"""What every cell's run shares: the cell's files found by name, the seeds,
the timed window's frame, the correctness verdict, the per-layer readers
and the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration (its
``file``: the configuration as run, ``portbench/configs/<name>.json``) and
a traffic mix (``portbench/traffic/<name>.json``), whose ``kind`` names its
driver (``portbench/drivers/<kind>.py``).  The cell's limits are
``portbench/limits/<cell>.json``; each per-layer metric is read by
``portbench/metrics/<metric>.py``.  A driver is a class ``Driver(ctx)``
with ``setup()``, ``window(seconds) -> (end-to-end values, attempted,
failed)``, ``release()`` (drops the program's state), ``check() -> {name:
value}`` (the numbers compared with the reference) and, in a traced run,
``record() -> dict`` (what the per-layer readers read).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diffsbdd_tpu")


def load_spec(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    cell: str
    config: Dict      # the configuration file's content
    traffic: Dict     # the traffic mix's content
    seed: int
    device: Any       # torch.device
    workdir: Path     # scratch for the run's files (under TMPDIR)
    trace: bool

    def rng(self, stream: int) -> np.random.Generator:
        """An independent numpy stream of the run seed."""
        return np.random.default_rng([self.seed % 2 ** 64, stream])

    def torch_seed(self, stream: int) -> int:
        """An independent torch seed of the run seed."""
        ss = np.random.SeedSequence([self.seed % 2 ** 64, stream])
        return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def cell_files(spec: Dict, cell: str, root: Path = ROOT):
    """(workload entry, configuration content, traffic content, limits) of a
    cell, each found by its name."""
    work = {w["name"]: w for w in spec["workloads"]}[cell]
    conf = {c["name"]: c for c in spec["configs"]}[work["config"]]
    return (work, read_json(root / conf["file"]),
            read_json(BENCH / "traffic" / f"{work['traffic']}.json"),
            read_json(BENCH / "limits" / f"{cell}.json"))


def metrics_of(spec: Dict, cell: str, section: str):
    """The metrics of ``section`` that ``cell`` reports: those listing it,
    and those without a list whose end-to-end metric the cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in names)]


def read_metric(name: str, record: Dict) -> Optional[float]:
    """The per-layer metric ``name`` from a traced run's record (None when
    its reader finds nothing to read)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def driver_class(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}").Driver


def run(cell: str, seed: int, seconds: float, trace: bool, device, workdir: Path,
        t_process: float, spec: Optional[Dict] = None, config: Optional[Dict] = None,
        traffic: Optional[Dict] = None, limits: Optional[Dict] = None) -> Dict:
    """One run of ``cell``: set-up, the timed window, the comparison with
    the reference and, traced, the per-layer readings.  ``config``,
    ``traffic`` and ``limits`` replace the cell's files (the tests' small
    sizes).  Returns the result line's dict with the compared numbers under
    ``checks``."""
    import torch
    spec = spec or load_spec()
    _, conf_file, traffic_file, limits_file = cell_files(spec, cell)
    ctx = Context(cell=cell, config=config or conf_file, traffic=traffic or traffic_file,
                  seed=int(seed), device=device, workdir=Path(workdir), trace=bool(trace))
    driver = driver_class(ctx.traffic["kind"])(ctx)
    driver.setup()
    cuda = device.type == "cuda"
    window_start = time.perf_counter()
    values, attempted, failed = driver.window(seconds)
    values["setup_s"] = window_start - t_process
    memory = int(torch.cuda.max_memory_allocated()) if cuda else 0
    record = driver.record() if trace else None
    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    print(f"reference comparison took {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr, flush=True)
    limits = limits or limits_file
    verdict = {k: [float(v), float(limits.get(k, "nan"))] for k, v in checks.items()}
    correct = bool(checks) and set(checks) == set(limits) and all(
        np.isfinite(v) and v <= lim for v, lim in verdict.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": memory}
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, cell, section):
        value = read_metric(m["name"], record) if trace else values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace:
        summary = record.get("trace") or {}
        device_info["busy_s"] = float(summary.get("busy_s", 0.0))
        device_info["window_s"] = float(summary.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                               "idle_gaps": summary.get("idle_gaps", [])}
    result["checks"] = verdict
    return result


def emit(result: Dict) -> None:
    """The compared numbers as the last lines of standard error, the result
    as the last line of standard output (``checks`` its last key)."""
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
