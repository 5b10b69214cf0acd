"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Sets up the cell (builds the cell's CUDA
libraries on a checkout's first run, loads or draws the weights, makes the
inputs from ``--seed``, warms up), measures for ``--seconds`` (whole
requests or steps, each started while the window is open), compares what
the window produced with the plain reference, and prints the result as the
last line of standard output (``--trace 1``: the per-layer metrics, from a
profiled part of the window).  Exits with 2 and prints no result without
enough CUDA devices, and with 3 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".portbench_cache" / "torch_extensions"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from portbench import harness

    spec = harness.load_spec(ROOT)
    work = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if work is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda"), Path(workdir), T_PROCESS, spec=spec)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"JAX or the JAX package was loaded: {leaked}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
