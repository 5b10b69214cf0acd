"""The readings that the limits in ``portbench/limits/<cell>.json`` are set
from: on each seed, the numbers compared for the program (as a run
compares them), for the control (the reference with every matrix product's
operands rounded to TF32, in the program's place) and, for a training
cell, for a fault planted in the reference (each micro-batch's loss taken
over its first half only), with each step's loss gap and timesteps and the
leaves of widest change gap beside the compared median.  A training cell's
state left unchanged reads 1 by the change's measure and needs no run.  The
benchmark's own runs do not run this.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 --seconds 8

Prints one JSON line a seed.  A sampling cell's window runs ``--seconds``
(whole requests) with ``--steps-checked`` steps a request compared.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed, seconds, device, workdir, config=None, traffic=None,
             steps_checked=None):
    """{"program": {...}, "control": {...}[, "half_batch": {...}]} of one
    seed."""
    import torch
    from portbench import harness
    from portbench.drivers.common import merge
    spec = harness.load_spec()
    _, conf, mix, _ = harness.cell_files(spec, cell)
    mix = traffic or mix
    if steps_checked is not None:
        mix = merge(mix, {"steps_checked": steps_checked})
    ctx = harness.Context(cell=cell, config=config or conf, traffic=mix, seed=int(seed),
                          device=device, workdir=Path(workdir), trace=False)
    driver = harness.driver_class(mix["kind"])(ctx)
    driver.setup()
    driver.window(seconds)
    driver.release()
    out = {"seed": int(seed), "program": driver.check()}
    if mix["kind"] == "sample":
        out["borderline_graphs"] = driver.borderline_graphs
        out["program_strict"] = driver._worst("f32")
        out["control"] = driver.control()
    else:
        ref = driver.follow("f32")
        tf32, half = driver.follow("tf32"), driver.follow("f32", half_batch=True)
        out["control"] = driver.gaps(*tf32, driver.P0, ref)
        out["half_batch"] = driver.gaps(*half, driver.P0, ref)
        out["steps"] = [dict(loss_gap=abs(a - b) / abs(b), t=sorted(
            int(x) for d in driver.draws[i * driver.k_acc:(i + 1) * driver.k_acc]
            for x in d[0].flatten().tolist())) for i, (a, b) in enumerate(zip(driver.losses,
                                                                           ref[0]))]
        out["leaves"] = leaf_look(driver.p_end, driver.P0, ref)
        out["worst_change_gap"] = {
            "program": out["leaves"][0]["gap"],
            "control": leaf_look(tf32[2], driver.P0, ref, 1)[0]["gap"],
            "half_batch": leaf_look(half[2], driver.P0, ref, 1)[0]["gap"]}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def leaf_look(end, P0, ref, n=3):
    """The ``n`` moved leaves with the widest change gap: the gap, the
    leaf, its change norms (reference, program), its reference
    first-gradient norm, the median leaf's, and the share of its elements
    whose reference first gradient is under AmsgradW's eps."""
    import numpy as np
    from portbench.drivers.train import change_gaps
    _, first, ref_end = ref
    g = {k: float(v.norm()) for k, v in first.items()}
    g_med = float(np.median(list(g.values())))
    gaps = change_gaps(end, P0, ref)
    rows = []
    for k in sorted(gaps, key=gaps.get, reverse=True)[:n]:
        rows.append(dict(gap=gaps[k], leaf=k, ref_change=float((ref_end[k] - P0[k]).norm()),
                         change=float((end[k] - P0[k]).norm()), ref_grad=g[k],
                         median_grad=g_med,
                         share_under_eps=float((first[k].abs() < 1e-8).float().mean())))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--steps-checked", type=int, default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="portbench-control-") as workdir:
            t0 = time.perf_counter()
            out = readings(args.workload, seed, args.seconds, torch.device("cuda"), workdir,
                           steps_checked=args.steps_checked)
            out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
