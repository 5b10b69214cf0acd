"""The benchmark's files, names and arithmetic, and a whole run of each cell
on the CPU at small sizes.  Run from the repository root:

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import harness, work
from portbench.gen import dataset, pockets
from portbench.tests import tiny

ROOT = harness.ROOT
BENCH = harness.BENCH
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_file_parses_and_is_found_by_name():
    for conf in SPEC["configs"]:
        assert (ROOT / conf["file"]).is_file()
        assert json.loads((ROOT / conf["file"]).read_text())["name"] == conf["name"]
    for cell in SPEC["workloads"]:
        _, conf, mix, limits = harness.cell_files(SPEC, cell["name"])
        assert (BENCH / "drivers" / f"{mix['kind']}.py").is_file()
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())
        assert conf["reduced"] == [c for c in SPEC["configs"]
                                   if c["name"] == cell["config"]][0]["reduced"]
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]] + [w["config"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"])) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert all(UNIT.match(m["unit"]) for m in SPEC["end_to_end"] + SPEC["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in SPEC["end_to_end"] + SPEC["per_layer"])
    for path in BENCH.rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        target = e2e[m["moves"]]
        assert m["workloads"] and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in target.get("workloads", [cell])
    for cell in cells:
        reported = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.metrics_of(SPEC, cell, "per_layer")


def test_the_sampling_pool_is_the_same_for_every_seed(tmp_path):
    _, _, mix, _ = harness.cell_files(SPEC, tiny.SAMPLE)
    plan = pockets.request_plan(mix, mix["pockets"])
    again = pockets.request_plan(mix, mix["pockets"])
    assert all(np.array_equal(x["lig_sizes"], y["lig_sizes"]) for x, y in zip(plan, again))
    assert all(len(x["lig_sizes"]) == mix["n_samples"] for x in plan)
    texts = []
    for run in ("a", "b"):
        paths, _ = pockets.write_pockets(tmp_path / run, mix, plan)
        texts.append([Path(p).read_text() for p in paths])
    assert texts[0] == texts[1] and len(set(texts[0])) == len(plan)
    for req, text in zip(plan, texts[0]):
        n = sum(line.startswith("ATOM") for line in text.splitlines())
        assert req["pocket_atoms"] <= n <= 320


def test_the_training_set_is_the_same_for_every_seed(tmp_path):
    _, _, mix, _ = harness.cell_files(SPEC, tiny.TRAIN)
    assert dataset.complex_sizes(mix, 50) == dataset.complex_sizes(mix, 50)
    small = dict(mix, n_train=6, n_val=2)
    sets = []
    for run in ("a", "b"):
        d = dataset.write(tmp_path / run, small, 10)
        with np.load(d / "train.npz") as f:
            sets.append({k: f[k] for k in f.files})
    assert sets[0].keys() == sets[1].keys()
    assert all(np.array_equal(sets[0][k], sets[1][k]) for k in sets[0])
    sizes = np.bincount(sets[0]["pocket_mask"].astype(int)).tolist()
    assert sizes == [npk for _, npk in dataset.complex_sizes(small, 6)]


@pytest.mark.parametrize("kernel,B,N,pairs,n_mlp,gflop,bound_ms", [
    ("gcl_agg", 16, 344, 224_918, 1, 30.06, 0.1822),
    ("coord_agg", 16, 344, 23_979, 2, 6.41, 0.0388),
    ("gcl_agg_bwd", 16, 352, 233_034, 1, 93.42, 0.5662),
    ("coord_agg_bwd", 16, 352, 29_762, 2, 23.86, 0.1446),
])
def test_roofline_counts_match_the_hand_worked_f256_rows(kernel, B, N, pairs, n_mlp, gflop,
                                                         bound_ms):
    """PERF.md's kernel table, F = 256: operations and 3xTF32 bounds."""
    launch = work.Launch(kernel, B, N, 256, 24 if kernel == "coord_agg" else N, n_mlp, pairs)
    assert launch.flops() / 1e9 == pytest.approx(gflop, rel=2e-3)
    assert launch.least_s() * 1e3 == pytest.approx(bound_ms, rel=2e-3)


def test_model_operations_by_hand():
    # one ligand and one pocket node, F = 4, joint_nf 2, one type each, one layer
    by_hand = (2 * (1 * 2 + 2 * 2)) * 2 + (2 * (2 * 2 + 2 * 1)) * 2 \
        + 2 * 2 * 2 * 3 * 4 + 2 * 2 * (2 * 16 + 3 * 16 + 2 * 2 * 16)
    assert work.node_flops(2, 1, 1, 1, 1, 2, 4, 1) == by_hand
    launch = work.Launch("gcl_agg", 1, 2, 4, 2, 1, 3)
    assert work.pair_flops(launch) == 3 * (2 * 16 + 2 * 4)


def test_pairs_inside_the_cutoffs_by_hand():
    import torch
    x0 = torch.tensor([[[0.0, 0, 0], [9.0, 0, 0], [4.0, 0, 0], [20.0, 0, 0]]])
    mask = torch.tensor([[1.0, 1, 1, 1]])
    is_lig = torch.tensor([[1.0, 1, 0, 0]])
    # ligand pairs all (4, self included); pocket 2-2, 3-3 (15 A apart: no
    # 2-3); ligand-pocket within 5 A: 0-2, 2-0, 1-2, 2-1
    assert int(work.count_pairs(x0, mask, None, is_lig, (None, 5.0, 5.0))) == 10
    assert int(work.count_pairs(x0, mask, None, is_lig, (None, 5.0, 5.0), 2)) == 6


@pytest.mark.parametrize("cell", [tiny.SAMPLE, tiny.TRAIN])
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_cpu_run_prints_the_contracts_keys(cell, trace):
    result = tiny.run(cell, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = set(result["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert names <= {m["name"] for m in harness.metrics_of(SPEC, cell, "per_layer")}
    else:
        assert names == {m["name"] for m in harness.metrics_of(SPEC, cell, "end_to_end")}
    json.dumps(result)


def _top(name):
    return name.split(".")[0]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import control, run\n"
            "from portbench.tests import tiny\n"
            "tiny.run(tiny.SAMPLE)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, check=True)
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "diffsbdd_tpu"}
    assert "diffsbdd_tpu_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert all(_top(m) in ("torch", "numpy", "portbench", "__future__", "math",
                                   "re", "typing", "dataclasses") for m in mods), (path, mods)
            assert all(not m.startswith("portbench.") or m.startswith("portbench.reference")
                       for m in mods), (path, mods)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.joint, portbench.reference.sampler, "
            "portbench.reference.pocket, portbench.reference.weights\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True)
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"diffsbdd_tpu_torch", "diffsbdd_tpu", "jax"}


def test_run_refuses_without_a_card_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", tiny.SAMPLE,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
