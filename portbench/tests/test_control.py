"""The control (the reference with every product's operands rounded to
TF32, in the program's place) reads far above the program: on the CPU at
small sizes, and on the card at the cells' own sizes against their limits."""
from __future__ import annotations

import tempfile

import pytest
import torch

from portbench import control, harness
from portbench.tests import tiny


@pytest.mark.parametrize("cell", [tiny.SAMPLE, tiny.TRAIN])
def test_the_control_reads_above_the_program_on_the_cpu(cell):
    _, conf, mix, _ = tiny.files(cell)
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as d:
        out = control.readings(cell, 5, 0.5, torch.device("cpu"), d, config=conf, traffic=mix)
    for name, value in out["control"].items():
        assert value >= 3 * out["program"][name], (name, out)
    if "half_batch" in out:
        assert out["half_batch"]["loss_gap"] >= 10 * out["program"]["loss_gap"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [tiny.SAMPLE, tiny.TRAIN])
def test_the_limits_lie_between_the_program_and_the_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes")
    _, _, _, limits = harness.cell_files(harness.load_spec(), cell)
    with tempfile.TemporaryDirectory() as d:
        out = control.readings(cell, 7, 8.0, torch.device("cuda"), d)
    assert all(out["program"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in out["control"]), out
