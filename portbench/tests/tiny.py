"""The cells at sizes a CPU test holds: the small committed JAX snapshot
(hidden 64, 3 layers) for sampling, a hidden-32 two-layer joint model for
training, pockets of 40-60 atoms, short chains."""
from __future__ import annotations

import tempfile
import time
from pathlib import Path

import torch

from portbench import harness
from portbench.drivers.common import merge

SAMPLE, TRAIN = "cond-sample-n20", "joint-train-b16"


def files(cell):
    spec = harness.load_spec()
    _, conf, mix, limits = harness.cell_files(spec, cell)
    if cell == SAMPLE:
        conf = merge(conf, {"weights": {"path": "checkpoints/overfit_chem_fixture_best.npz"},
                            "config": {"egnn_params": {"hidden_nf": 64, "n_layers": 3,
                                                       "joint_nf": 32},
                                       "diffusion_params": {"diffusion_steps": 12}}})
        mix = merge(mix, {"n_samples": 2, "pocket_atoms": [40, 52], "pockets": 2,
                          "lig_size_range": [4, 9], "steps_checked": 3, "trace_passes": [3, 8, 2]})
    else:
        conf = merge(conf, {"config": {"egnn_params": {"hidden_nf": 32, "n_layers": 2,
                                                       "joint_nf": 16},
                                       "diffusion_params": {"diffusion_steps": 50},
                                       "batch_size": 4, "accumulate_grad_batches": 2}})
        mix = merge(mix, {"n_train": 12, "n_val": 2, "pocket_atoms": [30, 41],
                          "lig_size_range": [4, 9], "trace_steps": [1, 3, 1]})
    return spec, conf, mix, limits


def run(cell, seed=2 ** 31 + 17, seconds=1.0, trace=False):
    """A whole run of ``cell`` on the CPU at the small sizes."""
    spec, conf, mix, limits = files(cell)
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as d:
        return harness.run(cell, seed, seconds, trace, torch.device("cpu"), Path(d),
                           time.perf_counter(), spec=spec, config=conf, traffic=mix,
                           limits=limits)
