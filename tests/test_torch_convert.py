"""JAX parameter snapshots -> the port's state_dict, and the checkpoint
round trip.

Every key of both committed ``.npz`` snapshots must land in the port's
state_dict with the value the JAX package's own exporter gives it
(``convert/torch_ckpt.export_state_dict``), and the result must load into a
port model of the snapshot's config with ``strict=True``.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from diffsbdd_tpu.convert.torch_ckpt import export_state_dict
from diffsbdd_tpu.utils.params_io import load_params_npz
from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
from diffsbdd_tpu_torch.config import load_config, snapshot_config
from diffsbdd_tpu_torch.convert.jax_params import load_npz, state_dict_from_npz
from diffsbdd_tpu_torch.train.module import build_module_from_config

REPO = Path(__file__).resolve().parent.parent
SNAPSHOTS = ("overfit_chem_fixture_best", "synth_quality_r05c_best")


@pytest.mark.parametrize("name", SNAPSHOTS)
def test_npz_round_trips_every_key(name):
    path = REPO / "checkpoints" / f"{name}.npz"
    got = state_dict_from_npz(path)
    want = export_state_dict(load_params_npz(path), attention=True,
                             reflection_equiv=False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # every stored leaf is consumed: 3 tied cross-product heads are extra
    n_blocks = sum(k.endswith("coord_mlp.4.weight") for k in got)
    assert len(got) == len(load_npz(path)) + n_blocks

    model = build_module_from_config(load_config(overrides=snapshot_config(path)),
                                     np.ones((9, 9)))
    model.load_state_dict({k: torch.tensor(v) for k, v in got.items()},
                          strict=True)


def test_snapshot_configs_are_the_trained_ones():
    """Widths, depth and T from each snapshot's metadata; the flagship
    options as the training scripts fix them."""
    r05c = snapshot_config(REPO / "checkpoints" / "synth_quality_r05c_best.npz")
    assert r05c["egnn_params"] == dict(
        joint_nf=128, hidden_nf=256, n_layers=6, attention=True, tanh=True,
        norm_constant=1, inv_sublayers=1, reflection_equivariant=False,
        edge_cutoff_ligand=None, edge_cutoff_pocket=5.0,
        edge_cutoff_interaction=5.0)
    assert r05c["diffusion_params"] == dict(diffusion_steps=500,
                                            normalize_factors=[1, 4])
    assert (r05c["dataset"], r05c["mode"], r05c["pocket_representation"]) == (
        "crossdock_full", "pocket_conditioning", "full-atom")
    fixture = snapshot_config(REPO / "checkpoints" / "overfit_chem_fixture_best.npz",
                              {"diffusion_params": {"diffusion_steps": 10}})
    assert (fixture["egnn_params"]["hidden_nf"], fixture["egnn_params"]["n_layers"],
            fixture["diffusion_params"]["diffusion_steps"]) == (64, 3, 10)


def test_checkpoint_round_trip(tmp_path):
    path = REPO / "checkpoints" / "overfit_chem_fixture_best.npz"
    ckpt = import_jax_npz(path, tmp_path, name="best")
    module, cfg = load_model(ckpt, name="best", device="cpu")
    assert cfg.egnn_params.hidden_nf == 64
    assert module.ddpm.T == 150  # as trained (overfit_chem_fixture_best.json)
    assert module.ddpm.size_distribution is None
    sd = state_dict_from_npz(path)
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    # the cross-product head is the coordinate head itself
    egnn = module.ddpm.dynamics.egnn
    assert egnn.e_block_0.gcl_equiv.cross_product_mlp[4] is \
        egnn.e_block_0.gcl_equiv.coord_mlp[4]


def test_checkpoint_keeps_the_raw_size_histogram(tmp_path):
    hist = np.arange(6.0).reshape(2, 3)
    ckpt = import_jax_npz(REPO / "checkpoints" / "overfit_chem_fixture_best.npz",
                          tmp_path, node_histogram=hist)
    module, _ = load_model(ckpt, device="cpu")
    np.testing.assert_array_equal(module.ddpm.size_distribution.raw_histogram, hist)


def test_load_model_runs_on_cuda_unless_asked(tmp_path):
    """Without a card and without device="cpu", loading raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ckpt = import_jax_npz(REPO / "checkpoints" / "overfit_chem_fixture_best.npz",
                          tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(ckpt)
