"""The port's import of reference Lightning checkpoints against the JAX
package's converter on the CPU.

Each case writes a reference-format ``.ckpt`` with ``torch.save``: the
state_dict in the reference's names (JAX's ``export_state_dict`` of a JAX
initialization: the tied cross head under both keys, the schedule's
``ddpm.gamma.gamma`` table; a learned schedule's ``ddpm.gamma.*`` weights
added by hand) and ``hyper_parameters`` of ``argparse.Namespace`` values with
the size histogram.  The port's ``import_lightning_checkpoint`` must give
exactly the weights of JAX's ``convert_lightning_checkpoint`` on the same file,
and the two models the same loss terms under the same draws (1e-5).
"""
import json
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.convert.torch_ckpt import (convert_lightning_checkpoint,
                                             export_state_dict)
from diffsbdd_tpu.train.module import build_module_from_config as jax_build
from diffsbdd_tpu_torch.checkpoint import load_model
from diffsbdd_tpu_torch.convert import torch_ckpt
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_jax
from test_torch_joint import jax_joint_draws
from test_torch_repairs import moad_batch
from test_torch_train import jax_draws

T = 5
NL, NP = 8, 24
LIGHTNING_TOL = dict(atol=1e-5, rtol=1e-5)
# the learned gamma(t) sums 1024 hidden units and is normalized by
# gamma~(1) - gamma~(0), which amplifies float32 rounding to ~1e-3 in
# gamma_s - gamma_t and so in every term weighted by it (as in
# test_torch_train.py)
LEARNED_TOL = dict(atol=3e-3, rtol=3e-3)

# (dataset, mode, pocket representation, extra diffusion params, histogram as)
CASES = {
    "crossdock_ca_cond": ("crossdock", "pocket_conditioning", "CA", {}, "list"),
    "crossdock_full_joint": ("crossdock_full", "joint", "full-atom", {}, "array"),
    "moad_fullatom_cond": ("bindingmoad", "pocket_conditioning", "full-atom", {}, "list"),
    "learned_schedule": ("crossdock", "pocket_conditioning", "CA",
                         {"diffusion_noise_schedule": "learned",
                          "diffusion_loss_type": "vlb"}, "array"),
}


def hparams(case):
    dataset, mode, rep, diffusion, hist_as = CASES[case]
    hist = np.ones((NL + 1, NP + 1))
    hist[4:8, 14:24] += 3.0
    return {
        "dataset": dataset, "mode": mode, "pocket_representation": rep,
        "virtual_nodes": False, "batch_size": 4, "lr": 1e-3, "clip_grad": True,
        "augment_noise": 0, "augment_rotation": False, "auxiliary_loss": False,
        "eval_epochs": 50, "visualize_sample_epoch": 50, "visualize_chain_epoch": 50,
        "egnn_params": Namespace(
            joint_nf=8, hidden_nf=16, n_layers=2, inv_sublayers=1, attention=True,
            tanh=True, norm_constant=1, sin_embedding=False,
            normalization_factor=100, aggregation_method="sum",
            reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0, device="cuda"),
        "diffusion_params": Namespace(**{
            "diffusion_steps": T, "diffusion_noise_schedule": "polynomial_2",
            "diffusion_noise_precision": 5e-4, "diffusion_loss_type": "l2",
            "normalize_factors": [1, 4], **diffusion}),
        "loss_params": Namespace(max_weight=0.001, schedule="linear", clamp_lj=3.0),
        "eval_params": Namespace(n_eval_samples=10, eval_batch_size=10,
                                 smiles_file=None, n_visualize_samples=5,
                                 keep_frames=5),
        "node_histogram": hist.tolist() if hist_as == "list" else hist,
    }


def write_reference_ckpt(path, case, edit=None):
    """A reference-format Lightning file from a JAX initialization of the
    case's model; ``edit(state_dict)`` changes the state_dict before it is
    written."""
    hp = hparams(case)
    jm = jax_build(jax_load_config(overrides=torch_ckpt.hparams_to_config_dict(hp)),
                   np.asarray(hp["node_histogram"]))
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
    learned = "gamma" in params
    table = None if learned else np.asarray(jm.ddpm.gamma_table.gammas)
    sd = export_state_dict(params, attention=True, reflection_equiv=False,
                           gamma_table=table)
    if learned:
        g = params["gamma"]["params"]
        for layer in ("l1", "l2", "l3"):
            sd[f"ddpm.gamma.{layer}.weight"] = g[layer]["kernel"].T
            sd[f"ddpm.gamma.{layer}.bias"] = g[layer]["bias"]
        sd["ddpm.gamma.gamma_0"] = g["gamma_0"]
        sd["ddpm.gamma.gamma_1"] = g["gamma_1"]
    state_dict = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    if edit is not None:
        edit(state_dict)
    torch.save({"state_dict": state_dict, "hyper_parameters": hp,
                "epoch": 3, "global_step": 120}, path)
    return path


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Per case: (JAX converter's (module, state), the port's module)."""
    out = {}
    for case in CASES:
        d = tmp_path_factory.mktemp(case)
        ckpt = write_reference_ckpt(d / "ref.ckpt", case)
        jmod, jstate, _ = convert_lightning_checkpoint(ckpt, d / "jax")
        pmod, _ = torch_ckpt.import_lightning_checkpoint(ckpt, d / "port")
        out[case] = (jmod, jstate, pmod.eval())
    return out


@pytest.mark.parametrize("case", CASES)
def test_import_gives_the_jax_converters_weights(imported, case):
    jmod, jstate, pmod = imported[case]
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = pmod.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    cross = [k for k in got if k.endswith("cross_product_mlp.4.weight")]
    assert len(cross) == 2 and all(
        got[k].data_ptr() == got[k.replace("cross_product_mlp", "coord_mlp")].data_ptr()
        for k in cross)
    if CASES[case][3]:
        assert any(k.startswith("ddpm.gamma_net.") for k in got)
    np.testing.assert_array_equal(pmod.ddpm.size_distribution.raw_histogram,
                                  jmod.ddpm.size_distribution.raw_histogram)


@pytest.mark.parametrize("case", CASES)
def test_imported_loss_terms_match_jax(imported, case):
    jmod, jstate, pmod = imported[case]
    joint = CASES[case][1] == "joint"
    lig, pkt = moad_batch(np.random.default_rng(5), pmod.residue_nf, NL=NL, NP=NP)
    if pmod.atom_nf != 10:
        lig["one_hot"] = np.concatenate(
            [lig["one_hot"], np.zeros(lig["one_hot"].shape[:2] + (1,), np.float32)], -1)
    rng = jax.random.PRNGKey(4)
    jb = [{k: jax.numpy.asarray(v) for k, v in part.items()} for part in (lig, pkt)]
    want = jmod.ddpm.loss_terms(jstate.params, rng, *jb, True)
    if joint:
        t_int, noise = jax_joint_draws(rng, lig, pkt, True, T)
    else:
        t_int, noise = jax_draws(rng, lig, pmod.atom_nf, True, T=T)
    queue = list(noise)
    pmod.ddpm.sample_timesteps = lambda g, n, lowest: torch.as_tensor(t_int)
    pmod.ddpm.sample_gaussian = lambda g, shape, mask: \
        torch.tensor(queue.pop(0)) * mask[..., None]
    with torch.no_grad():
        got = pmod.ddpm.loss_terms(None, *[{k: torch.as_tensor(v) for k, v in part.items()}
                                           for part in (lig, pkt)], True)
    assert not queue
    tol = LEARNED_TOL if CASES[case][3] else LIGHTNING_TOL
    info_got, info_want = got.pop("info"), want.pop("info")
    for part_got, part_want in ((got, want), (info_got, info_want)):
        assert part_got.keys() == part_want.keys()
        for k in part_want:
            np.testing.assert_allclose(part_got[k].detach().numpy(),
                                       np.asarray(part_want[k]), err_msg=k, **tol)


def _wrong_table(sd):
    sd["ddpm.gamma.gamma"] = sd["ddpm.gamma.gamma"] + 1e-3


def _stray_key(sd):
    sd["ddpm.dynamics.egnn.e_block_0.gcl_0.extra.weight"] = torch.zeros(2)


def _missing_key(sd):
    del sd["ddpm.dynamics.atom_encoder.0.bias"]


@pytest.mark.parametrize("edit,message", [
    (_wrong_table, "gamma schedule mismatch"),
    (_stray_key, "left over"),
    (_missing_key, "missing")], ids=["gamma_table", "stray_key", "missing_key"])
def test_mismatches_raise(tmp_path, edit, message):
    ckpt = write_reference_ckpt(tmp_path / "ref.ckpt", "crossdock_ca_cond", edit)
    with pytest.raises(ValueError, match=message):
        torch_ckpt.import_lightning_checkpoint(ckpt, tmp_path / "port")
    assert not (tmp_path / "port").exists()
    if edit is _wrong_table:
        # unchecked on request, as in JAX
        torch_ckpt.import_lightning_checkpoint(ckpt, tmp_path / "port",
                                               verify_gamma=False)


def test_cli_writes_what_load_model_reads(tmp_path, capsys):
    ckpt = write_reference_ckpt(tmp_path / "ref.ckpt", "moad_fullatom_cond")
    torch_ckpt.main([str(ckpt), "--outdir", str(tmp_path / "out"), "--name", "imported"])
    assert "converted" in capsys.readouterr().out
    module, cfg = load_model(tmp_path / "out", name="imported", device="cpu")
    assert (cfg.dataset, cfg.mode, cfg.pocket_representation) == \
        ("bindingmoad", "pocket_conditioning", "full-atom")
    assert cfg.egnn_params.hidden_nf == 16 and cfg.diffusion_params.diffusion_steps == T
    assert cfg.eval_params.keep_frames == 5
    sidecar = json.loads((tmp_path / "out" / "imported.config.json").read_text())
    np.testing.assert_array_equal(np.asarray(sidecar["node_histogram"]),
                                  np.asarray(hparams("moad_fullatom_cond")["node_histogram"]))
    again, _ = torch_ckpt.import_lightning_checkpoint(ckpt, tmp_path / "again")
    for k, v in again.state_dict().items():
        assert torch.equal(module.state_dict()[k], v), k
