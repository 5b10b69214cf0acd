"""The port's joint model against the JAX package's on the CPU.

Both sides run the committed fixture weights (hidden 64, 3 layers; the joint
model's parameter tree is the conditional one's, which the first test shows)
in ``mode: joint`` on the same numpy batches and consume the same numbers:
for the losses the test replays the JAX key and hands timesteps and noise to
the port; for the samplers both sides pop one recorded stream (the JAX side
eagerly, under ``jax.disable_jit``).  A joint draw is four arrays: ligand x,
pocket x, ligand h, pocket h.

Tolerances: loss terms 2e-4 (three layers of float32 sums in another order);
one denoise step 1e-4; chains: maximum coordinate deviation 1e-3 A and no
atom-type flip, printed as they come out.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import diffsbdd_tpu.cli.generate_ligands as jax_cli
import diffsbdd_tpu_torch.cli.generate_ligands as port_cli
import diffsbdd_tpu_torch.diffusion.ddpm as port_ddpm
from diffsbdd_tpu.chem.sdfio import read_sdf
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.diffusion.ddpm import JointDDPM as JaxJointDDPM
from diffsbdd_tpu.train.module import build_module_from_config as jax_build
from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
from diffsbdd_tpu_torch.chem import pdb as port_pdb
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.convert.jax_params import flatten, state_dict_from_jax
from diffsbdd_tpu_torch.train.module import build_module_from_config
from reference_bridge import make_queued_ddpm
from test_torch_sampling import FIXTURE_NPZ, deviation
from test_torch_train import (A, LOSS_TOL, assert_tree_close, batches, datadir,  # noqa: F401
                              both_modules, fixture_overrides, fixture_params,
                              jnp_batch, tiny_overrides, torch_batch)

T = 10
HIST = np.ones((17, 65))
JOINT = dict(mode="joint")


def joint_overrides(T=T, **over):
    return fixture_overrides(diffusion_params=dict(diffusion_steps=T), **JOINT, **over)


def queued(jm):
    jm.ddpm.__class__ = make_queued_ddpm(JaxJointDDPM)
    return jm


def joint_noise(seed, n_draws, B, NL, NP):
    """``n_draws`` joint draws, flattened in drawing order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_draws):
        for shape in ((B, NL, 3), (B, NP, 3), (B, NL, A), (B, NP, A)):
            out.append(rng.standard_normal(shape).astype(np.float32))
    return out


def queue_port(pm, queue):
    def pop(g, shape, mask):
        arr = queue.pop(0)
        assert tuple(arr.shape) == tuple(shape), (arr.shape, shape)
        return torch.as_tensor(arr) * mask[..., None]
    pm.ddpm.sample_gaussian = pop


def jax_joint_draws(rng, ligand, pocket, training, T):
    """Timesteps and noise that ``JointDDPM.loss_terms`` draws from ``rng``."""
    k_t, k_noise, k_noise0 = jax.random.split(rng, 3)
    B, NL = ligand["x"].shape[:2]
    NP = pocket["x"].shape[1]
    t_int = jax.random.randint(k_t, (B, 1), 0 if training else 1, T + 1)
    noise = []
    for key in ([k_noise] if training else [k_noise, k_noise0]):
        ks = jax.random.split(key, 4)
        for k, shape in zip(ks, ((B, NL, 3), (B, NP, 3), (B, NL, A), (B, NP, A))):
            noise.append(np.asarray(jax.random.normal(k, shape)))
    return np.asarray(t_int, np.float32), noise


def test_joint_tree_is_the_conditional_tree():
    """A joint model initializes the same parameter tree as a conditional
    one, so ``convert/jax_params.py`` serves both."""
    trees = {}
    for mode in ("joint", "pocket_conditioning", "pocket_conditioning_simple"):
        jm = jax_build(jax_load_config(overrides=tiny_overrides(mode=mode)), HIST)
        params = jm.init_params(jax.random.PRNGKey(0), batch_size=2)
        trees[mode] = {k: v.shape for k, v in flatten(
            jax.tree_util.tree_map(np.asarray, params)).items()}
        pm = build_module_from_config(load_config(overrides=tiny_overrides(mode=mode)),
                                      HIST)
        pm.load_state_dict({k: torch.tensor(v) for k, v in
                            state_dict_from_jax(params).items()}, strict=True)
    assert trees["joint"] == trees["pocket_conditioning"] \
        == trees["pocket_conditioning_simple"]


@pytest.mark.parametrize("training", [True, False])
def test_joint_loss_terms_match_jax(fixture_params, batches, training):
    jm, params, pm = both_modules(joint_overrides(T=20), fixture_params)
    lig, pkt = batches[0]["ligand"], batches[0]["pocket"]
    rng = jax.random.PRNGKey(7)
    want = jm.ddpm.loss_terms(params, rng, jnp_batch(lig), jnp_batch(pkt), training)
    t_int, noise = jax_joint_draws(rng, lig, pkt, training, 20)
    queue = list(noise)
    queue_port(pm, queue)
    pm.ddpm.sample_timesteps = lambda g, n, lowest: torch.as_tensor(t_int)
    with torch.no_grad():
        got = pm.ddpm.loss_terms(None, torch_batch(lig), torch_batch(pkt), training)
    assert not queue
    assert_tree_close(got.pop("info"), want.pop("info"), **LOSS_TOL)
    assert_tree_close(got, want, **LOSS_TOL)


@pytest.mark.parametrize("loss_type,training", [("l2", True), ("vlb", False)])
def test_joint_loss_fn_matches_jax(fixture_params, batches, loss_type, training):
    over = joint_overrides(T=20)
    over["diffusion_params"]["diffusion_loss_type"] = loss_type
    jm, params, pm = both_modules(over, fixture_params)
    lig, pkt = batches[1]["ligand"], batches[1]["pocket"]
    rng = jax.random.PRNGKey(8)
    want_loss, want = jm.loss_fn(params, rng, jnp_batch(lig), jnp_batch(pkt), training)
    t_int, noise = jax_joint_draws(rng, lig, pkt, training, 20)
    queue_port(pm, list(noise))
    pm.ddpm.sample_timesteps = lambda g, n, lowest: torch.as_tensor(t_int)
    with torch.no_grad():
        got_loss, got = pm.loss_fn(None, torch_batch(lig), torch_batch(pkt), training)
    assert_tree_close(got, want, **LOSS_TOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **LOSS_TOL)


def small_masks(B=2, NL=8, NP=40):
    m_l = np.ones((B, NL), np.float32)
    m_l[1, 6:] = 0.0
    m_p = np.ones((B, NP), np.float32)
    m_p[0, 35:] = 0.0
    return m_l, m_p


def test_joint_denoise_step_matches_jax(fixture_params):
    jm, params, pm = both_modules(joint_overrides(), fixture_params)
    queued(jm)
    m_l, m_p = small_masks()
    rng = np.random.default_rng(0)
    z_l = rng.standard_normal((2, 8, 3 + A)).astype(np.float32) * m_l[..., None]
    z_p = rng.standard_normal((2, 40, 3 + A)).astype(np.float32) * m_p[..., None]
    z_p[..., :3] *= 4.0
    s, t = np.full((2, 1), 0.4, np.float32), np.full((2, 1), 0.5, np.float32)
    noise = joint_noise(1, 1, 2, 8, 40)
    jm.ddpm.set_queue(list(noise))
    with jax.disable_jit():
        want = jm.ddpm._denoise_step(params, jax.random.PRNGKey(0),
                                     *map(jnp.asarray, (z_l, z_p, m_l, m_p, s, t)))
    queue_port(pm, list(noise))
    with torch.no_grad():
        got = pm.ddpm._denoise_step(None, *map(torch.as_tensor,
                                               (z_l, z_p, m_l, m_p, s, t)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_joint_chain_matches_jax(fixture_params):
    """``sample`` at T = 10: 1 prior, T step and 1 decode draw."""
    jm, params, pm = both_modules(joint_overrides(), fixture_params)
    queued(jm)
    m_l, m_p = small_masks()
    noise = joint_noise(2, T + 2, 2, 8, 40)
    jm.ddpm.set_queue(list(noise))
    with jax.disable_jit():
        want = jm.ddpm.sample(params, jax.random.PRNGKey(0),
                              (jnp.asarray(m_l), jnp.asarray(m_p)), timesteps=T)
    assert not jm.ddpm._noise_queue
    queue = list(noise)
    queue_port(pm, queue)
    got = pm.ddpm.sample(None, (torch.as_tensor(m_l), torch.as_tensor(m_p)),
                         timesteps=T)
    assert not queue
    for name, g, w, m in (("ligand", got[0], want[0], m_l), ("pocket", got[1], want[1], m_p)):
        dx, flips = deviation(g.numpy()[m > 0], np.asarray(w)[m > 0])
        print(f"joint T={T} chain, {name}: max coordinate deviation {dx:.2e} A, "
              f"{flips} type flips")
        assert dx <= 1e-3 and flips == 0


def inpaint_case(seed, B=2, NL=8, NP=40):
    m_l, m_p = small_masks(B, NL, NP)
    rng = np.random.default_rng(seed)

    def part(mask, n, spread):
        x = rng.standard_normal((B, n, 3)).astype(np.float32) * spread + 3.0
        oh = np.eye(A, dtype=np.float32)[rng.integers(0, 5, (B, n))]
        return {"x": x * mask[..., None], "one_hot": oh * mask[..., None],
                "mask": mask, "size": mask.sum(1).astype(np.int32)}

    lig_fixed = np.zeros_like(m_l)
    lig_fixed[:, :3] = 1.0
    return part(m_l, NL, 1.5), part(m_p, NP, 4.0), lig_fixed


@pytest.mark.parametrize("resamplings", [1, 2, 5])
@pytest.mark.parametrize("jump_length", [1, 2, 3, 7])
@pytest.mark.parametrize("timesteps", [1, 6, 10, 25])
def test_repaint_schedule_matches_jax(resamplings, jump_length, timesteps):
    port = port_ddpm.JointDDPM
    assert port.get_repaint_schedule(resamplings, jump_length, timesteps) == \
        JaxJointDDPM.get_repaint_schedule(resamplings, jump_length, timesteps)
    got = port._repaint_plan(resamplings, jump_length, timesteps)
    want = JaxJointDDPM._repaint_plan(JaxJointDDPM, resamplings, jump_length,
                                      timesteps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if resamplings == 1:
        assert len(got[0]) == timesteps  # one pass per level, then the decode


def test_generate_cli_on_a_joint_checkpoint_matches_jax(tmp_path, monkeypatch,
                                                        fixture_params):
    """``cli.generate_ligands`` on a joint checkpoint inpaints with the whole
    pocket fixed; both CLIs write the same molecules from the same noise."""
    n_samples, n_atoms, t = 2, 8, 4
    pdb = tmp_path / "pocket.pdb"
    ref = chip_smoke.write_pocket_pdb(pdb, n_atoms=40, seed=5)
    args = ["--pdbfile", str(pdb), "--ref_ligand", ref, "--n_samples",
            str(n_samples), "--num_nodes_lig", str(n_atoms), "--all_frags",
            "--timesteps", str(t), "--resamplings", "2", "--jump_length", "2"]

    over = joint_overrides(T=t)
    jm = queued(jax_build(jax_load_config(overrides=over), HIST))
    ckpt = import_jax_npz(FIXTURE_NPZ, tmp_path / "ckpt", over)
    module, _ = load_model(ckpt, device="cpu")
    assert isinstance(module.ddpm, port_ddpm.JointDDPM)
    n_pocket = module.prepare_pocket(port_pdb.get_pocket_from_ligand(
        port_pdb.parse_pdb(pdb), ref))["mask"].shape[1]
    s_arr, jumps = jm.ddpm._repaint_plan(2, 2, t)
    noise = joint_noise(6, 2 + 2 * len(s_arr) + int((jumps > 0).sum()),
                        n_samples, n_atoms, n_pocket)

    queue = list(noise)
    jm.ddpm.set_queue(queue)
    monkeypatch.setattr(jax_cli, "load_model", lambda *a, **k: (
        jm, types.SimpleNamespace(params=fixture_params), None))
    with jax.disable_jit():
        jax_cli.main(["unused", *args, "--outfile", str(tmp_path / "jax.sdf")])
    assert not queue

    queue = list(noise)
    monkeypatch.setattr(port_ddpm.JointDDPM, "sample_gaussian",
                        lambda self, g, shape, mask:
                        torch.as_tensor(queue.pop(0)) * mask[..., None])
    port_cli.main([str(ckpt), *args, "--outfile", str(tmp_path / "port.sdf"),
                   "--device", "cpu"])
    assert not queue

    want, got = read_sdf(tmp_path / "jax.sdf"), read_sdf(tmp_path / "port.sdf")
    assert len(got) == len(want) == n_samples
    dev = 0.0
    for g, w in zip(got, want):
        assert g.symbols == w.symbols and g.n_atoms == n_atoms
        dev = max(dev, float(np.abs(g.coords - w.coords).max()))
    print(f"joint CLI SDFs: max coordinate deviation {dev:.2e} A")
    assert dev <= 1e-3
