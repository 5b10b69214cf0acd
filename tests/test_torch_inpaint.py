"""The port's conditional inpainting, ``diversify`` and the simple conditional
model against the JAX package's on the CPU.

Both sides run the committed fixture weights (hidden 64, 3 layers) on the same
numpy batches and pop one recorded noise stream (the JAX side eagerly, under
``jax.disable_jit``).  A conditional RePaint iteration draws for the denoise
step, for the re-noised known part and, between two visits of one level, for
the re-noise step.  Chains: maximum coordinate deviation 1e-3 A and no
atom-type flip, printed as they come out; loss terms 2e-4.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import diffsbdd_tpu.cli.inpaint as jax_cli
import diffsbdd_tpu_torch.cli.inpaint as port_cli
import diffsbdd_tpu_torch.diffusion.ddpm as port_ddpm
from diffsbdd_tpu.chem import pdb as jax_pdb
from diffsbdd_tpu.chem.sdfio import read_sdf, write_sdf_file
from diffsbdd_tpu.diffusion.ddpm import ConditionalDDPM as JaxConditionalDDPM
from diffsbdd_tpu.diffusion.ddpm import SimpleConditionalDDPM as JaxSimpleDDPM
from diffsbdd_tpu_torch.checkpoint import import_jax_npz
from diffsbdd_tpu_torch.chem import pdb as port_pdb
from diffsbdd_tpu_torch.chem.sdfio import read_sdf as port_read_sdf
from reference_bridge import make_queued_ddpm
from test_torch_joint import inpaint_case, queue_port
from test_torch_sampling import FIXTURE_NPZ, deviation
from test_torch_train import (A, LOSS_TOL, assert_tree_close, batches, datadir,  # noqa: F401
                              both_modules, feed, fixture_overrides, fixture_params,
                              jax_draws, jnp_batch, torch_batch)

T = 6
B, NL, NP = 2, 8, 40


def modules(fixture_params, mode="pocket_conditioning", T=T):
    jm, params, pm = both_modules(
        fixture_overrides(diffusion_params=dict(diffusion_steps=T), mode=mode),
        fixture_params)
    base = JaxSimpleDDPM if mode.endswith("simple") else JaxConditionalDDPM
    jm.ddpm.__class__ = make_queued_ddpm(base)
    return jm, params, pm


def lig_noise(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, NL, 3 + A)).astype(np.float32) for _ in range(n)]


def report(name, got, want, mask, limit=1e-3):
    dx, flips = deviation(np.asarray(got)[mask > 0], np.asarray(want)[mask > 0])
    print(f"{name}: max coordinate deviation {dx:.2e} A, {flips} type flips")
    assert dx <= limit and flips == 0


@pytest.mark.parametrize("center", ["ligand", "pocket"])
def test_inpaint_with_frames_matches_jax(fixture_params, center):
    """``inpaint`` with resamplings = 2 and a frame for every second level."""
    jm, params, pm = modules(fixture_params)
    lig, pkt, lig_fixed = inpaint_case(10)
    R, frames = 2, 3
    noise = lig_noise(11, 1 + T * (2 * R + (R - 1)) + 1)
    jm.ddpm.set_queue(list(noise))
    with jax.disable_jit():
        want = jm.ddpm.inpaint(params, jax.random.PRNGKey(0), jnp_batch(lig),
                               jnp_batch(pkt), jnp.asarray(lig_fixed),
                               resamplings=R, timesteps=T, center=center,
                               return_frames=frames)
    assert not jm.ddpm._noise_queue
    queue = list(noise)
    queue_port(pm, queue)
    got = pm.ddpm.inpaint(None, torch_batch(lig), torch_batch(pkt),
                          torch.as_tensor(lig_fixed), resamplings=R, timesteps=T,
                          center=center, return_frames=frames)
    assert not queue
    assert got[0].shape == (frames, B, NL, 3 + A)
    assert got[1].shape == (frames, B, NP, 3 + A)
    for f in range(frames):
        report(f"inpaint center={center} frame {f}, ligand", got[0][f], want[0][f],
               lig["mask"])
        report(f"inpaint center={center} frame {f}, pocket", got[1][f], want[1][f],
               pkt["mask"])


def one_pocket(pkt):
    """The first pocket of the batch replicated over it."""
    return {k: np.repeat(v[:1], len(v), axis=0) for k, v in pkt.items()}


@pytest.mark.parametrize("mode", ["pocket_conditioning", "pocket_conditioning_simple"])
def test_diversify_matches_jax(fixture_params, mode):
    jm, params, pm = modules(fixture_params, mode)
    lig, pkt, _ = inpaint_case(14)
    steps = 4
    noise = lig_noise(15, steps + 2)
    jm.ddpm.set_queue(list(noise))
    with jax.disable_jit():
        want = jm.ddpm.diversify(params, jax.random.PRNGKey(0), jnp_batch(lig),
                                 jnp_batch(pkt), noising_steps=steps)
    assert not jm.ddpm._noise_queue
    queue = list(noise)
    queue_port(pm, queue)
    got = pm.ddpm.diversify(None, torch_batch(lig), torch_batch(pkt), steps)
    assert not queue
    report(f"diversify {mode}, ligand", got[0], want[0], lig["mask"])
    report(f"diversify {mode}, pocket", got[1], want[1], pkt["mask"])


@pytest.mark.parametrize("training", [True, False])
def test_simple_loss_terms_match_jax(fixture_params, batches, training):
    jm, params, pm = both_modules(
        fixture_overrides(mode="pocket_conditioning_simple"), fixture_params)
    assert isinstance(pm.ddpm, port_ddpm.SimpleConditionalDDPM)
    lig, pkt = batches[0]["ligand"], batches[0]["pocket"]
    rng = jax.random.PRNGKey(9)
    want = jm.ddpm.loss_terms(params, rng, jnp_batch(lig), jnp_batch(pkt), training)
    t_int, noise = jax_draws(rng, lig, A, training)
    tq, nq = feed(pm, [t_int], noise)
    with torch.no_grad():
        got = pm.ddpm.loss_terms(None, torch_batch(lig), torch_batch(pkt), training)
    assert not tq and not nq
    assert_tree_close(got.pop("info"), want.pop("info"), **LOSS_TOL)
    assert_tree_close(got, want, **LOSS_TOL)


def test_simple_sampling_matches_jax(fixture_params):
    jm, params, pm = modules(fixture_params, "pocket_conditioning_simple")
    lig, pkt, _ = inpaint_case(16)
    pkt = one_pocket(pkt)
    noise = lig_noise(17, T + 2)
    jm.ddpm.set_queue(list(noise))
    with jax.disable_jit():
        want = jm.ddpm.sample_given_pocket(
            params, jax.random.PRNGKey(0), jnp_batch(pkt), jnp.asarray(lig["mask"]),
            timesteps=T, shared_pocket=True)
    assert not jm.ddpm._noise_queue
    queue = list(noise)
    queue_port(pm, queue)
    got = pm.ddpm.sample_given_pocket(None, torch_batch(pkt),
                                      torch.as_tensor(lig["mask"]), timesteps=T,
                                      shared_pocket=True)
    assert not queue
    report("simple chain, ligand", got[0], want[0], lig["mask"])
    report("simple chain, pocket", got[1], want[1], pkt["mask"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def cli_case(tmp_path, fixture_params, T=4):
    pdb = tmp_path / "pocket.pdb"
    ref = chip_smoke.write_pocket_pdb(pdb, n_atoms=40, seed=6)
    over = fixture_overrides(diffusion_params=dict(diffusion_steps=T))
    jm, params, _ = both_modules(over, fixture_params)
    jm.ddpm.__class__ = make_queued_ddpm(JaxConditionalDDPM)
    ckpt = import_jax_npz(FIXTURE_NPZ, tmp_path / "ckpt", over)
    return pdb, ref, jm, params, ckpt


def run_both(monkeypatch, tmp_path, jm, params, ckpt, args, noise):
    queue = list(noise)
    jm.ddpm.set_queue(queue)
    monkeypatch.setattr(jax_cli, "load_model", lambda *a, **k: (
        jm, types.SimpleNamespace(params=params), None))
    with jax.disable_jit():
        jax_cli.main(["unused", *args, "--outfile", str(tmp_path / "jax.sdf")])
    assert not queue
    queue = list(noise)
    monkeypatch.setattr(port_ddpm.ConditionalDDPM, "sample_gaussian",
                        lambda self, g, shape, mask:
                        torch.as_tensor(queue.pop(0)) * mask[..., None])
    port_cli.main([str(ckpt), *args, "--outfile", str(tmp_path / "port.sdf"),
                   "--device", "cpu"])
    assert not queue
    return read_sdf(tmp_path / "jax.sdf"), read_sdf(tmp_path / "port.sdf")


def assert_same_molecules(got, want, n):
    assert len(got) == len(want) == n
    dev = 0.0
    for g, w in zip(got, want):
        assert g.symbols == w.symbols
        dev = max(dev, float(np.abs(g.coords - w.coords).max()))
    print(f"inpaint CLI SDFs: max coordinate deviation {dev:.2e} A")
    assert dev <= 1e-3


@pytest.mark.parametrize("fix", ["names", "sdf"])
def test_inpaint_cli_matches_jax_cli(tmp_path, monkeypatch, fixture_params, fix):
    """Fixed atoms by name from the PDB's ligand residue, or from an SDF file."""
    t, R, n_samples = 4, 2, 2
    pdb, ref, jm, params, ckpt = cli_case(tmp_path, fixture_params, t)
    if fix == "names":
        fix_atoms, n_fixed = ["C0", "C1", "N8", "O10"], 4
    else:
        res = jax_pdb.parse_pdb(pdb).residue("A", 900)
        frag = types.SimpleNamespace(
            coords=np.array([a.coord for a in res.atoms[:3]]),
            symbols=[a.element.capitalize() for a in res.atoms[:3]], bonds=[],
            name="frag")
        write_sdf_file(tmp_path / "frag.sdf", [frag])
        assert port_read_sdf(tmp_path / "frag.sdf")[0].symbols == frag.symbols
        fix_atoms, n_fixed = [str(tmp_path / "frag.sdf")], 3
    args = ["--pdbfile", str(pdb), "--ref_ligand", ref, "--fix_atoms", *fix_atoms,
            "--n_samples", str(n_samples), "--add_n_nodes", "4", "--timesteps", str(t),
            "--resamplings", str(R)]
    rng = np.random.default_rng(18)
    noise = [rng.standard_normal((n_samples, 8, 3 + A)).astype(np.float32)
             for _ in range(1 + t * (2 * R + R - 1) + 1)]
    want, got = run_both(monkeypatch, tmp_path, jm, params, ckpt, args, noise)
    assert_same_molecules(got, want, n_samples)
    assert all(m.n_atoms == n_fixed + 4 for m in got)


def test_inpaint_cli_save_traj_matches_jax_cli(tmp_path, monkeypatch, fixture_params):
    """``--save_traj``: one sample, one molecule per level."""
    t = 4
    pdb, ref, jm, params, ckpt = cli_case(tmp_path, fixture_params, t)
    args = ["--pdbfile", str(pdb), "--ref_ligand", ref, "--fix_atoms", "C0", "C1",
            "--n_samples", "1", "--add_n_nodes", "5", "--timesteps", str(t),
            "--resamplings", "1", "--save_traj", "--center", "pocket"]
    rng = np.random.default_rng(19)
    noise = [rng.standard_normal((1, 8, 3 + A)).astype(np.float32)
             for _ in range(1 + 2 * t + 1)]
    want, got = run_both(monkeypatch, tmp_path, jm, params, ckpt, args, noise)
    assert_same_molecules(got, want, t)


def test_inpaint_cli_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main([str(tmp_path), "--pdbfile", "x.pdb", "--ref_ligand", "A:1",
                       "--fix_atoms", "C1", "--outfile", str(tmp_path / "o.sdf")])


def test_prepare_substructure_matches_jax(tmp_path):
    pdb = tmp_path / "pocket.pdb"
    ref = chip_smoke.write_pocket_pdb(pdb, n_atoms=30, seed=7)
    enc = {"C": 0, "N": 1, "O": 2}
    want = jax_cli.prepare_substructure(ref, ["C2", "N9", "O11"],
                                        jax_pdb.parse_pdb(pdb), enc)
    got = port_cli.prepare_substructure(ref, ["C2", "N9", "O11"],
                                        port_pdb.parse_pdb(pdb), enc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].argmax(-1).tolist() == [0, 1, 2]
