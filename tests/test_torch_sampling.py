"""The port's full pocket-conditional chain against the JAX chain, T = 10.

Both sides sample the committed fixture weights (hidden 64, 3 layers) on
the same synthetic pocket and consume the same recorded noise (1 prior, T
step and 1 decode draw).  The JAX chain runs eagerly (``jax.disable_jit``)
so its noise hook can pop the recorded arrays.  Reported: the maximum
coordinate deviation (Angstrom) and the number of atom-type flips; limits
1e-3 A and 0 flips.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffsbdd_tpu.chem import pdb as jax_pdb
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.diffusion.ddpm import ConditionalDDPM as JaxConditionalDDPM
from diffsbdd_tpu.train.module import build_module_from_config as jax_build
from diffsbdd_tpu.utils.params_io import load_params_npz
from diffsbdd_tpu_torch.chem import pdb as port_pdb
from diffsbdd_tpu_torch.config import load_config, snapshot_config
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_npz
from diffsbdd_tpu_torch.train.module import build_module_from_config
from reference_bridge import make_queued_ddpm
import test_torch_threads  # noqa: F401  (PyTorch threads a worker under xdist)

REPO = Path(__file__).resolve().parent.parent
FIXTURE_NPZ = REPO / "checkpoints" / "overfit_chem_fixture_best.npz"
T = 10
B, NL = 2, 8
HIST = np.ones((17, 129))


def fixture_config(T=T, egnn_impl="auto"):
    """The fixture's config (``snapshot_config``) at ``T`` steps, for either
    side."""
    return snapshot_config(FIXTURE_NPZ, {"diffusion_params": {"diffusion_steps": T},
                                         "tpu": {"egnn_impl": egnn_impl}})


def jax_module(T=T):
    module = jax_build(jax_load_config(overrides=fixture_config(T)), HIST)
    module.ddpm.__class__ = make_queued_ddpm(JaxConditionalDDPM)
    return module, load_params_npz(FIXTURE_NPZ)


def port_module():
    module = build_module_from_config(load_config(overrides=fixture_config()), HIST)
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            state_dict_from_npz(FIXTURE_NPZ).items()}, strict=True)
    return module.eval()


def noise_stream(seed, n, nl=NL):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, nl, 3 + 11)).astype(np.float32)
            for _ in range(n)]


def queue_port_noise(module, queue):
    module.ddpm.sample_gaussian = lambda g, shape, mask: \
        torch.as_tensor(queue.pop(0)) * mask[..., None]


def deviation(a, b):
    """(max coordinate deviation in A, atom-type flips) over valid atoms."""
    dx = float(np.abs(a[..., :3] - b[..., :3]).max())
    flips = int((a[..., 3:].argmax(-1) != b[..., 3:].argmax(-1)).sum())
    return dx, flips


@pytest.fixture(scope="module")
def pocket_pdb(tmp_path_factory):
    path = tmp_path_factory.mktemp("pocket") / "pocket.pdb"
    return path, chip_smoke.write_pocket_pdb(path, n_atoms=50, seed=3)


def test_prepare_pocket_matches_jax(pocket_pdb):
    path, ref = pocket_pdb
    jm, _ = jax_module()
    want = jm.prepare_pocket(jax_pdb.get_pocket_from_ligand(
        jax_pdb.parse_pdb(path), ref), repeats=B)
    got = port_module().prepare_pocket(port_pdb.get_pocket_from_ligand(
        port_pdb.parse_pdb(path), ref), repeats=B)
    for k in ("x", "one_hot", "mask", "size"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_chain_matches_jax(pocket_pdb):
    path, ref = pocket_pdb
    jm, params = jax_module()
    pm = port_module()
    residues = port_pdb.get_pocket_from_ligand(port_pdb.parse_pdb(path), ref)
    pocket = pm.prepare_pocket(residues, repeats=B)
    lig_mask = np.ones((B, NL), np.float32)
    lig_mask[1, 6:] = 0.0

    noise = noise_stream(0, T + 2)
    jm.ddpm.set_queue(list(noise))
    with jax.disable_jit():
        want, _ = jm.ddpm.sample_given_pocket(
            params, jax.random.PRNGKey(0),
            {k: jnp.asarray(v.numpy()) for k, v in pocket.items()},
            jnp.asarray(lig_mask), timesteps=T)
    assert not jm.ddpm._noise_queue

    queue = list(noise)
    queue_port_noise(pm, queue)
    got, _ = pm.ddpm.sample_given_pocket(None, pocket, torch.as_tensor(lig_mask),
                                         timesteps=T, shared_pocket=True)
    assert not queue
    m = lig_mask > 0
    dx, flips = deviation(got.numpy()[m], np.asarray(want)[m])
    print(f"T={T} chain: max coordinate deviation {dx:.2e} A, {flips} "
          f"atom-type flips")
    assert dx <= 1e-3 and flips == 0
