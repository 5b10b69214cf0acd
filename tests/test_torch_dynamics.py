"""The port's EGNNDynamics against the JAX EGNNDynamics on the CPU.

The committed fixture weights (hidden 64, 3 layers, joint_nf 32, SE(3) cross
branch, attention, cutoffs None/5/5) go through both; the JAX side runs its
dense XLA path and its Pallas kernels in interpret mode, with the
shared-pocket factorization off and on.  Tolerance atol 1e-4 on eps: float32
on both sides with other summation orders through 3 layers.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsbdd_tpu.models.dynamics import EGNNDynamics as JaxDynamics
from diffsbdd_tpu.utils.params_io import load_params_npz
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_jax
from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
import test_torch_threads  # noqa: F401  (PyTorch threads a worker under xdist)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "checkpoints" / "overfit_chem_fixture_best.npz"
ATOM_NF = RESIDUE_NF = 11
COMMON = dict(atom_nf=ATOM_NF, residue_nf=RESIDUE_NF, joint_nf=32,
              hidden_nf=64, n_layers=3, attention=True, tanh=True,
              norm_constant=1, inv_sublayers=1, reflection_equivariant=False,
              edge_cutoff_ligand=None, edge_cutoff_pocket=5.0,
              edge_cutoff_interaction=5.0)
# the port's network is the pocket-conditional one (pocket coordinates fixed)
JAX_ONLY = dict(update_pocket_coords=False)
# what ``port_dynamics`` builds unless told otherwise: the pocket-conditional
# network on the split path (both packages default to the joint network's
# moving pocket and to block fusing)
PORT_DEFAULTS = dict(update_pocket_coords=False, kernel_block_fuse=False)


def make_batch(seed, B=2, NL=8, NP=40, shared=True):
    """Padded ligand/pocket batch from a numpy seed; with ``shared`` one
    pocket is replicated across the batch, as in sampling."""
    rng = np.random.default_rng(seed)
    x_p = rng.uniform(-6, 6, (1 if shared else B, NP, 3))
    h_p = np.eye(RESIDUE_NF)[rng.integers(0, 4, (1 if shared else B, NP))]
    x_p, h_p = np.broadcast_to(x_p, (B, NP, 3)), np.broadcast_to(h_p, (B, NP, RESIDUE_NF))
    x_l = rng.standard_normal((B, NL, 3)) * 1.5
    h_l = rng.standard_normal((B, NL, ATOM_NF)) * 0.5
    m_l = np.ones((B, NL))
    m_l[1, NL - 2:] = 0
    m_p = np.ones((B, NP))
    m_p[:, NP - 5:] = 0
    xh_l = np.concatenate([x_l, h_l], -1) * m_l[..., None]
    xh_p = np.concatenate([x_p, h_p], -1) * m_p[..., None]
    t = np.full((B, 1), 0.37)
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (xh_l, xh_p, t, m_l, m_p)]


def port_dynamics(params, **overrides):
    model = EGNNDynamics(**{**COMMON, **PORT_DEFAULTS, **overrides})
    sd = state_dict_from_jax(params)
    prefix = "ddpm.dynamics."
    model.load_state_dict({k[len(prefix):]: torch.tensor(v)
                           for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def fixture_params():
    return load_params_npz(FIXTURE)


@pytest.mark.parametrize("impl,shared", [("xla", False), ("pallas", False),
                                         ("pallas", True)])
def test_dynamics_matches_jax(fixture_params, impl, shared):
    batch = make_batch(0)
    kw = dict(impl=impl)
    if impl == "pallas":
        kw.update(interpret=True, kernel_tile=32, kernel_tile_i=8,
                  kernel_sub_j=8, kernel_skip_mode="compact")
    apply = jax.jit(JaxDynamics(**COMMON, **JAX_ONLY, **kw).apply,
                    static_argnames="shared_pocket")
    ref = apply(fixture_params["dynamics"], *map(jnp.asarray, batch),
                shared_pocket=shared)
    with torch.no_grad():
        got = port_dynamics(fixture_params)(*map(torch.as_tensor, batch),
                                            shared_pocket=shared)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_shared_pocket_factorization_is_exact(fixture_params):
    """The B=1 pocket-pocket block broadcast equals the full first layer."""
    batch = [torch.as_tensor(a) for a in make_batch(1)]
    model = port_dynamics(fixture_params)
    with torch.no_grad():
        a = model(*batch, shared_pocket=True)
        b = model(*batch, shared_pocket=False)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, atol=1e-5, rtol=1e-5)


def test_edge_type_embedding_matches_jax():
    """The 3-way edge-type embedding (folded into the kernels' row/column
    projections plus a rank-1 ligand-ligand term) on freshly initialized
    weights."""
    cfg = dict(COMMON, joint_nf=8, hidden_nf=16, n_layers=2,
               edge_embedding_dim=4)
    batch = make_batch(2, shared=False)
    jax_model = JaxDynamics(**cfg, **JAX_ONLY, impl="xla")
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                     *map(jnp.asarray, batch))
    params = jax.tree_util.tree_map(np.asarray, params)
    ref = jax.jit(jax_model.apply)(params, *map(jnp.asarray, batch))
    port = port_dynamics({"dynamics": params}, **{k: cfg[k] for k in (
        "joint_nf", "hidden_nf", "n_layers", "edge_embedding_dim")})
    with torch.no_grad():
        got = port(*map(torch.as_tensor, batch))
    assert "ddpm.dynamics.edge_embedding.weight" in state_dict_from_jax(
        {"dynamics": params})
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
