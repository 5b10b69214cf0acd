"""The port's whole-block function against the JAX package's on the CPU.

``block_fused_plain`` (the port's CPU path and the CUDA kernel's oracle) is
held against ``block_fused_pallas`` in interpret mode and against the dense
mirror ``block_fused_xla`` on numpy-seeded inputs (B=2, N=256, H=F=32,
cutoffs None/2.5/2.0): atol 2e-5 / rtol 1e-4 on h_new and on the dx rows below
``update_rows`` (the JAX kernel keeps whole row tiles; the port writes exact
zeros at and above ``update_rows``).  The gradient of the port's function
(autograd through the plain version, which is also what the CUDA Function's
backward runs) is held against ``jax.grad`` of ``egnn_block_step``: atol 1e-5 /
rtol 1e-4.  The network with block fusing on is held against the JAX network
with its Pallas kernels in interpret mode, for the conditional model, the
joint model and the shared pocket: atol 1e-4.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsbdd_tpu.models.dynamics import EGNNDynamics as JaxDynamics
from diffsbdd_tpu.ops.egnn_block_fused import (block_fused_pallas,
                                               block_fused_xla, egnn_block_step)
from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
from diffsbdd_tpu_torch.ops import egnn_cuda as kernels
from test_torch_dynamics import COMMON, make_batch, port_dynamics

B, N, H, F = 2, 256, 32, 32
NL = 24
CUTOFFS = (None, 2.5, 2.0)
KW = dict(cutoffs=CUTOFFS, attention=True, tanh=True, coords_range=10.0,
          norm_constant=1.0, normalization_factor=100.0)


def make_inputs(seed, with_cross=True, with_type=True, attention=True,
                n=N, b=B, f=F):
    """The operands of ``block_fused`` as numpy arrays (None where absent)."""
    rng = np.random.default_rng(seed)
    nrm = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    h = nrm(b, n, f)
    a_row, a_col = nrm(b, n, f), nrm(b, n, f)
    x = nrm(b, n, 3) * 3.0
    x0 = x + nrm(b, n, 3) * 0.1
    mask = (rng.uniform(size=(b, n)) > 0.1).astype(np.float32)
    mask[:, 0] = 1.0
    is_lig = np.broadcast_to((np.arange(n) < NL).astype(np.float32), (b, n)).copy()
    gcl = dict(w_d2=nrm(f), w_d20=nrm(f), type_delta=nrm(f) if with_type else None,
               w2=nrm(f, f), b2=nrm(f),
               w_att=nrm(f, 1) if attention else None,
               b_att=nrm(1) if attention else None)
    node = dict(w_h=nrm(f, f), w_a=nrm(f, f), b0=nrm(f), w2=nrm(f, f), b2=nrm(f))

    def head():
        return dict(k_i=nrm(f, f), k_j=nrm(f, f), b0=nrm(f), w_d2=nrm(f),
                    w_d20=nrm(f), type_bias=nrm(2, 2, f) if with_type else None,
                    w1=nrm(f, f), b1=nrm(f), w3=nrm(f, 1) * 1e-2)

    coord = head()
    cross = head() if with_cross else None
    graph_mean = nrm(b, 3) if with_cross else None
    return [h, a_row, a_col, x, x0, mask, is_lig, gcl, node, coord, cross,
            graph_mean]


def convert(ins, fn):
    def one(v):
        if isinstance(v, dict):
            return {k: one(u) for k, u in v.items()}
        return None if v is None else fn(v)
    return [one(v) for v in ins]


def check_outputs(got, ref, update_rows):
    rows = N if update_rows is None else update_rows
    got_h, got_dx = (g.detach().numpy() for g in got)
    np.testing.assert_allclose(got_h, np.asarray(ref[0]), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got_dx[:, :rows], np.asarray(ref[1])[:, :rows],
                               atol=2e-5, rtol=1e-4)
    assert not got_dx[:, rows:].any()


@pytest.mark.parametrize("with_cross", [True, False])
@pytest.mark.parametrize("update_rows", [NL, None])
def test_plain_matches_jax(with_cross, update_rows):
    ins = make_inputs(0, with_cross=with_cross)
    got = kernels.block_fused(*convert(ins, torch.as_tensor),
                              update_rows=update_rows, **KW)
    jins = convert(ins, jnp.asarray)
    check_outputs(got, block_fused_pallas(*jins, update_rows=update_rows,
                                          interpret=True, **KW), update_rows)
    check_outputs(got, block_fused_xla(*jins, update_rows=update_rows, **KW),
                  update_rows)


def test_plain_no_attention_no_type_matches_jax():
    ins = make_inputs(1, with_cross=False, with_type=False, attention=False)
    kw = dict(KW, attention=False)
    got = kernels.block_fused(*convert(ins, torch.as_tensor), update_rows=NL, **kw)
    jins = convert(ins, jnp.asarray)
    check_outputs(got, block_fused_pallas(*jins, update_rows=NL, interpret=True,
                                          **kw), NL)
    check_outputs(got, block_fused_xla(*jins, update_rows=NL, **kw), NL)


def test_gradients_match_jax():
    """Cotangents of h, a_row and the coordinate head's dict for the loss
    sum(h_new^2) + sum(dx[:, :update_rows]^2) (the JAX function keeps whole
    row tiles of dx, the port exact zeros), through ``block_fused_bwd_plain``
    (the backward of the CUDA Function) and through plain autograd on the CPU
    path."""
    ins = make_inputs(2)
    jins = convert(ins, jnp.asarray)

    def loss(h, a_row, coord):
        full = [h, a_row] + jins[2:9] + [coord] + jins[10:]
        h_new, dx = egnn_block_step(*full, update_rows=NL, impl="pallas",
                                    interpret=True, **KW)
        return jnp.sum(h_new ** 2) + jnp.sum(dx[:, :NL] ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jins[0], jins[1], jins[9])

    tins = convert(ins, torch.as_tensor)
    kw = dict(KW, update_rows=NL)
    with torch.no_grad():
        h_new, dx = kernels.block_fused_plain(*tins, **kw)
    grads = kernels.block_fused_bwd_plain(2 * h_new, 2 * dx, *tins, **kw)
    packed = kernels._pack_block(*tins[7:])
    n_lead = 5 + len(kernels._GCL_KEYS) + len(kernels._NODE_KEYS)
    got_coord = dict(zip(kernels._HEAD_KEYS, grads[n_lead:n_lead + 9]))
    assert len(grads) == 5 + len(packed)

    def close(g, w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)

    close(grads[0], want[0])
    close(grads[1], want[1])
    for k, w in want[2].items():
        close(got_coord[k], w)

    # the CPU path: plain autograd through the public wrapper
    leaves = convert(ins, lambda a: torch.as_tensor(a).requires_grad_(True))
    h_new, dx = kernels.block_fused(*leaves, **kw)
    ((h_new ** 2).sum() + (dx ** 2).sum()).backward()
    close(leaves[0].grad, want[0])
    close(leaves[1].grad, want[1])
    for k, w in want[2].items():
        close(leaves[9][k].grad, w)


@pytest.fixture(scope="module")
def fixture_params():
    from test_torch_dynamics import FIXTURE
    from diffsbdd_tpu.utils.params_io import load_params_npz
    return load_params_npz(FIXTURE)


@pytest.mark.parametrize("update_pocket,shared", [(False, False), (True, False),
                                                  (False, True)])
def test_dynamics_block_fuse_matches_jax(fixture_params, update_pocket, shared):
    """The fixture weights through both networks with block fusing on: every
    block is the whole-block function in the joint model and without the
    shared pocket; with it, block 0 keeps the split path."""
    batch = make_batch(0)
    jax_model = JaxDynamics(**COMMON, update_pocket_coords=update_pocket,
                            impl="pallas", interpret=True, kernel_tile=32,
                            kernel_tile_i=8, kernel_sub_j=8, kernel_block_fuse=True)
    apply = jax.jit(jax_model.apply, static_argnames=("shared_pocket", "block_fuse"))
    ref = apply(fixture_params["dynamics"], *map(jnp.asarray, batch),
                shared_pocket=shared, block_fuse=True)
    port = port_dynamics(fixture_params, update_pocket_coords=update_pocket,
                         kernel_block_fuse=True)
    calls = []
    plain = kernels.block_fused
    try:
        kernels.block_fused = lambda *a, **k: (calls.append(1), plain(*a, **k))[1]
        with torch.no_grad():
            got = port(*map(torch.as_tensor, batch), shared_pocket=shared,
                       block_fuse=True)
            split = port(*map(torch.as_tensor, batch), shared_pocket=shared)
    finally:
        kernels.block_fused = plain
    assert len(calls) == (2 if shared else 3)
    for g, r, s in zip(got, ref, split):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
        np.testing.assert_allclose(g.numpy(), s.numpy(), atol=1e-5, rtol=1e-5)


def test_block_fuse_needs_the_switch(fixture_params):
    """``kernel_block_fuse=False`` keeps the samplers' request from reaching
    the whole-block function.  The switch defaults to True, as the JAX
    package's ``kernel_block_fuse`` field does."""
    default = inspect.signature(EGNNDynamics).parameters["kernel_block_fuse"].default
    assert default is True
    assert default == JaxDynamics.__dataclass_fields__["kernel_block_fuse"].default
    batch = [torch.as_tensor(a) for a in make_batch(0)]
    port = port_dynamics(fixture_params, kernel_block_fuse=False)
    assert port.kernel_block_fuse is False
    plain = kernels.block_fused
    try:
        def refuse(*a, **k):
            raise AssertionError("block_fused called with the switch off")
        kernels.block_fused = refuse
        with torch.no_grad():
            port(*batch, block_fuse=True)
    finally:
        kernels.block_fused = plain
