"""The port's backward wrappers on the CPU (plain versions: autograd through
the plain twins) against the JAX backward kernels and against ``jax.grad``.

The JAX side runs ``gcl_agg_bwd_pallas`` / ``coord_agg_bwd_pallas`` in
interpret mode, as tests/test_pallas_bwd.py runs them, and ``jax.vjp`` of the
dense XLA mirrors.  The port side does what its autograd Functions do on a
card: fold the edge-type table outside, call the backward wrapper on the
folded operands, chain the fold with autograd.  The CUDA kernels are held
against the same plain versions in test_torch_gpu.py.

Tolerance atol 1e-4, rtol 1e-3, as the JAX package's own backward test uses:
float32 everywhere, but each cotangent sums up to B*N*N pair terms in another
order on each side.  The JAX kernels keep whole ``tile_i`` row tiles and the
port exact rows, so ``update_rows`` is a multiple of the tile and the output
cotangent is zero past it on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsbdd_tpu.ops.egnn_pallas as ep
import diffsbdd_tpu.ops.egnn_pallas_bwd as epb
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
from test_torch_kernels import (B, CUTOFFS, F, N, _jnp, _torch, coord_args, gcl_args,
                                make_inputs)

TOL = dict(atol=1e-4, rtol=1e-3)
TILES = dict(tile_i=8, tile_j=N, sub_j=16)
MLP_KEYS = ("a_row", "a_col", "w_d2", "w_d20", "type_bias", "w2", "b2", "w3")


def cotangent(seed, width, update_rows):
    g = np.random.default_rng(seed).standard_normal((B, N, width)).astype(np.float32)
    if update_rows is not None:
        g[:, update_rows:] = 0.0
    return g


def _d2_0(x0):
    d = x0[:, :, None, :] - x0[:, None, :, :]
    return jnp.sum(d * d, -1)


def _close(got, ref, name):
    if ref is None:
        assert got is None, name
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=name,
                               **TOL)


def _port_mlp_cotangents(ops, is_lig, bwd):
    """Fold the type table of one pair MLP, run ``bwd(a_row_f, a_col_f,
    delta)`` -> (da_row_f, da_col_f, ddelta), and chain the fold back to
    (a_row, a_col, type_bias)."""
    a_row = ops["a_row"].clone().requires_grad_(True)
    a_col = ops["a_col"].clone().requires_grad_(True)
    tb = None if ops["type_bias"] is None else \
        ops["type_bias"].clone().requires_grad_(True)
    row_f, col_f, delta = ec.fold_type_bias(a_row, a_col, is_lig, tb)
    d_row, d_col, d_delta = bwd(row_f.detach(), col_f.detach(),
                                None if delta is None else delta.detach())
    outs, leaves, cots = [row_f, col_f], [a_row, a_col], [d_row, d_col]
    if tb is not None:
        outs.append(delta), leaves.append(tb), cots.append(d_delta)
    grads = torch.autograd.grad(outs, leaves, grad_outputs=cots)
    return grads[0], grads[1], grads[2] if tb is not None else None


# ---------------------------------------------------------------------------
# GCL aggregation
# ---------------------------------------------------------------------------

GCL_NAMES = ("a_row", "a_col", "x", "x0", "w_d2", "w_d20", "type_bias", "w2", "b2",
             "w_att", "b_att")


def _port_gcl_bwd(g, args, kw):
    """{operand name: cotangent} through ``ec.gcl_agg_bwd`` and the fold."""
    a = dict(zip(("a_row", "a_col", "x", "x0", "mask", "is_lig", "w_d2", "w_d20",
                  "type_bias", "w2", "b2", "w_att", "b_att"),
                 [_torch(v) for v in args]))
    out = {}

    def bwd(row_f, col_f, delta):
        cot = ec.gcl_agg_bwd(torch.as_tensor(g), row_f, col_f, a["x"], a["x0"],
                             a["mask"], a["is_lig"], a["w_d2"], a["w_d20"], delta,
                             a["w2"], a["b2"], a["w_att"], a["b_att"], **kw)
        (_, _, out["x"], out["x0"], out["w_d2"], out["w_d20"], _, out["w2"],
         out["b2"], out["w_att"], out["b_att"]) = cot
        return cot[0], cot[1], cot[6]

    out["a_row"], out["a_col"], out["type_bias"] = _port_mlp_cotangents(
        a, a["is_lig"], bwd)
    return out


@pytest.mark.parametrize("attention,with_tb,update_rows,col_mask_on,use_bits", [
    (True, True, None, False, True),
    (False, True, None, False, False),
    (True, False, 16, False, True),
    (False, False, 16, True, False),
    (True, True, None, True, False),
])
def test_gcl_bwd_plain_matches_jax(attention, with_tb, update_rows, col_mask_on,
                                   use_bits):
    ops = make_inputs(11, with_type_bias=with_tb)
    args = gcl_args(ops)
    if not attention:
        args[-2] = args[-1] = None
    col_mask = None
    if col_mask_on:
        col_mask = (np.random.default_rng(12).uniform(size=(B, N)) > 0.3) \
            .astype(np.float32)
    g = cotangent(13, F, update_rows)
    kw = dict(cutoffs=CUTOFFS, attention=attention, normalization_factor=100.0,
              update_rows=update_rows)

    got = _port_gcl_bwd(g, args, dict(kw, col_mask=_torch(col_mask)))

    jargs = [_jnp(v) for v in args]
    kernel = epb.gcl_agg_bwd_pallas(
        jnp.asarray(g), *jargs, **kw, **TILES, col_mask=_jnp(col_mask),
        d2_0=_d2_0(jargs[3]) if use_bits else None, interpret=True)
    kernel = dict(zip(("a_row", "a_col", "x", "x0", "mask", "is_lig", "w_d2", "w_d20",
                       "type_bias", "w2", "b2", "w_att", "b_att"), kernel))
    diff = [i for i, v in enumerate(jargs) if v is not None and i not in (4, 5)]

    def mirror(*dargs):
        full = list(jargs)
        for i, v in zip(diff, dargs):
            full[i] = v
        return ep.gcl_message_agg_xla(*full, **kw, col_mask=_jnp(col_mask),
                                      tile_i=TILES["tile_i"])

    _, vjp = jax.vjp(mirror, *[jargs[i] for i in diff])
    names = ("a_row", "a_col", "x", "x0", "mask", "is_lig", "w_d2", "w_d20",
             "type_bias", "w2", "b2", "w_att", "b_att")
    grad = dict.fromkeys(GCL_NAMES)
    grad.update({names[i]: v for i, v in zip(diff, vjp(jnp.asarray(g)))})

    for name in GCL_NAMES:
        _close(got[name], kernel[name], f"{name} vs the Pallas backward kernel")
        _close(got[name], grad[name], f"{name} vs jax.vjp of the XLA mirror")


# ---------------------------------------------------------------------------
# coordinate update
# ---------------------------------------------------------------------------

def _port_coord_bwd(g, main, cross, graph_mean, kw):
    """({name: cotangent} of the coordinate MLP and the coordinates, the same
    of the cross MLP or None, dmean or None) through ``ec.coord_agg_bwd``."""
    names = ("a_row", "a_col", "x", "x0", "mask", "is_lig", "w_d2", "w_d20",
             "type_bias", "w2", "b2", "w3")
    a = dict(zip(names, [_torch(v) for v in main]))
    c = _torch(cross)
    out, cout, extra = {}, {}, {}

    def run(row_f, col_f, delta, cross_folded):
        cot = ec.coord_agg_bwd(
            torch.as_tensor(g), row_f, col_f, a["x"], a["x0"], a["mask"],
            a["is_lig"], a["w_d2"], a["w_d20"], delta, a["w2"], a["b2"], a["w3"],
            cross=cross_folded, graph_mean=_torch(graph_mean), **kw)
        m = cot[0]
        (_, _, out["x"], out["x0"], out["w_d2"], out["w_d20"], _, out["w2"],
         out["b2"], out["w3"]) = m
        extra["cross"], extra["dmean"] = cot[1], cot[2]
        return m[0], m[1], m[6]

    if c is None:
        out["a_row"], out["a_col"], out["type_bias"] = _port_mlp_cotangents(
            a, a["is_lig"], lambda r, cl, d: run(r, cl, d, None))
        return out, None, None

    def cross_bwd(c_row_f, c_col_f, c_delta):
        folded = dict(a_row=c_row_f, a_col=c_col_f, w_d2=c["w_d2"], w_d20=c["w_d20"],
                      delta=c_delta, w2=c["w2"], b2=c["b2"], w3=c["w3"])
        out["a_row"], out["a_col"], out["type_bias"] = _port_mlp_cotangents(
            a, a["is_lig"], lambda r, cl, d: run(r, cl, d, folded))
        cc = extra["cross"]
        cout.update({k: cc[k] for k in ("w_d2", "w_d20", "w2", "b2", "w3")})
        return cc["a_row"], cc["a_col"], cc["delta"]

    cout["a_row"], cout["a_col"], cout["type_bias"] = _port_mlp_cotangents(
        c, a["is_lig"], cross_bwd)
    return out, cout, extra["dmean"]


@pytest.mark.parametrize("with_cross,tanh,update_rows,with_tb,use_bits", [
    (False, True, None, True, True),
    (True, True, None, True, True),
    (True, False, None, False, False),
    (True, True, 16, True, False),
])
def test_coord_bwd_plain_matches_jax(with_cross, tanh, update_rows, with_tb, use_bits):
    main, cross, graph_mean = coord_args(make_inputs(21, with_type_bias=with_tb),
                                         with_cross)
    if cross is not None and not with_tb:
        cross["type_bias"] = None
    g = cotangent(23, 3, update_rows)
    kw = dict(cutoffs=CUTOFFS, tanh=tanh, coords_range=2.5, norm_constant=1.0,
              normalization_factor=100.0, update_rows=update_rows)

    got, got_cross, got_mean = _port_coord_bwd(g, main, cross, graph_mean, kw)

    jmain, jcross, jmean = [_jnp(v) for v in main], _jnp(cross), _jnp(graph_mean)
    k_main, k_cross, k_mean = epb.coord_agg_bwd_pallas(
        jnp.asarray(g), *jmain, **kw, **TILES, cross=jcross, graph_mean=jmean,
        d2_0=_d2_0(jmain[3]) if use_bits else None, interpret=True)
    names = ("a_row", "a_col", "x", "x0", "mask", "is_lig", "w_d2", "w_d20",
             "type_bias", "w2", "b2", "w3")
    k_main = dict(zip(names, k_main))
    diff = [i for i, v in enumerate(jmain) if v is not None and i not in (4, 5)]

    def mirror(dargs, c, gm):
        full = list(jmain)
        for i, v in zip(diff, dargs):
            full[i] = v
        return ep.coord_update_agg_xla(*full, **kw, cross=c, graph_mean=gm,
                                       tile_i=TILES["tile_i"])

    _, vjp = jax.vjp(mirror, [jmain[i] for i in diff], jcross, jmean)
    v_main, v_cross, v_mean = vjp(jnp.asarray(g))
    v_main = dict(zip([names[i] for i in diff], v_main))

    for name in got:
        _close(got[name], k_main[name], f"{name} vs the Pallas backward kernel")
        _close(got[name], v_main.get(name), f"{name} vs jax.vjp of the XLA mirror")
    if not with_cross:
        assert got_cross is None and got_mean is None
        return
    for name in MLP_KEYS:
        _close(got_cross[name], k_cross[name], f"cross.{name} vs the kernel")
        _close(got_cross[name], v_cross[name], f"cross.{name} vs jax.vjp")
    _close(got_mean, k_mean, "dmean vs the Pallas backward kernel")
    _close(got_mean, v_mean, "dmean vs jax.vjp of the XLA mirror")


def test_bwd_plain_is_finite_on_coincident_nodes():
    """Padded nodes share the origin and every node is its own neighbour: the
    guarded norms keep every cotangent finite there, with and without masks."""
    main, cross, graph_mean = coord_args(make_inputs(31), True)
    main[2][:, -6:] = 0.0   # x: coincident (padded) nodes
    main[3][:, -6:] = 0.0   # x0
    main[4][:, -6:] = 0.0   # mask
    kw = dict(cutoffs=(None, None, None), tanh=True, coords_range=2.5,
              norm_constant=1.0, normalization_factor=100.0, update_rows=None)
    got, got_cross, got_mean = _port_coord_bwd(cotangent(33, 3, None), main, cross,
                                               graph_mean, kw)
    for name, v in {**got, **{f"cross.{k}": v for k, v in got_cross.items()},
                    "dmean": got_mean}.items():
        assert torch.isfinite(v).all(), name
    assert not got["x"][:, -6:].any()  # masked nodes get exact zeros


def test_bwd_wrappers_launch_nothing_on_cpu():
    ec.reset_launch_counts()
    args = gcl_args(make_inputs(41))
    _port_gcl_bwd(cotangent(42, F, None), args,
                  dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0))
    assert not any(ec.launch_counts.values())


def test_public_wrappers_are_differentiable_on_cpu():
    """On CPU tensors the public wrappers are the plain twins under plain
    autograd: the gradient of a scalar equals the backward wrapper's."""
    args = [_torch(v) for v in gcl_args(make_inputs(51))]
    leaves = [a.clone().requires_grad_(True) if i not in (4, 5) else a
              for i, a in enumerate(args)]
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    out = ec.gcl_message_agg(*leaves, **kw)
    g = torch.as_tensor(cotangent(52, F, None))
    grads = torch.autograd.grad(out, [leaves[i] for i in (2, 3, 9)], grad_outputs=g)
    want = _port_gcl_bwd(g.numpy(), [a.numpy() for a in args], kw)
    for got, name in zip(grads, ("x", "x0", "w2")):
        torch.testing.assert_close(got, want[name], **TOL)
