"""The port's EGNN kernels on the CPU: plain twins against the JAX Pallas
kernels (interpret mode, compact skip).  The CUDA kernels are held against the
twins in test_torch_gpu.py.

Tolerance atol 1e-5, rtol 1e-4: both sides are float32 but sum the pairs in
another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsbdd_tpu.ops.egnn_pallas as ep
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
import test_torch_threads  # noqa: F401  (PyTorch threads a worker under xdist)

B, N, F = 2, 48, 64
CUTOFFS = (None, 5.0, 5.0)
TOL = dict(atol=1e-5, rtol=1e-4)


def make_inputs(seed, batch=B, with_type_bias=True):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    x = f(batch, N, 3, scale=3.0)
    ops = dict(
        a_row=f(batch, N, F, scale=0.3), a_col=f(batch, N, F, scale=0.3),
        x=x, x0=(x + f(batch, N, 3, scale=0.1)).astype(np.float32),
        mask=(rng.uniform(size=(batch, N)) > 0.2).astype(np.float32),
        is_lig=(np.arange(N)[None].repeat(batch, 0) < 12).astype(np.float32),
        w_d2=f(F, scale=0.1), w_d20=f(F, scale=0.1),
        type_bias=f(2, 2, F, scale=0.2) if with_type_bias else None,
        w2=f(F, F, scale=0.3), b2=f(F, scale=0.1))
    return ops


def gcl_args(ops, seed=0):
    rng = np.random.default_rng(seed + 100)
    w_att = (rng.standard_normal((F, 1)) * 0.3).astype(np.float32)
    keys = ("a_row", "a_col", "x", "x0", "mask", "is_lig", "w_d2", "w_d20",
            "type_bias", "w2", "b2")
    return [ops[k] for k in keys] + [w_att, np.array([0.1], np.float32)]


def coord_args(ops, with_cross, seed=0):
    rng = np.random.default_rng(seed + 200)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    w3 = f(F, 1, scale=0.3)
    keys = ("a_row", "a_col", "x", "x0", "mask", "is_lig", "w_d2", "w_d20",
            "type_bias", "w2", "b2")
    main = [ops[k] for k in keys] + [w3]
    cross = graph_mean = None
    if with_cross:
        cross = dict(a_row=f(B, N, F, scale=0.3), a_col=f(B, N, F, scale=0.3),
                     w_d2=f(F, scale=0.1), w_d20=f(F, scale=0.1),
                     type_bias=f(2, 2, F, scale=0.2), w2=f(F, F, scale=0.3),
                     b2=f(F, scale=0.1), w3=w3)
        m = ops["mask"]
        graph_mean = ((ops["x"] * m[..., None]).sum(1)
                      / m.sum(1)[:, None]).astype(np.float32)
    return main, cross, graph_mean


def _d2_0(x0):
    d = x0[:, :, None, :] - x0[:, None, :, :]
    return jnp.sum(d * d, -1)


def _jnp(a):
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _jnp(v) for k, v in a.items()}
    return jnp.asarray(a)


def _torch(a, device="cpu"):
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _torch(v, device) for k, v in a.items()}
    return torch.as_tensor(a, device=device)


def _jax_gcl(args, col_mask=None, update_rows=None, attention=True):
    a = [_jnp(v) for v in args]
    if not attention:
        a[-2] = a[-1] = None
    return np.asarray(ep.gcl_message_agg(
        *a, cutoffs=CUTOFFS, attention=attention, normalization_factor=100.0,
        impl="pallas", interpret=True, skip_mode="compact", sub_j=8,
        col_mask=_jnp(col_mask), update_rows=update_rows, d2_0=_d2_0(a[3])))


def _port_gcl(args, col_mask=None, update_rows=None, attention=True,
              device="cpu", fn=ec.gcl_message_agg):
    a = [_torch(v, device) for v in args]
    if not attention:
        a[-2] = a[-1] = None
    return fn(*a, cutoffs=CUTOFFS, attention=attention,
              normalization_factor=100.0, col_mask=_torch(col_mask, device),
              update_rows=update_rows).cpu().numpy()


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("with_type_bias", [True, False])
def test_gcl_plain_matches_jax_pallas(attention, with_type_bias):
    args = gcl_args(make_inputs(1, with_type_bias=with_type_bias))
    np.testing.assert_allclose(_port_gcl(args, attention=attention),
                               _jax_gcl(args, attention=attention), **TOL)


def test_gcl_plain_col_mask_and_update_rows():
    """The shared-pocket variants: ligand rows over all columns, with the
    rows truncated to the ligand.  The JAX kernel keeps whole row tiles, so
    only the first ``update_rows`` rows are compared; the port's later rows
    are exact zeros."""
    ops = make_inputs(2)
    args = gcl_args(ops)
    lig = ops["mask"] * ops["is_lig"]
    got = _port_gcl(args, col_mask=ops["mask"], update_rows=12)
    ref = _jax_gcl(args, col_mask=ops["mask"], update_rows=12)
    np.testing.assert_allclose(got[:, :12], ref[:, :12], **TOL)
    assert not got[:, 12:].any()
    np.testing.assert_allclose(_port_gcl(args, col_mask=lig),
                               _jax_gcl(args, col_mask=lig), **TOL)


def test_gcl_plain_batch_one_pocket_block():
    """B = 1, pocket rows over pocket columns (the broadcast block)."""
    ops = make_inputs(3, batch=1)
    pkt = ops["mask"] * (1 - ops["is_lig"])
    ops["mask"] = pkt
    args = gcl_args(ops)
    np.testing.assert_allclose(_port_gcl(args, col_mask=pkt),
                               _jax_gcl(args, col_mask=pkt), **TOL)


@pytest.mark.parametrize("with_cross", [False, True])
@pytest.mark.parametrize("update_rows", [None, 12])
def test_coord_plain_matches_jax_pallas(with_cross, update_rows):
    main, cross, graph_mean = coord_args(make_inputs(4), with_cross)
    kw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0,
              norm_constant=1.0, normalization_factor=100.0,
              update_rows=update_rows)
    ref = np.asarray(ep.coord_update_agg(
        *map(_jnp, main), **kw, cross=_jnp(cross), graph_mean=_jnp(graph_mean),
        impl="pallas", interpret=True, skip_mode="compact", sub_j=8,
        d2_0=_d2_0(jnp.asarray(main[3]))))
    got = ec.coord_update_agg(
        *map(_torch, main), **kw, cross=_torch(cross),
        graph_mean=_torch(graph_mean)).numpy()
    rows = N if update_rows is None else update_rows
    np.testing.assert_allclose(got[:, :rows], ref[:, :rows], **TOL)
    assert not got[:, rows:].any()


@pytest.mark.parametrize("cutoffs", [CUTOFFS, (None, None, None),
                                     (4.0, 6.0, 3.0)])
def test_adjacency_matches_jax_build_adjacency(cutoffs):
    """The twins' adjacency against the JAX dense path's ``build_adjacency``
    over the ligand-first concatenated node set (self-edges kept)."""
    from diffsbdd_tpu.models.dynamics import build_adjacency
    ops = make_inputs(7)
    nl = int(ops["is_lig"][0].sum())
    x, m = ops["x0"], ops["mask"]
    ref = build_adjacency(x[:, :nl], x[:, nl:], m[:, :nl], m[:, nl:], *cutoffs)
    xt = torch.as_tensor(x)
    got = ec.adjacency_dense(((xt[:, :, None] - xt[:, None]) ** 2).sum(-1),
                             torch.as_tensor(m), torch.as_tensor(ops["is_lig"]),
                             cutoffs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fold_type_bias_matches_jax():
    ops = make_inputs(5)
    ref = ep.fold_type_bias(*(_jnp(ops[k]) for k in
                              ("a_row", "a_col", "is_lig", "type_bias")))
    got = ec.fold_type_bias(*(_torch(ops[k]) for k in
                              ("a_row", "a_col", "is_lig", "type_bias")))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_wrapper_counts_no_launch_on_cpu():
    """On CPU tensors the wrappers take the twins and launch nothing."""
    ec.reset_launch_counts()
    _port_gcl(gcl_args(make_inputs(6)))
    assert ec.launch_counts == {"gcl_agg": 0, "coord_agg": 0, "gcl_agg_bwd": 0,
                                "coord_agg_bwd": 0, "block_fused": 0}


@pytest.mark.parametrize("width", [32, 64, 96, 128, 160, 192, 224, 256, 320, 384, 448,
                                   512, 640, 768, 896, 1024, 1088, 2048, 2112, 3072, 4096,
                                   4160])
def test_kernel_widths(width):
    """The five kernels are built for hidden widths 64, 128 (the config
    default), 256, 512, 1024 (on tiles of two rows and one, ``ec.row_tile``),
    2048 (a row tile on a cluster of two blocks, ``ec.cluster_size``) and
    4096 (a cluster of four); every other width up to 4096 runs zero-padded
    to the next of the widths, and a wider one is refused before a launch,
    naming the ROADMAP item, never run by the plain version on the card:
    1088 and 2048 run on every kernel at 2048, 2112, 3072 and 4096 on every
    kernel at 4096; 4160 is refused by every kernel, naming "widths above
    4096"."""
    assert ec.SUPPORTED_F == (64, 128, 256, 512, 1024, 2048, 4096)
    assert [ec.row_tile(f) for f in ec.SUPPORTED_F] == [4, 4, 4, 2, 1, 1, 1]
    assert [ec.cluster_size(f) for f in ec.SUPPORTED_F] == [1, 1, 1, 1, 1, 2, 4]
    for name in ec.KERNELS:
        widths = ec.KERNEL_WIDTHS[name]
        assert widths == ec.SUPPORTED_F, name
        assert ec.WIDER_ITEM[name] == "widths above 4096", name
        text = (ec.CSRC / f"{name}.cu").read_text()
        assert all(f"case {f}: return launch<{f}>(" in text for f in widths), name
        if width <= widths[-1]:
            want = min(f for f in widths if f >= width)
            assert ec.padded_width(width, name, name) == want
            w2 = torch.ones(width, width)
            padded = ec.pad_operands(dict(w2=w2), width, want)["w2"]
            assert padded.shape == (want, want) and padded.sum() == width * width
        else:
            with pytest.raises(ValueError, match=f"{name}: feature width {width} above "
                               f"{widths[-1]}.*ROADMAP.*{ec.WIDER_ITEM[name]}"):
                ec.padded_width(width, name, name)


@pytest.mark.parametrize("width,refused", [(1088, False), (2112, False), (3072, False),
                                           (4096, False), (4160, True)])
def test_forward_wrappers_refuse_an_untrainable_width(width, refused):
    """A forward wrapper whose output will need a gradient through a backward
    kernel (grad mode on, an operand that requires it) at a width that
    kernel is not built for raises before any launch, naming the backward
    kernel and its ROADMAP item; without a gradient due (no_grad, or no
    operand that requires one) the width passes this check.  The backward
    kernels are built up to 4096: 1088 (padded onto 2048), 2112 and 3072
    (padded onto 4096) and 4096 train, 4160 is refused.  The wrappers call
    this on CUDA tensors, unless ``mirror_bwd`` takes the plain backward."""
    w = torch.ones(width, width)
    ec._refuse_untrainable_width("gcl_message_agg", "gcl_agg_bwd", width, (w, None))
    w.requires_grad_(True)
    with torch.no_grad():
        ec._refuse_untrainable_width("coord_update_agg", "coord_agg_bwd", width, (None, w))
    for name, kernel in (("gcl_message_agg", "gcl_agg_bwd"),
                         ("coord_update_agg", "coord_agg_bwd")):
        if refused:
            with pytest.raises(ValueError, match=f"{name}: feature width {width} above 4096, "
                               f"the widest {kernel} .*widths above 4096"):
                ec._refuse_untrainable_width(name, kernel, width, (None, w))
        else:
            ec._refuse_untrainable_width(name, kernel, width, (None, w))
