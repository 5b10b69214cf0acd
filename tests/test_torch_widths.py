"""Hidden widths the kernels are not built for, zero-padded to the next one
they are (``ec.padded_width``: 32 -> 64, 96 -> 128, 192 -> 256, 320 and 384
-> 512, 640 -> 1024, 1088 -> 2048), and the widest built widths, 512, 1024
and 2048, unpadded, on the CPU.

On the card the wrappers pad every operand's width axes
(``ec.pad_operands``), run the kernel at the padded width and cut the
outputs back.  Here the same padding goes through the plain versions, which
compute what the kernels do:

* the padded GCL, coordinate update (cross branch on) and whole block,
  cut back to F, against the JAX package's dense twins at F
  (``gcl_message_agg_xla``, ``coord_update_agg_xla``, ``block_fused_xla``):
  atol 1e-5 + rtol 1e-4 (float32 on both sides, the pairs summed in
  another order), and the padded channels exact zeros: the GCL sum, the
  pair MLPs' messages and the block's h_new;
* gradients through the padding (autograd slices them back to F) against
  the unpadded plain versions': atol 1e-5 + rtol 1e-4;
* the 2xTF32 and bf16 tiers' emulations at the padded width against the
  same tier at F, within the card's gates (``ec.TIER_GATES``, the whole
  block's ``ec.BLOCK_TIER_GATES``: at bf16 ``ec.block_bf16_gate`` against
  the bf16 sums in float64), the backward plain versions included;
* at 1088 and 2048, the backward plain versions as the card's backward
  wrappers run them (padded onto 2048, cut back) against ``jax.vjp`` of
  the JAX package's dense twins at F: atol 1e-4, rtol 1e-3, as
  test_torch_kernels_bwd.py (each cotangent sums up to B*N*N pair terms in
  another order); the padded channels' cotangents exact zeros.

* at 1088 (padded onto 2048) and 2048, the whole block on one graph of 15
  nodes with odd ``update_rows`` against ``block_fused_xla``: both
  outputs, atol 1e-5 + rtol 1e-4.

B = 2, N = 20 (8 ligand nodes), one numpy seed a width.  Widths 320 to 512
are the F = 512 kernels' (on tiles of two rows on the card), 640 and 1024
the F = 1024 kernels' (tiles of one row), 1088 and 2048 the F = 2048
kernels' (a row tile on a cluster of two blocks), which the plain versions
compute at any width.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import diffsbdd_tpu.ops.egnn_pallas as ep
from diffsbdd_tpu.ops.egnn_block_fused import block_fused_xla
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
import test_torch_threads  # noqa: F401  (PyTorch threads a worker under xdist)

B, N, NL = 2, 20, 8
WIDTHS = (32, 96, 192, 320, 384, 512, 640, 1024, 1088, 2048)
NAMES = ("gcl", "coord", "block")
# the kernel behind each function, whose widths bound its cases
KERNEL = dict(gcl="gcl_agg", coord="coord_agg", block="block_fused")
# the widths of the backward kernels' F = 2048 instantiation: 1088 padded, 2048
CLUSTER_WIDTHS = (1088, 2048)


def built(kernel, F):
    """Whether ``kernel`` runs width F on the card (padded or not)."""
    return F <= ec.KERNEL_WIDTHS[kernel][-1]


# (name, F): every function at every width its kernel runs
CASES = [pytest.param(name, F, id=f"{name}-{F}") for F in WIDTHS for name in NAMES
         if built(KERNEL[name], F)]
TOL = dict(atol=1e-5, rtol=1e-4)
CUTOFFS = (None, 5.0, 5.0)
GCL_KW = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
COORD_KW = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
                normalization_factor=100.0)
BLOCK_KW = dict(COORD_KW, attention=True)
GCL_KEYS = ("a_row", "a_col", "x", "x0", "mask", "is_lig", "w_d2", "w_d20", "type_bias",
            "w2", "b2", "w_att", "b_att")
COORD_KEYS = GCL_KEYS[:11] + ("w3",)
BLOCK_KEYS = ("h", "a_row", "a_col", "x", "x0", "mask", "is_lig", "gcl", "node", "coord",
              "cross", "graph_mean")


def make_ops(F, seed=0, B=B, N=N):
    """Every operand of the three functions at width F (B graphs of N
    nodes), as numpy arrays."""
    rng = np.random.default_rng(seed)
    nrm = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    s = F ** -0.5
    x = nrm(B, N, 3, scale=3.0)
    mask = (rng.uniform(size=(B, N)) > 0.15).astype(np.float32)
    mask[:, 0] = 1.0
    w3 = nrm(F, 1, scale=s)

    def mlp():
        return dict(a_row=nrm(B, N, F, scale=0.5), a_col=nrm(B, N, F, scale=0.5),
                    w_d2=nrm(F, scale=0.05), w_d20=nrm(F, scale=0.05),
                    type_bias=nrm(2, 2, F, scale=0.2), w2=nrm(F, F, scale=s),
                    b2=nrm(F, scale=0.1), w3=w3)

    def head():
        return dict(k_i=nrm(F, F, scale=s), k_j=nrm(F, F, scale=s), b0=nrm(F, scale=0.1),
                    w_d2=nrm(F, scale=0.05), w_d20=nrm(F, scale=0.05),
                    type_bias=nrm(2, 2, F, scale=0.2), w1=nrm(F, F, scale=s),
                    b1=nrm(F, scale=0.1), w3=w3)

    ops = dict(mlp(), x=x, x0=x + nrm(B, N, 3, scale=0.1), mask=mask,
               is_lig=np.broadcast_to((np.arange(N) < NL).astype(np.float32), (B, N)).copy(),
               w_att=nrm(F, 1, scale=s), b_att=nrm(1, scale=0.1), h=nrm(B, N, F, scale=0.5),
               delta=nrm(F, scale=0.2), cross=mlp(), coord=head(), block_cross=head())
    ops["graph_mean"] = ((x * mask[..., None]).sum(1) / mask.sum(1)[:, None]).astype(np.float32)
    ops["gcl"] = dict(w_d2=ops["w_d2"], w_d20=ops["w_d20"], type_delta=ops["delta"],
                      w2=ops["w2"], b2=ops["b2"], w_att=ops["w_att"], b_att=ops["b_att"])
    ops["node"] = dict(w_h=nrm(F, F, scale=s), w_a=nrm(F, F, scale=s), b0=nrm(F, scale=0.1),
                       w2=nrm(F, F, scale=s), b2=nrm(F, scale=0.1))
    return ops


def convert(tree, fn):
    if isinstance(tree, dict):
        return {k: convert(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def gcl(ops, **kw):
    return ec.gcl_message_agg_plain(*(ops[k] for k in GCL_KEYS), **GCL_KW, **kw)


def coord(ops, **kw):
    return ec.coord_update_agg_plain(*(ops[k] for k in COORD_KEYS), **COORD_KW,
                                     cross=ops["cross"], graph_mean=ops["graph_mean"], **kw)


def block(ops, **kw):
    return ec.block_fused_plain(*(dict(ops, cross=ops["block_cross"])[k] for k in BLOCK_KEYS),
                                **BLOCK_KW, **kw)


def padded(fn, ops, F, **kw):
    """``fn`` on ``ops`` zero-padded to ``ec.padded_width(F)``: (the outputs
    cut back to F, the padded outputs)."""
    out = fn(ec.pad_operands(ops, F, ec.padded_width(F, kernel=KERNEL[fn.__name__])), **kw)
    full = out if isinstance(out, tuple) else (out,)
    cut = tuple(o if o.shape[-1] == 3 else o[..., :F] for o in full)  # dx is (B, N, 3)
    return (cut if isinstance(out, tuple) else cut[0]), full


@functools.lru_cache(maxsize=None)
def _jax_fns():
    return dict(
        gcl=jax.jit(lambda o: ep.gcl_message_agg_xla(*(o[k] for k in GCL_KEYS), **GCL_KW)),
        coord=jax.jit(lambda o: ep.coord_update_agg_xla(
            *(o[k] for k in COORD_KEYS), **COORD_KW, cross=o["cross"],
            graph_mean=o["graph_mean"])),
        block=jax.jit(lambda o, update_rows=None: block_fused_xla(
            *(dict(o, cross=o["block_cross"])[k] for k in BLOCK_KEYS), **BLOCK_KW,
            update_rows=update_rows), static_argnames="update_rows"))


PORT = dict(gcl=gcl, coord=coord, block=block)


@pytest.mark.parametrize("name,F", CASES)
def test_padded_plain_matches_jax(name, F):
    ops = make_ops(F)
    got, full = padded(PORT[name], convert(ops, torch.as_tensor), F)
    ref = _jax_fns()[name](convert(ops, jax.numpy.asarray))
    for g, r in zip(*((got, ref) if name == "block" else ((got,), (ref,)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    # the padded channels: exact zeros in the GCL sum and in h_new
    if name != "coord":
        assert full[0].shape[-1] == ec.padded_width(F, kernel=KERNEL[name])
        assert not full[0][..., F:].any()


@pytest.mark.parametrize("F", CLUSTER_WIDTHS)
def test_block_at_2048_matches_jax(F):
    """The whole block as the card's wrapper runs it at F = 2048 (1088
    zero-padded onto it, the outputs cut back) on one graph of 15 nodes,
    the cross branch on and ``update_rows`` 7, against the JAX package's
    ``block_fused_xla`` at F (the dx rows below ``update_rows``: JAX keeps
    whole row tiles), the port's dx rows at and above it exact zeros."""
    ops = make_ops(F, seed=F, B=1, N=15)
    width = ec.padded_width(F, kernel="block_fused")
    assert width == 2048
    (h_new, dx), _ = padded(block, convert(ops, torch.as_tensor), F, update_rows=7)
    ref_h, ref_dx = _jax_fns()["block"](convert(ops, jax.numpy.asarray), update_rows=7)
    np.testing.assert_allclose(h_new.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(dx.numpy()[:, :7], np.asarray(ref_dx)[:, :7], **TOL)
    assert not dx[:, 7:].any()


@pytest.mark.parametrize("F", WIDTHS)
def test_padded_pair_messages_are_exact_zeros(F):
    """Both pair MLPs' messages in their padded channels, at every tier."""
    width = ec.padded_width(F)
    ops = ec.pad_operands(convert(make_ops(F), torch.as_tensor), F, width)
    d2, d2_0 = ec._pair_d2(ops["x"]), ec._pair_d2(ops["x0"])
    for tier in ec.TIERS:
        for m in (ops, ops["cross"]):
            msg = ec._pair_mlp_plain(m["a_row"], m["a_col"], d2, d2_0, ops["is_lig"],
                                     m["w_d2"], m["w_d20"], m["type_bias"], m["w2"], m["b2"],
                                     matmul=torch.matmul, precision=tier)
            assert msg.shape[-1] == width and not msg[..., F:].any(), tier


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [] if tree is None or not tree.is_floating_point() else [tree]


@pytest.mark.parametrize("name,F", CASES)
def test_gradients_through_the_padding(name, F):
    """d(sum(out * g)) for every operand, through pad -> plain version at the
    padded width -> cut, against the plain version at F."""
    ops = convert(make_ops(F), lambda a: torch.as_tensor(a).requires_grad_(True))
    leaves = _leaves(ops)
    got, _ = padded(PORT[name], ops, F)
    want = PORT[name](ops)
    got, want = ((got, want) if name == "block" else ((got,), (want,)))
    gen = torch.Generator().manual_seed(F)
    cots = [torch.randn(w.shape, generator=gen) for w in want]

    def grads(outs):
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    for g, w in zip(grads(got), grads(want)):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def _assert_within_gate(got, ref, exact, gate):
    limit = TOL["atol"] + TOL["rtol"] * ref.abs() + gate["share"] * float(ref.abs().max())
    assert bool(((got - ref).abs() <= limit).all()), float((got - ref).abs().max())
    assert ec.tier_moved_share(got, ref, exact) <= gate["moved"]


@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("tier", ["tf32x2", "bf16"])
def test_padded_tiers_within_their_gates(tier, F):
    """Each function's tier emulation on the padded operands against the same
    tier at F (the norm gate against float32's move at F), and both backward
    plain versions' cotangents at the tier against theirs at F; each where
    its kernel runs width F."""
    ops = convert(make_ops(F), torch.as_tensor)
    for name, gates in (("gcl", ec.TIER_GATES), ("coord", ec.TIER_GATES),
                        ("block", ec.BLOCK_TIER_GATES)):
        if not built(KERNEL[name], F):
            continue
        got, _ = padded(PORT[name], ops, F, precision=tier)
        ref, exact = PORT[name](ops, precision=tier), PORT[name](ops)
        if name == "block" and tier == "bf16":  # the gate's own reference
            for g, r, s, e in zip(got, ref, PORT[name](ops, precision=ec.BF16_EXACT),
                                  exact):
                assert ec.block_bf16_gate(g, r, s, e)["ok"]
            continue
        for g, r, e in zip(*((got, ref, exact) if name == "block"
                             else ((got,), (ref,), (exact,)))):
            _assert_within_gate(g, r, e, gates[tier])

    if not built("gcl_agg_bwd", F):
        return
    gcl_bwd = lambda o, **kw: ec.gcl_agg_bwd_plain(
        o["g"], *(o[k] for k in GCL_KEYS[:8]), o["delta"], *(o[k] for k in GCL_KEYS[9:]),
        **GCL_KW, **kw)
    cross = {k: ops["cross"].get(k, ops["delta"]) for k in ec._MLP_KEYS}
    coord_bwd = lambda o, **kw: ec.coord_agg_bwd_plain(
        o["g3"], *(o[k] for k in COORD_KEYS[:8]), o["delta"], *(o[k] for k in COORD_KEYS[9:]),
        **COORD_KW, cross=o["cross"], graph_mean=o["graph_mean"], **kw)
    gen = torch.Generator().manual_seed(F)
    bwd_ops = dict(ops, cross=cross, g=torch.randn(B, N, F, generator=gen),
                   g3=torch.randn(B, N, 3, generator=gen))
    width = ec.padded_width(F, kernel="gcl_agg_bwd")
    for fn, names in ((gcl_bwd, ec._GCL_COT), (coord_bwd, ec._COORD_COT)):
        padded_ops = dict(ec.pad_operands(bwd_ops, F, width),
                          g=ec._pad_axes(bwd_ops["g"], F, width, (-1,), "g"))
        outs = [fn(o, precision=t) for o, t in ((padded_ops, tier), (bwd_ops, tier),
                                                 (bwd_ops, "tf32x3"))]
        if fn is coord_bwd:  # (main, cross, dmean) -> one dict
            outs = [dict(zip(names, m), **{f"cross.{k}": v for k, v in c.items()}, dmean=d)
                    for m, c, d in outs]
        else:
            outs = [dict(zip(names, o)) for o in outs]
        # cut back to F by the name of the operand each cotangent belongs to
        got = {key: ec.unpad_operands({key.split(".")[-1]: value}, F)[key.split(".")[-1]]
               for key, value in outs[0].items()}
        for key, ref in outs[1].items():
            if ref is None:
                assert got[key] is None, key
                continue
            assert got[key].shape == ref.shape, key
            err = float((got[key] - ref).abs().max())
            assert err <= ec.TIER_GATES[tier]["bwd"] * float(ref.abs().max()) + 1e-7, key
            assert ec.tier_moved_share(got[key], ref, outs[2][key]) <= \
                ec.TIER_GATES[tier]["moved"], key


BWD_TOL = dict(atol=1e-4, rtol=1e-3)
UPDATE_ROWS = 12


def _delta_tables(ops):
    """``ops`` with every edge-type table (0, 0; 0, delta): its fold leaves
    the projections as they are and gives delta, so the backward wrappers'
    folded operands are the operands, and JAX's table cotangent at [1, 1]
    is the port's ddelta."""
    def delta_table(tb):
        out = np.zeros_like(tb)
        out[1, 1] = tb[1, 1]
        return out

    out = dict(ops, type_bias=delta_table(ops["type_bias"]))
    out["cross"] = dict(ops["cross"], type_bias=delta_table(ops["cross"]["type_bias"]))
    return out


def _cut(cot, F):
    """Cotangents named as their operands cut back to F, each padded part
    (its width axes past F) asserted exact zeros."""
    for key, t in cot.items():
        if isinstance(t, dict):
            _cut(t, F)
        elif t is not None and key in ec._WIDTH_AXES:
            for axis in ec._WIDTH_AXES[key]:
                assert not t.narrow(axis % t.dim(), F, t.shape[axis] - F).any(), key
    return ec.unpad_operands(cot, F)


def _port_bwd(name, ops, g, F, width, update_rows=UPDATE_ROWS):
    """The backward plain version of ``name`` as the card's wrapper runs it
    at F: operands and ``g`` zero-padded to the backward kernel's width
    (asserted to be ``width``), the cotangents (named as their operands, the
    cross MLP's a dict, dmean) cut back to F."""
    assert ec.padded_width(F, kernel=f"{KERNEL[name]}_bwd") == width
    t = convert(ops, torch.as_tensor)
    folded = {k: t[k] for k in GCL_KEYS}
    folded["type_bias"] = t["type_bias"][1, 1]  # delta
    pad = ec.pad_operands(dict(folded, delta=folded.pop("type_bias")), F, width)
    if name == "gcl":
        g_pad = ec._pad_axes(torch.as_tensor(g), F, width, (-1,), "g")
        args = [pad[k] for k in GCL_KEYS[:8]] + [pad["delta"]] + [pad[k] for k in GCL_KEYS[9:]]
        cot = ec.gcl_agg_bwd_plain(g_pad, *args, **GCL_KW, update_rows=update_rows,
                                   col_mask=torch.as_tensor(ops["col_mask"]))
        return _cut(dict(zip(ec._GCL_COT, cot)), F)
    cross = {k: t["cross"][k] for k in ec._MLP_KEYS if k != "delta"}
    cross["delta"] = t["cross"]["type_bias"][1, 1]
    cross = ec.pad_operands(cross, F, width)
    w3 = ec.pad_operands(dict(w3=t["w3"]), F, width)["w3"]
    args = [pad[k] for k in GCL_KEYS[:8]] + [pad["delta"], pad["w2"], pad["b2"], w3]
    main, cross_cot, dmean = ec.coord_agg_bwd_plain(
        torch.as_tensor(g), *args, **COORD_KW, update_rows=update_rows, cross=cross,
        graph_mean=t["graph_mean"])
    return dict(_cut(dict(zip(ec._COORD_COT, main)), F), cross=_cut(cross_cot, F), dmean=dmean)


def _jax_vjp(name, ops, g, update_rows=UPDATE_ROWS):
    """jax.vjp of the JAX package's dense twin at F: {operand: cotangent}
    (the cross MLP's a dict, the graph mean's as dmean), each table's
    cotangent at [1, 1] as delta."""
    j = convert(ops, jax.numpy.asarray)
    keys = GCL_KEYS if name == "gcl" else COORD_KEYS
    diff = [k for k in keys if k not in ("mask", "is_lig") and j[k] is not None]

    def fn(d, cross, graph_mean):
        args = [d.get(k, j[k]) for k in keys]
        if name == "gcl":
            return ep.gcl_message_agg_xla(*args, **GCL_KW, col_mask=j["col_mask"],
                                          update_rows=update_rows, tile_i=1)
        return ep.coord_update_agg_xla(*args, **COORD_KW, cross=cross, graph_mean=graph_mean,
                                       update_rows=update_rows, tile_i=1)

    _, vjp = jax.vjp(fn, {k: j[k] for k in diff}, j["cross"], j["graph_mean"])
    main, cross, dmean = vjp(jax.numpy.asarray(g))
    out = {k: np.asarray(v) for k, v in main.items()}
    out["delta"] = out.pop("type_bias")[1, 1]
    if name == "coord":
        cross = {k: np.asarray(v) for k, v in cross.items()}
        cross["delta"] = cross.pop("type_bias")[1, 1]
        out.update(cross=cross, dmean=np.asarray(dmean))
    return out


@pytest.mark.parametrize("F", CLUSTER_WIDTHS)
@pytest.mark.parametrize("name", ["gcl", "coord"])
def test_backward_plain_at_2048_matches_jax_vjp(name, F):
    """The backward plain versions at the backward kernels' F = 2048 (1088
    padded onto it) against ``jax.vjp`` of JAX's dense twins at F: the GCL
    with attention, an edge-type delta, a column mask (the columns of a
    two-rank edge split's first block) and update_rows; the coordinate
    update with the cross branch, tanh, the deltas and update_rows (JAX's
    coordinate twin takes no column mask).  Every cotangent within atol
    1e-4, rtol 1e-3; the padded channels' exact zeros."""
    ops = _delta_tables(make_ops(F))
    ops["col_mask"] = ops["mask"] * (np.arange(N) < N // 2)
    rng = np.random.default_rng(F + 1)
    g = rng.standard_normal((B, N, F if name == "gcl" else 3)).astype(np.float32)
    g[:, UPDATE_ROWS:] = 0.0  # rows past update_rows carry no cotangent
    assert_cotangents_close(name, _port_bwd(name, ops, g, F, 2048), _jax_vjp(name, ops, g))


def assert_cotangents_close(name, got, want):
    """Every cotangent of ``_port_bwd`` against ``_jax_vjp``'s, within
    ``BWD_TOL``."""
    pairs = [(k, got[k], want.get(k)) for k in got if k not in ("cross", "dmean")]
    if name == "coord":
        pairs += [(f"cross.{k}", got["cross"][k], want["cross"][k]) for k in ec._MLP_KEYS]
        pairs.append(("dmean", got["dmean"], want["dmean"]))
    for key, port, ref in pairs:
        assert ref is not None and port is not None, key
        np.testing.assert_allclose(port.numpy(), np.asarray(ref).reshape(port.shape),
                                   err_msg=key, **BWD_TOL)
