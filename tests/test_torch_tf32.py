"""The kernels' tensor-core products, rehearsed on the CPU.

``csrc/egnn_mma.cuh`` computes silu(pre) @ W2 in 3xTF32 for the GCL kernel and
for both MLPs of the coordinate kernel: each operand split into TF32 parts
hi + lo (``cvt.rna``), summed as lo*hi + hi*lo + hi*hi.  Here
``ec.matmul_3xtf32`` emulates that product and the dense twins run through it
at the flagship width F = 256; the result must stay within a tenth of the gate
the card holds the kernels to (atol 1e-5 + rtol 1e-4 against the float32
plain version), so that the rounding alone cannot fail it there.  The GCL
backward kernel (``csrc/egnn_mma_bwd.cuh``) runs three products in 3xTF32,
the forward recompute, dm1 = dz2 @ W2^T and dW2 = m1^T dz2: its rehearsal
runs autograd through the twin with all three emulated, against the gate on
each cotangent (a tenth of BWD_RTOL of its largest entry); so does the
coordinate backward kernel (``csrc/coord_agg_bwd.cu``), the same three
products for each of its two MLPs.  The whole-block kernel
(``csrc/block_fused.cu``) runs every product it has in 3xTF32, the GCL's and
both coordinate MLPs' per-pair products and the node MLP's and the heads'
projections of every node: its rehearsal runs the plain version with all of
them emulated, against the gate on each output (1e-5 + 1e-4 of its largest
entry).  The one-pass TF32 error at the same point is printed (``pytest
-s``), not asserted.
"""
import numpy as np
import pytest
import torch

from diffsbdd_tpu_torch.ops import egnn_cuda as ec

F = 256
CUTOFFS = (None, 5.0, 5.0)
GATE = dict(atol=1e-5, rtol=1e-4)  # the card's: tests/test_torch_gpu.py, chip_smoke.py


def _tf32_values(rng, n):
    """Finite float32 values that TF32 represents: the low 13 bits zero."""
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    bits &= np.uint32(0xFFFFE000)
    vals = bits.view(np.float32)
    return vals[np.isfinite(vals)]


def test_tf32_round_is_exact_on_tf32_values():
    vals = np.concatenate([_tf32_values(np.random.default_rng(0), 20000),
                           np.array([0.0, -0.0, 1.0, -2.5, 2.0 ** -130], np.float32)])
    got = ec.tf32_round(torch.as_tensor(vals)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), vals.view(np.uint32))


def test_tf32_round_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4,
                  1 + 1.5 * ulp, 2 - ulp / 2], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1, 1 + ulp, 1 + 2 * ulp, 2], np.float32)
    np.testing.assert_array_equal(ec.tf32_round(torch.as_tensor(x)).numpy(), want)
    # on random values: the nearest, within half a TF32 ulp of the magnitude
    v = np.random.default_rng(1).standard_normal(10000).astype(np.float32)
    r = ec.tf32_round(torch.as_tensor(v)).numpy()
    assert (r.view(np.uint32) & 0x1FFF == 0).all()
    assert (np.abs(r - v) <= np.abs(v) * 2.0 ** -11).all()


def test_3xtf32_product_is_float32_grade():
    """Against float64: the 3xTF32 product errs about as float32 does, the
    one-pass TF32 product some hundred times more."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((64, F)).astype(np.float32)
    b = (rng.standard_normal((F, F)) * F ** -0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    err = lambda got: float(np.abs(got.numpy() - exact).max())
    e32, e3, e1 = err(at @ bt), err(ec.matmul_3xtf32(at, bt)), err(
        ec.matmul_3xtf32(at, bt, passes=1))
    assert e3 <= 4 * e32 + 1e-7, (e3, e32)
    assert e1 >= 100 * e3, (e1, e3)


@pytest.mark.parametrize("K", [1024, 2048])
def test_3xtf32_product_stays_float32_grade_at_wide_k(K):
    """The widest kernels' products run over K = 1024 and, on the F = 2048
    cluster, K = 2048 rows of W2 (each block all of them, for its half of
    the columns): against float64 the emulated 3xTF32 product stays within
    4x float32's own error, the one-pass TF32 product some hundred times
    above it; and a GCL at that width with the product emulated stays
    within a tenth of the card's gate against the float32 plain version."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((32, K)).astype(np.float32)
    b = (rng.standard_normal((K, K)) * K ** -0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    err = lambda got: float(np.abs(got.numpy() - exact).max())
    e32, e3, e1 = err(at @ bt), err(ec.matmul_3xtf32(at, bt)), err(
        ec.matmul_3xtf32(at, bt, passes=1))
    print(f"\nK={K} against float64: float32 {e32:.2e}, 3xTF32 {e3:.2e}, TF32 {e1:.2e}")
    assert e3 <= 4 * e32 + 1e-7, (e3, e32)
    assert e1 >= 100 * e3, (e1, e3)

    B, NL, N = 2, 6, 20
    f = lambda *s, scale=1.0: torch.as_tensor((rng.standard_normal(s) * scale)
                                              .astype(np.float32))
    x0 = f(B, N, 3, scale=2.0)
    ops = dict(a_row=f(B, N, K, scale=0.5), a_col=f(B, N, K, scale=0.5),
               x=x0 + f(B, N, 3, scale=0.2), x0=x0, mask=torch.ones(B, N),
               is_lig=(torch.arange(N) < NL).float().expand(B, N).contiguous(),
               w_d2=f(K, scale=0.05), w_d20=f(K, scale=0.05),
               type_bias=f(2, 2, K, scale=0.2), w2=torch.as_tensor(b), b2=f(K, scale=0.1),
               w_att=f(K, 1, scale=K ** -0.5), b_att=f(1, scale=0.1))
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    ref = ec.gcl_message_agg_plain(**ops, **kw)
    got = ec.gcl_message_agg_plain(**ops, **kw, matmul=ec.matmul_3xtf32)
    share = gate_share(got, ref)
    print(f"K={K} GCL: 3xTF32 at {share:.4f} of the gate")
    assert share <= 0.1, share


def gcl_operands(seed, spread):
    """A complex of 8 ligand and 40 pocket atoms at the flagship width with
    fan-in-scaled weights; atoms from N(0, spread^2): at spread 1 every pair
    is within the 5 A cutoffs (the collapsed complex)."""
    rng = np.random.default_rng(seed)
    B, NL, N = 2, 8, 48
    f = lambda *s, scale=1.0: torch.as_tensor((rng.standard_normal(s) * scale)
                                              .astype(np.float32))
    x0 = f(B, N, 3, scale=spread)
    mask = torch.ones(B, N)
    mask[1, NL - 2:NL] = 0.0
    is_lig = (torch.arange(N) < NL).float().expand(B, N).contiguous()
    return dict(a_row=f(B, N, F, scale=0.5), a_col=f(B, N, F, scale=0.5),
                x=x0 + f(B, N, 3, scale=0.2), x0=x0, mask=mask, is_lig=is_lig,
                w_d2=f(F, scale=0.05), w_d20=f(F, scale=0.05),
                type_bias=f(2, 2, F, scale=0.2), w2=f(F, F, scale=F ** -0.5),
                b2=f(F, scale=0.1), w_att=f(F, 1, scale=F ** -0.5),
                b_att=f(1, scale=0.1))


def gate_share(got, ref):
    """The largest error as a share of the card's gate atol + rtol * |ref|."""
    return float(((got - ref).abs() / (GATE["atol"] + GATE["rtol"] * ref.abs())).max())


@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_gcl_3xtf32_within_a_tenth_of_the_card_gate(spread):
    ops = gcl_operands(3, spread)
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    ref = ec.gcl_message_agg_plain(*ops.values(), **kw)
    pairs = int((ec.adjacency_dense(((ops["x0"][:, :, None] - ops["x0"][:, None]) ** 2)
                                    .sum(-1), ops["mask"], ops["is_lig"], CUTOFFS)
                 > 0).sum())
    three = ec.gcl_message_agg_plain(*ops.values(), **kw, matmul=ec.matmul_3xtf32)
    one = ec.gcl_message_agg_plain(
        *ops.values(), **kw, matmul=lambda a, b: ec.matmul_3xtf32(a, b, passes=1))
    print(f"\nF={F} spread {spread}: {pairs} active pairs, |ref| max "
          f"{float(ref.abs().max()):.3e}; 3xTF32 max_abs_err "
          f"{float((three - ref).abs().max()):.3e} = {gate_share(three, ref):.4f} of "
          f"the gate; 1-pass TF32 {float((one - ref).abs().max()):.3e} = "
          f"{gate_share(one, ref):.4f} of the gate")
    assert gate_share(three, ref) <= 0.1


def coord_operands(seed, spread):
    """``gcl_operands``' complex with the coordinate MLP's operands, the cross
    MLP's (its head tied to the coordinate head, as in the model) and the
    graph mean of the current coordinates."""
    ops = gcl_operands(seed, spread)
    rng = np.random.default_rng(seed + 100)
    f = lambda *s, scale=1.0: torch.as_tensor((rng.standard_normal(s) * scale)
                                              .astype(np.float32))
    w3 = f(F, 1, scale=F ** -0.5)
    main = {k: ops[k] for k in ("a_row", "a_col", "x", "x0", "mask", "is_lig",
                                "w_d2", "w_d20", "type_bias", "w2", "b2")}
    main["w3"] = w3
    cross = dict(a_row=f(2, 48, F, scale=0.5), a_col=f(2, 48, F, scale=0.5),
                 w_d2=f(F, scale=0.05), w_d20=f(F, scale=0.05),
                 type_bias=f(2, 2, F, scale=0.2), w2=f(F, F, scale=F ** -0.5),
                 b2=f(F, scale=0.1), w3=w3)
    m = ops["mask"]
    graph_mean = (ops["x"] * m[..., None]).sum(1) / m.sum(1)[:, None]
    return main, cross, graph_mean


@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_coord_3xtf32_within_a_tenth_of_the_card_gate(spread):
    """Both MLPs of the coordinate update through the emulated product, cross
    branch and tanh on, every row updated."""
    main, cross, graph_mean = coord_operands(4, spread)
    kw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
              normalization_factor=100.0, cross=cross, graph_mean=graph_mean)
    ref = ec.coord_update_agg_plain(*main.values(), **kw)
    three = ec.coord_update_agg_plain(*main.values(), **kw, matmul=ec.matmul_3xtf32)
    one = ec.coord_update_agg_plain(
        *main.values(), **kw, matmul=lambda a, b: ec.matmul_3xtf32(a, b, passes=1))
    print(f"\nF={F} spread {spread}: coordinate update, |ref| max "
          f"{float(ref.abs().max()):.3e}; 3xTF32 max_abs_err "
          f"{float((three - ref).abs().max()):.3e} = {gate_share(three, ref):.4f} of "
          f"the gate; 1-pass TF32 {float((one - ref).abs().max()):.3e} = "
          f"{gate_share(one, ref):.4f} of the gate")
    assert gate_share(three, ref) <= 0.1


def block_operands(seed, spread):
    """``gcl_operands``' complex as the whole-block kernel takes it: h, the
    GCL's operands with its edge-type table folded, and the node MLP's and
    both heads' weights at fan-in scale (the cross head's w3 tied to the
    coordinate head's, as in the model), each head with an edge-type table."""
    ops = gcl_operands(seed, spread)
    rng = np.random.default_rng(seed + 200)
    f = lambda *s, scale=1.0: torch.as_tensor((rng.standard_normal(s) * scale)
                                              .astype(np.float32))
    a_row, a_col, delta = ec.fold_type_bias(ops["a_row"], ops["a_col"],
                                            ops["is_lig"], ops["type_bias"])
    gcl = dict(w_d2=ops["w_d2"], w_d20=ops["w_d20"], type_delta=delta, w2=ops["w2"],
               b2=ops["b2"], w_att=ops["w_att"], b_att=ops["b_att"])
    s = F ** -0.5
    node = dict(w_h=f(F, F, scale=s), w_a=f(F, F, scale=s), b0=f(F, scale=0.1),
                w2=f(F, F, scale=s), b2=f(F, scale=0.1))
    w3 = f(F, 1, scale=s)

    def head():
        return dict(k_i=f(F, F, scale=s), k_j=f(F, F, scale=s), b0=f(F, scale=0.1),
                    w_d2=f(F, scale=0.05), w_d20=f(F, scale=0.05),
                    type_bias=f(2, 2, F, scale=0.2), w1=f(F, F, scale=s),
                    b1=f(F, scale=0.1), w3=w3)

    h = f(*ops["a_row"].shape, scale=0.5)
    m = ops["mask"]
    graph_mean = (ops["x"] * m[..., None]).sum(1) / m.sum(1)[:, None]
    return (h, a_row, a_col, ops["x"], ops["x0"], m, ops["is_lig"], gcl, node, head(),
            head(), graph_mean)


@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_block_fused_3xtf32_within_a_tenth_of_the_card_gate(spread):
    """The whole block with every product the kernel runs on its tensor cores
    emulated, every row moving (the joint chain's launch), attention, tanh,
    the cross head and edge-type tables on; each output against the gate
    ``chip_smoke.py`` phase 3c holds the kernel to."""
    ins = block_operands(9, spread)
    kw = dict(cutoffs=CUTOFFS, attention=True, tanh=True, coords_range=15.0,
              norm_constant=1.0, normalization_factor=100.0)
    ref = ec.block_fused_plain(*ins, **kw)
    three = ec.block_fused_plain(*ins, **kw, matmul=ec.matmul_3xtf32)
    one = ec.block_fused_plain(
        *ins, **kw, matmul=lambda a, b: ec.matmul_3xtf32(a, b, passes=1))

    def share(got):  # the worst output's error as a share of its gate
        return max(float((g - r).abs().max()) / (1e-5 + 1e-4 * float(r.abs().max()))
                   for g, r in zip(got, ref))

    print(f"\nF={F} spread {spread}: whole block, |h_new| max "
          f"{float(ref[0].abs().max()):.3e}, |dx| max {float(ref[1].abs().max()):.3e}; "
          f"3xTF32 {share(three):.4f} of the gate; 1-pass TF32 {share(one):.4f} of "
          f"the gate")
    assert share(three) <= 0.1


# ---------------------------------------------------------------------------
# the GCL backward kernel's three products (csrc/egnn_mma_bwd.cuh)
# ---------------------------------------------------------------------------

BWD_RTOL = 5e-5  # the card's gate on a cotangent: chip_smoke.py BWD_RTOL


class _Matmul3xTF32(torch.autograd.Function):
    """a @ b in emulated 3xTF32, and its backward as the backward kernel runs
    it: dm1 = g @ b^T and dW2 = a^T g, each in 3xTF32 too (``passes=1``:
    plain TF32)."""

    @staticmethod
    def forward(ctx, a, b, passes):
        ctx.save_for_backward(a, b)
        ctx.passes = passes
        return ec.matmul_3xtf32(a, b, passes)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        f = b.shape[0]
        da = ec.matmul_3xtf32(g, b.t(), ctx.passes)
        db = ec.matmul_3xtf32(a.reshape(-1, f).t(), g.reshape(-1, f), ctx.passes)
        return da, db, None


GCL_COT = ("da_row", "da_col", "dx", "dx0", "dw_d2", "dw_d20", "ddelta", "dw2",
           "db2", "dw_att", "db_att")
COORD_COT = GCL_COT[:9] + ("dw3",)


def bwd_gate_share(got, ref, names=GCL_COT):
    """The largest error of each cotangent (named by ``names``, in order) as a
    share of the card's gate BWD_RTOL * (its largest entry) + 1e-7: the worst
    share and its name."""
    worst, name = 0.0, ""
    for cname, u, v in zip(names, got, ref):
        assert (u is None) == (v is None), cname
        if v is None:
            continue
        limit = BWD_RTOL * float(v.abs().max()) + 1e-7
        share = float((u - v).abs().max()) / limit
        if share >= worst:
            worst, name = share, cname
    return worst, name


@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_gcl_bwd_3xtf32_within_a_tenth_of_the_card_gate(spread):
    """Every cotangent of the GCL aggregation, attention and an edge-type
    delta on, with the forward recompute, dm1 and dW2 products in emulated
    3xTF32, against float32."""
    ops = gcl_operands(5, spread)
    a_row, a_col, delta = ec.fold_type_bias(ops["a_row"], ops["a_col"],
                                            ops["is_lig"], ops["type_bias"])
    args = (a_row, a_col, ops["x"], ops["x0"], ops["mask"], ops["is_lig"],
            ops["w_d2"], ops["w_d20"], delta, ops["w2"], ops["b2"], ops["w_att"],
            ops["b_att"])
    rng = np.random.default_rng(6)
    g = torch.as_tensor(rng.standard_normal(ops["a_row"].shape).astype(np.float32))
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    ref = ec.gcl_agg_bwd_plain(g, *args, **kw)
    three = ec.gcl_agg_bwd_plain(
        g, *args, **kw, matmul=lambda a, b: _Matmul3xTF32.apply(a, b, 3))
    one = ec.gcl_agg_bwd_plain(
        g, *args, **kw, matmul=lambda a, b: _Matmul3xTF32.apply(a, b, 1))
    share3, name3 = bwd_gate_share(three, ref)
    share1, name1 = bwd_gate_share(one, ref)
    print(f"\nF={F} spread {spread}: GCL backward, 3xTF32 worst cotangent {name3} "
          f"{share3:.4f} of the gate; 1-pass TF32 {name1} {share1:.4f} of the gate")
    assert share3 <= 0.1


def coord_bwd_cotangents(result):
    """``coord_agg_bwd_plain``'s (main, cross, dmean) as a flat tuple, with
    the names ``bwd_gate_share`` takes."""
    main, cross, dmean = result
    names = COORD_COT + tuple(f"cross.{k}" for k in cross) + ("dmean",)
    return names, tuple(main) + tuple(cross.values()) + (dmean,)


@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_coord_bwd_3xtf32_within_a_tenth_of_the_card_gate(spread):
    """Every cotangent of the coordinate update, cross branch, tanh and an
    edge-type delta on, the ligand rows updated (the conditional train
    step's launch), with both MLPs' forward recompute, dm1 and dW2 products
    in emulated 3xTF32, against float32."""
    main, cross, graph_mean = coord_operands(7, spread)
    a_row, a_col, delta = ec.fold_type_bias(main["a_row"], main["a_col"],
                                            main["is_lig"], main["type_bias"])
    c_row, c_col, c_delta = ec.fold_type_bias(cross["a_row"], cross["a_col"],
                                              main["is_lig"], cross["type_bias"])
    args = (a_row, a_col, main["x"], main["x0"], main["mask"], main["is_lig"],
            main["w_d2"], main["w_d20"], delta, main["w2"], main["b2"], main["w3"])
    c = dict(a_row=c_row, a_col=c_col, w_d2=cross["w_d2"], w_d20=cross["w_d20"],
             delta=c_delta, w2=cross["w2"], b2=cross["b2"], w3=cross["w3"])
    rng = np.random.default_rng(8)
    g = torch.as_tensor(rng.standard_normal(main["x"].shape).astype(np.float32))
    kw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
              normalization_factor=100.0, cross=c, graph_mean=graph_mean,
              update_rows=8)
    names, ref = coord_bwd_cotangents(ec.coord_agg_bwd_plain(g, *args, **kw))
    _, three = coord_bwd_cotangents(ec.coord_agg_bwd_plain(
        g, *args, **kw, matmul=lambda a, b: _Matmul3xTF32.apply(a, b, 3)))
    _, one = coord_bwd_cotangents(ec.coord_agg_bwd_plain(
        g, *args, **kw, matmul=lambda a, b: _Matmul3xTF32.apply(a, b, 1)))
    share3, name3 = bwd_gate_share(three, ref, names)
    share1, name1 = bwd_gate_share(one, ref, names)
    print(f"\nF={F} spread {spread}: coordinate backward, 3xTF32 worst cotangent "
          f"{name3} {share3:.4f} of the gate; 1-pass TF32 {name1} {share1:.4f} of "
          f"the gate")
    assert share3 <= 0.1
