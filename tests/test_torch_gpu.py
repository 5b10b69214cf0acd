"""The port's CUDA kernels against their plain twins on a card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_gpu.py``.  Without
a card every test skips.  Tolerance atol 1e-5, rtol 1e-4: float32 on both
sides, pairs summed in another order (the whole-block kernel's is stated at
``assert_block_close``).
"""
import pytest
import torch

from diffsbdd_tpu_torch.ops import egnn_cuda as ec

B, N, F = 2, 48, 64
CUTOFFS = (None, 5.0, 5.0)
TOL = dict(atol=1e-5, rtol=1e-4)

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_card():
    # decided per test, not at import, so every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(seed, N=N, F=F, w_scale=0.3):
    """Operands on the card; ``w_scale`` the F x F and head weights' (None:
    fan-in, F ** -0.5, a trained layer's)."""
    w_scale = F ** -0.5 if w_scale is None else w_scale
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).cuda()
    x = r(B, N, 3, scale=3.0)
    mask = (torch.rand((B, N), generator=g) > 0.2).float().cuda()
    is_lig = (torch.arange(N) < 12).float().expand(B, N).contiguous().cuda()
    main = dict(a_row=r(B, N, F, scale=0.3), a_col=r(B, N, F, scale=0.3),
                x=x, x0=x + r(B, N, 3, scale=0.1), mask=mask, is_lig=is_lig,
                w_d2=r(F, scale=0.1), w_d20=r(F, scale=0.1),
                type_bias=r(2, 2, F, scale=0.2), w2=r(F, F, scale=w_scale),
                b2=r(F, scale=0.1))
    extra = dict(w_att=r(F, 1, scale=w_scale), b_att=r(1, scale=0.1),
                 w3=r(F, 1, scale=w_scale),
                 cross=dict(a_row=r(B, N, F, scale=0.3), a_col=r(B, N, F, scale=0.3),
                            w_d2=r(F, scale=0.1), w_d20=r(F, scale=0.1),
                            type_bias=r(2, 2, F, scale=0.2),
                            w2=r(F, F, scale=w_scale), b2=r(F, scale=0.1)))
    return main, extra


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("variant", ["full", "lig_cols", "lig_rows"])
def test_gcl_kernel_matches_twin(attention, variant):
    main, extra = _inputs(0)
    kw = dict(cutoffs=CUTOFFS, attention=attention, normalization_factor=100.0)
    if variant == "lig_cols":
        kw["col_mask"] = main["mask"] * main["is_lig"]
    elif variant == "lig_rows":
        kw.update(col_mask=main["mask"], update_rows=12)
    att = (extra["w_att"], extra["b_att"]) if attention else (None, None)
    ec.reset_launch_counts()
    got = ec.gcl_message_agg(*main.values(), *att, **kw)
    assert ec.launch_counts["gcl_agg"] == 1
    ref = ec.gcl_message_agg_plain(*main.values(), *att, **kw)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("with_cross", [False, True])
def test_coord_kernel_matches_twin(with_cross):
    main, extra = _inputs(1)
    cross = graph_mean = None
    if with_cross:
        cross = dict(extra["cross"], w3=extra["w3"])
        m = main["mask"]
        graph_mean = (main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None]
    kw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
              normalization_factor=100.0, cross=cross, graph_mean=graph_mean,
              update_rows=12)
    ec.reset_launch_counts()
    got = ec.coord_update_agg(*main.values(), extra["w3"], **kw)
    assert ec.launch_counts["coord_agg"] == 1
    ref = ec.coord_update_agg_plain(*main.values(), extra["w3"], **kw)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("update_rows", [None, 11])
def test_kernels_on_a_partial_row_tile(update_rows):
    """N and update_rows that are not multiples of the kernels' 4-row tile:
    the last tile's rows past the end read nothing and write nothing."""
    main, extra = _inputs(3, N=45)
    m = main["mask"]
    gcl_kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0,
                  col_mask=m, update_rows=update_rows)
    att = (extra["w_att"], extra["b_att"])
    torch.testing.assert_close(ec.gcl_message_agg(*main.values(), *att, **gcl_kw),
                               ec.gcl_message_agg_plain(*main.values(), *att, **gcl_kw),
                               **TOL)
    graph_mean = (main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None]
    coord_kw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0,
                    norm_constant=1.0, normalization_factor=100.0,
                    cross=dict(extra["cross"], w3=extra["w3"]),
                    graph_mean=graph_mean, update_rows=update_rows)
    torch.testing.assert_close(
        ec.coord_update_agg(*main.values(), extra["w3"], **coord_kw),
        ec.coord_update_agg_plain(*main.values(), extra["w3"], **coord_kw), **TOL)


@pytest.mark.parametrize("kernel", ["gcl", "coord_main", "coord_cross", "gcl_bwd",
                                    "coord_bwd_main", "coord_bwd_cross"])
def test_wrappers_reject_a_misaligned_w2(kernel):
    """W2 streams through cp.async in 16-byte pieces: a contiguous W2 that
    starts 4 bytes past an aligned address is refused before any launch."""
    main, extra = _inputs(4)
    misaligned = lambda w: torch.empty(w.numel() + 1, device=w.device)[1:] \
        .copy_(w.reshape(-1)).view_as(w)
    ec.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "gcl":
            ec.gcl_message_agg(*dict(main, w2=misaligned(main["w2"])).values(),
                               extra["w_att"], extra["b_att"], cutoffs=CUTOFFS,
                               attention=True, normalization_factor=100.0)
        elif kernel == "gcl_bwd":
            ops = _folded(dict(main, w2=misaligned(main["w2"])))
            ec.gcl_agg_bwd(torch.ones_like(main["a_row"]), *ops.values(),
                           extra["w_att"], extra["b_att"], cutoffs=CUTOFFS,
                           attention=True, normalization_factor=100.0)
        elif kernel.startswith("coord_bwd"):
            ops = _folded(main)
            cross = _folded_cross(extra["cross"], main["is_lig"], extra["w3"])
            if kernel == "coord_bwd_main":
                ops["w2"] = misaligned(ops["w2"])
            else:
                cross["w2"] = misaligned(cross["w2"])
            m = main["mask"]
            ec.coord_agg_bwd(torch.ones_like(main["x"]), *ops.values(), extra["w3"],
                             cutoffs=CUTOFFS, tanh=True, coords_range=15.0,
                             norm_constant=1.0, normalization_factor=100.0, cross=cross,
                             graph_mean=(main["x"] * m[..., None]).sum(1)
                             / m.sum(1)[:, None])
        else:
            cross = dict(extra["cross"], w3=extra["w3"])
            if kernel == "coord_main":
                main["w2"] = misaligned(main["w2"])
            else:
                cross["w2"] = misaligned(cross["w2"])
            m = main["mask"]
            ec.coord_update_agg(*main.values(), extra["w3"], cutoffs=CUTOFFS, tanh=True,
                                coords_range=15.0, norm_constant=1.0,
                                normalization_factor=100.0, cross=cross,
                                graph_mean=(main["x"] * m[..., None]).sum(1)
                                / m.sum(1)[:, None])
    assert sum(ec.launch_counts.values()) == 0


def test_wrapper_rejects_noncontiguous_weight():
    main, extra = _inputs(2)
    main["w2"] = main["w2"].t()
    with pytest.raises(ValueError, match="contiguous"):
        ec.gcl_message_agg(*main.values(), extra["w_att"], extra["b_att"],
                           cutoffs=CUTOFFS, attention=True,
                           normalization_factor=100.0)


# ---------------------------------------------------------------------------
# backward kernels against autograd through the plain twins
# ---------------------------------------------------------------------------

GCL_COT = ("da_row", "da_col", "dx", "dx0", "dw_d2", "dw_d20", "ddelta", "dw2",
           "db2", "dw_att", "db_att")
COORD_COT = GCL_COT[:9] + ("dw3",)


def _folded(main, with_delta=True):
    """The operands the backward wrappers take: the edge-type table folded
    into the projections, delta (F,) in its place."""
    a_row, a_col, delta = ec.fold_type_bias(
        main["a_row"], main["a_col"], main["is_lig"],
        main["type_bias"] if with_delta else None)
    out = dict(main, a_row=a_row.contiguous(), a_col=a_col.contiguous())
    out["type_bias"] = delta  # same slot, now (F,) or None
    return out


def _folded_cross(cross, is_lig, w3, with_delta=True):
    """The cross MLP's operands as ``coord_agg_bwd`` takes them: its
    edge-type table folded (``_folded``), delta (F,) or None in its place."""
    c = _folded(dict(cross, is_lig=is_lig), with_delta)
    return dict(a_row=c["a_row"], a_col=c["a_col"], w_d2=c["w_d2"], w_d20=c["w_d20"],
                delta=c["type_bias"], w2=c["w2"], b2=c["b2"], w3=w3)


def _assert_cotangents(got, ref, rel=1e-4):
    """Every cotangent within ``rel`` (1e-4) of its plain version, relative
    to that cotangent's largest entry: float32 on both sides, but the kernel
    sums thousands of pairs per entry in another order (weights: every pair
    of the batch), so the error scales with the sum, not with the entry."""
    assert got.keys() == ref.keys()
    for name in ref:
        if ref[name] is None:
            assert got[name] is None, name
            continue
        scale = float(ref[name].abs().max())
        err = float((got[name] - ref[name]).abs().max())
        assert torch.isfinite(got[name]).all(), name
        assert err <= rel * scale + 1e-7, (name, err, scale)


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("variant", ["full", "lig_cols", "lig_rows", "no_delta"])
def test_gcl_bwd_kernel_matches_plain(attention, variant):
    main, extra = _inputs(4)
    ops = _folded(main, with_delta=variant != "no_delta")
    kw = dict(cutoffs=CUTOFFS, attention=attention, normalization_factor=100.0)
    if variant == "lig_cols":
        kw["col_mask"] = main["mask"] * main["is_lig"]
    elif variant == "lig_rows":
        kw.update(col_mask=main["mask"], update_rows=12)
    att = (extra["w_att"], extra["b_att"]) if attention else (None, None)
    g = torch.randn(B, N, F, generator=torch.Generator().manual_seed(5)).cuda()
    ec.reset_launch_counts()
    got = ec.gcl_agg_bwd(g, *ops.values(), *att, **kw)
    assert ec.launch_counts["gcl_agg_bwd"] == 1
    ref = ec.gcl_agg_bwd_plain(g, *ops.values(), *att, **kw)
    _assert_cotangents(dict(zip(GCL_COT, got)), dict(zip(GCL_COT, ref)))


def _coord_cot(result):
    main, cross, dmean = result
    out = dict(zip(COORD_COT, main))
    if cross is not None:
        out.update({f"cross.{k}": v for k, v in cross.items()})
    out["dmean"] = dmean
    return out


def _column_block(mask, block, blocks=2):
    """``mask`` on the columns of block ``block`` of ``blocks`` (a rank's
    share of an edge split)."""
    n = mask.shape[1]
    keep = torch.zeros(n, device=mask.device)
    keep[n * block // blocks:n * (block + 1) // blocks] = 1.0
    return mask * keep


def _coord_bwd_case(seed, N, with_cross, tanh, update_rows, with_delta=True, F=F,
                    block=None, w_scale=0.3):
    main, extra = _inputs(seed, N=N, F=F, w_scale=w_scale)
    ops = _folded(main, with_delta)
    cross = graph_mean = None
    if with_cross:
        cross = _folded_cross(extra["cross"], main["is_lig"], extra["w3"], with_delta)
        m = main["mask"]
        graph_mean = (main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None]
    kw = dict(cutoffs=CUTOFFS, tanh=tanh, coords_range=15.0, norm_constant=1.0,
              normalization_factor=100.0, cross=cross, graph_mean=graph_mean,
              update_rows=update_rows)
    if block is not None:
        kw["col_mask"] = _column_block(main["mask"], block)
    g = torch.randn(B, N, 3, generator=torch.Generator().manual_seed(6)).cuda()
    ec.reset_launch_counts()
    got = ec.coord_agg_bwd(g, *ops.values(), extra["w3"], **kw)
    assert ec.launch_counts["coord_agg_bwd"] == 1
    ref = ec.coord_agg_bwd_plain(g, *ops.values(), extra["w3"], **kw)
    _assert_cotangents(_coord_cot(got), _coord_cot(ref))


@pytest.mark.parametrize("with_cross", [False, True])
@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("update_rows", [None, 12])
def test_coord_bwd_kernel_matches_plain(with_cross, tanh, update_rows):
    _coord_bwd_case(7, N, with_cross, tanh, update_rows)


@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("update_rows", [None, 12])
def test_coord_kernels_on_a_column_block(block, update_rows):
    """A column block of a two-rank edge split as ``col_mask``: the forward
    and the backward kernel against their plain versions, and the forward's
    two blocks add up to the whole graph."""
    main, extra = _inputs(1)
    cross = dict(extra["cross"], w3=extra["w3"])
    m = main["mask"]
    kw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
              normalization_factor=100.0, cross=cross,
              graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None],
              update_rows=update_rows)
    parts = [ec.coord_update_agg(*main.values(), extra["w3"],
                                 col_mask=_column_block(m, b), **kw) for b in (0, 1)]
    ref = ec.coord_update_agg_plain(*main.values(), extra["w3"],
                                    col_mask=_column_block(m, block), **kw)
    torch.testing.assert_close(parts[block], ref, **TOL)
    torch.testing.assert_close(parts[0] + parts[1],
                               ec.coord_update_agg(*main.values(), extra["w3"], **kw), **TOL)
    _coord_bwd_case(7, N, True, True, update_rows, block=block)


@pytest.mark.parametrize("update_rows", [None, 11])
def test_forward_kernels_at_2048_on_a_partial_row_tile(update_rows):
    """``test_kernels_on_a_partial_row_tile`` on the F = 2048 cluster kernels
    (fan-in weights): N = 45 and rows past ``update_rows`` written as zeros
    by the blocks of a grid of clusters, every tier within its gate."""
    main, extra = _inputs(3, N=45, F=2048, w_scale=None)
    m = main["mask"]
    att = (extra["w_att"], extra["b_att"])
    gcl_kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0,
                  col_mask=m, update_rows=update_rows)
    graph_mean = (main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None]
    coord_kw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0,
                    norm_constant=1.0, normalization_factor=100.0,
                    cross=dict(extra["cross"], w3=extra["w3"]),
                    graph_mean=graph_mean, update_rows=update_rows)
    for tier in ec.TIERS:
        for wrapper, plain, args, kw in (
                (ec.gcl_message_agg, ec.gcl_message_agg_plain, (*main.values(), *att), gcl_kw),
                (ec.coord_update_agg, ec.coord_update_agg_plain,
                 (*main.values(), extra["w3"]), coord_kw)):
            got = wrapper(*args, **kw, precision=tier)
            if tier == ec.DEFAULT_TIER:
                torch.testing.assert_close(got, plain(*args, **kw), **TOL)
            else:
                _assert_tier_close(got, plain(*args, **kw, precision=tier), plain(*args, **kw),
                                   tier)
            if update_rows is not None:
                assert not got[:, update_rows:].any()


@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("update_rows", [None, 12])
def test_coord_kernels_at_2048_on_a_column_block(block, update_rows):
    """The forward half of ``test_coord_kernels_on_a_column_block`` on the
    F = 2048 cluster kernels: a column block of a two-rank edge split as
    ``col_mask`` against the plain version, the two blocks adding up to the
    whole graph; the GCL kernel on the same column block."""
    main, extra = _inputs(1, F=2048, w_scale=None)
    cross = dict(extra["cross"], w3=extra["w3"])
    m = main["mask"]
    kw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
              normalization_factor=100.0, cross=cross,
              graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None],
              update_rows=update_rows)
    parts = [ec.coord_update_agg(*main.values(), extra["w3"],
                                 col_mask=_column_block(m, b), **kw) for b in (0, 1)]
    ref = ec.coord_update_agg_plain(*main.values(), extra["w3"],
                                    col_mask=_column_block(m, block), **kw)
    torch.testing.assert_close(parts[block], ref, **TOL)
    torch.testing.assert_close(parts[0] + parts[1],
                               ec.coord_update_agg(*main.values(), extra["w3"], **kw), **TOL)
    gkw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0,
               col_mask=_column_block(m, block), update_rows=update_rows)
    att = (extra["w_att"], extra["b_att"])
    torch.testing.assert_close(ec.gcl_message_agg(*main.values(), *att, **gkw),
                               ec.gcl_message_agg_plain(*main.values(), *att, **gkw), **TOL)


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("update_rows", [None, 11])
def test_bwd_kernels_on_a_partial_row_tile(update_rows, width):
    """From F = 512 on the weights take the fan-in scale (``_inputs``'
    w_scale None): the default 0.3 puts the attention logits at a spread of
    sqrt(512) * 0.5 * 0.3 ~ 3.4, where db_att sums saturated gates'
    derivatives att * (1 - att) that cancel, and 1 - att near 1 keeps too few
    digits in float32, the plain version's as the kernel's, for the gate.
    F = 2048 runs each row tile on a cluster of two blocks."""
    main, extra = _inputs(8, N=45, F=width, w_scale=None if width >= 512 else 0.3)
    ops = _folded(main)
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0,
              update_rows=update_rows)
    g = torch.randn(B, 45, width, generator=torch.Generator().manual_seed(9)).cuda()
    att = (extra["w_att"], extra["b_att"])
    got = ec.gcl_agg_bwd(g, *ops.values(), *att, **kw)
    ref = ec.gcl_agg_bwd_plain(g, *ops.values(), *att, **kw)
    _assert_cotangents(dict(zip(GCL_COT, got)), dict(zip(GCL_COT, ref)))
    _coord_bwd_case(8, 45, True, True, update_rows, with_delta=False, F=width,
                    w_scale=None if width >= 512 else 0.3)


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024, 2048])
def test_bwd_kernel_is_deterministic(width):
    """No atomics: two launches on the same inputs give the same bits."""
    main, extra = _inputs(10, F=width)
    ops = _folded(main)
    g = torch.randn(B, N, width, generator=torch.Generator().manual_seed(11)).cuda()
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    a = ec.gcl_agg_bwd(g, *ops.values(), extra["w_att"], extra["b_att"], **kw)
    b = ec.gcl_agg_bwd(g, *ops.values(), extra["w_att"], extra["b_att"], **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _bwd_2048_cases(seed, update_rows=None, block=None):
    """Both backward kernels at F = 2048 (fan-in weights, N = 45, attention,
    cross branch, tanh, edge-type deltas) at every tier against their plain
    versions at that tier (3xTF32: ``_assert_cotangents``; the reduced tiers:
    ``ec.TIER_GATES``), each launch on a cluster of two blocks of that tier's
    library; ``block``: the columns of that block of a two-rank edge split
    (``col_mask``).  Returns {tier: (GCL cotangents, coordinate ones)}."""
    main, extra = _inputs(seed, N=45, F=2048, w_scale=None)
    ops = _folded(main)
    m = main["mask"]
    col_mask = None if block is None else _column_block(m, block)
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0,
              update_rows=update_rows, col_mask=col_mask)
    ckw = dict(COORD_KW, update_rows=update_rows, col_mask=col_mask,
               cross=_folded_cross(extra["cross"], main["is_lig"], extra["w3"]),
               graph_mean=(m[..., None] * main["x"]).sum(1) / m.sum(1)[:, None])
    att = (extra["w_att"], extra["b_att"])
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn(B, 45, 2048, generator=gen).cuda()
    gc = torch.randn(B, 45, 3, generator=gen).cuda()
    exact = (dict(zip(GCL_COT, ec.gcl_agg_bwd_plain(g, *ops.values(), *att, **kw))),
             _coord_cot(ec.coord_agg_bwd_plain(gc, *ops.values(), extra["w3"], **ckw)))
    out = {}
    for tier in ec.TIERS:
        ec.reset_launch_counts()
        got = (dict(zip(GCL_COT, ec.gcl_agg_bwd(g, *ops.values(), *att, **kw, precision=tier))),)
        assert ec.last_cluster_dim("gcl_agg_bwd", tier) == 2
        got += (_coord_cot(ec.coord_agg_bwd(gc, *ops.values(), extra["w3"], **ckw,
                                            precision=tier)),)
        assert ec.last_cluster_dim("coord_agg_bwd", tier) == 2
        _only_tier("gcl_agg_bwd", tier)
        _only_tier("coord_agg_bwd", tier)
        if tier == ec.DEFAULT_TIER:
            for c, e in zip(got, exact):
                _assert_cotangents(c, e)
        else:
            ref = (dict(zip(GCL_COT, ec.gcl_agg_bwd_plain(g, *ops.values(), *att, **kw,
                                                            precision=tier))),
                   _coord_cot(ec.coord_agg_bwd_plain(gc, *ops.values(), extra["w3"], **ckw,
                                                     precision=tier)))
            for c, r, e in zip(got, ref, exact):
                _assert_tier_cotangents(c, r, e, tier)
        if update_rows is not None:
            assert not got[0]["da_row"][:, update_rows:].any()
        out[tier] = got
    return out


@pytest.mark.parametrize("update_rows", [None, 11])
def test_bwd_kernels_at_2048_on_a_partial_row_tile(update_rows):
    """``_bwd_2048_cases`` on N = 45 rows, the rows past ``update_rows``
    not visited (da_row zero there)."""
    _bwd_2048_cases(40, update_rows)


@pytest.mark.parametrize("block", [0, 1])
def test_bwd_kernels_at_2048_on_a_column_block(block):
    """``_bwd_2048_cases`` on each column block of a two-rank edge split at
    the conditional step's rows (the first 12 move)."""
    _bwd_2048_cases(42, 12, block)


def test_bwd_kernels_at_2048_are_deterministic():
    """No atomics, and the two blocks of a cluster add each pair sum's two
    shares in one fixed order: three launches of each backward kernel at
    every tier give one digest of all their cotangents."""
    main, extra = _inputs(44, N=45, F=2048, w_scale=None)
    ops = _folded(main)
    m = main["mask"]
    ckw = dict(COORD_KW, update_rows=12,
               cross=_folded_cross(extra["cross"], main["is_lig"], extra["w3"]),
               graph_mean=(m[..., None] * main["x"]).sum(1) / m.sum(1)[:, None])
    gen = torch.Generator().manual_seed(45)
    g = torch.randn(B, 45, 2048, generator=gen).cuda()
    gc = torch.randn(B, 45, 3, generator=gen).cuda()
    for tier in ec.TIERS:
        digests = {_digest([*ec.gcl_agg_bwd(g, *ops.values(), extra["w_att"], extra["b_att"],
                                           **GCL_KW, precision=tier),
                            *_coord_cot(ec.coord_agg_bwd(gc, *ops.values(), extra["w3"], **ckw,
                                                         precision=tier)).values()])
                   for _ in range(3)}
        assert len(digests) == 1, tier


def test_autograd_through_kernels_matches_twins():
    """Gradients of a scalar of both public wrappers, type table and tied head
    included, on the card (Functions) against the CPU (plain autograd)."""
    main, extra = _inputs(12)
    m = main["mask"]
    names = ("a_row", "a_col", "x", "x0", "w_d2", "w_d20", "type_bias", "w2", "b2")
    digests = {}  # the card run's outputs, kept for an intermittent failure

    def run(device):
        mv = {k: v.to(device) for k, v in main.items()}
        ex = {k: v.to(device) for k, v in extra.items() if k != "cross"}
        cr = {k: v.to(device) for k, v in extra["cross"].items()}
        leaves = {k: mv[k].clone().requires_grad_(True) for k in names}
        leaves.update({k: ex[k].clone().requires_grad_(True) for k in ex})
        leaves.update({f"cross.{k}": v.clone().requires_grad_(True)
                       for k, v in cr.items()})
        ops = dict(mv, **{k: leaves[k] for k in names})
        agg = ec.gcl_message_agg(*ops.values(), leaves["w_att"], leaves["b_att"],
                                 cutoffs=CUTOFFS, attention=True,
                                 normalization_factor=100.0)
        x = leaves["x"]
        mean = (x * mv["mask"][..., None]).sum(1) / mv["mask"].sum(1)[:, None]
        cross = {k: leaves[f"cross.{k}"] for k in cr}
        cross["w3"] = leaves["w3"]  # the tied head
        upd = ec.coord_update_agg(*ops.values(), leaves["w3"], cutoffs=CUTOFFS,
                                  tanh=True, coords_range=15.0, norm_constant=1.0,
                                  normalization_factor=100.0, cross=cross,
                                  graph_mean=mean, update_rows=12)
        loss = (agg ** 2).sum() + (upd ** 2).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if device == "cuda":
            digests.update(gcl_agg=_digest([agg]), coord_agg=_digest([upd]),
                           **{f"grad.{k}": _digest([g]) for k, g in zip(leaves, grads)})
        return {k: g.cpu() for k, g in zip(leaves, grads)}

    ec.reset_launch_counts()
    got = run("cuda")
    assert ec.launch_counts == {"gcl_agg": 1, "coord_agg": 1, "gcl_agg_bwd": 1,
                                "coord_agg_bwd": 1, "block_fused": 0}
    try:
        _assert_cotangents(got, run("cpu"))
    except AssertionError as err:
        raise AssertionError(f"{err}; the card run's digests: {digests}") from err


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(b"none" if t is None else t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def test_split_kernels_at_f64_give_one_result_each():
    """The F = 64 split kernels of ``test_autograd_through_kernels_matches_twins``,
    forward and backward, 200 times in one process with other launches
    between: every kernel's outputs one bitwise value (an intermittent
    failure of that test, ROADMAP.md §3 item 5, was one other value)."""
    main, extra = _inputs(12)
    m = main["mask"]
    att = (extra["w_att"], extra["b_att"])
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    ckw = dict(COORD_KW, update_rows=12, cross=dict(extra["cross"], w3=extra["w3"]),
               graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None])
    ops = _folded(main)
    bkw = dict(ckw, cross=_folded_cross(extra["cross"], main["is_lig"], extra["w3"]))
    gen = torch.Generator().manual_seed(13)
    g = torch.randn(B, N, F, generator=gen).cuda()
    gc = torch.randn(B, N, 3, generator=gen).cuda()
    heavy = _gcl_ops(block_inputs(14, B=4, N=96, F=256, spread=1.0))
    runs = {
        "gcl_agg": lambda: [ec.gcl_message_agg(*main.values(), *att, **kw)],
        "coord_agg": lambda: [ec.coord_update_agg(*main.values(), extra["w3"], **ckw)],
        "gcl_agg_bwd": lambda: ec.gcl_agg_bwd(g, *ops.values(), *att, **kw),
        "coord_agg_bwd": lambda: list(_coord_cot(
            ec.coord_agg_bwd(gc, *ops.values(), extra["w3"], **bkw)).values())}
    seen = {name: set() for name in runs}
    with torch.no_grad():
        for rep in range(200):
            if rep % 2:
                ec.gcl_message_agg(*heavy, **GCL_KW)
            for name, run in runs.items():
                seen[name].add(_digest(run()))
    assert {name: len(d) for name, d in seen.items()} == dict.fromkeys(runs, 1)


# ---------------------------------------------------------------------------
# the whole-block kernel against its plain version
# ---------------------------------------------------------------------------

def block_inputs(seed, B=B, N=N, F=F, n_lig=12, cross=True, attention=True,
                 table=True, device="cuda", spread=3.0):
    """The operands of ``ec.block_fused`` from a seed: coordinates with
    standard deviation ``spread`` (so the 5 A cutoffs bite), a mask with
    holes, ligand rows first."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=0.3: (torch.randn(s, generator=g) * scale).to(device)
    x = r(B, N, 3, scale=spread)
    mask = (torch.rand((B, N), generator=g) > 0.1).float().to(device)
    is_lig = (torch.arange(N) < n_lig).float().expand(B, N).contiguous().to(device)
    # weights at 1/sqrt(F), so that the width does not set the activations' scale
    w = lambda *s: r(*s, scale=s[0] ** -0.5)
    gcl = dict(w_d2=r(F, scale=0.1), w_d20=r(F, scale=0.1),
               type_delta=r(F, scale=0.2) if table else None, w2=w(F, F),
               b2=r(F, scale=0.1), w_att=w(F, 1) if attention else None,
               b_att=r(1, scale=0.1) if attention else None)
    node = dict(w_h=w(F, F), w_a=w(F, F), b0=r(F, scale=0.1), w2=w(F, F),
                b2=r(F, scale=0.1))
    w3 = w(F, 1)

    def head():
        return dict(k_i=w(F, F), k_j=w(F, F), b0=r(F, scale=0.1),
                    w_d2=r(F, scale=0.1), w_d20=r(F, scale=0.1),
                    type_bias=r(2, 2, F, scale=0.2) if table else None,
                    w1=w(F, F), b1=r(F, scale=0.1), w3=w3)

    coord = head()
    cross_d = head() if cross else None
    graph_mean = None
    if cross:
        graph_mean = (x * mask[..., None]).sum(1) / mask.sum(1)[:, None]
    return [r(B, N, F), r(B, N, F), r(B, N, F), x, x + r(B, N, 3, scale=0.1), mask,
            is_lig, gcl, node, coord, cross_d, graph_mean]


BLOCK_KW = dict(cutoffs=CUTOFFS, attention=True, tanh=True, coords_range=15.0,
                norm_constant=1.0, normalization_factor=100.0)


def assert_block_close(got, ref, update_rows=None):
    """h_new and dx within atol 1e-5 + 1e-4 of the plain version's largest
    entry (the node MLP sums F products of O(1) terms); dx rows at and above
    ``update_rows`` exact zeros."""
    for name, g, r in zip(("h_new", "dx"), got, ref):
        assert torch.isfinite(g).all(), name
        err = float((g - r).abs().max())
        assert err <= 1e-5 + 1e-4 * float(r.abs().max()), (name, err)
    if update_rows is not None:
        assert not got[1][:, update_rows:].any()


@pytest.mark.parametrize("update_rows", [None, 12])
@pytest.mark.parametrize("variant", ["full", "no_cross", "no_attention", "no_tanh",
                                     "no_table"])
def test_block_kernel_matches_plain(variant, update_rows):
    ins = block_inputs(20, cross=variant != "no_cross",
                       attention=variant != "no_attention",
                       table=variant != "no_table")
    kw = dict(BLOCK_KW, attention=variant != "no_attention",
              tanh=variant != "no_tanh", update_rows=update_rows)
    ec.reset_launch_counts()
    got = ec.block_fused(*ins, **kw)
    assert ec.launch_counts == {"gcl_agg": 0, "coord_agg": 0, "gcl_agg_bwd": 0,
                                "coord_agg_bwd": 0, "block_fused": 1}
    assert_block_close(got, ec.block_fused_plain(*ins, **kw), update_rows)


@pytest.mark.parametrize("N,update_rows", [(45, None), (45, 11), (325, 23),
                                            (130, None)])
def test_block_kernel_on_partial_tiles(N, update_rows):
    """N that is no multiple of the 4-row tile, with ``update_rows`` odd."""
    ins = block_inputs(21, N=N, spread=4.0)
    kw = dict(BLOCK_KW, update_rows=update_rows)
    assert_block_close(ec.block_fused(*ins, **kw),
                       ec.block_fused_plain(*ins, **kw), update_rows)


def test_block_kernel_at_full_width():
    ins = block_inputs(22, B=2, N=90, F=256, n_lig=10, spread=4.0)
    kw = dict(BLOCK_KW, update_rows=10)
    assert_block_close(ec.block_fused(*ins, **kw),
                       ec.block_fused_plain(*ins, **kw), 10)


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("spread", [1.0, 4.0])
def test_block_kernel_at_joint_shapes(B, spread):
    """Every row moves at N = 344, F = 256: 6 row tiles a phase-A block at
    B = 8 and 11 at B = 16 on 132 SMs; at ``spread`` 1 nearly every pair
    passes the cutoffs (the collapsed complex of the joint chain at large
    t)."""
    ins = block_inputs(25, B=B, N=344, F=256, n_lig=24, table=False, spread=spread)
    assert_block_close(ec.block_fused(*ins, **BLOCK_KW),
                       ec.block_fused_plain(*ins, **BLOCK_KW))


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("cross", [True, False], ids=["cross", "no_cross"])
@pytest.mark.parametrize("N,blocks", [(130, 132), (130, 22), (130, 12), (130, 9),
                                      (128, 8)],
                         ids=["rows4", "rows24", "rows44", "rows60", "rows64"])
def test_block_kernel_at_each_block_size(N, blocks, cross, width, monkeypatch):
    """Phase A at the rows a block owns: B = 4 graphs of ceil(N / 4) row
    tiles dealt round-robin over ``blocks`` blocks give at most 1, 6, 11, 15
    and 16 tiles a block (4 rows, one m-tile; 24 and 44, as the wrapper
    picks at B = 8 and B = 16 for N = 344 on 132 SMs, and 60, each with a
    partial m-tile of 16 rows; and the most, 64), N = 130 a short last tile
    in every graph, and blocks with fewer tiles than others; phase B (the
    pair MLPs over blockIdx.z and the sum of their slabs, or the coordinate
    MLP alone) with the cross head on and off; every row moves.  At F = 512
    the tiles have 2 rows and at 1024 one (``ec.row_tile``): twice or four
    times the tiles, the block counts past 16 tiles a block refused by the
    wrapper's own grid, so those cases take the fewest blocks that hold
    them."""
    tiles = 4 * -(-N // ec.row_tile(width))
    blocks = max(blocks, -(-tiles // ec.BLOCK_TILES_MAX))
    monkeypatch.setattr(ec, "_block_grid", lambda B, N, device, F: blocks)
    ins = block_inputs(28, B=4, N=N, F=width, n_lig=20, cross=cross, spread=4.0)
    ec.reset_launch_counts()
    got = ec.block_fused(*ins, **BLOCK_KW)
    assert ec.launch_counts["block_fused"] == 1
    assert_block_close(got, ec.block_fused_plain(*ins, **BLOCK_KW))


@pytest.mark.parametrize("group,name", [("gcl", "w2"), ("node", "w_a"),
                                        ("coord", "w1"), ("cross", "k_j")])
def test_block_wrapper_rejects_a_misaligned_weight(group, name):
    """Every weight matrix of the whole-block kernel streams through cp.async
    in 16-byte pieces: one that starts 4 bytes past an aligned address is
    refused before any launch."""
    ins = block_inputs(29)
    d = ins[{"gcl": 7, "node": 8, "coord": 9, "cross": 10}[group]]
    w = d[name]
    d[name] = torch.empty(w.numel() + 1, device=w.device)[1:].copy_(w.reshape(-1)) \
        .view_as(w)
    ec.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ec.block_fused(*ins, **BLOCK_KW)
    assert ec.launch_counts["block_fused"] == 0


def test_block_kernel_is_deterministic():
    ins = block_inputs(23)
    a = ec.block_fused(*ins, **BLOCK_KW)
    b = ec.block_fused(*ins, **BLOCK_KW)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_block_kernel_gradient_is_plain_autograd():
    """The Function's backward (autograd through the plain version) on the
    card against plain autograd on the CPU."""
    def run(device):
        ins = block_inputs(24, device=device)
        leaves = [ins[0].requires_grad_(True), ins[1].requires_grad_(True),
                  ins[9]["k_i"].requires_grad_(True),
                  ins[8]["w_a"].requires_grad_(True)]
        h_new, dx = ec.block_fused(*ins, **BLOCK_KW, update_rows=12)
        loss = (h_new ** 2).sum() + (dx ** 2).sum()
        return dict(zip("h a_row k_i w_a".split(),
                        (g.cpu() for g in torch.autograd.grad(loss, leaves))))

    ec.reset_launch_counts()
    got = run("cuda")
    assert ec.launch_counts["block_fused"] == 1
    _assert_cotangents(got, run("cpu"))


# ---------------------------------------------------------------------------
# the whole-block kernel at F = 2048, on clusters of two blocks
# ---------------------------------------------------------------------------

# case: (cross, attention, edge-type tables, N, update_rows), on B = 2
# graphs of 45 nodes, 12 of them ligand rows.  At bf16 the gate
# (``ec.block_bf16_gate``) holds the kernel against the bf16 plain version
# with its products summed in float64, within twice the float32 plain
# version's own distance from it: two float32 orders of the same bf16 sums
# read alike there (dx by norm at F = 2048: the plain version 0.35 of the
# tier's move, the kernel 0.39; H100, chip_smoke.py 20l)
BLOCK_CLUSTER_CASES = {"cross_table": (True, True, True, 45, 12),
                       "no_cross": (False, True, True, 45, 12),
                       "no_attention": (True, False, False, 45, None),
                       "odd_n_odd_rows": (True, True, True, 45, 11)}


def _assert_block_tier(got, ref, exact, tier, update_rows, sums=None):
    """``assert_block_close`` at 3xTF32; at the reduced tiers each output
    within ``ec.BLOCK_TIER_GATES`` of the plain version at the tier: at
    2xTF32 its error norm against the tier's move from ``exact``,
    float32's; at bf16 ``ec.block_bf16_gate`` against ``sums``, the bf16
    products summed in float64 (``ec.block_fused_bf16_exact``)."""
    if tier == "tf32x3":
        assert_block_close(got, ref, update_rows)
        return
    for g, r, e, s in zip(got, ref, exact, sums if tier == "bf16" else ref):
        if tier == "bf16":
            res = ec.block_bf16_gate(g, r, s, e)
            assert res["ok"], res
        else:
            _assert_tier_close(g, r, e, tier, ec.BLOCK_TIER_GATES)
    if update_rows is not None:
        assert not got[1][:, update_rows:].any()


@pytest.mark.parametrize("width", [2048, 1536])
@pytest.mark.parametrize("tier", ["tf32x3", "tf32x2", "bf16"])
@pytest.mark.parametrize("case", list(BLOCK_CLUSTER_CASES))
def test_block_kernel_at_2048(case, tier, width):
    """The whole-block kernel at F = 2048 (1536 zero-padded onto it) at each
    tier against its plain version at the tier: the cross head on and off,
    attention off, edge-type tables, odd N with odd ``update_rows``; both
    outputs, dx rows past ``update_rows`` exact zeros, two launches bit for
    bit, each on clusters of two blocks."""
    cross, attention, table, n, rows = BLOCK_CLUSTER_CASES[case]
    ins = block_inputs(60, N=n, F=width, cross=cross, attention=attention, table=table,
                       spread=4.0)
    kw = dict(BLOCK_KW, attention=attention, update_rows=rows)
    ec.reset_launch_counts()
    got = ec.block_fused(*ins, **kw, precision=tier)
    again = ec.block_fused(*ins, **kw, precision=tier)
    _only_tier("block_fused", tier, launches=2)
    assert ec.last_cluster_dim("block_fused", tier) == 2
    assert got[0].shape == (B, n, width)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    ref = ec.block_fused_plain(*ins, **kw, precision=tier)
    exact = ec.block_fused_plain(*ins, **kw) if tier != "tf32x3" else ref
    sums = ec.block_fused_bf16_exact(*ins, **kw) if tier == "bf16" else None
    _assert_block_tier(got, ref, exact, tier, rows, sums)


@pytest.mark.parametrize("clusters", [None, 17], ids=["one_wave", "16_tiles"])
def test_block_kernel_at_2048_on_many_tiles(clusters, monkeypatch):
    """Phase A at F = 2048 deals B * N one-row tiles to the clusters: the
    wrapper's grid (one cluster of two blocks an SM pair, 4 tiles a cluster
    here), and the fewest clusters that hold them (16 tiles a cluster, the
    most, 15 in the last), on the collapsed complex, every row moving."""
    if clusters is not None:
        monkeypatch.setattr(ec, "_block_grid", lambda B, N, device, F: 2 * clusters)
    ins = block_inputs(61, N=131, F=2048, n_lig=20, spread=1.0)
    ec.reset_launch_counts()
    got = ec.block_fused(*ins, **BLOCK_KW)
    assert ec.launch_counts["block_fused"] == 1
    assert_block_close(got, ec.block_fused_plain(*ins, **BLOCK_KW))


def test_block_wrapper_at_2048_rejects_a_misaligned_h():
    """At F = 2048 phase A reads h in 16-byte vectors: an h that starts 4
    bytes past an aligned address is refused before any launch."""
    ins = block_inputs(62, N=45, F=2048)
    h = ins[0]
    ins[0] = torch.empty(h.numel() + 1, device=h.device)[1:].copy_(h.reshape(-1)).view_as(h)
    ec.reset_launch_counts()
    with pytest.raises(ValueError, match="h must be 16-byte aligned"):
        ec.block_fused(*ins, **BLOCK_KW)
    assert ec.launch_counts["block_fused"] == 0


def _fused_network_matches_cpu(hidden):
    """A hidden-``hidden`` joint network (every node moves) with block
    fusing on: one whole-block launch a layer on the card, on clusters of
    ``ec.cluster_size``, against the plain versions on the CPU."""
    model, batch = _dynamics_case("cuda", hidden_nf=hidden, kernel_block_fuse=True,
                                  update_pocket_coords=True)
    cpu, cpu_batch = _dynamics_case("cpu", hidden_nf=hidden, update_pocket_coords=True)
    ec.reset_launch_counts()
    with torch.no_grad():
        fused = model(*batch, block_fuse=True)
        want = cpu(*cpu_batch)
    assert ec.launch_counts == {**dict.fromkeys(ec.KERNELS, 0), "block_fused": 2}, \
        ec.launch_counts
    assert ec.last_cluster_dim("block_fused") == ec.cluster_size(hidden)
    for f, w in zip(fused, want):
        torch.testing.assert_close(f.cpu(), w, atol=1e-4, rtol=1e-4)


def test_width_2048_fused_network_matches_cpu():
    _fused_network_matches_cpu(2048)


# ---------------------------------------------------------------------------
# the whole-block kernel at F = 4096, on clusters of four blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [4096, 3072])
@pytest.mark.parametrize("tier", ["tf32x3", "tf32x2", "bf16"])
@pytest.mark.parametrize("case", list(BLOCK_CLUSTER_CASES))
def test_block_kernel_at_4096(case, tier, width):
    """The whole-block kernel at F = 4096 (3072 zero-padded onto it) at each
    tier against its plain version at the tier, the cases of
    ``test_block_kernel_at_2048``: both outputs within the tier's gate, dx
    rows past ``update_rows`` exact zeros, two launches bit for bit, each on
    clusters of four blocks."""
    cross, attention, table, n, rows = BLOCK_CLUSTER_CASES[case]
    ins = block_inputs(63, N=n, F=width, cross=cross, attention=attention, table=table,
                       spread=4.0)
    kw = dict(BLOCK_KW, attention=attention, update_rows=rows)
    ec.reset_launch_counts()
    got = ec.block_fused(*ins, **kw, precision=tier)
    again = ec.block_fused(*ins, **kw, precision=tier)
    _only_tier("block_fused", tier, launches=2)
    assert ec.last_cluster_dim("block_fused", tier) == 4
    assert got[0].shape == (B, n, width)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    ref = ec.block_fused_plain(*ins, **kw, precision=tier)
    exact = ec.block_fused_plain(*ins, **kw) if tier != "tf32x3" else ref
    sums = ec.block_fused_bf16_exact(*ins, **kw) if tier == "bf16" else None
    _assert_block_tier(got, ref, exact, tier, rows, sums)


@pytest.mark.parametrize("clusters", [None, 17], ids=["one_wave", "16_tiles"])
def test_block_kernel_at_4096_on_many_tiles(clusters, monkeypatch):
    """Phase A at F = 4096 deals B * N one-row tiles to clusters of four
    blocks: the wrapper's grid (one wave of 33 clusters on 132 SMs, at
    most 8 tiles a cluster here), and the fewest clusters that hold them
    (16 tiles a cluster, the most, 15 in the last), on the collapsed
    complex, every row moving."""
    if clusters is not None:
        monkeypatch.setattr(ec, "_block_grid", lambda B, N, device, F: 4 * clusters)
    ins = block_inputs(64, N=131, F=4096, n_lig=20, spread=1.0)
    ec.reset_launch_counts()
    got = ec.block_fused(*ins, **BLOCK_KW)
    assert ec.launch_counts["block_fused"] == 1 and ec.last_cluster_dim("block_fused") == 4
    assert_block_close(got, ec.block_fused_plain(*ins, **BLOCK_KW))


def test_block_wrapper_at_4096_rejects_a_misaligned_h():
    """At F = 4096 phase A reads h in 16-byte vectors: an h that starts 4
    bytes past an aligned address is refused before any launch."""
    ins = block_inputs(65, N=45, F=4096)
    h = ins[0]
    ins[0] = torch.empty(h.numel() + 1, device=h.device)[1:].copy_(h.reshape(-1)).view_as(h)
    ec.reset_launch_counts()
    with pytest.raises(ValueError, match="h must be 16-byte aligned"):
        ec.block_fused(*ins, **BLOCK_KW)
    assert ec.launch_counts["block_fused"] == 0


def test_width_4096_fused_network_matches_cpu():
    """A hidden-4096 joint network with block fusing on: one whole-block
    launch a layer on clusters of four, no split-kernel launch, against the
    plain versions on the CPU."""
    _fused_network_matches_cpu(4096)


# ---------------------------------------------------------------------------
# the GCL kernel (3xTF32 on the tensor cores) at the main path's shapes
# ---------------------------------------------------------------------------

def _gcl_ops(ins):
    """``gcl_message_agg``'s operands out of ``block_inputs``: the GCL part,
    its edge-type delta as a (2, 2, F) table."""
    _, a_row, a_col, x, x0, mask, is_lig, gcl = ins[:8]
    return (a_row, a_col, x, x0, mask, is_lig, gcl["w_d2"], gcl["w_d20"],
            ec._delta_table(gcl["type_delta"]), gcl["w2"], gcl["b2"], gcl["w_att"],
            gcl["b_att"])


GCL_KW = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)


def _plain_in_slices(plain, ops, kw, step):
    """``plain(*ops, **kw)`` of a forward plain version over batch slices of
    ``step`` graphs, concatenated: the per-graph operands are the first six
    (a_row .. is_lig), the cross head's projections and the graph mean.  At
    F = 2048 one (16, 344, 344, F) float32 tensor takes 15.5 GB."""
    def part(sl):
        k = dict(kw)
        if k.get("cross") is not None:
            k["cross"] = {n: (v[sl] if n in ("a_row", "a_col") else v)
                          for n, v in k["cross"].items()}
        for n in ("graph_mean", "col_mask"):
            if k.get(n) is not None:
                k[n] = k[n][sl]
        return plain(*(t[sl] if i < 6 else t for i, t in enumerate(ops)), **k)

    return torch.cat([part(slice(b, b + step)) for b in range(0, ops[0].shape[0], step)], 0)


def _plain_step(width):
    """Graphs a slice of the forward plain versions at the main path's shapes
    (all 16 up to F = 1024)."""
    return 4 if width > 1024 else 16


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_gcl_kernel_at_flagship_shapes(width, spread):
    """B = 16, N = 344 (24 ligand atoms): 1376 row tiles on 132 SMs (at
    F = 2048 each on a cluster of two blocks); at ``spread`` 1 every pair
    passes the cutoffs, so every chunk is full."""
    ops = _gcl_ops(block_inputs(26, B=16, N=344, F=width, n_lig=24, spread=spread))
    ec.reset_launch_counts()
    got = ec.gcl_message_agg(*ops, **GCL_KW)
    assert ec.launch_counts["gcl_agg"] == 1
    assert ec.last_cluster_dim("gcl_agg") == ec.cluster_size(width)
    torch.testing.assert_close(
        got, _plain_in_slices(ec.gcl_message_agg_plain, ops, GCL_KW, _plain_step(width)), **TOL)


def test_gcl_kernel_is_deterministic():
    """The row sums are owned by one warp each, in a fixed order: two
    launches give the same bits."""
    ops = _gcl_ops(block_inputs(27, B=4, N=344, F=256, n_lig=24, spread=1.0))
    assert torch.equal(ec.gcl_message_agg(*ops, **GCL_KW),
                       ec.gcl_message_agg(*ops, **GCL_KW))


@pytest.mark.parametrize("tier", ["tf32x3", "tf32x2", "bf16"])
def test_gcl_kernel_at_2048_is_deterministic(tier):
    """At F = 2048 a row's two feature halves come from the two blocks of a
    cluster, which add the attention dot's two shares in one fixed order:
    two launches give the same bits, on the collapsed complex."""
    ops = _gcl_ops(block_inputs(27, B=2, N=344, F=2048, n_lig=24, spread=1.0))
    got = ec.gcl_message_agg(*ops, **GCL_KW, precision=tier)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, ec.gcl_message_agg(*ops, **GCL_KW, precision=tier))


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_gcl_bwd_kernel_at_flagship_shapes(width, spread):
    """The GCL backward kernel (3xTF32 on the tensor cores) at N = 344 (24
    ligand atoms), B = 4, attention and an edge-type delta on: every
    cotangent against autograd through the plain twin; at ``spread`` 1 every
    pair passes the cutoffs, so every chunk is full.  Two launches agree bit
    for bit."""
    ins = block_inputs(30, B=4, N=344, F=width, n_lig=24, spread=spread)
    _, a_row, a_col, x, x0, mask, is_lig, gcl = ins[:8]
    ops = (a_row, a_col, x, x0, mask, is_lig, gcl["w_d2"], gcl["w_d20"],
           gcl["type_delta"], gcl["w2"], gcl["b2"], gcl["w_att"], gcl["b_att"])
    g = torch.randn(4, 344, width, generator=torch.Generator().manual_seed(31)).cuda()
    ec.reset_launch_counts()
    got = ec.gcl_agg_bwd(g, *ops, **GCL_KW)
    again = ec.gcl_agg_bwd(g, *ops, **GCL_KW)
    assert ec.launch_counts["gcl_agg_bwd"] == 2
    for u, v in zip(got, again):
        assert torch.equal(u, v)
    ref = ec.gcl_agg_bwd_plain(g, *ops, **GCL_KW)
    _assert_cotangents(dict(zip(GCL_COT, got)), dict(zip(GCL_COT, ref)))


# ---------------------------------------------------------------------------
# the coordinate kernel (3xTF32 on the tensor cores) at the main path's shapes
# ---------------------------------------------------------------------------

def coord_inputs(seed, B, N=344, F=256, n_lig=24, spread=4.0, cross=True):
    """``coord_update_agg``'s operands out of ``block_inputs``: each head's
    projections of h, its edge-type table and W2; the cross head (with the
    graph mean) or None."""
    ins = block_inputs(seed, B=B, N=N, F=F, n_lig=n_lig, cross=cross, spread=spread)
    h, _, _, x, x0, mask, is_lig = ins[:7]

    def mlp(hd):
        return dict(a_row=h @ hd["k_i"] + hd["b0"], a_col=h @ hd["k_j"],
                    w_d2=hd["w_d2"], w_d20=hd["w_d20"], type_bias=hd["type_bias"],
                    w2=hd["w1"], b2=hd["b1"], w3=hd["w3"])

    main = mlp(ins[9])
    main = (main["a_row"], main["a_col"], x, x0, mask, is_lig, main["w_d2"],
            main["w_d20"], main["type_bias"], main["w2"], main["b2"], main["w3"])
    return main, (mlp(ins[10]) if cross else None), ins[11]


COORD_KW = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
                normalization_factor=100.0)


def _coord_case(seed, B, width, spread, update_rows, cross, share=None):
    """The coordinate kernel against its plain version: within ``TOL``, or
    with ``share`` within that share of the output's largest entry."""
    main, cross_d, graph_mean = coord_inputs(seed, B, F=width, spread=spread,
                                             cross=cross)
    kw = dict(COORD_KW, cross=cross_d, graph_mean=graph_mean, update_rows=update_rows)
    ec.reset_launch_counts()
    got = ec.coord_update_agg(*main, **kw)
    again = ec.coord_update_agg(*main, **kw)
    assert ec.launch_counts["coord_agg"] == 2
    assert ec.last_cluster_dim("coord_agg") == ec.cluster_size(width)
    assert torch.equal(got, again)  # fixed-order row sums: the same bits
    ref = _plain_in_slices(ec.coord_update_agg_plain, main, kw,
                           _plain_step(width) if B == 16 else B)
    if share is None:
        torch.testing.assert_close(got, ref, **TOL)
    else:
        assert torch.isfinite(got).all()
        err = float((got - ref).abs().max())
        assert err <= share * float(ref.abs().max()), err
    if update_rows is not None:
        assert not got[:, update_rows:].any()


@pytest.mark.parametrize("width", [64, 128, 256, 1024, 2048])
@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
@pytest.mark.parametrize("update_rows", [24, None], ids=["ligand_rows", "all_rows"])
@pytest.mark.parametrize("cross", [True, False], ids=["cross", "no_cross"])
def test_coord_kernel_at_flagship_shapes(width, spread, update_rows, cross):
    """B = 16, N = 344 (24 ligand atoms): the main path's 96 row tiles of
    ligand rows, or all 1376 (at F = 1024 one row a tile: 384 or 5504; at
    2048 each on a cluster of two blocks, the head's two shares summed on
    rank 0); at ``spread`` 1 every pair passes the cutoffs, so every chunk is
    full.  Two launches agree bit for bit."""
    _coord_case(28, 16, width, spread, update_rows, cross)


@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
@pytest.mark.parametrize("update_rows", [24, None], ids=["ligand_rows", "all_rows"])
@pytest.mark.parametrize("cross", [True, False], ids=["cross", "no_cross"])
def test_coord_kernel_at_flagship_shapes_512(spread, update_rows, cross):
    """``test_coord_kernel_at_flagship_shapes`` at F = 512 (tiles of 2 rows),
    held within 5e-6 of the output's largest entry, the F = 512 kernels'
    3xTF32 target (``chip_smoke.py`` phase 20h).  An entry sums pair terms
    as large as the output's largest (15 A / norm), each a head dot over 512
    features: on the collapsed complex with every row moving, a small entry
    that cancels such terms can sit past ``TOL``'s absolute 1e-5 while its
    error stays at 3xTF32's grade against the largest entry."""
    _coord_case(28, 16, 512, spread, update_rows, cross, share=5e-6)


@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_coord_kernel_at_the_joint_chain_batch(spread):
    """B = 8, every row moves, cross branch on: the launch of the joint chain
    with block fusing off."""
    _coord_case(29, 8, 256, spread, None, True)


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
@pytest.mark.parametrize("update_rows", [24, None], ids=["ligand_rows", "all_rows"])
def test_coord_bwd_kernel_at_flagship_shapes(width, spread, update_rows):
    """The coordinate backward kernel (3xTF32 on the tensor cores) at N = 344
    (24 ligand atoms), B = 4, cross branch, tanh and edge-type deltas on: the
    conditional train step's launch (ligand rows) and the joint one's (every
    row), every cotangent against autograd through the plain twin; at
    ``spread`` 1 every pair passes the cutoffs, so every chunk is full.  Two
    launches agree bit for bit."""
    main, cross_d, graph_mean = coord_inputs(32, 4, F=width, spread=spread)
    a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, table, w2, b2, w3 = main
    a_row, a_col, delta = ec.fold_type_bias(a_row, a_col, is_lig, table)
    cross = _folded_cross(cross_d, is_lig, cross_d["w3"])
    ops = (a_row.contiguous(), a_col.contiguous(), x, x0, mask, is_lig, w_d2, w_d20,
           delta, w2, b2, w3)
    kw = dict(COORD_KW, cross=cross, graph_mean=graph_mean, update_rows=update_rows)
    g = torch.randn(4, 344, 3, generator=torch.Generator().manual_seed(33)).cuda()
    ec.reset_launch_counts()
    got = ec.coord_agg_bwd(g, *ops, **kw)
    again = ec.coord_agg_bwd(g, *ops, **kw)
    assert ec.launch_counts["coord_agg_bwd"] == 2
    got, again = _coord_cot(got), _coord_cot(again)
    for name in got:
        assert torch.equal(got[name], again[name]), name
    _assert_cotangents(got, _coord_cot(ec.coord_agg_bwd_plain(g, *ops, **kw)))


# ---------------------------------------------------------------------------
# precision tiers: each split kernel at 2xTF32 and bf16 against its plain
# version at that tier (ec.TIER_GATES: the largest error, and the error's
# norm as a share of how far the tier moves the plain version from
# float32's), launched from that tier's library
# ---------------------------------------------------------------------------

def _assert_tier_close(got, ref, exact, tier, gates=ec.TIER_GATES):
    gate = gates[tier]
    limit = TOL["atol"] + TOL["rtol"] * ref.abs() + gate["share"] * float(ref.abs().max())
    assert torch.isfinite(got).all()
    assert bool(((got - ref).abs() <= limit).all()), float((got - ref).abs().max())
    moved = ec.tier_moved_share(got, ref, exact)
    assert moved <= gate["moved"], moved


def _assert_tier_cotangents(got, ref, exact, tier):
    _assert_cotangents(got, ref, ec.TIER_GATES[tier]["bwd"])
    for name in ref:
        if ref[name] is not None:
            moved = ec.tier_moved_share(got[name], ref[name], exact[name])
            assert moved <= ec.TIER_GATES[tier]["moved"], (name, moved)


def _only_tier(name, tier, launches=1):
    """``name`` ran ``launches`` times, all at ``tier``."""
    for t in ec.TIERS:
        assert ec.tier_launch_counts[f"{name}[{t}]"] == (launches if t == tier else 0), t


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("tier", ["tf32x2", "bf16"])
def test_tiered_forward_kernels_match_plain(tier, width):
    main, extra = _inputs(20, F=width, w_scale=None)
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    att = (extra["w_att"], extra["b_att"])
    ec.reset_launch_counts()
    got = ec.gcl_message_agg(*main.values(), *att, **kw, precision=tier)
    _only_tier("gcl_agg", tier)
    _assert_tier_close(got, ec.gcl_message_agg_plain(*main.values(), *att, **kw, precision=tier),
                       ec.gcl_message_agg_plain(*main.values(), *att, **kw), tier)
    m = main["mask"]
    ckw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
               normalization_factor=100.0, update_rows=12,
               cross=dict(_inputs(21, F=width, w_scale=None)[1]["cross"], w3=extra["w3"]),
               graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None])
    got = ec.coord_update_agg(*main.values(), extra["w3"], **ckw, precision=tier)
    _only_tier("coord_agg", tier)
    _assert_tier_close(
        got, ec.coord_update_agg_plain(*main.values(), extra["w3"], **ckw, precision=tier),
        ec.coord_update_agg_plain(*main.values(), extra["w3"], **ckw), tier)


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("tier", ["tf32x2", "bf16"])
def test_tiered_backward_kernels_match_plain(tier, width):
    main, extra = _inputs(22, F=width, w_scale=None)
    ops = _folded(main)
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    att = (extra["w_att"], extra["b_att"])
    g = torch.randn(B, N, width, generator=torch.Generator().manual_seed(23)).cuda()
    ec.reset_launch_counts()
    got = ec.gcl_agg_bwd(g, *ops.values(), *att, **kw, precision=tier)
    _only_tier("gcl_agg_bwd", tier)
    ref = ec.gcl_agg_bwd_plain(g, *ops.values(), *att, **kw, precision=tier)
    exact = ec.gcl_agg_bwd_plain(g, *ops.values(), *att, **kw)
    _assert_tier_cotangents(*(dict(zip(GCL_COT, c)) for c in (got, ref, exact)), tier)
    m = main["mask"]
    ckw = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
               normalization_factor=100.0, update_rows=12,
               cross=_folded_cross(_inputs(24, F=width, w_scale=None)[1]["cross"],
                                   main["is_lig"], extra["w3"]),
               graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None])
    gc = torch.randn(B, N, 3, generator=torch.Generator().manual_seed(25)).cuda()
    got = ec.coord_agg_bwd(gc, *ops.values(), extra["w3"], **ckw, precision=tier)
    _only_tier("coord_agg_bwd", tier)
    ref = ec.coord_agg_bwd_plain(gc, *ops.values(), extra["w3"], **ckw, precision=tier)
    exact = ec.coord_agg_bwd_plain(gc, *ops.values(), extra["w3"], **ckw)
    _assert_tier_cotangents(_coord_cot(got), _coord_cot(ref), _coord_cot(exact), tier)


@pytest.mark.parametrize("tier", ["tf32x2", "bf16"])
def test_autograd_runs_the_backward_tier(tier):
    """A 3xTF32 forward with a ``bwd_precision`` backward: each kernel at its
    own tier, and the gradients those of the plain backward at that tier."""
    main, extra = _inputs(26, w_scale=None)
    a_row = main["a_row"].clone().requires_grad_(True)
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    ec.reset_launch_counts()
    out = ec.gcl_message_agg(a_row, *list(main.values())[1:], extra["w_att"],
                             extra["b_att"], **kw, bwd_precision=tier)
    out.backward(torch.ones_like(out))
    _only_tier("gcl_agg", "tf32x3")
    _only_tier("gcl_agg_bwd", tier)
    ops = _folded(main)
    ref, exact = (ec.gcl_agg_bwd_plain(torch.ones_like(out), *ops.values(), extra["w_att"],
                                       extra["b_att"], **kw, precision=t)
                  for t in (tier, "tf32x3"))
    _assert_tier_cotangents({"da_row": a_row.grad}, {"da_row": ref[0]},
                            {"da_row": exact[0]}, tier)


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("tier", ["tf32x2", "bf16"])
def test_tiered_block_kernel_matches_plain(tier, width):
    """The whole-block kernel's library at each reduced tier against the
    plain version at that tier (``BLOCK_TIER_GATES``; at bf16
    ``ec.block_bf16_gate``), both outputs; dx rows at and above
    ``update_rows`` exact zeros; only that tier's library launched."""
    ins = block_inputs(40, N=90, F=width, n_lig=10, spread=4.0)
    kw = dict(BLOCK_KW, update_rows=10)
    ec.reset_launch_counts()
    got = ec.block_fused(*ins, **kw, precision=tier)
    _only_tier("block_fused", tier)
    ref = ec.block_fused_plain(*ins, **kw, precision=tier)
    exact = ec.block_fused_plain(*ins, **kw)
    sums = ec.block_fused_bf16_exact(*ins, **kw) if tier == "bf16" else None
    _assert_block_tier(got, ref, exact, tier, 10, sums)


def _dynamics_case(device, hidden_nf=64, **knobs):
    """A two-layer flagship-style network (cross branch, attention, tanh,
    cutoffs) with seeded weights, and a batch, on ``device``."""
    from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
    torch.manual_seed(0)
    knobs = {"update_pocket_coords": False, "kernel_block_fuse": False, **knobs}
    model = EGNNDynamics(atom_nf=5, residue_nf=7, joint_nf=16, hidden_nf=hidden_nf, n_layers=2,
                         attention=True, tanh=True, norm_constant=1.0, inv_sublayers=1,
                         reflection_equivariant=False, edge_cutoff_pocket=5.0,
                         edge_cutoff_interaction=5.0, **knobs).to(device)
    g = torch.Generator().manual_seed(1)
    NL, NP = 12, 40
    xh_l = torch.cat([torch.randn(B, NL, 3, generator=g),
                      torch.eye(5)[torch.randint(0, 5, (B, NL), generator=g)]], -1)
    xh_p = torch.cat([torch.randn(B, NP, 3, generator=g) * 3,
                      torch.eye(7)[torch.randint(0, 7, (B, NP), generator=g)]], -1)
    batch = [t.to(device) for t in (xh_l, xh_p, torch.full((B, 1), 0.4),
                                    torch.ones(B, NL), torch.ones(B, NP))]
    return model, batch


def _sum_sq_grads(model, batch):
    loss = sum(e.pow(2).sum() for e in model(*batch))
    return {n: g.cpu() for n, g in zip(
        [n for n, _ in model.named_parameters()],
        torch.autograd.grad(loss, list(model.parameters()), allow_unused=True))
        if g is not None}


def test_egnn_impl_xla_launches_no_kernel():
    """``egnn_impl: xla`` on the card: the dense path, forward and backward,
    with no kernel launched, block fusing asked for or not; its values those
    of the CPU's dense path."""
    model, batch = _dynamics_case("cuda", egnn_impl="xla", kernel_block_fuse=True)
    ec.reset_launch_counts()
    with torch.no_grad():
        got = model(*batch, block_fuse=True)
    grads = _sum_sq_grads(model, batch)
    assert not any(ec.launch_counts.values()), ec.launch_counts
    cpu, cpu_batch = _dynamics_case("cpu", egnn_impl="xla")
    with torch.no_grad():
        want = cpu(*cpu_batch)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)
    assert grads


def test_kernel_bwd_xla_launches_no_backward_kernel():
    """``kernel_bwd: xla`` on the card: the forward kernels run (one of each
    split kernel a layer), no backward kernel, and the gradients are the
    CPU's plain autograd (the mirror) within the backward kernels' gate."""
    model, batch = _dynamics_case("cuda", kernel_bwd="xla")
    ec.reset_launch_counts()
    got = _sum_sq_grads(model, batch)
    assert ec.launch_counts == {"gcl_agg": 2, "coord_agg": 2, "gcl_agg_bwd": 0,
                                "coord_agg_bwd": 0, "block_fused": 0}, ec.launch_counts
    cpu, cpu_batch = _dynamics_case("cpu", kernel_bwd="xla")
    _assert_cotangents(got, _sum_sq_grads(cpu, cpu_batch))


# ---------------------------------------------------------------------------
# hidden widths the kernels are not built for: zero-padded to the next one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [96, 192, 384, 448, 640, 896, 1088, 1536])
def test_padded_widths_match_plain(width):
    """96 runs at 128, 192 at 256, 384 and 448 at 512, 640 and 896 at 1024,
    1088 and 1536 at 2048 (``ec.padded_width``):
    each of the five wrappers against its plain version at the true width,
    one launch each, every output and cotangent at the true width; above
    1024 each launch on a cluster of two."""
    main, extra = _inputs(50, F=width, w_scale=None)
    att = (extra["w_att"], extra["b_att"])
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    m = main["mask"]
    ckw = dict(COORD_KW, update_rows=12, cross=dict(extra["cross"], w3=extra["w3"]),
               graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None])
    ec.reset_launch_counts()
    got = ec.gcl_message_agg(*main.values(), *att, **kw)
    assert got.shape == (B, N, width)
    torch.testing.assert_close(got, ec.gcl_message_agg_plain(*main.values(), *att, **kw),
                               **TOL)
    torch.testing.assert_close(ec.coord_update_agg(*main.values(), extra["w3"], **ckw),
                               ec.coord_update_agg_plain(*main.values(), extra["w3"], **ckw),
                               **TOL)
    ops = _folded(main)
    gen = torch.Generator().manual_seed(51)
    g = torch.randn(B, N, width, generator=gen).cuda()
    _assert_cotangents(dict(zip(GCL_COT, ec.gcl_agg_bwd(g, *ops.values(), *att, **kw))),
                       dict(zip(GCL_COT, ec.gcl_agg_bwd_plain(g, *ops.values(), *att, **kw))))
    ckw["cross"] = _folded_cross(extra["cross"], main["is_lig"], extra["w3"])
    gc = torch.randn(B, N, 3, generator=gen).cuda()
    _assert_cotangents(
        _coord_cot(ec.coord_agg_bwd(gc, *ops.values(), extra["w3"], **ckw)),
        _coord_cot(ec.coord_agg_bwd_plain(gc, *ops.values(), extra["w3"], **ckw)))
    ins = block_inputs(52, F=width)
    got = ec.block_fused(*ins, **BLOCK_KW, update_rows=12)
    assert got[0].shape == (B, N, width)
    assert_block_close(got, ec.block_fused_plain(*ins, **BLOCK_KW, update_rows=12), 12)
    assert ec.launch_counts == dict.fromkeys(ec.KERNELS, 1), ec.launch_counts
    if width > 1024:
        assert all(ec.last_cluster_dim(k) == 2 for k in ec.KERNELS)


def test_padded_width_network_matches_cpu():
    """A hidden-96 network on the card, the split kernels forward and
    backward (one launch of each a layer) and the whole-block kernel,
    against its plain versions on the CPU."""
    model, batch = _dynamics_case("cuda", hidden_nf=96, kernel_block_fuse=True)
    cpu, cpu_batch = _dynamics_case("cpu", hidden_nf=96)
    ec.reset_launch_counts()
    got = _sum_sq_grads(model, batch)
    assert ec.launch_counts == {"gcl_agg": 2, "coord_agg": 2, "gcl_agg_bwd": 2,
                                "coord_agg_bwd": 2, "block_fused": 0}, ec.launch_counts
    _assert_cotangents(got, _sum_sq_grads(cpu, cpu_batch))
    with torch.no_grad():
        fused = model(*batch, block_fuse=True)
        want = cpu(*cpu_batch)
    assert ec.launch_counts["block_fused"] == 2
    for f, w in zip(fused, want):
        torch.testing.assert_close(f.cpu(), w, atol=1e-4, rtol=1e-4)


def _wide_network_matches_cpu(hidden):
    """A hidden-``hidden`` network on the card (above 1024: the split kernels
    at F = 2048 or 4096, each row tile on a cluster of two or four blocks):
    its forward and its gradient on the split kernels and their backward
    kernels (one launch of each a layer) against the plain versions on the
    CPU."""
    clusters = ec.cluster_size(ec.padded_width(hidden))
    model, batch = _dynamics_case("cuda", hidden_nf=hidden)
    cpu, cpu_batch = _dynamics_case("cpu", hidden_nf=hidden)
    ec.reset_launch_counts()
    with torch.no_grad():
        got = model(*batch)
        want = cpu(*cpu_batch)
    assert ec.launch_counts == {**dict.fromkeys(ec.KERNELS, 0), "gcl_agg": 2,
                                "coord_agg": 2}, ec.launch_counts
    assert ec.last_cluster_dim("gcl_agg") == ec.last_cluster_dim("coord_agg") == clusters
    for f, w in zip(got, want):
        torch.testing.assert_close(f.cpu(), w, atol=1e-4, rtol=1e-4)
    ec.reset_launch_counts()
    grads = _sum_sq_grads(model, batch)
    assert ec.launch_counts == {**dict.fromkeys(ec.KERNELS, 2), "block_fused": 0}, \
        ec.launch_counts
    assert all(ec.last_cluster_dim(k) == clusters for k in ec.KERNELS if k != "block_fused")
    _assert_cotangents(grads, _sum_sq_grads(cpu, cpu_batch))


def test_padded_width_1088_network_matches_cpu():
    """Hidden 1088, zero-padded onto the F = 2048 kernels: the forward and
    (since the backward kernels are built at 2048) the gradient on the
    kernels, against the CPU."""
    _wide_network_matches_cpu(1088)


def test_width_2048_network_matches_cpu():
    """Hidden 2048, the kernels' own width: as the hidden-1088 network."""
    _wide_network_matches_cpu(2048)


def test_forward_width_above_2048_is_refused():
    """The split kernels run every width up to 4096 (2049-4096 on the F =
    4096 kernels, clusters of four blocks), the backward ones too: at 2112
    a forward whose gradient is due runs, and so does its gradient, padded
    onto 4096 (each wrapper once, on clusters of four).  4160 is wider: a
    ValueError naming the ROADMAP item, before any launch, with a gradient
    due or not."""
    main, extra = _inputs(53, F=2112, w_scale=None)
    m = main["mask"]
    main["w2"].requires_grad_(True)
    extra["w3"].requires_grad_(True)
    ec.reset_launch_counts()
    out = ec.gcl_message_agg(*main.values(), extra["w_att"], extra["b_att"], cutoffs=CUTOFFS,
                             attention=True, normalization_factor=100.0)
    dx = ec.coord_update_agg(*main.values(), extra["w3"], **COORD_KW, update_rows=12,
                             cross=dict(extra["cross"], w3=extra["w3"]),
                             graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None])
    assert out.shape == (B, N, 2112) and dx.shape == (B, N, 3)
    dw2, dw3 = torch.autograd.grad(out.square().sum() + dx.square().sum(),
                                   (main["w2"], extra["w3"]))
    assert dw2.shape == (2112, 2112) and dw3.shape == (2112, 1)
    assert torch.isfinite(dw2).all() and torch.isfinite(dw3).all()
    assert ec.launch_counts == {**dict.fromkeys(ec.KERNELS, 1), "block_fused": 0}
    assert all(ec.last_cluster_dim(k) == 4 for k in ec.KERNELS if k != "block_fused")
    for grad_due in (False, True):
        main, extra = _inputs(53, F=4160)
        m = main["mask"]
        main["w2"].requires_grad_(grad_due)
        above = "above 4096.*the widest (gcl|coord)_agg .*widths above 4096"
        ec.reset_launch_counts()
        with pytest.raises(ValueError, match=above):
            ec.gcl_message_agg(*main.values(), extra["w_att"], extra["b_att"],
                               cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
        with pytest.raises(ValueError, match=above):
            ec.coord_update_agg(*main.values(), extra["w3"], **COORD_KW, update_rows=12,
                                cross=dict(extra["cross"], w3=extra["w3"]),
                                graph_mean=(main["x"] * m[..., None]).sum(1)
                                / m.sum(1)[:, None])
        assert not any(ec.launch_counts.values())


# ---------------------------------------------------------------------------
# the forward split kernels at F = 4096, each row tile on a cluster of four
# ---------------------------------------------------------------------------

# case: (cross, attention, update_rows), on B = 2 graphs of 45 nodes, 12 of
# them ligand rows, fan-in weights
WIDE_CASES = {"cross": (True, True, 11), "no_cross": (False, True, 12),
              "no_attention": (True, False, None)}


@pytest.mark.parametrize("width", [4096, 3072])
@pytest.mark.parametrize("tier", ["tf32x3", "tf32x2", "bf16"])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_forward_kernels_at_4096(case, tier, width):
    """``gcl_agg`` and ``coord_agg`` at F = 4096 (3072 zero-padded onto it)
    at each tier against their plain versions at the tier (3xTF32 within
    ``TOL``, the others ``ec.TIER_GATES``): the cross branch on and off,
    attention off, odd ``update_rows`` with the rows past it exact zeros;
    two launches bit for bit, each on clusters of four blocks."""
    cross, attention, rows = WIDE_CASES[case]
    main, extra = _inputs(70, N=45, F=width, w_scale=None)
    m = main["mask"]
    att = (extra["w_att"], extra["b_att"]) if attention else (None, None)
    gcl_kw = dict(cutoffs=CUTOFFS, attention=attention, normalization_factor=100.0,
                  update_rows=rows)
    coord_kw = dict(COORD_KW, update_rows=rows)
    if cross:
        coord_kw.update(cross=dict(extra["cross"], w3=extra["w3"]),
                        graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None])
    for name, wrapper, plain, args, kw in (
            ("gcl_agg", ec.gcl_message_agg, ec.gcl_message_agg_plain,
             (*main.values(), *att), gcl_kw),
            ("coord_agg", ec.coord_update_agg, ec.coord_update_agg_plain,
             (*main.values(), extra["w3"]), coord_kw)):
        ec.reset_launch_counts()
        got = wrapper(*args, **kw, precision=tier)
        again = wrapper(*args, **kw, precision=tier)
        _only_tier(name, tier, launches=2)
        assert ec.last_cluster_dim(name, tier) == 4
        assert torch.equal(got, again)
        if tier == ec.DEFAULT_TIER:
            torch.testing.assert_close(got, plain(*args, **kw), **TOL)
        else:
            _assert_tier_close(got, plain(*args, **kw, precision=tier), plain(*args, **kw),
                               tier)
        if rows is not None:
            assert not got[:, rows:].any()


@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_forward_kernels_at_4096_on_many_clusters(spread):
    """A grid of many clusters of four: B = 4 graphs of 344 nodes (24 ligand
    atoms), every row moving (1376 row tiles, 5504 blocks, over 40 waves of
    the card's clusters); at ``spread`` 1 every pair passes the cutoffs.
    The GCL and the coordinate update (cross branch on) against their plain
    versions (batch slices of one graph: 1.9 GB a (1, 344, 344, 4096)
    float32 tensor)."""
    ops = _gcl_ops(block_inputs(71, B=4, N=344, F=4096, n_lig=24, spread=spread))
    ec.reset_launch_counts()
    got = ec.gcl_message_agg(*ops, **GCL_KW)
    assert ec.launch_counts["gcl_agg"] == 1 and ec.last_cluster_dim("gcl_agg") == 4
    torch.testing.assert_close(got, _plain_in_slices(ec.gcl_message_agg_plain, ops, GCL_KW, 1),
                               **TOL)
    del got
    main, cross_d, graph_mean = coord_inputs(72, 4, F=4096, spread=spread)
    kw = dict(COORD_KW, cross=cross_d, graph_mean=graph_mean)
    got = ec.coord_update_agg(*main, **kw)
    assert ec.launch_counts["coord_agg"] == 1 and ec.last_cluster_dim("coord_agg") == 4
    torch.testing.assert_close(got, _plain_in_slices(ec.coord_update_agg_plain, main, kw, 1),
                               **TOL)


@pytest.mark.parametrize("hidden", [4096, 3072])
def test_width_4096_network_matches_cpu(hidden):
    """A hidden-4096 (and 3072, zero-padded onto 4096) conditional network on
    the card: its forward on the split kernels at F = 4096 and its gradient
    on their backward kernels at F = 4096 (one launch of each a layer,
    clusters of four) against the plain versions on the CPU."""
    _wide_network_matches_cpu(hidden)


# ---------------------------------------------------------------------------
# the backward kernels at F = 4096, each row tile on a cluster of four
# ---------------------------------------------------------------------------

# case: (cross, attention, update_rows, column block of a two-rank edge
# split), on B = 2 graphs of 45 nodes, 12 of them ligand rows, fan-in weights
WIDE_BWD_CASES = {"cross": (True, True, 11, None), "no_cross_block": (False, True, 12, 1),
                  "no_attention_block": (True, False, None, 0)}


def _equal_cotangents(got, again):
    for name in got:
        assert (got[name] is None and again[name] is None) or torch.equal(got[name],
                                                                        again[name]), name


@pytest.mark.parametrize("width", [4096, 3072])
@pytest.mark.parametrize("tier", ["tf32x3", "tf32x2", "bf16"])
@pytest.mark.parametrize("case", list(WIDE_BWD_CASES))
def test_bwd_kernels_at_4096(case, tier, width):
    """``gcl_agg_bwd`` and ``coord_agg_bwd`` at F = 4096 (3072 zero-padded
    onto it) at each tier against their plain versions at the tier (3xTF32:
    ``_assert_cotangents``; the others ``ec.TIER_GATES``): the cross branch
    on and off, attention on and off, an odd ``update_rows`` (da_row zero
    past it), a column block; two launches bit for bit, each on clusters of
    four blocks of the tier's library."""
    cross, attention, rows, block = WIDE_BWD_CASES[case]
    main, extra = _inputs(80, N=45, F=width, w_scale=None)
    ops = _folded(main)
    m = main["mask"]
    col_mask = None if block is None else _column_block(m, block)
    kw = dict(cutoffs=CUTOFFS, attention=attention, normalization_factor=100.0,
              update_rows=rows, col_mask=col_mask)
    ckw = dict(COORD_KW, update_rows=rows, col_mask=col_mask)
    if cross:
        ckw.update(cross=_folded_cross(extra["cross"], main["is_lig"], extra["w3"]),
                   graph_mean=(m[..., None] * main["x"]).sum(1) / m.sum(1)[:, None])
    att = (extra["w_att"], extra["b_att"]) if attention else (None, None)
    gen = torch.Generator().manual_seed(81)
    g = torch.randn(B, 45, width, generator=gen).cuda()
    gc = torch.randn(B, 45, 3, generator=gen).cuda()
    calls = {"gcl_agg_bwd": lambda fn, **t: dict(zip(GCL_COT, fn(g, *ops.values(), *att, **kw,
                                                                 **t))),
             "coord_agg_bwd": lambda fn, **t: _coord_cot(fn(gc, *ops.values(), extra["w3"],
                                                            **ckw, **t))}
    for name, call in calls.items():
        kernel, plain = getattr(ec, name), getattr(ec, f"{name}_plain")
        ec.reset_launch_counts()
        got, again = call(kernel, precision=tier), call(kernel, precision=tier)
        _only_tier(name, tier, launches=2)
        assert ec.last_cluster_dim(name, tier) == 4
        _equal_cotangents(got, again)
        exact = call(plain)
        if tier == ec.DEFAULT_TIER:
            _assert_cotangents(got, exact)
        else:
            _assert_tier_cotangents(got, call(plain, precision=tier), exact, tier)
        if rows is not None:
            assert not got["da_row"][:, rows:].any()


PER_GRAPH = ("da_row", "da_col", "dx", "dx0", "cross.a_row", "cross.a_col", "dmean")


def _bwd_plain_in_slices(call, batch, step=1):
    """``call(sl)`` (a backward plain version's named cotangents on the batch
    slice ``sl``) over slices of ``step`` graphs: the per-graph cotangents
    concatenated, the weights' summed."""
    parts = [call(slice(b, b + step)) for b in range(0, batch, step)]
    return {k: None if parts[0][k] is None
            else torch.cat([p[k] for p in parts]) if k in PER_GRAPH
            else torch.stack([p[k] for p in parts]).sum(0) for k in parts[0]}


@pytest.mark.parametrize("spread", [4.0, 1.0], ids=["clean", "collapsed"])
def test_bwd_kernels_at_4096_on_many_clusters(spread):
    """A grid of many clusters of four: B = 4 graphs of 344 nodes (24 ligand
    atoms), attention and edge-type deltas on; the GCL's every row, the
    coordinate update's ligand rows (cross branch and tanh on); at
    ``spread`` 1 every pair passes the cutoffs.  Both backward kernels
    against their plain versions (batch slices of one graph: a (1, 344,
    344, 4096) float32 tensor is 1.9 GB)."""
    ins = block_inputs(75, B=4, N=344, F=4096, n_lig=24, spread=spread)
    _, a_row, a_col, x, x0, mask, is_lig, gcl = ins[:8]
    nodes = (a_row, a_col, x, x0, mask, is_lig)
    rest = (gcl["w_d2"], gcl["w_d20"], gcl["type_delta"], gcl["w2"], gcl["b2"],
            gcl["w_att"], gcl["b_att"])
    gen = torch.Generator().manual_seed(76)
    g = torch.randn(4, 344, 4096, generator=gen).cuda()
    ec.reset_launch_counts()
    got = dict(zip(GCL_COT, ec.gcl_agg_bwd(g, *nodes, *rest, **GCL_KW)))
    assert ec.launch_counts["gcl_agg_bwd"] == 1 and ec.last_cluster_dim("gcl_agg_bwd") == 4
    ref = _bwd_plain_in_slices(lambda sl: dict(zip(GCL_COT, ec.gcl_agg_bwd_plain(
        g[sl], *(t[sl] for t in nodes), *rest, **GCL_KW))), 4)
    _assert_cotangents(got, ref)
    del got, ref, g
    main, cross_d, graph_mean = coord_inputs(77, 4, F=4096, spread=spread)
    a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, table, w2, b2, w3 = main
    a_row, a_col, delta = ec.fold_type_bias(a_row, a_col, is_lig, table)
    nodes = (a_row.contiguous(), a_col.contiguous(), x, x0, mask, is_lig)
    rest = (w_d2, w_d20, delta, w2, b2, w3)
    cross = _folded_cross(cross_d, is_lig, cross_d["w3"])
    kw = dict(COORD_KW, update_rows=24)
    gc = torch.randn(4, 344, 3, generator=gen).cuda()
    got = _coord_cot(ec.coord_agg_bwd(gc, *nodes, *rest, **kw, cross=cross,
                                      graph_mean=graph_mean))
    assert ec.launch_counts["coord_agg_bwd"] == 1 and ec.last_cluster_dim("coord_agg_bwd") == 4

    def plain(sl):
        c = {k: (v[sl] if k in ("a_row", "a_col") else v) for k, v in cross.items()}
        return _coord_cot(ec.coord_agg_bwd_plain(gc[sl], *(t[sl] for t in nodes), *rest, **kw,
                                                 cross=c, graph_mean=graph_mean[sl]))

    _assert_cotangents(got, _bwd_plain_in_slices(plain, 4))


def test_backward_width_above_2048_is_refused():
    """The backward kernels run every width up to 4096; 4160 is wider: a
    ValueError naming the ROADMAP item, before any launch."""
    main, extra = _inputs(53, F=4160)
    att = (extra["w_att"], extra["b_att"])
    kw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
    ops = _folded(main)
    m = main["mask"]
    ckw = dict(COORD_KW, update_rows=12,
               cross=_folded_cross(extra["cross"], main["is_lig"], extra["w3"]),
               graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None])
    ec.reset_launch_counts()
    with pytest.raises(ValueError, match="above 4096.*ROADMAP.*widths above 4096"):
        ec.gcl_agg_bwd(torch.ones(B, N, 4160, device="cuda"), *ops.values(), *att, **kw)
    with pytest.raises(ValueError, match="above 4096.*ROADMAP.*widths above 4096"):
        ec.coord_agg_bwd(torch.ones(B, N, 3, device="cuda"), *ops.values(), extra["w3"], **ckw)
    assert not any(ec.launch_counts.values())


def test_block_width_above_4096_is_refused():
    """The whole-block kernel runs every width up to 4096; 4160 is wider: a
    ValueError naming its ROADMAP item, before any launch."""
    ins = block_inputs(54, F=4160)
    ec.reset_launch_counts()
    with pytest.raises(ValueError, match="above 4096.*ROADMAP.*widths above 4096"):
        ec.block_fused(*ins, **BLOCK_KW)
    assert not any(ec.launch_counts.values())


# ---------------------------------------------------------------------------
# the kernels' pair counters
# ---------------------------------------------------------------------------

def _outputs(out):
    """Every tensor of a wrapper's result, in order."""
    if torch.is_tensor(out):
        return [out]
    items = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) \
        else ()
    return [t for v in items for t in _outputs(v)]


def _pair_case(kernel, width, update_rows, seed=90):
    """(one launch of ``kernel`` at ``width``, x0, mask, is_lig, the rows
    below which each of its phases counts)."""
    if kernel == "block_fused":
        ins = block_inputs(seed, F=width)
        kw = dict(BLOCK_KW, update_rows=update_rows)
        return (lambda: ec.block_fused(*ins, **kw)), ins[4], ins[5], ins[6], \
            [None, update_rows]
    main, extra = _inputs(seed, F=width, w_scale=None)
    m = main["mask"]
    att = (extra["w_att"], extra["b_att"])
    gkw = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0,
               update_rows=update_rows)
    ckw = dict(COORD_KW, update_rows=update_rows,
               graph_mean=(main["x"] * m[..., None]).sum(1) / m.sum(1)[:, None])
    gen = torch.Generator().manual_seed(seed + 1)
    ops = _folded(main)
    if kernel == "gcl_agg":
        run = lambda: ec.gcl_message_agg(*main.values(), *att, **gkw)
    elif kernel == "coord_agg":
        cross = dict(extra["cross"], w3=extra["w3"])
        run = lambda: ec.coord_update_agg(*main.values(), extra["w3"], cross=cross, **ckw)
    elif kernel == "gcl_agg_bwd":
        g = torch.randn(B, N, width, generator=gen).cuda()
        run = lambda: ec.gcl_agg_bwd(g, *ops.values(), *att, **gkw)
    else:
        g = torch.randn(B, N, 3, generator=gen).cuda()
        cross = _folded_cross(extra["cross"], main["is_lig"], extra["w3"])
        run = lambda: ec.coord_agg_bwd(g, *ops.values(), extra["w3"], cross=cross, **ckw)
    return run, main["x0"], m, main["is_lig"], [update_rows]


def _dense_pair_counts(x0, mask, is_lig, phases, width):
    """(active, computed) as the kernels count them, from the dense
    adjacency: the pairs inside the cutoffs on each phase's rows, and for
    each tile of ``row_tile(width)`` rows its columns adjacent to any of its
    rows, in chunks of 16, times the tile's rows.  Refuses inputs with a
    pair within float32 rounding of its cutoff, which either side may
    count."""
    d2 = ec._pair_d2(x0.double())
    for c in CUTOFFS:
        if c is not None:
            assert not ((d2 - c * c).abs() <= 1e-4 * c * c).any(), "a borderline pair"
    adj = ec.adjacency_dense(d2, mask.double(), is_lig.double(), CUTOFFS) != 0
    TI, n = ec.row_tile(width), x0.shape[1]
    active = computed = 0
    for rows in phases:
        r = n if rows is None else min(rows, n)
        tiles = -(-r // TI)
        a = torch.nn.functional.pad(adj[:, :r], (0, 0, 0, tiles * TI - r))
        active += int(a.sum())
        cols = a.view(B, tiles, TI, n).any(2).sum(-1)
        computed += int((TI * 16 * ((cols + 15) // 16)).sum())
    return active, computed


@pytest.mark.parametrize("width", [256, 4096])
@pytest.mark.parametrize("update_rows", [None, 12], ids=["all_rows", "ligand_rows"])
@pytest.mark.parametrize("kernel", ["gcl_agg", "coord_agg", "gcl_agg_bwd", "coord_agg_bwd",
                                    "block_fused"])
def test_kernels_count_their_pairs(kernel, update_rows, width):
    """While a profiler records, a launch counts the pairs inside the
    cutoffs exactly as the dense adjacency has them and the pairs its chunks
    hold (each tile once, whatever its cluster of four blocks at 4096 or its
    pair MLP); its outputs are bit for bit those of a launch with a null
    counter, which counts nothing."""
    run, x0, mask, is_lig, phases = _pair_case(kernel, width, update_rows)
    ec.reset_launch_counts()
    off = _outputs(run())
    torch.cuda.synchronize()
    assert ec.pair_counts()[kernel] == (0, 0) and ec.launch_counts[kernel] == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = _outputs(run())
    assert ec.last_cluster_dim(kernel) == ec.cluster_size(width)
    want = _dense_pair_counts(x0, mask, is_lig, phases, width)
    got = ec.pair_counts()
    assert got[kernel] == want and want[1] >= want[0] > 0
    assert all(v == (0, 0) for k, v in got.items() if k != kernel)
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))
