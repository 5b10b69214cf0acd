"""The port's CUDA kernels against their plain twins on a card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_gpu.py``.  Without
a card every test skips.  Tolerance atol 1e-5, rtol 1e-4: float32 on both
sides, pairs summed in another order.
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


def _inputs(seed, N=N):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).cuda()
    x = r(B, N, 3, scale=3.0)
    mask = (torch.rand((B, N), generator=g) > 0.2).float().cuda()
    is_lig = (torch.arange(N) < 12).float().expand(B, N).contiguous().cuda()
    main = dict(a_row=r(B, N, F, scale=0.3), a_col=r(B, N, F, scale=0.3),
                x=x, x0=x + r(B, N, 3, scale=0.1), mask=mask, is_lig=is_lig,
                w_d2=r(F, scale=0.1), w_d20=r(F, scale=0.1),
                type_bias=r(2, 2, F, scale=0.2), w2=r(F, F, scale=0.3),
                b2=r(F, scale=0.1))
    extra = dict(w_att=r(F, 1, scale=0.3), b_att=r(1, scale=0.1),
                 w3=r(F, 1, scale=0.3),
                 cross=dict(a_row=r(B, N, F, scale=0.3), a_col=r(B, N, F, scale=0.3),
                            w_d2=r(F, scale=0.1), w_d20=r(F, scale=0.1),
                            type_bias=r(2, 2, F, scale=0.2),
                            w2=r(F, F, scale=0.3), b2=r(F, scale=0.1)))
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


def test_wrapper_rejects_noncontiguous_weight():
    main, extra = _inputs(2)
    main["w2"] = main["w2"].t()
    with pytest.raises(ValueError, match="contiguous"):
        ec.gcl_message_agg(*main.values(), extra["w_att"], extra["b_att"],
                           cutoffs=CUTOFFS, attention=True,
                           normalization_factor=100.0)
