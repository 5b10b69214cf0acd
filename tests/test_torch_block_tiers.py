"""The whole-block kernel's precision tiers and the JAX package's
``egnn_impl: xla`` / ``kernel_bwd: xla`` paths in the port, against JAX on
the CPU.

``block_fused_plain(..., precision=)`` is the CPU path and the card's oracle
of ``csrc/block_fused.cu`` built at each tier: the split plain versions at
the tier for the pair MLPs, the tier's product for the node MLP and the
projections, their elementwise work in float32.  Operands: seed 0 of
``test_torch_block_fused.make_inputs`` at B = 2, N = 128 (JAX's kernel wants
N a multiple of its 128-wide column tile), H = F = 32.  A share is the
largest deviation over the reference's largest entry, over h_new and dx.

Tolerances, each beside the figure measured here:

* against JAX's exact ``block_fused_xla``: the split kernels' forward gates
  (``test_torch_precision.FWD_GATE``): 3xTF32 5e-4 (measured 4.3e-7),
  2xTF32 2e-3 (7.0e-4), bf16 5e-2 (1.3e-2); each reduced tier also moves
  the output at least 3e-5 (2xTF32) or 2e-3 (bf16);
* the bf16 plain version against JAX's interpret-mode kernel at
  ``mxu_precision="bfloat16"``: within 1e-2 (measured 6.2e-3), and closer
  to it by norm than float32 is (measured 0.86 of float32's distance).
  JAX's CPU interpreter rounds only the prepped weight of the node MLP's and
  the projections' products, the card (as a TPU) and the port both
  operands: with that one difference emulated the port is 0.09 of
  float32's distance (gate 1/4);
* the 3xTF32 default bit for bit the plain version as it was before the
  tiers (copied below);
* the network with ``kernel_block_fuse`` at ``bfloat16`` / ``float32_x2``
  against JAX's (Pallas kernels in interpret mode, block fusing on, the same
  precision, the fixture weights jittered below TF32's resolution, as
  ``chip_smoke.py`` does, so that 2xTF32 drops something): within the tier's
  forward gate, 5e-2 / 2e-3 of the largest entry (measured 3.2e-3 /
  1.7e-3: JAX's "float32_x2" drops the weight's low part below bf16's
  resolution, 1.7e-3 from its exact network, the port's below TF32's,
  2.0e-4 from it), every block the whole-block function at the tier;
* ``egnn_impl: xla``: eps against JAX's ``impl="xla"`` network within atol
  1e-4 + rtol 1e-4 (float32 on both sides; measured 3e-7), no kernel
  called;
* ``kernel_bwd: xla``: the wrappers' gradients through the mirror (a bf16
  forward, so that the port's autograd Function runs on the CPU) against
  ``jax.grad`` through JAX's Pallas interpret forward with
  ``bwd_impl="xla"``, for a linear loss (its gradient does not read the
  forward's values): atol 5e-4 of the largest entry + rtol 5e-3 (measured
  1.0e-6 of the largest entry, where the bf16 plain backward is 1.1e-2);
  the network's parameter gradients of sum(eps^2) against JAX's network
  with ``kernel_bwd="xla"`` and Pallas interpret forward, at the same
  tolerance (measured 2.5e-6); ``loss_terms`` within ``LOSS_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsbdd_tpu.ops.egnn_pallas as ep
from diffsbdd_tpu.models.dynamics import EGNNDynamics as JaxDynamics
from diffsbdd_tpu.ops.egnn_block_fused import block_fused_pallas, block_fused_xla
from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
from test_torch_block_fused import KW, NL, convert, make_inputs
from test_torch_dense import GRAD_TOL, KWARGS, PREFIX, VALUE_TOL, inputs, scaled
from test_torch_dynamics import COMMON, make_batch, port_dynamics
from test_torch_kernels import _d2_0, _jnp, _torch, coord_args, gcl_args
from test_torch_kernels import make_inputs as kernel_inputs
from test_torch_precision import COORD_KW, FWD_GATE, GCL_KW, _norm_share, _share
from test_torch_train import (LOSS_TOL, A, batches, both_modules,  # noqa: F401
                              datadir, feed, jax_draws, jnp_batch, tiny_overrides,
                              torch_batch)
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_jax

N = 128
TIERS = ("tf32x3", "tf32x2", "bf16")
MOVES_AT_LEAST = {"tf32x2": 3e-5, "bf16": 2e-3}
NAME = {"tf32x2": "float32_x2", "bf16": "bfloat16"}


@pytest.fixture(scope="module")
def block_case():
    """(numpy operands, JAX's exact outputs, JAX's bf16 interpret kernel's)."""
    ins = make_inputs(0, n=N)
    jins = convert(ins, jnp.asarray)
    exact = block_fused_xla(*jins, update_rows=NL, **KW)
    bf16 = block_fused_pallas(*jins, update_rows=NL, interpret=True,
                              mxu_precision="bfloat16", **KW)
    return ins, [np.asarray(o) for o in exact], [np.asarray(o) for o in bf16]


def _plain(ins, **kw):
    return [o.numpy() for o in ec.block_fused_plain(
        *convert(ins, torch.as_tensor), update_rows=NL, **KW, **kw)]


def _block_share(got, want):
    """The larger share of h_new and of dx's rows below ``update_rows``
    (JAX's kernel keeps whole row tiles, the port exact zeros past them)."""
    return max(_share(got[0], want[0]), _share(got[1][:, :NL], want[1][:, :NL]))


def _block_norm(got, want):
    return _norm_share(np.concatenate([got[0].ravel(), got[1][:, :NL].ravel()]),
                       np.concatenate([want[0].ravel(), want[1][:, :NL].ravel()]))


# ---------------------------------------------------------------------------
# the whole-block plain version at each tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", TIERS)
def test_block_plain_tiers_against_jax_exact(block_case, tier):
    ins, exact, _ = block_case
    got = _plain(ins, precision=tier)
    share = _block_share(got, exact)
    assert share <= FWD_GATE[tier], share
    if tier != "tf32x3":
        assert share > MOVES_AT_LEAST[tier], share
    assert not got[1][:, NL:].any()


def test_block_bf16_plain_against_jax_interpret_kernel(block_case, monkeypatch):
    """Closer by norm to JAX's bf16 kernel than float32 is; with the node
    MLP's and the projections' products rounding the weight alone, as JAX's
    CPU interpreter does, within a quarter of float32's distance: what
    remains apart is that rounding, not the pair MLPs' rounding points."""
    ins, exact, bf16 = block_case
    got = _plain(ins, precision="bf16")
    assert _block_share(got, bf16) <= 1e-2
    assert _block_norm(got, bf16) < _block_norm(exact, bf16)
    assert _block_share(bf16, exact) > 2e-3  # JAX's interpret kernel does round
    monkeypatch.setattr(ec, "_tier_product", lambda tier: lambda a, b: a @ ec.bf16_round(b))
    weight_only = _plain(ins, precision="bf16")
    assert _block_norm(weight_only, bf16) <= 0.25 * _block_norm(exact, bf16)


def _before_block(h, a_row, a_col, x, x0, mask, is_lig, gcl, node, coord, cross,
                  graph_mean, *, cutoffs, attention, tanh, coords_range,
                  norm_constant, normalization_factor, update_rows):
    """``block_fused_plain`` before the precision tiers, verbatim (at its
    default product)."""
    matmul = torch.matmul
    silu = torch.nn.functional.silu
    agg = ec.gcl_message_agg_plain(
        a_row, a_col, x, x0, mask, is_lig, gcl["w_d2"], gcl["w_d20"],
        ec._delta_table(gcl.get("type_delta")), gcl["w2"], gcl["b2"],
        gcl.get("w_att"), gcl.get("b_att"), cutoffs=cutoffs, attention=attention,
        normalization_factor=normalization_factor, matmul=matmul)
    pre_n = matmul(h, node["w_h"]) + matmul(agg, node["w_a"]) + node["b0"]
    h_new = (h + matmul(silu(pre_n), node["w2"]) + node["b2"]) * mask[..., None]

    def head(p):
        row, col, delta = ec.fold_type_bias(matmul(h_new, p["k_i"]) + p["b0"],
                                            matmul(h_new, p["k_j"]), is_lig,
                                            p.get("type_bias"))
        return row, col, ec._delta_table(delta)

    la_row, la_col, l_tb = head(coord)
    c_row, c_col, c_tb = head(cross)
    cross_arg = dict(a_row=c_row, a_col=c_col, w_d2=cross["w_d2"],
                     w_d20=cross["w_d20"], type_bias=c_tb, w2=cross["w1"],
                     b2=cross["b1"], w3=cross["w3"])
    dx = ec.coord_update_agg_plain(
        la_row, la_col, x, x0, mask, is_lig, coord["w_d2"], coord["w_d20"], l_tb,
        coord["w1"], coord["b1"], coord["w3"], cutoffs=cutoffs, tanh=tanh,
        coords_range=coords_range, norm_constant=norm_constant,
        normalization_factor=normalization_factor, cross=cross_arg,
        graph_mean=graph_mean, update_rows=update_rows, matmul=matmul)
    return h_new, dx


def test_block_default_tier_is_bitwise_the_untiered_plain_version(block_case):
    tins = convert(block_case[0], torch.as_tensor)
    want = _before_block(*tins, update_rows=NL, **KW)
    for got in (ec.block_fused_plain(*tins, update_rows=NL, **KW),
                ec.block_fused_plain(*tins, update_rows=NL, **KW, precision="tf32x3"),
                ec.block_fused(*tins, update_rows=NL, **KW)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("tier", ["tf32x2", "bf16"])
def test_block_tier_gate_refuses_other_arithmetic(block_case, tier):
    """The whole-block gates on what a faulty library would compute.  2xTF32
    (``tier_moved_share`` within ``BLOCK_TIER_GATES``' 0.25): 3xTF32 in the
    tier's slot reads 1.0.  bf16 (``block_bf16_gate``: against the bf16
    plain version with its products summed in float64, at most k = 2 times
    the plain version's own distance by norm and by largest error, with
    floors): the plain version itself passes (ratio 1), and 3xTF32 in the
    bf16 slot fails (it reads 1.0 of the tier's move by norm, against a
    limit of 0.28 / 0.33 for h_new / dx: at F = 32 the plain version is
    1.2e-5 / 6.9e-5 of the move from the float64 sums, so the floors set
    the limit), as do bf16 products without the pair MLPs' elementwise
    rounding points (0.82 / 46)."""
    tins = convert(block_case[0], torch.as_tensor)
    exact = ec.block_fused_plain(*tins, update_rows=NL, **KW)
    ref = ec.block_fused_plain(*tins, update_rows=NL, **KW, precision=tier)
    if tier == "tf32x2":
        gate = ec.BLOCK_TIER_GATES[tier]["moved"]
        for e, r in zip(exact, ref):
            assert ec.tier_moved_share(r, r, e) == 0.0
            assert ec.tier_moved_share(e, r, e) == 1.0 > gate
        return
    sums = ec.block_fused_bf16_exact(*tins, update_rows=NL, **KW)
    gcl = dict(tins[7], w_att=ec.bf16_round(tins[7]["w_att"]))
    coord = dict(tins[9], w3=ec.bf16_round(tins[9]["w3"]))
    cross = dict(tins[10], w3=coord["w3"])
    faulty = ec.block_fused_plain(*tins[:7], gcl, tins[8], coord, cross, tins[11],
                                  update_rows=NL, **KW, matmul=ec.matmul_bf16)
    for name, r, s, e, f in zip(("h_new", "dx"), ref, sums, exact, faulty):
        assert not torch.equal(r, s), name  # the float32 order moves the sums
        right = ec.block_bf16_gate(r, r, s, e)
        assert right["ok"] and right["ratio"] == 1.0, (name, right)
        for what, got in (("3xTF32", e), ("no rounding points", f)):
            res = ec.block_bf16_gate(got, r, s, e)
            assert not res["ok"] and res["ratio"] > ec.BLOCK_TIER_GATES["bf16"]["k"], (
                name, what, res)


def test_block_gradient_runs_the_tier(block_case):
    """The whole-block function's gradient on the CPU at a tier is autograd
    through that tier's plain version (the CUDA Function's backward too)."""
    tins = convert(block_case[0], lambda a: torch.as_tensor(a).requires_grad_(True))
    h_new, dx = ec.block_fused(*tins, update_rows=NL, **KW, precision="bf16")
    (h_new.sum() + dx.sum()).backward()
    fresh = convert(block_case[0], torch.as_tensor)
    grads = ec.block_fused_bwd_plain(torch.ones_like(h_new), torch.ones_like(dx),
                                     *fresh, update_rows=NL, **KW, precision="bf16")
    assert torch.allclose(tins[0].grad, grads[0], atol=1e-6, rtol=1e-5)
    exact = ec.block_fused_bwd_plain(torch.ones_like(h_new), torch.ones_like(dx),
                                     *fresh, update_rows=NL, **KW)
    assert not torch.allclose(grads[0], exact[0], atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the network with block fusing at the reduced tiers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_params():
    from test_torch_dynamics import FIXTURE
    from diffsbdd_tpu.utils.params_io import load_params_npz
    return load_params_npz(FIXTURE)


def _jittered(params, seed=0):
    """Every weight times 1 + u 2^-11, u uniform in [-1, 1): the float16
    fixture values gain a low part below TF32's resolution."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda w: (np.asarray(w) * (1 + (2 * rng.random(np.shape(w)) - 1) * 2 ** -11))
        .astype(np.float32), params)


@pytest.mark.parametrize("tier", ["tf32x2", "bf16"])
def test_network_block_fuse_at_tier_against_jax(fixture_params, monkeypatch, tier):
    fixture_params = _jittered(fixture_params)
    batch = make_batch(0)
    jax_model = JaxDynamics(**COMMON, update_pocket_coords=True, impl="pallas",
                            interpret=True, kernel_tile=32, kernel_tile_i=8,
                            kernel_sub_j=8, kernel_block_fuse=True,
                            matmul_precision=NAME[tier])
    apply = jax.jit(jax_model.apply, static_argnames=("block_fuse",))
    ref = apply(fixture_params["dynamics"], *map(jnp.asarray, batch), block_fuse=True)
    port = port_dynamics(fixture_params, update_pocket_coords=True,
                         kernel_block_fuse=True, matmul_precision=NAME[tier])
    seen, real = [], ec.block_fused
    monkeypatch.setattr(ec, "block_fused",
                        lambda *a, **k: (seen.append(k["precision"]), real(*a, **k))[1])
    with torch.no_grad():
        got = port(*map(torch.as_tensor, batch), block_fuse=True)
    assert seen == [tier] * COMMON["n_layers"]
    for g, r in zip(got, ref):
        assert _share(g.numpy(), r) <= FWD_GATE[tier]


# ---------------------------------------------------------------------------
# egnn_impl: xla
# ---------------------------------------------------------------------------

def _refuse_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on the dense path")
    for fn in ("gcl_message_agg", "coord_update_agg", "block_fused"):
        monkeypatch.setattr(ec, fn, refuse)


@pytest.mark.parametrize("joint", [False, True], ids=["conditional", "joint"])
def test_egnn_impl_xla_against_jax(monkeypatch, joint):
    kw = dict(KWARGS, update_pocket_coords=joint)
    batch = inputs(30)
    jdyn = JaxDynamics(**kw, impl="xla")
    variables = scaled(jdyn.init(jax.random.PRNGKey(3), *map(jnp.asarray, batch)), 3)
    model = EGNNDynamics(**kw, egnn_impl="xla", kernel_block_fuse=True)
    state = state_dict_from_jax({"dynamics": variables})
    model.load_state_dict({k[len(PREFIX):]: torch.tensor(v) for k, v in state.items()},
                          strict=True)
    assert model.dense
    want = jax.jit(jdyn.apply)(variables, *map(jnp.asarray, batch))
    _refuse_kernels(monkeypatch)
    with torch.no_grad():
        got = model(*map(torch.as_tensor, batch), block_fuse=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VALUE_TOL)


@pytest.mark.parametrize("impl", ["egnn_impl", "kernel_bwd"])
def test_xla_impls_loss_terms_against_jax(batches, monkeypatch, impl):  # noqa: F811
    """The module a config with ``tpu.<impl>: xla`` builds, its loss terms
    against JAX's module with the same config (JAX on the CPU runs XLA)."""
    jm, params, pm = both_modules(tiny_overrides(tpu={impl: "xla"}))
    dyn = pm.ddpm.dynamics
    assert (dyn.dense, dyn.mirror_bwd) == ((True, False) if impl == "egnn_impl"
                                           else (False, True))
    if impl == "egnn_impl":
        _refuse_kernels(monkeypatch)
    lig, pkt = batches[0]["ligand"], batches[0]["pocket"]
    rng = jax.random.PRNGKey(12)
    want = jm.ddpm.loss_terms(params, rng, jnp_batch(lig), jnp_batch(pkt), True)
    t_int, noise = jax_draws(rng, lig, A, True)
    feed(pm, [t_int], noise)
    got = pm.ddpm.loss_terms(None, torch_batch(lig), torch_batch(pkt), True)
    for k, w in want.items():
        if isinstance(w, dict):
            continue
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w), err_msg=k,
                                   **LOSS_TOL)


# ---------------------------------------------------------------------------
# kernel_bwd: xla
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gcl_ops():
    return gcl_args(kernel_inputs(3))


@pytest.fixture(scope="module")
def coord_ops():
    return coord_args(kernel_inputs(8), True)


def _linear_grads_jax(fn, ops, cot, **kw):
    def loss(a_row, w2):
        full = list(ops)
        full[0], full[9] = a_row, w2
        return jnp.sum(fn(*full, **kw) * cot)
    return jax.grad(loss, argnums=(0, 1))(ops[0], ops[9])


def _linear_grads_port(fn, ops, cot, **kw):
    full = list(ops)
    full[0] = full[0].clone().requires_grad_(True)
    full[9] = full[9].clone().requires_grad_(True)
    (fn(*full, **kw) * cot).sum().backward()
    return full[0].grad, full[9].grad


def test_mirror_backward_against_jax(gcl_ops, coord_ops):
    """A bf16 forward (plain, at its tier) with ``mirror_bwd``: the gradient
    of a linear loss is the float32 mirror's, JAX's with ``bwd_impl="xla"``
    behind its interpret-mode bf16 kernel; and not the bf16 plain
    backward's."""
    main, cross, gm = coord_ops
    cases = ((ep.gcl_message_agg, ec.gcl_message_agg, gcl_ops, GCL_KW, {}, {}, 3),
             (ep.coord_update_agg, ec.coord_update_agg, main, COORD_KW,
              dict(cross=_jnp(cross), graph_mean=_jnp(gm)),
              dict(cross=_torch(cross), graph_mean=_torch(gm)), 4))
    for fn_jax, fn_port, ops, kw, extra_jax, extra_port, seed in cases:
        jops = list(map(_jnp, ops))
        shape = (2, ops[0].shape[1], 3 if fn_port is ec.coord_update_agg else ops[0].shape[2])
        cot = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        want = _linear_grads_jax(fn_jax, jops, jnp.asarray(cot), **kw, **extra_jax,
                                 impl="pallas", interpret=True, skip_mode="compact",
                                 sub_j=8, mxu_precision="bfloat16", bwd_impl="xla",
                                 d2_0=_d2_0(jops[3]))
        tops = list(map(_torch, ops))
        got = _linear_grads_port(fn_port, tops, torch.as_tensor(cot), **kw, **extra_port,
                                 precision="bf16", mirror_bwd=True)
        kernel_tier = _linear_grads_port(fn_port, tops, torch.as_tensor(cot), **kw,
                                         **extra_port, precision="bf16")
        for g, w, k in zip(got, want, kernel_tier):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL["atol"] * np.abs(w).max(),
                                       rtol=GRAD_TOL["rtol"])
            assert _share(k.numpy(), w) > 10 * _share(g.numpy(), w)


def test_network_kernel_bwd_xla_against_jax():
    """The parameter gradients of sum(eps^2) through the port's network with
    ``kernel_bwd="xla"`` against JAX's with its Pallas kernels in interpret
    mode and ``kernel_bwd="xla"`` (the dense mirror's backward)."""
    kw = dict(KWARGS, update_pocket_coords=False)
    batch = inputs(31)
    jdyn = JaxDynamics(**kw, impl="xla")
    variables = scaled(jdyn.init(jax.random.PRNGKey(4), *map(jnp.asarray, batch)), 4)
    jpal = JaxDynamics(**kw, impl="pallas", interpret=True, kernel_tile=32,
                       kernel_tile_i=8, kernel_sub_j=8, kernel_bwd="xla")

    def loss(v):
        out = jpal.apply(v, *map(jnp.asarray, batch))
        return sum(jnp.sum(o ** 2) for o in out)

    want = state_dict_from_jax({"dynamics": jax.jit(jax.grad(loss))(variables)})
    model = EGNNDynamics(**kw, kernel_bwd="xla")
    state = state_dict_from_jax({"dynamics": variables})
    model.load_state_dict({k[len(PREFIX):]: torch.tensor(v) for k, v in state.items()},
                          strict=True)
    assert model.mirror_bwd and not model.dense
    sum(o.pow(2).sum() for o in model(*map(torch.as_tensor, batch))).backward()
    reached = 0
    for name, p in model.named_parameters():
        w = want[PREFIX + name]
        if p.grad is None:
            assert not np.any(w), name
            continue
        reached += 1
        np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name,
                                   atol=GRAD_TOL["atol"] * max(np.abs(w).max(), 1e-3),
                                   rtol=GRAD_TOL["rtol"])
    assert reached > 20
