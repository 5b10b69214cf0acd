"""The JAX package's precision policies in the port, against JAX on the CPU.

``tpu.matmul_precision`` picks the split kernels' tier (``config.PRECISIONS``: its
exact and 3-pass names run 3xTF32, ``float32_x2`` 2xTF32, ``bfloat16`` one
bf16 pass), ``tpu.kernel_bwd_precision`` the backward kernels' alone, and
``tpu.compute_dtype: bfloat16`` the dense path's pair MLPs.  On the CPU the
port runs each tier's plain version, which emulates the kernel's rounding.

Tolerances, each beside the figure measured here (B = 2, N = 48, F = 64,
the numpy-seeded operands of ``test_torch_kernels``; a share is the largest
deviation over the reference's largest entry):

* against JAX's exact float32 functions: forward within 5e-4 at 3xTF32
  (JAX's gate for its 3-pass tier, ``tests/test_pallas.py``; measured 4e-7:
  the port's 3xTF32 plain version is float32's product), 2e-3 at 2xTF32
  (JAX has no test of its "float32_x2"; its ~1e-3 relative dots, twice;
  measured 7.3e-4) and 5e-2 at bf16 (JAX's; 9.6e-3), each reduced tier
  also moved at least 1e-5 (2xTF32) or 1.5e-3 (bf16); gradients through a
  ``bwd_precision`` backward within 3e-2 with cosine > 0.999 at bf16 (JAX's,
  ``tests/test_pallas_bwd.py``; 9.7e-3, cosine 0.99999), 5e-3 at 2xTF32
  (1.5e-3) and 5e-4 at 3xTF32 (9e-7);
* the bf16 forward against JAX's interpret-mode kernel at
  ``mxu_precision="bfloat16"``: within 2.5e-3 (1.3e-3, 1.4e-3), and closer to
  it than float32 is (see the test);
* the 3xTF32 default bit for bit the plain versions as they were before the
  tiers (copied below), values and gradients;
* the network at each name against JAX's exact one, within that tier's
  forward gate (bf16 9.7e-5, 2xTF32 5.7e-6, the others 2e-7);
* ``compute_dtype: bfloat16`` on the dense model against JAX's
  ``EGNNDynamics(compute_dtype=jnp.bfloat16)``: eps within 5e-3 (1.2e-3),
  ``loss_terms`` within 5e-3 (9.4e-4); both sides cast at the same points,
  and a bf16 product or sum may round once here and twice there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsbdd_tpu.ops.egnn_pallas as ep
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.models.dynamics import EGNNDynamics as JaxDynamics
from diffsbdd_tpu.ops.egnn_pallas import _PRECISIONS
from diffsbdd_tpu_torch import config as port_config
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.models import dynamics as port_dynamics
from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
from diffsbdd_tpu_torch.train.module import build_module_from_config
from test_torch_dense import KWARGS, PREFIX, inputs, scaled
from test_torch_kernels import (CUTOFFS, _d2_0, _jnp, _torch, coord_args, gcl_args,
                                make_inputs)
from test_torch_train import (A, FIXTURE_NPZ, HIST, batches, both_modules,  # noqa: F401
                              datadir, feed, jax_draws, jnp_batch, tiny_overrides,
                              tiny_train_config, torch_batch)
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_jax

TIERS = ("tf32x3", "tf32x2", "bf16")
# the mapping the port documents (config.py), written out
TIER_OF = {"float32": "tf32x3", "float32_x3": "tf32x3", "tensorfloat32": "tf32x3",
           "float32_x2": "tf32x2", "bfloat16": "bf16"}
FWD_GATE = {"tf32x3": 5e-4, "tf32x2": 2e-3, "bf16": 5e-2}  # x max |ref|
GRAD_GATE = {"tf32x3": 5e-4, "tf32x2": 5e-3, "bf16": 3e-2}
GCL_KW = dict(cutoffs=CUTOFFS, attention=True, normalization_factor=100.0)
COORD_KW = dict(cutoffs=CUTOFFS, tanh=True, coords_range=2.5, norm_constant=1.0,
                normalization_factor=100.0)


@pytest.fixture(scope="module")
def gcl_ops():
    return gcl_args(make_inputs(3))


@pytest.fixture(scope="module")
def coord_ops():
    return coord_args(make_inputs(8), True)


def _share(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cosine(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_config_defaults_and_names_are_jax_s():
    jax_tpu, port_tpu = jax_load_config().tpu, load_config().tpu
    for key in ("matmul_precision", "kernel_bwd_precision", "compute_dtype"):
        assert getattr(port_tpu, key) == getattr(jax_tpu, key), key
    assert set(port_config.PRECISIONS) == set(_PRECISIONS)
    for name in _PRECISIONS:
        cfg = load_config(overrides={"tpu": {"matmul_precision": name,
                                             "kernel_bwd_precision": name}})
        assert cfg.tpu.matmul_precision == name


@pytest.mark.parametrize("key,value", [("matmul_precision", "float16"),
                                       ("matmul_precision", "highest"),
                                       ("kernel_bwd_precision", "bf16"),
                                       ("compute_dtype", "float16")])
def test_unknown_precision_names_raise(key, value):
    with pytest.raises(ValueError, match=key):
        load_config(overrides={"tpu": {key: value}})
    with pytest.raises(ValueError):
        EGNNDynamics(**KWARGS, **{key: value})


@pytest.mark.parametrize("name", sorted(_PRECISIONS))
def test_each_name_reaches_the_network(name):
    cfg = load_config(overrides=tiny_overrides(tpu={"matmul_precision": name,
                                                    "kernel_bwd_precision": "bfloat16"}))
    dyn = build_module_from_config(cfg, HIST).ddpm.dynamics
    assert dyn.precision == TIER_OF[name]
    assert dyn.bwd_precision == "bf16"
    assert dyn.tf32_glue == (name in ("tensorfloat32", "bfloat16"))
    assert dyn.compute_dtype == torch.float32


def test_block_fusing_with_a_reduced_tier_raises():
    """Block fusing at every precision name builds, and the whole-block
    function runs at the name's tier (it raised before the whole-block
    kernel had the reduced tiers); only an unknown name raises."""
    for name in sorted(_PRECISIONS):
        cfg = load_config(overrides=tiny_overrides(
            tpu={"matmul_precision": name, "kernel_block_fuse": True}))
        dyn = build_module_from_config(cfg, HIST).ddpm.dynamics
        assert dyn.kernel_block_fuse and dyn.precision == TIER_OF[name]
    with pytest.raises(ValueError, match="matmul_precision"):
        load_config(overrides=tiny_overrides(
            tpu={"matmul_precision": "bf16", "kernel_block_fuse": True}))


@pytest.mark.parametrize("key", ["egnn_impl", "kernel_bwd"])
def test_implementation_knobs(key):
    """``egnn_impl`` / ``kernel_bwd``: auto and pallas run the kernels; xla
    builds the dense path (``egnn_impl``) or the kernels with the dense
    mirror's backward (``kernel_bwd``), as JAX's xla does; others raise."""
    for impl in ("auto", "pallas", "xla"):
        cfg = load_config(overrides=tiny_overrides(tpu={key: impl}))
        assert getattr(cfg.tpu, key) == impl
        dyn = build_module_from_config(cfg, HIST).ddpm.dynamics
        xla = impl == "xla"
        assert (dyn.dense, dyn.mirror_bwd) == ((xla, False) if key == "egnn_impl"
                                               else (False, xla))
    with pytest.raises(ValueError, match=key):
        load_config(overrides={"tpu": {key: "triton"}})
    with pytest.raises(ValueError, match=key):
        EGNNDynamics(**KWARGS, **{key: "triton"})


def test_checkpoints_carry_the_tiers(tmp_path, datadir):  # noqa: F811
    """A checkpoint's config carries the tiers into ``load_model`` (every CLI),
    the sampling server, and the checkpoints ``cli.train`` writes."""
    import json
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
    from diffsbdd_tpu_torch.cli import serve
    from diffsbdd_tpu_torch.cli import train as train_cli
    tpu = {"matmul_precision": "bfloat16", "kernel_bwd_precision": "float32_x2"}
    ckpt = import_jax_npz(FIXTURE_NPZ, tmp_path / "ckpt", overrides={"tpu": tpu})
    dyn = load_model(ckpt, device="cpu")[0].ddpm.dynamics
    assert (dyn.precision, dyn.bwd_precision, dyn.tf32_glue) == ("bf16", "tf32x2", True)
    assert serve.SamplingServer(ckpt, device="cpu").module.ddpm.dynamics.precision == "bf16"
    cfg = dict(tiny_train_config(datadir, tmp_path / "runs"), tpu=tpu)
    (tmp_path / "train.json").write_text(json.dumps(cfg))
    train_cli.main(["--config", str(tmp_path / "train.json"), "--device", "cpu"])
    trained = load_model(tmp_path / "runs" / cfg["run_name"] / "checkpoints", name="last",
                         device="cpu")[0].ddpm.dynamics
    assert (trained.precision, trained.bwd_precision) == ("bf16", "tf32x2")


def test_glue_precision_is_scoped():
    before = torch.backends.cuda.matmul.allow_tf32
    with port_dynamics.glue_precision(not before, cuda=True):
        assert torch.backends.cuda.matmul.allow_tf32 == (not before)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    with port_dynamics.glue_precision(not before, cuda=False):
        assert torch.backends.cuda.matmul.allow_tf32 == before


# ---------------------------------------------------------------------------
# the plain versions at each tier against JAX
# ---------------------------------------------------------------------------

def test_tier_products():
    """2xTF32 drops the second operand's low part (JAX's "float32_x2": the
    weight's); bf16 rounds both operands to nearest even."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((32, 64)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((64, 16)).astype(np.float32))
    hi = ec.tf32_round(b)
    two = ec.matmul_3xtf32(a, b, passes=2)
    assert torch.equal(two, ec.matmul_3xtf32(a, hi, passes=3))
    assert not torch.equal(two, ec.matmul_3xtf32(a, b, passes=3))
    exact = a.double() @ b.double()
    assert float((two - exact).abs().max()) < 1e-2 * float(exact.abs().max())
    assert torch.equal(ec.matmul_bf16(a, b),
                       a.bfloat16().float() @ b.bfloat16().float())
    x = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)])  # ties
    assert torch.equal(ec.bf16_round(x), torch.tensor([1.0, 1 + 2 ** -6, -1.0]))


# the least a reduced tier moves each output from JAX's exact one: a
# product of another tier in its place reads less (GCL and coordinate:
# 3xTF32 3.7e-7 and 2.0e-7, 2xTF32 7.3e-4 and 2.6e-4, bf16 9.6e-3 and 3.6e-3)
MOVES_AT_LEAST = {"tf32x2": 1e-5, "bf16": 1.5e-3}


@pytest.mark.parametrize("tier", TIERS)
def test_forward_tiers_against_jax_exact(gcl_ops, coord_ops, tier):
    want = ep.gcl_message_agg_xla(*map(_jnp, gcl_ops), **GCL_KW)
    got = ec.gcl_message_agg(*map(_torch, gcl_ops), **GCL_KW, precision=tier)
    shares = [_share(got.numpy(), want)]
    main, cross, gm = coord_ops
    want = ep.coord_update_agg_xla(*map(_jnp, main), **COORD_KW, cross=_jnp(cross),
                                   graph_mean=_jnp(gm))
    got = ec.coord_update_agg(*map(_torch, main), **COORD_KW, cross=_torch(cross),
                              graph_mean=_torch(gm), precision=tier)
    shares.append(_share(got.numpy(), want))
    for share in shares:
        assert share <= FWD_GATE[tier], share
        if tier != "tf32x3":  # a reduced tier, not another tier under its name
            assert share > MOVES_AT_LEAST[tier], share


def _norm_share(got, want):
    """||got - want|| over ||want|| (Frobenius)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_forward_against_jax_interpret_kernel(gcl_ops, coord_ops):
    """JAX's Pallas kernels at ``mxu_precision="bfloat16"`` in interpret mode
    against the port's bf16 plain version, which rounds at the same points
    (``ec._pair_mlp_bf16``): measured 1.3e-3 (GCL) and 1.4e-3 (coordinate) of
    the largest entry apart, where float32 is 8.5e-3 and 3.3e-3 from JAX's
    bf16 kernel; gate 2.5e-3.  By norm the port is 0.17 (GCL) and 0.26
    (coordinate) of float32's distance from JAX's bf16 kernel; gate 1/2."""
    a = list(map(_jnp, gcl_ops))
    want = ep.gcl_message_agg(*a, **GCL_KW, impl="pallas", interpret=True,
                              skip_mode="compact", sub_j=8,
                              mxu_precision="bfloat16", d2_0=_d2_0(a[3]))
    got = ec.gcl_message_agg_plain(*map(_torch, gcl_ops), **GCL_KW, precision="bf16")
    exact = ep.gcl_message_agg_xla(*a, **GCL_KW)
    assert _share(got.numpy(), want) <= 2.5e-3
    assert _norm_share(got.numpy(), want) <= 0.5 * _norm_share(exact, want)
    assert _share(want, exact) > 1e-3  # JAX's interpret kernel does round
    main, cross, gm = coord_ops
    m = list(map(_jnp, main))
    want = ep.coord_update_agg(*m, **COORD_KW, cross=_jnp(cross), graph_mean=_jnp(gm),
                               impl="pallas", interpret=True, skip_mode="compact",
                               sub_j=8, mxu_precision="bfloat16", d2_0=_d2_0(m[3]))
    got = ec.coord_update_agg_plain(*map(_torch, main), **COORD_KW, cross=_torch(cross),
                                    graph_mean=_torch(gm), precision="bf16")
    exact = ep.coord_update_agg_xla(*m, **COORD_KW, cross=_jnp(cross), graph_mean=_jnp(gm))
    assert _share(got.numpy(), want) <= 2.5e-3
    assert _norm_share(got.numpy(), want) <= 0.5 * _norm_share(exact, want)


@pytest.mark.parametrize("tier", ["tf32x2", "bf16"])
def test_tier_gate_refuses_other_arithmetic(gcl_ops, coord_ops, tier):
    """``ec.TIER_GATES``' norm gate (``tier_moved_share``) on what a faulty
    library would compute: float32 (3xTF32) read as the tier, 1.0; on the
    bf16 tier also the bf16 product without the pair MLP's elementwise
    rounding points, measured 1.12 (GCL) and 0.89 (coordinate); the gate is
    0.25.  The tier's own plain version reads 0."""
    gate = ec.TIER_GATES[tier]["moved"]
    ops = list(map(_torch, gcl_ops))
    exact = ec.gcl_message_agg_plain(*ops, **GCL_KW)
    ref = ec.gcl_message_agg_plain(*ops, **GCL_KW, precision=tier)
    assert ec.tier_moved_share(ref, ref, exact) == 0.0
    assert ec.tier_moved_share(exact, ref, exact) == 1.0
    main, cross, gm = coord_ops
    m, extra = list(map(_torch, main)), dict(cross=_torch(cross), graph_mean=_torch(gm))
    c_exact = ec.coord_update_agg_plain(*m, **COORD_KW, **extra)
    c_ref = ec.coord_update_agg_plain(*m, **COORD_KW, **extra, precision=tier)
    assert ec.tier_moved_share(c_exact, c_ref, c_exact) == 1.0
    if tier == "bf16":
        ops[-2] = ec.bf16_round(ops[-2])  # w_att as the kernel reads it
        faulty = ec.gcl_message_agg_plain(*ops, **GCL_KW, matmul=ec.matmul_bf16)
        assert ec.tier_moved_share(faulty, ref, exact) > 2 * gate
        m[-1] = ec.bf16_round(m[-1])  # w3
        extra["cross"] = dict(extra["cross"], w3=m[-1])
        faulty = ec.coord_update_agg_plain(*m, **COORD_KW, **extra, matmul=ec.matmul_bf16)
        assert ec.tier_moved_share(faulty, c_ref, c_exact) > 2 * gate


def _jax_grads(fn, ops, kw, **extra):
    def loss(a_row, w2):
        full = list(ops)
        full[0], full[9] = a_row, w2
        return jnp.sum(fn(*full, **kw, **extra) ** 2)
    return jax.grad(loss, argnums=(0, 1))(ops[0], ops[9])


def _port_grads(fn, ops, kw, **extra):
    full = list(ops)
    full[0] = full[0].clone().requires_grad_(True)
    full[9] = full[9].clone().requires_grad_(True)
    (fn(*full, **kw, **extra) ** 2).sum().backward()
    return full[0].grad, full[9].grad


@pytest.mark.parametrize("tier", TIERS)
def test_backward_tiers_against_jax_exact(gcl_ops, coord_ops, tier):
    """The gradients through a 3xTF32 forward with ``bwd_precision=tier``
    (the plain backward at that tier) against JAX's exact ones, at JAX's gate
    for its bf16 backward (relative 3e-2, cosine > 0.999)."""
    main, cross, gm = coord_ops
    for fn_jax, fn_port, ops, kw, extra_jax, extra_port in (
            (ep.gcl_message_agg_xla, ec.gcl_message_agg, gcl_ops, GCL_KW, {}, {}),
            (ep.coord_update_agg_xla, ec.coord_update_agg, main, COORD_KW,
             dict(cross=_jnp(cross), graph_mean=_jnp(gm)),
             dict(cross=_torch(cross), graph_mean=_torch(gm)))):
        want = _jax_grads(fn_jax, list(map(_jnp, ops)), kw, **extra_jax)
        got = _port_grads(fn_port, list(map(_torch, ops)), kw, bwd_precision=tier,
                          **extra_port)
        for g, w in zip(got, want):
            share = _share(g.numpy(), w)
            assert share <= GRAD_GATE[tier], (fn_port.__name__, share)
            assert _cosine(g.numpy(), np.asarray(w)) > 0.999


# ---------------------------------------------------------------------------
# the default tier: bit for bit the plain versions as they were before tiers
# ---------------------------------------------------------------------------

def _before_gcl(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, type_bias, w2, b2,
                w_att, b_att, *, cutoffs, attention, normalization_factor):
    """``gcl_message_agg_plain`` before the precision tiers, verbatim."""
    silu = torch.nn.functional.silu
    d2 = ec._pair_d2(x)
    d2_0 = ec._pair_d2(x0)
    pre = a_row[:, :, None, :] + a_col[:, None, :, :] + ec._edge_bias_dense(
        d2, d2_0, w_d2, w_d20, is_lig, type_bias)
    m = silu(torch.matmul(silu(pre), w2) + b2)
    if attention:
        m = m * torch.sigmoid(m @ w_att + b_att)
    adj = ec.adjacency_dense(d2_0, mask, is_lig, cutoffs)
    agg = (m * adj[..., None]).sum(2) / normalization_factor
    return ec._keep_rows(agg, None)


def _before_coord(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, type_bias, w2, b2,
                  w3, *, cutoffs, tanh, coords_range, norm_constant,
                  normalization_factor, cross=None, graph_mean=None):
    """``coord_update_agg_plain`` before the precision tiers, verbatim."""
    silu = torch.nn.functional.silu
    d2 = ec._pair_d2(x)
    d2_0 = ec._pair_d2(x0)
    adj = ec.adjacency_dense(d2_0, mask, is_lig, cutoffs)

    def head(r, c, wd2, wd20, tb, w2_, b2_, w3_):
        pre = r[:, :, None, :] + c[:, None, :, :] + ec._edge_bias_dense(
            d2, d2_0, wd2, wd20, is_lig, tb)
        phi = (silu(torch.matmul(silu(pre), w2_) + b2_) @ w3_)[..., 0]
        return torch.tanh(phi) * coords_range if tanh else phi

    phi = head(a_row, a_col, w_d2, w_d20, type_bias, w2, b2, w3)
    diff = x[:, :, None, :] - x[:, None, :, :]
    norm = torch.sqrt(d2 + 1e-8) + norm_constant
    trans = diff / norm[..., None] * phi[..., None]
    if cross is not None:
        phi_c = head(cross["a_row"], cross["a_col"], cross["w_d2"],
                     cross["w_d20"], cross["type_bias"], cross["w2"],
                     cross["b2"], cross["w3"])
        xc = x - graph_mean[:, None, :]
        shape = d2.shape + (3,)
        cr = torch.linalg.cross(xc[:, :, None, :].expand(shape),
                                xc[:, None, :, :].expand(shape), dim=-1)
        cnorm = torch.sqrt((cr ** 2).sum(-1, keepdim=True) + 1e-8) + norm_constant
        trans = trans + cr / cnorm * phi_c[..., None]
    agg = (trans * adj[..., None]).sum(2) / normalization_factor
    return ec._keep_rows(agg, None)


def test_default_tier_is_bitwise_the_untiered_plain_versions(gcl_ops, coord_ops):
    ops = list(map(_torch, gcl_ops))
    want = _before_gcl(*ops, **GCL_KW)
    for got in (ec.gcl_message_agg(*ops, **GCL_KW),
                ec.gcl_message_agg(*ops, **GCL_KW, precision="tf32x3"),
                ec.gcl_message_agg_plain(*ops, **GCL_KW)):
        assert torch.equal(got, want)
    got_g = _port_grads(ec.gcl_message_agg, ops, GCL_KW)
    want_g = _port_grads(_before_gcl, ops, GCL_KW)
    assert all(torch.equal(g, w) for g, w in zip(got_g, want_g))
    main, cross, gm = coord_ops
    m, extra = list(map(_torch, main)), dict(cross=_torch(cross), graph_mean=_torch(gm))
    want = _before_coord(*m, **COORD_KW, **extra)
    assert torch.equal(ec.coord_update_agg(*m, **COORD_KW, **extra), want)
    got_g = _port_grads(ec.coord_update_agg, m, COORD_KW, **extra)
    want_g = _port_grads(_before_coord, m, COORD_KW, **extra)
    assert all(torch.equal(g, w) for g, w in zip(got_g, want_g))


# ---------------------------------------------------------------------------
# the network: every name reaches every kernel call; compute_dtype
# ---------------------------------------------------------------------------

def _kernels_case(seed=0, **knobs):
    """JAX's exact XLA network and the port's (kernels' path, plain versions
    on the CPU) with the same weights and ``knobs``."""
    base = dict(KWARGS, update_pocket_coords=False)
    kw = {**base, "kernel_block_fuse": False, **knobs}
    batch = inputs(seed)
    jdyn = JaxDynamics(**base, impl="xla")
    variables = scaled(jdyn.init(jax.random.PRNGKey(seed), *map(jnp.asarray, batch)), seed)
    model = EGNNDynamics(**kw)
    state = state_dict_from_jax({"dynamics": variables})
    model.load_state_dict({k[len(PREFIX):]: torch.tensor(v) for k, v in state.items()},
                          strict=True)
    return jdyn, variables, model, batch


@pytest.mark.parametrize("name", sorted(_PRECISIONS))
def test_network_at_each_name_against_jax(monkeypatch, name):
    """Every split-kernel call of a forward and its backward gets the name's
    tier (the backward ``kernel_bwd_precision``'s: bfloat16), and eps stays
    within the tier's gate of JAX's exact network."""
    jdyn, variables, model, batch = _kernels_case(
        matmul_precision=name, kernel_bwd_precision="bfloat16")
    assert not model.dense
    seen = []
    for fn in ("gcl_message_agg", "coord_update_agg"):
        real = getattr(ec, fn)

        def spy(*a, _real=real, _fn=fn, **k):
            seen.append((_fn, k["precision"], k["bwd_precision"]))
            return _real(*a, **k)
        monkeypatch.setattr(ec, fn, spy)
    want = jax.jit(jdyn.apply)(variables, *map(jnp.asarray, batch))
    got = model(*map(torch.as_tensor, batch))
    assert {s[0] for s in seen} == {"gcl_message_agg", "coord_update_agg"}
    assert set(s[1:] for s in seen) == {(TIER_OF[name], "bf16")}
    tier = TIER_OF[name]
    for g, w in zip(got, want):
        share = _share(g.detach().numpy(), w)
        assert share <= FWD_GATE[tier], share
    sum(e.pow(2).sum() for e in got).backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


def _dense_case(seed=0):
    kw = dict(KWARGS, sin_embedding=True, aggregation_method="mean",
              update_pocket_coords=False)
    batch = inputs(seed)
    jdyn = JaxDynamics(**kw, impl="xla", compute_dtype=jnp.bfloat16)
    variables = scaled(jdyn.init(jax.random.PRNGKey(seed), *map(jnp.asarray, batch)), seed)
    model = EGNNDynamics(**kw, compute_dtype="bfloat16", kernel_block_fuse=False)
    state = state_dict_from_jax({"dynamics": variables})
    model.load_state_dict({k[len(PREFIX):]: torch.tensor(v) for k, v in state.items()},
                          strict=True)
    return jdyn, variables, model, batch


def test_dense_bf16_eps_against_jax():
    jdyn, variables, model, batch = _dense_case()
    assert model.dense and model.compute_dtype == torch.bfloat16
    want = jax.jit(jdyn.apply)(variables, *map(jnp.asarray, batch))
    exact = jax.jit(JaxDynamics(**dict(KWARGS, sin_embedding=True, aggregation_method="mean",
                                       update_pocket_coords=False), impl="xla").apply)(
        variables, *map(jnp.asarray, batch))
    with torch.no_grad():
        got = model(*map(torch.as_tensor, batch))
    for g, w, e in zip(got, want, exact):
        assert g.dtype == torch.float32
        assert _share(g.numpy(), w) <= 5e-3
        assert _share(w, e) > 1e-5  # JAX's bf16 network is not its f32 one


DENSE_BF16 = dict(egnn_params=dict(sin_embedding=True, aggregation_method="mean"),
                  tpu=dict(compute_dtype="bfloat16"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def test_dense_bf16_loss_terms_against_jax(batches):  # noqa: F811
    training = True
    jm, params, pm = both_modules(tiny_overrides(**DENSE_BF16))
    assert pm.ddpm.dynamics.compute_dtype == torch.bfloat16
    lig, pkt = batches[0]["ligand"], batches[0]["pocket"]
    rng = jax.random.PRNGKey(11)
    want = jm.ddpm.loss_terms(params, rng, jnp_batch(lig), jnp_batch(pkt), training)
    t_int, noise = jax_draws(rng, lig, A, training)
    feed(pm, [t_int], noise)
    with torch.no_grad():
        got = pm.ddpm.loss_terms(None, torch_batch(lig), torch_batch(pkt), training)
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-3)
        assert float(np.abs(got[k] - want[k]).max()) <= 5e-3 * scale, k
