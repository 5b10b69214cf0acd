"""Hidden widths 2049-4096 on the five kernels, on the CPU.

On the card ``gcl_agg``, ``coord_agg``, their backward kernels and
``block_fused`` are built at F = 4096 (each row tile on a cluster of four
blocks), and the wrappers run every width from 2049 up zero-padded onto
4096.  Here the same padding goes through the plain versions, which
compute what the kernels do:

* the GCL and the coordinate update (cross branch on) at 3072 (padded onto
  4096, cut back) and at 4096 against the JAX package's dense twins at F
  (``gcl_message_agg_xla``, ``coord_update_agg_xla``): atol 1e-5 + rtol
  1e-4 (float32 on both sides, the pairs summed in another order); the
  padded channels of the GCL sum and of both pair MLPs' messages (every
  tier) exact zeros;
* the whole block (cross head on, odd ``update_rows``) at 3072 (padded onto
  4096, cut back) and at 4096 against ``block_fused_xla`` at F, as
  ``test_torch_widths.py``'s 2048 case: atol 1e-5 + rtol 1e-4, the dx rows
  below ``update_rows`` (JAX keeps whole row tiles); the padded channels of
  h_new and the port's dx rows at and above ``update_rows`` exact zeros;
* the backward plain versions at 3072 (padded onto 4096, cut back) and at
  4096 against ``jax.vjp`` of the same twins: atol 1e-4, rtol 1e-3, as
  ``test_torch_widths.py``'s 2048 case (each cotangent sums up to B*N*N
  pair terms in another order); the padded channels' cotangents exact
  zeros;
* the slice as a whole: the conditional model's loss gradients at hidden
  4096 (one EGNN layer, one complex) against JAX's, within 1e-3 of each
  gradient's largest entry, as ``test_torch_train.py``'s
  ``test_loss_gradients_match_jax``.

Which kernel runs which width (2112, 3072 and 4096 at 4096 on all five;
4160 refused by all) is ``test_torch_kernels.py``'s ``test_kernel_widths``.

B = 1, N = 12 (5 ligand nodes), one numpy seed a width, operands drawn as
``test_torch_widths.make_ops`` draws them (the split functions' own; the
whole block's others from a second seed, ``block_ops``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import diffsbdd_tpu.ops.egnn_pallas as ep
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_jax
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
import test_torch_train as tt
from test_torch_train import batches, datadir  # noqa: F401  (fixtures)
from test_torch_widths import (COORD_KEYS, GCL_KEYS, GCL_KW, COORD_KW, TOL, _delta_tables,
                               _jax_fns, _jax_vjp, _port_bwd, assert_cotangents_close,
                               block, convert, padded)

B, N, NL = 1, 12, 5
WIDTHS = (3072, 4096)
UPDATE_ROWS = 9  # odd, below N
KERNEL = dict(gcl="gcl_agg", coord="coord_agg")


def wide_ops(F, seed):
    """The operands of the GCL and the coordinate update at width F, as
    numpy arrays (``test_torch_widths.make_ops``' distributions)."""
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

    ops = dict(mlp(), x=x, x0=x + nrm(B, N, 3, scale=0.1), mask=mask,
               is_lig=np.broadcast_to((np.arange(N) < NL).astype(np.float32), (B, N)).copy(),
               w_att=nrm(F, 1, scale=s), b_att=nrm(1, scale=0.1), cross=mlp())
    ops["graph_mean"] = ((x * mask[..., None]).sum(1) / mask.sum(1)[:, None]).astype(np.float32)
    return ops


@functools.lru_cache(maxsize=None)
def _ops(F):
    return wide_ops(F, seed=F)


def gcl(ops, **kw):
    return ec.gcl_message_agg_plain(*(ops[k] for k in GCL_KEYS), **GCL_KW, **kw)


def coord(ops, **kw):
    return ec.coord_update_agg_plain(*(ops[k] for k in COORD_KEYS), **COORD_KW,
                                     cross=ops["cross"], graph_mean=ops["graph_mean"], **kw)


PORT = dict(gcl=gcl, coord=coord)
JAX = dict(
    gcl=lambda o: ep.gcl_message_agg_xla(*(o[k] for k in GCL_KEYS), **GCL_KW),
    coord=lambda o: ep.coord_update_agg_xla(*(o[k] for k in COORD_KEYS), **COORD_KW,
                                            cross=o["cross"], graph_mean=o["graph_mean"]))


@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("name", list(PORT))
def test_plain_at_4096_matches_jax(name, F):
    """The plain version as the card's wrapper runs it (padded onto 4096,
    the output cut back) against JAX's dense twin at F; the padded channels
    of the GCL sum exact zeros."""
    ops = _ops(F)
    assert ec.padded_width(F, kernel=KERNEL[name]) == 4096
    got, full = padded(PORT[name], convert(ops, torch.as_tensor), F)
    ref = jax.jit(JAX[name])(convert(ops, jax.numpy.asarray))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if name == "gcl":
        assert full[0].shape[-1] == 4096
        assert not full[0][..., F:].any()


@functools.lru_cache(maxsize=None)
def block_ops(F):
    """The whole block's operands at width F, keyed as
    ``test_torch_widths.make_ops``' (``block`` reads them): the GCL's and the
    graph mean from ``_ops(F)``; h, the edge-type delta, the node MLP and
    both heads (the coordinate head's w1 the cross MLP's W2) drawn from a
    second seed."""
    ops = _ops(F)
    rng = np.random.default_rng(F + 2)
    nrm = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    s = F ** -0.5

    def head(w1):
        return dict(k_i=nrm(F, F, scale=s), k_j=nrm(F, F, scale=s), b0=nrm(F, scale=0.1),
                    w_d2=nrm(F, scale=0.05), w_d20=nrm(F, scale=0.05),
                    type_bias=nrm(2, 2, F, scale=0.2), w1=w1, b1=nrm(F, scale=0.1),
                    w3=ops["w3"])

    gcl = dict(w_d2=ops["w_d2"], w_d20=ops["w_d20"], type_delta=nrm(F, scale=0.2),
               w2=ops["w2"], b2=ops["b2"], w_att=ops["w_att"], b_att=ops["b_att"])
    node = dict(w_h=nrm(F, F, scale=s), w_a=nrm(F, F, scale=s), b0=nrm(F, scale=0.1),
                w2=nrm(F, F, scale=s), b2=nrm(F, scale=0.1))
    return dict(ops, h=nrm(B, N, F, scale=0.5), gcl=gcl, node=node,
                coord=head(ops["cross"]["w2"]), block_cross=head(nrm(F, F, scale=s)))


@pytest.mark.parametrize("F", WIDTHS)
def test_block_plain_at_4096_matches_jax(F):
    """The whole block as the card's wrapper runs it at F = 4096 (3072
    zero-padded onto it, the outputs cut back), the cross head on and
    ``update_rows`` odd, against the JAX package's ``block_fused_xla`` at F
    (the dx rows below ``update_rows``: JAX keeps whole row tiles); the
    padded channels of h_new and the port's dx rows at and above
    ``update_rows`` exact zeros."""
    ops = block_ops(F)
    assert ec.padded_width(F, kernel="block_fused") == 4096
    (h_new, dx), (full_h, _) = padded(block, convert(ops, torch.as_tensor), F,
                                      update_rows=UPDATE_ROWS)
    ref_h, ref_dx = _jax_fns()["block"](convert(ops, jax.numpy.asarray),
                                       update_rows=UPDATE_ROWS)
    np.testing.assert_allclose(h_new.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(dx.numpy()[:, :UPDATE_ROWS],
                               np.asarray(ref_dx)[:, :UPDATE_ROWS], **TOL)
    assert full_h.shape[-1] == 4096 and not full_h[..., F:].any()
    assert not dx[:, UPDATE_ROWS:].any()


def test_padded_pair_messages_at_3072_are_exact_zeros():
    """Both pair MLPs' messages at 3072 padded onto 4096: the padded
    channels exact zeros at every tier."""
    F = 3072
    ops = ec.pad_operands(convert(_ops(F), torch.as_tensor), F, 4096)
    d2, d2_0 = ec._pair_d2(ops["x"]), ec._pair_d2(ops["x0"])
    for tier in ec.TIERS:
        for m in (ops, ops["cross"]):
            msg = ec._pair_mlp_plain(m["a_row"], m["a_col"], d2, d2_0, ops["is_lig"],
                                     m["w_d2"], m["w_d20"], m["type_bias"], m["w2"], m["b2"],
                                     matmul=torch.matmul, precision=tier)
            assert msg.shape[-1] == 4096 and not msg[..., F:].any(), tier


@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("name", ["gcl", "coord"])
def test_backward_plain_at_4096_matches_jax_vjp(name, F):
    """The backward plain versions as the card's backward wrappers run them
    at F = 4096 (3072 padded onto it, the cotangents cut back) against
    ``jax.vjp`` of JAX's dense twins at F: the GCL with attention, an
    edge-type delta, a column mask (the first half of the columns) and
    update_rows; the coordinate update with the cross branch, tanh, the
    deltas and update_rows.  Every cotangent within atol 1e-4, rtol 1e-3;
    the padded channels' exact zeros."""
    ops = _delta_tables(_ops(F))
    ops["col_mask"] = ops["mask"] * (np.arange(N) < N // 2)
    rng = np.random.default_rng(F + 1)
    g = rng.standard_normal((B, N, F if name == "gcl" else 3)).astype(np.float32)
    g[:, UPDATE_ROWS:] = 0.0  # rows past update_rows carry no cotangent
    assert_cotangents_close(name, _port_bwd(name, ops, g, F, 4096, UPDATE_ROWS),
                            _jax_vjp(name, ops, g, UPDATE_ROWS))


def seeded_params(overrides, seed=0):
    """Random weights of the JAX model of ``overrides``, drawn with numpy
    into its parameter tree (the shapes from ``jax.eval_shape`` of its init:
    at hidden 4096 the init's own draws and forward pass take most of a
    test's time): kernels N(0, 1 / fan_in), the coordinate heads' last ones
    1e-3 of that (as JAX's init scales them down), biases N(0, 0.1^2)."""
    jm = tt.jax_build(tt.jax_load_config(overrides=overrides), tt.HIST)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        scale = (leaf.shape[0] ** -0.5 * (1e-3 if "gcl_equiv" in name and "lin2" in name else 1.0)
                 if name.endswith("kernel']") else 0.1)
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), batch_size=2))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def one_complex(part):
    """The first complex of a padded batch part, its padding cut to its size
    (the masks hold its nodes first)."""
    n = int(part["mask"][0].sum())
    return {k: v[:1, :n] if v.ndim > 1 else v[:1] for k, v in part.items()}


def test_hidden_4096_loss_gradients_match_jax(batches):  # noqa: F811
    """The slice as a whole: the gradient of the conditional model's
    training loss at hidden 4096 (one EGNN layer; seeded random weights,
    ``seeded_params``, carried across by ``state_dict_from_jax``), on the
    first complex of the training batches (its padding cut), against JAX's,
    parameter by parameter: within 1e-3 of each gradient's largest entry, as
    ``test_loss_gradients_match_jax`` (float32 forward and backward, sums in
    another order).  On the card the same step runs every split kernel at
    F = 4096."""
    over = tt.tiny_overrides(egnn_params=dict(hidden_nf=4096))
    jm, params, pm = tt.both_modules(over, seeded_params(over))
    lig, pkt = (one_complex(batches[0][part]) for part in ("ligand", "pocket"))
    rng = jax.random.PRNGKey(11)
    grads = jax.jit(jax.grad(lambda p: jm.loss_fn(
        p, rng, tt.jnp_batch(lig), tt.jnp_batch(pkt), True)[0]))(params)
    want = state_dict_from_jax(grads)
    t_int, noise = tt.jax_draws(rng, lig, tt.A, True)
    tt.feed(pm, [t_int], noise)
    loss, _ = pm.loss_fn(None, tt.torch_batch(lig), tt.torch_batch(pkt), True)
    names, tensors = zip(*pm.named_parameters())
    assert any(4096 in t.shape for t in tensors)
    got = torch.autograd.grad(loss, tensors, allow_unused=True)
    reached = 0
    for name, g in zip(names, got):
        if g is None:  # the pocket decoder: the conditional loss never reads it
            assert not want[name].any(), name
            continue
        reached += 1
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-3 * scale + 1e-7,
                                   rtol=0, err_msg=name)
    assert reached > 20, reached
