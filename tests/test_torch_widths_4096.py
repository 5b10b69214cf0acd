"""Hidden widths 2049-4096 on the two forward split kernels, on the CPU.

On the card ``gcl_agg`` and ``coord_agg`` are built at F = 4096 (each row
tile on a cluster of four blocks), and the wrappers run every width from
2049 up zero-padded onto 4096; the backward kernels and ``block_fused`` stop
at 2048.  Here the same padding goes through the plain versions, which
compute what the kernels do:

* the GCL and the coordinate update (cross branch on) at 3072 (padded onto
  4096, cut back) and at 4096 against the JAX package's dense twins at F
  (``gcl_message_agg_xla``, ``coord_update_agg_xla``): atol 1e-5 + rtol
  1e-4 (float32 on both sides, the pairs summed in another order); the
  padded channels of the GCL sum and of both pair MLPs' messages (every
  tier) exact zeros.

Which kernel runs which width (3072 at 4096 on the two, refused by the
other three; 4160 refused by all) is ``test_torch_kernels.py``'s
``test_kernel_widths``.

B = 1, N = 12 (5 ligand nodes), one numpy seed a width, operands drawn as
``test_torch_widths.make_ops`` draws them (only the two functions' own).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import diffsbdd_tpu.ops.egnn_pallas as ep
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
from test_torch_widths import COORD_KEYS, GCL_KEYS, GCL_KW, COORD_KW, TOL, convert, padded

B, N, NL = 1, 12, 5
WIDTHS = (3072, 4096)
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
