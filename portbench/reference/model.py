"""DiffSBDD's EGNN dynamics as plain dense PyTorch.

The network (Schneuing et al., DiffSBDD; the EGNN of Satorras et al. with
EDM's conventions): ligand and pocket features are encoded to ``joint_nf``,
the normalized time is appended, and ``n_layers`` equivariant blocks run over
the ligand-first node set.  A block is one GCL (edge MLP on [h_i, h_j,
d2_ij, d2_0_ij], sigmoid attention, sum over the neighbours / 100, residual
node MLP) and one coordinate update (tanh-bounded MLP on the same input
times the normalized difference, plus the SE(3) cross-product MLP that shares
its head, summed / 100).  Edges join every ligand pair and the pairs within
the pocket and interaction cutoffs of the EGNN's input coordinates;
self-edges count.  The velocity is the coordinate change; the joint model
removes its centre of mass, the conditional model moves the ligand only.

Weights are a dict under DiffSBDD's PyTorch state_dict names
(``ddpm.dynamics.egnn.e_block_0.gcl_0.edge_mlp.0.weight``, (out, in)).
The first layer of each pair MLP is applied as its row and column halves
plus the two distance columns, which is the same sum as the concatenated
input.  Every (B, N, N, F) tensor exists in memory: callers pass small
batches (``chunk``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

DYN = "ddpm.dynamics."


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, to nearest even)."""
    bits = x.float().contiguous().view(torch.int32)
    keep = bits + 0xFFF + ((bits >> 13) & 1)
    return (keep & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and so the products of its
    backward: what a TF32 matrix unit computes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).transpose(-1, -2), tf32(a).transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32, or with both operands rounded to TF32 first."""
    if precision == "tf32":
        if a.dim() > 2:  # (..., K) @ (K, M): one 2-D product
            return _TF32Product.apply(a.reshape(-1, a.shape[-1]), b).reshape(
                *a.shape[:-1], b.shape[-1])
        return _TF32Product.apply(a, b)
    if precision != "f32":
        raise ValueError(precision)
    return a @ b


@dataclasses.dataclass(frozen=True)
class Net:
    """The network's options (a configuration's ``egnn_params``)."""

    n_layers: int
    cutoffs: Tuple[Optional[float], Optional[float], Optional[float]]
    joint: bool  # every node moves and the velocity's CoM is removed
    norm_constant: float = 1.0
    coords_range: float = 15.0
    normalization_factor: float = 100.0
    reflection_equiv: bool = False
    attention: bool = True
    tanh: bool = True

    @classmethod
    def from_config(cls, cfg: Dict, joint: bool) -> "Net":
        e = cfg["egnn_params"]
        if e.get("sin_embedding") or e.get("aggregation_method", "sum") != "sum" \
                or e.get("edge_embedding_dim") is not None or e.get("inv_sublayers", 1) != 1:
            raise ValueError("the reference covers the full-atom presets' EGNN only")
        return cls(n_layers=e["n_layers"],
                   cutoffs=(e["edge_cutoff_ligand"], e["edge_cutoff_pocket"],
                            e["edge_cutoff_interaction"]),
                   joint=joint, norm_constant=float(e["norm_constant"]),
                   normalization_factor=float(e["normalization_factor"]),
                   reflection_equiv=bool(e["reflection_equivariant"]),
                   attention=bool(e["attention"]), tanh=bool(e["tanh"]))


def linear(x, P, name, precision, bias=True):
    y = mm(x, P[name + ".weight"].t(), precision)
    return y + P[name + ".bias"] if bias else y


def mlp2(x, P, name, precision):
    return linear(F.silu(linear(x, P, name + ".0", precision)), P, name + ".2", precision)


def masked_mean(x, mask):
    count = torch.clamp(mask.sum(1), min=1e-12)
    return (x * mask[..., None]).sum(1) / count[..., None]


def sq_dist(x):
    return ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)


def cutoff2(is_lig, cutoffs):
    """(B, N, N) squared cutoff of each pair's type (inf: none)."""
    inf = float("inf")
    c_ll, c_pp, c_lp = ((inf if c is None else float(c)) ** 2 for c in cutoffs)
    both_lig = is_lig[:, :, None] * is_lig[:, None, :]
    both_pkt = (1 - is_lig[:, :, None]) * (1 - is_lig[:, None, :])
    return torch.where(both_lig > 0, c_ll, torch.where(both_pkt > 0, c_pp, c_lp))


def adjacency(d2_0, mask, is_lig, cutoffs, flip=None):
    """(B, N, N) edges: both ends valid and d2_0 within the pair type's
    cutoff (none: every pair); ``flip`` (B, N, N, 0 or 1) toggles pairs."""
    adj = mask[:, :, None] * mask[:, None, :] * (d2_0 <= cutoff2(is_lig, cutoffs)).float()
    return adj if flip is None else adj + flip * (1 - 2 * adj)


def borderline(x0, mask, is_lig, cutoffs, tol: float = 1e-5):
    """(B, N, N) pairs i < j, both valid, whose squared distance (exact in
    float64 from the float32 coordinates) lies within ``tol`` A^2 of their
    cutoff: float32 arithmetic may put them on either side."""
    x = x0.double()
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    near = (d2 - cutoff2(is_lig, cutoffs).double()).abs() <= tol
    valid = mask[:, :, None] * mask[:, None, :] > 0
    return torch.triu(near & valid, diagonal=1)


def pair_pre(P, name, h, d2, d2_0, precision):
    """First layer of a pair MLP on [h_i, h_j, d2_ij, d2_0_ij]: (B, N, N, F)."""
    w = P[name + ".weight"]
    H = h.shape[-1]
    rows = mm(h, w[:, :H].t(), precision)
    cols = mm(h, w[:, H:2 * H].t(), precision)
    return (rows[:, :, None, :] + cols[:, None, :, :] + d2[..., None] * w[:, 2 * H]
            + d2_0[..., None] * w[:, 2 * H + 1] + P[name + ".bias"])


def gcl(P, name, h, d2, d2_0, adj, mask, net: Net, precision):
    m = F.silu(pair_pre(P, name + ".edge_mlp.0", h, d2, d2_0, precision))
    m = F.silu(linear(m, P, name + ".edge_mlp.2", precision))
    if net.attention:
        m = m * torch.sigmoid(linear(m, P, name + ".att_mlp.0", precision))
    agg = (m * adj[..., None]).sum(2) / net.normalization_factor
    upd = mlp2(torch.cat([h, agg], -1), P, name + ".node_mlp", precision)
    return (h + upd) * mask[..., None]


def coord_update(P, name, h, x, d2, d2_0, adj, mask, move, net: Net, precision):
    head = name + ".coord_mlp.4"

    def phi(mlp):
        z = F.silu(pair_pre(P, f"{name}.{mlp}.0", h, d2, d2_0, precision))
        z = F.silu(linear(z, P, f"{name}.{mlp}.2", precision))
        out = linear(z, P, head, precision, bias=False)
        return torch.tanh(out) * net.coords_range if net.tanh else out

    diff = x[:, :, None, :] - x[:, None, :, :]
    trans = diff / (torch.sqrt(d2[..., None] + 1e-8) + net.norm_constant) * phi("coord_mlp")
    if not net.reflection_equiv:
        xc = x - masked_mean(x, mask)[:, None, :]
        a, b = torch.broadcast_tensors(xc[:, :, None, :], xc[:, None, :, :])
        cross = torch.linalg.cross(a, b, dim=-1)
        cross = cross / (torch.sqrt((cross ** 2).sum(-1, keepdim=True) + 1e-8)
                         + net.norm_constant)
        trans = trans + cross * phi("cross_product_mlp")
    agg = (trans * adj[..., None]).sum(2) / net.normalization_factor
    return (x + agg * move[..., None]) * mask[..., None]


def _dynamics(P, net: Net, xh_lig, xh_pkt, t, m_l, m_p, training, precision, flip=None):
    B, NL = m_l.shape
    x = torch.cat([xh_lig[..., :3], xh_pkt[..., :3]], 1)
    mask = torch.cat([m_l, m_p], 1)
    is_lig = torch.cat([torch.ones_like(m_l), torch.zeros_like(m_p)], 1)
    h = torch.cat([mlp2(xh_lig[..., 3:], P, DYN + "atom_encoder", precision),
                   mlp2(xh_pkt[..., 3:], P, DYN + "residue_encoder", precision)], 1)
    h = torch.cat([h, t[:, None, :].expand(B, h.shape[1], 1)], -1)
    d2_0 = sq_dist(x)
    adj = adjacency(d2_0, mask, is_lig, net.cutoffs, flip)
    move = mask if net.joint else is_lig
    h = linear(h, P, DYN + "egnn.embedding", precision)
    x_cur = x
    for i in range(net.n_layers):
        blk = f"{DYN}egnn.e_block_{i}"
        d2 = sq_dist(x_cur)
        h = gcl(P, blk + ".gcl_0", h, d2, d2_0, adj, mask, net, precision)
        x_cur = coord_update(P, blk + ".gcl_equiv", h, x_cur, d2, d2_0, adj, mask, move,
                             net, precision)
        h = h * mask[..., None]
    h = linear(h, P, DYN + "egnn.embedding_out", precision) * mask[..., None]
    vel = (x_cur - x) * mask[..., None]
    if training:
        vel = torch.nan_to_num(vel)
    if net.joint:
        vel = (vel - masked_mean(vel, mask)[:, None, :]) * mask[..., None]
    h = h[..., :-1]
    eps_lig = torch.cat([vel[:, :NL], mlp2(h[:, :NL], P, DYN + "atom_decoder", precision)
                         * m_l[..., None]], -1)
    eps_pkt = torch.cat([vel[:, NL:], mlp2(h[:, NL:], P, DYN + "residue_decoder", precision)
                         * m_p[..., None]], -1)
    return eps_lig, eps_pkt


def dynamics(P, net: Net, xh_lig, xh_pkt, t, m_l, m_p, training=False,
             precision="f32", chunk: int = 4, flip=None):
    """(eps_lig, eps_pkt) of padded inputs, ``chunk`` graphs at a time;
    ``flip``: pairs whose edge is toggled (``adjacency``)."""
    outs = [_dynamics(P, net, xh_lig[i:i + chunk], xh_pkt[i:i + chunk], t[i:i + chunk],
                      m_l[i:i + chunk], m_p[i:i + chunk], training, precision,
                      None if flip is None else flip[i:i + chunk])
            for i in range(0, m_l.shape[0], chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
