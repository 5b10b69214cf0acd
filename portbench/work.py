"""Operations and bytes of the port's EGNN kernels and of the model, from
the shapes of each launch and the pairs inside the cutoffs in its inputs.

The kernel counts are those of ``chip_smoke.py``'s ``work_bounds`` and
``bwd_work``: a forward pair MLP costs 2F^2 + 10F operations an active pair
(its F x F product, the first layer's adds, silu, the attention or head
dot), a backward one 6F^2 + 30F (the recomputed forward, dW2 and the
cotangent through W2); each input byte is read once and each output byte
written once.  The least time of a launch is max(3 x ops / TF32 peak,
bytes / HBM peak): the 3xTF32 bound.

The model's operations count each product of the network once (two a
multiply-add): the pair MLPs' F x F products and dots at the pairs inside
the cutoffs that the launches computed, and the per-node products (encoders, embeddings, the
pair MLPs' first-layer projections, the node MLPs, decoders) from the valid
nodes; a training step adds the backward's two products for each forward one.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench import peaks


@dataclass
class Launch:
    kernel: str   # gcl_agg, coord_agg, gcl_agg_bwd, coord_agg_bwd
    B: int
    N: int
    F: int
    rows_out: int  # rows written (update_rows, or N)
    n_mlp: int     # pair MLPs a pair: 1 (GCL), 2 (coordinate + cross)
    pairs: int

    def flops(self) -> float:
        per = 6 * self.F ** 2 + 30 * self.F if self.kernel.endswith("_bwd") \
            else 2 * self.F ** 2 + 10 * self.F
        return float(self.pairs) * self.n_mlp * per

    def bytes(self) -> float:
        B, N, F = self.B, self.N, self.F
        width = F if self.kernel.startswith("gcl") else 3
        if self.kernel.endswith("_bwd"):
            return 4.0 * (self.n_mlp * (4 * B * N * F + 3 * F * F + 12 * F) + B * N * 17
                          + B * N * width)
        return 4.0 * (self.n_mlp * (2 * B * N * F + F * F + 4 * F) + B * N * 11
                      + B * self.rows_out * width)

    def least_s(self) -> float:
        return max(3 * self.flops() / peaks.TF32_FLOPS, self.bytes() / peaks.HBM_BYTES)


def count_pairs(x0, mask, col_mask, is_lig, cutoffs, update_rows=None) -> torch.Tensor:
    """Pairs (row, column) with both ends valid and d2(x0) within the pair
    type's cutoff, over the rows below ``update_rows``: a 0-d tensor."""
    rows = x0.shape[1] if update_rows is None else int(update_rows)
    xr = x0[:, :rows]
    d2 = ((xr[:, :, None, :] - x0[:, None, :, :]) ** 2).sum(-1)
    inf = float("inf")
    c_ll, c_pp, c_lp = ((inf if c is None else float(c)) ** 2 for c in cutoffs)
    il_r, il_c = is_lig[:, :rows, None], is_lig[:, None, :]
    cut2 = torch.where((il_r * il_c) > 0, c_ll,
                       torch.where(((1 - il_r) * (1 - il_c)) > 0, c_pp, c_lp))
    cols = mask if col_mask is None else col_mask
    return (mask[:, :rows, None] * cols[:, None, :] * (d2 <= cut2)).sum()


def node_flops(n_nodes: float, n_lig: float, n_pkt: float, atom_nf: int, residue_nf: int,
               joint_nf: int, F: int, n_layers: int, cross: bool = True) -> float:
    """A forward pass's per-node products: encoders and decoders, the
    EGNN's embeddings, per layer the GCL's two first-layer projections, its
    node MLP (2F x F, F x F) and each coordinate MLP's two projections."""
    enc = n_lig * 2 * (atom_nf * 2 * atom_nf + 2 * atom_nf * joint_nf) \
        + n_pkt * 2 * (residue_nf * 2 * residue_nf + 2 * residue_nf * joint_nf)
    dec = n_lig * 2 * (joint_nf * 2 * atom_nf + 2 * atom_nf * atom_nf) \
        + n_pkt * 2 * (joint_nf * 2 * residue_nf + 2 * residue_nf * residue_nf)
    emb = n_nodes * 2 * 2 * (joint_nf + 1) * F
    heads = 2 if cross else 1
    layer = n_nodes * 2 * (2 * F * F + 3 * F * F + heads * 2 * F * F)
    return enc + dec + emb + n_layers * layer


def pair_flops(launch: Launch) -> float:
    """The model's products in a forward launch's pair MLPs: the F x F
    product and the attention or head dot, an active pair and MLP."""
    return float(launch.pairs) * launch.n_mlp * (2 * launch.F ** 2 + 2 * launch.F)
