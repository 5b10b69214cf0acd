"""The epsilon-network: encoders + EGNN over the joint ligand/pocket graph.

In the conditional models the pocket coordinates stay fixed
(``update_pocket_coords=False``); in the joint model every node moves and the
velocity field's centre of mass is removed.  The network is conditioned on
time.  Inputs are padded per-domain tensors; the
node axes are concatenated ligand-first inside:
  xh_lig: (B, NL, 3 + atom_nf)      mask_lig: (B, NL)
  xh_pkt: (B, NP, 3 + residue_nf)   mask_pkt: (B, NP)
  t:      (B, 1) normalized time
Returns (eps_lig, eps_pkt) with the same leading shapes.

The network takes the kernels' path unless its configuration asks for what
they do not compute -- the sinusoidal distance embedding, mean aggregation
or ``mode="gnn_dynamics"`` -- or ``egnn_impl="xla"`` names the dense path,
and then the dense path, as the JAX package's ``_resolve_impl`` chooses its
XLA path for exactly these.  ``kernel_bwd="xla"`` keeps the forward kernels
and takes their gradient through the float32 dense mirror instead of the
backward kernels, as the JAX package's does.

Precision, by the JAX package's names (``config.py`` has the mapping):
``matmul_precision`` picks the kernels' tier and, on CUDA, whether the
forward's cuBLAS products outside them (the "glue") run in TF32, set for the
forward alone and restored after it; ``kernel_bwd_precision`` the backward
kernels' tier (None: the forward's); ``compute_dtype="bfloat16"`` the dense
path's pair-MLP type.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from diffsbdd_tpu_torch.config import check_impls, precision_policy
from diffsbdd_tpu_torch.models.egnn import EGNN, GNN, GraphContext
from diffsbdd_tpu_torch.ops.masked import masked_mean
from diffsbdd_tpu_torch.utils.profiling import span


@contextlib.contextmanager
def glue_precision(tf32: bool, cuda: bool):
    """CUDA float32 matrix products in TF32 (or not) inside the block, the
    previous setting restored after it; nothing on the CPU."""
    if not cuda:
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def build_adjacency(x_lig, x_pkt, mask_lig, mask_pkt, cutoff_ligand=None,
                    cutoff_pocket=None, cutoff_interaction=None) -> torch.Tensor:
    """Dense (B, N, N) adjacency over the ligand-first node set: the masks
    times each pair type's test d^2 <= cutoff^2 on these coordinates;
    self-edges are kept."""
    def pair_adj(xa, xb, ma, mb, cutoff):
        adj = ma[:, :, None] * mb[:, None, :]
        if cutoff is not None:
            d2 = ((xa[:, :, None, :] - xb[:, None, :, :]) ** 2).sum(-1)
            adj = adj * (d2 <= cutoff * cutoff).to(adj.dtype)
        return adj

    adj_ll = pair_adj(x_lig, x_lig, mask_lig, mask_lig, cutoff_ligand)
    adj_pp = pair_adj(x_pkt, x_pkt, mask_pkt, mask_pkt, cutoff_pocket)
    adj_lp = pair_adj(x_lig, x_pkt, mask_lig, mask_pkt, cutoff_interaction)
    top = torch.cat([adj_ll, adj_lp], 2)
    bottom = torch.cat([adj_lp.transpose(1, 2), adj_pp], 2)
    return torch.cat([top, bottom], 1)


def _type_edge_attr(is_lig, type_table, is_lig_cols=None) -> torch.Tensor:
    """(B, N, Nc, E) edge-type embedding, 0 = cross, 1 = lig-lig, 2 =
    pkt-pkt, of the columns ``is_lig_cols`` (all when None)."""
    ilc = is_lig if is_lig_cols is None else is_lig_cols
    both_lig = is_lig[:, :, None] * ilc[:, None, :]
    both_pkt = (1 - is_lig[:, :, None]) * (1 - ilc[:, None, :])
    return type_table[(both_lig + 2 * both_pkt).long()]


def _col_adjacency(x, mask, is_lig, cutoffs, ctx: GraphContext):
    """The (B, N, Nc) block of ``build_adjacency``'s output of ``ctx``'s
    columns (all without a shard), built from the concatenated node set, and
    the columns' ligand flags."""
    x_cols, mask_cols, il_cols = ctx.cols(x), ctx.cols(mask), ctx.cols(is_lig)
    d2 = ((x[:, :, None, :] - x_cols[:, None, :, :]) ** 2).sum(-1)
    inf = float("inf")
    c_ll, c_pp, c_lp = ((inf if c is None else c) ** 2 for c in cutoffs)
    both_lig = is_lig[:, :, None] * il_cols[:, None, :]
    both_pkt = (1 - is_lig[:, :, None]) * (1 - il_cols[:, None, :])
    cut2 = torch.where(both_lig > 0, c_ll, torch.where(both_pkt > 0, c_pp, c_lp))
    adj = mask[:, :, None] * mask_cols[:, None, :]
    return adj * (d2 <= cut2).to(adj.dtype), il_cols


def _mlp2(d_in: int, d_mid: int, d_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, d_mid), nn.SiLU(), nn.Linear(d_mid, d_out))


class EGNNDynamics(nn.Module):
    """Predicts (eps_x, eps_h) for ligand and pocket nodes."""

    def __init__(self, atom_nf: int, residue_nf: int, joint_nf: int = 16,
                 hidden_nf: int = 64, n_layers: int = 4,
                 attention: bool = False, tanh: bool = False,
                 norm_constant: float = 0.0, inv_sublayers: int = 2,
                 normalization_factor: float = 100.0,
                 edge_cutoff_ligand: Optional[float] = None,
                 edge_cutoff_pocket: Optional[float] = None,
                 edge_cutoff_interaction: Optional[float] = None,
                 reflection_equivariant: bool = True,
                 edge_embedding_dim: Optional[int] = None,
                 update_pocket_coords: bool = True,
                 kernel_block_fuse: bool = True, mode: str = "egnn_dynamics",
                 sin_embedding: bool = False, aggregation_method: str = "sum",
                 nan_check: bool = False, matmul_precision: str = "float32",
                 kernel_bwd_precision: Optional[str] = None,
                 compute_dtype: str = "float32", egnn_impl: str = "auto",
                 kernel_bwd: str = "auto"):
        super().__init__()
        if mode not in ("egnn_dynamics", "gnn_dynamics"):
            raise ValueError(mode)
        check_impls(egnn_impl, kernel_bwd)
        self.mode = mode
        # the dense path, exactly where the JAX package's _resolve_impl takes
        # its XLA path; otherwise the kernels
        self.dense = sin_embedding or mode != "egnn_dynamics" \
            or aggregation_method != "sum" or egnn_impl == "xla"
        # the split kernels' gradient through the dense mirror
        self.mirror_bwd = kernel_bwd == "xla"
        # the kernels' tiers and the glue's (config.PRECISIONS)
        self.precision, self.bwd_precision, self.tf32_glue, dtype = precision_policy(
            matmul_precision, kernel_bwd_precision, compute_dtype)
        self.compute_dtype = getattr(torch, dtype)
        # the sampling-time check: raise on non-finite velocities (one host
        # sync a forward, so off by default)
        self.nan_check = nan_check
        self.update_pocket_coords = update_pocket_coords
        # allow the whole-block kernel where a caller asks for it (the
        # samplers do); False: always the split kernels
        self.kernel_block_fuse = kernel_block_fuse
        self.inv_sublayers = inv_sublayers
        self.cutoffs = (edge_cutoff_ligand, edge_cutoff_pocket,
                        edge_cutoff_interaction)
        self.atom_encoder = _mlp2(atom_nf, 2 * atom_nf, joint_nf)
        self.atom_decoder = _mlp2(joint_nf, 2 * atom_nf, atom_nf)
        self.residue_encoder = _mlp2(residue_nf, 2 * residue_nf, joint_nf)
        self.residue_decoder = _mlp2(joint_nf, 2 * residue_nf, residue_nf)
        # learnable 3-way edge-type embedding: 0 = cross, 1 = lig-lig,
        # 2 = pkt-pkt
        self.edge_embedding = nn.Embedding(3, edge_embedding_dim) \
            if edge_embedding_dim is not None else None
        dyn_nf = joint_nf + 1  # + the time channel
        if mode == "gnn_dynamics":
            # [x, h] in, [vel, h] out
            self.gnn = GNN(
                in_node_nf=3 + dyn_nf, in_edge_nf=edge_embedding_dim or 0,
                hidden_nf=hidden_nf, out_node_nf=3 + dyn_nf, n_layers=n_layers,
                attention=attention, normalization_factor=normalization_factor,
                aggregation_method=aggregation_method)
        else:
            self.egnn = EGNN(
                in_node_nf=dyn_nf, hidden_nf=hidden_nf, out_node_nf=dyn_nf,
                in_edge_nf=edge_embedding_dim or 0, n_layers=n_layers,
                attention=attention, tanh=tanh, norm_constant=norm_constant,
                inv_sublayers=inv_sublayers,
                normalization_factor=normalization_factor,
                reflection_equiv=reflection_equivariant,
                sin_embedding=sin_embedding, aggregation_method=aggregation_method)

    def forward(self, xh_lig, xh_pkt, t, mask_lig, mask_pkt,
                shared_pocket: bool = False, zero_nan: bool = False,
                block_fuse: bool = False, shard=None):
        """The velocities and type predictions (``_forward``), with the glue
        products at ``matmul_precision``'s tier; a ``network.forward`` span
        (``utils.profiling.span``)."""
        with span("network.forward"), glue_precision(self.tf32_glue, xh_lig.is_cuda):
            return self._forward(xh_lig, xh_pkt, t, mask_lig, mask_pkt,
                                 shared_pocket, zero_nan, block_fuse, shard)

    def _forward(self, xh_lig, xh_pkt, t, mask_lig, mask_pkt,
                 shared_pocket: bool = False, zero_nan: bool = False,
                 block_fuse: bool = False, shard=None):
        """``block_fuse``: run one-GCL blocks as the whole-block kernel (the
        samplers ask for it; it takes effect when ``kernel_block_fuse`` is
        set).  ``shared_pocket``: the batch holds one pocket replicated across
        samples and ``t`` is uniform over the batch, which lets the first GCL
        compute its pocket-pocket aggregation once.  ``zero_nan``: the
        training-time guard -- NaN velocities become zeros (and infinities the
        largest finite values), so one numerical blow-up corrupts a step
        instead of poisoning the parameters.  In the joint model no pocket
        is shared: every node diffuses.  ``shard``: this rank's column block
        under edge-axis sharding (``parallel.edge_shard.ShardContext``; its
        callers go through ``edge_sharded_dynamics``); it turns the shared
        pocket and block fusing off, since both need every column at once.
        The dense path uses neither; ``gnn_dynamics`` raises under a shard,
        as in the JAX package."""
        B, NL = mask_lig.shape
        NP = mask_pkt.shape[1]
        nd = 3
        x_lig, h_lig = xh_lig[..., :nd], xh_lig[..., nd:]
        x_pkt, h_pkt = xh_pkt[..., :nd], xh_pkt[..., nd:]

        h = torch.cat([self.atom_encoder(h_lig), self.residue_encoder(h_pkt)], 1)
        x = torch.cat([x_lig, x_pkt], dim=1)
        mask = torch.cat([mask_lig, mask_pkt], dim=1)
        is_lig = torch.cat([torch.ones_like(mask_lig), torch.zeros_like(mask_pkt)], 1)
        h = torch.cat([h, t[:, None, :].expand(B, NL + NP, 1).to(h.dtype)], -1)

        type_table = None if self.edge_embedding is None \
            else self.edge_embedding.weight
        if self.mode == "gnn_dynamics":
            if shard is not None:
                raise NotImplementedError(
                    "edge-axis sharding supports egnn_dynamics only")
            adj = build_adjacency(x_lig, x_pkt, mask_lig, mask_pkt, *self.cutoffs)
            edge_attr = None if type_table is None else _type_edge_attr(is_lig, type_table)
            out = self.gnn(torch.cat([x, h], -1), adj, mask, edge_attr)
            vel = out[..., :nd] * mask[..., None]
            h_final = out[..., nd:]
        else:
            ctx = GraphContext(
                x0=x, mask=mask, is_lig=is_lig, cutoffs=self.cutoffs,
                type_table=type_table, n_lig=NL,
                update_rows=None if self.update_pocket_coords else NL,
                block_fuse=bool(block_fuse) and self.kernel_block_fuse
                and self.inv_sublayers == 1 and shard is None and not self.dense,
                shard=shard, dense=self.dense, precision=self.precision,
                bwd_precision=self.bwd_precision, mirror_bwd=self.mirror_bwd,
                compute_dtype=self.compute_dtype)
            if self.dense:
                ctx.adj, il_cols = _col_adjacency(x, mask, is_lig, self.cutoffs, ctx)
                if type_table is not None:
                    (table,) = ctx.enter(type_table)
                    ctx.edge_attr = _type_edge_attr(is_lig, table, il_cols)
            h_final, x_final = self.egnn(
                h, x, ctx, shared_pocket=bool(shared_pocket) and not self.update_pocket_coords
                and shard is None and not self.dense)
            vel = (x_final - x) * mask[..., None]
        if zero_nan:
            vel = torch.nan_to_num(vel)
        elif self.nan_check and not bool(torch.isfinite(vel).all()):
            raise ValueError("NaN detected in EGNN output")
        if self.update_pocket_coords:
            # the joint model removes the velocity field's centre of mass
            vel = (vel - masked_mean(vel, mask)[:, None, :]) * mask[..., None]

        h_final = h_final[..., :-1]  # drop the time channel
        h_final_lig = self.atom_decoder(h_final[:, :NL])
        h_final_pkt = self.residue_decoder(h_final[:, NL:])

        eps_lig = torch.cat([vel[:, :NL], h_final_lig * mask_lig[..., None]], -1)
        eps_pkt = torch.cat([vel[:, NL:], h_final_pkt * mask_pkt[..., None]], -1)
        return eps_lig, eps_pkt
