"""Dense masked SE(3)-equivariant GNN over padded ligand-pocket graphs.

Graphs are padded to ``(B, N, .)`` with a node mask; nodes are ligand-first.
Every pairwise MLP's first layer is split into per-node row/column
projections (``split_first_layer``), so only the genuinely pairwise F x F
work runs at O(N^2), and that work runs in the kernels of
``ops/egnn_cuda.py`` (their plain twins on the CPU), which rebuild the
adjacency from the EGNN input coordinates and the distance cutoffs.  A block
with one GCL can run as one whole-block kernel (``GraphContext.block_fuse``,
set on the sampling path); training keeps the split kernels and their
backward kernels.  Under edge-axis sharding (``GraphContext.shard``, see
``parallel/edge_shard.py``) each aggregation runs on this rank's column
block and sums the blocks over the rank's group.

The model variants the kernels do not compute -- the sinusoidal distance
embedding, mean aggregation and the non-equivariant ``GNN`` -- take the
dense path (``GraphContext.dense``), as the JAX package takes its XLA path
for them: the (B, N, N) adjacency and the (B, N, N, .) edge features and
messages in memory, plain ``torch`` products, no kernel.

Precision: ``GraphContext.precision`` / ``bwd_precision`` are the kernels'
tiers (``ops.egnn_cuda.TIERS``) at every call, the whole-block kernel's
included; ``GraphContext.mirror_bwd`` takes the split kernels' gradient
through their float32 dense mirror instead of the backward kernels; on the
dense path
``GraphContext.compute_dtype`` (bfloat16) keeps the EGNN's pair MLPs and
their (B, N, N, .) messages in that type and sums them over the columns in
float32, at the JAX package's casts (its ``compute_dtype``).  ``GNN`` stays
in float32, as the JAX package's does.

Module and parameter names follow the reference PyTorch state_dict
(``egnn.e_block_0.gcl_0.edge_mlp.0.weight``, ``gnn.gcl_0.edge_mlp.0.weight``
...).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffsbdd_tpu_torch.ops import egnn_cuda as kernels
from diffsbdd_tpu_torch.ops.masked import masked_mean


@dataclasses.dataclass
class GraphContext:
    """Per-forward graph data shared by every layer of the EGNN."""

    x0: torch.Tensor        # (B, N, 3) EGNN input coordinates: d2_0 + adjacency
    mask: torch.Tensor      # (B, N)
    is_lig: torch.Tensor    # (B, N)
    cutoffs: Tuple[Optional[float], Optional[float], Optional[float]]
    type_table: Optional[torch.Tensor]  # (3, E) edge-type embedding or None
    n_lig: int  # ligand rows lead the node axis
    # rows below update_rows move (the conditional models freeze the pocket:
    # update_rows = n_lig); None in the joint model, where every node moves
    update_rows: Optional[int] = None
    block_fuse: bool = False  # one-GCL blocks run as the whole-block kernel
    # edge-axis sharding: a parallel.edge_shard.ShardContext (this rank's
    # column block and its group), or None
    shard: Optional[object] = None
    # the kernels' precision tiers (ops.egnn_cuda.TIERS): the forward
    # kernels' (the whole-block kernel's too), and the backward kernels'
    # (None: the forward's)
    precision: str = kernels.DEFAULT_TIER
    bwd_precision: Optional[str] = None
    # the split kernels' gradient through the float32 dense mirror instead of
    # the backward kernels (the JAX package's kernel_bwd: xla)
    mirror_bwd: bool = False
    # the dense path's pair-MLP type (torch.bfloat16 or torch.float32)
    compute_dtype: torch.dtype = torch.float32

    # the dense path: the adjacency (B, N, Nc) and the edge-type features
    # (B, N, Nc, E) or None of the columns this rank owns (all N without a
    # shard), and the EGNN's input-coordinate edge features (set by EGNN)
    dense: bool = False
    adj: Optional[torch.Tensor] = None
    edge_attr: Optional[torch.Tensor] = None
    edge_feat0: Optional[torch.Tensor] = None

    @property
    def update_coords_mask(self) -> Optional[torch.Tensor]:
        return None if self.update_rows is None else self.is_lig

    @property
    def kernel_opts(self) -> dict:
        """The precision and backward keywords of every split-kernel call."""
        return dict(precision=self.precision, bwd_precision=self.bwd_precision,
                    mirror_bwd=self.mirror_bwd)

    def enter(self, *tensors):
        """Replicated tensors about to feed this rank's share of a column
        sum (the identity without a shard)."""
        return tensors if self.shard is None else self.shard.enter(*tensors)

    def leave(self, share: torch.Tensor) -> torch.Tensor:
        """This rank's share of a column sum -> the sum over the group."""
        return share if self.shard is None else self.shard.leave(share)

    def cols(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's columns of the node axis 1 of ``t``."""
        return t if self.shard is None else t[:, self.shard.lo:self.shard.hi]


SIN_EMB_MAX_RES = 15.0
SIN_EMB_MIN_RES = 15.0 / 2000.0
SIN_EMB_DIV = 4


def n_sin_frequencies() -> int:
    return int(math.log(SIN_EMB_MAX_RES / SIN_EMB_MIN_RES, SIN_EMB_DIV)) + 1


def sin_embedding_dim() -> int:
    return 2 * n_sin_frequencies()


def sinusoidal_distance_embedding(radial: torch.Tensor) -> torch.Tensor:
    """Fourier features of the edge distance from the squared distance
    (..., 1) -> (..., 2 n); no gradient flows through them, as in the JAX
    package (``stop_gradient``)."""
    n = n_sin_frequencies()
    freqs = 2 * math.pi * (SIN_EMB_DIV ** torch.arange(
        n, dtype=radial.dtype, device=radial.device)) / SIN_EMB_MAX_RES
    emb = torch.sqrt(radial + 1e-8) * freqs
    return torch.cat([torch.sin(emb), torch.cos(emb)], -1).detach()


def coord2diff(x, norm_constant: float = 1.0, x_cols=None):
    """Squared distances (B, N, Nc, 1) and normalized differences (B, N, Nc,
    3), (x_i - x_j) / (|x_i - x_j| + norm_constant), of rows ``x`` (B, N, 3)
    against columns ``x_cols`` (all of ``x`` when None)."""
    diff = x[:, :, None, :] - (x if x_cols is None else x_cols)[:, None, :, :]
    radial = (diff ** 2).sum(-1, keepdim=True)
    return radial, diff / (torch.sqrt(radial + 1e-8) + norm_constant)


def coord2cross(x, node_mask, norm_constant: float = 1.0, x_cols=None):
    """Normalized cross products (B, N, Nc, 3) of the coordinates about the
    graph's masked centre of mass (over every node, whatever the columns).
    The norm is sqrt(. + 1e-8): the cross product is zero on the diagonal."""
    count = torch.clamp(node_mask.sum(1, keepdim=True), min=1e-12)
    mean = (x * node_mask[..., None]).sum(1, keepdim=True) / count[..., None]
    xc = x - mean
    xc_cols = xc if x_cols is None else x_cols - mean
    a, b = torch.broadcast_tensors(xc[:, :, None, :], xc_cols[:, None, :, :])
    cross = torch.linalg.cross(a, b, dim=-1)
    norm = torch.sqrt((cross ** 2).sum(-1, keepdim=True) + 1e-8)
    return cross / (norm + norm_constant)


def split_pair_dense(weight, bias, h, edge_feat, node_dim: int, ctx=None):
    """First layer of a pairwise MLP on the dense path: (B, N, Nc, F)
    pre-activations of [h_i, h_j, edge_feat_ij] from the per-node row and
    column projections of the (F, 2 node_dim + E) ``weight``; the columns
    are ``ctx``'s (all without a context).  ``edge_feat`` may be None (no
    edge features)."""
    a_i = h @ weight[:, :node_dim].t()
    a_j = h @ weight[:, node_dim:2 * node_dim].t()
    if ctx is not None:
        a_j = ctx.cols(a_j)
    pre = a_i[:, :, None, :] + a_j[:, None, :, :]
    if edge_feat is not None and weight.shape[1] > 2 * node_dim:
        pre = pre + edge_feat @ weight[:, 2 * node_dim:].t()
    return pre + bias


def pair_sum(m, adj):
    """sum_j m_ij adj_ij (B, N, F) in float32, of messages m (B, N, Nc, F) in
    float32 or bfloat16 (adj is 0 or 1: the bf16 products are exact, the sum
    accumulates in float32, as the JAX package's einsum with
    ``preferred_element_type=float32``)."""
    if m.dtype == torch.float32:
        return torch.einsum("bijf,bij->bif", m, adj)
    return (m * adj.to(m.dtype)[..., None]).sum(2, dtype=torch.float32)


def dense_aggregate(num, adj, method: str, normalization_factor: float, ctx=None):
    """Complete a row sum ``num`` (B, N, D) over the columns (one
    ``all_reduce`` under a shard) and normalize it: by the factor ("sum") or
    by the row's edge count, at least 1 ("mean", its own ``all_reduce``)."""
    leave = (lambda t: t) if ctx is None else ctx.leave
    num = leave(num)
    if method == "sum":
        return num / normalization_factor
    if method == "mean":
        denom = leave(adj.sum(2))
        return num / torch.clamp(denom, min=1.0)[..., None]
    raise ValueError(method)


def split_first_layer(linear: nn.Linear, h: torch.Tensor):
    """Per-node row/col projections of a pairwise first layer whose input is
    [h_i, h_j, d2_ij, d2_0_ij, edge_type_emb_ij] (bias folded into the rows).
    Returns a_row, a_col (B, N, F), the two distance-feature rows (F,) and the
    edge-type rows (E, F) or None."""
    H = h.shape[-1]
    w, b = linear.weight, linear.bias  # (F, 2H + 2 + E)
    a_row = F.linear(h, w[:, :H], b)
    a_col = F.linear(h, w[:, H:2 * H])
    w_types = w[:, 2 * H + 2:].t() if w.shape[1] > 2 * H + 2 else None
    return (a_row, a_col, w[:, 2 * H].contiguous(),
            w[:, 2 * H + 1].contiguous(), w_types)


def type_bias_table(type_table, w_types):
    """(3, E) embedding and (E, F) first-layer rows -> (2, 2, F) table indexed
    by (is_lig_i, is_lig_j); types: 0 = cross, 1 = lig-lig, 2 = pkt-pkt."""
    if type_table is None:
        return None
    proj = type_table @ w_types
    return torch.stack([torch.stack([proj[2], proj[0]]),
                        torch.stack([proj[0], proj[1]])])


def _input_major(linear: nn.Linear) -> torch.Tensor:
    """(in, out) contiguous copy of a Linear's weight for the kernels."""
    return linear.weight.t().contiguous()


class DenseGCL(nn.Module):
    """Invariant node update: pairwise edge MLP + masked sum + residual MLP."""

    def __init__(self, hidden_nf: int, edges_in_d: int, node_nf: int,
                 normalization_factor: float = 100.0, attention: bool = False,
                 aggregation_method: str = "sum"):
        super().__init__()
        self.normalization_factor = normalization_factor
        self.attention = attention
        self.aggregation_method = aggregation_method
        self.edge_mlp = nn.Sequential(
            nn.Linear(2 * node_nf + edges_in_d, hidden_nf), nn.SiLU(),
            nn.Linear(hidden_nf, hidden_nf), nn.SiLU())
        self.node_mlp = nn.Sequential(
            nn.Linear(node_nf + hidden_nf, hidden_nf), nn.SiLU(),
            nn.Linear(hidden_nf, node_nf))
        if attention:
            self.att_mlp = nn.Sequential(nn.Linear(hidden_nf, 1), nn.Sigmoid())

    def forward(self, h, x, ctx: GraphContext, shared_pocket: bool = False):
        a_row, a_col, w_d2, w_d20, w_types = split_first_layer(self.edge_mlp[0], h)
        weights = (w_d2, w_d20, type_bias_table(ctx.type_table, w_types),
                   _input_major(self.edge_mlp[2]), self.edge_mlp[2].bias)
        if self.attention:
            weights += (_input_major(self.att_mlp[0]), self.att_mlp[0].bias)
        else:
            weights += (None, None)
        kw = dict(cutoffs=ctx.cutoffs, attention=self.attention,
                  normalization_factor=self.normalization_factor, **ctx.kernel_opts)
        mask, is_lig, x0 = ctx.mask, ctx.is_lig, ctx.x0
        if ctx.shard is not None:
            agg = ctx.shard.aggregate(
                kernels.gcl_message_agg, a_row, a_col, x, x0, mask, is_lig, *weights,
                col_mask=ctx.shard.col_mask(mask), **kw)
        elif shared_pocket:
            # one pocket replicated across the batch and a per-step-uniform
            # time channel make the pocket-row/pocket-col aggregation of the
            # first GCL identical for every sample: compute it once at B = 1
            # and broadcast; only the ligand-touching parts run per sample
            # (an exact partition of the (row, col) space)
            pkt = mask * (1.0 - is_lig)
            lig = mask * is_lig
            agg_pp = kernels.gcl_message_agg(
                a_row[:1], a_col[:1], x[:1], x0[:1], pkt[:1], is_lig[:1],
                *weights, col_mask=pkt[:1], **kw)
            agg_pl = kernels.gcl_message_agg(
                a_row, a_col, x, x0, pkt, is_lig, *weights, col_mask=lig, **kw)
            agg_lr = kernels.gcl_message_agg(
                a_row, a_col, x, x0, lig, is_lig, *weights, col_mask=mask,
                update_rows=ctx.n_lig, **kw)
            agg = agg_pp.expand_as(agg_pl) + agg_pl + agg_lr
        else:
            agg = kernels.gcl_message_agg(a_row, a_col, x, x0, mask, is_lig,
                                          *weights, **kw)
        return self.node_update(h, agg, mask)

    def node_update(self, h, agg, mask):
        upd = self.node_mlp(torch.cat([h, agg], dim=-1))
        return (h + upd) * mask[..., None]

    def dense_forward(self, h, edge_feat, adj, mask, ctx: Optional[GraphContext] = None):
        """The dense path: the edge MLP on every (row, column) pair of
        ``adj`` (B, N, Nc) with the edge features ``edge_feat`` (B, N, Nc, .)
        or None, aggregated by ``aggregation_method``; under ``ctx``'s shard
        the columns are this rank's and the sums complete over its group.  The
        edge MLP runs in ``ctx.compute_dtype`` (float32 without a context)."""
        w = [self.edge_mlp[0].weight, self.edge_mlp[0].bias,
             self.edge_mlp[2].weight, self.edge_mlp[2].bias]
        if self.attention:
            w += [self.att_mlp[0].weight, self.att_mlp[0].bias]
        if ctx is not None:
            h_in, *w = ctx.enter(h, *w)
        else:
            h_in = h
        cd = torch.float32 if ctx is None else ctx.compute_dtype
        if cd != torch.float32:
            h_in, w = h_in.to(cd), [t.to(cd) for t in w]
            edge_feat = None if edge_feat is None else edge_feat.to(cd)
        m = F.silu(split_pair_dense(w[0], w[1], h_in, edge_feat, h.shape[-1], ctx))
        m = F.silu(F.linear(m, w[2], w[3]))
        if self.attention:
            m = m * torch.sigmoid(F.linear(m, w[4], w[5]))
        num = pair_sum(m, adj)
        agg = dense_aggregate(num, adj, self.aggregation_method,
                              self.normalization_factor, ctx)
        return self.node_update(h, agg, mask)

    def fused_pieces(self, h, ctx: GraphContext):
        """The operands of the whole-block kernel that belong to this layer:
        the folded first-layer projections of h, and the ``gcl`` and ``node``
        parameter dicts of ``ops.egnn_cuda.block_fused``."""
        H = h.shape[-1]
        a_row, a_col, w_d2, w_d20, w_types = split_first_layer(self.edge_mlp[0], h)
        a_row, a_col, type_delta = kernels.fold_type_bias(
            a_row, a_col, ctx.is_lig, type_bias_table(ctx.type_table, w_types))
        gcl = dict(w_d2=w_d2, w_d20=w_d20, type_delta=type_delta,
                   w2=_input_major(self.edge_mlp[2]), b2=self.edge_mlp[2].bias,
                   w_att=_input_major(self.att_mlp[0]) if self.attention else None,
                   b_att=self.att_mlp[0].bias if self.attention else None)
        w0 = self.node_mlp[0].weight  # (F, H + F)
        node = dict(w_h=w0[:, :H].t().contiguous(), w_a=w0[:, H:].t().contiguous(),
                    b0=self.node_mlp[0].bias, w2=_input_major(self.node_mlp[2]),
                    b2=self.node_mlp[2].bias)
        return a_row.contiguous(), a_col.contiguous(), gcl, node


def coord_mlp(hidden_nf: int, edges_in_d: int, node_nf: int,
              head: Optional[nn.Linear] = None) -> nn.Sequential:
    """Linear(2H+E -> F), silu, Linear(F -> F), silu, Linear(F -> 1, no bias).
    ``head`` shares an existing final layer (the cross-product MLP's head is
    the coordinate MLP's).  A new head starts xavier-uniform with gain 1e-3,
    as in the reference and the JAX package, so that a fresh model's
    coordinate updates start near zero."""
    if head is None:
        head = nn.Linear(hidden_nf, 1, bias=False)
        nn.init.xavier_uniform_(head.weight, gain=1e-3)
    return nn.Sequential(
        nn.Linear(2 * node_nf + edges_in_d, hidden_nf), nn.SiLU(),
        nn.Linear(hidden_nf, hidden_nf), nn.SiLU(), head)


class DenseEquivariantUpdate(nn.Module):
    """Equivariant coordinate update with the optional SE(3) cross term, of
    the rows the context lets move."""

    def __init__(self, hidden_nf: int, edges_in_d: int, node_nf: int,
                 normalization_factor: float = 100.0, tanh: bool = False,
                 coords_range: float = 10.0, norm_constant: float = 1.0,
                 reflection_equiv: bool = True, aggregation_method: str = "sum"):
        super().__init__()
        self.normalization_factor = normalization_factor
        self.aggregation_method = aggregation_method
        self.tanh = tanh
        self.coords_range = coords_range
        self.norm_constant = norm_constant
        self.reflection_equiv = reflection_equiv
        self.coord_mlp = coord_mlp(hidden_nf, edges_in_d, node_nf)
        if not reflection_equiv:
            self.cross_product_mlp = coord_mlp(hidden_nf, edges_in_d, node_nf,
                                               head=self.coord_mlp[4])

    def forward(self, h, x, ctx: GraphContext):
        a_row, a_col, w_d2, w_d20, w_types = split_first_layer(self.coord_mlp[0], h)
        w3 = _input_major(self.coord_mlp[4])
        cross, graph_mean = None, None
        if not self.reflection_equiv:
            mlp = self.cross_product_mlp
            c_row, c_col, cw_d2, cw_d20, cw_types = split_first_layer(mlp[0], h)
            cross = dict(a_row=c_row, a_col=c_col, w_d2=cw_d2, w_d20=cw_d20,
                         type_bias=type_bias_table(ctx.type_table, cw_types),
                         w2=_input_major(mlp[2]), b2=mlp[2].bias, w3=w3)
            graph_mean = masked_mean(x, ctx.mask)
        args = (a_row, a_col, x, ctx.x0, ctx.mask, ctx.is_lig, w_d2, w_d20,
                type_bias_table(ctx.type_table, w_types),
                _input_major(self.coord_mlp[2]), self.coord_mlp[2].bias, w3)
        kw = dict(cutoffs=ctx.cutoffs, tanh=self.tanh, coords_range=self.coords_range,
                  norm_constant=self.norm_constant,
                  normalization_factor=self.normalization_factor,
                  graph_mean=graph_mean, update_rows=ctx.update_rows, **ctx.kernel_opts)
        if ctx.shard is not None:
            # the graph mean is of every node: computed before the split and
            # replicated; its cotangent is summed over the blocks with the rest
            agg = ctx.shard.aggregate(kernels.coord_update_agg, *args, cross=cross,
                                      col_mask=ctx.shard.col_mask(ctx.mask), **kw)
        else:
            agg = kernels.coord_update_agg(*args, cross=cross, **kw)
        return self.apply_update(x, agg, ctx)

    def dense_forward(self, h, x, coord_diff, coord_cross, edge_feat, ctx: GraphContext):
        """The dense path: both pair MLPs on every (row, column) pair, the
        translations summed over the adjacency and normalized by
        ``aggregation_method``.  The pair MLPs run in ``ctx.compute_dtype``,
        their outputs and everything after them in float32."""
        head = self.coord_mlp[4].weight
        mlps = [self.coord_mlp] + ([] if self.reflection_equiv else [self.cross_product_mlp])
        w = [head] + [t for mlp in mlps for t in (mlp[0].weight, mlp[0].bias,
                                                  mlp[2].weight, mlp[2].bias)]
        h_in, head, *w = ctx.enter(h, *w)
        H = h.shape[-1]
        cd, feat = ctx.compute_dtype, edge_feat
        if cd != torch.float32:
            h_in, head, w = h_in.to(cd), head.to(cd), [t.to(cd) for t in w]
            feat = edge_feat.to(cd)

        def phi(w0, b0, w1, b1):
            z = F.silu(split_pair_dense(w0, b0, h_in, feat, H, ctx))
            out = F.linear(F.silu(F.linear(z, w1, b1)), head).float()  # (B, N, Nc, 1)
            return torch.tanh(out) * self.coords_range if self.tanh else out

        trans = coord_diff * phi(*w[:4])
        if not self.reflection_equiv:
            trans = trans + coord_cross * phi(*w[4:])
        num = (trans * ctx.adj[..., None]).sum(2)
        agg = dense_aggregate(num, ctx.adj, self.aggregation_method,
                              self.normalization_factor, ctx)
        return self.apply_update(x, agg, ctx)

    @staticmethod
    def apply_update(x, agg, ctx: GraphContext):
        if ctx.update_coords_mask is not None:
            agg = agg * ctx.update_coords_mask[..., None]
        return (x + agg) * ctx.mask[..., None]

    def block_pieces(self, type_table, H: int):
        """The ``coord`` and ``cross`` parameter dicts of the whole-block
        kernel: each first layer split into its per-node, distance and type
        rows (what ``split_first_layer`` and ``type_bias_table`` do outside
        the kernel for the split path).  The cross head is the coordinate
        head."""
        w3 = _input_major(self.coord_mlp[4])

        def pieces(mlp):
            w = mlp[0].weight  # (F, 2H + 2 + E)
            w_types = w[:, 2 * H + 2:].t() if w.shape[1] > 2 * H + 2 else None
            return dict(k_i=w[:, :H].t().contiguous(),
                        k_j=w[:, H:2 * H].t().contiguous(), b0=mlp[0].bias,
                        w_d2=w[:, 2 * H].contiguous(),
                        w_d20=w[:, 2 * H + 1].contiguous(),
                        type_bias=type_bias_table(type_table, w_types),
                        w1=_input_major(mlp[2]), b1=mlp[2].bias, w3=w3)

        cross = None if self.reflection_equiv else pieces(self.cross_product_mlp)
        return pieces(self.coord_mlp), cross


class EquivariantBlock(nn.Module):
    """``n_layers`` x DenseGCL followed by one coordinate update; distances
    are recomputed from the block's current coordinates."""

    def __init__(self, hidden_nf: int, edge_feat_nf: int, n_layers: int = 2,
                 attention: bool = True, tanh: bool = False,
                 coords_range: float = 15.0, norm_constant: float = 1.0,
                 normalization_factor: float = 100.0,
                 reflection_equiv: bool = True, sin_embedding: bool = False,
                 aggregation_method: str = "sum"):
        super().__init__()
        self.n_layers = n_layers
        self.norm_constant = norm_constant
        self.reflection_equiv = reflection_equiv
        self.sin_embedding = sin_embedding
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", DenseGCL(
                hidden_nf, edge_feat_nf, node_nf=hidden_nf,
                normalization_factor=normalization_factor, attention=attention,
                aggregation_method=aggregation_method))
        self.gcl_equiv = DenseEquivariantUpdate(
            hidden_nf, edge_feat_nf, node_nf=hidden_nf,
            normalization_factor=normalization_factor, tanh=tanh,
            coords_range=coords_range, norm_constant=norm_constant,
            reflection_equiv=reflection_equiv, aggregation_method=aggregation_method)

    def forward(self, h, x, ctx: GraphContext, shared_pocket: bool = False):
        if ctx.dense:
            return self._dense(h, x, ctx)
        if ctx.block_fuse and self.n_layers == 1 and not shared_pocket:
            return self._block_fused(h, x, ctx)
        for i in range(self.n_layers):
            # the batch-invariant pocket factorization only holds for the
            # very first GCL (pocket h diverges per sample after it)
            h = getattr(self, f"gcl_{i}")(h, x, ctx,
                                          shared_pocket=shared_pocket and i == 0)
        x = self.gcl_equiv(h, x, ctx)
        return h * ctx.mask[..., None], x

    def _dense(self, h, x, ctx: GraphContext):
        """The dense path: the edge features rebuilt from the block's
        current coordinates, [dist(x), dist(x0), edge types]."""
        (x_in,) = ctx.enter(x)
        x_cols = ctx.cols(x_in)
        radial, coord_diff = coord2diff(x_in, self.norm_constant, x_cols)
        coord_cross = None if self.reflection_equiv else coord2cross(
            x_in, ctx.mask, self.norm_constant, x_cols)
        dist = sinusoidal_distance_embedding(radial) if self.sin_embedding else radial
        edge_feat = torch.cat([dist, ctx.edge_feat0], -1)
        for i in range(self.n_layers):
            h = getattr(self, f"gcl_{i}").dense_forward(h, edge_feat, ctx.adj, ctx.mask, ctx)
        x = self.gcl_equiv.dense_forward(h, x, coord_diff, coord_cross, edge_feat, ctx)
        return h * ctx.mask[..., None], x

    def _block_fused(self, h, x, ctx: GraphContext):
        """The whole block as one kernel (``ops.egnn_cuda.block_fused``)."""
        equiv = self.gcl_equiv
        a_row, a_col, gcl, node = self.gcl_0.fused_pieces(h, ctx)
        coord, cross = equiv.block_pieces(ctx.type_table, h.shape[-1])
        graph_mean = None if cross is None else masked_mean(x, ctx.mask)
        h_new, dx = kernels.block_fused(
            h, a_row, a_col, x, ctx.x0, ctx.mask, ctx.is_lig, gcl, node, coord,
            cross, graph_mean, cutoffs=ctx.cutoffs, attention=self.gcl_0.attention,
            tanh=equiv.tanh, coords_range=equiv.coords_range,
            norm_constant=equiv.norm_constant,
            normalization_factor=equiv.normalization_factor,
            update_rows=ctx.update_rows, precision=ctx.precision)
        return h_new * ctx.mask[..., None], equiv.apply_update(x, dx, ctx)


class EGNN(nn.Module):
    """embedding -> n_layers equivariant blocks -> embedding_out."""

    def __init__(self, in_node_nf: int, hidden_nf: int, out_node_nf: int,
                 in_edge_nf: int = 0, n_layers: int = 3,
                 attention: bool = False, tanh: bool = False,
                 coords_range: float = 15.0, norm_constant: float = 1.0,
                 inv_sublayers: int = 2, normalization_factor: float = 100.0,
                 reflection_equiv: bool = True, sin_embedding: bool = False,
                 aggregation_method: str = "sum"):
        super().__init__()
        self.n_layers = n_layers
        self.sin_embedding = sin_embedding
        # [dist(d2), dist(d2_0), edge-type embedding]; dist is d2 itself or
        # its sinusoidal embedding
        dist_dim = sin_embedding_dim() if sin_embedding else 1
        edge_feat_nf = 2 * dist_dim + in_edge_nf
        self.embedding = nn.Linear(in_node_nf, hidden_nf)
        for i in range(n_layers):
            # every block gets the FULL coords_range, as in the reference
            self.add_module(f"e_block_{i}", EquivariantBlock(
                hidden_nf, edge_feat_nf, n_layers=inv_sublayers,
                attention=attention, tanh=tanh,
                coords_range=float(coords_range), norm_constant=norm_constant,
                normalization_factor=normalization_factor,
                reflection_equiv=reflection_equiv, sin_embedding=sin_embedding,
                aggregation_method=aggregation_method))
        self.embedding_out = nn.Linear(hidden_nf, out_node_nf)

    def forward(self, h, x, ctx: GraphContext, shared_pocket: bool = False):
        if ctx.dense:
            # the input coordinates' edge features, shared by every block
            (x0,) = ctx.enter(x)
            radial0, _ = coord2diff(x0, x_cols=ctx.cols(x0))
            feat0 = sinusoidal_distance_embedding(radial0) if self.sin_embedding else radial0
            if ctx.edge_attr is not None:
                feat0 = torch.cat([feat0, ctx.edge_attr], -1)
            ctx = dataclasses.replace(ctx, edge_feat0=feat0)
        h = self.embedding(h)
        for i in range(self.n_layers):
            h, x = getattr(self, f"e_block_{i}")(
                h, x, ctx, shared_pocket=shared_pocket and i == 0)
        h = self.embedding_out(h)
        return h * ctx.mask[..., None], x


class GNN(nn.Module):
    """The non-equivariant baseline of ``gnn_dynamics`` on the dense path:
    embedding -> n_layers GCLs over [x, h] node features and the edge-type
    features, no distances -> embedding_out."""

    def __init__(self, in_node_nf: int, in_edge_nf: int, hidden_nf: int,
                 out_node_nf: int, n_layers: int = 4, attention: bool = False,
                 normalization_factor: float = 1.0, aggregation_method: str = "sum"):
        super().__init__()
        self.n_layers = n_layers
        self.embedding = nn.Linear(in_node_nf, hidden_nf)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", DenseGCL(
                hidden_nf, in_edge_nf, node_nf=hidden_nf,
                normalization_factor=normalization_factor, attention=attention,
                aggregation_method=aggregation_method))
        self.embedding_out = nn.Linear(hidden_nf, out_node_nf)

    def forward(self, h, adj, mask, edge_attr=None):
        h = self.embedding(h)
        for i in range(self.n_layers):
            h = getattr(self, f"gcl_{i}").dense_forward(h, edge_attr, adj, mask)
        return self.embedding_out(h) * mask[..., None]
