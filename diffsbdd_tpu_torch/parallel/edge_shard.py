"""Edge-axis sharding: the EGNN's O(N^2) pairwise work split over a group.

When a graph is too large for one card's pairwise work, the column axis of
the (B, N, N) edge set is split over the ranks of a process group and every
row-sum aggregation is completed with an ``all_reduce``: the EGNN's message
aggregation is a sum, so the ranks' column blocks add up to the whole.  The
JAX package does the same with ``shard_map`` and a ``psum``
(``diffsbdd_tpu/parallel/edge_shard.py``).

How it composes with the model code (``models/egnn.py``,
``models/dynamics.py``):

* every node-level tensor (h, x, masks) stays replicated on the group; only
  the pairwise work is split: rank r's column block [lo, hi) of the node axis
  is its ``col_mask`` (``mask`` times the block), and the kernels visit only
  the columns it keeps, so a rank's pair work is its block's share;
* every GCL and coordinate aggregation runs the CUDA kernel on the card (its
  plain version on the CPU) on that block, and ``ShardContext.aggregate``
  sums the blocks with one ``all_reduce``; the whole-block kernel is not used
  (its phase B needs the complete GCL sum), nor the shared-pocket first
  layer;
* the dense path (the sinusoidal distance embedding, mean aggregation)
  builds the adjacency and edge features of the block's columns only, and
  each aggregation's numerator takes one ``all_reduce`` (``leave``), under
  mean its denominator one more, as the JAX package's ``_psum_cols``;
  ``gnn_dynamics`` raises under the split, as in JAX;
* gradients: ``aggregate`` wraps the call in a conjugate pair -- identity
  forward and an ``all_reduce`` of every input cotangent backward on the way
  in, an ``all_reduce`` forward and identity backward on the way out -- so
  every rank ends with the complete gradient of every replicated tensor and
  parameter, as if nothing were split.

Node counts the shard count does not divide need no padding: the column
blocks are uneven ranges.  The sum over blocks is exact up to summation
order.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

from diffsbdd_tpu_torch.parallel.mesh import all_gather_rows, group_rank_size, shard_batch


def column_range(n: int, index: int, count: int) -> Tuple[int, int]:
    """[lo, hi) of block ``index`` of ``count`` near-equal blocks of ``n``."""
    return n * index // count, n * (index + 1) // count


class _EnterShard(torch.autograd.Function):
    """Replicated tensors into a rank's share of a sum: identity forward; the
    cotangents, one share from each rank, summed over the group backward
    (packed into one ``all_reduce``)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
        parts = torch.split(flat, [g.numel() for g in grads])
        return (None, *(p.view_as(g) for p, g in zip(parts, grads)))


class _LeaveShard(torch.autograd.Function):
    """A rank's share of a sum into the replicated sum: ``all_reduce``
    forward, identity backward."""

    @staticmethod
    def forward(ctx, group, share):
        total = share.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherRows(torch.autograd.Function):
    """The ranks' batch rows gathered in rank order forward; this rank's rows
    of the (replicated) cotangent backward."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.index, _ = group_rank_size(group)
        ctx.rows = t.shape[0]
        return all_gather_rows(t, group)

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows]


@dataclasses.dataclass
class ShardContext:
    """This rank's column block [lo, hi) of the node axis and the group that
    holds the other blocks."""

    group: object
    lo: int
    hi: int

    def col_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """``mask`` (B, N) restricted to the block's columns."""
        block = torch.zeros(mask.shape[1], dtype=mask.dtype, device=mask.device)
        block[self.lo:self.hi] = 1.0
        return mask * block

    def enter(self, *tensors):
        """Replicated tensors about to feed this rank's share of a sum: the
        ones that need a gradient go through the conjugate pair's way in."""
        slots = [i for i, t in enumerate(tensors) if _needs_grad(t)]
        if not slots:
            return tensors
        out = list(tensors)
        for i, t in zip(slots, _EnterShard.apply(self.group, *(tensors[i] for i in slots))):
            out[i] = t
        return tuple(out)

    def leave(self, share: torch.Tensor) -> torch.Tensor:
        """This rank's share of a sum -> the sum over the group."""
        return _LeaveShard.apply(self.group, share)

    def aggregate(self, fn, *args, **kw):
        """``fn(*args, **kw)`` -- an aggregation wrapper of ``ops.egnn_cuda``
        called with this block's ``col_mask`` in ``kw`` -- summed over the
        group, with the conjugate pair of the module docstring around it for
        every tensor that needs a gradient: the positional and keyword
        arguments, and the entries of a dict argument (the cross MLP's)."""
        args = list(args)
        kw = {k: dict(v) if isinstance(v, dict) else v for k, v in kw.items()}
        slots = [(args, i) for i, a in enumerate(args) if _needs_grad(a)]
        for k, v in kw.items():
            if isinstance(v, dict):
                slots += [(v, j) for j, t in v.items() if _needs_grad(t)]
            elif _needs_grad(v):
                slots.append((kw, k))
        for (c, k), t in zip(slots, self.enter(*(c[k] for c, k in slots))):
            c[k] = t
        return self.leave(fn(*args, **kw))


def _needs_grad(a) -> bool:
    return isinstance(a, torch.Tensor) and a.requires_grad


def make_dp_edge_groups(n_data: int, n_edge: int):
    """(data group, edge group) of this rank on an (n_data, n_edge) grid of
    the first n_data * n_edge ranks, the edge axis inner (rank = d * n_edge +
    e): the counterpart of ``make_dp_edge_mesh``.  The batch splits over the
    data group, the pairwise columns over the edge group, whose per-layer
    ``all_reduce`` is the hot collective (put it on the fast links).  Every
    rank builds every group, in the same order; ranks past the grid get
    (None, None).  Raises when more ranks are asked for than exist."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data * n_edge > world:
        raise ValueError(f"requested a {n_data}x{n_edge} data-x-edge grid but only "
                         f"{world} processes are running")
    rank = dist.get_rank()
    data_group = edge_group = None
    for d in range(n_data):
        group = dist.new_group(ranks=[d * n_edge + e for e in range(n_edge)])
        if d == rank // n_edge:
            edge_group = group
    for e in range(n_edge):
        group = dist.new_group(ranks=[d * n_edge + e for d in range(n_data)])
        if e == rank % n_edge:
            data_group = group
    if rank >= n_data * n_edge:
        return None, None
    return data_group, edge_group


def edge_sharded_dynamics(dynamics, group, batch_group=None):
    """``dynamics`` (an ``EGNNDynamics``) with its pairwise work split over
    the ranks of ``group``: a callable with ``dynamics.forward``'s contract
    (``fn(xh_lig, xh_pkt, t, mask_lig, mask_pkt, zero_nan=False) -> (eps_lig,
    eps_pkt)``), its inputs and outputs replicated on ``group`` and its
    gradients complete on every rank.

    ``batch_group``: data parallelism composed with the edge split.  The
    inputs are then the global batch, every rank computes the rows of its
    ``batch_group`` rank (the group's size must divide the batch) and the
    outputs are gathered back to the global batch; the parameter gradients
    of a rank are its rows' share, to be summed over ``batch_group`` (as the
    train step's reduction does).
    """
    def apply(xh_lig, xh_pkt, t, mask_lig, mask_pkt, zero_nan: bool = False):
        if batch_group is not None:
            xh_lig, xh_pkt, t, mask_lig, mask_pkt = (
                shard_batch(a, batch_group) for a in (xh_lig, xh_pkt, t, mask_lig, mask_pkt))
        index, count = group_rank_size(group)
        lo, hi = column_range(mask_lig.shape[1] + mask_pkt.shape[1], index, count)
        out = dynamics(xh_lig, xh_pkt, t, mask_lig, mask_pkt, zero_nan=zero_nan,
                       shard=ShardContext(group, lo, hi))
        if batch_group is not None:
            out = tuple(_GatherRows.apply(batch_group, o) for o in out)
        return out

    return apply
