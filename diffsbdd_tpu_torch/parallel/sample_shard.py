"""The conditional sampling chain with its batch split over the ranks of a group.

Each rank samples its contiguous slice of the batch with
``ConditionalDDPM.sample_given_pocket`` on its own card -- the kernels run
unchanged, a chain needs no communication -- and the slices are gathered, so
that every rank returns the whole batch.  Two noise contracts, as in the JAX
package (``diffsbdd_tpu/parallel/sample_shard.py``):

* **global** (``sample_given_pocket_sharded``, the JAX package's GSPMD tier):
  every rank draws each Gaussian of the whole logical batch from the same
  seeded generator and keeps its rows, so the gathered result is the
  unsharded chain's whatever the number of ranks;
* **per rank** (``ShardedSampler``, its shard_map tier): rank r draws only its
  slice's noise, from a generator seeded with ``rank_seed(seed, r)``;
  ``reference_shard_chain`` is the single-process chain that rank r's rows
  equal.

Both raise when the group's size does not divide the batch.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from diffsbdd_tpu_torch.parallel.mesh import (all_gather_rows, group_rank_size,
                                              rank_seed, shard_batch)


def _rows(B: int, group) -> slice:
    index, count = group_rank_size(group)
    if B % count != 0:
        raise ValueError(f"batch {B} is not divisible by the {count} ranks of the group")
    local = B // count
    return slice(index * local, (index + 1) * local)


@contextlib.contextmanager
def _noise_source(ddpm, draw):
    """``ddpm.sample_gaussian`` replaced by ``draw`` for the block's duration."""
    own = vars(ddpm).get("sample_gaussian")
    ddpm.sample_gaussian = draw
    try:
        yield
    finally:
        if own is None:
            del ddpm.sample_gaussian
        else:
            ddpm.sample_gaussian = own


def sample_given_pocket_sharded(ddpm, group, generator: torch.Generator, pocket,
                                lig_mask, timesteps: Optional[int] = None,
                                shared_pocket: bool = False):
    """``ddpm.sample_given_pocket`` over the whole batch (``pocket`` and
    ``lig_mask`` replicated on ``group``), each rank sampling its slice:
    global noise contract.  Returns (xh_lig, xh_pkt) of the whole batch."""
    B = lig_mask.shape[0]
    rows = _rows(B, group)
    draw = ddpm.sample_gaussian

    def global_draw(gen, shape, mask):
        full = (B,) + tuple(shape[1:])
        return draw(gen, full, mask.new_ones((B,) + tuple(mask.shape[1:])))[rows] \
            * mask[..., None]

    with _noise_source(ddpm, global_draw):
        xh_lig, xh_pkt = ddpm.sample_given_pocket(
            generator, shard_batch(pocket, group), lig_mask[rows], timesteps=timesteps,
            shared_pocket=shared_pocket)
    return all_gather_rows(xh_lig, group), all_gather_rows(xh_pkt, group)


class ShardedSampler:
    """The batch split over ``group``, each rank with its own noise: rank r
    samples its slice with a generator seeded ``rank_seed(seed, r)`` (on the
    slice's device), exactly as ``reference_shard_chain`` does for shard r."""

    def __init__(self, ddpm, group):
        self.ddpm = ddpm
        self.group = group

    def sample_given_pocket(self, seed: int, pocket, lig_mask,
                            timesteps: Optional[int] = None,
                            shared_pocket: bool = False):
        rows = _rows(lig_mask.shape[0], self.group)
        index, _ = group_rank_size(self.group)
        xh_lig, xh_pkt = reference_shard_chain(
            self.ddpm, seed, shard_batch(pocket, self.group), lig_mask[rows], index,
            timesteps=timesteps, shared_pocket=shared_pocket)
        return all_gather_rows(xh_lig, self.group), all_gather_rows(xh_pkt, self.group)


def reference_shard_chain(ddpm, seed: int, pocket_local, lig_mask_local,
                          shard_index: int, timesteps: Optional[int] = None,
                          shared_pocket: bool = False):
    """The single-process chain of shard ``shard_index`` on its slice: what
    ``ShardedSampler`` computes on that rank."""
    generator = torch.Generator(device=lig_mask_local.device).manual_seed(
        rank_seed(seed, shard_index))
    return ddpm.sample_given_pocket(generator, pocket_local, lig_mask_local,
                                    timesteps=timesteps, shared_pocket=shared_pocket)
