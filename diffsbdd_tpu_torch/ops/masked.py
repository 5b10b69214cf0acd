"""Masked reductions over padded node axes ``(B, N, D)`` with a ``(B, N)``
validity mask."""
from __future__ import annotations

import torch


def masked_sum(x: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sum of ``x`` over the node axis, counting only mask==1 nodes."""
    return (x * mask.unsqueeze(-1)).sum(dim)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 1,
                eps: float = 1e-12) -> torch.Tensor:
    """Mean of ``x`` over valid nodes; safe for empty masks."""
    count = mask.sum(dim)
    return masked_sum(x, mask, dim) / torch.clamp(count, min=eps)[..., None]



def sum_except_batch(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the batch axis, ignoring padded nodes:
    ``x`` (B, N, D), ``mask`` (B, N) -> (B,)."""
    return (x.sum(-1) * mask).sum(-1)
