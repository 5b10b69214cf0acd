"""Lennard-Jones auxiliary loss on padded ligands and its time-dependent
weight schedule."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def lj_potential(atom_x, atom_one_hot, mask, lj_rm, norm_value: float,
                 clamp: Optional[float] = None):
    """Per-graph summed Lennard-Jones potential.

    atom_x: (B, N, 3); atom_one_hot: (B, N, A); mask: (B, N); lj_rm: (A, A)
    optimal radii in pm.  Self-edges are excluded.
    """
    N = atom_x.shape[1]
    adj = mask[:, :, None] * mask[:, None, :]
    adj = adj * (1.0 - torch.eye(N, dtype=atom_x.dtype, device=atom_x.device)[None])

    diff = atom_x[:, :, None, :] - atom_x[:, None, :, :]
    r2 = (diff ** 2).sum(-1)
    r = torch.sqrt(torch.where(adj > 0, r2, torch.ones_like(r2)))  # masked pairs: r = 1

    rm_table = torch.as_tensor(np.asarray(lj_rm), dtype=atom_x.dtype,
                               device=atom_x.device) / 100.0 / norm_value  # pm -> A
    types = atom_one_hot.argmax(-1)
    rm = rm_table[types[:, :, None], types[:, None, :]]
    sr = 2 ** (-1.0 / 6.0) * rm / r
    out = 4 * (sr ** 12 - sr ** 6)
    if clamp is not None:
        out = torch.clamp(out, max=clamp)
    return (out * adj).sum((1, 2))


class WeightSchedule:
    """weight(t): linearly decaying from max_weight at t = 0, or constant."""

    def __init__(self, T: int, max_weight: float, mode: str = "linear"):
        if mode == "linear":
            weights = np.linspace(max_weight, 0, T + 1)
        elif mode == "constant":
            weights = max_weight * np.ones(T + 1)
        else:
            raise NotImplementedError(f"{mode} weight schedule")
        self.weights = torch.as_tensor(weights, dtype=torch.float32)

    def __call__(self, t_int: torch.Tensor) -> torch.Tensor:
        if self.weights.device != t_int.device:
            self.weights = self.weights.to(t_int.device)
        return self.weights[t_int.long()]
