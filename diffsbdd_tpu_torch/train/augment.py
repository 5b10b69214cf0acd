"""Training-time data augmentation: one random rigid rotation per graph and
Gaussian jitter on the joint (ligand + pocket) zero-CoM subspace.

Padded nodes sit at the origin and are fixed points of any rotation, so the
masks are preserved by construction.  The draws go through ``draw_normal`` so
that tests can feed recorded numbers.
"""
from __future__ import annotations

import torch

from diffsbdd_tpu_torch.geom.com import remove_mean_joint


def draw_normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def rotation_matrices(q: torch.Tensor) -> torch.Tensor:
    """(B, 4) quaternions (normalized here) -> (B, 3, 3) rotation matrices;
    standard normal quaternions give the Haar measure on SO(3)."""
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def augment_batch(generator, ligand, pocket, augment_noise: float = 0.0,
                  augment_rotation: bool = False, draw=draw_normal):
    """(ligand, pocket) with augmented coordinates; other fields are shared.
    Draws, in order: the quaternions (if rotating), the ligand jitter, the
    pocket jitter (if jittering)."""
    x_l, x_p = ligand["x"], pocket["x"]
    m_l, m_p = ligand["mask"], pocket["mask"]
    dev = x_l.device

    if augment_rotation:
        rot = rotation_matrices(draw(generator, (x_l.shape[0], 4), dev))
        x_l = torch.einsum("bij,bnj->bni", rot, x_l)
        x_p = torch.einsum("bij,bnj->bni", rot, x_p)

    if augment_noise > 0:
        eps_l = draw(generator, x_l.shape, dev) * m_l[..., None]
        eps_p = draw(generator, x_p.shape, dev) * m_p[..., None]
        eps_l, eps_p = remove_mean_joint(eps_l, eps_p, m_l, m_p)
        x_l = x_l + augment_noise * eps_l * m_l[..., None]
        x_p = x_p + augment_noise * eps_p * m_p[..., None]

    return dict(ligand, x=x_l), dict(pocket, x=x_p)
