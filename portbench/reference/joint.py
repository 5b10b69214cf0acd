"""The joint model's training step of DiffSBDD: its L2 loss, the gradient
norm clipping and the AMSGrad-with-weight-decay update.

Loss (``JointDDPM`` in training, ``loss_type: l2``): ligand and pocket
normalized (x / 1, one-hot / 4), noised together at t ~ U{0..T} with
centre-of-mass-free coordinate noise over the whole complex; the network
predicts the noise; per graph

    nll = 0.5 * (|eps_l - net_l|^2 / ((3 + atom_nf) n_l)
                 + |eps_p - net_p|^2 / ((3 + residue_nf) n_p))   (t > 0)
          + |eps_x,l - net_x,l|^2 / (6 n_l) + |eps_x,p - net_x,p|^2 / (6 n_p)
          - log p(h | z_0)                                          (t = 0)
          + KL(q(z_T | x) || N(0, I))

and the loss is its mean over the batch.  A step with ``k`` micro-batches
averages their gradients.  Clipping: at most 1.5 * mean + 2 * std of the
last 50 clipped norms (seeded with 3000).  The update is optax's
``chain(scale_by_amsgrad(), add_decayed_weights(1e-12), scale(-lr))``:
bias-corrected moments, the running maximum of the corrected second moment.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import model, schedule as sched


def remove_mean_joint(x_l, x_p, m_l, m_p):
    total = (x_l * m_l[..., None]).sum(1) + (x_p * m_p[..., None]).sum(1)
    mean = total / torch.clamp(m_l.sum(1) + m_p.sum(1), min=1e-12)[..., None]
    return x_l - mean[:, None, :], x_p - mean[:, None, :]


def gaussian_kl(mu2, q_sigma, p_sigma, d):
    return d * torch.log(p_sigma / q_sigma) + 0.5 * (d * q_sigma ** 2 + mu2) / p_sigma ** 2 \
        - 0.5 * d


def masked_sum(x, mask):
    return (x.sum(-1) * mask).sum(-1)


def log_ph_cat(one_hot_norm, z_h, sigma_0_cat, mask, norm_h):
    one_hot = one_hot_norm * norm_h
    centered = z_h * norm_h - 1.0
    s = sigma_0_cat[:, None, :]
    cdf = lambda v: 0.5 * (1.0 + torch.erf(v / math.sqrt(2)))
    mass = torch.clamp(cdf((centered + 0.5) / s) - cdf((centered - 0.5) / s), min=0.0)
    logp = torch.log(mass + 1e-10)
    logp = logp - torch.logsumexp(logp, -1, keepdim=True)
    return masked_sum(logp * one_hot, mask)


def loss(P, net, table, T, lig, pkt, t_int, draws, norm_values, precision="f32"):
    """Per-graph nll (B,) of padded batches ``lig``/``pkt`` (x, one_hot, mask,
    size) at integer timesteps ``t_int`` (B,) with the standard normal draws
    (ligand x, pocket x, ligand h, pocket h; masked)."""
    m_l, m_p = lig["mask"], pkt["mask"]
    xh_l = torch.cat([lig["x"] / norm_values[0], lig["one_hot"] / norm_values[1]], -1)
    xh_p = torch.cat([pkt["x"] / norm_values[0], pkt["one_hot"] / norm_values[1]], -1)
    n_l, n_p = lig["size"].float(), pkt["size"].float()
    atom_nf, residue_nf = xh_l.shape[-1] - 3, xh_p.shape[-1] - 3
    gamma_t = table[t_int][:, None]
    alpha_t, sigma_t = sched.alpha(gamma_t)[:, None, :], sched.sigma(gamma_t)[:, None, :]
    ex_l, ex_p = remove_mean_joint(draws[0], draws[1], m_l, m_p)
    eps_l = torch.cat([ex_l * m_l[..., None], draws[2]], -1)
    eps_p = torch.cat([ex_p * m_p[..., None], draws[3]], -1)
    z_l = (alpha_t * xh_l + sigma_t * eps_l) * m_l[..., None]
    z_p = (alpha_t * xh_p + sigma_t * eps_p) * m_p[..., None]
    t = (t_int.float() / T)[:, None]
    net_l, net_p = model.dynamics(P, net, z_l, z_p, t, m_l, m_p, training=True,
                                  precision=precision, chunk=z_l.shape[0])
    zero = (t_int == 0).float()
    err_l = masked_sum((eps_l - net_l) ** 2, m_l) * (1 - zero)
    err_p = masked_sum((eps_p - net_p) ** 2, m_p) * (1 - zero)
    loss_t = 0.5 * (err_l / ((3 + atom_nf) * n_l) + err_p / ((3 + residue_nf) * n_p))
    px_l = 0.5 * masked_sum((eps_l[..., :3] - net_l[..., :3]) ** 2, m_l)
    px_p = 0.5 * masked_sum((eps_p[..., :3] - net_p[..., :3]) ** 2, m_p)
    sigma_0_cat = sched.sigma(gamma_t) * norm_values[1]
    ph = log_ph_cat(xh_l[..., 3:], z_l[..., 3:], sigma_0_cat, m_l, norm_values[1]) \
        + log_ph_cat(xh_p[..., 3:], z_p[..., 3:], sigma_0_cat, m_p, norm_values[1])
    loss_0 = (px_l / (3 * n_l) + px_p / (3 * n_p) - ph) * zero
    gamma_T = table[torch.full_like(t_int, T)][:, None]
    alpha_T, sigma_T = sched.alpha(gamma_T)[:, None, :], sched.sigma(gamma_T)[:, 0]
    mu_l, mu_p = alpha_T * xh_l, alpha_T * xh_p
    ones = torch.ones_like(sigma_T)
    mu2_h = masked_sum(mu_l[..., 3:] ** 2, m_l) + masked_sum(mu_p[..., 3:] ** 2, m_p)
    mu2_x = masked_sum(mu_l[..., :3] ** 2, m_l) + masked_sum(mu_p[..., :3] ** 2, m_p)
    kl = gaussian_kl(mu2_x, sigma_T, ones, (n_l + n_p - 1) * 3) \
        + gaussian_kl(mu2_h, sigma_T, ones, 1.0)
    return loss_t + loss_0 + kl


class Amsgrad:
    """optax's amsgrad + decayed weights (1e-12) + scale(-lr) on a dict."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-12):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu_max = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.count += 1
        t = np.float32(self.count)
        c1 = float(np.float32(1) - np.power(np.float32(self.b1), t))
        c2 = float(np.float32(1) - np.power(np.float32(self.b2), t))
        for k, g in grads.items():
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            self.nu_max[k] = torch.maximum(self.nu_max[k], self.nu[k] / c2)
            update = (self.mu[k] / c1) / (torch.sqrt(self.nu_max[k]) + self.eps) \
                + self.wd * params[k]
            params[k] = params[k] - self.lr * update


class ClipQueue:
    """The last 50 clipped gradient norms, seeded with 3000."""

    def __init__(self):
        self.values: List[float] = [3000.0]

    def max_norm(self):
        v = torch.tensor(self.values, dtype=torch.float32)
        mean = v.mean()
        return float(1.5 * mean + 2.0 * torch.sqrt(((v - mean) ** 2).mean()))

    def push(self, value):
        self.values = (self.values + [value])[-50:]


def train_steps(P0, net, table, T, batches, draws, lr, k_acc, norm_values,
                precision="f32", slice_size: int = 1):
    """Follow ``len(batches)`` optimizer steps from the weights ``P0``.

    ``batches``: per step (lig, pkt) padded dicts of the whole batch;
    ``draws``: per step, per micro-batch, (t_int (b,), [4 draws]).  Returns
    (losses per step, the first step's clipped gradients, the weights after
    the last step), gradients taken ``slice_size`` graphs at a time."""
    params = {k: v.clone() for k, v in P0.items()}
    opt, queue = Amsgrad(params, lr), ClipQueue()
    losses, first = [], None
    for (lig, pkt), step_draws in zip(batches, draws):
        B = lig["x"].shape[0]
        micro = B // k_acc
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for c, (t_int, d) in enumerate(step_draws):
            for s in range(0, micro, slice_size):
                rows = slice(c * micro + s, c * micro + s + slice_size)
                local = slice(s, s + slice_size)
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                nll = loss(leaves, net, table, T,
                           {k: v[rows] for k, v in lig.items()},
                           {k: v[rows] for k, v in pkt.items()},
                           t_int[local], [x[local] for x in d], norm_values, precision)
                part = nll.sum() / (micro * k_acc)
                got = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
                for k, g in zip(leaves, got):
                    if g is not None:
                        grads[k] += g
                total += float(part.detach())
        losses.append(total)
        max_norm = queue.max_norm()
        gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
        scale = min(max_norm / (gnorm + 1e-12), 1.0)
        grads = {k: g * scale for k, g in grads.items()}
        queue.push(min(gnorm, max_norm))
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(params, grads)
    return losses, first, params
