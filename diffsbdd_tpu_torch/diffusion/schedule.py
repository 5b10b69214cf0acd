"""Noise schedules and the gamma -> (alpha, sigma) algebra.

The predefined schedules (cosine, polynomial_<power>) are gamma tables built
once on the host in float64 and stored as float32, exactly as the JAX package
builds them; the learned monotone schedule is ``GammaNetwork``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def cosine_alphas2(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cumulative alpha^2 of the cosine schedule: betas clipped at 0.999 and
    alphas2 rebuilt as a cumulative product."""
    steps = timesteps + 2
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    betas = np.clip(betas, a_min=0, a_max=0.999)
    return np.cumprod(1.0 - betas, axis=0)


def clip_noise_schedule(alphas2: np.ndarray, clip_value: float = 0.001) -> np.ndarray:
    """Clip the per-step ratio alpha_t^2 / alpha_{t-1}^2 from below."""
    alphas2 = np.concatenate([np.ones(1), alphas2], axis=0)
    alphas_step = np.clip(alphas2[1:] / alphas2[:-1], a_min=clip_value, a_max=1.0)
    return np.cumprod(alphas_step, axis=0)


def polynomial_alphas2(timesteps: int, s: float = 1e-4, power: float = 3.0) -> np.ndarray:
    """alpha^2 schedule (1 - (t/T)^power)^2 with ratio clipping and precision."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = clip_noise_schedule(alphas2, clip_value=0.001)
    precision = 1 - 2 * s
    return precision * alphas2 + s


def gamma_table(noise_schedule: str, timesteps: int, precision: float) -> np.ndarray:
    """gamma(t) = log(sigma_t^2 / alpha_t^2) for t = 0..T, as float32.
    ``noise_schedule`` is 'cosine' or 'polynomial_<power>'."""
    kind, _, power = noise_schedule.partition("_")
    if noise_schedule == "cosine":
        alphas2 = cosine_alphas2(timesteps)
    elif kind == "polynomial" and power:
        alphas2 = polynomial_alphas2(timesteps, s=precision, power=float(power))
    else:
        raise ValueError(f"unknown noise schedule {noise_schedule!r}")
    sigmas2 = 1 - alphas2
    return (-(np.log(alphas2) - np.log(sigmas2))).astype(np.float32)


def alpha(gamma: torch.Tensor) -> torch.Tensor:
    """alpha_t = sqrt(sigmoid(-gamma_t))."""
    return torch.sqrt(torch.sigmoid(-gamma))


def sigma(gamma: torch.Tensor) -> torch.Tensor:
    """sigma_t = sqrt(sigmoid(gamma_t))."""
    return torch.sqrt(torch.sigmoid(gamma))


def snr(gamma: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio alpha^2 / sigma^2 = exp(-gamma)."""
    return torch.exp(-gamma)


def sigma_and_alpha_t_given_s(gamma_t: torch.Tensor, gamma_s: torch.Tensor):
    """Transition coefficients of q(z_t | z_s), t > s: returns
    (sigma^2_{t|s}, sigma_{t|s}, alpha_{t|s}) in the expm1/softplus form."""
    sigma2_t_given_s = -torch.expm1(F.softplus(gamma_s) - F.softplus(gamma_t))
    log_alpha2_t = F.logsigmoid(-gamma_t)
    log_alpha2_s = F.logsigmoid(-gamma_s)
    alpha_t_given_s = torch.exp(0.5 * (log_alpha2_t - log_alpha2_s))
    return sigma2_t_given_s, torch.sqrt(sigma2_t_given_s), alpha_t_given_s


def cdf_standard_gaussian(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2)))


class PositiveLinear(nn.Module):
    """Linear layer whose weights pass through softplus, so they are positive.
    ``weight`` is (out, in) as in ``nn.Linear``; the offset makes
    softplus(weight) start small."""

    def __init__(self, in_features: int, out_features: int,
                 weight_init_offset: float = -2.0):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(-bound, bound)
            + weight_init_offset)
        self.bias = nn.Parameter(torch.empty(out_features).uniform_(-bound, bound))

    def forward(self, x):
        return F.linear(x, F.softplus(self.weight), self.bias)


class GammaNetwork(nn.Module):
    """Learned monotone gamma(t), normalized to [gamma_0, gamma_1]."""

    def __init__(self):
        super().__init__()
        self.l1 = PositiveLinear(1, 1)
        self.l2 = PositiveLinear(1, 1024)
        self.l3 = PositiveLinear(1024, 1)
        self.gamma_0 = nn.Parameter(torch.tensor([-5.0]))
        self.gamma_1 = nn.Parameter(torch.tensor([10.0]))

    def gamma_tilde(self, t):
        l1_t = self.l1(t)
        return l1_t + self.l3(torch.sigmoid(self.l2(l1_t)))

    def forward(self, t):
        g0 = self.gamma_tilde(torch.zeros_like(t))
        g1 = self.gamma_tilde(torch.ones_like(t))
        normalized = (self.gamma_tilde(t) - g0) / (g1 - g0)
        return self.gamma_0 + (self.gamma_1 - self.gamma_0) * normalized
