"""Predefined polynomial noise schedule and the gamma -> (alpha, sigma) algebra.

The gamma table is built once on the host in float64 and stored as float32,
exactly as the JAX package builds it.  The learned schedule
(``GammaNetwork``) and the cosine schedule are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
    ``noise_schedule`` is 'polynomial_<power>'."""
    kind, _, power = noise_schedule.partition("_")
    if kind != "polynomial" or not power:
        raise NotImplementedError(
            f"noise schedule {noise_schedule!r}: only polynomial_<power> is ported")
    alphas2 = polynomial_alphas2(timesteps, s=precision, power=float(power))
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
