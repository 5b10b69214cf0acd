"""The polynomial noise schedule of DiffSBDD / EDM and its gamma algebra.

gamma(t) = log(sigma_t^2 / alpha_t^2) tabulated at t = 0..T in float64 on
the host and stored as float32; alpha_t = sqrt(sigmoid(-gamma)), sigma_t =
sqrt(sigmoid(gamma)).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gamma_table(schedule: str, timesteps: int, precision: float) -> np.ndarray:
    """``polynomial_<power>``: alpha^2 = (1 - (t / (T + 1))^power)^2 with the
    per-step ratio clipped at 0.001 from below, squeezed by the precision."""
    kind, _, power = schedule.partition("_")
    if kind != "polynomial" or not power:
        raise ValueError(f"only polynomial schedules are referenced: {schedule!r}")
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, float(power))) ** 2
    ratio = np.clip(alphas2 / np.concatenate([np.ones(1), alphas2])[:-1], 0.001, 1.0)
    alphas2 = np.cumprod(ratio)
    alphas2 = (1 - 2 * precision) * alphas2 + precision
    sigmas2 = 1 - alphas2
    return (-(np.log(alphas2) - np.log(sigmas2))).astype(np.float32)


def alpha(gamma):
    return torch.sqrt(torch.sigmoid(-gamma))


def sigma(gamma):
    return torch.sqrt(torch.sigmoid(gamma))


def t_given_s(gamma_t, gamma_s):
    """(sigma^2_{t|s}, sigma_{t|s}, alpha_{t|s}) of q(z_t | z_s)."""
    sigma2 = -torch.expm1(F.softplus(gamma_s) - F.softplus(gamma_t))
    alpha_ts = torch.exp(0.5 * (F.logsigmoid(-gamma_t) - F.logsigmoid(-gamma_s)))
    return sigma2, torch.sqrt(sigma2), alpha_ts
