"""The pocket-conditional sampler of DiffSBDD, one stage at a time.

``ConditionalDDPM``'s chain: a prior draw around the pocket's centre of
mass, T ancestral steps z_t -> z_s through the dynamics, and a decode at
t = 0; after each draw the ligand's centre of mass is removed from the
ligand and the pocket coordinates alike.  Each function takes the state it
starts from and the standard normal draw (already masked) that the stage
consumes, and returns what the stage produces and the scale by which a
change of the network's output moves it; the stages that run the network
also return its output.
"""
from __future__ import annotations

import torch

from portbench.reference import model, schedule as sched


def project(z_lig, xh_pkt, m_l, m_p):
    """Both coordinate sets in the ligand's centre-of-mass frame."""
    mean = model.masked_mean(z_lig[..., :3], m_l)[:, None, :]
    return (torch.cat([(z_lig[..., :3] - mean) * m_l[..., None], z_lig[..., 3:]], -1),
            torch.cat([(xh_pkt[..., :3] - mean) * m_p[..., None], xh_pkt[..., 3:]], -1))


def normalize(x, one_hot, norm_values):
    return torch.cat([x / norm_values[0], one_hot / norm_values[1]], -1)


def prior(xh_pkt, m_l, m_p, noise):
    """z_T ~ N(pocket centre, I) over the ligand's valid nodes, projected;
    ``xh_pkt`` normalized."""
    B, NL = m_l.shape
    mu_x = model.masked_mean(xh_pkt[..., :3], m_p)
    mu = torch.cat([mu_x[:, None, :].expand(B, NL, 3),
                    torch.zeros_like(noise[..., 3:])], -1) * m_l[..., None]
    z, pkt = project((mu + noise) * m_l[..., None], xh_pkt, m_l, m_p)
    return z, pkt, 1.0


def step(P, net, table, z_lig, xh_pkt, t, m_l, m_p, noise, timesteps, precision="f32",
         flip=None):
    """One ancestral step of a ``timesteps``-step chain from the normalized
    time ``t`` (B, 1) to t - 1/timesteps; gamma from the T + 1 entries of
    ``table`` at the nearest step."""
    T = table.shape[0] - 1
    s = (torch.round(t * timesteps) - 1) / timesteps
    gamma_t = table[torch.round(t * T).long()[:, 0]][:, None]
    gamma_s = table[torch.round(s * T).long()[:, 0]][:, None]
    sigma2_ts, sigma_ts, alpha_ts = sched.t_given_s(gamma_t, gamma_s)
    sigma_s, sigma_t = sched.sigma(gamma_s)[:, None, :], sched.sigma(gamma_t)[:, None, :]
    eps, _ = model.dynamics(P, net, z_lig, xh_pkt, t, m_l, m_p, precision=precision,
                            flip=flip)
    coef = (sigma2_ts / alpha_ts / sigma_t[:, :, 0])[:, None, :]
    mu = z_lig / alpha_ts[:, None, :] - coef * eps
    scale = sigma_ts[:, None, :] * sigma_s / sigma_t
    z, pkt = project((mu + scale * noise) * m_l[..., None], xh_pkt, m_l, m_p)
    return z, pkt, coef, eps


def decode(P, net, table, z0, xh_pkt, m_l, m_p, noise, norm_values, atom_nf,
           precision="f32", flip=None):
    """x from p(x | z_0), types by argmax of z_0's features, then the final
    centre-of-mass removal: the sampler's (B, NL, 3 + atom_nf) output."""
    B = z0.shape[0]
    gamma_0 = table[torch.zeros(B, dtype=torch.long, device=z0.device)][:, None]
    t0 = torch.zeros(B, 1, device=z0.device)
    eps, _ = model.dynamics(P, net, z0, xh_pkt, t0, m_l, m_p, precision=precision, flip=flip)
    alpha_0, sigma_0 = sched.alpha(gamma_0)[:, None, :], sched.sigma(gamma_0)[:, None, :]
    sigma_x = torch.exp(0.5 * gamma_0)[:, None, :]
    mu = (z0 - sigma_0 * eps) / alpha_0
    xh, pkt = project((mu + sigma_x * noise) * m_l[..., None], xh_pkt, m_l, m_p)
    x_lig = xh[..., :3] * norm_values[0] * m_l[..., None]
    x_pkt = pkt[..., :3] * norm_values[0] * m_p[..., None]
    h = z0[..., 3:] * norm_values[1]
    h = torch.nn.functional.one_hot(h.argmax(-1), atom_nf).float() * m_l[..., None]
    mean = model.masked_mean(x_lig, m_l)[:, None, :]
    x_lig = (x_lig - mean) * m_l[..., None]
    return torch.cat([x_lig, h], -1), sigma_0 / alpha_0, eps
