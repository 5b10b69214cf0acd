"""Pocket-conditional E(3)-equivariant DDPM over padded ligand/pocket graphs:
the sampling half of ``ConditionalDDPM``.

Batches are padded dicts ``{'x': (B,N,3), 'one_hot': (B,N,A), 'mask': (B,N),
'size': (B,)}``.  Every Gaussian draw goes through ``sample_gaussian``, which
draws from an explicit ``torch.Generator``; tests override it to feed a
recorded noise stream.  A chain of T steps draws 1 prior, T step and 1 decode
array.  Training losses, the joint model, inpainting and diversify are not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from diffsbdd_tpu_torch.diffusion import schedule as sched
from diffsbdd_tpu_torch.diffusion.size_prior import SizeDistribution
from diffsbdd_tpu_torch.geom.com import remove_mean_conditional
from diffsbdd_tpu_torch.ops.masked import masked_mean

Batch = Dict[str, torch.Tensor]


def num_nodes_to_mask(num_nodes: np.ndarray, n_max: int) -> np.ndarray:
    """Host-side: (B,) node counts -> (B, n_max) validity mask."""
    num_nodes = np.asarray(num_nodes)
    return (np.arange(n_max)[None, :] < num_nodes[:, None]).astype(np.float32)


def _xh(d: Batch) -> torch.Tensor:
    return torch.cat([d["x"], d["one_hot"]], dim=-1)


class ConditionalDDPM(nn.Module):
    """Only the ligand diffuses; the pocket is fixed context whose coordinates
    translate with the ligand-CoM-free frame."""

    def __init__(self, dynamics: nn.Module, atom_nf: int, residue_nf: int,
                 n_dims: int, size_distribution: Optional[SizeDistribution],
                 timesteps: int = 1000, noise_schedule: str = "polynomial_2",
                 noise_precision: float = 1e-4,
                 norm_values: Tuple[float, float] = (1.0, 1.0),
                 norm_biases: Tuple[Optional[float], float] = (None, 0.0)):
        super().__init__()
        self.dynamics = dynamics
        self.atom_nf = atom_nf
        self.residue_nf = residue_nf
        self.n_dims = n_dims
        self.T = timesteps
        self.norm_values = tuple(norm_values)
        self.norm_biases = tuple(norm_biases)
        self.size_distribution = size_distribution
        # derived from the config, so not part of the state_dict
        self.register_buffer("gamma_table", torch.as_tensor(sched.gamma_table(
            noise_schedule, timesteps, noise_precision)), persistent=False)
        self._check_norm_values()

    def _check_norm_values(self, num_stdevs: int = 8):
        """Guard against the categorical normalization washing out."""
        sigma_0 = float(sched.sigma(self.gamma_table[0]))
        if sigma_0 * num_stdevs > 1.0 / self.norm_values[1]:
            raise ValueError(
                f"Normalization value {self.norm_values[1]} probably too large "
                f"with sigma_0 {sigma_0:.5f}")

    # ----------------------------------------------------------------- basics
    def gamma(self, t: torch.Tensor) -> torch.Tensor:
        """gamma at normalized time t in [0, 1]: one gather from the table."""
        return self.gamma_table[torch.round(t * self.T).long()]

    def normalize(self, pocket: Batch) -> Batch:
        """x /= norm_x; one_hot = (one_hot - bias) / norm_h."""
        out = dict(pocket)
        out["x"] = pocket["x"] / self.norm_values[0]
        out["one_hot"] = (pocket["one_hot"].float() - self.norm_biases[1]) \
            / self.norm_values[1]
        return out

    def unnormalize(self, x, h_cat):
        return (x * self.norm_values[0],
                h_cat * self.norm_values[1] + self.norm_biases[1])

    def sample_gaussian(self, generator: torch.Generator, shape, mask):
        """Every Gaussian draw of the sampler; overridable for tests."""
        return torch.randn(shape, generator=generator, device=mask.device,
                           dtype=torch.float32) * mask[..., None]

    def sample_normal_zero_com(self, generator, mu_lig, xh_pkt, sigma, m_l, m_p):
        """Sample the ligand normal and re-project to the ligand-CoM-free frame."""
        B, NL = m_l.shape
        eps = self.sample_gaussian(generator, (B, NL, self.n_dims + self.atom_nf), m_l)
        out_lig = (mu_lig + sigma * eps) * m_l[..., None]
        nd = self.n_dims
        x_l, x_p = remove_mean_conditional(out_lig[..., :nd], xh_pkt[..., :nd], m_l, m_p)
        out_lig = torch.cat([x_l * m_l[..., None], out_lig[..., nd:]], -1)
        xh_pkt = torch.cat([x_p * m_p[..., None], xh_pkt[..., nd:]], -1)
        return out_lig, xh_pkt

    # --------------------------------------------------------------- sampling
    def _prior_sample(self, generator, pocket: Batch, lig_mask):
        """z_T ~ N(pocket CoM, I), re-projected."""
        B, NL = lig_mask.shape
        mu_x = masked_mean(pocket["x"], pocket["mask"])
        mu = torch.cat([mu_x[:, None, :].expand(B, NL, self.n_dims),
                        torch.zeros((B, NL, self.atom_nf), device=lig_mask.device)], -1)
        sigma = torch.ones((B, 1, 1), device=lig_mask.device)
        return self.sample_normal_zero_com(generator, mu * lig_mask[..., None],
                                           _xh(pocket), sigma, lig_mask,
                                           pocket["mask"])

    def _denoise_step(self, generator, z_lig, xh_pkt, m_l, m_p, s_norm,
                      t_norm, shared_pocket: bool = False):
        """One ligand ancestral step z_t -> z_s."""
        gamma_s = self.gamma(s_norm)
        gamma_t = self.gamma(t_norm)
        sigma2_tgs, sigma_tgs, alpha_tgs = sched.sigma_and_alpha_t_given_s(
            gamma_t, gamma_s)
        sigma_s = sched.sigma(gamma_s)[:, None, :]
        sigma_t = sched.sigma(gamma_t)[:, None, :]
        eps_lig, _ = self.dynamics(z_lig, xh_pkt, t_norm, m_l, m_p,
                                   shared_pocket=shared_pocket)
        coef = (sigma2_tgs / alpha_tgs / sigma_t[:, :, 0])[:, None, :]
        mu_lig = z_lig / alpha_tgs[:, None, :] - coef * eps_lig
        sigma = sigma_tgs[:, None, :] * sigma_s / sigma_t
        return self.sample_normal_zero_com(generator, mu_lig, xh_pkt, sigma, m_l, m_p)

    def sample_p_xh_given_z0(self, generator, z0_lig, xh_pkt, m_l, m_p):
        """Final decode: x from p(x | z_0), atom types by argmax."""
        B = z0_lig.shape[0]
        nd = self.n_dims
        t_zeros = torch.zeros((B, 1), device=z0_lig.device)
        gamma_0 = self.gamma(t_zeros)
        sigma_x = sched.snr(-0.5 * gamma_0)[:, None, :]
        net_lig, _ = self.dynamics(z0_lig, xh_pkt, t_zeros, m_l, m_p)
        alpha_0 = sched.alpha(gamma_0)[:, None, :]
        sigma_0 = sched.sigma(gamma_0)[:, None, :]
        mu_lig = 1.0 / alpha_0 * (z0_lig - sigma_0 * net_lig)
        xh_lig, xh_pkt = self.sample_normal_zero_com(generator, mu_lig, xh_pkt,
                                                     sigma_x, m_l, m_p)
        x_lig, h_lig = self.unnormalize(xh_lig[..., :nd], z0_lig[..., nd:])
        x_pkt, h_pkt = self.unnormalize(xh_pkt[..., :nd], xh_pkt[..., nd:])
        h_lig = nn.functional.one_hot(h_lig.argmax(-1), self.atom_nf).float() \
            * m_l[..., None]
        return x_lig * m_l[..., None], h_lig, x_pkt * m_p[..., None], h_pkt

    @torch.no_grad()
    def sample_given_pocket(self, generator: torch.Generator, pocket: Batch,
                            lig_mask, timesteps: Optional[int] = None,
                            shared_pocket: bool = False):
        """Pocket-conditional generation: prior draw, ``timesteps`` ancestral
        steps, decode.  ``shared_pocket``: every row of the batch holds the
        same pocket (see EGNNDynamics.forward).  Returns (xh_lig, xh_pkt)."""
        timesteps = self.T if timesteps is None else timesteps
        pocket = self.normalize(pocket)
        B = lig_mask.shape[0]
        m_p = pocket["mask"]
        z_lig, xh_pkt = self._prior_sample(generator, pocket, lig_mask)
        for s in range(timesteps - 1, -1, -1):
            s_arr = torch.full((B, 1), s, dtype=torch.float32,
                               device=lig_mask.device) / timesteps
            t_arr = torch.full((B, 1), s + 1, dtype=torch.float32,
                               device=lig_mask.device) / timesteps
            z_lig, xh_pkt = self._denoise_step(generator, z_lig, xh_pkt,
                                               lig_mask, m_p, s_arr, t_arr,
                                               shared_pocket=shared_pocket)
        x_lig, h_lig, x_pkt, h_pkt = self.sample_p_xh_given_z0(
            generator, z_lig, xh_pkt, lig_mask, m_p)
        # final CoG re-projection
        x_lig, x_pkt = remove_mean_conditional(x_lig, x_pkt, lig_mask, m_p)
        x_lig = x_lig * lig_mask[..., None]
        return torch.cat([x_lig, h_lig], -1), torch.cat([x_pkt, h_pkt], -1)
