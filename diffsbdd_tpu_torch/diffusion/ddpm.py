"""Pocket-conditional E(3)-equivariant DDPM over padded ligand/pocket graphs:
``ConditionalDDPM`` with its training loss terms and its sampler.

Batches are padded dicts ``{'x': (B,N,3), 'one_hot': (B,N,A), 'mask': (B,N),
'size': (B,)}``.  Every Gaussian draw goes through ``sample_gaussian`` and the
timestep draw of the loss through ``sample_timesteps``; both draw from an
explicit ``torch.Generator``, and tests override them to feed recorded
streams.  A chain of T steps draws 1 prior, T step and 1 decode array; a
training loss draws the timesteps and 1 array, an evaluation loss 2.  The
joint model, inpainting and diversify are not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from diffsbdd_tpu_torch.diffusion import schedule as sched
from diffsbdd_tpu_torch.diffusion.size_prior import SizeDistribution
from diffsbdd_tpu_torch.geom.com import remove_mean_conditional
from diffsbdd_tpu_torch.ops.masked import masked_mean, sum_except_batch

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
                 noise_precision: float = 1e-4, loss_type: str = "l2",
                 norm_values: Tuple[float, float] = (1.0, 1.0),
                 norm_biases: Tuple[Optional[float], float] = (None, 0.0),
                 virtual_node_idx: Optional[int] = None):
        super().__init__()
        if loss_type not in {"vlb", "l2"}:
            raise ValueError(loss_type)
        if noise_schedule == "learned" and loss_type != "vlb":
            raise ValueError("a learned schedule requires the vlb objective")
        self.dynamics = dynamics
        self.atom_nf = atom_nf
        self.residue_nf = residue_nf
        self.n_dims = n_dims
        self.T = timesteps
        self.loss_type = loss_type
        self.norm_values = tuple(norm_values)
        self.norm_biases = tuple(norm_biases)
        self.size_distribution = size_distribution
        self.vnode_idx = virtual_node_idx
        # a device anchor that is there whatever the schedule
        self.register_buffer("_anchor", torch.zeros(()), persistent=False)
        if noise_schedule == "learned":
            self.gamma_net = sched.GammaNetwork()
            self.gamma_table = None
        else:
            self.gamma_net = None
            # derived from the config, so not part of the state_dict
            self.register_buffer("gamma_table", torch.as_tensor(sched.gamma_table(
                noise_schedule, timesteps, noise_precision)), persistent=False)
            self._check_norm_values()

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def _check_norm_values(self, num_stdevs: int = 8):
        """Guard against the categorical normalization washing out."""
        sigma_0 = float(sched.sigma(self.gamma_table[0]))
        if sigma_0 * num_stdevs > 1.0 / self.norm_values[1]:
            raise ValueError(
                f"Normalization value {self.norm_values[1]} probably too large "
                f"with sigma_0 {sigma_0:.5f}")

    # ----------------------------------------------------------------- basics
    def gamma(self, t: torch.Tensor) -> torch.Tensor:
        """gamma at normalized time t in [0, 1]: one gather from the table,
        or the learned network."""
        if self.gamma_net is not None:
            return self.gamma_net(t)
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

    def sample_timesteps(self, generator: torch.Generator, batch_size: int,
                         lowest_t: int) -> torch.Tensor:
        """The loss's integer timesteps, uniform on [lowest_t, T], as a
        (B, 1) float tensor; overridable for tests."""
        return torch.randint(lowest_t, self.T + 1, (batch_size, 1),
                             generator=generator, device=self.device).float()

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

    # ------------------------------------------------------------------- loss
    def subspace_dimensionality(self, input_size: torch.Tensor) -> torch.Tensor:
        """(N - 1) * d on the translation-invariant subspace."""
        return (input_size - 1) * self.n_dims

    @staticmethod
    def gaussian_kl(mu_norm2, q_sigma, p_sigma, d):
        """KL(N(mu_q, q_sigma) || N(0, p_sigma)) in dimension d."""
        return (d * torch.log(p_sigma / q_sigma)
                + 0.5 * (d * q_sigma ** 2 + mu_norm2) / (p_sigma ** 2)
                - 0.5 * d)

    def xh_given_zt_and_epsilon(self, z_t, eps, gamma_t, mask):
        """The denoised estimate from z_t and the predicted epsilon."""
        alpha_t = sched.alpha(gamma_t)[:, None, :]
        sigma_t = sched.sigma(gamma_t)[:, None, :]
        return (z_t / alpha_t - eps * sigma_t / alpha_t) * mask[..., None]

    def delta_log_px(self, num_nodes: torch.Tensor) -> torch.Tensor:
        return -self.subspace_dimensionality(num_nodes) * math.log(self.norm_values[0])

    def log_constants_p_x_given_z0(self, n_nodes: torch.Tensor, batch_size: int):
        """The constant part of log p(x | z0)."""
        degrees_of_freedom_x = self.subspace_dimensionality(n_nodes)
        gamma_0 = self.gamma(torch.zeros((batch_size, 1), device=self.device))
        log_sigma_x = 0.5 * gamma_0[:, 0]
        return degrees_of_freedom_x * (-log_sigma_x - 0.5 * math.log(2 * math.pi))

    def _log_ph_cat(self, one_hot_norm, z_h, sigma_0_cat, mask, epsilon=1e-10):
        """Discretized-Gaussian categorical likelihood, summed per graph:
        integrate N(z_h, sigma_0_cat) over [h - 0.5, h + 0.5] around the
        one-hot peak, normalize over classes, pick the true class."""
        one_hot = one_hot_norm * self.norm_values[1] + self.norm_biases[1]
        estimated = z_h * self.norm_values[1] + self.norm_biases[1]
        centered = estimated - 1.0
        s = sigma_0_cat[:, None, :]
        # clamped at 0: float32 erf is not monotone at ulp level in the
        # saturated tails, so the difference can come out at -1e-8 and NaN
        # the log
        prob_mass = torch.clamp(
            sched.cdf_standard_gaussian((centered + 0.5) / s)
            - sched.cdf_standard_gaussian((centered - 0.5) / s), min=0.0)
        log_ph_prop = torch.log(prob_mass + epsilon)
        log_probs = log_ph_prop - torch.logsumexp(log_ph_prop, dim=-1, keepdim=True)
        return sum_except_batch(log_probs * one_hot, mask)

    def noised_representation(self, generator, xh_lig, xh_pkt, m_l, m_p, gamma_t):
        """q(z_t | x) for the ligand only, re-projected."""
        alpha_t = sched.alpha(gamma_t)[:, None, :]
        sigma_t = sched.sigma(gamma_t)[:, None, :]
        B, NL = m_l.shape
        eps = self.sample_gaussian(generator, (B, NL, self.n_dims + self.atom_nf), m_l)
        z_lig = (alpha_t * xh_lig + sigma_t * eps) * m_l[..., None]
        nd = self.n_dims
        x_l, x_p = remove_mean_conditional(z_lig[..., :nd], xh_pkt[..., :nd], m_l, m_p)
        z_lig = torch.cat([x_l * m_l[..., None], z_lig[..., nd:]], -1)
        xh_pkt = torch.cat([x_p * m_p[..., None], xh_pkt[..., nd:]], -1)
        return z_lig, xh_pkt, eps

    def kl_prior(self, xh_lig, lig: Batch) -> torch.Tensor:
        """Ligand-only KL(q(z_T | x) || N(0, 1))."""
        B = xh_lig.shape[0]
        gamma_T = self.gamma(torch.ones((B, 1), device=xh_lig.device))
        mu = sched.alpha(gamma_T)[:, None, :] * xh_lig
        sigma_T = sched.sigma(gamma_T)[:, 0]
        nd = self.n_dims
        ones = torch.ones_like(sigma_T)
        mu_norm2_h = sum_except_batch(mu[..., nd:] ** 2, lig["mask"])
        kl_h = self.gaussian_kl(mu_norm2_h, sigma_T, ones, d=1.0)
        mu_norm2_x = sum_except_batch(mu[..., :nd] ** 2, lig["mask"])
        d_x = self.subspace_dimensionality(lig["size"])
        return self.gaussian_kl(mu_norm2_x, sigma_T, ones, d_x) + kl_h

    def _is_virtual(self, ligand: Batch) -> torch.Tensor:
        return (ligand["one_hot"][..., self.vnode_idx] > 0).float()[..., None]

    def log_pxh_given_z0_without_constants(self, ligand: Batch, z0_lig, eps_lig,
                                           net_lig, gamma_0, epsilon=1e-10):
        nd = self.n_dims
        sigma_0_cat = sched.sigma(gamma_0) * self.norm_values[1]
        sq_err = (eps_lig[..., :nd] - net_lig[..., :nd]) ** 2
        if self.vnode_idx is not None:
            # virtual-node coordinates do not contribute
            sq_err = sq_err * (1.0 - self._is_virtual(ligand))
        log_px = -0.5 * sum_except_batch(sq_err, ligand["mask"])
        log_ph = self._log_ph_cat(ligand["one_hot"], z0_lig[..., nd:], sigma_0_cat,
                                  ligand["mask"], epsilon)
        return log_px, log_ph

    def loss_terms(self, generator, ligand: Batch, pocket: Batch,
                   training: bool) -> Dict[str, Any]:
        """Every ingredient of the VLB / L2 loss, per graph; the weighting
        happens in ``LigandPocketDDPM.loss_fn``."""
        ligand, pocket = self.normalize(ligand), self.normalize(pocket)
        B = ligand["x"].shape[0]
        nd = self.n_dims
        m_l, m_p = ligand["mask"], pocket["mask"]

        delta_log_px = self.delta_log_px(ligand["size"])

        t_int = self.sample_timesteps(generator, B, 0 if training else 1)
        s_int = t_int - 1
        t_is_zero = (t_int == 0).float()
        t_is_not_zero = 1.0 - t_is_zero
        s = s_int / self.T
        t = t_int / self.T
        gamma_s = self.gamma(s)
        gamma_t = self.gamma(t)

        xh0_lig, xh0_pkt = _xh(ligand), _xh(pocket)
        # centre the input on the ligand CoM
        x_l, x_p = remove_mean_conditional(xh0_lig[..., :nd], xh0_pkt[..., :nd], m_l, m_p)
        xh0_lig = torch.cat([x_l * m_l[..., None], xh0_lig[..., nd:]], -1)
        xh0_pkt = torch.cat([x_p * m_p[..., None], xh0_pkt[..., nd:]], -1)

        z_t_lig, xh_pkt, eps_lig = self.noised_representation(
            generator, xh0_lig, xh0_pkt, m_l, m_p, gamma_t)
        # zero_nan in training: one numerical blow-up corrupts a step instead
        # of poisoning the parameters
        net_lig, _ = self.dynamics(z_t_lig, xh_pkt, t, m_l, m_p, zero_nan=training)

        xh_lig_hat = self.xh_given_zt_and_epsilon(z_t_lig, net_lig, gamma_t, m_l)

        sq_err = (eps_lig - net_lig) ** 2
        if self.vnode_idx is not None:
            coord_scale = 1.0 - self._is_virtual(ligand)
            sq_err = torch.cat([sq_err[..., :nd] * coord_scale, sq_err[..., nd:]], -1)
        error_t_lig = sum_except_batch(sq_err, m_l)

        snr_weight = (1 - sched.snr(gamma_s - gamma_t))[:, 0]
        neg_log_constants = -self.log_constants_p_x_given_z0(ligand["size"], B)
        kl_prior = self.kl_prior(xh0_lig, ligand)

        if training:
            log_px, log_ph = self.log_pxh_given_z0_without_constants(
                ligand, z_t_lig, eps_lig, net_lig, gamma_t)
            loss_0_x_lig = -log_px * t_is_zero[:, 0]
            loss_0_h = -log_ph * t_is_zero[:, 0]
            error_t_lig = error_t_lig * t_is_not_zero[:, 0]
        else:
            t_zeros = torch.zeros_like(s)
            gamma_0 = self.gamma(t_zeros)
            z_0_lig, xh_pkt0, eps_0 = self.noised_representation(
                generator, xh0_lig, xh0_pkt, m_l, m_p, gamma_0)
            net_0, _ = self.dynamics(z_0_lig, xh_pkt0, t_zeros, m_l, m_p)
            log_px, log_ph = self.log_pxh_given_z0_without_constants(
                ligand, z_0_lig, eps_0, net_0, gamma_0)
            loss_0_x_lig = -log_px
            loss_0_h = -log_ph

        log_pn = self.size_distribution.log_prob_n1_given_n2(
            ligand["size"], pocket["size"])

        info = {
            "eps_hat_lig_x": masked_mean(
                net_lig[..., :nd].abs().mean(-1, keepdim=True), m_l).mean(),
            "eps_hat_lig_h": masked_mean(
                net_lig[..., nd:].abs().mean(-1, keepdim=True), m_l).mean(),
        }
        zero = torch.zeros_like(error_t_lig)
        return dict(
            delta_log_px=delta_log_px,
            error_t_lig=error_t_lig, error_t_pocket=zero,
            SNR_weight=snr_weight,
            loss_0_x_ligand=loss_0_x_lig, loss_0_x_pocket=zero,
            loss_0_h=loss_0_h, neg_log_constants=neg_log_constants,
            kl_prior=kl_prior, log_pN=log_pn, t_int=t_int[:, 0],
            xh_lig_hat=xh_lig_hat, info=info)

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
