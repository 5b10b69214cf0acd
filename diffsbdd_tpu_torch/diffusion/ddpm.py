"""E(3)-equivariant DDPMs over padded ligand/pocket graphs: ``JointDDPM``
(ligand and pocket diffuse together), ``ConditionalDDPM`` (only the ligand
diffuses, the pocket is fixed context) and ``SimpleConditionalDDPM`` (the
conditional model without the centre-of-mass subspace), each with its training
loss terms, its sampler, a chain sampler that keeps frames for visualization
(``sample_chain``, ``sample_given_pocket_chain``) and its RePaint inpainting;
the conditional models also ``diversify``.

Batches are padded dicts ``{'x': (B,N,3), 'one_hot': (B,N,A), 'mask': (B,N),
'size': (B,)}``.  Every Gaussian draw goes through ``sample_gaussian`` and the
timestep draw of the loss through ``sample_timesteps``; both draw from an
explicit ``torch.Generator``, and tests override them to feed recorded
streams.  The conditional models draw one ligand array at a time: a chain of
T steps draws 1 prior, T step and 1 decode array; a training loss draws the
timesteps and 1 array, an evaluation loss 2.  The joint model draws four
arrays at a time (``sample_combined_noise``: ligand coordinates, pocket
coordinates, ligand features, pocket features).  Every sampling loop is a
Python loop over single steps, so one method serves where the JAX package
keeps a scanned and a segmented twin.  The samplers ask the network for the
whole-block kernel (``block_fuse=True``); the losses never do.  Each network
pass of a sampler, with the sampler's own work around it, and each decode is
a ``sampler.pass`` span (``utils.profiling.span``: recorded while a profiler
records).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from diffsbdd_tpu_torch.diffusion import schedule as sched
from diffsbdd_tpu_torch.diffusion.size_prior import SizeDistribution
from diffsbdd_tpu_torch.geom import com
from diffsbdd_tpu_torch.ops.masked import masked_mean, masked_sum, sum_except_batch
from diffsbdd_tpu_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


def num_nodes_to_mask(num_nodes: np.ndarray, n_max: int) -> np.ndarray:
    """Host-side: (B,) node counts -> (B, n_max) validity mask."""
    num_nodes = np.asarray(num_nodes)
    return (np.arange(n_max)[None, :] < num_nodes[:, None]).astype(np.float32)


def _xh(d: Batch) -> torch.Tensor:
    return torch.cat([d["x"], d["one_hot"]], dim=-1)


def _shift_x(xh, delta, mask, nd):
    """``xh`` with ``delta`` (B, nd) added to the coordinates of valid nodes."""
    return torch.cat([xh[..., :nd] + delta[:, None, :] * mask[..., None],
                      xh[..., nd:]], -1)


def _frame_stride(timesteps: int, return_frames: int) -> int:
    """Steps between two kept frames of a chain."""
    if not (0 < return_frames <= timesteps) or timesteps % return_frames:
        raise ValueError(f"return_frames {return_frames} must divide "
                         f"timesteps {timesteps}")
    return timesteps // return_frames


def _full(B, value, device, scale=1.0):
    return torch.full((B, 1), float(value), dtype=torch.float32,
                      device=device) / scale


class DDPMBase(nn.Module):
    """What the three models share: the schedule, normalization, the
    likelihood pieces and the noise source."""

    def __init__(self, dynamics: nn.Module, atom_nf: int, residue_nf: int,
                 n_dims: int, size_distribution: Optional[SizeDistribution],
                 timesteps: int = 1000, noise_schedule: str = "learned",
                 noise_precision: float = 1e-4, loss_type: str = "vlb",
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

    def unnormalize_z(self, z):
        x, h = self.unnormalize(z[..., :self.n_dims], z[..., self.n_dims:])
        return torch.cat([x, h], -1)

    def _project(self, xh_lig, xh_pkt, m_l, m_p):
        """The coordinates of both domains through the model's ``remove_mean``
        (the subclass's centre-of-mass convention), padded nodes zeroed."""
        nd = self.n_dims
        x_l, x_p = self.remove_mean(xh_lig[..., :nd], xh_pkt[..., :nd], m_l, m_p)
        return (torch.cat([x_l * m_l[..., None], xh_lig[..., nd:]], -1),
                torch.cat([x_p * m_p[..., None], xh_pkt[..., nd:]], -1))

    # ------------------------------------------------------- likelihood pieces
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


class JointDDPM(DDPMBase):
    """Ligand and pocket diffuse together, in the frame whose origin is the
    centre of mass of the combined system."""

    @staticmethod
    def remove_mean(x_lig, x_pkt, m_l, m_p):
        return com.remove_mean_joint(x_lig, x_pkt, m_l, m_p)

    def sample_combined_noise(self, generator, m_l, m_p):
        """CoM-free positional noise and iid feature noise for both domains;
        four draws: ligand x, pocket x, ligand h, pocket h."""
        B, NL = m_l.shape
        NP = m_p.shape[1]
        ex_l = self.sample_gaussian(generator, (B, NL, self.n_dims), m_l)
        ex_p = self.sample_gaussian(generator, (B, NP, self.n_dims), m_p)
        ex_l, ex_p = self.remove_mean(ex_l, ex_p, m_l, m_p)
        ex_l = ex_l * m_l[..., None]
        ex_p = ex_p * m_p[..., None]
        eh_l = self.sample_gaussian(generator, (B, NL, self.atom_nf), m_l)
        eh_p = self.sample_gaussian(generator, (B, NP, self.residue_nf), m_p)
        return torch.cat([ex_l, eh_l], -1), torch.cat([ex_p, eh_p], -1)

    def noised_representation(self, generator, xh_lig, xh_pkt, m_l, m_p, gamma_t):
        """q(z_t | x) for both domains."""
        alpha_t = sched.alpha(gamma_t)[:, None, :]
        sigma_t = sched.sigma(gamma_t)[:, None, :]
        eps_lig, eps_pkt = self.sample_combined_noise(generator, m_l, m_p)
        z_lig = (alpha_t * xh_lig + sigma_t * eps_lig) * m_l[..., None]
        z_pkt = (alpha_t * xh_pkt + sigma_t * eps_pkt) * m_p[..., None]
        return z_lig, z_pkt, eps_lig, eps_pkt

    # ------------------------------------------------------------------- loss
    def kl_prior(self, xh_lig, xh_pkt, lig: Batch, pkt: Batch) -> torch.Tensor:
        """KL(q(z_T | x) || N(0, 1)) over both domains."""
        B = xh_lig.shape[0]
        gamma_T = self.gamma(torch.ones((B, 1), device=xh_lig.device))
        alpha_T = sched.alpha(gamma_T)[:, None, :]
        mu_l, mu_p = alpha_T * xh_lig, alpha_T * xh_pkt
        sigma_T = sched.sigma(gamma_T)[:, 0]
        nd = self.n_dims
        ones = torch.ones_like(sigma_T)
        mu_norm2_h = (sum_except_batch(mu_l[..., nd:] ** 2, lig["mask"])
                      + sum_except_batch(mu_p[..., nd:] ** 2, pkt["mask"]))
        kl_h = self.gaussian_kl(mu_norm2_h, sigma_T, ones, d=1.0)
        mu_norm2_x = (sum_except_batch(mu_l[..., :nd] ** 2, lig["mask"])
                      + sum_except_batch(mu_p[..., :nd] ** 2, pkt["mask"]))
        d_x = self.subspace_dimensionality(lig["size"] + pkt["size"])
        return self.gaussian_kl(mu_norm2_x, sigma_T, ones, d_x) + kl_h

    def log_pxh_given_z0_without_constants(self, ligand: Batch, z0_lig, eps_lig,
                                           net_lig, pocket: Batch, z0_pkt, eps_pkt,
                                           net_pkt, gamma_0, epsilon=1e-10):
        nd = self.n_dims
        sigma_0_cat = sched.sigma(gamma_0) * self.norm_values[1]
        log_px_lig = -0.5 * sum_except_batch(
            (eps_lig[..., :nd] - net_lig[..., :nd]) ** 2, ligand["mask"])
        log_px_pkt = -0.5 * sum_except_batch(
            (eps_pkt[..., :nd] - net_pkt[..., :nd]) ** 2, pocket["mask"])
        log_ph = (self._log_ph_cat(ligand["one_hot"], z0_lig[..., nd:], sigma_0_cat,
                                   ligand["mask"], epsilon)
                  + self._log_ph_cat(pocket["one_hot"], z0_pkt[..., nd:], sigma_0_cat,
                                     pocket["mask"], epsilon))
        return log_px_lig, log_px_pkt, log_ph

    def loss_terms(self, generator, ligand: Batch, pocket: Batch,
                   training: bool) -> Dict[str, Any]:
        """Every ingredient of the VLB / L2 loss, per graph; the weighting
        happens in ``LigandPocketDDPM.loss_fn``."""
        ligand, pocket = self.normalize(ligand), self.normalize(pocket)
        B = ligand["x"].shape[0]
        nd = self.n_dims
        m_l, m_p = ligand["mask"], pocket["mask"]
        num_nodes = ligand["size"] + pocket["size"]

        delta_log_px = self.delta_log_px(num_nodes)

        t_int = self.sample_timesteps(generator, B, 0 if training else 1)
        s_int = t_int - 1
        t_is_zero = (t_int == 0).float()
        t_is_not_zero = 1.0 - t_is_zero
        s = s_int / self.T
        t = t_int / self.T
        gamma_s = self.gamma(s)
        gamma_t = self.gamma(t)

        xh_lig, xh_pkt = _xh(ligand), _xh(pocket)
        z_t_lig, z_t_pkt, eps_lig, eps_pkt = self.noised_representation(
            generator, xh_lig, xh_pkt, m_l, m_p, gamma_t)
        # zero_nan in training: one numerical blow-up corrupts a step instead
        # of poisoning the parameters
        net_lig, net_pkt = self.dynamics(z_t_lig, z_t_pkt, t, m_l, m_p,
                                         zero_nan=training)

        xh_lig_hat = self.xh_given_zt_and_epsilon(z_t_lig, net_lig, gamma_t, m_l)

        error_t_lig = sum_except_batch((eps_lig - net_lig) ** 2, m_l)
        error_t_pkt = sum_except_batch((eps_pkt - net_pkt) ** 2, m_p)

        snr_weight = (1 - sched.snr(gamma_s - gamma_t))[:, 0]
        neg_log_constants = -self.log_constants_p_x_given_z0(num_nodes, B)
        kl_prior = self.kl_prior(xh_lig, xh_pkt, ligand, pocket)

        if training:
            log_px_lig, log_px_pkt, log_ph = self.log_pxh_given_z0_without_constants(
                ligand, z_t_lig, eps_lig, net_lig,
                pocket, z_t_pkt, eps_pkt, net_pkt, gamma_t)
            loss_0_x_lig = -log_px_lig * t_is_zero[:, 0]
            loss_0_x_pkt = -log_px_pkt * t_is_zero[:, 0]
            loss_0_h = -log_ph * t_is_zero[:, 0]
            error_t_lig = error_t_lig * t_is_not_zero[:, 0]
            error_t_pkt = error_t_pkt * t_is_not_zero[:, 0]
        else:
            t_zeros = torch.zeros_like(s)
            gamma_0 = self.gamma(t_zeros)
            z_0_lig, z_0_pkt, eps_0_lig, eps_0_pkt = self.noised_representation(
                generator, xh_lig, xh_pkt, m_l, m_p, gamma_0)
            net_0_lig, net_0_pkt = self.dynamics(z_0_lig, z_0_pkt, t_zeros, m_l, m_p)
            log_px_lig, log_px_pkt, log_ph = self.log_pxh_given_z0_without_constants(
                ligand, z_0_lig, eps_0_lig, net_0_lig,
                pocket, z_0_pkt, eps_0_pkt, net_0_pkt, gamma_0)
            loss_0_x_lig = -log_px_lig
            loss_0_x_pkt = -log_px_pkt
            loss_0_h = -log_ph

        log_pn = self.size_distribution.log_prob(ligand["size"], pocket["size"])

        def mean_abs(net, mask, sl):
            return masked_mean(net[..., sl].abs().mean(-1, keepdim=True), mask).mean()

        info = {
            "eps_hat_lig_x": mean_abs(net_lig, m_l, slice(None, nd)),
            "eps_hat_lig_h": mean_abs(net_lig, m_l, slice(nd, None)),
            "eps_hat_pocket_x": mean_abs(net_pkt, m_p, slice(None, nd)),
            "eps_hat_pocket_h": mean_abs(net_pkt, m_p, slice(nd, None)),
        }
        return dict(
            delta_log_px=delta_log_px,
            error_t_lig=error_t_lig, error_t_pocket=error_t_pkt,
            SNR_weight=snr_weight,
            loss_0_x_ligand=loss_0_x_lig, loss_0_x_pocket=loss_0_x_pkt,
            loss_0_h=loss_0_h, neg_log_constants=neg_log_constants,
            kl_prior=kl_prior, log_pN=log_pn, t_int=t_int[:, 0],
            xh_lig_hat=xh_lig_hat, info=info)

    # --------------------------------------------------------------- sampling
    def _denoise_step(self, generator, z_lig, z_pkt, m_l, m_p, s_norm, t_norm):
        """One ancestral step z_t -> z_s for both domains."""
        gamma_s = self.gamma(s_norm)
        gamma_t = self.gamma(t_norm)
        sigma2_tgs, sigma_tgs, alpha_tgs = sched.sigma_and_alpha_t_given_s(
            gamma_t, gamma_s)
        sigma_s = sched.sigma(gamma_s)[:, None, :]
        sigma_t = sched.sigma(gamma_t)[:, None, :]
        eps_lig, eps_pkt = self.dynamics(z_lig, z_pkt, t_norm, m_l, m_p,
                                         block_fuse=True)
        coef = (sigma2_tgs / alpha_tgs / sigma_t[:, :, 0])[:, None, :]
        mu_lig = z_lig / alpha_tgs[:, None, :] - coef * eps_lig
        mu_pkt = z_pkt / alpha_tgs[:, None, :] - coef * eps_pkt
        sigma = sigma_tgs[:, None, :] * sigma_s / sigma_t
        noise_lig, noise_pkt = self.sample_combined_noise(generator, m_l, m_p)
        zs_lig = (mu_lig + sigma * noise_lig) * m_l[..., None]
        zs_pkt = (mu_pkt + sigma * noise_pkt) * m_p[..., None]
        return self._project(zs_lig, zs_pkt, m_l, m_p)

    def _noise_step(self, generator, z_lig, z_pkt, m_l, m_p, gamma_t, gamma_s):
        """One forward jump z_s -> z_t."""
        _, sigma_tgs, alpha_tgs = sched.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        noise_lig, noise_pkt = self.sample_combined_noise(generator, m_l, m_p)
        zt_lig = (alpha_tgs[:, None, :] * z_lig
                  + sigma_tgs[:, None, :] * noise_lig) * m_l[..., None]
        zt_pkt = (alpha_tgs[:, None, :] * z_pkt
                  + sigma_tgs[:, None, :] * noise_pkt) * m_p[..., None]
        return self._project(zt_lig, zt_pkt, m_l, m_p)

    def sample_p_xh_given_z0(self, generator, z0_lig, z0_pkt, m_l, m_p):
        """Final decode: x from p(x | z_0), types of both domains by argmax."""
        B = z0_lig.shape[0]
        nd = self.n_dims
        t_zeros = torch.zeros((B, 1), device=z0_lig.device)
        gamma_0 = self.gamma(t_zeros)
        sigma_x = sched.snr(-0.5 * gamma_0)[:, None, :]
        net_lig, net_pkt = self.dynamics(z0_lig, z0_pkt, t_zeros, m_l, m_p,
                                         block_fuse=True)
        alpha_0 = sched.alpha(gamma_0)[:, None, :]
        sigma_0 = sched.sigma(gamma_0)[:, None, :]
        mu_lig = 1.0 / alpha_0 * (z0_lig - sigma_0 * net_lig)
        mu_pkt = 1.0 / alpha_0 * (z0_pkt - sigma_0 * net_pkt)
        noise_lig, noise_pkt = self.sample_combined_noise(generator, m_l, m_p)
        xh_lig = (mu_lig + sigma_x * noise_lig) * m_l[..., None]
        xh_pkt = (mu_pkt + sigma_x * noise_pkt) * m_p[..., None]
        x_lig, h_lig = self.unnormalize(xh_lig[..., :nd], z0_lig[..., nd:])
        x_pkt, h_pkt = self.unnormalize(xh_pkt[..., :nd], z0_pkt[..., nd:])
        h_lig = nn.functional.one_hot(h_lig.argmax(-1), self.atom_nf).float() \
            * m_l[..., None]
        h_pkt = nn.functional.one_hot(h_pkt.argmax(-1), self.residue_nf).float() \
            * m_p[..., None]
        return x_lig, h_lig, x_pkt, h_pkt

    def _decode(self, generator, z_lig, z_pkt, m_l, m_p):
        """Decode and re-project onto the CoM-free subspace."""
        x_lig, h_lig, x_pkt, h_pkt = self.sample_p_xh_given_z0(
            generator, z_lig, z_pkt, m_l, m_p)
        x_lig, x_pkt = self.remove_mean(x_lig, x_pkt, m_l, m_p)
        return (torch.cat([x_lig * m_l[..., None], h_lig], -1),
                torch.cat([x_pkt * m_p[..., None], h_pkt], -1))

    @torch.no_grad()
    def sample(self, generator: torch.Generator, masks,
               timesteps: Optional[int] = None):
        """Unconditional joint generation; masks = (lig_mask, pocket_mask).
        Returns (xh_lig, xh_pkt)."""
        timesteps = self.T if timesteps is None else timesteps
        m_l, m_p = masks
        B, dev = m_l.shape[0], m_l.device
        z_lig, z_pkt = self.sample_combined_noise(generator, m_l, m_p)
        for s in range(timesteps - 1, -1, -1):
            with span("sampler.pass"):
                z_lig, z_pkt = self._denoise_step(
                    generator, z_lig, z_pkt, m_l, m_p, _full(B, s, dev, timesteps),
                    _full(B, s + 1, dev, timesteps))
        with span("sampler.pass"):
            return self._decode(generator, z_lig, z_pkt, m_l, m_p)

    @torch.no_grad()
    def sample_chain(self, generator: torch.Generator, masks,
                     timesteps: Optional[int] = None, return_frames: int = 1):
        """``sample`` keeping ``return_frames`` states of the chain for
        visualization: (frames_lig, frames_pkt), each (return_frames, B, N,
        D), the unnormalized state after every ``timesteps / return_frames``-th
        step, the last frame replaced by the decoded sample."""
        timesteps = self.T if timesteps is None else timesteps
        stride = _frame_stride(timesteps, return_frames)
        m_l, m_p = masks
        B, dev = m_l.shape[0], m_l.device
        z_lig, z_pkt = self.sample_combined_noise(generator, m_l, m_p)
        frames_lig, frames_pkt = [], []
        for i, s in enumerate(range(timesteps - 1, -1, -1)):
            with span("sampler.pass"):
                z_lig, z_pkt = self._denoise_step(
                    generator, z_lig, z_pkt, m_l, m_p, _full(B, s, dev, timesteps),
                    _full(B, s + 1, dev, timesteps))
                if (i + 1) % stride == 0:
                    frames_lig.append(self.unnormalize_z(z_lig))
                    frames_pkt.append(self.unnormalize_z(z_pkt))
        with span("sampler.pass"):
            frames_lig[-1], frames_pkt[-1] = self._decode(generator, z_lig, z_pkt,
                                                          m_l, m_p)
        return torch.stack(frames_lig), torch.stack(frames_pkt)

    # ------------------------------------------------------------- inpainting
    @staticmethod
    def get_repaint_schedule(resamplings: int, jump_length: int,
                             timesteps: int) -> List[int]:
        """Segment lengths of the RePaint jump schedule."""
        schedule: List[int] = []
        curr_t = 0
        while curr_t < timesteps:
            if curr_t + jump_length < timesteps:
                if len(schedule) > 0:
                    schedule[-1] += jump_length
                    schedule.extend([jump_length] * (resamplings - 1))
                else:
                    schedule.extend([jump_length] * resamplings)
                curr_t += jump_length
            else:
                residual = timesteps - curr_t
                if len(schedule) > 0:
                    schedule[-1] += residual
                else:
                    schedule.append(residual)
                curr_t += residual
        return list(reversed(schedule))

    @classmethod
    def _repaint_plan(cls, resamplings: int, jump_length: int, timesteps: int):
        """The jump schedule flattened into per-iteration (s, jump) arrays:
        iteration k denoises to level s[k] and then jumps jump[k] levels back
        up (0: no jump).  Its length is the number of network passes before
        the decode."""
        schedule = cls.get_repaint_schedule(resamplings, jump_length, timesteps)
        s_list, jump_list = [], []
        s = timesteps - 1
        for i, n_steps in enumerate(schedule):
            for j in range(n_steps):
                s_list.append(s)
                do_jump = (j == n_steps - 1) and (i < len(schedule) - 1)
                jump_list.append(jump_length if do_jump else 0)
                if do_jump:
                    s += jump_length
                s -= 1
        return np.asarray(s_list, np.int32), np.asarray(jump_list, np.int32)

    def _joint_inpaint_prep(self, generator, ligand: Batch, pocket: Batch,
                            lig_fixed, pocket_fixed):
        """Normalize, centre on the CoM of the known nodes, draw the prior."""
        ligand, pocket = self.normalize(ligand), self.normalize(pocket)
        nd = self.n_dims
        m_l, m_p = ligand["mask"], pocket["mask"]
        fixed_l = lig_fixed * m_l
        fixed_p = pocket_fixed * m_p
        total = masked_sum(ligand["x"], fixed_l) + masked_sum(pocket["x"], fixed_p)
        count = fixed_l.sum(1) + fixed_p.sum(1)
        mean_known = total / torch.clamp(count, min=1e-12)[:, None]
        ctx = dict(ligand=ligand, pocket=pocket,
                   xh0_lig=_shift_x(_xh(ligand), -mean_known, m_l, nd),
                   xh0_pkt=_shift_x(_xh(pocket), -mean_known, m_p, nd),
                   lig_fixed=lig_fixed, pocket_fixed=pocket_fixed,
                   fixed_l=fixed_l, fixed_p=fixed_p, count=count)
        z_lig, z_pkt = self.sample_combined_noise(generator, m_l, m_p)
        return ctx, z_lig, z_pkt

    def _joint_repaint_body(self, generator, ctx, timesteps: int, z_lig, z_pkt,
                            s: int, jump: int):
        """One RePaint iteration at level ``s``: the known part re-noised to
        s, the unknown part denoised one step, the two combined, and then the
        jump back by ``jump`` levels if any.  Draws in that order."""
        nd = self.n_dims
        m_l, m_p = ctx["ligand"]["mask"], ctx["pocket"]["mask"]
        lig_fixed, pocket_fixed = ctx["lig_fixed"], ctx["pocket_fixed"]
        B, dev = m_l.shape[0], m_l.device

        def fixed_com(zl, zp):
            tot = masked_sum(zl[..., :nd], ctx["fixed_l"]) \
                + masked_sum(zp[..., :nd], ctx["fixed_p"])
            return tot / torch.clamp(ctx["count"], min=1e-12)[:, None]

        s_norm = _full(B, s, dev, timesteps)
        t_norm = _full(B, s + 1, dev, timesteps)
        gamma_s = self.gamma(s_norm)

        zk_lig, zk_pkt, _, _ = self.noised_representation(
            generator, ctx["xh0_lig"], ctx["xh0_pkt"], m_l, m_p, gamma_s)
        zu_lig, zu_pkt = self._denoise_step(generator, z_lig, z_pkt, m_l, m_p,
                                            s_norm, t_norm)

        # align the CoM of the fixed nodes before combining
        delta = fixed_com(zu_lig, zu_pkt) - fixed_com(zk_lig, zk_pkt)
        zk_lig = _shift_x(zk_lig, delta, m_l, nd)
        zk_pkt = _shift_x(zk_pkt, delta, m_p, nd)

        z_lig = (zk_lig * lig_fixed[..., None]
                 + zu_lig * (1 - lig_fixed[..., None])) * m_l[..., None]
        z_pkt = (zk_pkt * pocket_fixed[..., None]
                 + zu_pkt * (1 - pocket_fixed[..., None])) * m_p[..., None]
        if jump > 0:
            gamma_t = self.gamma(_full(B, s + jump, dev, timesteps))
            z_lig, z_pkt = self._noise_step(generator, z_lig, z_pkt, m_l, m_p,
                                            gamma_t, gamma_s)
        return z_lig, z_pkt

    @torch.no_grad()
    def inpaint(self, generator: torch.Generator, ligand: Batch, pocket: Batch,
                lig_fixed, pocket_fixed, resamplings: int = 1,
                jump_length: int = 1, timesteps: Optional[int] = None):
        """RePaint-style joint inpainting; ``lig_fixed`` / ``pocket_fixed`` are
        (B, N) {0, 1} masks of the clamped nodes.  Returns (xh_lig, xh_pkt)."""
        timesteps = self.T if timesteps is None else timesteps
        ctx, z_lig, z_pkt = self._joint_inpaint_prep(generator, ligand, pocket,
                                                     lig_fixed, pocket_fixed)
        for s, jump in zip(*self._repaint_plan(resamplings, jump_length, timesteps)):
            with span("sampler.pass"):
                z_lig, z_pkt = self._joint_repaint_body(
                    generator, ctx, timesteps, z_lig, z_pkt, int(s), int(jump))
        with span("sampler.pass"):
            return self._decode(generator, z_lig, z_pkt, ctx["ligand"]["mask"],
                                ctx["pocket"]["mask"])


class ConditionalDDPM(DDPMBase):
    """Only the ligand diffuses; the pocket is fixed context whose coordinates
    translate with the ligand-CoM-free frame."""

    @staticmethod
    def remove_mean(x_lig, x_pkt, m_l, m_p):
        return com.remove_mean_conditional(x_lig, x_pkt, m_l, m_p)

    def sample_normal_zero_com(self, generator, mu_lig, xh_pkt, sigma, m_l, m_p):
        """Sample the ligand normal and re-project to the ligand-CoM-free frame."""
        B, NL = m_l.shape
        eps = self.sample_gaussian(generator, (B, NL, self.n_dims + self.atom_nf), m_l)
        out_lig = (mu_lig + sigma * eps) * m_l[..., None]
        return self._project(out_lig, xh_pkt, m_l, m_p)

    def noised_representation(self, generator, xh_lig, xh_pkt, m_l, m_p, gamma_t):
        """q(z_t | x) for the ligand only, re-projected."""
        alpha_t = sched.alpha(gamma_t)[:, None, :]
        sigma_t = sched.sigma(gamma_t)[:, None, :]
        B, NL = m_l.shape
        eps = self.sample_gaussian(generator, (B, NL, self.n_dims + self.atom_nf), m_l)
        z_lig = (alpha_t * xh_lig + sigma_t * eps) * m_l[..., None]
        return (*self._project(z_lig, xh_pkt, m_l, m_p), eps)

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

        # centre the input on the ligand CoM
        xh0_lig, xh0_pkt = self._centered(ligand, pocket)

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
                                   shared_pocket=shared_pocket, block_fuse=True)
        coef = (sigma2_tgs / alpha_tgs / sigma_t[:, :, 0])[:, None, :]
        mu_lig = z_lig / alpha_tgs[:, None, :] - coef * eps_lig
        sigma = sigma_tgs[:, None, :] * sigma_s / sigma_t
        return self.sample_normal_zero_com(generator, mu_lig, xh_pkt, sigma, m_l, m_p)

    def _noise_step(self, generator, zs_lig, xh_pkt, m_l, m_p, gamma_t, gamma_s):
        """One forward step z_s -> z_t."""
        _, sigma_tgs, alpha_tgs = sched.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        return self.sample_normal_zero_com(
            generator, alpha_tgs[:, None, :] * zs_lig, xh_pkt,
            sigma_tgs[:, None, :], m_l, m_p)

    def sample_p_xh_given_z0(self, generator, z0_lig, xh_pkt, m_l, m_p):
        """Final decode: x from p(x | z_0), atom types by argmax."""
        B = z0_lig.shape[0]
        nd = self.n_dims
        t_zeros = torch.zeros((B, 1), device=z0_lig.device)
        gamma_0 = self.gamma(t_zeros)
        sigma_x = sched.snr(-0.5 * gamma_0)[:, None, :]
        net_lig, _ = self.dynamics(z0_lig, xh_pkt, t_zeros, m_l, m_p,
                                   block_fuse=True)
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
        B, dev = lig_mask.shape[0], lig_mask.device
        m_p = pocket["mask"]
        z_lig, xh_pkt = self._prior_sample(generator, pocket, lig_mask)
        for s in range(timesteps - 1, -1, -1):
            with span("sampler.pass"):
                z_lig, xh_pkt = self._denoise_step(
                    generator, z_lig, xh_pkt, lig_mask, m_p,
                    _full(B, s, dev, timesteps), _full(B, s + 1, dev, timesteps),
                    shared_pocket=shared_pocket)
        with span("sampler.pass"):
            x_lig, h_lig, x_pkt, h_pkt = self.sample_p_xh_given_z0(
                generator, z_lig, xh_pkt, lig_mask, m_p)
            # final CoG re-projection
            x_lig, x_pkt = self.remove_mean(x_lig, x_pkt, lig_mask, m_p)
            x_lig = x_lig * lig_mask[..., None]
        return torch.cat([x_lig, h_lig], -1), torch.cat([x_pkt, h_pkt], -1)

    @torch.no_grad()
    def sample_given_pocket_chain(self, generator: torch.Generator, pocket: Batch,
                                 lig_mask, timesteps: Optional[int] = None,
                                 return_frames: int = 1):
        """``sample_given_pocket`` (no shared pocket) keeping
        ``return_frames`` states for visualization, as
        ``JointDDPM.sample_chain`` does; unlike the joint chain, the decoded
        last frame is neither re-projected nor re-masked."""
        timesteps = self.T if timesteps is None else timesteps
        stride = _frame_stride(timesteps, return_frames)
        pocket = self.normalize(pocket)
        B, dev = lig_mask.shape[0], lig_mask.device
        m_p = pocket["mask"]
        z_lig, xh_pkt = self._prior_sample(generator, pocket, lig_mask)
        frames_lig, frames_pkt = [], []
        for i, s in enumerate(range(timesteps - 1, -1, -1)):
            with span("sampler.pass"):
                z_lig, xh_pkt = self._denoise_step(
                    generator, z_lig, xh_pkt, lig_mask, m_p,
                    _full(B, s, dev, timesteps), _full(B, s + 1, dev, timesteps))
                if (i + 1) % stride == 0:
                    frames_lig.append(self.unnormalize_z(z_lig))
                    frames_pkt.append(self.unnormalize_z(xh_pkt))
        with span("sampler.pass"):
            x_lig, h_lig, x_pkt, h_pkt = self.sample_p_xh_given_z0(
                generator, z_lig, xh_pkt, lig_mask, m_p)
        frames_lig[-1] = torch.cat([x_lig, h_lig], -1)
        frames_pkt[-1] = torch.cat([x_pkt, h_pkt], -1)
        return torch.stack(frames_lig), torch.stack(frames_pkt)

    def _centered(self, ligand: Batch, pocket: Batch):
        """(xh0_lig, xh0_pkt) of normalized batches in this model's frame."""
        return self._project(_xh(ligand), _xh(pocket), ligand["mask"], pocket["mask"])

    @torch.no_grad()
    def diversify(self, generator: torch.Generator, ligand: Batch, pocket: Batch,
                  noising_steps: int, shared_pocket: bool = False):
        """Noise the ligand to level ``noising_steps`` and run the reverse
        chain from there: 1 noising, ``noising_steps`` step and 1 decode draw.
        Returns (xh_lig, xh_pkt) in the sampler's frame."""
        ligand, pocket = self.normalize(ligand), self.normalize(pocket)
        B, dev = ligand["x"].shape[0], ligand["x"].device
        m_l, m_p = ligand["mask"], pocket["mask"]
        gamma_t = self.gamma(_full(B, noising_steps, dev, self.T))
        xh0_lig, xh0_pkt = self._centered(ligand, pocket)
        z_lig, xh_pkt, _ = self.noised_representation(
            generator, xh0_lig, xh0_pkt, m_l, m_p, gamma_t)
        for s in range(noising_steps - 1, -1, -1):
            with span("sampler.pass"):
                z_lig, xh_pkt = self._denoise_step(
                    generator, z_lig, xh_pkt, m_l, m_p, _full(B, s, dev, self.T),
                    _full(B, s + 1, dev, self.T), shared_pocket=shared_pocket)
        with span("sampler.pass"):
            x_lig, h_lig, x_pkt, h_pkt = self.sample_p_xh_given_z0(
                generator, z_lig, xh_pkt, m_l, m_p)
        return torch.cat([x_lig, h_lig], -1), torch.cat([x_pkt, h_pkt], -1)

    # ------------------------------------------------------------- inpainting
    def _cond_inpaint_prep(self, generator, ligand: Batch, pocket: Batch,
                           lig_fixed, center: str = "ligand"):
        """Normalize and draw the prior around the CoM of the known part (the
        fixed ligand atoms, or the pocket)."""
        if center not in ("ligand", "pocket"):
            raise NotImplementedError(f"centering option {center}")
        ligand, pocket = self.normalize(ligand), self.normalize(pocket)
        B, NL = ligand["mask"].shape
        m_l, m_p = ligand["mask"], pocket["mask"]
        lf = lig_fixed * m_l
        com_pocket_0 = masked_mean(pocket["x"], m_p)
        if center == "ligand":
            mean_known = masked_sum(ligand["x"], lf) \
                / torch.clamp(lf.sum(1), min=1e-12)[:, None]
        else:
            mean_known = com_pocket_0
        mu = torch.cat([mean_known[:, None, :].expand(B, NL, self.n_dims),
                        torch.zeros((B, NL, self.atom_nf), device=m_l.device)], -1)
        z_lig, xh_pkt = self.sample_normal_zero_com(
            generator, mu * m_l[..., None], _xh(pocket),
            torch.ones((B, 1, 1), device=m_l.device), m_l, m_p)
        ctx = dict(ligand=ligand, m_p=m_p, lf=lf, lig_fixed=lig_fixed,
                   xh0_ligand=_xh(ligand), com_pocket_0=com_pocket_0)
        return ctx, z_lig, xh_pkt

    def _cond_repaint_body(self, generator, ctx, timesteps: int, z_lig, xh_pkt,
                           s: int, renoise: bool, shared_pocket: bool = False):
        """One conditional RePaint iteration at level ``s``: the unknown part
        denoised one step, the known part re-noised to s in the translated
        pocket frame, the two combined, and with ``renoise`` one forward step
        back to s + 1.  Draws in that order.  Returns ((z_lig, xh_pkt), pre)
        with ``pre`` the state before the re-noise (a trajectory frame).

        The pocket is translated per sample here, and ``shared_pocket`` stays
        valid all the same: the pocket-pocket part of the first GCL reads
        distances only."""
        nd = self.n_dims
        ligand = ctx["ligand"]
        m_l, m_p = ligand["mask"], ctx["m_p"]
        lf, lig_fixed = ctx["lf"], ctx["lig_fixed"]
        B, dev = m_l.shape[0], m_l.device
        s_norm = _full(B, s, dev, timesteps)
        t_norm = _full(B, s + 1, dev, timesteps)
        gamma_s = self.gamma(s_norm)
        gamma_t = self.gamma(t_norm)

        z_unknown, xh_pkt = self._denoise_step(
            generator, z_lig, xh_pkt, m_l, m_p, s_norm, t_norm,
            shared_pocket=shared_pocket)

        com_pocket = masked_mean(xh_pkt[..., :nd], m_p)
        x_known = ligand["x"] + (com_pocket - ctx["com_pocket_0"])[:, None, :]
        xh_ligand = torch.cat([x_known * m_l[..., None],
                               ctx["xh0_ligand"][..., nd:]], -1)
        z_known, xh_pkt, _ = self.noised_representation(
            generator, xh_ligand, xh_pkt, m_l, m_p, gamma_s)

        # align the CoM of the fixed nodes, the pocket moving along
        denom = torch.clamp(lf.sum(1), min=1e-12)[:, None]
        dx = masked_sum(z_unknown[..., :nd], lf) / denom \
            - masked_sum(z_known[..., :nd], lf) / denom
        z_known = _shift_x(z_known, dx, m_l, nd)
        xh_pkt = _shift_x(xh_pkt, dx, m_p, nd)

        z_lig = (z_known * lig_fixed[..., None]
                 + z_unknown * (1 - lig_fixed[..., None])) * m_l[..., None]
        pre = (z_lig, xh_pkt)
        if renoise:
            z_lig, xh_pkt = self._noise_step(generator, z_lig, xh_pkt, m_l, m_p,
                                             gamma_t, gamma_s)
        return (z_lig, xh_pkt), pre

    @torch.no_grad()
    def inpaint(self, generator: torch.Generator, ligand: Batch, pocket: Batch,
                lig_fixed, resamplings: int = 1, timesteps: Optional[int] = None,
                center: str = "ligand", return_frames: int = 1,
                shared_pocket: bool = False):
        """Conditional RePaint inpainting: ``timesteps`` levels, each visited
        ``resamplings`` times with a re-noise step between visits;
        ``timesteps * resamplings`` network passes and the decode.

        With ``return_frames`` > 1 the unnormalized state at the end of every
        ``timesteps / return_frames``-th level is collected (chronological,
        the decode last) and (frames_lig, frames_pkt), each (return_frames,
        B, N, D), come back instead of (xh_lig, xh_pkt)."""
        timesteps = self.T if timesteps is None else timesteps
        stride = _frame_stride(timesteps, return_frames)
        ctx, z_lig, xh_pkt = self._cond_inpaint_prep(generator, ligand, pocket,
                                                     lig_fixed, center=center)
        m_l, m_p = ctx["ligand"]["mask"], ctx["m_p"]
        frames_lig, frames_pkt = [], []
        for i, s in enumerate(range(timesteps - 1, -1, -1)):
            for u in range(resamplings):
                with span("sampler.pass"):
                    (z_lig, xh_pkt), pre = self._cond_repaint_body(
                        generator, ctx, timesteps, z_lig, xh_pkt, s,
                        renoise=u < resamplings - 1, shared_pocket=shared_pocket)
            if return_frames > 1 and (i + 1) % stride == 0:
                frames_lig.append(self.unnormalize_z(pre[0]))
                frames_pkt.append(self.unnormalize_z(pre[1]))
        with span("sampler.pass"):
            x_lig, h_lig, x_pkt, h_pkt = self.sample_p_xh_given_z0(
                generator, z_lig, xh_pkt, m_l, m_p)
        final_lig = torch.cat([x_lig, h_lig], -1)
        final_pkt = torch.cat([x_pkt, h_pkt], -1)
        if return_frames > 1:
            frames_lig[-1], frames_pkt[-1] = final_lig, final_pkt
            return torch.stack(frames_lig), torch.stack(frames_pkt)
        return final_lig, final_pkt


class SimpleConditionalDDPM(ConditionalDDPM):
    """The conditional model without the CoM-subspace trick: the likelihood
    lives in the pocket-CoM frame and no projection is applied."""

    def subspace_dimensionality(self, input_size):
        return input_size * self.n_dims

    @staticmethod
    def remove_mean(x_lig, x_pkt, m_l, m_p):
        return com.remove_mean_simple(x_lig, x_pkt, m_l, m_p)

    @staticmethod
    def _center_on_pocket(ligand: Optional[Batch], pocket: Batch):
        pocket_com = masked_mean(pocket["x"], pocket["mask"])[:, None, :]
        out_p = dict(pocket, x=(pocket["x"] - pocket_com) * pocket["mask"][..., None])
        out_l = None
        if ligand is not None:
            out_l = dict(ligand,
                         x=(ligand["x"] - pocket_com) * ligand["mask"][..., None])
        return out_l, out_p

    # ``remove_mean`` is the identity here, so every entry point but
    # ``inpaint`` (whose prior is centred on the known part already) enters
    # the pocket-CoM frame itself: without it the prior's mean would sit at
    # the absolute coordinates of the input file.

    def loss_terms(self, generator, ligand, pocket, training):
        ligand, pocket = self._center_on_pocket(ligand, pocket)
        return super().loss_terms(generator, ligand, pocket, training)

    def sample_given_pocket(self, generator, pocket, lig_mask, timesteps=None,
                            shared_pocket: bool = False):
        _, pocket = self._center_on_pocket(None, pocket)
        return super().sample_given_pocket(generator, pocket, lig_mask,
                                           timesteps=timesteps,
                                           shared_pocket=shared_pocket)

    def sample_given_pocket_chain(self, generator, pocket, lig_mask,
                                  timesteps=None, return_frames: int = 1):
        _, pocket = self._center_on_pocket(None, pocket)
        return super().sample_given_pocket_chain(generator, pocket, lig_mask,
                                                 timesteps=timesteps,
                                                 return_frames=return_frames)

    def diversify(self, generator, ligand, pocket, noising_steps,
                  shared_pocket: bool = False):
        ligand, pocket = self._center_on_pocket(ligand, pocket)
        return super().diversify(generator, ligand, pocket, noising_steps,
                                 shared_pocket=shared_pocket)
