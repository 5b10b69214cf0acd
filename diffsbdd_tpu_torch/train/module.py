"""Model wrapper: config -> (dynamics + DDPM), the training loss, pocket
preparation and the ``generate_ligands`` inference API, for the three modes
``joint``, ``pocket_conditioning`` and ``pocket_conditioning_simple``.

``LigandPocketDDPM`` is an ``nn.Module`` whose state_dict keys are the
reference's (``ddpm.dynamics....``).  A joint checkpoint generates ligands as
an inpainter with every pocket node fixed.  ``analyze_samples`` gives the
sampling-quality metrics, smina docking scores included where receptors are
given.
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from diffsbdd_tpu_torch.chem import pdb as pdbmod
from diffsbdd_tpu_torch.chem.docking import smina_score
from diffsbdd_tpu_torch.chem.metrics import (BasicMolecularMetrics,
                                             CategoricalDistribution,
                                             MoleculeProperties)
from diffsbdd_tpu_torch.chem.molecule import SimpleMol, build_molecule, process_molecule
from diffsbdd_tpu_torch.config import Config
from diffsbdd_tpu_torch.constants import dataset_params
from diffsbdd_tpu_torch.data.dataset import round_to_bucket
from diffsbdd_tpu_torch.diffusion.ddpm import (ConditionalDDPM, JointDDPM,
                                               SimpleConditionalDDPM,
                                               num_nodes_to_mask)
from diffsbdd_tpu_torch.diffusion.size_prior import SizeDistribution
from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
from diffsbdd_tpu_torch.ops.masked import masked_mean
from diffsbdd_tpu_torch.train.augment import augment_batch
from diffsbdd_tpu_torch.train.lj import WeightSchedule, lj_potential
from diffsbdd_tpu_torch.utils.misc import shift_to_pocket_frame
from diffsbdd_tpu_torch.utils.profiling import span


def molecules_from_samples(xh_lig: np.ndarray, lig_mask: np.ndarray, dataset_info,
                           sanitize: bool = False, relax_iter: int = 0,
                           largest_frag: bool = False, return_raw: bool = False):
    """One molecule per row of a sampled ligand batch (coordinates and one-hot
    types under the mask), bonds perceived, filters applied; rows that fail a
    filter are dropped.  With ``return_raw`` also every built molecule before
    the filters: (molecules, raw)."""
    molecules, raw = [], []
    for b in range(len(xh_lig)):
        sel = lig_mask[b] > 0
        mol = build_molecule(xh_lig[b, sel, :3], xh_lig[b, sel, 3:].argmax(-1),
                             dataset_info)
        raw.append(mol)
        mol = process_molecule(mol, sanitize=sanitize, relax_iter=relax_iter,
                               largest_frag=largest_frag)
        if mol is not None:
            molecules.append(mol)
    return (molecules, raw) if return_raw else molecules


DDPM_MODELS = {
    "joint": JointDDPM,
    "pocket_conditioning": ConditionalDDPM,
    "pocket_conditioning_simple": SimpleConditionalDDPM,
}


class LigandPocketDDPM(nn.Module):
    def __init__(self, dataset: str, mode: str, egnn_params: Config,
                 diffusion_params: Config, node_histogram,
                 pocket_representation: str = "CA", virtual_nodes: bool = False,
                 auxiliary_loss: bool = False, loss_params: Optional[Config] = None,
                 augment_noise: float = 0.0, augment_rotation: bool = False,
                 lig_bucket: int = 8, pocket_bucket: int = 64,
                 kernel_block_fuse: bool = False, nan_check: bool = False,
                 matmul_precision: str = "float32",
                 kernel_bwd_precision: Optional[str] = None,
                 compute_dtype: str = "float32", egnn_impl: str = "auto",
                 kernel_bwd: str = "auto"):
        super().__init__()
        if mode not in DDPM_MODELS:
            raise ValueError(f"mode {mode!r} not in {sorted(DDPM_MODELS)}")
        self.mode = mode
        if pocket_representation not in ("CA", "full-atom"):
            raise ValueError(pocket_representation)
        self.pocket_representation = pocket_representation
        self.dataset_info = dataset_params[dataset]
        self.lig_bucket = lig_bucket
        self.pocket_bucket = pocket_bucket
        self.T = diffusion_params.diffusion_steps
        self.loss_type = diffusion_params.diffusion_loss_type
        self.virtual_nodes = virtual_nodes
        self.augment_noise = float(augment_noise or 0.0)
        self.augment_rotation = bool(augment_rotation)
        self.x_dims = 3
        key = "aa" if pocket_representation == "CA" else "atom"
        self.pocket_type_encoder = self.dataset_info[f"{key}_encoder"]
        self.residue_nf = len(self.dataset_info[f"{key}_decoder"])

        self.lig_type_encoder = dict(self.dataset_info["atom_encoder"])
        self.lig_type_decoder = list(self.dataset_info["atom_decoder"])
        self.max_num_nodes = None if node_histogram is None \
            else len(node_histogram) - 1
        self.virtual_atom = None
        if virtual_nodes:
            symbol = "Ne"  # virtual atoms are written out as neon
            self.virtual_atom = self.lig_type_encoder[symbol] = len(self.lig_type_encoder)
            self.lig_type_decoder.append(symbol)
            self.dataset_info = dict(self.dataset_info,
                                     atom_encoder=self.lig_type_encoder,
                                     atom_decoder=self.lig_type_decoder)
        self.atom_nf = len(self.lig_type_decoder)

        self.auxiliary_loss = auxiliary_loss
        self.lj_rm = np.asarray(self.dataset_info["lennard_jones_rm"])
        if virtual_nodes and self.lj_rm.shape[0] < self.atom_nf:
            # virtual atoms never contribute LJ terms
            padded = np.zeros((self.atom_nf, self.atom_nf))
            padded[:self.lj_rm.shape[0], :self.lj_rm.shape[1]] = self.lj_rm
            self.lj_rm = padded
        if auxiliary_loss:
            self.clamp_lj = loss_params.clamp_lj
            self.auxiliary_weight_schedule = WeightSchedule(
                T=self.T, max_weight=loss_params.max_weight,
                mode=loss_params.schedule)

        dynamics = EGNNDynamics(
            atom_nf=self.atom_nf, residue_nf=self.residue_nf,
            joint_nf=egnn_params.joint_nf, hidden_nf=egnn_params.hidden_nf,
            n_layers=egnn_params.n_layers, attention=egnn_params.attention,
            tanh=egnn_params.tanh, norm_constant=egnn_params.norm_constant,
            inv_sublayers=egnn_params.inv_sublayers,
            normalization_factor=egnn_params.normalization_factor,
            edge_cutoff_ligand=egnn_params.get("edge_cutoff_ligand"),
            edge_cutoff_pocket=egnn_params.get("edge_cutoff_pocket"),
            edge_cutoff_interaction=egnn_params.get("edge_cutoff_interaction"),
            reflection_equivariant=egnn_params.reflection_equivariant,
            edge_embedding_dim=egnn_params.get("edge_embedding_dim"),
            update_pocket_coords=(mode == "joint"),
            kernel_block_fuse=kernel_block_fuse,
            sin_embedding=egnn_params.sin_embedding,
            aggregation_method=egnn_params.aggregation_method, nan_check=nan_check,
            matmul_precision=matmul_precision, kernel_bwd_precision=kernel_bwd_precision,
            compute_dtype=compute_dtype, egnn_impl=egnn_impl, kernel_bwd=kernel_bwd)
        self.ddpm = DDPM_MODELS[mode](
            dynamics=dynamics, atom_nf=self.atom_nf, residue_nf=self.residue_nf,
            n_dims=3, timesteps=diffusion_params.diffusion_steps,
            noise_schedule=diffusion_params.diffusion_noise_schedule,
            noise_precision=diffusion_params.diffusion_noise_precision,
            loss_type=diffusion_params.diffusion_loss_type,
            norm_values=tuple(diffusion_params.normalize_factors),
            size_distribution=(None if node_histogram is None
                               else SizeDistribution(node_histogram)),
            virtual_node_idx=self.virtual_atom)

    @property
    def device(self) -> torch.device:
        return self.ddpm.device

    # ------------------------------------------------------------------- loss
    def loss_fn(self, generator: torch.Generator, ligand: Dict, pocket: Dict,
                training: bool = True):
        """Scalar loss and a dict of metrics.  ``generator`` drives every
        random draw: the augmentation, the timesteps, the noise."""
        if training and (self.augment_noise > 0 or self.augment_rotation):
            ligand, pocket = augment_batch(generator, ligand, pocket,
                                           self.augment_noise, self.augment_rotation)
        terms = self.ddpm.loss_terms(generator, ligand, pocket, training)
        info = dict(terms.pop("info"))

        lig_size = ligand["size"].float()
        pkt_size = pocket["size"].float()
        actual_lig_size = lig_size
        if self.virtual_nodes:
            # a missing key is an error, not a fallback: the padded ligand
            # size would mis-normalize the x-term of the l2 loss
            actual_lig_size = lig_size - ligand["num_virtual_atoms"].float()

        error_t_lig = terms["error_t_lig"]
        error_t_pocket = terms["error_t_pocket"]
        l2_training = self.loss_type == "l2" and training
        if l2_training:
            error_t_lig = error_t_lig / (self.x_dims * actual_lig_size
                                         + self.ddpm.atom_nf * lig_size)
            error_t_pocket = error_t_pocket / (
                (self.x_dims + self.ddpm.residue_nf) * pkt_size)
            loss_t = 0.5 * (error_t_lig + error_t_pocket)
            loss_0 = (terms["loss_0_x_ligand"] / (self.x_dims * actual_lig_size)
                      + terms["loss_0_x_pocket"] / (self.x_dims * pkt_size)
                      + terms["loss_0_h"])
        else:
            loss_t = -self.T * 0.5 * terms["SNR_weight"] * (
                error_t_lig + error_t_pocket)
            loss_0 = (terms["loss_0_x_ligand"] + terms["loss_0_x_pocket"]
                      + terms["loss_0_h"] + terms["neg_log_constants"])

        nll = loss_t + loss_0 + terms["kl_prior"]
        if not l2_training:
            nll = nll - terms["delta_log_px"]
            if not self.virtual_nodes:
                nll = nll - terms["log_pN"]

        if self.auxiliary_loss and l2_training:
            xh_hat = terms["xh_lig_hat"]
            weighted_lj = self.auxiliary_weight_schedule(terms["t_int"]) * lj_potential(
                xh_hat[..., :self.x_dims], xh_hat[..., self.x_dims:],
                ligand["mask"], self.lj_rm, self.ddpm.norm_values[0],
                clamp=self.clamp_lj)
            nll = nll + weighted_lj
            info["weighted_lj"] = weighted_lj.mean()

        info.update(
            error_t_lig=error_t_lig.mean(), error_t_pocket=error_t_pocket.mean(),
            SNR_weight=terms["SNR_weight"].mean(), loss_0=loss_0.mean(),
            kl_prior=terms["kl_prior"].mean(),
            delta_log_px=terms["delta_log_px"].mean(),
            neg_log_const_0=terms["neg_log_constants"].mean(),
            log_pN=terms["log_pN"].mean())
        loss = nll.mean()
        info["loss"] = loss
        return loss, info

    # ---------------------------------------------------------- pocket prep
    def prepare_pocket(self, residues: Sequence[pdbmod.Residue],
                       repeats: int = 1,
                       n_pocket_pad: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Padded pocket batch (CA or full-atom) replicated ``repeats`` times."""
        coords, types = [], []
        if self.pocket_representation == "CA":
            for res in residues:
                ca = res.get_atom("CA")
                if ca is None:
                    # silently dropping the residue would condition on a
                    # different binding site than the user specified
                    raise KeyError(
                        f"residue {res.chain_id}:{res.resseq} has no CA atom")
                coords.append(ca.coord)
                types.append(self.pocket_type_encoder[res.one_letter()])
        else:
            for res in residues:
                for a in res.atoms:
                    el = a.element.capitalize()
                    if el == "H" and "H" not in self.pocket_type_encoder:
                        continue
                    if el not in self.pocket_type_encoder:
                        if "others" not in self.pocket_type_encoder:
                            raise KeyError(f"unknown pocket element {el}")
                        el = "others"
                    coords.append(a.coord)
                    types.append(self.pocket_type_encoder[el])
        coords = np.asarray(coords, np.float32)

        n = len(coords)
        n_pad = n_pocket_pad or round_to_bucket(n, self.pocket_bucket)
        one_hot = np.zeros((n, self.residue_nf), np.float32)
        one_hot[np.arange(n), types] = 1.0
        pocket = {
            "x": np.zeros((repeats, n_pad, 3), np.float32),
            "one_hot": np.zeros((repeats, n_pad, self.residue_nf), np.float32),
            "mask": np.zeros((repeats, n_pad), np.float32),
        }
        pocket["x"][:, :n] = coords[None]
        pocket["one_hot"][:, :n] = one_hot[None]
        pocket["mask"][:, :n] = 1.0
        out = {k: torch.as_tensor(v, device=self.device) for k, v in pocket.items()}
        out["size"] = torch.full((repeats,), n, dtype=torch.int32, device=self.device)
        return out

    # ------------------------------------------------------------- inference
    def generate_ligands(
        self, pdb_file, n_samples: int, generator: torch.Generator,
        pocket_ids: Optional[List[str]] = None,
        ref_ligand: Optional[str] = None,
        num_nodes_lig: Optional[np.ndarray] = None,
        sanitize: bool = False, largest_frag: bool = False,
        relax_iter: int = 0, timesteps: Optional[int] = None,
        size_rng: Optional[np.random.Generator] = None,
        resamplings: int = 1, jump_length: int = 1,
        n_nodes_bias: int = 0, n_nodes_min: int = 0, return_raw: bool = False,
    ):
        """Generate ligands for one pocket given by residue ids or by a
        reference ligand residue ('<chain>:<resi>').  ``generator`` lives on
        the module's device and drives every Gaussian draw.  A conditional
        model samples directly; a joint model inpaints with every pocket node
        fixed, following the RePaint schedule of ``resamplings`` and
        ``jump_length`` (which a conditional model does not read).  The
        ligand sizes, drawn or given, get ``n_nodes_bias`` added and are
        clipped below at ``n_nodes_min``.  Returns the molecules that pass
        the filters, and with ``return_raw`` also every built molecule:
        (molecules, raw).  Reading the pocket and building the molecules are
        the ``module.prepare_pocket`` and ``module.build_molecules`` spans
        (``utils.profiling.span``)."""
        if (pocket_ids is None) == (ref_ligand is None):
            raise ValueError("give exactly one of pocket_ids and ref_ligand")
        with span("module.prepare_pocket"):
            struct = pdbmod.parse_pdb(pdb_file)
            if pocket_ids is not None:
                residues = [struct.residue(pid.split(":")[0], int(pid.split(":")[1]))
                            for pid in pocket_ids]
            else:
                residues = pdbmod.get_pocket_from_ligand(struct, ref_ligand)

            pocket = self.prepare_pocket(residues, repeats=n_samples)
            pocket_com_before = masked_mean(pocket["x"], pocket["mask"]).cpu().numpy()

        if num_nodes_lig is None:
            if self.virtual_nodes:
                # a virtual-node model always generates at the padded maximum
                num_nodes_lig = np.full(n_samples, self.max_num_nodes)
            elif self.ddpm.size_distribution is None:
                raise ValueError("this model has no ligand size prior: give "
                                 "num_nodes_lig")
            else:
                num_nodes_lig = self.ddpm.size_distribution.sample_conditional(
                    n2=pocket["size"].cpu().numpy(), rng=size_rng)
        num_nodes_lig = np.clip(np.asarray(num_nodes_lig) + n_nodes_bias,
                                n_nodes_min, None)
        n_lig_pad = round_to_bucket(int(num_nodes_lig.max()), self.lig_bucket)
        lig_mask = torch.as_tensor(num_nodes_to_mask(num_nodes_lig, n_lig_pad),
                                   device=self.device)

        if isinstance(self.ddpm, JointDDPM):
            ligand = {
                "x": torch.zeros((n_samples, n_lig_pad, 3), device=self.device),
                "one_hot": torch.zeros((n_samples, n_lig_pad, self.atom_nf),
                                       device=self.device),
                "mask": lig_mask,
                "size": torch.as_tensor(num_nodes_lig, dtype=torch.int32,
                                        device=self.device),
            }
            xh_lig, xh_pocket = self.ddpm.inpaint(
                generator, ligand, pocket, lig_fixed=torch.zeros_like(lig_mask),
                pocket_fixed=pocket["mask"], resamplings=resamplings,
                jump_length=jump_length, timesteps=timesteps)
        else:
            # shared_pocket: prepare_pocket replicated ONE pocket across the
            # batch, so the batch-invariant first-layer factorization applies
            xh_lig, xh_pocket = self.ddpm.sample_given_pocket(
                generator, pocket, lig_mask, timesteps=timesteps,
                shared_pocket=True)

        with span("module.build_molecules"):
            lig_m = lig_mask.cpu().numpy()
            xh_lig, xh_pocket = shift_to_pocket_frame(
                xh_lig.cpu().numpy(), xh_pocket.cpu().numpy(), lig_m,
                pocket["mask"].cpu().numpy(), pocket_com_before)

            return molecules_from_samples(xh_lig, lig_m, self.dataset_info,
                                          sanitize=sanitize, relax_iter=relax_iter,
                                          largest_frag=largest_frag,
                                          return_raw=return_raw)

    # ------------------------------------------------------------------ eval
    def analyze_samples(self, molecules: List[SimpleMol], atom_types, aa_types,
                        receptors=None, dataset_smiles=None) -> Dict[str, float]:
        """Sampling-quality metrics: the atom- and residue-type KL divergences
        from the dataset histograms (-1.0 where not computed), validity,
        connectivity, uniqueness, novelty, and the mean QED, SA, logP,
        Lipinski and diversity of the connected molecules.  With
        ``receptors``, one receptor file a molecule, also ``smina_score``,
        the mean of the finite smina scores, when every file exists; a
        missing binary or a failed scoring skips it with a warning."""
        lig_dist = None if self.virtual_nodes else CategoricalDistribution(
            self.dataset_info["atom_hist"], self.lig_type_encoder)
        kl_atom = lig_dist.kl_divergence(atom_types) if lig_dist else -1.0
        if self.pocket_representation == "CA":
            kl_aa = CategoricalDistribution(
                self.dataset_info["aa_hist"],
                self.pocket_type_encoder).kl_divergence(aa_types)
        else:
            kl_aa = -1.0

        metrics = BasicMolecularMetrics(self.dataset_info, dataset_smiles)
        (validity, connectivity, uniqueness, novelty), (_, connected) = \
            metrics.evaluate_mols(molecules)
        qed, sa, logp, lipinski, diversity = \
            MoleculeProperties().evaluate_mean(connected)
        out = {
            "kl_div_atom_types": kl_atom, "kl_div_residue_types": kl_aa,
            "Validity": validity, "Connectivity": connectivity,
            "Uniqueness": uniqueness, "Novelty": novelty,
            "QED": qed, "SA": sa, "LogP": logp, "Lipinski": lipinski,
            "Diversity": diversity,
        }
        if receptors is not None and molecules \
                and len(receptors) == len(molecules) \
                and all(Path(r).exists() for r in receptors):
            # scored 1:1, each molecule against its own pocket's receptor
            try:
                scores = smina_score(molecules, receptors)
                finite = [s for s in scores if np.isfinite(s)]
                if finite:
                    out["smina_score"] = float(np.mean(finite))
            except (FileNotFoundError, OSError, RuntimeError, ValueError) as e:
                # a missing binary or a failed scoring never sinks the
                # training run's evaluation
                warnings.warn(f"smina scoring skipped: {e}")
        return out


def build_module_from_config(cfg: Config, node_histogram) -> LigandPocketDDPM:
    """The module a config describes; the ``tpu`` fields it reads are listed
    in ``config.py``."""
    return LigandPocketDDPM(
        dataset=cfg.dataset, mode=cfg.mode, egnn_params=cfg.egnn_params,
        diffusion_params=cfg.diffusion_params, node_histogram=node_histogram,
        pocket_representation=cfg.pocket_representation,
        virtual_nodes=cfg.virtual_nodes,
        auxiliary_loss=cfg.auxiliary_loss, loss_params=cfg.get("loss_params"),
        augment_noise=cfg.augment_noise, augment_rotation=cfg.augment_rotation,
        lig_bucket=cfg.tpu.lig_bucket, pocket_bucket=cfg.tpu.pocket_bucket,
        kernel_block_fuse=cfg.tpu.get("kernel_block_fuse", False),
        nan_check=cfg.tpu.get("nan_check", False),
        matmul_precision=cfg.tpu.get("matmul_precision", "float32"),
        kernel_bwd_precision=cfg.tpu.get("kernel_bwd_precision"),
        compute_dtype=cfg.tpu.get("compute_dtype", "float32"),
        egnn_impl=cfg.tpu.get("egnn_impl", "auto"),
        kernel_bwd=cfg.tpu.get("kernel_bwd", "auto"))
