"""Model wrapper: config -> (dynamics + DDPM), pocket preparation and the
``generate_ligands`` inference API of the pocket-conditional model.

``LigandPocketDDPM`` is an ``nn.Module`` whose state_dict keys are the
reference's (``ddpm.dynamics....``).  Training, evaluation and the joint model
are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from diffsbdd_tpu_torch.chem import pdb as pdbmod
from diffsbdd_tpu_torch.chem.molecule import SimpleMol, build_molecule, process_molecule
from diffsbdd_tpu_torch.config import Config
from diffsbdd_tpu_torch.constants import dataset_params
from diffsbdd_tpu_torch.data.dataset import round_to_bucket
from diffsbdd_tpu_torch.diffusion.ddpm import ConditionalDDPM, num_nodes_to_mask
from diffsbdd_tpu_torch.diffusion.size_prior import SizeDistribution
from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
from diffsbdd_tpu_torch.ops.masked import masked_mean
from diffsbdd_tpu_torch.utils.misc import shift_to_pocket_frame


class LigandPocketDDPM(nn.Module):
    def __init__(self, dataset: str, mode: str, egnn_params: Config,
                 diffusion_params: Config, node_histogram,
                 pocket_representation: str = "CA", virtual_nodes: bool = False,
                 lig_bucket: int = 8, pocket_bucket: int = 64):
        super().__init__()
        if mode != "pocket_conditioning":
            raise NotImplementedError(f"mode {mode!r}: only pocket_conditioning "
                                      "is ported")
        if virtual_nodes:
            raise NotImplementedError("virtual nodes are not ported")
        if egnn_params.sin_embedding or egnn_params.aggregation_method != "sum":
            raise NotImplementedError("the port runs sum aggregation without "
                                      "sinusoidal distance embeddings")
        if pocket_representation not in ("CA", "full-atom"):
            raise ValueError(pocket_representation)
        self.pocket_representation = pocket_representation
        self.dataset_info = dataset_params[dataset]
        self.lig_bucket = lig_bucket
        self.pocket_bucket = pocket_bucket
        key = "aa" if pocket_representation == "CA" else "atom"
        self.pocket_type_encoder = self.dataset_info[f"{key}_encoder"]
        self.atom_nf = len(self.dataset_info["atom_decoder"])
        self.residue_nf = len(self.dataset_info[f"{key}_decoder"])

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
            edge_embedding_dim=egnn_params.get("edge_embedding_dim"))
        self.ddpm = ConditionalDDPM(
            dynamics=dynamics, atom_nf=self.atom_nf, residue_nf=self.residue_nf,
            n_dims=3, timesteps=diffusion_params.diffusion_steps,
            noise_schedule=diffusion_params.diffusion_noise_schedule,
            noise_precision=diffusion_params.diffusion_noise_precision,
            norm_values=tuple(diffusion_params.normalize_factors),
            size_distribution=(None if node_histogram is None
                               else SizeDistribution(node_histogram)))

    @property
    def device(self) -> torch.device:
        return self.ddpm.gamma_table.device

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
    ) -> List[SimpleMol]:
        """Generate ligands for one pocket given by residue ids or by a
        reference ligand residue ('<chain>:<resi>').  ``generator`` lives on
        the module's device and drives every Gaussian draw."""
        if (pocket_ids is None) == (ref_ligand is None):
            raise ValueError("give exactly one of pocket_ids and ref_ligand")
        struct = pdbmod.parse_pdb(pdb_file)
        if pocket_ids is not None:
            residues = [struct.residue(pid.split(":")[0], int(pid.split(":")[1]))
                        for pid in pocket_ids]
        else:
            residues = pdbmod.get_pocket_from_ligand(struct, ref_ligand)

        pocket = self.prepare_pocket(residues, repeats=n_samples)
        pocket_com_before = masked_mean(pocket["x"], pocket["mask"]).cpu().numpy()

        if num_nodes_lig is None:
            if self.ddpm.size_distribution is None:
                raise ValueError("this model has no ligand size prior: give "
                                 "num_nodes_lig")
            num_nodes_lig = self.ddpm.size_distribution.sample_conditional(
                n2=pocket["size"].cpu().numpy(), rng=size_rng)
        num_nodes_lig = np.asarray(num_nodes_lig)
        n_lig_pad = round_to_bucket(int(num_nodes_lig.max()), self.lig_bucket)
        lig_mask = torch.as_tensor(num_nodes_to_mask(num_nodes_lig, n_lig_pad),
                                   device=self.device)

        # shared_pocket: prepare_pocket replicated ONE pocket across the
        # batch, so the batch-invariant first-layer factorization applies
        xh_lig, xh_pocket = self.ddpm.sample_given_pocket(
            generator, pocket, lig_mask, timesteps=timesteps,
            shared_pocket=True)

        lig_m = lig_mask.cpu().numpy()
        xh_lig, xh_pocket = shift_to_pocket_frame(
            xh_lig.cpu().numpy(), xh_pocket.cpu().numpy(), lig_m,
            pocket["mask"].cpu().numpy(), pocket_com_before)

        molecules = []
        for b in range(n_samples):
            sel = lig_m[b] > 0
            mol = build_molecule(xh_lig[b, sel, :3], xh_lig[b, sel, 3:].argmax(-1),
                                 self.dataset_info)
            mol = process_molecule(mol, sanitize=sanitize, relax_iter=relax_iter,
                                   largest_frag=largest_frag)
            if mol is not None:
                molecules.append(mol)
        return molecules


def build_module_from_config(cfg: Config, node_histogram) -> LigandPocketDDPM:
    return LigandPocketDDPM(
        dataset=cfg.dataset, mode=cfg.mode, egnn_params=cfg.egnn_params,
        diffusion_params=cfg.diffusion_params, node_histogram=node_histogram,
        pocket_representation=cfg.pocket_representation,
        virtual_nodes=cfg.virtual_nodes,
        lig_bucket=cfg.tpu.lig_bucket, pocket_bucket=cfg.tpu.pocket_bucket)
