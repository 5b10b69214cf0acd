"""Sampling evaluation during training: quality metrics on sampled molecules,
xyz dumps of samples, and denoising chains written as xyz frames (and
rendered).

``SamplingEvaluator`` dispatches on the model family: a joint model samples
ligand and pocket sizes from its prior and generates both; a conditional model
samples ligands for the pockets of the validation set.  Every Gaussian draw
comes from the ``torch.Generator`` the caller passes (through the DDPM's
``sample_gaussian``), every size draw from ``size_rng`` (``default_rng(0)``
unless given).  The samplers are the unsegmented ones: ``sample``,
``sample_given_pocket`` (no shared pocket: each row has its own pocket) and
the chain samplers.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from diffsbdd_tpu_torch.chem.molecule import build_molecule
from diffsbdd_tpu_torch.chem.visualization import (save_xyz_file, visualize,
                                                   visualize_chain)
from diffsbdd_tpu_torch.data.dataset import pad_batch, round_to_bucket
from diffsbdd_tpu_torch.diffusion.ddpm import JointDDPM, num_nodes_to_mask


def residues_to_atoms(x_ca: np.ndarray, atom_encoder) -> np.ndarray:
    """CA positions -> a carbon one-hot, for drawing a CA pocket."""
    one_hot = np.zeros(x_ca.shape[:-1] + (len(atom_encoder),), np.float32)
    one_hot[..., atom_encoder["C"]] = 1.0
    return one_hot


class SamplingEvaluator:
    """``dataset``: the validation ``LigandPocketDataset`` (conditional
    models); ``dataset_smiles``: the training set's molecule keys (novelty);
    ``wandb``: the wandb module, to log renders; ``datadir``: the processed
    data directory whose ``val/<PDB>-<suffix>.pdb`` receptors are docked
    against (smina) when given; ``perception``: the bond perception of the
    metric molecules (``build_molecule``'s, the EDM tables by default)."""

    def __init__(self, module, dataset=None, dataset_smiles=None,
                 outdir="eval_out", wandb=None, datadir=None, perception=None):
        self.module = module
        self.dataset = dataset
        self.dataset_smiles = dataset_smiles
        self.outdir = Path(outdir)
        self.joint = isinstance(module.ddpm, JointDDPM)
        self.wandb = wandb
        self.datadir = datadir
        self.perception = perception

    def _receptor_path(self, receptor_name: str):
        """'1abc.bio1' -> datadir/val/1ABC-bio1.pdb."""
        pdb, _, suffix = str(receptor_name).partition(".")
        return Path(self.datadir, "val", f"{pdb.upper()}-{suffix}.pdb")

    def _tensor(self, array):
        return torch.as_tensor(array, device=self.module.device)

    # ------------------------------------------------------------- dispatch
    def sample_and_analyze(self, generator: torch.Generator, n_samples: int,
                           batch_size=None, size_rng=None) -> Dict[str, float]:
        """``analyze_samples`` of ``n_samples`` molecules sampled in batches
        of ``batch_size``."""
        analyze = self._analyze_joint if self.joint else self._analyze_given_pocket
        return analyze(generator, n_samples, batch_size or n_samples,
                       size_rng or np.random.default_rng(0))

    def _joint_masks(self, n: int, size_rng):
        """Ligand and pocket masks of ``n`` sizes drawn from the joint prior."""
        mod = self.module
        n_lig, n_pkt = mod.ddpm.size_distribution.sample(n, rng=size_rng)
        nl_pad = round_to_bucket(int(n_lig.max()), mod.lig_bucket)
        np_pad = round_to_bucket(int(n_pkt.max()), mod.pocket_bucket)
        return (self._tensor(num_nodes_to_mask(n_lig, nl_pad)),
                self._tensor(num_nodes_to_mask(n_pkt, np_pad)))

    # ----------------------------------------------------------- joint mode
    def _analyze_joint(self, generator, n_samples, batch_size, size_rng):
        mod = self.module
        molecules, atom_types, aa_types = [], [], []
        # a bounded loop: fewer molecules rather than a hang when batches
        # yield none
        for _ in range(-(-n_samples // batch_size)):
            if len(molecules) >= n_samples:
                break
            n = min(batch_size, n_samples - len(molecules))
            lig_mask, pkt_mask = self._joint_masks(n, size_rng)
            xh_lig, xh_pkt = mod.ddpm.sample(generator, (lig_mask, pkt_mask))
            xh_lig, xh_pkt = xh_lig.cpu().numpy(), xh_pkt.cpu().numpy()
            m_l, m_p = lig_mask.cpu().numpy(), pkt_mask.cpu().numpy()
            molecules.extend(self._to_molecules(xh_lig, m_l))
            atom_types.extend(xh_lig[..., 3:].argmax(-1)[m_l > 0].tolist())
            aa_types.extend(xh_pkt[..., 3:].argmax(-1)[m_p > 0].tolist())
        return mod.analyze_samples(molecules[:n_samples], atom_types, aa_types,
                                   dataset_smiles=self.dataset_smiles)

    # ----------------------------------------------------- conditional mode
    def _val_pocket_batch(self, idx: List[int]):
        """(ligand, pocket, receptor names) of validation complexes ``idx``
        (modulo the set's length), padded to buckets, on the module's
        device."""
        items = [self.dataset[i % len(self.dataset)] for i in idx]
        nl_pad = round_to_bucket(max(len(it["lig_coords"]) for it in items),
                                 self.module.lig_bucket)
        np_pad = round_to_bucket(max(len(it["pocket_coords"]) for it in items),
                                 self.module.pocket_bucket)
        batch = pad_batch(items, nl_pad, np_pad)
        ligand = {k: self._tensor(v) for k, v in batch["ligand"].items()}
        pocket = {k: self._tensor(v) for k, v in batch["pocket"].items()}
        return ligand, pocket, batch["receptors"]

    def _ligand_mask(self, pocket, size_rng):
        """Ligand sizes for the pockets: a virtual-node model's fixed padded
        size, else draws from p(n_lig | n_pocket), at least 1."""
        mod = self.module
        n = pocket["mask"].shape[0]
        if mod.virtual_nodes:
            num_nodes = np.full(n, mod.max_num_nodes)
        else:
            num_nodes = mod.ddpm.size_distribution.sample_conditional(
                n2=pocket["size"].cpu().numpy(), rng=size_rng)
            num_nodes = np.clip(num_nodes, 1, None)
        nl_pad = round_to_bucket(int(num_nodes.max()), mod.lig_bucket)
        return self._tensor(num_nodes_to_mask(num_nodes, nl_pad))

    def _analyze_given_pocket(self, generator, n_samples, batch_size, size_rng):
        mod = self.module
        molecules, atom_types, aa_types, receptors = [], [], [], []
        for i in range(-(-n_samples // batch_size)):
            if len(molecules) >= n_samples:
                break
            n = min(batch_size, n_samples - len(molecules))
            _, pocket, recs = self._val_pocket_batch(
                list(range(i * batch_size, i * batch_size + n)))
            lig_mask = self._ligand_mask(pocket, size_rng)
            xh_lig, xh_pkt = mod.ddpm.sample_given_pocket(generator, pocket, lig_mask)
            mols, kept = self._to_molecules(
                xh_lig.cpu().numpy(), lig_mask.cpu().numpy(),
                strip_virtual=mod.virtual_nodes, return_kept=True)
            molecules.extend(mols)
            # the receptor list stays 1:1 with the molecules kept
            receptors.extend(recs[k] for k in kept)
            for m in mols:
                atom_types.extend(mod.lig_type_encoder[s] for s in m.symbols)
            aa_types.extend(xh_pkt[..., 3:].argmax(-1)[pocket["mask"] > 0]
                            .cpu().numpy().tolist())
        recs = [self._receptor_path(r) for r in receptors[:n_samples]] \
            if self.datadir is not None else None
        return mod.analyze_samples(molecules[:n_samples], atom_types, aa_types,
                                   receptors=recs,
                                   dataset_smiles=self.dataset_smiles)

    # ------------------------------------------------------------- helpers
    def _to_molecules(self, xh_lig, lig_mask, strip_virtual=False,
                      return_kept=False):
        """One molecule a row with at least one (non-virtual) atom; with
        ``return_kept`` also the rows kept."""
        mod = self.module
        out, kept = [], []
        for b in range(xh_lig.shape[0]):
            sel = lig_mask[b] > 0
            coords = xh_lig[b, sel, :3]
            types = xh_lig[b, sel, 3:].argmax(-1)
            if strip_virtual and mod.virtual_atom is not None:
                keep = types != mod.virtual_atom
                coords, types = coords[keep], types[keep]
            if len(types) == 0:
                continue
            out.append(build_molecule(coords, types, mod.dataset_info,
                                      add_coords=True, perception=self.perception))
            kept.append(b)
        return (out, kept) if return_kept else out

    # --------------------------------------------------------- sample dumps
    def sample_and_save(self, generator: torch.Generator, n_samples: int,
                        epoch: int = 0, size_rng=None, render: bool = True):
        """``n_samples`` samples (ligand and pocket) as xyz files under
        ``<outdir>/epoch_<epoch>``, rendered to PNGs unless ``render`` is
        False; returns the directory."""
        mod = self.module
        size_rng = size_rng or np.random.default_rng(0)
        if self.joint:
            lig_mask, pocket_mask = self._joint_masks(n_samples, size_rng)
            xh_lig, xh_pkt = mod.ddpm.sample(generator, (lig_mask, pocket_mask))
        else:
            _, pocket, _ = self._val_pocket_batch(list(range(n_samples)))
            lig_mask = self._ligand_mask(pocket, size_rng)
            xh_lig, xh_pkt = mod.ddpm.sample_given_pocket(generator, pocket, lig_mask)
            pocket_mask = pocket["mask"]

        outdir = Path(self.outdir, f"epoch_{epoch}")
        self._write_complex_xyz(outdir, xh_lig, lig_mask, xh_pkt, pocket_mask)
        if render:
            visualize(str(outdir), dataset_info=mod.dataset_info, wandb=self.wandb)
        return outdir

    def sample_chain_and_save(self, generator: torch.Generator, keep_frames: int,
                              epoch: int = 0, size_rng=None, render: bool = True):
        """One denoising chain as xyz frames under
        ``<outdir>/epoch_<epoch>/chain``: ``keep_frames`` (cut to the
        largest divisor of T not above it) frames, the decoded sample last;
        rendered to PNGs and a GIF unless ``render`` is False.  Returns the
        GIF's path, or None when nothing was rendered."""
        mod = self.module
        size_rng = size_rng or np.random.default_rng(0)
        T = mod.ddpm.T
        keep_frames = min(keep_frames, T)
        while T % keep_frames != 0:
            keep_frames -= 1
        if self.joint:
            lig_mask, pocket_mask = self._joint_masks(1, size_rng)
            frames_lig, frames_pkt = mod.ddpm.sample_chain(
                generator, (lig_mask, pocket_mask), return_frames=keep_frames)
        else:
            _, pocket, _ = self._val_pocket_batch([0])
            lig_mask = self._ligand_mask(pocket, size_rng)
            frames_lig, frames_pkt = mod.ddpm.sample_given_pocket_chain(
                generator, pocket, lig_mask, return_frames=keep_frames)
            pocket_mask = pocket["mask"]

        outdir = Path(self.outdir, f"epoch_{epoch}", "chain")
        outdir.mkdir(parents=True, exist_ok=True)
        for f in range(frames_lig.shape[0]):
            self._write_complex_xyz(outdir, frames_lig[f], lig_mask, frames_pkt[f],
                                    pocket_mask, name=f"chain_{f:04d}")
        if not render:
            return None
        return visualize_chain(str(outdir), mod.dataset_info, wandb=self.wandb)

    def _write_complex_xyz(self, outdir, xh_lig, lig_mask, xh_pkt, pkt_mask,
                           name="molecule"):
        """One xyz file a row: the ligand's atoms, then the pocket's (a CA
        pocket as carbons, a full-atom pocket's types cut to the ligand's
        type space)."""
        mod = self.module
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        xh_lig, xh_pkt = (np.asarray(torch.as_tensor(a).cpu()) for a in (xh_lig, xh_pkt))
        m_l, m_p = (np.asarray(torch.as_tensor(a).cpu()) for a in (lig_mask, pkt_mask))
        A = len(mod.lig_type_decoder)
        for b in range(xh_lig.shape[0]):
            sel_l, sel_p = m_l[b] > 0, m_p[b] > 0
            x_l = xh_lig[b, sel_l, :3]
            oh_l = np.eye(A)[xh_lig[b, sel_l, 3:].argmax(-1)]
            x_p = xh_pkt[b, sel_p, :3]
            if mod.pocket_representation == "CA":
                oh_p = residues_to_atoms(x_p, mod.lig_type_encoder)
            else:
                idx = xh_pkt[b, sel_p, 3:].argmax(-1)
                oh_p = np.eye(A)[np.minimum(idx, A - 1)]
            save_xyz_file(outdir, np.concatenate([oh_l, oh_p]),
                          np.concatenate([x_l, x_p]), mod.lig_type_decoder,
                          name=f"{name}_{b:03d}" if name == "molecule" else name)
