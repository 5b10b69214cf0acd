"""Substructure inpainting / fragment linking (RePaint-style).

    python -m diffsbdd_tpu_torch.cli.inpaint <ckpt_dir> --pdbfile 5ndu.pdb \\
        --ref_ligand C:8V2 --fix_atoms C1 N6 C5 C12 --outfile out.sdf
    python -m diffsbdd_tpu_torch.cli.inpaint <ckpt_dir> --pdbfile 5ndu.pdb \\
        --ref_ligand 5ndu_C_8V2.sdf --fix_atoms fragments.sdf --outfile linked.sdf

The pocket is the residues near the reference ligand, a residue of the PDB or
an SDF file.  The fixed atoms are named atoms of the reference ligand residue,
or every atom of one or more SDF files; atom names need a residue reference,
so an SDF reference takes SDF fixed atoms.  Runs on CUDA unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from diffsbdd_tpu_torch.checkpoint import load_model
from diffsbdd_tpu_torch.chem import pdb as pdbmod
from diffsbdd_tpu_torch.chem.sdfio import read_sdf, write_sdf_file
from diffsbdd_tpu_torch.data.dataset import round_to_bucket
from diffsbdd_tpu_torch.diffusion.ddpm import JointDDPM, num_nodes_to_mask
from diffsbdd_tpu_torch.ops.masked import masked_mean
from diffsbdd_tpu_torch.train.module import molecules_from_samples
from diffsbdd_tpu_torch.utils.device import resolve_device
from diffsbdd_tpu_torch.utils.misc import shift_to_pocket_frame


def prepare_substructure(ref_ligand, fix_atoms, struct, atom_encoder):
    """Coordinates and one-hot types of the fixed substructure, from SDF
    files or from atom names of the reference ligand residue."""
    if fix_atoms[0].endswith(".sdf"):
        coords, one_hot = [], []
        for fn in fix_atoms:
            mol = read_sdf(fn)[0]
            coords.append(np.asarray(mol.coords, np.float32))
            oh = np.zeros((mol.n_atoms, len(atom_encoder)), np.float32)
            for i, s in enumerate(mol.symbols):
                oh[i, atom_encoder[s]] = 1.0
            one_hot.append(oh)
        return np.concatenate(coords), np.concatenate(one_hot)

    if ref_ligand.endswith(".sdf"):
        raise ValueError("atom names in --fix_atoms need a reference ligand residue "
                         "'<chain>:<resi>'; with an SDF --ref_ligand give the fixed "
                         "atoms as SDF files")
    chain, resi = ref_ligand.split(":")
    wanted = set(fix_atoms)
    atoms = [a for a in struct.residue(chain, int(resi)).atoms if a.name in wanted]
    coords = np.asarray([a.coord for a in atoms], np.float32)
    one_hot = np.zeros((len(atoms), len(atom_encoder)), np.float32)
    for i, a in enumerate(atoms):
        one_hot[i, atom_encoder[a.element.capitalize()]] = 1.0
    return coords, one_hot


def inpaint_ligand(module, generator: torch.Generator, pdb_file, n_samples: int,
                   ligand: str, fix_atoms: List[str],
                   add_n_nodes: Optional[int] = None, center: str = "ligand",
                   sanitize: bool = False, largest_frag: bool = False,
                   relax_iter: int = 0, timesteps: Optional[int] = None,
                   resamplings: int = 1, save_traj: bool = False,
                   size_rng: Optional[np.random.Generator] = None):
    """Generate ligands around a fixed substructure; the fixed atoms lead each
    ligand.  ``save_traj`` (needs n_samples = 1 and a conditional checkpoint)
    returns one molecule per denoising frame instead of one per sample."""
    if save_traj and n_samples > 1:
        raise NotImplementedError("Can only visualize trajectory with n_samples=1.")
    frames = (timesteps or module.ddpm.T) if save_traj else 1
    if save_traj:
        sanitize, relax_iter, largest_frag = False, 0, False
    dev = module.device
    struct = pdbmod.parse_pdb(pdb_file)
    residues = pdbmod.get_pocket_from_ligand(struct, ligand)
    pocket = module.prepare_pocket(residues, repeats=n_samples)

    x_fixed, one_hot_fixed = prepare_substructure(ligand, fix_atoms, struct,
                                                  module.lig_type_encoder)
    n_fixed = len(x_fixed)
    if add_n_nodes is None:
        if module.ddpm.size_distribution is None:
            raise ValueError("this model has no ligand size prior: give add_n_nodes")
        num_nodes = module.ddpm.size_distribution.sample_conditional(
            n2=pocket["size"].cpu().numpy(), rng=size_rng)
        num_nodes = np.clip(num_nodes, n_fixed, None)
    else:
        num_nodes = np.full(n_samples, n_fixed + add_n_nodes)

    n_lig_pad = round_to_bucket(int(num_nodes.max()), module.lig_bucket)
    lig_mask = num_nodes_to_mask(num_nodes, n_lig_pad)
    x = np.zeros((n_samples, n_lig_pad, 3), np.float32)
    one_hot = np.zeros((n_samples, n_lig_pad, module.atom_nf), np.float32)
    lig_fixed = np.zeros((n_samples, n_lig_pad), np.float32)
    x[:, :n_fixed] = x_fixed[None]
    one_hot[:, :n_fixed] = one_hot_fixed[None]
    lig_fixed[:, :n_fixed] = 1.0
    ligand_batch = {"x": torch.as_tensor(x, device=dev),
                    "one_hot": torch.as_tensor(one_hot, device=dev),
                    "mask": torch.as_tensor(lig_mask, device=dev),
                    "size": torch.as_tensor(num_nodes, dtype=torch.int32, device=dev)}
    lig_fixed = torch.as_tensor(lig_fixed, device=dev)

    pkt_m = pocket["mask"].cpu().numpy()
    com_before = masked_mean(pocket["x"], pocket["mask"]).cpu().numpy()

    if isinstance(module.ddpm, JointDDPM):
        if save_traj:
            raise NotImplementedError(
                "--save_traj is only supported for conditional checkpoints "
                "(the joint RePaint sampler does not collect frames)")
        # a joint checkpoint inpaints with every pocket node clamped; no
        # ``center``: the joint sampler works in its own CoM-free frame
        xh_lig, xh_pocket = module.ddpm.inpaint(
            generator, ligand_batch, pocket, lig_fixed,
            pocket_fixed=pocket["mask"], resamplings=resamplings,
            timesteps=timesteps)
    else:
        # shared_pocket: one pocket replicated across the samples
        xh_lig, xh_pocket = module.ddpm.inpaint(
            generator, ligand_batch, pocket, lig_fixed, center=center,
            resamplings=resamplings, timesteps=timesteps, return_frames=frames,
            shared_pocket=True)
    xh_lig, xh_pocket = xh_lig.cpu().numpy(), xh_pocket.cpu().numpy()

    if save_traj:
        # the frames take the place of the batch axis
        xh_lig, xh_pocket = xh_lig[:, 0], xh_pocket[:, 0]
        lig_mask = np.repeat(lig_mask[:1], frames, axis=0)
        pkt_m = np.repeat(pkt_m[:1], frames, axis=0)
        com_before = np.repeat(com_before[:1], frames, axis=0)
    xh_lig, _ = shift_to_pocket_frame(xh_lig, xh_pocket, lig_mask, pkt_m, com_before)
    return molecules_from_samples(xh_lig, lig_mask, module.dataset_info,
                                  sanitize=sanitize, relax_iter=relax_iter,
                                  largest_frag=largest_frag)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", type=Path)
    p.add_argument("--pdbfile", type=str, required=True)
    p.add_argument("--ref_ligand", type=str, required=True)
    p.add_argument("--fix_atoms", type=str, nargs="+", required=True)
    p.add_argument("--center", type=str, default="ligand",
                   choices=["ligand", "pocket"])
    p.add_argument("--outfile", type=Path, required=True)
    p.add_argument("--n_samples", type=int, default=20)
    p.add_argument("--add_n_nodes", type=int, default=None)
    p.add_argument("--relax", action="store_true")
    p.add_argument("--sanitize", action="store_true")
    p.add_argument("--resamplings", type=int, default=20)
    p.add_argument("--timesteps", type=int, default=50)
    p.add_argument("--save_traj", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    module, _ = load_model(args.checkpoint, device=device)
    if args.add_n_nodes is None and module.ddpm.size_distribution is None:
        p.error("the checkpoint has no ligand size prior: pass --add_n_nodes")
    molecules = inpaint_ligand(
        module, torch.Generator(device=device).manual_seed(args.seed),
        args.pdbfile, args.n_samples, args.ref_ligand, args.fix_atoms,
        add_n_nodes=args.add_n_nodes, center=args.center, sanitize=args.sanitize,
        relax_iter=(200 if args.relax else 0), timesteps=args.timesteps,
        resamplings=args.resamplings, save_traj=args.save_traj,
        size_rng=np.random.default_rng(args.seed))

    args.outfile.parent.mkdir(parents=True, exist_ok=True)
    write_sdf_file(args.outfile, molecules)
    print(f"wrote {len(molecules)} molecules to {args.outfile}")


if __name__ == "__main__":
    main()
