"""Evolutionary molecule optimization: population -> partial noising and
denoising (``diversify``) -> score -> top-k selection -> repeat.

    python -m diffsbdd_tpu_torch.cli.optimize <ckpt_dir> --pdbfile pocket.pdb \\
        --ref_ligand ligand.sdf --objective sa --outfile opt.sdf [--device cpu]

Writes the last generation's molecules to ``--outfile`` and every molecule
scored on the way to ``<outfile>.csv`` (generation, score, fate, key).  Runs
on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import csv
import math
import random
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from diffsbdd_tpu_torch.checkpoint import load_model
from diffsbdd_tpu_torch.chem import pdb as pdbmod
from diffsbdd_tpu_torch.chem.metrics import MoleculeProperties
from diffsbdd_tpu_torch.chem.molecule import SimpleMol
from diffsbdd_tpu_torch.chem.sdfio import read_sdf, write_sdf_file
from diffsbdd_tpu_torch.data.dataset import round_to_bucket
from diffsbdd_tpu_torch.ops.masked import masked_mean
from diffsbdd_tpu_torch.train.module import molecules_from_samples
from diffsbdd_tpu_torch.utils.device import resolve_device
from diffsbdd_tpu_torch.utils.misc import shift_to_pocket_frame

CSV_FIELDS = ("generation", "score", "fate", "smiles")


def prepare_ligands_from_mols(mols: List[SimpleMol], atom_encoder,
                              n_lig_pad: int, device="cpu") -> Dict[str, torch.Tensor]:
    """Molecule list -> padded ligand batch on ``device``."""
    B = len(mols)
    A = len(atom_encoder)
    ligand = {
        "x": np.zeros((B, n_lig_pad, 3), np.float32),
        "one_hot": np.zeros((B, n_lig_pad, A), np.float32),
        "mask": np.zeros((B, n_lig_pad), np.float32),
        "size": np.zeros((B,), np.int32),
    }
    for b, mol in enumerate(mols):
        n = mol.n_atoms
        ligand["x"][b, :n] = mol.coords
        for i, s in enumerate(mol.symbols):
            ligand["one_hot"][b, i, atom_encoder[s]] = 1.0
        ligand["mask"][b, :n] = 1.0
        ligand["size"][b] = n
    return {k: torch.as_tensor(v, device=device) for k, v in ligand.items()}


def diversify_ligands(module, generator: torch.Generator, pocket,
                      mols: List[SimpleMol], timesteps: int,
                      sanitize: bool = False, largest_frag: bool = False,
                      relax_iter: int = 0) -> List[SimpleMol]:
    """Noise a population ``timesteps`` levels and denoise it back, in one
    pocket replicated across the batch; the molecules that pass the
    filters."""
    n_lig_pad = round_to_bucket(max(m.n_atoms for m in mols), module.lig_bucket)
    ligand = prepare_ligands_from_mols(mols, module.lig_type_encoder, n_lig_pad,
                                       module.device)
    com_before = masked_mean(pocket["x"], pocket["mask"]).cpu().numpy()
    xh_lig, xh_pocket = module.ddpm.diversify(
        generator, ligand, pocket, noising_steps=timesteps, shared_pocket=True)
    lig_m = ligand["mask"].cpu().numpy()
    xh_lig, _ = shift_to_pocket_frame(
        xh_lig.cpu().numpy(), xh_pocket.cpu().numpy(), lig_m,
        pocket["mask"].cpu().numpy(), com_before)
    return molecules_from_samples(xh_lig, lig_m, module.dataset_info,
                                  sanitize=sanitize, relax_iter=relax_iter,
                                  largest_frag=largest_frag)


def nlargest(rows: List[dict], k: int) -> List[dict]:
    """The ``k`` rows of highest score, highest first, rows of equal score
    in their order, and NaN scores last (``pandas.DataFrame.nlargest(k,
    "score")``)."""
    def key(r):
        nan = math.isnan(r["score"])
        return nan, 0.0 if nan else -r["score"]
    return sorted(rows, key=key)[:k]


def write_csv(path, rows: List[dict]) -> None:
    """The rows with their index first, in an unnamed column."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["", *CSV_FIELDS])
        for i, row in enumerate(rows):
            writer.writerow([i, *(row[k] for k in CSV_FIELDS)])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", type=Path)
    p.add_argument("--pdbfile", type=str, required=True)
    p.add_argument("--ref_ligand", type=str, required=True)
    p.add_argument("--objective", type=str, default="sa",
                   choices={"qed", "sa"})
    p.add_argument("--timesteps", type=int, default=100)
    p.add_argument("--population_size", type=int, default=100)
    p.add_argument("--evolution_steps", type=int, default=10)
    p.add_argument("--top_k", type=int, default=7)
    p.add_argument("--outfile", type=Path, required=True)
    p.add_argument("--relax", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    module, _ = load_model(args.checkpoint, device=device)

    struct = pdbmod.parse_pdb(args.pdbfile)
    residues = pdbmod.get_pocket_from_ligand(struct, args.ref_ligand)
    pocket = module.prepare_pocket(residues, repeats=args.population_size)

    props = MoleculeProperties()
    objective = props.calculate_qed if args.objective == "qed" \
        else props.calculate_sa

    ref_mol = read_sdf(args.ref_ligand)[0]
    generator = torch.Generator(device=device).manual_seed(args.seed)
    random.seed(args.seed)

    ref_score = objective(ref_mol)
    if not np.isfinite(ref_score):
        raise RuntimeError(
            f"objective '{args.objective}' returned {ref_score} for the "
            f"reference ligand: refusing to optimize a non-finite objective")

    buffer = [{"generation": 0, "score": ref_score, "fate": "initial",
               "mol": ref_mol, "smiles": ref_mol.to_smiles()}]
    molecules = [ref_mol]
    for generation in range(args.evolution_steps):
        if generation == 0:
            population = molecules * args.population_size
        else:
            prev = [r for r in buffer if r["generation"] == generation]
            if not prev:
                # every molecule of the generation failed the filters:
                # reseed from the best of all earlier generations
                print(f"generation {generation} produced no valid "
                      f"molecules; reseeding from the global buffer")
                prev = buffer
            top_k = [r["mol"] for r in nlargest(prev, args.top_k)]
            for r in buffer:
                if r["generation"] == generation:
                    r["fate"] = "survived"
            # replicate the survivors; the remainder drawn at random
            population = top_k * (args.population_size // len(top_k))
            while len(population) < args.population_size:
                population.append(random.choice(top_k))
        population = population[:args.population_size]

        scores = [objective(m) for m in population]
        print(f"generation {generation}, mean score: {np.nanmean(scores):.4f}")

        molecules = diversify_ligands(
            module, generator, pocket, population, timesteps=args.timesteps,
            sanitize=True, relax_iter=(200 if args.relax else 0))
        buffer.extend({"generation": generation + 1, "score": objective(m),
                       "fate": "purged", "mol": m, "smiles": m.to_smiles()}
                      for m in molecules)

    args.outfile.parent.mkdir(parents=True, exist_ok=True)
    write_sdf_file(args.outfile, molecules)
    write_csv(args.outfile.with_suffix(".csv"), buffer)
    print(f"wrote {len(molecules)} molecules to {args.outfile}")


if __name__ == "__main__":
    main()
