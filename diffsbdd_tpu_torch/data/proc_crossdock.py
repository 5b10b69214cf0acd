"""CrossDocked processing: raw complexes -> the port's training files.

    python -m diffsbdd_tpu_torch.data.proc_crossdock <basedir> [--outdir DIR] [--split_file F] [--ca_only] [--dist_cutoff 8.0] [--random_seed 42]

Reads the Pocket2Mol split of the CrossDocked pocket10 set
(``<basedir>/crossdocked_pocket10`` and ``split_by_name.pt``, or a ``.json``
split of the same layout), extracts the ligand atoms and the pocket residues
within a distance cutoff (CA only or full-atom) and writes
``{train,val,test}.npz`` in the flat layout that ``data/dataset.py`` reads,
plus statistics of the training split:

* ``size_distribution.npy``, the joint (n_lig, n_pocket) histogram smoothed
  by a Gaussian (sigma 1, zero outside);
* ``train_smiles.npy``, the molecule keys of the training ligands, for the
  novelty metric (the WL key that ``SimpleMol.to_smiles`` gives);
* the atom- and residue-type histograms, printed.

Validation and test complexes also keep their PDB, SDF and pocket-id files
for the test-set sampler.
"""
from __future__ import annotations

import argparse
import json
import random
import shutil
from pathlib import Path
from time import time
from typing import Dict, Optional

import numpy as np
import torch

from diffsbdd_tpu_torch.chem import pdb as pdbmod
from diffsbdd_tpu_torch.chem.molecule import build_molecule
from diffsbdd_tpu_torch.chem.sdfio import read_sdf
from diffsbdd_tpu_torch.constants import dataset_params


def process_ligand_and_pocket(pdbfile, sdffile, atom_dict, amino_acid_dict,
                              dist_cutoff: float, ca_only: bool):
    """One complex -> (ligand_data, pocket_data) flat arrays.

    Hydrogens outside the atom dict are dropped from the ligand, an unknown
    heavy atom raises (the caller skips the complex); the pocket is the
    standard residues with an atom within ``dist_cutoff`` of the ligand.
    """
    struct = pdbmod.parse_pdb(pdbfile)
    mols = read_sdf(sdffile)
    if not mols:
        raise ValueError(f"cannot read sdf mol ({sdffile})")
    ligand = mols[0]

    keep = [i for i, s in enumerate(ligand.symbols)
            if s.capitalize() in atom_dict or s != "H"]
    lig_symbols = [ligand.symbols[i] for i in keep]
    lig_coords = np.asarray(ligand.coords, np.float64)[keep]
    try:
        lig_one_hot = np.stack([
            np.eye(1, len(atom_dict), atom_dict[s.capitalize()]).squeeze()
            for s in lig_symbols])
    except KeyError as e:
        raise KeyError(f"{e} not in atom dict ({sdffile})")

    pocket_residues = pdbmod.get_pocket_residues_from_coords(
        struct, lig_coords, dist_cutoff=dist_cutoff)
    if not pocket_residues:
        raise ValueError(f"empty pocket ({pdbfile})")
    pocket_ids = [f"{res.chain_id}:{res.resseq}" for res in pocket_residues]

    if ca_only:
        coords, one_hot = [], []
        for res in pocket_residues:
            ca = res.get_atom("CA")
            if ca is None:
                # a residue without CA excludes the whole complex
                raise KeyError(f"no CA in {res.chain_id}:{res.resseq}")
            one_hot.append(np.eye(1, len(amino_acid_dict),
                                  amino_acid_dict[res.one_letter()]).squeeze())
            coords.append(ca.coord)
        pocket_coords = np.stack(coords)
        pocket_one_hot = np.stack(one_hot)
    else:
        coords, one_hot = [], []
        for res in pocket_residues:
            for atom in res.atoms:
                el = atom.element.capitalize()
                if el in amino_acid_dict:
                    one_hot.append(np.eye(1, len(amino_acid_dict),
                                          amino_acid_dict[el]).squeeze())
                elif el != "H":
                    # an unknown heavy atom goes to the 'others' column
                    one_hot.append(np.eye(1, len(amino_acid_dict),
                                          len(amino_acid_dict) - 1).squeeze())
                else:
                    continue
                coords.append(atom.coord)
        pocket_coords = np.stack(coords)
        pocket_one_hot = np.stack(one_hot)

    ligand_data = {"lig_coords": lig_coords.astype(np.float32),
                   "lig_one_hot": lig_one_hot.astype(np.float32)}
    pocket_data = {"pocket_coords": pocket_coords.astype(np.float32),
                   "pocket_one_hot": pocket_one_hot.astype(np.float32),
                   "pocket_ids": pocket_ids}
    return ligand_data, pocket_data


def gaussian_filter(a, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """``scipy.ndimage.gaussian_filter(a, sigma, order=0, mode="constant",
    cval=0.0, truncate=truncate)`` in numpy: the normalized Gaussian of
    radius ``int(truncate * sigma + 0.5)`` correlated along each axis in
    turn, zeros outside the array."""
    out = np.asarray(a, dtype=np.float64)
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    weights = np.exp(-0.5 / (float(sigma) * float(sigma)) * x ** 2)
    weights = weights / weights.sum()
    for axis in range(out.ndim):
        moved = np.moveaxis(out, axis, -1)
        n = moved.shape[-1]
        padded = np.pad(moved, [(0, 0)] * (moved.ndim - 1) + [(radius, radius)])
        acc = np.zeros_like(moved)
        for k, w in enumerate(weights):
            acc += w * padded[..., k:k + n]
        out = np.moveaxis(acc, -1, axis)
    return out


def get_n_nodes(lig_mask, pocket_mask, smooth_sigma: Optional[float] = None):
    """The joint (n_lig, n_pocket) size histogram of the complexes, smoothed
    by ``gaussian_filter`` when ``smooth_sigma`` is given."""
    idx_lig, n_lig = np.unique(lig_mask, return_counts=True)
    idx_pkt, n_pkt = np.unique(pocket_mask, return_counts=True)
    assert np.all(idx_lig == idx_pkt)

    joint = np.zeros((int(n_lig.max()) + 1, int(n_pkt.max()) + 1))
    for nl, npk in zip(n_lig, n_pkt):
        joint[nl, npk] += 1

    if smooth_sigma is not None:
        joint = gaussian_filter(joint, sigma=smooth_sigma, truncate=4.0)
    return joint


def compute_smiles(positions, one_hot, mask, dataset_info):
    """The molecule keys of the complexes' ligands (each molecule's largest
    fragment, EDM bonds)."""
    sections = np.where(np.diff(mask))[0] + 1
    positions = [np.asarray(p) for p in np.split(positions, sections)]
    types = [np.asarray(o).argmax(-1) for o in np.split(one_hot, sections)]
    smiles = []
    for pos, t in zip(positions, types):
        mol = build_molecule(pos, t, dataset_info)
        key = mol.largest_fragment().to_smiles()
        if key is not None:
            smiles.append(key)
    return np.array(smiles)


def type_histograms(lig_one_hot, pocket_one_hot, atom_decoder, aa_decoder):
    atom_counts = {a: 0 for a in atom_decoder}
    for idx in np.asarray(lig_one_hot).argmax(-1):
        atom_counts[atom_decoder[idx]] += 1
    aa_counts = {a: 0 for a in aa_decoder}
    for idx in np.asarray(pocket_one_hot).argmax(-1):
        aa_counts[aa_decoder[idx]] += 1
    return atom_counts, aa_counts


def saveall(filename, names, lig_coords, lig_one_hot, lig_mask,
            pocket_coords, pocket_one_hot, pocket_mask, receptors=None):
    extra = {} if receptors is None else {"receptors": receptors}
    np.savez(filename, names=names,
             lig_coords=lig_coords, lig_one_hot=lig_one_hot,
             lig_mask=lig_mask, pocket_coords=pocket_coords,
             pocket_one_hot=pocket_one_hot, pocket_mask=pocket_mask,
             **extra)


def read_split(split_path) -> Dict[str, list]:
    """Pocket2Mol split file: a torch .pt dict {split: [(pocket, ligand),
    ...]} or the same as .json.  A .pt split is a pickle, unpickled with
    ``weights_only=False``: read only files from a source you trust."""
    split_path = Path(split_path)
    if split_path.suffix == ".pt":
        return torch.load(split_path, weights_only=False)
    return json.loads(split_path.read_text())


def process_split(split_pairs, datadir, processed_dir, split_name, atom_dict,
                  amino_acid_dict, dist_cutoff, ca_only,
                  copy_test_files=True):
    """Extract every complex of one split; returns flat arrays + failures."""
    acc = {k: [] for k in ("lig_coords", "lig_one_hot", "lig_mask",
                           "pocket_coords", "pocket_one_hot", "pocket_mask")}
    names = []
    failed = []
    count = 0
    out_dir = Path(processed_dir, split_name)
    out_dir.mkdir(parents=True, exist_ok=True)

    for pocket_fn, ligand_fn in split_pairs:
        sdffile = Path(datadir, ligand_fn)
        pdbfile = Path(datadir, pocket_fn)
        try:
            ligand_data, pocket_data = process_ligand_and_pocket(
                pdbfile, sdffile, atom_dict, amino_acid_dict, dist_cutoff,
                ca_only)
        except (KeyError, ValueError, FileNotFoundError, AssertionError,
                IndexError) as e:
            failed.append((str(type(e).__name__), pocket_fn, ligand_fn))
            continue

        names.append(f"{pocket_fn}_{ligand_fn}")
        acc["lig_coords"].append(ligand_data["lig_coords"])
        acc["lig_one_hot"].append(ligand_data["lig_one_hot"])
        acc["lig_mask"].append(
            count * np.ones(len(ligand_data["lig_coords"])))
        acc["pocket_coords"].append(pocket_data["pocket_coords"])
        acc["pocket_one_hot"].append(pocket_data["pocket_one_hot"])
        acc["pocket_mask"].append(
            count * np.ones(len(pocket_data["pocket_coords"])))
        count += 1

        if split_name in {"val", "test"} and copy_test_files:
            # keep the PDB/SDF + pocket-id txt for the test-set sampler
            new_rec = Path(pdbfile).stem.replace("_", "-")
            shutil.copy(pdbfile, Path(out_dir, f"{new_rec}.pdb"))
            new_lig = f"{new_rec}_{Path(sdffile).stem.replace('_', '-')}"
            shutil.copy(sdffile, Path(out_dir, new_lig + ".sdf"))
            with open(Path(out_dir, new_lig + ".txt"), "w") as f:
                f.write(" ".join(pocket_data["pocket_ids"]))

    flat = {k: np.concatenate(v) if v else np.zeros((0,))
            for k, v in acc.items()}
    return names, flat, failed


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("basedir", type=Path)
    p.add_argument("--outdir", type=Path, default=None)
    p.add_argument("--split_file", type=Path, default=None)
    p.add_argument("--ca_only", action="store_true")
    p.add_argument("--dist_cutoff", type=float, default=8.0)
    p.add_argument("--random_seed", type=int, default=42)
    args = p.parse_args(argv)

    datadir = args.basedir / "crossdocked_pocket10"
    split_file = args.split_file or args.basedir / "split_by_name.pt"
    processed_dir = args.outdir or Path(
        args.basedir, "processed_crossdock_noH_ca_only" if args.ca_only
        else "processed_crossdock_noH_full")
    processed_dir.mkdir(parents=True, exist_ok=True)

    dinfo = dataset_params["crossdock" if args.ca_only else "crossdock_full"]
    atom_dict = dinfo["atom_encoder"]
    amino_acid_dict = dinfo["aa_encoder"]

    random.seed(args.random_seed)
    np.random.seed(args.random_seed)

    data_split = read_split(split_file)
    # without a validation split, 300 training complexes become one
    if "val" not in data_split:
        random.shuffle(data_split["train"])
        data_split["val"] = data_split["train"][:300]
        data_split["train"] = data_split["train"][300:]

    train_flat = None
    for split in data_split:
        tic = time()
        names, flat, failed = process_split(
            data_split[split], datadir, processed_dir, split, atom_dict,
            amino_acid_dict, args.dist_cutoff, args.ca_only)
        saveall(processed_dir / f"{split}.npz", names, **flat)
        print(f"{split}: {len(names)} complexes "
              f"({len(failed)} failed) in {time() - tic:.1f}s")
        if split == "train":
            train_flat = flat

    # statistics from the training split
    n_nodes = get_n_nodes(train_flat["lig_mask"], train_flat["pocket_mask"],
                          smooth_sigma=1.0)
    np.save(processed_dir / "size_distribution.npy", n_nodes)
    smiles = compute_smiles(train_flat["lig_coords"],
                            train_flat["lig_one_hot"],
                            train_flat["lig_mask"], dinfo)
    np.save(processed_dir / "train_smiles.npy", smiles)
    # full-atom pockets are atom-typed: decode with the atom decoder
    atom_hist, aa_hist = type_histograms(
        train_flat["lig_one_hot"], train_flat["pocket_one_hot"],
        dinfo["atom_decoder"],
        dinfo["aa_decoder"] if args.ca_only else dinfo["atom_decoder"])
    print("atom histogram:", atom_hist)
    print("aa histogram:", aa_hist)


if __name__ == "__main__":
    main()
