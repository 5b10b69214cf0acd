"""Binding MOAD processing: raw biounits -> the port's training files.

    python -m diffsbdd_tpu_torch.data.proc_bindingmoad <basedir> [--outdir DIR] [--qed_thresh 0.3] [--max_occurences 50] [--num_val 300] [--num_test 300] [--dist_cutoff 8.0] [--ca_only] [--random_seed 42]

* parse the ``every.csv`` label file into {EC class -> PDB -> ligands};
* keep the 'valid' ligands above a QED threshold, at most ``max_occurences``
  complexes a ligand name.  Without RDKit no QED is computed: every ligand
  gets 1.0 (with a warning) and only the validity filter applies;
* split by EC number into train, val and test;
* extract each ligand and its pocket from its biounit within a distance
  cutoff, CA only or full-atom;
* write the flat ``.npz`` files and statistics of ``proc_crossdock``, and for
  val and test per-complex SDF and pocket-id files and receptor PDBs without
  the processed ligands.
"""
from __future__ import annotations

import argparse
import random
import warnings
from collections import defaultdict
from pathlib import Path
from time import time

import numpy as np

from diffsbdd_tpu_torch.chem import pdb as pdbmod
from diffsbdd_tpu_torch.chem.molecule import build_molecule
from diffsbdd_tpu_torch.chem.sdfio import write_sdf_file
from diffsbdd_tpu_torch.constants import dataset_params
from diffsbdd_tpu_torch.data.proc_crossdock import (compute_smiles, get_n_nodes,
                                                    saveall, type_histograms)


def read_label_file(csv_path):
    """Binding MOAD's 'every.csv' -> {EC class: {PDB id: [[name, validity,
    smiles], ...]}}."""
    ligand_dict = {}
    curr_class = curr_prot = None
    with open(csv_path) as f:
        for line in f:
            row = line.split(",")
            if len(row[0]) > 0:
                curr_class = row[0]
                ligand_dict[curr_class] = {}
                continue
            if len(row[2]) > 0:
                curr_prot = row[2]
                ligand_dict[curr_class][curr_prot] = []
                continue
            if len(row[3]) > 0:
                ligand_dict[curr_class][curr_prot].append(
                    [row[3], row[4], row[9]])
    return ligand_dict


def compute_druglikeness(ligand_dict):
    """Append a druglikeness to each ligand entry: without RDKit, 1.0 for
    every ligand, so that the QED filter passes every valid one."""
    warnings.warn("RDKit unavailable: skipping QED computation; the "
                  "druglikeness filter will pass every valid ligand")
    for c in ligand_dict:
        for p in ligand_dict[c]:
            for m in ligand_dict[c][p]:
                m.append(1.0)
    return ligand_dict


def filter_and_flatten(ligand_dict, qed_thresh, max_occurences, seed):
    """Keep 'valid' ligands above the QED threshold, at most
    ``max_occurences`` complexes per ligand name (randomized order)."""
    all_examples = [(c, p, m) for c in ligand_dict for p in ligand_dict[c]
                    for m in ligand_dict[c][p]]
    random.seed(seed)
    random.shuffle(all_examples)

    filtered = []
    counter = defaultdict(int)
    for c, p, m in all_examples:
        ligand_name = m[0].split(":")[0]
        if m[1] == "valid" and len(m) > 3 and m[3] > qed_thresh:
            if counter[ligand_name] < max_occurences:
                filtered.append((c, p, m))
                counter[ligand_name] += 1
    return filtered


def split_by_ec_number(data_list, n_val, n_test, ec_level: int = 1):
    """Greedy EC-class packing into val/test of the requested sizes."""
    examples_per_class = defaultdict(int)
    for c, p, m in data_list:
        examples_per_class[".".join(c.split(".")[:ec_level])] += 1

    val_classes, test_classes = set(), set()
    ordered = sorted(examples_per_class.items(), key=lambda x: x[1],
                     reverse=True)
    for c, num in ordered:
        if sum(examples_per_class[x] for x in val_classes) + num <= n_val:
            val_classes.add(c)
    for c, num in ordered:
        if c in val_classes:
            continue
        if sum(examples_per_class[x] for x in test_classes) + num <= n_test:
            test_classes.add(c)

    def cls(x):
        return ".".join(x[0].split(".")[:ec_level])

    split = {
        "train": [x for x in data_list
                  if cls(x) not in val_classes and cls(x) not in test_classes],
        "val": [x for x in data_list if cls(x) in val_classes],
        "test": [x for x in data_list if cls(x) in test_classes],
    }
    assert sum(map(len, split.values())) == len(data_list)
    return split


def ligand_list_to_dict(ligand_list):
    out = defaultdict(list)
    for _, p, m in ligand_list:
        out[p].append(m)
    return out


def process_ligand_and_pocket(struct: pdbmod.Structure, ligand_name: str,
                              ligand_chain: str, ligand_resi: int,
                              atom_dict, amino_acid_dict,
                              dist_cutoff: float, ca_only: bool):
    """One (biounit structure, ligand id) -> flat arrays."""
    try:
        ligand = struct.residue(ligand_chain, ligand_resi)
    except KeyError:
        raise KeyError(
            f"ligand {ligand_name}:{ligand_chain}:{ligand_resi} not found")
    if ligand.resname != ligand_name:
        raise ValueError(f"{ligand.resname} != {ligand_name}")

    lig_atoms = [a for a in ligand.atoms
                 if a.element.capitalize() in atom_dict or a.element != "H"]
    lig_coords = np.array([a.coord for a in lig_atoms], np.float32)
    try:
        lig_one_hot = np.stack([
            np.eye(1, len(atom_dict),
                   atom_dict[a.element.capitalize()]).squeeze()
            for a in lig_atoms])
    except KeyError as e:
        raise KeyError(f"ligand atom {e} not in atom dict")

    pocket_residues = pdbmod.get_pocket_residues_from_coords(
        struct, lig_coords, dist_cutoff=dist_cutoff)
    pocket_residues = [r for r in pocket_residues
                       if not (r.chain_id == ligand_chain
                               and r.resseq == ligand_resi)]
    if not pocket_residues:
        raise ValueError("empty pocket")

    if ca_only:
        coords, one_hot = [], []
        for res in pocket_residues:
            ca = res.get_atom("CA")
            if ca is None:
                # a residue without CA excludes the whole complex
                raise KeyError(f"no CA in {res.chain_id}:{res.resseq}")
            coords.append(ca.coord)
            one_hot.append(np.eye(1, len(amino_acid_dict),
                                  amino_acid_dict[res.one_letter()]).squeeze())
        pocket_coords = np.stack(coords)
        pocket_one_hot = np.stack(one_hot)
    else:
        coords, one_hot = [], []
        for res in pocket_residues:
            for a in res.atoms:
                el = a.element.capitalize()
                if el == "H":
                    continue
                if el not in atom_dict:
                    # an unknown heavy atom excludes the complex
                    raise KeyError(f"pocket atom {el} not in atom dict")
                coords.append(a.coord)
                one_hot.append(np.eye(1, len(atom_dict),
                                      atom_dict[el]).squeeze())
        pocket_coords = np.stack(coords)
        pocket_one_hot = np.stack(one_hot)

    return ({"lig_coords": lig_coords,
             "lig_one_hot": lig_one_hot.astype(np.float32)},
            {"pocket_coords": pocket_coords.astype(np.float32),
             "pocket_one_hot": pocket_one_hot.astype(np.float32),
             "pocket_ids": [f"{r.chain_id}:{r.resseq}"
                            for r in pocket_residues]})


def _write_eval_files(out_dir: Path, pdbfile: Path, p: str, mol_id: str,
                      ligand_data, pocket_data, dataset_info):
    """The complex's ligand as an SDF (EDM bonds) and its pocket ids as a
    txt file, for the test-set sampler and docking."""
    name = f"{p}-{pdbfile.suffix[1:]}_{mol_id}"
    mol = build_molecule(ligand_data["lig_coords"],
                         np.argmax(ligand_data["lig_one_hot"], axis=1),
                         dataset_info)
    write_sdf_file(out_dir / f"{name}.sdf", [mol])
    (out_dir / f"{name}.txt").write_text(
        " ".join(pocket_data["pocket_ids"]))


def process_split(examples, pdbdir, atom_dict, amino_acid_dict, dist_cutoff,
                  ca_only, out_dir=None, dataset_info=None):
    """Extract every example of one split; returns (names, flat arrays with
    each complex's receptor file name, failures).  ``out_dir`` (val/test):
    also write per-complex ligand SDF + pocket-id txt and a receptor PDB with
    the processed ligands removed; the evaluator resolves '1abc.bio1' ->
    <split>/1ABC-bio1.pdb for its docking scores."""
    acc = {k: [] for k in ("lig_coords", "lig_one_hot", "lig_mask",
                           "pocket_coords", "pocket_one_hot", "pocket_mask")}
    names, receptors, failed = [], [], []
    count = 0
    pdbdir = Path(pdbdir)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)

    for p, ligands in ligand_list_to_dict(examples).items():
        # biounit files are named <pdb>.bio<N>; a ligand may live in any
        # biounit, so each file is tried in turn for the ligands not yet
        # processed
        candidates = [c for c in
                      sorted(pdbdir.glob(f"{p.lower()}.bio*"))
                      + [pdbdir / f"{p.lower()}.pdb"] if c.exists()]
        if not candidates:
            failed.append(("FileNotFound", p))
            continue
        remaining = list(ligands)
        errors = {}
        for pdbfile in candidates:
            if not remaining:
                break
            try:
                struct = pdbmod.parse_pdb(pdbfile)
            except Exception:
                errors.setdefault("__parse__", []).append(pdbfile.name)
                continue
            still = []
            bio_processed = []
            for m in remaining:
                ligand_name, ligand_chain, ligand_resi = m[0].split(":")
                try:
                    ligand_data, pocket_data = process_ligand_and_pocket(
                        struct, ligand_name, ligand_chain, int(ligand_resi),
                        atom_dict, amino_acid_dict, dist_cutoff, ca_only)
                except (KeyError, ValueError, IndexError) as e:
                    errors[m[0]] = str(e)
                    still.append(m)
                    continue
                names.append(f"{p}_{m[0]}")
                receptors.append(pdbfile.name)
                acc["lig_coords"].append(ligand_data["lig_coords"])
                acc["lig_one_hot"].append(ligand_data["lig_one_hot"])
                acc["lig_mask"].append(
                    count * np.ones(len(ligand_data["lig_coords"])))
                acc["pocket_coords"].append(pocket_data["pocket_coords"])
                acc["pocket_one_hot"].append(pocket_data["pocket_one_hot"])
                acc["pocket_mask"].append(
                    count * np.ones(len(pocket_data["pocket_coords"])))
                count += 1
                bio_processed.append(
                    (ligand_name, ligand_chain, int(ligand_resi)))
                if out_dir is not None:
                    _write_eval_files(out_dir, pdbfile, p, m[0],
                                      ligand_data, pocket_data, dataset_info)
            if out_dir is not None and bio_processed:
                pdbmod.write_receptor_pdb(
                    pdbfile, out_dir / f"{p}-{pdbfile.suffix[1:]}.pdb",
                    exclude_hetero=bio_processed)
            remaining = still
        for m in remaining:
            failed.append((errors.get(m[0], "NotFound"), p, m[0]))

    flat = {k: np.concatenate(v) if v else np.zeros((0,))
            for k, v in acc.items()}
    flat["receptors"] = np.asarray(receptors)
    return names, flat, failed


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("basedir", type=Path)
    p.add_argument("--outdir", type=Path, default=None)
    p.add_argument("--qed_thresh", type=float, default=0.3)
    p.add_argument("--max_occurences", type=int, default=50)
    p.add_argument("--num_val", type=int, default=300)
    p.add_argument("--num_test", type=int, default=300)
    p.add_argument("--dist_cutoff", type=float, default=8.0)
    p.add_argument("--ca_only", action="store_true")
    p.add_argument("--random_seed", type=int, default=42)
    args = p.parse_args(argv)

    pdbdir = args.basedir / "BindingMOAD_2020"
    csv_path = args.basedir / "every.csv"
    processed_dir = args.outdir or Path(
        args.basedir, "processed_moad_ca_only" if args.ca_only
        else "processed_moad_full")
    processed_dir.mkdir(parents=True, exist_ok=True)

    dinfo = dataset_params["bindingmoad"]
    atom_dict = dinfo["atom_encoder"]
    amino_acid_dict = dinfo["aa_encoder"]

    ligand_dict = read_label_file(csv_path)
    ligand_dict = compute_druglikeness(ligand_dict)
    filtered = filter_and_flatten(
        ligand_dict, args.qed_thresh, args.max_occurences, args.random_seed)
    print(f"{len(filtered)} examples after filtering")

    data_split = split_by_ec_number(filtered, args.num_val, args.num_test)

    train_flat = None
    for split in data_split:
        tic = time()
        names, flat, failed = process_split(
            data_split[split], pdbdir, atom_dict, amino_acid_dict,
            args.dist_cutoff, args.ca_only,
            # val/test side files for the test-set sampler and docking
            out_dir=(processed_dir / split
                     if split in {"val", "test"} else None),
            dataset_info=dinfo)
        saveall(processed_dir / f"{split}.npz", names, **flat)
        print(f"{split}: {len(names)} complexes ({len(failed)} failed) "
              f"in {time() - tic:.1f}s")
        if split == "train":
            train_flat = flat

    n_nodes = get_n_nodes(train_flat["lig_mask"], train_flat["pocket_mask"],
                          smooth_sigma=1.0)
    np.save(processed_dir / "size_distribution.npy", n_nodes)
    smiles = compute_smiles(train_flat["lig_coords"],
                            train_flat["lig_one_hot"],
                            train_flat["lig_mask"], dinfo)
    np.save(processed_dir / "train_smiles.npy", smiles)
    # full-atom pockets are atom-typed, so their histogram must be decoded
    # with the ATOM decoder (the aa decoder only applies to CA-only mode)
    pocket_decoder = dinfo["aa_decoder"] if args.ca_only \
        else dinfo["atom_decoder"]
    atom_hist, aa_hist = type_histograms(
        train_flat["lig_one_hot"], train_flat["pocket_one_hot"],
        dinfo["atom_decoder"], pocket_decoder)
    print("atom histogram:", atom_hist)
    print("pocket histogram:", aa_hist)


if __name__ == "__main__":
    main()
