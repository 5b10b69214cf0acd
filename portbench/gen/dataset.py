"""A synthetic processed training set in the format DiffSBDD's processing
scripts write (``train.npz``, ``val.npz``: flat per-node arrays and graph-id
masks; ``size_distribution.npy``: the (ligand, pocket) size histogram), after
``chip_smoke.py``'s ``write_synthetic_dataset``, with one change: the whole
set (sizes, coordinates, types) comes from the mix's own seed, so that every
run seed trains on the same set, in an order of its own.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.gen.pockets import pocket_atoms


def complex_sizes(traffic: dict, n: int):
    """(ligand atoms, pocket atoms) of ``n`` complexes, from the mix's seed."""
    rng = np.random.default_rng(traffic["traffic_seed"])
    lo, hi = traffic["lig_size_range"]
    return [(int(rng.integers(lo, hi + 1)), int(rng.choice(traffic["pocket_atoms"])))
            for _ in range(n)]


def write(datadir, traffic: dict, n_types: int) -> Path:
    """``n_train`` training and ``n_val`` validation complexes: a full-atom
    pocket shell of exactly its size around a Gaussian ligand cloud, shifted
    at random (the loader centres each complex), atom types at random."""
    rng = np.random.default_rng([traffic["traffic_seed"], 1])
    datadir = Path(datadir)
    datadir.mkdir(parents=True, exist_ok=True)
    n_train, n_val = traffic["n_train"], traffic["n_val"]
    sizes = complex_sizes(traffic, n_train + n_val)
    hist = np.zeros((traffic["lig_size_range"][1] + 1, max(traffic["pocket_atoms"]) + 1))
    for split, part in (("train", sizes[:n_train]), ("val", sizes[n_train:])):
        arrays = {k: [] for k in ("lig_coords", "lig_one_hot", "lig_mask",
                                  "pocket_coords", "pocket_one_hot", "pocket_mask")}
        for i, (nl, npk) in enumerate(part):
            residues, _ = pocket_atoms(npk, rng, keep=None)
            pocket = np.array([xyz for _, atoms in residues for _, _, xyz in atoms])[:npk]
            ligand = rng.standard_normal((nl, 3)) * 1.5
            shift = rng.uniform(-20, 20, 3)
            arrays["lig_coords"].append(ligand + shift)
            arrays["pocket_coords"].append(pocket + shift)
            arrays["lig_one_hot"].append(np.eye(n_types)[rng.integers(0, n_types, nl)])
            arrays["pocket_one_hot"].append(np.eye(n_types)[rng.integers(0, 4, npk)])
            arrays["lig_mask"].append(np.full(nl, i, float))
            arrays["pocket_mask"].append(np.full(npk, i, float))
            if split == "train":
                hist[nl, npk] += 1
        np.savez(datadir / f"{split}.npz",
                 names=np.array([f"{split}_{i}" for i in range(len(part))]),
                 **{k: np.concatenate(v).astype(np.float32) for k, v in arrays.items()})
    np.save(datadir / "size_distribution.npy", hist)
    return datadir
