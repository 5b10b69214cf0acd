"""Synthetic full-atom pockets (chain A) around a 12-atom ligand residue
(HETATM LIG A:900), after ``chip_smoke.py``'s ``pocket_atoms`` /
``write_pocket_pdb``, with one change: a residue is kept only when one of
its atoms lies within ``KEEP`` A of a ligand atom, so that DiffSBDD's 8 A
pocket selection takes every residue and the pocket's atom count is the
generator's, whatever the seed.

A sampling mix's pool of requests (pockets and ligand sizes) comes from the
mix's own seed, the same for every run seed: the pairs inside the cutoffs,
which set the kernels' work, vary by some 5% from one drawn pool to another.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

KEEP = 7.5  # below the 8 A selection cutoff, with room for the PDB's rounding

RESIDUES = [
    ("GLY", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O")]),
    ("ALA", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C")]),
    ("SER", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("OG", "O")]),
    ("CYS", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("SG", "S")]),
    ("THR", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("OG1", "O"), ("CG2", "C")]),
    ("ASP", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("CG", "C"), ("OD1", "O"), ("OD2", "O")]),
    ("MET", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("CG", "C"), ("SD", "S"), ("CE", "C")]),
    ("LYS", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("CG", "C"), ("CD", "C"), ("CE", "C"), ("NZ", "N")]),
]


def pocket_atoms(n_atoms: int, rng: np.random.Generator, keep: float = KEEP):
    """Residues (centres 4.5-9.5 A from the origin, atoms within 1.5 A of
    their centre) until at least ``n_atoms`` atoms, and a 12-atom ligand
    within 2 A of the origin.  With ``keep`` only residues that come within
    ``keep`` A of the ligand.  Returns (residues, ligand): lists of
    (resname, [(name, element, xyz)]) and [(name, element, xyz)]."""
    ligand = [(f"{el}{k}", el, rng.uniform(-1.0, 1.0, 3) * 2.0 / np.sqrt(3))
              for k, el in enumerate(["C"] * 8 + ["N"] * 2 + ["O"] * 2)]
    lig = np.array([xyz for _, _, xyz in ligand])
    residues, count = [], 0
    while count < n_atoms:
        name, atoms = RESIDUES[rng.integers(len(RESIDUES))]
        d = rng.standard_normal(3)
        centre = d / np.linalg.norm(d) * rng.uniform(4.5, 9.5)
        placed = [(a, el, centre + rng.uniform(-1.5, 1.5, 3) / np.sqrt(3))
                  for a, el in atoms]
        xyz = np.array([p[2] for p in placed])
        if keep is not None and np.sqrt(((xyz[:, None] - lig[None]) ** 2).sum(-1).min()) >= keep:
            continue
        residues.append((name, placed))
        count += len(placed)
    return residues, ligand


def write_pdb(path, residues, ligand) -> str:
    """Write residues 1..n of chain A and the ligand as PDB; returns the
    ligand's '<chain>:<resi>'."""
    lines, serial = [], 1

    def record(rec, name, resname, resseq, xyz, el):
        nonlocal serial
        field = name if len(name) == 4 else f" {name:<3}"
        lines.append(f"{rec:<6}{serial:5d} {field} {resname:>3} A{resseq:4d}    "
                     f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00"
                     f"          {el:>2}")
        serial += 1

    for resseq, (resname, atoms) in enumerate(residues, start=1):
        for name, el, xyz in atoms:
            record("ATOM", name, resname, resseq, xyz, el)
    for name, el, xyz in ligand:
        record("HETATM", name, "LIG", 900, xyz, el)
    Path(path).write_text("\n".join(lines + ["END"]) + "\n")
    return "A:900"


def request_plan(traffic: dict, n_requests: int):
    """The mix's requests, the same for every seed: per request the pocket's
    atom target (cycling through ``pocket_atoms``) and the ligand sizes
    (``n_samples`` drawn in ``lig_size_range`` from ``traffic_seed``)."""
    rng = np.random.default_rng(traffic["traffic_seed"])
    lo, hi = traffic["lig_size_range"]
    targets = traffic["pocket_atoms"]
    return [dict(pocket_atoms=int(targets[r % len(targets)]),
                 lig_sizes=rng.integers(lo, hi + 1, traffic["n_samples"]))
            for r in range(n_requests)]


def write_pockets(outdir, traffic: dict, plan):
    """One PDB a request of ``plan``, coordinates from the mix's seed;
    returns the paths and the ligand id."""
    rng = np.random.default_rng([traffic["traffic_seed"], 1])
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    paths = []
    for r, req in enumerate(plan):
        residues, ligand = pocket_atoms(req["pocket_atoms"], rng)
        path = outdir / f"pocket_{r}.pdb"
        ref = write_pdb(path, residues, ligand)
        paths.append(str(path))
    return paths, ref
