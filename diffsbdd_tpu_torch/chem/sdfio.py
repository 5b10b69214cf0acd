"""SDF (MDL molfile V2000) and xyz reading and writing without external
chemistry libraries."""
from __future__ import annotations

import random
from pathlib import Path
from typing import List

import numpy as np


def write_xyz_file(coords, atom_types, filename):
    """One molecule as an xyz file: the atom count, a blank line, then
    '<symbol> x y z' rows with three decimals."""
    coords = np.asarray(coords)
    if len(coords) != len(atom_types):
        raise ValueError(f"{len(coords)} coordinates, {len(atom_types)} types")
    rows = [f"{len(coords)}\n\n"]
    rows += [f"{t} {x:.3f} {y:.3f} {z:.3f}\n"
             for t, (x, y, z) in zip(atom_types, coords)]
    with open(filename, "w") as f:
        f.write("".join(rows))


def load_xyz_files(path, shuffle=True):
    """The ``*.txt`` then ``*.xyz`` files of a directory, each group sorted;
    shuffled (``random.shuffle``) unless ``shuffle`` is False."""
    files = sorted(Path(path).glob("*.txt")) + sorted(Path(path).glob("*.xyz"))
    if shuffle:
        random.shuffle(files)
    return files


def load_molecule_xyz(file, atom_encoder):
    """One xyz file -> (coords (N, 3), one_hot (N, A)) float32 arrays."""
    with open(file) as f:
        n_atoms = int(f.readline())
        f.readline()
        coords = np.zeros((n_atoms, 3), dtype=np.float32)
        one_hot = np.zeros((n_atoms, len(atom_encoder)), dtype=np.float32)
        for i in range(n_atoms):
            parts = f.readline().split()
            coords[i] = [float(v) for v in parts[1:4]]
            one_hot[i, atom_encoder[parts[0]]] = 1.0
    return coords, one_hot


def _mol_block(mol, name="") -> str:
    n_atoms = len(mol.coords)
    n_bonds = len(mol.bonds)
    lines = [name, "  diffsbdd_tpu", ""]
    lines.append(f"{n_atoms:3d}{n_bonds:3d}  0  0  0  0  0  0  0  0999 V2000")
    for i in range(n_atoms):
        x, y, z = mol.coords[i]
        lines.append(
            f"{x:10.4f}{y:10.4f}{z:10.4f} {mol.symbols[i]:<3} 0  0  0  0  0  0  0  0  0  0  0  0")
    for (i, j, order) in mol.bonds:
        # orders are V2000-coded ints already (4 = aromatic)
        lines.append(f"{i + 1:3d}{j + 1:3d}{int(order):3d}  0")
    lines.append("M  END")
    return "\n".join(lines)


def write_sdf_file(sdf_path, molecules):
    """Write a list of SimpleMol to an SDF file, skipping None entries."""
    with open(sdf_path, "w") as f:
        for m in molecules:
            if m is None:
                continue
            f.write(_mol_block(m, name=m.name))
            f.write("\n$$$$\n")


def read_sdf(path, keep_invalid: bool = False) -> List["SimpleMol"]:
    """Every V2000 molblock of an SDF file as a SimpleMol.  A block that does
    not parse is skipped, or with ``keep_invalid`` stands as None, so that
    the list's indices stay those of the file (obabel's -f/-l count blocks
    so)."""
    from diffsbdd_tpu_torch.chem.molecule import SimpleMol

    mols = []
    with open(path) as f:
        content = f.read()
    for block in content.split("$$$$"):
        lines = block.strip("\n").split("\n")
        if len(lines) < 4:
            continue
        # the counts line usually ends in V2000, but the tag is optional:
        # fall back to its canonical position, line 4 of the molblock
        counts_idx = next((i for i, ln in enumerate(lines[:8])
                           if ln.rstrip().endswith("V2000")), 3)
        try:
            counts = lines[counts_idx]
            n_atoms, n_bonds = int(counts[0:3]), int(counts[3:6])
            symbols, coords, bonds = [], [], []
            for ln in lines[counts_idx + 1:counts_idx + 1 + n_atoms]:
                coords.append([float(ln[0:10]), float(ln[10:20]), float(ln[20:30])])
                symbols.append(ln[31:34].strip())
            first_bond = counts_idx + 1 + n_atoms
            for ln in lines[first_bond:first_bond + n_bonds]:
                bonds.append((int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])))
            if len(symbols) != n_atoms or len(bonds) != n_bonds:
                raise IndexError("truncated molblock")
        except (ValueError, IndexError):
            if keep_invalid:
                mols.append(None)
            continue
        mols.append(SimpleMol(symbols=symbols,
                              coords=np.array(coords, dtype=np.float32),
                              bonds=bonds,
                              name=lines[0].strip() if counts_idx >= 3 else ""))
    return mols
