"""SDF (MDL molfile V2000) reading and writing without external chemistry
libraries."""
from __future__ import annotations

from typing import List

import numpy as np


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


def read_sdf(path) -> List["SimpleMol"]:
    """Every V2000 molblock of an SDF file as a SimpleMol; blocks that do not
    parse are skipped."""
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
                continue
        except (ValueError, IndexError):
            continue
        mols.append(SimpleMol(symbols=symbols,
                              coords=np.array(coords, dtype=np.float32),
                              bonds=bonds,
                              name=lines[0].strip() if counts_idx >= 3 else ""))
    return mols
