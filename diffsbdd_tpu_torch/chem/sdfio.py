"""SDF (MDL molfile V2000) writing without external chemistry libraries."""
from __future__ import annotations


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
