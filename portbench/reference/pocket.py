"""A full-atom pocket read from a PDB file, as DiffSBDD builds it.

The pocket is every standard residue with an atom closer than 8 A to an
atom of the reference ligand residue (a HETATM record), in file order, its
atoms typed by element through the dataset's atom encoder (an element the
encoder lacks becomes ``others``; hydrogens are dropped when the encoder has
no H).  Coordinates are the PDB's fixed columns.
"""
from __future__ import annotations

import numpy as np

# DiffSBDD's atom types of the CrossDocked sets (ligand and full-atom pocket)
_ATOMS = ["C", "N", "O", "S", "B", "Br", "Cl", "P", "I", "F"]
DECODERS = {"crossdock": _ATOMS, "crossdock_full": _ATOMS + ["others"]}

STANDARD = {"ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
            "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL"}


def read(pdb_path, ref_ligand: str, encoder, cutoff: float = 8.0):
    """(coords (n, 3) float32, type indices (n,)) of the pocket."""
    chain, resi = ref_ligand.split(":")
    residues, ligand = {}, []
    for line in open(pdb_path):
        rec = line[:6].strip()
        if rec not in ("ATOM", "HETATM"):
            continue
        xyz = [float(line[30:38]), float(line[38:46]), float(line[46:54])]
        el = line[76:78].strip().capitalize()
        key = (line[21], int(line[22:26]), line[17:20].strip())
        if rec == "HETATM" and key[0] == chain and key[1] == int(resi):
            ligand.append(xyz)
        elif key[2] in STANDARD:
            residues.setdefault(key, []).append((el, xyz))
    lig = np.asarray(ligand, np.float32)
    coords, types = [], []
    for atoms in residues.values():
        rc = np.asarray([a[1] for a in atoms], np.float32)
        d2 = ((rc[:, None, :] - lig[None, :, :]) ** 2).sum(-1)
        if float(np.sqrt(d2.min())) >= cutoff:
            continue
        for el, xyz in atoms:
            if el == "H" and "H" not in encoder:
                continue
            coords.append(xyz)
            types.append(encoder[el] if el in encoder else encoder["others"])
    return np.asarray(coords, np.float32), np.asarray(types, np.int64)
