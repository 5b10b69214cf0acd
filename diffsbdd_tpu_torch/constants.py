"""Chemical constants and per-dataset parameters.

The port's own copy of the parts of ``diffsbdd_tpu/constants.py`` that
molecule building, rendering and data processing need: bond-length tables
(pm), the maximum valences, the bond-perception margins, the idealized
backbone geometry and the ``bindingmoad`` / ``crossdock`` /
``crossdock_full`` type spaces with their bond matrices generated from the
element tables and their rendering colours and radii.
"""
from __future__ import annotations

import numpy as np

# margins (pm) added to table bond lengths when perceiving bonds of order 1/2/3
MARGINS = (3, 2, 1)

# maximum valences used by the table-based validity check
ALLOWED_BONDS = {
    "H": 1, "C": 4, "N": 3, "O": 2, "F": 1, "B": 3, "Al": 3, "Si": 4,
    "P": [3, 5], "S": 4, "Cl": 1, "As": 3, "Br": 1, "I": 1, "Hg": [1, 2],
    "Bi": [3, 5],
}

# single-bond lengths in pm, symmetric access via bond_length()
BONDS1 = {
    "H": {"H": 74, "C": 109, "N": 101, "O": 96, "F": 92, "B": 119, "Si": 148,
          "P": 144, "As": 152, "S": 134, "Cl": 127, "Br": 141, "I": 161},
    "C": {"H": 109, "C": 154, "N": 147, "O": 143, "F": 135, "Si": 185,
          "P": 184, "S": 182, "Cl": 177, "Br": 194, "I": 214},
    "N": {"H": 101, "C": 147, "N": 145, "O": 140, "F": 136, "Cl": 175,
          "Br": 214, "S": 168, "I": 222, "P": 177},
    "O": {"H": 96, "C": 143, "N": 140, "O": 148, "F": 142, "Br": 172,
          "S": 151, "P": 163, "Si": 163, "Cl": 164, "I": 194},
    "F": {"H": 92, "C": 135, "N": 136, "O": 142, "F": 142, "S": 158,
          "Si": 160, "Cl": 166, "Br": 178, "P": 156, "I": 187},
    "B": {"H": 119, "Cl": 175},
    "Si": {"Si": 233, "H": 148, "C": 185, "O": 163, "S": 200, "F": 160,
           "Cl": 202, "Br": 215, "I": 243},
    "Cl": {"Cl": 199, "H": 127, "C": 177, "N": 175, "O": 164, "P": 203,
           "S": 207, "B": 175, "Si": 202, "F": 166, "Br": 214},
    "S": {"H": 134, "C": 182, "N": 168, "O": 151, "S": 204, "F": 158,
          "Cl": 207, "Br": 225, "Si": 200, "P": 210, "I": 234},
    "Br": {"Br": 228, "H": 141, "C": 194, "O": 172, "N": 214, "Si": 215,
           "S": 225, "F": 178, "Cl": 214, "P": 222},
    "P": {"P": 221, "H": 144, "C": 184, "O": 163, "Cl": 203, "S": 210,
          "F": 156, "N": 177, "Br": 222},
    "I": {"H": 161, "C": 214, "Si": 243, "N": 222, "O": 194, "S": 234,
          "F": 187, "I": 266},
    "As": {"H": 152},
}

BONDS2 = {
    "C": {"C": 134, "N": 129, "O": 120, "S": 160},
    "N": {"C": 129, "N": 125, "O": 121},
    "O": {"C": 120, "N": 121, "O": 121, "P": 150},
    "P": {"O": 150, "S": 186},
    "S": {"P": 186, "C": 160},
}

BONDS3 = {
    "C": {"C": 120, "N": 116, "O": 113},
    "N": {"C": 116, "N": 110},
    "O": {"C": 113},
}


def bond_length(table: dict, a: str, b: str) -> float:
    """Symmetric lookup; 0 when no bond of that order exists for the pair."""
    if a in table and b in table[a]:
        return float(table[a][b])
    if b in table and a in table[b]:
        return float(table[b][a])
    return 0.0


def build_bond_matrix(decoder, table) -> np.ndarray:
    """(A, A) matrix of bond lengths (pm) for an atom-type decoder list."""
    n = len(decoder)
    out = np.zeros((n, n), dtype=np.float64)
    for i, a in enumerate(decoder):
        for j, b in enumerate(decoder):
            out[i, j] = bond_length(table, a, b)
    return out


COVALENT_RADII = {
    "H": 32, "C": 60, "N": 54, "O": 53, "F": 53, "B": 73, "Al": 111,
    "Si": 102, "P": 94, "S": 94, "Cl": 93, "As": 106, "Br": 109, "I": 125,
    "Hg": 133, "Bi": 135,
}

# idealized backbone geometry (Bhagavan & Ha, Essentials of Medical
# Biochemistry 2015, ch. 4)
N_CA_DIST = 1.47
CA_C_DIST = 1.53
N_CA_C_ANGLE = 110 * np.pi / 180


def build_lennard_jones_rm(decoder) -> np.ndarray:
    """(A, A) optimal LJ radii (pm): the shortest tabulated bond length, or
    the sum of covalent radii for pairs that never bond."""
    n = len(decoder)
    out = np.zeros((n, n), dtype=np.float64)
    for i, a in enumerate(decoder):
        for j, b in enumerate(decoder):
            candidates = [bond_length(t, a, b) for t in (BONDS1, BONDS2, BONDS3)]
            candidates = [c for c in candidates if c > 0]
            if candidates:
                out[i, j] = min(candidates)
            elif a in COVALENT_RADII and b in COVALENT_RADII:
                out[i, j] = COVALENT_RADII[a] + COVALENT_RADII[b]
    return out


_LIG_ATOMS = ["C", "N", "O", "S", "B", "Br", "Cl", "P", "I", "F"]
_AA20 = ["A", "C", "D", "E", "F", "G", "H", "I", "K", "L",
         "M", "N", "P", "Q", "R", "S", "T", "V", "W", "Y"]
# PyMOL element colours (pymolwiki.org Color_Values)
_COLORS10 = ["#33ff33", "#3333ff", "#ff4d4d", "#e6c540", "#ffb5b5",
             "#A62929", "#1FF01F", "#ff8000", "#940094", "#B3FFFF"]


def _dataset(atom_decoder, aa_decoder, atom_hist, aa_hist, colors):
    return {
        "atom_encoder": {a: i for i, a in enumerate(atom_decoder)},
        "atom_decoder": list(atom_decoder),
        "aa_encoder": {a: i for i, a in enumerate(aa_decoder)},
        "aa_decoder": list(aa_decoder),
        # the radii follow the colours, which bindingmoad has 11 of for its
        # 10 atom types, as the reference has them
        "colors_dic": list(colors),
        "radius_dic": [0.3] * len(colors),
        "bonds1": build_bond_matrix(atom_decoder, BONDS1),
        "bonds2": build_bond_matrix(atom_decoder, BONDS2),
        "bonds3": build_bond_matrix(atom_decoder, BONDS3),
        "lennard_jones_rm": build_lennard_jones_rm(atom_decoder),
        "atom_hist": dict(atom_hist),
        "aa_hist": dict(aa_hist),
    }


# the type histograms are dataset statistics (atom types of the ligands,
# residue or atom types of the pockets), the priors of the atom-type KL metric
dataset_params = {
    # CA or full-atom pockets: residues typed by amino acid, or (full-atom)
    # pocket atoms typed like ligand atoms
    "bindingmoad": _dataset(
        _LIG_ATOMS, _AA20,
        atom_hist={"C": 545542, "N": 90205, "O": 132965, "S": 9342, "B": 109,
                   "Br": 1424, "Cl": 5516, "P": 5154, "I": 445, "F": 9742},
        aa_hist={"A": 109798, "C": 31556, "D": 83921, "E": 79405, "F": 97083,
                 "G": 139319, "H": 62661, "I": 99008, "K": 62403, "L": 155105,
                 "M": 59977, "N": 70437, "P": 58833, "Q": 48254, "R": 74215,
                 "S": 103286, "T": 90972, "V": 119954, "W": 42017, "Y": 90596},
        colors=_COLORS10 + ["#b3e3f5"]),
    # CA pocket representation: residues typed by amino acid
    "crossdock": _dataset(
        _LIG_ATOMS, _AA20,
        atom_hist={"C": 1570032, "N": 273792, "O": 396623, "S": 26339, "B": 0,
                   "Br": 0, "Cl": 15055, "P": 25975, "I": 0, "F": 30673},
        aa_hist={"A": 277175, "C": 92406, "D": 254046, "E": 201833,
                 "F": 234995, "G": 376966, "H": 147704, "I": 290683,
                 "K": 173210, "L": 421883, "M": 157813, "N": 174241,
                 "P": 148581, "Q": 120232, "R": 173848, "S": 274430,
                 "T": 247605, "V": 326134, "W": 88552, "Y": 226668},
        colors=_COLORS10),
    # full-atom pocket representation: pocket atoms typed like ligand atoms
    "crossdock_full": _dataset(
        _LIG_ATOMS + ["others"], _LIG_ATOMS + ["others"],
        atom_hist={"C": 1570767, "N": 273858, "O": 396837, "S": 26352, "B": 0,
                   "Br": 0, "Cl": 15058, "P": 25994, "I": 0, "F": 30687,
                   "others": 0},
        aa_hist={"C": 23302704, "N": 6093090, "O": 6701210, "S": 276805,
                 "B": 0, "Br": 0, "Cl": 0, "P": 0, "I": 0, "F": 0,
                 "others": 0},
        colors=_COLORS10 + ["#ffb5b5"]),
}
