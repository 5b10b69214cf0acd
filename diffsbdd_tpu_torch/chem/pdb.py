"""Minimal PDB parsing: residues, atoms and coordinates of the first model,
pocket selection around a reference ligand, and receptor files without their
ligands."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from diffsbdd_tpu_torch.chem.sdfio import read_sdf

# three-letter -> one-letter codes for the 20 standard amino acids
THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
}
STANDARD_AA = set(THREE_TO_ONE)


@dataclasses.dataclass
class Atom:
    name: str
    element: str
    coord: np.ndarray  # (3,)
    is_hetero: bool
    serial: int = 0


@dataclasses.dataclass
class Residue:
    chain_id: str
    resname: str
    resseq: int
    icode: str
    atoms: List[Atom]

    @property
    def is_standard_aa(self) -> bool:
        return self.resname in STANDARD_AA

    def one_letter(self) -> str:
        return THREE_TO_ONE[self.resname]

    def get_atom(self, name: str) -> Optional[Atom]:
        for a in self.atoms:
            if a.name == name:
                return a
        return None

    def coords(self, heavy_only: bool = True) -> np.ndarray:
        atoms = [a for a in self.atoms if not (heavy_only and a.element == "H")]
        return np.array([a.coord for a in atoms], dtype=np.float32)


class Structure:
    """First model of a PDB file: residues indexed by (chain, resseq)."""

    def __init__(self, residues: List[Residue]):
        self.residues = residues
        self._index: Dict[tuple, List[Residue]] = {}
        for r in residues:
            self._index.setdefault((r.chain_id, r.resseq), []).append(r)

    def get_residues(self) -> List[Residue]:
        return self.residues

    def residues_of_chain(self, chain_id: str) -> List[Residue]:
        return [r for r in self.residues if r.chain_id == chain_id]

    def residue(self, chain_id: str, resseq: int) -> Residue:
        """The unique residue at (chain, resseq).

        Raises KeyError when the address is ambiguous — e.g. insertion-code
        variants (100 vs 100A) or an ATOM residue and a HETATM ligand
        sharing a number.  Silently picking one would extract the wrong
        pocket/ligand; the reference fails loudly too
        (utils.get_residue_with_resi asserts exactly one match)."""
        matches = self._index[(chain_id, resseq)]
        if len(matches) > 1:
            desc = ", ".join(f"{r.resname}{r.resseq}{r.icode.strip()}"
                             for r in matches)
            raise KeyError(
                f"ambiguous residue {chain_id}:{resseq} ({desc}); "
                f"the PDB uses insertion codes or duplicate numbering")
        return matches[0]


def _element_from_record(line: str, atom_name: str) -> str:
    elem = line[76:78].strip() if len(line) >= 78 else ""
    if elem:
        return elem.capitalize()
    # fall back to the atom-name heuristic.  PDB column alignment
    # disambiguates: two-letter elements start at column 13 ('CA  ' is
    # calcium), one-letter elements at column 14 (' CA ' is an alpha
    # carbon) — the check must use the UNSTRIPPED name field, as BioPython
    # does, or every backbone CA becomes calcium
    name_field = line[12:16]
    name = atom_name.strip()
    while name and name[0].isdigit():
        name = name[1:]
    if (len(name) >= 2 and not name_field.startswith(" ")
            and name[:2].capitalize() in {
                "Cl", "Br", "Fe", "Zn", "Mg", "Mn", "Na", "Ca", "Cu", "Se"}):
        return name[:2].capitalize()
    return name[:1].upper()


def parse_pdb(path) -> Structure:
    """Parse the first model of a PDB file into a Structure.

    Atom records of one residue interrupted by other residues' records are
    merged back into the first occurrence, so a residue is never split into
    duplicate entries (which would make its (chain, resseq) address look
    ambiguous)."""
    residues: List[Residue] = []
    by_key: Dict[tuple, Residue] = {}
    current_key = None
    current: Optional[Residue] = None

    with open(path) as f:
        for line in f:
            rec = line[:6]
            if rec == "ENDMDL":
                break  # first model only, like PDBParser(...)[0]
            if rec not in ("ATOM  ", "HETATM"):
                continue
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue  # keep the primary conformation
            atom_name = line[12:16].strip()
            resname = line[17:20].strip()
            chain_id = line[21]
            resseq = int(line[22:26])
            icode = line[26]
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
            serial = int(line[6:11])
            key = (chain_id, resseq, icode, resname)
            if key != current_key:
                current = by_key.get(key)
                if current is None:
                    current = Residue(chain_id, resname, resseq, icode, [])
                    residues.append(current)
                    by_key[key] = current
                current_key = key
            current.atoms.append(Atom(
                name=atom_name,
                element=_element_from_record(line, atom_name),
                coord=np.array([x, y, z], dtype=np.float32),
                is_hetero=(rec == "HETATM"),
                serial=serial,
            ))
    return Structure(residues)


def get_pocket_residues_from_coords(
        structure: Structure, ligand_coords: np.ndarray,
        dist_cutoff: float = 8.0, skip_residue: Optional[Residue] = None
) -> List[Residue]:
    """Standard amino-acid residues with any atom within ``dist_cutoff`` of
    the ligand (utils.py:103-128 semantics).

    ``skip_residue`` excludes exactly THAT residue object (the reference
    ligand itself, when it lives inside the PDB) — matching by residue
    number alone would also drop same-numbered standard residues in other
    chains."""
    pocket = []
    lig = np.asarray(ligand_coords, dtype=np.float32)
    for res in structure.get_residues():
        if res is skip_residue:
            continue
        if not res.is_standard_aa:
            continue
        rc = np.array([a.coord for a in res.atoms], dtype=np.float32)
        d2 = ((rc[:, None, :] - lig[None, :, :]) ** 2).sum(-1)
        if float(np.sqrt(d2.min())) < dist_cutoff:
            pocket.append(res)
    return pocket


def get_pocket_from_ligand(structure: Structure, ref_ligand: str,
                           dist_cutoff: float = 8.0) -> List[Residue]:
    """Pocket residues from a reference ligand.

    ``ref_ligand`` is either '<chain>:<resi>', a ligand residue inside the PDB
    (which is then left out of the pocket), or the path of an SDF file whose
    first molecule gives the ligand atoms (no residue is left out).
    """
    if str(ref_ligand).endswith(".sdf"):
        mol = read_sdf(ref_ligand)[0]
        return get_pocket_residues_from_coords(structure, mol.coords, dist_cutoff)
    chain, resi = str(ref_ligand).split(":")
    lig_res = structure.residue(chain, int(resi))
    lig_coords = np.array([a.coord for a in lig_res.atoms], dtype=np.float32)
    return get_pocket_residues_from_coords(
        structure, lig_coords, dist_cutoff, skip_residue=lig_res)


def write_receptor_pdb(src_path, dst_path, exclude_hetero=()):
    """Copy the first model of ``src_path`` to ``dst_path`` without the
    HETATM records of the ligands ``exclude_hetero`` ((resname, chain,
    resseq) triples): the receptor a processed complex is docked against.
    CONECT and MASTER records are dropped (they may name removed serials);
    the other records pass through verbatim."""
    exclude = {(str(n).strip(), str(c), int(r)) for n, c, r in exclude_hetero}
    with open(src_path) as f_in, open(dst_path, "w") as f_out:
        for line in f_in:
            rec = line[:6]
            if rec == "ENDMDL":
                f_out.write("END\n")
                break
            if rec in ("CONECT", "MASTER"):
                continue
            if rec == "HETATM" and len(line) >= 27:
                key = (line[17:20].strip(), line[21], int(line[22:26]))
                if key in exclude:
                    continue
            f_out.write(line)
