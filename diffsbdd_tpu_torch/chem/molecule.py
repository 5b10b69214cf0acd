"""Molecule construction and filtering without chemistry libraries.

A generated ligand becomes a ``SimpleMol``: atoms, coordinates and typed
bonds perceived from the EDM bond-length tables (numpy), with a valence-table
validity check standing in for RDKit sanitization and union-find fragments
for largest-fragment extraction.  RDKit and OpenBabel are never imported.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

from diffsbdd_tpu_torch.constants import ALLOWED_BONDS, MARGINS


@dataclasses.dataclass
class SimpleMol:
    """Atoms + coordinates + typed bonds; the host-side molecule object."""

    symbols: List[str]
    coords: np.ndarray  # (N, 3) float32
    bonds: List[Tuple[int, int, int]]  # (i, j, order), each pair once
    name: str = ""

    @property
    def n_atoms(self) -> int:
        return len(self.symbols)

    def neighbor_orders(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.n_atoms)]
        for i, j, o in self.bonds:
            out[i].append(o)
            out[j].append(o)
        return out

    def fragments(self) -> List[List[int]]:
        """Connected components (sorted by size, largest first)."""
        parent = list(range(self.n_atoms))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for i, j, _ in self.bonds:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
        groups = {}
        for i in range(self.n_atoms):
            groups.setdefault(find(i), []).append(i)
        return sorted(groups.values(), key=len, reverse=True)

    def subset(self, idx: Sequence[int]) -> "SimpleMol":
        idx = list(idx)
        remap = {a: k for k, a in enumerate(idx)}
        bonds = [(remap[i], remap[j], o) for i, j, o in self.bonds
                 if i in remap and j in remap]
        return SimpleMol(symbols=[self.symbols[i] for i in idx],
                         coords=self.coords[idx], bonds=bonds, name=self.name)

    def largest_fragment(self) -> "SimpleMol":
        frags = self.fragments()
        return self.subset(frags[0]) if frags else self

    def check_valency(self) -> bool:
        """True when every atom's bond-order sum is at most its maximum
        allowed valence (aromatic bonds, order 4, count 1.5)."""
        for sym, orders in zip(self.symbols, self.neighbor_orders()):
            allowed = ALLOWED_BONDS.get(sym)
            if allowed is None:
                return False
            total = sum(1.5 if o == 4 else o for o in orders)
            if total > (max(allowed) if isinstance(allowed, list) else allowed):
                return False
        return True


def get_bond_order_batch(atoms1, atoms2, distances, dataset_info) -> np.ndarray:
    """EDM bond orders from distances (Angstrom): single, then double, then
    triple thresholds, higher orders overwriting lower ones."""
    atoms1 = np.asarray(atoms1)
    atoms2 = np.asarray(atoms2)
    d_pm = 100.0 * np.asarray(distances)
    b1 = np.asarray(dataset_info["bonds1"])[atoms1, atoms2]
    b2 = np.asarray(dataset_info["bonds2"])[atoms1, atoms2]
    b3 = np.asarray(dataset_info["bonds3"])[atoms1, atoms2]
    m1, m2, m3 = MARGINS
    orders = np.zeros(d_pm.shape, dtype=np.int32)
    orders[d_pm < b1 + m1] = 1
    orders[d_pm < b2 + m2] = 2
    orders[d_pm < b3 + m3] = 3
    return orders


def perceive_bonds_edm(positions: np.ndarray, atom_types: np.ndarray,
                       dataset_info) -> List[Tuple[int, int, int]]:
    """Lower-triangle bond list (i > j) from pairwise distances."""
    pos = np.asarray(positions, dtype=np.float64)
    n = len(pos)
    if n == 0:
        return []
    d = np.sqrt(((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    a1 = np.broadcast_to(np.asarray(atom_types)[:, None], (n, n))
    a2 = np.broadcast_to(np.asarray(atom_types)[None, :], (n, n))
    orders = get_bond_order_batch(a1.ravel(), a2.ravel(), d.ravel(),
                                  dataset_info).reshape(n, n)
    orders = np.tril(orders, k=-1)
    ii, jj = np.nonzero(orders)
    return [(i, j, int(orders[i, j])) for i, j in zip(ii.tolist(), jj.tolist())]


def build_molecule(positions, atom_types, dataset_info) -> SimpleMol:
    """Coordinates + type indices -> SimpleMol with EDM-table bonds."""
    positions = np.asarray(positions, dtype=np.float32)
    atom_types = np.asarray(atom_types, dtype=np.int64)
    decoder = dataset_info["atom_decoder"]
    return SimpleMol(symbols=[decoder[int(t)] for t in atom_types],
                     coords=positions,
                     bonds=perceive_bonds_edm(positions, atom_types, dataset_info))


def process_molecule(mol: Optional[SimpleMol], sanitize=False, relax_iter=0,
                     largest_frag=False) -> Optional[SimpleMol]:
    """Filter/transform pipeline; None when the molecule fails a requested
    filter.  ``sanitize`` is the valence-table check; force-field relaxation
    needs RDKit and is skipped with a warning."""
    if mol is None:
        return None
    out = SimpleMol(symbols=list(mol.symbols), coords=np.array(mol.coords),
                    bonds=list(mol.bonds), name=mol.name)
    if sanitize and not out.check_valency():
        return None
    if largest_frag:
        out = out.largest_fragment()
        if sanitize and not out.check_valency():
            return None
    if relax_iter > 0:
        warnings.warn("UFF relaxation requires RDKit; skipping")
    return out
