"""Molecule construction and filtering without chemistry libraries.

A generated ligand becomes a ``SimpleMol``: atoms, coordinates and typed
bonds perceived from the EDM bond-length tables or from covalent radii
(numpy), with a valence-table validity check standing in for RDKit
sanitization, union-find fragments for largest-fragment extraction and a
Weisfeiler-Lehman hash standing in for canonical SMILES.  RDKit and OpenBabel
are never imported.
"""
from __future__ import annotations

import dataclasses
import hashlib
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

from diffsbdd_tpu_torch.chem import graphs
from diffsbdd_tpu_torch.constants import ALLOWED_BONDS, COVALENT_RADII, MARGINS


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

    def adjacency(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.n_atoms)]
        for i, j, _ in self.bonds:
            out[i].append(j)
            out[j].append(i)
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

    def is_connected(self) -> bool:
        return len(self.fragments()) <= 1

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

    def wl_labels(self, iterations: int) -> List[List[str]]:
        """Weisfeiler-Lehman atom labels labelled by element and bond order:
        the element hashes, then each of ``iterations`` refinements."""
        labels = [hashlib.sha1(s.encode()).hexdigest()[:8] for s in self.symbols]
        nbrs: List[List[Tuple[int, int]]] = [[] for _ in range(self.n_atoms)]
        for i, j, o in self.bonds:
            nbrs[i].append((j, o))
            nbrs[j].append((i, o))
        rounds = [labels]
        for _ in range(iterations):
            labels = [hashlib.sha1((labels[i] + "|" + ",".join(sorted(
                f"{o}:{labels[j]}" for j, o in nbrs[i]))).encode()).hexdigest()[:8]
                for i in range(self.n_atoms)]
            rounds.append(labels)
        return rounds

    def canonical_key(self, iterations: int = 4) -> str:
        """Weisfeiler-Lehman graph hash: a deterministic isomorphism-invariant
        key where canonical SMILES would serve (uniqueness and novelty
        bookkeeping)."""
        final = self.wl_labels(iterations)[-1]
        return hashlib.sha1(",".join(sorted(final)).encode()).hexdigest()

    def to_smiles(self) -> str:
        """The molecule's key: without RDKit, the WL key."""
        return self.canonical_key()


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


def perceive_bonds_covalent(positions, atom_types, dataset_info,
                            tolerance: float = 0.45) -> List[Tuple[int, int, int]]:
    """Covalent-radii bond perception, a deterministic stand-in for
    OpenBabel's: candidate bonds where ``0.4 < d < r_cov(a) + r_cov(b) +
    tolerance``; while an atom exceeds its maximum valence its candidates of
    largest excess over the covalent sum are dropped; orders from the EDM
    tables by nearest length (order k below the midpoint of the k and k-1
    lengths), then lowered (3 -> 2 -> 1) wherever an end's order sum exceeds
    its valence.  Unlike the EDM margins (0.03/0.02/0.01 A), its tolerance
    survives the ~0.02 A noise of the final decode."""
    pos = np.asarray(positions, dtype=np.float64)
    t = np.asarray(atom_types)
    n = len(pos)
    if n == 0:
        return []
    decoder = dataset_info["atom_decoder"]
    rcov = np.array([COVALENT_RADII.get(decoder[int(i)], 77) / 100.0 for i in t])
    d = np.sqrt(((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    limit = rcov[:, None] + rcov[None, :] + tolerance
    cand = np.tril((d < limit) & (d > 0.4), k=-1)
    ii, jj = np.nonzero(cand)
    max_val = {}
    for i_sym, sym in enumerate(decoder):
        a = ALLOWED_BONDS.get(sym)
        max_val[i_sym] = (max(a) if isinstance(a, list) else a) if a else 0
    # prune valence overflow, longest-excess bonds first
    bonds = sorted(zip(ii.tolist(), jj.tolist()),
                   key=lambda b: d[b[0], b[1]] - (rcov[b[0]] + rcov[b[1]]))
    degree = np.zeros(n, np.int64)
    kept = []
    for i, j in bonds:
        if degree[i] < max_val[int(t[i])] and degree[j] < max_val[int(t[j])]:
            kept.append((i, j))
            degree[i] += 1
            degree[j] += 1
    b1 = np.asarray(dataset_info["bonds1"]) / 100.0
    b2 = np.asarray(dataset_info["bonds2"]) / 100.0
    b3 = np.asarray(dataset_info["bonds3"]) / 100.0
    out = []
    order_sum = np.zeros(n, np.int64)
    for i, j in kept:
        ti, tj = int(t[i]), int(t[j])
        o = 1
        if b2[ti, tj] > 0 and d[i, j] < (b1[ti, tj] + b2[ti, tj]) / 2:
            o = 2
        if b3[ti, tj] > 0 and d[i, j] < (b2[ti, tj] + b3[ti, tj]) / 2:
            o = 3
        out.append([i, j, o])
        order_sum[i] += o
        order_sum[j] += o
    changed = True
    while changed:
        changed = False
        for rec in sorted(out, key=lambda r: -r[2]):
            i, j, o = rec
            if o > 1 and (order_sum[i] > max_val[int(t[i])]
                          or order_sum[j] > max_val[int(t[j])]):
                rec[2] = o - 1
                order_sum[i] -= 1
                order_sum[j] -= 1
                changed = True
    return [(i, j, o) for i, j, o in out]


def build_molecule(positions, atom_types, dataset_info, add_coords=True,
                   perception: Optional[str] = None) -> SimpleMol:
    """Coordinates + type indices -> SimpleMol.  ``perception`` picks the
    bonds: None or 'edm' (the EDM tables), 'covalent'
    (``perceive_bonds_covalent``); 'openbabel' raises, as the port has no
    OpenBabel.  The molecule always carries its coordinates, whatever
    ``add_coords`` says."""
    if perception not in (None, "edm", "covalent"):
        raise ValueError(f"bond perception {perception!r}: the port has 'edm' "
                         f"and 'covalent' (no OpenBabel)")
    positions = np.asarray(positions, dtype=np.float32)
    atom_types = np.asarray(atom_types, dtype=np.int64)
    decoder = dataset_info["atom_decoder"]
    perceive = perceive_bonds_covalent if perception == "covalent" \
        else perceive_bonds_edm
    return SimpleMol(symbols=[decoder[int(t)] for t in atom_types],
                     coords=positions,
                     bonds=perceive(positions, atom_types, dataset_info))


def process_molecule(mol: Optional[SimpleMol], add_hydrogens=False,
                     sanitize=False, relax_iter=0,
                     largest_frag=False) -> Optional[SimpleMol]:
    """Filter/transform pipeline; None when the molecule fails a requested
    filter.  ``sanitize`` is the valence-table check; adding hydrogens and
    force-field relaxation need RDKit and are skipped with a warning."""
    if mol is None:
        return None
    out = SimpleMol(symbols=list(mol.symbols), coords=np.array(mol.coords),
                    bonds=list(mol.bonds), name=mol.name)
    if sanitize and not out.check_valency():
        return None
    if add_hydrogens:
        warnings.warn("add_hydrogens requires RDKit; skipping")
    if largest_frag:
        out = out.largest_fragment()
        if sanitize and not out.check_valency():
            return None
    if relax_iter > 0:
        warnings.warn("UFF relaxation requires RDKit; skipping")
    return out


def filter_rd_mol(mol: SimpleMol) -> bool:
    """False for a molecule with two 3-rings that share an atom (rings from
    the cycle basis of the bond graph)."""
    rings = [set(c) for c in graphs.cycle_basis(
        graphs.graph(mol.n_atoms, [(i, j) for i, j, _ in mol.bonds]))]
    for i, ring_a in enumerate(rings):
        if len(ring_a) != 3:
            continue
        for j, ring_b in enumerate(rings):
            if i <= j:
                continue
            if len(ring_b) == 3 and ring_a & ring_b:
                return False
    return True
