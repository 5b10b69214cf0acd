"""Synthetic ligand-pocket training corpus from numpy and two protein PDBs.

No dataset archive is needed: the corpus is manufactured.

* **Molecular graphs** are sampled from the CrossDocked atom-type histogram
  (``constants.py``'s valencies and histograms): random trees with ring
  closures and bond-order upgrades, or assemblies of a small motif library,
  valence-correct by construction.
* **3D coordinates** are embedded from the single/double/triple bond-length
  tables by breadth-first placement and a few hundred steps of spring
  relaxation, then checked to round-trip through the EDM bond perception: a
  molecule is accepted only where ``perceive_bonds_edm`` on its coordinates
  recovers exactly the intended bonds, so every training molecule scores
  validity 1 and connectivity 1 under the repository's metrics.
* **Pocket patches** are carved from two proteins: the ligand is placed at
  a random surface site with clash resolution, and the pocket is the 8 A
  full-atom residue neighbourhood (one-hot by element, an 'others' column).

Training complexes come from one protein, validation and test from the other:
the held-out pockets come from a protein the model never saw.

Output: ``{train,val,test}.npz`` in the flat format of
``proc_crossdock.saveall``, ``size_distribution.npy`` and ``meta.json``,
loadable by ``LigandPocketDataset``.  For one seed and the same two PDBs the
arrays and the JSON are those of the JAX package's generator.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from diffsbdd_tpu_torch.chem import pdb as pdbmod
from diffsbdd_tpu_torch.chem.molecule import SimpleMol, perceive_bonds_edm
from diffsbdd_tpu_torch.constants import dataset_params
from diffsbdd_tpu_torch.data.proc_crossdock import get_n_nodes, saveall

# construction valences: conservative per-element bond budgets for graph
# growth (<= ALLOWED_BONDS maxima, constants.py:19-26, so valence checks
# pass with implicit hydrogens filling the remainder)
CONSTRUCT_VALENCE = {"C": 4, "N": 3, "O": 2, "S": 2, "P": 3, "Cl": 1, "F": 1}

# ---------------------------------------------------------------- motif graphs
# Recurring chemical building blocks.  Purely random graphs have no motif
# vocabulary to learn; real ligands are assembled from a small recurring
# fragment vocabulary, and these templates mirror that regularity.  Each
# motif: (symbols, internal bonds (i, j, order), attachment slot atom
# indices).
MOTIFS = {
    # 6-ring, Kekulé alternation (benzene-like)
    "ring6_arom": (["C"] * 6,
                   [(0, 1, 2), (1, 2, 1), (2, 3, 2), (3, 4, 1), (4, 5, 2),
                    (5, 0, 1)], [0, 1, 2, 3, 4, 5]),
    "ring6_sat": (["C"] * 6,
                  [(0, 1, 1), (1, 2, 1), (2, 3, 1), (3, 4, 1), (4, 5, 1),
                   (5, 0, 1)], [0, 1, 2, 3, 4, 5]),
    "ring5_O": (["O", "C", "C", "C", "C"],
                [(0, 1, 1), (1, 2, 1), (2, 3, 1), (3, 4, 1), (4, 0, 1)],
                [1, 2, 3, 4]),
    "ring6_N": (["N", "C", "C", "C", "C", "C"],
                [(0, 1, 1), (1, 2, 2), (2, 3, 1), (3, 4, 2), (4, 5, 1),
                 (5, 0, 2)], [1, 2, 3, 4, 5]),
    "amide": (["C", "O", "N"], [(0, 1, 2), (0, 2, 1)], [0, 2]),
    "carboxyl": (["C", "O", "O"], [(0, 1, 2), (0, 2, 1)], [0]),
    "chain2": (["C", "C"], [(0, 1, 1)], [0, 1]),
    "chain3": (["C", "C", "C"], [(0, 1, 1), (1, 2, 1)], [0, 1, 2]),
    "ether": (["C", "O", "C"], [(0, 1, 1), (1, 2, 1)], [0, 2]),
    "amine": (["C", "N"], [(0, 1, 1)], [0, 1]),
    "sulfide": (["C", "S"], [(0, 1, 1)], [0]),
}
# scaffold-biased pick frequencies (roughly drug-like composition)
MOTIF_WEIGHTS = {"ring6_arom": 3.0, "ring6_sat": 1.5, "ring5_O": 1.0,
                 "ring6_N": 1.5, "amide": 1.5, "carboxyl": 0.7,
                 "chain2": 2.0, "chain3": 1.5, "ether": 1.0, "amine": 1.2,
                 "sulfide": 0.3}
TERMINALS = (("C", 6.0), ("O", 1.5), ("N", 1.0), ("F", 0.5), ("Cl", 0.4))


def sample_graph_motif(rng: np.random.Generator, n_target: int, dinfo: dict,
                       ) -> Optional[Tuple[List[int], List[Tuple[int, int, int]]]]:
    """Molecular graph assembled from the motif library.

    Motifs are joined by single bonds at attachment slots with remaining
    valence, then open slots are capped with terminal atoms until the size
    target is reached.  Valence-correct by the same budgets as
    ``sample_graph``.
    """
    enc = dinfo["atom_encoder"]
    names = list(MOTIFS)
    w = np.array([MOTIF_WEIGHTS[m] for m in names], np.float64)
    w /= w.sum()
    t_syms = [t for t, _ in TERMINALS]
    t_w = np.array([p for _, p in TERMINALS], np.float64)
    t_w /= t_w.sum()

    symbols: List[str] = []
    bonds: List[Tuple[int, int, int]] = []
    cap: List[int] = []
    slots: List[int] = []

    def add_motif(name):
        syms, mb, att = MOTIFS[name]
        base = len(symbols)
        symbols.extend(syms)
        cap.extend(CONSTRUCT_VALENCE[s] for s in syms)
        for i, j, o in mb:
            bonds.append((base + i, base + j, o))
            cap[base + i] -= o
            cap[base + j] -= o
        slots.extend(base + a for a in att)
        return base

    add_motif(names[int(rng.choice(len(names), p=w))])
    for _ in range(40):
        if len(symbols) >= n_target:
            break
        open_slots = [s for s in slots if cap[s] > 0]
        if not open_slots:
            break
        host = int(rng.choice(open_slots))
        room = n_target - len(symbols)
        if room >= 2 and rng.random() < 0.55:
            name = names[int(rng.choice(len(names), p=w))]
            if len(MOTIFS[name][0]) > room:
                continue
            base = add_motif(name)
            # join host to the new motif's first open attachment slot
            att = [base + a for a in MOTIFS[name][2]
                   if cap[base + a] > 0]
            if not att:
                continue
            j = att[0]
            bonds.append((j, host, 1))
            cap[j] -= 1
            cap[host] -= 1
        else:
            sym = t_syms[int(rng.choice(len(t_syms), p=t_w))]
            j = len(symbols)
            symbols.append(sym)
            cap.append(CONSTRUCT_VALENCE[sym] - 1)
            cap[host] -= 1
            bonds.append((j, host, 1))
            slots.append(j)
    if not (4 <= len(symbols)):
        return None
    tidx = [enc[s] for s in symbols]
    return tidx, bonds


# --------------------------------------------------------------------- graphs
def _sample_symbols(rng: np.random.Generator, n: int, pool: List[str],
                    probs: np.ndarray) -> List[str]:
    syms = list(rng.choice(pool, size=n, p=probs))
    # the growth frontier needs interior capacity: force the root to be
    # multivalent and keep monovalent atoms in the minority
    if CONSTRUCT_VALENCE[syms[0]] < 2:
        syms[0] = "C"
    return syms


def sample_graph(rng: np.random.Generator, n: int, dinfo: dict,
                 double_p: float = 0.25, triple_p: float = 0.03,
                 ring_lambda: float = 0.7,
                 ) -> Optional[Tuple[List[int], List[Tuple[int, int, int]]]]:
    """Random valence-correct connected molecular graph.

    Returns (atom type indices, bonds as lower-triangle (i, j, order)) or
    None when growth fails (capacity exhausted — caller retries).
    """
    enc = dinfo["atom_encoder"]
    hist = dinfo["atom_hist"]
    pool = [s for s, c in hist.items() if c > 0 and s in CONSTRUCT_VALENCE]
    probs = np.array([hist[s] for s in pool], np.float64)
    probs /= probs.sum()
    syms = _sample_symbols(rng, n, pool, probs)
    cap = np.array([CONSTRUCT_VALENCE[s] for s in syms], np.int64)

    bonds: List[Tuple[int, int, int]] = []
    adj = [set() for _ in range(n)]
    # spanning tree: attach each new atom to a capacity-weighted open parent
    for i in range(1, n):
        open_slots = np.flatnonzero(cap[:i] > 0)
        if open_slots.size == 0:
            return None
        w = cap[open_slots].astype(np.float64)
        parent = int(rng.choice(open_slots, p=w / w.sum()))
        bonds.append((i, parent, 1))
        adj[i].add(parent)
        adj[parent].add(i)
        cap[i] -= 1
        cap[parent] -= 1

    # ring closures between atoms at tree distance 4-6 (ring size 5-7;
    # 3/4-rings are excluded — their 1-3 geometry breaks the distance-table
    # bond perception and the reference filters fused 3-rings anyway,
    # molecule_builder.py:229-250)
    n_rings = min(int(rng.poisson(ring_lambda)), 2)
    for _ in range(n_rings):
        cands = []
        open_atoms = np.flatnonzero(cap > 0)
        for a in open_atoms:
            # BFS distances from a (n is small)
            dist = {int(a): 0}
            frontier = [int(a)]
            while frontier:
                nxt = []
                for u in frontier:
                    for v in adj[u]:
                        if v not in dist:
                            dist[v] = dist[u] + 1
                            nxt.append(v)
                frontier = nxt
            for b in open_atoms:
                if b > a and dist.get(int(b), 99) in (4, 5, 6):
                    cands.append((int(b), int(a)))
        if not cands:
            break
        i, j = cands[int(rng.integers(len(cands)))]
        bonds.append((i, j, 1))
        adj[i].add(j)
        adj[j].add(i)
        cap[i] -= 1
        cap[j] -= 1

    # bond-order upgrades where the tables define the higher order and both
    # endpoints have spare capacity
    b2 = np.asarray(dinfo["bonds2"])
    b3 = np.asarray(dinfo["bonds3"])
    tidx = [enc[s] for s in syms]
    out: List[Tuple[int, int, int]] = []
    for (i, j, o) in bonds:
        ti, tj = tidx[i], tidx[j]
        if cap[i] >= 2 and cap[j] >= 2 and b3[ti, tj] > 0 and \
                rng.random() < triple_p:
            o = 3
            cap[i] -= 2
            cap[j] -= 2
        elif cap[i] >= 1 and cap[j] >= 1 and b2[ti, tj] > 0 and \
                rng.random() < double_p:
            o = 2
            cap[i] -= 1
            cap[j] -= 1
        out.append((i, j, o))
    return tidx, out


# ------------------------------------------------------------------ embedding
def _bond_targets(tidx: Sequence[int], bonds, dinfo) -> np.ndarray:
    tables = (np.asarray(dinfo["bonds1"]), np.asarray(dinfo["bonds2"]),
              np.asarray(dinfo["bonds3"]))
    d0 = np.zeros((len(tidx), len(tidx)), np.float64)
    for i, j, o in bonds:
        d0[i, j] = d0[j, i] = tables[o - 1][tidx[i], tidx[j]] / 100.0
    return d0


def _bfs_init(rng, n, bonds, d0) -> np.ndarray:
    """Breadth-first initial placement: each atom at its parent plus a
    random direction of the target bond length, best-of-K for clearance."""
    adj = [[] for _ in range(n)]
    for i, j, _ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    x = np.zeros((n, 3))
    placed = [0]
    seen = {0}
    queue = [0]
    while queue:
        u = queue.pop(0)
        for v in adj[u]:
            if v in seen:
                continue
            seen.add(v)
            queue.append(v)
            dirs = rng.standard_normal((24, 3))
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            cand = x[u] + dirs * d0[u, v]
            prev = x[np.array(placed)]
            clearance = np.linalg.norm(
                cand[:, None, :] - prev[None, :, :], axis=-1).min(1)
            x[v] = cand[int(np.argmax(clearance))]
            placed.append(v)
    return x


def embed_molecule(rng: np.random.Generator, tidx: Sequence[int], bonds,
                   dinfo: dict, iters: int = 400,
                   ) -> Optional[np.ndarray]:
    """Spring-relaxed 3D embedding hitting the bond-length tables.

    Bonded pairs are pulled to their table length; non-bonded pairs are
    pushed apart beyond both the single-bond perception threshold
    (bonds1 + margin, so no spurious bonds appear) and a 2.4 A comfort
    radius (1-3 pairs land at chemically plausible angles).
    """
    n = len(tidx)
    d0 = _bond_targets(tidx, bonds, dinfo)
    bonded = d0 > 0
    t = np.asarray(tidx)
    b1 = np.asarray(dinfo["bonds1"])[t[:, None], t[None, :]] / 100.0
    # hard floor for non-bonded pairs: single-bond threshold + 0.2 A
    floor = np.where(~bonded, np.maximum(b1 + 0.05, 0.0) + 0.2, 0.0)
    soft = np.where(~bonded, 2.4, 0.0)
    np.fill_diagonal(floor, 0.0)
    np.fill_diagonal(soft, 0.0)

    x = _bfs_init(rng, n, bonds, d0)
    # drug-like compactness target: real ligands are compact (r_gyr ~ 2.5-4 A
    # for 8-26 heavy atoms), while a pure-repulsion embedding produces
    # extended chains whose weak long-range coupling makes the diffusion
    # model's mid-chain coherence unnecessarily hard (SYNTH_GEOM_r05.json:
    # small-t bonds precise, fragments committed at mid noise)
    rg_target = 1.3 * n ** (1.0 / 3.0) + 0.8
    lr = 0.12
    for it in range(iters):
        diff = x[:, None, :] - x[None, :, :]
        d = np.sqrt((diff ** 2).sum(-1) + 1e-12)
        np.fill_diagonal(d, 1.0)
        unit = diff / d[..., None]
        # spring force toward bond targets
        f = np.where(bonded, d0 - d, 0.0)
        # soft repulsion below the comfort radius
        f = f + np.where((~bonded) & (d < soft), (soft - d) * 0.5, 0.0)
        # strong repulsion below the perception floor
        f = f + np.where((~bonded) & (d < floor + 0.15),
                         (floor + 0.15 - d) * 2.0, 0.0)
        grad = (f[..., None] * unit).sum(1)
        # centripetal compaction toward the gyration-radius target (the
        # nonbond floors above keep compaction from creating clashes)
        rel = x - x.mean(0, keepdims=True)
        rg = float(np.sqrt((rel ** 2).sum(1).mean()) + 1e-9)
        if rg > rg_target:
            grad = grad - 0.25 * (rg - rg_target) * rel / rg
        x = x + lr * grad
        if it % 50 == 49:
            bond_err = np.abs(np.where(bonded, d - d0, 0.0)).max()
            viol = ((~bonded) & (d < floor)).any()
            if bond_err < 0.03 and not viol:
                break
    # final acceptance gates
    diff = x[:, None, :] - x[None, :, :]
    d = np.sqrt((diff ** 2).sum(-1) + 1e-12)
    np.fill_diagonal(d, 10.0)
    if np.abs(np.where(bonded, d - d0, 0.0)).max() > 0.05:
        return None
    if ((~bonded) & (d < floor)).any():
        return None
    return x.astype(np.float32)


def generate_ligand(rng: np.random.Generator, dinfo: dict,
                    n_min: int = 8, n_max: int = 26,
                    max_tries: int = 20,
                    graph_mode: str = "random") -> Optional[dict]:
    """One verified synthetic ligand: graph + coords + round-trip check.

    The returned dict carries ``lig_coords`` (n, 3) float32 centered at the
    molecule CoM, ``lig_one_hot`` (n, A), and the WL ``key`` for uniqueness
    bookkeeping.  Acceptance requires `perceive_bonds_edm` on the final
    coordinates to reproduce the intended bond list exactly.
    """
    enc = dinfo["atom_encoder"]
    decoder = dinfo["atom_decoder"]
    for _ in range(max_tries):
        n = int(rng.integers(n_min, n_max + 1))
        g = (sample_graph_motif(rng, n, dinfo) if graph_mode == "motif"
             else sample_graph(rng, n, dinfo))
        if g is None:
            continue
        if graph_mode == "motif" and not (n_min <= len(g[0]) <= n_max):
            continue
        tidx, bonds = g
        x = embed_molecule(rng, tidx, bonds, dinfo)
        if x is None:
            continue
        perceived = perceive_bonds_edm(x, np.asarray(tidx), dinfo)
        want = {(max(i, j), min(i, j), o) for i, j, o in bonds}
        got = {(max(i, j), min(i, j), o) for i, j, o in perceived}
        if want != got:
            continue
        mol = SimpleMol(symbols=[decoder[t] for t in tidx],
                        coords=x, bonds=list(want))
        if not (mol.is_connected() and mol.check_valency()):
            continue  # unreachable by construction; belt and braces
        one_hot = np.eye(len(enc), dtype=np.float32)[np.asarray(tidx)]
        return {"lig_coords": x - x.mean(0, keepdims=True),
                "lig_one_hot": one_hot, "key": mol.canonical_key(),
                "n_atoms": n}
    return None


def build_ligand_library(rng: np.random.Generator, dinfo: dict,
                         vocab_size: int = 64, n_min: int = 8,
                         n_max: int = 26,
                         graph_mode: str = "motif") -> List[dict]:
    """Fixed vocabulary of ``vocab_size`` distinct verified ligands.

    Corpus v4 ("library" mode): the r05 runs showed held-out connectivity
    tracks the corpus' topological entropy — random graphs (2848 unique
    topologies / 3000 complexes) plateau at ~0.07, a motif vocabulary at
    ~0.17.  Real datasets sit at the other extreme: CrossDocked reuses a
    finite ligand set across pockets, so the generative task is "recall a
    member of a learned chemical vocabulary in a new pocket", not "invent a
    never-seen topology".  This library reproduces that regime with K
    unique molecules (WL-canonically distinct, each EDM-round-trip
    verified) reused across all training pockets under fresh random
    rotations/placements.
    """
    lib: List[dict] = []
    seen = set()
    tries = 0
    while len(lib) < vocab_size:
        tries += 1
        if tries > vocab_size * 200:
            raise RuntimeError("library generation stalled")
        lig = generate_ligand(rng, dinfo, n_min=n_min, n_max=n_max,
                              graph_mode=graph_mode)
        if lig is None or lig["key"] in seen:
            continue
        seen.add(lig["key"])
        lib.append(lig)
    return lib


# -------------------------------------------------------------------- pockets
def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class ProteinSource:
    """Parsed protein with cached heavy-atom coordinates for fast carving."""

    def __init__(self, pdb_path: str):
        self.struct = pdbmod.parse_pdb(pdb_path)
        self.residues = [r for r in self.struct.get_residues()
                         if r.is_standard_aa]
        self.res_coords = [r.coords(heavy_only=True) for r in self.residues]
        self.all_coords = np.concatenate(
            [c for c in self.res_coords if len(c)]).astype(np.float32)
        self.com = self.all_coords.mean(0)


def place_and_carve(rng: np.random.Generator, src: ProteinSource,
                    lig_coords: np.ndarray, amino_acid_dict: Dict[str, int],
                    dist_cutoff: float = 8.0, clash_dist: float = 2.2,
                    min_pocket_atoms: int = 80, max_pocket_atoms: int = 310,
                    max_tries: int = 30) -> Optional[dict]:
    """Drop the ligand at a random surface site, resolve clashes, carve the
    8 A full-atom pocket (utils.py:103-128 / process_crossdock full-atom
    encoding: per-atom element one-hot with an 'others' column)."""
    for _ in range(max_tries):
        xyz = lig_coords @ _random_rotation(rng).T
        anchor = src.all_coords[int(rng.integers(len(src.all_coords)))]
        outward = anchor - src.com
        nrm = np.linalg.norm(outward)
        if nrm < 1e-6:
            continue
        outward = outward / nrm
        pos = anchor + outward * float(rng.uniform(1.0, 3.0))
        cand = xyz + pos
        # push along the outward direction until clash-free
        ok = False
        for _ in range(60):
            dmin = np.linalg.norm(
                cand[:, None, :] - src.all_coords[None, :, :], axis=-1).min()
            if dmin >= clash_dist:
                ok = True
                break
            cand = cand + outward * 0.3
        if not ok:
            continue
        # carve residues with any atom within the cutoff
        coords, one_hot = [], []
        n_atoms = 0
        for res, rc in zip(src.residues, src.res_coords):
            if len(rc) == 0:
                continue
            d2 = ((rc[:, None, :] - cand[None, :, :]) ** 2).sum(-1)
            if float(d2.min()) < dist_cutoff ** 2:
                for atom in res.atoms:
                    el = atom.element.capitalize()
                    if el == "H":
                        continue
                    col = amino_acid_dict.get(el, len(amino_acid_dict) - 1)
                    one_hot.append(np.eye(
                        1, len(amino_acid_dict), col).squeeze())
                    coords.append(atom.coord)
                    n_atoms += 1
        if not (min_pocket_atoms <= n_atoms <= max_pocket_atoms):
            continue
        return {"lig_coords": cand.astype(np.float32),
                "pocket_coords": np.stack(coords).astype(np.float32),
                "pocket_one_hot": np.stack(one_hot).astype(np.float32)}
    return None


# --------------------------------------------------------------------- corpus
def generate_complexes(rng: np.random.Generator, src: ProteinSource,
                       dinfo: dict, n: int, tag: str,
                       n_min: int = 8, n_max: int = 26,
                       graph_mode: str = "random",
                       library: Optional[List[dict]] = None) -> List[dict]:
    out = []
    aa_dict = dinfo["aa_encoder"]
    while len(out) < n:
        if library is not None:
            lig = library[int(rng.integers(len(library)))]
        else:
            lig = generate_ligand(rng, dinfo, n_min=n_min, n_max=n_max,
                                  graph_mode=graph_mode)
        if lig is None:
            continue
        placed = place_and_carve(rng, src, lig["lig_coords"], aa_dict)
        if placed is None:
            continue
        out.append({
            "name": f"{tag}_{len(out):05d}",
            "lig_coords": placed["lig_coords"],
            "lig_one_hot": lig["lig_one_hot"],
            "pocket_coords": placed["pocket_coords"],
            "pocket_one_hot": placed["pocket_one_hot"],
            "key": lig["key"],
        })
    return out


def _save_split(path: Path, complexes: List[dict]) -> None:
    acc = {k: [] for k in ("lig_coords", "lig_one_hot", "lig_mask",
                           "pocket_coords", "pocket_one_hot", "pocket_mask")}
    names = []
    for i, c in enumerate(complexes):
        names.append(c["name"])
        acc["lig_coords"].append(c["lig_coords"])
        acc["lig_one_hot"].append(c["lig_one_hot"])
        acc["lig_mask"].append(i * np.ones(len(c["lig_coords"])))
        acc["pocket_coords"].append(c["pocket_coords"])
        acc["pocket_one_hot"].append(c["pocket_one_hot"])
        acc["pocket_mask"].append(i * np.ones(len(c["pocket_coords"])))
    flat = {k: np.concatenate(v) for k, v in acc.items()}
    saveall(path, names, **flat)


def build_corpus(outdir: Path, train_pdb, heldout_pdb, n_train: int = 3000,
                 n_val: int = 64, n_test: int = 128, seed: int = 0,
                 dataset: str = "crossdock_full",
                 train_protein: Optional[str] = None,
                 heldout_protein: Optional[str] = None,
                 n_min: int = 8, n_max: int = 26,
                 graph_mode: str = "random", vocab_size: int = 64) -> dict:
    """Write {train,val,test}.npz + size_distribution.npy + meta.json.

    Train ligand/pocket pairs are carved from the protein of ``train_pdb``;
    val/test from ``heldout_pdb`` — held-out pockets come from a protein the
    model never saw.  ``train_protein`` and ``heldout_protein`` name them in
    meta.json (the files' stems when None).  ``graph_mode='library'`` draws every ligand from a
    fixed ``vocab_size`` vocabulary of motif-assembled molecules, shared
    across splits: held-out generalization is then over POCKETS (the
    reference's actual task geometry — a finite chemical vocabulary
    recalled in never-seen binding sites), not over never-seen topology.
    """
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    dinfo = dataset_params[dataset]
    rng = np.random.default_rng(seed)

    train_protein = train_protein or Path(train_pdb).stem
    heldout_protein = heldout_protein or Path(heldout_pdb).stem
    src_train = ProteinSource(str(train_pdb))
    src_held = ProteinSource(str(heldout_pdb))

    kw = dict(n_min=n_min, n_max=n_max, graph_mode=graph_mode)
    if graph_mode == "library":
        library = build_ligand_library(rng, dinfo, vocab_size=vocab_size,
                                       n_min=n_min, n_max=n_max)
        kw = dict(n_min=n_min, n_max=n_max, graph_mode="motif",
                  library=library)
    train = generate_complexes(rng, src_train, dinfo, n_train, "synth_train",
                               **kw)
    val = generate_complexes(rng, src_held, dinfo, n_val, "synth_val", **kw)
    test = generate_complexes(rng, src_held, dinfo, n_test, "synth_test",
                              **kw)

    _save_split(outdir / "train.npz", train)
    _save_split(outdir / "val.npz", val)
    _save_split(outdir / "test.npz", test)

    lig_mask = np.concatenate([i * np.ones(len(c["lig_coords"]))
                               for i, c in enumerate(train)])
    pkt_mask = np.concatenate([i * np.ones(len(c["pocket_coords"]))
                               for i, c in enumerate(train)])
    hist = get_n_nodes(lig_mask, pkt_mask, smooth_sigma=1.0)
    np.save(outdir / "size_distribution.npy", hist)

    keys = [c["key"] for c in train]
    meta = {
        "n_train": len(train), "n_val": len(val), "n_test": len(test),
        "seed": seed, "dataset": dataset,
        "train_protein": train_protein, "heldout_protein": heldout_protein,
        "n_min": n_min, "n_max": n_max,
        "graph_mode": graph_mode,
        "vocab_size": vocab_size if graph_mode == "library" else None,
        "unique_train_graphs": len(set(keys)),
        "lig_sizes": {"min": int(min(len(c["lig_coords"]) for c in train)),
                      "max": int(max(len(c["lig_coords"]) for c in train))},
        "pocket_sizes": {
            "min": int(min(len(c["pocket_coords"]) for c in train)),
            "max": int(max(len(c["pocket_coords"]) for c in train))},
        "metric_ceiling": {"Validity": 1.0, "Connectivity": 1.0,
                           "note": "every sample round-trips the EDM "
                                   "perception kernel by construction"},
    }
    (outdir / "meta.json").write_text(json.dumps(meta, indent=1))
    return meta
