"""2D molecular descriptors, QED and an SA estimate without RDKit.

Every descriptor is computed from the heavy-atom graph (``SimpleMol``:
symbols, coordinates, typed bonds) under a standard implicit-hydrogen model.
Rings are the minimum cycle basis of ``chem/graphs.py``, networkx's own
algorithm, so the ring atom sets are the ones networkx would give.

What is exact and what approximate (formulas from the primary literature):

* QED uses the published desirability (ADS) parameters and weights of
  Bickerton et al., "Quantifying the chemical beauty of drugs", Nature
  Chemistry 4, 90-98 (2012), Supplementary Table 1.  The underlying
  descriptors (MW, HBA, HBD, TPSA, rotatable bonds, aromatic rings) follow
  their standard definitions; ALOGP is a coarse atom-contribution estimate
  and structural ALERTS are approximated by a small set of graph patterns,
  so absolute QED values differ from RDKit's but rank molecules sensibly.
* TPSA uses Ertl, Rohde & Selzer (J. Med. Chem. 43, 3714, 2000) atomic
  contributions for the common N/O/S/P environments.
* The SA estimate implements the complexity-penalty and symmetry terms of
  Ertl & Schuffenhauer (J. Cheminf. 1:8, 2009), with the fragment-frequency
  term replaced by a WL-environment commonality estimate (the published term
  needs the PubChem-derived fpscores table).
"""
from __future__ import annotations

import math
from typing import Dict, List, Set, Tuple

from diffsbdd_tpu_torch.chem import graphs
from diffsbdd_tpu_torch.constants import ALLOWED_BONDS

ATOMIC_MASS = {
    "H": 1.008, "B": 10.81, "C": 12.011, "N": 14.007, "O": 15.999,
    "F": 18.998, "Al": 26.98, "Si": 28.085, "P": 30.974, "S": 32.06,
    "Cl": 35.45, "As": 74.92, "Br": 79.904, "I": 126.9, "Hg": 200.59,
    "Bi": 208.98,
}


# --------------------------------------------------------------------------
# graph basics: implicit hydrogens, rings, aromaticity
# --------------------------------------------------------------------------

# Default valence lists (RDKit's charge-neutral model).  Distinct from
# ALLOWED_BONDS, which records the MAXIMUM bond count used for validity
# checks: e.g. ALLOWED_BONDS['S'] = 4, but a divalent sulfide must get the
# typical valence 2 (no phantom S-H hydrogens).
_DEFAULT_VALENCES = {
    "H": (1,), "B": (3,), "C": (4,), "N": (3,), "O": (2,), "F": (1,),
    "Al": (3,), "Si": (4,), "P": (3, 5), "S": (2, 4, 6), "Cl": (1,),
    "As": (3, 5), "Br": (1,), "I": (1,), "Hg": (1, 2), "Bi": (3, 5),
}


def implicit_hydrogens(mol, pyrrole=None) -> List[int]:
    """Implicit H per heavy atom: smallest default valence that accommodates
    the explicit bond-order sum, minus that sum (charge-neutral model).

    ``pyrrole``: optional precomputed ``pyrrole_like_nitrogens`` set —
    aromatic-MARKER input (order-4 bonds) gives a 2-connected pyrrole N an
    order sum of 2x1.5=3, hiding its N-H; the designated lone-pair donor of
    an all-N aromatic 5-ring gets that hydrogen back here."""
    order_sum = [0.0] * mol.n_atoms
    n_arom = [0] * mol.n_atoms
    n_bonds = [0] * mol.n_atoms
    for i, j, o in mol.bonds:
        if o == 4:  # aromatic marker
            n_arom[i] += 1
            n_arom[j] += 1
            o = 1.5
        order_sum[i] += o
        order_sum[j] += o
        n_bonds[i] += 1
        n_bonds[j] += 1
    if pyrrole is None:
        pyrrole = pyrrole_like_nitrogens(mol) if any(
            o == 4 for _, _, o in mol.bonds) else set()
    out = []
    for idx, s in enumerate(mol.symbols):
        if s in ("O", "S") and n_bonds[idx] == 2 and n_arom[idx] == 2:
            # furan/thiophene-type heteroatom: the lone pair is the ring's
            # pi donation, valence 2 is satisfied — no phantom hydrogens
            # (2 x 1.5 would otherwise round up to 3)
            out.append(0)
            continue
        if (s == "N" and n_arom[idx] >= 2 and n_bonds[idx] == 2
                and idx in pyrrole):
            out.append(1)  # marker-form pyrrole/imidazole N-H
            continue
        allowed = _DEFAULT_VALENCES.get(s)
        if allowed is None:
            allowed = ALLOWED_BONDS.get(s, 0)
            if isinstance(allowed, int):
                allowed = [allowed]
        total = int(math.ceil(order_sum[idx]))
        h = 0
        for v in sorted(allowed):
            if total <= v:
                h = v - total
                break
        out.append(h)
    return out


def pyrrole_like_nitrogens(mol, arom_rings=None, nbrs=None) -> Set[int]:
    """Aromatic N atoms that donate their lone pair to the ring pi system
    (pyrrole-type): they are not H-bond acceptors and, when 2-connected,
    carry the ring N-H.

    Per aromatic ring: 6-rings have none (pyridine-type N); in a 5-ring the
    donor is an O/S when present (furan/oxazole — its N is pyridine-type),
    else an N with three heavy neighbors (N-substituted pyrrole), else the
    N without an in-ring double bond (kekulized input), else — with
    aromatic-marker bonds, where orders cannot distinguish the tautomers —
    the lowest-index 2-connected N (deterministic pick)."""
    if nbrs is None:
        nbrs = _neighbors(mol)
    if arom_rings is None:
        arom_rings = aromatic_rings(mol)
    out: Set[int] = set()
    for ring in arom_rings:
        if len(ring) != 5:
            continue
        if any(mol.symbols[a] in ("O", "S") for a in ring):
            continue
        ns = [a for a in ring if mol.symbols[a] == "N"]
        if not ns:
            continue
        n3 = [a for a in ns if len(nbrs[a]) == 3]
        if n3:
            out.add(min(n3))
            continue
        marker = any(o == 4 for a in ring for _, o in nbrs[a])
        if marker:
            out.add(min(ns))
            continue
        no_double = [a for a in ns if not any(o == 2 for _, o in nbrs[a])]
        if no_double:
            out.add(min(no_double))
    return out


def _ctx(mol) -> Dict:
    """Per-molecule cache of the shared graph computations (neighbors, ring
    basis, aromatic rings, pyrrole set, implicit hydrogens).  The minimum
    cycle basis dominates the cost of every descriptor; computing it once
    per molecule instead of once per metric makes a full QED+SA+logP+
    Lipinski evaluation ~4x cheaper.  Cached on the molecule object (bonds
    are never mutated after construction)."""
    cache = getattr(mol, "_descriptor_ctx", None)
    if cache is not None and cache["n_bonds"] == len(mol.bonds):
        return cache
    nbrs = _neighbors(mol)
    ring_list = rings(mol)
    arom_rings = aromatic_rings(mol, ring_list)
    pyrrole = pyrrole_like_nitrogens(mol, arom_rings, nbrs)
    cache = {
        "n_bonds": len(mol.bonds),
        "nbrs": nbrs,
        "rings": ring_list,
        "arom_rings": arom_rings,
        "arom": {a for ring in arom_rings for a in ring},
        "pyrrole": pyrrole,
        "hs": implicit_hydrogens(mol, pyrrole=pyrrole),
    }
    try:
        mol._descriptor_ctx = cache
    except AttributeError:  # exotic mol types without attribute support
        pass
    return cache


def _neighbors(mol) -> List[List[Tuple[int, int]]]:
    nbrs: List[List[Tuple[int, int]]] = [[] for _ in range(mol.n_atoms)]
    for i, j, o in mol.bonds:
        nbrs[i].append((j, o))
        nbrs[j].append((i, o))
    return nbrs


def rings(mol) -> List[List[int]]:
    """Smallest cycle basis of the heavy-atom graph (SSSR-like)."""
    return [list(c) for c in graphs.minimum_cycle_basis(
        graphs.graph(mol.n_atoms, [(i, j) for i, j, _ in mol.bonds]))]


def aromatic_rings(mol, ring_list=None) -> List[List[int]]:
    """5/6-rings of C/N/O/S that satisfy a Hückel-style electron count.

    Each in-ring double bond donates 2 pi electrons; an O/S/N with only
    single ring bonds donates a lone pair; ring carbons must carry a double
    bond (in-ring or exocyclic) to be sp2.
    """
    ring_list = rings(mol) if ring_list is None else ring_list
    bond_order = {}
    for i, j, o in mol.bonds:
        bond_order[frozenset((i, j))] = o
    nbrs = _neighbors(mol)

    out = []
    for ring in ring_list:
        if len(ring) not in (5, 6):
            continue
        if any(mol.symbols[a] not in ("C", "N", "O", "S") for a in ring):
            continue
        rset = set(ring)
        # rings whose internal bonds all carry the explicit aromatic marker
        # (order 4, e.g. V2000 input or OpenBabel perception) are aromatic by
        # declaration — the Hückel count below would see pi=len(ring) and
        # wrongly reject 5-rings like thiophene/pyrrole
        ring_edges = {frozenset((a, b)) for a in ring
                      for b, _ in nbrs[a] if b in rset}
        if ring_edges and all(bond_order[e] == 4 for e in ring_edges):
            out.append(ring)
            continue
        pi = 0
        ok = True
        for a in ring:
            ring_orders = [bond_order[frozenset((a, b))]
                           for b, _ in nbrs[a] if b in rset]
            if any(o == 4 for o in ring_orders):  # explicit aromatic marker
                pi += 1
                continue
            has_ring_double = any(o == 2 for o in ring_orders)
            has_exo_double = any(o == 2 and b not in rset
                                 for b, o in nbrs[a])
            if has_ring_double:
                pi += 1  # each double bond counted once per endpoint -> 2/bond
            elif mol.symbols[a] in ("N", "O", "S"):
                pi += 2  # lone-pair donor (pyrrole-type)
            elif has_exo_double:
                pi += 0  # sp2 carbon, pi electrons point out of the ring
            else:
                ok = False  # sp3 carbon breaks conjugation
                break
        if ok and pi in (6, 10):
            out.append(ring)
    return out


def rotatable_bonds(mol, ring_list=None) -> int:
    """Single bonds between non-terminal heavy atoms, outside rings."""
    ring_list = _ctx(mol)["rings"] if ring_list is None else ring_list
    ring_edges: Set[frozenset] = set()
    for ring in ring_list:
        rset = set(ring)
        for i, j, o in mol.bonds:
            if i in rset and j in rset:
                ring_edges.add(frozenset((i, j)))
    deg = [0] * mol.n_atoms
    for i, j, _ in mol.bonds:
        deg[i] += 1
        deg[j] += 1
    count = 0
    for i, j, o in mol.bonds:
        if o != 1 or frozenset((i, j)) in ring_edges:
            continue
        if deg[i] > 1 and deg[j] > 1:
            count += 1
    return count


# --------------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------------

def molecular_weight(mol) -> float:
    """MW including implicit hydrogens."""
    h = sum(_ctx(mol)["hs"])
    return sum(ATOMIC_MASS.get(s, 0.0) for s in mol.symbols) \
        + h * ATOMIC_MASS["H"]


def h_bond_acceptors(mol, arom=None) -> int:
    """N and O atoms, excluding amide/pyrrole-type N (Lipinski-style).

    Pyrrole-type N comes from ``pyrrole_like_nitrogens``, which resolves
    BOTH bond representations — kekulized orders and aromatic-marker (order
    4) bonds; testing for "no double bond" alone misread every marker-form
    pyridine N as pyrrole-type and dropped it from the acceptor count."""
    ctx = _ctx(mol)
    nbrs = ctx["nbrs"]
    pyrrole = ctx["pyrrole"]
    count = 0
    for idx, s in enumerate(mol.symbols):
        if s == "O":
            count += 1
        elif s == "N":
            # exclude amide N (bonded to a C that carries =O)
            amide = False
            for b, o in nbrs[idx]:
                if mol.symbols[b] == "C":
                    for c, oc in nbrs[b]:
                        if mol.symbols[c] == "O" and oc == 2:
                            amide = True
            if not amide and idx not in pyrrole:
                count += 1
    return count


def h_bond_donors(mol) -> int:
    """N-H / O-H counts under the implicit-H model."""
    hs = _ctx(mol)["hs"]
    return sum(1 for idx, s in enumerate(mol.symbols)
               if s in ("N", "O") and hs[idx] > 0)


def tpsa(mol, arom=None) -> float:
    """Ertl topological polar surface area from N/O/S/P contributions."""
    ctx = _ctx(mol)
    hs = ctx["hs"]
    nbrs = ctx["nbrs"]
    if arom is None:
        arom = ctx["arom"]
    total = 0.0
    for idx, s in enumerate(mol.symbols):
        orders = sorted(o for _, o in nbrs[idx])
        n_nbrs = len(orders)
        h = hs[idx]
        if s == "N":
            if idx in arom:
                total += 15.79 if h > 0 else 12.89
            elif 3 in orders:
                total += 23.79  # nitrile
            elif 2 in orders:
                total += 23.85 if h > 0 else 12.36  # imine
            elif h == 0:
                total += 3.24
            elif h == 1:
                total += 12.03
            else:
                total += 26.02
        elif s == "O":
            if idx in arom:
                total += 13.14
            elif 2 in orders:
                total += 17.07
            elif h > 0:
                total += 20.23
            else:
                total += 9.23
        elif s == "S":
            if n_nbrs <= 2 and h == 0 and 2 not in orders:
                total += 28.24 if idx in arom else 25.30  # Ertl aromatic S
            elif h > 0:
                total += 38.80
            elif 2 in orders:
                total += 32.09
        elif s == "P":
            if 2 in orders:
                total += 34.14
            else:
                total += 13.59
    return total


# coarse per-element logP contributions (Wildman-Crippen-scale averages);
# a ranking aid, not the 68-type Crippen scheme
_LOGP_CONTRIB = {
    "C": 0.14, "N": -0.50, "O": -0.35, "S": 0.25, "F": 0.22, "Cl": 0.65,
    "Br": 0.89, "I": 1.10, "P": -0.40, "B": 0.05, "others": 0.0,
}


def logp_estimate(mol, arom=None) -> float:
    ctx = _ctx(mol)
    if arom is None:
        arom = ctx["arom"]
    hs = ctx["hs"]
    total = 0.0
    for idx, s in enumerate(mol.symbols):
        c = _LOGP_CONTRIB.get(s, 0.0)
        if s == "C" and idx in arom:
            c = 0.29  # aromatic carbon is more lipophilic
        total += c
        if s in ("N", "O") and hs[idx] > 0:
            total -= 0.30 * hs[idx]  # polar X-H
    total += 0.08 * sum(hs)  # aliphatic hydrogens
    return total


def structural_alerts(mol, ring_list=None) -> int:
    """Tiny subset of the Brenk alert patterns recognizable on the graph:
    long aliphatic chains, acyclic N-N / N=N / S-S, aldehydes, >2 halogens
    on one atom's neighborhood."""
    ctx = _ctx(mol)
    nbrs = ctx["nbrs"]
    ring_atoms = {a for ring in (ring_list if ring_list is not None
                                 else ctx["rings"]) for a in ring}
    alerts = 0
    # heteroatom-heteroatom single bonds outside rings (N-N, S-S, N-O...)
    for i, j, o in mol.bonds:
        si, sj = mol.symbols[i], mol.symbols[j]
        if si in ("N", "O", "S") and sj in ("N", "O", "S") \
                and not (i in ring_atoms and j in ring_atoms):
            alerts += 1
    # aldehyde: terminal C(=O) with an implicit H
    hs = ctx["hs"]
    for idx, s in enumerate(mol.symbols):
        if s == "C" and hs[idx] >= 1 and any(
                mol.symbols[b] == "O" and o == 2 for b, o in nbrs[idx]):
            if sum(1 for b, _ in nbrs[idx] if mol.symbols[b] != "O") <= 1:
                alerts += 1
    # unbranched aliphatic chain of >= 7 carbons
    longest = 0
    g = graphs.graph(mol.n_atoms, [
        (i, j) for i, j, o in mol.bonds
        if o == 1 and mol.symbols[i] == "C" and mol.symbols[j] == "C"
        and i not in ring_atoms and j not in ring_atoms])
    for comp in graphs.connected_components(g):
        if len(comp) >= 2:
            longest = max(longest, graphs.longest_shortest_path(g, comp) + 1)
    if longest >= 7:
        alerts += 1
    return alerts


# --------------------------------------------------------------------------
# QED (Bickerton et al. 2012)
# --------------------------------------------------------------------------

# ADS parameters (a, b, c, d, e, f, dmax) per descriptor,
# Supplementary Table 1 of the QED paper (identical constants ship in
# RDKit's QED.py).
_ADS = {
    "MW": (2.817065973, 392.5754953, 290.7489764, 2.419764353,
           49.22325677, 65.37051707, 104.9805561),
    "ALOGP": (3.172690585, 137.8624751, 2.534937431, 4.581497897,
              0.822739154, 0.576295591, 131.3186604),
    "HBA": (2.948620388, 160.4605972, 3.615294657, 4.435986202,
            0.290141953, 1.300669958, 148.7763046),
    "HBD": (1.618662227, 1010.051101, 0.985094388, 0.000000001,
            0.713820843, 0.920922555, 258.1632616),
    "PSA": (1.876861559, 125.2232657, 62.90773554, 87.83366614,
            12.01999824, 28.51324732, 104.5686167),
    "ROTB": (0.010000000, 272.4121427, 2.558379970, 1.565547684,
             1.271567166, 2.758063707, 105.4420403),
    "AROM": (3.217788970, 957.7374108, 2.274627939, 0.000000001,
             1.317690384, 0.375760881, 312.3372610),
    "ALERTS": (0.990316944, 1148.470110, 2.516979161, 0.000000001,
               0.812727738, 0.875193782, 417.7253140),
}
_QED_WEIGHTS = {  # mean weights (QED_w,mo)
    "MW": 0.66, "ALOGP": 0.46, "HBA": 0.05, "HBD": 0.61,
    "PSA": 0.06, "ROTB": 0.65, "AROM": 0.48, "ALERTS": 0.95,
}


def _ads(x: float, p) -> float:
    a, b, c, d, e, f, dmax = p
    v = a + b / (1 + math.exp(-(x - c + d / 2) / e)) \
        * (1 - 1 / (1 + math.exp(-(x - c - d / 2) / f)))
    return max(v / dmax, 1e-9)


def qed_properties(mol) -> Dict[str, float]:
    # the minimum cycle basis is by far the most expensive pure-python step:
    # _ctx computes it once per molecule and every descriptor (and later
    # metric call) reuses it
    ctx = _ctx(mol)
    ring_list = ctx["rings"]
    arom_rings = ctx["arom_rings"]
    arom = ctx["arom"]
    return {
        "MW": molecular_weight(mol),
        "ALOGP": logp_estimate(mol, arom),
        "HBA": float(h_bond_acceptors(mol, arom)),
        "HBD": float(h_bond_donors(mol)),
        "PSA": tpsa(mol, arom),
        "ROTB": float(rotatable_bonds(mol, ring_list)),
        "AROM": float(len(arom_rings)),
        "ALERTS": float(structural_alerts(mol, ring_list)),
    }


def qed_score(mol) -> float:
    """Weighted-desirability QED in (0, 1); higher is more drug-like."""
    props = qed_properties(mol)
    num = sum(w * math.log(_ads(props[k], _ADS[k]))
              for k, w in _QED_WEIGHTS.items())
    return math.exp(num / sum(_QED_WEIGHTS.values()))


# --------------------------------------------------------------------------
# SA fallback (Ertl & Schuffenhauer 2009, fragment term approximated)
# --------------------------------------------------------------------------

def _wl_environments(mol, radius: int = 2) -> List[str]:
    """Per-atom Morgan-style environment labels after `radius` refinements."""
    nbrs = _neighbors(mol)
    labels = list(mol.symbols)
    for _ in range(radius):
        labels = [
            labels[i] + "(" + ",".join(sorted(
                f"{o}{labels[j]}" for j, o in nbrs[i])) + ")"
            for i in range(mol.n_atoms)
        ]
    return labels


def sa_score(mol) -> float:
    """Synthetic accessibility in [1, 10] (1 = easy), Ertl-Schuffenhauer
    scheme with the complexity/symmetry terms exact and the PubChem
    fragment-frequency term approximated by environment commonality."""
    n = mol.n_atoms
    if n == 0:
        return 10.0
    ctx = _ctx(mol)
    ring_list = ctx["rings"]

    # --- fragment-commonality term (approximates score1 = mean fragment
    # log-frequency).  Plain C/N/O environments of low degree are "common"
    # (positive contribution); exotic elements and crowded environments are
    # "rare" (negative), spanning roughly the published term's [-4, 1] range.
    nbrs = ctx["nbrs"]
    contribs = []
    for idx, s in enumerate(mol.symbols):
        deg = len(nbrs[idx])
        if s in ("C", "N", "O"):
            c = 0.5 - 0.45 * max(0, deg - 2)
        elif s in ("S", "F", "Cl", "Br"):
            c = 0.0 - 0.3 * max(0, deg - 1)
        else:
            c = -2.0
        contribs.append(c)
    score1 = sum(contribs) / n

    # --- complexity penalties (exact scheme)
    ring_sets = [set(r) for r in ring_list]
    n_macro = sum(1 for r in ring_list if len(r) > 8)
    n_spiro = 0
    n_bridge = 0
    for i in range(len(ring_sets)):
        for j in range(i + 1, len(ring_sets)):
            shared = ring_sets[i] & ring_sets[j]
            if len(shared) == 1:
                n_spiro += 1
            elif len(shared) > 2:
                n_bridge += 1
    size_penalty = n ** 1.005 - n
    stereo_penalty = 0.0  # no stereochemistry on generated heavy-atom graphs
    spiro_penalty = math.log10(n_spiro + 1)
    bridge_penalty = math.log10(n_bridge + 1)
    macro_penalty = math.log10(2) if n_macro > 0 else 0.0
    score2 = -(size_penalty + stereo_penalty + spiro_penalty
               + bridge_penalty + macro_penalty)

    # --- symmetry correction (exact scheme on WL environments)
    n_unique = len(set(_wl_environments(mol)))
    score3 = 0.0
    if n > n_unique:
        score3 = math.log(float(n) / n_unique) * 0.5

    raw = score1 + score2 + score3
    # published transform to [1, 10]
    smin, smax = -4.0, 2.5
    sa = 11.0 - (raw - smin + 1.0) / (smax - smin) * 9.0
    if sa > 8.0:
        sa = 8.0 + math.log(sa + 1.0 - 9.0)
    return float(min(max(sa, 1.0), 10.0))
