"""The port's chemistry metrics against the JAX package's and networkx.

The corpus: the 64 committed molecules of ``benchmarks/TEST_SET_r05``,
hand-made ring systems (fused, spiro, bridged, cage, aromatic-marker and
kekulized, apart) and 200 seeded random connected molecules.  The JAX side
runs its no-RDKit branches (rdkit is not installed here).  Integers, strings
and bond lists must be equal; floats within 1e-12.
"""
from pathlib import Path

import networkx as nx
import numpy as np
import pytest

import diffsbdd_tpu.chem.descriptors as jax_desc
import diffsbdd_tpu.chem.metrics as jax_metrics
import diffsbdd_tpu.chem.molecule as jax_mol
import diffsbdd_tpu_torch.chem.descriptors as port_desc
import diffsbdd_tpu_torch.chem.metrics as port_metrics
import diffsbdd_tpu_torch.chem.molecule as port_mol
from diffsbdd_tpu.chem.sascore import calculate_score as jax_sa
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.constants import dataset_params as jax_dataset_params
from diffsbdd_tpu.train.module import build_module_from_config as jax_build
from diffsbdd_tpu_torch.chem import graphs
from diffsbdd_tpu_torch.chem.sascore import calculate_score as port_sa
from diffsbdd_tpu_torch.chem.sdfio import read_sdf
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.constants import dataset_params
from diffsbdd_tpu_torch.train.module import build_module_from_config
from test_torch_sampling import HIST, fixture_config
from test_torch_train import tiny_overrides

REPO = Path(__file__).resolve().parent.parent
TEST_SET = REPO / "benchmarks" / "TEST_SET_r05"
FULL = dataset_params["crossdock_full"]
TOL = 1e-12

if jax_mol.HAVE_RDKIT or jax_metrics.HAVE_RDKIT:
    pytest.skip("RDKit is installed: the JAX metrics would not take their "
                "no-RDKit branches", allow_module_level=True)


def _ring(start, n, order=1):
    return [(start + k, start + (k + 1) % n, order) for k in range(n)]


# name -> (symbols, bonds (i, j, order))
HAND_MADE = {
    "benzene_marker": (["C"] * 6, _ring(0, 6, 4)),
    "naphthalene": (["C"] * 10, [(0, 1, 2), (1, 2, 1), (2, 3, 2), (3, 4, 1), (4, 9, 2),
                                 (9, 0, 1), (4, 5, 1), (5, 6, 2), (6, 7, 1), (7, 8, 2),
                                 (8, 9, 1)]),
    "indole": (["C"] * 8 + ["N"], [(0, 1, 2), (1, 2, 1), (2, 3, 2), (3, 4, 1), (4, 5, 2),
                                   (5, 0, 1), (4, 6, 1), (6, 7, 2), (7, 8, 1), (8, 5, 1)]),
    "pyrrole_marker": (["N"] + ["C"] * 4, _ring(0, 5, 4)),
    "imidazole_marker": (["N", "C", "N", "C", "C"], _ring(0, 5, 4)),
    "furan_thiophene": (["O"] + ["C"] * 4 + ["S"] + ["C"] * 4,
                        _ring(0, 5, 4) + _ring(5, 5, 4)),
    "pyridine_amide": (["N"] + ["C"] * 5 + ["C", "O", "N"],
                       _ring(0, 6, 4) + [(3, 6, 1), (6, 7, 2), (6, 8, 1)]),
    "spiro[4.5]decane": (["C"] * 10, _ring(0, 5) + [(0, 5, 1), (5, 6, 1), (6, 7, 1),
                                                     (7, 8, 1), (8, 9, 1), (9, 0, 1)]),
    "norbornane": (["C"] * 7, [(0, 1, 1), (1, 2, 1), (2, 3, 1), (3, 4, 1), (4, 5, 1),
                               (5, 0, 1), (0, 6, 1), (6, 3, 1)]),
    "bicyclo[2.2.2]octane": (["C"] * 8, [(0, 2, 1), (2, 3, 1), (3, 1, 1), (0, 4, 1),
                                         (4, 5, 1), (5, 1, 1), (0, 6, 1), (6, 7, 1),
                                         (7, 1, 1)]),
    "adamantane": (["C"] * 10, [(0, 4, 1), (4, 1, 1), (0, 5, 1), (5, 2, 1), (0, 6, 1),
                                (6, 3, 1), (1, 7, 1), (7, 2, 1), (1, 8, 1), (8, 3, 1),
                                (2, 9, 1), (9, 3, 1)]),
    "cubane": (["C"] * 8, _ring(0, 4) + _ring(4, 4) + [(k, k + 4, 1) for k in range(4)]),
    "two_systems_apart": (["C"] * 11, _ring(0, 5) + [(5, 6, 2), (6, 7, 1), (7, 8, 2),
                                                     (8, 9, 1), (9, 10, 2), (10, 5, 1)]),
    "heptanal": (["C"] * 7 + ["O"], [(k, k + 1, 1) for k in range(6)] + [(6, 7, 2)]),
    "hydrazine_disulfide": (["N", "N", "C", "S", "S", "C", "Cl", "P", "O", "F"],
                            [(0, 1, 1), (1, 2, 1), (2, 3, 1), (3, 4, 1), (4, 5, 1),
                             (5, 6, 1), (2, 7, 1), (7, 8, 2), (7, 9, 1)]),
}

RANDOM_SYMBOLS = ["C"] * 8 + ["N", "N", "O", "O", "S", "F", "Cl", "P", "Br", "I", "B"]


def random_molecule(rng):
    """A connected graph of 8-30 atoms (a random tree plus 0-6 extra edges)
    with random elements and bond orders."""
    n = int(rng.integers(8, 31))
    pairs = [(k, int(rng.integers(0, k))) for k in range(1, n)]
    for _ in range(int(rng.integers(0, 7))):
        i, j = (int(v) for v in rng.choice(n, 2, replace=False))
        if (i, j) not in pairs and (j, i) not in pairs:
            pairs.append((i, j))
    symbols = [RANDOM_SYMBOLS[int(k)] for k in rng.integers(0, len(RANDOM_SYMBOLS), n)]
    orders = rng.choice([1, 1, 1, 2, 4], len(pairs))
    return symbols, [(i, j, int(o)) for (i, j), o in zip(pairs, orders)]


def committed_molecules():
    files = sorted(TEST_SET.glob("*/*.sdf"))
    return [(m.symbols, m.coords, m.bonds, m.name)
            for f in files for m in read_sdf(f)]


def corpus():
    """[(label, symbols, coords, bonds)] of the whole corpus."""
    out = [(f"{name}[{k}]", s, c, b)
           for k, (s, c, b, name) in enumerate(committed_molecules())]
    rng = np.random.default_rng(0)
    for name, (s, b) in HAND_MADE.items():
        out.append((name, s, rng.standard_normal((len(s), 3)), b))
    for k in range(200):
        s, b = random_molecule(rng)
        out.append((f"random[{k}]", s, rng.standard_normal((len(s), 3)), b))
    return out


CORPUS = corpus()


def both(symbols, coords, bonds):
    """The same molecule as a JAX and as a port SimpleMol (each with its own
    descriptor cache)."""
    coords = np.asarray(coords, np.float32)
    return (jax_mol.SimpleMol(list(symbols), coords.copy(), list(bonds)),
            port_mol.SimpleMol(list(symbols), coords.copy(), list(bonds)))


def assert_same(got, want, what):
    if isinstance(want, float):
        assert abs(got - want) <= TOL, (what, got, want)
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            assert_same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (what, got, want)
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{k}]")
    else:
        assert got == want, (what, got, want)


def nx_graph(n, edges):
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    return g


def graph_cases():
    """(label, n_nodes, edges): the corpus's bond graphs and 200 random
    connected graphs of 8-30 nodes with 0-6 extra edges."""
    cases = [(label, len(s), [(i, j) for i, j, _ in b]) for label, s, _, b in CORPUS]
    rng = np.random.default_rng(1)
    for k in range(200):
        s, b = random_molecule(rng)
        cases.append((f"graph[{k}]", len(s), [(i, j) for i, j, _ in b]))
    return cases


def test_cycle_bases_match_networkx():
    several_rings = 0
    for label, n, edges in graph_cases():
        g, adj = nx_graph(n, edges), graphs.graph(n, edges)
        want = nx.minimum_cycle_basis(g)
        got = graphs.minimum_cycle_basis(adj)
        # the multiset of cycle lengths is the same for every minimum basis:
        # a mismatch only in atom sets is a tie-break difference
        assert sorted(map(len, got)) == sorted(map(len, want)), label
        assert {frozenset(c) for c in got} == {frozenset(c) for c in want}, \
            f"{label}: minimum cycle basis differs in a tie-break"
        assert got == want, f"{label}: the same cycles in another order"
        assert graphs.cycle_basis(adj) == nx.cycle_basis(g), label
        several_rings += len(want) > 1
    assert several_rings > 100


def test_components_and_longest_chain_match_networkx():
    rng = np.random.default_rng(2)
    for k in range(100):
        # a forest: random trees over a random split of the nodes
        n = int(rng.integers(2, 30))
        edges = [(v, int(rng.integers(0, v))) for v in range(1, n) if rng.random() < 0.8]
        g, adj = nx_graph(n, edges), graphs.graph(n, edges)
        want = list(nx.connected_components(g))
        got = list(graphs.connected_components(adj))
        assert got == want, k
        for comp in got:
            lengths = dict(nx.all_pairs_shortest_path_length(g.subgraph(comp)))
            assert graphs.longest_shortest_path(adj, comp) == max(
                max(d.values()) for d in lengths.values()), k


DESCRIPTORS = ["implicit_hydrogens", "pyrrole_like_nitrogens", "rings",
               "aromatic_rings", "rotatable_bonds", "molecular_weight",
               "h_bond_acceptors", "h_bond_donors", "tpsa", "logp_estimate",
               "structural_alerts", "qed_properties", "qed_score", "sa_score"]


def test_descriptors_match_jax():
    assert sorted(DESCRIPTORS) == sorted(
        n for n in dir(port_desc) if not n.startswith("_") and n[0].islower()
        and callable(getattr(port_desc, n))
        and getattr(port_desc, n).__module__ == port_desc.__name__)
    for label, s, c, b in CORPUS:
        jm, pm = both(s, c, b)
        for name in DESCRIPTORS:
            want = getattr(jax_desc, name)(jm)
            got = getattr(port_desc, name)(pm)
            if name == "rings":
                got, want = sorted(map(sorted, got)), sorted(map(sorted, want))
            assert_same(got, want, f"{label}: {name}")
        assert_same(port_sa(pm), jax_sa(jm), f"{label}: calculate_score")


def test_descriptor_cache_starts_fresh_on_copies():
    """``_ctx`` is keyed on the bond count and cached on the molecule: the
    copies that ``process_molecule`` and ``subset`` make start without it."""
    s, b = HAND_MADE["two_systems_apart"]
    _, pm = both(s, np.zeros((len(s), 3)), b)
    port_desc.qed_score(pm)
    assert hasattr(pm, "_descriptor_ctx")
    assert not hasattr(port_mol.process_molecule(pm), "_descriptor_ctx")
    assert not hasattr(pm.largest_fragment(), "_descriptor_ctx")
    with pytest.raises(TypeError, match="SimpleMol"):
        port_sa("CCO")


def test_keys_fingerprints_and_filters_match_jax():
    for label, s, c, b in CORPUS:
        jm, pm = both(s, c, b)
        assert pm.canonical_key() == jm.canonical_key(), label
        assert pm.to_smiles() == jm.to_smiles(), label
        assert port_metrics.wl_fingerprint(pm) == jax_metrics.wl_fingerprint(jm), label
        assert port_mol.filter_rd_mol(pm) == jax_mol.filter_rd_mol(jm), label
        assert pm.is_connected() == jm.is_connected(), label
        assert pm.adjacency() == jm.adjacency(), label
    # the filter rejects two 3-rings sharing an atom
    fused = port_mol.SimpleMol(["C"] * 5, np.zeros((5, 3)),
                               [(0, 1, 1), (1, 2, 1), (2, 0, 1), (2, 3, 1), (3, 4, 1),
                                (4, 2, 1)])
    assert not port_mol.filter_rd_mol(fused)


@pytest.mark.parametrize("noise", [0.0, 0.08])
def test_bond_perception_matches_jax(noise):
    """EDM and covalent bond lists of the committed molecules' coordinates
    and types (and the same with seeded noise on the coordinates), and the
    molecules ``build_molecule`` makes of them."""
    rng = np.random.default_rng(3)
    enc = FULL["atom_encoder"]
    for k, (s, c, _, _) in enumerate(committed_molecules()):
        # the SDF cuts the type "others" to its first three letters
        types = np.array([enc["others" if x == "oth" else x] for x in s])
        pos = (c + noise * rng.standard_normal(c.shape)).astype(np.float32)
        want = jax_mol.perceive_bonds_covalent(pos, types, jax_dataset_params["crossdock_full"])
        got = port_mol.perceive_bonds_covalent(pos, types, FULL)
        assert got == want, k
        for perception in ("edm", "covalent"):
            jm = jax_mol.build_molecule(pos, types, jax_dataset_params["crossdock_full"],
                                        perception=perception)
            pm = port_mol.build_molecule(pos, types, FULL, perception=perception)
            assert (pm.symbols, pm.bonds) == (jm.symbols, jm.bonds), (k, perception)
    with pytest.raises(ValueError, match="OpenBabel"):
        port_mol.build_molecule(pos, types, FULL, perception="openbabel")


def _metric_molecules():
    """Committed molecules, hand-made ones and a few fragmented and invalid
    ones, as JAX and port lists."""
    rows = [(s, c, b) for _, s, c, b in CORPUS[:80]]
    rng = np.random.default_rng(4)
    rows.append((["C"] * 4, rng.standard_normal((4, 3)), [(0, 1, 1), (2, 3, 1)]))
    rows.append((["O", "C"], rng.standard_normal((2, 3)), [(0, 1, 3)]))
    rows += rows[:5]  # duplicates for uniqueness
    pairs = [both(*r) for r in rows]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_molecular_metrics_match_jax():
    jmols, pmols = _metric_molecules()
    train_keys = [m.to_smiles() for m in pmols[10:30]]
    for dataset_smiles in (None, train_keys):
        want = jax_metrics.BasicMolecularMetrics(
            jax_dataset_params["crossdock_full"], dataset_smiles).evaluate_mols(jmols)
        got = port_metrics.BasicMolecularMetrics(FULL, dataset_smiles).evaluate_mols(pmols)
        assert_same(got[0], want[0], "validity, connectivity, uniqueness, novelty")
        for g, w in zip(got[1], want[1]):
            assert [(m.symbols, m.bonds) for m in g] == [(m.symbols, m.bonds) for m in w]

    rng = np.random.default_rng(5)
    graphs_in = [(rng.standard_normal((n, 3)) * 1.4, rng.integers(0, 10, n))
                 for n in rng.integers(4, 20, 12)]
    want = jax_metrics.BasicMolecularMetrics(
        jax_dataset_params["crossdock_full"]).evaluate(graphs_in)
    got = port_metrics.BasicMolecularMetrics(FULL).evaluate(graphs_in)
    assert_same(got[0], want[0], "evaluate")

    jprops, pprops = jax_metrics.MoleculeProperties(), port_metrics.MoleculeProperties()
    pockets = [slice(0, 30), slice(30, 64), slice(64, None), slice(0, 1)]
    assert_same(pprops.evaluate([pmols[s] for s in pockets]),
                jprops.evaluate([jmols[s] for s in pockets]), "evaluate")
    assert_same(pprops.evaluate_mean(pmols), jprops.evaluate_mean(jmols), "evaluate_mean")
    assert_same(pprops.evaluate_mean([]), jprops.evaluate_mean([]), "evaluate_mean([])")


@pytest.mark.parametrize("dataset", ["crossdock", "crossdock_full"])
def test_kl_divergence_matches_jax(dataset):
    rng = np.random.default_rng(6)
    jinfo, pinfo = jax_dataset_params[dataset], dataset_params[dataset]
    assert pinfo["atom_hist"] == jinfo["atom_hist"]
    assert pinfo["aa_hist"] == jinfo["aa_hist"]
    for hist, enc in (("atom_hist", "atom_encoder"), ("aa_hist", "aa_encoder")):
        want_dist = jax_metrics.CategoricalDistribution(jinfo[hist], jinfo[enc])
        got_dist = port_metrics.CategoricalDistribution(pinfo[hist], pinfo[enc])
        for n in (0, 1, 50, 400):
            sample = rng.integers(0, len(pinfo[enc]), n)
            assert_same(got_dist.kl_divergence(sample),
                        want_dist.kl_divergence(sample), f"{dataset} {hist} n={n}")


ANALYZE_CONFIGS = {
    "fixture_full_atom": lambda: fixture_config(),
    "ca_pockets": lambda: tiny_overrides(dataset="crossdock", pocket_representation="CA"),
    "virtual_nodes": lambda: tiny_overrides(virtual_nodes=True),
}


@pytest.mark.parametrize("config", sorted(ANALYZE_CONFIGS))
def test_analyze_samples_matches_jax(config):
    over = ANALYZE_CONFIGS[config]()
    hist = np.ones((13, 65)) if over.get("virtual_nodes") else HIST
    jm = jax_build(jax_load_config(overrides=over), hist)
    pm = build_module_from_config(load_config(overrides=over), hist)
    jmols, pmols = _metric_molecules()
    rng = np.random.default_rng(7)
    atom_types = rng.integers(0, 10, 300)
    aa_types = rng.integers(0, pm.residue_nf, 500)
    smiles = [m.to_smiles() for m in pmols[:20]]
    want = jm.analyze_samples(jmols, atom_types, aa_types, receptors=None,
                              dataset_smiles=smiles)
    got = pm.analyze_samples(pmols, atom_types, aa_types, dataset_smiles=smiles)
    assert_same(got, want, config)
    # receptor files that do not exist: no docking score, as in JAX
    # (tests/test_torch_docking.py scores them with a stand-in smina)
    receptors = ["r.pdb"] * len(pmols)
    assert_same(pm.analyze_samples(pmols, atom_types, aa_types, receptors=receptors,
                                   dataset_smiles=smiles),
                jm.analyze_samples(jmols, atom_types, aa_types, receptors=receptors,
                                   dataset_smiles=smiles), config)
