"""The port's sampling workflows against the JAX package's: the ligand sizes
of ``generate_ligands``, ``cli.test_set``, ``diversify_ligands`` and
``cli.optimize``.

Both sides sample the fixture weights (hidden 64, 3 layers) at T = 2 with a
flat size prior (the JAX side's eager passes dominate the tests' time).  The JAX side runs eagerly and draws each Gaussian of the
shape it asks for from a seeded numpy stream; the port replays the same
arrays in the same order.  Files, rows and molecules must be the same, atoms
equal and coordinates within 1e-3 A (as ``test_torch_cli.py``).
"""
import csv
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import diffsbdd_tpu.chem.metrics as jax_metrics
import diffsbdd_tpu.chem.molecule as jax_mol
import diffsbdd_tpu.cli.optimize as jax_opt
import diffsbdd_tpu.cli.test_set as jax_test_set
import diffsbdd_tpu.train.module as jax_module_mod
import diffsbdd_tpu_torch.cli.optimize as port_opt
import diffsbdd_tpu_torch.cli.test_set as port_test_set
import diffsbdd_tpu_torch.diffusion.ddpm as port_ddpm
import diffsbdd_tpu_torch.train.module as port_module_mod
from diffsbdd_tpu.chem import pdb as jax_pdb
from diffsbdd_tpu.chem.sdfio import read_sdf as jax_read_sdf
from diffsbdd_tpu_torch.checkpoint import import_jax_npz
from diffsbdd_tpu_torch.chem import pdb as port_pdb
from diffsbdd_tpu_torch.chem.molecule import build_molecule
from diffsbdd_tpu_torch.chem.sdfio import read_sdf, write_sdf_file
from diffsbdd_tpu_torch.constants import dataset_params
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_npz
from test_torch_sampling import FIXTURE_NPZ, HIST, fixture_config, jax_module

T = 2
COORD_TOL = 1e-3

if jax_mol.HAVE_RDKIT or jax_metrics.HAVE_RDKIT:
    pytest.skip("RDKit is installed: the JAX side would not take its no-RDKit "
                "branches", allow_module_level=True)


class RecordedNoise:
    """Seeded Gaussian arrays of whatever shape the JAX sampler asks for,
    kept so that the port replays them in order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.arrays = []

    def jax_draw(self, key, shape, mask):
        arr = self.rng.standard_normal(tuple(shape)).astype(np.float32)
        self.arrays.append(arr)
        return jnp.asarray(arr) * mask[..., None]

    def port_draw(self, generator, shape, mask):
        arr = self.arrays.pop(0)
        assert arr.shape == tuple(shape), (arr.shape, shape)
        return torch.as_tensor(arr) * mask[..., None]


def jax_side(noise):
    """The JAX module with its noise drawn by ``noise``, and a ``load_model``
    that returns it."""
    module, params = jax_module(T)
    module.ddpm.sample_gaussian = noise.jax_draw
    load = lambda *a, **k: (module, types.SimpleNamespace(params=params), None)  # noqa: E731
    return module, params, load


def port_side():
    """The port's module with the fixture weights at T steps."""
    module = port_module_mod.build_module_from_config(
        load_config(overrides=fixture_config(T)), HIST)
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            state_dict_from_npz(FIXTURE_NPZ).items()}, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    return import_jax_npz(FIXTURE_NPZ, tmp_path_factory.mktemp("ckpt"),
                          {"diffusion_params": {"diffusion_steps": T}},
                          node_histogram=HIST)


def ligand_sdf(pdb, out):
    """The PDB's ligand residue (HETATM) as a one-molecule SDF with covalent
    bonds."""
    info = dataset_params["crossdock_full"]
    rows = [ln for ln in pdb.read_text().splitlines() if ln.startswith("HETATM")]
    coords = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
                       for ln in rows])
    types_ = [info["atom_encoder"][ln[76:78].strip()] for ln in rows]
    write_sdf_file(out, [build_molecule(coords, types_, info, perception="covalent")])
    return out


def ring_ligand_sdf(out):
    """A planar 9-atom ligand (a 6-ring of C with C, O and N substituents)
    centred on the synthetic pocket's ligand site, covalent bonds."""
    angle = np.arange(6) * np.pi / 3
    coords = np.concatenate([
        np.stack([1.39 * np.cos(angle), 1.39 * np.sin(angle), np.zeros(6)], 1),
        [[2.9, 0.0, 0.0], [3.6, 1.2, 0.0], [-2.8, 0.0, 0.0]]])
    info = dataset_params["crossdock_full"]
    write_sdf_file(out, [build_molecule(coords - coords.mean(0), [0] * 7 + [2, 1],
                                        info, perception="covalent")])
    return out


def write_test_dir(root, n_pockets=2):
    """``<pdb>.pdb``, ``<pdb>_A_LIG.sdf`` and ``<pdb>_A_LIG.txt`` (the
    residues within 8 A of the ligand) for each synthetic pocket."""
    root.mkdir()
    for k in range(n_pockets):
        pdb = root / f"pkt{k}.pdb"
        ref = chip_smoke.write_pocket_pdb(pdb, n_atoms=50, seed=k)
        ligand_sdf(pdb, root / f"pkt{k}_A_LIG.sdf")
        residues = port_pdb.get_pocket_from_ligand(port_pdb.parse_pdb(pdb), ref)
        (root / f"pkt{k}_A_LIG.txt").write_text(
            " ".join(f"{r.chain_id}:{r.resseq}" for r in residues))
    return root


def assert_same_molecules(got, want):
    assert len(got) == len(want)
    dev = 0.0
    for g, w in zip(got, want):
        assert g.symbols == w.symbols
        assert g.bonds == w.bonds
        dev = max(dev, float(np.abs(g.coords - w.coords).max()))
    assert dev <= COORD_TOL, dev
    return dev


@pytest.mark.parametrize("given,bias,n_min", [
    (None, 0, 0), (None, 3, 0), (None, -4, 6), (7, -2, 1), (5, 0, 9)])
def test_generate_ligands_sizes_match_jax(tmp_path, monkeypatch, given, bias, n_min):
    """The sizes drawn (from the same ``size_rng`` seed) or given, with the
    bias added and the clip applied, reach the sampler as JAX's do."""
    pdb = tmp_path / "pocket.pdb"
    ref = chip_smoke.write_pocket_pdb(pdb, n_atoms=50, seed=5)
    n = 4
    num_nodes = None if given is None else np.full(n, given)
    sizes = {}

    class Stop(Exception):
        pass

    def capture(side):
        def fn(num_nodes_lig, n_pad):
            sizes[side] = np.asarray(num_nodes_lig)
            raise Stop
        return fn

    jm, params = jax_module(T)
    monkeypatch.setattr(jax_module_mod, "num_nodes_to_mask", capture("jax"))
    with pytest.raises(Stop):
        jm.generate_ligands(params, jax.random.PRNGKey(0), pdb, n, ref_ligand=ref,
                            num_nodes_lig=num_nodes, n_nodes_bias=bias,
                            n_nodes_min=n_min, size_rng=np.random.default_rng(3))
    pm = port_side()
    monkeypatch.setattr(port_module_mod, "num_nodes_to_mask", capture("port"))
    with pytest.raises(Stop):
        pm.generate_ligands(pdb, n, torch.Generator(), ref_ligand=ref,
                            num_nodes_lig=num_nodes, n_nodes_bias=bias,
                            n_nodes_min=n_min, size_rng=np.random.default_rng(3))
    np.testing.assert_array_equal(sizes["port"], sizes["jax"])
    assert sizes["port"].min() >= n_min


def _sdf_pair(a, b):
    return read_sdf(a), jax_read_sdf(b)


def test_test_set_cli_matches_jax(tmp_path, monkeypatch, port_ckpt):
    test_dir = write_test_dir(tmp_path / "test")
    # 4 ligands of 9-14 atoms a batch (padded to 16, 64 pocket nodes): the
    # shapes of the optimize tests, so that JAX's eager passes compile once
    args = ["--test_dir", str(test_dir), "--n_samples", "4", "--batch_size", "4",
            "--timesteps", str(T), "--n_nodes_bias", "-2", "--n_nodes_min", "9",
            "--seed", "3"]
    noise = RecordedNoise(1)
    _, _, load = jax_side(noise)
    monkeypatch.setattr(jax_test_set, "load_model", load)
    with jax.disable_jit():
        jax_test_set.main(["unused", *args, "--outdir", str(tmp_path / "jax")])
    monkeypatch.setattr(port_ddpm.ConditionalDDPM, "sample_gaussian",
                        lambda self, g, shape, mask: noise.port_draw(g, shape, mask))
    port_test_set.main([str(port_ckpt), *args, "--outdir", str(tmp_path / "port"),
                        "--device", "cpu"])
    assert not noise.arrays

    def files(root):
        return sorted(p.relative_to(root).as_posix() for p in root.rglob("*"))

    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert files(tmp_path / "port") == [
        "pocket_times", "pocket_times.txt", "pocket_times/pkt0_A_LIG.txt",
        "pocket_times/pkt1_A_LIG.txt", "processed", "processed/pkt0_A_LIG_gen.sdf",
        "processed/pkt1_A_LIG_gen.sdf", "raw", "raw/pkt0_A_LIG_gen.sdf",
        "raw/pkt1_A_LIG_gen.sdf"]
    for sub in ("raw", "processed"):
        for k in range(2):
            name = f"{sub}/pkt{k}_A_LIG_gen.sdf"
            got, want = _sdf_pair(tmp_path / "port" / name, tmp_path / "jax" / name)
            assert len(got) == 4
            assert_same_molecules(got, want)

    def keys(path):
        return [ln.rsplit(" ", 1)[0] for ln in path.read_text().splitlines()]

    assert keys(tmp_path / "port" / "pocket_times.txt") \
        == keys(tmp_path / "jax" / "pocket_times.txt") \
        == [str(test_dir / f"pkt{k}_A_LIG.sdf") for k in range(2)]


def test_diversify_ligands_matches_jax(tmp_path):
    pdb = tmp_path / "pocket.pdb"
    chip_smoke.write_pocket_pdb(pdb, n_atoms=50, seed=7)
    sdf = ring_ligand_sdf(tmp_path / "lig.sdf")
    noise = RecordedNoise(2)
    jm, params, _ = jax_side(noise)
    jmols = jax_read_sdf(sdf) * 4
    jpocket = jm.prepare_pocket(jax_pdb.get_pocket_from_ligand(
        jax_pdb.parse_pdb(pdb), str(sdf)), repeats=4)
    with jax.disable_jit():
        want = jax_opt.diversify_ligands(jm, params, jax.random.PRNGKey(0), jpocket,
                                         jmols, timesteps=T)
    pm = port_side()
    pm.ddpm.sample_gaussian = noise.port_draw
    ppocket = pm.prepare_pocket(port_pdb.get_pocket_from_ligand(
        port_pdb.parse_pdb(pdb), str(sdf)), repeats=4)
    got = port_opt.diversify_ligands(pm, None, ppocket, read_sdf(sdf) * 4, timesteps=T)
    assert not noise.arrays
    assert len(got) == 4
    assert_same_molecules(got, want)


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def assert_same_csv(got_path, want_path):
    got, want = _csv_rows(got_path), _csv_rows(want_path)
    assert got[0] == want[0] == ["", "generation", "score", "fate", "smiles"]
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert (g[0], g[1], g[3], g[4]) == (w[0], w[1], w[3], w[4])
        assert abs(float(g[2]) - float(w[2])) <= 1e-12
    return got


def test_optimize_cli_matches_jax(tmp_path, monkeypatch, port_ckpt):
    """Two generations of 4 noised to level T; the noise seed is one at which
    each generation keeps a molecule through the valence check, so that both
    selections run."""
    pdb = tmp_path / "pocket.pdb"
    chip_smoke.write_pocket_pdb(pdb, n_atoms=50, seed=8)
    sdf = ring_ligand_sdf(tmp_path / "lig.sdf")
    args = ["--pdbfile", str(pdb), "--ref_ligand", str(sdf), "--objective", "sa",
            "--timesteps", str(T), "--population_size", "4", "--evolution_steps", "2",
            "--top_k", "3", "--seed", "1"]
    noise = RecordedNoise(1)
    _, _, load = jax_side(noise)
    monkeypatch.setattr(jax_opt, "load_model", load)
    with jax.disable_jit():
        jax_opt.main(["unused", *args, "--outfile", str(tmp_path / "jax.sdf")])
    monkeypatch.setattr(port_ddpm.ConditionalDDPM, "sample_gaussian",
                        lambda self, g, shape, mask: noise.port_draw(g, shape, mask))
    port_opt.main([str(port_ckpt), *args, "--outfile", str(tmp_path / "port.sdf"),
                   "--device", "cpu"])
    assert not noise.arrays
    rows = assert_same_csv(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert [r[1] for r in rows[1:]].count("0") == 1 and rows[1][3] == "initial"
    assert {"1", "2"} <= {r[1] for r in rows[1:]}
    got, want = _sdf_pair(tmp_path / "port.sdf", tmp_path / "jax.sdf")
    assert got
    assert_same_molecules(got, want)


def test_nlargest_matches_pandas():
    rng = np.random.default_rng(9)
    for trial in range(50):
        scores = rng.choice([0.1, 0.25, 0.5, 0.5, 0.75, float("nan")], int(rng.integers(1, 12)))
        rows = [{"score": float(s), "i": i} for i, s in enumerate(scores)]
        df = pd.DataFrame(rows)
        for k in range(1, len(rows) + 2):
            want = df.nlargest(k, "score")["i"].tolist()
            assert [r["i"] for r in port_opt.nlargest(rows, k)] == want, (scores, k)


def test_optimize_selection_and_reseed_match_jax(tmp_path, monkeypatch, port_ckpt):
    """The population loop against pandas' (fates, reseeding from the whole
    buffer after an empty generation, ``random.choice`` fill, ties, the CSV),
    with the sampler replaced on both sides by the same stand-in: generation
    1 yields nothing, the others every second molecule of the population."""
    pdb = tmp_path / "pocket.pdb"
    chip_smoke.write_pocket_pdb(pdb, n_atoms=50, seed=9)
    sdf = ring_ligand_sdf(tmp_path / "lig.sdf")
    args = ["--pdbfile", str(pdb), "--ref_ligand", str(sdf), "--objective", "qed",
            "--population_size", "5", "--evolution_steps", "4", "--top_k", "2",
            "--seed", "4"]

    def stand_in(population, calls):
        calls.append(len(population))
        if len(calls) == 2:
            return []
        out = []
        for k, m in enumerate(population[::2]):
            m = type(m)(list(m.symbols), np.array(m.coords), list(m.bonds)[k % 2:], m.name)
            out.append(m)
        return out

    jax_calls, port_calls = [], []
    _, _, load = jax_side(RecordedNoise(0))
    monkeypatch.setattr(jax_opt, "load_model", load)
    monkeypatch.setattr(jax_opt, "diversify_ligands",
                        lambda module, params, rng, pocket, mols, **k: stand_in(mols, jax_calls))
    jax_opt.main(["unused", *args, "--outfile", str(tmp_path / "jax.sdf")])
    monkeypatch.setattr(port_opt, "diversify_ligands",
                        lambda module, g, pocket, mols, **k: stand_in(mols, port_calls))
    port_opt.main([str(port_ckpt), *args, "--outfile", str(tmp_path / "port.sdf"),
                   "--device", "cpu"])
    assert port_calls == jax_calls == [5] * 4
    rows = assert_same_csv(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert {r[3] for r in rows[1:]} == {"initial", "survived", "purged"}
