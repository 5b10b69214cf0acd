"""The port's docking wrappers and the docking branch of ``analyze_samples``
against the JAX package on the CPU, with stand-ins for ``smina.static``,
``qvina2.1``, ``obabel`` and ``prepare_receptor4.py`` on PATH (the stubs of
``tests/test_docking.py``): the same scores, files and NaNs, with a binary
missing, a run that fails and a receptor file that is not there."""
import pickle

import numpy as np
import pytest

from diffsbdd_tpu.chem import docking as jax_docking
from diffsbdd_tpu.chem.molecule import build_molecule as jax_build_molecule
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.train.module import build_module_from_config as jax_build
from diffsbdd_tpu_torch.chem import docking
from diffsbdd_tpu_torch.chem.molecule import SimpleMol, build_molecule
from diffsbdd_tpu_torch.chem.sdfio import read_sdf, write_sdf_file
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.train.module import build_module_from_config
from test_docking import QVINA_FAIL_STUB, stub_binaries, stub_prep  # noqa: F401
from test_torch_train import tiny_overrides


def mols(seeds, n=5):
    """Chains of ``n`` carbons, molecule ``seed`` about 10 * seed A out."""
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        coords = rng.normal(size=(n, 3)).astype(np.float32) + 10 * seed
        out.append(SimpleMol(symbols=["C"] * n, coords=coords,
                       bonds=[(i, i + 1, 1) for i in range(n - 1)], name=f"mol{seed}"))
    return out


def same_mol(a, b):
    if a is None or b is None:
        return a is b
    return (a.symbols == b.symbols and a.bonds == b.bonds and a.name == b.name
            and np.array_equal(a.coords, b.coords))


def both(fn_name, *args, **kw):
    """(port, JAX) results of one docking function on the same arguments."""
    return getattr(docking, fn_name)(*args, **kw), getattr(jax_docking, fn_name)(*args, **kw)


def test_smina_scores_match_jax(stub_binaries, tmp_path):
    rec = tmp_path / "rec.pdb"
    rec.write_text("END\n")
    got, want = both("smina_score", mols([0, 1]), str(rec))
    assert got == want == [-7.31415, -5.0]
    got, want = both("smina_score", mols([0, 1]), [str(rec), str(rec)])
    assert got == want == [-7.31415, -7.31415]
    # three molecules, two parsed scores: every score is NaN, with a warning
    with pytest.warns(UserWarning, match="discarding ambiguous"):
        got = docking.smina_score(mols([0, 1, 2]), str(rec))
    assert np.isnan(got).all() and len(got) == 3
    with pytest.raises(ValueError, match="1:1"):
        docking.smina_score(mols([0, 1]), [str(rec)])
    assert docking.calculate_smina_score(rec, tmp_path / "x.sdf") \
        == jax_docking.calculate_smina_score(rec, tmp_path / "x.sdf")


def test_qvina2_scores_files_and_nans_match_jax(stub_binaries, tmp_path):
    """Three blocks, the middle one truncated: a NaN in its place (obabel's
    block indices stay aligned), docked poses read back; then a rerun that
    reads the cached poses, and a failing QuickVina2 run."""
    sdf = tmp_path / "lig.sdf"
    write_sdf_file(sdf, mols([1, 2, 3]))
    blocks = sdf.read_text().split("$$$$\n")
    sdf.write_text("$$$$\n".join([blocks[0], "\n".join(blocks[1].split("\n")[:6]) + "\n",
                                  *blocks[2:]]))
    rec = tmp_path / "rec.pdbqt"
    rec.write_text("REMARK receptor\n")
    assert read_sdf(sdf, keep_invalid=True)[1] is None and len(read_sdf(sdf)) == 2

    scores, poses = docking.calculate_qvina2_score(rec, sdf, tmp_path / "port",
                                                   return_mols=True)
    want_scores, want_poses = jax_docking.calculate_qvina2_score(
        rec, sdf, tmp_path / "jax", return_mols=True)
    np.testing.assert_array_equal(scores, want_scores)
    assert np.isnan(scores[1]) and np.isfinite([scores[0], scores[2]]).all()
    assert [p is None for p in poses] == [p is None for p in want_poses]
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())

    # cached poses: the best ' VINA RESULT:' of each *_out.sdf
    for out in ("port", "jax"):
        (tmp_path / out / "lig_0_out.sdf").write_text(
            "x\n VINA RESULT:    -8.1  0.0  0.0\n VINA RESULT:    -6.0  1.0  2.0\n")
    got, want = docking.calculate_qvina2_score(rec, sdf, tmp_path / "port"), \
        jax_docking.calculate_qvina2_score(rec, sdf, tmp_path / "jax")
    np.testing.assert_array_equal(got, want)
    assert got[0] == -8.1

    (stub_binaries / "qvina2.1").write_text(QVINA_FAIL_STUB)
    single = tmp_path / "one.sdf"
    write_sdf_file(single, mols([4]))
    got, want = both("calculate_qvina2_score", rec, single, tmp_path / "fail",
                     return_mols=True)
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all() and got[1] == want[1] == [None]


def test_receptor_preparation_matches_jax(stub_prep, tmp_path):
    pdb_dir = tmp_path / "pdbs"
    pdb_dir.mkdir()
    for name in ("recA", "recB"):
        (pdb_dir / f"{name}.pdb").write_text("ATOM\nEND\n")
    for dataset in ("crossdocked", "bindingmoad"):
        got = docking.pdbs_to_pdbqts(pdb_dir, tmp_path / f"port_{dataset}", dataset)
        want = jax_docking.pdbs_to_pdbqts(pdb_dir, tmp_path / f"jax_{dataset}", dataset)
        assert [p.name for p in got] == [p.name for p in want] == ["recA.pdbqt", "recB.pdbqt"]
    calls = (stub_prep / "prep_calls.txt").read_text().splitlines()
    # port, JAX for crossdocked, then port, JAX for MOAD: the same flags
    assert [c.split(" -o ")[1].split()[1:] for c in calls] == \
        [[], [], [], [], ["-A", "checkhydrogens", "-e"], ["-A", "checkhydrogens", "-e"],
         ["-A", "checkhydrogens", "-e"], ["-A", "checkhydrogens", "-e"]]
    with pytest.raises(NotImplementedError):
        docking.pdb_to_pdbqt(pdb_dir / "recA.pdb", tmp_path / "x.pdbqt", dataset="nope")


def test_missing_binaries_raise_as_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    for call in (lambda m: m.calculate_qvina2_score(tmp_path / "r.pdbqt",
                                                    tmp_path / "l.sdf", tmp_path),
                 lambda m: m.calculate_smina_score(tmp_path / "r.pdb", tmp_path / "l.sdf"),
                 lambda m: m.sdf_to_pdbqt(tmp_path / "l.sdf", tmp_path / "l.pdbqt", 0),
                 lambda m: m.pdb_to_pdbqt(tmp_path / "r.pdb", tmp_path / "r.pdbqt")):
        with pytest.raises(FileNotFoundError) as got:
            call(docking)
        with pytest.raises(FileNotFoundError) as want:
            call(jax_docking)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dataset", ["moad", "crossdocked"])
def test_batch_cli_matches_jax(stub_binaries, tmp_path, dataset):
    """``main`` over a directory: the same results, the same CSV text (JAX
    writes it with pandas) and the same pickle."""
    pdbqt_dir, sdf_dir = tmp_path / "receptors", tmp_path / "sdfs"
    pdbqt_dir.mkdir()
    sdf_dir.mkdir()
    if dataset == "moad":
        for rec in ("1abc-bio1", "2xyz-bio1"):
            (pdbqt_dir / f"{rec}.pdbqt").write_text("REMARK receptor\n")
        write_sdf_file(sdf_dir / "1abc-bio1_pocket0_gen.sdf", mols([1]))
        write_sdf_file(sdf_dir / "2xyz-bio1_pocket3_gen.sdf", mols([2, 3]))
    else:
        (pdbqt_dir / "pocketA.pdbqt").write_text("REMARK receptor\n")
        write_sdf_file(sdf_dir / "pocketA_gen.sdf", mols([4, 5]))
    out = {}
    for side, mod in (("port", docking), ("jax", jax_docking)):
        out[side] = mod.main(["--pdbqt_dir", str(pdbqt_dir), "--sdf_dir", str(sdf_dir),
                              "--out_dir", str(tmp_path / side), "--write_csv",
                              "--write_dict", "--dataset", dataset])
    assert out["port"] == out["jax"]
    assert (tmp_path / "port" / "qvina2_scores.csv").read_text() \
        == (tmp_path / "jax" / "qvina2_scores.csv").read_text()
    dicts = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "qvina2_scores.pkl", "rb") as f:
            dicts[side] = pickle.load(f)
    assert dicts["port"].keys() == dicts["jax"].keys()
    for name, want in dicts["jax"].items():
        got = dicts["port"][name]
        assert {k: got[k] for k in ("receptor", "ligand", "scores")} \
            == {k: want[k] for k in ("receptor", "ligand", "scores")}
        assert all(same_mol(a, b) for a, b in zip(got["mols"], want["mols"]))


@pytest.fixture(scope="module")
def analysis_inputs():
    """Both modules (tiny, full-atom; no weights: the metrics read none) and
    3 molecules built on each side from the same coordinates and types."""
    over, hist = tiny_overrides(), np.ones((17, 65))
    jm = jax_build(jax_load_config(overrides=over), hist)
    pm = build_module_from_config(load_config(overrides=over), hist)
    rng = np.random.default_rng(0)
    coords = [rng.normal(size=(6, 3)) * 1.2 for _ in range(3)]
    types = [rng.integers(0, 4, 6) for _ in range(3)]
    port_mols = [build_molecule(c, t, pm.dataset_info) for c, t in zip(coords, types)]
    jax_mols = [jax_build_molecule(c, t, jm.dataset_info, use_openbabel=False)
                for c, t in zip(coords, types)]
    atom_types = np.concatenate(types).tolist()
    return jm, pm, port_mols, jax_mols, atom_types


def _analyze(analysis_inputs, receptors):
    jm, pm, port_mols, jax_mols, atom_types = analysis_inputs
    got = pm.analyze_samples(port_mols, atom_types, [], receptors=receptors)
    want = jm.analyze_samples(jax_mols, atom_types, [], receptors=receptors)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    return got


def test_analyze_samples_scores_receptors_as_jax(analysis_inputs, stub_binaries, tmp_path):
    recs = []
    for k in range(3):
        recs.append(tmp_path / f"rec{k}.pdb")
        recs[-1].write_text("END\n")
    got = _analyze(analysis_inputs, recs)
    assert got["smina_score"] == pytest.approx(-7.31415, abs=1e-12)
    # a receptor file missing: no score, as in JAX
    assert "smina_score" not in _analyze(analysis_inputs, recs[:2] + [tmp_path / "gone.pdb"])
    # a list that does not pair 1:1 with the molecules: no score
    assert "smina_score" not in _analyze(analysis_inputs, recs[:2])


def test_analyze_samples_without_smina_warns_and_skips(analysis_inputs, tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    rec = tmp_path / "rec.pdb"
    rec.write_text("END\n")
    with pytest.warns(UserWarning, match="smina scoring skipped"):
        got = _analyze(analysis_inputs, [rec] * 3)
    assert "smina_score" not in got

