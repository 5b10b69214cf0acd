"""The port's data processing against the JAX package on the CPU: backbone
frames, the smoothed size histogram (also against scipy), CrossDocked and
Binding MOAD extraction, splits and mains, and the baseline-sample collector.

Inputs are synthetic: pockets written by ``chip_smoke.write_pocket_pdb`` with
their 12-atom ligand (HETATM LIG A:900) as the complex's ligand, and the label
file layout of ``tests/test_processing.py``.  Integer and string outputs must
be equal, float ones equal to 1e-6 (the smoothed histogram to 1e-12).
"""
import json

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter as scipy_gaussian_filter

import chip_smoke
from diffsbdd_tpu.chem import pdb as jax_pdb
from diffsbdd_tpu.constants import dataset_params as jax_dataset_params
from diffsbdd_tpu.data import prepare_crossdocked as jax_prep
from diffsbdd_tpu.data import proc_bindingmoad as jax_moad
from diffsbdd_tpu.data import proc_crossdock as jax_cd
from diffsbdd_tpu.geom import backbone as jax_bb
from diffsbdd_tpu_torch.chem import pdb as port_pdb
from diffsbdd_tpu_torch.chem.molecule import SimpleMol, build_molecule
from diffsbdd_tpu_torch.chem.sdfio import write_sdf_file
from diffsbdd_tpu_torch.constants import dataset_params
from diffsbdd_tpu_torch.data import prepare_crossdocked as port_prep
from diffsbdd_tpu_torch.data import proc_bindingmoad as port_moad
from diffsbdd_tpu_torch.data import proc_crossdock as port_cd
from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset
from diffsbdd_tpu_torch.geom import backbone as port_bb


def assert_same(got, want, path=""):
    """Nested dicts / lists / arrays equal: floats to 1e-6, the rest exactly."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)) and not (want and isinstance(want[0], float)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------- backbone
def test_backbone_matches_jax():
    rng = np.random.default_rng(0)
    ca = rng.normal(size=(16, 3)) * 10
    quat = rng.normal(size=(16, 4))
    for f, args in (("get_bb_coords_from_transform", (ca, quat)),
                    ("quaternion_to_rotation_matrix", (quat,)),
                    ("rotation_matrix", (rng.uniform(-np.pi, np.pi, 5), 1))):
        assert_same(getattr(port_bb, f)(*args), getattr(jax_bb, f)(*args), f)
    coords, _ = jax_bb.get_bb_coords_from_transform(ca, quat)
    n, c_a, c = coords[0::3], coords[1::3], coords[2::3]
    assert_same(port_bb.get_bb_transform(n, c_a, c), jax_bb.get_bb_transform(n, c_a, c))
    # pi rotations (w = 0), where a sign shortcut would reflect the axis
    axes = np.array([[1.0, -1, 0], [1, 1, 0], [-1, 2, 0.5]])
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    K = np.zeros((3, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axes[:, 2], axes[:, 1], -axes[:, 0]
    K -= K.transpose(0, 2, 1)
    rot = np.eye(3) + 2.0 * K @ K
    assert_same(port_bb.rotation_matrix_to_quaternion(rot),
                jax_bb.rotation_matrix_to_quaternion(rot))


# ------------------------------------------------------ the size histogram
@pytest.mark.parametrize("shape,sigma", [((9, 30), 1.0), ((40,), 2.5), ((5, 7, 6), 0.7)])
def test_gaussian_filter_matches_scipy(shape, sigma):
    a = np.random.default_rng(1).poisson(2.0, shape).astype(np.float64)
    want = scipy_gaussian_filter(a, sigma=sigma, order=0, mode="constant", cval=0.0,
                                 truncate=4.0)
    np.testing.assert_allclose(port_cd.gaussian_filter(a, sigma), want, atol=1e-12, rtol=0)


def test_get_n_nodes_matches_jax():
    rng = np.random.default_rng(2)
    n_lig, n_pkt = rng.integers(3, 30, 40), rng.integers(20, 90, 40)
    lig_mask = np.repeat(np.arange(40.0), n_lig)
    pkt_mask = np.repeat(np.arange(40.0), n_pkt)
    hists = []
    for sigma in (None, 1.0):
        got = port_cd.get_n_nodes(lig_mask, pkt_mask, smooth_sigma=sigma)
        want = jax_cd.get_n_nodes(lig_mask, pkt_mask, smooth_sigma=sigma)
        assert got.shape == want.shape == (n_lig.max() + 1, n_pkt.max() + 1)
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
        hists.append(got)
    assert hists[0].sum() == 40 and np.count_nonzero(hists[1]) > np.count_nonzero(hists[0])


# -------------------------------------------------------- synthetic inputs
def write_complex(root, seed, n_atoms=80):
    """``pocket<seed>.pdb`` and ``pocket<seed>_lig.sdf``: a synthetic pocket
    and its ligand (covalent bonds)."""
    pdb = root / f"pocket{seed}.pdb"
    chip_smoke.write_pocket_pdb(pdb, n_atoms=n_atoms, seed=seed)
    _, ligand = chip_smoke.pocket_atoms(n_atoms, seed=seed)
    info = dataset_params["crossdock"]
    coords = np.array([xyz for _, _, xyz in ligand])
    types = [info["atom_encoder"][el] for _, el, _ in ligand]
    sdf = root / f"pocket{seed}_lig.sdf"
    mol = build_molecule(coords, types, info, perception="covalent")
    write_sdf_file(sdf, [SimpleMol(mol.symbols + ["H"], np.concatenate(
        [mol.coords, mol.coords[:1] + 1.0]), mol.bonds)])
    return pdb, sdf


@pytest.mark.parametrize("ca_only", [True, False], ids=["CA", "full-atom"])
def test_process_ligand_and_pocket_matches_jax(tmp_path, ca_only):
    pdb, sdf = write_complex(tmp_path, 3)
    info = dataset_params["crossdock" if ca_only else "crossdock_full"]
    args = (pdb, sdf, info["atom_encoder"], info["aa_encoder"], 8.0, ca_only)
    got, want = port_cd.process_ligand_and_pocket(*args), jax_cd.process_ligand_and_pocket(*args)
    assert_same(got, want)
    assert got[0]["lig_coords"].shape == (12, 3)  # the hydrogen is dropped
    assert got[1]["pocket_one_hot"].shape[1] == (20 if ca_only else 11)


@pytest.fixture(scope="module")
def crossdocked_raw(tmp_path_factory):
    """A raw CrossDocked layout of 6 pairs (4 train, 1 val, 1 test) plus a
    pair whose files are missing, with the split as .json and as .pt."""
    base = tmp_path_factory.mktemp("crossdocked")
    data = base / "crossdocked_pocket10"
    data.mkdir()
    pairs = []
    for seed in range(6):
        pdb, sdf = write_complex(data, seed)
        pairs.append([pdb.name, sdf.name])
    split = {"train": pairs[:4] + [["gone.pdb", "gone.sdf"]], "val": pairs[4:5],
             "test": pairs[5:]}
    (base / "split.json").write_text(json.dumps(split))
    torch.save({k: [tuple(p) for p in v] for k, v in split.items()}, base / "split_by_name.pt")
    return base


def _outputs(root):
    files = sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())
    out = {"files": files}
    for name in files:
        path = root / name
        if path.suffix == ".npz":
            with np.load(path) as f:
                out[name] = {k: f[k] for k in f.files}
        elif path.suffix == ".npy":
            out[name] = np.load(path, allow_pickle=True)
        else:
            out[name] = path.read_text()
    return out


@pytest.mark.parametrize("ca_only,split", [(True, "split.json"), (False, None)],
                         ids=["CA-json", "full-atom-pt"])
def test_crossdock_main_matches_jax(crossdocked_raw, tmp_path, ca_only, split, capsys):
    args = [str(crossdocked_raw)] + (["--ca_only"] if ca_only else []) \
        + (["--split_file", str(crossdocked_raw / split)] if split else [])
    port_cd.main(args + ["--outdir", str(tmp_path / "port")])
    jax_cd.main(args + ["--outdir", str(tmp_path / "jax")])
    got, want = _outputs(tmp_path / "port"), _outputs(tmp_path / "jax")
    assert_same(got, want)
    assert "train.npz" in got["files"] and "val/pocket4.pdb" in got["files"]
    ds = LigandPocketDataset(tmp_path / "port" / "train.npz")
    assert len(ds) == 4 and len(got["train_smiles.npy"]) == 4
    out = capsys.readouterr().out
    assert out.count("train: 4 complexes (1 failed)") == 2


def test_read_split_keeps_the_pt_route(crossdocked_raw):
    got = port_cd.read_split(crossdocked_raw / "split_by_name.pt")
    assert got == jax_cd.read_split(crossdocked_raw / "split_by_name.pt")
    assert port_cd.read_split(crossdocked_raw / "split.json") \
        == jax_cd.read_split(crossdocked_raw / "split.json")


def test_type_histograms_and_smiles_match_jax():
    info = dataset_params["crossdock"]
    pos = np.array([[0, 0, 0], [1.54, 0, 0], [5, 5, 5], [6.54, 5, 5.0], [7.9, 5, 5]])
    one_hot = np.eye(10)[[0, 0, 0, 2, 1]]
    mask = np.array([0, 0, 1, 1, 1])
    assert_same(port_cd.compute_smiles(pos, one_hot, mask, info),
                jax_cd.compute_smiles(pos, one_hot, mask, jax_dataset_params["crossdock"]))
    assert port_cd.type_histograms(one_hot, np.eye(20)[[3, 3, 19]], info["atom_decoder"],
                                   info["aa_decoder"]) \
        == jax_cd.type_histograms(one_hot, np.eye(20)[[3, 3, 19]], info["atom_decoder"],
                                  info["aa_decoder"])


# ------------------------------------------------------------ binding MOAD
LABELS = ('1.1.1.1,,,,,,,,,,\n'
          ',,1ABC,,,,,,,,\n'
          ',,,LIG:A:900,valid,,,,,CC(=O)O,\n'
          ',,,BAD:A:101,invalid,,,,,CC,\n'
          ',,2DEF,,,,,,,,\n'
          ',,,LIG:A:900,valid,,,,,CCO,\n'
          '2.7.7.7,,,,,,,,,,\n'
          ',,3GHI,,,,,,,,\n'
          ',,,LIG:A:900,valid,,,,,c1ccccc1,\n'
          ',,,MIS:A:5,valid,,,,,C,\n'
          '3.1.1.1,,,,,,,,,,\n'
          ',,4JKL,,,,,,,,\n'
          ',,,LIG:A:900,valid,,,,,CN,\n'
          ',,5MNO,,,,,,,,\n'
          ',,,LIG:A:900,valid,,,,,CS,\n')


def test_moad_labels_filter_and_split_match_jax(tmp_path):
    csv = tmp_path / "every.csv"
    csv.write_text(LABELS)
    got, want = port_moad.read_label_file(csv), jax_moad.read_label_file(csv)
    assert got == want and len(got["1.1.1.1"]["1ABC"]) == 2
    with pytest.warns(UserWarning, match="RDKit unavailable"):
        got = port_moad.compute_druglikeness(got)
    with pytest.warns(UserWarning, match="RDKit unavailable"):
        want = jax_moad.compute_druglikeness(want)
    assert got == want
    for seed in (0, 3):
        flat = port_moad.filter_and_flatten(got, 0.0, 10, seed)
        assert flat == jax_moad.filter_and_flatten(want, 0.0, 10, seed)
        assert "BAD:A:101" not in {m[0] for _, _, m in flat}
        assert port_moad.split_by_ec_number(flat, 2, 1) \
            == jax_moad.split_by_ec_number(flat, 2, 1)
    assert len(port_moad.filter_and_flatten(got, 0.0, 1, 0)) == 2  # 'LIG' at most once...
    assert port_moad.filter_and_flatten(got, 0.0, 1, 0) \
        == jax_moad.filter_and_flatten(want, 0.0, 1, 0)  # ...'MIS' once


@pytest.mark.parametrize("ca_only", [True, False], ids=["CA", "full-atom"])
def test_moad_extraction_matches_jax(tmp_path, ca_only):
    pdb, _ = write_complex(tmp_path, 4)
    info = dataset_params["bindingmoad"]
    args = ("LIG", "A", 900, info["atom_encoder"], info["aa_encoder"], 8.0, ca_only)
    got = port_moad.process_ligand_and_pocket(port_pdb.parse_pdb(pdb), *args)
    want = jax_moad.process_ligand_and_pocket(jax_pdb.parse_pdb(pdb), *args)
    assert_same(got, want)
    assert "A:900" not in got[1]["pocket_ids"]
    for mod, parse in ((port_moad, port_pdb.parse_pdb), (jax_moad, jax_pdb.parse_pdb)):
        with pytest.raises(ValueError):
            mod.process_ligand_and_pocket(parse(pdb), "WRONG", *args[1:])


def write_moad_raw(base):
    """Binding MOAD's layout: every.csv and biounits, one for each PDB of the
    label file but 5MNO; 3GHI's 'MIS:A:5' is in no biounit."""
    base.mkdir(parents=True, exist_ok=True)
    (base / "every.csv").write_text(LABELS)
    pdbdir = base / "BindingMOAD_2020"
    pdbdir.mkdir()
    for seed, pdb_id in enumerate(("1abc", "2def", "3ghi", "4jkl")):
        chip_smoke.write_pocket_pdb(pdbdir / f"{pdb_id}.bio1", n_atoms=80, seed=10 + seed)
    return base


def test_moad_process_split_with_eval_files_matches_jax(tmp_path):
    raw = write_moad_raw(tmp_path / "raw")
    info = dataset_params["bindingmoad"]
    examples = [("1.1.1.1", "1ABC", ["LIG:A:900", "valid", "CC", 1.0]),
                ("2.7.7.7", "3GHI", ["LIG:A:900", "valid", "C", 1.0]),
                ("2.7.7.7", "3GHI", ["MIS:A:5", "valid", "C", 1.0]),
                ("3.1.1.1", "5MNO", ["LIG:A:900", "valid", "CS", 1.0])]
    out = {}
    for side, mod in (("port", port_moad), ("jax", jax_moad)):
        out[side] = mod.process_split(examples, raw / "BindingMOAD_2020",
                                      info["atom_encoder"], info["aa_encoder"], 8.0, True,
                                      out_dir=tmp_path / side, dataset_info=info)
    assert_same(out["port"][:2], out["jax"][:2])
    print(out["port"][2])
    assert out["port"][2] == out["jax"][2]
    assert list(out["port"][1]["receptors"]) == ["1abc.bio1", "3ghi.bio1"]
    got, want = _outputs(tmp_path / "port"), _outputs(tmp_path / "jax")
    assert_same(got, want)
    assert "1ABC-bio1.pdb" in got["files"] and "1ABC-bio1_LIG:A:900.sdf" in got["files"]
    assert "HETATM" not in got["1ABC-bio1.pdb"]


@pytest.mark.parametrize("ca_only", [True, False], ids=["CA", "full-atom"])
def test_moad_main_matches_jax(tmp_path, ca_only):
    raw = write_moad_raw(tmp_path / "raw")
    args = [str(raw), "--num_val", "2", "--num_test", "2"] + (["--ca_only"] if ca_only else [])
    with pytest.warns(UserWarning, match="RDKit unavailable"):
        port_moad.main(args + ["--outdir", str(tmp_path / "port")])
    with pytest.warns(UserWarning, match="RDKit unavailable"):
        jax_moad.main(args + ["--outdir", str(tmp_path / "jax")])
    got, want = _outputs(tmp_path / "port"), _outputs(tmp_path / "jax")
    assert got["files"] == want["files"]
    assert_same(got, want)
    assert len(LigandPocketDataset(tmp_path / "port" / "train.npz")) >= 1


# ------------------------------------------------------ baseline collector
def test_collect_matches_jax(tmp_path):
    a, b = (SimpleMol(["C", "O"], np.array([[0, 0, 0], [1.2, k, 0]], np.float32),
                      [(0, 1, 2)], name=f"m{k}") for k in range(2))
    dump = {("dir/rec_1.pdb", "dir/lig_a.sdf"): [a, b], "dir/pocket_x.sdf": a}
    torch.save(dump, tmp_path / "samples.pt")
    assert port_prep.collect(tmp_path / "samples.pt", tmp_path / "port") == 2
    jax_prep.main([str(tmp_path / "samples.pt"), "--outdir", str(tmp_path / "jax")])
    got, want = _outputs(tmp_path / "port"), _outputs(tmp_path / "jax")
    assert_same(got, want)
    assert got["files"] == ["pocket-x_gen.sdf", "rec-1-lig-a_gen.sdf"]


def test_pdb_helpers_match_jax(tmp_path):
    """``Residue.coords``, ``Structure.residues_of_chain`` and
    ``write_receptor_pdb`` (the receptor without the processed ligand)."""
    pdb, _ = write_complex(tmp_path, 6)
    got, want = port_pdb.parse_pdb(pdb), jax_pdb.parse_pdb(pdb)
    for heavy_only in (True, False):
        assert_same([r.coords(heavy_only) for r in got.get_residues()],
                    [r.coords(heavy_only) for r in want.get_residues()])
    assert [(r.resname, r.resseq) for r in got.residues_of_chain("A")] \
        == [(r.resname, r.resseq) for r in want.residues_of_chain("A")]
    assert got.residues_of_chain("B") == want.residues_of_chain("B") == []
    port_pdb.write_receptor_pdb(pdb, tmp_path / "port.pdb", [("LIG", "A", 900)])
    jax_pdb.write_receptor_pdb(pdb, tmp_path / "jax.pdb", [("LIG", "A", 900)])
    assert (tmp_path / "port.pdb").read_text() == (tmp_path / "jax.pdb").read_text()
    assert "HETATM" in pdb.read_text() and "HETATM" not in (tmp_path / "port.pdb").read_text()
