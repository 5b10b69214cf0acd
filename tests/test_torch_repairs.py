"""Three port faults against the JAX package, repaired: a virtual-node
model's ligand sizes, a reference ligand given as an SDF file, and the
``bindingmoad`` dataset (every preset of ``configs/`` builds, and a tiny MOAD
model's loss terms match JAX with CA and with full-atom pockets)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import diffsbdd_tpu.train.module as jax_module_mod
import diffsbdd_tpu_torch.cli.generate_ligands as port_cli
import diffsbdd_tpu_torch.cli.inpaint as port_inpaint_cli
import diffsbdd_tpu_torch.train.module as port_module_mod
from diffsbdd_tpu.chem import pdb as jax_pdb
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.constants import dataset_params as jax_dataset_params
from diffsbdd_tpu_torch.checkpoint import import_jax_npz
from diffsbdd_tpu_torch.chem import pdb as port_pdb
from diffsbdd_tpu_torch.chem.molecule import SimpleMol
from diffsbdd_tpu_torch.chem.sdfio import read_sdf, write_sdf_file
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.constants import dataset_params
from test_torch_sampling import FIXTURE_NPZ
from test_torch_train import (LOSS_TOL, assert_tree_close, both_modules, jax_draws,
                              tiny_overrides)

PRESETS = sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.yml"))

T = 5


def write_complex(tmp_path, offset):
    """A synthetic pocket PDB and an SDF of its ligand's atoms moved by
    ``offset`` (A): off the centre, the 8 A cutoff keeps only some residues."""
    pdb = tmp_path / "pocket.pdb"
    chip_smoke.write_pocket_pdb(pdb, n_atoms=120, seed=5)
    _, ligand = chip_smoke.pocket_atoms(120, seed=5)
    coords = np.array([xyz for _, _, xyz in ligand], np.float32) + np.float32(offset)
    sdf = tmp_path / "ref.sdf"
    write_sdf_file(sdf, [SimpleMol([el for _, el, _ in ligand], coords, [])])
    return pdb, sdf


def residue_keys(residues):
    return [(r.chain_id, r.resseq, r.resname) for r in residues]


@pytest.mark.parametrize("offset", [0.0, 6.0], ids=["centred", "off_centre"])
def test_pocket_from_an_sdf_ligand_matches_jax(tmp_path, offset):
    pdb, sdf = write_complex(tmp_path, np.array([offset, 0.0, 0.0]))
    got = port_pdb.get_pocket_from_ligand(port_pdb.parse_pdb(pdb), str(sdf))
    want = jax_pdb.get_pocket_from_ligand(jax_pdb.parse_pdb(pdb), str(sdf))
    assert residue_keys(got) == residue_keys(want)
    n_all = sum(r.is_standard_aa for r in port_pdb.parse_pdb(pdb).get_residues())
    assert 0 < len(got) <= n_all
    if offset:
        assert len(got) < n_all  # the cutoff bites


def test_cli_takes_an_sdf_reference_ligand(tmp_path):
    """``cli.generate_ligands --ref_ligand x.sdf`` on the fixture checkpoint."""
    pdb, sdf = write_complex(tmp_path, np.zeros(3))
    ckpt = import_jax_npz(FIXTURE_NPZ, tmp_path / "ckpt",
                          {"diffusion_params": {"diffusion_steps": T}})
    out = tmp_path / "out.sdf"
    port_cli.main([str(ckpt), "--pdbfile", str(pdb), "--ref_ligand", str(sdf),
                   "--outfile", str(out), "--n_samples", "2", "--num_nodes_lig", "6",
                   "--all_frags", "--timesteps", str(T), "--device", "cpu"])
    mols = read_sdf(out)
    assert len(mols) == 2 and all(m.n_atoms == 6 for m in mols)
    assert all(np.isfinite(m.coords).all() for m in mols)


def test_inpaint_cli_takes_an_sdf_reference_ligand(tmp_path):
    """``cli.inpaint --ref_ligand x.sdf --fix_atoms frag.sdf`` on the fixture
    checkpoint: the fragment's atoms lead every ligand, near where they were
    put (RePaint clamps them at every step but the last, p(x | z_0), whose
    noise moves them by a few hundredths of an angstrom).  Atom names with an
    SDF reference are refused with a clear error."""
    pdb, sdf = write_complex(tmp_path, np.zeros(3))
    frag_mol = read_sdf(sdf)[0]
    frag = tmp_path / "frag.sdf"
    write_sdf_file(frag, [SimpleMol(frag_mol.symbols[:3], frag_mol.coords[:3], [])])
    ckpt = import_jax_npz(FIXTURE_NPZ, tmp_path / "ckpt",
                          {"diffusion_params": {"diffusion_steps": T}})
    out = tmp_path / "out.sdf"
    args = [str(ckpt), "--pdbfile", str(pdb), "--ref_ligand", str(sdf),
            "--outfile", str(out), "--n_samples", "2", "--add_n_nodes", "3",
            "--timesteps", str(T), "--resamplings", "1", "--device", "cpu"]
    port_inpaint_cli.main(args + ["--fix_atoms", str(frag)])
    mols = read_sdf(out)
    assert len(mols) == 2 and all(m.n_atoms == 6 for m in mols)
    for m in mols:
        assert np.isfinite(m.coords).all()
        assert m.symbols[:3] == frag_mol.symbols[:3]
        np.testing.assert_allclose(m.coords[:3], frag_mol.coords[:3], atol=0.2)
    with pytest.raises(ValueError, match="reference ligand residue"):
        port_inpaint_cli.main(args + ["--fix_atoms", "C0", "C1"])


def test_virtual_node_model_samples_at_the_padded_maximum(tmp_path, monkeypatch):
    """Without num_nodes_lig a virtual-node model samples every ligand at the
    size histogram's maximum (virtual atoms included), as JAX does, and never
    draws from the size prior.  The sizes are read where the molecules would
    be built: with random weights an atom may decode as the virtual type,
    which neither package's bond tables cover."""
    hist = np.ones((13, 65))
    over = tiny_overrides(virtual_nodes=True, diffusion_params={"diffusion_steps": T})
    pdb, _ = write_complex(tmp_path, np.zeros(3))
    ref = "A:900"

    sizes = {}

    class Stop(Exception):
        pass

    def jax_sizes(num_nodes, n_pad):
        sizes["jax"] = np.asarray(num_nodes)
        raise Stop

    jm = jax_module_mod.build_module_from_config(jax_load_config(overrides=over), hist)
    monkeypatch.setattr(jax_module_mod, "num_nodes_to_mask", jax_sizes)
    with pytest.raises(Stop):
        jm.generate_ligands(None, jax.random.PRNGKey(0), pdb, 3, ref_ligand=ref)

    def port_sizes(xh_lig, lig_mask, *a, **k):
        assert np.isfinite(xh_lig).all()
        sizes["port"] = lig_mask.sum(1)
        return []

    pm = port_module_mod.build_module_from_config(load_config(overrides=over), hist).eval()
    pm.ddpm.size_distribution.sample_conditional = None  # must not be drawn from
    monkeypatch.setattr(port_module_mod, "molecules_from_samples", port_sizes)
    pm.generate_ligands(pdb, 3, torch.Generator().manual_seed(0), ref_ligand=ref,
                        timesteps=T)
    assert pm.max_num_nodes == 12
    np.testing.assert_array_equal(sizes["jax"], np.full(3, 12))
    np.testing.assert_array_equal(sizes["port"], sizes["jax"])


def test_every_dataset_matches_jax():
    """The three type spaces, with their histograms, bond and LJ tables and
    rendering colours and radii (11 of each for MOAD's 10 atom types)."""
    assert sorted(dataset_params) == sorted(jax_dataset_params) \
        == ["bindingmoad", "crossdock", "crossdock_full"]
    for name, want in jax_dataset_params.items():
        got = dataset_params[name]
        assert sorted(got) == sorted(want), name
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                          err_msg=f"{name}/{key}")
    assert len(dataset_params["bindingmoad"]["colors_dic"]) == 11
    assert len(dataset_params["bindingmoad"]["radius_dic"]) == 11


@pytest.mark.parametrize("preset", PRESETS, ids=[p.stem for p in PRESETS])
def test_every_preset_builds_as_in_jax(preset):
    jm = jax_module_mod.build_module_from_config(jax_load_config(preset),
                                                 np.ones((17, 65)))
    pm = port_module_mod.build_module_from_config(load_config(preset),
                                                  np.ones((17, 65)))
    assert type(pm.ddpm).__name__ == type(jm.ddpm).__name__
    assert (pm.atom_nf, pm.residue_nf, pm.lig_type_decoder, pm.pocket_representation,
            pm.ddpm.T) == (jm.atom_nf, jm.residue_nf, jm.lig_type_decoder,
                           jm.pocket_representation, jm.ddpm.T)
    assert pm.dataset_info["atom_decoder"] == jm.dataset_info["atom_decoder"]


def moad_batch(rng, residue_nf, B=4, NL=8, NP=24):
    """A padded numpy batch of MOAD complexes: ligands of 5-8 atoms of the 10
    types, pockets of 14-24 nodes typed in ``residue_nf`` classes."""
    def part(n_max, sizes, nf, scale):
        mask = (np.arange(n_max)[None] < sizes[:, None]).astype(np.float32)
        return {"x": (rng.standard_normal((B, n_max, 3)) * scale).astype(np.float32)
                * mask[..., None],
                "one_hot": np.eye(nf, dtype=np.float32)[rng.integers(0, nf, (B, n_max))]
                * mask[..., None],
                "mask": mask, "size": sizes.astype(np.int32)}
    return (part(NL, rng.integers(5, NL + 1, B), 10, 1.5),
            part(NP, rng.integers(14, NP + 1, B), residue_nf, 4.0))


@pytest.mark.parametrize("representation,residue_nf,training",
                         [("CA", 20, True), ("full-atom", 10, False)])
def test_bindingmoad_loss_terms_match_jax(representation, residue_nf, training):
    over = tiny_overrides(dataset="bindingmoad", pocket_representation=representation)
    jm, params, pm = both_modules(over)
    assert (pm.atom_nf, pm.residue_nf) == (10, residue_nf)
    lig, pkt = moad_batch(np.random.default_rng(3), residue_nf)
    rng = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in lig.items()}, {k: jnp.asarray(v) for k, v in pkt.items()}
    want = jm.ddpm.loss_terms(params, rng, *jb, training)
    t_int, noise = jax_draws(rng, lig, 10, training)
    tq, nq = [t_int], list(noise)
    pm.ddpm.sample_timesteps = lambda g, n, lowest: torch.as_tensor(tq.pop(0))
    pm.ddpm.sample_gaussian = lambda g, shape, mask: \
        torch.tensor(nq.pop(0)) * mask[..., None]
    with torch.no_grad():
        got = pm.ddpm.loss_terms(None, {k: torch.as_tensor(v) for k, v in lig.items()},
                                 {k: torch.as_tensor(v) for k, v in pkt.items()}, training)
    assert not tq and not nq
    assert_tree_close(got.pop("info"), want.pop("info"), **LOSS_TOL)
    assert_tree_close(got, want, **LOSS_TOL)
