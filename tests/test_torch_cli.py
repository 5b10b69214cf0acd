"""The port's generate_ligands CLI against the JAX CLI on a synthetic pocket.

Both CLIs sample the fixture weights at T = 5 from the same recorded noise
(the JAX one eagerly, so its noise hook can pop the arrays) and write SDFs
whose molecules must have the same atoms, with coordinates within 1e-3 A.
"""
import types

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import diffsbdd_tpu.cli.generate_ligands as jax_cli
import diffsbdd_tpu_torch.cli.generate_ligands as port_cli
import diffsbdd_tpu_torch.diffusion.ddpm as port_ddpm
from diffsbdd_tpu.chem.sdfio import read_sdf
from diffsbdd_tpu_torch.checkpoint import import_jax_npz
from test_torch_sampling import FIXTURE_NPZ, jax_module, noise_stream

N_SAMPLES, N_ATOMS, T = 2, 8, 5


def test_cli_matches_jax_cli(tmp_path, monkeypatch):
    pdb = tmp_path / "pocket.pdb"
    ref = chip_smoke.write_pocket_pdb(pdb, n_atoms=50, seed=4)
    args = ["--pdbfile", str(pdb), "--ref_ligand", ref, "--n_samples",
            str(N_SAMPLES), "--num_nodes_lig", str(N_ATOMS), "--all_frags",
            "--timesteps", str(T)]
    noise = noise_stream(1, T + 2)

    queue = list(noise)
    module, params = jax_module(T)
    module.ddpm.set_queue(queue)
    monkeypatch.setattr(jax_cli, "load_model", lambda *a, **k: (
        module, types.SimpleNamespace(params=params), None))
    with jax.disable_jit():
        jax_cli.main(["unused", *args, "--outfile", str(tmp_path / "jax.sdf")])
    assert not queue

    ckpt = import_jax_npz(FIXTURE_NPZ, tmp_path / "ckpt",
                          {"diffusion_params": {"diffusion_steps": T}})
    queue = list(noise)
    monkeypatch.setattr(port_ddpm.ConditionalDDPM, "sample_gaussian",
                        lambda self, g, shape, mask:
                        torch.as_tensor(queue.pop(0)) * mask[..., None])
    port_cli.main([str(ckpt), *args, "--outfile", str(tmp_path / "port.sdf"),
                   "--device", "cpu"])
    assert not queue

    want, got = read_sdf(tmp_path / "jax.sdf"), read_sdf(tmp_path / "port.sdf")
    assert len(got) == len(want) == N_SAMPLES
    dev = 0.0
    for g, w in zip(got, want):
        assert g.symbols == w.symbols
        dev = max(dev, float(np.abs(g.coords - w.coords).max()))
    print(f"CLI SDFs: max coordinate deviation {dev:.2e} A")
    assert dev <= 1e-3


def test_cli_refuses_cpu_fallback(tmp_path):
    """Without a card and without --device cpu the CLI raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main([str(tmp_path), "--pdbfile", "x.pdb", "--ref_ligand",
                       "A:1", "--outfile", str(tmp_path / "o.sdf")])


def test_cli_needs_sizes_without_a_size_prior(tmp_path, capsys):
    """A checkpoint imported without a size histogram has no prior to draw
    ligand sizes from: the CLI stops unless --num_nodes_lig is given."""
    ckpt = import_jax_npz(FIXTURE_NPZ, tmp_path / "ckpt")
    with pytest.raises(SystemExit):
        port_cli.main([str(ckpt), "--pdbfile", "x.pdb", "--ref_ligand", "A:1",
                       "--outfile", str(tmp_path / "o.sdf"), "--device", "cpu"])
    assert "--num_nodes_lig" in capsys.readouterr().err
    assert not (tmp_path / "o.sdf").exists()
