"""The port's sampling server against the JAX package's.

Both servers hold the fixture weights (hidden 64, 3 layers) at T = 2 on a
synthetic pocket.  The handlers' replies must match; a seeded ``generate``
under the same recorded noise must give the same molecule keys and sizes;
warmup must leave the server's streams alone; the JSON-lines loop must
answer each line and stop at ``shutdown``.
"""
import io
import json
import types

import jax
import pytest
import torch

import chip_smoke
import diffsbdd_tpu.checkpoint as jax_checkpoint
import diffsbdd_tpu.chem.metrics as jax_metrics
import diffsbdd_tpu.chem.molecule as jax_mol
import diffsbdd_tpu_torch.cli.optimize as port_opt
import diffsbdd_tpu_torch.cli.serve as port_serve
import diffsbdd_tpu_torch.cli.test_set as port_test_set
from diffsbdd_tpu.cli.serve import SamplingServer as JaxServer
from diffsbdd_tpu.config import load_config as jax_load_config
from test_torch_sampling import fixture_config
from test_torch_workflows import T, RecordedNoise, jax_side, port_ckpt  # noqa: F401


if jax_mol.HAVE_RDKIT or jax_metrics.HAVE_RDKIT:
    pytest.skip("RDKit is installed: the JAX side would not take its no-RDKit "
                "branches", allow_module_level=True)


@pytest.fixture(scope="module")
def pocket(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "pocket.pdb"
    return path, chip_smoke.write_pocket_pdb(path, n_atoms=50, seed=11)


def jax_server(monkeypatch, noise):
    module, params, _ = jax_side(noise)
    cfg = jax_load_config(overrides=fixture_config(T))
    monkeypatch.setattr(jax_checkpoint, "load_model", lambda *a, **k: (
        module, types.SimpleNamespace(params=params), cfg))
    return JaxServer("ckpt")


def test_handler_replies_match_jax(monkeypatch, port_ckpt):  # noqa: F811
    jax_srv = jax_server(monkeypatch, RecordedNoise(0))
    port_srv = port_serve.SamplingServer(port_ckpt, device="cpu")
    port_srv.checkpoint = jax_srv.checkpoint
    assert port_srv.handle({"op": "ping"}) == jax_srv.handle({"op": "ping"}) == {"ok": True}
    want, got = jax_srv.handle({"op": "info", "id": 1}), port_srv.handle({"op": "info", "id": 1})
    assert got.keys() == want.keys()
    for k in ("ok", "id", "checkpoint", "dataset", "mode", "pocket_representation", "T",
              "requests", "molecules"):
        assert got[k] == want[k], k
    for req in ({"op": "nope", "id": "x"}, {"op": "generate", "id": 9},
                {"op": "warmup"}):
        assert port_srv.handle(req) == jax_srv.handle(req), req
    assert port_srv.handle({"op": "generate"})["error"] == "KeyError: 'pdbfile'"


def test_seeded_generate_matches_jax(monkeypatch, port_ckpt, pocket):  # noqa: F811
    path, ref = pocket
    req = {"op": "generate", "id": "r1", "pdbfile": str(path), "ref_ligand": ref,
           "n_samples": 3, "num_nodes_lig": 8, "timesteps": T, "seed": 5}
    noise = RecordedNoise(1)
    jax_srv = jax_server(monkeypatch, noise)
    with jax.disable_jit():
        want = jax_srv.handle(req)
    port_srv = port_serve.SamplingServer(port_ckpt, device="cpu")
    port_srv.module.ddpm.sample_gaussian = noise.port_draw
    got = port_srv.handle(req)
    assert not noise.arrays
    assert want["ok"] and got["ok"]
    assert got["n_molecules"] == want["n_molecules"] >= 1
    assert got["smiles"] == want["smiles"]
    assert got["n_atoms"] == want["n_atoms"]
    assert port_srv.handle({"op": "info"})["requests"] == 1


def test_warmup_leaves_the_streams_alone(port_ckpt, pocket, tmp_path):  # noqa: F811
    """An unseeded generate (sizes from the prior, noise from the server's
    generator) gives the same reply on a warmed and on a fresh server; two
    generates with the same seed and sizes give the same reply (a seed pins
    the noise, the sizes still come from the server's ``size_rng``)."""
    path, ref = pocket
    req = {"op": "generate", "pdbfile": str(path), "ref_ligand": ref, "n_samples": 2,
           "timesteps": T, "all_frags": True}
    warmed = port_serve.SamplingServer(port_ckpt, seed=3, device="cpu")
    rep = warmed.handle({**req, "op": "warmup", "outfile": str(tmp_path / "no.sdf")})
    assert rep["ok"] and rep["n_molecules"] == 2
    assert not (tmp_path / "no.sdf").exists()
    fresh = port_serve.SamplingServer(port_ckpt, seed=3, device="cpu")

    def molecules(reply):
        assert reply["ok"], reply
        return reply["smiles"], reply["n_atoms"]

    first = molecules(warmed.handle(req))
    assert first == molecules(fresh.handle(req))
    # the stream moved on: the next unseeded reply differs from the first
    assert molecules(fresh.handle(req)) != first
    seeded = {**req, "seed": 7, "num_nodes_lig": 9, "outfile": str(tmp_path / "a.sdf")}
    assert molecules(fresh.handle(seeded)) == molecules(warmed.handle(seeded))
    assert (tmp_path / "a.sdf").exists()


def test_jsonl_loop(port_ckpt):  # noqa: F811
    server = port_serve.SamplingServer(port_ckpt, device="cpu")
    lines = ['{"op": "ping", "id": 1}', "", "not json", "[1, 2]",
             '{"op": "shutdown"}', '{"op": "ping", "id": 2}']
    out = io.StringIO()
    server.serve_forever(io.StringIO("\n".join(lines) + "\n"), out)
    replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert len(replies) == 4
    assert replies[0] == {"ok": True, "id": 1}
    assert replies[1]["error"].startswith("bad request: ")
    assert replies[2] == {"error": "bad request: request must be a JSON object"}
    assert replies[3] == {"ok": True, "shutdown": True}


@pytest.mark.parametrize("main,argv", [
    (port_serve.main, ["ckpt"]),
    (port_test_set.main, ["ckpt", "--test_dir", "t", "--outdir", "o"]),
    (port_opt.main, ["ckpt", "--pdbfile", "p.pdb", "--ref_ligand", "l.sdf",
                     "--outfile", "o.sdf"]),
])
def test_entry_points_refuse_cpu_fallback(main, argv, tmp_path, monkeypatch):
    """Without a card and without --device cpu each entry point raises
    before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not any(tmp_path.iterdir())
