"""The port's sampling evaluation against the JAX package on the CPU: the
three chain samplers, ``SamplingEvaluator`` (metric dicts, xyz dumps, chain
frames), its rendering, and the trainer's schedule.

Both sides run a tiny model (hidden 16, 1 layer, T = 4) with the same
weights: a CA-pocket conditional model and a full-atom joint model over a
seeded synthetic dataset.  The JAX side runs eagerly (``jax.disable_jit``) and
draws noise of whatever shape it asks for from ``RecordedNoise``; the port
replays the arrays in order.  Tolerances: chain frames 1e-4 A with no atom-type
flip, metric dicts 1e-6 key by key, xyz files identical as text (a coordinate
at a rounding boundary of the 3-decimal format may differ in its last digit).
"""
import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.data.dataset import LigandPocketDataset as JaxDataset
from diffsbdd_tpu.train import evaluation as jax_eval
from diffsbdd_tpu.train import loop as jax_loop
from diffsbdd_tpu_torch.cli import train as train_cli
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset
from diffsbdd_tpu_torch.train import evaluation as port_eval
from diffsbdd_tpu_torch.train import loop as port_loop
from test_torch_train import both_modules, tiny_overrides
from test_torch_workflows import RecordedNoise

T = 4
FRAME_TOL = 1e-4  # A, float32 on both sides through one layer and T steps
METRIC_TOL = 1e-6


def _widen_pockets(npz, n_cols):
    """Widen the pocket one-hot of a synthetic split to ``n_cols`` types."""
    data = dict(np.load(npz))
    oh = data["pocket_one_hot"]
    data["pocket_one_hot"] = np.concatenate(
        [oh, np.zeros((len(oh), n_cols - oh.shape[1]), oh.dtype)], 1)
    np.savez(npz, **data)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two synthetic splits: 'ca' (10 ligand types, 20 residue types) and
    'full' (11 types both)."""
    root = tmp_path_factory.mktemp("evaldata")
    for name, n_types in (("ca", 10), ("full", 11)):
        chip_smoke.write_synthetic_dataset(root / name, 6, 4, seed=4, lig_sizes=(4, 8),
                                           pocket_sizes=(20, 28, 36), n_types=n_types)
    for split in ("train", "val"):
        _widen_pockets(root / "ca" / f"{split}.npz", 20)
    return root


MODELS = {
    "cond": dict(dataset="crossdock", pocket_representation="CA"),
    "simple": dict(dataset="crossdock", pocket_representation="CA",
                   mode="pocket_conditioning_simple"),
    "joint": dict(mode="joint"),
}


def models(data, kind):
    """(JAX module, params, port module) of a tiny model of ``kind``, with
    the size prior of its training split."""
    over = tiny_overrides(diffusion_params=dict(diffusion_steps=T), **MODELS[kind])
    sub = "full" if kind == "joint" else "ca"
    hist = np.load(data / sub / "size_distribution.npy")
    jm, params, pm = both_modules(over, hist=hist)
    return jm, params, pm.eval(), sub


def record(jm, pm, seed):
    noise = RecordedNoise(seed)
    jm.ddpm.sample_gaussian = noise.jax_draw
    pm.ddpm.sample_gaussian = noise.port_draw
    return noise


def assert_frames_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    dev = float(np.abs(got[..., :3] - want[..., :3]).max())
    flips = int((got[..., 3:].argmax(-1) != want[..., 3:].argmax(-1)).sum())
    print(f"frames {got.shape}: max coordinate deviation {dev:.2e} A, {flips} type flips")
    assert dev <= FRAME_TOL and flips == 0


def pocket_batch(sub_dir, pm, n):
    ds = LigandPocketDataset(sub_dir / "val.npz")
    ev = port_eval.SamplingEvaluator(pm, dataset=ds)
    _, pocket, _ = ev._val_pocket_batch(list(range(n)))
    return pocket


@pytest.mark.parametrize("kind,frames", [("cond", 2), ("simple", 4), ("joint", 2)])
def test_chain_samplers_match_jax(data, kind, frames):
    """One chain of a ligand of 6 atoms padded to 8 (and a pocket of 20 nodes
    padded to 64): the shapes the evaluator's chain has, so that the eager
    JAX side compiles its operations once for both tests."""
    jm, params, pm, sub = models(data, kind)
    noise = record(jm, pm, 1)
    m_l = torch.as_tensor(np.array([[1] * 6 + [0] * 2], np.float32))
    if kind == "joint":
        m_p = torch.as_tensor(np.array([[1] * 20 + [0] * 44], np.float32))
        with jax.disable_jit():
            want = jm.ddpm.sample_chain(params, jax.random.PRNGKey(0),
                                        (m_l.numpy(), m_p.numpy()), return_frames=frames)
        got = pm.ddpm.sample_chain(None, (m_l, m_p), return_frames=frames)
    else:
        pocket = pocket_batch(data / sub, pm, 1)
        jpocket = {k: v.numpy() for k, v in pocket.items()}
        with jax.disable_jit():
            want = jm.ddpm.sample_given_pocket_chain(
                params, jax.random.PRNGKey(0), jpocket, m_l.numpy(), return_frames=frames)
        got = pm.ddpm.sample_given_pocket_chain(None, pocket, m_l, return_frames=frames)
    assert not noise.arrays
    assert got[0].shape[:2] == (frames, 1)
    for g, w in zip(got, want):
        assert_frames_close(g, w)


def evaluators(data, kind, tmp_path):
    jm, params, pm, sub = models(data, kind)
    kw = dict(dataset_smiles=np.array(["a", "b"]), datadir=tmp_path / "nodata")
    jev = jax_eval.SamplingEvaluator(jm, dataset=JaxDataset(data / sub / "val.npz"),
                                     outdir=tmp_path / "jax", **kw)
    pev = port_eval.SamplingEvaluator(pm, dataset=LigandPocketDataset(data / sub / "val.npz"),
                                      outdir=tmp_path / "port", **kw)
    return jm, params, jev, pm, pev


@pytest.mark.parametrize("kind", ["cond", "joint"])
def test_sample_and_analyze_matches_jax(data, tmp_path, kind):
    """5 molecules in batches of 1 (one shape for the eager JAX side): the
    bounded batch loop, and the 4 validation pockets wrapping around."""
    jm, params, jev, pm, pev = evaluators(data, kind, tmp_path)
    noise = record(jm, pm, 2)
    with jax.disable_jit():
        want = jev.sample_and_analyze(params, jax.random.PRNGKey(0), 5, batch_size=1)
    got = pev.sample_and_analyze(None, 5, batch_size=1)
    assert not noise.arrays
    print(kind, got)
    assert list(got) == list(want)
    assert "smina_score" not in got  # no receptor files under datadir
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    if kind == "cond":
        assert got["kl_div_residue_types"] != -1.0


def assert_same_xyz(got: str, want: str):
    """xyz texts equal line by line; a coordinate may differ from JAX's text
    by one unit of its third decimal, and only where the two values (within
    FRAME_TOL of each other) straddle a rounding boundary of the format."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert got_lines[:2] == want_lines[:2] and len(got_lines) == len(want_lines)
    for a, b in zip(got_lines[2:], want_lines[2:]):
        if a == b:
            continue
        print(f"xyz rows differ in the last digit: {a!r} / {b!r}")
        (sa, *xa), (sb, *xb) = a.split(), b.split()
        assert sa == sb
        assert np.abs(np.array(xa, float) - np.array(xb, float)).max() <= 1e-3 + 1e-9


def _texts(root):
    return {p.relative_to(root).as_posix(): p.read_text()
            for p in sorted(root.rglob("*.txt"))}


@pytest.mark.parametrize("kind", ["cond", "joint"])
def test_xyz_dumps_and_renders_match_jax(data, tmp_path, kind):
    """``sample_and_save`` (1 sample) and ``sample_chain_and_save`` (T = 4,
    keep_frames 3 -> 2 frames): the same xyz files as JAX, as text; the
    port's renders: a PNG beside every xyz file and the chain's GIF."""
    jm, params, jev, pm, pev = evaluators(data, kind, tmp_path)
    noise = record(jm, pm, 3)
    with jax.disable_jit():
        jev.sample_and_save(params, jax.random.PRNGKey(0), 1, epoch=2)
        jev.sample_chain_and_save(params, jax.random.PRNGKey(1), 3, epoch=2)
    out = pev.sample_and_save(None, 1, epoch=2)
    gif = pev.sample_chain_and_save(None, 3, epoch=2)
    assert not noise.arrays
    got, want = _texts(tmp_path / "port"), _texts(tmp_path / "jax")
    assert sorted(got) == sorted(want) == [
        "epoch_2/chain/chain_0000_000.txt", "epoch_2/chain/chain_0001_000.txt",
        "epoch_2/molecule_000_000.txt"]
    for name in want:
        assert_same_xyz(got[name], want[name])
    pngs = sorted(p.name for p in (tmp_path / "port").rglob("*.png"))
    assert len(pngs) == 3 and out == tmp_path / "port" / "epoch_2"
    assert gif == str(tmp_path / "port" / "epoch_2" / "chain" / "output_chain.gif")
    assert (tmp_path / "port" / "epoch_2" / "chain" / "output_chain.gif").stat().st_size > 0
    # without rendering: the same files, no image
    pev.outdir = tmp_path / "bare"
    del pm.ddpm.sample_gaussian
    generator = torch.Generator().manual_seed(0)
    pev.sample_and_save(generator, 1, render=False)
    assert pev.sample_chain_and_save(generator, 3, render=False) is None
    assert not list((tmp_path / "bare").rglob("*.png"))
    assert len(list((tmp_path / "bare").rglob("*.txt"))) == 3


def test_residues_to_atoms_matches_jax():
    enc = {"N": 0, "C": 1, "O": 2}
    x = np.random.default_rng(0).standard_normal((2, 5, 3))
    np.testing.assert_array_equal(port_eval.residues_to_atoms(x, enc),
                                  jax_eval.residues_to_atoms(x, enc))
    assert port_eval.residues_to_atoms(x, enc).shape == (2, 5, 3)


class Spy:
    """An evaluator and a logger that record what the trainer asks of them."""

    def __init__(self):
        self.calls, self.logged = [], []

    def sample_and_analyze(self, *args, batch_size=None):
        self.calls.append(("analyze", args[-1], batch_size))
        return {"Validity": 0.5, "QED": -1.0}

    def sample_and_save(self, *args, epoch):
        self.calls.append(("save", args[-1], epoch))

    def sample_chain_and_save(self, *args, epoch):
        self.calls.append(("chain", args[-1], epoch))

    def log(self, metrics, step):
        self.logged.append(sorted(metrics.items()))


def test_trainer_runs_the_evaluator_on_jaxs_epochs(tmp_path):
    """Seven epochs without batches, metrics every 2, samples every 3, a
    chain every 4: the same calls, arguments and logged names as JAX's."""
    over = tiny_overrides(eval_epochs=2, visualize_sample_epoch=3,
                          visualize_chain_epoch=4, logdir=str(tmp_path),
                          eval_params=dict(n_eval_samples=7, eval_batch_size=3,
                                           n_visualize_samples=2, keep_frames=9))
    jm, params, pm = both_modules(over)
    spies = {"jax": Spy(), "port": Spy()}
    jtrainer = jax_loop.Trainer(jm, jax_load_config(overrides=over), [], None,
                                logger=spies["jax"], evaluator=spies["jax"])
    jtrainer.fit(jax_loop.create_train_state(params, lr=1e-3), jax.random.PRNGKey(0),
                 n_epochs=7)
    ptrainer = port_loop.Trainer(pm, load_config(overrides=over), [], None,
                                 logger=spies["port"], evaluator=spies["port"])
    ptrainer.fit(port_loop.create_train_state(pm, lr=1e-3), torch.Generator(), n_epochs=7)
    assert spies["port"].calls == spies["jax"].calls == [
        ("analyze", 7, 3), ("save", 2, 2), ("analyze", 7, 3), ("chain", 9, 3),
        ("analyze", 7, 3), ("save", 2, 5)]
    assert spies["port"].logged == spies["jax"].logged == \
        [[("QED/val", -1.0), ("Validity/val", 0.5)]] * 3


def test_cli_train_runs_the_evaluator(data, tmp_path, monkeypatch):
    """cli.train with eval_epochs 1 and the visualize epochs past the run:
    one epoch, then ``sample_and_analyze`` on the validation pockets through
    ``Trainer.fit``, its metrics logged under 'val'."""
    cfg = tiny_overrides(dataset="crossdock", pocket_representation="CA",
                         datadir=str(data / "ca"), logdir=str(tmp_path), batch_size=3,
                         n_epochs=1, eval_epochs=1, visualize_sample_epoch=2,
                         visualize_chain_epoch=2,
                         diffusion_params=dict(diffusion_steps=T),
                         eval_params=dict(n_eval_samples=2, eval_batch_size=2))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    logged = []
    monkeypatch.setattr(train_cli.WandbLogger, "log",
                        lambda self, metrics, step: logged.append(metrics))
    train_cli.main(["--config", str(path), "--device", "cpu"])
    evals = [m for m in logged if "Validity/val" in m]
    assert len(evals) == 1 and np.isfinite(list(evals[0].values())).all()
    assert not (tmp_path / "run" / "eval").exists()  # nothing rendered
