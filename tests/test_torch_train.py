"""The port's training slice against the JAX package on the CPU.

Both sides get the same numpy batches (the port's ``PaddedLoader`` over a
seeded synthetic dataset), the same weights (the committed fixture, hidden 64,
3 layers; or a JAX initialization of a tiny model mapped through
``convert/jax_params.py``) and the same random draws: the JAX side draws its
timesteps and noise from a PRNG key, the test replays that key and hands the
numbers to the port through ``sample_timesteps`` / ``sample_gaussian``.

Tolerances are stated where they are used; all of them are for float32 on
both sides with sums taken in another order.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.data import dataset as jax_data
from diffsbdd_tpu.diffusion import schedule as jax_sched
from diffsbdd_tpu.diffusion.size_prior import SizeDistribution as JaxSizes
from diffsbdd_tpu.train import augment as jax_augment
from diffsbdd_tpu.train import lj as jax_lj
from diffsbdd_tpu.train import loop as jax_loop
from diffsbdd_tpu.train.module import build_module_from_config as jax_build
from diffsbdd_tpu.utils.params_io import load_params_npz
from diffsbdd_tpu_torch.cli import generate_ligands as gen_cli
from diffsbdd_tpu_torch.cli import train as train_cli
from diffsbdd_tpu_torch.config import load_config, snapshot_config
from diffsbdd_tpu_torch.convert.jax_params import (optimizer_state_from_jax,
                                                   state_dict_from_jax)
from diffsbdd_tpu_torch.data import dataset as port_data
from diffsbdd_tpu_torch.diffusion import schedule as port_sched
from diffsbdd_tpu_torch.diffusion.size_prior import SizeDistribution
from diffsbdd_tpu_torch.train import augment as port_augment
from diffsbdd_tpu_torch.train import lj as port_lj
from diffsbdd_tpu_torch.train import loop as port_loop
from diffsbdd_tpu_torch.train.module import build_module_from_config
import test_torch_threads  # noqa: F401  (PyTorch threads a worker under xdist)

REPO = Path(__file__).resolve().parent.parent
FIXTURE_NPZ = REPO / "checkpoints" / "overfit_chem_fixture_best.npz"
B, T = 4, 20
HIST = np.ones((17, 65))
A = 11  # atom types of crossdock_full, ligand and full-atom pocket alike


# ---------------------------------------------------------------------------
# shared set-up
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    chip_smoke.write_synthetic_dataset(d, 8, 4, seed=3, lig_sizes=(5, 12),
                                       pocket_sizes=(20, 28, 36), n_types=A)
    return d


@pytest.fixture(scope="module")
def batches(datadir):
    """Two padded numpy batches of 4 complexes (ligand <= 16, pocket <= 64)."""
    ds = port_data.LigandPocketDataset(datadir / "train.npz")
    return list(port_data.PaddedLoader(ds, B, shuffle=False))


def fixture_overrides(**over):
    cfg = snapshot_config(FIXTURE_NPZ, {"diffusion_params": {"diffusion_steps": T},
                                        "tpu": {"egnn_impl": "auto"}})
    for k, v in over.items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    return cfg


def tiny_overrides(**over):
    cfg = fixture_overrides(egnn_params=dict(joint_nf=8, hidden_nf=16, n_layers=1))
    for k, v in over.items():
        cfg[k] = {**cfg.get(k, {}), **v} if isinstance(v, dict) else v
    return cfg


def both_modules(overrides, params=None, hist=HIST):
    """(JAX module, its params, the port's module with the same weights)."""
    jm = jax_build(jax_load_config(overrides=overrides), hist)
    if params is None:
        params = jax.tree_util.tree_map(
            np.asarray, jm.init_params(jax.random.PRNGKey(0), batch_size=2))
    pm = build_module_from_config(load_config(overrides=overrides), hist)
    pm.load_state_dict({k: torch.tensor(v) for k, v in
                        state_dict_from_jax(params).items()}, strict=True)
    return jm, params, pm


@pytest.fixture(scope="module")
def fixture_params():
    return load_params_npz(FIXTURE_NPZ)


def jnp_batch(part):
    return {k: jnp.asarray(v) for k, v in part.items()}


def torch_batch(part):
    return port_loop.batch_to_device(part, "cpu")


def jax_draws(rng, ligand, atom_nf, training, T=T):
    """The timesteps and the noise ``ConditionalDDPM.loss_terms`` draws from
    ``rng``: (t_int (B, 1), [eps] in training, [eps, eps_0] in evaluation)."""
    k_t, k_noise, k_noise0 = jax.random.split(rng, 3)
    n, nl = ligand["x"].shape[:2]
    t_int = jax.random.randint(k_t, (n, 1), 0 if training else 1, T + 1)
    keys = [k_noise] if training else [k_noise, k_noise0]
    return (np.asarray(t_int, np.float32),
            [np.asarray(jax.random.normal(k, (n, nl, 3 + atom_nf))) for k in keys])


def feed(module, t_ints, noises):
    """Hand the port's DDPM recorded timesteps and noise, in drawing order."""
    tq, nq = list(t_ints), list(noises)
    module.ddpm.sample_timesteps = lambda g, n, lowest: torch.as_tensor(tq.pop(0))
    module.ddpm.sample_gaussian = lambda g, shape, mask: \
        torch.tensor(nq.pop(0)) * mask[..., None]
    return tq, nq


def assert_tree_close(got, want, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)


# ---------------------------------------------------------------------------
# (b) loss_terms and loss_fn, term by term
# ---------------------------------------------------------------------------

# three layers of float32 sums in another order: 1e-4 on O(1..100) terms
LOSS_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("training", [True, False])
def test_loss_terms_match_jax(fixture_params, batches, training):
    jm, params, pm = both_modules(fixture_overrides(), fixture_params)
    lig, pkt = batches[0]["ligand"], batches[0]["pocket"]
    rng = jax.random.PRNGKey(7)
    want = jm.ddpm.loss_terms(params, rng, jnp_batch(lig), jnp_batch(pkt), training)
    t_int, noise = jax_draws(rng, lig, A, training)
    tq, nq = feed(pm, [t_int], noise)
    with torch.no_grad():
        got = pm.ddpm.loss_terms(None, torch_batch(lig), torch_batch(pkt), training)
    assert not tq and not nq
    assert_tree_close(got.pop("info"), want.pop("info"), **LOSS_TOL)
    assert_tree_close(got, want, **LOSS_TOL)


@pytest.mark.parametrize("loss_type,training", [("l2", True), ("vlb", True),
                                                ("l2", False)])
def test_loss_fn_matches_jax(fixture_params, batches, loss_type, training):
    over = fixture_overrides(diffusion_params=dict(diffusion_loss_type=loss_type))
    jm, params, pm = both_modules(over, fixture_params)
    lig, pkt = batches[1]["ligand"], batches[1]["pocket"]
    rng = jax.random.PRNGKey(8)
    want_loss, want = jm.loss_fn(params, rng, jnp_batch(lig), jnp_batch(pkt), training)
    t_int, noise = jax_draws(rng, lig, A, training)
    feed(pm, [t_int], noise)
    with torch.no_grad():
        got_loss, got = pm.loss_fn(None, torch_batch(lig), torch_batch(pkt), training)
    assert_tree_close(got, want, **LOSS_TOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **LOSS_TOL)


def test_loss_fn_virtual_nodes_lj_and_learned_schedule(datadir):
    """The options the flagship preset leaves off, on a freshly initialized
    tiny model: virtual nodes (masked coordinates, ``num_virtual_atoms``)
    with the auxiliary LJ term under l2, and the learned schedule under vlb."""
    hist = np.ones((13, 65))
    # the learned gamma(t) sums 1024 hidden units and is normalized by
    # gamma~(1) - gamma~(0), which amplifies float32 rounding to ~1e-3 in
    # gamma_s - gamma_t and so in every term weighted by it
    learned_tol = dict(atol=3e-3, rtol=3e-3)
    for over, tol in (
            (tiny_overrides(virtual_nodes=True, auxiliary_loss=True,
                            loss_params=dict(max_weight=0.5, schedule="linear",
                                             clamp_lj=3.0)), LOSS_TOL),
            (tiny_overrides(virtual_nodes=True, diffusion_params=dict(
                diffusion_loss_type="vlb", diffusion_noise_schedule="learned")),
             learned_tol)):
        jm, params, pm = both_modules(over, hist=hist)
        transform = port_data.AppendVirtualNodes(12, pm.lig_type_encoder, "Ne",
                                                 rng=np.random.default_rng(0))
        ds = port_data.LigandPocketDataset(datadir / "train.npz", transform=transform)
        batch = next(iter(port_data.PaddedLoader(ds, B, shuffle=False)))
        lig, pkt = batch["ligand"], batch["pocket"]
        assert lig["num_virtual_atoms"].sum() > 0 and lig["one_hot"].shape[-1] == A + 1
        rng = jax.random.PRNGKey(9)
        want_loss, want = jm.loss_fn(params, rng, jnp_batch(lig), jnp_batch(pkt), True)
        t_int, noise = jax_draws(rng, lig, A + 1, True)
        feed(pm, [t_int], noise)
        with torch.no_grad():
            got_loss, got = pm.loss_fn(None, torch_batch(lig), torch_batch(pkt), True)
        assert_tree_close(got, want, **tol)
        np.testing.assert_allclose(float(got_loss), float(want_loss), **tol)


# ---------------------------------------------------------------------------
# (c) the gradient of loss_fn, parameter by parameter
# ---------------------------------------------------------------------------

def test_loss_gradients_match_jax(fixture_params, batches):
    jm, params, pm = both_modules(fixture_overrides(), fixture_params)
    lig, pkt = batches[0]["ligand"], batches[0]["pocket"]
    rng = jax.random.PRNGKey(10)
    grads = jax.jit(jax.grad(lambda p: jm.loss_fn(
        p, rng, jnp_batch(lig), jnp_batch(pkt), True)[0]))(params)
    want = state_dict_from_jax(grads)
    t_int, noise = jax_draws(rng, lig, A, True)
    feed(pm, [t_int], noise)
    loss, _ = pm.loss_fn(None, torch_batch(lig), torch_batch(pkt), True)
    names, tensors = zip(*pm.named_parameters())
    got = torch.autograd.grad(loss, tensors, allow_unused=True)
    reached = 0
    for name, g in zip(names, got):
        if g is None:  # the pocket decoder: the conditional loss never reads it
            assert not want[name].any(), name
            continue
        reached += 1
        # 1e-3 of the gradient's largest entry: float32 through three layers
        # forward and backward, sums in another order
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-3 * scale + 1e-7,
                                   rtol=0, err_msg=name)
    assert reached > 50


# ---------------------------------------------------------------------------
# (d) optimizer and gradient-norm history
# ---------------------------------------------------------------------------

def test_optimizer_matches_optax_chain():
    """Seven steps of numpy gradients through ``AmsgradW`` and through
    ``jax_loop.make_optimizer`` (optax's amsgrad, decayed weights, -lr):
    parameters within 1e-6, the moments after the last step too."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    opt = jax_loop.make_optimizer(1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jp)
    params = [torch.tensor(v) for v in p0.values()]
    port = port_loop.AmsgradW(params, 1e-3)
    for step in range(7):
        # gradients that shrink and flip, so that the running maximum matters
        g = {k: (rng.standard_normal(s) * 10.0 ** -(step % 3)).astype(np.float32)
             for k, s in shapes.items()}
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        port.step([torch.tensor(v) for v in g.values()])
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0,
                                       err_msg=f"{k} at step {step}")
    ams = jstate[0]
    assert port.count == int(ams.count) == 7
    for name in ("mu", "nu", "nu_max"):
        for mine, k in zip(getattr(port, name), shapes):
            np.testing.assert_allclose(mine.numpy(), np.asarray(getattr(ams, name)[k]),
                                       atol=1e-6, rtol=1e-5, err_msg=name)


def test_optimizer_differs_from_torch_adamw():
    """The reason for the port's own optimizer: after a large first gradient
    ``torch.optim.AdamW(amsgrad=True)`` takes another second step."""
    grads = [np.array([10.0], np.float32), np.array([0.1], np.float32)]
    p = [torch.zeros(1)]
    mine = port_loop.AmsgradW(p, 1e-3)
    q = torch.nn.Parameter(torch.zeros(1))
    theirs = torch.optim.AdamW([q], lr=1e-3, amsgrad=True, weight_decay=1e-12)
    for g in grads:
        mine.step([torch.tensor(g)])
        q.grad = torch.tensor(g)
        theirs.step()
    assert abs(float(p[0]) - float(q.detach())) > 1e-4


def test_grad_norm_queue_matches_jax():
    rng = np.random.default_rng(1)
    jq, pq = jax_loop.GradNormQueue.create(), port_loop.GradNormQueue()
    for i in range(2 * port_loop.QUEUE_LEN + 5):
        for got, want in zip(pq.stats(), jq.stats()):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        v = float(rng.uniform(0.5, 30.0))
        jq, _ = jq.push(v), pq.push(torch.tensor(v))
    state = pq.state_dict()
    fresh = port_loop.GradNormQueue()
    fresh.load_state_dict(state)
    assert torch.equal(fresh.values, pq.values) and (fresh.count, fresh.ptr) == (pq.count, pq.ptr)


# ---------------------------------------------------------------------------
# (e) whole train steps
# ---------------------------------------------------------------------------

def test_three_train_steps_match_jax(fixture_params, batches):
    """Three optimizer steps on the fixture weights with adaptive clipping:
    loss and gradient norm at every step, every parameter and the optimizer's
    moments at the end."""
    jm, params, pm = both_modules(fixture_overrides(), fixture_params)
    jstep = jax_loop.make_train_step(jm, lr=1e-3, clip_grad=True)
    jstate = jax_loop.create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                         lr=1e-3)
    state = port_loop.create_train_state(pm, lr=1e-3)
    pstep = port_loop.make_train_step(state, clip_grad=True)
    for i in range(3):
        lig, pkt = batches[i % 2]["ligand"], batches[i % 2]["pocket"]
        rng = jax.random.PRNGKey(20 + i)
        jstate, want = jstep(jstate, rng, jnp_batch(lig), jnp_batch(pkt))
        t_int, noise = jax_draws(rng, lig, A, True)
        feed(pm, [t_int], noise)
        got = pstep(None, torch_batch(lig), torch_batch(pkt))
        for k in ("loss", "grad_norm", "max_grad_norm", "error_t_lig"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3,
                                       err_msg=f"{k} at step {i}")
    assert state.step == int(jstate.step) == 3
    # A step moves an entry by about lr * g / (|g| + 1e-8): where |g| is at
    # float32 rounding level, the two sides' gradients differ by a fraction of
    # themselves and the entries by a fraction of lr.  3 steps of lr = 1e-3
    # bound the difference by 3e-3; the entries agree to 2e-4.
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    names = [n for n, _ in pm.named_parameters()]
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[n], atol=2e-4, rtol=0,
                                   err_msg=n)
    # the moments, mapped through the same names, on the entries that carry
    # the state: first moments within 1e-3 of their largest entry
    want_opt = optimizer_state_from_jax(jstate.opt_state[0], names)
    assert want_opt["count"] == state.optimizer.count == 3
    for mine, theirs, n in zip(state.optimizer.mu, want_opt["mu"], names):
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=1e-3 * np.abs(theirs).max() + 1e-9, err_msg=n)
    np.testing.assert_allclose(state.queue.values.numpy(),
                               np.asarray(jstate.queue.values), rtol=1e-3)


def test_gradient_accumulation_matches_jax(batches):
    """accumulate_grad_batches = 2 on a tiny model: JAX splits the step key
    per micro-batch, the port draws per micro-batch in the same order."""
    jm, params, pm = both_modules(tiny_overrides())
    jstep = jax_loop.make_train_step(jm, lr=1e-3, clip_grad=True,
                                     accumulate_grad_batches=2)
    jstate = jax_loop.create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                         lr=1e-3)
    lig, pkt = batches[0]["ligand"], batches[0]["pocket"]
    rng = jax.random.PRNGKey(30)
    jstate, want = jstep(jstate, rng, jnp_batch(lig), jnp_batch(pkt))
    t_ints, noises = [], []
    for i, key in enumerate(jax.random.split(rng, 2)):
        half = {k: v[2 * i:2 * i + 2] for k, v in lig.items()}
        t_int, noise = jax_draws(key, half, A, True)
        t_ints.append(t_int), noises.extend(noise)
    state = port_loop.create_train_state(pm, lr=1e-3)
    feed(pm, t_ints, noises)
    got = port_loop.make_train_step(state, accumulate_grad_batches=2)(
        None, torch_batch(lig), torch_batch(pkt))
    for k in ("loss", "grad_norm", "kl_prior"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, err_msg=k)
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for n, p in pm.named_parameters():  # one step of lr 1e-3, see above
        np.testing.assert_allclose(p.detach().numpy(), want_sd[n], atol=1e-4, rtol=0,
                                   err_msg=n)
    with pytest.raises(ValueError, match="must divide"):
        port_loop.make_train_step(state, accumulate_grad_batches=3)(
            None, torch_batch(lig), torch_batch(pkt))


def test_zero_nan_guard_in_training(batches):
    """A NaN velocity is zeroed on the training path and kept elsewhere."""
    _, _, pm = both_modules(tiny_overrides())
    lig, pkt = torch_batch(batches[0]["ligand"]), torch_batch(batches[0]["pocket"])
    xh_l = torch.cat([lig["x"], lig["one_hot"]], -1)
    xh_p = torch.cat([pkt["x"], pkt["one_hot"]], -1)
    xh_l[0, 0, 0] = float("nan")
    t = torch.full((B, 1), 0.5)
    with torch.no_grad():
        kept, _ = pm.ddpm.dynamics(xh_l, xh_p, t, lig["mask"], pkt["mask"])
        zeroed, _ = pm.ddpm.dynamics(xh_l, xh_p, t, lig["mask"], pkt["mask"],
                                     zero_nan=True)
    assert torch.isnan(kept[0, :, :3]).any()
    assert torch.isfinite(zeroed[..., :3]).all()


# ---------------------------------------------------------------------------
# (f) checkpoints, the trainer and the CLIs
# ---------------------------------------------------------------------------

def tiny_train_config(datadir, logdir, **over):
    cfg = tiny_overrides(**{**dict(run_name="tiny", logdir=str(logdir),
                                   datadir=str(datadir), batch_size=B, n_epochs=1,
                                   lr=1e-3, seed=1), **over})
    cfg.pop("tpu")
    return cfg


def test_checkpoint_resume_gives_the_same_next_step(tmp_path, batches):
    _, _, pm = both_modules(tiny_overrides())
    cfg = load_config(overrides=tiny_train_config(tmp_path, tmp_path))
    state = port_loop.create_train_state(pm, lr=1e-3)
    step = port_loop.make_train_step(state)
    draw = lambda seed: torch.Generator().manual_seed(seed)
    batch = lambda i: (torch_batch(batches[i]["ligand"]), torch_batch(batches[i]["pocket"]))
    step(draw(0), *batch(0))
    step(draw(1), *batch(1))
    from diffsbdd_tpu_torch.checkpoint import load_model, save_model
    save_model(tmp_path / "ckpt", pm, cfg, name="last", state=state)

    fresh = build_module_from_config(cfg, HIST)
    restored, saved_cfg = port_loop.restore_checkpoint(
        tmp_path / "ckpt", port_loop.create_train_state(fresh, lr=1e-3))
    assert restored.step == 2 and restored.optimizer.count == 2
    assert saved_cfg["node_histogram"] == HIST.tolist()
    a = step(draw(2), *batch(0))
    b = port_loop.make_train_step(restored)(draw(2), *batch(0))
    assert float(a["loss"]) == float(b["loss"])
    for p, q in zip(pm.parameters(), fresh.parameters()):
        assert torch.equal(p, q)
    # the same files serve sampling: load_model reads the weights and the prior
    module, _ = load_model(tmp_path / "ckpt", name="last", device="cpu")
    assert module.ddpm.size_distribution is not None


class ListLogger:
    def __init__(self):
        self.rows = []

    def log(self, metrics, step):
        self.rows.append((step, metrics))


def test_trainer_fits_checkpoints_and_logs(tmp_path, datadir):
    cfg = load_config(overrides=tiny_train_config(datadir, tmp_path, n_epochs=2))
    module = build_module_from_config(cfg, port_data.load_size_histogram(datadir))
    ds = port_data.LigandPocketDataset(datadir / "train.npz")
    val = port_data.LigandPocketDataset(datadir / "val.npz")
    logger = ListLogger()
    trainer = port_loop.Trainer(
        module, cfg, port_data.PaddedLoader(ds, B, rng=np.random.default_rng(0)),
        port_data.PaddedLoader(val, B, shuffle=False), logger=logger)
    before = [p.detach().clone() for p in module.parameters()]
    state = trainer.fit(port_loop.create_train_state(module, cfg.lr),
                        torch.Generator().manual_seed(0), n_epochs=2)
    assert state.step == 4
    train_rows = [m for _, m in logger.rows if "loss/train" in m]
    val_rows = [m for _, m in logger.rows if "loss/val" in m]
    assert len(train_rows) == 4 and len(val_rows) == 2
    assert all(np.isfinite(m["loss/train"]) and np.isfinite(m["grad_norm/train"])
               for m in train_rows)
    assert any(not torch.equal(p, q) for p, q in zip(module.parameters(), before))
    ckpt = tmp_path / "tiny" / "checkpoints"
    for name in ("last", "best"):
        assert (ckpt / f"{name}.pt").exists() and (ckpt / f"{name}.train.pt").exists()


def test_train_cli_then_sampling_with_the_checkpoints_own_size_prior(tmp_path, datadir):
    """cli.train, cli.train --resume, then cli.generate_ligands on the trained
    checkpoint without --num_nodes_lig."""
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(tiny_train_config(datadir, tmp_path / "runs")))
    train_cli.main(["--config", str(cfg_path), "--device", "cpu"])
    ckpt = tmp_path / "runs" / "tiny" / "checkpoints"
    train_cli.main(["--config", str(cfg_path), "--device", "cpu", "--resume", str(ckpt)])
    state = torch.load(ckpt / "last.train.pt", weights_only=True)
    assert state["step"] == 4  # 2 steps, then 2 more after resuming
    pdb = tmp_path / "pocket.pdb"
    ref = chip_smoke.write_pocket_pdb(pdb, n_atoms=28, seed=1)
    sdf = tmp_path / "out.sdf"
    gen_cli.main([str(ckpt), "--pdbfile", str(pdb), "--ref_ligand", ref, "--outfile",
                  str(sdf), "--n_samples", "3", "--all_frags", "--timesteps", "4",
                  "--device", "cpu"])
    assert len(sdf.read_text().split("$$$$")) - 1 == 3


def test_trainer_runs_on_the_card_unless_told_otherwise(tmp_path, datadir):
    """Without a card the CLI raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(tiny_train_config(datadir, tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--config", str(cfg_path)])


# ---------------------------------------------------------------------------
# (g) the small modules
# ---------------------------------------------------------------------------

def test_lj_potential_and_weight_schedule_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 9, 3)) * 1.5).astype(np.float32)
    one_hot = np.eye(A)[rng.integers(0, A, (3, 9))].astype(np.float32)
    mask = (rng.uniform(size=(3, 9)) > 0.2).astype(np.float32)
    from diffsbdd_tpu.constants import dataset_params as jax_info
    from diffsbdd_tpu_torch.constants import dataset_params as port_info
    rm = port_info["crossdock_full"]["lennard_jones_rm"]
    np.testing.assert_array_equal(rm, jax_info["crossdock_full"]["lennard_jones_rm"])
    for clamp in (None, 3.0):
        want = jax_lj.lj_potential(jnp.asarray(x), jnp.asarray(one_hot), jnp.asarray(mask),
                                   rm, 1.0, clamp=clamp)
        got = port_lj.lj_potential(torch.tensor(x), torch.tensor(one_hot),
                                   torch.tensor(mask), rm, 1.0, clamp=clamp)
        # r^-12 terms reach 1e6 when unclamped: relative tolerance only
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    t = np.array([0, 3, 10])
    for mode in ("linear", "constant"):
        np.testing.assert_allclose(
            port_lj.WeightSchedule(10, 0.5, mode)(torch.tensor(t)).numpy(),
            np.asarray(jax_lj.WeightSchedule(10, 0.5, mode)(t)), rtol=1e-6)


def test_augment_batch_matches_jax(batches):
    lig, pkt = batches[0]["ligand"], batches[0]["pocket"]
    key = jax.random.PRNGKey(3)
    want_l, want_p = jax_augment.augment_batch(key, jnp_batch(lig), jnp_batch(pkt),
                                               augment_noise=0.1, augment_rotation=True)
    k_rot, k_noise = jax.random.split(key)
    k1, k2 = jax.random.split(k_noise)
    draws = [np.asarray(jax.random.normal(k_rot, (B, 4))),
             np.asarray(jax.random.normal(k1, lig["x"].shape)),
             np.asarray(jax.random.normal(k2, pkt["x"].shape))]
    got_l, got_p = port_augment.augment_batch(
        None, torch_batch(lig), torch_batch(pkt), 0.1, True,
        draw=lambda g, shape, dev: torch.tensor(draws.pop(0)))
    np.testing.assert_allclose(got_l["x"].numpy(), np.asarray(want_l["x"]), atol=1e-5)
    np.testing.assert_allclose(got_p["x"].numpy(), np.asarray(want_p["x"]), atol=1e-5)
    rot = port_augment.rotation_matrices(torch.randn(5, 4))
    torch.testing.assert_close(rot @ rot.transpose(1, 2), torch.eye(3).expand(5, 3, 3),
                               atol=1e-5, rtol=0)


def test_size_prior_log_probs_match_jax():
    hist = np.random.default_rng(4).integers(0, 5, (13, 30)).astype(float)
    want, got = JaxSizes(hist), SizeDistribution(hist)
    n1, n2 = np.array([0, 3, 12, 7]), np.array([29, 0, 11, 11])
    np.testing.assert_allclose(
        got.log_prob_n1_given_n2(torch.tensor(n1), torch.tensor(n2)).numpy(),
        np.asarray(want.log_prob_n1_given_n2(n1, n2)), rtol=1e-6)
    np.testing.assert_allclose(got.log_prob(torch.tensor(n1), torch.tensor(n2)).numpy(),
                               np.asarray(want.log_prob(n1, n2)), rtol=1e-6)


def test_schedules_match_jax():
    for name in ("cosine", "polynomial_2"):
        np.testing.assert_array_equal(port_sched.gamma_table(name, 50, 1e-4),
                                      jax_sched.gamma_table(name, 50, 1e-4))
    x = np.linspace(-4, 4, 9).astype(np.float32)
    np.testing.assert_allclose(port_sched.cdf_standard_gaussian(torch.tensor(x)).numpy(),
                               np.asarray(jax_sched.cdf_standard_gaussian(jnp.asarray(x))),
                               atol=1e-7)
    with pytest.raises(ValueError):
        port_sched.gamma_table("linear", 10, 1e-4)


def test_gamma_network_matches_jax():
    net = jax_sched.GammaNetwork()
    t = np.linspace(0, 1, 7, dtype=np.float32)[:, None]
    params = net.init(jax.random.PRNGKey(5), jnp.asarray(t))
    want = net.apply(params, jnp.asarray(t))
    sd = state_dict_from_jax({"gamma": jax.tree_util.tree_map(np.asarray, params)})
    port = port_sched.GammaNetwork()
    port.load_state_dict({k.removeprefix("ddpm.gamma_net."): torch.tensor(v)
                          for k, v in sd.items()}, strict=True)
    got = port(torch.tensor(t))
    # gamma~ sums 1024 hidden units (~60) and is normalized by gamma~(1) -
    # gamma~(0) (~0.1 at initialization) onto [-5, 10]: float32 rounding of
    # the sum comes out at ~1e-4 in gamma
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-3)
    assert (got[1:] >= got[:-1]).all()  # monotone in t


# ---------------------------------------------------------------------------
# (h) the data pipeline
# ---------------------------------------------------------------------------

def _assert_batches_equal(got, want):
    for part in ("ligand", "pocket"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            np.testing.assert_array_equal(got[part][k], want[part][k], err_msg=k)
    assert list(got["names"]) == list(want["names"])


@pytest.mark.parametrize("fixed_shape", [True, False])
def test_padded_loader_matches_jax(datadir, fixed_shape):
    kw = dict(lig_bucket=4, pocket_bucket=8, shuffle=True, fixed_shape=fixed_shape)
    want = list(jax_data.PaddedLoader(jax_data.LigandPocketDataset(datadir / "train.npz"),
                                      3, rng=np.random.default_rng(6), **kw))
    loader = port_data.PaddedLoader(port_data.LigandPocketDataset(datadir / "train.npz"),
                                    3, rng=np.random.default_rng(6), **kw)
    got = list(loader)
    assert len(got) == len(want) == len(loader) == 3  # 8 complexes, last batch filled
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    np.testing.assert_array_equal(port_data.load_size_histogram(datadir),
                                  jax_data.load_size_histogram(datadir))


def test_virtual_nodes_transform_matches_jax(datadir):
    enc = {**{str(i): i for i in range(A)}, "Ne": A}
    items = []
    for mod in (port_data, jax_data):
        tr = mod.AppendVirtualNodes(14, enc, "Ne", rng=np.random.default_rng(7))
        ds = mod.LigandPocketDataset(datadir / "val.npz", transform=tr)
        items.append(mod.pad_batch([ds[i] for i in range(len(ds))], 16, 40))
    _assert_batches_equal(*items)
    assert items[0]["ligand"]["num_virtual_atoms"].min() >= 2
