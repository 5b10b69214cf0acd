"""The model variants that run on the dense path, against the JAX package's
XLA path on the CPU: the sinusoidal distance embedding, mean aggregation and
``gnn_dynamics``; ``nan_check``; their checkpoints through the converters.

JAX's ``EGNNDynamics._resolve_impl`` takes its XLA path (no Pallas kernel)
for exactly these variants, so the JAX side runs ``impl="xla"`` here.  Sizes
are tiny (hidden 16, 2 layers, T = 5).  Tolerances: float32 on both sides
with sums taken in another order: eps atol 1e-4 + rtol 1e-4; parameter
gradients of sum(eps^2) atol 5e-4 + rtol 5e-3; ``loss_terms`` within
``LOSS_TOL``; a chain within 1e-4 A with 0 atom-type flips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu.convert.torch_ckpt import convert_state_dict, export_state_dict
from diffsbdd_tpu.diffusion.ddpm import ConditionalDDPM as JaxConditionalDDPM
from diffsbdd_tpu.models.dynamics import EGNNDynamics as JaxDynamics
from diffsbdd_tpu.models.dynamics import build_adjacency as jax_build_adjacency
from diffsbdd_tpu.models.egnn import sinusoidal_distance_embedding as jax_sin
from diffsbdd_tpu.train.module import build_module_from_config as jax_build
from diffsbdd_tpu_torch.chem import pdb as port_pdb
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_jax
from diffsbdd_tpu_torch.convert.torch_ckpt import state_dict_from_lightning
from diffsbdd_tpu_torch.models import egnn as port_egnn
from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics, build_adjacency
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
from diffsbdd_tpu_torch.train.module import build_module_from_config
from reference_bridge import make_queued_ddpm
from test_torch_sampling import deviation
from test_torch_train import (LOSS_TOL, A, assert_tree_close, batches,  # noqa: F401
                              both_modules, datadir, feed, jax_draws, jnp_batch,
                              tiny_overrides, torch_batch)

VALUE_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)
PREFIX = "ddpm.dynamics."
KWARGS = dict(atom_nf=5, residue_nf=7, joint_nf=8, hidden_nf=16, n_layers=2,
              attention=True, tanh=True, norm_constant=1.0, inv_sublayers=1,
              reflection_equivariant=False, edge_embedding_dim=4,
              edge_cutoff_ligand=None, edge_cutoff_pocket=3.0,
              edge_cutoff_interaction=2.5)
VARIANTS = {"sin_sum": dict(sin_embedding=True),
            "nosin_mean": dict(aggregation_method="mean"),
            "sin_mean": dict(sin_embedding=True, aggregation_method="mean"),
            "gnn": dict(mode="gnn_dynamics")}
MODES = {"conditional": False, "joint": True}  # update_pocket_coords


def inputs(seed, B=2, NL=7, NP=22, atom_nf=5, residue_nf=7):
    """A padded batch with padding on both node axes."""
    rng = np.random.default_rng(seed)
    m_l = (rng.uniform(size=(B, NL)) > 0.2).astype(np.float32)
    m_p = (rng.uniform(size=(B, NP)) > 0.2).astype(np.float32)
    m_l[:, 0] = m_p[:, 0] = 1.0
    xh_l = np.concatenate([rng.standard_normal((B, NL, 3)),
                           np.eye(atom_nf)[rng.integers(0, atom_nf, (B, NL))]], -1)
    xh_p = np.concatenate([rng.standard_normal((B, NP, 3)) * 1.5,
                           np.eye(residue_nf)[rng.integers(0, residue_nf, (B, NP))]], -1)
    t = np.full((B, 1), 0.4)
    return [np.ascontiguousarray(a * (m[..., None] if a.ndim == 3 else 1), np.float32)
            for a, m in ((xh_l, m_l), (xh_p, m_p), (t, None), (m_l, None), (m_p, None))]


def scaled(variables, seed):
    """Every weight redrawn at fan-in scale (biases and the edge-type table
    at 0.3), the coordinate head at a twentieth of it: JAX's initial head
    (gain 1e-3) would leave the coordinates, and so the distance features of
    the second block, nearly untouched, and a head at full scale moves atoms
    by up to ``coords_range`` (15 A) under mean aggregation, where float32
    rounding through the highest sinusoid (429 rad/A) takes both packages
    ~1e-3 from a float64 run of either."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        scale = leaf.shape[0] ** -0.5 if leaf.ndim == 2 else 0.3
        if "coord_mlp/lin2" in jax.tree_util.keystr(path, simple=True, separator="/"):
            scale *= 0.05
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, variables)


def case(variant, joint, seed=0):
    """(JAX module, its variables, the port's model with the same weights,
    the inputs)."""
    kw = dict(KWARGS, **VARIANTS[variant], update_pocket_coords=joint)
    batch = inputs(seed)
    jdyn = JaxDynamics(**kw, impl="xla")
    variables = scaled(jdyn.init(jax.random.PRNGKey(seed), *map(jnp.asarray, batch)), seed)
    model = EGNNDynamics(**kw, kernel_block_fuse=False)
    state = state_dict_from_jax({"dynamics": variables})
    model.load_state_dict({k[len(PREFIX):]: torch.tensor(v) for k, v in state.items()},
                          strict=True)
    return jdyn, variables, model, batch


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_dynamics_matches_jax(variant, mode):
    jdyn, variables, model, batch = case(variant, MODES[mode])
    assert model.dense
    want = jax.jit(jdyn.apply)(variables, *map(jnp.asarray, batch))
    with torch.no_grad():
        got = model(*map(torch.as_tensor, batch))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VALUE_TOL)
        assert float(np.abs(np.asarray(w)).max()) > 1e-2  # not a trivial zero


@pytest.mark.parametrize("variant", VARIANTS)
def test_gradients_match_jax(variant):
    """The gradients of sum(eps^2) by parameter (the joint model: the
    pocket moves, every coordinate carries gradient from block to block,
    through the detached sinusoidal features too)."""
    jdyn, variables, model, batch = case(variant, True, seed=1)

    def loss(v):
        return sum(jnp.sum(e ** 2) for e in jdyn.apply(v, *map(jnp.asarray, batch)))
    want = state_dict_from_jax({"dynamics": jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(variables))})
    out = model(*map(torch.as_tensor, batch))
    sum((o ** 2).sum() for o in out).backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[PREFIX + name], **GRAD_TOL,
                                   err_msg=name)


def test_sinusoidal_embedding_and_adjacency_match_jax():
    rng = np.random.default_rng(4)
    radial = (rng.uniform(0, 30, (2, 5, 5, 1))).astype(np.float32)
    got = port_egnn.sinusoidal_distance_embedding(torch.tensor(radial, requires_grad=True))
    assert not got.requires_grad  # detached, as JAX's stop_gradient
    assert got.shape[-1] == port_egnn.sin_embedding_dim() == 2 * port_egnn.n_sin_frequencies()
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_sin(jnp.asarray(radial))),
                               atol=1e-5, rtol=1e-5)
    xh_l, xh_p, _, m_l, m_p = inputs(5)
    cut = (None, 3.0, 2.5)
    want = jax_build_adjacency(jnp.asarray(xh_l[..., :3]), jnp.asarray(xh_p[..., :3]),
                               jnp.asarray(m_l), jnp.asarray(m_p), *cut)
    got = build_adjacency(*(torch.tensor(a) for a in (xh_l[..., :3], xh_p[..., :3],
                                                       m_l, m_p)), *cut)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _count_kernel_calls(monkeypatch):
    calls = {}
    for name in ("gcl_message_agg", "coord_update_agg", "block_fused"):
        fn = getattr(ec, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ec, name, spy)
    return calls


@pytest.mark.parametrize("variant", list(VARIANTS) + ["nosin_sum"])
def test_only_the_sum_nosin_model_calls_the_kernels(monkeypatch, variant):
    """The dense variants call no kernel wrapper; the sum, no-sin model
    (the kernels' model) calls them, block fusing on or off."""
    kw = dict(KWARGS, **VARIANTS.get(variant, {}), kernel_block_fuse=True,
              update_pocket_coords=False)
    model = EGNNDynamics(**kw)
    calls = _count_kernel_calls(monkeypatch)
    with torch.no_grad():
        model(*map(torch.as_tensor, inputs(6)))
        model(*map(torch.as_tensor, inputs(6)), block_fuse=True)
    if variant == "nosin_sum":
        assert not model.dense
        assert calls == {"gcl_message_agg": 2, "coord_update_agg": 2, "block_fused": 2}
    else:
        assert model.dense and calls == {}


def test_nan_check_raises_on_nan():
    _, _, model, batch = case("sin_mean", False)
    batch[0][0, 0, 0] = np.nan
    xs = list(map(torch.as_tensor, batch))
    with torch.no_grad():
        model(*xs)  # off by default: NaN passes through
        model.nan_check = True
        with pytest.raises(ValueError, match="NaN detected in EGNN output"):
            model(*xs)
        eps, _ = model(*xs, zero_nan=True)  # the training guard takes precedence
        assert torch.isfinite(eps[..., :3]).all()
    module = build_module_from_config(load_config(overrides=tiny_overrides(
        tpu={"nan_check": True})), np.ones((17, 65)))
    assert module.ddpm.dynamics.nan_check


CHAIN_T = 5
DENSE_OVERRIDES = tiny_overrides(
    egnn_params=dict(sin_embedding=True, aggregation_method="mean"),
    diffusion_params=dict(diffusion_steps=CHAIN_T))


@pytest.fixture(scope="module")
def dense_modules():
    """A tiny ``LigandPocketDDPM`` with sin features and mean aggregation,
    built from config overrides on both sides, the same weights."""
    return both_modules(DENSE_OVERRIDES)


@pytest.mark.parametrize("training", [True, False])
def test_loss_terms_match_jax(dense_modules, batches, training):  # noqa: F811
    jm, params, pm = dense_modules
    assert pm.ddpm.dynamics.dense
    lig, pkt = batches[0]["ligand"], batches[0]["pocket"]
    rng = jax.random.PRNGKey(3)
    want = jm.ddpm.loss_terms(params, rng, jnp_batch(lig), jnp_batch(pkt), training)
    t_int, noise = jax_draws(rng, lig, A, training, T=CHAIN_T)
    tq, nq = feed(pm, [t_int], noise)
    with torch.no_grad():
        got = pm.ddpm.loss_terms(None, torch_batch(lig), torch_batch(pkt), training)
    assert not tq and not nq
    assert_tree_close(got.pop("info"), want.pop("info"), **LOSS_TOL)
    assert_tree_close(got, want, **LOSS_TOL)


def test_chain_matches_jax(dense_modules, tmp_path):
    """A T = 5 chain of the sin/mean model on a synthetic pocket, recorded
    noise on both sides."""
    T, B, NL = CHAIN_T, 2, 6
    jm, params, pm = dense_modules
    queued = make_queued_ddpm(JaxConditionalDDPM)
    pm = pm.eval()
    pdb = tmp_path / "pocket.pdb"
    ref = chip_smoke.write_pocket_pdb(pdb, n_atoms=40, seed=2)
    pocket = pm.prepare_pocket(port_pdb.get_pocket_from_ligand(
        port_pdb.parse_pdb(pdb), ref), repeats=B)
    lig_mask = np.ones((B, NL), np.float32)
    lig_mask[1, 4:] = 0.0
    rng = np.random.default_rng(0)
    noise = [rng.standard_normal((B, NL, 3 + A)).astype(np.float32) for _ in range(T + 2)]
    jax_ddpm, cls = jm.ddpm, jm.ddpm.__class__
    jax_ddpm.__class__ = queued
    jax_ddpm.set_queue(list(noise))
    try:
        with jax.disable_jit():
            want, _ = jax_ddpm.sample_given_pocket(
                params, jax.random.PRNGKey(0),
                {k: jnp.asarray(v.numpy()) for k, v in pocket.items()},
                jnp.asarray(lig_mask), timesteps=T)
    finally:
        jax_ddpm.__class__ = cls
    queue = list(noise)
    pm.ddpm.sample_gaussian = lambda g, shape, mask: \
        torch.as_tensor(queue.pop(0)) * mask[..., None]
    with torch.no_grad():
        got, _ = pm.ddpm.sample_given_pocket(None, pocket, torch.as_tensor(lig_mask),
                                             timesteps=T, shared_pocket=True)
    assert not queue and not jax_ddpm._noise_queue
    m = lig_mask > 0
    dx, flips = deviation(got.numpy()[m], np.asarray(want)[m])
    print(f"T={T} dense chain: max coordinate deviation {dx:.2e} A, {flips} flips")
    assert dx <= 1e-4 and flips == 0


def test_sin_embedding_reference_state_dict_loads(dense_modules):
    """A sin-embedding model's reference-named state_dict (JAX's exporter)
    through the port's Lightning import: every tensor in its place, the
    wider first layers included."""
    over = DENSE_OVERRIDES
    jm, params, pm = dense_modules
    sd = export_state_dict(params, attention=True, reflection_equiv=False,
                           gamma_table=np.asarray(pm.ddpm.gamma_table))
    key = "ddpm.dynamics.egnn.e_block_0.gcl_0.edge_mlp.0.weight"
    H, dist = 16, port_egnn.sin_embedding_dim()
    assert sd[key].shape == (16, 2 * H + 2 * dist)  # no edge-type embedding
    fresh = build_module_from_config(load_config(overrides=over), np.ones((17, 65)))
    fresh.load_state_dict(state_dict_from_lightning(sd, fresh), strict=True)
    for name, v in pm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[name], v, atol=0, rtol=0, msg=name)
    with pytest.raises(ValueError, match="left over"):
        state_dict_from_lightning(dict(sd, **{"ddpm.dynamics.stray.weight": sd[key]}),
                                  fresh)


def test_gnn_dynamics_checkpoints_convert():
    """``gnn_dynamics``: a flax tree through ``convert/jax_params.py`` (the
    port's model gives JAX's output, ``test_dynamics_matches_jax``), and a
    reference-named state_dict (``ddpm.dynamics.gnn.*``) through the port's
    Lightning import and through JAX's converter to the same weights, every
    source tensor consumed."""
    jdyn, variables, model, batch = case("gnn", False)
    names = {k for k in model.state_dict()}
    assert {"gnn.embedding.weight", "gnn.gcl_1.edge_mlp.0.weight",
            "gnn.gcl_0.att_mlp.0.weight", "gnn.embedding_out.bias"} <= names
    assert model.gnn.embedding.in_features == 3 + KWARGS["joint_nf"] + 1
    over = tiny_overrides()
    module = build_module_from_config(load_config(overrides=over), np.ones((17, 65)))
    module.ddpm.dynamics = model
    sd = {PREFIX + k: v.numpy() for k, v in model.state_dict().items()}
    sd["ddpm.gamma.gamma"] = module.ddpm.gamma_table.numpy()
    loaded = state_dict_from_lightning(sd, module)
    converted = convert_state_dict(sd, n_layers=2, inv_sublayers=1, attention=True,
                                   reflection_equiv=False, has_edge_embedding=True,
                                   mode="gnn_dynamics")
    assert set(converted["dynamics"]["params"]) >= {"gnn", "atom_encoder"}
    from_jax = state_dict_from_jax({"dynamics": converted["dynamics"]})
    for k, v in from_jax.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v, err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        state_dict_from_lightning({k: v for k, v in sd.items()
                                   if "gnn.gcl_1" not in k}, module)


def test_fresh_coordinate_head_starts_as_in_jax():
    """A fresh model's coordinate head is xavier-uniform with gain 1e-3 in
    both packages (the reference's init): coordinate updates start near
    zero.  The port's head took nn.Linear's default before (found while
    porting the dense path)."""
    torch.manual_seed(0)
    model = EGNNDynamics(**KWARGS, update_pocket_coords=False, kernel_block_fuse=False)
    jdyn = JaxDynamics(**KWARGS, update_pocket_coords=False, impl="xla")
    variables = jdyn.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs(0)))
    H = KWARGS["hidden_nf"]
    bound = 1e-3 * np.sqrt(6.0 / (H + 1))
    for i in range(KWARGS["n_layers"]):
        w = getattr(model.egnn, f"e_block_{i}").gcl_equiv.coord_mlp[4].weight
        jw = variables["params"]["egnn"][f"e_block_{i}"]["gcl_equiv"]["coord_mlp"]["lin2"]["kernel"]
        for t in (w.detach().numpy(), np.asarray(jw)):
            assert np.abs(t).max() <= bound and np.abs(t).max() > bound / 4
