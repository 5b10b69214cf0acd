"""The port's multi-device paths against the JAX package's, on the CPU.

The port's ranks are processes spawned with ``torch.multiprocessing`` and
joined by gloo (``tests/torch_parallel_ranks.py``); the JAX side runs in this
process on the 8-device CPU mesh of ``tests/conftest.py``.  Two spawns in
all: two ranks for the edge-sharded dynamics, the sharded samplers,
data-parallel training and ``cli.train``; four for one 2 x 2 data-x-edge
grid.  Sizes are tiny (hidden 16, 1-2 layers, T = 5).

Tolerances: float32 on both sides with sums taken in another order.  Values
atol 1e-5 + rtol 1e-4 (the dense path's sinusoidal features and mean
aggregation: atol 1e-4 + rtol 1e-4, as ``tests/test_torch_dense.py``); parameter gradients of the edge split atol 5e-4 +
rtol 5e-3 (the JAX package's own ``tests/test_edge_shard.py``), and against
the unsharded port also 1e-4 of each gradient's largest entry; the
data-parallel step against the single-process step atol 1e-5 + rtol 1e-4,
and against JAX as ``tests/test_torch_train.py`` holds the port's step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parallel_ranks as ranks
from diffsbdd_tpu.models.dynamics import EGNNDynamics as JaxDynamics
from diffsbdd_tpu.parallel.edge_shard import (edge_sharded_dynamics as jax_edge_sharded,
                                              make_dp_edge_mesh, make_edge_mesh)
from diffsbdd_tpu.parallel.mesh import make_mesh, shard_batch as jax_shard_batch
from diffsbdd_tpu.train import loop as jax_loop
from diffsbdd_tpu_torch.chem import pdb as port_pdb
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_jax
from diffsbdd_tpu_torch.data import dataset as port_data
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
from diffsbdd_tpu_torch.parallel import mesh
from diffsbdd_tpu_torch.parallel.edge_shard import ShardContext, column_range
from diffsbdd_tpu_torch.parallel.sample_shard import reference_shard_chain
from diffsbdd_tpu_torch.train.module import build_module_from_config
from test_torch_train import (A, HIST, both_modules, jax_draws, jnp_batch,
                              tiny_overrides, tiny_train_config)

VALUE_TOL = dict(atol=1e-5, rtol=1e-4)
# the dense cases' values: the gate of tests/test_torch_dense.py (the highest
# sinusoid, 429 rad/A, turns a distance's float32 rounding into ~1e-5)
DENSE_VALUE_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)
# sharded against unsharded, both the port's: besides GRAD_TOL, every
# gradient within 1e-4 of its largest entry (the two differ in summation
# order only; a cotangent share left unsummed gives ~1e-3)
PORT_GRAD_RTOL = 1e-4
CUTOFFS = (None, 2.5, 2.0)
# update_pocket_coords False / True, on the kernels (sum, no sinusoidal
# features) and on the dense path (sinusoidal features, mean aggregation)
EDGE_CASES = ("conditional", "joint", "dense_conditional", "dense_joint")
# the dense cases scale the coordinate head 30x, not 300x: under mean
# aggregation a 300x head moves atoms by up to coords_range (15 A), and the
# sinusoidal features of such distances take float32 gradients up to 8% of a
# parameter's largest entry from float64, the split or no split
DENSE = dict(sin_embedding=True, aggregation_method="mean", head_scale=30.0)
# the conditional case's network with bf16 kernels forward and backward
TIER = dict(matmul_precision="bfloat16", kernel_bwd_precision="bfloat16")
# its network with a 2xTF32 forward (which takes the CPU through the
# kernels' autograd Functions) and the dense mirror's backward
MIRROR = dict(matmul_precision="float32_x2", kernel_bwd="xla")
PREFIX = "ddpm.dynamics."


# ---------------------------------------------------------------------------
# the coordinate kernel's column mask, plain versions
# ---------------------------------------------------------------------------

def coord_operands(seed=0, B=2, N=13, F=16):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g) * scale  # noqa: E731
    mask = (torch.rand(B, N, generator=g) > 0.2).float()
    is_lig = torch.zeros(B, N)
    is_lig[:, :5] = 1.0
    x0 = r(B, N, 3, scale=1.5) * mask[..., None]
    x = (x0 + r(B, N, 3, scale=0.2)) * mask[..., None]
    w3 = r(F, 1, scale=F ** -0.5)
    mlp = lambda: dict(a_row=r(B, N, F, scale=0.5), a_col=r(B, N, F, scale=0.5),  # noqa: E731
                       w_d2=r(F, scale=0.05), w_d20=r(F, scale=0.05), delta=r(F, scale=0.2),
                       w2=r(F, F, scale=F ** -0.5), b2=r(F, scale=0.1), w3=w3)
    return dict(x=x, x0=x0, mask=mask, is_lig=is_lig, main=mlp(), cross=mlp(),
                graph_mean=(x * mask[..., None]).sum(1) / mask.sum(1)[:, None],
                g=r(B, N, 3))


COORD_KW = dict(cutoffs=CUTOFFS, tanh=True, coords_range=15.0, norm_constant=1.0,
                normalization_factor=100.0)


def coord_forward(o, **kw):
    m, c = o["main"], o["cross"]
    cross = dict(c, type_bias=ec._delta_table(c["delta"]))
    del cross["delta"]
    return ec.coord_update_agg_plain(
        m["a_row"], m["a_col"], o["x"], o["x0"], o["mask"], o["is_lig"], m["w_d2"],
        m["w_d20"], ec._delta_table(m["delta"]), m["w2"], m["b2"], m["w3"],
        cross=cross, graph_mean=o["graph_mean"], **COORD_KW, **kw)


def coord_backward(o, **kw):
    m = o["main"]
    main, cross, dmean = ec.coord_agg_bwd_plain(
        o["g"], m["a_row"], m["a_col"], o["x"], o["x0"], o["mask"], o["is_lig"],
        *(m[k] for k in ("w_d2", "w_d20", "delta", "w2", "b2", "w3")),
        cross=o["cross"], graph_mean=o["graph_mean"], **COORD_KW, **kw)
    return list(main) + [cross[k] for k in ec._MLP_KEYS] + [dmean]


@pytest.mark.parametrize("update_rows", [None, 5])
def test_coord_col_mask_equal_to_mask_is_bitwise_unchanged(update_rows):
    o = coord_operands()
    assert torch.equal(coord_forward(o, update_rows=update_rows),
                       coord_forward(o, col_mask=o["mask"], update_rows=update_rows))
    for a, b in zip(coord_backward(o, update_rows=update_rows),
                    coord_backward(o, col_mask=o["mask"], update_rows=update_rows)):
        assert torch.equal(a, b)


def test_coord_column_blocks_sum_to_the_whole():
    """Three uneven column blocks (the ranks of an edge split): the forward
    and every cotangent of the blocks add up to the unsplit call's."""
    o = coord_operands(seed=1)
    N = o["mask"].shape[1]
    blocks = [ShardContext(None, *column_range(N, i, 3)).col_mask(o["mask"])
              for i in range(3)]
    whole = coord_forward(o)
    parts = sum(coord_forward(o, col_mask=b) for b in blocks)
    torch.testing.assert_close(parts, whole, **VALUE_TOL)
    whole_bwd = coord_backward(o)
    parts_bwd = [sum(p) for p in zip(*(coord_backward(o, col_mask=b) for b in blocks))]
    for got, want in zip(parts_bwd, whole_bwd):
        torch.testing.assert_close(got, want, **VALUE_TOL)


# ---------------------------------------------------------------------------
# process groups without a run around them
# ---------------------------------------------------------------------------

def test_a_process_on_its_own(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.init_distributed(device="cpu") == 1
    assert mesh.make_data_group(-1) is None and mesh.make_data_group(1) is None
    with pytest.raises(ValueError, match="requested a 2-rank data group"):
        mesh.make_data_group(2)
    batch = {"ligand": {"x": np.arange(8).reshape(4, 2)}, "names": list("abcd")}
    assert mesh.shard_batch(batch, None)["names"] == list("abcd")
    assert mesh.rank_seed(7, 0) == 7 and len({mesh.rank_seed(7, r) for r in range(4)}) == 4


# ---------------------------------------------------------------------------
# the two-rank run
# ---------------------------------------------------------------------------

def edge_inputs(seed, B=2, NL=7, NP=22, atom_nf=5, residue_nf=7):
    """29 nodes: an odd count, which two shards do not divide."""
    rng = np.random.default_rng(seed)
    m_l = (rng.uniform(size=(B, NL)) > 0.2).astype(np.float32)
    m_p = (rng.uniform(size=(B, NP)) > 0.2).astype(np.float32)
    m_l[:, 0] = m_p[:, 0] = 1.0
    xh_l = np.concatenate([rng.standard_normal((B, NL, 3)),
                           np.eye(atom_nf)[rng.integers(0, atom_nf, (B, NL))]], -1)
    xh_p = np.concatenate([rng.standard_normal((B, NP, 3)) * 1.5,
                           np.eye(residue_nf)[rng.integers(0, residue_nf, (B, NP))]], -1)
    t = np.full((B, 1), 0.3)
    return [np.ascontiguousarray(a, np.float32) for a in (xh_l, xh_p, t, m_l, m_p)]


def edge_case(update_pocket_coords, seed, B=2, head_scale=300.0, **variant):
    """A two-layer dynamics (SE(3) cross branch, attention, tanh, edge-type
    embedding; ``variant``: further options) initialized by JAX: (the JAX
    module, its variables, the spec the ranks build the port's from)."""
    kwargs = dict(atom_nf=5, residue_nf=7, joint_nf=8, hidden_nf=16, n_layers=2,
                  attention=True, tanh=True, norm_constant=1.0, inv_sublayers=1,
                  reflection_equivariant=False, edge_embedding_dim=8,
                  edge_cutoff_ligand=CUTOFFS[0], edge_cutoff_pocket=CUTOFFS[1],
                  edge_cutoff_interaction=CUTOFFS[2],
                  update_pocket_coords=update_pocket_coords, **variant)
    inputs = edge_inputs(seed, B=B)
    jdyn = JaxDynamics(**kwargs, impl="xla")
    variables = jax.tree_util.tree_map(
        np.asarray, jdyn.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs)))
    # the coordinate head starts near zero (gain 1e-3, as in the reference):
    # scaled to a trained head's size, so that the coordinates, and the graph
    # mean of the cross branch, carry gradient from block to block
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf * head_scale if "coord_mlp/lin2" in jax.tree_util.keystr(
            path, simple=True, separator="/") else leaf, variables)
    state = {k[len(PREFIX):]: v for k, v in
             state_dict_from_jax({"dynamics": variables}).items()}
    return jdyn, variables, dict(kwargs=kwargs, state=state, inputs=inputs)


def jax_sum_sq_grads(apply_fn, variables, inputs):
    def loss(v):
        return sum(jnp.sum(e ** 2) for e in apply_fn(v, *map(jnp.asarray, inputs)))
    grads = jax.jit(jax.grad(loss))(variables)
    return {k[len(PREFIX):]: v for k, v in state_dict_from_jax(
        {"dynamics": jax.tree_util.tree_map(np.asarray, grads)}).items()}


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """Everything the two ranks need, and what they returned."""
    work = tmp_path_factory.mktemp("two_ranks")
    edge = {name: edge_case(upd, seed, **variant)
            for name, upd, seed, variant in (
                ("conditional", False, 1, {}), ("joint", True, 2, {}),
                ("dense_conditional", False, 6, DENSE), ("dense_joint", True, 7, DENSE),
                ("tier_conditional", False, 1, TIER),
                ("mirror_conditional", False, 1, MIRROR))}
    # gnn_dynamics under the split raises, as in JAX
    gnn = dict(edge["conditional"][2], state=None)
    gnn["kwargs"] = dict(gnn["kwargs"], mode="gnn_dynamics")

    # sampling: a tiny conditional model at T = 5 on a 30-atom pocket shared
    # by a batch of 4
    T = 5
    sampling_config = tiny_overrides(diffusion_params=dict(diffusion_steps=T))
    torch.manual_seed(0)
    pm = build_module_from_config(load_config(overrides=sampling_config), HIST)
    pdb = work / "pocket.pdb"
    ref = chip_smoke.write_pocket_pdb(pdb, n_atoms=30, seed=4)
    pocket = pm.prepare_pocket(port_pdb.get_pocket_from_ligand(
        port_pdb.parse_pdb(pdb), ref), repeats=4)
    lig_mask = np.ones((4, 6), np.float32)
    lig_mask[1, 4:] = lig_mask[3, 5:] = 0.0
    sampling = dict(module=dict(
        config=sampling_config, histogram=HIST,
        state={k: v.detach().numpy() for k, v in pm.state_dict().items()}),
        pocket={k: v.numpy() for k, v in pocket.items()}, lig_mask=lig_mask, T=T, seed=5)

    # training: a tiny conditional model, JAX-initialized; two global
    # batches of 4 and the noise JAX draws for them
    datadir = work / "data"
    chip_smoke.write_synthetic_dataset(datadir, 8, 4, seed=3, lig_sizes=(5, 12),
                                       pocket_sizes=(20, 28, 36), n_types=A)
    batches = list(port_data.PaddedLoader(
        port_data.LigandPocketDataset(datadir / "train.npz"), 4, shuffle=False))
    jm, params, _ = both_modules(tiny_overrides())
    keys = [jax.random.PRNGKey(40 + i) for i in range(2)]
    noise = []
    for key, batch in zip(keys, batches):
        t_int, (eps,) = jax_draws(key, batch["ligand"], A, True)
        noise.append((t_int, eps))
    training = dict(
        module=dict(config=tiny_overrides(), histogram=HIST,
                    state=state_dict_from_jax(params)),
        batches=batches, noise=noise,
        config=tiny_train_config(datadir, work, batch_size=4))

    job = dict(workdir=str(work), sampling=sampling, training=training,
               edge={name: spec for name, (_, _, spec) in edge.items()}, gnn=gnn)
    results = ranks.run(ranks.two_ranks, 2, work, job)
    return dict(job=job, results=results, edge=edge, jax_train=(jm, params, keys))


# ---- the edge split -------------------------------------------------------

def value_tol(name):
    return DENSE_VALUE_TOL if name.startswith("dense") else VALUE_TOL


@pytest.mark.parametrize("name", EDGE_CASES)
def test_edge_sharded_dynamics_matches_unsharded_port(two_rank_run, name):
    spec = two_rank_run["job"]["edge"][name]
    model = ranks.build_dynamics(spec)
    want = model(*map(torch.as_tensor, spec["inputs"]))
    want_grads = ranks.sum_sq_grads(model, want)
    for res in two_rank_run["results"]:
        got = res["edge"][name]
        assert got["eps"][1].shape == want[1].shape  # no padding left on
        for g, w in zip(got["eps"], want):
            torch.testing.assert_close(g, w.detach(), **value_tol(name))
        for (n, _), g, w in zip(model.named_parameters(), got["grads"], want_grads):
            torch.testing.assert_close(g, w, **GRAD_TOL, msg=n)
            assert float((g - w).abs().max()) <= PORT_GRAD_RTOL * float(w.abs().max()), n


@pytest.mark.parametrize("name", EDGE_CASES)
def test_edge_sharded_dynamics_matches_jax(two_rank_run, name):
    """Against JAX's ``edge_sharded_dynamics`` on a two-device edge mesh, on
    the same weights: values and every parameter's gradient."""
    jdyn, variables, spec = two_rank_run["edge"][name]
    sharded = jax_edge_sharded(jdyn, make_edge_mesh(2))
    want = jax.jit(sharded)(variables, *map(jnp.asarray, spec["inputs"]))
    want_grads = jax_sum_sq_grads(sharded, variables, spec["inputs"])
    names = [n for n, _ in ranks.build_dynamics(spec).named_parameters()]
    for res in two_rank_run["results"]:
        got = res["edge"][name]
        for g, w in zip(got["eps"], want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **value_tol(name))
        for n, g in zip(names, got["grads"]):
            np.testing.assert_allclose(g.numpy(), want_grads[n], **GRAD_TOL, err_msg=n)


def test_edge_split_at_a_precision_tier(two_rank_run):
    """The bf16 tiers under the edge split: each rank's column block through
    the plain versions at bf16, forward and backward.  A pair's rounding is
    the same whichever rank computes it, so against one process at the same
    tier the values and gradients hold the float32 gates; against JAX's
    float32 split (its XLA path ignores the tier on the CPU) the tier's own
    deviation shows, within JAX's bf16 gate: 5e-2 of the largest entry
    (measured 1.5e-3)."""
    jdyn, variables, spec = two_rank_run["edge"]["tier_conditional"]
    model = ranks.build_dynamics(spec)
    assert (model.precision, model.bwd_precision) == ("bf16", "bf16")
    want = model(*map(torch.as_tensor, spec["inputs"]))
    want_grads = ranks.sum_sq_grads(model, want)
    exact = jax.jit(jax_edge_sharded(jdyn, make_edge_mesh(2)))(
        variables, *map(jnp.asarray, spec["inputs"]))
    for res in two_rank_run["results"]:
        got = res["edge"]["tier_conditional"]
        for g, w, e in zip(got["eps"], want, exact):
            torch.testing.assert_close(g, w.detach(), **VALUE_TOL)
            share = float(np.abs(g.numpy() - np.asarray(e)).max() / np.abs(np.asarray(e)).max())
            assert share <= 5e-2, share
        for (n, _), g, w in zip(model.named_parameters(), got["grads"], want_grads):
            torch.testing.assert_close(g, w, **GRAD_TOL, msg=n)


def test_edge_split_with_the_mirror_backward(two_rank_run):
    """``kernel_bwd: xla`` under the edge split: each rank differentiates
    the float32 mirror on its column block.  Against one process of the same
    network, values and gradients within the float32 gates; the gradients
    also within GRAD_TOL of JAX's float32 split (the forward's 2xTF32
    rounding moves them little), and not those of the 2xTF32 backward."""
    jdyn, variables, spec = two_rank_run["edge"]["mirror_conditional"]
    model = ranks.build_dynamics(spec)
    assert model.mirror_bwd and model.precision == "tf32x2"
    want = model(*map(torch.as_tensor, spec["inputs"]))
    want_grads = ranks.sum_sq_grads(model, want)
    jax_grads = jax_sum_sq_grads(jax_edge_sharded(jdyn, make_edge_mesh(2)), variables,
                                 spec["inputs"])
    kernel_bwd = ranks.build_dynamics(dict(spec, kwargs=dict(spec["kwargs"],
                                                            kernel_bwd="auto")))
    tier_grads = ranks.sum_sq_grads(kernel_bwd, kernel_bwd(*map(torch.as_tensor,
                                                                spec["inputs"])))
    names = [n for n, _ in model.named_parameters()]
    for res in two_rank_run["results"]:
        got = res["edge"]["mirror_conditional"]
        for g, w in zip(got["eps"], want):
            torch.testing.assert_close(g, w.detach(), **VALUE_TOL)
        for n, g, w in zip(names, got["grads"], want_grads):
            torch.testing.assert_close(g, w, **GRAD_TOL, msg=n)
            np.testing.assert_allclose(g.numpy(), jax_grads[n], **GRAD_TOL, err_msg=n)
        assert any(not torch.equal(g, t) for g, t in zip(got["grads"], tier_grads))


def test_edge_split_refuses_gnn_dynamics(two_rank_run):
    """``gnn_dynamics`` has no edge split, in the port as in JAX."""
    jdyn, variables, spec = two_rank_run["edge"]["conditional"]
    gnn = JaxDynamics(**dict(spec["kwargs"], mode="gnn_dynamics"), impl="xla")
    with pytest.raises(NotImplementedError, match="egnn_dynamics only"):
        jax_edge_sharded(gnn, make_edge_mesh(2))(
            gnn.init(jax.random.PRNGKey(0), *map(jnp.asarray, spec["inputs"])),
            *map(jnp.asarray, spec["inputs"]))
    for res in two_rank_run["results"]:
        assert res["gnn_error"] == "edge-axis sharding supports egnn_dynamics only"


def test_dp_x_edge_grid_matches_jax(tmp_path):
    """Four ranks, a 2 x 2 data-x-edge grid, against JAX on
    ``make_dp_edge_mesh(2, 2)``: the gathered values and the gradients
    summed over the data group."""
    jdyn, variables, spec = edge_case(False, seed=3, B=4)
    res = ranks.run(ranks.dp_x_edge, 4, tmp_path, dict(edge=spec))
    sharded = jax_edge_sharded(jdyn, make_dp_edge_mesh(2, 2), batch_axis="data")
    want = jax.jit(sharded)(variables, *map(jnp.asarray, spec["inputs"]))
    want_grads = jax_sum_sq_grads(sharded, variables, spec["inputs"])
    names = [n for n, _ in ranks.build_dynamics(spec).named_parameters()]
    for r in res:
        for g, w in zip(r["eps"], want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **VALUE_TOL)
        for n, g in zip(names, r["grads"]):
            np.testing.assert_allclose(g.numpy(), want_grads[n], **GRAD_TOL, err_msg=n)


# ---- the sharded samplers -------------------------------------------------

def sampling_setup(run):
    s = run["job"]["sampling"]
    ddpm = ranks.build_module(s["module"]).ddpm.eval()
    pocket = {k: torch.as_tensor(v) for k, v in s["pocket"].items()}
    return s, ddpm, pocket, torch.as_tensor(s["lig_mask"])


def test_sharded_sampling_global_noise_equals_unsharded(two_rank_run):
    """The gathered two-rank chain is the unsharded chain: coordinates within
    1e-4 A, no atom-type flip."""
    s, ddpm, pocket, lig_mask = sampling_setup(two_rank_run)
    want = ddpm.sample_given_pocket(torch.Generator().manual_seed(s["seed"]), pocket,
                                    lig_mask, timesteps=s["T"], shared_pocket=True)
    valid = [lig_mask > 0, pocket["mask"] > 0]
    for res in two_rank_run["results"]:
        for got, ref, m in zip(res["global"], want, valid):
            dx = float((got[..., :3] - ref[..., :3])[m].abs().max())
            flips = int((got[..., 3:].argmax(-1) != ref[..., 3:].argmax(-1))[m].sum())
            print(f"global contract: max coordinate deviation {dx:.2e} A, {flips} flips")
            assert dx <= 1e-4 and flips == 0


def test_sharded_sampling_per_rank_equals_reference_chain(two_rank_run):
    """Rank r's rows are ``reference_shard_chain`` of shard r, bit for bit
    (one thread, as the ranks ran)."""
    s, ddpm, pocket, lig_mask = sampling_setup(two_rank_run)
    threads = torch.get_num_threads()
    torch.set_num_threads(ranks.THREADS)
    try:
        want = [reference_shard_chain(
            ddpm, s["seed"], {k: v[2 * r:2 * r + 2] for k, v in pocket.items()},
            lig_mask[2 * r:2 * r + 2], r, timesteps=s["T"], shared_pocket=True)
            for r in range(2)]
    finally:
        torch.set_num_threads(threads)
    for res in two_rank_run["results"]:
        for i in range(2):  # xh_lig, xh_pkt
            assert torch.equal(res["per_rank"][i], torch.cat([w[i] for w in want]))
    # each rank drew its own noise
    assert not torch.equal(want[0][0], want[1][0])


def test_sharded_sampling_needs_a_divisible_batch(two_rank_run):
    for res in two_rank_run["results"]:
        for msg in res["sampling_errors"]:
            assert "batch 3 is not divisible by the 2 ranks" in msg


# ---- data-parallel training ------------------------------------------------

@pytest.mark.parametrize("k_acc", [1, 2])
def test_dp_step_matches_the_single_process_step(two_rank_run, k_acc):
    """Two ranks of batch 2 against one process of batch 4, the same recorded
    noise: the reduced gradients, loss, metrics and gradient norm of the
    first step; the parameters after two steps (within 1e-5: a step moves
    an entry by about lr * g / (|g| + 1e-8), and the two sides' gradients
    agree to float32 rounding)."""
    t = two_rank_run["job"]["training"]
    want = ranks.train_steps(t["module"], t["batches"], t["noise"], k_acc)
    for res in two_rank_run["results"]:
        got = res["dp"][k_acc]
        assert got["infos"][0].keys() == want["infos"][0].keys()
        for step in range(2):
            for k, v in want["infos"][step].items():
                np.testing.assert_allclose(got["infos"][step][k], v, **VALUE_TOL,
                                           err_msg=f"{k} at step {step}")
        for g, w in zip(got["grads"], want["grads"]):
            torch.testing.assert_close(g, w, **VALUE_TOL)
        for g, w in zip(got["params"], want["params"]):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_dp_step_matches_jax(two_rank_run):
    """Against the JAX step on a batch placed on a two-device data mesh
    (``make_train_step(mesh=None)``, which the JAX package pins to the
    single-device step), two steps with the recorded noise: loss and
    gradient norm within 1e-3, parameters within 2e-4 (as
    ``tests/test_torch_train.py`` holds the single-process port)."""
    t = two_rank_run["job"]["training"]
    jm, params, keys = two_rank_run["jax_train"]
    jstep = jax_loop.make_train_step(jm, lr=1e-3, clip_grad=True)
    jstate = jax_loop.create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                         lr=1e-3)
    data_mesh = make_mesh(2)
    infos = []
    for key, batch in zip(keys, t["batches"]):
        jstate, info = jstep(jstate, key,
                             jax_shard_batch(jnp_batch(batch["ligand"]), data_mesh),
                             jax_shard_batch(jnp_batch(batch["pocket"]), data_mesh))
        infos.append(info)
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    names = [n for n, _ in ranks.build_module(t["module"]).named_parameters()]
    for res in two_rank_run["results"]:
        got = res["dp"][1]
        for step, info in enumerate(infos):
            for k in ("loss", "grad_norm", "max_grad_norm"):
                np.testing.assert_allclose(got["infos"][step][k], float(info[k]),
                                           rtol=1e-3, err_msg=f"{k} at step {step}")
        for n, p in zip(names, got["params"]):
            np.testing.assert_allclose(p.numpy(), want_sd[n], atol=2e-4, rtol=0,
                                       err_msg=n)


def test_dp_divisibility_and_group_errors(two_rank_run):
    for res in two_rank_run["results"]:
        e = res["errors"]
        assert "requested a 3-rank data group but only 2" in e["data_group"]
        assert "batch_size=3 is not divisible by the 2 ranks" in e["batch"]
        assert "gives per-shard batch 2, not divisible by accumulate_grad_batches=4" \
            in e["per_shard"]
        assert "the data group holds 1 of 2 ranks" in e["no_group"]
        assert "must divide the per-shard batch size 2 (= global batch / 2 devices)" \
            in e["step"]


def test_cli_train_writes_files_on_rank_0_only(two_rank_run):
    """cli.train on two ranks, each with its own logdir: rank 0 writes the
    checkpoints, rank 1 nothing; the prefetch thread is gone after the run."""
    r0, r1 = two_rank_run["results"]
    assert {"tiny/checkpoints/last.pt", "tiny/checkpoints/best.pt"} <= set(r0["written"])
    assert r1["written"] == []
    assert r0["threads_left"] == r1["threads_left"] == []
