"""The port's spans (``utils.profiling.span``) and the kernels' pair counters
(``ops.egnn_cuda.pair_counts``) on the CPU: nothing recorded without a
profiler, parents, roots and self times with one, the Chrome trace's
annotations, the plain path's pair counts against the dense adjacency, the
counter the launches get, and the spans of a sampler, a training step and
the loader.  Imports neither JAX nor the JAX package."""
import json
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.data.dataset import (LigandPocketDataset, PaddedLoader,
                                             load_size_histogram)
from diffsbdd_tpu_torch.ops import egnn_cuda as ec
from diffsbdd_tpu_torch.train.loop import batch_to_device, create_train_state, make_train_step
from diffsbdd_tpu_torch.train.module import build_module_from_config
from diffsbdd_tpu_torch.utils import profiling
import test_torch_threads  # noqa: F401  (PyTorch threads a worker under xdist)


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    ec.reset_launch_counts()
    yield
    profiling.reset()
    ec.reset_launch_counts()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_a_span_without_a_profiler_records_nothing(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(profiling, "_event", lambda device: entered.append("event"))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("sampler.pass")
    with first, profiling.span("network.forward"):
        pass
    assert first is profiling.span("train.step")  # one shared null context
    assert entered == []
    assert profiling.spans() == [] and profiling.snapshot() == {}


def test_nested_spans_give_parents_roots_and_self_times():
    with recording():
        with profiling.span("outer"):
            busy(0.01)
            with profiling.span("inner"):
                busy(0.02)
            with profiling.span("inner"):
                busy(0.02)
            worker = threading.Thread(target=lambda: profiling.span("thread").__enter__()
                                      .__exit__(None, None, None))
            worker.start()
            worker.join()
        with profiling.span("outer"):
            busy(0.005)
    found = profiling.spans()
    assert [s.name for s in found] == ["outer", "inner", "inner", "thread", "outer"]
    assert [s.parent for s in found] == [None, 0, 0, None, None]
    roots = [s.root for s in found]
    assert roots[0] == roots[1] == roots[2]
    assert len({roots[0], roots[3], roots[4]}) == 3  # the thread's span is its own root
    assert all(s.device_s is None for s in found)  # no CUDA in use
    snap = profiling.snapshot()
    assert snap["outer"]["count"] == 2 and snap["inner"]["count"] == 2
    assert snap["inner"]["host_s"] == pytest.approx(snap["inner"]["host_self_s"])
    outer = found[0].host_end - found[0].host_start
    children = sum(s.host_end - s.host_start for s in found[1:3])
    assert snap["outer"]["host_s"] == pytest.approx(
        outer + found[4].host_end - found[4].host_start)
    assert snap["outer"]["host_self_s"] == pytest.approx(snap["outer"]["host_s"] - children)
    assert 0.01 <= snap["outer"]["host_self_s"] < snap["outer"]["host_s"] - 0.04
    assert snap["outer"]["device_s"] is None and snap["outer"]["device_self_median_s"] is None


def test_snapshot_and_reset():
    with recording():
        for _ in range(3):
            with profiling.span("step"):
                pass
    assert profiling.snapshot()["step"]["count"] == 3
    assert profiling.snapshot()["step"]["count"] == 3  # reading keeps the spans
    profiling.reset()
    assert profiling.snapshot() == {} and profiling.spans() == []
    with recording():
        with profiling.span("step"):
            pass
    assert profiling.snapshot()["step"]["count"] == 1


@pytest.mark.parametrize("restart", [False, True])
def test_a_span_the_profiler_stopped_inside_is_not_kept(restart, monkeypatch):
    """Nor is its range ended: the stopped profiler's end callback would
    write into the storage it freed (a crash later, at random)."""
    exits = []
    real = torch.profiler.record_function

    class Counting(real):
        def __exit__(self, *exc):
            exits.append(self.name)
            return super().__exit__(*exc)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    open_before = len(profiling._open_ranges)
    prof = recording()
    prof.start()
    with profiling.span("pass"):
        with profiling.span("net"):
            pass
        prof.stop()
        with profiling.span("net"):  # entered with no profiler: nothing
            pass
        if restart:  # another profiler records when the span ends
            prof = recording()
            prof.start()
    if restart:
        prof.stop()
    assert [s.name for s in profiling.spans()] == ["net"]
    assert profiling.spans()[0].parent is None  # its parent was not kept
    assert exits == ["net"]
    assert len(profiling._open_ranges) == open_before + 1


def test_device_trace_holds_the_spans_as_user_annotations(tmp_path):
    with profiling.device_trace(tmp_path / "trace"):
        with profiling.span("sampler.pass"):
            with profiling.span("network.forward"):
                torch.randn(32, 32) @ torch.randn(32, 32)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"sampler.pass", "network.forward"} <= names
    assert [s.name for s in profiling.spans()] == ["sampler.pass", "network.forward"]


# ---------------------------------------------------------------------------
# pair counters
# ---------------------------------------------------------------------------

def _graph(seed, B=2, N=30, F=16):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g) * scale
    x = r(B, N, 3, scale=4.0)
    mask = (torch.rand((B, N), generator=g) > 0.2).float()
    is_lig = (torch.arange(N) < 9).float().expand(B, N).contiguous()
    ops = dict(a_row=r(B, N, F), a_col=r(B, N, F), x=x, x0=x + r(B, N, 3, scale=0.1),
               mask=mask, is_lig=is_lig, w_d2=r(F, scale=0.1), w_d20=r(F, scale=0.1),
               type_bias=r(2, 2, F, scale=0.1), w2=r(F, F, scale=0.3), b2=r(F, scale=0.1))
    return ops, dict(w_att=r(F, 1, scale=0.3), b_att=r(1), w3=r(F, 1, scale=0.3))


def _dense_pairs(ops, cutoffs, col_mask, update_rows):
    adj = ec.adjacency_dense(ec._pair_d2(ops["x0"]), ops["mask"], ops["is_lig"], cutoffs,
                             col_mask=col_mask)
    rows = adj.shape[1] if update_rows is None else update_rows
    return int((adj[:, :rows] != 0).sum())


@pytest.mark.parametrize("kernel", ["gcl_agg", "coord_agg"])
@pytest.mark.parametrize("cutoffs", [(None, 5.0, 5.0), (3.0, 4.0, 6.0)])
@pytest.mark.parametrize("variant", ["all", "update_rows", "col_mask", "both"])
def test_plain_pair_counts_are_the_dense_adjacency(kernel, cutoffs, variant):
    ops, extra = _graph(1)
    B, N = ops["mask"].shape
    col_mask = ops["mask"] * ops["is_lig"] if variant in ("col_mask", "both") else None
    update_rows = 9 if variant in ("update_rows", "both") else None
    kw = dict(cutoffs=cutoffs, normalization_factor=100.0, col_mask=col_mask,
              update_rows=update_rows)
    if kernel == "gcl_agg":
        run = lambda: ec.gcl_message_agg(*ops.values(), extra["w_att"], extra["b_att"],
                                         attention=True, **kw)
    else:
        run = lambda: ec.coord_update_agg(*ops.values(), extra["w3"], tanh=True,
                                          coords_range=15.0, norm_constant=1.0, **kw)
    run()  # no profiler: nothing counted
    assert ec.pair_counts()[kernel] == (0, 0)
    with recording():
        run()
        run()
    active = _dense_pairs(ops, cutoffs, col_mask, update_rows)
    assert 0 < active < B * N * N
    assert ec.pair_counts()[kernel] == (2 * active, 2 * B * N * N)
    assert all(v == (0, 0) for k, v in ec.pair_counts().items() if k != kernel)
    ec.reset_launch_counts()
    assert ec.pair_counts()[kernel] == (0, 0)


@pytest.mark.parametrize("tier", ["tf32x2", "bf16"])
def test_plain_pair_counts_of_the_backward(tier):
    """A tier other than 3xTF32 runs the wrappers' autograd Functions on the
    CPU, whose backward goes through the backward wrappers: each counts."""
    ops, extra = _graph(2)
    leaf = ops["a_row"].clone().requires_grad_(True)
    cutoffs = (None, 5.0, 5.0)
    with recording():
        out = ec.gcl_message_agg(leaf, *list(ops.values())[1:], extra["w_att"],
                                 extra["b_att"], cutoffs=cutoffs, attention=True,
                                 normalization_factor=100.0, update_rows=9, precision=tier)
        out.sum().backward()
        out = ec.coord_update_agg(leaf, *list(ops.values())[1:], extra["w3"],
                                  cutoffs=cutoffs, tanh=True, coords_range=15.0,
                                  norm_constant=1.0, normalization_factor=100.0,
                                  update_rows=9, precision=tier)
        out.sum().backward()
    B, N = ops["mask"].shape
    want = (_dense_pairs(ops, cutoffs, None, 9), B * N * N)
    counts = ec.pair_counts()
    assert [counts[k] for k in ("gcl_agg", "gcl_agg_bwd", "coord_agg", "coord_agg_bwd")] \
        == [want] * 4


def test_plain_pair_counts_of_the_whole_block():
    """Both phases add: the GCL on every row, the coordinate update below
    update_rows."""
    ops, _ = _graph(3)
    B, N, F = ops["a_row"].shape
    g = torch.Generator().manual_seed(4)
    r = lambda *s: torch.randn(s, generator=g) * 0.2
    head = lambda: dict(k_i=r(F, F), k_j=r(F, F), b0=r(F), w_d2=r(F), w_d20=r(F),
                        type_bias=r(2, 2, F), w1=r(F, F), b1=r(F), w3=r(F, 1))
    gcl = dict(w_d2=r(F), w_d20=r(F), type_delta=None, w2=r(F, F), b2=r(F),
               w_att=r(F, 1), b_att=r(1))
    node = dict(w_h=r(F, F), w_a=r(F, F), b0=r(F), w2=r(F, F), b2=r(F))
    cutoffs = (None, 5.0, 5.0)
    with recording():
        ec.block_fused(r(B, N, F), ops["a_row"], ops["a_col"], ops["x"], ops["x0"],
                       ops["mask"], ops["is_lig"], gcl, node, head(), cutoffs=cutoffs,
                       attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
                       normalization_factor=100.0, update_rows=9)
    want = _dense_pairs(ops, cutoffs, None, None) + _dense_pairs(ops, cutoffs, None, 9)
    assert ec.pair_counts()["block_fused"] == (want, 2 * B * N * N)


class _Lib:
    """A stand-in for a kernel's library: keeps what each entry point got."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn_name):
        return lambda *args: self.calls.append((fn_name, args)) or 0


def test_launches_pass_a_null_counter_unless_a_profiler_records(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(ec, "_lib", lambda name, tier=ec.DEFAULT_TIER: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    buf = torch.zeros((len(ec.KERNELS), 2), dtype=torch.int64)
    monkeypatch.setitem(ec._pair_buffers, 0, buf)
    for name in ec.KERNELS:
        ec._launch(name, 1, 2)
    with recording():
        for name in ec.KERNELS:
            ec._launch(name, 1, 2)
    off, on = lib.calls[:len(ec.KERNELS)], lib.calls[len(ec.KERNELS):]
    for k, name in enumerate(ec.KERNELS):
        fn_name = ec._ARGTYPES[name][0]
        assert off[k] == (fn_name, (1, 2, None, 7))
        assert on[k] == (fn_name, (1, 2, buf[k].data_ptr(), 7))
    assert ec.launch_counts == {name: 2 for name in ec.KERNELS}


def test_reset_zeroes_the_device_counters(monkeypatch):
    buf = torch.arange(2 * len(ec.KERNELS), dtype=torch.int64).view(-1, 2)
    monkeypatch.setitem(ec._pair_buffers, 0, buf)
    assert ec.pair_counts()["gcl_agg"] == (0, 1)
    assert ec.pair_counts()["block_fused"] == (8, 9)
    ec.reset_launch_counts()
    assert not buf.any()


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

TINY = {"dataset": "crossdock_full", "pocket_representation": "full-atom",
        "egnn_params": {"hidden_nf": 16, "joint_nf": 8, "n_layers": 1}}


def test_sampling_records_a_pass_span_a_network_pass_and_the_decode(tmp_path):
    T = 3
    cfg = load_config(overrides=dict(TINY, mode="pocket_conditioning",
                                     diffusion_params={"diffusion_steps": T}))
    module = build_module_from_config(cfg, np.ones((17, 129))).eval()
    ref = chip_smoke.write_pocket_pdb(tmp_path / "p.pdb", n_atoms=30)
    g = torch.Generator().manual_seed(0)
    module.generate_ligands(tmp_path / "p.pdb", 2, g, ref_ligand=ref,
                            num_nodes_lig=np.array([5, 6]))
    assert profiling.spans() == []
    with recording():
        module.generate_ligands(tmp_path / "p.pdb", 2, g, ref_ligand=ref,
                                num_nodes_lig=np.array([5, 6]))
    found = profiling.spans()
    names = [s.name for s in found]
    assert names == ["module.prepare_pocket"] + ["sampler.pass", "network.forward"] * (T + 1) \
        + ["module.build_molecules"]
    for k, s in enumerate(found):
        if s.name == "network.forward":
            assert found[s.parent].name == "sampler.pass" and s.parent == k - 1
            assert s.root == found[k - 1].root
    assert profiling.snapshot()["sampler.pass"]["count"] == T + 1
    counts = ec.pair_counts()
    assert counts["gcl_agg"][0] > 0 and counts["coord_agg"][0] > 0


def test_a_training_step_records_its_micro_batches_and_the_loader_its_batches():
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        chip_smoke.write_synthetic_dataset(d, 8, 2, seed=3, lig_sizes=(4, 8),
                                           pocket_sizes=(20, 28), n_types=11)
        cfg = load_config(overrides=dict(TINY, mode="joint", datadir=str(d), batch_size=4,
                                         accumulate_grad_batches=2,
                                         diffusion_params={"diffusion_steps": 10}))
        module = build_module_from_config(cfg, load_size_histogram(d)).train()
        loader = PaddedLoader(LigandPocketDataset(d / "train.npz"), 4,
                              rng=np.random.default_rng(0))
        step = make_train_step(create_train_state(module, lr=1e-3), True,
                               accumulate_grad_batches=2)
        g = torch.Generator().manual_seed(0)
        with recording():
            for batch in loader:
                step(g, batch_to_device(batch["ligand"], "cpu"),
                     batch_to_device(batch["pocket"], "cpu"))
    found = profiling.spans()
    assert [s.name for s in found] == ["data.batch", "train.step", "train.micro_batch",
                                       "network.forward", "train.micro_batch",
                                       "network.forward"] * 2
    for k in (0, 6):
        assert found[k].parent is None and found[k + 1].parent is None
        assert found[k + 2].parent == found[k + 4].parent == k + 1
        assert {s.root for s in found[k + 1:k + 6]} == {found[k + 1].root}
        assert found[k].root != found[k + 1].root
    snap = profiling.snapshot()
    assert snap["train.step"]["count"] == 2 and snap["train.micro_batch"]["count"] == 4
    assert 0 < snap["train.step"]["host_self_s"] < snap["train.step"]["host_s"]
    counts = ec.pair_counts()  # autograd through the plain version: no backward's
    assert counts["gcl_agg"][0] > 0 and counts["gcl_agg_bwd"] == (0, 0)
