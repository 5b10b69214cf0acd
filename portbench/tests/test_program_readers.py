"""The readers of the metrics that read the program's own spans and pair
counters: None when nothing was recorded (or the program has no such
reader's source), the right value on a hand-built snapshot.  Run from the
repository root:

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import pytest

from diffsbdd_tpu_torch.ops import egnn_cuda as ec
from diffsbdd_tpu_torch.utils import profiling
from portbench import harness

YIELDS = {"gcl_agg_pair_yield.sample": "gcl_agg",
          "coord_agg_pair_yield.sample": "coord_agg",
          "gcl_agg_bwd_pair_yield.train": "gcl_agg_bwd",
          "coord_agg_bwd_pair_yield.train": "coord_agg_bwd"}
SPANS = {"sampler_self_ms_per_pass.sample": "sampler.pass",
         "trainer_self_ms_per_step.train": "train.step",
         "data_ms_per_step.train": "data.batch"}


def _span(count, host_s, device_s, self_median_s):
    return dict(count=count, host_s=host_s, device_s=device_s, host_self_s=host_s / 2,
                device_self_s=None if device_s is None else device_s / 2,
                device_self_median_s=self_median_s)


def test_every_program_metric_is_declared():
    declared = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    for name in list(YIELDS) + list(SPANS):
        assert declared[name]["workloads"] == [
            "cond-sample-n20" if name.endswith(".sample") else "joint-train-b16"]


@pytest.mark.parametrize("name", list(YIELDS))
def test_a_pair_yield_reads_the_kernels_counters(name, monkeypatch):
    counts = {k: (0, 0) for k in ec.KERNELS}
    monkeypatch.setattr(ec, "pair_counts", lambda: counts)
    assert harness.read_metric(name, {}) is None
    counts[YIELDS[name]] = (550, 1000)
    counts["block_fused"] = (1, 1000)
    assert harness.read_metric(name, {}) == pytest.approx(55.0)
    monkeypatch.delattr(ec, "pair_counts")  # a program without the counters
    assert harness.read_metric(name, {}) is None


@pytest.mark.parametrize("name", list(SPANS))
def test_a_span_metric_reads_the_snapshot(name, monkeypatch):
    snap = {}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert harness.read_metric(name, {}) is None
    snap["other"] = _span(3, 1.0, 1.0, 0.1)
    assert harness.read_metric(name, {}) is None
    # no CUDA events: only the host-clock metric reads
    snap[SPANS[name]] = _span(4, 0.006, None, None)
    want = 1.5 if name == "data_ms_per_step.train" else None
    assert harness.read_metric(name, {}) == (None if want is None else pytest.approx(want))
    snap[SPANS[name]] = _span(4, 0.006, 0.008, 0.0007)
    want = 1.5 if name == "data_ms_per_step.train" else 0.7
    assert harness.read_metric(name, {}) == pytest.approx(want)
    monkeypatch.delattr(profiling, "snapshot")  # a program without the spans
    assert harness.read_metric(name, {}) is None
