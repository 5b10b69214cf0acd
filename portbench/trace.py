"""A ``torch.profiler`` trace of a steady part of a traced run, read back
from its Chrome trace: the device's busy time, each port kernel's device
time, the rest (the glue), the device operations that took most time, and
the device's idle gaps by what the host was doing meanwhile.  The device
alone is traced for the numbers (recording every host operation as well
slows the host by a quarter and inflates the idle share); a short second
trace with the host's operations attributes the idle gaps.

Kernels are told apart by their function names (``gcl_agg_kernel``,
``coord_agg_cluster_kernel``, ...).  A library's helper kernels
(``add_partials``, ``reduce_partials_kernel``) belong to the kernel that
precedes them on their stream.
"""
from __future__ import annotations

import heapq
import json
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch

FAMILIES = ("gcl_agg_bwd", "coord_agg_bwd", "gcl_agg", "coord_agg", "block_phase")
HELPERS = ("add_partials", "reduce_partials_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


def family(name: str) -> Optional[str]:
    for fam in FAMILIES:
        if fam in name:
            return "block_fused" if fam == "block_phase" else fam
    return None


def short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width]


class DeviceTrace:
    """Start and stop around the traced part; ``summary`` after ``stop``."""

    def __init__(self, workdir, host: bool = False):
        self.workdir = Path(workdir)
        self.host = host
        self.prof = None
        self.summary: Optional[Dict] = None
        self.cuda = torch.cuda.is_available()

    def warm_up(self):
        """Start and stop the profiler once: its first start initialises the
        device tracer, which takes seconds (set-up, not the window)."""
        self.start()
        torch.ones(1, device="cuda" if self.cuda else "cpu").add_(1)
        self.stop()
        self.summary = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        if self.host and self.cuda:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        """Stop and read the trace back (in a traced run's window, which
        reports no end-to-end metric: exporting takes seconds, and a later
        profiler invalidates an earlier one's results)."""
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        path = self.workdir / "trace.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        self.summary = summarize(events, self.window_s)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[Dict], window_s: float) -> Dict:
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    kernel_s, ops = defaultdict(float), defaultdict(float)
    glue_s = 0.0
    last = {}  # stream -> family of the last port kernel
    for e in sorted(dev, key=lambda e: e["ts"]):
        dur = float(e.get("dur", 0.0)) * 1e-6
        name = e.get("name", "")
        stream = (e.get("pid"), e.get("tid"))
        fam = family(name)
        if fam is not None:
            last[stream] = fam
        elif any(h in name for h in HELPERS):
            fam = last.get(stream)
        if fam is None:
            glue_s += dur
        else:
            kernel_s[fam] += dur
        ops[short(name)] += dur
    merged = _merge([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                     for e in dev])
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps = defaultdict(float)
    host_sorted = sorted(host, key=lambda e: e["ts"])
    at_host, active = 0, []  # active: heap of (end, start, name) of host calls
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        while at_host < len(host_sorted) and host_sorted[at_host]["ts"] <= a1:
            e = host_sorted[at_host]
            heapq.heappush(active, (float(e["ts"]) + float(e.get("dur", 0.0)),
                                    float(e["ts"]), e.get("name", "")))
            at_host += 1
        while active and active[0][0] < a1:
            heapq.heappop(active)
        inner = max(active, key=lambda a: a[1])[2] if active else \
            "host outside any traced call"
        gaps[short(inner)] += (b0 - a1) * 1e-6
    return dict(busy_s=busy_s, window_s=window_s, glue_s=glue_s, kernel_s=dict(kernel_s),
                device_ops=sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:10],
                idle_gaps=sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10])
