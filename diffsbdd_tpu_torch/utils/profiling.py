"""Profiling and timing utilities.

``device_trace`` records a ``torch.profiler`` trace of the host and the CUDA
card and writes it as a Chrome trace (viewable in Perfetto or
chrome://tracing); ``StepTimer`` times steps on the host clock, waiting for
the card to finish each step's work; ``PocketTimer`` keeps the wall time of
each pocket with the reference's report ('Time per pocket: mean \\pm std').

``span(name)`` marks a layer of the program (a sampler pass, the network, a
training step, a batch of the loader).  It records only while a profiler
records (``device_trace``, or any ``torch.profiler.profile``): then it enters
``record_function(name)``, so that the span lies in the profiler's trace on
the clock of the device's kernels, records a pair of CUDA events on the
current stream where the program uses CUDA, and keeps its host and device
times.  Otherwise it returns one shared null context and costs one attribute
read.  ``snapshot()`` sums the kept spans by name (with each span's self time:
its duration less its children's); ``reset()`` drops them.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(logdir="profile", name: str = "trace.json"):
    """Profile the enclosed work (host and, where there is one, the CUDA
    card) and write ``logdir/name`` as a Chrome trace.  Yields the
    ``torch.profiler.profile``; its ``key_averages()`` hold the sums by
    operation once the block has left."""
    from torch.profiler import ProfilerActivity, profile
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / name))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

_autograd_profiler = torch.autograd.profiler
_OFF = contextlib.nullcontext()
# [name, parent record, root, t0, t1, start event, end event, kept, device]
_records: List[list] = []
_free_events: Dict[int, list] = {}  # device -> CUDA events ready for reuse
_roots = itertools.count()
_local = threading.local()

# A range that a profiler stops inside must not be ended: torch ends a
# record_function with the callbacks it began with, and the stopped
# profiler's would write into the storage it freed (a crash later, at
# random).  So profiler stops are counted (torch calls _run_on_profiler_stop
# after each), and a span that saw one keeps its range open: the handle is
# held here and never ended, and the span is not kept.
_stops = [0]
_open_ranges: List = []
_run_on_profiler_stop = getattr(_autograd_profiler, "_run_on_profiler_stop", None)


def _count_profiler_stop():
    _stops[0] += 1
    _run_on_profiler_stop()


if _run_on_profiler_stop is not None:
    _autograd_profiler._run_on_profiler_stop = _count_profiler_stop


class Span(NamedTuple):
    """One kept span: ``parent`` its parent's index in ``spans()`` (None for
    a root), ``root`` the id its root span shares with every span below it
    (a request, a step, a batch), host times on ``time.perf_counter``."""

    name: str
    parent: Optional[int]
    root: int
    host_start: float
    host_end: float
    device_s: Optional[float]


def _event(device: int):
    pool = _free_events.setdefault(device, [])
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


class _Recorder:
    __slots__ = ("rec", "rf", "stops")

    def __init__(self, name: str):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        root = parent[2] if parent is not None else next(_roots)
        self.rec = [name, parent, root, 0.0, 0.0, None, None, False, None]
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        rec = self.rec
        self.stops = _stops[0]
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            rec[8] = device = torch.cuda.current_device()
            rec[5], rec[6] = _event(device), _event(device)
            rec[5].record()
        _local.stack.append(rec)
        _records.append(rec)
        rec[3] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[4] = time.perf_counter()
        if rec[6] is not None:
            rec[6].record()
        _local.stack.pop()
        if _stops[0] == self.stops:
            self.rf.__exit__(*exc)
            rec[7] = True
        else:  # kept whole or not at all: it may have missed its children
            _open_ranges.append(self.rf)
        return False


def span(name: str):
    """A context that marks one layer's work as ``name`` while a profiler
    records, and does nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recorder(name)


def _kept():
    return [r for r in _records if r[7]]


def spans() -> List[Span]:
    """The spans kept since the last ``reset()``, in the order they began
    (waits for the device once)."""
    kept = _kept()
    if any(r[5] is not None for r in kept):
        torch.cuda.synchronize()
    index = {id(r): k for k, r in enumerate(kept)}
    return [Span(r[0], None if r[1] is None else index.get(id(r[1])), r[2], r[3], r[4],
                 None if r[5] is None else r[5].elapsed_time(r[6]) * 1e-3)
            for r in kept]


def snapshot() -> Dict[str, Dict[str, Optional[float]]]:
    """The kept spans by name: ``count``, ``host_s`` and ``device_s`` (their
    summed durations), ``host_self_s`` and ``device_self_s`` (the same less
    the time their child spans cover) and ``device_self_median_s`` (the
    median span's).  The median is the typical span's where one span holds
    what is no work of the program: a caller that switches profilers inside
    a span (the benchmark's traced runs do, from the device trace to the host
    trace inside a sampler pass) adds that switch's export to the span.  The
    device times are None for a name with a span that recorded no CUDA
    events."""
    found = spans()
    host_child = [0.0] * len(found)
    dev_child = [0.0] * len(found)
    for s in found:
        if s.parent is not None:
            host_child[s.parent] += s.host_end - s.host_start
            dev_child[s.parent] += s.device_s or 0.0
    out: Dict[str, Dict[str, Optional[float]]] = {}
    dev_self: Dict[str, List[float]] = {}
    for k, s in enumerate(found):
        e = out.setdefault(s.name, dict(count=0, host_s=0.0, device_s=0.0,
                                        host_self_s=0.0, device_self_s=0.0))
        host = s.host_end - s.host_start
        e["count"] += 1
        e["host_s"] += host
        e["host_self_s"] += host - host_child[k]
        if s.device_s is None or e["device_s"] is None:
            e["device_s"] = e["device_self_s"] = None
        else:
            e["device_s"] += s.device_s
            e["device_self_s"] += s.device_s - dev_child[k]
            dev_self.setdefault(s.name, []).append(s.device_s - dev_child[k])
    for name, e in out.items():
        e["device_self_median_s"] = None if e["device_s"] is None \
            else float(np.median(dev_self[name]))
    return out


def reset() -> None:
    """Drop every span kept so far (the CUDA events of those that ended go
    back to the pool)."""
    for r in _records:
        if r[5] is not None and r[4]:
            _free_events.setdefault(r[8], []).extend((r[5], r[6]))
    _records.clear()


def _synchronize(result) -> None:
    """Wait for the device work behind ``result`` (a tensor or a nested
    dict, list or tuple of them) to finish."""
    devices = set()

    def visit(r):
        if isinstance(r, torch.Tensor):
            devices.add(r.device)
        elif isinstance(r, dict):
            for v in r.values():
                visit(v)
        elif isinstance(r, (list, tuple)):
            for v in r:
                visit(v)
    visit(result)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class StepTimer:
    """Host-clock step times that end when the step's result is computed on
    its device, and their running statistics."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() called before start()")
        if result is not None:
            _synchronize(result)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"mean_s": 0.0, "std_s": 0.0, "min_s": 0.0, "n": 0}
        arr = np.asarray(self.times)
        return {"mean_s": float(arr.mean()), "std_s": float(arr.std()),
                "min_s": float(arr.min()), "n": len(arr)}


class PocketTimer:
    """Wall time per pocket, written as '<pocket> <seconds>' lines and
    reported as the reference reports it."""

    def __init__(self):
        self.time_per_pocket: Dict[str, float] = {}
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, pocket_name: str) -> float:
        if self._t0 is None:
            raise RuntimeError("PocketTimer.stop() called before start()")
        dt = time.time() - self._t0
        self.time_per_pocket[str(pocket_name)] = dt
        return dt

    def write(self, path):
        with open(path, "w") as f:
            for k, v in self.time_per_pocket.items():
                f.write(f"{k} {v}\n")

    def report(self) -> str:
        times = np.array(list(self.time_per_pocket.values()))
        return f"Time per pocket: {times.mean():.3f} \\pm {times.std():.2f}"
