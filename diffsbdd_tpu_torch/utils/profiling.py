"""Profiling and timing utilities.

``device_trace`` records a ``torch.profiler`` trace of the host and the CUDA
card and writes it as a Chrome trace (viewable in Perfetto or
chrome://tracing); ``StepTimer`` times steps on the host clock, waiting for
the card to finish each step's work; ``PocketTimer`` keeps the wall time of
each pocket with the reference's report ('Time per pocket: mean \\pm std').
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional

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
