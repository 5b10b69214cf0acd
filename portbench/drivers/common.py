"""What the drivers share: the configuration as the program gets it, the
launch-count check, and the traced run's taps (the kernels' launches with
the pairs inside their cutoffs, the network's calls with their valid
nodes), which exist only in a traced run."""
from __future__ import annotations

import copy
from typing import Dict, List

import torch

from portbench import work
from portbench.trace import DeviceTrace

KERNELS = ("gcl_agg", "coord_agg", "gcl_agg_bwd", "coord_agg_bwd", "block_fused")


def merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) \
            else copy.deepcopy(v)
    return out


def bucket(n: int, size: int) -> int:
    """Smallest multiple of ``size`` >= n (at least ``size``)."""
    return max(-(-int(n) // size) * size, size)


def launch_gap(ec, expected: Dict[str, int], tier: str) -> float:
    """How far the window's launches are from the cell's: every kernel at
    the configured tier as often as expected, none at another tier."""
    gap = 0
    for key, count in ec.tier_launch_counts.items():
        name, _, at = key[:-1].partition("[")
        want = expected.get(name, 0) if at == tier else 0
        gap += abs(int(count) - int(want))
    return float(gap)


class TraceTaps:
    """The traced part of a run: the profiler (the device alone, then the
    host as well for a short part after it), every split-kernel launch
    (shapes and inputs kept, pairs counted after the trace) and every call
    of the network with its valid nodes."""

    def __init__(self, ec, dynamics: torch.nn.Module, workdir):
        self.ec = ec
        self.device_trace = DeviceTrace(workdir)
        self.device_trace.warm_up()
        self.host_trace = DeviceTrace(workdir, host=True)
        self.active = False
        self.calls: List[tuple] = []
        self.nodes: List[tuple] = []
        self.orig = (ec.gcl_message_agg, ec.coord_update_agg)
        gcl_fn, coord_fn = self.orig

        def gcl(a_row, a_col, x, x0, mask, is_lig, *rest, **kw):
            if self.active:
                self._keep("gcl_agg", 1, a_row, x0, mask, is_lig, kw)
            return gcl_fn(a_row, a_col, x, x0, mask, is_lig, *rest, **kw)

        def coord(a_row, a_col, x, x0, mask, is_lig, *rest, **kw):
            if self.active:
                self._keep("coord_agg", 1 if kw.get("cross") is None else 2, a_row, x0,
                           mask, is_lig, kw)
            return coord_fn(a_row, a_col, x, x0, mask, is_lig, *rest, **kw)

        ec.gcl_message_agg, ec.coord_update_agg = gcl, coord
        self.hook = dynamics.register_forward_pre_hook(self._net_call)

    def _keep(self, kernel, n_mlp, a_row, x0, mask, is_lig, kw):
        grad = torch.is_grad_enabled() and a_row.requires_grad
        self.calls.append((kernel, n_mlp, tuple(a_row.shape), x0, mask, kw.get("col_mask"),
                           is_lig, tuple(kw["cutoffs"]), kw.get("update_rows"), grad))

    def _net_call(self, module, args):
        if self.active:
            xh_lig, xh_pkt, _, m_l, m_p = args[:5]
            self.nodes.append((m_l, m_p, xh_lig.shape[-1] - 3, xh_pkt.shape[-1] - 3,
                               torch.is_grad_enabled()))

    def start(self):
        self.device_trace.start()
        self.active = True

    def stop(self):
        self.active = False
        self.device_trace.stop()

    def start_host(self):
        self.host_trace.start()

    def stop_host(self):
        if self.host_trace.prof is not None:
            self.host_trace.stop()

    def remove(self):
        self.ec.gcl_message_agg, self.ec.coord_update_agg = self.orig
        self.hook.remove()

    def launches(self) -> List[work.Launch]:
        out = []
        for kernel, n_mlp, shape, x0, mask, col_mask, is_lig, cut, rows, grad in self.calls:
            B, N, F = shape
            pairs = int(work.count_pairs(x0, mask, col_mask, is_lig, cut, rows))
            rows_out = N if rows is None else int(rows)
            out.append(work.Launch(kernel, B, N, F, rows_out, n_mlp, pairs))
            if grad:
                out.append(work.Launch(kernel + "_bwd", B, N, F, rows_out, n_mlp, pairs))
        return out

    def record(self, egnn: Dict, units: int, unit: str) -> Dict:
        """What the per-layer readers read: the trace's sums, each kernel's
        least time over its launches, the model's operations, over
        ``units`` passes or steps."""
        summary = dict(self.device_trace.summary or {})
        if self.host_trace.summary is not None and summary:
            summary["idle_gaps"] = self.host_trace.summary["idle_gaps"]
        launches = self.launches()
        least: Dict[str, float] = {}
        model_flops = 0.0
        for launch in launches:
            least[launch.kernel] = least.get(launch.kernel, 0.0) + launch.least_s()
            if not launch.kernel.endswith("_bwd"):
                model_flops += work.pair_flops(launch)
        for m_l, m_p, atom_nf, residue_nf, grad in self.nodes:
            n_lig, n_pkt = float(m_l.sum()), float(m_p.sum())
            model_flops += work.node_flops(n_lig + n_pkt, n_lig, n_pkt, atom_nf, residue_nf,
                                           egnn["joint_nf"], egnn["hidden_nf"],
                                           egnn["n_layers"],
                                           cross=not egnn["reflection_equivariant"])
        if any(n[-1] for n in self.nodes):  # a training step: the backward's products
            model_flops *= 3
        return {"trace": summary or None, "kernel_least_s": least,
                "model_flops": model_flops, unit: units}

