"""Driver of the ``train`` mixes: optimizer steps of the port's training
loop (``train.loop.make_train_step``: the configuration's micro-batches,
gradient clipping and AmsgradW) on batches from the port's own loader
(``data.dataset``) over a synthetic processed set written at set-up.

The mix's seed draws the set (sizes, coordinates, types), the same for every
run seed; the run seed draws the data order, the weights (on the device, in
one draw) and the loss's timesteps and noise.

Correctness.  Set-up builds the one training object and drives it through
its first ``steps_checked`` steps, through the same call and loader as the
window, keeping the batches, the timesteps and the normal draws the loss
consumed, the losses, the first gradient as the optimizer got it (its first
moment after one step over 1 - beta1) and the weights after the last; the
window goes on from there.  The reference follows the same steps from the
same weights.  Compared: the relative gap of each step's loss (the worst
step); the gap between the program's and the reference's norm of each
leaf's first gradient (the worst leaf) and of each leaf's change over the
steps (the median leaf), over the larger of that leaf's reference norm and
the median leaf's.  Leaves whose reference gradient is under a thousandth
of the median leaf's move by round-off alone and are left out of the
change.  The change is taken by the median leaf: on some seeds one leaf
whose first gradient lies largely under AmsgradW's eps (1e-8) turns the
round-off of those elements into a change gap some hundred times the other
seeds' (``control.py`` prints the worst leaves).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.drivers.common import TraceTaps, launch_gap, merge
from portbench.gen import dataset as gen
from portbench.reference import joint as ref_joint
from portbench.reference import model as ref_model
from portbench.reference import pocket as ref_pocket
from portbench.reference import schedule as ref_sched
from portbench.reference import weights as ref_weights

FIELDS = ("x", "one_hot", "mask", "size")


class DrawTap:
    """Records the loss's timestep and normal draws while ``on``."""

    def __init__(self, ddpm):
        self.ddpm = ddpm
        self._t, self._g = ddpm.sample_timesteps, ddpm.sample_gaussian
        self.draws = []  # per loss call: [t (b, 1), normal draws...]
        ddpm.sample_timesteps, ddpm.sample_gaussian = self._timesteps, self._gaussian

    def _timesteps(self, generator, batch_size, lowest_t):
        t = self._t(generator, batch_size, lowest_t)
        self.draws.append([t.clone()])
        return t

    def _gaussian(self, generator, shape, mask):
        noise = self._g(generator, shape, mask)
        self.draws[-1].append(noise.clone())
        return noise

    def remove(self):
        del self.ddpm.sample_timesteps, self.ddpm.sample_gaussian


def change_gaps(end, P0, ref) -> dict:
    """Per moved leaf: the gap between the program's and the reference's
    norm of its change from ``P0``, over the larger of its reference norm
    and the median leaf's."""
    _, ref_first, ref_end = ref
    g_ref = {k: float(v.norm()) for k, v in ref_first.items()}
    g_med = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: float((ref_end[k] - P0[k]).norm()) for k in moved}
    d_med = float(np.median(list(d_ref.values())))
    return {k: abs(float((end[k] - P0[k]).norm()) - d_ref[k]) / max(d_ref[k], d_med)
            for k in moved}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.traffic
        self.cuda = ctx.device.type == "cuda"

    # ------------------------------------------------------------ set-up
    def setup(self):
        from diffsbdd_tpu_torch.config import load_config
        from diffsbdd_tpu_torch.data.dataset import (LigandPocketDataset, PaddedLoader,
                                                     load_size_histogram)
        from diffsbdd_tpu_torch.ops import egnn_cuda as ec
        from diffsbdd_tpu_torch.train.loop import (batch_to_device, create_train_state,
                                                   make_train_step)
        from diffsbdd_tpu_torch.train.module import build_module_from_config
        ctx, mix = self.ctx, self.mix
        self.ec, self.to_device = ec, batch_to_device
        if self.cuda:
            ec.build_kernels(ctx.config["kernels"])
        decoder = ref_pocket.DECODERS[ctx.config["config"]["dataset"]]
        datadir = gen.write(ctx.workdir / "data", mix, len(decoder))
        self.cfg_dict = merge(ctx.config["config"], {"datadir": str(datadir),
                                                     "logdir": str(ctx.workdir / "runs")})
        cfg = self.cfg = load_config(overrides=self.cfg_dict)
        module = build_module_from_config(cfg, load_size_histogram(datadir)).to(ctx.device)
        e = self.cfg_dict["egnn_params"]
        self.leaves = ref_weights.specs(len(decoder), len(decoder), e["joint_nf"],
                                        e["hidden_nf"], e["n_layers"], e["attention"],
                                        not e["reflection_equivariant"])
        weights = torch.Generator(device=ctx.device).manual_seed(ctx.torch_seed(4))
        self.P0 = ref_weights.seeded(self.leaves, weights, ctx.device)
        module.load_state_dict(ref_weights.tied_keys(self.P0), strict=True)
        self.module = module.train()
        self.state = create_train_state(module, lr=cfg.lr)
        self.k_acc = int(cfg.get("accumulate_grad_batches", 1))
        self.step = make_train_step(self.state, cfg.clip_grad,
                                    accumulate_grad_batches=self.k_acc)
        self.loader = PaddedLoader(
            LigandPocketDataset(datadir / "train.npz"), cfg.batch_size, shuffle=True,
            lig_bucket=cfg.tpu.lig_bucket, pocket_bucket=cfg.tpu.pocket_bucket,
            rng=ctx.rng(2))
        self.batches = iter(self.loader)
        self.generator = torch.Generator(device=ctx.device).manual_seed(ctx.torch_seed(3))
        self.spans = {"loader": []} if ctx.trace else None
        self._first_steps()
        self.taps = TraceTaps(ec, module.ddpm.dynamics, ctx.workdir) if ctx.trace else None

    def _next(self):
        t0 = time.perf_counter()
        try:
            batch = next(self.batches)
        except StopIteration:
            self.batches = iter(self.loader)
            batch = next(self.batches)
        if self.spans is not None:
            self.spans["loader"].append(time.perf_counter() - t0)
        return batch

    def _run_step(self, batch):
        return self.step(self.generator, self.to_device(batch["ligand"], self.ctx.device),
                         self.to_device(batch["pocket"], self.ctx.device))

    def _first_steps(self):
        """The training object's first steps, with what the check needs."""
        tap = DrawTap(self.module.ddpm)
        names = [n for n, _ in self.module.named_parameters()]
        opt = self.state.optimizer
        self.kept, self.losses = [], []
        for i in range(self.mix["steps_checked"]):
            batch = self._next()
            self.kept.append({part: {k: torch.as_tensor(batch[part][k], device=self.ctx.device)
                                     for k in FIELDS} for part in ("ligand", "pocket")})
            info = self._run_step(batch)
            self.losses.append(float(info["loss"]))
            if i == 0:
                self.g1 = {n: (m / (1 - opt.b1)).clone() for n, m in zip(names, opt.mu)}
        self.p_end = {n: p.detach().clone() for n, p in self.module.named_parameters()}
        tap.remove()
        self.draws = tap.draws
        if self.cuda:
            torch.cuda.synchronize()

    # ------------------------------------------------------------ window
    def window(self, seconds: float):
        ec = self.ec
        ec.reset_launch_counts()
        first, last, host = self.mix["trace_steps"]
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if self.taps is not None and done == first:
                self.taps.start()
            batch = self._next()
            self._run_step(batch)
            done += 1
            if self.taps is not None and done == last:
                self.taps.stop()
                self.taps.start_host()
            if self.taps is not None and done == last + host:
                self.taps.stop_host()
        if self.cuda:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        if self.taps is not None and self.taps.active:
            self.taps.stop()
        if self.taps is not None:
            self.taps.stop_host()
        self.traced_steps = max(0, min(done, last) - first)
        layers = self.cfg_dict["egnn_params"]["n_layers"]
        per_step = layers * self.k_acc
        expected = {k: per_step * done for k in ("gcl_agg", "coord_agg", "gcl_agg_bwd",
                                                 "coord_agg_bwd")}
        self.launch_gap = launch_gap(ec, expected if self.cuda else {},
                                     self.ctx.config["tier"])
        batch = self.cfg.batch_size
        return {"complexes_per_s": batch * done / elapsed}, done, 0

    def record(self):
        rec = self.taps.record(self.cfg_dict["egnn_params"], self.traced_steps, "steps")
        self.taps.remove()
        rec["spans"] = self.spans
        return rec

    def release(self):
        del self.module, self.state, self.step, self.generator
        if self.cuda:
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def follow(self, precision="f32", half_batch=False):
        """The reference's losses, first gradients and end weights over the
        kept steps; ``half_batch``: each micro-batch's loss over its first
        half only (a fault's reading)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = self.cfg_dict
        d = c["diffusion_params"]
        table = torch.as_tensor(ref_sched.gamma_table(
            d["diffusion_noise_schedule"], d["diffusion_steps"], d["diffusion_noise_precision"]),
            device=self.ctx.device)
        net = ref_model.Net.from_config(c, joint=c["mode"] == "joint")
        micro = self.cfg.batch_size // self.k_acc
        if len(self.draws) != len(self.kept) * self.k_acc or any(
                len(d) != 5 or d[0].shape[0] != micro for d in self.draws):
            raise ValueError("the loss drew other timesteps or noise than one "
                             "micro-batch of the configured size a call")
        draws = []
        for s in range(len(self.kept)):
            calls = self.draws[s * self.k_acc:(s + 1) * self.k_acc]
            draws.append([(t[:, 0].round().long(), noise) for t, *noise in calls])
        batches = [(b["ligand"], b["pocket"]) for b in self.kept]
        if half_batch:
            keep = torch.cat([torch.arange(i * micro, i * micro + micro // 2)
                              for i in range(self.k_acc)]).to(self.ctx.device)
            batches = [({k: v[keep] for k, v in lig.items()}, {k: v[keep] for k, v in pkt.items()})
                       for lig, pkt in batches]
            draws = [[(t[:micro // 2], [x[:micro // 2] for x in noise]) for t, noise in step]
                     for step in draws]
        return ref_joint.train_steps(self.P0, net, table, d["diffusion_steps"], batches, draws,
                                     c["lr"], self.k_acc, d["normalize_factors"], precision)

    @staticmethod
    def gaps(losses, first, end, P0, ref) -> dict:
        ref_losses, ref_first, ref_end = ref
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        g_ref = {k: float(v.norm()) for k, v in ref_first.items()}
        g_med = float(np.median(list(g_ref.values())))
        grad_gap = max(abs(float(first[k].norm()) - g_ref[k]) / max(g_ref[k], g_med)
                       for k in g_ref)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "median_change_gap": float(np.median(list(change_gaps(end, P0, ref).values())))}

    def check(self):
        try:
            ref = self.follow()
        except ValueError:
            inf = float("inf")
            return {"loss_gap": inf, "grad_gap": inf, "median_change_gap": inf,
                    "launch_gap": self.launch_gap}
        out = self.gaps(self.losses, self.g1, self.p_end, self.P0, ref)
        out["launch_gap"] = self.launch_gap
        return out
