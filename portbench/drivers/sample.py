"""Driver of the ``sample`` mixes: de-novo ligand generation, one call of
``LigandPocketDDPM.generate_ligands`` a request, as
``cli/generate_ligands.py`` calls it (one batch of ``n_samples``, the
largest fragment kept, no sanitising, no relaxation), one client sending
its requests back to back.

The requests go in order through the mix's pool: ``pockets`` pocket PDBs
(written at set-up, cycling through the mix's atom counts) with explicit
ligand sizes, all from the mix's seed, so that every run seed does the same
work.  The run seed draws the sampler's noise and the stages checked.

Correctness.  A T-step chain amplifies rounding, so the reference follows
the program's own chain stage by stage: for each request, from what the
program held at the start of a stage, and with the standard normal draw the
program consumed there, it recomputes the stage and compares the program's
result.  An edge whose squared length lies within float32 rounding of its
cutoff may fall on either side of it in the program and in the reference;
for a graph with one to three such pairs the reference takes the toggles of
them that bring its network output closest to the program's
(``ref_model.borderline``), since each is a sound reading of the cutoff.  Checked in every request: the prior draw (from the PDB file read by
the reference itself), ``steps_checked`` ancestral steps drawn from the run
seed, and the final decode against the sampler's output.  Two numbers, the
largest over the stages and the graphs: ``net_gap``, the gap between the
network's output in the program and in the reference (eps, in its own
units), and ``state_gap``, the gap between the stage's result in the
program and in the reference (normalized coordinates and features; Angstrom
and one-hot types at the decode).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench.drivers.common import TraceTaps, bucket, launch_gap
from portbench.gen import pockets as gen
from portbench.harness import ROOT
from portbench.reference import model as ref_model
from portbench.reference import pocket as ref_pocket
from portbench.reference import sampler as ref_sampler
from portbench.reference import schedule as ref_sched
from portbench.reference import weights as ref_weights


class SamplerTap:
    """Keeps, for the stages a request's check needs, the network's inputs
    and outputs (at call c: the state entering step c, or the decode at
    c = T), the standard normal draws (draw 0: the prior; draw c + 1: stage
    c's) and the sampler's output.  ``on_call(c)`` runs before each network
    call."""

    def __init__(self, ddpm, T: int):
        self.T = T
        self.records = []
        self.rec = None
        self.on_call = None
        self.spans = None
        self.hooks = (ddpm.dynamics.register_forward_pre_hook(self._pre),
                      ddpm.dynamics.register_forward_hook(self._post))
        self._gauss, self._sample = ddpm.sample_gaussian, ddpm.sample_given_pocket
        ddpm.sample_gaussian = self._gaussian
        ddpm.sample_given_pocket = self._sample_given_pocket

    def begin(self, request: int, steps) -> None:
        T = self.T
        self.want_in = {0, T} | set(steps) | {k + 1 for k in steps}
        self.want_noise = {0, T + 1} | {k + 1 for k in steps}
        self.rec = dict(request=request, steps=sorted(steps), inputs={}, outputs={},
                        noise={})
        self.call = self.draw = 0

    def _pre(self, module, args):
        if self.rec is None:
            return
        c = self.call
        self.call += 1
        if self.on_call is not None:
            self.on_call(c)
        if c in self.want_in:
            xh_lig, xh_pkt, t, m_l, m_p = args[:5]
            self.rec["inputs"][c] = (xh_lig.clone(), xh_pkt.clone(), t.clone())
            if c == 0:
                self.rec["masks"] = (m_l.clone(), m_p.clone())

    def _post(self, module, args, output):
        if self.rec is not None and self.call - 1 in self.want_in:
            self.rec["outputs"][self.call - 1] = output[0].clone()

    def _gaussian(self, generator, shape, mask):
        noise = self._gauss(generator, shape, mask)
        if self.rec is not None:
            if self.draw in self.want_noise:
                self.rec["noise"][self.draw] = noise.clone()
            self.draw += 1
        return noise

    def _sample_given_pocket(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._sample(*args, **kwargs)
        if self.spans is not None:
            if out[0].is_cuda:
                torch.cuda.synchronize()
            self.spans["sampler"].append(time.perf_counter() - t0)
        if self.rec is not None:
            self.rec["output"] = out[0].clone()
            self.records.append(self.rec)
            self.rec = None
        return out


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config["config"]
        self.mix = ctx.traffic
        self.cuda = ctx.device.type == "cuda"

    # ------------------------------------------------------------ set-up
    def setup(self):
        from diffsbdd_tpu_torch import checkpoint
        from diffsbdd_tpu_torch.ops import egnn_cuda as ec
        ctx, mix = self.ctx, self.mix
        self.ec = ec
        if self.cuda:
            ec.build_kernels(ctx.config["kernels"])
        weights = ROOT / ctx.config["weights"]["path"]
        ckpt = checkpoint.import_jax_npz(weights, ctx.workdir / "ckpt", overrides=self.cfg)
        self.module, _ = checkpoint.load_model(ckpt, device=ctx.device)
        self.T = mix["timesteps"] or self.cfg["diffusion_params"]["diffusion_steps"]
        pool = mix["pockets"]
        self.plan = gen.request_plan(mix, pool)
        self.pdbs, self.ref_ligand = gen.write_pockets(ctx.workdir / "pockets", mix,
                                                       self.plan)
        self.generator = torch.Generator(device=ctx.device).manual_seed(ctx.torch_seed(2))
        self.tap = SamplerTap(self.module.ddpm, self.T)
        self.spans = {"request": [], "sampler": []} if ctx.trace else None
        self.taps = TraceTaps(ec, self.module.ddpm.dynamics, ctx.workdir) if ctx.trace else None
        self._warm_up()

    def _generate(self, r: int, generator, timesteps=None):
        """Request ``r`` as the CLI makes it (``timesteps`` None: the mix's,
        whose null is the configuration's T)."""
        mix = self.mix
        req = self.plan[r % len(self.plan)]
        return self.module.generate_ligands(
            self.pdbs[r % len(self.pdbs)], mix["n_samples"], generator,
            ref_ligand=self.ref_ligand, num_nodes_lig=req["lig_sizes"],
            sanitize=mix["sanitize"], largest_frag=mix["largest_frag"],
            relax_iter=mix["relax_iter"], timesteps=timesteps or mix["timesteps"],
            resamplings=mix["resamplings"], jump_length=mix["jump_length"])

    def _warm_up(self):
        """Two steps and the decode at each padded shape the pool holds."""
        lig_bucket = self.cfg["tpu"]["lig_bucket"]
        pocket_bucket = self.cfg["tpu"]["pocket_bucket"]
        seen = set()
        warm = torch.Generator(device=self.ctx.device).manual_seed(self.ctx.torch_seed(9))
        for r, req in enumerate(self.plan):
            n_pocket = sum(1 for line in open(self.pdbs[r]) if line.startswith("ATOM"))
            shape = (bucket(max(req["lig_sizes"]), lig_bucket), bucket(n_pocket, pocket_bucket))
            if shape not in seen:
                seen.add(shape)
                self._generate(r, warm, timesteps=2)
        if self.cuda:
            torch.cuda.synchronize()

    # ------------------------------------------------------------ window
    def window(self, seconds: float):
        mix, T = self.mix, self.T
        ec = self.ec
        ec.reset_launch_counts()
        if self.spans is not None:
            self.tap.spans = self.spans
            first, last, host = mix["trace_passes"]
            first, last = min(first, T // 2), min(last, T)
            host = min(last + host, T)

            def on_call(c):
                if self.tap.rec["request"] != 0:
                    return
                if c == first:
                    self.taps.start()
                if c == last:
                    self.taps.stop()
                    self.traced_passes = last - first
                    self.taps.start_host()
                if c == host:
                    self.taps.stop_host()
            self.tap.on_call = on_call
        done = molecules = 0
        walls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            rng = np.random.default_rng([self.ctx.seed % 2 ** 64, 3, done])
            self.tap.begin(done, rng.choice(T, mix["steps_checked"], replace=False).tolist())
            t_req = time.perf_counter()
            molecules += len(self._generate(done, self.generator))
            walls.append(time.perf_counter() - t_req)
            if self.spans is not None:
                self.spans["request"].append(walls[-1])
            done += 1
        elapsed = time.perf_counter() - t0
        print("request walls (s): " + " ".join(f"{w:.3f}" for w in walls), file=sys.stderr)
        self.tap.on_call = None
        layers = self.cfg["egnn_params"]["n_layers"]
        per_request = {"gcl_agg": T * (layers + 2) + layers, "coord_agg": layers * (T + 1)}
        self.launch_gap = launch_gap(ec, {k: v * done for k, v in per_request.items()}
                                     if self.cuda else {}, self.ctx.config["tier"])
        self.done, self.molecules = done, molecules
        return {"molecules_per_s": mix["n_samples"] * done / elapsed}, done, 0

    # ------------------------------------------------------------ trace
    def record(self):
        rec = self.taps.record(self.cfg["egnn_params"], getattr(self, "traced_passes", 0),
                               "passes")
        self.taps.remove()
        spans = self.spans
        keep = slice(1, None) if len(spans["request"]) > 1 else slice(None)
        rec["spans"] = {k: v[keep] for k, v in spans.items()}
        rec["passes_per_request"] = self.T + 1
        return rec

    def release(self):
        del self.module, self.generator
        if self.cuda:
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def reference(self):
        cfg = self.cfg
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        P = ref_weights.from_npz(ROOT / self.ctx.config["weights"]["path"], self.ctx.device)
        net = ref_model.Net.from_config(cfg, joint=False)
        d = cfg["diffusion_params"]
        table = torch.as_tensor(ref_sched.gamma_table(
            d["diffusion_noise_schedule"], d["diffusion_steps"],
            d["diffusion_noise_precision"]), device=self.ctx.device)
        return P, net, table

    def _closest(self, stage, got_eps, z_in, pkt_in, ml, mp):
        """``stage(rows, flip)``'s results (its last: the network's output)
        for every graph, each graph with 1-3 borderline pairs at the toggles
        of them whose output lies closest to the program's ``got_eps``."""
        rows = slice(None)
        base = list(stage(rows, None))
        is_lig = torch.cat([torch.ones_like(ml), torch.zeros_like(mp)], 1)
        near = ref_model.borderline(torch.cat([z_in[..., :3], pkt_in[..., :3]], 1),
                                    torch.cat([ml, mp], 1), is_lig,
                                    ref_model.Net.from_config(self.cfg, False).cutoffs)
        counts = near.flatten(1).sum(1)
        self.borderline_graphs += int((counts > 0).sum())
        for g in torch.nonzero((counts > 0) & (counts <= 3)).flatten().tolist():
            pairs = near[g].nonzero().tolist()
            best = float(((base[-1][g] - got_eps[g]).abs() * ml[g][:, None]).max())
            for choice in range(1, 2 ** len(pairs)):
                flip = torch.zeros((1,) + near.shape[1:], device=near.device)
                for bit, (i, j) in enumerate(pairs):
                    if choice >> bit & 1:
                        flip[0, i, j] = flip[0, j, i] = 1
                alt = stage(slice(g, g + 1), flip)
                gap = float(((alt[-1][0] - got_eps[g]).abs() * ml[g][:, None]).max())
                if gap < best:
                    best = gap
                    for k, v in enumerate(alt):
                        if torch.is_tensor(v) and v.dim() and base[k].shape[0] > g:
                            base[k] = base[k].clone()
                            base[k][g] = v[0]
        return base

    def stages(self, rec, P, net, table, precision, admissible=False):
        """{"net_gap": [...], "state_gap": [...]}: (program's result, the
        reference's, mask) of each stage the record holds, the reference
        ``admissible`` to the program's readings of borderline edges; None
        where the program's shapes are not the reference's or a stage left no
        record (a stage that drew no noise)."""
        try:
            return self._stages(rec, P, net, table, precision, admissible)
        except KeyError:
            return None

    def _stages(self, rec, P, net, table, precision, admissible=False):
        cfg, T = self.cfg, self.T
        norm = cfg["diffusion_params"]["normalize_factors"]
        decoder = ref_pocket.DECODERS[cfg["dataset"]]
        encoder = {el: i for i, el in enumerate(decoder)}
        m_l, m_p = rec["masks"]
        B, NL = m_l.shape
        NP = m_p.shape[1]
        r = rec["request"]
        sizes = np.asarray(self.plan[r % len(self.plan)]["lig_sizes"])
        coords, types = ref_pocket.read(self.pdbs[r % len(self.pdbs)], self.ref_ligand, encoder)
        n = len(coords)
        dev = m_l.device
        if NL != bucket(sizes.max(), cfg["tpu"]["lig_bucket"]) \
                or NP != bucket(n, cfg["tpu"]["pocket_bucket"]):
            return None
        ml = torch.as_tensor(np.arange(NL)[None] < sizes[:, None], dtype=torch.float32,
                             device=dev)
        mp = torch.zeros(B, NP, device=dev)
        mp[:, :n] = 1
        pocket = torch.zeros(B, NP, 3 + len(decoder), device=dev)
        pocket[:, :n] = ref_sampler.normalize(
            torch.as_tensor(coords, device=dev),
            torch.nn.functional.one_hot(torch.as_tensor(types, device=dev), len(decoder)).float(),
            norm)
        if not (torch.equal(ml, m_l) and torch.equal(mp, m_p)):
            return None
        out = {"net_gap": [], "state_gap": []}
        z, pkt, _ = ref_sampler.prior(pocket, ml, mp, rec["noise"][0])
        got = rec["inputs"][0]
        out["state_gap"] += [(got[0], z, ml), (got[1][..., :3], pkt[..., :3], mp)]
        for k in rec["steps"]:
            z_in, pkt_in, t = rec["inputs"][k]
            noise = rec["noise"][k + 1]

            def stage(rows, flip):
                return ref_sampler.step(P, net, table, z_in[rows], pkt_in[rows], t[rows],
                                        ml[rows], mp[rows], noise[rows], T, precision, flip)
            z, pkt, _, eps = self._closest(stage, rec["outputs"][k], z_in, pkt_in, ml, mp) \
                if admissible else stage(slice(None), None)
            got = rec["inputs"][k + 1]
            out["net_gap"].append((rec["outputs"][k], eps, ml))
            out["state_gap"] += [(got[0], z, ml), (got[1][..., :3], pkt[..., :3], mp)]
        z_in, pkt_in, _ = rec["inputs"][T]
        noise = rec["noise"][T + 1]

        def stage(rows, flip):
            return ref_sampler.decode(P, net, table, z_in[rows], pkt_in[rows], ml[rows],
                                      mp[rows], noise[rows], norm, len(decoder), precision,
                                      flip)
        xh, _, eps = self._closest(stage, rec["outputs"][T], z_in, pkt_in, ml, mp) \
            if admissible else stage(slice(None), None)
        out["net_gap"].append((rec["outputs"][T], eps, ml))
        out["state_gap"].append((rec["output"], xh, ml))
        return out

    @staticmethod
    def gaps(stages_a, stages_b=None) -> dict:
        """The largest gap of each kind over the stages and graphs: the
        program's results against the reference's (``stages_b`` None), or
        two references' against each other."""
        if stages_a is None:
            return {"net_gap": float("inf"), "state_gap": float("inf")}
        out = {}
        for kind, rows in stages_a.items():
            worst = 0.0
            for i, (got, ref, mask) in enumerate(rows):
                a, b = (got, ref) if stages_b is None else (ref, stages_b[kind][i][1])
                worst = max(worst, float(((a - b).abs() * mask[..., None]).max()))
            out[kind] = worst
        return out

    def _worst(self, precision, against=None, admissible=False):
        P, net, table = self.reference()
        self.borderline_graphs = 0
        out = {"net_gap": 0.0, "state_gap": 0.0}
        for rec in self.tap.records:
            mine = self.stages(rec, P, net, table, precision, admissible)
            other = None if against is None else self.stages(rec, P, net, table, against)
            if mine is None or (against is not None and other is None):
                return {k: float("inf") for k in out}
            for k, v in self.gaps(mine, other).items():
                out[k] = max(out[k], v)
        if not self.tap.records:
            return {k: float("inf") for k in out}
        return out

    def check(self):
        out = self._worst("f32", admissible=True)
        out["launch_gap"] = self.launch_gap
        return out

    def control(self):
        """The control's readings: the reference at TF32 in the program's
        place, against the float32 reference, on this run's records."""
        return self._worst("tf32", against="f32")
