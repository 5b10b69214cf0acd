#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases (any failure ends the run with a non-zero exit code):
  1. the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch twin at the flagship shapes
     (B=16, NL=24, NP=300 padded to 320, F=256, cutoffs None/5/5, attention
     and the cross branch on) and at the shared-pocket variants (col_mask,
     update_rows, B=1), with CUDA-event times of kernel and twin;
  4. import checkpoints/synth_quality_r05c_best.npz (hidden 256, 6 layers,
     joint_nf 128) into a port checkpoint;
  5. write a seeded synthetic full-atom pocket PDB;
  6. the main path: the port's cli.generate_ligands, 16 samples of 24 atoms,
     T=500 -- the launch counters must show every kernel on that path;
     then a profile of a 5-step chain on the same inputs (device time by
     kernel, device idle share);
  7. correctness of the sampler end to end on a small input: the fixture
     checkpoint sampled on the card (kernels) and on the CPU (plain twins)
     with the same injected noise must agree.

Prints a {"kernels": [...]} line and the card line, and as its last line
{"ok": true, "device": {...}}.  The pocket, the samples and a summary.json go
to ``--out`` (default chip_smoke_out/ in the repository).  Needs a CUDA card:
exits non-zero without one, and without the repository around it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# the flagship checkpoint (hidden 256, 6 layers, joint_nf 128, T = 500) and
# the small fixture (hidden 64, 3 layers) sampled at T = 10 for the
# card-vs-CPU check; their configs come from snapshot_config
R05C_NPZ = REPO / "checkpoints" / "synth_quality_r05c_best.npz"
FIXTURE_NPZ = REPO / "checkpoints" / "overfit_chem_fixture_best.npz"
FIXTURE_T = 10

# H100 SXM data-sheet peaks: f32 on the CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# residue templates: (name, [(atom name, element), ...])
_RESIDUES = [
    ("GLY", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O")]),
    ("ALA", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C")]),
    ("SER", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("OG", "O")]),
    ("CYS", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("SG", "S")]),
    ("THR", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("OG1", "O"), ("CG2", "C")]),
    ("ASP", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("CG", "C"), ("OD1", "O"), ("OD2", "O")]),
    ("MET", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("CG", "C"), ("SD", "S"), ("CE", "C")]),
    ("LYS", [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"),
             ("CG", "C"), ("CD", "C"), ("CE", "C"), ("NZ", "N")]),
]


def pocket_atoms(n_atoms: int, seed: int):
    """Residues placed around the origin (centres 4.5-9.5 A out, atoms within
    1.5 A of their centre) until at least ``n_atoms`` atoms, plus a 12-atom
    ligand within 2 A of the origin.  Returns (residues, ligand) as lists of
    (resname, [(name, element, xyz)]) and [(name, element, xyz)]."""
    rng = np.random.default_rng(seed)
    residues, count = [], 0
    while count < n_atoms:
        name, atoms = _RESIDUES[rng.integers(len(_RESIDUES))]
        d = rng.standard_normal(3)
        centre = d / np.linalg.norm(d) * rng.uniform(4.5, 9.5)
        placed = [(a, el, centre + rng.uniform(-1.5, 1.5, 3) / np.sqrt(3))
                  for a, el in atoms]
        residues.append((name, placed))
        count += len(placed)
    ligand = [(f"{el}{k}", el, rng.uniform(-1.0, 1.0, 3) * 2.0 / np.sqrt(3))
              for k, el in enumerate(["C"] * 8 + ["N"] * 2 + ["O"] * 2)]
    return residues, ligand


def write_pocket_pdb(path, n_atoms: int = 300, seed: int = 0) -> str:
    """Write a synthetic full-atom pocket (chain A, residues 1..n) and its
    ligand (HETATM LIG A:900) as PDB; returns the ligand's '<chain>:<resi>'."""
    residues, ligand = pocket_atoms(n_atoms, seed)
    lines, serial = [], 1

    def record(rec, name, resname, resseq, xyz, el):
        nonlocal serial
        field = name if len(name) == 4 else f" {name:<3}"
        lines.append(f"{rec:<6}{serial:5d} {field} {resname:>3} A{resseq:4d}    "
                     f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00"
                     f"          {el:>2}")
        serial += 1

    for resseq, (resname, atoms) in enumerate(residues, start=1):
        for name, el, xyz in atoms:
            record("ATOM", name, resname, resseq, xyz, el)
    for name, el, xyz in ligand:
        record("HETATM", name, "LIG", 900, xyz, el)
    Path(path).write_text("\n".join(lines + ["END"]) + "\n")
    return "A:900"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(ec, torch, dev, flagship):
    """Phase 3: kernels vs plain twins at the flagship shapes."""
    B, NL, NP_PAD = 16, 24, 320
    F = flagship["egnn_params"]["hidden_nf"]
    N = NL + NP_PAD
    cut = tuple(flagship["egnn_params"][k] for k in (
        "edge_cutoff_ligand", "edge_cutoff_pocket", "edge_cutoff_interaction"))
    residues, _ = pocket_atoms(300, seed=0)
    pk = np.array([xyz for _, atoms in residues for _, _, xyz in atoms],
                  np.float32)[:300]
    g = torch.Generator().manual_seed(0)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    x0 = torch.zeros(B, N, 3)
    x0[:, :NL] = torch.randn((B, NL, 3), generator=g) * 1.5
    x0[:, NL:NL + 300] = torch.as_tensor(pk)
    x0 = x0.to(dev)
    x = x0 + r(B, N, 3, scale=0.2)
    mask = torch.zeros(B, N, device=dev)
    mask[:, :NL + 300] = 1.0
    is_lig = torch.zeros(B, N, device=dev)
    is_lig[:, :NL] = 1.0
    # weight scales of a trained layer (fan-in normalized)
    s = F ** -0.5
    gcl_w = dict(w_d2=r(F, scale=0.05), w_d20=r(F, scale=0.05), type_bias=None,
                 w2=r(F, F, scale=s), b2=r(F, scale=0.1),
                 w_att=r(F, 1, scale=s), b_att=r(1, scale=0.1))
    a_row, a_col = r(B, N, F, scale=0.5), r(B, N, F, scale=0.5)
    pkt, lig = mask * (1 - is_lig), mask * is_lig

    def gcl_call(fn, variant):
        kw = dict(cutoffs=cut, attention=True, normalization_factor=100.0)
        if variant == "full":
            return fn(a_row, a_col, x, x0, mask, is_lig, *gcl_w.values(), **kw)
        if variant == "pocket_pocket_b1":
            return fn(a_row[:1], a_col[:1], x[:1], x0[:1], pkt[:1], is_lig[:1],
                      *gcl_w.values(), col_mask=pkt[:1], **kw)
        if variant == "pocket_ligand":
            return fn(a_row, a_col, x, x0, pkt, is_lig, *gcl_w.values(),
                      col_mask=lig, **kw)
        return fn(a_row, a_col, x, x0, lig, is_lig, *gcl_w.values(),
                  col_mask=mask, update_rows=NL, **kw)

    w3 = r(F, 1, scale=s)
    cross = dict(a_row=r(B, N, F, scale=0.5), a_col=r(B, N, F, scale=0.5),
                 w_d2=r(F, scale=0.05), w_d20=r(F, scale=0.05), type_bias=None,
                 w2=r(F, F, scale=s), b2=r(F, scale=0.1), w3=w3)
    graph_mean = (x * mask[..., None]).sum(1) / mask.sum(1)[:, None]
    coord_w = (r(F, scale=0.05), r(F, scale=0.05), None, r(F, F, scale=s),
               r(F, scale=0.1), w3)

    def coord_call(fn, variant):
        kw = dict(cutoffs=cut, tanh=True, coords_range=15.0, norm_constant=1.0,
                  normalization_factor=100.0, update_rows=NL)
        if variant == "ligand_rows_cross":
            return fn(a_row, a_col, x, x0, mask, is_lig, *coord_w, cross=cross,
                      graph_mean=graph_mean, **kw)
        return fn(a_row, a_col, x, x0, mask, is_lig, *coord_w, **kw)

    # tolerance: float32 both sides, pairs summed in another order
    tol = dict(atol=1e-5, rtol=1e-4)
    results, variant_ms = {}, {}
    for name, call, plain, kern, variants in (
            ("gcl_agg", gcl_call, ec.gcl_message_agg_plain, ec.gcl_message_agg,
             ["full", "pocket_pocket_b1", "pocket_ligand", "ligand_rows"]),
            ("coord_agg", coord_call, ec.coord_update_agg_plain,
             ec.coord_update_agg, ["ligand_rows_cross", "ligand_rows_nocross"])):
        worst = 0.0
        for v in variants:
            got = call(kern, v)
            ref = call(plain, v)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            bad = float(((got - ref).abs() - (tol["atol"] + tol["rtol"] * ref.abs())).max())
            print(f"  {name}[{v}] shape={tuple(got.shape)} max_abs_err={err:.3e} "
                  f"(atol {tol['atol']} + rtol {tol['rtol']}) "
                  f"ref_max={float(ref.abs().max()):.3e}")
            _check(bad <= 0.0, f"{name}[{v}] disagrees with its plain twin")
            worst = max(worst, err)
            variant_ms[f"{name}[{v}]"] = _cuda_ms(lambda: call(kern, v), 20)
            print(f"  {name}[{v}] kernel {variant_ms[f'{name}[{v}]']:.4f} ms")
        v = variants[0]
        ms = _cuda_ms(lambda: call(kern, v), 50)
        plain_ms = _cuda_ms(lambda: call(plain, v), 3)
        # the bound: operations and bytes this input needs
        adj = ec.adjacency_dense(((x0[:, :, None] - x0[:, None]) ** 2).sum(-1),
                                 mask, is_lig, cut)
        if name == "coord_agg":
            adj = adj[:, :NL]  # update_rows = NL
        pairs = int((adj > 0).sum())
        n_mlp = 1 if name == "gcl_agg" else 2
        rows_out = N if name == "gcl_agg" else NL
        flops = pairs * n_mlp * (2 * F * F + 10 * F)
        bytes_ = 4 * (n_mlp * (2 * B * N * F + F * F + 4 * F) + B * N * 11
                      + B * rows_out * (F if name == "gcl_agg" else 3))
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, bytes_ / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= bytes_ / PEAK_BYTES \
            else "bytes"
        print(f"  {name}[{v}] kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
              f"active pairs {pairs}, {flops / 1e9:.2f} GFLOP, bound {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.1f}% of f32 peak")
        results[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    return results, variant_ms


def profile_phase(torch, module, pocket_pdb, ref_lig, n_samples, steps=5):
    """Device time by kernel over a short chain (prior, ``steps`` denoise
    steps, decode) on the main path's inputs, and the device's idle share of
    the wall time (under the profiler, which adds host overhead)."""
    from torch.profiler import ProfilerActivity, profile
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pocket_pdb), ref_lig)
    pocket = module.prepare_pocket(residues, repeats=n_samples)
    lig_mask = torch.ones(n_samples, 24, device=pocket["x"].device)
    gen = torch.Generator(device=pocket["x"].device).manual_seed(1)
    module.ddpm.sample_given_pocket(gen, pocket, lig_mask, timesteps=2,
                                    shared_pocket=True)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        module.ddpm.sample_given_pocket(gen, pocket, lig_mask, timesteps=steps,
                                        shared_pocket=True)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    # device-side events only (kernels, copies): CPU ops also carry the
    # device time of the kernels they launch
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if not events:
        print("  the profiler recorded no device time: breakdown not measured")
        return None
    events.sort(key=lambda e: -e.self_device_time_total)
    print(f"  {steps} steps + prior + decode: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    top = []
    for e in events[:8]:
        share = e.self_device_time_total / busy_us
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {share:6.1%} "
              f"x{e.count:<5d} {e.key[:70]}")
        top.append(dict(name=e.key, ms=e.self_device_time_total / 1e3,
                        count=e.count))
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                idle_share=1 - busy_us / wall_us, top=top)


def small_reference_phase(torch, dev, work):
    """Phase 7: the fixture model sampled on the card (kernels) and on the
    CPU (plain twins) from the same injected noise must agree."""
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    ckpt = import_jax_npz(FIXTURE_NPZ, work / "fixture",
                          {"diffusion_params": {"diffusion_steps": FIXTURE_T}})
    pdb = work / "small.pdb"
    ref_lig = write_pocket_pdb(pdb, n_atoms=60, seed=1)
    B, NL, T = 2, 8, FIXTURE_T
    rng = np.random.default_rng(0)
    noise = [rng.standard_normal((B, NL, 3 + 11)).astype(np.float32)
             for _ in range(T + 2)]
    outs = {}
    for d in (dev, torch.device("cpu")):
        module, _ = load_model(ckpt, device=d)
        queue = list(noise)
        module.ddpm.sample_gaussian = lambda g, shape, mask, q=queue: \
            torch.as_tensor(q.pop(0), device=mask.device) * mask[..., None]
        residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pdb), ref_lig)
        pocket = module.prepare_pocket(residues, repeats=B)
        lig_mask = torch.ones(B, NL, device=d)
        lig_mask[1, 6:] = 0.0
        xh, _ = module.ddpm.sample_given_pocket(None, pocket, lig_mask,
                                                shared_pocket=True)
        outs[d.type] = xh.cpu().numpy()
    a, b = outs["cuda"], outs["cpu"]
    dev_x = float(np.abs(a[..., :3] - b[..., :3]).max())
    flips = int((a[..., 3:].argmax(-1) != b[..., 3:].argmax(-1)).sum())
    print(f"  fixture T={T}: card vs CPU max coordinate deviation {dev_x:.3e} A, "
          f"{flips} atom-type flips (limit 1e-3 A, 0 flips)")
    _check(np.isfinite(a).all(), "non-finite samples on the card")
    _check(dev_x <= 1e-3 and flips == 0, "card and CPU samplers disagree")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=REPO / "chip_smoke_out",
                        help="directory for the pocket, samples and summary")
    out = parser.parse_args(argv).out
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsbdd_tpu_torch.cli import generate_ligands as cli
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
    from diffsbdd_tpu_torch.config import snapshot_config
    from diffsbdd_tpu_torch.diffusion.ddpm import ConditionalDDPM
    from diffsbdd_tpu_torch.ops import egnn_cuda as ec
    from diffsbdd_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    out.mkdir(parents=True, exist_ok=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    print("[1] card")
    card = _card_line()
    print(card)

    print("[2] build")
    t0 = time.perf_counter()
    logs = ec.build_kernels(force=True)
    print(f"  built {', '.join(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line:
                print(f"  {name}: {line.strip()}")

    print("[3] kernels vs plain twins at the flagship shapes")
    flagship = snapshot_config(R05C_NPZ)
    kres, variant_ms = kernel_phase(ec, torch, dev, flagship)

    with tempfile.TemporaryDirectory(dir=out) as tmp:
        work = Path(tmp)
        print("[4] import checkpoints/synth_quality_r05c_best.npz")
        ckpt = import_jax_npz(R05C_NPZ, work / "r05c")

        print("[5] synthetic pocket")
        pdb = out / "pocket.pdb"
        ref_lig = write_pocket_pdb(pdb, n_atoms=300, seed=0)

        print("[6] main path: cli.generate_ligands")
        T, n_samples = flagship["diffusion_params"]["diffusion_steps"], 16
        sdf = out / "samples.sdf"
        timing = {}
        sample = ConditionalDDPM.sample_given_pocket

        def timed_sample(self, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = sample(self, *a, **k)
            torch.cuda.synchronize()
            timing["sample_s"] = time.perf_counter() - t
            return result

        ConditionalDDPM.sample_given_pocket = timed_sample
        ec.reset_launch_counts()
        t0 = time.perf_counter()
        cli.main([str(ckpt), "--pdbfile", str(pdb), "--ref_ligand", ref_lig,
                  "--outfile", str(sdf), "--n_samples", str(n_samples),
                  "--num_nodes_lig", "24", "--all_frags",
                  "--timesteps", str(T)])
        wall = time.perf_counter() - t0
        launches = dict(ec.launch_counts)
        ConditionalDDPM.sample_given_pocket = sample
        expected = {"gcl_agg": 8 * T + 6, "coord_agg": 6 * T + 6}
        print(f"  launches {launches}, expected {expected}")
        _check(launches == expected, "launch counts differ from the main path's")
        blocks = sdf.read_text().split("$$$$")[:-1]
        _check(len(blocks) == n_samples, f"SDF holds {len(blocks)} molecules")
        for blk in blocks:
            lines = blk.split("\n")
            i = next(k for k, ln in enumerate(lines) if ln.endswith("V2000"))
            _check(int(lines[i][:3]) == 24, "a molecule does not have 24 atoms")
            coords = [[float(ln[0:10]), float(ln[10:20]), float(ln[20:30])]
                      for ln in lines[i + 1:i + 25]]
            _check(np.isfinite(coords).all(), "non-finite coordinates")
        step_ms = 1e3 * timing["sample_s"] / (T + 1)
        print(f"  {n_samples} molecules, T={T}: sampling {timing['sample_s']:.2f} s "
              f"({step_ms:.2f} ms per denoise step, decode pass included), CLI wall {wall:.2f} s, "
              f"{n_samples / wall:.3f} molecules/s")

        print("[6b] device time by kernel on the main path's inputs")
        module, _ = load_model(ckpt, device=dev)
        breakdown = profile_phase(torch, module, pdb, ref_lig, n_samples)
        del module

        print("[7] small-input reference: card vs CPU")
        small_reference_phase(torch, dev, work)

    summary = {"card": card, "launches": launches, "kernels": kres,
               "variant_ms": variant_ms, "breakdown": breakdown,
               "sample_s": timing["sample_s"], "step_ms": step_ms,
               "cli_wall_s": wall, "molecules_per_s": n_samples / wall,
               "total_s": time.perf_counter() - t_start}
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(f"chip_smoke: all phases passed in {summary['total_s']:.1f} s")
    sources = {"gcl_agg": ("diffsbdd_tpu_torch/csrc/gcl_agg.cu",
                           "diffsbdd_tpu/ops/egnn_pallas.py:511"),
               "coord_agg": ("diffsbdd_tpu_torch/csrc/coord_agg.cu",
                             "diffsbdd_tpu/ops/egnn_pallas.py:959")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         **kres[name], "library_ms": None} for name in ec.KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
