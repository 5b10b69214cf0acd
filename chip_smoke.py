#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases (any failure ends the run with a non-zero exit code):
  1. the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. each forward kernel against its plain PyTorch twin at the flagship shapes
     (B=16, NL=24, NP=300 padded to 320, F=256, cutoffs None/5/5, attention
     and the cross branch on) and at the shared-pocket variants (col_mask,
     update_rows, B=1), with CUDA-event times of kernel and twin;
  3b. each backward kernel against its plain version (autograd through the
     twin) at the flagship training shapes (B=16, ligands of 24-32 atoms padded
     to 32, update_rows = NL for the coordinate kernel) and at the variants (no
     attention, no tanh, cross off, col_mask, an edge-type delta, odd N and odd
     update_rows), every cotangent, with CUDA-event times;
  4. import checkpoints/synth_quality_r05c_best.npz (hidden 256, 6 layers,
     joint_nf 128) into a port checkpoint;
  5. write a seeded synthetic full-atom pocket PDB;
  6. the main path: the port's cli.generate_ligands, 16 samples of 24 atoms,
     T=500 -- the launch counters must show every kernel on that path;
     then a profile of a 5-step chain on the same inputs (device time by
     kernel, device idle share);
  7. correctness of the sampler end to end on a small input: the fixture
     checkpoint sampled on the card (kernels) and on the CPU (plain twins)
     with the same injected noise must agree;
  8. the training main path: a seeded synthetic processed dataset (96 + 16
     complexes, ligands of 16-32 atoms, full-atom pockets of 250-320 atoms),
     the port's cli.train at the flagship widths for one epoch (6 optimizer
     steps of batch 16, then validation) -- 6 launches of each of the four
     kernels per train step and forward launches only in validation, finite
     losses and gradient norms, moved parameters, `last` and `best`
     checkpoints, and the trained checkpoint sampled through
     cli.generate_ligands with its own size prior; then a profile of one step;
  9. the loss and every parameter's gradient of one fixture batch on the card
     (kernels) against the CPU (plain twins), same timesteps and noise.

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


def write_synthetic_dataset(datadir, n_train: int, n_val: int, seed: int = 0,
                            lig_sizes=(16, 32), pocket_sizes=tuple(range(250, 321, 10)),
                            n_types: int = 10) -> None:
    """A seeded synthetic processed dataset in the format ``LigandPocketDataset``
    reads: ``train.npz`` and ``val.npz`` (flat per-node arrays plus graph-id
    masks) and ``size_distribution.npy`` (the (ligand, pocket) size histogram of
    the training split).  Each complex is a full-atom pocket shell (see
    ``pocket_atoms``) of a size drawn from ``pocket_sizes`` around a ligand of
    ``lig_sizes[0]``..``lig_sizes[1]`` atoms, both with random atom types."""
    datadir = Path(datadir)
    datadir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    hist = np.zeros((lig_sizes[1] + 1, max(pocket_sizes) + 1))
    for split, n in (("train", n_train), ("val", n_val)):
        arrays = {k: [] for k in ("lig_coords", "lig_one_hot", "lig_mask",
                                  "pocket_coords", "pocket_one_hot", "pocket_mask")}
        for i in range(n):
            nl = int(rng.integers(lig_sizes[0], lig_sizes[1] + 1))
            npk = int(rng.choice(pocket_sizes))
            residues, _ = pocket_atoms(npk, seed=int(rng.integers(1 << 31)))
            pocket = np.array([xyz for _, atoms in residues for _, _, xyz in atoms])[:npk]
            ligand = rng.standard_normal((nl, 3)) * 1.5
            shift = rng.uniform(-20, 20, 3)  # the loader centres every complex
            arrays["lig_coords"].append(ligand + shift)
            arrays["pocket_coords"].append(pocket + shift)
            arrays["lig_one_hot"].append(np.eye(n_types)[rng.integers(0, n_types, nl)])
            arrays["pocket_one_hot"].append(np.eye(n_types)[rng.integers(0, 4, npk)])
            arrays["lig_mask"].append(np.full(nl, i, float))
            arrays["pocket_mask"].append(np.full(npk, i, float))
            if split == "train":
                hist[nl, npk] += 1
        np.savez(datadir / f"{split}.npz",
                 names=np.array([f"{split}_{i}" for i in range(n)]),
                 **{k: np.concatenate(v).astype(np.float32) for k, v in arrays.items()})
    np.save(datadir / "size_distribution.npy", hist)


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


def kernel_inputs(torch, dev, flagship, B, NL, lig_sizes=None, np_pad=320,
                  n_pocket=300, seed=0, with_delta=False):
    """Operands of both kernels at the flagship width on a synthetic complex:
    one full-atom pocket of ``n_pocket`` atoms padded to ``np_pad``, ligands of
    ``lig_sizes`` atoms (all NL when None) within a few Angstrom of its centre.
    Weight scales are those of a trained layer (fan-in normalized).  Returns a
    namespace-like dict."""
    F = flagship["egnn_params"]["hidden_nf"]
    N = NL + np_pad
    cut = tuple(flagship["egnn_params"][k] for k in (
        "edge_cutoff_ligand", "edge_cutoff_pocket", "edge_cutoff_interaction"))
    residues, _ = pocket_atoms(n_pocket, seed=0)
    pk = np.array([xyz for _, atoms in residues for _, _, xyz in atoms],
                  np.float32)[:n_pocket]
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    x0 = torch.zeros(B, N, 3)
    x0[:, :NL] = torch.randn((B, NL, 3), generator=g) * 1.5
    x0[:, NL:NL + n_pocket] = torch.as_tensor(pk)
    mask = torch.zeros(B, N)
    mask[:, NL:NL + n_pocket] = 1.0
    for b in range(B):
        mask[b, :NL if lig_sizes is None else int(lig_sizes[b])] = 1.0
    x0 = (x0 * mask[..., None]).to(dev)
    mask = mask.to(dev)
    x = (x0 + r(B, N, 3, scale=0.2)) * mask[..., None]
    is_lig = torch.zeros(B, N, device=dev)
    is_lig[:, :NL] = 1.0
    s = F ** -0.5
    delta = lambda: r(F, scale=0.2) if with_delta else None
    gcl_w = dict(w_d2=r(F, scale=0.05), w_d20=r(F, scale=0.05), type_bias=None,
                 w2=r(F, F, scale=s), b2=r(F, scale=0.1),
                 w_att=r(F, 1, scale=s), b_att=r(1, scale=0.1))
    a_row, a_col = r(B, N, F, scale=0.5), r(B, N, F, scale=0.5)
    w3 = r(F, 1, scale=s)
    cross = dict(a_row=r(B, N, F, scale=0.5), a_col=r(B, N, F, scale=0.5),
                 w_d2=r(F, scale=0.05), w_d20=r(F, scale=0.05), type_bias=None,
                 w2=r(F, F, scale=s), b2=r(F, scale=0.1), w3=w3)
    graph_mean = (x * mask[..., None]).sum(1) / mask.sum(1)[:, None]
    coord_w = (r(F, scale=0.05), r(F, scale=0.05), None, r(F, F, scale=s),
               r(F, scale=0.1), w3)
    return dict(B=B, NL=NL, N=N, F=F, cut=cut, x=x, x0=x0, mask=mask, is_lig=is_lig,
                a_row=a_row, a_col=a_col, gcl_w=gcl_w, coord_w=coord_w, cross=cross,
                graph_mean=graph_mean, gcl_delta=delta(), coord_delta=delta(),
                cross_delta=delta(), r=r)


def active_pairs(ec, inp, rows=None, col_mask=None):
    """Pairs with adjacency 1 among the first ``rows`` rows (all when None)."""
    x0 = inp["x0"]
    adj = ec.adjacency_dense(((x0[:, :, None] - x0[:, None]) ** 2).sum(-1),
                             inp["mask"], inp["is_lig"], inp["cut"], col_mask=col_mask)
    return int((adj[:, :rows] > 0).sum())


def kernel_phase(ec, torch, dev, flagship):
    """Phase 3: kernels vs plain twins at the flagship shapes."""
    B, NL = 16, 24
    inp = kernel_inputs(torch, dev, flagship, B, NL)
    F, N, cut = inp["F"], inp["N"], inp["cut"]
    x, x0, mask, is_lig = inp["x"], inp["x0"], inp["mask"], inp["is_lig"]
    a_row, a_col, gcl_w = inp["a_row"], inp["a_col"], inp["gcl_w"]
    cross, graph_mean, coord_w = inp["cross"], inp["graph_mean"], inp["coord_w"]
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
        pairs = active_pairs(ec, inp, rows=NL if name == "coord_agg" else None)
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


GCL_COT = ("da_row", "da_col", "dx", "dx0", "dw_d2", "dw_d20", "ddelta", "dw2", "db2",
           "dw_att", "db_att")
COORD_COT = GCL_COT[:9] + ("dw3",)
# cotangents with a batch axis; the others are sums over the batch
PER_GRAPH = {"da_row", "da_col", "dx", "dx0", "cross.a_row", "cross.a_col", "dmean"}
# Every cotangent must lie within BWD_RTOL of its plain version, relative to
# that cotangent's largest entry: float32 on both sides, but an entry is a sum
# over up to every active pair of the batch (~1e6 at the flagship shapes), taken
# in another order by the kernel, so the error scales with the sum and not with
# the entry.  Measured on an H100: 2e-6 at worst.
BWD_RTOL = 5e-5


def _name_cotangents(result, names):
    """Flatten a backward wrapper's result into {name: tensor or None}."""
    if names is GCL_COT:
        return dict(zip(names, result))
    main, cross, dmean = result
    out = dict(zip(names, main))
    if cross is not None:
        out.update({f"cross.{k}": v for k, v in cross.items()})
        out["dmean"] = dmean
    return out


def _plain_in_slices(torch, call, B, step):
    """The plain backward over batch slices of ``step`` graphs (the dense twin
    under autograd holds several (b, N, N, F) tensors): per-graph cotangents
    are concatenated, weight cotangents summed."""
    parts = [call(slice(b, min(b + step, B))) for b in range(0, B, step)]
    out = {}
    for name in parts[0]:
        vals = [p[name] for p in parts]
        if vals[0] is None:
            out[name] = None
        elif name in PER_GRAPH:
            out[name] = torch.cat(vals, 0)
        else:
            out[name] = torch.stack(vals, 0).sum(0)
    return out


def bwd_kernel_phase(ec, torch, dev, flagship):
    """Phase 3b: backward kernels vs autograd through the plain twins."""
    results, variant_ms = {}, {}

    def sl_mlp(d, sl):  # batch slice of a pair MLP's operands
        return {k: (v[sl] if k in ("a_row", "a_col") else v) for k, v in d.items()}

    def run(name, label, inp, call, plain_step, timed):
        """``call(fn, sl)`` runs wrapper ``fn`` on batch slice ``sl``."""
        B = inp["B"]
        names = GCL_COT if name == "gcl_agg_bwd" else COORD_COT
        kern = ec.gcl_agg_bwd if name == "gcl_agg_bwd" else ec.coord_agg_bwd
        plain = ec.gcl_agg_bwd_plain if name == "gcl_agg_bwd" else ec.coord_agg_bwd_plain
        got = _name_cotangents(call(kern, slice(0, B)), names)
        ref = _plain_in_slices(
            torch, lambda sl: _name_cotangents(call(plain, sl), names), B, plain_step)
        torch.cuda.synchronize()
        worst_abs, worst_rel, worst_name = 0.0, 0.0, ""
        for cname, r in ref.items():
            if r is None:
                _check(got[cname] is None, f"{name}[{label}] {cname} should be None")
                continue
            _check(bool(torch.isfinite(got[cname]).all()),
                   f"{name}[{label}] {cname} is not finite")
            scale = float(r.abs().max())
            err = float((got[cname] - r).abs().max())
            worst_abs = max(worst_abs, err)
            if err / (scale + 1e-30) > worst_rel:
                worst_rel, worst_name = err / (scale + 1e-30), cname
            _check(err <= BWD_RTOL * scale + 1e-7,
                   f"{name}[{label}] {cname}: error {err:.3e} against scale {scale:.3e}")
        print(f"  {name}[{label}] {len(ref)} cotangents, worst error {worst_rel:.2e} of "
              f"its cotangent's largest entry ({worst_name}; limit {BWD_RTOL:.0e}), "
              f"max_abs_err {worst_abs:.3e}")
        ms = _cuda_ms(lambda: call(kern, slice(0, B)), 20 if timed else 5)
        variant_ms[f"{name}[{label}]"] = ms
        if not timed:
            print(f"  {name}[{label}] kernel {ms:.4f} ms")
            return
        plain_ms = _cuda_ms(lambda: _plain_in_slices(
            torch, lambda sl: _name_cotangents(call(plain, sl), names), B, plain_step), 2)
        rows = inp["NL"] if name == "coord_agg_bwd" else None
        pairs = active_pairs(ec, inp, rows=rows)
        F, N = inp["F"], inp["N"]
        n_mlp = 1 if name == "gcl_agg_bwd" else 2
        # per active pair and MLP: three F x F products (forward, dW2, dm1) and
        # the elementwise terms of both passes
        flops = pairs * n_mlp * (6 * F * F + 30 * F)
        width_g = F if name == "gcl_agg_bwd" else 3
        # inputs once (projections, weights, W2 and its transpose, node data, g)
        # and outputs once (da_row, da_col per MLP, dx, dx0, weight cotangents)
        bytes_ = 4 * (n_mlp * (4 * B * N * F + 3 * F * F + 12 * F) + B * N * 17
                      + B * N * width_g)
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, bytes_ / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= bytes_ / PEAK_BYTES \
            else "bytes"
        print(f"  {name}[{label}] kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
              f"active pairs {pairs}, {flops / 1e9:.2f} GFLOP, bound {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.1f}% of f32 peak")
        results[name] = dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)

    def gcl_case(label, inp, attention=True, col_mask=None, update_rows=None,
                 plain_step=4, timed=False):
        w = inp["gcl_w"]
        g = inp["r"](inp["B"], inp["N"], inp["F"])
        att = (w["w_att"], w["b_att"]) if attention else (None, None)

        def call(fn, sl):
            return fn(g[sl], inp["a_row"][sl], inp["a_col"][sl], inp["x"][sl],
                      inp["x0"][sl], inp["mask"][sl], inp["is_lig"][sl], w["w_d2"],
                      w["w_d20"], inp["gcl_delta"], w["w2"], w["b2"], *att,
                      cutoffs=inp["cut"], attention=attention,
                      normalization_factor=100.0,
                      col_mask=None if col_mask is None else col_mask[sl],
                      update_rows=update_rows)
        run("gcl_agg_bwd", label, inp, call, plain_step, timed)

    def coord_case(label, inp, cross=True, tanh=True, update_rows=None,
                   plain_step=2, timed=False):
        g = inp["r"](inp["B"], inp["N"], 3)
        w_d2, w_d20, _, w2, b2, w3 = inp["coord_w"]
        c = {k: v for k, v in inp["cross"].items() if k != "type_bias"}
        c["delta"] = inp["cross_delta"]

        def call(fn, sl):
            return fn(g[sl], inp["a_row"][sl], inp["a_col"][sl], inp["x"][sl],
                      inp["x0"][sl], inp["mask"][sl], inp["is_lig"][sl], w_d2, w_d20,
                      inp["coord_delta"], w2, b2, w3, cutoffs=inp["cut"], tanh=tanh,
                      coords_range=15.0, norm_constant=1.0, normalization_factor=100.0,
                      cross=sl_mlp(c, sl) if cross else None,
                      graph_mean=inp["graph_mean"][sl] if cross else None,
                      update_rows=update_rows)
        run("coord_agg_bwd", label, inp, call, plain_step, timed)

    # the flagship training step: B = 16, ligands of 24-32 atoms padded to 32
    sizes = np.random.default_rng(0).integers(24, 33, 16)
    full = kernel_inputs(torch, dev, flagship, 16, 32, lig_sizes=sizes, seed=1)
    gcl_case("train_full", full, timed=True)
    coord_case("train_ligand_rows_cross", full, update_rows=32, timed=True)
    # the variants, at a smaller batch
    small = kernel_inputs(torch, dev, flagship, 4, 24, seed=2, with_delta=True)
    lig = small["mask"] * small["is_lig"]
    gcl_case("no_attention_delta", small, attention=False)
    gcl_case("ligand_columns", small, col_mask=lig)
    coord_case("no_cross_no_tanh_all_rows_delta", small, cross=False, tanh=False)
    odd = kernel_inputs(torch, dev, flagship, 3, 23, np_pad=302, n_pocket=290, seed=3)
    gcl_case("odd_n_odd_rows", odd, col_mask=odd["mask"], update_rows=21)
    coord_case("odd_n_odd_rows", odd, update_rows=21)
    return results, variant_ms


def profile_phase(torch, module, pocket_pdb, ref_lig, n_samples, steps=5):
    """Device time by kernel over a short chain (prior, ``steps`` denoise
    steps, decode) on the main path's inputs, and the device's idle share of
    the wall time (under the profiler, which adds host overhead)."""
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pocket_pdb), ref_lig)
    pocket = module.prepare_pocket(residues, repeats=n_samples)
    lig_mask = torch.ones(n_samples, 24, device=pocket["x"].device)
    gen = torch.Generator(device=pocket["x"].device).manual_seed(1)
    module.ddpm.sample_given_pocket(gen, pocket, lig_mask, timesteps=2,
                                    shared_pocket=True)  # warm-up
    torch.cuda.synchronize()
    return _profile(torch, lambda: module.ddpm.sample_given_pocket(
        gen, pocket, lig_mask, timesteps=steps, shared_pocket=True),
        f"{steps} steps + prior + decode")


def _profile(torch, fn, what):
    """Device time by kernel over one call of ``fn`` and the device's idle
    share of its wall time (under the profiler, which adds host overhead)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
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
    print(f"  {what}: wall {wall_us / 1e3:.2f} ms, device busy "
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


# the training fields of configs/crossdock_fullatom_cond.yml (the network and
# diffusion fields come from snapshot_config, which fixes the same values)
TRAIN_FIELDS = dict(dataset="crossdock", batch_size=16, lr=1.0e-3, n_epochs=1,
                    clip_grad=True, accumulate_grad_batches=1, augment_noise=0,
                    augment_rotation=False, auxiliary_loss=False, virtual_nodes=False,
                    seed=42)
N_TRAIN, N_VAL = 96, 16


def flagship_train_config(flagship, datadir, logdir):
    """The config of the training run, checked against the YAML preset where
    PyYAML is installed."""
    cfg = {**flagship, **TRAIN_FIELDS, "run_name": "chip_smoke_train",
           "datadir": str(datadir), "logdir": str(logdir)}
    cfg["diffusion_params"] = dict(flagship["diffusion_params"],
                                   diffusion_noise_schedule="polynomial_2",
                                   diffusion_noise_precision=5.0e-4,
                                   diffusion_loss_type="l2")
    try:
        import yaml
    except ImportError:
        print("  PyYAML not installed: the preset file is not cross-checked")
        return cfg
    from diffsbdd_tpu_torch.config import load_config
    preset = yaml.safe_load((REPO / "configs" / "crossdock_fullatom_cond.yml").read_text())
    full = load_config(overrides=cfg).to_dict()
    for key in ("egnn_params", "diffusion_params", "mode", "pocket_representation",
                *TRAIN_FIELDS):
        if key == "seed" or key == "n_epochs":
            continue
        want = preset[key]
        got = {k: full[key][k] for k in want} if isinstance(want, dict) else full[key]
        _check(got == want, f"config field {key} differs from the preset: {got} != {want}")
    return cfg


def train_phase(torch, ec, dev, flagship, out, work, pdb, ref_lig):
    """Phase 8: the port's cli.train at the flagship widths on a synthetic
    dataset, then the trained checkpoint through cli.generate_ligands."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.cli import generate_ligands as gen_cli
    from diffsbdd_tpu_torch.cli import train as train_cli
    from diffsbdd_tpu_torch.train import loop

    n_pocket = sum(ln.startswith("ATOM") for ln in Path(pdb).read_text().splitlines())
    data = work / "data"
    # the sampled pocket's size is among the training sizes, so that the
    # checkpoint's size prior has seen it
    write_synthetic_dataset(data, N_TRAIN, N_VAL, seed=0,
                            pocket_sizes=(250, 265, 280, n_pocket, 310, 320))
    cfg = flagship_train_config(flagship, data, work / "runs")
    cfg_path = work / "train_config.json"
    cfg_path.write_text(json.dumps(cfg))

    records, captured = [], {}
    trainer_log, create_state = loop.Trainer.log, train_cli.create_train_state

    def log(self, metrics, split, step):
        torch.cuda.synchronize()
        records.append(dict(split=split, step=step, t=time.perf_counter(),
                            launches=dict(ec.launch_counts),
                            **{k: float(v) for k, v in metrics.items()}))

    def capture_state(module, lr):
        captured["state"] = create_state(module, lr)
        captured["initial"] = [p.detach().clone() for p in module.parameters()]
        return captured["state"]

    loop.Trainer.log, train_cli.create_train_state = log, capture_state
    ec.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_cli.main(["--config", str(cfg_path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ec.launch_counts)
    loop.Trainer.log, train_cli.create_train_state = trainer_log, create_state

    train = [r for r in records if r["split"] == "train"]
    val = [r for r in records if r["split"] == "val"]
    n_steps, n_layers = N_TRAIN // 16, flagship["egnn_params"]["n_layers"]
    _check(len(train) == n_steps and len(val) == 1,
           f"{len(train)} train and {len(val)} val records")
    prev = dict.fromkeys(ec.KERNELS, 0)
    for r in train:
        per_step = {k: r["launches"][k] - prev[k] for k in ec.KERNELS}
        _check(all(v == n_layers for v in per_step.values()),
               f"step {r['step']}: launches {per_step}, expected {n_layers} of each")
        _check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
               f"step {r['step']}: loss {r['loss']}, grad_norm {r['grad_norm']}")
        prev = r["launches"]
    # validation: two network passes per batch (t and t = 0), forward only
    in_val = {k: val[0]["launches"][k] - prev[k] for k in ec.KERNELS}
    want_val = {"gcl_agg": 2 * n_layers * (N_VAL // 16), "coord_agg": 2 * n_layers * (N_VAL // 16),
                "gcl_agg_bwd": 0, "coord_agg_bwd": 0}
    _check(in_val == want_val, f"validation launches {in_val}, expected {want_val}")
    _check(np.isfinite(val[0]["loss"]), f"validation loss {val[0]['loss']}")
    print(f"  launches per train step {n_layers}/{n_layers}/{n_layers}/{n_layers} "
          f"(gcl, coord, gcl bwd, coord bwd) over {n_steps} steps; validation {in_val}")
    print("  loss " + " ".join(f"{r['loss']:.4f}" for r in train)
          + f"; val {val[0]['loss']:.4f}")
    print("  grad_norm " + " ".join(f"{r['grad_norm']:.3f}" for r in train))

    state = captured["state"]
    moved = [float((p.detach() - p0).abs().max())
             for p, p0 in zip(state.module.parameters(), captured["initial"])]
    _check(np.isfinite(moved).all() and max(moved) > 0, "the parameters did not move")
    _check(state.step == n_steps, f"trainer step {state.step}")
    ckpt = work / "runs" / "chip_smoke_train" / "checkpoints"
    for name in ("last", "best"):
        for suffix in (".pt", ".train.pt", ".config.json"):
            _check((ckpt / f"{name}{suffix}").exists(), f"no {name}{suffix}")

    # steady-state step time: the first step carries the libraries' loading
    steps_ms = [1e3 * (b["t"] - a["t"]) for a, b in zip(train, train[1:])]
    step_ms = float(np.median(steps_ms))
    print(f"  train step {step_ms:.2f} ms (median of {len(steps_ms)}; "
          + " ".join(f"{m:.1f}" for m in steps_ms) + f"), {16e3 / step_ms:.2f} "
          f"complexes/s; cli.train wall {wall:.2f} s")

    print("  the trained checkpoint through load_model and cli.generate_ligands")
    module, _ = load_model(ckpt, name="last", device=dev)
    for p, q in zip(module.parameters(), state.module.parameters()):
        _check(torch.equal(p, q), "the last checkpoint differs from the trained weights")
    _check(module.ddpm.size_distribution is not None, "the checkpoint has no size prior")
    sdf = out / "trained_samples.sdf"
    gen_cli.main([str(ckpt), "--pdbfile", str(pdb), "--ref_ligand", ref_lig,
                  "--outfile", str(sdf), "--n_samples", "4", "--all_frags",
                  "--timesteps", "20"])
    blocks = sdf.read_text().split("$$$$")[:-1]
    _check(len(blocks) == 4, f"the trained checkpoint gave {len(blocks)} molecules")

    print("  device time by kernel over one train step")
    train_step = loop.make_train_step(state)
    batch = next(iter(train_cli.PaddedLoader(
        train_cli.LigandPocketDataset(data / "train.npz"), 16, shuffle=False)))
    lig = loop.batch_to_device(batch["ligand"], dev)
    pkt = loop.batch_to_device(batch["pocket"], dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    train_step(gen, lig, pkt)  # warm-up
    torch.cuda.synchronize()
    breakdown = _profile(torch, lambda: train_step(gen, lig, pkt), "one train step")
    return dict(launches=launches, per_step=n_layers, step_ms=step_ms,
                steps_ms=steps_ms, complexes_per_s=16e3 / step_ms, cli_wall_s=wall,
                losses=[r["loss"] for r in train], val_loss=val[0]["loss"],
                grad_norms=[r["grad_norm"] for r in train], breakdown=breakdown)


def gradient_phase(torch, dev, work):
    """Phase 9: loss and every parameter's gradient of one fixture batch on
    the card (kernels) against the CPU (plain twins), from the same timesteps
    and noise."""
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
    ckpt = import_jax_npz(FIXTURE_NPZ, work / "fixture_grad",
                          node_histogram=np.ones((17, 65)))
    write_synthetic_dataset(work / "small_data", 4, 1, seed=5, lig_sizes=(6, 12),
                            pocket_sizes=(40, 52, 60), n_types=11)
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset, PaddedLoader
    from diffsbdd_tpu_torch.train.loop import batch_to_device
    batch = next(iter(PaddedLoader(LigandPocketDataset(work / "small_data" / "train.npz"),
                                   4, shuffle=False)))
    rng = np.random.default_rng(1)
    NL = batch["ligand"]["x"].shape[1]
    t_int = rng.integers(1, 100, (4, 1)).astype(np.float32)
    eps = rng.standard_normal((4, NL, 3 + 11)).astype(np.float32)
    res = {}
    for d in (dev, torch.device("cpu")):
        module, _ = load_model(ckpt, device=d)
        module.ddpm.sample_timesteps = lambda g, B, lo, d=d: torch.as_tensor(t_int, device=d)
        module.ddpm.sample_gaussian = lambda g, shape, mask: \
            torch.as_tensor(eps, device=mask.device) * mask[..., None]
        loss, _ = module.loss_fn(None, batch_to_device(batch["ligand"], d),
                                 batch_to_device(batch["pocket"], d), training=True)
        names, params = zip(*module.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        res[d.type] = (float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)
                                     if g is not None})
    (l_card, g_card), (l_cpu, g_cpu) = res["cuda"], res["cpu"]
    _check(g_card.keys() == g_cpu.keys(), "different parameters reached on card and CPU")
    # float32 on both sides with other summation orders through three layers
    # and their backward: 1e-3 of each gradient's largest entry
    worst, worst_name = 0.0, ""
    for n in g_cpu:
        scale = float(g_cpu[n].abs().max())
        err = float((g_card[n] - g_cpu[n]).abs().max())
        _check(bool(torch.isfinite(g_card[n]).all()), f"gradient of {n} is not finite")
        _check(err <= 1e-3 * scale + 1e-7, f"gradient of {n}: error {err:.3e}, scale {scale:.3e}")
        if scale > 0 and err / scale > worst:
            worst, worst_name = err / scale, n
    _check(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu), f"loss {l_card} on the card, {l_cpu} on the CPU")
    print(f"  loss {l_card:.6f} on the card, {l_cpu:.6f} on the CPU; {len(g_cpu)} gradients, "
          f"worst error {worst:.2e} of its largest entry ({worst_name}; limit 1e-3)")


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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3] kernels vs plain twins at the flagship shapes")
    flagship = snapshot_config(R05C_NPZ)
    kres, variant_ms = kernel_phase(ec, torch, dev, flagship)

    print("[3b] backward kernels vs plain versions at the flagship training shapes")
    bres, bwd_variant_ms = bwd_kernel_phase(ec, torch, dev, flagship)
    kres.update(bres)
    variant_ms.update(bwd_variant_ms)

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
        expected = {"gcl_agg": 8 * T + 6, "coord_agg": 6 * T + 6,
                    "gcl_agg_bwd": 0, "coord_agg_bwd": 0}
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

        print("[8] training main path: cli.train at the flagship widths")
        training = train_phase(torch, ec, dev, flagship, out, work, pdb, ref_lig)

        print("[9] card vs CPU gradients on the fixture")
        gradient_phase(torch, dev, work)

    # a kernel's launches: those of the main path that runs it most
    launches = {k: max(launches[k], training["launches"][k]) for k in ec.KERNELS}
    summary = {"card": card, "launches": launches, "kernels": kres,
               "sampling_launches": expected, "training": training,
               "variant_ms": variant_ms, "breakdown": breakdown,
               "sample_s": timing["sample_s"], "step_ms": step_ms,
               "cli_wall_s": wall, "molecules_per_s": n_samples / wall,
               "total_s": time.perf_counter() - t_start}
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(f"chip_smoke: all phases passed in {summary['total_s']:.1f} s")
    sources = {"gcl_agg": ("diffsbdd_tpu_torch/csrc/gcl_agg.cu",
                           "diffsbdd_tpu/ops/egnn_pallas.py:511"),
               "coord_agg": ("diffsbdd_tpu_torch/csrc/coord_agg.cu",
                             "diffsbdd_tpu/ops/egnn_pallas.py:959"),
               "gcl_agg_bwd": ("diffsbdd_tpu_torch/csrc/gcl_agg_bwd.cu",
                               "diffsbdd_tpu/ops/egnn_pallas_bwd.py:385"),
               "coord_agg_bwd": ("diffsbdd_tpu_torch/csrc/coord_agg_bwd.cu",
                                 "diffsbdd_tpu/ops/egnn_pallas_bwd.py:908")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "launches_by_path": {"sampling": expected[name],
                              "training": training["launches"][name]},
         **kres[name], "library_ms": None} for name in ec.KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
