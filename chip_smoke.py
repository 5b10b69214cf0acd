#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases (any failure ends the run with a non-zero exit code):
  1. the card's name and power limit (nvidia-smi);
  2. build the five CUDA kernels from csrc/ with their 2xTF32 and bf16
     libraries (one nvcc per library, in parallel), and count the
     tensor-core (HMMA) and cp.async (LDGSTS) instructions in the SASS of
     each: all five run their products in 3xTF32, the whole-block kernel in
     both of its phases (block_phase_a, block_phase_b), and each tier's
     library only its tier's HMMA (TF32 or bf16), as many as its passes:
     2xTF32 2/3 of 3xTF32's TF32 HMMA, bf16 1/6 of them in the forward and
     whole-block kernels (between 1/6 and 1/3 in the backward ones, whose
     dW2 loop is not unrolled); every recorded function (F = 64 to 4096)
     of the five 3xTF32 libraries against its recorded SASS digest
     (``PARENT_SASS``, same nvcc), and the digests of the functions not
     yet recorded printed;
  3. each forward kernel against its plain PyTorch twin at the flagship shapes
     (B=16, NL=24, NP=300 padded to 320, F=256, cutoffs None/5/5, attention
     and the cross branch on) and at the shared-pocket variants (col_mask,
     update_rows, B=1), both also on a collapsed complex (every pair within
     the cutoffs), the coordinate kernel also without the cross branch and at
     the joint chain's launch (B=8, every row moves), two launches bit for
     bit, with CUDA-event times of kernel and twin and each variant's bounds
     (f32 CUDA cores, 3xTF32 tensor cores);
  3b. each backward kernel against its plain version (autograd through the
     twin) at the flagship training shapes (B=16, ligands of 24-32 atoms padded
     to 32, update_rows = NL for the coordinate kernel) and at the variants (no
     attention, no tanh, cross off, col_mask, an edge-type delta, odd N and odd
     update_rows), the GCL kernel also on a collapsed complex at the training
     shapes (every pair within the cutoffs), the coordinate kernel also at
     the joint train step's launch (B=16, N=352, every row moves, collapsed
     complex, cross and tanh on), every cotangent, with CUDA-event times and
     each timed case's bounds (f32 CUDA cores, 3xTF32 tensor cores);
  3c. the whole-block kernel against its plain version at the joint shapes
     (B=16, N=344, every row moves), the conditional shapes (24 rows move), the
     batch that phase 10 launches it at (B=8: another grid and other rows a
     block) on a clean and on a collapsed complex (every pair within the
     cutoffs, as the joint chain has it at large t), and at the variants (cross off, attention off, tanh off, an edge-type
     table, odd N with odd update_rows), both outputs, two launches bit for
     bit, with CUDA-event times of the kernel, the plain version and the split
     pair it replaces (GCL kernel + node MLP and projections in PyTorch +
     coordinate kernel), and the bounds (f32 CUDA cores, 3xTF32 tensor
     cores);
  4. import checkpoints/synth_quality_r05c_best.npz (hidden 256, 6 layers,
     joint_nf 128) into a port checkpoint;
  5. write a seeded synthetic full-atom pocket PDB;
  6. the main path: the port's cli.generate_ligands, 16 samples of 24 atoms,
     T=500 -- the launch counters must show every kernel on that path;
     then a profile of a 5-step chain on the same inputs (device time by
     kernel, device idle share);
  7. correctness of the samplers end to end on a small input: the fixture
     checkpoint sampled on the card (split kernels, and the whole-block
     kernel) and on the CPU (plain twins) with the same injected noise must
     agree, as a conditional and as a joint model;
  8. the training main path: a seeded synthetic processed dataset (96 + 16
     complexes, ligands of 16-32 atoms, full-atom pockets of 250-320 atoms),
     the port's cli.train at the flagship widths for one epoch (6 optimizer
     steps of batch 16, then validation) -- 6 launches of each of the four
     kernels per train step and forward launches only in validation, finite
     losses and gradient norms, moved parameters, `last` and `best`
     checkpoints, and the trained checkpoint sampled through
     cli.generate_ligands with its own size prior; a profile of one step;
  9. the loss and every parameter's gradient of one fixture batch on the card
     (kernels) against the CPU (plain twins), same timesteps and noise;
  10. the joint main path: cli.train with mode joint at the flagship widths
     (3 steps of batch 16: the split kernels and their backward kernels, the
     whole-block kernel never), then cli.generate_ligands on that checkpoint
     with tpu.kernel_block_fuse on, T=500: a joint checkpoint inpaints with the
     whole pocket fixed (8 samples: the noised pocket is a dense graph, about
     eight times the pairs of the conditional path), every block of every pass
     is one launch of the whole-block kernel and the split kernels are not
     launched; a profile of one joint train step;
  10b. a 5-step joint chain on the same inputs profiled with block fusing on
     and off (device time by kernel, the whole-block kernel's two phases
     apart, idle share, ms per pass);
  11. conditional inpainting: cli.inpaint on the imported flagship checkpoint
     with block fusing on, 6 atoms of the pocket's reference ligand fixed and
     18 added, T=50 with 3 resamplings -- per pass of the chain 3 + 1 launches
     of the split kernels (block 0, the shared pocket) and 5 of the whole-block
     kernel, 6 of it in the decode pass; the fixed atoms come back where they
     were put;
  11b. the 5-step chain of phase 6 profiled with block fusing on and off;
  12. the test-set workflow: the port's cli.test_set on the flagship
     checkpoint over a synthetic test directory of 2 pockets (seeds 0 and 1,
     ~300 atoms, each with phase 6's first molecule as its 24-atom ligand),
     16 samples a pocket in one batch, --fix_n_nodes --all_frags, T=500 --
     the file layout, 16 molecules in each processed SDF, one sampling chain
     of launches a pocket; seconds per pocket and per molecule, sampling and
     host apart;
  13. molecule optimization: the port's cli.optimize on phase 5's pocket with
     that ligand, objective SA, population 16, 2 generations of 100 noising
     steps, top 4 -- the CSV (the reference row and one row for each built
     molecule), the output SDF, one diversify chain of launches a
     generation; seconds per generation;
  14. serving: a SamplingServer on the flagship checkpoint driven through its
     JSON-lines loop (ping, info, warmup, two generates with one seed, one
     without, a malformed line, shutdown; 16 molecules of 24 atoms, 100
     steps) -- every reply, the two seeded replies identical, the launches of
     each request; the cold (warmup) and warm request wall;
  and a quality readout: analyze_samples on phase 6's molecules under EDM
  and covalent bond perception (the card's own figures; they gate nothing);
  15. Lightning import: phase 4's checkpoint written as a reference-format
     Lightning .ckpt (reference names, the schedule's table, Namespace
     hyper-parameters, phase 8's size histogram), imported by `python -m
     diffsbdd_tpu_torch.convert.torch_ckpt`: bitwise-equal weights, and one
     seeded cli.generate_ligands run of 4 molecules (T=500) from each gives
     identical SDFs;
  16. evaluation during training: the port's SamplingEvaluator on phase 8's
     checkpoint and validation pockets (sample_and_analyze of 16 samples in
     one batch, sample_and_save's xyz of 4, a chain of keep_frames 10 as xyz
     frames) and on phase 10's joint checkpoint with block fusing on
     (sample_and_analyze of 8, a chain of keep_frames 10), then cli.train for
     one epoch with eval_epochs 1 (the evaluator through Trainer.fit) --
     6(T+1) launches of gcl_agg and of coord_agg per conditional chain,
     6(T+1) of block_fused and nothing else per joint chain, finite metrics
     (-1 where JAX leaves one uncomputed); nothing is rendered: the card's
     machine is not promised matplotlib or imageio;
  17. processing (host only): a raw CrossDocked layout of 6 synthetic pairs
     through the port's proc_crossdock, full-atom and CA, each split loaded
     with LigandPocketDataset, the size histogram and the smiles checked;
  18. the multi-device paths (parallel/) on the one card.  18a: the two
     coordinate kernels on the two column blocks of a two-rank edge split at
     the flagship shapes (phase 3's and 3b's launches), each block against
     its plain version, the blocks' sum against the whole-graph launch, each
     block's time beside the whole graph's.  18b: two ranks spawned on the
     card, joined by gloo over CUDA tensors (NCCL refuses two ranks on one
     card), each check against one process on the card: the edge-sharded
     flagship dynamics (forward and parameter gradients, on the kernels with
     column-block masks), one data-parallel train step at global batch 16
     with injected noise, the batch-sharded main path (2 x 8 molecules at
     T=500, global noise contract); each rank's launches as each check's.
     18c: cli.train for one epoch under a one-rank torchrun environment
     (NCCL) with num_workers 2: the rank-0 checkpoints, the prefetch thread.
     No time of phase 18 is a multi-card speed: two ranks share one card.
  19. hidden width 128, the dense variants, profiling and the synthetic
     corpus.  19a: the five kernels at F=128 against their plain versions at
     phases 3, 3b and 3c's shapes (two launches bit for bit, CUDA-event
     times, both bounds) and their registers and spills.  19b: the config
     defaults' model (hidden 128, joint_nf 32, 5 layers, full-atom
     crossdock_full) from seeded random weights through cli.generate_ligands
     (16 x 24 atoms, T=100) with the launches 5 layers make, cli.train for
     2 steps (the backward kernels at F=128), the trained checkpoint sampled
     with block fusing on (the whole-block kernel at F=128), and card vs CPU
     chains from injected noise.  19c: the flagship config with sinusoidal
     distance features and mean aggregation from seeded random weights (the
     dense path): cli.generate_ligands (16 x 24, T=50) with no kernel
     launched, ms per pass and peak memory; one dynamics forward at B=2 card
     vs CPU for it and for gnn_dynamics at the same widths; cli.train for 2
     steps of batch 4 (finite losses, peak memory); a chain with
     tpu.nan_check on, and a NaN input that raises.  19d: utils.profiling's
     device_trace around 3 passes of phase 6's main path (the trace file, the
     top 5 device operations) and a StepTimer.  19e (host only):
     synth_corpus.build_corpus on two seeded synthetic proteins (32 + 8 + 8
     complexes) loaded through LigandPocketDataset and PaddedLoader.
  20. the precision policies and the implementation choices.  20a: the
     five kernels at 3xTF32, 2xTF32 and bf16, at F=256 and 128, at phases
     3, 3b and 3c's main shapes (the whole-block kernel at the joint chain's
     B=8 launch, clean and collapsed, and at B=16 with 24 rows moving; at
     F=128 the B=8 launch), each against its plain version at that tier (ops.egnn_cuda.TIER_GATES: the
     largest error, and the error's norm within a quarter of how far the tier
     moves the output from the 3xTF32 kernel's), only that tier's library
     launched, two launches bit for bit, CUDA-event times and the tier's
     bound (bf16: operations / 989 TFLOP/s; 2xTF32: 2 x operations / 495
     TFLOP/s; or bytes / 3.35 TB/s).  20b: phase 6's main path (same seed,
     so the same noise) at matmul_precision bfloat16 from the flagship
     checkpoint against phase 6, and at float32_x2 from the flagship weights
     jittered below TF32's resolution (the r05c weights are float16 values,
     from which 2xTF32 drops nothing) against float32 on the same weights:
     every launch at the tier, ms per pass, molecules/s, the largest
     coordinate deviation and the type flips, the quality readout.  20c: one
     conditional train step of the jittered flagship weights at float32,
     with kernel_bwd_precision bfloat16 and at float32_x2: launches by tier,
     gradient deviation from float32's, ms a step.  20d: phase 19c's dense model at compute_dtype
     bfloat16: ms per pass and peak memory, a forward against float32 and
     the CPU (the first GCL's message sums: the card's bf16 within 1e-3 and
     a quarter of float32's distance of the CPU's), and the largest training
     batch that runs.  20e: hidden widths 96 and 192, which the kernels run
     zero-padded to 128 and 256: the five wrappers at 3xTF32 and bf16
     against their plain versions at the true width (the tier gates, one
     launch each), gcl_agg's time at width 192 beside 256, and a hidden-192
     flagship-shaped model sampled through cli.generate_ligands (16 x 24,
     T=50, 8T + 6 / 6T + 6 launches, ms a pass); the package root's
     load_model on the card; what still raises with no launch: an unknown
     precision name and width 320.  20f: phase 10's joint chain (flagship-joint-b8,
     8 x 24, T=500, one seed) from phase 10's joint checkpoint, block
     fusing on at float32, bfloat16 and float32_x2 and off
     at the reduced tiers: 6(T+1) launches of the tier's whole-block library
     a chain (or of the tier's split pair), ms a pass, max A and type flips
     against float32.  20g: egnn_impl xla (the flagship checkpoint on the
     dense path: cli.generate_ligands 16 x 24 at T=50 with no launch, ms a
     pass, peak memory, eps against the kernels' path) and kernel_bwd xla
     (one conditional train step at the largest batch of 16/8/4 that fits:
     6 + 6 forward launches, no backward kernel, gradients against the
     backward kernels', ms a step, peak memory).  20h: hidden widths
     257-512 on the F = 512 instantiations (tiles of two rows): the five
     kernels at F = 512 and every tier at phases 3, 3b and 3c's main shapes
     against their plain versions (the tier gates; the 3xTF32 error beside
     a 5e-6 target; ms, bound, registers and spills), widths
     384 and 448 run padded at 3xTF32 and bf16 (one launch each), the
     flagship's shape at hidden 512 from seeded random weights sampled (16 x
     24, T = 20: 166 / 126 launches), trained a step at batch 16 (6
     launches of each split kernel) and sampled as a joint model with block
     fusing (8 x 24, T = 20: 126 launches), and hidden 384 sampled.  20i:
     hidden widths 513-1024 on the F = 1024 instantiations (tiles of one
     row), as 20h: the five kernels at F = 1024 and every tier at phases 3,
     3b and 3c's main shapes (the forward plain versions in batch slices of
     4), width 768 run padded, the flagship's shape at hidden 1024 sampled
     (16 x 24, T = 2 since 20n: 22 / 18 launches), trained a step at batch
     16 (6 launches of each split kernel) and sampled as a joint model with
     block fusing (8 x 24, T = 2: 18 launches), hidden 768 sampled; the dW2
     step's share of gcl_agg_bwd at
     F = 512 and 1024 (a build of it with -DEGNN_SKIP_DW2, timed through
     the same wrapper); and how the 3xTF32 error grows with K: the five
     kernels against their float64 plain versions at F = 256, 512 and
     1024, and gcl_agg at 1024 from a build without the step sums
     (-DEGNN_NO_STEP_SUMS).  20j: hidden widths 1025-2048 on the two
     forward split kernels at F = 2048, each row tile on a cluster of two
     blocks: gcl_agg (full graph, collapsed) and coord_agg (ligand rows
     with the cross branch on and off, every row at B = 8) at every tier at
     phase 3's shapes against their plain versions (batch slices of 2; the
     tier gates, the reduced tiers' on the first 4 graphs; the cluster
     dimension each launch used; ms, bound, registers, spills, shared
     memory), widths 1088 and 1536 run padded (one launch each), the
     flagship's shape at hidden 2048 and 1536 from seeded random weights
     sampled (16 x 24, T = 2: 22 / 18 launches), the joint model at hidden
     2048 sampled with block fusing off (8 x 24, T = 2).
     20k: training at hidden widths 1025-2048 on the two backward kernels
     at F = 2048, each row tile on a cluster of two blocks: gcl_agg_bwd and
     coord_agg_bwd at every tier at phase 3b's main shapes against their
     plain versions (batch slices of 2 and 1; the tier gates, the reduced
     tiers' on the first 4 graphs; the cluster dimension; ms, bound,
     registers, spills, shared memory; the dW2
     step's share from 20i's timing build), and one conditional train step
     at batch 16 at hidden 2048 and at 1536 from seeded random weights,
     two layers (one launch of each split kernel a layer, forward and
     backward, at F = 2048; ms a step, peak memory, a finite loss and
     gradient norm).  20l: the
     whole-block kernel at F = 2048, both phases on clusters of two
     blocks, at phase 3c's joint shapes (B = 8; the clean complex at every
     tier, the reduced tiers checked on its first 4 graphs, the collapsed
     one at 3xTF32) against its plain version (batch slices of 2; the block
     gates; two launches bit for bit; the cluster dimension; ms, bounds,
     registers, spills, shared memory), the bf16 library at F = 1024 and
     2048 and its plain version each against that plain version with its
     products summed in float64, width 1536 padded onto it, and the joint
     model at hidden 2048 sampled with block fusing on (8 x 24, T = 2: 18
     whole-block launches, no split-kernel launch); the bf16 whole-block
     gate (20a, 20e, 20l and the card tests) holds the kernel against its
     plain version with the bf16 products summed in float64, within twice
     the float32 plain version's own distance.  20m: hidden widths
     2049-4096 on the two forward split kernels at F = 4096, each row tile
     on a cluster of four blocks: gcl_agg (full graph) and coord_agg
     (ligand rows, the cross branch on and off) at every tier at phase 3's
     shapes against their plain versions (batch slices of 1; the reduced
     tiers on the first 4 graphs), width 3072 padded, the flagship's shape
     at hidden 4096 with two layers from seeded random weights sampled (16
     x 24, T = 2: 10 / 6 launches at F = 4096), and the refusals before any
     launch of
     width 4160 in the forward wrappers.  20n: training at hidden widths
     2049-4096 on the two backward kernels at F = 4096, each row tile on a
     cluster of four blocks: gcl_agg_bwd and coord_agg_bwd at every tier at
     phase 3b's main shapes against their plain versions (batch slices of
     1; the reduced tiers on the first 4 graphs; the cluster dimension; ms,
     bound, registers, spills, shared memory), width 3072 padded,
     cli.train at hidden 4096 and two layers from phase 8's config (batch
     4, one epoch of two steps and its validation pass, one launch of each
     split kernel a layer and step at F = 4096 on clusters of four, a
     finite loss and gradient norm, the checkpoints written), a two-layer
     hidden-3072 train step at batch 4 (padded onto 4096; ms, peak
     memory), and the refusals before any launch of width 4160 in the
     backward wrappers.  20o: the whole-block kernel at F = 4096, both
     phases on clusters of four blocks, as 20l: at every tier on phase 3c's
     clean complex (B = 8; plain version in batch slices of 1, the reduced
     tiers checked on the first 4 graphs), width 3072 padded onto it, the
     joint model at hidden 4096 with two layers from seeded random weights
     sampled with block fusing on (8 x 24, T = 2: 2 whole-block launches a
     pass, no split-kernel launch), and the refusal before any launch of
     width 4160 in block_fused.

Prints a {"kernels": [...]} line (the five kernels, then the same five at
F=128 from phase 19, then the five kernels at 2xTF32 and bf16 from phase
20, then the five at F=512 from phase 20h and at F=1024 from phase 20i,
then gcl_agg and coord_agg at F=2048 from phase 20j, gcl_agg_bwd and
coord_agg_bwd at F=2048 from phase 20k, block_fused at F=2048 from
phase 20l, gcl_agg and coord_agg at F=4096 from phase 20m,
gcl_agg_bwd and coord_agg_bwd at F=4096 from phase 20n, and block_fused
at F=4096 from phase 20o)
and the card line, and as its last line
{"ok": true, "device": {...}}.  The pocket, the samples and a summary.json go
to ``--out`` (default chip_smoke_out/ in the repository).  Needs a CUDA card:
exits non-zero without one, and without the repository around it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
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
# batch of the joint main path (phase 10), and of the whole-block kernel's
# comparison that the kernels line carries (phase 3c)
JOINT_SAMPLES = 8

# H100 SXM data-sheet peaks: f32 on the CUDA cores, TF32 on the tensor cores
# (dense), HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
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


def write_protein_pdb(path, n_atoms: int = 800, radius: float = 13.0,
                      seed: int = 0) -> None:
    """Write a synthetic globular protein (chain A, standard residues) as
    PDB: residue centres drawn uniformly in a ball of ``radius`` A, atoms
    within 1.5 A of their centre, until at least ``n_atoms`` atoms.  Dense
    enough for ``synth_corpus.place_and_carve``'s 8 A pockets of 80-310
    atoms at its surface."""
    rng = np.random.default_rng(seed)
    lines, serial, count, resseq = [], 1, 0, 1
    while count < n_atoms:
        name, atoms = _RESIDUES[rng.integers(len(_RESIDUES))]
        d = rng.standard_normal(3)
        centre = d / np.linalg.norm(d) * radius * rng.uniform() ** (1 / 3)
        for a, el in atoms:
            xyz = centre + rng.uniform(-1.5, 1.5, 3) / np.sqrt(3)
            field = a if len(a) == 4 else f" {a:<3}"
            lines.append(f"ATOM  {serial:5d} {field} {name:>3} A{resseq:4d}    "
                         f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00"
                         f"          {el:>2}")
            serial += 1
        count += len(atoms)
        resseq += 1
    Path(path).write_text("\n".join(lines + ["END"]) + "\n")


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


def sass_counts(ec, name, opcodes, function=None, tier="tf32x3"):
    """Instructions of each opcode in the library of kernel ``name`` at
    ``tier``, from ``cuobjdump --dump-sass`` (beside nvcc in the CUDA
    toolkit); with ``function``, only in the device functions whose names
    contain it.  An opcode matches with or without its modifiers (HMMA
    counts HMMA.1688.F32.TF32)."""
    cuobjdump = Path(ec._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(ec._lib_path(name, tier))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    if function is not None:
        sections = re.split(r"^\s*Function : ", sass, flags=re.M)[1:]
        sass = "".join(sec for sec in sections if function in sec.split("\n", 1)[0])
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", sass)) for op in opcodes}


# the SASS digests (``sass_functions``) of every function the five 3xTF32
# libraries had before the backward kernels' F = 2048 instantiations (the
# kernels at F = 64, 128, 256, 512 and 1024, the width-free summing
# kernels, and the forward split kernels at F = 2048): recorded on the card
# from builds of the sources as they stood before the F = 1024
# instantiations (commit b7b3254), for F = 1024's before the F = 2048 ones
# (commit 3ac0e94), and for the F = 2048 forward ones before the F = 2048
# backward ones (commit 0695e1d); then the backward kernels' and the
# whole-block kernel's F = 2048 functions, recorded from the build that
# added the latter (the backward ones as commit 134fe18 left them; the
# whole block's phase B at F = 2048 is coord_agg's cluster kernel, one
# source in egnn_coord.cuh, so both libraries hold the same SASS); then the
# forward split kernels' F = 4096 functions (clusters of four), recorded
# from the build that added them; then the whole-block kernel's F = 4096
# functions, recorded from the build that added them (its phase B is
# coord_agg's F = 4096 cluster kernel, the same SASS in both libraries);
# and the nvcc that built them (the card machine's)
PARENT_SASS_FUNCTIONS = {
    "gcl_agg": {
        "_ZN43_GLOBAL__N_22gcl_agg_cluster_kernelILi4096EEEvN4egnn7GclArgsE":
            "ec185106b77d6a03eeae96f7bdb9d084cd31b285872025c18823a274a7a1e71b",
        "_ZN43_GLOBAL__N_22gcl_agg_cluster_kernelILi2048EEEvN4egnn7GclArgsE":
            "ad274632bea97ed04dbd2d691b9ccec8205a24280e855d5f1c28a01f3b2f91f4",
        "_ZN43_GLOBAL__N_14gcl_agg_kernelILi1024EEEvN4egnn7GclArgsE":
            "262c284a9e7a0d49910d2dcc2c29224a27b3b57894f76fe8434eca460b876d1c",
        "_ZN43_GLOBAL__N_14gcl_agg_kernelILi128EEEvN4egnn7GclArgsE":
            "730d534b55a3f772a8b79f2756f60d13dca8afab46533419648f59967a7608f6",
        "_ZN43_GLOBAL__N_14gcl_agg_kernelILi256EEEvN4egnn7GclArgsE":
            "c3a0194f773ad3b6bff8d37164125e0134ea4d1641bfe726e4268d45eee4bda4",
        "_ZN43_GLOBAL__N_14gcl_agg_kernelILi512EEEvN4egnn7GclArgsE":
            "a68fb2d6abf4bb91848c7eaef4110f67127155f91b6b0278473e2d10dca720c2",
        "_ZN43_GLOBAL__N_14gcl_agg_kernelILi64EEEvN4egnn7GclArgsE":
            "70d7888e930840cfda5361f4df9caaef1a91bfc470f45d178456b773ca6e30ac",
    },
    "coord_agg": {
        "_ZN45_GLOBAL__N_24coord_agg_cluster_kernelILi4096ELb0EEEvN4egnn9CoordArgsEPf":
            "5332f2dcaaf99ae8e748ce5ce8755edbd38887d6bd3a03bad8f9a34112cbe029",
        "_ZN45_GLOBAL__N_24coord_agg_cluster_kernelILi4096ELb1EEEvN4egnn9CoordArgsEPf":
            "9c215048eb2c18b73727a583bafc6ef6a950d9460325a3970efa329f4511f814",
        "_ZN45_GLOBAL__N_24coord_agg_cluster_kernelILi2048ELb0EEEvN4egnn9CoordArgsEPf":
            "6542948e98d277a6821b12d26484c7ce201b60a3fe89710f4739f2f5762bc0ab",
        "_ZN45_GLOBAL__N_24coord_agg_cluster_kernelILi2048ELb1EEEvN4egnn9CoordArgsEPf":
            "fbe918284c03e6277c03b04854259eb839aa94d558ec1c7b68f4675628fff31f",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi1024ELb0EEEvN4egnn9CoordArgsEPf":
            "d47f9245ce1be58f8979e0d4f42346be5e39553d802283b19aa787d4442643c1",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi1024ELb1EEEvN4egnn9CoordArgsEPf":
            "6c3690d742ee0e99f16da461c857ccb55854afcb411f37775afbc41840f6e885",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi128ELb0EEEvN4egnn9CoordArgsEPf":
            "d852b1e615740ab6c21a4e8044840d8d11365410a4640bcee5d5cb780d9ab4e7",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi128ELb1EEEvN4egnn9CoordArgsEPf":
            "d9e1fa98bb98740d3ecfeb03638ec7b434796e7d41227d14e8fe3bd482bdbc0b",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi256ELb0EEEvN4egnn9CoordArgsEPf":
            "c9facc3e8512d624da9c1ae27a0e3aed80dfd6bce72e80d61dbad7484db35628",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi256ELb1EEEvN4egnn9CoordArgsEPf":
            "e6e3ab6fc86b490f81fd1ab69a3eb1fb1cb1a18684214ed4cb061543f1b7b54d",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi512ELb0EEEvN4egnn9CoordArgsEPf":
            "cf1245fb4cdbc2674222242d57e94bda896b638ea5d7b47e7cd98f0a5fca79f0",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi512ELb1EEEvN4egnn9CoordArgsEPf":
            "4ba5b6750f6397e4b6ebc2ff88ee0a83bf9fee14c8f2860795dbef79036e833e",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi64ELb0EEEvN4egnn9CoordArgsEPf":
            "efa26ab59dcfd0a717735b6c278cd426e8362f0c0864510227ce197b8a9eab85",
        "_ZN45_GLOBAL__N_16coord_agg_kernelILi64ELb1EEEvN4egnn9CoordArgsEPf":
            "3b3d41de8d6cd1ad5a75d1a03b02b8ee405204db40bb284ea998e8de0766489b",
        "_ZN4egnn12add_partialsEPKfmPf":
            "436cfdd5b3bf1ed3c806bb8323e361d20e910bc5f4dd0ee3d728a7f1ade8dd62",
    },
    "gcl_agg_bwd": {
        "_ZN47_GLOBAL__N_26gcl_agg_bwd_cluster_kernelILi4096EEEvN4egnn10GclBwdArgsE":
            "99f0c826a8dcb18c54068fb1382a6eabebe298590dbc63f100f92813214f137f",
        "_ZN47_GLOBAL__N_26gcl_agg_bwd_cluster_kernelILi2048EEEvN4egnn10GclBwdArgsE":
            "01284c1c864b894fe639dd9f6f19e7b928060d049c8f1452c65333c4f7e1a680",
        "_ZN47_GLOBAL__N_18gcl_agg_bwd_kernelILi1024EEEvN4egnn10GclBwdArgsE":
            "5833331ae612127554bf368cecea3d65e865ccf66f45d004392b56194b0979bb",
        "_ZN47_GLOBAL__N_18gcl_agg_bwd_kernelILi128EEEvN4egnn10GclBwdArgsE":
            "f9a2194647a8972ad2427c4ccf8a1ec4f6203e55f93e70e367855bce874f9c92",
        "_ZN47_GLOBAL__N_18gcl_agg_bwd_kernelILi256EEEvN4egnn10GclBwdArgsE":
            "0b16989468a9d9541d0ed60965fb1ed22bc7c8a821f65b7e0a6e7a0a7045c066",
        "_ZN47_GLOBAL__N_18gcl_agg_bwd_kernelILi512EEEvN4egnn10GclBwdArgsE":
            "96ba8f5dca35ef424d06534f5165e796ae3c769f89dbbffef8e94f79360a424e",
        "_ZN47_GLOBAL__N_18gcl_agg_bwd_kernelILi64EEEvN4egnn10GclBwdArgsE":
            "b14f432d39dd8818152f32969cf833c3845745f743095238ad5954cae35d6c84",
        "_ZN4egnn22reduce_partials_kernelEPKfPfim":
            "9efdeac766b91eb4db11842e9aa1cef231b9e8b2cd5fb3ae8ade646d929c8a23",
    },
    "coord_agg_bwd": {
        "_ZN49_GLOBAL__N_28coord_agg_bwd_cluster_kernelILi4096EEEvNS_12CoordBwdArgsE":
            "c96fcb5571b4f01f3c7a8a425c1ec2822f7de82d90794c770b476a5f402f9df5",
        "_ZN49_GLOBAL__N_28coord_agg_bwd_cluster_kernelILi2048EEEvNS_12CoordBwdArgsE":
            "d81573c99be242b978e5619c645fbf595c96c67fc2872035ef0f0f2e0464d8b1",
        "_ZN49_GLOBAL__N_20coord_agg_bwd_kernelILi1024EEEvNS_12CoordBwdArgsE":
            "ad14a6baa9412a818234010db6080f1c8103a8f54dfcc5792bc21712f460ce18",
        "_ZN49_GLOBAL__N_20coord_agg_bwd_kernelILi128EEEvNS_12CoordBwdArgsE":
            "8dd38a40dc446c71001ffb83fe325f38d6a9f5ddcf6e9dd8ed9aaa3f6f0b0383",
        "_ZN49_GLOBAL__N_20coord_agg_bwd_kernelILi256EEEvNS_12CoordBwdArgsE":
            "345ca50863463b762d6eb481453803ebc73f62eabcdce891bc41f53290852375",
        "_ZN49_GLOBAL__N_20coord_agg_bwd_kernelILi512EEEvNS_12CoordBwdArgsE":
            "fc440d308499cb5320cfc34cabd7d0f579b11ebaea916d667dafe52944e742eb",
        "_ZN49_GLOBAL__N_20coord_agg_bwd_kernelILi64EEEvNS_12CoordBwdArgsE":
            "abb72bf6ebf6bcee3c10b1d8ae9ddd29b39c863b757827fd0f453b961aa1f31e",
        "_ZN4egnn22reduce_partials_kernelEPKfPfim":
            "9efdeac766b91eb4db11842e9aa1cef231b9e8b2cd5fb3ae8ade646d929c8a23",
    },
    "block_fused": {
        "_ZN47_GLOBAL__N_21block_phase_a_clusterILi2048EEEvNS_6PhaseAEPf":
            "b1604414919928f345bd8ce6ad77301dac2195aa89075b65686868edb055e48c",
        "_ZN47_GLOBAL__N_24coord_agg_cluster_kernelILi2048ELb0EEEvN4egnn9CoordArgsEPf":
            "6542948e98d277a6821b12d26484c7ce201b60a3fe89710f4739f2f5762bc0ab",
        "_ZN47_GLOBAL__N_24coord_agg_cluster_kernelILi2048ELb1EEEvN4egnn9CoordArgsEPf":
            "fbe918284c03e6277c03b04854259eb839aa94d558ec1c7b68f4675628fff31f",
        "_ZN47_GLOBAL__N_13block_phase_aILi1024EEEvNS_6PhaseAE":
            "fd249cd938f63c9dd3765860c190c547a07f54df7a504e62c540524c577f6c53",
        "_ZN47_GLOBAL__N_13block_phase_bILi1024ELb0EEEvN4egnn9CoordArgsEPf":
            "d47f9245ce1be58f8979e0d4f42346be5e39553d802283b19aa787d4442643c1",
        "_ZN47_GLOBAL__N_13block_phase_bILi1024ELb1EEEvN4egnn9CoordArgsEPf":
            "6c3690d742ee0e99f16da461c857ccb55854afcb411f37775afbc41840f6e885",
        "_ZN47_GLOBAL__N_13block_phase_aILi128EEEvNS_6PhaseAE":
            "073b3a56f5e7e5434ede0fbd4b56d0531a55034b43534a344c3056304bcc9972",
        "_ZN47_GLOBAL__N_13block_phase_aILi256EEEvNS_6PhaseAE":
            "c26aa44eda620c01d1da921951e7947704aa4a2124306662908c29e7eae8dcc3",
        "_ZN47_GLOBAL__N_13block_phase_aILi512EEEvNS_6PhaseAE":
            "075a07bd8966b4e628706ffa1d6906e0e5ef1d1ce442a4dea8e5976591895d80",
        "_ZN47_GLOBAL__N_13block_phase_aILi64EEEvNS_6PhaseAE":
            "05cfe8a7a9b6250ecb7f9a379a7333e2c3bd3f5c6a1ff74fe46c2c69e967ca9a",
        "_ZN47_GLOBAL__N_13block_phase_bILi128ELb0EEEvN4egnn9CoordArgsEPf":
            "d852b1e615740ab6c21a4e8044840d8d11365410a4640bcee5d5cb780d9ab4e7",
        "_ZN47_GLOBAL__N_13block_phase_bILi128ELb1EEEvN4egnn9CoordArgsEPf":
            "d9e1fa98bb98740d3ecfeb03638ec7b434796e7d41227d14e8fe3bd482bdbc0b",
        "_ZN47_GLOBAL__N_13block_phase_bILi256ELb0EEEvN4egnn9CoordArgsEPf":
            "c9facc3e8512d624da9c1ae27a0e3aed80dfd6bce72e80d61dbad7484db35628",
        "_ZN47_GLOBAL__N_13block_phase_bILi256ELb1EEEvN4egnn9CoordArgsEPf":
            "e6e3ab6fc86b490f81fd1ab69a3eb1fb1cb1a18684214ed4cb061543f1b7b54d",
        "_ZN47_GLOBAL__N_13block_phase_bILi512ELb0EEEvN4egnn9CoordArgsEPf":
            "cf1245fb4cdbc2674222242d57e94bda896b638ea5d7b47e7cd98f0a5fca79f0",
        "_ZN47_GLOBAL__N_13block_phase_bILi512ELb1EEEvN4egnn9CoordArgsEPf":
            "4ba5b6750f6397e4b6ebc2ff88ee0a83bf9fee14c8f2860795dbef79036e833e",
        "_ZN47_GLOBAL__N_13block_phase_bILi64ELb0EEEvN4egnn9CoordArgsEPf":
            "efa26ab59dcfd0a717735b6c278cd426e8362f0c0864510227ce197b8a9eab85",
        "_ZN47_GLOBAL__N_13block_phase_bILi64ELb1EEEvN4egnn9CoordArgsEPf":
            "3b3d41de8d6cd1ad5a75d1a03b02b8ee405204db40bb284ea998e8de0766489b",
        "_ZN4egnn12add_partialsEPKfmPf":
            "436cfdd5b3bf1ed3c806bb8323e361d20e910bc5f4dd0ee3d728a7f1ade8dd62",
        "_ZN47_GLOBAL__N_18block_phase_a_wideILi4096EEEvNS_6PhaseAEPf":
            "94aebb1d0ea6701299274ad60732ff1e17168f24b6cff5d5fec4f34bd91d7a1d",
        "_ZN47_GLOBAL__N_24coord_agg_cluster_kernelILi4096ELb0EEEvN4egnn9CoordArgsEPf":
            "5332f2dcaaf99ae8e748ce5ce8755edbd38887d6bd3a03bad8f9a34112cbe029",
        "_ZN47_GLOBAL__N_24coord_agg_cluster_kernelILi4096ELb1EEEvN4egnn9CoordArgsEPf":
            "9c215048eb2c18b73727a583bafc6ef6a950d9460325a3970efa329f4511f814",
    },
}
PARENT_SASS = {"nvcc": "Cuda compilation tools, release 12.9, V12.9.86",
               "functions": PARENT_SASS_FUNCTIONS}
FORWARD_KERNELS = ("gcl_agg", "coord_agg", "block_fused")


def nvcc_release(ec):
    return subprocess.run([ec._nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-2].strip()


def sass_functions(ec, name, tier="tf32x3"):
    """{function: sha256 of its SASS instructions} of the library of kernel
    ``name`` at ``tier`` (addresses' trailing comments dropped): equal
    digests, the same code instruction for instruction.  A function is its
    mangled name with the anonymous namespace's per-build hash taken out, so
    that one source built in two directories names its functions alike."""
    import hashlib
    cuobjdump = Path(ec._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(ec._lib_path(name, tier))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out = {}
    for section in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
        head, body = section.split("\n", 1)
        fn = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_",
                    head.strip())
        lines = [re.sub(r";.*", "", ln) + "\n" for ln in body.split("\n")
                 if re.match(r"^\s+/\*[0-9a-f]+\*/", ln)]
        out[fn] = hashlib.sha256("".join(lines).encode()).hexdigest()
    return out


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
                  n_pocket=300, seed=0, with_delta=False, spread=None):
    """Operands of both kernels at the flagship width on a synthetic complex:
    one full-atom pocket of ``n_pocket`` atoms padded to ``np_pad``, ligands of
    ``lig_sizes`` atoms (all NL when None) within a few Angstrom of its centre.
    With ``spread`` every atom is instead drawn from a Gaussian of that width:
    the collapsed complex of the joint chain at large t, in which nearly every
    pair passes the cutoffs.  Weight scales are those of a trained layer (fan-in normalized).  Returns a
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
    if spread is not None:
        x0 = torch.randn((B, N, 3), generator=g) * spread
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


def work_bounds(pairs, B, N, F, n_mlp, rows_out, width_out):
    """Operations and bytes of a forward pair-MLP kernel on these inputs, and
    the bounds they give: f32 on the CUDA cores, and 3xTF32 on the tensor
    cores (three passes of every operation at the TF32 rate)."""
    flops = pairs * n_mlp * (2 * F * F + 10 * F)
    # projections, W2 and the vectors once, the node data once, the output once
    bytes_ = 4 * (n_mlp * (2 * B * N * F + F * F + 4 * F) + B * N * 11
                  + B * rows_out * width_out)
    t_f32, t_tc, t_bytes = flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS, \
        bytes_ / PEAK_BYTES
    return dict(pairs=pairs, flops=flops, bytes=bytes_,
                bound_ms=1e3 * max(t_f32, t_bytes),
                bound_by="operations" if t_f32 >= t_bytes else "bytes",
                bound_tc_ms=1e3 * max(t_tc, t_bytes),
                bound_tc_by="operations" if t_tc >= t_bytes else "bytes")


def bwd_work(pairs, B, N, F, n_mlp, width_g):
    """Operations and bytes of a backward pair-MLP kernel on these inputs: per
    active pair and MLP three F x F products (forward, dW2, dm1) and the
    elementwise terms of both passes; the inputs once (projections, weights,
    W2 and its transpose, node data, g of width ``width_g``) and the outputs
    once (da_row, da_col per MLP, dx, dx0, weight cotangents)."""
    return dict(pairs=pairs, flops=pairs * n_mlp * (6 * F * F + 30 * F),
                bytes=4 * (n_mlp * (4 * B * N * F + 3 * F * F + 12 * F) + B * N * 17
                           + B * N * width_g))


def kernel_phase(ec, torch, dev, flagship):
    """Phase 3: kernels vs plain twins at the flagship shapes; both also on a
    collapsed complex (every pair within the cutoffs, full chunks), the
    coordinate kernel also at the joint chain's batch with every row moving,
    two launches of each variant bit for bit."""
    B, NL = 16, 24
    inp = kernel_inputs(torch, dev, flagship, B, NL)
    dense = kernel_inputs(torch, dev, flagship, B, NL, seed=9, spread=1.0)
    # the joint chain's coordinate launch with block fusing off: B = 8, every
    # row moves, on a clean and on a collapsed complex
    all8 = kernel_inputs(torch, dev, flagship, JOINT_SAMPLES, NL, seed=10)
    dense8 = kernel_inputs(torch, dev, flagship, JOINT_SAMPLES, NL, seed=11, spread=1.0)
    F, N, cut = inp["F"], inp["N"], inp["cut"]
    x, x0, mask, is_lig = inp["x"], inp["x0"], inp["mask"], inp["is_lig"]
    a_row, a_col, gcl_w = inp["a_row"], inp["a_col"], inp["gcl_w"]
    pkt, lig = mask * (1 - is_lig), mask * is_lig

    def gcl_call(fn, variant):
        kw = dict(cutoffs=cut, attention=True, normalization_factor=100.0)
        if variant == "full":
            return fn(a_row, a_col, x, x0, mask, is_lig, *gcl_w.values(), **kw)
        if variant == "full_collapsed":
            d = dense
            return fn(d["a_row"], d["a_col"], d["x"], d["x0"], d["mask"], d["is_lig"],
                      *d["gcl_w"].values(), **kw)
        if variant == "pocket_pocket_b1":
            return fn(a_row[:1], a_col[:1], x[:1], x0[:1], pkt[:1], is_lig[:1],
                      *gcl_w.values(), col_mask=pkt[:1], **kw)
        if variant == "pocket_ligand":
            return fn(a_row, a_col, x, x0, pkt, is_lig, *gcl_w.values(),
                      col_mask=lig, **kw)
        return fn(a_row, a_col, x, x0, lig, is_lig, *gcl_w.values(),
                  col_mask=mask, update_rows=NL, **kw)

    def gcl_work(variant):
        """The bounds of a GCL variant: its active pairs and its batch."""
        if variant == "full":
            return work_bounds(active_pairs(ec, inp), B, N, F, 1, N, F)
        if variant == "full_collapsed":
            return work_bounds(active_pairs(ec, dense), B, N, F, 1, N, F)
        if variant == "pocket_pocket_b1":
            one = dict(inp, x0=x0[:1], mask=pkt[:1], is_lig=is_lig[:1])
            return work_bounds(active_pairs(ec, one, col_mask=pkt[:1]), 1, N, F, 1, N, F)
        if variant == "pocket_ligand":
            return work_bounds(active_pairs(ec, dict(inp, mask=pkt), col_mask=lig),
                               B, N, F, 1, N, F)
        return work_bounds(active_pairs(ec, dict(inp, mask=lig), rows=NL, col_mask=mask),
                           B, N, F, 1, N, F)

    def coord_inputs(variant):
        if variant.endswith("_b8_collapsed"):
            return dense8
        if variant.endswith("_b8"):
            return all8
        return dense if variant.endswith("_collapsed") else inp

    def coord_call(fn, variant):
        d = coord_inputs(variant)
        rows = None if variant.startswith("all_rows") else NL
        kw = dict(cutoffs=cut, tanh=True, coords_range=15.0, norm_constant=1.0,
                  normalization_factor=100.0, update_rows=rows)
        if "nocross" not in variant:
            kw.update(cross=d["cross"], graph_mean=d["graph_mean"])
        return fn(d["a_row"], d["a_col"], d["x"], d["x0"], d["mask"], d["is_lig"],
                  *d["coord_w"], **kw)

    def coord_work(variant):
        """The bounds of a coordinate variant: its active pairs (of the rows
        that move), its batch, one or two pair MLPs."""
        d = coord_inputs(variant)
        rows = d["N"] if variant.startswith("all_rows") else NL
        return work_bounds(active_pairs(ec, d, rows=rows), d["B"], N, F,
                           1 if "nocross" in variant else 2, rows, 3)

    # tolerance: float32 both sides (the products in 3xTF32, float32-grade),
    # pairs summed in another order
    tol = dict(atol=1e-5, rtol=1e-4)
    results, variant_ms = {}, {}
    for name, call, plain, kern, work_of, variants in (
            ("gcl_agg", gcl_call, ec.gcl_message_agg_plain, ec.gcl_message_agg,
             gcl_work, ["full", "full_collapsed", "pocket_pocket_b1", "pocket_ligand",
                        "ligand_rows"]),
            ("coord_agg", coord_call, ec.coord_update_agg_plain,
             ec.coord_update_agg, coord_work,
             ["ligand_rows_cross", "ligand_rows_nocross", "ligand_rows_cross_collapsed",
              "all_rows_cross_b8", "all_rows_cross_b8_collapsed"])):
        worst, work = 0.0, {}
        for v in variants:
            got = call(kern, v)
            again = call(kern, v)
            ref = call(plain, v)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            bad = float(((got - ref).abs() - (tol["atol"] + tol["rtol"] * ref.abs())).max())
            print(f"  {name}[{v}] shape={tuple(got.shape)} max_abs_err={err:.3e} "
                  f"(atol {tol['atol']} + rtol {tol['rtol']}) "
                  f"ref_max={float(ref.abs().max()):.3e}")
            _check(bad <= 0.0, f"{name}[{v}] disagrees with its plain twin")
            _check(torch.equal(got, again), f"{name}[{v}]: two launches differ")
            worst = max(worst, err)
            ms = variant_ms[f"{name}[{v}]"] = _cuda_ms(lambda: call(kern, v), 20)
            w = work[v] = dict(work_of(v), ms=ms)
            print(f"  {name}[{v}] kernel {ms:.4f} ms, two launches bit for bit; "
                  f"active pairs {w['pairs']}, {w['flops'] / 1e9:.2f} GFLOP; bound "
                  f"{w['bound_ms']:.4f} ms f32 ({100 * w['bound_ms'] / ms:.1f}%), "
                  f"{w['bound_tc_ms']:.4f} ms 3xTF32 ({100 * w['bound_tc_ms'] / ms:.1f}%)")
        v = variants[0]
        ms = _cuda_ms(lambda: call(kern, v), 50)
        plain_ms = _cuda_ms(lambda: call(plain, v), 3)
        w = work[v]
        print(f"  {name}[{v}] kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
              f"active pairs {w['pairs']}, {w['flops'] / 1e9:.2f} GFLOP, bound "
              f"{w['bound_ms']:.4f} ms ({w['bound_by']}), "
              f"{100 * w['bound_ms'] / ms:.1f}% of f32 peak")
        results[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                             bound_ms=w["bound_ms"], bound_by=w["bound_by"],
                             bound_tc_ms=w["bound_tc_ms"], bound_tc_by=w["bound_tc_by"],
                             variants=work)
    return results, variant_ms


def block_operands(inp, cross=True, attention=True, table=False):
    """The operands of ``ec.block_fused`` on a ``kernel_inputs`` complex: h and
    the node MLP's and the heads' weights at fan-in scale."""
    r, B, N, F = inp["r"], inp["B"], inp["N"], inp["F"]
    s = F ** -0.5
    g = inp["gcl_w"]
    gcl = dict(w_d2=g["w_d2"], w_d20=g["w_d20"],
               type_delta=r(F, scale=0.2) if table else None, w2=g["w2"], b2=g["b2"],
               w_att=g["w_att"] if attention else None,
               b_att=g["b_att"] if attention else None)
    node = dict(w_h=r(F, F, scale=s), w_a=r(F, F, scale=s), b0=r(F, scale=0.1),
                w2=r(F, F, scale=s), b2=r(F, scale=0.1))
    w3 = inp["coord_w"][5]

    def head():
        return dict(k_i=r(F, F, scale=s), k_j=r(F, F, scale=s), b0=r(F, scale=0.1),
                    w_d2=r(F, scale=0.05), w_d20=r(F, scale=0.05),
                    type_bias=r(2, 2, F, scale=0.2) if table else None,
                    w1=r(F, F, scale=s), b1=r(F, scale=0.1), w3=w3)

    coord = head()
    return [r(B, N, F, scale=0.5), inp["a_row"], inp["a_col"], inp["x"], inp["x0"],
            inp["mask"], inp["is_lig"], gcl, node, coord, head() if cross else None,
            inp["graph_mean"] if cross else None]


def split_pair(ec, torch, ops, **kw):
    """What the whole-block kernel replaces: the GCL kernel, the node MLP and
    the head projections in PyTorch, the coordinate kernel."""
    h, a_row, a_col, x, x0, mask, is_lig, gcl, node, coord, cross, graph_mean = ops
    _check(gcl["type_delta"] is None, "the split pair is timed without a type table")
    agg = ec.gcl_message_agg(
        a_row, a_col, x, x0, mask, is_lig, gcl["w_d2"], gcl["w_d20"], None,
        gcl["w2"], gcl["b2"], gcl["w_att"], gcl["b_att"], cutoffs=kw["cutoffs"],
        attention=kw["attention"], normalization_factor=kw["normalization_factor"])
    pre = h @ node["w_h"] + agg @ node["w_a"] + node["b0"]
    h_new = (h + torch.nn.functional.silu(pre) @ node["w2"] + node["b2"]) * mask[..., None]
    cross_arg = None
    if cross is not None:
        cross_arg = dict(a_row=h_new @ cross["k_i"] + cross["b0"],
                         a_col=h_new @ cross["k_j"], w_d2=cross["w_d2"],
                         w_d20=cross["w_d20"], type_bias=cross["type_bias"],
                         w2=cross["w1"], b2=cross["b1"], w3=cross["w3"])
    dx = ec.coord_update_agg(
        h_new @ coord["k_i"] + coord["b0"], h_new @ coord["k_j"], x, x0, mask, is_lig,
        coord["w_d2"], coord["w_d20"], coord["type_bias"], coord["w1"], coord["b1"],
        coord["w3"], cutoffs=kw["cutoffs"], tanh=kw["tanh"],
        coords_range=kw["coords_range"], norm_constant=kw["norm_constant"],
        normalization_factor=kw["normalization_factor"], cross=cross_arg,
        graph_mean=graph_mean, update_rows=kw["update_rows"])
    return h_new, dx


def block_work(B, N, F, pairs_a, pairs_b, n_heads):
    """Operations and bytes of the whole-block kernel: phase A's pair MLP on
    its ``pairs_a`` active pairs, the node MLP (3 products) and 2 projections
    per head on every node, phase B's ``n_heads`` pair MLPs on the
    ``pairs_b`` pairs of the rows that move; h, a_row, a_col and the node
    data in, every weight once, h_new and dx out."""
    flops = pairs_a * (2 * F * F + 10 * F) + B * N * (3 + 2 * n_heads) * 2 * F * F \
        + pairs_b * n_heads * (2 * F * F + 10 * F)
    bytes_ = 4 * (3 * B * N * F + B * N * 11 + (4 + 3 * n_heads) * F * F
                  + (8 + 5 * n_heads) * F + B * N * F + B * N * 3)
    return flops, bytes_


def block_kernel_phase(ec, torch, dev, flagship, main_batch):
    """Phase 3c: the whole-block kernel vs its plain version and the split
    pair; ``main_batch`` is the batch the joint main path launches it at.
    Tolerance: each output within 1e-5 + 1e-4 of the plain version's
    largest entry -- float32 on both sides, but an entry of h_new is a sum of
    F products of O(1) terms on top of the pair sums, taken in another order."""
    results, variant_ms = {}, {}
    base_kw = dict(attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
                   normalization_factor=100.0)

    def run(label, inp, update_rows, timed=False, **opts):
        cross = opts.get("cross", True)
        kw = dict(base_kw, cutoffs=inp["cut"], update_rows=update_rows,
                  attention=opts.get("attention", True), tanh=opts.get("tanh", True))
        ops = block_operands(inp, cross=cross, attention=kw["attention"],
                             table=opts.get("table", False))
        before = ec.launch_counts["block_fused"]
        got = ec.block_fused(*ops, **kw)
        again = ec.block_fused(*ops, **kw)
        _check(ec.launch_counts["block_fused"] == before + 2, "launches not counted")
        ref = ec.block_fused_plain(*ops, **kw)
        torch.cuda.synchronize()
        worst = 0.0
        for name, g, a, r in zip(("h_new", "dx"), got, again, ref):
            _check(bool(torch.isfinite(g).all()), f"block_fused[{label}] {name} not finite")
            _check(torch.equal(g, a), f"block_fused[{label}] {name}: two launches differ")
            err, scale = float((g - r).abs().max()), float(r.abs().max())
            print(f"  block_fused[{label}] {name} shape={tuple(g.shape)} "
                  f"max_abs_err={err:.3e} (1e-5 + 1e-4 of ref_max={scale:.3e})")
            _check(err <= 1e-5 + 1e-4 * scale,
                   f"block_fused[{label}] {name} disagrees with its plain version")
            worst = max(worst, err)
        rows = inp["N"] if update_rows is None else update_rows
        _check(not bool(got[1][:, rows:].any()), f"block_fused[{label}] dx rows past "
               "update_rows are not zero")
        ms = _cuda_ms(lambda: ec.block_fused(*ops, **kw), 20 if timed else 5)
        variant_ms[f"block_fused[{label}]"] = ms
        if not timed:
            print(f"  block_fused[{label}] kernel {ms:.4f} ms")
            return
        pair = split_pair(ec, torch, ops, **kw)
        for name, g, r in zip(("h_new", "dx"), pair, ref):
            _check(float((g - r).abs().max()) <= 1e-5 + 1e-4 * float(r.abs().max()),
                   f"split pair [{label}] {name} disagrees with the plain version")
        split_ms = _cuda_ms(lambda: split_pair(ec, torch, ops, **kw), 20)
        plain_ms = _cuda_ms(lambda: ec.block_fused_plain(*ops, **kw), 2)
        B, N, F = inp["B"], inp["N"], inp["F"]
        pairs_a = active_pairs(ec, inp)
        pairs_b = active_pairs(ec, inp, rows=rows)
        flops, bytes_ = block_work(B, N, F, pairs_a, pairs_b, 2 if cross else 1)
        t_f32, t_tc, t_bytes = flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS, \
            bytes_ / PEAK_BYTES
        bound_ms, bound_tc_ms = 1e3 * max(t_f32, t_bytes), 1e3 * max(t_tc, t_bytes)
        bound_by = "operations" if t_f32 >= t_bytes else "bytes"
        bound_tc_by = "operations" if t_tc >= t_bytes else "bytes"
        print(f"  block_fused[{label}] kernel {ms:.4f} ms, split pair {split_ms:.4f} ms, "
              f"plain version {plain_ms:.4f} ms; active pairs {pairs_a} (GCL) + {pairs_b} "
              f"(coordinates), {flops / 1e9:.2f} GFLOP, bound {bound_ms:.4f} ms f32 "
              f"({bound_by}, {100 * bound_ms / ms:.1f}%), {bound_tc_ms:.4f} ms 3xTF32 "
              f"({bound_tc_by}, {100 * bound_tc_ms / ms:.1f}%)")
        results[label] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              bound_tc_ms=bound_tc_ms, bound_tc_by=bound_tc_by,
                              split_pair_ms=split_ms)

    full = kernel_inputs(torch, dev, flagship, 16, 24, seed=4)
    run("joint_all_rows", full, None, timed=True)
    run("conditional_ligand_rows", full, 24, timed=True)
    del full
    main = kernel_inputs(torch, dev, flagship, main_batch, 24, seed=7)
    run("joint_main_path", main, None, timed=True)
    dense = kernel_inputs(torch, dev, flagship, main_batch, 24, seed=8, spread=1.0)
    run("joint_main_path_dense", dense, None, timed=True)
    del main, dense
    small = kernel_inputs(torch, dev, flagship, 4, 24, seed=5)
    run("no_cross", small, 24, cross=False)
    run("no_attention", small, None, attention=False)
    run("no_tanh", small, 24, tanh=False)
    run("type_table", small, None, table=True)
    odd = kernel_inputs(torch, dev, flagship, 3, 23, np_pad=302, n_pocket=290, seed=6)
    run("odd_n_odd_rows", odd, 21, table=True)
    run("odd_n_all_rows", odd, None)
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

    def run(name, label, inp, call, plain_step, timed, update_rows=None,
            plain_timed=True):
        """``call(fn, sl)`` runs wrapper ``fn`` on batch slice ``sl``.  A timed
        case returns its time, error and bounds, and the plain version's time
        with ``plain_timed``."""
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
        pairs = active_pairs(ec, inp, rows=update_rows)
        F, N = inp["F"], inp["N"]
        work = bwd_work(pairs, B, N, F, 1 if name == "gcl_agg_bwd" else 2,
                        F if name == "gcl_agg_bwd" else 3)
        flops = work["flops"]
        t_f32, t_tc, t_bytes = flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS, \
            work["bytes"] / PEAK_BYTES
        res = dict(max_abs_err=worst_abs, ms=ms,
                   bound_ms=1e3 * max(t_f32, t_bytes),
                   bound_by="operations" if t_f32 >= t_bytes else "bytes",
                   # every product of both kernels runs in 3xTF32
                   bound_tc_ms=1e3 * max(t_tc, t_bytes),
                   bound_tc_by="operations" if t_tc >= t_bytes else "bytes")
        print(f"  {name}[{label}] kernel {ms:.4f} ms, active pairs {pairs}, "
              f"{flops / 1e9:.2f} GFLOP; f32 bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}), {100 * res['bound_ms'] / ms:.1f}% of it; 3xTF32 "
              f"bound {res['bound_tc_ms']:.4f} ms ({res['bound_tc_by']}), "
              f"{100 * res['bound_tc_ms'] / ms:.1f}% of it")
        if plain_timed:
            res["plain_ms"] = _cuda_ms(lambda: _plain_in_slices(
                torch, lambda sl: _name_cotangents(call(plain, sl), names), B,
                plain_step), 2)
            print(f"  {name}[{label}] plain version {res['plain_ms']:.4f} ms")
        return res

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
        return run("gcl_agg_bwd", label, inp, call, plain_step, timed)

    def coord_case(label, inp, cross=True, tanh=True, update_rows=None,
                   plain_step=2, timed=False, plain_timed=True):
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
        return run("coord_agg_bwd", label, inp, call, plain_step, timed, update_rows,
                   plain_timed)

    # the flagship training step: B = 16, ligands of 24-32 atoms padded to 32
    sizes = np.random.default_rng(0).integers(24, 33, 16)
    full = kernel_inputs(torch, dev, flagship, 16, 32, lig_sizes=sizes, seed=1)
    results["gcl_agg_bwd"] = gcl_case("train_full", full, timed=True)
    coord = coord_case("train_ligand_rows_cross", full, update_rows=32, timed=True)
    # the joint train step's coordinate launch: every row moves, and the noised
    # pocket is a dense graph (collapsed complex); the plain version untimed
    joint = kernel_inputs(torch, dev, flagship, 16, 32, lig_sizes=sizes, seed=5,
                          spread=1.0)
    jres = coord_case("joint_train_all_rows_collapsed", joint, timed=True,
                      plain_timed=False)
    del joint
    coord["max_abs_err"] = max(coord["max_abs_err"], jres.pop("max_abs_err"))
    results["coord_agg_bwd"] = {**coord, **{f"joint_{k}": v for k, v in jres.items()}}
    # the GCL kernel on a collapsed complex at the training shapes: full chunks
    dense = kernel_inputs(torch, dev, flagship, 16, 32, lig_sizes=sizes, seed=4,
                          spread=1.0)
    gcl_case("train_full_collapsed", dense)
    del dense
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
    the wall time (under the profiler, which adds host overhead).  A joint
    model runs the chain its main path runs: inpainting with the whole pocket
    fixed."""
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    from diffsbdd_tpu_torch.diffusion.ddpm import JointDDPM
    residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pocket_pdb), ref_lig)
    pocket = module.prepare_pocket(residues, repeats=n_samples)
    dev = pocket["x"].device
    lig_mask = torch.ones(n_samples, 24, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    if isinstance(module.ddpm, JointDDPM):
        ligand = {"x": torch.zeros(n_samples, 24, 3, device=dev),
                  "one_hot": torch.zeros(n_samples, 24, module.atom_nf, device=dev),
                  "mask": lig_mask}
        chain = lambda n: module.ddpm.inpaint(
            gen, ligand, pocket, lig_fixed=torch.zeros_like(lig_mask),
            pocket_fixed=pocket["mask"], timesteps=n)
    else:
        chain = lambda n: module.ddpm.sample_given_pocket(
            gen, pocket, lig_mask, timesteps=n, shared_pocket=True)
    chain(2)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    chain(steps)
    torch.cuda.synchronize()
    pass_ms = 1e3 * (time.perf_counter() - t) / (steps + 1)
    prof = _profile(torch, lambda: chain(steps), f"{steps} steps + prior + decode")
    if prof is not None:
        prof["pass_ms"] = pass_ms  # unprofiled, the decode pass counted
    return prof


def fuse_on_off_profiles(torch, ec, module, pocket_pdb, ref_lig, n_samples):
    """``profile_phase`` with block fusing off, on, on, off (in turns, on one
    card) -> {"off": [profile, profile], "on": [...]}, each with its launches."""
    profiles = {}
    for fuse in (False, True, True, False):
        module.ddpm.dynamics.kernel_block_fuse = fuse
        ec.reset_launch_counts()
        print(f"  block fusing {'on' if fuse else 'off'}")
        prof = profile_phase(torch, module, pocket_pdb, ref_lig, n_samples)
        if prof is not None:
            prof["launches"] = dict(ec.launch_counts)
            profiles.setdefault("on" if fuse else "off", []).append(prof)
    for key, runs in profiles.items():
        print(f"  block fusing {key}: " + "; ".join(
            f"{p['pass_ms']:.2f} ms per pass unprofiled; profiled wall "
            f"{p['wall_ms']:.2f} ms, device busy {p['busy_ms']:.2f} ms, idle share "
            f"{p['idle_share']:.3f}" for p in runs))
    return profiles


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
    # the whole-block kernel's two phases, each apart
    phases = {}
    for tag in ("block_phase_a", "block_phase_b"):
        hits = [e for e in events if tag in e.key]
        if hits:
            ms, count = sum(e.self_device_time_total for e in hits) / 1e3, \
                sum(e.count for e in hits)
            phases[tag] = dict(ms=ms, count=count)
            print(f"    {tag}: {ms:.3f} ms in {count} launches, {ms / count:.4f} ms each")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                idle_share=1 - busy_us / wall_us, top=top, phases=phases)


def small_reference_phase(torch, dev, work):
    """Phase 7: the fixture model sampled on the card (kernels) and on the
    CPU (plain twins) from the same injected noise must agree: as the
    conditional model it is, with the split kernels and with the whole-block
    kernel, and run as a joint model (every block the whole-block kernel, every
    row moving)."""
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    pdb = work / "small.pdb"
    ref_lig = write_pocket_pdb(pdb, n_atoms=60, seed=1)
    B, NL, T = 2, 8, FIXTURE_T
    residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pdb), ref_lig)

    def chain(mode, fuse, d, noise):
        ckpt = import_jax_npz(
            FIXTURE_NPZ, work / f"fixture_{mode}_{int(fuse)}",
            {"diffusion_params": {"diffusion_steps": T}, "mode": mode,
             "tpu": {"kernel_block_fuse": fuse}})
        module, _ = load_model(ckpt, device=d)
        queue = list(noise)
        module.ddpm.sample_gaussian = lambda g, shape, mask, q=queue: \
            torch.as_tensor(q.pop(0), device=mask.device) * mask[..., None]
        pocket = module.prepare_pocket(residues, repeats=B)
        lig_mask = torch.ones(B, NL, device=d)
        lig_mask[1, 6:] = 0.0
        if mode == "joint":
            xh, _ = module.ddpm.sample(None, (lig_mask, pocket["mask"]), timesteps=T)
        else:
            xh, _ = module.ddpm.sample_given_pocket(None, pocket, lig_mask,
                                                    shared_pocket=True)
        _check(not queue, "noise left over")
        return xh.cpu().numpy()

    rng = np.random.default_rng(0)
    n_pocket = padded_pocket_size(residues)
    for mode, fuse in (("pocket_conditioning", False), ("pocket_conditioning", True),
                       ("joint", True)):
        if mode == "joint":  # a joint draw: ligand x, pocket x, ligand h, pocket h
            shapes = [(B, NL, 3), (B, n_pocket, 3), (B, NL, 11), (B, n_pocket, 11)]
        else:
            shapes = [(B, NL, 3 + 11)]
        noise = [rng.standard_normal(sh).astype(np.float32)
                 for _ in range(T + 2) for sh in shapes]
        a = chain(mode, fuse, dev, noise)
        b = chain(mode, False, torch.device("cpu"), noise)
        dev_x = float(np.abs(a[..., :3] - b[..., :3]).max())
        flips = int((a[..., 3:].argmax(-1) != b[..., 3:].argmax(-1)).sum())
        print(f"  fixture T={T} {mode}, block fusing {'on' if fuse else 'off'}: card vs "
              f"CPU max coordinate deviation {dev_x:.3e} A, {flips} atom-type flips "
              f"(limit 1e-3 A, 0 flips)")
        _check(np.isfinite(a).all(), "non-finite samples on the card")
        _check(dev_x <= 1e-3 and flips == 0, "card and CPU samplers disagree")


def padded_pocket_size(residues, bucket=64):
    """Padded node count of a full-atom pocket made of ``residues``."""
    n = sum(1 for res in residues for a in res.atoms if a.element.capitalize() != "H")
    return -(-n // bucket) * bucket


# the training fields of configs/crossdock_fullatom_cond.yml (the network and
# diffusion fields come from snapshot_config, which fixes the same values)
TRAIN_FIELDS = dict(dataset="crossdock", batch_size=16, lr=1.0e-3, n_epochs=1,
                    clip_grad=True, accumulate_grad_batches=1, augment_noise=0,
                    augment_rotation=False, auxiliary_loss=False, virtual_nodes=False,
                    seed=42)
N_TRAIN, N_VAL = 96, 16


def flagship_train_config(flagship, datadir, logdir, mode="pocket_conditioning",
                          run_name="chip_smoke_train", block_fuse=False):
    """The config of a training run, checked against the mode's YAML preset
    where PyYAML is installed.  ``block_fuse`` goes into the checkpoint for the
    samplers; training never reads it."""
    cfg = {**flagship, **TRAIN_FIELDS, "mode": mode, "run_name": run_name,
           "datadir": str(datadir), "logdir": str(logdir),
           "tpu": {"kernel_block_fuse": block_fuse}}
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
    name = "crossdock_fullatom_joint.yml" if mode == "joint" \
        else "crossdock_fullatom_cond.yml"
    preset = yaml.safe_load((REPO / "configs" / name).read_text())
    full = load_config(overrides=cfg).to_dict()
    for key in ("egnn_params", "diffusion_params", "mode", "pocket_representation",
                *TRAIN_FIELDS):
        # cuts: one epoch, one seed, and no gradient accumulation (the joint
        # preset accumulates 4 batches), so that a few steps are a few updates
        if key in ("seed", "n_epochs", "accumulate_grad_batches"):
            continue
        want = preset[key]
        got = {k: full[key][k] for k in want} if isinstance(want, dict) else full[key]
        _check(got == want, f"config field {key} differs from the preset: {got} != {want}")
    return cfg


def train_phase(torch, ec, dev, flagship, out, work, pdb, ref_lig,
                mode="pocket_conditioning", n_train=N_TRAIN, block_fuse=False):
    """Phases 8 and 10: the port's cli.train at the flagship widths on a
    synthetic dataset (``n_train`` + 16 complexes), in ``mode``;
    for the conditional model also the trained checkpoint through
    cli.generate_ligands; then a profile of one step.  The result holds the
    checkpoint directory."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.cli import generate_ligands as gen_cli
    from diffsbdd_tpu_torch.cli import train as train_cli
    from diffsbdd_tpu_torch.train import loop

    n_pocket = sum(ln.startswith("ATOM") for ln in Path(pdb).read_text().splitlines())
    run_name = f"chip_smoke_train_{mode}"
    data = work / f"data_{mode}"
    # the sampled pocket's size is among the training sizes, so that the
    # checkpoint's size prior has seen it
    write_synthetic_dataset(data, n_train, N_VAL, seed=0,
                            pocket_sizes=(250, 265, 280, n_pocket, 310, 320))
    cfg = flagship_train_config(flagship, data, work / "runs", mode, run_name,
                                block_fuse)
    cfg_path = work / f"train_config_{mode}.json"
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
    n_steps, n_layers = n_train // 16, flagship["egnn_params"]["n_layers"]
    _check(len(train) == n_steps and len(val) == 1,
           f"{len(train)} train and {len(val)} val records")
    prev = dict.fromkeys(ec.KERNELS, 0)
    # training keeps the split kernels and their backward kernels, whatever
    # the block-fuse switch says
    want_step = {k: 0 if k == "block_fused" else n_layers for k in ec.KERNELS}
    for r in train:
        per_step = {k: r["launches"][k] - prev[k] for k in ec.KERNELS}
        _check(per_step == want_step,
               f"step {r['step']}: launches {per_step}, expected {want_step}")
        _check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
               f"step {r['step']}: loss {r['loss']}, grad_norm {r['grad_norm']}")
        prev = r["launches"]
    # validation: two network passes per batch (t and t = 0), forward only
    in_val = {k: val[0]["launches"][k] - prev[k] for k in ec.KERNELS}
    want_val = {"gcl_agg": 2 * n_layers * (N_VAL // 16), "coord_agg": 2 * n_layers * (N_VAL // 16),
                "gcl_agg_bwd": 0, "coord_agg_bwd": 0, "block_fused": 0}
    _check(in_val == want_val, f"validation launches {in_val}, expected {want_val}")
    _check(np.isfinite(val[0]["loss"]), f"validation loss {val[0]['loss']}")
    print(f"  launches per train step {n_layers}/{n_layers}/{n_layers}/{n_layers}/0 "
          f"(gcl, coord, gcl bwd, coord bwd, whole block) over {n_steps} steps; "
          f"validation {in_val}")
    print("  loss " + " ".join(f"{r['loss']:.4f}" for r in train)
          + f"; val {val[0]['loss']:.4f}")
    print("  grad_norm " + " ".join(f"{r['grad_norm']:.3f}" for r in train))

    state = captured["state"]
    moved = [float((p.detach() - p0).abs().max())
             for p, p0 in zip(state.module.parameters(), captured["initial"])]
    _check(np.isfinite(moved).all() and max(moved) > 0, "the parameters did not move")
    _check(state.step == n_steps, f"trainer step {state.step}")
    ckpt = work / "runs" / run_name / "checkpoints"
    for name in ("last", "best"):
        for suffix in (".pt", ".train.pt", ".config.json"):
            _check((ckpt / f"{name}{suffix}").exists(), f"no {name}{suffix}")

    # steady-state step time: the first step carries the libraries' loading
    steps_ms = [1e3 * (b["t"] - a["t"]) for a, b in zip(train, train[1:])]
    step_ms = float(np.median(steps_ms))
    print(f"  train step {step_ms:.2f} ms (median of {len(steps_ms)}; "
          + " ".join(f"{m:.1f}" for m in steps_ms) + f"), {16e3 / step_ms:.2f} "
          f"complexes/s; cli.train wall {wall:.2f} s")
    result = dict(launches=launches, per_step=n_layers, step_ms=step_ms,
                  steps_ms=steps_ms, complexes_per_s=16e3 / step_ms, cli_wall_s=wall,
                  losses=[r["loss"] for r in train], val_loss=val[0]["loss"],
                  grad_norms=[r["grad_norm"] for r in train], ckpt=str(ckpt),
                  datadir=str(data))

    if mode != "joint":
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

    # last: the profiled steps move the weights away from the checkpoint's
    print("  device time by kernel over one train step")
    train_step = loop.make_train_step(state)
    batch = next(iter(train_cli.PaddedLoader(
        train_cli.LigandPocketDataset(data / "train.npz"), 16, shuffle=False)))
    lig = loop.batch_to_device(batch["ligand"], dev)
    pkt = loop.batch_to_device(batch["pocket"], dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    train_step(gen, lig, pkt)  # warm-up
    torch.cuda.synchronize()
    result["breakdown"] = _profile(torch, lambda: train_step(gen, lig, pkt),
                                   "one train step")
    return result


def _sdf_molecules(path):
    """[(symbols, coords (n, 3))] of the V2000 blocks of an SDF file."""
    mols = []
    for blk in Path(path).read_text().split("$$$$")[:-1]:
        lines = blk.split("\n")
        i = next(k for k, ln in enumerate(lines) if ln.endswith("V2000"))
        n = int(lines[i][:3])
        rows = lines[i + 1:i + 1 + n]
        mols.append(([ln[31:34].strip() for ln in rows],
                     np.array([[float(ln[0:10]), float(ln[10:20]), float(ln[20:30])]
                               for ln in rows])))
    return mols


def _check_molecules(path, n_mols, n_atoms):
    mols = _sdf_molecules(path)
    _check(len(mols) == n_mols, f"{path.name} holds {len(mols)} molecules")
    for symbols, coords in mols:
        _check(len(symbols) == n_atoms, f"a molecule does not have {n_atoms} atoms")
        _check(np.isfinite(coords).all(), "non-finite coordinates")
    return mols


def joint_phase(torch, ec, dev, flagship, out, work, pdb, ref_lig, n_samples):
    """Phases 10 and 10b: cli.train in mode joint, then cli.generate_ligands
    on that checkpoint with block fusing on: a joint checkpoint inpaints with
    the whole pocket fixed, and every block of every pass is the whole-block
    kernel; then a 5-step chain on the same inputs profiled with block fusing
    on and off."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.cli import generate_ligands as gen_cli
    from diffsbdd_tpu_torch.diffusion.ddpm import JointDDPM
    training = train_phase(torch, ec, dev, flagship, out, work, pdb, ref_lig,
                           mode="joint", n_train=48, block_fuse=True)
    T = flagship["diffusion_params"]["diffusion_steps"]
    n_layers = flagship["egnn_params"]["n_layers"]
    # network passes: one per entry of the RePaint plan, and the decode
    passes = len(JointDDPM._repaint_plan(1, 1, T)[0]) + 1
    sdf = out / "joint_samples.sdf"
    ec.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_cli.main([training["ckpt"], "--pdbfile", str(pdb),
                  "--ref_ligand", ref_lig, "--outfile", str(sdf), "--n_samples",
                  str(n_samples), "--num_nodes_lig", "24", "--all_frags",
                  "--timesteps", str(T), "--resamplings", "1", "--jump_length", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ec.launch_counts)
    expected = {**dict.fromkeys(ec.KERNELS, 0), "block_fused": n_layers * passes}
    print(f"  launches {launches}, expected {expected} ({passes} passes)")
    _check(launches == expected, "launch counts differ from the joint path's")
    _check_molecules(sdf, n_samples, 24)
    pass_ms = 1e3 * wall / passes
    print(f"  {n_samples} molecules, T={T}, N=24+320: CLI wall {wall:.2f} s "
          f"({pass_ms:.2f} ms per pass, checkpoint load and host work included), "
          f"{n_samples / wall:.3f} molecules/s")

    print("[10b] a 5-step joint chain with block fusing on and off")
    module, _ = load_model(training["ckpt"], device=dev)
    profiles = fuse_on_off_profiles(torch, ec, module, pdb, ref_lig, n_samples)
    return dict(training=training, launches=launches, passes=passes,
                cli_wall_s=wall, pass_ms=pass_ms, molecules_per_s=n_samples / wall,
                profiles=profiles)


def inpaint_phase(torch, ec, dev, flagship, out, work, pdb, ref_lig, n_samples=16,
                  T=50, R=3):
    """Phases 11 and 11b: cli.inpaint on the imported flagship checkpoint with
    block fusing on, then the 5-step chain profiled with it on and off."""
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
    from diffsbdd_tpu_torch.cli import inpaint as inpaint_cli
    ckpt = import_jax_npz(R05C_NPZ, work / "r05c_fused",
                          {"tpu": {"kernel_block_fuse": True}})
    fixed = ["C0", "C1", "C2", "C3", "N8", "O10"]
    n_layers = flagship["egnn_params"]["n_layers"]
    passes = T * R + 1
    sdf = out / "inpainted.sdf"
    ec.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inpaint_cli.main([str(ckpt), "--pdbfile", str(pdb), "--ref_ligand", ref_lig,
                      "--fix_atoms", *fixed, "--add_n_nodes", "18", "--outfile",
                      str(sdf), "--n_samples", str(n_samples), "--timesteps", str(T),
                      "--resamplings", str(R)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ec.launch_counts)
    # in the T * R passes of the chain block 0 keeps the shared-pocket split
    # path (3 GCL launches, 1 coordinate launch) and blocks 1.. are the
    # whole-block kernel; the decode pass shares no pocket: all blocks fused
    chain = passes - 1
    expected = {**dict.fromkeys(ec.KERNELS, 0), "gcl_agg": 3 * chain,
                "coord_agg": chain, "block_fused": (n_layers - 1) * chain + n_layers}
    print(f"  launches {launches}, expected {expected} ({passes} passes)")
    _check(launches == expected, "launch counts differ from the inpainting path's")
    mols = _check_molecules(sdf, n_samples, len(fixed) + 18)
    # the fixed atoms lead each molecule; the frame is shifted back onto the
    # pocket, so they must sit where the reference ligand has them, up to the
    # noise of the last level (sigma_0 ~ 0.02 A) and of the CoM alignment
    want = {ln[12:16].strip(): [float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
            for ln in Path(pdb).read_text().splitlines() if ln.startswith("HETATM")}
    want = np.array([want[name] for name in fixed])
    off = max(float(np.abs(coords[:len(fixed)] - want).max()) for _, coords in mols)
    for symbols, _ in mols:
        _check(symbols[:len(fixed)] == [n[0] for n in fixed], "fixed atom types changed")
    print(f"  {n_samples} molecules of {len(fixed)} fixed + 18 new atoms, T={T} x {R} "
          f"resamplings: CLI wall {wall:.2f} s ({1e3 * wall / passes:.2f} ms per pass); "
          f"fixed atoms within {off:.3f} A of their place (limit 0.5 A)")
    _check(off <= 0.5, "the fixed atoms moved")

    print("[11b] the 5-step chain with block fusing on and off")
    module, _ = load_model(ckpt, device=dev)
    profiles = fuse_on_off_profiles(torch, ec, module, pdb, ref_lig, n_samples)
    return dict(launches=launches, passes=passes, cli_wall_s=wall,
                pass_ms=1e3 * wall / passes, fixed_atoms_off=off, profiles=profiles)


def chain_launches(ec, n_layers: int, shared_passes: int) -> dict:
    """Launches of a conditional chain of ``shared_passes`` shared-pocket
    passes and one decode pass: a shared pass runs the GCL kernel 3 times in
    the first layer and once in each later one, the coordinate kernel once a
    layer; the decode pass shares no pocket."""
    return {**dict.fromkeys(ec.KERNELS, 0),
            "gcl_agg": (n_layers + 2) * shared_passes + n_layers,
            "coord_agg": n_layers * (shared_passes + 1)}


def _scaled(counts: dict, k: int) -> dict:
    return {name: k * n for name, n in counts.items()}


def _type_indices(encoder, symbols):
    """Type indices of SDF atom symbols; the SDF cuts the type "others" to
    its first three letters."""
    return np.array([encoder["others" if s == "oth" else s] for s in symbols])


def first_molecule_sdf(sdf, out, encoder):
    """The first molecule of ``sdf`` whose atoms are all of ligand types
    other than "others" (which an SDF cannot spell), alone in ``out``."""
    from diffsbdd_tpu_torch.chem.sdfio import read_sdf, write_sdf_file
    mol = next(m for m in read_sdf(sdf) if set(m.symbols) <= set(encoder) - {"others"})
    write_sdf_file(out, [mol])
    return out


def test_set_phase(torch, ec, flagship, ckpt, work, ligand_sdf, n_samples=16):
    """Phase 12: cli.test_set over 2 synthetic pockets, one batch each."""
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    from diffsbdd_tpu_torch.cli import test_set as test_set_cli
    from diffsbdd_tpu_torch.diffusion.ddpm import ConditionalDDPM
    T = flagship["diffusion_params"]["diffusion_steps"]
    n_layers = flagship["egnn_params"]["n_layers"]
    test_dir, outdir = work / "test_set", work / "test_set_out"
    test_dir.mkdir()
    names = []
    for seed in (0, 1):
        pdb = test_dir / f"pkt{seed}.pdb"
        ref = write_pocket_pdb(pdb, n_atoms=300, seed=seed)
        name = f"pkt{seed}_A_LIG"
        (test_dir / f"{name}.sdf").write_text(Path(ligand_sdf).read_text())
        residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pdb), ref)
        (test_dir / f"{name}.txt").write_text(
            " ".join(f"{r.chain_id}:{r.resseq}" for r in residues))
        names.append(name)
    sample, sample_s = ConditionalDDPM.sample_given_pocket, []

    def timed_sample(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = sample(self, *a, **k)
        torch.cuda.synchronize()
        sample_s.append(time.perf_counter() - t)
        return result

    ConditionalDDPM.sample_given_pocket = timed_sample
    ec.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        test_set_cli.main([str(ckpt), "--test_dir", str(test_dir), "--outdir", str(outdir),
                           "--n_samples", str(n_samples), "--batch_size", str(n_samples),
                           "--fix_n_nodes", "--all_frags", "--timesteps", str(T)])
    finally:
        ConditionalDDPM.sample_given_pocket = sample
    wall = time.perf_counter() - t0
    launches = dict(ec.launch_counts)
    expected = _scaled(chain_launches(ec, n_layers, T), len(names))
    print(f"  launches {launches}, expected {expected} (one chain of {T} shared-pocket "
          f"passes and a decode pass for each of {len(names)} pockets)")
    _check(launches == expected, "launch counts differ from the test-set path's")
    layout = sorted(p.relative_to(outdir).as_posix() for p in outdir.rglob("*"))
    want = sorted(["raw", "processed", "pocket_times", "pocket_times.txt"]
                  + [f"{d}/{n}_gen.sdf" for d in ("raw", "processed") for n in names]
                  + [f"pocket_times/{n}.txt" for n in names])
    _check(layout == want, f"test-set output layout {layout}")
    for name in names:
        _check_molecules(outdir / "processed" / f"{name}_gen.sdf", n_samples, 24)
        _check_molecules(outdir / "raw" / f"{name}_gen.sdf", n_samples, 24)
    per_pocket = [float(ln.split()[-1]) for ln in
                  (outdir / "pocket_times.txt").read_text().splitlines()]
    _check(len(per_pocket) == len(names), "pocket_times.txt lines")
    _check(len(sample_s) == len(names), f"{len(sample_s)} sampling chains")
    sample_s = sum(sample_s) / len(names)
    pocket_s = sum(per_pocket) / len(names)
    print(f"  {len(names)} pockets x {n_samples} molecules, T={T}: "
          f"{', '.join(f'{t:.2f}' for t in per_pocket)} s per pocket "
          f"({pocket_s / n_samples:.3f} s per molecule): sampling {sample_s:.2f} s, "
          f"host {pocket_s - sample_s:.2f} s a pocket; CLI wall {wall:.2f} s")
    return dict(launches=launches, pocket_s=per_pocket, sample_s_per_pocket=sample_s,
                host_s_per_pocket=pocket_s - sample_s, s_per_molecule=pocket_s / n_samples,
                cli_wall_s=wall)


def optimize_phase(torch, ec, flagship, ckpt, out, pdb, ligand_sdf, population=16,
                   generations=2, steps=100):
    """Phase 13: cli.optimize, objective SA, on phase 5's pocket."""
    import csv
    from diffsbdd_tpu_torch.cli import optimize as opt_cli
    n_layers = flagship["egnn_params"]["n_layers"]
    built, seconds = [], []
    diversify = opt_cli.diversify_ligands

    def counted(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mols = diversify(*a, **k)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        built.append(len(mols))
        return mols

    sdf = out / "optimized.sdf"
    opt_cli.diversify_ligands = counted
    ec.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        opt_cli.main([str(ckpt), "--pdbfile", str(pdb), "--ref_ligand", str(ligand_sdf),
                      "--objective", "sa", "--population_size", str(population),
                      "--evolution_steps", str(generations), "--timesteps", str(steps),
                      "--top_k", "4", "--outfile", str(sdf)])
    finally:
        opt_cli.diversify_ligands = diversify
    wall = time.perf_counter() - t0
    launches = dict(ec.launch_counts)
    expected = _scaled(chain_launches(ec, n_layers, steps), generations)
    print(f"  launches {launches}, expected {expected} (a diversify chain of {steps} "
          f"shared-pocket passes and a decode pass for each of {generations} generations)")
    _check(launches == expected, "launch counts differ from the optimization path's")
    with open(sdf.with_suffix(".csv")) as f:
        rows = list(csv.reader(f))
    _check(rows[0] == ["", "generation", "score", "fate", "smiles"], f"CSV header {rows[0]}")
    _check(len(rows) == 2 + sum(built), f"{len(rows) - 1} CSV rows for {sum(built)} "
           "built molecules and the reference")
    _check(rows[1][1] == "0" and rows[1][3] == "initial", "CSV reference row")
    _check([int(r[1]) for r in rows[2:]] == [g + 1 for g, n in enumerate(built)
                                             for _ in range(n)], "CSV generations")
    _check(all(np.isfinite(float(r[2])) for r in rows[1:]), "non-finite score")
    mols = _sdf_molecules(sdf)
    _check(len(mols) == built[-1], f"{sdf.name} holds {len(mols)} molecules")
    for _, coords in mols:
        _check(np.isfinite(coords).all(), "non-finite coordinates")
    best = max(float(r[2]) for r in rows[2:]) if len(rows) > 2 else float("nan")
    print(f"  population {population}, {generations} generations of {steps} steps: "
          f"molecules kept {built}, reference SA {float(rows[1][2]):.2f}, best {best:.2f}; "
          f"{', '.join(f'{t:.2f}' for t in seconds)} s per generation in diversify, "
          f"CLI wall {wall:.2f} s ({wall / generations:.2f} s per generation)")
    return dict(launches=launches, built=built, diversify_s=seconds, cli_wall_s=wall,
                s_per_generation=wall / generations)


def serving_phase(torch, ec, flagship, ckpt, pdb, ref_lig, n_samples=16, steps=100):
    """Phase 14: a SamplingServer through its JSON-lines loop."""
    import io
    from diffsbdd_tpu_torch.cli.serve import SamplingServer
    n_layers = flagship["egnn_params"]["n_layers"]
    server = SamplingServer(ckpt)
    shape = {"pdbfile": str(pdb), "ref_ligand": ref_lig, "n_samples": n_samples,
             "num_nodes_lig": 24, "timesteps": steps}
    requests = [{"op": "ping", "id": 0}, {"op": "info", "id": 1},
                {"op": "warmup", "id": 2, **shape},
                {"op": "generate", "id": 3, "seed": 11, **shape},
                {"op": "generate", "id": 4, "seed": 11, **shape},
                {"op": "generate", "id": 5, **shape}]
    lines = [json.dumps(r) for r in requests] + ["{not json", json.dumps({"op": "shutdown"}),
                                                 json.dumps({"op": "ping", "id": 9})]
    per_request, handle = [], server.handle

    def measured(req):
        ec.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        reply = handle(req)
        torch.cuda.synchronize()
        per_request.append((req.get("op"), time.perf_counter() - t, dict(ec.launch_counts)))
        return reply

    server.handle = measured
    out = io.StringIO()
    server.serve_forever(io.StringIO("\n".join(lines) + "\n"), out)
    replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
    _check(len(replies) == 8, f"{len(replies)} replies to 8 requests before shutdown")
    ping, info, warm, gen_a, gen_b, gen_c, bad, stop = replies
    _check(ping == {"ok": True, "id": 0}, f"ping reply {ping}")
    _check(info.get("ok") and info["id"] == 1 and info["T"] ==
           flagship["diffusion_params"]["diffusion_steps"] and info["requests"] == 0,
           f"info reply {info}")
    _check(warm.get("ok") and warm["n_molecules"] == n_samples, f"warmup reply {warm}")
    for rep in (gen_a, gen_b, gen_c):
        _check(rep.get("ok") and rep["n_molecules"] == n_samples
               and len(rep["smiles"]) == n_samples, f"generate reply {rep}")
    _check((gen_a["smiles"], gen_a["n_atoms"]) == (gen_b["smiles"], gen_b["n_atoms"]),
           "two generates with one seed differ")
    _check(bad["error"].startswith("bad request"), f"malformed-line reply {bad}")
    _check(stop == {"ok": True, "shutdown": True}, f"shutdown reply {stop}")
    chain = chain_launches(ec, n_layers, steps)
    idle = dict.fromkeys(ec.KERNELS, 0)
    want = {"ping": idle, "info": idle, "warmup": chain, "generate": chain,
            "shutdown": idle}
    for op, _, counts in per_request:
        _check(counts == want[op], f"{op} launched {counts}, expected {want[op]}")
    walls = {f"{op}[{k}]": s for k, (op, s, _) in enumerate(per_request)}
    cold = per_request[2][1]
    warm_s = [s for op, s, _ in per_request[3:6]]
    print(f"  {len(replies)} replies; launches per generate and warmup {chain}; "
          f"the seeded replies identical ({len(set(gen_a['smiles']))} distinct keys of "
          f"{n_samples}); cold (warmup) request {cold:.2f} s, warm requests "
          f"{', '.join(f'{s:.2f}' for s in warm_s)} s ({n_samples} molecules of 24 atoms, "
          f"{steps} steps)")
    totals = {k: sum(c[k] for _, _, c in per_request) for k in ec.KERNELS}
    return dict(launches=totals, walls=walls, cold_s=cold, warm_s=warm_s)


# the config fields a Lightning checkpoint's hyper-parameters hold, besides
# the four nested namespaces and the size histogram
LIGHTNING_FIELDS = ("dataset", "mode", "pocket_representation", "virtual_nodes",
                    "batch_size", "lr", "clip_grad", "augment_noise", "augment_rotation",
                    "auxiliary_loss", "eval_epochs", "visualize_sample_epoch",
                    "visualize_chain_epoch")


def write_lightning_ckpt(torch, ckpt, path, node_histogram):
    """The port checkpoint ``ckpt`` (``best``) as a reference-format Lightning
    file: the state_dict in the reference's names with the schedule's table
    ``ddpm.gamma.gamma`` (the tied cross head is under both keys already),
    and hyper-parameters of ``argparse.Namespace`` values with the size
    histogram."""
    from argparse import Namespace
    from diffsbdd_tpu_torch.checkpoint import load_model
    module, cfg = load_model(ckpt, device="cpu")
    cfg = cfg.to_dict()
    state_dict = {k.replace("ddpm.gamma_net.", "ddpm.gamma."): v
                  for k, v in module.state_dict().items()}
    state_dict["ddpm.gamma.gamma"] = module.ddpm.gamma_table.clone()
    hparams = {k: cfg[k] for k in LIGHTNING_FIELDS}
    hparams.update({k: Namespace(**cfg[k]) for k in ("egnn_params", "diffusion_params",
                                                       "loss_params", "eval_params")})
    hparams["node_histogram"] = node_histogram
    torch.save({"state_dict": state_dict, "hyper_parameters": hparams, "epoch": 0,
                "global_step": 0}, path)
    return path


def lightning_phase(torch, ec, dev, flagship, ckpt, work, out, pdb, ref_lig,
                    node_histogram, n_samples=4):
    """Phase 15: phase 4's r05c checkpoint written as a reference Lightning
    file, imported by ``python -m diffsbdd_tpu_torch.convert.torch_ckpt``;
    both load to bitwise-equal weights and sample identical SDFs from one
    seed."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.cli import generate_ligands as gen_cli
    T = flagship["diffusion_params"]["diffusion_steps"]
    n_layers = flagship["egnn_params"]["n_layers"]
    path = write_lightning_ckpt(torch, ckpt, work / "r05c.ckpt", node_histogram)
    imported = work / "r05c_lightning"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "diffsbdd_tpu_torch.convert.torch_ckpt",
                    str(path), "--outdir", str(imported)], cwd=REPO, check=True)
    import_s = time.perf_counter() - t0
    (a, _), (b, cfg) = load_model(ckpt, device=dev), load_model(imported, device=dev)
    sd_a, sd_b = a.state_dict(), b.state_dict()
    _check(sd_a.keys() == sd_b.keys() and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a),
           "the imported weights differ from the checkpoint's")
    _check(b.ddpm.size_distribution is not None, "the import lost the size histogram")
    del a, b
    sdfs, launches, walls = [], [], []
    for name, d in (("r05c", ckpt), ("imported", imported)):
        sdf = out / f"lightning_{name}.sdf"
        ec.reset_launch_counts()
        t0 = time.perf_counter()
        gen_cli.main([str(d), "--pdbfile", str(pdb), "--ref_ligand", ref_lig,
                      "--outfile", str(sdf), "--n_samples", str(n_samples),
                      "--num_nodes_lig", "24", "--all_frags", "--timesteps", str(T),
                      "--seed", "3"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(dict(ec.launch_counts))
        _check_molecules(sdf, n_samples, 24)
        sdfs.append(sdf.read_text())
    _check(sdfs[0] == sdfs[1], "the imported checkpoint samples other molecules")
    expected = chain_launches(ec, n_layers, T)
    _check(launches == [expected, expected], f"launches {launches}, expected {expected}")
    print(f"  {len(sd_a)} tensors bitwise equal; import (a process of its own) "
          f"{import_s:.2f} s; seeded cli.generate_ligands, {n_samples} molecules, T={T}: "
          f"identical SDFs, CLI wall {walls[0]:.2f} s (r05c), {walls[1]:.2f} s (imported); "
          f"launches each {expected}; imported config "
          f"{cfg.dataset}/{cfg.mode}/{cfg.pocket_representation}")
    return dict(launches=launches[1], import_s=import_s, cli_wall_s=walls,
                tensors=len(sd_a))


def _check_metrics(metrics, minus_one):
    """Every metric finite; those JAX leaves uncomputed at exactly -1."""
    print("  " + json.dumps(metrics))
    for k, v in metrics.items():
        _check(np.isfinite(v), f"metric {k} = {v}")
    for k in minus_one:
        _check(metrics[k] == -1.0, f"metric {k} = {metrics[k]}, expected -1")


def evaluation_phase(torch, ec, dev, flagship, work, out, training, joint):
    """Phase 16: the port's SamplingEvaluator on the card -- phase 8's
    conditional checkpoint on its validation pockets, phase 10's joint
    checkpoint with block fusing on -- and cli.train with eval_epochs 1, so
    that the evaluator runs through Trainer.fit.  Nothing is rendered: the
    chains and samples are written as xyz files only."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.cli import train as train_cli
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset
    from diffsbdd_tpu_torch.train import loop
    from diffsbdd_tpu_torch.train.evaluation import SamplingEvaluator
    T = flagship["diffusion_params"]["diffusion_steps"]
    L = flagship["egnn_params"]["n_layers"]
    idle = dict.fromkeys(ec.KERNELS, 0)
    # no shared pocket: one GCL and one coordinate launch a layer and pass
    split_chain = {**idle, "gcl_agg": L * (T + 1), "coord_agg": L * (T + 1)}
    fused_chain = {**idle, "block_fused": L * (T + 1)}
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = {}

    def run(what, expected, fn):
        ec.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = dict(ec.launch_counts)
        print(f"  {what}: {seconds:.2f} s, launches {launches}")
        _check(launches == expected, f"{what}: launches {launches}, expected {expected}")
        calls[what] = dict(s=seconds, launches=launches)
        return result

    def chain_files(ev, n):
        files = sorted((ev.outdir / "epoch_0" / "chain").glob("chain_*.txt"))
        _check(len(files) == n, f"{len(files)} chain frames, expected {n}")

    module, _ = load_model(training["ckpt"], name="last", device=dev)
    ev = SamplingEvaluator(module, outdir=out / "evaluation" / "cond",
                           dataset=LigandPocketDataset(Path(training["datadir"]) / "val.npz"))
    cond = run("conditional sample_and_analyze, 16 samples in one batch", split_chain,
               lambda: ev.sample_and_analyze(gen, 16, batch_size=16))
    # full-atom pockets: no residue-type KL; no training keys: no novelty
    _check_metrics(cond, minus_one={"kl_div_residue_types", "Novelty"})
    run("conditional sample_and_save, 4 samples", split_chain,
        lambda: ev.sample_and_save(gen, 4, render=False))
    _check(len(list((ev.outdir / "epoch_0").glob("molecule_*.txt"))) == 4, "xyz samples")
    # keep_frames 10 of T = 500: a frame every 50 steps, the decoded sample last
    run("conditional chain, keep_frames 10, B = 1", split_chain,
        lambda: ev.sample_chain_and_save(gen, 10, render=False))
    chain_files(ev, 10)
    del module, ev

    module, _ = load_model(joint["training"]["ckpt"], name="last", device=dev)
    ev = SamplingEvaluator(module, outdir=out / "evaluation" / "joint")
    joint_metrics = run("joint sample_and_analyze, 8 samples (block fusing on)",
                        fused_chain, lambda: ev.sample_and_analyze(gen, JOINT_SAMPLES))
    _check_metrics(joint_metrics, minus_one={"kl_div_residue_types", "Novelty"})
    run("joint chain, keep_frames 10, B = 1", fused_chain,
        lambda: ev.sample_chain_and_save(gen, 10, render=False))
    chain_files(ev, 10)
    del module, ev

    print("  cli.train, one epoch with eval_epochs 1")
    run_name = "chip_smoke_train_eval"
    cfg = flagship_train_config(flagship, training["datadir"], work / "runs",
                                run_name=run_name)
    cfg.update(eval_epochs=1, visualize_sample_epoch=2, visualize_chain_epoch=2,
               eval_params=dict(n_eval_samples=4, eval_batch_size=4,
                                n_visualize_samples=1, keep_frames=10))
    cfg_path = work / "train_eval_config.json"
    cfg_path.write_text(json.dumps(cfg))
    logged, trainer_log = [], loop.Trainer.log
    loop.Trainer.log = lambda self, metrics, split, step: logged.append(
        {f"{k}/{split}": float(v) for k, v in metrics.items()})
    n_steps = N_TRAIN // 16
    try:
        run("cli.train, 1 epoch + validation + evaluation of 4 samples",
            {**idle, "gcl_agg": L * (n_steps + 2 + T + 1),
             "coord_agg": L * (n_steps + 2 + T + 1), "gcl_agg_bwd": L * n_steps,
             "coord_agg_bwd": L * n_steps},
            lambda: train_cli.main(["--config", str(cfg_path)]))
    finally:
        loop.Trainer.log = trainer_log
    evals = [m for m in logged if "Validity/val" in m]
    _check(len(evals) == 1, f"{len(evals)} evaluations logged, expected 1")
    _check_metrics(evals[0], minus_one={"kl_div_residue_types/val", "Novelty/val"})
    _check(not (work / "runs" / run_name / "eval").exists(), "the run rendered")
    return dict(calls=calls, cond=cond, joint=joint_metrics, trainer=evals[0],
                launches={k: max(c["launches"][k] for c in calls.values())
                          for k in ec.KERNELS})


def processing_phase(work, ligand_sdf):
    """Phase 17: a raw CrossDocked layout of 6 pairs (synthetic pockets at
    seeds 0-5, each with phase 6's first molecule as its ligand, a .json
    split of 4/1/1) through the port's proc_crossdock, full-atom and CA;
    host only."""
    import shutil
    from diffsbdd_tpu_torch.chem.sdfio import read_sdf
    from diffsbdd_tpu_torch.data import proc_crossdock
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset
    raw = work / "crossdocked"
    pockets = raw / "crossdocked_pocket10"
    pockets.mkdir(parents=True)
    pairs = []
    for seed in range(6):
        write_pocket_pdb(pockets / f"pocket{seed}.pdb", n_atoms=300, seed=seed)
        shutil.copy(ligand_sdf, pockets / f"pocket{seed}_lig.sdf")
        pairs.append([f"pocket{seed}.pdb", f"pocket{seed}_lig.sdf"])
    (raw / "split.json").write_text(json.dumps(
        {"train": pairs[:4], "val": pairs[4:5], "test": pairs[5:]}))
    n_lig = len(read_sdf(ligand_sdf)[0].symbols)
    result = {}
    for rep, widths in (("full-atom", (11, 11)), ("CA", (10, 20))):
        outdir = work / f"processed_{rep}"
        t0 = time.perf_counter()
        proc_crossdock.main([str(raw), "--outdir", str(outdir), "--split_file",
                             str(raw / "split.json")] + (["--ca_only"] if rep == "CA" else []))
        host_s = time.perf_counter() - t0
        sizes = []
        for split, n in (("train", 4), ("val", 1), ("test", 1)):
            ds = LigandPocketDataset(outdir / f"{split}.npz")
            _check(len(ds) == n, f"{rep} {split}: {len(ds)} complexes, expected {n}")
            for item in (ds[i] for i in range(n)):
                _check(item["lig_coords"].shape == (n_lig, 3)
                       and item["lig_one_hot"].shape[1] == widths[0]
                       and item["pocket_one_hot"].shape[1] == widths[1]
                       and len(item["pocket_coords"]) > 0, f"{rep} {split}: shapes")
                if split == "train":
                    sizes.append(len(item["pocket_coords"]))
        hist = np.load(outdir / "size_distribution.npy")
        _check(hist.shape == (n_lig + 1, max(sizes) + 1)
               and all(hist[n_lig, s] > 0 for s in sizes), f"{rep}: size histogram {hist.shape}")
        smiles = np.load(outdir / "train_smiles.npy", allow_pickle=True)
        _check(len(smiles) == 4, f"{rep}: {len(smiles)} training smiles")
        print(f"  {rep}: 4/1/1 complexes of {n_lig} ligand atoms, training pockets of "
              f"{sizes} nodes, size histogram {hist.shape}, {len(smiles)} smiles; "
              f"host {host_s:.2f} s")
        result[rep] = dict(host_s=host_s, pocket_sizes=sizes, hist_shape=list(hist.shape))
    return result


# ---------------------------------------------------------------------------
# phase 18: the multi-device paths (parallel/) on the one card
# ---------------------------------------------------------------------------

# the edge-sharded and data-parallel checks against one process on the card:
# float32 on both sides, every sum of a pair MLP split into two column blocks
# or two batch halves (another order, and another grid for the backward
# kernels): values atol 1e-4 + rtol 1e-4 through the flagship's six layers;
# every parameter gradient within PAR_GRAD_RTOL of its largest entry, phase
# 9's gate for gradients through several layers summed in another order (the
# sum-of-squares loss of unnormalized coordinates gives entries up to ~1e5,
# so an elementwise gate would hold the small ones to the large ones'
# rounding); the train step's metrics atol 1e-5 + rtol 1e-4
PAR_VALUE_TOL = dict(atol=1e-4, rtol=1e-4)
PAR_GRAD_RTOL = 1e-3
PAR_INFO_TOL = dict(atol=1e-5, rtol=1e-4)
PAR_SEED = 18


def column_mask_phase(ec, torch, dev, flagship, variant_ms):
    """Phase 18a: the two coordinate kernels on the two column blocks of a
    two-rank edge split at the flagship shapes -- each block against its
    plain version, the blocks' sum against the whole-graph launch -- with
    each block's time beside the whole graph's."""
    from diffsbdd_tpu_torch.parallel.edge_shard import ShardContext, column_range

    def blocks(inp):
        return [ShardContext(None, *column_range(inp["N"], r, 2)).col_mask(inp["mask"])
                for r in range(2)]

    # forward: phase 3's main-path launch (B = 16, 24 ligand rows, cross on)
    inp = kernel_inputs(torch, dev, flagship, 16, 24)
    kw = dict(cutoffs=inp["cut"], tanh=True, coords_range=15.0, norm_constant=1.0,
              normalization_factor=100.0, update_rows=24, cross=inp["cross"],
              graph_mean=inp["graph_mean"])

    def fwd(fn, cm):
        return fn(inp["a_row"], inp["a_col"], inp["x"], inp["x0"], inp["mask"],
                  inp["is_lig"], *inp["coord_w"], col_mask=cm, **kw)

    tol = dict(atol=1e-5, rtol=1e-4)

    def close(what, got, ref):
        err = float((got - ref).abs().max())
        bad = float(((got - ref).abs() - (tol["atol"] + tol["rtol"] * ref.abs())).max())
        _check(bad <= 0.0, f"{what}: error {err:.3e} over atol 1e-5 + rtol 1e-4")
        return err

    whole = fwd(ec.coord_update_agg, None)
    res = {"coord_agg": {"whole_ms": _cuda_ms(lambda: fwd(ec.coord_update_agg, None), 20),
                         "blocks": []}}
    parts = []
    for r, cm in enumerate(blocks(inp)):
        got = fwd(ec.coord_update_agg, cm)
        err = close(f"coord_agg column block {r}", got, fwd(ec.coord_update_agg_plain, cm))
        parts.append(got)
        res["coord_agg"]["blocks"].append(dict(
            max_abs_err=err, ms=_cuda_ms(lambda: fwd(ec.coord_update_agg, cm), 20),
            pairs=active_pairs(ec, inp, rows=24, col_mask=cm)))
    res["coord_agg"]["sum_err"] = close("coord_agg block sum", parts[0] + parts[1], whole)

    # backward: phase 3b's training launch (B = 16, ligands of 24-32 atoms
    # padded to 32, cross and tanh on)
    sizes = np.random.default_rng(0).integers(24, 33, 16)
    full = kernel_inputs(torch, dev, flagship, 16, 32, lig_sizes=sizes, seed=1)
    g = full["r"](16, full["N"], 3)
    w_d2, w_d20, _, w2, b2, w3 = full["coord_w"]
    c = {k: v for k, v in full["cross"].items() if k != "type_bias"}
    c["delta"] = full["cross_delta"]

    def bwd(fn, cm, sl=slice(0, 16)):
        return _name_cotangents(fn(
            g[sl], full["a_row"][sl], full["a_col"][sl], full["x"][sl], full["x0"][sl],
            full["mask"][sl], full["is_lig"][sl], w_d2, w_d20, full["coord_delta"], w2,
            b2, w3, cutoffs=full["cut"], tanh=True, coords_range=15.0,
            norm_constant=1.0, normalization_factor=100.0,
            cross={k: (v[sl] if k in ("a_row", "a_col") else v) for k, v in c.items()},
            graph_mean=full["graph_mean"][sl], col_mask=None if cm is None else cm[sl],
            update_rows=32), COORD_COT)

    def bwd_close(what, got, ref):
        worst = 0.0
        for name, r in ref.items():
            if r is None:
                continue
            scale, err = float(r.abs().max()), float((got[name] - r).abs().max())
            _check(err <= BWD_RTOL * scale + 1e-7,
                   f"{what} {name}: error {err:.3e} against scale {scale:.3e}")
            worst = max(worst, err / (scale + 1e-30))
        return worst

    whole = bwd(ec.coord_agg_bwd, None)
    res["coord_agg_bwd"] = {"whole_ms": _cuda_ms(lambda: bwd(ec.coord_agg_bwd, None), 20),
                            "blocks": []}
    parts = []
    for r, cm in enumerate(blocks(full)):
        got = bwd(ec.coord_agg_bwd, cm)
        ref = _plain_in_slices(torch, lambda sl: bwd(ec.coord_agg_bwd_plain, cm, sl), 16, 2)
        rel = bwd_close(f"coord_agg_bwd column block {r}", got, ref)
        parts.append(got)
        res["coord_agg_bwd"]["blocks"].append(dict(
            worst_rel_err=rel, ms=_cuda_ms(lambda: bwd(ec.coord_agg_bwd, cm), 20),
            pairs=active_pairs(ec, full, rows=32, col_mask=cm)))
    summed = {k: None if v is None else v + parts[1][k] for k, v in parts[0].items()}
    res["coord_agg_bwd"]["sum_worst_rel_err"] = bwd_close("coord_agg_bwd block sum",
                                                          summed, whole)
    for name, phase, label in (("coord_agg", "3", "coord_agg[ligand_rows_cross]"),
                               ("coord_agg_bwd", "3b",
                                "coord_agg_bwd[train_ligand_rows_cross]")):
        r = res[name]
        print(f"  {name}: blocks " + ", ".join(
            f"{b['ms']:.4f} ms ({b['pairs']} pairs)" for b in r["blocks"])
            + f"; whole graph {r['whole_ms']:.4f} ms here, {variant_ms[label]:.4f} ms "
            f"in phase {phase}; each block within its gate of its plain version, "
            f"the blocks' sum of the whole-graph launch")
    return res


def _grad_gate(what, names, got, want) -> float:
    """Each gradient within PAR_GRAD_RTOL of its largest entry; returns the
    worst error as a share of that entry."""
    worst = 0.0
    for n, g, w in zip(names, got, want):
        scale, err = float(w.abs().max()), float((g - w).abs().max())
        _check(err <= PAR_GRAD_RTOL * scale + 1e-7,
               f"{what} d{n}: error {err:.3e} against scale {scale:.3e}")
        worst = max(worst, err / (scale + 1e-30))
    return worst


def _parallel_model(job, dev):
    """The flagship conditional module with the job's weights (r05c) on
    ``dev``."""
    import torch
    from diffsbdd_tpu_torch.config import load_config
    from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_npz
    from diffsbdd_tpu_torch.train.module import build_module_from_config
    module = build_module_from_config(load_config(overrides=job["config"]),
                                      job["histogram"])
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            state_dict_from_npz(job["weights"]).items()}, strict=True)
    return module.to(dev)


def _parallel_checks(torch, job, dev, group):
    """(i) the flagship dynamics forward and its parameter gradients, (iii)
    the main path's chain at T = 500, (ii) one train step with injected
    noise; with ``group`` each split over its ranks (the edge axis for (i),
    the batch for (ii) and (iii)), without it on one process.  Returns the
    results, each check's wall on the card and its kernel launches."""
    from diffsbdd_tpu_torch.ops import egnn_cuda as ec
    from diffsbdd_tpu_torch.parallel import mesh
    from diffsbdd_tpu_torch.parallel.edge_shard import edge_sharded_dynamics
    from diffsbdd_tpu_torch.parallel.sample_shard import sample_given_pocket_sharded
    from diffsbdd_tpu_torch.train import loop
    module = _parallel_model(job, dev)
    walls, launches = {}, {}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(name, fn):
        ec.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        walls[name] = time.perf_counter() - t0
        launches[name] = dict(ec.launch_counts)
        return result

    dyn = module.ddpm.dynamics
    inputs = [torch.as_tensor(a, device=dev) for a in job["dynamics_inputs"]]
    params = list(dyn.parameters())

    def dynamics():
        fn = dyn if group is None else edge_sharded_dynamics(dyn, group)
        eps = fn(*inputs)
        grads = torch.autograd.grad(sum((e ** 2).sum() for e in eps), params,
                                    allow_unused=True)
        return [e.detach() for e in eps], [torch.zeros_like(p) if gr is None else gr
                                           for p, gr in zip(params, grads)]

    eps, grads = timed("edge_dynamics", dynamics)

    pocket = {k: torch.as_tensor(v, device=dev) for k, v in job["pocket"].items()}
    lig_mask = torch.as_tensor(job["lig_mask"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(job["seed"])
    kw = dict(timesteps=job["T"], shared_pocket=True)
    ddpm = module.ddpm.eval()
    if group is None:
        samples = timed("sampling", lambda: ddpm.sample_given_pocket(
            gen, pocket, lig_mask, **kw))
    else:
        samples = timed("sampling", lambda: sample_given_pocket_sharded(
            ddpm, group, gen, pocket, lig_mask, **kw))

    # the step last: it moves the weights
    rank, n = mesh.group_rank_size(group)
    t_int, noise = job["noise"]
    rows = slice(rank * len(t_int) // n, (rank + 1) * len(t_int) // n)
    module.ddpm.sample_timesteps = lambda g, n_, lowest: torch.as_tensor(
        t_int[rows], device=dev)
    module.ddpm.sample_gaussian = lambda g, shape, mask: torch.as_tensor(
        noise[rows], device=dev) * mask[..., None]
    state = loop.create_train_state(module.train(), lr=1e-3)
    seen, optimizer_step = [], state.optimizer.step
    state.optimizer.step = lambda grads: (seen.append([gr.clone() for gr in grads]),
                                          optimizer_step(grads))
    step = loop.make_train_step(state, clip_grad=True, group=group)
    local = mesh.shard_batch(job["batch"], group)
    info = timed("train_step", lambda: step(
        None, loop.batch_to_device(local["ligand"], dev),
        loop.batch_to_device(local["pocket"], dev)))
    host = lambda ts: [t.cpu() for t in ts]  # noqa: E731
    out = {"dynamics": (host(eps), host(grads)), "sampling": host(samples),
           "train_step": ({k: float(v) for k, v in info.items()}, host(seen[0]))}
    return out, walls, launches


def _parallel_rank(rank, workdir, device_type):
    """One of phase 18b's two ranks: gloo over CUDA tensors, both ranks on
    the one card (NCCL refuses two ranks on one card)."""
    import torch
    import torch.distributed as dist
    from diffsbdd_tpu_torch.parallel import mesh
    from diffsbdd_tpu_torch.utils.device import resolve_device
    workdir = Path(workdir)
    mesh.init_distributed(device=device_type, init_method=f"file://{workdir}/rendezvous",
                          rank=rank, world_size=2, backend="gloo")
    try:
        dev = resolve_device(f"cuda:{torch.cuda.current_device()}"
                             if device_type == "cuda" else "cpu")
        job = torch.load(workdir / "job.pt", weights_only=False)
        torch.save(_parallel_checks(torch, job, dev, dist.group.WORLD),
                   workdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def parallel_phase(torch, ec, dev, flagship, work, pdb, ref_lig):
    """Phase 18b: two gloo ranks sharing the card (spawned; the kernels are
    built) against one process on the card: (i) the edge-sharded flagship
    dynamics, forward and parameter gradients; (ii) one data-parallel train
    step at global batch 16 (8 a rank) with injected noise; (iii) the
    batch-sharded main path, 2 x 8 molecules at T = 500, global noise
    contract; each rank's kernel launches against each check's."""
    import torch.multiprocessing as mp
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset, PaddedLoader

    T = flagship["diffusion_params"]["diffusion_steps"]
    par = work / "parallel"
    # a training batch of the r05c model's atom types (phase 8's model has
    # crossdock's 10, the r05c weights crossdock_full's 11)
    write_synthetic_dataset(par / "data", 16, 1, seed=PAR_SEED, n_types=11)
    hist = np.load(par / "data" / "size_distribution.npy")
    job = dict(config=flagship, histogram=hist, T=T, seed=PAR_SEED,
               weights=str(R05C_NPZ))
    module = _parallel_model(job, dev)
    residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pdb), ref_lig)
    pocket = {k: v.cpu().numpy() for k, v in module.prepare_pocket(residues, repeats=16).items()}
    rng = np.random.default_rng(PAR_SEED)
    atom_nf = module.ddpm.atom_nf
    # (i): 8 ligands of 24 atoms around the pocket's centre at t = 0.5
    centre = (pocket["x"][0] * pocket["mask"][0, :, None]).sum(0) / pocket["mask"][0].sum()
    xh_lig = np.concatenate([centre + rng.standard_normal((8, 24, 3)) * 1.5,
                             np.eye(atom_nf)[rng.integers(0, atom_nf, (8, 24))]], -1)
    xh_pkt = np.concatenate([pocket["x"][:8], pocket["one_hot"][:8]], -1)
    job["dynamics_inputs"] = [np.ascontiguousarray(a, np.float32) for a in (
        xh_lig, xh_pkt, np.full((8, 1), 0.5), np.ones((8, 24)), pocket["mask"][:8])]
    # (iii): the main path's batch
    job["pocket"], job["lig_mask"] = pocket, np.ones((16, 24), np.float32)
    # (ii): a batch of 16 complexes and its timesteps and noise
    batch = next(iter(PaddedLoader(LigandPocketDataset(par / "data" / "train.npz"),
                                   16, shuffle=False)))
    nl = batch["ligand"]["x"].shape[1]
    job["batch"] = batch
    job["noise"] = (rng.integers(0, T + 1, (16, 1)).astype(np.float32),
                    rng.standard_normal((16, nl, 3 + atom_nf)).astype(np.float32))
    dyn_names = [n for n, _ in module.ddpm.dynamics.named_parameters()]
    names = [n for n, _ in module.named_parameters()]
    del module
    torch.save(job, par / "job.pt")

    t0 = time.perf_counter()
    mp.spawn(_parallel_rank, args=(str(par), dev.type), nprocs=2, join=True)
    spawn_wall = time.perf_counter() - t0
    ranks = [torch.load(par / f"rank{r}.pt", weights_only=False) for r in range(2)]
    ref, ref_walls, ref_launches = _parallel_checks(torch, job, dev, None)

    n_layers = flagship["egnn_params"]["n_layers"]
    step_launches = {k: 0 if k == "block_fused" else n_layers for k in ec.KERNELS}
    expected = {"edge_dynamics": step_launches, "train_step": step_launches,
                "sampling": {"gcl_agg": 8 * T + 6, "coord_agg": 6 * T + 6,
                             "gcl_agg_bwd": 0, "coord_agg_bwd": 0, "block_fused": 0}}
    _check(ref_launches == expected, f"one process: launches {ref_launches}, "
                                     f"expected {expected}")
    report = {"spawn_wall_s": spawn_wall, "one_process_walls_s": ref_walls,
              "ranks": []}
    for r, (got, walls, launches) in enumerate(ranks):
        print(f"  rank {r} launches {launches}")
        _check(launches == expected, f"rank {r}: launches {launches}, expected {expected}")
        # (i)
        worst_v = max(float((g - w).abs().max())
                      for g, w in zip(got["dynamics"][0], ref["dynamics"][0]))
        for g, w in zip(got["dynamics"][0], ref["dynamics"][0]):
            _check(torch.allclose(g, w, **PAR_VALUE_TOL), f"rank {r}: edge-sharded eps")
        worst_g = _grad_gate(f"rank {r}: edge-sharded", dyn_names, got["dynamics"][1],
                             ref["dynamics"][1])
        # (iii)
        lig = torch.as_tensor(job["lig_mask"]) > 0
        dx = float((got["sampling"][0][..., :3] - ref["sampling"][0][..., :3])[lig].abs().max())
        flips = int((got["sampling"][0][..., 3:].argmax(-1)
                     != ref["sampling"][0][..., 3:].argmax(-1))[lig].sum())
        _check(dx <= 1e-3 and flips == 0,
               f"rank {r}: sharded chain {dx:.3e} A, {flips} flips from the unsharded")
        # (ii)
        info, grads = got["train_step"]
        want_info, want_grads = ref["train_step"]
        _check(info.keys() == want_info.keys(), f"rank {r}: train step info keys")
        for k, v in want_info.items():
            _check(abs(info[k] - v) <= PAR_INFO_TOL["atol"] + PAR_INFO_TOL["rtol"] * abs(v),
                   f"rank {r}: train step {k} {info[k]} against {v}")
        worst_s = _grad_gate(f"rank {r}: train step", names, grads, want_grads)
        print(f"  rank {r}: (i) eps max_abs_err {worst_v:.3e} (atol 1e-4 + rtol 1e-4), "
              f"worst gradient {worst_g:.2e} of its largest entry (limit "
              f"{PAR_GRAD_RTOL:.0e}); (ii) loss {info['loss']:.6f} against "
              f"{want_info['loss']:.6f}, grad_norm {info['grad_norm']:.4f} against "
              f"{want_info['grad_norm']:.4f}, worst gradient {worst_s:.2e} of its "
              f"largest entry (limit {PAR_GRAD_RTOL:.0e}); (iii) "
              f"{int(lig.sum())} ligand atoms, max coordinate deviation {dx:.3e} A, "
              f"{flips} flips (limit 1e-3 A, 0)")
        report["ranks"].append(dict(walls_s=walls, launches=launches, eps_err=worst_v,
                                    grad_err=worst_g, step_rel_err=worst_s,
                                    chain_dx=dx, flips=flips))
    print("  walls, s: " + "; ".join(
        f"{k} two ranks sharing the card {ranks[0][1][k]:.2f}, {ranks[1][1][k]:.2f}, "
        f"one process {ref_walls[k]:.2f}" for k in ref_walls)
        + f"; the spawn {spawn_wall:.1f} (process start, imports, the checks)")
    return report


def nccl_phase(torch, flagship, work, training):
    """Phase 18c: cli.train for one epoch under a torchrun environment of one
    rank (NCCL at world size 1) with num_workers 2: the rank-0 checkpoint,
    the prefetch thread."""
    import socket
    cfg = flagship_train_config(flagship, training["datadir"], work / "nccl_runs",
                                run_name="chip_smoke_nccl")
    cfg["num_workers"] = 2
    cfg_path = work / "train_config_nccl.json"
    cfg_path.write_text(json.dumps(cfg))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "diffsbdd_tpu_torch.cli.train",
                          "--config", str(cfg_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    print("\n".join("  | " + ln for ln in run.stdout.strip().splitlines()[-4:]))
    _check(run.returncode == 0, f"cli.train under torchrun's environment failed:\n"
                                f"{run.stderr[-3000:]}")
    _check("rank 0 of 1 in the data group (nccl)" in run.stdout,
           "cli.train did not join an NCCL group")
    _check("prefetching 2 training batches ahead" in run.stdout,
           "cli.train did not prefetch")
    ckpt = work / "nccl_runs" / "chip_smoke_nccl" / "checkpoints"
    for name in ("last.pt", "last.train.pt", "best.pt"):
        _check((ckpt / name).exists(), f"no {name} from the NCCL run")
    print(f"  cli.train, 1 epoch of {N_TRAIN // 16} steps, NCCL at world size 1, "
          f"prefetch depth 2: wall {wall:.2f} s (a process of its own)")
    return dict(wall_s=wall)


def quality_readout(dev, ckpt, sdf):
    """analyze_samples on the molecules of ``sdf`` rebuilt under EDM and
    covalent bond perception."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.chem.molecule import build_molecule
    from diffsbdd_tpu_torch.chem.sdfio import read_sdf
    module, _ = load_model(ckpt, device=dev)
    enc = module.lig_type_encoder
    mols = read_sdf(sdf)
    types = [_type_indices(enc, m.symbols) for m in mols]
    out = {}
    for perception in ("edm", "covalent"):
        built = [build_molecule(m.coords, t, module.dataset_info, perception=perception)
                 for m, t in zip(mols, types)]
        out[perception] = module.analyze_samples(built, np.concatenate(types), [])
    print("  " + json.dumps({"quality": out, "molecules": len(mols)}))
    return out


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


# ---------------------------------------------------------------------------
# phase 19: hidden width 128, the dense variants, profiling, synthetic corpus
# ---------------------------------------------------------------------------

# the config defaults' model (load_config(): hidden 128, joint_nf 32, 5
# layers, attention, tanh, no cutoffs, no cross branch) on full-atom pockets
DEFAULT_WIDTH = 128
DEFAULT_OVERRIDES = {"dataset": "crossdock_full", "pocket_representation": "full-atom",
                     "mode": "pocket_conditioning"}
DEFAULT_T = 100
DENSE_T = 50
DENSE_TRAIN_BATCH = 4


def ptxas_usage(logs, width):
    """Registers, spills and static shared memory of every entry function
    instantiated at ``width``, from nvcc's ``-Xptxas -v`` output: {kernel:
    [{function, registers, spill_stores, spill_loads, static_smem}]}."""
    usage = {}
    for name, log in logs.items():
        funcs = re.split(r"Compiling entry function '", log)[1:]
        for body in funcs:
            fn = body.split("'", 1)[0]
            if f"ILi{width}E" not in fn:
                continue
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
            smem = re.search(r"(\d+) bytes smem", body)
            short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "", fn)
            usage.setdefault(name, []).append(dict(
                function=short, registers=int(regs.group(1)),
                spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)),
                static_smem=int(smem.group(1)) if smem else 0))
    return usage


def block_entry(block_res):
    """The kernels line's entry of the whole-block kernel: the joint path's
    shapes and batch on the clean complex, the collapsed one's beside it."""
    clean, dense = block_res["joint_main_path"], block_res["joint_main_path_dense"]
    return {**clean, "max_abs_err": max(clean["max_abs_err"], dense["max_abs_err"]),
            "batch": JOINT_SAMPLES, "dense_ms": dense["ms"],
            "dense_plain_ms": dense["plain_ms"], "dense_bound_ms": dense["bound_ms"],
            "dense_bound_tc_ms": dense["bound_tc_ms"],
            "dense_split_pair_ms": dense["split_pair_ms"]}


def width_kernel_phase(ec, torch, dev, flagship, logs, width=DEFAULT_WIDTH):
    """Phase 19a: the five kernels at hidden width ``width``, each against
    its plain version at phases 3, 3b and 3c's shapes (every variant, two
    launches bit for bit, CUDA-event times, the f32 and 3xTF32 bounds), and
    the instantiations' registers and spills."""
    cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))
    kres, variant_ms = kernel_phase(ec, torch, dev, cfg)
    bres, bwd_ms = bwd_kernel_phase(ec, torch, dev, cfg)
    block_res, block_ms = block_kernel_phase(ec, torch, dev, cfg, JOINT_SAMPLES)
    kres.update(bres)
    kres["block_fused"] = block_entry(block_res)
    variant_ms.update(bwd_ms)
    variant_ms.update(block_ms)
    usage = ptxas_usage(logs, width)
    for name in ec.KERNELS:
        _check(name in usage, f"{name} has no instantiation at F = {width}")
        for u in usage[name]:
            print(f"  {name} F={width} {u['function'][:60]}: {u['registers']} registers, "
                  f"spill stores {u['spill_stores']} B, loads {u['spill_loads']} B")
        kres[name]["ptxas"] = usage[name]
    return kres, {f"F{width}:{k}": v for k, v in variant_ms.items()}, block_res


def _timed_generate(torch, ec, args, sampler_cls):
    """cli.generate_ligands with ``args``: (CLI wall s, sampling s, launches),
    the sampler's time on the host clock between two device syncs."""
    from diffsbdd_tpu_torch.cli import generate_ligands as gen_cli
    timing = {}
    sample = sampler_cls.sample_given_pocket

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = sample(self, *a, **k)
        torch.cuda.synchronize()
        timing["sample_s"] = time.perf_counter() - t
        return result

    sampler_cls.sample_given_pocket = timed
    ec.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        gen_cli.main([str(a) for a in args])
    finally:
        sampler_cls.sample_given_pocket = sample
    return time.perf_counter() - t0, timing["sample_s"], dict(ec.launch_counts)


def _random_checkpoint(torch, overrides, histogram, path, seed=0):
    """A port checkpoint of the model ``overrides`` configure, its weights
    drawn from ``seed``."""
    from diffsbdd_tpu_torch.checkpoint import save_model
    from diffsbdd_tpu_torch.config import load_config
    from diffsbdd_tpu_torch.train.module import build_module_from_config
    cfg = load_config(overrides=overrides)
    torch.manual_seed(seed)
    module = build_module_from_config(cfg, histogram)
    save_model(path, module, cfg, name="best")
    return path, cfg


def card_vs_cpu_chain(torch, dev, ckpt, work, T, B=2, NL=8):
    """One conditional chain of ``ckpt`` on the card (kernels) and on the
    CPU (plain versions) from the same injected noise, on a 60-atom pocket:
    (max coordinate deviation A, atom-type flips)."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    pdb = work / "small19.pdb"
    ref_lig = write_pocket_pdb(pdb, n_atoms=60, seed=1)
    residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pdb), ref_lig)
    out, nf = [], None
    for d in (dev, torch.device("cpu")):
        module, _ = load_model(ckpt, device=d)
        nf = module.atom_nf
        rng = np.random.default_rng(0)
        queue = [rng.standard_normal((B, NL, 3 + nf)).astype(np.float32)
                 for _ in range(T + 2)]
        module.ddpm.sample_gaussian = lambda g, shape, mask, q=queue: \
            torch.as_tensor(q.pop(0), device=mask.device) * mask[..., None]
        pocket = module.prepare_pocket(residues, repeats=B)
        lig_mask = torch.ones(B, NL, device=d)
        lig_mask[1, 6:] = 0.0
        with torch.no_grad():
            xh, _ = module.ddpm.sample_given_pocket(None, pocket, lig_mask, timesteps=T,
                                                    shared_pocket=True)
        _check(not queue, "noise left over")
        out.append(xh.cpu().numpy())
    a, b = out
    _check(np.isfinite(a).all(), "non-finite samples on the card")
    return float(np.abs(a[..., :3] - b[..., :3]).max()), \
        int((a[..., 3:].argmax(-1) != b[..., 3:].argmax(-1)).sum())


def default_width_phase(torch, ec, dev, work, pdb, ref_lig, card):
    """Phase 19b: the config defaults' model (hidden 128, 5 layers) from
    seeded random weights: cli.generate_ligands (16 x 24 atoms, T = 100)
    with the launches a 5-layer chain makes; cli.train for one short epoch
    (the backward kernels at F = 128); the trained checkpoint sampled with
    block fusing on (the whole-block kernel at F = 128); the card against the
    CPU on a small input with injected noise."""
    from diffsbdd_tpu_torch.cli import train as train_cli
    from diffsbdd_tpu_torch.config import load_config
    from diffsbdd_tpu_torch.diffusion.ddpm import ConditionalDDPM
    cfg0 = load_config(overrides=DEFAULT_OVERRIDES)
    p = cfg0.egnn_params
    print(f"  config defaults: hidden {p.hidden_nf}, joint_nf {p.joint_nf}, {p.n_layers} "
          f"layers, attention {p.attention}, tanh {p.tanh}, cutoffs "
          f"{p.edge_cutoff_ligand}/{p.edge_cutoff_pocket}/{p.edge_cutoff_interaction}, "
          f"reflection_equivariant {p.reflection_equivariant}")
    _check(p.hidden_nf == DEFAULT_WIDTH and p.joint_nf == 32 and p.n_layers == 5,
           "the config defaults moved")
    L, T, n = p.n_layers, DEFAULT_T, 16
    data = work / "data19"
    n_pocket = sum(ln.startswith("ATOM") for ln in Path(pdb).read_text().splitlines())
    write_synthetic_dataset(data, 32, 16, seed=19, pocket_sizes=(250, 280, n_pocket, 320),
                            n_types=11)  # crossdock_full's 11 atom types
    histogram = np.load(data / "size_distribution.npy")
    ckpt, _ = _random_checkpoint(torch, DEFAULT_OVERRIDES, histogram, work / "default19")
    res = {"card": card}

    sdf = work / "default19.sdf"
    wall, sample_s, launches = _timed_generate(
        torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile", sdf,
                    "--n_samples", n, "--num_nodes_lig", 24, "--all_frags",
                    "--timesteps", T], ConditionalDDPM)
    want = chain_launches(ec, L, T)
    print(f"  sampling: launches {launches}, expected {want}")
    _check(launches == want, "the default-width chain's launches differ")
    mols = _sdf_molecules(sdf)
    _check(0 < len(mols) <= n and all(np.isfinite(c).all() for _, c in mols),
           "default-width molecules")
    res["sampling"] = dict(launches=launches, wall_s=wall, sample_s=sample_s,
                           ms_per_pass=1e3 * sample_s / (T + 1), molecules=len(mols),
                           molecules_per_s=n / wall)
    print(f"  {card}: {n} x 24 atoms, T={T}: {res['sampling']['ms_per_pass']:.2f} ms per "
          f"pass, sampling {sample_s:.2f} s, CLI wall {wall:.2f} s, {len(mols)} molecules")

    # one short epoch: 32 complexes in batches of 16, then validation
    cfg = dict(DEFAULT_OVERRIDES, **{k: v for k, v in TRAIN_FIELDS.items() if k != "dataset"},
               run_name="chip_smoke_default19", datadir=str(data), logdir=str(work / "runs19"),
               tpu={"kernel_block_fuse": True})
    cfg_path = work / "default19.json"
    cfg_path.write_text(json.dumps(cfg))
    ec.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_cli.main(["--config", str(cfg_path)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    tl = dict(ec.launch_counts)
    steps = 32 // 16
    print(f"  cli.train ({steps} steps + validation): launches {tl}, {train_s:.2f} s")
    _check(tl["gcl_agg_bwd"] == tl["coord_agg_bwd"] == L * steps,
           "the default-width train steps' backward launches")
    _check(tl["gcl_agg"] > 0 and tl["block_fused"] == 0, "the default-width training launches")
    res["training"] = dict(launches=tl, wall_s=train_s, steps=steps)

    trained = work / "runs19" / "chip_smoke_default19" / "checkpoints"
    wall, sample_s, launches = _timed_generate(
        torch, ec, [trained, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile",
                    work / "default19_fused.sdf", "--n_samples", n, "--num_nodes_lig", 24,
                    "--all_frags", "--timesteps", T], ConditionalDDPM)
    want = {**dict.fromkeys(ec.KERNELS, 0), "gcl_agg": 3 * T, "coord_agg": T,
            "block_fused": (L - 1) * T + L}
    print(f"  sampling with block fusing: launches {launches}, expected {want}")
    _check(launches == want, "the fused default-width chain's launches differ")
    res["sampling_fused"] = dict(launches=launches, wall_s=wall, sample_s=sample_s,
                                 ms_per_pass=1e3 * sample_s / (T + 1))
    print(f"  {card}: fused {res['sampling_fused']['ms_per_pass']:.2f} ms per pass")

    dx, flips = card_vs_cpu_chain(torch, dev, ckpt, work, T=10)
    print(f"  card vs CPU, T=10: max coordinate deviation {dx:.3e} A, {flips} flips "
          f"(limit 1e-3 A, 0 flips)")
    _check(dx <= 1e-3 and flips == 0, "default-width card and CPU chains disagree")
    res["card_vs_cpu"] = dict(max_dx=dx, flips=flips)
    res["launches"] = {k: max(res[p]["launches"][k] for p in
                              ("sampling", "training", "sampling_fused")) for k in ec.KERNELS}
    return res


DENSE_VARIANT = {"sin_embedding": True, "aggregation_method": "mean"}


def dense_inputs(torch, module, B, NL, NP, seed, dev):
    """A conditional batch for ``module``'s dynamics: a synthetic pocket of
    ``NP`` atoms and ligands of ``NL`` atoms within a few A of its centre."""
    residues, _ = pocket_atoms(NP, seed=seed)
    pk = np.array([xyz for _, atoms in residues for _, _, xyz in atoms], np.float32)[:NP]
    rng = np.random.default_rng(seed)
    xh_l = np.concatenate([rng.standard_normal((B, NL, 3)) * 1.5,
                           np.eye(module.atom_nf)[rng.integers(0, module.atom_nf, (B, NL))]], -1)
    xh_p = np.concatenate([np.broadcast_to(pk, (B, NP, 3)),
                           np.eye(module.residue_nf)[rng.integers(0, 4, (B, NP))]], -1)
    t = np.full((B, 1), 0.5)
    return [torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
            for a in (xh_l, xh_p, t, np.ones((B, NL)), np.ones((B, NP)))]


def dense_phase(torch, ec, dev, flagship, work, pdb, ref_lig, card):
    """Phase 19c: the flagship config with sinusoidal distance features and
    mean aggregation (the dense path, no kernel) from seeded random weights:
    cli.generate_ligands (16 x 24 atoms, T = 50) with zero launches, ms per
    pass and peak memory; one dynamics forward on the card against the CPU
    for it and for gnn_dynamics at the same widths; cli.train for a few steps
    at a batch that fits; one chain with tpu.nan_check on."""
    import copy
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    from diffsbdd_tpu_torch.cli import train as train_cli
    from diffsbdd_tpu_torch.diffusion.ddpm import ConditionalDDPM
    from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
    from diffsbdd_tpu_torch.train import loop
    over = dict(flagship, egnn_params=dict(flagship["egnn_params"], **DENSE_VARIANT))
    data = work / "data19c"
    n_pocket = sum(ln.startswith("ATOM") for ln in Path(pdb).read_text().splitlines())
    write_synthetic_dataset(data, 8, 4, seed=20, pocket_sizes=(280, n_pocket, 320))
    histogram = np.load(data / "size_distribution.npy")
    ckpt, cfg = _random_checkpoint(torch, over, histogram, work / "dense19")
    res = {"card": card}
    n, T = 16, DENSE_T

    torch.cuda.reset_peak_memory_stats()
    sdf = work / "dense19.sdf"
    wall, sample_s, launches = _timed_generate(
        torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile", sdf,
                    "--n_samples", n, "--num_nodes_lig", 24, "--all_frags",
                    "--timesteps", T], ConditionalDDPM)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  sampling: launches {launches} (expected none)")
    _check(not any(launches.values()), "the dense variant launched a kernel")
    mols = _sdf_molecules(sdf)
    _check(len(mols) <= n and all(np.isfinite(c).all() for _, c in mols), "dense molecules")
    res["sampling"] = dict(launches=launches, wall_s=wall, sample_s=sample_s,
                           ms_per_pass=1e3 * sample_s / (T + 1), peak_gib=peak,
                           molecules=len(mols))
    print(f"  {card}: sin/mean {n} x 24 atoms, T={T}: {res['sampling']['ms_per_pass']:.2f} "
          f"ms per pass, sampling {sample_s:.2f} s, CLI wall {wall:.2f} s, peak "
          f"{peak:.2f} GiB, {len(mols)} molecules")

    # one forward at B = 2 on the card and on the CPU: this model and
    # gnn_dynamics at the same widths
    module, _ = load_model(ckpt, device=dev)
    cpu_module, _ = load_model(ckpt, device="cpu")
    e = cfg.egnn_params
    torch.manual_seed(1)
    gnn = EGNNDynamics(
        atom_nf=module.atom_nf, residue_nf=module.residue_nf, joint_nf=e.joint_nf,
        hidden_nf=e.hidden_nf, n_layers=e.n_layers, attention=e.attention,
        normalization_factor=e.normalization_factor,
        edge_cutoff_ligand=e.edge_cutoff_ligand, edge_cutoff_pocket=e.edge_cutoff_pocket,
        edge_cutoff_interaction=e.edge_cutoff_interaction,
        edge_embedding_dim=e.get("edge_embedding_dim"), mode="gnn_dynamics",
        update_pocket_coords=False, kernel_block_fuse=False).eval()
    res["forward"] = {}
    for name, card_dyn, cpu_dyn in (
            ("sin_mean", module.ddpm.dynamics, cpu_module.ddpm.dynamics),
            ("gnn_dynamics", copy.deepcopy(gnn).to(dev), gnn)):
        ec.reset_launch_counts()
        with torch.no_grad():
            got = card_dyn(*dense_inputs(torch, module, 2, 24, 120, 3, dev))
            want = cpu_dyn(*dense_inputs(torch, module, 2, 24, 120, 3, torch.device("cpu")))
        torch.cuda.synchronize()
        errs = []
        for g, w in zip(got, want):
            g = g.cpu()
            errs.append(float((g - w).abs().max()))
            bad = float(((g - w).abs() - (1e-4 + 1e-4 * w.abs())).max())
            _check(bad <= 0, f"dense {name} forward: card and CPU disagree")
        _check(not any(ec.launch_counts.values()), f"dense {name} forward launched a kernel")
        print(f"  {name} forward B=2, 24 + 120 atoms: card vs CPU max abs err "
              f"{max(errs):.3e} (atol 1e-4 + rtol 1e-4)")
        res["forward"][name] = max(errs)
    del module, cpu_module, gnn

    # training at a batch that fits: every block's (B, N, N, F) activations
    # are kept for the backward pass
    train_cfg = dict(flagship_train_config(flagship, data, work / "runs19c",
                                           run_name="chip_smoke_dense19"),
                     batch_size=DENSE_TRAIN_BATCH)
    train_cfg["egnn_params"] = dict(train_cfg["egnn_params"], **DENSE_VARIANT)
    cfg_path = work / "dense19_train.json"
    cfg_path.write_text(json.dumps(train_cfg))
    losses = []
    trainer_log = loop.Trainer.log

    def log(self, metrics, split, step):
        losses.append((split, float(metrics["loss"])))
        return trainer_log(self, metrics, split, step)

    loop.Trainer.log = log
    ec.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        train_cli.main(["--config", str(cfg_path)])
    finally:
        loop.Trainer.log = trainer_log
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 8 // DENSE_TRAIN_BATCH
    _check(sum(s == "train" for s, _ in losses) >= steps and
           all(np.isfinite(v) for _, v in losses), f"dense training losses {losses}")
    _check(not any(ec.launch_counts.values()), "dense training launched a kernel")
    res["training"] = dict(losses=losses, wall_s=train_s, peak_gib=peak,
                           batch_size=DENSE_TRAIN_BATCH, steps=steps)
    print(f"  {card}: cli.train {steps} steps of batch {DENSE_TRAIN_BATCH} + validation: "
          f"{train_s:.2f} s, losses {[round(v, 4) for _, v in losses]}, peak {peak:.2f} GiB")

    # a chain with tpu.nan_check on: finite, and a poisoned input raises
    checked, _ = _random_checkpoint(torch, dict(over, tpu={"nan_check": True}), histogram,
                                    work / "dense19_nan")
    module, _ = load_model(checked, device=dev)
    _check(module.ddpm.dynamics.nan_check, "tpu.nan_check did not reach the network")
    residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pdb), ref_lig)
    pocket = module.prepare_pocket(residues, repeats=4)
    t0 = time.perf_counter()
    with torch.no_grad():
        xh, _ = module.ddpm.sample_given_pocket(
            torch.Generator(device=dev).manual_seed(0), pocket,
            torch.ones(4, 24, device=dev), timesteps=10, shared_pocket=True)
    torch.cuda.synchronize()
    nan_s = time.perf_counter() - t0
    _check(bool(torch.isfinite(xh).all()), "nan_check chain")
    poisoned = dense_inputs(torch, module, 1, 8, 40, 4, dev)
    poisoned[0][0, 0, 0] = float("nan")
    try:
        with torch.no_grad():
            module.ddpm.dynamics(*poisoned)
        raised = ""
    except ValueError as err:
        raised = str(err)
    _check(raised == "NaN detected in EGNN output", "nan_check did not raise on NaN")
    print(f"  nan_check on: a T=10 chain of 4 finite in {nan_s:.2f} s; a NaN input raises "
          f"'{raised}'")
    res["nan_check"] = dict(chain_s=nan_s, raised=raised)
    return res


def profiling_phase(torch, ec, dev, ckpt, pdb, ref_lig, out, card, passes=3):
    """Phase 19d: utils.profiling on the card: device_trace around 3 passes
    of phase 6's main path (the flagship checkpoint, 16 x 24 atoms), the
    trace file and the top 5 device operations; a StepTimer over the same
    passes one by one."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.chem import pdb as pdbmod
    from diffsbdd_tpu_torch.utils.profiling import StepTimer, device_trace
    module, _ = load_model(ckpt, device=dev)
    residues = pdbmod.get_pocket_from_ligand(pdbmod.parse_pdb(pdb), ref_lig)
    pocket = module.prepare_pocket(residues, repeats=16)
    lig_mask = torch.ones(16, 24, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    # passes - 1 denoise steps and the decode pass
    chain = lambda: module.ddpm.sample_given_pocket(  # noqa: E731
        gen, pocket, lig_mask, timesteps=passes - 1, shared_pocket=True)
    with torch.no_grad():
        chain()  # warm-up
        with device_trace(out / "trace19") as prof:
            chain()
        trace = out / "trace19" / "trace.json"
        _check(trace.exists() and trace.stat().st_size > 0, "no trace written")
        events = sorted((e for e in prof.key_averages()
                         if str(e.device_type).endswith("CUDA")
                         and e.self_device_time_total > 0),
                        key=lambda e: -e.self_device_time_total)
        _check(len(events) > 0, "the trace holds no device time")
        top = [dict(name=e.key, ms=e.self_device_time_total / 1e3, count=e.count)
               for e in events[:5]]
        print(f"  {card}: trace {trace.name} {trace.stat().st_size / 1e6:.1f} MB; top 5 "
              "device operations:")
        for t in top:
            print(f"    {t['ms']:9.3f} ms x{t['count']:<4d} {t['name'][:70]}")
        timer = StepTimer()
        for _ in range(5):
            timer.start()
            timer.stop(chain())
        summary = timer.summary()
    print(f"  StepTimer over 5 chains of {passes} passes: {summary}")
    return dict(trace_bytes=trace.stat().st_size, top=top, step_timer=summary,
                card=card)


def corpus_phase(work):
    """Phase 19e (host only): synth_corpus.build_corpus on two seeded
    synthetic proteins, 32 + 8 + 8 complexes, loaded through
    LigandPocketDataset and PaddedLoader."""
    from diffsbdd_tpu_torch.data import synth_corpus
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset, PaddedLoader
    prot = [work / "protA19.pdb", work / "protB19.pdb"]
    for seed, path in enumerate(prot):
        write_protein_pdb(path, seed=seed)
    t0 = time.perf_counter()
    meta = synth_corpus.build_corpus(work / "corpus19", *prot, n_train=32, n_val=8,
                                     n_test=8, seed=0)
    build_s = time.perf_counter() - t0
    sizes = {}
    for split in ("train", "val", "test"):
        ds = LigandPocketDataset(work / "corpus19" / f"{split}.npz")
        batches = list(PaddedLoader(ds, 8, shuffle=False))
        sizes[split] = len(ds)
        _check(sum(b["ligand"]["x"].shape[0] for b in batches) == len(ds),
               f"corpus {split} batches")
    _check(sizes == {"train": 32, "val": 8, "test": 8}, f"corpus sizes {sizes}")
    _check(80 <= meta["pocket_sizes"]["min"] and meta["pocket_sizes"]["max"] <= 310,
           "corpus pocket sizes")
    print(f"  corpus of {sizes} in {build_s:.2f} s (host); ligands {meta['lig_sizes']}, "
          f"pockets {meta['pocket_sizes']}, {meta['unique_train_graphs']} unique graphs")
    return dict(meta=meta, build_s=build_s, sizes=sizes)


def phase19(torch, ec, dev, flagship, logs, work, out, pdb, ref_lig, ckpt, card):
    """Phase 19 in order; returns its results."""
    t19 = time.perf_counter()
    print(f"[19a] the five kernels at hidden width {DEFAULT_WIDTH} ({card})")
    kres, variant_ms, block_res = width_kernel_phase(ec, torch, dev, flagship, logs)
    print(f"[19b] the config defaults' model (hidden {DEFAULT_WIDTH}, 5 layers)")
    default = default_width_phase(torch, ec, dev, work, pdb, ref_lig, card)
    print("[19c] the dense variants at the flagship widths (sin features, mean "
          "aggregation; gnn_dynamics)")
    dense = dense_phase(torch, ec, dev, flagship, work, pdb, ref_lig, card)
    print("[19d] utils.profiling on the main path")
    prof = profiling_phase(torch, ec, dev, ckpt, pdb, ref_lig, out, card)
    print("[19e] synth_corpus.build_corpus (host)")
    corpus = corpus_phase(work)
    res = dict(kernels=kres, block_fused=block_res, variant_ms=variant_ms,
               default=default, dense=dense, profiling=prof, corpus=corpus,
               phase_s=time.perf_counter() - t19)
    print(f"  phase 19 took {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 20: the precision policies (matmul_precision, kernel_bwd_precision,
# compute_dtype)
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12
# each tier's products: (passes, the tensor cores' rate for them)
TIER_RATE = {"tf32x3": (3, PEAK_TF32_FLOPS), "tf32x2": (2, PEAK_TF32_FLOPS),
             "bf16": (1, PEAK_BF16_FLOPS)}
# the JAX names whose main paths phase 20 drives, by the tier they run
TIER_NAME = {"tf32x2": "float32_x2", "bf16": "bfloat16"}
TIER_WIDTHS = (256, DEFAULT_WIDTH)
DENSE_BF16_BATCHES = (16, 8, 4)  # tried in order; the first that trains is kept


def tier_bound(flops, bytes_, tier):
    """(bound ms, "operations" or "bytes") of work at ``tier``: its passes of
    ``flops`` at the tensor cores' rate, or the bytes at HBM's."""
    passes, peak = TIER_RATE[tier]
    t_ops, t_bytes = passes * flops / peak, bytes_ / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tier_kernel_phase(ec, torch, dev, flagship, width, names=None):
    """Phase 20a: the four split kernels at every tier (3xTF32 beside the two
    reduced ones, in the same run) at phases 3 and 3b's main shapes and width
    ``width``: each against its plain version at that tier within
    ``ec.TIER_GATES``, only that tier's library launched, two launches bit for
    bit, CUDA-event times of kernel and plain version, the tier's bound, and
    how far the tier moves the output from the 3xTF32 kernel's.  ``names``:
    only these kernels (all four when None).  Above F = 1024 (the backward
    kernels at 2048, 20k) the backward plain versions run in batch slices of
    2 and 1 graphs, the plain time is that of the reference run itself (a
    second run would take seconds a tier), the kernels are timed over 2
    launches, and the reduced tiers are checked on the batch's first
    ``REDUCED_CHECK_BATCH`` graphs (kernel, plain version, and the 3xTF32
    kernel their move is measured from), their time taken at the full
    batch; above 2048 (20n) the plain versions in slices of 1, and each
    kernel's time is one launch at the full batch (the 3xTF32 one's the
    second of its two checked launches)."""
    cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))
    fwd = kernel_inputs(torch, dev, cfg, 16, 24)
    sizes = np.random.default_rng(0).integers(24, 33, 16)
    bwd = kernel_inputs(torch, dev, cfg, 16, 32, lig_sizes=sizes, seed=1)
    F, NL, B = fwd["F"], fwd["NL"], 16
    g_gcl, g_coord = bwd["r"](B, bwd["N"], F), bwd["r"](B, bwd["N"], 3)
    cross_b = {k: v for k, v in bwd["cross"].items() if k != "type_bias"}
    cross_b["delta"] = bwd["cross_delta"]
    node = ("a_row", "a_col", "x", "x0", "mask", "is_lig")

    def gcl_fwd(fn, tier, sl=slice(None)):
        return fn(*(fwd[k][sl] for k in node), *fwd["gcl_w"].values(), cutoffs=fwd["cut"],
                  attention=True, normalization_factor=100.0, precision=tier)

    def coord_fwd(fn, tier, sl=slice(None)):
        c = {k: (v[sl] if k in ("a_row", "a_col") else v) for k, v in fwd["cross"].items()}
        return fn(*(fwd[k][sl] for k in node), *fwd["coord_w"], cutoffs=fwd["cut"], tanh=True,
                  coords_range=15.0, norm_constant=1.0, normalization_factor=100.0,
                  update_rows=NL, cross=c, graph_mean=fwd["graph_mean"][sl],
                  precision=tier)

    # the forward plain versions above F = 512 in batch slices of 4 graphs:
    # at F = 1024 one (16, 344, 344, F) float32 tensor takes 7.8 GB; there
    # the kernels (up to ~140 ms a launch) are timed over 5 launches, not 20
    fwd_step = 4 if width > WIDE else None
    reps = 2 if width > WIDEST else 5 if width > WIDE else 20
    # the GCL's, the coordinate's: at F = 4096 a (1, 352, 352, F) float32 tensor is 2 GB
    bwd_steps = (1, 1) if width > CLUSTER_WIDTH else (2, 1) if width > WIDEST else (4, 2)

    def fwd_plain(call, plain, tier):
        if fwd_step is None:
            return call(plain, tier)
        return torch.cat([call(plain, tier, slice(b, b + fwd_step))
                          for b in range(0, B, fwd_step)], 0)

    def gcl_bwd(fn, tier, sl=slice(None)):
        w = bwd["gcl_w"]
        return _name_cotangents(fn(
            g_gcl[sl], *(bwd[k][sl] for k in node), w["w_d2"], w["w_d20"], bwd["gcl_delta"],
            w["w2"], w["b2"], w["w_att"], w["b_att"], cutoffs=bwd["cut"], attention=True,
            normalization_factor=100.0, precision=tier), GCL_COT)

    def coord_bwd(fn, tier, sl=slice(None)):
        w_d2, w_d20, _, w2, b2, w3 = bwd["coord_w"]
        c = {k: (v[sl] if k in ("a_row", "a_col") else v) for k, v in cross_b.items()}
        return _name_cotangents(fn(
            g_coord[sl], *(bwd[k][sl] for k in node), w_d2, w_d20, bwd["coord_delta"], w2,
            b2, w3, cutoffs=bwd["cut"], tanh=True, coords_range=15.0, norm_constant=1.0,
            normalization_factor=100.0, cross=c, graph_mean=bwd["graph_mean"][sl],
            update_rows=32, precision=tier), COORD_COT)

    cases = {  # kernel: (call, kernel wrapper, plain version, plain batch slice, work)
        "gcl_agg": (gcl_fwd, ec.gcl_message_agg, ec.gcl_message_agg_plain, None,
                    work_bounds(active_pairs(ec, fwd), B, fwd["N"], F, 1, fwd["N"], F)),
        "coord_agg": (coord_fwd, ec.coord_update_agg, ec.coord_update_agg_plain, None,
                      work_bounds(active_pairs(ec, fwd, rows=NL), B, fwd["N"], F, 2, NL, 3)),
        "gcl_agg_bwd": (gcl_bwd, ec.gcl_agg_bwd, ec.gcl_agg_bwd_plain, bwd_steps[0],
                        bwd_work(active_pairs(ec, bwd), B, bwd["N"], F, 1, F)),
        "coord_agg_bwd": (coord_bwd, ec.coord_agg_bwd, ec.coord_agg_bwd_plain, bwd_steps[1],
                          bwd_work(active_pairs(ec, bwd, rows=32), B, bwd["N"], F, 2, 3))}
    if names is not None:
        cases = {k: v for k, v in cases.items() if k in names}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    results = {}
    for name, (call, kern, plain, step, work) in cases.items():
        base = None
        for tier in ec.TIERS:
            gate = ec.TIER_GATES[tier]
            # above F = 1024 the reduced tiers' checks on the first graphs
            sub = slice(0, REDUCED_CHECK_BATCH) if (
                step is not None and width > WIDEST and tier != ec.DEFAULT_TIER) else slice(None)
            ec.reset_launch_counts()
            got = call(kern, tier, sub)
            start.record()
            again = call(kern, tier, sub)
            end.record()
            torch.cuda.synchronize()
            again_ms = start.elapsed_time(end)
            launched = {k: v for k, v in ec.tier_launch_counts.items() if v}
            _check(launched == {f"{name}[{tier}]": 2},
                   f"{name}[{tier}]: launched {launched}, not its tier's library")
            if sub.stop is not None and base is not None and sub_base is None:
                sub_base = call(kern, ec.DEFAULT_TIER, sub)  # the 3xTF32 kernel's, on the slice
            # the reduced tiers' norm gate reads the tier's move from the
            # 3xTF32 kernel's output (base: the first tier's, itself held to
            # float32's plain version)
            if step is None:
                ref = fwd_plain(call, plain, tier)
                limit = 1e-5 + 1e-4 * ref.abs() + gate["share"] * float(ref.abs().max())
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                share = err / float(ref.abs().max())
                _check(bool(torch.isfinite(got).all()) and bool(((got - ref).abs() <= limit).all()),
                       f"{name}[{tier}] F={width}: error {err:.3e} over its gate")
                _check(torch.equal(got, again), f"{name}[{tier}]: two launches differ")
                moved, moved_share = (0.0, 0.0) if base is None else (
                    float((got - base).abs().max() / base.abs().max()),
                    ec.tier_moved_share(got, ref, base))
                base = got if base is None else base
            else:
                rows = B if sub.stop is None else sub.stop
                start.record()
                ref = _plain_in_slices(torch, lambda sl: call(plain, tier, sl), rows, step)
                end.record()
                torch.cuda.synchronize()
                ref_ms = start.elapsed_time(end)
                err, share, moved, moved_share = 0.0, 0.0, 0.0, 0.0
                for cname, r in ref.items():
                    if r is None:
                        continue
                    e = float((got[cname] - r).abs().max())
                    scale = float(r.abs().max())
                    _check(bool(torch.isfinite(got[cname]).all()) and
                           e <= gate["bwd"] * scale + 1e-7,
                           f"{name}[{tier}] F={width} {cname}: error {e:.3e}, scale {scale:.3e}")
                    _check(torch.equal(got[cname], again[cname]),
                           f"{name}[{tier}] {cname}: two launches differ")
                    err, share = max(err, e), max(share, e / (scale + 1e-30))
                    ref_base = base if sub.stop is None else sub_base
                    if ref_base is not None:
                        moved = max(moved, float((got[cname] - ref_base[cname]).abs().max()) /
                                    float(ref_base[cname].abs().max() + 1e-30))
                        moved_share = max(moved_share, ec.tier_moved_share(
                            got[cname], r, ref_base[cname]))
                if base is None:
                    base, sub_base = got, None
            if gate["moved"] is not None:
                _check(moved_share <= gate["moved"],
                       f"{name}[{tier}] F={width}: error norm {moved_share:.3f} of the "
                       f"tier's move, gate {gate['moved']}")
            if sub.stop is None and width > CLUSTER_WIDTH:
                ms = again_ms
            elif width > CLUSTER_WIDTH:  # one launch at the full batch
                start.record()
                call(kern, tier)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
            else:
                ms = _cuda_ms(lambda: call(kern, tier), reps)
            if step is None:
                plain_ms = _cuda_ms(lambda: fwd_plain(call, plain, tier), 2 if reps > 5 else 1)
            elif width > WIDEST:
                plain_ms = ref_ms
            else:
                plain_ms = _cuda_ms(lambda: _plain_in_slices(
                    torch, lambda sl: call(plain, tier, sl), B, step), 1)
            bound_ms, bound_by = tier_bound(work["flops"], work["bytes"], tier)
            results[f"{name}[{tier}]"] = dict(
                tier=tier, width=width, checked_batch=B if sub.stop is None else sub.stop,
                max_abs_err=err, gate_share=share, moved=moved,
                moved_share=moved_share, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                pairs=work["pairs"], flops=work["flops"])
            print(f"  {name}[{tier}] F={width}: {ms:.4f} ms (plain {plain_ms:.3f} ms), "
                  f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%); "
                  f"error {share:.2e} of the largest entry (gate "
                  + (f"1e-5 + 1e-4 |ref| + {gate['share']:g} of it" if step is None
                     else f"{gate['bwd']:g} of it") + f"), moved {moved:.2e} from 3xTF32"
                  + ("" if gate["moved"] is None else
                     f"; error norm {moved_share:.4f} of the move (gate {gate['moved']:g})")
                  + ("" if sub.stop is None else f"; checked on the first {sub.stop} graphs"))
    return results


def _captured_generate(torch, ec, args, joint=False):
    """cli.generate_ligands with ``args``: (CLI wall s, sampling s, launches,
    launches by tier, the sampled ligands (x and h) on the host).  ``joint``:
    the checkpoint is a joint model, which inpaints with the pocket fixed."""
    from diffsbdd_tpu_torch.cli import generate_ligands as gen_cli
    from diffsbdd_tpu_torch.diffusion.ddpm import ConditionalDDPM, JointDDPM
    out = {}
    cls, method = (JointDDPM, "inpaint") if joint else (ConditionalDDPM,
                                                         "sample_given_pocket")
    sample = getattr(cls, method)

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = sample(self, *a, **k)
        torch.cuda.synchronize()
        out["sample_s"] = time.perf_counter() - t
        out["xh"] = result[0].cpu()
        return result

    setattr(cls, method, timed)
    ec.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        gen_cli.main([str(a) for a in args])
    finally:
        setattr(cls, method, sample)
    return (time.perf_counter() - t0, out["sample_s"], dict(ec.launch_counts),
            {k: v for k, v in ec.tier_launch_counts.items() if v}, out["xh"])


def _configured_checkpoints(torch, ckpt, work, configs):
    """The weights of checkpoint ``ckpt`` under each entry of ``configs``
    (label: its ``tpu`` fields), one checkpoint each."""
    from diffsbdd_tpu_torch.checkpoint import load_model, save_model
    module, cfg = load_model(ckpt, device="cpu")
    out = {}
    for label, tpu in configs.items():
        for key, value in tpu.items():
            setattr(cfg.tpu, key, value)
        out[label] = work / f"{Path(ckpt).name}_{label}"
        save_model(out[label], module, cfg, name="best")
    return out


def _jittered_checkpoints(torch, work, configs, node_histogram=None, seed=0):
    """The flagship (r05c) weights, each times 1 + u 2^-11 with u uniform in
    [-1, 1) from ``seed``, as one checkpoint for each entry of ``configs``
    (label: its ``tpu`` fields over float32's).  The r05c weights are
    float16 values, which TF32 holds exactly, so 2xTF32 drops no low part of
    them; the jitter gives each weight a low part as a float32-trained weight
    has, and moves the model by less than a bf16 rounding."""
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model, save_model
    module, cfg = load_model(import_jax_npz(R05C_NPZ, work / "r05c_import",
                                            node_histogram=node_histogram), device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.mul_(1 + (2 * torch.rand(p.shape, generator=g) - 1) * 2 ** -11)
    save_model(work / "r05c_jitter", module, cfg, name="best")
    return _configured_checkpoints(torch, work / "r05c_jitter", work, {
        label: {"matmul_precision": "float32", "kernel_bwd_precision": None, **tpu}
        for label, tpu in configs.items()})


def tier_sampling_phase(torch, ec, dev, work, pdb, ref_lig, base, card):
    """Phase 20b: phase 6's main path (cli.generate_ligands, 16 x 24 atoms,
    T = 500, seed 0: the same injected noise) at ``bfloat16`` from the
    flagship checkpoint, against phase 6's float32 run (``base``), and at
    ``float32_x2`` from the flagship weights jittered below TF32's resolution
    (``_jittered_checkpoints``), against a float32 run of those: every launch
    at the tier, the counts of phase 6; ms a pass, molecules/s, the
    coordinates' largest deviation (A) and the atom types that flip against
    float32, and the quality readout of both."""
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz
    n, T = 16, 500
    expected = {"gcl_agg": 8 * T + 6, "coord_agg": 6 * T + 6, "gcl_agg_bwd": 0,
                "coord_agg_bwd": 0, "block_fused": 0}

    def run(ckpt, label):
        sdf = work / f"samples_{label}.sdf"
        wall, sample_s, launches, by_tier, xh = _captured_generate(
            torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile", sdf,
                        "--n_samples", n, "--num_nodes_lig", 24, "--all_frags",
                        "--timesteps", T])
        _check(launches == expected, f"{label}: launches {launches}, expected {expected}")
        _check_molecules(sdf, n, 24)
        _check(bool(torch.isfinite(xh).all()), f"{label}: non-finite samples")
        return dict(launches=launches, launches_by_tier=by_tier, wall_s=wall,
                    sample_s=sample_s, ms_per_pass=1e3 * sample_s / (T + 1),
                    molecules_per_s=n / wall, xh=xh,
                    quality=quality_readout(dev, ckpt, sdf))

    jittered = _jittered_checkpoints(torch, work, {
        name: {"matmul_precision": name} for name in ("float32", "float32_x2")})
    jit_base = run(jittered["float32"], "jittered_float32")
    _check(jit_base["launches_by_tier"] == {"gcl_agg[tf32x3]": 8 * T + 6,
                                            "coord_agg[tf32x3]": 6 * T + 6},
           f"jittered float32: launches by tier {jit_base['launches_by_tier']}")
    res = {"float32_jittered": {k: v for k, v in jit_base.items() if k != "xh"}}
    for tier, name in TIER_NAME.items():
        if name == "float32_x2":
            ckpt, ref, weights = jittered[name], jit_base, "r05c jittered"
        else:
            ckpt = import_jax_npz(R05C_NPZ, work / f"r05c_{name}",
                                  overrides={"tpu": {"matmul_precision": name}})
            ref, weights = base, "r05c"
        r = run(ckpt, name)
        _check(r["launches_by_tier"] == {f"gcl_agg[{tier}]": 8 * T + 6,
                                         f"coord_agg[{tier}]": 6 * T + 6},
               f"{name}: launches by tier {r['launches_by_tier']}")
        xh, want = r.pop("xh"), ref["xh"]
        r.update(tier=tier, weights=weights,
                 max_dev_A=float((xh[..., :3] - want[..., :3]).abs().max()),
                 type_flips=int((xh[..., 3:].argmax(-1) != want[..., 3:].argmax(-1)).sum()),
                 atoms=int(want.shape[0] * want.shape[1]))
        res[name] = r
        print(f"  {card}: {name} ({tier}, {weights} weights): {r['ms_per_pass']:.2f} ms a "
              f"pass, {r['molecules_per_s']:.3f} molecules/s (float32: "
              f"{ref['ms_per_pass']:.2f} ms, {ref['molecules_per_s']:.3f}); against float32 "
              f"with the same noise: {r['max_dev_A']:.3e} A at most, {r['type_flips']} of "
              f"{r['atoms']} atom types flipped")
    return res


def tier_training_phase(torch, ec, dev, work, card):
    """Phase 20c: the conditional train step of the flagship weights,
    jittered below TF32's resolution (``_jittered_checkpoints``), on one batch
    of 16 synthetic complexes (phase 8's sizes, the checkpoint's 11 atom
    types; injected timesteps and noise) at float32, with
    kernel_bwd_precision bfloat16, and at float32_x2: each
    tier's launches, every parameter gradient's deviation from float32's (its
    largest error over its largest entry) and the gradients' cosine, and ms a
    train step (median of 5, after 2)."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset, PaddedLoader
    from diffsbdd_tpu_torch.train import loop
    data = work / "data20c"
    write_synthetic_dataset(data, 16, 1, seed=22, pocket_sizes=(250, 280, 310, 320),
                            n_types=11)
    batch = next(iter(PaddedLoader(LigandPocketDataset(data / "train.npz"), 16,
                                   shuffle=False)))
    lig = loop.batch_to_device(batch["ligand"], dev)
    pkt = loop.batch_to_device(batch["pocket"], dev)
    rng = np.random.default_rng(20)
    t_int = torch.as_tensor(rng.integers(0, 501, (16, 1)).astype(np.float32), device=dev)
    eps = torch.as_tensor(rng.standard_normal(
        (16, lig["x"].shape[1], 3 + 11)).astype(np.float32), device=dev)
    configs = {"float32": {}, "bwd_bfloat16": {"kernel_bwd_precision": "bfloat16"},
               "float32_x2": {"matmul_precision": "float32_x2"}}
    ckpts = _jittered_checkpoints(torch, work / "train20c", configs,
                                  node_histogram=np.load(data / "size_distribution.npy"))
    res, base = {}, None
    for label in configs:
        module, _ = load_model(ckpts[label], device=dev)
        module.train()
        module.ddpm.sample_timesteps = lambda g, B, lo: t_int
        module.ddpm.sample_gaussian = lambda g, shape, mask: eps * mask[..., None]
        ec.reset_launch_counts()
        loss, _ = module.loss_fn(None, lig, pkt, training=True)
        names, params = zip(*module.named_parameters())
        grads = {n: g for n, g in zip(names, torch.autograd.grad(loss, params, allow_unused=True))
                 if g is not None}
        torch.cuda.synchronize()
        by_tier = {k: v for k, v in ec.tier_launch_counts.items() if v}
        fwd_tier = module.ddpm.dynamics.precision
        bwd_tier = module.ddpm.dynamics.bwd_precision or fwd_tier
        _check(by_tier == {f"gcl_agg[{fwd_tier}]": 6, f"coord_agg[{fwd_tier}]": 6,
                           f"gcl_agg_bwd[{bwd_tier}]": 6, f"coord_agg_bwd[{bwd_tier}]": 6},
               f"{label}: launches by tier {by_tier}")
        _check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
               f"{label}: non-finite gradients")
        if base is None:
            base, dev_share, cosine = grads, 0.0, 1.0
        else:
            dev_share = max(float((grads[k] - base[k]).abs().max() / (base[k].abs().max() + 1e-30))
                            for k in base)
            a = torch.cat([grads[k].flatten() for k in base])
            b = torch.cat([base[k].flatten() for k in base])
            cosine = float((a * b).sum() / (a.norm() * b.norm()))
        state = loop.create_train_state(module, lr=1e-4)
        step = loop.make_train_step(state)
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(None, lig, pkt)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms = float(np.median(times[2:]))
        loss = float(loss.detach())
        if label == "bwd_bfloat16":  # the forward kept 3xTF32: the same loss
            _check(loss == res["float32"]["loss"], f"{label}: the forward's loss moved")
        # JAX's gate on its bf16 backward's gradients (tests/test_pallas_bwd.py)
        _check(cosine > 0.999, f"{label}: gradients' cosine {cosine} against float32")
        res[label] = dict(loss=loss, launches_by_tier=by_tier, ms_per_step=ms,
                          grad_dev_share=dev_share, grad_cosine=cosine)
        print(f"  {card}: {label}: train step {ms:.2f} ms (median of 5), loss {loss:.6f}; "
              f"gradients against float32: worst {dev_share:.3e} of a parameter's largest "
              f"entry, cosine {cosine:.8f}; launches {by_tier}")
        del module, state, grads
    return res


def dense_bf16_phase(torch, ec, dev, flagship, work, pdb, ref_lig, card):
    """Phase 20d: phase 19c's dense model (sinusoidal features, mean
    aggregation, seeded random weights) at compute_dtype bfloat16: sampling
    (16 x 24, T = 50) ms a pass and peak memory, no launch; one forward
    against float32's on the card and against the CPU's bfloat16; the largest
    of DENSE_BF16_BATCHES that cli.train runs for an epoch, and its peak."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.cli import train as train_cli
    from diffsbdd_tpu_torch.diffusion.ddpm import ConditionalDDPM
    from diffsbdd_tpu_torch.models import egnn as egnn_mod
    over = dict(flagship, egnn_params=dict(flagship["egnn_params"], **DENSE_VARIANT),
                tpu={"compute_dtype": "bfloat16"})
    data = work / "data20d"
    n_pocket = sum(ln.startswith("ATOM") for ln in Path(pdb).read_text().splitlines())
    write_synthetic_dataset(data, max(DENSE_BF16_BATCHES), 4, seed=21,
                            pocket_sizes=(280, n_pocket, 320))
    histogram = np.load(data / "size_distribution.npy")
    ckpt, cfg = _random_checkpoint(torch, over, histogram, work / "dense20")
    f32_ckpt, _ = _random_checkpoint(torch, dict(over, tpu={}), histogram, work / "dense20_f32")
    res = {"card": card}
    n, T = 16, DENSE_T
    torch.cuda.reset_peak_memory_stats()
    wall, sample_s, launches = _timed_generate(
        torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile",
                    work / "dense20.sdf", "--n_samples", n, "--num_nodes_lig", 24,
                    "--all_frags", "--timesteps", T], ConditionalDDPM)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check(not any(launches.values()), "the dense bf16 model launched a kernel")
    res["sampling"] = dict(ms_per_pass=1e3 * sample_s / (T + 1), sample_s=sample_s,
                           wall_s=wall, peak_gib=peak)
    print(f"  {card}: bf16 sin/mean {n} x 24, T={T}: "
          f"{res['sampling']['ms_per_pass']:.2f} ms a pass, peak {peak:.2f} GiB")
    module, _ = load_model(ckpt, device=dev)
    _check(module.ddpm.dynamics.compute_dtype == torch.bfloat16,
           "compute_dtype did not reach the network")
    f32, _ = load_model(f32_ckpt, device=dev)
    cpu, _ = load_model(ckpt, device="cpu")

    def forward(model, d):
        """The network's outputs, and the first GCL's message sums (where
        compute_dtype acts: bf16 messages summed in float32)."""
        sums, real = [], egnn_mod.pair_sum

        def captured(m, adj):
            sums.append(real(m, adj))
            return sums[-1]

        egnn_mod.pair_sum = captured
        try:
            with torch.no_grad():
                out = model.ddpm.dynamics(*dense_inputs(torch, module, 2, 24, 120, 3, d))
        finally:
            egnn_mod.pair_sum = real
        return [o.cpu() for o in out], sums[0].cpu()

    (got, got_m), (exact, exact_m), (host, host_m) = (
        forward(module, dev), forward(f32, dev), forward(cpu, torch.device("cpu")))
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    vs_f32 = max(rel(g, e) for g, e in zip(got, exact))
    vs_cpu = max(rel(g, h) for g, h in zip(got, host))
    msg_f32, msg_cpu = rel(got_m, exact_m), rel(got_m, host_m)
    # the card's bf16 messages are the CPU's (the same roundings; sums in
    # another order, a rare rounding to the other neighbour), and not
    # float32's: the card and the CPU within 1e-3 of the largest sum
    # (measured 2.8e-4) and within a quarter of bf16's distance from float32
    # (2.8e-3); the outputs within 1e-4 of the CPU's (3.7e-6)
    _check(all(bool(torch.isfinite(g).all()) for g in got) and msg_cpu <= 1e-3
           and msg_cpu <= 0.25 * msg_f32 and vs_cpu <= 1e-4,
           f"dense bf16: messages card vs CPU {msg_cpu:.3e}, vs float32 {msg_f32:.3e}; "
           f"outputs card vs CPU {vs_cpu:.3e}")
    res["forward"] = dict(vs_float32=vs_f32, vs_cpu=vs_cpu, messages_vs_float32=msg_f32,
                          messages_vs_cpu=msg_cpu)
    print(f"  forward B=2: outputs {vs_f32:.3e} of the largest entry from float32's, "
          f"{vs_cpu:.3e} from the CPU's bf16; the first GCL's message sums {msg_f32:.3e} "
          f"from float32's, {msg_cpu:.3e} from the CPU's (limits: outputs 1e-4; messages "
          f"1e-3 and a quarter of float32's)")
    del module, f32, cpu
    for bs in DENSE_BF16_BATCHES:
        train_cfg = dict(flagship_train_config(flagship, data, work / f"runs20d_{bs}",
                                               run_name=f"chip_smoke_dense20_{bs}"),
                         batch_size=bs)
        train_cfg["egnn_params"] = dict(train_cfg["egnn_params"], **DENSE_VARIANT)
        train_cfg["tpu"] = dict(train_cfg.get("tpu", {}), compute_dtype="bfloat16")
        cfg_path = work / f"dense20_train_{bs}.json"
        cfg_path.write_text(json.dumps(train_cfg))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            train_cli.main(["--config", str(cfg_path)])
        except torch.cuda.OutOfMemoryError:
            print(f"  batch {bs}: out of memory")
            continue
        torch.cuda.synchronize()
        res["training"] = dict(batch_size=bs, wall_s=time.perf_counter() - t0,
                               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"  {card}: cli.train bf16 at batch {bs}: {res['training']['wall_s']:.2f} s, "
              f"peak {res['training']['peak_gib']:.2f} GiB")
        break
    _check("training" in res, f"no batch of {DENSE_BF16_BATCHES} trained")
    return res


# the whole-block kernel's shapes in phase 20a (phase 3c's): label -> (batch,
# seed, spread, update_rows); the first is the joint main path's launch
TIER_BLOCK_SHAPES = {"joint_main_path": (JOINT_SAMPLES, 7, None, None),
                     "joint_main_path_dense": (JOINT_SAMPLES, 8, 1.0, None),
                     "conditional_ligand_rows": (16, 4, None, 24)}


def block_bf16_check(ec, what, got, ref, sums, f32):
    """``ec.block_bf16_gate`` on both outputs of a bf16 whole-block launch
    ``got`` (h_new, dx): ``ref`` the bf16 plain version's, ``sums``
    ``ec.block_fused_bf16_exact``'s, ``f32`` the float32 plain version's.
    Fails the phase if either output is over the gate; returns the worst
    figures over the two (``norm``, ``plain_norm``, ``max``, ``ratio``)."""
    worst = dict(norm=0.0, plain_norm=0.0, max=0.0, ratio=0.0)
    for name, g, r, s, e in zip(("h_new", "dx"), got, ref, sums, f32):
        res = ec.block_bf16_gate(g, r, s, e)
        _check(res["ok"], f"{what} {name}: over the bf16 gate: error norm {res['norm']:.4f} "
                          f"of the tier's move against the float64 sums (limit "
                          f"{res['norm_limit']:.4f}; the plain version {res['plain_norm']:.4f}), "
                          f"largest error {res['max']:.3e} (the plain version "
                          f"{res['plain_max']:.3e})")
        for k in worst:
            worst[k] = max(worst[k], res[k])
    return worst


def tier_block_phase(ec, torch, dev, flagship, width, shapes):
    """Phase 20a, the whole-block kernel: its library at every tier on
    phase 3c's ``shapes`` (``TIER_BLOCK_SHAPES``) at width ``width``, against
    its plain version at that tier (each output within 1e-5 + (1e-4 + the
    tier's share) of its largest entry, and its error norm within
    ``BLOCK_TIER_GATES``' share of the tier's move from the 3xTF32 kernel's;
    at bf16 ``block_bf16_check``: against the bf16 sums in float64, within
    twice the plain version's own distance), only that tier's library
    launched, two launches bit for bit, dx rows at
    and above ``update_rows`` exact zeros; CUDA-event times of kernel and
    plain version, and the tier's bound.  At the reduced tiers also the
    yardstick of the bf16 gate: how far the plain version moves, by norm as
    a share of the tier's move, when its inputs h, a_row, a_col move by 1e-6
    relative.  Returns {shape: {tier: entry}}."""
    cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))
    reps = 5 if width > WIDE else 20  # launches timed (~40 ms each at F = 1024)
    results = {}
    for label in shapes:
        B, seed, spread, rows = TIER_BLOCK_SHAPES[label]
        inp = kernel_inputs(torch, dev, cfg, B, 24, seed=seed, spread=spread)
        ops = block_operands(inp)
        kw = dict(cutoffs=inp["cut"], attention=True, tanh=True, coords_range=15.0,
                  norm_constant=1.0, normalization_factor=100.0, update_rows=rows)
        N, F = inp["N"], inp["F"]
        flops, bytes_ = block_work(B, N, F, active_pairs(ec, inp),
                                   active_pairs(ec, inp, rows=rows), 2)
        g = torch.Generator(device=dev).manual_seed(seed)
        noisy_ops = [o * (1 + (torch.rand(o.shape, generator=g, device=dev) - 0.5) * 2e-6)
                     for o in ops[:3]] + ops[3:]
        base = None
        for tier in ec.TIERS:
            gate = ec.BLOCK_TIER_GATES[tier]
            what = f"block_fused[{tier}] {label} F={width}"
            ec.reset_launch_counts()
            got = ec.block_fused(*ops, **kw, precision=tier)
            again = ec.block_fused(*ops, **kw, precision=tier)
            launched = {k: v for k, v in ec.tier_launch_counts.items() if v}
            _check(launched == {f"block_fused[{tier}]": 2},
                   f"{what}: launched {launched}, not its tier's library")
            ref = ec.block_fused_plain(*ops, **kw, precision=tier)
            f32 = ref if base is None else f32
            torch.cuda.synchronize()
            noisy = None if base is None else ec.block_fused_plain(*noisy_ops, **kw,
                                                                   precision=tier)
            err = share = moved = moved_share = noise_share = 0.0
            bf16 = None
            if tier == "bf16":
                bf16 = block_bf16_check(ec, what, got, ref,
                                        ec.block_fused_bf16_exact(*ops, **kw), f32)
            for i, (name, g, a, r) in enumerate(zip(("h_new", "dx"), got, again, ref)):
                scale = float(r.abs().max())
                e = float((g - r).abs().max())
                _check(bool(torch.isfinite(g).all()) and
                       (bf16 is not None or e <= 1e-5 + (1e-4 + gate["share"]) * scale),
                       f"{what} {name}: error {e:.3e}, largest entry {scale:.3e}")
                _check(torch.equal(g, a), f"{what} {name}: two launches differ")
                err, share = max(err, e), max(share, e / scale)
                if base is not None:
                    b = base[i]
                    moved = max(moved, float((g - b).abs().max() / b.abs().max()))
                    moved_share = max(moved_share, ec.tier_moved_share(g, r, b))
                    noise_share = max(noise_share, ec.tier_moved_share(noisy[i], r, b))
            _check(not bool(got[1][:, N if rows is None else rows:].any()),
                   f"{what}: dx rows past update_rows are not zero")
            if gate.get("moved") is not None:
                _check(moved_share <= gate["moved"],
                       f"{what}: error norm {moved_share:.3f} of the tier's move, "
                       f"gate {gate['moved']}")
            base = got if base is None else base
            ms = _cuda_ms(lambda: ec.block_fused(*ops, **kw, precision=tier), reps)
            plain_ms = _cuda_ms(lambda: ec.block_fused_plain(*ops, **kw, precision=tier),
                                2 if reps > 5 else 1)
            bound_ms, bound_by = tier_bound(flops, bytes_, tier)
            results.setdefault(label, {})[tier] = dict(
                tier=tier, width=width, batch=B, max_abs_err=err, gate_share=share,
                moved=moved, moved_share=moved_share, noise_share=noise_share, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                bf16_gate=bf16)
            print(f"  {what}: {ms:.4f} ms (plain {plain_ms:.3f} ms), bound {bound_ms:.4f} "
                  f"ms ({bound_by}, {100 * bound_ms / ms:.1f}%); error {share:.2e} of the "
                  f"largest entry, moved {moved:.2e} from 3xTF32"
                  + ("" if base is got else
                     f"; error norm {moved_share:.4f} of the move (the plain version under "
                     f"1e-6 input noise {noise_share:.4f})")
                  + ("" if bf16 is None else
                     f"; bf16 gate: against the float64 sums {bf16['norm']:.4f} of the move "
                     f"(the plain version {bf16['plain_norm']:.4f}), ratio {bf16['ratio']:.3f}"
                     f" (gate {ec.BLOCK_TIER_GATES['bf16']['k']:g})"))
        del inp, ops, noisy_ops
    return results


def tier_joint_phase(torch, ec, dev, work, pdb, ref_lig, card, joint_ckpt,
                     n=JOINT_SAMPLES, T=500):
    """Phase 20f: the joint chain of flagship-joint-b8 (cli.generate_ligands
    on phase 10's joint checkpoint, ``joint_ckpt``: inpainting with the
    pocket fixed, ``n`` x 24 atoms, T = 500, one seed: the same noise in
    every run; its weights are float32 values, from which 2xTF32 drops a low
    part) with tpu.kernel_block_fuse on at float32, bfloat16 and float32_x2,
    and off at the two reduced tiers: every block of every pass the
    whole-block kernel's library at the tier (6 (T + 1) launches) or the
    split pair at the tier; ms a pass of each; the coordinates' largest
    deviation (A) and the atom types that flip against the float32 chain.
    (The r05c weights are a conditional model's: as a joint model, whose
    pocket rows move inside the network, its chains run away, hundreds of A
    apart between tiers.)"""
    from diffsbdd_tpu_torch.diffusion.ddpm import JointDDPM
    configs = {"float32": {"matmul_precision": "float32", "kernel_block_fuse": True}}
    for name in TIER_NAME.values():
        configs[name] = {"matmul_precision": name, "kernel_block_fuse": True}
        configs[f"{name}_split"] = {"matmul_precision": name, "kernel_block_fuse": False}
    ckpts = _configured_checkpoints(torch, joint_ckpt, work, configs)
    passes = len(JointDDPM._repaint_plan(1, 1, T)[0]) + 1
    res, ref = {}, None
    for label, tpu in configs.items():
        tier = ec.DEFAULT_TIER if label == "float32" else \
            {v: k for k, v in TIER_NAME.items()}[tpu["matmul_precision"]]
        sdf = work / f"joint20f_{label}.sdf"
        wall, sample_s, launches, by_tier, xh = _captured_generate(
            torch, ec, [ckpts[label], "--pdbfile", pdb, "--ref_ligand", ref_lig,
                        "--outfile", sdf, "--n_samples", n, "--num_nodes_lig", 24,
                        "--all_frags", "--timesteps", T, "--resamplings", 1,
                        "--jump_length", 1], joint=True)
        want = {f"block_fused[{tier}]": 6 * passes} if tpu["kernel_block_fuse"] else \
            {f"gcl_agg[{tier}]": 6 * passes, f"coord_agg[{tier}]": 6 * passes}
        _check(by_tier == want, f"joint {label}: launches by tier {by_tier}, expected {want}")
        _check_molecules(sdf, n, 24)
        _check(bool(torch.isfinite(xh).all()), f"joint {label}: non-finite samples")
        r = dict(tier=tier, block_fuse=tpu["kernel_block_fuse"], launches=launches,
                 launches_by_tier=by_tier, wall_s=wall, sample_s=sample_s,
                 ms_per_pass=1e3 * sample_s / passes, molecules_per_s=n / wall)
        if ref is None:
            ref = xh
        else:
            r.update(max_dev_A=float((xh[..., :3] - ref[..., :3]).abs().max()),
                     type_flips=int((xh[..., 3:].argmax(-1) != ref[..., 3:].argmax(-1)).sum()),
                     atoms=int(ref.shape[0] * ref.shape[1]))
        res[label] = r
        print(f"  {card}: joint {label} ({tier}, block fusing "
              f"{'on' if r['block_fuse'] else 'off'}): {r['ms_per_pass']:.2f} ms a pass, "
              f"{r['molecules_per_s']:.3f} molecules/s"
              + ("" if "max_dev_A" not in r else
                 f"; against float32 with the same noise {r['max_dev_A']:.3e} A at most, "
                 f"{r['type_flips']} of {r['atoms']} atom types flipped"))
    return res


IMPL_TRAIN_BATCHES = (16, 8, 4)  # tried in order; the first that fits is kept


def impl_phase(torch, ec, dev, flagship, work, pdb, ref_lig, card):
    """Phase 20g: the two implementation choices.  (a) tpu.egnn_impl xla on
    the flagship checkpoint: cli.generate_ligands on phase 5's pocket (16 x
    24, T = DENSE_T) with no kernel launched, ms a pass and peak memory; one
    dynamics forward (B = 16, 24 + 300 atoms) against the kernels' path on
    the same weights and inputs, within 1e-4 of the largest entry (float32
    on both sides: the CPU tests' gate for the dense path against JAX).
    (b) tpu.kernel_bwd xla: one conditional train step of the flagship
    weights at the largest of IMPL_TRAIN_BATCHES that fits (synthetic
    complexes, injected timesteps and noise): 6 + 6 forward launches and no
    backward kernel; every parameter gradient against the backward kernels'
    (phase 9's gate: 1e-3 of its largest entry; cosine > 0.99999); ms a
    train step (median of 3, after 1) and peak memory of both."""
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset, PaddedLoader
    from diffsbdd_tpu_torch.train import loop
    res = {"card": card}
    ckpt = import_jax_npz(R05C_NPZ, work / "r05c_xla", overrides={"tpu": {"egnn_impl": "xla"}})
    kern_ckpt = import_jax_npz(R05C_NPZ, work / "r05c_kernels20g")
    n, T = 16, DENSE_T
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wall, sample_s, launches, _, _ = _captured_generate(
        torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile",
                    work / "xla20g.sdf", "--n_samples", n, "--num_nodes_lig", 24,
                    "--all_frags", "--timesteps", T])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check(not any(launches.values()), f"egnn_impl xla launched {launches}")
    _check_molecules(work / "xla20g.sdf", n, 24)
    dense, _ = load_model(ckpt, device=dev)
    kern, _ = load_model(kern_ckpt, device=dev)
    _check(dense.ddpm.dynamics.dense and not kern.ddpm.dynamics.dense,
           "egnn_impl did not choose the path")
    batch = dense_inputs(torch, dense, n, 24, 300, 3, dev)
    with torch.no_grad():
        ec.reset_launch_counts()
        got = dense.ddpm.dynamics(*batch)
        _check(not any(ec.launch_counts.values()), "the dense forward launched a kernel")
        want = kern.ddpm.dynamics(*batch)
    dev_share = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    _check(dev_share <= 1e-4, f"egnn_impl xla against the kernels: {dev_share:.3e}")
    res["egnn_impl_xla"] = dict(ms_per_pass=1e3 * sample_s / (T + 1), sample_s=sample_s,
                                wall_s=wall, peak_gib=peak, launches=launches,
                                eps_vs_kernels=dev_share)
    print(f"  {card}: egnn_impl xla {n} x 24, T={T}: "
          f"{res['egnn_impl_xla']['ms_per_pass']:.2f} ms a pass, peak {peak:.2f} GiB, no "
          f"launch; eps against the kernels' path {dev_share:.3e} of the largest entry "
          f"(limit 1e-4)")
    del dense, kern, got, want, batch

    data = work / "data20g"
    write_synthetic_dataset(data, max(IMPL_TRAIN_BATCHES), 1, seed=23,
                            pocket_sizes=(250, 280, 310, 320), n_types=11)
    hist = np.load(data / "size_distribution.npy")
    ckpts = {impl: import_jax_npz(R05C_NPZ, work / f"r05c_bwd_{impl}", node_histogram=hist,
                                  overrides={"tpu": {"kernel_bwd": impl}})
             for impl in ("auto", "xla")}
    rng = np.random.default_rng(21)
    for bs in IMPL_TRAIN_BATCHES:
        batch = next(iter(PaddedLoader(LigandPocketDataset(data / "train.npz"), bs,
                                       shuffle=False)))
        lig = loop.batch_to_device(batch["ligand"], dev)
        pkt = loop.batch_to_device(batch["pocket"], dev)
        t_int = torch.as_tensor(rng.integers(0, 501, (bs, 1)).astype(np.float32), device=dev)
        eps = torch.as_tensor(rng.standard_normal(
            (bs, lig["x"].shape[1], 3 + 11)).astype(np.float32), device=dev)
        out = {}
        try:
            for impl, path in ckpts.items():
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                module, _ = load_model(path, device=dev)
                module.train()
                module.ddpm.sample_timesteps = lambda g, B, lo: t_int
                module.ddpm.sample_gaussian = lambda g, shape, mask: eps * mask[..., None]
                ec.reset_launch_counts()
                loss, _ = module.loss_fn(None, lig, pkt, training=True)
                names, params = zip(*module.named_parameters())
                grads = {k: g for k, g in zip(names, torch.autograd.grad(
                    loss, params, allow_unused=True)) if g is not None}
                torch.cuda.synchronize()
                counts = dict(ec.launch_counts)
                step = loop.make_train_step(loop.create_train_state(module, lr=1e-4))
                times = []
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(None, lig, pkt)
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
                out[impl] = dict(loss=float(loss.detach()), grads=grads, launches=counts,
                                 ms_per_step=float(np.median(times[1:])),
                                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
                del module, step, loss
        except torch.cuda.OutOfMemoryError:
            print(f"  kernel_bwd: batch {bs}: out of memory")
            out = None
            torch.cuda.empty_cache()
            continue
        break
    _check(out is not None, f"no batch of {IMPL_TRAIN_BATCHES} trained with kernel_bwd xla")
    mirror, kernel = out["xla"], out["auto"]
    _check(mirror["launches"] == {"gcl_agg": 6, "coord_agg": 6, "gcl_agg_bwd": 0,
                                  "coord_agg_bwd": 0, "block_fused": 0},
           f"kernel_bwd xla: launches {mirror['launches']}")
    _check(kernel["launches"]["gcl_agg_bwd"] == 6, "the kernel backward did not run")
    _check(mirror["grads"].keys() == kernel["grads"].keys(), "different parameters reached")
    worst = 0.0
    for k, w in kernel["grads"].items():
        g = mirror["grads"][k]
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        _check(bool(torch.isfinite(g).all()) and err <= 1e-3 * scale + 1e-7,
               f"kernel_bwd xla: gradient of {k}: error {err:.3e}, scale {scale:.3e}")
        worst = max(worst, err / (scale + 1e-30))
    a = torch.cat([mirror["grads"][k].flatten() for k in kernel["grads"]])
    b = torch.cat([w.flatten() for w in kernel["grads"].values()])
    cosine = float((a * b).sum() / (a.norm() * b.norm()))
    _check(cosine > 0.99999, f"kernel_bwd xla: gradients' cosine {cosine}")
    _check(mirror["loss"] == kernel["loss"], "kernel_bwd xla moved the forward's loss")
    res["kernel_bwd_xla"] = dict(
        batch_size=bs, grad_dev_share=worst, grad_cosine=cosine, loss=mirror["loss"],
        **{f"{k}_{impl}": v[k] for impl, v in (("mirror", mirror), ("kernels", kernel))
           for k in ("ms_per_step", "peak_gib", "launches")})
    print(f"  {card}: kernel_bwd xla at batch {bs}: {mirror['ms_per_step']:.2f} ms a train "
          f"step, peak {mirror['peak_gib']:.2f} GiB (the backward kernels: "
          f"{kernel['ms_per_step']:.2f} ms, {kernel['peak_gib']:.2f} GiB); gradients "
          f"against the backward kernels' worst {worst:.3e} of a parameter's largest "
          f"entry, cosine {cosine:.8f}; launches {mirror['launches']}")
    return res


PADDED_WIDTHS = (96, 192)  # run at 128 and 256 (ec.padded_width)
PADDED_TIERS = ("tf32x3", "bf16")
PADDED_CHAIN = dict(n=16, T=50)  # a hidden-192 chain beside a hidden-256 one


def padded_kernel_phase(ec, torch, dev, flagship, width, names=None):
    """Phase 20e, the kernels at a hidden width they are not built for: the
    five wrappers at ``width`` (zero-padded to ``ec.padded_width(width)``)
    at 3xTF32 and bf16 on a phase-3 complex of B = 2 (24 + 300 atoms, cross
    branch, attention, the edge-type deltas), each against its plain version
    at ``width`` and that tier: the split kernels on ``ec.TIER_GATES``, the
    whole block on ``ec.BLOCK_TIER_GATES`` (as in 20a; at bf16
    ``ec.block_bf16_gate`` against the bf16 sums in float64 at ``width``,
    float32's plain version giving the tier's move); one launch of that tier's
    library each, outputs and cotangents at ``width``.  ``names``: only these
    kernels (all five when None)."""
    cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))
    inp = kernel_inputs(torch, dev, cfg, 2, 24, with_delta=True, seed=5)
    B, N, F, NL = inp["B"], inp["N"], inp["F"], inp["NL"]
    node = ("a_row", "a_col", "x", "x0", "mask", "is_lig")
    g_gcl, g_coord = inp["r"](B, N, F), inp["r"](B, N, 3)
    cross_b = {k: v for k, v in inp["cross"].items() if k != "type_bias"}
    cross_b["delta"] = inp["cross_delta"]
    ops = block_operands(inp, table=True)
    w = inp["gcl_w"]
    block_kw = dict(cutoffs=inp["cut"], attention=True, tanh=True, coords_range=15.0,
                    norm_constant=1.0, normalization_factor=100.0, update_rows=NL)
    calls = {  # kernel: fn(wrapper or plain version, tier) -> {output: tensor}
        "gcl_agg": lambda fn, tier: {"agg": fn(
            *(inp[k] for k in node), *w.values(), cutoffs=inp["cut"], attention=True,
            normalization_factor=100.0, precision=tier)},
        "coord_agg": lambda fn, tier: {"dx": fn(
            *(inp[k] for k in node), *inp["coord_w"], cutoffs=inp["cut"], tanh=True,
            coords_range=15.0, norm_constant=1.0, normalization_factor=100.0,
            update_rows=NL, cross=inp["cross"], graph_mean=inp["graph_mean"],
            precision=tier)},
        "gcl_agg_bwd": lambda fn, tier: _name_cotangents(fn(
            g_gcl, *(inp[k] for k in node), w["w_d2"], w["w_d20"], inp["gcl_delta"],
            w["w2"], w["b2"], w["w_att"], w["b_att"], cutoffs=inp["cut"], attention=True,
            normalization_factor=100.0, precision=tier), GCL_COT),
        "coord_agg_bwd": lambda fn, tier: _name_cotangents(fn(
            g_coord, *(inp[k] for k in node), *inp["coord_w"][:2], inp["coord_delta"],
            *inp["coord_w"][3:], cutoffs=inp["cut"], tanh=True, coords_range=15.0,
            norm_constant=1.0, normalization_factor=100.0, cross=cross_b,
            graph_mean=inp["graph_mean"], update_rows=NL, precision=tier), COORD_COT),
        "block_fused": lambda fn, tier: dict(zip(("h_new", "dx"), fn(
            *ops, **block_kw, precision=tier)))}
    plains = {"gcl_agg": ec.gcl_message_agg_plain, "coord_agg": ec.coord_update_agg_plain,
              "gcl_agg_bwd": ec.gcl_agg_bwd_plain, "coord_agg_bwd": ec.coord_agg_bwd_plain,
              "block_fused": ec.block_fused_plain}
    wrappers = {"gcl_agg": ec.gcl_message_agg, "coord_agg": ec.coord_update_agg,
                "gcl_agg_bwd": ec.gcl_agg_bwd, "coord_agg_bwd": ec.coord_agg_bwd,
                "block_fused": ec.block_fused}
    results = {}
    for name, call in calls.items():
        if names is not None and name not in names:
            continue
        exact = call(plains[name], "tf32x3")
        for tier in PADDED_TIERS:
            gate = (ec.BLOCK_TIER_GATES if name == "block_fused" else ec.TIER_GATES)[tier]
            what = f"{name}[{tier}] F={width} (at {ec.padded_width(width)})"
            ec.reset_launch_counts()
            got = call(wrappers[name], tier)
            launched = {k: v for k, v in ec.tier_launch_counts.items() if v}
            _check(launched == {f"{name}[{tier}]": 1},
                   f"{what}: launched {launched}, not one launch of its tier's library")
            ref = exact if tier == "tf32x3" else call(plains[name], tier)
            sums = None
            if name == "block_fused" and tier == "bf16":
                sums = dict(zip(("h_new", "dx"), ec.block_fused_bf16_exact(*ops, **block_kw)))
            torch.cuda.synchronize()
            share = moved_share = 0.0
            for out, r in ref.items():
                if r is None:
                    _check(got[out] is None, f"{what} {out}: a cotangent where none is due")
                    continue
                g = got[out]
                _check(g.shape == r.shape, f"{what} {out}: shape {tuple(g.shape)}, "
                                           f"expected {tuple(r.shape)}")
                scale = float(r.abs().max())
                e = float((g - r).abs().max())
                if name.endswith("_bwd"):
                    ok = e <= gate["bwd"] * scale + 1e-7
                elif sums is not None:
                    res = ec.block_bf16_gate(g, r, sums[out], exact[out])
                    ok, moved_share = res["ok"], max(moved_share, res["norm"])
                elif name == "block_fused":
                    ok = e <= 1e-5 + (1e-4 + gate["share"]) * scale
                else:
                    ok = bool(((g - r).abs() <= 1e-5 + 1e-4 * r.abs()
                               + gate["share"] * scale).all())
                _check(bool(torch.isfinite(g).all()) and ok,
                       f"{what} {out}: error {e:.3e}, largest entry {scale:.3e}")
                share = max(share, e / (scale + 1e-30))
                if gate.get("moved") is not None:
                    moved_share = max(moved_share, ec.tier_moved_share(g, r, exact[out]))
            if gate.get("moved") is not None:
                _check(moved_share <= gate["moved"],
                       f"{what}: error norm {moved_share:.3f} of the tier's move, "
                       f"gate {gate['moved']}")
            results[f"{name}[{tier}]"] = dict(width=width, run_at=ec.padded_width(width),
                                              gate_share=share, moved_share=moved_share)
            if name != "block_fused":
                results[f"{name}[{tier}]"]["cluster_dim"] = ec.last_cluster_dim(name, tier)
            print(f"  {what}: 1 launch of {name}[{tier}]; error {share:.2e} of the largest "
                  f"entry" + ("" if gate.get("moved") is None else
                              f", error norm {moved_share:.4f} of the tier's move "
                              f"(gate {gate['moved']:g})")
                  + ("" if sums is None else f", error norm {moved_share:.4f} of the "
                                             f"tier's move against the float64 sums"))
    del inp, ops
    return results


def padded_width_phase(torch, ec, dev, flagship, work, pdb, ref_lig, card):
    """Phase 20e: hidden widths the kernels are not built for, and what
    still raises.  (a) ``padded_kernel_phase`` at 96 and 192.  (b) the
    padding's cost: ``gcl_agg`` at phase 3's main shapes (B = 16) at width
    192 (run at 256) beside width 256, CUDA-event times.  (c) a hidden-192
    model of the flagship's shape (random weights from seed 0) through
    cli.generate_ligands on phase 5's pocket, 16 x 24, T = 50, and the same
    model at hidden 256 as its yardstick, in turns 192, 256, 192, 256: 8T +
    6 ``gcl_agg`` and 6T + 6 ``coord_agg`` launches each, ms a pass.  (d) the
    package root's ``load_model`` at its default device: the module on the
    card, the checkpoint's only name ``best`` loaded for ``last``.  (e) what
    still raises before any launch: an unknown precision name (as JAX's
    ``_PRECISIONS[name]`` does); widths above 1024 are phase 20i's."""
    import diffsbdd_tpu_torch
    from diffsbdd_tpu_torch.config import load_config
    res = {"card": card, "kernels": {}}
    for width in PADDED_WIDTHS:
        res["kernels"][width] = padded_kernel_phase(ec, torch, dev, flagship, width)

    timing = {}
    for width in (192, 256):
        cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))
        inp = kernel_inputs(torch, dev, cfg, 16, 24)
        args = [inp[k] for k in ("a_row", "a_col", "x", "x0", "mask", "is_lig")]
        timing[width] = _cuda_ms(lambda: ec.gcl_message_agg(
            *args, *inp["gcl_w"].values(), cutoffs=inp["cut"], attention=True,
            normalization_factor=100.0), 20)
        del inp, args
    res["gcl_agg_ms"] = {"F192_at_256": timing[192], "F256": timing[256]}
    print(f"  {card}: gcl_agg at B = 16, 24 + 300 atoms: width 192 padded "
          f"{timing[192]:.4f} ms, width 256 {timing[256]:.4f} ms")

    chain, res["chain"] = PADDED_CHAIN, {192: [], 256: []}
    ckpts = {width: _random_checkpoint(torch, dict(flagship, egnn_params=dict(
        flagship["egnn_params"], hidden_nf=width)), None, work / f"h{width}")[0]
        for width in (192, 256)}
    want = chain_launches(ec, 6, chain["T"])
    for width in (192, 256, 192, 256):
        sdf = work / f"h{width}.sdf"
        wall, sample_s, launches, by_tier, xh = _captured_generate(
            torch, ec, [ckpts[width], "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile",
                        sdf, "--n_samples", chain["n"], "--num_nodes_lig", 24,
                        "--all_frags", "--timesteps", chain["T"]])
        _check(launches == want, f"the hidden-{width} chain launched {launches}, not {want}")
        _check(bool(torch.isfinite(xh).all()), f"the hidden-{width} chain's samples")
        mols = _sdf_molecules(sdf)
        _check(0 < len(mols) <= chain["n"], f"the hidden-{width} chain wrote {len(mols)}")
        res["chain"][width].append(dict(
            chain, ms_per_pass=1e3 * sample_s / (chain["T"] + 1), sample_s=sample_s,
            wall_s=wall, launches=launches, launches_by_tier=by_tier, molecules=len(mols)))
        print(f"  {card}: hidden {width}" + (" (run at 256)" if width == 192 else "")
              + f", {chain['n']} x 24 atoms, T={chain['T']}: "
              f"{res['chain'][width][-1]['ms_per_pass']:.2f} ms a pass, CLI wall {wall:.2f} s, "
              f"launches {launches}, {len(mols)} molecules")
    module, _ = diffsbdd_tpu_torch.load_model(ckpts[192], name="last")
    on = {p.device.type for p in module.parameters()}
    _check(on == {"cuda"}, f"diffsbdd_tpu_torch.load_model put the module on {on}")
    res["root_load_model"] = sorted(on)
    print(f"  diffsbdd_tpu_torch.load_model(ckpt, name='last'): best loaded, on {on}")
    del module

    def refused(key, call, names):
        try:
            call()
            res[key] = ""
        except ValueError as err:
            res[key] = str(err)
        _check(names in res[key], f"{key} did not raise naming {names}")
        print(f"  {key}: raises '{res[key][:100]}'")

    ec.reset_launch_counts()
    refused("unknown_precision", lambda: load_config(
        overrides=dict(flagship, tpu={"matmul_precision": "float16"})), "matmul_precision")
    _check(not any(ec.launch_counts.values()), "a refused call launched a kernel")
    return res


WIDE = 512  # built on tiles of two rows
WIDE_PADDED = (384, 448)  # run on the F = 512 kernels (ec.padded_width)
WIDE_CHAIN = dict(n=16, T=20)
# the F = 512 kernels' 3xTF32 target: error within this share of the plain
# version's largest entry (reported beside the binding gates, TIER_GATES)
WIDE_3XTF32_SHARE = 5e-6
WIDEST = 1024  # the widest width on tiles of one row without a cluster
WIDEST_PADDED = (768,)  # run on the F = 1024 kernels
WIDEST_CHAIN = dict(n=16, T=2)  # shorter than 20h's: phases 20j-20n share the time limit
# phase 20i's measurement builds, started with phase 2's: (kernel, define,
# library) -- the GCL backward without its dW2 step (its output's dW2 stays
# zero), and the GCL forward at F = 1024 without the step sums
MEASUREMENT_BUILDS = {"skip_dw2": ("gcl_agg_bwd", "-DEGNN_SKIP_DW2",
                                   "libgcl_agg_bwd_skip_dw2.so"),
                      "no_step_sums": ("gcl_agg", "-DEGNN_NO_STEP_SUMS",
                                       "libgcl_agg_no_step_sums.so")}


def _float64(tree):
    """Every floating tensor of ``tree`` (dicts, lists, tuples) in float64."""
    if isinstance(tree, dict):
        return {k: _float64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_float64(v) for v in tree)
    return tree.double() if hasattr(tree, "is_floating_point") and tree.is_floating_point() \
        else tree


def float64_shares(ec, torch, dev, flagship, width, names=None):
    """The five 3xTF32 kernels (or ``names`` of them) at ``width`` on 20a's
    inputs (phases 3, 3b and 3c's main shapes; the block at B = 8): each
    output's largest error over its largest entry against the plain version
    in float64 (the exact result), beside the float32 plain version's own:
    {kernel: (kernel's, float32 plain version's)}, the largest over the
    outputs."""
    cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))
    node = ("a_row", "a_col", "x", "x0", "mask", "is_lig")
    fwd = {k: v for k, v in kernel_inputs(torch, dev, cfg, 16, 24).items() if k != "r"}
    sizes = np.random.default_rng(0).integers(24, 33, 16)
    bwd = kernel_inputs(torch, dev, cfg, 16, 32, lig_sizes=sizes, seed=1)
    g_gcl, g_coord = bwd["r"](16, bwd["N"], width), bwd["r"](16, bwd["N"], 3)
    bwd = {k: v for k, v in bwd.items() if k != "r"}
    cross_b = {k: v for k, v in bwd["cross"].items() if k != "type_bias"}
    cross_b["delta"] = bwd["cross_delta"]
    blk = kernel_inputs(torch, dev, cfg, JOINT_SAMPLES, 24, seed=7)
    bkw = dict(cutoffs=blk["cut"], attention=True, tanh=True, coords_range=15.0,
               norm_constant=1.0, normalization_factor=100.0)

    def gcl_fwd(fn, i, sl=slice(None)):
        return {"agg": fn(*(i[k][sl] for k in node), *i["gcl_w"].values(), cutoffs=i["cut"],
                          attention=True, normalization_factor=100.0)}

    def coord_fwd(fn, i, sl=slice(None)):
        c = {k: (v[sl] if k in ("a_row", "a_col") else v) for k, v in i["cross"].items()}
        return {"dx": fn(*(i[k][sl] for k in node), *i["coord_w"], cutoffs=i["cut"], tanh=True,
                         coords_range=15.0, norm_constant=1.0, normalization_factor=100.0,
                         update_rows=i["NL"], cross=c, graph_mean=i["graph_mean"][sl])}

    def gcl_bwd(fn, i, g, sl=slice(None)):
        w = i["gcl_w"]
        return _name_cotangents(fn(
            g[sl], *(i[k][sl] for k in node), w["w_d2"], w["w_d20"], i["gcl_delta"], w["w2"],
            w["b2"], w["w_att"], w["b_att"], cutoffs=i["cut"], attention=True,
            normalization_factor=100.0), GCL_COT)

    def coord_bwd(fn, i, g, cr, sl=slice(None)):
        w_d2, w_d20, _, w2, b2, w3 = i["coord_w"]
        c = {k: (v[sl] if k in ("a_row", "a_col") else v) for k, v in cr.items()}
        return _name_cotangents(fn(
            g[sl], *(i[k][sl] for k in node), w_d2, w_d20, i["coord_delta"], w2, b2, w3,
            cutoffs=i["cut"], tanh=True, coords_range=15.0, norm_constant=1.0,
            normalization_factor=100.0, cross=c, graph_mean=i["graph_mean"][sl],
            update_rows=32), COORD_COT)

    def block(fn, ops, sl=slice(None)):
        per_graph = (0, 1, 2, 3, 4, 5, 6, 11)  # h .. is_lig, graph_mean
        return dict(zip(("h_new", "dx"), fn(*(o[sl] if n in per_graph else o
                                               for n, o in enumerate(ops)), **bkw)))

    def sliced(call, B, step):
        """A forward plain version over batch slices of ``step`` graphs,
        concatenated (its (B, N, N, F) tensors in float64 at F = 512 would
        not fit at once)."""
        parts = [call(slice(b, min(b + step, B))) for b in range(0, B, step)]
        return {out: torch.cat([p[out] for p in parts], 0) for out in parts[0]}

    bops = block_operands(blk)
    f64, g64, c64, b64 = _float64(fwd), _float64(g_gcl), _float64(g_coord), _float64(bops)
    bwd64, cross64 = _float64(bwd), _float64(cross_b)
    B = JOINT_SAMPLES
    cases = {  # kernel: (kernel's outputs, float32 plain's, float64 plain's)
        "gcl_agg": lambda: (
            gcl_fwd(ec.gcl_message_agg, fwd),
            sliced(lambda sl: gcl_fwd(ec.gcl_message_agg_plain, fwd, sl), 16, 8),
            sliced(lambda sl: gcl_fwd(ec.gcl_message_agg_plain, f64, sl), 16, 2)),
        "coord_agg": lambda: (
            coord_fwd(ec.coord_update_agg, fwd),
            sliced(lambda sl: coord_fwd(ec.coord_update_agg_plain, fwd, sl), 16, 8),
            sliced(lambda sl: coord_fwd(ec.coord_update_agg_plain, f64, sl), 16, 2)),
        "gcl_agg_bwd": lambda: (
            gcl_bwd(ec.gcl_agg_bwd, bwd, g_gcl),
            _plain_in_slices(torch, lambda sl: gcl_bwd(ec.gcl_agg_bwd_plain, bwd, g_gcl, sl),
                             16, 4),
            _plain_in_slices(torch, lambda sl: gcl_bwd(ec.gcl_agg_bwd_plain, bwd64, g64, sl),
                             16, 2)),
        "coord_agg_bwd": lambda: (
            coord_bwd(ec.coord_agg_bwd, bwd, g_coord, cross_b),
            _plain_in_slices(torch, lambda sl: coord_bwd(ec.coord_agg_bwd_plain, bwd, g_coord,
                                                         cross_b, sl), 16, 2),
            _plain_in_slices(torch, lambda sl: coord_bwd(ec.coord_agg_bwd_plain, bwd64, c64,
                                                         cross64, sl), 16, 1)),
        "block_fused": lambda: (
            block(ec.block_fused, bops),
            sliced(lambda sl: block(ec.block_fused_plain, bops, sl), B, 4),
            sliced(lambda sl: block(ec.block_fused_plain, b64, sl), B, 1))}
    shares = {}
    for name, run in cases.items():
        if names is not None and name not in names:
            continue
        got, ref, exact = run()
        kernel = plain = 0.0
        for out, e in exact.items():
            if e is None:
                continue
            scale = float(e.abs().max()) + 1e-30
            kernel = max(kernel, float((got[out].double() - e).abs().max()) / scale)
            plain = max(plain, float((ref[out].double() - e).abs().max()) / scale)
        shares[name] = (kernel, plain)
        del got, ref, exact
    return shares


def wide_width_phase(torch, ec, dev, flagship, logs, work, pdb, ref_lig, card,
                     width=WIDE, padded=WIDE_PADDED, chain=WIDE_CHAIN, label="20h"):
    """Phases 20h and 20i, the widths above 256 on the F = ``width``
    kernels (512: tiles of two rows; 1024: of one).  (a) the five kernels
    at F = ``width`` and every tier on phases 3, 3b and 3c's main shapes
    (``tier_kernel_phase``, ``tier_block_phase`` at the joint chain's B =
    8) within the tier gates, the 3xTF32 error beside the
    ``WIDE_3XTF32_SHARE`` target and, against the float64 plain version
    (``float64_shares``), beside the float32 plain version's own, and the
    instantiations' registers and spills.  (b) ``padded_kernel_phase`` at
    each of ``padded``: one launch of each wrapper's library at 3xTF32 and
    bf16.  (c) the flagship's shape at hidden ``width`` from seeded random
    weights: cli.generate_ligands (``chain``'s n x 24 atoms on phase 5's
    pocket, its T: 8T + 6 and 6T + 6 launches), one conditional train step
    at batch 16 (6 launches of each split kernel, forward and backward; ms a
    step), the joint model's chain with block fusing on (8 x 24, the same T:
    6T + 6 whole-block launches), and the chain again at hidden
    ``padded[0]``."""
    from diffsbdd_tpu_torch.checkpoint import load_model
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset, PaddedLoader
    from diffsbdd_tpu_torch.diffusion.ddpm import JointDDPM
    from diffsbdd_tpu_torch.train import loop
    t0 = time.perf_counter()
    res = {"card": card}
    kernels = tier_kernel_phase(ec, torch, dev, flagship, width)
    blocks = tier_block_phase(ec, torch, dev, flagship, width, ["joint_main_path"])
    kernels.update({f"block_fused[{tier}]": entry
                    for tier, entry in blocks["joint_main_path"].items()})
    usage = ptxas_usage(logs, width)
    exact = res["float64_shares"] = float64_shares(ec, torch, dev, flagship, width)
    for name in ec.KERNELS:
        _check(name in usage, f"{name} has no instantiation at F = {width}")
        entry = kernels[f"{name}[tf32x3]"]
        entry["within_3xtf32_target"] = entry["gate_share"] <= WIDE_3XTF32_SHARE
        entry["f64_share"], entry["plain_f64_share"] = exact[name]
        print(f"  {name}[tf32x3] F={width}: error {entry['gate_share']:.2e} of the largest "
              f"entry, the {WIDE_3XTF32_SHARE:g} target "
              + ("met" if entry["within_3xtf32_target"] else "missed")
              + f"; against float64 the kernel {entry['f64_share']:.2e}, the float32 plain "
              f"version {entry['plain_f64_share']:.2e}")
        for u in usage[name]:
            print(f"  {name} F={width} {u['function'][:60]}: {u['registers']} registers, "
                  f"spill stores {u['spill_stores']} B, loads {u['spill_loads']} B")
        for tier in ec.TIERS:
            kernels[f"{name}[{tier}]"]["ptxas"] = usage[name]
    res["kernels"] = kernels
    res["padded"] = {w: padded_kernel_phase(ec, torch, dev, flagship, w) for w in padded}

    def model(width, **over):
        return dict(flagship, **over, egnn_params=dict(flagship["egnn_params"],
                                                       hidden_nf=width))

    want = chain_launches(ec, 6, chain["T"])
    res["chain"] = {}
    for hidden in (width, padded[0]):
        ckpt = _random_checkpoint(torch, model(hidden), None, work / f"wide{hidden}")[0]
        sdf = work / f"wide{hidden}.sdf"
        wall, sample_s, launches, by_tier, xh = _captured_generate(
            torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile", sdf,
                        "--n_samples", chain["n"], "--num_nodes_lig", 24, "--all_frags",
                        "--timesteps", chain["T"]])
        _check(launches == want, f"the hidden-{hidden} chain launched {launches}, not {want}")
        _check(bool(torch.isfinite(xh).all()), f"the hidden-{hidden} chain's samples")
        mols = _sdf_molecules(sdf)
        _check(0 < len(mols) <= chain["n"], f"the hidden-{hidden} chain wrote {len(mols)}")
        res["chain"][hidden] = dict(chain, run_at=ec.padded_width(hidden), launches=launches,
                                    ms_per_pass=1e3 * sample_s / (chain["T"] + 1),
                                    sample_s=sample_s, wall_s=wall, molecules=len(mols))
        print(f"  {card}: hidden {hidden} (kernels at {ec.padded_width(hidden)}), "
              f"{chain['n']} x 24 atoms, T={chain['T']}: "
              f"{res['chain'][hidden]['ms_per_pass']:.2f} ms a pass, CLI wall {wall:.2f} s, "
              f"launches {launches}, {len(mols)} molecules")

    data = work / f"data{label}"
    write_synthetic_dataset(data, 16, 1, seed=22, pocket_sizes=(250, 280, 310, 320),
                            n_types=11)
    batch = next(iter(PaddedLoader(LigandPocketDataset(data / "train.npz"), 16,
                                   shuffle=False)))
    lig = loop.batch_to_device(batch["ligand"], dev)
    pkt = loop.batch_to_device(batch["pocket"], dev)
    ckpt = _random_checkpoint(torch, model(width), np.load(data / "size_distribution.npy"),
                              work / f"wide{width}_train")[0]
    module, _ = load_model(ckpt, device=dev)
    module.train()
    ec.reset_launch_counts()
    loss, _ = module.loss_fn(None, lig, pkt, training=True)
    grads = torch.autograd.grad(loss, [p for p in module.parameters()], allow_unused=True)
    torch.cuda.synchronize()
    step_launches = dict(ec.launch_counts)
    _check(step_launches == {**dict.fromkeys(ec.KERNELS, 6), "block_fused": 0},
           f"the hidden-{width} train step launched {step_launches}")
    _check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                              for g in grads if g is not None),
           f"the hidden-{width} train step: non-finite loss or gradients")
    step = loop.make_train_step(loop.create_train_state(module, lr=1e-4))
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(None, lig, pkt)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
    res["train_step"] = dict(batch=16, launches=step_launches, loss=float(loss.detach()),
                             ms_per_step=float(np.median(times[1:])))
    print(f"  {card}: hidden {width} train step at batch 16: "
          f"{res['train_step']['ms_per_step']:.2f} ms (median of 3), launches {step_launches}")
    del module, grads, step

    T = chain["T"]
    ckpt = _random_checkpoint(torch, model(width, mode="joint",
                                           tpu={"kernel_block_fuse": True}),
                              None, work / f"wide{width}_joint")[0]
    passes = len(JointDDPM._repaint_plan(1, 1, T)[0]) + 1
    sdf = work / f"wide{width}_joint.sdf"
    wall, sample_s, launches, by_tier, xh = _captured_generate(
        torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile", sdf,
                    "--n_samples", JOINT_SAMPLES, "--num_nodes_lig", 24, "--all_frags",
                    "--timesteps", T, "--resamplings", 1, "--jump_length", 1], joint=True)
    want = {**dict.fromkeys(ec.KERNELS, 0), "block_fused": 6 * passes}
    _check(launches == want, f"the hidden-{width} joint chain launched {launches}, not {want}")
    _check(bool(torch.isfinite(xh).all()), f"the hidden-{width} joint chain's samples")
    res["joint"] = dict(n=JOINT_SAMPLES, T=T, launches=launches, sample_s=sample_s,
                        wall_s=wall, ms_per_pass=1e3 * sample_s / passes)
    print(f"  {card}: hidden {width} joint chain, {JOINT_SAMPLES} x 24 atoms, T={T}, block "
          f"fusing on: {res['joint']['ms_per_pass']:.2f} ms a pass, launches {launches}")

    res["phase_s"] = time.perf_counter() - t0
    print(f"  phase {label} took {res['phase_s']:.1f} s")
    return res


CLUSTER_WIDTH = 2048  # the split kernels' widest: a row tile on two blocks
CLUSTER_KERNELS = ("gcl_agg", "coord_agg")  # phase 20j's; 20k's the backward two
CLUSTER_PADDED = (1088, 1536)  # run on the F = 2048 kernels (ec.padded_width)
CLUSTER_CHAIN = dict(n=16, T=2)  # phases 20j-20n share the time limit
CLUSTER_JOINT = dict(n=JOINT_SAMPLES, T=2)  # 20j's and 20l's joint chains
CLUSTER_PLAIN_STEP = 2  # graphs a slice of the plain versions: 1.9 GB a (2, 344, 344, 2048) tensor


def forward_dynamic_smem(ec, F, N):
    """Bytes of dynamic shared memory of a forward cluster kernel's block at
    built width F (csrc/egnn_mma.cuh's dynamic_smem): S (all F features at
    2048; the block's own part and the staging of a peer's above), the two
    8-row W2 stages of the block's F / C columns, the column list."""
    C = ec.cluster_size(F)
    s_floats = 2 * 16 * (F // C + 4) if C > 2 else 16 * (F + 4)
    return 4 * (s_floats + 2 * 8 * (F // C + 8)) + 4 * N


def cluster_kernel_phase(ec, torch, dev, flagship, logs, width=CLUSTER_WIDTH,
                         variants=None, step=CLUSTER_PLAIN_STEP, reps=3):
    """Phase 20j (a): ``gcl_agg`` and ``coord_agg`` at F = 2048 (each row
    tile on a cluster of two blocks) at every tier, at phase 3's shapes:
    ``gcl_agg`` on the full graph and the collapsed complex (B = 16, 24 +
    320 atoms), ``coord_agg`` on ligand rows with the cross branch on and
    off and on every row of the joint chain's batch (B = 8).  Each variant
    against its plain version at the tier (batch slices of ``step``
    graphs) within ``ec.TIER_GATES``, the reduced tiers' error norm against
    their move from the 3xTF32 kernel's output; two launches bit for bit;
    the cluster dimension each launch used (``ec.cluster_size``); CUDA-event
    ms of kernel (``reps`` launches) and plain version, the tier's bound;
    the instantiations' registers, spills and shared memory a block.  The
    reduced tiers are checked on the first ``REDUCED_CHECK_BATCH`` graphs
    (kernel, plain version and the 3xTF32 output their move is read from),
    their kernel timed at the full batch.  ``width``, ``variants`` (their
    names, all when None): phase 20m's F = 4096 (clusters of four) on a
    subset."""
    cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))
    NL = 24
    inputs = {"full": kernel_inputs(torch, dev, cfg, 16, NL),
              "collapsed": kernel_inputs(torch, dev, cfg, 16, NL, seed=9, spread=1.0),
              "b8": kernel_inputs(torch, dev, cfg, JOINT_SAMPLES, NL, seed=10)}
    node = ("a_row", "a_col", "x", "x0", "mask", "is_lig")

    def gcl(i):
        def call(fn, tier, sl=slice(None)):
            return fn(*(i[k][sl] for k in node), *i["gcl_w"].values(), cutoffs=i["cut"],
                      attention=True, normalization_factor=100.0, precision=tier)
        return call

    def coord(i, cross, rows):
        def call(fn, tier, sl=slice(None)):
            kw = {}
            if cross:
                kw = dict(cross={k: (v[sl] if k in ("a_row", "a_col") else v)
                                 for k, v in i["cross"].items()},
                          graph_mean=i["graph_mean"][sl])
            return fn(*(i[k][sl] for k in node), *i["coord_w"], cutoffs=i["cut"], tanh=True,
                      coords_range=15.0, norm_constant=1.0, normalization_factor=100.0,
                      update_rows=rows, precision=tier, **kw)
        return call

    full, dense, b8 = inputs["full"], inputs["collapsed"], inputs["b8"]
    N, F, want_cluster = full["N"], width, ec.cluster_size(width)
    names = variants
    variants = {  # (kernel, call, batch, work)
        "full": ("gcl_agg", gcl(full), 16,
                 work_bounds(active_pairs(ec, full), 16, N, F, 1, N, F)),
        "full_collapsed": ("gcl_agg", gcl(dense), 16,
                           work_bounds(active_pairs(ec, dense), 16, N, F, 1, N, F)),
        "ligand_rows_cross": ("coord_agg", coord(full, True, NL), 16,
                              work_bounds(active_pairs(ec, full, rows=NL), 16, N, F, 2, NL, 3)),
        "ligand_rows_nocross": ("coord_agg", coord(full, False, NL), 16,
                                work_bounds(active_pairs(ec, full, rows=NL), 16, N, F, 1, NL,
                                            3)),
        "all_rows_cross_b8": ("coord_agg", coord(b8, True, None), JOINT_SAMPLES,
                              work_bounds(active_pairs(ec, b8), JOINT_SAMPLES, N, F, 2, N, 3))}
    wrappers = {"gcl_agg": ec.gcl_message_agg, "coord_agg": ec.coord_update_agg}
    plains = {"gcl_agg": ec.gcl_message_agg_plain, "coord_agg": ec.coord_update_agg_plain}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    res = {}
    for v, (name, call, B, work) in variants.items():
        if names is not None and v not in names:
            continue
        base = None
        for tier in ec.TIERS:
            gate = ec.TIER_GATES[tier]
            what = f"{name}[{tier}] F={F} {v}"
            rows = B if tier == ec.DEFAULT_TIER else REDUCED_CHECK_BATCH
            sub = slice(0, rows)
            ec.reset_launch_counts()
            got, again = call(wrappers[name], tier, sub), call(wrappers[name], tier, sub)
            cluster = ec.last_cluster_dim(name, tier)
            launched = {k: n for k, n in ec.tier_launch_counts.items() if n}
            _check(launched == {f"{name}[{tier}]": 2},
                   f"{what}: launched {launched}, not its tier's library")
            _check(cluster == want_cluster,
                   f"{what}: cluster dimension {cluster}, not {want_cluster}")
            start.record()
            ref = torch.cat([call(plains[name], tier, slice(b, b + step))
                             for b in range(0, rows, step)], 0)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            limit = 1e-5 + 1e-4 * ref.abs() + gate["share"] * scale
            _check(bool(torch.isfinite(got).all()) and bool(((got - ref).abs() <= limit).all()),
                   f"{what}: error {err:.3e} over its gate (largest entry {scale:.3e})")
            _check(torch.equal(got, again), f"{what}: two launches differ")
            moved_share = 0.0 if base is None else ec.tier_moved_share(got, ref, base[sub])
            if gate["moved"] is not None:
                _check(moved_share <= gate["moved"],
                       f"{what}: error norm {moved_share:.3f} of the tier's move, "
                       f"gate {gate['moved']}")
            base = got if base is None else base
            ms = _cuda_ms(lambda: call(wrappers[name], tier), reps)
            bound_ms, bound_by = tier_bound(work["flops"], work["bytes"], tier)
            res[f"{name}[{tier}]:{v}"] = dict(
                kernel=name, tier=tier, variant=v, width=F, batch=B, checked_batch=rows,
                cluster_dim=cluster,
                max_abs_err=err, gate_share=err / (scale + 1e-30), moved_share=moved_share,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                pairs=work["pairs"], flops=work["flops"])
            print(f"  {what}: cluster of {cluster}, {ms:.3f} ms (plain {plain_ms:.1f} ms), "
                  f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%); error "
                  f"{err / (scale + 1e-30):.2e} of the largest entry"
                  + ("" if gate["moved"] is None else
                     f", error norm {moved_share:.4f} of the tier's move")
                  + ("" if rows == B else f"; checked on the first {rows} graphs"))
            del got, again, ref
        if base is not None:
            del base
    usage = ptxas_usage(logs, F)
    smem = {"dynamic": forward_dynamic_smem(ec, F, N)}
    for name in CLUSTER_KERNELS:
        _check(name in usage, f"{name} has no instantiation at F = {F}")
        for u in usage[name]:
            print(f"  {name} F={F} {u['function'][:60]}: {u['registers']} registers, spill "
                  f"stores {u['spill_stores']} B, loads {u['spill_loads']} B; shared memory "
                  f"{smem['dynamic']} B dynamic (N = {N}) + {u['static_smem']} B static")
    del inputs, full, dense, b8
    torch.cuda.empty_cache()
    return {"variants": res, "ptxas": {k: usage[k] for k in CLUSTER_KERNELS},
            "smem_dynamic": smem["dynamic"]}


def cluster_width_phase(torch, ec, dev, flagship, logs, work, pdb, ref_lig, card):
    """Phase 20j, hidden widths 1025-2048 on the forward split kernels at
    F = 2048 (a row tile on a cluster of two blocks; the backward kernels'
    are 20k's, ``block_fused``'s 20l's).  (a) ``cluster_kernel_phase``.  (b)
    ``padded_kernel_phase`` of the two forward kernels at each of
    ``CLUSTER_PADDED``: one launch of each wrapper's library at 3xTF32 and
    bf16, on a cluster of two.  (c) the flagship's shape from seeded random
    weights: cli.generate_ligands at hidden 2048 and 1536 (16 x 24 on phase
    5's pocket, ``CLUSTER_CHAIN``'s T: 8T + 6 and 6T + 6 launches), and the
    joint model at hidden 2048 with block fusing off (``CLUSTER_JOINT``: 6
    launches of each split kernel a pass).  (d) the refusal before any
    launch of wider widths is 20m's (the forward wrappers), 20n's (the
    backward ones) and 20o's (``block_fused``): every kernel runs 2049-4096
    on its F = 4096 instantiation."""
    from diffsbdd_tpu_torch.diffusion.ddpm import JointDDPM
    t0 = time.perf_counter()
    res = {"card": card, "kernels": cluster_kernel_phase(ec, torch, dev, flagship, logs)}
    res["padded"] = {w: padded_kernel_phase(ec, torch, dev, flagship, w, names=CLUSTER_KERNELS)
                     for w in CLUSTER_PADDED}
    for w, r in res["padded"].items():
        for key, entry in r.items():
            _check(entry["cluster_dim"] == 2, f"width {w} {key}: cluster {entry['cluster_dim']}")

    def model(width, **over):
        return dict(flagship, **over, egnn_params=dict(flagship["egnn_params"],
                                                       hidden_nf=width))

    chain = CLUSTER_CHAIN
    want = chain_launches(ec, 6, chain["T"])
    res["chain"] = {}
    for hidden in (CLUSTER_WIDTH, CLUSTER_PADDED[-1]):
        ckpt = _random_checkpoint(torch, model(hidden), None, work / f"cluster{hidden}")[0]
        sdf = work / f"cluster{hidden}.sdf"
        wall, sample_s, launches, by_tier, xh = _captured_generate(
            torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile", sdf,
                        "--n_samples", chain["n"], "--num_nodes_lig", 24, "--all_frags",
                        "--timesteps", chain["T"]])
        _check(launches == want, f"the hidden-{hidden} chain launched {launches}, not {want}")
        _check(bool(torch.isfinite(xh).all()), f"the hidden-{hidden} chain's samples")
        mols = _sdf_molecules(sdf)
        _check(0 < len(mols) <= chain["n"], f"the hidden-{hidden} chain wrote {len(mols)}")
        res["chain"][hidden] = dict(chain, run_at=ec.padded_width(hidden), launches=launches,
                                    ms_per_pass=1e3 * sample_s / (chain["T"] + 1),
                                    sample_s=sample_s, wall_s=wall, molecules=len(mols))
        print(f"  {card}: hidden {hidden} (kernels at {ec.padded_width(hidden)}), "
              f"{chain['n']} x 24 atoms, T={chain['T']}: "
              f"{res['chain'][hidden]['ms_per_pass']:.2f} ms a pass, CLI wall {wall:.2f} s, "
              f"launches {launches}, {len(mols)} molecules")
        shutil.rmtree(work / f"cluster{hidden}", ignore_errors=True)

    T = CLUSTER_JOINT["T"]
    ckpt = _random_checkpoint(torch, model(CLUSTER_WIDTH, mode="joint",
                                           tpu={"kernel_block_fuse": False}),
                              None, work / "cluster_joint")[0]
    passes = len(JointDDPM._repaint_plan(1, 1, T)[0]) + 1
    sdf = work / "cluster_joint.sdf"
    wall, sample_s, launches, by_tier, xh = _captured_generate(
        torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile", sdf,
                    "--n_samples", CLUSTER_JOINT["n"], "--num_nodes_lig", 24, "--all_frags",
                    "--timesteps", T, "--resamplings", 1, "--jump_length", 1], joint=True)
    want = {**dict.fromkeys(ec.KERNELS, 0), "gcl_agg": 6 * passes, "coord_agg": 6 * passes}
    _check(launches == want,
           f"the hidden-{CLUSTER_WIDTH} joint chain launched {launches}, not {want}")
    _check(bool(torch.isfinite(xh).all()), f"the hidden-{CLUSTER_WIDTH} joint chain's samples")
    res["joint"] = dict(CLUSTER_JOINT, launches=launches, sample_s=sample_s, wall_s=wall,
                        ms_per_pass=1e3 * sample_s / passes)
    print(f"  {card}: hidden {CLUSTER_WIDTH} joint chain, {CLUSTER_JOINT['n']} x 24 atoms, "
          f"T={T}, block fusing off: {res['joint']['ms_per_pass']:.2f} ms a pass, "
          f"launches {launches}")
    shutil.rmtree(work / "cluster_joint", ignore_errors=True)
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    print(f"  phase 20j took {res['phase_s']:.1f} s")
    return res


CLUSTER_BWD_KERNELS = ("gcl_agg_bwd", "coord_agg_bwd")
CLUSTER_TRAIN = (CLUSTER_WIDTH, CLUSTER_PADDED[-1])  # hidden widths of 20k's train steps
# depth of 20k's train steps and 20m-20o's models (the flagship's 6 layers
# cut for the time limit: at hidden 4096 six layers are 1.21 G parameters,
# and cli.train writes 38.7 GB of checkpoints for them)
WIDE_LAYERS = 2


def wide_model(flagship, hidden, **over):
    """The flagship's config at ``hidden`` with ``WIDE_LAYERS`` layers."""
    return dict(flagship, **over, egnn_params=dict(flagship["egnn_params"], hidden_nf=hidden,
                                                   n_layers=WIDE_LAYERS))


def cluster_train_step(torch, ec, dev, flagship, hidden, lig, pkt, histogram):
    """Two conditional train steps (``loop.make_train_step``: forward,
    backward, clipping, the optimizer) on the batch ``lig``, ``pkt`` of
    ``wide_model(flagship, hidden)`` from seeded random weights: the first's
    launches (one of each split kernel a layer, each split kernel's last on
    clusters of ``ec.cluster_size`` blocks at the width it runs: two at
    2048, four at 4096), its peak device memory, its loss and gradient norm
    finite; the second's ms."""
    from diffsbdd_tpu_torch.config import load_config
    from diffsbdd_tpu_torch.train import loop
    from diffsbdd_tpu_torch.train.module import build_module_from_config
    cfg = load_config(overrides=wide_model(flagship, hidden))
    torch.manual_seed(0)
    module = build_module_from_config(cfg, histogram).to(dev)
    module.train()
    step = loop.make_train_step(loop.create_train_state(module, lr=1e-4))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ec.reset_launch_counts()
    info = step(None, lig, pkt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(ec.launch_counts)
    want = {**dict.fromkeys(ec.KERNELS, WIDE_LAYERS), "block_fused": 0}
    _check(launches == want, f"the hidden-{hidden} train step launched {launches}, not {want}")
    clusters = {k: ec.last_cluster_dim(k) for k in ec.KERNELS if k != "block_fused"}
    want_dim = ec.cluster_size(ec.padded_width(hidden))
    _check(set(clusters.values()) == {want_dim},
           f"the hidden-{hidden} train step's clusters {clusters}, not {want_dim}")
    loss, gnorm = float(info["loss"]), float(info["grad_norm"])
    _check(np.isfinite(loss) and np.isfinite(gnorm),
           f"the hidden-{hidden} train step: loss {loss}, gradient norm {gnorm}")
    t = time.perf_counter()
    step(None, lig, pkt)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    del module, step
    torch.cuda.empty_cache()
    return dict(batch=int(lig["x"].shape[0]), layers=WIDE_LAYERS,
                run_at=ec.padded_width(hidden), launches=launches,
                cluster_dims=clusters, loss=loss, grad_norm=gnorm, ms_per_step=ms,
                peak_gib=peak)


def cluster_bwd_phase(torch, ec, dev, flagship, logs, work, card, dw2):
    """Phase 20k, training at hidden widths 1025-2048 on the backward
    kernels at F = 2048 (a row tile on a cluster of two blocks).  (a)
    ``tier_kernel_phase`` of gcl_agg_bwd and coord_agg_bwd at F = 2048 at
    every tier on phase 3b's main shapes (B = 16, ligands of 24-32 padded to
    32 + 320 pocket atoms; the plain versions in batch slices of 2 and 1):
    the tier gates, two launches bit for bit, the cluster dimension of each
    tier's last launch, ms, plain ms, bound; the instantiations' registers,
    spills and shared memory; beside them ``dw2`` (20i's dW2 share at F =
    2048).  (b) ``cluster_train_step`` at hidden 2048 and 1536 on a seeded
    synthetic batch of 16 (ligands of 16-32 atoms, pockets of 250-320;
    ``WIDE_LAYERS`` layers)."""
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset, PaddedLoader
    from diffsbdd_tpu_torch.train import loop
    t0 = time.perf_counter()
    F = CLUSTER_WIDTH
    kernels = tier_kernel_phase(ec, torch, dev, flagship, F, names=CLUSTER_BWD_KERNELS)
    for name in CLUSTER_BWD_KERNELS:
        for tier in ec.TIERS:
            dim = kernels[f"{name}[{tier}]"]["cluster_dim"] = ec.last_cluster_dim(name, tier)
            _check(dim == 2, f"{name}[{tier}] F={F}: cluster dimension {dim}, not 2")
    usage = ptxas_usage(logs, F)
    smem = 4 * (16 * F + 2 * 8 * (F // 2 + 8)) + 4 * 352  # A, B and the columns at N = 352
    for name in CLUSTER_BWD_KERNELS:
        _check(name in usage, f"{name} has no instantiation at F = {F}")
        for u in usage[name]:
            print(f"  {name} F={F} {u['function'][:60]}: {u['registers']} registers, spill "
                  f"stores {u['spill_stores']} B, loads {u['spill_loads']} B; shared memory "
                  f"{smem} B dynamic (N = 352) + {u['static_smem']} B static")
        for tier in ec.TIERS:
            kernels[f"{name}[{tier}]"]["ptxas"] = usage[name]
    print(f"  gcl_agg_bwd[tf32x3] F={F}: the dW2 step {dw2['dw2_ms']:.2f} of "
          f"{dw2['ms']:.2f} ms, {100 * dw2['dw2_share']:.1f}% (20i's timing build)")
    res = {"card": card, "kernels": kernels, "dw2": dw2, "smem_dynamic": smem,
           "train_step": {}}
    data = work / "data20k"
    write_synthetic_dataset(data, 16, 1, seed=24, pocket_sizes=(250, 280, 310, 320),
                            n_types=11)
    batch = next(iter(PaddedLoader(LigandPocketDataset(data / "train.npz"), 16,
                                   shuffle=False)))
    lig = loop.batch_to_device(batch["ligand"], dev)
    pkt = loop.batch_to_device(batch["pocket"], dev)
    histogram = np.load(data / "size_distribution.npy")
    for hidden in CLUSTER_TRAIN:
        r = res["train_step"][hidden] = cluster_train_step(
            torch, ec, dev, flagship, hidden, lig, pkt, histogram)
        print(f"  {card}: hidden {hidden} (kernels at {r['run_at']}), {r['layers']} layers, "
              f"train step at batch {r['batch']}: "
              f"{r['ms_per_step']:.1f} ms, peak {r['peak_gib']:.2f} GiB, loss "
              f"{r['loss']:.4f}, gradient norm {r['grad_norm']:.4f}, launches "
              f"{r['launches']}, clusters {r['cluster_dims']}")
    res["phase_s"] = time.perf_counter() - t0
    print(f"  phase 20k took {res['phase_s']:.1f} s")
    return res


CLUSTER_BLOCK_SHAPES = ("joint_main_path", "joint_main_path_dense")  # 3c's, B = 8
CLUSTER_BLOCK_PADDED = CLUSTER_PADDED[-1]  # run on the F = 2048 whole-block kernel
BF16_WITNESS_SEEDS = (7, 17, 27)  # B = CLUSTER_PLAIN_STEP graphs each, a width


def bf16_order_witness(ec, torch, dev, flagship):
    """Phase 20l, where the whole-block kernel's bf16 error comes from, at
    F = 1024 (a row tile on one block) and 2048 (on clusters of two): on
    ``BF16_WITNESS_SEEDS`` complexes of CLUSTER_PLAIN_STEP graphs at phase
    3c's joint shapes, the bf16 library and its bf16 plain version (float32
    sums) each against that plain version with its bf16 products summed in
    float64 (``ec.block_fused_bf16_exact``: the tier's roundings, exact sums
    rounded once).  Per width and output, the largest over the seeds of: the
    kernel's error against the plain version, the kernel's and the plain
    version's against the float64 sums, each as an error norm over the norm
    of the tier's move from the float32 plain version
    (``ec.tier_moved_share``) and as the largest error over the float64
    sums' largest entry; and under the bf16 gate (``ec.block_bf16_gate``)
    the kernel's ratio to the plain version and the ratio that a 3xTF32
    library in the bf16 slot reads.  Two orders of the same float32 sums
    read alike against the exact ones; a fault of the kernel's reads more.
    Fails if the kernel is over the gate, or if a 3xTF32 library is not
    (one output over it refuses a library) with a ratio above the gate's k,
    on any complex at either width."""
    res = {}
    k = ec.BLOCK_TIER_GATES["bf16"]["k"]
    for F in (WIDEST, CLUSTER_WIDTH):
        cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=F))
        worst = {}
        for seed in BF16_WITNESS_SEEDS:
            inp = kernel_inputs(torch, dev, cfg, CLUSTER_PLAIN_STEP, 24, seed=seed)
            ops = block_operands(inp)
            kw = dict(cutoffs=inp["cut"], attention=True, tanh=True, coords_range=15.0,
                      norm_constant=1.0, normalization_factor=100.0)
            got = ec.block_fused(*ops, **kw, precision="bf16")
            ref = ec.block_fused_plain(*ops, **kw, precision="bf16")
            f32 = ec.block_fused_plain(*ops, **kw)
            f64 = ec.block_fused_bf16_exact(*ops, **kw)
            tf32x3 = [ec.block_bf16_gate(x, r, e, x) for r, e, x in zip(ref, f64, f32)]
            # a library fails the gate when one output does
            _check(not all(t["ok"] for t in tf32x3) and max(t["ratio"] for t in tf32x3) > k,
                   f"block_fused[bf16] F={F} seed {seed}: a 3xTF32 library in the bf16 slot "
                   f"passes the gate, {tf32x3}")
            for name, g, r, e, x in zip(("h_new", "dx"), got, ref, f64, f32):
                _check(bool(torch.isfinite(g).all() and torch.isfinite(e).all()),
                       f"block_fused[bf16] F={F} {name}: not finite")
                scale = float(e.abs().max())
                kernel = ec.block_bf16_gate(g, r, e, x)
                _check(kernel["ok"], f"block_fused[bf16] F={F} {name} seed {seed}: over the "
                                     f"bf16 gate, {kernel}")
                now = dict(kernel_vs_plain=ec.tier_moved_share(g, r, x),
                           kernel_vs_f64=ec.tier_moved_share(g, e, x),
                           plain_vs_f64=ec.tier_moved_share(r, e, x),
                           kernel_vs_plain_max=float((g - r).abs().max()) / scale,
                           kernel_vs_f64_max=float((g - e).abs().max()) / scale,
                           plain_vs_f64_max=float((r - e).abs().max()) / scale,
                           kernel_ratio=kernel["ratio"])
                was = worst.setdefault(name, dict(dict.fromkeys(now, 0.0),
                                                  tf32x3_ratio=float("inf"),
                                                  tf32x3_fails=0))
                for key, v in now.items():
                    was[key] = max(was[key], v)
                # the least over the seeds: the gate must refuse 3xTF32 on every one
                t = tf32x3[0 if name == "h_new" else 1]
                was["tf32x3_ratio"] = min(was["tf32x3_ratio"], t["ratio"])
                was["tf32x3_fails"] += not t["ok"]
            del inp, ops, got, ref, f32, f64
            torch.cuda.empty_cache()
        res[F] = worst
        for name, w in worst.items():
            print(f"  block_fused[bf16] F={F} {name}, error norm over the tier's move, the "
                  f"largest of {len(BF16_WITNESS_SEEDS)} complexes of {CLUSTER_PLAIN_STEP}: "
                  f"kernel against plain {w['kernel_vs_plain']:.3f}; against the float64 "
                  f"sums the kernel {w['kernel_vs_f64']:.3f}, the plain version "
                  f"{w['plain_vs_f64']:.3f}; largest error over the largest entry "
                  f"{w['kernel_vs_plain_max']:.2e}, {w['kernel_vs_f64_max']:.2e}, "
                  f"{w['plain_vs_f64_max']:.2e}; under the gate (k = {k:g}) the kernel's "
                  f"ratio {w['kernel_ratio']:.3f}, a 3xTF32 library's {w['tf32x3_ratio']:.3f} "
                  f"(the least over the complexes; over the gate on {w['tf32x3_fails']} of "
                  f"{len(BF16_WITNESS_SEEDS)})")
    return res


def _block_batch(ops, sl):
    """``block_operands``' operands of the graphs ``sl`` (the per-graph ones:
    h .. is_lig and the graph mean)."""
    return (*(t[sl] for t in ops[:7]), *ops[7:11], None if ops[11] is None else ops[11][sl])


def _block_plain_in_slices(ec, torch, ops, kw, step):
    """``ec.block_fused_plain(*ops, **kw)`` over batch slices of ``step``
    graphs, concatenated."""
    B = ops[0].shape[0]
    parts = [ec.block_fused_plain(*_block_batch(ops, slice(b, b + step)), **kw)
             for b in range(0, B, step)]
    return tuple(torch.cat(outs, 0) for outs in zip(*parts))


def cluster_block_phase(torch, ec, dev, flagship, logs, work, pdb, ref_lig, card,
                        width=CLUSTER_WIDTH, shapes=CLUSTER_BLOCK_SHAPES,
                        step=CLUSTER_PLAIN_STEP, padded=CLUSTER_BLOCK_PADDED, layers=6,
                        witness=True, label="20l"):
    """Phase 20l, the whole-block kernel at F = 2048 (both phases on clusters
    of two blocks; sampling at hidden 1025-2048 with block fusing on).  (a)
    its library on phase 3c's joint shapes (B = 8, 24 + 320 atoms, every
    row moving: ``shapes`` of ``TIER_BLOCK_SHAPES``, the clean complex at
    every tier, the collapsed one at 3xTF32) against its plain version at
    the tier in batch slices of ``step`` graphs: each output within 1e-5 +
    (1e-4 + the tier's share) of its largest entry, the error norm within
    ``ec.BLOCK_TIER_GATES``' share of the tier's move from the 3xTF32
    kernel's output (at bf16 ``block_bf16_check``: against the bf16 sums in
    float64, within twice the plain version's own distance), that tier's
    library alone launched, two launches bit for bit, each on clusters of
    ``ec.cluster_size(width)``; the reduced tiers checked on the first
    ``REDUCED_CHECK_BATCH`` graphs; CUDA-event ms of kernel (the full
    batch) and plain version, the tier's bound and the 3xTF32 one; the
    instantiations' registers, spills and shared memory; with ``witness``
    also ``bf16_order_witness`` at F = 1024 and 2048.  (b)
    ``padded_kernel_phase`` of the whole block at ``padded``.  (c) the joint
    model at hidden ``width`` (``layers`` layers) from seeded random weights
    sampled with block fusing on (``CLUSTER_JOINT``: ``layers`` whole-block
    launches a pass and no split-kernel launch).  Phase 20o is the same at
    F = 4096 (clusters of four): ``width``, ``shapes``, ``step``,
    ``padded``, ``layers``, ``witness`` and ``label`` its; it also checks
    the refusal before any launch of width ``REFUSED_QUAD`` in
    ``block_fused``."""
    from diffsbdd_tpu_torch.diffusion.ddpm import JointDDPM
    t0 = time.perf_counter()
    F = width
    want_cluster = ec.cluster_size(F)
    cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=F))
    kernels = {}
    for shape in shapes:
        B, seed, spread, rows = TIER_BLOCK_SHAPES[shape]
        inp = kernel_inputs(torch, dev, cfg, B, 24, seed=seed, spread=spread)
        ops = block_operands(inp)
        kw = dict(cutoffs=inp["cut"], attention=True, tanh=True, coords_range=15.0,
                  norm_constant=1.0, normalization_factor=100.0, update_rows=rows)
        N = inp["N"]
        flops, bytes_ = block_work(B, N, F, active_pairs(ec, inp),
                                   active_pairs(ec, inp, rows=rows), 2)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        base = None
        for tier in ec.TIERS if shape == shapes[0] else (ec.DEFAULT_TIER,):
            gate = ec.BLOCK_TIER_GATES[tier]
            what = f"block_fused[{tier}] {shape} F={F}"
            n = B if tier == ec.DEFAULT_TIER else min(B, REDUCED_CHECK_BATCH)
            sub = _block_batch(ops, slice(0, n))
            ec.reset_launch_counts()
            got = ec.block_fused(*sub, **kw, precision=tier)
            again = ec.block_fused(*sub, **kw, precision=tier)
            cluster = ec.last_cluster_dim("block_fused", tier)
            launched = {k: v for k, v in ec.tier_launch_counts.items() if v}
            _check(launched == {f"block_fused[{tier}]": 2},
                   f"{what}: launched {launched}, not its tier's library")
            _check(cluster == want_cluster,
                   f"{what}: cluster dimension {cluster}, not {want_cluster}")
            start.record()
            ref = _block_plain_in_slices(ec, torch, sub, dict(kw, precision=tier), step)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            f32 = ref if base is None else f32
            bf16 = None
            if tier == "bf16":
                sums = _block_plain_in_slices(ec, torch, sub, dict(kw, precision=ec.BF16_EXACT),
                                              step)
                bf16 = block_bf16_check(ec, what, got, ref, sums, tuple(t[:n] for t in f32))
                del sums
            err = share = moved_share = 0.0
            for i, (name, g, a, r) in enumerate(zip(("h_new", "dx"), got, again, ref)):
                scale = float(r.abs().max())
                e = float((g - r).abs().max())
                _check(bool(torch.isfinite(g).all()) and
                       (bf16 is not None or e <= 1e-5 + (1e-4 + gate["share"]) * scale),
                       f"{what} {name}: error {e:.3e}, largest entry {scale:.3e}")
                _check(torch.equal(g, a), f"{what} {name}: two launches differ")
                err, share = max(err, e), max(share, e / scale)
                if base is not None:
                    moved_share = max(moved_share, ec.tier_moved_share(g, r, base[i][:n]))
            _check(not bool(got[1][:, N if rows is None else rows:].any()),
                   f"{what}: dx rows past update_rows are not zero")
            if gate.get("moved") is not None:
                _check(moved_share <= gate["moved"],
                       f"{what}: error norm {moved_share:.3f} of the tier's move, "
                       f"gate {gate['moved']}")
            base = got if base is None else base
            del again, ref
            ms = _cuda_ms(lambda: ec.block_fused(*ops, **kw, precision=tier), 3)
            bound_ms, bound_by = tier_bound(flops, bytes_, tier)
            bound_tc_ms, bound_tc_by = tier_bound(flops, bytes_, "tf32x3")
            kernels[f"block_fused[{tier}]:{shape}"] = dict(
                kernel="block_fused", tier=tier, variant=shape, width=F, batch=B,
                checked_batch=n, cluster_dim=cluster, max_abs_err=err, gate_share=share,
                moved_share=moved_share, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_tc_ms=bound_tc_ms, bound_tc_by=bound_tc_by,
                flops=flops, bf16_gate=bf16)
            print(f"  {what}: cluster of {cluster}, {ms:.3f} ms (plain {plain_ms:.1f} ms), "
                  f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%; 3xTF32 "
                  f"{bound_tc_ms:.4f} ms); error {share:.2e} of the largest entry"
                  + ("" if gate.get("moved") is None else
                     f", error norm {moved_share:.4f} of the tier's move "
                     f"(gate {gate['moved']:g})")
                  + ("" if bf16 is None else
                     f"; bf16 gate: against the float64 sums {bf16['norm']:.4f} of the move "
                     f"(the plain version {bf16['plain_norm']:.4f}), ratio {bf16['ratio']:.3f}"
                     f" (gate {ec.BLOCK_TIER_GATES['bf16']['k']:g})")
                  + ("" if n == B else f"; checked on the first {n} graphs"))
            del got
        del inp, ops, base, f32
        torch.cuda.empty_cache()
    print(f"  {label} (a) took {time.perf_counter() - t0:.1f} s")
    usage = ptxas_usage(logs, F)
    _check("block_fused" in usage, f"block_fused has no instantiation at F = {F}")
    N = 344
    smem = forward_dynamic_smem(ec, F, N)
    for u in usage["block_fused"]:
        print(f"  block_fused F={F} {u['function'][:60]}: {u['registers']} registers, spill "
              f"stores {u['spill_stores']} B, loads {u['spill_loads']} B; shared memory "
              f"{smem} B dynamic (N = {N}) + {u['static_smem']} B static")
    res = {"card": card, "kernels": kernels, "ptxas": usage["block_fused"],
           "smem_dynamic": smem}
    if witness:
        res["bf16_witness"] = bf16_order_witness(ec, torch, dev, flagship)
    res["padded"] = padded_kernel_phase(ec, torch, dev, flagship, padded,
                                        names=("block_fused",))
    for tier in PADDED_TIERS:
        dim = ec.last_cluster_dim("block_fused", tier)
        _check(dim == want_cluster, f"block_fused[{tier}] width {padded}: cluster {dim}")

    T = CLUSTER_JOINT["T"]
    ckpt = _random_checkpoint(torch, dict(flagship, mode="joint",
                                          tpu={"kernel_block_fuse": True},
                                          egnn_params=dict(flagship["egnn_params"],
                                                           hidden_nf=F, n_layers=layers)),
                              None, work / f"joint_fused_{F}")[0]
    passes = len(JointDDPM._repaint_plan(1, 1, T)[0]) + 1
    sdf = work / f"joint_fused_{F}.sdf"
    wall, sample_s, launches, by_tier, xh = _captured_generate(
        torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile", sdf,
                    "--n_samples", CLUSTER_JOINT["n"], "--num_nodes_lig", 24, "--all_frags",
                    "--timesteps", T, "--resamplings", 1, "--jump_length", 1], joint=True)
    want = {**dict.fromkeys(ec.KERNELS, 0), "block_fused": layers * passes}
    _check(launches == want, f"the hidden-{F} fused joint chain launched {launches}, "
                             f"not {want}")
    dim = ec.last_cluster_dim("block_fused")
    _check(dim == want_cluster, f"the hidden-{F} fused joint chain's clusters: {dim}")
    _check(bool(torch.isfinite(xh).all()), f"the hidden-{F} fused joint chain's samples")
    mols = _sdf_molecules(sdf)
    _check(0 < len(mols) <= CLUSTER_JOINT["n"],
           f"the hidden-{F} fused joint chain wrote {len(mols)}")
    res["joint"] = dict(CLUSTER_JOINT, layers=layers, launches=launches, sample_s=sample_s,
                        wall_s=wall, ms_per_pass=1e3 * sample_s / passes, molecules=len(mols))
    print(f"  {card}: hidden {F} joint chain, {layers} layers, {CLUSTER_JOINT['n']} x 24 "
          f"atoms, T={T}, block fusing on: {res['joint']['ms_per_pass']:.2f} ms a pass, "
          f"launches {launches}, {len(mols)} molecules")
    shutil.rmtree(work / f"joint_fused_{F}", ignore_errors=True)
    if F == QUAD_WIDTH:
        blk = kernel_inputs(torch, dev, dict(cfg, egnn_params=dict(
            cfg["egnn_params"], hidden_nf=REFUSED_QUAD)), 2, 24, with_delta=True)
        res["refusals"] = {f"block_fused_width_{REFUSED_QUAD}": refused_before_launch(
            ec, f"block_fused_width_{REFUSED_QUAD}", lambda: ec.block_fused(
                *block_operands(blk), cutoffs=blk["cut"], attention=True, tanh=True,
                coords_range=15.0, norm_constant=1.0, normalization_factor=100.0),
            ("block_fused", "above 4096", "ROADMAP", "widths above 4096"))}
        del blk
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    print(f"  phase {label} took {res['phase_s']:.1f} s")
    return res


QUAD_WIDTH = 4096  # the widest: a row tile on four blocks
QUAD_VARIANTS = ("full", "ligand_rows_cross", "ligand_rows_nocross")  # phase 3's shapes
QUAD_PADDED = 3072  # run on the F = 4096 kernels (ec.padded_width)
QUAD_CHAIN = dict(n=16, T=2)
QUAD_PLAIN_STEP = 1  # graphs a slice of the plain versions: 1.9 GB a (1, 344, 344, 4096) tensor
REFUSED_QUAD = 4160  # wider than every kernel
QUAD_BLOCK_SHAPES = ("joint_main_path",)  # 20o's: phase 3c's clean complex, B = 8
QUAD_TRAIN = dict(batch=4, steps=2)  # 20n's cli.train epoch
# graphs on which 20j-20n check the reduced tiers (their plain versions take
# seconds a tier at the full batch); the times stay the full batch's
REDUCED_CHECK_BATCH = 4


def quad_width_phase(torch, ec, dev, flagship, logs, work, pdb, ref_lig, card):
    """Phase 20m, hidden widths 2049-4096 on the forward split kernels at
    F = 4096 (a row tile on a cluster of four blocks; the samplers' two
    kernels; the backward ones at 4096 are 20n's, ``block_fused`` stays at
    2048).  (a)
    ``cluster_kernel_phase`` at F = 4096 on ``QUAD_VARIANTS`` (phase 3's
    shapes: ``gcl_agg`` on the full graph, ``coord_agg`` on ligand rows with
    the cross branch on and off) at every tier, the plain versions in batch
    slices of ``QUAD_PLAIN_STEP``; each launch on clusters of 4.  (b)
    ``padded_kernel_phase`` of the two kernels at ``QUAD_PADDED``.  (c) the
    main path: cli.generate_ligands at hidden 4096 from seeded random
    weights (``WIDE_LAYERS`` layers; 16 x 24 on phase 5's pocket,
    ``QUAD_CHAIN``'s T, ``chain_launches``, all at F = 4096 on clusters of
    four), finite samples and an SDF.  (d) refusals, each before any launch: width
    ``REFUSED_QUAD`` in the two forward wrappers."""
    t0 = time.perf_counter()
    res = {"card": card, "kernels": cluster_kernel_phase(
        ec, torch, dev, flagship, logs, width=QUAD_WIDTH, variants=QUAD_VARIANTS,
        step=QUAD_PLAIN_STEP, reps=2)}
    print(f"  20m (a) took {time.perf_counter() - t0:.1f} s")
    res["padded"] = padded_kernel_phase(ec, torch, dev, flagship, QUAD_PADDED,
                                        names=CLUSTER_KERNELS)
    for key, entry in res["padded"].items():
        _check(entry["cluster_dim"] == 4, f"width {QUAD_PADDED} {key}: cluster "
                                          f"{entry['cluster_dim']}, not 4")

    def model(width):
        return dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))

    chain = QUAD_CHAIN
    want = chain_launches(ec, WIDE_LAYERS, chain["T"])
    t1 = time.perf_counter()
    ckpt = _random_checkpoint(torch, wide_model(flagship, QUAD_WIDTH), None, work / "quad")[0]
    ckpt_s = time.perf_counter() - t1
    sdf = work / "quad.sdf"
    wall, sample_s, launches, by_tier, xh = _captured_generate(
        torch, ec, [ckpt, "--pdbfile", pdb, "--ref_ligand", ref_lig, "--outfile", sdf,
                    "--n_samples", chain["n"], "--num_nodes_lig", 24, "--all_frags",
                    "--timesteps", chain["T"]])
    _check(launches == want, f"the hidden-{QUAD_WIDTH} chain launched {launches}, not {want}")
    _check(by_tier == {f"{k}[{ec.DEFAULT_TIER}]": n for k, n in want.items() if n},
           f"the hidden-{QUAD_WIDTH} chain's libraries: {by_tier}")
    for name in CLUSTER_KERNELS:
        dim = ec.last_cluster_dim(name)
        _check(dim == 4, f"the hidden-{QUAD_WIDTH} chain's {name}: cluster {dim}, not 4")
    _check(bool(torch.isfinite(xh).all()), f"the hidden-{QUAD_WIDTH} chain's samples")
    mols = _sdf_molecules(sdf)
    _check(0 < len(mols) <= chain["n"], f"the hidden-{QUAD_WIDTH} chain wrote {len(mols)}")
    res["chain"] = dict(chain, layers=WIDE_LAYERS, launches=launches,
                        ms_per_pass=1e3 * sample_s / (chain["T"] + 1),
                        sample_s=sample_s, wall_s=wall, checkpoint_s=ckpt_s,
                        molecules=len(mols))
    print(f"  {card}: hidden {QUAD_WIDTH}, {WIDE_LAYERS} layers, {chain['n']} x 24 atoms, "
          f"T={chain['T']}: "
          f"{res['chain']['ms_per_pass']:.2f} ms a pass, CLI wall {wall:.2f} s (the random "
          f"checkpoint written in {ckpt_s:.1f} s), launches {launches}, {len(mols)} molecules")
    shutil.rmtree(work / "quad", ignore_errors=True)

    node = ("a_row", "a_col", "x", "x0", "mask", "is_lig")
    inp = kernel_inputs(torch, dev, model(REFUSED_QUAD), 2, 24)
    above = ("above 4096", "ROADMAP", "widths above 4096")
    res["refusals"] = {
        f"gcl_agg_width_{REFUSED_QUAD}": refused_before_launch(
            ec, f"gcl_agg_width_{REFUSED_QUAD}", lambda: ec.gcl_message_agg(
                *(inp[k] for k in node), *inp["gcl_w"].values(), cutoffs=inp["cut"],
                attention=True, normalization_factor=100.0), above),
        f"coord_agg_width_{REFUSED_QUAD}": refused_before_launch(
            ec, f"coord_agg_width_{REFUSED_QUAD}", lambda: ec.coord_update_agg(
                *(inp[k] for k in node), *inp["coord_w"], cutoffs=inp["cut"], tanh=True,
                coords_range=15.0, norm_constant=1.0, normalization_factor=100.0,
                update_rows=24, cross=inp["cross"], graph_mean=inp["graph_mean"]), above)}
    del inp
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    print(f"  phase 20m took {res['phase_s']:.1f} s")
    return res


def refused_before_launch(ec, key, call, names):
    """``call()`` raises a ValueError whose message names each of ``names``,
    and launches no kernel.  Returns the message."""
    ec.reset_launch_counts()
    try:
        call()
        msg = ""
    except ValueError as err:
        msg = str(err)
    _check(all(n in msg for n in names), f"{key} did not raise naming {names}: {msg!r}")
    _check(not any(ec.launch_counts.values()), f"{key} launched {ec.launch_counts}")
    print(f"  {key}: raises before any launch: '{msg[:110]}'")
    return msg


def quad_train_phase(torch, ec, dev, flagship, work, card):
    """Phase 20n (c), the training main path at hidden 4096: cli.train from
    the config phase 8 writes (``flagship_train_config``) at hidden
    ``QUAD_WIDTH``, ``WIDE_LAYERS`` layers and batch ``QUAD_TRAIN["batch"]``,
    on a seeded synthetic dataset of ``QUAD_TRAIN["steps"]`` batches and one
    validation batch: one epoch, its validation pass, its checkpoints.  Each
    step launches one of each split kernel a layer, each on clusters of four
    (F = 4096), with a finite loss and gradient norm; validation only the
    two forward kernels; the checkpoints are written (then removed: 12.9 GB
    with the optimizer's moments)."""
    from diffsbdd_tpu_torch.cli import train as train_cli
    from diffsbdd_tpu_torch.train import loop
    batch, steps = QUAD_TRAIN["batch"], QUAD_TRAIN["steps"]
    data = work / "data20n"
    write_synthetic_dataset(data, batch * steps, batch, seed=26,
                            pocket_sizes=(250, 280, 310, 320))
    run_name = f"chip_smoke_train_{QUAD_WIDTH}"
    cfg = flagship_train_config(flagship, data, work / "runs20n", run_name=run_name)
    cfg.update(batch_size=batch, egnn_params=dict(cfg["egnn_params"], hidden_nf=QUAD_WIDTH,
                                                  n_layers=WIDE_LAYERS))
    cfg_path = work / f"train_config_{QUAD_WIDTH}.json"
    cfg_path.write_text(json.dumps(cfg))
    split = [k for k in ec.KERNELS if k != "block_fused"]
    records = []
    trainer_log = loop.Trainer.log

    def log(self, metrics, split_name, step):
        torch.cuda.synchronize()
        records.append(dict(split=split_name, step=step, t=time.perf_counter(),
                            launches=dict(ec.launch_counts),
                            clusters={k: ec.last_cluster_dim(k) for k in split},
                            **{k: float(v) for k, v in metrics.items()}))

    loop.Trainer.log = log
    try:
        ec.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_cli.main(["--config", str(cfg_path)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        loop.Trainer.log = trainer_log
    launches = dict(ec.launch_counts)
    train = [r for r in records if r["split"] == "train"]
    val = [r for r in records if r["split"] == "val"]
    _check(len(train) == steps and len(val) == 1,
           f"hidden {QUAD_WIDTH}: {len(train)} train and {len(val)} val records")
    n_layers = WIDE_LAYERS
    want_step = {k: 0 if k == "block_fused" else n_layers for k in ec.KERNELS}
    prev = dict.fromkeys(ec.KERNELS, 0)
    for r in train:
        per_step = {k: r["launches"][k] - prev[k] for k in ec.KERNELS}
        _check(per_step == want_step, f"hidden {QUAD_WIDTH} step {r['step']}: launches "
                                      f"{per_step}, expected {want_step}")
        _check(set(r["clusters"].values()) == {4},
               f"hidden {QUAD_WIDTH} step {r['step']}: clusters {r['clusters']}, not 4")
        _check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
               f"hidden {QUAD_WIDTH} step {r['step']}: loss {r['loss']}, "
               f"grad_norm {r['grad_norm']}")
        prev = r["launches"]
    in_val = {k: val[0]["launches"][k] - prev[k] for k in ec.KERNELS}
    want_val = {**dict.fromkeys(ec.KERNELS, 0), "gcl_agg": 2 * n_layers, "coord_agg": 2 * n_layers}
    _check(in_val == want_val, f"hidden {QUAD_WIDTH} validation launches {in_val}, "
                               f"expected {want_val}")
    _check(np.isfinite(val[0]["loss"]), f"hidden {QUAD_WIDTH} validation loss {val[0]['loss']}")
    ckpt = work / "runs20n" / run_name / "checkpoints"
    written = {f.name: f.stat().st_size for f in ckpt.iterdir()}
    for name in ("last.pt", "last.train.pt", "last.config.json", "best.pt"):
        _check(written.get(name, 0) > 0, f"hidden {QUAD_WIDTH}: no {name} written")
    shutil.rmtree(work / "runs20n", ignore_errors=True)
    step_ms = 1e3 * (train[1]["t"] - train[0]["t"])
    res = dict(batch=batch, steps=steps, layers=n_layers, launches=launches, per_step=want_step,
               validation=in_val, losses=[r["loss"] for r in train], val_loss=val[0]["loss"],
               grad_norms=[r["grad_norm"] for r in train], step_ms=step_ms, cli_wall_s=wall,
               checkpoint_gb=sum(written.values()) / 1e9)
    print(f"  {card}: cli.train at hidden {QUAD_WIDTH}, {n_layers} layers, batch {batch}: "
          f"{steps} steps "
          f"(launches a step {want_step}, clusters of 4), loss "
          + " ".join(f"{r['loss']:.4f}" for r in train)
          + f", gradient norm " + " ".join(f"{r['grad_norm']:.4f}" for r in train)
          + f", val {val[0]['loss']:.4f}; the second step {step_ms:.1f} ms; CLI wall "
          f"{wall:.1f} s ({res['checkpoint_gb']:.1f} GB of checkpoints)")
    return res


def quad_bwd_phase(torch, ec, dev, flagship, logs, work, card):
    """Phase 20n, training at hidden widths 2049-4096 on the backward kernels
    at F = 4096 (a row tile on a cluster of four blocks).  (a)
    ``tier_kernel_phase`` of gcl_agg_bwd and coord_agg_bwd at F = 4096 at
    every tier on phase 3b's main shapes (the plain versions in batch
    slices of 1): the tier gates, two launches bit for bit, each tier's
    cluster dimension, ms, plain ms, bound; registers, spills and shared
    memory.  (b) ``padded_kernel_phase`` of the two at ``QUAD_PADDED``.  (c)
    ``quad_train_phase``: cli.train at hidden 4096.  (d)
    ``cluster_train_step`` at hidden ``QUAD_PADDED`` (padded onto 4096),
    batch ``QUAD_TRAIN["batch"]``.  (c) and (d) at ``WIDE_LAYERS`` layers.
    (e) refusals, each before any launch: width ``REFUSED_QUAD`` in the two
    backward wrappers."""
    from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset, PaddedLoader
    from diffsbdd_tpu_torch.train import loop
    t0 = time.perf_counter()
    F = QUAD_WIDTH
    kernels = tier_kernel_phase(ec, torch, dev, flagship, F, names=CLUSTER_BWD_KERNELS)
    for name in CLUSTER_BWD_KERNELS:
        for tier in ec.TIERS:
            dim = kernels[f"{name}[{tier}]"]["cluster_dim"] = ec.last_cluster_dim(name, tier)
            _check(dim == 4, f"{name}[{tier}] F={F}: cluster dimension {dim}, not 4")
    usage = ptxas_usage(logs, F)
    smem = 4 * (16 * 2048 + 2 * 8 * (1024 + 8)) + 4 * 352  # OWN, STG, B, the columns (N = 352)
    for name in CLUSTER_BWD_KERNELS:
        _check(name in usage, f"{name} has no instantiation at F = {F}")
        for u in usage[name]:
            print(f"  {name} F={F} {u['function'][:60]}: {u['registers']} registers, spill "
                  f"stores {u['spill_stores']} B, loads {u['spill_loads']} B; shared memory "
                  f"{smem} B dynamic (N = 352) + {u['static_smem']} B static")
        for tier in ec.TIERS:
            kernels[f"{name}[{tier}]"]["ptxas"] = usage[name]
    res = {"card": card, "kernels": kernels, "smem_dynamic": smem}
    print(f"  20n (a) took {time.perf_counter() - t0:.1f} s")
    res["padded"] = padded_kernel_phase(ec, torch, dev, flagship, QUAD_PADDED,
                                        names=CLUSTER_BWD_KERNELS)
    for key, entry in res["padded"].items():
        _check(entry["cluster_dim"] == 4, f"width {QUAD_PADDED} {key}: cluster "
                                          f"{entry['cluster_dim']}, not 4")
    res["training"] = quad_train_phase(torch, ec, dev, flagship, work, card)
    data = work / "data20n_step"
    write_synthetic_dataset(data, QUAD_TRAIN["batch"], 1, seed=27,
                            pocket_sizes=(250, 280, 310, 320), n_types=11)
    batch = next(iter(PaddedLoader(LigandPocketDataset(data / "train.npz"),
                                   QUAD_TRAIN["batch"], shuffle=False)))
    r = res["train_step"] = cluster_train_step(
        torch, ec, dev, flagship, QUAD_PADDED, loop.batch_to_device(batch["ligand"], dev),
        loop.batch_to_device(batch["pocket"], dev), np.load(data / "size_distribution.npy"))
    print(f"  {card}: hidden {QUAD_PADDED} (kernels at {r['run_at']}), {r['layers']} layers, "
          f"train step at batch {r['batch']}: {r['ms_per_step']:.1f} ms, peak "
          f"{r['peak_gib']:.2f} GiB, loss "
          f"{r['loss']:.4f}, gradient norm {r['grad_norm']:.4f}, launches {r['launches']}, "
          f"clusters {r['cluster_dims']}")

    def model(width):
        return dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))

    node = ("a_row", "a_col", "x", "x0", "mask", "is_lig")
    inp = kernel_inputs(torch, dev, model(REFUSED_QUAD), 2, 24, with_delta=True)
    w, (w_d2, w_d20, _, w2, b2, w3) = inp["gcl_w"], inp["coord_w"]
    cross = {k: v for k, v in inp["cross"].items() if k != "type_bias"}
    cross["delta"] = inp["cross_delta"]
    above = ("above 4096", "ROADMAP", "widths above 4096")
    res["refusals"] = {
        f"gcl_agg_bwd_width_{REFUSED_QUAD}": refused_before_launch(
            ec, f"gcl_agg_bwd_width_{REFUSED_QUAD}", lambda: ec.gcl_agg_bwd(
                inp["r"](2, inp["N"], REFUSED_QUAD), *(inp[k] for k in node), w["w_d2"],
                w["w_d20"], inp["gcl_delta"], w["w2"], w["b2"], w["w_att"], w["b_att"],
                cutoffs=inp["cut"], attention=True, normalization_factor=100.0),
            ("gcl_agg_bwd",) + above),
        f"coord_agg_bwd_width_{REFUSED_QUAD}": refused_before_launch(
            ec, f"coord_agg_bwd_width_{REFUSED_QUAD}", lambda: ec.coord_agg_bwd(
                inp["r"](2, inp["N"], 3), *(inp[k] for k in node), w_d2, w_d20,
                inp["coord_delta"], w2, b2, w3, cutoffs=inp["cut"], tanh=True,
                coords_range=15.0, norm_constant=1.0, normalization_factor=100.0,
                cross=cross, graph_mean=inp["graph_mean"], update_rows=24),
            ("coord_agg_bwd",) + above)}
    del inp
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    print(f"  phase 20n took {res['phase_s']:.1f} s")
    return res


def start_measurement_builds(ec):
    """Starts nvcc on each of ``MEASUREMENT_BUILDS`` (3xTF32).  Returns
    {build: (the process, the kernel, the library's path)}."""
    builds = {}
    ec.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for key, (name, define, lib) in MEASUREMENT_BUILDS.items():
        path = ec.BUILD_DIR / lib
        builds[key] = (subprocess.Popen(
            [ec._nvcc(), *ec.NVCC_FLAGS, define, "-o", str(path), str(ec.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), name, path)
    return builds


def _measurement_library(ec, build):
    """The library of one of ``start_measurement_builds``' builds, loaded
    with its kernel's C signature: (kernel, the ``ec._libs`` key of its
    3xTF32 library, the loaded variant)."""
    import ctypes
    proc, name, path = build
    log, _ = proc.communicate()
    _check(proc.returncode == 0, f"the measurement build of {path.name} failed:\n{log}")
    variant = ctypes.CDLL(str(path))
    fn_name, argtypes = ec._ARGTYPES[name]
    fn = getattr(variant, fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return name, (name, ec.DEFAULT_TIER), variant


def _with_library(ec, key, variant, fn):
    """fn() with the wrappers' 3xTF32 library ``key`` swapped for ``variant``."""
    library = ec._lib(*key)
    ec._libs[key] = variant
    try:
        return fn()
    finally:
        ec._libs[key] = library


def dw2_share_phase(ec, torch, dev, flagship, build, widths):
    """Phase 20i, the dW2 step's share of ``gcl_agg_bwd`` (3xTF32) at each of
    ``widths`` on phase 3b's main shapes (B = 16, N = 32 + 320): the
    kernel's CUDA-event time, and the timing build's (``build``, the
    skip_dw2 of ``start_measurement_builds``) launched through the same
    wrapper; the difference is the step's time."""
    _, key, variant = _measurement_library(ec, build)
    node = ("a_row", "a_col", "x", "x0", "mask", "is_lig")
    res = {}
    for width in widths:
        cfg = dict(flagship, egnn_params=dict(flagship["egnn_params"], hidden_nf=width))
        sizes = np.random.default_rng(0).integers(24, 33, 16)
        bwd = kernel_inputs(torch, dev, cfg, 16, 32, lig_sizes=sizes, seed=1)
        g, w = bwd["r"](16, bwd["N"], width), bwd["gcl_w"]

        def call():
            return ec.gcl_agg_bwd(g, *(bwd[k] for k in node), w["w_d2"], w["w_d20"],
                                  bwd["gcl_delta"], w["w2"], w["b2"], w["w_att"], w["b_att"],
                                  cutoffs=bwd["cut"], attention=True,
                                  normalization_factor=100.0)

        ms = _cuda_ms(call, 5)
        skip_ms = _with_library(ec, key, variant, lambda: _cuda_ms(call, 5))
        res[width] = dict(ms=ms, without_dw2_ms=skip_ms, dw2_ms=ms - skip_ms,
                          dw2_share=(ms - skip_ms) / ms)
        print(f"  gcl_agg_bwd[tf32x3] F={width}: {ms:.4f} ms, {skip_ms:.4f} ms without the "
              f"dW2 step: the step {ms - skip_ms:.4f} ms, {100 * (ms - skip_ms) / ms:.1f}%")
        del bwd, g
    return res


def error_growth_phase(ec, torch, dev, flagship, build, shares):
    """Phase 20i, how the 3xTF32 error grows with K: the five kernels'
    ``float64_shares`` at F = 256, beside ``shares`` ({width: float64_shares}
    of 20h and 20i), and gcl_agg's at F = 1024 from the build without the
    step sums (``build``, the no_step_sums of ``start_measurement_builds``):
    mma.sync accumulates each k-step's three passes into the accumulators,
    and that build shows what it does at K = 1024."""
    name, key, variant = _measurement_library(ec, build)
    shares = {**shares, 256: float64_shares(ec, torch, dev, flagship, 256)}
    unsummed = _with_library(ec, key, variant, lambda: float64_shares(
        ec, torch, dev, flagship, WIDEST, names=(name,)))[name]
    for kernel in ec.KERNELS:
        print(f"  {kernel}[tf32x3] against float64, the kernel's error over the largest "
              f"entry (the float32 plain version's): "
              + ", ".join(f"F={w} {shares[w][kernel][0]:.2e} ({shares[w][kernel][1]:.2e})"
                          for w in sorted(shares))
              + (f"; F={WIDEST} without the step sums {unsummed[0]:.2e}" if kernel == name
                 else ""))
    return {"shares": shares, f"{name}_{WIDEST}_without_step_sums": unsummed}


def phase20(torch, ec, dev, flagship, logs, work, pdb, ref_lig, base, card, joint_ckpt,
            builds):
    """Phase 20 in order; ``logs``: phase 2's compiler output; ``base``:
    phase 6's float32 run (its samples, ms_per_pass and molecules_per_s);
    ``joint_ckpt``: phase 10's joint checkpoint; ``builds``:
    ``start_measurement_builds``'."""
    t20 = time.perf_counter()
    res = {"kernels": {}, "block_shapes": {}}
    for width in TIER_WIDTHS:
        print(f"[20a] the kernels at each tier, F={width} ({card})")
        res["kernels"][width] = tier_kernel_phase(ec, torch, dev, flagship, width)
        shapes = list(TIER_BLOCK_SHAPES) if width == 256 else ["joint_main_path"]
        blocks = res["block_shapes"][width] = tier_block_phase(
            ec, torch, dev, flagship, width, shapes)
        # the kernels line: the joint main path's launch
        res["kernels"][width].update({f"block_fused[{tier}]": entry for tier, entry
                                      in blocks["joint_main_path"].items()})
    print("[20b] the main path at bfloat16 and at float32_x2")
    res["sampling"] = tier_sampling_phase(torch, ec, dev, work, pdb, ref_lig, base, card)
    print("[20c] the train step with kernel_bwd_precision bfloat16, and at float32_x2")
    res["training"] = tier_training_phase(torch, ec, dev, work, card)
    print("[20d] the dense sin/mean model at compute_dtype bfloat16")
    res["dense"] = dense_bf16_phase(torch, ec, dev, flagship, work, pdb, ref_lig, card)
    print("[20e] hidden widths 96 and 192 zero-padded, the root's load_model, refusals")
    res["widths"] = padded_width_phase(torch, ec, dev, flagship, work, pdb, ref_lig, card)
    print("[20f] the joint chain with block fusing at bfloat16 and at float32_x2")
    res["joint"] = tier_joint_phase(torch, ec, dev, work, pdb, ref_lig, card, joint_ckpt)
    print("[20g] egnn_impl xla and kernel_bwd xla")
    res["impl"] = impl_phase(torch, ec, dev, flagship, work, pdb, ref_lig, card)
    print(f"[20h] hidden widths 257-512 on the F = {WIDE} kernels ({card})")
    res["wide"] = wide_width_phase(torch, ec, dev, flagship, logs, work, pdb, ref_lig, card)
    print(f"[20i] hidden widths 513-1024 on the F = {WIDEST} kernels ({card})")
    res["widest"] = wide_width_phase(torch, ec, dev, flagship, logs, work, pdb, ref_lig, card,
                                     width=WIDEST, padded=WIDEST_PADDED, chain=WIDEST_CHAIN,
                                     label="20i")
    res["widest"]["dw2"] = dw2_share_phase(ec, torch, dev, flagship, builds["skip_dw2"],
                                           (WIDE, WIDEST, CLUSTER_WIDTH))
    res["widest"]["error_growth"] = error_growth_phase(
        ec, torch, dev, flagship, builds["no_step_sums"],
        {WIDE: res["wide"]["float64_shares"], WIDEST: res["widest"]["float64_shares"]})
    print(f"[20j] hidden widths 1025-2048 on the F = {CLUSTER_WIDTH} forward kernels, "
          f"clusters of two blocks ({card})")
    res["cluster"] = cluster_width_phase(torch, ec, dev, flagship, logs, work, pdb, ref_lig,
                                         card)
    print(f"[20k] training at hidden widths 1025-2048 on the F = {CLUSTER_WIDTH} backward "
          f"kernels, clusters of two blocks ({card})")
    res["cluster_bwd"] = cluster_bwd_phase(torch, ec, dev, flagship, logs, work, card,
                                           res["widest"]["dw2"][CLUSTER_WIDTH])
    print(f"[20l] the whole-block kernel at F = {CLUSTER_WIDTH}, clusters of two blocks; "
          f"the hidden-{CLUSTER_WIDTH} joint chain with block fusing on ({card})")
    res["cluster_block"] = cluster_block_phase(torch, ec, dev, flagship, logs, work, pdb,
                                               ref_lig, card)
    print(f"[20m] hidden widths 2049-4096 on the F = {QUAD_WIDTH} forward kernels, clusters "
          f"of four blocks ({card})")
    res["quad"] = quad_width_phase(torch, ec, dev, flagship, logs, work, pdb, ref_lig, card)
    print(f"[20n] training at hidden widths 2049-4096 on the F = {QUAD_WIDTH} backward "
          f"kernels, clusters of four blocks ({card})")
    res["quad_bwd"] = quad_bwd_phase(torch, ec, dev, flagship, logs, work, card)
    print(f"[20o] the whole-block kernel at F = {QUAD_WIDTH}, clusters of four blocks; the "
          f"hidden-{QUAD_WIDTH} joint chain with block fusing on ({card})")
    res["quad_block"] = cluster_block_phase(
        torch, ec, dev, flagship, logs, work, pdb, ref_lig, card, width=QUAD_WIDTH,
        shapes=QUAD_BLOCK_SHAPES, step=QUAD_PLAIN_STEP, padded=QUAD_PADDED,
        layers=WIDE_LAYERS, witness=False, label="20o")
    res["phase_s"] = time.perf_counter() - t20
    print(f"  phase 20 took {res['phase_s']:.1f} s")
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=REPO / "chip_smoke_out",
                        help="directory for the pocket, samples and summary")
    out = parser.parse_args(argv).out
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
    # phase 20i's measurement builds, compiled beside the libraries so that
    # no host-bound phase shares the cores with them
    builds = start_measurement_builds(ec)
    try:
        logs = ec.build_kernels(force=True, tiers=tuple(ec.TIERS))
        build_s = time.perf_counter() - t0
        print(f"  built {', '.join(logs)} in {build_s:.1f} s")
        return _phases(torch, ec, dev, out, card, logs, build_s, builds, t_start)
    finally:
        for proc, _, _ in builds.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _phases(torch, ec, dev, out, card, logs, build_s, builds, t_start) -> int:
    """Phases 2 (after the build) to 20, the summary and the last lines."""
    from diffsbdd_tpu_torch.cli import generate_ligands as cli
    from diffsbdd_tpu_torch.checkpoint import import_jax_npz, load_model
    from diffsbdd_tpu_torch.config import snapshot_config
    from diffsbdd_tpu_torch.diffusion.ddpm import ConditionalDDPM
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # the kernels' products run on the tensor cores (HMMA) through cp.async
    # stages (LDGSTS), the whole-block kernel's in both phases
    for name, function in (("gcl_agg", None), ("coord_agg", None), ("gcl_agg_bwd", None),
                           ("coord_agg_bwd", None), ("block_fused", "block_phase_a"),
                           ("block_fused", "block_phase_b")):
        sass = sass_counts(ec, name, ("HMMA", "LDGSTS"), function)
        what = name if function is None else f"{name} {function}"
        print(f"  {what} SASS: {sass['HMMA']} HMMA, {sass['LDGSTS']} LDGSTS instructions")
        _check(sass["HMMA"] > 0 and sass["LDGSTS"] > 0,
               f"{what} has no tensor-core or cp.async instructions")
    # every recorded function of the five 3xTF32 libraries (the kernels at
    # F = 64 to 4096) builds to the recorded SASS, instruction for
    # instruction (same nvcc); a function not yet recorded is printed
    release = nvcc_release(ec)
    for name in ec.KERNELS:
        if release != PARENT_SASS["nvcc"]:
            print(f"  {name} 3xTF32 SASS not compared: nvcc {release}, recorded with "
                  f"{PARENT_SASS['nvcc']}")
            continue
        got = sass_functions(ec, name)
        want = PARENT_SASS["functions"][name]
        differ = sorted(fn for fn, digest in want.items() if got.get(fn) != digest)
        _check(not differ, f"{name} 3xTF32 SASS differs from the recorded in {differ}")
        print(f"  {name} 3xTF32 SASS: {len(want)} recorded functions identical, "
              f"{len(got) - len(want)} new ({release})")
        for fn in sorted(set(got) - set(want)):  # for the next record
            print(f"  {name} new SASS function {fn}: {got[fn]}")
    # each tier's library runs its products as that tier's tensor-core
    # instructions only: TF32 HMMA for 3xTF32 and 2xTF32, bf16 HMMA for bf16
    # (m16n8k16, and m16n8k8 at F = 1024's stages of 8 rows); every HMMA is
    # one of those three kinds
    hmma = ("HMMA.1688.F32.TF32", "HMMA.16816.F32.BF16", "HMMA.1688.F32.BF16")
    tier_sass = {}
    for name in ec.KERNELS:
        for tier in ec.TIERS:
            sass = tier_sass[f"{name}[{tier}]"] = sass_counts(
                ec, name, ("HMMA", *hmma, "LDGSTS"), tier=tier)
            tf32, k16, k8 = (sass[op] for op in hmma)
            print(f"  {name}[{tier}] SASS: {tf32} TF32 HMMA, {k16} + {k8} bf16 HMMA "
                  f"(m16n8k16 + m16n8k8), {sass['LDGSTS']} LDGSTS")
            _check(sass["HMMA"] == tf32 + k16 + k8,
                   f"{name}[{tier}] runs HMMA of another kind than the tiers'")
            _check(sass["LDGSTS"] > 0 and (k16 + k8 > 0 and tf32 == 0 if tier == "bf16"
                                           else tf32 > 0 and k16 + k8 == 0),
                   f"{name}[{tier}] runs other tensor-core instructions than its tier's")
        # as many products as the tier's passes: 2xTF32 two of 3xTF32's three
        # m16n8k8 passes, exactly 2/3 of its HMMA; bf16 one m16n8k16 (twice
        # the k) where 3xTF32 runs two k-steps of three, or one m16n8k8
        # where it runs three: k16 + k8 / 2 is 1/6 of its HMMA in the forward
        # kernels; in the backward kernels more than 1/6 and less than 1/3,
        # as their dW2 loop (not unrolled) holds one k-step in either tier
        # (measured 126 of 714 and 252 of 1428 before F = 1024)
        full = tier_sass[f"{name}[tf32x3]"]["HMMA.1688.F32.TF32"]
        k16, k8 = (tier_sass[f"{name}[bf16]"][op] for op in hmma[1:])
        bf16 = k16 + k8 / 2
        _check(3 * tier_sass[f"{name}[tf32x2]"]["HMMA.1688.F32.TF32"] == 2 * full,
               f"{name}: the 2xTF32 HMMA count is not 2/3 of 3xTF32's {full}")
        _check(6 * bf16 == full if name in FORWARD_KERNELS else full < 6 * bf16 < 2 * full,
               f"{name}: {bf16} bf16 HMMA against 3xTF32's {full}")

    print("[3] kernels vs plain twins at the flagship shapes")
    flagship = snapshot_config(R05C_NPZ)
    kres, variant_ms = kernel_phase(ec, torch, dev, flagship)

    print("[3b] backward kernels vs plain versions at the flagship training shapes")
    bres, bwd_variant_ms = bwd_kernel_phase(ec, torch, dev, flagship)
    kres.update(bres)
    variant_ms.update(bwd_variant_ms)

    print("[3c] whole-block kernel vs its plain version and the split pair")
    block_res, block_variant_ms = block_kernel_phase(ec, torch, dev, flagship,
                                                     JOINT_SAMPLES)
    variant_ms.update(block_variant_ms)
    # the kernels line carries the joint path's shapes and batch (every row
    # moves: the path that launches it most) on the clean complex, the
    # collapsed one's times and bounds beside it, and the split pair's time
    # (the yardstick the kernel must beat); the other shapes stay in the
    # summary
    kres["block_fused"] = block_entry(block_res)

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
            timing["xh"] = result[0].cpu()  # phase 20b's float32 reference
            return result

        ConditionalDDPM.sample_given_pocket = timed_sample
        ec.reset_launch_counts()
        t0 = time.perf_counter()
        cli.main([str(ckpt), "--pdbfile", str(pdb), "--ref_ligand", ref_lig,
                  "--outfile", str(sdf), "--n_samples", str(n_samples),
                  "--num_nodes_lig", "24", "--all_frags",
                  "--timesteps", str(T)])
        wall = time.perf_counter() - t0
        sampling_launches = dict(ec.launch_counts)
        ConditionalDDPM.sample_given_pocket = sample
        expected = {"gcl_agg": 8 * T + 6, "coord_agg": 6 * T + 6,
                    "gcl_agg_bwd": 0, "coord_agg_bwd": 0, "block_fused": 0}
        print(f"  launches {sampling_launches}, expected {expected}")
        _check(sampling_launches == expected,
               "launch counts differ from the main path's")
        _check_molecules(sdf, n_samples, 24)
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

        print("[10] joint main path: cli.train (mode joint), then "
              "cli.generate_ligands with block fusing on")
        joint = joint_phase(torch, ec, dev, flagship, out, work, pdb, ref_lig,
                            JOINT_SAMPLES)

        print("[11] conditional inpainting: cli.inpaint with block fusing on")
        inpainting = inpaint_phase(torch, ec, dev, flagship, out, work, pdb, ref_lig)

        from diffsbdd_tpu_torch.constants import dataset_params
        ligand_sdf = first_molecule_sdf(
            sdf, out / "ligand.sdf", dataset_params[flagship["dataset"]]["atom_encoder"])
        print("[12] test-set workflow: cli.test_set")
        test_set = test_set_phase(torch, ec, flagship, ckpt, work, ligand_sdf)

        print("[13] molecule optimization: cli.optimize")
        optimize = optimize_phase(torch, ec, flagship, ckpt, out, pdb, ligand_sdf)

        print("[14] serving: SamplingServer's JSON-lines loop")
        serving = serving_phase(torch, ec, flagship, ckpt, pdb, ref_lig)

        print("[quality] analyze_samples on phase 6's molecules")
        quality = quality_readout(dev, ckpt, sdf)

        print("[15] Lightning import: a reference-format .ckpt of the r05c weights")
        lightning = lightning_phase(
            torch, ec, dev, flagship, ckpt, work, out, pdb, ref_lig,
            np.load(Path(training["datadir"]) / "size_distribution.npy"))

        print("[16] evaluation during training: SamplingEvaluator on the card")
        evaluation = evaluation_phase(torch, ec, dev, flagship, work, out, training, joint)

        print("[17] processing: proc_crossdock on a raw CrossDocked layout (host)")
        processing = processing_phase(work, ligand_sdf)

        print("[18a] coordinate kernels on the column blocks of a two-rank edge split")
        t18 = time.perf_counter()
        parallel = {"column_blocks": column_mask_phase(ec, torch, dev, flagship,
                                                       variant_ms)}
        print("[18b] two gloo ranks sharing the card against one process")
        parallel["ranks"] = parallel_phase(torch, ec, dev, flagship, work, pdb, ref_lig)
        print("[18c] cli.train under a one-rank torchrun environment (NCCL)")
        parallel["nccl"] = nccl_phase(torch, flagship, work, training)
        parallel["phase_s"] = time.perf_counter() - t18
        print(f"  phase 18 took {parallel['phase_s']:.1f} s")

        width = phase19(torch, ec, dev, flagship, logs, work, out, pdb, ref_lig, ckpt, card)

        tiers = phase20(torch, ec, dev, flagship, logs, work, pdb, ref_lig,
                        dict(xh=timing["xh"], ms_per_pass=step_ms,
                             molecules_per_s=n_samples / wall), card,
                        joint["training"]["ckpt"], builds)

    by_path = {"sampling": sampling_launches, "training": training["launches"],
               "joint_training": joint["training"]["launches"],
               "joint_sampling": joint["launches"], "inpainting": inpainting["launches"],
               "test_set": test_set["launches"], "optimize": optimize["launches"],
               "serving": serving["launches"], "lightning_import": lightning["launches"],
               "evaluation": evaluation["launches"]}
    # a kernel's launches: those of the main path that runs it most
    launches = {k: max(path[k] for path in by_path.values()) for k in ec.KERNELS}
    for k in ec.KERNELS:
        _check(launches[k] > 0, f"no main path launched {k}")
    summary = {"card": card, "launches": launches, "launches_by_path": by_path,
               "kernels": kres, "block_fused": block_res,
               "sampling_launches": sampling_launches, "training": training,
               "joint": joint, "inpainting": inpainting, "test_set": test_set,
               "optimize": optimize, "serving": serving, "quality": quality,
               "lightning": lightning, "evaluation": evaluation, "processing": processing,
               "parallel": parallel, "phase19": width, "phase20": tiers,
               "build_s": build_s, "tier_sass": tier_sass,
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
                                 "diffsbdd_tpu/ops/egnn_pallas_bwd.py:908"),
               "block_fused": ("diffsbdd_tpu_torch/csrc/block_fused.cu",
                               "diffsbdd_tpu/ops/egnn_block_fused.py:295")}
    # the same five kernels at hidden width 128, their launches from phase
    # 19b's default-width paths
    by_path128 = {"default_width_sampling": width["default"]["sampling"]["launches"],
                  "default_width_training": width["default"]["training"]["launches"],
                  "default_width_fused_sampling":
                      width["default"]["sampling_fused"]["launches"]}
    for k in ec.KERNELS:
        _check(width["default"]["launches"][k] > 0, f"no F = 128 path launched {k}")
    # the five kernels at the reduced tiers, F = 256: their launches on phase
    # 20b's main paths (forward), 20c's train steps (backward) and 20f's
    # joint chains (the whole-block kernel)
    by_tier_path = {f"sampling_{n}": tiers["sampling"][n]["launches_by_tier"]
                    for n in TIER_NAME.values()}
    by_tier_path.update({f"training_{n}": r["launches_by_tier"]
                         for n, r in tiers["training"].items()})
    by_tier_path.update({f"joint_{n}": r["launches_by_tier"]
                         for n, r in tiers["joint"].items()})
    tier_entries = []
    for tier in TIER_NAME:
        for name in ec.KERNELS:
            key = f"{name}[{tier}]"
            counts = {path: c.get(key, 0) for path, c in by_tier_path.items()}
            _check(max(counts.values()) > 0, f"no main path launched {key}")
            tier_entries.append(
                {"name": key, "route": "cuda", "source": sources[name][0],
                 "replaces": sources[name][1], "launches": max(counts.values()),
                 "launches_by_path": counts, **tiers["kernels"][256][key],
                 "library_ms": None})
    # the five kernels at F = 512 and 1024 (3xTF32), their launches on
    # phases 20h's and 20i's paths at those widths (the reduced tiers'
    # figures are in summary.json)
    wide_entries = []
    for built, padded, res in ((WIDE, WIDE_PADDED[0], tiers["wide"]),
                               (WIDEST, WIDEST_PADDED[0], tiers["widest"])):
        by_wide_path = {"wide_sampling": res["chain"][built]["launches"],
                        "wide_training_step": res["train_step"]["launches"],
                        "wide_joint_sampling": res["joint"]["launches"],
                        f"wide_padded_{padded}_sampling": res["chain"][padded]["launches"]}
        for name in ec.KERNELS:
            counts = {path: c[name] for path, c in by_wide_path.items()}
            _check(max(counts.values()) > 0, f"no hidden-{built} path launched {name}")
            entry = {k: v for k, v in res["kernels"][f"{name}[tf32x3]"].items()
                     if k != "ptxas"}
            wide_entries.append(
                {"name": f"{name}[F={built}]", "route": "cuda", "source": sources[name][0],
                 "replaces": sources[name][1], "launches": max(counts.values()),
                 "launches_by_path": counts, **entry, "library_ms": None})
    # gcl_agg and coord_agg at F = 2048 (3xTF32, a row tile on a cluster of
    # two blocks), their launches on phase 20j's paths at hidden 1025-2048 and
    # on 20k's train steps
    cl = tiers["cluster"]
    cb = tiers["cluster_bwd"]
    by_cluster_path = {
        "cluster_sampling": cl["chain"][CLUSTER_WIDTH]["launches"],
        f"cluster_padded_{CLUSTER_PADDED[-1]}_sampling": cl["chain"][CLUSTER_PADDED[-1]]["launches"],
        "cluster_joint_sampling_unfused": cl["joint"]["launches"],
        **{f"cluster_train_step_{h}": r["launches"] for h, r in cb["train_step"].items()}}
    cluster_entries = []
    for name, main_variant in (("gcl_agg", "full"), ("coord_agg", "ligand_rows_cross")):
        counts = {path: c[name] for path, c in by_cluster_path.items()}
        _check(max(counts.values()) > 0, f"no hidden-{CLUSTER_WIDTH} path launched {name}")
        runs = [e for e in cl["kernels"]["variants"].values()
                if e["kernel"] == name and e["tier"] == ec.DEFAULT_TIER]
        entry = cl["kernels"]["variants"][f"{name}[{ec.DEFAULT_TIER}]:{main_variant}"]
        cluster_entries.append(
            {"name": f"{name}[F={CLUSTER_WIDTH}]", "route": "cuda", "source": sources[name][0],
             "replaces": sources[name][1], "launches": max(counts.values()),
             "launches_by_path": counts,
             "max_abs_err": max(e["max_abs_err"] for e in runs),
             **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "cluster_dim",
                                      "variant")}, "library_ms": None})
    # gcl_agg_bwd and coord_agg_bwd at F = 2048 (3xTF32, clusters of two
    # blocks), their launches on phase 20k's train steps at hidden 1025-2048
    for name in CLUSTER_BWD_KERNELS:
        counts = {f"cluster_train_step_{h}": r["launches"][name]
                  for h, r in cb["train_step"].items()}
        _check(max(counts.values()) > 0, f"no hidden-{CLUSTER_WIDTH} path launched {name}")
        entry = {k: v for k, v in cb["kernels"][f"{name}[{ec.DEFAULT_TIER}]"].items()
                 if k != "ptxas"}
        cluster_entries.append(
            {"name": f"{name}[F={CLUSTER_WIDTH}]", "route": "cuda", "source": sources[name][0],
             "replaces": sources[name][1], "launches": max(counts.values()),
             "launches_by_path": counts, **entry, "library_ms": None})
    # block_fused at F = 2048 (3xTF32, both phases on clusters of two
    # blocks), its launches on phase 20l's fused joint chain at hidden 2048;
    # the joint shapes on the clean complex, the collapsed one's beside them
    cbl = tiers["cluster_block"]
    counts = {"cluster_joint_sampling_fused": cbl["joint"]["launches"]["block_fused"]}
    _check(counts["cluster_joint_sampling_fused"] > 0,
           f"no hidden-{CLUSTER_WIDTH} path launched block_fused")
    runs = [e for e in cbl["kernels"].values() if e["tier"] == ec.DEFAULT_TIER]
    clean = cbl["kernels"][f"block_fused[{ec.DEFAULT_TIER}]:joint_main_path"]
    dense = cbl["kernels"][f"block_fused[{ec.DEFAULT_TIER}]:joint_main_path_dense"]
    cluster_entries.append(
        {"name": f"block_fused[F={CLUSTER_WIDTH}]", "route": "cuda",
         "source": sources["block_fused"][0], "replaces": sources["block_fused"][1],
         "launches": counts["cluster_joint_sampling_fused"], "launches_by_path": counts,
         "max_abs_err": max(e["max_abs_err"] for e in runs),
         **{k: clean[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "cluster_dim",
                                  "variant", "batch")},
         "dense_ms": dense["ms"], "dense_plain_ms": dense["plain_ms"],
         "dense_bound_ms": dense["bound_ms"], "library_ms": None})
    # gcl_agg and coord_agg at F = 4096 (3xTF32, a row tile on a cluster of
    # four blocks), their launches on phase 20m's hidden-4096 main path and
    # 20n's cli.train run at hidden 4096
    quad, qb = tiers["quad"], tiers["quad_bwd"]
    for name, main_variant in (("gcl_agg", "full"), ("coord_agg", "ligand_rows_cross")):
        counts = {"quad_sampling": quad["chain"]["launches"][name],
                  "quad_training": qb["training"]["launches"][name]}
        _check(min(counts.values()) > 0, f"no hidden-{QUAD_WIDTH} path launched {name}")
        runs = [e for e in quad["kernels"]["variants"].values()
                if e["kernel"] == name and e["tier"] == ec.DEFAULT_TIER]
        entry = quad["kernels"]["variants"][f"{name}[{ec.DEFAULT_TIER}]:{main_variant}"]
        cluster_entries.append(
            {"name": f"{name}[F={QUAD_WIDTH}]", "route": "cuda", "source": sources[name][0],
             "replaces": sources[name][1], "launches": max(counts.values()),
             "launches_by_path": counts, "max_abs_err": max(e["max_abs_err"] for e in runs),
             **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "cluster_dim",
                                      "variant")}, "library_ms": None})
    # gcl_agg_bwd and coord_agg_bwd at F = 4096 (3xTF32, clusters of four
    # blocks), their launches on 20n's cli.train run at hidden 4096 and its
    # hidden-3072 train step
    for name in CLUSTER_BWD_KERNELS:
        counts = {"quad_training": qb["training"]["launches"][name],
                  f"quad_train_step_{QUAD_PADDED}": qb["train_step"]["launches"][name]}
        _check(min(counts.values()) > 0, f"no hidden-{QUAD_WIDTH} path launched {name}")
        entry = {k: v for k, v in qb["kernels"][f"{name}[{ec.DEFAULT_TIER}]"].items()
                 if k != "ptxas"}
        cluster_entries.append(
            {"name": f"{name}[F={QUAD_WIDTH}]", "route": "cuda", "source": sources[name][0],
             "replaces": sources[name][1], "launches": counts["quad_training"],
             "launches_by_path": counts, **entry, "library_ms": None})
    # block_fused at F = 4096 (3xTF32, both phases on clusters of four
    # blocks), its launches on phase 20o's fused joint chain at hidden 4096;
    # phase 3c's joint shapes on the clean complex
    qbl = tiers["quad_block"]
    counts = {"quad_joint_sampling_fused": qbl["joint"]["launches"]["block_fused"]}
    _check(counts["quad_joint_sampling_fused"] > 0,
           f"no hidden-{QUAD_WIDTH} path launched block_fused")
    clean = qbl["kernels"][f"block_fused[{ec.DEFAULT_TIER}]:joint_main_path"]
    cluster_entries.append(
        {"name": f"block_fused[F={QUAD_WIDTH}]", "route": "cuda",
         "source": sources["block_fused"][0], "replaces": sources["block_fused"][1],
         "launches": counts["quad_joint_sampling_fused"], "launches_by_path": counts,
         **{k: clean[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "cluster_dim", "variant", "batch")}, "library_ms": None})
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
         **kres[name], "library_ms": None} for name in ec.KERNELS] + [
        {"name": f"{name}[F={DEFAULT_WIDTH}]", "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": width["default"]["launches"][name],
         "launches_by_path": {path: counts[name] for path, counts in by_path128.items()},
         **width["kernels"][name], "library_ms": None} for name in ec.KERNELS]
        + tier_entries + wide_entries + cluster_entries}, default=str))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
