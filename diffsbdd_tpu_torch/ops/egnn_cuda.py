"""Hand-written CUDA kernels for the EGNN hot loop, with their plain versions.

Two forward kernels carry sampling and the forward half of a training step
(sources in ``diffsbdd_tpu_torch/csrc``):

* ``gcl_message_agg``  -- edge MLP + sigmoid attention + masked row sum of one
  GCL layer (``csrc/gcl_agg.cu``; its F x F product on the tensor cores in
  3xTF32, ``csrc/egnn_mma.cuh``, emulated on the CPU by ``matmul_3xtf32``);
* ``coord_update_agg`` -- coordinate MLP (+ the SE(3) cross-product MLP) +
  tanh clamping + masked row sum of the relative-direction translations
  (``csrc/coord_agg.cu``; both MLPs' F x F products on the tensor cores in
  3xTF32, as the GCL kernel's).

Two backward kernels carry the other half of a training step:

* ``gcl_agg_bwd``   -- every cotangent of ``gcl_message_agg``
  (``csrc/gcl_agg_bwd.cu``; its three F x F products, the forward recompute,
  dm1 and dW2, on the tensor cores in 3xTF32, ``csrc/egnn_mma_bwd.cuh``);
* ``coord_agg_bwd`` -- every cotangent of ``coord_update_agg``, the cross MLP's
  and the graph mean's included (``csrc/coord_agg_bwd.cu``; the same three
  products of each MLP in 3xTF32, on the GCL backward's pieces).

One kernel carries a whole EGNN block on the sampling path:

* ``block_fused`` -- GCL aggregation, the node MLP, the first-layer
  projections of the coordinate and cross heads, and the coordinate update of
  one block behind one entry point (``csrc/block_fused.cu``; every product,
  pair MLPs and node MLP alike, on the tensor cores in 3xTF32).  Its
  gradient, should one be taken, is autograd through its plain version.

All of them rebuild the adjacency from the EGNN input coordinates ``x0``, the
node masks and the per-pair-type distance cutoffs, so the (B, N, N) adjacency
and the (B, N, N, F) message tensors never exist in memory; the backward
kernels recompute the pair MLPs instead of reading saved activations.  A
caller may ask for the split kernels' gradient through the dense mirror
instead of the backward kernels (``mirror_bwd``, the JAX package's
``kernel_bwd: xla``): autograd through the float32 plain version, with the
forward kernels' outputs kept.

Each wrapper takes its plain PyTorch version (``*_plain``: the dense twins, and
autograd through them) when its tensors lie on the CPU, and launches its kernel
when they lie on a CUDA device; there is no fallback from one to the other.
The plain versions are the CPU path and the kernels' test oracle.  On CUDA the
public wrappers go through ``torch.autograd.Function``s, so a training step
launches each split kernel once per layer.  Each launch adds one to
``launch_counts[name]`` (one for the two phases of ``block_fused``, one for
the coordinate kernel's two MLPs and the sum of their terms).  While a
profiler records, each launch also counts its pairs: ``pair_counts()[name]``
is (active, computed), the pairs inside the cutoffs on rows below
``update_rows`` and the pairs the kernel's chunks hold (each tile's rows
times 16 columns a chunk, a tile counted once whatever its cluster or pair
MLP; the two phases of ``block_fused`` both add), so that active / computed
is the share of the pair-MLP work spent inside the cutoffs.  Given a
counter, the library counts them on the device ahead of the kernel, with
the compaction the kernel's tiles run (``csrc/egnn_common.cuh``'s
``count_pairs_kernel``); the kernel itself is the same either way.
The plain path counts the adjacency's pairs and the dense (B, N, N) it
computes.

Precision tiers.  Every kernel takes ``precision`` (and the split forward
wrappers ``bwd_precision`` for their backward kernels): ``"tf32x3"``
(the default, 3xTF32: f32-grade), ``"tf32x2"`` (2xTF32: the second operand's
low part dropped, W2's in the forward) or ``"bf16"`` (one bf16 pass, f32
accumulation; the forward kernels also compute the pair MLP at the JAX
package's bf16 rounding points, ``_pair_mlp_bf16``).  ``config.PRECISIONS``
maps the JAX package's ``matmul_precision`` names onto them.  Each tier of a
kernel is its own
library; a tier that does not build or launch raises, and
``tier_launch_counts["gcl_agg[bf16]"]`` counts the launches of each tier's
library beside ``launch_counts``.  The plain versions
emulate each tier (``matmul_3xtf32(passes=2)``, ``matmul_bf16``,
``bf16_round``), so the CPU path computes what the card does; the
whole-block kernel's node MLP and projections round their products alone,
their elementwise work stays float32.

Hidden widths.  The five kernels are instantiated at F = 64, 128, 256,
512, 1024, 2048 and 4096 (at 512 on tiles of 2 rows, at 1024 of 1 row,
``row_tile``; at 2048 each row tile on a cluster of two blocks and at
4096 on a cluster of four holding a quarter of K each, ``cluster_size``:
``csrc/egnn_cluster.cuh`` the forward kernels' and the whole-block
kernel's, with its ``WideLayout`` at 4096, ``csrc/egnn_cluster_bwd.cuh``
the backward kernels'): ``KERNEL_WIDTHS``.  On CUDA the public wrappers
run any other width up to 4096 at the next of the widths
(``padded_width``: 32 at 64, 96 at 128, 192 at 256, 384 at 512, 768 at
1024, 1088 at 2048, 3072 at 4096): every operand's width axes zero-padded
(``pad_operands``), the outputs' cut back.  The padded channels stay exact
zeros through every MLP, so the result is the unpadded one up to
summation order, at every tier; gradients reach the true width through
autograd of the padding.  Wider than 4096 raises before any launch.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into plain-C shared
libraries under ``csrc/build`` at first use (``build_kernels``) and loaded with
ctypes.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("gcl_agg", "coord_agg", "gcl_agg_bwd", "coord_agg_bwd", "block_fused")
HEADERS = (CSRC / "egnn_common.cuh", CSRC / "egnn_mma.cuh",
           CSRC / "egnn_coord.cuh", CSRC / "egnn_bwd.cuh",
           CSRC / "egnn_mma_bwd.cuh", CSRC / "egnn_cluster.cuh",
           CSRC / "egnn_cluster_bwd.cuh")  # shared device code
# hidden widths the kernels are built for: the fixture checkpoint's, the
# config default's, the flagship's, and twice, four, eight and sixteen
# times the flagship's.  The layouts need F to divide
# the block's 256 threads or be a multiple of them, and the dW2 warp layout
# F >= 64 (csrc/egnn_mma.cuh,
# egnn_mma_bwd.cuh): 64, 128 and 256 are all the widths they admit up to 256;
# 512 and 1024 take tilings of their own (two rows a tile and one,
# ``row_tile``), 2048 a cluster of two blocks a row tile and 4096 of four
# (``cluster_size``).  The wrappers run every other width up to 4096
# zero-padded to the next of the widths (``padded_width``,
# ``pad_operands``).
SUPPORTED_F = (64, 128, 256, 512, 1024, 2048, 4096)
# the widths each kernel is built for: all of them, for every kernel
KERNEL_WIDTHS = {name: SUPPORTED_F for name in KERNELS}
# the ROADMAP.md §2 item that would run each kernel above its widest width
WIDER_ITEM = {name: f"widths above {KERNEL_WIDTHS[name][-1]}" for name in KERNELS}


def row_tile(F: int) -> int:
    """Rows per tile of the kernels at built width F: tile_rows<F>() in
    csrc/egnn_common.cuh (4; 2 at 512 and 1 at 1024, where a taller tile's
    pair tiles do not fit a block's shared memory)."""
    return 1 if F > 512 else 2 if F > 256 else 4


def cluster_size(F: int) -> int:
    """Blocks a row tile of the kernels at built width F: cluster_size<F>()
    in csrc/egnn_cluster.cuh (2 at 2048, whose S and W2 stages do not fit
    one block's shared memory, nor its accumulators one thread's registers;
    4 at 4096, each block owning a quarter of the features; 1, no cluster,
    below)."""
    return 4 if F > 2048 else 2 if F > 1024 else 1


NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# precision tiers of the kernels' products (csrc/egnn_mma.cuh, TIER):
# the value is the library's -DEGNN_TIER
TIERS = {"tf32x3": 0, "tf32x2": 1, "bf16": 2}
DEFAULT_TIER = "tf32x3"

# The card's gates, a tiered kernel against its plain version at the same
# tier (chip_smoke.py phase 20a, tests/test_torch_gpu.py).  Two parts:
#  * moved: the error's Frobenius norm within this share of the norm of how
#    far the tier moves the plain version from float32's (``tier_moved_share``).
#    A library that ran another tier's arithmetic (2xTF32 at three passes, bf16
#    without its elementwise rounding points) reads near 1 or above
#    (tests/test_torch_precision.py); the kernels read up to 0.087 on an H100
#    (phase 20a: a 2xTF32 coordinate backward at F = 256);
#  * share / bwd: the largest error within 1e-5 + 1e-4 |ref| + share * max
#    |ref| (forward), within bwd * max |ref| + 1e-7 (each cotangent).  Kernel
#    and plain version compute the values a tier rounds (silu, sums) a float32
#    rounding apart, and a value next to a rounding boundary may round to the
#    other neighbour: one ulp of that term, 2^-8 in bf16, and 2^-10 in 2xTF32
#    where the dropped low part no longer makes up for it (the cotangent dz2
#    in the dW2 product).  With few pairs a sum can be one such term, so the
#    gate allows about one ulp of a term as large as the largest entry:
#    2xTF32 backward 4e-3 (measured on an H100 up to 1.45e-3, a cross-MLP dW2
#    of the card tests at F = 128), bf16 2e-3 forward and 4e-3 backward
#    (measured up to 1.8e-4 and 4.1e-4); 3xTF32 keeps 1e-4.
TIER_GATES = {"tf32x3": dict(share=0.0, bwd=1e-4, moved=None),
              "tf32x2": dict(share=0.0, bwd=4e-3, moved=0.25),
              "bf16": dict(share=2e-3, bwd=4e-3, moved=0.25)}
# The whole-block kernel's gates (forward only): the split kernels' at
# 3xTF32 and 2xTF32.  At bf16 the gate measures the kernel's own error
# (``block_bf16_gate``): its reference is the bf16 plain version with its
# bf16-rounded products summed in float64 (``block_fused_bf16_exact``), not
# the bf16 plain version, whose float32 sums are another order of the same
# bf16-rounded terms.  The block computes phase B's inputs itself, h' and its
# projections, and rounds them to bf16 again, so two float32 orders part by
# whole bf16 roundings: against the float64 sums the plain version alone
# reads 0.242 (F = 1024) and 0.351 (2048) of the tier's move by norm (dx, at
# phase 3c's shapes on an H100, chip_smoke.py 20l), the kernel 0.282 and
# 0.391; 1.11-1.40x the plain version by norm and 1.10-1.22x by largest
# error.  Held against the plain version, the kernel would be charged with
# both orders.  Allowed, for each output: the kernel's distance from the
# reference at most k = 2 times the plain version's own, by error norm and by
# largest error, each with a floor of atol + rtol |reference|, so that a case
# whose plain version is nearly exact does not gate at zero, and
# * by norm ``floor`` (0.25) of the tier's move: about what a float32
#   rounding of the inputs alone moves the plain version (inputs moved by
#   1e-6 relative: 0.13-0.24 of the move for dx at phase 3c's shapes on an
#   H100, chip_smoke.py 20a; a padded width's other float32 order of the
#   node products, 0.077 at 384 on the CPU, where the plain version is 0.001
#   from the float64 sums, tests/test_torch_widths.py);
# * by largest error ``share`` (4e-3) of the reference's largest entry: a
#   bf16 rounding that one order takes to the other neighbour moves a term by
#   an ulp, so two such roundings of a term as large as the largest entry
#   (0.25 of the move's largest entry allowed 1.0e-3 where the kernel read
#   1.2e-3, dx at F = 256, B = 2, N = 90 on an H100, tests/test_torch_gpu.py).
# 3xTF32 in the bf16 slot reads 1.0 by norm, against limits of 0.36 (h_new)
# and 0.95 (dx) at 2048 from the figures above; bf16 products without the
# pair MLPs' rounding points 0.82 and 46 (tests/test_torch_block_tiers.py).
BLOCK_TIER_GATES = dict(TIER_GATES, bf16=dict(k=2.0, floor=0.25, share=4e-3, atol=1e-5,
                                              rtol=1e-4))


def tier_moved_share(got: torch.Tensor, ref: torch.Tensor, exact: torch.Tensor) -> float:
    """||got - ref|| / ||ref - exact|| (Frobenius norms): a tier's kernel
    output ``got`` against its plain version ``ref``, as a share of how far
    the tier moves that output from float32's ``exact``."""
    err = float((got.double() - ref.double()).norm())
    moved = float((ref.double() - exact.double()).norm())
    return err / moved if moved > 0 else (0.0 if err == 0 else float("inf"))


def block_bf16_gate(got: torch.Tensor, plain: torch.Tensor, exact: torch.Tensor,
                    f32: torch.Tensor) -> dict:
    """``BLOCK_TIER_GATES["bf16"]`` on one output of the whole block: ``got``
    the kernel's (or a stand-in's), ``plain`` the bf16 plain version's,
    ``exact`` ``block_fused_bf16_exact``'s, ``f32`` the float32 plain
    version's.  Returns ``ok`` and the figures: the kernel's and the plain
    version's error norms against ``exact`` as shares of the tier's move
    (``tier_moved_share`` against ``f32``) with the norm limit, their largest
    errors with the limit's part that does not vary by entry, and ``ratio``:
    the larger of the kernel's two measures over the plain version's."""
    gate = BLOCK_TIER_GATES["bf16"]
    got, plain, exact, f32 = (t.detach().double() for t in (got, plain, exact, f32))
    tol = gate["atol"] + gate["rtol"] * exact.abs()
    err, own = (got - exact).abs(), (plain - exact).abs()
    move = exact - f32
    norm_limit = (gate["k"] * float(own.norm()) + gate["floor"] * float(move.norm())
                  + float(tol.norm()))
    max_limit = gate["k"] * float(own.max()) + gate["share"] * float(exact.abs().max())
    ok = (bool(torch.isfinite(got).all()) and float(err.norm()) <= norm_limit
          and bool((err <= max_limit + tol).all()))
    share = lambda t: tier_moved_share(t, exact, f32)
    ratio = max(float(err.norm()) / max(float(own.norm()), 1e-300),
                float(err.max()) / max(float(own.max()), 1e-300))
    moved = float(move.norm())
    return dict(ok=ok, norm=share(got), plain_norm=share(plain),
                norm_limit=norm_limit / moved if moved > 0 else float("inf"),
                max=float(err.max()), plain_max=float(own.max()), max_limit=max_limit,
                ratio=ratio)


launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
# launches by kernel and tier, "gcl_agg[bf16]": which library ran
tier_launch_counts: Dict[str, int] = {f"{name}[{tier}]": 0
                                      for name in KERNELS for tier in TIERS}
_libs: Dict[tuple, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# each entry point's parameters; the last two are the pair counter and the stream
_ARGTYPES = {
    "gcl_agg": ("gcl_agg_forward",
                [_P] * 14 + [_F] * 4 + [_I] * 4 + [_P] + [_P, _P]),
    "coord_agg": ("coord_agg_forward",
                  [_P] * 22 + [_I] + [_F] * 6 + [_I] * 4 + [_P] * 2 + [_P, _P]),
    "gcl_agg_bwd": ("gcl_agg_backward",
                    [_P] * 16 + [_F] * 4 + [_I] * 5 + [_P] * 7 + [_P, _P]),
    "coord_agg_bwd": ("coord_agg_backward",
                      [_P] * 25 + [_I] + [_F] * 6 + [_I] * 5 + [_P] * 14 + [_P, _P]),
    "block_fused": ("block_fused_forward",
                    [_P] * 39 + [_I] + [_F] * 6 + [_I] * 5 + [_P, _P] + [_P, _P]),
}

# Pair counters: while a profiler records, each launch adds to its kernel's
# (active, computed) pairs -- the pairs inside the cutoffs (both ends valid,
# rows below update_rows) and the pairs its chunks hold -- in a per-device
# int64 buffer, a row a kernel (csrc/egnn_common.cuh's launch_count_pairs);
# the plain path adds its own in Python.  Otherwise every launch passes a
# null counter.
_pair_buffers: Dict[int, torch.Tensor] = {}
_plain_pairs: Dict[str, list] = {name: [0, 0] for name in KERNELS}


def _recording() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def _pair_counter(name: str) -> Optional[int]:
    """The device address of kernel ``name``'s two counters on the current
    device while a profiler records; None (a null pointer) otherwise."""
    if not _recording():
        return None
    device = torch.cuda.current_device()
    buf = _pair_buffers.get(device)
    if buf is None:
        buf = _pair_buffers[device] = torch.zeros(
            (len(KERNELS), 2), dtype=torch.int64, device=torch.device("cuda", device))
    return buf.data_ptr() + buf.stride(0) * buf.element_size() * KERNELS.index(name)


def _count_plain(name: str, x0, mask, col_mask, is_lig, cutoffs, update_rows) -> None:
    """A plain-path launch of kernel ``name`` while a profiler records: the
    adjacency's pairs on rows below ``update_rows``, and every pair of the
    (B, N, N) it computes."""
    if not _recording():
        return
    B, N = mask.shape
    adj = adjacency_dense(_pair_d2(x0), mask, is_lig, cutoffs, col_mask=col_mask)
    _plain_pairs[name][0] += int(torch.count_nonzero(adj[:, :_rows(update_rows, N)]))
    _plain_pairs[name][1] += B * N * N


def pair_counts() -> Dict[str, tuple]:
    """(active, computed) pairs of each kernel's launches while a profiler
    recorded, since the last ``reset_launch_counts``: the device counters
    (read with one synchronize) and the plain path's."""
    out = {name: list(v) for name, v in _plain_pairs.items()}
    for buf in _pair_buffers.values():
        for name, (active, computed) in zip(KERNELS, buf.tolist()):
            out[name][0] += active
            out[name][1] += computed
    return {name: (int(a), int(c)) for name, (a, c) in out.items()}


def reset_launch_counts() -> None:
    """Zero ``launch_counts``, ``tier_launch_counts`` and the pair counters."""
    for counts in (launch_counts, tier_launch_counts):
        for name in counts:
            counts[name] = 0
    for v in _plain_pairs.values():
        v[:] = [0, 0]
    for buf in _pair_buffers.values():
        buf.zero_()


def check_tier(name: str, tier: str) -> str:
    """``tier`` if it is one of ``TIERS``; raises, naming the kernel
    ``name``, otherwise."""
    if tier not in TIERS:
        raise ValueError(f"{name}: no precision tier {tier!r}")
    return tier


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str, tier: str = DEFAULT_TIER) -> Path:
    return BUILD_DIR / (f"lib{name}.so" if tier == DEFAULT_TIER else f"lib{name}_{tier}.so")


def build_kernels(names: Sequence[str] = KERNELS, force: bool = False,
                  tiers: Sequence[str] = (DEFAULT_TIER,)) -> Dict[str, str]:
    """Compile the named kernels at each of ``tiers``, one ``nvcc``
    process a library, all started together (a tier other than 3xTF32 with
    ``-DEGNN_TIER``).  Returns the compiler output (register and
    shared-memory use from ``-Xptxas -v``) by library: the kernel's name for
    3xTF32, ``name[tier]`` for the others; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        for tier in tiers:
            src, lib = CSRC / f"{name}.cu", _lib_path(name, tier)
            newest = max(p.stat().st_mtime for p in (src, *HEADERS))
            if not force and lib.exists() and lib.stat().st_mtime >= newest:
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            define = [] if tier == DEFAULT_TIER else [f"-DEGNN_TIER={TIERS[tier]}"]
            key = name if tier == DEFAULT_TIER else f"{name}[{tier}]"
            procs[key] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *define, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs = {}
    for key, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[key] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        os.replace(tmp, lib)
    return logs


def _lib(name: str, tier: str = DEFAULT_TIER) -> ctypes.CDLL:
    lib = _libs.get((name, tier))
    if lib is None:
        build_kernels([name], tiers=(tier,))
        lib = ctypes.CDLL(str(_lib_path(name, tier)))
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[(name, tier)] = lib
    return lib


def _check(name: str, tensors: Dict[str, Optional[torch.Tensor]],
           shapes: Dict[str, tuple], device: torch.device) -> None:
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key in shapes and tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _cut2(c: Optional[float]) -> float:
    """Squared cutoff for the kernels; -1 encodes "no cutoff"."""
    return -1.0 if c is None else float(c) * float(c)


def last_cluster_dim(name: str, tier: str = DEFAULT_TIER) -> int:
    """The cluster dimension (blocks a cluster along x) that the last launch
    of kernel ``name``'s library at ``tier`` used: 4 at F = 4096, 2 at 2048,
    1 below (``egnn_last_cluster_dim`` in each of the five libraries)."""
    fn = _lib(name, tier).egnn_last_cluster_dim
    fn.argtypes, fn.restype = [], ctypes.c_int
    return int(fn())


def _launch(name: str, *args, tier: str = DEFAULT_TIER) -> None:
    fn = getattr(_lib(name, tier), _ARGTYPES[name][0])
    err = fn(*args, _pair_counter(name), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}[{tier}] kernel launch failed with CUDA error {err}")
    launch_counts[name] += 1
    tier_launch_counts[f"{name}[{tier}]"] += 1


# ---------------------------------------------------------------------------
# plain twins (port of the JAX package's dense mirrors)
# ---------------------------------------------------------------------------

def _pair_d2(x: torch.Tensor) -> torch.Tensor:
    return ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)


def adjacency_dense(d2, mask, is_lig, cutoffs, col_mask=None):
    """(B, N, N) adjacency: masks times the per-pair-type cutoff test on the
    squared distances ``d2``; self-edges kept."""
    cutoff_l, cutoff_p, cutoff_i = cutoffs
    cm = mask if col_mask is None else col_mask
    valid = mask[:, :, None] * cm[:, None, :]
    ll = is_lig[:, :, None] * is_lig[:, None, :]
    pp = (1 - is_lig)[:, :, None] * (1 - is_lig)[:, None, :]
    cross = 1.0 - ll - pp
    ok = torch.zeros_like(valid)
    ok = ok + (ll if cutoff_l is None else ll * (d2 <= cutoff_l ** 2))
    ok = ok + (pp if cutoff_p is None else pp * (d2 <= cutoff_p ** 2))
    ok = ok + (cross if cutoff_i is None else cross * (d2 <= cutoff_i ** 2))
    return valid * ok


def _edge_bias_dense(d2, d2_0, w_d2, w_d20, is_lig, type_bias):
    out = d2[..., None] * w_d2 + d2_0[..., None] * w_d20
    if type_bias is not None:
        li = is_lig[:, :, None, None]
        lj = is_lig[:, None, :, None]
        out = out + (1 - li) * (1 - lj) * type_bias[0, 0] \
            + (1 - li) * lj * type_bias[0, 1] \
            + li * (1 - lj) * type_bias[1, 0] \
            + li * lj * type_bias[1, 1]
    return out


def _keep_rows(agg, update_rows):
    if update_rows is None:
        return agg
    keep = torch.arange(agg.shape[1], device=agg.device) < int(update_rows)
    return agg * keep[None, :, None].to(agg.dtype)


def _pair_mlp_plain(row, col, d2, d2_0, is_lig, w_d2, w_d20, type_bias, w2, b2, *,
                    matmul, precision):
    """silu(silu(pre) @ w2 + b2) of every pair (B, N, N, F): ``matmul`` the
    product at 3xTF32, the tier's product at 2xTF32, and on the bf16 tier the
    JAX package's bf16 ``_pair_mlp`` (``_pair_mlp_bf16``; ``BF16_EXACT``: its
    products summed in float64)."""
    if precision in _BF16:
        return _pair_mlp_bf16(row, col, d2, d2_0, is_lig, w_d2, w_d20, type_bias, w2, b2,
                              matmul=_tier_product(precision))
    if precision != DEFAULT_TIER:
        matmul = _tier_product(precision)
    silu = torch.nn.functional.silu
    pre = row[:, :, None, :] + col[:, None, :, :] + _edge_bias_dense(
        d2, d2_0, w_d2, w_d20, is_lig, type_bias)
    return silu(matmul(silu(pre), w2) + b2)


def _silu_bf16(x):
    """The JAX package's ``_silu`` on a bfloat16 tensor, x * (1 / (1 + e^-x)),
    each operation's result rounded to bfloat16."""
    one = torch.ones((), dtype=torch.bfloat16, device=x.device)
    return x * (one / (one + torch.exp(-x)))


def _pair_mlp_bf16(row, col, d2, d2_0, is_lig, w_d2, w_d20, type_bias, w2, b2,
                   matmul=None):
    """The pair MLP at the JAX package's bf16 rounding points (its
    ``_pair_mlp`` at ``mxu_precision="bfloat16"``, as the bf16 kernels compute
    it): the edge-type table folded into row and col, which are rounded, as is
    the edge bias (computed in float32); pre = (row + col) + bias and both
    silus in bfloat16 operations; the product's operands rounded, its sum and
    + b2 (rounded) in float32, z rounded (``matmul``: the product,
    ``matmul_bf16`` when None).  Returns float32 holding bf16 values."""
    bf = torch.bfloat16
    row, col, delta = fold_type_bias(row, col, is_lig, type_bias)
    bias = d2[..., None] * w_d2 + d2_0[..., None] * w_d20
    if delta is not None:
        bias = bias + (is_lig[:, :, None] * is_lig[:, None, :])[..., None] * delta
    pre = (row.to(bf)[:, :, None, :] + col.to(bf)[:, None, :, :]) + bias.to(bf)
    z = (matmul or matmul_bf16)(_silu_bf16(pre).float(), w2) + bf16_round(b2)
    return _silu_bf16(z.to(bf)).float()


def _head_weight(w, precision):
    """A pair MLP's head (w_att, w3) as the tier's kernel reads it."""
    return bf16_round(w) if precision in _BF16 else w


def gcl_message_agg_plain(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20,
                          type_bias, w2, b2, w_att, b_att, *, cutoffs,
                          attention, normalization_factor, col_mask=None,
                          update_rows=None, matmul=torch.matmul, precision=DEFAULT_TIER):
    """Dense twin of the GCL kernel (same math, O(N^2 F) in memory).
    ``matmul`` computes silu(pre) @ w2 (``matmul_3xtf32``: as the kernel's
    tensor cores do); ``precision`` another tier than 3xTF32 emulates that
    kernel's (its product in place of ``matmul``, and the bf16 tier's
    rounding points)."""
    d2 = _pair_d2(x)
    d2_0 = _pair_d2(x0)
    m = _pair_mlp_plain(a_row, a_col, d2, d2_0, is_lig, w_d2, w_d20, type_bias, w2, b2,
                        matmul=matmul, precision=precision)
    if attention:
        m = m * torch.sigmoid(m @ _head_weight(w_att, precision) + b_att)
    adj = adjacency_dense(d2_0, mask, is_lig, cutoffs, col_mask=col_mask)
    agg = (m * adj[..., None]).sum(2) / normalization_factor
    return _keep_rows(agg, update_rows)


def coord_update_agg_plain(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20,
                           type_bias, w2, b2, w3, *, cutoffs, tanh,
                           coords_range, norm_constant, normalization_factor,
                           cross=None, graph_mean=None, col_mask=None,
                           update_rows=None, matmul=torch.matmul, precision=DEFAULT_TIER):
    """Dense twin of the coordinate-update kernel.  ``matmul`` computes
    silu(pre) @ w2 of both MLPs (``matmul_3xtf32``: as the kernel's tensor
    cores do); ``precision``: as ``gcl_message_agg_plain``'s."""
    d2 = _pair_d2(x)
    d2_0 = _pair_d2(x0)
    adj = adjacency_dense(d2_0, mask, is_lig, cutoffs, col_mask=col_mask)

    def head(row, col, wd2, wd20, tb, w2_, b2_, w3_):
        m = _pair_mlp_plain(row, col, d2, d2_0, is_lig, wd2, wd20, tb, w2_, b2_,
                            matmul=matmul, precision=precision)
        phi = (m @ _head_weight(w3_, precision))[..., 0]
        return torch.tanh(phi) * coords_range if tanh else phi

    phi = head(a_row, a_col, w_d2, w_d20, type_bias, w2, b2, w3)
    diff = x[:, :, None, :] - x[:, None, :, :]
    norm = torch.sqrt(d2 + 1e-8) + norm_constant
    trans = diff / norm[..., None] * phi[..., None]
    if cross is not None:
        phi_c = head(cross["a_row"], cross["a_col"], cross["w_d2"],
                     cross["w_d20"], cross["type_bias"], cross["w2"],
                     cross["b2"], cross["w3"])
        xc = x - graph_mean[:, None, :]
        shape = d2.shape + (3,)
        cr = torch.linalg.cross(xc[:, :, None, :].expand(shape),
                                xc[:, None, :, :].expand(shape), dim=-1)
        # guarded norm: the cross product is exactly zero on the diagonal
        cnorm = torch.sqrt((cr ** 2).sum(-1, keepdim=True) + 1e-8) + norm_constant
        trans = trans + cr / cnorm * phi_c[..., None]
    agg = (trans * adj[..., None]).sum(2) / normalization_factor
    return _keep_rows(agg, update_rows)


# ---------------------------------------------------------------------------
# the forward kernels' tensor-core product, emulated (tests only)
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, as ``cvt.rna.tf32.f32``: half a TF32 ulp added to the
    magnitude's bits, the low 13 bits cleared."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as ``csrc/egnn_mma.cuh`` computes it: each operand split into
    TF32 parts hi + lo, summed as lo*hi + hi*lo + hi*hi in float32 (lo*lo
    dropped).  ``passes=2`` is the 2xTF32 tier, lo*hi + hi*hi (b's low part
    dropped, as the JAX package's "float32_x2" drops the weight's);
    ``passes=1`` is plain TF32 (hi*hi only)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo = tf32_round(a - a_hi)
    if passes == 2:
        return a_lo @ b_hi + a_hi @ b_hi
    b_lo = tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16 (ties to even, as ``astype`` and the
    kernels' ``cvt.rn.bf16x2``), kept in x's type."""
    return x.to(torch.bfloat16).to(x.dtype)


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the bf16 tier's ``mma.sync.m16n8k16``: both operands rounded
    to bfloat16, the exact products summed in float32."""
    return bf16_round(a) @ bf16_round(b)


def matmul_bf16_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bfloat16 as ``matmul_bf16``'s,
    their products summed in float64 and the sum rounded once to float32:
    the bf16 tier's product without the order of a float32 sum."""
    return (bf16_round(a).double() @ bf16_round(b).double()).to(a.dtype)


# A precision of the plain versions only: the bf16 tier with its products
# summed in float64 (``block_fused_bf16_exact``); no kernel runs it
BF16_EXACT = "bf16_exact_sums"
_BF16 = ("bf16", BF16_EXACT)


def _tier_product(precision: str):
    """The product a tier's tensor cores compute (3xTF32: float32's own)."""
    return {"tf32x3": torch.matmul, "bf16": matmul_bf16, BF16_EXACT: matmul_bf16_exact,
            "tf32x2": lambda a, b: matmul_3xtf32(a, b, passes=2)}[precision]


class _TierMatmul(torch.autograd.Function):
    """a @ b at a tier, and its backward as the backward kernels run it: dA =
    g @ b^T and dB = a^T g at the same tier (the second operand's low part
    dropped in 2xTF32), in float32 around them."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return _tier_product(precision)(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        mm, f = _tier_product(ctx.precision), b.shape[0]
        return (mm(g, b.t()), mm(a.reshape(-1, f).t(), g.reshape(-1, f)), None)


def _bwd_matmul(precision: str, matmul):
    """The product a plain backward version differentiates through: the
    caller's at 3xTF32, the tier's (both directions) otherwise."""
    if precision == DEFAULT_TIER:
        return matmul
    return lambda a, b: _TierMatmul.apply(a, b, precision)


# ---------------------------------------------------------------------------
# edge-type-table folding
# ---------------------------------------------------------------------------

def fold_type_bias(a_row, a_col, is_lig, type_bias):
    """Fold the (2, 2, F) edge-type table into per-node row/col projections.

    tb[li, lj] == t00 + li*(t10-t00) + lj*(t01-t00) + li*lj*delta with
    delta = t11 - t10 - t01 + t00; only the rank-1 product term stays
    pairwise.  Returns (a_row', a_col', delta), delta None without a table.
    """
    if type_bias is None:
        return a_row, a_col, None
    t00, t01 = type_bias[0, 0], type_bias[0, 1]
    t10, t11 = type_bias[1, 0], type_bias[1, 1]
    lig = is_lig[..., None]
    a_row = a_row + t00 + lig * (t10 - t00)
    a_col = a_col + lig * (t01 - t00)
    return a_row, a_col, (t11 - t10 - t01 + t00)


# ---------------------------------------------------------------------------
# the whole block, plain: GCL + node MLP + head projections + coordinate update
# ---------------------------------------------------------------------------

_GCL_KEYS = ("w_d2", "w_d20", "type_delta", "w2", "b2", "w_att", "b_att")
_NODE_KEYS = ("w_h", "w_a", "b0", "w2", "b2")
_HEAD_KEYS = ("k_i", "k_j", "b0", "w_d2", "w_d20", "type_bias", "w1", "b1", "w3")


def block_fused_plain(h, a_row, a_col, x, x0, mask, is_lig, gcl, node, coord,
                      cross=None, graph_mean=None, *, cutoffs, attention, tanh,
                      coords_range, norm_constant, normalization_factor,
                      update_rows=None, matmul=torch.matmul, precision=DEFAULT_TIER):
    """Plain version of ``block_fused`` (same math, O(N^2 F) in memory): the
    dense GCL twin, the node MLP, the folded head projections of h', the dense
    coordinate twin.  ``matmul`` computes every product the kernel runs on
    its tensor cores: the GCL's and both coordinate MLPs' silu(pre) @ W2, the
    node MLP's three and the heads' projections (``matmul_3xtf32``: as the
    kernel does).  Another ``precision`` than 3xTF32 emulates that tier's
    library: the split plain versions at the tier for the pair MLPs, the
    tier's product (``matmul_3xtf32(passes=2)``, ``matmul_bf16``) for the
    node MLP and the projections, whose elementwise work stays float32."""
    silu = torch.nn.functional.silu
    if precision != DEFAULT_TIER:
        matmul = _tier_product(precision)
    agg = gcl_message_agg_plain(
        a_row, a_col, x, x0, mask, is_lig, gcl["w_d2"], gcl["w_d20"],
        _delta_table(gcl.get("type_delta")), gcl["w2"], gcl["b2"],
        gcl.get("w_att"), gcl.get("b_att"), cutoffs=cutoffs, attention=attention,
        normalization_factor=normalization_factor, matmul=matmul, precision=precision)
    pre_n = matmul(h, node["w_h"]) + matmul(agg, node["w_a"]) + node["b0"]
    h_new = (h + matmul(silu(pre_n), node["w2"]) + node["b2"]) * mask[..., None]

    def head(p):
        row, col, delta = fold_type_bias(matmul(h_new, p["k_i"]) + p["b0"],
                                         matmul(h_new, p["k_j"]), is_lig,
                                         p.get("type_bias"))
        return row, col, _delta_table(delta)

    la_row, la_col, l_tb = head(coord)
    cross_arg = None
    if cross is not None:
        c_row, c_col, c_tb = head(cross)
        cross_arg = dict(a_row=c_row, a_col=c_col, w_d2=cross["w_d2"],
                         w_d20=cross["w_d20"], type_bias=c_tb, w2=cross["w1"],
                         b2=cross["b1"], w3=cross["w3"])
    dx = coord_update_agg_plain(
        la_row, la_col, x, x0, mask, is_lig, coord["w_d2"], coord["w_d20"], l_tb,
        coord["w1"], coord["b1"], coord["w3"], cutoffs=cutoffs, tanh=tanh,
        coords_range=coords_range, norm_constant=norm_constant,
        normalization_factor=normalization_factor, cross=cross_arg,
        graph_mean=graph_mean, update_rows=update_rows, matmul=matmul,
        precision=precision)
    return h_new, dx


def block_fused_bf16_exact(*args, **kw):
    """The bf16 plain version of ``block_fused`` (``block_fused_plain`` at
    ``precision="bf16"``, the same arguments) with every bf16-rounded
    product summed in float64 and rounded once: the reference of the bf16
    whole-block gate (``block_bf16_gate``), against which the kernel's and
    the plain version's float32 orders of the same sums read alike."""
    return block_fused_plain(*args, **kw, precision=BF16_EXACT)


# ---------------------------------------------------------------------------
# plain backward versions: autograd through the plain twins
# ---------------------------------------------------------------------------

def _delta_table(delta):
    """The (2, 2, F) edge-type table whose fold is (0, 0, delta)."""
    if delta is None:
        return None
    z = torch.zeros_like(delta)
    return torch.stack([torch.stack([z, z]), torch.stack([z, delta])])


def _leaves(tensors):
    return [None if t is None else t.detach().requires_grad_(True) for t in tensors]


def _grads(out, g, leaves):
    """d(out . g)/d(leaf) for every leaf; None for a None or unused leaf."""
    live = [t for t in leaves if t is not None]
    found = iter(torch.autograd.grad(out, live, grad_outputs=g, allow_unused=True))
    return [None if t is None else next(found) for t in leaves]


def gcl_agg_bwd_plain(g, a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, delta,
                      w2, b2, w_att, b_att, *, cutoffs, attention,
                      normalization_factor, col_mask=None, update_rows=None,
                      matmul=torch.matmul, precision=DEFAULT_TIER):
    """Plain version of ``gcl_agg_bwd``: autograd through the dense twin.
    ``matmul`` computes silu(pre) @ w2, and through its backward the dm1 and
    dW2 products (tests: the kernel's 3xTF32 products, emulated); another
    ``precision`` runs all three at that tier, the rest in float32, as the
    backward kernel of that tier does."""
    matmul = _bwd_matmul(precision, matmul)
    with torch.enable_grad():
        lv = _leaves([a_row, a_col, x, x0, w_d2, w_d20, delta, w2, b2, w_att, b_att])
        out = gcl_message_agg_plain(
            lv[0], lv[1], lv[2], lv[3], mask, is_lig, lv[4], lv[5],
            _delta_table(lv[6]), lv[7], lv[8], lv[9], lv[10], cutoffs=cutoffs,
            attention=attention, normalization_factor=normalization_factor,
            col_mask=col_mask, update_rows=update_rows, matmul=matmul)
        return tuple(_grads(out, g, lv))


_MLP_KEYS = ("a_row", "a_col", "w_d2", "w_d20", "delta", "w2", "b2", "w3")
# the backward wrappers' cotangents in order, each named as its operand
_GCL_COT = ("a_row", "a_col", "x", "x0", "w_d2", "w_d20", "delta", "w2", "b2", "w_att",
            "b_att")
_COORD_COT = _GCL_COT[:9] + ("w3",)


def coord_agg_bwd_plain(g, a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, delta,
                        w2, b2, w3, *, cutoffs, tanh, coords_range, norm_constant,
                        normalization_factor, cross=None, graph_mean=None,
                        col_mask=None, update_rows=None, matmul=torch.matmul,
                        precision=DEFAULT_TIER):
    """Plain version of ``coord_agg_bwd``: autograd through the dense twin.
    ``matmul`` computes silu(pre) @ w2 of both MLPs, and through its backward
    their dm1 and dW2 products (tests: the kernel's 3xTF32 products,
    emulated); ``precision``: as ``gcl_agg_bwd_plain``'s."""
    matmul = _bwd_matmul(precision, matmul)
    with torch.enable_grad():
        lv = _leaves([a_row, a_col, x, x0, w_d2, w_d20, delta, w2, b2, w3])
        cl, gm, cross_in = [], None, None
        if cross is not None:
            cl = _leaves([cross[k] for k in _MLP_KEYS])
            gm = graph_mean.detach().requires_grad_(True)
            cross_in = dict(zip(_MLP_KEYS, cl))
            cross_in["type_bias"] = _delta_table(cross_in.pop("delta"))
        out = coord_update_agg_plain(
            lv[0], lv[1], lv[2], lv[3], mask, is_lig, lv[4], lv[5],
            _delta_table(lv[6]), lv[7], lv[8], lv[9], cutoffs=cutoffs, tanh=tanh,
            coords_range=coords_range, norm_constant=norm_constant,
            normalization_factor=normalization_factor, cross=cross_in,
            graph_mean=gm, col_mask=col_mask, update_rows=update_rows,
            matmul=matmul)
        grads = _grads(out, g, lv + cl + [gm])
    main = tuple(grads[:len(lv)])
    if cross is None:
        return main, None, None
    return main, dict(zip(_MLP_KEYS, grads[len(lv):-1])), grads[-1]


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _rows(update_rows, N):
    return N if update_rows is None else int(update_rows)


def padded_width(F: int, name: str = "egnn kernels", kernel: str = "gcl_agg") -> int:
    """The width ``kernel`` runs hidden width ``F`` at: the least of its
    ``KERNEL_WIDTHS`` that is >= F.  Wider than its widest raises, naming the
    ROADMAP.md §2 item that would build it (``WIDER_ITEM``): above 4096,
    clusters of eight blocks."""
    widths = KERNEL_WIDTHS[kernel]
    for width in widths:
        if width >= F:
            return width
    raise ValueError(f"{name}: feature width {F} above {widths[-1]}, the widest {kernel} "
                     f"is built for (ROADMAP.md §2: {WIDER_ITEM[kernel]})")


def _refuse_untrainable_width(name: str, bwd_kernel: str, F: int, tensors) -> None:
    """Raises before any launch when a gradient of a forward wrapper's output
    will be due (grad mode on, an operand that requires it) at a width
    ``bwd_kernel`` is not built for: a train step at such a width fails at
    its first layer, not after a forward pass.  Each backward kernel is built
    at every width of its forward kernel, so this fires today only where
    ``padded_width`` refuses the forward too; it is the guard for a forward
    kernel built wider than its backward (ROADMAP.md §2: 8192)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        padded_width(F, name, bwd_kernel)


# the axes of an operand that run along the hidden width, by the operand's
# name in the wrappers' signatures and parameter dicts; other operands have none
_WIDTH_AXES = {**dict.fromkeys(("h", "a_row", "a_col", "w_d2", "w_d20", "delta",
                                "type_delta", "type_bias", "b0", "b1", "b2"), (-1,)),
               **dict.fromkeys(("w1", "w2", "w_h", "w_a", "k_i", "k_j"), (0, 1)),
               **dict.fromkeys(("w_att", "w3"), (0,))}


def _pad_axes(t: torch.Tensor, F: int, width: int, axes, key: str) -> torch.Tensor:
    pad = [0] * (2 * t.dim())
    for axis in axes:
        if t.shape[axis] != F:
            raise ValueError(f"{key} has shape {tuple(t.shape)}, expected width {F} "
                             f"on axis {axis}")
        pad[2 * (t.dim() - 1 - axis % t.dim()) + 1] = width - F
    return torch.nn.functional.pad(t, pad)


def pad_operands(ops: Dict, F: int, width: int) -> Dict:
    """``ops`` (operands by name, parameter dicts nested) with every
    hidden-width axis zero-padded from ``F`` to ``width``.  The added channels
    of every kernel stay exact zeros -- silu(0) = 0, and the padded rows and
    columns of every matrix are zero -- so a kernel at ``width`` computes the
    width-``F`` result up to summation order.  The padding is differentiable:
    autograd slices the gradients back to ``F``."""
    return {key: pad_operands(t, F, width) if isinstance(t, dict)
            else t if t is None or key not in _WIDTH_AXES
            else _pad_axes(t, F, width, _WIDTH_AXES[key], key)
            for key, t in ops.items()}


def unpad_operands(ops: Dict, F: int) -> Dict:
    """``pad_operands``' inverse: every hidden-width axis cut back to ``F``
    (cotangents named as the operands they belong to)."""
    out = {}
    for key, t in ops.items():
        if isinstance(t, dict):
            out[key] = unpad_operands(t, F)
        elif t is None or key not in _WIDTH_AXES:
            out[key] = t
        else:
            index = [slice(None)] * t.dim()
            for axis in _WIDTH_AXES[key]:
                index[axis] = slice(0, F)
            out[key] = t[tuple(index)]
    return out


def _mlp_shapes(B, N, F):
    return dict(a_row=(B, N, F), a_col=(B, N, F), w_d2=(F,), w_d20=(F,), delta=(F,),
                w2=(F, F), b2=(F,), w3=(F, 1))


def _node_shapes(B, N):
    return dict(x=(B, N, 3), x0=(B, N, 3), mask=(B, N), col_mask=(B, N),
                is_lig=(B, N), graph_mean=(B, 3))


def _check_mlp(name, prefix, mlp, B, N, F, device):
    _check(name, {prefix + k: v for k, v in mlp.items()},
           {prefix + k: v for k, v in _mlp_shapes(B, N, F).items()}, device)


def _blocks_per_batch(B: int, rows: int, device, F: int) -> int:
    """Blocks a backward kernel at built width F runs per batch element,
    counted in clusters at F = 2048 and 4096 (``cluster_size``): enough to
    fill the card's SMs (one block fits an SM), at most one per row tile.
    Each owns one slab of the scratch (at 4096 a cluster's dW2 slab is 67 MB:
    2.15 GB for B = 16, 2 clusters a graph)."""
    tiles = max(1, -(-rows // row_tile(F)))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tiles, sms // (B * cluster_size(F))))


BLOCK_TILES_MAX = 16  # RB_TILES in csrc/block_fused.cu


def _block_grid(B: int, N: int, device, F: int) -> int:
    """Blocks of the whole-block kernel's phase A at built width F: one an SM
    (one fits an SM), so that the B * ceil(N / row_tile(F)) row tiles, dealt
    round-robin, spread as thinly as one wave allows; more only where a
    block would own more than ``BLOCK_TILES_MAX`` tiles, fewer where there
    are fewer tiles.  A block's time is its tiles' GCL work plus its node
    products (one pass over the weights, growing with its m-tiles of 16
    rows), and under one wave the longest block sets the time.  Above
    F = 1024 the tiles are dealt to clusters of ``cluster_size(F)`` blocks
    (two at 2048, four at 4096), one wave holding ``sms // cluster_size(F)``
    of them."""
    tiles = B * -(-N // row_tile(F))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    C = cluster_size(F)
    return C * max(min(sms // C, tiles), -(-tiles // BLOCK_TILES_MAX))


def _split_weight_slab(w_out, F):
    """(dW2, [dw_d2, dw_d20, ddelta, db2, dhead, dhead_bias]) views of a slab."""
    return w_out[:F * F].view(F, F), w_out[F * F:].view(6, F)


def _gcl_forward_cuda(a_row, a_col, x, x0, mask, cm, is_lig, w_d2, w_d20, delta,
                      w2, b2, w_att, b_att, cutoffs, nf, update_rows, tier):
    B, N, F = a_row.shape
    watt = None if w_att is None else w_att.reshape(F)
    _check_mlp("gcl_message_agg", "", dict(a_row=a_row, a_col=a_col, w_d2=w_d2,
                                           w_d20=w_d20, delta=delta, w2=w2, b2=b2),
               B, N, F, a_row.device)
    _check("gcl_message_agg",
           dict(x=x, x0=x0, mask=mask, col_mask=cm, is_lig=is_lig, w_att=watt,
                b_att=b_att),
           dict(_node_shapes(B, N), w_att=(F,), b_att=(1,)), a_row.device)
    if w2.data_ptr() % 16:
        raise ValueError("gcl_message_agg: w2 must be 16-byte aligned (cp.async)")
    out = torch.empty((B, N, F), device=a_row.device, dtype=torch.float32)
    _launch("gcl_agg",
            _ptr(a_row), _ptr(a_col), _ptr(x), _ptr(x0), _ptr(mask), _ptr(cm),
            _ptr(is_lig), _ptr(w_d2), _ptr(w_d20), _ptr(delta), _ptr(w2),
            _ptr(b2), _ptr(watt), _ptr(b_att),
            _cut2(cutoffs[0]), _cut2(cutoffs[1]), _cut2(cutoffs[2]),
            float(nf), B, N, F, _rows(update_rows, N), out.data_ptr(), tier=tier)
    return out


def gcl_agg_bwd(g, a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, delta, w2, b2,
                w_att, b_att, *, cutoffs, attention, normalization_factor,
                col_mask=None, update_rows=None, precision=DEFAULT_TIER):
    """Cotangents of ``gcl_message_agg`` on folded operands (``delta`` (F,) or
    None in place of the edge-type table) for the output cotangent ``g``
    (B, N, F); rows of ``g`` past ``update_rows`` are ignored.  ``precision``:
    the tier of the three products.

    Returns (da_row, da_col, dx, dx0, dw_d2, dw_d20, ddelta, dw2, db2, dw_att,
    db_att); ddelta is None without delta, dw_att and db_att without attention.
    CPU tensors take the plain version, CUDA tensors the kernel.
    """
    check_tier("gcl_agg_bwd", precision)
    kw = dict(cutoffs=cutoffs, attention=attention,
              normalization_factor=normalization_factor, col_mask=col_mask,
              update_rows=update_rows, precision=precision)
    if a_row.device.type == "cpu":
        _count_plain("gcl_agg_bwd", x0, mask, col_mask, is_lig, cutoffs, update_rows)
        return gcl_agg_bwd_plain(g, a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20,
                                 delta, w2, b2, w_att, b_att, **kw)
    if a_row.device.type != "cuda":
        raise ValueError(f"gcl_agg_bwd: unsupported device {a_row.device}")
    B, N, F = a_row.shape
    dev = a_row.device
    width = padded_width(F, "gcl_agg_bwd", "gcl_agg_bwd")
    if width != F:
        ops = pad_operands(dict(a_row=a_row, a_col=a_col, w_d2=w_d2, w_d20=w_d20,
                                delta=delta, w2=w2, b2=b2, w_att=w_att), F, width)
        grads = gcl_agg_bwd(_pad_axes(g, F, width, (-1,), "g"), ops["a_row"],
                            ops["a_col"], x, x0, mask, is_lig, ops["w_d2"], ops["w_d20"],
                            ops["delta"], ops["w2"], ops["b2"], ops["w_att"], b_att, **kw)
        return tuple(unpad_operands(dict(zip(_GCL_COT, grads)), F).values())
    cm = mask if col_mask is None else col_mask
    watt = w_att.reshape(F) if attention else None
    batt = b_att.reshape(1) if attention else None
    _check_mlp("gcl_agg_bwd", "", dict(a_row=a_row, a_col=a_col, w_d2=w_d2,
                                       w_d20=w_d20, delta=delta, w2=w2, b2=b2),
               B, N, F, dev)
    _check("gcl_agg_bwd",
           dict(g=g, x=x, x0=x0, mask=mask, col_mask=cm, is_lig=is_lig, w_att=watt,
                b_att=batt),
           dict(_node_shapes(B, N), g=(B, N, F), w_att=(F,), b_att=(1,)), dev)
    if w2.data_ptr() % 16:
        raise ValueError("gcl_agg_bwd: w2 must be 16-byte aligned (cp.async)")
    rows = _rows(update_rows, N)
    Q = _blocks_per_batch(B, min(rows, N), dev, F)
    slab = F * F + 6 * F
    zeros = lambda *shape: torch.zeros(shape, device=dev, dtype=torch.float32)
    empty = lambda *shape: torch.empty(shape, device=dev, dtype=torch.float32)
    da_row, acol_part = zeros(B, N, F), zeros(B, Q, N, F)
    dx_part, w_part = zeros(B, Q, N, 6), zeros(B * Q, slab)
    da_col, dxx0, w_out = empty(B, N, F), empty(B, N, 6), empty(slab)
    w2t = w2.t().contiguous()
    _launch("gcl_agg_bwd",
            _ptr(g), _ptr(a_row), _ptr(a_col), _ptr(x), _ptr(x0), _ptr(mask),
            _ptr(cm), _ptr(is_lig), _ptr(w_d2), _ptr(w_d20), _ptr(delta), _ptr(w2),
            _ptr(w2t), _ptr(b2), _ptr(watt), _ptr(batt),
            _cut2(cutoffs[0]), _cut2(cutoffs[1]), _cut2(cutoffs[2]),
            float(normalization_factor), B, N, F, rows, Q,
            _ptr(da_row), _ptr(acol_part), _ptr(dx_part), _ptr(w_part),
            _ptr(da_col), _ptr(dxx0), _ptr(w_out), tier=precision)
    dw2, vec = _split_weight_slab(w_out, F)
    return (da_row, da_col, dxx0[..., :3], dxx0[..., 3:], vec[0], vec[1],
            None if delta is None else vec[2], dw2, vec[3],
            vec[4].reshape(F, 1) if attention else None,
            vec[5, :1] if attention else None)


def _coord_forward_cuda(main, c, x, x0, mask, cm, is_lig, gm, cutoffs, tanh,
                        coords_range, norm_constant, nf, update_rows, tier):
    B, N, F = main["a_row"].shape
    dev = main["a_row"].device
    _check_mlp("coord_update_agg", "", main, B, N, F, dev)
    _check_mlp("coord_update_agg", "cross.", c, B, N, F, dev)
    _check("coord_update_agg",
           dict(x=x, x0=x0, mask=mask, col_mask=cm, is_lig=is_lig, graph_mean=gm),
           _node_shapes(B, N), dev)
    for key, w2 in (("w2", main["w2"]), ("cross.w2", c["w2"])):
        if w2 is not None and w2.data_ptr() % 16:
            raise ValueError(f"coord_update_agg: {key} must be 16-byte aligned (cp.async)")
    out = torch.empty((B, N, 3), device=dev, dtype=torch.float32)
    # the two MLPs' terms, summed into out by the kernel's second launch
    partial = None if c["a_row"] is None else \
        torch.empty((2, B, N, 3), device=dev, dtype=torch.float32)
    _launch("coord_agg",
            *(_ptr(main[k]) for k in _MLP_KEYS), *(_ptr(c[k]) for k in _MLP_KEYS),
            _ptr(x), _ptr(x0), _ptr(mask), _ptr(cm), _ptr(is_lig), _ptr(gm),
            int(bool(tanh)), float(coords_range), float(norm_constant), float(nf),
            _cut2(cutoffs[0]), _cut2(cutoffs[1]), _cut2(cutoffs[2]),
            B, N, F, _rows(update_rows, N), _ptr(partial), out.data_ptr(), tier=tier)
    return out


_NO_MLP = dict.fromkeys(_MLP_KEYS)


def coord_agg_bwd(g, a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, delta, w2, b2,
                  w3, *, cutoffs, tanh, coords_range, norm_constant,
                  normalization_factor, cross=None, graph_mean=None,
                  col_mask=None, update_rows=None, precision=DEFAULT_TIER):
    """Cotangents of ``coord_update_agg`` on folded operands for the output
    cotangent ``g`` (B, N, 3); rows of ``g`` past ``update_rows`` are ignored.
    ``cross``: dict(a_row, a_col, w_d2, w_d20, delta, w2, b2, w3) or None.
    ``precision``: the tier of each MLP's three products.

    Returns (main, cross, dmean): main = (da_row, da_col, dx, dx0, dw_d2,
    dw_d20, ddelta, dw2, db2, dw3); cross the same cotangents of the cross MLP
    as a dict keyed like ``cross`` (None without it); dmean (B, 3) or None.
    The two w3 cotangents come back separately even where the heads are tied.
    CPU tensors take the plain version, CUDA tensors the kernel.
    """
    check_tier("coord_agg_bwd", precision)
    kw = dict(cutoffs=cutoffs, tanh=tanh, coords_range=coords_range,
              norm_constant=norm_constant,
              normalization_factor=normalization_factor, cross=cross,
              graph_mean=graph_mean, col_mask=col_mask, update_rows=update_rows,
              precision=precision)
    if a_row.device.type == "cpu":
        _count_plain("coord_agg_bwd", x0, mask, col_mask, is_lig, cutoffs, update_rows)
        return coord_agg_bwd_plain(g, a_row, a_col, x, x0, mask, is_lig, w_d2,
                                   w_d20, delta, w2, b2, w3, **kw)
    if a_row.device.type != "cuda":
        raise ValueError(f"coord_agg_bwd: unsupported device {a_row.device}")
    B, N, F = a_row.shape
    dev = a_row.device
    main = dict(a_row=a_row, a_col=a_col, w_d2=w_d2, w_d20=w_d20, delta=delta,
                w2=w2, b2=b2, w3=w3)
    width = padded_width(F, "coord_agg_bwd", "coord_agg_bwd")
    if width != F:
        ops = pad_operands(dict(main, cross=cross), F, width)
        kw["cross"] = ops.pop("cross")
        main_cot, cross_cot, dmean = coord_agg_bwd(
            g, ops["a_row"], ops["a_col"], x, x0, mask, is_lig, ops["w_d2"], ops["w_d20"],
            ops["delta"], ops["w2"], ops["b2"], ops["w3"], **kw)
        return (tuple(unpad_operands(dict(zip(_COORD_COT, main_cot)), F).values()),
                None if cross_cot is None else unpad_operands(cross_cot, F), dmean)
    c = _NO_MLP if cross is None else {k: cross[k] for k in _MLP_KEYS}
    if cross is not None and graph_mean is None:
        raise ValueError("coord_agg_bwd: the cross branch needs graph_mean")
    gm = None if cross is None else graph_mean
    cm = mask if col_mask is None else col_mask
    _check_mlp("coord_agg_bwd", "", main, B, N, F, dev)
    _check_mlp("coord_agg_bwd", "cross.", c, B, N, F, dev)
    _check("coord_agg_bwd",
           dict(g=g, x=x, x0=x0, mask=mask, col_mask=cm, is_lig=is_lig, graph_mean=gm),
           dict(_node_shapes(B, N), g=(B, N, 3)), dev)
    for key, w in (("w2", w2), ("cross.w2", c["w2"])):
        if w is not None and w.data_ptr() % 16:
            raise ValueError(f"coord_agg_bwd: {key} must be 16-byte aligned (cp.async)")
    rows = _rows(update_rows, N)
    Q = _blocks_per_batch(B, min(rows, N), dev, F)
    slab = F * F + 6 * F
    zeros = lambda *shape: torch.zeros(shape, device=dev, dtype=torch.float32)
    empty = lambda *shape: torch.empty(shape, device=dev, dtype=torch.float32)
    out = dict(da_row=zeros(B, N, F), acol_part=zeros(B, Q, N, F),
               dx_part=zeros(B, Q, N, 6), w_part=zeros(B * Q, slab),
               da_col=empty(B, N, F), dxx0=empty(B, N, 6), w_out=empty(slab))
    co = dict.fromkeys(("dc_row", "ccol_part", "mean_part", "cw_part", "dc_col",
                        "dmean", "cw_out"))
    if cross is not None:
        co = dict(dc_row=zeros(B, N, F), ccol_part=zeros(B, Q, N, F),
                  mean_part=zeros(B, Q, 3), cw_part=zeros(B * Q, slab),
                  dc_col=empty(B, N, F), dmean=empty(B, 3), cw_out=empty(slab))
    w2t = w2.t().contiguous()
    cw2t = None if cross is None else c["w2"].t().contiguous()

    def mlp_ptrs(m, wt):
        return (_ptr(m["a_row"]), _ptr(m["a_col"]), _ptr(m["w_d2"]), _ptr(m["w_d20"]),
                _ptr(m["delta"]), _ptr(m["w2"]), _ptr(wt), _ptr(m["b2"]),
                _ptr(None if m["w3"] is None else m["w3"].reshape(F)))

    _launch("coord_agg_bwd",
            _ptr(g), *mlp_ptrs(main, w2t), *mlp_ptrs(c, cw2t),
            _ptr(x), _ptr(x0), _ptr(mask), _ptr(cm), _ptr(is_lig), _ptr(gm),
            int(bool(tanh)), float(coords_range), float(norm_constant),
            float(normalization_factor),
            _cut2(cutoffs[0]), _cut2(cutoffs[1]), _cut2(cutoffs[2]),
            B, N, F, rows, Q,
            _ptr(out["da_row"]), _ptr(co["dc_row"]), _ptr(out["acol_part"]),
            _ptr(co["ccol_part"]), _ptr(out["dx_part"]), _ptr(co["mean_part"]),
            _ptr(out["w_part"]), _ptr(co["cw_part"]),
            _ptr(out["da_col"]), _ptr(co["dc_col"]), _ptr(out["dxx0"]),
            _ptr(co["dmean"]), _ptr(out["w_out"]), _ptr(co["cw_out"]), tier=precision)

    def cotangents(row, col, w_out, has_delta):
        dw2, vec = _split_weight_slab(w_out, F)
        return dict(a_row=row, a_col=col, w_d2=vec[0], w_d20=vec[1],
                    delta=vec[2] if has_delta else None, w2=dw2, b2=vec[3],
                    w3=vec[4].reshape(F, 1))

    m = cotangents(out["da_row"], out["da_col"], out["w_out"], delta is not None)
    main_cot = (m["a_row"], m["a_col"], out["dxx0"][..., :3], out["dxx0"][..., 3:],
                m["w_d2"], m["w_d20"], m["delta"], m["w2"], m["b2"], m["w3"])
    if cross is None:
        return main_cot, None, None
    return (main_cot, cotangents(co["dc_row"], co["dc_col"], co["cw_out"],
                                 c["delta"] is not None), co["dmean"])


# ---------------------------------------------------------------------------
# autograd: kernel forward, kernel backward
# ---------------------------------------------------------------------------

class _GclAggFn(torch.autograd.Function):
    """``gcl_message_agg`` over folded operands: the forward kernel at the
    forward tier, the backward kernel at the backward tier.  Forward saves the
    operands only; backward recomputes the pair MLP inside its kernel, or
    with ``mirror`` differentiates the float32 plain version instead.  On
    the CPU (a tier other than 3xTF32) the plain versions of both, at their
    tiers."""

    @staticmethod
    def forward(ctx, a_row, a_col, x, x0, w_d2, w_d20, delta, w2, b2, w_att, b_att,
                mask, col_mask, is_lig, cfg):
        cutoffs, attention, nf, update_rows, tier, _, _ = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(a_row, a_col, x, x0, w_d2, w_d20, delta, w2, b2,
                              w_att, b_att, mask, col_mask, is_lig)
        if a_row.device.type == "cpu":
            _count_plain("gcl_agg", x0, mask, col_mask, is_lig, cutoffs, update_rows)
            return gcl_message_agg_plain(
                a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, _delta_table(delta),
                w2, b2, w_att, b_att, cutoffs=cutoffs, attention=attention,
                normalization_factor=nf, col_mask=col_mask, update_rows=update_rows,
                precision=tier)
        return _gcl_forward_cuda(
            a_row, a_col, x, x0, mask, mask if col_mask is None else col_mask,
            is_lig, w_d2, w_d20, delta, w2, b2, w_att if attention else None,
            b_att if attention else None, cutoffs, nf, update_rows, tier)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (a_row, a_col, x, x0, w_d2, w_d20, delta, w2, b2, w_att, b_att, mask,
         col_mask, is_lig) = ctx.saved_tensors
        cutoffs, attention, nf, update_rows, _, bwd_tier, mirror = ctx.cfg
        bwd = gcl_agg_bwd_plain if mirror else gcl_agg_bwd
        grads = bwd(
            g.contiguous(), a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, delta,
            w2, b2, w_att, b_att, cutoffs=cutoffs, attention=attention,
            normalization_factor=nf, col_mask=col_mask, update_rows=update_rows,
            precision=DEFAULT_TIER if mirror else bwd_tier)
        return (*grads, None, None, None, None)


class _CoordAggFn(torch.autograd.Function):
    """``coord_update_agg`` over folded operands, as ``_GclAggFn``: the masks,
    10 tensors of the coordinate MLP and the coordinates, then (with the cross
    branch) the 8 of the cross MLP and the graph mean."""

    @staticmethod
    def forward(ctx, cfg, mask, col_mask, is_lig, a_row, a_col, x, x0, w_d2, w_d20,
                delta, w2, b2, w3, *cross_ops):
        cutoffs, tanh, coords_range, norm_constant, nf, update_rows, tier, _, _ = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(mask, col_mask, is_lig, a_row, a_col, x, x0, w_d2,
                              w_d20, delta, w2, b2, w3, *cross_ops)
        main = dict(a_row=a_row, a_col=a_col, w_d2=w_d2, w_d20=w_d20, delta=delta,
                    w2=w2, b2=b2, w3=w3)
        c, gm = _NO_MLP, None
        if cross_ops:
            c, gm = dict(zip(_MLP_KEYS, cross_ops[:-1])), cross_ops[-1]
        if a_row.device.type == "cpu":
            cross = None
            if cross_ops:
                cross = dict(c, type_bias=_delta_table(c["delta"]))
            _count_plain("coord_agg", x0, mask, col_mask, is_lig, cutoffs, update_rows)
            return coord_update_agg_plain(
                a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, _delta_table(delta),
                w2, b2, w3, cutoffs=cutoffs, tanh=tanh, coords_range=coords_range,
                norm_constant=norm_constant, normalization_factor=nf, cross=cross,
                graph_mean=gm, col_mask=col_mask, update_rows=update_rows,
                precision=tier)
        return _coord_forward_cuda(main, c, x, x0, mask,
                                   mask if col_mask is None else col_mask, is_lig, gm,
                                   cutoffs, tanh, coords_range, norm_constant, nf,
                                   update_rows, tier)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        mask, col_mask, is_lig, *ops = ctx.saved_tensors
        main_ops, cross_ops = ops[:10], ops[10:]
        (cutoffs, tanh, coords_range, norm_constant, nf, update_rows, _, bwd_tier,
         mirror) = ctx.cfg
        cross = dict(zip(_MLP_KEYS, cross_ops[:-1])) if cross_ops else None
        bwd = coord_agg_bwd_plain if mirror else coord_agg_bwd
        main_cot, cross_cot, dmean = bwd(
            g.contiguous(), *main_ops[:4], mask, is_lig, *main_ops[4:],
            cutoffs=cutoffs, tanh=tanh, coords_range=coords_range,
            norm_constant=norm_constant, normalization_factor=nf, cross=cross,
            graph_mean=cross_ops[-1] if cross_ops else None, col_mask=col_mask,
            update_rows=update_rows, precision=DEFAULT_TIER if mirror else bwd_tier)
        grads = (None, None, None, None) + tuple(main_cot)
        if cross_ops:
            grads += tuple(cross_cot[k] for k in _MLP_KEYS) + (dmean,)
        return grads


# ---------------------------------------------------------------------------
# public wrappers: plain twin on the CPU, kernels on CUDA
# ---------------------------------------------------------------------------

def _tiers(name, precision, bwd_precision):
    """(forward tier, backward tier): the backward's is the forward's when
    None."""
    fwd = check_tier(name, precision)
    return fwd, check_tier(name, fwd if bwd_precision is None else bwd_precision)


def gcl_message_agg(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20,
                    type_bias, w2, b2, w_att, b_att, *, cutoffs, attention,
                    normalization_factor, col_mask=None, update_rows=None,
                    precision=DEFAULT_TIER, bwd_precision=None, mirror_bwd=False):
    """Aggregated attention-gated GCL messages -> (B, N, F).

    a_row/a_col: per-node projections of h through the split first-layer
    kernel (first-layer bias folded into a_row); w_d2/w_d20: the first-layer
    rows of the two distance features; type_bias: optional (2, 2, F)
    projected edge-type table; w2 (F, F) input-major, w_att (F, 1), b_att (1,).
    ``col_mask`` restricts the neighbour side; rows >= ``update_rows`` are
    exact zeros.  ``precision``: the forward kernel's tier, ``bwd_precision``
    the backward kernel's (None: the forward's).  Differentiable on both
    devices: by plain autograd through the twin on the CPU at 3xTF32, through
    the forward and backward kernels on CUDA, and through the plain versions
    of both at their tiers on the CPU otherwise (the edge-type fold stays
    outside them, so autograd chains through it).  ``mirror_bwd``: the
    backward is autograd through the float32 twin (no backward kernel, no
    ``bwd_precision``), the forward's output the kernel's.  On CUDA a width
    above 4096 raises before any launch (``padded_width``), and so would one
    whose gradient will be due at a width the backward kernel is not built
    for, unless ``mirror_bwd`` (``_refuse_untrainable_width``).
    """
    tiers = _tiers("gcl_agg", precision, bwd_precision)
    if a_row.device.type == "cpu" and tiers == (DEFAULT_TIER, DEFAULT_TIER):
        _count_plain("gcl_agg", x0, mask, col_mask, is_lig, cutoffs, update_rows)
        return gcl_message_agg_plain(
            a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, type_bias, w2, b2,
            w_att, b_att, cutoffs=cutoffs, attention=attention,
            normalization_factor=normalization_factor, col_mask=col_mask,
            update_rows=update_rows)
    if a_row.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gcl_message_agg: unsupported device {a_row.device}")
    F = a_row.shape[-1]
    width = F
    if a_row.device.type == "cuda":
        width = padded_width(F, "gcl_message_agg", "gcl_agg")
        if not mirror_bwd:
            _refuse_untrainable_width("gcl_message_agg", "gcl_agg_bwd", F, (
                a_row, a_col, x, x0, w_d2, w_d20, type_bias, w2, b2, w_att, b_att))
    if width != F:
        ops = pad_operands(dict(a_row=a_row, a_col=a_col, w_d2=w_d2, w_d20=w_d20,
                                type_bias=type_bias, w2=w2, b2=b2, w_att=w_att),
                           F, width)
        return gcl_message_agg(
            ops["a_row"], ops["a_col"], x, x0, mask, is_lig, ops["w_d2"], ops["w_d20"],
            ops["type_bias"], ops["w2"], ops["b2"], ops["w_att"], b_att, cutoffs=cutoffs,
            attention=attention, normalization_factor=normalization_factor,
            col_mask=col_mask, update_rows=update_rows, precision=precision,
            bwd_precision=bwd_precision, mirror_bwd=mirror_bwd)[..., :F]
    a_row, a_col, delta = fold_type_bias(a_row, a_col, is_lig, type_bias)
    cfg = (tuple(cutoffs), bool(attention), float(normalization_factor),
           None if update_rows is None else int(update_rows), *tiers, bool(mirror_bwd))
    return _GclAggFn.apply(a_row.contiguous(), a_col.contiguous(), x, x0, w_d2,
                           w_d20, delta, w2, b2, w_att, b_att, mask, col_mask,
                           is_lig, cfg)


def coord_update_agg(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20,
                     type_bias, w2, b2, w3, *, cutoffs, tanh, coords_range,
                     norm_constant, normalization_factor, cross=None,
                     graph_mean=None, col_mask=None, update_rows=None,
                     precision=DEFAULT_TIER, bwd_precision=None, mirror_bwd=False):
    """Coordinate-update aggregation -> (B, N, 3).

    ``cross``: dict(a_row, a_col, w_d2, w_d20, type_bias, w2, b2, w3) of the
    SE(3) cross-product MLP (None when reflection-equivariant), with
    ``graph_mean`` (B, 3) the masked mean of the current coordinates.  w3
    (F, 1) is the scalar head.  ``col_mask`` restricts the neighbour side (a
    column block under edge-axis sharding; ``mask`` when None).  Rows >=
    ``update_rows`` are exact zeros.  ``precision``, ``bwd_precision``,
    ``mirror_bwd``: as ``gcl_message_agg``'s.  Differentiable on both devices, as
    ``gcl_message_agg`` is; its widths as ``gcl_message_agg``'s.
    """
    tiers = _tiers("coord_agg", precision, bwd_precision)
    if a_row.device.type == "cpu" and tiers == (DEFAULT_TIER, DEFAULT_TIER):
        _count_plain("coord_agg", x0, mask, col_mask, is_lig, cutoffs, update_rows)
        return coord_update_agg_plain(
            a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20, type_bias, w2, b2, w3,
            cutoffs=cutoffs, tanh=tanh, coords_range=coords_range,
            norm_constant=norm_constant,
            normalization_factor=normalization_factor, cross=cross,
            graph_mean=graph_mean, col_mask=col_mask, update_rows=update_rows)
    if a_row.device.type not in ("cpu", "cuda"):
        raise ValueError(f"coord_update_agg: unsupported device {a_row.device}")
    F = a_row.shape[-1]
    width = F
    if a_row.device.type == "cuda":
        width = padded_width(F, "coord_update_agg", "coord_agg")
        if not mirror_bwd:
            _refuse_untrainable_width("coord_update_agg", "coord_agg_bwd", F, (
                a_row, a_col, x, x0, w_d2, w_d20, type_bias, w2, b2, w3, graph_mean,
                *(cross or {}).values()))
    if width != F:
        ops = pad_operands(dict(a_row=a_row, a_col=a_col, w_d2=w_d2, w_d20=w_d20,
                                type_bias=type_bias, w2=w2, b2=b2, w3=w3, cross=cross),
                           F, width)
        return coord_update_agg(
            ops["a_row"], ops["a_col"], x, x0, mask, is_lig, ops["w_d2"], ops["w_d20"],
            ops["type_bias"], ops["w2"], ops["b2"], ops["w3"], cutoffs=cutoffs, tanh=tanh,
            coords_range=coords_range, norm_constant=norm_constant,
            normalization_factor=normalization_factor, cross=ops["cross"],
            graph_mean=graph_mean, col_mask=col_mask, update_rows=update_rows,
            precision=precision, bwd_precision=bwd_precision, mirror_bwd=mirror_bwd)
    a_row, a_col, delta = fold_type_bias(a_row, a_col, is_lig, type_bias)
    cross_ops = ()
    if cross is not None:
        if graph_mean is None:
            raise ValueError("coord_update_agg: the cross branch needs graph_mean")
        c_row, c_col, c_delta = fold_type_bias(cross["a_row"], cross["a_col"],
                                               is_lig, cross["type_bias"])
        cross_ops = (c_row.contiguous(), c_col.contiguous(), cross["w_d2"],
                     cross["w_d20"], c_delta, cross["w2"], cross["b2"],
                     cross["w3"], graph_mean)
    cfg = (tuple(cutoffs), bool(tanh), float(coords_range), float(norm_constant),
           float(normalization_factor),
           None if update_rows is None else int(update_rows), *tiers, bool(mirror_bwd))
    return _CoordAggFn.apply(cfg, mask, col_mask, is_lig, a_row.contiguous(),
                             a_col.contiguous(), x, x0, w_d2, w_d20, delta, w2, b2,
                             w3, *cross_ops)


# ---------------------------------------------------------------------------
# the whole-block kernel
# ---------------------------------------------------------------------------

def _pack_block(gcl, node, coord, cross, graph_mean):
    """The parameter dicts of ``block_fused`` as one flat tuple (None where a
    piece is absent): gcl, node, coord, then cross and graph_mean if any."""
    ops = tuple(gcl.get(k) for k in _GCL_KEYS) + tuple(node[k] for k in _NODE_KEYS) \
        + tuple(coord.get(k) for k in _HEAD_KEYS)
    if cross is not None:
        ops += tuple(cross.get(k) for k in _HEAD_KEYS) + (graph_mean,)
    return ops


def _unpack_block(ops):
    ng, nn_, nh = len(_GCL_KEYS), len(_NODE_KEYS), len(_HEAD_KEYS)
    gcl = dict(zip(_GCL_KEYS, ops[:ng]))
    node = dict(zip(_NODE_KEYS, ops[ng:ng + nn_]))
    coord = dict(zip(_HEAD_KEYS, ops[ng + nn_:ng + nn_ + nh]))
    rest = ops[ng + nn_ + nh:]
    if not rest:
        return gcl, node, coord, None, None
    return gcl, node, coord, dict(zip(_HEAD_KEYS, rest[:nh])), rest[nh]


def block_fused_bwd_plain(g_h, g_dx, h, a_row, a_col, x, x0, mask, is_lig, gcl, node,
                          coord, cross=None, graph_mean=None, **kw):
    """Cotangents of ``block_fused`` for the output cotangents ``g_h`` (B, N, H)
    and ``g_dx`` (B, N, 3): autograd through the plain version.  Returns one
    cotangent (or None) for each of h, a_row, a_col, x, x0 and then for each
    entry of the flat parameter tuple (``_pack_block`` order)."""
    with torch.enable_grad():
        lv = _leaves([h, a_row, a_col, x, x0,
                      *_pack_block(gcl, node, coord, cross, graph_mean)])
        out = block_fused_plain(*lv[:5], mask, is_lig, *_unpack_block(lv[5:]), **kw)
        live = [t for t in lv if t is not None]
        found = iter(torch.autograd.grad(out, live, grad_outputs=(g_h, g_dx),
                                         allow_unused=True))
    return [None if t is None else next(found) for t in lv]


def _block_forward_cuda(h, a_row, a_col, x, x0, mask, is_lig, gcl, node, coord,
                        cross, graph_mean, cutoffs, attention, tanh, coords_range,
                        norm_constant, nf, update_rows, tier):
    B, N, F = a_row.shape
    dev = a_row.device
    name = "block_fused"
    watt = gcl["w_att"].reshape(F) if attention else None
    batt = gcl["b_att"].reshape(1) if attention else None
    _check(name, dict(h=h, a_row=a_row, a_col=a_col, x=x, x0=x0, mask=mask,
                      is_lig=is_lig, graph_mean=graph_mean),
           dict(_node_shapes(B, N), h=(B, N, F), a_row=(B, N, F), a_col=(B, N, F)), dev)
    _check(name, {"gcl." + k: v for k, v in dict(gcl, w_att=watt, b_att=batt).items()},
           {"gcl.w_d2": (F,), "gcl.w_d20": (F,), "gcl.type_delta": (F,),
            "gcl.w2": (F, F), "gcl.b2": (F,), "gcl.w_att": (F,), "gcl.b_att": (1,)}, dev)
    _check(name, {"node." + k: v for k, v in node.items()},
           {"node.w_h": (F, F), "node.w_a": (F, F), "node.b0": (F,),
            "node.w2": (F, F), "node.b2": (F,)}, dev)
    head_shapes = dict(k_i=(F, F), k_j=(F, F), b0=(F,), w_d2=(F,), w_d20=(F,),
                       type_bias=(2, 2, F), w1=(F, F), b1=(F,), w3=(F, 1))
    c = dict.fromkeys(_HEAD_KEYS) if cross is None else cross
    for prefix, hd in (("coord.", coord), ("cross.", c)):
        _check(name, {prefix + k: hd.get(k) for k in _HEAD_KEYS},
               {prefix + k: v for k, v in head_shapes.items()}, dev)
    if cross is not None and graph_mean is None:
        raise ValueError(f"{name}: the cross branch needs graph_mean")
    mats = {"gcl.w2": gcl["w2"], **{f"node.{k}": node[k] for k in ("w_h", "w_a", "w2")},
            **{f"{p}.{k}": hd.get(k) for p, hd in (("coord", coord), ("cross", c))
               for k in ("k_i", "k_j", "w1")}}
    if cluster_size(F) > 1:
        mats["h"] = h  # phase A reads its rows in 16-byte vectors above 1024
    for key, w in mats.items():
        if w is not None and w.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned (16-byte copies)")
    out_h = torch.empty((B, N, F), device=dev, dtype=torch.float32)
    out_dx = torch.empty((B, N, 3), device=dev, dtype=torch.float32)
    # the heads' projections (and above F = 1024 the GCL aggregates, which
    # pass through device memory there), their type deltas and phase B's two
    # partial slabs
    planes = 4 + (cluster_size(F) > 1)
    scratch = torch.empty(planes * B * N * F + 2 * F + 2 * B * N * 3, device=dev,
                          dtype=torch.float32)
    _launch(name,
            _ptr(h), _ptr(a_row), _ptr(a_col), _ptr(x), _ptr(x0), _ptr(mask),
            _ptr(is_lig),
            _ptr(gcl["w_d2"]), _ptr(gcl["w_d20"]), _ptr(gcl.get("type_delta")),
            _ptr(gcl["w2"]), _ptr(gcl["b2"]), _ptr(watt), _ptr(batt),
            *(_ptr(node[k]) for k in _NODE_KEYS),
            *(_ptr(coord.get(k)) for k in _HEAD_KEYS),
            *(_ptr(c.get(k)) for k in _HEAD_KEYS),
            _ptr(None if cross is None else graph_mean), _ptr(scratch),
            int(bool(tanh)), float(coords_range), float(norm_constant), float(nf),
            _cut2(cutoffs[0]), _cut2(cutoffs[1]), _cut2(cutoffs[2]),
            B, N, F, _rows(update_rows, N), _block_grid(B, N, dev, F), _ptr(out_h),
            _ptr(out_dx), tier=tier)
    return out_h, out_dx


class _BlockFusedFn(torch.autograd.Function):
    """``block_fused`` on CUDA: the kernel forward at its tier; backward is
    autograd through the plain version at that tier (sampling runs under
    ``no_grad`` and never reaches it)."""

    @staticmethod
    def forward(ctx, cfg, mask, is_lig, *ops):
        ctx.cfg = cfg
        ctx.save_for_backward(mask, is_lig, *ops)
        gcl, node, coord, cross, graph_mean = _unpack_block(ops[5:])
        return _block_forward_cuda(*ops[:5], mask, is_lig, gcl, node, coord, cross,
                                   graph_mean, *cfg)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_h, g_dx):
        mask, is_lig, *ops = ctx.saved_tensors
        (cutoffs, attention, tanh, coords_range, norm_constant, nf, update_rows,
         tier) = ctx.cfg
        grads = block_fused_bwd_plain(
            g_h, g_dx, *ops[:5], mask, is_lig, *_unpack_block(ops[5:]),
            cutoffs=cutoffs, attention=attention, tanh=tanh,
            coords_range=coords_range, norm_constant=norm_constant,
            normalization_factor=nf, update_rows=update_rows, precision=tier)
        return (None, None, None, *grads)


def block_fused(h, a_row, a_col, x, x0, mask, is_lig, gcl, node, coord, cross=None,
                graph_mean=None, *, cutoffs, attention, tanh, coords_range,
                norm_constant, normalization_factor, update_rows=None,
                precision=DEFAULT_TIER):
    """One EGNN block with one GCL -> (h_new (B, N, H), dx (B, N, 3)).

    h: block-entry node features; a_row/a_col: the GCL's first-layer
    projections of h with the edge-type table already folded
    (``fold_type_bias``).  Parameter dicts, every matrix input-major:

      gcl   = {w_d2, w_d20, type_delta (F,)|None, w2, b2, w_att|None, b_att|None}
      node  = {w_h (H, F), w_a (F, F), b0 (F,), w2 (F, H), b2 (H,)}
      coord = {k_i (H, F), k_j (H, F), b0 (F,), w_d2 (F,), w_d20 (F,),
               type_bias (2, 2, F)|None, w1 (F, F), b1 (F,), w3 (F, 1)}
      cross = the same fields as coord (needs graph_mean (B, 3)), or None

    dx rows >= ``update_rows`` are exact zeros.  ``precision``: the tier of
    every product, that tier's library on CUDA and its emulation on the CPU.
    CPU tensors take the plain version, CUDA tensors the kernel (H == F
    there); differentiable on both, on CUDA by autograd through the plain
    version.
    """
    kw = dict(cutoffs=tuple(cutoffs), attention=bool(attention), tanh=bool(tanh),
              coords_range=float(coords_range), norm_constant=float(norm_constant),
              normalization_factor=float(normalization_factor),
              update_rows=None if update_rows is None else int(update_rows),
              precision=check_tier("block_fused", precision))
    if a_row.device.type == "cpu":
        # its two phases: the GCL on every row, the coordinate update below
        # update_rows
        _count_plain("block_fused", x0, mask, None, is_lig, cutoffs, None)
        _count_plain("block_fused", x0, mask, None, is_lig, cutoffs, update_rows)
        return block_fused_plain(h, a_row, a_col, x, x0, mask, is_lig, gcl, node,
                                 coord, cross, graph_mean, **kw)
    if a_row.device.type != "cuda":
        raise ValueError(f"block_fused: unsupported device {a_row.device}")
    F = a_row.shape[-1]
    if h.shape[-1] != F:
        raise ValueError(f"block_fused: node width {h.shape[-1]} != message width {F}")
    width = padded_width(F, "block_fused", "block_fused")
    if width != F:
        ops = pad_operands(dict(h=h, a_row=a_row, a_col=a_col, gcl=gcl, node=node,
                                coord=coord, cross=cross), F, width)
        h_new, dx = block_fused(ops["h"], ops["a_row"], ops["a_col"], x, x0, mask, is_lig,
                                ops["gcl"], ops["node"], ops["coord"], ops["cross"],
                                graph_mean, **kw)
        return h_new[..., :F], dx
    cfg = tuple(kw.values())
    return _BlockFusedFn.apply(cfg, mask, is_lig, h, a_row, a_col, x, x0,
                               *_pack_block(gcl, node, coord, cross, graph_mean))
