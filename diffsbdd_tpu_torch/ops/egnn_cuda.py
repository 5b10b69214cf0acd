"""Hand-written CUDA kernels for the EGNN hot loop, with their plain twins.

Two kernels carry the sampling path (sources in ``diffsbdd_tpu_torch/csrc``):

* ``gcl_message_agg``  -- edge MLP + sigmoid attention + masked row sum of one
  GCL layer (``csrc/gcl_agg.cu``);
* ``coord_update_agg`` -- coordinate MLP (+ the SE(3) cross-product MLP) +
  tanh clamping + masked row sum of the relative-direction translations
  (``csrc/coord_agg.cu``).

Both rebuild the adjacency from the EGNN input coordinates ``x0``, the node
masks and the per-pair-type distance cutoffs, so the (B, N, N) adjacency and
the (B, N, N, F) message tensors never exist in memory.

Each wrapper takes its plain PyTorch twin (``*_plain``) when its tensors lie on
the CPU, and launches its kernel when they lie on a CUDA device; there is no
fallback from one to the other.  The twins are the CPU path and the kernels'
test oracle.  Each launch adds one to ``launch_counts[name]``.

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
KERNELS = ("gcl_agg", "coord_agg")
HEADERS = (CSRC / "egnn_common.cuh",)  # device code both kernels include
SUPPORTED_F = (64, 256)  # the fixture checkpoint's width and the flagship's
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "gcl_agg": ("gcl_agg_forward",
                [_P] * 14 + [_F] * 4 + [_I] * 4 + [_P, _P]),
    "coord_agg": ("coord_agg_forward",
                  [_P] * 21 + [_I] + [_F] * 6 + [_I] * 4 + [_P, _P]),
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_kernels(names: Sequence[str] = KERNELS, force: bool = False) -> Dict[str, str]:
    """Compile the named kernels, one ``nvcc`` process each, all started
    together.  Returns the compiler output (register and shared-memory use
    from ``-Xptxas -v``) by kernel; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = CSRC / f"{name}.cu", _lib_path(name)
        newest = max(p.stat().st_mtime for p in (src, *HEADERS))
        if not force and lib.exists() and lib.stat().st_mtime >= newest:
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs = {}
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)
    return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
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


def _launch(name: str, *args) -> None:
    fn = getattr(_lib(name), _ARGTYPES[name][0])
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    launch_counts[name] += 1


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


def gcl_message_agg_plain(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20,
                          type_bias, w2, b2, w_att, b_att, *, cutoffs,
                          attention, normalization_factor, col_mask=None,
                          update_rows=None):
    """Dense twin of the GCL kernel (same math, O(N^2 F) in memory)."""
    silu = torch.nn.functional.silu
    d2 = _pair_d2(x)
    d2_0 = _pair_d2(x0)
    pre = a_row[:, :, None, :] + a_col[:, None, :, :] + _edge_bias_dense(
        d2, d2_0, w_d2, w_d20, is_lig, type_bias)
    m = silu(silu(pre) @ w2 + b2)
    if attention:
        m = m * torch.sigmoid(m @ w_att + b_att)
    adj = adjacency_dense(d2_0, mask, is_lig, cutoffs, col_mask=col_mask)
    agg = (m * adj[..., None]).sum(2) / normalization_factor
    return _keep_rows(agg, update_rows)


def coord_update_agg_plain(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20,
                           type_bias, w2, b2, w3, *, cutoffs, tanh,
                           coords_range, norm_constant, normalization_factor,
                           cross=None, graph_mean=None, update_rows=None):
    """Dense twin of the coordinate-update kernel."""
    silu = torch.nn.functional.silu
    d2 = _pair_d2(x)
    d2_0 = _pair_d2(x0)
    adj = adjacency_dense(d2_0, mask, is_lig, cutoffs)

    def head(r, c, wd2, wd20, tb, w2_, b2_, w3_):
        pre = r[:, :, None, :] + c[:, None, :, :] + _edge_bias_dense(
            d2, d2_0, wd2, wd20, is_lig, tb)
        phi = (silu(silu(pre) @ w2_ + b2_) @ w3_)[..., 0]
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
# wrappers: plain twin on the CPU, kernel on CUDA
# ---------------------------------------------------------------------------

def _rows(update_rows, N):
    return N if update_rows is None else int(update_rows)


def _check_width(name, F):
    if F not in SUPPORTED_F:
        raise ValueError(f"{name}: feature width {F} not in {SUPPORTED_F}")


def gcl_message_agg(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20,
                    type_bias, w2, b2, w_att, b_att, *, cutoffs, attention,
                    normalization_factor, col_mask=None, update_rows=None):
    """Aggregated attention-gated GCL messages -> (B, N, F).

    a_row/a_col: per-node projections of h through the split first-layer
    kernel (first-layer bias folded into a_row); w_d2/w_d20: the first-layer
    rows of the two distance features; type_bias: optional (2, 2, F)
    projected edge-type table; w2 (F, F) input-major, w_att (F, 1), b_att (1,).
    ``col_mask`` restricts the neighbour side; rows >= ``update_rows`` are
    exact zeros.
    """
    kw = dict(cutoffs=cutoffs, attention=attention,
              normalization_factor=normalization_factor, col_mask=col_mask,
              update_rows=update_rows)
    if a_row.device.type == "cpu":
        return gcl_message_agg_plain(a_row, a_col, x, x0, mask, is_lig, w_d2,
                                     w_d20, type_bias, w2, b2, w_att, b_att,
                                     **kw)
    if a_row.device.type != "cuda":
        raise ValueError(f"gcl_message_agg: unsupported device {a_row.device}")
    B, N, F = a_row.shape
    _check_width("gcl_message_agg", F)
    a_row, a_col, delta = fold_type_bias(a_row, a_col, is_lig, type_bias)
    a_row, a_col = a_row.contiguous(), a_col.contiguous()
    cm = mask if col_mask is None else col_mask
    watt = w_att.reshape(F) if attention else None
    batt = b_att.reshape(1) if attention else None
    _check("gcl_message_agg",
           dict(a_row=a_row, a_col=a_col, x=x, x0=x0, mask=mask, col_mask=cm,
                is_lig=is_lig, w_d2=w_d2, w_d20=w_d20, delta=delta, w2=w2,
                b2=b2, w_att=watt, b_att=batt),
           dict(a_col=(B, N, F), x=(B, N, 3), x0=(B, N, 3), mask=(B, N),
                col_mask=(B, N), is_lig=(B, N), w_d2=(F,), w_d20=(F,),
                delta=(F,), w2=(F, F), b2=(F,), w_att=(F,), b_att=(1,)),
           a_row.device)
    out = torch.empty((B, N, F), device=a_row.device, dtype=torch.float32)
    _launch("gcl_agg",
            _ptr(a_row), _ptr(a_col), _ptr(x), _ptr(x0), _ptr(mask), _ptr(cm),
            _ptr(is_lig), _ptr(w_d2), _ptr(w_d20), _ptr(delta), _ptr(w2),
            _ptr(b2), _ptr(watt), _ptr(batt),
            _cut2(cutoffs[0]), _cut2(cutoffs[1]), _cut2(cutoffs[2]),
            float(normalization_factor), B, N, F, _rows(update_rows, N),
            out.data_ptr())
    return out


def coord_update_agg(a_row, a_col, x, x0, mask, is_lig, w_d2, w_d20,
                     type_bias, w2, b2, w3, *, cutoffs, tanh, coords_range,
                     norm_constant, normalization_factor, cross=None,
                     graph_mean=None, update_rows=None):
    """Coordinate-update aggregation -> (B, N, 3).

    ``cross``: dict(a_row, a_col, w_d2, w_d20, type_bias, w2, b2, w3) of the
    SE(3) cross-product MLP (None when reflection-equivariant), with
    ``graph_mean`` (B, 3) the masked mean of the current coordinates.  w3
    (F, 1) is the scalar head.  Rows >= ``update_rows`` are exact zeros.
    """
    kw = dict(cutoffs=cutoffs, tanh=tanh, coords_range=coords_range,
              norm_constant=norm_constant,
              normalization_factor=normalization_factor, cross=cross,
              graph_mean=graph_mean, update_rows=update_rows)
    if a_row.device.type == "cpu":
        return coord_update_agg_plain(a_row, a_col, x, x0, mask, is_lig, w_d2,
                                      w_d20, type_bias, w2, b2, w3, **kw)
    if a_row.device.type != "cuda":
        raise ValueError(f"coord_update_agg: unsupported device {a_row.device}")
    B, N, F = a_row.shape
    _check_width("coord_update_agg", F)
    a_row, a_col, delta = fold_type_bias(a_row, a_col, is_lig, type_bias)
    c = dict(a_row=None, a_col=None, w_d2=None, w_d20=None, delta=None,
             w2=None, b2=None, w3=None)
    if cross is not None:
        c_row, c_col, c_delta = fold_type_bias(cross["a_row"], cross["a_col"],
                                               is_lig, cross["type_bias"])
        c = dict(a_row=c_row.contiguous(), a_col=c_col.contiguous(),
                 w_d2=cross["w_d2"], w_d20=cross["w_d20"], delta=c_delta,
                 w2=cross["w2"], b2=cross["b2"], w3=cross["w3"].reshape(F))
        if graph_mean is None:
            raise ValueError("coord_update_agg: the cross branch needs graph_mean")
    main = dict(a_row=a_row.contiguous(), a_col=a_col.contiguous(),
                w_d2=w_d2, w_d20=w_d20, delta=delta, w2=w2, b2=b2,
                w3=w3.reshape(F))
    shapes = dict(a_row=(B, N, F), a_col=(B, N, F), w_d2=(F,), w_d20=(F,),
                  delta=(F,), w2=(F, F), b2=(F,), w3=(F,))
    for prefix, d in (("", main), ("cross.", c)):
        _check("coord_update_agg", {prefix + k: v for k, v in d.items()},
               {prefix + k: v for k, v in shapes.items()}, a_row.device)
    gm = None if cross is None else graph_mean
    _check("coord_update_agg",
           dict(x=x, x0=x0, mask=mask, is_lig=is_lig, graph_mean=gm),
           dict(x=(B, N, 3), x0=(B, N, 3), mask=(B, N), is_lig=(B, N),
                graph_mean=(B, 3)),
           a_row.device)
    out = torch.empty((B, N, 3), device=a_row.device, dtype=torch.float32)
    _launch("coord_agg",
            *(_ptr(main[k]) for k in ("a_row", "a_col", "w_d2", "w_d20",
                                      "delta", "w2", "b2", "w3")),
            *(_ptr(c[k]) for k in ("a_row", "a_col", "w_d2", "w_d20",
                                   "delta", "w2", "b2", "w3")),
            _ptr(x), _ptr(x0), _ptr(mask), _ptr(is_lig), _ptr(gm),
            int(bool(tanh)), float(coords_range), float(norm_constant),
            float(normalization_factor),
            _cut2(cutoffs[0]), _cut2(cutoffs[1]), _cut2(cutoffs[2]),
            B, N, F, _rows(update_rows, N), out.data_ptr())
    return out
