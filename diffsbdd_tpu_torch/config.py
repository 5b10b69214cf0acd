"""Config: a recursive namespace over the reference-compatible preset fields.

A config is the defaults below merged with a JSON file (the checkpoint
sidecar) or a YAML preset from ``configs/``, then with explicit overrides.
Only the fields that sampling, training and its evaluation read have
defaults here; other fields of a preset or sidecar pass through unchanged.
PyYAML is imported only when a ``.yml``/``.yaml`` path is given.

The JAX package's ``tpu`` fields, as the port reads them:

* read: ``lig_bucket``, ``pocket_bucket`` (padding), ``kernel_block_fuse``
  (the samplers' whole-block kernel, at every tier below), ``mesh_data``,
  ``multihost`` (``parallel/``), ``nan_check``, and the precision policies
  below;
* ``egnn_impl``: ``auto`` and ``pallas`` run the kernels (their plain
  versions on the CPU); ``xla`` runs the kernels' model on the dense path
  (``EGNNDynamics.dense``: the (B, N, N, F) edge features and messages in
  memory, plain ``torch`` products, no kernel launched, block fusing off), as
  the JAX package's XLA path does, at the glue's precision below and with
  ``compute_dtype``; the kernels' tiers do not apply there;
* ``kernel_bwd``: ``auto`` and ``pallas`` run the backward kernels in
  training; ``xla`` keeps the forward kernels and takes their gradient by
  autograd through the float32 dense mirror (``gcl_agg_bwd_plain``,
  ``coord_agg_bwd_plain`` on the card's tensors; under the edge split on the
  rank's column block), as the JAX package's dense-mirror backward does, so
  ``kernel_bwd_precision`` is then read by nothing (JAX reads its backward
  tier only in the Pallas branch).  Any other value of either raises;
* accepted without effect: ``n_lig_max``, ``n_pocket_max`` (TPU padding
  ceilings; the port pads to each batch's buckets), ``kernel_tile_i``,
  ``kernel_sub_j``, ``kernel_skip_mode``, ``kernel_bwd_sub_j`` (the Pallas
  kernels' tiles and skip granularity; the CUDA kernels choose their own),
  ``remat`` (read by nothing in the JAX package past its defaults) and
  ``steps_per_dispatch`` (it hid a remote TPU's dispatch latency).

Precision policies (JAX's names and defaults; ``PRECISIONS`` below, read by
``models/dynamics.py``):

=================  ===================  ==================================
matmul_precision   kernels' tier        glue products on CUDA (f32 on CPU)
=================  ===================  ==================================
float32 (default)  3xTF32               float32
float32_x3         3xTF32               float32
tensorfloat32      3xTF32               TF32 cuBLAS
float32_x2         2xTF32 (lo*hi+hi*hi) float32
bfloat16           one bf16 pass        TF32 cuBLAS
=================  ===================  ==================================

The bf16 tier's forward kernels also compute the pair MLP at the JAX
package's bf16 rounding points (its ``_pair_mlp``: the inputs, each add and
each step of silu rounded to bf16; ``ops/egnn_cuda.py``); its backward
kernels round only the products' operands.  The glue's
tier is set for each forward and restored after it (the backward's glue
products run in float32).  ``kernel_bwd_precision`` (None: the forward's)
takes the same names for the backward kernels alone.  ``compute_dtype:
bfloat16`` keeps the dense path's pair MLPs in bf16 (sinusoidal features,
mean aggregation; ``gnn_dynamics`` stays float32 as in JAX), their column
sums in float32; the kernels ignore it.  ``kernel_block_fuse`` runs the
whole-block kernel at the same tier as the split kernels: its pair MLPs
round as theirs do, its node MLP and projections only their products (the
tier's library, ``block_fused[bf16]``).  Any other precision name raises, as
JAX's ``_PRECISIONS[name]`` does.

The defaults are the JAX package's, key for key and value for value, less
the ``tpu`` fields accepted without effect above and four keys that no
module of either package reads (``gpus``, ``enable_progress_bar``,
``num_sanity_val_steps``, ``egnn_params.device``); a preset or sidecar
that sets them passes them through.
"""
from __future__ import annotations

import copy
import json
import warnings
from pathlib import Path
from typing import Any, Dict, Optional


class Config:
    """Recursive attribute namespace over a dict."""

    def __init__(self, d: Optional[Dict[str, Any]] = None):
        if d:
            for k, v in d.items():
                setattr(self, k, Config(v) if isinstance(v, dict) else v)

    def get(self, key, default=None):
        return getattr(self, key, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self.__dict__.items()}


_DEFAULTS: Dict[str, Any] = {
    "dataset": "crossdock",
    "mode": "pocket_conditioning",
    "pocket_representation": "CA",
    "virtual_nodes": False,
    "run_name": "run",
    "logdir": "runs",
    "datadir": None,
    "seed": 42,
    "batch_size": 16,
    "lr": 1.0e-3,
    "n_epochs": 1000,
    "clip_grad": True,
    "accumulate_grad_batches": 1,
    # > 0: the training batches are assembled in a background thread, this
    # many ahead (at least 2)
    "num_workers": 0,
    "augment_noise": 0,
    "augment_rotation": False,
    "auxiliary_loss": False,
    "loss_params": {"max_weight": 0.001, "schedule": "linear", "clamp_lj": 3.0},
    "log_every_n_steps": 1,
    # the sampling evaluation during training: metrics every eval_epochs,
    # rendered samples and a denoising chain on their own schedules
    "eval_epochs": 50,
    "visualize_sample_epoch": 50,
    "visualize_chain_epoch": 50,
    "eval_params": {
        "n_eval_samples": 100,
        "eval_batch_size": 100,
        "smiles_file": None,
        "n_visualize_samples": 5,
        "keep_frames": 100,
    },
    "wandb_params": {"mode": "disabled", "entity": None, "group": None},
    "egnn_params": {
        "edge_cutoff_ligand": None,
        "edge_cutoff_pocket": None,
        "edge_cutoff_interaction": None,
        "reflection_equivariant": True,
        "edge_embedding_dim": None,
        "joint_nf": 32,
        "hidden_nf": 128,
        "n_layers": 5,
        "attention": True,
        "tanh": True,
        "norm_constant": 1,
        "inv_sublayers": 1,
        "sin_embedding": False,
        "aggregation_method": "sum",
        "normalization_factor": 100,
    },
    "diffusion_params": {
        "diffusion_steps": 500,
        "diffusion_noise_schedule": "polynomial_2",
        "diffusion_noise_precision": 5.0e-4,
        "diffusion_loss_type": "l2",
        "normalize_factors": [1, 4],
    },
    # padding granularity of the node axes, and the switch that lets the
    # samplers run one-GCL blocks as the whole-block kernel (the presets keep
    # these under the key "tpu"; the port reads the same fields)
    "tpu": {
        "lig_bucket": 8,
        "pocket_bucket": 64,
        "kernel_block_fuse": False,
        # ranks of the data group; -1: every rank of the run
        "mesh_data": -1,
        # join a process group even without torchrun's environment
        "multihost": False,
        # raise when the network's velocities are not all finite (one host
        # sync a forward)
        "nan_check": False,
        # the implementation choices (above): the kernels, or the dense path
        # (egnn_impl) / the dense mirror's gradient (kernel_bwd) with xla
        "egnn_impl": "auto",
        "kernel_bwd": "auto",
        # the precision policies (the table above)
        "matmul_precision": "float32",
        "kernel_bwd_precision": None,
        "compute_dtype": "float32",
    },
}

# matmul_precision (JAX's names) -> (the split kernels' tier, whether the
# glue's cuBLAS products run in TF32 on CUDA): the table above
PRECISIONS = {"float32": ("tf32x3", False), "float32_x3": ("tf32x3", False),
              "tensorfloat32": ("tf32x3", True), "float32_x2": ("tf32x2", False),
              "bfloat16": ("bf16", True)}
COMPUTE_DTYPES = ("float32", "bfloat16")
IMPLS = ("auto", "pallas", "xla")


def precision_policy(matmul_precision: str = "float32",
                     kernel_bwd_precision: Optional[str] = None,
                     compute_dtype: str = "float32"):
    """(forward tier, backward tier or None, TF32 glue, compute dtype name) of
    the JAX package's precision names; raises ``ValueError`` on any other
    name, as its ``_PRECISIONS[name]`` does."""
    for key, value, allowed in (("matmul_precision", matmul_precision, PRECISIONS),
                                ("kernel_bwd_precision", kernel_bwd_precision,
                                 (None, *PRECISIONS)),
                                ("compute_dtype", compute_dtype, COMPUTE_DTYPES)):
        if value not in allowed:
            raise ValueError(f"tpu.{key} {value!r} not in {tuple(allowed)}")
    tier, tf32_glue = PRECISIONS[matmul_precision]
    bwd = None if kernel_bwd_precision is None else PRECISIONS[kernel_bwd_precision][0]
    return tier, bwd, tf32_glue, compute_dtype


def check_impls(egnn_impl: str = "auto", kernel_bwd: str = "auto") -> None:
    """Raises ``ValueError`` on an implementation name other than JAX's
    auto / pallas / xla."""
    for key, value in (("egnn_impl", egnn_impl), ("kernel_bwd", kernel_bwd)):
        if value not in IMPLS:
            raise ValueError(f"tpu.{key} {value!r} not in {IMPLS}")


def check_tpu(tpu: Dict[str, Any]) -> None:
    """Raises ``ValueError`` on a ``tpu`` field the port does not honour: an
    unknown precision or implementation name."""
    precision_policy(tpu.get("matmul_precision"), tpu.get("kernel_bwd_precision"),
                     tpu.get("compute_dtype"))
    check_impls(tpu.get("egnn_impl", "auto"), tpu.get("kernel_bwd", "auto"))


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _read(path) -> Dict[str, Any]:
    path = Path(path)
    if path.suffix in (".yml", ".yaml"):
        import yaml  # only presets need PyYAML
        with open(path) as f:
            return yaml.safe_load(f) or {}
    return json.loads(path.read_text())


def load_config(path=None, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Defaults, then the file at ``path`` (JSON or YAML), then overrides."""
    merged = _merge(_DEFAULTS, _read(path) if path is not None else {})
    if overrides:
        merged = _merge(merged, overrides)
    check_tpu(merged["tpu"])
    return Config(merged)


def merge_configs(config: Dict[str, Any], resume_config: Dict[str, Any]):
    """The checkpoint's config takes precedence over ``config``, with
    warnings."""
    for key, value in resume_config.items():
        if key in config and config[key] != value:
            warnings.warn(
                f"Config parameter '{key}' (value: {config[key]}) will be "
                f"overwritten with value {value} from the checkpoint.")
        config[key] = value
    return config


# What the JAX package's training scripts fix for every committed parameter
# snapshot (benchmarks/synth_quality_r05.py:165-189,
# benchmarks/overfit_chem_r04.py:100-122): full-atom pocket conditioning on
# crossdock_full with the flagship EGNN options of
# configs/crossdock_fullatom_cond.yml.
_SNAPSHOT_FIXED: Dict[str, Any] = {
    "dataset": "crossdock_full",
    "mode": "pocket_conditioning",
    "pocket_representation": "full-atom",
    "egnn_params": {"attention": True, "tanh": True, "norm_constant": 1,
                    "inv_sublayers": 1, "reflection_equivariant": False,
                    "edge_cutoff_ligand": None, "edge_cutoff_pocket": 5.0,
                    "edge_cutoff_interaction": 5.0},
    "diffusion_params": {"normalize_factors": [1, 4]},
}


def snapshot_config(npz_path, overrides: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The config overrides a committed JAX parameter snapshot
    (``checkpoints/<name>.npz``) was trained with: widths, depth and T from
    the metadata file beside it (``<name>.json``), the rest as the training
    scripts fix it; then ``overrides``."""
    meta = json.loads(Path(npz_path).with_suffix(".json").read_text())
    trained = {"egnn_params": {k: meta[k] for k in ("joint_nf", "hidden_nf",
                                                      "n_layers")},
               "diffusion_params": {"diffusion_steps": meta["T"]}}
    return _merge(_merge(_SNAPSHOT_FIXED, trained), overrides or {})
