"""Model checkpoints: a torch state_dict plus a JSON config sidecar.

A checkpoint named ``best`` in ``ckpt_dir`` is ``best.pt`` (the state_dict)
and ``best.config.json`` (the config, with the raw ligand/pocket size
histogram under ``node_histogram``, or null when the checkpoint carries no
size prior).  A checkpoint written by the trainer also has ``best.train.pt``
(optimizer state, gradient-norm history, step), which only resuming reads.
``import_jax_npz`` turns a JAX parameter snapshot (``checkpoints/*.npz``)
into a checkpoint without the training state.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from diffsbdd_tpu_torch.config import Config, load_config, snapshot_config
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_npz
from diffsbdd_tpu_torch.train.module import LigandPocketDDPM, build_module_from_config
from diffsbdd_tpu_torch.utils.device import resolve_device


def save_model(ckpt_dir, module: LigandPocketDDPM, cfg: Config,
               name: str = "last", state=None) -> None:
    """Write the checkpoint ``name``; with a trainer ``state`` (a
    ``train.loop.TrainState`` over ``module``) also its training state, so
    that the run can be resumed."""
    cfg_dict = cfg.to_dict()
    # the RAW histogram: SizeDistribution smooths and normalizes on load
    sizes = module.ddpm.size_distribution
    cfg_dict["node_histogram"] = None if sizes is None else \
        np.asarray(sizes.raw_histogram).tolist()
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    (ckpt_dir / f"{name}.config.json").write_text(json.dumps(cfg_dict, default=str))
    torch.save(module.state_dict(), ckpt_dir / f"{name}.pt")
    if state is not None:
        torch.save(state.train_state_dict(), ckpt_dir / f"{name}.train.pt")


def load_model(ckpt_dir, name: str = "best", device="cuda"
               ) -> Tuple[LigandPocketDDPM, Config]:
    """Rebuild (module in eval mode, config) from a checkpoint, on CUDA
    unless ``device="cpu"``; raises without a card (``resolve_device``).
    Where ``name`` is missing, loads ``last`` (``best`` when ``last`` was
    asked for), as the JAX package does: the trainer writes ``last`` at
    every validation but ``best`` only when the loss improves."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    cfg_file = ckpt_dir / f"{name}.config.json"
    if not cfg_file.exists():
        name = "best" if name == "last" else "last"
        cfg_file = ckpt_dir / f"{name}.config.json"
        if not cfg_file.exists():
            raise FileNotFoundError(f"no checkpoint config under {ckpt_dir}")
    cfg_dict = json.loads(cfg_file.read_text())
    histogram = cfg_dict.pop("node_histogram")
    cfg = load_config(overrides=cfg_dict)
    module = build_module_from_config(
        cfg, None if histogram is None else np.asarray(histogram))
    state = torch.load(ckpt_dir / f"{name}.pt", map_location="cpu",
                       weights_only=True)
    module.load_state_dict(state, strict=True)
    return module.to(device).eval(), cfg


def import_jax_npz(npz_path, out_dir, overrides: Optional[Dict[str, Any]] = None,
                   node_histogram: Optional[np.ndarray] = None,
                   name: str = "best") -> Path:
    """Write a port checkpoint from a committed JAX parameter snapshot, with
    the config it was trained with (``snapshot_config``) and ``overrides``.
    Without ``node_histogram`` the checkpoint has no ligand size prior, and
    sampling from it needs explicit ligand sizes."""
    cfg = load_config(overrides=snapshot_config(npz_path, overrides))
    module = build_module_from_config(cfg, node_histogram)
    state = {k: torch.as_tensor(v) for k, v in state_dict_from_npz(npz_path).items()}
    module.load_state_dict(state, strict=True)
    save_model(out_dir, module, cfg, name=name)
    return Path(out_dir)
