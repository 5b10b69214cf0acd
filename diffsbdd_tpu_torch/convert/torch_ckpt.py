"""Reference PyTorch Lightning checkpoints -> port checkpoints.

    python -m diffsbdd_tpu_torch.convert.torch_ckpt <file.ckpt> --outdir <dir> [--name best]

The reference publishes trained checkpoints for CrossDocked and Binding MOAD
(Zenodo record 8183747).  Such a file holds the LightningModule's
``state_dict`` and its ``hyper_parameters`` (``argparse.Namespace`` values,
the ligand/pocket size histogram under ``node_histogram``).  The port's module
tree uses the reference's state_dict names, so the import only reconciles
three differences:

- ``ddpm.gamma.gamma``, the reference's table of a fixed noise schedule, is no
  parameter of the port (it derives the table from the config): it is checked
  against the port's table (atol 1e-4) and dropped;
- a learned schedule is ``ddpm.gamma.{l1,l2,l3,gamma_0,gamma_1}`` there and
  ``ddpm.gamma_net.*`` here;
- the cross-product MLP's head is the coordinate MLP's (one tensor under two
  keys): it is read from ``coord_mlp.4.weight`` only.

Any other key that is left over or missing raises.  The result is a port
checkpoint (``checkpoint.save_model``) that ``load_model`` and every CLI read.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from diffsbdd_tpu_torch.checkpoint import save_model
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.train.module import build_module_from_config

_GAMMA_TABLE = "ddpm.gamma.gamma"
_TIED_HEAD = "cross_product_mlp.4.weight"


def _namespace_to_dict(obj):
    if hasattr(obj, "__dict__") and not isinstance(obj, dict):
        return {k: _namespace_to_dict(v) for k, v in vars(obj).items()}
    if isinstance(obj, dict):
        return {k: _namespace_to_dict(v) for k, v in obj.items()}
    return obj


def hparams_to_config_dict(hparams: Dict[str, Any]) -> Dict[str, Any]:
    """Lightning ``hyper_parameters`` -> the config fields the port reads."""
    h = _namespace_to_dict(hparams)
    keep = ["dataset", "mode", "pocket_representation", "virtual_nodes",
            "batch_size", "lr", "clip_grad", "augment_noise",
            "augment_rotation", "auxiliary_loss", "eval_epochs",
            "visualize_sample_epoch", "visualize_chain_epoch"]
    cfg = {k: h[k] for k in keep if k in h}
    for nested in ("egnn_params", "diffusion_params", "loss_params",
                   "eval_params"):
        if nested in h and h[nested] is not None:
            cfg[nested] = h[nested]
    return cfg


def state_dict_from_lightning(state_dict: Dict[str, torch.Tensor], module,
                              verify_gamma: bool = True) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` -> the state_dict of the port's ``module``
    (float32 CPU tensors).  Raises ValueError on a schedule table that is not
    the config's and on keys left over or missing."""
    sd = {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
          for k, v in state_dict.items()}
    table = sd.pop(_GAMMA_TABLE, None)
    ours = module.ddpm.gamma_table
    if verify_gamma and table is not None and ours is not None:
        ours = ours.detach().cpu().float()
        if ours.shape != table.shape or not torch.allclose(ours, table, atol=1e-4, rtol=0):
            diff = float((ours - table).abs().max()) if ours.shape == table.shape \
                else f"shapes {tuple(table.shape)} and {tuple(ours.shape)}"
            raise ValueError("gamma schedule mismatch between checkpoint and "
                             f"config (max diff {diff})")
    sd = {("ddpm.gamma_net." + k[len("ddpm.gamma."):]
           if k.startswith("ddpm.gamma.") else k): v for k, v in sd.items()}
    # the tied head: coord_mlp's copy is the one read
    sd = {k: v for k, v in sd.items() if not k.endswith(_TIED_HEAD)}
    want = module.state_dict()
    for k in want:
        if k.endswith(_TIED_HEAD):
            sd[k] = sd.get(k.replace("cross_product_mlp", "coord_mlp"))
    leftover = sorted(set(sd) - set(want))
    missing = sorted(k for k in want if sd.get(k) is None)
    if leftover or missing:
        raise ValueError(
            f"{len(leftover)} checkpoint tensors left over and {len(missing)} "
            f"missing (flag/checkpoint mismatch? e.g. attention/"
            f"reflection_equivariant/inv_sublayers): left over "
            f"{', '.join(leftover[:10])}; missing {', '.join(missing[:10])}")
    return sd


def import_lightning_checkpoint(ckpt, out_dir, name: str = "best",
                                verify_gamma: bool = True):
    """Write the port checkpoint ``name`` under ``out_dir`` from the
    reference Lightning file ``ckpt``; returns (module, config).

    The file is unpickled with ``weights_only=False``: its hyper-parameters
    are ``argparse.Namespace`` objects and may hold numpy arrays.  Unpickling
    runs code, so import only files from a source you trust."""
    ckpt = torch.load(ckpt, map_location="cpu", weights_only=False)
    hparams = ckpt["hyper_parameters"]
    cfg = load_config(overrides=hparams_to_config_dict(hparams))
    histogram = np.asarray(_namespace_to_dict(hparams)["node_histogram"])
    module = build_module_from_config(cfg, histogram)
    module.load_state_dict(state_dict_from_lightning(
        ckpt["state_dict"], module, verify_gamma=verify_gamma), strict=True)
    save_model(out_dir, module, cfg, name=name)
    return module, cfg


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Import a DiffSBDD Lightning checkpoint as a port checkpoint")
    p.add_argument("ckpt", type=Path)
    p.add_argument("--outdir", type=Path, required=True)
    p.add_argument("--name", type=str, default="best")
    args = p.parse_args(argv)
    import_lightning_checkpoint(args.ckpt, args.outdir, name=args.name)
    print(f"converted {args.ckpt} -> {args.outdir}")


if __name__ == "__main__":
    main()
