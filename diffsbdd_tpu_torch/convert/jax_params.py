"""JAX (flax) parameter-shaped trees -> the port's state_dict names.

The same map serves parameters, gradients (``jax.grad`` returns a tree shaped
like the parameters) and the moment trees of optax's amsgrad state.

A flax leaf path such as ``dynamics/params/egnn/e_block_0/gcl_0/edge_mlp_0_kernel``
maps to ``ddpm.dynamics.egnn.e_block_0.gcl_0.edge_mlp.0.weight``; dense
kernels (in, out) are transposed to torch's (out, in).  The cross-product
MLP's head is the coordinate MLP's head, so it is written under both keys.

The committed ``checkpoints/*.npz`` snapshots store the flax tree under
'/'-joined paths in float16; ``load_npz`` reads them as float32.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict

import numpy as np

# flax submodule name -> torch nn.Sequential index, by owning module
_COORD_LAYERS = {"lin0": "0", "lin1": "2", "lin2": "4"}
_MLP2_LAYERS = {"lin0": "0", "lin2": "2"}
_SPLIT_LEAF = re.compile(r"^(.*)_(kernel|bias)$")


def load_npz(path) -> Dict[str, np.ndarray]:
    """'/'-joined flax paths -> float32 arrays (integer leaves as stored)."""
    with np.load(Path(path)) as data:
        return {k: (data[k].astype(np.float32)
                    if np.issubdtype(data[k].dtype, np.floating) else data[k])
                for k in data.files}


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> '/'-joined paths."""
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _torch_key(path: str):
    """flax leaf path -> (torch state_dict key, transpose?)."""
    parts = path.split("/")
    if parts[:2] == ["gamma", "params"]:
        # the learned noise schedule: l1/kernel -> ddpm.gamma_net.l1.weight
        leaf = {"kernel": "weight"}.get(parts[-1], parts[-1])
        return "ddpm.gamma_net." + ".".join(parts[2:-1] + [leaf]), parts[-1] == "kernel"
    if parts[:2] != ["dynamics", "params"]:
        raise KeyError(f"not a dynamics parameter: {path}")
    parts = parts[2:]
    leaf = parts.pop()
    m = _SPLIT_LEAF.match(leaf)
    if m and leaf not in ("kernel", "bias"):
        # fused names: edge_mlp_0_kernel, lin0_bias, ...
        parts.append(m.group(1))
        leaf = m.group(2)
    owner = parts[-2] if len(parts) >= 2 else ""
    name = parts[-1]
    if owner in ("coord_mlp", "cross_product_mlp"):
        parts[-1] = _COORD_LAYERS[name]
    elif name in _MLP2_LAYERS:
        parts[-1] = _MLP2_LAYERS[name]
    else:
        parts[-1] = re.sub(r"_(\d+)$", r".\1", name)
    transpose = leaf == "kernel"
    leaf = "bias" if leaf == "bias" else "weight"
    return "ddpm.dynamics." + ".".join(parts + [leaf]), transpose


def state_dict_from_jax(params) -> Dict[str, np.ndarray]:
    """Flax params, or a tree shaped like them (nested dict or flat
    '/'-joined paths, rooted at ``dynamics/params`` and, with a learned
    schedule, ``gamma/params``) -> state_dict arrays.  Every leaf is
    consumed."""
    sd: Dict[str, np.ndarray] = {}
    for path, value in flatten(params).items():
        key, transpose = _torch_key(path)
        if key in sd:
            raise KeyError(f"two leaves map to {key}")
        value = np.asarray(value, np.float32)
        sd[key] = np.ascontiguousarray(value.T) if transpose else value
    for key in list(sd):
        if key.endswith("gcl_equiv.coord_mlp.4.weight"):
            tied = key.replace("coord_mlp", "cross_product_mlp")
            if tied.replace(".4.weight", ".0.weight") in sd:
                sd[tied] = sd[key]
    return sd


def state_dict_from_npz(path) -> Dict[str, np.ndarray]:
    return state_dict_from_jax(load_npz(path))


def optimizer_state_from_jax(amsgrad_state, parameter_names) -> Dict[str, Any]:
    """optax's ``ScaleByAmsgradState`` (``count`` and the parameter-shaped
    trees ``mu``, ``nu``, ``nu_max``) -> the state dict of the port's
    optimizer, its lists ordered as ``parameter_names`` (the module's
    ``named_parameters()``)."""
    out: Dict[str, Any] = {"count": int(amsgrad_state.count)}
    for name in ("mu", "nu", "nu_max"):
        sd = state_dict_from_jax(getattr(amsgrad_state, name))
        out[name] = [sd[k] for k in parameter_names]
    return out
