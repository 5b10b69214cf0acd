"""The network's weights under DiffSBDD's state_dict names.

``specs`` lists every leaf of a configuration's network with its shape and
the bound of PyTorch's default initialisation (uniform in +-1/sqrt(fan_in)
for a linear layer's weight and bias; the coordinate head xavier-uniform
with gain 1e-3).  ``seeded`` draws all of them on the device from one
generator in one call.  ``from_npz`` reads a JAX parameter snapshot
(``checkpoints/*.npz``: flax paths, (in, out) kernels, float16).  The
cross-product MLP's head is the coordinate MLP's head: one leaf, which the
state_dict also lists under the cross MLP's name (``tied_keys``).
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

DYN = "ddpm.dynamics."


def specs(atom_nf: int, residue_nf: int, joint_nf: int, hidden: int, n_layers: int,
          attention: bool = True, cross: bool = True) -> List[Tuple[str, tuple, float]]:
    out = []

    def lin(name, n_in, n_out, bias=True):
        bound = 1.0 / math.sqrt(n_in)
        out.append((name + ".weight", (n_out, n_in), bound))
        if bias:
            out.append((name + ".bias", (n_out,), bound))

    for enc, nf in (("atom", atom_nf), ("residue", residue_nf)):
        lin(f"{DYN}{enc}_encoder.0", nf, 2 * nf)
        lin(f"{DYN}{enc}_encoder.2", 2 * nf, joint_nf)
        lin(f"{DYN}{enc}_decoder.0", joint_nf, 2 * nf)
        lin(f"{DYN}{enc}_decoder.2", 2 * nf, nf)
    F = hidden
    lin(DYN + "egnn.embedding", joint_nf + 1, F)
    for i in range(n_layers):
        blk = f"{DYN}egnn.e_block_{i}"
        lin(blk + ".gcl_0.edge_mlp.0", 2 * F + 2, F)
        lin(blk + ".gcl_0.edge_mlp.2", F, F)
        lin(blk + ".gcl_0.node_mlp.0", 2 * F, F)
        lin(blk + ".gcl_0.node_mlp.2", F, F)
        if attention:
            lin(blk + ".gcl_0.att_mlp.0", F, 1)
        for mlp in ("coord_mlp",) + (("cross_product_mlp",) if cross else ()):
            lin(f"{blk}.gcl_equiv.{mlp}.0", 2 * F + 2, F)
            lin(f"{blk}.gcl_equiv.{mlp}.2", F, F)
        out.append((blk + ".gcl_equiv.coord_mlp.4.weight", (1, F),
                    1e-3 * math.sqrt(6.0 / (F + 1))))
    lin(DYN + "egnn.embedding_out", F, joint_nf + 1)
    return out


def tied_keys(P: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``P`` with the cross MLP's head listed under its own name too."""
    out = dict(P)
    for k in P:
        if k.endswith("gcl_equiv.coord_mlp.4.weight"):
            tied = k.replace("coord_mlp", "cross_product_mlp")
            if tied.replace(".4.weight", ".0.weight") in P:
                out[tied] = P[k]
    return out


def seeded(leaves, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every leaf uniform in +-bound, from one draw on ``device``."""
    sizes = [int(np.prod(shape)) for _, shape, _ in leaves]
    flat = torch.rand(sum(sizes), generator=generator, device=device) * 2 - 1
    P, at = {}, 0
    for (name, shape, bound), n in zip(leaves, sizes):
        P[name] = (flat[at:at + n] * bound).reshape(shape).contiguous()
        at += n
    return P


_COORD = {"lin0": "0", "lin1": "2", "lin2": "4"}
_MLP2 = {"lin0": "0", "lin2": "2"}


def from_npz(path, device) -> Dict[str, torch.Tensor]:
    """A flax snapshot of the dynamics as float32 tensors under the
    state_dict names (each (in, out) kernel transposed)."""
    P = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            if parts[:2] != ["dynamics", "params"]:
                raise KeyError(f"not a dynamics leaf: {key}")
            parts, leaf = parts[2:-1], parts[-1]
            m = re.match(r"^(.*)_(kernel|bias)$", leaf)
            if m:  # edge_mlp_0_kernel, lin0_bias: module and leaf in one name
                parts, leaf = parts + [m.group(1)], m.group(2)
            owner, name = (parts[-2] if len(parts) > 1 else ""), parts[-1]
            if owner in ("coord_mlp", "cross_product_mlp"):
                parts[-1] = _COORD[name]
            elif name in _MLP2:
                parts[-1] = _MLP2[name]
            else:
                parts[-1] = re.sub(r"_(\d+)$", r".\1", name)
            value = torch.as_tensor(data[key].astype(np.float32))
            if leaf == "kernel":
                value = value.t().contiguous()
            P[DYN + ".".join(parts) + (".weight" if leaf == "kernel" else ".bias")] = value
    return {k: v.to(device) for k, v in P.items()}
