"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and absent -- an entry point
    never carries on on the CPU by itself.  On CUDA, float32 matrix products
    and convolutions are kept in full float32 (no TF32), as the JAX reference
    computes."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run "
                               "on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return device
