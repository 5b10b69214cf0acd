"""Centre-of-mass projections on padded ligand/pocket batches.  Three
semantics that are easy to mix up, one function each: joint (the combined
system's CoM leaves both parts), conditional (the ligand's CoM leaves both
parts), simple (no projection)."""
from __future__ import annotations

from typing import Tuple

import torch

from diffsbdd_tpu_torch.ops.masked import masked_mean, masked_sum


def remove_mean_conditional(x_lig: torch.Tensor, x_pocket: torch.Tensor,
                            mask_lig: torch.Tensor, mask_pocket: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subtract the ligand CoM from both ligand and pocket coordinates, so
    the pocket translates within the ligand frame."""
    mean = masked_mean(x_lig, mask_lig)
    return x_lig - mean[:, None, :], x_pocket - mean[:, None, :]


def remove_mean_joint(x_lig: torch.Tensor, x_pocket: torch.Tensor,
                      mask_lig: torch.Tensor, mask_pocket: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subtract the CoM of the combined ligand + pocket system from both."""
    total = masked_sum(x_lig, mask_lig) + masked_sum(x_pocket, mask_pocket)
    count = mask_lig.sum(1) + mask_pocket.sum(1)
    mean = total / torch.clamp(count, min=1e-12)[..., None]
    return x_lig - mean[:, None, :], x_pocket - mean[:, None, :]


def remove_mean_simple(x_lig, x_pocket, mask_lig, mask_pocket):
    """Identity projection (``SimpleConditionalDDPM``)."""
    return x_lig, x_pocket
