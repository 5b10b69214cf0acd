"""Centre-of-mass projection of the pocket-conditional model."""
from __future__ import annotations

from typing import Tuple

import torch

from diffsbdd_tpu_torch.ops.masked import masked_mean


def remove_mean_conditional(x_lig: torch.Tensor, x_pocket: torch.Tensor,
                            mask_lig: torch.Tensor, mask_pocket: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subtract the ligand CoM from both ligand and pocket coordinates, so
    the pocket translates within the ligand frame."""
    mean = masked_mean(x_lig, mask_lig)
    return x_lig - mean[:, None, :], x_pocket - mean[:, None, :]
