"""Host-side helpers of the sampling path."""
from __future__ import annotations

import numpy as np


def shift_to_pocket_frame(xh_lig, xh_pocket, lig_mask, pkt_mask, com_before):
    """Translate sampled ligand+pocket back into the original pocket frame.

    The conditional sampler runs in a ligand-CoM frame in which the pocket
    drifts; callers record the pocket CoM before sampling and restore it
    afterwards.  Returns writable numpy copies of ``xh_lig``/``xh_pocket``
    with the shift applied under the masks.
    """
    xh_lig = np.array(xh_lig)
    xh_pocket = np.array(xh_pocket)
    pkt_m = np.asarray(pkt_mask)
    lig_m = np.asarray(lig_mask)
    com_after = (xh_pocket[..., :3] * pkt_m[..., None]).sum(1) \
        / np.maximum(pkt_m.sum(1), 1.0)[..., None]
    shift = np.asarray(com_before) - com_after
    xh_pocket[..., :3] += shift[:, None, :] * pkt_m[..., None]
    xh_lig[..., :3] += shift[:, None, :] * lig_m[..., None]
    return xh_lig, xh_pocket
