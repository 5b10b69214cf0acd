"""The port's conditional inpainting with one pocket shared over the batch
against the JAX package's on the CPU.

Split from ``test_torch_inpaint.py`` (whose helpers it uses), so that the
two run on separate workers: both sides run the committed fixture weights
and pop one recorded noise stream (the JAX side eagerly, under
``jax.disable_jit``).  Tolerances: maximum coordinate deviation 1e-3 A and
no atom-type flip; the shared and the unshared port chains within 1e-4 A.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_inpaint import T, lig_noise, modules, one_pocket, report
from test_torch_joint import inpaint_case, queue_port
from test_torch_train import (fixture_params,  # noqa: F401
                              jnp_batch, torch_batch)


def test_inpaint_shared_pocket_matches_jax(fixture_params):
    """One pocket replicated over the batch, ``shared_pocket=True`` on both
    sides: the pocket is translated per sample on the way, and the shared
    pocket-pocket block of the first GCL still holds, since it reads
    distances only.  The fixed atoms come back where they were put, up to the
    common translation of the frame."""
    jm, params, pm = modules(fixture_params)
    lig, pkt, lig_fixed = inpaint_case(12)
    pkt = one_pocket(pkt)
    R = 3
    noise = lig_noise(13, 1 + T * (2 * R + (R - 1)) + 1)
    jm.ddpm.set_queue(list(noise))
    with jax.disable_jit():
        want = jm.ddpm.inpaint_segmented(
            params, jax.random.PRNGKey(0), jnp_batch(lig), jnp_batch(pkt),
            jnp.asarray(lig_fixed), resamplings=R, timesteps=T, shared_pocket=True)
    assert not jm.ddpm._noise_queue
    outs = {}
    for shared in (True, False):
        queue = list(noise)
        queue_port(pm, queue)
        outs[shared] = pm.ddpm.inpaint(
            None, torch_batch(lig), torch_batch(pkt), torch.as_tensor(lig_fixed),
            resamplings=R, timesteps=T, shared_pocket=shared)
        assert not queue
    report("inpaint shared pocket, ligand", outs[True][0], want[0], lig["mask"])
    report("inpaint shared pocket, pocket", outs[True][1], want[1], pkt["mask"])
    report("inpaint shared against unshared", outs[True][0], outs[False][0],
           lig["mask"], limit=1e-4)
    # the fixed atoms keep their shape and their place relative to the pocket
    got_l, got_p = outs[True][0].numpy(), outs[True][1].numpy()
    shift = (got_p[..., :3] - pkt["x"]) * pkt["mask"][..., None]
    shift = shift.sum(1) / pkt["mask"].sum(1)[:, None]
    moved = got_l[:, :3, :3] - shift[:, None, :]
    print("fixed atoms off by", float(np.abs(moved - lig["x"][:, :3]).max()), "A")
    np.testing.assert_allclose(
        moved - moved.mean(1, keepdims=True),
        lig["x"][:, :3] - lig["x"][:, :3].mean(1, keepdims=True), atol=0.5)
