"""The port's joint RePaint inpainting against the JAX package's on the CPU.

Split from ``test_torch_joint.py`` (whose helpers it uses), so that the
two run on separate workers: both sides run the committed fixture weights
in ``mode: joint`` and pop one recorded noise stream (the JAX side eagerly,
under ``jax.disable_jit``).  Tolerance: maximum coordinate deviation 1e-3 A
and no atom-type flip, printed as they come out.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_joint import T, inpaint_case, joint_noise, joint_overrides, queue_port, queued
from test_torch_sampling import deviation
from test_torch_train import (both_modules, fixture_params,  # noqa: F401
                              jnp_batch, torch_batch)


def test_joint_inpaint_matches_jax(fixture_params):
    """RePaint with resamplings = 2 and jump_length = 2 at T = 10: every
    iteration draws for the re-noised known part, the denoise step and, on a
    jump, the jump; the pocket is fixed, three ligand atoms too."""
    jm, params, pm = both_modules(joint_overrides(), fixture_params)
    queued(jm)
    lig, pkt, lig_fixed = inpaint_case(3)
    s_arr, jumps = jm.ddpm._repaint_plan(2, 2, T)
    n_draws = 1 + 2 * len(s_arr) + int((jumps > 0).sum()) + 1
    noise = joint_noise(4, n_draws, 2, 8, 40)
    jm.ddpm.set_queue(list(noise))
    with jax.disable_jit():
        want = jm.ddpm.inpaint(params, jax.random.PRNGKey(0), jnp_batch(lig),
                               jnp_batch(pkt), jnp.asarray(lig_fixed),
                               jnp.asarray(pkt["mask"]), resamplings=2,
                               jump_length=2, timesteps=T)
    assert not jm.ddpm._noise_queue
    queue = list(noise)
    queue_port(pm, queue)
    got = pm.ddpm.inpaint(None, torch_batch(lig), torch_batch(pkt),
                          torch.as_tensor(lig_fixed), torch.as_tensor(pkt["mask"]),
                          resamplings=2, jump_length=2, timesteps=T)
    assert not queue
    for name, g, w, m in (("ligand", got[0], want[0], lig["mask"]),
                          ("pocket", got[1], want[1], pkt["mask"])):
        dx, flips = deviation(g.numpy()[m > 0], np.asarray(w)[m > 0])
        print(f"joint inpaint ({len(s_arr)} passes), {name}: max coordinate "
              f"deviation {dx:.2e} A, {flips} type flips")
        assert dx <= 1e-3 and flips == 0
