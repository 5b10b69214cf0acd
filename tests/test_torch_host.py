"""The port's diffusion algebra and host-side modules against the JAX
package's, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsbdd_tpu.chem.molecule import build_molecule as jax_build_molecule
from diffsbdd_tpu.chem.molecule import process_molecule as jax_process_molecule
from diffsbdd_tpu.constants import dataset_params as jax_dataset_params
from diffsbdd_tpu.diffusion import schedule as jax_sched
from diffsbdd_tpu.diffusion.size_prior import SizeDistribution as JaxSizeDistribution
from diffsbdd_tpu.geom.com import remove_mean_conditional as jax_remove_mean
from diffsbdd_tpu.utils.misc import shift_to_pocket_frame as jax_shift
from diffsbdd_tpu_torch.chem.molecule import build_molecule, process_molecule
from diffsbdd_tpu_torch.constants import dataset_params
from diffsbdd_tpu_torch.diffusion import schedule as sched
from diffsbdd_tpu_torch.diffusion.size_prior import SizeDistribution
from diffsbdd_tpu_torch.geom.com import remove_mean_conditional
from diffsbdd_tpu_torch.utils.misc import shift_to_pocket_frame


@pytest.mark.parametrize("timesteps", [10, 500])
def test_gamma_table_and_transitions_match_jax(timesteps):
    want = jax_sched.gamma_table("polynomial_2", timesteps, 5e-4)
    got = sched.gamma_table("polynomial_2", timesteps, 5e-4)
    np.testing.assert_array_equal(got, want)
    g_t, g_s = torch.as_tensor(got[1:]), torch.as_tensor(got[:-1])
    # rtol 1e-4: sigma^2_{t|s} = -expm1(softplus(g_s) - softplus(g_t)) cancels
    # two close float32 values, and the frameworks' softplus round apart
    for a, b in zip(sched.sigma_and_alpha_t_given_s(g_t, g_s),
                    jax_sched.sigma_and_alpha_t_given_s(jnp.asarray(got[1:]),
                                                        jnp.asarray(got[:-1]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-7)
    for f, jf in ((sched.alpha, jax_sched.alpha), (sched.sigma, jax_sched.sigma),
                  (sched.snr, jax_sched.snr)):
        np.testing.assert_allclose(f(g_t).numpy(), np.asarray(jf(jnp.asarray(got[1:]))),
                                   rtol=1e-5)


def test_size_prior_samples_match_jax():
    hist = np.random.default_rng(0).integers(0, 5, (20, 40))
    got = SizeDistribution(hist).sample_conditional(
        n2=np.array([3, 17, 39]), rng=np.random.default_rng(1))
    want = JaxSizeDistribution(hist).sample_conditional(
        n2=np.array([3, 17, 39]), rng=np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)


def test_remove_mean_and_pocket_frame_match_jax():
    rng = np.random.default_rng(2)
    x_l, x_p = rng.standard_normal((2, 6, 3)), rng.standard_normal((2, 9, 3))
    m_l = np.ones((2, 6), np.float32)
    m_l[1, 4:] = 0
    m_p = np.ones((2, 9), np.float32)
    got = remove_mean_conditional(*(torch.as_tensor(a, dtype=torch.float32)
                                    for a in (x_l, x_p, m_l, m_p)))
    want = jax_remove_mean(*(jnp.asarray(a, jnp.float32)
                             for a in (x_l, x_p, m_l, m_p)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    com = rng.standard_normal((2, 3))
    for g, w in zip(shift_to_pocket_frame(x_l, x_p, m_l, m_p, com),
                    jax_shift(x_l, x_p, m_l, m_p, com)):
        np.testing.assert_allclose(g, w)


@pytest.mark.parametrize("dataset", ["crossdock", "crossdock_full"])
def test_dataset_tables_match_jax(dataset):
    for k, v in dataset_params[dataset].items():
        want = jax_dataset_params[dataset][k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, want)
        else:
            assert v == want, k


@pytest.mark.parametrize("largest_frag", [False, True])
def test_molecule_building_matches_jax(largest_frag):
    info, jinfo = dataset_params["crossdock_full"], jax_dataset_params["crossdock_full"]
    rng = np.random.default_rng(3)
    for _ in range(5):
        pos = np.cumsum(rng.normal(0, 0.9, (12, 3)), axis=0).astype(np.float32)
        types = rng.integers(0, 4, 12)
        got = process_molecule(build_molecule(pos, types, info),
                               sanitize=True, largest_frag=largest_frag)
        want = jax_process_molecule(
            jax_build_molecule(pos, types, jinfo, perception="edm"),
            sanitize=True, largest_frag=largest_frag)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.symbols == want.symbols
            assert sorted(got.bonds) == sorted(want.bonds)
            np.testing.assert_array_equal(got.coords, want.coords)
