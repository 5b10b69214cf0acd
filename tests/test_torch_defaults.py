"""The port's constructor defaults against the JAX package's, on the CPU.

* the DDPMs (``DDPMBase`` and the three models that inherit its
  ``__init__``) built with default arguments, no parameters initialized:
  the same loss type, schedule kind and learned gamma;
* every field default of JAX's ``EGNNDynamics`` flax dataclass against the
  port's ``EGNNDynamics.__init__`` default of the same name (dtypes by their
  names: ``jnp.float32`` is ``"float32"``);
* the fixture weights through ``EGNNDynamics`` as each package builds it
  with ``update_pocket_coords`` left out: both move the pocket, and the
  pocket's output agrees within the dynamics tests' atol 1e-4.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsbdd_tpu.diffusion import ddpm as jax_ddpm
from diffsbdd_tpu.models.dynamics import EGNNDynamics as JaxDynamics
from diffsbdd_tpu.utils.params_io import load_params_npz
from diffsbdd_tpu_torch.convert.jax_params import state_dict_from_jax
from diffsbdd_tpu_torch.diffusion import ddpm as port_ddpm
from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
from test_torch_dynamics import COMMON, FIXTURE, make_batch

MODELS = ("JointDDPM", "ConditionalDDPM", "SimpleConditionalDDPM")


def _name(value):
    """A default as the two packages can compare it: a dtype by its name."""
    try:
        return jnp.dtype(value).name if isinstance(value, type) else value
    except TypeError:
        return value


@pytest.mark.parametrize("model", MODELS)
def test_ddpm_defaults_match_jax(model):
    """The learned schedule and the vlb objective, in both packages."""
    small = dict(atom_nf=5, residue_nf=7, joint_nf=8, hidden_nf=16, n_layers=1)
    args = dict(atom_nf=5, residue_nf=7, n_dims=3, size_distribution=None)
    jax_model = getattr(jax_ddpm, model)(JaxDynamics(**small), **args)
    port = getattr(port_ddpm, model)(EGNNDynamics(**small), **args)
    assert port.loss_type == jax_model.loss_type == "vlb"
    assert jax_model.learned_gamma and jax_model.gamma_table is None
    assert port.gamma_net is not None and port.gamma_table is None
    defaults = {k: p.default for k, p in
                inspect.signature(port_ddpm.DDPMBase.__init__).parameters.items()}
    for key, value in inspect.signature(jax_ddpm.DDPMBase.__init__).parameters.items():
        if value.default is not inspect.Parameter.empty:
            assert defaults[key] == value.default, key


def test_dynamics_field_defaults_match_jax():
    """Every default the two ``EGNNDynamics`` share, among them
    ``update_pocket_coords`` and ``kernel_block_fuse`` (both True)."""
    port = {k: p.default for k, p in inspect.signature(EGNNDynamics).parameters.items()
            if p.default is not inspect.Parameter.empty}
    shared = []
    for field in dataclasses.fields(JaxDynamics):
        if field.name not in port or field.default is dataclasses.MISSING:
            continue
        shared.append(field.name)
        assert _name(port[field.name]) == _name(field.default), field.name
    assert {"update_pocket_coords", "kernel_block_fuse", "compute_dtype",
            "matmul_precision", "joint_nf", "hidden_nf"} <= set(shared)
    assert port["update_pocket_coords"] is True and port["kernel_block_fuse"] is True


def test_default_network_moves_the_pocket_as_jax():
    """With ``update_pocket_coords`` left out both networks update the
    pocket's coordinates, and agree on them."""
    params = load_params_npz(FIXTURE)
    batch = make_batch(0)
    ref = jax.jit(JaxDynamics(**COMMON, impl="xla").apply)(
        params["dynamics"], *map(jnp.asarray, batch))
    port = EGNNDynamics(**COMMON)
    prefix = "ddpm.dynamics."
    port.load_state_dict({k[len(prefix):]: torch.tensor(v)
                          for k, v in state_dict_from_jax(params).items()}, strict=True)
    assert port.update_pocket_coords
    with torch.no_grad():
        got = port.eval()(*map(torch.as_tensor, batch))
    pocket_x = got[1][..., :3].numpy()
    assert np.abs(pocket_x).max() > 1e-3  # the pocket moves
    np.testing.assert_allclose(pocket_x, np.asarray(ref[1])[..., :3], atol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
