"""PyTorch/CUDA port of diffsbdd_tpu: pocket-conditional ligand sampling
with hand-written Hopper kernels for the EGNN's pairwise work.

The package root has the JAX package's API: ``Config``, ``load_config``,
``build_module`` and ``load_model`` (on CUDA unless ``device="cpu"``), the
last two importing the model only when called."""

__version__ = "0.1.0"

from diffsbdd_tpu_torch.config import Config, load_config  # noqa: E402,F401


def build_module(cfg, node_histogram):
    """The ``LigandPocketDDPM`` that ``cfg`` configures
    (``train.module.build_module_from_config``)."""
    from diffsbdd_tpu_torch.train.module import build_module_from_config
    return build_module_from_config(cfg, node_histogram)


def load_model(ckpt_dir, name="best", device="cuda"):
    """(module in eval mode, config) of a checkpoint (``checkpoint.load_model``)."""
    from diffsbdd_tpu_torch.checkpoint import load_model as _load
    return _load(ckpt_dir, name=name, device=device)
