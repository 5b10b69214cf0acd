"""The port's package root, checkpoint-name fallback and config defaults
against the JAX package's, on the CPU.

* ``diffsbdd_tpu_torch`` has the root names of ``diffsbdd_tpu/__init__.py``
  (``__version__``, ``Config``, ``load_config``, ``build_module``,
  ``load_model``), and importing it imports no model code;
* ``checkpoint.load_model`` falls back from a missing ``best`` to ``last``
  and from a missing ``last`` to ``best``, and raises ``FileNotFoundError``
  when neither exists, as the JAX package's ``checkpoint.load_model``;
* ``load_config()`` of both packages, the defaults and each preset of
  ``configs/``, key by key: equal values, and no key of the port's that JAX
  lacks; JAX's keys that the port leaves out are only those its config
  documents as without effect there.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import diffsbdd_tpu
import diffsbdd_tpu_torch
from diffsbdd_tpu.config import load_config as jax_load_config
from diffsbdd_tpu_torch import checkpoint
from diffsbdd_tpu_torch.train.module import build_module_from_config

REPO = Path(__file__).resolve().parent.parent
FIXTURE_NPZ = REPO / "checkpoints" / "overfit_chem_fixture_best.npz"
PRESETS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").glob("*.yml"))
# the JAX package's keys that the port's config leaves out: TPU tiling and
# padding knobs, and trainer options no JAX module reads
# (diffsbdd_tpu_torch/config.py's docstring)
NO_EFFECT = {"egnn_params.device", "enable_progress_bar", "gpus", "num_sanity_val_steps",
             "tpu.kernel_bwd_sub_j", "tpu.kernel_skip_mode", "tpu.kernel_sub_j",
             "tpu.kernel_tile_i", "tpu.n_lig_max", "tpu.n_pocket_max", "tpu.remat",
             "tpu.steps_per_dispatch"}


def _flat(d, prefix=""):
    out = {}
    for key, value in d.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


@pytest.fixture(scope="module")
def fixture_ckpt(tmp_path_factory):
    """The fixture weights as a port checkpoint named ``best``."""
    return checkpoint.import_jax_npz(FIXTURE_NPZ, tmp_path_factory.mktemp("ckpt"))


def _copy_as(src: Path, dst: Path, names: dict) -> Path:
    """``src``'s checkpoint files under ``dst``, renamed old -> new."""
    dst.mkdir()
    for old, new in names.items():
        for suffix in (".pt", ".config.json"):
            shutil.copy(src / f"{old}{suffix}", dst / f"{new}{suffix}")
    return dst


def _same_weights(module, path: Path) -> bool:
    state = torch.load(path, map_location="cpu", weights_only=True)
    return all(torch.equal(v, state[k]) for k, v in module.state_dict().items())


def test_root_names_are_jax_s():
    assert diffsbdd_tpu_torch.__version__ == diffsbdd_tpu.__version__ == "0.1.0"
    for name in ("Config", "load_config", "build_module", "load_model"):
        assert callable(getattr(diffsbdd_tpu_torch, name)), name
    assert diffsbdd_tpu_torch.Config is diffsbdd_tpu_torch.config.Config
    assert diffsbdd_tpu_torch.load_config().n_epochs == 1000


def test_root_import_loads_no_model():
    """``import diffsbdd_tpu_torch`` stays cheap: the model, the kernels and
    torch itself load only when ``build_module`` / ``load_model`` are called."""
    code = ("import sys, diffsbdd_tpu_torch\n"
            "heavy = [m for m in sys.modules if m == 'torch' or m.startswith("
            "('diffsbdd_tpu_torch.train', 'diffsbdd_tpu_torch.models', "
            "'diffsbdd_tpu_torch.ops', 'diffsbdd_tpu_torch.checkpoint'))]\n"
            "assert not heavy, heavy\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_root_build_module_and_load_model(fixture_ckpt):
    module, cfg = diffsbdd_tpu_torch.load_model(fixture_ckpt, device="cpu")
    assert not module.training and _same_weights(module, fixture_ckpt / "best.pt")
    hist = np.ones((17, 65))
    built = diffsbdd_tpu_torch.build_module(cfg, hist)
    want = build_module_from_config(cfg, hist)
    assert type(built) is type(want)
    assert [(k, v.shape) for k, v in built.state_dict().items()] == \
        [(k, v.shape) for k, v in want.state_dict().items()]
    assert [type(m).__name__ for m in built.modules()] == \
        [type(m).__name__ for m in want.modules()]


@pytest.mark.parametrize("asked, present", [("best", "last"), ("last", "best")])
def test_load_model_falls_back(fixture_ckpt, tmp_path, asked, present):
    """The name asked for is missing: the other one is loaded, its config
    and its weights; through the package root as well."""
    ckpt = _copy_as(fixture_ckpt, tmp_path / "ckpt", {"best": present})
    module, cfg = checkpoint.load_model(ckpt, name=asked, device="cpu")
    assert _same_weights(module, ckpt / f"{present}.pt")
    assert cfg.to_dict() == checkpoint.load_model(ckpt, name=present, device="cpu")[1].to_dict()
    root, _ = diffsbdd_tpu_torch.load_model(ckpt, name=asked, device="cpu")
    assert _same_weights(root, ckpt / f"{present}.pt")


def test_load_model_prefers_the_name_asked_for(fixture_ckpt, tmp_path):
    """With both present, each name loads its own files."""
    ckpt = _copy_as(fixture_ckpt, tmp_path / "ckpt", {"best": "best"})
    module, cfg = checkpoint.load_model(ckpt, device="cpu")
    with torch.no_grad():
        for p in module.parameters():
            p.add_(1.0)
    checkpoint.save_model(ckpt, module, cfg, name="last")
    assert _same_weights(checkpoint.load_model(ckpt, device="cpu")[0], ckpt / "best.pt")
    last = checkpoint.load_model(ckpt, name="last", device="cpu")[0]
    assert _same_weights(last, ckpt / "last.pt")
    assert not _same_weights(last, ckpt / "best.pt")


@pytest.mark.parametrize("name, held", [("best", "epoch_3"), ("last", "epoch_3"),
                                        ("epoch_3", None)])
def test_load_model_raises_when_neither_exists(fixture_ckpt, tmp_path, name, held):
    """Neither the name asked for nor its fallback is there (a directory
    with another checkpoint only, or an empty one): FileNotFoundError, as
    JAX's."""
    ckpt = _copy_as(fixture_ckpt, tmp_path / "ckpt", {} if held is None else {"best": held})
    with pytest.raises(FileNotFoundError, match="no checkpoint config"):
        checkpoint.load_model(ckpt, name=name, device="cpu")


@pytest.mark.parametrize("preset", [None] + PRESETS)
def test_load_config_matches_jax_key_by_key(preset):
    path = None if preset is None else str(REPO / preset)
    jax_cfg = _flat(jax_load_config(path).to_dict())
    port = _flat(diffsbdd_tpu_torch.load_config(path).to_dict())
    assert not set(port) - set(jax_cfg), sorted(set(port) - set(jax_cfg))
    assert set(jax_cfg) - set(port) <= NO_EFFECT, sorted(set(jax_cfg) - set(port) - NO_EFFECT)
    differ = {k: (jax_cfg[k], port[k]) for k in port if port[k] != jax_cfg[k]}
    assert not differ, differ
