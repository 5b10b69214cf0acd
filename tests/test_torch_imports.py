"""The port stands alone: no module of ``diffsbdd_tpu_torch`` nor
``chip_smoke.py`` imports JAX, flax, optax, orbax or the JAX package, nor
networkx, pandas, RDKit or OpenBabel, which the machine with the card lacks;
scipy, matplotlib, imageio, wandb and PyYAML, which it is not promised, only
inside the functions that need them."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import diffsbdd_tpu_torch

REPO = Path(__file__).resolve().parent.parent
BANNED = ("jax", "flax", "optax", "orbax", "diffsbdd_tpu", "networkx", "pandas",
          "rdkit", "openbabel")
LAZY = ("scipy", "matplotlib", "imageio", "wandb", "yaml")
FORBIDDEN = re.compile(
    rf"^\s*(from|import)\s+({'|'.join(BANNED)})(\.|\s|$)", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        diffsbdd_tpu_torch.__path__, "diffsbdd_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules() + ["chip_smoke"]
    assert len(mods) > 20
    assert {"diffsbdd_tpu_torch.cli.inpaint", "diffsbdd_tpu_torch.cli.generate_ligands",
            "diffsbdd_tpu_torch.cli.test_set", "diffsbdd_tpu_torch.cli.optimize",
            "diffsbdd_tpu_torch.cli.serve", "diffsbdd_tpu_torch.chem.graphs",
            "diffsbdd_tpu_torch.chem.descriptors", "diffsbdd_tpu_torch.chem.sascore",
            "diffsbdd_tpu_torch.chem.metrics",
            "diffsbdd_tpu_torch.diffusion.ddpm", "diffsbdd_tpu_torch.convert.torch_ckpt",
            "diffsbdd_tpu_torch.chem.docking", "diffsbdd_tpu_torch.chem.visualization",
            "diffsbdd_tpu_torch.train.evaluation", "diffsbdd_tpu_torch.geom.backbone",
            "diffsbdd_tpu_torch.data.proc_crossdock",
            "diffsbdd_tpu_torch.data.proc_bindingmoad",
            "diffsbdd_tpu_torch.data.prepare_crossdocked",
            "diffsbdd_tpu_torch.parallel.mesh", "diffsbdd_tpu_torch.parallel.edge_shard",
            "diffsbdd_tpu_torch.parallel.sample_shard",
            "diffsbdd_tpu_torch.utils.debug", "diffsbdd_tpu_torch.utils.profiling",
            "diffsbdd_tpu_torch.data.synth_corpus"} <= set(mods)
    code = ("import sys\n"
            f"for m in {BANNED + LAZY!r}:\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_no_jax_package_imports_in_sources():
    files = sorted((REPO / "diffsbdd_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    bad = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
           for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert not bad, bad


def test_every_kernel_has_a_plain_c_source():
    """Each kernel the wrappers can launch has its ``csrc/<name>.cu`` with an
    ``extern "C"`` entry point of the registered name, and no source pulls in
    PyTorch's headers (they are built by nvcc alone and bound with ctypes)."""
    from diffsbdd_tpu_torch.ops import egnn_cuda as ec
    assert "block_fused" in ec.KERNELS and set(ec.launch_counts) == set(ec.KERNELS)
    for name in ec.KERNELS:
        text = (ec.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {ec._ARGTYPES[name][0]}(' in text, name
    for path in list(ec.CSRC.glob("*.cu")) + list(ec.CSRC.glob("*.cuh")):
        assert "torch/" not in path.read_text(), path.name
    assert all(h.exists() for h in ec.HEADERS)


def test_argtypes_match_the_c_signatures():
    """ctypes passes what ``argtypes`` lists: one entry for each parameter of
    the ``extern "C"`` entry point, a pointer for each pointer, a float for
    each float and an int for each int (an int where a pointer is due cuts it
    to 32 bits)."""
    import ctypes
    import re
    from diffsbdd_tpu_torch.ops import egnn_cuda as ec
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_float: "float", ctypes.c_int: "int"}
    for name in ec.KERNELS:
        fn_name, argtypes = ec._ARGTYPES[name]
        text = (ec.CSRC / f"{name}.cu").read_text()
        params = re.search(rf'extern "C" int {fn_name}\((.*?)\)\s*{{', text, re.S).group(1)
        want = ["ptr" if "*" in p else p.split()[0] for p in params.split(",")]
        assert [kinds[t] for t in argtypes] == want, name
