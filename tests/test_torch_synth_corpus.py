"""The port's synthetic-corpus generator against the JAX package's: for one
seed and the same two proteins (synthetic PDBs written from a seed), the
same arrays in every split and the same meta.json, in each graph mode, and
the size histogram within 1e-12 (its smoothing is the port's own)."""
import json

import numpy as np
import pytest

import chip_smoke
from diffsbdd_tpu.data import synth_corpus as jax_corpus
from diffsbdd_tpu_torch.data import synth_corpus as port_corpus
from diffsbdd_tpu_torch.data.dataset import LigandPocketDataset, PaddedLoader


@pytest.fixture(scope="module")
def proteins(tmp_path_factory):
    d = tmp_path_factory.mktemp("proteins")
    paths = {name: d / f"{name}.pdb" for name in ("protA", "protB")}
    for seed, path in enumerate(paths.values()):
        chip_smoke.write_protein_pdb(path, seed=seed)
    return paths


@pytest.mark.parametrize("graph_mode", ["random", "motif", "library"])
def test_corpus_equals_jax(tmp_path, monkeypatch, proteins, graph_mode):
    kw = dict(n_train=6, n_val=2, n_test=2, seed=3, graph_mode=graph_mode, vocab_size=3)
    monkeypatch.setattr(jax_corpus, "DEFAULT_PROTEINS",
                        {k: str(v) for k, v in proteins.items()})
    want = jax_corpus.build_corpus(tmp_path / "jax", train_protein="protA",
                                   heldout_protein="protB", **kw)
    got = port_corpus.build_corpus(tmp_path / "port", proteins["protA"],
                                   proteins["protB"], **kw)
    assert got == want
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == \
        json.loads((tmp_path / "jax" / "meta.json").read_text())
    for split in ("train", "val", "test"):
        with np.load(tmp_path / "port" / f"{split}.npz") as a, \
                np.load(tmp_path / "jax" / f"{split}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split}/{k}")
    # the port's own Gaussian smoothing of the histogram, scipy's within
    # 1e-12 (tests/test_torch_processing.py)
    np.testing.assert_allclose(np.load(tmp_path / "port" / "size_distribution.npy"),
                               np.load(tmp_path / "jax" / "size_distribution.npy"),
                               atol=1e-12, rtol=0)
    assert 80 <= got["pocket_sizes"]["min"] <= got["pocket_sizes"]["max"] <= 310
    # the splits load as a training set
    ds = LigandPocketDataset(tmp_path / "port" / "train.npz")
    batch = next(iter(PaddedLoader(ds, 3, shuffle=False)))
    assert batch["ligand"]["x"].shape[0] == 3 and len(ds) == 6
