"""The port's loaders against the JAX package's on the CPU: ``PaddedLoader``'s
process sharding batch for batch, and ``PrefetchLoader``'s three behaviours
(identical batches in order, a loader's error raised on the consumer, an
abandoned epoch that leaves no thread behind)."""
import threading

import numpy as np
import pytest

import chip_smoke
from diffsbdd_tpu.data import dataset as jax_data
from diffsbdd_tpu_torch.data import dataset as port_data

FIELDS = ("x", "one_hot", "mask", "size")


@pytest.fixture(scope="module")
def train_npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    chip_smoke.write_synthetic_dataset(d, 10, 2, seed=5, lig_sizes=(5, 12),
                                       pocket_sizes=(20, 28, 36), n_types=11)
    return d / "train.npz"


def assert_same_batch(got, want):
    assert list(got["names"]) == list(want["names"])
    for part in ("ligand", "pocket"):
        for k in FIELDS:
            np.testing.assert_array_equal(got[part][k], want[part][k], err_msg=k)


@pytest.mark.parametrize("shuffle,fixed_shape", [(True, True), (False, False)])
def test_process_sharding_matches_jax(train_npz, shuffle, fixed_shape):
    """Each of two ranks gets JAX's slice of every global batch of 4 (10
    complexes: the last batch refilled), and the two slices make the
    single-process batch."""
    kw = dict(batch_size=4, lig_bucket=8, pocket_bucket=8, shuffle=shuffle,
              fixed_shape=fixed_shape)
    jds = jax_data.LigandPocketDataset(train_npz)
    pds = port_data.LigandPocketDataset(train_npz)
    whole = list(port_data.PaddedLoader(pds, rng=np.random.default_rng(3), **kw))
    shards = []
    for rank in range(2):
        sharding = dict(process_index=rank, process_count=2)
        want = list(jax_data.PaddedLoader(jds, rng=np.random.default_rng(3), **kw,
                                          **sharding))
        got = list(port_data.PaddedLoader(pds, rng=np.random.default_rng(3), **kw,
                                          **sharding))
        assert len(got) == len(want) == len(whole) == 3
        for g, w in zip(got, want):
            assert len(g["names"]) == 2
            assert_same_batch(g, w)
        shards.append(got)
    for b, s0, s1 in zip(whole, *shards):
        assert list(s0["names"]) + list(s1["names"]) == list(b["names"])


def test_process_sharding_rejects_bad_ranks(train_npz):
    ds = port_data.LigandPocketDataset(train_npz)
    with pytest.raises(ValueError, match="not divisible by process_count 2"):
        port_data.PaddedLoader(ds, batch_size=3, process_count=2)
    with pytest.raises(ValueError, match="process_index 2 is not in"):
        port_data.PaddedLoader(ds, batch_size=4, process_index=2, process_count=2)


def test_prefetch_yields_identical_batches(train_npz):
    """Two epochs through the prefetch thread give the wrapped loader's
    batches, in its order, as JAX's PrefetchLoader does."""
    pds = port_data.LigandPocketDataset(train_npz)
    jds = jax_data.LigandPocketDataset(train_npz)
    kw = dict(batch_size=3, lig_bucket=8, pocket_bucket=8, shuffle=True)
    pre = port_data.PrefetchLoader(
        port_data.PaddedLoader(pds, rng=np.random.default_rng(1), **kw), depth=2)
    want = jax_data.PrefetchLoader(
        jax_data.PaddedLoader(jds, rng=np.random.default_rng(1), **kw), depth=2)
    assert len(pre) == len(want) == 4
    for _ in range(2):  # the same rng stream: the same shuffles
        got, ref = list(pre), list(want)
        assert len(got) == len(ref) == 4
        for g, w in zip(got, ref):
            assert_same_batch(g, w)


def test_prefetch_raises_the_loaders_error_and_survives_early_exit():
    class Boom:
        def __iter__(self):
            yield {"i": 0}
            raise RuntimeError("loader exploded")

        def __len__(self):
            return 2

    it = iter(port_data.PrefetchLoader(Boom(), depth=1))
    assert next(it)["i"] == 0
    with pytest.raises(RuntimeError, match="loader exploded"):
        next(it)

    # an iterator abandoned mid-epoch stops and joins its producer thread
    before = threading.active_count()
    it = iter(port_data.PrefetchLoader(({"i": i} for i in range(100)), depth=1))
    assert next(it)["i"] == 0
    it.close()
    assert threading.active_count() == before
    with pytest.raises(ValueError, match="depth must be >= 1"):
        port_data.PrefetchLoader([], depth=0)
