"""Data pipeline: preprocessed ``.npz`` splits -> padded fixed-shape batches.

Reads the ``{train,val,test}.npz`` format of the processing scripts (flat
per-node arrays plus graph-id masks) and pads to size-bucketed static shapes.
Batches are numpy; the trainer moves them to its device.  Assembling and
padding one batch of ``PaddedLoader`` is a ``data.batch`` span
(``utils.profiling.span``), on whichever thread pads it.
"""
from __future__ import annotations

import math
import queue
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from diffsbdd_tpu_torch.utils.profiling import span


def round_to_bucket(n: int, bucket: int, minimum: int = 0) -> int:
    """Smallest multiple of ``bucket`` >= n (and >= ``minimum``, >= bucket)."""
    return max(int(math.ceil(n / bucket)) * bucket, minimum, bucket)


def pad_batch(items: List[dict], n_lig: int, n_pocket: int) -> Dict[str, dict]:
    """Pad a list of per-complex dicts into padded ligand/pocket batch dicts."""
    B = len(items)
    a_nf = items[0]["lig_one_hot"].shape[1]
    r_nf = items[0]["pocket_one_hot"].shape[1]

    def empty(n, nf):
        return {"x": np.zeros((B, n, 3), np.float32),
                "one_hot": np.zeros((B, n, nf), np.float32),
                "mask": np.zeros((B, n), np.float32),
                "size": np.zeros((B,), np.int32)}

    lig, pkt = empty(n_lig, a_nf), empty(n_pocket, r_nf)
    if "num_virtual_atoms" in items[0]:
        lig["num_virtual_atoms"] = np.array(
            [it["num_virtual_atoms"] for it in items], np.int32)

    for b, it in enumerate(items):
        nl, npk = len(it["lig_coords"]), len(it["pocket_coords"])
        if nl > n_lig or npk > n_pocket:
            raise ValueError(
                f"complex ({nl}, {npk}) exceeds padded shape ({n_lig}, {n_pocket})")
        for part, n, key in ((lig, nl, "lig"), (pkt, npk, "pocket")):
            part["x"][b, :n] = it[f"{key}_coords"]
            part["one_hot"][b, :n] = it[f"{key}_one_hot"]
            part["mask"][b, :n] = 1.0
            part["size"][b] = n

    return {"ligand": lig, "pocket": pkt,
            "names": [it.get("names", "") for it in items],
            "receptors": [it.get("receptors", "") for it in items]}


class AppendVirtualNodes:
    """Pad every ligand to a fixed size with 'Ne' virtual atoms sampled around
    the real atoms."""

    def __init__(self, max_ligand_size: int, atom_encoder: dict, symbol: str,
                 rng: Optional[np.random.Generator] = None):
        self.max_ligand_size = max_ligand_size
        self.atom_encoder = atom_encoder
        self.vidx = atom_encoder[symbol]
        self.rng = rng or np.random.default_rng()

    def __call__(self, data: dict) -> dict:
        data = dict(data)
        n_real = len(data["lig_coords"])
        n_virt = self.max_ligand_size - n_real
        mu = data["lig_coords"].mean(0, keepdims=True)
        # sample standard deviation (ddof=1); a 1-atom ligand gets sigma = 0
        sigma = data["lig_coords"].std(0, ddof=1).max() if n_real > 1 else 0.0
        virt_coords = self.rng.standard_normal((n_virt, 3)).astype(np.float32) \
            * sigma + mu

        one_hot = data["lig_one_hot"]
        # insert the virtual-atom column at vidx
        one_hot = np.concatenate(
            [one_hot[:, :self.vidx], np.zeros((n_real, 1), one_hot.dtype),
             one_hot[:, self.vidx:]], axis=1)
        virt_one_hot = np.zeros((n_virt, len(self.atom_encoder)), one_hot.dtype)
        virt_one_hot[:, self.vidx] = 1.0

        data["lig_coords"] = np.concatenate(
            [data["lig_coords"], virt_coords.astype(np.float32)])
        data["lig_one_hot"] = np.concatenate([one_hot, virt_one_hot])
        data["num_virtual_atoms"] = n_virt
        return data


class LigandPocketDataset:
    """Per-complex view over a preprocessed npz split file: splits the flat
    arrays by the graph-id masks and centres each complex at the joint
    ligand + pocket CoM."""

    def __init__(self, npz_path, center: bool = True,
                 transform: Optional[Callable] = None):
        self.transform = transform
        with np.load(npz_path, allow_pickle=True) as f:
            data = {key: val for key, val in f.items()}

        self.data: Dict[str, list] = {}
        for k, v in data.items():
            if k in ("names", "receptors"):
                self.data[k] = list(v)
                continue
            mask_key = "lig_mask" if "lig" in k else "pocket_mask"
            sections = np.where(np.diff(data[mask_key]))[0] + 1
            self.data[k] = [x.astype(np.float32) if x.dtype.kind == "f" else x
                            for x in np.split(v, sections)]

        if center:
            for i in range(len(self.data["lig_coords"])):
                lc = self.data["lig_coords"][i]
                pc = self.data["pocket_coords"][i]
                mean = (lc.sum(0) + pc.sum(0)) / (len(lc) + len(pc))
                self.data["lig_coords"][i] = (lc - mean).astype(np.float32)
                self.data["pocket_coords"][i] = (pc - mean).astype(np.float32)

    def __len__(self):
        return len(self.data["names"])

    def __getitem__(self, idx) -> dict:
        item = {k: v[idx] for k, v in self.data.items()}
        if self.transform is not None:
            item = self.transform(item)
        return item

    def max_sizes(self):
        nl = max(len(c) for c in self.data["lig_coords"])
        npk = max(len(c) for c in self.data["pocket_coords"])
        return nl, npk


class PaddedLoader:
    """Shuffling batch iterator producing padded numpy batches.

    ``fixed_shape=True`` pads every batch to the split's maximum (one padded
    shape); otherwise each batch is padded to its own (lig, pocket) size
    buckets.  A short last batch is filled by repeating items, so the batch
    dimension is static, unless ``drop_last``.

    Data parallelism (the reference's per-rank DistributedSampler):
    ``batch_size`` is the global batch, and with ``process_index`` /
    ``process_count`` (a rank and its data group's size) each rank yields its
    contiguous ``batch_size // process_count`` slice of every global batch.
    Every rank must build its loader with a same-seeded ``rng``, so that the
    shuffle orders agree (the default rng(0) does), and keep
    ``fixed_shape=True``, so that the ranks' padded shapes agree.
    """

    def __init__(self, dataset: LigandPocketDataset, batch_size: int,
                 lig_bucket: int = 8, pocket_bucket: int = 64,
                 shuffle: bool = True, drop_last: bool = False,
                 fixed_shape: bool = True,
                 rng: Optional[np.random.Generator] = None,
                 process_index: int = 0, process_count: int = 1):
        if process_count < 1 or batch_size % process_count != 0:
            raise ValueError(f"batch_size {batch_size} is not divisible by "
                             f"process_count {process_count}")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not in "
                             f"[0, {process_count})")
        self.process_index = process_index
        self.process_count = process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.lig_bucket = lig_bucket
        self.pocket_bucket = pocket_bucket
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = rng or np.random.default_rng(0)
        self.fixed_shape = fixed_shape
        nl, npk = dataset.max_sizes()
        if isinstance(dataset.transform, AppendVirtualNodes):
            # the transform pads every ligand to its fixed size; max_sizes()
            # sees only the raw complexes
            nl = max(nl, dataset.transform.max_ligand_size)
        self.n_lig_max = round_to_bucket(nl, lig_bucket)
        self.n_pocket_max = round_to_bucket(npk, pocket_bucket)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, dict]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        transform = self.dataset.transform
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            with span("data.batch"):
                batch = self._batch(order, idx, transform)
            yield batch

    def _batch(self, order, idx, transform) -> Dict[str, dict]:
        """The padded batch of the items ``idx`` of the shuffled ``order``
        (a short last one filled from ``order``)."""
        if len(idx) < self.batch_size:
            # np.resize tiles `order` as often as needed, so this holds
            # even when batch_size > 2 * len(dataset)
            idx = np.concatenate(
                [idx, np.resize(order, self.batch_size - len(idx))])
        if self.process_count > 1:
            # this rank's slice; the bucket shapes below come from the
            # slice when fixed_shape is False
            local = self.batch_size // self.process_count
            idx = idx[self.process_index * local:(self.process_index + 1) * local]
        if self.fixed_shape:
            n_lig, n_pocket = self.n_lig_max, self.n_pocket_max
        else:
            raw_max = max(len(self.dataset.data["lig_coords"][int(i)])
                          for i in idx)
            if isinstance(transform, AppendVirtualNodes):
                raw_max = max(raw_max, transform.max_ligand_size)
            n_lig = round_to_bucket(raw_max, self.lig_bucket)
            n_pocket = round_to_bucket(
                max(len(self.dataset.data["pocket_coords"][int(i)])
                    for i in idx), self.pocket_bucket)
        return pad_batch([self.dataset[int(i)] for i in idx], n_lig, n_pocket)


def load_size_histogram(datadir) -> np.ndarray:
    """``size_distribution.npy`` written by the processing scripts."""
    return np.load(Path(datadir, "size_distribution.npy"))


class PrefetchLoader:
    """Batches of any iterable assembled in a background thread, up to
    ``depth`` ahead on a bounded queue: the counterpart of the reference
    DataLoader's ``num_workers``.  The thread pads the next batches while
    the consumer waits on the card (a wait that releases the interpreter
    lock).  Yields the wrapped
    loader's batches unchanged and in order; an error of the loader is raised
    on the consumer, and a consumer that stops early (a ``break``, an error
    in the step) leaves no thread blocked."""

    _DONE = object()

    def __init__(self, loader, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except BaseException as e:  # raised again on the consumer
                err.append(e)
            finally:
                put(self._DONE)

        thread = threading.Thread(target=work, name="diffsbdd-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is self._DONE:
                    break
                yield batch
        finally:
            stop.set()
            thread.join()
        if err:
            raise err[0]
