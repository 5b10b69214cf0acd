"""Joint (n_ligand, n_pocket) size prior: a smoothed 2-D histogram over node
counts with its conditionals.  Sampling decides shapes, so it is host-side
numpy; the log-probabilities of the training loss are gathers from float32
tables that follow the tensors they are asked about onto their device."""
from __future__ import annotations

import numpy as np
import torch


class SizeDistribution:
    def __init__(self, histogram):
        # the raw histogram is what checkpoints persist: re-smoothing an
        # already-normalized table would flatten the prior on every save/load
        self.raw_histogram = np.asarray(histogram, dtype=np.float64)
        if self.raw_histogram.ndim != 2:
            raise ValueError("size histogram must be 2-D: (n_lig+1, n_pocket+1)")
        histogram = self.raw_histogram + 1e-3
        self.prob = histogram / histogram.sum()
        self.n2_max = histogram.shape[1] - 1
        self.prob_n1_given_n2 = self.prob / self.prob.sum(axis=0, keepdims=True)
        self._log_tables = {
            "joint": torch.as_tensor(np.log(self.prob), dtype=torch.float32),
            "n1_given_n2": torch.as_tensor(np.log(self.prob_n1_given_n2),
                                           dtype=torch.float32)}

    def sample(self, n_samples: int = 1, rng: np.random.Generator | None = None):
        """Sample (n_lig, n_pocket) pairs from the joint prior."""
        rng = rng or np.random.default_rng()
        flat = self.prob.reshape(-1)
        idx = rng.choice(len(flat), size=n_samples, p=flat)
        n1, n2 = np.unravel_index(idx, self.prob.shape)
        return n1.astype(np.int32), n2.astype(np.int32)

    def sample_conditional(self, n2, rng: np.random.Generator | None = None):
        """Sample ligand sizes n1 ~ p(n1 | n2) for pocket sizes ``n2``."""
        rng = rng or np.random.default_rng()
        table = self.prob_n1_given_n2
        out = [rng.choice(table.shape[0], p=table[:, c])
               for c in np.clip(np.asarray(n2), 0, self.n2_max)]
        return np.asarray(out, dtype=np.int32)

    def _gather(self, name: str, n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
        table = self._log_tables[name]
        if table.device != n1.device:
            table = self._log_tables[name] = table.to(n1.device)
        return table[n1.long(), n2.long()]

    def log_prob(self, n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
        """log p(n1, n2) for integer tensors of node counts."""
        return self._gather("joint", n1, n2)

    def log_prob_n1_given_n2(self, n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
        """log p(n1 | n2), the conditional model's log p(N)."""
        return self._gather("n1_given_n2", n1, n2)
