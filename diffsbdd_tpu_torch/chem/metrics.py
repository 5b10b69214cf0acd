"""Molecular quality metrics without RDKit.

Validity is the valence-table check, uniqueness and novelty compare
Weisfeiler-Lehman keys, diversity is a Tanimoto distance over WL
fingerprints, and QED, SA, logP and the Lipinski rules come from
``chem/descriptors.py``.  Names and return structures are those of the
reference's metrics (``evaluate_mols``, ``evaluate``, ``evaluate_mean``).
"""
from __future__ import annotations

from copy import deepcopy
from typing import List, Sequence, Tuple

import numpy as np

from diffsbdd_tpu_torch.chem import descriptors
from diffsbdd_tpu_torch.chem.molecule import SimpleMol, build_molecule
from diffsbdd_tpu_torch.chem.sascore import calculate_score


class CategoricalDistribution:
    """KL divergence of an empirical type histogram from the dataset prior."""

    EPS = 1e-10

    def __init__(self, histogram_dict, mapping):
        histogram = np.zeros(len(mapping))
        for k, v in histogram_dict.items():
            histogram[mapping[k]] = v
        self.p = histogram / histogram.sum()
        self.mapping = deepcopy(mapping)

    def kl_divergence(self, other_sample: Sequence[int]) -> float:
        sample_histogram = np.zeros(len(self.mapping))
        for x in other_sample:
            sample_histogram[int(x)] += 1
        q = sample_histogram / max(sample_histogram.sum(), 1)
        # zero-probability classes contribute nothing (p log p/q -> 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            terms = -self.p * np.log(q / self.p + self.EPS)
        return float(np.sum(np.where(self.p > 0, terms, 0.0)))


def wl_fingerprint(mol: SimpleMol, radius: int = 2) -> set:
    """Morgan/ECFP-like fingerprint: the set of WL environment hashes up to
    ``radius`` iterations."""
    return set().union(*mol.wl_labels(radius))


class BasicMolecularMetrics:
    """Validity / connectivity / uniqueness / novelty."""

    def __init__(self, dataset_info, dataset_smiles_list=None,
                 connectivity_thresh: float = 1.0):
        self.atom_decoder = dataset_info["atom_decoder"]
        self.dataset_smiles_list = (set(dataset_smiles_list)
                                    if dataset_smiles_list is not None else None)
        self.dataset_info = dataset_info
        self.connectivity_thresh = connectivity_thresh

    def compute_validity(self, generated: List[SimpleMol]):
        if len(generated) < 1:
            return [], 0.0
        valid = [m for m in generated if m is not None and m.check_valency()]
        return valid, len(valid) / len(generated)

    def compute_connectivity(self, valid: List[SimpleMol]):
        """The largest fragment must hold >= connectivity_thresh of all
        atoms."""
        if len(valid) < 1:
            return [], 0.0, []
        connected, connected_keys = [], []
        for mol in valid:
            largest = mol.largest_fragment()
            if largest.n_atoms / mol.n_atoms >= self.connectivity_thresh:
                connected_keys.append(largest.to_smiles())
                connected.append(largest)
        return connected, len(connected_keys) / len(valid), connected_keys

    def compute_uniqueness(self, connected_keys: List[str]):
        if len(connected_keys) < 1:
            return [], 0.0
        return (list(set(connected_keys)),
                len(set(connected_keys)) / len(connected_keys))

    def compute_novelty(self, unique: List[str]):
        """Novelty against the training keys; -1.0 (not computed) without
        them."""
        if self.dataset_smiles_list is None:
            return [], -1.0
        if len(unique) < 1:
            return [], 0.0
        novel = [s for s in unique if s not in self.dataset_smiles_list]
        return novel, len(novel) / len(unique)

    def evaluate_mols(self, mols: List[SimpleMol]):
        valid, validity = self.compute_validity(mols)
        connected, connectivity, connected_keys = \
            self.compute_connectivity(valid)
        unique, uniqueness = self.compute_uniqueness(connected_keys)
        _, novelty = self.compute_novelty(unique)
        return [validity, connectivity, uniqueness, novelty], [valid, connected]

    def evaluate(self, generated: List[Tuple[np.ndarray, np.ndarray]]):
        """The same from (coordinates, type indices) pairs."""
        mols = [build_molecule(*graph, self.dataset_info)
                for graph in generated]
        return self.evaluate_mols(mols)


class MoleculeProperties:
    """QED / SA / logP / Lipinski / diversity."""

    @staticmethod
    def calculate_qed(mol) -> float:
        return descriptors.qed_score(mol)

    @staticmethod
    def calculate_sa(mol) -> float:
        return round((10 - calculate_score(mol)) / 9, 2)  # pocket2mol rescaling

    @staticmethod
    def calculate_logp(mol) -> float:
        return descriptors.logp_estimate(mol)

    @staticmethod
    def calculate_lipinski(mol) -> float:
        """Heavy-atom graphs carry no explicit H: the donor and logP rules
        count as satisfied, acceptors are the N + O count."""
        rule_1 = descriptors.molecular_weight(mol) < 500
        rule_2 = True
        rule_3 = sum(1 for s in mol.symbols if s in ("N", "O")) <= 10
        rule_4 = True
        rule_5 = descriptors.rotatable_bonds(mol) <= 10
        return float(sum(int(r) for r in (rule_1, rule_2, rule_3, rule_4,
                                          rule_5)))

    @staticmethod
    def similarity(mol_a, mol_b) -> float:
        fa, fb = wl_fingerprint(mol_a), wl_fingerprint(mol_b)
        if not fa and not fb:
            return 1.0
        return len(fa & fb) / max(len(fa | fb), 1)

    @classmethod
    def calculate_diversity(cls, pocket_mols) -> float:
        if len(pocket_mols) < 2:
            return 0.0
        div, total = 0.0, 0
        for i in range(len(pocket_mols)):
            for j in range(i + 1, len(pocket_mols)):
                div += 1 - cls.similarity(pocket_mols[i], pocket_mols[j])
                total += 1
        return div / total

    def evaluate(self, pocket_mols: List[List[SimpleMol]]):
        """Per-pocket lists of QED, SA, logP, Lipinski, and each pocket's
        diversity."""
        all_qed, all_sa, all_logp, all_lipinski, per_pocket_div = \
            [], [], [], [], []
        for pocket in pocket_mols:
            all_qed.append([self.calculate_qed(m) for m in pocket])
            all_sa.append([self.calculate_sa(m) for m in pocket])
            all_logp.append([self.calculate_logp(m) for m in pocket])
            all_lipinski.append([self.calculate_lipinski(m) for m in pocket])
            per_pocket_div.append(self.calculate_diversity(pocket))
        return all_qed, all_sa, all_logp, all_lipinski, per_pocket_div

    def evaluate_mean(self, mols: List[SimpleMol]):
        if len(mols) < 1:
            return 0.0, 0.0, 0.0, 0.0, 0.0
        qed = float(np.mean([self.calculate_qed(m) for m in mols]))
        sa = float(np.mean([self.calculate_sa(m) for m in mols]))
        logp = float(np.mean([self.calculate_logp(m) for m in mols]))
        lipinski = float(np.mean([self.calculate_lipinski(m) for m in mols]))
        diversity = self.calculate_diversity(mols)
        return qed, sa, logp, lipinski, diversity
