"""Synthetic accessibility (Ertl & Schuffenhauer) scoring without RDKit:
the estimate of ``chem/descriptors.py`` (complexity and symmetry terms
exact, fragment-frequency term approximated), which never returns NaN."""
from __future__ import annotations

from diffsbdd_tpu_torch.chem.descriptors import sa_score
from diffsbdd_tpu_torch.chem.molecule import SimpleMol


def calculate_score(mol) -> float:
    """SA score in [1, 10] (lower = easier to make) of a SimpleMol."""
    if not isinstance(mol, SimpleMol):
        raise TypeError(f"calculate_score takes a SimpleMol, not "
                        f"{type(mol).__name__} (the port has no RDKit)")
    return sa_score(mol)
