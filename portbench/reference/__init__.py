"""Plain float32 PyTorch reference of what the benchmark's cells run: the
EGNN dynamics of DiffSBDD (``model``), its noise schedule (``schedule``),
the pocket-conditional sampler's steps (``sampler``), the joint model's
training loss and optimizer step (``joint``), the full-atom pocket read
from a PDB file (``pocket``) and the weights (``weights``).

It imports torch and numpy only: nothing of the program under test and no
JAX.  Every matrix product goes through ``model.mm``, which computes in
float32 (TF32 off) or, for the control, with both operands rounded to TF32.
"""
