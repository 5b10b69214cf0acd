"""PyTorch/CUDA port of diffsbdd_tpu: pocket-conditional ligand sampling
with hand-written Hopper kernels for the EGNN's pairwise work."""
