"""Input generators of the benchmark's traffic mixes: synthetic full-atom
pockets written as PDB files (``pockets``) and synthetic processed training
sets (``dataset``), all from seeds."""
