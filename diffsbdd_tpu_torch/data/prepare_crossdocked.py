"""Baseline methods' sampled molecules -> one SDF file a pocket.

    python -m diffsbdd_tpu_torch.data.prepare_crossdocked <samples.pt> --outdir <dir>

Takes a CrossDocked test-set dump of a baseline method's samples (a torch
pickle mapping a (receptor, reference ligand) key, or one name, to a molecule
or a list of them) and writes ``<receptor>-<ligand>_gen.sdf`` for each pocket,
so that every method is scored by the same metrics and docking tools.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from diffsbdd_tpu_torch.chem.sdfio import write_sdf_file


def collect(samples_path, outdir) -> int:
    """Write one SDF a key of the dump; returns how many were written.  The
    dump is unpickled with ``weights_only=False``: read only files from a
    source you trust."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    data = torch.load(samples_path, map_location="cpu", weights_only=False)
    n_written = 0
    for key, mols in data.items():
        if isinstance(key, (tuple, list)):
            receptor = Path(str(key[0])).stem
            ligand = Path(str(key[1])).stem
            name = f"{receptor}_{ligand}".replace("_", "-")
        else:
            name = Path(str(key)).stem.replace("_", "-")
        out = outdir / f"{name}_gen.sdf"
        write_sdf_file(out, mols if isinstance(mols, (list, tuple)) else [mols])
        n_written += 1
    return n_written


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("samples", type=Path,
                   help=".pt dump of baseline samples keyed by pocket")
    p.add_argument("--outdir", type=Path, required=True)
    args = p.parse_args(argv)
    n = collect(args.samples, args.outdir)
    print(f"wrote {n} per-pocket SDF files to {args.outdir}")


if __name__ == "__main__":
    main()
