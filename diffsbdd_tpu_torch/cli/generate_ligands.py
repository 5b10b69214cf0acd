"""De-novo ligand generation for one pocket.

    python -m diffsbdd_tpu_torch.cli.generate_ligands <ckpt_dir> \\
        --pdbfile pocket.pdb --ref_ligand A:330 --outfile out.sdf \\
        --n_samples 20 [--device cpu]

The pocket is the residues near ``--ref_ligand`` (a ligand residue
'<chain>:<resi>' of the PDB, or an SDF file) or the ``--resi_list``.
Runs on CUDA unless ``--device cpu`` is given.  A joint checkpoint generates
by inpainting with the whole pocket fixed; ``--resamplings`` and
``--jump_length`` set its RePaint schedule and a conditional checkpoint does
not read them.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from diffsbdd_tpu_torch.checkpoint import load_model
from diffsbdd_tpu_torch.chem.sdfio import write_sdf_file
from diffsbdd_tpu_torch.utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", type=Path)
    p.add_argument("--pdbfile", type=str, required=True)
    p.add_argument("--resi_list", type=str, nargs="+", default=None)
    p.add_argument("--ref_ligand", type=str, default=None)
    p.add_argument("--outfile", type=Path, required=True)
    p.add_argument("--n_samples", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_nodes_lig", type=int, default=None)
    p.add_argument("--all_frags", action="store_true")
    p.add_argument("--sanitize", action="store_true")
    p.add_argument("--relax", action="store_true")
    p.add_argument("--resamplings", type=int, default=10)
    p.add_argument("--jump_length", type=int, default=1)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    module, _ = load_model(args.checkpoint, device=device)
    if args.num_nodes_lig is None and module.ddpm.size_distribution is None:
        p.error("the checkpoint has no ligand size prior: pass --num_nodes_lig")

    batch_size = args.batch_size or args.n_samples
    generator = torch.Generator(device=device).manual_seed(args.seed)
    size_rng = np.random.default_rng(args.seed)
    molecules = []
    # bounded retry budget: filters can reject every molecule of a batch
    max_batches = 3 * -(-args.n_samples // batch_size) + 3
    for _ in range(max_batches):
        if len(molecules) >= args.n_samples:
            break
        num_nodes = None if args.num_nodes_lig is None else \
            np.full(batch_size, args.num_nodes_lig)
        molecules.extend(module.generate_ligands(
            args.pdbfile, batch_size, generator,
            pocket_ids=args.resi_list, ref_ligand=args.ref_ligand,
            num_nodes_lig=num_nodes, sanitize=args.sanitize,
            largest_frag=not args.all_frags,
            relax_iter=(200 if args.relax else 0),
            timesteps=args.timesteps, size_rng=size_rng,
            resamplings=args.resamplings, jump_length=args.jump_length))

    if len(molecules) < args.n_samples:
        print(f"warning: only {len(molecules)}/{args.n_samples} molecules "
              f"survived filtering within the retry budget")
    molecules = molecules[:args.n_samples]
    args.outfile.parent.mkdir(parents=True, exist_ok=True)
    write_sdf_file(args.outfile, molecules)
    print(f"wrote {len(molecules)} molecules to {args.outfile}")


if __name__ == "__main__":
    main()
