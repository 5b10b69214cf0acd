"""Test-set benchmark sampler.

For every test SDF ``<pdb>_<chain>_<lig>.sdf`` of ``--test_dir`` (beside its
pocket ``<pdb>.pdb`` and residue list ``<pdb>_<chain>_<lig>.txt``): sample
in batches until ``n_samples`` molecules pass the filters (retrying up to
MAXNTRIES times on failure), write the raw and processed SDFs and the
pocket's wall time, and report the mean +/- std time per pocket.

    python -m diffsbdd_tpu_torch.cli.test_set <ckpt_dir> --test_dir <dir> \\
        --outdir out/ [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import warnings
from pathlib import Path
from time import time

import numpy as np
import torch

from diffsbdd_tpu_torch.checkpoint import load_model
from diffsbdd_tpu_torch.chem.molecule import process_molecule
from diffsbdd_tpu_torch.chem.sdfio import read_sdf, write_sdf_file
from diffsbdd_tpu_torch.utils.device import resolve_device

MAXITER = 10
MAXNTRIES = 10


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", type=Path)
    p.add_argument("--test_dir", type=Path, required=True)
    p.add_argument("--test_list", type=Path, default=None)
    p.add_argument("--outdir", type=Path, required=True)
    p.add_argument("--n_samples", type=int, default=100)
    p.add_argument("--all_frags", action="store_true")
    p.add_argument("--sanitize", action="store_true")
    p.add_argument("--relax", action="store_true")
    p.add_argument("--batch_size", type=int, default=120)
    p.add_argument("--resamplings", type=int, default=10)
    p.add_argument("--jump_length", type=int, default=1)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--fix_n_nodes", action="store_true")
    p.add_argument("--n_nodes_bias", type=int, default=0)
    p.add_argument("--n_nodes_min", type=int, default=0)
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    module, _ = load_model(args.checkpoint, device=device)
    if not args.fix_n_nodes and not module.virtual_nodes \
            and module.ddpm.size_distribution is None:
        p.error("the checkpoint has no ligand size prior: pass --fix_n_nodes")

    args.outdir.mkdir(parents=True, exist_ok=args.skip_existing)
    raw_dir = Path(args.outdir, "raw")
    raw_dir.mkdir(exist_ok=args.skip_existing)
    processed_dir = Path(args.outdir, "processed")
    processed_dir.mkdir(exist_ok=args.skip_existing)
    times_dir = Path(args.outdir, "pocket_times")
    times_dir.mkdir(exist_ok=args.skip_existing)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    size_rng = np.random.default_rng(args.seed)

    test_files = sorted(args.test_dir.glob("[!.]*.sdf"))
    if args.test_list is not None:
        with open(args.test_list) as f:
            keep = set(f.read().split(","))
        test_files = [x for x in test_files if x.stem in keep]

    time_per_pocket = {}
    for sdf_file in test_files:
        ligand_name = sdf_file.stem
        pdb_name = ligand_name.split("_")[0]
        pdb_file = Path(sdf_file.parent, f"{pdb_name}.pdb")
        txt_file = Path(sdf_file.parent, f"{ligand_name}.txt")
        raw_out = Path(raw_dir, f"{ligand_name}_gen.sdf")
        processed_out = Path(processed_dir, f"{ligand_name}_gen.sdf")
        time_file = Path(times_dir, f"{ligand_name}.txt")

        if args.skip_existing and time_file.exists() \
                and processed_out.exists() and raw_out.exists():
            with open(time_file) as f:
                # "<sdf path> <seconds>": the last token, whatever the path
                time_per_pocket[str(sdf_file)] = float(f.read().split()[-1])
            continue

        for n_try in range(MAXNTRIES):
            try:
                t_start = time()
                with open(txt_file) as f:
                    resi_list = f.read().split()

                num_nodes_lig = None
                if args.fix_n_nodes:
                    num_nodes_lig = np.full(
                        args.batch_size, read_sdf(sdf_file)[0].n_atoms)

                all_molecules = []
                valid_molecules = []
                processed_molecules = []
                n_generated, n_valid, iteration = 0, 0, 0
                while len(valid_molecules) < args.n_samples:
                    iteration += 1
                    if iteration > MAXITER:
                        raise RuntimeError(
                            "Maximum number of iterations exceeded.")
                    # every filter off first; they are applied below
                    _, mols_batch = module.generate_ligands(
                        pdb_file, args.batch_size, generator,
                        pocket_ids=resi_list, num_nodes_lig=num_nodes_lig,
                        timesteps=args.timesteps, sanitize=False,
                        largest_frag=False, relax_iter=0,
                        n_nodes_bias=args.n_nodes_bias,
                        n_nodes_min=max(args.n_nodes_min, 1),
                        resamplings=args.resamplings,
                        jump_length=args.jump_length,
                        size_rng=size_rng, return_raw=True)
                    all_molecules.extend(mols_batch)

                    batch_processed = [
                        process_molecule(
                            m, sanitize=args.sanitize,
                            relax_iter=(200 if args.relax else 0),
                            largest_frag=not args.all_frags)
                        for m in mols_batch]
                    processed_molecules.extend(batch_processed)
                    valid_batch = [m for m in batch_processed if m is not None]
                    n_generated += args.batch_size
                    n_valid += len(valid_batch)
                    valid_molecules.extend(valid_batch)

                valid_molecules = valid_molecules[:args.n_samples]
                # the raw SDF lists the molecules that passed the filters first
                all_molecules = \
                    [all_molecules[i] for i, m in enumerate(processed_molecules)
                     if m is not None] + \
                    [all_molecules[i] for i, m in enumerate(processed_molecules)
                     if m is None]
                write_sdf_file(raw_out, all_molecules)
                write_sdf_file(processed_out, valid_molecules)

                time_per_pocket[str(sdf_file)] = time() - t_start
                with open(time_file, "w") as f:
                    f.write(f"{sdf_file} {time_per_pocket[str(sdf_file)]}")
                print(f"{ligand_name}: validity "
                      f"{n_valid / max(n_generated, 1) * 100:.2f}%, "
                      f"{(time() - t_start) / max(len(valid_molecules), 1):.2f}"
                      f" sec/mol")
                break
            except (RuntimeError, ValueError) as e:
                if n_try >= MAXNTRIES - 1:
                    raise RuntimeError("Maximum number of retries exceeded")
                warnings.warn(f"Attempt {n_try + 1}/{MAXNTRIES} failed: {e}")

    with open(Path(args.outdir, "pocket_times.txt"), "w") as f:
        for k, v in time_per_pocket.items():
            f.write(f"{k} {v}\n")

    times = np.array(list(time_per_pocket.values()))
    print(f"Time per pocket: {times.mean():.3f} \\pm {times.std():.2f}")


if __name__ == "__main__":
    main()
