"""Training CLI.

    python -m diffsbdd_tpu_torch.cli.train --config configs/crossdock_fullatom_cond.yml
    python -m diffsbdd_tpu_torch.cli.train --config ... --resume <ckpt_dir>

The YAML presets are those of the JAX package.  ``--resume`` restores weights,
optimizer state and the checkpoint's hyperparameters (the checkpoint's config
takes precedence, with warnings).  Runs on CUDA unless ``--device cpu`` is
given.  Besides training, validating and checkpointing, the run samples
from the model on the config's schedules (``eval_epochs``,
``visualize_sample_epoch``, ``visualize_chain_epoch``, ``eval_params``): the
quality metrics of ``analyze_samples`` on validation pockets (novelty against
``train_smiles.npy`` where the data directory has it), and xyz dumps of
samples and of a denoising chain with their renders under
``<logdir>/<run_name>/eval``.

On several cards, one process each:

    torchrun --nproc_per_node=N -m diffsbdd_tpu_torch.cli.train --config ...

joins the NCCL process group that torchrun's environment describes (gloo with
``--device cpu``), splits every global batch of ``batch_size`` over the
``tpu.mesh_data`` ranks of the data group (-1: all of them; it must hold
every rank and divide the batch), averages each step's gradients over them,
and leaves metrics, checkpoints and the sampling evaluation to rank 0.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from diffsbdd_tpu_torch.config import load_config, merge_configs
from diffsbdd_tpu_torch.data.dataset import (AppendVirtualNodes, LigandPocketDataset,
                                             PaddedLoader, load_size_histogram)
from diffsbdd_tpu_torch.parallel.mesh import (broadcast_module, group_rank_size,
                                              init_distributed, make_data_group,
                                              rank_seed)
from diffsbdd_tpu_torch.train.evaluation import SamplingEvaluator
from diffsbdd_tpu_torch.train.loop import (Trainer, create_train_state,
                                           restore_checkpoint)
from diffsbdd_tpu_torch.train.module import build_module_from_config
from diffsbdd_tpu_torch.utils.device import resolve_device


class WandbLogger:
    """Logs to wandb when the config enables it and the package is there."""

    def __init__(self, cfg):
        self.run = None
        mode = cfg.wandb_params.get("mode", "disabled")
        if mode != "disabled":
            try:
                import wandb
            except ImportError:
                print("wandb not installed; metrics are not logged")
                return
            self.run = wandb.init(
                project="ligand-pocket-ddpm", name=cfg.run_name, id=cfg.run_name,
                group=cfg.wandb_params.get("group"),
                entity=cfg.wandb_params.get("entity"), mode=mode, dir=cfg.logdir)

    def log(self, metrics, step):
        if self.run is not None:
            self.run.log(metrics, step=step)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.resume is not None:
        resume_cfg_file = sorted(Path(args.resume).glob("*.config.json"))
        if resume_cfg_file:
            resume_config = json.loads(resume_cfg_file[-1].read_text())
            resume_config.pop("node_histogram", None)
            cfg = load_config(
                args.config, overrides=merge_configs(cfg.to_dict(), resume_config))

    # a multi-process run: join its group before anything is built; the
    # process then owns card LOCAL_RANK
    init_distributed(cfg, device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    group = make_data_group(cfg.tpu.get("mesh_data", -1)) \
        if torch.distributed.is_initialized() else None
    rank, n_ranks = group_rank_size(group)
    if group is not None:
        print(f"rank {rank} of {n_ranks} in the data group "
              f"({torch.distributed.get_backend(group)})")

    histogram = load_size_histogram(cfg.datadir)
    torch.manual_seed(cfg.seed)  # the initial weights
    module = build_module_from_config(cfg, histogram).to(device)

    transform = None
    if cfg.virtual_nodes:
        transform = AppendVirtualNodes(module.max_num_nodes, module.lig_type_encoder, "Ne")
    train_ds = LigandPocketDataset(Path(cfg.datadir, "train.npz"), transform=transform)
    val_ds = LigandPocketDataset(Path(cfg.datadir, "val.npz"), transform=transform)
    # same-seeded shuffles on every rank; each yields its slice of a batch
    buckets = dict(lig_bucket=cfg.tpu.lig_bucket, pocket_bucket=cfg.tpu.pocket_bucket,
                   process_index=rank, process_count=n_ranks)
    train_loader = PaddedLoader(train_ds, cfg.batch_size, shuffle=True,
                                rng=np.random.default_rng(cfg.seed), **buckets)
    val_loader = PaddedLoader(val_ds, cfg.batch_size, shuffle=False, **buckets)

    state = create_train_state(module, lr=cfg.lr)
    if args.resume is not None:
        state, _ = restore_checkpoint(args.resume, state, name="last")
        print(f"resumed from {args.resume} at step {state.step}")
    broadcast_module(module, group)

    logger = WandbLogger(cfg)
    smiles_file = Path(cfg.datadir, "train_smiles.npy")
    train_smiles = np.load(smiles_file, allow_pickle=True) \
        if smiles_file.exists() else None
    wandb_mod = None
    if logger.run is not None:
        import wandb as wandb_mod  # the module, for its Image and Video
    evaluator = SamplingEvaluator(
        module, dataset=val_ds, dataset_smiles=train_smiles,
        outdir=Path(cfg.logdir) / cfg.run_name / "eval", wandb=wandb_mod,
        datadir=cfg.datadir)

    # each rank draws its own noise
    generator = torch.Generator(device=device).manual_seed(rank_seed(cfg.seed, rank))
    trainer = Trainer(module, cfg, train_loader, val_loader, logger=logger,
                      evaluator=evaluator, group=group)
    try:
        trainer.fit(state, generator, n_epochs=cfg.n_epochs)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
