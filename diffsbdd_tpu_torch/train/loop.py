"""Training loop: the optimizer, adaptive gradient clipping, the train and
eval steps, checkpoints and the epoch-driven ``Trainer``.

What the JAX package's loop does and this one keeps: AdamW-with-amsgrad as
optax composes it (weight decay 1e-12), gradient-norm clipping at
1.5 * mean + 2 * std of a 50-step history, gradient accumulation over
micro-batches, best + last checkpoints on the validation loss, metric dicts
with the reference's names.  Not ported: chaining several optimizer steps into
one dispatch (``chain_steps`` / ``steps_per_dispatch``, which hid a remote
device's dispatch latency).

Data parallelism, one process per card (``parallel/mesh.py``): every rank of
a data group takes its slice of the global batch, and the step averages the
gradients, the loss and the metrics over the group with one packed
``all_reduce`` before the gradient-norm clipping, so that every rank clips by
the same norm and takes the same optimizer step (the JAX package's ``pmean``
on its data mesh).  The reduction is explicit rather than a
``DistributedDataParallel`` wrapper: the step takes its gradients with
``torch.autograd.grad``, and DDP's hooks fire on ``.backward()`` only.  One
difference from the JAX package: it shrinks its data mesh until the mesh
divides the batch, leaving devices idle; a rank here is a process that
cannot sit idle, so ``Trainer`` raises when the data group's size does not
divide ``batch_size``.

The step never reads a value back from the device: the gradient-norm history
and the clipping scale are device tensors, so the host runs ahead of the card
until a metric is logged.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from diffsbdd_tpu_torch.data.dataset import PrefetchLoader
from diffsbdd_tpu_torch.parallel.mesh import all_reduce_mean, group_rank_size
from diffsbdd_tpu_torch.utils.device import resolve_device
from diffsbdd_tpu_torch.utils.profiling import span

QUEUE_LEN = 50


class GradNormQueue:
    """Circular buffer of the last ``QUEUE_LEN`` (clipped) gradient norms,
    seeded with one large value that gets flushed."""

    def __init__(self, device="cpu"):
        self.values = torch.zeros(QUEUE_LEN, dtype=torch.float32, device=device)
        self.values[0] = 3000.0
        self.count = 1  # valid entries: values[:count]
        self.ptr = 1    # next write position

    def stats(self):
        """(mean, population standard deviation) of the valid entries."""
        valid = self.values[:self.count]
        mean = valid.mean()
        return mean, torch.sqrt(((valid - mean) ** 2).mean())

    def push(self, value: torch.Tensor) -> None:
        self.values[self.ptr % QUEUE_LEN] = value
        self.count = min(self.count + 1, QUEUE_LEN)
        self.ptr = (self.ptr + 1) % QUEUE_LEN

    def state_dict(self) -> Dict[str, Any]:
        return {"values": self.values.cpu(), "count": self.count, "ptr": self.ptr}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.values.copy_(torch.as_tensor(state["values"]))
        self.count, self.ptr = int(state["count"]), int(state["ptr"])


class AmsgradW:
    """The optimizer of the JAX package's training loop:
    ``optax.chain(scale_by_amsgrad(), add_decayed_weights(1e-12), scale(-lr))``.

    Not ``torch.optim.AdamW(amsgrad=True)``: optax bias-corrects both moments
    first and keeps the running maximum of the *corrected* second moment
    (``nu_max = max(nu_max, nu / (1 - b2^t))``, ``update = mu_hat /
    (sqrt(nu_max) + eps)``), where PyTorch keeps the maximum of the raw moment
    and corrects it with the current step; the two part ways at step 2.  The
    weight decay is added to the update before the learning rate scales it.
    The bias corrections ``1 - b^t`` are taken in float32, as optax takes them.
    """

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-12):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        one, t = np.float32(1), np.float32(self.count)
        c1 = float(one - np.power(np.float32(self.b1), t))
        c2 = float(one - np.power(np.float32(self.b2), t))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        nu_hat = torch._foreach_div(self.nu, c2)
        torch._foreach_maximum_(self.nu_max, nu_hat)
        denom = torch._foreach_sqrt(self.nu_max)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-self.lr)

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu,
                "nu_max": self.nu_max}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for name in ("mu", "nu", "nu_max"):
            for mine, theirs in zip(getattr(self, name), state[name], strict=True):
                mine.copy_(theirs)


@dataclasses.dataclass
class TrainState:
    module: torch.nn.Module
    optimizer: AmsgradW
    queue: GradNormQueue
    step: int = 0

    def train_state_dict(self) -> Dict[str, Any]:
        """What resuming needs beside the module's weights."""
        return {"optimizer": self.optimizer.state_dict(),
                "queue": self.queue.state_dict(), "step": self.step}

    def load_train_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.queue.load_state_dict(state["queue"])
        self.step = int(state["step"])


def create_train_state(module, lr: float) -> TrainState:
    """Optimizer state and gradient-norm history on the module's device."""
    return TrainState(module=module,
                      optimizer=AmsgradW(module.parameters(), lr),
                      queue=GradNormQueue(module.device))


def _split_batch(d: Dict[str, torch.Tensor], k: int) -> List[Dict[str, torch.Tensor]]:
    return [{key: v.chunk(k)[i] for key, v in d.items()} for i in range(k)]


def make_train_step(state: TrainState, clip_grad: bool = True,
                    accumulate_grad_batches: int = 1, group=None) -> Callable:
    """``step(generator, ligand, pocket) -> info``: one optimizer step on one
    batch.  ``accumulate_grad_batches`` > 1 splits the batch into that many
    micro-batches and averages their gradients, losses and metrics.  With a
    data ``group`` of more than one rank the batch is this rank's slice, and
    the (accumulated) gradients, the loss and the metrics are averaged over
    the group before the clipping (``generator`` is then the rank's own).
    The call is a ``train.step`` span and each micro-batch's loss and
    gradients a ``train.micro_batch`` span (``utils.profiling.span``)."""
    module, k_acc = state.module, accumulate_grad_batches
    params = list(module.parameters())
    n_ranks = group_rank_size(group)[1]

    def loss_and_grads(generator, ligand, pocket):
        with span("train.micro_batch"):
            loss, info = module.loss_fn(generator, ligand, pocket, training=True)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the loss does not reach (the pocket decoder of the
        # conditional model) has a zero gradient, not none
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)], info

    def step(generator, ligand, pocket):
        with span("train.step"):
            if k_acc <= 1:
                grads, info = loss_and_grads(generator, ligand, pocket)
            else:
                B = ligand["x"].shape[0]
                if B % k_acc != 0:
                    # with several ranks B is the rank's slice: the global batch
                    # must be divisible by ranks * k_acc
                    raise ValueError(
                        f"accumulate_grad_batches={k_acc} must divide the "
                        f"{'per-shard ' if n_ranks > 1 else ''}batch size {B}"
                        + (f" (= global batch / {n_ranks} devices)" if n_ranks > 1 else ""))
                grads, infos = None, []
                for lig, pkt in zip(_split_batch(ligand, k_acc), _split_batch(pocket, k_acc)):
                    g, info = loss_and_grads(generator, lig, pkt)
                    grads = g if grads is None else torch._foreach_add(grads, g)
                    infos.append(info)
                grads = torch._foreach_div(grads, k_acc)
                info = {k: torch.stack([i[k] for i in infos]).mean(0) for k in infos[0]}

            info = {k: v.detach() for k, v in info.items()}
            if n_ranks > 1:
                reduced = all_reduce_mean([*grads, *info.values()], group)
                grads = reduced[:len(grads)]
                info = dict(zip(info, reduced[len(grads):]))
            if clip_grad:
                # allow 150% + 2 standard deviations of the recent history
                mean, std = state.queue.stats()
                max_norm = 1.5 * mean + 2.0 * std
                gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
                scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
                grads = [g * scale for g in grads]
                state.queue.push(torch.minimum(gnorm, max_norm))
                info["grad_norm"] = gnorm
                info["max_grad_norm"] = max_norm
            state.optimizer.step(grads)
            state.step += 1
            return info

    return step


def make_eval_step(module, group=None) -> Callable:
    """``step(generator, ligand, pocket) -> info`` of the validation loss,
    averaged over the ranks of ``group``."""
    n_ranks = group_rank_size(group)[1]

    @torch.no_grad()
    def step(generator, ligand, pocket):
        info = module.loss_fn(generator, ligand, pocket, training=False)[1]
        if n_ranks > 1:
            info = dict(zip(info, all_reduce_mean(list(info.values()), group)))
        return info
    return step


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def restore_checkpoint(ckpt_dir, state: TrainState, name: str = "last"):
    """Load what ``checkpoint.save_model`` wrote for a trainer state --
    weights, optimizer state, gradient-norm history and step -- into ``state``;
    returns (state, the checkpoint's config dict or None)."""
    ckpt_dir = Path(ckpt_dir)
    device = state.module.device
    state.module.load_state_dict(
        torch.load(ckpt_dir / f"{name}.pt", map_location=device, weights_only=True),
        strict=True)
    state.load_train_state_dict(torch.load(
        ckpt_dir / f"{name}.train.pt", map_location=device, weights_only=True))
    cfg_file = ckpt_dir / f"{name}.config.json"
    config = json.loads(cfg_file.read_text()) if cfg_file.exists() else None
    return state, config


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

_ARRAY_FIELDS = ("x", "one_hot", "mask", "size", "num_virtual_atoms")


def batch_to_device(part: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The array fields of a padded ligand or pocket batch as tensors."""
    return {k: torch.as_tensor(part[k], device=device)
            for k in _ARRAY_FIELDS if k in part}


class Trainer:
    """Epoch-driven trainer with periodic validation, best / last checkpoints,
    an optional sampling evaluator and optional metric logging.

    Runs on the module's device, which the entry point picked through
    ``resolve_device``: the card unless the caller asked for the CPU, with
    float32 matrix products kept in full float32
    (``torch.backends.cuda.matmul.allow_tf32`` stays False), as the JAX
    reference trains.

    ``group``: the data group of a multi-process run (``parallel.mesh``); the
    loaders then yield this rank's slice of every global batch.  It must hold
    every rank and its size must divide ``batch_size`` (and the slice
    ``accumulate_grad_batches``): a rank outside it, or with nothing to do,
    would sit idle, so this raises where the JAX package shrinks its mesh.
    Metrics, checkpoints and the sampling evaluator run on rank 0 only.
    ``num_workers`` > 0 assembles the next training batches in a background
    thread, ``max(2, num_workers)`` ahead (``PrefetchLoader``).
    """

    def __init__(self, module, cfg, train_loader, val_loader, logger=None,
                 evaluator=None, group=None):
        self.module = module
        self.cfg = cfg
        self.device = resolve_device(str(module.device))
        self.is_main_process = not dist.is_initialized() or dist.get_rank() == 0
        n_prefetch = int(cfg.get("num_workers", 0) or 0)
        if n_prefetch > 0 and train_loader is not None:
            train_loader = PrefetchLoader(train_loader, depth=max(2, n_prefetch))
            if self.is_main_process:
                print(f"prefetching {train_loader.depth} training batches ahead")
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger
        # a train.evaluation.SamplingEvaluator, run on the eval schedules
        self.evaluator = evaluator
        self.group = group
        n_ranks = group_rank_size(group)[1]
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n_ranks != world:
            raise ValueError(f"the data group holds {n_ranks} of {world} ranks; "
                             f"one process per card cannot leave a rank idle: "
                             f"set tpu.mesh_data to {world} (or -1)")
        k_acc = int(cfg.get("accumulate_grad_batches", 1))
        if cfg.batch_size % n_ranks != 0:
            raise ValueError(f"batch_size={cfg.batch_size} is not divisible by the "
                             f"{n_ranks} ranks of the data group")
        if n_ranks > 1 and (cfg.batch_size // n_ranks) % k_acc != 0:
            raise ValueError(
                f"batch_size={cfg.batch_size} over {n_ranks} devices gives per-shard "
                f"batch {cfg.batch_size // n_ranks}, not divisible by "
                f"accumulate_grad_batches={k_acc}; adjust batch_size or tpu.mesh_data")
        self.best_val = float("inf")
        self.log_every_n_steps = int(cfg.get("log_every_n_steps", 1))
        self.ckpt_dir = Path(cfg.logdir) / cfg.run_name / "checkpoints"
        if self.is_main_process:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.eval_step = make_eval_step(module, group)

    def log(self, metrics: Dict, split: str, step: int):
        if not self.is_main_process:
            return
        named = {f"{k}/{split}": float(v) for k, v in metrics.items()}
        if self.logger is not None:
            self.logger.log(named, step=step)

    def fit(self, state: TrainState, generator: torch.Generator, n_epochs: int,
            eval_every: int = 1) -> TrainState:
        from diffsbdd_tpu_torch.checkpoint import save_model

        train_step = make_train_step(
            state, self.cfg.clip_grad,
            accumulate_grad_batches=self.cfg.get("accumulate_grad_batches", 1),
            group=self.group)
        for epoch in range(n_epochs):
            t0 = time.time()
            train_info = None
            for batch in self.train_loader:
                train_info = train_step(
                    generator, batch_to_device(batch["ligand"], self.device),
                    batch_to_device(batch["pocket"], self.device))
                if state.step % self.log_every_n_steps == 0:
                    self.log(train_info, "train", state.step)

            if (epoch + 1) % eval_every == 0 and self.val_loader is not None:
                val_losses = []
                for batch in self.val_loader:
                    info = self.eval_step(
                        generator, batch_to_device(batch["ligand"], self.device),
                        batch_to_device(batch["pocket"], self.device))
                    val_losses.append(float(info["loss"]))
                val_loss = float(np.mean(val_losses))
                self.log({"loss": val_loss}, "val", state.step)
                if self.is_main_process:
                    save_model(self.ckpt_dir, self.module, self.cfg, name="last",
                               state=state)
                if val_loss < self.best_val:
                    self.best_val = val_loss
                    if self.is_main_process:
                        save_model(self.ckpt_dir, self.module, self.cfg, name="best",
                                   state=state)

            if self.evaluator is not None and self.is_main_process:
                self._evaluate(generator, epoch, state.step)

            if not self.is_main_process:
                continue
            if train_info is not None:
                print(f"epoch {epoch}: {time.time() - t0:.1f}s "
                      f"loss={float(train_info['loss']):.4f}")
            else:
                print(f"epoch {epoch}: {time.time() - t0:.1f}s (no batches)")
        return state

    def _evaluate(self, generator, epoch: int, step: int):
        """The sampling evaluation after ``epoch``: metrics every
        ``eval_epochs`` epochs (logged under split 'val'), rendered samples
        every ``visualize_sample_epoch``, a rendered chain every
        ``visualize_chain_epoch``."""
        cfg, ep = self.cfg, self.cfg.eval_params
        if (epoch + 1) % cfg.eval_epochs == 0:
            tic = time.time()
            metrics = self.evaluator.sample_and_analyze(
                generator, ep.n_eval_samples, batch_size=ep.get("eval_batch_size"))
            self.log(metrics, "val", step)
            print(f"Evaluation took {time.time() - tic:.2f} seconds")
        if (epoch + 1) % cfg.visualize_sample_epoch == 0:
            self.evaluator.sample_and_save(generator, ep.n_visualize_samples,
                                           epoch=epoch)
        if (epoch + 1) % cfg.visualize_chain_epoch == 0:
            self.evaluator.sample_chain_and_save(generator, ep.keep_frames,
                                                 epoch=epoch)
