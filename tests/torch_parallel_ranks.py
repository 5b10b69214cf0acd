"""Rank functions of ``tests/test_torch_parallel.py``.

Each runs in a process of its own, spawned with ``torch.multiprocessing`` and
joined to the others by gloo over a file rendezvous (no TCP port to collide
on when pytest-xdist runs several files at once).  The module imports torch,
numpy and the port only: a spawned child imports it, and must not pay for
importing JAX.  The single-process halves of the comparisons (``build_*``,
``train_steps``) are here too, so that both sides run the same code.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from diffsbdd_tpu_torch.cli import train as train_cli
from diffsbdd_tpu_torch.config import load_config
from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
from diffsbdd_tpu_torch.parallel import mesh
from diffsbdd_tpu_torch.parallel.edge_shard import (edge_sharded_dynamics,
                                                   make_dp_edge_groups)
from diffsbdd_tpu_torch.parallel.sample_shard import (ShardedSampler,
                                                     sample_given_pocket_sharded)
from diffsbdd_tpu_torch.train import loop
from diffsbdd_tpu_torch.train.module import build_module_from_config

# every child runs on one thread: several of them share the cores with the
# other pytest workers
THREADS = 1


def run(fn, world: int, workdir, job) -> list:
    """``fn(rank, job)`` on ``world`` gloo ranks; their results in rank order."""
    workdir = Path(workdir)
    torch.save(job, workdir / "job.pt")
    mp.spawn(_child, args=(fn, world, str(workdir)), nprocs=world, join=True)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _child(rank, fn, world, workdir):
    torch.set_num_threads(THREADS)
    mesh.init_distributed(device="cpu", init_method=f"file://{workdir}/rendezvous",
                          rank=rank, world_size=world)
    try:
        job = torch.load(Path(workdir) / "job.pt", weights_only=False)
        torch.save(fn(rank, job), Path(workdir) / f"rank{rank}.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _error(call) -> str:
    """The message of the ValueError that ``call()`` raises ('' if none)."""
    try:
        call()
    except ValueError as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# the models and the recorded noise, on either side
# ---------------------------------------------------------------------------

def build_dynamics(spec):
    """An ``EGNNDynamics`` with the converted weights of ``spec``."""
    model = EGNNDynamics(**spec["kwargs"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()},
                          strict=True)
    return model


def build_module(spec):
    module = build_module_from_config(load_config(overrides=spec["config"]),
                                      spec["histogram"])
    module.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()},
                           strict=True)
    return module


def sum_sq_grads(model, out):
    """The gradients of sum(eps^2) by parameter, in ``named_parameters``
    order (zeros where the loss does not reach)."""
    loss = sum((o ** 2).sum() for o in out)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def feed_rows(module, steps, lo, hi, k_acc):
    """Queue recorded timesteps and noise -- ``steps`` is a list of (t (B, 1),
    eps (B, NL, D)) of the global batch, one per optimizer step -- as the
    port's DDPM draws them for rows [lo, hi) in ``k_acc`` micro-batches."""
    tq, nq = [], []
    bounds = np.linspace(lo, hi, k_acc + 1).astype(int)
    for t, eps in steps:
        for a, b in zip(bounds[:-1], bounds[1:]):
            tq.append(torch.as_tensor(t[a:b]))
            nq.append(torch.as_tensor(eps[a:b]))
    module.ddpm.sample_timesteps = lambda g, n, lowest: tq.pop(0)
    module.ddpm.sample_gaussian = lambda g, shape, mask: nq.pop(0) * mask[..., None]
    return tq, nq


def train_steps(spec, batches, noise, k_acc, group=None):
    """Optimizer steps of the port (lr 1e-3, clipping on) on the global
    ``batches``, this rank's rows of them with the recorded ``noise``: the
    infos, the gradients the optimizer got at the first step, the final
    parameters."""
    module = build_module(spec)
    rank, n = mesh.group_rank_size(group)
    B = batches[0]["ligand"]["x"].shape[0]
    tq, nq = feed_rows(module, noise, rank * B // n, (rank + 1) * B // n, k_acc)
    state = loop.create_train_state(module, lr=1e-3)
    seen, optimizer_step = [], state.optimizer.step
    state.optimizer.step = lambda grads: (seen.append([g.clone() for g in grads]),
                                          optimizer_step(grads))
    step = loop.make_train_step(state, clip_grad=True, accumulate_grad_batches=k_acc,
                                group=group)
    infos = []
    for batch in batches:
        local = mesh.shard_batch(batch, group)
        info = step(None, loop.batch_to_device(local["ligand"], "cpu"),
                    loop.batch_to_device(local["pocket"], "cpu"))
        infos.append({k: float(v) for k, v in info.items()})
    assert not tq and not nq
    return dict(infos=infos, grads=seen[0],
                params=[p.detach().clone() for p in module.parameters()])


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def two_ranks(rank, job):
    """Edge-sharded dynamics, sharded sampling and data-parallel training on
    two ranks, then cli.train (last: it leaves the process group)."""
    world = dist.group.WORLD
    out = {"edge": {}}
    for name, spec in job["edge"].items():
        model = build_dynamics(spec)
        eps = edge_sharded_dynamics(model, world)(*map(torch.as_tensor, spec["inputs"]))
        out["edge"][name] = dict(eps=[e.detach() for e in eps],
                                 grads=sum_sq_grads(model, eps))
    try:
        gnn = job["gnn"]
        edge_sharded_dynamics(EGNNDynamics(**gnn["kwargs"]), world)(
            *map(torch.as_tensor, gnn["inputs"]))
        out["gnn_error"] = ""
    except NotImplementedError as e:
        out["gnn_error"] = str(e)

    s = job["sampling"]
    ddpm = build_module(s["module"]).ddpm.eval()
    pocket = {k: torch.as_tensor(v) for k, v in s["pocket"].items()}
    lig_mask = torch.as_tensor(s["lig_mask"])
    kw = dict(timesteps=s["T"], shared_pocket=True)
    out["global"] = sample_given_pocket_sharded(
        ddpm, world, torch.Generator().manual_seed(s["seed"]), pocket, lig_mask, **kw)
    out["per_rank"] = ShardedSampler(ddpm, world).sample_given_pocket(
        s["seed"], pocket, lig_mask, **kw)
    odd = {k: v[:3] for k, v in pocket.items()}
    out["sampling_errors"] = [
        _error(lambda: sample_given_pocket_sharded(
            ddpm, world, torch.Generator(), odd, lig_mask[:3], **kw)),
        _error(lambda: ShardedSampler(ddpm, world).sample_given_pocket(
            0, odd, lig_mask[:3], **kw))]

    t = job["training"]
    out["dp"] = {k: train_steps(t["module"], t["batches"], t["noise"], k, world)
                 for k in (1, 2)}
    module = build_module(t["module"])
    cfg = load_config(overrides=t["config"])
    state = loop.create_train_state(module, lr=1e-3)
    local = mesh.shard_batch(t["batches"][0], world)
    out["errors"] = dict(
        data_group=_error(lambda: mesh.make_data_group(3)),
        batch=_error(lambda: loop.Trainer(
            module, load_config(overrides=dict(t["config"], batch_size=3)), None, None,
            group=world)),
        per_shard=_error(lambda: loop.Trainer(
            module, load_config(overrides=dict(t["config"], accumulate_grad_batches=4)),
            None, None, group=world)),
        no_group=_error(lambda: loop.Trainer(module, cfg, None, None)),
        step=_error(lambda: loop.make_train_step(state, accumulate_grad_batches=3,
                                                 group=world)(
            None, loop.batch_to_device(local["ligand"], "cpu"),
            loop.batch_to_device(local["pocket"], "cpu"))))

    # cli.train for one epoch through the prefetch loader, each rank with a
    # config of its own whose logdir tells who wrote what
    config = Path(job["workdir"]) / f"config{rank}.json"
    logdir = Path(job["workdir"]) / f"logs{rank}"
    config.write_text(json.dumps(dict(t["config"], logdir=str(logdir), num_workers=2)))
    train_cli.main(["--config", str(config), "--device", "cpu"])
    out["written"] = sorted(str(p.relative_to(logdir)) for p in logdir.rglob("*")
                            if p.is_file()) if logdir.exists() else []
    out["threads_left"] = [th.name for th in threading.enumerate()
                           if th.name == "diffsbdd-prefetch"]
    return out


def dp_x_edge(rank, job):
    """A 2 x 2 data-x-edge grid: the global batch in, the gathered eps out,
    the gradients summed over the data group."""
    data_group, edge_group = make_dp_edge_groups(2, 2)
    spec = job["edge"]
    model = build_dynamics(spec)
    eps = edge_sharded_dynamics(model, edge_group, batch_group=data_group)(
        *map(torch.as_tensor, spec["inputs"]))
    grads = sum_sq_grads(model, eps)
    for g in grads:
        dist.all_reduce(g, group=data_group)
    return dict(eps=[e.detach() for e in eps], grads=grads)
