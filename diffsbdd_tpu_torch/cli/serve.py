"""Persistent sampling server: load a checkpoint once, then answer many
requests at steady-state cost.

Protocol: one JSON object per line on stdin, one JSON reply per line on
stdout.  Operations:

    {"op": "ping"}
    {"op": "info"}
    {"op": "warmup", "pdbfile": ..., "ref_ligand": "A:330",
     "n_samples": 8}                      # run a request shape before traffic
    {"op": "generate", "pdbfile": ..., "ref_ligand": "A:330" |
     "resi_list": ["A:1", ...], "n_samples": 8, "outfile": "out.sdf",
     "timesteps": null, "num_nodes_lig": null, "sanitize": false,
     "all_frags": false, "relax": false, "resamplings": 10,
     "jump_length": 1, "seed": null}
    {"op": "shutdown"}

A request with a ``seed`` samples from a generator seeded with it; one
without draws from the server's own generator, which warmup never touches.
Replies echo the request's "id" field (if any) and carry either the result
or {"error": "<ExcType>: <message>"}: a malformed request never stops the
server.

    python -m diffsbdd_tpu_torch.cli.serve <ckpt_dir> [--name best] \\
        [--device cpu] [--warm-pdbfile ...]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from diffsbdd_tpu_torch.checkpoint import load_model
from diffsbdd_tpu_torch.chem.sdfio import write_sdf_file
from diffsbdd_tpu_torch.utils.device import resolve_device


class SamplingServer:
    """Checkpoint-resident request handler (transport-agnostic)."""

    def __init__(self, checkpoint, name: str = "best", seed: int = 0,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        t0 = time.time()
        self.module, self.cfg = load_model(checkpoint, name=name, device=self.device)
        self.load_s = round(time.time() - t0, 2)
        self.checkpoint = str(checkpoint)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._size_rng = np.random.default_rng(seed)
        self.requests = 0
        self.molecules = 0
        self.started = time.time()

    def _next_generator(self, seed=None) -> torch.Generator:
        if seed is not None:
            return torch.Generator(device=self.device).manual_seed(int(seed))
        return self._generator

    # ------------------------------------------------------------- handlers
    def handle(self, req: dict) -> dict:
        """Dispatch one request dict to a reply dict (never raises)."""
        rid = req.get("id")
        try:
            op = req.get("op", "generate")
            fn = getattr(self, f"_op_{op}", None)
            if fn is None:
                raise ValueError(f"unknown op '{op}'")
            out = fn(req)
        except Exception as e:  # noqa: BLE001 -- the server must stay up
            out = {"error": f"{type(e).__name__}: {e}"[:500]}
        if rid is not None:
            out["id"] = rid
        return out

    def _op_ping(self, req):
        return {"ok": True}

    def _op_info(self, req):
        return {
            "ok": True,
            "checkpoint": self.checkpoint,
            "dataset": self.cfg.dataset,
            "mode": self.cfg.mode,
            "pocket_representation": self.cfg.pocket_representation,
            "T": self.module.ddpm.T,
            "load_s": self.load_s,
            "uptime_s": round(time.time() - self.started, 1),
            "requests": self.requests,
            "molecules": self.molecules,
        }

    def _op_warmup(self, req):
        """Run a request shape once before traffic hits it: generate, with
        the molecules discarded and no output file written.  It samples from
        a generator seeded 0 (or the request's seed) and sizes from a fresh
        ``default_rng(0)``, so an unseeded generate after warmup gives the
        molecules it would give on a server never warmed."""
        req = dict(req)
        req.pop("outfile", None)
        req.setdefault("seed", 0)
        t0 = time.time()
        mols = self._generate(req, size_rng=np.random.default_rng(0))
        return {"ok": True, "compiled_s": round(time.time() - t0, 2),
                "n_molecules": len(mols)}

    def _op_generate(self, req):
        t0 = time.time()
        mols = self._generate(req)
        self.requests += 1
        self.molecules += len(mols)
        out = {"ok": True, "n_molecules": len(mols),
               "wall_s": round(time.time() - t0, 2),
               "smiles": [m.to_smiles() for m in mols],
               "n_atoms": [len(m.symbols) for m in mols]}
        outfile = req.get("outfile")
        if outfile:
            outfile = Path(outfile)
            outfile.parent.mkdir(parents=True, exist_ok=True)
            write_sdf_file(outfile, mols)
            out["outfile"] = str(outfile)
        return out

    def _generate(self, req, size_rng=None):
        pdbfile = req["pdbfile"]
        n = int(req.get("n_samples", 8))
        num_nodes = req.get("num_nodes_lig")
        if num_nodes is not None:
            num_nodes = np.full(n, int(num_nodes))
        if size_rng is None:
            size_rng = self._size_rng
        return self.module.generate_ligands(
            pdbfile, n, self._next_generator(req.get("seed")),
            pocket_ids=req.get("resi_list"),
            ref_ligand=req.get("ref_ligand"),
            num_nodes_lig=num_nodes,
            sanitize=bool(req.get("sanitize", False)),
            largest_frag=not bool(req.get("all_frags", False)),
            relax_iter=(200 if req.get("relax") else 0),
            timesteps=req.get("timesteps"),
            resamplings=int(req.get("resamplings", 10)),
            jump_length=int(req.get("jump_length", 1)),
            size_rng=size_rng)

    def _op_shutdown(self, req):
        return {"ok": True, "shutdown": True}

    # ------------------------------------------------------------- transport
    def serve_forever(self, infile=None, outfile=None):
        """JSON-lines loop; returns when the input ends or on shutdown."""
        infile = infile if infile is not None else sys.stdin
        outfile = outfile if outfile is not None else sys.stdout
        for line in infile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
            except Exception as e:  # malformed line: reply, keep serving
                print(json.dumps({"error": f"bad request: {e}"[:300]}),
                      file=outfile, flush=True)
                continue
            out = self.handle(req)
            print(json.dumps(out), file=outfile, flush=True)
            if out.get("shutdown"):
                break


def main(argv=None):
    p = argparse.ArgumentParser("diffsbdd_tpu_torch sampling server")
    p.add_argument("checkpoint", type=Path)
    p.add_argument("--name", default="best")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--warm-pdbfile", type=str, default=None,
                   help="run one request for this pocket before accepting "
                        "requests")
    p.add_argument("--warm-ref-ligand", type=str, default=None)
    p.add_argument("--warm-n-samples", type=int, default=8)
    args = p.parse_args(argv)

    server = SamplingServer(args.checkpoint, name=args.name, seed=args.seed,
                            device=args.device)
    print(json.dumps({"ready": True, "load_s": server.load_s}),
          file=sys.stderr, flush=True)
    if args.warm_pdbfile:
        rep = server.handle({"op": "warmup", "pdbfile": args.warm_pdbfile,
                             "ref_ligand": args.warm_ref_ligand,
                             "n_samples": args.warm_n_samples})
        print(json.dumps({"warmup": rep}), file=sys.stderr, flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
