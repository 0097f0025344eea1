"""End-to-end training driver of the port (the reference's
``launch/train.py``): AdamW steps of ``Model.loss`` on the byte-level corpus.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --reduced --steps 20 --batch 8 --seq 128 --device cpu

The reference's flags (``--arch --reduced --steps --batch --seq --lr
--policy --value-dtype --block-size --scale-dtype --variant --checkpoint
--log-every``) with its defaults, and the vocabulary set to the byte
tokenizer's 258. On one device the policy has nothing to compress (the
reference's single-device context has no mesh and no ``simulate_tp``), so
training there is uncompressed. Runs on the card unless ``--device cpu``;
``--layers N`` trains the schedule's first N layers at full width.

``--tp M`` trains on M TP ranks (processes; NCCL with a card per rank,
else gloo staged through host memory, ``launch/mesh.py``), each holding its
shard of the weights and of the moments, every row-parallel reduction the
policy's compressed collective with the straight-through backward. ``--dp
D`` adds data ranks (a ``data x model`` grid of ``D x M``): each takes its
rows of the global batch, and the gradients are averaged with one
all-reduce a step. Rank 0 prints; every rank must see the same losses. A
vision model's patch embeddings and an encoder-decoder's encoder frames are
random stand-ins drawn from seed 0 (``models/frontends.py``), fixed for
the run. Weights are random from seed 0, as the reference's
``PRNGKey(0)``. ``--checkpoint PATH`` writes the reference's checkpoint format
after the last step (the grid's first rank, whole tensors).

Refused before any rank starts (``training.check_trainable``, which
``make_train_step`` also applies): a MoE family with ``--dp`` above 1 (the
expert-parallel island's backward all-to-alls are a later slice: ROADMAP
Queue 1 item 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import first_layers, get_config, reduced_config
from repro_torch.core.formats import MXSpec
from repro_torch.core.policy import CompressionPolicy, NO_COMPRESSION
from repro_torch.core.tp import TPContext
from repro_torch.data import Batches, corpus_tokens
from repro_torch.device import resolve_device
from repro_torch.kernels.build import load_kernels
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.frontends import frontend_stubs
from repro_torch.models.model import Model, param_shapes, torch_dtype
from repro_torch.training import (
    AdamWConfig, check_trainable, init_train_state, make_train_step, save_checkpoint,
)

__all__ = ["main", "build_policy", "train_config"]

CORPUS_BYTES = 4_000_000   # the reference's corpus_tokens(4_000_000)
SEED = 0                   # the reference's PRNGKey(0) and Batches(seed=0)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="train the schedule's first N layers at full width (0: all)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", default="mx", choices=["mx", "none"])
    ap.add_argument("--value-dtype", default="fp4_e2m1")
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--scale-dtype", default="e8m0")
    ap.add_argument("--variant", default="gather", choices=["gather", "two_phase"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism over this many ranks (processes)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks: a data x model grid of dp x tp ranks")
    ap.add_argument("--device", default="cuda")
    return ap


def build_policy(args) -> CompressionPolicy:
    if args.policy == "none":
        return NO_COMPRESSION
    return CompressionPolicy(spec=MXSpec.make(args.value_dtype, args.block_size,
                                              args.scale_dtype),
                             variant=args.variant)


def train_config(args):
    """The model config ``args`` train: reduced as the reference's
    ``reduced_config`` with ``--reduced``, cut to ``--layers``, vocab 258."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    return dataclasses.replace(first_layers(cfg, args.layers), vocab_size=258)


def main(argv=None) -> List[Dict[str, float]]:
    """Train; returns the logged metrics of each logged step (rank 0's)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = train_config(args)
    check_trainable(cfg, build_policy(args), args.tp, args.dp)
    ranks = args.tp * args.dp
    if ranks > 1:
        if device.type == "cuda":
            load_kernels()   # one build, before the ranks load it
        threads = 0 if device.type == "cuda" else max(1, (os.cpu_count() or 2) // ranks)
        outs = spawn_ranks(_train_rank, ranks, args, device=device.type, threads=threads,
                           tp=args.tp)
        losses = [[m["loss"] for m in o] for o in outs]
        if any(o != losses[0] for o in losses[1:]):
            raise RuntimeError(f"ranks saw different losses: {losses}")
        print(f"ranks: all {ranks} saw identical losses")
        return outs[0]
    return _train(args, device)


def _train_rank(grid, rank: int, device: torch.device, args) -> List[Dict[str, float]]:
    if device.type == "cuda":
        load_kernels(build=False)
    return _train(args, device, tp_group=grid.tp_group, dp_group=grid.dp_group)


def _train(args, device: torch.device, tp_group=None,
           dp_group=None) -> List[Dict[str, float]]:
    cfg = train_config(args)
    model = Model(cfg)
    ctx = TPContext(policy=build_policy(args), tp_group=tp_group, dp_group=dp_group)
    first = ctx.tp_rank == 0 and ctx.dp_rank == 0
    print_ = print if first else (lambda *a, **k: None)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    where = (f"tp={ctx.tp_size} dp={ctx.dp_size} transport={ctx.transport}"
             if tp_group is not None or dp_group is not None else "one device")
    policy = (ctx.policy.describe() if tp_group is not None
              else "uncompressed (one rank: no reduction crosses ranks)")
    print_(f"device={name} {where} policy={policy}")

    state = init_train_state(model, device=device, seed=SEED,
                             tp=(ctx.tp_rank, ctx.tp_size), dp=(ctx.dp_rank, ctx.dp_size))
    n_params = sum(int(np.prod(s)) for s in _leaf_shapes(param_shapes(cfg)))
    print_(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
           f"params={n_params:,} dtype={cfg.dtype}")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 10 + 1),
                          total_steps=args.steps)
    step_fn = make_train_step(model, ctx, opt_cfg)

    toks = corpus_tokens(CORPUS_BYTES)
    batches = Batches(toks, args.batch, args.seq, seed=SEED, device=device,
                      rows=(ctx.dp_rank, ctx.dp_size))
    rows = batches.rows
    extra = {k: v[rows].to(device) for k, v in frontend_stubs(
        cfg, args.batch, SEED, dtype=torch_dtype(cfg.dtype)).items()}
    logged: List[Dict[str, float]] = []
    t0 = time.time()
    for step in range(args.steps):
        state, metrics = step_fn(state, {**batches.next(), **extra})
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            logged.append({"step": step, **m})
            print_(f"step {step:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
                   f"lr {m['lr']:.2e} ({(time.time() - t0) / (step + 1):.2f}s/step)")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state, step=args.steps, cfg=cfg,
                        ctx=ctx if tp_group is not None or dp_group is not None else None)
        print_(f"saved {args.checkpoint}")
    return logged


def _leaf_shapes(tree) -> list:
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _leaf_shapes(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _leaf_shapes(v)]
    return [tree]


if __name__ == "__main__":
    main()
