"""Where the time of a serving run goes on the card: the llama2-7b serve of
``chip_smoke.py`` (or another ported family, ``--arch``, e.g. qwen2-7b,
mixtral-8x22b, jamba-v0.1-52b, pixtral-12b, whisper-medium or xlstm-125m; ``--layers
N`` serves the schedule's first N layers at full width, for a model whose
weights do not fit one card)
under ``torch.profiler``, device kernel time
summed by layer of the stack (paged attention, MX codec, MoE dispatch,
GEMMs, the rest), against the run's wall time (the rest is the device's idle
share: host-side dispatch and scheduling). The profiler slows the host, so
the same run is also timed without it, and the idle share is given against
both walls.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --cache-spec fp4_e2m1
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch mixtral-8x22b \
      --layers 15 --cache-spec fp4_e2m1
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch jamba-v0.1-52b \
      --layers 21 --cache-spec fp4_e2m1,bf16

The ``moe_dispatch`` row holds a MoE layer's routing and dispatch kernels
(``models/moe.py``): the router's softmax, the top-k and expert-id sorts,
``searchsorted``, the gathers of the sorted slots and routed rows
(``index_select``), the scatter into the expert buffer (``index_copy_``) and
the combine (``index_add_``); the expert products stay under GEMM and the
small elementwise kernels between them (positions, destinations, gate
products) under the rest. No other kernel of a mixed step has those names;
a split chunk or whole-prompt prefill adds one one-row ``index_select``
(its logits row), and whole-prompt attention its own softmax. A Mamba
layer's convolution, selective scan and gates (``models/ssm.py``: plain
PyTorch elementwise ops, concatenations and the scan's ``einsum``, which
lands under GEMM) fall in the rest ("other"). An xLSTM layer's products
(the projections, the mLSTM chunk's einsums over (L, L) scores and its
(dh, dh) carry, the sLSTM's per-token batched recurrent product) land
under GEMM; its scans' elementwise gating, cumulative sums, exponentials
and the group norms under the rest.

``--cache-spec`` takes a comma-separated list, e.g. ``fp4_e2m1,bf16,bf16,fp4_e2m1``:
the cells then run in that order in one process on the same weights, so
their numbers compare within one call. A cell runs the mixed token-budget
scheduler (budget 260, chunk 256) on graphed steps (the engine's CUDA
graphs, captured in the warm-up run); ``:split`` after the spec runs the
split chunk-then-decode scheduler (``token_budget=0``, chunk 256) instead,
and ``:eager`` runs eager steps (``cuda_graphs=False``), e.g.
``fp4_e2m1,fp4_e2m1:eager,fp4_e2m1:eager,fp4_e2m1`` holds the two in turns.
A stack with recurrent layers (jamba, xlstm-125m), a vision model (pixtral-12b) and an
encoder-decoder (whisper-medium) run whole-prompt prefill and the split
decode, their only scheduler (``prefill_chunk=0``), in every cell; the
latter two on random stand-in patch embeddings or encoder frames drawn from
``--seed`` (``models/frontends.py``), ``--prompt-len`` counting text tokens.
The encoder's attention and the cross-attention (plain PyTorch einsums and
softmax) land under GEMM and the rest.
Writes the tables to ``--out`` as a JSON list as well. Needs a GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.configs import first_layers, get_config
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.core.tp import TPContext
from repro_torch.models.frontends import frontend_stubs
from repro_torch.models.model import Model, recurrent_layer, torch_dtype
from repro_torch.serving import Engine, Request

CATEGORIES = (  # (category, substrings of the device kernel's name)
    ("paged_attention", ("paged_attention_kernel",)),
    ("mx_codec", ("mx_quant_kernel", "mx_dequant_kernel", "mx_dequant_reduce_kernel")),
    ("moe_dispatch", ("sort", "softmax", "searchsorted", "index_copy", "indexfunc",
                      "indexselect")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the schedule's first N layers (0: all)")
    ap.add_argument("--cache-spec", default="fp4_e2m1")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/profile_serve.json")
    args = ap.parse_args(argv)

    cfg = first_layers(get_config(args.arch), args.layers)
    model = Model(cfg)
    params = model.init_params(device="cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    args.extra = frontend_stubs(cfg, args.requests, args.seed, torch_dtype(cfg.dtype)) or None
    results = [profile_cell(model, params, spec, prompts, args)
               for spec in args.cache_spec.split(",")]
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))


def profile_cell(model, params, cell, prompts, args):
    """One cell: an unprofiled run, then the same traffic under the profiler."""
    cfg = model.cfg
    cache_spec, *options = cell.split(":")
    if not set(options) <= {"mixed", "split", "eager"}:
        raise ValueError(f"cell {cell!r}: options are 'split' (else mixed) and 'eager'")
    whole = recurrent_layer(cfg) is not None or cfg.frontend is not None
    scheduler = "whole" if whole else "split" if "split" in options else "mixed"
    steps = "eager" if "eager" in options else "graphed"
    n_prefix = cfg.n_patches if cfg.frontend == "vision" else 0
    extra = args.extra
    engine = Engine(model, params, TPContext(policy=PAPER_DEFAULT, simulate_tp=4),
                    max_slots=4, max_len=n_prefix + args.prompt_len + args.new_tokens,
                    block_size=16,
                    prefill_chunk=0 if scheduler == "whole" else 256,
                    token_budget=260 if scheduler == "mixed" else 0,
                    cache_spec=cache_spec, cuda_graphs=steps == "graphed")
    engine.run([Request(prompt=prompts[0].copy(), max_new_tokens=2)],   # warm-up
               extra_inputs=extra and {k: v[:1] for k, v in extra.items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run([Request(prompt=p.copy(), max_new_tokens=args.new_tokens) for p in prompts],
               seed=args.seed, extra_inputs=extra)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    plain = engine.stats.summary()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.run([Request(prompt=p.copy(), max_new_tokens=args.new_tokens) for p in prompts],
                   seed=args.seed, extra_inputs=extra)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat, by_kernel = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_cat[category(e.name)] += us / 1e3
            by_kernel[e.name] += us / 1e3
    busy = sum(by_cat.values())
    n_steps = engine.stats.n_steps
    dispatches = engine.stats.n_dispatches
    name = torch.cuda.get_device_name(0)
    print(f"{name}; {cfg.name} ({cfg.n_layers} layers), {cache_spec} pools, {scheduler} "
          f"scheduler, {steps} steps, "
          f"{n_steps} steps, {dispatches} dispatches ({engine.gate_counts}), wall "
          f"{wall_ms:.1f} ms under the profiler, {plain_wall_ms:.1f} ms without it; TPOT p50 "
          f"{plain['tpot_p50_s'] * 1e3:.2f} ms, {plain['tokens_per_s']:.1f} tokens/s without "
          f"it")
    for cat in ("paged_attention", "mx_codec", "moe_dispatch", "gemm", "other"):
        print(f"  {cat:16s} {by_cat[cat]:9.1f} ms  {by_cat[cat] / wall_ms:6.1%} of wall  "
              f"{by_cat[cat] / max(n_steps, 1):7.2f} ms/step")
    print(f"  device busy {busy:.1f} ms = {busy / wall_ms:.1%} of wall; idle share "
          f"{1 - busy / wall_ms:.1%} under the profiler, {1 - busy / plain_wall_ms:.1%} "
          f"against the wall without it")
    top = by_kernel.most_common(8)
    for k, ms in top:
        print(f"    {ms:9.1f} ms  {k[:100]}")
    return {"device": name, "arch": cfg.name, "n_layers": cfg.n_layers,
            "cache_spec": cache_spec, "scheduler": scheduler,
            "step_programs": steps, "capture_s": engine.capture_seconds(),
            "tpot_p50_ms": plain["tpot_p50_s"] * 1e3, "tokens_per_s": plain["tokens_per_s"],
            "steps": n_steps, "dispatches": dispatches,
            "gate_counts": engine.gate_counts, "wall_ms": wall_ms,
            "plain_wall_ms": plain_wall_ms, "device_ms_by_category": dict(by_cat),
            "top_kernels_ms": dict(top)}


if __name__ == "__main__":
    main()
