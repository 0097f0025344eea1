"""Single-device serving driver of the port: continuous-batching requests
through the Engine with MX-compressed row-parallel reductions simulated over
``--simulate-tp`` shards.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --slots 4 --requests 8 --prompt-len 512 --new-tokens 32 \
      --prefill-chunk 256 --cache-spec fp4_e2m1

``--token-budget 0`` selects the split chunk-then-decode scheduler,
``--prefill-chunk 0`` whole-prompt prefill, and ``--prefix-cache 1`` prefix
caching (the prompts then share their first half, so there is something to
share; the report prints the prompt tokens skipped). The banner names the
step mode. ``--deadline-ms`` / ``--ttft-deadline-ms`` set per-request
deadlines, ``--max-queue`` bounds admission, and ``--fault-plan`` (e.g.
``'exhaust@2x2;die@5'``, grammar in ``serving/faults.py``) injects faults
and wraps the run in an ``EngineSupervisor``; the report counts outcomes
and recoveries. ``--variant two_phase`` re-quantizes each compressed
reduction's result once more, as the reference's simulated path does (on
``--tp`` ranks: the reduce-scatter + all-gather form); ``--overlap-chunks``
chunks each compressed reduction's gathers on ``--tp`` ranks (the same bytes
either way) and is ignored under ``--simulate-tp``, which has no rank
collective to chunk (the banner says so). ``--arch`` takes every ported family
(llama2, internlm2, qwen2-7b, qwen3-32b, gemma3-4b, the MoE families
mixtral-8x22b and llama4-maverick-400b-a17b, whose banner adds experts,
top-k, shared experts, capacity factor and the layers served, and the Mamba +
MoE hybrid jamba-v0.1-52b, whose banner adds its Mamba layers and recurrent
state, and xlstm-125m, whose banner adds its mLSTM and sLSTM layers and
recurrent state). jamba and xlstm serve split and whole-prompt only: each
prompt prefills at its exact length (a recurrent layer would fold pads into
its state), so ``--prefill-chunk``, ``--token-budget`` and
``--prefix-cache`` are refused for them; ``--reduced`` keeps one layer of
each kind of its schedule (jamba: Mamba, Mamba + MoE, attention; xlstm:
mLSTM, sLSTM). xlstm-125m has no attention layer, so no paged pools (the
banner's pool MB is 0; the block allocator still runs, as the reference's
does). pixtral-12b (a vision prefix: 256 patch
embeddings ahead of each prompt) and whisper-medium (an encoder-decoder over
1500 encoder frames) serve whole-prompt too; their extra inputs are random
stand-ins drawn from ``--seed`` (``models/frontends.py``; nothing is
downloaded), and the banner says so. ``--layers N`` serves the schedule's first N
layers at full width (a model whose weights do not fit one card:
mixtral-8x22b fits about 15 of its 56 layers on an 80 GB H100,
llama4-maverick 5 of 48, jamba 24 of 32). Runs on the GPU by
default; ``--device cpu`` runs the plain PyTorch path on the CPU (use
``--reduced`` there). Weights are random, drawn from ``--seed``.

``--shard-pools N`` sequence-shards the paged pools over N kv ranks: N
processes (``torch.multiprocessing``, gloo over a ``file://`` rendezvous in
a temporary directory), each running the whole model on the same requests
and holding ``1/N`` of every pool; rank r uses ``cuda:(r % device_count)``,
so ranks share a card when there are fewer cards than ranks. The kernels
are built once, before the ranks start; the ranks only load them. Rank 0
prints the banner (``kv_shards=``, MB per rank) and the report, and the
tokens of every rank must be identical.

``--tp N`` runs tensor parallelism over N ranks instead of simulating it:
N processes, each holding ``1/N`` of the heads, the MLP columns and the
pools, every row-parallel reduction the paper's compressed collective
between them. The group is NCCL when there are at least N cards (rank r on
``cuda:r``), else gloo with every exchange staged through host memory
(``launch/mesh.py``); the banner names the transport, and the report the
collectives per step. As with ``--shard-pools``, rank 0 prints and every
rank must sample the same tokens. pixtral-12b and whisper-medium run on ``--tp`` ranks too: an
encoder layer and each cross-attention hold the rank's heads (their ``wo``
and ``down`` reductions compressed between the ranks) and a vision model's
``mm_proj`` its output columns, made whole by one dense all-gather a
prefill; every rank draws the same extra inputs from ``--seed``, and the
report adds the dense all-gathers and their bytes.

``--dp D`` with ``--tp M`` serves on a ``data x model`` grid of ``D x M``
ranks (the reference's ``make_host_mesh(data=D, model=M)``; rank ``d * M +
m``): each row is a TP group, each column a data group. Every rank runs the
engine on the same requests with its TP shard of the weights and of the
pools (replicated over the data ranks); a MoE model's data rank holds ``E /
D`` experts when D divides E, and a MoE call of more than 64 tokens in D
groups of whole batch rows runs the expert-parallel island, its ``down``
reductions reduced as the split decode's context says (the engine's
default: uncompressed). In the engine that is the split scheduler's decode
with ``--slots`` above 64 and divisible by D, so give ``--token-budget
0``. The report adds the island's entries and the bytes of its reductions,
all-to-alls and data all-gathers per step. ``--dp`` does not
combine with ``--simulate-tp``.

``--shard-pools K`` with ``--tp M`` (and ``--dp D``) serves on the
reference's ``kv x data x model`` mesh of ``K x D x M`` ranks (its
``make_kv_mesh``; rank ``k*D*M + d*M + m``, ``launch/mesh.py``): each rank
holds ``1/K`` of the blocks of the pools of its kv heads, every pool
plane's exchange runs over the kv group of its (data, model) position, the
compressed reductions over its row and the MoE island over its data group.
The banner names the three extents; the report adds the exchange's
all-reduces and MB per step, and prints the pool bytes a rank holds (summed
over its tensors) beside the reference's ``paged_cache_bytes(per_device=
True)`` on the whole config, which divides by the kv shards only and so
reads M times the bytes a rank holds (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.kernels.build import load_kernels
from repro_torch.core.collectives import (
    exchange_counts, reset_exchange_counts, reset_tp_counts, tp_counts,
)
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.configs import first_layers, get_config, reduced_config
from repro_torch.core.formats import MXSpec
from repro_torch.core.policy import CompressionPolicy, NO_COMPRESSION
from repro_torch.core.tp import TPContext
from repro_torch.device import resolve_device
from repro_torch.models.frontends import frontend_stubs
from repro_torch.models.model import Model, torch_dtype
from repro_torch.serving import (
    Engine, EngineSupervisor, FaultPlan, Request, paged_cache_bytes,
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the schedule's first N layers at full width (0: all)")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default: one per slot)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--policy", default="mx", choices=["mx", "none"])
    ap.add_argument("--variant", default="gather", choices=["gather", "two_phase"])
    ap.add_argument("--overlap-chunks", type=int, default=1,
                    help="feature-dim chunks of each compressed reduction's all-gathers on "
                         "--tp ranks (bit-identical results either way); ignored under "
                         "--simulate-tp, which has no rank collective (the banner says so)")
    ap.add_argument("--simulate-tp", type=int, default=None,
                    help="row-parallel reductions split into this many MX-compressed "
                         "partial sums on the one device (TPContext.simulate_tp; default "
                         "4 without --tp)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism over this many ranks (processes; NCCL with "
                         "a card per rank, else gloo staged through host memory)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks: with --tp M, a data x model grid of dp x M "
                         "ranks (the MoE expert-parallel island across the data ranks)")
    ap.add_argument("--min-prefill-fraction", type=float, default=0.5,
                    help="per-step compression gate: a step runs compressed only "
                         "when at least this fraction of its real tokens are prefill")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--cache-spec", default="bf16",
                    help="KV pool storage: 'bf16' (dense) or an MX scheme "
                         "('fp4_e2m1', 'fp5_e2m2_b16_e8m0', ...)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per PREFILLING slot per step "
                         "(default 2*block_size; 0 = whole-prompt prefill)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="flattened tokens per mixed step (default prefill_chunk + "
                         "slots; 0 = the split chunk-then-decode scheduler)")
    ap.add_argument("--prefix-cache", type=int, default=0, choices=[0, 1],
                    help="share KV blocks of a common prompt prefix across requests")
    ap.add_argument("--stagger", type=float, default=0.0,
                    help="inter-arrival gap in seconds (simulated traffic)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request total-latency deadline in ms (0 = none): a request "
                         "still running past it leaves timed_out with its partial output")
    ap.add_argument("--ttft-deadline-ms", type=float, default=0.0,
                    help="per-request TTFT deadline in ms (0 = none)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: arrived requests never admitted beyond this "
                         "many leave rejected")
    ap.add_argument("--fault-plan", default="",
                    help="fault schedule, e.g. 'exhaust@6x4;corrupt@9;die@12' "
                         "(serving/faults.py); the run is supervised: recoverable faults "
                         "restart the engine and replay unfinished requests")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the random weights, the synthetic prompts and the "
                         "fault plan")
    ap.add_argument("--shard-pools", type=int, default=1,
                    help="sequence-shard the paged pools over this many kv ranks "
                         "(processes over gloo; 1 = replicated pools)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    """Serve once; returns (engine, requests), or with ``--shard-pools N >
    1`` (None, the tokens of each rank's requests, by rank)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if (args.tp > 1 or args.dp > 1) and args.simulate_tp:
        raise ValueError("--tp and --dp run tensor parallelism across ranks; --simulate-tp "
                         "simulates it on one device: give one of them")
    ranks = args.tp * args.dp * args.shard_pools
    # a Grid for the data x model and kv x data x model meshes; one group else
    grid = args.dp > 1 or (args.shard_pools > 1 and args.tp > 1)
    kind = "grid" if grid else ("tp" if args.tp > 1 else "kv")
    if ranks > 1:
        if args.stagger or args.deadline_ms or args.ttft_deadline_ms:
            raise ValueError("--shard-pools, --tp and --dp run every rank's scheduler in "
                             "lockstep: --stagger and deadlines read each rank's own clock")
        if device.type == "cuda":
            load_kernels()   # one build, before the ranks load it
        # on the CPU the ranks share its cores: no rank takes them all
        threads = 0 if device.type == "cuda" else max(1, (os.cpu_count() or 2) // ranks)
        outs = spawn_ranks(_serve_rank, ranks, args, device=device.type, threads=threads,
                           tp=args.tp if grid else 0,
                           kv=args.shard_pools if grid else 0)
        if any(o != outs[0] for o in outs[1:]):
            raise RuntimeError(f"{kind} ranks sampled different tokens")
        print(f"{kind} ranks: all {ranks} sampled identical tokens")
        return None, outs
    return _serve(args, device)


def _serve_rank(group, rank: int, device: torch.device, args) -> list:
    """One rank of ``--shard-pools``, ``--tp`` or a grid: load the kernels
    the parent built, serve, return the requests' tokens."""
    if device.type == "cuda":
        load_kernels(build=False)
    if args.dp > 1 or (args.shard_pools > 1 and args.tp > 1):
        # a Grid: this rank's row, column and kv group
        _, out = _serve(args, device, tp_group=group.tp_group, dp_group=group.dp_group,
                        kv_group=group.kv_group)
    elif args.tp > 1:
        _, out = _serve(args, device, tp_group=group)
    else:
        _, out = _serve(args, device, kv_group=group)
    return [r.output.tolist() for r in out]


def _serve(args, device: torch.device, kv_group=None, tp_group=None, dp_group=None):
    """The serving run of ``main`` on ``device`` (on one rank of ``kv_group``,
    ``tp_group`` or a grid's ``tp_group``, ``dp_group`` and ``kv_group``
    when given: only rank 0 prints)."""
    full = get_config(args.arch)
    # reduced: at least one layer of each kind the schedule has (jamba: 3)
    kinds = len({(sp.kind, sp.moe, sp.window is not None) for sp in full.layers})
    cfg = first_layers(reduced_config(full, n_layers=max(2, kinds)) if args.reduced else full,
                       args.layers)
    model = Model(cfg)
    policy = NO_COMPRESSION if args.policy == "none" else CompressionPolicy(
        spec=MXSpec.make("fp4_e2m1", 32, "e8m0"), variant=args.variant,
        min_prefill_fraction=args.min_prefill_fraction,
        overlap_chunks=args.overlap_chunks)
    ranked = tp_group is not None or dp_group is not None
    simulate = 0 if ranked else (4 if args.simulate_tp is None else args.simulate_tp)
    ctx = TPContext(policy=policy, simulate_tp=simulate, kv_group=kv_group, tp_group=tp_group,
                    dp_group=dp_group)
    print_ = (print if ctx.kv_rank == 0 and ctx.tp_rank == 0 and ctx.dp_rank == 0
              else (lambda *a, **k: None))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    variant = policy.variant if policy.enabled else "none"
    if ranked:
        tp = (f"tp={ctx.tp_size}" + (f" dp={ctx.dp_size}" if dp_group is not None else "")
              + (f" kv={ctx.kv_shards}" if kv_group is not None else "")
              + f" transport={ctx.transport}")
        if ctx.transport == "gloo-staged" and device.type == "cuda":
            tp += " (ranks share a card: exchanges staged through host memory, eager steps)"
        ignored = f" overlap_chunks={args.overlap_chunks}" if args.overlap_chunks != 1 else ""
    else:
        tp = f"simulate_tp={simulate}"
        ignored = (f" overlap_chunks={args.overlap_chunks} (ignored: no effect under "
                   f"simulate_tp)" if args.overlap_chunks != 1 else "")
    print_(f"device={name} arch={cfg.name} policy={policy.describe()} variant={variant} "
           f"{tp}{ignored}")
    n_moe = sum(spec.moe for spec in cfg.layers)
    if n_moe:
        print_(f"moe: experts={cfg.n_experts} top_k={cfg.top_k} "
               f"shared={cfg.n_shared_experts} capacity_factor={cfg.capacity_factor}; "
               f"{n_moe} MoE of {cfg.n_layers} layers served (of {full.n_layers} in the "
               f"config); routed experts reduced "
               + (f"in the expert-parallel island over {ctx.dp_size} data ranks "
                  f"({cfg.tp_shard(1, ctx.dp_size).local_experts} experts a data rank) on "
                  f"calls of more than 64 tokens in {ctx.dp_size} groups, else by dense "
                  f"all-reduces"
                  if dp_group is not None else
                  "by one all-reduce per MoE layer" if tp_group is not None
                  else "unsplit (simulate_tp splits only the row-parallel layers)"))
    n_mamba = sum(spec.kind == "mamba" for spec in cfg.layers)
    if n_mamba:
        print_(f"mamba: {n_mamba} Mamba of {cfg.n_layers} layers served, d_inner="
               f"{cfg.ssm_d_inner} d_state={cfg.ssm_d_state} dt_rank={cfg.dt_rank} "
               f"d_conv={cfg.ssm_d_conv}; out_proj reduced by the policy, x_proj "
               + ("by one all-reduce per Mamba layer" if tp_group is not None
                  else "unsplit (simulate_tp splits only the row-parallel layers)"))

    n_xlstm = {k: sum(spec.kind == k for spec in cfg.layers) for k in ("mlstm", "slstm")}
    if any(n_xlstm.values()):
        rank = cfg.tp_shard(ctx.tp_size)
        print_(f"xlstm: {n_xlstm['mlstm']} mLSTM + {n_xlstm['slstm']} sLSTM of {cfg.n_layers} "
               f"layers served, mLSTM d_inner={rank.mlstm_d_inner} heads={rank.mlstm_heads}, "
               f"sLSTM heads={cfg.n_heads} FF={rank.slstm_ff} (per rank); down and ff_down "
               f"reduced by the policy, the mLSTM q/k/v/i/f projection "
               + ("by one fp32 all-reduce per mLSTM layer" if tp_group is not None
                  else "unsplit (simulate_tp splits only the row-parallel layers)")
               + "; no attention layer, no paged pools")

    n_prefix = cfg.n_patches if cfg.frontend == "vision" else 0
    if cfg.frontend == "vision":
        print_(f"vision prefix: {n_prefix} patch embeddings (random stand-ins from --seed) "
               f"through mm_proj ahead of each prompt; whole-prompt prefill")
    if cfg.encoder_decoder:
        print_(f"encoder: {cfg.n_encoder_layers} layers over {cfg.encoder_seq} frames (random "
               f"stand-ins from --seed) in each prefill; {cfg.n_layers} cross-attention "
               f"sublayers, their wo reduced by the policy; whole-prompt prefill")

    params = model.init_params(device=device, seed=args.seed, tp=(ctx.tp_rank, ctx.tp_size),
                               dp=(ctx.dp_rank, ctx.dp_size))
    fault_plan = FaultPlan.parse(args.fault_plan, seed=args.seed)
    engine = Engine(model, params, ctx, max_slots=args.slots,
                    max_len=n_prefix + args.prompt_len + args.new_tokens,
                    block_size=args.block_size, cache_spec=args.cache_spec,
                    prefill_chunk=args.prefill_chunk, token_budget=args.token_budget,
                    prefix_cache=bool(args.prefix_cache), max_queue=args.max_queue,
                    deadline_s=args.deadline_ms / 1e3 or None,
                    deadline_ttft_s=args.ttft_deadline_ms / 1e3 or None,
                    fault_plan=fault_plan if len(fault_plan) else None, device=device)
    if len(fault_plan):
        print_(f"fault plan: {fault_plan.describe()}")
    step = (f"mixed, {engine.token_budget}-token budget ({engine.prefill_chunk} "
            f"tokens/chunk)" if engine.token_budget
            else (f"split, chunked {engine.prefill_chunk} tokens/step"
                  if engine.prefill_chunk else "split, whole-prompt"))
    recurrent = n_mamba or any(n_xlstm.values())
    if recurrent:
        step += (" (recurrent layers: each prompt prefills at its exact length, since pads "
                 "would fold into the recurrent state; no chunked or mixed step)")
    rec = (f", recurrent state {engine.rec_state_bytes() / 1e6:.2f} MB fp32 per rank"
           if recurrent else "")
    held = (f", {engine.pool_bytes_held() / 1e6:.2f} MB held" if engine.kv_shards > 1 else "")
    if engine.kv_shards > 1 and engine.tp_size > 1:
        # the reference's MB/device on this mesh: the whole config's pools over
        # the kv shards alone (its pools are split over model too)
        ref = paged_cache_bytes(cfg, engine.n_blocks, engine.block_size,
                                dtype_bytes=engine.cache_dtype.itemsize,
                                cache_spec=engine.cache_spec, kv_shards=engine.kv_shards,
                                per_device=True)
        held += f"; the reference's paged_cache_bytes(per_device=True) {ref / 1e6:.2f} MB"
    print_(f"kv cache: {engine.cache_spec.describe()} "
           f"({engine.kv_pool_bytes() / 1e6:.2f} MB pools, kv_shards={engine.kv_shards}, "
           f"tp={engine.tp_size}, "
           f"{engine.kv_pool_bytes(per_device=True) / 1e6:.2f} MB per rank{held}{rec}); "
           f"step: {step}; prefix cache: {'on' if engine.prefix_cache else 'off'}")

    n_req = args.requests or args.slots
    rng = np.random.default_rng(args.seed)
    # with the prefix cache on, every prompt opens with the same half
    shared = rng.integers(0, cfg.vocab_size, args.prompt_len // 2 if args.prefix_cache
                          else 0).astype(np.int32)
    reqs = [Request(prompt=np.concatenate([shared, rng.integers(
                        0, cfg.vocab_size, args.prompt_len - len(shared)).astype(np.int32)]),
                    max_new_tokens=args.new_tokens, temperature=args.temperature,
                    arrival_s=i * args.stagger)
            for i in range(n_req)]
    extra = frontend_stubs(cfg, n_req, args.seed, dtype=torch_dtype(cfg.dtype)) or None
    # warm-up run, so the report measures serving rather than first-launch
    # set-up, with the fault plan disarmed so that it fires in the measured run
    plan, engine.fault_plan = engine.fault_plan, None
    engine.run([Request(prompt=reqs[0].prompt.copy(), max_new_tokens=2)],
               extra_inputs=extra and {k: v[:1] for k, v in extra.items()})
    engine.fault_plan = plan
    sup = EngineSupervisor(engine) if len(fault_plan) else None
    reset_tp_counts()
    reset_exchange_counts()
    t0 = time.time()
    out = (sup or engine).run(reqs, seed=args.seed, extra_inputs=extra)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    s = (sup or engine).stats.summary()
    print_(f"{s['n_requests']} requests, {s['n_generated']} tokens in {wall:.2f}s wall; "
           f"steady tokens/s={s['tokens_per_s']:.1f}")
    print_(f"dispatch: {s['n_steps']} steps, {s['n_dispatches']} program dispatches, "
           f"{s['tokens_per_step_mean']:.1f} tokens/step ({s['prefill_tokens']} prefill "
           f"+ {s['decode_tokens']} decode)")
    if "compressed" in engine.gate_variants():
        print_(f"compression gate: {s['n_compressed_steps']} compressed / "
               f"{s['n_steps'] - s['n_compressed_steps']} dense steps")
    if engine.prefix_cache:
        print_(f"prefix cache: {s['prefill_tokens_skipped']} prompt tokens skipped "
               f"(hit rate {s['prefix_hit_rate']:.2f})")
    print_(f"preemptions: {s['n_preemptions']}")
    if ranked:
        c, n = tp_counts(), max(s["n_steps"], 1)
        dense = (f", {c['dense_all_gather']} dense all-gathers of the vision prefix "
                 f"({c['dense_all_gather_bytes'] / 1e6:.3f} MB)"
                 if cfg.frontend == "vision" else "")
        print_(f"collectives ({ctx.transport}): {c['all_gather']} all-gathers, "
               f"{c['all_to_all']} all-to-alls, {c['all_reduce']} all-reduces{dense}; per "
               f"step {c['bytes'] / n / 1e6:.3f} MB sent by rank 0, "
               f"{c['seconds'] / n * 1e3:.2f} ms host")
        if dp_group is not None:
            print_(f"island: {c['island']} entries ({c['island'] / n:.2f} per step); per step "
                   f"{c['island_down_bytes'] / n / 1e6:.3f} MB of down reductions, "
                   f"{c['compressed_all_to_all_bytes'] / n / 1e6:.3f} MB in "
                   f"{c['compressed_all_to_all']} compressed and "
                   f"{c['dense_all_to_all_bytes'] / n / 1e6:.3f} MB in "
                   f"{c['dense_all_to_all']} dense all-to-alls, "
                   f"{c['dp_all_gather_bytes'] / n / 1e6:.3f} MB in {c['dp_all_gather']} "
                   f"data all-gathers, sent by rank 0")
    if ctx.kv_sharded:
        e, n = exchange_counts(), max(s["n_steps"], 1)
        print_(f"kv exchange ({ctx.transport}): {e['all_reduce']} all-reduces "
               f"over {ctx.kv_shards} kv ranks; per step {e['bytes'] / n / 1e6:.3f} MB from "
               f"rank 0, {e['seconds'] / n * 1e3:.2f} ms host")
    print_(f"programs: decode={engine.decode_cache_size()} prefill={engine.prefill_cache_size()} "
           f"({'graphed' if engine.graphed else 'eager'} steps)")
    print_(f"TTFT p50 {s['ttft_p50_s']*1e3:.1f} ms, p90 {s['ttft_p90_s']*1e3:.1f} ms; "
           f"TPOT p50 {s['tpot_p50_s']*1e3:.2f} ms, p95 {s['tpot_p95_s']*1e3:.2f} ms; "
           f"latency p50 {s['latency_p50_s']*1e3:.1f} ms")
    print_(f"outcomes: {s['n_ok']} ok, {s['n_rejected']} rejected, {s['n_timed_out']} timed "
           f"out, {s['n_cancelled']} cancelled; goodput={s['goodput_tokens_per_s']:.1f} tok/s")
    if sup is not None:
        r = sup.report()
        print_(f"recoveries: {r['n_recoveries']} ({r['n_hard']} hard, {r['n_warm']} warm) "
               f"recovery {r['recovery_s_total'] * 1e3:.1f} ms + backoff "
               f"{r['backoff_s_total'] * 1e3:.1f} ms; errors={r['errors']}")
    print_("first request tokens:", out[0].output.tolist())
    return engine, out


if __name__ == "__main__":
    main()
