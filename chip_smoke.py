#!/usr/bin/env python3
"""End-to-end smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device   — needs CUDA and compute capability 9.x; prints the card's name
              and power limit (nvidia-smi).
2. build    — compiles every hand-written kernel of the serving path from
              src/repro_torch/kernels/csrc (one parallel build).
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the shapes of the llama2-7b serving steps (T = 260 tokens = a
              256-token prefill chunk + 4 decode slots, TP 4, d_model 4096):
              codec bytes exact for all 13 element formats at block 32 and
              for fp4_e2m1 and int8 at blocks 8-256, on bf16 and fp32 inputs
              (fp32 with full mantissas too, amaxes just below powers of two
              and midpoints with their neighbours), ragged row counts and
              zero, NaN, inf and subnormal blocks;
              dequantize and dequantize+reduce exact on every such case;
              the codec also exact and timed at the split chunk's and the
              whole-prompt prefill's TP partials (4 x 256 and 4 x 512 rows),
              the split chunk's 256-row append, the 512-row whole-prompt
              insert and the 4-row decode append; dequantize and
              dequantize+reduce over a block of scale byte 255 (a poisoned
              pool block): inf and NaN where the plain version has them;
              paged attention within one bf16 rounding of each element
              over bf16 and fp4 pools in the geometries the served steps run
              (mixed, decode-only with 256 budget pads, the same pads of an
              empty slot, the split scheduler's decode, R = 4, and its chunk,
              R = 1, Sq = 256 over 256 history positions with the chunk as
              256 extras), the same geometries over a pool with one poisoned
              block (scale bytes 255 in fp4 pools, NaN in bf16 pools): the
              non-finite query rows are the plain version's and exactly those
              whose history reaches the block; the new families' served
              reads (qwen2-7b G 7, qwen3-32b G 8 at hd 128; gemma3-4b G 2 at
              hd 256 over a 1536-token history, with its 1024 window and
              without) in every one of those geometries on fp4 and bf16
              pools, the mixed and split-decode ones timed; the
              codec at the families' widths (d_model 3584, 5120, 2560;
              kv_dim 512, 1024) at their served shapes; the MoE families'
              served reads (mixtral-8x22b G 6 with its 4096 window,
              llama4-maverick G 5, both KV 8 at hd 128) in every geometry,
              mixed and split decode timed, and the codec at their
              partials (d_model 6144 and 5120); jamba-v0.1-52b's one
              paged read, the split decode (KV 8, G 4, hd 128, no
              window), timed, and the codec at its whole-prompt shapes
              (the TP partials of every row-parallel reduction, a Mamba
              layer's out_proj included, at its three exact prompt
              lengths, the insert and the decode append); pixtral-12b's and
              whisper-medium's one paged read, the split decode (KV 8, G 4,
              hd 128 over 556-796 history positions: the 256-patch prefix
              and 512 text tokens; KV 16, G 1, hd 64), timed, and the codec
              at their whole-prompt shapes (pixtral's TP partials of 768
              positions, S = 4 x (768, 5120); whisper's decoder prompt of 64
              and its encoder's partials, S = 4 x (1500, 1024)), the insert
              and the decode append; xlstm-125m's codec (its only kernels:
              no paged read) at its whole-prompt TP partials (4 T, 768) and
              S = 4 x (T, 768) at T = 512, 479 and 448, and one TP rank's
              partial and S = 2 shards at 64 and 512 rows; plus a sweep of
              small shapes through every path of the paged kernel (hd 32 to
              256, GQA groups 1, 2, 7, 8, with and without a window); the
              sequence-sharded read (``row_map``, the TPU kernel's
              has_row_map) in every one of those served geometries of
              llama2-7b and the families, on fp4 and bf16 pools, over the
              virtual pool of each geometry's regions: bit-identical to the
              table walk over the original pool and within the check of
              the plain version, mixed and split decode timed; one TP
              rank's shapes: paged attention at 16 and 10 heads
              (llama2-7b on 2 ranks, llama2-13b on 4) in every served
              geometry, mixed and split decode timed, llama2-7b's 16 heads
              also over the virtual pool (``row_map``: a kv x model rank's
              read), mixtral-8x22b's kv 2 x data 2 x model 2 rank (24 heads
              over 4 kv heads, G 6) likewise, and the codec at the
              rank's partial, its gathered S = 2 and S = 4 shards and the
              two_phase slices, and at a training step's partials (8 x 256
              tokens: internlm2-1.8b TP 2, llama2-7b TP 4) and their
              gathered shards. Prints
              each kernel's
              device time (CUDA events around back-to-back launches) at every
              shape the served steps launch it, bytes moved and bound, and
              the launch floor (an add on one element).
4. reference— reduced llama2 on the card vs the same engine on the CPU (plain
              versions), dense fp32 pools: greedy tokens, steps, dispatches,
              preemptions and skipped prompt tokens identical on the mixed
              and split schedulers, whole-prompt prefill, a prefix-cache COW
              fork and eviction under a 7-block pool; supervised runs under
              die@3, corrupt@3 (fp4 and fp32 pools), exhaust@2:6x3 and stuck@4
              on a persistent prefix cache (warm recovery), max_queue and
              eos_id: tokens, outcomes, recovery events, the corruption
              watch's step and merged steps and dispatches identical; the
              new families' reduced configs with their GQA group and
              head_dim kept (G 7, 8; G 2 at hd 256 with a window) on the
              mixed step (fp32 and fp4 pools) and the split scheduler,
              tokens identical; the MoE families' reduced configs (mixtral
              G 6, llama4 G 5, 4 experts) the same, and the mixed step over
              an 80-token budget too (the sort-based dispatch; the 18-token
              budget runs every expert on every token); reduced jamba
              (Mamba, Mamba + MoE, attention) whole-prompt at exact
              lengths on fp32 and fp4 pools and through a preemption,
              tokens, steps, dispatches and preemptions identical; reduced
              pixtral (G 4, 16 patches) and whisper (2 + 2 layers over 64
              frames) the same, on random stand-in extra inputs; reduced
              xlstm (mLSTM, sLSTM) the same; one compressed mixed step on
              fp4 pools within a stated tolerance.
5. serve    — llama2-7b at full width and depth, random bf16 weights from a
              seed, TPContext(PAPER_DEFAULT, simulate_tp=4), on graphed steps
              (every step program a CUDA graph, captured at its first call,
              its launches recorded and added at each replay), 8 requests x 512
              prompt tokens x 32 new tokens: the mixed-step engine on fp4 and
              bf16 pools; (a) the split scheduler (chunk 256) on fp4 and bf16
              pools; (b) whole-prompt prefill on fp4 pools; (c) the mixed
              engine with prefix_cache and persistent_cache, prompts sharing
              a 256-token prefix, run twice on fp4 and on bf16 pools (the warm
              run forks tail blocks on bf16 and resumes at the aligned
              boundary on fp4); (d) the mixed engine on fp4 pools of 102
              blocks, so that it preempts; (e) measure_ttft at 512 and 2048
              prompt tokens, compressed vs uncompressed reductions; (f) the
              mixed engine supervised under exhaust@5:64x4;corrupt@9;die@20
              (fp4 pools) and corrupt@9 (bf16 pools); (h) an eos_id stop;
              (g) max_queue=2, then a deadline of 3/4 of the eos run's
              makespan with a cancel from a timer. Every run checks that
              each request reached its outcome (ok with 32 tokens, except in
              (g) and (h)), finite logits, a conserved free list with nothing
              held, the planned recoveries, and each kernel's launch count
              against the count the run's own stats give (a supervisor's
              merged over its attempts; launch counts reset just before each
              run), and prints its step programs (decode, prefill).
6. families — qwen2-7b, gemma3-4b and qwen3-32b at full width on random
              bf16 weights from a seed (``FAMILIES``): qwen2-7b at full
              depth, mixed on fp4 pools, split on bf16 pools, mixed under the
              two_phase variant (one more quantize and dequantize per
              compressed reduction) and measure_ttft at 512 tokens;
              gemma3-4b at full depth, 4 requests of 1536 tokens (past its
              1024 window), mixed fp4 and split bf16, measure_ttft at 2048;
              qwen3-32b mixed fp4 at full depth when its weights and pools
              fit the card once the earlier models are freed, else at the
              depth that fits (printed); the MoE families at full width on
              the largest prefix of their schedule that fits (``fit_depth``,
              each layer at its own size; printed: about 15 of mixtral's 56
              layers, 5 of llama4's 48, two of them MoE): mixtral-8x22b mixed
              fp4 with an eager twin whose tokens must equal the graphed
              run's (the graphs hold the routing sort, the dispatch scatter
              and the combine's scatter-add), split bf16 and measure_ttft at
              512; llama4-maverick mixed fp4 and split bf16; jamba-v0.1-52b
              (Mamba + MoE hybrid) on the prefix fit_depth finds (24 of 32
              layers with 84 GB free, three of them attention),
              whole-prompt (its only scheduler) on fp4 and bf16 pools over
              prompts of 512, 480 and 448 tokens (one step program per
              exact length, each captured once and replayed), an eager
              twin of the fp4 run whose tokens must equal the graphed
              run's, and measure_ttft at 512; pixtral-12b at full depth (40
              layers), 8 requests of 256 patch embeddings + 512 text
              tokens, and whisper-medium at full depth (24 encoder + 24
              decoder layers), 8 requests of 1500 encoder frames + a
              64-token decoder prompt and 64 new tokens (random stand-in
              extra inputs, seed 0), each whole-prompt on fp4 and bf16
              pools (the bf16 run with its split decode compressed too), an
              eager twin of the fp4 run, and measure_ttft compressed
              against uncompressed at 512 text tokens (pixtral) and 64
              decoder tokens over 1500 frames (whisper). Each run held as in phase 5 (on graphed steps; a MoE
              layer's launches count one compressed reduction for ``wo``
              and one per shared expert, a Mamba layer's one for its
              ``out_proj``, a whisper prefill 120 (the encoder's ``wo`` and
              ``down``, each decoder layer's two and its cross-attention's
              ``wo``) and a whisper decode step 72; paged reads and pool
              writes count attention layers only), with its weight GB and
              peak device memory printed.
7. sharded  — llama2-7b at full width and depth on 2 kv ranks (processes
              over gloo, ``file://`` rendezvous) sharing the one card, the
              paged pools sequence-sharded between them (each rank holds half
              of every pool; the blocks a step reads are exchanged through
              host memory): (a) mixed on fp4 pools under PAPER_DEFAULT over
              simulate_tp = 4 and on bf16 pools uncompressed, (b) split on
              fp4 pools of 12 blocks (it preempts), (c) the prefix cache on
              bf16 pools run twice (copy-on-write forks), (d) corrupt@3 on
              fp4 pools supervised, (e) capacity: one prompt that 2 x 17
              blocks hold and 17 do not. 4 requests of 64 + 8 tokens. Each
              run's tokens identical on both ranks and to the replicated
              engine's in this process, half the pool bytes per rank, the
              launch counts and the exchange's all-reduces (layers x pool
              planes per paged read and COW fork) exact; the replicated
              engine at the per-rank budget must refuse the long prompt.
              Prints the exchange's MB and ms per step and TPOT p50 sharded
              against replicated (one card, gloo, host-staged: not NVLink)
              and each rank's peak device memory. Sharded engines run eager
              steps (a graph cannot hold the host-staged exchange). Then
              jamba-v0.1-52b's layers 0-4 (its first attention layer is
              layer 4) and xlstm-125m at full depth, whole-prompt on fp4
              pools, on the same 2 ranks (``KV_STACKS``): tokens identical
              to the replicated engine's, half the attention pools and the
              whole recurrent state per rank.
9. tp       — tensor parallelism across ranks (``phase_tp``, after phase 7):
              llama2-7b at full width on its first 16 layers on 2
              ranks, (a) mixed on
              fp4 pools under PAPER_DEFAULT, (b) mixed on bf16 pools under
              two_phase, (c) split on bf16 pools with overlap_chunks=4, (d)
              whole-prompt prefill on fp4 pools, and the prefix cache on fp4
              pools cold then warm, (e) corrupt@3 supervised on fp4 pools,
              (f) measure_ttft at 512 tokens, compressed and uncompressed;
              llama2-13b (Table 3's 13b) at full width on its first 10
              layers on 4 ranks,
              (a) and (f); mixtral-8x22b at full width cut to 2 layers on 2
              ranks, (a): each rank holds half of every expert's d_ff (its
              routed-expert bytes held to half), and one dense all-reduce
              per MoE layer and step reduces the routed experts (the
              reference's TP-only path leaves them uncompressed);
              jamba-v0.1-52b at full width cut to layers 0-4 on 2 ranks,
              (d): each rank holds half of every Mamba layer's channels and
              recurrent state, and one dense all-reduce per Mamba layer
              and pass reduces x_proj (in fp32); xlstm-125m at full depth
              on 2 ranks, (d) and (f): each rank holds half of every mLSTM
              layer's channels, heads and state and of every sLSTM FF, the
              sLSTM gates and state whole, and one dense all-reduce per
              mLSTM layer and pass reduces its q/k/v/i/f partial (in
              fp32). Each rank
              holds 1/N of the heads, the MLP columns
              and the pools, and every row-parallel reduction is the
              compressed collective between the ranks (NCCL with a card per
              rank; with one card, gloo with every exchange staged through
              host memory and eager steps: not NVLink). Held against a
              single-rank simulate_tp=N engine run first in this process
              on the same weights and prompts: every rank's tokens
              identical to rank 0's, each rank 1/N of the pool bytes,
              launches and collectives exact per rank, the first mixed
              step's logits (full depth and cut to 2 layers): dense within a
              quarter of what compression moves them, compressed within the
              code flips the dense paths' rounding difference explains (x2;
              ``tp_flip_share``), and the collective bit-identical to the
              simulated reduction on
              the same partials (gather, two_phase). Prints the transport,
              the collectives, MB and host ms per step, the requests whose
              tokens equal the simulated run's, TPOT and TTFT.
10. dp      — data-parallel ranks and the MoE expert-parallel island
              (``phase_dp``, after phase 9): mixtral-8x22b at full width on
              the layers four ranks' shards fit (``grid_depth``: 13 of 56
              with 84 GB free) and llama4-maverick on its first 2 layers,
              each on a 2 x 2 data x model grid of ranks sharing the card
              (gloo, host-staged, eager steps): each rank holds its model
              rank's half of the heads and of the d_ff of its data rank's
              half of the experts. The split scheduler over 128 slots, 8
              requests of 64 + 8 tokens on fp4 pools, compressed
              (PAPER_DEFAULT, the decode compressed too), dense, and
              compressed with compressed all-to-alls: every decode step
              runs the island in each MoE layer (its down partials reduced
              by the paper's compressed collective), chunks never do.
              Held: the four ranks' tokens identical, launches and
              collectives exact per rank, island entries = MoE layers x
              decode steps (a run that never enters it fails), a quarter
              of the routed experts' bytes per rank. Prints the island's
              down, all-to-all and data all-gather MB per decode step
              against the dense run's, and TPOT. ``--phase dp [arch ...]``
              runs it alone (NCCL and graphed steps with a card per rank).
11. kvtp    — sequence-sharded pools on TP rows and on the data x model grid
              (``phase_kvtp``, after phase 10; the reference's ``kv x data x
              model`` mesh, ``make_kv_mesh``): llama2-7b at full width cut to
              its first 4 layers on kv 2 x model 2 ranks sharing the card
              over gloo (host-staged exchanges, eager steps). Each rank holds
              half the blocks of the pools of its half of the kv heads
              (1/4 of the pool bytes) and its row's half of the weights (the
              same on both kv ranks); every pool plane's exchange, scatter,
              COW copy and fault fill runs over the kv group of its model
              position, the compressed reductions over its row. Every rank
              serves mixed and split on fp4 pools under PAPER_DEFAULT, the
              prefix cache on bf16 pools twice (the warm run's COW forks over
              the kv group) and the capacity case, first with replicated pools
              (its row alone) and then sharded: tokens identical on the four
              ranks and to each row's replicated run, launches, exchange
              all-reduces and row collectives exact, the pool bytes held 1/4
              of the whole; at the per-rank budget of 17 blocks the sharded
              row serves a 525-token prompt the replicated row refuses. A
              ``kvtp[...]`` line per run prints the extents, the transport,
              the exchange's MB and host ms per step, the pool bytes a rank
              holds and TPOT sharded against replicated. Paged attention at
              16 local kv heads (G 1) over the virtual pool (``row_map``) is
              held and timed in phase 3. ``--phase kvtp [arch ...]`` runs it
              alone: llama2-7b at full depth on kv 2 x model 2 (over NCCL with
              four cards, one a rank) and mixtral-8x22b on kv 2 x
              data 2 x model 2 (8 ranks on one card over gloo, at the depth
              ``grid_depth`` finds for them), whose split decode over 128
              slots enters the MoE island in every layer; its tokens and
              island counts are held to the same ranks' replicated run.
8. graphs   — (run right after phase 5, on its weights and prompts) an eager
              twin (``cuda_graphs=False``) of phase 5's graphed mixed fp4 and
              bf16, split bf16 and whole-prompt fp4 runs: greedy tokens
              identical in every request (no tolerance: the graph replays
              the eager step's kernels), launches exact on both, the program
              counts (decode_cache_size, prefill_cache_size) as expected on
              both, 2 for a mixed engine that ran both gate variants; an
              eager corrupt@9 supervised run whose tokens and hard recovery
              the graphed one must match; measure_ttft on eager steps.
              Prints capture seconds per program, TPOT p50, tokens/s and
              the device memory each run added at its peak (graph pool and
              activations) graphed against eager, and measure_ttft at
              512 and 2048 tokens, graphed against eager, compressed against
              uncompressed. Then the analytic TTFT model's H100 constants
              fitted on this run (``launch/ttft_table.fit_h100``) and its
              codec term against the measured one (``one_card_check``).

12. train  — training (``phase_train``, after phase 11): internlm2-1.8b at
              full width and depth (24 layers, vocab 258: the reference
              launch/train.py's default), bf16 weights and fp32 AdamW moments
              on the one card, 20 steps of 8 x 256 corpus tokens
              (uncompressed: one card has no reduction between ranks):
              every loss finite, the last 5 steps' mean below the first 5's;
              prints step ms p50 against the matmul bound, tokens/s, peak
              memory and the AdamW update's device ms against its bytes
              bound. Then the same width on its first 4 layers on 2 TP ranks
              sharing the card (gloo, host-staged), every row-parallel
              reduction compressed (PAPER_DEFAULT) with the
              straight-through backward, 3 steps: losses equal on both
              ranks, replicated weights bit-equal after the steps, the first
              loss within rel 1e-4 of the one-card simulate_tp=2 forward and
              more than that from the dense first loss, 2
              quantize and 2 dequantize+sum launches per layer a step and
              none in the backward, 4 all-gathers per layer forward, 2
              backward all-reduces per layer and one optimizer all-reduce a
              step, the compressed gradient's cosine with the dense one above
              0.7. ``--phase train [arch ...]`` runs ``TRAIN_MODELS``
              (internlm2-1.8b on 2 ranks, llama2-7b on 4, full depth) over
              NCCL with a card per rank, compressed against dense step ms.

The line before the last is the JSON ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py --phase
tp [arch ...]`` builds the kernels and runs phase 9 alone (on a machine with
a card per rank, over NCCL), for the named ``TP_MODELS`` or all of them;
``--phase dp [arch ...]`` phase 10 likewise (``DP_MODELS``), ``--phase kvtp
[arch ...]`` phase 11 (``KVTP_MODELS``, at full depth).
Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM, fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM, dense bf16 tensor cores

KERNELS = {  # name -> (source in the repo, the TPU kernel it replaces)
    "mx_quant": ("src/repro_torch/kernels/csrc/mx_quant.cu",
                 "src/repro/kernels/mx_quant.py:28"),
    "mx_dequant": ("src/repro_torch/kernels/csrc/mx_dequant.cu",
                   "src/repro/kernels/mx_dequant.py:44"),
    "mx_dequant_reduce": ("src/repro_torch/kernels/csrc/mx_dequant_reduce.cu",
                          "src/repro/kernels/mx_dequant.py:50"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:45"),
}

# the slice's shapes (llama2-7b, mixed step)
T, TP, D, SLOTS, BS, CHUNK, PROMPT, NEW = 260, 4, 4096, 4, 16, 256, 512, 32
MAX_LEN = PROMPT + NEW
TTFT_LENS, TTFT_ITERS = (512, 2048), 6   # measure_ttft prompt lengths, prefills each

# The new families' serve phase (``phase_family``), in the order they run:
# requests, prompt tokens per request, runs (scheduler/pools; "two_phase"
# is the mixed step under the two_phase variant), measure_ttft lengths and
# the runs given an eager twin (``graphs_vs_eager``). The paged and codec
# phases time each family at the shapes these runs give.
FAMILIES = {
    "qwen2-7b": dict(requests=8, prompt=PROMPT, ttft=(512,),
                     runs=("mixed/fp4_e2m1", "split/bf16", "two_phase/fp4_e2m1")),
    "gemma3-4b": dict(requests=4, prompt=1536, ttft=(2048,),
                      runs=("mixed/fp4_e2m1", "split/bf16")),
    "qwen3-32b": dict(requests=4, prompt=PROMPT, ttft=(), runs=("mixed/fp4_e2m1",)),
    "mixtral-8x22b": dict(requests=8, prompt=PROMPT, ttft=(512,),
                          runs=("mixed/fp4_e2m1", "split/bf16"), eager=("mixed/fp4_e2m1",)),
    "llama4-maverick-400b-a17b": dict(requests=4, prompt=PROMPT, ttft=(),
                                      runs=("mixed/fp4_e2m1", "split/bf16")),
    # a recurrent stack serves whole-prompt only, each prompt at its exact
    # length: three lengths, so three prefill programs are captured and each
    # replayed; its only paged read is the split decode
    "jamba-v0.1-52b": dict(requests=8, prompt=PROMPT, lengths=(PROMPT, PROMPT - 32, PROMPT - 64),
                           ttft=(512,), runs=("whole/fp4_e2m1", "whole/bf16"),
                           eager=("whole/fp4_e2m1",), geometries=("decode",)),
    # a vision prefix (256 patch embeddings ahead of 512 text tokens) and an
    # encoder-decoder (1500 encoder frames, a 64-token decoder prompt, 64 new
    # tokens) serve whole-prompt only too, text bucketed to powers of two;
    # ``prompt`` counts text tokens. ``compress_decode`` names the runs whose
    # split decode compresses its reductions as well (the engine's option)
    "pixtral-12b": dict(requests=8, prompt=PROMPT, ttft=(512,),
                        runs=("whole/fp4_e2m1", "whole/bf16"), eager=("whole/fp4_e2m1",),
                        compress_decode=("whole/bf16",), geometries=("decode",)),
    "whisper-medium": dict(requests=8, prompt=64, new=64, ttft=(64,),
                           runs=("whole/fp4_e2m1", "whole/bf16"), eager=("whole/fp4_e2m1",),
                           compress_decode=("whole/bf16",), geometries=("decode",)),
    # mLSTM + sLSTM, no attention layer: no pools and no paged read;
    # whole-prompt at exact lengths (479 is prime: the reference would run it
    # in 1-token chunks, the port in 128-token chunks and a shorter last one)
    "xlstm-125m": dict(requests=8, prompt=PROMPT, lengths=(PROMPT, 479, 448), ttft=(512,),
                       runs=("whole/fp4_e2m1", "whole/bf16"), eager=("whole/fp4_e2m1",),
                       geometries=()),
}


def n_prefix(cfg) -> int:
    """Positions a vision model's patch embeddings take ahead of the text."""
    return cfg.n_patches if cfg.frontend == "vision" else 0


def stubs(cfg, batch: int):
    """``Engine.run``'s ``extra_inputs`` for ``batch`` requests of ``cfg``:
    the random stand-in patch embeddings or encoder frames (seed 0, on the
    host, in the model's dtype); None for a text decoder."""
    import torch

    from repro_torch.models.frontends import frontend_stubs

    return frontend_stubs(cfg, batch, 0, getattr(torch, cfg.dtype)) or None


def first_rows(extra, n: int = 1):
    """The first ``n`` rows of every extra input (None stays None)."""
    return extra and {k: v[:n] for k, v in extra.items()}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_QUIET = [False]   # set in a kv rank other than 0: only rank 0 prints


def log(msg: str) -> None:
    if not _QUIET[0]:
        print(msg, flush=True)


def device_ms(torch, fn, n: int = 50, reps: int = 3) -> float:
    """Device time per launch (ms): one event pair around ``n`` back-to-back
    calls, queued behind a ``torch.cuda._sleep`` long enough for the host to
    enqueue all of them, so the card runs them without a gap; the median of
    ``reps`` such runs, divided by ``n``. A run whose enqueue outlasted its
    sleep is repeated with a sleep twice as long (at most 4 times); a
    function that waits for the card inside fails here."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sleep_s = max(10 * (time.perf_counter() - t0), 0.025)   # 10x the enqueue, >= 25 ms
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        for _ in range(4):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            slept = min(sleep_s, 2.0)
            torch.cuda._sleep(int(slept * 2e9))   # <= 2 GHz: sleeps >= slept
            a.record()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            enq = time.perf_counter() - t0
            b.record()
            b.synchronize()
            if enq < slept:
                break
            sleep_s *= 2
        check(enq < slept, f"device_ms: the host enqueue ({enq:.4f} s) outlasted the sleep")
        runs.append(a.elapsed_time(b) / n)
    runs.sort()
    return runs[len(runs) // 2]


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- kernels


CODEC_BLOCKS = (8, 16, 64, 128, 256)   # block sizes held beside 32, for fp4_e2m1 and int8
RAGGED_ROWS = (1, 3, 257)


def codec_partials(torch, rows, width, g, dev):
    """The quantize checks' base inputs: ``(rows, width)`` partials at
    row_linear's spread of scales (randn times 10^[-3, 3) per row) in fp32,
    where hardly any value is a bf16, and rounded to bf16 with rows 0-5
    holding the edge blocks (as many of them as there are rows)."""
    xf = torch.randn(rows, width, generator=g, device=dev)
    xf = xf * torch.pow(10.0, torch.rand(rows, 1, generator=g, device=dev) * 6 - 3)
    x = xf.to(torch.bfloat16)
    edges = ((0, slice(None), 0.0),              # zero row
             (1, slice(None), 1e-40),            # subnormal amax
             (2, 5, float("nan")),               # NaN block
             (3, 7, float("inf")),               # +inf block
             (4, 9, float("-inf")),              # -inf block
             (5, slice(0, 32), 0.0))             # zero block inside a normal row
    for row, col, value in edges[:rows]:
        x[row, col] = value
    return x, xf


def fp32_edge_rows(torch, spec, width, dev):
    """Two fp32 rows that put the quantizer on its edges. In the first, block
    b's amax is the float just below 2^k (k = -40 .. 39 over the blocks), so
    the exponent field is one below k's and the mantissa all ones. In the
    second, block b holds 2^emax * 2^e first (so its shared exponent is e)
    and then the format's midpoints and their fp32 neighbours times 2^e,
    cycled so that the blocks together hold each of them; e runs over -126,
    -125, -100, 100 - emax and -20 .. 19."""
    from repro_torch.core.mx import pow2

    B = spec.block_size
    i = torch.arange(width // B, device=dev)
    p2 = pow2(i % 80 - 40)
    a = torch.linspace(-0.5, 0.5, B, device=dev) * p2[:, None]    # |a| <= 2^(k-1)
    a[:, 0] = torch.nextafter(p2, torch.zeros_like(p2))
    m = torch.tensor(spec.elem.midpoints, dtype=torch.float32, device=dev)
    inf = torch.full_like(m, float("inf"))
    near = torch.cat([m, torch.nextafter(m, -inf), torch.nextafter(m, inf)])
    exps = torch.tensor([-126, -125, -100, 100 - spec.elem.emax] + list(range(-20, 20)),
                        device=dev)
    e = exps[i % len(exps)]
    b = near[(i[:, None] * (B - 1) + torch.arange(B, device=dev)) % len(near)] * pow2(e)[:, None]
    b[:, 0] = pow2(e + spec.elem.emax)
    return torch.stack([a.reshape(-1), b.reshape(-1)])


def codec_inputs(torch, x, xf, spec, t):
    """The quantize checks' inputs for ``spec`` from ``codec_partials``: the
    bf16 partials, ``t`` rows of them in fp32 (bf16-exact), ``t`` rows of the
    fp32 partials with ``fp32_edge_rows`` below them, then ragged row counts
    from row 3 on (an inf block first) at full width and at 3 blocks a row
    (so the last warp and CTA are partial), in bf16 and fp32."""
    edge = torch.cat([xf[:t], fp32_edge_rows(torch, spec, x.shape[1], x.device)])
    return [x, x[:t].float(), edge] + [x[3:3 + m, :n].contiguous().to(dt) for m in RAGGED_ROWS
                                       for n in (x.shape[1], 3 * spec.block_size)
                                       for dt in (torch.bfloat16, torch.float32)]


def phase_kernels(torch, dev="cuda"):
    """The codec kernels (``phase_codec``), then paged attention."""
    info = phase_codec(torch, dev)
    info.update(phase_paged(torch, dev))
    info["paged_attention"]["launch_floor_ms"] = info["mx_quant"]["launch_floor_ms"]
    return info


def phase_codec(torch, dev="cuda"):
    """The three codec kernels against their plain versions, timed at every
    shape the served step launches them, and the launch floor."""
    from repro_torch.core.formats import ELEMENT_FORMATS, MXSpec
    from repro_torch.core.mx import MXCompressed
    from repro_torch.kernels import mx_dequant, mx_quant

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    fp4 = MXSpec.make("fp4_e2m1", 32, "e8m0")
    info = {}

    def same(a, b):
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    def max_err(a, b):  # max |a - b| over the finite values (inf/NaN must match)
        fin = torch.isfinite(a) & torch.isfinite(b)
        return float((a.float() - b.float())[fin].abs().max()) if fin.any() else 0.0

    def timed(run, plain, nbytes, n_ops, shape):
        b_ms, b_by = bound(nbytes, n_ops, FP32_OPS_PER_S)
        return dict(ms=device_ms(torch, run), plain_ms=device_ms(torch, plain, n=5),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=nbytes, shape=shape)

    # the launch floor: device time of the smallest kernel, an add on one element
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(torch, lambda: one.add_(1.0))
    log(f"kernel launch floor: {floor_ms:.4f} ms on the device (in-place add, one element)")

    # --- quantize: (TP*T, D) partials of row_linear, with edge blocks
    x, xf = codec_partials(torch, TP * T, D, g, dev)
    specs = [MXSpec.make(f, 32, "e8m0") for f in sorted(ELEMENT_FORMATS)]
    specs += [MXSpec.make(f, b, "e8m0") for f in ("fp4_e2m1", "int8") for b in CODEC_BLOCKS]
    bad, q_err, n_q, quantized = [], 0.0, 0, {}
    for spec in specs:
        for xin in codec_inputs(torch, x, xf, spec, T):
            k = mx_quant.mx_quantize_2d(xin, spec)
            p = mx_quant.quantize_plain(xin, spec)
            if not (torch.equal(k.payload, p.payload) and torch.equal(k.scales, p.scales)):
                bad.append(f"{spec.name}/{xin.dtype}/{tuple(xin.shape)}")
            q_err = max(q_err, max_err(k.payload, p.payload), max_err(k.scales, p.scales))
            quantized.setdefault(spec.name, []).append(k)
            n_q += 1
    check(not bad, f"mx_quant bytes differ from the plain version: {bad}")
    what = (f"{len(specs)} specs (13 formats at block 32; fp4_e2m1, int8 at blocks "
            f"{', '.join(map(str, CODEC_BLOCKS))}) x ({TP * T}, {D}) bf16, ({T}, {D}) fp32 "
            f"bf16-exact, ({T + 2}, {D}) fp32 not bf16-exact with 2 edge rows, and rows "
            f"{', '.join(map(str, RAGGED_ROWS))} at width {D} and 3 blocks in bf16 and fp32")
    shapes = []
    for m in (TP * T, T):   # the TP partials, the pool append's K or V
        xm = x[:m]
        comp = mx_quant.mx_quantize_2d(xm, fp4)
        nbytes = xm.numel() * 2 + comp.payload.numel() + comp.scales.numel()
        shapes.append(timed(lambda: mx_quant.mx_quantize_2d(xm, fp4),
                            lambda: mx_quant.quantize_plain(xm, fp4), nbytes, xm.numel() * 20,
                            f"({m}, {D}) bf16 -> fp4_e2m1_b32"))
    # the other served call sites: the split chunk's TP partials and pool
    # append (K or V), the whole-prompt prefill's TP partials, the
    # whole-prompt insert and the split decode's pool append, each bytes
    # exact and timed
    xb, _ = codec_partials(torch, TP * PROMPT, D, g, dev)
    for m, site in ((TP * CHUNK, "chunk TP partials"), (CHUNK, "split chunk append"),
                    (TP * PROMPT, "whole-prompt TP partials"), (PROMPT, "whole-prompt insert"),
                    (SLOTS, "split decode append")):
        xm = xb[:m]
        k, pl = mx_quant.mx_quantize_2d(xm, fp4), mx_quant.quantize_plain(xm, fp4)
        check(torch.equal(k.payload, pl.payload) and torch.equal(k.scales, pl.scales),
              f"mx_quant bytes differ from the plain version at ({m}, {D}), {site}")
        nbytes = xm.numel() * 2 + k.payload.numel() + k.scales.numel()
        shapes.append(timed(lambda: mx_quant.mx_quantize_2d(xm, fp4),
                            lambda: mx_quant.quantize_plain(xm, fp4), nbytes, xm.numel() * 20,
                            f"({m}, {D}) bf16 -> fp4_e2m1_b32, {site}"))
        n_q += 1
    info["mx_quant"] = dict(shapes[0], max_abs_err=q_err, launch_floor_ms=floor_ms, cases=n_q,
                            shapes=shapes[1:])
    log(f"kernel mx_quant: bytes exact in {n_q} cases, {what}, zero/subnormal/NaN/inf blocks "
        f"included; " + "; ".join(f"{r['shape']} {r['ms']:.4f} ms on the device (plain "
                                  f"{r['plain_ms']:.4f} ms), {r['bytes'] / 1e6:.2f} MB, bound "
                                  f"{r['bound_ms']:.4f} ms" for r in shapes))

    # --- dequantize: every quantized case above, to bf16 and fp32
    bad, d_err, n_d = [], 0.0, 0
    for spec in specs:
        for c in quantized[spec.name]:
            for dt in (torch.bfloat16, torch.float32):
                k = mx_dequant.mx_dequantize_2d(c.payload, c.scales, spec, dt)
                p = mx_dequant.dequantize_plain(c, spec, dt)
                if not same(k, p):
                    bad.append(f"{spec.name}/{dt}/{tuple(c.payload.shape)}")
                d_err = max(d_err, max_err(k, p))
                n_d += 1
    check(not bad, f"mx_dequant differs from the plain version: {bad}")
    c = mx_quant.mx_quantize_2d(x[:T], fp4)   # the step's K/V round trip, (T, D) -> bf16
    # a poisoned pool block: scale bytes 255 decode as 2^128 = +inf, so its
    # values come out inf (code != 0) or NaN (0 * inf), as in the reference
    bad_scales = c.scales.clone()
    bad_scales[POISON_ROWS, POISON_BLOCK] = 255
    for dt in (torch.bfloat16, torch.float32):
        k = mx_dequant.mx_dequantize_2d(c.payload, bad_scales, fp4, dt)
        p = mx_dequant.dequantize_plain(MXCompressed(c.payload, bad_scales), fp4, dt)
        check_poisoned(torch, k, p, POISON_ROWS, POISON_BLOCK * 32, f"mx_dequant ({dt})")
        n_d += 1
    nbytes = c.payload.numel() + c.scales.numel() + T * D * 2
    info["mx_dequant"] = dict(
        timed(lambda: mx_dequant.mx_dequantize_2d(c.payload, c.scales, fp4, torch.bfloat16),
              lambda: mx_dequant.dequantize_plain(c, fp4, torch.bfloat16), nbytes, T * D * 2,
              f"({T}, {D}) fp4_e2m1_b32 -> bf16"),
        max_abs_err=d_err, launch_floor_ms=floor_ms, cases=n_d)
    r = info["mx_dequant"]
    log(f"kernel mx_dequant: exact in {n_d} cases (every quantize case -> bf16, fp32, and "
        f"a block of scale byte 255 in rows {POISON_ROWS}: inf/NaN where the plain version's); "
        f"({T},{D}) -> bf16 {r['ms']:.4f} ms on the device (plain {r['plain_ms']:.4f} ms), "
        f"{nbytes / 1e6:.2f} MB, bound {r['bound_ms']:.4f} ms")

    # --- dequantize + reduce: the compressed row-parallel epilogue, S = TP
    r_err, n_r = 0.0, 0
    for spec in specs:
        full = quantized[spec.name][0]           # the (TP*T, D) bf16 partials
        w = MXCompressed(full.payload.reshape(TP, T, -1), full.scales.reshape(TP, T, -1))
        for dt in (torch.bfloat16, torch.float32):
            k = mx_dequant.dequant_reduce(w.payload, w.scales, spec, dt)
            p = mx_dequant.dequant_reduce_plain(w, spec, dt)
            check(same(k, p), f"mx_dequant_reduce differs from the plain version "
                              f"({spec.name}, {dt})")
            r_err = max(r_err, max_err(k, p))
            n_r += 1
            if spec == fp4:   # one shard's block poisoned: the sum is inf/NaN there
                bad_scales = w.scales.clone()
                bad_scales[1, POISON_ROWS, POISON_BLOCK] = 255
                k = mx_dequant.dequant_reduce(w.payload, bad_scales, spec, dt)
                p = mx_dequant.dequant_reduce_plain(MXCompressed(w.payload, bad_scales), spec, dt)
                check_poisoned(torch, k, p, POISON_ROWS, POISON_BLOCK * 32,
                               f"mx_dequant_reduce ({dt})")
                n_r += 1
    red_shapes = []
    for rows, site, src in ((T, "mixed step", x), (CHUNK, "split chunk", xb),
                            (PROMPT, "whole-prompt prefill", xb)):
        comp = mx_quant.mx_quantize_2d(src[:TP * rows], fp4)
        w = MXCompressed(comp.payload.reshape(TP, rows, -1), comp.scales.reshape(TP, rows, -1))
        if rows != T:   # the new served shapes, exact like every case above
            check(same(mx_dequant.dequant_reduce(w.payload, w.scales, fp4, torch.bfloat16),
                       mx_dequant.dequant_reduce_plain(w, fp4, torch.bfloat16)),
                  f"mx_dequant_reduce differs from the plain version at S={TP} x {rows}")
            n_r += 1
        nbytes = w.payload.numel() + w.scales.numel() + rows * D * 2
        red_shapes.append(timed(
            lambda w=w: mx_dequant.dequant_reduce(w.payload, w.scales, fp4, torch.bfloat16),
            lambda w=w: mx_dequant.dequant_reduce_plain(w, fp4, torch.bfloat16), nbytes,
            TP * rows * D * 2, f"S={TP} x ({rows}, {D}) fp4_e2m1_b32 -> bf16, {site}"))
    info["mx_dequant_reduce"] = dict(red_shapes[0], max_abs_err=r_err, launch_floor_ms=floor_ms,
                                     cases=n_r, shapes=red_shapes[1:])
    r = info["mx_dequant_reduce"]
    log(f"kernel mx_dequant_reduce: exact in {n_r} cases ({len(specs)} specs x (bf16, fp32), "
        f"a poisoned block of shard 1, and the chunk and whole-prompt shapes); " + "; ".join(
            f"{r['shape']} {r['ms']:.4f} ms on the device (plain {r['plain_ms']:.4f} ms), "
            f"{r['bytes'] / 1e6:.2f} MB, bound {r['bound_ms']:.4f} ms" for r in red_shapes))

    # the new families' widths at the shapes their serve runs launch the codec
    info["mx_dequant"]["shapes"] = []
    for name, rows in codec_tp(torch, dev, g, fp4, same, timed).items():
        info[name]["shapes"] += rows
        log(f"kernel {name} (TP ranks): exact; " + "; ".join(
            f"{r['shape']} {r['ms']:.4f} ms on the device (plain {r['plain_ms']:.4f} ms), "
            f"{r['bytes'] / 1e6:.2f} MB, bound {r['bound_ms']:.4f} ms" for r in rows))
    for arch, plan in FAMILIES.items():
        for name, rows in codec_family(torch, dev, g, fp4, arch, plan, same, timed).items():
            info[name]["shapes"] += rows
            if rows:
                log(f"kernel {name} ({arch}): bytes exact; " + "; ".join(
                    f"{r['shape']} {r['ms']:.4f} ms on the device (plain "
                    f"{r['plain_ms']:.4f} ms), {r['bytes'] / 1e6:.2f} MB, bound "
                    f"{r['bound_ms']:.4f} ms" for r in rows))
    return info


def codec_tp(torch, dev, g, fp4, same, timed):
    """The codec at the shapes one rank of the TP phase launches it (the
    mixed step's T rows): llama2-7b on 2 ranks, the partial (T, 4096), its
    gathered S = 2 shards, and two_phase's slices: the N destination slices
    (2 T, 2048), the reduction of the 2 received ones, the reduced slice's
    quantize and the 2 gathered slices' dequantize; llama2-13b on 4 ranks,
    the partial (T, 5120) and its S = 4 shards; whisper-medium on 2 ranks,
    the encoder's partial (1500, 1024) of a prefill and its S = 2 shards;
    pixtral-12b on 2 ranks, the prefix-plus-prompt partial (256 + 64,
    5120) of the phase's prefill and its S = 2 shards; xlstm-125m on 2
    ranks, the partial (64, 768) of the phase's prompts and (512, 768) of
    its measure_ttft prefill, and their S = 2 shards; a training step's
    partial (8 x 256 tokens) on internlm2-1.8b TP 2 (2048, 2048) and
    llama2-7b TP 4 (2048, 4096) and their gathered shards; at one rank of the dp
    phase's 2 x 2 grid (``DP_MODELS``), the island's ``down`` partial (dp,
    E/dp, C, d) of a DP_SLOTS-row decode step (mixtral (160, 6144), llama4
    (128, 5120); under ``compress_all_to_all`` its dispatch and combine
    tensors are the same shape, quantized and dequantized), its S = 2
    gathered shards and the dequantize of a received all-to-all. Each exact
    against the plain version and timed."""
    from repro_torch.configs import get_config
    from repro_torch.core.mx import MXCompressed
    from repro_torch.kernels import mx_dequant, mx_quant

    sites = {  # kernel -> (shards S, rows, width, site)
        "mx_quant": [(1, T, 4096, "llama2-7b TP 2 partial"),
                     (1, 2 * T, 2048, "llama2-7b TP 2 two_phase destination slices"),
                     (1, T, 2048, "llama2-7b TP 2 two_phase reduced slice"),
                     (1, T, 5120, "llama2-13b TP 4 partial"),
                     (1, 1500, 1024, "whisper-medium TP 2 encoder partial"),
                     (1, 256 + SHARD_PROMPT, 5120, "pixtral-12b TP 2 prefix-plus-prompt partial"),
                     (1, SHARD_PROMPT, 768, "xlstm-125m TP 2 prompt partial"),
                     (1, TP_TTFT, 768, "xlstm-125m TP 2 measure_ttft partial"),
                     (1, TRAIN_BATCH * TRAIN_SEQ, 2048, "internlm2-1.8b TP 2 training partial"),
                     (1, TRAIN_BATCH * TRAIN_SEQ, 4096, "llama2-7b TP 4 training partial")]
        + [(1, island_rows(get_config(a)), get_config(a).d_model,
            f"{a} 2 x 2 grid island down partial (dp, E/dp, C, d), also the "
            f"compress_all_to_all dispatch and combine tensor") for a in DP_MODELS],
        "mx_dequant_reduce": [(2, T, 4096, "llama2-7b TP 2 gathered shards"),
                              (2, T, 2048, "llama2-7b TP 2 two_phase received slices"),
                              (4, T, 5120, "llama2-13b TP 4 gathered shards"),
                              (2, 1500, 1024, "whisper-medium TP 2 encoder gathered shards"),
                              (2, 256 + SHARD_PROMPT, 5120,
                               "pixtral-12b TP 2 prefix-plus-prompt gathered shards"),
                              (2, SHARD_PROMPT, 768, "xlstm-125m TP 2 prompt gathered shards"),
                              (2, TP_TTFT, 768, "xlstm-125m TP 2 measure_ttft gathered shards"),
                              (2, TRAIN_BATCH * TRAIN_SEQ, 2048,
                               "internlm2-1.8b TP 2 training gathered shards"),
                              (4, TRAIN_BATCH * TRAIN_SEQ, 4096,
                               "llama2-7b TP 4 training gathered shards")]
        + [(2, island_rows(get_config(a)), get_config(a).d_model,
            f"{a} 2 x 2 grid island down gathered shards") for a in DP_MODELS],
        "mx_dequant": [(1, 2 * T, 2048, "llama2-7b TP 2 two_phase gathered slices")]
        + [(1, island_rows(get_config(a)), get_config(a).d_model,
            f"{a} 2 x 2 grid island compress_all_to_all received tensor (dp, E/dp, C, d)")
           for a in DP_MODELS],
    }
    out = {}
    for name, rows in sites.items():
        out[name] = []
        for S, m, width, site in rows:
            x, _ = codec_partials(torch, S * m, width, g, dev)
            c = mx_quant.mx_quantize_2d(x, fp4)
            shape = f"({S} x {m}, {width})" if S > 1 else f"({m}, {width})"
            if name == "mx_quant":
                pl = mx_quant.quantize_plain(x, fp4)
                check(torch.equal(c.payload, pl.payload) and torch.equal(c.scales, pl.scales),
                      f"mx_quant bytes differ from the plain version at {shape}, {site}")
                run = lambda x=x: mx_quant.mx_quantize_2d(x, fp4)
                plain = lambda x=x: mx_quant.quantize_plain(x, fp4)
                nbytes = x.numel() * 2 + c.payload.numel() + c.scales.numel()
                what, n_ops = f"{shape} bf16 -> fp4_e2m1_b32, {site}", x.numel() * 20
            elif name == "mx_dequant":
                check(same(mx_dequant.mx_dequantize_2d(c.payload, c.scales, fp4, torch.bfloat16),
                           mx_dequant.dequantize_plain(c, fp4, torch.bfloat16)),
                      f"mx_dequant differs from the plain version at {shape}, {site}")
                run = lambda c=c: mx_dequant.mx_dequantize_2d(c.payload, c.scales, fp4,
                                                              torch.bfloat16)
                plain = lambda c=c: mx_dequant.dequantize_plain(c, fp4, torch.bfloat16)
                nbytes = c.payload.numel() + c.scales.numel() + m * width * 2
                what, n_ops = f"{shape} fp4_e2m1_b32 -> bf16, {site}", m * width * 2
            else:
                w = MXCompressed(c.payload.reshape(S, m, -1), c.scales.reshape(S, m, -1))
                check(same(mx_dequant.dequant_reduce(w.payload, w.scales, fp4, torch.bfloat16),
                           mx_dequant.dequant_reduce_plain(w, fp4, torch.bfloat16)),
                      f"mx_dequant_reduce differs from the plain version at {shape}, {site}")
                run = lambda w=w: mx_dequant.dequant_reduce(w.payload, w.scales, fp4,
                                                            torch.bfloat16)
                plain = lambda w=w: mx_dequant.dequant_reduce_plain(w, fp4, torch.bfloat16)
                nbytes = w.payload.numel() + w.scales.numel() + m * width * 2
                what, n_ops = f"S={S} x ({m}, {width}) fp4_e2m1_b32 -> bf16, {site}", \
                    S * m * width * 2
            out[name].append(timed(run, plain, nbytes, n_ops, what))
    return out


def codec_sites(cfg, plan):
    """The codec's call sites in a family's serve runs (``FAMILIES``): (rows,
    width, site) of each quantize, dequantize and S = TP dequantize+reduce.
    The row-parallel reductions (``wo``, ``down``, a Mamba layer's
    ``out_proj``, a cross-attention's ``wo``) are d_model wide, the pool
    writes and the mixed step's K/V round trip kv_dim wide. A whole-prompt
    family (a recurrent stack, a vision prefix, an encoder-decoder) runs no
    mixed step: its prefill at each prompt length (the vision prefix's
    positions included), the insert of its K/V, the split decode's append
    (neither for a stack without attention: xLSTM's ``down`` and
    ``ff_down`` are its only call sites), and an encoder-decoder's encoder
    over its frames."""
    d, kv, pre = cfg.d_model, cfg.kv_dim, n_prefix(cfg)
    kinds = {r.split("/")[0] for r in plan["runs"]}
    pools = attn_layers(cfg) > 0   # a stack without attention (xLSTM) writes no pool
    quant, deq, red = [], [], []
    if kinds - {"split", "whole"}:   # a mixed step runs
        quant = [(TP * T, d, "mixed TP partials"), (T, kv, "mixed pool append, K or V")]
        deq = [(T, kv, "mixed K/V round trip")]
        red = [(T, d, "mixed step")]
    if "whole" in kinds:   # whole-prompt prefill at each length, insert, split decode
        for n in plan.get("lengths", (plan["prompt"],)):
            quant += [(TP * (pre + n), d, f"whole-prompt TP partials, {pre + n} tokens")]
            quant += [(pre + n, kv, f"whole-prompt insert, K or V, {pre + n} tokens")] * pools
            red.append((pre + n, d, f"whole-prompt prefill, {pre + n} tokens"))
        quant += [(SLOTS, kv, "split decode append, K or V")] * pools
        if cfg.encoder_decoder:
            F = cfg.encoder_seq
            quant.append((TP * F, d, f"encoder TP partials, {F} frames"))
            red.append((F, d, f"encoder, {F} frames"))
    if "split" in kinds:
        quant.append((TP * CHUNK, d, "split chunk TP partials"))
        red.append((CHUNK, d, "split chunk"))
    for n in plan["ttft"]:
        if (TP * (pre + n), d, f"whole-prompt TP partials, {pre + n} tokens") not in quant:
            quant.append((TP * (pre + n), d, f"whole-prompt TP partials, {pre + n} tokens"))
            red.append((pre + n, d, f"whole-prompt prefill, {pre + n} tokens"))
    if "two_phase" in kinds:
        quant.append((T, d, "two_phase re-quantize of the reduced result"))
        deq.append((T, d, "two_phase second pass"))
    return {"mx_quant": quant, "mx_dequant": deq, "mx_dequant_reduce": red}


def codec_family(torch, dev, g, fp4, arch, plan, same, timed):
    """Each codec kernel at ``codec_sites``: bytes (or values) equal to the
    plain version's, device time, the plain version's, the bound."""
    from repro_torch.configs import get_config
    from repro_torch.core.mx import MXCompressed
    from repro_torch.kernels import mx_dequant, mx_quant

    out = {}
    for name, sites in codec_sites(get_config(arch), plan).items():
        rows = []
        for m, width, site in sites:
            shape = f"{arch}: ({m}, {width})"
            if name == "mx_quant":
                x, _ = codec_partials(torch, m, width, g, dev)
                k, pl = mx_quant.mx_quantize_2d(x, fp4), mx_quant.quantize_plain(x, fp4)
                check(torch.equal(k.payload, pl.payload) and torch.equal(k.scales, pl.scales),
                      f"mx_quant bytes differ from the plain version at {shape}, {site}")
                nbytes = x.numel() * 2 + k.payload.numel() + k.scales.numel()
                rows.append(timed(lambda x=x: mx_quant.mx_quantize_2d(x, fp4),
                                  lambda x=x: mx_quant.quantize_plain(x, fp4), nbytes,
                                  x.numel() * 20, f"{shape} bf16 -> fp4_e2m1_b32, {site}"))
            elif name == "mx_dequant":
                x, _ = codec_partials(torch, m, width, g, dev)
                c = mx_quant.mx_quantize_2d(x, fp4)
                check(same(mx_dequant.mx_dequantize_2d(c.payload, c.scales, fp4, torch.bfloat16),
                           mx_dequant.dequantize_plain(c, fp4, torch.bfloat16)),
                      f"mx_dequant differs from the plain version at {shape}, {site}")
                nbytes = c.payload.numel() + c.scales.numel() + m * width * 2
                rows.append(timed(
                    lambda c=c: mx_dequant.mx_dequantize_2d(c.payload, c.scales, fp4,
                                                            torch.bfloat16),
                    lambda c=c: mx_dequant.dequantize_plain(c, fp4, torch.bfloat16), nbytes,
                    m * width * 2, f"{shape} fp4_e2m1_b32 -> bf16, {site}"))
            else:
                x, _ = codec_partials(torch, TP * m, width, g, dev)
                c = mx_quant.mx_quantize_2d(x, fp4)
                w = MXCompressed(c.payload.reshape(TP, m, -1), c.scales.reshape(TP, m, -1))
                check(same(mx_dequant.dequant_reduce(w.payload, w.scales, fp4, torch.bfloat16),
                           mx_dequant.dequant_reduce_plain(w, fp4, torch.bfloat16)),
                      f"mx_dequant_reduce differs from the plain version at S={TP} x {shape}")
                nbytes = w.payload.numel() + w.scales.numel() + m * width * 2
                rows.append(timed(
                    lambda w=w: mx_dequant.dequant_reduce(w.payload, w.scales, fp4,
                                                          torch.bfloat16),
                    lambda w=w: mx_dequant.dequant_reduce_plain(w, fp4, torch.bfloat16), nbytes,
                    TP * m * width * 2, f"S={TP} x {shape} fp4_e2m1_b32 -> bf16, {site}"))
        out[name] = rows
    return out


POISON_ROWS, POISON_BLOCK = [7, 100, 259], 5   # a pool block of scale byte 255, in codec rows


def check_poisoned(torch, out, ref, rows, col, what):
    """A codec output with a poisoned block: the kernel's inf and NaN
    positions equal the plain version's, the poisoned block's 32 values are
    all non-finite, and every other value equals the plain version's."""
    for flag in (torch.isnan, torch.isinf):
        check(torch.equal(flag(out), flag(ref)), f"{what}: {flag.__name__} positions differ "
              f"from the plain version's")
    check(bool((~torch.isfinite(out[rows, col:col + 32])).all()),
          f"{what}: a poisoned block decoded to finite values")
    fin = torch.isfinite(ref)
    check(torch.equal(out[fin], ref[fin]), f"{what}: finite values differ")


# ------------------------------------------------------------- paged attention


def check_paged(torch, out, ref, what):
    """Hold the paged kernel's output against its plain version. bf16: both
    accumulate in fp32 and round to bf16 once, so each element may differ by
    one bf16 rounding of the reference, 2^-7 |ref|, plus 1e-4 for fp32
    summation order near zero; rel-L2 stays below 2e-3. fp32: summation
    order only, 1e-4 |ref| + 1e-5. Returns (max |err|, elements not equal,
    rel-L2)."""
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    rtol, atol = (2.0**-7, 1e-4) if out.dtype == torch.bfloat16 else (1e-4, 1e-5)
    over = int((d > rtol * r.abs() + atol).sum())
    rel = float((o - r).norm() / r.norm())
    err = float(d.max())
    check(math.isfinite(err) and over == 0 and rel <= 2e-3,
          f"paged_attention ({what}): {over} elements beyond {rtol:.3g} |ref| + {atol:.3g}, "
          f"max |err| {err}, rel-L2 {rel}")
    return err, int((d > 0).sum()), rel


def slot_rows(torch, dev, slot_tables, starts, segs=(), decodes=(), pads=()):
    """The paged read's row arguments for a mixed step laid out as
    ``build_mixed_batch`` does: prefill segments ``(slot, start, n)``, then
    decode rows ``(slot, position)``, then budget pads ``(slot, count)`` (a
    pad sits at position 0; a slot >= len(starts) is empty: null table, no
    history). Returns (tables, hist, q_pos, t_extra)."""
    from repro_torch.kernels.paged_attention import T_INVALID

    sid, pos, valid = [], [], []
    for slot, start, n in segs:
        sid += [slot] * n
        pos += list(range(start, start + n))
        valid += [True] * n
    for slot, p in decodes:
        sid, pos, valid = sid + [slot], pos + [p], valid + [True]
    for slot, n in pads:
        sid, pos, valid = sid + [slot] * n, pos + [0] * n, valid + [False] * n
    n_slots = len(starts)
    sid = torch.tensor(sid, device=dev)
    pos = torch.tensor(pos, device=dev, dtype=torch.int32)
    valid = torch.tensor(valid, device=dev)
    live = sid < n_slots
    own = sid.clamp(max=n_slots - 1)
    tables = torch.where(live[:, None], slot_tables[own], 0).to(torch.int32).contiguous()
    hist = torch.where(live, starts[own], 0).to(torch.int32).contiguous()
    same = (sid[None, :] == sid[:, None]) & valid[None, :]
    t_extra = torch.where(same, pos[None, :], T_INVALID).to(torch.int32).contiguous()
    return tables, hist, pos[:, None].contiguous(), t_extra


def paged_bound(torch, q, spec, kv_dim, tables, hist, qpos, t_extra, H, hd, window=None):
    """(bound ms, bound by, bytes) of one paged read on these inputs: each
    pool position some row may see (inside its window), once (rows that
    share a table share it), the extras some row may see, q, out, t_extra
    and the tables; the operations are 4*hd per valid (query head, key) pair
    at the bf16 rate."""
    per_pos = (kv_dim * 2 if spec is None
               else kv_dim * spec.elem.bits // 8 + kv_dim // spec.block_size)
    hi = torch.minimum(hist, qpos.max(1).values + 1).clamp(min=0)
    lo = ((qpos.min(1).values - window + 1).clamp(min=0) if window
          else torch.zeros_like(hi))
    seen = {}
    for tb, a, b in zip(tables.tolist(), lo.tolist(), hi.tolist()):
        if b > a:
            s0, s1 = seen.get(tuple(tb), (a, b))
            seen[tuple(tb)] = (min(s0, a), max(s1, b))
    t_hi = torch.minimum(hist[:, None], qpos + 1)
    t_lo = (qpos - window + 1).clamp(min=0) if window else torch.zeros_like(qpos)
    n_pairs = float((t_hi - t_lo).clamp(min=0).sum())
    nbytes = (2 * sum(b - a for a, b in seen.values()) * per_pos
              + 2 * q.numel() * q.element_size()
              + (tables.numel() + hist.numel() + qpos.numel()) * 4)
    if t_extra is not None:
        vis = t_extra[:, None, :] <= qpos[:, :, None]
        if window:
            vis &= t_extra[:, None, :] > qpos[:, :, None] - window
        n_pairs += float(vis.sum())
        nbytes += (2 * int(vis.any(1).any(0).sum()) * kv_dim * q.element_size()
                   + t_extra.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * n_pairs * hd * H, BF16_OPS_PER_S)
    return b_ms, b_by, nbytes


def paged_geometries(torch, dev, g, kv_dim, q_dim, prompt, new=NEW):
    """Pools of 4 slots of ``prompt + new`` positions at a family's width
    (bf16 and fp4_e2m1 from one set of random bf16 values) and the paged
    reads its served steps make over them: (geometries, pools, slot
    tables). ``prompt`` P: the mixed step holds slot 0's last 256-token
    chunk at P - 256 .. P - 1 over its history below P - 256, decode rows
    of slots 1-3 at P + 8, P + 18 and P + 28 and a pad of an empty slot;
    the split scheduler's decode one row per slot at histories max(P - 212,
    P / 2) .. P + 28; its chunk slot 0's last chunk with the chunk as 256
    extras (a prompt shorter than the chunk serves only the split decode)."""
    from repro_torch.core.formats import MXSpec
    from repro_torch.core.mx import MXCompressed
    from repro_torch.kernels import mx_quant

    fp4 = MXSpec.make("fp4_e2m1", 32, "e8m0")
    P = prompt
    max_blocks = (P + new) // BS
    n_blocks = SLOTS * max_blocks + 1
    slot_tables = torch.arange(1, n_blocks, device=dev, dtype=torch.int32).reshape(SLOTS, -1)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    dense_k, dense_v = randn(n_blocks, BS, kv_dim), randn(n_blocks, BS, kv_dim)
    wire = lambda x: MXCompressed(*(a.reshape(n_blocks, BS, -1) for a in
                                    mx_quant.mx_quantize_2d(x.reshape(-1, kv_dim), fp4)))
    pools = {"fp4": (wire(dense_k), wire(dense_v), fp4), "bf16": (dense_k, dense_v, None)}
    q, ke, ve = randn(T, 1, q_dim), randn(T, kv_dim), randn(T, kv_dim)
    i32 = lambda v: torch.tensor(v, device=dev, dtype=torch.int32)
    decoding = [(0, P + 8), (1, P + 15), (2, P + 21), (3, P + 28)]
    mixed_starts = i32([P - CHUNK, P + 8, P + 18, P + 28])
    dec_starts = i32([p for _, p in decoding])
    lengths = i32([max(P - 212, P // 2), P + 8, P + 18, P + 28])
    chunk_pos = torch.arange(P - CHUNK, P, device=dev, dtype=torch.int32)[None].contiguous()
    geometries = {  # name -> (q, (tables, hist, q_pos, t_extra), timed)
        # the compressed steps: a 256-token chunk + 3 decode rows, and a pad
        # of an empty slot (no valid key: the mean of every key it addresses)
        "mixed": (q, slot_rows(torch, dev, slot_tables, mixed_starts, [(0, P - CHUNK, CHUNK)],
                               [(1, P + 8), (2, P + 18), (3, P + 28)], [(SLOTS, 1)]), True),
        # the dense steps: 4 decode rows, then 256 budget pads owned by slot 0
        "decode_only": (q, slot_rows(torch, dev, slot_tables, dec_starts, (), decoding,
                                     [(0, T - SLOTS)]), True),
        # the same with the pads owned by an empty slot: a 256-row run over
        # five 64-row tiles with no valid key, held on the mean path
        "empty_pads": (q, slot_rows(torch, dev, slot_tables, dec_starts, (), decoding,
                                    [(SLOTS, T - SLOTS)]), False),
        # the split scheduler's decode: one row per slot, its token in the pool
        "decode": (q[:SLOTS].contiguous(), (slot_tables, (lengths + 1).contiguous(),
                                            lengths[:, None].contiguous(), None), True),
        # the split scheduler's chunk: slot 0's last 256-token chunk, its
        # history in its blocks, the chunk's own K/V as extras
        "chunk": (randn(1, CHUNK, q_dim), (slot_tables[:1].contiguous(), i32([P - CHUNK]),
                                           chunk_pos, chunk_pos), True),
    }
    return geometries, pools, slot_tables, (ke, ve)


def row_regions(torch, tables):
    """Sequence-sharded addressing of a geometry: (regions, row_map), the
    distinct table rows (one per slot: the blocks ``pool_exchange`` gathers
    into a virtual pool) and each row's region. Rows with equal tables share
    a region, so the kernel's runs are those of its table walk."""
    regions, inverse = torch.unique(tables, dim=0, return_inverse=True)
    return regions, inverse.to(torch.int32).contiguous()


def virtual_pool(pool, regions):
    """``pool[regions.reshape(-1)]``: what ``pool_exchange`` gives every kv
    rank (payload and scales of an MX pool)."""
    from repro_torch.core.mx import MXCompressed

    idx = regions.reshape(-1).long()
    if isinstance(pool, MXCompressed):
        return MXCompressed(pool.payload[idx].contiguous(), pool.scales[idx].contiguous())
    return pool[idx].contiguous()


def time_paged(torch, dev, res, label, geometries, pools, extras, H, KV, hd, window,
               timed_only=None, row_map=False):
    """Each geometry on each pool format: the kernel against its plain
    version, and for a timed geometry (of those in ``timed_only``, if given)
    its device time, the plain version's, SDPA's on the K/V
    gathered to dense bf16 (GQA by ``enable_gqa``; the gather not timed; the
    port never calls it) and its bound. ``row_map``: the sequence-sharded
    read (the TPU kernel's ``has_row_map``), over the virtual pool of the
    geometry's regions (``row_regions``), held bit for bit to the table
    walk over the original pool as well. Results go to ``res[label + geo /
    pools (/row_map)]``."""
    from repro_torch.kernels import paged_attention as pa

    ke, ve = extras
    kw = dict(kv_heads=KV, scale=hd**-0.5, window=window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for geo, (qq, (tables, hist, qpos, t_extra), timed) in geometries.items():
        timed = timed and (timed_only is None or geo in timed_only)
        R, Sq = qpos.shape
        E = t_extra.shape[1] if t_extra is not None else 0
        ex = (ke[:E], ve[:E], t_extra) if E else ()
        for name, (pk, pv, spec) in pools.items():
            rkw, rows = {}, tables
            if row_map:
                walk = pa.paged_attention(qq, pk, pv, tables, hist, qpos, *ex, spec=spec, **kw)
                regions, rm = row_regions(torch, tables)
                pk, pv = virtual_pool(pk, regions), virtual_pool(pv, regions)
                rkw, rows = dict(row_map=rm), pa.block_rows(tables, rm)
            args = (qq, pk, pv, tables, hist, qpos, *ex)
            run = lambda: pa.paged_attention(*args, spec=spec, **kw, **rkw)
            out = run()
            ref = pa.paged_attention_plain(*args, spec=spec, **kw, **rkw)
            where = f"{label}{geo} R={R} Sq={Sq} H={H} KV={KV} hd={hd} E={E}" + (
                f" window={window}" if window else "") + (" row_map" if row_map else "")
            err, n_diff, rel = check_paged(torch, out, ref, f"{name} pools, {where}")
            r = dict(geometry=label + geo, pools=name, max_abs_err=err, rel_l2=rel,
                     elements_differing=n_diff, shape=f"{where}, {name} pools")
            msg = (f"kernel paged_attention ({name} pools, {where}): max|err| {err:.3g}, "
                   f"rel-L2 {rel:.3g}, {n_diff} of {out.numel()} elements differ")
            if row_map:
                check(torch.equal(out, walk), f"paged_attention ({name} pools, {where}): the "
                      f"row_map read differs from the table walk in "
                      f"{int((out != walk).sum())} elements")
                r["row_map"] = True
                r["geometry"] += " row_map"
                msg += f"; bit-identical to the table walk over {regions.shape[0]} regions"
            if timed:
                r["ms"] = device_ms(torch, run)
                r["plain_ms"] = device_ms(torch, lambda: pa.paged_attention_plain(
                    *args, spec=spec, **kw, **rkw), n=3)
                kg = pa._gather_pool(pk, rows, spec).to(torch.bfloat16)
                vg = pa._gather_pool(pv, rows, spec).to(torch.bfloat16)
                cap = kg.shape[1]
                t = torch.arange(cap, device=dev)[None]
                tpos = torch.where(t < hist[:, None], t, pa.T_INVALID)
                if E:
                    kg = torch.cat([kg, ke[:E][None].expand(R, -1, -1)], 1)
                    vg = torch.cat([vg, ve[:E][None].expand(R, -1, -1)], 1)
                    tpos = torch.cat([tpos, t_extra], 1)
                mask = tpos[:, None, :] <= qpos[:, :, None]             # (R, Sq, keys)
                if window:
                    mask &= tpos[:, None, :] > qpos[:, :, None] - window
                mask[~mask.any(-1)] = True           # SDPA gives NaN on a row with no key
                kk = kg.reshape(R, -1, KV, hd).transpose(1, 2)
                vv = vg.reshape(R, -1, KV, hd).transpose(1, 2)
                qh = qq.reshape(R, Sq, H, hd).transpose(1, 2)
                m4 = mask[:, None]
                r["library_ms"] = device_ms(torch, lambda: sdpa(
                    qh, kk, vv, attn_mask=m4, scale=hd**-0.5, enable_gqa=KV != H), n=10)
                del kg, vg, kk, vv
                r["bound_ms"], r["bound_by"], r["bytes"] = paged_bound(
                    torch, qq, spec, KV * hd, rows, hist, qpos, t_extra, H, hd, window)
                msg += (f"; {r['ms']:.4f} ms on the device (plain {r['plain_ms']:.4f} ms, "
                        f"SDPA on gathered K/V "
                        f"{r['library_ms']:.4f} ms), {r['bytes'] / 1e6:.2f} MB, bound "
                        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            res[f"{label}{geo}/{name}" + ("/row_map" if row_map else "")] = r
            log(msg)


def phase_paged(torch, dev="cuda"):
    """Paged attention at llama2-7b width (H = KV = 32, hd = 128) in the
    geometries the served steps run, over bf16 and fp4 pools, also over a
    poisoned block; every served geometry of the new families (``FAMILIES``:
    G = 7 and 8 at hd 128, G = 2 at hd 256 with the 1024 window and
    without), their mixed step and split decode timed; and a sweep of small
    shapes through every path of the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    H = KV = 32
    hd = D // H
    geometries, pools, slot_tables, (ke, ve) = paged_geometries(torch, dev, g, D, D, PROMPT)
    kw = dict(kv_heads=KV, scale=hd**-0.5)
    res = {}
    time_paged(torch, dev, res, "", geometries, pools, (ke, ve), H, KV, hd, None)
    # the sequence-sharded read (row_map) in every served geometry
    time_paged(torch, dev, res, "", geometries, pools, (ke, ve), H, KV, hd, None,
               timed_only=("mixed", "decode"), row_map=True)
    # poisoned pools: one block of scale bytes 255 (fp4) or NaN values (bf16)
    # in every served geometry; the rows whose history reaches it must come
    # out non-finite in the kernel and in the plain version, and no other
    poison = {"mixed": (0, 3, 2, 5), "decode_only": (0, 0, 1, 5), "empty_pads": (1, 5),
              "decode": (3, 5), "chunk": (0, 2)}   # (slot, block of its table) pairs
    n_poison = 0
    for geo, pairs in poison.items():
        qq, (tables, hist, qpos, t_extra), _ = geometries[geo]
        E = t_extra.shape[1] if t_extra is not None else 0
        extras = (ke[:E], ve[:E], t_extra) if E else ()
        for slot, j in zip(pairs[::2], pairs[1::2]):
            blk = int(slot_tables[slot, j])
            reach = reaching_rows(torch, tables, hist, qpos, blk, BS)
            for name, (pk, pv, spec) in pools.items():
                bk, bv = poisoned_pool(torch, pk, blk), poisoned_pool(torch, pv, blk)
                args = (qq, bk, bv, tables, hist, qpos, *extras)
                out = pa.paged_attention(*args, spec=spec, **kw)
                ref = pa.paged_attention_plain(*args, spec=spec, **kw)
                bad_k, bad_p = ~torch.isfinite(out).all(-1), ~torch.isfinite(ref).all(-1)
                what = f"poisoned block {blk} (slot {slot}), {name} pools, {geo}"
                check(torch.equal(bad_k, bad_p), f"paged_attention ({what}): the kernel's "
                      f"non-finite rows {int(bad_k.sum())} differ from the plain version's "
                      f"{int(bad_p.sum())}")
                check(torch.equal(bad_k, reach), f"paged_attention ({what}): non-finite rows "
                      f"{int(bad_k.sum())} are not the {int(reach.sum())} rows that reach it")
                if not bad_k.all():
                    check_paged(torch, out[~bad_k], ref[~bad_k], what)
                n_poison += 1
                log(f"kernel paged_attention ({what}): non-finite in the {int(reach.sum())} of "
                    f"{reach.numel()} query rows that reach the block, as the plain version"
                    + ("" if bad_k.all() else "; the other rows within the check"))
    del geometries, pools
    # the new families' served reads at their prompt lengths, each geometry
    # under every window their layers run (gemma3: 1024 and global); the
    # mixed step and the split decode timed. A family that serves only some
    # geometries (jamba: the split decode) is held and timed on those, and
    # not on the sequence-sharded read it does not serve
    for arch, plan in FAMILIES.items():
        cfg = get_config(arch)
        if not attn_layers(cfg):   # no paged read (xlstm-125m)
            continue
        geos, fpools, _, fextras = paged_geometries(torch, dev, g, cfg.kv_dim, cfg.q_dim,
                                                    n_prefix(cfg) + plan["prompt"],
                                                    plan.get("new", NEW))
        if "geometries" in plan:
            geos = {k: v for k, v in geos.items() if k in plan["geometries"]}
        windows = sorted({sp.window for sp in cfg.layers if sp.kind == "attn"},
                         key=lambda w: w is None)
        for window in windows:
            label = f"{arch} " if window == windows[0] else f"{arch} global "
            for rm in (False, True) if "geometries" not in plan else (False,):
                time_paged(torch, dev, res, label, geos, fpools, fextras, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, window,
                           timed_only=("mixed", "decode") if window == windows[0] else (),
                           row_map=rm)
        del geos, fpools
    # one TP rank's heads (llama2-7b on 2 ranks: 16; llama2-13b on 4: 10) in
    # the served geometries at phase 5's prompt length, mixed and split
    # decode timed
    for label, heads in (("llama2-7b TP2 ", 16), ("llama2-13b TP4 ", 10)):
        geos, tpools, _, textras = paged_geometries(torch, dev, g, heads * hd, heads * hd,
                                                    PROMPT)
        time_paged(torch, dev, res, label, geos, tpools, textras, heads, heads, hd, None,
                   timed_only=("mixed", "decode"))
        if heads == 16:   # the sequence-sharded read of a kv x model rank (the kvtp phase)
            time_paged(torch, dev, res, label, geos, tpools, textras, heads, heads, hd, None,
                       timed_only=("mixed", "decode"), row_map=True)
        del geos, tpools
    # one rank of mixtral-8x22b's kv 2 x data 2 x model 2 grid (the kvtp
    # phase's --phase kvtp grid): its model rank's 24 query heads over 4 kv
    # heads (G 6, hd 128) under the 4096 window, at phase 5's prompt length;
    # the table walk and the sequence-sharded read, mixed and split decode
    # timed
    rank = get_config("mixtral-8x22b").tp_shard(2)
    window = next(sp.window for sp in rank.layers if sp.kind == "attn")
    geos, tpools, _, textras = paged_geometries(torch, dev, g, rank.kv_dim, rank.q_dim, PROMPT)
    for rm in (False, True):
        time_paged(torch, dev, res, "mixtral-8x22b kv2 x data2 x model2 ", geos, tpools, textras,
                   rank.n_heads, rank.n_kv_heads, rank.head_dim, window,
                   timed_only=("mixed", "decode"), row_map=rm)
    del geos, tpools
    # one TP rank's heads of the whole-prompt families on 2 ranks, in their
    # only paged read, the split decode, at the TP phase's prompt length
    # (SHARD_PROMPT text tokens after pixtral's 256 patches; the decode rows'
    # histories reach 28 past it): pixtral KV 4 / G 4 / hd 128, whisper's
    # decoder KV 8 / G 1 / hd 64
    for arch in ("pixtral-12b", "whisper-medium"):
        rank = get_config(arch).tp_shard(2)
        geos, tpools, _, textras = paged_geometries(
            torch, dev, g, rank.kv_dim, rank.q_dim, n_prefix(rank) + SHARD_PROMPT)
        time_paged(torch, dev, res, f"{arch} TP2 ", {"decode": geos["decode"]}, tpools, textras,
                   rank.n_heads, rank.n_kv_heads, rank.head_dim, None)
        del geos, tpools
    n_sweep = paged_sweep(torch, dev)
    log(f"kernel paged_attention: {n_sweep} small-shape cases through every path match "
        f"the plain version (fp32 / bf16 q; fp32, bf16, fp4, fp6, int8 pools; hd 32-128 at "
        f"G 1-2, hd 128 at G 7-8, hd 192 and 256 at G 1-2; windows; chunk, decode and "
        f"multi-run mixed geometries)")
    n_rm = sum(1 for r in res.values() if r.get("row_map"))
    log(f"kernel paged_attention (row_map): {n_rm} served cases (llama2-7b and the families, "
        f"every geometry and window, fp4 and bf16 pools) bit-identical to the table walk and "
        f"within the check of the plain version")
    main = dict(res["mixed/fp4"])
    main["geometries"] = [res[k] for k in res if k != "mixed/fp4"]
    main["sweep_cases"] = n_sweep
    main["poisoned_cases"] = n_poison
    return {"paged_attention": main}


def poisoned_pool(torch, pool, blk):
    """A copy of ``pool`` with block ``blk`` poisoned as the engine's
    corrupt fault does: scale bytes 255 in an MX pool, NaN in a dense one."""
    from repro_torch.core.mx import MXCompressed

    if isinstance(pool, MXCompressed):
        scales = pool.scales.clone()
        scales[blk] = 255
        return MXCompressed(pool.payload, scales)
    out = pool.clone()
    out[blk] = float("nan")
    return out


def reaching_rows(torch, tables, hist, qpos, blk, bs):
    """(R, Sq) bool: the queries whose history reaches pool block ``blk``
    (a position of it in the row's table below ``hist`` and at or before
    the query's position)."""
    t = torch.arange(tables.shape[1] * bs, device=tables.device)
    seen = (tables[:, t // bs] == blk) & (t[None] < hist[:, None])
    first = torch.where(seen, t[None], 2**30).min(1).values
    return qpos >= first[:, None]


# The sweep's head geometries: (head dims, GQA groups, windows of the chunk
# and decode geometries); the mixed geometry runs without and with a window
SWEEP = (((32, 64, 96, 128), (1, 2), (None,)),
         ((128,), (7, 8), (None, 24)),
         ((192, 256), (1, 2), (None, 24)))


def paged_sweep(torch, dev):
    """Small shapes through every path of the paged kernel, each against its
    plain version: fp32 q (CUDA-core block and vector paths) and bf16 q
    (tensor-core block path, vector path; CUDA cores over fp32 pools), dense
    and MX pools (fp4 and fp6 at block 32, int8 at block 16), at the head
    geometries of ``SWEEP`` (hd 32..256 and G 1, 2, 7, 8: at G = 7 a row's
    query vectors straddle the kernel's 64-vector tiles), with and without a
    window, in a mixed geometry whose runs cross 64-row tiles (two prefill
    segments, decode rows, pads of an empty slot and of a live one), a chunk
    geometry (Sq = 40) and a decode geometry. Returns the number of cases."""
    from repro_torch.core.formats import MXSpec
    from repro_torch.core.mx import MXCompressed
    from repro_torch.kernels import mx_quant
    from repro_torch.kernels import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(1)
    bs, nb, n_slots, KV = 16, 8, 4, 2
    n_blocks = n_slots * nb + 1
    slot_tables = torch.arange(1, n_blocks, device=dev, dtype=torch.int32).reshape(n_slots, nb)
    starts = torch.tensor([37, 50, 60, 45], device=dev, dtype=torch.int32)
    mixed = slot_rows(torch, dev, slot_tables, starts, [(0, 37, 70), (1, 50, 20)],
                      [(2, 60), (3, 45)], [(n_slots, 40), (0, 12)])
    cpos = torch.arange(37, 77, device=dev, dtype=torch.int32)[None]
    chunk = (slot_tables[:1].contiguous(), starts[:1].contiguous(), cpos.contiguous(),
             cpos.contiguous())
    lengths = torch.tensor([37, 52, 90], device=dev, dtype=torch.int32)
    decode = (slot_tables[:3].contiguous(), (lengths + 1).contiguous(),
              lengths[:, None].contiguous(), None)
    pool_fmts = {"f32": None, "bf16": None, "fp4": MXSpec.make("fp4_e2m1", 32, "e8m0"),
                 "fp6": MXSpec.make("fp6_e3m2", 32, "e8m0"), "int8": MXSpec.make("int8", 16, "e8m0")}
    combos = [(torch.float32, "f32"), (torch.float32, "bf16"), (torch.float32, "fp4"),
              (torch.bfloat16, "bf16"), (torch.bfloat16, "f32"), (torch.bfloat16, "fp4"),
              (torch.bfloat16, "fp6"), (torch.bfloat16, "int8")]
    n = 0
    for hds, groups, windows in SWEEP:
        for hd in hds:
            kv_dim = KV * hd
            raw_k = torch.randn(n_blocks, bs, kv_dim, generator=g, device=dev)
            raw_v = torch.randn(n_blocks, bs, kv_dim, generator=g, device=dev)
            for dt, fmt in combos:
                spec = pool_fmts[fmt]
                if spec is not None:
                    pk, pv = (MXCompressed(*(a.reshape(n_blocks, bs, -1) for a in
                                             mx_quant.mx_quantize_2d(p.reshape(-1, kv_dim),
                                                                     spec)))
                              for p in (raw_k, raw_v))
                else:
                    cast = torch.float32 if fmt == "f32" else torch.bfloat16
                    pk, pv = raw_k.to(cast), raw_v.to(cast)
                for G in groups:
                    for geo, (tables, hist, qpos, t_extra), wins in (
                            ("mixed", mixed, (None, 24)), ("chunk", chunk, windows),
                            ("decode", decode, windows)):
                        R, Sq = qpos.shape
                        q = torch.randn(R, Sq, KV * G * hd, generator=g, device=dev).to(dt)
                        extras = ()
                        if t_extra is not None:
                            E = t_extra.shape[1]
                            extras = (torch.randn(E, kv_dim, generator=g, device=dev).to(dt),
                                      torch.randn(E, kv_dim, generator=g, device=dev).to(dt),
                                      t_extra)
                        for window in wins:
                            args = (q, pk, pv, tables, hist, qpos, *extras)
                            kw = dict(spec=spec, kv_heads=KV, scale=hd**-0.5, window=window)
                            check_paged(torch, pa.paged_attention(*args, **kw),
                                        pa.paged_attention_plain(*args, **kw),
                                        f"sweep {geo} q {dt} {fmt} pools hd {hd} G {G} "
                                        f"window {window}")
                            n += 1
    return n


# ------------------------------------------------------------------- reference


def phase_reference(torch, dev="cuda"):
    """Reduced llama2 (fp32) on the card vs on the CPU (plain versions)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.formats import KVCacheSpec
    from repro_torch.core.policy import PAPER_DEFAULT
    from repro_torch.core.tp import TPContext
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine, Request, build_mixed_batch, init_paged_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config(get_config("llama2-7b")), dtype="float32")
    model = Model(cfg)
    cpu = model.init_params(device="cpu", seed=1)
    gpu = _tree_to(cpu, torch.device(dev))

    parity = [(((np.arange(5 + 9 * i) * 11 + i) % cfg.vocab_size).astype(np.int32), 4 + i)
              for i in range(4)]
    dup = ((np.arange(32) * 7) % cfg.vocab_size).astype(np.int32)
    evict = [(np.arange(20, dtype=np.int32), 30)] * 2
    base = dict(max_slots=2, max_len=64, block_size=16, cache_dtype=torch.float32,
                cache_spec="bf16")
    cases = {  # name -> (engine options, traffic); dense fp32 pools throughout
        "mixed": (dict(prefill_chunk=16, token_budget=18), parity),
        "split": (dict(prefill_chunk=16, token_budget=0), parity),
        "whole-prompt": (dict(prefill_chunk=0), parity),
        "prefix COW": (dict(max_slots=1, prefill_chunk=32, prefix_cache=True), [(dup, 5)] * 3),
        "evict mixed": (dict(prefill_chunk=8, n_blocks=7), evict),
        "evict split": (dict(prefill_chunk=8, token_budget=0, n_blocks=7), evict),
    }
    for case, (opts, traffic) in cases.items():
        outs, stats = {}, {}
        for name, params in (("cpu", cpu), ("card", gpu)):
            eng = Engine(model, params, TPContext(), device=params["embed"]["w"].device,
                         **{**base, **opts})
            reqs = eng.run([Request(prompt=p.copy(), max_new_tokens=n) for p, n in traffic])
            outs[name] = [r.output.tolist() for r in reqs]
            s = eng.stats.summary()
            stats[name] = (s["n_steps"], s["n_dispatches"], s["n_preemptions"],
                           s["prefill_tokens_skipped"])
        check(outs["cpu"] == outs["card"],
              f"{case}: greedy tokens differ card vs CPU: {outs['card']} vs {outs['cpu']}")
        check(stats["cpu"] == stats["card"], f"{case}: steps, dispatches, preemptions, "
              f"skipped tokens differ card vs CPU: {stats['card']} vs {stats['cpu']}")
        if case == "prefix COW":
            check(stats["card"][3] == 62, f"prefix COW: {stats['card'][3]} tokens skipped")
        if case.startswith("evict"):
            check(stats["card"][2] >= 1, f"{case}: no preemption")
        log(f"reference[{case}]: reduced llama2 fp32 greedy tokens identical card vs CPU "
            f"({sum(map(len, outs['cpu']))} tokens); steps, dispatches, preemptions, "
            f"skipped tokens {stats['card']} on both")

    reference_faults(torch, model, cpu, gpu, parity, base)
    reference_families(torch, dev, base)

    # one compressed mixed step on fp4 pools, card vs CPU
    ctx = TPContext(policy=PAPER_DEFAULT, simulate_tp=4)
    batch = build_mixed_batch([(0, np.arange(20, dtype=np.int32) % cfg.vocab_size, 0)],
                              [(1, 7, 5)], 24, 2)
    spec = KVCacheSpec.parse("fp4_e2m1")
    logits = {}
    for name, params in (("cpu", cpu), ("card", gpu)):
        d = params["embed"]["w"].device
        state = init_paged_state(cfg, 2, 9, 16, torch.float32, cache_spec=spec, device=d)
        t = lambda a: torch.tensor(a, device=d)
        lg, _ = model.mixed_step(ctx, params, t(batch.tokens), state, t(batch.slot_ids),
                                 t(batch.positions), t(batch.valid), t(batch.is_decode),
                                 t(np.array([0, 5], np.int32)),
                                 t(np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)),
                                 t(batch.sample_idx), cache_spec=spec)
        logits[name] = lg.float().cpu()
    rel = float((logits["card"] - logits["cpu"]).norm() / logits["cpu"].norm())
    check(math.isfinite(rel) and rel <= 1e-3,
          f"compressed mixed-step logits card vs CPU rel-L2 {rel} > 1e-3")
    log(f"reference: compressed (simulate_tp=4, fp4 pools) mixed-step logits card vs CPU "
        f"rel-L2 {rel:.3g} <= 1e-3")


# reduced_config caps heads at 4 and head_dim at 32; these keep each new
# family's GQA group and head_dim in its reduced config
FAMILY_REDUCED = {"qwen2-7b": dict(n_heads=7, n_kv_heads=1),
                  "qwen3-32b": dict(n_heads=8, n_kv_heads=1),
                  "gemma3-4b": dict(n_heads=2, n_kv_heads=1, head_dim=256),
                  "mixtral-8x22b": dict(n_heads=6, n_kv_heads=1),
                  "llama4-maverick-400b-a17b": dict(n_heads=5, n_kv_heads=1),
                  "jamba-v0.1-52b": {},
                  "pixtral-12b": dict(n_heads=4, n_kv_heads=1),
                  "whisper-medium": {},
                  "xlstm-125m": {}}
# reduced jamba keeps one layer of each kind of its schedule: Mamba, Mamba +
# MoE, attention (reduced_config's default 2 layers hold no attention layer)
REDUCED_LAYERS = {"jamba-v0.1-52b": 3}
MOE_BUDGET = 80   # the reduced MoE runs' token budget: above 64, so the mixed step dispatches


def reference_families(torch, dev, base):
    """Each new family's reduced config (its group and head_dim kept: G 7,
    8 at hd 32, G 2 at hd 256 with a 32-token window, mixtral G 6 and
    llama4 G 5 at hd 32 with 4 experts; fp32) on the card vs on the CPU: the
    mixed step on dense fp32 and fp4 pools, and the split scheduler, over
    prompts of 5 to 48 tokens (two longer than the window); a MoE family's
    mixed step also over a MOE_BUDGET-token budget (the sort-based dispatch;
    the 18-token budget runs every expert on every token) on both pools;
    a recurrent stack (jamba: Mamba, Mamba + MoE, attention; xlstm: mLSTM,
    sLSTM) whole-prompt at exact lengths on dense fp32 and fp4 pools, and
    through a preemption;
    pixtral (G 4, a 16-patch prefix) and whisper (2 encoder layers over 64
    frames) whole-prompt on dense fp32 and fp4 pools and through a
    preemption, on random stand-in extra inputs (the same host arrays for
    both): greedy tokens, steps and dispatches identical."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.tp import TPContext
    from repro_torch.models.model import Model, recurrent_layer
    from repro_torch.serving import Engine, Request

    for arch, over in FAMILY_REDUCED.items():
        cfg = dataclasses.replace(reduced_config(get_config(arch),
                                                 n_layers=REDUCED_LAYERS.get(arch, 2)),
                                  dtype="float32", **over)
        model = Model(cfg)
        cpu = model.init_params(device="cpu", seed=1)
        gpu = _tree_to(cpu, torch.device(dev))
        traffic = [(((np.arange(n) * 11 + i) % cfg.vocab_size).astype(np.int32), 4 + i)
                   for i, n in enumerate((5, 14, 40, 48))]
        cases = [("mixed", dict(prefill_chunk=16, token_budget=18)),
                 ("mixed fp4", dict(prefill_chunk=16, token_budget=18, cache_spec="fp4_e2m1")),
                 ("split", dict(prefill_chunk=16, token_budget=0))]
        extra = stubs(cfg, len(traffic))
        if recurrent_layer(cfg) is not None:   # whole-prompt only, at exact lengths
            cases = [("whole", {}), ("whole fp4", dict(cache_spec="fp4_e2m1")),
                     ("whole evict", dict(n_blocks=4))]
        elif extra:   # whole-prompt only; a prefix or encoder needs room beside the text
            cases = [("whole", dict(max_len=96)),
                     ("whole fp4", dict(max_len=96, cache_spec="fp4_e2m1")),
                     # a vision prefix holds a block of its own in each slot
                     ("whole evict", dict(max_len=96, n_blocks=4 + -(-n_prefix(cfg) // 16)))]
        elif moe_layers(cfg):
            cases += [(f"mixed dispatch{fp4}", dict(prefill_chunk=16, token_budget=MOE_BUDGET,
                                                    **({"cache_spec": "fp4_e2m1"} if fp4 else {})))
                      for fp4 in ("", " fp4")]
        # two 12-token prompts on 3 usable blocks: both cross 16 tokens, the
        # later one is preempted and re-prefilled at its new exact length
        evict = [(((np.arange(12) * 5 + i) % cfg.vocab_size).astype(np.int32), 8)
                 for i in range(2)]
        for case, opts in cases:
            seen = {}
            reqs_of = evict if case.endswith("evict") else traffic
            for name, params in (("cpu", cpu), ("card", gpu)):
                eng = Engine(model, params, TPContext(), device=params["embed"]["w"].device,
                             **{**base, **opts})
                reqs = eng.run([Request(prompt=p.copy(), max_new_tokens=n) for p, n in reqs_of],
                               extra_inputs=first_rows(extra, len(reqs_of)))
                s = eng.stats.summary()
                seen[name] = ([r.output.tolist() for r in reqs], s["n_steps"], s["n_dispatches"],
                              s["n_preemptions"])
            check(seen["cpu"] == seen["card"],
                  f"reference[{arch} {case}]: card and CPU differ: {seen['card']} vs "
                  f"{seen['cpu']}")
            if case == "whole evict":
                check(seen["card"][3] >= 1, f"reference[{arch} {case}]: no preemption")
            log(f"reference[{arch} {case}]: reduced {arch} (G {cfg.n_heads // cfg.n_kv_heads}, "
                f"hd {cfg.head_dim}, windows {[sp.window for sp in cfg.layers]}"
                + (f", {moe_layers(cfg)} MoE layers of {cfg.n_experts} experts top-{cfg.top_k}"
                   if moe_layers(cfg) else "")
                + (f", layers {[sp.kind for sp in cfg.layers]}, d_inner {cfg.ssm_d_inner}"
                   if mamba_layers(cfg) else "")
                + (f", layers {[sp.kind for sp in cfg.layers]}, mLSTM d_inner "
                   f"{cfg.mlstm_d_inner}, sLSTM FF {cfg.slstm_ff}" if mlstm_layers(cfg) else "")
                + (f", {cfg.n_patches} patches" if cfg.frontend == "vision" else "")
                + (f", {cfg.n_encoder_layers} encoder layers over {cfg.encoder_seq} frames"
                   if cfg.encoder_decoder else "") + ") fp32 greedy "
                f"tokens identical card vs CPU ({sum(map(len, seen['cpu'][0]))} tokens); "
                f"{seen['card'][1]} steps, {seen['card'][2]} dispatches, {seen['card'][3]} "
                f"preemptions on both")


def reference_faults(torch, model, cpu, gpu, parity, base):
    """The reduced model under faults, supervised, on the card and on the CPU
    (mixed step, chunk 16): engine death, pool corruption on fp4 and on dense
    fp32 pools, 6 of the 8 blocks held for 3 steps, a stuck step on a
    persistent prefix cache (warm recovery), bounded admission and an
    ``eos_id`` stop. Tokens, outcomes, recovery events (error, mode,
    replayed), the step the corruption watch fires at, and the merged steps
    and dispatches must be identical."""
    import re

    from repro_torch.core.tp import TPContext
    from repro_torch.serving import Engine, EngineSupervisor, FaultPlan, Request

    mixed = dict(base, prefill_chunk=16, token_budget=18)
    cases = {  # name -> (engine options, fault plan, per-request options)
        "die@3": (mixed, "die@3", None),
        "corrupt@3 fp4": (dict(mixed, cache_spec="fp4_e2m1"), "corrupt@3", None),
        "corrupt@3 fp32": (mixed, "corrupt@3", None),
        "exhaust@2:6x3": (mixed, "exhaust@2:6x3", None),
        "stuck@4 warm": (dict(mixed, prefix_cache=True, persistent_cache=True,
                              step_timeout_s=2.0), "stuck@4", None),
        "max_queue=1": (dict(mixed, max_queue=1), None, None),
        "eos_id": (mixed, None, "eos"),
    }
    eos = None
    for case, (opts, plan, req_kw) in cases.items():
        seen = {}
        for name, params in (("cpu", cpu), ("card", gpu)):
            eng = Engine(model, params, TPContext(), device=params["embed"]["w"].device,
                         fault_plan=FaultPlan.parse(plan) if plan else None, **opts)
            # one run with the plan and the watchdog off first: first launches
            # (and cuBLAS set-up on the card) stay out of the measured run
            held = eng.fault_plan, eng.step_timeout_s
            eng.fault_plan = eng.step_timeout_s = None
            eng.run([Request(prompt=parity[0][0][:4].copy(), max_new_tokens=2)])
            eng.fault_plan, eng.step_timeout_s = held
            kw = [dict(eos_id=eos)] + [{}] * (len(parity) - 1) if req_kw else [{}] * len(parity)
            reqs = [Request(prompt=p.copy(), max_new_tokens=n, **k)
                    for (p, n), k in zip(parity, kw)]
            sup = EngineSupervisor(eng, backoff_s=0.0)
            sup.run(reqs)
            a = eng.allocator
            check(a.n_held == 0 and a.n_allocated == 0
                  and a.n_free + a.n_cached == eng.n_blocks - 1,
                  f"reference[{case}] on the {name}: free list not conserved")
            steps = [re.search(r"\(step (\d+)\)", e.detail) for e in sup.events]
            seen[name] = dict(
                outputs=[r.output.tolist() for r in reqs], outcomes=[r.outcome for r in reqs],
                events=[(e.error, e.mode, e.n_replayed) for e in sup.events],
                watch_steps=[int(m.group(1)) for m in steps if m],
                counts=(sup.stats.n_steps, sup.stats.n_dispatches))
        check(seen["cpu"] == seen["card"],
              f"reference[{case}]: card and CPU differ: {seen['card']} vs {seen['cpu']}")
        got = seen["card"]
        planned = {"die@3": ["EngineDead"], "corrupt@3 fp4": ["WireCorruption"],
                   "corrupt@3 fp32": ["WireCorruption"], "stuck@4 warm": ["StepStuck"]}
        check([e[0] for e in got["events"]] == planned.get(case, []),
              f"reference[{case}]: recovery events {got['events']}")
        check(case != "stuck@4 warm" or got["events"][0][1] == "warm",
              f"reference[{case}]: recovery not warm")
        want = {"max_queue=1": ["ok"] * 3 + ["rejected"]}.get(case, ["ok"] * 4)
        check(sorted(got["outcomes"]) == want, f"reference[{case}]: outcomes {got['outcomes']}")
        if case == "die@3":   # replayed, so the fault-free tokens: eos_id = request 0's 3rd
            free0 = got["outputs"][0]
            eos = free0[2]
        if case == "eos_id":
            stop = free0.index(eos) + 1
            check(got["outputs"][0] == free0[:stop],
                  f"reference[eos_id]: request 0 gave {got['outputs'][0]}, not {free0[:stop]}")
        log(f"reference[{case}]: reduced llama2 fp32, supervised, identical card vs CPU: "
            f"outcomes {got['outcomes']}, recoveries {got['events']}, watch fired at step(s) "
            f"{got['watch_steps']}, {got['counts'][0]} steps / {got['counts'][1]} dispatches "
            f"merged over the attempts")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ----------------------------------------------------------------------- serve


def expected_launches(eng, stats, n_layers: int) -> dict:
    """Kernel launches of one served run, derived from its ``ServeStats``
    (``eng.stats`` of one ``Engine.run``; a supervisor's merged ``stats``
    over its attempts: a ``die`` fault raises before its step dispatches,
    and the corruption watch raises after the mixed step has launched and
    recorded it, so an aborted attempt's stats cover exactly its launches).
    Per layer, each compressed row-parallel reduction (``row_reductions``:
    ``wo`` (a Mamba layer's ``out_proj``) and the MLP's ``down``, or on a
    MoE layer ``wo`` (``out_proj``) and each shared expert's ``down``; the
    routed experts are never compressed, as in the reference outside its
    expert-parallel island; an encoder-decoder's cross-attention ``wo``
    per decoder layer, and its encoder layers' ``wo`` and ``down`` in a
    prefill) is one ``mx_quant`` + one ``mx_dequant_reduce``;
    per attention layer (``attn_layers``; a Mamba layer reads no pool) a
    paged step (mixed, chunk or decode) is one ``paged_attention``, fp4
    pools add one ``mx_quant`` each for K and V per write (step append,
    whole-prompt insert) and, in the mixed step only, one ``mx_dequant``
    each for the decode round trip. Under the ``two_phase`` variant each compressed
    reduction adds one ``mx_quant`` and one ``mx_dequant`` (the second
    quantize of the reduced result). The mixed step compresses under its
    compressed gate; the split chunk and the whole-prompt prefill under the
    engine's context, the split decode under ``ctx_decode``. A COW fork
    launches nothing, and a layer's window changes no count. On a TP group
    (``eng.tp_size > 1``) the gather variant's reduction quantizes and
    reduces each of its ``overlap_chunks`` chunks apart (two_phase launches
    what the simulated two_phase does), and the count also holds the
    group's collectives: ``tp_all_gather`` (payload and scales of each
    chunk, or of the reduced slice under two_phase), ``tp_all_to_all``
    (two_phase's payload and scales) and ``tp_all_reduce`` (one per dense
    reduction: each row-parallel layer of a dense step; one per MoE layer
    per forward pass for its routed experts, compressed or not; one per
    Mamba layer per pass for its ``x_proj`` partial and one per mLSTM layer
    per pass for its q/k/v/i/f partial) and
    ``tp_dense_all_gather`` (a vision model's prefix, one a whole-prompt
    prefill). On sequence-sharded
    pools (``eng.kv_shards > 1``) the count also holds ``all_reduce``, the
    exchange's: per paged read and per COW fork one for each pool plane of
    each attention layer (K and V; payload and scales of each on fp4
    pools). On a ``data x model`` grid (``eng.dp_size > 1``) a split decode
    step whose slot width meets the island gate (``moe.uses_island``) runs
    the expert-parallel island in each MoE layer: under ``ctx_decode``'s
    policy its ``down`` reduction is one more compressed reduction (one
    ``mx_quant`` + one ``mx_dequant_reduce`` per chunk, two all-gathers
    per chunk) or one dense all-reduce, and under ``compress_all_to_all``
    its two all-to-alls add two ``mx_quant`` and two ``mx_dequant``; any
    other pass of a MoE layer whose data rank holds a share of the experts
    sums their partials with two dense all-reduces (model group, data
    group)."""
    from repro_torch.core.collectives import _overlap_chunks
    from repro_torch.models.moe import uses_island

    q, s = eng.cache_spec.quantized, stats
    check(len(eng.cfg.layers) == n_layers, f"expected_launches: {n_layers} layers, the engine "
                                           f"has {len(eng.cfg.layers)}")
    L = attn_layers(eng.cfg)
    R, M = row_reductions(eng.cfg), dense_reductions(eng.cfg)
    R_dec = row_reductions(eng.cfg, decode=True)
    policy = eng.ctx.policy
    two = policy.variant == "two_phase"
    planes = 4 if q else 2
    # a TP group's gather variant quantizes and reduces each of its
    # overlap_chunks feature chunks apart (two_phase is unchunked)
    tp = eng.tp_size > 1
    k = (_overlap_chunks(eng.cfg.d_model, policy.spec, policy.overlap_chunks)
         if tp and policy.enabled and not two else 1)
    if eng.token_budget:
        n_c, n_d = s.n_compressed_steps, s.n_steps - s.n_compressed_steps
        red, dense = R * n_c, R * n_d
        passes = s.n_steps
        out = {"mx_quant": red * (k + two) + (L * 2 * (n_c + n_d) if q else 0),
               "mx_dequant_reduce": red * k,
               "mx_dequant": red * two + (L * 2 * (n_c + n_d) if q else 0),
               "paged_attention": L * (n_c + n_d)}
        reads, forks = s.n_steps, s.n_dispatches - s.n_steps
        n_whole = n_dec = 0
    else:
        n_chunk = sum(1 for p, _ in s.step_tokens if p)
        n_dec = sum(1 for _, d in s.step_tokens if d)
        # whole-prompt: prefill + insert each; chunked: the rest are COW forks
        n_whole = 0 if eng.prefill_chunk else (s.n_dispatches - n_chunk - n_dec) // 2
        comp_pre = (n_chunk + n_whole) * eng.ctx.policy.enabled
        comp_dec = n_dec * eng.ctx_decode.policy.enabled
        red = R * comp_pre + R_dec * comp_dec
        dense = R * (n_chunk + n_whole - comp_pre) + R_dec * (n_dec - comp_dec)
        passes = n_chunk + n_whole + n_dec
        out = {"mx_quant": red * (k + two) + (L * 2 * (n_chunk + n_dec + n_whole) if q else 0),
               "mx_dequant_reduce": red * k, "mx_dequant": red * two,
               "paged_attention": L * (n_chunk + n_dec)}
        reads = n_chunk + n_dec
        forks = s.n_dispatches - reads - 2 * n_whole
    # the island: split decode steps of a grid whose slot width meets its gate
    moe_l, dp = moe_layers(eng.cfg), eng.dp_size
    island = (moe_l * n_dec if not eng.token_budget and moe_l
              and uses_island(eng.cfg, dp, eng.n_slots, eng.n_slots) else 0)
    dec_policy = eng.ctx_decode.policy
    isl_c = island * dec_policy.enabled * dec_policy.compress_tp_reduce
    isl_a2a = island * dec_policy.enabled * dec_policy.compress_all_to_all
    out["mx_quant"] += isl_c * k + 2 * isl_a2a
    out["mx_dequant_reduce"] += isl_c * k
    out["mx_dequant"] += 2 * isl_a2a
    sharded = dp > 1 and eng.cfg.n_experts % dp == 0
    moe_ar = (moe_l * passes - island) * (1 + sharded) + island - isl_c
    if eng.kv_shards > 1:
        out["all_reduce"] = L * planes * (reads + forks)
    if tp:   # per compressed reduction: payload and scales (per chunk); per dense one
        out.update(tp_all_gather=(red + isl_c) * (2 if two else 2 * k),
                   tp_all_to_all=red * 2 * two,
                   tp_all_reduce=dense + (M - moe_l) * passes + moe_ar,
                   tp_dense_all_gather=n_whole * (eng.cfg.frontend == "vision"))
    return out


def expert_bytes(params) -> int:
    """Bytes of the routed experts' weights (``up``, ``gate``, ``down`` of
    every MoE layer) in a parameter tree."""
    return sum(t.numel() * t.element_size() for lp in params["layers"] if "moe" in lp
               for k in ("up", "gate", "down") for t in _leaves(lp["moe"][k]))


def row_reductions(cfg, decode: bool = False) -> int:
    """Row-parallel reductions the policy compresses per forward pass of
    ``cfg``: each layer's ``wo`` (a Mamba layer's ``out_proj``), and its
    MLP's ``down`` or its MoE's shared experts' (a mixtral layer 1, a llama4
    MoE layer 2, a dense layer 2, a jamba MoE layer 1); an xLSTM layer's one
    (an mLSTM ``down``, an sLSTM ``ff_down``: xlstm-125m 12); an
    encoder-decoder adds each decoder layer's cross-attention ``wo`` and, in
    a prefill (not a ``decode`` step), each encoder layer's ``wo`` and
    ``down`` (whisper: 120 a prefill, 72 a decode step; pixtral 80 both)."""
    n = sum(1 if sp.kind in ("mlstm", "slstm") else 1 + (cfg.n_shared_experts if sp.moe else 1)
            for sp in cfg.layers)
    if cfg.encoder_decoder:
        n += cfg.n_layers + (0 if decode else 2 * cfg.n_encoder_layers)
    return n


def moe_layers(cfg) -> int:
    """MoE layers of ``cfg``: on a TP group each reduces its routed experts
    with one dense all-reduce per forward pass."""
    return sum(sp.moe for sp in cfg.layers)


def mamba_layers(cfg) -> int:
    """Mamba layers of ``cfg``: on a TP group each reduces its ``x_proj``
    partial with one dense all-reduce per forward pass."""
    return sum(sp.kind == "mamba" for sp in cfg.layers)


def mlstm_layers(cfg) -> int:
    """mLSTM layers of ``cfg``: on a TP group each reduces its q/k/v/i/f
    partial with one dense all-reduce per forward pass."""
    return sum(sp.kind == "mlstm" for sp in cfg.layers)


def dense_reductions(cfg) -> int:
    """The dense all-reduces a forward pass of ``cfg`` makes on a TP group
    beside its row-parallel reductions: one per MoE layer (routed experts),
    Mamba layer (``x_proj``) and mLSTM layer (q/k/v/i/f)."""
    return moe_layers(cfg) + mamba_layers(cfg) + mlstm_layers(cfg)


def attn_layers(cfg) -> int:
    """Attention layers of ``cfg``: the layers with paged pools."""
    return sum(sp.kind == "attn" for sp in cfg.layers)


def serve_run(torch, dev, runs, totals, L, name, eng, traffic, warm=True, sup=None,
              req_kw=None, all_new=True, during=None, new=NEW, extra=None):
    """One measured run of ``eng`` (under ``sup`` when given) on
    ``traffic`` (with the model's ``extra`` inputs, one row per request,
    when it takes them), ``new`` tokens a request, with its checks: every request
    at a terminal outcome (``ok`` with ``new`` tokens when ``all_new``), a
    conserved free list with nothing held, finite logits in the last
    attempt, launches equal to the stats' (on sharded pools the exchange's
    all-reduces too). ``during(reqs)`` starts what acts on the run from
    outside (a timer). Returns (summary, requests)."""
    from repro_torch.core.collectives import (
        exchange_counts, reset_exchange_counts, reset_tp_counts, tp_counts,
    )
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.serving import Request

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    base = None
    if dev == "cuda":   # the peak over the run, its warm-up's captures included
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    if warm:   # cuBLAS handles, first launches and captures, outside the count
        plan, eng.fault_plan = eng.fault_plan, None
        eng.run([Request(prompt=traffic[0].copy(), max_new_tokens=2)],
                extra_inputs=first_rows(extra))
        eng.fault_plan = plan
        sync()
    reqs = [Request(prompt=p.copy(), max_new_tokens=new, **k)
            for p, k in zip(traffic, req_kw or [{}] * len(traffic))]
    stop = during(reqs) if during else None
    reset_launch_counts()
    reset_exchange_counts()
    reset_tp_counts()
    t0 = time.perf_counter()
    (sup or eng).run(reqs, seed=0, extra_inputs=extra)
    sync()
    wall = time.perf_counter() - t0
    got = launch_counts()
    exchange = exchange_counts()
    collectives = tp_counts()
    if eng.kv_shards > 1:
        got["all_reduce"] = exchange["all_reduce"]
    if eng.tp_size > 1:
        got.update({f"tp_{c}": collectives[c] for c in ("all_gather", "all_to_all",
                                                          "all_reduce", "dense_all_gather")})
    if stop:
        stop()
    stats = (sup or eng).stats
    s = stats.summary()
    expect = expected_launches(eng, stats, L)
    a = eng.allocator
    check(all(r.outcome is not None for r in reqs), f"{name}: a request has no outcome")
    check(not all_new or all(r.outcome == "ok" and len(r.output) == new for r in reqs),
          f"{name}: not every request finished ok with {new} tokens")
    check(eng.logits_finite(), f"{name}: non-finite logits")
    check(a.n_free + a.n_cached == eng.n_blocks - 1 and a.n_allocated == 0
          and a.n_held == 0,
          f"{name}: free list not conserved ({a.n_free} free, {a.n_cached} cached, "
          f"{a.n_allocated} referenced, {a.n_held} held of {eng.n_blocks - 1})")
    if dev == "cuda":  # kernels launch only on the card
        check(got == expect, f"{name}: launches {got} != expected {expect}")
    else:   # the exchanges and the TP collectives run on the CPU too
        for c in ("all_reduce", "tp_all_gather", "tp_all_to_all", "tp_all_reduce",
                  "tp_dense_all_gather"):
            check(got.get(c) == expect.get(c),
                  f"{name}: {got.get(c)} {c} != expected {expect.get(c)}")
    for k in totals:
        totals[k] += got[k]
    runs[name] = dict(summary=s, launches=got, gate=dict(eng.gate_counts), wall_s=wall,
                      pool_mb=eng.kv_pool_bytes() / 1e6, pool_bytes=eng.kv_pool_bytes(),
                      outputs=[r.output.tolist() for r in reqs],
                      outcomes=[r.outcome for r in reqs], exchange=exchange, expected=expect,
                      tp=collectives,
                      graphed=eng.graphed,
                      programs=(eng.decode_cache_size(), eng.prefill_cache_size()),
                      capture_s=eng.capture_seconds(),
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else None,
                      # what the run added at its peak over what was held before it (the
                      # engine's pools come with the engine): graph pool and activations
                      run_peak_gb=((torch.cuda.max_memory_allocated() - base) / 1e9
                                   if dev == "cuda" else None))
    outcomes = ", ".join(f"{s[k]} {k[2:].replace('_', ' ')}" for k in
                         ("n_ok", "n_rejected", "n_timed_out", "n_cancelled") if s[k])
    log(f"serve[{name}]: {len(reqs)} requests ({outcomes}), {s['n_generated']} tokens in "
        f"{wall:.2f} s; TTFT p50 {s['ttft_p50_s'] * 1e3:.1f} ms p90 "
        f"{s['ttft_p90_s'] * 1e3:.1f} ms; TPOT p50 {s['tpot_p50_s'] * 1e3:.2f} ms; "
        f"{s['tokens_per_s']:.1f} tokens/s, goodput {s['goodput_tokens_per_s']:.1f}; "
        f"{s['n_steps']} steps, {s['n_dispatches']} "
        f"dispatches (gate {eng.gate_counts}); {s['n_preemptions']} preemptions; "
        f"{s['prefill_tokens_skipped']} prompt tokens skipped; pool "
        f"{runs[name]['pool_mb']:.1f} MB; {'graphed' if eng.graphed else 'eager'} steps, "
        f"programs decode={runs[name]['programs'][0]} prefill={runs[name]['programs'][1]}; "
        f"launches {got}")
    return s, reqs


def phase_serve(torch, dev="cuda", cfg=None):
    """llama2-7b at full width and depth (or ``cfg``), one set of weights,
    through every scheduler and cache path of the port. Each run is driven
    with the launch counts set to 0 just before it and read just after, and
    held to the counts its own stats give (``expected_launches``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import PAPER_DEFAULT
    from repro_torch.core.tp import TPContext
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine

    cfg = cfg or get_config("llama2-7b")
    L = cfg.n_layers
    model = Model(cfg)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    params = model.init_params(device=dev, seed=0)
    sync()
    log(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} random "
        f"{cfg.dtype} weights (seed 0) in {time.perf_counter() - t0:.1f} s; "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB")
    ctx = TPContext(policy=PAPER_DEFAULT, simulate_tp=TP)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32) for _ in range(8)]
    shared = rng.integers(0, cfg.vocab_size, CHUNK).astype(np.int32)
    shared_prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, PROMPT - CHUNK)
                                      .astype(np.int32)]) for _ in range(8)]
    runs, totals = {}, {k: 0 for k in KERNELS}
    serve = functools.partial(serve_run, torch, dev, runs, totals, L)
    kw = dict(max_slots=SLOTS, max_len=MAX_LEN, block_size=BS, device=dev)
    # the mixed token-budget step
    for spec in ("fp4_e2m1", "bf16"):
        eng = Engine(model, params, ctx, prefill_chunk=CHUNK,
                                             token_budget=T, cache_spec=spec, **kw)
        serve(f"mixed/{spec}", eng, prompts)[0]
        check(eng.gate_counts["compressed"] > 0 and eng.gate_counts["dense"] > 0,
              f"mixed/{spec}: gate counts {eng.gate_counts}")
    # (a) the split scheduler: one 256-token chunk, then the batched decode
    for spec in ("fp4_e2m1", "bf16"):
        eng = Engine(model, params, ctx, prefill_chunk=CHUNK,
                                             token_budget=0, cache_spec=spec, **kw)
        s = serve(f"split/{spec}", eng, prompts)[0]
        check(s["n_dispatches"] > s["n_steps"], f"split/{spec}: one dispatch per step")
    # (b) whole-prompt prefill + insert, then the batched decode
    eng = Engine(model, params, ctx, prefill_chunk=0,
                                          cache_spec="fp4_e2m1", **kw)
    s = serve("whole/fp4_e2m1", eng, prompts)[0]
    check(s["prefill_tokens"] == 8 * PROMPT and s["n_dispatches"] > s["n_steps"],
          "whole/fp4_e2m1: prompts not prefilled whole")
    # (c) prefix cache kept warm across runs: a shared 256-token prefix, then
    # the same prompts again (bf16 pools fork the tail block, fp4 pools
    # resume at the aligned boundary); pools sized to keep every prompt block
    for spec in ("fp4_e2m1", "bf16"):
        eng = Engine(model, params, ctx, prefill_chunk=CHUNK, token_budget=T, cache_spec=spec,
                     prefix_cache=True, persistent_cache=True,
                     n_blocks=8 * (MAX_LEN // BS) + 1, **kw)
        first = serve(f"prefix/{spec}/run1", eng, shared_prompts, warm=False)[0]
        second = serve(f"prefix/{spec}/run2", eng, shared_prompts, warm=False)[0]
        check(first["prefill_tokens_skipped"] > 0 and second["prefill_tokens_skipped"] > 0,
              f"prefix/{spec}: no prompt tokens skipped")
        # the warm run reads through other kernel geometries and GEMM shapes,
        # so its tokens may part from the cold run's at a near tie: counted
        same = sum(a == b for a, b in zip(runs[f"prefix/{spec}/run1"]["outputs"],
                                          runs[f"prefix/{spec}/run2"]["outputs"]))
        runs[f"prefix/{spec}/run2"]["same_tokens_as_run1"] = same
        log(f"prefix[{spec}]: the warm run decoded the cold run's tokens for {same} of 8 "
            f"requests")
        cow = second["n_dispatches"] - second["n_steps"]
        if spec == "bf16":
            check(eng._exact_pools and cow == 8 and second["prefill_tokens_skipped"]
                  == 8 * (PROMPT - 1), f"prefix/bf16: {cow} COW forks, "
                  f"{second['prefill_tokens_skipped']} tokens skipped on the warm run")
        else:
            check(cow == 0 and second["prefill_tokens_skipped"] == 8 * CHUNK,
                  f"prefix/fp4: {cow} COW forks, {second['prefill_tokens_skipped']} skipped")
    # (d) preemption: 101 usable blocks for 4 slots of 34. (With one block
    # more, three requests' worth, the fourth slot's chunk defers in place and
    # the three decodes fit exactly, so nothing is preempted.)
    eng = Engine(model, params, ctx, prefill_chunk=CHUNK, token_budget=T, cache_spec="fp4_e2m1",
                 n_blocks=3 * (MAX_LEN // BS), **kw)
    s = serve("evict/fp4_e2m1", eng, prompts)[0]
    check(s["n_preemptions"] >= 1, "evict/fp4_e2m1: no preemption")
    serve_faults(torch, dev, serve, runs, model, params, ctx, prompts, kw)

    # (e) whole-prompt TTFT (Table 3's metric), compressed vs uncompressed
    # reductions on the one card: the simulated codec's cost, not a TP saving
    runs["ttft"] = ttft_runs(torch, dev, model, params, TTFT_LENS, totals)
    check(dev != "cuda" or all(totals[k] > 0 for k in KERNELS),
          f"a kernel never launched: {totals}")
    runs["graphs"] = phase_graphs(torch, dev, serve, runs, model, params, ctx, prompts,
                                  kw, totals)
    return runs, totals


def ttft_runs(torch, dev, model, params, lens, totals, label="", graphs=True, extra=None):
    """``measure_ttft`` at each prompt length of ``lens``, compressed
    (PAPER_DEFAULT over simulate_tp = TP) and uncompressed, launches held to
    one compressed reduction per row-parallel layer (``row_reductions``: an
    encoder-decoder's encoder and cross-attention included) and prefill, on
    graphed steps (``graphs=False``: eager), over the first row of the
    model's ``extra`` inputs (a vision prefix, encoder frames) when it takes
    them. Returns {"compressed/n" | "uncompressed/n": result}."""
    from repro_torch.core.policy import NO_COMPRESSION, PAPER_DEFAULT
    from repro_torch.core.tp import TPContext
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine

    R = row_reductions(model.cfg)
    ttft = {}
    for kind, policy in (("compressed", PAPER_DEFAULT), ("uncompressed", NO_COMPRESSION)):
        eng = Engine(model, params, TPContext(policy=policy, simulate_tp=TP), max_slots=1,
                     max_len=n_prefix(model.cfg) + max(lens), block_size=BS, prefill_chunk=0,
                     device=dev, cuda_graphs=graphs)
        for n in lens:
            reset_launch_counts()
            r = eng.measure_ttft(n, iters=TTFT_ITERS, extra_inputs=first_rows(extra))
            got = launch_counts()
            comp = int(policy.enabled)
            expect = {"mx_quant": TTFT_ITERS * R * comp, "mx_dequant": 0,
                      "mx_dequant_reduce": TTFT_ITERS * R * comp, "paged_attention": 0}
            if dev == "cuda":
                check(got == expect, f"{label}ttft/{kind}/{n}: launches {got} != {expect}")
            for k in totals:
                totals[k] += got[k]
            ttft[f"{kind}/{n}"] = dict(r, launches=got, capture_s=eng.capture_seconds())
            log(f"{label}ttft[{n} tokens, {kind}]: median {r['median_s'] * 1e3:.2f} ms, std "
                f"{r['std_s'] * 1e3:.2f} ms over {r['iters']} prefills")
        del eng
    return ttft


# ---------------------------------------------------------------------- graphs

# phase 5's graphed run -> (the scheduler options of its eager twin, the
# (decode, prefill) program counts both must show: 2 for a mixed engine under
# PAPER_DEFAULT that ran both gate variants)
GRAPH_PAIRS = {
    "mixed/fp4_e2m1": (dict(prefill_chunk=CHUNK, token_budget=T, cache_spec="fp4_e2m1"), (2, 2)),
    "mixed/bf16": (dict(prefill_chunk=CHUNK, token_budget=T, cache_spec="bf16"), (2, 2)),
    "split/bf16": (dict(prefill_chunk=CHUNK, token_budget=0, cache_spec="bf16"), (1, 1)),
    "whole/fp4_e2m1": (dict(prefill_chunk=0, cache_spec="fp4_e2m1"), (1, 1)),
}


def phase_graphs(torch, dev, serve, runs, model, params, ctx, prompts, kw, totals):
    """Phase 8: graphed steps against eager ones on llama2-7b, the weights
    and prompts of phase 5, whose graphed runs (``GRAPH_PAIRS``) each get an
    eager twin (``graphs_vs_eager``): greedy tokens identical in every
    request (no tolerance); launches exact on both (``serve_run``); program
    counts as ``GRAPH_PAIRS`` expects on both. Then a supervised eager
    ``corrupt@9`` run on bf16 pools whose tokens and recovery the graphed
    run of phase 5 must match, and ``measure_ttft`` on eager steps. Prints
    capture seconds per program, TPOT p50, tokens/s and the device memory
    each run added at its peak, eager against graphed, and the whole-prompt
    TTFT of both, compressed against uncompressed."""
    from repro_torch.serving import Engine, EngineSupervisor, FaultPlan

    out = {}
    for name, (opts, programs) in GRAPH_PAIRS.items():
        out[name] = graphs_vs_eager(dev, serve, runs, name, Engine(
            model, params, ctx, cuda_graphs=False, **opts, **kw), prompts, programs)

    # a hard recovery under graphs: phase 5's graphed faults/bf16 run
    eng = Engine(model, params, ctx, prefill_chunk=CHUNK, token_budget=T, cache_spec="bf16",
                 cuda_graphs=False, fault_plan=FaultPlan.parse(FAULT_RUNS["bf16"][0]), **kw)
    sup = EngineSupervisor(eng)
    serve("eager faults/bf16", eng, prompts, sup=sup)
    g, e = runs["faults/bf16"], runs["eager faults/bf16"]
    ev = lambda r: [(x["error"], x["mode"], x["n_replayed"]) for x in r["events"]]
    e["events"] = [dict(error=x.error, mode=x.mode, n_replayed=x.n_replayed,
                        recovery_s=x.recovery_s) for x in sup.events]
    check(ev(g) == ev(e) == [("WireCorruption", "hard", len(prompts))],
          f"graphs[faults/bf16]: recoveries graphed {ev(g)}, eager {ev(e)}")
    check(g["outputs"] == e["outputs"], "graphs[faults/bf16]: the graphed run's tokens after "
                                        "its hard recovery differ from the eager run's")
    check(g["programs"] == (2, 2), f"graphs[faults/bf16]: programs {g['programs']} after the "
                                   f"recovery")
    out["faults/bf16"] = dict(recovery_s=([x["recovery_s"] for x in g["events"]],
                                          [x["recovery_s"] for x in e["events"]]))
    log(f"graphs[faults/bf16]: corrupt@9 recovered hard on both, tokens identical; recovery_s "
        f"{g['events'][0]['recovery_s']:.4f} graphed / {e['events'][0]['recovery_s']:.4f} "
        f"eager; programs decode={g['programs'][0]} prefill={g['programs'][1]}")
    del eng, sup

    runs["ttft_eager"] = ttft_runs(torch, dev, model, params, TTFT_LENS, totals,
                                   label="eager ", graphs=False)
    for n in TTFT_LENS:
        gr, ea = runs["ttft"], runs["ttft_eager"]
        ms = lambda r, k: r[f"{k}/{n}"]["median_s"] * 1e3
        out[f"ttft/{n}"] = {k: (ms(gr, k), ms(ea, k)) for k in ("compressed", "uncompressed")}
        log(f"graphs ttft[{n} tokens]: graphed {ms(gr, 'compressed'):.3f} ms compressed / "
            f"{ms(gr, 'uncompressed'):.3f} ms uncompressed = "
            f"{ms(gr, 'compressed') / ms(gr, 'uncompressed'):.3f}x; eager "
            f"{ms(ea, 'compressed'):.3f} / {ms(ea, 'uncompressed'):.3f} ms = "
            f"{ms(ea, 'compressed') / ms(ea, 'uncompressed'):.3f}x; capture s "
            + ", ".join(f"{k} {gr[f'{k}/{n}']['capture_s'].get(f'prefill/{n}', float('nan')):.3f}"
                        for k in ("compressed", "uncompressed")))
    return out


def fit_depth(torch, dev, cfg, n_blocks, margin_gb=6.0):
    """``cfg`` at full depth if its bf16 weights (``param_count``: every
    leaf of the tree ``init_params`` builds, a jamba Mamba layer's MLP
    included), the K/V pools of ``n_blocks`` blocks (bf16, the larger
    format) of each attention layer, the fp32 recurrent state of SLOTS slots
    of each Mamba layer and ``margin_gb`` fit in the card's free memory,
    else the largest prefix ``layers[:n]`` of its schedule whose summed
    sizes fit (each layer counted at its own size: a llama4 MoE layer is 86
    times a dense one). Returns (config, free bytes, bytes needed at full
    depth)."""
    from repro_torch.configs import first_layers
    from repro_torch.serving.kv_cache import cross_state_bytes, recurrent_state_bytes

    if dev != "cuda":
        return cfg, None, None
    free = torch.cuda.mem_get_info()[0]

    def need(n):
        prefix = first_layers(cfg, n)
        return (prefix.param_count() * 2
                + 2 * n_blocks * BS * cfg.kv_dim * 2 * attn_layers(prefix)
                + recurrent_state_bytes(prefix, SLOTS) + cross_state_bytes(prefix, SLOTS)
                + margin_gb * 1e9)

    n = cfg.n_layers
    while n > 1 and need(n) > free:
        n -= 1
    return first_layers(cfg, n), free, need(cfg.n_layers)


def phase_family(torch, arch, dev="cuda"):
    """One new family (``FAMILIES[arch]``) at full width on random seed-0
    bf16 weights, its runs under TPContext(PAPER_DEFAULT, simulate_tp=4)
    (``two_phase`` runs under the two_phase variant; ``whole`` runs
    whole-prompt prefill and the split decode, the one scheduler of a
    recurrent stack, a vision prefix and an encoder-decoder: a recurrent
    stack over prompts of the plan's exact ``lengths``, one step program per
    length, the others one per length bucket, each captured once and
    replayed; ``compress_decode`` runs compress the split decode's
    reductions too) and its measure_ttft lengths; a vision model's and an
    encoder-decoder's requests carry random stand-in patch embeddings or
    encoder frames (``stubs``). Every run held as ``serve_run`` holds it (ok
    with its token count, finite logits, the free list conserved, exact
    launch counts: a whisper prefill 120 compressed reductions, its decode
    step 72, pixtral 80 either way, paged reads one per decoder layer a
    decode step). At full depth when it fits the card (``fit_depth``), else
    at the depth that fits, printed. Prints the weight GB and each run's
    peak device memory."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import PAPER_DEFAULT
    from repro_torch.core.tp import TPContext
    from repro_torch.models.model import Model
    from repro_torch.models.moe import DENSE_MAX_TOKENS, capacity
    from repro_torch.serving import Engine
    from repro_torch.serving.kv_cache import cross_state_bytes, recurrent_state_bytes

    plan = FAMILIES[arch]
    full = get_config(arch)
    lengths = plan.get("lengths", (plan["prompt"],))
    new = plan.get("new", NEW)
    max_len = n_prefix(full) + max(lengths) + new
    n_blocks = SLOTS * (-(-max_len // BS)) + 1
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    cfg, free, need = fit_depth(torch, dev, full, n_blocks)
    if free is not None:
        log(f"{arch}: {free / 1e9:.2f} GB free on the card, {need / 1e9:.2f} GB needed at full "
            f"depth ({full.param_count() / 1e9:.2f} B parameters); serving "
            + (f"all {cfg.n_layers} layers" if cfg is full else
               f"{cfg.n_layers} of {full.n_layers} layers (depth cut to fit one card; full "
               f"width)"))
    L = cfg.n_layers
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(device=dev, seed=0)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"{arch}: {L} layers d_model {cfg.d_model} H {cfg.n_heads} KV {cfg.n_kv_heads} hd "
        f"{cfg.head_dim} vocab {cfg.vocab_size}, windows "
        f"{sorted({sp.window for sp in cfg.layers}, key=str)}, random {cfg.dtype} weights "
        f"(seed 0) in {time.perf_counter() - t0:.1f} s; {weights_gb:.2f} GB")
    n_moe = moe_layers(cfg)
    if n_moe:
        experts_gb = expert_bytes(params) / 1e9
        log(f"{arch}: {n_moe} MoE layers of {L} served ({full.n_layers} in the config): "
            f"{cfg.n_experts} experts, top-{cfg.top_k}, {cfg.n_shared_experts} shared, "
            f"capacity factor {cfg.capacity_factor}: "
            + (", ".join(f"{capacity(cfg, n)} slots per expert in a {n}-token prefill"
                         for n in lengths) if "lengths" in plan else
               f"{capacity(cfg, T)} slots per expert in a {T}-token mixed step, "
               f"{capacity(cfg, CHUNK)} in a {CHUNK}-token chunk")
            + f", every expert on every token at {DENSE_MAX_TOKENS} tokens or fewer; routed "
            f"expert weights "
            f"{experts_gb:.2f} GB, read whole by every step")
    n_mamba = mamba_layers(cfg)
    if n_mamba:
        log(f"{arch}: {n_mamba} Mamba layers and {attn_layers(cfg)} attention layers of {L} "
            f"served: d_inner {cfg.ssm_d_inner}, d_state {cfg.ssm_d_state}, dt_rank "
            f"{cfg.dt_rank}, d_conv {cfg.ssm_d_conv}; recurrent state "
            f"{recurrent_state_bytes(cfg, SLOTS) / 1e6:.2f} MB fp32 for {SLOTS} slots; "
            f"whole-prompt prefill at exact lengths {list(lengths)}")
    n_mlstm, n_slstm = mlstm_layers(cfg), sum(sp.kind == "slstm" for sp in cfg.layers)
    if n_mlstm or n_slstm:
        log(f"{arch}: {n_mlstm} mLSTM and {n_slstm} sLSTM layers of {L} served, no attention "
            f"layer (no paged pools, no paged read): mLSTM d_inner {cfg.mlstm_d_inner} in "
            f"{cfg.mlstm_heads} heads, sLSTM {cfg.n_heads} heads and FF {cfg.slstm_ff}; "
            f"recurrent state {recurrent_state_bytes(cfg, SLOTS) / 1e6:.2f} MB fp32 for "
            f"{SLOTS} slots; {row_reductions(cfg)} compressed reductions a compressed pass; "
            f"whole-prompt prefill at exact lengths {list(lengths)}")
    if cfg.frontend == "vision":
        log(f"{arch}: a vision prefix of {cfg.n_patches} patch embeddings (random stand-ins, "
            f"seed 0) through mm_proj ahead of {list(lengths)} text tokens: "
            f"{[n_prefix(cfg) + n for n in lengths]} positions a prefill")
    if cfg.encoder_decoder:
        log(f"{arch}: {cfg.n_encoder_layers} encoder layers over {cfg.encoder_seq} frames "
            f"(random stand-ins, seed 0) in each prefill, {cfg.n_layers} decoder layers with "
            f"cross-attention; per-slot cross K/V "
            f"{cross_state_bytes(cfg, SLOTS) / 1e6:.2f} MB bf16 for {SLOTS} slots")
    if cfg.frontend is not None:
        log(f"{arch}: per pass {row_reductions(cfg)} compressed reductions a prefill, "
            f"{row_reductions(cfg, decode=True)} a decode step (when it compresses), "
            f"{attn_layers(cfg)} paged reads a decode step")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, lengths[i % len(lengths)]).astype(np.int32)
               for i in range(plan["requests"])]
    extra = stubs(cfg, plan["requests"])
    runs, totals = {}, {k: 0 for k in KERNELS}
    serve = functools.partial(serve_run, torch, dev, runs, totals, L, new=new, extra=extra)
    kw = dict(max_slots=SLOTS, max_len=max_len, block_size=BS, device=dev)

    def engine(run, graphs=True):
        kind, spec = run.split("/")
        policy = (dataclasses.replace(PAPER_DEFAULT, variant="two_phase") if kind == "two_phase"
                  else PAPER_DEFAULT)
        steps = (dict(prefill_chunk=0) if kind == "whole" else
                 dict(prefill_chunk=CHUNK, token_budget=0 if kind == "split" else T))
        return Engine(model, params, TPContext(policy=policy, simulate_tp=TP),
                      cache_spec=spec, cuda_graphs=graphs,
                      compress_decode=run in plan.get("compress_decode", ()), **steps, **kw)

    for run in plan["runs"]:
        kind = run.split("/")[0]
        eng = engine(run)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        s = serve(f"{arch} {run}", eng, prompts)[0]
        peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else None
        runs[f"{arch} {run}"]["peak_gb"] = peak
        if kind == "split":
            check(s["n_dispatches"] > s["n_steps"], f"{arch} {run}: one dispatch per step")
        elif kind == "whole":
            # one program per exact length (a recurrent stack) or per bucket
            buckets = {eng._shapes_for(n)[0] for n in lengths}
            captured = sorted(k for k in eng.capture_seconds() if k.startswith("prefill/"))
            check(s["prefill_tokens"] == sum(map(len, prompts))
                  and eng.prefill_cache_size() == len(buckets)
                  and (dev != "cuda" or captured == sorted(f"prefill/{n}" for n in buckets)),
                  f"{arch} {run}: {s['prefill_tokens']} prompt tokens prefilled, "
                  f"{eng.prefill_cache_size()} prefill programs {captured}, not one per "
                  f"length bucket {sorted(buckets)}")
            runs[f"{arch} {run}"]["prefill_capture_s"] = {
                k: v for k, v in eng.capture_seconds().items() if k.startswith("prefill/")}
            log(f"{arch} {run}: {eng.prefill_cache_size()} whole-prompt programs, one per "
                f"length bucket {sorted(buckets)}, each replayed for the later prompts of its "
                f"bucket; decode {'compressed' if eng.ctx_decode.policy.enabled else 'dense'}; "
                f"capture s "
                + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                    runs[f'{arch} {run}']['prefill_capture_s'].items())))
        else:
            check(eng.gate_counts["compressed"] > 0 and eng.gate_counts["dense"] > 0,
                  f"{arch} {run}: gate counts {eng.gate_counts}")
        log(f"{arch} {run}: peak device memory " + (f"{peak:.2f} GB" if peak is not None
                                                    else "not measured (no card)"))
        del eng
        if run in plan.get("eager", ()):
            runs[f"{arch} graphs/{run}"] = graphs_vs_eager(
                dev, serve, runs, f"{arch} {run}", engine(run, graphs=False), prompts)
    if plan["ttft"]:
        runs["ttft"] = ttft_runs(torch, dev, model, params, plan["ttft"], totals, f"{arch} ",
                                 extra=extra)
        for n in plan["ttft"]:
            ms = lambda k: runs["ttft"][f"{k}/{n}"]["median_s"] * 1e3
            log(f"{arch} ttft[{n} tokens]: {ms('compressed'):.3f} ms compressed / "
                f"{ms('uncompressed'):.3f} ms uncompressed = "
                f"{ms('compressed') / ms('uncompressed'):.4f}x")
    if "two_phase/fp4_e2m1" in plan["runs"]:
        two, one = runs[f"{arch} two_phase/fp4_e2m1"], runs[f"{arch} mixed/fp4_e2m1"]
        extra = {k: two["launches"][k] - one["launches"][k] for k in ("mx_quant", "mx_dequant")}
        log(f"{arch}: two_phase adds {extra} launches over the gather run "
            f"({two['summary']['n_compressed_steps']} compressed steps x {L} layers x 2 "
            f"reductions each)")
    runs["config"] = dict(n_layers=L, full_layers=full.n_layers, weights_gb=weights_gb,
                          free_gb=free and free / 1e9, need_gb=need and need / 1e9,
                          moe_layers=n_moe, mamba_layers=n_mamba, mlstm_layers=n_mlstm,
                          slstm_layers=n_slstm, attn_layers=attn_layers(cfg))
    return runs, totals


def graphs_vs_eager(dev, serve, runs, name, eng, prompts, programs=None):
    """The eager twin ``eng`` (``cuda_graphs=False``) of the graphed run
    ``name``, on its weights and prompts: greedy tokens identical in every
    request (no tolerance: a replay runs the eager step's kernels; on a MoE
    model the graph holds the routing sort, the dispatch scatter and the
    combine's scatter-add), launches exact on both (``serve_run``), the
    same program counts (and ``programs`` when given). Returns what it
    printed: tokens, capture seconds, TPOT p50, tokens/s and the device
    memory each run added at its peak, graphed against eager."""
    serve(f"eager {name}", eng, prompts)
    g, e = runs[name], runs[f"eager {name}"]
    check(dev != "cuda" or (g["graphed"] and not eng.graphed),
          f"graphs[{name}]: graphed {g['graphed']}, eager {eng.graphed}")
    check(g["programs"] == e["programs"] and programs in (None, g["programs"]),
          f"graphs[{name}]: programs graphed {g['programs']}, eager {e['programs']}, "
          f"expected {programs or 'the same'}")
    differ = [i for i, (x, y) in enumerate(zip(g["outputs"], e["outputs"])) if x != y]
    same = len(prompts) - len(differ)
    check(g["outputs"] == e["outputs"] and len(g["outputs"]) == len(prompts),
          f"graphs[{name}]: {same} of {len(prompts)} requests decoded the eager tokens; "
          f"requests {differ} differ")
    sg, se = g["summary"], e["summary"]
    peak = (f"{g['run_peak_gb']:.3f} / {e['run_peak_gb']:.3f} GB" if dev == "cuda"
            else "not measured (no card)")
    log(f"graphs[{name}]: tokens identical for {same} of {len(prompts)} requests; "
        f"programs decode={g['programs'][0]} "
        f"prefill={g['programs'][1]} on both; TPOT p50 {sg['tpot_p50_s'] * 1e3:.2f} ms "
        f"graphed / {se['tpot_p50_s'] * 1e3:.2f} ms eager; {sg['tokens_per_s']:.1f} / "
        f"{se['tokens_per_s']:.1f} tokens/s; device memory the run added at its peak "
        f"{peak} graphed / eager; "
        f"capture s " + ", ".join(f"{k} {v:.3f}" for k, v in g["capture_s"].items()))
    return dict(same_tokens=same, capture_s=g["capture_s"],
                tpot_p50_ms=(sg["tpot_p50_s"] * 1e3, se["tpot_p50_s"] * 1e3),
                tokens_per_s=(sg["tokens_per_s"], se["tokens_per_s"]),
                run_peak_gb=(g["run_peak_gb"], e["run_peak_gb"]), programs=g["programs"])


# ---------------------------------------------------------------------- sharded

KV_RANKS = 2                      # the sharded phase's kv ranks, on the one card
SHARD_PROMPT, SHARD_NEW = 64, 8   # its traffic: SLOTS requests of 64 + 8 tokens
SHARD_CAP_BLOCKS = 17             # the capacity case's pool budget per rank (blocks)


def cross_bytes_held(eng) -> int:
    """Bytes of an encoder-decoder's per-slot cross K/V this process holds
    for ``eng`` (0 for a decoder)."""
    return sum(t.numel() * t.element_size()
               for t in eng._state.get("cross_k", []) + eng._state.get("cross_v", []))


def sharded_serve(torch, dev, group, model, params, label):
    """The sequence-sharded phase's runs of ``model`` on this kv rank of
    ``group`` (None: the replicated engine they are held to), each held as
    ``serve_run`` holds it, the exchange's all-reduces counted with the
    launches: (a) the mixed step on fp4 pools under PAPER_DEFAULT over
    simulate_tp = 4, and on bf16 pools uncompressed; (b) the split
    scheduler on fp4 pools of 12 blocks (5 a request), so that it preempts;
    (c) the prefix cache on bf16 pools run twice, the warm run forking every
    request's tail block (copy on write); (d) ``corrupt@3`` on fp4 pools,
    supervised; (e) one prompt as long as 2 x SHARD_CAP_BLOCKS blocks hold.
    Every engine's pools held in this process are ``kv_pool_bytes
    (per_device=True)``. Returns (runs, totals)."""
    import numpy as np

    from repro_torch.core.policy import NO_COMPRESSION, PAPER_DEFAULT
    from repro_torch.core.tp import TPContext
    from repro_torch.serving import Engine, EngineSupervisor, FaultPlan

    cfg = model.cfg
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, SHARD_PROMPT).astype(np.int32)
               for _ in range(SLOTS)]
    long_s = (2 * SHARD_CAP_BLOCKS - 1) * BS - 4 + 1
    long_prompt = [rng.integers(0, cfg.vocab_size, long_s).astype(np.int32)]
    runs, totals = {}, {k: 0 for k in KERNELS}
    serve = functools.partial(serve_run, torch, dev, runs, totals, cfg.n_layers, new=SHARD_NEW)
    ctx = lambda policy: TPContext(policy=policy, simulate_tp=TP, kv_group=group)
    comp = ctx(PAPER_DEFAULT)
    max_len = SHARD_PROMPT + SHARD_NEW
    kw = dict(max_slots=SLOTS, max_len=max_len, block_size=BS, prefill_chunk=CHUNK, device=dev)

    def held(name, eng):
        b = eng.pool_bytes_held()
        check(b == eng.kv_pool_bytes(per_device=True) == eng.kv_pool_bytes() // eng.kv_shards,
              f"{label}{name}: this rank holds {b} pool bytes, not "
              f"{eng.kv_pool_bytes(per_device=True)} of {eng.kv_pool_bytes()}")
        runs[label + name]["pool_bytes_held"] = b

    for name, spec, c in (("mixed/fp4_e2m1", "fp4_e2m1", comp),
                          ("mixed/bf16", "bf16", ctx(NO_COMPRESSION))):
        eng = Engine(model, params, c, token_budget=T, cache_spec=spec, **kw)
        serve(label + name, eng, prompts)
        held(name, eng)
    check(runs[label + "mixed/fp4_e2m1"]["gate"]["compressed"] > 0,
          f"{label}mixed/fp4_e2m1: no compressed step")
    eng = Engine(model, params, comp, token_budget=0, cache_spec="fp4_e2m1", n_blocks=12, **kw)
    s = serve(label + "split-evict/fp4_e2m1", eng, prompts)[0]
    held("split-evict/fp4_e2m1", eng)
    check(s["n_preemptions"] >= 1, f"{label}split-evict/fp4_e2m1: no preemption")
    eng = Engine(model, params, comp, token_budget=T, cache_spec="bf16", prefix_cache=True,
                 persistent_cache=True, n_blocks=2 * SLOTS * (-(-max_len // BS)) + 2, **kw)
    serve(label + "prefix/bf16/run1", eng, prompts, warm=False)
    held("prefix/bf16/run1", eng)
    s = serve(label + "prefix/bf16/run2", eng, prompts, warm=False)[0]
    held("prefix/bf16/run2", eng)
    check(s["n_dispatches"] - s["n_steps"] == SLOTS,
          f"{label}prefix/bf16: {s['n_dispatches'] - s['n_steps']} COW forks, not {SLOTS}")
    eng = Engine(model, params, comp, token_budget=T, cache_spec="fp4_e2m1",
                 fault_plan=FaultPlan.parse("corrupt@3"), **kw)
    sup = EngineSupervisor(eng, backoff_s=0.0)
    serve(label + "corrupt@3/fp4_e2m1", eng, prompts, sup=sup)
    events = [(e.error, e.mode) for e in sup.events]
    check(events == [("WireCorruption", "hard")], f"{label}corrupt@3: recoveries {events}")
    runs[label + "corrupt@3/fp4_e2m1"]["events"] = [(e.error, e.mode, e.n_replayed, e.detail)
                                                    for e in sup.events]
    held("corrupt@3/fp4_e2m1", eng)
    eng = Engine(model, params, comp, max_slots=1, max_len=(2 * SHARD_CAP_BLOCKS - 1) * BS,
                 block_size=BS, prefill_chunk=CHUNK, n_blocks=2 * SHARD_CAP_BLOCKS,
                 cache_spec="fp4_e2m1", device=dev)
    serve(label + "capacity/fp4_e2m1", eng, long_prompt, new=4)
    held("capacity/fp4_e2m1", eng)
    runs[label + "capacity/fp4_e2m1"]["prompt_tokens"] = long_s
    return runs, totals


# the whole-prompt stacks of phase 7 -> layers served (None: all): jamba's
# layers 0-4 hold its first attention layer (so its pools shard), and both
# ranks hold the whole model on the one card
KV_STACKS = {"jamba-v0.1-52b": 5, "xlstm-125m": None}


def sharded_whole(torch, dev, group, model, params, label):
    """A whole-prompt stack's run on this kv rank of ``group`` (None: the
    replicated engine it is held to): ``whole/fp4_e2m1`` under
    PAPER_DEFAULT over simulate_tp = 4, SLOTS requests of SHARD_PROMPT +
    SHARD_NEW tokens, held as ``serve_run`` holds it. Each rank holds half
    of the attention pools (none for a stack without attention) and the
    whole recurrent state. Returns (runs, totals)."""
    import numpy as np

    from repro_torch.core.policy import PAPER_DEFAULT
    from repro_torch.core.tp import TPContext
    from repro_torch.serving import Engine
    from repro_torch.serving.kv_cache import recurrent_state_bytes

    cfg = model.cfg
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, SHARD_PROMPT).astype(np.int32)
               for _ in range(SLOTS)]
    runs, totals = {}, {k: 0 for k in KERNELS}
    eng = Engine(model, params, TPContext(policy=PAPER_DEFAULT, simulate_tp=TP, kv_group=group),
                 max_slots=SLOTS, max_len=SHARD_PROMPT + SHARD_NEW, block_size=BS,
                 prefill_chunk=0, cache_spec="fp4_e2m1", device=dev)
    name = f"{label}{cfg.name} whole/fp4_e2m1"
    serve_run(torch, dev, runs, totals, cfg.n_layers, name, eng, prompts, new=SHARD_NEW)
    b = eng.pool_bytes_held()
    rec = sum(t.numel() * t.element_size() for c in eng._state["rec"] for t in c)
    check(b == eng.kv_pool_bytes(per_device=True) == eng.kv_pool_bytes() // eng.kv_shards
          and rec == recurrent_state_bytes(cfg, SLOTS),
          f"{name}: this rank holds {b} pool bytes of {eng.kv_pool_bytes()} and {rec} bytes "
          f"of recurrent state, not 1/{eng.kv_shards} and the whole "
          f"{recurrent_state_bytes(cfg, SLOTS)}")
    runs[name].update(pool_bytes_held=b, rec_bytes_held=rec)
    return runs, totals


def _sharded_rank(group, rank, dev, cfg, stacks):
    """One kv rank of ``phase_sharded``: open the kernels the parent built,
    draw ``cfg``'s seed-0 weights, serve ``sharded_serve``'s runs, then
    each whole-prompt stack of ``stacks`` (arch -> config) in turn
    (``sharded_whole``). Only rank 0 prints."""
    import torch

    from repro_torch.kernels.build import load_kernels
    from repro_torch.models.model import Model

    _QUIET[0] = rank != 0
    cuda = dev.type == "cuda"
    if cuda:
        load_kernels(build=False)
    model = Model(cfg)
    params = model.init_params(device=dev, seed=0)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runs, totals = sharded_serve(torch, dev.type, group, model, params, "sharded ")
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    for arch, scfg in stacks.items():
        del model, params
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        model = Model(scfg)
        params = model.init_params(device=dev, seed=0)
        r, t = sharded_whole(torch, dev.type, group, model, params, "sharded ")
        runs.update(r)
        for k in totals:
            totals[k] += t[k]
    return dict(runs=runs, totals=totals, device=str(dev), peak_gb=peak)


def phase_sharded(torch, card, dev="cuda", cfg=None, stack_cfgs=None):
    """llama2-7b at full width and depth on KV_RANKS kv ranks sharing the one
    card (processes over gloo; the exchange is staged through the host), its
    runs held to the replicated engine's in this process on the same weights
    and prompts: tokens identical on every rank and to the replicated run's,
    each rank holding half the pool bytes, exact launch and all-reduce
    counts; and at a fixed per-rank pool budget (SHARD_CAP_BLOCKS blocks)
    the sharded engine serves a prompt at least 1.9x longer than the
    replicated engine admits, which must refuse it. Prints the exchange's
    bytes and ms per step, TPOT p50 sharded against replicated, and each
    rank's peak device memory. (``dev="cpu"`` and a reduced ``cfg``
    rehearse it on the CPU, with ``stack_cfgs`` giving the whole-prompt
    stacks' reduced configs by arch, or False for none.) Then
    jamba-v0.1-52b's layers 0-4 and xlstm-125m at full depth
    (``KV_STACKS``), whole-prompt on fp4 pools (``sharded_whole``), on the
    same 2 ranks: tokens identical to the replicated engine's, half the
    pool bytes and the whole recurrent state per rank."""
    import numpy as np

    from repro_torch.configs import first_layers, get_config
    from repro_torch.core.policy import PAPER_DEFAULT
    from repro_torch.core.tp import TPContext
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine, PoolExhausted, Request

    cuda = dev == "cuda"
    cfg = cfg or get_config("llama2-7b")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    model = Model(cfg)
    params = model.init_params(device=dev, seed=0)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rep, totals = sharded_serve(torch, dev, None, model, params, "replicated ")
    rep_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    # the replicated engine at the per-rank budget refuses the long prompt
    eng = Engine(model, params, TPContext(policy=PAPER_DEFAULT, simulate_tp=TP), max_slots=1,
                 max_len=(2 * SHARD_CAP_BLOCKS - 1) * BS, block_size=BS, prefill_chunk=CHUNK,
                 n_blocks=SHARD_CAP_BLOCKS, cache_spec="fp4_e2m1", device=dev)
    cap = rep["replicated capacity/fp4_e2m1"]
    long_s, long_r = cap["prompt_tokens"], (SHARD_CAP_BLOCKS - 1) * BS - 4 + 1
    try:
        eng.run([Request(prompt=np.zeros(long_s, np.int32), max_new_tokens=4)])
        refused = False
    except PoolExhausted:
        refused = True
    check(refused, f"sharded: the replicated engine of {SHARD_CAP_BLOCKS} blocks admitted a "
          f"{long_s}-token prompt")
    budget = eng.kv_pool_bytes(per_device=True)
    del eng, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the whole-prompt stacks, replicated in this process first
    if stack_cfgs is None:
        stacks = {arch: first_layers(get_config(arch), n or 0) for arch, n in KV_STACKS.items()}
    else:
        stacks = dict(stack_cfgs or {})
    for arch, scfg in stacks.items():
        smodel = Model(scfg)
        sparams = smodel.init_params(device=dev, seed=0)
        r, t = sharded_whole(torch, dev, None, smodel, sparams, "replicated ")
        rep.update(r)
        for k in totals:
            totals[k] += t[k]
        del smodel, sparams
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_ranks(_sharded_rank, KV_RANKS, cfg, stacks, device=dev, timeout_s=900,
                        threads=0 if cuda else 2)
    wall = time.perf_counter() - t0
    log(f"sharded: {KV_RANKS} kv ranks on {card} over gloo (exchange staged through host "
        f"memory: one card, not NVLink), {wall:.1f} s with start-up")
    for r in ranks:
        for k in totals:
            totals[k] += r["totals"][k]
    for name, rr in rep.items():
        case = name.split(" ", 1)[1]
        sh = [r["runs"]["sharded " + case] for r in ranks]
        for i, x in enumerate(sh):
            check(x["outputs"] == rr["outputs"], f"sharded {case}: rank {i}'s tokens differ "
                  f"from the replicated run's")
            check(x["pool_bytes_held"] * KV_RANKS == x["pool_bytes"],
                  f"sharded {case}: rank {i} holds {x['pool_bytes_held']} of "
                  f"{x['pool_bytes']} pool bytes, not 1/{KV_RANKS}")
            check(x.get("events") == rr.get("events"),
                  f"sharded {case}: rank {i}'s recoveries {x.get('events')} differ from "
                  f"{rr.get('events')}")
        ex, s = sh[0]["exchange"], sh[0]["summary"]
        log(f"sharded {case}: tokens identical on {KV_RANKS} ranks and to the replicated run; "
            f"{sh[0]['pool_bytes_held'] / 1e6:.2f} MB of pools per rank of "
            f"{sh[0]['pool_mb']:.2f} MB; exchange {ex['all_reduce']} all-reduces "
            f"({sh[0]['expected']['all_reduce']} expected), "
            f"{ex['bytes'] / s['n_steps'] / 1e6:.2f} MB and {ex['seconds'] / s['n_steps'] * 1e3:.2f}"
            f" ms per step (one card, gloo, host-staged exchange); TPOT p50 "
            f"{s['tpot_p50_s'] * 1e3:.2f} ms sharded vs {rr['summary']['tpot_p50_s'] * 1e3:.2f} "
            f"ms replicated (one card, gloo, host-staged exchange)")
    shc = ranks[0]["runs"]["sharded capacity/fp4_e2m1"]
    check(shc["pool_bytes_held"] == budget and long_s / long_r >= 1.9,
          f"sharded capacity: {shc['pool_bytes_held']} pool bytes per rank against a budget of "
          f"{budget}; {long_s} / {long_r} tokens")
    log(f"sharded capacity: at {budget / 1e6:.2f} MB of fp4 pools per rank the {KV_RANKS}-rank "
        f"engine served a {long_s}-token prompt; the replicated engine admits {long_r} at most "
        f"({long_s / long_r:.2f}x) and refused it")
    for i, r in enumerate(ranks):
        log(f"sharded: rank {i} ({r['device']}) peak device memory "
            + (f"{r['peak_gb']:.2f} GB (replicated in one process: {rep_peak:.2f} GB)" if cuda
               else "not measured (no card)"))
    log(f"sharded: card {card}")
    return dict(replicated=rep, ranks=ranks, wall_s=wall, budget_bytes=budget,
                long_prompt=long_s, long_replicated=long_r), totals


# -------------------------------------------------------------------------- tp

# the TP phase's models -> (ranks, runs, layers served: None for all, else the
# schedule's first N at full width); traffic as phase 7's: SLOTS requests of
# SHARD_PROMPT + SHARD_NEW tokens
TP_MODELS = {
    # llama2 at full width on its first 16 and 10 layers: each layer repeats
    # the same reductions, and a step staged through host memory pays per
    # layer (the script's time limit)
    "llama2-7b": (2, ("mixed/fp4_e2m1", "two_phase/bf16", "split-overlap4/bf16",
                      "whole/fp4_e2m1", "prefix/fp4_e2m1", "corrupt@3/fp4_e2m1", "ttft"), 16),
    "llama2-13b": (4, ("mixed/fp4_e2m1", "ttft"), 10),
    "mixtral-8x22b": (2, ("mixed/fp4_e2m1",), 2),
    # layers 0-4: Mamba, Mamba + MoE twice, then attention (about 14.3 GB)
    "jamba-v0.1-52b": (2, ("whole/fp4_e2m1",), 5),
    # whole-prompt only, at full width and depth (13.6 GB of weights a rank,
    # embed and lm_head whole on each):
    # the 256-patch prefix ahead of each prompt, made whole by one dense
    # all-gather a prefill
    "pixtral-12b": (2, ("whole/fp4_e2m1", "ttft"), None),
    # whole-prompt only, 24 + 24 layers: each prefill runs the encoder over
    # 1500 frames (48 of its 120 compressed reductions) on the rank's heads
    "whisper-medium": (2, ("whole/fp4_e2m1", "ttft"), None),
    # whole-prompt only, full depth: each rank holds half the mLSTM heads
    # and the sLSTM FF columns, every sLSTM gate whole; 12 compressed
    # reductions and 10 dense all-reduces (q/k/v/i/f) a pass
    "xlstm-125m": (2, ("whole/fp4_e2m1", "ttft"), None),
}
TP_TTFT = 512          # measure_ttft's prompt tokens in the TP phase (text tokens)
TP_TTFT_TOKENS = {"whisper-medium": 64}   # a model whose decoder prompts are short
TP_CUT_LAYERS = 2      # the depth-cut model whose logits are held too
TP_DENSE_SHARE = 0.25  # dense rank vs simulated logits, at most this share of what
                       # compression moves them
TP_FLIP_MARGIN = 2.0   # the compressed bound's margin over tp_flip_share


def tp_flip_share(rel_dense: float) -> float:
    """How far the rank path's compressed logits may lie from the simulated
    path's, as a share of what compression moves them (rel-L2), given
    ``rel_dense``, the dense paths' rel-L2 in the same run. The ranks' GEMMs
    have other shapes than the simulated ones, so their bf16 results round
    differently: a relative perturbation r of what is quantized. fp4_e2m1's
    neighbouring codes lie s ~ 1/2 of a value apart, so a fraction ~ 2r/s of
    the codes flips, each by one gap, where the quantization error has an
    RMS of a gap over sqrt(12): the flips add sqrt(12 * 2r / s) = sqrt(48 r)
    of the quantization noise, and the network carries both alike. r is
    read from the dense comparison (the same GEMMs without the codec)."""
    return math.sqrt(48 * rel_dense)


def tp_context(group, n, policy):
    """``policy`` over the TP group, or over ``simulate_tp = n`` without one."""
    from repro_torch.core.tp import TPContext

    if group is None:
        return TPContext(policy=policy, simulate_tp=n)
    return TPContext(policy=policy, tp_group=group)


def first_logits(torch, dev, model, params, ctx, prompt):
    """The logits of one mixed step that prefills ``prompt`` (one slot) over
    fresh fp4 pools: the first step of a served run, as fp32 numpy (what a
    rank hands its parent holds no torch tensor: a tensor would travel as
    a file descriptor that dies with the rank). A recurrent stack, a vision
    prefix or an encoder-decoder (no mixed step) gives its whole-prompt
    prefill's logits at the exact length, with the first request's extra
    inputs (``stubs``, the same on every rank)."""
    import numpy as np

    from repro_torch.core.formats import KVCacheSpec
    from repro_torch.models.model import recurrent_layer
    from repro_torch.serving import init_paged_state

    extra = stubs(model.cfg, 1)
    if recurrent_layer(model.cfg) is not None or extra:
        cache = model.init_cache(1, n_prefix(model.cfg) + len(prompt), torch.bfloat16, dev,
                                 ctx=ctx)
        tokens = torch.tensor(np.asarray(prompt), device=dev, dtype=torch.int32)[None]
        batch = {"tokens": tokens, **{k: v.to(dev) for k, v in (extra or {}).items()}}
        logits, _ = model.prefill(ctx, params, batch, cache)
        return logits[0].float().cpu().numpy()
    spec = KVCacheSpec.parse("fp4_e2m1")
    t = len(prompt)
    nb = -(-t // BS)
    state = init_paged_state(model.local_cfg(ctx), 2, 2 * nb + 1, BS, torch.bfloat16,
                             cache_spec=spec, device=dev)
    i32 = lambda a: torch.tensor(np.asarray(a), device=dev, dtype=torch.int32)
    tables = torch.zeros((2, nb), device=dev, dtype=torch.int32)
    tables[0] = torch.arange(1, nb + 1, device=dev, dtype=torch.int32)
    logits, _ = model.mixed_step(ctx, params, i32(prompt)[None], state, i32(np.zeros(t)),
                                 i32(np.arange(t)), torch.ones(t, dtype=torch.bool, device=dev),
                                 torch.zeros(t, dtype=torch.bool, device=dev), i32([0, 0]),
                                 tables, i32([t - 1, 0]), cache_spec=spec)
    return logits[0].float().cpu().numpy()


def tp_partials(torch, n, rows, width):
    """(n, rows, width) bf16 partials at row_linear's spread of scales, from
    seed 7 on the CPU (the same on every process)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(n, rows, width, generator=g)
    return (x * torch.pow(10.0, torch.rand(n, rows, 1, generator=g) * 4 - 2)).to(torch.bfloat16)


def tp_serve(torch, dev, group, n, model, params, runs_wanted, label):
    """The TP phase's runs of ``model`` on this rank of ``group`` (None: the
    single-rank engine over ``simulate_tp = n`` they are held to), each held
    as ``serve_run`` holds it (on a TP group its collectives counted with
    the launches): (a) ``mixed/fp4_e2m1`` under PAPER_DEFAULT; (b)
    ``two_phase/bf16``; (c) ``split-overlap4/bf16``, the split scheduler
    with ``overlap_chunks=4``; (d) ``whole/fp4_e2m1``, whole-prompt prefill,
    and ``prefix/fp4_e2m1``, the mixed engine with the prefix cache, a cold
    run then a warm one (the engine's prefix cache rides on chunked
    prefill); (e) ``corrupt@3/fp4_e2m1``, supervised; (f) ``ttft``:
    measure_ttft at TP_TTFT text tokens (``TP_TTFT_TOKENS`` for a model
    with short prompts), compressed against uncompressed. A vision model
    or an encoder-decoder serves its runs with its extra inputs (``stubs``,
    drawn from seed 0 on the host: the same on every rank) and is held to
    one dense all-gather of its prefix a prefill and to 1/n of the cross K/V
    per rank. Also the first mixed step's logits, compressed and dense.
    Returns (runs, totals)."""
    import dataclasses

    import numpy as np

    from repro_torch.core.collectives import reset_tp_counts, tp_counts
    from repro_torch.core.policy import NO_COMPRESSION, PAPER_DEFAULT
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, EngineSupervisor, FaultPlan
    from repro_torch.serving.kv_cache import cross_state_bytes, recurrent_state_bytes

    cfg = model.cfg
    L = cfg.n_layers
    pre = n_prefix(cfg)
    extra = stubs(cfg, SLOTS)
    ttft_len = TP_TTFT_TOKENS.get(cfg.name, TP_TTFT)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, SHARD_PROMPT).astype(np.int32)
               for _ in range(SLOTS)]
    shared = rng.integers(0, cfg.vocab_size, SHARD_PROMPT // 2).astype(np.int32)
    shared_prompts = [np.concatenate([shared, p[SHARD_PROMPT // 2:]]) for p in prompts]
    runs, totals = {}, {k: 0 for k in KERNELS}
    serve = functools.partial(serve_run, torch, dev, runs, totals, L, new=SHARD_NEW, extra=extra)
    ctx = functools.partial(tp_context, group, n)
    comp = ctx(PAPER_DEFAULT)
    max_len = pre + SHARD_PROMPT + SHARD_NEW
    kw = dict(max_slots=SLOTS, max_len=max_len, block_size=BS, device=dev)
    mixed = dict(kw, prefill_chunk=CHUNK, token_budget=T)

    def held(name, eng):
        b = eng.pool_bytes_held()
        check(b == eng.kv_pool_bytes(per_device=True) == eng.kv_pool_bytes() // eng.tp_size,
              f"{label}{name}: this rank holds {b} pool bytes, not "
              f"{eng.kv_pool_bytes(per_device=True)} of {eng.kv_pool_bytes()}")
        rec = sum(t.numel() * t.element_size() for c in eng._state["rec"] for t in c)
        # an sLSTM layer's state is whole on every rank, the rest 1/n
        whole = 4 * 4 * cfg.d_model * eng.n_slots * sum(sp.kind == "slstm" for sp in cfg.layers)
        check(rec == eng.rec_state_bytes()
              and (rec - whole) * eng.tp_size == recurrent_state_bytes(cfg, eng.n_slots) - whole,
              f"{label}{name}: this rank holds {rec} bytes of recurrent state, not 1/"
              f"{eng.tp_size} of {recurrent_state_bytes(cfg, eng.n_slots) - whole} plus the "
              f"whole sLSTM state ({whole})")
        cross = cross_bytes_held(eng)
        check(cross == cross_state_bytes(eng.cfg, eng.n_slots)
              and cross * eng.tp_size == cross_state_bytes(cfg, eng.n_slots)
              and all(t.shape[-1] == eng.cfg.kv_dim for t in eng._state.get("cross_k", [])),
              f"{label}{name}: this rank holds {cross} bytes of cross K/V, not 1/"
              f"{eng.tp_size} of {cross_state_bytes(cfg, eng.n_slots)} at kv_dim "
              f"{eng.cfg.kv_dim}")
        runs[label + name].update(pool_bytes_held=b, transport=eng.ctx.transport,
                                  rec_bytes_held=rec, cross_bytes_held=cross)

    engines = {
        "mixed/fp4_e2m1": lambda: Engine(model, params, comp, cache_spec="fp4_e2m1", **mixed),
        "two_phase/bf16": lambda: Engine(model, params, ctx(dataclasses.replace(
            PAPER_DEFAULT, variant="two_phase", strict_variant=True)), cache_spec="bf16",
            **mixed),
        "split-overlap4/bf16": lambda: Engine(model, params, ctx(dataclasses.replace(
            PAPER_DEFAULT, overlap_chunks=4)), prefill_chunk=CHUNK, token_budget=0,
            cache_spec="bf16", **kw),
        "whole/fp4_e2m1": lambda: Engine(model, params, comp, prefill_chunk=0,
                                         cache_spec="fp4_e2m1", **kw),
    }
    for name in runs_wanted:
        if name in engines:
            eng = engines[name]()
            serve(label + name, eng, prompts)
            held(name, eng)
            del eng
        elif name == "prefix/fp4_e2m1":
            # 32-token chunks: a lossy pool's warm match resumes at a chunk
            # boundary, and a 256-token chunk would hold the whole prompt
            eng = Engine(model, params, comp, cache_spec="fp4_e2m1", prefix_cache=True,
                         persistent_cache=True, n_blocks=2 * SLOTS * (-(-max_len // BS)) + 2,
                         **dict(mixed, prefill_chunk=2 * BS))
            for run in ("run1", "run2"):
                serve(f"{label}{name}/{run}", eng, shared_prompts, warm=False)
                held(f"{name}/{run}", eng)
            check(runs[f"{label}{name}/run2"]["summary"]["prefill_tokens_skipped"] > 0,
                  f"{label}{name}: the warm run skipped no prompt token")
            del eng
        elif name == "corrupt@3/fp4_e2m1":
            eng = Engine(model, params, comp, cache_spec="fp4_e2m1",
                         fault_plan=FaultPlan.parse("corrupt@3"), **mixed)
            sup = EngineSupervisor(eng, backoff_s=0.0)
            serve(label + name, eng, prompts, sup=sup)
            events = [(e.error, e.mode) for e in sup.events]
            check(events == [("WireCorruption", "hard")], f"{label}{name}: recoveries {events}")
            runs[label + name]["events"] = [(e.error, e.mode, e.n_replayed, e.detail)
                                            for e in sup.events]
            held(name, eng)
            del eng, sup
        elif name == "ttft":
            ttft = {}
            for kind, policy in (("compressed", PAPER_DEFAULT), ("uncompressed", NO_COMPRESSION)):
                eng = Engine(model, params, ctx(policy), max_slots=1, max_len=pre + ttft_len,
                             block_size=BS, prefill_chunk=0, device=dev)
                reset_launch_counts()
                reset_tp_counts()
                r = eng.measure_ttft(ttft_len, iters=TTFT_ITERS, extra_inputs=first_rows(extra))
                got, c = launch_counts(), tp_counts()
                R = row_reductions(cfg)
                m = int(policy.enabled) * TTFT_ITERS * R
                expect = {"mx_quant": m, "mx_dequant": 0, "mx_dequant_reduce": m,
                          "paged_attention": 0}
                if dev == "cuda":
                    check(got == expect, f"{label}ttft/{kind}: launches {got} != {expect}")
                if eng.tp_size > 1:
                    want = (2 * m, TTFT_ITERS * (R + dense_reductions(cfg)) - m,
                            TTFT_ITERS * (cfg.frontend == "vision"))
                    check((c["all_gather"], c["all_reduce"], c["dense_all_gather"]) == want,
                          f"{label}ttft/{kind}: collectives {c} != {want}")
                for k in totals:
                    totals[k] += got[k]
                ttft[kind] = dict(r, launches=got, tp=c)
                log(f"{label}ttft[{ttft_len} tokens, {kind}]: median {r['median_s'] * 1e3:.2f} "
                    f"ms, std {r['std_s'] * 1e3:.2f} ms over {r['iters']} prefills; "
                    + (f"{c['all_gather']} all-gathers, {c['all_reduce']} all-reduces, "
                       f"{c['dense_all_gather']} dense all-gathers, "
                       f"{c['bytes'] / 1e6:.2f} MB sent, {c['seconds'] * 1e3:.1f} ms host "
                       f"({eng.ctx.transport})" if eng.tp_size > 1 else "one process"))
                del eng
            runs[label + "ttft"] = dict(ttft, tokens=ttft_len)
    runs[label + "logits"] = {
        "compressed": first_logits(torch, dev, model, params, comp, prompts[0]),
        "dense": first_logits(torch, dev, model, params, ctx(NO_COMPRESSION), prompts[0])}
    return runs, totals


def cut_logits(torch, dev, group, n, cfg):
    """``first_logits`` (compressed and dense) of ``cfg`` cut to its first
    TP_CUT_LAYERS layers at full width, on seed-0 weights (this rank's
    shard on a TP group), for the prompt ``tp_serve`` serves first."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch.core.policy import NO_COMPRESSION, PAPER_DEFAULT
    from repro_torch.models.model import Model

    cut = dataclasses.replace(cfg, n_layers=TP_CUT_LAYERS, layers=cfg.layers[:TP_CUT_LAYERS])
    rank = dist.get_rank(group) if group is not None else 0
    model = Model(cut)
    params = model.init_params(device=dev, seed=0, tp=(rank, n) if group is not None else (0, 1))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, SHARD_PROMPT).astype(np.int32)
    return {kind: first_logits(torch, dev, model, params, tp_context(group, n, policy), prompt)
            for kind, policy in (("compressed", PAPER_DEFAULT), ("dense", NO_COMPRESSION))}


def _tp_rank(group, rank, dev, cfg, n, runs_wanted):
    """One rank of ``phase_tp``: open the kernels the parent built, draw its
    shard of ``cfg``'s seed-0 weights, serve ``tp_serve``'s runs, and reduce
    its slice of the collective probe (gather and two_phase). Only rank 0
    prints."""
    import torch

    from repro_torch.core.collectives import rank_compressed_psum, transport
    from repro_torch.core.policy import PAPER_DEFAULT
    from repro_torch.kernels.build import load_kernels
    from repro_torch.models.model import Model

    _QUIET[0] = rank != 0
    cuda = dev.type == "cuda"
    if cuda:
        load_kernels(build=False)
    model = Model(cfg)
    params = model.init_params(device=dev, seed=0, tp=(rank, n))
    weight_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    experts = expert_bytes(params)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runs, totals = tp_serve(torch, dev.type, group, n, model, params, runs_wanted, "tp ")
    if cfg.n_layers > TP_CUT_LAYERS:
        runs["tp cut logits"] = cut_logits(torch, dev, group, n, cfg)
    x = tp_partials(torch, n, T, cfg.d_model)[rank].to(dev)
    probe = {v: rank_compressed_psum(x, group, PAPER_DEFAULT.spec, variant=v, strict=True)
             .cpu().view(torch.int16).numpy() for v in ("gather", "two_phase")}
    return dict(runs=runs, totals=totals, device=str(dev), transport=transport(group),
                probe=probe, weight_gb=weight_gb, expert_bytes=experts,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None)


def rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_tp(torch, card, dev="cuda", cfg=None):
    """Tensor parallelism across ranks (``TP_MODELS``): llama2-7b at full
    width on its first 16 layers on 2 ranks, runs (a)-(f) of ``tp_serve``;
    llama2-13b on its first 10 on 4 ranks, runs (a) and (f). Each model's single-rank engine over
    ``simulate_tp = n`` runs first in this process on the same seed-0
    weights and prompts and is freed; then n ranks (spawned processes:
    NCCL with a card each, else gloo with the exchanges staged through host
    memory; ``launch/mesh.py``) serve the same runs, each with its shard of
    the weights and of the pools. Held: every rank's tokens identical to
    rank 0's; each rank's pool bytes 1/n of the simulated engine's; launches
    and collectives exact per rank; the first mixed step's logits, at full
    depth and cut to TP_CUT_LAYERS layers: dense within TP_DENSE_SHARE of
    what compression moves them, compressed within TP_FLIP_MARGIN x
    ``tp_flip_share`` of it; and the rank collective bit-identical to the simulated
    reduction on the same partials at the model's reduction shape, for the
    gather and two_phase variants. mixtral-8x22b at full width cut to its
    first 2 layers on 2 ranks, run (a): each rank holds half of every
    expert's ``d_ff`` (its routed-expert bytes half the single-rank
    model's), and one dense all-reduce per MoE layer and step reduces the
    routed experts. jamba layers 0-4 on 2 ranks, whole-prompt. pixtral-12b
    at full width and depth and whisper-medium at full depth (24 + 24
    layers, 1500 frames) on 2 ranks, whole-prompt and ``measure_ttft``:
    each rank holds half the cross K/V, pixtral's prefix is one dense
    all-gather a prefill. xlstm-125m at full depth on 2 ranks, whole-prompt
    and ``measure_ttft``: each rank holds half the mLSTM heads and state and
    the whole sLSTM state. Prints the transport, the collectives
    per step, the tokens identical to the simulated run's (counted: bf16
    GEMMs of other shapes round differently, and random weights have near
    ties), and TTFT. (``dev="cpu"`` and a reduced ``cfg`` rehearse it.)"""
    from repro_torch.configs import first_layers, get_config
    from repro_torch.core.collectives import compressed_psum
    from repro_torch.core.policy import PAPER_DEFAULT
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    from repro_torch.models.model import Model

    cuda = dev == "cuda"
    totals = {k: 0 for k in KERNELS}
    out = {}
    for arch, (n, runs_wanted, layers) in TP_MODELS.items():
        mcfg = cfg or first_layers(get_config(arch), layers or 0)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        model = Model(mcfg)
        t0 = time.perf_counter()
        params = model.init_params(device=dev, seed=0)
        sim_experts = expert_bytes(params)
        log(f"tp[{arch}]: {mcfg.n_layers} layers d_model {mcfg.d_model}, "
            f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB of "
            f"seed-0 weights in {time.perf_counter() - t0:.1f} s; the simulate_tp={n} engine "
            f"first")
        sim, _ = tp_serve(torch, dev, None, n, model, params, runs_wanted, "simulated ")
        if mcfg.n_layers > TP_CUT_LAYERS:
            sim["simulated cut logits"] = cut_logits(torch, dev, None, n, mcfg)
        stacked = tp_partials(torch, n, T, mcfg.d_model).to(dev)
        want = {"gather": compressed_psum(stacked, PAPER_DEFAULT.spec)}
        spec = PAPER_DEFAULT.spec
        want["two_phase"] = ops.mx_dequantize(ops.mx_quantize(want["gather"], spec), spec,
                                              out_dtype=torch.bfloat16)
        want = {k: v.cpu().view(torch.int16).numpy() for k, v in want.items()}
        del params, model, stacked
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks = spawn_ranks(_tp_rank, n, mcfg, n, runs_wanted, device=dev, timeout_s=900,
                            threads=0 if cuda else 2)
        wall = time.perf_counter() - t0
        transport = ranks[0]["transport"]
        check(transport == ("nccl" if backend_for(n, dev) == "nccl" else "gloo-staged"),
              f"tp[{arch}]: transport {transport}")
        where = ("NCCL, one card per rank" if transport == "nccl" else
                 "gloo, exchanges staged through host memory, eager steps" +
                 (": the ranks share one card, not NVLink" if cuda else ""))
        log(f"tp[{arch}]: {n} ranks on {card} over {where}; {wall:.1f} s with start-up; "
            f"{ranks[0]['weight_gb']:.2f} GB of weights per rank")
        for i, r in enumerate(ranks):
            check(r["expert_bytes"] * n == sim_experts,
                  f"tp[{arch}]: rank {i} holds {r['expert_bytes']} routed-expert bytes, not "
                  f"1/{n} of {sim_experts}")
        if sim_experts:
            log(f"tp[{arch}]: each rank holds {ranks[0]['expert_bytes'] / 1e9:.2f} GB of routed "
                f"experts, 1/{n} of {sim_experts / 1e9:.2f} GB (every expert, 1/{n} of its "
                f"d_ff)")
        for r in ranks:
            for k in totals:
                totals[k] += r["totals"][k]
        for v in ("gather", "two_phase"):
            for i, r in enumerate(ranks):
                check((r["probe"][v] == want[v]).all(),
                      f"tp[{arch}]: rank {i}'s {v} reduction differs from the simulated one")
        log(f"tp[{arch}]: the rank collective is bit-identical to the simulated reduction on "
            f"the same ({n}, {T}, {mcfg.d_model}) bf16 partials, gather and two_phase, on "
            f"every rank")
        logit_checks = []
        for name, rr in sim.items():
            case = name.split(" ", 1)[1]
            got = [r["runs"]["tp " + case] for r in ranks]
            if case.endswith("logits"):
                for i, g in enumerate(got):
                    for k in ("compressed", "dense"):
                        check((g[k] == got[0][k]).all(),
                              f"tp[{arch}] {case}: rank {i}'s {k} logits differ from rank 0's")
                rel_q = rel_l2(rr["compressed"], rr["dense"])
                rel_c = rel_l2(got[0]["compressed"], rr["compressed"])
                rel_d = rel_l2(got[0]["dense"], rr["dense"])
                rel_x = rel_l2(got[0]["compressed"], rr["dense"])
                out.setdefault(arch, {})[case.replace(" ", "_") + "_rel_l2"] = dict(
                    compressed=rel_c, dense=rel_d, compression=rel_q, rank_c_vs_sim_dense=rel_x)
                log(f"tp[{arch}] {case} (first step): rel-L2 rank vs simulated "
                    f"{rel_c:.4g} compressed (bound {TP_FLIP_MARGIN} x sqrt(48 x {rel_d:.4g}) "
                    f"x {rel_q:.4g} = {TP_FLIP_MARGIN * tp_flip_share(rel_d) * rel_q:.4g}), "
                    f"{rel_d:.4g} dense (bound {TP_DENSE_SHARE} x {rel_q:.4g}); compression "
                    f"itself moves them {rel_q:.4g}; rank compressed vs simulated dense "
                    f"{rel_x:.4g}")
                logit_checks.append((case, rel_c, rel_d, rel_q))
                continue
            if case == "ttft":
                for kind in ("compressed", "uncompressed"):
                    log(f"tp[{arch}] ttft[{rr['tokens']} tokens, {kind}]: {n} ranks median "
                        f"{got[0][kind]['median_s'] * 1e3:.2f} ms ({transport}); "
                        f"simulate_tp={n} in one process {rr[kind]['median_s'] * 1e3:.2f} ms")
                ratio = lambda t: t["compressed"]["median_s"] / t["uncompressed"]["median_s"]
                log(f"tp[{arch}] ttft[{rr['tokens']} tokens]: compressed / uncompressed "
                    f"{ratio(got[0]):.4f} on {n} ranks ({transport}), {ratio(rr):.4f} "
                    f"simulated in one process")
                continue
            for i, g in enumerate(got):
                check(g["outputs"] == got[0]["outputs"],
                      f"tp[{arch}] {case}: rank {i}'s tokens differ from rank 0's")
                check(g["pool_bytes_held"] * n == rr["pool_bytes"] == g["pool_bytes"],
                      f"tp[{arch}] {case}: rank {i} holds {g['pool_bytes_held']} pool bytes, "
                      f"not 1/{n} of {rr['pool_bytes']}")
                check(g.get("events") == rr.get("events"),
                      f"tp[{arch}] {case}: rank {i}'s recoveries {g.get('events')} differ "
                      f"from {rr.get('events')}")
            same = sum(a == b for a, b in zip(got[0]["outputs"], rr["outputs"]))
            c, s = got[0]["tp"], got[0]["summary"]
            steps = max(s["n_steps"], 1)
            log(f"tp[{arch}] {case}: tokens identical on {n} ranks; {same} of "
                f"{len(rr['outputs'])} requests decode the simulated run's tokens; "
                f"{got[0]['pool_bytes_held'] / 1e6:.2f} MB of pools per rank of "
                f"{got[0]['pool_mb']:.2f} MB"
                + (f" ({got[0]['cross_bytes_held'] / 1e6:.2f} MB of it cross K/V)"
                   if got[0].get("cross_bytes_held") else "")
                + (f"; {c['dense_all_gather']} dense prefix all-gathers "
                   f"({c['dense_all_gather_bytes'] / 1e6:.2f} MB)" if c["dense_all_gather"]
                   else "")
                + f"; per step {c['all_gather'] / steps:.1f} "
                f"all-gathers, {c['all_to_all'] / steps:.1f} all-to-alls, "
                f"{c['all_reduce'] / steps:.1f} all-reduces, {c['bytes'] / steps / 1e6:.3f} MB "
                f"sent and {c['seconds'] / steps * 1e3:.2f} ms host per rank ({transport}); "
                f"TPOT p50 {s['tpot_p50_s'] * 1e3:.2f} ms on {n} ranks vs "
                f"{rr['summary']['tpot_p50_s'] * 1e3:.2f} ms simulated in one process")
            got[0]["same_as_simulated"] = same
        for case, rel_c, rel_d, rel_q in logit_checks:
            bound_c = TP_FLIP_MARGIN * tp_flip_share(rel_d) * rel_q
            check(math.isfinite(rel_c) and rel_c <= bound_c and rel_d <= TP_DENSE_SHARE * rel_q,
                  f"tp[{arch}] {case}: rel-L2 rank vs simulated {rel_c:.4g} compressed (bound "
                  f"{bound_c:.4g}), {rel_d:.4g} dense (bound {TP_DENSE_SHARE} x {rel_q:.4g})")
        for i, r in enumerate(ranks):
            log(f"tp[{arch}]: rank {i} ({r['device']}) peak device memory "
                + (f"{r['peak_gb']:.2f} GB" if cuda else "not measured (no card)"))
        out.setdefault(arch, {}).update(
            ranks=n, transport=transport, wall_s=wall,
            simulated={k: v for k, v in sim.items() if not k.endswith("logits")},
            rank_runs=[{k: v for k, v in r["runs"].items() if not k.endswith("logits")}
                       for r in ranks],
            peak_gb=[r["peak_gb"] for r in ranks], weight_gb=ranks[0]["weight_gb"])
    log(f"tp: card {card}")
    return out, totals


# ------------------------------------------------------------------------- dp

DP_GRID = (2, 2)   # (data, model) ranks on the one card: make_host_mesh(data=2, model=2)
DP_SLOTS = 128     # the split decode's batch: above 64 and even, so it enters the island
# the dp phase's models -> layers served (None: the depth ``grid_depth`` finds)
DP_MODELS = {"mixtral-8x22b": None, "llama4-maverick-400b-a17b": 2}
DP_RUNS = ("compressed", "dense", "compressed-a2a")   # the island's policies, in order
CONTEXT_GB = 0.6   # a process's CUDA context and allocator slack on the card


def dp_policy(run):
    """PAPER_DEFAULT, NO_COMPRESSION, or PAPER_DEFAULT with compressed
    all-to-alls."""
    import dataclasses

    from repro_torch.core.policy import NO_COMPRESSION, PAPER_DEFAULT

    if run == "dense":
        return NO_COMPRESSION
    return dataclasses.replace(PAPER_DEFAULT, compress_all_to_all=run == "compressed-a2a")


def island_rows(cfg) -> int:
    """Rows of the island's ``down`` partial (dp, E/dp, C, d) at one rank of
    the dp phase: dp x E/dp x the capacity of DP_SLOTS / dp tokens."""
    from repro_torch.models.moe import capacity

    return cfg.n_experts * capacity(cfg, DP_SLOTS // DP_GRID[0])


def grid_rank_bytes(cfg) -> int:
    """bf16 bytes of the weights one rank of the DP_GRID holds: its TP
    shard of its data rank's experts (``param_shapes`` of the rank-local
    config)."""
    from repro_torch.models.model import param_shapes

    return 2 * sum(math.prod(shape) for shape in
                   _leaves(param_shapes(cfg.tp_shard(DP_GRID[1], DP_GRID[0]))))


def grid_depth(torch, dev, cfg, margin_gb=8.0, kv=1):
    """The largest prefix of ``cfg``'s schedule whose weights on the
    DP_GRID's ranks (``grid_rank_bytes`` each), on ``kv`` such grids (a kv
    x data x model grid: the same weights on each, 1/kv of the pools), their
    pools and CUDA contexts and ``margin_gb`` fit the card's free memory
    (every rank on the one card; ``cfg`` itself on the CPU). Returns
    (config, free bytes)."""
    from repro_torch.configs import first_layers

    if dev != "cuda":
        return cfg, None
    free = torch.cuda.mem_get_info()[0]
    ranks = kv * DP_GRID[0] * DP_GRID[1]
    blocks = DP_SLOTS * (-(-(SHARD_PROMPT + SHARD_NEW) // BS)) + 1

    def need(n):
        prefix = first_layers(cfg, n)
        pools = 2 * blocks * BS * cfg.kv_dim // DP_GRID[1] * 2 * attn_layers(prefix) // kv
        return ranks * (grid_rank_bytes(prefix) + pools + CONTEXT_GB * 1e9) + margin_gb * 1e9

    n = cfg.n_layers
    while n > 1 and need(n) > free:
        n -= 1
    return first_layers(cfg, n), free


def dp_serve(torch, dev, grid, model, params):
    """The dp phase's runs of ``model`` on this rank of the grid: the split
    scheduler with DP_SLOTS slots on fp4 pools, SLOTS requests of
    SHARD_PROMPT + SHARD_NEW tokens, under each policy of DP_RUNS (the
    decode compressed too when the policy is), each held as ``serve_run``
    holds it (launches and collectives exact, the island's included).
    Returns (runs, totals); each run adds its decode steps and the island's
    counters."""
    import numpy as np

    from repro_torch.core.tp import TPContext
    from repro_torch.serving import Engine

    cfg = model.cfg
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, SHARD_PROMPT).astype(np.int32)
               for _ in range(2 * SLOTS)]
    runs, totals = {}, {k: 0 for k in KERNELS}
    for run in DP_RUNS:
        policy = dp_policy(run)
        ctx = TPContext(policy=policy, tp_group=grid.tp_group, dp_group=grid.dp_group)
        eng = Engine(model, params, ctx, max_slots=DP_SLOTS, max_len=SHARD_PROMPT + SHARD_NEW,
                     block_size=BS, prefill_chunk=CHUNK, token_budget=0, cache_spec="fp4_e2m1",
                     compress_decode=policy.enabled, device=dev)
        name = f"dp {run}"
        serve_run(torch, dev, runs, totals, cfg.n_layers, name, eng, prompts, new=SHARD_NEW)
        runs[name]["n_decode_steps"] = sum(1 for _, d in eng.stats.step_tokens if d)
        runs[name]["transport"] = eng.ctx.transport
        runs[name]["pool_bytes_held"] = eng.pool_bytes_held()
        del eng
    return runs, totals


def _dp_rank(grid, rank, dev, cfg):
    """One rank of ``phase_dp``'s grid: open the kernels the parent built,
    draw its shard of ``cfg``'s seed-0 weights (its model rank's columns of
    its data rank's experts), serve ``dp_serve``'s runs. Only rank 0
    prints."""
    import torch

    from repro_torch.kernels.build import load_kernels
    from repro_torch.models.model import Model

    _QUIET[0] = rank != 0
    cuda = dev.type == "cuda"
    if cuda:
        load_kernels(build=False)
    model = Model(cfg)
    params = model.init_params(device=dev, seed=0, tp=(grid.tp_rank, grid.tp),
                               dp=(grid.dp_rank, grid.dp))
    weight_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runs, totals = dp_serve(torch, dev.type, grid, model, params)
    return dict(runs=runs, totals=totals, device=str(dev), weight_gb=weight_gb,
                expert_bytes=expert_bytes(params), grid=(grid.dp_rank, grid.tp_rank),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None)


def phase_dp(torch, card, dev="cuda", cfg=None):
    """Data-parallel ranks and the MoE expert-parallel island (``DP_MODELS``):
    each model at full width on a 2 x 2 ``data x model`` grid of ranks
    (``spawn_ranks(..., tp=2)``; with one card the ranks share it over
    gloo, every exchange staged through host memory, eager steps; with a
    card per rank NCCL and graphed steps), mixtral-8x22b on
    the largest prefix of its schedule the four ranks' shards fit
    (``grid_depth``) and llama4-maverick on its first 2 layers (a dense
    layer, then a MoE layer of 128 experts); each rank holds its model
    rank's half of the heads and of every expert's ``d_ff`` for its data
    rank's half of the experts. The split scheduler with DP_SLOTS slots
    serves SLOTS x 2 requests of SHARD_PROMPT + SHARD_NEW tokens on fp4
    pools under each of DP_RUNS: every decode step (DP_SLOTS rows in 2
    groups) runs the island in each MoE layer, whose ``down`` partials are
    reduced by the paper's compressed collective under PAPER_DEFAULT
    (compressed, compressed-a2a: the decode compresses too) and whose
    dispatch and combine all-to-alls are compressed under
    ``compress_all_to_all``; chunks (one batch row) sum the experts'
    partials densely. Held: the four ranks' tokens identical in every run,
    launches and collectives exact per rank (``expected_launches``), the
    island entered in every MoE layer of every decode step (a run without
    an island entry fails), each rank holding a quarter of the routed
    experts' bytes. Prints per step the island's ``down`` bytes, the
    all-to-alls' and the data all-gather's bytes against the dense run's,
    and TPOT. (``dev="cpu"`` and a reduced ``cfg`` rehearse it.)"""
    from repro_torch.configs import first_layers, get_config
    from repro_torch.launch.mesh import spawn_ranks

    cuda = dev == "cuda"
    totals = {k: 0 for k in KERNELS}
    out = {}
    dp, tp = DP_GRID
    for arch, layers in DP_MODELS.items():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        full = cfg or get_config(arch)
        if layers:
            mcfg, free = first_layers(full, layers), None
        else:
            mcfg, free = grid_depth(torch, dev, full)
        moe_l = moe_layers(mcfg)
        esize = 2 if mcfg.dtype == "bfloat16" else 4
        whole_experts = esize * moe_l * mcfg.n_experts * 3 * mcfg.d_model * mcfg.d_ff
        log(f"dp[{arch}]: {mcfg.n_layers} of {full.n_layers} layers ({moe_l} MoE) at d_model "
            f"{mcfg.d_model} on a {dp} x {tp} data x model grid of ranks ({card})"
            + (f"; {free / 1e9:.1f} GB free, {grid_rank_bytes(mcfg) / 1e9:.2f} GB of weights a "
               f"rank" if free else ""))
        t0 = time.perf_counter()
        ranks = spawn_ranks(_dp_rank, dp * tp, mcfg, device=dev, timeout_s=900,
                            threads=0 if cuda else 1, tp=tp)
        wall = time.perf_counter() - t0
        check([r["grid"] for r in ranks] == [(d, m) for d in range(dp) for m in range(tp)],
              f"dp[{arch}]: ranks sit at {[r['grid'] for r in ranks]} on the grid")
        for i, r in enumerate(ranks):
            check(r["expert_bytes"] * dp * tp == whole_experts,
                  f"dp[{arch}]: rank {i} holds {r['expert_bytes']} routed-expert bytes, not "
                  f"1/{dp * tp} of {whole_experts}")
            for k in totals:
                totals[k] += r["totals"][k]
        transport = ranks[0]["runs"]["dp dense"]["transport"]
        where = ("NCCL, one card per rank, graphed steps" if transport == "nccl" else
                 "gloo, exchanges staged through host memory, eager steps"
                 + (", the ranks share one card, not NVLink" if cuda else ""))
        log(f"dp[{arch}]: {dp * tp} ranks ({where}), {wall:.1f} s with start-up; "
            f"{ranks[0]['weight_gb']:.2f} GB of weights a "
            f"rank, {ranks[0]['expert_bytes'] / 1e9:.2f} GB of it routed experts (1/{dp * tp} "
            f"of {whole_experts / 1e9:.2f} GB)")
        dense = ranks[0]["runs"]["dp dense"]
        for run in DP_RUNS:
            got = [r["runs"][f"dp {run}"] for r in ranks]
            for i, g in enumerate(got):
                check(g["outputs"] == got[0]["outputs"],
                      f"dp[{arch}] {run}: rank {i}'s tokens differ from rank 0's")
            g = got[0]
            c, n_dec = g["tp"], g["n_decode_steps"]
            steps = max(g["summary"]["n_steps"], 1)
            check(n_dec > 0 and c["island"] == moe_l * n_dec > 0,
                  f"dp[{arch}] {run}: {c['island']} island entries in {n_dec} decode steps of "
                  f"{moe_l} MoE layers")
            check(c["dp_all_gather"] == c["island"]
                  and c["compressed_all_to_all"] == 2 * c["island"] * (run == "compressed-a2a")
                  and c["dense_all_to_all"] == 2 * c["island"] * (run != "compressed-a2a"),
                  f"dp[{arch}] {run}: collectives {c}")
            if run != "dense":
                check(c["island_down_bytes"] < dense["tp"]["island_down_bytes"],
                      f"dp[{arch}] {run}: the island's down reductions sent "
                      f"{c['island_down_bytes']} bytes, the dense run's "
                      f"{dense['tp']['island_down_bytes']}")
            a2a = c["compressed_all_to_all_bytes"] + c["dense_all_to_all_bytes"]
            a2a_d = dense["tp"]["dense_all_to_all_bytes"]
            per = lambda b: b / max(n_dec, 1) / 1e6
            log(f"dp[{arch}] {run}: tokens identical on {dp * tp} ranks; {c['island']} island "
                f"entries ({moe_l} MoE layers x {n_dec} decode steps of {DP_SLOTS} rows); per "
                f"decode step a rank sent {per(c['island_down_bytes']):.3f} MB in the "
                f"island's down reductions (dense {per(dense['tp']['island_down_bytes']):.3f}), "
                f"{per(a2a):.3f} MB in its all-to-alls (dense {per(a2a_d):.3f}), "
                f"{per(c['dp_all_gather_bytes']):.3f} MB in data all-gathers (dense "
                f"{per(dense['tp']['dp_all_gather_bytes']):.3f}); all collectives "
                f"{c['bytes'] / steps / 1e6:.3f} MB and {c['seconds'] / steps * 1e3:.2f} ms host "
                f"per step; TPOT p50 {g['summary']['tpot_p50_s'] * 1e3:.2f} ms; launches "
                f"{g['launches']}")
            same = sum(a == b for a, b in zip(g["outputs"], dense["outputs"]))
            g["same_as_dense"] = same
            if run != "dense":
                log(f"dp[{arch}] {run}: {same} of {len(g['outputs'])} requests decode the "
                    f"dense run's tokens")
        for i, r in enumerate(ranks):
            log(f"dp[{arch}]: rank {i} ({r['device']}) peak device memory "
                + (f"{r['peak_gb']:.2f} GB" if cuda else "not measured (no card)"))
        out[arch] = dict(layers=mcfg.n_layers, moe_layers=moe_l, wall_s=wall,
                         transport=transport, weight_gb=ranks[0]["weight_gb"],
                         island_rows=island_rows(mcfg),
                         runs={run: ranks[0]["runs"][f"dp {run}"] for run in DP_RUNS},
                         peak_gb=[r["peak_gb"] for r in ranks])
    log(f"dp: card {card}")
    return out, totals



# ------------------------------------------------------------------------ kvtp

# the kvtp phase's models -> ((kv, data, model) extents, runs, layers served:
# None for all, 0 for the depth ``grid_depth`` finds for the grid's ranks);
# traffic as phase 7's: SLOTS requests of SHARD_PROMPT + SHARD_NEW tokens
KVTP_MODELS = {
    "llama2-7b": ((2, 1, 2), ("mixed/fp4_e2m1", "split/fp4_e2m1", "prefix/bf16",
                              "capacity/fp4_e2m1"), None),
    "mixtral-8x22b": ((2, 2, 2), ("island/fp4_e2m1",), 0),
}
# the default run's kvtp piece: llama2-7b on kv 2 x model 2 ranks sharing the
# one card over gloo, cut to its first KVTP_DEFAULT_LAYERS layers (a step
# staged through host memory pays per layer: the script's time limit)
KVTP_DEFAULT, KVTP_DEFAULT_LAYERS = "llama2-7b", 4
KVTP_MARGIN_GB = 16.0   # grid_depth's margin for the 8-rank grid (8 GB ran out)


def kvtp_context(grid, policy, sharded):
    """``policy`` over this rank's row (and column), with its kv group when
    ``sharded``, else with replicated pools."""
    from repro_torch.core.tp import TPContext

    return TPContext(policy=policy, tp_group=grid.tp_group, dp_group=grid.dp_group,
                     kv_group=grid.kv_group if sharded else None)


def kvtp_serve(torch, dev, grid, model, params, runs_wanted, sharded):
    """The kvtp phase's runs of ``model`` on this rank of ``grid``, with
    its pools sharded over its kv group (``sharded``) or replicated over it
    (its row and column alone, the anchor), each held as ``serve_run``
    holds it (launches, the exchange's all-reduces and the row's collectives
    exact): ``mixed/fp4_e2m1`` and ``split/fp4_e2m1`` under PAPER_DEFAULT;
    ``prefix/bf16``, the prefix cache on bf16 pools run twice (the warm run
    forks each request's tail block: a copy-on-write over the kv group);
    ``capacity/fp4_e2m1``, one prompt as long as 2 x SHARD_CAP_BLOCKS
    blocks hold, with pools of 2 x SHARD_CAP_BLOCKS blocks (replicated,
    also the refusal of SHARD_CAP_BLOCKS blocks, the per-rank budget);
    ``island/fp4_e2m1``, the split scheduler over DP_SLOTS slots, the
    decode compressed too (a MoE model's island). Each engine's pools held
    in this process are ``kv_pool_bytes(per_device=True)``. Returns (runs,
    totals), run names prefixed with the mode."""
    import numpy as np

    from repro_torch.core.policy import PAPER_DEFAULT
    from repro_torch.serving import Engine, PoolExhausted, Request

    cfg = model.cfg
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, SHARD_PROMPT).astype(np.int32)
               for _ in range(2 * SLOTS)]
    long_s = (2 * SHARD_CAP_BLOCKS - 1) * BS - 4 + 1
    long_prompt = [rng.integers(0, cfg.vocab_size, long_s).astype(np.int32)]
    label = "sharded " if sharded else "replicated "
    runs, totals = {}, {k: 0 for k in KERNELS}
    serve = functools.partial(serve_run, torch, dev, runs, totals, cfg.n_layers, new=SHARD_NEW)
    comp = kvtp_context(grid, PAPER_DEFAULT, sharded)
    max_len = SHARD_PROMPT + SHARD_NEW
    kw = dict(max_slots=SLOTS, max_len=max_len, block_size=BS, prefill_chunk=CHUNK, device=dev)
    cap = dict(max_slots=1, max_len=(2 * SHARD_CAP_BLOCKS - 1) * BS, block_size=BS,
               prefill_chunk=CHUNK, cache_spec="fp4_e2m1", device=dev)

    def held(name, eng):
        b = eng.pool_bytes_held()
        n = eng.kv_shards * eng.tp_size
        check(b == eng.kv_pool_bytes(per_device=True) == eng.kv_pool_bytes() // n,
              f"kvtp {label}{name}: this rank holds {b} pool bytes, not 1/{n} of "
              f"{eng.kv_pool_bytes()}")
        runs[label + name].update(pool_bytes_held=b, n_blocks=eng.n_blocks,
                                  transport=eng.ctx.transport)

    for name in runs_wanted:
        if name in ("mixed/fp4_e2m1", "split/fp4_e2m1"):
            eng = Engine(model, params, comp, token_budget=T if name[0] == "m" else 0,
                         cache_spec="fp4_e2m1", **kw)
            serve(label + name, eng, prompts[:SLOTS])
            held(name, eng)
        elif name == "prefix/bf16":
            eng = Engine(model, params, comp, token_budget=T, cache_spec="bf16",
                         prefix_cache=True, persistent_cache=True,
                         n_blocks=2 * SLOTS * (-(-max_len // BS)) + 2, **kw)
            for run in ("run1", "run2"):
                s = serve(f"{label}{name}/{run}", eng, prompts[:SLOTS], warm=False)[0]
                held(f"{name}/{run}", eng)
            check(s["n_dispatches"] - s["n_steps"] == SLOTS,
                  f"kvtp {label}{name}: {s['n_dispatches'] - s['n_steps']} COW forks, not "
                  f"{SLOTS}")
        elif name == "capacity/fp4_e2m1":
            eng = Engine(model, params, comp, n_blocks=2 * SHARD_CAP_BLOCKS, **cap)
            serve(label + name, eng, long_prompt, new=4)
            held(name, eng)
            runs[label + name]["prompt_tokens"] = long_s
            if not sharded:   # the per-rank budget replicated refuses the prompt
                del eng
                eng = Engine(model, params, comp, n_blocks=SHARD_CAP_BLOCKS, **cap)
                try:
                    eng.run([Request(prompt=long_prompt[0].copy(), max_new_tokens=4)])
                    refused = False
                except PoolExhausted:
                    refused = True
                check(refused, f"kvtp: a replicated engine of {SHARD_CAP_BLOCKS} blocks "
                      f"admitted a {long_s}-token prompt")
                runs[label + name]["budget_bytes"] = eng.pool_bytes_held()
        elif name == "island/fp4_e2m1":
            eng = Engine(model, params, comp, max_slots=DP_SLOTS, max_len=max_len,
                         block_size=BS, prefill_chunk=CHUNK, token_budget=0,
                         cache_spec="fp4_e2m1", compress_decode=True, device=dev)
            serve(label + name, eng, prompts)
            held(name, eng)
            runs[label + name]["n_decode_steps"] = sum(1 for _, d in eng.stats.step_tokens if d)
        del eng
    return runs, totals


def _kvtp_rank(grid, rank, dev, cfg, runs_wanted):
    """One rank of ``phase_kvtp``'s grid: open the kernels the parent built,
    draw its (data, model) position's shard of ``cfg``'s seed-0 weights
    (the same on every kv rank), serve ``kvtp_serve``'s runs with
    replicated pools and then with sharded ones. Only rank 0 prints."""
    import torch

    from repro_torch.kernels.build import load_kernels
    from repro_torch.models.model import Model

    _QUIET[0] = rank != 0
    cuda = dev.type == "cuda"
    if cuda:
        load_kernels(build=False)
    model = Model(cfg)
    params = model.init_params(device=dev, seed=0, tp=(grid.tp_rank, grid.tp),
                               dp=(grid.dp_rank, grid.dp))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runs, totals = {}, {k: 0 for k in KERNELS}
    for sharded in (False, True):
        r, t = kvtp_serve(torch, dev.type, grid, model, params, runs_wanted, sharded)
        runs.update(r)
        for k in totals:
            totals[k] += t[k]
    return dict(runs=runs, totals=totals, device=str(dev), weight_bytes=weight_bytes,
                grid=(grid.kv_rank, grid.dp_rank, grid.tp_rank),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None)


def phase_kvtp(torch, card, dev="cuda", cfg=None, models=None, layers=None):
    """Sequence-sharded pools on TP rows and on the data x model grid
    (``KVTP_MODELS``, or the archs of ``models``): each model at full width
    on a ``kv x data x model`` grid of ranks (``spawn_ranks(..., tp=M,
    kv=K)``, the reference's ``make_kv_mesh``; NCCL with a card per rank,
    else gloo with every exchange staged through host memory and eager
    steps), llama2-7b on kv 2 x model 2 at full depth (``layers`` overrides
    a model's depth: the default run cuts it to KVTP_DEFAULT_LAYERS) and
    mixtral-8x22b on kv 2 x data 2 x model 2 at the depth the eight ranks'
    shards fit (``grid_depth``). Every rank serves ``kvtp_serve``'s runs
    first with replicated pools (its row and column alone) and then with
    its pools sharded over its kv group. Held: the weights a rank holds
    the same on every kv rank; every rank's tokens identical to rank 0's
    and each rank's sharded tokens to its own replicated run's; the
    recoveries and (mixtral) the island's entries and collectives equal
    between the modes, the island entered in every MoE layer of every
    decode step; a rank holding 1/(K*M) of the pool bytes and 1/K of its
    replicated row's per block; launches and collectives exact per rank;
    at the per-rank budget of SHARD_CAP_BLOCKS blocks the sharded row
    serves a prompt at least 1.9x longer than the replicated row admits,
    which refuses it. Prints a ``kvtp[...]`` line per run with the
    extents, the transport, the exchange's MB and host ms per step, the
    pool bytes per rank and TPOT sharded against replicated. (``dev="cpu"``
    and a reduced ``cfg`` rehearse it.)"""
    from repro_torch.configs import first_layers, get_config
    from repro_torch.launch.mesh import spawn_ranks

    cuda = dev == "cuda"
    totals = {k: 0 for k in KERNELS}
    out = {}
    for arch in models or KVTP_MODELS:
        (kv, dp, tp), runs_wanted, depth = KVTP_MODELS[arch]
        depth = (layers or {}).get(arch, depth)
        world = kv * dp * tp
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        full = cfg or get_config(arch)
        free = None
        if depth == 0 and cfg is None:
            # eight processes drawing their shards at once: their fp32
            # transients need more room than the dp phase's four
            mcfg, free = grid_depth(torch, dev, full, margin_gb=KVTP_MARGIN_GB, kv=kv)
        else:
            mcfg = first_layers(full, depth or 0)
        log(f"kvtp[{arch}]: {mcfg.n_layers} of {full.n_layers} layers at d_model "
            f"{mcfg.d_model} on a kv {kv} x data {dp} x model {tp} grid of {world} ranks "
            f"({card})" + (f"; {free / 1e9:.1f} GB free" if free else ""))
        t0 = time.perf_counter()
        ranks = spawn_ranks(_kvtp_rank, world, mcfg, runs_wanted, device=dev, timeout_s=900,
                            threads=0 if cuda else 1, tp=tp, kv=kv)
        wall = time.perf_counter() - t0
        check([r["grid"] for r in ranks] == [(k, d, m) for k in range(kv) for d in range(dp)
                                             for m in range(tp)],
              f"kvtp[{arch}]: ranks sit at {[r['grid'] for r in ranks]}")
        plane = dp * tp
        for i, r in enumerate(ranks):
            check(r["weight_bytes"] == ranks[i % plane]["weight_bytes"],
                  f"kvtp[{arch}]: rank {i} holds {r['weight_bytes']} weight bytes, its kv "
                  f"group's rank 0 {ranks[i % plane]['weight_bytes']}")
            for k in totals:
                totals[k] += r["totals"][k]
        transport = ranks[0]["runs"]["sharded " + runs_wanted[0]]["transport"]
        where = ("NCCL, one card per rank" if transport == "nccl" else
                 "gloo, exchanges staged through host memory, eager steps"
                 + (", ranks sharing a card, not NVLink" if cuda else ""))
        log(f"kvtp[{arch}]: {world} ranks ({where}), {wall:.1f} s with start-up; "
            f"{ranks[0]['weight_bytes'] / 1e9:.2f} GB of weights a rank")
        res = {}
        for name in [n for n in ranks[0]["runs"] if n.startswith("sharded ")]:
            case = name.split(" ", 1)[1]
            sh = [r["runs"][name] for r in ranks]
            rep = [r["runs"]["replicated " + case] for r in ranks]
            for i, (x, y) in enumerate(zip(sh, rep)):
                check(x["outputs"] == sh[0]["outputs"] and x["outputs"] == y["outputs"],
                      f"kvtp[{arch}] {case}: rank {i}'s tokens differ from rank 0's or from "
                      f"its replicated run's")
                check(x.get("events") == y.get("events"),
                      f"kvtp[{arch}] {case}: rank {i}'s recoveries differ")
                check(x["pool_bytes_held"] * kv * tp == x["pool_bytes"]
                      and x["pool_bytes_held"] * kv * y["n_blocks"]
                      == y["pool_bytes_held"] * x["n_blocks"],
                      f"kvtp[{arch}] {case}: rank {i} holds {x['pool_bytes_held']} pool bytes "
                      f"of {x['pool_bytes']}, its replicated run {y['pool_bytes_held']}")
                island = ("island", "island_down_bytes", "compressed_all_to_all_bytes",
                          "dense_all_to_all_bytes", "dp_all_gather_bytes", "all_gather",
                          "all_reduce")
                check({k: x["tp"][k] for k in island} == {k: y["tp"][k] for k in island},
                      f"kvtp[{arch}] {case}: rank {i}'s row and island collectives "
                      f"{x['tp']} differ from its replicated run's {y['tp']}")
            x, y = sh[0], rep[0]
            s, ex = x["summary"], x["exchange"]
            steps = max(s["n_steps"], 1)
            if case.startswith("island"):
                n_dec, L_moe = x["n_decode_steps"], moe_layers(mcfg)
                check(x["tp"]["island"] == L_moe * n_dec > 0,
                      f"kvtp[{arch}] {case}: {x['tp']['island']} island entries in {n_dec} "
                      f"decode steps of {L_moe} MoE layers")
            if case == "capacity/fp4_e2m1":
                long_s, long_r = x["prompt_tokens"], (SHARD_CAP_BLOCKS - 1) * BS - 4 + 1
                check(x["pool_bytes_held"] == y["budget_bytes"] and long_s / long_r >= 1.9,
                      f"kvtp[{arch}] capacity: {x['pool_bytes_held']} pool bytes a rank "
                      f"against a budget of {y['budget_bytes']}; {long_s} / {long_r} tokens")
                log(f"kvtp[{arch}] capacity: at {x['pool_bytes_held'] / 1e6:.2f} MB of fp4 "
                    f"pools a rank the sharded row served a {long_s}-token prompt with the "
                    f"tokens of a replicated row of twice the blocks; a replicated row at that "
                    f"budget admits {long_r} at most ({long_s / long_r:.2f}x) and refused it")
            x["tokens_equal"] = True
            log(f"kvtp[{arch}] {case}: tokens identical on {world} ranks and to each row's "
                f"replicated run; kv {kv} x data {dp} x model {tp} over {transport}; exchange "
                f"{ex['all_reduce']} all-reduces ({x['expected'].get('all_reduce')} expected), "
                f"{ex['bytes'] / steps / 1e6:.3f} MB and {ex['seconds'] / steps * 1e3:.2f} ms "
                f"host per step; {x['pool_bytes_held'] / 1e6:.2f} MB of pools a rank "
                f"(1/{kv * tp} of {x['pool_mb']:.2f} MB); row collectives "
                f"{x['tp']['bytes'] / steps / 1e6:.3f} MB and {x['tp']['seconds'] / steps * 1e3:.2f}"
                f" ms host per step" + (f"; {x['tp']['island']} island entries"
                                        if x['tp']['island'] else "")
                + f"; TPOT p50 {s['tpot_p50_s'] * 1e3:.2f} ms sharded vs "
                f"{y['summary']['tpot_p50_s'] * 1e3:.2f} ms replicated")
            res[case] = dict(sharded=x, replicated=y)
        for i, r in enumerate(ranks):
            log(f"kvtp[{arch}]: rank {i} ({r['device']}) peak device memory "
                + (f"{r['peak_gb']:.2f} GB" if cuda else "not measured (no card)"))
        out[arch] = dict(extents=(kv, dp, tp), layers=mcfg.n_layers, wall_s=wall,
                         transport=transport, weight_bytes=ranks[0]["weight_bytes"], runs=res,
                         peak_gb=[r["peak_gb"] for r in ranks])
    log(f"kvtp: card {card}")
    return out, totals


FAULT_RUNS = {  # pools -> (fault plan, the recoveries it must cause, in order)
    "fp4_e2m1": ("exhaust@5:64x4;corrupt@9;die@20", ["WireCorruption", "EngineDead"]),
    "bf16": ("corrupt@9", ["WireCorruption"]),
}


def serve_faults(torch, dev, serve, runs, model, params, ctx, prompts, kw):
    """The robustness paths at llama2-7b width, mixed step, the fault-free
    runs' weights and prompts: (f) supervised runs under ``FAULT_RUNS``
    (every request ok, the planned recoveries, each replaying all 8
    requests: none can finish in 20 steps); (h) ``eos_id`` set to the
    fault-free run's 5th token of the first request that did not produce it
    earlier; (g) ``max_queue=2`` (exactly 2 of 8 rejected), then an engine
    deadline of 3/4 of the eos run's makespan (the run just before, so at
    the same host pace) with request 0 cancelled from a timer at a fifth of
    it. Tokens of (f) are counted against the
    fault-free run, not held (near ties at full width, section 6 of
    PERF.md); the reference phase holds them on the reduced model. Last,
    the corruption watch's cost per step (``watch_cost``)."""
    import dataclasses
    import re
    import threading

    from repro_torch.serving import Engine, EngineSupervisor, FaultPlan

    mixed = lambda spec, **o: Engine(model, params, ctx, prefill_chunk=CHUNK, token_budget=T,
                                     cache_spec=spec, **o, **kw)
    for spec, (plan, planned) in FAULT_RUNS.items():
        name = f"faults/{spec}"
        eng = mixed(spec, fault_plan=FaultPlan.parse(plan))
        sup = EngineSupervisor(eng)
        s, reqs = serve(name, eng, prompts, sup=sup)
        events = [(e.error, e.mode, e.n_replayed) for e in sup.events]
        check(events == [(e, "hard", len(prompts)) for e in planned],
              f"{name}: recoveries {events}, planned {planned}")
        watch = [int(m.group(1)) for e in sup.events
                 for m in [re.search(r"\(step (\d+)\)", e.detail)] if m]
        free = runs[f"mixed/{spec}"]["outputs"]
        same = sum(r.output.tolist() == f for r, f in zip(reqs, free))
        report = sup.report()
        report.pop("serve")
        # the merged summary's makespan is the last attempt's clock (replays
        # arrive at 0 on it); over the whole supervised run's wall:
        wall_goodput = s["n_generated"] / runs[name]["wall_s"]
        runs[name].update(events=[dataclasses.asdict(e) for e in sup.events], plan=plan,
                          watch_steps=watch, same_tokens_as_fault_free=same, report=report,
                          goodput_wall_tokens_per_s=wall_goodput)
        log(f"faults[{spec}]: plan {plan}: recoveries " + "; ".join(
            f"{e.error} ({e.mode}, {e.n_replayed} replayed) recovery_s {e.recovery_s:.4f} "
            f"backoff_s {e.backoff_s:.3f}" for e in sup.events) +
            f"; corruption watch fired at step(s) {watch}; goodput "
            f"{s['goodput_tokens_per_s']:.1f} tokens/s over the last attempt, {wall_goodput:.1f} "
            f"over the supervised run's {runs[name]['wall_s']:.2f} s; outcomes {s['n_ok']} ok; "
            f"{same} of {len(prompts)} requests decoded the fault-free run's tokens")

    # (h) eos_id
    free = runs["mixed/fp4_e2m1"]["outputs"]
    k = next((i for i, o in enumerate(free) if o[4] not in o[:4]), 0)
    eos, stop = free[k][4], free[k].index(free[k][4]) + 1
    name = "eos/fp4_e2m1"
    s, reqs = serve(name, mixed("fp4_e2m1"), prompts, all_new=False,
                    req_kw=[dict(eos_id=eos) if i == k else {} for i in range(len(prompts))])
    check(all(r.outcome == "ok" for r in reqs) and reqs[k].output.tolist() == free[k][:stop]
          and all(len(r.output) == NEW for i, r in enumerate(reqs) if i != k),
          f"{name}: request {k} gave {reqs[k].output.tolist()}, not {free[k][:stop]}")
    runs[name].update(request=k, eos_id=eos, stopped_at=stop)
    log(f"{name}: request {k} (eos_id {eos}, its fault-free 5th token) stopped ok after {stop} "
        f"tokens")

    # (g) bounded admission, then deadlines and a cancel from another thread.
    # The deadline is set from the makespan of the run just before it (the
    # eos run: the same 8 prompts, its last wave of requests decodes all
    # 32 tokens), so that the host's pace, which varies within a call, is
    # the same for both
    name = "max_queue/fp4_e2m1"
    s, reqs = serve(name, mixed("fp4_e2m1", max_queue=2), prompts, all_new=False)
    check(s["n_rejected"] == 2 and s["n_ok"] == len(prompts) - 2
          and all(len(r.output) == 0 and r.timing.admitted_s is None
                  for r in reqs if r.outcome == "rejected"),
          f"{name}: outcomes {[r.outcome for r in reqs]}")
    makespan = runs["eos/fp4_e2m1"]["summary"]["makespan_s"]

    def cancel_first(reqs):
        timer = threading.Timer(0.2 * makespan, reqs[0].cancel)
        timer.start()
        return timer.cancel

    name = "deadline/fp4_e2m1"
    s, reqs = serve(name, mixed("fp4_e2m1", deadline_s=0.75 * makespan), prompts,
                    all_new=False, during=cancel_first)
    check(reqs[0].outcome == "cancelled" and 0 < len(reqs[0].output) < NEW,
          f"{name}: request 0 {reqs[0].outcome} with {len(reqs[0].output)} tokens")
    check(s["n_timed_out"] >= 1 and all(len(r.output) < NEW for r in reqs
                                        if r.outcome == "timed_out"),
          f"{name}: outcomes {[r.outcome for r in reqs]}")
    runs[name]["deadline_s"] = 0.75 * makespan
    for name in ("max_queue/fp4_e2m1", "deadline/fp4_e2m1"):
        s = runs[name]["summary"]
        log(f"{name}: outcomes {s['n_ok']} ok, {s['n_rejected']} rejected, {s['n_timed_out']} "
            f"timed out, {s['n_cancelled']} cancelled; goodput {s['goodput_tokens_per_s']:.1f} "
            f"tokens/s of {s['tokens_per_s']:.1f}")
    runs["watch_cost"] = watch_cost(torch, dev, eng, model.cfg.vocab_size)


def watch_cost(torch, dev, eng, vocab, n=200):
    """What the corruption watch adds to a served step: the engine's sampler
    over (slots, vocab) fp32 logits with the watch off and on, host ms per
    call (each call ends in the device-to-host copy of the tokens, which
    the watch's flags share), in turns off, on, on, off; and on the card the
    device ms of the watch's own ops (finite flags, the masked logits, the
    stack the copy takes)."""
    import numpy as np

    logits = torch.randn(eng.n_slots, vocab, device=dev)
    temps, rows = np.zeros(eng.n_slots, np.float32), list(range(eng.n_slots))
    host = {False: [], True: []}
    for on in (False, True, True, False):
        eng._nan_watch = on
        eng._sample(logits, temps, rows)
        t0 = time.perf_counter()
        for _ in range(n):
            eng._sample(logits, temps, rows)
        host[on].append((time.perf_counter() - t0) / n * 1e3)
    eng._nan_watch = False

    toks = logits.argmax(-1)

    def watch_ops():
        fin = torch.isfinite(logits).all(dim=-1)
        return torch.where(fin[:, None], logits, 0.0), torch.stack([toks, fin.to(toks.dtype)])

    out = dict(host_ms_off=host[False], host_ms_on=host[True],
               device_ms_watch=device_ms(torch, watch_ops) if dev == "cuda" else None)
    log(f"corruption watch: sampler {min(host[False]):.4f} ms per step off, "
        f"{min(host[True]):.4f} ms on (host clock, {n} calls, best of two in turns); the "
        f"watch's own device ops " + (f"{out['device_ms_watch']:.4f} ms" if dev == "cuda"
                                      else "not measured (no card)"))
    return out


def ttft_fit(info, ttft):
    """The analytic TTFT model's H100 constants fitted on this run
    (``launch/ttft_table.fit_h100``: the graphed uncompressed measure_ttft at
    2048 tokens, the launch floor, the codec's device time at the
    whole-prompt shapes of 512 tokens), and the one-card check of its codec
    term against the measured compressed minus uncompressed TTFT."""
    from repro_torch.launch.ttft_table import fit_h100, measured_from, one_card_check

    q = next(r for r in info["mx_quant"]["shapes"] if "whole-prompt TP partials" in r["shape"])
    d = next(r for r in info["mx_dequant_reduce"]["shapes"]
             if "whole-prompt prefill" in r["shape"])
    fit = fit_h100(ttft["uncompressed/2048"]["median_s"],
                   info["mx_quant"]["launch_floor_ms"] / 1e3, q["ms"] / 1e3, d["ms"] / 1e3)
    log(f"ttft model fit (H100 entry): mfu {fit['mfu']:.4f} (graphed uncompressed "
        f"measure_ttft at 2048 tokens {ttft['uncompressed/2048']['median_s'] * 1e3:.3f} ms), "
        f"codec_fixed_s {fit['codec_fixed_s']:.4g} (2 x the launch floor), codec_passes "
        f"{fit['codec_passes']:.4f} ({q['shape']} {q['ms']:.4f} ms + {d['shape']} "
        f"{d['ms']:.4f} ms)")
    text, one_card = one_card_check(measured_from(ttft))
    for line in text.splitlines():
        log(line)
    return dict(fit=fit, one_card=one_card)


# ---------------------------------------------------------------------- train

TRAIN_ARCH = "internlm2-1.8b"   # the reference launch/train.py's default
TRAIN_STEPS = 20                # one card, full depth
TRAIN_BATCH, TRAIN_SEQ = 8, 256  # the reference launch/train.py's defaults
TRAIN_TP_LAYERS = 4             # the 2-rank run sharing the one card (gloo, host-staged)
TRAIN_TP_STEPS = 3
TRAIN_MODELS = {"internlm2-1.8b": 2, "llama2-7b": 4}   # --phase train: TP ranks, full depth
TRAIN_NCCL_STEPS = 6
TRAIN_COSINE = 0.7              # compressed vs dense gradient (tests/test_collectives.py's bound)
TRAIN_LOSS_REL = 1e-4           # the ranks' first loss vs the one-card simulate_tp=n forward
                                # (about 10x under the compression's own effect on it, which
                                # the ranks' dense first loss must show beyond this limit)


def train_cfg(arch, layers=0):
    """``arch`` at full width on its first ``layers`` layers (all: 0), vocab
    258 (the byte tokenizer's, as the reference's launch/train.py sets it)."""
    import dataclasses

    from repro_torch.configs import first_layers, get_config

    return dataclasses.replace(first_layers(get_config(arch), layers), vocab_size=258)


def train_batches(n):
    """The first ``n`` global batches (TRAIN_BATCH x TRAIN_SEQ) the corpus
    pipeline draws with seed 0, as numpy (what a rank receives)."""
    from repro_torch.data import Batches, corpus_tokens

    b = Batches(corpus_tokens(4_000_000), TRAIN_BATCH, TRAIN_SEQ, seed=0, device="cpu")
    return [{k: v.numpy() for k, v in b.next().items()} for _ in range(n)]


def train_opt(steps):
    from repro_torch.training import AdamWConfig

    # the reference's launch/train.py schedule
    return AdamWConfig(lr=3e-4, warmup_steps=min(50, steps // 10 + 1), total_steps=steps)


def train_flops(cfg) -> float:
    """Matmul operations of one step: 6 per parameter per token."""
    from repro_torch.models.model import param_shapes

    return 6.0 * sum(math.prod(s) for s in _leaves(param_shapes(cfg))) * TRAIN_BATCH * TRAIN_SEQ


def adamw_bytes(n_params: int, wbytes: int = 2) -> float:
    """What the AdamW update must move: the weight, its gradient and both
    fp32 moments read, the weight and the moments written."""
    return n_params * (2 * wbytes + wbytes + 2 * 4 * 2)


def timed_steps(torch, dev, step, state, batches):
    """Run ``step`` over ``batches``; (state, losses, host ms of each step
    from its start to a synchronize after it, the last metrics)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses, ms, metrics = [], [], None
    for b in batches:
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, losses, ms, metrics


def train_one_card(torch, dev, card, totals):
    """internlm2-1.8b at full width and depth on one card: TRAIN_STEPS AdamW
    steps on the corpus (uncompressed: one card has no reduction between
    ranks, as the reference's single-device context). Held: every loss
    finite, the mean of the last 5 below the mean of the first 5. Prints
    step ms p50 against the bound, tokens/s, peak memory and the AdamW
    update's device ms against its bound."""
    from repro_torch.core.tp import TPContext
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.training import adamw_update, init_train_state, make_train_step
    from repro_torch.training.optimizer import leaves, rebuild

    cfg = train_cfg(TRAIN_ARCH)
    model = Model(cfg)
    d = torch.device(dev)
    batches = [{k: torch.from_numpy(v).to(d) for k, v in b.items()}
               for b in train_batches(TRAIN_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, device=dev, seed=0)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    opt = train_opt(TRAIN_STEPS)
    step = make_train_step(model, TPContext(), opt)
    reset_launch_counts()
    state, losses, ms, _ = timed_steps(torch, d, step, state, batches)
    launched = launch_counts()
    for k in totals:
        totals[k] += launched[k]
    check(all(math.isfinite(x) for x in losses), f"train[one card]: a loss is not finite: "
          f"{losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"train[one card]: the loss did not fall: first 5 mean {first:.4f}, "
          f"last 5 mean {last:.4f}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    p50 = sorted(ms[1:])[len(ms[1:]) // 2]
    flops = train_flops(cfg)
    step_bound, _ = bound(0, flops, BF16_OPS_PER_S)

    # the AdamW update alone on a step's gradients: CUDA events around 3
    # back-to-back updates after a warm one (the card waits wherever the
    # host's enqueue is slower), beside the host's enqueue time
    params = state["params"]
    flat = leaves(params)
    loss, _ = model.loss(TPContext(), params, batches[0])
    tree = rebuild(params, list(torch.autograd.grad(loss, flat)))
    del loss
    with torch.no_grad():
        adamw_update(opt, params, tree, state["opt"])
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(3):
            adamw_update(opt, params, tree, state["opt"])
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / 3
        b.record()
        b.synchronize()
        opt_ms = a.elapsed_time(b) / 3
    opt_bound, opt_by = bound(adamw_bytes(n_params), 0, BF16_OPS_PER_S)
    del tree
    res = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params, steps=TRAIN_STEPS,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses, step_ms=ms, step_ms_p50=p50,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3), peak_gb=peak,
               step_bound_ms=step_bound, step_flops=flops, adamw_ms=opt_ms,
               adamw_enqueue_ms=enqueue_ms, adamw_bound_ms=opt_bound, adamw_bound_by=opt_by,
               launches=launched)
    log(f"train[{cfg.name}] one card ({card}): {cfg.n_layers} layers d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params bf16, {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} corpus tokens: loss {losses[0]:.4f} -> {losses[-1]:.4f} (first 5 mean "
        f"{first:.4f}, last 5 mean {last:.4f}); step p50 {p50:.2f} ms (first step "
        f"{ms[0]:.1f} ms; bound {step_bound:.2f} ms at {flops / 1e12:.2f} TFLOP bf16), "
        f"{res['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GB; the AdamW update "
        f"{opt_ms:.3f} ms between events ({enqueue_ms:.3f} ms host enqueue; bound "
        f"{opt_bound:.3f} ms, {adamw_bytes(n_params) / 1e9:.1f} GB); kernels launched "
        f"{launched}")
    del state, params, flat, step
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _grad_dots(torch, grads_a, grads_b, sharded, group):
    """(a . b, |a|^2, |b|^2) over the whole model: the TP-sharded leaves'
    sums over the group, each replicated leaf once."""
    from repro_torch.core.collectives import rank_sum_scalar

    part = torch.zeros(3, dtype=torch.float64, device=grads_a[0].device)
    whole = torch.zeros_like(part)
    for a, b, s in zip(grads_a, grads_b, sharded):
        a, b = a.double(), b.double()
        v = torch.stack([(a * b).sum(), (a * a).sum(), (b * b).sum()])
        if s:
            part += v
        else:
            whole += v
    return (rank_sum_scalar(part, group) + whole).tolist()


def _train_rank(group, rank, dev, cfg, batches_np, steps, runs):
    """One TP rank of the training phase: its seed-0 shard; the dense and the
    compressed gradient of the first batch (forward and backward launches
    counted apart; their cosine over the whole model); then ``steps`` train
    steps under each policy of ``runs`` from the same weights, each with
    its losses, step ms, kernel launches and collectives, and a digest of
    every replicated leaf after the steps. Only rank 0 prints."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.core.collectives import reset_tp_counts, tp_counts, transport
    from repro_torch.core.policy import NO_COMPRESSION, PAPER_DEFAULT
    from repro_torch.core.tp import TPContext
    from repro_torch.kernels.build import launch_counts, load_kernels, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.train_step import sharded_leaves

    _QUIET[0] = rank != 0
    cuda = dev.type == "cuda"
    if cuda:
        load_kernels(build=False)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n = dist.get_world_size(group)
    model = Model(cfg)
    sharded = sharded_leaves(model, n)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches_np]
    policies = {"compressed": PAPER_DEFAULT, "dense": NO_COMPRESSION}
    ctx = {k: TPContext(policy=p, tp_group=group) for k, p in policies.items()}

    params = model.init_params(device=dev, seed=0, tp=(rank, n))
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss_d, _ = model.loss(ctx["dense"], params, batches[0])
    g_dense = torch.autograd.grad(loss_d, flat)
    sync()
    reset_launch_counts()
    loss_c, _ = model.loss(ctx["compressed"], params, batches[0])
    sync()
    forward = launch_counts()
    g_comp = torch.autograd.grad(loss_c, flat)
    sync()
    backward = {k: v - forward[k] for k, v in launch_counts().items()}
    ab, aa, bb = _grad_dots(torch, g_comp, g_dense, sharded, group)
    cosine = ab / math.sqrt(aa * bb)
    first = dict(loss_compressed=float(loss_c.detach()), loss_dense=float(loss_d.detach()),
                 cosine=cosine,
                 forward=forward, backward=backward)
    del g_dense, g_comp, loss_c, loss_d
    for p in flat:
        p.requires_grad_(False)

    out = {}
    for name in runs:
        state = init_train_state(model, model.init_params(device=dev, seed=0, tp=(rank, n)))
        step = make_train_step(model, ctx[name], train_opt(steps))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        reset_tp_counts()
        state, losses, ms, _ = timed_steps(torch, dev, step, state, batches[:steps])
        digest = hashlib.sha256()
        for t, s in zip(leaves(state["params"]), sharded):
            if not s:
                digest.update(t.detach().cpu().view(torch.int16).numpy().tobytes())
        out[name] = dict(losses=losses, step_ms=ms, launches=launch_counts(),
                         collectives=tp_counts(), replicated=digest.hexdigest(),
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None)
        del state, step
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return dict(first=first, runs=out, transport=transport(group), device=str(dev))


def train_ranks(torch, card, arch, n, layers, steps, runs, totals, dev="cuda"):
    """``arch`` at full width on ``layers`` layers (all: 0) on ``n`` TP ranks
    (``spawn_ranks``: NCCL with a card each, else gloo sharing the card),
    every row-parallel reduction compressed (PAPER_DEFAULT) with the
    straight-through backward. Held: losses equal on every rank and
    replicated weights bit-equal after the steps; the first compressed loss
    within TRAIN_LOSS_REL of the one-card ``simulate_tp=n`` forward on the
    same seed-0 weights and batch, and further than that from the dense
    first loss; kernel launches exact (2 quantize and 2
    dequantize+sum per layer a step, none in the backward); per step 4
    all-gathers per layer forward, 2 backward all-reduces per layer and the
    optimizer's one; the compressed gradient's cosine with the dense one
    above TRAIN_COSINE."""
    from repro_torch.core.policy import PAPER_DEFAULT
    from repro_torch.core.tp import TPContext
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    from repro_torch.models.model import Model

    cfg = train_cfg(arch, layers)
    L = cfg.n_layers
    batches = train_batches(steps)
    # the one-card simulate_tp=n forward the ranks' first loss is held to
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init_params(device=dev, seed=0)
    with torch.no_grad():
        b0 = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
        sim = float(model.loss(TPContext(policy=PAPER_DEFAULT, simulate_tp=n), params, b0)[0])
        sim_dense = float(model.loss(TPContext(), params, b0)[0])
    del params, b0
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_ranks(_train_rank, n, cfg, batches, steps, runs, device=dev,
                        timeout_s=900, threads=0 if dev == "cuda" else 2)
    wall = time.perf_counter() - t0
    transport = ranks[0]["transport"]
    check(transport == ("nccl" if backend_for(n, dev) == "nccl" else "gloo-staged"),
          f"train[{arch}]: transport {transport}")
    tag = f"train[{arch} tp {n}, {L} layers]"
    first = ranks[0]["first"]
    want_fwd = {"mx_quant": 2 * L, "mx_dequant_reduce": 2 * L, "mx_dequant": 0,
                "paged_attention": 0}
    for i, r in enumerate(ranks):
        f = r["first"]
        check(f["forward"] == want_fwd, f"{tag}: rank {i}'s compressed forward launched "
              f"{f['forward']}, not {want_fwd}")
        check(not any(f["backward"].values()), f"{tag}: rank {i}'s backward launched "
              f"{f['backward']}")
        check(f["loss_compressed"] == first["loss_compressed"],
              f"{tag}: rank {i}'s first loss differs from rank 0's")
    rel = abs(first["loss_compressed"] - sim) / abs(sim)
    check(rel <= TRAIN_LOSS_REL, f"{tag}: first compressed loss {first['loss_compressed']:.5f} "
          f"vs the one-card simulate_tp={n} forward {sim:.5f} (rel {rel:.3g} > "
          f"{TRAIN_LOSS_REL})")
    moved = abs(first["loss_compressed"] - first["loss_dense"]) / abs(first["loss_dense"])
    check(moved > TRAIN_LOSS_REL, f"{tag}: the codec moved the first loss by rel {moved:.3g} "
          f"(compressed {first['loss_compressed']:.5f}, dense {first['loss_dense']:.5f}), not "
          f"more than {TRAIN_LOSS_REL}")
    check(first["cosine"] > TRAIN_COSINE, f"{tag}: compressed vs dense gradient cosine "
          f"{first['cosine']:.4f} <= {TRAIN_COSINE}")
    res = dict(arch=arch, ranks=n, layers=L, transport=transport, wall_s=wall, steps=steps,
               simulated_loss=sim, simulated_dense_loss=sim_dense, first=first,
               runs=[r["runs"] for r in ranks])
    for name in runs:
        got = [r["runs"][name] for r in ranks]
        for i, g in enumerate(got):
            check(g["losses"] == got[0]["losses"], f"{tag} {name}: rank {i}'s losses "
                  f"{g['losses']} differ from rank 0's {got[0]['losses']}")
            check(g["replicated"] == got[0]["replicated"],
                  f"{tag} {name}: rank {i}'s replicated weights differ from rank 0's")
            check(all(math.isfinite(x) for x in g["losses"]), f"{tag} {name}: a loss is not "
                  f"finite: {g['losses']}")
            c = g["collectives"]
            if name == "compressed":
                want = {k: v * steps for k, v in want_fwd.items()}
                check(g["launches"] == want, f"{tag}: rank {i} launched {g['launches']} in "
                      f"{steps} steps, not {want}")
                check(c["all_gather"] == 4 * L * steps and c["all_reduce"] == 0,
                      f"{tag}: rank {i}'s forward collectives {c}")
                for k in totals:
                    totals[k] += g["launches"][k]
            else:
                check(not any(g["launches"].values()) and c["all_reduce"] == 2 * L * steps,
                      f"{tag} dense: rank {i} launched {g['launches']}, collectives {c}")
            check(c["backward_all_reduce"] == 2 * L * steps and c["grad_all_reduce"] == steps,
                  f"{tag} {name}: rank {i}'s backward and optimizer all-reduces {c}")
        g = got[0]
        p50 = sorted(g["step_ms"][1:])[len(g["step_ms"][1:]) // 2]
        g["step_ms_p50"] = p50
        c = g["collectives"]
        log(f"{tag} {name} on {card} over {transport}: losses {g['losses'][0]:.4f} -> "
            f"{g['losses'][-1]:.4f} equal on {n} ranks, replicated weights bit-equal; step p50 "
            f"{p50:.2f} ms (first {g['step_ms'][0]:.1f} ms), {TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.0f} "
            f"tokens/s; per step per rank {c['all_gather'] / steps:.0f} all-gathers and "
            f"{c['all_reduce'] / steps:.0f} all-reduces forward ({c['bytes'] / steps / 1e6:.2f} "
            f"MB), {c['backward_all_reduce'] / steps:.0f} backward all-reduces "
            f"({c['backward_bytes'] / steps / 1e6:.2f} MB), {c['grad_all_reduce'] / steps:.0f} "
            f"optimizer all-reduce; host {c['seconds'] / steps * 1e3:.1f} ms in forward "
            f"collectives; kernels {g['launches']}; peak "
            + (f"{g['peak_gb']:.2f} GB" if g["peak_gb"] is not None else "not measured"))
    log(f"{tag}: first compressed loss {first['loss_compressed']:.5f} vs one-card "
        f"simulate_tp={n} forward {sim:.5f} (rel {rel:.3g}; moved rel {moved:.3g} from dense "
        f"{first['loss_dense']:.5f}; one-card dense "
        f"{sim_dense:.5f}); forward launches {first['forward']}, backward none; compressed vs "
        f"dense gradient cosine {first['cosine']:.4f} (bound {TRAIN_COSINE}); {wall:.1f} s with "
        f"start-up")
    if "dense" in runs:
        pc = res["runs"][0]["compressed"]["step_ms_p50"]
        pd = res["runs"][0]["dense"]["step_ms_p50"]
        log(f"{tag}: step p50 compressed / dense {pc:.2f} / {pd:.2f} ms = {pc / pd:.4f}")
    return res


def phase_train(torch, card, dev="cuda"):
    """Training (after phase 11): internlm2-1.8b at full width and depth on
    the one card (``train_one_card``), then at full width on its first
    TRAIN_TP_LAYERS layers on 2 TP ranks sharing the card (gloo), compressed
    (``train_ranks``). Returns (results, kernel launches)."""
    totals = {k: 0 for k in KERNELS}
    out = {"one_card": train_one_card(torch, dev, card, totals)}
    out["tp"] = train_ranks(torch, card, TRAIN_ARCH, 2, TRAIN_TP_LAYERS, TRAIN_TP_STEPS,
                            ("compressed",), totals, dev=dev)
    return out, totals

# ------------------------------------------------------------------------ main


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels.build import build_seconds, builder, load_kernels
    except ImportError as e:
        print(f"chip_smoke: the port (src/repro_torch) is missing: {e}", file=sys.stderr)
        return 1
    major, minor = torch.cuda.get_device_capability(0)
    if major != 9:
        print(f"chip_smoke: needs a Hopper card (capability 9.x), got {major}.{minor}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} capability {major}.{minor}")

    load_kernels()
    log(f"build: {build_seconds():.1f} s for {len(KERNELS)} kernels ({builder()} path)")
    if sys.argv[1:3] == ["--phase", "tp"]:
        # phase 9 alone (a machine with a card per rank runs it over NCCL),
        # for the TP_MODELS named after it or all of them; without an
        # argument the script runs every phase
        unknown = set(sys.argv[3:]) - set(TP_MODELS)
        check(not unknown, f"--phase tp: not in TP_MODELS: {sorted(unknown)}")
        for a in [a for a in TP_MODELS if sys.argv[3:] and a not in sys.argv[3:]]:
            del TP_MODELS[a]
        tp, _ = phase_tp(torch, card)
        print(json.dumps({"ok": True, "phase": "tp", "transport": {a: r["transport"]
                                                                   for a, r in tp.items()},
                          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:3] == ["--phase", "kvtp"]:
        # the kvtp phase alone (llama2-7b over NCCL on a machine with four
        # cards), for the KVTP_MODELS named after it or all of them
        unknown = set(sys.argv[3:]) - set(KVTP_MODELS)
        check(not unknown, f"--phase kvtp: not in KVTP_MODELS: {sorted(unknown)}")
        kvtp, _ = phase_kvtp(torch, card, models=sys.argv[3:] or None)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_kvtp.json").write_text(json.dumps({"card": card, "kvtp": kvtp},
                                                                 indent=1, default=str))
        print(json.dumps({"ok": True, "phase": "kvtp",
                          "transport": {a: r["transport"] for a, r in kvtp.items()},
                          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:3] == ["--phase", "train"]:
        # training on TP ranks alone, NCCL with a card per rank: each of
        # TRAIN_MODELS (or those named) at full depth, compressed and dense
        unknown = set(sys.argv[3:]) - set(TRAIN_MODELS)
        check(not unknown, f"--phase train: not in TRAIN_MODELS: {sorted(unknown)}")
        train = {}
        for arch, n in TRAIN_MODELS.items():
            if sys.argv[3:] and arch not in sys.argv[3:]:
                continue
            check(torch.cuda.device_count() >= n, f"--phase train {arch}: {n} ranks need "
                  f"{n} cards, found {torch.cuda.device_count()}")
            train[arch] = train_ranks(torch, card, arch, n, 0, TRAIN_NCCL_STEPS,
                                      ("compressed", "dense"), {k: 0 for k in KERNELS})
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_train.json").write_text(json.dumps(
            {"card": card, "train": train}, indent=1, default=str))
        print(json.dumps({"ok": True, "phase": "train",
                          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:3] == ["--phase", "dp"]:
        # the dp phase alone, for the DP_MODELS named after it or all of them
        unknown = set(sys.argv[3:]) - set(DP_MODELS)
        check(not unknown, f"--phase dp: not in DP_MODELS: {sorted(unknown)}")
        for a in [a for a in DP_MODELS if sys.argv[3:] and a not in sys.argv[3:]]:
            del DP_MODELS[a]
        dp, _ = phase_dp(torch, card)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_dp.json").write_text(json.dumps({"card": card, "dp": dp},
                                                               indent=1, default=str))
        print(json.dumps({"ok": True, "phase": "dp",
                          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}}))
        return 0
    info = phase_kernels(torch)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    phase_reference(torch)
    runs, totals = phase_serve(torch)
    ttft_model = ttft_fit(info, runs["ttft"])
    families = {}
    for arch in FAMILIES:
        families[arch], fam_totals = phase_family(torch, arch)
        for k in totals:
            totals[k] += fam_totals[k]
    sharded, sh_totals = phase_sharded(torch, card)
    for k in totals:
        totals[k] += sh_totals[k]
    tp, tp_totals = phase_tp(torch, card)
    for k in totals:
        totals[k] += tp_totals[k]
    dp, dp_totals = phase_dp(torch, card)
    for k in totals:
        totals[k] += dp_totals[k]
    kvtp, kvtp_totals = phase_kvtp(torch, card, models=[KVTP_DEFAULT],
                                   layers={KVTP_DEFAULT: KVTP_DEFAULT_LAYERS})
    for k in totals:
        totals[k] += kvtp_totals[k]
    train, train_totals = phase_train(torch, card)
    for k in totals:
        totals[k] += train_totals[k]

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep, launches=totals[n],
                    **{k: info[n][k] for k in keys})
               for n, (src, rep) in KERNELS.items()]
    # the codec's other served shapes, each kernel's launch floor
    for k in kernels:
        if "shapes" in info[k["name"]]:
            k["shapes"] = [{f: v for f, v in r.items() if f in keys + ("shape",)}
                           for r in info[k["name"]]["shapes"]]
    for k in kernels:
        k["launch_floor_ms"] = info[k["name"]]["launch_floor_ms"]
    # paged attention's other geometries and pool formats, each with its bound
    kernels[-1]["geometries"] = [
        {k: v for k, v in r.items() if k in keys + ("geometry", "pools", "rel_l2", "row_map")}
        for r in info["paged_attention"]["geometries"]]
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_seconds(), "builder": builder(), "kernels": info,
         "serve": runs, "families": families, "sharded": sharded, "tp": tp, "dp": dp,
         "kvtp": kvtp, "train": train,
         "launches": totals,
         "ttft_model": ttft_model},
        indent=1, default=str))
    log("kernels: " + ", ".join(
        f"{k['name']} launches={k['launches']} max_abs_err={k['max_abs_err']:.3g} "
        f"ms={k['ms']:.4f}" for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
