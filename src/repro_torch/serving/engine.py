"""Continuous-batching serving engine over a paged KV cache — the port of the
reference engine's schedulers.

By default every engine step flattens up to ``token_budget`` tokens —
several PREFILLING slots' prompt chunks plus one token per DECODING slot —
into a single mixed batch and runs one ``Model.mixed_step``. Under an active
compression policy the engine holds two gate variants of the step (the
compressed context and ``ctx.without_compression()``) and picks one per step
with ``CompressionPolicy.active_for_step`` on the batch's REAL prefill and
decode token counts.

``token_budget=0`` selects the split scheduler: at most one
``Model.prefill_chunk`` of the earliest-arrival PREFILLING slot, then one
batched ``Model.decode_step_paged`` over every slot (two dispatches per
step). ``prefill_chunk=0`` prefills each prompt whole at admission
(``Model.prefill`` over a dense cache, right-padded to a power-of-two length
bucket) and inserts it into the slot's blocks, then decodes with the split
scheduler's batched decode.

A stack with recurrent layers (jamba's Mamba layers, xlstm-125m's mLSTM and
sLSTM layers) is served whole-prompt only, as the reference serves it:
right-padding would fold pads into the recurrent state, so each prompt
prefills at its exact length (one step program per length, under the LRU
of 8), and the chunked and mixed steps, ``token_budget`` and the prefix
cache are refused with the reference's errors. The insert writes the
request's attention K/V into its blocks and its recurrent caches into its
slot's row of ``state["rec"]``; the batched decode carries every slot's
row. A stack with no attention layer (xlstm-125m) has no pools, and its
block allocator, tables and preemptions still run as the reference's do
(the blocks back nothing); a ``corrupt`` fault then poisons nothing, as
the reference's poisons pools only.

A vision model (pixtral) and an encoder-decoder (whisper) are served
whole-prompt too, as the reference serves them: the chunk and mixed steps
thread no prefix or encoder state. Their text prompts are bucketed to powers
of two like any attention stack's. ``run(..., extra_inputs=...)`` gives one
row per request of the model's extra inputs (``patch_embeds`` (N, n_patches,
d_model), ``encoder_frames`` (N, encoder_seq, d_model); numpy or host torch
arrays, cast to the model's dtype), which reach the bucket's prefill
program with the tokens (again when a preempted request re-prefills). A
vision prompt's ``n_patches`` prefix positions sit ahead of its text in the
slot's blocks (``_n_prefix``); an encoder-decoder's insert writes the
encoder's per-layer cross K/V into the slot's rows of ``state["cross_k"]``
/ ``state["cross_v"]`` in place, which every decode step reads. On a TP
group each rank holds its kv heads of that cross state (the rank-local
``kv_dim``) and writes them at the insert; every rank must be given the
same ``extra_inputs`` (draw them from one seed, ``frontend_stubs``, never
from a per-rank generator), since each rank's encoder or prefix computes on
them.

With ``prefix_cache=True`` full prompt blocks are published in a hash-chain
index as their chunks land; admission maps matching blocks into the new
slot's table by reference and prefill resumes at the first non-cached token.
Under block pressure the engine preempts the latest-arrival request (LIFO,
evict-and-recompute: its generated tokens fold into its prompt and it
requeues), with the reference's eviction-storm guard.

Every request ends in a terminal outcome (``ok``, ``rejected``,
``timed_out``, ``cancelled``): deadlines (``deadline_ttft_s`` /
``deadline_s``, measured from arrival), ``Request.cancel()`` and bounded
admission (``max_queue``) free a request's blocks and keep its partial
output; ``eos_id`` ends a request early. A ``FaultPlan`` injects pool
exhaustion, pool corruption, slow or stuck steps and engine death at chosen
steps; the step watchdog (``step_timeout_s``), the stall guard
(``stall_limit``, 256 by default) and the non-finite logits watch turn them
into ``StepStuck`` / ``WireCorruption`` / ``EngineDead``, from which
``recover()`` (or ``EngineSupervisor``) restores a runnable engine.

Step programs: as the reference jits each step program once, the engine
runs each of its steps through a compile-once ``StepProgram``
(``serving/graphs.py``): the mixed step once per gate variant, the split
chunk and decode, and whole-prompt prefill once per length bucket (under the
reference's LRU bound of 8). On the card each program is a CUDA graph,
captured at its first call and replayed after; ``cuda_graphs=False`` asks
for eager steps instead. On the CPU, on sequence-sharded pools and on a
gloo TP group the programs run eagerly through the same static buffers.
``decode_cache_size`` / ``prefill_cache_size`` count the programs that have
run, with the reference's semantics.

Tensor parallelism: with a ``TPContext`` whose ``tp_group`` holds N ranks,
each rank runs this engine on the same requests with its shard of the
weights (``Model.init_params(tp=...)``) and the pools of its ``1/N`` of
the kv heads (the rank-local config, ``ModelConfig.tp_shard``); every
row-parallel reduction crosses the group. The logits are replicated, so
every rank samples the same tokens and makes the same host decisions. Under
NCCL the step programs stay CUDA graphs (the communicator is initialised
with one collective before the first capture); over gloo-staged transport
the steps run eagerly. ``keep_local_fp`` is refused here: it gives every
rank different logits (ROADMAP.md Queue 3 item 11).

Sequence-sharded pools: with a ``TPContext`` whose ``kv_group`` holds N
ranks, each rank runs this engine on the same requests and holds
``n_blocks / N`` blocks of every pool (capacity rounds up to a multiple of
N). Every rank makes the same host decisions (admission, allocation,
preemption, prefix hits and sampling are deterministic), the steps exchange
the blocks they read over the group, and every rank samples the same
tokens. Only the attention pools shard, as the reference pins only them to
its kv axis: a whole-prompt stack's per-slot state (jamba's and xLSTM's
``state["rec"]``, whisper's cross K/V) is whole on every kv rank, the same
on each since every rank runs the same steps, and a vision prefix's blocks
shard like any other. A stack with no pools (xlstm-125m) shards nothing.
With a ``tp_group`` (and a ``dp_group``) too, the rank sits on the
reference's ``kv x data x model`` mesh: it holds ``n_blocks / N`` blocks of
the pools of its kv heads, each pool plane's exchange, the scatters, the
copy-on-write fork and the corruption fault run over the kv group of its
(data, model) position, the row-parallel reductions over its row and the
MoE island over its data group, and every one of the grid's ranks runs the
scheduler in lockstep. The recurrent state and the cross K/V hold the
rank's heads (split over the row) and are whole over the kv group.

Data-parallel ranks: with a ``TPContext`` whose ``dp_group`` holds N ranks
(with its ``tp_group``, one row of a ``data x model`` grid), each rank runs
this engine on the same requests in lockstep with the pools of its TP
shard, replicated over the data ranks, and computes every row outside the
MoE layers; a MoE call that meets the island gate (``moe.uses_island``:
more than 64 tokens in ``N`` groups of whole batch rows, ``E % N == 0``)
runs the expert-parallel island across the data ranks. In the engine that
is the split scheduler's batched decode when ``max_slots`` exceeds 64 and
divides by N (its batch is the slot width, whatever the active count); a
chunk, a whole-prompt prefill or a mixed step is one batch row and never
enters it.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.formats import KVCacheSpec, MXSpec
from repro_torch.core.policy import NO_COMPRESSION
from repro_torch.core.tp import (
    TPContext, pool_block_copy, pool_block_fill, pool_block_write,
)
from repro_torch.device import resolve_device
from repro_torch.models.attention import pool_planes, pool_rows, write_pool_rows
from repro_torch.models.frontends import frontend_shapes
from repro_torch.models.model import Model, torch_dtype
from repro_torch.serving.errors import (
    OUTCOME_CANCELLED, OUTCOME_OK, OUTCOME_REJECTED, OUTCOME_TIMED_OUT, EngineDead,
    InvalidRequest, PoolExhausted, SlotExhausted, StepStuck, WireCorruption,
)
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.kv_cache import (
    BlockAllocator, PrefixIndex, build_mixed_batch, check_cache_spec, init_paged_state,
    paged_cache_bytes, recurrent_state_bytes, zero_paged_state,
)
from repro_torch.serving.graphs import StepProgram, StepPrograms
from repro_torch.serving.ttft import RequestTiming, ServeStats

__all__ = ["Request", "Engine"]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # int32 token ids (non-empty)
    max_new_tokens: int = 16
    temperature: float = 0.0
    arrival_s: float = 0.0        # offset from run() start (staggered traffic)
    eos_id: Optional[int] = None  # stop early on this token
    # deadlines measured from arrival (None = the engine's default; its None =
    # no deadline); expiry is the terminal outcome "timed_out", never an error
    deadline_ttft_s: Optional[float] = None   # first token must land by this
    deadline_s: Optional[float] = None        # last token must land by this
    cancelled: bool = False       # set by cancel(); swept at the next step
    # filled by the engine:
    output: Optional[np.ndarray] = None
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None
    timing: Optional[RequestTiming] = None

    def __post_init__(self) -> None:
        if np.asarray(self.prompt).size == 0:
            raise InvalidRequest("request prompt is empty — a request needs at "
                                 "least one prompt token")
        if self.max_new_tokens <= 0:
            raise InvalidRequest(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        for name in ("deadline_ttft_s", "deadline_s"):
            d = getattr(self, name)
            if d is not None and d <= 0:
                raise InvalidRequest(f"{name} must be > 0 seconds (measured from "
                                     f"arrival), got {d}")

    def cancel(self) -> None:
        """Mark for cancellation: the engine sweeps the flag at its next step
        boundary, frees the request's blocks and records ``"cancelled"`` with
        the tokens generated so far. Safe from another thread (the flag only
        ever flips one way)."""
        self.cancelled = True

    @property
    def outcome(self) -> Optional[str]:
        return self.timing.outcome if self.timing is not None else None


@dataclasses.dataclass
class _Work:
    """Scheduler-internal request state (survives preemptions)."""

    req: Request
    prompt: np.ndarray            # effective prompt: original + generated on
                                  # readmission after a preemption (recompute)
    arrival: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    admitted_t: Optional[float] = None
    first_token_t: Optional[float] = None
    preemptions: int = 0
    prefilling: bool = False      # prompt still streaming in chunk by chunk
    pos: int = 0                  # prompt tokens already written to the pools
    token_times: List[float] = dataclasses.field(default_factory=list)
    # prefix cache: block hashes of the effective prompt (per admission) and
    # the prompt tokens served from shared blocks so far
    hashes: Optional[List[int]] = None
    cached_tokens: int = 0
    # the request's row of each extra model input (patch embeddings, encoder
    # frames), handed to its prefill at every admission
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> bool:
        if len(self.tokens) >= self.req.max_new_tokens:
            return True
        return (self.req.eos_id is not None and bool(self.tokens)
                and self.tokens[-1] == self.req.eos_id)


class Engine:
    """Continuous-batching engine: FIFO admission by arrival time into
    ``max_slots`` slots; chunked prefill packed with the decode batch into
    one mixed step (default), the split chunk-then-decode scheduler
    (``token_budget=0``) or whole-prompt prefill (``prefill_chunk=0``); LIFO
    preemption under block pressure; optional prefix caching.

    The constructor takes the reference's arguments for these options and
    validates them with the same errors: ``prefill_chunk`` (default
    ``2*block_size``; 0 = whole prompt), ``token_budget`` (default
    ``prefill_chunk + max_slots``; 0 = split steps), ``prefix_cache`` (needs
    chunked prefill), ``persistent_cache`` (pools, allocator and prefix index
    stay warm across ``run()`` calls; needs ``prefix_cache``),
    ``compress_decode`` (the split decode and the mixed gate compress too),
    ``max_preempts_per_step`` / ``thrash_window`` / ``thrash_limit`` (the
    eviction-storm guard: chunk allocation stops choosing victims once a
    step has preempted that many slots, and a window of steps with at least
    ``thrash_limit`` preemptions degrades the engine to one chunk per step
    and no admissions until a request retires), and the robustness options:
    ``max_queue`` (arrived requests never admitted beyond this many leave
    ``rejected``), ``deadline_ttft_s`` / ``deadline_s`` (engine defaults of
    the request deadlines), ``fault_plan`` (``serving/faults.py``),
    ``step_timeout_s`` (a step slower than this raises ``StepStuck``) and
    ``stall_limit`` (that many steps in a row without a token, with requests
    in flight and no fault hold, raise ``StepStuck``; 0 = off). On the card
    the steps replay CUDA graphs unless ``cuda_graphs=False`` (eager steps,
    to hold the graphed path against; the CPU, sequence-sharded pools and
    gloo TP groups always run eagerly).

    ``run(requests)`` serves a list of ``Request``s, fills their ``output`` /
    ``ttft_s`` / ``latency_s`` / ``timing`` and leaves per-run aggregates in
    ``self.stats`` and per-gate step counts in ``self.gate_counts``. A run
    aborted by ``EngineDead`` / ``StepStuck`` / ``WireCorruption`` resumes
    after ``recover()``. Runs on the card unless ``device="cpu"``; params
    must live on that device.
    """

    def __init__(self, model: Model, params, ctx: TPContext, *,
                 max_len: int, max_slots: int = 4, block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 cache_spec: "KVCacheSpec | MXSpec | str | None" = None,
                 compress_decode: bool = False,
                 prefill_chunk: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 persistent_cache: bool = False,
                 max_queue: Optional[int] = None,
                 deadline_ttft_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 step_timeout_s: Optional[float] = None,
                 stall_limit: int = 256,
                 max_preempts_per_step: Optional[int] = None,
                 thrash_window: int = 8,
                 thrash_limit: Optional[int] = None,
                 cuda_graphs: bool = True,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.local_cfg(ctx)   # this rank's heads on a TP group
        self.ctx = ctx
        self.tp_size = ctx.tp_size
        if self.tp_size > 1 and ctx.policy.enabled and ctx.policy.keep_local_fp:
            raise ValueError(
                "keep_local_fp on a TP group gives each rank its own logits (its own "
                "quantization residual), so the ranks' sampled tokens and schedules "
                "could part; the engine refuses it on the rank path (ROADMAP.md Queue 3 "
                "item 11: the reference's out_specs claim a replicated output there)")
        self.params = params
        if max_slots <= 0:
            raise SlotExhausted(f"max_slots must be >= 1, got {max_slots}")
        self.n_slots = max_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = -(-max_len // block_size)
        # full provisioning by default (+1 for the reserved null block)
        self.n_blocks = n_blocks or (self.n_slots * self.max_blocks + 1)
        # sequence-sharded pools: each kv rank holds a contiguous
        # n_blocks / kv_shards of the blocks, so round capacity UP
        self.kv_shards = ctx.kv_shards
        if self.n_blocks % self.kv_shards:
            self.n_blocks += self.kv_shards - self.n_blocks % self.kv_shards
        self.dp_size = ctx.dp_size
        self._lockstep = self.kv_shards > 1 or self.tp_size > 1 or self.dp_size > 1
        if self._lockstep and (deadline_s or deadline_ttft_s or step_timeout_s):
            raise ValueError(
                "sequence-sharded pools, TP groups and data groups run every rank's "
                "scheduler in lockstep; deadlines and the step watchdog read each rank's "
                "own clock")
        self.cache_dtype = cache_dtype or torch.bfloat16
        self.cache_spec = check_cache_spec(self.cfg, cache_spec)
        self.stats = ServeStats()

        # eviction-storm guard (see the class docstring)
        self.max_preempts_per_step = (max_preempts_per_step
                                      if max_preempts_per_step is not None
                                      else 2 * self.n_slots)
        self.thrash_window = int(thrash_window)
        self.thrash_limit = thrash_limit if thrash_limit is not None else 4 * self.n_slots

        # robustness options (see the class docstring); all host-side
        if max_queue is not None and max_queue < 0:
            raise ValueError("max_queue must be >= 0 (None = unbounded)")
        self.max_queue = max_queue
        self.deadline_ttft_s = deadline_ttft_s
        self.deadline_s = deadline_s
        self.fault_plan = fault_plan
        self.step_timeout_s = step_timeout_s
        self.stall_limit = int(stall_limit)
        # the non-finite logits watch (WireCorruption) is on only under a plan
        # that can corrupt a pool block
        self._nan_watch = fault_plan is not None and any(
            f.kind == "corrupt" for f in fault_plan.faults)

        # right-padding to a bucket is only sound when every layer is
        # attention (causal masking hides trailing pads); recurrent layers
        # fold pads into their state, so those archs prefill at exact length.
        # The chunked and mixed steps need a pure-attention decoder with no
        # prefix tokens or encoder state threading through them (the
        # reference's gate): everything else is whole-prompt
        self._pad_ok = all(spec.kind == "attn" for spec in self.cfg.layers)
        self._n_prefix = self.cfg.n_patches if self.cfg.frontend == "vision" else 0
        self._extra_shapes = frontend_shapes(self.cfg, 1)
        chunk_ok = self._pad_ok and not self._extra_shapes
        if prefill_chunk is None:
            prefill_chunk = 2 * block_size if chunk_ok else 0
        elif prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = whole-prompt)")
        elif prefill_chunk and not chunk_ok:
            raise ValueError(
                "prefill_chunk requires a pure-attention text decoder "
                "(recurrent/vision/encoder-decoder archs use whole-prompt "
                "prefill; pass prefill_chunk=0 or leave it unset)")
        self.prefill_chunk = int(prefill_chunk)
        if token_budget is None:
            token_budget = self.prefill_chunk + self.n_slots if self.prefill_chunk else 0
        elif token_budget < 0:
            raise ValueError("token_budget must be >= 0 (0 = split steps)")
        elif token_budget and not self.prefill_chunk:
            raise ValueError(
                "token_budget (the unified mixed-batch step) rides on chunked "
                "prefill; this engine is whole-prompt (prefill_chunk=0 or a "
                "non-chunkable architecture)")
        elif token_budget and token_budget < self.n_slots + self.prefill_chunk:
            # one decode token per slot plus one full chunk, so packing only
            # ever places full chunks (chunk boundaries, and therefore which
            # tokens attend each other at compute vs pool precision, never
            # depend on packing timing)
            raise ValueError(
                f"token_budget ({token_budget}) must cover one decode token per "
                f"slot plus one full prefill chunk (max_slots={self.n_slots} + "
                f"prefill_chunk={self.prefill_chunk}); shrink prefill_chunk for a "
                f"smaller step")
        self.token_budget = int(token_budget)

        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache and not self.prefill_chunk:
            raise ValueError(
                "prefix_cache rides on chunked prefill (matches resume at the first "
                "non-cached token); this engine is whole-prompt (prefill_chunk=0 or a "
                "non-chunkable architecture)")
        self.persistent_cache = bool(persistent_cache)
        if self.persistent_cache and not self.prefix_cache:
            raise ValueError(
                "persistent_cache keeps the prefix index warm across runs; it "
                "requires prefix_cache=True (warm pool bytes are only reachable "
                "through the index)")
        # pools hold exactly what prefill computed only when dense at the
        # compute dtype; on lossy pools a full-prompt match resumes at a
        # chunk-aligned boundary instead of forking the tail block
        self._exact_pools = (not self.cache_spec.quantized
                             and self.cache_dtype == torch_dtype(self.cfg.dtype))

        # paper §5.2 gating: the split decode reduces uncompressed unless
        # compress_decode; the mixed gate drops its prefill-fraction floor then
        self.ctx_decode = ctx if compress_decode else dataclasses.replace(
            ctx, policy=NO_COMPRESSION)
        self._gate_policy = (dataclasses.replace(ctx.policy, min_prefill_fraction=0.0)
                             if compress_decode else ctx.policy)
        self._gate_ctxs: Dict[bool, TPContext] = {}
        if self.token_budget:
            self._gate_ctxs[False] = ctx.without_compression()
            if ctx.policy.enabled and ctx.policy.compress_tp_reduce:
                self._gate_ctxs[True] = ctx
        self.gate_counts = {"compressed": 0, "dense": 0}
        # compile-once step programs (module doc); graphs need the card and
        # no host-staged exchange inside a step
        self.graphed = (bool(cuda_graphs) and self.device.type == "cuda"
                        and self.kv_shards == 1 and ctx.transport != "gloo-staged")
        for group in (ctx.tp_group, ctx.dp_group, ctx.kv_group):
            if self.graphed and group is not None:
                # NCCL sets its communicator up at its first collective, which
                # must not happen inside a capture
                torch.distributed.all_reduce(torch.zeros(1, device=self.device), group=group)
                torch.cuda.synchronize(self.device)
        self._programs = StepPrograms(self.device, graphed=self.graphed)
        self._state = None
        self._ran = False
        self._fresh = False   # pools rebuilt by recover(): the next run keeps them
        self._reset()

    # ------------------------------------------------------------- state mgmt

    def _reset(self) -> None:
        """Fresh pools, allocator and prefix index. The pools are allocated
        once and zeroed in place after that: the step programs hold their
        addresses."""
        self.prefix_index = PrefixIndex(self.block_size) if self.prefix_cache else None
        self.allocator = BlockAllocator(self.n_blocks, prefix_index=self.prefix_index,
                                        shards=self.kv_shards)
        if self._state is None:
            # this rank's slab of every pool (all of it when replicated)
            self._state = init_paged_state(self.cfg, self.n_slots,
                                           self.n_blocks // self.kv_shards,
                                           self.block_size, self.cache_dtype,
                                           cache_spec=self.cache_spec, device=self.device)
        else:
            zero_paged_state(self._state)
        self._soft_reset()

    def _soft_reset(self) -> None:
        """Per-run scheduling state only: with ``persistent_cache`` the pools,
        allocator and index survive between runs (a clean run leaves every
        block free or parked in the index LRU)."""
        self._tables = np.zeros((self.n_slots, self.max_blocks), np.int32)
        self._lengths = np.zeros((self.n_slots,), np.int32)
        self._cur = np.zeros((self.n_slots,), np.int32)
        self._running: Dict[int, _Work] = {}
        self._waiting: List[_Work] = []
        self._finite = torch.ones((), dtype=torch.bool, device=self.device)
        self._step_i = 0             # steps of this run (fault plans count them)
        self._stall = 0              # consecutive steps without a token
        self._hold_until = 0         # step at which fault-held blocks return
        self.max_resident_ctx = 0    # peak slot length over the run's steps
        self.max_resident_blocks = 0  # peak pool blocks out of the free list
        self._step_preempts = 0
        self._preempt_window: collections.deque = collections.deque(
            maxlen=max(1, self.thrash_window))
        self._degraded = False

    def gate_variants(self) -> List[str]:
        """Names of the mixed-step variants this engine dispatches between
        (empty for split-scheduler and whole-prompt engines)."""
        return [("compressed" if g else "dense") for g in sorted(self._gate_ctxs)]

    def decode_cache_size(self) -> int:
        """Step programs that advance decode and have run (the reference's
        compiled-variant count): the mixed step's gate variants in a mixed
        engine, else the split decode (0 or 1)."""
        if self.token_budget:
            return self._programs.count(*(self._mixed_key(g) for g in self._gate_ctxs))
        return self._programs.count("decode")

    def prefill_cache_size(self) -> int:
        """Step programs on the serving path's prefill that have run: the
        mixed step's gate variants in a mixed engine, the one chunk program
        of a split chunked engine, else the whole-prompt programs by bucket,
        those the LRU evicted included (``measure_ttft``'s bucket counts
        only here, as in the reference)."""
        if self.token_budget:
            return self.decode_cache_size()
        if self.prefill_chunk:
            return self._programs.count("chunk")
        return self._programs.prefill_count()

    def capture_seconds(self) -> Dict[str, float]:
        """Wall seconds each captured step program took to capture, by name
        (empty when the steps run eagerly)."""
        return self._programs.capture_seconds()

    def rec_state_bytes(self) -> int:
        """Bytes of the slot-batched recurrent caches this rank holds (0 for
        a pure-attention stack; ``kv_cache.recurrent_state_bytes``)."""
        return recurrent_state_bytes(self.cfg, self.n_slots)

    def kv_pool_bytes(self, *, per_device: bool = False) -> int:
        """Bytes of the attention KV pools: the pools the engine addresses
        (every rank's kv heads on a TP group), or with ``per_device=True``
        what this rank holds (``1/kv_shards`` of them when sharded, ``1/N``
        on a TP group of N ranks, ``1/(kv_shards * N)`` on both). An
        encoder-decoder's per-slot cross K/V is counted too
        (``kv_cache.cross_state_bytes``)."""
        b = paged_cache_bytes(self.cfg, self.n_blocks, self.block_size,
                              dtype_bytes=self.cache_dtype.itemsize,
                              cache_spec=self.cache_spec, kv_shards=self.kv_shards,
                              per_device=per_device, n_slots=self.n_slots)
        return b if per_device else b * self.tp_size

    def pool_bytes_held(self) -> int:
        """Bytes of the pool tensors (every plane of every layer) and of an
        encoder-decoder's cross K/V that this process holds, summed over
        the tensors themselves."""
        cross = self._state.get("cross_k", []) + self._state.get("cross_v", [])
        return sum(t.numel() * t.element_size() for t in self._pool_planes() + cross)

    def logits_finite(self) -> bool:
        """Whether every step of the last run produced finite logits in every
        row, pad and prefilling rows included (a record, not the corruption
        watch: that checks sampled rows only and raises)."""
        return bool(self._finite)

    # ---------------------------------------------------------- step programs
    #
    # A program's function holds the model, weights and pools it runs on, not
    # the engine: with no cycle through the engine, dropping the engine frees
    # its graphs at once, never in a garbage collection that could fall
    # inside another engine's capture. The pools keep their addresses.

    def _mixed_program(self, gate: bool) -> StepProgram:
        """The mixed step under gate variant ``gate``: logits (n_slots, V)."""
        T, S, nb, i32 = self.token_budget, self.n_slots, self.max_blocks, torch.int32
        model, params, state, spec = self.model, self.params, self._state, self.cache_spec

        def make():
            ctx = self._gate_ctxs[gate]

            def step(tokens, slot_ids, positions, valid, is_decode, lengths, tables,
                     sample_idx):
                return model.mixed_step(ctx, params, tokens, state, slot_ids, positions, valid,
                                        is_decode, lengths, tables, sample_idx,
                                        cache_spec=spec)[0]

            return step, dict(tokens=((1, T), i32), slot_ids=((T,), i32),
                              positions=((T,), i32), valid=((T,), torch.bool),
                              is_decode=((T,), torch.bool), lengths=((S,), i32),
                              tables=((S, nb), i32), sample_idx=((S,), i32))

        return self._programs.get(self._mixed_key(gate), make)

    @staticmethod
    def _mixed_key(gate: bool) -> str:
        return f"mixed/{'compressed' if gate else 'dense'}"

    def _chunk_program(self) -> StepProgram:
        """The split scheduler's chunk of one slot: logits (1, V)."""
        model, params, ctx, state, spec = (self.model, self.params, self.ctx, self._state,
                                           self.cache_spec)

        def make():
            def step(tokens, table_row, start, n_valid):
                return model.prefill_chunk(ctx, params, tokens, state, table_row, start,
                                           n_valid, cache_spec=spec)[0]

            return step, dict(tokens=((1, self.prefill_chunk), torch.int32),
                              table_row=((self.max_blocks,), torch.int32),
                              start=((), torch.int32), n_valid=((), torch.int32))

        return self._programs.get("chunk", make)

    def _decode_program(self) -> StepProgram:
        """The batched decode of every slot: logits (n_slots, V)."""
        S = self.n_slots
        model, params, ctx, state, spec = (self.model, self.params, self.ctx_decode,
                                           self._state, self.cache_spec)

        def make():
            def step(tokens, tables, lengths):
                return model.decode_step_paged(ctx, params, tokens, state, tables, lengths,
                                               cache_spec=spec)[0]

            return step, dict(tokens=((S, 1), torch.int32),
                              tables=((S, self.max_blocks), torch.int32),
                              lengths=((S,), torch.int32))

        return self._programs.get("decode", make)

    # ------------------------------------------------------- shape bucketing

    def _shapes_for(self, prompt_len: int):
        """(text bucket, total prefill positions, blocks they fill) of a
        whole prompt: the smallest power-of-two multiple of the block size
        that holds the text, capped at the slot's capacity less a vision
        prefix; the total adds the prefix. A recurrent stack's bucket is the
        prompt's exact length."""
        cap = self.max_blocks * self.block_size - self._n_prefix
        if self._pad_ok:
            bucket = self.block_size
            while bucket < prompt_len:
                bucket *= 2
            bucket = min(bucket, cap)
        else:
            bucket = prompt_len
        if bucket < prompt_len or bucket > cap:
            raise ValueError(f"prompt ({prompt_len} tokens) exceeds cache capacity ({cap})")
        total = bucket + self._n_prefix
        return bucket, total, -(-total // self.block_size)

    def _prefill_for(self, prompt_len: int):
        """(bucket, program, nb) for a whole prompt of this length:
        the bucket's step program (made on first use, an LRU touch after it)
        takes ``tokens`` (1, bucket), ``last_index`` and the model's extra
        inputs (``patch_embeds`` / ``encoder_frames``, one row, in the
        model's dtype), runs ``Model.prefill`` over the program's own dense
        cache of ``total`` positions (every position of it written each
        call) and returns (logits (1, V) at ``last_index``, the layer caches,
        and an encoder-decoder's per-layer cross K/V).

        Each bucket's program holds its dense cache for as long as the
        program lives (up to 8 under the LRU; an evicted one releases it):
        2 x n_layers x total x n_kv_heads x head_dim elements of
        ``cache_dtype``, 1.07 GB for llama2-7b's bf16 at 2048. The buckets
        double (the last capped at the slot's capacity), so together they
        hold less than twice the largest power-of-two bucket plus the capped
        one. ``paged_cache_bytes`` does not count it. A recurrent stack keys
        a program per exact prompt length (and its recurrent layers' caches are
        the program's outputs)."""
        bucket, total, nb = self._shapes_for(prompt_len)
        model, params, ctx = self.model, self.params, self.ctx
        dtype = torch_dtype(self.cfg.dtype)

        def make():
            cache = model.init_cache(1, total, self.cache_dtype, self.device, ctx=ctx)

            def prefill(tokens, last_index, **extra):
                logits, out = model.prefill(ctx, params, {"tokens": tokens, **extra}, cache,
                                            last_index=last_index)
                return logits, out["layers"], out.get("cross")

            return prefill, dict(tokens=((1, bucket), torch.int32),
                                 last_index=((), torch.int32),
                                 **{k: (shape, dtype) for k, shape in self._extra_shapes.items()})

        return bucket, self._programs.prefill(bucket, make), nb

    def _insert(self, layer_caches, cross, block_ids: List[int], slot: int) -> None:
        """Scatter a one-request dense prefill cache into the slot's blocks
        in every attention layer's pools (in place), through the same row
        codec and writer as the step appends (MX-quantized per position on
        wire pools; positions past an exact-length prompt's end zero, as the
        reference pads them), each recurrent layer's cache into row ``slot``
        of its ``state["rec"]`` entry and an encoder-decoder's cross K/V
        (``cross``, per layer) into row ``slot`` of ``state["cross_k"]`` /
        ``state["cross_v"]`` (all in place: a captured decode step reads
        those addresses)."""
        if cross is not None:
            for held_k, held_v, kv in zip(self._state["cross_k"], self._state["cross_v"],
                                          cross):
                held_k[slot].copy_(kv.k[0])
                held_v[slot].copy_(kv.v[0])
        nb, bs = len(block_ids), self.block_size
        pos = torch.arange(nb * bs, device=self.device)
        blk = torch.tensor(block_ids, dtype=torch.long, device=self.device)[pos // bs]
        attn = [c for c, spec in zip(layer_caches, self.cfg.layers) if spec.kind == "attn"]
        rec = [c for c, spec in zip(layer_caches, self.cfg.layers) if spec.kind != "attn"]
        for held, c in zip(self._state["rec"], rec):
            for t, new in zip(held, c):
                t[slot].copy_(new[0])
        for i, c in enumerate(attn):
            pk, pv = self._state["pools_k"][i], self._state["pools_v"][i]
            k, v = c.k[0], c.v[0]
            if k.shape[0] < nb * bs:   # an exact-length prompt: zero to the block's end
                k, v = (torch.nn.functional.pad(t, (0, 0, 0, nb * bs - t.shape[0]))
                        for t in (k, v))
            k_rows, v_rows = pool_rows(k, v, pk, self.cache_spec)
            if self.ctx.kv_sharded:   # each rank writes the blocks it owns
                vals = [r.reshape(nb, bs, -1) for r in pool_planes(k_rows, v_rows)]
                pool_block_write(self.ctx, list(zip(pool_planes(pk, pv), vals)), block_ids)
            else:
                write_pool_rows(pk, pv, k_rows, v_rows, blk, pos % bs)

    def _pool_planes(self) -> List[torch.Tensor]:
        """Every layer's K and V pool planes (payload and scales of wire
        pools)."""
        return [a for pk, pv in zip(self._state["pools_k"], self._state["pools_v"])
                for a in pool_planes(pk, pv)]

    def _cow(self, src: int, dst: int) -> None:
        """Copy block ``src`` to block ``dst`` in every layer's K/V pools (in
        place; payload and scales of wire pools): the private copy a slot
        writes into instead of a shared tail block. Sharded pools: the owner
        of ``src`` sends the block over the kv group, the owner of ``dst``
        writes it."""
        if self.ctx.kv_sharded:
            pool_block_copy(self.ctx, self._pool_planes(), src, dst)
            return
        for a in self._pool_planes():
            a[dst] = a[src]

    # ------------------------------------------------------------- sampling

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                rows: List[int]) -> np.ndarray:
        """One token per logits row. Under the corruption watch each row's
        finite flag rides in the same device-to-host copy as the tokens, and
        the ``rows`` that sample a token are checked before any host state
        takes them (``_check_finite``); without it the step does no extra
        device work."""
        fin = None
        if self._nan_watch:
            fin = torch.isfinite(logits).all(dim=-1)
            logits = torch.where(fin[:, None], logits, 0.0)  # keep NaN from multinomial
        toks = torch.argmax(logits, dim=-1)
        if (temps > 0).any():
            t = torch.as_tensor(np.maximum(temps, 1e-6), device=logits.device)[:, None]
            probs = torch.softmax(logits.float() / t, dim=-1)
            drawn = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            toks = torch.where(torch.as_tensor(temps > 0, device=logits.device), drawn, toks)
        if fin is None:
            return toks.cpu().numpy().astype(np.int32)
        host = torch.stack([toks, fin.to(toks.dtype)]).cpu().numpy()
        self._check_finite(host[1], rows)
        return host[0].astype(np.int32)

    def _check_finite(self, finite: np.ndarray, rows: List[int]) -> None:
        """The WireCorruption watch: raise if a row about to contribute a
        sampled token holds non-finite logits (a poisoned pool block reached
        the sampling boundary)."""
        bad = [r for r in rows if not finite[r]]
        if bad:
            raise WireCorruption(
                f"non-finite logits at sampling row(s) {bad} (step {self._step_i}) — a "
                f"corrupted KV pool block reached the sampling boundary; pools must be "
                f"rebuilt (hard recovery)")

    def _sample_one(self, logits: torch.Tensor, w: _Work) -> int:
        self._finite &= torch.isfinite(logits).all()
        return int(self._sample(logits, np.array([w.req.temperature], np.float32), [0])[0])

    # ------------------------------------------------------------ scheduling

    def _free_slot(self) -> Optional[int]:
        for s in range(self.n_slots):
            if s not in self._running:
                return s
        return None

    def _admit_ready(self, now: float) -> None:
        if self._degraded and self._running:
            return  # thrash degradation: no admissions until a retire
        while self._waiting and self._waiting[0].arrival <= now:
            slot = self._free_slot()
            if slot is None:
                return
            w = self._waiting[0]
            if self.prefill_chunk:
                # chunked admission takes just a slot: blocks arrive as chunks land
                self._waiting.pop(0)
                self._admit_chunked(w, slot, now)
                continue
            _, _, nb = self._prefill_for(len(w.prompt))   # an LRU touch, as the reference's
            ids = self.allocator.alloc(nb)
            if ids is None:
                if not self._running and not self.allocator.n_held:
                    raise PoolExhausted(
                        f"prefill needs {nb} KV blocks; only {self.allocator.n_free} "
                        f"free and nothing to evict — pool too small for this request")
                return  # decode will retire or evict slots and free blocks
            self._waiting.pop(0)
            self._admit(w, slot, ids)

    def _admit_chunked(self, w: _Work, slot: int, now: float) -> None:
        """Move a request into a slot, PREFILLING; with the prefix cache on,
        cached prompt blocks are mapped into its table first."""
        w.blocks, w.pos, w.prefilling = [], 0, True
        self._clear_slot(slot)
        if self.prefix_index is not None:
            self._match_prefix(w, slot)
        if w.admitted_t is None:
            w.admitted_t = now
        self._running[slot] = w

    def _match_prefix(self, w: _Work, slot: int) -> None:
        """Map the longest indexed prefix of ``w.prompt`` into the slot.

        Matches are cut to multiples of ``lcm(block_size, prefill_chunk)`` so
        the warm suffix recomputes with the writer's chunk boundaries. A
        full-prompt match must still recompute the last token's logits: on
        exact pools the tail shared block is forked (copy on write) and only
        token L-1 is recomputed; on lossy pools (or with no block for the
        fork) prefill resumes at the last aligned boundary before L."""
        L = len(w.prompt)
        bs = self.block_size
        w.hashes = PrefixIndex.chain(w.prompt, bs)
        ids = self.prefix_index.match(w.hashes)
        grain = math.lcm(bs, self.prefill_chunk)
        if ids and len(ids) * bs < L:
            ids = ids[:(len(ids) * bs // grain) * grain // bs]
        if not ids:
            return
        self.allocator.share(ids)
        w.blocks = list(ids)
        m_tok = len(w.blocks) * bs
        if m_tok >= L:  # full-prompt hit: recompute the last token's logits
            fork = self.allocator.alloc(1) if self._exact_pools else None
            if fork is not None:
                self._cow(w.blocks[-1], fork[0])
                self.stats.record_dispatch(1)  # the COW block fork
                self.allocator.release([w.blocks[-1]])
                w.blocks[-1] = fork[0]
                m_tok = L - 1
            else:
                keep = ((L - 1) // grain) * grain // bs
                self.allocator.release(w.blocks[keep:])
                del w.blocks[keep:]
                m_tok = keep * bs
                if not w.blocks:
                    return
        w.pos = m_tok
        w.cached_tokens += m_tok
        self.prefix_index.hit_blocks += len(w.blocks)
        self._tables[slot, :len(w.blocks)] = w.blocks
        self._lengths[slot] = w.pos

    def _alloc_for_chunk(self, slot: int, w: _Work, n_valid: int) -> bool:
        """Allocate the blocks covering ``n_valid`` more prompt tokens,
        evicting the latest-arrival request under pressure (LIFO). False when
        the slot is itself the victim (it defers in place, keeping its
        written chunks) or the step's preemption budget is spent."""
        need = -(-(w.pos + n_valid) // self.block_size)
        while True:
            got = self.allocator.alloc_to(w.blocks, need)
            if got is not None:
                self._tables[slot, need - len(got):need] = got
                return True
            victim = max(self._running, key=lambda s: (self._running[s].arrival, s))
            if victim == slot:
                if len(self._running) == 1 and not self.allocator.n_held:
                    raise PoolExhausted(
                        f"prefill chunk needs {need - len(w.blocks)} KV blocks; only "
                        f"{self.allocator.n_available} available and nothing to "
                        f"evict — pool too small for this request")
                return False
            if self._step_preempts >= self.max_preempts_per_step:
                return False  # storm guard: defer instead of another victim
            self._preempt(victim)

    def _advance_prefill(self, slot: int, w: _Work, n_valid: int) -> None:
        """Account ``n_valid`` freshly written prompt tokens and publish every
        prompt block they completed."""
        old_pos = w.pos
        w.pos += n_valid
        self._lengths[slot] = w.pos
        if self.prefix_index is not None:
            for j in range(old_pos // self.block_size,
                           min(w.pos // self.block_size, len(w.hashes))):
                self.prefix_index.register(w.hashes[j], w.blocks[j])

    def _first_token(self, slot: int, w: _Work, tok: int, now: float) -> None:
        """The sampled token ends PREFILLING and is the TTFT endpoint."""
        w.prefilling = False
        self._cur[slot] = tok
        if w.first_token_t is None:
            w.first_token_t = now
        w.tokens.append(tok)
        w.token_times.append(now)
        if w.done:
            self._retire(slot, now)

    def _prefill_step(self) -> int:
        """Split scheduler: ONE chunk of the earliest-arrival PREFILLING slot.
        Returns the prompt tokens processed (0 if no chunk ran)."""
        pref = [s for s, w in self._running.items() if w.prefilling]
        if not pref:
            return 0
        slot = min(pref, key=lambda s: (self._running[s].arrival, s))
        w = self._running[slot]
        L = len(w.prompt)
        n_valid = min(self.prefill_chunk, L - w.pos)
        if not self._alloc_for_chunk(slot, w, n_valid):
            return 0
        tokens = np.zeros((1, self.prefill_chunk), np.int32)
        tokens[0, :n_valid] = w.prompt[w.pos:w.pos + n_valid]
        logits = self._chunk_program()(tokens=tokens, table_row=self._tables[slot],
                                       start=w.pos, n_valid=n_valid)
        self._advance_prefill(slot, w, n_valid)
        if w.pos >= L:  # final chunk: its logits give the first token
            tok = self._sample_one(logits, w)
            self._first_token(slot, w, tok, time.perf_counter() - self._t0)
        return n_valid

    def _pack_prefill(self, budget: int) -> List:
        """Place PREFILLING slots' chunks, earliest arrival first, into the
        remaining budget: only full split-schedule chunks (``min(chunk,
        remaining prompt)``); a chunk that does not fit waits a step, and a
        slot that cannot get blocks defers without blocking the rest."""
        segs = []
        pref = sorted((s for s, w in self._running.items() if w.prefilling),
                      key=lambda s: (self._running[s].arrival, s))
        for slot in pref:
            if budget <= 0:
                break
            if slot not in self._running:   # evicted packing an earlier slot
                continue
            w = self._running[slot]
            n = min(self.prefill_chunk, len(w.prompt) - w.pos)
            if n > budget:
                continue
            if n <= 0 or not self._alloc_for_chunk(slot, w, n):
                continue
            segs.append((slot, w.prompt[w.pos:w.pos + n], w.pos))
            budget -= n
            if self._degraded:
                break  # thrash degradation: one chunk per step
        return segs

    def _step_mixed(self) -> int:
        """One engine step: pack prefill chunks + the decode batch into one
        mixed step, run the gate variant the step's real composition picks,
        sample every slot that produced a token. Returns real tokens run."""
        self._grow_or_evict()
        decoding = sorted(s for s, w in self._running.items() if not w.prefilling)
        segs = self._pack_prefill(self.token_budget - len(decoding))
        decoding = [s for s in decoding if s in self._running]  # packing may evict
        if not segs and not decoding:
            return 0
        batch = build_mixed_batch(
            segs, [(s, int(self._cur[s]), int(self._lengths[s])) for s in decoding],
            self.token_budget, self.n_slots)
        gate = (True in self._gate_ctxs
                and self._gate_policy.active_for_step(batch.n_prefill, batch.n_decode))
        logits = self._mixed_program(gate)(
            tokens=batch.tokens, slot_ids=batch.slot_ids, positions=batch.positions,
            valid=batch.valid, is_decode=batch.is_decode, lengths=self._lengths,
            tables=self._tables, sample_idx=batch.sample_idx)
        self.gate_counts["compressed" if gate else "dense"] += 1
        self.stats.record_step(batch.n_prefill, batch.n_decode, n_dispatches=1,
                               compressed=gate)
        self._finite &= torch.isfinite(logits).all()

        temps = np.zeros((self.n_slots,), np.float32)
        for slot, _, _ in segs:
            temps[slot] = self._running[slot].req.temperature
        for slot in decoding:
            self._lengths[slot] += 1
            temps[slot] = self._running[slot].req.temperature
        toks = self._sample(logits, temps, decoding + [
            slot for slot, chunk, _ in segs
            if self._running[slot].pos + len(chunk) >= len(self._running[slot].prompt)])
        now = time.perf_counter() - self._t0

        for slot, chunk, _ in segs:
            w = self._running[slot]
            self._advance_prefill(slot, w, len(chunk))
            if w.pos >= len(w.prompt):
                self._first_token(slot, w, int(toks[slot]), now)
        self._take_tokens(decoding, toks, now)
        return batch.n_prefill + batch.n_decode

    def _take_tokens(self, slots: List[int], toks: np.ndarray, now: float) -> None:
        """Append each decoding slot's sampled token; retire finished ones."""
        for slot in slots:
            w = self._running[slot]
            tok = int(toks[slot])
            w.tokens.append(tok)
            w.token_times.append(now)
            self._cur[slot] = tok
            if w.done:
                self._retire(slot, now)

    def _admit(self, w: _Work, slot: int, ids: List[int]) -> None:
        """Whole-prompt admission: prefill the prompt right-padded to its
        bucket (after a vision prefix; with the request's extra inputs),
        sample its first token, insert its cache into ``ids``."""
        L = len(w.prompt)
        bucket, prefill, nb = self._prefill_for(L)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :L] = w.prompt
        logits, cache, cross = prefill(tokens=tokens, last_index=self._n_prefix + L - 1,
                                       **w.extra)
        self.stats.record_dispatch(2, prefill_tokens=L)  # prefill + insert
        tok = self._sample_one(logits, w)
        self._insert(cache, cross, ids, slot)
        now = time.perf_counter() - self._t0
        w.blocks = ids
        self._tables[slot, :] = 0
        self._tables[slot, :nb] = ids
        self._lengths[slot] = self._n_prefix + L
        if w.admitted_t is None:
            w.admitted_t = now
        self._running[slot] = w
        self._first_token(slot, w, tok, now)

    def _grow_or_evict(self) -> None:
        """Give every DECODING slot a block covering its next write position,
        preempting the latest-arrival request when the pool runs dry."""
        decoding = [s for s in self._running if not self._running[s].prefilling]
        for slot in sorted(decoding, key=lambda s: self._running[s].arrival):
            if slot not in self._running:  # preempted by an earlier iteration
                continue
            w = self._running[slot]
            while len(w.blocks) * self.block_size <= self._lengths[slot]:
                got = self.allocator.alloc(1)
                if got is None:
                    victim = max(self._running,
                                 key=lambda s: (self._running[s].arrival, s))
                    if (victim == slot and len(self._running) == 1
                            and not self.allocator.n_held):
                        raise PoolExhausted(
                            "KV pool exhausted with a single request in flight — "
                            "n_blocks too small for prompt+decode")
                    # a decode slot cannot defer in place (its next write needs
                    # a real block), so growth ignores the per-step budget
                    self._preempt(victim)
                    if victim == slot:
                        break
                    continue
                w.blocks += got
                self._tables[slot, len(w.blocks) - 1] = got[0]

    def _preempt(self, slot: int) -> None:
        """Evict-and-recompute: free the slot, fold the generated tokens into
        the prompt and requeue by arrival; readmission rebuilds the KV."""
        w = self._running.pop(slot)
        self.allocator.release(w.blocks)  # shared blocks survive in the index
        w.blocks = []
        w.prefilling = False
        w.pos = 0
        w.hashes = None
        self._clear_slot(slot)
        w.prompt = np.concatenate([np.asarray(w.req.prompt, np.int32),
                                   np.asarray(w.tokens, np.int32)])
        w.preemptions += 1
        self._step_preempts += 1
        bisect.insort(self._waiting, w, key=lambda x: x.arrival)

    def _decode_once(self) -> int:
        """One batched decode over every slot; PREFILLING and empty slots ride
        along (their writes land where the next chunk overwrites them or in
        the null block) and their tokens are discarded. Returns the decode
        tokens sampled."""
        logits = self._decode_program()(tokens=self._cur[:, None], tables=self._tables,
                                        lengths=self._lengths)
        self._finite &= torch.isfinite(logits).all()
        active = [s for s, w in self._running.items() if not w.prefilling]
        temps = np.zeros((self.n_slots,), np.float32)
        for slot in active:
            self._lengths[slot] += 1
            temps[slot] = self._running[slot].req.temperature
        toks = self._sample(logits, temps, active)
        self._take_tokens(active, toks, time.perf_counter() - self._t0)
        return len(active)

    def _clear_slot(self, slot: int) -> None:
        self._tables[slot, :] = 0
        self._lengths[slot] = 0
        self._cur[slot] = 0

    def _retire(self, slot: int, now: float) -> None:
        self._finish(slot, OUTCOME_OK, now)

    def _finish(self, slot: int, outcome: str, now: float) -> None:
        """Terminal exit of a running slot, for any outcome: release its
        blocks (shared ones stay in the index), clear its table row, record
        the timing. An ``ok`` retire ends thrash degradation."""
        w = self._running.pop(slot)
        self.allocator.release(w.blocks)
        w.blocks = []
        self._clear_slot(slot)
        self._record_terminal(w, outcome, now)
        if outcome == OUTCOME_OK:
            self._degraded = False

    def _record_terminal(self, w: _Work, outcome: str, now: float) -> None:
        """Fill the request's output and timing at its terminal outcome, with
        the tokens generated so far (the caller has released its blocks)."""
        r = w.req
        gen = w.tokens[: r.max_new_tokens]
        r.output = np.asarray(gen, np.int32)
        r.timing = RequestTiming(
            arrival_s=w.arrival, admitted_s=w.admitted_t, first_token_s=w.first_token_t,
            finished_s=now, n_prompt=len(np.asarray(r.prompt)), n_generated=len(gen),
            n_preemptions=w.preemptions, n_cached_prompt=w.cached_tokens,
            inter_token_s=[b - a for a, b in zip(w.token_times, w.token_times[1:])],
            outcome=outcome)
        r.ttft_s = r.timing.ttft_s if w.first_token_t is not None else None
        r.latency_s = r.timing.latency_s
        self.stats.record(r.timing)

    def _expired(self, w: _Work, now: float) -> Optional[str]:
        """The terminal outcome ``w`` should leave with now, or None.
        Cancellation wins over deadlines; deadlines measure from arrival, and
        the TTFT deadline stops applying once a first token exists."""
        if w.req.cancelled:
            return OUTCOME_CANCELLED
        if w.arrival > now:
            return None  # not in the system yet
        d = w.req.deadline_s if w.req.deadline_s is not None else self.deadline_s
        if d is not None and now - w.arrival >= d and not w.done:
            return OUTCOME_TIMED_OUT
        dt = (w.req.deadline_ttft_s if w.req.deadline_ttft_s is not None
              else self.deadline_ttft_s)
        if dt is not None and w.first_token_t is None and now - w.arrival >= dt:
            return OUTCOME_TIMED_OUT
        return None

    def _sweep_terminal(self, now: float) -> None:
        """Before admission: move every cancelled or expired request, waiting
        or running, to its terminal outcome."""
        kept: List[_Work] = []
        for w in self._waiting:  # filtering keeps arrival order
            oc = self._expired(w, now)
            if oc is None:
                kept.append(w)
            else:
                self._record_terminal(w, oc, now)
        self._waiting = kept
        for slot in list(self._running):
            oc = self._expired(self._running[slot], now)
            if oc is not None:
                self._finish(slot, oc, now)

    def _bound_queue(self, now: float) -> None:
        """After admission has filled every free slot: arrived requests never
        admitted, beyond the first ``max_queue``, leave ``rejected``.
        Preempted requeues were accepted already and are exempt."""
        if self.max_queue is None:
            return
        arrived = [w for w in self._waiting if w.arrival <= now and w.admitted_t is None]
        drop = arrived[self.max_queue:]
        if drop:
            ids = {id(w) for w in drop}
            self._waiting = [w for w in self._waiting if id(w) not in ids]
            for w in drop:
                self._record_terminal(w, OUTCOME_REJECTED, now)

    # ------------------------------------------------------ faults & recovery

    def _apply_faults(self) -> None:
        """Fire the fault plan's events due at this step and expire earlier
        holds (``serving/faults.py`` names the kinds)."""
        if self._hold_until and self._step_i >= self._hold_until:
            self.allocator.unhold()
            self._hold_until = 0
        for f in self.fault_plan.take(self._step_i):
            if f.kind == "exhaust":
                self.allocator.hold(f.n_blocks)
                self._hold_until = max(self._hold_until, self._step_i + f.duration)
            elif f.kind == "corrupt":
                self._corrupt_block(f.block)
            elif f.kind == "slow":
                time.sleep(f.sleep_s)
            elif f.kind == "stuck":
                time.sleep(max(f.sleep_s, 2.0 * (self.step_timeout_s or 0.05)))
            elif f.kind == "die":
                raise EngineDead(
                    f"fault injection: engine died at step {self._step_i} with "
                    f"{len(self._running)} in-flight and {len(self._waiting)} queued "
                    f"request(s)")

    def _corrupt_block(self, block: int) -> None:
        """Poison one pool block in every attention layer's K and V pool, in
        place: scale bytes 255 (2^128, so the block decodes to inf and NaN)
        in MX pools, NaN in dense pools; payload bytes stay. ``block`` -1
        picks the lowest live block (nothing happens when none is live). On
        sharded pools only the owner of the block writes. Recurrent state is
        left as it is, as the reference leaves it (a stack without
        attention layers has nothing to poison)."""
        if block < 0:
            live = sorted(b for w in self._running.values() for b in w.blocks)
            if not live:
                return
            block = live[0]
        if self.ctx.kv_sharded:
            q = self.cache_spec.quantized
            if not self._state["pools_k"]:
                return
            pool_block_fill(self.ctx, [(p.scales if q else p, 255 if q else float("nan"))
                                       for p in self._state["pools_k"] + self._state["pools_v"]],
                            block)
            return
        for pool in self._state["pools_k"] + self._state["pools_v"]:
            if self.cache_spec.quantized:
                pool.scales[block] = 255
            else:
                pool[block] = float("nan")

    def recover(self, *, hard: bool = True) -> None:
        """Make the engine runnable again after ``run`` aborted with
        ``EngineDead`` / ``StepStuck`` / ``WireCorruption`` (the
        ``EngineSupervisor`` calls this between attempts).

        ``hard=True`` (pools lost or poisoned): the pools are zeroed in place
        and the allocator and prefix index rebuilt here, so the recovery's
        time includes the rebuild (the reference rebuilds at the next
        ``run()``; the next run keeps these). The step programs survive, as
        the reference's compiled programs do. ``hard=False`` on a
        ``persistent_cache`` engine (StepStuck: pools healthy): the in-flight
        requests' blocks are released and the pools and index stay warm for
        the replay."""
        if hard or not self.persistent_cache:
            self._reset()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._fresh = True
            return
        for slot in list(self._running):
            w = self._running.pop(slot)
            self.allocator.release(w.blocks)
            w.blocks = []
        self.allocator.unhold()      # expire fault holds mid-flight
        self._soft_reset()

    def _guard_step(self, n_tok: int, elapsed_s: float) -> None:
        """After each step: the capacity peaks, the step watchdog (a step
        slower than ``step_timeout_s``: the step ends in the device-to-host
        copy of its sampled tokens, so its wall time holds the device's), the
        stall guard (``stall_limit`` steps in a row without a token, unless
        blocks are fault-held, which expire on schedule) and the thrash
        detector."""
        self.max_resident_ctx = max(self.max_resident_ctx, int(self._lengths.max(initial=0)))
        self.max_resident_blocks = max(self.max_resident_blocks,
                                       self.n_blocks - 1 - self.allocator.n_free)
        if self.step_timeout_s is not None and elapsed_s > self.step_timeout_s:
            raise StepStuck(
                f"engine step {self._step_i} took {elapsed_s:.3f}s (step_timeout_s="
                f"{self.step_timeout_s}); treating the step loop as wedged")
        if n_tok > 0:
            self._stall = 0
        elif not self.allocator.n_held:
            self._stall += 1
            if self.stall_limit and self._stall >= self.stall_limit:
                raise StepStuck(
                    f"no token progress for {self._stall} consecutive steps with "
                    f"{len(self._running)} slot(s) in flight — scheduler livelock")
        self._preempt_window.append(self._step_preempts)
        if not self._degraded and sum(self._preempt_window) >= self.thrash_limit:
            self._degraded = True

    # ------------------------------------------------------------------ API

    def _extras(self, extra_inputs, n: int) -> List[Dict[str, object]]:
        """The slices ``[i:i+1]`` of the model's extra inputs for the first
        ``n`` rows (``Model`` needs every one of ``frontend_shapes``; a text
        decoder takes none), each input checked against its row shape."""
        given = dict(extra_inputs or {})
        if set(given) != set(self._extra_shapes):
            raise ValueError(f"{self.cfg.name}: extra_inputs {sorted(given)}, the model takes "
                             f"{sorted(self._extra_shapes)} (one row per request)")
        for k, (_, *row) in self._extra_shapes.items():
            if tuple(given[k].shape[1:]) != tuple(row) or given[k].shape[0] < n:
                raise ValueError(f"{self.cfg.name}: extra input {k} of shape "
                                 f"{tuple(given[k].shape)}, expected ({n}, "
                                 f"{', '.join(map(str, row))})")
        return [{k: v[i:i + 1] for k, v in given.items()} for i in range(n)]

    def run(self, requests: List[Request], *, seed: int = 0,
            extra_inputs: Optional[Dict[str, object]] = None) -> List[Request]:
        """Serve ``requests`` (``arrival_s`` honoured against the run's wall
        clock); returns them with output/ttft/latency/timing filled. With
        ``persistent_cache`` the pools, allocator and prefix index carry over
        from the previous run. ``extra_inputs`` are the model's extra inputs
        with one row per request (a vision model's ``patch_embeds``, an
        encoder-decoder's ``encoder_frames``; ``models/frontends.py``),
        sliced per request for its prefill."""
        if self._fresh:
            self._fresh = False          # recover() rebuilt the pools already
        elif self.persistent_cache and self._ran:
            self._soft_reset()
        else:
            self._reset()
        self._ran = True
        self.stats = ServeStats()
        self.gate_counts = {"compressed": 0, "dense": 0}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._t0 = time.perf_counter()
        capacity = self.max_blocks * self.block_size
        works = []
        if self._lockstep and any(r.arrival_s or r.deadline_s or r.deadline_ttft_s
                                  for r in requests):
            raise ValueError("sequence-sharded pools, TP groups and data groups: requests "
                             "arrive at t=0 with no deadline (each rank's clock would admit "
                             "and expire them at its own step)")
        extras = self._extras(extra_inputs, len(requests))
        for i, r in enumerate(requests):
            need = self._n_prefix + len(np.asarray(r.prompt)) + r.max_new_tokens - 1
            if need > capacity:
                raise InvalidRequest(
                    f"request {i}: prompt+decode needs {need} cache positions but "
                    f"max_len={self.max_len} provides {capacity}")
            works.append(_Work(req=r, prompt=np.asarray(r.prompt, np.int32),
                               arrival=float(r.arrival_s), extra=extras[i]))
        self._waiting = sorted(works, key=lambda w: w.arrival)
        try:
            while self._waiting or self._running:
                now = time.perf_counter() - self._t0
                self._sweep_terminal(now)
                self._admit_ready(now)
                self._bound_queue(now)
                if not self._running:
                    if self._waiting:
                        time.sleep(min(max(self._waiting[0].arrival - now, 0.0), 0.005))
                    continue
                self._step_i += 1
                self._step_preempts = 0
                t_step = time.perf_counter()
                if self.fault_plan is not None:
                    self._apply_faults()
                if self.token_budget:
                    n_tok = self._step_mixed()
                else:
                    # split scheduler: at most one prefill chunk, then a
                    # batched decode of every DECODING slot
                    n_pref = self._prefill_step() if self.prefill_chunk else 0
                    self._grow_or_evict()
                    n_dec = 0
                    if any(not w.prefilling for w in self._running.values()):
                        n_dec = self._decode_once()
                    self.stats.record_step(n_pref, n_dec,
                                           n_dispatches=(1 if n_pref else 0) + (1 if n_dec else 0))
                    n_tok = n_pref + n_dec
                self._guard_step(n_tok, time.perf_counter() - t_step)
        finally:
            # fault holds never outlive a run, whether it ended or aborted
            if self.allocator.n_held:
                self.allocator.unhold()
                self._hold_until = 0
        return requests

    def measure_ttft(self, prompt_len: int, *, iters: int = 8,
                     extra_inputs: Optional[Dict[str, object]] = None) -> Dict[str, float]:
        """Median whole-prompt prefill time at a given prompt length (the
        paper's Table 3 metric), through the bucketed prefill the engine
        serves; the first iteration is dropped as warm-up when there are
        more than one (on the card that iteration captures the bucket's
        graph). Times on the host clock around work that ends in a device
        synchronize. ``prompt_len`` counts text tokens; a vision model's
        prefix and an encoder-decoder's encoder run too, on the first row of
        ``extra_inputs`` (which such a model needs)."""
        prompt = np.random.default_rng(0).integers(
            0, self.cfg.vocab_size, (prompt_len,), dtype=np.int64).astype(np.int32)
        bucket, prefill, _ = self._prefill_for(prompt_len)
        extra = self._extras(extra_inputs, 1)[0]
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :prompt_len] = prompt
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = prefill(tokens=tokens, last_index=self._n_prefix + prompt_len - 1, **extra)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times.append(time.perf_counter() - t0)
            del out
        if len(times) > 1:
            times = times[1:]
        arr = np.array(times)
        return {"median_s": float(np.median(arr)), "std_s": float(np.std(arr)),
                "iters": len(times)}
