"""Continuous-batching serving engine over a paged KV cache — the port of the
reference engine's unified mixed token-budget scheduler.

Every engine step flattens up to ``token_budget`` tokens — several
PREFILLING slots' prompt chunks plus one token per DECODING slot — into a
single mixed batch and runs one ``Model.mixed_step``. Under an active
compression policy the engine holds two gate variants of the step (the
compressed context and ``ctx.without_compression()``) and picks one per step
with ``CompressionPolicy.active_for_step`` on the batch's REAL prefill and
decode token counts: prefill-dominated steps take the compressed reduction,
decode-dominated steps stay dense.

Not ported yet (the constructor raises on each): the split scheduler
(``token_budget=0``), whole-prompt prefill (``prefill_chunk=0``), prefix
caching, fault injection, deadlines and bounded admission. Sequence-sharded
pools cannot be asked for: ``TPContext`` has no kv axis yet. There is no
preemption either: under the default full provisioning
an allocation never fails, and when a smaller ``n_blocks`` runs dry the
engine raises ``PoolExhausted``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.formats import KVCacheSpec, MXSpec
from repro_torch.core.tp import TPContext
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.errors import (
    OUTCOME_OK, InvalidRequest, PoolExhausted, SlotExhausted,
)
from repro_torch.serving.kv_cache import (
    BlockAllocator, build_mixed_batch, check_cache_spec, init_paged_state,
    paged_cache_bytes,
)
from repro_torch.serving.ttft import RequestTiming, ServeStats

__all__ = ["Request", "Engine"]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # int32 token ids (non-empty)
    max_new_tokens: int = 16
    temperature: float = 0.0
    arrival_s: float = 0.0        # offset from run() start (staggered traffic)
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

    @property
    def outcome(self) -> Optional[str]:
        return self.timing.outcome if self.timing is not None else None


@dataclasses.dataclass
class _Work:
    """Scheduler-internal request state."""

    req: Request
    prompt: np.ndarray
    arrival: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    admitted_t: Optional[float] = None
    first_token_t: Optional[float] = None
    prefilling: bool = False      # prompt still streaming in chunk by chunk
    pos: int = 0                  # prompt tokens already written to the pools
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.req.max_new_tokens


class Engine:
    """Continuous-batching engine: FIFO admission by arrival time into
    ``max_slots`` slots, chunked prefill packed with the decode batch into one
    mixed token-budget step per engine step, per-step compression gate.

    ``run(requests)`` serves a list of ``Request``s, fills their ``output`` /
    ``ttft_s`` / ``latency_s`` / ``timing`` and leaves per-run aggregates in
    ``self.stats`` and per-gate step counts in ``self.gate_counts``. Runs on
    the card unless ``device="cpu"``; params must live on that device.
    """

    def __init__(self, model: Model, params, ctx: TPContext, *,
                 max_len: int, max_slots: int = 4, block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 cache_spec: "KVCacheSpec | MXSpec | str | None" = None,
                 prefill_chunk: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 max_queue: Optional[int] = None,
                 deadline_ttft_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 fault_plan=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        unported = {
            "prefix_cache": prefix_cache, "max_queue": max_queue is not None,
            "deadline_ttft_s": deadline_ttft_s is not None,
            "deadline_s": deadline_s is not None, "fault_plan": fault_plan is not None,
            "token_budget=0 (split scheduler)": token_budget == 0,
            "prefill_chunk=0 (whole-prompt prefill)": prefill_chunk == 0,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                f"not ported yet: {', '.join(asked)} (the port serves the mixed "
                f"token-budget scheduler only)")
        self.model = model
        self.cfg = model.cfg
        self.ctx = ctx
        self.params = params
        if max_slots <= 0:
            raise SlotExhausted(f"max_slots must be >= 1, got {max_slots}")
        self.n_slots = max_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = -(-max_len // block_size)
        # full provisioning by default (+1 for the reserved null block)
        self.n_blocks = n_blocks or (self.n_slots * self.max_blocks + 1)
        self.cache_dtype = cache_dtype or torch.bfloat16
        self.cache_spec = check_cache_spec(self.cfg, cache_spec)
        self.stats = ServeStats()

        if prefill_chunk is None:
            prefill_chunk = 2 * block_size
        elif prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 1")
        self.prefill_chunk = int(prefill_chunk)
        if token_budget is None:
            token_budget = self.prefill_chunk + self.n_slots
        elif token_budget < 0:
            raise ValueError("token_budget must be >= 1")
        elif token_budget < self.n_slots + self.prefill_chunk:
            # one decode token per slot plus one full chunk, so packing only
            # ever places full chunks (chunk boundaries, and therefore which
            # tokens attend each other at compute vs pool precision, never
            # depend on packing timing)
            raise ValueError(
                f"token_budget ({token_budget}) must cover one decode token per "
                f"slot plus one full prefill chunk (max_slots={self.n_slots} + "
                f"prefill_chunk={self.prefill_chunk})")
        self.token_budget = int(token_budget)

        # per-step gate on the batch's REAL composition
        self._gate_ctxs: Dict[bool, TPContext] = {False: ctx.without_compression()}
        if ctx.policy.enabled and ctx.policy.compress_tp_reduce:
            self._gate_ctxs[True] = ctx
        self.gate_counts = {"compressed": 0, "dense": 0}
        self._reset()

    # ------------------------------------------------------------- state mgmt

    def _reset(self) -> None:
        self.allocator = BlockAllocator(self.n_blocks)
        self._state = init_paged_state(self.cfg, self.n_slots, self.n_blocks,
                                       self.block_size, self.cache_dtype,
                                       cache_spec=self.cache_spec, device=self.device)
        self._tables = np.zeros((self.n_slots, self.max_blocks), np.int32)
        self._lengths = np.zeros((self.n_slots,), np.int32)
        self._cur = np.zeros((self.n_slots,), np.int32)
        self._running: Dict[int, _Work] = {}
        self._waiting: List[_Work] = []
        self._finite = torch.ones((), dtype=torch.bool, device=self.device)

    def gate_variants(self) -> List[str]:
        """Names of the step variants this engine dispatches between."""
        return [("compressed" if g else "dense") for g in sorted(self._gate_ctxs)]

    def kv_pool_bytes(self) -> int:
        return paged_cache_bytes(self.cfg, self.n_blocks, self.block_size,
                                 dtype_bytes=torch.empty((), dtype=self.cache_dtype)
                                 .element_size(),
                                 cache_spec=self.cache_spec)

    def logits_finite(self) -> bool:
        """Whether every step of the last run produced finite logits."""
        return bool(self._finite)

    # ------------------------------------------------------------- sampling

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        toks = torch.argmax(logits, dim=-1)
        if (temps > 0).any():
            t = torch.as_tensor(np.maximum(temps, 1e-6), device=logits.device)[:, None]
            probs = torch.softmax(logits.float() / t, dim=-1)
            drawn = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            toks = torch.where(torch.as_tensor(temps > 0, device=logits.device), drawn, toks)
        return toks.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------ scheduling

    def _free_slot(self) -> Optional[int]:
        for s in range(self.n_slots):
            if s not in self._running:
                return s
        return None

    def _admit_ready(self, now: float) -> None:
        """FIFO admission of arrived requests into free slots, PREFILLING:
        blocks arrive chunk by chunk as the prompt streams in."""
        while self._waiting and self._waiting[0].arrival <= now:
            slot = self._free_slot()
            if slot is None:
                return
            w = self._waiting.pop(0)
            w.blocks, w.pos, w.prefilling = [], 0, True
            self._clear_slot(slot)
            if w.admitted_t is None:
                w.admitted_t = now
            self._running[slot] = w

    def _alloc_for_chunk(self, slot: int, w: _Work, n_valid: int) -> None:
        """Allocate the blocks covering ``n_valid`` more prompt tokens."""
        need = -(-(w.pos + n_valid) // self.block_size)
        got = self.allocator.alloc_to(w.blocks, need)
        if got is None:
            raise PoolExhausted(
                f"prefill chunk needs {need - len(w.blocks)} KV blocks; only "
                f"{self.allocator.n_free} free (the port has no preemption: size "
                f"n_blocks for the traffic or leave it at full provisioning)")
        self._tables[slot, need - len(got):need] = got

    def _advance_prefill(self, slot: int, w: _Work, n_valid: int) -> None:
        w.pos += n_valid
        self._lengths[slot] = w.pos

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

    def _pack_prefill(self, budget: int) -> List:
        """Place PREFILLING slots' chunks, earliest arrival first, into the
        remaining budget: only full split-schedule chunks (``min(chunk,
        remaining prompt)``); a chunk that does not fit waits a step."""
        segs = []
        pref = sorted((s for s, w in self._running.items() if w.prefilling),
                      key=lambda s: (self._running[s].arrival, s))
        for slot in pref:
            if budget <= 0:
                break
            w = self._running[slot]
            n = min(self.prefill_chunk, len(w.prompt) - w.pos)
            if n > budget or n <= 0:
                continue
            self._alloc_for_chunk(slot, w, n)
            segs.append((slot, w.prompt[w.pos:w.pos + n], w.pos))
            budget -= n
        return segs

    def _grow(self) -> None:
        """Give every DECODING slot a block covering its next write position."""
        for slot in sorted((s for s, w in self._running.items() if not w.prefilling),
                           key=lambda s: self._running[s].arrival):
            w = self._running[slot]
            while len(w.blocks) * self.block_size <= self._lengths[slot]:
                got = self.allocator.alloc(1)
                if got is None:
                    raise PoolExhausted(
                        "KV pool exhausted growing a decode slot (the port has no "
                        "preemption: size n_blocks for the traffic)")
                w.blocks += got
                self._tables[slot, len(w.blocks) - 1] = got[0]

    def _step_mixed(self) -> int:
        """One engine step: pack prefill chunks + the decode batch into one
        mixed step, run the gate variant the step's real composition picks,
        sample every slot that produced a token. Returns real tokens run."""
        self._grow()
        decoding = sorted(s for s, w in self._running.items() if not w.prefilling)
        segs = self._pack_prefill(self.token_budget - len(decoding))
        if not segs and not decoding:
            return 0
        batch = build_mixed_batch(
            segs, [(s, int(self._cur[s]), int(self._lengths[s])) for s in decoding],
            self.token_budget, self.n_slots)
        gate = (True in self._gate_ctxs
                and self.ctx.policy.active_for_step(batch.n_prefill, batch.n_decode))
        dev = self.device
        t = lambda a: torch.tensor(a, device=dev)  # a copy: host arrays mutate later
        logits, self._state = self.model.mixed_step(
            self._gate_ctxs[gate], self.params, t(batch.tokens), self._state,
            t(batch.slot_ids), t(batch.positions), t(batch.valid), t(batch.is_decode),
            t(self._lengths), t(self._tables), t(batch.sample_idx),
            cache_spec=self.cache_spec)
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
        toks = self._sample(logits, temps)
        now = time.perf_counter() - self._t0

        for slot, chunk, _ in segs:
            w = self._running[slot]
            self._advance_prefill(slot, w, len(chunk))
            if w.pos >= len(w.prompt):
                self._first_token(slot, w, int(toks[slot]), now)
        for slot in decoding:
            w = self._running[slot]
            tok = int(toks[slot])
            w.tokens.append(tok)
            w.token_times.append(now)
            self._cur[slot] = tok
            if w.done:
                self._retire(slot, now)
        return batch.n_prefill + batch.n_decode

    def _clear_slot(self, slot: int) -> None:
        self._tables[slot, :] = 0
        self._lengths[slot] = 0
        self._cur[slot] = 0

    def _retire(self, slot: int, now: float) -> None:
        """Terminal exit of a finished slot: release its blocks, clear its
        table row, record the request's timing."""
        w = self._running.pop(slot)
        self.allocator.release(w.blocks)
        w.blocks = []
        self._clear_slot(slot)
        r = w.req
        gen = w.tokens[: r.max_new_tokens]
        r.output = np.asarray(gen, np.int32)
        r.timing = RequestTiming(
            arrival_s=w.arrival, admitted_s=w.admitted_t, first_token_s=w.first_token_t,
            finished_s=now, n_prompt=len(np.asarray(r.prompt)), n_generated=len(gen),
            inter_token_s=[b - a for a, b in zip(w.token_times, w.token_times[1:])],
            outcome=OUTCOME_OK)
        r.ttft_s = r.timing.ttft_s
        r.latency_s = r.timing.latency_s
        self.stats.record(r.timing)

    # ------------------------------------------------------------------ API

    def run(self, requests: List[Request], *, seed: int = 0) -> List[Request]:
        """Serve ``requests`` (``arrival_s`` honoured against the run's wall
        clock); returns them with output/ttft/latency/timing filled."""
        self._reset()
        self.stats = ServeStats()
        self.gate_counts = {"compressed": 0, "dense": 0}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._t0 = time.perf_counter()
        capacity = self.max_blocks * self.block_size
        works = []
        for i, r in enumerate(requests):
            need = len(np.asarray(r.prompt)) + r.max_new_tokens - 1
            if need > capacity:
                raise InvalidRequest(
                    f"request {i}: prompt+decode needs {need} cache positions but "
                    f"max_len={self.max_len} provides {capacity}")
            works.append(_Work(req=r, prompt=np.asarray(r.prompt, np.int32),
                               arrival=float(r.arrival_s)))
        self._waiting = sorted(works, key=lambda w: w.arrival)
        while self._waiting or self._running:
            now = time.perf_counter() - self._t0
            self._admit_ready(now)
            if not self._running:
                time.sleep(min(max(self._waiting[0].arrival - now, 0.0), 0.005))
                continue
            self._step_mixed()
        return requests
