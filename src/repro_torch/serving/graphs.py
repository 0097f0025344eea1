"""Compile-once step programs of the serving engine. The reference jits each
step program once and counts the compiled programs (``decode_cache_size`` /
``prefill_cache_size``); here a program is a ``torch.cuda.CUDAGraph``
captured at its first call and replayed at every later one.

A ``StepProgram`` owns its static inputs: one byte buffer on the device that
holds every input array at a fixed address, each input 16-byte aligned. Each
call copies the host arrays into it with one host-to-device copy, staged
through pinned host memory, so the arrays are read during the call and may
change after it. Inputs are int32 or bool (token ids, positions, tables,
flags), or floating (a vision prefix's patch embeddings, an encoder's
frames) in the model's dtype: a floating array, numpy or a torch tensor of
any float dtype, is cast on the host into its staged slice by
``Tensor.copy_`` (round to nearest even, as a cast on the card rounds), so
bf16, which numpy lacks, reaches the card as bf16 bits in the same single
copy. On the card the
first call runs the step eagerly on a side stream (the warm-up, whose result
is that call's), then captures the same function over the same buffers; a
later call replays the graph and returns its static outputs, which the next
replay overwrites. A capture runs no kernel: its launches are recorded
(``kernels.build.record_launches``) and added to the counters at each replay,
so ``launch_counts()`` stays the count of kernels run; a TP group's NCCL
collectives are recorded and added the same way
(``collectives.recorded_collectives``). A program that is not ``graphed``
(on the CPU, on sequence-sharded pools or a gloo TP group, whose
host-staged exchanges a graph cannot hold, or when eager steps are asked
for) runs the
function over the same buffers at every call. A capture or replay that fails
raises; nothing falls back to eager steps.

``StepPrograms`` names the programs of one engine and gives them one graph
memory pool: the programs run one at a time, so their activations share it.
Whole-prompt prefill programs are LRU-bounded as in the reference; an evicted
program that had run is counted and its graph and buffers released.
"""
from __future__ import annotations

import collections
import gc
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.collectives import add_tp_counts, recorded_collectives
from repro_torch.kernels.build import add_launches, record_launches

__all__ = ["StepProgram", "StepPrograms", "PREFILL_PROGRAMS_MAX"]

PREFILL_PROGRAMS_MAX = 8   # the reference's PREFILL_FN_CACHE_MAX
_ALIGN = 16

InputSpec = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


class StepProgram:
    """One step program: ``fn(**inputs)`` over static input buffers, captured
    as a CUDA graph at the first call when ``graphed``. ``inputs`` maps each
    argument's name to its (shape, dtype): int32, bool, or a floating dtype
    (fp32, bf16, fp16)."""

    def __init__(self, name: str, fn: Callable[..., Any], inputs: InputSpec,
                 device: torch.device, *, graphed: bool, pool=None):
        self.name = name
        self.graphed = graphed
        self.n_calls = 0
        self.capture_s: Optional[float] = None
        self._fn, self._device, self._pool = fn, device, pool
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Any = None
        self._record: Dict[str, int] = {}
        self._collectives: Dict[str, float] = {}
        layout, size = {}, 0   # each input's byte range, 16-byte aligned
        for key, (shape, dtype) in inputs.items():
            if dtype not in (torch.int32, torch.bool) and not dtype.is_floating_point:
                raise TypeError(f"step program {name}: input {key} of dtype {dtype}")
            nbytes = math.prod(shape) * dtype.itemsize
            layout[key] = (size, size + nbytes)
            size += -(-nbytes // _ALIGN) * _ALIGN
        cuda = device.type == "cuda"
        self._host = torch.zeros(max(size, 1), dtype=torch.uint8, pin_memory=cuda)
        self._dev = torch.zeros_like(self._host, device=device) if cuda else self._host
        host_np = self._host.numpy()
        self.inputs: Dict[str, torch.Tensor] = {}
        self._staged: Dict[str, Any] = {}   # numpy views (int32, bool), torch (floating)
        for key, (shape, dtype) in inputs.items():
            a, b = layout[key]
            self.inputs[key] = self._dev[a:b].view(dtype).view(shape)
            if dtype.is_floating_point:
                self._staged[key] = self._host[a:b].view(dtype).view(shape)
            else:
                self._staged[key] = host_np[a:b].view(
                    np.bool_ if dtype == torch.bool else np.int32).reshape(shape)

    @property
    def built(self) -> bool:
        """Whether the program has run (the reference's compile happens at
        the first call too)."""
        return self.n_calls > 0

    def __call__(self, **arrays) -> Any:
        if arrays.keys() != self._staged.keys():
            raise TypeError(f"step program {self.name}: inputs {sorted(arrays)} != "
                            f"{sorted(self._staged)}")
        for key, a in arrays.items():
            staged = self._staged[key]
            if isinstance(staged, torch.Tensor):   # cast on the host, bf16 included
                src = torch.as_tensor(a)
                if tuple(src.shape) != tuple(staged.shape):
                    raise ValueError(f"step program {self.name}: input {key} of shape "
                                     f"{tuple(src.shape)}, expected {tuple(staged.shape)}")
                staged.copy_(src)
            else:
                np.copyto(staged, a)
        if self._dev is not self._host:
            self._dev.copy_(self._host)
        self.n_calls += 1
        if not self.graphed:
            return self._fn(**self.inputs)
        if self._graph is None:
            return self._capture()
        self._graph.replay()
        add_launches(self._record)
        add_tp_counts(self._collectives)
        return self._out

    def _capture(self) -> Any:
        """Warm up on a side stream (this call's result), then capture."""
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._fn(**self.inputs)
        current.wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while the capture is open: one that drops
        # another graph would destroy it, which CUDA refuses during a capture
        # (and the capture fails)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with record_launches() as record, recorded_collectives() as collectives:
                with torch.cuda.graph(graph, pool=self._pool):
                    static = self._fn(**self.inputs)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self._device)
        self.capture_s = time.perf_counter() - t0
        self._graph, self._out, self._record = graph, static, record
        self._collectives = collectives
        return out

    def release(self) -> None:
        """Drop the graph, its static outputs and the input buffers."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._out = self._fn = None
        self.inputs, self._staged = {}, {}
        self._host = self._dev = None


class StepPrograms:
    """The step programs of one engine, by name, sharing one graph memory
    pool. ``prefill`` keeps whole-prompt programs by bucket under the
    reference's LRU bound."""

    def __init__(self, device: torch.device, *, graphed: bool):
        self.device = device
        self.graphed = graphed
        self._pool = torch.cuda.graph_pool_handle() if graphed else None
        self._programs: Dict[str, StepProgram] = {}
        self._prefill: "collections.OrderedDict[int, StepProgram]" = collections.OrderedDict()
        self.evicted_prefill = 0   # evicted prefill programs that had run

    def _make(self, name: str, fn, inputs: InputSpec) -> StepProgram:
        return StepProgram(name, fn, inputs, self.device, graphed=self.graphed,
                           pool=self._pool)

    def get(self, name: str, make: Callable[[], Tuple[Callable, InputSpec]]) -> StepProgram:
        """The program called ``name``, made by ``make() -> (fn, inputs)`` the
        first time."""
        if name not in self._programs:
            self._programs[name] = self._make(name, *make())
        return self._programs[name]

    def prefill(self, bucket: int, make: Callable[[], Tuple[Callable, InputSpec]]
                ) -> StepProgram:
        """The whole-prompt program of ``bucket``, made by ``make() -> (fn,
        inputs)`` when absent; an LRU touch otherwise. Beyond
        ``PREFILL_PROGRAMS_MAX`` buckets the least recent is released."""
        if bucket in self._prefill:
            self._prefill.move_to_end(bucket)
        else:
            self._prefill[bucket] = self._make(f"prefill/{bucket}", *make())
            while len(self._prefill) > PREFILL_PROGRAMS_MAX:
                _, old = self._prefill.popitem(last=False)
                self.evicted_prefill += int(old.built)
                old.release()
        return self._prefill[bucket]

    def count(self, *names: str) -> int:
        """Programs among ``names`` that have run."""
        return sum(int(n in self._programs and self._programs[n].built) for n in names)

    def prefill_count(self) -> int:
        """Whole-prompt programs that have run, the evicted ones included."""
        return self.evicted_prefill + sum(int(p.built) for p in self._prefill.values())

    def capture_seconds(self) -> Dict[str, float]:
        """Capture wall seconds of each captured program, by name."""
        progs = list(self._programs.values()) + list(self._prefill.values())
        return {p.name: p.capture_s for p in progs if p.capture_s is not None}
