"""The kv group of sequence-sharded paged pools — the port's counterpart of
the reference's ``make_kv_mesh`` (a ``kv`` mesh axis there, a
``torch.distributed`` process group of ranks here).

Each rank is one process that runs the whole model and holds
``n_blocks / kv`` blocks of every pool. The backend is gloo: NCCL refuses
two ranks on one card, and the kv ranks of a one-card run share it. Every
rank calls ``init_kv_group`` with the same ``init_method`` (a ``file://``
path or ``tcp://localhost:<port>``) and its own rank; ``spawn_kv_ranks``
starts the ranks as processes and collects what each returns.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["init_kv_group", "spawn_kv_ranks"]


KV_TIMEOUT_S = 300.0   # a collective that waits longer raises instead of hanging


def init_kv_group(kv: int, rank: int, init_method: str, backend: str = "gloo",
                  device: str = "cuda") -> Tuple[Any, torch.device]:
    """Join the kv group as ``rank`` of ``kv``: initialise
    ``torch.distributed`` and return (the group, this rank's device). The
    device is ``cuda:(rank % device_count)`` (raising when there is no
    card), or the CPU when ``device="cpu"``."""
    if kv < 2:
        raise ValueError(f"a kv group needs at least 2 ranks, got {kv}")
    if not 0 <= rank < kv:
        raise ValueError(f"rank {rank} is not in a kv group of {kv}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=kv, rank=rank,
                            timeout=datetime.timedelta(seconds=KV_TIMEOUT_S))
    return dist.group.WORLD, dev


def _rank_entry(rank: int, fn: Callable, kv: int, init_method: str, device: str,
                threads: int, args: tuple, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        group, dev = init_kv_group(kv, rank, init_method, device=device)
        try:
            out = fn(group, rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn_kv_ranks(fn: Callable, kv: int, *args, device: str = "cuda", threads: int = 0,
                   timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(group, rank, device, *args)`` on ``kv`` ranks, each a new
    process (``spawn``) that joins one kv group over gloo (``file://``
    rendezvous in a new temporary directory), and return what each rank
    returned, by rank. ``fn`` and ``args`` must pickle, and ``fn`` must live
    in a module the ranks can import. ``threads`` > 0 sets each rank's torch
    threads. A rank that raises or dies, or no answer from every rank
    within ``timeout_s``, stops every rank and raises here (with the rank's
    traceback when it raised)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="kv_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, fn, kv, init, device, threads, args, results))
                 for r in range(kv)]
        for p in procs:
            p.start()
        out: List[Any] = [None] * kv
        answered = set()
        deadline = time.monotonic() + timeout_s
        try:
            while len(answered) < kv:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in answered and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"kv rank(s) exited without an answer "
                                           f"(rank, exit code): {dead}") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"kv ranks: no answer within {timeout_s} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"kv rank {rank} failed:\n{val}")
                out[rank] = val
                answered.add(rank)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return out
