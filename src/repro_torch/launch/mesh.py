"""Groups of ranks: the port's counterpart of the reference's meshes (a mesh
axis there, a ``torch.distributed`` process group of ranks here). One group
kind serves the port's axes: the kv group of sequence-sharded paged pools
(``TPContext.kv_group``), the tensor-parallel group (``TPContext.tp_group``)
and the data group (``TPContext.dp_group``). ``spawn_ranks(..., tp=M,
kv=K)`` lays ``K x D x M`` ranks out on the reference's ``("kv", "data",
"model")`` mesh (``make_kv_mesh``; ``make_host_mesh(data=D, model=M)`` when
K is 1): rank ``r = k*D*M + d*M + m`` sits in row (k, d) (its model group,
the M ranks of its plane k and data rank d), column (k, m) (its data group,
ranks ``k*D*M + m + d'*M``) and kv group (d, m) (the K ranks of its (data,
model) position, ``d*M + m + k'*D*M``). ``init_group`` makes one
``new_group`` per row, then per column, then per kv group, in that order on
every rank (``new_group`` is collective); a one-rank group is no group
(None), and K = 1 makes the grid and the numbering of a ``data x model``
grid.

Each rank is one process. Every rank calls ``init_group`` with the same
``init_method`` (a ``file://`` path or ``tcp://localhost:<port>``) and its
own rank; ``spawn_ranks`` starts the ranks as processes and collects what
each returns. The transport a group gives is ``collectives.transport``.

The backend follows one rule (``backend_for``):

* NCCL when the device is ``cuda`` and ``torch.cuda.device_count() >=
  world``: rank r runs on ``cuda:r`` and the collectives move device memory
  (transport ``"nccl"``);
* gloo otherwise: rank r runs on ``cuda:(r % device_count)`` (ranks share a
  card when there are fewer cards than ranks; NCCL refuses two ranks on one
  card) or on the CPU, and every exchange of a tensor on the card is staged
  through host memory (transport ``"gloo-staged"``; on the CPU the tensors
  already live there).

Nothing switches transport after a failure: a collective that fails raises.
"""
from __future__ import annotations

import dataclasses
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

__all__ = ["Grid", "backend_for", "init_group", "spawn_ranks"]


GROUP_TIMEOUT_S = 300.0   # a collective that waits longer raises instead of hanging


def backend_for(world: int, device: str | torch.device) -> str:
    """``"nccl"`` when every one of ``world`` ranks can have a card of its
    own, else ``"gloo"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on a ``kv x data x model`` grid of ``kv * dp * tp``
    ranks: its model group (``tp_group``, its row; None when ``tp == 1``),
    its data group (``dp_group``, its column; None when ``dp == 1``) and
    its kv group (``kv_group``, the ranks of its (data, model) position;
    None when ``kv == 1``), and its rank in each."""

    tp_group: Any
    dp_group: Any
    tp: int
    dp: int
    tp_rank: int
    dp_rank: int
    kv_group: Any = None
    kv: int = 1
    kv_rank: int = 0


def _grid(world: int, rank: int, tp: int, kv: int = 1) -> Grid:
    """The rows, columns and kv groups of a grid of ``world`` ranks, ``tp``
    wide and ``kv`` planes deep: every rank makes every group, in the same
    order (``new_group`` is collective, and ranks that made them in other
    orders would wait on each other)."""
    if tp < 1 or kv < 1 or world % (tp * kv):
        raise ValueError(f"a grid of {world} ranks has no {kv} planes of rows of {tp}")
    dp = world // (tp * kv)
    plane = dp * tp
    rows = [dist.new_group([k * plane + d * tp + m for m in range(tp)]) if tp > 1 else None
            for k in range(kv) for d in range(dp)]
    cols = [dist.new_group([k * plane + d * tp + m for d in range(dp)]) if dp > 1 else None
            for k in range(kv) for m in range(tp)]
    kvs = [dist.new_group([k * plane + p for k in range(kv)]) if kv > 1 else None
           for p in range(plane)]
    k, p = divmod(rank, plane)
    d, m = divmod(p, tp)
    return Grid(tp_group=rows[k * dp + d], dp_group=cols[k * tp + m], tp=tp, dp=dp,
                tp_rank=m, dp_rank=d, kv_group=kvs[p], kv=kv, kv_rank=k)


def init_group(world: int, rank: int, init_method: str,
               device: str = "cuda", tp: int = 0, kv: int = 0) -> Tuple[Any, torch.device]:
    """Join a group of ``world`` ranks as ``rank``: initialise
    ``torch.distributed`` with the backend ``backend_for`` picks and return
    (the group, this rank's device); with ``tp`` or ``kv`` > 0, (this rank's
    ``Grid`` on a ``kv x data x model`` grid ``tp`` wide (1 when 0) and
    ``kv`` planes deep (1 when 0), the device). The device is
    ``cuda:rank`` under NCCL, ``cuda:(rank % device_count)`` under gloo
    (raising when there is no card), or the CPU when ``device="cpu"``."""
    if world < 2:
        raise ValueError(f"a group needs at least 2 ranks, got {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a group of {world}")
    dev = resolve_device(device)
    backend = backend_for(world, dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return (_grid(world, rank, max(tp, 1), max(kv, 1)) if tp or kv else dist.group.WORLD), dev


def _rank_entry(rank: int, fn: Callable, world: int, init_method: str, device: str,
                threads: int, tp: int, kv: int, args: tuple, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        group, dev = init_group(world, rank, init_method, device=device, tp=tp, kv=kv)
        try:
            out = fn(group, rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, world: int, *args, device: str = "cuda", threads: int = 0,
                timeout_s: float = 900.0, tp: int = 0, kv: int = 0) -> List[Any]:
    """Run ``fn(group, rank, device, *args)`` on ``world`` ranks, each a new
    process (``spawn``) that joins one group (``init_group``; ``file://``
    rendezvous in a new temporary directory), and return what each rank
    returned, by rank. With ``tp`` or ``kv`` > 0 the ranks form a ``kv x
    data x model`` grid ``tp`` wide and ``kv`` planes deep (``init_group``)
    and ``fn`` gets its ``Grid`` in place of the group. ``fn`` and ``args`` must pickle, and ``fn`` must live
    in a module the ranks can import. ``threads`` > 0 sets each rank's torch
    threads. A rank that raises or dies, or no answer from every rank
    within ``timeout_s``, stops every rank and raises here (with the rank's
    traceback when it raised)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, fn, world, init, device, threads, tp, kv, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: List[Any] = [None] * world
        answered = set()
        deadline = time.monotonic() + timeout_s
        try:
            while len(answered) < world:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in answered and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank(s) exited without an answer "
                                           f"(rank, exit code): {dead}") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"ranks: no answer within {timeout_s} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{val}")
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
