"""What each kv rank of ``tests/test_torch_sharded_pools.py`` runs. This
module imports torch and the port only, never jax or ``repro``: the ranks
are spawned processes, and the JAX reference runs in the test process.

``run_rank(group, rank, device, job)`` (the ``spawn_ranks`` target)
runs the pool-op probe and then every engine case of ``job`` and of its
whole-prompt stacks (``job["stacks"]``); the test process calls
``run_cases(None, "cpu", ...)`` itself for the replicated engine, so both
run the same code.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.collectives import (
    exchange_counts, masked_owner_psum, reset_exchange_counts, reset_tp_counts, tp_counts,
)
from repro_torch.core.policy import NO_COMPRESSION, PAPER_DEFAULT
from repro_torch.core.tp import (
    TPContext, pool_block_copy, pool_block_fill, pool_block_write, pool_exchange, pool_scatter,
)
from repro_torch.models.attention import pool_planes
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.serving import Engine, EngineSupervisor, FaultPlan, PoolExhausted, Request

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes, for bit-for-bit comparison."""
    return t.contiguous().view(torch.uint8).numpy().copy()


def run_pool_ops(group, rank: int, probe: dict) -> dict:
    """Each pool op on this rank's slabs of the probe's global planes (uint8,
    bf16 and fp32 bit patterns); returns the results as bytes, and this
    rank's slabs after the writes."""
    planes = [torch.from_numpy(a.copy()).view(dt) for a, dt in zip(probe["planes"],
                                                                  probe["dtypes"])]
    n = planes[0].shape[0]
    per = n // 2
    slabs = [p[rank * per:(rank + 1) * per].clone() for p in planes]
    ctx = TPContext(kv_group=group)
    out = {}
    own = (torch.arange(n) // per) == rank
    out["psum"] = [bits(masked_owner_psum(p, own[:, None, None], group)) for p in planes]
    out["exchange"] = [bits(v) for v in pool_exchange(ctx, slabs,
                                                      torch.from_numpy(probe["tables"]))]
    blk, offs = torch.from_numpy(probe["blk"]), torch.from_numpy(probe["offs"])
    vals = [torch.from_numpy(v.copy()).view(p.dtype) for v, p in zip(probe["rows"], planes)]
    pool_scatter(ctx, list(zip(slabs, vals)), blk, offs)
    out["scatter"] = [bits(s) for s in slabs]
    blocks = [torch.from_numpy(v.copy()).view(p.dtype) for v, p in zip(probe["blocks"], planes)]
    pool_block_write(ctx, list(zip(slabs, blocks)), probe["block_ids"])
    out["write"] = [bits(s) for s in slabs]
    pool_block_fill(ctx, [(s, f) for s, f in zip(slabs, probe["fills"])], probe["fill_block"])
    out["fill"] = [bits(s) for s in slabs]
    for src, dst in probe["copies"]:
        pool_block_copy(ctx, slabs, src, dst)
    out["copy"] = [bits(s) for s in slabs]
    return out


def _requests(traffic):
    return [Request(prompt=np.asarray(p, np.int32).copy(), max_new_tokens=n, arrival_s=0.0)
            for p, n in traffic]


def run_case(model, params, ctx: TPContext, device, case: dict) -> dict:
    """One engine case: ``case["runs"]`` runs of ``case["traffic"]`` on one
    engine (under a supervisor when ``case["plan"]`` is set; with the
    model's ``case["extra"]`` inputs, one row per request, when given).
    Returns by run: tokens, the stats' counts, gate counts, the free lists,
    the exchange's all-reduces, the TP group's collectives; and the pools,
    an encoder-decoder's cross K/V and the recurrent state this rank
    holds."""
    kw = dict(case["engine"])
    kw["cache_dtype"] = DTYPES[kw.get("cache_dtype", "float32")]
    plan = case.get("plan")
    eng = Engine(model, params, ctx, device=device,
                 fault_plan=FaultPlan.parse(plan) if plan else None, **kw)
    res = {"runs": [], "n_blocks": eng.n_blocks, "kv_shards": eng.kv_shards,
           "pool_bytes": eng.kv_pool_bytes(),
           "pool_bytes_per_device": eng.kv_pool_bytes(per_device=True)}
    for _ in range(case.get("runs", 1)):
        reqs = _requests(case["traffic"])
        sup = EngineSupervisor(eng, backoff_s=0.0) if plan else None
        reset_exchange_counts()
        reset_tp_counts()
        try:
            (sup or eng).run(reqs, extra_inputs=case.get("extra"))
        except PoolExhausted as e:
            res["runs"].append({"exhausted": str(e)})
            continue
        stats = (sup or eng).stats
        a = eng.allocator
        res["runs"].append({
            "outputs": [r.output.tolist() for r in reqs],
            "outcomes": [r.outcome for r in reqs],
            "summary": stats.summary(),
            "step_tokens": list(stats.step_tokens),
            "gate": dict(eng.gate_counts),
            "events": [(e.error, e.mode, e.n_replayed, e.detail) for e in (sup.events if sup
                                                                          else [])],
            "free_per_shard": a.free_per_shard,
            "owners_ok": all(a.shard_of(b) == s for s, d in enumerate(a._free) for b in d),
            "n_free": a.n_free, "n_cached": a.n_cached, "n_allocated": a.n_allocated,
            "n_held": a.n_held, "finite": eng.logits_finite(),
            "max_resident_ctx": eng.max_resident_ctx,
            "hit_blocks": eng.prefix_index.hit_blocks if eng.prefix_index else 0,
            "exchange": exchange_counts()["all_reduce"],
            "tp": tp_counts(),
        })
    planes = [p for pk, pv in zip(eng._state["pools_k"], eng._state["pools_v"])
              for p in pool_planes(pk, pv)]
    res["slab_rows"] = sorted({p.shape[0] for p in planes})
    res["slab_bytes"] = sum(p.numel() * p.element_size() for p in planes)
    res["planes_per_layer"] = len(planes) // max(1, len(eng._state["pools_k"]))
    cross = eng._state.get("cross_k", []) + eng._state.get("cross_v", [])
    res["cross_bytes"] = sum(t.numel() * t.element_size() for t in cross)
    res["rec_bytes"] = sum(t.numel() * t.element_size() for c in eng._state.get("rec", [])
                           for t in c)
    res["cross_widths"] = sorted({t.shape[-1] for t in cross})
    return res


def run_cases(group, device, cfg, params_np, cases) -> dict:
    """Every engine case on this kv rank of ``group`` (None: the replicated
    engine in the calling process)."""
    model = Model(cfg)
    params = params_from_numpy(params_np, cfg, device)
    out = {}
    for name, case in cases.items():
        policy = PAPER_DEFAULT if case.get("gated") else NO_COMPRESSION
        ctx = TPContext(policy=policy, simulate_tp=2 if case.get("gated") else 0,
                        kv_group=group)
        out[name] = run_case(model, params, ctx, device, case)
    return out


def run_rank(group, rank: int, device, job: dict) -> dict:
    """The ``spawn_ranks`` target: the pool-op probe, then the engine
    cases of ``job``, and those of each whole-prompt stack of
    ``job["stacks"]``, on this kv rank."""
    return {"pool_ops": run_pool_ops(group, rank, job["probe"]),
            "cases": run_cases(group, device, job["cfg"], job["params"], job["cases"]),
            "stacks": {k: run_cases(group, device, m["cfg"], m["params"], m["cases"])
                       for k, m in job.get("stacks", {}).items()}}
