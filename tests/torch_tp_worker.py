"""What each TP rank of ``tests/test_torch_tp.py`` runs. This module imports
torch and the port only, never jax or ``repro``: the ranks are spawned
processes, and the JAX reference runs in the test process.

``run_rank(group, rank, device, job)`` (the ``spawn_ranks`` target) runs the
collective probe on this rank's partials, then (when the job has them) the
refusals, one mixed step's logits and every engine case, and the same for
the job's MoE model (``job["moe"]``), its Mamba + MoE hybrid
(``job["jamba"]``), its vision-prefix model (``job["pixtral"]``), its
encoder-decoder (``job["whisper"]``) and its xLSTM stack (``job["xlstm"]``);
the last four give a whole-prompt prefill's logits (no mixed step serves
them), pixtral and whisper with their extra inputs (``logit_extra``, and
``extra`` in each engine case). Each model also reports the shapes of
every layer's ``core`` this rank holds (``core_shapes``). The test
process calls ``run_tp_cases(None, ...)`` itself for the port's single-rank
engine, so both run the same code.

``run_grid_rank(grid, rank, device, job)`` is what each rank of
``tests/test_torch_data_parallel.py``'s 2 x 2 ``data x model`` grid runs
(``spawn_ranks(..., tp=2)``): the ``compressed_all_to_all`` probe over its
data group, one MoE layer of each model of ``job["moe"]`` on every input
under every policy of ``POLICIES``, and the engine cases of
``job["engine"]``.

``run_kvtp_rank(grid, rank, device, job)`` is what each rank of
``tests/test_torch_kv_tp.py``'s ``kv x data x model`` grids runs
(``spawn_ranks(..., tp=2, kv=2)``): for each model of ``job["models"]`` its
engine cases with replicated pools (``kv_group=None``: this rank's plane is
a ``data x model`` grid of its own) and then with the pools sharded over
its kv group, the weights this rank holds, and (``probes``) two mixed steps'
logits and the exchanged virtual pool in both modes.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import collectives as C
from repro_torch.core.formats import KVCacheSpec
from repro_torch.core.policy import NO_COMPRESSION, PAPER_DEFAULT, CompressionPolicy
from repro_torch.core.tp import TPContext, pool_exchange
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.models.attention import pool_planes
from repro_torch.models.frontends import frontend_shapes
from repro_torch.models.model import Model, recurrent_layer
from repro_torch.models.moe import moe
from repro_torch.serving import Engine
from repro_torch.serving.kv_cache import init_paged_state
from tests.torch_kv_worker import bits, run_case

SPEC = PAPER_DEFAULT.spec
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _reduce_cases(x: torch.Tensor, group) -> dict:
    """Every rank reduction of this rank's partial ``x``, as bytes, with the
    TP counters of each."""
    kinds = {f"gather/{k}": dict(overlap_chunks=k) for k in (1, 2, 4)}
    kinds["two_phase"] = dict(variant="two_phase")
    kinds["two_phase/strict"] = dict(variant="two_phase", strict=True)
    kinds["keep_local_fp"] = dict(keep_local_fp=True)
    kinds["accum_bf16"] = dict(accum_dtype="bfloat16")
    out = {}
    for name, kw in kinds.items():
        C.reset_tp_counts()
        y = C.rank_compressed_psum(x, group, SPEC, **kw)
        out[name] = dict(y=bits(y), dtype=str(y.dtype), shape=tuple(y.shape),
                         counts=C.tp_counts())
    # the wire: each chunk's gathered payload and scales, in rank order
    for k in (1, 4):
        n_chunks = C._overlap_chunks(x.shape[-1], SPEC, k)
        _, comps = C._quantize_staged(x, SPEC, n_chunks)
        wires = C._gather_staged(comps, group)
        out[f"wire/{k}"] = dict(payload=[bits(w.payload) for w in wires],
                                scales=[bits(w.scales) for w in wires], n_chunks=n_chunks)
    C.reset_tp_counts()
    out["dense"] = dict(y=bits(C.rank_psum(x, group)), counts=C.tp_counts())
    ag = C.compressed_all_gather(x, group, SPEC, overlap_chunks=2)
    out["all_gather"] = dict(y=bits(ag), shape=tuple(ag.shape))
    C.reset_tp_counts()
    dense = C.rank_all_gather(x, group)
    out["dense_all_gather"] = dict(y=bits(dense), shape=tuple(dense.shape),
                                   counts=C.tp_counts())
    for name, policy, n_tok in (("maybe/compressed", PAPER_DEFAULT, None),
                                ("maybe/gated", PAPER_DEFAULT, 4),
                                ("maybe/none", None, None)):
        C.reset_tp_counts()
        y = C.psum_maybe_compressed(x, policy, n_tokens=n_tok, group=group)
        out[name] = dict(y=bits(y), counts=C.tp_counts())
    return out


def _downgrades(group, width: int) -> dict:
    """two_phase on a feature dim that does not split into N block-aligned
    slices: warnings (once per site), the gather variant's result, and the
    strict variant's error."""
    x = torch.ones(4, width)
    C.reset_downgrade_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        y = C.rank_compressed_psum(x, group, SPEC, variant="two_phase")
        C.rank_compressed_psum(x, group, SPEC, variant="two_phase")
    gather = C.rank_compressed_psum(x, group, SPEC)
    try:
        C.rank_compressed_psum(x, group, SPEC, variant="two_phase", strict=True)
        strict = None
    except ValueError as e:
        strict = str(e)
    return dict(warnings=[str(w.message) for w in caught], same=bool(torch.equal(y, gather)),
                strict=strict)


def run_collectives(group, rank: int, probe: dict) -> dict:
    """The probe's partials (``(N, ...)`` numpy, one per rank) reduced over
    ``group`` from this rank's slice, by case."""
    out = {}
    for name, (arr, dtype) in probe["partials"].items():
        x = torch.from_numpy(arr[rank].copy()).to(DTYPES[dtype])
        out[name] = _reduce_cases(x, group)
    out["downgrade"] = _downgrades(group, probe["odd_width"])
    return out


def mixed_logits(model: Model, params, ctx: TPContext, tokens: np.ndarray,
                 cache_spec=None, device="cpu") -> np.ndarray:
    """Logits of one mixed step that prefills ``tokens`` (one slot, from
    position 0) over fresh pools of this rank's kv heads (dense fp32, or
    ``cache_spec``)."""
    cfg = model.local_cfg(ctx)
    cache_spec = KVCacheSpec.parse(cache_spec)
    t, bs, n_slots = len(tokens), 16, 2
    nb = -(-t // bs)
    state = init_paged_state(cfg, n_slots, n_slots * nb + 1, bs, torch.float32,
                             cache_spec=cache_spec, device=device)
    tables = torch.zeros((n_slots, nb), dtype=torch.int32)
    tables[0] = torch.arange(1, nb + 1, dtype=torch.int32)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    logits, _ = model.mixed_step(
        ctx, params, i32(tokens)[None], state, slot_ids=i32(np.zeros(t)),
        positions=i32(np.arange(t)), valid=torch.ones(t, dtype=torch.bool),
        is_decode=torch.zeros(t, dtype=torch.bool), slot_starts=i32([0, 0]), tables=tables,
        sample_idx=i32([t - 1, 0]), cache_spec=cache_spec)
    return logits.float().numpy()


def prefill_logits(model: Model, params, ctx: TPContext, tokens: np.ndarray,
                   cache_spec=None, device="cpu", extra=None) -> np.ndarray:
    """Logits of one whole-prompt prefill of ``tokens`` (one request at its
    exact length, after a vision prefix; the pools' format plays no part)
    with the model's ``extra`` inputs (numpy, one row)."""
    del cache_spec
    cfg = model.cfg
    prefix = cfg.n_patches if cfg.frontend == "vision" else 0
    cache = model.init_cache(1, prefix + len(tokens), torch.float32, device, ctx=ctx)
    batch = {k: torch.as_tensor(v, device=device) for k, v in (extra or {}).items()}
    batch["tokens"] = torch.as_tensor(np.asarray(tokens), dtype=torch.int32, device=device)[None]
    logits, _ = model.prefill(ctx, params, batch, cache)
    return logits.float().numpy()


def _context(group, gated: bool, **policy) -> TPContext:
    """PAPER_DEFAULT (``policy`` fields replaced) or NO_COMPRESSION, over the
    TP group, or over ``simulate_tp=2`` in the single-rank port."""
    pol = CompressionPolicy(spec=SPEC, **policy) if gated else NO_COMPRESSION
    if group is None:
        return TPContext(policy=pol, simulate_tp=2 if gated else 0)
    return TPContext(policy=pol, tp_group=group)


def _params(group, cfg, params_np, device):
    """(model, this rank's parameters) of ``params_np``: the rank's shard on
    a TP group, the whole tree without one."""
    n = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    tree = params_np if n == 1 else shard_params(params_np, cfg, rank, n)
    return Model(cfg), params_from_numpy(tree, cfg.tp_shard(n), device)


def run_tp_cases(group, device, cfg, params_np, job) -> dict:
    """One mixed step's logits (dense and compressed; the whole-prompt
    prefill of a recurrent stack, a vision prefix or an encoder-decoder
    instead) and every engine case of ``job`` on this
    TP rank of ``group`` (None: the port's single-rank engine, compressed
    runs over ``simulate_tp=2``). Each engine case also returns the pool
    bytes this process holds and the TP counters by run."""
    model, params = _params(group, cfg, params_np, device)
    shapes = lambda node: ({k: shapes(v) for k, v in node.items()} if isinstance(node, dict)
                           else tuple(node.shape))
    out = {"logits": {}, "core_shapes": [shapes(lp["core"]) for lp in params["layers"]]}
    tokens = job["logit_tokens"]
    if recurrent_layer(cfg) is None and not frontend_shapes(cfg, 1):
        probe = mixed_logits
    else:
        probe = functools.partial(prefill_logits, extra=job.get("logit_extra"))
    for name, gated, spec in (("dense", False, None), ("compressed", True, None),
                              ("compressed-fp4", True, "fp4_e2m1")):
        out["logits"][name] = probe(model, params, _context(group, gated), tokens,
                                    cache_spec=spec, device=device)
    for name, case in job["cases"].items():
        ctx = _context(group, case.get("gated", False))
        res = run_case(model, params, ctx, device, case)
        res["tp_size"] = ctx.tp_size
        res["transport"] = ctx.transport
        out[name] = res
    return out


def _refusals(group, cfg, params_np) -> dict:
    """The rank path's refusals, by message: keep_local_fp in the engine, a
    TP group with simulate_tp or with a kv group that overlaps it."""
    model, params = _params(group, cfg, params_np, "cpu")
    msgs = {}
    for name, make in (
            ("keep_local_fp", lambda: Engine(model, params, _context(group, True,
                                                                     keep_local_fp=True),
                                             max_slots=2, max_len=64, device="cpu")),
            ("simulate_tp", lambda: TPContext(simulate_tp=2, tp_group=group)),
            ("kv_group", lambda: TPContext(tp_group=group, kv_group=group))):
        try:
            make()
            msgs[name] = None
        except ValueError as e:
            msgs[name] = str(e)
    return msgs


def run_rank(group, rank: int, device, job: dict) -> dict:
    """The ``spawn_ranks`` target: the collective probe, then (when ``job``
    carries a model) the refusals and the engine cases, and those of the
    MoE, hybrid, vision-prefix, encoder-decoder and xLSTM models, on this
    TP rank."""
    out = {"collectives": run_collectives(group, rank, job["probe"]),
           "transport": C.transport(group)}
    if "cfg" in job:
        out["refusals"] = _refusals(group, job["cfg"], job["params"])
        out["cases"] = run_tp_cases(group, device, job["cfg"], job["params"], job)
    for key in ("moe", "jamba", "pixtral", "whisper", "xlstm"):
        if key in job:
            m = job[key]
            out[key] = run_tp_cases(group, device, m["cfg"], m["params"], m)
    return out


# ------------------------------------------------- the data x model grid

# the island's policies: dense, the paper's compressed reduction, and the
# compressed reduction with compressed all-to-alls
POLICIES = {"dense": NO_COMPRESSION, "compressed": PAPER_DEFAULT,
            "compressed-a2a": dataclasses.replace(PAPER_DEFAULT, compress_all_to_all=True)}


def grid_context(grid, policy) -> TPContext:
    return TPContext(policy=policy, tp_group=grid.tp_group, dp_group=grid.dp_group)


def rank_params(grid, cfg, params_np):
    """This grid rank's parameters: its TP shard of its data rank's
    experts."""
    tree = shard_params(params_np, cfg, grid.tp_rank, grid.tp, dp_rank=grid.dp_rank, dp=grid.dp)
    return params_from_numpy(tree, cfg.tp_shard(grid.tp, grid.dp), "cpu")


def run_grid_a2a(grid, probe: dict) -> dict:
    """``compressed_all_to_all`` of this rank's probe tensor (``(dp, ...)``,
    slice i for data rank i) over its data group: the received bytes and
    the counters."""
    x = torch.from_numpy(probe[grid.dp_rank * grid.tp + grid.tp_rank].copy())
    C.reset_tp_counts()
    y = C.compressed_all_to_all(x, grid.dp_group, PAPER_DEFAULT.spec)
    return dict(y=bits(y), dtype=str(y.dtype), shape=tuple(y.shape), counts=C.tp_counts())


def run_grid_moe(grid, m: dict) -> dict:
    """One MoE layer (``m["layer"]``) of ``m["cfg"]`` on every input of
    ``m["inputs"]`` and a whole-prompt prefill of the rows of
    ``m["tokens"]``, under every policy of ``POLICIES``: outputs and logits
    (fp32 numpy) and counters by (input or ``"prefill"``, policy), and the
    expert rows this rank holds."""
    cfg = m["cfg"]
    params = rank_params(grid, cfg, m["params"])
    lp = params["layers"][m["layer"]]["moe"]
    local = cfg.tp_shard(grid.tp, grid.dp)
    out = {"experts_held": tuple(lp["up"]["w"].shape)}
    for name, x in m["inputs"].items():
        for pname, policy in POLICIES.items():
            C.reset_tp_counts()
            y, _ = moe(grid_context(grid, policy), lp, torch.from_numpy(x), local)
            out[name, pname] = dict(y=y.numpy().copy(), counts=C.tp_counts())
    model, tokens = Model(cfg), torch.from_numpy(m.get("tokens", np.zeros((0, 0), np.int32)))
    for pname, policy in (POLICIES.items() if tokens.numel() else ()):
        ctx = grid_context(grid, policy)
        C.reset_tp_counts()
        logits, _ = model.prefill(ctx, params, {"tokens": tokens},
                                  model.init_cache(*tokens.shape, torch.float32, "cpu", ctx=ctx))
        out["prefill", pname] = dict(y=logits.numpy().copy(), counts=C.tp_counts())
    return out


def run_grid_engine(grid, e: dict) -> dict:
    """Every engine case of ``e`` on this grid rank (``run_case``), under
    the case's policy."""
    cfg = e["cfg"]
    model, params = Model(cfg), rank_params(grid, cfg, e["params"])
    return {name: run_case(model, params, grid_context(grid, POLICIES[case["policy"]]), "cpu",
                           case)
            for name, case in e["cases"].items()}


def run_grid_rank(grid, rank: int, device, job: dict) -> dict:
    """The ``spawn_ranks(..., tp=2)`` target of
    ``tests/test_torch_data_parallel.py``: the ``compressed_all_to_all``
    probe, the MoE layers and the engine cases on this rank of the 2 x 2
    ``data x model`` grid."""
    return {"grid": (grid.dp_rank, grid.tp_rank, grid.dp, grid.tp),
            "a2a": run_grid_a2a(grid, job["a2a"]),
            "moe": {k: run_grid_moe(grid, m) for k, m in job["moe"].items()},
            "engine": run_grid_engine(grid, job["engine"])}


# ----------------------------------------------- the kv x data x model grid


def kv_grid_context(grid, policy, sharded: bool) -> TPContext:
    """``policy`` over this rank's row and column, with its kv group when
    ``sharded`` (else replicated pools)."""
    return TPContext(policy=policy, tp_group=grid.tp_group, dp_group=grid.dp_group,
                     kv_group=grid.kv_group if sharded else None)


def two_chunk_probe(model: Model, params, ctx: TPContext, probe: dict) -> dict:
    """Two mixed steps of one slot over fresh pools of ``probe["n_blocks"]``
    blocks (this rank's ``1/kv_shards`` of them, of its kv heads): the
    prompt's first chunk from position 0, then its second, which reads the
    first from the pools through table row ``probe["table"]`` (blocks on
    every kv rank). Returns both steps' logits and every pool plane's
    blocks of that row after the second step (``pool_exchange`` when
    sharded, the pool's rows when replicated), as bytes."""
    cfg = model.local_cfg(ctx)
    spec = KVCacheSpec.parse(probe["cache_spec"])
    tokens, table = probe["tokens"], probe["table"]
    c, bs = len(tokens) // 2, 16
    state = init_paged_state(cfg, 2, probe["n_blocks"] // ctx.kv_shards, bs, torch.float32,
                             cache_spec=spec, device="cpu")
    tables = torch.zeros((2, len(table)), dtype=torch.int32)
    tables[0] = torch.as_tensor(table, dtype=torch.int32)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    logits = []
    for start in (0, c):
        out, state = model.mixed_step(
            ctx, params, i32(tokens[start:start + c])[None], state,
            slot_ids=i32(np.zeros(c)), positions=i32(np.arange(start, start + c)),
            valid=torch.ones(c, dtype=torch.bool), is_decode=torch.zeros(c, dtype=torch.bool),
            slot_starts=i32([start, 0]), tables=tables, sample_idx=i32([c - 1, 0]),
            cache_spec=spec)
        logits.append(bits(out))
    planes = [p for pk, pv in zip(state["pools_k"], state["pools_v"])
              for p in pool_planes(pk, pv)]
    row = tables[:1]
    virtual = (pool_exchange(ctx, planes, row) if ctx.kv_sharded
               else [p[row.reshape(-1).long()] for p in planes])
    return dict(logits=logits, virtual=[bits(v) for v in virtual],
                widths=[p.shape[-1] for p in planes], slab_rows=planes[0].shape[0])


def run_kvtp_rank(grid, rank: int, device, job: dict) -> dict:
    """The ``spawn_ranks(..., tp=2, kv=2)`` target of
    ``tests/test_torch_kv_tp.py``: this rank's place on the grid, then for
    each model of ``job["models"]`` the bytes of the weights it holds, its
    engine cases (``run_case``) under each mode the case names
    (``"replicated"``: ``kv_group=None``; ``"sharded"``) and policy
    (``POLICIES``), and each of the model's ``probes`` in both modes; and
    the refusal of a context whose groups overlap."""
    out = {"grid": (grid.kv_rank, grid.dp_rank, grid.tp_rank, grid.kv, grid.dp, grid.tp)}
    for key, m in job["models"].items():
        cfg = m["cfg"]
        model, params = Model(cfg), rank_params(grid, cfg, m["params"])
        held = lambda node: (sum(held(v) for v in node.values()) if isinstance(node, dict)
                             else sum(held(v) for v in node) if isinstance(node, list)
                             else node.numel() * node.element_size())
        res = {"weight_bytes": held(params)}
        for mode in ("replicated", "sharded"):
            res[mode] = {name: run_case(model, params, kv_grid_context(
                grid, POLICIES[case["policy"]], mode == "sharded"), device, case)
                for name, case in m["cases"].items() if mode in case["modes"]}
            for name, probe in m.get("probes", {}).items():
                ctx = kv_grid_context(grid, POLICIES[probe["policy"]], mode == "sharded")
                res[mode][f"probe/{name}"] = two_chunk_probe(model, params, ctx, probe)
        out[key] = res
    try:   # a context whose groups share more than this rank
        TPContext(tp_group=grid.tp_group, kv_group=grid.tp_group)
        out["overlap"] = None
    except ValueError as e:
        out["overlap"] = str(e)
    return out


# ------------------------------------------------------------------ training


def torch_batch(batch_np: dict, device="cpu", rows=slice(None)) -> dict:
    """A numpy batch (tokens, targets, extra inputs) as tensors: ``rows`` of
    it."""
    return {k: torch.as_tensor(np.ascontiguousarray(v[rows]), device=device)
            for k, v in batch_np.items()}


def loss_and_grads(model: Model, params, ctx: TPContext, batch: dict):
    """(loss, metrics, gradient tree like ``params``; zeros where the loss
    does not reach a leaf) of ``Model.loss``."""
    from repro_torch.training.optimizer import leaves, rebuild

    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = model.loss(ctx, params, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    for p in flat:
        p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            rebuild(params, grads))


def to_numpy(tree):
    """A tree of tensors as fp32 numpy (dict keys kept)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree.detach().float().numpy().copy()


def _rank_train_grads(group, cfg, params_np, batch_np, policy) -> dict:
    """``Model.loss`` and its gradient on this TP rank, the gradient made
    whole (``convert.gather_params``) on every rank."""
    from repro_torch.models.convert import gather_params

    ctx = TPContext(policy=policy, tp_group=group)
    model, params = _params(group, cfg, params_np, "cpu")
    loss, metrics, grads = loss_and_grads(model, params, ctx, torch_batch(batch_np))
    C.reset_tp_counts()
    return dict(loss=loss, metrics=metrics, grads=to_numpy(gather_params(grads, cfg, ctx)))


def _rank_train_steps(ctx: TPContext, cfg, params_np, batches_np, opt_cfg, rows) -> dict:
    """``make_train_step`` steps from ``params_np`` (this rank's TP shard,
    fresh moments) over ``batches_np`` (``rows`` of each): the losses, the
    TP and data counters of the last step and the params made whole."""
    from repro_torch.models.convert import gather_params
    from repro_torch.training import init_train_state, make_train_step

    model = Model(cfg)
    tree = params_np if ctx.tp_size == 1 else shard_params(params_np, cfg, ctx.tp_rank,
                                                          ctx.tp_size)
    state = init_train_state(model, params_from_numpy(tree, cfg.tp_shard(ctx.tp_size), "cpu"))
    step = make_train_step(model, ctx, opt_cfg)
    losses = []
    for b in batches_np:
        C.reset_tp_counts()
        state, metrics = step(state, torch_batch(b, rows=rows))
        losses.append(float(metrics["loss"]))
    return dict(losses=losses, counts=C.tp_counts(),
                params=to_numpy(gather_params(state["params"], cfg, ctx)))


def _rank_checkpoint(ctx: TPContext, cfg, ck: dict) -> dict:
    """Save the checkpoint of ``ck``'s whole state (params, moments, step)
    from this rank's shard of it (the first rank writes to ``ck["path"]``),
    then restore ``ck["restore"]`` (a one-rank file) into this rank's
    shard."""
    from repro_torch.models.convert import opt_state_from_numpy
    from repro_torch.training import restore_checkpoint, save_checkpoint
    from repro_torch.training.optimizer import OptState

    n, r = ctx.tp_size, ctx.tp_rank
    local = cfg.tp_shard(n)
    shard = lambda t: shard_params(t, cfg, r, n)
    opt = opt_state_from_numpy(OptState(mu=shard(ck["mu"]), nu=shard(ck["nu"]), step=ck["step"]),
                               local, "cpu")
    state = {"params": params_from_numpy(shard(ck["params"]), local, "cpu"), "opt": opt}
    save_checkpoint(ck["path"], state, step=ck["step"], cfg=cfg, ctx=ctx)
    back = restore_checkpoint(ck["restore"], state, cfg=cfg, ctx=ctx)
    return dict(params=to_numpy(back["params"]), mu=to_numpy(back["opt"].mu),
                step=back["opt"].step)


def _train_refusals(group, dp_group, job: dict) -> dict:
    """``make_train_step``'s refusals on this rank's groups, by exception
    type and message (None: built): a MoE on the data group, and
    ``keep_local_fp`` on the TP group; the same MoE on the TP group and
    the same policy on the data group are built."""
    from repro_torch.training import AdamWConfig, make_train_step

    moe_cfg, dense_cfg = job["grads"]["mixtral"]["cfg"], job["grads"]["internlm2"]["cfg"]
    local_fp = dataclasses.replace(PAPER_DEFAULT, keep_local_fp=True)
    cases = {"moe/dp": (moe_cfg, TPContext(dp_group=dp_group)),
             "moe/tp": (moe_cfg, TPContext(tp_group=group)),
             "keep_local_fp/tp": (dense_cfg, TPContext(policy=local_fp, tp_group=group)),
             "keep_local_fp/dp": (dense_cfg, TPContext(policy=local_fp, dp_group=dp_group))}
    out = {}
    for name, (cfg, ctx) in cases.items():
        try:
            make_train_step(Model(cfg), ctx, AdamWConfig())
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


STE_CASES = {"gather": {}, "gather/overlap2": dict(overlap_chunks=2),
             "two_phase": dict(variant="two_phase", strict=True),
             "accum_bf16": dict(accum_dtype="bfloat16"), "bf16": {}}


def _backward_probe(group, rank: int) -> dict:
    """Each rank collective's backward on this rank: a (6, 64) partial (the
    rank's own values) through the collective, then ``backward`` with the
    same cotangent on every rank (``copy_to_group``: the rank's multiple of
    it); the input's gradient and the TP counters after the forward and
    after the backward."""
    x = torch.randn(6, 64, generator=torch.Generator().manual_seed(11)) * (rank + 1)
    cot = torch.randn(6, 64, generator=torch.Generator().manual_seed(12))
    group_n = dist.get_world_size(group)
    calls = {name: (lambda t, kw=kw: C.rank_compressed_psum(t, group, SPEC, **kw))
             for name, kw in STE_CASES.items()}
    calls.update(rank_psum=lambda t: C.rank_psum(t, group),
                 rank_all_gather=lambda t: C.rank_all_gather(t[:, :64 // group_n], group),
                 copy_to_group=lambda t: C.copy_to_group(t, group))
    out = {}
    for name, call in calls.items():
        xi = (x.bfloat16() if name == "bf16" else x).clone().requires_grad_(True)
        C.reset_tp_counts()
        y = call(xi)
        forward = C.tp_counts()
        y.backward((cot * (rank + 1) if name == "copy_to_group" else cot).to(y.dtype))
        out[name] = dict(grad=xi.grad.float().numpy().copy(), dtype=str(xi.grad.dtype),
                         forward=forward, backward=C.tp_counts(), out_dtype=str(y.dtype))
    return out


def run_train_rank(group, rank: int, device, job: dict) -> dict:
    """What each of the 2 ranks of ``tests/test_torch_train_tp.py`` runs: for
    each model of ``job["grads"]`` the loss and the gathered gradient on the
    TP group, dense and (``compressed``) under PAPER_DEFAULT; each rank
    collective's backward (``_backward_probe``); ``job["steps"]``
    train steps on the TP group and on a data group of the same two ranks
    (each taking its rows of the global batch); the checkpoint of
    ``job["checkpoint"]`` saved and restored on the TP group;
    ``make_train_step``'s refusals (``_train_refusals``)."""
    dp_group = dist.new_group([0, 1])   # the same two ranks as a data group
    out = {"grads": {}, "backward": _backward_probe(group, rank),
           "refusals": _train_refusals(group, dp_group, job)}
    for key, m in job["grads"].items():
        out["grads"][key] = {"dense": _rank_train_grads(group, m["cfg"], m["params"],
                                                        m["batch"], NO_COMPRESSION)}
        if m.get("compressed"):
            out["grads"][key]["compressed"] = _rank_train_grads(
                group, m["cfg"], m["params"], m["batch"], PAPER_DEFAULT)
    s = job["steps"]
    out["tp_steps"] = _rank_train_steps(TPContext(tp_group=group), s["cfg"], s["params"],
                                        s["batches"], s["opt_cfg"], slice(None))
    half = len(s["batches"][0]["tokens"]) // 2
    out["dp_steps"] = _rank_train_steps(TPContext(dp_group=dp_group), s["cfg"], s["params"],
                                        s["batches"], s["opt_cfg"],
                                        slice(rank * half, (rank + 1) * half))
    ck = job["checkpoint"]
    out["checkpoint"] = _rank_checkpoint(TPContext(tp_group=group), ck["cfg"], ck)
    return out

