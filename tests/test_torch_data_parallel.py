"""The port's data-parallel ranks and the MoE expert-parallel island against
the reference, on the CPU, fp32, identical weights and inputs.

One spawn of a 2 x 2 ``data x model`` grid of gloo ranks
(``launch/mesh.spawn_ranks(..., tp=2)``, the reference's
``make_host_mesh(data=2, model=2)``) serves every rank case of this module
through ``tests/torch_tp_worker.py::run_grid_rank``:

* (a) grouped routing: reduced mixtral with 3 experts at capacity factor
  0.5 (``E % 2 != 0``: no island, every expert on every rank) on 4 rows of
  40 tokens routes two groups of two rows, which drop other tokens than
  one call over every row; reduced mixtral and llama4 (4 experts, 2 a data
  rank) on 3 rows of 30 tokens (one group: the experts' partials summed
  over the model and the data groups) and on 2 rows of 16 (the tiny-token
  dense path); each equals the reference's single-device ``moe`` called on
  each group's rows and concatenated within rel-L2 1e-5, at capacity
  factor 1.25 and at 0.5, where tokens drop.
* (b) the island: 4 rows of 40 tokens on reduced mixtral and llama4 (two
  groups of 80 tokens, so each group's reference call dispatches too; 2
  experts a data rank) equal (a)'s reference within rel-L2 1e-5, dense,
  dense, and within rel-L2 5e-2 compressed (``simulate_tp=2``'s logits
  tolerance, ``tests/test_torch_prefill.py``) what the reference's codec
  gives where the island compresses (``emulated_island``: the ``down``
  partials, and under ``compress_all_to_all`` the dispatch and the
  combine): the reference's own island does not run on this JAX
  (ShardingTypeError), and its single-device ``moe`` compresses no routed
  expert. The same bits on all four ranks under every policy, with the
  island's collectives counted; and a whole-prompt prefill of 4 prompts of
  40 tokens, whose MoE calls run the island, gives the logits of the
  reference's prefill of each group's 2 prompts within rel-L2 1e-5 dense.
* (c) ``compressed_all_to_all``: the bytes each rank receives are the
  port's codec applied to each slice sent to it, counted as one call with
  the payload's and scales' bytes.
* (d) the engine on the grid: reduced mixtral (ample capacity, so the
  groups change no value) on the split scheduler with 66 slots, whose
  every decode step enters the island: tokens and counters equal to the
  single-device reference Engine's, dense; compressed (the decode too, and
  the all-to-alls), the four ranks' tokens equal and the island's
  compressed collectives counted per decode step.

In the test process: the four grid ranks' expert slices of
``shard_params`` and of ``init_params(tp=..., dp=...)`` put back together
are the converted reference tree. Reduced configs keep 4 query heads over
2 kv heads (the kv heads divide over 2 model ranks). TF32 is off for torch
matmuls.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as reference_engine
from repro.core.mx import fake_quantize as j_fake_quantize
from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.core.tp import TPContext as JTPContext
from repro.models.mlp import mlp as j_mlp
from repro.models.model import Model as JModel
from repro.models.moe import moe as j_moe
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.models.model import Model, is_expert_leaf, shard_axis, shard_leaf
from repro_torch.models.moe import (
    _combine, _dispatch, _experts, capacity, num_groups, route, uses_island,
)
from tests.conftest import fp32_reduced
from tests.test_torch_serving import SUMMARY_KEYS, _CopyingJnp
from tests.torch_tp_worker import run_grid_rank

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DP, TP = 2, 2
HEADS = dict(n_heads=4, n_kv_heads=2)
ARCHS = {"mixtral": "mixtral-8x22b", "llama4": "llama4-maverick-400b-a17b"}
# the MoE probes: model key -> (arch, config overrides, the inputs it runs)
MOE_MODELS = {"mixtral": ("mixtral-8x22b", {}, ("island", "one-group", "dense")),
              "mixtral-drop": ("mixtral-8x22b", dict(capacity_factor=0.5),
                               ("island", "one-group")),
              "mixtral-e3": ("mixtral-8x22b", dict(n_experts=3, capacity_factor=0.5),
                             ("island",)),
              "llama4": ("llama4-maverick-400b-a17b", {}, ("island", "one-group", "dense"))}
# inputs by name: (batch rows, tokens a row)
INPUTS = {"island": (4, 40), "one-group": (3, 30), "dense": (2, 16)}
# the models whose grid prefill of PREFILL prompts is held to the reference's
PREFILL_MODELS = ("mixtral", "mixtral-drop", "llama4")
PREFILL = (4, 40)
# the engine: ample capacity (no expert can overflow), 66 slots (a decode
# batch above 64 that splits over 2 data ranks)
ENGINE_CFG = dict(capacity_factor=4.0)
ENGINE = dict(max_slots=66, max_len=48, block_size=16, prefill_chunk=16, token_budget=0)
REL = 1e-5
REL_COMPRESSED = 5e-2


def configs(arch, **over):
    """(reference, port) reduced fp32 configs of ``arch`` with 4 query heads
    over 2 kv heads and ``over``."""
    cfg_j = dataclasses.replace(fp32_reduced(arch), **HEADS, **over)
    cfg_t = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32", **HEADS,
                                **over)
    return cfg_j, cfg_t


def reference_tree(cfg_j):
    model_j = JModel(cfg_j)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    return model_j, params_j, jax.tree.map(np.asarray, params_j)


def moe_layer(cfg) -> int:
    return next(i for i, s in enumerate(cfg.layers) if s.moe)


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def grouped_reference(cfg_j, params_j, layer, x, whole=False):
    """The reference's single-device ``moe`` on each of the G groups' rows
    of x (B, S, d), concatenated (G = ``num_groups(2, B)``), and with
    ``whole`` its one call over every row (else None)."""
    moe_p = params_j["layers"][layer]["moe"]
    call = lambda rows: np.asarray(j_moe(JTPContext(mesh=None), moe_p, jnp.asarray(rows),
                                         cfg_j)[0])
    B = x.shape[0]
    G = num_groups(DP, B)
    grouped = np.concatenate([call(x[g * B // G:(g + 1) * B // G]) for g in range(G)])
    return grouped, call(x) if whole else None


def grouped_prefill(model_j, params_j, tokens):
    """The reference's single-device prefill logits of each group's rows of
    ``tokens`` (B, S), concatenated."""
    ctx = JTPContext(mesh=None)
    B, S = tokens.shape
    G = num_groups(DP, B)
    return np.concatenate([np.asarray(model_j.prefill(
        ctx, params_j, {"tokens": jnp.asarray(tokens[g * B // G:(g + 1) * B // G])},
        model_j.init_cache(B // G, S, jnp.float32))[0]) for g in range(G)])


def emulated_island(cfg, cfg_j, tree, params_j, layer, x, a2a):
    """What the compressed island computes on x (B, S, d), built from the
    reference's codec (``fake_quantize``, PAPER_DEFAULT) and sums: each
    group dispatched on its own (the port's dispatch, which the dense cases
    hold to the reference's), under ``a2a`` its expert rows quantized (the
    dispatch all-to-all), each model rank's ``d_ff`` half of the experts'
    ``down`` partial quantized and the two summed in fp32 in rank order
    (the reference's simulated compressed reduction), under ``a2a`` that sum
    quantized again (the combine all-to-all), the combine; plus the shared
    experts under the reference's ``simulate_tp=2``."""
    spec = J_PAPER_DEFAULT.spec
    fq = lambda t: torch.from_numpy(np.array(j_fake_quantize(jnp.asarray(t.numpy()), spec)))
    p = params_from_numpy(tree, cfg, "cpu")["layers"][layer]["moe"]
    halves = [{k: {"w": shard_leaf(p[k]["w"], k, "w", h, TP)} for k in ("up", "gate", "down")}
              for h in range(TP)]
    B, S, d = x.shape
    Tg = B * S // DP
    x2 = torch.from_numpy(x.reshape(B * S, d))
    _, _, gates, idx = route(p, x2, cfg)
    outs = []
    for g in range(DP):
        rows = slice(g * Tg, (g + 1) * Tg)
        ei, dest, st, sg = _dispatch(x2[rows], gates[rows], idx[rows], cfg.n_experts,
                                     capacity(cfg, Tg), 1)
        xin = fq(ei[0]) if a2a else ei[0]
        parts = [fq(_experts(hp, xin)) for hp in halves]
        eo = parts[0] + parts[1]
        outs.append(_combine((fq(eo) if a2a else eo)[None], dest, st, sg, Tg))
    out = torch.cat(outs).numpy().reshape(x.shape)
    ctx = JTPContext(mesh=None, policy=J_PAPER_DEFAULT, simulate_tp=2)
    for i in range(cfg.n_shared_experts):
        out = out + np.asarray(j_mlp(ctx, params_j["layers"][layer]["moe"][f"shared{i}"],
                                     jnp.asarray(x), cfg_j))
    return out


def _traffic(vocab):
    return [(((np.arange(n, dtype=np.int32) * 11 + i) % vocab).astype(np.int32), 4 + i)
            for i, n in enumerate((20, 12, 30))]


def _job():
    """The ranks' job (the all-to-all probes, each MoE model's config,
    numpy tree, inputs and prompts, the engine cases) and, for the
    references, each model's (reference config, reference params)."""
    rng = np.random.default_rng(5)
    job = {"moe": {}, "a2a": [(rng.normal(size=(DP, 3, 5, 64))
                               * 10.0 ** rng.integers(-2, 3, (DP, 3, 5, 1))).astype(np.float32)
                              for _ in range(DP * TP)]}
    refs, trees = {}, {}
    for key, (arch, over, names) in MOE_MODELS.items():
        cfg_j, cfg_t = configs(arch, **over)
        base = key.split("-")[0] if key.endswith("-drop") else key
        if base not in trees:
            trees[base] = reference_tree(cfg_j)
        _, params_j, tree = trees[base]
        inputs = {name: (np.random.default_rng(b * 100 + s).normal(size=(b, s, cfg_t.d_model))
                         .astype(np.float32)) for name, (b, s) in INPUTS.items()
                  if name in names}
        job["moe"][key] = dict(cfg=cfg_t, params=tree, layer=moe_layer(cfg_t), inputs=inputs)
        if key in PREFILL_MODELS:
            job["moe"][key]["tokens"] = np.random.default_rng(7).integers(
                0, cfg_t.vocab_size, PREFILL, dtype=np.int32)
        refs[key] = (cfg_j, params_j)
    cfg_j, cfg_t = configs(ARCHS["mixtral"], **ENGINE_CFG)
    model_j, params_j, tree = reference_tree(cfg_j)
    traffic = _traffic(cfg_t.vocab_size)
    job["engine"] = dict(cfg=cfg_t, params=tree, traffic=traffic, cases={
        "split-dense": dict(engine=dict(ENGINE), traffic=traffic, policy="dense"),
        "split-compressed-a2a": dict(engine=dict(ENGINE, compress_decode=True),
                                     traffic=traffic, policy="compressed-a2a")})
    refs["engine"] = (model_j, params_j)
    return job, refs


def _references(job, refs):
    """The reference's per-group MoE outputs (with the one call over every
    row where two groups drop other tokens), ``emulated_island`` on the
    island input, the per-group prefill logits, and the reference Engine's
    run of the engine traffic."""
    ref_moe = {}
    for key, m in job["moe"].items():
        cfg_t, layer, inputs = m["cfg"], m["layer"], m["inputs"]
        cfg_j, params_j = refs[key]
        ref_moe[key] = {name: grouped_reference(
            cfg_j, params_j, layer, x,
            whole=name == "island" and (key == "mixtral-e3" or key.endswith("-drop")))
            for name, x in inputs.items()}
        if uses_island(cfg_t, DP, INPUTS["island"][0], int(np.prod(INPUTS["island"]))):
            ref_moe[key]["emulated"] = {
                a2a: emulated_island(cfg_t, cfg_j, m["params"], params_j, layer,
                                     inputs["island"], a2a) for a2a in (False, True)}
        if "tokens" in m:
            ref_moe[key]["prefill"] = grouped_prefill(JModel(cfg_j), params_j, m["tokens"])
    model_j, params_j = refs["engine"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(reference_engine, "jnp", _CopyingJnp())
        eng = JEngine(model_j, params_j, JTPContext(mesh=None), cache_dtype=jnp.float32,
                      **ENGINE)
        reqs = [JRequest(prompt=p.copy(), max_new_tokens=n, arrival_s=0.0)
                for p, n in job["engine"]["traffic"]]
        eng.run(reqs)
        s = eng.stats.summary()
    return ref_moe, dict(outputs=[r.output.tolist() for r in reqs],
                         summary={k: s[k] for k in SUMMARY_KEYS})


@pytest.fixture(scope="module")
def grid():
    """The 2 x 2 grid's results (one spawn, run while this process computes
    the references), the reference's per-group MoE outputs and logits, and
    the reference Engine's run."""
    job, refs = _job()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_ranks, run_grid_rank, DP * TP, job, device="cpu", threads=1,
                            timeout_s=600, tp=TP)
        ref_moe, ref_engine = _references(job, refs)
        ranks = ranks.result()
    return dict(job=job, ranks=ranks, ref_moe=ref_moe, ref_engine=ref_engine)


def test_grid_places_ranks_by_rows_and_columns(grid):
    """Rank r = d * tp + m: data rank d, model rank m."""
    assert [r["grid"] for r in grid["ranks"]] == [(d, m, DP, TP) for d in range(DP)
                                                 for m in range(TP)]


def _outputs(grid, key, name, policy):
    got = [r["moe"][key][name, policy] for r in grid["ranks"]]
    for g in got[1:]:
        assert np.array_equal(g["y"], got[0]["y"]), (key, name, policy)
    return got[0]


@pytest.mark.parametrize("key", sorted(MOE_MODELS))
def test_grouped_routing_equals_reference_per_group(grid, key):
    """(a): the non-island calls (every expert on 2 groups for 3 experts;
    one group, or the dense path, on 2 experts a data rank), dense, equal
    the reference's per-group ``moe`` on every rank, at capacity factors
    1.25 and 0.5; two groups of 3 experts route otherwise than one call
    over every row."""
    cfg = grid["job"]["moe"][key]["cfg"]
    for name in [n for n in MOE_MODELS[key][2] if n != "island" or key == "mixtral-e3"]:
        b, s = INPUTS[name]
        assert not uses_island(cfg, DP, b, b * s)
        out = _outputs(grid, key, name, "dense")
        want, whole = grid["ref_moe"][key][name]
        assert rel_l2(out["y"], want) <= REL, (key, name)
        c = out["counts"]
        sharded = cfg.n_experts % DP == 0
        assert (c["island"], c["dp_all_gather"], c["dense_all_to_all"]) == (0, 0, 0)
        shared = cfg.n_shared_experts   # each shared expert's down: one all-reduce
        assert c["all_reduce"] == 1 + sharded + shared, (key, name, c)
    if key == "mixtral-e3":
        want, whole = grid["ref_moe"][key]["island"]
        assert num_groups(DP, INPUTS["island"][0]) == 2 and rel_l2(whole, want) > 1e-3


@pytest.mark.parametrize("key", ["mixtral", "mixtral-drop", "llama4"])
@pytest.mark.parametrize("policy", ["dense", "compressed", "compressed-a2a"])
def test_island_equals_reference_per_group(grid, key, policy):
    """(b): 4 rows of 40 tokens (two groups of two rows) on 2 experts a data
    rank run the island; the four ranks' outputs are the same bits and
    equal, dense, the reference's per-group ``moe`` within rel-L2 1e-5 and,
    compressed, ``emulated_island`` (the reference's codec where the island
    compresses) within 5e-2. Counted per call: one island entry, two all-to-alls
    over the data group (compressed under ``compress_all_to_all``), one
    data all-gather of the rows, and the ``down`` partial's reduction over
    the model group (two all-gathers compressed, one all-reduce dense)."""
    m = grid["job"]["moe"][key]
    cfg = m["cfg"]
    b, s = INPUTS["island"]
    assert uses_island(cfg, DP, b, b * s)
    out = _outputs(grid, key, "island", policy)
    want, whole = grid["ref_moe"][key]["island"]
    if policy == "dense":
        assert rel_l2(out["y"], want) <= REL, (key, rel_l2(out["y"], want))
    else:
        want = grid["ref_moe"][key]["emulated"][policy == "compressed-a2a"]
        assert rel_l2(out["y"], want) <= REL_COMPRESSED, (key, policy, rel_l2(out["y"], want))
    if key.endswith("-drop"):   # two groups drop other tokens than one call
        assert rel_l2(whole, want) > 1e-3
    c = out["counts"]
    a2a = policy == "compressed-a2a"
    assert (c["island"], c["dp_all_gather"]) == (1, 1)
    assert (c["compressed_all_to_all"], c["dense_all_to_all"]) == ((2, 0) if a2a else (0, 2))
    d = cfg.d_model
    C = int(cfg.capacity_factor * (b // DP) * s * cfg.top_k / cfg.n_experts)
    rows = DP * (cfg.n_experts // DP) * C             # the down partial (dp, El, C, d)
    shared = cfg.n_shared_experts
    if policy == "dense":
        assert (c["all_reduce"], c["all_gather"]) == (1 + shared, 0)
        assert c["island_down_bytes"] == rows * d * 4
        assert c["dense_all_to_all_bytes"] == 2 * rows * d * 4
    else:
        wire = rows * (d // 2 + d // 32)              # fp4 payload + one scale per 32
        assert (c["all_reduce"], c["all_gather"]) == (0, 2 + 2 * shared)
        assert c["island_down_bytes"] == wire
        if a2a:
            assert c["compressed_all_to_all_bytes"] == 2 * wire
    assert c["dp_all_gather_bytes"] == (b // DP) * s * d * 4


@pytest.mark.parametrize("key", PREFILL_MODELS)
@pytest.mark.parametrize("policy", ["dense", "compressed", "compressed-a2a"])
def test_island_prefill_logits_on_the_grid(grid, key, policy):
    """(b): a whole-prompt prefill of 4 prompts of 40 tokens on the grid
    (its MoE calls run the island) gives the same logits on all four ranks:
    dense, the logits of the reference's prefill of each group's 2 prompts
    within rel-L2 1e-5; compressed, finite logits that the compression
    moved (the island compresses reductions the reference's single-device
    path cannot: ``test_island_equals_reference_per_group`` holds them to
    the reference's codec), with one island, one data all-gather and (under
    ``compress_all_to_all``) two compressed all-to-alls per MoE layer."""
    cfg = grid["job"]["moe"][key]["cfg"]
    out = _outputs(grid, key, "prefill", policy)
    dense = grid["ref_moe"][key]["prefill"]
    if policy == "dense":
        assert rel_l2(out["y"], dense) <= REL, (key, rel_l2(out["y"], dense))
    else:
        assert rel_l2(out["y"], dense) > 1e-3
    c = out["counts"]
    L = sum(s.moe for s in cfg.layers)
    assert (c["island"], c["dp_all_gather"]) == (L, L)
    assert c["compressed_all_to_all"] == (2 * L if policy == "compressed-a2a" else 0)


def test_compressed_all_to_all_is_the_codec_per_slice(grid):
    """(c): data rank i receives from data rank j the port's codec applied
    to the slice j sent it (bit for bit), in x's dtype and shape; one call,
    counting the payload's and the scales' bytes."""
    probes = grid["job"]["a2a"]
    spec = PAPER_DEFAULT.spec
    for r, res in enumerate(grid["ranks"]):
        d, m = divmod(r, TP)
        sent = [probes[j * TP + m][d] for j in range(DP)]      # what each data rank sends
        want = np.stack([ops.mx_dequantize(ops.mx_quantize(torch.from_numpy(x), spec), spec,
                                           out_dtype=torch.float32).numpy() for x in sent])
        assert res["a2a"]["shape"] == want.shape
        assert res["a2a"]["dtype"] == "torch.float32"
        np.testing.assert_array_equal(res["a2a"]["y"].reshape(-1), want.view(np.uint8).reshape(-1))
        comp = ops.mx_quantize(torch.from_numpy(probes[r]), spec)
        c = res["a2a"]["counts"]
        assert c["compressed_all_to_all"] == 1 and c["all_to_all"] == 0
        assert c["compressed_all_to_all_bytes"] == c["bytes"] == (comp.payload.numel()
                                                                  + comp.scales.numel())


def test_experts_held_per_rank(grid):
    """Each rank holds its data rank's 2 of 4 experts (all 3 of 3), half of
    each one's d_ff."""
    for key, m in grid["job"]["moe"].items():
        cfg = m["cfg"]
        El = cfg.n_experts // DP if cfg.n_experts % DP == 0 else cfg.n_experts
        for r in grid["ranks"]:
            assert r["moe"][key]["experts_held"] == (El, cfg.d_model, cfg.d_ff // TP)


@pytest.mark.parametrize("case", ["split-dense", "split-compressed-a2a"])
def test_grid_engine_tokens_and_counters(grid, case):
    """(d): the split scheduler with 66 slots on the grid: every rank's
    tokens equal (and, dense, equal the single-device reference Engine's,
    with its steps, dispatches and token counts); every decode step enters
    the island in each MoE layer (compressed: its ``down`` reductions and
    all-to-alls compressed), each chunk does not (16 tokens: the dense
    path, the experts' partials summed over both groups)."""
    cfg = grid["job"]["engine"]["cfg"]
    runs = [r["engine"][case]["runs"][0] for r in grid["ranks"]]
    ref = grid["ref_engine"]
    for run in runs:
        assert run["outputs"] == runs[0]["outputs"]
        assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
        assert {k: run["summary"][k] for k in SUMMARY_KEYS} == ref["summary"]
    if case == "split-dense":
        assert runs[0]["outputs"] == ref["outputs"]
    L = sum(s.moe for s in cfg.layers)
    n_dec = sum(1 for _, d in runs[0]["step_tokens"] if d)
    n_chunk = sum(1 for p, _ in runs[0]["step_tokens"] if p)
    assert n_dec > 0 and n_chunk > 0
    c = runs[0]["tp"]
    assert (c["island"], c["dp_all_gather"]) == (L * n_dec, L * n_dec)
    if case == "split-dense":
        assert (c["dense_all_to_all"], c["compressed_all_to_all"]) == (2 * L * n_dec, 0)
        # per chunk: wo and the experts over the model group, the experts over
        # the data group; per decode step: wo and each island's down
        assert c["all_reduce"] == n_chunk * (2 * L) + n_chunk * L + n_dec * 2 * L
        assert c["all_gather"] == 0
    else:
        assert (c["compressed_all_to_all"], c["dense_all_to_all"]) == (2 * L * n_dec, 0)
        # compressed: the chunk's wo (16 tokens) and every decode step's wo and
        # island down (66 rows), two all-gathers each
        assert c["all_gather"] == 2 * (n_chunk * L + n_dec * 2 * L)
        assert c["all_reduce"] == n_chunk * 2 * L


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_grid_expert_slices_reassemble_to_reference_tree(arch):
    """The four grid ranks' ``shard_params`` slices: each expert leaf put
    back together (model ranks along its ``d_ff`` axis, then data ranks
    along the expert axis) is the converted reference tree's leaf, every
    other leaf the TP shard of the rank's model rank; and
    ``init_params(tp=..., dp=...)`` keeps the same slices of
    ``init_params()``."""
    cfg_j, cfg = configs(ARCHS[arch])
    _, _, tree = reference_tree(cfg_j)

    def leaves(node, key="", parent=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, k, key)
        elif isinstance(node, list):
            for v in node:
                yield from leaves(v, key, parent)
        else:
            yield parent, key, np.asarray(node, np.float32)

    full = list(leaves(tree))
    shards = {(d, m): list(leaves(shard_params(tree, cfg, m, TP, dp_rank=d, dp=DP)))
              for d in range(DP) for m in range(TP)}
    n_expert = 0
    for i, (parent, key, want) in enumerate(full):
        axis = shard_axis(parent, key)
        rows = [[shards[d, m][i][2] for m in range(TP)] for d in range(DP)]
        cols = [r[0] if axis is None else np.concatenate(r, axis=axis) for r in rows]
        if is_expert_leaf(parent, key, want.ndim):
            n_expert += 1
            assert all(c.shape[0] == cfg.n_experts // DP for c in cols)
            np.testing.assert_array_equal(np.concatenate(cols, axis=0), want)
        else:
            for c in cols:
                np.testing.assert_array_equal(c, want)
    assert n_expert == 3 * sum(s.moe for s in cfg.layers)
    model = Model(cfg)
    whole = list(leaves(model.init_params(device="cpu", seed=3)))
    for d in range(DP):
        part = list(leaves(model.init_params(device="cpu", seed=3, tp=(1, TP), dp=(d, DP))))
        for (parent, key, w), (_, _, p) in zip(whole, part):
            if is_expert_leaf(parent, key, w.ndim):
                El = cfg.n_experts // DP
                w = w[d * El:(d + 1) * El]
            axis = shard_axis(parent, key)
            if axis is not None:
                size = w.shape[axis] // TP
                w = np.take(w, np.arange(size, 2 * size), axis=axis)
            np.testing.assert_array_equal(p, w)
