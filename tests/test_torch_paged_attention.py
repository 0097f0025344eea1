"""The plain version of the port's paged-attention kernel against the
reference's Pallas kernel (``repro.kernels.paged_attention``, interpret mode
on the CPU), on the same pools, tables and queries: the mixed geometry (with
budget pads, and a row that has no valid key at all), the decode geometry,
a chunk geometry (Sq > 1), dense and fp4 wire pools, GQA groups G = 1 and 2,
and one sliding-window case; the multi-segment mixed geometry also at the
new families' groups G = 7 and 8 and at head_dim 256 (G = 2), with and
without a window; and the ``row_map`` read of sequence-sharded pools (a
virtual pool of per-slot regions, ``pool[slot_tables.reshape(-1)]``) in the
decode, chunk and mixed geometries against the reference kernel's
``row_map`` path, and bit for bit against the table walk over the original
pool. fp32 throughout; tolerance 1e-5 (summation order only).
TF32 is switched off for torch matmuls in this file.

The CUDA kernel cuts the query vectors into 64-vector tiles and those into
runs of rows that share a block table; a multi-segment mixed geometry whose
runs cross tile boundaries (at G = 7 a row's 7 query vectors straddle them
too) is held against Pallas here, and a torch
emulation of the kernel's tiled online softmax (bf16 tensor-core operands,
P split into bf16 hi + lo parts) is held against the plain version within
``chip_smoke.py``'s per-element tolerance, so a precision fault of that
design shows on the CPU.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro.core.formats import MXSpec as JMXSpec
from repro.core.mx import MXCompressed as JMX
from repro.kernels.paged_attention import paged_attention as pallas_paged_attention
from repro_torch.core.formats import MXSpec
from repro_torch.core.mx import MXCompressed
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
HD, BS, N_BLOCKS = 32, 16, 12
T_INVALID = 2**30


def _pools(kv_dim, fmt, seed=0, n_blocks=N_BLOCKS):
    """The same random K/V pools for both frameworks (fp4: the reference
    codec's wire bytes, handed to the port as they are)."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(n_blocks, BS, kv_dim)).astype(np.float32)
    v = rng.normal(size=(n_blocks, BS, kv_dim)).astype(np.float32)
    if fmt == "dense":
        return (jnp.asarray(k), jnp.asarray(v)), (torch.from_numpy(k), torch.from_numpy(v)), None
    jspec = JMXSpec.make(fmt, 32)
    jk, jv = jmx.quantize(jnp.asarray(k), jspec), jmx.quantize(jnp.asarray(v), jspec)
    to_t = lambda c: MXCompressed(torch.from_numpy(np.array(c.payload)),
                                  torch.from_numpy(np.array(c.scales)))
    return (jk, jv), (to_t(jk), to_t(jv)), (jspec, MXSpec.make(fmt, 32))


def _mixed_geometry():
    """3 slots: slot 0 prefilling positions 37..40 over history 37, slot 1
    decoding at 52, slot 2 empty (its pad rows have no valid key at all)."""
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    starts = np.array([37, 52, 0], np.int32)
    positions = np.array([37, 38, 39, 40, 52, 0, 0], np.int32)
    slot_ids = np.array([0, 0, 0, 0, 1, 2, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 0, 0], bool)
    same = (slot_ids[None, :] == slot_ids[:, None]) & valid[None, :]
    t_extra = np.where(same, positions[None, :], T_INVALID).astype(np.int32)
    return (tables[slot_ids], starts[slot_ids], positions[:, None], t_extra)


def _run_both(q, pools_j, pools_t, specs, tables, hist, q_pos, extras, kv_heads, window,
              hd=HD, row_map=None):
    (pk_j, pv_j), (pk_t, pv_t) = pools_j, pools_t
    jspec, tspec = specs if specs else (None, None)
    e_j = e_t = (None, None, None)
    if extras is not None:
        ke, ve, te = extras
        e_j = (jnp.asarray(ke), jnp.asarray(ve), jnp.asarray(te))
        e_t = (torch.from_numpy(ke), torch.from_numpy(ve), torch.from_numpy(te))
    ref = pallas_paged_attention(
        jnp.asarray(q), pk_j, pv_j, jnp.asarray(tables), jnp.asarray(hist),
        jnp.asarray(q_pos), *e_j, None if row_map is None else jnp.asarray(row_map),
        spec=jspec, kv_heads=kv_heads, scale=hd**-0.5, window=window,
        out_dtype=jnp.float32, interpret=True)
    args = (torch.from_numpy(q), pk_t, pv_t, torch.from_numpy(tables),
            torch.from_numpy(hist), torch.from_numpy(q_pos), *e_t,
            None if row_map is None else torch.from_numpy(row_map))
    got = paged_attention(*args, spec=tspec, kv_heads=kv_heads, scale=hd**-0.5,
                          window=window)
    # the CPU dispatch IS the plain version
    np.testing.assert_array_equal(
        got.numpy(), paged_attention_plain(*args, spec=tspec, kv_heads=kv_heads,
                                           scale=hd**-0.5, window=window).numpy())
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("fmt", ["dense", "fp4_e2m1"])
def test_mixed_geometry_matches_pallas(fmt, groups):
    kv_heads, n_heads = 4 // groups, 4
    pools_j, pools_t, specs = _pools(kv_heads * HD, fmt)
    tables, hist, q_pos, t_extra = _mixed_geometry()
    rng = np.random.default_rng(1)
    R = len(tables)
    q = rng.normal(size=(R, 1, n_heads * HD)).astype(np.float32)
    ke = rng.normal(size=(R, kv_heads * HD)).astype(np.float32)
    ve = rng.normal(size=(R, kv_heads * HD)).astype(np.float32)
    got, ref = _run_both(q, pools_j, pools_t, specs, tables, hist, q_pos,
                         (ke, ve, t_extra), kv_heads, None)
    np.testing.assert_allclose(got, ref, **TOL)
    # the slot-2 pad row attends nothing: both average every key it addresses
    keys_v = (np.asarray(pools_j[1]) if fmt == "dense"
              else np.asarray(jmx.dequantize(pools_j[1], specs[0])))
    mean = np.concatenate([keys_v[tables[5]].reshape(-1, kv_heads * HD), ve]).mean(0)
    np.testing.assert_allclose(got[5, 0].reshape(n_heads, HD),
                               np.repeat(mean.reshape(kv_heads, HD), groups, 0), **TOL)


@pytest.mark.parametrize("fmt", ["dense", "fp4_e2m1"])
def test_decode_geometry_matches_pallas(fmt):
    kv_heads = 2
    pools_j, pools_t, specs = _pools(kv_heads * HD, fmt, seed=2)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    lengths = np.array([37, 52], np.int32)
    q = np.random.default_rng(3).normal(size=(2, 1, 4 * HD)).astype(np.float32)
    got, ref = _run_both(q, pools_j, pools_t, specs, tables, lengths + 1,
                         lengths[:, None].copy(), None, kv_heads, None)
    np.testing.assert_allclose(got, ref, **TOL)


def test_chunk_geometry_matches_pallas():
    """R = 1, Sq = 8 (a prefill chunk over its own extras), G = 2."""
    kv_heads = 2
    pools_j, pools_t, specs = _pools(kv_heads * HD, "fp4_e2m1", seed=4)
    p = np.arange(37, 45, dtype=np.int32)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 8, 4 * HD)).astype(np.float32)
    ke = rng.normal(size=(8, kv_heads * HD)).astype(np.float32)
    ve = rng.normal(size=(8, kv_heads * HD)).astype(np.float32)
    got, ref = _run_both(q, pools_j, pools_t, specs, np.array([[1, 2, 3, 4]], np.int32),
                         np.array([37], np.int32), p[None], (ke, ve, p[None].copy()),
                         kv_heads, None)
    np.testing.assert_allclose(got, ref, **TOL)


def test_sliding_window_matches_pallas():
    kv_heads = 4
    pools_j, pools_t, specs = _pools(kv_heads * HD, "dense", seed=6)
    tables, hist, q_pos, t_extra = _mixed_geometry()
    rng = np.random.default_rng(7)
    R = len(tables)
    q = rng.normal(size=(R, 1, 4 * HD)).astype(np.float32)
    ke = rng.normal(size=(R, kv_heads * HD)).astype(np.float32)
    ve = rng.normal(size=(R, kv_heads * HD)).astype(np.float32)
    got, ref = _run_both(q, pools_j, pools_t, specs, tables, hist, q_pos,
                         (ke, ve, t_extra), kv_heads, 8)
    np.testing.assert_allclose(got, ref, **TOL)


# ------------------------------------------ row_map: sequence-sharded pools


def _virtual(pools_j, pools_t, slot_tables):
    """Both frameworks' virtual pools of ``pool_exchange``: the blocks of
    each slot's table, one region of nb blocks per slot, in table order."""
    idx = slot_tables.reshape(-1)
    take_j = lambda p: p[idx] if not isinstance(p, JMX) else JMX(p.payload[idx], p.scales[idx])
    take_t = lambda p: (p[torch.from_numpy(idx).long()] if not isinstance(p, MXCompressed)
                        else MXCompressed(*(a[torch.from_numpy(idx).long()] for a in p)))
    return tuple(map(take_j, pools_j)), tuple(map(take_t, pools_t))


def _row_map_case(geo, fmt, groups=2, hd=HD):
    """(q, pools, specs, slot tables, row arguments, row_map, extras, kv_heads,
    window) of one served geometry: the mixed step (row_map = slot_ids),
    the split decode (arange(B)) and the split chunk (zeros(1))."""
    rng = np.random.default_rng(13)
    if geo == "multi_segment":
        kv_heads = max(1, 4 // groups)
        pools_j, pools_t, specs = _pools(kv_heads * hd, fmt, seed=8, n_blocks=33)
        slot_tables = np.arange(1, 33, dtype=np.int32).reshape(4, 8)
        tables, hist, q_pos, t_extra = _multi_segment_geometry()
        # rows of the empty slot 4 read an all-null region of their own
        slot_tables = np.concatenate([slot_tables, np.zeros((1, 8), np.int32)])
        sid = np.array([next(i for i, t in enumerate(slot_tables) if (t == row).all())
                        for row in tables], np.int32)
        window = 24
    else:
        kv_heads = 2
        pools_j, pools_t, specs = _pools(kv_heads * hd, fmt, seed=14)
        window = None
        slot_tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
        if geo == "mixed":
            tables, hist, q_pos, t_extra = _mixed_geometry()
            sid = np.array([0, 0, 0, 0, 1, 2, 0], np.int32)
        elif geo == "decode":
            slot_tables = slot_tables[:2]
            tables, sid = slot_tables, np.arange(2, dtype=np.int32)
            lengths = np.array([37, 52], np.int32)
            hist, q_pos, t_extra = lengths + 1, lengths[:, None].copy(), None
        else:  # chunk: R = 1, Sq = 8 over its own extras
            slot_tables = slot_tables[:1]
            tables, sid = slot_tables, np.zeros(1, np.int32)
            q_pos = np.arange(37, 45, dtype=np.int32)[None]
            hist, t_extra = np.array([37], np.int32), q_pos.copy()
    R, Sq = q_pos.shape
    q = rng.normal(size=(R, Sq, kv_heads * groups * hd)).astype(np.float32)
    extras = None
    if t_extra is not None:
        E = t_extra.shape[1]
        extras = (rng.normal(size=(E, kv_heads * hd)).astype(np.float32),
                  rng.normal(size=(E, kv_heads * hd)).astype(np.float32), t_extra)
    return (q, pools_j, pools_t, specs, slot_tables, (tables, hist, q_pos), sid, extras,
            kv_heads, window)


@pytest.mark.parametrize("fmt", ["dense", "fp4_e2m1"])
@pytest.mark.parametrize("geo", ["decode", "chunk", "mixed", "multi_segment"])
def test_row_map_matches_pallas_and_table_walk(geo, fmt):
    """The plain version's ``row_map`` read over a virtual pool matches the
    reference kernel's ``row_map`` read (interpret mode) within the file's
    tolerance, and equals the table walk over the original pool exactly."""
    (q, pools_j, pools_t, specs, slot_tables, (tables, hist, q_pos), sid, extras,
     kv_heads, window) = _row_map_case(geo, fmt)
    vj, vt = _virtual(pools_j, pools_t, slot_tables)
    got, ref = _run_both(q, vj, vt, specs, tables, hist, q_pos, extras, kv_heads, window,
                         row_map=sid)
    np.testing.assert_allclose(got, ref, **TOL)
    walk = paged_attention_plain(
        torch.from_numpy(q), *pools_t, torch.from_numpy(tables), torch.from_numpy(hist),
        torch.from_numpy(q_pos), *([torch.from_numpy(a) for a in extras] if extras else []),
        spec=specs[1] if specs else None, kv_heads=kv_heads, scale=HD**-0.5, window=window)
    np.testing.assert_array_equal(got, walk.numpy())


# ------------------------------------------- runs across the kernel's 64-vector tiles


def _slot_rows(slot_tables, starts, segs, decodes, pads):
    """Rows of a mixed step as ``build_mixed_batch`` lays them out: prefill
    segments (slot, start, n), decode rows (slot, position), then budget pads
    (slot, count) at position 0; a slot >= len(starts) is empty (null table,
    no history). Returns (tables, hist, q_pos, t_extra) as numpy int32."""
    sid, pos, valid = [], [], []
    for slot, start, n in segs:
        sid, pos, valid = sid + [slot] * n, pos + list(range(start, start + n)), valid + [1] * n
    for slot, p in decodes:
        sid, pos, valid = sid + [slot], pos + [p], valid + [1]
    for slot, n in pads:
        sid, pos, valid = sid + [slot] * n, pos + [0] * n, valid + [0] * n
    sid, pos, valid = np.array(sid), np.array(pos, np.int32), np.array(valid, bool)
    live = sid < len(starts)
    own = np.minimum(sid, len(starts) - 1)
    tables = np.where(live[:, None], slot_tables[own], 0).astype(np.int32)
    hist = np.where(live, starts[own], 0).astype(np.int32)
    same = (sid[None, :] == sid[:, None]) & valid[None, :]
    t_extra = np.where(same, pos[None, :], T_INVALID).astype(np.int32)
    return tables, hist, pos[:, None].copy(), t_extra


def _multi_segment_geometry():
    """144 rows: a 70-row prefill segment of slot 0 (it crosses the first
    64-row tile boundary), a 20-row segment of slot 1, decode rows of slots 2
    and 3, 40 pads of an empty slot (they cross the second boundary and see
    no key) and 12 pads of slot 0 (one key each)."""
    nb = 8
    slot_tables = np.arange(1, 1 + 4 * nb, dtype=np.int32).reshape(4, nb)
    starts = np.array([37, 50, 60, 45], np.int32)
    return _slot_rows(slot_tables, starts, [(0, 37, 70), (1, 50, 20)], [(2, 60), (3, 45)],
                      [(4, 40), (0, 12)])


# (GQA group, head_dim): the served groups of llama2 / internlm2 (1, 2),
# qwen2-7b (7), qwen3-32b (8), and gemma3-4b's head_dim 256
HEADS = [pytest.param((1, HD), id="1"), pytest.param((2, HD), id="2"),
         pytest.param((7, HD), id="7"), pytest.param((8, HD), id="8"),
         pytest.param((2, 256), id="2-hd256")]


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("groups", HEADS)
@pytest.mark.parametrize("fmt", ["dense", "fp4_e2m1"])
def test_multi_segment_mixed_matches_pallas(fmt, groups, window):
    groups, hd = groups
    kv_heads = max(1, 4 // groups)
    n_heads = kv_heads * groups
    pools_j, pools_t, specs = _pools(kv_heads * hd, fmt, seed=8, n_blocks=33)
    tables, hist, q_pos, t_extra = _multi_segment_geometry()
    rng = np.random.default_rng(9)
    R = len(tables)
    q = rng.normal(size=(R, 1, n_heads * hd)).astype(np.float32)
    ke = rng.normal(size=(R, kv_heads * hd)).astype(np.float32)
    ve = rng.normal(size=(R, kv_heads * hd)).astype(np.float32)
    got, ref = _run_both(q, pools_j, pools_t, specs, tables, hist, q_pos,
                         (ke, ve, t_extra), kv_heads, window, hd)
    np.testing.assert_allclose(got, ref, **TOL)


def _kernel_runs(tables, hist, n_vectors, per_row):
    """The CUDA kernel's runs: within each tile of 64 query vectors, maximal
    ranges whose rows share (tables[r], hist[r]) with the row before."""
    runs = []
    for u0 in range(0, n_vectors, 64):
        u1 = min(u0 + 64, n_vectors)
        start = u0
        for u in range(u0 + 1, u1):
            r, rp = u // per_row, (u - 1) // per_row
            if r != rp and not (hist[r] == hist[rp] and torch.equal(tables[r], tables[rp])):
                runs.append((start, u))
                start = u
        runs.append((start, u1))
    return runs


def _emulate_kernel(q, pool_k, pool_v, tables, hist, q_pos, k_extra, v_extra, t_extra, *,
                    spec, kv_heads, scale, window=None, split_p=True):
    """Torch emulation of the kernel's bf16 path: per kv head, per run, key
    tiles of 64 (the run's pool positions, then the extras), skipping tiles
    no vector of the run may see. Runs of more than 8 vectors take the
    tensor-core path: bf16 operands, fp32 products and sums, online softmax
    in fp32, P split into bf16 hi + lo parts (``split_p``; hi alone when
    False). Shorter runs take the CUDA-core path, fp32 throughout. Vectors
    with no valid key get the mean of every key their row addresses."""
    from repro_torch.kernels.paged_attention import _gather_pool

    R, Sq, q_dim = q.shape
    keys, vals = _gather_pool(pool_k, tables, spec), _gather_pool(pool_v, tables, spec)
    cap, kv_dim = keys.shape[1], keys.shape[2]
    hd = kv_dim // kv_heads
    G = q_dim // hd // kv_heads
    qf = q.float().reshape(R, Sq, kv_heads, G, hd)
    ke = k_extra.float() if k_extra is not None else torch.zeros(0, kv_dim)
    ve = v_extra.float() if v_extra is not None else torch.zeros(0, kv_dim)
    E = ke.shape[0]
    out = torch.zeros(R, Sq, kv_heads, G, hd)
    hist = hist.clamp(0, cap)
    visible = lambda t, qp: (t <= qp) & ((t > qp - window) if window else True)
    for kvh in range(kv_heads):
        cols = slice(kvh * hd, (kvh + 1) * hd)
        for u0, u1 in _kernel_runs(tables, hist, R * Sq * G, Sq * G):
            u = torch.arange(u0, u1)
            r, s, g = u // (Sq * G), (u // G) % Sq, u % G
            Q, qp = qf[r, s, kvh, g], q_pos[r, s][:, None].long()
            r0 = int(r[0])
            t_hi = max(0, min(int(hist[r0]), int(qp.max()) + 1))
            t_lo = max(0, int(qp.min()) - window + 1) if window else 0
            tiles = [(keys[r0, t0:min(t0 + 64, t_hi), cols], vals[r0, t0:min(t0 + 64, t_hi), cols],
                      visible(torch.arange(t0, min(t0 + 64, t_hi))[None], qp))
                     for t0 in range(t_lo, t_hi, 64)]
            tiles += [(ke[e0:e0 + 64, cols], ve[e0:e0 + 64, cols],
                       visible(t_extra[r, e0:e0 + 64].long(), qp)) for e0 in range(0, E, 64)]
            mma = len(u) > 8
            m = torch.full((len(u), 1), -1e30)
            l, acc = torch.zeros(len(u), 1), torch.zeros(len(u), hd)
            for Kt, Vt, ok in tiles:
                if not ok.any():
                    continue
                sc = torch.where(ok, (Q @ Kt.T) * scale, torch.tensor(-math.inf))
                m_new = torch.maximum(m, sc.max(1, keepdim=True).values)
                alpha, p = torch.exp(m - m_new), torch.exp(sc - m_new)
                l = l * alpha + p.sum(1, keepdim=True)
                if mma:
                    hi = p.to(torch.bfloat16).float()
                    pv = hi @ Vt + ((p - hi).to(torch.bfloat16).float() @ Vt if split_p else 0)
                else:
                    pv = p @ Vt
                acc, m = acc * alpha + pv, m_new
            mean = torch.cat([vals[r0, :, cols], ve[:, cols]]).mean(0)
            out[r, s, kvh, g] = torch.where(l > 0, acc / l.clamp(min=1e-38), mean)
    return out.reshape(R, Sq, q_dim).to(q.dtype)


def _within_chip_tolerance(got, ref):
    """``chip_smoke.py``'s check of the card's bf16 output: each element
    within one bf16 rounding of the reference (2^-7 |ref| + 1e-4), rel-L2
    at most 2e-3. Returns (elements over, rel-L2)."""
    o, r = got.float(), ref.float()
    over = int(((o - r).abs() > 2.0**-7 * r.abs() + 1e-4).sum())
    return over, float((o - r).norm() / r.norm())


def _llama2_mixed_one_head(fmt):
    """chip_smoke's mixed geometry at llama2-7b's head dim on one kv head: a
    256-row prefill chunk over 256 positions of history, 3 decode rows at
    history 520-540, one pad of an empty slot; bf16 q, extras and pools."""
    from repro_torch.core.mx import quantize

    hd, nb, bs = 128, 34, 16
    slot_tables = np.arange(1, 1 + 4 * nb, dtype=np.int32).reshape(4, nb)
    starts = np.array([256, 520, 530, 540], np.int32)
    rows = _slot_rows(slot_tables, starts, [(0, 256, 256)], [(1, 520), (2, 530), (3, 540)],
                      [(4, 1)])
    rng = np.random.default_rng(10)
    bf = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    pk, pv = bf(4 * nb + 1, bs, hd), bf(4 * nb + 1, bs, hd)
    spec = None
    if fmt == "fp4_e2m1":
        spec = MXSpec.make(fmt, 32)
        pk, pv = (MXCompressed(*(a.reshape(4 * nb + 1, bs, -1) for a in
                                 quantize(p.reshape(-1, hd), spec))) for p in (pk, pv))
    R = len(rows[0])
    return bf(R, 1, hd), pk, pv, rows, bf(R, hd), bf(R, hd), spec


def _small_bf16_case(fmt, kv_heads=2, groups=2, hd=HD):
    tables, hist, q_pos, t_extra = _multi_segment_geometry()
    _, (pk, pv), specs = _pools(kv_heads * hd, fmt, seed=11, n_blocks=33)
    spec = specs[1] if specs else None
    if spec is None:
        pk, pv = pk.to(torch.bfloat16), pv.to(torch.bfloat16)
    rng = np.random.default_rng(12)
    bf = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    R = len(tables)
    return bf(R, 1, kv_heads * groups * hd), pk, pv, (tables, hist, q_pos, t_extra), \
        bf(R, kv_heads * hd), bf(R, kv_heads * hd), spec


@pytest.mark.parametrize("fmt", ["dense", "fp4_e2m1"])
@pytest.mark.parametrize("case", ["multi_segment_G2_window", "llama2_mixed",
                                  "multi_segment_G7_window", "multi_segment_G2_hd256_window"])
def test_tiled_kernel_emulation_within_chip_tolerance(case, fmt):
    """The kernel's tiling, run split and hi/lo probabilities keep its bf16
    output within chip_smoke's per-element tolerance of the plain version;
    at G = 7 (one kv head, so the 144 rows' 1008 query vectors) a row's
    vectors straddle the 64-vector tiles, and each tile's part of a row is
    a run of its own."""
    if case == "llama2_mixed":
        q, pk, pv, rows, ke, ve, spec = _llama2_mixed_one_head(fmt)
        kw = dict(spec=spec, kv_heads=1, scale=128**-0.5, window=None)
    elif case == "multi_segment_G7_window":
        q, pk, pv, rows, ke, ve, spec = _small_bf16_case(fmt, kv_heads=1, groups=7)
        kw = dict(spec=spec, kv_heads=1, scale=HD**-0.5, window=24)
        runs = _kernel_runs(torch.from_numpy(rows[0]), torch.from_numpy(rows[1]), 7 * 144, 7)
        assert any(b % 64 == 0 and b % 7 for _, b in runs)   # a row cut by a tile's end
    elif case == "multi_segment_G2_hd256_window":
        q, pk, pv, rows, ke, ve, spec = _small_bf16_case(fmt, hd=256)
        kw = dict(spec=spec, kv_heads=2, scale=256**-0.5, window=24)
    else:
        q, pk, pv, rows, ke, ve, spec = _small_bf16_case(fmt)
        kw = dict(spec=spec, kv_heads=2, scale=HD**-0.5, window=24)
    rows = [torch.from_numpy(a) for a in rows]
    args = (q, pk, pv, *rows[:3], ke, ve, rows[3])
    ref = paged_attention_plain(*args, **kw)
    got = _emulate_kernel(*args, **kw)
    assert got.dtype == ref.dtype == torch.bfloat16
    over, rel = _within_chip_tolerance(got, ref)
    assert over == 0 and rel <= 2e-3, (over, rel)


def test_bf16_probabilities_alone_break_the_chip_tolerance():
    """Why the kernel splits P: rounded to bf16 once for the PV product, the
    probabilities of the llama2-7b mixed geometry leave elements beyond one
    bf16 step of the reference; the hi + lo split above does not."""
    q, pk, pv, rows, ke, ve, spec = _llama2_mixed_one_head("dense")
    rows = [torch.from_numpy(a) for a in rows]
    args = (q, pk, pv, *rows[:3], ke, ve, rows[3])
    kw = dict(spec=spec, kv_heads=1, scale=128**-0.5)
    over, rel = _within_chip_tolerance(_emulate_kernel(*args, **kw, split_p=False),
                                       paged_attention_plain(*args, **kw))
    assert over > 0
