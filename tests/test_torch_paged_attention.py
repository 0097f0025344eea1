"""The plain version of the port's paged-attention kernel against the
reference's Pallas kernel (``repro.kernels.paged_attention``, interpret mode
on the CPU), on the same pools, tables and queries: the mixed geometry (with
budget pads, and a row that has no valid key at all), the decode geometry,
a chunk geometry (Sq > 1), dense and fp4 wire pools, GQA groups G = 1 and 2,
and one sliding-window case. fp32 throughout; tolerance 1e-5 (summation
order only). TF32 is switched off for torch matmuls in this file.
"""
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


def _pools(kv_dim, fmt, seed=0):
    """The same random K/V pools for both frameworks (fp4: the reference
    codec's wire bytes, handed to the port as they are)."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(N_BLOCKS, BS, kv_dim)).astype(np.float32)
    v = rng.normal(size=(N_BLOCKS, BS, kv_dim)).astype(np.float32)
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


def _run_both(q, pools_j, pools_t, specs, tables, hist, q_pos, extras, kv_heads, window):
    (pk_j, pv_j), (pk_t, pv_t) = pools_j, pools_t
    jspec, tspec = specs if specs else (None, None)
    e_j = e_t = (None, None, None)
    if extras is not None:
        ke, ve, te = extras
        e_j = (jnp.asarray(ke), jnp.asarray(ve), jnp.asarray(te))
        e_t = (torch.from_numpy(ke), torch.from_numpy(ve), torch.from_numpy(te))
    ref = pallas_paged_attention(
        jnp.asarray(q), pk_j, pv_j, jnp.asarray(tables), jnp.asarray(hist),
        jnp.asarray(q_pos), *e_j, spec=jspec, kv_heads=kv_heads, scale=HD**-0.5,
        window=window, out_dtype=jnp.float32, interpret=True)
    args = (torch.from_numpy(q), pk_t, pv_t, torch.from_numpy(tables),
            torch.from_numpy(hist), torch.from_numpy(q_pos), *e_t)
    got = paged_attention(*args, spec=tspec, kv_heads=kv_heads, scale=HD**-0.5,
                          window=window)
    # the CPU dispatch IS the plain version
    np.testing.assert_array_equal(
        got.numpy(), paged_attention_plain(*args, spec=tspec, kv_heads=kv_heads,
                                           scale=HD**-0.5, window=window).numpy())
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


def test_row_map_is_not_ported():
    q = torch.zeros(1, 1, 32)
    pool = torch.zeros(2, 16, 32)
    with pytest.raises(NotImplementedError, match="row_map"):
        paged_attention(q, pool, pool, torch.zeros(1, 1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32),
                        row_map=torch.zeros(1, dtype=torch.int32), kv_heads=1, scale=1.0)
