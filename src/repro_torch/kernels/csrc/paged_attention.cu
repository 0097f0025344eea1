// Gather-free paged GQA attention over block-table KV pools, dense or MX
// wire format, with in-step compute-precision K/V extras.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:_kernel
// (wrapper paged_attention). The TPU walked a sequential (rows, blocks) grid
// with the softmax state in VMEM scratch; here each CTA walks block tables
// itself, reading each block id from the table, so no pool[table] gather is
// ever materialized.
//
//   q       (R, Sq, H*hd)            T (fp32 or bf16)
//   pools   dense (n_blocks, bs, kv_dim) P, or MX wire payload
//           (n_blocks, bs, kv_dim*bits/8) + scales (n_blocks, bs, kv_dim/B)
//   tables  (R, nb) int32, hist (R,) int32, q_pos (R, Sq) int32
//   row_map (R,) int32, or null (sequence-sharded pools; see below)
//   extras  k/v (E, kv_dim) T + t_extra (R, E) int32 (optional)
//   out     (R, Sq, H*hd)            T
//
// Row r's query (s, head h = kvh*G + g) attends pool positions t < hist[r],
// t <= q_pos[r, s] (and t > q_pos - window), read at pool precision (a cast,
// or the MX dequantization of mx_common.cuh), plus extra e where
// t_extra[r, e] <= q_pos (and inside the window) in compute precision. The
// softmax is fp32 with the reference's finite -1e30 running-max start, so a
// masked key contributes exactly 0 once any key is valid. A query with no
// valid key at all averages every key its row could address (all nb*bs
// table positions and all E extras) with equal weight, as the reference's
// softmax over all-(-1e30) scores does.
//
// row_map (the TPU kernel's has_row_map=True, index maps :196-207): the
// pools are the virtual pools of core/tp.py pool_exchange (the blocks a
// step's tables name, gathered from the kv ranks in table order), and block
// j of row r is virtual row row_map[r] * nb + j. The kernel computes that
// row itself (BlockMap) and reads no table.
//
// Design. The query vectors (row, s, g) of one kv head are flattened and cut
// into tiles of 64; a tile's vectors split into RUNS of consecutive rows
// that share (tables[r], hist[r]), or (row_map[r], hist[r]) under row_map.
// The mixed step builds tables[slot_ids] (row_map = slot_ids when sharded),
// so the 256 rows of a prefill chunk are one run, and so are a slot's budget
// pads. The runs are found on the device (each row against the one before
// it) and dealt out to the kRunCtas CTAs of the tile (gridDim.z), so the
// single-row runs of decode slots spread over as many SMs. A run's keys are
// its pool positions [t_lo, t_hi) (t_hi = min(hist, largest q_pos + 1),
// t_lo from the window) followed by the E extras; each key tile is staged
// in shared memory ONCE per run (block ids from the table, MX codes
// dequantized once per key, not once per row) and shared by every row of
// the run. A tile of extras that no query vector of the run may see (the
// other slots' columns) is skipped after a look at t_extra alone.
//   * bf16 runs of more than kVecQ vectors: QK^T and PV on the tensor cores
//     (mma.sync m16n8k16 bf16 -> fp32), four warps x 16 query vectors, the
//     online softmax in fp32 registers. P is split into a bf16 hi part and a
//     bf16 lo part (two PV products): rounding P to bf16 alone adds 2^-9
//     relative error per probability, which the output check (one bf16 step
//     of the reference, 2^-7 |ref| + 1e-4) does not leave room for; hi + lo
//     carries P to about 2^-17. Pool values are exact in bf16 (bf16 pools,
//     or MX codes of at most 7 significant bits times a power of two).
//   * fp32 runs of more than kVecQ vectors (and bf16 q over fp32 pools): the
//     same key tiles, fp32 FMAs on the CUDA cores, warps over query vectors.
//     No TF32.
//   * runs of at most kVecQ vectors (decode rows, short pad runs): lanes over
//     keys. Each warp takes chunks of 32 keys, stages them, and each lane
//     computes full dot products of its key with every query vector held in
//     shared memory (no shuffle per key); the four warps' softmax states are
//     merged through shared memory.
//   * a run with a query vector that sees no key computes the mean once (per
//     run and tile), from key tiles staged the same way.
//
// Head dims. Every buffer and register array is sized by the head-dim class
// HD (128: hd 32..128; 256: hd 160..256), a template parameter chosen per
// launch. At HD = 256 the fp32 compute path's vector chunks hold 16 keys per
// warp, not 32 (4 warps x 2 x 32 fp32 rows of 260 would need 266 KB of the
// 227 KB a CTA may have); every variant stays under 205 KB. Any GQA group G
// works: the query vectors of a row straddle 64-vector tiles when 64 is not
// a multiple of G, and each tile's part of a row is a run of its own.
//
// Bound. In the mixed geometry the function's bytes are few (the rows of a
// slot share its history) and its operations are tensor-core work; in the
// decode geometry each slot's history is read once, so bytes bound it (bf16
// 4*hd bytes per key and kv head for K and V, fp4 about hd + hd/16). What is
// left above the bound: key tiles are staged into one buffer (cp.async or
// batched loads, but no TMA and no double buffering, so loads and math do
// not overlap), the decode rows' dot products run on CUDA cores, and each
// decode run is one CTA (no split of a long history across CTAs).
#include <climits>
#include <cstdint>
#include <cstring>

#include "mx_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;      // query vectors per tile; keys per block-path key tile
constexpr int kVecQ = 8;       // runs of at most this many query vectors: vector path
constexpr int kBlkQ = 16;      // query vectors per warp on the block paths
constexpr int kRunCtas = 4;    // CTAs that share one tile's runs (gridDim.z)
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

struct PagedArgs {
  const void* q;
  const void* k_pool;      // dense pool or MX payload
  const void* v_pool;
  const uint8_t* k_scales;  // MX only
  const uint8_t* v_scales;
  const int* tables;        // nullptr under row_map
  const int* row_map;       // nullptr: walk the tables
  const int* hist;
  const int* q_pos;
  const void* k_extra;     // nullptr when E == 0
  const void* v_extra;
  const int* t_extra;
  void* out;
  const float* vals;       // MX code values
  int R, Sq, H, KV, hd, bs, kv_dim, nb, E, n_codes, bits, mx_block, bias, window;
  float scale;
};

// Shared-memory header; the query region and the key/value region follow.
template <int HD>
struct Smem {
  float vals[mxk::kMaxCodes];
  float mean[HD];
  long long qoff[kTile];   // element offset of each query vector in q / out
  int qpos[kTile];
  int qrow[kTile];
  int need[kTile];         // 1: the query vector saw no valid key
  int run[kTile + 1];      // run starts within the tile, then the tile's end
  unsigned bits[2];
  int n_runs;
};
template <int HD>
__host__ __device__ constexpr int header_bytes() {
  return (static_cast<int>(sizeof(Smem<HD>)) + 15) / 16 * 16;
}
template <int HD>
__host__ __device__ constexpr int q_bytes() {  // fp32 [64][hd], or bf16 [64][hd + 8]
  return kTile * HD * 4;
}

template <typename CT>
__host__ __device__ constexpr int row_pad() { return 16 / static_cast<int>(sizeof(CT)); }

// Keys per warp chunk on the vector path: 32 (a key per lane), or 16 for
// fp32 compute at HD = 256, where 32 would not fit in shared memory.
template <typename CT, int HD>
__host__ __device__ constexpr int vec_chunk() { return sizeof(CT) == 4 && HD > 128 ? 16 : 32; }

// Key/value region: 4 warps x (chunk K rows + chunk V rows) on the vector
// path, 64 K rows + 64 V rows on the block paths. Rows are padded by 16
// bytes, so 16-byte accesses to 8 consecutive rows (and ldmatrix) hit
// distinct banks.
template <typename CT, int HD>
constexpr int kv_bytes() {
  const int rows = 2 * kTile > 2 * kWarps * vec_chunk<CT, HD>() ? 2 * kTile
                                                               : 2 * kWarps * vec_chunk<CT, HD>();
  return rows * (HD + row_pad<CT>()) * static_cast<int>(sizeof(CT));
}
template <typename CT, int HD>
constexpr int smem_bytes() { return header_bytes<HD>() + q_bytes<HD>() + kv_bytes<CT, HD>(); }

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool in_window(int t, int qpos, int window) {
  return t <= qpos && (window <= 0 || t > qpos - window);
}

// ------------------------------------------------------------ 8-value moves

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <typename S>
__device__ __forceinline__ void load8(const S* src, float f[8]) {
  if constexpr (sizeof(S) == 4) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    unpack8(*reinterpret_cast<const uint4*>(src), f);
  }
}

template <typename S, typename D>
__device__ __forceinline__ void copy8(const S* src, D* dst) {
  if constexpr (sizeof(S) == sizeof(D)) {
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(src)[0];
    if constexpr (sizeof(S) == 4) reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(src)[1];
  } else {
    float f[8];
    load8(src, f);
    mxk::store8(dst, f);
  }
}

// ---------------------------------------------------------------- staging

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses the registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

template <typename S, typename D>
__device__ __forceinline__ void cp_async8(const S* src, D* dst) {
  cp_async16(dst, src);
  if constexpr (sizeof(S) == 4) cp_async16(dst + 4, src + 4);
}

// One 8-value unit of a key row, as read from device memory.
struct Raw {
  uint4 a, b;
};

// A thread's fixed place in an MX key row, worked out once per staging
// call (no division per unit).
struct MxCol {
  long long pbytes;  // payload bytes per pool row
  int nsc;           // scale bytes per pool row
  int sidx;          // this unit's scale byte, when one scale covers it
  bool one_scale;    // block size a multiple of 8
};

// Read unit ``uu`` (8 values) of key x of one kv head into ``r``, or start
// its cp.async straight into ``dst`` where the type does not change.
template <typename T, typename P, bool MX, typename CT>
__device__ __forceinline__ void load_unit(const PagedArgs& a, const MxCol& mc, bool pool,
                                          long long prow, int e, int col, bool is_v, CT* dst,
                                          Raw& r) {
  if (pool) {
    if constexpr (MX) {
      const uint8_t* pp = static_cast<const uint8_t*>(is_v ? a.v_pool : a.k_pool) + prow * mc.pbytes;
      const uint8_t* sp = (is_v ? a.v_scales : a.k_scales) + prow * mc.nsc;
      const uint64_t word = a.bits == 4
          ? static_cast<uint64_t>(*reinterpret_cast<const uint32_t*>(pp + (col >> 3) * 4))
          : mxk::load_group_word(pp, col >> 3, a.bits);
      r.a.x = static_cast<uint32_t>(word);
      r.a.y = static_cast<uint32_t>(word >> 32);
      if (mc.one_scale) {
        r.a.z = sp[mc.sidx];
      } else {
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lo |= static_cast<uint32_t>(sp[(col + k) / a.mx_block]) << (8 * k);
          hi |= static_cast<uint32_t>(sp[(col + 4 + k) / a.mx_block]) << (8 * k);
        }
        r.b.x = lo;
        r.b.y = hi;
      }
    } else {
      const P* src = static_cast<const P*>(is_v ? a.v_pool : a.k_pool) + prow * a.kv_dim + col;
      if constexpr (sizeof(P) == sizeof(CT)) {
        cp_async8(src, dst);
      } else {
        r.a = reinterpret_cast<const uint4*>(src)[0];
        if constexpr (sizeof(P) == 4) r.b = reinterpret_cast<const uint4*>(src)[1];
      }
    }
  } else {
    const T* src = static_cast<const T*>(is_v ? a.v_extra : a.k_extra) +
                   static_cast<long long>(e) * a.kv_dim + col;
    if constexpr (sizeof(T) == sizeof(CT)) {
      cp_async8(src, dst);
    } else {
      r.a = reinterpret_cast<const uint4*>(src)[0];
      if constexpr (sizeof(T) == 4) r.b = reinterpret_cast<const uint4*>(src)[1];
    }
  }
}

// Finish a unit read by load_unit: decode MX codes or cast into ``dst``.
template <typename T, typename P, bool MX, typename CT>
__device__ __forceinline__ void store_unit(const PagedArgs& a, const MxCol& mc, bool pool,
                                           const Raw& r, const float* s_vals, CT* dst) {
  float f[8];
  if (pool) {
    if constexpr (MX) {
      const uint64_t word = r.a.x | (static_cast<uint64_t>(r.a.y) << 32);
      const uint64_t mask = (1ull << a.bits) - 1ull;
      if (mc.one_scale) {
        const float sc = mxk::scale_value(static_cast<int>(r.a.z) - a.bias);
#pragma unroll
        for (int k = 0; k < 8; ++k) f[k] = s_vals[(word >> (k * a.bits)) & mask] * sc;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t sb = k < 4 ? r.b.x : r.b.y;
          f[k] = s_vals[(word >> (k * a.bits)) & mask] *
                 mxk::scale_value(static_cast<int>((sb >> (8 * (k & 3))) & 0xffu) - a.bias);
        }
      }
      mxk::store8(dst, f);
    } else if constexpr (sizeof(P) != sizeof(CT)) {
      load8(reinterpret_cast<const P*>(&r), f);
      mxk::store8(dst, f);
    }
  } else if constexpr (sizeof(T) != sizeof(CT)) {
    load8(reinterpret_cast<const T*>(&r), f);
    mxk::store8(dst, f);
  }
}

// Block j of a run's rows: their table's entry, or under row_map the
// virtual pool row base + j (base = row_map[r] * nb).
struct BlockMap {
  const int* tbl;  // nullptr under row_map
  int base;
  __device__ __forceinline__ int operator[](int j) const { return tbl ? tbl[j] : base + j; }
};

// Stage keys first .. first+n-1 of one kv head into rows 0..n-1 of sK / sV
// (rows n..nmax-1 zeroed). Key x is pool position x (read through ``tbl``)
// when x < pool_end, else extra x - e_off. Thread tid of nthr owns 8-value
// unit tid % (hd/8) of rows tid / (hd/8), + nthr / (hd/8), ...: neighbouring
// threads on neighbouring addresses, one block-table lookup per row and no
// division per unit. Copies that keep their type go through cp.async; MX
// codes and casts are read kBatch rows at a time (all loads in flight
// before the first store), then decoded into shared memory.
template <typename T, typename P, bool MX, typename CT>
__device__ __forceinline__ void stage(const PagedArgs& a, BlockMap tbl, int kvh, int first, int n,
                                      int nmax, int pool_end, int e_off, CT* sK, CT* sV,
                                      bool want_k, const float* s_vals, int tid, int nthr) {
  constexpr int kBatch = 4;
  const int hd = a.hd, upr = hd >> 3, ld = hd + row_pad<CT>();
  const int rpp = nthr / upr, i0 = tid / upr, uu = tid - i0 * upr;
  if (i0 >= rpp) return;  // hd = 96 leaves a few threads without a unit
  const int col = kvh * hd + uu * 8;
  MxCol mc{0, 0, 0, true};
  if constexpr (MX) {
    mc.pbytes = static_cast<long long>(a.kv_dim) * a.bits / 8;
    mc.nsc = a.kv_dim / a.mx_block;
    mc.one_scale = a.mx_block % 8 == 0;
    mc.sidx = col / a.mx_block;
  }
  const bool pow2 = (a.bs & (a.bs - 1)) == 0;
  const int bs_shift = __ffs(a.bs) - 1;
  for (int ib = i0; ib < nmax; ib += kBatch * rpp) {
    Raw rk[kBatch], rv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = ib + b * rpp;
      if (i < n) {
        const int x = first + i;
        const bool pool = x < pool_end;
        long long prow = 0;
        if (pool) {
          const int blk = pow2 ? tbl[x >> bs_shift] : tbl[x / a.bs];
          prow = static_cast<long long>(blk) * a.bs + (pow2 ? (x & (a.bs - 1)) : x % a.bs);
        }
        if (want_k)
          load_unit<T, P, MX, CT>(a, mc, pool, prow, x - e_off, col, false, sK + i * ld + uu * 8,
                                  rk[b]);
        load_unit<T, P, MX, CT>(a, mc, pool, prow, x - e_off, col, true, sV + i * ld + uu * 8,
                                rv[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = ib + b * rpp;
      if (i >= nmax) break;
      CT* dk = sK + i * ld + uu * 8;
      CT* dv = sV + i * ld + uu * 8;
      if (i >= n) {
        const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (want_k) mxk::store8(dk, z);
        mxk::store8(dv, z);
      } else {
        const bool pool = first + i < pool_end;
        if (want_k) store_unit<T, P, MX, CT>(a, mc, pool, rk[b], s_vals, dk);
        store_unit<T, P, MX, CT>(a, mc, pool, rv[b], s_vals, dv);
      }
    }
  }
  cp_async_wait_all();
}

// -------------------------------------------------- lanes over keys (CUDA cores)

// Fold up to 32 staged keys (lane j's key is row j of Kc / Vc, n of them;
// a lane past n reads row n - 1 and its key is masked by ``bits``)
// into the online softmax of NQ query vectors (fp32, rows of sq; vectors
// past the caller's count have no valid key and are ignored). Bit i of
// ``bits`` says whether this lane's key is valid for vector i. l is kept per
// lane (summed over the warp at the end); m is warp-uniform. Each lane owns
// head dims [lane*hpl, lane*hpl + hpl) of acc. No warp-collective operation
// sits under a condition: a guarded shuffle costs a convergence barrier per
// key. A vector with no valid key here keeps its state (alpha = 1, p = 0).
template <int NQ, int HD, typename CT>
__device__ __forceinline__ void vec_update(const CT* Kc, const CT* Vc, int ld, int n,
                                           uint32_t bits, const float* sq, int hd, float scale,
                                           float m[NQ], float l[NQ], float acc[NQ][HD / 32]) {
  constexpr int kMaxHpl = HD / 32;
  const int lane = threadIdx.x & 31, hpl = hd >> 5;
  float s[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) s[i] = 0.f;
  const CT* kr = Kc + min(lane, n - 1) * ld;
  for (int d = 0; d < hd; d += 8) {
    float k8[8];
    load8(kr + d, k8);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float4 qa = *reinterpret_cast<const float4*>(sq + i * hd + d);
      const float4 qb = *reinterpret_cast<const float4*>(sq + i * hd + d + 4);
      float t = s[i];
      t = fmaf(qa.x, k8[0], t); t = fmaf(qa.y, k8[1], t);
      t = fmaf(qa.z, k8[2], t); t = fmaf(qa.w, k8[3], t);
      t = fmaf(qb.x, k8[4], t); t = fmaf(qb.y, k8[5], t);
      t = fmaf(qb.z, k8[6], t); t = fmaf(qb.w, k8[7], t);
      s[i] = t;
    }
  }
  float p[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const float sc = ((bits >> i) & 1u) ? s[i] * scale : neg_inf();
    const float m_new = fmaxf(m[i], warp_max(sc));
    const float alpha = expf(m[i] - m_new);
    p[i] = expf(sc - m_new);
    l[i] = l[i] * alpha + p[i];
#pragma unroll
    for (int dd = 0; dd < kMaxHpl; ++dd) acc[i][dd] *= alpha;
    m[i] = m_new;
  }
  for (int j = 0; j < n; ++j) {
    float v[kMaxHpl];
    const CT* vr = Vc + j * ld + lane * hpl;
    if (hpl == kMaxHpl) {  // hd = HD: one 8- or 16-byte read, or (hd 256) 8 values
      if constexpr (kMaxHpl == 8) {
        load8(vr, v);
      } else if constexpr (sizeof(CT) == 2) {
        const uint2 u = *reinterpret_cast<const uint2*>(vr);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
      } else {
        const float4 f = *reinterpret_cast<const float4*>(vr);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      }
    } else {
#pragma unroll
      for (int dd = 0; dd < kMaxHpl; ++dd) v[dd] = dd < hpl ? mxk::to_float(vr[dd]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
      for (int dd = 0; dd < kMaxHpl; ++dd) acc[i][dd] = fmaf(pj, v[dd], acc[i][dd]);
    }
  }
}

// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// Split two fp32 probabilities into bf16 hi and lo parts (x ~ hi + lo).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// --------------------------------------------------------------- the runs

struct Run {
  BlockMap tbl;
  int M;          // query vectors in the run (this tile's part of it)
  int t_lo, t_hi; // pool positions that any of them may see
};

// Runs of at most NQ <= kVecQ query vectors: warps take chunks of
// vec_chunk keys in turn. NQ is fixed at compile time (1 for a decode row, else kVecQ), so no
// loop over vectors carries a guard.
template <int NQ, int HD, typename T, typename P, bool MX, typename CT>
__device__ void vector_run(const PagedArgs& a, Smem<HD>& sm, float* sq, CT* kv, const Run& run,
                           int kvh) {
  constexpr int kMaxHpl = HD / 32, kChunk = vec_chunk<CT, HD>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = a.hd, hpl = hd >> 5, ld = hd + row_pad<CT>(), M = run.M;
  const T* q = static_cast<const T*>(a.q);
  for (int idx = tid; idx < M * hd; idx += kThreads) {
    const int i = idx / hd, d = idx - i * hd;
    sq[idx] = mxk::to_float(q[sm.qoff[i] + d]);
  }
  __syncthreads();

  float m[NQ], l[NQ], acc[NQ][kMaxHpl];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kMaxHpl; ++dd) acc[i][dd] = 0.f;
  }
  CT* wK = kv + warp * 2 * kChunk * ld;
  CT* wV = wK + kChunk * ld;
  const int np = max(0, run.t_hi - run.t_lo);
  const int ncp = (np + kChunk - 1) / kChunk, nce = (a.E + kChunk - 1) / kChunk;
  for (int c = warp; c < ncp + nce; c += kWarps) {
    const bool pool = c < ncp;
    const int first = pool ? run.t_lo + c * kChunk : (c - ncp) * kChunk;
    const int n = pool ? min(kChunk, run.t_hi - first) : min(kChunk, a.E - first);
    // this lane's key against every vector (t_extra read at clamped
    // indices, so the loads carry no condition and overlap)
    const int x = first + min(lane, n - 1);
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int qi = min(i, M - 1);
      const int t = pool ? x : a.t_extra[static_cast<long long>(sm.qrow[qi]) * a.E + x];
      if (i < M && lane < n && in_window(t, sm.qpos[qi], a.window)) bits |= 1u << i;
    }
    if (__ballot_sync(0xffffffffu, bits != 0) == 0) continue;  // nobody sees this chunk
    __syncwarp();  // the previous chunk's reads of wK / wV are done
    stage<T, P, MX, CT>(a, run.tbl, kvh, first, n, kChunk, pool ? INT_MAX : INT_MIN, 0, wK, wV,
                        true, sm.vals, lane, 32);
    __syncwarp();
    vec_update<NQ, HD, CT>(wK, wV, ld, n, bits, sq, hd, a.scale, m, l, acc);
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) l[i] = warp_sum(l[i]);

  // merge the four warps' states (the staging region is reused)
  __syncthreads();
  float* s_m = reinterpret_cast<float*>(kv);
  float* s_l = s_m + kWarps * kVecQ;
  float* s_acc = s_l + kWarps * kVecQ;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      s_m[warp * kVecQ + i] = m[i];
      s_l[warp * kVecQ + i] = l[i];
    }
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int dd = 0; dd < kMaxHpl; ++dd)
      if (i < M && dd < hpl) s_acc[(warp * kVecQ + i) * HD + lane * hpl + dd] = acc[i][dd];
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int idx = tid; idx < M * hd; idx += kThreads) {
    const int i = idx / hd, d = idx - i * hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * kVecQ + i]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w * kVecQ + i] - mx);
      L += s_l[w * kVecQ + i] * c;
      A += s_acc[(w * kVecQ + i) * HD + d] * c;
    }
    if (L > 0.f)
      out[sm.qoff[i] + d] = mxk::from_float<T>(A / L);
    else
      sm.need[i] = 1;
  }
}

// Runs of more than kVecQ query vectors: 64-key tiles staged by the whole
// CTA, shared by every vector of the run. bf16: tensor cores, warp w owns
// vectors [16w, 16w + 16). fp32: CUDA cores, the same split.
template <int HD, typename T, typename P, bool MX, typename CT>
__device__ void block_run(const PagedArgs& a, Smem<HD>& sm, unsigned char* qreg, CT* kv,
                          const Run& run, int kvh) {
  constexpr bool kMma = sizeof(CT) == 2;
  constexpr int kMaxHpl = HD / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = a.hd, hpl = hd >> 5, ld = hd + row_pad<CT>(), M = run.M;
  const int g = lane >> 2, tq = lane & 3;   // mma fragment row group / column pair
  const int m0 = warp * kBlkQ;              // this warp's first query vector
  const int nq = max(0, min(kBlkQ, M - m0));
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  CT* sK = kv;
  CT* sV = kv + kTile * ld;

  // stage the run's queries: bf16 [64][hd + 8] for ldmatrix, or fp32 [M][hd]
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(qreg);
  float* sq = reinterpret_cast<float*>(qreg);
  if constexpr (kMma) {
    const int upr = hd >> 3, ldq = hd + 8;
    for (int w = tid; w < kTile * upr; w += kThreads) {
      const int i = w / upr, uu = w - i * upr;
      if (i < M)
        copy8(q + sm.qoff[i] + uu * 8, sQ + i * ldq + uu * 8);
      else
        *reinterpret_cast<uint4*>(sQ + i * ldq + uu * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int idx = tid; idx < M * hd; idx += kThreads) {
      const int i = idx / hd, d = idx - i * hd;
      sq[idx] = mxk::to_float(q[sm.qoff[i] + d]);
    }
  }

  // softmax state. mma: rows g and g + 8 of the warp's 16, head dims in
  // 8-wide n-tiles. fp32: vectors m0 + i, lane dims.
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  float oacc[HD / 8][4];
  float m[kBlkQ], l[kBlkQ], acc[kBlkQ][kMaxHpl];
  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < kBlkQ; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int dd = 0; dd < kMaxHpl; ++dd) acc[i][dd] = 0.f;
    }
  }
  // per-thread query rows for the mask
  const int qi0 = m0 + g, qi1 = m0 + g + 8;
  const int qp0 = qi0 < M ? sm.qpos[qi0] : INT_MIN, qp1 = qi1 < M ? sm.qpos[qi1] : INT_MIN;
  const long long tr0 = static_cast<long long>(sm.qrow[min(qi0, M - 1)]) * a.E;
  const long long tr1 = static_cast<long long>(sm.qrow[min(qi1, M - 1)]) * a.E;

  const int np = max(0, run.t_hi - run.t_lo);
  const int ntp = (np + kTile - 1) / kTile, nte = (a.E + kTile - 1) / kTile;
  for (int c = 0; c < ntp + nte; ++c) {
    const bool pool = c < ntp;
    const int first = pool ? run.t_lo + c * kTile : (c - ntp) * kTile;
    const int n = pool ? min(kTile, run.t_hi - first) : min(kTile, a.E - first);
    // which (vector, key) pairs of this tile are valid for this thread; the
    // key positions are read first, at clamped indices and without a
    // condition, so the loads overlap
    uint32_t bits = 0;
    if constexpr (kMma) {
      // bit c of each half: key 8*(c/2) + 2*tq + c%2; low half row g, high g + 8
      int t0[16], t1[16];
#pragma unroll
      for (int c2 = 0; c2 < 16; ++c2) {
        const int x = first + min(8 * (c2 >> 1) + 2 * tq + (c2 & 1), n - 1);
        t0[c2] = pool ? x : a.t_extra[tr0 + x];
        t1[c2] = pool ? x : a.t_extra[tr1 + x];
      }
#pragma unroll
      for (int c2 = 0; c2 < 16; ++c2) {
        const bool in_tile = 8 * (c2 >> 1) + 2 * tq + (c2 & 1) < n;
        if (in_tile && qi0 < M && in_window(t0[c2], qp0, a.window)) bits |= 1u << c2;
        if (in_tile && qi1 < M && in_window(t1[c2], qp1, a.window)) bits |= 1u << (16 + c2);
      }
    } else if (nq > 0) {
      // bit h*16 + i: key 32*h + lane for vector m0 + i
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * 32 + lane;
        const int x = first + min(col, n - 1);
        int t[kBlkQ];
#pragma unroll
        for (int i = 0; i < kBlkQ; ++i)
          t[i] = pool ? x : a.t_extra[static_cast<long long>(sm.qrow[m0 + min(i, nq - 1)]) * a.E + x];
#pragma unroll
        for (int i = 0; i < kBlkQ; ++i)
          if (col < n && i < nq && in_window(t[i], sm.qpos[m0 + i], a.window))
            bits |= 1u << (h * 16 + i);
      }
    }
    // also the barrier that frees sK / sV (and, at c == 0, publishes sQ)
    if (!__syncthreads_or(bits != 0)) continue;
    stage<T, P, MX, CT>(a, run.tbl, kvh, first, n, kTile, pool ? INT_MAX : INT_MIN, 0, sK, sV,
                        true, sm.vals, tid, kThreads);
    __syncthreads();
    if (!__any_sync(0xffffffffu, bits != 0)) continue;  // nothing for this warp's vectors

    if constexpr (kMma) {
      const int ldq = hd + 8;
      // S = Q K^T: 16 vectors x 64 keys per warp
      float sacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if (kk * 16 >= hd) break;
        uint32_t af[4];
        ldsm_x4(af, sQ + (m0 + (lane & 15)) * ldq + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp * 16 >= n) break;
          uint32_t bf[4];
          ldsm_x4(bf, sK + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * ld + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma16816(sacc[2 * jp], af, bf[0], bf[1]);
          mma16816(sacc[2 * jp + 1], af, bf[2], bf[3]);
        }
      }
      // scale, mask, online softmax (rows g and g + 8; a row's 64 keys are
      // spread over the 4 threads of a quad)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = neg_inf();
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = (bits >> (16 * h + 2 * j + e)) & 1u;
            const float s = ok ? sacc[j][2 * h + e] * a.scale : neg_inf();
            sacc[j][2 * h + e] = s;
            mx = fmaxf(mx, s);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mrow[h], mx);
        const float alpha = expf(mrow[h] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(sacc[j][2 * h + e] - m_new);
            sacc[j][2 * h + e] = p;
            ps += p;
          }
        lrow[h] = lrow[h] * alpha + ps;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          oacc[j][2 * h] *= alpha;
          oacc[j][2 * h + 1] *= alpha;
        }
        mrow[h] = m_new;
      }
      // O += P V with P = hi + lo (two bf16 products)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (kk * 16 >= n) break;
        uint32_t ah[4], al[4];
        split2(sacc[2 * kk][0], sacc[2 * kk][1], ah[0], al[0]);
        split2(sacc[2 * kk][2], sacc[2 * kk][3], ah[1], al[1]);
        split2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ah[2], al[2]);
        split2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          if (dp * 16 >= hd) break;
          uint32_t bf[4];
          ldsm_x4_t(bf, sV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + dp * 16 +
                            (lane >> 4) * 8);
          mma16816(oacc[2 * dp], ah, bf[0], bf[1]);
          mma16816(oacc[2 * dp], al, bf[0], bf[1]);
          mma16816(oacc[2 * dp + 1], ah, bf[2], bf[3]);
          mma16816(oacc[2 * dp + 1], al, bf[2], bf[3]);
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nh = min(32, n - 32 * h);
        if (nh <= 0 || nq == 0) continue;
        vec_update<kBlkQ, HD, CT>(sK + 32 * h * ld, sV + 32 * h * ld, ld, nh,
                              (bits >> (16 * h)) & 0xffffu, sq + m0 * hd, hd, a.scale, m, l, acc);
      }
    }
  }

  // write what has a valid key; flag the rest for the mean
  if constexpr (kMma) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float L = lrow[h];
      L += __shfl_xor_sync(0xffffffffu, L, 1);
      L += __shfl_xor_sync(0xffffffffu, L, 2);
      const int qi = h ? qi1 : qi0;
      if (qi >= M) continue;
      if (L > 0.f) {
        const float inv = 1.f / L;
        T* orow = out + sm.qoff[qi];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          if (j * 8 >= hd) break;
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * tq) =
              __floats2bfloat162_rn(oacc[j][2 * h] * inv, oacc[j][2 * h + 1] * inv);
        }
      } else if (tq == 0) {
        sm.need[qi] = 1;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBlkQ; ++i) {
      if (i >= nq) continue;
      const float L = warp_sum(l[i]);
      if (L > 0.f) {
        T* orow = out + sm.qoff[m0 + i] + lane * hpl;
#pragma unroll
        for (int dd = 0; dd < kMaxHpl; ++dd)
          if (dd < hpl) orow[dd] = mxk::from_float<T>(acc[i][dd] / L);
      } else if (lane == 0) {
        sm.need[m0 + i] = 1;
      }
    }
  }
}

template <int HD, typename T, typename P, bool MX, typename CT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(PagedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  unsigned char* qreg = smem_raw + header_bytes<HD>();
  CT* kv = reinterpret_cast<CT*>(qreg + q_bytes<HD>());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.y;
  const int G = a.H / a.KV, SqG = a.Sq * G;
  const long long U = static_cast<long long>(a.R) * SqG;
  const long long u0 = static_cast<long long>(blockIdx.x) * kTile;
  const int nu = static_cast<int>(min(static_cast<long long>(kTile), U - u0));
  const int cap = a.nb * a.bs;

  if (MX)
    for (int i = tid; i < a.n_codes; i += kThreads) sm.vals[i] = a.vals[i];

  // runs: a query vector starts one where its row addresses other keys than
  // the row before it (another table row or history), or at the tile's
  // start. Two threads compare each row of the tile with the one before,
  // entries strided by 2, loads in flight together; sm.need holds the flags.
  const int r_first = static_cast<int>(u0 / SqG);
  const int n_rows = static_cast<int>((u0 + nu - 1) / SqG) - r_first + 1;  // <= 64
  if (tid < kTile) sm.need[tid] = 0;
  __syncthreads();
  {
    const int pr = (tid >> 1) + 1, half = tid & 1;
    int d = 0;
    if (pr < n_rows) {
      const int r = r_first + pr;
      d = half == 0 && a.hist[r] != a.hist[r - 1];
      if (a.row_map) {
        d |= half == 0 && a.row_map[r] != a.row_map[r - 1];
      } else {
        const int* t0 = a.tables + static_cast<long long>(r) * a.nb;
        const int* t1 = t0 - a.nb;
#pragma unroll 4
        for (int k = half; k < a.nb; k += 2) d |= t0[k] != t1[k];
      }
    }
    d |= __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0 && pr < n_rows) sm.need[pr] = d;
  }
  __syncthreads();
  if (warp < 2) {
    bool start = false;
    if (tid < nu) {
      const long long u = u0 + tid;
      const int r = static_cast<int>(u / SqG);
      start = tid == 0 || (r != static_cast<int>((u - 1) / SqG) && sm.need[r - r_first]);
    }
    const unsigned b = __ballot_sync(0xffffffffu, start);
    if (lane == 0) sm.bits[warp] = b;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < nu; ++i)
      if ((sm.bits[i >> 5] >> (i & 31)) & 1u) sm.run[n++] = i;
    sm.run[n] = nu;
    sm.n_runs = n;
  }
  __syncthreads();
  const int n_runs = sm.n_runs;

  for (int k = blockIdx.z; k < n_runs; k += gridDim.z) {
    const int i0 = sm.run[k], M = sm.run[k + 1] - i0;
    __syncthreads();  // the previous run is done with the per-vector arrays
    if (tid < M) {
      const long long u = u0 + i0 + tid;
      const int r = static_cast<int>(u / SqG), s = static_cast<int>((u / G) % a.Sq);
      const int gg = static_cast<int>(u % G);
      sm.qrow[tid] = r;
      sm.qpos[tid] = a.q_pos[static_cast<long long>(r) * a.Sq + s];
      sm.qoff[tid] = ((static_cast<long long>(r) * a.Sq + s) * a.H + kvh * G + gg) * a.hd;
      sm.need[tid] = 0;
    }
    __syncthreads();
    Run run;
    const int r0 = sm.qrow[0];
    run.tbl = a.row_map ? BlockMap{nullptr, a.row_map[r0] * a.nb}
                        : BlockMap{a.tables + static_cast<long long>(r0) * a.nb, 0};
    run.M = M;
    int maxq = INT_MIN, minq = INT_MAX;
    for (int i = 0; i < M; ++i) {
      maxq = max(maxq, sm.qpos[i]);
      minq = min(minq, sm.qpos[i]);
    }
    const int hist = max(0, min(a.hist[r0], cap));
    run.t_hi = max(0, maxq >= hist ? hist : maxq + 1);
    run.t_lo = a.window > 0 ? max(0, minq - a.window + 1) : 0;

    if (M == 1)
      vector_run<1, HD, T, P, MX, CT>(a, sm, reinterpret_cast<float*>(qreg), kv, run, kvh);
    else if (M <= kVecQ)
      vector_run<kVecQ, HD, T, P, MX, CT>(a, sm, reinterpret_cast<float*>(qreg), kv, run, kvh);
    else
      block_run<HD, T, P, MX, CT>(a, sm, qreg, kv, run, kvh);
    __syncthreads();

    // vectors with no valid key: the mean of every key the run's rows address
    const int need = tid < M ? sm.need[tid] : 0;
    if (__syncthreads_or(need)) {
      CT* sV = kv + kTile * (a.hd + row_pad<CT>());
      const int ld = a.hd + row_pad<CT>();
      constexpr int kDims = (HD + kThreads - 1) / kThreads;  // head dims per thread
      float sum[kDims];
#pragma unroll
      for (int j = 0; j < kDims; ++j) sum[j] = 0.f;
      for (int kb = 0; kb < cap + a.E; kb += kTile) {
        const int n = min(kTile, cap + a.E - kb);
        stage<T, P, MX, CT>(a, run.tbl, kvh, kb, n, kTile, cap, cap, kv, sV, false, sm.vals, tid,
                            kThreads);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kDims; ++j) {
          const int d = tid + j * kThreads;
          if (d < a.hd)
            for (int i = 0; i < n; ++i) sum[j] += mxk::to_float(sV[i * ld + d]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const int d = tid + j * kThreads;
        if (d < a.hd) sm.mean[d] = sum[j] / static_cast<float>(cap + a.E);
      }
      __syncthreads();
      T* out = static_cast<T*>(a.out);
      for (int idx = tid; idx < M * a.hd; idx += kThreads) {
        const int i = idx / a.hd, d = idx - i * a.hd;
        if (sm.need[i]) out[sm.qoff[i] + d] = mxk::from_float<T>(sm.mean[d]);
      }
    }
  }
}

template <int HD, typename T, typename P, bool MX, typename CT>
cudaError_t launch_hd(const PagedArgs& a, cudaStream_t s) {
  constexpr int smem = smem_bytes<CT, HD>();
  static_assert(smem <= 232448, "over the 227 KB of shared memory a CTA may have");
  auto kern = paged_attention_kernel<HD, T, P, MX, CT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long U = static_cast<long long>(a.R) * a.Sq * (a.H / a.KV);
  const dim3 grid(static_cast<unsigned>((U + kTile - 1) / kTile), a.KV, kRunCtas);
  kern<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The head-dim class: hd 32..128 (multiples of 32) or 160..256.
template <typename T, typename P, bool MX, typename CT>
cudaError_t launch(const PagedArgs& a, cudaStream_t s) {
  if (a.hd <= 0 || a.hd % 32 != 0 || a.hd > 256) return cudaErrorInvalidValue;
  return a.hd <= 128 ? launch_hd<128, T, P, MX, CT>(a, s) : launch_hd<256, T, P, MX, CT>(a, s);
}

}  // namespace

// pool_kind: 0 dense fp32, 1 dense bf16, 2 MX wire (payload + scales).
// window <= 0: no sliding window. E == 0: no extras. row_map null: walk
// tables; else tables is not read.
extern "C" int mxk_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
    const void* v_scales, const void* tables, const void* row_map, const void* hist,
    const void* q_pos, const void* k_extra, const void* v_extra, const void* t_extra, void* out,
    const float* vals,
    int R, int Sq, int H, int KV, int hd, int bs, int kv_dim, int nb, int E, int n_codes,
    int bits, int mx_block, int bias, int window, float scale, int q_is_bf16, int pool_kind,
    void* stream) {
  PagedArgs a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scales = static_cast<const uint8_t*>(k_scales);
  a.v_scales = static_cast<const uint8_t*>(v_scales);
  a.tables = static_cast<const int*>(tables);
  a.row_map = static_cast<const int*>(row_map);
  a.hist = static_cast<const int*>(hist);
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_extra = k_extra;
  a.v_extra = v_extra;
  a.t_extra = static_cast<const int*>(t_extra);
  a.out = out;
  a.vals = vals;
  a.R = R; a.Sq = Sq; a.H = H; a.KV = KV; a.hd = hd; a.bs = bs; a.kv_dim = kv_dim; a.nb = nb;
  a.E = E; a.n_codes = n_codes; a.bits = bits; a.mx_block = mx_block; a.bias = bias;
  a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (q_is_bf16) {
    // bf16 and MX pool values are exact in bf16: tensor cores; fp32 pools are not
    switch (pool_kind) {
      case 0: err = launch<bf16, float, false, float>(a, s); break;
      case 1: err = launch<bf16, bf16, false, bf16>(a, s); break;
      default: err = launch<bf16, float, true, bf16>(a, s); break;
    }
  } else {
    switch (pool_kind) {
      case 0: err = launch<float, float, false, float>(a, s); break;
      case 1: err = launch<float, bf16, false, float>(a, s); break;
      default: err = launch<float, float, true, float>(a, s); break;
    }
  }
  return static_cast<int>(err);
}
