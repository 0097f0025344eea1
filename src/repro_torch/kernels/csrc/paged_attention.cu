// Gather-free paged GQA attention over block-table KV pools, dense or MX
// wire format, with in-step compute-precision K/V extras.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:_kernel
// (wrapper paged_attention). The TPU walked a sequential (rows, blocks) grid
// with the softmax state in VMEM scratch; here one CTA owns one (row, kv
// head) pair and walks the row's block table itself, reading each block id
// from the table, so no pool[table] gather is ever materialized.
//
//   q       (R, Sq, H*hd)            T (fp32 or bf16)
//   pools   dense (n_blocks, bs, kv_dim) P, or MX wire payload
//           (n_blocks, bs, kv_dim*bits/8) + scales (n_blocks, bs, kv_dim/B)
//   tables  (R, nb) int32, hist (R,) int32, q_pos (R, Sq) int32
//   extras  k/v (E, kv_dim) T + t_extra (R, E) int32 (optional)
//   out     (R, Sq, H*hd)            T
//
// Row r's query (s, head h = kvh*G + g) attends pool positions t < hist[r],
// t <= q_pos[r, s] (and t > q_pos - window), read at pool precision (a cast,
// or the MX dequantization of mx_common.cuh done in registers), plus extra
// e where t_extra[r, e] <= q_pos (and inside the window) in compute
// precision. The four warps of the CTA split the keys (position t goes to
// warp t % 4), each keeps an fp32 online softmax per query vector (up to 8
// query vectors per pass: the G heads of the group times Sq), and the warps'
// states are merged through shared memory at the end. Masked keys are
// skipped, which is exact: with the running max initialised at the finite
// -1e30 of the reference, a masked key contributes exp(-1e30 - m) = 0 once
// any key is valid. A query with no valid key at all averages every key it
// could address (all nb*bs table positions and all E extras) with equal
// weight, as the reference's online softmax over all-(-1e30) scores does.
//
// Bound: in the decode geometry, bytes (each row streams its own history
// once: dense bf16 4*hd bytes per key and head, fp4 about hd). In the mixed
// geometry the rows of one slot's prefill chunk share their history, so
// the function's bytes are few and its operations (4*hd per query head and
// valid key) bound it. The design keeps scores and probabilities in
// registers, reads each key once per CTA with neighbouring lanes on
// neighbouring addresses, and leaves the tensor cores unused: a CTA per row
// re-reads the shared history from L2 (a later PR's work: tile the rows of
// one slot through wgmma).
#include <climits>

#include "mx_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxQ = 8;     // query vectors per pass
constexpr int kMaxHpl = 4;   // head_dim / 32 <= 4, i.e. head_dim <= 128
constexpr float kNegInf = -1e30f;

struct PagedArgs {
  const void* q;
  const void* k_pool;      // dense pool or MX payload
  const void* v_pool;
  const uint8_t* k_scales;  // MX only
  const uint8_t* v_scales;
  const int* tables;
  const int* hist;
  const int* q_pos;
  const void* k_extra;     // nullptr when E == 0
  const void* v_extra;
  const int* t_extra;
  void* out;
  const float* vals;       // MX code values
  int Sq, H, KV, hd, bs, kv_dim, nb, E, n_codes, bits, mx_block, bias, window;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This lane's hpl elements of K and V at pool row ``row`` (= blk*bs + off).
template <typename P, bool MX>
__device__ __forceinline__ void load_pool(const PagedArgs& a, long long row, int col0, int hpl,
                                          const float* s_vals, float k[kMaxHpl],
                                          float v[kMaxHpl]) {
  if constexpr (MX) {
    const long long pbytes = static_cast<long long>(a.kv_dim) * a.bits / 8;
    const long long nsc = a.kv_dim / a.mx_block;
    const uint8_t* kp = static_cast<const uint8_t*>(a.k_pool) + row * pbytes;
    const uint8_t* vp = static_cast<const uint8_t*>(a.v_pool) + row * pbytes;
#pragma unroll
    for (int d = 0; d < kMaxHpl; ++d) {
      if (d < hpl) {
        const int i = col0 + d;
        const long long si = row * nsc + i / a.mx_block;
        k[d] = s_vals[mxk::code_at(kp, i, a.bits)] * mxk::scale_value(a.k_scales[si] - a.bias);
        v[d] = s_vals[mxk::code_at(vp, i, a.bits)] * mxk::scale_value(a.v_scales[si] - a.bias);
      }
    }
  } else {
    const P* kp = static_cast<const P*>(a.k_pool) + row * a.kv_dim + col0;
    const P* vp = static_cast<const P*>(a.v_pool) + row * a.kv_dim + col0;
#pragma unroll
    for (int d = 0; d < kMaxHpl; ++d) {
      if (d < hpl) {
        k[d] = mxk::to_float(kp[d]);
        v[d] = mxk::to_float(vp[d]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_extra(const PagedArgs& a, int e, int col0, int hpl,
                                           float k[kMaxHpl], float v[kMaxHpl]) {
  const T* kp = static_cast<const T*>(a.k_extra) + static_cast<long long>(e) * a.kv_dim + col0;
  const T* vp = static_cast<const T*>(a.v_extra) + static_cast<long long>(e) * a.kv_dim + col0;
#pragma unroll
  for (int d = 0; d < kMaxHpl; ++d) {
    if (d < hpl) {
      k[d] = mxk::to_float(kp[d]);
      v[d] = mxk::to_float(vp[d]);
    }
  }
}

__device__ __forceinline__ bool in_window(int t, int qpos, int window) {
  return t <= qpos && (window <= 0 || t > qpos - window);
}

// Fold one key (k, v at lane elements) into the online softmax of every
// query vector j < nq for which ``valid(j)``.
template <typename Valid>
__device__ __forceinline__ void accumulate(const float q[kMaxQ][kMaxHpl], const float k[kMaxHpl],
                                           const float v[kMaxHpl], int nq, int hpl, float scale,
                                           Valid valid, float m[kMaxQ], float l[kMaxQ],
                                           float acc[kMaxQ][kMaxHpl]) {
#pragma unroll
  for (int j = 0; j < kMaxQ; ++j) {
    if (j >= nq) break;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < kMaxHpl; ++d)
      if (d < hpl) dot += q[j][d] * k[d];
    dot = warp_sum(dot);
    if (!valid(j)) continue;
    const float s = dot * scale;
    const float m_new = fmaxf(m[j], s);
    const float alpha = expf(m[j] - m_new);
    const float p = expf(s - m_new);
    l[j] = l[j] * alpha + p;
#pragma unroll
    for (int d = 0; d < kMaxHpl; ++d)
      if (d < hpl) acc[j][d] = acc[j][d] * alpha + p * v[d];
    m[j] = m_new;
  }
}

template <typename T, typename P, bool MX>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(PagedArgs a) {
  const int r = blockIdx.x, kvh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.H / a.KV, hpl = a.hd / 32, n_qvec = a.Sq * G;
  const int col0 = kvh * a.hd + lane * hpl;  // this lane's first K/V column
  const int cap = a.nb * a.bs;

  __shared__ float s_vals[mxk::kMaxCodes];
  __shared__ float s_m[kWarps][kMaxQ], s_l[kWarps][kMaxQ];
  __shared__ float s_acc[kWarps][kMaxQ][kMaxHpl * 32];
  __shared__ float s_mean[kMaxHpl * 32];
  __shared__ int s_need_mean;
  if (MX)
    for (int i = threadIdx.x; i < a.n_codes; i += blockDim.x) s_vals[i] = a.vals[i];

  const int* tbl = a.tables + static_cast<long long>(r) * a.nb;
  const int hist = min(a.hist[r], cap);
  const T* qrow = static_cast<const T*>(a.q) + static_cast<long long>(r) * a.Sq * a.H * a.hd;
  T* orow = static_cast<T*>(a.out) + static_cast<long long>(r) * a.Sq * a.H * a.hd;

  for (int q0 = 0; q0 < n_qvec; q0 += kMaxQ) {
    const int nq = min(kMaxQ, n_qvec - q0);
    float q[kMaxQ][kMaxHpl], acc[kMaxQ][kMaxHpl], m[kMaxQ], l[kMaxQ];
    int qpos[kMaxQ];
    int qpos_max = INT_MIN;
#pragma unroll
    for (int j = 0; j < kMaxQ; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
      qpos[j] = INT_MIN;
#pragma unroll
      for (int d = 0; d < kMaxHpl; ++d) q[j][d] = acc[j][d] = 0.f;
      if (j < nq) {
        const int qi = q0 + j, s = qi / G, h = kvh * G + qi % G;
        qpos[j] = a.q_pos[static_cast<long long>(r) * a.Sq + s];
        qpos_max = max(qpos_max, qpos[j]);
        const T* qp = qrow + (static_cast<long long>(s) * a.H + h) * a.hd + lane * hpl;
#pragma unroll
        for (int d = 0; d < kMaxHpl; ++d)
          if (d < hpl) q[j][d] = mxk::to_float(qp[d]);
      }
    }
    __syncthreads();  // s_vals staged; s_acc free from the previous pass

    // pool history: only positions below hist and at most the latest query
    // position can be valid
    const int t_end = qpos_max == INT_MIN ? 0 : min(hist, qpos_max + 1);
    for (int t = warp; t < t_end; t += kWarps) {
      const long long row = static_cast<long long>(tbl[t / a.bs]) * a.bs + t % a.bs;
      float k[kMaxHpl], v[kMaxHpl];
      load_pool<P, MX>(a, row, col0, hpl, s_vals, k, v);
      accumulate(q, k, v, nq, hpl, a.scale,
                 [&](int j) { return in_window(t, qpos[j], a.window); }, m, l, acc);
    }
    // in-step extras, compute precision
    for (int e = warp; e < a.E; e += kWarps) {
      const int te = a.t_extra[static_cast<long long>(r) * a.E + e];
      if (te > qpos_max) continue;  // masked for every query vector
      float k[kMaxHpl], v[kMaxHpl];
      load_extra<T>(a, e, col0, hpl, k, v);
      accumulate(q, k, v, nq, hpl, a.scale,
                 [&](int j) { return in_window(te, qpos[j], a.window); }, m, l, acc);
    }

    // merge the four warps' softmax states
    if (lane == 0)
      for (int j = 0; j < kMaxQ; ++j) {
        s_m[warp][j] = m[j];
        s_l[warp][j] = l[j];
      }
#pragma unroll
    for (int j = 0; j < kMaxQ; ++j)
#pragma unroll
      for (int d = 0; d < kMaxHpl; ++d)
        if (d < hpl) s_acc[warp][j][lane * hpl + d] = acc[j][d];
    if (threadIdx.x == 0) s_need_mean = 0;
    __syncthreads();

    for (int idx = threadIdx.x; idx < nq * a.hd; idx += blockDim.x) {
      const int j = idx / a.hd, dd = idx % a.hd;
      float mx = kNegInf;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][j]);
      float L = 0.f, A = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(s_m[w][j] - mx);
        L += s_l[w][j] * c;
        A += s_acc[w][j][dd] * c;
      }
      if (L > 0.f) {
        const int qi = q0 + j, s = qi / G, h = kvh * G + qi % G;
        orow[(static_cast<long long>(s) * a.H + h) * a.hd + dd] = mxk::from_float<T>(A / L);
      } else {
        s_need_mean = 1;
      }
    }
    __syncthreads();

    if (s_need_mean) {
      // no valid key for some query vector: equal weights over every key
      // the row addresses (the reference's all-masked softmax)
      float sum[kMaxHpl] = {0.f, 0.f, 0.f, 0.f};
      for (int t = warp; t < cap + a.E; t += kWarps) {
        float k[kMaxHpl], v[kMaxHpl];
        if (t < cap)
          load_pool<P, MX>(a, static_cast<long long>(tbl[t / a.bs]) * a.bs + t % a.bs, col0,
                           hpl, s_vals, k, v);
        else
          load_extra<T>(a, t - cap, col0, hpl, k, v);
#pragma unroll
        for (int d = 0; d < kMaxHpl; ++d)
          if (d < hpl) sum[d] += v[d];
      }
#pragma unroll
      for (int d = 0; d < kMaxHpl; ++d)
        if (d < hpl) s_acc[warp][0][lane * hpl + d] = sum[d];
      __syncthreads();
      for (int dd = threadIdx.x; dd < a.hd; dd += blockDim.x) {
        float tot = 0.f;
        for (int w = 0; w < kWarps; ++w) tot += s_acc[w][0][dd];
        s_mean[dd] = tot / static_cast<float>(cap + a.E);
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < nq * a.hd; idx += blockDim.x) {
        const int j = idx / a.hd, dd = idx % a.hd;
        float L = 0.f;
        for (int w = 0; w < kWarps; ++w) L += s_l[w][j];
        if (L > 0.f) continue;
        const int qi = q0 + j, s = qi / G, h = kvh * G + qi % G;
        orow[(static_cast<long long>(s) * a.H + h) * a.hd + dd] = mxk::from_float<T>(s_mean[dd]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_for_q(const PagedArgs& a, int R, int pool_kind, cudaStream_t s) {
  const dim3 grid(R, a.KV), block(kWarps * 32);
  switch (pool_kind) {
    case 0: paged_attention_kernel<T, float, false><<<grid, block, 0, s>>>(a); break;
    case 1: paged_attention_kernel<T, __nv_bfloat16, false><<<grid, block, 0, s>>>(a); break;
    default: paged_attention_kernel<T, float, true><<<grid, block, 0, s>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

// pool_kind: 0 dense fp32, 1 dense bf16, 2 MX wire (payload + scales).
// window <= 0: no sliding window. E == 0: no extras.
extern "C" int mxk_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
    const void* v_scales, const void* tables, const void* hist, const void* q_pos,
    const void* k_extra, const void* v_extra, const void* t_extra, void* out, const float* vals,
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
  a.hist = static_cast<const int*>(hist);
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_extra = k_extra;
  a.v_extra = v_extra;
  a.t_extra = static_cast<const int*>(t_extra);
  a.out = out;
  a.vals = vals;
  a.Sq = Sq; a.H = H; a.KV = KV; a.hd = hd; a.bs = bs; a.kv_dim = kv_dim; a.nb = nb;
  a.E = E; a.n_codes = n_codes; a.bits = bits; a.mx_block = mx_block; a.bias = bias;
  a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = q_is_bf16 ? launch_for_q<__nv_bfloat16>(a, R, pool_kind, s)
                                    : launch_for_q<float>(a, R, pool_kind, s);
  return static_cast<int>(err);
}
