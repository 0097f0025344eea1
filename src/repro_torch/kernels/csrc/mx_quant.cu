// MX block quantization (the compress half of the codec).
//
// Replaces the TPU kernel src/repro/kernels/mx_quant.py:_quant_kernel
// (wrapper mx_quantize_2d, dispatch kernels/ops.py:mx_quantize).
//
// (M, N) fp32 or bf16 -> payload (M, N*bits/8) uint8 + scales (M, N/B) uint8.
// One thread owns one group of 8 consecutive values: it loads them with one
// or two 16-byte loads, the B/8 threads of an MX block reduce the
// NaN-propagating amax with warp shuffles, and each thread packs its 8 codes
// into ``bits`` bytes (the LSB-first layout of core/packing.py, every width
// 1-8). The code table's midpoints are staged in shared memory.
//
// Bound: bytes. It reads each input byte once and writes bits/8 + 1/B bytes
// per value, a handful of compares per value for fp4; the design keeps
// every load a full 16-byte vector, neighbouring threads on neighbouring
// addresses, and never re-reads the input.
#include "mx_common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void load8(const T* x, long long g, float v[8]);

template <>
__device__ __forceinline__ void load8<float>(const float* x, long long g, float v[8]) {
  const float4* p = reinterpret_cast<const float4*>(x + g * 8);
  const float4 a = p[0], b = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* x, long long g, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(x + g * 8);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

template <typename T>
__global__ void mx_quant_kernel(const T* __restrict__ x, uint8_t* __restrict__ payload,
                                uint8_t* __restrict__ scales, const float* __restrict__ mids,
                                int n_mids, int zero_code, long long n_groups, int gpb,
                                int bits, int emax, int min_exp, int max_exp, int bias) {
  __shared__ float s_mids[mxk::kMaxCodes];
  for (int i = threadIdx.x; i < n_mids; i += blockDim.x) s_mids[i] = mids[i];
  __syncthreads();

  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = g < n_groups;
  float v[8];
  load8<T>(x, live ? g : 0, v);  // every lane loads so the shuffles stay full

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = mxk::nan_max(amax, fabsf(v[i]));
  for (int off = 1; off < gpb; off <<= 1)
    amax = mxk::nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const int e = mxk::shared_exp(amax, emax, min_exp, max_exp);
  if (!live) return;
  if (g % gpb == 0) scales[g / gpb] = static_cast<uint8_t>(e + bias);

  uint64_t word = 0;
  if (e < mxk::kMinNormalExp) {
    for (int i = 0; i < 8; ++i) word |= static_cast<uint64_t>(zero_code) << (i * bits);
  } else {
    const float inv = mxk::pow2f(-e);
    for (int i = 0; i < 8; ++i)
      word |= static_cast<uint64_t>(mxk::code_of(v[i] * inv, s_mids, n_mids)) << (i * bits);
  }
  uint8_t* out = payload + g * bits;
  for (int b = 0; b < bits; ++b) out[b] = static_cast<uint8_t>(word >> (8 * b));
}

}  // namespace

// n_groups = M*N/8; gpb = block/8 (a power of two <= 32). Returns the
// launch's cudaError_t (0 on success).
extern "C" int mxk_quant(const void* x, int x_is_bf16, void* payload, void* scales,
                         const float* mids, int n_mids, int zero_code, long long n_groups,
                         int gpb, int bits, int emax, int min_exp, int max_exp, int bias,
                         void* stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n_groups + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* p = static_cast<uint8_t*>(payload);
  uint8_t* sc = static_cast<uint8_t*>(scales);
  if (x_is_bf16)
    mx_quant_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), p, sc, mids, n_mids, zero_code, n_groups, gpb,
        bits, emax, min_exp, max_exp, bias);
  else
    mx_quant_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), p, sc, mids, n_mids, zero_code, n_groups, gpb, bits, emax,
        min_exp, max_exp, bias);
  return static_cast<int>(cudaGetLastError());
}
