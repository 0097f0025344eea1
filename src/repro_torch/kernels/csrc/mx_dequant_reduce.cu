// Fused MX dequantize + shard reduction: the epilogue of the compressed
// row-parallel reduction (the paper's Fig. 1b gather variant).
//
// Replaces the TPU kernel src/repro/kernels/mx_dequant.py:_dequant_reduce_kernel
// (wrapper dequant_reduce, dispatch kernels/ops.py:mx_dequant_reduce).
//
// payload (S, M, N*bits/8) + scales (S, M, N/B) -> (M, N) fp32 or bf16: each
// thread owns one group of 8 output values and walks the S shards in order
// 0..S-1, reading the group's ``bits`` payload bytes of each shard as
// aligned words (one 32-bit load for fp4) and accumulating the dequantized
// values in fp32 registers (the same order as the plain version, so results
// are bit-identical); it casts once and writes the 8 values as one 16-byte
// store (bf16) or two (fp32). The gathered payload never round-trips
// through device memory as dense values.
//
// Bound: bytes — S*(bits/8 + 1/B) bytes read and 2 or 4 written per output
// value; each input byte is read once.
#include "mx_common.cuh"

namespace {

struct ReduceArgs {
  const uint8_t* payload;
  const uint8_t* scales;
  void* out;
  const float* vals;
  long long n_groups;
  int n_codes, n_shards, gpb_shift, bias;
};

template <typename OutT, int BITS>
__global__ void __launch_bounds__(mxk::kThreads) mx_dequant_reduce_kernel(const ReduceArgs a) {
  __shared__ float s_vals[1 << BITS];
  for (int i = threadIdx.x; i < (1 << BITS); i += blockDim.x)
    s_vals[i] = i < a.n_codes ? a.vals[i] : __int_as_float(0x7fc00000);  // no code: NaN
  __syncthreads();
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= a.n_groups) return;
  const long long n_scales = a.n_groups >> a.gpb_shift;
  float acc[8];
  for (int s = 0; s < a.n_shards; ++s) {
    uint32_t w[(BITS + 3) / 4];
    mxk::load_words<BITS>(a.payload + (s * a.n_groups + g) * BITS, w);
    const float sc = mxk::scale_value(a.scales[s * n_scales + (g >> a.gpb_shift)] - a.bias);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = s_vals[mxk::get_code<BITS>(w, i)] * sc;
      acc[i] = s > 0 ? acc[i] + v : v;
    }
  }
  mxk::store8(static_cast<OutT*>(a.out) + g * 8, acc);
}

template <typename OutT>
int launch(const ReduceArgs& a, int bits, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((a.n_groups + mxk::kThreads - 1) / mxk::kThreads);
  switch (bits) {
    case 1: mx_dequant_reduce_kernel<OutT, 1><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 2: mx_dequant_reduce_kernel<OutT, 2><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 3: mx_dequant_reduce_kernel<OutT, 3><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 4: mx_dequant_reduce_kernel<OutT, 4><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 5: mx_dequant_reduce_kernel<OutT, 5><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 6: mx_dequant_reduce_kernel<OutT, 6><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 7: mx_dequant_reduce_kernel<OutT, 7><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 8: mx_dequant_reduce_kernel<OutT, 8><<<grid, mxk::kThreads, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_groups = M*N/8 per shard; gpb = B/8 (a power of two). payload and out
// 16-byte aligned.
extern "C" int mxk_dequant_reduce(const void* payload, const void* scales, void* out,
                                  int out_is_bf16, const float* vals, int n_codes,
                                  long long n_groups, int n_shards, int gpb, int bits,
                                  int bias, void* stream) {
  int gpb_shift = 0;
  while ((1 << gpb_shift) < gpb) ++gpb_shift;
  const ReduceArgs a{static_cast<const uint8_t*>(payload), static_cast<const uint8_t*>(scales),
                     out, vals, n_groups, n_codes, n_shards, gpb_shift, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_bf16 ? launch<__nv_bfloat16>(a, bits, s) : launch<float>(a, bits, s);
}
