// Fused MX dequantize + shard reduction: the epilogue of the compressed
// row-parallel reduction (the paper's Fig. 1b gather variant).
//
// Replaces the TPU kernel src/repro/kernels/mx_dequant.py:_dequant_reduce_kernel
// (wrapper dequant_reduce, dispatch kernels/ops.py:mx_dequant_reduce).
//
// payload (S, M, N*bits/8) + scales (S, M, N/B) -> (M, N) fp32 or bf16: each
// thread owns one group of 8 output values, walks the S shards in order
// 0..S-1 accumulating the dequantized values in fp32 registers (the same
// order as the plain version, so results are bit-identical), and casts once
// at the store. The gathered payload never round-trips through device
// memory as dense values.
//
// Bound: bytes — S*(bits/8 + 1/B) bytes read and 2 or 4 written per output
// value; each input byte is read once.
#include "mx_common.cuh"

namespace {

template <typename OutT>
__global__ void mx_dequant_reduce_kernel(const uint8_t* __restrict__ payload,
                                         const uint8_t* __restrict__ scales,
                                         OutT* __restrict__ out,
                                         const float* __restrict__ vals, int n_codes,
                                         long long n_groups, int n_shards, int gpb, int bits,
                                         int bias) {
  __shared__ float s_vals[mxk::kMaxCodes];
  for (int i = threadIdx.x; i < n_codes; i += blockDim.x) s_vals[i] = vals[i];
  __syncthreads();
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  const long long n_scales = n_groups / gpb;
  float acc[8];
  for (int s = 0; s < n_shards; ++s) {
    const uint64_t word = mxk::load_group_word(payload + s * n_groups * bits, g, bits);
    mxk::dequant_group(word, scales[s * n_scales + g / gpb], bias, bits, s_vals, acc, s > 0);
  }
  mxk::store8<OutT>(out + g * 8, acc);
}

}  // namespace

// n_groups = M*N/8 per shard.
extern "C" int mxk_dequant_reduce(const void* payload, const void* scales, void* out,
                                  int out_is_bf16, const float* vals, int n_codes,
                                  long long n_groups, int n_shards, int gpb, int bits,
                                  int bias, void* stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n_groups + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(payload);
  const uint8_t* sc = static_cast<const uint8_t*>(scales);
  if (out_is_bf16)
    mx_dequant_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        p, sc, static_cast<__nv_bfloat16*>(out), vals, n_codes, n_groups, n_shards, gpb, bits,
        bias);
  else
    mx_dequant_reduce_kernel<float><<<blocks, threads, 0, s>>>(
        p, sc, static_cast<float*>(out), vals, n_codes, n_groups, n_shards, gpb, bits, bias);
  return static_cast<int>(cudaGetLastError());
}
