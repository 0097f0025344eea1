// MX dequantization: payload + scales -> dense values.
//
// Replaces the TPU kernel src/repro/kernels/mx_dequant.py:_dequant_kernel
// (wrapper mx_dequantize_2d, dispatch kernels/ops.py:mx_dequantize).
//
// payload (M, N*bits/8) + scales (M, N/B) -> (M, N) fp32 or bf16. One thread
// per group of 8 codes: it reads ``bits`` payload bytes and one scale byte,
// looks the codes up in the shared-memory value table and scales them by the
// exact power of two (mx_common.cuh:dequant_group, shared with
// mx_dequant_reduce.cu).
//
// Bound: bytes — it reads bits/8 + 1/B bytes and writes 2 or 4 bytes per
// value; the design reads each input byte once and writes whole groups.
#include "mx_common.cuh"

namespace {

template <typename OutT>
__global__ void mx_dequant_kernel(const uint8_t* __restrict__ payload,
                                  const uint8_t* __restrict__ scales, OutT* __restrict__ out,
                                  const float* __restrict__ vals, int n_codes,
                                  long long n_groups, int gpb, int bits, int bias) {
  __shared__ float s_vals[mxk::kMaxCodes];
  for (int i = threadIdx.x; i < n_codes; i += blockDim.x) s_vals[i] = vals[i];
  __syncthreads();
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  float v[8];
  mxk::dequant_group(mxk::load_group_word(payload, g, bits), scales[g / gpb], bias, bits,
                     s_vals, v, false);
  mxk::store8<OutT>(out + g * 8, v);
}

}  // namespace

extern "C" int mxk_dequant(const void* payload, const void* scales, void* out, int out_is_bf16,
                           const float* vals, int n_codes, long long n_groups, int gpb,
                           int bits, int bias, void* stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n_groups + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(payload);
  const uint8_t* sc = static_cast<const uint8_t*>(scales);
  if (out_is_bf16)
    mx_dequant_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        p, sc, static_cast<__nv_bfloat16*>(out), vals, n_codes, n_groups, gpb, bits, bias);
  else
    mx_dequant_kernel<float><<<blocks, threads, 0, s>>>(
        p, sc, static_cast<float*>(out), vals, n_codes, n_groups, gpb, bits, bias);
  return static_cast<int>(cudaGetLastError());
}
