// MX dequantization: payload + scales -> dense values.
//
// Replaces the TPU kernel src/repro/kernels/mx_dequant.py:_dequant_kernel
// (wrapper mx_dequantize_2d, dispatch kernels/ops.py:mx_dequantize).
//
// payload (M, N*bits/8) + scales (M, N/B) -> (M, N) fp32 or bf16. One thread
// per group of 8 codes, neighbouring threads on neighbouring groups: it
// reads the group's ``bits`` payload bytes in the widest aligned words (one
// 32-bit load for fp4) and its scale byte, looks the codes up in the value
// table staged once per CTA in shared memory, scales them by the exact power
// of two, and writes the 8 values as one 16-byte store (bf16) or two (fp32).
// The CTAs walk the groups in a grid-stride loop sized to the SMs, and each
// thread's first payload and scale loads are issued before the table's
// barrier.
//
// Bound: bytes — it reads bits/8 + 1/B bytes and writes 2 or 4 bytes per
// value; every warp access is contiguous.
#include "mx_common.cuh"

namespace {

struct DequantArgs {
  const uint8_t* payload;
  const uint8_t* scales;
  void* out;
  const float* vals;
  long long n_groups;
  int n_codes, gpb_shift, bias;
};

template <typename OutT, int BITS>
__global__ void __launch_bounds__(mxk::kThreads) mx_dequant_kernel(const DequantArgs a) {
  __shared__ float s_vals[1 << BITS];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t w[(BITS + 3) / 4] = {};
  int raw = 0;
  if (g < a.n_groups) {  // before the barrier
    mxk::load_words<BITS>(a.payload + g * BITS, w);
    raw = a.scales[g >> a.gpb_shift];
  }
  for (int i = threadIdx.x; i < (1 << BITS); i += blockDim.x)
    s_vals[i] = i < a.n_codes ? a.vals[i] : __int_as_float(0x7fc00000);  // no code: NaN
  __syncthreads();

  OutT* out = static_cast<OutT*>(a.out);
  while (g < a.n_groups) {
    const float sc = mxk::scale_value(raw - a.bias);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = s_vals[mxk::get_code<BITS>(w, i)] * sc;
    mxk::store8(out + g * 8, v);
    g += stride;
    if (g < a.n_groups) {
      mxk::load_words<BITS>(a.payload + g * BITS, w);
      raw = a.scales[g >> a.gpb_shift];
    }
  }
}

template <typename OutT>
int launch(const DequantArgs& a, int bits, cudaStream_t s) {
  const unsigned grid = mxk::grid_size(a.n_groups);
  switch (bits) {
    case 1: mx_dequant_kernel<OutT, 1><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 2: mx_dequant_kernel<OutT, 2><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 3: mx_dequant_kernel<OutT, 3><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 4: mx_dequant_kernel<OutT, 4><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 5: mx_dequant_kernel<OutT, 5><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 6: mx_dequant_kernel<OutT, 6><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 7: mx_dequant_kernel<OutT, 7><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 8: mx_dequant_kernel<OutT, 8><<<grid, mxk::kThreads, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_groups = M*N/8; gpb = B/8 (a power of two). payload and out 16-byte
// aligned.
extern "C" int mxk_dequant(const void* payload, const void* scales, void* out, int out_is_bf16,
                           const float* vals, int n_codes, long long n_groups, int gpb,
                           int bits, int bias, void* stream) {
  int gpb_shift = 0;
  while ((1 << gpb_shift) < gpb) ++gpb_shift;
  const DequantArgs a{static_cast<const uint8_t*>(payload), static_cast<const uint8_t*>(scales),
                      out, vals, n_groups, n_codes, gpb_shift, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_bf16 ? launch<__nv_bfloat16>(a, bits, s) : launch<float>(a, bits, s);
}
