// Device helpers shared by the MX codec kernels and the paged-attention
// kernel: exact powers of two, the shared-exponent rule, code selection and
// reading codes out of the packed LSB-first bitstream.
//
// Semantics equal repro_torch/core/mx.py (the plain version):
//   * shared exponent from the fp32 exponent field of the NaN-propagating
//     block amax, minus the element format's emax; amax == 0 or NaN gives
//     the scale format's min_exp; clamped to [min_exp, max_exp];
//   * a block whose exponent is below -126 (not a normal fp32 power of two)
//     stores all-zero codes, and such a scale decodes as 0;
//   * code = number of midpoints strictly below v * 2^-e (searchsorted,
//     side="left"), NaN -> the top code;
//   * codes are indices into the sorted code table, packed LSB-first: code c
//     of a row occupies bits [c*bits, (c+1)*bits) of the row's bytes.
// Built without --use_fast_math: no flush-to-zero, exact powers of two.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mxk {

constexpr int kMaxCodes = 256;       // int8 / fp8_e4m3 tables hold 255 codes
constexpr int kMinNormalExp = -126;

// Exact 2^k as a float for k in [-149, 127]; 0 below.
__device__ __forceinline__ float pow2f(int k) {
  if (k >= kMinNormalExp) return __uint_as_float(static_cast<unsigned>(k + 127) << 23);
  if (k >= -149) return __uint_as_float(1u << (k + 149));
  return 0.f;
}

// Decoded value of one scale exponent (below the normal range -> 0).
__device__ __forceinline__ float scale_value(int e) {
  return e >= kMinNormalExp ? pow2f(e) : 0.f;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// NaN-propagating max of two magnitudes (fmaxf alone drops NaN).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Clamped shared exponent of a block with magnitude max ``amax``.
__device__ __forceinline__ int shared_exp(float amax, int emax, int min_exp, int max_exp) {
  int e = amax > 0.f ? static_cast<int>((__float_as_uint(amax) >> 23) & 0xFF) - 127 - emax
                     : min_exp;  // zero or NaN amax
  return min(max(e, min_exp), max_exp);
}

// Round-to-nearest code of a normalized value by midpoint compare-count.
__device__ __forceinline__ int code_of(float v, const float* mids, int n_mids) {
  if (isnan(v)) return n_mids;
  int c = 0;
  for (int k = 0; k < n_mids; ++k) c += v > mids[k];
  return c;
}

// Code of element ``i`` in a packed row (LSB-first bitstream).
__device__ __forceinline__ int code_at(const uint8_t* row, int i, int bits) {
  const int bit = i * bits;
  const int byte = bit >> 3, sh = bit & 7;
  unsigned w = row[byte];
  if (sh + bits > 8) w |= static_cast<unsigned>(row[byte + 1]) << 8;
  return static_cast<int>((w >> sh) & ((1u << bits) - 1u));
}

// The 8 codes of group ``g`` (bits bytes starting at g * bits) as one word.
__device__ __forceinline__ uint64_t load_group_word(const uint8_t* payload, long long g, int bits) {
  const uint8_t* p = payload + g * bits;
  uint64_t word = 0;
  for (int b = 0; b < bits; ++b) word |= static_cast<uint64_t>(p[b]) << (8 * b);
  return word;
}

// Dequantize the 8 values of one packed group into ``out`` (accumulating
// when ``accumulate``), scale byte ``raw`` with bias ``bias``.
__device__ __forceinline__ void dequant_group(uint64_t word, int raw, int bias, int bits,
                                              const float* vals, float out[8], bool accumulate) {
  const float sc = scale_value(raw - bias);
  const uint64_t mask = (1ull << bits) - 1ull;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = vals[(word >> (i * bits)) & mask] * sc;
    out[i] = accumulate ? out[i] + v : v;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float v[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = from_float<T>(v[i]);
}

}  // namespace mxk
