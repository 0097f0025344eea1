// Device helpers shared by the MX codec kernels and the paged-attention
// kernel: exact powers of two, the shared-exponent rule, code selection,
// reading and writing codes of the packed LSB-first bitstream as aligned
// words, 16-byte stores of 8 values, and the grid size of the codec's
// grid-stride loops.
//
// Semantics equal repro_torch/core/mx.py (the plain version):
//   * shared exponent from the fp32 exponent field of the NaN-propagating
//     block amax, minus the element format's emax; amax == 0 or NaN gives
//     the scale format's min_exp; clamped to [min_exp, max_exp];
//   * a block whose exponent is below -126 (not a normal fp32 power of two)
//     stores all-zero codes, and such a scale decodes as 0;
//   * code = number of midpoints strictly below v * 2^-e (searchsorted,
//     side="left"), NaN -> the top code; found by a branch-free binary
//     search over the midpoints padded with +inf (search_code);
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

// Clamped shared exponent of a block with magnitude max ``amax``.
__device__ __forceinline__ int shared_exp(float amax, int emax, int min_exp, int max_exp) {
  int e = amax > 0.f ? static_cast<int>((__float_as_uint(amax) >> 23) & 0xFF) - 127 - emax
                     : min_exp;  // zero or NaN amax
  return min(max(e, min_exp), max_exp);
}

// Round-to-nearest code of a normalized value: the number of midpoints
// strictly below v, by a branch-free binary search of BITS steps over
// ``t``, the n_mids sorted midpoints padded with +inf to 2^BITS - 1 entries
// (a format of BITS bits has at most 2^BITS codes). +inf is below no value,
// so the padding never counts; NaN compares false everywhere and takes the
// top code. tests/test_torch_codec.py mirrors this step for step.
template <int BITS>
__device__ __forceinline__ int search_code(float v, const float* t, int n_mids) {
  int c = 0;
#pragma unroll
  for (int s = 1 << (BITS - 1); s > 0; s >>= 1) c += t[c + s - 1] < v ? s : 0;
  return isnan(v) ? n_mids : c;
}

// fp32 value of the bf16 in the low / high half of a 32-bit word (exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Two fp32 values rounded to bf16 (nearest, ties to even) in one word, the
// first in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Widest access (bytes, <= 16) that divides ``nb``: a run of nb bytes that
// starts at a multiple of nb from a 16-byte aligned base is read and written
// in accesses of this width.
__host__ __device__ constexpr int access_width(int nb) {
  return nb % 16 == 0 ? 16 : nb % 8 == 0 ? 8 : nb % 4 == 0 ? 4 : nb % 2 == 0 ? 2 : 1;
}

// NB bytes at p as little-endian 32-bit words (the last word zero-padded).
template <int NB>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[(NB + 3) / 4]) {
  constexpr int W = access_width(NB);
  if constexpr (W == 16) {
#pragma unroll
    for (int k = 0; k < NB / 16; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[k];
      w[4 * k] = q.x; w[4 * k + 1] = q.y; w[4 * k + 2] = q.z; w[4 * k + 3] = q.w;
    }
  } else if constexpr (W == 8) {
#pragma unroll
    for (int k = 0; k < NB / 8; ++k) {
      const uint2 q = reinterpret_cast<const uint2*>(p)[k];
      w[2 * k] = q.x; w[2 * k + 1] = q.y;
    }
  } else if constexpr (W == 4) {
#pragma unroll
    for (int k = 0; k < NB / 4; ++k) w[k] = reinterpret_cast<const uint32_t*>(p)[k];
  } else {
#pragma unroll
    for (int k = 0; k < (NB + 3) / 4; ++k) w[k] = 0;
#pragma unroll
    for (int b = 0; b < NB; b += W) {
      const uint32_t v = W == 2 ? reinterpret_cast<const uint16_t*>(p)[b / 2] : p[b];
      w[b / 4] |= v << (8 * (b % 4));
    }
  }
}

// The first NB bytes of the little-endian words ``w`` to p.
template <int NB>
__device__ __forceinline__ void store_words(uint8_t* p, const uint32_t (&w)[(NB + 3) / 4]) {
  constexpr int W = access_width(NB);
  if constexpr (W == 16) {
#pragma unroll
    for (int k = 0; k < NB / 16; ++k)
      reinterpret_cast<uint4*>(p)[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  } else if constexpr (W == 8) {
#pragma unroll
    for (int k = 0; k < NB / 8; ++k)
      reinterpret_cast<uint2*>(p)[k] = make_uint2(w[2 * k], w[2 * k + 1]);
  } else if constexpr (W == 4) {
#pragma unroll
    for (int k = 0; k < NB / 4; ++k) reinterpret_cast<uint32_t*>(p)[k] = w[k];
  } else {
#pragma unroll
    for (int b = 0; b < NB; b += W) {
      const uint32_t v = w[b / 4] >> (8 * (b % 4));
      if constexpr (W == 2) reinterpret_cast<uint16_t*>(p)[b / 2] = static_cast<uint16_t>(v);
      else p[b] = static_cast<uint8_t>(v);
    }
  }
}

// Code i of a packed bitstream held in words (i a compile-time constant
// after unrolling, so the words stay in registers).
template <int BITS, int NW>
__device__ __forceinline__ uint32_t get_code(const uint32_t (&w)[NW], int i) {
  const int bit = i * BITS, k = bit / 32, sh = bit % 32;
  uint32_t c = w[k] >> sh;
  if (sh + BITS > 32) c |= w[k + 1] << (32 - sh);
  return c & ((1u << BITS) - 1u);
}

// OR code ``c`` (< 2^BITS) into slot i of a zeroed packed bitstream.
template <int BITS, int NW>
__device__ __forceinline__ void put_code(uint32_t (&w)[NW], int i, uint32_t c) {
  const int bit = i * BITS, k = bit / 32, sh = bit % 32;
  w[k] |= c << sh;
  if (sh + BITS > 32) w[k + 1] |= c >> (32 - sh);
}

// Threads per CTA of the codec kernels, and the grid of their grid-stride
// loops: enough CTAs for one item per thread, at most as many as the SMs
// hold at once, so a CTA stages its code table once for all its items.
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 2048 / kThreads;

inline unsigned grid_size(long long items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long need = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(need < 1LL * sms * kCtasPerSm ? need : 1LL * sms * kCtasPerSm);
}

// The 8 codes of group ``g`` (bits bytes starting at g * bits) as one word,
// for a width known only at run time.
__device__ __forceinline__ uint64_t load_group_word(const uint8_t* payload, long long g, int bits) {
  const uint8_t* p = payload + g * bits;
  uint64_t word = 0;
  for (int b = 0; b < bits; ++b) word |= static_cast<uint64_t>(p[b]) << (8 * b);
  return word;
}

// The 8 values ``v`` to a 16-byte aligned ``dst``: two 16-byte stores
// (fp32) or one (bf16, rounded to nearest, ties to even).
__device__ __forceinline__ void store8(float* dst, const float v[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float v[8]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                              pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

}  // namespace mxk
