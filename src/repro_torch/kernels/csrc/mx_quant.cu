// MX block quantization (the compress half of the codec).
//
// Replaces the TPU kernel src/repro/kernels/mx_quant.py:_quant_kernel
// (wrapper mx_quantize_2d, dispatch kernels/ops.py:mx_quantize).
//
// (M, N) fp32 or bf16 -> payload (M, N*bits/8) uint8 + scales (M, N/B) uint8.
// The values are one stream of MX blocks (N is a multiple of B, so no block
// crosses a row). A thread owns a chunk of C = min(B, 32) consecutive
// values: for B <= 32 a whole block, whose amax, scale byte and packed codes
// it finds alone; a larger block is split over B/32 neighbouring lanes that
// reduce the amax with warp shuffles. For the served shape (bf16, B = 32,
// fp4) that is four 16-byte loads in, one 16-byte payload store and one
// scale byte out per thread. The amax is a max over the magnitudes' bit
// patterns (NaN > inf > every finite value), two halves at a time for
// bf16. Codes come from a BITS-step binary search over the midpoints,
// staged once per CTA in shared memory (mx_common.cuh:search_code); the CTAs
// walk the chunks in a grid-stride loop sized to the SMs.
//
// Bound: bytes. It reads each input byte once and writes bits/8 + 1/B bytes
// per value; the work is a multiply, BITS compares and a shift per value.
#include "mx_common.cuh"

namespace {

struct QuantArgs {
  const void* x;
  uint8_t* payload;
  uint8_t* scales;
  const float* mids;
  long long n_chunks;
  int n_mids, zero_code, lane_shift, emax, min_exp, max_exp, bias;
};

// Value i of a chunk held as raw 32-bit words.
template <typename T> __device__ __forceinline__ float value_at(const uint32_t* raw, int i);
template <> __device__ __forceinline__ float value_at<float>(const uint32_t* raw, int i) {
  return __uint_as_float(raw[i]);
}
template <> __device__ __forceinline__ float value_at<__nv_bfloat16>(const uint32_t* raw, int i) {
  return i & 1 ? mxk::bf16_hi(raw[i >> 1]) : mxk::bf16_lo(raw[i >> 1]);
}

// Bit pattern of the chunk's largest magnitude as an fp32 (any NaN in the
// chunk gives a NaN pattern, as every NaN pattern exceeds inf's).
template <typename T, int NW>
__device__ __forceinline__ uint32_t amax_bits(const uint32_t (&raw)[NW]) {
  uint32_t m = 0;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < NW; ++k) m = max(m, raw[k] & 0x7fffffffu);
    return m;
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) m = __vmaxu2(m, raw[k] & 0x7fff7fffu);
    return max(m & 0xffffu, m >> 16) << 16;
  }
}

template <typename T, int BITS, int C>
__global__ void __launch_bounds__(mxk::kThreads) mx_quant_kernel(const QuantArgs a) {
  constexpr int kInBytes = C * static_cast<int>(sizeof(T));
  constexpr int kOutBytes = C * BITS / 8;
  constexpr int kTable = (1 << BITS) - 1;
  __shared__ float s_mids[kTable];

  const uint8_t* x = static_cast<const uint8_t*>(a.x);
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << a.lane_shift;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long ch = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t raw[kInBytes / 4];
  mxk::load_words<kInBytes>(x + (ch < a.n_chunks ? ch : 0) * kInBytes, raw);  // before the barrier
  for (int i = threadIdx.x; i < kTable; i += blockDim.x)
    s_mids[i] = i < a.n_mids ? a.mids[i] : __int_as_float(0x7f800000);
  __syncthreads();

  // warp-uniform trip count: the lanes of a split block shuffle together
  while (ch - lane < a.n_chunks) {
    const bool live = ch < a.n_chunks;
    uint32_t m = amax_bits<T>(raw);
    for (int off = 1; off < lanes; off <<= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const int e = mxk::shared_exp(__uint_as_float(m), a.emax, a.min_exp, a.max_exp);

    uint32_t w[(kOutBytes + 3) / 4] = {};
    if (e < mxk::kMinNormalExp) {
#pragma unroll
      for (int i = 0; i < C; ++i) mxk::put_code<BITS>(w, i, a.zero_code);
    } else {
      const float inv = mxk::pow2f(-e);
#pragma unroll
      for (int i = 0; i < C; ++i)
        mxk::put_code<BITS>(w, i, mxk::search_code<BITS>(value_at<T>(raw, i) * inv, s_mids,
                                                          a.n_mids));
    }
    if (live) {
      mxk::store_words<kOutBytes>(a.payload + ch * kOutBytes, w);
      if ((ch & (lanes - 1)) == 0) a.scales[ch >> a.lane_shift] = static_cast<uint8_t>(e + a.bias);
    }
    ch += stride;
    if (ch - lane < a.n_chunks) mxk::load_words<kInBytes>(x + (ch < a.n_chunks ? ch : 0) * kInBytes, raw);
  }
}

template <typename T, int BITS>
int launch(const QuantArgs& a, int chunk, cudaStream_t s) {
  const unsigned grid = mxk::grid_size(a.n_chunks);
  switch (chunk) {
    case 8: mx_quant_kernel<T, BITS, 8><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 16: mx_quant_kernel<T, BITS, 16><<<grid, mxk::kThreads, 0, s>>>(a); break;
    case 32: mx_quant_kernel<T, BITS, 32><<<grid, mxk::kThreads, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const QuantArgs& a, int bits, int chunk, cudaStream_t s) {
  switch (bits) {
    case 1: return launch<T, 1>(a, chunk, s);
    case 2: return launch<T, 2>(a, chunk, s);
    case 3: return launch<T, 3>(a, chunk, s);
    case 4: return launch<T, 4>(a, chunk, s);
    case 5: return launch<T, 5>(a, chunk, s);
    case 6: return launch<T, 6>(a, chunk, s);
    case 7: return launch<T, 7>(a, chunk, s);
    case 8: return launch<T, 8>(a, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// n_groups = M*N/8; gpb = B/8 (a power of two <= 32). x and payload 16-byte
// aligned. Returns the launch's cudaError_t (0 on success).
extern "C" int mxk_quant(const void* x, int x_is_bf16, void* payload, void* scales,
                         const float* mids, int n_mids, int zero_code, long long n_groups,
                         int gpb, int bits, int emax, int min_exp, int max_exp, int bias,
                         void* stream) {
  const int chunk = gpb >= 4 ? 32 : 8 * gpb;  // values per thread
  int lane_shift = 0;
  while ((chunk << lane_shift) < 8 * gpb) ++lane_shift;  // lanes per block = 2^lane_shift
  const QuantArgs a{x, static_cast<uint8_t*>(payload), static_cast<uint8_t*>(scales), mids,
                    n_groups * 8 / chunk, n_mids, zero_code, lane_shift, emax, min_exp, max_exp,
                    bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(a, bits, chunk, s) : launch<float>(a, bits, chunk, s);
}
