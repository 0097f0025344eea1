// Runs the codec kernels' CUDA sources on the CPU, for the tests in
// tests/test_torch_codec_source.py: just enough of the CUDA runtime and
// device intrinsics for mx_common.cuh and the codec .cu files to compile with
// g++, and a launch that runs every CTA of the grid in turn, each thread of a
// CTA on a std::thread. __syncthreads is a barrier of the CTA, a warp shuffle
// a barrier of its 32 lanes. A barrier that waits longer than 60 s aborts
// the process (a kernel whose threads do not all reach it would otherwise
// hang the test run).
#pragma once
#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

struct dim3i { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3i threadIdx, blockIdx;
inline dim3i blockDim, gridDim;

struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline unsigned __vmaxu2(unsigned a, unsigned b) {
  const unsigned lo = std::max(a & 0xffffu, b & 0xffffu), hi = std::max(a >> 16, b >> 16);
  return lo | (hi << 16);
}
using std::isnan;
using std::max;
using std::min;
inline unsigned max(unsigned a, unsigned b) { return a > b ? a : b; }

struct __nv_bfloat16 { uint16_t b; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float(uint32_t(h.b) << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // nearest, ties to even
  if (std::isnan(f)) return {uint16_t(0x7fff)};
  unsigned u = __float_as_uint(f);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// One SM: the grid-stride kernels get at most 2048 / kThreads CTAs, so a
// few thousand items already take several trips round their loops.
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 1; return cudaSuccess; }

namespace shim {

class Barrier {
 public:
  void reset(int n) { n_ = n; count_ = 0; }
  void wait() {
    std::unique_lock<std::mutex> lk(m_);
    const long gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
      return;
    }
    if (!cv_.wait_for(lk, std::chrono::seconds(60), [&] { return gen_ != gen; })) {
      std::fprintf(stderr, "emulated kernel: a barrier waited 60 s; aborting\n");
      std::abort();
    }
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  int n_ = 0, count_ = 0;
  long gen_ = 0;
};

inline Barrier cta;
inline Barrier warps[32];
inline unsigned lanes[1024];

}  // namespace shim

inline void __syncthreads() { shim::cta.wait(); }
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int off) {
  shim::Barrier& w = shim::warps[threadIdx.x / 32];
  shim::lanes[threadIdx.x] = v;
  w.wait();
  const unsigned r = shim::lanes[threadIdx.x ^ off];
  w.wait();
  return r;
}

// kernel<<<grid, block, ...>>>(args...) is rewritten to this call.
template <class K, class... A>
void shim_launch(unsigned grid, unsigned block, K kernel, const A&... args) {
  gridDim.x = grid;
  blockDim.x = block;
  shim::cta.reset(static_cast<int>(block));
  for (unsigned w = 0; w < (block + 31) / 32; ++w)
    shim::warps[w].reset(static_cast<int>(std::min(32u, block - 32 * w)));
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < block; ++t)
    ts.emplace_back([&, t] {
      threadIdx.x = t;
      for (unsigned b = 0; b < grid; ++b) {  // the CTAs in turn
        blockIdx.x = b;
        kernel(args...);
        shim::cta.wait();
      }
    });
  for (auto& t : ts) t.join();
}
