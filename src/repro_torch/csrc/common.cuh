// Shared helpers for the port's Hopper kernels: dtype conversion,
// vectorised loads/stores and warp/block reductions.
//
// Every kernel file exposes `extern "C"` launchers that take raw device
// pointers, the dtype codes below and a cudaStream_t, launch on that
// stream, and return cudaGetLastError() so the ctypes wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro {

// dtype codes shared with repro_torch/kernels/cuda_lib.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// An unsigned type of exactly BYTES bytes, for one vectorised access.
template <int BYTES>
struct RawVec;
template <>
struct RawVec<2> { using type = uint16_t; };
template <>
struct RawVec<4> { using type = uint32_t; };
template <>
struct RawVec<8> { using type = uint2; };
template <>
struct RawVec<16> { using type = uint4; };

// Load N contiguous elements of T (one aligned access) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  using V = typename RawVec<sizeof(T) * N>::type;
  V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float<T>(e[i]);
}

// Store N floats as contiguous elements of T (one aligned access).
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* in) {
  using V = typename RawVec<sizeof(T) * N>::type;
  V raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<V*>(p) = raw;
}

// Set a kernel's dynamic shared-memory limit once per device, not on
// every launch.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t bytes,
                          std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum N values (a power of 2, at most 32) over the warp at once: each
// halving step sends half of a lane's values to its partner and keeps the
// other half, so log2(N) steps of N/2, N/4, ... shuffles and then plain
// steps leave lane l holding the sum of value l / (32 / N), all lanes of
// a group with the same bits.  Clobbers v.
template <int N>
__device__ __forceinline__ float warp_sum_many(float (&v)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: 1, 2, ..., 32");
  int o = 16;
#pragma unroll
  for (int n = N; n > 1; n >>= 1, o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float give = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
  }
  float s = v[0];
#pragma unroll
  for (; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// (value, index) ordering of lax.top_k / argmax: larger value first,
// ties to the lower index.
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv,
                                             int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ranks_before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

}  // namespace repro
