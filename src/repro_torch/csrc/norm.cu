// Fused AddBias + Residual + {RMS,Layer}Norm for Hopper (paper C1).
//
// Replaces the JAX package's Pallas kernel `norm_pallas`
// (src/repro/kernels/layernorm.py, body `_norm_kernel`).
//
// Bound: bytes.  Per row the kernel reads x (and residual, bias) once and
// writes y (and the updated residual) once; gamma/beta are C values that
// stay in L1/L2.  At C = 2048 a row is 4 KB of bf16 in and out, far below
// the ~295 FLOP/byte the card needs to be compute-bound.
//
// Design: one block of 256 threads per row.  Each thread moves 16 bytes
// per access (8 bf16 or 4 f32).  One pass over the row produces both
// moments, sum(s) and sum(s^2), as in the paper's Eq. 1
// (Var = E(s^2) - E(s)^2), reduced by warp shuffles and one shared-memory
// step; the summed row s = x + bias + residual is parked in shared memory
// (f32) so the normalise pass never reads device memory again.
#include "common.cuh"

namespace repro {

constexpr int kNormThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
            const T* __restrict__ beta, const T* __restrict__ bias,
            const T* __restrict__ residual, T* __restrict__ y,
            T* __restrict__ s_out, int cols, float eps, int rms) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float srow[];
  __shared__ float red_sum[kNormThreads / 32];
  __shared__ float red_sq[kNormThreads / 32];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float sum = 0.f, sumsq = 0.f;
  for (int c0 = threadIdx.x * VEC; c0 < cols; c0 += kNormThreads * VEC) {
    float v[VEC];
    load_vec<T, VEC>(x + off + c0, v);
    if (bias != nullptr) {
      float b[VEC];
      load_vec<T, VEC>(bias + c0, b);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] += b[i];
    }
    if (residual != nullptr) {
      float r[VEC];
      load_vec<T, VEC>(residual + off + c0, r);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] += r[i];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      srow[c0 + i] = v[i];
      sum += v[i];
      sumsq += v[i] * v[i];
    }
    if (s_out != nullptr) store_vec<T, VEC>(s_out + off + c0, v);
  }
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  if (lane == 0) {
    red_sum[warp] = sum;
    red_sq[warp] = sumsq;
  }
  __syncthreads();
  if (warp == 0) {
    sum = lane < kNormThreads / 32 ? red_sum[lane] : 0.f;
    sumsq = lane < kNormThreads / 32 ? red_sq[lane] : 0.f;
    sum = warp_sum(sum);
    sumsq = warp_sum(sumsq);
    if (lane == 0) {
      red_sum[0] = sum;
      red_sq[0] = sumsq;
    }
  }
  __syncthreads();
  const float inv_n = 1.f / static_cast<float>(cols);
  const float mean = red_sum[0] * inv_n;
  const float mean_sq = red_sq[0] * inv_n;
  float inv;
  if (rms) {
    inv = rsqrtf(mean_sq + eps);
  } else {
    inv = rsqrtf(fmaxf(mean_sq - mean * mean, 0.f) + eps);
  }

  for (int c0 = threadIdx.x * VEC; c0 < cols; c0 += kNormThreads * VEC) {
    float g[VEC], out[VEC];
    load_vec<T, VEC>(gamma + c0, g);
    if (rms) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = srow[c0 + i] * inv * g[i];
    } else {
      float bt[VEC];
      load_vec<T, VEC>(beta + c0, bt);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out[i] = (srow[c0 + i] - mean) * inv * g[i] + bt[i];
    }
    store_vec<T, VEC>(y + off + c0, out);
  }
}

template <typename T>
cudaError_t launch_norm(const void* x, const void* gamma, const void* beta,
                        const void* bias, const void* residual, void* y,
                        void* s_out, int rows, int cols, float eps, int rms,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cols) * sizeof(float);
  norm_kernel<T><<<rows, kNormThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<const T*>(bias),
      static_cast<const T*>(residual), static_cast<T*>(y),
      static_cast<T*>(s_out), cols, eps, rms);
  return cudaGetLastError();
}

}  // namespace repro

// x, residual, y, s_out: (rows, cols); gamma, beta, bias: (cols,), all of
// one dtype.  beta is read only when rms == 0; bias, residual and s_out
// may be null.  The caller guarantees 16-byte aligned rows, cols a
// multiple of 16 / sizeof(dtype), and cols * 4 bytes of shared memory
// within the default 48 KB.
extern "C" int repro_norm(const void* x, const void* gamma, const void* beta,
                          const void* bias, const void* residual, void* y,
                          void* s_out, int rows, int cols, float eps,
                          int rms, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch_norm<float>(x, gamma, beta, bias, residual, y,
                                     s_out, rows, cols, eps, rms, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_norm<__nv_bfloat16>(x, gamma, beta, bias, residual,
                                             y, s_out, rows, cols, eps, rms,
                                             s);
  return static_cast<int>(cudaErrorInvalidValue);
}
