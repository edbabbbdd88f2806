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
// Design: the row in registers, one 16-byte vector a thread, and every
// load of it (x, the residual, the bias, gamma and beta) issued before any
// arithmetic.  A row takes one block of up to 512 threads (wider rows 2,
// 4 or 6 vectors a thread): each thread adds, stores the updated residual,
// reduces both moments (sum(s) and sum(s^2), the paper's Eq. 1 with Var =
// E(s^2) - E(s)^2) by five xor-shuffle steps, the warps' partials go to
// shared memory and, after the kernel's one barrier, every warp adds all
// of them in the same order; then it stores y.  A row of at most 32
// vectors takes a block of one warp and no barrier.  At the decode tick's
// 8 rows the kernel is latency: a warp per row of 2048 carried 8 times a
// thread's loads and arithmetic in series and measured slower
// (tools/norm_variants.py), so the threads a row follow its width.  A
// row's bits depend on the row alone, never on R.
#include "common.cuh"

namespace repro {

// One block of TPR threads a row; NV 16-byte vectors per thread, so a row
// of at most TPR * NV * VEC columns.
template <typename T, int TPR, int NV>
__global__ void __launch_bounds__(TPR)
norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
            const T* __restrict__ beta, const T* __restrict__ bias,
            const T* __restrict__ residual, T* __restrict__ y,
            T* __restrict__ s_out, int cols, float eps, int rms) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;

  // every load of the row, before any arithmetic
  uint4 xr[NV], rr[NV], br[NV], gr[NV], tr[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c0 = (i * TPR + lane) * VEC;
    if (c0 < cols) {
      xr[i] = *reinterpret_cast<const uint4*>(x + off + c0);
      if (residual != nullptr)
        rr[i] = *reinterpret_cast<const uint4*>(residual + off + c0);
      if (bias != nullptr)
        br[i] = *reinterpret_cast<const uint4*>(bias + c0);
      gr[i] = *reinterpret_cast<const uint4*>(gamma + c0);
      if (!rms) tr[i] = *reinterpret_cast<const uint4*>(beta + c0);
    }
  }

  float s[NV][VEC];
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c0 = (i * TPR + lane) * VEC;
    if (c0 < cols) {
      const T* e = reinterpret_cast<const T*>(&xr[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[i][j] = to_float<T>(e[j]);
      if (bias != nullptr) {
        const T* b = reinterpret_cast<const T*>(&br[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[i][j] += to_float<T>(b[j]);
      }
      if (residual != nullptr) {
        const T* r = reinterpret_cast<const T*>(&rr[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[i][j] += to_float<T>(r[j]);
      }
      if (s_out != nullptr) store_vec<T, VEC>(s_out + off + c0, s[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sum += s[i][j];
        sumsq += s[i][j] * s[i][j];
      }
    }
  }
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  if constexpr (TPR > 32) {
    constexpr int kWarps = TPR / 32;
    __shared__ float part[kWarps][2];
    if ((threadIdx.x & 31) == 0) {
      part[threadIdx.x >> 5][0] = sum;
      part[threadIdx.x >> 5][1] = sumsq;
    }
    __syncthreads();
    sum = 0.f;
    sumsq = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sum += part[w][0];
      sumsq += part[w][1];
    }
  }
  const float inv_n = 1.f / static_cast<float>(cols);
  const float mean = sum * inv_n;
  const float mean_sq = sumsq * inv_n;
  const float inv = rms ? rsqrtf(mean_sq + eps)
                        : rsqrtf(fmaxf(mean_sq - mean * mean, 0.f) + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c0 = (i * TPR + lane) * VEC;
    if (c0 < cols) {
      const T* g = reinterpret_cast<const T*>(&gr[i]);
      float o[VEC];
      if (rms) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o[j] = s[i][j] * inv * to_float<T>(g[j]);
      } else {
        const T* bt = reinterpret_cast<const T*>(&tr[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o[j] = (s[i][j] - mean) * inv * to_float<T>(g[j]) +
                 to_float<T>(bt[j]);
      }
      store_vec<T, VEC>(y + off + c0, o);
    }
  }
}

template <typename T, int TPR, int NV>
cudaError_t launch_norm(const void* x, const void* gamma, const void* beta,
                        const void* bias, const void* residual, void* y,
                        void* s_out, int rows, int cols, float eps, int rms,
                        cudaStream_t stream) {
  norm_kernel<T, TPR, NV><<<rows, TPR, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<const T*>(bias),
      static_cast<const T*>(residual), static_cast<T*>(y),
      static_cast<T*>(s_out), cols, eps, rms);
  return cudaGetLastError();
}

// The bodies built: one vector a thread at 32 (one warp), 64, 128,
// 256 and 512 threads a row; 2, 4 and 6 vectors a thread at 512, rows up
// to 12288 wide.  kernels/layernorm.py `norm_plan` picks one by C.
#define REPRO_NORM_BODIES(X)                                               \
  X(32, 1) X(64, 1) X(128, 1) X(256, 1) X(512, 1) X(512, 2) X(512, 4)      \
  X(512, 6)

template <typename T>
cudaError_t dispatch_norm(const void* x, const void* gamma, const void* beta,
                          const void* bias, const void* residual, void* y,
                          void* s_out, int rows, int cols, float eps, int rms,
                          int tpr, int nv, cudaStream_t stream) {
#define REPRO_NORM_CASE(TPR_, NV_)                                       \
  if (tpr == TPR_ && nv == NV_)                                          \
    return launch_norm<T, TPR_, NV_>(x, gamma, beta, bias, residual, y, \
                                     s_out, rows, cols, eps, rms, stream);
  REPRO_NORM_BODIES(REPRO_NORM_CASE)
#undef REPRO_NORM_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t norm_occupancy(int tpr, int nv, int* blocks) {
#define REPRO_NORM_CASE(TPR_, NV_)                                     \
  if (tpr == TPR_ && nv == NV_)                                        \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(             \
        blocks, norm_kernel<T, TPR_, NV_>, TPR_, 0);
  REPRO_NORM_BODIES(REPRO_NORM_CASE)
#undef REPRO_NORM_CASE
  return cudaErrorInvalidValue;
}

// An empty kernel: the floor under any launch's device time, which
// chip_smoke.py times beside the norm at the decode tick's 8 rows.
__global__ void floor_kernel() {}

}  // namespace repro

// x, residual, y, s_out: (rows, cols); gamma, beta, bias: (cols,), all of
// one dtype.  beta is read only when rms == 0; bias, residual and s_out
// may be null.  The caller guarantees 16-byte aligned rows and cols a
// multiple of 16 / sizeof(dtype), and picks the body: tpr threads a row
// and nv vectors a thread, with tpr * nv vectors covering the row
// (kernels/layernorm.py `norm_plan`).
extern "C" int repro_norm(const void* x, const void* gamma, const void* beta,
                          const void* bias, const void* residual, void* y,
                          void* s_out, int rows, int cols, float eps,
                          int rms, int dtype, int tpr, int nv,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == repro::kBFloat16 ? 8 : 4;
  if (rows <= 0 || cols <= 0 || cols % vec ||
      static_cast<long long>(tpr) * nv * vec < cols)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return repro::dispatch_norm<float>(x, gamma, beta, bias, residual, y,
                                       s_out, rows, cols, eps, rms, tpr, nv,
                                       s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch_norm<__nv_bfloat16>(x, gamma, beta, bias,
                                               residual, y, s_out, rows,
                                               cols, eps, rms, tpr, nv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks per SM of the body (dtype, tpr, nv), or minus a CUDA
// error code.
extern "C" int repro_norm_blocks_per_sm(int dtype, int tpr, int nv) {
  int blocks = 0;
  const cudaError_t err =
      dtype == repro::kBFloat16
          ? repro::norm_occupancy<__nv_bfloat16>(tpr, nv, &blocks)
          : repro::norm_occupancy<float>(tpr, nv, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launch the empty kernel on (blocks, threads).
extern "C" int repro_floor(int blocks, int threads, void* stream) {
  repro::floor_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
