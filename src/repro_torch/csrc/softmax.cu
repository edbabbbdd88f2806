// Masked, scaled row softmax for Hopper: the batch reduction of paper
// §4.1.2 ("ApplyMaskAndSoftmax").
//
// Replaces the JAX package's Pallas kernel `softmax_pallas`
// (src/repro/kernels/softmax.py, body `_softmax_kernel`).
//
// Bound: bytes.  Each row is read once and written once; the arithmetic
// (a scale, an exp and a divide per element, two reductions per row) is
// far below the card's ridge point.
//
// Design.  The Pallas kernel packs block_rows rows into one VMEM tile and
// reduces along the lanes.  Here one warp owns one row and a block holds
// kRowsPerBlock rows, so R rows take ceil(R / 8) blocks in one launch and
// no row waits on another's synchronisation.  Each lane keeps its
// ceil(C / 32) values in registers between the two reductions (max, then
// sum of exponentials), which are warp shuffles: x is read once and the
// output written once.  Lane l holds the VEC-wide chunks l, l + 32, ...,
// so every warp access is contiguous (16-byte accesses when the row
// width and the pointers allow).  Only columns below min(length, C) are
// read; the rest are written as exact zeros.  A row with no valid column
// gives zeros, not NaN: its max is taken as 0 when it is not finite and
// the denominator is max(sum, 1e-30), as in the plain version.  The
// exponential is the accurate expf (not __expf), the divide IEEE.
//
// Rows are at most 1024 wide (the largest sequence bucket of the serving
// paths); the wrapper refuses wider rows.
#include "common.cuh"

namespace repro {

constexpr int kRowsPerBlock = 8;  // one warp per row

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// VEC: elements per access; NV: accesses per lane.  A lane holds VEC * NV
// values, a row at most 32 * VEC * NV columns.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
masked_softmax_kernel(const T* __restrict__ x, const int* __restrict__ lengths,
                      T* __restrict__ out, int rows, int cols, float scale) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * cols;
  T* orow = out + static_cast<size_t>(row) * cols;
  const int len = lengths == nullptr ? cols : min(lengths[row], cols);

  float v[NV][VEC];
  float m = neg_inf();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c0 = (i * 32 + lane) * VEC;
    if (c0 + VEC <= len) {
      load_vec<T, VEC>(xr + c0, v[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        v[i][j] = c0 + j < len ? to_float<T>(xr[c0 + j]) * scale : neg_inf();
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) m = fmaxf(m, v[i][j]);
  }
  m = warp_max(m);
  if (!isfinite(m)) m = 0.f;

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c0 = (i * 32 + lane) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[i][j] = c0 + j < len ? expf(v[i][j] - m) : 0.f;
      s += v[i][j];
    }
  }
  s = fmaxf(warp_sum(s), 1e-30f);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c0 = (i * 32 + lane) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[i][j] = v[i][j] / s;
    if (c0 + VEC <= cols) {
      store_vec<T, VEC>(orow + c0, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (c0 + j < cols) orow[c0 + j] = from_float<T>(v[i][j]);
    }
  }
}

template <typename T, int VEC, int NV>
cudaError_t launch_softmax(const void* x, const void* lengths, void* out,
                           int rows, int cols, float scale,
                           cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  masked_softmax_kernel<T, VEC, NV><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(lengths),
      static_cast<T*>(out), rows, cols, scale);
  return cudaGetLastError();
}

// Smallest power-of-two NV whose 32 * VEC * NV columns cover the row
template <typename T, int VEC>
cudaError_t dispatch_width(const void* x, const void* lengths, void* out,
                           int rows, int cols, float scale,
                           cudaStream_t stream) {
  const int per_lane = (cols + 32 * VEC - 1) / (32 * VEC);
// (instantiated only up to the 1024 columns the launcher accepts)
#define REPRO_SOFTMAX_CASE(NV_)                                        \
  if constexpr (32 * VEC * NV_ <= 1024) {                              \
    if (per_lane <= NV_)                                               \
      return launch_softmax<T, VEC, NV_>(x, lengths, out, rows, cols,  \
                                         scale, stream);               \
  }
  REPRO_SOFTMAX_CASE(1)
  REPRO_SOFTMAX_CASE(2)
  REPRO_SOFTMAX_CASE(4)
  REPRO_SOFTMAX_CASE(8)
  REPRO_SOFTMAX_CASE(16)
  REPRO_SOFTMAX_CASE(32)
#undef REPRO_SOFTMAX_CASE
  return cudaErrorInvalidValue;
}

}  // namespace repro

// x, out: (rows, cols) row-major, f32 or bf16 (dtype code); lengths:
// (rows,) int32 valid columns, or null for all; cols <= 1024.  vec != 0
// asks for 16-byte accesses: the caller guarantees cols is a multiple of
// 16 / sizeof(element) and both pointers are 16-byte aligned.
extern "C" int repro_softmax(const void* x, const void* lengths, void* out,
                             int rows, int cols, float scale, int dtype,
                             int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols <= 0 || cols > 1024 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if (dtype == repro::kFloat32)
    return static_cast<int>(
        vec ? repro::dispatch_width<float, 4>(x, lengths, out, rows, cols,
                                              scale, s)
            : repro::dispatch_width<float, 1>(x, lengths, out, rows, cols,
                                              scale, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(
        vec ? repro::dispatch_width<__nv_bfloat16, 8>(x, lengths, out, rows,
                                                      cols, scale, s)
            : repro::dispatch_width<__nv_bfloat16, 1>(x, lengths, out, rows,
                                                      cols, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
