// Tiled (flash) attention with an online softmax for Hopper: causal
// prompt prefill.
//
// Replaces the JAX package's Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`).
//
// Bound: operations.  Causal prefill at S = 1024, dh = 128 does
// 2 * 2 * S^2 / 2 * dh FLOPs per (row, head) against 4 * S * dh bytes of
// q, k, v and output, about 256 FLOP per byte in bf16, close to the
// tensor cores' ridge point; this first version does its products on the
// f32 FMA units (no mma.sync / wgmma yet), so its ceiling is the card's
// 67 TFLOP/s of f32 FMA, not 989 TFLOP/s of bf16 tensor-core math.
//
// Design: one block of 256 threads per (row, head, 64-query tile).  The
// block loops over 64-key tiles up to the causal diagonal and the row's
// valid length, so tiles above the diagonal are never loaded.  The q tile,
// the k tile (stored transposed), the v tile and the probability tile live
// in shared memory as f32; each thread owns 4 query rows (the same rows in
// the score micro-tile and in the output accumulator, so the rescale
// factor never leaves registers) and keeps the running max, sum and its
// dh / 16 output columns per row in registers.  Row reductions are
// shuffles across the 16 threads that share a row.  GQA maps query head h
// to KV head h / (H / KV).  Inputs are read at caller-given strides with a
// contiguous last dim, so (B, S, H, dh) activations need no transpose.
#include "common.cuh"

namespace repro {

constexpr int kFlashThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile

template <int DH>
struct FlashSmem {
  static constexpr int kQStride = DH + 1;
  static constexpr int kKStride = kBK + 1;  // K stored as [DH][kBK + 1]
  static constexpr int kVStride = DH;
  static constexpr int kPStride = kBK + 1;
  static constexpr int kFloats = kBQ * kQStride + DH * kKStride +
                                 kBK * kVStride + kBQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kFlashThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ lengths,
                       T* __restrict__ out, int heads, int kv_heads, int sq,
                       int sk, long long q_sb, long long q_sh, long long q_ss,
                       long long k_sb, long long k_sh, long long k_ss,
                       long long v_sb, long long v_sh, long long v_ss,
                       long long o_sb, long long o_sh, long long o_ss,
                       int causal, float scale) {
  using S = FlashSmem<DH>;
  constexpr int CPT = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                          // [kBQ][kQStride]
  float* kt = qs + kBQ * S::kQStride;        // [DH][kKStride]
  float* vs = kt + DH * S::kKStride;         // [kBK][kVStride]
  float* ps = vs + kBK * S::kVStride;        // [kBQ][kPStride]

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kBQ;                 // first query row of the tile
  const int abs_q0 = (sk - sq) + q0;       // its key position
  const int kv_len = lengths != nullptr ? min(lengths[b], sk) : sk;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int idx = threadIdx.x; idx < kBQ * DH; idx += kFlashThreads) {
    const int r = idx / DH, d = idx % DH;
    const int qr = q0 + r;
    qs[r * S::kQStride + d] = qr < sq ? to_float<T>(qb[qr * q_ss + d]) : 0.f;
  }

  float m_run[4], l_run[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = neg_inf();
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  int last_key = kv_len - 1;
  if (causal) last_key = min(last_key, abs_q0 + kBQ - 1);
  const int n_tiles = last_key >= 0 ? last_key / kBK + 1 : 0;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's k/v/p are consumed
    for (int idx = threadIdx.x; idx < kBK * DH; idx += kFlashThreads) {
      const int c = idx / DH, d = idx % DH;
      const int key = k0 + c;
      const bool ok = key < sk;
      kt[d * S::kKStride + c] = ok ? to_float<T>(kb[key * k_ss + d]) : 0.f;
      vs[c * S::kVStride + d] = ok ? to_float<T>(vb[key * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * S::kQStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kt[d * S::kKStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += a[i] * bk[j];
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = abs_q0 + r;
      const bool row_ok = q0 + r < sq;
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = row_ok && key < kv_len && (!causal || key <= qpos);
        sc[i][j] = ok ? sc[i][j] * scale : neg_inf();
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_run[i], mx);
      float rowsum = 0.f;
      if (m_new == neg_inf()) {
        alpha[i] = 1.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      } else {
        alpha[i] = expf(m_run[i] - m_new);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = expf(sc[i][j] - m_new);  // masked: exp(-inf) = 0
          rowsum += sc[i][j];
        }
      }
      rowsum = half_warp_sum(rowsum);
      l_run[i] = l_run[i] * alpha[i] + rowsum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[r * S::kPStride + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * S::kPStride + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = vs[c * S::kVStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] += p[i] * vv[j];
    }
  }

  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= sq) continue;
    const float inv = 1.f / (l_run[i] == 0.f ? 1.f : l_run[i]);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      ob[qr * o_ss + tx + 16 * j] = from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int batch, int heads,
                         int kv_heads, int sq, int sk, const long long* st,
                         int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = FlashSmem<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_attention_kernel<T, DH><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), heads, kv_heads, sq, sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal,
      scale);
  return cudaGetLastError();
}

}  // namespace repro

// q: (batch, heads, sq, dh), k, v: (batch, kv_heads, sk, dh) and out:
// (batch, heads, sq, dh), each addressed through its (batch, head, seq)
// element strides in `strides` (12 values: q, k, v, out) with a
// contiguous last dim; lengths: (batch,) int32 valid kv lengths, or null.
// Queries sit at the last sq key positions.  dh is 128, the model's.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, int batch, int heads,
                                     int kv_heads, int sq, int sk, int dh,
                                     const long long* strides, int causal,
                                     float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::launch_flash<float, 128>(
        q, k, v, lengths, out, batch, heads, kv_heads, sq, sk, strides,
        causal, scale, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(repro::launch_flash<__nv_bfloat16, 128>(
        q, k, v, lengths, out, batch, heads, kv_heads, sq, sk, strides,
        causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
