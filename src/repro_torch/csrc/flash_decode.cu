// Paged split-K decode attention for Hopper.
//
// Replaces the JAX package's Pallas kernel `flash_decode_paged_pallas`
// (src/repro/kernels/flash_decode.py, bodies `_paged_decode_kernel` and
// `_combine_splits`).
//
// Bound: bytes.  Each decode step reads every live K and V row once
// (2 * len * dh * 4 bytes per row and KV head from the f32 pool) and does
// 4 FLOPs per byte-pair of work, far below the card's ridge point.
//
// Design, against the two costs the Pallas version pays:
//  - the Pallas grid is (row, query head, split, block), so each KV block
//    is fetched once per query head; here one block of 4 warps owns a
//    (row, KV head, split) and computes all G = H / KV query heads of the
//    group from one read of each key and value;
//  - the Pallas wrapper transposes the whole (NB, BS, KV, dh) pool to
//    (KV, NB, BS, dh) on every call; here the kernel reads the pool in
//    place at its own strides, following the row's block table.
// Split s owns the row's logical blocks [8 s, 8 s + 8), whatever the
// batch or the table's width, so a row's keys are always merged in the
// same order (splits past the row's end hold nothing and weigh exactly 0
// in the merge).  Each split walks only its live blocks (ceil(len / BS)
// in all, clamped to the table's max_blocks), so no masked, unwritten or
// out-of-table position is ever read.  Warps take keys round-robin; a
// lane holds dh / 32 dims of q, k, v and the accumulator, and the q.k dot
// is a warp shuffle reduction.
// Softmax runs online in f32 (running max m, sum l, accumulator).  The
// four warps merge in shared memory, and a second small launch merges the
// splits by their log-sum-exp.
//
// Instantiated for what the serving path and the card tests run: dh = 128,
// an f32 pool with f32 or bf16 queries, and H / KV of 1, 2 or 8.
#include "common.cuh"

namespace repro {

constexpr int kDecodeWarps = 4;
constexpr int kSplitBlocks = 8;  // shared with kernels/flash_decode.py

template <typename TQ, typename TKV, int DH, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    float* __restrict__ part_o, float* __restrict__ part_m,
                    float* __restrict__ part_l, int kv_heads, int block_size,
                    int max_blocks, int splits, float scale) {
  static_assert(DH % 32 == 0, "a lane holds DH / 32 dims");
  constexpr int PL = DH / 32;  // dims per lane
  __shared__ float sm_m[kDecodeWarps][G];
  __shared__ float sm_l[kDecodeWarps][G];
  __shared__ float sm_acc[kDecodeWarps][G][DH];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int heads = kv_heads * G;

  const int len = lengths[b];
  // a length past the table is read as the whole table, as the plain
  // version (which gathers max_blocks blocks) reads it
  const int nblk = min((len + block_size - 1) / block_size, max_blocks);
  const int blk0 = split * kSplitBlocks;
  const int t0 = blk0 * block_size;
  const int t1 = min(min(blk0 + kSplitBlocks, nblk) * block_size, len);

  float qv[G][PL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const TQ* qp = q + (static_cast<size_t>(b) * heads + kvh * G + g) * DH +
                   lane * PL;
    load_vec<TQ, PL>(qp, qv[g]);
  }
  float m[G], l[G], acc[G][PL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = neg_inf();
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) acc[g][i] = 0.f;
  }

  const int* table = tables + static_cast<size_t>(b) * max_blocks;
  for (int t = t0 + warp; t < t1; t += kDecodeWarps) {
    const int phys = table[t / block_size];
    const size_t row = (static_cast<size_t>(phys) * block_size +
                        t % block_size) * kv_heads + kvh;
    float kk[PL], vv[PL];
    load_vec<TKV, PL>(k_pool + row * DH + lane * PL, kk);
    load_vec<TKV, PL>(v_pool + row * DH + lane * PL, vv);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) d += qv[g][i] * kk[i];
      const float s = warp_sum(d) * scale;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < PL; ++i) acc[g][i] = acc[g][i] * alpha + p * vv[i];
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) sm_acc[warp][g][lane * PL + i] = acc[g][i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * DH; idx += kDecodeWarps * 32) {
    const int g = idx / DH;
    const int d = idx % DH;
    float mx = neg_inf();
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float wt = sm_m[w][g] == neg_inf() ? 0.f : expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * wt;
      num += sm_acc[w][g][d] * wt;
    }
    const size_t part = (static_cast<size_t>(b) * heads + kvh * G + g) *
                            splits + split;
    part_o[part * DH + d] = num;
    if (d == 0) {
      part_m[part] = mx;
      part_l[part] = den;
    }
  }
}

// Merge the splits of one (row, head) by log-sum-exp: blockDim.x == DH.
template <typename TQ>
__global__ void combine_splits_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      TQ* __restrict__ out, int splits,
                                      int dh) {
  const size_t bh = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int d = threadIdx.x;
  float mx = neg_inf();
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_m[bh * splits + s]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ms = part_m[bh * splits + s];
    const float wt = ms == neg_inf() ? 0.f : expf(ms - mx);
    den += part_l[bh * splits + s] * wt;
    num += part_o[(bh * splits + s) * dh + d] * wt;
  }
  out[bh * dh + d] = from_float<TQ>(num / fmaxf(den, 1e-30f));
}

template <typename TQ, typename TKV, int DH, int G>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const void* tables,
                          const void* lengths, void* part_o, void* part_m,
                          void* part_l, void* out, int batch, int kv_heads,
                          int block_size, int max_blocks, int splits,
                          float scale, cudaStream_t stream) {
  dim3 grid(splits, kv_heads, batch);
  paged_decode_kernel<TQ, TKV, DH, G><<<grid, kDecodeWarps * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(part_o),
      static_cast<float*>(part_m), static_cast<float*>(part_l), kv_heads,
      block_size, max_blocks, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2(kv_heads * G, batch);
  combine_splits_kernel<TQ><<<grid2, DH, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<TQ*>(out), splits, DH);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_group(int group, const void* q, const void* k_pool,
                           const void* v_pool, const void* tables,
                           const void* lengths, void* part_o, void* part_m,
                           void* part_l, void* out, int batch, int kv_heads,
                           int block_size, int max_blocks, int splits,
                           float scale, cudaStream_t stream) {
#define REPRO_DECODE_CASE(G_)                                              \
  case G_:                                                                 \
    return launch_decode<TQ, float, 128, G_>(                              \
        q, k_pool, v_pool, tables, lengths, part_o, part_m, part_l, out,   \
        batch, kv_heads, block_size, max_blocks, splits, scale, stream);
  switch (group) {
    REPRO_DECODE_CASE(1)
    REPRO_DECODE_CASE(2)
    REPRO_DECODE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

}  // namespace repro

// q: (batch, kv_heads * group, dh); k_pool, v_pool: (NB, block_size,
// kv_heads, dh) f32; tables: (batch, max_blocks) int32; lengths: (batch,)
// int32; part_o: (batch, heads, splits, dh) f32 and part_m, part_l:
// (batch, heads, splits) f32 scratch, splits = ceil(max_blocks / 8);
// out: (batch, heads, dh) in q's dtype (f32 or bf16).  dh is 128 and
// group 1, 2 or 8.
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* tables,
                                  const void* lengths, void* part_o,
                                  void* part_m, void* part_l, void* out,
                                  int batch, int kv_heads, int group, int dh,
                                  int block_size, int max_blocks, int splits,
                                  float scale, int q_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh != 128 || splits * repro::kSplitBlocks < max_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == repro::kFloat32)
    return static_cast<int>(repro::dispatch_group<float>(
        group, q, k_pool, v_pool, tables, lengths, part_o, part_m, part_l,
        out, batch, kv_heads, block_size, max_blocks, splits, scale, s));
  if (q_dtype == repro::kBFloat16)
    return static_cast<int>(repro::dispatch_group<__nv_bfloat16>(
        group, q, k_pool, v_pool, tables, lengths, part_o, part_m, part_l,
        out, batch, kv_heads, block_size, max_blocks, splits, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
