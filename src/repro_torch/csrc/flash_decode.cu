// Split-K decode attention for Hopper, over a paged pool or a contiguous
// cache.
//
// Replaces the JAX package's Pallas kernels `flash_decode_paged_pallas`
// (bodies `_paged_decode_kernel` and `_combine_splits`) and
// `flash_decode_pallas` (body `_decode_kernel`), both in
// src/repro/kernels/flash_decode.py.
//
// Bound: bytes.  Each decode step reads every live K and V row once
// (2 * len * dh * 4 bytes per row and KV head from the f32 cache) and does
// 4 FLOPs per byte-pair of work, far below the card's ridge point.
//
// Design, against the costs the Pallas versions pay:
//  - the Pallas grids are (row, query head, split, block), so each KV
//    block is fetched once per query head; here one block of 4 warps owns
//    a (row, KV head, split) and computes all G = H / KV query heads of
//    the group from one read of each key and value;
//  - the paged Pallas wrapper transposes the whole (NB, BS, KV, dh) pool
//    to (KV, NB, BS, dh) on every call; here the kernel reads the pool in
//    place at its own strides, following the row's block table;
//  - the contiguous Pallas kernel takes (B, KV, S, dh), which the cache's
//    (B, S, KV, dh) layer slice is only as a strided view; here the kernel
//    reads that view through its strides, so no copy of the cache is made;
//  - both Pallas kernels read masked tail blocks and select them away;
//    here each split walks only the row's live keys.
// The two layouts share one kernel body (`decode_split_kernel`) and differ
// only in where key t of a row lives (`PagedRows`, `StridedRows`).  Split s
// owns the row's logical blocks [8 s, 8 s + 8) in the pool and keys
// [128 s, 128 s + 128) in the contiguous cache, whatever the batch, the
// table's width or the cache's length, so a row's keys are always merged
// in the same order; at the pool's block size of 16 the two layouts split
// at the same keys and give the same bits for the same keys.  Splits past the row's end hold
// nothing and weigh exactly 0 in the merge.  No masked, unwritten or
// out-of-table position is ever read: a row's keys end at its length,
// clamped to the table (MB * BS) or the cache (S), as the plain versions
// clamp.  Warps take keys round-robin; a lane holds dh / 32 dims of q, k,
// v and the accumulator, and the q.k dot is a warp shuffle reduction.
// Softmax runs online in f32 (running max m, sum l, accumulator).  The
// four warps merge in shared memory, and a second small launch merges the
// splits by their log-sum-exp.
//
// Instantiated for what the serving paths and the card tests run:
// dh = 128, an f32 cache with f32 or bf16 queries, and H / KV of 1, 2 or
// 8.
#include "common.cuh"

namespace repro {

constexpr int kDecodeWarps = 4;
constexpr int kDecodeDh = 128;   // the head dim the kernels are built for
// a paged split owns 8 logical blocks (BLOCKS_PER_SPLIT in
// kernels/flash_decode.py); a contiguous split the keys of 8 blocks of 16
// (SPLIT_KEYS there), the pool's block size in the serving path
constexpr int kSplitBlocks = 8;
constexpr int kSplitKeys = kSplitBlocks * 16;

// Where key t of row b lives in the paged pool (NB, BS, KV, dh): the row's
// block table maps logical block t / BS to a pool block.
struct PagedRows {
  const int* tables;  // (batch, max_blocks)
  int block_size, max_blocks, kv_heads;

  __device__ __forceinline__ int capacity() const {
    return max_blocks * block_size;
  }
  __device__ __forceinline__ int split_keys() const {
    return kSplitBlocks * block_size;
  }
  // element offset of key t's dh-vector for KV head kvh
  __device__ __forceinline__ size_t offset(int b, int kvh, int t) const {
    const int phys =
        tables[static_cast<size_t>(b) * max_blocks + t / block_size];
    return ((static_cast<size_t>(phys) * block_size + t % block_size) *
                kv_heads + kvh) * kDecodeDh;
  }
};

// Where key t of row b lives in a contiguous (B, KV, S, dh) view with
// arbitrary strides (in elements; dh is unit-stride).
struct StridedRows {
  long long stride_b, stride_h, stride_s;
  int seq;

  __device__ __forceinline__ int capacity() const { return seq; }
  __device__ __forceinline__ int split_keys() const { return kSplitKeys; }
  __device__ __forceinline__ size_t offset(int b, int kvh, int t) const {
    return static_cast<size_t>(b * stride_b + kvh * stride_h + t * stride_s);
  }
};

template <typename TQ, typename TKV, int G, typename Rows>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, Rows rows,
                    const int* __restrict__ lengths,
                    float* __restrict__ part_o, float* __restrict__ part_m,
                    float* __restrict__ part_l, int kv_heads, int splits,
                    float scale) {
  constexpr int DH = kDecodeDh;
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

  // a length past the table or the cache reads all of it, as the plain
  // versions (which see max_blocks blocks or S keys) read it
  const int len = min(lengths[b], rows.capacity());
  const int t0 = split * rows.split_keys();
  const int t1 = min(t0 + rows.split_keys(), len);

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

  for (int t = t0 + warp; t < t1; t += kDecodeWarps) {
    const size_t off = rows.offset(b, kvh, t) + lane * PL;
    float kk[PL], vv[PL];
    load_vec<TKV, PL>(k + off, kk);
    load_vec<TKV, PL>(v + off, vv);
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

template <typename TQ, int G, typename Rows>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          Rows rows, const void* lengths, void* part_o,
                          void* part_m, void* part_l, void* out, int batch,
                          int kv_heads, int splits, float scale,
                          cudaStream_t stream) {
  dim3 grid(splits, kv_heads, batch);
  decode_split_kernel<TQ, float, G, Rows>
      <<<grid, kDecodeWarps * 32, 0, stream>>>(
          static_cast<const TQ*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), rows,
          static_cast<const int*>(lengths), static_cast<float*>(part_o),
          static_cast<float*>(part_m), static_cast<float*>(part_l),
          kv_heads, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2(kv_heads * G, batch);
  combine_splits_kernel<TQ><<<grid2, kDecodeDh, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<TQ*>(out), splits,
      kDecodeDh);
  return cudaGetLastError();
}

template <typename Rows>
cudaError_t dispatch_decode(int q_dtype, int group, const void* q,
                            const void* k, const void* v, Rows rows,
                            const void* lengths, void* part_o, void* part_m,
                            void* part_l, void* out, int batch, int kv_heads,
                            int splits, float scale, cudaStream_t stream) {
#define REPRO_DECODE_CASE(TQ_, G_)                                         \
  if (group == G_)                                                        \
    return launch_decode<TQ_, G_, Rows>(q, k, v, rows, lengths, part_o,   \
                                        part_m, part_l, out, batch,       \
                                        kv_heads, splits, scale, stream);
  if (q_dtype == kFloat32) {
    REPRO_DECODE_CASE(float, 1)
    REPRO_DECODE_CASE(float, 2)
    REPRO_DECODE_CASE(float, 8)
  } else if (q_dtype == kBFloat16) {
    REPRO_DECODE_CASE(__nv_bfloat16, 1)
    REPRO_DECODE_CASE(__nv_bfloat16, 2)
    REPRO_DECODE_CASE(__nv_bfloat16, 8)
  }
#undef REPRO_DECODE_CASE
  return cudaErrorInvalidValue;
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
  if (dh != repro::kDecodeDh || splits * repro::kSplitBlocks < max_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::PagedRows rows{static_cast<const int*>(tables), block_size,
                        max_blocks, kv_heads};
  return static_cast<int>(repro::dispatch_decode(
      q_dtype, group, q, k_pool, v_pool, rows, lengths, part_o, part_m,
      part_l, out, batch, kv_heads, splits, scale,
      static_cast<cudaStream_t>(stream)));
}

// q: (batch, kv_heads * group, dh); k, v: (batch, kv_heads, seq, dh) f32
// views sharing the strides (stride_b, stride_h, stride_s) in elements,
// dh unit-stride, every dh-vector 16-byte aligned; lengths: (batch,)
// int32; scratch and out as above with splits = ceil(seq / 128).  dh is
// 128 and group 1, 2 or 8.
extern "C" int repro_contiguous_decode(
    const void* q, const void* k, const void* v, const void* lengths,
    void* part_o, void* part_m, void* part_l, void* out, int batch,
    int kv_heads, int group, int dh, int seq, long long stride_b,
    long long stride_h, long long stride_s, int splits, float scale,
    int q_dtype, void* stream) {
  if (dh != repro::kDecodeDh || splits * repro::kSplitKeys < seq)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::StridedRows rows{stride_b, stride_h, stride_s, seq};
  return static_cast<int>(repro::dispatch_decode(
      q_dtype, group, q, k, v, rows, lengths, part_o, part_m, part_l, out,
      batch, kv_heads, splits, scale, static_cast<cudaStream_t>(stream)));
}
