// Fused temperature / top-k / top-p / Gumbel-max sampling for Hopper.
//
// Replaces the JAX package's Pallas kernel `sample_pallas`
// (src/repro/kernels/sampling.py, body `_sample_kernel`).
//
// Bound: bytes.  The function reads the (B, V) f32 logits once (370 KB a
// row at V = 92544) and does a few comparisons per element; everything
// else touches B * C values.
//
// Design.  A row is larger than the 227 KB of shared memory one block may
// hold, and one block per row would leave all but B of the 132 SMs idle,
// so the row is cut into `chunks` slices and the work runs in two
// launches:
//  1. `sample_partial_kernel`, one block per (slice, row): the block reads
//     its slice once into shared memory (temperature-scaled, with the same
//     correctly rounded division as the plain version), takes the slice's
//     greedy argmax of the unscaled logits on the way, and peels the
//     slice's top C scaled values in lax.top_k order (larger value first,
//     ties to the lower index).  Pass j admits only elements ranked after
//     candidate j - 1, so nothing is marked and ties stay ordered.
//  2. `sample_merge_kernel`, one block per row: the global top C is a
//     subset of the union of the slices' top C, and the order is total,
//     so peeling the union again gives exactly the row's top C in order.
//     Then one warp applies top-k, the softmax over the kept candidates,
//     top-p over the exclusive cumulative sum (a warp scan) and the
//     Gumbel-max draw over the kept set; rows with T <= 0 return the
//     greedy argmax.
#include "common.cuh"

namespace repro {

constexpr int kSampleThreads = 256;
constexpr int kNoIndex = 0x7fffffff;

// Block-wide argmax under ranks_before; every thread gets the result.
// sv/si hold one slot per warp.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* sv,
                                             int* si) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kSampleThreads / 32 ? sv[lane] : neg_inf();
    i = lane < kSampleThreads / 32 ? si[lane] : kNoIndex;
    warp_argmax(v, i);
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();  // sv/si are reused by the next reduction
}

// Peel the top `cands` of the n (value, index) pairs in shared memory into
// out_v/out_i (device or shared memory), in ranks_before order.  Slots with
// nothing left to peel get (-inf, kNoIndex), which ranks after any element.
__device__ void peel_top(const float* vals, const int* idx, int n, int cands,
                         float* out_v, int* out_i, float* sv, int* si) {
  float last_v = pos_inf();
  int last_i = -1;
  for (int j = 0; j < cands; ++j) {
    float bv = neg_inf();
    int bi = kNoIndex;
    for (int e = threadIdx.x; e < n; e += kSampleThreads) {
      const float v = vals[e];
      const int c = idx[e];
      const bool after = v < last_v || (v == last_v && c > last_i);
      if (after && ranks_before(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    block_argmax(bv, bi, sv, si);
    if (threadIdx.x == 0) {
      out_v[j] = bv;
      out_i[j] = bi;
    }
    last_v = bv;
    last_i = bi;
  }
}

// grid (chunks, rows).  Dynamic shared memory: chunk_len floats + ints.
__global__ void __launch_bounds__(kSampleThreads)
sample_partial_kernel(const float* __restrict__ logits,
                      const float* __restrict__ temperature, int vocab,
                      int chunk_len, int cands, float* __restrict__ part_v,
                      int* __restrict__ part_i, float* __restrict__ greedy_v,
                      int* __restrict__ greedy_i) {
  extern __shared__ unsigned char smem_raw[];
  float* vals = reinterpret_cast<float*>(smem_raw);
  int* idx = reinterpret_cast<int*>(vals + chunk_len);
  __shared__ float red_v[kSampleThreads / 32];
  __shared__ int red_i[kSampleThreads / 32];

  const int chunk = blockIdx.x;
  const int row = blockIdx.y;
  const int chunks = gridDim.x;
  const int c0 = chunk * chunk_len;
  const int n = max(min(chunk_len, vocab - c0), 0);
  const float* x = logits + static_cast<size_t>(row) * vocab;
  const float t = fmaxf(temperature[row], 1e-6f);

  float bv = neg_inf();
  int bi = kNoIndex;
  for (int e = threadIdx.x; e < n; e += kSampleThreads) {
    const float v = x[c0 + e];
    if (ranks_before(v, c0 + e, bv, bi)) {
      bv = v;
      bi = c0 + e;
    }
    vals[e] = __fdiv_rn(v, t);
    idx[e] = c0 + e;
  }
  block_argmax(bv, bi, red_v, red_i);  // its barriers publish vals/idx too
  const size_t slot = static_cast<size_t>(row) * chunks + chunk;
  if (threadIdx.x == 0) {
    greedy_v[slot] = bv;
    greedy_i[slot] = bi;
  }
  if (!(temperature[row] > 0.f)) return;  // a greedy row needs no peel
  peel_top(vals, idx, n, cands, part_v + slot * cands, part_i + slot * cands,
           red_v, red_i);
}

// grid (rows).  Dynamic shared memory: chunks * cands floats + ints, then
// cands floats + ints for the merged candidates.
__global__ void __launch_bounds__(kSampleThreads)
sample_merge_kernel(const float* __restrict__ part_v,
                    const int* __restrict__ part_i,
                    const float* __restrict__ greedy_v,
                    const int* __restrict__ greedy_i,
                    const float* __restrict__ temperature,
                    const int* __restrict__ top_k,
                    const float* __restrict__ top_p,
                    const float* __restrict__ gumbel, int* __restrict__ out,
                    int chunks, int cands) {
  extern __shared__ unsigned char smem_raw[];
  const int n = chunks * cands;
  float* vals = reinterpret_cast<float*>(smem_raw);
  int* idx = reinterpret_cast<int*>(vals + n);
  float* cand_v = reinterpret_cast<float*>(idx + n);
  int* cand_i = reinterpret_cast<int*>(cand_v + cands);
  __shared__ float red_v[kSampleThreads / 32];
  __shared__ int red_i[kSampleThreads / 32];
  const int row = blockIdx.x;

  float gv = neg_inf();
  int gi = kNoIndex;
  for (int c = threadIdx.x; c < chunks; c += kSampleThreads) {
    const size_t s = static_cast<size_t>(row) * chunks + c;
    if (ranks_before(greedy_v[s], greedy_i[s], gv, gi)) {
      gv = greedy_v[s];
      gi = greedy_i[s];
    }
  }
  block_argmax(gv, gi, red_v, red_i);
  if (!(temperature[row] > 0.f)) {  // greedy row: the same test as plain
    if (threadIdx.x == 0) out[row] = gi;
    return;
  }
  // each thread reads back in the first peel pass exactly the entries it
  // wrote here; the pass's barriers publish them for the later passes
  for (int e = threadIdx.x; e < n; e += kSampleThreads) {
    vals[e] = part_v[static_cast<size_t>(row) * n + e];
    idx[e] = part_i[static_cast<size_t>(row) * n + e];
  }
  peel_top(vals, idx, n, cands, cand_v, cand_i, red_v, red_i);
  __syncthreads();

  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int k = top_k[row] > 0 ? top_k[row] : cands;
  k = k < 1 ? 1 : (k > cands ? cands : k);
  // the kept candidates are sorted, so their max is candidate 0
  const float m = cand_v[0];
  // lane L owns the contiguous candidates [L * per, (L + 1) * per), so a
  // per-lane running sum plus a warp scan of the lane totals is a prefix
  // sum in candidate order
  const int per = (cands + 31) / 32;
  const int j0 = lane * per;
  const int j1 = min(j0 + per, cands);
  float total = 0.f;
  for (int j = j0; j < j1; ++j) total += j < k ? expf(cand_v[j] - m) : 0.f;
  const float denom = fmaxf(warp_sum(total), 1e-30f);
  float lane_mass = 0.f;
  for (int j = j0; j < j1; ++j)
    lane_mass += j < k ? expf(cand_v[j] - m) / denom : 0.f;
  float before = lane_mass;  // inclusive warp scan, then made exclusive
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, before, o);
    if (lane >= o) before += up;
  }
  before -= lane_mass;
  const float p_cut = top_p[row];
  const float* g = gumbel + static_cast<size_t>(row) * cands;
  float best = neg_inf();
  int choice = kNoIndex;
  float cum = before;
  for (int j = j0; j < j1; ++j) {
    const bool in_k = j < k;
    const float p = in_k ? expf(cand_v[j] - m) / denom : 0.f;
    const float exclusive = cum;
    cum += p;
    const float pert = (in_k && exclusive < p_cut) ? cand_v[j] + g[j]
                                                    : neg_inf();
    if (ranks_before(pert, j, best, choice)) {
      best = pert;
      choice = j;
    }
  }
  warp_argmax(best, choice);
  if (lane == 0) out[row] = cand_i[choice];
}

}  // namespace repro

// logits: (rows, vocab) f32; temperature, top_p: (rows,) f32; top_k:
// (rows,) int32; gumbel: (rows, cands) f32; out: (rows,) int32.  Scratch:
// part_v/part_i (rows, chunks, cands), greedy_v/greedy_i (rows, chunks).
// The caller picks chunks and chunk_len (chunks * chunk_len >= vocab) so
// that both launches' shared memory fits the 227 KB a block may use, and
// guarantees 1 <= cands <= vocab.
extern "C" int repro_sample(const void* logits, const void* temperature,
                            const void* top_k, const void* top_p,
                            const void* gumbel, void* out, void* part_v,
                            void* part_i, void* greedy_v, void* greedy_i,
                            int rows, int vocab, int cands, int chunks,
                            int chunk_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem1 = chunk_len * 8;
  const int smem2 = (chunks + 1) * cands * 8;
  cudaError_t err = cudaFuncSetAttribute(
      repro::sample_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(repro::sample_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::sample_partial_kernel<<<dim3(chunks, rows), repro::kSampleThreads,
                                 smem1, s>>>(
      static_cast<const float*>(logits),
      static_cast<const float*>(temperature), vocab, chunk_len, cands,
      static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<float*>(greedy_v), static_cast<int*>(greedy_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::sample_merge_kernel<<<rows, repro::kSampleThreads, smem2, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const float*>(greedy_v), static_cast<const int*>(greedy_i),
      static_cast<const float*>(temperature),
      static_cast<const int*>(top_k), static_cast<const float*>(top_p),
      static_cast<const float*>(gumbel), static_cast<int*>(out), chunks,
      cands);
  return static_cast<int>(cudaGetLastError());
}
