// Fused temperature / top-k / top-p / Gumbel-max sampling for Hopper.
//
// Replaces the JAX package's Pallas kernel `sample_pallas`
// (src/repro/kernels/sampling.py, body `_sample_kernel`).
//
// Bound: bytes.  The function reads the (B, V) logits once (370 KB a row
// of f32 at V = 92544, 185 KB of bf16) and does a few operations per
// element; everything else touches B * C values.
//
// Design: one launch, one thread-block cluster per row.  The grid is
// (kCluster, rows); block r of a row's cluster owns the contiguous slice r
// of the row, so block order is index order.
//  1. A block reads its slice once (16-byte loads where the row allows).
//     Greedy rows (T <= 0, uniform over the cluster since a cluster is one
//     row) take the slice's argmax of the unscaled values; the leader
//     block (rank 0) reduces the cluster's argmaxes through distributed
//     shared memory (DSMEM).  Sampled rows store each scaled value
//     __fdiv_rn(x, t) (the plain version's correctly rounded division) in
//     shared memory as an order-preserving uint32 key and count the keys'
//     first radix digit into a shared histogram on the way.  A masked
//     (infinite) logit skips the division's slow path, which otherwise
//     made a masked row the slowest of the launch.
//  2. Radix select of the C-th largest key across the cluster: each pass
//     counts the next digit of the keys that still match the prefix found
//     so far; the blocks' histograms are summed through DSMEM after a
//     cluster barrier (every thread issues its loads from all peers before
//     adding, each block starting at its own peer), and every block scans
//     the same sums, so all find the same digit.  Two histogram buffers
//     alternate, so one barrier a pass suffices: a block clears the buffer
//     its peers read a pass ago.  The passes end with the threshold key T
//     and need = C - count(> T).
//  3. Gather: each thread owns a contiguous run of its block's keys; an
//     ordered block-wide compaction (a scan of the runs' counts) and the
//     lower-ranked blocks' counts (read through DSMEM) place every key
//     above T and the first `need` keys equal to T, in index order, in the
//     leader's C candidate slots through DSMEM.  Ties at rank C therefore
//     go to the lower index, as the stable sort of the plain version.
//  4. The leader block ranks the candidates by (value desc, index asc):
//     each candidate's place is the count of candidates ranked before it,
//     counted by a group of threads and summed by shuffles, so the sort is
//     one step and one barrier (a one-warp bitonic sort took 21 dependent
//     steps).  Its first warp then applies top-k, the softmax over the
//     kept candidates, top-p over the exclusive cumulative sum (a warp
//     scan) and the Gumbel-max draw, on noise staged in shared memory at
//     the start.
// No global scratch: the wrapper allocates only the (B,) output.  Every
// block stays until the cluster's last barrier, so no block exits while a
// peer may still read its shared memory.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro {

constexpr int kSampleThreads = 512;
constexpr int kSampleWarps = kSampleThreads / 32;
// Blocks in a row's cluster (8 is the portable size) and the radix digit
// width: the passes take kDigitBits bits from the top, the last one what
// is left (four passes of 8; 11, 11, 10 and a cluster of 16 measured no
// faster with the logits in L2, tools/sample_variants.py).
// kernels/sampling.py mirrors both.
constexpr int kCluster = 8;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kPasses = (32 + kDigitBits - 1) / kDigitBits;
constexpr int kNoIndex = 0x7fffffff;
// Dynamic shared memory a block may ask for: the 227 KB one block may
// hold, less 1 KB kept for the kernel's static shared memory
constexpr int kSampleSmemLimit = 232448 - 1024;

// Order-preserving map of a float to uint32: a larger value gives a larger
// key.  -0 is mapped as +0, since the two compare equal.
__device__ __forceinline__ uint32_t float_key(float v) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// x / t correctly rounded, as the plain version divides, for t positive
// and finite: an infinite x (a masked logit) is its own quotient and skips
// the division's slow path.
__device__ __forceinline__ float scaled(float x, float t) {
  return isinf(x) ? x : __fdiv_rn(x, t);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Exclusive prefix sum of v over the block's threads in thread order, and
// the block's total.  wsum: one slot per warp, not reused by the caller
// before a later barrier.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* wsum,
                                                         uint32_t& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  uint32_t before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kSampleWarps; ++w) {
    const uint32_t s = wsum[w];
    before += w < warp ? s : 0u;
    total += s;
  }
  return before + inc - v;
}

// The radix passes' digits: pass P covers bits [kShift, kShift + kWidth).
template <int P>
struct Digit {
  static constexpr int kHigh = 32 - P * kDigitBits;
  static constexpr int kWidth = kHigh < kDigitBits ? kHigh : kDigitBits;
  static constexpr int kShift = kHigh - kWidth;
};

// A thread's counts into a shared histogram, one atomic for each run of
// equal bins in the order the thread meets its keys: a run of equal values
// (a masked row's -inf) adds once a thread instead of queueing every key
// on one address.  Used where few keys count (the passes after the
// first); on every key of the slice read its compare costs more than it
// saves.
struct BinRuns {
  uint32_t* h;
  uint32_t bin = 0xffffffffu;
  uint32_t count = 0;
  __device__ __forceinline__ explicit BinRuns(uint32_t* hist) : h(hist) {}
  __device__ __forceinline__ void add(uint32_t b) {
    if (b == bin) {
      ++count;
      return;
    }
    flush();
    bin = b;
    count = 1;
  }
  __device__ __forceinline__ void flush() {
    if (count) atomicAdd(&h[bin], count);
    count = 0;
  }
};

// A thread's run of its block's keys: [e0, e0 + len) of the slice, runs
// of `vecs` 16-byte vectors, an odd number, so that the 8 threads of a
// quarter warp read 8 distinct groups of 4 banks (7 at V 92544 over 8
// blocks).  Pass 1 keeps, in place and in index order, the `kept` keys at
// or above pass 0's digit, with their slice positions in pos[e0 ...]; the
// later passes and the gather read those.
struct Run {
  int e0, len, vecs, kept;
};
constexpr int kRunChunk = 7;  // vectors of a run loaded at once

// Per-block state of the select, in shared memory.
struct SelectShared {
  uint32_t wsum[kPasses + 1][kSampleWarps];
  uint32_t digit;
  uint32_t need;
  uint32_t counts;  // (keys above T) << 16 | (keys equal to T), this block
  float greedy_v;
  int greedy_i;
  float red_v[kSampleWarps];
  int red_i[kSampleWarps];
};

// Pass P of the radix select.  On entry the pass's histogram buffer holds
// this block's counts of digit P for the keys that match (prefix, mask);
// pass 0's is filled while the slice is read.
template <int P>
__device__ __forceinline__ void radix_pass(cg::cluster_group& cluster,
                                           int rank, uint32_t* keys,
                                           uint16_t* pos, Run& run,
                                           uint32_t* hist, SelectShared& sh,
                                           uint32_t& prefix, uint32_t& mask,
                                           uint32_t& need) {
  constexpr int kNb = 1 << Digit<P>::kWidth;
  constexpr int kShift = Digit<P>::kShift;
  constexpr int kBpt = kNb >= kSampleThreads ? kNb / kSampleThreads : 1;
  uint32_t* h = hist + (P & 1) * kBins;
  const int tid = threadIdx.x;
  if constexpr (P == 1) {
    // a chunk of the run loaded before any of its keys is written back: a
    // kept key moves down to e0 + kept <= its own position
    int kept = 0;
    BinRuns counts(h);
    for (int c = 0; c < run.vecs; c += kRunChunk) {
      uint4 kv[kRunChunk];
      const uint4* k4 = reinterpret_cast<const uint4*>(keys + run.e0);
#pragma unroll
      for (int u = 0; u < kRunChunk; ++u)
        if (4 * (c + u) < run.len) kv[u] = k4[c + u];
#pragma unroll
      for (int u = 0; u < kRunChunk; ++u) {
        const uint32_t kk[4] = {kv[u].x, kv[u].y, kv[u].z, kv[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * (c + u) + j;
          const bool valid = e < run.len;
          if (valid && (kk[j] & mask) == prefix)
            counts.add((kk[j] >> kShift) & (kNb - 1));
          if (valid && kk[j] >= prefix) {  // at or above pass 0's digit
            keys[run.e0 + kept] = kk[j];
            pos[run.e0 + kept] = static_cast<uint16_t>(run.e0 + e);
            ++kept;
          }
        }
      }
    }
    counts.flush();
    run.kept = kept;
  } else if constexpr (P > 1) {
    BinRuns counts(h);
    for (int j = 0; j < run.kept; ++j) {
      const uint32_t k = keys[run.e0 + j];
      if ((k & mask) == prefix) counts.add((k >> kShift) & (kNb - 1));
    }
    counts.flush();
  }
  cluster.sync();  // every block's histogram of this pass is complete
  if (P + 1 < kPasses) {
    // the other buffer was read by the peers in the previous pass, which
    // they finished before arriving at the barrier above
    uint32_t* next = hist + ((P + 1) & 1) * kBins;
    for (int i = tid; i < kBins; i += kSampleThreads) next[i] = 0;
  }
  // thread t sums the cluster's counts of bins hi, hi - 1, ..., hi -
  // kBpt + 1, hi = kNb - 1 - t * kBpt: a prefix over threads is a suffix
  // over bins.  All kCluster loads are in flight before the first add.
  uint32_t c[kBpt] = {};
  const int lo = kNb - (tid + 1) * kBpt;
  if (lo >= 0) {
    using V = typename RawVec<4 * kBpt>::type;
    V raw[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      raw[r] = *reinterpret_cast<const V*>(
          cluster.map_shared_rank(h, (rank + r) % kCluster) + lo);
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const uint32_t* e = reinterpret_cast<const uint32_t*>(&raw[r]);
#pragma unroll
      for (int b = 0; b < kBpt; ++b) c[b] += e[kBpt - 1 - b];
    }
  }
  uint32_t mine = 0;
#pragma unroll
  for (int b = 0; b < kBpt; ++b) mine += c[b];
  uint32_t total;
  uint32_t above = block_exclusive_scan(mine, sh.wsum[P], total);
  if (above < need && need <= above + mine) {
#pragma unroll
    for (int b = 0; b < kBpt; ++b) {
      if (above + c[b] >= need) {
        sh.digit = static_cast<uint32_t>(lo + kBpt - 1 - b);
        sh.need = need - above;
        break;
      }
      above += c[b];
    }
  }
  __syncthreads();
  prefix |= sh.digit << kShift;
  mask |= static_cast<uint32_t>(kNb - 1) << kShift;
  need = sh.need;
}

// grid (kCluster, rows), cluster dims (kCluster, 1, 1), kSampleThreads a
// block.  Dynamic shared memory: slice_len uint32 keys, 2 * kBins uint32
// histogram counts, then cands_pow2 each of candidate values and indices,
// sorted values and indices, and noise, then slice_len uint16 positions.
// vec: 16-byte loads (the caller checked the row and the pointer allow
// them).
template <typename T>
__global__ void __launch_bounds__(kSampleThreads)
sample_kernel(const T* __restrict__ logits,
              const float* __restrict__ temperature,
              const int* __restrict__ top_k, const float* __restrict__ top_p,
              const float* __restrict__ gumbel, int* __restrict__ out,
              int vocab, int slice_len, int cands, int cands_pow2, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* hist = keys + slice_len;
  float* cand_v = reinterpret_cast<float*>(hist + 2 * kBins);
  int* cand_i = reinterpret_cast<int*>(cand_v + cands_pow2);
  float* sort_v = reinterpret_cast<float*>(cand_i + cands_pow2);
  int* sort_i = reinterpret_cast<int*>(sort_v + cands_pow2);
  float* noise = reinterpret_cast<float*>(sort_i + cands_pow2);
  uint16_t* pos = reinterpret_cast<uint16_t*>(noise + cands_pow2);
  __shared__ SelectShared sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int c0 = rank * slice_len;
  const int n = max(min(slice_len, vocab - c0), 0);
  const T* x = logits + static_cast<size_t>(row) * vocab + c0;
  const bool sampled = temperature[row] > 0.f;  // the plain version's test
  const float t = fmaxf(temperature[row], 1e-6f);
  const int row_top_k = top_k[row];  // the tail's, read early
  const float p_cut = top_p[row];
  constexpr int kShift0 = Digit<0>::kShift;

  if (sampled) {
    for (int i = tid; i < kBins; i += kSampleThreads) hist[i] = 0;
    if (rank == 0)  // the tail's noise, long before it is needed
      for (int j = tid; j < cands; j += kSampleThreads)
        noise[j] = gumbel[static_cast<size_t>(row) * cands + j];
    __syncthreads();
  }
  float bv = neg_inf();
  int bi = kNoIndex;
  if (vec) {
    // U 16-byte loads in flight per thread before any is used: a slice of
    // 11568 values in one round of f32 or bf16 loads
    constexpr int U = 32 / VEC;
    const int nv = n / VEC;  // slices start at multiples of 8 elements
    for (int base = tid; base < nv; base += kSampleThreads * U) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = base + u * kSampleThreads;
        if (v < nv) raw[u] = *reinterpret_cast<const uint4*>(x + v * VEC);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = base + u * kSampleThreads;
        if (v >= nv) break;
        const T* e = reinterpret_cast<const T*>(&raw[u]);
        if (sampled) {
          uint32_t k[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            k[j] = float_key(scaled(to_float<T>(e[j]), t));
            atomicAdd(&hist[k[j] >> kShift0], 1u);
          }
#pragma unroll
          for (int j = 0; j < VEC; j += 4)
            *reinterpret_cast<uint4*>(keys + v * VEC + j) =
                make_uint4(k[j], k[j + 1], k[j + 2], k[j + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float f = to_float<T>(e[j]);
            if (ranks_before(f, c0 + v * VEC + j, bv, bi)) {
              bv = f;
              bi = c0 + v * VEC + j;
            }
          }
        }
      }
    }
  } else {
    for (int e = tid; e < n; e += kSampleThreads) {
      const float f = to_float<T>(x[e]);
      if (sampled) {
        keys[e] = float_key(scaled(f, t));
        atomicAdd(&hist[keys[e] >> kShift0], 1u);
      } else if (ranks_before(f, c0 + e, bv, bi)) {
        bv = f;
        bi = c0 + e;
      }
    }
  }

  const int lane = tid & 31;
  if (!sampled) {
    // greedy row: the slice's argmax, then the leader reduces the cluster's
    const int warp = tid >> 5;
    warp_argmax(bv, bi);
    if (lane == 0) {
      sh.red_v[warp] = bv;
      sh.red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kSampleWarps ? sh.red_v[lane] : neg_inf();
      bi = lane < kSampleWarps ? sh.red_i[lane] : kNoIndex;
      warp_argmax(bv, bi);
      if (lane == 0) {
        sh.greedy_v = bv;
        sh.greedy_i = bi;
      }
    }
    cluster.sync();
    if (rank == 0 && warp == 0) {
      bv = neg_inf();
      bi = kNoIndex;
      if (lane < kCluster) {
        const SelectShared* peer = cluster.map_shared_rank(&sh, lane);
        bv = peer->greedy_v;
        bi = peer->greedy_i;
      }
      warp_argmax(bv, bi);
      if (lane == 0) out[row] = bi;
    }
    cluster.sync();  // the leader has read every peer
    return;
  }

  // radix select of the C-th largest key across the cluster
  Run run;
  run.vecs = ((n + 4 * kSampleThreads - 1) / (4 * kSampleThreads)) | 1;
  run.e0 = min(tid * 4 * run.vecs, n);
  run.len = min(run.e0 + 4 * run.vecs, n) - run.e0;
  run.kept = 0;
  uint32_t prefix = 0, mask = 0, need = static_cast<uint32_t>(cands);
  radix_pass<0>(cluster, rank, keys, pos, run, hist, sh, prefix, mask, need);
  radix_pass<1>(cluster, rank, keys, pos, run, hist, sh, prefix, mask, need);
  if constexpr (kPasses > 2)
    radix_pass<2>(cluster, rank, keys, pos, run, hist, sh, prefix, mask,
                  need);
  if constexpr (kPasses > 3)
    radix_pass<3>(cluster, rank, keys, pos, run, hist, sh, prefix, mask,
                  need);
  const uint32_t thr = prefix;  // the key of rank C
  const uint32_t n_above = static_cast<uint32_t>(cands) - need;

  // ordered gather over the kept keys: runs in thread order, each in index
  // order, so a scan of the runs' counts places them in index order
  uint32_t gt = 0, eq = 0;
  for (int j = 0; j < run.kept; ++j) {
    gt += keys[run.e0 + j] > thr;
    eq += keys[run.e0 + j] == thr;
  }
  uint32_t block_counts;  // both halves stay below 2^16: slice_len < 65536
  const uint32_t at = block_exclusive_scan((gt << 16) | eq,
                                           sh.wsum[kPasses], block_counts);
  if (tid == 0) sh.counts = block_counts;
  cluster.sync();  // every block's counts are visible
  // the lower-ranked blocks' counts: lane r of every warp reads block r's
  // and the warp adds them, 8 remote loads a warp rather than a thread
  const uint32_t lower =
      lane < rank ? *cluster.map_shared_rank(&sh.counts, lane) : 0u;
  uint32_t lower_gt = lower >> 16, lower_eq = lower & 0xffffu;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lower_gt += __shfl_xor_sync(0xffffffffu, lower_gt, o);
    lower_eq += __shfl_xor_sync(0xffffffffu, lower_eq, o);
  }
  uint32_t g = (at >> 16) + lower_gt, q = (at & 0xffffu) + lower_eq;
  if (gt + eq > 0) {
    float* lv = cluster.map_shared_rank(cand_v, 0);
    int* li = cluster.map_shared_rank(cand_i, 0);
    for (int j = 0; j < run.kept; ++j) {
      const uint32_t k = keys[run.e0 + j];
      if (k > thr) {
        lv[g] = key_float(k);
        li[g] = c0 + pos[run.e0 + j];
        ++g;
      } else if (k == thr) {
        if (q < need) {
          lv[n_above + q] = key_float(k);
          li[n_above + q] = c0 + pos[run.e0 + j];
        }
        ++q;
      }
    }
  }
  cluster.sync();  // the leader's candidates are complete
  if (rank != 0) return;

  // the leader: candidate i goes to the place given by the count of
  // candidates ranked before it; tpc threads (a power of two dividing 32)
  // count a candidate's comparisons and add them by shuffles
  const int tpc = max(1, min(32, kSampleThreads / cands_pow2));
  const int sub = tid & (tpc - 1);
  for (int base = 0; base < cands; base += kSampleThreads / tpc) {
    const int i = base + tid / tpc;
    float vi = 0.f;
    int ii = 0, before = 0;
    if (i < cands) {
      vi = cand_v[i];
      ii = cand_i[i];
      for (int j = sub; j < cands; j += tpc)
        before += ranks_before(cand_v[j], cand_i[j], vi, ii);
    }
    for (int o = 1; o < tpc; o <<= 1)
      before += __shfl_xor_sync(0xffffffffu, before, o);
    if (i < cands && sub == 0) {
      sort_v[before] = vi;
      sort_i[before] = ii;
    }
  }
  __syncthreads();
  if (tid >= 32) return;

  int k = row_top_k > 0 ? row_top_k : cands;
  k = k < 1 ? 1 : (k > cands ? cands : k);
  // the kept candidates are sorted, so their max is candidate 0
  const float m = sort_v[0];
  // lane L owns the contiguous candidates [L * per, (L + 1) * per), so a
  // per-lane running sum plus a warp scan of the lane totals is a prefix
  // sum in candidate order
  const int cper = (cands + 31) / 32;
  const int j0 = lane * cper;
  const int j1 = min(j0 + cper, cands);
  float total = 0.f;
  for (int j = j0; j < j1; ++j) total += j < k ? expf(sort_v[j] - m) : 0.f;
  const float denom = fmaxf(warp_sum(total), 1e-30f);
  float lane_mass = 0.f;
  for (int j = j0; j < j1; ++j)
    lane_mass += j < k ? expf(sort_v[j] - m) / denom : 0.f;
  float before = lane_mass;  // inclusive warp scan, then made exclusive
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, before, o);
    if (lane >= o) before += up;
  }
  before -= lane_mass;
  float best = neg_inf();
  int choice = kNoIndex;
  float cum = before;
  for (int j = j0; j < j1; ++j) {
    const bool in_k = j < k;
    const float p = in_k ? expf(sort_v[j] - m) / denom : 0.f;
    const float exclusive = cum;
    cum += p;
    const float pert = (in_k && exclusive < p_cut) ? sort_v[j] + noise[j]
                                                    : neg_inf();
    if (ranks_before(pert, j, best, choice)) {
      best = pert;
      choice = j;
    }
  }
  warp_argmax(best, choice);
  if (lane == 0) out[row] = sort_i[choice];
}

template <typename T>
cudaError_t launch_sample(const void* logits, const void* temperature,
                          const void* top_k, const void* top_p,
                          const void* gumbel, void* out, int rows, int vocab,
                          int cands, int cands_pow2, int slice_len, int smem,
                          cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = sample_kernel<T>;
  cudaError_t err = set_smem_once(kernel, kSampleSmemLimit, smem_set);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return err;
  }
  constexpr int VEC = 16 / sizeof(T);
  const int vec = vocab % VEC == 0 &&
                  reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, rows, 1);
  cfg.blockDim = dim3(kSampleThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(logits),
      static_cast<const float*>(temperature),
      static_cast<const int*>(top_k), static_cast<const float*>(top_p),
      static_cast<const float*>(gumbel), static_cast<int*>(out), vocab,
      slice_len, cands, cands_pow2, vec);
  const cudaError_t last = cudaGetLastError();  // and clears it
  return err != cudaSuccess ? err : last;
}

inline int pow2_at_least(int c) {
  int p = 1;
  while (p < c) p <<= 1;
  return p;
}

inline int sample_smem_bytes(int slice_len, int cands) {
  return slice_len * 6 + 2 * kBins * 4 + pow2_at_least(cands) * 20;
}

}  // namespace repro

// logits: (rows, vocab) f32 or bf16 (dtype code); temperature, top_p:
// (rows,) f32; top_k: (rows,) int32; gumbel: (rows, cands) f32; out:
// (rows,) int32.  The caller's plan (kernels/sampling.py `sample_plan`,
// for a cluster of kCluster blocks) gives the slice length (a multiple of
// 8, kCluster * slice_len >= vocab) and the dynamic shared memory, which
// must cover the keys, the histograms and the candidates; it guarantees
// 1 <= cands <= min(vocab, 1024).
extern "C" int repro_sample(const void* logits, const void* temperature,
                            const void* top_k, const void* top_p,
                            const void* gumbel, void* out, int rows,
                            int vocab, int cands, int slice_len, int smem,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cands < 1 || cands > 1024 || cands > vocab ||
      slice_len % 8 ||
      static_cast<long long>(repro::kCluster) * slice_len < vocab ||
      slice_len >= 65536 || smem > repro::kSampleSmemLimit ||
      smem < repro::sample_smem_bytes(slice_len, cands))
    return static_cast<int>(cudaErrorInvalidValue);
  const int p2 = repro::pow2_at_least(cands);
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::launch_sample<float>(
        logits, temperature, top_k, top_p, gumbel, out, rows, vocab, cands,
        p2, slice_len, smem, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(repro::launch_sample<__nv_bfloat16>(
        logits, temperature, top_k, top_p, gumbel, out, rows, vocab, cands,
        p2, slice_len, smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// What one launch gets from the card: resident blocks per SM and the most
// clusters that can run at once, for the f32 (dtype 0) or bf16 (1) kernel
// at `smem` bytes of dynamic shared memory.  Returns a CUDA error code.
extern "C" int repro_sample_occupancy(int dtype, int smem, int* blocks_per_sm,
                                      int* max_clusters) {
  static std::atomic<unsigned long long> set_f{0}, set_b{0};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(repro::kCluster, 1, 1);
  cfg.blockDim = dim3(repro::kSampleThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = repro::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (dtype == repro::kFloat32) {
    auto kernel = repro::sample_kernel<float>;
    err = repro::set_smem_once(kernel, repro::kSampleSmemLimit, set_f);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, kernel, repro::kSampleThreads, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  } else {
    auto kernel = repro::sample_kernel<__nv_bfloat16>;
    err = repro::set_smem_once(kernel, repro::kSampleSmemLimit, set_b);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, kernel, repro::kSampleThreads, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  }
  cudaGetLastError();  // a failed query leaves no error for a launch
  return static_cast<int>(err);
}
