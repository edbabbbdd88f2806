// Split-K decode attention for Hopper, over a paged pool or a contiguous
// cache: the kernel and its launch, shared by the f32 K/V's translation
// unit (flash_decode.cu, with the C entry points) and the bf16 K/V's
// (flash_decode_bf16kv.cu), which compile in parallel.
//
// Replaces the JAX package's Pallas kernels `flash_decode_paged_pallas`
// (bodies `_paged_decode_kernel` and `_combine_splits`) and
// `flash_decode_pallas` (body `_decode_kernel`), both in
// src/repro/kernels/flash_decode.py.
//
// Bound: bytes.  Each decode step reads every live K and V row once
// (2 * len * dh * 4 bytes per row and KV head from an f32 cache, half that
// from a bf16 one) and does 4 FLOPs per pair of K and V values, far below
// the card's ridge point.  At serving batch sizes there are a few hundred
// blocks for 132 SMs and a split is only 128 keys, so a block's serial
// chain (copy latency, the reductions of each tile, the merge) sets the
// time as much as the bytes: the design keeps bytes in flight and
// shortens that chain.
//
// Design, against the costs the Pallas versions pay:
//  - the Pallas grids are (row, query head, split, block), so each KV
//    block is fetched once per query head; here one block of 4 warps owns
//    a (row, KV head, split) and computes all G = H / KV query heads of
//    the group from one read of each key and value;
//  - the paged Pallas wrapper transposes the whole (NB, BS, KV, dh) pool
//    to (KV, NB, BS, dh) on every call; here the kernel reads the pool in
//    place at its own strides, following the row's block table (the
//    split's entries are staged in shared memory once);
//  - the contiguous Pallas kernel takes (B, KV, S, dh), which the cache's
//    (B, S, KV, dh) layer slice is only as a strided view; here the kernel
//    reads that view through its strides, so no copy of the cache is made;
//  - both Pallas kernels read masked tail blocks and select them away;
//    here each split walks only the row's live keys;
//  - the Pallas version merges the splits in a second call; here the last
//    block of a (row, KV head) to finish merges them in the same launch.
//
// Inside a block: a split's keys go through a ring of kStages (3) shared-
// memory stages of kTileKeys (16) keys, held in the cache's own type (f32
// or bf16, the template parameter TKV: the Pallas kernels read K and V in
// any type and compute in f32).  Each warp copies its keys' K and V
// dh-vectors with 16-byte `cp.async` (4 f32 or 8 bf16 values a copy); the
// next tile but one is issued as soon as every thread is past the tile
// before, so two tiles (32 KB in f32) are in flight while one is
// computed, and an f32 block holds 48 KB, 4 blocks per SM: a batch of 8
// rows at 1024 keys (512 blocks) is resident in one wave.  A bf16 ring is
// half that.  Values become f32 where they leave the ring (the score
// loads and the P.V loads); scores, softmax, accumulation and the split
// merge are f32 for both types.
// Rows past the split's keys are zero-filled by the copy (nothing is
// read), so the loops over a tile carry no branch.  Per staged tile:
//  - scores: each warp dots q against 4 of the tile's keys (a lane holds
//    4 dims), and reduces its 4 G dot products in one multi-value
//    shuffle reduction (`warp_sum_many`: 9 shuffles at G 2, not 40);
//  - softmax, once per tile: thread (g, r) takes head g's tile max from
//    shared memory and the one exp2 of score r;
//  - P.V: thread d rescales its accumulator once and adds p * V[., d]
//    over the tile's keys in key order, and the weights into the running
//    sum (the same in every thread).
// Sums inside a split therefore depend only on the split's keys.
//
// The split merge: a block that is not its row's only live split writes
// its unnormalised output, max and sum to scratch, releases them (one
// thread's fence after a barrier), and takes a ticket for its (row, KV
// head); the block that draws the last ticket resets it to 0, acquires
// the others' partials and merges every live split by log-sum-exp in
// split order, so the bits do not depend on which block finished last.
// The tickets are an int32 buffer the wrapper keeps zeroed per stream.
//
// The two layouts share the kernel body and differ only in where key t of
// a row lives (`PagedRows`, `StridedRows`).  Split s owns the row's
// logical blocks [8 s, 8 s + 8) in the pool and keys [128 s, 128 s + 128)
// in the contiguous cache, whatever the batch, the table's width or the
// cache's length, so a row's keys are always merged in the same order; at
// the pool's block size of 16 the two layouts split and tile at the same
// keys and give the same bits for the same keys.  Splits past the row's
// end take no part in the merge.  No masked, unwritten or out-of-table
// position is ever read: a row's keys end at its length, clamped to the
// table (MB * BS) or the cache (S), as the plain versions clamp; a length
// of 0 gives zeros.
//
// The head dim is a template parameter: one thread a dim of the output
// (a block of DH threads), DH / 32 dims a lane in the score dot products,
// and a ring of DH-wide tiles.  The G query heads of a group each keep an
// accumulator a thread; a warp reduces its rows' G score sums in chunks
// of at most 32 (`warp_sum_many`), padded to a power of two, so G need
// not be one (group 7) and may exceed 8 (group 12).
//
// Instantiated for what the serving paths, the model functions and the
// card tests run: an f32 cache (the engines') or a bf16 one (the model
// functions' default, as in the JAX package), each with f32 or bf16
// queries, at dh = 128 with H / KV of 1, 2, 4, 7, 8 or 12 (InternLM2,
// OLMoE, Qwen3-32B's local heads, Qwen2-VL, StarCoder2), and at dh = 64
// with H / KV of 1 (MusicGen, Zamba2).
#pragma once

#include "common.cuh"

namespace repro {

// a paged split owns 8 logical blocks (BLOCKS_PER_SPLIT in
// kernels/flash_decode.py); a contiguous split the keys of 8 blocks of 16
// (SPLIT_KEYS there), the pool's block size in the serving path
constexpr int kSplitBlocks = 8;
constexpr int kSplitKeys = kSplitBlocks * 16;
constexpr int kTileKeys = 16;        // keys per stage
constexpr int kStages = 3;
static_assert(kStages >= 2, "a stage in flight while one is computed");

constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// The shape of the kernel for head dim DH, group G and K/V type TKV.
template <int DH, int G, typename TKV>
struct DecodeShape {
  static constexpr int kThreads = DH;            // thread d owns output dim d
  static constexpr int kWarps = DH / 32;
  static constexpr int kLaneDims = DH / 32;      // q / k dims a lane dots
  static constexpr int kRowsPerWarp = kTileKeys / kWarps;
  // values of a 16-byte copy, and the copies a thread issues per tile of
  // K (and of V)
  static constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kCopies = kTileKeys * DH / kVec / kThreads;
  // a warp's score sums a tile (key row j, head g at j * G + g), reduced
  // in chunks of kChunk (a power of two, at most 32) values
  static constexpr int kSums = kRowsPerWarp * G;
  static constexpr int kChunk = kSums < 32 ? pow2_at_least(kSums) : 32;
  static constexpr int kChunks = (kSums + kChunk - 1) / kChunk;
  static constexpr int kLanesPerSum = 32 / kChunk;
  static constexpr int kTileElems = kTileKeys * DH;
  // the ring: kStages stages of a K tile and a V tile in TKV (dynamic
  // shared memory); the split merge reuses it for every split's max and
  // sum, as floats
  static constexpr size_t kRingBytes =
      size_t(kStages) * 2 * kTileElems * sizeof(TKV);
  static constexpr int kRingFloats = static_cast<int>(kRingBytes / 4);
  // splits whose outputs the merge loads at once (fewer for wide groups,
  // whose G outputs a split take registers)
  static constexpr int kMergeLoads = G <= 8 ? 8 : 4;
  static_assert(DH % 32 == 0 && kTileKeys % kWarps == 0, "DH: 64 or 128");
  static_assert((kTileKeys * DH / kVec) % kThreads == 0, "whole copies");
  static_assert(kLaneDims * 4 <= 16, "one load of a lane's q or k dims");
};

// the ring's bytes at head dim DH in TKV (the same for every group)
template <int DH, typename TKV>
constexpr size_t kRingBytesFor = DecodeShape<DH, 1, TKV>::kRingBytes;

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
  // stage the split's table entries in `tab` (those inside the table:
  // read before the row's length is known, so no round trip waits on it)
  __device__ __forceinline__ void load_split(int b, int split,
                                             int* tab) const {
    const int blocks = min(kSplitBlocks, max_blocks - split * kSplitBlocks);
    if (static_cast<int>(threadIdx.x) < blocks)
      tab[threadIdx.x] = tables[static_cast<size_t>(b) * max_blocks +
                                split * kSplitBlocks + threadIdx.x];
  }
  // element offset of key t's DH-vector for KV head kvh; t0 is the
  // split's first key
  template <int DH>
  __device__ __forceinline__ size_t offset(int, int kvh, int t, int t0,
                                           const int* tab) const {
    const unsigned rel = t - t0, bsz = block_size;
    return ((static_cast<size_t>(tab[rel / bsz]) * bsz + rel % bsz) *
                kv_heads + kvh) * DH;
  }
};

// Where key t of row b lives in a contiguous (B, KV, S, dh) view with
// arbitrary strides (in elements; dh is unit-stride).
struct StridedRows {
  long long stride_b, stride_h, stride_s;
  int seq;

  __device__ __forceinline__ int capacity() const { return seq; }
  __device__ __forceinline__ int split_keys() const { return kSplitKeys; }
  __device__ __forceinline__ void load_split(int, int, int*) const {}
  template <int DH>
  __device__ __forceinline__ size_t offset(int b, int kvh, int t, int,
                                           const int*) const {
    return static_cast<size_t>(b * stride_b + kvh * stride_h + t * stride_s);
  }
};

// 16 bytes global -> shared; `bytes` 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// orders this thread's (and, through a barrier before it, its block's)
// memory accesses before and after it at device scope
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TKV comes last among the template parameters, so the f32 cache's
// instantiations keep their names' (TQ, G, DH, Rows) prefix
template <typename TQ, int G, int DH, typename Rows, typename TKV>
__global__ void __launch_bounds__(DH)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, Rows rows,
              const int* __restrict__ lengths, float* __restrict__ part,
              int* __restrict__ tickets, TQ* __restrict__ out, int kv_heads,
              int splits, float scale_log2) {
  using Sh = DecodeShape<DH, G, TKV>;
  constexpr int kThreads = Sh::kThreads, kWarps = Sh::kWarps;
  constexpr int kRowsPerWarp = Sh::kRowsPerWarp, kLaneDims = Sh::kLaneDims;
  constexpr int kTileElems = Sh::kTileElems, kVec = Sh::kVec;
  constexpr int kPart = G * (DH + 2);  // a split's partial: o, m, l
  extern __shared__ __align__(16) float ring[];
  TKV* const tiles_kv = reinterpret_cast<TKV*>(ring);
  __shared__ float sm_s[G][kTileKeys];  // a tile's scores
  __shared__ float sm_p[G][kTileKeys];  // ... and their weights
  __shared__ float sm_m[2][G];          // running max, before and after
  __shared__ float sm_alpha[G];         // the tile's rescale
  __shared__ int sm_tab[kSplitBlocks];
  __shared__ int sm_last;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int heads = kv_heads * G;
  TQ* ob = out + (static_cast<size_t>(b) * heads + kvh * G) * DH;

  rows.load_split(b, split, sm_tab);
  // a length past the table or the cache reads all of it, as the plain
  // versions (which see max_blocks blocks or S keys) read it
  const int len = max(0, min(lengths[b], rows.capacity()));
  const int sk = rows.split_keys();
  const int live = (len + sk - 1) / sk;   // splits that hold keys
  if (split >= live) {
    if (split == 0) {                      // an empty row attends to nothing
#pragma unroll
      for (int g = 0; g < G; ++g) ob[g * DH + tid] = from_float<TQ>(0.f);
    }
    return;
  }
  const int t0 = split * sk;
  const int keys = min(sk, len - t0);
  const int tiles = (keys + kTileKeys - 1) / kTileKeys;
  if (tid < G) sm_m[0][tid] = neg_inf();
  __syncthreads();

  // tile i's K and V into stage i % kStages: copy c = tid + j * kThreads
  // is 16 bytes of key row c / (DH / kVec) (f32 at DH 128: warp w copies
  // keys w, w + 4, ...); every thread commits one group per tile, empty
  // past the last.  Tile i + kStages - 1 is issued once every thread is
  // past tile i - 1, so kStages - 1 tiles are in flight while tile i is
  // computed.
  auto issue = [&](int i) {
    if (i < tiles) {
      TKV* ks = tiles_kv + (i % kStages) * 2 * kTileElems;
      TKV* vs = ks + kTileElems;
      const int n = min(kTileKeys, keys - i * kTileKeys);
#pragma unroll
      for (int j = 0; j < Sh::kCopies; ++j) {
        // a row past the split's keys is zero-filled: its copy reads
        // nothing (its address is the last key's, never dereferenced)
        const int c = tid + j * kThreads;
        const int r = c / (DH / kVec), col = (c % (DH / kVec)) * kVec;
        const size_t off =
            rows.template offset<DH>(b, kvh,
                                     t0 + i * kTileKeys + min(r, n - 1), t0,
                                     sm_tab) + col;
        const int bytes = r < n ? 16 : 0;
        cp_async_16(ks + r * DH + col, k + off, bytes);
        cp_async_16(vs + r * DH + col, v + off, bytes);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float qv[G][kLaneDims];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_vec<TQ, kLaneDims>(
        q + (static_cast<size_t>(b) * heads + kvh * G + g) * DH +
            lane * kLaneDims,
        qv[g]);
  // thread tid: dim tid of every head's output, and (the same in every
  // thread) each head's running sum of weights
  float acc[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = l[g] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kStages - 2>();          // this thread's copies of tile i
    __syncthreads();                       // everyone's; tile i - 1 is done
    issue(i + kStages - 1);                // into the stage it used
    const TKV* ks = tiles_kv + (i % kStages) * 2 * kTileElems;
    const TKV* vs = ks + kTileElems;
    const int n = min(kTileKeys, keys - i * kTileKeys);

    // scores: warp w dots q against keys w, w + kWarps, ... of the tile;
    // the warp's kSums sums (key j, head g at j * G + g) are formed and
    // reduced kChunk at a time (a wide group's sums never all live in
    // registers at once), so lane group lane / kLanesPerSum of chunk c
    // ends with value c * kChunk + its index
    float kk[kRowsPerWarp][kLaneDims];     // zeros past the keys
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
      load_vec<TKV, kLaneDims>(ks + (warp + j * kWarps) * DH +
                                   lane * kLaneDims,
                               kk[j]);
#pragma unroll
    for (int c = 0; c < Sh::kChunks; ++c) {
      float dot[Sh::kChunk];
#pragma unroll
      for (int e = 0; e < Sh::kChunk; ++e) {
        const int at = c * Sh::kChunk + e;
        float d = 0.f;
        if (at < Sh::kSums) {
#pragma unroll
          for (int x = 0; x < kLaneDims; ++x)
            d += qv[at % G][x] * kk[at / G][x];
        }
        dot[e] = d;
      }
      const int idx = c * Sh::kChunk + lane / Sh::kLanesPerSum;
      const float sum = warp_sum_many<Sh::kChunk>(dot, lane);
      const int r = warp + (idx / G) * kWarps;
      if (lane % Sh::kLanesPerSum == 0 && idx < Sh::kSums && r < n)
        sm_s[idx % G][r] = sum * scale_log2;
    }
    __syncthreads();

    // online softmax, once per tile: thread (g, r) takes the tile's max
    // of head g from shared memory and the one exp2 of score r
    const int cur = i & 1;
    for (int e = tid; e < G * kTileKeys; e += kThreads) {
      const int g = e / kTileKeys, r = e % kTileKeys;
      const float m_old = sm_m[cur][g];
      float mx = m_old;
#pragma unroll
      for (int j = 0; j < kTileKeys; ++j)
        mx = fmaxf(mx, j < n ? sm_s[g][j] : neg_inf());
      sm_p[g][r] = r < n ? exp2f(sm_s[g][r] - mx) : 0.f;
      if (r == 0) {
        sm_alpha[g] = exp2f(m_old - mx);   // 0 on the first tile
        sm_m[cur ^ 1][g] = mx;
      }
    }
    __syncthreads();

    // P.V: thread tid adds p * V[., tid] over the tile's keys in order,
    // and the weights into the running sum (past the keys p and V are 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g] *= sm_alpha[g];
      l[g] *= sm_alpha[g];
    }
#pragma unroll
    for (int r = 0; r < kTileKeys; ++r) {
      const float vv = to_float<TKV>(vs[r * DH + tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pr = sm_p[g][r];
        acc[g] = fmaf(pr, vv, acc[g]);
        l[g] += pr;
      }
    }
  }

  if (live == 1) {                         // the row's only split
#pragma unroll
    for (int g = 0; g < G; ++g)
      ob[g * DH + tid] = from_float<TQ>(acc[g] / fmaxf(l[g], 1e-30f));
    return;
  }

  const size_t bk = static_cast<size_t>(b) * kv_heads + kvh;
  float* mine = part + (bk * splits + split) * kPart;
#pragma unroll
  for (int g = 0; g < G; ++g) mine[g * DH + tid] = acc[g];
  if (tid == 0) {
    const int last = tiles & 1;            // where the final max went
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mine[G * DH + g] = sm_m[last][g];
      mine[G * DH + G + g] = l[g];
    }
  }
  __syncthreads();                         // the block's partials written
  if (tid == 0) {
    fence_acq_rel_gpu();                   // ... and released
    const int ticket = atomicAdd(tickets + bk, 1);
    sm_last = ticket == live - 1;
    if (sm_last) {
      tickets[bk] = 0;                     // ready for the next launch
      fence_acq_rel_gpu();                 // the other splits' partials
    }
  }
  __syncthreads();
  if (!sm_last) return;

  // the last block merges the live splits by log-sum-exp, in split order:
  // every split's max and sum into the (now idle) ring in one round trip,
  // then each thread its dim of every head, loading kMergeLoads splits'
  // outputs at once
  const float* all = part + bk * splits * kPart;
  float* sm_ms = ring;                     // [live][G] maxima
  float* sm_ls = ring + live * G;          // [live][G] sums
  for (int idx = tid; idx < live * G; idx += kThreads) {
    const float* ps = all + (idx / G) * kPart + G * DH + idx % G;
    sm_ms[idx] = __ldcg(ps);
    sm_ls[idx] = __ldcg(ps + G);
  }
  __syncthreads();
  float mx[G], den[G], num[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = neg_inf();
    den[g] = num[g] = 0.f;
  }
  for (int s = 0; s < live; ++s)
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = fmaxf(mx[g], sm_ms[s * G + g]);
  constexpr int kMergeLoads = Sh::kMergeLoads;
  for (int s0 = 0; s0 < live; s0 += kMergeLoads) {
    float o[kMergeLoads][G];
#pragma unroll
    for (int j = 0; j < kMergeLoads; ++j)
#pragma unroll
      for (int g = 0; g < G; ++g)
        o[j][g] = s0 + j < live
                      ? __ldcg(all + (s0 + j) * kPart + g * DH + tid)
                      : 0.f;
#pragma unroll
    for (int j = 0; j < kMergeLoads; ++j) {
      if (s0 + j >= live) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int at = (s0 + j) * G + g;
        const float w = exp2f(sm_ms[at] - mx[g]);
        den[g] += sm_ls[at] * w;
        num[g] += o[j][g] * w;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    ob[g * DH + tid] = from_float<TQ>(num[g] / fmaxf(den[g], 1e-30f));
}

template <typename TQ, int G, int DH, typename Rows, typename TKV>
cudaError_t set_decode_smem() {
  static std::atomic<unsigned long long> done{0};   // devices already set
  return set_smem_once(decode_kernel<TQ, G, DH, Rows, TKV>,
                       kRingBytesFor<DH, TKV>, done);
}

// One launch of the kernel instantiated for (TQ, TKV, G, DH).
template <typename Rows>
struct DecodeLaunch {
  const void *q, *k, *v;
  Rows rows;
  const void* lengths;
  void *part, *tickets, *out;
  int batch, kv_heads, splits;
  float scale;
  cudaStream_t stream;

  template <typename TQ, typename TKV, int G, int DH>
  cudaError_t run() const {
    if (2 * splits * G > DecodeShape<DH, G, TKV>::kRingFloats)
      return cudaErrorInvalidValue;       // the merge stages m and l there
    cudaError_t err = set_decode_smem<TQ, G, DH, Rows, TKV>();
    if (err != cudaSuccess) return err;
    dim3 grid(splits, kv_heads, batch);
    decode_kernel<TQ, G, DH, Rows, TKV>
        <<<grid, DH, kRingBytesFor<DH, TKV>, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), rows, static_cast<const int*>(lengths),
        static_cast<float*>(part), static_cast<int*>(tickets),
        static_cast<TQ*>(out), kv_heads, splits,
        scale * 1.4426950408889634f);
    return cudaGetLastError();
  }
};

// Resident blocks per SM of the kernel instantiated for (TQ, TKV, G, DH).
template <typename Rows>
struct DecodeOccupancy {
  int* blocks;

  template <typename TQ, typename TKV, int G, int DH>
  cudaError_t run() const {
    cudaError_t err = set_decode_smem<TQ, G, DH, Rows, TKV>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, decode_kernel<TQ, G, DH, Rows, TKV>, DH,
        kRingBytesFor<DH, TKV>);
  }
};

// Run `op` for the instantiation over a K/V of type TKV that q's dtype,
// the group size and the head dim name (INSTANTIATIONS in
// kernels/flash_decode.py).
template <typename TKV, typename Op>
cudaError_t dispatch_decode_kv(int q_dtype, int group, int dh,
                               const Op& op) {
#define REPRO_DECODE_CASE(TQ_, G_, DH_) \
  if (group == G_ && dh == DH_) return op.template run<TQ_, TKV, G_, DH_>();
#define REPRO_DECODE_CASES(TQ_)   \
  REPRO_DECODE_CASE(TQ_, 1, 128)  \
  REPRO_DECODE_CASE(TQ_, 2, 128)  \
  REPRO_DECODE_CASE(TQ_, 4, 128)  \
  REPRO_DECODE_CASE(TQ_, 7, 128)  \
  REPRO_DECODE_CASE(TQ_, 8, 128)  \
  REPRO_DECODE_CASE(TQ_, 12, 128) \
  REPRO_DECODE_CASE(TQ_, 1, 64)
  if (q_dtype == kFloat32) {
    REPRO_DECODE_CASES(float)
  } else if (q_dtype == kBFloat16) {
    REPRO_DECODE_CASES(__nv_bfloat16)
  }
#undef REPRO_DECODE_CASES
#undef REPRO_DECODE_CASE
  return cudaErrorInvalidValue;
}

// The bf16 K/V's dispatch for each op, defined in flash_decode_bf16kv.cu.
cudaError_t dispatch_decode_bf16kv(int q_dtype, int group, int dh,
                                   const DecodeLaunch<PagedRows>& op);
cudaError_t dispatch_decode_bf16kv(int q_dtype, int group, int dh,
                                   const DecodeLaunch<StridedRows>& op);
cudaError_t dispatch_decode_bf16kv(int q_dtype, int group, int dh,
                                   const DecodeOccupancy<PagedRows>& op);
cudaError_t dispatch_decode_bf16kv(int q_dtype, int group, int dh,
                                   const DecodeOccupancy<StridedRows>& op);

}  // namespace repro
