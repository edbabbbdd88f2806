// Tiled (flash) attention with an online softmax for Hopper: causal
// prompt prefill, and the segment-masked attention of a packed prefill.
//
// Replaces the JAX package's Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`), and in
// its packed mode computes the JAX package's `attention_packed`
// (src/repro/models/layers.py), which has no Pallas kernel of its own.
//
// Bound: operations.  Causal prefill at S = 1024, dh = 128 does
// 2 * 2 * S^2 / 2 * dh FLOPs per (row, head) against 4 * S * dh bytes of
// q, k, v and output, about 256 FLOP per byte in bf16, close to the
// tensor cores' ridge point (295 FLOP per byte at 989 TFLOP/s and
// 3.35 TB/s): the products have to run on the tensor cores.
//
// bf16 (the serving path): both products as Hopper warpgroup MMAs
// (wgmma, bf16 in, f32 accumulate).  One block is one warpgroup (4 warps)
// serving 64 query rows of one query head; each warp owns 16 whole rows.
// The q tile is loaded once and held in registers as wgmma A fragments.
// K and V tiles of 64 keys are bf16 in shared memory in wgmma's 128-byte
// swizzled layout (two 64-column halves, 16-byte chunks XORed with the
// row mod 8), read by the tensor cores through matrix descriptors: K as a
// K-major B operand of S = Q K^T (m64n64k16), V as an MN-major one of
// O += P V (m64n128k16), so V needs no transpose.  The f32 scores are
// masked only on the tile that holds the causal diagonal or the row's
// length; the running max and sum stay in f32 in the registers of the
// warp that owns the rows (quad shuffles); P is rounded to bf16 in
// registers and fed as the A operand of P V (the wgmma accumulator layout
// is its A layout).  Tile j's scores and tile j - 1's P V are issued
// together, and the softmax of S_j runs while the tensor cores do
// P_{j-1} V_{j-1}; S is zeroed by its first MMA and P alternates between
// two register sets, so no instruction writes a register of a wgmma in
// flight and ptxas keeps them asynchronous.  K and V are double-buffered
// by 16-byte cp.async: tile j + 1 loads while tile j multiplies, one
// barrier per tile.  Tiles above the diagonal or past the row's length
// are never loaded; keys past the length inside the last tile are
// zero-filled.  81 KB of shared memory and 222 registers a thread: two
// blocks per SM.  The grid launches the longest causal query tiles first,
// so the short ones fill the tail.  Rows must be 16-byte aligned (a
// 16-byte-aligned base and (batch, head, seq) strides that are multiples
// of 8 elements); a misaligned bf16 launch is refused.
//
// f32 (no serving path sends it; held to 1e-4 by the card tests, which
// TF32 tensor cores would not meet): the first version's body on the f32
// FMA units, ceiling 67 TFLOP/s.  One block of 256 threads per (row,
// head, 64-query tile); q, K (transposed), V and the probabilities in f32
// shared memory; each thread owns 4 query rows and dh / 16 output
// columns.
//
// Head dim 64 (MusicGen's per-group prefill): both bodies are templates
// on the head dim.  The bf16 body at dh 64 keeps the same pipeline with
// one 64-column half a tile (8 KB, 41 KB of shared memory a block):
// S = Q K^T in 4 k-steps of 16, and O += P V as m64n64k16 products;
// the f32 FMA body at dh 64 has dh / 16 = 4 output columns a thread.
//
// Both: GQA maps query head h to KV head h / (H / KV); inputs are read
// at caller-given strides with a contiguous last dim, so (B, S, H, dh)
// activations need no transpose; queries sit at the last Sq keys; a row
// with no valid key gives 0.
//
// Packed mode (bf16 only): one flat row of many segments, each a run of
// fresh tokens with its own segment id and per-token positions, after an
// optional region of cached prefix keys labelled the same way.  Key j is
// visible to query i iff both carry one id and k_pos[j] <= q_pos[i], or j
// is i's own key.  Two launches:
//
// The plan (`flash_packed_plan_kernel`), once per pack: the ids and
// positions are the same for every head and layer, so which key tiles a
// query tile visits is worked out once and read by every attention
// launch of the pack.  One block a query tile reads its 64 rows, lists
// their distinct real ids each with its rows' largest position, and its
// warps scan every key tile (two keys a lane, a few tiles' loads in
// flight, two warp votes a tile): a tile is visited where one of its keys
// is visible to a real row, or where it holds a row's own key; it is
// unmasked only where all 64 rows are real and carry one id and all 64
// keys carry that id at positions at or below every row's.  No order of
// the key slots is assumed.  The row of the plan (int32, `packed plan
// width` entries): the count, the visited tiles in ascending order, each
// flagged kPlanMasked where masked, then -1.  Bound: bytes (the ids and
// positions read once, (Sq / 64) * (Sk / 64 + 1) * 4 bytes of plan
// written); each block reads the keys' 8 * Sk bytes from L2.
//
// The attention (`flash_attention_packed_kernel`): the causal kernel's
// wgmma pipeline over the planned key tiles, warp-specialised for this
// card.  One block serves one query tile of two query heads of one GQA
// group: a producer warp keeps K and V tiles in flight by TMA
// (cp.async.bulk.tensor, the 128-byte swizzle that wgmma reads) in a
// two-stage mbarrier ring, and two consumer warpgroups, one a head, share
// every staged tile, so K and V cross from L2 once for both heads.  The
// producer holds 24 registers and the consumers 240 (setmaxnreg).  A
// masked tile's ids and positions come by TMA with its K tile, and its
// keep bits (32 a thread) are worked out while the tensor cores run the
// tile's products.  A query tile of padding only does no key work and
// writes zeros (no real query sees a padding key, and no padding row is
// read back).  The work scales with the visible pairs, sum of len *
// (len + 1) / 2 over the segments (plus prefix times fresh), not with
// Sq * Sk.
#include <cuda.h>

#include <climits>

#include "common.cuh"

namespace repro {

// ---------------------------------------------------------------------------
// f32: FMA body
// ---------------------------------------------------------------------------

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
cudaError_t set_fma_smem() {
  static std::atomic<unsigned long long> done{0};   // devices already set
  return set_smem_once(flash_attention_kernel<T, DH>, FlashSmem<DH>::kBytes,
                       done);
}

template <typename T, int DH>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int batch, int heads,
                         int kv_heads, int sq, int sk, const long long* st,
                         int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = FlashSmem<DH>::kBytes;
  cudaError_t err = set_fma_smem<T, DH>();
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

// ---------------------------------------------------------------------------
// bf16: tensor-core body (wgmma, cp.async)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;            // one warpgroup
constexpr int kBQ = 64;                  // query rows per block (wgmma M)
constexpr int kBK = 64;                  // keys per tile
constexpr int kDH = 128;
constexpr int kChunks = kDH / 8;         // 16-byte chunks per row
constexpr int kTileBytes = 64 * kDH * 2; // one 64-row bf16 tile, 16 KB
// q (then the output), two stages of K and of V, and slack to align the
// tiles to the 1024 bytes of the 128-byte swizzle pattern; the causal
// kernel at head dim DH (128, or MusicGen's 64: one 64-column half)
template <int DH>
constexpr int tile_bytes() { return 64 * DH * 2; }
template <int DH>
constexpr size_t smem_bytes() { return 5 * tile_bytes<DH>() + 1024; }
constexpr size_t kSmemBytes = smem_bytes<kDH>();
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of (row, 16-byte chunk) in a 64 x kDH tile laid out for
// wgmma's 128-byte swizzle: two 64-column halves of 8 KB, each 64 rows of
// 128 bytes whose 16-byte chunks are XORed with the row (mod 8).
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (chunk >> 3) * 8192 + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

// 16 bytes global -> shared; `bytes` 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies and make them visible to wgmma's reads
// (the async proxy); a barrier then publishes them to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x in one MUFU.EX2 (relative error about 2^-22, far below the bf16
// rounding of P; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as bf16x2, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// S (64 x 64 keys, f32) += A (64 x 16 of q, registers) * K^T, K (64 keys x
// 16 dh) read from shared memory as a K-major B operand.
__device__ __forceinline__ void wgmma_s(float (&d)[8][4],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// O (64 x 128 dh, f32) += A (64 x 16 keys of P, registers) * V, V (16 keys x
// 128 dh) read from shared memory as an MN-major (transposed) B operand.
__device__ __forceinline__ void wgmma_o(float (&d)[16][4],
    const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O (64 x 64 dh, f32) += A (64 x 16 keys of P, registers) * V, V (16 keys x
// 64 dh, one 64-column half) read from shared memory as an MN-major
// (transposed) B operand: the head dim 64 form of wgmma_o.
__device__ __forceinline__ void wgmma_o64(float (&d)[8][4],
    const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The descriptors of one K tile at shared address `kt` as the B operand
// of S = Q K^T, one per 16 dh: K-major, 8-row groups 1024 bytes apart, the
// two dh halves 8 KB apart.  Like every register a wgmma reads, they are
// set before the wgmma fence (the empty asm pins them there).
template <int DH = kDH>
__device__ __forceinline__ void k_descs(uint64_t (&d)[DH / 16],
                                        uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    d[kk] = smem_desc(kt + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
    asm volatile("" : "+l"(d[kk]));
  }
}

// The descriptors of one V tile at shared address `vt` as the B operand of
// O += P V, one per 16 keys: MN-major, the two dh halves 8 KB apart,
// 8-key groups 1024 bytes apart.
__device__ __forceinline__ void v_descs(uint64_t (&d)[kBK / 16],
                                        uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    d[kk] = smem_desc(vt + kk * 2048, 8192, 1024);
    asm volatile("" : "+l"(d[kk]));
  }
}

// S = Q K^T for one tile of 64 keys, as one wgmma group; the first step
// overwrites S (scale-d 0), so no other instruction writes S before it.
template <int DH = kDH>
__device__ __forceinline__ void scores(float (&s)[kBK / 8][4],
                                       const uint32_t (&qf)[DH / 16][4],
                                       const uint64_t (&dk)[DH / 16]) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wgmma_s(s, qf[kk], dk[kk], kk > 0);
  wgmma_commit();
}

// O += P V for one tile of 64 keys, as one wgmma group.
template <int DH = kDH>
__device__ __forceinline__ void accumulate(float (&o)[DH / 8][4],
                                           const uint32_t (&pa)[kBK / 16][4],
                                           const uint64_t (&dv)[kBK / 16]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    if constexpr (DH == 128)
      wgmma_o(o, pa[kk], dv[kk]);
    else
      wgmma_o64(o, pa[kk], dv[kk]);
  }
  wgmma_commit();
}

// The online softmax of one thread's two rows (g and g + 8 of its warp's
// 16): running max and sum in f32, in the base-2 domain of the scaled
// scores.
struct Rows {
  float m[2];
  float l[2];
  int warp_q0;     // key position of the warp's first row
  int g, tig;      // the rows g, g + 8 and columns 2 tig, 2 tig + 1
  int kv_len;      // keys at or past it are masked
  int causal;
  float scale_log2;

  // Packed mode: which of this thread's 32 scores of the tile at k0 are
  // kept, bit 4 n + e for element e of n tile n: key j is kept for row i
  // iff it has i's id and a position at or below i's, or it is i's own
  // key.  Computed from the tile's ids and positions staged in shared
  // memory while the tensor cores run the tile's products; q_seg and
  // q_pos are the block's 64 query rows' (shared memory), warp_row0 the
  // warp's first row among them.
  __device__ __forceinline__ uint32_t packed_keep(
      int k0, const int* k_seg, const int* k_pos, const int* q_seg,
      const int* q_pos, int warp_row0) const {
    const int r0 = warp_row0 + g;
    const int seg_r[2] = {q_seg[r0], q_seg[r0 + 8]};
    const int pos_r[2] = {q_pos[r0], q_pos[r0 + 8]};
    uint32_t bits = 0;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const int col = n * 8 + 2 * tig;
      const int2 ks = *reinterpret_cast<const int2*>(k_seg + col);
      const int2 kp = *reinterpret_cast<const int2*>(k_pos + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + col + (e & 1);
        const int i = e >> 1;
        const int sg = e & 1 ? ks.y : ks.x;
        const int ps = e & 1 ? kp.y : kp.x;
        const bool keep = key < kv_len &&
            ((sg == seg_r[i] && ps <= pos_r[i]) || key == warp_q0 + g + 8 * i);
        bits |= static_cast<uint32_t>(keep) << (4 * n + e);
      }
    }
    return bits;
  }

  // Scale and mask the S tile whose first key is k0, update max and sum,
  // turn S into P as bf16 A fragments and give the factor that rescales
  // the output accumulated so far.  Causal mode masks only where the tile
  // holds the diagonal or the row's length; packed mode only where the
  // block's plan marked the tile, by its keep bits (`keep`, all set on an
  // unmasked tile; `packed_keep`).
  template <bool kPacked>
  __device__ __forceinline__ void softmax(float (&s)[kBK / 8][4],
                                          uint32_t (&pa)[kBK / 16][4],
                                          float (&alpha)[2], int k0,
                                          uint32_t keep) {
    const bool edge = kPacked ? keep != ~0u
        : (causal && k0 + kBK - 1 > warp_q0) || k0 + kBK > kv_len;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          if constexpr (kPacked) {
            if (!((keep >> (4 * n + e)) & 1u)) x = neg_inf();
          } else {
            const int key = k0 + n * 8 + 2 * tig + (e & 1);
            const int qpos = warp_q0 + g + (e >> 1) * 8;   // the row's key
            if (key >= kv_len || (causal && key > qpos)) x = neg_inf();
          }
        }
        s[n][e] = x;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = neg_inf();
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == neg_inf() ? 0.f : m_new;  // all masked
      alpha[i] = fast_exp2(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        s[n][2 * i] = fast_exp2(s[n][2 * i] - base);     // masked: 0
        s[n][2 * i + 1] = fast_exp2(s[n][2 * i + 1] - base);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  }
};

// Start copying rows [row0, row0 + 64) of a (rows, DH) operand with row
// stride `stride` into a swizzled tile at shared address `tile`; rows at
// or past `limit` are zero-filled and never read.
template <int DH = kDH>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* g,
                                          long long stride, int row0,
                                          int limit) {
  constexpr int kC = DH / 8;              // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < 64 * kC / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kC, c = idx % kC;
    const int row = row0 + r;
    const bool ok = row < limit;
    const bf16* src = ok ? g + row * stride + c * 8 : g;
    cp_async_16(tile + sw128(r, c), src, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// Packed mode: the plan of visited key tiles, once per pack
// ---------------------------------------------------------------------------

constexpr int kMaxTiles = 2048;           // key tiles a packed launch holds
constexpr int kPlanMasked = 1 << 16;      // plan entry flag: mask this tile
constexpr int kPlanThreads = 256;
constexpr int kPlanBatch = 4;             // key tiles a warp loads at once

// The segment ids and positions of a packed launch (int32, 16-byte
// aligned): q_seg, q_pos (Sq,), k_seg, k_pos (Sk,).
struct Packed {
  const int* q_seg;
  const int* q_pos;
  const int* k_seg;
  const int* k_pos;
};

// Row blockIdx.x of the plan: the key tiles that query rows [q0, q0 + 64)
// visit (see the file's head for the rule and the row's layout).
__global__ void __launch_bounds__(kPlanThreads)
flash_packed_plan_kernel(Packed pk, int* __restrict__ plan, int sq, int sk,
                         int width) {
  __shared__ int row_seg[kBQ], row_pos[kBQ];
  __shared__ int ids[kBQ], tops[kBQ];    // distinct real ids, largest pos
  __shared__ int n_ids, n_real, pos_lo;
  __shared__ uint8_t flag[kMaxTiles];    // 0 skipped, 1 masked, 2 unmasked
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int n_kt = (sk + kBK - 1) / kBK;
  int* row = plan + static_cast<long long>(blockIdx.x) * width;
  if (tid == 0) {
    n_ids = 0;
    n_real = 0;
    pos_lo = INT_MAX;
  }
  if (tid < kBQ) {
    const bool in = q0 + tid < sq;
    row_seg[tid] = in ? pk.q_seg[q0 + tid] : -1;
    row_pos[tid] = in ? pk.q_pos[q0 + tid] : 0;
  }
  __syncthreads();
  if (tid < kBQ && row_seg[tid] >= 0) {  // the first row of each id lists it
    const int sg = row_seg[tid];
    int top = row_pos[tid];
    bool first = true;
    for (int r = 0; r < kBQ; ++r)
      if (row_seg[r] == sg) {
        first &= r >= tid;
        top = max(top, row_pos[r]);
      }
    atomicAdd(&n_real, 1);
    atomicMin(&pos_lo, row_pos[tid]);
    if (first) {
      const int at = atomicAdd(&n_ids, 1);
      ids[at] = sg;
      tops[at] = top;
    }
  }
  __syncthreads();
  const int nid = n_ids;
  if (nid == 0) {                        // padding rows only: no key work
    for (int i = tid; i < width; i += kPlanThreads) row[i] = i == 0 ? 0 : -1;
    return;
  }
  const bool one_id = n_real == kBQ && nid == 1;
  const int id0 = ids[0], lo = pos_lo;
  const int offset = sk - sq;             // key position of query 0
  const int diag_lo = (offset + q0) / kBK;
  const int diag_hi = (offset + min(q0 + kBQ, sq) - 1) / kBK;
  constexpr int kWarps = kPlanThreads / 32;
  for (int t0 = warp * kPlanBatch; t0 < n_kt; t0 += kWarps * kPlanBatch) {
    // lane l: keys 2l, 2l + 1 of tiles t0 .. t0 + kPlanBatch - 1, all
    // loads in flight at once; keys past sk read as padding
    int2 sg[kPlanBatch], ps[kPlanBatch];
#pragma unroll
    for (int b = 0; b < kPlanBatch; ++b) {
      const int key = (t0 + b) * kBK + 2 * lane;
      sg[b] = make_int2(-1, -1);
      ps[b] = make_int2(0, 0);
      if (key + 1 < sk) {
        sg[b] = __ldg(reinterpret_cast<const int2*>(pk.k_seg + key));
        ps[b] = __ldg(reinterpret_cast<const int2*>(pk.k_pos + key));
      } else if (key < sk) {
        sg[b].x = __ldg(pk.k_seg + key);
        ps[b].x = __ldg(pk.k_pos + key);
      }
    }
#pragma unroll
    for (int b = 0; b < kPlanBatch; ++b) {
      const int t = t0 + b;
      const int key = t * kBK + 2 * lane;
      bool seen = false;                  // ids are >= 0: padding never
      for (int i = 0; i < nid; ++i)
        seen |= (sg[b].x == ids[i] && ps[b].x <= tops[i]) ||
                (sg[b].y == ids[i] && ps[b].y <= tops[i]);
      const bool below = key + 1 < sk && sg[b].x == id0 && ps[b].x <= lo &&
                         sg[b].y == id0 && ps[b].y <= lo;
      const bool any = __any_sync(0xffffffffu, seen);
      const bool all = __all_sync(0xffffffffu, below);
      if (lane == 0 && t < n_kt) {
        const bool own = t >= diag_lo && t <= diag_hi;
        flag[t] = any || own ? (one_id && all ? 2 : 1) : 0;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {                       // compact the flags in tile order
    int n = 0;
    for (int base = 0; base < n_kt; base += 32) {
      const int t = base + lane;
      const int f = t < n_kt ? flag[t] : 0;
      const unsigned hit = __ballot_sync(0xffffffffu, f != 0);
      if (f)
        row[1 + n + __popc(hit & ((1u << lane) - 1))] =
            t | (f == 1 ? kPlanMasked : 0);
      n += __popc(hit);
    }
    if (lane == 0) row[0] = n;
    for (int i = 1 + n + lane; i < width; i += 32) row[i] = -1;
  }
}

// ---------------------------------------------------------------------------
// Packed mode: TMA, mbarriers, named barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrive on `bar` and expect `bytes` more of TMA traffic in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One TMA box of a 3-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

// Barrier `id` (1, 2: one a consumer warpgroup) over 128 threads.
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// load_tile for one warpgroup, `t` its thread (0..127).
__device__ __forceinline__ void load_tile_wg(uint32_t tile, const bf16* g,
                                             long long stride, int row0,
                                             int limit, int t) {
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int idx = t + i * 128;
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const bool ok = row < limit;
    const bf16* src = ok ? g + row * stride + c * 8 : g;
    cp_async_16(tile + sw128(r, c), src, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// The causal kernel
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int* __restrict__ lengths,
                            bf16* __restrict__ out, int heads, int kv_heads,
                            int sq, int sk, long long q_sb, long long q_sh,
                            long long q_ss, long long k_sb, long long k_sh,
                            long long k_ss, long long v_sb, long long v_sh,
                            long long v_ss, long long o_sb, long long o_sh,
                            long long o_ss, int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(tc_smem));
  const uint32_t qs = (raw + 1023) & ~1023u;    // q, then the output
  unsigned char* qs_ptr = tc_smem + (qs - raw);
  constexpr int kTile = 64 * DH * 2;            // one 64-row bf16 tile
  constexpr int kC = DH / 8;                    // 16-byte chunks a row
  const uint32_t ks = qs + kTile;               // K stages 0, 1
  const uint32_t vs = ks + 2 * kTile;           // V stages 0, 1

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // longest causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;     // fragment row group, pair
  const int kvh = h / (heads / kv_heads);
  const int q0 = qt * kBQ;
  const int offset = sk - sq;                  // key position of query 0
  const int kv_len = lengths != nullptr ? min(lengths[b], sk) : sk;
  int last_key = kv_len - 1;
  if (causal) last_key = min(last_key, offset + min(q0 + kBQ, sq) - 1);
  const int n_tiles = last_key >= 0 ? last_key / kBK + 1 : 0;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  load_tile<DH>(qs, qb, q_ss, q0, sq);
  if (n_tiles > 0) load_tile<DH>(ks, kb, k_ss, 0, kv_len);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 columns of dh
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(qs + sw128(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)),
            qf[kk]);

  // per thread: rows g and g + 8 of the warp's 16, columns 2 tig, 2 tig + 1
  // of every 8-wide n tile (the wgmma accumulator layout)
  Rows rows{{neg_inf(), neg_inf()}, {0.f, 0.f}, offset + q0 + warp * 16, g,
            tig, kv_len, causal, scale_log2};
  float o[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float s[kBK / 8][4];
  uint32_t p0[kBK / 16][4], p1[kBK / 16][4];   // P of even, odd tiles
  float alpha[2];
  uint64_t dk[DH / 16], dv[kBK / 16];

  if (n_tiles > 0) {                            // S_0 and P_0
    if (n_tiles > 1) load_tile<DH>(ks + kTile, kb, k_ss, kBK, kv_len);
    load_tile<DH>(vs, vb, v_ss, 0, kv_len);
    cp_async_commit();                          // K_1, V_0
    k_descs<DH>(dk, ks);
    wgmma_fence();
    scores<DH>(s, qf, dk);
    wgmma_wait<0>();
    fence_regs(s);
    rows.softmax<false>(s, p0, alpha, 0, ~0u);
  }
  // tile j: S_j and P_{j-1} V_{j-1} in flight together, the softmax of
  // S_j running while the tensor cores do P_{j-1} V_{j-1}.  P alternates
  // between two register sets (P_{j-1} in `p_in`, P_j into `p_out`), so
  // no instruction writes a register of the wgmma in flight.
  auto step = [&](int j, const uint32_t (&p_in)[kBK / 16][4],
                  uint32_t (&p_out)[kBK / 16][4]) {
    cp_async_wait_all();
    __syncthreads();       // K_j, V_{j-1} landed; all warps are past S_{j-1}
    if (j + 1 < n_tiles)   // and P_{j-2} V_{j-2}, whose stages these reuse
      load_tile<DH>(ks + ((j + 1) & 1) * kTile, kb, k_ss, (j + 1) * kBK,
                kv_len);
    load_tile<DH>(vs + (j & 1) * kTile, vb, v_ss, j * kBK, kv_len);
    cp_async_commit();                          // K_{j+1}, V_j
    k_descs<DH>(dk, ks + (j & 1) * kTile);
    v_descs(dv, vs + ((j - 1) & 1) * kTile);
    fence_regs(o);
    wgmma_fence();
    scores<DH>(s, qf, dk);
    accumulate<DH>(o, p_in, dv);
    wgmma_wait<1>();
    fence_regs(s);
    rows.softmax<false>(s, p_out, alpha, j * kBK, ~0u);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
  };
  // the last P V: P_{n-1} lies in p[(n - 1) & 1]
  auto last = [&](const uint32_t (&p_in)[kBK / 16][4]) {
    cp_async_wait_all();
    __syncthreads();
    v_descs(dv, vs + ((n_tiles - 1) & 1) * kTile);
    fence_regs(o);
    wgmma_fence();
    accumulate<DH>(o, p_in, dv);
    wgmma_wait<0>();
    fence_regs(o);
  };
  for (int j = 1; j < n_tiles; j += 2) {
    step(j, p0, p1);
    if (j + 1 < n_tiles) step(j + 1, p1, p0);
  }
  if (n_tiles > 0) {
    if ((n_tiles - 1) & 1)
      last(p1);
    else
      last(p0);
  }

  // normalise, stage the warp's rows in the q tile (each warp reads and
  // writes only its own 16 rows there), then 16-byte stores
  const float inv0 = 1.f / (rows.l[0] == 0.f ? 1.f : rows.l[0]);
  const float inv1 = 1.f / (rows.l[1] == 0.f ? 1.f : rows.l[1]);
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    *reinterpret_cast<uint32_t*>(qs_ptr + sw128(r0, d) + 4 * tig) =
        pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(qs_ptr + sw128(r0 + 8, d) + 4 * tig) =
        pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
  }
  __syncthreads();
  bf16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 64 * kC / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kC, c = idx % kC;
    if (q0 + r < sq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(qs_ptr + sw128(r, c));
  }
}

// The packed mode: one flat row (batch 1) of segments, queries at the
// last sq keys, over the key tiles of the pack's plan.  A body of its
// own: sharing one templated body with the causal kernel moved the causal
// kernel's instruction schedule and slowed it.
constexpr int kPkHeads = 2;                     // consumer warpgroups a block
constexpr int kPkThreads = 128 * (1 + kPkHeads);  // and the producer's
constexpr int kPkStages = 2;                    // K and V ring depth
constexpr int kIdsBytes = 2 * kBK * 4;          // a key tile's ids, positions
// shared memory, from the 1024-aligned base: q (then the output) of each
// consumer, the K and V stages, the staged ids and positions, the query
// rows' ids and positions, the plan entry of each K stage, the barriers
constexpr int kPkK = kPkHeads * kTileBytes;
constexpr int kPkV = kPkK + kPkStages * kTileBytes;
constexpr int kPkIds = kPkV + kPkStages * kTileBytes;
constexpr int kPkRows = kPkIds + kPkStages * kIdsBytes;
constexpr int kPkEntry = kPkRows + 2 * kBQ * 4;
constexpr int kPkBars = kPkEntry + 8 * kPkStages;
constexpr size_t kPkSmemBytes = kPkBars + 4 * 8 * kPkStages + 1024;

__global__ void __launch_bounds__(kPkThreads, 1)
flash_attention_packed_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_seg,
                              const __grid_constant__ CUtensorMap tm_pos,
                              const bf16* __restrict__ q,
                              bf16* __restrict__ out,
                              const int* __restrict__ q_seg,
                              const int* __restrict__ q_pos,
                              const int* __restrict__ plan, int plan_width,
                              int heads, int kv_heads, int sq, int sk,
                              long long q_sh, long long q_ss, long long o_sh,
                              long long o_ss, float scale_log2) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(tc_smem));
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_ptr = tc_smem + (base - raw);
  const uint32_t ks = base + kPkK, vs = base + kPkV, ids = base + kPkIds;
  const uint32_t full_k = base + kPkBars, empty_k = full_k + 8 * kPkStages;
  const uint32_t full_v = empty_k + 8 * kPkStages;
  const uint32_t empty_v = full_v + 8 * kPkStages;
  int* rseg = reinterpret_cast<int*>(base_ptr + kPkRows);  // the query rows'
  int* rpos = rseg + kBQ;
  int* entry = reinterpret_cast<int*>(base_ptr + kPkEntry);

  // the block's heads: kPkHeads query heads of KV head kvh (fewer where
  // the group is not a multiple of kPkHeads)
  const int group = heads / kv_heads;
  const int pairs = (group + kPkHeads - 1) / kPkHeads;
  const int kvh = blockIdx.x / pairs;
  const int head0 = kvh * group + (blockIdx.x % pairs) * kPkHeads;
  const int active = min(kPkHeads, (kvh + 1) * group - head0);
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kBQ;
  const int* prow = plan + static_cast<long long>(qt) * plan_width;
  const int n_tiles = __ldg(prow);
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPkStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 4 * active);   // one arrival a warp
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 4 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (wg == 0 && t < kBQ) {
    rseg[t] = q0 + t < sq ? q_seg[q0 + t] : -1;
    rpos[t] = q0 + t < sq ? q_pos[q0 + t] : 0;
  } else if (wg > 0 && wg <= active && n_tiles > 0) {
    load_tile_wg(base + (wg - 1) * kTileBytes, q + (head0 + wg - 1) * q_sh,
                 q_ss, q0, sq, t);
    cp_async_commit();
  }
  __syncthreads();

  if (wg == 0) {                 // the producer: one thread issues the TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (t != 0 || n_tiles == 0) return;
    int e_next = __ldg(prow + 1);
    for (int j = 0; j < n_tiles; ++j) {
      const int e = e_next;
      if (j + 1 < n_tiles) e_next = __ldg(prow + 2 + j);
      const int s = j % kPkStages, ph = (j / kPkStages) & 1;
      const int k0 = (e & (kPlanMasked - 1)) * kBK;
      const bool masked = (e & kPlanMasked) != 0;
      mbar_wait(empty_k + 8 * s, ph ^ 1);
      entry[s] = e;
      mbar_expect_tx(full_k + 8 * s, kTileBytes + (masked ? kIdsBytes : 0));
      tma_load_3d(ks + s * kTileBytes, &tm_k, 0, k0, kvh, full_k + 8 * s);
      tma_load_3d(ks + s * kTileBytes + kTileBytes / 2, &tm_k, 64, k0, kvh,
                  full_k + 8 * s);
      if (masked) {
        tma_load_1d(ids + s * kIdsBytes, &tm_seg, k0, full_k + 8 * s);
        tma_load_1d(ids + s * kIdsBytes + kBK * 4, &tm_pos, k0,
                    full_k + 8 * s);
      }
      mbar_wait(empty_v + 8 * s, ph ^ 1);
      mbar_expect_tx(full_v + 8 * s, kTileBytes);
      tma_load_3d(vs + s * kTileBytes, &tm_v, 0, k0, kvh, full_v + 8 * s);
      tma_load_3d(vs + s * kTileBytes + kTileBytes / 2, &tm_v, 64, k0, kvh,
                  full_v + 8 * s);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int w = wg - 1;
  if (w >= active) return;
  const uint32_t qs = base + w * kTileBytes;     // q, then the output
  unsigned char* qs_ptr = base_ptr + w * kTileBytes;
  bf16* ob = out + (head0 + w) * o_sh;
  if (n_tiles == 0) {            // padding rows only: no key work, zeros
#pragma unroll
    for (int i = 0; i < 64 * kChunks / 128; ++i) {
      const int idx = t + i * 128;
      const int r = idx / kChunks, c = idx % kChunks;
      if (q0 + r < sq)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * o_ss + c * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;     // fragment row group, pair
  cp_async_wait_all();
  wg_sync(1 + w);

  // this warp's 16 query rows as A fragments, one per 16 columns of dh
  uint32_t qf[kDH / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDH / 16; ++kk)
    ldsm_x4(qs + sw128(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)),
            qf[kk]);

  Rows rows{{neg_inf(), neg_inf()}, {0.f, 0.f}, (sk - sq) + q0 + warp * 16,
            g, tig, sk, 1, scale_log2};
  // the keep bits of the tile in K stage s with plan entry e: all set
  // where it is unmasked
  auto keep_bits = [&](int s, int e) -> uint32_t {
    if (!(e & kPlanMasked)) return ~0u;
    const int* kseg = reinterpret_cast<const int*>(base_ptr + kPkIds +
                                                   s * kIdsBytes);
    return rows.packed_keep((e & (kPlanMasked - 1)) * kBK, kseg, kseg + kBK,
                            rseg, rpos, warp * 16);
  };
  // hand a stage back to the producer once every lane is done with it
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float o[kDH / 8][4];
#pragma unroll
  for (int d = 0; d < kDH / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float s[kBK / 8][4];
  uint32_t p0[kBK / 16][4], p1[kBK / 16][4];   // P of even, odd tiles
  float alpha[2];
  uint64_t dk[kDH / 16], dv[kBK / 16];

  {                                             // S_0 and P_0
    mbar_wait(full_k, 0);
    const int e = entry[0];
    k_descs(dk, ks);
    wgmma_fence();
    scores(s, qf, dk);
    const uint32_t keep = keep_bits(0, e);
    wgmma_wait<0>();
    release(empty_k);
    fence_regs(s);
    rows.softmax<true>(s, p0, alpha, 0, keep);
  }
  // visited tile j: S_j and P_{j-1} V_{j-1} in flight together, the keep
  // bits worked out meanwhile, the softmax of S_j while the tensor cores
  // do P_{j-1} V_{j-1}, each stage handed back as soon as it is read
  auto step = [&](int j, const uint32_t (&p_in)[kBK / 16][4],
                  uint32_t (&p_out)[kBK / 16][4]) {
    const int sk_j = j % kPkStages, sv = (j - 1) % kPkStages;
    mbar_wait(full_k + 8 * sk_j, (j / kPkStages) & 1);
    mbar_wait(full_v + 8 * sv, ((j - 1) / kPkStages) & 1);
    const int e = entry[sk_j];
    k_descs(dk, ks + sk_j * kTileBytes);
    v_descs(dv, vs + sv * kTileBytes);
    fence_regs(o);
    wgmma_fence();
    scores(s, qf, dk);
    accumulate(o, p_in, dv);
    const uint32_t keep = keep_bits(sk_j, e);
    wgmma_wait<1>();
    release(empty_k + 8 * sk_j);
    fence_regs(s);
    rows.softmax<true>(s, p_out, alpha, 0, keep);
    wgmma_wait<0>();
    release(empty_v + 8 * sv);
    fence_regs(o);
#pragma unroll
    for (int d = 0; d < kDH / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
  };
  // the last P V: P_{n-1} lies in p[(n - 1) & 1]
  auto last = [&](const uint32_t (&p_in)[kBK / 16][4]) {
    const int sv = (n_tiles - 1) % kPkStages;
    mbar_wait(full_v + 8 * sv, ((n_tiles - 1) / kPkStages) & 1);
    v_descs(dv, vs + sv * kTileBytes);
    fence_regs(o);
    wgmma_fence();
    accumulate(o, p_in, dv);
    wgmma_wait<0>();
    fence_regs(o);
  };
  for (int j = 1; j < n_tiles; j += 2) {
    step(j, p0, p1);
    if (j + 1 < n_tiles) step(j + 1, p1, p0);
  }
  if ((n_tiles - 1) & 1)
    last(p1);
  else
    last(p0);

  // normalise, stage the warp's rows in its q tile, then 16-byte stores
  const float inv0 = 1.f / (rows.l[0] == 0.f ? 1.f : rows.l[0]);
  const float inv1 = 1.f / (rows.l[1] == 0.f ? 1.f : rows.l[1]);
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int d = 0; d < kDH / 8; ++d) {
    *reinterpret_cast<uint32_t*>(qs_ptr + sw128(r0, d) + 4 * tig) =
        pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(qs_ptr + sw128(r0 + 8, d) + 4 * tig) =
        pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
  }
  wg_sync(1 + w);
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int idx = t + i * 128;
    const int r = idx / kChunks, c = idx % kChunks;
    if (q0 + r < sq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(qs_ptr + sw128(r, c));
  }
}

template <int DH>
cudaError_t set_bf16_smem() {
  static std::atomic<unsigned long long> done{0};   // devices already set
  return set_smem_once(flash_attention_bf16_kernel<DH>, smem_bytes<DH>(),
                       done);
}

cudaError_t set_packed_smem() {
  static std::atomic<unsigned long long> done{0};   // devices already set
  return set_smem_once(flash_attention_packed_kernel, kPkSmemBytes, done);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// every row a 16-byte-aligned run of 128 elements: cp.async and the
// 16-byte output stores need it
inline bool rows_aligned(const void* q, const void* k, const void* v,
                         const void* out, const long long* st) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return false;
  return true;
}

template <int DH>
cudaError_t launch_flash_bf16(const void* q, const void* k, const void* v,
                              const void* lengths, void* out, int batch,
                              int heads, int kv_heads, int sq, int sk,
                              const long long* st, int causal, float scale,
                              cudaStream_t stream) {
  if (!rows_aligned(q, k, v, out, st)) return cudaErrorMisalignedAddress;
  cudaError_t err = set_bf16_smem<DH>();
  if (err != cudaSuccess) return err;
  dim3 grid(heads, batch, (sq + kBQ - 1) / kBQ);
  constexpr size_t smem = smem_bytes<DH>();
  flash_attention_bf16_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), heads, kv_heads, sq, sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal,
      scale * kLog2e);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, through the runtime's entry
// point query (the library links no libcuda); null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (kv_heads, rows, 128) bf16 operand read through its (head, row)
// element strides, in boxes of 64 rows by 64 columns (128 bytes) laid
// out in the 128-byte swizzle: two boxes make one K or V tile.
bool kv_map(EncodeTiled encode, CUtensorMap* map, const void* p, int rows,
            int kv_heads, long long row_stride, long long head_stride) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kDH),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(kv_heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(head_stride) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(kBK), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An (n,) int32 vector in boxes of one key tile; keys past n read as 0.
bool ids_map(EncodeTiled encode, CUtensorMap* map, const void* p, int n) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(kBK)};
  const cuuint32_t step[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, const_cast<void*>(p),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_packed_plan(const Packed& pk, int* plan, int sq, int sk,
                               int width, cudaStream_t stream) {
  if (!aligned16(pk.q_seg) || !aligned16(pk.q_pos) || !aligned16(pk.k_seg) ||
      !aligned16(pk.k_pos) || !aligned16(plan))
    return cudaErrorMisalignedAddress;
  const int n_kt = (sk + kBK - 1) / kBK;
  if (sq < 1 || sk < sq || n_kt > kMaxTiles || width < n_kt + 1 || width % 4)
    return cudaErrorInvalidValue;
  flash_packed_plan_kernel<<<(sq + kBQ - 1) / kBQ, kPlanThreads, 0, stream>>>(
      pk, plan, sq, sk, width);
  return cudaGetLastError();
}

cudaError_t launch_flash_packed(const void* q, const void* k, const void* v,
                                const Packed& pk, const int* plan, int width,
                                void* out, int heads, int kv_heads, int sq,
                                int sk, const long long* st, float scale,
                                cudaStream_t stream) {
  if (!rows_aligned(q, k, v, out, st) || !aligned16(pk.q_seg) ||
      !aligned16(pk.q_pos) || !aligned16(pk.k_seg) || !aligned16(pk.k_pos) ||
      !aligned16(plan))
    return cudaErrorMisalignedAddress;
  const int n_kt = (sk + kBK - 1) / kBK;
  if (sq < 1 || sk < sq || n_kt > kMaxTiles || width < n_kt + 1)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_k, tm_v, tm_seg, tm_pos;
  if (!kv_map(encode, &tm_k, k, sk, kv_heads, st[5], st[4]) ||
      !kv_map(encode, &tm_v, v, sk, kv_heads, st[8], st[7]) ||
      !ids_map(encode, &tm_seg, pk.k_seg, sk) ||
      !ids_map(encode, &tm_pos, pk.k_pos, sk))
    return cudaErrorInvalidValue;
  cudaError_t err = set_packed_smem();
  if (err != cudaSuccess) return err;
  const int group = heads / kv_heads;
  dim3 grid(kv_heads * ((group + kPkHeads - 1) / kPkHeads), 1,
            (sq + kBQ - 1) / kBQ);
  flash_attention_packed_kernel<<<grid, kPkThreads, kPkSmemBytes, stream>>>(
      tm_k, tm_v, tm_seg, tm_pos, static_cast<const bf16*>(q),
      static_cast<bf16*>(out), pk.q_seg, pk.q_pos, plan, width, heads,
      kv_heads, sq, sk, st[1], st[2], st[10], st[11], scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace repro

// q: (batch, heads, sq, dh), k, v: (batch, kv_heads, sk, dh) and out:
// (batch, heads, sq, dh), each addressed through its (batch, head, seq)
// element strides in `strides` (12 values: q, k, v, out) with a
// contiguous last dim; lengths: (batch,) int32 valid kv lengths, or null.
// Queries sit at the last sq key positions.  dh is 128 or 64.  bf16
// runs on the tensor cores and needs 16-byte-aligned rows
// (cudaErrorMisalignedAddress otherwise); f32 runs the FMA body.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, int batch, int heads,
                                     int kv_heads, int sq, int sk, int dh,
                                     const long long* strides, int causal,
                                     float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_DH(DH_)                                                 \
  if (dh == DH_) {                                                          \
    if (dtype == repro::kFloat32)                                           \
      return static_cast<int>(repro::launch_flash<float, DH_>(              \
          q, k, v, lengths, out, batch, heads, kv_heads, sq, sk, strides,   \
          causal, scale, s));                                               \
    if (dtype == repro::kBFloat16)                                          \
      return static_cast<int>(repro::tc::launch_flash_bf16<DH_>(            \
          q, k, v, lengths, out, batch, heads, kv_heads, sq, sk, strides,   \
          causal, scale, s));                                               \
  }
  REPRO_FLASH_DH(128)
  REPRO_FLASH_DH(64)
#undef REPRO_FLASH_DH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The packed mode's plan: q_seg, q_pos (sq,) and k_seg, k_pos (sk,)
// int32, 16-byte aligned, sq <= sk <= 2048 * 64, the segment id
// (negative: padding) and the position within the segment of each query
// and key, queries at the last sq keys; plan: (ceil(sq / 64), width)
// int32, width >= ceil(sk / 64) + 1 and a multiple of 4.  Row t: the
// count of key tiles query tile t visits, those tiles in ascending
// order (| 1 << 16 where masked), then -1.
extern "C" int repro_flash_attention_packed_plan(
    const void* q_seg, const void* q_pos, const void* k_seg,
    const void* k_pos, void* plan, int sq, int sk, int width, void* stream) {
  const repro::tc::Packed pk{static_cast<const int*>(q_seg),
                             static_cast<const int*>(q_pos),
                             static_cast<const int*>(k_seg),
                             static_cast<const int*>(k_pos)};
  return static_cast<int>(repro::tc::launch_packed_plan(
      pk, static_cast<int*>(plan), sq, sk, width,
      static_cast<cudaStream_t>(stream)));
}

// The packed mode (the JAX package's attention_packed): q (1, heads, sq,
// dh), k, v (1, kv_heads, sk, dh), out (1, heads, sq, dh), strided as
// above (the batch strides are not read); the ids and positions as for
// the plan, and the pack's plan (repro_flash_attention_packed_plan) of
// row width `width`.  Key j is visible to query i iff both carry one id
// and k_pos[j] <= q_pos[i], or j is i's own key (j - (sk - sq) == i),
// within the key tiles the plan visits.  A query tile of padding only
// gives zeros.  bf16 and dh 128 only.
extern "C" int repro_flash_attention_packed(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* q_pos, const void* k_seg, const void* k_pos,
    const void* plan, int width, void* out, int heads, int kv_heads, int sq,
    int sk, int dh, const long long* strides, float scale, int dtype,
    void* stream) {
  if (dh != 128 || dtype != repro::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const repro::tc::Packed pk{static_cast<const int*>(q_seg),
                             static_cast<const int*>(q_pos),
                             static_cast<const int*>(k_seg),
                             static_cast<const int*>(k_pos)};
  return static_cast<int>(repro::tc::launch_flash_packed(
      q, k, v, pk, static_cast<const int*>(plan), width, out, heads,
      kv_heads, sq, sk, strides, scale, static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM of the flash kernel for `dtype` and head dim
// `dh` at its launch shape (threads, dynamic shared memory), from the
// CUDA occupancy calculator; a negative CUDA error code on failure.
extern "C" int repro_flash_attention_blocks_per_sm(int dtype, int dh) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_FLASH_BLOCKS(DH_)                                             \
  if (dh == DH_ && dtype == repro::kFloat32) {                              \
    err = repro::set_fma_smem<float, DH_>();                                \
    if (err == cudaSuccess)                                                 \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                  \
          &blocks, repro::flash_attention_kernel<float, DH_>,               \
          repro::kFlashThreads, repro::FlashSmem<DH_>::kBytes);             \
  } else if (dh == DH_ && dtype == repro::kBFloat16) {                      \
    err = repro::tc::set_bf16_smem<DH_>();                                  \
    if (err == cudaSuccess)                                                 \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                  \
          &blocks, repro::tc::flash_attention_bf16_kernel<DH_>,             \
          repro::tc::kThreads, repro::tc::smem_bytes<DH_>());               \
  }
  REPRO_FLASH_BLOCKS(128)
  REPRO_FLASH_BLOCKS(64)
#undef REPRO_FLASH_BLOCKS
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The same for the packed mode's kernel.
extern "C" int repro_flash_attention_packed_blocks_per_sm() {
  int blocks = 0;
  cudaError_t err = repro::tc::set_packed_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, repro::tc::flash_attention_packed_kernel,
        repro::tc::kPkThreads, repro::tc::kPkSmemBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
