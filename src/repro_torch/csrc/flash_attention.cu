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
// Both: GQA maps query head h to KV head h / (H / KV); inputs are read
// at caller-given strides with a contiguous last dim, so (B, S, H, dh)
// activations need no transpose; queries sit at the last Sq keys; a row
// with no valid key gives 0.
//
// Packed mode (bf16 only): one flat row of many segments, each a run of
// fresh tokens with its own segment id and per-token positions, after an
// optional region of cached prefix keys labelled the same way.  Key j is
// visible to query i iff both carry one id and k_pos[j] <= q_pos[i], or j
// is i's own key.  The wgmma body is the causal one; what changes is
// which key tiles a query tile visits and where it masks.  Each block
// first plans: it reads its 64 query rows' ids and positions, then its
// warps scan every key tile's 64 ids and positions (coalesced loads, two
// warp votes a tile) and the block keeps, in order, every tile whose
// keys meet the query rows' range of ids at or below their largest
// position, or that holds a query row's own key.  The work so scales
// with the visible pairs, sum of len * (len + 1) / 2 over the segments
// (plus prefix times fresh), not with Sq * Sk; the scan itself reads
// 8 * Sk bytes a block from L2.  A visited tile is masked unless every
// key and every query row of it carry one id and every key position is at
// or below every query position, so a segment boundary inside a tile
// takes the masked path.
// A masked tile's keep bits (32 a thread) are worked out from its ids and
// positions, staged in shared memory by cp.async with its K tile, while
// the tensor cores run the tile's products.  A query tile of padding only does
// no key work and writes zeros (no real query sees a padding key, and no
// padding row is read back).  The plan and the staged ids take 7.5 KB of
// shared memory on top of the causal kernel's 81 KB, and ptxas gives the
// mode 255 registers a thread: still two blocks per SM.
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
// tiles to the 1024 bytes of the 128-byte swizzle pattern
constexpr size_t kSmemBytes = 5 * kTileBytes + 1024;
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The descriptors of one K tile at shared address `kt` as the B operand
// of S = Q K^T, one per 16 dh: K-major, 8-row groups 1024 bytes apart, the
// two dh halves 8 KB apart.  Like every register a wgmma reads, they are
// set before the wgmma fence (the empty asm pins them there).
__device__ __forceinline__ void k_descs(uint64_t (&d)[kDH / 16],
                                        uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < kDH / 16; ++kk) {
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
__device__ __forceinline__ void scores(float (&s)[kBK / 8][4],
                                       const uint32_t (&qf)[kDH / 16][4],
                                       const uint64_t (&dk)[kDH / 16]) {
#pragma unroll
  for (int kk = 0; kk < kDH / 16; ++kk) wgmma_s(s, qf[kk], dk[kk], kk > 0);
  wgmma_commit();
}

// O += P V for one tile of 64 keys, as one wgmma group.
__device__ __forceinline__ void accumulate(float (&o)[kDH / 8][4],
                                           const uint32_t (&pa)[kBK / 16][4],
                                           const uint64_t (&dv)[kBK / 16]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) wgmma_o(o, pa[kk], dv[kk]);
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

// Start copying rows [row0, row0 + 64) of a (rows, kDH) operand with row
// stride `stride` into a swizzled tile at shared address `tile`; rows at
// or past `limit` are zero-filled and never read.
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* g,
                                          long long stride, int row0,
                                          int limit) {
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const bool ok = row < limit;
    const bf16* src = ok ? g + row * stride + c * 8 : g;
    cp_async_16(tile + sw128(r, c), src, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// Packed mode: the plan of visited key tiles
// ---------------------------------------------------------------------------

constexpr int kMaxTiles = 2048;             // key tiles a packed launch holds
constexpr uint16_t kMaskedTile = 0x8000;    // plan entry: mask this tile
constexpr int kScanBatch = 32;              // key tiles a warp scans at once

// The segment ids and positions of a packed launch (int32, 16-byte
// aligned): q_seg, q_pos (Sq,), k_seg, k_pos (Sk,).
struct Packed {
  const int* q_seg;
  const int* q_pos;
  const int* k_seg;
  const int* k_pos;
};

// Packed mode's shared memory after the five tiles: the ids and positions
// of the two staged key tiles (staged with K) and of the block's query
// rows, and the plan.
struct PackedSmem {
  int k_seg[2][kBK];
  int k_pos[2][kBK];
  int q_seg[kBQ];
  int q_pos[kBQ];
  int tiles;                 // visited tiles
  uint16_t list[kMaxTiles];  // visited key tiles in order, kMaskedTile flagged
  uint8_t flag[kMaxTiles];   // per key tile: 0 skipped, 1 masked, 2 unmasked
};
constexpr size_t kPackedSmemBytes = kSmemBytes + sizeof(PackedSmem);

// Which key tiles the block's query rows [q0, q0 + 64) visit, worked out
// from the ids and positions themselves, so no order of the key slots is
// assumed.  A tile is visited when one of its keys can be seen by a query
// row: its id lies in the rows' [min, max] of real ids and its position
// is at or below the largest position of the rows with that id (exact
// for the lowest and highest id, the rows' largest position for any id
// between), or when it holds a query row's own key (the self-key rule).
// It is left unmasked only when every key in it and every query row carry
// one id and every key's position is at or below every query's.
//
// Each warp loads the query rows and the ids and positions of its first
// kScanBatch tiles at once (16-byte loads, two tiles a load), and reduces
// the rows itself (warp reductions): a global round trip takes
// microseconds beside the co-resident block's traffic, so the plan makes
// one (two past 8192 keys), and one barrier.  Two ballots flag two tiles,
// and warp 0 compacts the flags in tile order.  Returns the number of
// visited tiles: 0 when the query rows are all padding.
__device__ int plan_tiles(PackedSmem& p, const Packed& pk, int q0, int sq,
                          int sk, int offset) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_tiles = (sk + kBK - 1) / kBK;
  // step i of a batch: lane l holds keys 4l .. 4l + 3 of tiles t0 + 2i
  // and t0 + 2i + 1 (lanes 0-15 the first, 16-31 the second): one 16-byte
  // load of ids and one of positions, 512 contiguous bytes a warp
  int4 seg[kScanBatch / 2], pos[kScanBatch / 2];
  auto fetch = [&](int t0) {       // keys past sk read as padding
#pragma unroll
    for (int i = 0; i < kScanBatch / 2; ++i) {
      const int key = (t0 + 2 * i) * kBK + 4 * lane;
      seg[i] = make_int4(-1, -1, -1, -1);
      pos[i] = make_int4(0, 0, 0, 0);
      if (key + 3 < sk) {
        seg[i] = __ldg(reinterpret_cast<const int4*>(pk.k_seg + key));
        pos[i] = __ldg(reinterpret_cast<const int4*>(pk.k_pos + key));
      } else {                     // the last, partial run of keys
        if (key < sk) {
          seg[i].x = __ldg(pk.k_seg + key);
          pos[i].x = __ldg(pk.k_pos + key);
        }
        if (key + 1 < sk) {
          seg[i].y = __ldg(pk.k_seg + key + 1);
          pos[i].y = __ldg(pk.k_pos + key + 1);
        }
        if (key + 2 < sk) {
          seg[i].z = __ldg(pk.k_seg + key + 2);
          pos[i].z = __ldg(pk.k_pos + key + 2);
        }
      }
    }
  };
  // every warp summarises the query rows itself (lane l: rows l, l + 32),
  // so no barrier stands between the summary and the votes
  int s[2], ps[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + lane + 32 * i;
    s[i] = r < sq ? pk.q_seg[r] : -1;
    ps[i] = r < sq ? pk.q_pos[r] : 0;
  }
  int t0 = (tid >> 5) * kScanBatch;
  fetch(t0);
  if (tid < 32) {                  // warp 0 keeps the rows for the masks
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      p.q_seg[lane + 32 * i] = s[i];
      p.q_pos[lane + 32 * i] = ps[i];
    }
  }
  const bool real0 = s[0] >= 0, real1 = s[1] >= 0;
  const int real = __reduce_add_sync(0xffffffffu, int(real0) + int(real1));
  if (real == 0) return 0;
  const int id_lo = __reduce_min_sync(0xffffffffu,
      min(real0 ? s[0] : INT_MAX, real1 ? s[1] : INT_MAX));
  const int id_hi = __reduce_max_sync(0xffffffffu, max(s[0], s[1]));
  const int pos_lo = __reduce_min_sync(0xffffffffu,
      min(real0 ? ps[0] : INT_MAX, real1 ? ps[1] : INT_MAX));
  const int pos_hi = __reduce_max_sync(0xffffffffu,
      max(real0 ? ps[0] : INT_MIN, real1 ? ps[1] : INT_MIN));
  const int pos_hi_lo = __reduce_max_sync(0xffffffffu,
      max(real0 && s[0] == id_lo ? ps[0] : INT_MIN,
          real1 && s[1] == id_lo ? ps[1] : INT_MIN));
  const int pos_hi_hi = __reduce_max_sync(0xffffffffu,
      max(real0 && s[0] == id_hi ? ps[0] : INT_MIN,
          real1 && s[1] == id_hi ? ps[1] : INT_MIN));
  const bool one_id = real == kBQ && id_lo == id_hi;
  const int diag_lo = (offset + q0) / kBK;
  const int diag_hi = (offset + min(q0 + kBQ, sq) - 1) / kBK;
  auto meets = [&](int sg, int ps) {
    const int top = sg == id_lo ? pos_hi_lo : sg == id_hi ? pos_hi_hi : pos_hi;
    return sg >= id_lo && sg <= id_hi && ps <= top;
  };
  auto below = [&](int sg, int ps) { return sg == id_lo && ps <= pos_lo; };
  for (;;) {
#pragma unroll
    for (int i = 0; i < kScanBatch / 2; ++i) {
      const int4 sg = seg[i], ps = pos[i];
      const bool any = meets(sg.x, ps.x) || meets(sg.y, ps.y) ||
                       meets(sg.z, ps.z) || meets(sg.w, ps.w);
      const bool all = below(sg.x, ps.x) && below(sg.y, ps.y) &&
                       below(sg.z, ps.z) && below(sg.w, ps.w);
      const unsigned any_bits = __ballot_sync(0xffffffffu, any);
      const unsigned all_bits = __ballot_sync(0xffffffffu, all);
      if (lane < 2) {              // lane h flags tile t0 + 2i + h
        const int t = t0 + 2 * i + lane;
        const unsigned half = lane ? 0xffff0000u : 0x0000ffffu;
        if (t < n_tiles) {
          const bool own = t >= diag_lo && t <= diag_hi;
          const bool full = one_id && (all_bits & half) == half;
          p.flag[t] = (any_bits & half) || own ? (full ? 2 : 1) : 0;
        }
      }
    }
    t0 += kThreads / 32 * kScanBatch;
    if (t0 >= n_tiles) break;
    fetch(t0);
  }
  __syncthreads();
  if (tid < 32) {
    int n = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int t = base + tid;
      const int f = t < n_tiles ? p.flag[t] : 0;
      const unsigned hit = __ballot_sync(0xffffffffu, f != 0);
      if (f)
        p.list[n + __popc(hit & ((1u << tid) - 1))] =
            static_cast<uint16_t>(t | (f == 1 ? kMaskedTile : 0));
      n += __popc(hit);
    }
    if (tid == 0) p.tiles = n;
  }
  __syncthreads();
  return p.tiles;
}

// Start copying the ids and positions of the key tile at k0 to shared
// addresses `seg` and `pos` (16 chunks of 16 bytes each); keys at or past
// sk are zero-filled and masked by the softmax.
__device__ __forceinline__ void load_ids(uint32_t seg, uint32_t pos,
                                         const Packed& pk, int k0, int sk) {
  if (threadIdx.x < 2 * kBK / 4) {
    const int c = threadIdx.x & (kBK / 4 - 1);
    const bool ids = threadIdx.x < kBK / 4;
    const int* src = ids ? pk.k_seg : pk.k_pos;
    const int key = k0 + 4 * c;
    const int bytes = 4 * max(0, min(4, sk - key));
    cp_async_16((ids ? seg : pos) + 16 * c, bytes ? src + key : src, bytes);
  }
}

// ---------------------------------------------------------------------------
// The causal kernel, and the packed mode's (the same wgmma pipeline)
// ---------------------------------------------------------------------------

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
  const uint32_t ks = qs + kTileBytes;          // K stages 0, 1
  const uint32_t vs = ks + 2 * kTileBytes;      // V stages 0, 1

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

  load_tile(qs, qb, q_ss, q0, sq);
  if (n_tiles > 0) load_tile(ks, kb, k_ss, 0, kv_len);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 columns of dh
  uint32_t qf[kDH / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDH / 16; ++kk)
    ldsm_x4(qs + sw128(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)),
            qf[kk]);

  // per thread: rows g and g + 8 of the warp's 16, columns 2 tig, 2 tig + 1
  // of every 8-wide n tile (the wgmma accumulator layout)
  Rows rows{{neg_inf(), neg_inf()}, {0.f, 0.f}, offset + q0 + warp * 16, g,
            tig, kv_len, causal, scale_log2};
  float o[kDH / 8][4];
#pragma unroll
  for (int d = 0; d < kDH / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float s[kBK / 8][4];
  uint32_t p0[kBK / 16][4], p1[kBK / 16][4];   // P of even, odd tiles
  float alpha[2];
  uint64_t dk[kDH / 16], dv[kBK / 16];

  if (n_tiles > 0) {                            // S_0 and P_0
    if (n_tiles > 1) load_tile(ks + kTileBytes, kb, k_ss, kBK, kv_len);
    load_tile(vs, vb, v_ss, 0, kv_len);
    cp_async_commit();                          // K_1, V_0
    k_descs(dk, ks);
    wgmma_fence();
    scores(s, qf, dk);
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
      load_tile(ks + ((j + 1) & 1) * kTileBytes, kb, k_ss, (j + 1) * kBK,
                kv_len);
    load_tile(vs + (j & 1) * kTileBytes, vb, v_ss, j * kBK, kv_len);
    cp_async_commit();                          // K_{j+1}, V_j
    k_descs(dk, ks + (j & 1) * kTileBytes);
    v_descs(dv, vs + ((j - 1) & 1) * kTileBytes);
    fence_regs(o);
    wgmma_fence();
    scores(s, qf, dk);
    accumulate(o, p_in, dv);
    wgmma_wait<1>();
    fence_regs(s);
    rows.softmax<false>(s, p_out, alpha, j * kBK, ~0u);
    wgmma_wait<0>();
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
    cp_async_wait_all();
    __syncthreads();
    v_descs(dv, vs + ((n_tiles - 1) & 1) * kTileBytes);
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
  for (int d = 0; d < kDH / 8; ++d) {
    *reinterpret_cast<uint32_t*>(qs_ptr + sw128(r0, d) + 4 * tig) =
        pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(qs_ptr + sw128(r0 + 8, d) + 4 * tig) =
        pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
  }
  __syncthreads();
  bf16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    if (q0 + r < sq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(qs_ptr + sw128(r, c));
  }
}

// The packed mode: one flat row (batch 1) of segments, queries at the
// last sq keys.  The causal kernel's pipeline over the planned key tiles,
// in a body of its own: sharing one templated body moved the causal
// kernel's instruction schedule and slowed it.
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_packed_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ out, int heads,
                              int kv_heads, int sq, int sk, long long q_sh,
                              long long q_ss, long long k_sh, long long k_ss,
                              long long v_sh, long long v_ss, long long o_sh,
                              long long o_ss, float scale_log2, Packed pk) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(tc_smem));
  const uint32_t qs = (raw + 1023) & ~1023u;    // q, then the output
  unsigned char* qs_ptr = tc_smem + (qs - raw);
  const uint32_t ks = qs + kTileBytes;          // K stages 0, 1
  const uint32_t vs = ks + 2 * kTileBytes;      // V stages 0, 1
  const uint32_t ids = vs + 2 * kTileBytes;     // the PackedSmem
  PackedSmem* plan = reinterpret_cast<PackedSmem*>(qs_ptr + 5 * kTileBytes);

  const int h = blockIdx.x;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;     // fragment row group, pair
  const int kvh = h / (heads / kv_heads);
  const int q0 = qt * kBQ;
  const int offset = sk - sq;                  // key position of query 0

  const bf16* qb = q + h * q_sh;
  const bf16* kb = k + kvh * k_sh;
  const bf16* vb = v + kvh * v_sh;

  load_tile(qs, qb, q_ss, q0, sq);
  cp_async_commit();                 // q lands while the plan is made
  const int n_tiles = plan_tiles(*plan, pk, q0, sq, sk, offset);
  if (n_tiles == 0) {                // padding rows only: no key work, zeros
    bf16* ob = out + h * o_sh;
    cp_async_wait_all();
#pragma unroll
    for (int i = 0; i < 64 * kChunks / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kChunks, c = idx % kChunks;
      if (q0 + r < sq)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * o_ss + c * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  // the j-th visited key tile: its first key, and whether it is masked
  auto tile_k0 = [&](int j) { return (plan->list[j] & ~kMaskedTile) * kBK; };
  auto tile_masked = [&](int j) {
    return (plan->list[j] & kMaskedTile) != 0;
  };
  // K of visited tile j and its ids and positions into stage j & 1
  auto load_keys = [&](int j) {
    const int st = j & 1;
    load_tile(ks + st * kTileBytes, kb, k_ss, tile_k0(j), sk);
    load_ids(ids + st * kBK * 4, ids + (2 + st) * kBK * 4, pk, tile_k0(j),
             sk);
  };
  load_keys(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 columns of dh
  uint32_t qf[kDH / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDH / 16; ++kk)
    ldsm_x4(qs + sw128(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)),
            qf[kk]);

  Rows rows{{neg_inf(), neg_inf()}, {0.f, 0.f}, offset + q0 + warp * 16, g,
            tig, sk, 1, scale_log2};
  // visited tile j's keep bits, all set where it is unmasked
  auto keep_bits = [&](int j) -> uint32_t {
    return tile_masked(j) ? rows.packed_keep(tile_k0(j), plan->k_seg[j & 1],
                                             plan->k_pos[j & 1], plan->q_seg,
                                             plan->q_pos, warp * 16)
                          : ~0u;
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
    if (n_tiles > 1) load_keys(1);
    load_tile(vs, vb, v_ss, tile_k0(0), sk);
    cp_async_commit();                          // K_1, V_0
    k_descs(dk, ks);
    wgmma_fence();
    scores(s, qf, dk);
    const uint32_t keep = keep_bits(0);
    wgmma_wait<0>();
    fence_regs(s);
    rows.softmax<true>(s, p0, alpha, tile_k0(0), keep);
  }
  // tile j as in the causal kernel, the keep bits worked out while the
  // tensor cores run S_j and P_{j-1} V_{j-1}
  auto step = [&](int j, const uint32_t (&p_in)[kBK / 16][4],
                  uint32_t (&p_out)[kBK / 16][4]) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) load_keys(j + 1);
    load_tile(vs + (j & 1) * kTileBytes, vb, v_ss, tile_k0(j), sk);
    cp_async_commit();                          // K_{j+1}, V_j
    k_descs(dk, ks + (j & 1) * kTileBytes);
    v_descs(dv, vs + ((j - 1) & 1) * kTileBytes);
    fence_regs(o);
    wgmma_fence();
    scores(s, qf, dk);
    accumulate(o, p_in, dv);
    const uint32_t keep = keep_bits(j);
    wgmma_wait<1>();
    fence_regs(s);
    rows.softmax<true>(s, p_out, alpha, tile_k0(j), keep);
    wgmma_wait<0>();
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
    cp_async_wait_all();
    __syncthreads();
    v_descs(dv, vs + ((n_tiles - 1) & 1) * kTileBytes);
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

  // normalise, stage the warp's rows in the q tile, then 16-byte stores
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
  __syncthreads();
  bf16* ob = out + h * o_sh;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    if (q0 + r < sq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(qs_ptr + sw128(r, c));
  }
}

cudaError_t set_bf16_smem() {
  static std::atomic<unsigned long long> done{0};   // devices already set
  return set_smem_once(flash_attention_bf16_kernel, kSmemBytes, done);
}

cudaError_t set_packed_smem() {
  static std::atomic<unsigned long long> done{0};   // devices already set
  return set_smem_once(flash_attention_packed_kernel, kPackedSmemBytes, done);
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

cudaError_t launch_flash_bf16(const void* q, const void* k, const void* v,
                              const void* lengths, void* out, int batch,
                              int heads, int kv_heads, int sq, int sk,
                              const long long* st, int causal, float scale,
                              cudaStream_t stream) {
  if (!rows_aligned(q, k, v, out, st)) return cudaErrorMisalignedAddress;
  cudaError_t err = set_bf16_smem();
  if (err != cudaSuccess) return err;
  dim3 grid(heads, batch, (sq + kBQ - 1) / kBQ);
  flash_attention_bf16_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), heads, kv_heads, sq, sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal,
      scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_flash_packed(const void* q, const void* k, const void* v,
                                const Packed& pk, void* out, int heads,
                                int kv_heads, int sq, int sk,
                                const long long* st, float scale,
                                cudaStream_t stream) {
  if (!rows_aligned(q, k, v, out, st) || !aligned16(pk.q_seg) ||
      !aligned16(pk.q_pos) || !aligned16(pk.k_seg) || !aligned16(pk.k_pos))
    return cudaErrorMisalignedAddress;
  if (sk < sq || (sk + kBK - 1) / kBK > kMaxTiles) return cudaErrorInvalidValue;
  cudaError_t err = set_packed_smem();
  if (err != cudaSuccess) return err;
  dim3 grid(heads, 1, (sq + kBQ - 1) / kBQ);
  flash_attention_packed_kernel<<<grid, kThreads, kPackedSmemBytes,
                                  stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), heads, kv_heads,
      sq, sk, st[1], st[2], st[4], st[5], st[7], st[8], st[10], st[11],
      scale * kLog2e, pk);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace repro

// q: (batch, heads, sq, dh), k, v: (batch, kv_heads, sk, dh) and out:
// (batch, heads, sq, dh), each addressed through its (batch, head, seq)
// element strides in `strides` (12 values: q, k, v, out) with a
// contiguous last dim; lengths: (batch,) int32 valid kv lengths, or null.
// Queries sit at the last sq key positions.  dh is 128, the model's.
// bf16 runs on the tensor cores and needs 16-byte-aligned rows
// (cudaErrorMisalignedAddress otherwise); f32 runs the FMA body.
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
    return static_cast<int>(repro::tc::launch_flash_bf16(
        q, k, v, lengths, out, batch, heads, kv_heads, sq, sk, strides,
        causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The packed mode (the JAX package's attention_packed): q (1, heads, sq,
// dh), k, v (1, kv_heads, sk, dh) with sq <= sk <= 2048 * 64, out (1,
// heads, sq, dh), strided as above (the batch strides are not read);
// q_seg, q_pos (sq,) and k_seg, k_pos (sk,) int32, 16-byte aligned, the
// segment id (negative: padding) and the position within the segment of
// each query and key.  Key j is visible to query i iff both carry one id
// and k_pos[j] <= q_pos[i], or j is i's own key (j - (sk - sq) == i).  A
// query tile of padding only gives zeros.  bf16 and dh 128 only.
extern "C" int repro_flash_attention_packed(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* q_pos, const void* k_seg, const void* k_pos, void* out,
    int heads, int kv_heads, int sq, int sk, int dh,
    const long long* strides, float scale, int dtype, void* stream) {
  if (dh != 128 || dtype != repro::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const repro::tc::Packed pk{static_cast<const int*>(q_seg),
                             static_cast<const int*>(q_pos),
                             static_cast<const int*>(k_seg),
                             static_cast<const int*>(k_pos)};
  return static_cast<int>(repro::tc::launch_flash_packed(
      q, k, v, pk, out, heads, kv_heads, sq, sk, strides, scale,
      static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM of the flash kernel for `dtype` at its launch
// shape (threads, dynamic shared memory), from the CUDA occupancy
// calculator; a negative CUDA error code on failure.
extern "C" int repro_flash_attention_blocks_per_sm(int dtype) {
  int blocks = 0;
  cudaError_t err;
  if (dtype == repro::kFloat32) {
    err = repro::set_fma_smem<float, 128>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, repro::flash_attention_kernel<float, 128>,
          repro::kFlashThreads, repro::FlashSmem<128>::kBytes);
  } else if (dtype == repro::kBFloat16) {
    err = repro::tc::set_bf16_smem();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, repro::tc::flash_attention_bf16_kernel,
        repro::tc::kThreads, repro::tc::kSmemBytes);
  } else {
    err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The same for the packed mode's kernel.
extern "C" int repro_flash_attention_packed_blocks_per_sm() {
  int blocks = 0;
  cudaError_t err = repro::tc::set_packed_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, repro::tc::flash_attention_packed_kernel,
        repro::tc::kThreads, repro::tc::kPackedSmemBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
