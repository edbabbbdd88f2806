// Split-K decode attention for Hopper: the C entry points and the f32
// K/V's instantiations.  The kernel, its design and what it replaces are
// in flash_decode.cuh; the bf16 K/V's instantiations are compiled apart,
// in flash_decode_bf16kv.cu, so the two halves build in parallel.
#include "flash_decode.cuh"

namespace repro {

// Run `op` for the instantiation that q's dtype, the K/V dtype, the group
// size and the head dim name (INSTANTIATIONS and KV_DTYPES in
// kernels/flash_decode.py).
template <typename Op>
cudaError_t dispatch_decode(int q_dtype, int kv_dtype, int group, int dh,
                            const Op& op) {
  if (kv_dtype == kFloat32)
    return dispatch_decode_kv<float>(q_dtype, group, dh, op);
  if (kv_dtype == kBFloat16)
    return dispatch_decode_bf16kv(q_dtype, group, dh, op);
  return cudaErrorInvalidValue;
}

}  // namespace repro

// q: (batch, kv_heads * group, dh); k_pool, v_pool: (NB, block_size,
// kv_heads, dh) in kv_dtype (f32 or bf16); tables: (batch, max_blocks)
// int32; lengths: (batch,) int32; part: batch * kv_heads * splits *
// group * (dh + 2) f32 scratch,
// splits = ceil(max_blocks / 8); tickets: batch * kv_heads int32, all 0
// (the kernel leaves them 0); out: (batch, heads, dh) in q's dtype (f32
// or bf16).  (group, dh) is one of those instantiated (dispatch_decode),
// and 2 * splits * group at most the ring's floats (the merge stages
// every split's max and sum there; a bf16 ring holds half an f32 one's).
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* tables,
                                  const void* lengths, void* part,
                                  void* tickets, void* out, int batch,
                                  int kv_heads, int group, int dh,
                                  int block_size, int max_blocks, int splits,
                                  float scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  if (splits * repro::kSplitBlocks < max_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::PagedRows rows{static_cast<const int*>(tables), block_size,
                        max_blocks, kv_heads};
  repro::DecodeLaunch<repro::PagedRows> op{
      q, k_pool, v_pool, rows, lengths, part, tickets, out, batch,
      kv_heads, splits, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      repro::dispatch_decode(q_dtype, kv_dtype, group, dh, op));
}

// q: (batch, kv_heads * group, dh); k, v: (batch, kv_heads, seq, dh)
// views in kv_dtype (f32 or bf16) sharing the strides (stride_b,
// stride_h, stride_s) in elements, dh unit-stride, every 16 bytes of a
// dh-vector 16-byte aligned; lengths: (batch,) int32; part, tickets and
// out as above with splits = ceil(seq / 128).  dh, group and splits as
// above.
extern "C" int repro_contiguous_decode(
    const void* q, const void* k, const void* v, const void* lengths,
    void* part, void* tickets, void* out, int batch, int kv_heads,
    int group, int dh, int seq, long long stride_b, long long stride_h,
    long long stride_s, int splits, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (splits * repro::kSplitKeys < seq)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::StridedRows rows{stride_b, stride_h, stride_s, seq};
  repro::DecodeLaunch<repro::StridedRows> op{
      q, k, v, rows, lengths, part, tickets, out, batch,
      kv_heads, splits, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      repro::dispatch_decode(q_dtype, kv_dtype, group, dh, op));
}

// Resident blocks per SM of the paged (paged != 0) or contiguous kernel
// for q's dtype, the K/V dtype, the group size and the head dim, or minus
// the CUDA error.
extern "C" int repro_flash_decode_blocks_per_sm(int q_dtype, int kv_dtype,
                                                int group, int paged,
                                                int dh) {
  int blocks = 0;
  const cudaError_t err =
      paged ? repro::dispatch_decode(
                  q_dtype, kv_dtype, group, dh,
                  repro::DecodeOccupancy<repro::PagedRows>{&blocks})
            : repro::dispatch_decode(
                  q_dtype, kv_dtype, group, dh,
                  repro::DecodeOccupancy<repro::StridedRows>{&blocks});
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Dynamic shared memory of one block at head dim dh (64 or 128) and K/V
// dtype kv_dtype: the ring of K and V stages; 0 for another dh or type.
extern "C" int repro_flash_decode_ring_bytes(int dh, int kv_dtype) {
  using repro::kRingBytesFor;
  if (kv_dtype == repro::kFloat32) {
    if (dh == 64) return static_cast<int>(kRingBytesFor<64, float>);
    if (dh == 128) return static_cast<int>(kRingBytesFor<128, float>);
  } else if (kv_dtype == repro::kBFloat16) {
    if (dh == 64) return static_cast<int>(kRingBytesFor<64, __nv_bfloat16>);
    if (dh == 128) return static_cast<int>(kRingBytesFor<128, __nv_bfloat16>);
  }
  return 0;
}
