// The bf16 K/V's instantiations of the split-K decode kernel
// (flash_decode.cuh), in a translation unit of their own so they compile
// beside the f32 K/V's (flash_decode.cu).
#include "flash_decode.cuh"

namespace repro {

cudaError_t dispatch_decode_bf16kv(int q_dtype, int group, int dh,
                                   const DecodeLaunch<PagedRows>& op) {
  return dispatch_decode_kv<__nv_bfloat16>(q_dtype, group, dh, op);
}

cudaError_t dispatch_decode_bf16kv(int q_dtype, int group, int dh,
                                   const DecodeLaunch<StridedRows>& op) {
  return dispatch_decode_kv<__nv_bfloat16>(q_dtype, group, dh, op);
}

cudaError_t dispatch_decode_bf16kv(int q_dtype, int group, int dh,
                                   const DecodeOccupancy<PagedRows>& op) {
  return dispatch_decode_kv<__nv_bfloat16>(q_dtype, group, dh, op);
}

cudaError_t dispatch_decode_bf16kv(int q_dtype, int group, int dh,
                                   const DecodeOccupancy<StridedRows>& op) {
  return dispatch_decode_kv<__nv_bfloat16>(q_dtype, group, dh, op);
}

}  // namespace repro
