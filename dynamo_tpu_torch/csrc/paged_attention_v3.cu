// Read-only GQA paged decode attention over positions < seq_len (the new
// token is already in the pool), with sliding window, sinks and a softmax
// scale.
//
// Replaces dynamo_tpu/ops/pallas/paged_attention_v3.py:_decode_kernel_v3.
// Bound: bytes (2 * KH * D pool elements per live token, about one flop
// per byte). Design (common.cuh): grid (S, KH, B), each split streams its
// run of page tiles through a ring of bulk copies kept in flight, and the
// last split of each (sequence, KV head) merges the partials and the sinks
// in the same launch.
#include "common.cuh"

extern "C" int dtt_paged_attention_v3(
    const void* q, const void* k_layer, const void* v_layer,
    const int* block_tables, const int* seq_lens, const float* sinks,
    void* out, float* ws, int* tickets, int S, int B, int H, int KH, int D,
    int page, int P, int window, float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  return dtt::launch_decode_attention<false>(
      q, const_cast<void*>(k_layer), const_cast<void*>(v_layer), nullptr,
      nullptr, block_tables, seq_lens, nullptr, nullptr, sinks, out, ws,
      tickets, S, B, H, KH, D, page, P, window, scale, dtype,
      (cudaStream_t)stream);
}
