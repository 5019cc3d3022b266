// Read-only GQA paged decode attention over positions < seq_len (the new
// token is already in the pool), with sliding window, sinks and a softmax
// scale.
//
// Replaces dynamo_tpu/ops/pallas/paged_attention_v3.py:_decode_kernel_v3,
// both branches: plain pools (f32, bf16) and fp8 e4m3 pools whose page
// tiles dequantize on use by per-(page, KV head) bf16 scales.
// Bound: bytes (2 * KH * D pool elements per live token, about one flop
// per byte at bf16, two at fp8). Design (common.cuh): grid (S, KH, B), each
// split streams its run of page tiles through a ring of bulk copies kept in
// flight, and the last split of each (sequence, KV head) merges the
// partials and the sinks in the same launch.
#include "common.cuh"

// k_scale / v_scale: one layer's [num_pages, KH] bf16 scales when
// pool_dtype is fp8, else null.
extern "C" int dtt_paged_attention_v3(
    const void* q, const void* k_layer, const void* v_layer,
    const void* k_scale, const void* v_scale, const int* block_tables,
    const int* seq_lens, const float* sinks, void* out, float* ws,
    int* tickets, int S, int B, int H, int KH, int D, int page, int P,
    int window, float scale, int q_dtype, int pool_dtype, void* stream) {
  if (B == 0) return 0;
  return dtt::launch_decode_attention<false>(
      q, const_cast<void*>(k_layer), const_cast<void*>(v_layer),
      const_cast<void*>(k_scale), const_cast<void*>(v_scale), nullptr,
      nullptr, block_tables, seq_lens, nullptr, nullptr, sinks, out, ws,
      tickets, S, B, H, KH, D, page, P, window, scale, q_dtype, pool_dtype,
      (cudaStream_t)stream);
}
