// Read-only GQA paged decode attention over positions < seq_len (the new
// token is already in the pool), with sliding window, sinks and a softmax
// scale. One block per (sequence, KV head); see common.cuh.
//
// Replaces dynamo_tpu/ops/pallas/paged_attention_v3.py:_decode_kernel_v3.
#include "common.cuh"

extern "C" int dtt_paged_attention_v3(
    const void* q, const void* k_layer, const void* v_layer,
    const int* block_tables, const int* seq_lens, const float* sinks,
    void* out, int B, int H, int KH, int D, int page, int P, int window,
    float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  return dtt::launch_decode_attention<false>(
      q, const_cast<void*>(k_layer), const_cast<void*>(v_layer), nullptr,
      nullptr, block_tables, seq_lens, nullptr, nullptr, sinks, out, B, H, KH,
      D, page, P, window, scale, dtype, (cudaStream_t)stream);
}
