// Fused decode step for one layer: GQA paged attention over positions
// < seq_len - 1, the new token merged analytically as one extra key, sinks,
// then the new K/V row written in place at (dst_page, dst_off).
//
// Replaces dynamo_tpu/ops/pallas/fused_decode.py:_fused_decode_kernel.
// Bound: bytes (the live context's K and V; the append adds 2 * KH * D
// elements per sequence). Design (common.cuh): grid (S, KH, B), each split
// streams its run of page tiles through a ring of bulk copies; the last
// split of each (sequence, KV head) merges the partials, the new key and
// the sinks, and only after every split has read its tiles writes the new
// row, so no tile read races the write.
#include "common.cuh"

extern "C" int dtt_fused_decode(
    const void* q, void* k_pages, void* v_pages, const void* k_new,
    const void* v_new, const int* block_tables, const int* seq_lens,
    const int* dst_page, const int* dst_off, const float* sinks, void* out,
    float* ws, int* tickets, int S, int B, int H, int KH, int D, int page,
    int P, int num_pages, int layer, int window, float scale, int dtype,
    void* stream) {
  if (B == 0) return 0;
  const size_t layer_elems = (size_t)num_pages * KH * page * D;
  const size_t off = (size_t)layer * layer_elems * (dtype == dtt::kBF16 ? 2 : 4);
  return dtt::launch_decode_attention<true>(
      q, (char*)k_pages + off, (char*)v_pages + off, k_new, v_new,
      block_tables, seq_lens, dst_page, dst_off, sinks, out, ws, tickets, S,
      B, H, KH, D, page, P, window, scale, dtype, (cudaStream_t)stream);
}
