// Fused decode step for one layer: GQA paged attention over positions
// < seq_len - 1, the new token merged analytically as one extra key, sinks,
// then the new K/V row written in place at (dst_page, dst_off).
//
// Replaces dynamo_tpu/ops/pallas/fused_decode.py:_fused_decode_kernel, both
// branches: plain pools (f32, bf16) and fp8 e4m3 pools with per-(page, KV
// head) bf16 scales, where tiles dequantize on use and the append is a
// requantizing read-modify-write of the head's run of the destination page
// and its scale (common.cuh). Bound: bytes (the live context's K and V;
// the append adds 2 * KH * D elements per sequence, a page run at fp8).
// Design (common.cuh): grid (S, KH, B), each split streams its run of page
// tiles through a ring of bulk copies; the last split of each (sequence,
// KV head) merges the partials, the new key and the sinks, and only after
// every split has read its tiles writes the new row, so no tile read races
// the write.
#include "common.cuh"

// k_scale / v_scale: [L, num_pages, KH] bf16 when pool_dtype is fp8, else
// null; q, k_new, v_new and out are of q_dtype.
extern "C" int dtt_fused_decode(
    const void* q, void* k_pages, void* v_pages, void* k_scale,
    void* v_scale, const void* k_new, const void* v_new,
    const int* block_tables, const int* seq_lens, const int* dst_page,
    const int* dst_off, const float* sinks, void* out, float* ws,
    int* tickets, int S, int B, int H, int KH, int D, int page, int P,
    int num_pages, int layer, int window, float scale, int q_dtype,
    int pool_dtype, void* stream) {
  if (B == 0) return 0;
  const size_t layer_elems = (size_t)num_pages * KH * page * D;
  const size_t el = pool_dtype == dtt::kFP8 ? 1 : pool_dtype == dtt::kBF16 ? 2 : 4;
  const size_t off = (size_t)layer * layer_elems * el;
  const size_t s_off = (size_t)layer * num_pages * KH * 2;  // bf16 scales
  char* ks = k_scale ? (char*)k_scale + s_off : nullptr;
  char* vs = v_scale ? (char*)v_scale + s_off : nullptr;
  return dtt::launch_decode_attention<true>(
      q, (char*)k_pages + off, (char*)v_pages + off, ks, vs, k_new, v_new,
      block_tables, seq_lens, dst_page, dst_off, sinks, out, ws, tickets, S,
      B, H, KH, D, page, P, window, scale, q_dtype, pool_dtype,
      (cudaStream_t)stream);
}
