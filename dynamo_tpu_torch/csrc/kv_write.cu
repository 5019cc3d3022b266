// Token KV append into the paged pool: row n of k_new/v_new [N, KH, D]
// lands at (layer, dst_page[n], :, dst_off[n], :) of the pools
// [L, num_pages, KH, page, D], in place, K and V in one launch.
//
// Replaces dynamo_tpu/ops/pallas/kv_write.py:_kv_write_kernel and, on an
// fp8 pool, the reference's requantizing append that its dispatcher
// write_new_kv sends a QuantPool to (dynamo_tpu/ops/quant.py
// quant_append_rows), landed position by position as its verify forward
// does (dynamo_tpu/models/llama.py verify_forward).
//
// bf16 / f32 pools: one block per row; its threads store the row's KH * D
// elements with 16-byte vector stores. Duplicate writes to trash page 0
// race and leave garbage there by contract. Bound: the row bytes; at 8 to
// 72 rows the launch itself sets the time.
//
// fp8 pools (e4m3 values [L, num_pages, KH, page, D], one bf16 scale per
// (layer, page, KV head) [L, num_pages, KH]): an append rewrites its whole
// page run. For each row, in ascending n among the rows on its page:
//   old = 0 if dst_off == 0 (a fresh page), else the page's scale;
//   new = bf16_rne(max(old, amax|row| / 448));
//   the run's values re-encode by old / new, the row quantizes by new,
//   each value clipped to +-448 and cast once to e4m3 (round to nearest
//   even, IEEE divisions): ops/quant.py quant_append_rows on that page.
// The run goes back to e4m3 after every step, as the reference's
// one-call-per-position loop leaves it, so rows of a verify that share a
// page (n = slot * W + w) get the reference's bits from one launch.
// Rows of different pages are independent; rows on trash page 0 are
// skipped.
//
// Grid (N, KH, 2): block (n, kh, K or V). A block whose row is not the
// first in index order to target its page leaves at once (one pass over
// dst_page[0, n), no host sync, same-page rows need not be adjacent). The
// first one owns the (page, kh) run: page * D / 16 threads, each holding
// 16 neighbouring e4m3 values in registers; the run, its scale and the
// indices it needs are loaded in one trip. It walks dst_page[n, N) 32 rows
// at a time: a warp ballot marks the window's rows on the page and their
// head-kh rows are staged in shared memory; a warp per row takes the
// amaxes; one thread runs the serial part, the chain of scales and
// old / new factors (two divisions a row); then each thread finishes its
// values on its own: the last marked row at its token quantized (the
// steps before it are overwritten), then one e4m3 re-encode per later
// row. So a verify's serial work per page is its scale chain, not W
// passes over the run. The run and the scale are written back once.
// Bound: bytes, each touched run read and written once (2 KB + 2 KB at
// page 16, D 128) plus the rows; a launch moves ~1 MB at a verify's
// shape, so latency (three trips to memory) sets its time.
#include "common.cuh"

namespace dtt {

template <typename T>
__global__ void kv_write_kernel(T* __restrict__ k_pages, T* __restrict__ v_pages,
                                const T* __restrict__ k_new,
                                const T* __restrict__ v_new,
                                const int* __restrict__ dst_page,
                                const int* __restrict__ dst_off, int layer,
                                int num_pages, int KH, int page, int D) {
  const int n = blockIdx.x;
  const size_t row_elems = (size_t)KH * D;
  const size_t page_elems = (size_t)KH * page * D;
  const size_t page_base =
      ((size_t)layer * num_pages + (size_t)dst_page[n]) * page_elems;
  const size_t off = (size_t)dst_off[n] * D;
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = (int)(row_elems / kVec);
  const uint4* ks = reinterpret_cast<const uint4*>(k_new + n * row_elems);
  const uint4* vs = reinterpret_cast<const uint4*>(v_new + n * row_elems);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int kh = i * kVec / D;  // D % kVec == 0: a chunk never spans heads
    const int d = i * kVec % D;
    const size_t dst = page_base + (size_t)kh * page * D + off + d;
    *reinterpret_cast<uint4*>(k_pages + dst) = ks[i];
    *reinterpret_cast<uint4*>(v_pages + dst) = vs[i];
  }
}

constexpr int kWindow = 32;  // rows scanned (and staged) per ballot

template <typename T>
__global__ void kv_append_fp8_kernel(
    __nv_fp8_e4m3* __restrict__ k_vals, __nv_fp8_e4m3* __restrict__ v_vals,
    __nv_bfloat16* __restrict__ k_scale, __nv_bfloat16* __restrict__ v_scale,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ dst_page, const int* __restrict__ dst_off,
    int N, int layer, int num_pages, int KH, int page, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rows_s = reinterpret_cast<T*>(smem);  // [kWindow, D]: head kh of the window's rows
  __shared__ int off_s[kWindow];
  __shared__ float amax_s[kWindow], ns_s[kWindow], fac_s[kWindow];
  const int n = blockIdx.x, kh = blockIdx.y, kv = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = dst_page[n];
  if (p == 0) return;  // trash page: garbage by contract

  // everything that needs only p is loaded in one trip: the run (16 e4m3
  // values per thread), its scale, the first window's indices and the
  // earlier rows' pages
  __nv_bfloat16* scales = kv ? v_scale : k_scale;
  const T* rows = kv ? v_new : k_new;
  const size_t si = ((size_t)layer * num_pages + p) * KH + kh;
  uint4* run = reinterpret_cast<uint4*>((kv ? v_vals : k_vals) + si * page * D) + tid;
  const uint4 w4 = *run;
  float cur = __bfloat162float(scales[si]);
  int j = n + lane;
  bool hit = j < N && dst_page[j] == p;
  int off_j = j < N ? dst_off[j] : 0;
  bool earlier = false;
  for (int m = tid; m < n; m += blockDim.x) earlier |= dst_page[m] == p;
  if (__syncthreads_or(earlier)) return;  // an earlier row's block owns p

  uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
  const int tok = tid * 16 / D, d0 = tid * 16 - tok * D;
  constexpr int kVec = 16 / sizeof(T);
  const int row_vecs = D / kVec;
  auto reencode = [&](float fac) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 a = fp8x2_to_float2((uint16_t)(w[q] & 0xffffu));
      const float2 c = fp8x2_to_float2((uint16_t)(w[q] >> 16));
      w[q] = f32_to_fp8(__fmul_rn(a.x, fac)) | (f32_to_fp8(__fmul_rn(a.y, fac)) << 8) |
             (f32_to_fp8(__fmul_rn(c.x, fac)) << 16) |
             (f32_to_fp8(__fmul_rn(c.y, fac)) << 24);
    }
  };

  for (int base = n; base < N; base += kWindow) {
    if (base != n) {
      j = base + lane;
      hit = j < N && dst_page[j] == p;
      off_j = j < N ? dst_off[j] : 0;
    }
    // every warp reads the same indices: the mask is uniform over the block
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask == 0) continue;
    __syncthreads();  // the last window is done with the shared arrays
    for (int i = tid; i < kWindow * row_vecs; i += blockDim.x) {
      const int b = i / row_vecs, c = i - b * row_vecs;
      if (mask >> b & 1u)
        reinterpret_cast<uint4*>(rows_s + b * D)[c] = reinterpret_cast<const uint4*>(
            rows + ((size_t)(base + b) * KH + kh) * D)[c];
    }
    if (warp == 0) off_s[lane] = off_j;
    __syncthreads();
    // each marked row's amax, a warp per row
    for (int b = warp; b < kWindow; b += blockDim.x >> 5) {
      if (!(mask >> b & 1u)) continue;
      const T* row = rows_s + b * D;
      float amax = 0.f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f<T>(row[d])));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) amax_s[b] = amax;
    }
    __syncthreads();
    // the scale after each row, in index order; a fresh page (dst_off 0)
    // starts from scale 0, never its last occupant's
    if (tid == 0) {
      for (unsigned m = mask; m; m &= m - 1) {
        const int b = __ffs(m) - 1;
        const float old = off_s[b] == 0 ? 0.f : cur;
        const float ns = __bfloat162float(
            __float2bfloat16_rn(fmaxf(old, __fdiv_rn(amax_s[b], kFp8Max))));
        ns_s[b] = ns;
        fac_s[b] = ns > 0.f ? __fdiv_rn(old, fmaxf(ns, kTiny)) : 0.f;
        cur = ns;
      }
    }
    __syncthreads();
    cur = ns_s[31 - __clz(mask)];
    // this thread's values after the window: the last marked row at its
    // token (if any) quantized, then re-encoded by every later row's step;
    // steps before that row are overwritten, so they need not run
    unsigned mine = 0;
    for (unsigned m = mask; m; m &= m - 1)
      if (off_s[__ffs(m) - 1] == tok) mine |= m & (0u - m);
    unsigned later = mask;
    if (mine) {
      const int b = 31 - __clz(mine);
      const float ns = ns_s[b];
      const T* src = rows_s + b * D + d0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = f32_to_fp8(quant_value(to_f<T>(src[4 * q]), ns)) |
               (f32_to_fp8(quant_value(to_f<T>(src[4 * q + 1]), ns)) << 8) |
               (f32_to_fp8(quant_value(to_f<T>(src[4 * q + 2]), ns)) << 16) |
               (f32_to_fp8(quant_value(to_f<T>(src[4 * q + 3]), ns)) << 24);
      later = b == 31 ? 0u : mask & ~((2u << b) - 1u);
    }
    for (unsigned m = later; m; m &= m - 1) reencode(fac_s[__ffs(m) - 1]);
  }
  *run = make_uint4(w[0], w[1], w[2], w[3]);
  if (tid == 0) scales[si] = __float2bfloat16_rn(cur);
}

}  // namespace dtt

// `dtype` is the new rows' type (kF32, kBF16); `ptype` the pools' (dtype,
// or kFP8 with the [L, num_pages, KH] bf16 scales in k_scale / v_scale,
// which are null otherwise).
extern "C" int dtt_kv_write(void* k_pages, void* v_pages, void* k_scale,
                            void* v_scale, const void* k_new, const void* v_new,
                            const int* dst_page, const int* dst_off, int n,
                            int layer, int num_pages, int kh, int page, int d,
                            int dtype, int ptype, void* stream) {
  if (n == 0) return 0;
  const int elem = dtype == dtt::kBF16 ? 2 : 4;
  if ((dtype != dtt::kBF16 && dtype != dtt::kF32) || (d * elem) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ptype == dtt::kFP8) {
    // a thread holds 16 values of one token; whole warps; rows staged in
    // at most 48 KB
    const int threads = page * d / 16;
    const size_t smem = (size_t)dtt::kWindow * d * elem;  // + 512 B static
    if (k_scale == nullptr || v_scale == nullptr || d % 16 || threads % 32 ||
        threads > 1024 || smem > 47 * 1024 || kh > 65535)
      return (int)cudaErrorInvalidValue;
    const dim3 grid(n, kh, 2);
    if (dtype == dtt::kBF16) {
      dtt::kv_append_fp8_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
          (__nv_fp8_e4m3*)k_pages, (__nv_fp8_e4m3*)v_pages,
          (__nv_bfloat16*)k_scale, (__nv_bfloat16*)v_scale,
          (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, dst_page,
          dst_off, n, layer, num_pages, kh, page, d);
    } else {
      dtt::kv_append_fp8_kernel<float><<<grid, threads, smem, s>>>(
          (__nv_fp8_e4m3*)k_pages, (__nv_fp8_e4m3*)v_pages,
          (__nv_bfloat16*)k_scale, (__nv_bfloat16*)v_scale, (const float*)k_new,
          (const float*)v_new, dst_page, dst_off, n, layer, num_pages, kh, page,
          d);
    }
    return (int)cudaGetLastError();
  }
  if (ptype != dtype || k_scale != nullptr || v_scale != nullptr)
    return (int)cudaErrorInvalidValue;
  const int threads = ((kh * d * elem / 16) + 31) / 32 * 32;
  const int block = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  if (dtype == dtt::kBF16) {
    dtt::kv_write_kernel<__nv_bfloat16><<<n, block, 0, s>>>(
        (__nv_bfloat16*)k_pages, (__nv_bfloat16*)v_pages,
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, dst_page,
        dst_off, layer, num_pages, kh, page, d);
  } else {
    dtt::kv_write_kernel<float><<<n, block, 0, s>>>(
        (float*)k_pages, (float*)v_pages, (const float*)k_new,
        (const float*)v_new, dst_page, dst_off, layer, num_pages, kh, page, d);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
