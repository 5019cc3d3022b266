// Shared device helpers for the paged decode kernels (sm_90a).
//
// The pools are PAGE-MAJOR: [L, num_pages, KH, PAGE, D], one page of one
// layer being one contiguous [KH, PAGE, D] block. Page 0 is the trash page.
// Element types: float (dtype code 0) and __nv_bfloat16 (dtype code 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// finite "minus infinity" (the TPU kernels' NEG_INF): masked scores stay
// finite, so exp(NEG_INF - m) underflows to 0 instead of producing NaN
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a bf16 cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy `n` elements (a multiple of 16 bytes, 16-byte aligned) with 16-byte
// vector loads/stores, spread over the block's threads.
template <typename T>
__device__ __forceinline__ void copy_vec(T* __restrict__ dst,
                                         const T* __restrict__ src, int n) {
  const int nv = n * (int)sizeof(T) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) d[i] = s[i];
}

// Load one [PAGE, D] tile of T into shared memory as f32, 16 bytes per
// thread per load (neighbouring threads on neighbouring addresses).
template <typename T, int PAGE, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = PAGE * D / kVec;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < kChunks; i += blockDim.x) {
    uint4 raw = s[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) dst[i * kVec + u] = to_f<T>(e[u]);
  }
}

// GQA paged decode attention for one (sequence, KV head) per block; warp g
// of the block serves query head kh * G + g, so blockDim.x == 32 * G.
//
// Keys read from the pool: positions in [lo, ctx), where ctx = seq_len
// (read-only form: the new token is already in the pool) or seq_len - 1
// (FUSED: the new token (k_new, v_new) merges analytically as one extra
// key, then its row is written to (dst_page, dst_off) of the layer).
// lo = seq_len - window with a sliding window, else 0. Only pages below
// ceil(ctx / PAGE) are read, so the trash page, where inactive slots
// write, is never read for a live row. Sinks add exp(sink) to the softmax
// denominator only. f32 online softmax throughout.
//
// Race freedom of the FUSED write: no block reads the row being written
// (reads stop at seq_len - 2), other blocks of the same sequence own other
// heads, and sequences never share a tail page.
template <typename T, int PAGE, int D, bool FUSED>
__global__ void __launch_bounds__(512)
    decode_attention_kernel(const T* __restrict__ q,  // [B, H, D]
                            T* k_layer,               // [NP, KH, PAGE, D]
                            T* v_layer,
                            const T* __restrict__ k_new,  // [B, KH, D]
                            const T* __restrict__ v_new,
                            const int* __restrict__ block_tables,  // [B, P]
                            const int* __restrict__ seq_lens,      // [B]
                            const int* __restrict__ dst_page,      // [B]
                            const int* __restrict__ dst_off,       // [B]
                            const float* __restrict__ sinks,  // [H] or null
                            T* __restrict__ out,              // [B, H, D]
                            int KH, int G, int P, int window, float scale) {
  constexpr int kDpl = D / 32;  // head dims per lane: d = lane + 32 * j
  __shared__ float k_tile[PAGE * D];
  __shared__ float v_tile[PAGE * D];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int H = KH * G;
  const int h = kh * G + g;
  const int seq_len = seq_lens[b];
  const int ctx = FUSED ? seq_len - 1 : seq_len;
  const int lo = window > 0 ? max(seq_len - window, 0) : 0;

  // the query, pre-scaled and rounded to T exactly as the TPU wrapper does
  float qv[kDpl];
  const T* qrow = q + ((size_t)b * H + h) * D;
#pragma unroll
  for (int j = 0; j < kDpl; ++j)
    qv[j] = to_f<T>(from_f<T>(to_f<T>(qrow[lane + 32 * j]) * scale));

  float m = kNegInf, l = 0.f;
  float acc[kDpl];
#pragma unroll
  for (int j = 0; j < kDpl; ++j) acc[j] = 0.f;

  const size_t page_stride = (size_t)KH * PAGE * D;
  const size_t head_off = (size_t)kh * PAGE * D;
  const int n_pages = (ctx + PAGE - 1) / PAGE;
  for (int p = lo / PAGE; p < n_pages; ++p) {
    const size_t base = (size_t)block_tables[(size_t)b * P + p] * page_stride;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, PAGE, D>(k_tile, k_layer + base + head_off);
    load_tile<T, PAGE, D>(v_tile, v_layer + base + head_off);
    __syncthreads();

    float s[PAGE];
    float pm = kNegInf;
#pragma unroll
    for (int t = 0; t < PAGE; ++t) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kDpl; ++j) part += qv[j] * k_tile[t * D + lane + 32 * j];
      part = warp_sum(part);
      const int pos = p * PAGE + t;
      s[t] = (pos >= lo && pos < ctx) ? part : kNegInf;
      pm = fmaxf(pm, s[t]);
    }
    const float m_new = fmaxf(m, pm);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc[j] *= alpha;
#pragma unroll
    for (int t = 0; t < PAGE; ++t) {
      const int pos = p * PAGE + t;
      if (pos >= lo && pos < ctx) {  // masked rows may hold non-finite junk
        const float pt = expf(s[t] - m_new);
        l += pt;
#pragma unroll
        for (int j = 0; j < kDpl; ++j) acc[j] += pt * v_tile[t * D + lane + 32 * j];
      }
    }
    m = m_new;
  }

  if (FUSED) {
    // the new token as one more key: score q.k_new, value v_new. The
    // decode query sits at the new token, so it is always visible.
    const T* kn = k_new + ((size_t)b * KH + kh) * D;
    const T* vn = v_new + ((size_t)b * KH + kh) * D;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) part += qv[j] * to_f<T>(kn[lane + 32 * j]);
    const float s_new = warp_sum(part);
    const float m_f = fmaxf(m, s_new);
    const float alpha = expf(m - m_f);
    const float p_new = expf(s_new - m_f);
    l = l * alpha + p_new;
#pragma unroll
    for (int j = 0; j < kDpl; ++j)
      acc[j] = acc[j] * alpha + p_new * to_f<T>(vn[lane + 32 * j]);
    m = m_f;
  }
  if (sinks != nullptr) {
    // a virtual key with value 0: exp(sink) joins the denominator only
    const float sink = sinks[h];
    const float m_s = fmaxf(m, sink);
    const float c = expf(m - m_s);
    l = l * c + expf(sink - m_s);
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc[j] *= c;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + ((size_t)b * H + h) * D;
#pragma unroll
  for (int j = 0; j < kDpl; ++j) orow[lane + 32 * j] = from_f<T>(acc[j] * inv);

  if (FUSED) {
    // land this head's new KV row in place
    const size_t row = (size_t)dst_page[b] * page_stride + head_off +
                       (size_t)dst_off[b] * D;
    const size_t src = ((size_t)b * KH + kh) * D;
    copy_vec<T>(k_layer + row, k_new + src, D);
    copy_vec<T>(v_layer + row, v_new + src, D);
  }
}

// Host-side launcher shared by the two attention entry points.
template <bool FUSED>
inline int launch_decode_attention(
    const void* q, void* k_layer, void* v_layer, const void* k_new,
    const void* v_new, const int* block_tables, const int* seq_lens,
    const int* dst_page, const int* dst_off, const float* sinks, void* out,
    int B, int H, int KH, int D, int page, int P, int window, float scale,
    int dtype, cudaStream_t stream) {
  const int G = H / KH;
  if (page != 16 || (D != 64 && D != 128) || G < 1 || G > 16 || H % KH)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, KH), block(32 * G);
#define DTT_LAUNCH(T, DD)                                                  \
  decode_attention_kernel<T, 16, DD, FUSED><<<grid, block, 0, stream>>>(   \
      (const T*)q, (T*)k_layer, (T*)v_layer, (const T*)k_new,              \
      (const T*)v_new, block_tables, seq_lens, dst_page, dst_off, sinks,   \
      (T*)out, KH, G, P, window, scale)
  if (dtype == kBF16) {
    if (D == 128) DTT_LAUNCH(__nv_bfloat16, 128);
    else DTT_LAUNCH(__nv_bfloat16, 64);
  } else if (dtype == kF32) {
    if (D == 128) DTT_LAUNCH(float, 128);
    else DTT_LAUNCH(float, 64);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DTT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace dtt
