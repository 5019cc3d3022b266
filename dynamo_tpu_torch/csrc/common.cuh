// Shared device code of the paged decode kernels (sm_90a).
//
// The pools are PAGE-MAJOR: [L, num_pages, KH, PAGE, D], one page of one
// layer being one contiguous [KH, PAGE, D] block, so one KV head's page is
// one contiguous PAGE * D run. Page 0 is the trash page. The query, the
// output and the new K/V rows share one element type T: float (code 0) or
// __nv_bfloat16 (code 1). The pools' element type TP is T, or
// __nv_fp8_e4m3 (code 2) for an fp8 KV cache, which has one bf16 scale per
// (layer, page, KV head) beside it, [L, num_pages, KH]: a value is
// e4m3 * scale.
//
// decode_attention_kernel below serves both attention entry points:
// dtt_fused_decode (fused_decode.cu, FUSED = true), which replaces
// dynamo_tpu/ops/pallas/fused_decode.py:_fused_decode_kernel, and
// dtt_paged_attention_v3 (paged_attention_v3.cu, FUSED = false), which
// replaces dynamo_tpu/ops/pallas/paged_attention_v3.py:_decode_kernel_v3.
//
// Bound on the H100: bytes. Each live context token costs 2 * KH * D pool
// elements (K and V) against 4 * H * D flops: about one flop per byte at
// bf16, far below the ~295 the card needs before tensor cores set the
// pace. At B=8 and a 512-token context one layer reads 16.8 MB, 5.0 us at
// 3.35 TB/s. The design therefore aims at keeping bytes moving:
//
// * Split context ("flash-decoding"). Grid (S_grid, KH, B). The host picks
//   S_grid so that B * KH * S_grid covers the SMs about twice (at most
//   kMaxSplits). In the kernel, (sequence b, KV head kh) cuts its live page
//   range [lo / PAGE, ceil(ctx / PAGE)), from seq_lens[b], into S =
//   min(S_grid, max(live pages / kMinSplitPages, 1)) near-equal runs;
//   split s walks run s, and splits s >= S exit at once. So the host never
//   reads seq_lens, the launch can be captured in a CUDA graph, and a short
//   context takes one split however large S_grid is. With no live page the
//   one split records an empty partial (m = kNegInf, l = 0, acc = 0).
// * Loads that do not need seq_lens[b] (the query, the new K/V rows, the
//   sinks) are issued together with it and staged in shared memory, so a
//   launch waits on one round trip to memory before it asks for tiles.
// * A ring of page tiles kept in flight (64 KB: 8 stages at bf16 D 128).
//   Each stage holds one head's K and V page tiles in T (not widened),
//   filled by two 1-D bulk copies (cp.async.bulk ... mbarrier::
//   complete_tx) that a producer warp starts, refilling a stage as soon as
//   its consumer releases it on a second mbarrier.
// * Four consumer warps, each owning whole tiles (tile i goes to warp
//   i % 4), so the tile loop has no block-wide barrier. Scores: lane owns
//   D / 32 neighbouring head dims of all 16 tokens of the tile (a warp
//   reads each K row whole, free of bank conflicts) against the query
//   (pre-scaled, rounded to T, kept in f32 in shared memory), for the
//   group's heads 4 at a time; a 5-step butterfly reduce-scatter of the
//   64 partial dot products leaves lane l the scores of token l / 2 for two
//   heads. So the query is read once per tile rather than once per token.
//   f32 online softmax per warp and head over the tile's 16 tokens. P.V:
//   lane owns head dims 2 * lane + 64 j and the next one for all G heads.
//   Block size is 160 for every G in 1..16 and D in {64, 128}.
// * Combine in the same launch. The block merges its four warps' partials
//   in shared memory. With S == 1 it finishes the head there. Otherwise
//   every split writes its partial (acc[G, D], m, l) in f32 to the
//   workspace [B, KH, S_grid, G, D + 2], then __threadfence() and an atomicAdd
//   on the (b, kh) ticket. The last split to arrive merges the partials
//   (loads independent across splits and heads). Then (FUSED) the new token
//   merges as one extra key, then the sinks; the head is normalised and
//   written out; the ticket is reset to 0 for the next launch or graph
//   replay; and only then (FUSED) the new K/V row lands at (dst_page,
//   dst_off).
//
// fp8 pools (TP = __nv_fp8_e4m3): each consumer warp loads its next
// tile's two scales, scale[block_tables[b, p], kh], while it works on the
// current one, and dequantizes on use (e4m3 -> f16 -> f32 is exact, then
// times the scale: the plain version's dequantized value). The FUSED append
// is then a read-modify-write of the whole PAGE x D run of (dst_page, kh)
// and its scale, the same arithmetic as ops/quant.py quant_append_rows:
// new scale = bf16_rne(max(old, amax|row| / 448)) (old = 0 when dst_off is
// 0: a fresh page), old rows times old / new, the new row divided by the
// new scale, each clipped to +-448 and cast once, round to nearest even
// (cvt.rn.satfinite; IEEE divisions, no fast math).
//
// Race freedom of the FUSED write: the row lies at position seq_len - 1,
// on the tail page, which a split reads as a whole tile (with its two
// scales). The last-arriving split writes after every split of its (b, kh)
// has taken its ticket, and a split takes its ticket only after its last
// tile has landed in shared memory and been read, and after every scale it
// loaded has been used; so no read of the head's run or of its scale
// overlaps the write, whether it rewrites one row (bf16, f32) or the whole
// run and the scale (fp8). With S == 1 the one block writes after a
// block-wide barrier that follows its last tile; the spare splits read
// nothing. Other blocks of the sequence serve other KV heads, whose runs
// and scales are disjoint, and sequences never share a tail page. Inactive
// slots all write trash page 0, concurrently: garbage there by contract,
// every access in bounds.
//
// Keys read from the pool: positions in [lo, ctx), ctx = seq_len
// (read-only form: the new token is already in the pool) or seq_len - 1
// (FUSED: the new token (k_new, v_new) merges analytically as one extra
// key). lo = seq_len - window with a sliding window, else 0. Only pages
// below ceil(ctx / PAGE) are read, so the trash page, where inactive slots
// write, is never read for a live row. Masked rows of a tile are skipped
// by selection, never multiplied by a zero weight, so junk (even NaN) in a
// masked slot cannot leak. Sinks add exp(sink) to the denominator only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dtt {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kFP8 = 2;  // pools only: __nv_fp8_e4m3 values + bf16 scales

constexpr float kFp8Max = 448.f;  // e4m3 max finite (ops/quant.py FP8_MAX)
constexpr float kTiny = 1e-30f;   // division guard (ops/quant.py _TINY)

template <typename TP>
__host__ __device__ constexpr bool is_fp8() {
  return std::is_same<TP, __nv_fp8_e4m3>::value;
}

// finite "minus infinity" (the TPU kernels' NEG_INF): masked scores stay
// finite, so exp(NEG_INF - m) underflows to 0 instead of producing NaN
constexpr float kNegInf = -1e30f;

constexpr int kPage = 16;      // tokens per page (the only page size)
constexpr int kWarps = 4;      // consumer warps per block
constexpr int kBlock = 32 * (kWarps + 1);  // and one producer warp
constexpr int kMaxSplits = 64;  // S <= kMaxSplits (ops/cuda: MAX_SPLITS)
// a context is split only into runs of at least this many pages (two
// tiles per consumer warp): below it the cross-split merge costs more
// than the tiles it spreads
constexpr int kMinSplitPages = 2 * kWarps;

// shared memory given to the ring of page tiles per block; the ring holds
// 4, 8, 12 or 16 stages of one head's K and V page tiles (of the pool's
// element type TP: 16 stages at fp8): a multiple of
// the consumer warps, so stage i % stages is always consumed by warp
// i % kWarps, which waits on its phases strictly in turn (a parity wait
// can then never mistake an older completed phase for the awaited one)
constexpr int kRingBytes = 64 * 1024;
template <typename TP, int D>
__host__ __device__ constexpr int ring_stages() {
  constexpr int n = kRingBytes / (2 * kPage * D * (int)sizeof(TP));
  return n < kWarps ? kWarps : n > 4 * kWarps ? 4 * kWarps : n / kWarps * kWarps;
}

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

// two neighbouring e4m3 values (low byte first) as floats: exact, since
// every e4m3 value is an f16
__device__ __forceinline__ float2 fp8x2_to_float2(uint16_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)v, __NV_E4M3);
  return __half22float2(__half2(h));
}

// clip to +-448 (a NaN stays NaN, as torch.clamp keeps it), then one
// round-to-nearest-even cast f32 -> e4m3
__device__ __forceinline__ uint32_t f32_to_fp8(float x) {
  x = x < -kFp8Max ? -kFp8Max : (x > kFp8Max ? kFp8Max : x);
  return (uint32_t)__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

// ops/quant.py quant_values for one element (f32, before the clip)
__device__ __forceinline__ float quant_value(float x, float scale) {
  return scale > 0.f ? __fdiv_rn(x, fmaxf(scale, kTiny)) : 0.f;
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

// ---- mbarrier and 1-D bulk copy (PTX, sm_90) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// two neighbouring elements of T as floats
template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <>
__device__ __forceinline__ float2 load2<__nv_fp8_e4m3>(const __nv_fp8_e4m3* p) {
  return fp8x2_to_float2(*reinterpret_cast<const uint16_t*>(p));
}

// N (2 or 4) neighbouring elements of T as floats
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&f)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 elements");
  if constexpr (is_fp8<T>()) {
    if constexpr (N == 4) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
      const float2 a = fp8x2_to_float2((uint16_t)(v & 0xffffu));
      const float2 c = fp8x2_to_float2((uint16_t)(v >> 16));
      f[0] = a.x, f[1] = a.y, f[2] = c.x, f[3] = c.y;
    } else {
      const float2 a = load2<T>(p);
      f[0] = a.x, f[1] = a.y;
    }
  } else if constexpr (sizeof(T) == 4) {
    if constexpr (N == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      f[0] = v.x, f[1] = v.y;
    }
  } else {
    const float2 a = load2<T>(p);
    f[0] = a.x, f[1] = a.y;
    if constexpr (N == 4) {
      const float2 c = load2<T>(p + 2);
      f[2] = c.x, f[3] = c.y;
    }
  }
}

// Butterfly reduce-scatter of 64 per-lane values over the warp: each step
// halves the values a lane holds, keeping the half that lane bit
// log2(HALF) - 1 selects and adding its partner's copy of that half. After
// the five steps v[0..1] of lane l hold the warp sums of entries
// 2 l, 2 l + 1 (lane bits 4..0 select entry bits 5..1).
template <int HALF>
__device__ __forceinline__ void reduce_scatter(float (&v)[64], int lane) {
  constexpr int kMask = HALF / 2;
  const bool up = (lane & kMask) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = up ? v[j] : v[j + HALF];
    const float keep = up ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
  }
  if constexpr (HALF > 2) reduce_scatter<HALF / 2>(v, lane);
}

// ---- dynamic shared memory of one block (byte offsets) ----

struct SmemPlan {
  int q;      // [G, D] f32: the pre-scaled query
  int nv;     // [2, D] f32: the new K and V rows (FUSED)
  int sink;   // [G] f32: the sinks
  int p;      // [kWarps, G, PAGE] f32: each warp's tile probabilities
  int snew;   // [G] f32: the new token's scores (FUSED)
  int ml;     // [2, G] f32: merged max and denominator
  int rq;     // [4] f32: (FUSED, fp8) new scale and old / new, K then V
  int dst;    // [2] int: (FUSED, fp8) dst_page[b], dst_off[b]
  int bars;   // [2, stages] mbarriers: tile landed, then tile released
  int flag;   // int: this block is the last split of its (b, kh)
  int total;
};

// The ring sits at offset 0. Once every tile is consumed, the block reuses
// it for the warps' partials [kWarps, G, D + 2] f32 and then for the
// splits' maxima, weights and denominators [2, S, G] f32; ring_stages
// keeps it large enough for both.
template <typename TP, int D>
__host__ __device__ inline SmemPlan smem_plan(int G) {
  constexpr int kStages = ring_stages<TP, D>();
  SmemPlan p;
  int off = kStages * 2 * kPage * D * (int)sizeof(TP);  // K and V stages
  p.q = off;
  off += G * D * 4;
  p.nv = off;
  off += 2 * D * 4;
  p.sink = off;
  off += (G + 3) / 4 * 16;  // the tile probabilities are read as float4
  p.p = off;
  off += kWarps * G * kPage * 4;
  p.snew = off;
  off += G * 4;
  p.ml = off;
  off += 2 * G * 4;
  p.rq = off;
  off += 4 * 4;
  p.dst = off;
  off += 2 * 4;
  off = (off + 7) / 8 * 8;
  p.bars = off;
  off += 2 * kStages * 8;
  p.flag = off;
  off += 16;
  p.total = off;
  return p;
}

// acc[g][*] += P[g] . V over one tile, for lane's head dims (2 * lane + 64 j
// and the next one). MASKED selects the rows in [t_lo, t_hi): junk in a
// masked row never meets a zero weight. fp8 tiles dequantize by `sv`.
template <typename TP, int D, int GB, bool MASKED>
__device__ __forceinline__ void tile_pv(float (&acc)[GB][D / 32],
                                        const TP* __restrict__ vt,
                                        const float* __restrict__ pw, int G,
                                        int lane, int t_lo, int t_hi, float sv) {
  constexpr int kPairs = D / 64;
#pragma unroll
  for (int t4 = 0; t4 < kPage / 4; ++t4) {
    float2 vf[4][kPairs];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = 4 * t4 + u;
      const bool ok = !MASKED || (t >= t_lo && t < t_hi);
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        float2 v = load2<TP>(vt + t * D + 2 * lane + 64 * j);
        if constexpr (is_fp8<TP>()) v = make_float2(v.x * sv, v.y * sv);
        vf[u][j] = ok ? v : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        const float4 pp = reinterpret_cast<const float4*>(pw + g * kPage)[t4];
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          acc[g][2 * j] += pp.x * vf[0][j].x + pp.y * vf[1][j].x +
                           pp.z * vf[2][j].x + pp.w * vf[3][j].x;
          acc[g][2 * j + 1] += pp.x * vf[0][j].y + pp.y * vf[1][j].y +
                               pp.z * vf[2][j].y + pp.w * vf[3][j].y;
        }
      }
    }
  }
}

// GQA paged decode attention, split context with an in-launch combine; see
// the notes at the top of this file. GB >= G is the compile-time bound of
// the group size (4 or 16); threads hold per-head state for GB heads. T is
// the query / output / new-row type, TP the pools' (T, or e4m3 with scales).
template <typename T, typename TP, int D, int GB, bool FUSED>
__global__ void __launch_bounds__(kBlock, GB <= 4 ? 3 : 2)
    decode_attention_kernel(const T* __restrict__ q,  // [B, H, D]
                            TP* k_layer,              // [NP, KH, PAGE, D]
                            TP* v_layer,
                            __nv_bfloat16* k_scale,  // [NP, KH] (fp8) or null
                            __nv_bfloat16* v_scale,
                            const T* __restrict__ k_new,  // [B, KH, D]
                            const T* __restrict__ v_new,
                            const int* __restrict__ block_tables,  // [B, P]
                            const int* __restrict__ seq_lens,      // [B]
                            const int* __restrict__ dst_page,      // [B]
                            const int* __restrict__ dst_off,       // [B]
                            const float* __restrict__ sinks,  // [H] or null
                            T* __restrict__ out,              // [B, H, D]
                            float* __restrict__ ws,  // [B, KH, S, G, D + 2]
                            int* __restrict__ tickets,  // [B * KH], zeroed
                            int KH, int G, int P, int window, float scale) {
  constexpr int kDl = D / 32;               // head dims per lane
  constexpr int kHS = 128 / D;              // merge: threads per head dim
  constexpr int kGA = GB / kHS;             // merge: heads per thread
  constexpr int kTileElems = kPage * D;
  constexpr uint32_t kTileBytes = kTileElems * sizeof(TP);
  constexpr int kW = D + 2;                 // partial row: acc, m, l
  constexpr int kStages = ring_stages<TP, D>();
  constexpr bool kQuant = is_fp8<TP>();
  static_assert(kQuant || std::is_same<T, TP>::value, "plain pools hold T");
  static_assert(kStages * 2 * kTileElems * (int)sizeof(TP) >= kWarps * GB * kW * 4,
                "the idle ring must hold the warps' partials");

  extern __shared__ __align__(128) unsigned char smem[];
  const SmemPlan plan = smem_plan<TP, D>(G);
  TP* stages = reinterpret_cast<TP*>(smem);
  float* part_s = reinterpret_cast<float*>(smem);  // after the ring is idle
  float* qf = reinterpret_cast<float*>(smem + plan.q);
  float* nv_s = reinterpret_cast<float*>(smem + plan.nv);
  float* sink_s = reinterpret_cast<float*>(smem + plan.sink);
  float* p_s = reinterpret_cast<float*>(smem + plan.p);
  float* snew_s = reinterpret_cast<float*>(smem + plan.snew);
  float* ml_s = reinterpret_cast<float*>(smem + plan.ml);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.bars);
  uint64_t* empty = full + kStages;
  int* last_s = reinterpret_cast<int*>(smem + plan.flag);

  const int split = blockIdx.x;
  const int S_grid = gridDim.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = KH * G;
  const int seq_len = seq_lens[b];

  // Loads that do not need seq_len go out with it (each decode layer finds
  // them outside the L2) and land in shared memory before the split test,
  // which keeps the compiler from sinking them past it: the query,
  // pre-scaled and rounded to T exactly as the TPU wrapper does, in f32
  // [G, D]; (FUSED) the new K and V rows in f32; the sinks; (FUSED, fp8)
  // the destination page and offset.
  int* dst_s = reinterpret_cast<int*>(smem + plan.dst);
  {
    constexpr int kQPer = (GB * D + kBlock - 1) / kBlock;
    constexpr int kNVPer = (2 * D + kBlock - 1) / kBlock;
    const T* qg = q + ((size_t)b * H + (size_t)kh * G) * D;
    const size_t row = ((size_t)b * KH + kh) * D;
    T qv[kQPer], nv[kNVPer];
    float sk = 0.f;
#pragma unroll
    for (int r = 0; r < kQPer; ++r) {
      const int i = tid + r * kBlock;
      if (i < G * D) qv[r] = qg[i];
    }
    if (FUSED) {
#pragma unroll
      for (int r = 0; r < kNVPer; ++r) {
        const int i = tid + r * kBlock;
        if (i < 2 * D) nv[r] = i < D ? k_new[row + i] : v_new[row + i - D];
      }
    }
    if (sinks != nullptr && tid < G) sk = sinks[kh * G + tid];
    int dst = 0;
    if (FUSED && kQuant && tid < 2) dst = tid == 0 ? dst_page[b] : dst_off[b];
#pragma unroll
    for (int r = 0; r < kQPer; ++r) {
      const int i = tid + r * kBlock;
      if (i < G * D) qf[i] = to_f<T>(from_f<T>(to_f<T>(qv[r]) * scale));
    }
    if (FUSED) {
#pragma unroll
      for (int r = 0; r < kNVPer; ++r) {
        const int i = tid + r * kBlock;
        if (i < 2 * D) nv_s[i] = to_f<T>(nv[r]);
      }
    }
    if (sinks != nullptr && tid < G) sink_s[tid] = sk;
    if (FUSED && kQuant && tid < 2) dst_s[tid] = dst;
  }

  const int ctx = FUSED ? seq_len - 1 : seq_len;
  const int lo = window > 0 ? max(seq_len - window, 0) : 0;

  // the live page range is cut into S <= S_grid near-equal runs of at
  // least kMinSplitPages pages each, or one run (empty when no page is
  // live); the grid's spare splits leave here, before the ring, the
  // workspace or the ticket, so a short context pays for one split
  const int lo_p = lo / kPage;
  const int n_live = max((ctx + kPage - 1) / kPage - lo_p, 0);
  const int S = min(S_grid, max(n_live / kMinSplitPages, 1));
  if (split >= S) return;
  const int p_begin = lo_p + (int)((long long)split * n_live / S);
  const int n = lo_p + (int)((long long)(split + 1) * n_live / S) - p_begin;

  const size_t page_stride = (size_t)KH * kPage * D;
  const size_t head_off = (size_t)kh * kPage * D;
  const int* bt = block_tables + (size_t)b * P;

  auto fetch = [&](int i) {
    const int st = i % kStages;
    const size_t base = (size_t)bt[p_begin + i] * page_stride + head_off;
    TP* dst = stages + (size_t)2 * st * kTileElems;
    mbar_expect_tx(&full[st], 2 * kTileBytes);
    bulk_load(dst, k_layer + base, kTileBytes, &full[st]);
    bulk_load(dst + kTileElems, v_layer + base, kTileBytes, &full[st]);
  };
  if (tid == kWarps * 32) {  // the producer's lane 0: first tiles at once
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);
    }
    mbar_init_fence();
    for (int i = 0; i < min(n, kStages); ++i) fetch(i);
  }
  __syncthreads();

  float acc[GB][kDl];
  float m_r[GB], l_r[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m_r[g] = kNegInf;
    l_r[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kDl; ++j) acc[g][j] = 0.f;
  }

  if (warp == kWarps) {
    // producer: while the first tiles land, the new token's scores (FUSED);
    // then keep the ring full, refilling a stage once it is released
    if (FUSED) {
      float kv[kDl];
#pragma unroll
      for (int j = 0; j < kDl; ++j) kv[j] = nv_s[lane + 32 * j];
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < kDl; ++j) part += qf[g * D + lane + 32 * j] * kv[j];
        part = warp_sum(part);
        if (lane == 0) snew_s[g] = part;
      }
    }
    if (lane == 0) {
      for (int i = kStages; i < n; ++i) {
        mbar_wait(&empty[i % kStages], (uint32_t)(i / kStages - 1) & 1u);
        fetch(i);
      }
    }
  } else {
    // consumers: warp w takes tiles w, w + 4, ...; in the score step each
    // lane owns head dims [kDl * lane, + kDl) of all 16 tokens, and a
    // 5-step butterfly reduce-scatter leaves it the full scores of token
    // lane / 2 for heads 2 * (lane & 1) + {0, 1} of each group of 4
    const int t_me = lane >> 1;
    const int k_me = 2 * (lane & 1);
    float* pw = p_s + warp * G * kPage;
    // (fp8) the K and V scales of tile i, loaded one tile ahead
    auto tile_scales = [&](int i) {
      const size_t si = (size_t)bt[p_begin + i] * KH + kh;
      return make_float2(__bfloat162float(k_scale[si]), __bfloat162float(v_scale[si]));
    };
    float2 sc_next = make_float2(1.f, 1.f);
    if constexpr (kQuant) {
      if (warp < n) sc_next = tile_scales(warp);
    }
    for (int i = warp; i < n; i += kWarps) {
      const int st = i % kStages;
      const int pos0 = (p_begin + i) * kPage;
      const int t_lo = max(lo - pos0, 0);
      const int t_hi = min(ctx - pos0, kPage);
      const float2 sc = sc_next;
      if constexpr (kQuant) {
        if (i + kWarps < n) sc_next = tile_scales(i + kWarps);
      }
      mbar_wait(&full[st], (uint32_t)(i / kStages) & 1u);
      const TP* kt = stages + (size_t)2 * st * kTileElems;
      const TP* vt = kt + kTileElems;
      const bool valid = t_me >= t_lo && t_me < t_hi;
#pragma unroll
      for (int hg = 0; hg < GB / 4; ++hg) {
        if (4 * hg >= G) break;
        float qv[4][kDl];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * hg + k < G) {
            load_row<float, kDl>(qf + (4 * hg + k) * D + kDl * lane, qv[k]);
          } else {
#pragma unroll
            for (int d = 0; d < kDl; ++d) qv[k][d] = 0.f;
          }
        }
        // v[4 t + k]: this lane's share of the score of token t, head k
        float v[4 * kPage];
#pragma unroll
        for (int t = 0; t < kPage; ++t) {
          float kf[kDl];
          load_row<TP, kDl>(kt + t * D + kDl * lane, kf);
          if constexpr (kQuant) {
#pragma unroll
            for (int d = 0; d < kDl; ++d) kf[d] *= sc.x;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float sum = 0.f;
#pragma unroll
            for (int d = 0; d < kDl; ++d) sum += qv[k][d] * kf[d];
            v[4 * t + k] = sum;
          }
        }
        reduce_scatter<32>(v, lane);
        // online softmax over the tile's 16 tokens for the lane's two heads
        // (the 16 lanes of one parity hold one head pair)
        float m_tile[2], p_tile[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float sv = valid ? v[j] : kNegInf;
          float mx = sv;
#pragma unroll
          for (int o = 2; o < 32; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_old = (lane & 1) ? m_r[4 * hg + 2 + j] : m_r[4 * hg + j];
          const float m_new = fmaxf(m_old, mx);
          const float p = valid ? expf(sv - m_new) : 0.f;
          float ps = p;
#pragma unroll
          for (int o = 2; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
          m_tile[j] = m_new;
          p_tile[j] = ps;
          const int g = 4 * hg + k_me + j;
          if (g < G) pw[g * kPage + t_me] = p;
        }
        // every lane takes each head's new max and tile sum from lane 0
        // (heads 0 and 1 of the group) or lane 1 (heads 2 and 3)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int g = 4 * hg + k;
          const float m_new = __shfl_sync(0xffffffffu, m_tile[k & 1], k >> 1);
          const float ps = __shfl_sync(0xffffffffu, p_tile[k & 1], k >> 1);
          if (g < G) {
            const float alpha = expf(m_r[g] - m_new);
            l_r[g] = l_r[g] * alpha + ps;
            m_r[g] = m_new;
#pragma unroll
            for (int j = 0; j < kDl; ++j) acc[g][j] *= alpha;
          }
        }
      }
      __syncwarp();
      if (t_lo == 0 && t_hi == kPage)
        tile_pv<TP, D, GB, false>(acc, vt, pw, G, lane, t_lo, t_hi, sc.y);
      else
        tile_pv<TP, D, GB, true>(acc, vt, pw, G, lane, t_lo, t_hi, sc.y);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }
  __syncthreads();  // every tile consumed: the ring is idle

  // the warps' partials, then their merge per (head, head dim)
  if (warp < kWarps) {
    float* wp = part_s + warp * G * kW;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
#pragma unroll
        for (int j = 0; j < kDl; ++j)
          wp[g * kW + 2 * lane + 64 * (j / 2) + (j & 1)] = acc[g][j];
        if (lane == 0) {
          wp[g * kW + D] = m_r[g];
          wp[g * kW + D + 1] = l_r[g];
        }
      }
    }
  }
  __syncthreads();
  const int d_me = tid % D;   // merge: head dim (threads below 128)
  const int hs_me = tid / D;  // merge: first head
  float mm[kGA], ll[kGA], aa[kGA];
  if (tid < 128) {
#pragma unroll
    for (int k = 0; k < kGA; ++k) {
      const int g = hs_me + kHS * k;
      if (g >= G) continue;
      float m = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, part_s[(w * G + g) * kW + D]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* e = part_s + (w * G + g) * kW;
        const float c = expf(e[D] - m);
        l += e[D + 1] * c;
        a += e[d_me] * c;
      }
      mm[k] = m;
      ll[k] = l;
      aa[k] = a;
    }
  }

  int* ticket = tickets + (size_t)b * KH + kh;
  if (S > 1) {
    // this split's partial, then its ticket; the last split merges them
    float* wb = ws + ((size_t)b * KH + kh) * S_grid * G * kW;
    if (tid < 128) {
      float* wp = wb + (size_t)split * G * kW;
#pragma unroll
      for (int k = 0; k < kGA; ++k) {
        const int g = hs_me + kHS * k;
        if (g >= G) continue;
        wp[g * kW + d_me] = aa[k];
        if (d_me == 0) {
          wp[g * kW + D] = mm[k];
          wp[g * kW + D + 1] = ll[k];
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *last_s = atomicAdd(ticket, 1) == S - 1;
    __syncthreads();
    if (!*last_s) return;
    __threadfence();  // see every split's partial

    // maxima and denominators into shared memory; per head (one warp
    // each) the merged max M, the weights exp(m_s - M) and the denominator
    float* w_s = part_s;           // [S, G] maxima, then weights
    float* lw_s = part_s + S * G;  // [S, G] denominators
    for (int i = tid; i < S * G; i += kBlock) {
      w_s[i] = __ldcg(wb + (size_t)i * kW + D);
      lw_s[i] = __ldcg(wb + (size_t)i * kW + D + 1);
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps + 1) {
      float m = kNegInf;
      for (int s = lane; s < S; s += 32) m = fmaxf(m, w_s[s * G + g]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float c = expf(w_s[s * G + g] - m);
        l += lw_s[s * G + g] * c;
        w_s[s * G + g] = c;
      }
      l = warp_sum(l);
      if (lane == 0) {
        ml_s[g] = m;
        ml_s[G + g] = l;
      }
    }
    __syncthreads();
    if (tid < 128) {
#pragma unroll
      for (int k = 0; k < kGA; ++k) aa[k] = 0.f;
      const float* e = wb + d_me;
#pragma unroll 16
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int k = 0; k < kGA; ++k) {
          const int g = hs_me + kHS * k;
          if (g < G)
            aa[k] += w_s[s * G + g] * __ldcg(e + (size_t)(s * G + g) * kW);
        }
      }
#pragma unroll
      for (int k = 0; k < kGA; ++k) {
        const int g = hs_me + kHS * k;
        if (g >= G) continue;
        mm[k] = ml_s[g];
        ll[k] = ml_s[G + g];
      }
    }
  }

  if (tid < 128) {
#pragma unroll
    for (int k = 0; k < kGA; ++k) {
      const int g = hs_me + kHS * k;
      if (g >= G) continue;
      float m = mm[k], l = ll[k], a = aa[k];
      if (FUSED) {
        // the new token as one more key: score q.k_new, value v_new. The
        // decode query sits at the new token, so it is always visible.
        const float s_new = snew_s[g];
        const float m_f = fmaxf(m, s_new);
        const float alpha = expf(m - m_f);
        const float p_new = expf(s_new - m_f);
        l = l * alpha + p_new;
        a = a * alpha + p_new * nv_s[D + d_me];
        m = m_f;
      }
      if (sinks != nullptr) {
        // a virtual key with value 0: exp(sink) joins the denominator only
        const float sink = sink_s[g];
        const float m_s = fmaxf(m, sink);
        const float c = expf(m - m_s);
        l = l * c + expf(sink - m_s);
        a *= c;
      }
      out[((size_t)b * H + (size_t)kh * G + g) * D + d_me] =
          from_f<T>(a / fmaxf(l, 1e-30f));
    }
  }
  if (S > 1 && tid == 0) *ticket = 0;  // clean for the next launch or replay

  if constexpr (FUSED && !kQuant) {
    // every split of (b, kh) has read its tiles: land the new KV row
    const size_t row = (size_t)dst_page[b] * page_stride + head_off +
                       (size_t)dst_off[b] * D;
    const size_t src = ((size_t)b * KH + kh) * D;
    copy_vec<T>(k_layer + row, k_new + src, D);
    copy_vec<T>(v_layer + row, v_new + src, D);
  }
  if constexpr (FUSED && kQuant) {
    // every split of (b, kh) has read its tiles and their scales: requantize
    // the head's run of the destination page around the new row (the new
    // rows, unquantized, are in nv_s). The run's words (four e4m3 values
    // each) and the old scales are loaded together, before any store, so
    // the read costs one trip to memory; warp 0 then takes K's scale and
    // warp 1 V's.
    constexpr int kRunWords = kPage * D / 4;
    constexpr int kIters = (2 * kRunWords + kBlock - 1) / kBlock;
    float* rq_s = reinterpret_cast<float*>(smem + plan.rq);
    const int doff = dst_s[1];
    const size_t si = (size_t)dst_s[0] * KH + kh;
    const size_t run = (size_t)dst_s[0] * page_stride + head_off;
    auto word_at = [&](int w) {
      const int kv = w / kRunWords;  // 0: K, 1: V
      return reinterpret_cast<uint32_t*>((kv ? v_layer : k_layer) + run) +
             (w - kv * kRunWords);
    };
    uint32_t old_w[kIters];
#pragma unroll
    for (int r = 0; r < kIters; ++r) {
      const int w = tid + r * kBlock;
      if (w < 2 * kRunWords) old_w[r] = *word_at(w);
    }
    if (warp < 2) {
      // a fresh page (dst_off 0) starts from scale 0, never its last
      // occupant's
      const __nv_bfloat16* sc = warp == 0 ? k_scale : v_scale;
      const float old = doff == 0 ? 0.f : __bfloat162float(sc[si]);
      const float* row = nv_s + warp * D;
      float amax = 0.f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(row[d]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) {
        const float ns = __bfloat162float(
            __float2bfloat16_rn(fmaxf(old, __fdiv_rn(amax, kFp8Max))));
        rq_s[2 * warp] = ns;
        rq_s[2 * warp + 1] = ns > 0.f ? __fdiv_rn(old, fmaxf(ns, kTiny)) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kIters; ++r) {
      const int w = tid + r * kBlock;
      if (w >= 2 * kRunWords) break;
      const int kv = w / kRunWords;
      const int e = (w - kv * kRunWords) * 4;  // element in the run
      const int t = e / D;
      float f[4];
      if (t == doff) {
        const float ns = rq_s[2 * kv];
        const float* src = nv_s + kv * D + (e - t * D);
#pragma unroll
        for (int j = 0; j < 4; ++j) f[j] = quant_value(src[j], ns);
      } else {
        const float fac = rq_s[2 * kv + 1];
        const float2 a = fp8x2_to_float2((uint16_t)(old_w[r] & 0xffffu));
        const float2 c = fp8x2_to_float2((uint16_t)(old_w[r] >> 16));
        f[0] = __fmul_rn(a.x, fac);
        f[1] = __fmul_rn(a.y, fac);
        f[2] = __fmul_rn(c.x, fac);
        f[3] = __fmul_rn(c.y, fac);
      }
      *word_at(w) = f32_to_fp8(f[0]) | (f32_to_fp8(f[1]) << 8) |
                    (f32_to_fp8(f[2]) << 16) | (f32_to_fp8(f[3]) << 24);
    }
    if (tid == 0) {
      k_scale[si] = __float2bfloat16_rn(rq_s[0]);
      v_scale[si] = __float2bfloat16_rn(rq_s[2]);
    }
  }
}

// static: its function-local `raised` must stay private to this library
// (an inline function's static is one object across every library the
// process loads, so a second build of these kernels would skip raising
// its own limit)
template <typename T, typename TP, int D, int GB, bool FUSED>
static int launch_split(dim3 grid, cudaStream_t stream, const void* q,
                        void* k_layer, void* v_layer, void* k_scale,
                        void* v_scale, const void* k_new, const void* v_new,
                        const int* block_tables, const int* seq_lens,
                        const int* dst_page, const int* dst_off,
                        const float* sinks, void* out, float* ws, int* tickets,
                        int KH, int G, int P, int window, float scale) {
  auto kernel = decode_attention_kernel<T, TP, D, GB, FUSED>;
  const int bytes = smem_plan<TP, D>(G).total;
  // above 48 KB the limit is raised once per kernel and device (the most a
  // launch needs is the G = 16 plan)
  static int raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > 48 * 1024 && (dev >= 64 || raised[dev] < bytes)) {
    const int most = smem_plan<TP, D>(16).total;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised[dev] = most;
  }
  kernel<<<grid, kBlock, bytes, stream>>>(
      (const T*)q, (TP*)k_layer, (TP*)v_layer, (__nv_bfloat16*)k_scale,
      (__nv_bfloat16*)v_scale, (const T*)k_new, (const T*)v_new, block_tables,
      seq_lens, dst_page, dst_off, sinks, (T*)out, ws, tickets, KH, G, P,
      window, scale);
  return (int)cudaGetLastError();
}

// Host-side launcher shared by the two attention entry points. `ws` holds
// B * KH * S * G * (D + 2) floats; `tickets` B * KH ints, zero on entry
// (the kernel leaves them zero). Both must belong to this stream alone.
// `qtype` is the query / output / new-row type (kF32, kBF16), `ptype` the
// pools' (qtype, or kFP8 with one layer's [NP, KH] bf16 scales in
// k_scale / v_scale, which are null otherwise).
template <bool FUSED>
static int launch_decode_attention(
    const void* q, void* k_layer, void* v_layer, void* k_scale, void* v_scale,
    const void* k_new, const void* v_new, const int* block_tables,
    const int* seq_lens, const int* dst_page, const int* dst_off,
    const float* sinks, void* out, float* ws, int* tickets, int S, int B,
    int H, int KH, int D, int page, int P, int window, float scale, int qtype,
    int ptype, cudaStream_t stream) {
  const int G = KH > 0 ? H / KH : 0;
  if (page != kPage || (D != 64 && D != 128) || G < 1 || G > 16 || H % KH ||
      S < 1 || S > kMaxSplits || KH > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((ptype == kFP8) != (k_scale != nullptr && v_scale != nullptr) ||
      (ptype != kFP8 && ptype != qtype))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(S, KH, B);
#define DTT_LAUNCH(T, TP, DD, GG)                                            \
  return launch_split<T, TP, DD, GG, FUSED>(                                 \
      grid, stream, q, k_layer, v_layer, k_scale, v_scale, k_new, v_new,     \
      block_tables, seq_lens, dst_page, dst_off, sinks, out, ws, tickets, KH, \
      G, P, window, scale)
#define DTT_BY_G(T, TP, DD)              \
  if (G <= 4) DTT_LAUNCH(T, TP, DD, 4); \
  DTT_LAUNCH(T, TP, DD, 16)
#define DTT_BY_D(T, TP)                        \
  if (D == 128) { DTT_BY_G(T, TP, 128); }      \
  DTT_BY_G(T, TP, 64)
  if (ptype == kFP8) {
    if (qtype == kBF16) { DTT_BY_D(__nv_bfloat16, __nv_fp8_e4m3); }
    if (qtype == kF32) { DTT_BY_D(float, __nv_fp8_e4m3); }
  } else {
    if (qtype == kBF16) { DTT_BY_D(__nv_bfloat16, __nv_bfloat16); }
    if (qtype == kF32) { DTT_BY_D(float, float); }
  }
#undef DTT_BY_D
#undef DTT_BY_G
#undef DTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace dtt
