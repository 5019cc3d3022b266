// Token KV append into the paged pool: row n of k_new/v_new [N, KH, D]
// lands at (layer, dst_page[n], :, dst_off[n], :) of the pools
// [L, num_pages, KH, page, D], in place. One block per row; its threads
// store the row's KH * D elements with 16-byte vector stores. Duplicate
// writes to trash page 0 race and leave garbage there by contract.
//
// Replaces dynamo_tpu/ops/pallas/kv_write.py:_kv_write_kernel.
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

}  // namespace dtt

extern "C" int dtt_kv_write(void* k_pages, void* v_pages, const void* k_new,
                            const void* v_new, const int* dst_page,
                            const int* dst_off, int n, int layer,
                            int num_pages, int kh, int page, int d, int dtype,
                            void* stream) {
  if (n == 0) return 0;
  const int elem = dtype == dtt::kBF16 ? 2 : 4;
  if ((dtype != dtt::kBF16 && dtype != dtt::kF32) || (d * elem) % 16)
    return (int)cudaErrorInvalidValue;
  const int threads = ((kh * d * elem / 16) + 31) / 32 * 32;
  const int block = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  cudaStream_t s = (cudaStream_t)stream;
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
