// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// paged_flash_decode (_paged_decode_kernel): one query token per row attends
// over the KV pages its page table maps, with GQA and an online softmax.
// q (B, H, D); k, v pages (P, page, K, D) shared pools; table (B, W) int32;
// kv_len (B,) int32; out (B, H, D); q, pages and out in one dtype (bf16 or
// f32), all sums fp32. Numerics follow the TPU kernel: q * scale rounded to
// q's dtype, scores and (m, l, acc) in fp32, p rounded to v's dtype before
// p . v, l floored at 1e-30.
//
// Design. One CTA per (row, KV head) serves that head's G = H / K query
// heads, so each K / V page is read once for all of them. The CTA walks the
// row's table in order and stops at the first page at or past kv_len: pages
// past the filled prefix are skipped, not read and masked, and no page past
// column W - 1 is read (a parked row's kv_len exceeds W * page). Per page:
// the page's K and V rows of this head are staged in shared memory as fp32
// (K rows padded to D + 1 against bank conflicts); one thread per
// (query head, key) takes a score; one thread per query head updates
// (m, l) and turns its scores into p; one thread per (query head, feature)
// updates acc. At decode the work is reading the pages, about 0.6 MB a row
// at 144 tokens of context, so the kernel is bound by its launch and its
// per-page barriers, not by bytes or operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pa {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__host__ __device__ constexpr size_t smem_floats(int G, int D, int page) {
  // q (G, D) | K page (page, D + 1) | V page (page, D) | p (G, page) |
  // acc (G, D) | m, l, corr (G each)
  return (size_t)G * D + (size_t)page * (D + 1) + (size_t)page * D +
         (size_t)G * page + (size_t)G * D + 3 * (size_t)G;
}

// grid (K, B): blockIdx.x = KV head, blockIdx.y = row
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ kv_len, T* __restrict__ out, int H,
                    int KH, int D, int page, int W, float scale) {
  extern __shared__ float sm[];
  const int kh = blockIdx.x, row = blockIdx.y;
  const int G = H / KH;
  float* qs = sm;
  float* kt = qs + G * D;
  float* vt = kt + page * (D + 1);
  float* ps = vt + page * D;
  float* acc = ps + G * page;
  float* m = acc + G * D;
  float* l = m + G;
  float* corr = l + G;

  const T* qrow = q + ((size_t)row * H + (size_t)kh * G) * D;
  for (int o = threadIdx.x; o < G * D; o += kThreads) {
    qs[o] = round_to<T>(to_f32(qrow[o]) * scale);
    acc[o] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  const int len = kv_len[row];
  const int* trow = table + (size_t)row * W;

  for (int j = 0; j < W && j * page < len; ++j) {
    const size_t pid = (size_t)trow[j];
    __syncthreads();                     // the previous page is consumed
    for (int o = threadIdx.x; o < page * D; o += kThreads) {
      const int jj = o / D, dd = o - jj * D;
      const size_t src = ((pid * page + jj) * KH + kh) * D + dd;
      kt[jj * (D + 1) + dd] = to_f32(kp[src]);
      vt[o] = to_f32(vp[src]);
    }
    __syncthreads();
    for (int o = threadIdx.x; o < G * page; o += kThreads) {
      const int g = o / page, jj = o - g * page;
      float s = 0.f;
      const float* qg = qs + g * D;
      const float* kj = kt + jj * (D + 1);
      for (int dd = 0; dd < D; ++dd) s = fmaf(qg[dd], kj[dd], s);
      ps[o] = j * page + jj < len ? s : kNegInf;
    }
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += kThreads) {
      float* pg = ps + g * page;
      float mx = m[g];
      for (int jj = 0; jj < page; ++jj) mx = fmaxf(mx, pg[jj]);
      float sum = 0.f;
      for (int jj = 0; jj < page; ++jj) {
        const float p = expf(pg[jj] - mx);
        sum += p;
        pg[jj] = round_to<T>(p);
      }
      const float c = expf(m[g] - mx);
      l[g] = l[g] * c + sum;
      m[g] = mx;
      corr[g] = c;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < G * D; o += kThreads) {
      const int g = o / D, dd = o - g * D;
      const float* pg = ps + g * page;
      float a = acc[o] * corr[g];
      for (int jj = 0; jj < page; ++jj) a = fmaf(pg[jj], vt[jj * D + dd], a);
      acc[o] = a;
    }
  }
  __syncthreads();
  T* orow = out + ((size_t)row * H + (size_t)kh * G) * D;
  for (int o = threadIdx.x; o < G * D; o += kThreads)
    orow[o] = from_f32<T>(acc[o] / fmaxf(l[o / D], 1e-30f));
}

template <typename T>
int paged_decode(const void* q, const void* kp, const void* vp,
                 const void* table, const void* kv_len, void* out, int B,
                 int H, int KH, int D, int page, int W, float scale,
                 void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || page <= 0 || W <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<T>;
  const size_t smem = smem_floats(H / KH, D, page) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(KH, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)table,
      (const int*)kv_len, (T*)out, H, KH, D, page, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace pa

extern "C" {

const char* pa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pa_paged_decode_f32(const void* q, const void* kp, const void* vp,
                        const void* table, const void* kv_len, void* out,
                        int B, int H, int KH, int D, int page, int W,
                        float scale, void* stream) {
  return pa::paged_decode<float>(q, kp, vp, table, kv_len, out, B, H, KH, D,
                                 page, W, scale, stream);
}

int pa_paged_decode_bf16(const void* q, const void* kp, const void* vp,
                         const void* table, const void* kv_len, void* out,
                         int B, int H, int KH, int D, int page, int W,
                         float scale, void* stream) {
  return pa::paged_decode<__nv_bfloat16>(q, kp, vp, table, kv_len, out, B, H,
                                         KH, D, page, W, scale, stream);
}

}  // extern "C"
