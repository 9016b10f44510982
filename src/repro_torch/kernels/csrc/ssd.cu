// Mamba2 SSD chunked scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py ssd_pallas
// (_ssd_kernel): for every (row, head) the recurrence
//   S_t = exp(loga_t) S_{t-1} + B_t x_t^T,   y_t = C_t^T S_t
// evaluated chunk-parallel. Within a chunk of Q steps:
//   y   = ((C B^T) o exp(cum_t - cum_s), s <= t) x  +  (C o exp(cum)) S
//   S  <- exp(total) S + sum_q exp(total - cum_q) B_q x_q^T
// with cum the inclusive sum of loga inside the chunk and total its last
// entry. x (Nb, T, H, P), loga (Nb, T, H), B, C (Nb, T, H, N), y (Nb, T, H,
// P), all in one dtype (bf16 or f32) and read in that (T, H, .) layout
// directly (no head-major copy); all state math fp32, y rounded once.
//
// Design. The TPU grid (heads, chunks) ran the chunks in order on one core
// with the state in VMEM scratch. Here one CTA owns one (row, head, P tile)
// and walks the chunks itself, the state (N x P tile, fp32) in shared
// memory, so nothing carries between CTAs. The chunk is the kernel's own
// choice, kQ = 64 steps: a 256-step chunk's fp32 B and C tiles alone take
// 256 KB at N = 128, more than a CTA may hold. A chunk past T (T need not be
// a multiple of kQ) is padded with loga = 0 and x = B = C = 0, which leaves
// the state as it is; its rows are not stored. The result does not depend
// on the chunk apart from rounding. The columns p of y and S are
// independent, so a row's P columns may split over CTAs (the wrapper halves
// the tile while the grid has fewer CTAs than the card has SMs); each tile
// recomputes the chunk's scores C B^T. exp is taken only on causal entries
// (above the diagonal cum_t - cum_s > 0 would overflow). Per chunk and
// tile: Q^2 N / 2 (scores) + Q^2 P / 2 + Q N P (y) + Q N P (state) FMAs on
// the CUDA cores from shared memory, one operand a broadcast; B rows are
// padded to N + 1 floats so the score loop is free of bank conflicts. At
// zamba2's prefill (T <= 128, H = 80, P = N = 64) the grid is 160 CTAs of
// two chunks each: bound by the per-chunk barriers and shared-memory
// traffic, not by bytes (a few MB) or operations. Tensor cores (TF32
// mma.sync), TMA loads and splitting long T across CTAs with a second pass
// over the chunk states come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {

constexpr int kThreads = 256;
constexpr int kQ = 64;                 // steps per chunk (two per warp lane)
constexpr int kMaxSmem = 232448;       // bytes a CTA may use on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr size_t smem_floats(int N, int pt) {
  // S (N, pt) | x (kQ, pt) | B (kQ, N + 1) | C (kQ, N) | G (kQ, kQ + 1) | cum
  return (size_t)N * pt + (size_t)kQ * pt + (size_t)kQ * (N + 1) +
         (size_t)kQ * N + (size_t)kQ * (kQ + 1) + kQ;
}

// grid (Nb * H, ceil(P / pt)): blockIdx.x = row * H + head, blockIdx.y = P tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ la,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           T* __restrict__ y, int Tn, int H, int P, int N, int pt) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int row = blockIdx.x / H, h = blockIdx.x - row * H;
  const int p0 = blockIdx.y * pt;
  const int np = min(pt, P - p0);
  float* S = sm;
  float* xs = S + N * pt;
  float* Bs = xs + kQ * pt;
  float* Cs = Bs + kQ * (N + 1);
  float* G = Cs + kQ * N;
  float* cum = G + kQ * (kQ + 1);

  for (int o = tid; o < N * pt; o += kThreads) S[o] = 0.f;
  const size_t base = (size_t)row * Tn;

  for (int t0 = 0; t0 < Tn; t0 += kQ) {
    const int q = min(kQ, Tn - t0);
    __syncthreads();                     // the previous chunk is consumed
    for (int o = tid; o < kQ * pt; o += kThreads) {
      const int t = o / pt, p = o - t * pt;
      xs[o] = (t < q && p < np)
                  ? to_f32(x[((base + t0 + t) * H + h) * P + p0 + p])
                  : 0.f;
    }
    for (int o = tid; o < kQ * N; o += kThreads) {
      const int t = o / N, n = o - t * N;
      float b = 0.f, c = 0.f;
      if (t < q) {
        const size_t src = ((base + t0 + t) * H + h) * N + n;
        b = to_f32(Bm[src]);
        c = to_f32(Cm[src]);
      }
      Bs[t * (N + 1) + n] = b;
      Cs[o] = c;
    }
    if (tid < 32) {                      // inclusive cumsum of loga, fp32
      const int i0 = 2 * tid;
      const float a0 = i0 < q ? to_f32(la[(base + t0 + i0) * H + h]) : 0.f;
      const float a1 = i0 + 1 < q ? to_f32(la[(base + t0 + i0 + 1) * H + h]) : 0.f;
      const float pair = a0 + a1;
      float s = pair;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += v;
      }
      const float before = s - pair;
      cum[i0] = before + a0;
      cum[i0 + 1] = before + a0 + a1;
    }
    __syncthreads();
    // decay-masked scores G[t][s] = (C_t . B_s) exp(cum_t - cum_s), s <= t
    for (int o = tid; o < kQ * kQ; o += kThreads) {
      const int t = o / kQ, s = o - t * kQ;
      float g = 0.f;
      if (s <= t && t < q) {
        const float* ct = Cs + t * N;
        const float* bs = Bs + s * (N + 1);
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc = fmaf(ct[n], bs[n], acc);
        g = acc * expf(cum[t] - cum[s]);
      }
      G[t * (kQ + 1) + s] = g;
    }
    __syncthreads();
    const float total = cum[kQ - 1];     // padded steps add 0
    for (int o = tid; o < kQ * N; o += kThreads) {
      const int t = o / N, n = o - t * N;
      Cs[o] *= expf(cum[t]);
      Bs[t * (N + 1) + n] *= expf(total - cum[t]);
    }
    __syncthreads();
    // y[t][p] = sum_{s <= t} G[t][s] x[s][p] + sum_n C'[t][n] S[n][p]
    for (int o = tid; o < q * pt; o += kThreads) {
      const int t = o / pt, p = o - t * pt;
      if (p >= np) continue;
      const float* gt = G + t * (kQ + 1);
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc = fmaf(gt[s], xs[s * pt + p], acc);
      const float* ct = Cs + t * N;
      for (int n = 0; n < N; ++n) acc = fmaf(ct[n], S[n * pt + p], acc);
      y[((base + t0 + t) * H + h) * P + p0 + p] = from_f32<T>(acc);
    }
    __syncthreads();
    // S[n][p] = exp(total) S[n][p] + sum_q B'[q][n] x[q][p]
    const float decay = expf(total);
    for (int o = tid; o < N * pt; o += kThreads) {
      const int n = o / pt, p = o - n * pt;
      float acc = decay * S[o];
      for (int s = 0; s < q; ++s) acc = fmaf(Bs[s * (N + 1) + n], xs[s * pt + p], acc);
      S[o] = acc;
    }
  }
}

template <typename T>
int ssd(const void* x, const void* la, const void* Bm, const void* Cm,
        void* y, int Nb, int Tn, int H, int P, int N, int pt, void* stream) {
  if (Nb <= 0 || Tn <= 0 || H <= 0 || P <= 0 || N <= 0 || pt <= 0 || pt > P ||
      (long long)Nb * H > 2147483647LL || (P + pt - 1) / pt > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, pt) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Nb * H, (P + pt - 1) / pt), kThreads, smem,
           (cudaStream_t)stream>>>((const T*)x, (const T*)la, (const T*)Bm,
                                   (const T*)Cm, (T*)y, Tn, H, P, N, pt);
  return (int)cudaGetLastError();
}

}  // namespace ssd

extern "C" {

const char* ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ssd_chunked_scan_f32(const void* x, const void* la, const void* Bm,
                         const void* Cm, void* y, int Nb, int Tn, int H,
                         int P, int N, int pt, void* stream) {
  return ssd::ssd<float>(x, la, Bm, Cm, y, Nb, Tn, H, P, N, pt, stream);
}

int ssd_chunked_scan_bf16(const void* x, const void* la, const void* Bm,
                          const void* Cm, void* y, int Nb, int Tn, int H,
                          int P, int N, int pt, void* stream) {
  return ssd::ssd<__nv_bfloat16>(x, la, Bm, Cm, y, Nb, Tn, H, P, N, pt,
                                 stream);
}

}  // extern "C"
