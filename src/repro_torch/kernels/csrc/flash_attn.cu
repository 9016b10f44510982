// Blocked online-softmax attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (_flash_kernel): out = softmax(scale * q k^T) v per head,
// the (Sq, Sk) scores never in device memory, causal blocks above the
// diagonal skipped. q (B, H, Sq, D), k, v (B, KH, Sk, D) and out (B, H, Sq,
// D), each given by its (batch, head, row) strides with D contiguous, so
// (B, S, H, D) activations are read in place; GQA reads KV head h / (H /
// KH). One dtype (bf16 or f32) for all four. Numerics follow the TPU
// kernel: scores q . k in fp32 times scale, the running (m, l) and the
// accumulator fp32, p rounded to v's dtype before p . v (l sums the
// unrounded p), l floored at 1e-30. The causal mask is i >= j on absolute
// indices from 0 (as the reference); keys at or past Sk are masked.
//
// Design. One CTA per (batch, head, 64-query block) walks the 64-key blocks
// up to the diagonal (causal) or Sk: K and V tiles staged in shared memory
// as fp32 (K rows padded to D + 1 against bank conflicts), one thread per
// (query, key) for the scores, one warp per 8 query rows for the row max,
// p and the sums (shuffles), and the accumulator in registers, 32 (query,
// feature) pairs per thread. D up to 128 (80, zamba2's d_head, included).
// Every product runs on the CUDA cores from shared memory: at long
// sequences the kernel is bound by those FMAs (4 B H Sq Sk D operations,
// halved when causal), not by bytes; tensor cores (mma.sync / wgmma) and a
// TMA ring for K / V are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // keys per staged block (two per lane)
constexpr int kMaxD = 128;
constexpr int kAcc = kBQ * kMaxD / kThreads;
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);
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

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__host__ __device__ constexpr size_t smem_floats(int D) {
  // q (kBQ, D) | k (kBK, D + 1) | v (kBK, D) | p (kBQ, kBK + 1) | m, l, corr
  return (size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1) + 3 * (size_t)kBQ;
}

// grid (ceil(Sq / kBQ), H, B)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Strides st, int H,
             int KH, int Sq, int Sk, int D, float scale, int causal) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  float* qs = sm;
  float* ks = qs + kBQ * D;
  float* vs = ks + kBK * (D + 1);
  float* ps = vs + kBK * D;
  float* m = ps + kBQ * (kBK + 1);
  float* l = m + kBQ;
  float* corr = l + kBQ;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;
  for (int o = tid; o < kBQ * D; o += kThreads) {
    const int r = o / D, d = o - r * D;
    qs[o] = q0 + r < Sq ? to_f32(qp[(q0 + r) * st.qs + d]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  int nk = (Sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);   // skip blocks above
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                     // the previous block is consumed
    for (int o = tid; o < kBK * D; o += kThreads) {
      const int c = o / D, d = o - c * D;
      const bool in = k0 + c < Sk;
      ks[c * (D + 1) + d] = in ? to_f32(kp[(k0 + c) * st.ks + d]) : 0.f;
      vs[o] = in ? to_f32(vp[(k0 + c) * st.vs + d]) : 0.f;
    }
    __syncthreads();
    for (int o = tid; o < kBQ * kBK; o += kThreads) {
      const int r = o / kBK, c = o - r * kBK;
      const float* qr = qs + r * D;
      const float* kc = ks + c * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kc[d], s);
      const bool valid = k0 + c < Sk && (!causal || k0 + c <= q0 + r);
      ps[r * (kBK + 1) + c] = valid ? s * scale : kNegInf;
    }
    __syncthreads();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      float* pr = ps + r * (kBK + 1);
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      const float e0 = s0 > 0.5f * kNegInf ? expf(s0 - m_new) : 0.f;
      const float e1 = s1 > 0.5f * kNegInf ? expf(s1 - m_new) : 0.f;
      float sum = e0 + e1;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      pr[lane] = round_to<T>(e0);
      pr[lane + 32] = round_to<T>(e1);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        l[r] = l[r] * c + sum;
        m[r] = m_new;
        corr[r] = c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int o = tid + i * kThreads;
      if (o < kBQ * D) {
        const int r = o / D, d = o - r * D;
        const float* pr = ps + r * (kBK + 1);
        float a = acc[i] * corr[r];
        for (int c = 0; c < kBK; ++c) a = fmaf(pr[c], vs[c * D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  T* op = out + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int o = tid + i * kThreads;
    if (o < kBQ * D) {
      const int r = o / D, d = o - r * D;
      if (q0 + r < Sq) op[(q0 + r) * st.os + d] = from_f32<T>(acc[i] / fmaxf(l[r], 1e-30f));
    }
  }
}

template <typename T>
int flash(const void* q, const void* k, const void* v, void* out,
          const Strides& st, int B, int H, int KH, int Sq, int Sk, int D,
          float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > kMaxD || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_kernel<T>;
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads, smem,
           (cudaStream_t)stream>>>((const T*)q, (const T*)k, (const T*)v,
                                   (T*)out, st, H, KH, Sq, Sk, D, scale,
                                   causal);
  return (int)cudaGetLastError();
}

}  // namespace fa

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// strides: 12 int64 (q b, h, s | k b, h, s | v b, h, s | out b, h, s)
#define FA_ENTRY(NAME, T)                                                     \
  int NAME(const void* q, const void* k, const void* v, void* out,            \
           const long long* strides, int B, int H, int KH, int Sq, int Sk,    \
           int D, float scale, int causal, void* stream) {                    \
    const fa::Strides st{strides[0], strides[1], strides[2],  strides[3],     \
                         strides[4], strides[5], strides[6],  strides[7],     \
                         strides[8], strides[9], strides[10], strides[11]};   \
    return fa::flash<T>(q, k, v, out, st, B, H, KH, Sq, Sk, D, scale, causal, \
                        stream);                                              \
  }

FA_ENTRY(fa_flash_attention_f32, float)
FA_ENTRY(fa_flash_attention_bf16, __nv_bfloat16)

}  // extern "C"
