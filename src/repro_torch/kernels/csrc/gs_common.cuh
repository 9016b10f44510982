// Shared pieces of the fused GSOFT rotation kernels (gs_fused_T.cu,
// gs_fused.cu, gs_fused_bwd.cu): constants, type conversion, the bank slot
// of a row, the register-tiled block product and the launch helper. Each including .cu file is its own shared library.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace gs {

constexpr int kThreads = 1024;
constexpr int kPerThread = 32;                        // fp32 sums a thread keeps
constexpr int kMaxTileElems = kThreads * kPerThread;  // tt * d must not exceed this

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A factor element of type F as the fp32 value the kernels multiply with:
// rounded to the activation type T first when F is wider (an fp32 bank
// entry with bf16 x: what ``index_select(...).to(x.dtype)`` would give),
// exact when F is T.
template <typename T, typename F>
struct Factor {
  static __device__ __forceinline__ float get(F v) {
    return to_f32(from_f32<T>(to_f32(v)));
  }
};
template <typename T>
struct Factor<T, T> {
  static __device__ __forceinline__ float get(T v) { return to_f32(v); }
};

// The bank slot of batch row `row`: ids[row] clamped into [0, slots) (the
// kernels never read past the bank), or the row itself without ids (per-row
// factors passed straight through).
__device__ __forceinline__ long long row_slot(const long long* ids, int row,
                                              int slots) {
  if (ids == nullptr) return row;
  const long long s = ids[row];
  return s < 0 ? 0 : (s >= slots ? slots - 1 : s);
}

// Register layout shared by both kernels: thread `tid` owns the feature
// columns k = tid + p * kThreads (p < KP) of all TT tokens of the tile, so a
// factor element loaded once from L1/L2 feeds TT fused multiply-adds, and the
// factor loads of a warp (32 consecutive columns of one b x b block row) are
// coalesced. The TT * KP sums stay in registers across one __syncthreads,
// which is what lets every stage overwrite the tile in place.
//
// Block product over the tile: acc[p][t] = sum_i F[g][i][j] * buf[t*d + in(g, i)]
// for column k = g*b + j, with F read as F[(g*b + i)*b + j] (row i of block g),
// and `in` the stage's shuffled input position.
// F's element type FT may be wider than the activation type T (Factor).
template <typename T, int TT, bool kShuffledIn, typename FT>
__device__ __forceinline__ void block_stage(const FT* __restrict__ F,
                                            const float* buf, int d, int r, int b,
                                            int kbeg, int kend,
                                            float (&acc)[kPerThread / TT][TT]) {
  constexpr int KP = kPerThread / TT;
#pragma unroll
  for (int p = 0; p < KP; ++p) {
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[p][t] = 0.f;
    const int k = kbeg + threadIdx.x + p * kThreads;
    if (k < kend) {
      const int g = k / b, j = k - g * b;
      const FT* Fg = F + (size_t)g * b * b + j;
      // input position of row i of block g: g*b + i (in place) or
      // i*r + g (reading the P^T-shuffled intermediate)
      const float* in = kShuffledIn ? buf + g : buf + g * b;
      const int step = kShuffledIn ? r : 1;
#pragma unroll 4
      for (int i = 0; i < b; ++i) {
        const float w = Factor<T, FT>::get(Fg[(size_t)i * b]);
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[p][t] += w * in[t * d + i * step];
      }
    }
  }
}

template <int TT>
__device__ __forceinline__ void store_tile(float* buf, int d, int kbeg, int kend,
                                           const float (&acc)[kPerThread / TT][TT]) {
  constexpr int KP = kPerThread / TT;
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    const int k = kbeg + threadIdx.x + p * kThreads;
    if (k < kend) {
#pragma unroll
      for (int t = 0; t < TT; ++t) buf[t * d + k] = acc[p][t];
    }
  }
}

template <typename Kernel, typename T>
cudaError_t launch_kernel(Kernel kernel, int cluster, dim3 grid, size_t smem,
                          cudaStream_t stream, const void* x, const void* L,
                          const void* R, void* y, int n_tokens, int r, int b) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)L, (const T*)R,
                           (T*)y, n_tokens, r, b);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Tokens per tile TT: a power of two with TT * d <= kMaxTileElems (the wrapper
// picks it); one instantiation per TT.
#define GS_DISPATCH_TT(tt, CALL)                       \
  switch (tt) {                                        \
    case 1: { constexpr int TT = 1; return CALL; }     \
    case 2: { constexpr int TT = 2; return CALL; }     \
    case 4: { constexpr int TT = 4; return CALL; }     \
    case 8: { constexpr int TT = 8; return CALL; }     \
    default: return (int)cudaErrorInvalidValue;        \
  }

inline bool bad_shape(int B, int n_tokens, int r, int b, int tt) {
  return B <= 0 || n_tokens <= 0 || r <= 0 || b <= 0 || B > 65535 ||
         (long long)tt * r * b > kMaxTileElems;
}

// ---------------------------------------------------------------------------
// Route 2 past kMaxTileElems: wide passes through an fp32 workspace
// ---------------------------------------------------------------------------
//
// When a row of d = r * b features does not fit the fp32 tile (tt * d >
// kMaxTileElems), route 2 of every GS kernel runs as a chain of these
// passes, each a block-diagonal product with a permuted read and a permuted
// write, from and into device memory (the intermediate stays fp32):
//   out[t][k] = sum_j W(g, i, j) * in[t][imap(g*b + j)],  g*b + i = omap(k),
// W(g, i, j) = F_g[i][j] (ftrans = 0) or F_g[j][i] (ftrans = 1) of the
// row's factors (its bank slot when ids is given), or the identity (F ==
// nullptr: out[t][k] = in[t][imap(omap(k))]). The maps: 0 the identity, 1
// P as a gather (c -> (c % r) b + c / r), 2 P^T (k -> (k % b) r + k / b).
// One thread owns one feature k of kWideTokens tokens, so a factor element
// feeds that many FMAs; no width limit. Width is not a speed path (f32
// checks, b != 32): simple and right.
constexpr int kWideThreads = 256;
constexpr int kWideTokens = 8;
enum { kMapId = 0, kMapP = 1, kMapPT = 2 };

__device__ __forceinline__ int wide_map(int m, int c, int r, int b) {
  return m == kMapP ? (c % r) * b + c / r : (m == kMapPT ? (c % b) * r + c / b : c);
}

// TX: the activation type (an fp32 bank entry is rounded to it, Factor);
// TI / TO: the pass's input / output element types
template <typename TX, typename TI, typename TF, typename TO>
__global__ void __launch_bounds__(kWideThreads)
gs_wide_pass_kernel(const TI* __restrict__ in, const TF* __restrict__ F,
                    const long long* __restrict__ ids, int slots,
                    TO* __restrict__ out, int n_tokens, int r, int b, int imap,
                    int omap, int ftrans) {
  const int d = r * b;
  const int k = blockIdx.x * kWideThreads + threadIdx.x;
  if (k >= d) return;
  const int row = blockIdx.z;
  const int t0 = blockIdx.y * kWideTokens;
  const int nt = min(kWideTokens, n_tokens - t0);
  const size_t base = ((size_t)row * n_tokens + t0) * d;
  const int c = wide_map(omap, k, r, b);
  const int g = c / b, i = c - g * b;
  float acc[kWideTokens];
#pragma unroll
  for (int t = 0; t < kWideTokens; ++t) acc[t] = 0.f;
  if (F == nullptr) {
    const int s = wide_map(imap, c, r, b);
#pragma unroll
    for (int t = 0; t < kWideTokens; ++t)
      if (t < nt) acc[t] = to_f32(in[base + (size_t)t * d + s]);
  } else {
    const TF* Fg = F + ((size_t)row_slot(ids, row, slots) * r + g) * b * b;
    const size_t f0 = ftrans ? (size_t)i : (size_t)i * b;
    const size_t fs = ftrans ? (size_t)b : 1;
    for (int j = 0; j < b; ++j) {
      const float w = Factor<TX, TF>::get(Fg[f0 + j * fs]);
      const int s = wide_map(imap, g * b + j, r, b);
#pragma unroll
      for (int t = 0; t < kWideTokens; ++t)
        if (t < nt) acc[t] = fmaf(w, to_f32(in[base + (size_t)t * d + s]), acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kWideTokens; ++t)
    if (t < nt) out[base + (size_t)t * d + k] = from_f32<TO>(acc[t]);
}

inline bool bad_wide_shape(int B, int n_tokens, int r, int b) {
  return B <= 0 || n_tokens <= 0 || r <= 0 || b <= 0 || B > 65535 ||
         (long long)r * b > 2147483647LL - kWideThreads ||
         (n_tokens + kWideTokens - 1) / kWideTokens > 65535;
}

template <typename TX, typename TI, typename TF, typename TO>
cudaError_t wide_pass(const void* in, const void* F, const long long* ids,
                      int slots, void* out, int B, int n_tokens, int r, int b,
                      int imap, int omap, int ftrans, cudaStream_t stream) {
  const long long d = (long long)r * b;
  const dim3 grid((unsigned)((d + kWideThreads - 1) / kWideThreads),
                  (n_tokens + kWideTokens - 1) / kWideTokens, B);
  gs_wide_pass_kernel<TX, TI, TF, TO><<<grid, kWideThreads, 0, stream>>>(
      (const TI*)in, (const TF*)F, ids, slots, (TO*)out, n_tokens, r, b, imap,
      omap, ftrans);
  return cudaGetLastError();
}

}  // namespace gs
