// Backward of the fused GSOFT rotation for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces the Pallas TPU kernels src/repro/kernels/gs_fused.py
// gs_fused_bwd_pallas (with_dx=True) and gs_fused_grads_pallas
// (with_dx=False), both _gs_fused_bwd_kernel: for y[i] = P^T L_i P R_i x[i]
// and the cotangent dy[i], per row i and token t
//
//   u = R x,  v = P u,  dw = P dy,  dL[g] += dw_g v_g^T,
//   dv = L^T dw,  du = P^T dv,  dR[g] += du_g x_g^T,  dx = R^T du,
//
// with dL, dR (B, r, b, b) summed over the tokens in fp32 and dx in x's
// dtype. One source serves both: WITH_DX is a template flag, as with_dx is
// a static argument of the Pallas body.
//
// Design. The TPU kernel keeps one (r, b, b) fp32 output block resident and
// revisits it on every step of a sequential grid. On the H100 blocks run in
// parallel and in no order, and the two factor gradients of one row are
// 2 * d * b fp32 values (2 MB at d = 8192, 7.6 MB at d = 29568): more than a
// CTA holds on chip. So the work is split in two passes:
//
//   pass 1 (gs_bwd_tile_kernel): one CTA per tile of TT tokens, as in the
//     forward kernels. The tile lives in shared memory as fp32 (one buffer
//     of TT * d <= 32768 floats, so d = 29568 fits in f32 with TT = 1: x is
//     used up before dy is loaded into the same buffer). It computes the
//     stages above, writes dx, and writes the three per-token operands of the
//     factor-gradient sums, v, dw and du, as fp32 rows grouped by block
//     (workspace 3 * B * T * d floats).
//   pass 2 (gs_bwd_reduce_kernel): one CTA per (block g, token split, row)
//     sums dw_g v_g^T and du_g x_g^T over its tokens in registers (4 x 4
//     tiles of the b x b block per thread), staging TK tokens of the four
//     b-wide operand slices in shared memory at a time.
//     With one split it writes dL, dR; with several it writes per-split
//     partial sums, which gs_bwd_sum_kernel adds in split order.
//
// Every output element is owned by one thread of one CTA and summed in a
// fixed order, so repeated runs are bit-identical (no atomics).
//
// What bounds it on the H100: the bytes. Reading x and dy and writing dx is
// 3 * T * d elements against 10 * T * d * b operations; the workspace adds
// 12 bytes written and read per element, and pass 2 runs on fp32 CUDA cores.
// Measured, pass 1 is held back by the factor stream instead: a tile of TT
// tokens (TT <= 4 at d = 8192, 1 at d = 29568) reads all 3 * d * b factor
// elements from L2, so each feeds only TT multiply-adds. (Padding the
// shared-memory rows to remove the shuffles' bank conflicts did not change
// pass 1's time.) More tokens per factor read (a cluster sharing one token
// tile), keeping the operands on chip, and tensor cores for the b x b
// stages and sums are later work.

#include "gs_common.cuh"

namespace gs {

constexpr int kReduceTokens = 64;   // tokens staged per pass-2 iteration
constexpr int kReduceThreads = 256;

// P = P_(r, d) as a gather: (P y)[c] = y[sigma(c)]
__device__ __forceinline__ int p_src(int c, int r, int b) { return (c % r) * b + c / r; }
// P^T as a gather: (P^T y)[k] = y[tau(k)]
__device__ __forceinline__ int pt_src(int k, int r, int b) { return (k % b) * r + k / b; }

// buf[t][k] = buf[t][src(k)] for every token of the tile, through registers;
// the permuted rows of the first nt tokens are also written to ws (fp32,
// row stride d).
template <int TT, bool kP>
__device__ __forceinline__ void permute_tile(float* buf, float* __restrict__ ws,
                                             int d, int r, int b, int nt,
                                             float (&acc)[kPerThread / TT][TT]) {
  constexpr int KP = kPerThread / TT;
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    const int k = threadIdx.x + p * kThreads;
    if (k < d) {
      const int s = kP ? p_src(k, r, b) : pt_src(k, r, b);
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[p][t] = buf[t * d + s];
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    const int k = threadIdx.x + p * kThreads;
    if (k < d) {
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        buf[t * d + k] = acc[p][t];
        if (t < nt) ws[(size_t)t * d + k] = acc[p][t];
      }
    }
  }
  __syncthreads();
}

template <typename T, int TT>
__device__ __forceinline__ void load_tile(float* buf, const T* __restrict__ src,
                                          int d, int nt) {
  for (int o = threadIdx.x; o < TT * d; o += kThreads) {
    const int t = o / d;
    buf[o] = t < nt ? to_f32(src[o]) : 0.f;
  }
  __syncthreads();
}

// Pass 1. Factors: RT = R^T (for u = R x), L (for dv = L^T dw), R (for
// dx = R^T du), each (B, r, b, b); the block product of gs_common.cuh reads
// F[g][i][j] as the weight of input i for output j.
template <typename T, int TT, bool WITH_DX>
__global__ void __launch_bounds__(kThreads, 1)
gs_bwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const T* __restrict__ L, const T* __restrict__ R,
                   const T* __restrict__ RT, T* __restrict__ dx,
                   float* __restrict__ ws_v, float* __restrict__ ws_dw,
                   float* __restrict__ ws_du, int n_tokens, int r, int b) {
  extern __shared__ float buf[];                     // (TT, d) fp32
  const int d = r * b;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int nt = min(TT, n_tokens - t0);
  const size_t off = ((size_t)row * n_tokens + t0) * d;
  const size_t foff = (size_t)row * r * b * b;
  float acc[kPerThread / TT][TT];

  // u = R x, in place
  load_tile<T, TT>(buf, x + off, d, nt);
  block_stage<T, TT, false>(RT + foff, buf, d, r, b, 0, d, acc);
  __syncthreads();
  store_tile<TT>(buf, d, 0, d, acc);
  __syncthreads();
  // v = P u -> workspace (buf is reloaded next, so only ws keeps it)
  for (int o = threadIdx.x; o < nt * d; o += kThreads) {
    const int t = o / d, c = o - t * d;
    ws_v[off + o] = buf[t * d + p_src(c, r, b)];
  }
  __syncthreads();

  // dw = P dy
  load_tile<T, TT>(buf, dy + off, d, nt);
  permute_tile<TT, true>(buf, ws_dw + off, d, r, b, nt, acc);
  // dv = L^T dw
  block_stage<T, TT, false>(L + foff, buf, d, r, b, 0, d, acc);
  __syncthreads();
  store_tile<TT>(buf, d, 0, d, acc);
  __syncthreads();
  // du = P^T dv
  permute_tile<TT, false>(buf, ws_du + off, d, r, b, nt, acc);

  if (WITH_DX) {
    // dx = R^T du
    block_stage<T, TT, false>(R + foff, buf, d, r, b, 0, d, acc);
    constexpr int KP = kPerThread / TT;
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const int k = threadIdx.x + p * kThreads;
      if (k < d) {
#pragma unroll
        for (int t = 0; t < TT; ++t)
          if (t < nt) dx[off + (size_t)t * d + k] = from_f32<T>(acc[p][t]);
      }
    }
  }
}

// Pass 2: block g of row `row`, tokens [s * tps, (s + 1) * tps):
// dL[g][i][j] = sum_t dw[t][g*b + i] v[t][g*b + j] and
// dR[g][i][j] = sum_t du[t][g*b + i] x[t][g*b + j], into
// outL/outR + s * split_stride + (row * r + g) * b * b.
//
// Each thread owns 4 x 4 tiles of (i, j) of both sums (TP tiles; b is padded
// to bp, a multiple of 4, with zeros), so per token it reads four float4
// from shared memory for 32 fused multiply-adds. When the tiles are fewer
// than the threads, the threads split the staged tokens into `slices`
// (token t goes to slice t % slices) and the slices' sums are added in
// slice order at the end.
template <typename T, int TP>
__global__ void __launch_bounds__(kReduceThreads)
gs_bwd_reduce_kernel(const float* __restrict__ ws_v,
                     const float* __restrict__ ws_dw,
                     const float* __restrict__ ws_du, const T* __restrict__ x,
                     float* __restrict__ outL, float* __restrict__ outR,
                     size_t split_stride, int n_tokens, int r, int b, int tps) {
  extern __shared__ __align__(16) float sm[];        // 4 x (TK, bp) fp32
  constexpr int NT = kReduceThreads, TK = kReduceTokens;
  const int g = blockIdx.x, s = blockIdx.y, row = blockIdx.z;
  const int d = r * b, bp = (b + 3) & ~3, n4 = bp / 4, tiles = n4 * n4;
  const int slices = tiles >= NT ? 1 : NT / tiles;
  const int slice = slices > 1 ? threadIdx.x / tiles : 0;
  float* sdw = sm;
  float* sv = sdw + TK * bp;
  float* sdu = sv + TK * bp;
  float* sx = sdu + TK * bp;
  int i0[TP], j0[TP];
  bool act[TP];
  float aL[TP][16], aR[TP][16];
#pragma unroll
  for (int q = 0; q < TP; ++q) {
    const int tile = slices > 1 ? threadIdx.x % tiles : threadIdx.x + q * NT;
    act[q] = slices > 1 ? (q == 0 && slice < slices) : tile < tiles;
    i0[q] = 4 * (tile / n4);
    j0[q] = 4 * (tile % n4);
#pragma unroll
    for (int e = 0; e < 16; ++e) aL[q][e] = aR[q][e] = 0.f;
  }
  const int tbeg = s * tps, tend = min(n_tokens, tbeg + tps);
  const size_t base = (size_t)row * n_tokens * d + (size_t)g * b;
  for (int t0 = tbeg; t0 < tend; t0 += TK) {
    const int nt = min(TK, tend - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < TK * bp; e += NT) {
      const int t = e / bp, i = e - t * bp;
      float w = 0.f, v = 0.f, u = 0.f, xv = 0.f;
      if (t < nt && i < b) {
        const size_t gi = base + (size_t)(t0 + t) * d + i;
        w = ws_dw[gi];
        v = ws_v[gi];
        u = ws_du[gi];
        xv = to_f32(x[gi]);
      }
      sdw[e] = w;
      sv[e] = v;
      sdu[e] = u;
      sx[e] = xv;
    }
    __syncthreads();
    for (int t = slice; t < nt; t += slices) {
#pragma unroll
      for (int q = 0; q < TP; ++q) {
        if (!act[q]) continue;
        const float4 w4 = *reinterpret_cast<const float4*>(sdw + t * bp + i0[q]);
        const float4 u4 = *reinterpret_cast<const float4*>(sdu + t * bp + i0[q]);
        const float4 v4 = *reinterpret_cast<const float4*>(sv + t * bp + j0[q]);
        const float4 x4 = *reinterpret_cast<const float4*>(sx + t * bp + j0[q]);
        const float wa[4] = {w4.x, w4.y, w4.z, w4.w}, ua[4] = {u4.x, u4.y, u4.z, u4.w};
        const float va[4] = {v4.x, v4.y, v4.z, v4.w}, xa[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            aL[q][a * 4 + c] += wa[a] * va[c];
            aR[q][a * 4 + c] += ua[a] * xa[c];
          }
        }
      }
    }
  }
  const size_t obase = s * split_stride + ((size_t)row * r + g) * b * b;
  if (slices == 1) {
#pragma unroll
    for (int q = 0; q < TP; ++q) {
      if (!act[q]) continue;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int i = i0[q] + e / 4, j = j0[q] + e % 4;
        if (i < b && j < b) {
          outL[obase + i * b + j] = aL[q][e];
          outR[obase + i * b + j] = aR[q][e];
        }
      }
    }
    return;
  }
  // add the slices' sums in slice order (the staging area is free now)
  __syncthreads();
  float* red = sm;                                   // (slices, tiles, 32)
  if (act[0]) {
    float* mine = red + ((size_t)slice * tiles + threadIdx.x % tiles) * 32;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      mine[e] = aL[0][e];
      mine[16 + e] = aR[0][e];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < tiles * 32; o += NT) {
    float acc = 0.f;
    for (int sl = 0; sl < slices; ++sl) acc += red[(size_t)sl * tiles * 32 + o];
    const int tile = o / 32, k = o % 32, e = k % 16;
    const int i = 4 * (tile / n4) + e / 4, j = 4 * (tile % n4) + e % 4;
    if (i < b && j < b) (k < 16 ? outL : outR)[obase + i * b + j] = acc;
  }
}

// out[e] = sum over splits s (in order) of part[s * n + e]
__global__ void gs_bwd_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t n, int splits) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(size_t)s * n + e];
    out[e] = acc;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int TT, bool WITH_DX>
int launch_tile(const void* x, const void* dy, const void* L, const void* R,
                const void* RT, void* dx, float* ws, int B, int n_tokens, int r,
                int b, cudaStream_t stream) {
  auto kernel = gs_bwd_tile_kernel<T, TT, WITH_DX>;
  const size_t smem = (size_t)TT * r * b * sizeof(float);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * n_tokens * r * b;
  const unsigned tiles = (n_tokens + TT - 1) / TT;
  kernel<<<dim3(tiles, B), kThreads, smem, stream>>>(
      (const T*)x, (const T*)dy, (const T*)L, (const T*)R, (const T*)RT, (T*)dx,
      ws, ws + n, ws + 2 * n, n_tokens, r, b);
  return (int)cudaGetLastError();
}

template <typename T, int TP>
int launch_reduce(const float* ws, const void* x, float* outL, float* outR,
                  size_t split_stride, int B, int n_tokens, int r, int b,
                  int splits, int tps, cudaStream_t stream) {
  auto kernel = gs_bwd_reduce_kernel<T, TP>;
  const int bp = (b + 3) & ~3;
  const size_t stage = (size_t)4 * kReduceTokens * bp * sizeof(float);
  const size_t red = (size_t)kReduceThreads * 32 * sizeof(float);
  const size_t smem = stage > red ? stage : red;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * n_tokens * r * b;
  kernel<<<dim3(r, splits, B), kReduceThreads, smem, stream>>>(
      ws, ws + n, ws + 2 * n, (const T*)x, outL, outR, split_stride, n_tokens,
      r, b, tps);
  return (int)cudaGetLastError();
}

// 4 x 4 tiles per thread of pass 2: 1 for b <= 64, else 2 or 4 (b <= 128)
template <typename T>
int dispatch_reduce(const float* ws, const void* x, float* outL, float* outR,
                    size_t split_stride, int B, int n_tokens, int r, int b,
                    int splits, int tps, cudaStream_t stream) {
  const int n4 = ((b + 3) & ~3) / 4;
  const int tp = (n4 * n4 + kReduceThreads - 1) / kReduceThreads;
  if (tp <= 1)
    return launch_reduce<T, 1>(ws, x, outL, outR, split_stride, B, n_tokens, r,
                               b, splits, tps, stream);
  if (tp <= 2)
    return launch_reduce<T, 2>(ws, x, outL, outR, split_stride, B, n_tokens, r,
                               b, splits, tps, stream);
  if (tp <= 4)
    return launch_reduce<T, 4>(ws, x, outL, outR, split_stride, B, n_tokens, r,
                               b, splits, tps, stream);
  return (int)cudaErrorInvalidValue;
}

// ws: 3 * B * T * d floats (v, dw, du); part: 2 * splits * B * r * b * b
// floats when splits > 1 (unused otherwise); dL, dR: B * r * b * b floats.
template <typename T, bool WITH_DX>
int launch_bwd(const void* x, const void* dy, const void* L, const void* R,
               const void* RT, void* dx, float* ws, float* part, float* dL,
               float* dR, int B, int n_tokens, int r, int b, int tt, int splits,
               void* stream_ptr) {
  if (bad_shape(B, n_tokens, r, b, tt) || b > 128 || splits <= 0 ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err;
  switch (tt) {
    case 1: err = launch_tile<T, 1, WITH_DX>(x, dy, L, R, RT, dx, ws, B, n_tokens, r, b, stream); break;
    case 2: err = launch_tile<T, 2, WITH_DX>(x, dy, L, R, RT, dx, ws, B, n_tokens, r, b, stream); break;
    case 4: err = launch_tile<T, 4, WITH_DX>(x, dy, L, R, RT, dx, ws, B, n_tokens, r, b, stream); break;
    case 8: err = launch_tile<T, 8, WITH_DX>(x, dy, L, R, RT, dx, ws, B, n_tokens, r, b, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const size_t n_out = (size_t)B * r * b * b;
  const int tps =
      ((n_tokens + splits - 1) / splits + kReduceTokens - 1) / kReduceTokens * kReduceTokens;
  float* outL = splits > 1 ? part : dL;
  float* outR = splits > 1 ? part + splits * n_out : dR;
  err = dispatch_reduce<T>(ws, x, outL, outR, n_out, B, n_tokens, r, b, splits,
                           tps, stream);
  if (err != 0 || splits == 1) return err;
  const size_t want = (n_out + 255) / 256;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  gs_bwd_sum_kernel<<<blocks, 256, 0, stream>>>(part, dL, n_out, splits);
  gs_bwd_sum_kernel<<<blocks, 256, 0, stream>>>(part + splits * n_out, dR, n_out,
                                                splits);
  return (int)cudaGetLastError();
}

}  // namespace gs

extern "C" {

int gs_max_tile_elems() { return gs::kMaxTileElems; }

int gs_reduce_tokens() { return gs::kReduceTokens; }

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gs_fused_bwd_f32(const void* x, const void* dy, const void* L, const void* R,
                     const void* RT, void* dx, float* ws, float* part, float* dL,
                     float* dR, int B, int n_tokens, int r, int b, int tt,
                     int splits, void* stream) {
  return gs::launch_bwd<float, true>(x, dy, L, R, RT, dx, ws, part, dL, dR, B,
                                     n_tokens, r, b, tt, splits, stream);
}

int gs_fused_bwd_bf16(const void* x, const void* dy, const void* L, const void* R,
                      const void* RT, void* dx, float* ws, float* part, float* dL,
                      float* dR, int B, int n_tokens, int r, int b, int tt,
                      int splits, void* stream) {
  return gs::launch_bwd<__nv_bfloat16, true>(x, dy, L, R, RT, dx, ws, part, dL,
                                             dR, B, n_tokens, r, b, tt, splits,
                                             stream);
}

int gs_fused_grads_f32(const void* x, const void* dy, const void* L,
                       const void* R, const void* RT, void* dx, float* ws,
                       float* part, float* dL, float* dR, int B, int n_tokens,
                       int r, int b, int tt, int splits, void* stream) {
  return gs::launch_bwd<float, false>(x, dy, L, R, RT, dx, ws, part, dL, dR, B,
                                      n_tokens, r, b, tt, splits, stream);
}

int gs_fused_grads_bf16(const void* x, const void* dy, const void* L,
                        const void* R, const void* RT, void* dx, float* ws,
                        float* part, float* dL, float* dR, int B, int n_tokens,
                        int r, int b, int tt, int splits, void* stream) {
  return gs::launch_bwd<__nv_bfloat16, false>(x, dy, L, R, RT, dx, ws, part, dL,
                                              dR, B, n_tokens, r, b, tt, splits,
                                              stream);
}

}  // extern "C"
