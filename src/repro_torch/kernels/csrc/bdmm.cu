// Block-diagonal matmul and its blocks gradient for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bdmm.py:
//
//   bdmm (bdmm_pallas): per row z, y[z, t, g*bo + i] =
//       sum_j blocks[z, g, i, j] * x[z, t, g*bi + j]
//     blocks (B, r, bo, bi), x (B, T, r*bi) -> y (B, T, r*bo), one dtype
//     (bf16 or f32), fp32 sums. B = 1 is the unbanked product; B > 1 gives
//     every row its own blocks (the banked OFT / BOFT serving rotation,
//     which the JAX package runs as a vmap of the kernel).
//
//   bdmm_dblocks (bdmm_dblocks_pallas): per row z,
//       dblocks[z, g, i, j] = sum_t dy[z, t, g*bo + i] * x[z, t, g*bi + j]
//     dy (B, T, r*bo), x (B, T, r*bi) -> dblocks (B, r, bo, bi) in fp32.
//
// Both take rectangular blocks, bo and bi up to kMaxBlock.
//
// What bounds them on the H100. At the training path's shapes (the weight
// slabs: T = 1024 .. 29568 tokens, d = 8192 or 29568, b = 32) both move
// 2 * T * d elements against 2 * T * d * b operations: 32 fp32 FMAs per
// 4 bytes of bf16 read, under the fp32 rate of the CUDA cores and near the
// memory rate. At decode (B = 4, T = 1) the work is reading the per-row
// blocks, B * r * bo * bi elements against one token each.
//
// bdmm design. One CTA per (group tile of gt groups, token chunk, row). The
// tile's blocks are read once, coalesced (gt consecutive blocks are one
// contiguous run), into shared memory as fp32 with rows padded to bi + 1, and
// reused for every token of the chunk. Thread c owns output column c of the
// tile (group c / bo, row i = c % bo) and keeps the sums of TT tokens in
// registers; per token tile the x slice (TT x gt*bi, contiguous per token)
// is staged in shared memory as fp32. A warp covers the columns of one group
// (bo >= 8), so its x reads are broadcasts (float4 when 4 | bi) and its block
// reads walk rows of stride bi + 1 (no bank conflicts). Outputs are written
// coalesced along the columns. The wrapper shrinks gt at decode and short
// prefills so the grid still covers the 132 SMs (B = 4, T = 1, r = 256: 512
// CTAs of 2 groups), and gives each CTA several token tiles on long inputs so
// the block staging is paid once per chunk.
//
// bdmm_dblocks design. The Pallas kernel revisits one fp32 output block over
// a sequential token grid; CUDA has no sequential grid. One CTA per (group
// tile, token split, row) keeps its partial sums in registers (4 x 4 tiles
// of (i, j) per thread, bo and bi padded to multiples of 4 with zeros),
// staging TK tokens of the dy and x slices in shared memory at a time (two
// float4 reads per 16 FMAs). With one split it writes dblocks; with several
// it writes per-split partial sums, which bdmm_sum_kernel adds in split
// order. Every output has one owner and a fixed summation order: runs are
// bit-identical, and there are no atomics.

#include "gs_common.cuh"

namespace gs {

constexpr int kMaxBlock = 128;       // largest bo, bi
constexpr int kBdmmThreads = 256;    // at most gt * bo <= 256 columns per CTA
constexpr int kDbTokens = 32;        // tokens staged per dblocks iteration
constexpr int kDbThreads = 256;

// ---------------------------------------------------------------------------
// bdmm
// ---------------------------------------------------------------------------

// TT tokens per tile; JC block-row elements per register chunk (JC | bi).
template <typename T, int TT, int JC>
__global__ void __launch_bounds__(kBdmmThreads)
bdmm_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
            T* __restrict__ y, int n_tokens, int r, int bo, int bi, int gt,
            int tpc) {
  extern __shared__ __align__(16) float sm[];
  const int z = blockIdx.z;
  const int g0 = blockIdx.x * gt;
  const int ng = min(gt, r - g0);
  const int wstride = bi + 1;
  const int win = ng * bi;                              // x columns of the tile
  const int xstride = gt * bi;
  float* ws = sm;                                       // (ng * bo, bi + 1)
  float* xs = sm + ((gt * bo * wstride + 3) & ~3);      // (TT, gt * bi)
  const size_t din = (size_t)r * bi, dout = (size_t)r * bo;

  // the tile's blocks: one contiguous run of ng * bo * bi elements
  const T* bsrc = blocks + ((size_t)z * r + g0) * bo * bi;
  for (int e = threadIdx.x; e < ng * bo * bi; e += blockDim.x) {
    const int row = e / bi, j = e - row * bi;
    ws[row * wstride + j] = to_f32(bsrc[e]);
  }

  const int c = threadIdx.x;
  const bool active = c < ng * bo;
  const int gl = active ? c / bo : 0;
  const int tbeg = blockIdx.y * tpc;
  const int tend = min(n_tokens, tbeg + tpc);
  const T* xsrc = x + (size_t)z * n_tokens * din + (size_t)g0 * bi;
  T* ydst = y + (size_t)z * n_tokens * dout + (size_t)g0 * bo;

  for (int t0 = tbeg; t0 < tend; t0 += TT) {
    const int nt = min(TT, tend - t0);
    __syncthreads();                      // the previous tile is consumed
    for (int e = threadIdx.x; e < TT * win; e += blockDim.x) {
      const int t = e / win, k = e - t * win;
      xs[t * xstride + k] = t < nt ? to_f32(xsrc[(size_t)(t0 + t) * din + k]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.f;
    for (int jc = 0; jc < bi; jc += JC) {
      float w[JC];
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) w[jj] = ws[c * wstride + jc + jj];
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float* xr = xs + t * xstride + gl * bi + jc;
        if constexpr (JC % 4 == 0) {
#pragma unroll
          for (int q = 0; q < JC / 4; ++q) {
            const float4 v = reinterpret_cast<const float4*>(xr)[q];
            acc[t] += w[4 * q] * v.x;
            acc[t] += w[4 * q + 1] * v.y;
            acc[t] += w[4 * q + 2] * v.z;
            acc[t] += w[4 * q + 3] * v.w;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < JC; ++jj) acc[t] += w[jj] * xr[jj];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TT; ++t)
      if (t < nt) ydst[(size_t)(t0 + t) * dout + c] = from_f32<T>(acc[t]);
  }
}

template <typename T, int TT, int JC>
int launch_bdmm_tt_jc(const void* blocks, const void* x, void* y, int B,
                      int n_tokens, int r, int bo, int bi, int gt, int tpc,
                      cudaStream_t stream) {
  auto kernel = bdmm_kernel<T, TT, JC>;
  const size_t ws = ((size_t)gt * bo * (bi + 1) + 3) & ~(size_t)3;
  const size_t smem = (ws + (size_t)TT * gt * bi) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (gt * bo + 31) / 32 * 32;
  const dim3 grid((r + gt - 1) / gt, (n_tokens + tpc - 1) / tpc, B);
  kernel<<<grid, threads, smem, stream>>>((const T*)blocks, (const T*)x, (T*)y,
                                          n_tokens, r, bo, bi, gt, tpc);
  return (int)cudaGetLastError();
}

template <typename T, int TT>
int launch_bdmm_tt(const void* blocks, const void* x, void* y, int B,
                   int n_tokens, int r, int bo, int bi, int gt, int tpc,
                   cudaStream_t stream) {
  if (bi % 32 == 0)
    return launch_bdmm_tt_jc<T, TT, 32>(blocks, x, y, B, n_tokens, r, bo, bi,
                                        gt, tpc, stream);
  if (bi % 4 == 0)
    return launch_bdmm_tt_jc<T, TT, 4>(blocks, x, y, B, n_tokens, r, bo, bi,
                                       gt, tpc, stream);
  return launch_bdmm_tt_jc<T, TT, 1>(blocks, x, y, B, n_tokens, r, bo, bi, gt,
                                     tpc, stream);
}

// tt: tokens per tile (1, 8 or 32); gt: groups per CTA; tpc: tokens per CTA
// (a multiple of tt)
template <typename T>
int launch_bdmm(const void* blocks, const void* x, void* y, int B, int n_tokens,
                int r, int bo, int bi, int gt, int tt, int tpc,
                void* stream_ptr) {
  if (B <= 0 || B > 65535 || n_tokens <= 0 || r <= 0 || bo <= 0 || bi <= 0 ||
      bo > kMaxBlock || bi > kMaxBlock || gt <= 0 ||
      gt * (bo > bi ? bo : bi) > kBdmmThreads || tpc <= 0 || tpc % tt != 0 ||
      (n_tokens + tpc - 1) / tpc > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (tt) {
    case 1: return launch_bdmm_tt<T, 1>(blocks, x, y, B, n_tokens, r, bo, bi, gt, tpc, stream);
    case 8: return launch_bdmm_tt<T, 8>(blocks, x, y, B, n_tokens, r, bo, bi, gt, tpc, stream);
    case 32: return launch_bdmm_tt<T, 32>(blocks, x, y, B, n_tokens, r, bo, bi, gt, tpc, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bdmm_dblocks
// ---------------------------------------------------------------------------

// CTA (group tile, token split s, row z): groups [g0, g0 + ng), tokens
// [s * tps, (s + 1) * tps), into out + s * split_stride. TP 4 x 4 tiles per
// thread.
template <typename T, int TP>
__global__ void __launch_bounds__(kDbThreads)
bdmm_dblocks_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                    float* __restrict__ out, size_t split_stride, int n_tokens,
                    int r, int bo, int bi, int gt, int tps) {
  extern __shared__ __align__(16) float sm[];
  constexpr int TK = kDbTokens;
  const int z = blockIdx.z, s = blockIdx.y;
  const int g0 = blockIdx.x * gt;
  const int ng = min(gt, r - g0);
  const int bop = (bo + 3) & ~3, bip = (bi + 3) & ~3;
  const int n4j = bip / 4, tiles_g = (bop / 4) * n4j;
  const int wdy = gt * bop, wx = gt * bip;
  float* sdy = sm;                                    // (TK, gt * bop)
  float* sx = sm + TK * wdy;                          // (TK, gt * bip)

  int gl[TP], i0[TP], j0[TP];
  bool act[TP];
  float acc[TP][16];
#pragma unroll
  for (int q = 0; q < TP; ++q) {
    const int tile = threadIdx.x + q * blockDim.x;
    act[q] = tile < ng * tiles_g;
    gl[q] = act[q] ? tile / tiles_g : 0;
    const int rem = tile - gl[q] * tiles_g;
    i0[q] = act[q] ? 4 * (rem / n4j) : 0;
    j0[q] = act[q] ? 4 * (rem % n4j) : 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[q][e] = 0.f;
  }

  const size_t ddy = (size_t)r * bo, dx = (size_t)r * bi;
  const T* dysrc = dy + (size_t)z * n_tokens * ddy + (size_t)g0 * bo;
  const T* xsrc = x + (size_t)z * n_tokens * dx + (size_t)g0 * bi;
  const int tbeg = s * tps, tend = min(n_tokens, tbeg + tps);
  for (int t0 = tbeg; t0 < tend; t0 += TK) {
    const int nt = min(TK, tend - t0);
    __syncthreads();                      // the previous tokens are consumed
    for (int e = threadIdx.x; e < TK * wdy; e += blockDim.x) {
      const int t = e / wdy, k = e - t * wdy, g = k / bop, i = k - g * bop;
      sdy[e] = (t < nt && g < ng && i < bo)
                   ? to_f32(dysrc[(size_t)(t0 + t) * ddy + g * bo + i]) : 0.f;
    }
    for (int e = threadIdx.x; e < TK * wx; e += blockDim.x) {
      const int t = e / wx, k = e - t * wx, g = k / bip, j = k - g * bip;
      sx[e] = (t < nt && g < ng && j < bi)
                  ? to_f32(xsrc[(size_t)(t0 + t) * dx + g * bi + j]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
#pragma unroll
      for (int q = 0; q < TP; ++q) {
        if (!act[q]) continue;
        const float4 a = *reinterpret_cast<const float4*>(sdy + t * wdy + gl[q] * bop + i0[q]);
        const float4 b = *reinterpret_cast<const float4*>(sx + t * wx + gl[q] * bip + j0[q]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[q][u * 4 + v] += av[u] * bv[v];
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < TP; ++q) {
    if (!act[q]) continue;
    float* o = out + s * split_stride + ((size_t)z * r + g0 + gl[q]) * bo * bi;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int i = i0[q] + e / 4, j = j0[q] + e % 4;
      if (i < bo && j < bi) o[i * bi + j] = acc[q][e];
    }
  }
}

// out[e] = sum over splits s (in order) of part[s * n + e]
__global__ void bdmm_sum_kernel(const float* __restrict__ part,
                                float* __restrict__ out, size_t n, int splits) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(size_t)s * n + e];
    out[e] = acc;
  }
}

template <typename T, int TP>
int launch_dblocks_tp(const void* dy, const void* x, float* outp,
                      size_t split_stride, int B, int n_tokens, int r, int bo,
                      int bi, int gt, int threads, int splits, int tps,
                      cudaStream_t stream) {
  auto kernel = bdmm_dblocks_kernel<T, TP>;
  const int bop = (bo + 3) & ~3, bip = (bi + 3) & ~3;
  const size_t smem = (size_t)kDbTokens * gt * (bop + bip) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((r + gt - 1) / gt, splits, B);
  kernel<<<grid, threads, smem, stream>>>((const T*)dy, (const T*)x, outp,
                                          split_stride, n_tokens, r, bo, bi,
                                          gt, tps);
  return (int)cudaGetLastError();
}

// part: splits * B * r * bo * bi floats when splits > 1 (unused otherwise);
// out: B * r * bo * bi floats. tps: tokens per split.
template <typename T>
int launch_dblocks(const void* dy, const void* x, float* part, float* out,
                   int B, int n_tokens, int r, int bo, int bi, int gt,
                   int splits, int tps, void* stream_ptr) {
  if (B <= 0 || B > 65535 || n_tokens <= 0 || r <= 0 || bo <= 0 || bi <= 0 ||
      bo > kMaxBlock || bi > kMaxBlock || gt <= 0 || splits <= 0 ||
      splits > 65535 || tps <= 0 || (long long)splits * tps < n_tokens)
    return (int)cudaErrorInvalidValue;
  const int bop = (bo + 3) & ~3, bip = (bi + 3) & ~3;
  const int tiles = gt * (bop / 4) * (bip / 4);
  if (gt * (bop > bip ? bop : bip) > 256 && gt > 1) return (int)cudaErrorInvalidValue;
  const int threads = tiles >= kDbThreads ? kDbThreads : (tiles + 31) / 32 * 32;
  const int tp = (tiles + threads - 1) / threads;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t n_out = (size_t)B * r * bo * bi;
  float* outp = splits > 1 ? part : out;
  int err;
  switch (tp) {
    case 1: err = launch_dblocks_tp<T, 1>(dy, x, outp, n_out, B, n_tokens, r, bo, bi, gt, threads, splits, tps, stream); break;
    case 2: err = launch_dblocks_tp<T, 2>(dy, x, outp, n_out, B, n_tokens, r, bo, bi, gt, threads, splits, tps, stream); break;
    case 3:
    case 4: err = launch_dblocks_tp<T, 4>(dy, x, outp, n_out, B, n_tokens, r, bo, bi, gt, threads, splits, tps, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || splits == 1) return err;
  const size_t want = (n_out + 255) / 256;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  bdmm_sum_kernel<<<blocks, 256, 0, stream>>>(part, out, n_out, splits);
  return (int)cudaGetLastError();
}

}  // namespace gs

extern "C" {

int bdmm_max_block() { return gs::kMaxBlock; }

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int bdmm_f32(const void* blocks, const void* x, void* y, int B, int n_tokens,
             int r, int bo, int bi, int gt, int tt, int tpc, void* stream) {
  return gs::launch_bdmm<float>(blocks, x, y, B, n_tokens, r, bo, bi, gt, tt,
                                tpc, stream);
}

int bdmm_bf16(const void* blocks, const void* x, void* y, int B, int n_tokens,
              int r, int bo, int bi, int gt, int tt, int tpc, void* stream) {
  return gs::launch_bdmm<__nv_bfloat16>(blocks, x, y, B, n_tokens, r, bo, bi,
                                        gt, tt, tpc, stream);
}

int bdmm_dblocks_f32(const void* dy, const void* x, float* part, float* out,
                     int B, int n_tokens, int r, int bo, int bi, int gt,
                     int splits, int tps, void* stream) {
  return gs::launch_dblocks<float>(dy, x, part, out, B, n_tokens, r, bo, bi,
                                   gt, splits, tps, stream);
}

int bdmm_dblocks_bf16(const void* dy, const void* x, float* part, float* out,
                      int B, int n_tokens, int r, int bo, int bi, int gt,
                      int splits, int tps, void* stream) {
  return gs::launch_dblocks<__nv_bfloat16>(dy, x, part, out, B, n_tokens, r,
                                           bo, bi, gt, splits, tps, stream);
}

}  // extern "C"
