// Quantized-weight matmuls for Hopper (sm_90a), bound to Python with ctypes.
//
// q_matmul replaces the Pallas TPU kernel src/repro/kernels/q_matmul.py
// q_matmul_pallas (_q_matmul_kernel):  y = (x @ q) * scale  with x (M, K)
// bf16 or f32, q (K, N) int8 codes, scale (N,) fp32 per output channel, y
// (M, N) in x's dtype. The codes are widened to fp32 in registers (exact),
// products and sums are fp32, and the scale is applied in the epilogue: the
// dequantized weight never exists in device memory.
//
// gs_q_matmul replaces gs_q_matmul_pallas (_gs_q_matmul_kernel) and its
// per-row vmap ops.gs_q_matmul_banked:  y_i = round(x_i Q_i) @ q * scale
// with Q_i = P^T L_i P R_i the row's GSOFT rotation (x (B, T, d), per-row L,
// R (B, r, b, b) in x's dtype, one shared q (d, N)). The rotated slab is
// rounded to x's dtype (as the TPU kernel does) and stays in shared memory:
// one launch, no round trip through device memory.
//
// What bounds them on the H100: at decode (M = B * T <= 16) the work is
// streaming the int8 weight once, K * N bytes (67 MB for wq, 242 MB for the
// MLP weights, 1.25 GB for the LM head), so both kernels are bound by memory
// traffic; 2 * M * K * N operations are far below the CUDA cores' rate.
//
// q_matmul design. A CTA of 8 warps owns TT tokens x (32 * C) output
// columns over a K range; lane l of every warp owns C consecutive columns
// and reads their C codes of a row as one 4 / 8 / 16-byte load, so a warp
// reads one contiguous run of 32 * C bytes per row; warp w takes rows
// w, w + 8, ... of the range, loading the codes of 4-8 rows before it
// widens any (one row at a time leaves the loop bound by the latency). The codes are widened with a byte permute into
// the mantissa of 2^23 and one fp32 subtract (exact; cheaper than int->float
// conversions, which run at a quarter of the rate). x is staged in shared
// memory as fp32, 128 rows at a time, and read as a broadcast. The 8 warps'
// partial sums are added in warp order through shared memory. When the
// column tiles alone would not fill the card (small N at decode), the wrapper
// splits K over CTAs: each split writes fp32 partials and a second small
// kernel adds them in split order and applies the scale (deterministic, no
// atomics).
//
// gs_q_matmul design. A cluster of 8 CTAs owns one token tile (TT tokens of
// any rows) and one tile of NC output columns. CTA c owns 1/8 of the GS
// blocks: it gathers its blocks of P x from the token tile, computes their
// first stage (L^T) into shared memory, reads the inputs of its blocks of
// the second stage (P^T of the first stage's output) from the CTAs that
// hold them over distributed shared memory, and computes its blocks of the
// second stage (R^T), rounded to x's dtype. So the rotated slab never leaves
// the chip, each CTA reads 1/8 of the rows' factors (their loads batched,
// several in flight per thread) and holds two (TT, d / 8) fp32 buffers,
// which leaves room for TT = 8 tokens at d = 8192 and 4 at d = 29568. CTA c
// then multiplies its blocks' K rows by the codes of the column tile, its
// threads split over columns and K lanes, adds the K lanes in shared memory,
// and the cluster adds its 8 partial tiles over distributed shared memory in
// rank order (its threads load 16 rows of codes before using any). The
// rotation is recomputed by every column tile (as on the TPU), so the
// wrapper takes wide column tiles (8 clusters on the H100, of the 15 it
// holds at once), and the grid is ordered so the token tiles of one column
// tile run side by side and share the codes in L2.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace qmm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back: the activation-dtype rounding of the TPU kernel
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Four int8 codes of one 32-bit word -> four exact floats: flip the sign
// bits (v + 128 as an unsigned byte), put each byte in the low mantissa of
// 2^23 and subtract 2^23 + 128.
__device__ __forceinline__ void widen4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// The C codes at p (C columns of one row) as floats; `avail` columns exist.
// `vec`: the row stride and p are C-byte aligned, so one vector load does.
template <int C>
__device__ __forceinline__ void load_codes(const int8_t* __restrict__ p,
                                           int avail, bool vec, float* w) {
  if (vec && avail >= C) {
    if constexpr (C == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      widen4(v.x, w); widen4(v.y, w + 4); widen4(v.z, w + 8); widen4(v.w, w + 12);
    } else if constexpr (C == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      widen4(v.x, w); widen4(v.y, w + 4);
    } else {
      static_assert(C == 4, "codes per thread: 4, 8 or 16");
      widen4(__ldg(reinterpret_cast<const unsigned int*>(p)), w);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) w[c] = c < avail ? (float)p[c] : 0.f;
  }
}

// The C codes at p (C-byte aligned) as C / 4 raw 32-bit words, widened
// later with widen4: a batch of rows is loaded before any is widened.
template <int C>
__device__ __forceinline__ void load_raw(const int8_t* __restrict__ p,
                                         unsigned int* r) {
  if constexpr (C == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (C == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = v.x; r[1] = v.y;
  } else {
    r[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// ---------------------------------------------------------------------------
// q_matmul
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKTile = 128;               // rows of x staged per step

template <int TT, int C>
constexpr size_t qmm_smem_floats() {
  return (size_t)TT * kKTile > (size_t)kWarps * TT * 32 * C
             ? (size_t)TT * kKTile : (size_t)kWarps * TT * 32 * C;
}

// grid (column tiles, K splits, token tiles). ws == nullptr: write y;
// otherwise write this split's fp32 partial sums to ws (splits, M, N).
template <typename T, int TT, int C>
__global__ void __launch_bounds__(kThreads)
q_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, T* __restrict__ y,
                float* __restrict__ ws, int M, int K, int N, int k_per_split,
                int vec) {
  extern __shared__ float smem[];
  constexpr int NCT = 32 * C;                 // columns of the CTA's tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * NCT;
  const int n = col0 + lane * C;
  const int split = blockIdx.y;
  const int t0 = blockIdx.z * TT;
  const int nt = min(TT, M - t0);
  const int kbeg = split * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int8_t* qn = q + n;

  float acc[TT][C];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[t][c] = 0.f;

  for (int kt = kbeg; kt < kend; kt += kKTile) {
    const int rows = min(kKTile, kend - kt);
    __syncthreads();                          // the previous x tile is consumed
    for (int o = threadIdx.x; o < TT * kKTile; o += kThreads) {
      const int t = o / kKTile, kk = o - t * kKTile;
      smem[o] = (t < nt && kk < rows)
                    ? to_f32(x[(size_t)(t0 + t) * K + kt + kk]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      int kk = warp;
      if (vec && n + C <= N) {
        // the codes of kQU rows are loaded before any is used: kQU vector
        // loads in flight per thread
        constexpr int kQU = C == 16 ? 4 : 8;
        for (; kk + (kQU - 1) * kWarps < rows; kk += kQU * kWarps) {
          unsigned int raw[kQU][C / 4];
#pragma unroll
          for (int u = 0; u < kQU; ++u)
            load_raw<C>(qn + (size_t)(kt + kk + u * kWarps) * N, raw[u]);
#pragma unroll
          for (int u = 0; u < kQU; ++u) {
            float w[C];
#pragma unroll
            for (int c4 = 0; c4 < C / 4; ++c4) widen4(raw[u][c4], w + 4 * c4);
#pragma unroll
            for (int t = 0; t < TT; ++t) {
              const float xv = smem[t * kKTile + kk + u * kWarps];
#pragma unroll
              for (int c = 0; c < C; ++c) acc[t][c] = fmaf(xv, w[c], acc[t][c]);
            }
          }
        }
      }
      for (; kk < rows; kk += kWarps) {        // the rest, and ragged N
        float w[C];
        load_codes<C>(qn + (size_t)(kt + kk) * N, N - n, vec, w);
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const float xv = smem[t * kKTile + kk];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[t][c] = fmaf(xv, w[c], acc[t][c]);
        }
      }
    }
  }

  // add the warps' partial sums in warp order
  __syncthreads();
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < C; ++c)
      smem[(warp * TT + t) * NCT + lane * C + c] = acc[t][c];
  __syncthreads();
  for (int o = threadIdx.x; o < TT * NCT; o += kThreads) {
    const int t = o / NCT, cc = o - t * NCT;
    const int col = col0 + cc;
    if (t >= nt || col >= N) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += smem[(w * TT + t) * NCT + cc];
    if (ws != nullptr)
      ws[((size_t)split * M + t0 + t) * N + col] = s;
    else
      y[(size_t)(t0 + t) * N + col] = from_f32<T>(s * scale[col]);
  }
}

// y = (sum of the K splits' partials, in split order) * scale
template <typename T>
__global__ void q_matmul_reduce(const float* __restrict__ ws,
                                const float* __restrict__ scale,
                                T* __restrict__ y, int splits, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[sp * mn + i];
  y[i] = from_f32<T>(s * scale[i % N]);
}

template <typename T, int TT, int C>
int launch_qmm(const void* x, const void* q, const void* scale, void* y,
               void* ws, int M, int K, int N, int splits, int k_per_split,
               int vec, cudaStream_t stream) {
  auto kernel = q_matmul_kernel<T, TT, C>;
  const size_t smem = qmm_smem_floats<TT, C>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + 32 * C - 1) / (32 * C), splits, (M + TT - 1) / TT);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const int8_t*)q, (const float*)scale, (T*)y,
      splits > 1 ? (float*)ws : nullptr, M, K, N, k_per_split, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  q_matmul_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      (const float*)ws, (const float*)scale, (T*)y, splits, M, N);
  return (int)cudaGetLastError();
}

template <typename T>
int q_matmul(const void* x, const void* q, const void* scale, void* y,
             void* ws, int M, int K, int N, int tt, int c, int splits,
             int k_per_split, int vec, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || k_per_split <= 0 ||
      (long long)splits * k_per_split < K || splits > 65535 ||
      (M + tt - 1) / tt > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define QMM_CASE(TT_, C_)                                                   \
  if (tt == TT_ && c == C_)                                                 \
    return launch_qmm<T, TT_, C_>(x, q, scale, y, ws, M, K, N, splits,     \
                                  k_per_split, vec, s);
  QMM_CASE(1, 16) QMM_CASE(2, 16) QMM_CASE(4, 16) QMM_CASE(8, 8)
  QMM_CASE(16, 4)
#undef QMM_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// gs_q_matmul (banked)
// ---------------------------------------------------------------------------

constexpr int kGThreads = 512;
constexpr int kCluster = 8;               // CTAs sharing one token tile's rotation
constexpr int kGC = 4;                    // codes per thread in the matmul
constexpr int kGU = 16;                   // rows of codes a thread loads at once
// tt * share must not exceed this (share = ceil(r / kCluster) * b): a CTA
// holds two (tt, share) fp32 buffers, 192 KB at most
constexpr int kRotTileElems = 24576;

// TT floats at p (16-byte aligned for TT >= 4) -> v
template <int TT>
__device__ __forceinline__ void load_tokens(const float* p, float* v) {
  if constexpr (TT % 4 == 0) {
#pragma unroll
    for (int t = 0; t < TT; t += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + t);
      v[t] = f.x; v[t + 1] = f.y; v[t + 2] = f.z; v[t + 3] = f.w;
    }
  } else if constexpr (TT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// One block stage of the rotation for the columns [kbeg, kend) of this
// CTA's blocks, every token of the tile with its own row's factors F[t]:
// out[(k - kbeg) * TT + t] = sum_i F_t[g][i][j] in[(g*b + i - kbeg) * TT + t]
// for column k = g*b + j. The factor loads of U rows i are issued before
// their multiply-adds, so a thread keeps U * TT loads in flight.
template <typename T, int TT, bool kRound>
__device__ __forceinline__ void rot_stage(const T* const* F, const float* in,
                                          float* out, int b, int kbeg,
                                          int kend) {
  constexpr int U = TT >= 8 ? 4 : 8;
  for (int k = kbeg + threadIdx.x; k < kend; k += kGThreads) {
    const int g = k / b, j = k - g * b;
    const size_t fo = (size_t)g * b * b + j;
    const float* ing = in + (size_t)(g * b - kbeg) * TT;
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.f;
    for (int i0 = 0; i0 < b; i0 += U) {
      float f[U][TT];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int t = 0; t < TT; ++t)
          f[u][t] = i0 + u < b ? to_f32(F[t][fo + (size_t)(i0 + u) * b]) : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < b) {
          float v[TT];
          load_tokens<TT>(ing + (size_t)(i0 + u) * TT, v);
#pragma unroll
          for (int t = 0; t < TT; ++t) acc[t] = fmaf(f[u][t], v[t], acc[t]);
        }
      }
    }
    float* o = out + (size_t)(k - kbeg) * TT;
#pragma unroll
    for (int t = 0; t < TT; ++t) o[t] = kRound ? round_to<T>(acc[t]) : acc[t];
  }
}

// grid.x = kCluster * token tiles * column tiles, token tile fastest after
// the rank (clusters of one column tile are neighbours in launch order).
// Rank c of a cluster owns the GS blocks [c * bpr, (c + 1) * bpr) of both
// stages, bpr = ceil(r / kCluster), hence the K rows [c * bpr * b, ...) of
// the product. Its buffers are token-minor: element (k, t) at k * TT + t.
template <typename T, int TT>
__global__ void __launch_bounds__(kGThreads, 1)
gs_q_matmul_kernel(const T* __restrict__ x, const T* __restrict__ Lf,
                   const T* __restrict__ Rf, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ y,
                   int n_tokens, int M, int r, int b, int N, int nthr_n,
                   int vec, int token_tiles) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int d = r * b;
  const int rank = blockIdx.x % kCluster;
  const int cl = blockIdx.x / kCluster;
  const int m0 = (cl % token_tiles) * TT;
  const int col_tile = cl / token_tiles;
  const int nt = min(TT, M - m0);
  const int bpr = (r + kCluster - 1) / kCluster;
  const int share = bpr * b;
  const int gbeg = min(r, rank * bpr), gend = min(r, gbeg + bpr);
  const int kbeg = gbeg * b, kend = gend * b;
  const int width = kend - kbeg;
  float* sbuf = smem;                          // s, then m: (share, TT)
  float* qbuf = smem + (size_t)share * TT;     // q (peers read it), then y

  const T* Lt[TT];
  const T* Rt[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    const size_t row = (size_t)(t < nt ? m0 + t : m0) / n_tokens;
    Lt[t] = Lf + row * r * b * b;
    Rt[t] = Rf + row * r * b * b;
  }

  // this CTA's blocks of s = P x: s[u] = x[(u % r) * b + u / r]; tokens past
  // the ragged end are 0
  for (int o = threadIdx.x; o < width * TT; o += kGThreads) {
    const int uu = o / TT, t = o - uu * TT;
    const int u = kbeg + uu;
    sbuf[o] = t < nt ? to_f32(x[(size_t)(m0 + t) * d + (u % r) * b + u / r])
                     : 0.f;
  }
  __syncthreads();
  // stage 1: q_g = L_g^T s_g on this CTA's blocks
  rot_stage<T, TT, false>(Lt, sbuf, qbuf, b, kbeg, kend);
  cluster.sync();                              // every CTA's q written
  // m = P^T q on this CTA's blocks: m[g*b + i] = q[i*r + g], from the
  // owner of q's block (i*r + g) / b, over distributed shared memory
#pragma unroll 4
  for (int o = threadIdx.x; o < width * TT; o += kGThreads) {
    const int mm = o / TT, t = o - mm * TT;
    const int gl = mm / b, i = mm - gl * b;
    const int v = i * r + gbeg + gl;
    const int owner = (v / b) / bpr;
    const float* src = cluster.map_shared_rank(qbuf, owner);
    sbuf[o] = src[(size_t)(v - owner * share) * TT + t];
  }
  cluster.sync();                              // no peer reads our q any more
  // stage 2: y_g = R_g^T m_g, rounded to x's dtype, into qbuf
  rot_stage<T, TT, true>(Rt, sbuf, qbuf, b, kbeg, kend);
  __syncthreads();

  // this CTA's K range of the product: threads over (K lanes, columns)
  const int nc = nthr_n * kGC;                 // columns of the tile
  const int klanes = kGThreads / nthr_n;
  const int tid_n = threadIdx.x % nthr_n, kl = threadIdx.x / nthr_n;
  const int n = col_tile * nc + tid_n * kGC;
  float acc2[TT][kGC];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < kGC; ++c) acc2[t][c] = 0.f;
  if (n < N) {
    const int8_t* qn = q + n;
    int k = kbeg + kl;
    if (vec && n + kGC <= N) {
      // the codes of kGU rows are loaded before any is used, so a thread
      // keeps kGU loads in flight (a load per row at a time is bound by
      // the memory latency, not by the bytes)
      for (; k + (kGU - 1) * klanes < kend; k += kGU * klanes) {
        unsigned int wq[kGU];
#pragma unroll
        for (int u = 0; u < kGU; ++u)
          load_raw<kGC>(qn + (size_t)(k + u * klanes) * N, wq + u);
#pragma unroll
        for (int u = 0; u < kGU; ++u) {
          float w[kGC], xv[TT];
          widen4(wq[u], w);
          load_tokens<TT>(qbuf + (size_t)(k + u * klanes - kbeg) * TT, xv);
#pragma unroll
          for (int t = 0; t < TT; ++t)
#pragma unroll
            for (int c = 0; c < kGC; ++c)
              acc2[t][c] = fmaf(xv[t], w[c], acc2[t][c]);
        }
      }
    }
    for (; k < kend; k += klanes) {            // the rest, and ragged N
      float w[kGC], xv[TT];
      load_codes<kGC>(qn + (size_t)k * N, N - n, vec, w);
      load_tokens<TT>(qbuf + (size_t)(k - kbeg) * TT, xv);
#pragma unroll
      for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int c = 0; c < kGC; ++c) acc2[t][c] = fmaf(xv[t], w[c], acc2[t][c]);
    }
  }
  __syncthreads();                             // the slab is consumed
  // add the K lanes in lane order; the sum lands in red[0 .. TT * nc)
  float* red = smem;
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < kGC; ++c)
      red[(kl * TT + t) * nc + tid_n * kGC + c] = acc2[t][c];
  __syncthreads();
  for (int o = threadIdx.x; o < TT * nc; o += kGThreads) {
    float s = 0.f;
    for (int l = 0; l < klanes; ++l) s += red[l * TT * nc + o];
    red[o] = s;
  }
  cluster.sync();                              // every partial tile ready
  // rank c adds the 8 partial tiles on its slice of the outputs, rank order
  const int per = (TT * nc + kCluster - 1) / kCluster;
  const int obeg = rank * per, oend = min(TT * nc, obeg + per);
  for (int o = obeg + threadIdx.x; o < oend; o += kGThreads) {
    const int t = o / nc, col = col_tile * nc + (o - t * nc);
    if (t >= nt || col >= N) continue;
    float s = 0.f;
    for (int c = 0; c < kCluster; ++c) s += cluster.map_shared_rank(red, c)[o];
    y[(size_t)(m0 + t) * N + col] = from_f32<T>(s * scale[col]);
  }
  cluster.sync();                              // peers are done reading red
}

template <typename T, int TT>
int launch_gqm(const void* x, const void* L, const void* R, const void* q,
               const void* scale, void* y, int n_tokens, int M, int r, int b,
               int N, int nthr_n, int vec, cudaStream_t stream) {
  auto kernel = gs_q_matmul_kernel<T, TT>;
  const size_t share = (size_t)((r + kCluster - 1) / kCluster) * b;
  const size_t slabs = 2 * share * TT;
  const size_t red = (size_t)kGThreads * kGC * TT;   // K lanes x tile
  const size_t smem = (slabs > red ? slabs : red) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = nthr_n * kGC;
  const int token_tiles = (M + TT - 1) / TT;
  const long long col_tiles = (N + nc - 1) / nc;
  const long long blocks = (long long)kCluster * token_tiles * col_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kGThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)L,
                           (const T*)R, (const int8_t*)q, (const float*)scale,
                           (T*)y, n_tokens, M, r, b, N, nthr_n, vec,
                           token_tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of the kernel for this geometry the card holds at once
// (cudaOccupancyMaxActiveClusters), or a negative error code.
template <typename T, int TT>
int active_clusters_tt(int r, int b) {
  auto kernel = gs_q_matmul_kernel<T, TT>;
  const size_t share = (size_t)((r + kCluster - 1) / kCluster) * b;
  const size_t slabs = 2 * share * TT;
  const size_t red = (size_t)kGThreads * kGC * TT;
  const size_t smem = (slabs > red ? slabs : red) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64, 1, 1);
  cfg.blockDim = dim3(kGThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
int gs_q_matmul(const void* x, const void* L, const void* R, const void* q,
                const void* scale, void* y, int n_tokens, int M, int r, int b,
                int N, int tt, int nthr_n, int vec, void* stream) {
  const long long share = (long long)((r + kCluster - 1) / kCluster) * b;
  if (M <= 0 || n_tokens <= 0 || r <= 0 || b <= 0 || N <= 0 ||
      tt * share > kRotTileElems || nthr_n < 32 || nthr_n > kGThreads ||
      kGThreads % nthr_n != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tt) {
    case 1: return launch_gqm<T, 1>(x, L, R, q, scale, y, n_tokens, M, r, b, N, nthr_n, vec, s);
    case 2: return launch_gqm<T, 2>(x, L, R, q, scale, y, n_tokens, M, r, b, N, nthr_n, vec, s);
    case 4: return launch_gqm<T, 4>(x, L, R, q, scale, y, n_tokens, M, r, b, N, nthr_n, vec, s);
    case 8: return launch_gqm<T, 8>(x, L, R, q, scale, y, n_tokens, M, r, b, N, nthr_n, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace qmm

extern "C" {

const char* qmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int qmm_cluster_size() { return qmm::kCluster; }

int qmm_rot_tile_elems() { return qmm::kRotTileElems; }

int qmm_gs_q_matmul_active_clusters(int tt, int r, int b) {
  switch (tt) {
    case 1: return qmm::active_clusters_tt<__nv_bfloat16, 1>(r, b);
    case 2: return qmm::active_clusters_tt<__nv_bfloat16, 2>(r, b);
    case 4: return qmm::active_clusters_tt<__nv_bfloat16, 4>(r, b);
    case 8: return qmm::active_clusters_tt<__nv_bfloat16, 8>(r, b);
    default: return -1;
  }
}

int qmm_q_matmul_f32(const void* x, const void* q, const void* scale, void* y,
                     void* ws, int M, int K, int N, int tt, int c, int splits,
                     int k_per_split, int vec, void* stream) {
  return qmm::q_matmul<float>(x, q, scale, y, ws, M, K, N, tt, c, splits,
                              k_per_split, vec, stream);
}

int qmm_q_matmul_bf16(const void* x, const void* q, const void* scale, void* y,
                      void* ws, int M, int K, int N, int tt, int c, int splits,
                      int k_per_split, int vec, void* stream) {
  return qmm::q_matmul<__nv_bfloat16>(x, q, scale, y, ws, M, K, N, tt, c,
                                      splits, k_per_split, vec, stream);
}

int qmm_gs_q_matmul_f32(const void* x, const void* L, const void* R,
                        const void* q, const void* scale, void* y, int n_tokens,
                        int M, int r, int b, int N, int tt, int nthr_n, int vec,
                        void* stream) {
  return qmm::gs_q_matmul<float>(x, L, R, q, scale, y, n_tokens, M, r, b, N,
                                 tt, nthr_n, vec, stream);
}

int qmm_gs_q_matmul_bf16(const void* x, const void* L, const void* R,
                         const void* q, const void* scale, void* y,
                         int n_tokens, int M, int r, int b, int N, int tt,
                         int nthr_n, int vec, void* stream) {
  return qmm::gs_q_matmul<__nv_bfloat16>(x, L, R, q, scale, y, n_tokens, M, r,
                                         b, N, tt, nthr_n, vec, stream);
}

}  // extern "C"
