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
// with Q_i = P^T L_i P R_i the row's GSOFT rotation (per-row factors, or a
// bank read at the rows' slot ids) and one shared q (d, N). Its rotated slab
// xr = round(x_i Q_i) is exactly gs_fused_T's output (the TPU kernel rounds
// z to x's dtype before its product), so the wrapper computes it once per
// call with gs_fused_T's kernel (csrc/gs_fused_T.cu: 64 KB at decode wq, in
// L2) and launches the product here behind it with programmatic dependent
// launch: each token is rotated once however many column tiles there are,
// and the product's CTAs load their first code stages while the rotation
// runs (griddepcontrol.wait before the first read of xr). One call, no
// round trip to the host. f32 (the checks) runs q_matmul's fp32 kernel on
// xr instead.
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
// gs_q_matmul's product (bf16). The codes stream once, as int8, through a
// 4-stage ring of 16-byte cp.async copies (64 K rows x 32-128 columns a
// stage, with the matching 64 K rows of xr); each code is widened exactly
// to bf16 in registers (the byte permute of widen4, then cvt.rn.bf16x2.f32)
// and multiplied on the tensor cores (mma.sync m16n8k16, fp32 sums) with
// the codes as A (16 output columns a fragment) and the tokens as B's 8
// columns, so 4 decode rows waste no fragment rows; a prefill chunk takes
// 16-token tiles. The scale is applied in the epilogue. The grid gives every
// SM a share of the codes: K is split over up to 8 CTAs of a cluster (8 at
// every qwen2-72b projection: more, shorter code streams ran faster than
// wider column tiles), whose partial tiles are added in rank order over
// distributed shared memory (no atomics, bit-identical reruns), and the
// column tiles narrow where they still do not fill twice the SMs (wk / wv
// at N = 1024).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace qmm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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
// gs_q_matmul's product (bf16)
// ---------------------------------------------------------------------------

namespace gsq {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKT = 64;                   // K rows a stage
constexpr int kStages = 4;
constexpr int kMaxSplits = 8;             // K splits: the cluster along K
constexpr int kXP = kKT * 2 + 16;         // xr token pitch in a stage (bytes)

__host__ __device__ inline int code_pitch(int nt) { return nt + 16; }

__host__ __device__ inline size_t stage_bytes(int nt, int ntok) {
  return (size_t)kKT * code_pitch(nt) + (size_t)ntok * kXP;
}

// the ring; after the K loop it holds the fp32 partial sums of the warps'
// K lanes (kWarps / (nt / 32) lanes of ntok tokens x nt columns)
__host__ __device__ inline size_t smem_bytes(int nt, int ntok) {
  const size_t ring = kStages * stage_bytes(nt, ntok);
  const size_t red = (size_t)(kWarps / (nt / 32)) * ntok * nt * 4;
  return ring > red ? ring : red;
}

// rows k and k + 1 of four consecutive columns (one 32-bit word each) ->
// four bf16 pairs (row k in the low half), exact: |code| <= 128 has 8
// significant bits
__device__ __forceinline__ void widen_pairs(uint32_t lo_row, uint32_t hi_row,
                                            uint32_t (&out)[4]) {
  float a[4], b[4];
  widen4(lo_row, a);
  widen4(hi_row, b);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = gs::pack_f32(a[j], b[j]);
}

// y (M, N) = round((xr @ q) * scale) for one token tile of NTOK tokens
// (blockIdx.z), one tile of nt columns (blockIdx.y) and one K split
// (blockIdx.x, the rank in a cluster of `splits` CTAs along K). Warp w owns
// 32 columns (w % (nt / 32)) and every (4 / (nt / 32))-th 16-row step of
// each 64-row stage. MMA m16n8k16 with A = q^T (16 columns x 16 rows of K:
// column 4 gid + 2 f + h is fragment f's row gid + 8 h, so one 32-bit word
// of a code row serves both fragments) and B = xr^T (16 K rows x 8 tokens).
// kVec: N % 16 == 0 and q 16-byte aligned, so codes move as 16-byte cp.async
// chunks; otherwise byte by byte.
template <int NTOK, bool kVec>
__global__ void __launch_bounds__(kThreads)
gsq_product_kernel(const __nv_bfloat16* __restrict__ xr,
                   const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N, int kps,
                   int nt) {
  constexpr int NT8 = NTOK / 8;
  extern __shared__ __align__(128) unsigned char sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n0 = blockIdx.y * nt, m0 = blockIdx.z * NTOK;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = nt / 32, kl = kWarps / nb;
  const int wcol = warp % nb, wk = warp / nb;
  const int cp = code_pitch(nt);
  const size_t sb = stage_bytes(nt, NTOK);
  const int kbeg = split * kps, kend = min(K, kbeg + kps);
  const int nchunks = (kend - kbeg + kKT - 1) / kKT;

  auto load_codes = [&](int c, int buf) {
    unsigned char* cs = sm + (size_t)buf * sb;
    const int k0 = kbeg + c * kKT;
    if constexpr (kVec) {
      const int per_row = nt / 16;
      for (int o = tid; o < kKT * per_row; o += kThreads) {
        const int rr = o / per_row, cc = o - rr * per_row;
        const int k = k0 + rr, col = n0 + cc * 16;
        const bool ok = k < kend && col < N;
        gs::cp_async16(cs + rr * cp + cc * 16,
                       ok ? q + (size_t)k * N + col : q, ok);
      }
    } else {
      for (int o = tid; o < kKT * nt; o += kThreads) {
        const int rr = o / nt, cc = o - rr * nt;
        const int k = k0 + rr, col = n0 + cc;
        cs[rr * cp + cc] = (k < kend && col < N)
                               ? (unsigned char)q[(size_t)k * N + col]
                               : (unsigned char)0;
      }
    }
  };
  auto load_xr = [&](int c, int buf) {
    unsigned char* xs = sm + (size_t)buf * sb + (size_t)kKT * cp;
    const int k0 = kbeg + c * kKT;
    for (int o = tid; o < NTOK * 8; o += kThreads) {
      const int t = o >> 3, kc = o & 7;
      const int m = m0 + t, k = k0 + kc * 8;
      unsigned char* dst = xs + t * kXP + kc * 16;
      if (m < M && k + 8 <= kend && (K & 7) == 0) {
        gs::cp_async16(dst, xr + (size_t)m * K + k, true);
      } else {
        __nv_bfloat16* d16 = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d16[e] = (m < M && k + e < kend) ? xr[(size_t)m * K + k + e]
                                           : __float2bfloat16(0.f);
      }
    }
  };

  // the codes of the first stages do not depend on the rotation in front of
  // this kernel: load them before waiting for it
  for (int c = 0; c < kStages - 1; ++c)
    if (c < nchunks) load_codes(c, c);
  gs::pdl_wait();
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load_xr(c, c);
    gs::cp_async_commit();
  }

  float acc[2][NT8][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int h = 0; h < NT8; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f][h][j] = 0.f;

  for (int it = 0; it < nchunks; ++it) {
    gs::cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed; the stage refilled below is consumed
    const int nxt = it + kStages - 1;
    if (nxt < nchunks) {
      load_codes(nxt, nxt % kStages);
      load_xr(nxt, nxt % kStages);
    }
    gs::cp_async_commit();
    const unsigned char* cs = sm + (size_t)(it % kStages) * sb;
    const unsigned char* xs = cs + (size_t)kKT * cp;
    for (int s = wk; s < kKT / 16; s += kl) {
      const unsigned char* cr = cs + (16 * s + 2 * tig) * cp + wcol * 32 + 4 * gid;
      uint32_t lo[4], hi[4];
      widen_pairs(*reinterpret_cast<const uint32_t*>(cr),
                  *reinterpret_cast<const uint32_t*>(cr + cp), lo);
      widen_pairs(*reinterpret_cast<const uint32_t*>(cr + 8 * cp),
                  *reinterpret_cast<const uint32_t*>(cr + 9 * cp), hi);
#pragma unroll
      for (int h = 0; h < NT8; ++h) {
        const unsigned char* xb = xs + (h * 8 + gid) * kXP + (16 * s + 2 * tig) * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xb + 16);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const uint32_t a[4] = {lo[2 * f], lo[2 * f + 1], hi[2 * f], hi[2 * f + 1]};
          gs::mma_16816(acc[f][h], a, b0, b1);
        }
      }
    }
  }
  gs::cp_async_wait<0>();
  __syncthreads();  // the ring is free: partial sums of the K lanes
  float* red = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int h = 0; h < NT8; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wcol * 32 + 4 * gid + 2 * f + (j >> 1);
        const int t = h * 8 + 2 * tig + (j & 1);
        red[((size_t)wk * NTOK + t) * nt + col] = acc[f][h][j];
      }
  __syncthreads();
  const int tile = NTOK * nt;
  for (int e = tid; e < tile; e += kThreads) {
    float sum = red[e];
    for (int w = 1; w < kl; ++w) sum += red[(size_t)w * tile + e];
    red[e] = sum;
  }
  cluster.sync();  // every split's partial tile is ready
  // rank c adds the splits' tiles on its slice of the outputs, in rank order
  const int per = (tile + splits - 1) / splits;
  const int ebeg = split * per, eend = min(tile, ebeg + per);
  for (int e = ebeg + tid; e < eend; e += kThreads) {
    const int t = e / nt, col = n0 + (e - t * nt);
    if (m0 + t >= M || col >= N) continue;
    float sum = 0.f;
    for (int c = 0; c < splits; ++c) sum += cluster.map_shared_rank(red, c)[e];
    y[(size_t)(m0 + t) * N + col] = __float2bfloat16(sum * scale[col]);
  }
  cluster.sync();  // peers are done reading this CTA's tile
}

template <int NTOK, bool kVec>
int launch_product(const void* xr, const void* q, const void* scale, void* y,
                   int M, int K, int N, int splits, int kps, int nt,
                   cudaStream_t stream) {
  auto kernel = gsq_product_kernel<NTOK, kVec>;
  const size_t smem = smem_bytes(nt, NTOK);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + nt - 1) / nt, (M + NTOK - 1) / NTOK);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, (const __nv_bfloat16*)xr,
                           (const int8_t*)q, (const float*)scale,
                           (__nv_bfloat16*)y, M, K, N, kps, nt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gsq

int gsq_product(const void* xr, const void* q, const void* scale, void* y,
                int M, int K, int N, int ntok, int nt, int splits, int kps,
                int vec, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 ||
      splits > gsq::kMaxSplits || kps <= 0 || kps % gsq::kKT != 0 ||
      (long long)splits * kps < K || (long long)(splits - 1) * kps >= K ||
      (nt != 32 && nt != 64 && nt != 128) || (N + nt - 1) / nt > 65535 ||
      (M + ntok - 1) / ntok > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define GSQ_CASE(NTOK_, VEC_)                                                  \
  if (ntok == NTOK_ && (vec != 0) == VEC_)                                     \
    return gsq::launch_product<NTOK_, VEC_>(xr, q, scale, y, M, K, N, splits, \
                                            kps, nt, s);
  GSQ_CASE(8, true) GSQ_CASE(8, false) GSQ_CASE(16, true) GSQ_CASE(16, false)
#undef GSQ_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace qmm

extern "C" {

const char* qmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// the constants gsq_plan mirrors: K rows a stage, largest K split
void qmm_gsq_constants(int* out) {
  out[0] = qmm::gsq::kKT;
  out[1] = qmm::gsq::kMaxSplits;
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

// gs_q_matmul's product in bf16: y = round((xr @ q) * scale), xr (M, K)
// the rotated slab; launched behind the rotation with programmatic
// dependent launch
int qmm_gsq_product_bf16(const void* xr, const void* q, const void* scale,
                         void* y, int M, int K, int N, int ntok, int nt,
                         int splits, int kps, int vec, void* stream) {
  return qmm::gsq_product(xr, q, scale, y, M, K, N, ntok, nt, splits, kps, vec,
                          stream);
}

}  // extern "C"
