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
// indices from 0 (as the reference); keys at or past Sk are masked, and
// their zero-filled rows add nothing.
//
// Design. A CTA owns a block of query rows of one (batch, head) and one
// chunk of the output features, and walks the 64-key tiles up to the
// diagonal (causal) or Sk. The grid walks the query blocks heaviest first
// (blockIdx.y counts down), so the causal diagonal's longest CTAs start
// first. K and V tiles come through a ring of 16-byte cp.async copies, kept
// in their own dtype (zero-filled past Sk and past D): one barrier a ring
// item (a K chunk or a V chunk of a tile).
// * Route 1, bf16 (flash_tc_kernel): 4 warps on the tensor cores, each with
//   MT m-tiles of 16 query rows. S = Q K^T by mma.sync m16n8k16 (bf16 in,
//   fp32 sums), K fragments by ldmatrix from rows padded to an odd number
//   of 16-byte units (no bank conflicts); the online softmax in registers
//   (row max and sum over the quad by shuffles; p = 2^(s scale log2 e - m)
//   by one FMA and the SFU); P turned into bf16 A fragments in place (the C
//   layout of two n-tiles is the A layout of one k-tile); O += P V with V
//   through ldmatrix.trans. D is padded to a multiple of 16 (zeros). Up to
//   D = 128 the CTA owns all of O, its Q block staged once: with MT = 2
//   (128 rows, chunks of 64 or more) every K / V fragment feeds two MMAs and
//   Q fragments come from shared memory, with MT = 1 (64 rows) they stay in
//   registers. Past 128 the output features are split over CTAs in chunks
//   of 128 (the O accumulator of a thread stays at 64 registers an m-tile),
//   each CTA recomputing S over all of D with Q and K streamed through the
//   ring chunk by chunk, so no D is too wide for shared memory (a ring item
//   holds 64 rows of one 128-wide chunk).
// * Route 2, f32 (flash_cc_kernel): the CUDA cores, fp32 throughout (TF32
//   would not meet the f32 tolerance). 256 threads; each owns a 4 x 4 block
//   of the 64 x 64 score tile (rows tr + 16 i, keys tc + 16 j) and a 4 x 8
//   block of the 64 x 128 output chunk, so one 16-byte shared load feeds
//   four to eight FMAs; Q and K stream through the ring in 64-wide chunks of
//   D, V in 128-wide chunks (the output split over CTAs past D = 128), and P
//   passes through a shared tile between the two products.
// At long sequences the bf16 route is bound by the tensor cores' operations
// (4 B H Sq Sk D, halved when causal), the f32 route by the fp32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace fa {

using gs::bf16;

constexpr int kBQ = 64;                 // query rows a CTA (route 2)
constexpr int kBK = 64;                 // keys a tile (route 2)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// Rows [r0, r0 + kRows) x columns [c0, c0 + width) of a row-strided matrix
// into shared memory (row pitch `pitch` elements), zero where the row is at
// or past `nrows` or the column at or past D. vec: 16-byte cp.async copies
// (base, row stride and D 16-byte aligned, width a multiple of 16 bytes);
// otherwise element by element, synchronously (visible after the ring's
// next barrier either way).
template <typename T, int kRows>
__device__ __forceinline__ void load_rows(T* dst, int pitch, const T* src,
                                          long long stride, int r0, int nrows,
                                          int c0, int width, int D, bool vec,
                                          int tid, int nthreads) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = width / E;
    for (int o = tid; o < kRows * per_row; o += nthreads) {
      const int r = o / per_row, col = c0 + (o - r * per_row) * E;
      const bool ok = r0 + r < nrows && col < D;
      gs::cp_async16(dst + r * pitch + (col - c0),
                     ok ? src + (long long)(r0 + r) * stride + col : src, ok);
    }
  } else {
    for (int o = tid; o < kRows * width; o += nthreads) {
      const int r = o / width, c = o - r * width;
      const bool ok = r0 + r < nrows && c0 + c < D;
      dst[r * pitch + c] =
          ok ? src[(long long)(r0 + r) * stride + c0 + c] : from_f32<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// route 1: bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpsTC = 4;
constexpr int kThreadsTC = 32 * kWarpsTC;
constexpr int kStagesTC = 2;
constexpr int kBKT = 64;                // keys a tile
constexpr int kNT = kBKT / 8;           // score n-tiles a warp
constexpr int kKT = kBKT / 16;          // P k-tiles a warp
constexpr int kMaxChunk = 128;          // output features a CTA (and Q / K chunk)

// 2^x on the special function unit (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// query rows a CTA: 16 a warp and m-tile
__host__ __device__ constexpr int tc_rows(int mt) { return 16 * kWarpsTC * mt; }

// shared bytes: (kQS: none; else the Q tile) + the ring; a ring item is a
// K chunk (with its Q chunk when kQS) or a V chunk, rows of W + 8
__host__ __device__ constexpr size_t tc_smem(int W, bool qs, int mt) {
  return ((qs ? 0 : (size_t)tc_rows(mt) * (W + 8)) +
          (size_t)kStagesTC * ((qs ? tc_rows(mt) : 0) + kBKT) * (W + 8)) *
         sizeof(bf16);
}

// grid (H * nc, ceil(Sq / rows), B); nc output chunks of W = 16 KC
// features. Warp w owns query rows 16 (MT w + i) of the CTA's block, m-tile
// i < MT: with MT = 2 each K / V fragment feeds two MMAs. kQS (nc > 1, W =
// 128): a tile's ring items are its nc (Q, K) chunk pairs, then its V chunk;
// otherwise (nc = 1, W >= D) K, then V, the Q block staged once (its
// fragments held in registers when MT = 1).
template <int KC, bool kQS, int MT>
__global__ void __launch_bounds__(kThreadsTC)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, Strides st,
                int H, int KH, int Sq, int Sk, int D, int nc, float sl2,
                int causal, int vec) {
  constexpr int W = 16 * KC, P = W + 8, NT = 2 * KC;
  constexpr int BQ = tc_rows(MT);
  constexpr bool kQReg = MT == 1 && !kQS;
  constexpr int kSlot = ((kQS ? BQ : 0) + kBKT) * P;
  extern __shared__ __align__(128) unsigned char smraw[];
  bf16* const qsm = reinterpret_cast<bf16*>(smraw);
  bf16* const ring = qsm + (kQS ? 0 : BQ * P);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x / nc, c = blockIdx.x - h * nc;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* kp = k + b * st.kb + kvh * st.kh;
  const bf16* vp = v + b * st.vb + kvh * st.vh;
  int nkb = (Sk + kBKT - 1) / kBKT;
  if (causal) nkb = min(nkb, (min(q0 + BQ, Sq) - 1) / kBKT + 1);
  const int kch = kQS ? nc : 1;          // K chunks a tile
  const int per_tile = kch + 1;
  const int items = nkb * per_tile;
  const int w0 = q0 + 16 * MT * warp;    // the warp's first query row

  auto load = [&](int it) {
    const int kb = it / per_tile, j = it - kb * per_tile;
    bf16* slot = ring + (it % kStagesTC) * kSlot;
    if (j < kch) {
      if (kQS)
        load_rows<bf16, BQ>(slot, P, qp, st.qs, q0, Sq, j * W, W, D, vec, tid,
                            kThreadsTC);
      load_rows<bf16, kBKT>(slot + (kQS ? BQ * P : 0), P, kp, st.ks,
                            kb * kBKT, Sk, j * W, W, D, vec, tid, kThreadsTC);
    } else {
      load_rows<bf16, kBKT>(slot, P, vp, st.vs, kb * kBKT, Sk, c * W, W, D,
                            vec, tid, kThreadsTC);
    }
  };

  if (!kQS)
    load_rows<bf16, BQ>(qsm, P, qp, st.qs, q0, Sq, 0, W, D, vec, tid,
                        kThreadsTC);
#pragma unroll
  for (int s = 0; s < kStagesTC - 1; ++s) {
    if (s < items) load(s);
    gs::cp_async_commit();
  }

  uint32_t qf[kQReg ? KC : 1][4];
  float sacc[MT][kNT][4], oacc[MT][NT][4];
  uint32_t pf[MT][kKT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][n][e] = 0.f;
  }

  // ldmatrix row / column offsets of this lane: an A operand (16 rows x 16
  // columns: matrices rows 0-7 | 8-15, then columns 8-15) and a B operand
  // of two n-tiles (rows 0-7 | 8-15 are the two n-tiles, columns 0-7 | 8-15
  // the two k halves)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  for (int it = 0; it < items; ++it) {
    gs::cp_async_wait<kStagesTC - 2>();
    __syncthreads();
    if (it + kStagesTC - 1 < items) load(it + kStagesTC - 1);
    gs::cp_async_commit();
    if (kQReg && it == 0) {
#pragma unroll
      for (int kt = 0; kt < (kQReg ? KC : 1); ++kt)
        gs::ldsm_x4(qf[kt], qsm + (16 * warp + a_row) * P + kt * 16 + a_col);
    }
    const int kb = it / per_tile, j = it - kb * per_tile;
    const int k0 = kb * kBKT;
    // a warp whose rows all precede the tile's keys (causal), or lie past
    // Sq, has nothing to add
    if (w0 >= Sq || (causal && k0 > w0 + 16 * MT - 1)) continue;
    const bf16* slot = ring + (it % kStagesTC) * kSlot;
    if (j < kch) {
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[i][n][e] = 0.f;
      }
      const bf16* qbase = kQS ? slot : qsm;
      const bf16* kt_base = slot + (kQS ? BQ * P : 0);
#pragma unroll
      for (int kt = 0; kt < KC; ++kt) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (kQReg) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[i][e] = qf[kQReg ? kt : 0][e];
          } else {
            gs::ldsm_x4(a[i], qbase + (16 * (MT * warp + i) + a_row) * P +
                                  kt * 16 + a_col);
          }
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t r[4];
          gs::ldsm_x4(r, kt_base + (np * 16 + b_row) * P + kt * 16 + b_col);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            gs::mma_16816(sacc[i][2 * np], a[i], r[0], r[1]);
            gs::mma_16816(sacc[i][2 * np + 1], a[i], r[2], r[3]);
          }
        }
      }
      if (j < kch - 1) continue;
      // the online softmax over this tile, in registers: thread holds rows
      // 16 (MT w + i) + gid (e = 0, 1) and + 8 (e = 2, 3), keys 8 n + 2 tig +
      // e % 2; the max of the raw scores, m in the scaled log2 domain, p =
      // 2^(s scale log2(e) - m) by one FMA and the SFU
      const bool edge = k0 + kBKT > Sk || (causal && k0 + kBKT - 1 > w0);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = w0 + 16 * i + gid;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (edge) {
              const int col = k0 + n * 8 + 2 * tig + (e & 1);
              if (col >= Sk || (causal && col > r0 + (e >> 1) * 8))
                sacc[i][n][e] = kNegInf;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], sacc[i][n][e]);
          }
        float corr[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
          const float mn = fmaxf(m[i][hf], mx[hf] * sl2);
          corr[hf] = ex2(m[i][hf] - mn);
          m[i][hf] = mn;
          l[i][hf] *= corr[hf];
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float s = sacc[i][n][e];
            float p = ex2(fmaf(s, sl2, -m[i][e >> 1]));
            if (edge && s <= 0.5f * kNegInf) p = 0.f;
            l[i][e >> 1] += p;
            sacc[i][n][e] = p;
          }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          oacc[i][n][0] *= corr[0];
          oacc[i][n][1] *= corr[0];
          oacc[i][n][2] *= corr[1];
          oacc[i][n][3] *= corr[1];
        }
        // P as bf16 A fragments: k-tile t is n-tiles 2t (keys 0-7), 2t + 1
#pragma unroll
        for (int t = 0; t < kKT; ++t) {
          pf[i][t][0] = gs::pack_f32(sacc[i][2 * t][0], sacc[i][2 * t][1]);
          pf[i][t][1] = gs::pack_f32(sacc[i][2 * t][2], sacc[i][2 * t][3]);
          pf[i][t][2] = gs::pack_f32(sacc[i][2 * t + 1][0], sacc[i][2 * t + 1][1]);
          pf[i][t][3] = gs::pack_f32(sacc[i][2 * t + 1][2], sacc[i][2 * t + 1][3]);
        }
      }
    } else {
      // O += P V: B fragments of two feature n-tiles from V (keys x
      // features) by ldmatrix.trans
#pragma unroll
      for (int t = 0; t < kKT; ++t)
#pragma unroll
        for (int np = 0; np < KC; ++np) {
          uint32_t r[4];
          gs::ldsm_x4_trans(r, slot + (t * 16 + a_row) * P + np * 16 + a_col);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            gs::mma_16816(oacc[i][2 * np], pf[i][t], r[0], r[1]);
            gs::mma_16816(oacc[i][2 * np + 1], pf[i][t], r[2], r[3]);
          }
        }
    }
  }
  gs::cp_async_wait<0>();
  bf16* op = out + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float lm[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = l[i][hf];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      lm[hf] = fmaxf(x, 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = c * W + n * 8 + 2 * tig;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = w0 + 16 * i + gid + 8 * hf;
        if (row >= Sq || col >= D) continue;
        bf16* p = op + row * st.os + col;
        const bf16 lo = __float2bfloat16(oacc[i][n][2 * hf] / lm[hf]);
        if (col + 1 < D) {
          const bf16 hi = __float2bfloat16(oacc[i][n][2 * hf + 1] / lm[hf]);
          if ((reinterpret_cast<uintptr_t>(p) & 3) == 0) {
            *reinterpret_cast<uint32_t*>(p) = gs::pack_bf16(lo, hi);
          } else {
            p[0] = lo;
            p[1] = hi;
          }
        } else {
          p[0] = lo;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// route 2: f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreadsCC = 256;
constexpr int kStagesCC = 2;
constexpr int kWK = 64;                 // Q / K chunk of D
constexpr int kWO = 128;                // output features a CTA (V chunk)
constexpr int kPK = kWK + 4, kPO = kWO + 4, kPP = kBQ + 1;
constexpr int kSlotCC = 2 * kBK * kPK > kBK * kPO ? 2 * kBK * kPK : kBK * kPO;

__host__ __device__ constexpr size_t cc_smem() {
  return ((size_t)kStagesCC * kSlotCC + (size_t)kBK * kPP) * sizeof(float);
}

// grid (H * nc, ceil(Sq / 64), B); nc output chunks of 128 features
__global__ void __launch_bounds__(kThreadsCC)
flash_cc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                Strides st, int H, int KH, int Sq, int Sk, int D, int nc,
                float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char smraw[];
  float* const ring = reinterpret_cast<float*>(smraw);
  float* const pt = ring + kStagesCC * kSlotCC;     // P^T: (key, row)
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int h = blockIdx.x / nc, c = blockIdx.x - h * nc;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + kvh * st.kh;
  const float* vp = v + b * st.vb + kvh * st.vh;
  int nkb = (Sk + kBK - 1) / kBK;
  if (causal) nkb = min(nkb, (min(q0 + kBQ, Sq) - 1) / kBK + 1);
  const int kch = (D + kWK - 1) / kWK;
  const int per_tile = kch + 1;
  const int items = nkb * per_tile;

  auto load = [&](int it) {
    const int kb = it / per_tile, j = it - kb * per_tile;
    float* slot = ring + (it % kStagesCC) * kSlotCC;
    if (j < kch) {
      load_rows<float, kBQ>(slot, kPK, qp, st.qs, q0, Sq, j * kWK, kWK, D, vec,
                            tid, kThreadsCC);
      load_rows<float, kBK>(slot + kBQ * kPK, kPK, kp, st.ks, kb * kBK, Sk,
                            j * kWK, kWK, D, vec, tid, kThreadsCC);
    } else {
      load_rows<float, kBK>(slot, kPO, vp, st.vs, kb * kBK, Sk, c * kWO, kWO,
                            D, vec, tid, kThreadsCC);
    }
  };

  load(0);
  gs::cp_async_commit();
  float s[4][4], acc[4][8];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }

  for (int it = 0; it < items; ++it) {
    gs::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < items) load(it + 1);
    gs::cp_async_commit();
    const int kb = it / per_tile, j = it - kb * per_tile;
    const int k0 = kb * kBK;
    const float* slot = ring + (it % kStagesCC) * kSlotCC;
    if (j < kch) {
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      }
      const float* qc = slot;
      const float* kc = slot + kBQ * kPK;
      const int dlen = (min(kWK, D - j * kWK) + 3) & ~3;
#pragma unroll 2
      for (int d = 0; d < dlen; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qc + (tr + 16 * i) * kPK + d);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kv[jj] = *reinterpret_cast<const float4*>(kc + (tc + 16 * jj) * kPK + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float a = s[i][jj];
            a = fmaf(qv[i].x, kv[jj].x, a);
            a = fmaf(qv[i].y, kv[jj].y, a);
            a = fmaf(qv[i].z, kv[jj].z, a);
            a = fmaf(qv[i].w, kv[jj].w, a);
            s[i][jj] = a;
          }
      }
      if (j < kch - 1) continue;
      // online softmax: row tr + 16 i lives on the 16 lanes of one half warp
      const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + tr + 16 * i;
        float mx = kNegInf;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float x = s[i][jj] * scale;
          const int col = k0 + tc + 16 * jj;
          if (edge && (col >= Sk || (causal && col > row))) x = kNegInf;
          s[i][jj] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[i], mx);
        const float corr = expf(m[i] - mn);
        m[i] = mn;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p = s[i][jj] > 0.5f * kNegInf ? expf(s[i][jj] - mn) : 0.f;
          sum += p;
          pt[(tc + 16 * jj) * kPP + tr + 16 * i] = p;
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] *= corr;
      }
    } else {
      // O += P V over the tile's 64 keys (P^T written before this item's
      // barrier)
      const float* vc = slot;
#pragma unroll 4
      for (int cc = 0; cc < kBK; ++cc) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = pt[cc * kPP + tr + 16 * i];
        const float4 v0 = *reinterpret_cast<const float4*>(vc + cc * kPO + tc * 4);
        const float4 v1 = *reinterpret_cast<const float4*>(vc + cc * kPO + 64 + tc * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(pv[i], v0.x, acc[i][0]);
          acc[i][1] = fmaf(pv[i], v0.y, acc[i][1]);
          acc[i][2] = fmaf(pv[i], v0.z, acc[i][2]);
          acc[i][3] = fmaf(pv[i], v0.w, acc[i][3]);
          acc[i][4] = fmaf(pv[i], v1.x, acc[i][4]);
          acc[i][5] = fmaf(pv[i], v1.y, acc[i][5]);
          acc[i][6] = fmaf(pv[i], v1.z, acc[i][6]);
          acc[i][7] = fmaf(pv[i], v1.w, acc[i][7]);
        }
      }
    }
  }
  gs::cp_async_wait<0>();
  float* op = out + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= Sq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = c * kWO + (e >> 2) * 64 + tc * 4 + (e & 3);
      if (col < D) op[row * st.os + col] = acc[i][e] / lm;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kernel, typename T>
int launch(Kernel kernel, int threads, int rows, size_t smem, int nc,
           const void* q,
           const void* k, const void* v, void* out, const Strides& st, int B,
           int H, int KH, int Sq, int Sk, int D, float scale, int causal,
           int vec, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H * nc, (Sq + rows - 1) / rows, B), threads, smem,
           (cudaStream_t)stream>>>((const T*)q, (const T*)k, (const T*)v,
                                   (T*)out, st, H, KH, Sq, Sk, D, nc, scale,
                                   causal, vec);
  return (int)cudaGetLastError();
}

// 16-byte copies need every operand's base, (batch, head, row) strides and D
// to be multiples of 16 bytes
template <typename T>
bool vec_ok(const void* q, const void* k, const void* v, const Strides& st,
            int D) {
  constexpr long long E = 16 / sizeof(T);
  const long long s[9] = {st.qb, st.qh, st.qs, st.kb, st.kh,
                          st.ks, st.vb, st.vh, st.vs};
  for (long long x : s)
    if (x % E) return false;
  return D % E == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

bool bad_args(int B, int H, int KH, int Sq, int Sk, int D, int nc) {
  return B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 ||
         D <= 0 || B > 65535 || (Sq + kBQ - 1) / kBQ > 65535 ||
         (long long)H * nc > 2147483647LL;
}

// m-tiles a warp: two (a K / V fragment feeds two MMAs, Q read from shared
// memory) where the Q block is staged once and the output chunk is at
// least 64 wide; one where Q streams with K (D > 128)
__host__ __device__ constexpr int tc_mt(int W, bool qs) {
  return !qs && W >= 64 ? 2 : 1;
}

// chunk: output features a CTA (flash_plan in kernels/flash_attention.py):
// a multiple of 16 up to 128, at least D when it is not 128
int flash_bf16(const void* q, const void* k, const void* v, void* out,
               const Strides& st, int B, int H, int KH, int Sq, int Sk, int D,
               float scale, int causal, int chunk, void* stream) {
  if (chunk <= 0 || chunk % 16 != 0 || chunk > kMaxChunk ||
      (chunk < kMaxChunk && chunk < D))
    return (int)cudaErrorInvalidValue;
  const int nc = (D + chunk - 1) / chunk;
  if (bad_args(B, H, KH, Sq, Sk, D, nc)) return (int)cudaErrorInvalidValue;
  const int vec = vec_ok<bf16>(q, k, v, st, D);
  const float sl2 = scale * kLog2e;
#define FA_TC(KC, QS)                                                         \
  launch<decltype(&flash_tc_kernel<KC, QS, tc_mt(16 * KC, QS)>), bf16>(       \
      flash_tc_kernel<KC, QS, tc_mt(16 * KC, QS)>, kThreadsTC,                \
      tc_rows(tc_mt(16 * KC, QS)), tc_smem(16 * KC, QS, tc_mt(16 * KC, QS)),  \
      nc, q, k, v, out, st, B, H, KH, Sq, Sk, D, sl2, causal, vec, stream)
  if (nc > 1) return FA_TC(8, true);
  switch (chunk / 16) {
    case 1: return FA_TC(1, false);
    case 2: return FA_TC(2, false);
    case 3: return FA_TC(3, false);
    case 4: return FA_TC(4, false);
    case 5: return FA_TC(5, false);
    case 6: return FA_TC(6, false);
    case 7: return FA_TC(7, false);
    case 8: return FA_TC(8, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_TC
}

// chunk: output features a CTA, always 128 (the thread's 4 x 8 block)
int flash_f32(const void* q, const void* k, const void* v, void* out,
              const Strides& st, int B, int H, int KH, int Sq, int Sk, int D,
              float scale, int causal, int chunk, void* stream) {
  if (chunk != kWO) return (int)cudaErrorInvalidValue;
  const int nc = (D + kWO - 1) / kWO;
  if (bad_args(B, H, KH, Sq, Sk, D, nc)) return (int)cudaErrorInvalidValue;
  return launch<decltype(&flash_cc_kernel), float>(
      flash_cc_kernel, kThreadsCC, kBQ, cc_smem(), nc, q, k, v, out, st, B, H, KH,
      Sq, Sk, D, scale, causal, vec_ok<float>(q, k, v, st, D), stream);
}

}  // namespace fa

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// strides: 12 int64 (q b, h, s | k b, h, s | v b, h, s | out b, h, s)
#define FA_ENTRY(NAME, FN)                                                    \
  int NAME(const void* q, const void* k, const void* v, void* out,            \
           const long long* strides, int B, int H, int KH, int Sq, int Sk,    \
           int D, float scale, int causal, int chunk, void* stream) {         \
    const fa::Strides st{strides[0], strides[1], strides[2],  strides[3],     \
                         strides[4], strides[5], strides[6],  strides[7],     \
                         strides[8], strides[9], strides[10], strides[11]};   \
    return fa::FN(q, k, v, out, st, B, H, KH, Sq, Sk, D, scale, causal,       \
                  chunk, stream);                                             \
  }

FA_ENTRY(fa_flash_attention_f32, flash_f32)
FA_ENTRY(fa_flash_attention_bf16, flash_bf16)

}  // extern "C"
