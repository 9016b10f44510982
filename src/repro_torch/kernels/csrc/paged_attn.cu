// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// paged_flash_decode (_paged_decode_kernel): one query token per row attends
// over the KV pages its page table maps, with GQA and an online softmax.
// q (B, H, D); k, v pages (P, page, K, D) shared pools; table (B, W) int32
// rows (any row stride); kv_len (B,) int32 or int64; out (B, H, D); q,
// pages and out in one dtype (bf16 or f32), all sums fp32. Numerics follow
// the TPU kernel: q * scale rounded to q's dtype, scores and (m, l, acc) in
// fp32, p rounded to v's dtype before p . v (l sums the unrounded p), l
// floored at 1e-30.
//
// Design (flash-decoding). A row's live keys, min(kv_len, W * page), are
// split over a thread block cluster of `splits` CTAs (the grid's x, up to
// 8): each CTA takes a contiguous range of the row's pages, rounded to whole
// 64-key tiles, and never reads a page at or past column W - 1's end (a
// parked row, kv_len > W * page, reads only the garbage page its table
// holds). One CTA serves up to 8 query heads of one KV head (a GQA group;
// wider groups take several CTAs) and up to 256 output features, so each K
// / V row is read once for the group. Keys stream through a ring of 64-key
// tiles in their own dtype: each key row of the tile (D values of one KV
// head, contiguous) lands by one 1-D bulk copy of the copy engine, which
// reports its bytes to the stage's mbarrier; rows past the range are
// zeroed instead (masked keys add 0, never 0 * NaN). The page table is read
// a tile ahead of the copies. Each of the 4 warps runs its own online
// softmax over its 16 keys of every tile; at the end the warps' (m, l, acc)
// merge in shared memory and the cluster's in distributed shared memory,
// each CTA writing a slice of the output: out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30). One launch, no workspace.
// * bf16: the tensor cores, with the GQA group as the MMA's N = 8 (a
//   smaller group zero-padded): S^T = K (q scale)^T by mma.sync m16n8k16
//   (the warp's 16 keys as M, D as K, K rows by ldmatrix), then acc^T +=
//   V^T P^T (the features as M, V by ldmatrix.trans); the S^T C fragment
//   becomes the P^T B fragment by movmatrix.trans, in registers.
// * f32: the CUDA cores, one warp per 16 keys of a tile (a lane per key and
//   half of D, scores completed by one shuffle), warp-shuffle softmax, p
//   broadcast by shuffles into acc (a lane per 32nd feature).
// At decode the work is reading the pages (0.6 MB a row at 144 tokens of
// qwen2-72b, bf16), so the kernel is bound by bytes and, at short contexts,
// by its latency: the splits put about one wave of CTAs on the card. At
// long contexts a CTA's copies (one per 256-byte key row) set its rate.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace pa {

using gs::bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;               // keys a ring item (16 a warp)
constexpr int kHeads = 8;               // query heads a CTA
constexpr int kMaxF = 256;              // output features a CTA
constexpr int kMaxSplits = 8;           // CTAs a row (the cluster)
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// the 8 x 8 b16 matrix of a fragment transposed across the warp
__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// mbarriers and 1-D bulk copies (the copy engine moves a whole key row and
// reports its bytes to the stage's barrier)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   gs::smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t tx) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          gs::smem_addr(bar)),
      "r"(tx)
      : "memory");
}

// wait for the barrier's phase of parity `parity`; traps rather than spin
// for ever should a copy never land
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(gs::smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1LL << 22)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(gs::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(gs::smem_addr(bar))
      : "memory");
}

struct Geo {
  int H, KH, D, page, W;
  int G;          // query heads a KV head
  int Dp;         // D padded (bf16: to 16, f32: to 4)
  int fc;         // output features a CTA (<= kMaxF)
  int nfc, nht;   // feature chunks, head tiles (of kHeads)
  long long tstride;  // table row stride (elements)
  int len64;      // kv_len is int64
};

template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / (int)sizeof(T);
}

// shared memory: stage barriers | q tile | ring (K tile, V tile) x stages |
// the CTA's merged (m, l, acc) for its cluster peers; after the key loop the
// ring holds the warps' (m, l, acc)
template <typename T>
__host__ __device__ inline size_t q_elems(const Geo& g) {
  return (size_t)kHeads * (g.Dp + pad<T>());
}
template <typename T>
__host__ __device__ inline size_t stage_elems(const Geo& g) {
  return (size_t)kTile * (g.Dp + pad<T>()) + (size_t)kTile * (g.fc + pad<T>());
}
constexpr int kBarBytes = 64;           // the stages' mbarriers
template <typename T>
__host__ __device__ inline size_t smem_bytes(const Geo& g, int stages) {
  return kBarBytes + (q_elems<T>(g) + stages * stage_elems<T>(g)) * sizeof(T) +
         (2 * kHeads + (size_t)kHeads * g.fc) * sizeof(float);
}

// [kbeg, kend): the keys split `split` of `splits` takes of a row with
// kv_len `len` (mirrored by paged_split in kernels/paged_attention.py)
__device__ __forceinline__ void split_range(long long len, const Geo& g,
                                            int split, int splits, int& kbeg,
                                            int& kend) {
  const long long cap = (long long)g.W * g.page;
  const int nkeys = (int)(len < 0 ? 0 : (len < cap ? len : cap));
  const int live = (nkeys + g.page - 1) / g.page;
  const int unit = max(1, kTile / g.page);
  int per = (live + splits - 1) / splits;
  per = (per + unit - 1) / unit * unit;
  const int pbeg = split * per, pend = min(live, pbeg + per);
  kbeg = pbeg * g.page;
  kend = pend > pbeg ? min(pend * g.page, nkeys) : kbeg;
}

// grid (splits, KH * nht * nfc, B), cluster (splits, 1, 1)
template <typename T, int kStages>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const void* __restrict__ kv_len, T* __restrict__ out,
                    Geo g, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smraw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x, row = blockIdx.z;
  int y = blockIdx.y;
  const int fci = y % g.nfc;
  y /= g.nfc;
  const int ht = y % g.nht, kh = y / g.nht;
  const int g0 = ht * kHeads, gt = min(kHeads, g.G - g0);
  const int f0 = fci * g.fc, fw = min(g.fc, g.D - f0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int QP = g.Dp + pad<T>(), KP = QP, VP = g.fc + pad<T>();

  uint64_t* const bars = reinterpret_cast<uint64_t*>(smraw);
  T* const qs = reinterpret_cast<T*>(smraw + kBarBytes);
  T* const ring = qs + q_elems<T>(g);
  const size_t slot_elems = stage_elems<T>(g);
  float* const cm = reinterpret_cast<float*>(ring + kStages * slot_elems);
  float* const cl = cm + kHeads;
  float* const cacc = cl + kHeads;

  const long long len = g.len64 ? static_cast<const long long*>(kv_len)[row]
                                : static_cast<const int*>(kv_len)[row];
  // q * scale rounded to q's dtype, zero past D and past the group (its
  // loads in flight with kv_len's)
  const T* qrow = q + ((size_t)row * g.H + (size_t)kh * g.G + g0) * g.D;
  for (int o = tid; o < kHeads * g.Dp; o += kThreads) {
    const int hh = o / g.Dp, d = o - hh * g.Dp;
    const float x = hh < gt && d < g.D ? to_f32(qrow[hh * g.D + d]) * scale : 0.f;
    qs[hh * QP + d] = from_f32<T>(x);
  }
  int kbeg, kend;
  split_range(len, g, split, splits, kbeg, kend);
  const int ntiles = kend > kbeg ? (kend - kbeg + kTile - 1) / kTile : 0;
  const int* trow = table + row * g.tstride;

  // Two threads a key row of a tile: the even one stages the row's K (all
  // of D), the odd one its V (this CTA's features), each by one bulk copy
  // (vec: rows 16-byte aligned) or element by element; a row past the
  // range is zeroed instead. Each thread then arrives on the stage's
  // barrier with the bytes it expects. A thread looks its row up a tile
  // ahead of the copy, so the table's latency hides behind a tile's work.
  static_assert(kThreads == 2 * kTile, "two threads a key row");
  const int lrow = tid >> 1, part = tid & 1;
  const int width = part ? g.fc : g.Dp;      // staged columns
  const int valid = part ? fw : g.D;         // read columns; the rest zeros
  auto lookup = [&](int t) -> long long {
    const int key = kbeg + t * kTile + lrow;
    if (t >= ntiles || key >= kend) return -1;
    const int pid = __ldg(trow + key / g.page);
    return (((long long)pid * g.page + key % g.page) * g.KH + kh) * g.D;
  };
  auto load = [&](int t, long long base) {
    T* const ks = ring + (t % kStages) * slot_elems;
    T* const dst = part ? ks + kTile * KP + lrow * VP : ks + lrow * KP;
    uint64_t* const bar = bars + t % kStages;
    const T* src = part ? vp + base + f0 : kp + base;
    if (base >= 0 && vec) {
      mbar_arrive(bar, valid * (uint32_t)sizeof(T));
      bulk_copy(dst, src, valid * (uint32_t)sizeof(T), bar);
      return;
    }
    for (int c = 0; c < width; ++c)
      dst[c] = base >= 0 && c < valid ? src[c] : from_f32<T>(0.f);
    mbar_arrive(bar, 0);
  };

  // per warp: (m, l) of its heads and acc; bf16 lanes hold heads 2 tig,
  // 2 tig + 1 and features mt * 16 + gid (+ 8); f32 lanes all 8 heads and
  // features lane + 32 j
  constexpr bool kTC = sizeof(T) == 2;
  constexpr int kAcc = kTC ? kMaxF / 16 : kMaxF / 32;   // m-tiles / features
  float m[kTC ? 2 : kHeads], l[kTC ? 2 : kHeads];
  float acc[kTC ? kAcc : kHeads][kTC ? 4 : kAcc];
#pragma unroll
  for (int i = 0; i < (kTC ? 2 : kHeads); ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < (kTC ? kAcc : kHeads); ++i)
#pragma unroll
    for (int e = 0; e < (kTC ? 4 : kAcc); ++e) acc[i][e] = 0.f;
  const int gid = lane >> 2, tig = lane & 3;
  const int mtn = g.fc / 16;            // bf16: active m-tiles

  auto compute = [&](int t) {
    const T* ks = ring + (t % kStages) * slot_elems;
    const T* vs = ks + kTile * KP;
    const int kw0 = kbeg + t * kTile + 16 * warp;
    if (kw0 >= kend) return;
    if constexpr (kTC) {
      const bf16* kb = reinterpret_cast<const bf16*>(ks);
      const bf16* vb = reinterpret_cast<const bf16*>(vs);
      const bf16* qb = reinterpret_cast<const bf16*>(qs);
      // two accumulators (even and odd k-tiles) halve the MMA chain
      float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
      const int arow = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int acol = (lane >> 4) * 8;
      const int qrow_l = (lane & 7) * QP + ((lane >> 3) & 1) * 8;
#pragma unroll 4
      for (int kt = 0; kt < g.Dp / 16; ++kt) {
        uint32_t a[4], bq[2];
        gs::ldsm_x4(a, kb + arow * KP + kt * 16 + acol);
        gs::ldsm_x2(bq, qb + qrow_l + kt * 16);
        if (kt & 1)
          gs::mma_16816(s2, a, bq[0], bq[1]);
        else
          gs::mma_16816(s, a, bq[0], bq[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += s2[e];
      // s: (key gid, heads 2 tig, 2 tig + 1), (key gid + 8, the same)
      const bool v0 = kw0 + gid < kend, v1 = kw0 + gid + 8 < kend;
      float mx[2] = {fmaxf(v0 ? s[0] : kNegInf, v1 ? s[2] : kNegInf),
                     fmaxf(v0 ? s[1] : kNegInf, v1 ? s[3] : kNegInf)};
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
        const float mn = fmaxf(m[i], mx[i]);
        corr[i] = __expf(m[i] - mn);
        m[i] = mn;
      }
      // bf16: e^x on the special function unit (relative error about
      // 2^-21, far below p's bf16 rounding)
      const float p0 = v0 ? __expf(s[0] - m[0]) : 0.f;
      const float p1 = v0 ? __expf(s[1] - m[1]) : 0.f;
      const float p2 = v1 ? __expf(s[2] - m[0]) : 0.f;
      const float p3 = v1 ? __expf(s[3] - m[1]) : 0.f;
      l[0] = l[0] * corr[0] + p0 + p2;
      l[1] = l[1] * corr[1] + p1 + p3;
      // P^T B fragment: keys 2 tig, 2 tig + 1 (+ 8) of head gid
      const uint32_t b0 = movtrans(gs::pack_f32(p0, p1));
      const uint32_t b1 = movtrans(gs::pack_f32(p2, p3));
      const int vrow = 16 * warp + (lane & 7) + ((lane >> 4) & 1) * 8;
      const int vcol = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int mt = 0; mt < kAcc; ++mt) {
        if (mt >= mtn) break;
        acc[mt][0] *= corr[0];
        acc[mt][1] *= corr[1];
        acc[mt][2] *= corr[0];
        acc[mt][3] *= corr[1];
        uint32_t a[4];
        gs::ldsm_x4_trans(a, vb + vrow * VP + mt * 16 + vcol);
        gs::mma_16816(acc[mt], a, b0, b1);
      }
    } else {
      const float* kf = reinterpret_cast<const float*>(ks);
      const float* vf = reinterpret_cast<const float*>(vs);
      const float* qf = reinterpret_cast<const float*>(qs);
      const int kr = lane & 15, half = lane >> 4;
      const bool valid = kw0 + kr < kend;
      float s[kHeads];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) s[hh] = 0.f;
      const float* krow = kf + (16 * warp + kr) * KP;
      for (int d = 4 * half; d < g.Dp; d += 8) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          const float4 qv = *reinterpret_cast<const float4*>(qf + hh * QP + d);
          s[hh] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z,
                       fmaf(qv.w, kv.w, s[hh]))));
        }
      }
      float p[kHeads];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        const float x = s[hh] + __shfl_xor_sync(0xffffffffu, s[hh], 16);
        float mx = valid ? x : kNegInf;
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[hh], mx);
        const float corr = expf(m[hh] - mn);
        m[hh] = mn;
        p[hh] = valid ? expf(x - mn) : 0.f;
        float sum = half ? 0.f : p[hh];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[hh] = l[hh] * corr + sum;
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc[hh][j] *= corr;
      }
      for (int jj = 0; jj < 16; ++jj) {
        const float* vr = vf + (16 * warp + jj) * VP;
        float vv[kAcc];
#pragma unroll
        for (int j = 0; j < kAcc; ++j) {
          const int f = lane + 32 * j;
          vv[j] = f < g.fc ? vr[f] : 0.f;
        }
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          const float pj = __shfl_sync(0xffffffffu, p[hh], jj);
#pragma unroll
          for (int j = 0; j < kAcc; ++j) acc[hh][j] = fmaf(pj, vv[j], acc[hh][j]);
        }
      }
    }
  };

  // the ring: stage s's barrier completes a phase when its tile landed;
  // one CTA barrier a tile keeps a stage from refilling while it is read
  // (two with a single stage)
  if (tid == 0)
    for (int st = 0; st < kStages; ++st) mbar_init(bars + st, kThreads);
  // columns staged but never copied (past D, past this CTA's features) stay
  // zero in every stage
  if (vec && (g.D < g.Dp || fw < g.fc))
    for (int st = 0; st < kStages; ++st) {
      T* const dst = part ? ring + st * slot_elems + kTile * KP + lrow * VP
                          : ring + st * slot_elems + lrow * KP;
      for (int c = valid; c < width; ++c) dst[c] = from_f32<T>(0.f);
    }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if constexpr (kStages == 1) {
    for (int t = 0; t < ntiles; ++t) {
      load(t, lookup(t));
      mbar_wait(bars, t & 1);
      compute(t);
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st)
      if (st < ntiles) load(st, lookup(st));
    long long next = lookup(kStages - 1);
    for (int t = 0; t < ntiles; ++t) {
      mbar_wait(bars + t % kStages, (t / kStages) & 1);
      __syncthreads();
      if (t + kStages - 1 < ntiles) load(t + kStages - 1, next);
      next = lookup(t + kStages);
      compute(t);
    }
  }
  __syncthreads();                       // the ring is free: warp states

  // the warps' (m, l, acc) into the ring's space: wm, wl [warp][head],
  // wacc [warp][head][feature]
  float* const wm = reinterpret_cast<float*>(ring);
  float* const wl = wm + kWarps * kHeads;
  float* const wacc = wl + kWarps * kHeads;
  if constexpr (kTC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    }
    if (gid == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wm[warp * kHeads + 2 * tig + i] = m[i];
        wl[warp * kHeads + 2 * tig + i] = l[i];
      }
    }
#pragma unroll
    for (int mt = 0; mt < kAcc; ++mt) {
      if (mt >= mtn) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = 2 * tig + (e & 1), f = mt * 16 + gid + (e >> 1) * 8;
        wacc[(warp * kHeads + hh) * g.fc + f] = acc[mt][e];
      }
    }
  } else {
    if (lane == 0) {
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        wm[warp * kHeads + hh] = m[hh];
        wl[warp * kHeads + hh] = l[hh];
      }
    }
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int f = lane + 32 * j;
        if (f < g.fc) wacc[(warp * kHeads + hh) * g.fc + f] = acc[hh][j];
      }
  }
  __syncthreads();
  // the CTA's merged state
  for (int e = tid; e < kHeads * g.fc; e += kThreads) {
    const int hh = e / g.fc, f = e - hh * g.fc;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kHeads + hh]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = expf(wm[w * kHeads + hh] - M);
      L += wl[w * kHeads + hh] * sc;
      A += wacc[(w * kHeads + hh) * g.fc + f] * sc;
    }
    cacc[e] = A;
    if (f == 0) {
      cm[hh] = M;
      cl[hh] = L;
    }
  }
  cluster.sync();                        // every split's state is ready
  T* const orow = out + ((size_t)row * g.H + (size_t)kh * g.G + g0) * g.D + f0;
  for (int e = split * kThreads + tid; e < kHeads * g.fc;
       e += splits * kThreads) {
    const int hh = e / g.fc, f = e - hh * g.fc;
    if (hh >= gt || f >= fw) continue;
    float M = kNegInf;
    for (int s = 0; s < splits; ++s)
      M = fmaxf(M, cluster.map_shared_rank(cm, s)[hh]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float sc = expf(cluster.map_shared_rank(cm, s)[hh] - M);
      L += cluster.map_shared_rank(cl, s)[hh] * sc;
      A += cluster.map_shared_rank(cacc, s)[e] * sc;
    }
    orow[hh * g.D + f] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
  cluster.sync();                        // peers are done reading this CTA
}

template <typename T, int kStages>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const void* kv_len, void* out, int B, int splits, const Geo& g,
           float scale, int vec, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, kStages>;
  const size_t smem = smem_bytes<T>(g, kStages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, g.KH * g.nht * g.nfc, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, (const T*)kp,
                           (const T*)vp, table, kv_len, (T*)out, g, scale, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the geometry the wrapper's paged_plan describes; 0 stages when even one
// does not fit in shared memory
template <typename T>
Geo geometry(int H, int KH, int D, int page, int W, long long tstride,
             int len64, int& stages) {
  Geo g{};
  g.H = H;
  g.KH = KH;
  g.D = D;
  g.page = page;
  g.W = W;
  g.G = H / KH;
  const int a = sizeof(T) == 2 ? 16 : 4;
  g.Dp = (D + a - 1) / a * a;
  g.fc = g.Dp < kMaxF ? g.Dp : kMaxF;
  g.nfc = (D + g.fc - 1) / g.fc;
  g.nht = (g.G + kHeads - 1) / kHeads;
  g.tstride = tstride;
  g.len64 = len64;
  stages = 0;
  for (int s = 3; s >= 1 && !stages; --s)
    if (smem_bytes<T>(g, s) <= kMaxSmem) stages = s;
  return g;
}

template <typename T>
int paged_decode(const void* q, const void* kp, const void* vp,
                 const void* table, long long tstride, const void* kv_len,
                 int len64, void* out, int B, int H, int KH, int D, int page,
                 int W, int splits, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || page <= 0 || W <= 0 ||
      B > 65535 || splits <= 0 || splits > kMaxSplits || tstride < W ||
      (long long)W * page > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  int stages;
  const Geo g = geometry<T>(H, KH, D, page, W, tstride, len64, stages);
  if (stages == 0 || (long long)KH * g.nht * g.nfc > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int E = 16 / sizeof(T);
  const int vec = D % E == 0 && reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)table;
  switch (stages) {
    case 3: return launch<T, 3>(q, kp, vp, tb, kv_len, out, B, splits, g, scale, vec, st);
    case 2: return launch<T, 2>(q, kp, vp, tb, kv_len, out, B, splits, g, scale, vec, st);
    default: return launch<T, 1>(q, kp, vp, tb, kv_len, out, B, splits, g, scale, vec, st);
  }
}

}  // namespace pa

extern "C" {

const char* pa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#define PA_ENTRY(NAME, T)                                                     \
  int NAME(const void* q, const void* kp, const void* vp, const void* table,  \
           long long tstride, const void* kv_len, int len64, void* out,       \
           int B, int H, int KH, int D, int page, int W, int splits,          \
           float scale, void* stream) {                                       \
    return pa::paged_decode<T>(q, kp, vp, table, tstride, kv_len, len64, out, \
                               B, H, KH, D, page, W, splits, scale, stream);  \
  }

PA_ENTRY(pa_paged_decode_f32, float)
PA_ENTRY(pa_paged_decode_bf16, __nv_bfloat16)

}  // extern "C"
