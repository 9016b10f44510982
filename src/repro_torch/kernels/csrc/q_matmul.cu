// Quantized-weight matmuls for Hopper (sm_90a), bound to Python with ctypes.
//
// q_matmul replaces the Pallas TPU kernel src/repro/kernels/q_matmul.py
// q_matmul_pallas (_q_matmul_kernel):  y = (x @ q) * scale  with x (M, K)
// bf16 or f32, q (K, N) int8 codes, scale (N,) fp32 per output channel, y
// (M, N) in x's dtype. The codes are widened exactly to bf16 in registers,
// the products run on the tensor cores with fp32 sums, and the scale is
// applied in the epilogue: the dequantized weight never exists in device
// memory.
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
// round trip to the host. f32 (the checks) runs q_matmul's kernel (its f32
// variant) on xr instead.
//
// What bounds them on the H100: at decode (M = B * T <= 16) the work is
// streaming the int8 weight once, K * N bytes (67 MB for wq, 242 MB for the
// MLP weights, 1.25 GB for the LM head), so both kernels are bound by memory
// traffic; 2 * M * K * N operations are far below the CUDA cores' rate.
//
// q_matmul design. The work at decode is streaming K * N code bytes once,
// so the kernel keeps many bytes in flight and spends few instructions a
// byte. A CTA is one producer warp and 4 * NTW consumer warps (NTW = 1, 2
// or 4 boxes across: 128, 256 or 512 columns a tile). The producer issues,
// from one lane, TMA copies (cp.async.bulk.tensor.2d) of NTW adjacent
// 64 K-row x 128-column boxes of codes (8 KB each, the 128-byte swizzle)
// and the matching box of x into a ring of mbarrier-tracked stages (the
// depth a launch argument); TMA zero-fills past K, N and M, so ragged edges
// cost nothing. Codes whose rows are not 16-byte aligned (N % 16 != 0, or
// an unaligned base), or x whose rows are not, are copied by the producer
// warp into the same swizzled layout instead; aligned inputs whose tensor
// map cannot be encoded are refused. Each consumer warp owns 32 columns:
// per 16-row K step it reads 4 words of codes (conflict-free through the
// swizzle), widens them exactly to bf16 (widen_pairs: byte permutes and an
// fp32 subtract) and multiplies on the tensor cores (mma.sync m16n8k16,
// fp32 sums) with the codes as A (16 output columns a fragment) and the
// tokens as B's 8 columns (16-token tiles past 8 rows). f32 x is split into
// bf16 hi + lo at the fragment load and both are multiplied (codes are
// exact in bf16; about 2^-17 relative on x). A consumer releases a stage
// with one arrive on its empty barrier. CTAs are persistent (as many as
// fit an SM: 3 a tile of 128 columns at 6 stages in bf16, 2 in f32 at 16
// tokens) and walk (column tile, token tile) items, so one item's epilogue
// (scale, round, store) overlaps the next item's loads; the LM head keeps
// the whole of K in one CTA. Where the column tiles alone would not fill
// the card (every decode projection below the LM head), K is split over a
// cluster of up to 16 CTAs (past 8, a non-portable size the H100 takes; no
// deeper than the card holds every cluster at once), one item each, whose
// partial tiles are added in rank order over distributed shared memory: no
// workspace, no second launch, no atomics, bit-identical reruns. The
// wrapper (kernels/q_matmul.py qmm_geometry) picks the tile width, ring
// depth, splits and grid, from the occupancy qmm_occupancy reports.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// mbarriers and TMA tile copies (the copy engine moves a 2-D box of a
// tensor map into shared memory and reports its bytes to the barrier)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   gs::smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(gs::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t tx) {
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
    if (i > (1LL << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0,
                                       int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(gs::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(gs::smem_addr(bar))
      : "memory");
}

// byte offset of (row, byte) in a tile of 128-byte rows written by TMA with
// the 128-byte swizzle: 16-byte chunk c of row r lands at chunk c ^ (r % 8)
// (the tile starts 1024-byte aligned)
__device__ __forceinline__ int swz(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// q_matmul
// ---------------------------------------------------------------------------

namespace qm {

// rows k and k + 1 of four consecutive columns (one 32-bit word each) ->
// four bf16 pairs (row k in the low half), packed by keeping the high
// halves of the fp32 values (one byte permute a pair, no conversion):
// exact, since |code| <= 128 has at most 8 significant bits
__device__ __forceinline__ void widen_pairs(uint32_t lo_row, uint32_t hi_row,
                                            uint32_t (&out)[4]) {
  float a[4], b[4];
  widen4(lo_row, a);
  widen4(hi_row, b);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __byte_perm(__float_as_uint(a[j]), __float_as_uint(b[j]), 0x7632);
}

constexpr int kBoxN = 128;                // columns a TMA box of codes
constexpr int kKT = 64;                   // K rows a stage
constexpr int kBoxBytes = kKT * kBoxN;    // 8 KB of codes a box
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 16;            // K splits: the cluster along K
constexpr int kSmemMax = 232448;          // dynamic shared memory a CTA

// NTW boxes across a tile (128 * NTW columns), one consumer warp per 32
// columns, one producer warp
template <typename T, int NTOK, int NTW>
struct Layout {
  static constexpr int kNT = kBoxN * NTW;
  static constexpr int kConsumers = 4 * NTW;
  static constexpr int kThreads = 32 * (kConsumers + 1);
  static constexpr int kCodeBytes = NTW * kBoxBytes;
  // x a stage: bf16, one box of NTOK rows x 64 K; f32, two boxes of NTOK
  // rows x 32 K (each box row 128 bytes)
  static constexpr int kXBytes = NTOK * kKT * (int)sizeof(T);
  static constexpr int kStage = kCodeBytes + kXBytes;   // a multiple of 1024
  static constexpr int kRed = NTOK * kNT * 4;           // split partial tile
};

// bytes of dynamic shared memory of a launch (the ring, the split partial
// tile, two barriers a stage, 1024 for alignment); -1 for a configuration
// the kernel does not take
inline int smem_bytes(int es, int ntok, int ntw, int stages) {
  if ((es != 2 && es != 4) || (ntok != 8 && ntok != 16) ||
      (ntw != 1 && ntw != 2 && ntw != 4) || stages < 2 || stages > kMaxStages)
    return -1;
  const int xbytes = ntok * kKT * es;
  return 1024 + stages * (ntw * kBoxBytes + xbytes) + ntok * kBoxN * ntw * 4 +
         2 * stages * 8;
}

// Persistent CTAs: a producer warp streams (K stage) tiles of codes and x
// into a ring of `stages`, the consumer warps widen the codes to bf16 and
// multiply on the tensor cores. Item = (column tile, token tile), walked
// with stride gridDim.x; with K splits (a cluster of `splits` CTAs along K)
// each CTA takes one item and the split's K range, and the cluster adds its
// partial tiles in rank order over distributed shared memory.
// vq / vx: codes / x come by TMA (else the producer warp copies them).
template <typename T, int NTOK, int NTW>
__global__ void __launch_bounds__(Layout<T, NTOK, NTW>::kThreads)
q_matmul_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tx,
                const T* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, T* __restrict__ y, int M,
                int K, int N, int stages, int splits, int kps, int vq, int vx) {
  using Lay = Layout<T, NTOK, NTW>;
  constexpr int NT8 = NTOK / 8;
  constexpr int kNT = Lay::kNT, kConsumers = Lay::kConsumers;
  constexpr int kCodeBytes = Lay::kCodeBytes;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ unsigned char smraw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smraw) + 1023) & ~(uintptr_t)1023);
  float* red = reinterpret_cast<float*>(sm + stages * Lay::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + stages * Lay::kStage + Lay::kRed);
  uint64_t* empty = full + stages;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ctiles = (N + kNT - 1) / kNT, ttiles = (M + NTOK - 1) / NTOK;
  const int items = ctiles * ttiles;
  const int rank = splits > 1 ? (int)cluster.block_rank() : 0;
  const int first = splits > 1 ? (int)(blockIdx.x / splits) : (int)blockIdx.x;
  const int stride = splits > 1 ? items : (int)gridDim.x;
  const int kbeg = rank * kps, kend = min(K, kbeg + kps);
  const int nst = (kend - kbeg + kKT - 1) / kKT;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[2][NT8][4];
  if (warp == kConsumers) {
    // the producer: NTW TMA boxes of codes and one or two of x a stage
    // (lane 0), or a copy by the warp where a tensor map does not fit
    const uint32_t tx_bytes = (vq ? kCodeBytes : 0) + (vx ? Lay::kXBytes : 0);
    int it = 0;
    for (int item = first; item < items; item += stride) {
      const int n0 = (item / ttiles) * kNT, m0 = (item % ttiles) * NTOK;
      for (int st = 0; st < nst; ++st, ++it) {
        const int s = it % stages, round = it / stages;
        if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
        unsigned char* cs = sm + s * Lay::kStage;
        unsigned char* xs = cs + kCodeBytes;
        const int k0 = kbeg + st * kKT;
        if (!vq)
          for (int o = lane; o < kCodeBytes; o += 32) {
            const int rr = o / kNT, cc = o - rr * kNT;
            const int k = k0 + rr, col = n0 + cc;
            cs[(cc / kBoxN) * kBoxBytes + swz(rr, cc % kBoxN)] =
                (k < kend && col < N) ? (unsigned char)q[(size_t)k * N + col]
                                      : (unsigned char)0;
          }
        if (!vx) {
          constexpr int kPerBox = 128 / (int)sizeof(T);   // K a box row
          for (int o = lane; o < NTOK * kKT; o += 32) {
            const int t = o / kKT, kk = o - t * kKT;
            const int m = m0 + t, k = k0 + kk;
            const int box = kk / kPerBox, kb = kk - box * kPerBox;
            T* dst = reinterpret_cast<T*>(xs + box * NTOK * 128 +
                                          swz(t, kb * (int)sizeof(T)));
            *dst = (m < M && k < kend) ? x[(size_t)m * K + k] : qmm::from_f32<T>(0.f);
          }
        }
        if (lane == 0) {
          mbar_arrive_tx(full + s, tx_bytes);
          if (vq) {
#pragma unroll
            for (int b = 0; b < NTW; ++b)
              tma_2d(cs + b * kBoxBytes, &tq, n0 + b * kBoxN, k0, full + s);
          }
          if (vx) {
            tma_2d(xs, &tx, k0, m0, full + s);
            if (kF32) tma_2d(xs + NTOK * 128, &tx, k0 + 32, m0, full + s);
          }
        } else {
          mbar_arrive(full + s);
        }
      }
    }
  } else {
    // a consumer warp: 32 columns of the tile (box warp / 4), all NTOK
    // tokens. The swizzled offsets a lane reads are the same in every
    // stage: computed once (codes: rows 16 ks + 2 tig (+1, +8, +9) at its
    // 4 columns; x: its token rows at K 16 ks + 2 tig (+8))
    const int wcol = warp;
    const int cbox = (wcol / 4) * kBoxBytes;
    int coff[kKT / 16][4], xoff[kKT / 16][NT8][2];
#pragma unroll
    for (int ks = 0; ks < kKT / 16; ++ks) {
      const int r0 = 16 * ks + 2 * tig, cb = (wcol % 4) * 32 + 4 * gid;
      coff[ks][0] = cbox + swz(r0, cb);
      coff[ks][1] = cbox + swz(r0 + 1, cb);
      coff[ks][2] = cbox + swz(r0 + 8, cb);
      coff[ks][3] = cbox + swz(r0 + 9, cb);
#pragma unroll
      for (int h = 0; h < NT8; ++h) {
        const int tr = 8 * h + gid;
        if constexpr (!kF32) {
          xoff[ks][h][0] = kCodeBytes + swz(tr, 2 * r0);
          xoff[ks][h][1] = kCodeBytes + swz(tr, 2 * r0 + 16);
        } else {
          const int xb = kCodeBytes + (r0 / 32) * NTOK * 128, kb = (r0 % 32) * 4;
          xoff[ks][h][0] = xb + swz(tr, kb);
          xoff[ks][h][1] = xb + swz(tr, kb + 32);
        }
      }
    }
    int it = 0;
    for (int item = first; item < items; item += stride) {
      const int n0 = (item / ttiles) * kNT, m0 = (item % ttiles) * NTOK;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < NT8; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[f][h][j] = 0.f;
      for (int st = 0; st < nst; ++st, ++it) {
        const int s = it % stages;
        mbar_wait(full + s, (it / stages) & 1);
        const unsigned char* cs = sm + s * Lay::kStage;
#pragma unroll
        for (int ks = 0; ks < kKT / 16; ++ks) {
          uint32_t lo[4], hi[4];
          widen_pairs(lds32(cs + coff[ks][0]), lds32(cs + coff[ks][1]), lo);
          widen_pairs(lds32(cs + coff[ks][2]), lds32(cs + coff[ks][3]), hi);
#pragma unroll
          for (int h = 0; h < NT8; ++h) {
            if constexpr (!kF32) {
              const uint32_t b0 = lds32(cs + xoff[ks][h][0]);
              const uint32_t b1 = lds32(cs + xoff[ks][h][1]);
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                const uint32_t a[4] = {lo[2 * f], lo[2 * f + 1], hi[2 * f], hi[2 * f + 1]};
                gs::mma_16816(acc[f][h], a, b0, b1);
              }
            } else {
              // x as bf16 hi + lo (the codes are exact in bf16)
              const float2 v0 = *reinterpret_cast<const float2*>(cs + xoff[ks][h][0]);
              const float2 v1 = *reinterpret_cast<const float2*>(cs + xoff[ks][h][1]);
              const float c[4] = {v0.x, v0.y, v1.x, v1.y};
              uint32_t sp[4];
              gs::hi_lo(c, sp);        // sp: hi (k, k+1), hi (k+8, k+9), lo, lo
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                const uint32_t a[4] = {lo[2 * f], lo[2 * f + 1], hi[2 * f], hi[2 * f + 1]};
                gs::mma_16816(acc[f][h], a, sp[2], sp[3]);
                gs::mma_16816(acc[f][h], a, sp[0], sp[1]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
      if (splits == 1) {
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int h = 0; h < NT8; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = n0 + wcol * 32 + 4 * gid + 2 * f + (j >> 1);
              const int m = m0 + h * 8 + 2 * tig + (j & 1);
              if (m < M && col < N)
                y[(size_t)m * N + col] = qmm::from_f32<T>(acc[f][h][j] * scale[col]);
            }
      }
    }
  }
  if (splits == 1) return;
  // K splits: one item a CTA; add the ranks' partial tiles in rank order
  const int n0 = (first / ttiles) * kNT, m0 = (first % ttiles) * NTOK;
  if (warp < kConsumers) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < NT8; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = warp * 32 + 4 * gid + 2 * f + (j >> 1);
          const int t = h * 8 + 2 * tig + (j & 1);
          red[t * kNT + col] = acc[f][h][j];
        }
  }
  cluster.sync();  // every split's partial tile is ready
  constexpr int tile = NTOK * kNT;
  const int per = (tile + splits - 1) / splits;
  const int ebeg = rank * per, eend = min(tile, ebeg + per);
  for (int e = ebeg + tid; e < eend; e += Lay::kThreads) {
    const int t = e / kNT, col = n0 + (e - t * kNT);
    if (m0 + t >= M || col >= N) continue;
    float sum = 0.f;
    for (int c = 0; c < splits; ++c) sum += cluster.map_shared_rank(red, c)[e];
    y[(size_t)(m0 + t) * N + col] = qmm::from_f32<T>(sum * scale[col]);
  }
  cluster.sync();  // peers are done reading this CTA's tile
}

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qres = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &qres);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &qres);
#endif
    if (qres == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a 2-D row-major tensor (rows x cols of elem bytes, row pitch `pitch`
// bytes) cut into boxes of box_rows x box_cols, 128-byte swizzle, zeros
// past the edges; false when the driver's encoder is missing or refuses
inline bool encode(CUtensorMap* map, CUtensorMapDataType dt, const void* base,
                   unsigned long long rows, unsigned long long cols,
                   unsigned long long pitch, unsigned box_rows,
                   unsigned box_cols) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NTOK, int NTW>
int launch(const void* x, const void* q, const void* scale, void* y, int M,
           int K, int N, int stages, int splits, int kps, int grid,
           cudaStream_t stream) {
  using Lay = Layout<T, NTOK, NTW>;
  const int smem = smem_bytes((int)sizeof(T), NTOK, NTW, stages);
  if (smem < 0 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tx;
  memset(&tq, 0, sizeof(tq));
  memset(&tx, 0, sizeof(tx));
  // rows a tensor map can take (16-byte aligned base and pitch) go by TMA;
  // the producer warp copies the others. An aligned tensor that cannot be
  // encoded is an error, not a quiet change of load path.
  const int vq = ((uintptr_t)q % 16 == 0) && N % 16 == 0;
  const int vx = ((uintptr_t)x % 16 == 0) && ((size_t)K * sizeof(T)) % 16 == 0;
  if (vq && !encode(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, N, kKT, kBoxN))
    return (int)cudaErrorNotSupported;
  if (vx && !encode(&tx, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    x, M, K, (unsigned long long)K * sizeof(T), NTOK,
                    128 / sizeof(T)))
    return (int)cudaErrorNotSupported;
  auto kernel = q_matmul_kernel<T, NTOK, NTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // clusters past 8 CTAs (the portable size) are allowed on the H100
  if (err == cudaSuccess && splits > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(Lay::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, tq, tx, (const T*)x, (const int8_t*)q,
                           (const float*)scale, (T*)y, M, K, N, stages, splits,
                           kps, vq, vx);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out[0]: CTAs of a configuration resident an SM (shared memory,
// registers, threads; 0 where one does not fit); out[1]: the largest
// cluster of them the card can place (the cap on K splits); out[2]: how
// many clusters of `splits` CTAs the card holds at once. A CUDA error code,
// 0 on success.
template <typename T>
int occupancy(int ntok, int ntw, int stages, int splits, int* out) {
  out[0] = out[1] = out[2] = 0;
  const int smem = smem_bytes((int)sizeof(T), ntok, ntw, stages);
  if (smem < 0 || smem > kSmemMax || splits < 1 || splits > kMaxSplits)
    return 0;
  cudaError_t err = cudaErrorInvalidValue;
#define QMM_OCC(NTOK_, NTW_)                                                  \
  if (ntok == NTOK_ && ntw == NTW_) {                                         \
    auto kernel = q_matmul_kernel<T, NTOK_, NTW_>;                            \
    constexpr int kThreads = Layout<T, NTOK_, NTW_>::kThreads;                \
    err = cudaFuncSetAttribute(                                               \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);          \
    if (err == cudaSuccess)                                                   \
      err = cudaFuncSetAttribute(                                             \
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);         \
    if (err == cudaSuccess)                                                   \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,    \
                                                          kThreads, smem);    \
    if (err == cudaSuccess && out[0] > 0) {                                   \
      cudaLaunchConfig_t cfg = {};                                            \
      cfg.gridDim = dim3(kMaxSplits, 1, 1);                                   \
      cfg.blockDim = dim3(kThreads, 1, 1);                                    \
      cfg.dynamicSmemBytes = smem;                                            \
      err = cudaOccupancyMaxPotentialClusterSize(&out[1], kernel, &cfg);      \
      if (err == cudaSuccess && splits <= out[1]) {                           \
        cudaLaunchAttribute attr[1];                                          \
        attr[0].id = cudaLaunchAttributeClusterDimension;                     \
        attr[0].val.clusterDim.x = splits;                                    \
        attr[0].val.clusterDim.y = 1;                                         \
        attr[0].val.clusterDim.z = 1;                                         \
        cfg.gridDim = dim3(splits, 1, 1);                                     \
        cfg.attrs = attr;                                                     \
        cfg.numAttrs = 1;                                                     \
        err = cudaOccupancyMaxActiveClusters(&out[2], kernel, &cfg);          \
      }                                                                       \
    }                                                                         \
  }
  QMM_OCC(8, 1) QMM_OCC(8, 2) QMM_OCC(8, 4)
  QMM_OCC(16, 1) QMM_OCC(16, 2) QMM_OCC(16, 4)
#undef QMM_OCC
  return (int)err;
}

}  // namespace qm

// grid: CTAs (splits == 1: persistent, at most the items; splits > 1: the
// items x splits, a cluster of `splits` along K of kps rows each, kps a
// multiple of the stage); ntw boxes across a tile; a ring of `stages`
template <typename T>
int q_matmul(const void* x, const void* q, const void* scale, void* y, int M,
             int K, int N, int ntok, int ntw, int stages, int splits, int kps,
             int grid, void* stream) {
  const int smem = qm::smem_bytes((int)sizeof(T), ntok, ntw, stages);
  if (M <= 0 || K <= 0 || N <= 0 || smem < 0 || smem > qm::kSmemMax ||
      splits <= 0 || splits > qm::kMaxSplits || kps <= 0 ||
      kps % qm::kKT != 0 || (long long)splits * kps < K ||
      (long long)(splits - 1) * kps >= K || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const long long nt = (long long)qm::kBoxN * ntw;
  const long long items = ((N + nt - 1) / nt) * ((M + ntok - 1) / ntok);
  if (items > 2147483647LL ||
      (splits > 1 ? (long long)grid != items * splits : grid > items))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define QMM_CASE(NTOK_, NTW_)                                                \
  if (ntok == NTOK_ && ntw == NTW_)                                          \
    return qm::launch<T, NTOK_, NTW_>(x, q, scale, y, M, K, N, stages,       \
                                      splits, kps, grid, s);
  QMM_CASE(8, 1) QMM_CASE(8, 2) QMM_CASE(8, 4)
  QMM_CASE(16, 1) QMM_CASE(16, 2) QMM_CASE(16, 4)
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

// the constants qmm_geometry mirrors: columns a box, K rows a stage,
// largest K split, deepest ring
void qmm_constants(int* out) {
  out[0] = qmm::qm::kBoxN;
  out[1] = qmm::qm::kKT;
  out[2] = qmm::qm::kMaxSplits;
  out[3] = qmm::qm::kMaxStages;
}

// q_matmul's kernel in that configuration: out[0] CTAs resident an SM (0:
// it does not fit), out[1] the largest cluster the card places, out[2]
// clusters of `splits` CTAs resident at once; a CUDA error code
int qmm_occupancy(int es, int ntok, int ntw, int stages, int splits,
                  int* out) {
  return es == 4
             ? qmm::qm::occupancy<float>(ntok, ntw, stages, splits, out)
             : qmm::qm::occupancy<__nv_bfloat16>(ntok, ntw, stages, splits, out);
}

int qmm_q_matmul_f32(const void* x, const void* q, const void* scale, void* y,
                     int M, int K, int N, int ntok, int ntw, int stages,
                     int splits, int kps, int grid, void* stream) {
  return qmm::q_matmul<float>(x, q, scale, y, M, K, N, ntok, ntw, stages,
                              splits, kps, grid, stream);
}

int qmm_q_matmul_bf16(const void* x, const void* q, const void* scale, void* y,
                      int M, int K, int N, int ntok, int ntw, int stages,
                      int splits, int kps, int grid, void* stream) {
  return qmm::q_matmul<__nv_bfloat16>(x, q, scale, y, M, K, N, ntok, ntw,
                                      stages, splits, kps, grid, stream);
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
