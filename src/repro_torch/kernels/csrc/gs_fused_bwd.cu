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
// dtype. What bounds it on the H100: the bytes. The grads read x and dy once
// (4 * T * d bytes in bf16) against 8 * T * d * b operations, which is below
// the tensor cores' ratio for b < 256.
//
// The structure the design uses. Split x into r source groups m of b
// features. v = P u puts u[m][q] (row q of R_m x_m) at position c = q*r + m,
// dw reads dy[m*b + q] for the same c, and du[m][q] = dv[c]: output group g
// (c in [g*b, g*b + b)) needs x and dy of its own source groups only, and
// row q of dR[m] belongs to the owner of c. For r >= b an output group
// starts at c = q*r + s0 and covers the b source groups s0 .. s0 + b - 1 of
// row q (the last of them wrap to groups 0.. of row q + 1 when s0 + b > r).
// Tiles of output groups whose s0 lie in [k*b, k*b + b) hold one group per q
// and need at most 2b - 1 source groups; when b divides r every group of
// tile k starts at s0 = k*b, so the tile is a closed super-block of b^2
// features (d / b^2 of them). Each dL[g] and each row of dR has exactly one
// owning tile: tiles need no reduction with one another, only across token
// splits.
//
// gs_grads_tc (bf16, b = 32, r >= 32): route 1, one pass, no workspace. The
// launch plan (kernels/gs_fused.py bwd_plan) cuts each tile into CTAs of 8
// output groups ("slots", sorted by s0, so a CTA stages at most 39 source
// groups) and the tokens into splits; a table gives each CTA its window of
// source groups (w0, W), the dy columns it stages, and per slot (q, g,
// s0 - w0). A CTA streams 16-token tiles of x (its W groups) and dy (those
// columns) through a double-buffered 16-byte cp.async ring and computes on
// chip, with mma.sync m16n8k16 (bf16 in, fp32 sums):
//   U^T = X_m R_m'^T (tokens x slots, per window group m),
//   dV^T = DW L_g (tokens x b, per slot),
//   dL_g += DW^T V (b x b, K = tokens), dR_m^T += X_m^T DU (b x slots).
// The stages go through shared memory transposed (stmatrix.trans), so every
// operand is read by ldmatrix without bank conflicts. Two warps work for
// each slot (512 threads, one CTA an SM for its shared memory); a thread
// keeps 16 fp32 of its slot's dL and up to 24 of its window groups' dR rows
// in registers for the whole split; a split writes its partial sums once,
// and gs_bwd_sum_kernel adds the splits in order.
// Numerics: R x and L^T dw have exact bf16 operands, so they match the plain
// version's fp32 arithmetic up to summation order. The sums' second operand
// (v or du) is fp32: it is split into hi = bf16(v) and lo = bf16(v - hi) and
// both are multiplied, keeping about 16 bits of its mantissa (2^-17
// relative), against the fp32 plain version's 2^-24.
// What holds route 1 at about 3x its bound (PERF.md): each 16-token tile
// moves about 230 KB through shared memory (staging, the transposed stages,
// the hi/lo operands, x read twice) and waits at three CTA barriers, with
// 16 warps an SM and 127 registers a thread. A cluster of a tile's 4 CTAs
// sharing the x and dy tiles by multicast bulk copies adds a cluster
// barrier a tile and did not run faster; nor did an f32 variant on the CUDA
// cores against route 2.
//
// Route 2, two passes with an fp32 workspace (f32 inputs, b != 32, r < b,
// where one output group touches the whole row):
//   pass 1 (gs_bwd_tile_kernel): one CTA per tile of TT tokens, as in the
//     forward kernels, writes dx and the per-token operands v, dw, du as fp32
//     rows grouped by block (workspace 3 * B * T * d floats);
//   pass 2 (gs_bwd_reduce_kernel): one CTA per (block g, i-chunk, token
//     split, row) sums dw_g v_g^T and du_g x_g^T over its tokens, 4 x 4
//     tiles of the b x b block per thread; blocks above 128 are split over
//     CTAs along their rows i, so any b <= 256 fits.
// Its pass 1 rereads the factors for every tile of <= 8 tokens; its speed is
// later work. A row wider than kMaxTileElems (tt = 0) runs pass 1 as four
// wide passes of gs_common.cuh into the same workspace: any d.
//
// Every output element is owned by one thread of one CTA and summed in a
// fixed order, so repeated runs are bit-identical (no atomics). dx for route
// 1 is Q^T dy, the transpose rotation (gs_fused_T.cu), launched by the
// wrapper.

#include "gs_common.cuh"
#include "mma.cuh"

namespace gs {

constexpr int kReduceTokens = 64;   // tokens staged per pass-2 iteration
constexpr int kReduceThreads = 256;
constexpr int kReduceTiles = 4 * kReduceThreads;  // 4 x 4 tiles a pass-2 CTA holds
constexpr int kMaxBwdBlock = 256;
constexpr int kSmemLimit = 232448;

// P = P_(r, d) as a gather: (P y)[c] = y[sigma(c)]
__device__ __forceinline__ int p_src(int c, int r, int b) { return (c % r) * b + c / r; }
// P^T as a gather: (P^T y)[k] = y[tau(k)]
__device__ __forceinline__ int pt_src(int k, int r, int b) { return (k % b) * r + k / b; }

// ---------------------------------------------------------------------------
// Route 1: gs_grads_tc
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kB = 32;          // block size
constexpr int kSlots = 8;       // output groups per CTA
constexpr int kTT = 16;         // tokens per staged tile (the sums' K)
constexpr int kWarps = 16;      // two per slot
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWin = 39;     // source groups a CTA stages
constexpr int kMPW = (kMaxWin + kWarps - 1) / kWarps;  // window groups per warp
constexpr int kTab = 8 + 4 * kSlots;                   // ints per CTA in the plan
// shared-memory pitches in bytes; each is an odd multiple of 16, so eight
// 16-byte rows at that pitch fall in distinct bank groups
constexpr int kVEP = kTT * 2 + 16;      // one (slot, position) row of 16 tokens
constexpr int kVQP = kB * kVEP + 16;    // one slot of V, DWT
constexpr int kDUQP = kTT * 2 + 16;     // one (window group, slot) row of DU
constexpr int kDUMP = kSlots * kDUQP + 16;

struct Layout {
  int xp, dp;  // token pitch of the x / dy stage
  size_t xs, ds, vhi, vlo, dwt, duhi, dulo, trash, tab, total;
  __host__ __device__ Layout(int maxw, int maxdq) {
    xp = maxw * kB * 2 + 16;
    dp = (maxw * maxdq * 2 + 31) / 32 * 32 + 16;
    size_t o = 0;
    xs = o;    o += 2 * (size_t)kTT * xp;
    ds = o;    o += 2 * (size_t)kTT * dp;
    vhi = o;   o += kSlots * kVQP;
    vlo = o;   o += kSlots * kVQP;
    dwt = o;   o += kSlots * kVQP;
    duhi = o;  o += (size_t)maxw * kDUMP;
    dulo = o;  o += (size_t)maxw * kDUMP;
    trash = o; o += 64;
    tab = o;   o += kTab * 4;
    total = o;
  }
};

// One CTA: plan entry blockIdx.x (a tile's 8 slots), token split blockIdx.y,
// row blockIdx.z. Shared memory (Layout): x and dy stages [token][window
// group][...] as in device memory; V (hi, lo) and DWT as [slot][position e]
// [token]; DU (hi, lo) as [window group][slot][token].
__global__ void __launch_bounds__(kThreads, 1)
gs_grads_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                   const bf16* __restrict__ L, const bf16* __restrict__ R,
                   const int* __restrict__ table, float* __restrict__ outL,
                   float* __restrict__ outR, size_t split_stride, int n_tokens,
                   int r, int tps, int maxw, int maxdq) {
  extern __shared__ __align__(128) unsigned char tcsm[];
  const Layout lay(maxw, maxdq);
  const int split = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  int* tab = reinterpret_cast<int*>(tcsm + lay.tab);
  if (tid < kTab) tab[tid] = table[(size_t)blockIdx.x * kTab + tid];
  // DU rows a slot does not own stay zero, so they add nothing to dR
  for (size_t o = (size_t)tid * 16; o < 2 * (size_t)maxw * kDUMP;
       o += kThreads * 16)
    *reinterpret_cast<uint4*>(tcsm + lay.duhi + o) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int w0 = tab[0], W = tab[1], qlo = tab[2], dq = tab[3], simple = tab[4];
  if (W == 0) return;  // a tile's last CTAs may own no group
  const int d = r * kB;
  const int t_beg = split * tps, t_end = min(n_tokens, t_beg + tps);
  // warp w works for slot w % 8 on half w / 8 of its rows / columns
  const int slot = warp & (kSlots - 1), half = warp / kSlots;
  const int myq = tab[8 + 4 * slot], myg = tab[9 + 4 * slot];
  const int mydelta = tab[10 + 4 * slot];

  // B fragments of R for stage (a): window group mm = warp + 16k, slot gid;
  // a group past r is group mm - r of row q + 1 (the wrap)
  uint32_t rf[kMPW][2][2];
  {
    const int q = tab[8 + 4 * gid];
#pragma unroll
    for (int k = 0; k < kMPW; ++k) {
      const int mm = warp + kWarps * k, mv = w0 + mm;
      const int m = mv >= r ? mv - r : mv, qq = q + (mv >= r ? 1 : 0);
      const bool ok = mm < W && q >= 0 && qq < kB;
      const bf16* p = R + (((size_t)row * r + (ok ? m : 0)) * kB + (ok ? qq : 0)) * kB;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        rf[k][kk][0] = ok ? *reinterpret_cast<const uint32_t*>(p + kk * 16 + 2 * tig) : 0u;
        rf[k][kk][1] = ok ? *reinterpret_cast<const uint32_t*>(p + kk * 16 + 2 * tig + 8) : 0u;
      }
    }
  }
  // B fragments of L_g for stage (c): this warp's slot and half of the
  // columns j, L[i][j] with K = i
  uint32_t lf[2][2][2];
  {
    const bf16* Lg = L + ((size_t)row * r + (myq >= 0 ? myg : 0)) * kB * kB;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = kk * 16 + 2 * tig + 8 * h, j = (2 * half + n) * 8 + gid;
          lf[kk][n][h] = myq >= 0 ? pack_bf16(Lg[i * kB + j], Lg[(i + 1) * kB + j]) : 0u;
        }
  }

  // dL rows half * 16 .. + 15 of this warp's slot; dR rows of its window
  // groups
  float accL[4][4], accR[kMPW][2][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accL[n][e] = 0.f;
#pragma unroll
  for (int k = 0; k < kMPW; ++k)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) accR[k][a][e] = 0.f;

  // one tile of tokens [t0, t0 + 16) into stage buffer `buf`; rows past the
  // split's end are zero-filled
  const int xc = W * (kB / 8);                   // 16-byte chunks of x a token
  const int xwrap = min(W, r - w0) * (kB / 8);   // ... before the window wraps
  const int cpg = dq / 8, dc = W * cpg;          // ... of dy: per group, a token
  const int x_t = tid / xc, x_o = tid % xc, xt = kThreads / xc, xo = kThreads % xc;
  const int d_t = tid / dc, d_o = tid % dc, dt_ = kThreads / dc, do_ = kThreads % dc;
  auto fetch = [&](int t0, int buf) {
    const int nt = min(kTT, t_end - t0);
    unsigned char* xs = tcsm + lay.xs + (size_t)buf * kTT * lay.xp;
    unsigned char* ds = tcsm + lay.ds + (size_t)buf * kTT * lay.dp;
    // chunk c = t * xc + o walked kThreads at a time: (t, o) advance by
    // (xt, xo) with a carry, no division per chunk
    for (int t = x_t, o = x_o; t < kTT; t += xt, o += xo) {
      if (o >= xc) { o -= xc; ++t; if (t >= kTT) break; }
      const size_t base = ((size_t)row * n_tokens + t0 + (t < nt ? t : 0)) * d;
      const int off = o < xwrap ? w0 * kB + o * 8 : (o - xwrap) * 8;
      cp_async16(xs + (size_t)t * lay.xp + o * 16, x + base + off, t < nt);
    }
    for (int t = d_t, o = d_o; t < kTT; t += dt_, o += do_) {
      if (o >= dc) { o -= dc; ++t; if (t >= kTT) break; }
      const int mm = o / cpg, cc = o - mm * cpg;
      const int mv = w0 + mm, m = mv >= r ? mv - r : mv;
      const size_t base = ((size_t)row * n_tokens + t0 + (t < nt ? t : 0)) * d;
      cp_async16(ds + (size_t)t * lay.dp + (mm * dq + cc * 8) * 2,
                 dy + base + m * kB + qlo + cc * 8, t < nt);
    }
  };

  unsigned char* vhi = tcsm + lay.vhi;
  unsigned char* vlo = tcsm + lay.vlo;
  unsigned char* dwt = tcsm + lay.dwt;
  unsigned char* duhi = tcsm + lay.duhi;
  unsigned char* dulo = tcsm + lay.dulo;
  const int ntiles = (t_end - t_beg + kTT - 1) / kTT;
  fetch(t_beg, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; the last tile's readers are done
    if (it + 1 < ntiles) fetch(t_beg + (it + 1) * kTT, buf ^ 1);
    cp_async_commit();
    const unsigned char* xs = tcsm + lay.xs + (size_t)buf * kTT * lay.xp;
    const unsigned char* ds = tcsm + lay.ds + (size_t)buf * kTT * lay.dp;

    // dw = P dy into DWT[slot][e][t]: element (t, e) of slot s is dy of
    // window group delta_s + e, column q_s (+1 past the wrap)
    if (simple) {
      // b | r: delta = 0 and slot s is column qlo + s, so DWT is the
      // transpose of each (16 tokens x 8 columns) dy tile: warp w takes
      // positions 2w and 2w + 1
      const int mi = lane >> 3, i = lane & 7;
      const int e = 2 * warp + (mi >> 1), th = mi & 1;
      uint32_t v[4];
      ldsm_x4(v, reinterpret_cast<const bf16*>(ds + (size_t)(th * 8 + i) * lay.dp +
                                               e * dq * 2));
      stsm_x4_trans(v, dwt + i * kVQP + e * kVEP + th * 16);
    } else if (myq >= 0) {
      // the slot's two warps gather its 32 positions x 16 tokens: lane
      // (t, e % 2) so a load instruction reads 16 tokens of two groups
      const int t = lane & 15;
      const bf16* src = reinterpret_cast<const bf16*>(ds + (size_t)t * lay.dp);
      bf16* dst = reinterpret_cast<bf16*>(dwt + slot * kVQP) + t;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = half * 16 + 2 * k + (lane >> 4), mm = mydelta + e;
        dst[e * (kVEP / 2)] = src[mm * dq + myq + (w0 + mm >= r ? 1 : 0) - qlo];
      }
    }
    __syncthreads();

    // (a) u = R x for window group mm, all slots: U^T (16 tokens x 8 slots),
    // K = the group's 32 features; v = P u into V[slot][mm - delta][t]
#pragma unroll
    for (int k = 0; k < kMPW; ++k) {
      const int mm = warp + kWarps * k;
      if (mm < W) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[4];
          const int t = (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = kk * 16 + (lane >> 4) * 8;
          ldsm_x4(a, reinterpret_cast<const bf16*>(xs + (size_t)t * lay.xp + (mm * kB + col) * 2));
          mma_16816(c, a, rf[k][kk][0], rf[k][kk][1]);
        }
        uint32_t s[4];
        hi_lo(c, s);
        const int mi = lane >> 3, j = lane & 7;
        const int qj = tab[8 + 4 * j], e = mm - tab[10 + 4 * j];
        unsigned char* dst = (qj >= 0 && e >= 0 && e < kB)
            ? (mi < 2 ? vhi : vlo) + j * kVQP + e * kVEP + (mi & 1) * 16
            : tcsm + lay.trash;
        stsm_x4_trans(s, dst);
      }
    }
    // (c) dv = L^T dw for this warp's slot and half of the columns j: dV^T
    // (16 tokens x 16), K = 32; du = P^T dv into DU[delta + j][slot][t]
    if (myq >= 0) {
      float c[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        const int i = kk * 16 + (lane & 7) + (lane >> 4) * 8;
        const int t0 = ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(a, reinterpret_cast<const bf16*>(dwt + slot * kVQP + i * kVEP + t0 * 2));
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_16816(c[n], a, lf[kk][n][0], lf[kk][n][1]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t s[4];
        hi_lo(c[n], s);
        const int mi = lane >> 3, mm = mydelta + (2 * half + n) * 8 + (lane & 7);
        stsm_x4_trans(s, (mi < 2 ? duhi : dulo) + mm * kDUMP + slot * kDUQP + (mi & 1) * 16);
      }
    }
    __syncthreads();

    // (b) dL_g += dw v^T for this warp's slot, rows half * 16 .. + 15: 16
    // x 32, K = 16 tokens; v as hi + lo
    if (myq >= 0) {
      uint32_t a[4];
      {
        const int i = half * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int t0 = (lane >> 4) * 8;
        ldsm_x4(a, reinterpret_cast<const bf16*>(dwt + slot * kVQP + i * kVEP + t0 * 2));
      }
#pragma unroll
      for (int hl = 0; hl < 2; ++hl)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bv[4];  // two 8-column tiles
          const int j = np * 16 + (lane & 7) + (lane >> 4) * 8;
          const int t0 = ((lane >> 3) & 1) * 8;
          ldsm_x4(bv, reinterpret_cast<const bf16*>(
                          (hl ? vlo : vhi) + slot * kVQP + j * kVEP + t0 * 2));
          mma_16816(accL[2 * np], a, bv[0], bv[1]);
          mma_16816(accL[2 * np + 1], a, bv[2], bv[3]);
        }
    }
    // (d) dR_m^T += x_m^T du for window group mm: 32 x 8 slots, K = 16
    // tokens; du as hi + lo
#pragma unroll
    for (int k = 0; k < kMPW; ++k) {
      const int mm = warp + kWarps * k;
      if (mm < W) {
        uint32_t bq[4];
        {
          const int t0 = ((lane >> 3) & 1) * 8;
          ldsm_x4(bq, reinterpret_cast<const bf16*>(
                          ((lane >> 4) ? dulo : duhi) + mm * kDUMP + (lane & 7) * kDUQP + t0 * 2));
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
          const int t = (lane & 7) + (lane >> 4) * 8;
          const int j0 = mt * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4_trans(a, reinterpret_cast<const bf16*>(xs + (size_t)t * lay.xp + (mm * kB + j0) * 2));
          mma_16816(accR[k][mt], a, bq[0], bq[1]);
          mma_16816(accR[k][mt], a, bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // this split's sums: dL rows of the warp's slot; the dR rows of its
  // window groups that some slot owns
  float* oL = outL + split * split_stride + (size_t)row * r * kB * kB;
  float* oR = outR + split * split_stride + (size_t)row * r * kB * kB;
  if (myq >= 0) {
    float* dst = oL + (size_t)myg * kB * kB;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int i = half * 16 + gid, j = n * 8 + 2 * tig;
      *reinterpret_cast<float2*>(dst + i * kB + j) = make_float2(accL[n][0], accL[n][1]);
      *reinterpret_cast<float2*>(dst + (i + 8) * kB + j) = make_float2(accL[n][2], accL[n][3]);
    }
  }
#pragma unroll
  for (int k = 0; k < kMPW; ++k) {
    const int mm = warp + kWarps * k;
    if (mm >= W) continue;
    const int mv = w0 + mm, m = mv >= r ? mv - r : mv, wrap = mv >= r ? 1 : 0;
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int s = 2 * tig + ci, q = tab[8 + 4 * s], e = mm - tab[10 + 4 * s];
      if (q < 0 || e < 0 || e >= kB) continue;
      float* dst = oR + ((size_t)m * kB + q + wrap) * kB;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        dst[mt * 16 + gid] = accR[k][mt][ci];
        dst[mt * 16 + gid + 8] = accR[k][mt][2 + ci];
      }
    }
  }
}

}  // namespace tc


// ---------------------------------------------------------------------------
// Route 2: two passes through an fp32 workspace
// ---------------------------------------------------------------------------

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

// Pass 2: rows [4 * it0, 4 * it1) of block g of row `row` (i-chunk ic of
// ichunks), tokens [s * tps, (s + 1) * tps):
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
                     size_t split_stride, int n_tokens, int r, int b, int tps,
                     int ichunks) {
  extern __shared__ __align__(16) float sm[];  // (TK, bi) x 2 + (TK, bp) x 2
  constexpr int NT = kReduceThreads, TK = kReduceTokens;
  const int g = blockIdx.x / ichunks, ic = blockIdx.x - g * ichunks;
  const int s = blockIdx.y, row = blockIdx.z;
  const int d = r * b, bp = (b + 3) & ~3, n4 = bp / 4;
  const int rows4 = (n4 + ichunks - 1) / ichunks;
  const int it0 = ic * rows4, it1 = min(n4, it0 + rows4);
  if (it0 >= it1) return;
  const int bi = 4 * (it1 - it0), ib = 4 * it0;    // staged rows of dw, du
  const int tiles = (it1 - it0) * n4;
  const int slices = tiles >= NT ? 1 : NT / tiles;
  const int slice = slices > 1 ? threadIdx.x / tiles : 0;
  float* sdw = sm;
  float* sdu = sdw + TK * bi;
  float* sv = sdu + TK * bi;
  float* sx = sv + TK * bp;
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
      float v = 0.f, xv = 0.f;
      if (t < nt && i < b) {
        const size_t gi = base + (size_t)(t0 + t) * d + i;
        v = ws_v[gi];
        xv = to_f32(x[gi]);
      }
      sv[e] = v;
      sx[e] = xv;
    }
    for (int e = threadIdx.x; e < TK * bi; e += NT) {
      const int t = e / bi, i = ib + e - t * bi;
      float w = 0.f, u = 0.f;
      if (t < nt && i < b) {
        const size_t gi = base + (size_t)(t0 + t) * d + i;
        w = ws_dw[gi];
        u = ws_du[gi];
      }
      sdw[e] = w;
      sdu[e] = u;
    }
    __syncthreads();
    for (int t = slice; t < nt; t += slices) {
#pragma unroll
      for (int q = 0; q < TP; ++q) {
        if (!act[q]) continue;
        const float4 w4 = *reinterpret_cast<const float4*>(sdw + t * bi + i0[q]);
        const float4 u4 = *reinterpret_cast<const float4*>(sdu + t * bi + i0[q]);
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
        const int i = ib + i0[q] + e / 4, j = j0[q] + e % 4;
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
    const int i = ib + 4 * (tile / n4) + e / 4, j = 4 * (tile % n4) + e % 4;
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

// dL, dR from the splits' partial sums (part: dL's splits, then dR's)
int sum_splits(const float* part, float* dL, float* dR, size_t n_out, int splits,
               cudaStream_t stream) {
  const size_t want = (n_out + 255) / 256;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  gs_bwd_sum_kernel<<<blocks, 256, 0, stream>>>(part, dL, n_out, splits);
  gs_bwd_sum_kernel<<<blocks, 256, 0, stream>>>(part + splits * n_out, dR, n_out,
                                                splits);
  return (int)cudaGetLastError();
}

// Route 1. table: n_entries x tc::kTab ints (kernels/gs_fused.py bwd_plan);
// part: 2 * splits * B * r * b * b floats when splits > 1.
int launch_grads_tc(const void* x, const void* dy, const void* L, const void* R,
                    const int* table, float* part, float* dL, float* dR, int B,
                    int n_tokens, int r, int n_entries, int splits, int tps,
                    int maxw, int maxdq, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || n_tokens <= 0 || r < tc::kB || n_entries <= 0 ||
      splits <= 0 || splits > 65535 || tps <= 0 || tps % tc::kTT != 0 ||
      (long long)splits * tps < n_tokens || maxw <= 0 || maxw > tc::kMaxWin ||
      maxdq <= 0 || maxdq > tc::kB || maxdq % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const tc::Layout lay(maxw, maxdq);
  if (lay.total > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(tc::gs_grads_tc_kernel, lay.total);
  if (err != cudaSuccess) return (int)err;
  const size_t n_out = (size_t)B * r * tc::kB * tc::kB;
  float* outL = splits > 1 ? part : dL;
  float* outR = splits > 1 ? part + splits * n_out : dR;
  tc::gs_grads_tc_kernel<<<dim3(n_entries, splits, B), tc::kThreads, lay.total,
                           stream>>>(
      (const bf16*)x, (const bf16*)dy, (const bf16*)L, (const bf16*)R, table,
      outL, outR, n_out, n_tokens, r, tps, maxw, maxdq);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return sum_splits(part, dL, dR, n_out, splits, stream);
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
                  int splits, int tps, int ichunks, cudaStream_t stream) {
  auto kernel = gs_bwd_reduce_kernel<T, TP>;
  const int bp = (b + 3) & ~3, n4 = bp / 4;
  const int bi = 4 * ((n4 + ichunks - 1) / ichunks);
  const size_t stage = (size_t)2 * kReduceTokens * (bi + bp) * sizeof(float);
  const size_t red = (size_t)kReduceThreads * 32 * sizeof(float);
  const size_t smem = stage > red ? stage : red;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * n_tokens * r * b;
  kernel<<<dim3(r * ichunks, splits, B), kReduceThreads, smem, stream>>>(
      ws, ws + n, ws + 2 * n, (const T*)x, outL, outR, split_stride, n_tokens,
      r, b, tps, ichunks);
  return (int)cudaGetLastError();
}

// 4 x 4 tiles per thread of pass 2: 1 for b <= 64, else 2 or 4, with the
// rows of larger blocks split over `ichunks` CTAs
template <typename T>
int dispatch_reduce(const float* ws, const void* x, float* outL, float* outR,
                    size_t split_stride, int B, int n_tokens, int r, int b,
                    int splits, int tps, int ichunks, cudaStream_t stream) {
  const int n4 = ((b + 3) & ~3) / 4;
  const int rows4 = (n4 + ichunks - 1) / ichunks;
  const int tp = (rows4 * n4 + kReduceThreads - 1) / kReduceThreads;
#define GS_REDUCE(TPV)                                                          \
  return launch_reduce<T, TPV>(ws, x, outL, outR, split_stride, B, n_tokens, r, \
                               b, splits, tps, ichunks, stream)
  if (tp <= 1) GS_REDUCE(1);
  if (tp <= 2) GS_REDUCE(2);
  if (tp <= 4) GS_REDUCE(4);
#undef GS_REDUCE
  return (int)cudaErrorInvalidValue;
}

// Pass 1 at any d, as a chain of the wide passes of gs_common.cuh through
// the same workspace: v = P R x, dw = P dy, du = P^T L^T dw, dx = R^T du.
template <typename T, bool WITH_DX>
int wide_tile(const void* x, const void* dy, const void* L, const void* R,
              void* dx, float* ws, int B, int n_tokens, int r, int b,
              cudaStream_t s) {
  const size_t n = (size_t)B * n_tokens * r * b;
  cudaError_t err = wide_pass<T, T, T, float>(x, R, nullptr, 0, ws, B, n_tokens,
                                              r, b, kMapId, kMapP, 0, s);
  if (err == cudaSuccess)
    err = wide_pass<T, T, T, float>(dy, nullptr, nullptr, 0, ws + n, B,
                                    n_tokens, r, b, kMapId, kMapP, 0, s);
  if (err == cudaSuccess)
    err = wide_pass<T, float, T, float>(ws + n, L, nullptr, 0, ws + 2 * n, B,
                                        n_tokens, r, b, kMapId, kMapPT, 1, s);
  if (err == cudaSuccess && WITH_DX)
    err = wide_pass<T, float, T, T>(ws + 2 * n, R, nullptr, 0, dx, B, n_tokens,
                                    r, b, kMapId, kMapId, 1, s);
  return (int)err;
}

// Route 2. ws: 3 * B * T * d floats (v, dw, du); part: 2 * splits * B * r *
// b * b floats when splits > 1 (unused otherwise); dL, dR: B * r * b * b
// floats. tt: tokens per pass-1 tile, or 0 for the wide pass 1 (any d).
template <typename T, bool WITH_DX>
int launch_bwd(const void* x, const void* dy, const void* L, const void* R,
               const void* RT, void* dx, float* ws, float* part, float* dL,
               float* dR, int B, int n_tokens, int r, int b, int tt, int splits,
               int ichunks, void* stream_ptr) {
  if ((tt == 0 ? bad_wide_shape(B, n_tokens, r, b)
               : bad_shape(B, n_tokens, r, b, tt)) ||
      b > kMaxBwdBlock || splits <= 0 ||
      splits > 65535 || ichunks <= 0 || (long long)r * ichunks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err;
  switch (tt) {
    case 0: err = wide_tile<T, WITH_DX>(x, dy, L, R, dx, ws, B, n_tokens, r, b, stream); break;
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
                           tps, ichunks, stream);
  if (err != 0 || splits == 1) return err;
  return sum_splits(part, dL, dR, n_out, splits, stream);
}

}  // namespace gs

extern "C" {

int gs_max_tile_elems() { return gs::kMaxTileElems; }

int gs_reduce_tokens() { return gs::kReduceTokens; }

// the constants the launch plan mirrors: tc block, slots, tokens per tile,
// largest window; pass-2 tiles a CTA; largest block
void gs_bwd_constants(int* out) {
  out[0] = gs::tc::kB;
  out[1] = gs::tc::kSlots;
  out[2] = gs::tc::kTT;
  out[3] = gs::tc::kMaxWin;
  out[4] = gs::kReduceTiles;
  out[5] = gs::kMaxBwdBlock;
  out[6] = gs::tc::kTab;
}

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gs_grads_tc_bf16(const void* x, const void* dy, const void* L, const void* R,
                     const int* table, float* part, float* dL, float* dR, int B,
                     int n_tokens, int r, int n_entries, int splits, int tps,
                     int maxw, int maxdq, void* stream) {
  return gs::launch_grads_tc(x, dy, L, R, table, part, dL, dR, B, n_tokens, r,
                             n_entries, splits, tps, maxw, maxdq,
                             (cudaStream_t)stream);
}

#define GS_BWD_ENTRY(NAME, T, WITH_DX)                                            \
  int NAME(const void* x, const void* dy, const void* L, const void* R,           \
           const void* RT, void* dx, float* ws, float* part, float* dL, float* dR, \
           int B, int n_tokens, int r, int b, int tt, int splits, int ichunks,    \
           void* stream) {                                                        \
    return gs::launch_bwd<T, WITH_DX>(x, dy, L, R, RT, dx, ws, part, dL, dR, B,   \
                                      n_tokens, r, b, tt, splits, ichunks,        \
                                      stream);                                    \
  }
GS_BWD_ENTRY(gs_fused_bwd_f32, float, true)
GS_BWD_ENTRY(gs_fused_bwd_bf16, __nv_bfloat16, true)
GS_BWD_ENTRY(gs_fused_grads_f32, float, false)
GS_BWD_ENTRY(gs_fused_grads_bf16, __nv_bfloat16, false)
#undef GS_BWD_ENTRY

}  // extern "C"
