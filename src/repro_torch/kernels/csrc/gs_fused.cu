// Forward GSOFT rotation for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gs_fused.py gs_fused_pallas
// (_gs_fused_kernel):  y[i] = P^T L_i P R_i x[i]  (= Q_i x[i]): the rotation
// of W's columns that every GSOFT training step materializes (and Double
// GSOFT's dx of its output side), and the offline merge. Two routes, picked
// by the launch plan (kernels/gs_fused.py fwd_plan); one call is one launch.
//
// What bounds it on the H100: the bytes. x is read and y written once (4 * T
// * d bytes in bf16) against 4 * T * d * b operations, which is below the
// tensor cores' ratio for b < 256 (b = 32: 32 operations a byte).
//
// Route 1, gs_fused_tc (bf16, b = 32, r >= 32: every slab GSOFT and Double
// GSOFT train). Split x into r source groups m of b features; u = R x and
// v = P u put row q of R_m x_m at position c = q*r + m, z_g = L_g v_g, and
// y = P^T z writes z[c] back to y[m*b + q]. Output group g (c in [g*b, g*b +
// b), c = q*r + s0) therefore reads row q of R_m x_m for the source groups
// m = s0 .. s0 + b - 1 (past r - 1: groups 0.. of row q + 1) and writes y
// at the same positions m*b + q: each output element has one owner, with
// no sum across CTAs. The plan is the backward's (tc_table, csrc/
// gs_fused_bwd.cu): tile k holds the b output groups whose s0 lie in [k*b,
// k*b + b), one per q, in 4 table entries of 8 groups ("slots") sorted by
// s0. Here ONE CTA takes a whole tile (32 slots), not one entry: the 4
// entries' windows overlap, so the tile's x window (at most 2b - 1 = 63
// source groups) is read from L2 once instead of about 4 times, and when b
// divides r the tile is a closed super-block of b^2 contiguous features in
// and out, so y is written in whole 2 KB rows of a token.
// A CTA (512 threads, alone on its SM for its shared memory) streams
// 16-token tiles of its window through a cp.async ring of 16-byte copies
// (3 stages when b | r, else 2) kept as bf16, and computes with mma.sync
// m16n8k16 (bf16 in, fp32 sums):
//   (a) U^T = X_m R_m'^T (16 tokens x the 8 slots of an entry, K = b) for
//       each window group m (b | r: all 4 entries from one ldmatrix of
//       X_m); v = P u, split into bf16 hi + lo, stored transposed
//       (stmatrix.trans) as V[slot][position][token];
//   (c) Z^T = V L_g^T (16 tokens x b, K = b) per slot, hi and lo both
//       multiplied; z rounded once to bf16 into Z[slot][token][i]
//       (stmatrix);
//   then y = P^T z from Z: 16-byte chunks of 8 slots when b | r (a warp
//   writes 512 contiguous bytes), else one element a lane, a window
//   group's 32 features a warp instruction, where the tile owns them.
// R's rows and L's blocks of the CTA's groups are loaded once per CTA into
// registers (the B fragments) and reused for all its tokens; the tokens are
// split over CTAs so tiles x splits x rows fill one wave of the SMs; a
// ragged last tile is zero-filled and masked. y is stored with the
// streaming hint (st.global.cs), which keeps it from evicting the x stream
// from L2 (tools/gs_fwd_ablate.py times the kernel with plain stores).
// Shared-memory pitches are odd multiples of 16 bytes or XOR-swizzled, so
// every ldmatrix / stmatrix and the 16-byte y gather are conflict-free. No
// workspace: x is read once from device memory and y written once.
// Numerics: R x has exact bf16 operands and fp32 sums, as the plain version;
// v is kept as hi + lo (about 16 bits of mantissa, 2^-17 relative) where
// JAX's kernel keeps fp32 and the plain version rounds v to bf16; y is
// rounded once. Every element is written by one thread from sums in a
// fixed order, so reruns are bit-identical.
// What holds it from its bound (PERF.md §6, from tools/gs_fwd_ablate.py):
// when b | r it runs near a plain copy of x (y.copy_(x)). When b does not
// divide r (the MLP wo slab, r = 924) the tile owns only parts of most y
// rows of its window (about 60 groups for 32 groups of output), so its
// write-back issues one 2-byte store a lane per (token, window group),
// about 60 a warp and tile against 4 stores of 512 bytes when b | r, each
// with its own index math; with one CTA an SM the phases add up, and the
// kernel spills a few registers at 128. That holds it at about 5x its
// bound.
//
// Route 2, gs_fused_kernel (f32 -- the offline merge and the f32 checks --,
// b != 32, r < b): one tile of TT tokens per CTA, the fp32 tile and the
// intermediate in shared memory, never in device memory, the design of
// gs_fused_T.cu; it takes the TRANSPOSED factors L^T, R^T (the wrapper
// passes them) so that its block products read the factors coalesced. Each
// tile re-reads the row's factors from L2, and a tile holds whole rows of
// at most kMaxTileElems features; a wider row (the wrapper passes tt = 0 to
// gs_fused_wide_*) runs two wide passes of gs_common.cuh through an fp32
// workspace instead, v = P R x and y = P^T L v: any d.

#include "gs_common.cuh"
#include "mma.cuh"

namespace gs {

// y = P^T L P R x for every token of the tile, from the TRANSPOSED factors
// LT[g] = L_g^T, RT[g] = R_g^T (the wrapper passes them), so that
// u_g = R_g x_g  is  u[g*b + i] = sum_j RT[g][j][i] x[g*b + j], the coalesced
// block product of gs_common.cuh.
template <typename T, int TT>
__global__ void __launch_bounds__(kThreads, 1)
gs_fused_kernel(const T* __restrict__ x, const T* __restrict__ LT,
                const T* __restrict__ RT, T* __restrict__ y,
                int n_tokens, int r, int b) {
  extern __shared__ float buf[];                     // (TT, d) fp32
  const int d = r * b;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int nt = min(TT, n_tokens - t0);
  const size_t off = ((size_t)row * n_tokens + t0) * d;
  const T* xr = x + off;
  T* yr = y + off;
  const T* Lr = LT + (size_t)row * r * b * b;
  const T* Rr = RT + (size_t)row * r * b * b;

  for (int o = threadIdx.x; o < TT * d; o += kThreads) {
    const int t = o / d;
    buf[o] = t < nt ? to_f32(xr[o]) : 0.f;
  }
  __syncthreads();

  float acc[kPerThread / TT][TT];
  // u = R x, in place
  block_stage<T, TT, false>(Rr, buf, d, r, b, 0, d, acc);
  __syncthreads();
  store_tile<TT>(buf, d, 0, d, acc);
  __syncthreads();

  // v = P u (v[c] = u[(c % r) * b + c / r]);  z_g = L_g v_g:
  // z[g*b + i] = sum_j LT[g][j][i] v[g*b + j]
  constexpr int KP = kPerThread / TT;
#pragma unroll
  for (int p = 0; p < KP; ++p) {
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[p][t] = 0.f;
    const int k = threadIdx.x + p * kThreads;
    if (k < d) {
      const int g = k / b, i = k - g * b;
      const T* Lg = Lr + (size_t)g * b * b + i;
      int quo = (g * b) / r, rem = (g * b) - quo * r;   // c = g*b + j as (quo, rem) of r
#pragma unroll 4
      for (int j = 0; j < b; ++j) {
        const float w = to_f32(Lg[(size_t)j * b]);
        const float* v = buf + rem * b + quo;
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[p][t] += w * v[t * d];
        if (++rem == r) { rem = 0; ++quo; }
      }
    }
  }
  __syncthreads();
  store_tile<TT>(buf, d, 0, d, acc);                // buf = z
  __syncthreads();
  // y = P^T z:  y[k] = z[(k % b) * r + k / b]
  for (int o = threadIdx.x; o < nt * d; o += kThreads) {
    const int t = o / d, k = o - t * d;
    yr[o] = from_f32<T>(buf[t * d + (k % b) * r + k / b]);
  }
}

// ---------------------------------------------------------------------------
// Route 1: gs_fused_tc
// ---------------------------------------------------------------------------

namespace fwd {

constexpr int kB = 32;             // block size
constexpr int kParts = 4;          // plan entries (of 8 slots) a tile holds
constexpr int kPartSlots = 8;
constexpr int kSlots = kParts * kPartSlots;  // output groups a CTA
constexpr int kTT = 16;            // tokens per staged tile
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWin = 2 * kB - 1;  // source groups a tile stages
constexpr int kEntryWin = 40;      // stage-(a) units per entry (> its window, <= 39)
constexpr int kTab = 8 + 4 * kPartSlots;  // ints per plan entry (tc_table)
constexpr int kVSP = kB * 32 + 16;  // bytes per slot of V: 32 positions x 16 tokens
constexpr int kZSP = kTT * kB * 2;  // bytes per slot of Z: 16 tokens x 32 outputs
constexpr int kSmemLimit = 232448;

struct Layout {
  int xp, stages;
  size_t xs, vhi, vlo, z, trash, tab, info, total;
  __host__ __device__ Layout(int maxw, bool simple) {
    xp = maxw * kB * 2 + 16;            // token pitch of the x stage
    stages = simple ? 3 : 2;
    size_t o = 0;
    xs = o;    o += (size_t)stages * kTT * xp;
    vhi = o;   o += kSlots * kVSP;
    vlo = o;   o += kSlots * kVSP;
    z = o;     o += kSlots * kZSP + (kSlots / 8) * 16;
    trash = o; o += 64;
    tab = o;   o += kParts * kTab * 4;
    info = o;  o += kSlots * 4 * 4;
    total = o;
  }
};

// byte offset of V[slot][e] half h (tokens 8h .. 8h + 7): the halves of
// rows e >= 4 (mod 8) are swapped, so the 8 rows an ldmatrix reads fall in
// distinct bank groups
__device__ __forceinline__ int v_off(int sl, int e, int h) {
  return sl * kVSP + e * 32 + ((h ^ ((e >> 2) & 1)) << 4);
}

// byte offset of Z[slot][t][i]: 16-byte chunk i / 8 of row t swizzled by
// t, and each group of 8 slots shifted by 16 bytes, so the stmatrix of (c)
// and the gather of 8 slots (b | r) read and write without bank conflicts
// (and the gather's addresses fold to immediates)
__device__ __forceinline__ int z_off(int sl, int t, int i) {
  return sl * kZSP + (sl >> 3) * 16 + t * 64 +
         ((((i >> 3) ^ (t >> 1)) & 3) << 4) + (i & 7) * 2;
}

// One CTA: tile blockIdx.x (plan entries 4k .. 4k + 3), token split
// blockIdx.y, row blockIdx.z. kSimple: b | r, so the tile is a super-block:
// window w0 = 32k of 32 groups, slot s is q = s with position e = window
// group e.
template <bool kSimple>
__global__ void __launch_bounds__(kThreads, 1)
gs_fused_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ L,
                   const bf16* __restrict__ R, const int* __restrict__ table,
                   bf16* __restrict__ y, int n_tokens, int r, int tps,
                   int maxw) {
  constexpr int kStages = kSimple ? 3 : 2;
  constexpr int kUnitStride = kSimple ? kB : kEntryWin;   // units per entry
  constexpr int kUPW = kParts * kUnitStride / kWarps;      // units per warp
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout lay(maxw, kSimple);
  const int split = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  int* tab = reinterpret_cast<int*>(sm + lay.tab);
  int* info = reinterpret_cast<int*>(sm + lay.info);  // slot: q, g, delta
  if (tid < kParts * kTab)
    tab[tid] = table[(size_t)blockIdx.x * kParts * kTab + tid];
  __syncthreads();
  // entry 0 starts the tile's window (the entries are sorted by s0); an
  // empty entry has W = 0 and no slot (q = -1)
  const int w0 = tab[0];
  int wend = w0;
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    if (tab[p * kTab + 1] > 0) wend = max(wend, tab[p * kTab] + tab[p * kTab + 1]);
  const int W = wend - w0;
  if (tid < kSlots) {
    const int* e = tab + (tid / kPartSlots) * kTab;
    const int j = tid % kPartSlots;
    info[4 * tid] = e[8 + 4 * j];
    info[4 * tid + 1] = e[9 + 4 * j];
    info[4 * tid + 2] = e[0] - w0 + e[10 + 4 * j];   // s0 - w0
  }
  __syncthreads();
  const int d = r * kB;
  const int t_beg = split * tps, t_end = min(n_tokens, t_beg + tps);
  if (t_beg >= t_end) return;

  // B fragments of R for (a). kSimple: fragment k is window group warp +
  // 16 (k / 4) for entry k % 4; else unit u = warp + 16k is (entry u /
  // stride, its window group u % stride). Column gid is the entry's slot
  // gid: row q (+1 past the wrap) of R_m
  uint32_t rf[kUPW][2][2];
#pragma unroll
  for (int k = 0; k < kUPW; ++k) {
    const int u = warp + kWarps * k;
    const int p = kSimple ? k % kParts : u / kUnitStride;
    const int ml = kSimple ? warp + kWarps * (k / kParts) : u % kUnitStride;
    const int* e = tab + p * kTab;
    const int q = e[8 + 4 * gid], mv = e[0] + ml;
    const int m = mv >= r ? mv - r : mv, qq = q + (mv >= r ? 1 : 0);
    const bool ok = ml < e[1] && q >= 0 && qq < kB;
    const bf16* src = R + (((size_t)row * r + (ok ? m : 0)) * kB + (ok ? qq : 0)) * kB;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      rf[k][kk][0] = ok ? *reinterpret_cast<const uint32_t*>(src + kk * 16 + 2 * tig) : 0u;
      rf[k][kk][1] = ok ? *reinterpret_cast<const uint32_t*>(src + kk * 16 + 2 * tig + 8) : 0u;
    }
  }
  // B fragments of L_g for (c): slots warp and warp + 16; B[k = e][n = i]
  // = L_g[i][e], a 32-bit pair of row i
  uint32_t lf[2][4][2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int sl = warp + kWarps * a, q = info[4 * sl];
    const bf16* Lg = L + ((size_t)row * r + (q >= 0 ? info[4 * sl + 1] : 0)) * kB * kB;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          lf[a][n][kk][h] = q >= 0 ? *reinterpret_cast<const uint32_t*>(
                                         Lg + (n * 8 + gid) * kB + kk * 16 + 2 * tig + 8 * h)
                                   : 0u;
  }
  // the write-back of a b-not-dividing-r tile: lane f writes feature f of
  // each window group it owns; the owner is the slot of q = f, or of
  // q = f - 1 for a window group past r - 1 (the wrap); a lane with no
  // such slot gets a start past any window group (it owns none)
  int own_sl = 0, own_d = 1 << 20, wrap_sl = 0, wrap_d = 1 << 20;
  if (!kSimple) {
    for (int s = 0; s < kSlots; ++s) {
      const int q = info[4 * s];
      if (q >= 0 && q == lane) { own_sl = s; own_d = info[4 * s + 2]; }
      if (q >= 0 && q + 1 == lane) { wrap_sl = s; wrap_d = info[4 * s + 2]; }
    }
  }

  // one tile of tokens [t0, t0 + 16) into stage buffer `buf`; rows past the
  // split's end are zero-filled
  const int xc = W * (kB / 8);                   // 16-byte chunks a token
  const int xwrap = min(W, r - w0) * (kB / 8);   // ... before the window wraps
  const int x_t = tid / xc, x_o = tid % xc, xt = kThreads / xc, xo = kThreads % xc;
  auto fetch = [&](int t0, int buf) {
    const int nt = min(kTT, t_end - t0);
    unsigned char* xs = sm + lay.xs + (size_t)buf * kTT * lay.xp;
    for (int t = x_t, o = x_o; t < kTT; t += xt, o += xo) {
      if (o >= xc) { o -= xc; ++t; if (t >= kTT) break; }
      const size_t base = ((size_t)row * n_tokens + t0 + (t < nt ? t : 0)) * d;
      const int off = o < xwrap ? w0 * kB + o * 8 : (o - xwrap) * 8;
      cp_async16(xs + (size_t)t * lay.xp + o * 16, x + base + off, t < nt);
    }
  };

  unsigned char* vhi = sm + lay.vhi;
  unsigned char* vlo = sm + lay.vlo;
  unsigned char* zs = sm + lay.z;
  const int ntiles = (t_end - t_beg + kTT - 1) / kTT;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) fetch(t_beg + s * kTT, s);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile landed; the last tile's readers are done
    if (it + kStages - 1 < ntiles)
      fetch(t_beg + (it + kStages - 1) * kTT, (it + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* xs = sm + lay.xs + (size_t)buf * kTT * lay.xp;

    // (a) u = R x: U^T (16 tokens x 8 slots of an entry), K = a window
    // group's 32 features; v = P u as hi + lo into V[slot][mm - delta][t].
    // kSimple: window groups warp and warp + 16, all 4 entries (slot s at
    // position mm); else each unit (entry p, window group mm).
    const int mi = lane >> 3, j8 = lane & 7;
    if (kSimple) {
#pragma unroll
      for (int k = 0; k < kUPW / kParts; ++k) {
        const int mm = warp + kWarps * k;
        float c[kParts][4];
#pragma unroll
        for (int p = 0; p < kParts; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) c[p][q] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[4];
          const int t = (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = kk * 16 + (lane >> 4) * 8;
          ldsm_x4(a, reinterpret_cast<const bf16*>(xs + (size_t)t * lay.xp + (mm * kB + col) * 2));
#pragma unroll
          for (int p = 0; p < kParts; ++p)
            mma_16816(c[p], a, rf[k * kParts + p][kk][0], rf[k * kParts + p][kk][1]);
        }
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          uint32_t s[4];
          hi_lo(c[p], s);
          stsm_x4_trans(s, (mi < 2 ? vhi : vlo) + v_off(p * kPartSlots + j8, mm, mi & 1));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < (kSimple ? 0 : kUPW); ++k) {
      const int u = warp + kWarps * k, p = u / kUnitStride, ml = u % kUnitStride;
      const int* e = tab + p * kTab;
      if (ml < e[1]) {
        const int mm = e[0] - w0 + ml;
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
        const int sl = p * kPartSlots + j8;
        const int pos = mm - info[4 * sl + 2];
        unsigned char* dst = (info[4 * sl] >= 0 && pos >= 0 && pos < kB)
            ? (mi < 2 ? vhi : vlo) + v_off(sl, pos, mi & 1)
            : sm + lay.trash;
        stsm_x4_trans(s, dst);
      }
    }
    __syncthreads();

    // (c) z = L_g v for slots warp and warp + 16: Z^T (16 tokens x 32), K =
    // 32 positions, v as hi + lo; rounded to bf16 into Z[slot][t][i]
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int sl = warp + kWarps * a;
      if (info[4 * sl] < 0) continue;
      float c[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[n][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ah[4], al[4];
        const int pos = kk * 16 + (lane & 7) + (lane >> 4) * 8;
        const int off = v_off(sl, pos, (lane >> 3) & 1);
        ldsm_x4_trans(ah, reinterpret_cast<const bf16*>(vhi + off));
        ldsm_x4_trans(al, reinterpret_cast<const bf16*>(vlo + off));
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          mma_16816(c[n], ah, lf[a][n][kk][0], lf[a][n][kk][1]);
          mma_16816(c[n], al, lf[a][n][kk][0], lf[a][n][kk][1]);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const uint32_t s[4] = {pack_f32(c[2 * np][0], c[2 * np][1]),
                               pack_f32(c[2 * np][2], c[2 * np][3]),
                               pack_f32(c[2 * np + 1][0], c[2 * np + 1][1]),
                               pack_f32(c[2 * np + 1][2], c[2 * np + 1][3])};
        const int mi = lane >> 3;
        const int t = (lane & 7) + (mi & 1) * 8, i = (2 * np + (mi >> 1)) * 8;
        stsm_x4(s, zs + z_off(sl, t, i));
      }
    }
    __syncthreads();

    // y = P^T z: warp w writes token w of the tile
    const int t = warp, tok = t_beg + it * kTT + t;
    if (tok < t_end) {
      bf16* yt = y + ((size_t)row * n_tokens + tok) * d;
      if (kSimple) {
        // lane (window group o * 8 + lane / 4, q chunk lane % 4): 8 slots'
        // outputs as one 16-byte store; a warp writes 512 contiguous bytes
        const int c8 = lane & 3;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int mm = o * 8 + (lane >> 2);
          uint32_t w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sl = c8 * 8 + 2 * j;
            const bf16 lo = *reinterpret_cast<const bf16*>(zs + z_off(sl, t, mm));
            const bf16 hi = *reinterpret_cast<const bf16*>(zs + z_off(sl + 1, t, mm));
            w[j] = pack_bf16(lo, hi);
          }
          st_cs16(yt + (size_t)(w0 + mm) * kB + c8 * 8,
                  make_uint4(w[0], w[1], w[2], w[3]));
        }
      } else {
        // window groups [mm0, mm1) with lane f the slot sl of start dd
        // (z_off(sl, t, mm - dd) with its parts hoisted), y of window group
        // mm at yp + mm * b; unrolled so several shared loads are in flight
        auto segment = [&](int mm0, int mm1, int sl, int dd, bf16* yp) {
          const unsigned char* zb = zs + sl * kZSP + (sl >> 3) * 16 + t * 64;
          const int ts = (t >> 1) & 3;
#pragma unroll 4
          for (int mm = mm0; mm < mm1; ++mm) {
            const int pos = mm - dd;
            if ((unsigned)pos < (unsigned)kB)
              st_cs2(yp + (size_t)mm * kB,
                     *reinterpret_cast<const bf16*>(
                         zb + ((((pos >> 3) ^ ts) & 3) << 4) + (pos & 7) * 2));
          }
        };
        const int nw = min(W, r - w0);   // window groups before the wrap
        segment(0, nw, own_sl, own_d, yt + (size_t)w0 * kB + lane);
        segment(nw, W, wrap_sl, wrap_d, yt + ((long long)w0 - r) * kB + lane);
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace fwd

// Route 1. table: the backward's plan (tc_table), 4 entries a tile.
int launch_fwd_tc(const void* x, const void* L, const void* R, const int* table,
                  void* y, int B, int n_tokens, int r, int tiles, int splits,
                  int tps, int maxw, cudaStream_t stream) {
  const bool simple = r % fwd::kB == 0;
  if (B <= 0 || B > 65535 || n_tokens <= 0 || r < fwd::kB ||
      tiles != (r + fwd::kB - 1) / fwd::kB || splits <= 0 || splits > 65535 ||
      tps <= 0 || tps % fwd::kTT != 0 || (long long)splits * tps < n_tokens ||
      maxw <= 0 || maxw > fwd::kMaxWin || (simple && maxw != fwd::kB))
    return (int)cudaErrorInvalidValue;
  const fwd::Layout lay(maxw, simple);
  if (lay.total > (size_t)fwd::kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = simple ? fwd::gs_fused_tc_kernel<true> : fwd::gs_fused_tc_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles, splits, B), fwd::kThreads, lay.total, stream>>>(
      (const bf16*)x, (const bf16*)L, (const bf16*)R, table, (bf16*)y, n_tokens,
      r, tps, maxw);
  return (int)cudaGetLastError();
}


template <typename T, int TT>
int launch_fwd(const void* x, const void* L, const void* R, void* y, int B,
               int n_tokens, int r, int b, cudaStream_t stream) {
  const size_t smem = (size_t)TT * r * b * sizeof(float);
  const unsigned tiles = (n_tokens + TT - 1) / TT;
  return (int)launch_kernel<decltype(&gs_fused_kernel<T, TT>), T>(
      gs_fused_kernel<T, TT>, 1, dim3(tiles, B), smem, stream, x, L, R, y,
      n_tokens, r, b);
}

template <typename T>
int launch(const void* x, const void* L, const void* R, void* y, int B,
           int n_tokens, int r, int b, int tt, void* stream) {
  if (bad_shape(B, n_tokens, r, b, tt)) return (int)cudaErrorInvalidValue;
  GS_DISPATCH_TT(tt, (launch_fwd<T, TT>(x, L, R, y, B, n_tokens, r, b,
                                        (cudaStream_t)stream)))
}

// Route 2 at any d (gs_common.cuh wide passes), from L and R as stored:
// ws = v = P R x (fp32, B * T * d floats), then y = P^T L v.
template <typename T>
int launch_wide(const void* x, const void* L, const void* R, float* ws,
                void* y, int B, int n_tokens, int r, int b, void* stream) {
  if (bad_wide_shape(B, n_tokens, r, b)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = wide_pass<T, T, T, float>(x, R, nullptr, 0, ws, B, n_tokens,
                                              r, b, kMapId, kMapP, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)wide_pass<T, float, T, T>(ws, L, nullptr, 0, y, B, n_tokens, r, b,
                                        kMapId, kMapPT, 0, s);
}

}  // namespace gs

extern "C" {

int gs_max_tile_elems() { return gs::kMaxTileElems; }

// the constants route 1's launch plan mirrors: block, slots an entry,
// tokens a tile, largest tile window, ints an entry, entries a tile
void gs_fwd_constants(int* out) {
  out[0] = gs::fwd::kB;
  out[1] = gs::fwd::kPartSlots;
  out[2] = gs::fwd::kTT;
  out[3] = gs::fwd::kMaxWin;
  out[4] = gs::fwd::kTab;
  out[5] = gs::fwd::kParts;
}

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gs_fused_f32(const void* x, const void* LT, const void* RT, void* y, int B,
                 int n_tokens, int r, int b, int tt, void* stream) {
  return gs::launch<float>(x, LT, RT, y, B, n_tokens, r, b, tt, stream);
}

int gs_fused_tc_bf16(const void* x, const void* L, const void* R,
                     const int* table, void* y, int B, int n_tokens, int r,
                     int tiles, int splits, int tps, int maxw, void* stream) {
  return gs::launch_fwd_tc(x, L, R, table, y, B, n_tokens, r, tiles, splits,
                           tps, maxw, (cudaStream_t)stream);
}

int gs_fused_bf16(const void* x, const void* LT, const void* RT, void* y, int B,
                  int n_tokens, int r, int b, int tt, void* stream) {
  return gs::launch<__nv_bfloat16>(x, LT, RT, y, B, n_tokens, r, b, tt, stream);
}

// Route 2 past the tile limit: L, R as stored (not transposed), ws an fp32
// workspace of B * T * d floats
int gs_fused_wide_f32(const void* x, const void* L, const void* R, float* ws,
                      void* y, int B, int n_tokens, int r, int b, void* stream) {
  return gs::launch_wide<float>(x, L, R, ws, y, B, n_tokens, r, b, stream);
}

int gs_fused_wide_bf16(const void* x, const void* L, const void* R, float* ws,
                       void* y, int B, int n_tokens, int r, int b,
                       void* stream) {
  return gs::launch_wide<__nv_bfloat16>(x, L, R, ws, y, B, n_tokens, r, b,
                                        stream);
}

}  // extern "C"
