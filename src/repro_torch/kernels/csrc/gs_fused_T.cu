// Transpose GSOFT rotation for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gs_fused.py
// gs_fused_T_pallas (_gs_fused_T_kernel) and its per-row vmap
// ops.gs_banked_transform_T:  y[i] = R_i^T P^T L_i^T P x[i]  (= x[i] Q_i)
// with Q = P^T L P R, P = P_(r, d) the GS shuffle, L and R block-diagonal with
// r blocks of b x b, d = r * b. x (B, T, d) and y contiguous, bf16 or f32.
// The factors of row i are either passed per row, (B, r, b, b), or read from
// a bank (A, r, b, b) at slot ids[i]: the kernel reads the id on the device
// and rounds an fp32 bank entry to x's dtype in registers, which is what
// index_select(...).to(x.dtype) would give, without that gather and cast.
// This is the banked serving rotation in front of every GSOFT-adapted
// projection, Double GSOFT's output side, and the dx of the GS backward.
// Two routes, picked by the launch plan (kernels/gs_fused.py t_plan).
//
// What bounds it on the H100: the bytes. At decode (T = 1 a row) the row's
// factors, 2 * d * b elements (8 MB in fp32 for 4 rows at d = 8192), against
// 2 * d for x and y; for long slabs x and y (4 * T * d bytes in bf16) against
// 4 * T * d * b operations, below the tensor cores' ratio for b = 32.
//
// Route 1, gs_T_tc (bf16 x, b = 32, r >= 32, any width d = 32 r). Write
// s = P x (s[i*r + u] = x[u*b + i]); L-block G holds the b positions
// G*b .. G*b + b - 1 of s, which are feature i of the natural groups
// u = G*b - i*r .. (past r - 1: feature i + 1 of groups 0 ..); z_G = L_G^T
// s_G; output group g (features g*b .. g*b + b - 1 of y) is
// y_g = R_g^T m_g with m_g[i] = z at position i*r + g. So output group g
// needs, for each row i, one entry of one L-block. A CTA owns a run of ng
// consecutive output groups g0 .. g0 + ng - 1 (ng = 32, or 16 / 8 when the
// plan spreads a short T over more CTAs) and a token split of one batch row:
// its y is one contiguous run of ng * b features per token, written by no
// other CTA, with no sum across CTAs. For row i its outputs are positions
// i*r + g0 .. of s-space: entries o_i = (i*r + g0) mod b .. of L-block
// G_i = (i*r + g0) / b, running into G_i + 1 when o_i + ng > b (b does not
// divide r). When b | r, o_i is the same for every i and the CTA's x is one
// super-block of b^2 features, closed under Q^T; otherwise its window of
// natural groups is g0 - 31 .. g0 + 63 at most (its plan entry gives it).
// The plan (t_plan in Python) lists the stage-1 units of an entry: (row i,
// block G_i or G_i + 1, which 16 of the b outputs), each holding only the
// factor rows its outputs need.
// A CTA (512 threads, alone on its SM) streams tiles of 16 tokens (b | r) or
// 8 (the wider window) of its x window through a 2-stage 16-byte cp.async
// ring, as bf16 (XOR-swizzled 16-byte chunks), and per tile:
//   (t) transposes it to XT[i][u][t] (row i, window group u, tokens
//       contiguous): one ldmatrix x4 + stmatrix.trans x4 per (group, 8
//       tokens), the feature shift of wrapped groups folded into the rows;
//   (1) Z^T = L^T S per stage-1 unit with mma.sync m16n8k16 (A = the unit's
//       L rows from registers, B = XT read by ldmatrix.trans at any
//       position offset, tokens as N), fp32 sums split into bf16 hi + lo and
//       stored (stmatrix) as V[g][i][t] at the output group they belong to;
//   (2) Y^T = R_g^T V_g (A = R_g from registers, B = V by ldmatrix.trans, hi
//       and lo both multiplied), y rounded once to bf16 into Z[t][g][f]
//       (stmatrix.trans) over the XT tile;
//   then y leaves in 16-byte evict-first stores (st.global.cs), a token's
//   ng * b features contiguous.
// The factors of a CTA (its 32 rows' L entries, its ng R blocks) are loaded
// once per CTA into registers (fp32 bank entries rounded to bf16 there) and
// reused for all its tokens; tokens are split over CTAs so entries x splits
// x rows fill one wave of SMs. Shared-memory pitches are odd multiples of 16
// bytes, so every ldmatrix / stmatrix is conflict-free; no workspace.
// Numerics: exact bf16 operands and fp32 sums; z kept as hi + lo (2^-17
// relative; JAX's kernel keeps fp32, the plain version rounds it to bf16);
// y rounded once. Every y element has one writer and a fixed summation
// order, so reruns are bit-identical; slot 0 of a bank (the identity) gives
// x back bit for bit.
//
// Route 2, gs_fused_T_kernel (f32, b != 32, r < b): one tile of TT tokens of
// one row per CTA (or per cluster, below), TT a power of two with TT * d <=
// 32768. The tile goes into shared memory once, as fp32 and already shuffled
// by P; each of the 1024 threads owns up to 32 / TT feature columns of all
// TT tokens and keeps their fp32 sums in registers. Stage 1 (L^T) overwrites
// the tile in place after one barrier; stage 2 (R^T) reads that intermediate
// at its P^T-shuffled position and writes y. When the split grid fits in one
// wave of SMs the wrapper splits every tile over a cluster of 8 CTAs: each
// reads 1/8 of the factors, and the CTAs exchange the intermediate over
// distributed shared memory. Its factor type is a template parameter of its
// own (an fp32 bank with bf16 x rounds each element to bf16, as above). A
// row wider than kMaxTileElems runs two wide passes of gs_common.cuh
// through an fp32 workspace instead (gs_fused_T_wide_*: P^T L^T P x, then
// R^T of it), bank read by slot id alike: any d.
//
// Both routes call griddepcontrol.launch_dependents at their start, so a
// kernel launched behind them with programmatic dependent launch (the int8
// product of gs_q_matmul) starts streaming its own operands meanwhile.

#include "gs_common.cuh"
#include "mma.cuh"

namespace gs {

constexpr int kCluster = 8;        // CTAs sharing one tile in the split kernel

// ---------------------------------------------------------------------------
// Route 2: gs_fused_T_kernel
// ---------------------------------------------------------------------------

// y = R^T P^T L^T P x for every token of the tile (TT tokens per tile).
//
// A tile is shared by a cluster of C CTAs (C = 1: no cluster). Each CTA holds
// the whole tile in its shared memory, computes 1/C of the feature columns of
// each stage (so it reads 1/C of the factors), and after stage 1 gathers the
// other CTAs' columns of the intermediate over distributed shared memory.
template <typename T, typename F, int TT, int C>
__global__ void __launch_bounds__(kThreads, 1)
gs_fused_T_kernel(const T* __restrict__ x, const F* __restrict__ Lf,
                  const F* __restrict__ Rf, const long long* __restrict__ ids,
                  int slots, T* __restrict__ y, int n_tokens, int r, int b) {
  pdl_launch_dependents();
  extern __shared__ float buf[];                     // (TT, d) fp32
  const int d = r * b;
  const int row = blockIdx.y;
  const int t0 = (blockIdx.x / C) * TT;
  const int rank = blockIdx.x % C;                   // rank in the (C,1,1) cluster
  const int share = (d + C - 1) / C;
  const int kbeg = min(d, rank * share), kend = min(d, kbeg + share);
  const int nt = min(TT, n_tokens - t0);
  const size_t off = ((size_t)row * n_tokens + t0) * d;
  const T* xr = x + off;
  T* yr = y + off;
  const size_t slot = (size_t)row_slot(ids, row, slots);
  const F* Lr = Lf + slot * r * b * b;
  const F* Rr = Rf + slot * r * b * b;

  // s = P x:  s[(k % b) * r + k / b] = x[k]  (P = P_(r, d), gather form);
  // rows past the ragged end are zero
  for (int o = threadIdx.x; o < TT * d; o += kThreads) {
    const int t = o / d, k = o - t * d;
    buf[t * d + (k % b) * r + k / b] = t < nt ? to_f32(xr[o]) : 0.f;
  }
  __syncthreads();

  float acc[kPerThread / TT][TT];
  // q_g = L_g^T s_g:  q[g*b + j] = sum_i L_g[i][j] s[g*b + i]
  block_stage<T, TT, false>(Lr, buf, d, r, b, kbeg, kend, acc);
  __syncthreads();
  store_tile<TT>(buf, d, kbeg, kend, acc);
  if constexpr (C > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                                  // every share of q written
    for (int o = threadIdx.x; o < TT * d; o += kThreads) {
      const int owner = (o % d) / share;
      if (owner != rank) buf[o] = cluster.map_shared_rank(buf, owner)[o];
    }
    cluster.sync();                                  // no peer reads us any more
  } else {
    __syncthreads();
  }
  // m = P^T q (m[g*b + i] = q[i*r + g]);  y_g[j] = sum_i R_g[i][j] m_g[i]
  block_stage<T, TT, true>(Rr, buf, d, r, b, kbeg, kend, acc);
#pragma unroll
  for (int p = 0; p < kPerThread / TT; ++p) {
    const int k = kbeg + threadIdx.x + p * kThreads;
    if (k < kend) {
#pragma unroll
      for (int t = 0; t < TT; ++t)
        if (t < nt) yr[(size_t)t * d + k] = from_f32<T>(acc[p][t]);
    }
  }
}

template <typename T, typename F, int TT>
int launch_T(const void* x, const void* L, const void* R, const long long* ids,
             int slots, void* y, int B, int n_tokens, int r, int b, int cluster,
             cudaStream_t stream) {
  const size_t smem = (size_t)TT * r * b * sizeof(float);
  const unsigned tiles = (n_tokens + TT - 1) / TT;
  if (cluster != 1 && cluster != kCluster) return (int)cudaErrorInvalidValue;
  auto kernel = cluster == kCluster ? gs_fused_T_kernel<T, F, TT, kCluster>
                                    : gs_fused_T_kernel<T, F, TT, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, B);
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
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const F*)L, (const F*)R,
                           ids, slots, (T*)y, n_tokens, r, b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename F>
int launch(const void* x, const void* L, const void* R, const long long* ids,
           int slots, void* y, int B, int n_tokens, int r, int b, int tt,
           int cluster, void* stream) {
  if (bad_shape(B, n_tokens, r, b, tt) || (ids != nullptr && slots <= 0))
    return (int)cudaErrorInvalidValue;
  GS_DISPATCH_TT(tt, (launch_T<T, F, TT>(x, L, R, ids, slots, y, B, n_tokens, r,
                                         b, cluster, (cudaStream_t)stream)))
}

// Route 2 at any d (gs_common.cuh wide passes): ws = P^T L^T P x (fp32, B *
// T * d floats), then y = R^T ws; the factors as stored, per row or a bank
// read at ids[row].
template <typename T, typename F>
int launch_wide(const void* x, const void* L, const void* R,
                const long long* ids, int slots, float* ws, void* y, int B,
                int n_tokens, int r, int b, void* stream) {
  if (bad_wide_shape(B, n_tokens, r, b) || (ids != nullptr && slots <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = wide_pass<T, T, F, float>(x, L, ids, slots, ws, B, n_tokens,
                                              r, b, kMapP, kMapPT, 1, s);
  if (err != cudaSuccess) return (int)err;
  return (int)wide_pass<T, float, F, T>(ws, R, ids, slots, y, B, n_tokens, r, b,
                                        kMapId, kMapId, 1, s);
}

// ---------------------------------------------------------------------------
// Route 1: gs_T_tc
// ---------------------------------------------------------------------------

namespace tT {

constexpr int kB = 32;             // block size
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLU = 6;          // stage-1 units a warp holds
constexpr int kMaxRU = 4;          // stage-2 units a warp holds
constexpr int kMaxUnits = kWarps * kMaxLU;   // stage-1 units an entry lists
constexpr int kHdr = 8;            // plan entry: g0, ng, wstart, W, units, 0...
constexpr int kTab = kHdr + kMaxUnits;       // ints per plan entry
constexpr int kMaxWin = 96;        // window groups an entry stages
constexpr int kSmemLimit = 232448;

// Shared memory of a CTA: the plan entry, a trash row for unowned fragment
// rows, the x ring S[stage][t][u][32] (16-byte chunks XOR-swizzled by u /
// 2), XT[i][u][t] (aliased by Z[t][g][32] once stage 1 has read it), V hi
// and lo [g][i][t].
struct Layout {
  int tt, sp, np, ip, vr, gp, zp;
  size_t tab, trash, s, xt, vhi, vlo, total;
  __host__ __device__ Layout(int tt_, int W, int ng, int stages) {
    tt = tt_;
    sp = W * kB * 2 + 16;               // x token pitch (an odd multiple of 16)
    np = tt == 16 ? 48 : 16;            // XT pitch of a window group (tt tokens)
    ip = W * np;                        // XT pitch of a row i
    if ((ip / 16) % 2 == 0) ip += 16;
    vr = tt == 16 ? 48 : 16;            // V pitch of a row i (tt tokens)
    gp = kB * vr + 16;                  // V pitch of an output group
    zp = ng * kB * 2 + 16;              // Z token pitch
    size_t o = 0;
    tab = o;   o += kTab * 4;
    trash = o; o += 64;
    s = o;     o += (size_t)stages * tt * sp;
    const size_t xtb = (size_t)kB * ip, zb = (size_t)tt * zp;
    xt = o;    o += xtb > zb ? xtb : zb;
    vhi = o;   o += (size_t)ng * gp;
    vlo = o;   o += (size_t)ng * gp;
    total = o;
  }
};

__device__ __forceinline__ int floor_div(int a, int r) {
  return a >= 0 ? a / r : -((r - 1 - a) / r);
}

__device__ __forceinline__ float ld_factor(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_factor(const bf16* p) {
  return __bfloat162float(*p);
}

// two factor elements as one bf16 pair, `lo` in the low half
template <typename F>
__device__ __forceinline__ uint32_t factor_pair(const F* lo, const F* hi) {
  return pack_f32(ld_factor(lo), ld_factor(hi));
}

// One CTA: plan entry blockIdx.x, token split blockIdx.y, batch row
// blockIdx.z; TT tokens a staged tile (16: b | r, window 32 groups; 8
// otherwise). F: the factor type (float: a bank; bf16: per-row factors).
// KLU, KRU: stage-1 and stage-2 units a warp holds at most, the plan's:
// the small entries of a short T need fewer fragment registers, and a
// kernel that holds no more than them spills less and runs its decode
// calls faster.
template <typename F, int TT, int KLU, int KRU>
__global__ void __launch_bounds__(kThreads, 1)
gs_T_tc_kernel(const bf16* __restrict__ x, const F* __restrict__ L,
               const F* __restrict__ R, const long long* __restrict__ ids,
               int slots, const int* __restrict__ table, bf16* __restrict__ y,
               int n_tokens, int r, int tps, int maxw, int maxng, int stages) {
  constexpr int NT = TT / 8;                    // n-tiles of 8 tokens
  pdl_launch_dependents();
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout lay(TT, maxw, maxng, stages);
  const int split = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  int* tab = reinterpret_cast<int*>(sm + lay.tab);
  for (int o = tid; o < kTab; o += kThreads)
    tab[o] = table[(size_t)blockIdx.x * kTab + o];
  const size_t slot = (size_t)row_slot(ids, row, slots);  // while tab lands
  __syncthreads();
  const int g0 = tab[0], ng = tab[1], wstart = tab[2], W = tab[3], nl = tab[4];
  if (nl > kWarps * KLU || 2 * ng > kWarps * KRU) __trap();  // a plan mismatch
  const int d = r * kB;
  const int t_beg = split * tps, t_end = min(n_tokens, t_beg + tps);
  if (t_beg >= t_end) return;
  const F* Lr = L + slot * r * kB * kB;
  const F* Rr = R + slot * r * kB * kB;

  // stage-1 units warp + 16 k: code = i | beta << 5 | mu << 6 | elo << 8 |
  // ehi << 16: row i, L-block G_i + beta, outputs e' = 16 mu .. 16 mu + 15
  // of which [elo, ehi) are the CTA's. A[m = e'][k = e] = L_G[e][e'] (rows
  // outside [elo, ehi) zero, their loads skipped); fragment register j
  // holds row m = gid + 8 (j & 1), columns k = 2 tig + 8 (j >> 1), + 1
  uint32_t la[KLU][2][4];
#pragma unroll
  for (int k = 0; k < KLU; ++k) {
    const int u = warp + kWarps * k;
    const int code = u < nl ? tab[kHdr + u] : 0;
    const int i = code & 31, beta = (code >> 5) & 1, mu = (code >> 6) & 1;
    const int elo = (code >> 8) & 0xff, ehi = (code >> 16) & 0xff;
    const int G = (i * r + g0) / kB + beta;
    const F* Lg = Lr + (size_t)(u < nl ? G : 0) * kB * kB;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ep = 16 * mu + gid + 8 * (j & 1);
        const int kk = 16 * s + 2 * tig + 8 * (j >> 1);
        la[k][s][j] = (u < nl && ep >= elo && ep < ehi)
                          ? factor_pair(Lg + kk * kB + ep, Lg + (kk + 1) * kB + ep)
                          : 0u;
      }
  }
  // stage-2 units warp + 16 k: output group gl = u / 2, outputs f = 16 (u %
  // 2) ..; A[m = f][k = i] = R_g[i][f]
  uint32_t ra[KRU][2][4];
#pragma unroll
  for (int k = 0; k < KRU; ++k) {
    const int u = warp + kWarps * k;
    const bool ok = u < 2 * ng;
    const F* Rg = Rr + (size_t)(ok ? g0 + (u >> 1) : 0) * kB * kB;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = 16 * (u & 1) + gid + 8 * (j & 1);
        const int kk = 16 * s + 2 * tig + 8 * (j >> 1);
        ra[k][s][j] = ok ? factor_pair(Rg + kk * kB + f, Rg + (kk + 1) * kB + f)
                         : 0u;
      }
  }

  // tokens [t0, t0 + TT) of the window (natural groups wstart .. wstart + W
  // - 1, taken mod r) into ring buffer `buf`; tokens past the split's end
  // are zero-filled
  const int xc = W * 4;                          // 16-byte chunks a token
  auto fetch = [&](int t0, int buf) {
    const int nt = min(TT, t_end - t0);
    unsigned char* S = sm + lay.s + (size_t)buf * TT * lay.sp;
    for (int o = tid; o < TT * xc; o += kThreads) {
      const int t = o / xc, rem = o - t * xc, u = rem >> 2, c = rem & 3;
      int g = (wstart + u) % r;
      if (g < 0) g += r;
      const size_t base = ((size_t)row * n_tokens + t0 + (t < nt ? t : 0)) * d;
      cp_async16(S + (size_t)t * lay.sp + u * 64 + (((c ^ (u >> 1)) & 3) << 4),
                 x + base + g * kB + c * 8, t < nt);
    }
  };

  unsigned char* xt = sm + lay.xt;
  unsigned char* zs = sm + lay.xt;               // Z aliases XT
  unsigned char* vhi = sm + lay.vhi;
  unsigned char* vlo = sm + lay.vlo;
  unsigned char* trash = sm + lay.trash;
  const int mi = lane >> 3, rho = lane & 7;
  const int ntiles = (t_end - t_beg + TT - 1) / TT;
  fetch(t_beg, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_beg + it * TT;
    if (it + 1 < ntiles) fetch(t0 + TT, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile landed; the last tile's write-back is done
    const unsigned char* S = sm + lay.s + (size_t)(it & 1) * TT * lay.sp;

    // (t) XT[i][u][t] = S[t][u][i + wrap(u)], wrap(u) = floor((wstart +
    // u) / r): an 8 x 8 transpose per (window group, 8 tokens, 8 features)
    for (int task = warp; task < NT * W; task += kWarps) {
      const int u = task / NT, h = task - u * NT;
      uint32_t v[4];
      ldsm_x4(v, reinterpret_cast<const bf16*>(
                     S + (size_t)(h * 8 + rho) * lay.sp + u * 64 +
                     (((mi ^ (u >> 1)) & 3) << 4)));
      const int i = 8 * mi + rho - floor_div(wstart + u, r);
      stsm_x4_trans(v, (i >= 0 && i < kB)
                           ? xt + (size_t)i * lay.ip + u * lay.np + h * 16
                           : trash);
    }
    __syncthreads();

    // (1) per stage-1 unit: D (16 outputs e' x 8 tokens) = A . XT[i][base
    // .. base + 31][tokens], base = g0 - o_i + 32 beta - wstart; hi + lo
    // into V[gl][i][t], gl = e' + 32 beta - o_i
#pragma unroll
    for (int k = 0; k < KLU; ++k) {
      const int u = warp + kWarps * k;
      if (u >= nl) break;
      const int code = tab[kHdr + u];
      const int i = code & 31, beta = (code >> 5) & 1, mu = (code >> 6) & 1;
      const int elo = (code >> 8) & 0xff, ehi = (code >> 16) & 0xff;
      const int oi = (i * r + g0) & (kB - 1);
      const int base = g0 - oi + kB * beta - wstart;
      const int ep = 16 * mu + rho + 8 * (mi & 1);   // this lane's stored row
      const int gl = ep + kB * beta - oi;
      const bool own = ep >= elo && ep < ehi && gl >= 0 && gl < ng;
#pragma unroll
      for (int h = 0; h < NT; ++h) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, reinterpret_cast<const bf16*>(
                              xt + (size_t)i * lay.ip + (base + lane) * lay.np + h * 16));
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_16816(c, la[k][0], bf[0], bf[1]);
        mma_16816(c, la[k][1], bf[2], bf[3]);
        uint32_t s[4];
        hi_lo(c, s);
        stsm_x4(s, own ? (mi < 2 ? vhi : vlo) + (size_t)gl * lay.gp + i * lay.vr + h * 16
                       : trash);
      }
    }
    __syncthreads();

    // (2) per stage-2 unit: D (16 outputs f x 8 tokens) = A . V[gl][i][t],
    // hi and lo; rounded to bf16 into Z[t][gl][f] (over XT)
#pragma unroll
    for (int k = 0; k < KRU; ++k) {
      const int u = warp + kWarps * k;
      if (u >= 2 * ng) break;
      const int gl = u >> 1, f0 = 16 * (u & 1);
#pragma unroll
      for (int h = 0; h < NT; ++h) {
        uint32_t bh[4], bl[4];
        const size_t off = (size_t)gl * lay.gp + lane * lay.vr + h * 16;
        ldsm_x4_trans(bh, reinterpret_cast<const bf16*>(vhi + off));
        ldsm_x4_trans(bl, reinterpret_cast<const bf16*>(vlo + off));
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_16816(c, ra[k][0], bh[0], bh[1]);
        mma_16816(c, ra[k][0], bl[0], bl[1]);
        mma_16816(c, ra[k][1], bh[2], bh[3]);
        mma_16816(c, ra[k][1], bl[2], bl[3]);
        const uint32_t s[2] = {pack_f32(c[0], c[1]), pack_f32(c[2], c[3])};
        stsm_x2_trans(s, zs + (size_t)(h * 8 + rho) * lay.zp + gl * 64 +
                             (f0 + 8 * (mi & 1)) * 2);
      }
    }
    __syncthreads();

    // y: a token's ng * b features are contiguous in y and in Z
    const int cpt = ng * 4;                       // 16-byte chunks a token
    for (int o = tid; o < TT * cpt; o += kThreads) {
      const int t = o / cpt, c = o - t * cpt;
      if (t0 + t < t_end)
        st_cs16(y + ((size_t)row * n_tokens + t0 + t) * d + (size_t)g0 * kB + c * 8,
                *reinterpret_cast<const uint4*>(zs + (size_t)t * lay.zp + c * 16));
    }
  }
  cp_async_wait<0>();
}

}  // namespace tT

// Route 1. table: t_plan's entries (tT::kTab ints each); klu, kru: the
// units a warp holds at most (the kernel instantiated for them).
template <typename F>
int launch_T_tc(const void* x, const void* L, const void* R,
                const long long* ids, int slots, const int* table, void* y,
                int B, int n_tokens, int r, int entries, int splits, int tps,
                int tt, int maxw, int maxng, int klu, int kru,
                cudaStream_t stream) {
  if (B <= 0 || B > 65535 || n_tokens <= 0 || r < tT::kB || entries <= 0 ||
      splits <= 0 || splits > 65535 || (tt != 8 && tt != 16) || tps <= 0 ||
      tps % tt != 0 || (long long)splits * tps < n_tokens || maxw <= 0 ||
      maxw > tT::kMaxWin || (maxng != 8 && maxng != 16 && maxng != 32) ||
      (ids != nullptr && slots <= 0))
    return (int)cudaErrorInvalidValue;
  const int stages = tps > tt ? 2 : 1;
  const tT::Layout lay(tt, maxw, maxng, stages);
  if (lay.total > (size_t)tT::kSmemLimit) return (int)cudaErrorInvalidValue;
  // b | r (16-token tiles): entries of 8, 16, 32 groups; otherwise (8)
  decltype(&tT::gs_T_tc_kernel<F, 16, 2, 1>) kernel = nullptr;
  if (tt == 16 && klu <= 2 && kru <= 1) kernel = tT::gs_T_tc_kernel<F, 16, 2, 1>;
  else if (tt == 16 && klu <= 2 && kru <= 2) kernel = tT::gs_T_tc_kernel<F, 16, 2, 2>;
  else if (tt == 16 && klu <= 4 && kru <= 4) kernel = tT::gs_T_tc_kernel<F, 16, 4, 4>;
  else if (tt == 8 && klu <= 4 && kru <= 1) kernel = tT::gs_T_tc_kernel<F, 8, 4, 1>;
  else if (tt == 8 && klu <= 4 && kru <= 2) kernel = tT::gs_T_tc_kernel<F, 8, 4, 2>;
  else if (tt == 8 && klu <= 6 && kru <= 4) kernel = tT::gs_T_tc_kernel<F, 8, 6, 4>;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(entries, splits, B), tT::kThreads, lay.total, stream>>>(
      (const bf16*)x, (const F*)L, (const F*)R, ids, slots, table, (bf16*)y,
      n_tokens, r, tps, maxw, maxng, stages);
  return (int)cudaGetLastError();
}

}  // namespace gs

extern "C" {

int gs_max_tile_elems() { return gs::kMaxTileElems; }

int gs_cluster_size() { return gs::kCluster; }

// the constants route 1's launch plan mirrors: block, warps, stage-1 units
// a warp, stage-2 units a warp, ints an entry, largest window, header ints
void gs_T_constants(int* out) {
  out[0] = gs::tT::kB;
  out[1] = gs::tT::kWarps;
  out[2] = gs::tT::kMaxLU;
  out[3] = gs::tT::kMaxRU;
  out[4] = gs::tT::kTab;
  out[5] = gs::tT::kMaxWin;
  out[6] = gs::tT::kHdr;
}

// shared memory of route 1 for a plan (what the launch asks for)
int gs_T_smem(int tt, int maxw, int maxng, int stages) {
  return (int)gs::tT::Layout(tt, maxw, maxng, stages).total;
}

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Route 2. x, factors: f32 / f32, bf16 / bf16, bf16 / f32 (a bank with bf16
// x); ids == nullptr: the factors are per row (B, r, b, b), else a bank of
// `slots` slots read at ids[row].
int gs_fused_T_f32_f32(const void* x, const void* L, const void* R,
                       const long long* ids, int slots, void* y, int B,
                       int n_tokens, int r, int b, int tt, int cluster,
                       void* stream) {
  return gs::launch<float, float>(x, L, R, ids, slots, y, B, n_tokens, r, b, tt,
                                  cluster, stream);
}

int gs_fused_T_bf16_bf16(const void* x, const void* L, const void* R,
                         const long long* ids, int slots, void* y, int B,
                         int n_tokens, int r, int b, int tt, int cluster,
                         void* stream) {
  return gs::launch<__nv_bfloat16, __nv_bfloat16>(x, L, R, ids, slots, y, B,
                                                  n_tokens, r, b, tt, cluster,
                                                  stream);
}

int gs_fused_T_bf16_f32(const void* x, const void* L, const void* R,
                        const long long* ids, int slots, void* y, int B,
                        int n_tokens, int r, int b, int tt, int cluster,
                        void* stream) {
  return gs::launch<__nv_bfloat16, float>(x, L, R, ids, slots, y, B, n_tokens,
                                          r, b, tt, cluster, stream);
}

// Route 2 past the tile limit (x, factors as above), ws an fp32 workspace of
// B * T * d floats.
#define GS_T_WIDE_ENTRY(NAME, T, F)                                            \
  int NAME(const void* x, const void* L, const void* R, const long long* ids,  \
           int slots, float* ws, void* y, int B, int n_tokens, int r, int b,   \
           void* stream) {                                                     \
    return gs::launch_wide<T, F>(x, L, R, ids, slots, ws, y, B, n_tokens, r,   \
                                 b, stream);                                   \
  }
GS_T_WIDE_ENTRY(gs_fused_T_wide_f32_f32, float, float)
GS_T_WIDE_ENTRY(gs_fused_T_wide_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
GS_T_WIDE_ENTRY(gs_fused_T_wide_bf16_f32, __nv_bfloat16, float)
#undef GS_T_WIDE_ENTRY

// Route 1 (bf16 x), factors f32 (a bank, or per row) or bf16 (per row).
int gs_T_tc_f32(const void* x, const void* L, const void* R,
                const long long* ids, int slots, const int* table, void* y,
                int B, int n_tokens, int r, int entries, int splits, int tps,
                int tt, int maxw, int maxng, int klu, int kru, void* stream) {
  return gs::launch_T_tc<float>(x, L, R, ids, slots, table, y, B, n_tokens, r,
                                entries, splits, tps, tt, maxw, maxng, klu, kru,
                                (cudaStream_t)stream);
}

int gs_T_tc_bf16(const void* x, const void* L, const void* R,
                 const long long* ids, int slots, const int* table, void* y,
                 int B, int n_tokens, int r, int entries, int splits, int tps,
                 int tt, int maxw, int maxng, int klu, int kru, void* stream) {
  return gs::launch_T_tc<__nv_bfloat16>(x, L, R, ids, slots, table, y, B,
                                        n_tokens, r, entries, splits, tps, tt,
                                        maxw, maxng, klu, kru,
                                        (cudaStream_t)stream);
}

}  // extern "C"
