// Block-diagonal matmul and its blocks gradient for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bdmm.py:
//
//   bdmm (bdmm_pallas): per row z, y[z, t, g*bo + i] =
//       sum_j W[z, g, i, j] * x[z, t, g*bi + j]
//     with W = blocks (B, r, bo, bi), or W = blocks^T read in place from
//     blocks (B, r, bi, bo) when `trans` is set (the banked OFT / BOFT
//     rotations and the dx of the autograd rule, which would otherwise copy
//     the transpose on every call); x (B, T, r*bi) -> y (B, T, r*bo), one
//     dtype (bf16 or f32), fp32 sums. B = 1 is the unbanked product; B > 1
//     gives every row its own blocks (the JAX package vmaps the kernel).
//
//   bdmm_dblocks (bdmm_dblocks_pallas): per row z,
//       dblocks[z, g, i, j] = sum_t dy[z, t, g*bo + i] * x[z, t, g*bi + j]
//     dy (B, T, r*bo), x (B, T, r*bi) -> dblocks (B, r, bo, bi) in fp32.
//
// Any bo, bi: no block-size limit.
//
// What bounds them on the H100. At the training path's shapes (the weight
// slabs: T = 1024 .. 29568 tokens, d = 8192 or 29568, b = 32) both read and
// write 2 * T * d elements against 2 * T * d * b operations: 32 FMAs per
// 4 bytes of bf16, a tenth of the 295 operations a byte where the tensor
// cores stop being the limit. Both are memory bound: the aim is to stream
// bytes at near the HBM rate and keep the arithmetic out of the way. At
// decode (B = 4, T = 1) the work is reading the per-row blocks,
// B * r * bo * bi elements against one token each.
//
// Routes (chosen in kernels/bdmm.py, checked again here):
//
// * bdmm_tc (bf16, T >= 16, bo and bi multiples of 8, bi <= 512): tensor
//   cores. A CTA owns gt groups x ncg output columns of each (a large bo is
//   split over CTAs along bo; a small one packs several groups per CTA so a
//   token row of x is >= 64 contiguous bytes). It stages its blocks once, as
//   bf16, zero-padded to the MMA tiles, and each warp loads its B fragments
//   (mma.sync m16n8k16: tokens are M, a group's output columns N, bi is K)
//   with ldmatrix, or ldmatrix.trans for blocks read transposed, and keeps
//   them in registers (NT n-tiles x KT k-steps <= 32 fragments, 64
//   registers) for all its token tiles. x tiles stream through a 3-stage
//   ring of 16-byte cp.async copies kept as bf16 (no widening), so two
//   tiles are in flight while one is multiplied; A fragments come from the
//   ring by ldmatrix. Rows of the ring, the blocks and the output tile are
//   padded to an odd number of 16-byte units, so ldmatrix and the fragment
//   stores hit 8 distinct bank groups. The fp32 sums round once to bf16
//   into a shared output tile that leaves in coalesced 16-byte stores. bi
//   not a multiple of 16 is zero-padded along K (zeroed blocks columns, a
//   zeroed tail of the ring's rows); bo not a multiple of the warp's n-tiles
//   has zeroed block rows whose outputs are not stored.
// * bdmm_decode (T < 16, block rows 16-byte aligned, both dtypes): the work
//   is one read of the blocks. Blocks in their layout: L lanes read a block
//   row (16 bytes each) and the token's x slice, and sum over warp shuffles.
//   Blocks read transposed: L lanes split the rows of the stored block, each
//   reads 16 bytes of output columns, and the shuffles sum over the lanes.
//   Tokens go in passes of 4 (a pass rereads the blocks from L1/L2).
// * bdmm_cc (f32, and bf16 shapes the routes above refuse): the CUDA cores,
//   full fp32 FMAs. f32 stays off the tensor cores: TF32 keeps about three
//   decimal digits, and the f32 tolerances (1e-4 on y, 1e-4 relative on the
//   gradients, a 1e-2 central difference) leave no room for it; 3xTF32 would
//   need three MMAs and a split per operand for a memory-bound kernel. One
//   thread per output column keeps TT tokens' sums in registers; the blocks
//   are staged once per CTA as fp32 (rows padded to kc + 1, conflict-free);
//   x tiles are double-buffered in their own dtype through 16-byte cp.async
//   when rows are 16-byte aligned (plain loads otherwise), with no division
//   per element. bi above the staged chunk kc is looped along (the blocks'
//   chunk restaged per step), bo above 256 is split over CTAs.
//
// bdmm_dblocks: the Pallas kernel revisits one fp32 output block over a
// sequential token grid; CUDA has no sequential grid. Tokens split over CTAs
// ("splits"); each CTA keeps its partial sums in registers and writes them
// to its split's slice; bdmm_sum_kernel adds the splits in order. Every
// output has one owner and a fixed summation order: runs are bit-identical,
// and there are no atomics.
//
// * bdmm_dblocks_tc (bf16, bo and bi multiples of 8): mma.sync with M = bo,
//   N = bi, K = tokens. dy and x tiles (token-major, as in device memory)
//   stream through a 3-stage cp.async ring; both operands come from them by
//   ldmatrix.trans. A warp owns a 32 x 32 tile of one group's dblocks (32
//   fp32 registers); a CTA holds gt groups x (wm x wn) warp tiles, and
//   larger blocks are split over CTAs along (bo, bi) output tiles. Rows past
//   T are zero-filled by cp.async, so they add nothing.
// * bdmm_dblocks_cc (f32, and other bf16 shapes): 4 x 4 tiles of (i, j) per
//   thread on the CUDA cores, dy and x tiles double-buffered as above,
//   blocks above 64 split over CTAs along (bo, bi).

#include "gs_common.cuh"
#include "mma.cuh"

namespace gs {

constexpr int kSmemLimit = 232448;   // bytes of shared memory one CTA may use
constexpr int kStages = 3;           // cp.async ring of the tensor-core kernels
constexpr int kCcStages = 2;         // double buffering on the CUDA cores
constexpr int kMaxThreads = 256;     // every kernel here: __launch_bounds__(256)
constexpr int kDecTokens = 4;        // tokens per pass of the decode kernel
constexpr int kDecThreads = 128;     // decode CTAs: small, so decode rows fill the SMs
constexpr int kDbCcTokens = 32;      // tokens per tile of bdmm_dblocks_cc

// ---------------------------------------------------------------------------
// Helpers (the PTX wrappers are in mma.cuh)
// ---------------------------------------------------------------------------

// 16 bytes of T as floats, and back
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }

// The cells (row, col) of a grid `cols` wide that this thread visits when a
// CTA walks it in row-major order, blockDim.x cells at a time: one division
// per walk, not per cell.
struct Cells {
  int row, col, cols, drow, dcol;
  __device__ __forceinline__ explicit Cells(int cols_) : cols(cols_) {
    row = threadIdx.x / cols;
    col = threadIdx.x - row * cols;
    drow = blockDim.x / cols;
    dcol = blockDim.x - drow * cols;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// A row pitch (elements of bf16) >= cols: a multiple of 8 (16 bytes) that
// is an odd number of 16-byte units, so 8 consecutive rows of an ldmatrix
// (or of a fragment store) fall in 8 distinct bank groups.
__host__ __device__ inline int pad_pitch(int cols) {
  int p = (cols + 7) / 8 * 8;
  if ((p / 8) % 2 == 0) p += 8;
  return p;
}

inline size_t ceil_div(size_t a, size_t b) { return (a + b - 1) / b; }

inline bool grid_ok(size_t gx, size_t gy, size_t gz) {
  return gx >= 1 && gx <= 0x7fffffff && gy >= 1 && gy <= 65535 && gz >= 1 &&
         gz <= 65535;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// bdmm on the tensor cores (bf16)
// ---------------------------------------------------------------------------

// Shared memory of bdmm_tc_kernel (kernels/bdmm.py _tc_smem mirrors it).
struct TcLayout {
  int ncg;       // output columns per group per CTA
  int xp;        // ring row pitch
  int bs_rows, bsp;  // blocks tile: rows, pitch
  int yp;        // output tile pitch
  size_t smem;
};

inline TcLayout tc_layout(int kt, int nt, int gt, int wpg, int tm, int bi,
                          bool trans) {
  TcLayout l;
  l.ncg = wpg * nt * 8;
  const int kw = kt * 16;
  l.xp = pad_pitch(gt * bi + (kw > bi ? kw - bi : 0));
  l.bs_rows = trans ? kw : gt * l.ncg;
  l.bsp = trans ? pad_pitch(gt * l.ncg) : pad_pitch(kw);
  l.yp = pad_pitch(gt * l.ncg);
  l.smem = ((size_t)kStages * tm * l.xp + (size_t)l.bs_rows * l.bsp +
            (size_t)tm * l.yp) * sizeof(bf16);
  return l;
}

// CTA (blockIdx.x = group tile * nch + column chunk, token chunk, row z).
// Warp w: group gl = w / wpg, output columns nb .. nb + 8 * NT of the
// group's chunk. tm tokens per tile (a multiple of 16), tpc per CTA.
template <int NT, int KT, bool TRANS>
__global__ void __launch_bounds__(kMaxThreads)
bdmm_tc_kernel(const bf16* __restrict__ blocks, const bf16* __restrict__ x,
               bf16* __restrict__ y, int n_tokens, int r, int bo, int bi,
               int gt, int wpg, int tm, int tpc, int nch, int xp, int bsp,
               int yp) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const int ncg = wpg * NT * 8;
  const int bs_rows = TRANS ? KT * 16 : gt * ncg;
  bf16* xs = reinterpret_cast<bf16*>(smraw);            // kStages x (tm, xp)
  bf16* bs = xs + (size_t)kStages * tm * xp;            // (bs_rows, bsp)
  bf16* ys = bs + (size_t)bs_rows * bsp;                // (tm, yp)

  const int z = blockIdx.z;
  const int gtile = blockIdx.x / nch, chunk = blockIdx.x - gtile * nch;
  const int g0 = gtile * gt, ng = min(gt, r - g0), n0 = chunk * ncg;
  const int nvalid = min(ncg, bo - n0);                 // a multiple of 8
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = warp / wpg, nb = (warp - gl * wpg) * NT * 8;
  const size_t din = (size_t)r * bi, dout = (size_t)r * bo;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // the CTA's blocks in their stored layout, zero outside them
  for (Cells e(bsp / 8); e.row < bs_rows; e.next()) {
    const int c = e.col * 8;
    uint4 v = zero4;
    if (!TRANS) {        // row gg * ncg + n (output column), col k
      const int gg = e.row / ncg, n = e.row - gg * ncg;
      if (gg < ng && n < nvalid && c < bi)
        v = *reinterpret_cast<const uint4*>(
            blocks + (((size_t)z * r + g0 + gg) * bo + n0 + n) * bi + c);
    } else {             // row k, col gg * ncg + n
      const int gg = c / ncg, n = c - gg * ncg;
      if (gg < ng && n < nvalid && e.row < bi)
        v = *reinterpret_cast<const uint4*>(
            blocks + (((size_t)z * r + g0 + gg) * bi + e.row) * bo + n0 + n);
    }
    *reinterpret_cast<uint4*>(bs + (size_t)e.row * bsp + c) = v;
  }
  // the ring's columns past the staged x (K padding of the last group)
  const int xw = gt * bi;
  if (xp > xw)
    for (Cells e(xp - xw); e.row < kStages * tm; e.next())
      xs[(size_t)e.row * xp + xw + e.col] = __float2bfloat16(0.f);
  __syncthreads();

  uint32_t bfr[NT][KT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
      const int l = lane & 15;
      if (!TRANS)
        ldsm_x2(bfr[nt][ks], bs + (size_t)(gl * ncg + nb + nt * 8 + (l & 7)) * bsp +
                                 ks * 16 + (l >> 3) * 8);
      else
        ldsm_x2_trans(bfr[nt][ks],
                      bs + (size_t)(ks * 16 + (l & 7) + (l >> 3) * 8) * bsp +
                          gl * ncg + nb + nt * 8);
    }
  }

  const int tbeg = blockIdx.y * tpc, tend = min(n_tokens, tbeg + tpc);
  const int ntile = (tend - tbeg + tm - 1) / tm;
  const bf16* xz = x + (size_t)z * n_tokens * din + (size_t)g0 * bi;
  bf16* yz = y + (size_t)z * n_tokens * dout + (size_t)g0 * bo + n0;
  const int xq = xw / 8, xq_valid = ng * bi / 8;

  auto issue = [&](int i) {
    if (i < ntile) {
      const int t0 = tbeg + i * tm, nv = min(tm, tend - t0);
      bf16* dst = xs + (size_t)(i % kStages) * tm * xp;
      for (Cells e(xq); e.row < tm; e.next()) {
        const bool ok = e.row < nv && e.col < xq_valid;
        cp_async16(dst + (size_t)e.row * xp + e.col * 8,
                   ok ? xz + (size_t)(t0 + e.row) * din + e.col * 8 : x, ok);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  const int cpg = nvalid / 8, cq = ng * cpg;   // 16-byte output chunks a row
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    issue(i + kStages - 1);
    const bf16* xt = xs + (size_t)(i % kStages) * tm * xp;
    for (int mt = 0; mt < tm / 16; ++mt) {
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, xt + (size_t)(mt * 16 + (lane & 15)) * xp + gl * bi +
                       ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[nt], a, bfr[nt][ks][0], bfr[nt][ks][1]);
      }
      const int row = mt * 16 + (lane >> 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = gl * ncg + nb + nt * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(ys + (size_t)row * yp + col) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(ys + (size_t)(row + 8) * yp + col) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();   // the output tile is complete
    const int t0 = tbeg + i * tm, nv = min(tm, tend - t0);
    for (Cells e(cq); e.row < nv; e.next()) {
      const int gg = e.col / cpg, c = (e.col - gg * cpg) * 8;
      *reinterpret_cast<uint4*>(yz + (size_t)(t0 + e.row) * dout +
                                (size_t)gg * bo + c) =
          *reinterpret_cast<const uint4*>(ys + (size_t)e.row * yp + gg * ncg + c);
    }
  }
  cp_async_wait<0>();
}

template <int NT, int KT, bool TRANS>
int launch_tc_nkt(const void* blocks, const void* x, void* y, int B,
                  int n_tokens, int r, int bo, int bi, int gt, int wpg, int tm,
                  int tpc, cudaStream_t stream) {
  auto kernel = bdmm_tc_kernel<NT, KT, TRANS>;
  const TcLayout l = tc_layout(KT, NT, gt, wpg, tm, bi, TRANS);
  const int nch = (bo + l.ncg - 1) / l.ncg;
  if (gt > 1 && nch > 1) return (int)cudaErrorInvalidValue;
  const size_t gx = ceil_div(r, gt) * nch, gy = ceil_div(n_tokens, tpc);
  if (!grid_ok(gx, gy, B)) return (int)cudaErrorInvalidValue;
  const int err = set_smem(kernel, l.smem);
  if (err != 0) return err;
  kernel<<<dim3((unsigned)gx, (unsigned)gy, B), gt * wpg * 32, l.smem,
           stream>>>((const bf16*)blocks, (const bf16*)x, (bf16*)y, n_tokens,
                     r, bo, bi, gt, wpg, tm, tpc, nch, l.xp, l.bsp, l.yp);
  return (int)cudaGetLastError();
}

template <int NT, bool TRANS>
int launch_tc_nt(int kt, const void* blocks, const void* x, void* y, int B,
                 int n_tokens, int r, int bo, int bi, int gt, int wpg, int tm,
                 int tpc, cudaStream_t stream) {
#define BDMM_TC_KT(K)                                                        \
  case K:                                                                    \
    if constexpr (NT * K <= 32)                                              \
      return launch_tc_nkt<NT, K, TRANS>(blocks, x, y, B, n_tokens, r, bo,   \
                                         bi, gt, wpg, tm, tpc, stream);      \
    return (int)cudaErrorInvalidValue;
  switch (kt) {
    BDMM_TC_KT(1)
    BDMM_TC_KT(2)
    BDMM_TC_KT(4)
    BDMM_TC_KT(8)
    BDMM_TC_KT(16)
    BDMM_TC_KT(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BDMM_TC_KT
}

int launch_tc(const void* blocks, const void* x, void* y, int B, int n_tokens,
              int r, int bo, int bi, int trans, int kt, int nt, int gt,
              int wpg, int tm, int tpc, void* stream_ptr) {
  if (B <= 0 || n_tokens <= 0 || r <= 0 || bo <= 0 || bi <= 0 || bo % 8 ||
      bi % 8 || kt * 16 < bi || gt <= 0 || wpg <= 0 || gt * wpg * 32 > kMaxThreads || tm <= 0 ||
      tm % 16 || tpc <= 0 || tpc % tm)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define BDMM_TC_NT(N)                                                          \
  if (nt == N)                                                                 \
    return trans ? launch_tc_nt<N, true>(kt, blocks, x, y, B, n_tokens, r, bo, \
                                         bi, gt, wpg, tm, tpc, stream)         \
                 : launch_tc_nt<N, false>(kt, blocks, x, y, B, n_tokens, r,    \
                                          bo, bi, gt, wpg, tm, tpc, stream);
  BDMM_TC_NT(4)
  BDMM_TC_NT(2)
  BDMM_TC_NT(1)
#undef BDMM_TC_NT
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bdmm at decode and short prefill (T < 16)
// ---------------------------------------------------------------------------

// One item per L = 2^lanes_log2 lanes: a block row (z, g, i) for blocks in
// their layout, or V output columns (z, g, c * V ..) for blocks read
// transposed. Threads past the last item compute on item 0 and store
// nothing, so every lane of a warp reaches the shuffles.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kDecThreads)
bdmm_decode_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
                   T* __restrict__ y, int B, int n_tokens, int r, int bo,
                   int bi, int lanes_log2) {
  constexpr int V = vec_elems<T>();
  const int L = 1 << lanes_log2;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int sub = threadIdx.x & (L - 1);
  const unsigned items = TRANS ? (unsigned)B * r * (bo / V) : (unsigned)B * r * bo;
  unsigned item = tid >> lanes_log2;
  const bool valid = item < items;
  if (!valid) item = 0;
  const size_t din = (size_t)r * bi, dout = (size_t)r * bo;
  if constexpr (!TRANS) {
    const unsigned zg = item / bo;
    const int i = (int)(item - zg * bo);
    const int z = (int)(zg / r), g = (int)(zg - (unsigned)z * r);
    const T* w = blocks + (size_t)item * bi;
    const T* xg = x + (size_t)z * n_tokens * din + (size_t)g * bi;
    for (int t0 = 0; t0 < n_tokens; t0 += kDecTokens) {
      float acc[kDecTokens];
#pragma unroll
      for (int u = 0; u < kDecTokens; ++u) acc[u] = 0.f;
      for (int j = sub * V; j < bi; j += L * V) {
        float wv[V];
        load16(w + j, wv);
#pragma unroll
        for (int u = 0; u < kDecTokens; ++u) {
          if (t0 + u < n_tokens) {
            float xv[V];
            load16(xg + (size_t)(t0 + u) * din + j, xv);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[u] += wv[v] * xv[v];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kDecTokens; ++u) {
        for (int o = L >> 1; o > 0; o >>= 1)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
        if (valid && sub == 0 && t0 + u < n_tokens)
          y[((size_t)z * n_tokens + t0 + u) * dout + (size_t)g * bo + i] =
              from_f32<T>(acc[u]);
      }
    }
  } else {
    const int cpr = bo / V;
    const unsigned zg = item / cpr;
    const int c = (int)(item - zg * cpr);
    const int z = (int)(zg / r), g = (int)(zg - (unsigned)z * r);
    const T* w = blocks + (size_t)zg * bi * bo + (size_t)c * V;  // row k: + k * bo
    const T* xg = x + (size_t)z * n_tokens * din + (size_t)g * bi;
    for (int t0 = 0; t0 < n_tokens; t0 += kDecTokens) {
      float acc[kDecTokens][V];
#pragma unroll
      for (int u = 0; u < kDecTokens; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[u][v] = 0.f;
#pragma unroll 4
      for (int k = sub; k < bi; k += L) {
        float wv[V];
        load16(w + (size_t)k * bo, wv);
#pragma unroll
        for (int u = 0; u < kDecTokens; ++u) {
          if (t0 + u < n_tokens) {
            const float xv = to_f32(xg[(size_t)(t0 + u) * din + k]);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[u][v] += xv * wv[v];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kDecTokens; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          for (int o = L >> 1; o > 0; o >>= 1)
            acc[u][v] += __shfl_xor_sync(0xffffffffu, acc[u][v], o);
        if (valid && sub == 0 && t0 + u < n_tokens)
          store16(y + ((size_t)z * n_tokens + t0 + u) * dout + (size_t)g * bo +
                      (size_t)c * V,
                  acc[u]);
      }
    }
  }
}

template <typename T>
int launch_decode(const void* blocks, const void* x, void* y, int B,
                  int n_tokens, int r, int bo, int bi, int trans,
                  int lanes_log2, void* stream_ptr) {
  constexpr int V = vec_elems<T>();
  if (B <= 0 || n_tokens <= 0 || r <= 0 || bo <= 0 || bi <= 0 ||
      lanes_log2 < 0 || lanes_log2 > 5 || (trans ? bo % V : bi % V))
    return (int)cudaErrorInvalidValue;
  const size_t items = trans ? (size_t)B * r * (bo / V) : (size_t)B * r * bo;
  const size_t gx = ceil_div(items << lanes_log2, kDecThreads);
  if (!grid_ok(gx, 1, 1) || gx * kDecThreads > 0xffffffffu)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (trans)
    bdmm_decode_kernel<T, true><<<(unsigned)gx, kDecThreads, 0, stream>>>(
        (const T*)blocks, (const T*)x, (T*)y, B, n_tokens, r, bo, bi,
        lanes_log2);
  else
    bdmm_decode_kernel<T, false><<<(unsigned)gx, kDecThreads, 0, stream>>>(
        (const T*)blocks, (const T*)x, (T*)y, B, n_tokens, r, bo, bi,
        lanes_log2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bdmm on the CUDA cores (f32; bf16 shapes the tensor-core and decode
// kernels refuse)
// ---------------------------------------------------------------------------

// Shared memory of bdmm_cc_kernel (kernels/bdmm.py _cc_smem mirrors it).
__host__ __device__ inline int cc_xpitch(int gt, int kc) { return (gt * kc + 7) / 8 * 8; }
__host__ __device__ inline size_t cc_wfloats(int gt, int nc, int kc) {
  return ((size_t)gt * nc * (kc + 1) + 3) / 4 * 4;
}
template <typename T>
size_t cc_smem(int gt, int nc, int kc, int tt) {
  return cc_wfloats(gt, nc, kc) * sizeof(float) +
         (size_t)kCcStages * tt * cc_xpitch(gt, kc) * sizeof(T);
}

// CTA (blockIdx.x = group tile * nch + column chunk, token chunk, row z):
// thread c owns output column n0 + c % nc of group g0 + c / nc and TT
// tokens' sums. K is looped in chunks of kc (one chunk: the blocks are
// staged once; gt > 1 only then).
template <typename T, bool TRANS, int TT, bool V4>
__global__ void __launch_bounds__(kMaxThreads)
bdmm_cc_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
               T* __restrict__ y, int n_tokens, int r, int bo, int bi, int gt,
               int nc, int kc, int tpc, int nch) {
  extern __shared__ __align__(16) unsigned char smraw[];
  constexpr int V = vec_elems<T>();
  const int wpitch = kc + 1, xp = cc_xpitch(gt, kc);
  float* ws = reinterpret_cast<float*>(smraw);                 // (gt * nc, kc + 1)
  T* xs = reinterpret_cast<T*>(ws + cc_wfloats(gt, nc, kc));   // stages x (TT, xp)
  const int z = blockIdx.z;
  const int gtile = blockIdx.x / nch, chunk = blockIdx.x - gtile * nch;
  const int g0 = gtile * gt, ng = min(gt, r - g0), n0 = chunk * nc;
  const int nk = (bi + kc - 1) / kc;
  const int c = threadIdx.x, gl = c / nc, n = c - gl * nc;
  const bool active = gl < ng && n0 + n < bo;
  const size_t din = (size_t)r * bi, dout = (size_t)r * bo;
  const bool vec = bi % V == 0 && kc % V == 0;

  auto stage_w = [&](int q) {
    const int k0 = q * kc;
    if (!TRANS) {
      for (Cells e(kc); e.row < gt * nc; e.next()) {   // row gg * nc + nn, col j
        const int gg = e.row / nc, nn = e.row - gg * nc, k = k0 + e.col;
        float v = 0.f;
        if (gg < ng && n0 + nn < bo && k < bi)
          v = to_f32(blocks[(((size_t)z * r + g0 + gg) * bo + n0 + nn) * bi + k]);
        ws[e.row * wpitch + e.col] = v;
      }
    } else {
      for (Cells e(nc); e.row < gt * kc; e.next()) {   // row gg * kc + j, col nn
        const int gg = e.row / kc, j = e.row - gg * kc, k = k0 + j;
        float v = 0.f;
        if (gg < ng && n0 + e.col < bo && k < bi)
          v = to_f32(blocks[(((size_t)z * r + g0 + gg) * bi + k) * bo + n0 + e.col]);
        ws[(gg * nc + e.col) * wpitch + j] = v;
      }
    }
  };

  const int tbeg = blockIdx.y * tpc, tend = min(n_tokens, tbeg + tpc);
  const int ntile = (tend - tbeg + TT - 1) / TT, nsteps = ntile * nk;
  const T* xz = x + (size_t)z * n_tokens * din + (size_t)g0 * bi;

  auto stage_x = [&](int s) {
    if (s < nsteps) {
      const int i = s / nk, q = s - i * nk;
      const int t0 = tbeg + i * TT, nv = min(TT, tend - t0);
      const int k0 = q * kc, w = nk == 1 ? ng * bi : min(kc, bi - k0);
      T* dst = xs + (size_t)(s % kCcStages) * TT * xp;
      if (vec) {
        for (Cells e(w / V); e.row < TT; e.next()) {
          const bool ok = e.row < nv;
          cp_async16(dst + e.row * xp + e.col * V,
                     ok ? xz + (size_t)(t0 + e.row) * din + k0 + e.col * V : x,
                     ok);
        }
      } else {
        for (Cells e(w); e.row < TT; e.next())
          dst[e.row * xp + e.col] =
              e.row < nv ? xz[(size_t)(t0 + e.row) * din + k0 + e.col]
                         : from_f32<T>(0.f);
      }
    }
    cp_async_commit();
  };

  if (nk == 1) stage_w(0);
  stage_x(0);
  float acc[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) acc[t] = 0.f;
  for (int s = 0; s < nsteps; ++s) {
    const int i = s / nk, q = s - i * nk;
    cp_async_wait<0>();
    __syncthreads();   // step s staged; every thread is done with step s - 1
    if (nk > 1) stage_w(q);
    stage_x(s + 1);
    if (nk > 1) __syncthreads();
    const int kcur = min(kc, bi - q * kc);
    if (active) {
      const T* xb = xs + (size_t)(s % kCcStages) * TT * xp + gl * kc;
      const float* wr = ws + c * wpitch;
      if constexpr (V4) {
#pragma unroll 2
        for (int j = 0; j < kcur; j += 4) {
          const float w0 = wr[j], w1 = wr[j + 1], w2 = wr[j + 2], w3 = wr[j + 3];
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            const float4 v = *reinterpret_cast<const float4*>(xb + t * xp + j);
            acc[t] += w0 * v.x;
            acc[t] += w1 * v.y;
            acc[t] += w2 * v.z;
            acc[t] += w3 * v.w;
          }
        }
      } else {
#pragma unroll 4
        for (int j = 0; j < kcur; ++j) {
          const float w = wr[j];
#pragma unroll
          for (int t = 0; t < TT; ++t) acc[t] += w * to_f32(xb[t * xp + j]);
        }
      }
    }
    if (q == nk - 1) {
      const int t0 = tbeg + i * TT;
      if (active) {
        T* yc = y + ((size_t)z * n_tokens + t0) * dout + (size_t)(g0 + gl) * bo + n0 + n;
#pragma unroll
        for (int t = 0; t < TT; ++t)
          if (t0 + t < tend) yc[(size_t)t * dout] = from_f32<T>(acc[t]);
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = 0.f;
    }
  }
  cp_async_wait<0>();
}

template <typename T, bool TRANS, int TT>
int launch_cc_tt(const void* blocks, const void* x, void* y, int B,
                 int n_tokens, int r, int bo, int bi, int gt, int nc, int kc,
                 int tpc, cudaStream_t stream) {
  const int nch = (bo + nc - 1) / nc;
  const size_t gx = ceil_div(r, gt) * nch, gy = ceil_div(n_tokens, tpc);
  if (!grid_ok(gx, gy, B)) return (int)cudaErrorInvalidValue;
  const size_t smem = cc_smem<T>(gt, nc, kc, TT);
  const int threads = (gt * nc + 31) / 32 * 32;
  const dim3 grid((unsigned)gx, (unsigned)gy, B);
  auto run = [&](auto kernel) {
    const int err = set_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<grid, threads, smem, stream>>>((const T*)blocks, (const T*)x,
                                            (T*)y, n_tokens, r, bo, bi, gt, nc,
                                            kc, tpc, nch);
    return (int)cudaGetLastError();
  };
  if constexpr (sizeof(T) == 4)   // float4 reads of the staged x
    if (bi % 4 == 0 && kc % 4 == 0) return run(bdmm_cc_kernel<T, TRANS, TT, true>);
  return run(bdmm_cc_kernel<T, TRANS, TT, false>);
}

template <typename T>
int launch_cc(const void* blocks, const void* x, void* y, int B, int n_tokens,
              int r, int bo, int bi, int trans, int gt, int nc, int kc,
              int tt, int tpc, void* stream_ptr) {
  if (B <= 0 || n_tokens <= 0 || r <= 0 || bo <= 0 || bi <= 0 || gt <= 0 ||
      nc <= 0 || nc > bo || kc <= 0 || kc > bi || gt * nc > kMaxThreads ||
      (gt > 1 && (kc < bi || nc < bo)) || tpc <= 0 || tpc % tt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
#define BDMM_CC_TT(TT)                                                       \
  if (tt == TT)                                                              \
    return trans ? launch_cc_tt<T, true, TT>(blocks, x, y, B, n_tokens, r,   \
                                             bo, bi, gt, nc, kc, tpc, s)     \
                 : launch_cc_tt<T, false, TT>(blocks, x, y, B, n_tokens, r,  \
                                              bo, bi, gt, nc, kc, tpc, s);
  BDMM_CC_TT(8)
  BDMM_CC_TT(32)
#undef BDMM_CC_TT
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bdmm_dblocks
// ---------------------------------------------------------------------------

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

// The splits' partial sums (in part) added into out, when there are several.
int sum_splits(float* part, float* out, size_t n_out, int splits,
               cudaStream_t stream) {
  if (splits == 1) return 0;
  const size_t want = (n_out + 255) / 256;
  const unsigned nb = (unsigned)(want < 4096 ? want : 4096);
  bdmm_sum_kernel<<<nb, 256, 0, stream>>>(part, out, n_out, splits);
  return (int)cudaGetLastError();
}

// Shared memory of bdmm_dblocks_tc_kernel (kernels/bdmm.py _db_tc_smem).
__host__ __device__ inline int db_tc_pitch(int gt, int b, int w) { return pad_pitch((gt - 1) * b + 32 * w); }
inline size_t db_tc_smem(int gt, int bo, int bi, int wm, int wn, int tk) {
  return (size_t)kStages * tk *
         (db_tc_pitch(gt, bo, wm) + db_tc_pitch(gt, bi, wn)) * sizeof(bf16);
}

// CTA (blockIdx.x = group tile * (nti * ntj) + output tile, split, row z):
// gt groups x (wm x wn) warps, each warp a 32 x 32 tile of one group's
// dblocks at (i0 + 32 wmi, j0 + 32 wnj); tokens [s * tps, (s + 1) * tps)
// in tiles of tk (a multiple of 16), into out + s * split_stride.
__global__ void __launch_bounds__(kMaxThreads)
bdmm_dblocks_tc_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                       float* __restrict__ out, size_t split_stride,
                       int n_tokens, int r, int bo, int bi, int gt, int wm,
                       int wn, int tk, int tps, int nti, int ntj) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const int pdy = db_tc_pitch(gt, bo, wm), px = db_tc_pitch(gt, bi, wn);
  bf16* sdy = reinterpret_cast<bf16*>(smraw);           // kStages x (tk, pdy)
  bf16* sx = sdy + (size_t)kStages * tk * pdy;          // kStages x (tk, px)
  const int z = blockIdx.z, s = blockIdx.y;
  const int per = nti * ntj, gtile = blockIdx.x / per;
  const int tile = blockIdx.x - gtile * per, ti = tile / ntj, tj = tile - ti * ntj;
  const int g0 = gtile * gt, ng = min(gt, r - g0);
  const int i0 = ti * 32 * wm, j0 = tj * 32 * wn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = warp / (wm * wn), wr = warp - gl * wm * wn;
  const int wmi = wr / wn, wnj = wr - wmi * wn;
  const size_t ddy = (size_t)r * bo, dxw = (size_t)r * bi;
  // staged columns: [g0 * bo + i0, + vdy) of dy, [g0 * bi + j0, + vx) of x
  const int vdy = gt > 1 ? ng * bo : min(32 * wm, bo - i0);
  const int vx = gt > 1 ? ng * bi : min(32 * wn, bi - j0);
  const bf16* dyz = dy + (size_t)z * n_tokens * ddy + (size_t)g0 * bo + i0;
  const bf16* xz = x + (size_t)z * n_tokens * dxw + (size_t)g0 * bi + j0;

  // columns no copy writes: zero, once
  if (pdy > vdy)
    for (Cells e(pdy - vdy); e.row < kStages * tk; e.next())
      sdy[(size_t)e.row * pdy + vdy + e.col] = __float2bfloat16(0.f);
  if (px > vx)
    for (Cells e(px - vx); e.row < kStages * tk; e.next())
      sx[(size_t)e.row * px + vx + e.col] = __float2bfloat16(0.f);

  const int tbeg = s * tps, tend = min(n_tokens, tbeg + tps);
  const int ntile = (tend - tbeg + tk - 1) / tk;
  auto issue = [&](int i) {
    if (i < ntile) {
      const int t0 = tbeg + i * tk, nv = min(tk, tend - t0);
      bf16* ddst = sdy + (size_t)(i % kStages) * tk * pdy;
      bf16* xdst = sx + (size_t)(i % kStages) * tk * px;
      for (Cells e(vdy / 8); e.row < tk; e.next()) {
        const bool ok = e.row < nv;
        cp_async16(ddst + (size_t)e.row * pdy + e.col * 8,
                   ok ? dyz + (size_t)(t0 + e.row) * ddy + e.col * 8 : dy, ok);
      }
      for (Cells e(vx / 8); e.row < tk; e.next()) {
        const bool ok = e.row < nv;
        cp_async16(xdst + (size_t)e.row * px + e.col * 8,
                   ok ? xz + (size_t)(t0 + e.row) * dxw + e.col * 8 : x, ok);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;
  const int acol = gl * bo + 32 * wmi, bcol = gl * bi + 32 * wnj;

  for (int st = 0; st < kStages - 1; ++st) issue(st);
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    issue(i + kStages - 1);
    const bf16* at = sdy + (size_t)(i % kStages) * tk * pdy;
    const bf16* bt = sx + (size_t)(i % kStages) * tk * px;
    for (int ks = 0; ks < tk / 16; ++ks) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_trans(a[mi], at + (size_t)(ks * 16 + (lane & 7) + (lane >> 4) * 8) * pdy +
                                 acol + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_trans(b[nj], bt + (size_t)(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * px +
                                 bcol + nj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_16816(acc[mi][nj], a[mi], b[nj >> 1][(nj & 1) * 2],
                    b[nj >> 1][(nj & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  if (gl < ng) {
    float* o = out + s * split_stride + ((size_t)z * r + g0 + gl) * bo * bi;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + 32 * wmi + mi * 16 + (lane >> 2) + 8 * h;
          const int j = j0 + 32 * wnj + nj * 8 + 2 * (lane & 3);
          if (i < bo && j < bi)
            *reinterpret_cast<float2*>(o + (size_t)i * bi + j) =
                make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
        }
  }
}

int launch_dblocks_tc(const void* dy, const void* x, float* part, float* out,
                      int B, int n_tokens, int r, int bo, int bi, int gt,
                      int wm, int wn, int tk, int splits, int tps,
                      void* stream_ptr) {
  if (B <= 0 || n_tokens <= 0 || r <= 0 || bo <= 0 || bi <= 0 || bo % 8 ||
      bi % 8 || gt <= 0 || wm <= 0 || wn <= 0 ||
      gt * wm * wn * 32 > kMaxThreads || tk <= 0 || tk % 16 || splits <= 0 ||
      tps <= 0 || tps % tk || (long long)splits * tps < n_tokens ||
      (gt > 1 && (bo > 32 * wm || bi > 32 * wn)))
    return (int)cudaErrorInvalidValue;
  const int nti = (bo + 32 * wm - 1) / (32 * wm), ntj = (bi + 32 * wn - 1) / (32 * wn);
  const size_t gx = ceil_div(r, gt) * nti * ntj;
  if (!grid_ok(gx, splits, B)) return (int)cudaErrorInvalidValue;
  const size_t smem = db_tc_smem(gt, bo, bi, wm, wn, tk);
  int err = set_smem(bdmm_dblocks_tc_kernel, smem);
  if (err != 0) return err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t n_out = (size_t)B * r * bo * bi;
  float* outp = splits > 1 ? part : out;
  bdmm_dblocks_tc_kernel<<<dim3((unsigned)gx, splits, B), gt * wm * wn * 32,
                           smem, stream>>>((const bf16*)dy, (const bf16*)x,
                                           outp, n_out, n_tokens, r, bo, bi,
                                           gt, wm, wn, tk, tps, nti, ntj);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return sum_splits(part, out, n_out, splits, stream);
}

// Shared memory of bdmm_dblocks_cc_kernel (kernels/bdmm.py _db_cc_smem).
__host__ __device__ inline int db_cc_pitch(int gt, int b, int m) {
  return ((gt - 1) * b + (m + 3) / 4 * 4 + 7) / 8 * 8;
}
template <typename T>
size_t db_cc_smem(int gt, int bo, int bi, int mi, int nj) {
  return (size_t)kCcStages * kDbCcTokens *
         (db_cc_pitch(gt, bo, mi) + db_cc_pitch(gt, bi, nj)) * sizeof(T);
}

// CTA (blockIdx.x = group tile * (nti * ntj) + output tile, split, row z):
// gt groups x an (mi x nj) tile of each group's dblocks at (i0, j0), one
// 4 x 4 sub-tile per thread; tokens [s * tps, (s + 1) * tps).
template <typename T, bool V4>
__global__ void __launch_bounds__(kMaxThreads)
bdmm_dblocks_cc_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                       float* __restrict__ out, size_t split_stride,
                       int n_tokens, int r, int bo, int bi, int gt, int mi,
                       int nj, int tps, int nti, int ntj) {
  extern __shared__ __align__(16) unsigned char smraw[];
  constexpr int TK = kDbCcTokens, V = vec_elems<T>();
  const int pdy = db_cc_pitch(gt, bo, mi), px = db_cc_pitch(gt, bi, nj);
  T* sdy = reinterpret_cast<T*>(smraw);                 // stages x (TK, pdy)
  T* sx = sdy + (size_t)kCcStages * TK * pdy;           // stages x (TK, px)
  const int z = blockIdx.z, s = blockIdx.y;
  const int per = nti * ntj, gtile = blockIdx.x / per;
  const int tile = blockIdx.x - gtile * per, ti = tile / ntj, tj = tile - ti * ntj;
  const int g0 = gtile * gt, ng = min(gt, r - g0);
  const int i0 = ti * mi, j0 = tj * nj;
  const int n4j = (nj + 3) / 4, tiles_g = (mi + 3) / 4 * n4j;
  const int gl = threadIdx.x / tiles_g, rem = threadIdx.x - gl * tiles_g;
  const int ii = 4 * (rem / n4j), jj = 4 * (rem - (rem / n4j) * n4j);
  const bool act = gl < ng && i0 + ii < bo && ii < mi && j0 + jj < bi && jj < nj;
  const size_t ddy = (size_t)r * bo, dxw = (size_t)r * bi;
  const int vdy = gt > 1 ? ng * bo : min(mi, bo - i0);
  const int vx = gt > 1 ? ng * bi : min(nj, bi - j0);
  const T* dyz = dy + (size_t)z * n_tokens * ddy + (size_t)g0 * bo + i0;
  const T* xz = x + (size_t)z * n_tokens * dxw + (size_t)g0 * bi + j0;
  const bool vdy16 = (g0 * bo + i0) % V == 0 && vdy % V == 0 && ddy % V == 0;
  const bool vx16 = (g0 * bi + j0) % V == 0 && vx % V == 0 && dxw % V == 0;

  if (pdy > vdy)
    for (Cells e(pdy - vdy); e.row < kCcStages * TK; e.next())
      sdy[(size_t)e.row * pdy + vdy + e.col] = from_f32<T>(0.f);
  if (px > vx)
    for (Cells e(px - vx); e.row < kCcStages * TK; e.next())
      sx[(size_t)e.row * px + vx + e.col] = from_f32<T>(0.f);

  const int tbeg = s * tps, tend = min(n_tokens, tbeg + tps);
  const int ntile = (tend - tbeg + TK - 1) / TK;
  auto stage = [&](T* dst, int pitch, const T* src, size_t sp, int w, bool v16,
                   int t0, int nv) {
    if (v16) {
      for (Cells e(w / V); e.row < TK; e.next()) {
        const bool ok = e.row < nv;
        cp_async16(dst + (size_t)e.row * pitch + e.col * V,
                   ok ? src + (size_t)(t0 + e.row) * sp + e.col * V : src, ok);
      }
    } else {
      for (Cells e(w); e.row < TK; e.next())
        dst[(size_t)e.row * pitch + e.col] =
            e.row < nv ? src[(size_t)(t0 + e.row) * sp + e.col] : from_f32<T>(0.f);
    }
  };
  auto issue = [&](int i) {
    if (i < ntile) {
      const int t0 = tbeg + i * TK, nv = min(TK, tend - t0);
      stage(sdy + (size_t)(i % kCcStages) * TK * pdy, pdy, dyz, ddy, vdy, vdy16, t0, nv);
      stage(sx + (size_t)(i % kCcStages) * TK * px, px, xz, dxw, vx, vx16, t0, nv);
    }
    cp_async_commit();
  };

  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  const int ac = gl * bo + ii, bc = gl * bi + jj;
  issue(0);
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // tile i staged; every thread is done with tile i - 1
    issue(i + 1);
    if (act) {
      const T* at = sdy + (size_t)(i % kCcStages) * TK * pdy + ac;
      const T* bt = sx + (size_t)(i % kCcStages) * TK * px + bc;
#pragma unroll 4
      for (int t = 0; t < TK; ++t) {
        float av[4], bv[4];
        if constexpr (V4) {
          const float4 a = *reinterpret_cast<const float4*>(at + (size_t)t * pdy);
          const float4 b = *reinterpret_cast<const float4*>(bt + (size_t)t * px);
          av[0] = a.x; av[1] = a.y; av[2] = a.z; av[3] = a.w;
          bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            av[u] = to_f32(at[(size_t)t * pdy + u]);
            bv[u] = to_f32(bt[(size_t)t * px + u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u * 4 + v] += av[u] * bv[v];
      }
    }
  }
  cp_async_wait<0>();

  if (act) {
    float* o = out + s * split_stride + ((size_t)z * r + g0 + gl) * bo * bi;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int a = ii + e / 4, b = jj + e % 4;
      if (a < mi && i0 + a < bo && b < nj && j0 + b < bi)
        o[(size_t)(i0 + a) * bi + j0 + b] = acc[e];
    }
  }
}

template <typename T>
int launch_dblocks_cc(const void* dy, const void* x, float* part, float* out,
                      int B, int n_tokens, int r, int bo, int bi, int gt,
                      int mi, int nj, int splits, int tps, void* stream_ptr) {
  if (B <= 0 || n_tokens <= 0 || r <= 0 || bo <= 0 || bi <= 0 || gt <= 0 ||
      mi <= 0 || mi > bo || nj <= 0 || nj > bi ||
      (gt > 1 && (mi < bo || nj < bi)) || splits <= 0 || tps <= 0 ||
      tps % kDbCcTokens || (long long)splits * tps < n_tokens)
    return (int)cudaErrorInvalidValue;
  const int tiles = gt * ((mi + 3) / 4) * ((nj + 3) / 4);
  if (tiles > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int threads = (tiles + 31) / 32 * 32;
  const int nti = (bo + mi - 1) / mi, ntj = (bi + nj - 1) / nj;
  const size_t gx = ceil_div(r, gt) * nti * ntj;
  if (!grid_ok(gx, splits, B)) return (int)cudaErrorInvalidValue;
  const size_t smem = db_cc_smem<T>(gt, bo, bi, mi, nj);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t n_out = (size_t)B * r * bo * bi;
  float* outp = splits > 1 ? part : out;
  const dim3 grid((unsigned)gx, splits, B);
  auto run = [&](auto kernel) {
    int err = set_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<grid, threads, smem, stream>>>((const T*)dy, (const T*)x, outp,
                                            n_out, n_tokens, r, bo, bi, gt, mi,
                                            nj, tps, nti, ntj);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    return sum_splits(part, out, n_out, splits, stream);
  };
  if constexpr (sizeof(T) == 4)   // float4 reads of the staged tiles
    if (bo % 4 == 0 && bi % 4 == 0) return run(bdmm_dblocks_cc_kernel<T, true>);
  return run(bdmm_dblocks_cc_kernel<T, false>);
}

}  // namespace gs

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// bdmm: blocks, x, y, B, T, r, bo, bi (of the product: blocks^T's when
// trans), trans, then the route's geometry, then the stream.
int bdmm_tc_bf16(const void* blocks, const void* x, void* y, int B, int n_tokens,
                 int r, int bo, int bi, int trans, int kt, int nt, int gt,
                 int wpg, int tm, int tpc, void* stream) {
  return gs::launch_tc(blocks, x, y, B, n_tokens, r, bo, bi, trans, kt, nt, gt,
                       wpg, tm, tpc, stream);
}

int bdmm_decode_f32(const void* blocks, const void* x, void* y, int B,
                    int n_tokens, int r, int bo, int bi, int trans,
                    int lanes_log2, void* stream) {
  return gs::launch_decode<float>(blocks, x, y, B, n_tokens, r, bo, bi, trans,
                                  lanes_log2, stream);
}

int bdmm_decode_bf16(const void* blocks, const void* x, void* y, int B,
                     int n_tokens, int r, int bo, int bi, int trans,
                     int lanes_log2, void* stream) {
  return gs::launch_decode<__nv_bfloat16>(blocks, x, y, B, n_tokens, r, bo, bi,
                                          trans, lanes_log2, stream);
}

int bdmm_cc_f32(const void* blocks, const void* x, void* y, int B, int n_tokens,
                int r, int bo, int bi, int trans, int gt, int nc, int kc,
                int tt, int tpc, void* stream) {
  return gs::launch_cc<float>(blocks, x, y, B, n_tokens, r, bo, bi, trans, gt,
                              nc, kc, tt, tpc, stream);
}

int bdmm_cc_bf16(const void* blocks, const void* x, void* y, int B, int n_tokens,
                 int r, int bo, int bi, int trans, int gt, int nc, int kc,
                 int tt, int tpc, void* stream) {
  return gs::launch_cc<__nv_bfloat16>(blocks, x, y, B, n_tokens, r, bo, bi,
                                      trans, gt, nc, kc, tt, tpc, stream);
}

// bdmm_dblocks: dy, x, partial sums (splits x B x r x bo x bi floats when
// splits > 1), dblocks, B, T, r, bo, bi, then the route's geometry (ending
// in splits and tokens per split), then the stream.
int bdmm_dblocks_tc_bf16(const void* dy, const void* x, float* part,
                         float* out, int B, int n_tokens, int r, int bo,
                         int bi, int gt, int wm, int wn, int tk, int splits,
                         int tps, void* stream) {
  return gs::launch_dblocks_tc(dy, x, part, out, B, n_tokens, r, bo, bi, gt,
                               wm, wn, tk, splits, tps, stream);
}

int bdmm_dblocks_cc_f32(const void* dy, const void* x, float* part, float* out,
                        int B, int n_tokens, int r, int bo, int bi, int gt,
                        int mi, int nj, int splits, int tps, void* stream) {
  return gs::launch_dblocks_cc<float>(dy, x, part, out, B, n_tokens, r, bo, bi,
                                      gt, mi, nj, splits, tps, stream);
}

int bdmm_dblocks_cc_bf16(const void* dy, const void* x, float* part, float* out,
                         int B, int n_tokens, int r, int bo, int bi, int gt,
                         int mi, int nj, int splits, int tps, void* stream) {
  return gs::launch_dblocks_cc<__nv_bfloat16>(dy, x, part, out, B, n_tokens, r,
                                              bo, bi, gt, mi, nj, splits, tps,
                                              stream);
}

}  // extern "C"
