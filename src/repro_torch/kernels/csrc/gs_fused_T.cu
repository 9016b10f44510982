// Transpose GSOFT rotation for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gs_fused.py
// gs_fused_T_pallas (_gs_fused_T_kernel) and its per-row vmap
// ops.gs_banked_transform_T:  y[i] = R_i^T P^T L_i^T P x[i]  (= x[i] Q_i)
// with Q = P^T L P R, P = P_(r, d) the GS shuffle, L and R block-diagonal with
// r blocks of b x b, d = r * b. x (B, T, d), per-row L and R (B, r, b, b),
// y (B, T, d), contiguous, bf16 or f32; sums in fp32.
//
// Design. One tile of TT tokens of one row per CTA (or per cluster, below);
// TT is a power of two with TT * d <= 32768 (TT = 4 at d = 8192, 1 at
// d = 29568). The tile goes from device memory into shared memory once, as
// fp32 and already shuffled by P. Each of the 1024 threads owns up to 32 / TT
// feature columns of all TT tokens and keeps their fp32 sums in registers: a
// factor element is loaded once (coalesced across the warp) and feeds TT
// multiply-adds. Stage 1 (L^T) overwrites the tile in place after one
// barrier; stage 2 (R^T) reads that intermediate at its P^T-shuffled position
// -- index math on shared memory -- and writes y. The intermediate never goes
// to device memory, the point of the TPU kernel. One fp32 tile (not an input
// and an output tile) is what lets d = 29568 fit: 118 KB of dynamic shared
// memory at TT = 1.
//
// What bounds it on the H100: at decode (T = 1 per row) the kernel must read
// the row's factors, 2 * d * b elements (1 MB in bf16 at d = 8192, b = 32),
// against 2 * d for x and y. When the split grid fits in one wave of SMs the
// wrapper splits every tile over a cluster of 8 CTAs: each reads 1/8 of the
// factors, and the CTAs exchange the intermediate over distributed shared
// memory, so it still stays on chip.

#include "gs_common.cuh"

namespace gs {

constexpr int kCluster = 8;        // CTAs sharing one tile in the split kernel

// y = R^T P^T L^T P x for every token of the tile (TT tokens per tile).
//
// A tile is shared by a cluster of C CTAs (C = 1: no cluster). Each CTA holds
// the whole tile in its shared memory, computes 1/C of the feature columns of
// each stage (so it reads 1/C of the factors), and after stage 1 gathers the
// other CTAs' columns of the intermediate over distributed shared memory. At
// decode this spreads each row's factor read over C SMs; the intermediate
// still never leaves the chip.
template <typename T, int TT, int C>
__global__ void __launch_bounds__(kThreads, 1)
gs_fused_T_kernel(const T* __restrict__ x, const T* __restrict__ Lf,
                  const T* __restrict__ Rf, T* __restrict__ y,
                  int n_tokens, int r, int b) {
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
  const T* Lr = Lf + (size_t)row * r * b * b;
  const T* Rr = Rf + (size_t)row * r * b * b;

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

template <typename T, int TT>
int launch_T(const void* x, const void* L, const void* R, void* y, int B,
             int n_tokens, int r, int b, int cluster, cudaStream_t stream) {
  const size_t smem = (size_t)TT * r * b * sizeof(float);
  const unsigned tiles = (n_tokens + TT - 1) / TT;
  if (cluster == kCluster)
    return (int)launch_kernel<decltype(&gs_fused_T_kernel<T, TT, kCluster>), T>(
        gs_fused_T_kernel<T, TT, kCluster>, kCluster, dim3(tiles * kCluster, B),
        smem, stream, x, L, R, y, n_tokens, r, b);
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  return (int)launch_kernel<decltype(&gs_fused_T_kernel<T, TT, 1>), T>(
      gs_fused_T_kernel<T, TT, 1>, 1, dim3(tiles, B), smem, stream, x, L, R, y,
      n_tokens, r, b);
}

template <typename T>
int launch(const void* x, const void* L, const void* R, void* y, int B,
           int n_tokens, int r, int b, int tt, int cluster, void* stream) {
  if (bad_shape(B, n_tokens, r, b, tt)) return (int)cudaErrorInvalidValue;
  GS_DISPATCH_TT(tt, (launch_T<T, TT>(x, L, R, y, B, n_tokens, r, b, cluster,
                                      (cudaStream_t)stream)))
}

}  // namespace gs

extern "C" {

int gs_max_tile_elems() { return gs::kMaxTileElems; }

int gs_cluster_size() { return gs::kCluster; }

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gs_fused_T_f32(const void* x, const void* L, const void* R, void* y, int B,
                   int n_tokens, int r, int b, int tt, int cluster,
                   void* stream) {
  return gs::launch<float>(x, L, R, y, B, n_tokens, r, b, tt, cluster, stream);
}

int gs_fused_T_bf16(const void* x, const void* L, const void* R, void* y, int B,
                    int n_tokens, int r, int b, int tt, int cluster,
                    void* stream) {
  return gs::launch<__nv_bfloat16>(x, L, R, y, B, n_tokens, r, b, tt, cluster,
                                   stream);
}

}  // extern "C"
