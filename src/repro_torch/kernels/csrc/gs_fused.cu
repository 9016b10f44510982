// Forward GSOFT rotation for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gs_fused.py gs_fused_pallas
// (_gs_fused_kernel):  y[i] = P^T L_i P R_i x[i]  (= Q_i x[i]), used by the
// offline merge on the columns of W. Same layout, types and register-tiled
// design as gs_fused_T.cu (one tile of TT tokens per CTA, the fp32 tile and
// the intermediate in shared memory, never in device memory); it takes the
// TRANSPOSED factors L^T, R^T (the wrapper passes them) so that its block
// products read the factors coalesced the same way.
//
// What bounds it on the H100: the merge slabs are large (T = d_out tokens),
// and every tile re-reads the row's factors from L2, TT tokens at a time, so
// at b = 128 the factor traffic dominates; tensor cores for b >= 16 and
// larger tiles are later work.

#include "gs_common.cuh"

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

}  // namespace gs

extern "C" {

int gs_max_tile_elems() { return gs::kMaxTileElems; }

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gs_fused_f32(const void* x, const void* LT, const void* RT, void* y, int B,
                 int n_tokens, int r, int b, int tt, void* stream) {
  return gs::launch<float>(x, LT, RT, y, B, n_tokens, r, b, tt, stream);
}

int gs_fused_bf16(const void* x, const void* LT, const void* RT, void* y, int B,
                  int n_tokens, int r, int b, int tt, void* stream) {
  return gs::launch<__nv_bfloat16>(x, LT, RT, y, B, n_tokens, r, b, tt, stream);
}

}  // extern "C"
