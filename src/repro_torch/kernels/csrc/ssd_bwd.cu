// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces no TPU kernel: the JAX package trains the Mamba2 families by
// autodiff of its plain chunked scan (src/repro/kernels/ref.py
// ssd_chunked_ref; ops.ssd's use_pallas is off for training) and its Pallas
// kernel src/repro/kernels/ssd.py ssd_pallas has no VJP. The port runs the
// forward kernel (csrc/ssd.cu) on the card, so its gradient is a kernel too.
//
// For every (row, head), with the recurrence S_t = exp(loga_t) S_{t-1} +
// B_t x_t^T, y_t = C_t^T S_t, and inside a chunk of Q steps cum the
// inclusive sum of loga, total its last entry, L_ts = exp(cum_t - cum_s)
// for s <= t (else 0), G = (C B^T) o L, D = dy x^T, M = D o L,
// ecum = exp(cum), wdec = exp(total - cum), S_in the chunk's start state
// (written by the forward kernel) and dS_out the gradient of its end state:
//   dx    = G^T dy + wdec o (B dS_out)
//   dB    = M^T C  + (wdec o x) dS_out^T
//   dC    = M B    + (ecum o dy) S_in^T
//   dS_in = exp(total) dS_out + (C o ecum)^T dy       (handed to chunk - 1)
//   dcum_t = sum_s (G o D)_ts - sum_s (G o D)_st
//            + ecum_t <dy_t, (C S_in)_t> - wdec_t <x_t, (B dS_out)_t>
//   dcum_{Q-1} += exp(total) <S_in, dS_out> + sum_t wdec_t <x_t, (B dS_out)_t>
//   dloga = the reverse cumulative sum of dcum inside the chunk.
// All in fp32, inputs and dy read in their dtype (bf16 or f32), outputs
// rounded once to it.
//
// What bounds it on the H100: operations at the fp32 rate (five Q x Q or
// Q x N products a chunk against a few KB of traffic), and the reverse
// chain of state gradients: chunk c needs dS_in of chunk c + 1.
//
// Design, modelled on csrc/ssd.cu: every (row, head, chunk) is one CTA (a
// "unit"), all chunks of a head at once. A unit stages its chunk, computes
// everything that does not need dS_out (G, D, the dcum terms of the scores
// and of S_in, dC whole, and its share (C o ecum)^T dy of dS_in, written to
// its own slot), then waits for chunk c + 1's flag, adds exp(total) dS_out to
// its slot and releases its own flag, and last forms the terms that read
// dS_out (dx, dB, the dcum terms of the end state) and dloga. Each chunk
// has a slot of its own in device memory (no slot is reused inside a
// launch, so no unit writes a slot another may still read); the flags, the
// ticket counter and the epoch scheme are the forward's: tickets run in
// reverse chunk order (every chain's last chunk first), so a unit only
// waits on a unit with a smaller ticket, already running or done. Every
// sum is in a fixed order (no atomics in any sum): reruns are bit-identical.
// The products run on the tensor cores at fp32 accuracy, 3xTF32 mma.sync
// m16n8k8 as in the forward, through one generic warp-tile loop whose
// operands are read element by element from shared memory (the states
// from device memory): a simple kernel, not yet a fast one (no TMA, no
// wgmma, fragments not reused across tiles). N up to 256, P up to 64 (the
// whole head in one unit: dB and dC sum over P), any T (the last chunk
// padded with loga = 0 and x = B = C = dy = 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd_bwd {

constexpr int kQ = 64;                 // steps per chunk (the forward's)
constexpr int kMaxP = 64;
constexpr int kMaxN = 256;
constexpr int kMaxSmem = 232448;       // bytes a CTA may use on sm_90
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared-memory layout in floats: C and B (kQ x cp), x, dy and Z (kQ x pp),
// G and M (kQ x gp), then cum, ecum, wdec, dcum, the column sums and u, and
// a kThreads reduction row.
struct Layout {
  int np, cp, pp, gp;
  size_t c, b, x, dy, z, g, m, cum, ecum, wdec, dcum, csum, u, red, total;
  __host__ __device__ Layout(int N, int P) {
    np = (N + 15) / 16 * 16;
    cp = np + 4;
    pp = (P + 7) / 8 * 8 + 4;
    gp = kQ + 4;
    size_t o = 0;
    c = o;    o += (size_t)kQ * cp;
    b = o;    o += (size_t)kQ * cp;
    x = o;    o += (size_t)kQ * pp;
    dy = o;   o += (size_t)kQ * pp;
    z = o;    o += (size_t)kQ * pp;
    g = o;    o += (size_t)kQ * gp;
    m = o;    o += (size_t)kQ * gp;
    cum = o;  o += kQ;
    ecum = o; o += kQ;
    wdec = o; o += kQ;
    dcum = o; o += kQ;
    csum = o; o += kQ;
    u = o;    o += kQ;
    red = o;  o += kThreads;
    total = o;
  }
};

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// out(m, n) = sum_k a(m, k) b(k, n) for m < M, n < Nn, k < K, handed to
// epi(m, n, value): warp w computes the 16 x 8 output tiles w, w + kWarps,
// ... over k steps of 8, reading operands through a / b (zero past the
// bounds). Warp-uniform loops: every lane reaches every mma.sync.
template <class FA, class FB, class EPI>
__device__ __forceinline__ void gemm(int M, int Nn, int K, FA a, FB b, EPI epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = (M + 15) / 16, nt = (Nn + 7) / 8;
  for (int tile = warp; tile < mt * nt; tile += kWarps) {
    const int m0 = (tile / nt) * 16, n0 = (tile % nt) * 8;
    const int ma = m0 + gid, mb = ma + 8, nb = n0 + gid;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int k1 = k0 + tig, k2 = k1 + 4;
      uint32_t ah[4], al[4], bh[2], bl[2];
      split(ma < M && k1 < K ? a(ma, k1) : 0.f, ah[0], al[0]);
      split(mb < M && k1 < K ? a(mb, k1) : 0.f, ah[1], al[1]);
      split(ma < M && k2 < K ? a(ma, k2) : 0.f, ah[2], al[2]);
      split(mb < M && k2 < K ? a(mb, k2) : 0.f, ah[3], al[3]);
      split(nb < Nn && k1 < K ? b(k1, nb) : 0.f, bh[0], bl[0]);
      split(nb < Nn && k2 < K ? b(k2, nb) : 0.f, bh[1], bl[1]);
      mma3(acc, ah, al, bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + gid + 8 * (e >> 1), n = n0 + 2 * tig + (e & 1);
      if (m < M && n < Nn) epi(m, n, acc[e]);
    }
  }
}

// One unit: chunk `chunk` of chain (row, head). states: the forward's
// chunk-start states, (chains_f, nchunks, np, sptp) with chains_f = (row,
// head, P tile of spt columns); dstate: (chains, nchunks, np, P), chunk c's
// slot taking its dS_in; sync[0] the ticket counter, sync[1 + chain] the
// chain's flag.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const T* __restrict__ x, const T* __restrict__ la,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               const T* __restrict__ dy, const float* __restrict__ states,
               float* __restrict__ dstate, T* __restrict__ dx,
               T* __restrict__ dla, T* __restrict__ dB, T* __restrict__ dC,
               unsigned long long* __restrict__ sync, unsigned long long base,
               unsigned int epoch, int Tn, int H, int P, int N, int spt,
               int sptp, int sptiles, int chains, int nchunks) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_ticket;
  const Layout lay(N, P);
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = (int)(atomicAdd(sync, 1ULL) - base);
  __syncthreads();
  const int ticket = s_ticket;
  const int r = ticket / chains, chain = ticket - r * chains;
  const int chunk = nchunks - 1 - r;
  const int row = chain / H, h = chain - row * H;
  const int t0 = chunk * kQ, q = min(kQ, Tn - t0);
  const bool first = chunk == 0, last = chunk + 1 == nchunks;
  const int cp = lay.cp, pp = lay.pp, gp = lay.gp, np = lay.np;
  float* Cs = sm + lay.c;
  float* Bs = sm + lay.b;
  float* xs = sm + lay.x;
  float* dys = sm + lay.dy;
  float* Zb = sm + lay.z;
  float* G = sm + lay.g;
  float* Mb = sm + lay.m;
  float* cum = sm + lay.cum;
  float* ecum = sm + lay.ecum;
  float* wdec = sm + lay.wdec;
  float* dcum = sm + lay.dcum;
  float* csum = sm + lay.csum;
  float* uu = sm + lay.u;
  float* red = sm + lay.red;
  const size_t base_t = (size_t)row * Tn + t0;
  const size_t slot = (size_t)np * P;
  float* mine = dstate + ((size_t)chain * nchunks + chunk) * slot;
  const float* next = mine + slot;     // chunk + 1's dS_in = this dS_out

  // stage the chunk as fp32, zero past T, P and N
  float a0 = 0.f, a1 = 0.f;
  if (tid < 32) {
    const int i0 = 2 * tid;
    if (i0 < q) a0 = to_f32(la[(base_t + i0) * H + h]);
    if (i0 + 1 < q) a1 = to_f32(la[(base_t + i0 + 1) * H + h]);
  }
  for (int o = tid; o < kQ * pp; o += kThreads) {
    const int t = o / pp, p = o - t * pp;
    float xv = 0.f, gv = 0.f;
    if (t < q && p < P) {
      const size_t src = ((base_t + t) * H + h) * P + p;
      xv = to_f32(x[src]);
      gv = to_f32(dy[src]);
    }
    xs[o] = xv;
    dys[o] = gv;
  }
  for (int o = tid; o < kQ * cp; o += kThreads) {
    const int t = o / cp, n = o - t * cp;
    float bv = 0.f, cv = 0.f;
    if (t < q && n < N) {
      const size_t src = ((base_t + t) * H + h) * N + n;
      bv = to_f32(Bm[src]);
      cv = to_f32(Cm[src]);
    }
    Bs[o] = bv;
    Cs[o] = cv;
  }
  if (tid < 32) {                        // inclusive cumsum of loga, fp32
    const int lane = tid, i0 = 2 * lane;
    const float pair = a0 + a1;
    float s = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += v;
    }
    const float before = s - pair;
    const float c0 = before + a0, c1 = before + a0 + a1;
    const float total = __shfl_sync(0xffffffffu, c1, 31);
    cum[i0] = c0;
    cum[i0 + 1] = c1;
    ecum[i0] = expf(c0);
    ecum[i0 + 1] = expf(c1);
    wdec[i0] = expf(total - c0);
    wdec[i0 + 1] = expf(total - c1);
  }
  __syncthreads();
  const float total = cum[kQ - 1];

  // G = (C B^T) o L and D = dy x^T
  gemm(kQ, kQ, N, [&](int t, int n) { return Cs[t * cp + n]; },
       [&](int n, int s) { return Bs[s * cp + n]; },
       [&](int t, int s, float v) {
         G[t * gp + s] = s <= t ? v * expf(cum[t] - cum[s]) : 0.f;
       });
  gemm(kQ, kQ, P, [&](int t, int p) { return dys[t * pp + p]; },
       [&](int p, int s) { return xs[s * pp + p]; },
       [&](int t, int s, float v) { Mb[t * gp + s] = v; });
  __syncthreads();

  // dcum from the scores: row sums minus column sums of G o D
  for (int i = tid; i < 2 * kQ; i += kThreads) {
    float acc = 0.f;
    if (i < kQ) {
      for (int s = 0; s < kQ; ++s) acc += G[i * gp + s] * Mb[i * gp + s];
      dcum[i] = acc;
    } else {
      const int s = i - kQ;
      for (int t = 0; t < kQ; ++t) acc += G[t * gp + s] * Mb[t * gp + s];
      csum[s] = acc;
    }
  }
  __syncthreads();
  for (int o = tid; o < kQ * kQ; o += kThreads) {   // M = D o L
    const int t = o / kQ, s = o - t * kQ;
    Mb[t * gp + s] = s <= t ? Mb[t * gp + s] * expf(cum[t] - cum[s]) : 0.f;
  }
  if (tid < kQ) dcum[tid] -= csum[tid];

  // S_in: the forward's chunk-start state (chunk 0 starts from zero)
  const int rh = row * H + h;
  auto s_in = [&](int n, int p) -> float {
    const int ti = p / spt;
    const size_t ch = (size_t)rh * sptiles + ti;
    return __ldg(states + ((ch * nchunks + chunk) * np + n) * sptp + (p - ti * spt));
  };
  if (!first) {
    // Z = C S_in, then dcum_t += ecum_t <dy_t, Z_t>
    gemm(kQ, P, N, [&](int t, int n) { return Cs[t * cp + n]; }, s_in,
         [&](int t, int p, float v) { Zb[t * pp + p] = v; });
    __syncthreads();
    if (tid < kQ) {
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc += dys[tid * pp + p] * Zb[tid * pp + p];
      dcum[tid] += ecum[tid] * acc;
    }
  }
  __syncthreads();                       // M whole, Z consumed

  // dC = M B + (ecum o dy) S_in^T
  gemm(kQ, N, kQ + (first ? 0 : P),
       [&](int t, int k) {
         return k < kQ ? Mb[t * gp + k] : ecum[t] * dys[t * pp + k - kQ];
       },
       [&](int k, int n) { return k < kQ ? Bs[k * cp + n] : s_in(n, k - kQ); },
       [&](int t, int n, float v) {
         if (t < q) dC[((base_t + t) * H + h) * N + n] = from_f32<T>(v);
       });
  // this chunk's share of dS_in: (C o ecum)^T dy (chunk 0 hands nothing on)
  if (!first)
    gemm(N, P, kQ, [&](int n, int t) { return Cs[t * cp + n] * ecum[t]; },
         [&](int t, int p) { return dys[t * pp + p]; },
         [&](int n, int p, float v) { mine[(size_t)n * P + p] = v; });

  // the chain's hand-off: wait for chunk + 1's dS_in, then dS_in = exp(total)
  // dS_out + the share, released to chunk - 1
  unsigned long long* flag = sync + 1 + chain;
  if (!last && tid == 0) {
    const unsigned long long want = ((unsigned long long)epoch << 32) | (unsigned)r;
    for (long long i = 0; ld_acquire(flag) < want; ++i) {
      __nanosleep(64);
      if (i > (1LL << 26)) __trap();     // a lost hand-off: fail, do not hang
    }
  }
  __syncthreads();
  if (!first) {
    if (!last) {
      const float decay = expf(total);
      for (int o = tid; o < N * P; o += kThreads)
        mine[o] = fmaf(decay, __ldcg(next + o), mine[o]);
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      st_release(flag, ((unsigned long long)epoch << 32) | (unsigned)(r + 1));
    }
  }

  if (!last) {
    // Z = B dS_out; u_s = wdec_s <x_s, Z_s>: dcum_s -= u_s, dtotal += sum u
    gemm(kQ, P, N, [&](int s, int n) { return Bs[s * cp + n]; },
         [&](int n, int p) { return __ldcg(next + (size_t)n * P + p); },
         [&](int s, int p, float v) { Zb[s * pp + p] = v; });
    float part = 0.f;                    // <S_in, dS_out>
    if (!first)
      for (int o = tid; o < N * P; o += kThreads) {
        const int n = o / P, p = o - n * P;
        part = fmaf(s_in(n, p), __ldcg(next + o), part);
      }
    red[tid] = part;
    __syncthreads();
    if (tid < kQ) {
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc += xs[tid * pp + p] * Zb[tid * pp + p];
      uu[tid] = wdec[tid] * acc;
      dcum[tid] -= uu[tid];
    }
    __syncthreads();
    if (tid == 0) {
      float sin_dout = 0.f, usum = 0.f;
      for (int i = 0; i < kThreads; ++i) sin_dout += red[i];
      for (int i = 0; i < kQ; ++i) usum += uu[i];
      dcum[kQ - 1] += expf(total) * sin_dout + usum;
    }
  }
  __syncthreads();

  // dx = G^T dy + wdec o Z
  gemm(kQ, P, kQ, [&](int s, int t) { return G[t * gp + s]; },
       [&](int t, int p) { return dys[t * pp + p]; },
       [&](int s, int p, float v) {
         if (s < q) {
           if (!last) v = fmaf(wdec[s], Zb[s * pp + p], v);
           dx[((base_t + s) * H + h) * P + p] = from_f32<T>(v);
         }
       });
  // dB = M^T C + (wdec o x) dS_out^T
  gemm(kQ, N, kQ + (last ? 0 : P),
       [&](int s, int k) {
         return k < kQ ? Mb[k * gp + s] : wdec[s] * xs[s * pp + k - kQ];
       },
       [&](int k, int n) {
         return k < kQ ? Cs[k * cp + n] : __ldcg(next + (size_t)n * P + k - kQ);
       },
       [&](int s, int n, float v) {
         if (s < q) dB[((base_t + s) * H + h) * N + n] = from_f32<T>(v);
       });
  // dloga: the reverse cumulative sum of dcum inside the chunk
  if (tid == 0) {
    float run = 0.f;
    for (int s = kQ - 1; s >= 0; --s) {
      run += dcum[s];
      if (s < q) dla[(base_t + s) * H + h] = from_f32<T>(run);
    }
  }
}

// dstate: chains * nchunks * np * P floats (no initial value needed); sync:
// 1 + chains uint64, the counter at `base` and no flag at or past (epoch <<
// 32) when the launch starts. spt / sptp / sptiles: the forward's P tile,
// its padded width and count (the layout of `states`).
template <typename T>
int ssd_bwd(const void* x, const void* la, const void* Bm, const void* Cm,
            const void* dy, const void* states, void* dstate, void* dx,
            void* dla, void* dB, void* dC, void* sync, unsigned long long base,
            unsigned int epoch, int Nb, int Tn, int H, int P, int N, int spt,
            int sptp, void* stream) {
  if (Nb <= 0 || Tn <= 0 || H <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || spt <= 0 || spt > P || sptp < spt || epoch == 0)
    return (int)cudaErrorInvalidValue;
  const long long chains = (long long)Nb * H;
  const long long nchunks = (Tn + kQ - 1) / kQ;
  if (chains * nchunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Layout lay(N, P);
  const size_t smem = lay.total * sizeof(float);
  if (smem + 16 > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int sptiles = (P + spt - 1) / spt;
  kernel<<<(unsigned)(chains * nchunks), kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)la, (const T*)Bm, (const T*)Cm, (const T*)dy,
      (const float*)states, (float*)dstate, (T*)dx, (T*)dla, (T*)dB, (T*)dC,
      (unsigned long long*)sync, base, epoch, Tn, H, P, N, spt, sptp, sptiles,
      (int)chains, (int)nchunks);
  return (int)cudaGetLastError();
}

}  // namespace ssd_bwd

extern "C" {

const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// steps a chunk, widest P, largest N
void ssd_bwd_constants(int* out) {
  out[0] = ssd_bwd::kQ;
  out[1] = ssd_bwd::kMaxP;
  out[2] = ssd_bwd::kMaxN;
}

int ssd_bwd_smem(int N, int P) {
  return (int)(ssd_bwd::Layout(N, P).total * sizeof(float));
}

int ssd_bwd_f32(const void* x, const void* la, const void* Bm, const void* Cm,
                const void* dy, const void* states, void* dstate, void* dx,
                void* dla, void* dB, void* dC, void* sync,
                unsigned long long base, unsigned int epoch, int Nb, int Tn,
                int H, int P, int N, int spt, int sptp, void* stream) {
  return ssd_bwd::ssd_bwd<float>(x, la, Bm, Cm, dy, states, dstate, dx, dla,
                                 dB, dC, sync, base, epoch, Nb, Tn, H, P, N,
                                 spt, sptp, stream);
}

int ssd_bwd_bf16(const void* x, const void* la, const void* Bm, const void* Cm,
                 const void* dy, const void* states, void* dstate, void* dx,
                 void* dla, void* dB, void* dC, void* sync,
                 unsigned long long base, unsigned int epoch, int Nb, int Tn,
                 int H, int P, int N, int spt, int sptp, void* stream) {
  return ssd_bwd::ssd_bwd<__nv_bfloat16>(x, la, Bm, Cm, dy, states, dstate, dx,
                                         dla, dB, dC, sync, base, epoch, Nb, Tn,
                                         H, P, N, spt, sptp, stream);
}

}  // extern "C"
