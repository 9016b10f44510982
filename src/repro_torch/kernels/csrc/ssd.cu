// Mamba2 SSD chunked scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py ssd_pallas
// (_ssd_kernel): for every (row, head) the recurrence
//   S_t = exp(loga_t) S_{t-1} + B_t x_t^T,   y_t = C_t^T S_t
// evaluated chunk-parallel. Within a chunk of Q steps:
//   y     = ((C B^T) o exp(cum_t - cum_s), s <= t) x  +  (C o exp(cum)) S_in
//   S_out = exp(total) S_in + sum_q exp(total - cum_q) B_q x_q^T
// with cum the inclusive sum of loga inside the chunk and total its last
// entry. x (Nb, T, H, P), loga (Nb, T, H), B, C (Nb, T, H, N), y (Nb, T, H,
// P), all in one dtype (bf16 or f32) and read in that (T, H, .) layout
// directly (no head-major copy); all state math fp32, y rounded once.
//
// What bounds it on the H100: operations, at the fp32 rate the state math
// keeps (a zamba2 prefill moves a few MB against about 0.3 GFLOP), and the
// chain of chunk states: chunk c needs the state left by chunk c - 1.
//
// For training, a launch may also write every chunk's start state S_in
// (`states`, fp32, one slot a chunk) from the hand-off it already reads: the
// backward kernel (csrc/ssd_bwd.cu) starts from them.
//
// Design. The TPU grid (heads, chunks) ran the chunks of a head in order on
// one core with the state in VMEM scratch. Here every (row, head, P tile,
// chunk) is one CTA (a "unit"; a chain is the chunks of one (row, head, P
// tile)), so all chunks of a head run at once. A unit computes everything
// that does not depend on the state first, in parallel with the other
// units: the decay-masked scores G = (C B^T) o exp(cum_t - cum_s), the
// intra-chunk output G x (kept in registers) and its local state S_loc =
// sum_q exp(total - cum_q) B_q x_q^T (in registers). Only then does it wait
// for S_in, published by chunk c - 1 of its chain in device memory, form
// S_out = exp(total) S_in + S_loc, publish that for chunk c + 1, and last add
// (C o exp(cum)) S_in to y. The chain's hand-off is therefore one
// elementwise N x P update a chunk, not a chunk's whole work. The state
// goes through two fp32 slots a chain (chunk c reads slot c % 2 and writes
// slot (c + 1) % 2: chunk c + 2 writes that slot again only after chunk c + 1
// has read it, since it waits for c + 1's state), with a flag a chain,
// (epoch << 32) | chunk, released after the state (st.release.gpu) and
// acquired before reading it (ld.acquire.gpu; the state itself with
// ld.global.cg, past L1). No CTA waits on one that was never scheduled: a
// CTA takes a ticket from a counter in device memory when it starts (not
// its blockIdx), and tickets run chunk-major (all chains' chunk 0 first), so
// a unit only ever waits on a unit with a smaller ticket, which is already
// running or done. The wrapper keeps the counter's running total and the
// epoch per (device, stream), so nothing is reset between calls: one call
// is one launch. Every sum is in a fixed order (no atomics in any sum):
// reruns are bit-identical.
//
// The products run on the tensor cores at fp32 accuracy: mma.sync m16n8k8
// TF32 with each operand split into hi = tf32(v) and lo = tf32(v - hi) and
// three products (lo hi + hi lo + hi hi, about 2^-21 relative; one TF32
// pass would keep 2^-11, too coarse for the 1e-4 gate). 3xTF32 was chosen
// over bf16 hi + lo (2^-17) for the margin it leaves at that gate. A unit
// is 16 warps, four a 16-row tile of the chunk, when the units are few (a
// prefill of T <= 128: each runs its phases on more warps), else 8, two a
// tile (more units resident an SM and less repeated fragment work; the
// wrapper picks): C B^T (causal 16 x 8 tiles only, K = N), G x (K = s <= t
// only) and
// S_loc (M = N, K = Q) share the x fragments of a k step; (C o exp(cum))
// S_in accumulates into G x's registers. Shared memory is fp32 at pitches
// that keep every fragment read conflict-free (the A operand of S_loc, B
// read along its rows, takes 2-way conflicts). The chunk is kQ = 64 steps;
// a chunk past T (T need not be a multiple of kQ) is padded with loga = 0
// and x = B = C = 0, which leaves the state as it is; its rows are not
// stored, and whole 16-row tiles past T are skipped. exp is taken only on
// causal entries (above the diagonal cum_t - cum_s > 0 would overflow).
// P is cut into the fewest tiles of at most 64 columns (narrower only where
// a unit would not fit shared memory: a narrower tile recomputes C B^T and
// ran slower at every shape measured, even where the units leave SMs
// idle); N is padded to 16 and may be up to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {

constexpr int kQ = 64;                 // steps per chunk
constexpr int kMaxPT = 64;             // P columns a unit
constexpr int kMaxN = 256;
constexpr int kMaxSmem = 232448;       // bytes a CTA may use on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared-memory layout in floats. Pitches: C and B rows np + 4 (an odd
// multiple of 4: the row-major A reads and B^T's reads are conflict-free),
// x and S rows round16(pt) + 8 (8 or 24 mod 32: the k-major B reads are
// conflict-free), G rows kQ + 4. G and S share their space: G is dead once
// G x is in registers, before S_in arrives.
struct Layout {
  int np, cp, ptp, xp, gp;
  size_t c, b, x, gs, cum, w, ecum, total;
  __host__ __device__ Layout(int N, int pt) {
    np = (N + 15) / 16 * 16;
    cp = np + 4;
    ptp = (pt + 7) / 8 * 8;
    xp = (pt + 15) / 16 * 16 + 8;
    gp = kQ + 4;
    size_t o = 0;
    c = o;    o += (size_t)kQ * cp;
    b = o;    o += (size_t)kQ * cp;
    x = o;    o += (size_t)kQ * xp;
    gs = o;
    const size_t g = (size_t)kQ * gp, s = (size_t)np * xp;
    o += g > s ? g : s;
    cum = o;  o += kQ;
    w = o;    o += kQ;
    ecum = o; o += kQ;
    total = o;
  }
};

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v as tf32 hi + lo
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), tf32 in, fp32 sums
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

// A fragment (16 x 8) from four fp32 values (rows gid, gid + 8; columns
// tig, tig + 4), split
__device__ __forceinline__ void a_frag(float v0, float v1, float v2, float v3,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
  split(v2, hi[2], lo[2]);
  split(v3, hi[3], lo[3]);
}

// four consecutive elements (16-byte aligned for f32, 8 for bf16) as fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// One unit (a chunk of one chain). MTW: N-row tiles of 16 a warp holds of
// S_loc (np <= 64 MTW). hand: two fp32 slots (np x ptp) a chain; sync[0] the
// ticket counter, sync[1 + chain] the chain's flag. vec: P, N and the P
// tile are multiples of 4 and the operands aligned, so the chunk is staged
// in 4-element loads, a batch of them in flight a thread.
template <typename T, int MTW, int NW>
__global__ void __launch_bounds__(32 * NW, MTW == 1 ? (NW == 16 ? 2 : 3) : 1)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ la,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           T* __restrict__ y, float* __restrict__ hand,
           float* __restrict__ states,
           unsigned long long* __restrict__ sync, unsigned long long base,
           unsigned int epoch, int Tn, int H, int P, int N, int pt,
           int ptiles, int chains, int nchunks, int vec) {
  constexpr int kThreads = 32 * NW;
  constexpr int kWPM = NW / 4;           // warps a 16-row m-tile of the chunk
  constexpr int kNTW = 8 / kWPM;         // 8-column tiles a warp (of 8)
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_ticket;
  const Layout lay(N, pt);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (tid == 0) s_ticket = (int)(atomicAdd(sync, 1ULL) - base);
  __syncthreads();
  const int ticket = s_ticket;
  const int chunk = ticket / chains, chain = ticket - chunk * chains;
  const int rh = chain / ptiles, ptile = chain - rh * ptiles;
  const int row = rh / H, h = rh - row * H;
  const int p0 = ptile * pt, npv = min(pt, P - p0);
  const int t0 = chunk * kQ, q = min(kQ, Tn - t0);
  const int np = lay.np, cp = lay.cp, ptp = lay.ptp, xp = lay.xp, gp = lay.gp;
  float* Cs = sm + lay.c;
  float* Bs = sm + lay.b;
  float* xs = sm + lay.x;
  float* G = sm + lay.gs;
  float* S = sm + lay.gs;
  float* cum = sm + lay.cum;
  float* wdec = sm + lay.w;
  float* ecum = sm + lay.ecum;
  const size_t base_t = (size_t)row * Tn + t0;

  // stage the chunk: x (kQ x ptp), B and C (kQ x np), zero past T, P and N
  float a0 = 0.f, a1 = 0.f;              // warp 0: loga of steps 2 lane, + 1
  if (warp == 0) {
    const int i0 = 2 * lane;
    if (i0 < q) a0 = to_f32(la[(base_t + i0) * H + h]);
    if (i0 + 1 < q) a1 = to_f32(la[(base_t + i0 + 1) * H + h]);
  }
  if (vec) {
    const int xc = ptp / 4, bc = np / 4;     // 4-element chunks a row
    for (int o0 = tid; o0 < kQ * xc; o0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = o0 + u * kThreads, t = o / xc, c = 4 * (o - t * xc);
        v[u] = (o < kQ * xc && t < q && c < npv)
                   ? ld4(x + ((base_t + t) * H + h) * P + p0 + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = o0 + u * kThreads, t = o / xc, c = 4 * (o - t * xc);
        if (o < kQ * xc) *reinterpret_cast<float4*>(xs + t * xp + c) = v[u];
      }
    }
    for (int o0 = tid; o0 < kQ * bc; o0 += 4 * kThreads) {
      float4 bv[4], cv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = o0 + u * kThreads, t = o / bc, c = 4 * (o - t * bc);
        bv[u] = cv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (o < kQ * bc && t < q && c < N) {
          const size_t src = ((base_t + t) * H + h) * N + c;
          bv[u] = ld4(Bm + src);
          cv[u] = ld4(Cm + src);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = o0 + u * kThreads, t = o / bc, c = 4 * (o - t * bc);
        if (o < kQ * bc) {
          *reinterpret_cast<float4*>(Bs + t * cp + c) = bv[u];
          *reinterpret_cast<float4*>(Cs + t * cp + c) = cv[u];
        }
      }
    }
  } else {
    for (int o = tid; o < kQ * ptp; o += kThreads) {
      const int t = o / ptp, p = o - t * ptp;
      xs[t * xp + p] = (t < q && p < npv)
                           ? to_f32(x[((base_t + t) * H + h) * P + p0 + p]) : 0.f;
    }
    for (int o = tid; o < kQ * np; o += kThreads) {
      const int t = o / np, n = o - t * np;
      float bv = 0.f, cv = 0.f;
      if (t < q && n < N) {
        const size_t src = ((base_t + t) * H + h) * N + n;
        bv = to_f32(Bm[src]);
        cv = to_f32(Cm[src]);
      }
      Bs[t * cp + n] = bv;
      Cs[t * cp + n] = cv;
    }
  }
  if (warp == 0) {                       // inclusive cumsum of loga, fp32
    const int i0 = 2 * lane;
    const float pair = a0 + a1;
    float s = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += v;
    }
    const float before = s - pair;
    const float c0 = before + a0, c1 = before + a0 + a1;
    const float total = __shfl_sync(0xffffffffu, c1, 31);   // padded steps add 0
    cum[i0] = c0;
    cum[i0 + 1] = c1;
    wdec[i0] = expf(total - c0);
    wdec[i0 + 1] = expf(total - c1);
    ecum[i0] = expf(c0);
    ecum[i0 + 1] = expf(c1);
  }
  __syncthreads();
  const float total = cum[kQ - 1];

  // G = (C B^T) o exp(cum_t - cum_s), s <= t: warp w takes the 16 rows of
  // m-tile mi = w / kWPM and every kWPM-th 8-column tile j <= 2 mi + 1
  const int mi = warp / kWPM, sub = warp % kWPM;
  const int mrows = (q + 15) / 16;       // 16-row tiles that hold steps < T
  if (mi < mrows) {
    float acc[kNTW][4];
#pragma unroll
    for (int jj = 0; jj < kNTW; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
    const float* ca = Cs + (16 * mi + gid) * cp + tig;
    for (int k0 = 0; k0 < np; k0 += 8) {
      uint32_t ah[4], al[4];
      a_frag(ca[k0], ca[k0 + 8 * cp], ca[k0 + 4], ca[k0 + 8 * cp + 4], ah, al);
#pragma unroll
      for (int jj = 0; jj < kNTW; ++jj) {
        const int j = kWPM * jj + sub;
        if (j <= 2 * mi + 1) {
          const float* bb = Bs + (8 * j + gid) * cp + k0 + tig;
          uint32_t bh[2], bl[2];
          split(bb[0], bh[0], bl[0]);
          split(bb[4], bh[1], bl[1]);
          mma3(acc[jj], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kNTW; ++jj) {
      const int j = kWPM * jj + sub;
      if (j <= 2 * mi + 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * mi + gid + 8 * (e >> 1), s = 8 * j + 2 * tig + (e & 1);
          G[t * gp + s] = s <= t ? acc[jj][e] * expf(cum[t] - cum[s]) : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // y = G x (rows of m-tile mi, columns of n-tiles kNTW sub .. + kNTW - 1) and
  // S_loc = B'^T x (N rows of m-tiles mi + 4 i, the same columns), B' = B o
  // exp(total - cum), sharing the x fragments of each k step over s
  float yacc[kNTW][4], sacc[MTW][kNTW][4];
#pragma unroll
  for (int jj = 0; jj < kNTW; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      yacc[jj][e] = 0.f;
#pragma unroll
      for (int i = 0; i < MTW; ++i) sacc[i][jj][e] = 0.f;
    }
  const int ntl = ptp / 8;               // 8-column tiles of the P tile
  const int ksteps = (q + 7) / 8;        // k steps holding steps < T
  for (int kk = 0; kk < ksteps; ++kk) {
    const int k0 = 8 * kk;
    uint32_t bh[kNTW][2], bl[kNTW][2];
#pragma unroll
    for (int jj = 0; jj < kNTW; ++jj) {
      const int jn = kNTW * sub + jj;
      if (jn < ntl) {
        const float* xb = xs + (k0 + tig) * xp + 8 * jn + gid;
        split(xb[0], bh[jj][0], bl[jj][0]);
        split(xb[4 * xp], bh[jj][1], bl[jj][1]);
      }
    }
    if (mi < mrows && kk < 2 * mi + 2) {
      const float* ga = G + (16 * mi + gid) * gp + k0 + tig;
      uint32_t ah[4], al[4];
      a_frag(ga[0], ga[8 * gp], ga[4], ga[8 * gp + 4], ah, al);
#pragma unroll
      for (int jj = 0; jj < kNTW; ++jj)
        if (kNTW * sub + jj < ntl) mma3(yacc[jj], ah, al, bh[jj], bl[jj]);
    }
    const float w0 = wdec[k0 + tig], w1 = wdec[k0 + tig + 4];
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int n0 = 16 * (mi + 4 * i);
      if (n0 < np) {
        const float* ba = Bs + (k0 + tig) * cp + n0 + gid;
        uint32_t ah[4], al[4];
        a_frag(ba[0] * w0, ba[8] * w0, ba[4 * cp] * w1, ba[4 * cp + 8] * w1, ah, al);
#pragma unroll
        for (int jj = 0; jj < kNTW; ++jj)
          if (kNTW * sub + jj < ntl) mma3(sacc[i][jj], ah, al, bh[jj], bl[jj]);
      }
    }
  }

  // the chain's hand-off: wait for S_in (chunk > 0), then S_out = exp(total)
  // S_in + S_loc to the other slot, and release it to chunk + 1
  unsigned long long* flag = sync + 1 + chain;
  const size_t slot_elems = (size_t)np * ptp;
  if (chunk > 0 && tid == 0) {
    const unsigned long long want = ((unsigned long long)epoch << 32) | (unsigned)chunk;
    for (long long i = 0; ld_acquire(flag) < want; ++i) {
      __nanosleep(64);
      if (i > (1LL << 26)) __trap();     // a lost hand-off: fail, do not hang
    }
  }
  __syncthreads();                       // S_in is published; G is consumed
  const float* s_prev = hand + ((size_t)chain * 2 + (chunk & 1)) * slot_elems;
  float* s_next = hand + ((size_t)chain * 2 + ((chunk + 1) & 1)) * slot_elems;
  const bool last = chunk + 1 == nchunks;
  const float decay = expf(total);
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    const int n0 = 16 * (mi + 4 * i);
    if (n0 >= np) continue;
#pragma unroll
    for (int jj = 0; jj < kNTW; ++jj) {
      const int jn = kNTW * sub + jj;
      if (jn >= ntl) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = n0 + gid + 8 * hh, p = 8 * jn + 2 * tig;
        float2 s_in = make_float2(0.f, 0.f);
        if (chunk > 0) {
          s_in = __ldcg(reinterpret_cast<const float2*>(s_prev + (size_t)n * ptp + p));
          *reinterpret_cast<float2*>(S + n * xp + p) = s_in;
        }
        if (states != nullptr)           // the chunk-start state, for the backward
          *reinterpret_cast<float2*>(states + ((size_t)chain * nchunks + chunk) * slot_elems +
                                     (size_t)n * ptp + p) = s_in;
        if (!last) {
          const float2 o = make_float2(fmaf(decay, s_in.x, sacc[i][jj][2 * hh]),
                                       fmaf(decay, s_in.y, sacc[i][jj][2 * hh + 1]));
          __stcg(reinterpret_cast<float2*>(s_next + (size_t)n * ptp + p), o);
        }
      }
    }
  }
  __syncthreads();                       // S_out is stored; S is whole
  // the release is cumulative: the CTA's stores, ordered before it by the
  // barrier, are visible to whoever acquires the flag
  if (!last && tid == 0)
    st_release(flag, ((unsigned long long)epoch << 32) | (unsigned)(chunk + 1));

  // y += (C o exp(cum)) S_in, then store the rows < T
  if (mi < mrows) {
    if (chunk > 0) {
      const float* ca = Cs + (16 * mi + gid) * cp + tig;
      const float e0 = ecum[16 * mi + gid], e1 = ecum[16 * mi + gid + 8];
      for (int k0 = 0; k0 < np; k0 += 8) {
        uint32_t ah[4], al[4];
        a_frag(ca[k0] * e0, ca[k0 + 8 * cp] * e1, ca[k0 + 4] * e0,
               ca[k0 + 8 * cp + 4] * e1, ah, al);
#pragma unroll
        for (int jj = 0; jj < kNTW; ++jj) {
          const int jn = kNTW * sub + jj;
          if (jn < ntl) {
            const float* sb = S + (k0 + tig) * xp + 8 * jn + gid;
            uint32_t bh[2], bl[2];
            split(sb[0], bh[0], bl[0]);
            split(sb[4 * xp], bh[1], bl[1]);
            mma3(yacc[jj], ah, al, bh, bl);
          }
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kNTW; ++jj) {
      const int jn = kNTW * sub + jj;
      if (jn >= ntl) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mi + gid + 8 * (e >> 1), p = 8 * jn + 2 * tig + (e & 1);
        if (t < q && p < npv)
          y[((base_t + t) * H + h) * P + p0 + p] = from_f32<T>(yacc[jj][e]);
      }
    }
  }
}

template <typename T, int MTW, int NW>
int launch(const void* x, const void* la, const void* Bm, const void* Cm,
           void* y, void* hand, void* states, void* sync, unsigned long long base,
           unsigned int epoch, int Tn, int H, int P, int N, int pt, int ptiles,
           int chains, int nchunks, int vec, size_t smem, cudaStream_t stream) {
  auto kernel = ssd_kernel<T, MTW, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)chains * nchunks), 32 * NW, smem, stream>>>(
      (const T*)x, (const T*)la, (const T*)Bm, (const T*)Cm, (T*)y,
      (float*)hand, (float*)states, (unsigned long long*)sync, base, epoch, Tn, H, P, N, pt,
      ptiles, chains, nchunks, vec);
  return (int)cudaGetLastError();
}

// hand: chains * 2 * np * ptp floats; sync: 1 + chains uint64, the counter
// at `base` and no flag at or past (epoch << 32) when the launch starts.
// states: null, or chains * nchunks * np * ptp floats that take every
// chunk's start state S_in (zero for chunk 0), the backward's input.
// warps: 16 a unit (few units: each runs its phases on more warps) or 8
// (many: more units resident an SM, less repeated fragment work)
template <typename T>
int ssd(const void* x, const void* la, const void* Bm, const void* Cm, void* y,
        void* hand, void* states, void* sync, unsigned long long base, unsigned int epoch,
        int Nb, int Tn, int H, int P, int N, int pt, int warps, void* stream) {
  if (Nb <= 0 || Tn <= 0 || H <= 0 || P <= 0 || N <= 0 || N > kMaxN ||
      pt <= 0 || pt > kMaxPT || pt > P || epoch == 0 ||
      (warps != 8 && warps != 16))
    return (int)cudaErrorInvalidValue;
  const int ptiles = (P + pt - 1) / pt;
  const long long chains = (long long)Nb * H * ptiles;
  const long long nchunks = (Tn + kQ - 1) / kQ;
  if (chains * nchunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Layout lay(N, pt);
  const size_t smem = lay.total * sizeof(float);
  if (smem + 16 > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = 4 * sizeof(T);
  const int vec = P % 4 == 0 && N % 4 == 0 && pt % 4 == 0 &&
                  (uintptr_t)x % align == 0 && (uintptr_t)Bm % align == 0 &&
                  (uintptr_t)Cm % align == 0;
#define SSD_CASE(MTW_, NW_)                                                    \
  if (lay.np <= 64 * MTW_ && warps == NW_)                                     \
    return launch<T, MTW_, NW_>(x, la, Bm, Cm, y, hand, states, sync, base,     \
                                epoch, Tn,                                      \
                                H, P, N, pt, ptiles, (int)chains, (int)nchunks, \
                                vec, smem, s);
  SSD_CASE(1, 16) SSD_CASE(2, 16) SSD_CASE(4, 16)
  SSD_CASE(1, 8) SSD_CASE(2, 8) SSD_CASE(4, 8)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace ssd

extern "C" {

const char* ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// the constants the wrapper mirrors: steps a chunk, widest P tile, largest
// N, and the shared memory of a unit of (N, pt) in bytes
void ssd_constants(int* out) {
  out[0] = ssd::kQ;
  out[1] = ssd::kMaxPT;
  out[2] = ssd::kMaxN;
}

int ssd_smem(int N, int pt) {
  return (int)(ssd::Layout(N, pt).total * sizeof(float));
}

int ssd_chunked_scan_f32(const void* x, const void* la, const void* Bm,
                         const void* Cm, void* y, void* hand, void* states,
                         void* sync, unsigned long long base,
                         unsigned int epoch, int Nb, int Tn, int H, int P,
                         int N, int pt, int warps, void* stream) {
  return ssd::ssd<float>(x, la, Bm, Cm, y, hand, states, sync, base, epoch, Nb,
                         Tn, H, P, N, pt, warps, stream);
}

int ssd_chunked_scan_bf16(const void* x, const void* la, const void* Bm,
                          const void* Cm, void* y, void* hand, void* states,
                          void* sync, unsigned long long base,
                          unsigned int epoch, int Nb, int Tn, int H, int P,
                          int N, int pt, int warps, void* stream) {
  return ssd::ssd<__nv_bfloat16>(x, la, Bm, Cm, y, hand, states, sync, base,
                                 epoch, Nb, Tn, H, P, N, pt, warps, stream);
}

}  // extern "C"
