// Hopper PTX wrappers shared by the tensor-core kernels (bdmm.cu,
// gs_fused.cu, gs_fused_T.cu, gs_fused_bwd.cu, q_matmul.cu): shared-memory
// addresses, 16-byte cp.async, ldmatrix / stmatrix, the bf16 mma.sync
// m16n8k16 with fp32 sums, the split of an fp32 fragment into bf16 hi + lo,
// and programmatic dependent launch. Each including .cu file is
// its own shared library.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gs {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; an invalid copy writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// store four 8 x 8 b16 matrices from the mma fragment layout, transposed:
// row i of matrix k (lane 8k + i gives its 16-byte address) receives column
// i of the fragment
__device__ __forceinline__ void stsm_x4_trans(const uint32_t (&r)[4], void* p) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// the same for two matrices (lanes 0-15 give the addresses)
__device__ __forceinline__ void stsm_x2_trans(const uint32_t (&r)[2], void* p) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n"
      ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1])
      : "memory");
}

// store four 8 x 8 b16 matrices from the mma fragment layout: row i of
// matrix k (lane 8k + i gives its 16-byte address) receives row i of the
// fragment
__device__ __forceinline__ void stsm_x4(const uint32_t (&r)[4], void* p) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// global stores with the streaming (evict-first) hint: written once and not
// read again by the kernel, so they do not push its input out of L2
__device__ __forceinline__ void st_cs16(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cs2(void* p, bf16 v) {
  asm volatile("st.global.cs.b16 [%0], %1;\n" ::"l"(p),
               "h"(__bfloat16_as_ushort(v))
               : "memory");
}

// programmatic dependent launch: let the next kernel of the stream (launched
// with cudaLaunchAttributeProgrammaticStreamSerialization) start its CTAs
// now; and, in that kernel, wait until this grid has finished and its
// writes are visible. Both are no-ops without such a launch.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// two bf16 in one 32-bit register, `lo` in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two fp32 as bf16 in one 32-bit register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the fp32 fragment c as bf16 hi = bf16(c) and lo = bf16(c - hi), packed
// as the rows gid (c0, c1) and gid + 8 (c2, c3) of two 8 x 8 matrices each
__device__ __forceinline__ void hi_lo(const float (&c)[4], uint32_t (&s)[4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float2 v = make_float2(c[2 * p], c[2 * p + 1]);
    const __nv_bfloat162 h = __float22bfloat162_rn(v);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __float22bfloat162_rn(make_float2(v.x - hf.x, v.y - hf.y));
    s[p] = *reinterpret_cast<const uint32_t*>(&h);
    s[2 + p] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

}  // namespace gs
