// Inline PTX for the kernels under csrc/: asynchronous global->shared copies
// (cp.async), shared-memory matrix loads (ldmatrix), the bf16 and tf32 tensor-core
// products (mma.sync m16n8k16, m16n8k8) and the fp32 -> tf32 rounding, for sm_80
// and later, used here on sm_90a.
#pragma once

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; src_bytes 0 writes 16 zero bytes (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices (or 8x4 of 32-bit words: register i of lane l then holds
// word l % 4 of row l / 4 of matrix i); lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed on the way into the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d[16x8] += a[16x16] (row-major bf16) * b[16x8] (column-major bf16), fp32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fp32 -> tf32 (10-bit mantissa), rounded to nearest with ties away from zero; the
// low 13 bits of the result are zero.
__device__ __forceinline__ uint32_t cvt_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small + O(2^-22 |v|), both tf32: the operand split of 3xTF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = cvt_tf32(v);
  small = cvt_tf32(v - __uint_as_float(big));
}

// d[16x8] += a[16x8] (row-major tf32) * b[8x8] (column-major tf32), fp32 sums.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[16x8] = a[16x8] (row-major tf32) * b[8x8] (column-major tf32), fp32, from zero.
__device__ __forceinline__ void mma_tf32_1688_zero(float (&d)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

}  // namespace hopper
