// Inline PTX for the kernels under csrc/, for sm_90a: the fp32 -> tf32 rounding and
// split of 3xTF32; Hopper's tensor copies (TMA, cp.async.bulk.tensor), the
// shared-memory barriers (mbarrier) that count their bytes, and the warpgroup
// product (wgmma) in bf16 and tf32.
#pragma once

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// A shared-memory barrier of `count` arrivals a phase; then a fence, so that the
// tensor copies see it initialised.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 4-d box of the tensor described by `tmap` (a __grid_constant__ CUtensorMap) at
// coordinates (c0, c1, c2, c3), innermost first, into shared memory at dst; elements
// outside the tensor arrive as zeros. Completes its bytes on the barrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 3-d box, as tma_load_4d.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before the async proxy's
// reads of it (wgmma's operands, written by ordinary stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in TMA's 128-byte swizzle: rows
// of 128 bytes (64 bf16 or 32 tf32 values along K), eight rows a 1024-byte atom (the
// stride between atoms, SBO), the tile on a 1024-byte boundary; a k16 step of bf16,
// or a k8 step of tf32, further along K starts 32 bytes later.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving a register's reads or writes across the wgmma
// instructions that own it.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d[64 x 24] += a[64 x 16] * b[16 x 24], bf16 in, fp32 sums, both operands K-major in
// shared memory; a warpgroup's instruction. Each warp holds 16 rows of d as three
// m16n8 fragments (d[4 j .. 4 j + 3]: columns 8 j on), the layout of mma.sync's.
__device__ __forceinline__ void wgmma_m64n24k16_bf16(float (&d)[12], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 48] (+)= a[64 x 8] * b[8 x 48], tf32 in, fp32 sums: a from registers (each
// warp 16 rows, the fragment of mma.sync m16n8k8's A: a[0] row g col t, a[1] row g + 8
// col t, a[2] row g col t + 4, a[3] row g + 8 col t + 4, for lane 4 g + t), b K-major in
// shared memory by descriptor (tf32 takes no other layout); a warpgroup's instruction.
// scale_d 0 ignores d's value (the sum starts from zero). Each warp holds 16 rows of d
// as six m16n8 fragments (d[4 j .. 4 j + 3]: columns 8 j on). The registers of a are
// read asynchronously: they stay unchanged until the wait.
__device__ __forceinline__ void wgmma_m64n48k8_tf32(float (&d)[24], const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace hopper
