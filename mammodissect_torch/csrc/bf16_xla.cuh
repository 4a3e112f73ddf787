// The JAX package's bf16 program as XLA's CPU backend compiles it, for the kernels
// under csrc/ that compute it: the rounding to bf16, flax's inference BatchNorm
// and jax.nn.silu's rounded op chain, with the chain's sigmoid read from a table.
// The plain versions are `ops.cuda_mbconv.batch_norm_fma` and
// `ops.activations.silu_chain`; kernel 2 (mbconv_expand_dw.cu) and the BatchNorm
// epilogue (bn_epilogue.cu) include this file.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16 path's BatchNorm, as XLA's CPU program of flax's BatchNorm computes it:
// v - mean rounded, then (v - mean) * mul + bias as one FMA (LLVM contracts the
// product and the sum); `ops.cuda_mbconv.batch_norm_fma` is the plain version
__device__ __forceinline__ float bn_bf16(float v, float mean, float mul, float bias) {
  return __fmaf_rn(__fsub_rn(v, mean), mul, bias);
}

// The bf16 path's SiLU of a bf16 value a, as XLA computes the JAX package's
// jax.nn.silu at bf16: exp(-a), 1 + it and its reciprocal each rounded to bf16
// (the accurate expf and the IEEE reciprocal, so that the float32 results round as
// XLA's do), a subnormal reciprocal flushed to zero as XLA's CPU backend flushes it;
// returns the product a * r rounded to fp32 (an explicit multiply: contracted into
// the squeeze's sum, it would sum exact products), which the caller's bf16 store rounds.
__device__ __forceinline__ float sigmoid_bf16(float a) {
  const float d = bf16_round(1.0f + bf16_round(expf(-a)));
  const float r = bf16_round(__frcp_rn(d));
  return r < 1.17549435e-38f ? 0.0f : r;
}

__device__ __forceinline__ float silu_bf16(float a) { return __fmul_rn(a, sigmoid_bf16(a)); }

// The sigmoid r of `sigmoid_bf16` takes a bf16 input, so it is a function of 65536
// values, and outside |a| in [2^-8, 2^7) it is a constant: 0.5 below (and at zero),
// 1 from 2^7 up for a > 0 and 0 for a < 0. The table holds r (bf16 bits) for the
// 1922 magnitudes from the largest bf16 below 2^-8 to 2^7, each sign, built once a
// device by `sigmoid_bf16` itself (`mbconv_sigmoid_bf16`), so a SiLU read from it has
// the chain's bits; the magnitude clamped to that range finds every finite input's
// entry, the constants included. Index: the sign times TAB_SPAN, plus the clamped
// bf16 magnitude bits less TAB_LO.
constexpr uint32_t TAB_LO = (119u << 7) - 1;  // the largest bf16 magnitude below 2^-8
constexpr uint32_t TAB_HI = 134u << 7;        // 2^7: biased exponent 134
constexpr uint32_t TAB_SPAN = TAB_HI - TAB_LO + 1;
constexpr int TAB_ENTRIES = 2 * TAB_SPAN;

// silu_bf16(a) for a bf16 value a (held in fp32) with r read from the table in
// shared memory: a clamp, a load and a multiply. Inf and NaN take the chain itself.
__device__ __forceinline__ float silu_tab(float a, const uint16_t* tab) {
  const uint32_t bits = __float_as_uint(a) >> 16, mag = bits & 0x7fffu;
  if (mag >= 0x7f80u) return silu_bf16(a);
  const uint32_t i = min(max(mag, TAB_LO), TAB_HI) - TAB_LO + (bits >> 15) * TAB_SPAN;
  return __fmul_rn(a, __uint_as_float(static_cast<uint32_t>(tab[i]) << 16));
}
