// The BatchNorm epilogue of the bf16 image tower (kernel 3) for Hopper (sm_90a): one
// pass over a convolution's float32 sums computes its BatchNorm, the rounding to bf16
// and the SiLU that follows, at the conv -> BatchNorm sites of the bf16 inference tower
// that kernel 2 does not cover.
//
//   v [B, H, W, C] f32 (the NCHW sums in channels_last memory), the BatchNorm as
//   flax's inference terms (mean, mul, bias) [C] f32  ->
//     out [B, H, W, C] bf16: bf16(bn(v)) (the project convs), or with the SiLU
//       bf16(silu(bf16(bn(v)))) (the stem, the strided and expand-1 blocks' expand and
//       depthwise, the head);
//     prod [B, H, W, C] f32 (with the SiLU): its last product a * r unrounded, what
//       the unfused block's SE sums over H x W (`silu(x, rounded=False)`; the head's
//       features where the program pools them in f32).
//   Either output or both. The SE's squeeze is then ATen's sum of prod, the ATen
//   chain's own reduction: a sum in another order moves the squeeze by float32 ulps,
//   which now and then move the SE's bf16 gate, and with it the tower's bits.
//
// It replaces no TPU kernel: XLA fuses these chains into the convolution on the TPU
// and on the CPU. In the port each op of the ATen chain
// (`ops.cuda_bn_epilogue.bn_epilogue_plain`) is a pass over the tensor: the
// BatchNorm's subtraction and addcmul (16 bytes an element), the cast to bf16 (6) and
// the rounded SiLU chain (~26), about 52 bytes an element where one pass needs 6.
// The arithmetic is the JAX package's bf16 program as XLA's CPU backend compiles it
// (`bf16_xla.cuh`, shared with kernel 2): (v - mean) rounded, one FMA with mul and
// bias, the result rounded to bf16, the SiLU's sigmoid read from kernel 2's table,
// the product a * r exact in f32 and rounded once by the bf16 store.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes, B*H*W*C*(4 + 2 per bf16 output + 4 per
// f32 output). A subtraction, an FMA, two roundings, a table read and a product an
// element are a small share of an SM's issue rate at that pace.
//
// Design. A thread owns V channels (V = 4: a 16-byte load of f32 sums, an 8-byte store
// of bf16, where C is a multiple of 4 and the sums 16-byte aligned; else V = 1) and
// keeps their BatchNorm terms in registers. A block is gx channel groups by ry rows of
// positions (gx * ry <= 256; gx covers C in npass passes, so C up to 1024 a pass); a
// block's tile is ry * RPT consecutive positions of one image, and each thread walks
// RPT of them, UNROLL loads in flight. The SiLU's table (7.5 KB) is copied to shared
// memory once a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "bf16_xla.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // most threads a block
constexpr int RPT = 16;       // positions a thread walks, a pass
constexpr int UNROLL = 4;     // positions a thread loads before it computes them

// How a launch cuts the tensor: C / V groups of V channels in npass passes of gx
// groups, ry rows of positions a block, tiles an image.
struct Geo {
  int npass, gx, ry, tiles;
};

inline Geo geometry(int64_t hw, int c, int vec) {
  Geo g;
  const int groups = c / vec;
  g.npass = (groups + THREADS - 1) / THREADS;
  g.gx = (groups + g.npass - 1) / g.npass;
  g.ry = THREADS / g.gx;
  const int64_t tile = static_cast<int64_t>(g.ry) * RPT;
  g.tiles = static_cast<int>((hw + tile - 1) / tile);
  return g;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(bf16* p, const float (&y)[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(y[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&y)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    *p = y[0];
  }
}

// SILU: the BatchNorm's SiLU (else the BatchNorm alone). BF16: writes the result in
// bf16 to out; F32: writes the SiLU's product a * r in f32 to prod (SILU only).
template <int V, bool SILU, bool BF16, bool F32>
__global__ void __launch_bounds__(THREADS)
bn_epilogue_kernel(const float* __restrict__ v, const float* __restrict__ mean,
                   const float* __restrict__ mul, const float* __restrict__ bias,
                   const uint16_t* __restrict__ table, bf16* __restrict__ out,
                   float* __restrict__ prod, int64_t hw, int c, int gx, int ry, int npass,
                   int tiles) {
  __shared__ __align__(16) uint16_t s_tab[SILU ? TAB_ENTRIES : 2];
  const int tid = threadIdx.x, tx = tid % gx, r = tid / gx;
  const int64_t img = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int64_t p0 = static_cast<int64_t>(tile) * ry * RPT + r;  // the thread's first position
  const int64_t tile_end = static_cast<int64_t>(tile + 1) * ry * RPT;
  const int64_t p_end = tile_end < hw ? tile_end : hw;
  const float* const vi = v + img * hw * c;
  if constexpr (SILU) {
    for (int i = tid; i < TAB_ENTRIES / 2; i += blockDim.x)
      reinterpret_cast<uint32_t*>(s_tab)[i] = reinterpret_cast<const uint32_t*>(table)[i];
    __syncthreads();
  }
  for (int pass = 0; pass < npass; ++pass) {
    const int c0 = (pass * gx + tx) * V;
    if (c0 >= c) break;
    float m[V], mu[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = __ldg(mean + c0 + j);
      mu[j] = __ldg(mul + c0 + j);
      b[j] = __ldg(bias + c0 + j);
    }
    for (int k0 = 0; k0 < RPT; k0 += UNROLL) {
      float x[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t p = p0 + static_cast<int64_t>(k0 + u) * ry;
        if (p < p_end) {
          load<V>(vi + p * c + c0, x[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) x[u][j] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t p = p0 + static_cast<int64_t>(k0 + u) * ry;
        if (p < p_end) {
          float y[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            y[j] = bf16_round(bn_bf16(x[u][j], m[j], mu[j], b[j]));
            if constexpr (SILU) y[j] = silu_tab(y[j], s_tab);
          }
          const int64_t o = (img * hw + p) * c + c0;
          if constexpr (BF16) store_bf16<V>(out + o, y);
          if constexpr (F32) store_f32<V>(prod + o, y);
        }
      }
    }
  }
}

template <int V, bool SILU, bool BF16, bool F32>
int launch(const float* v, const float* mean, const float* mul, const float* bias,
           const uint16_t* table, bf16* out, float* prod, int batch, int64_t hw, int c,
           cudaStream_t st) {
  const Geo g = geometry(hw, c, V);
  const int64_t blocks = static_cast<int64_t>(batch) * g.tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  bn_epilogue_kernel<V, SILU, BF16, F32><<<static_cast<unsigned>(blocks), g.gx * g.ry, 0, st>>>(
      v, mean, mul, bias, table, out, prod, hw, c, g.gx, g.ry, g.npass, g.tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int dispatch(bool silu, const float* v, const float* mean, const float* mul, const float* bias,
             const uint16_t* table, bf16* out, float* prod, int batch, int64_t hw, int c,
             cudaStream_t st) {
  if (!silu && out && !prod)
    return launch<V, false, true, false>(v, mean, mul, bias, table, out, prod, batch, hw, c, st);
  if (silu && out && !prod)
    return launch<V, true, true, false>(v, mean, mul, bias, table, out, prod, batch, hw, c, st);
  if (silu && out && prod)
    return launch<V, true, true, true>(v, mean, mul, bias, table, out, prod, batch, hw, c, st);
  if (silu && !out && prod)
    return launch<V, true, false, true>(v, mean, mul, bias, table, out, prod, batch, hw, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// silu: 0 = the BatchNorm, 1 = and its SiLU. vec: 4 (C a multiple of 4, v 16-byte
// aligned) or 1. mean, mul, bias [C] f32; table: kernel 2's SiLU table (silu 1). Writes
// out [batch, H*W, C] bf16 and, with silu, prod [batch, H*W, C] f32 (the SiLU's product
// unrounded), each where it is not null (at least one). On `stream`; returns a
// cudaError_t value (cudaErrorInvalidValue for an unsupported vec or set of outputs).
extern "C" int bn_epilogue(int silu, int vec, const void* v, const void* mean, const void* mul,
                           const void* bias, const void* table, void* out, void* prod,
                           int batch, int64_t hw, int c, void* stream) {
  if ((vec != 1 && vec != 4) || c % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || c == 0 || hw == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* vf = static_cast<const float*>(v);
  const auto* mf = static_cast<const float*>(mean);
  const auto* uf = static_cast<const float*>(mul);
  const auto* bf = static_cast<const float*>(bias);
  const auto* tab = static_cast<const uint16_t*>(table);
  auto* ob = static_cast<bf16*>(out);
  auto* of = static_cast<float*>(prod);
  return vec == 4 ? dispatch<4>(silu != 0, vf, mf, uf, bf, tab, ob, of, batch, hw, c, st)
                  : dispatch<1>(silu != 0, vf, mf, uf, bf, tab, ob, of, batch, hw, c, st);
}
