// MBConv front half for Hopper (sm_90a): 1x1 expand -> BN + SiLU -> k x k
// stride-1 depthwise (SAME zeros) -> BN + SiLU, in one kernel, and the SE's squeeze.
//
//   x [B, H, W, Cin] (NHWC), w_exp [Cin, Cexp], w_dw [K, K, Cexp], all in T;
//   each BatchNorm as three f32 vectors [Cexp]: mean, mul = scale * (1 / sqrt(var +
//   eps)) and bias (flax's inference BatchNorm, (v - mean) * mul + bias)
//   ->  out [B, H, W, Cexp] in T, and squeeze [B, Cexp] f32: the sum over H x W of
//   the last SiLU's values before they are rounded to T (the SE's mean times H W).
//   T is __nv_bfloat16 (the tower's main path) or float; every sum is fp32.
//
// Replaces the TPU kernel mammodissect/ops/pallas_mbconv.py::fused_expand_dw
// (body `_kernel`), generalised to what the EfficientNet-B5 tower needs: K in
// {3, 5}, any H and W (masked tail tiles), any Cin and Cexp (masked channel
// tails, no 128-lane padding), bf16 and fp32.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 and 495 TFLOP/s tf32 on the
// tensor cores, 67 TFLOP/s fp32 outside them), per call: bytes
// B*H*W*(Cin+Cexp)*sizeof(T); expand 2*B*H*W*Cin*Cexp FLOPs (tensor cores);
// depthwise 2*K*K*B*H*W*Cexp FLOPs (fp32 FMAs). The expanded tensor (Cexp/Cin = 6
// times the input) never goes to device memory. At B5 widths the expand is ~95% of
// the FLOPs, so it runs on the tensor cores; the depthwise's fp32 FMAs are the rest.
// In fp32 the expand takes three tf32 products (3xTF32, below), so its bound is the
// expand at 495/3 TFLOP/s beside the depthwise at 67 TFLOP/s: 6.69 ms a B5 forward
// at batch 16 (14.29 ms were both on the fp32 FMAs). The squeeze adds its tile
// partials, B*tiles*Cexp*4 bytes written and read once (below), and B*Cexp*4 bytes.
//
// The squeeze. The SE block after this kernel averages the last SiLU over H x W; the
// kernel sums it from the values in registers, so no pass reads the expanded tensor
// back. In bf16 the summed value is the SiLU's last product a * r in fp32, before the
// store rounds it (XLA's program of the JAX block averages that product unrounded:
// its mean promotes to fp32); in fp32 it is the value written. The order is fixed,
// with no float atomics, so two launches give the same bits: each depthwise item
// (a row segment of one or two channels) sums its outputs inside the image in column
// order in registers and leaves the sum in shared memory; after the block's barrier
// one thread a channel adds the items in row-then-segment order and writes the
// tile's partial to partials [B, tiles, Cexp rounded up to 48] (f32 scratch from the
// caller; every B5 and V2-S width is a multiple of 48); a second
// kernel (`squeeze_tiles_kernel`) then adds each (image, channel)'s partials in tile
// order. At block 4's 380 x 228 x 240, batch 16, the scratch is 16 x 456 x 240 x 4 =
// 7 MB (bf16 tiles), where a separate mean moves 10 bytes a value (the bf16 output
// read, an f32 copy written and read back): 3.3 GB there.
//
// bf16 design. The TPU kernel keeps a (t+4) x (W+4) x Cin input slab in VMEM, ~1.4
// MB at block 4 and far over the 227 KB of shared memory a block may use. A block
// here owns one image, a 16 x 12 output tile and 48 expanded channels (every B5
// width is a multiple of 48, so no channel tile is ragged there):
//   expand: a GEMM with M = the (16+K-1) x (12+K-1) halo positions, N = 48, K =
//     Cin, on mma.sync m16n8k16 (bf16 in, fp32 sums in registers). Each of the 8
//     warps owns every 8th group of 16 positions and all 6 n8 tiles. Operands come
//     from shared memory by ldmatrix (B transposed from the row-major [Cin, Cexp]
//     weight). Input rows and weights arrive as 16-byte cp.async copies, 32 input
//     channels a stage, two stages, so the next chunk is in flight during the
//     products; out-of-image positions and channel tails are zero-filled (src-size
//     0), and a chunk runs only the k16 steps it has (Cin = 40 costs 48, not 64).
//     Rows are padded by 16 bytes, so ldmatrix is free of bank conflicts.
//   epilogue: BN1 on the fp32 sums (`bn_bf16`, as flax's BatchNorm: (v - mean) * mul +
//     bias, the subtraction rounded, the product and the sum one FMA, as XLA's CPU
//     program computes it), rounded to bf16, then the SiLU as the JAX
//     package's bf16 program computes it (`silu_bf16`), zeros at out-of-image halo
//     positions (the depthwise must see SAME zeros, not silu(bn1 bias) of a zero
//     input), into shared memory as bf16 (over the stages, which are done).
//   depthwise: two channels a thread (bf16x2), a register window sliding along 6
//     output columns (each input read once per output row), K*K weights in
//     registers, fp32 sums, BN2 (`bn_bf16`) rounded to bf16, `silu_bf16`; the output tile is
//     staged in shared memory and stored as 16-byte vectors. Each item's two squeeze
//     sums stay in registers, then go to a static 32 x 48 f32 array (6 KB).
//   The roundings are the ones XLA's CPU program of the JAX MBConv block makes at
//   bf16: the convolutions' fp32 sums enter the BatchNorms unrounded (the
//   BatchNorm promotes them to fp32, which absorbs their rounding), each
//   BatchNorm's result is rounded, and so is each op of the SiLU.
// Halo recompute is 18*14/192 = 1.31 of the expand for K = 3, 20*16/192 = 1.67 for
// K = 5. The tile is 16 x 12 rather than 16 x 16 so that the sums, the epilogue
// and the depthwise fit 128 registers: two blocks an SM, so that one block's copies
// and barriers overlap another's math; and 228 = 19 x 12 columns at blocks 4-7.
// Past the MMAs the work is ~2.3 SiLUs (SFU) and K*K fp32 FMAs per output.
// Widths that are not multiples of 8, or unaligned pointers, stage and store
// element by element instead of the 16-byte paths.
//
// fp32 design: 3xTF32 on the tensor cores. The tensor cores take fp32 only as tf32
// (a 10-bit mantissa, ~3 decimal digits), which the port's float32 policy (TF32 off,
// as the JAX package's fp32 path) forbids for a single product. Each operand v is
// split as big = tf32(v) and small = tf32(v - big) (round to nearest), so v = big +
// small to ~2^-22 |v|; each k8 step computes big*big, then small*big + big*small,
// in mma.sync m16n8k8 (tf32 in, fp32 sums), and small*small (~2^-22) is dropped.
// The tensor cores truncate as they accumulate, so each k8 step starts its own sum
// from zero and joins the running sum by an fp32 add: summed in the tensor cores
// over all of Cin, the truncation drifts by ~1e-5 relative at Cin 512 (measured on
// the H100); this way the kernel is within ~4e-7 (1 + |x|) of float64, as float32
// products are, where one tf32 pass is off by ~2e-4 to 4e-4 (tests/_mbconv_f64.py).
// x is split as its fragments are loaded (by the two warps that share an m16 tile),
// the weight as its fragments are loaded, in every warp and every block: three
// instructions a value beside three MMAs, where a split once in the wrapper or the
// tower's cached front weights would add a launch or a second weight tensor and
// another C interface.
// A block owns one image, a 16 x 15 output tile and 48 expanded channels:
//   expand: M = the (16+K-1) x (15+K-1) halo positions (306 for K = 3, 380 for K =
//     5: 20 and 24 m16 tiles), N = 48, K = Cin; 8 warps as 4 along M x 2 along N,
//     each with every 4th m16 tile and 3 n8 tiles. x arrives as 16-byte cp.async
//     copies, 16 input channels a stage (two k8 steps), three stages, two chunks in
//     flight during the products; A fragments by ldmatrix (8 x 4 words; rows padded
//     by 16 bytes, free of bank conflicts), B fragments by 32-bit loads from the
//     row-major [Cin, Cexp] weight (rows padded to 56 words, free of conflicts).
//     Out-of-image positions and channel tails are zero-filled, and a chunk runs only
//     the k8 steps it has (Cin = 40 costs five).
//   epilogue: BN1 from the sums into the fp32 expanded tile in shared memory (over
//     the stages), exact zeros at out-of-image halo positions (SAME zeros for the
//     depthwise; silu(0) = 0), then SiLU over the tile in a pass of its own, once the
//     sums' registers are free (16-byte vectors; fast exponential and division).
//   depthwise: one channel a thread, a register window sliding along 5 output
//     columns, K*K fp32 weights in registers, BN2 + SiLU, stored from registers (a
//     warp writes 32 neighbouring channels: whole 32-byte sectors). Each item's
//     squeeze sum goes to 48 x 48 floats past the expanded tile, in the stages'
//     space (9 KB; a static array would cost the second block an SM).
//   Both BatchNorms are folded as the block loads them: scale mul, shift bias - mean
//   * mul (fp32 keeps the fold: no rounding to match, and fewer live values).
// 16 x 15 rather than the bf16 16 x 12: 29 columns (the 48 x 29 deep blocks) split
// into 2 tiles of 15 instead of 3 of 12, whose last is 5 wide; the halo recompute is
// 20*16/240 = 1.33 (K = 3) and 24*16/240 = 1.6 (K = 5) with the m16 padding. The
// shared memory (3 stages of 29-34 KB, or the 68-85 KB expanded tile) and 128
// registers a thread allow two blocks an SM (8 x 15 tiles at three blocks an SM
// were slower at the five B5 shapes timed: 40->240 k3, 64->384 k5, 176->1056 k5,
// 304->1824 k5 and 512->3072 k3).
// Widths that are not multiples of 4, or unaligned pointers, stage element by
// element instead of the 16-byte copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

// SiLU by the fast exponential and division: a few fp32 ulps (as accurate as the fp32
// sums before it); the SiLUs are most of the work past the MMAs, and the accurate
// expf and IEEE division cost several instructions more. The fp32 path's SiLU.
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

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
__device__ __forceinline__ float silu_bf16(float a) {
  const float d = bf16_round(1.0f + bf16_round(expf(-a)));
  const float r = bf16_round(__frcp_rn(d));
  return __fmul_rn(a, r < 1.17549435e-38f ? 0.0f : r);
}

// The two BatchNorms' vectors [Cexp] f32, passed by value: mean, mul, bias of BN1,
// then of BN2. `at` selects without indexing the parameter array by a runtime value
// (which would copy it to local memory).
struct Bn {
  const float* mean1;
  const float* mul1;
  const float* bias1;
  const float* mean2;
  const float* mul2;
  const float* bias2;
  __device__ __forceinline__ const float* at(int r) const {
    return r == 0 ? mean1 : r == 1 ? mul1 : r == 2 ? bias1 : r == 3 ? mean2 : r == 4 ? mul2 : bias2;
  }
};

// Adds each (image, channel)'s tile partials [B, tiles, cpad] (cpad: Cexp rounded up
// to the 48-channel tile) in tile order: the squeeze [B, Cexp]. One thread an (image,
// channel); neighbouring threads read neighbouring channels.
__global__ void squeeze_tiles_kernel(const float* __restrict__ partials,
                                     float* __restrict__ squeeze, int tiles, int cexp,
                                     int cpad, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = partials + (i / cexp) * tiles * cpad + i % cexp;
  float s = 0.0f;
#pragma unroll 8
  for (int t = 0; t < tiles; ++t) s += p[static_cast<int64_t>(t) * cpad];
  squeeze[i] = s;
}

constexpr int CHANNEL_TILE = 48;  // expanded channels a block, both paths

// ---------------------------------------------------------------- bf16, tensor cores
namespace tc {

constexpr int TH = 16;            // output rows per block
constexpr int TW = 12;            // output columns per block
constexpr int SEG = TW / 2;       // output columns of one depthwise window
constexpr int CT = CHANNEL_TILE;  // expanded channels per block
constexpr int NT = CT / 8;        // n8 tiles of the expand
constexpr int KC = 32;            // input channels per stage (two k16 steps)
constexpr int STAGES = 2;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int XS = KC + 8;        // input row stride (bf16): 80 bytes
constexpr int WS = CT + 8;        // weight row stride: 112 bytes
constexpr int ES = CT + 8;        // expanded / output tile row stride: 112 bytes

template <int K>
struct Geometry {
  static constexpr int WP = TW + K - 1;
  static constexpr int NP = (TH + K - 1) * WP;      // halo positions
  static constexpr int MT = (NP + 15) / 16;         // m16 tiles of the expand
  static constexpr int MPW = (MT + WARPS - 1) / WARPS;
  static constexpr int ROWS = MT * 16;
  static constexpr int STAGE = ROWS * XS + KC * WS;  // bf16 elements
  static constexpr int SMEM_A = STAGES * STAGE * 2;
  static constexpr int SMEM_B = (NP + TH * TW) * ES * 2;
  static constexpr int SMEM = SMEM_A > SMEM_B ? SMEM_A : SMEM_B;
};

template <int K>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM: one's copies, another's math
expand_dw_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_exp,
                      Bn bn, const bf16* __restrict__ w_dw, bf16* __restrict__ out,
                      float* __restrict__ partials, int H, int W, int cin, int cexp, int tiles_w,
                      int vec) {
  using G = Geometry<K>;
  constexpr int PAD = (K - 1) / 2;
  constexpr int SEGS_W = TW / SEG;                   // depthwise items along a row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_bn[6][CT];                      // mean, mul, bias of BN1, then BN2
  __shared__ __align__(8) float s_wdw[K * K][CT];
  __shared__ __align__(8) float s_sq[TH * SEGS_W][CT];  // the depthwise items' squeeze sums
  bf16* const sm = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CT;
  const int y0 = (blockIdx.y / tiles_w) * TH;
  const int x0 = (blockIdx.y % tiles_w) * TW;
  const int64_t img = blockIdx.z;
  const bf16* const ximg = x + img * H * W * cin;

  for (int i = tid; i < 6 * CT; i += THREADS) {
    const int r = i / CT, c = c0 + i % CT;
    s_bn[r][i % CT] = c < cexp ? bn.at(r)[c] : 0.0f;
  }
  for (int i = tid; i < K * K * CT; i += THREADS) {
    const int t = i / CT, c = c0 + i % CT;
    s_wdw[t][i % CT] = c < cexp ? __bfloat162float(w_dw[(int64_t)t * cexp + c]) : 0.0f;
  }
  __syncthreads();

  // one stage: the halo rows' KC input channels and the KC x CT weight block. The
  // loops stay rolled: unrolled, their addresses spill registers of the sums
  auto load_stage = [&](int s, int ci0) {
    bf16* const xs = sm + s * G::STAGE;
    bf16* const ws = xs + G::ROWS * XS;
    if (vec) {
#pragma unroll 1
      for (int i = tid; i < G::NP * (KC / 8); i += THREADS) {
        const int p = i / (KC / 8), seg = i % (KC / 8);
        const int gy = y0 - PAD + p / G::WP, gx = x0 - PAD + p % G::WP, ci = ci0 + seg * 8;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ci < cin;
        const bf16* src = ok ? ximg + ((int64_t)gy * W + gx) * cin + ci : x;
        hopper::cp_async16(hopper::smem_addr(xs + p * XS + seg * 8), src, ok ? 16 : 0);
      }
#pragma unroll 1
      for (int i = tid; i < KC * (CT / 8); i += THREADS) {
        const int r = i / (CT / 8), seg = i % (CT / 8);
        const int ci = ci0 + r, c = c0 + seg * 8;
        const bool ok = ci < cin && c < cexp;
        const bf16* src = ok ? w_exp + (int64_t)ci * cexp + c : w_exp;
        hopper::cp_async16(hopper::smem_addr(ws + r * WS + seg * 8), src, ok ? 16 : 0);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll 1
      for (int i = tid; i < G::NP * KC; i += THREADS) {
        const int p = i / KC, ci = ci0 + i % KC;
        const int gy = y0 - PAD + p / G::WP, gx = x0 - PAD + p % G::WP;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ci < cin;
        xs[p * XS + i % KC] = ok ? ximg[((int64_t)gy * W + gx) * cin + ci] : zero;
      }
#pragma unroll 1
      for (int i = tid; i < KC * CT; i += THREADS) {
        const int ci = ci0 + i / CT, c = c0 + i % CT;
        ws[(i / CT) * WS + i % CT] =
            ci < cin && c < cexp ? w_exp[(int64_t)ci * cexp + c] : zero;
      }
    }
  };

  // ---- expand on the tensor cores, two stages of cp.async in flight
  float acc[G::MPW][NT][4];
#pragma unroll
  for (int mi = 0; mi < G::MPW; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nt][q] = 0.0f;

  // one commit group per chunk (empty past the last), so group ch is complete once
  // at most STAGES - 1 newer groups are pending
  const int nchunks = (cin + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_stage(s, s * KC);
    hopper::cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    const int next = ch + STAGES - 1;
    if (next < nchunks) load_stage(next % STAGES, next * KC);
    hopper::cp_async_commit();
    hopper::cp_async_wait<STAGES - 1>();
    __syncthreads();  // this chunk's stage is complete for every thread
    const bf16* const xs = sm + (ch % STAGES) * G::STAGE;
    const bf16* const ws = xs + G::ROWS * XS;
    const int ksteps = (min(KC, cin - ch * KC) + 15) / 16;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      if (ks < ksteps) {
        const int kk = ks * 16;
        uint32_t b[NT][2];
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t r[4];
          hopper::ldmatrix_x4_trans(
              r, hopper::smem_addr(ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WS + j * 16 +
                                   (lane >> 4) * 8));
          b[2 * j][0] = r[0];
          b[2 * j][1] = r[1];
          b[2 * j + 1][0] = r[2];
          b[2 * j + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < G::MPW; ++mi) {
          const int mt = warp + mi * WARPS;
          if (mt < G::MT) {
            uint32_t a[4];
            hopper::ldmatrix_x4(
                a, hopper::smem_addr(xs + (mt * 16 + (lane & 15)) * XS + kk + (lane >> 4) * 8));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) hopper::mma_bf16_16816(acc[mi][nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // ---- BN1 + SiLU, SAME zeros outside the image, bf16 expanded tile over the stages
  bf16* const es = sm;                 // [NP][ES]
  bf16* const os = sm + G::NP * ES;    // [TH * TW][ES]
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < G::MPW; ++mi) {
    const int mt = warp + mi * WARPS;
    if (mt >= G::MT) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + h * 8;
      if (p >= G::NP) continue;
      const int gy = y0 - PAD + p / G::WP, gx = x0 - PAD + p % G::WP;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + q2;
        const float v0 = silu_bf16(
            bf16_round(bn_bf16(acc[mi][nt][2 * h], s_bn[0][c], s_bn[1][c], s_bn[2][c])));
        const float v1 = silu_bf16(bf16_round(
            bn_bf16(acc[mi][nt][2 * h + 1], s_bn[0][c + 1], s_bn[1][c + 1], s_bn[2][c + 1])));
        *reinterpret_cast<__nv_bfloat162*>(es + p * ES + c) =
            inside ? __floats2bfloat162_rn(v0, v1) : __float2bfloat162_rn(0.0f);
      }
    }
  }
  __syncthreads();

  // ---- depthwise K x K, two channels a thread, a window sliding along SEG columns;
  // each item sums its outputs inside the image (the squeeze) in column order
  constexpr int PAIRS = CT / 2;
  constexpr int ITEMS = PAIRS * TH * SEGS_W;
  for (int it = tid; it < ITEMS; it += THREADS) {
    const int c = (it % PAIRS) * 2, rest = it / PAIRS;
    const int r = rest / SEGS_W, col0 = (rest % SEGS_W) * SEG;
    if (y0 + r >= H) {
      *reinterpret_cast<float2*>(&s_sq[rest][c]) = make_float2(0.0f, 0.0f);
      continue;
    }
    float2 wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = *reinterpret_cast<const float2*>(&s_wdw[t][c]);
    const float m0 = s_bn[3][c], m1 = s_bn[3][c + 1], mu0 = s_bn[4][c], mu1 = s_bn[4][c + 1];
    const float bi0 = s_bn[5][c], bi1 = s_bn[5][c + 1];
    float sq0 = 0.0f, sq1 = 0.0f;
    float2 win[K][K];
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) win[dy][dx] = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < SEG + K - 1; ++j) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K - 1; ++dx) win[dy][dx] = win[dy][dx + 1];
        win[dy][K - 1] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            es + ((r + dy) * G::WP + col0 + j) * ES + c));
      }
      if (j >= K - 1) {
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            a0 = fmaf(win[dy][dx].x, wk[dy * K + dx].x, a0);
            a1 = fmaf(win[dy][dx].y, wk[dy * K + dx].y, a1);
          }
        const float v0 = silu_bf16(bf16_round(bn_bf16(a0, m0, mu0, bi0)));
        const float v1 = silu_bf16(bf16_round(bn_bf16(a1, m1, mu1, bi1)));
        const int col = col0 + j - (K - 1);
        *reinterpret_cast<__nv_bfloat162*>(os + (r * TW + col) * ES + c) =
            __floats2bfloat162_rn(v0, v1);
        if (x0 + col < W) {
          sq0 += v0;
          sq1 += v1;
        }
      }
    }
    *reinterpret_cast<float2*>(&s_sq[rest][c]) = make_float2(sq0, sq1);
  }
  __syncthreads();

  // ---- the tile's squeeze partial: one thread a channel adds the items in order
  if (tid < CT) {
    float s = 0.0f;
#pragma unroll 8
    for (int i = 0; i < TH * SEGS_W; ++i) s += s_sq[i][tid];
    partials[((img * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * CT + tid] = s;
  }

  // ---- store: 16 bytes a thread, masked at the image and channel edges
  constexpr int SEGS = CT / 8;
  for (int i = tid; i < TH * TW * SEGS; i += THREADS) {
    const int pos = i / SEGS, s = i % SEGS;
    const int gy = y0 + pos / TW, gx = x0 + pos % TW, c = c0 + s * 8;
    if (gy >= H || gx >= W || c >= cexp) continue;
    bf16* const dst = out + ((img * H + gy) * W + gx) * cexp + c;
    const bf16* const src = os + pos * ES + s * 8;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < cexp; ++e) dst[e] = src[e];
    }
  }
}

template <int K>
int launch_bf16(const void* x, const void* w_exp, const Bn& bn, const void* w_dw, void* out,
                void* partials, int batch, int H, int W, int cin, int cexp, cudaStream_t stream) {
  using G = Geometry<K>;
  auto kernel = expand_dw_bf16_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + TW - 1) / TW;
  const int64_t tiles = static_cast<int64_t>((H + TH - 1) / TH) * tiles_w;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = cin % 8 == 0 && cexp % 8 == 0 && aligned(x) && aligned(w_exp) && aligned(out);
  // channel tiles run fastest, so the blocks that share a halo tile share it in L2
  const dim3 grid((cexp + CT - 1) / CT, static_cast<unsigned>(tiles), batch);
  kernel<<<grid, THREADS, G::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_exp), bn,
      static_cast<const bf16*>(w_dw), static_cast<bf16*>(out), static_cast<float*>(partials), H,
      W, cin, cexp, tiles_w, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------- fp32, 3xTF32 tensor cores
namespace f32 {

constexpr int TH = 16;            // output rows per block
constexpr int TW = 15;            // output columns per block
constexpr int SEG = 5;            // output columns of one depthwise window
constexpr int CT = CHANNEL_TILE;  // expanded channels per block
constexpr int NT = CT / 8;        // n8 tiles of the expand
constexpr int WARPS_M = 4;        // warps along the halo positions
constexpr int WARPS_N = 2;        // warps along the channels
constexpr int NPW = NT / WARPS_N;  // n8 tiles of a warp
constexpr int KC = 16;            // input channels per stage (two k8 steps)
constexpr int STAGES = 3;
constexpr int THREADS = WARPS_M * WARPS_N * 32;
constexpr int XS = KC + 4;        // input row stride (floats): 80 bytes
constexpr int WS = CT + 8;        // weight row stride: 224 bytes
constexpr int ES = CT + 8;        // expanded tile row stride

template <int K>
struct Geometry {
  static constexpr int WP = TW + K - 1;
  static constexpr int NP = (TH + K - 1) * WP;      // halo positions
  static constexpr int MT = (NP + 15) / 16;         // m16 tiles of the expand
  static constexpr int MPW = (MT + WARPS_M - 1) / WARPS_M;
  static constexpr int ROWS = MT * 16;
  static constexpr int STAGE = ROWS * XS + KC * WS;  // floats
  static constexpr int ITEMS_TILE = TH * (TW / SEG);  // depthwise items of a channel
  static constexpr int SMEM_A = STAGES * STAGE * 4;
  // the expanded tile, then the items' squeeze sums (within the stages' space)
  static constexpr int SMEM_B = (NP * ES + ITEMS_TILE * CT) * 4;
  static constexpr int SMEM = SMEM_A > SMEM_B ? SMEM_A : SMEM_B;
};

template <int K>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM: one's copies, another's math
expand_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ w_exp, Bn bn,
                     const float* __restrict__ w_dw, float* __restrict__ out,
                     float* __restrict__ partials, int H, int W, int cin, int cexp, int ctiles,
                     int tiles_w, int vec) {
  using G = Geometry<K>;
  constexpr int PAD = (K - 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_bn[4][CT];                      // BN1 scale, shift, BN2 scale, shift
  __shared__ __align__(8) float s_wdw[K * K][CT];
  float* const sm = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  // channel tiles run fastest, so the blocks that share a halo tile share it in L2
  const int c0 = (blockIdx.x % ctiles) * CT;
  const int tile = blockIdx.x / ctiles;
  const int y0 = (tile / tiles_w) * TH;
  const int x0 = (tile % tiles_w) * TW;
  const int64_t img = blockIdx.y;
  const float* const ximg = x + img * H * W * cin;

  // each BatchNorm folded: scale mul, shift bias - mean * mul (the plain version's
  // float32 arithmetic, each op rounded)
  for (int i = tid; i < 2 * CT; i += THREADS) {
    const int n = i / CT, c = c0 + i % CT;
    float scale = 0.0f, shift = 0.0f;
    if (c < cexp) {
      scale = bn.at(3 * n + 1)[c];
      shift = __fsub_rn(bn.at(3 * n + 2)[c], __fmul_rn(bn.at(3 * n)[c], scale));
    }
    s_bn[2 * n][i % CT] = scale;
    s_bn[2 * n + 1][i % CT] = shift;
  }
  for (int i = tid; i < K * K * CT; i += THREADS) {
    const int t = i / CT, c = c0 + i % CT;
    s_wdw[t][i % CT] = c < cexp ? w_dw[(int64_t)t * cexp + c] : 0.0f;
  }

  // one stage: the halo rows' KC input channels and the KC x CT weight block,
  // zero-filled outside the image and past the channel tails
  auto load_stage = [&](int s, int ci0) {
    float* const xs = sm + s * G::STAGE;
    float* const ws = xs + G::ROWS * XS;
    if (vec) {
#pragma unroll 1
      for (int i = tid; i < G::NP * (KC / 4); i += THREADS) {
        const int p = i / (KC / 4), seg = i % (KC / 4);
        const int gy = y0 - PAD + p / G::WP, gx = x0 - PAD + p % G::WP, ci = ci0 + seg * 4;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ci < cin;
        const float* src = ok ? ximg + ((int64_t)gy * W + gx) * cin + ci : x;
        hopper::cp_async16(hopper::smem_addr(xs + p * XS + seg * 4), src, ok ? 16 : 0);
      }
#pragma unroll 1
      for (int i = tid; i < KC * (CT / 4); i += THREADS) {
        const int r = i / (CT / 4), seg = i % (CT / 4);
        const int ci = ci0 + r, c = c0 + seg * 4;
        const bool ok = ci < cin && c < cexp;
        const float* src = ok ? w_exp + (int64_t)ci * cexp + c : w_exp;
        hopper::cp_async16(hopper::smem_addr(ws + r * WS + seg * 4), src, ok ? 16 : 0);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < G::NP * KC; i += THREADS) {
        const int p = i / KC, ci = ci0 + i % KC;
        const int gy = y0 - PAD + p / G::WP, gx = x0 - PAD + p % G::WP;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ci < cin;
        xs[p * XS + i % KC] = ok ? ximg[((int64_t)gy * W + gx) * cin + ci] : 0.0f;
      }
#pragma unroll 1
      for (int i = tid; i < KC * CT; i += THREADS) {
        const int ci = ci0 + i / CT, c = c0 + i % CT;
        ws[(i / CT) * WS + i % CT] = ci < cin && c < cexp ? w_exp[(int64_t)ci * cexp + c] : 0.0f;
      }
    }
  };

  // ---- expand on the tensor cores as 3xTF32, STAGES - 1 chunks of cp.async in flight
  float acc[G::MPW][NPW][4];
#pragma unroll
  for (int mi = 0; mi < G::MPW; ++mi)
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.0f;

  const int g = lane >> 2, t4 = lane & 3;
  // one commit group per chunk (empty past the last), so chunk ch is complete once at
  // most STAGES - 2 newer groups are pending
  const int nchunks = (cin + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_stage(s, s * KC);
    hopper::cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    hopper::cp_async_wait<STAGES - 2>();
    // chunk ch is complete for every thread, and every warp is done with chunk ch - 1,
    // whose stage the next load refills
    __syncthreads();
    const int next = ch + STAGES - 1;
    if (next < nchunks) load_stage(next % STAGES, next * KC);
    hopper::cp_async_commit();
    const float* const xs = sm + (ch % STAGES) * G::STAGE;
    const float* const ws = xs + G::ROWS * XS;
    const int ksteps = (min(KC, cin - ch * KC) + 7) / 8;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      if (ks < ksteps) {
        const int kk = ks * 8;
        uint32_t bh[NPW][2], bl[NPW][2];
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          const float* const wcol = ws + (kk + t4) * WS + (wn * NPW + j) * 8 + g;
          hopper::split_tf32(wcol[0], bh[j][0], bl[j][0]);
          hopper::split_tf32(wcol[4 * WS], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int mi = 0; mi < G::MPW; ++mi) {
          const int mt = wm + mi * WARPS_M;
          if (mt < G::MT) {
            uint32_t a[4], ah[4], al[4];
            hopper::ldmatrix_x4(
                a, hopper::smem_addr(xs + (mt * 16 + (lane & 15)) * XS + kk + (lane >> 4) * 4));
#pragma unroll
            for (int q = 0; q < 4; ++q) hopper::split_tf32(__uint_as_float(a[q]), ah[q], al[q]);
            // big x big, then the small products into this k8 step's own sum, which joins
            // the running sum by an fp32 add (the tensor cores truncate as they
            // accumulate: over all of Cin in their sums that drifts by ~1e-5 at Cin 512);
            // small x small (~2^-22) is dropped
            float part[NPW][4];
#pragma unroll
            for (int j = 0; j < NPW; ++j) hopper::mma_tf32_1688_zero(part[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
            for (int j = 0; j < NPW; ++j) hopper::mma_tf32_1688(part[j], al, bh[j][0], bh[j][1]);
#pragma unroll
            for (int j = 0; j < NPW; ++j) hopper::mma_tf32_1688(part[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
            for (int j = 0; j < NPW; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[mi][j][q] += part[j][q];
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the stages, which the expanded tile overwrites

  // ---- BN1, then SiLU, SAME zeros outside the image, the fp32 expanded tile over the
  // stages. BN1 is applied from the sums and zeros written outside the image
  // (silu(0) = 0); the SiLUs follow in a pass of their own, once the sums' registers
  // are free
  float* const es = sm;  // [NP][ES]
#pragma unroll
  for (int mi = 0; mi < G::MPW; ++mi) {
    const int mt = wm + mi * WARPS_M;
    if (mt >= G::MT) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + h * 8;
      if (p >= G::NP) continue;
      const int gy = y0 - PAD + p / G::WP, gx = x0 - PAD + p % G::WP;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int c = (wn * NPW + j) * 8 + t4 * 2;
        const float v0 = fmaf(acc[mi][j][2 * h], s_bn[0][c], s_bn[1][c]);
        const float v1 = fmaf(acc[mi][j][2 * h + 1], s_bn[0][c + 1], s_bn[1][c + 1]);
        *reinterpret_cast<float2*>(es + p * ES + c) =
            inside ? make_float2(v0, v1) : make_float2(0.0f, 0.0f);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G::NP * (CT / 4); i += THREADS) {
    float4* const e4 = reinterpret_cast<float4*>(es + (i / (CT / 4)) * ES) + i % (CT / 4);
    const float4 v = *e4;
    *e4 = make_float4(silu_fast(v.x), silu_fast(v.y), silu_fast(v.z), silu_fast(v.w));
  }
  __syncthreads();

  // ---- depthwise K x K, one channel a thread (a warp reads 32 neighbouring channels),
  // a window sliding along SEG columns, BN2 + SiLU, stored from registers (a warp
  // writes whole 32-byte sectors); a channel a thread keeps the K = 5 window and
  // weights in 50 registers. Each item sums its outputs (the squeeze) in column order
  // in a register; the output offset is 32-bit (the caller keeps B H W Cexp under
  // 2^31), which leaves the accumulator room under the 128-register cap at K = 5
  float* const s_sq = sm + G::NP * ES;  // [ITEMS_TILE][CT]
  constexpr int ITEMS = CT * G::ITEMS_TILE;
  for (int it = tid; it < ITEMS; it += THREADS) {
    const int c = it % CT, rest = it / CT;
    const int r = rest / (TW / SEG), col0 = (rest % (TW / SEG)) * SEG;
    const int gy = y0 + r;
    if (gy >= H || x0 + col0 >= W || c0 + c >= cexp) {
      s_sq[it] = 0.0f;  // it = rest * CT + c: the item's slot, [ITEMS_TILE][CT]
      continue;
    }
    float sq = 0.0f;
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = s_wdw[t][c];
    const float sc = s_bn[2][c], bi = s_bn[3][c];
    const int orow = ((static_cast<int>(img) * H + gy) * W + x0 + col0) * cexp + c0 + c;
    float win[K][K];
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) win[dy][dx] = 0.0f;
#pragma unroll
    for (int j = 0; j < SEG + K - 1; ++j) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K - 1; ++dx) win[dy][dx] = win[dy][dx + 1];
        win[dy][K - 1] = es[((r + dy) * G::WP + col0 + j) * ES + c];
      }
      const int col = j - (K - 1);
      if (col >= 0 && x0 + col0 + col < W) {
        float a = 0.0f;
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx) a = fmaf(win[dy][dx], wk[dy * K + dx], a);
        const float v = silu_fast(fmaf(a, sc, bi));
        out[orow + col * cexp] = v;
        sq += v;
      }
    }
    s_sq[it] = sq;
  }
  __syncthreads();

  // ---- the tile's squeeze partial: one thread a channel adds the items in order; the
  // index comes from the block's coordinates alone (no value kept live through the
  // expand for it: at the 128-register cap that spills)
  if (tid < CT) {
    float s = 0.0f;
#pragma unroll 8
    for (int i = 0; i < G::ITEMS_TILE; ++i) s += s_sq[i * CT + tid];
    partials[(static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * CT + tid] = s;
  }
}

template <int K>
int launch_f32(const void* x, const void* w_exp, const Bn& bn, const void* w_dw, void* out,
               void* partials, int batch, int H, int W, int cin, int cexp, cudaStream_t stream) {
  using G = Geometry<K>;
  auto kernel = expand_dw_f32_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two blocks an SM need ~2 x 108 KB: ask for the largest shared-memory carveout
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctiles = (cexp + CT - 1) / CT;
  const int tiles_w = (W + TW - 1) / TW;
  const int64_t blocks = static_cast<int64_t>((H + TH - 1) / TH) * tiles_w * ctiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the depthwise's 32-bit output offsets
  if (static_cast<int64_t>(batch) * H * W * cexp > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = cin % 4 == 0 && cexp % 4 == 0 && aligned(x) && aligned(w_exp);
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  kernel<<<grid, THREADS, G::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_exp), bn,
      static_cast<const float*>(w_dw), static_cast<float*>(out), static_cast<float*>(partials),
      H, W, cin, cexp, ctiles, tiles_w, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// Output tiles of one image and channel tile (the partials' middle dimension):
// dtype 0 = float32, 1 = bfloat16.
extern "C" int mbconv_expand_dw_tiles(int dtype, int H, int W) {
  const int th = dtype == 1 ? tc::TH : f32::TH, tw = dtype == 1 ? tc::TW : f32::TW;
  return ((H + th - 1) / th) * ((W + tw - 1) / tw);
}

// The partials' last dimension: Cexp rounded up to the channel tile.
extern "C" int mbconv_expand_dw_channels(int cexp) {
  return (cexp + CHANNEL_TILE - 1) / CHANNEL_TILE * CHANNEL_TILE;
}

// dtype: 0 = float32, 1 = bfloat16. k: 3 or 5. bn1, bn2: mean, mul and bias [Cexp] f32
// each. partials: f32 scratch of [batch, mbconv_expand_dw_tiles(dtype, H, W),
// mbconv_expand_dw_channels(cexp)];
// squeeze [batch, cexp] f32. Launches the kernel, then `squeeze_tiles_kernel`, on
// `stream`. Returns a cudaError_t value (cudaErrorInvalidValue for an unsupported
// dtype or k).
extern "C" int mbconv_expand_dw(int dtype, int k, const void* x, const void* w_exp,
                                const void* mean1, const void* mul1, const void* bias1,
                                const void* w_dw, const void* mean2, const void* mul2,
                                const void* bias2, void* out, void* squeeze, void* partials,
                                int batch, int H, int W, int cin, int cexp, void* stream) {
  if (batch == 0 || cexp == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 0 || W == 0)
    return static_cast<int>(cudaMemsetAsync(squeeze, 0, sizeof(float) * batch * cexp, st));
  const Bn bn{static_cast<const float*>(mean1), static_cast<const float*>(mul1),
              static_cast<const float*>(bias1), static_cast<const float*>(mean2),
              static_cast<const float*>(mul2), static_cast<const float*>(bias2)};
  int err;
  if (dtype == 0 && k == 3)
    err = f32::launch_f32<3>(x, w_exp, bn, w_dw, out, partials, batch, H, W, cin, cexp, st);
  else if (dtype == 0 && k == 5)
    err = f32::launch_f32<5>(x, w_exp, bn, w_dw, out, partials, batch, H, W, cin, cexp, st);
  else if (dtype == 1 && k == 3)
    err = tc::launch_bf16<3>(x, w_exp, bn, w_dw, out, partials, batch, H, W, cin, cexp, st);
  else if (dtype == 1 && k == 5)
    err = tc::launch_bf16<5>(x, w_exp, bn, w_dw, out, partials, batch, H, W, cin, cexp, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const int64_t n = static_cast<int64_t>(batch) * cexp;
  squeeze_tiles_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(squeeze),
      mbconv_expand_dw_tiles(dtype, H, W), cexp, mbconv_expand_dw_channels(cexp), n);
  return static_cast<int>(cudaGetLastError());
}
