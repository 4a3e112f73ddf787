// MBConv front half for Hopper (sm_90a): 1x1 expand -> folded BN + SiLU ->
// k x k stride-1 depthwise (SAME zeros) -> folded BN + SiLU, in one kernel.
//
//   x [B, H, W, Cin] (NHWC), w_exp [Cin, Cexp], w_dw [K, K, Cexp], all in T;
//   bn1/bn2 scale and bias [Cexp] f32  ->  out [B, H, W, Cexp] in T.
//   T is __nv_bfloat16 (the tower's main path) or float; every sum is fp32.
//
// Replaces the TPU kernel mammodissect/ops/pallas_mbconv.py::fused_expand_dw
// (body `_kernel`), generalised to what the EfficientNet-B5 tower needs: K in
// {3, 5}, any H and W (masked tail tiles), any Cin and Cexp (masked channel
// tails, no 128-lane padding), bf16 and fp32.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores, 67
// TFLOP/s fp32 outside them), per call: bytes B*H*W*(Cin+Cexp)*sizeof(T); expand
// 2*B*H*W*Cin*Cexp FLOPs (tensor cores); depthwise 2*K*K*B*H*W*Cexp FLOPs (fp32
// FMAs). The expanded tensor (Cexp/Cin = 6 times the input) never goes to device
// memory. At B5 widths the expand is ~95% of the FLOPs, so it runs on the tensor
// cores; the depthwise's fp32 FMAs are the rest.
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
//   epilogue: BN1 + SiLU in fp32, zeros at out-of-image halo positions (the
//     depthwise must see SAME zeros, not silu(bn1 bias) of a zero input), rounded
//     to bf16 as the unfused graph does, into shared memory as bf16 (over the
//     stages, which are done).
//   depthwise: two channels a thread (bf16x2), a register window sliding along 6
//     output columns (each input read once per output row), K*K weights in
//     registers, fp32 sums, BN2 + SiLU; the output tile is staged in shared
//     memory and stored as 16-byte vectors.
// Halo recompute is 18*14/192 = 1.31 of the expand for K = 3, 20*16/192 = 1.67 for
// K = 5. The tile is 16 x 12 rather than 16 x 16 so that the sums, the epilogue
// and the depthwise fit 128 registers: two blocks an SM, so that one block's copies
// and barriers overlap another's math; and 228 = 19 x 12 columns at blocks 4-7.
// Past the MMAs the work is ~2.3 SiLUs (SFU) and K*K fp32 FMAs per output.
// Widths that are not multiples of 8, or unaligned pointers, stage and store
// element by element instead of the 16-byte paths.
//
// fp32 stays on the CUDA cores (the tensor cores take fp32 only as TF32, which
// the port's TF32-off policy forbids): 8 x 16 output tiles, 64 channels, the
// expand as fp32 FMAs staged 32 input channels at a time, then the depthwise from
// shared memory. It serves the fp32 checks, not the bf16 main path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// ---------------------------------------------------------------- bf16, tensor cores
namespace tc {

constexpr int TH = 16;            // output rows per block
constexpr int TW = 12;            // output columns per block
constexpr int SEG = TW / 2;       // output columns of one depthwise window
constexpr int CT = 48;            // expanded channels per block
constexpr int NT = CT / 8;        // n8 tiles of the expand
constexpr int KC = 32;            // input channels per stage (two k16 steps)
constexpr int STAGES = 2;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int XS = KC + 8;        // input row stride (bf16): 80 bytes
constexpr int WS = CT + 8;        // weight row stride: 112 bytes
constexpr int ES = CT + 8;        // expanded / output tile row stride: 112 bytes

// SiLU for the bf16 path: the fast exponential and division (a few fp32 ulps, far
// below the bf16 rounding that follows); the SiLUs are most of the work past the
// MMAs, and the accurate expf and IEEE division cost several instructions more
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

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
                      const float* __restrict__ s1, const float* __restrict__ b1,
                      const bf16* __restrict__ w_dw, const float* __restrict__ s2,
                      const float* __restrict__ b2, bf16* __restrict__ out, int H, int W,
                      int cin, int cexp, int tiles_w, int vec) {
  using G = Geometry<K>;
  constexpr int PAD = (K - 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_bn[4][CT];                      // s1, b1, s2, b2 of the tile
  __shared__ __align__(8) float s_wdw[K * K][CT];
  bf16* const sm = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CT;
  const int y0 = (blockIdx.y / tiles_w) * TH;
  const int x0 = (blockIdx.y % tiles_w) * TW;
  const int64_t img = blockIdx.z;
  const bf16* const ximg = x + img * H * W * cin;

  for (int i = tid; i < 4 * CT; i += THREADS) {
    const int r = i / CT, c = c0 + i % CT;
    const float* v = r == 0 ? s1 : r == 1 ? b1 : r == 2 ? s2 : b2;
    s_bn[r][i % CT] = c < cexp ? v[c] : 0.0f;
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
        const float v0 = silu_fast(fmaf(acc[mi][nt][2 * h], s_bn[0][c], s_bn[1][c]));
        const float v1 = silu_fast(fmaf(acc[mi][nt][2 * h + 1], s_bn[0][c + 1], s_bn[1][c + 1]));
        *reinterpret_cast<__nv_bfloat162*>(es + p * ES + c) =
            inside ? __floats2bfloat162_rn(v0, v1) : __float2bfloat162_rn(0.0f);
      }
    }
  }
  __syncthreads();

  // ---- depthwise K x K, two channels a thread, a window sliding along SEG columns
  constexpr int PAIRS = CT / 2;
  constexpr int ITEMS = PAIRS * TH * (TW / SEG);
  for (int it = tid; it < ITEMS; it += THREADS) {
    const int c = (it % PAIRS) * 2, rest = it / PAIRS;
    const int r = rest / (TW / SEG), col0 = (rest % (TW / SEG)) * SEG;
    if (y0 + r >= H) continue;
    float2 wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = *reinterpret_cast<const float2*>(&s_wdw[t][c]);
    const float sc0 = s_bn[2][c], sc1 = s_bn[2][c + 1], bi0 = s_bn[3][c], bi1 = s_bn[3][c + 1];
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
        *reinterpret_cast<__nv_bfloat162*>(os + (r * TW + col0 + j - (K - 1)) * ES + c) =
            __floats2bfloat162_rn(silu_fast(fmaf(a0, sc0, bi0)), silu_fast(fmaf(a1, sc1, bi1)));
      }
    }
  }
  __syncthreads();

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
int launch_bf16(const void* x, const void* w_exp, const void* s1, const void* b1,
                const void* w_dw, const void* s2, const void* b2, void* out, int batch, int H,
                int W, int cin, int cexp, cudaStream_t stream) {
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
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_exp), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w_dw),
      static_cast<const float*>(s2), static_cast<const float*>(b2), static_cast<bf16*>(out), H,
      W, cin, cexp, tiles_w, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------- fp32, CUDA cores
namespace f32 {

constexpr int TH = 8;         // output rows per block
constexpr int TW = 16;        // output columns per block
constexpr int CT = 64;        // expanded channels per block
constexpr int CI = 32;        // input channels staged per pass
constexpr int THREADS = 256;
constexpr int CG = CT / 4;          // channel groups of 4 (expand)
constexpr int PG = THREADS / CG;    // position groups (expand)
constexpr int ROW_GROUPS = THREADS / CT;  // depthwise

template <int K>
struct Geometry {
  static constexpr int HP = TH + K - 1;
  static constexpr int WP = TW + K - 1;
  static constexpr int NP = HP * WP;                // halo positions
  static constexpr int NJ = (NP + PG - 1) / PG;     // positions per thread
  static constexpr int NP_PAD = NJ * PG;
  static constexpr int XS = CI + 1;                 // padded row: no bank conflicts
  static constexpr int SMEM_A = (NP_PAD * XS + CI * CT) * 4;
  static constexpr int SMEM_B = NP * CT * 4;
  static constexpr int SMEM = SMEM_A > SMEM_B ? SMEM_A : SMEM_B;
};

template <int K>
__global__ void __launch_bounds__(THREADS)
expand_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ w_exp,
                     const float* __restrict__ s1, const float* __restrict__ b1,
                     const float* __restrict__ w_dw, const float* __restrict__ s2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int H, int W, int cin, int cexp, int tiles_w) {
  using G = Geometry<K>;
  constexpr int PAD = (K - 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [NP_PAD][XS]   expand
  float* ws = xs + G::NP_PAD * G::XS;          // [CI][CT]       expand
  float* es = reinterpret_cast<float*>(smem);  // [NP][CT]       depthwise

  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int c0 = blockIdx.y * CT;
  const int64_t img = blockIdx.z;

  // ---- expand over the halo tile, sums in registers
  const int cg = tid % CG, pg = tid / CG;
  float acc[G::NJ][4];
#pragma unroll
  for (int j = 0; j < G::NJ; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
  }
  for (int ci0 = 0; ci0 < cin; ci0 += CI) {
    __syncthreads();  // the previous pass is done reading xs/ws
    for (int i = tid; i < G::NP_PAD * CI; i += THREADS) {
      const int p = i / CI, ci = i % CI;
      float v = 0.0f;
      if (p < G::NP && ci0 + ci < cin) {
        const int gy = y0 - PAD + p / G::WP, gx = x0 - PAD + p % G::WP;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = x[((img * H + gy) * W + gx) * cin + ci0 + ci];
      }
      xs[p * G::XS + ci] = v;
    }
    for (int i = tid; i < CI * CT; i += THREADS) {
      const int ci = i / CT, c = i % CT;
      ws[ci * CT + c] = ci0 + ci < cin && c0 + c < cexp ? w_exp[(int64_t)(ci0 + ci) * cexp + c0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ci = 0; ci < CI; ++ci) {
      const float4 wv = *reinterpret_cast<const float4*>(ws + ci * CT + cg * 4);
#pragma unroll
      for (int j = 0; j < G::NJ; ++j) {
        const float xv = xs[(pg + j * PG) * G::XS + ci];
        acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
        acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
        acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
        acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
      }
    }
  }

  // BN1 + SiLU, SAME zeros outside the image; es overwrites xs/ws
  float sc[4], bi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + cg * 4 + q;
    sc[q] = c < cexp ? s1[c] : 0.0f;
    bi[q] = c < cexp ? b1[c] : 0.0f;
  }
  __syncthreads();  // every thread is done with xs/ws
#pragma unroll
  for (int j = 0; j < G::NJ; ++j) {
    const int p = pg + j * PG;
    if (p < G::NP) {
      const int gy = y0 - PAD + p / G::WP, gx = x0 - PAD + p % G::WP;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) e[q] = inside ? silu(acc[j][q] * sc[q] + bi[q]) : 0.0f;
      *reinterpret_cast<float4*>(es + p * CT + cg * 4) = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  __syncthreads();

  // ---- depthwise K x K from shared memory, BN2 + SiLU
  const int c = tid % CT, rg = tid / CT;
  if (c0 + c >= cexp) return;
  float wk[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = w_dw[(int64_t)t * cexp + c0 + c];
  const float sc2 = s2[c0 + c], bi2 = b2[c0 + c];
  for (int r = rg; r < TH; r += ROW_GROUPS) {
    const int gy = y0 + r;
    if (gy >= H) break;
    for (int col = 0; col < TW; ++col) {
      const int gx = x0 + col;
      if (gx >= W) break;
      float a = 0.0f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          a = fmaf(es[((r + dy) * G::WP + col + dx) * CT + c], wk[dy * K + dx], a);
      }
      out[((img * H + gy) * W + gx) * cexp + c0 + c] = silu(a * sc2 + bi2);
    }
  }
}

template <int K>
int launch_f32(const void* x, const void* w_exp, const void* s1, const void* b1,
               const void* w_dw, const void* s2, const void* b2, void* out, int batch, int H,
               int W, int cin, int cexp, cudaStream_t stream) {
  using G = Geometry<K>;
  auto kernel = expand_dw_f32_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (cexp + CT - 1) / CT, batch);
  kernel<<<grid, THREADS, G::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_exp),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const float*>(w_dw), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<float*>(out), H, W, cin, cexp, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. k: 3 or 5. Returns a cudaError_t value
// (cudaErrorInvalidValue for an unsupported dtype or k).
extern "C" int mbconv_expand_dw(int dtype, int k, const void* x, const void* w_exp,
                                const void* s1, const void* b1, const void* w_dw,
                                const void* s2, const void* b2, void* out, int batch, int H,
                                int W, int cin, int cexp, void* stream) {
  if (batch == 0 || H == 0 || W == 0 || cexp == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && k == 3)
    return f32::launch_f32<3>(x, w_exp, s1, b1, w_dw, s2, b2, out, batch, H, W, cin, cexp, st);
  if (dtype == 0 && k == 5)
    return f32::launch_f32<5>(x, w_exp, s1, b1, w_dw, s2, b2, out, batch, H, W, cin, cexp, st);
  if (dtype == 1 && k == 3)
    return tc::launch_bf16<3>(x, w_exp, s1, b1, w_dw, s2, b2, out, batch, H, W, cin, cexp, st);
  if (dtype == 1 && k == 5)
    return tc::launch_bf16<5>(x, w_exp, s1, b1, w_dw, s2, b2, out, batch, H, W, cin, cexp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
