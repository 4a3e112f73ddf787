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
// tensor cores, 67 TFLOP/s fp32 outside them), per call, the larger of: bytes
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
// with no float atomics, so two launches give the same bits: each depthwise item sums
// its outputs in registers in a fixed order; after the block's barrier one thread a
// channel adds the items in order and writes the block's partial to partials [B,
// tiles, Cexp rounded up to 48] (f32 scratch from the caller; every B5 and V2-S width
// is a multiple of 48); a second kernel (`squeeze_tiles_kernel`) then adds each
// (image, channel)'s partials in tile order. A tile is a strip x segment: at block
// 4's 380 x 228 x 240, batch 16, the scratch is 16 x 48 x 240 x 4 = 0.7 MB, where a
// separate mean moves 10 bytes a value (the bf16 output read, an f32 copy written and
// read back): 3.3 GB there.
//
// bf16 design. Its bound (above) is 2.5 ms a B5 forward at batch 16. What holds it
// back is the work past the products and its latency: each output takes the JAX
// program's bf16 SiLU twice (`silu_bf16`: the accurate expf, three bf16 roundings,
// the IEEE reciprocal, a flush; ~8.7 G evaluations a forward in 16 x 12 tiles), two
// BatchNorms, their roundings and the depthwise's K*K fp32 FMAs, in short phases
// between barriers, on top of the halo recompute of small tiles and the staging
// around every tile. No single unit binds: leaving out the SiLUs, the depthwise's
// FMAs or the products each saved under a fifth of the time (PERF.md). The design:
//   the SiLU from a table: r of a bf16 input is a function of 65536 values, constant
//     outside |a| in [2^-8, 2^7); the 2 x 1922 values from the largest bf16 below
//     2^-8 to 2^7 are built once a device by the kernel's own chain (`sigmoid_bf16`)
//     and held in shared memory (7.5 KB), so a SiLU is a clamp of the magnitude, one
//     shared-memory load and one __fmul_rn, with the chain's bits (Inf and NaN take
//     the chain itself; `silu_tab`). It trades ALU work for shared-memory traffic
//     (a random 2-byte gather, ~3-4 bank conflicts a warp).
//   each expanded row once: a block owns one image, one strip of output columns (the
//     whole width up to 64, else strips of at most 60), a segment of at most 32 output
//     rows and 48 expanded channels. It walks down the segment: each step expands the
//     next rs input rows (64 positions: the window's in-image columns rounded up to
//     m16 tiles, so W = 29 takes two rows a step) into a ring of K - 1 + rs expanded
//     rows in shared memory, then runs the depthwise for the output rows the ring
//     completes. Columns outside the image are zeros written once (SAME zeros for the
//     depthwise); rows outside it are written as zeros. The expand's recompute (its
//     epilogue's SiLUs over the outputs') falls from 1.33-2.07 (16 x 12 tiles) to
//     the strips' 2 x PAD columns and the segments' K - 1 rows, 1.06-1.17 at the B5
//     shapes (3.8 G SiLUs a forward at batch 16, from 5.3 G); the segments keep >=
//     2.9 waves of two blocks an SM at every B5 shape (block counts in PERF.md).
//   resident operands: the expand weights (48 KB at Cin 512), the depthwise weights,
//     the BatchNorms and the table stay in shared memory for the block's life, loaded
//     once, not re-staged per 16 x 12 tile. The expand weights are stored transposed,
//     K-major in wgmma's 128-byte swizzle: per 64 input channels, 48 rows of 128 bytes.
//   inputs by TMA: thread 0 keeps SLOTS chunks (rs x 64 positions x 64 input channels,
//     128 bytes a position) in flight, each a 4-d TMA box of x in the 128-byte
//     swizzle wgmma reads, with zeros outside the image and past
//     Cin, completing on an mbarrier the warps wait on; the slot is refilled after the
//     block's barrier. No dedicated producer warp: one thread's few instructions a
//     chunk. Cin not a multiple of 8 or an unaligned x (TMA refuses the strides) stage
//     the same layout element by element.
//   expand: wgmma m64n24k16 (bf16 in, fp32 sums), both operands read from shared
//     memory by descriptor: the input chunk as TMA laid it out, the weights K-major;
//     each of the two warpgroups computes 24 of the 48 channels for the step's 64
//     positions, over the k16 steps in order from zero into one sum. Those are the
//     bits of the plain version's torch.mm(..., out_dtype=float32) on the card (cuBLAS'
//     own sm90 kernels; measured at every B5 and V2-S shape, as mma.sync's were).
//     Each warp's 16 rows arrive in mma.sync's fragment layout, so the epilogue is
//     one m16 tile a warp. Against mma.sync m16n8k16 with ldmatrix operands it reads
//     each weight once a warpgroup instead of once a warp, frees the registers of the
//     fragments, and overlaps the products with the waits.
//   epilogue: BN1 (`bn_bf16`: (v - mean) * mul + bias, the subtraction rounded, then
//     one FMA, as XLA's CPU program of flax's BatchNorm) rounded to bf16, the SiLU,
//     bf16 into the ring.
//   depthwise: an item is a channel pair, a row of the step and 6 output columns
//     (~1 item a thread); its sums run over dy, then dx, from zero (the plain version's
//     order), a window of K columns sliding along each ring row; BN2 rounded, the
//     SiLU, stored as bf16x2 (a warp writes 96 contiguous bytes). Its squeeze sums a
//     row's outputs, then the rows, in registers for the walk.
//   The roundings are the ones XLA's CPU program of the JAX MBConv block makes at
//   bf16: the convolutions' fp32 sums enter the BatchNorms unrounded, each
//   BatchNorm's result is rounded, and so is each op of the SiLU.
//   Three blocks an SM at K = 3 where their shared memory fits (blocks 4-7 and 14-19
//   of B5: 80 registers), else two; 256 threads a block.
//
// fp32 design: the bf16 path's strip walk, with the expand as 3xTF32 on wgmma. Its
// bound (above) is 6.7 ms a B5 forward at batch 16. The tensor cores take fp32 only
// as tf32 (a 10-bit mantissa, ~3 decimal digits), which the port's float32 policy (TF32
// off, as the JAX package's fp32 path) forbids for a single product. Each operand v is
// split as big = tf32(v) and small = tf32(v - big) (round to nearest), so v = big +
// small to ~2^-22 |v|; the expand sums big*big, small*big and big*small as wgmma
// m64n48k8 products (tf32 in, fp32 sums), and small*small (~2^-22) is dropped. The
// tensor cores truncate as they accumulate: summed in them over all of Cin, big*big
// drifts by ~1e-5 relative at Cin 512 (2.77e-5 (1 + |x|) at the output, measured on the
// H100, against a tolerance of 1e-5). So big*big is summed from zero over each
// warpgroup's two k8 steps of a chunk and joins the running sum by an fp32 add, while
// small*big and big*small, ~2^-11 of the sum, stay in the tensor cores' sum over all
// of Cin, where their truncation is below fp32's rounding: within 3e-7 (1 + |x|) of
// float64 at the precision tests' shapes (tests/_mbconv_f64.py). The design:
//   the walk, as bf16: a block owns one image, one strip of output columns, a segment
//     of output rows and 48 expanded channels (`tc::geometry`: the same strips and
//     segments, so the same squeeze partials); each step expands the next rs input
//     rows (64 positions) once, into a ring of K - 1 + rs fp32 rows in shared memory,
//     then runs the depthwise for the output rows the ring completes.
//   the weights, split once a call: `split_weights_kernel` writes both tf32 parts,
//     K-major (the only layout wgmma takes for tf32 B), to the caller's scratch, from
//     which TMA brings them in the 128-byte swizzle (48 rows of 128 bytes a part and
//     32 input channels). Resident for the block's life where two blocks an SM still
//     fit beside the ring (12 KB a 32 input channels: at the B5 shapes Cin <= 128 at K
//     = 3, 40 and 64 at K = 5), else streamed: each chunk's two parts come through the
//     input ring with its x. Streaming was chosen over a 24-channel tile, which keeps
//     60-96 KB of weights at Cin 304-512 (one or two blocks of four warps an SM) and
//     doubles the reads of x: streaming keeps two blocks of eight warps an SM at every
//     B5 and V2-S shape. Measured against the weights resident at one block an SM,
//     streaming is faster at every shape where it is used (PERF.md).
//   inputs by TMA: thread 0 keeps the ring's slots (2-4, the most that keep the
//     blocks an SM) in flight, each a 4-d box of x (rs x 64 positions x 32 input
//     channels, 128 bytes a position) in the 128-byte swizzle, zeros outside the image
//     and past Cin, completing on an mbarrier. Cin not a multiple of 4 or an unaligned
//     x (TMA refuses the strides) stage the same layout element by element.
//   expand: each of the two warpgroups takes two of a chunk's four k8 steps on all 48
//     channels (wgmma m64n48k8: at N = 24 a warpgroup, each taking every k8 step, the
//     forward was 4% slower). Each warp reads its A fragments from the slot and splits
//     them in registers: every x value is split once a block. A goes to wgmma from
//     registers, B (both weight parts) from shared memory by descriptor; x's small
//     part is not written to shared memory, where 8 KB more a slot would cost the
//     second block an SM at K = 5 (the ring alone is 60 KB there). The weights' k8
//     order puts each 8-channel group's even channels first, so a thread's A fragment
//     of a row is two neighbouring channels: one 8-byte load. After the step's last
//     chunk the warpgroups add each other's sums through that chunk's slot, and
//     warpgroup nh keeps channels 24 nh .. 24 nh + 23 (own + other: the same sum in
//     both, so the order is fixed).
//   epilogue: BN1 and the SiLU from those sums in one pass into the ring.
//   depthwise: as bf16 (channel pairs, a row, 6 output columns an item, sums over dy,
//     then dx, from zero), K*K fp32 FMAs, BN2 and the SiLU, float2 stores (a warp
//     writes 192 contiguous bytes); output offsets are 64-bit, so one launch takes
//     any batch the grid does. The squeeze as bf16's, over the values written.
//   Both BatchNorms are folded as the block loads them: scale mul, shift bias - mean *
//   mul (fp32 keeps the fold: no rounding to match, and fewer live values); the SiLU
//   is `silu_fast`. Two blocks an SM at every B5 and V2-S shape; 256 threads a block.
// What holds it back (variants timed on the H100, PERF.md): the products are ~10 ms a
// forward, near two thirds of the tensor cores' rate; the rest is latency: each
// chunk's group is waited for before the next is issued, the TMA waits (~5 ms), and a
// walk whose non-product work alone is about the bf16 kernel's time. Issuing a chunk's
// group before splitting the next one's fragments spilled at the 128-register cap and
// was slower; so was a wgmma group a half chunk.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "bf16_xla.cuh"
#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

// SiLU by the fast exponential and division: a few fp32 ulps (as accurate as the fp32
// sums before it); the SiLUs are most of the work past the MMAs, and the accurate
// expf and IEEE division cost several instructions more. The fp32 path's SiLU.
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

constexpr int TAB_BYTES = (TAB_ENTRIES * 2 + 15) / 16 * 16;  // the SiLU table's shared memory

// r = sigmoid_bf16(a) for n bf16 values a: what builds the table (and, over all 65536
// values, the check of its constants in chip_smoke.py).
__global__ void sigmoid_bf16_kernel(const uint16_t* __restrict__ a, uint16_t* __restrict__ r,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) r[i] = __float_as_uint(sigmoid_bf16(__uint_as_float(static_cast<uint32_t>(a[i]) << 16))) >> 16;
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

constexpr int CT = CHANNEL_TILE;  // expanded channels per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KCH = 64;           // input channels of a chunk: 128 bytes a position
constexpr int MROWS = 64;         // positions of a step: four m16 tiles
constexpr int SLOTS = 3;          // input chunks in the ring
constexpr int SLOT_BYTES = MROWS * KCH * 2;
constexpr int W_CHUNK = CT * 128;  // resident weights of a chunk: 48 rows of 64 K values
constexpr int ES = CT + 8;        // expanded row stride: 112 bytes
constexpr int PAIRS = CT / 2;     // channel pairs of a depthwise item
constexpr int SEG = 6;            // output columns of a depthwise item
constexpr int IPT = 2;            // depthwise items a thread, at most
constexpr int STRIP = 60;         // widest strip of a wide image (W > MROWS)
constexpr int SEG_ROWS = 32;      // tallest H segment

// How a launch cuts an image: n_s column strips of sw (the last may be narrower),
// n_seg row segments of sh; ncp: the in-image columns a step expands, rounded up to
// m16 tiles; rs: rows a step (64 positions). A function of H and W alone (so is the
// partials' count), and of K only through ncp.
struct Geo {
  int n_s, sw, n_seg, sh, ncp, rs;
};

inline Geo geometry(int H, int W, int K) {
  Geo g;
  g.n_s = W <= MROWS ? 1 : (W + STRIP - 1) / STRIP;
  g.sw = (W + g.n_s - 1) / g.n_s;
  g.n_seg = (H + SEG_ROWS - 1) / SEG_ROWS;
  g.sh = (H + g.n_seg - 1) / g.n_seg;
  const int nc = g.n_s == 1 ? W : std::min(W, g.sw + K - 1);
  g.ncp = (nc + 15) / 16 * 16;
  g.rs = MROWS / g.ncp;
  return g;
}

// MINB: blocks an SM the registers must allow (3 where the shared memory does, at K = 3)
template <int K, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
expand_dw_bf16_kernel(const __grid_constant__ CUtensorMap tmap, const bf16* __restrict__ x,
                      const bf16* __restrict__ w_exp, Bn bn, const bf16* __restrict__ w_dw,
                      bf16* __restrict__ out, float* __restrict__ partials,
                      const uint16_t* __restrict__ table, int H, int W, int cin, int cexp,
                      int sw, int sh, int n_s, int ncp, int rs, int tma, int wvec, int ovec) {
  constexpr int PAD = (K - 1) / 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float s_bn[6][CT];  // mean, mul, bias of BN1, then BN2
  __shared__ __align__(8) float s_wdw[K * K][CT];
  __shared__ __align__(8) uint64_t s_bar[SLOTS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CT;
  const int x0 = (blockIdx.y % n_s) * sw, y0 = (blockIdx.y / n_s) * sh;
  const int64_t img = blockIdx.z;
  float* const part =
      partials + ((img * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * CT;
  if (x0 >= W || y0 >= H) {  // an empty strip or segment (not at B5 shapes)
    if (tid < CT) part[tid] = 0.0f;
    return;
  }
  const int swt = min(sw, W - x0), sht = min(sh, H - y0);
  const int wp = sw + K - 1;     // expanded row columns: x0 - PAD + j
  const int wr = wp + SEG;       // a ring row, with zeros past wp for the last window
  const int R = K - 1 + rs;      // expanded rows in the ring
  const int xs = max(0, x0 - PAD);  // the first in-image column of the window
  const int nc = min(W, x0 + swt + PAD) - xs;  // in-image columns the expand computes
  const int mts = rs * ncp / 16;  // m16 tiles of a step
  const int nch = max(1, (cin + KCH - 1) / KCH);  // one barrier a chunk, also at Cin 0
  const int nsteps = (sht + K - 1 + rs - 1) / rs;
  const int total = nsteps * nch;
  const int nseg = (swt + SEG - 1) / SEG;
  const int items = rs * nseg * PAIRS;
  const int ybase = y0 - PAD;    // the image row of the walk's row 0

  // dynamic shared memory from a 1024-byte boundary (the 128-byte swizzle of TMA and
  // wgmma): the input ring, the resident weights, the SiLU table, the expanded rows
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* const in_ring = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  unsigned char* const s_w = in_ring + SLOTS * SLOT_BYTES;  // [nch][CT][64] K-major, swizzled
  uint16_t* const s_tab = reinterpret_cast<uint16_t*>(s_w + nch * W_CHUNK);
  bf16* const ring = reinterpret_cast<bf16*>(s_w + nch * W_CHUNK + TAB_BYTES);  // [R][wr][ES]
  const uint32_t in_addr = hopper::smem_addr(in_ring);

  // chunk i of the walk (step i / nch, input channels (i % nch) * KCH on) into slot
  // i % SLOTS: one thread's TMA box (KCH channels, ncp columns from xs, rs rows,
  // one image), zeros outside the image and past Cin
  auto fetch = [&](int i) {
    const int s = i / nch, slot = i % SLOTS;
    const uint32_t bar = hopper::smem_addr(&s_bar[slot]);
    hopper::mbar_arrive_expect_tx(bar, rs * ncp * KCH * 2);
    hopper::tma_load_4d(in_addr + slot * SLOT_BYTES, &tmap, bar, (i - s * nch) * KCH, xs,
                        ybase + s * rs, static_cast<int>(img));
  };
  if (tma && tid == 0) {
    for (int s = 0; s < SLOTS; ++s) hopper::mbar_init(hopper::smem_addr(&s_bar[s]), 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tma && tid == 0)
    for (int i = 0; i < SLOTS && i < total; ++i) fetch(i);

  // resident for the block's life: the table, the BatchNorms, the depthwise and the
  // expand weights (zeros past Cin and Cexp); the ring starts at zero,
  // which stays in the columns outside the image (SAME zeros for the depthwise)
  for (int i = tid; i < TAB_ENTRIES / 4; i += THREADS)
    reinterpret_cast<uint2*>(s_tab)[i] = reinterpret_cast<const uint2*>(table)[i];
  for (int i = tid; i < 6 * CT; i += THREADS) {
    const int r = i / CT, c = c0 + i % CT;
    s_bn[r][i % CT] = c < cexp ? bn.at(r)[c] : 0.0f;
  }
  for (int i = tid; i < K * K * CT; i += THREADS) {
    const int t = i / CT, c = c0 + i % CT;
    s_wdw[t][i % CT] = c < cexp ? __bfloat162float(w_dw[(int64_t)t * cexp + c]) : 0.0f;
  }
  // the expand weights transposed to wgmma's K-major B: input channel k of expanded
  // channel n at chunk k / 64, row n, 16-byte column (k % 64) / 8 ^ (n % 8)
  auto put_w = [&](int k, int n, bf16 v) {
    *reinterpret_cast<bf16*>(s_w + (k / KCH) * W_CHUNK + n * 128 +
                             ((((k % KCH) >> 3) ^ (n & 7)) << 4) + (k & 7) * 2) = v;
  };
  if (wvec) {  // eight expanded channels a 16-byte load
    for (int i = tid; i < nch * KCH * (CT / 8); i += THREADS) {
      const int k = i / (CT / 8), n = (i % (CT / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < cin && c0 + n < cexp) v = *reinterpret_cast<const uint4*>(w_exp + (int64_t)k * cexp + c0 + n);
      const bf16* const e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) put_w(k, n + j, e[j]);
    }
  } else {
    for (int i = tid; i < nch * KCH * CT; i += THREADS) {
      const int k = i / CT, n = i % CT;
      put_w(k, n, k < cin && c0 + n < cexp ? w_exp[(int64_t)k * cexp + c0 + n]
                                            : __float2bfloat16(0.0f));
    }
  }
  for (int i = tid; i < R * wr * (ES / 8); i += THREADS)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  hopper::fence_proxy_async();  // the weights, written by ordinary stores, for wgmma
  __syncthreads();

  // the expand: warpgroup nh's wgmma computes expanded channels 24 nh .. 24 nh + 23
  // of the step's 64 positions; its warp mt holds rows 16 mt .. 16 mt + 15 (the
  // epilogue's m16 tile), whose positions exist when mt < mts
  const int mt = warp & 3, nh = warp >> 2;
  const bool has_rows = mt < mts;
  const uint32_t w_addr = hopper::smem_addr(s_w) + nh * 24 * 128;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const bf16* const ximg = x + img * H * W * cin;
  // the epilogue's two positions of each thread, and its depthwise items: the same
  // in every step
  int ep_rr[2], ep_col[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = mt * 16 + g + h * 8, rr = p / ncp, cc = p - rr * ncp;
    ep_rr[h] = rr;
    ep_col[h] = cc < nc ? cc + xs - x0 + PAD : -1;  // -1: past the in-image columns
  }
  int it_rr[IPT], it_col0[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int rest = (tid + k * THREADS) / PAIRS;
    it_rr[k] = rest / nseg;
    it_col0[k] = (rest - it_rr[k] * nseg) * SEG;
  }
  float sq[IPT][2];
#pragma unroll
  for (int k = 0; k < IPT; ++k) sq[k][0] = sq[k][1] = 0.0f;

  int head = 0;  // the ring row of the step's first row: (s * rs) % R
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    // ---- expand the step's rs input rows, chunk by chunk, on the tensor cores: the
    // k16 steps in order from zero into one sum (the plain version's torch.mm bits)
    float acc[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) acc[r] = 0.0f;
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int i = s * nch + ch, slot = i % SLOTS;
      unsigned char* const xin = in_ring + slot * SLOT_BYTES;
      if (tma) {
        hopper::mbar_wait(hopper::smem_addr(&s_bar[slot]), (i / SLOTS) & 1);
      } else {  // element by element, into the layout TMA's swizzle gives
#pragma unroll 1
        for (int e = tid; e < rs * ncp * KCH; e += THREADS) {
          const int p = e / KCH, cl = e % KCH, rr = p / ncp;
          const int gy = ybase + s * rs + rr, gx = xs + p - rr * ncp, ci = ch * KCH + cl;
          const bool ok = gy >= 0 && gy < H && gx < W && ci < cin;
          *reinterpret_cast<bf16*>(xin + p * 128 + (((cl >> 3) ^ (p & 7)) << 4) + (cl & 7) * 2) =
              ok ? ximg[((int64_t)gy * W + gx) * cin + ci] : __float2bfloat16(0.0f);
        }
        hopper::fence_proxy_async();  // ordinary stores, read by wgmma
        __syncthreads();
      }
      {  // the chunk's k16 steps in order, each a wgmma reading the slot and the weights
        const int ksteps = (min(KCH, cin - ch * KCH) + 15) / 16;
        const uint32_t a_addr = hopper::smem_addr(xin), b_addr = w_addr + ch * W_CHUNK;
#pragma unroll
        for (int r = 0; r < 12; ++r) hopper::fence_operand(acc[r]);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KCH / 16; ++ks)
          if (ks < ksteps)
            hopper::wgmma_m64n24k16_bf16(acc, hopper::wgmma_desc_sw128(a_addr + ks * 32),
                                         hopper::wgmma_desc_sw128(b_addr + ks * 32));
        hopper::wgmma_commit();
        hopper::wgmma_wait0();
#pragma unroll
        for (int r = 0; r < 12; ++r) hopper::fence_operand(acc[r]);
      }
      __syncthreads();  // every warp is done with the slot
      if (tma && tid == 0 && i + SLOTS < total) fetch(i + SLOTS);
    }

    // ---- BN1 + SiLU into the ring, bf16; zeros for rows outside the image
    if (has_rows) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ep_col[h] < 0) continue;
        const int gy = ybase + s * rs + ep_rr[h];
        const bool inside = gy >= 0 && gy < H;
        const int sl = head + ep_rr[h] < R ? head + ep_rr[h] : head + ep_rr[h] - R;
        bf16* const dst = ring + (sl * wr + ep_col[h]) * ES;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int c = (nh * 3 + j) * 8 + q2;
          const float v0 = silu_tab(
              bf16_round(bn_bf16(acc[4 * j + 2 * h], s_bn[0][c], s_bn[1][c], s_bn[2][c])), s_tab);
          const float v1 = silu_tab(bf16_round(bn_bf16(acc[4 * j + 2 * h + 1], s_bn[0][c + 1],
                                                       s_bn[1][c + 1], s_bn[2][c + 1])),
                                    s_tab);
          *reinterpret_cast<__nv_bfloat162*>(dst + c) =
              inside ? __floats2bfloat162_rn(v0, v1) : __float2bfloat162_rn(0.0f);
        }
      }
    }
    __syncthreads();

    // ---- depthwise K x K for the output rows the ring now completes: an item is a
    // channel pair, one of the step's rows and SEG columns; its sums go over dy, then
    // dx, from zero (the plain version's order), a window of K columns sliding along
    // each ring row; the item's squeeze sums stay in registers for the whole walk
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int item = tid + k * THREADS;
      if (item >= items) continue;
      const int c = (item % PAIRS) * 2, col0 = it_col0[k];
      const int yl = s * rs + it_rr[k] - (K - 1);  // the output row, from y0
      if (yl < 0 || yl >= sht) continue;
      int sl = head + it_rr[k] + R - (K - 1);  // the ring row of output row yl's dy = 0
      sl -= sl >= R ? R : 0;
      sl -= sl >= R ? R : 0;
      float2 a[SEG];
#pragma unroll
      for (int o = 0; o < SEG; ++o) a[o] = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const bf16* const src = ring + (sl * wr + col0) * ES + c;
        sl = sl + 1 == R ? 0 : sl + 1;
        float2 wk[K], win[K];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          wk[dx] = *reinterpret_cast<const float2*>(&s_wdw[dy * K + dx][c]);
          win[dx] = make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < SEG + K - 1; ++j) {
#pragma unroll
          for (int dx = 0; dx < K - 1; ++dx) win[dx] = win[dx + 1];
          win[K - 1] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + j * ES));
          if (j >= K - 1) {
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              a[j - (K - 1)].x = fmaf(win[dx].x, wk[dx].x, a[j - (K - 1)].x);
              a[j - (K - 1)].y = fmaf(win[dx].y, wk[dx].y, a[j - (K - 1)].y);
            }
          }
        }
      }
      const float m0 = s_bn[3][c], m1 = s_bn[3][c + 1], mu0 = s_bn[4][c], mu1 = s_bn[4][c + 1];
      const float bi0 = s_bn[5][c], bi1 = s_bn[5][c + 1];
      const bool store = c0 + c < cexp;
      bf16* const orow = out + ((img * H + y0 + yl) * W + x0 + col0) * cexp + c0 + c;
      float row0 = 0.0f, row1 = 0.0f;  // this row's sums, then added to the walk's
#pragma unroll
      for (int o = 0; o < SEG; ++o) {
        if (col0 + o < swt) {
          const float v0 = silu_tab(bf16_round(bn_bf16(a[o].x, m0, mu0, bi0)), s_tab);
          const float v1 = silu_tab(bf16_round(bn_bf16(a[o].y, m1, mu1, bi1)), s_tab);
          if (store) {
            bf16* const dst = orow + (int64_t)o * cexp;
            if (ovec) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
            } else {
              dst[0] = __float2bfloat16_rn(v0);
              if (c0 + c + 1 < cexp) dst[1] = __float2bfloat16_rn(v1);
            }
          }
          row0 += v0;
          row1 += v1;
        }
      }
      sq[k][0] += row0;
      sq[k][1] += row1;
    }
    head = head + rs < R ? head + rs : head + rs - R;
  }

  // ---- the block's squeeze partial: the items' sums, then one thread a channel adds
  // them in order (row of the step, then column segment); the input ring is free
  __syncthreads();
  float* const s_sq = reinterpret_cast<float*>(in_ring);  // [items][2]
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int item = tid + k * THREADS;
    if (item < items) {
      s_sq[2 * item] = sq[k][0];
      s_sq[2 * item + 1] = sq[k][1];
    }
  }
  __syncthreads();
  if (tid < CT) {
    float sum = 0.0f;
#pragma unroll 1
    for (int rest = 0; rest < rs * nseg; ++rest) sum += s_sq[2 * (rest * PAIRS + tid / 2) + (tid & 1)];
    part[tid] = sum;
  }
}

// cuTensorMapEncodeTiled through the runtime's entry-point query (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                   : nullptr;
  }();
  return fn;
}

// Static shared memory of the kernel for K (the arrays above).
constexpr int static_smem(int K) { return 6 * CT * 4 + K * K * CT * 4 + SLOTS * 8; }

template <int K>
int launch_bf16(const void* x, const void* w_exp, const Bn& bn, const void* w_dw, void* out,
                void* partials, const void* table, int batch, int H, int W, int cin, int cexp,
                cudaStream_t stream) {
  const Geo g = geometry(H, W, K);
  auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  // TMA reads rows of Cin bf16 values: Cin a multiple of 8 (16-byte strides) and x
  // on a 16-byte boundary; else the chunks are staged element by element
  const int tma = cin > 0 && cin % 8 == 0 && aligned(x, 16);
  const int wvec = cexp % 8 == 0 && aligned(w_exp, 16);
  const int ovec = cexp % 2 == 0 && aligned(out, 4);
  const int nch = std::max(1, (cin + KCH - 1) / KCH);
  // shared memory with a ring of `rows`, and the blocks an SM it allows: 228 KB, 1 KB
  // of it reserved a block; the registers allow three at K = 3 (at K = 5 the 85
  // registers a thread that takes spill) and two at K = 5
  auto smem_of = [&](int rows) {
    return 1024 + SLOTS * SLOT_BYTES + nch * W_CHUNK + TAB_BYTES +
           rows * (g.sw + K - 1 + SEG) * ES * 2;
  };
  auto blocks_of = [&](int rows) {
    return std::min(K == 3 ? 3 : 2, 233472 / (smem_of(rows) + static_smem(K) + 1024));
  };
  const int rows = K - 1 + g.rs;
  const int smem = smem_of(rows);
  if (smem + static_smem(K) > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = blocks_of(rows) == 3 ? expand_dw_bf16_kernel<K, K == 3 ? 3 : 2>
                                     : expand_dw_bf16_kernel<K, 2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cin) * 2,
                                   static_cast<cuuint64_t>(W) * cin * 2,
                                   static_cast<cuuint64_t>(H) * W * cin * 2};
    const cuuint32_t box[4] = {KCH, static_cast<cuuint32_t>(g.ncp),
                               static_cast<cuuint32_t>(g.rs), 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // channel tiles run fastest, so the blocks that read one strip read it from L2
  const dim3 grid((cexp + CT - 1) / CT, g.n_s * g.n_seg, batch);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, THREADS, smem, stream>>>(
      tmap, static_cast<const bf16*>(x), static_cast<const bf16*>(w_exp), bn,
      static_cast<const bf16*>(w_dw), static_cast<bf16*>(out), static_cast<float*>(partials),
      static_cast<const uint16_t*>(table), H, W, cin, cexp, g.sw, g.sh, g.n_s, g.ncp, g.rs, tma,
      wvec, ovec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------- fp32, 3xTF32 on wgmma
namespace f32 {

constexpr int CT = CHANNEL_TILE;  // expanded channels per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KCH = 32;           // input channels of a chunk: 128 bytes a position
constexpr int MROWS = tc::MROWS;  // positions of a step: four m16 tiles
constexpr int MAX_SLOTS = 4;      // input chunks in the ring, at most
constexpr int X_BYTES = MROWS * KCH * 4;  // a chunk of x: 8 KB
constexpr int W_PART = CT * 128;  // one tf32 part of a chunk's weights: 48 rows of 32 K values
constexpr int W_BYTES = 2 * W_PART;  // big, then small
constexpr int XCH_BYTES = 2 * 12 * 128 * 4;  // the warpgroups' exchange of their sums
constexpr int ES = CT;            // expanded row stride (floats)
constexpr int PAIRS = CT / 2;     // channel pairs of a depthwise item
constexpr int SEG = tc::SEG;      // output columns of a depthwise item
constexpr int IPT = tc::IPT;      // depthwise items a thread, at most
// (blocks an SM, resident weights) in the order a launch tries them (`launch_f32`)
constexpr int PREFER[4][2] = {{2, 1}, {2, 0}, {1, 1}, {1, 0}};

// A slot's bytes: x, then the chunk's weights where they stream; at least the
// warpgroups' exchange of their sums at the end of a step.
__host__ __device__ inline int slot_size(int resident) {
  return resident ? (X_BYTES > XCH_BYTES ? X_BYTES : XCH_BYTES) : X_BYTES + W_BYTES;
}

// The columns of a ring row: the strip's sw + K - 1 and the last depthwise item's
// window past them (read, never used).
__host__ __device__ inline int ring_cols(int sw, int K) { return (sw + SEG - 1) / SEG * SEG + K - 1; }

// w_exp [Cin, Cexp] -> wt [2][cpad][kpad], the big and the small tf32 part of each
// weight (`split_tf32`), K-major (the layout wgmma takes for tf32), zeros past Cin and
// Cexp; within each 8-channel group the even channels first, then the odd ones (k8
// position p holds channel 2p for p < 4, 2 (p - 4) + 1 after), so that the A fragment
// a thread gives wgmma for a k8 step (positions t and t + 4 of rows g and g + 8) is
// two neighbouring channels of x: one 8-byte load a row. A 32 x 32 tile a block
// through shared memory: reads along Cexp, writes along Cin.
__global__ void split_weights_kernel(const float* __restrict__ w, float* __restrict__ wt, int cin,
                                     int cexp, int cpad, int kpad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32, tx = threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = k < cin && n < cexp ? w[static_cast<int64_t>(k) * cexp + n] : 0.0f;
  }
  __syncthreads();
  const int q = tx & 7, kk = (tx & ~7) + (q < 4 ? 2 * q : 2 * q - 7);
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= cpad) continue;
    uint32_t big, small;
    hopper::split_tf32(tile[kk][i], big, small);
    wt[static_cast<int64_t>(n) * kpad + k0 + tx] = __uint_as_float(big);
    wt[(static_cast<int64_t>(cpad) + n) * kpad + k0 + tx] = __uint_as_float(small);
  }
}

// Warpgroup nh's share of a chunk, its k8 steps 2 nh and 2 nh + 1 (of ksteps), on
// all 48 channels: the warp's A fragments (rows 16 mt + g and + 8 at `x_row`: channels
// 8 ks + 2 t and + 1, 8 bytes at 16-byte column (2 ks + t / 2) ^ g of the swizzled
// 128-byte row) loaded and split into big and small tf32 parts, then big x big summed
// from zero into `run` and small x big and big x small into acc_s, the weights' two
// parts at b_addr (big) and b_addr + W_PART (small); one wgmma group, waited for.
__device__ __forceinline__ void expand_pair(const unsigned char* x_row, int nh, int t, int g,
                                            bool has_rows, int ksteps, uint32_t b_addr,
                                            float (&run)[24], float (&acc_s)[24]) {
  uint32_t ab[2][4], as[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ks = 2 * nh + j;
    float2 lo = make_float2(0.0f, 0.0f), hi = lo;
    if (has_rows && ks < ksteps) {
      const int col = ((2 * ks + (t >> 1)) ^ g) << 4;
      lo = *reinterpret_cast<const float2*>(x_row + col);
      hi = *reinterpret_cast<const float2*>(x_row + 8 * 128 + col);
    }
    hopper::split_tf32(lo.x, ab[j][0], as[j][0]);
    hopper::split_tf32(hi.x, ab[j][1], as[j][1]);
    hopper::split_tf32(lo.y, ab[j][2], as[j][2]);
    hopper::split_tf32(hi.y, ab[j][3], as[j][3]);
  }
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    hopper::fence_operand(run[r]);
    hopper::fence_operand(acc_s[r]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ks = 2 * nh + j;
    if (ks < ksteps) {
      const uint64_t big = hopper::wgmma_desc_sw128(b_addr + ks * 32);
      const uint64_t small = hopper::wgmma_desc_sw128(b_addr + W_PART + ks * 32);
      hopper::wgmma_m64n48k8_tf32(run, ab[j], big, j);
      hopper::wgmma_m64n48k8_tf32(acc_s, as[j], big, 1);
      hopper::wgmma_m64n48k8_tf32(acc_s, ab[j], small, 1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait0();
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    hopper::fence_operand(run[r]);
    hopper::fence_operand(acc_s[r]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hopper::fence_operand(ab[j][q]);
      hopper::fence_operand(as[j][q]);
    }
}

template <int K>
__global__ void __launch_bounds__(THREADS, 2)
expand_dw_f32_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ x, Bn bn, const float* __restrict__ w_dw,
                     float* __restrict__ out, float* __restrict__ partials, int H, int W, int cin,
                     int cexp, int sw, int sh, int n_s, int ncp, int rs, int slots, int resident,
                     int tma, int ovec) {
  constexpr int PAD = (K - 1) / 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float s_bn[4][CT];  // BN1 scale, shift, then BN2's (folded)
  __shared__ __align__(8) float s_wdw[K * K][CT];
  __shared__ __align__(8) uint64_t s_bar[MAX_SLOTS + 1];  // the slots', then the weights'

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CT;
  const int x0 = (blockIdx.y % n_s) * sw, y0 = (blockIdx.y / n_s) * sh;
  const int64_t img = blockIdx.z;
  float* const part =
      partials + ((img * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * CT;
  if (x0 >= W || y0 >= H) {  // an empty strip or segment (not at B5 shapes)
    if (tid < CT) part[tid] = 0.0f;
    return;
  }
  const int swt = min(sw, W - x0), sht = min(sh, H - y0);
  const int wr = ring_cols(sw, K);  // a ring row: expanded column x0 - PAD + j at j
  const int R = K - 1 + rs;      // expanded rows in the ring
  const int xs = max(0, x0 - PAD);  // the first in-image column of the window
  const int nc = min(W, x0 + swt + PAD) - xs;  // in-image columns the expand computes
  const int mts = rs * ncp / 16;  // m16 tiles of a step
  const int nch = max(1, (cin + KCH - 1) / KCH);  // one barrier a chunk, also at Cin 0
  const int nsteps = (sht + K - 1 + rs - 1) / rs;
  const int total = nsteps * nch;
  const int nseg = (swt + SEG - 1) / SEG;
  const int items = rs * nseg * PAIRS;
  const int ybase = y0 - PAD;    // the image row of the walk's row 0
  // x, then streamed weights; at least the warpgroups' exchange
  const int slot_bytes = slot_size(resident);
  const bool bars = tma || !resident;  // a slot completes on its barrier

  // dynamic shared memory from a 1024-byte boundary (the 128-byte swizzle of TMA and
  // wgmma): the input ring, the resident weights, the expanded rows
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* const in_ring = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  unsigned char* const s_w = in_ring + slots * slot_bytes;  // [nch][big, small][CT][32] K-major
  float* const ring = reinterpret_cast<float*>(s_w + (resident ? nch * W_BYTES : 0));  // [R][wr][ES]
  const uint32_t in_addr = hopper::smem_addr(in_ring);

  // chunk i of the walk (step i / nch, input channels (i % nch) * KCH on) into slot
  // i % slots: one thread's TMA boxes (x: KCH channels, ncp columns from xs, rs rows,
  // one image, zeros outside the image and past Cin; streamed weights: both parts of
  // the chunk's KCH x CT)
  auto fetch = [&](int i) {
    const int s = i / nch, ch = i - s * nch, slot = i % slots;
    const uint32_t dst = in_addr + slot * slot_bytes, bar = hopper::smem_addr(&s_bar[slot]);
    hopper::mbar_arrive_expect_tx(bar, (tma ? rs * ncp * KCH * 4 : 0) + (resident ? 0 : W_BYTES));
    if (tma)
      hopper::tma_load_4d(dst, &xmap, bar, ch * KCH, xs, ybase + s * rs, static_cast<int>(img));
    if (!resident)
      for (int p = 0; p < 2; ++p)
        hopper::tma_load_3d(dst + X_BYTES + p * W_PART, &wmap, bar, ch * KCH, c0, p);
  };
  if (tid == 0) {
    for (int s = 0; s <= MAX_SLOTS; ++s) hopper::mbar_init(hopper::smem_addr(&s_bar[s]), 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (resident) {  // every chunk's weights, once for the block's life
      const uint32_t bar = hopper::smem_addr(&s_bar[MAX_SLOTS]);
      hopper::mbar_arrive_expect_tx(bar, nch * W_BYTES);
      for (int ch = 0; ch < nch; ++ch)
        for (int p = 0; p < 2; ++p)
          hopper::tma_load_3d(hopper::smem_addr(s_w + ch * W_BYTES + p * W_PART), &wmap, bar,
                              ch * KCH, c0, p);
    }
    if (bars)
      for (int i = 0; i < slots && i < total; ++i) fetch(i);
  }

  // resident for the block's life: both BatchNorms folded (scale mul, shift bias - mean
  // * mul, each op rounded: the plain version's float32 arithmetic) and the depthwise
  // weights (zeros past Cexp); the ring starts at zero, which stays in the columns
  // outside the image (SAME zeros for the depthwise)
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
  for (int i = tid; i < R * wr * (ES / 4); i += THREADS)
    reinterpret_cast<float4*>(ring)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  // the expand: warpgroup nh's wgmma computes k8 steps 2 nh and 2 nh + 1 of each
  // chunk for all 48 channels of the step's 64 positions, and it keeps channels 24 nh
  // .. 24 nh + 23 for the epilogue; its warp mt holds rows 16 mt .. 16 mt + 15 (the
  // epilogue's m16 tile), whose positions exist when mt < mts. A thread's A fragments
  // start at a_row in the slot (`expand_pair`; the row's index modulo 8 is g)
  const int mt = warp & 3, nh = warp >> 2;
  const bool has_rows = mt < mts;
  const int g = lane >> 2, t = lane & 3;
  const int a_row = (mt * 16 + g) * 128 + (t & 1) * 8;
  // the epilogue's two positions of each thread, and its depthwise items: the same
  // in every step
  int ep_rr[2], ep_col[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = mt * 16 + g + h * 8, rr = p / ncp, cc = p - rr * ncp;
    ep_rr[h] = rr;
    ep_col[h] = cc < nc ? cc + xs - x0 + PAD : -1;  // -1: past the in-image columns
  }
  int it_rr[IPT], it_col0[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int rest = (tid + k * THREADS) / PAIRS;
    it_rr[k] = rest / nseg;
    it_col0[k] = (rest - it_rr[k] * nseg) * SEG;
  }
  float sq[IPT][2];
#pragma unroll
  for (int k = 0; k < IPT; ++k) sq[k][0] = sq[k][1] = 0.0f;
  const float* const ximg = x + img * H * W * cin;
  if (resident) hopper::mbar_wait(hopper::smem_addr(&s_bar[MAX_SLOTS]), 0);

  int head = 0;  // the ring row of the step's first row: (s * rs) % R
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    // ---- expand the step's rs input rows, chunk by chunk, as 3xTF32 on the tensor
    // cores: each warpgroup takes two of a chunk's four k8 steps on all 48 channels
    // (`expand_pair`), its big x big sums added to acc in fp32; then the two
    // warpgroups' sums of each channel are added through the last chunk's slot, and
    // warpgroup nh keeps channels 24 nh .. 24 nh + 23
    float acc[24], acc_s[24], run[24];
#pragma unroll
    for (int r = 0; r < 24; ++r) acc[r] = acc_s[r] = 0.0f;
    unsigned char* xin = in_ring;
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int i = s * nch + ch, slot = i % slots;
      xin = in_ring + slot * slot_bytes;
      if (bars) hopper::mbar_wait(hopper::smem_addr(&s_bar[slot]), (i / slots) & 1);
      if (!tma) {  // element by element, into the layout TMA's swizzle gives
#pragma unroll 1
        for (int e = tid; e < rs * ncp * KCH; e += THREADS) {
          const int p = e / KCH, cl = e % KCH, rr = p / ncp;
          const int gy = ybase + s * rs + rr, gx = xs + p - rr * ncp, ci = ch * KCH + cl;
          const bool ok = gy >= 0 && gy < H && gx < W && ci < cin;
          *reinterpret_cast<float*>(xin + p * 128 + (((cl >> 2) ^ (p & 7)) << 4) + (cl & 3) * 4) =
              ok ? ximg[((int64_t)gy * W + gx) * cin + ci] : 0.0f;
        }
        __syncthreads();
      }
      const int ksteps = (min(KCH, cin - ch * KCH) + 7) / 8;
      expand_pair(xin + a_row, nh, t, g, has_rows, ksteps,
                  hopper::smem_addr(resident ? s_w + ch * W_BYTES : xin + X_BYTES), run, acc_s);
      if (2 * nh < ksteps)
#pragma unroll
        for (int r = 0; r < 24; ++r) acc[r] += run[r];
      __syncthreads();  // every warp is done with the slot
      // the step's last slot carries the warpgroups' sums first: refilled after them
      if (bars && tid == 0 && ch + 1 < nch && i + slots < total) fetch(i + slots);
    }
    // the other warpgroup's channels through the slot ([warpgroup][12][128] floats,
    // the partner thread's fragment), then own + other (the same sum both ways)
    float own[12];
    {
      float* const xch = reinterpret_cast<float*>(xin);
      const int wt = tid & 127;
#pragma unroll
      for (int r = 0; r < 12; ++r) {
        own[r] = (nh ? acc[12 + r] : acc[r]) + (nh ? acc_s[12 + r] : acc_s[r]);
        xch[(nh * 12 + r) * 128 + wt] = (nh ? acc[r] : acc[12 + r]) + (nh ? acc_s[r] : acc_s[12 + r]);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 12; ++r) own[r] += xch[((1 - nh) * 12 + r) * 128 + wt];
    }

    // ---- BN1 + SiLU into the ring; zeros for rows outside the image
    if (has_rows) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ep_col[h] < 0) continue;
        const int gy = ybase + s * rs + ep_rr[h];
        const bool inside = gy >= 0 && gy < H;
        const int sl = head + ep_rr[h] < R ? head + ep_rr[h] : head + ep_rr[h] - R;
        float* const dst = ring + (sl * wr + ep_col[h]) * ES;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int c = (nh * 3 + j) * 8 + 2 * t, r = 4 * j + 2 * h;
          const float v0 = silu_fast(fmaf(own[r], s_bn[0][c], s_bn[1][c]));
          const float v1 = silu_fast(fmaf(own[r + 1], s_bn[0][c + 1], s_bn[1][c + 1]));
          *reinterpret_cast<float2*>(dst + c) = inside ? make_float2(v0, v1) : make_float2(0.0f, 0.0f);
        }
      }
    }
    __syncthreads();  // the ring rows written; every warp is done with the last slot
    if (bars && tid == 0 && (s + 1) * nch - 1 + slots < total) fetch((s + 1) * nch - 1 + slots);

    // ---- depthwise K x K for the output rows the ring now completes: an item is a
    // channel pair, one of the step's rows and SEG columns; its sums go over dy, then
    // dx, from zero, a window of K columns sliding along each ring row; BN2 + SiLU,
    // stored as float2 (a warp writes 192 contiguous bytes); the item's squeeze sums
    // stay in registers for the whole walk
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int item = tid + k * THREADS;
      if (item >= items) continue;
      const int c = (item % PAIRS) * 2, col0 = it_col0[k];
      const int yl = s * rs + it_rr[k] - (K - 1);  // the output row, from y0
      if (yl < 0 || yl >= sht) continue;
      int sl = head + it_rr[k] + R - (K - 1);  // the ring row of output row yl's dy = 0
      sl -= sl >= R ? R : 0;
      sl -= sl >= R ? R : 0;
      float2 a[SEG];
#pragma unroll
      for (int o = 0; o < SEG; ++o) a[o] = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const float* const src = ring + (sl * wr + col0) * ES + c;
        sl = sl + 1 == R ? 0 : sl + 1;
        float2 wk[K], win[K];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          wk[dx] = *reinterpret_cast<const float2*>(&s_wdw[dy * K + dx][c]);
          win[dx] = make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < SEG + K - 1; ++j) {
#pragma unroll
          for (int dx = 0; dx < K - 1; ++dx) win[dx] = win[dx + 1];
          win[K - 1] = *reinterpret_cast<const float2*>(src + j * ES);
          if (j >= K - 1) {
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              a[j - (K - 1)].x = fmaf(win[dx].x, wk[dx].x, a[j - (K - 1)].x);
              a[j - (K - 1)].y = fmaf(win[dx].y, wk[dx].y, a[j - (K - 1)].y);
            }
          }
        }
      }
      const float sc0 = s_bn[2][c], sc1 = s_bn[2][c + 1], sh0 = s_bn[3][c], sh1 = s_bn[3][c + 1];
      const bool store = c0 + c < cexp;
      float* const orow = out + ((img * H + y0 + yl) * W + x0 + col0) * cexp + c0 + c;
      float row0 = 0.0f, row1 = 0.0f;  // this row's sums, then added to the walk's
#pragma unroll
      for (int o = 0; o < SEG; ++o) {
        if (col0 + o < swt) {
          const float v0 = silu_fast(fmaf(a[o].x, sc0, sh0));
          const float v1 = silu_fast(fmaf(a[o].y, sc1, sh1));
          if (store) {
            float* const dst = orow + (int64_t)o * cexp;
            if (ovec) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (c0 + c + 1 < cexp) dst[1] = v1;
            }
          }
          row0 += v0;
          row1 += v1;
        }
      }
      sq[k][0] += row0;
      sq[k][1] += row1;
    }
    head = head + rs < R ? head + rs : head + rs - R;
  }

  // ---- the block's squeeze partial: the items' sums, then one thread a channel adds
  // them in order (row of the step, then column segment); the input ring is free
  __syncthreads();
  float* const s_sq = reinterpret_cast<float*>(in_ring);  // [items][2]
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int item = tid + k * THREADS;
    if (item < items) {
      s_sq[2 * item] = sq[k][0];
      s_sq[2 * item + 1] = sq[k][1];
    }
  }
  __syncthreads();
  if (tid < CT) {
    float sum = 0.0f;
#pragma unroll 1
    for (int rest = 0; rest < rs * nseg; ++rest) sum += s_sq[2 * (rest * PAIRS + tid / 2) + (tid & 1)];
    part[tid] = sum;
  }
}

// Static shared memory of the kernel for K (the arrays above).
constexpr int static_smem(int K) { return 4 * CT * 4 + K * K * CT * 4 + (MAX_SLOTS + 1) * 8; }

// The prepared weights' floats (`split_weights_kernel`): two parts of [cpad][kpad].
inline int64_t weight_floats(int cin, int cexp) {
  return 2ll * ((cexp + CT - 1) / CT * CT) * (std::max(1, (cin + KCH - 1) / KCH) * KCH);
}

template <int K>
int launch_f32(const void* x, const void* w_exp, const Bn& bn, const void* w_dw, void* out,
               void* partials, void* wprep, int batch, int H, int W, int cin, int cexp,
               cudaStream_t stream) {
  const tc::Geo g = tc::geometry(H, W, K);
  auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  const int nch = std::max(1, (cin + KCH - 1) / KCH), kpad = nch * KCH;
  const int cpad = (cexp + CT - 1) / CT * CT;
  if (wprep == nullptr || !aligned(wprep, 16)) return static_cast<int>(cudaErrorInvalidValue);
  split_weights_kernel<<<dim3(kpad / 32, (cpad + 31) / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(w_exp), static_cast<float*>(wprep), cin, cexp, cpad, kpad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // TMA reads rows of Cin floats: Cin a multiple of 4 (16-byte strides) and x on a
  // 16-byte boundary; else the chunks are staged element by element
  const int tma = cin > 0 && cin % 4 == 0 && aligned(x, 16);
  const int ovec = cexp % 2 == 0 && aligned(out, 8);
  const int ring = (K - 1 + g.rs) * ring_cols(g.sw, K) * ES * 4;
  auto smem_of = [&](int resident, int slots) {
    return 1024 + slots * slot_size(resident) + (resident ? nch * W_BYTES : 0) + ring;
  };
  // the weights resident where two blocks an SM still fit (228 KB, 1 KB of it reserved
  // a block), else streamed through the slots with x (two blocks an SM at every B5 and
  // V2-S shape); the most slots that keep the count
  int resident = -1, slots = 0;
  for (int pref = 0; pref < 4 && resident < 0; ++pref)
    for (int n = MAX_SLOTS; n >= 2 && resident < 0; --n) {
      const int bytes = smem_of(PREFER[pref][1], n) + static_smem(K);
      if (bytes <= 232448 && 233472 / (bytes + 1024) >= PREFER[pref][0]) {
        resident = PREFER[pref][1];
        slots = n;
      }
    }
  if (resident < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_of(resident, slots);
  auto kernel = expand_dw_f32_kernel<K>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  if (tma) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cin) * 4,
                                   static_cast<cuuint64_t>(W) * cin * 4,
                                   static_cast<cuuint64_t>(H) * W * cin * 4};
    const cuuint32_t box[4] = {KCH, static_cast<cuuint32_t>(g.ncp), static_cast<cuuint32_t>(g.rs), 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box,
               unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kpad), static_cast<cuuint64_t>(cpad), 2};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kpad) * 4,
                                   static_cast<cuuint64_t>(cpad) * kpad * 4};
    const cuuint32_t box[3] = {KCH, CT, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, wprep, dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // channel tiles run fastest, so the blocks that read one strip read it from L2
  const dim3 grid(cpad / CT, g.n_s * g.n_seg, batch);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, THREADS, smem, stream>>>(
      xmap, wmap, static_cast<const float*>(x), bn, static_cast<const float*>(w_dw),
      static_cast<float*>(out), static_cast<float*>(partials), H, W, cin, cexp, g.sw, g.sh, g.n_s,
      g.ncp, g.rs, slots, resident, tma, ovec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// Output tiles of one image and channel tile (the partials' middle dimension): the
// strips and segments of `tc::geometry`, for both dtypes (0 = float32, 1 = bfloat16).
extern "C" int mbconv_expand_dw_tiles(int dtype, int H, int W) {
  (void)dtype;
  const tc::Geo g = tc::geometry(H, W, 3);  // strips and segments do not depend on K
  return g.n_s * g.n_seg;
}

// The floats of the fp32 path's prepared weights (the C entry's `wprep`; 0 for bf16).
extern "C" int64_t mbconv_expand_dw_weight_floats(int dtype, int cin, int cexp) {
  return dtype == 0 ? f32::weight_floats(cin, cexp) : 0;
}

// The partials' last dimension: Cexp rounded up to the channel tile.
extern "C" int mbconv_expand_dw_channels(int cexp) {
  return (cexp + CHANNEL_TILE - 1) / CHANNEL_TILE * CHANNEL_TILE;
}

// dtype: 0 = float32, 1 = bfloat16. k: 3 or 5. bn1, bn2: mean, mul and bias [Cexp] f32
// each. partials: f32 scratch of [batch, mbconv_expand_dw_tiles(dtype, H, W),
// mbconv_expand_dw_channels(cexp)]; wprep (fp32 only): f32 scratch of
// mbconv_expand_dw_weight_floats(0, cin, cexp) values on a 16-byte boundary; table
// (bf16 only): the SiLU table; squeeze [batch, cexp] f32. fp32 launches
// `split_weights_kernel` first; then the kernel, then `squeeze_tiles_kernel`, all on
// `stream`. Returns a cudaError_t value (cudaErrorInvalidValue for an unsupported
// dtype or k).
extern "C" int mbconv_expand_dw(int dtype, int k, const void* x, const void* w_exp,
                                const void* mean1, const void* mul1, const void* bias1,
                                const void* w_dw, const void* mean2, const void* mul2,
                                const void* bias2, void* out, void* squeeze, void* partials,
                                void* wprep, const void* table, int batch, int H, int W, int cin, int cexp,
                                void* stream) {
  if (batch == 0 || cexp == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 0 || W == 0)
    return static_cast<int>(cudaMemsetAsync(squeeze, 0, sizeof(float) * batch * cexp, st));
  const Bn bn{static_cast<const float*>(mean1), static_cast<const float*>(mul1),
              static_cast<const float*>(bias1), static_cast<const float*>(mean2),
              static_cast<const float*>(mul2), static_cast<const float*>(bias2)};
  int err;
  if (dtype == 0 && k == 3)
    err = f32::launch_f32<3>(x, w_exp, bn, w_dw, out, partials, wprep, batch, H, W, cin, cexp, st);
  else if (dtype == 0 && k == 5)
    err = f32::launch_f32<5>(x, w_exp, bn, w_dw, out, partials, wprep, batch, H, W, cin, cexp, st);
  else if (dtype == 1 && k == 3)
    err = tc::launch_bf16<3>(x, w_exp, bn, w_dw, out, partials, table, batch, H, W, cin, cexp, st);
  else if (dtype == 1 && k == 5)
    err = tc::launch_bf16<5>(x, w_exp, bn, w_dw, out, partials, table, batch, H, W, cin, cexp, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const int64_t n = static_cast<int64_t>(batch) * cexp;
  squeeze_tiles_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(squeeze),
      mbconv_expand_dw_tiles(dtype, H, W), cexp, mbconv_expand_dw_channels(cexp), n);
  return static_cast<int>(cudaGetLastError());
}

// r = the bf16 SiLU's sigmoid (`sigmoid_bf16`) of n bf16 values a, as bf16: the
// kernel's SiLU table is this function of its 3844 inputs (`ops.cuda_mbconv.silu_table`).
extern "C" int mbconv_sigmoid_bf16(const void* a, void* r, int n, void* stream) {
  if (n <= 0) return 0;
  sigmoid_bf16_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<uint16_t*>(r), n);
  return static_cast<int>(cudaGetLastError());
}
