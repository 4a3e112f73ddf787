// Soft-WPMI gather + log-reduce for Hopper (sm_90a).
//
//   pde[u, c] = sum_k log(1 + p[k] * (clip_sm[inds[u, k], c] - 1) + eps)
//
// clip_sm [N, C] f32 (row-major, the softmaxed image x concept matrix),
// inds [U, k] int32 (each unit's top-k image rows), p [k] f32 -> pde [U, C] f32.
//
// Replaces the TPU kernel mammodissect/ops/pallas_wpmi.py::soft_wpmi_gather_logsum
// (body `_kernel`). That kernel stages a whole [N, 128] column block in VMEM and
// rides its indices in SMEM, which bounds it to per-layer unit counts; this one
// takes the dissection's main-path size in one launch (U = 6992 units of all 39
// B5 blocks, k = 100, C = 762, N up to the probe size).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
//   bytes that must move: the N*C*4 read of clip_sm, U*k*4 of indices, the
//   U*C*4 write (at N = 10k: 30 MB + 2.8 MB + 21 MB);
//   work: U*k*C ~ 5.3e8 terms of a few fp32 operations each. The gathered
//   traffic is U*k*C*4 ~ 2.1 GB, but clip_sm (30 MB at N = 10k) fits the 50 MB
//   L2, so the gathers are L2 hits after the first touch.
//
// A log per term (the first version) made the SFU's log sequence the limit. The
// sum of logs is the log of a product, so this kernel multiplies the terms and
// takes one logf per (unit, concept): log(m) + E * ln 2, where the running
// product is kept as a mantissa m in [1, 2) and an integer exponent sum E. Every
// R = 4 terms the exponent moves into E, so the product never leaves the normal
// range: a term is at least eps (1e-7 by default, 2^-23.3), and four of them times
// m >= 1 stay above FLT_MIN. The hot loop has no branch: a (unit, column) with a
// negative term, or whose group product ever falls below 2^-125 (terms under
// ~2^-31, zero or NaN), is flagged and redone at the end term by term through
// frexpf, so a zero term still gives -inf and a negative one NaN, as the plain
// version does. Each multiply adds at most 2^-24 relative rounding: <= ~6e-6
// absolute for k = 100, well inside the 1e-5 + 1e-5 |x| held against the plain
// version.
//
// Indices are checked where they are staged: one outside [0, N) sets the flag
// `bad` (zeroed by the entry point before the launch) and reads row 0 instead, so
// the kernel never reads out of bounds and the caller learns of it with the one
// host read of the flag, with no separate pass over the indices.
//
// Two designs, one launch either way:
// - slab (N * 128 bytes fit a block's shared memory: N <= ~1800, the main path's
//   N = 1024 included). Like the TPU kernel, a block holds a column block of
//   clip_sm, [N, 32] here, one concept column a lane, and every gather is a
//   shared-memory read free of bank conflicts (a warp reads one row's 32
//   consecutive floats). The block loads its slab once and runs a range of units
//   against it, each warp 4 units at a time: a lane loads one of each unit's next
//   32 indices, the warp stages them in shared memory as row offsets, and every
//   lane reads them back 4 at a time as one broadcast. With the gathers off the
//   L2, the instructions a term takes set the pace (~8: the gather and its
//   address, three for the term, a quarter of the group's product and exponent).
// - gather (larger N): grid over (concept tile, unit tile). A block of C_TILE
//   threads runs along the concept axis, two adjacent columns a thread (one
//   8-byte load where C is even), so every gathered row read is one coalesced 1 KB
//   segment from L2. The block stages its U_TILE units' indices (and p) in shared
//   memory, K_CHUNK at a time; each step issues the U_TILE x R gathers together
//   and reads the next step's indices while they are in flight. The L2's gather
//   rate sets its pace.
// Ragged tiles are masked, not padded.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int C_TILE = 128;   // threads per block, two concept columns each (gather design)
constexpr int U_TILE = 4;     // units per block (gather design)
constexpr int K_CHUNK = 128;  // indices staged in shared memory per pass (gather design)
constexpr int R = 4;          // terms multiplied between renormalisations
constexpr float LN2 = 0.693147180559945309f;

// m -> mantissa in [1, 2) (sign kept), its exponent added to e
__device__ __forceinline__ void renorm(float& m, int& e) {
  int ex;
  m = 2.0f * frexpf(m, &ex);
  e += ex - 1;
}

// multiply R terms into (m, e), m in [1, 2); t[j] is 1 for a masked term. The
// group's product v = m * q moves its exponent into e by integer arithmetic on its
// bits (the value frexpf would give, in a few instructions and no branch). ok
// turns false when a term is negative (an even number of them would leave q
// positive) or v is not a normal float of at least 2^-125 (a zero, NaN or tiny
// term; q itself was then not a normal float, m being below 2): (m, e) are then
// meaningless and the column is redone by logsum_exact.
__device__ __forceinline__ void mul_group(float& m, int& e, bool& ok, const float (&t)[R]) {
  const float q = (t[0] * t[1]) * (t[2] * t[3]);
  const int bits = __float_as_int(m * q);
  const int signs = __float_as_int(t[0]) | __float_as_int(t[1]) | __float_as_int(t[2]) |
                    __float_as_int(t[3]);
  ok &= signs >= 0 && static_cast<unsigned>(bits - 0x01000000) <= 0x7e7fffffu;  // 2^-125 <= v
  e += (bits >> 23) - 127;
  m = __int_as_float((bits & 0x007fffff) | 0x3f800000);
}

// pde of one (unit, column), term by term through frexpf: the column's value at
// base[row * stride]. The exact form, for the rare column whose grouped product
// left the normal range: a zero term gives -inf and a negative one NaN (whatever
// the other terms), as in the plain version. An index outside [0, n) reads row 0
// (the caller has flagged it).
__device__ __noinline__ float logsum_exact(const float* base, int64_t stride,
                                           const int32_t* unit_inds, const float* p, int n,
                                           int k, float eps) {
  float m = 1.0f;
  int e = 0;
  for (int kk = 0; kk < k; ++kk) {
    int row = unit_inds[kk];
    if (row < 0 || row >= n) row = 0;
    const float t = 1.0f + p[kk] * (base[row * stride] - 1.0f) + eps;
    m = t < 0.0f ? __int_as_float(0x7fffffff) : m * t;  // log of a negative term: NaN
    renorm(m, e);
  }
  return fmaf(static_cast<float>(e), LN2, logf(m));
}

__global__ void __launch_bounds__(C_TILE)
gather_logsum_kernel(const float* __restrict__ clip_sm, const int32_t* __restrict__ inds,
                     const float* __restrict__ p, float* __restrict__ out,
                     int* __restrict__ bad, int n, int c, int u, int k, float eps, int vec2) {
  __shared__ int32_t s_rows[U_TILE][K_CHUNK];
  __shared__ float s_p[K_CHUNK];

  const int col = (blockIdx.x * C_TILE + threadIdx.x) * 2;
  const int u0 = blockIdx.y * U_TILE;
  const int n_units = min(U_TILE, u - u0);
  const bool two = col + 1 < c;       // the second column exists
  const bool pair = vec2 && two;      // and both load as one float2

  float mx[U_TILE], my[U_TILE];
  int ex[U_TILE], ey[U_TILE];
  bool okx[U_TILE], oky[U_TILE];
#pragma unroll
  for (int i = 0; i < U_TILE; ++i) {
    mx[i] = my[i] = 1.0f;
    ex[i] = ey[i] = 0;
    okx[i] = oky[i] = true;
  }

  for (int k0 = 0; k0 < k; k0 += K_CHUNK) {
    const int kc = min(K_CHUNK, k - k0);
    __syncthreads();  // the previous chunk's indices are no longer read
    for (int i = threadIdx.x; i < U_TILE * K_CHUNK; i += C_TILE) {
      const int uu = i / K_CHUNK, kk = i % K_CHUNK;
      // masked units and steps gather row 0; their terms are never used
      int32_t row = 0;
      if (uu < n_units && kk < kc) {
        row = inds[(int64_t)(u0 + uu) * k + k0 + kk];
        if (row < 0 || row >= n) {
          *bad = 1;
          row = 0;
        }
      }
      s_rows[uu][kk] = row;
    }
    for (int kk = threadIdx.x; kk < K_CHUNK; kk += C_TILE) s_p[kk] = kk < kc ? p[k0 + kk] : 0.0f;
    __syncthreads();
    if (col >= c) continue;

    int rows[U_TILE][R];
    float pk[R];
    auto fetch = [&](int kb) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = min(kb + j, K_CHUNK - 1);
        pk[j] = s_p[kj];
#pragma unroll
        for (int uu = 0; uu < U_TILE; ++uu) rows[uu][j] = s_rows[uu][kj];
      }
    };
    fetch(0);
    for (int kk = 0; kk < kc; kk += R) {
      float2 xv[U_TILE][R];
      float pc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        pc[j] = pk[j];
#pragma unroll
        for (int uu = 0; uu < U_TILE; ++uu) {
          const float* src = clip_sm + (int64_t)rows[uu][j] * c + col;
          if (pair) {
            xv[uu][j] = __ldg(reinterpret_cast<const float2*>(src));
          } else {
            xv[uu][j].x = __ldg(src);
            xv[uu][j].y = two ? __ldg(src + 1) : 1.0f;
          }
        }
      }
      fetch(kk + R);  // the next step's indices while the gathers are in flight
#pragma unroll
      for (int uu = 0; uu < U_TILE; ++uu) {
        float tx[R], ty[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const bool live = kk + j < kc;
          tx[j] = live ? 1.0f + pc[j] * (xv[uu][j].x - 1.0f) + eps : 1.0f;
          ty[j] = live ? 1.0f + pc[j] * (xv[uu][j].y - 1.0f) + eps : 1.0f;
        }
        mul_group(mx[uu], ex[uu], okx[uu], tx);
        mul_group(my[uu], ey[uu], oky[uu], ty);
      }
    }
  }
  if (col >= c) return;
  for (int uu = 0; uu < n_units; ++uu) {
    float* dst = out + (int64_t)(u0 + uu) * c + col;
    const int32_t* unit_inds = inds + (int64_t)(u0 + uu) * k;
    const float vx = okx[uu] ? fmaf(static_cast<float>(ex[uu]), LN2, logf(mx[uu]))
                             : logsum_exact(clip_sm + col, c, unit_inds, p, n, k, eps);
    const float vy = oky[uu] || !two ? fmaf(static_cast<float>(ey[uu]), LN2, logf(my[uu]))
                                     : logsum_exact(clip_sm + col + 1, c, unit_inds, p, n, k, eps);
    if (pair) {
      *reinterpret_cast<float2*>(dst) = make_float2(vx, vy);
    } else {
      dst[0] = vx;
      if (two) dst[1] = vy;
    }
  }
}

// ---------------------------------------------------------------- slab design
constexpr int SLAB_W = 32;       // concept columns per block, one a lane
constexpr int SLAB_WARPS = 16;
constexpr int SLAB_UNITS = 4;    // units a warp carries at once
constexpr int SLAB_STEP = 32;    // indices a warp loads at once, one a lane

// shared memory of a block past its slab: each warp's staged row offsets and p
constexpr int SLAB_STAGE_BYTES = SLAB_WARPS * (SLAB_UNITS + 1) * SLAB_STEP * 4;

// kc terms (all SLAB_STEP when FULL) of SLAB_UNITS units into (m, e, ok); wi
// holds each unit's SLAB_STEP row offsets into the slab in bytes, wp the p's
template <bool FULL>
__device__ __forceinline__ void slab_steps(const char* __restrict__ slab_col,
                                           const int* __restrict__ wi,
                                           const float* __restrict__ wp, int kc, float eps,
                                           float (&m)[SLAB_UNITS], int (&e)[SLAB_UNITS],
                                           bool (&ok)[SLAB_UNITS]) {
#pragma unroll
  for (int t = 0; t < SLAB_STEP; t += R) {
    if (!FULL && t >= kc) break;
    // every lane reads the same 16 bytes: one broadcast a unit for R steps
    const float4 p4 = *reinterpret_cast<const float4*>(wp + t);
    const float pt[R] = {p4.x, p4.y, p4.z, p4.w};
    float x[SLAB_UNITS][R];
#pragma unroll
    for (int uu = 0; uu < SLAB_UNITS; ++uu) {
      const int4 r4 = *reinterpret_cast<const int4*>(wi + uu * SLAB_STEP + t);
      x[uu][0] = *reinterpret_cast<const float*>(slab_col + r4.x);
      x[uu][1] = *reinterpret_cast<const float*>(slab_col + r4.y);
      x[uu][2] = *reinterpret_cast<const float*>(slab_col + r4.z);
      x[uu][3] = *reinterpret_cast<const float*>(slab_col + r4.w);
    }
#pragma unroll
    for (int uu = 0; uu < SLAB_UNITS; ++uu) {
      float tt[R];
#pragma unroll
      for (int j = 0; j < R; ++j)
        tt[j] = FULL || t + j < kc ? 1.0f + pt[j] * (x[uu][j] - 1.0f) + eps : 1.0f;
      mul_group(m[uu], e[uu], ok[uu], tt);
    }
  }
}

__global__ void __launch_bounds__(SLAB_WARPS * 32, 1)
gather_logsum_slab_kernel(const float* __restrict__ clip_sm, const int32_t* __restrict__ inds,
                          const float* __restrict__ p, float* __restrict__ out,
                          int* __restrict__ bad, int n, int c, int u, int k, float eps,
                          int units_per_block) {
  extern __shared__ __align__(16) float slab[];  // [n][SLAB_W], then the warps' stages
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * SLAB_W + lane;
  const bool live = col < c;
#pragma unroll 8
  for (int r = warp; r < n; r += SLAB_WARPS)
    slab[r * SLAB_W + lane] = live ? __ldg(clip_sm + (int64_t)r * c + col) : 0.0f;
  int* const wi = reinterpret_cast<int*>(slab + n * SLAB_W) + warp * (SLAB_UNITS + 1) * SLAB_STEP;
  float* const wp = reinterpret_cast<float*>(wi + SLAB_UNITS * SLAB_STEP);
  __syncthreads();

  const char* const slab_col = reinterpret_cast<const char*>(slab + lane);
  const int ub = blockIdx.y * units_per_block, ue = min(u, ub + units_per_block);
  for (int u0 = ub + warp * SLAB_UNITS; u0 < ue; u0 += SLAB_WARPS * SLAB_UNITS) {
    float m[SLAB_UNITS];
    int e[SLAB_UNITS];
    bool ok[SLAB_UNITS];
#pragma unroll
    for (int uu = 0; uu < SLAB_UNITS; ++uu) {
      m[uu] = 1.0f;
      e[uu] = 0;
      ok[uu] = true;
    }
    for (int k0 = 0; k0 < k; k0 += SLAB_STEP) {
      const int kc = min(SLAB_STEP, k - k0);
      __syncwarp();  // the previous step's stage is no longer read
#pragma unroll
      for (int uu = 0; uu < SLAB_UNITS; ++uu) {
        // units past the range and steps past k read row 0; their terms are unused
        int row = 0;
        if (u0 + uu < ue && lane < kc) {
          row = inds[(int64_t)(u0 + uu) * k + k0 + lane];
          if (row < 0 || row >= n) {
            *bad = 1;
            row = 0;
          }
        }
        wi[uu * SLAB_STEP + lane] = row * SLAB_W * static_cast<int>(sizeof(float));
      }
      wp[lane] = lane < kc ? p[k0 + lane] : 0.0f;
      __syncwarp();
      if (kc == SLAB_STEP) {
        slab_steps<true>(slab_col, wi, wp, kc, eps, m, e, ok);
      } else {
        slab_steps<false>(slab_col, wi, wp, kc, eps, m, e, ok);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int uu = 0; uu < SLAB_UNITS; ++uu)
      if (u0 + uu < ue)
        out[(int64_t)(u0 + uu) * c + col] =
            ok[uu] ? fmaf(static_cast<float>(e[uu]), LN2, logf(m[uu]))
                   : logsum_exact(slab + lane, SLAB_W, inds + (int64_t)(u0 + uu) * k, p, n, k, eps);
  }
}

// the slab launch, or cudaErrorNotSupported when N's slab does not fit a block
int launch_slab(const float* clip_sm, const int32_t* inds, const float* p, float* out, int* bad,
                int n, int c, int u, int k, float eps, cudaStream_t st) {
  // the device's figures and the kernel's shared-memory opt-in, once a device
  constexpr int MAX_DEVICES = 64;
  static int max_smem[MAX_DEVICES], sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return cudaErrorNotSupported;
  auto kernel = gather_logsum_slab_kernel;
  if (max_smem[dev] == 0) {
    int opt_in = 0, count = 0;
    err = cudaDeviceGetAttribute(&opt_in, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, opt_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = count;
    max_smem[dev] = opt_in;
  }
  const size_t smem = static_cast<size_t>(n) * SLAB_W * sizeof(float) + SLAB_STAGE_BYTES;
  if (n == 0 || smem > static_cast<size_t>(max_smem[dev])) return cudaErrorNotSupported;
  // blocks an SM: as many slabs as shared memory holds (228 KB an SM, 1 KB of it
  // reserved a block), at most the 4 of 2048 threads
  const int per_sm = max(1, min(4, static_cast<int>((228 << 10) / (smem + 1024))));
  // about two blocks for each resident slot: every block loads its slab once, and
  // units come in rounds of one SLAB_UNITS group a warp
  const int tiles = (c + SLAB_W - 1) / SLAB_W;
  const int round = SLAB_WARPS * SLAB_UNITS;
  const int rounds = (u + round - 1) / round;
  const int want = max(1, min(rounds, (2 * sms[dev] * per_sm + tiles - 1) / tiles));
  const int units_per_block = (rounds + want - 1) / want * round;
  const dim3 grid(tiles, (u + units_per_block - 1) / units_per_block);
  kernel<<<grid, SLAB_WARPS * 32, smem, st>>>(clip_sm, inds, p, out, bad, n, c, u, k, eps,
                                              units_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bad: one int32 on the device, set to 1 when an index lies outside [0, n).
extern "C" int wpmi_gather_logsum(const void* clip_sm, const void* inds, const void* p,
                                  void* out, void* bad, int n, int c, int u, int k, float eps,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (u == 0 || c == 0) return 0;
  const int rc = launch_slab(static_cast<const float*>(clip_sm), static_cast<const int32_t*>(inds),
                             static_cast<const float*>(p), static_cast<float*>(out),
                             static_cast<int*>(bad), n, c, u, k, eps, st);
  if (rc != cudaErrorNotSupported) return rc;
  auto aligned8 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 8 == 0; };
  const int vec2 = c % 2 == 0 && aligned8(clip_sm) && aligned8(out);
  const dim3 grid((c + 2 * C_TILE - 1) / (2 * C_TILE), (u + U_TILE - 1) / U_TILE);
  gather_logsum_kernel<<<grid, C_TILE, 0, st>>>(
      static_cast<const float*>(clip_sm), static_cast<const int32_t*>(inds),
      static_cast<const float*>(p), static_cast<float*>(out), static_cast<int*>(bad), n, c, u,
      k, eps, vec2);
  return static_cast<int>(cudaGetLastError());
}
