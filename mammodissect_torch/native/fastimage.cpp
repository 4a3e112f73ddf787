// Native host kernels of the port's data paths: the eval resize of the float32
// image path and the packed-wire span packer of the dissection harvest
// (dissect/packing.py), copied from mammodissect/native/fastimage.cpp.
//
// fi_resize_normalize / fi_batch_resize_normalize: the float eval pipeline
// (resize to the probe's size, then min-max, then mean/std,
// `Datasets/dataset_concepts.py:212-215`) in one pass per output pixel, with the
// cv2-style bilinear sample at pixel centres and no antialiasing, as the JAX
// package's data path resizes whenever this library builds.
//
// The packed uint8 wire's host cost is per-ROW work over [B, H, W, C] batches:
// find each row's [first, last] nonzero span, then copy span bytes contiguously
// into one flat payload. numpy does both with full-frame boolean masks and fancy
// indexing (about 4 passes over the batch); here each is one forward/backward
// scan and one memcpy per row. Exposed to Python through ctypes
// (mammodissect_torch/native/__init__.py), which builds this file with g++ on
// first use.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

static inline float bilinear_sample(const float* src, int sh, int sw, float y, float x) {
  int y0 = (int)y;
  int x0 = (int)x;
  int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
  int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
  float fy = y - y0;
  float fx = x - x0;
  const float* r0 = src + (size_t)y0 * sw;
  const float* r1 = src + (size_t)y1 * sw;
  float top = r0[x0] * (1.f - fx) + r0[x1] * fx;
  float bot = r1[x0] * (1.f - fx) + r1[x1] * fx;
  return top * (1.f - fy) + bot * fy;
}

// Bilinear resample of float32 [sh, sw] -> [dh, dw], sampling at pixel centres
// with scale = src/dst (the source coordinate clamped to the image), then
// (x - lo)/(hi - lo) over the RESIZED image when do_minmax, then (x - mean)/std:
// pass 1 resizes while tracking min/max, pass 2 applies the fused affine
// x' = ((x - lo)/(hi - lo) - mean)/std = x*a + b.
void fi_resize_normalize(const float* src, int sh, int sw, float* dst, int dh, int dw,
                         int do_minmax, float mean, float std_) {
  float scale_y = (float)sh / dh;
  float scale_x = (float)sw / dw;
  float lo = 3.4e38f, hi = -3.4e38f;
  for (int oy = 0; oy < dh; ++oy) {
    float sy = (oy + 0.5f) * scale_y - 0.5f;
    if (sy < 0) sy = 0;
    if (sy > sh - 1) sy = (float)(sh - 1);
    for (int ox = 0; ox < dw; ++ox) {
      float sx = (ox + 0.5f) * scale_x - 0.5f;
      if (sx < 0) sx = 0;
      if (sx > sw - 1) sx = (float)(sw - 1);
      float v = bilinear_sample(src, sh, sw, sy, sx);
      if (v < lo) lo = v;
      if (v > hi) hi = v;
      dst[(size_t)oy * dw + ox] = v;
    }
  }
  float inv_std = 1.f / std_;
  float a, b;
  if (do_minmax) {
    float inv_range = hi > lo ? 1.f / (hi - lo) : 0.f;
    a = inv_range * inv_std;
    b = (-lo * inv_range - mean) * inv_std;
  } else {
    a = inv_std;
    b = -mean * inv_std;
  }
  for (size_t i = 0; i < (size_t)dh * dw; ++i) dst[i] = dst[i] * a + b;
}

// fi_resize_normalize over a batch [n, sh, sw] -> [n, dh, dw], images spread over
// n_threads threads.
void fi_batch_resize_normalize(const float* src, int n, int sh, int sw, float* dst,
                               int dh, int dw, int do_minmax, float mean, float std_,
                               int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      fi_resize_normalize(src + (size_t)i * sh * sw, sh, sw,
                          dst + (size_t)i * dh * dw, dh, dw, do_minmax, mean, std_);
    }
  };
  std::vector<std::thread> threads;
  int nt = n_threads < n ? n_threads : n;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Per-row nonzero spans of [n_rows] rows, each [W, C] uint8: start/length int32.
// "Nonzero" = any channel nonzero (matches packing.row_spans).
void fi_row_spans(const uint8_t* u8, int64_t n_rows, int64_t w, int64_t c,
                  int32_t* start, int32_t* length) {
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint8_t* row = u8 + r * w * c;
    int64_t nb = w * c;
    // byte-level scan: first/last nonzero BYTE, then round to pixel granularity;
    // the word-wise fast path skips zero bytes 8 at a time
    int64_t i = 0;
    while (i + 8 <= nb) {
      uint64_t v;
      std::memcpy(&v, row + i, 8);
      if (v != 0) break;
      i += 8;
    }
    while (i < nb && row[i] == 0) ++i;
    if (i == nb) {
      start[r] = 0;
      length[r] = 0;
      continue;
    }
    int64_t j = nb;
    while (j - 8 >= i) {
      uint64_t v;
      std::memcpy(&v, row + j - 8, 8);
      if (v != 0) break;
      j -= 8;
    }
    while (j > i && row[j - 1] == 0) --j;
    int32_t first_px = (int32_t)(i / c);
    int32_t last_px = (int32_t)((j - 1) / c);
    start[r] = first_px;
    length[r] = last_px - first_px + 1;
  }
}

// Pack [n_rows] rows' spans contiguously into `out` (row-major over rows, the
// packing.pack_batch order). Returns bytes written; the caller sizes `out` from
// sum(length) * c.
int64_t fi_pack_spans(const uint8_t* u8, int64_t n_rows, int64_t w, int64_t c,
                      const int32_t* start, const int32_t* length, uint8_t* out) {
  int64_t off = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t nb = (int64_t)length[r] * c;
    if (nb == 0) continue;
    std::memcpy(out + off, u8 + (r * w + start[r]) * c, (size_t)nb);
    off += nb;
  }
  return off;
}

// Threaded batch pack of a [B, H, W, C] batch in one call. Each image's payload
// lands at out + out_offsets[b]. Spans are caller-provided (fi_row_spans or a
// probe's precomputed spans): out_offsets are prefix sums of the span lengths.
void fi_batch_pack(const uint8_t* u8, int64_t b, int64_t h, int64_t w, int64_t c,
                   const int32_t* start, const int32_t* length,
                   uint8_t* out, const int64_t* out_offsets, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= b) return;
      const uint8_t* img = u8 + i * h * w * c;
      fi_pack_spans(img, h, w, c, start + i * h, length + i * h,
                    out + out_offsets[i]);
    }
  };
  std::vector<std::thread> threads;
  int nt = (int64_t)n_threads < b ? n_threads : (int)b;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
