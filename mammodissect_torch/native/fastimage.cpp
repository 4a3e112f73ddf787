// Packed-wire host kernels of the dissection harvest (dissect/packing.py): the
// packing part of mammodissect/native/fastimage.cpp, copied.
//
// The packed uint8 wire's host cost is per-ROW work over [B, H, W, C] batches:
// find each row's [first, last] nonzero span, then copy span bytes contiguously
// into one flat payload. numpy does both with full-frame boolean masks and fancy
// indexing (about 4 passes over the batch); here each is one forward/backward
// scan and one memcpy per row. Exposed to Python through ctypes
// (mammodissect_torch/native/__init__.py), which builds this file with g++ on
// first use.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

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
