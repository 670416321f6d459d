// Native batch-assembly core for tpusystem_torch.data (a copy of
// tpusystem/data/native/batcher.cpp).
//
// The reference's data path is torch DataLoader collation (pure Python in
// the repo; SURVEY.md §2.3 notes the reference itself ships no native code
// and delegates to torch). Here the host-side hot operation — gathering
// sample rows into a contiguous batch buffer the device transfer DMA-reads
// from — is a multithreaded memcpy in C++, called from Python via ctypes
// (ctypes foreign calls release the GIL, so gathers overlap the host loop).
//
// Deliberately minimal ABI: plain C, fixed-width types, no ownership — the
// caller (numpy) owns every buffer. Shuffle-order generation stays in
// Python so batch order is identical with or without this library.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Copy dst[i] = src[indices[i]] for i in [begin, end).
void gather_span(const char* src, const int64_t* indices, char* dst,
                 int64_t begin, int64_t end, int64_t row_bytes) {
  for (int64_t i = begin; i < end; ++i) {
    std::memcpy(dst + i * row_bytes, src + indices[i] * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

// Copy dst[i] = src[byte_starts[i] .. +window_bytes) for i in [begin, end).
// Windows may overlap in the source (stride < window is augmentation).
void window_span(const char* src, const int64_t* byte_starts, char* dst,
                 int64_t begin, int64_t end, int64_t window_bytes) {
  for (int64_t i = begin; i < end; ++i) {
    std::memcpy(dst + i * window_bytes, src + byte_starts[i],
                static_cast<size_t>(window_bytes));
  }
}

// Shared fan-out: run `span(src, offsets, dst, begin, end, bytes)` over
// [0, rows) across up to `threads` workers (auto when <= 0), staying
// single-threaded while the total copy is under ~1 MiB per worker.
template <typename Span>
void parallel_spans(Span span, const char* src, const int64_t* offsets,
                    char* dst, int64_t rows, int64_t row_bytes,
                    int32_t threads) {
  if (rows <= 0 || row_bytes <= 0) return;
  int64_t want = threads > 0 ? threads : std::thread::hardware_concurrency();
  const int64_t min_bytes_per_worker = 1 << 20;
  int64_t useful = (rows * row_bytes + min_bytes_per_worker - 1) /
                   min_bytes_per_worker;
  int64_t n = std::max<int64_t>(1, std::min({want, useful, rows}));
  if (n == 1) {
    span(src, offsets, dst, 0, rows, row_bytes);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(static_cast<size_t>(n));
  int64_t chunk = (rows + n - 1) / n;
  for (int64_t w = 0; w < n; ++w) {
    int64_t begin = w * chunk;
    int64_t end = std::min(rows, begin + chunk);
    if (begin >= end) break;
    workers.emplace_back(span, src, offsets, dst, begin, end, row_bytes);
  }
  for (auto& worker : workers) worker.join();
}

}  // namespace

extern "C" {

// ABI version probe — bump when the signatures below change.
int ts_abi_version() { return 2; }

// Gather `rows` rows of `row_bytes` bytes each from `src` into `dst`
// following `indices`. `threads` <= 0 means auto (hardware concurrency,
// capped so tiny batches stay single-threaded).
void ts_gather_rows(const char* src, const int64_t* indices, char* dst,
                    int64_t rows, int64_t row_bytes, int32_t threads) {
  parallel_spans(gather_span, src, indices, dst, rows, row_bytes, threads);
}

// Gather `windows` windows of `window_bytes` bytes each from `src` into
// `dst`; window i starts at byte offset `byte_starts[i]`. The LM-corpus
// hot path (MemmapTokens): overlapping sequence windows memcpy'd straight
// from the page cache instead of numpy's per-element fancy indexing.
void ts_gather_windows(const char* src, const int64_t* byte_starts, char* dst,
                       int64_t windows, int64_t window_bytes,
                       int32_t threads) {
  parallel_spans(window_span, src, byte_starts, dst, windows, window_bytes,
                 threads);
}

}  // extern "C"
