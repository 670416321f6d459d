// Row gather (K8) and ordered row scatter-add (K9) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpusystem/ops/pallas/embedding_lookup.py:
//   * gather_rows_{f32,bf16,bf16_f32}  <- gather_rows / _gather_kernel           (K8)
//   * scatter_add_rows_{f32,bf16}      <- scatter_add_rows / _scatter_add_kernel (K9)
//
// What bounds them on an H100: bytes. Neither does more than one multiply
// and one add per element it moves, so the least time is the rows read and
// written over 3.35 TB/s. The TPU kernels stream rows between HBM and VMEM
// with DMAs; here every row is one coalesced pass of a warp.
//
// K8, out[j] = out_dtype(float(src[ids[j]]) * scale[j]):
//   * one warp per output row, eight rows per 256-thread block;
//   * 16-byte loads along dim where a row's bytes are a multiple of 16 (and
//     the pointers aligned), element loads otherwise;
//   * the id is clamped for memory safety and the row is read even when the
//     scale is 0, so the result is the reference's formula bit for bit
//     (embedding_lookup.py:133-134, :296): the product in float32, rounded
//     once to the output type (round to nearest even for bf16), which keeps
//     a signed zero and carries a NaN of the table through.
//
// K9, out[id] = sum over j with ids[j] == id, in ascending j, of
// float(rows[j]) * scale[j], each product rounded, then each add rounded,
// from 0.0: the TPU kernel's sequential read-modify-write (:204-219) bit for
// bit, with no float atomics:
//   1. the wrapper sorts (id, j) stably by id (index bookkeeping, a library
//      sort); ids >= table_rows (sentinels) sort to the end;
//   2. a staging pass writes each position's product, rounded, in sorted
//      order into an [n, dim] float32 scratch (coalesced, fully parallel:
//      the products do not depend on the order of the sum);
//   3. warps walk the sorted positions and skip those that do not start a
//      segment of a real id, so segment offsets need no host round trip;
//      the warp at a start sums its segment's staged rows in order, 8 columns of 4
//      positions per load, and writes the finished row once. Only the adds
//      are ordered: a segment's rows lie at consecutive positions, so the
//      next 128 are loaded while the current 128 are added, and a Zipf head
//      id repeated ~17,000 times in a batch costs a chain of dependent adds,
//      not of dependent loads.
//   __fmul_rn and __fadd_rn keep nvcc from contracting the product and the
//   add into one FMA, which would round once where the reference rounds
//   twice. The rows untouched by any id are the caller's zeros.
//
// Plain C interface (bound with ctypes); every entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // rows (K8) or sorted positions (K9) per block
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V elements moved as one access of V * sizeof(T) bytes.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename TIn, typename TOut, bool VEC>
__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const TIn* __restrict__ src, const int* __restrict__ ids,
                       const float* __restrict__ scale, TOut* __restrict__ out, int n, int dim,
                       int src_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (j >= n) return;
  const int id = min(max(ids[j], 0), src_rows - 1);
  const float s = scale[j];
  const TIn* row = src + static_cast<int64_t>(id) * dim;
  TOut* dst = out + j * dim;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(TIn);  // 4 float32 or 8 bf16 per 16-byte load
    for (int c = lane * V; c < dim; c += 32 * V) {
      const Pack<TIn, V> in = *reinterpret_cast<const Pack<TIn, V>*>(row + c);
      Pack<TOut, V> result;
#pragma unroll
      for (int i = 0; i < V; ++i) result.v[i] = from_float<TOut>(to_float(in.v[i]) * s);
      *reinterpret_cast<Pack<TOut, V>*>(dst + c) = result;
    }
  } else {
    for (int c = lane; c < dim; c += 32) dst[c] = from_float<TOut>(to_float(row[c]) * s);
  }
}

template <typename TIn, typename TOut>
int launch_gather(const void* src, const void* ids, const void* scale, void* out, int n, int dim,
                  int src_rows, int vec, void* stream) {
  if (n < 0 || dim < 1 || src_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* in = static_cast<const TIn*>(src);
  auto* id = static_cast<const int*>(ids);
  auto* sc = static_cast<const float*>(scale);
  auto* o = static_cast<TOut*>(out);
  if (vec)
    gather_rows_kernel<TIn, TOut, true><<<grid, THREADS, 0, s>>>(in, id, sc, o, n, dim, src_rows);
  else
    gather_rows_kernel<TIn, TOut, false><<<grid, THREADS, 0, s>>>(in, id, sc, o, n, dim, src_rows);
  return static_cast<int>(cudaGetLastError());
}

// The ordered sum: a warp covers 8 columns of 4 consecutive positions per
// load (lanes 8g..8g+7 hold position q + g), 32 such loads a batch.
constexpr int COLUMNS = 8;
constexpr int STEPS = 32;
constexpr int SPAN = 4 * STEPS;   // segment positions per batch
constexpr int SUM_BLOCKS = 512;   // blocks per column group; warps walk positions

// Pass 1: staged[p] = float(rows[order[p]]) * scale[order[p]], each product
// rounded, in sorted order; sentinel positions are left unwritten. A warp per
// position, a lane per column.
template <typename TRow>
__global__ void __launch_bounds__(THREADS)
    stage_products_kernel(const TRow* __restrict__ rows, const float* __restrict__ scale,
                          const int* __restrict__ sorted_ids, const int64_t* __restrict__ order,
                          float* __restrict__ staged, int n, int dim, int table_rows) {
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int col = blockIdx.y * 32 + (threadIdx.x & 31);
  if (p >= n || col >= dim) return;
  const int id = sorted_ids[p];
  if (id < 0 || id >= table_rows) return;
  const int64_t j = order[p];
  staged[static_cast<int64_t>(p) * dim + col] = __fmul_rn(to_float(rows[j * dim + col]), scale[j]);
}

// How many of the SPAN positions from q hold id (a prefix: ids are sorted).
__device__ __forceinline__ int segment_count(const int* __restrict__ sorted_ids, int n, int id,
                                             int q, int lane) {
  int count = 0;
#pragma unroll
  for (int k = 0; k < SPAN / 32; ++k) {
    const int position = q + 32 * k + lane;
    count += __popc(__ballot_sync(FULL, position < n && sorted_ids[position] == id));
  }
  return count;
}

// This lane's element of the first `limit` positions from q: position
// q + 4 i + g, column col, in value[i].
__device__ __forceinline__ void load_span(float (&value)[STEPS], const float* __restrict__ column,
                                          int q, int limit, int n, int dim, int g, bool in_row) {
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int offset = 4 * i + g;
    value[i] = (offset < limit && q + offset < n && in_row)
                   ? column[static_cast<int64_t>(q + offset) * dim]
                   : 0.0f;
  }
}

// Pass 2: the warp at a segment's first position sums the segment's staged
// rows from 0.0 in order, 8 columns per warp (blockIdx.y walks the column
// groups), and writes the finished row once. A segment's rows lie at
// consecutive positions, so while one batch of 128 is added the next is
// already being loaded, its ids with it: no index has to arrive before a row
// can be asked for. Each lane adds its column's four positions of a load in
// order through shuffles, so every lane of a column holds the same sum.
__global__ void __launch_bounds__(THREADS)
    segment_sum_kernel(const float* __restrict__ staged, const int* __restrict__ sorted_ids,
                       float* __restrict__ out, int n, int dim, int table_rows) {
  const int lane = threadIdx.x & 31;
  const int c = lane & 7, g = lane >> 3;
  const int col = blockIdx.y * COLUMNS + c;
  const bool in_row = col < dim;
  const float* column = staged + col;
  for (int p = blockIdx.x * WARPS + (threadIdx.x >> 5); p < n; p += gridDim.x * WARPS) {
    const int id = sorted_ids[p];
    // sentinels move nothing; a warp inside a segment leaves it to its first
    if (id < 0 || id >= table_rows || (p > 0 && sorted_ids[p - 1] == id)) continue;
    float value[STEPS], ahead[STEPS];
    int count = segment_count(sorted_ids, n, id, p, lane);
    load_span(value, column, p, count, n, dim, g, in_row);
    float acc = 0.0f;
    for (int q = p;; q += SPAN) {
      const bool more = count == SPAN && q + SPAN < n;
      int count_ahead = 0;
      if (more) {
        count_ahead = segment_count(sorted_ids, n, id, q + SPAN, lane);
        load_span(ahead, column, q + SPAN, SPAN, n, dim, g, in_row);
      }
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        if (4 * i >= count) break;  // a short segment stops early
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float v = __shfl_sync(FULL, value[i], (h << 3) | c);
          if (4 * i + h < count) acc = __fadd_rn(acc, v);
        }
      }
      if (!more) break;
      count = count_ahead;
#pragma unroll
      for (int i = 0; i < STEPS; ++i) value[i] = ahead[i];
    }
    if (in_row && g == 0) out[static_cast<int64_t>(id) * dim + col] = acc;
  }
}

template <typename TRow>
int launch_scatter(const void* rows, const void* scale, const void* sorted_ids, const void* order,
                   void* staged, void* out, int n, int dim, int table_rows, void* stream) {
  if (n < 0 || dim < 1 || table_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || table_rows == 0) return static_cast<int>(cudaSuccess);
  const int position_blocks = (n + WARPS - 1) / WARPS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ids = static_cast<const int*>(sorted_ids);
  auto* stage = static_cast<float*>(staged);
  stage_products_kernel<TRow><<<dim3(position_blocks, (dim + 31) / 32), THREADS, 0, s>>>(
      static_cast<const TRow*>(rows), static_cast<const float*>(scale), ids,
      static_cast<const int64_t*>(order), stage, n, dim, table_rows);
  const dim3 sum_grid(position_blocks < SUM_BLOCKS ? position_blocks : SUM_BLOCKS,
                      (dim + COLUMNS - 1) / COLUMNS);
  segment_sum_kernel<<<sum_grid, THREADS, 0, s>>>(stage, ids, static_cast<float*>(out), n, dim,
                                                  table_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K8: out[j] = out_type(float(src[clamp(ids[j])]) * scale[j]), j < n. src
// [src_rows, dim]; ids int32 [n]; scale float32 [n]; out [n, dim]. vec != 0
// takes 16-byte loads: the caller checks that dim * sizeof(src) is a
// multiple of 16 and that src and out are 16-byte aligned.
int gather_rows_f32(const void* src, const void* ids, const void* scale, void* out, int n,
                    int dim, int src_rows, int vec, void* stream) {
  return launch_gather<float, float>(src, ids, scale, out, n, dim, src_rows, vec, stream);
}

int gather_rows_bf16(const void* src, const void* ids, const void* scale, void* out, int n,
                     int dim, int src_rows, int vec, void* stream) {
  return launch_gather<__nv_bfloat16, __nv_bfloat16>(src, ids, scale, out, n, dim, src_rows, vec,
                                                     stream);
}

int gather_rows_bf16_f32(const void* src, const void* ids, const void* scale, void* out, int n,
                         int dim, int src_rows, int vec, void* stream) {
  return launch_gather<__nv_bfloat16, float>(src, ids, scale, out, n, dim, src_rows, vec, stream);
}

// K9: out[id] = ordered float32 sum of float(rows[j]) * scale[j] over the j
// with ids[j] == id, for every id < table_rows; other rows of out are left
// as they are (the caller's zeros). rows [n, dim] (float32 or bf16); scale
// float32 [n]; sorted_ids int32 [n] and order int64 [n], the ids sorted
// stably and their positions; staged float32 [n, dim] scratch; out float32
// [table_rows, dim].
int scatter_add_rows_f32(const void* rows, const void* scale, const void* sorted_ids,
                         const void* order, void* staged, void* out, int n, int dim,
                         int table_rows, void* stream) {
  return launch_scatter<float>(rows, scale, sorted_ids, order, staged, out, n, dim, table_rows,
                               stream);
}

int scatter_add_rows_bf16(const void* rows, const void* scale, const void* sorted_ids,
                          const void* order, void* staged, void* out, int n, int dim,
                          int table_rows, void* stream) {
  return launch_scatter<__nv_bfloat16>(rows, scale, sorted_ids, order, staged, out, n, dim,
                                       table_rows, stream);
}

}  // extern "C"
