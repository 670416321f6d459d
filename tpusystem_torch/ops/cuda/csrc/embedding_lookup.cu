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
// bit, with no float atomics. Only the adds are ordered, so what bounds it
// is the longer of two times: the bytes, and the longest segment's chain of
// dependent float32 adds (4 cycles each: a Zipf head id repeated ~16,600
// times in a batch of 65,536 costs ~34 us at 1.98 GHz however wide the
// card). The design:
//   1. the wrapper sorts (id, j) stably by id (index bookkeeping, a library
//      sort); ids >= table_rows (sentinels) sort to the end;
//   2. stage_products_kernel<BF16, VEC> writes the products, rounded, in
//      sorted order into a float32 scratch laid out in planes of GROUP = 16
//      columns, [ceil(dim / 16)][n][16] (coalesced, fully parallel: the
//      products do not depend on the order of the sum), for the positions
//      that can lie in a long segment (below). The staging is kept for
//      those, not fused into their sum, so that a long segment's products of
//      one plane are one contiguous run: a 1-D bulk copy moves 256 of its
//      positions at a time, where a fused pass would need a copy per row.
//      The other positions are not staged: the short path forms their
//      products itself, so the scratch costs nothing on the DLRM's table
//      path and on a fold's tail;
//   3. segment_fold_kernel finds segment starts and lengths on the card (no
//      host round trip) and splits the work two ways:
//      * a segment of long_min (the wrapper's LONG_SEGMENT, 256) positions or
//        more is summed by one block per plane: one producer thread keeps
//        bulk copies of its plane's contiguous run landing in a 4-stage ring
//        of 256 positions (64 KB) under full / empty mbarriers, and one
//        warp, a lane a column, runs the chain: a shared-memory read and a
//        back-to-back __fadd_rn per position, no shuffle, no predicate, no
//        global load on it. The plane's width sets how many SMs share a long
//        segment and what each must pull: 16 columns of float32 are 64 B a
//        position, 32 GB/s at 4 cycles an add and 1.98 GHz, which the
//        ring's 64 KB in flight covers at a few microseconds of latency; a
//        128-column segment runs on 8 SMs at once. (On the card, planes of
//        32 columns made the longest segment slower, planes of 8 the short
//        segments and wide rows.) Each long-path block checks 4
//        candidate positions q = k * long_min and sums the segments they
//        own, one after another through the same ring: a segment of long_min
//        or more is owned by its first multiple of long_min, so every long
//        segment has one owner; start and end are found by warp-wide 32-way
//        searches;
//      * shorter segments are summed many to a warp: a warp per 32 sorted
//        positions and 32 columns owns the segments that start there, walks
//        them in order with 32 positions' rows gathered ahead (a lane a
//        column; rows[order[p]] times its scale, rounded, as the staging
//        pass would) and writes each finished row once. The DLRM's table
//        path (one position a segment) and the fold's tail take this path.
//   __fmul_rn and __fadd_rn keep nvcc from contracting the product and the
//   add into one FMA, which would round once where the reference rounds
//   twice. The rows untouched by any id keep the caller's values (zeros).
//
// Plain C interface (bound with ctypes); every entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;          // rows (K8), sorted positions or short items (K9) per block
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

// K9's layout: the staged products in planes of GROUP columns, [planes][n]
// [GROUP]; a long segment streams through STAGES ring slots of RING
// positions (the design note above says why these sizes); a short-path warp
// starts segments in TILE sorted positions, over 32 columns.
constexpr int GROUP = 16;
constexpr int TILE = 32;
constexpr int RING = 256;
constexpr int STAGES = 4;
constexpr int SCOUTS = 4;   // long-segment candidates a long-path block checks
static_assert(GROUP % 4 == 0 && GROUP <= 32, "planes of 4 to 32 columns, whole float4s");
constexpr size_t RING_BYTES = static_cast<size_t>(STAGES) * RING * GROUP * sizeof(float);
constexpr size_t FOLD_SMEM = RING_BYTES + 2 * STAGES * sizeof(uint64_t) + 128;

// Pass 1: staged[g][p][c] = float(rows[order[p]][g * GROUP + c]) *
// scale[order[p]], each product rounded, in sorted order, for the positions
// that can lie in a segment of long_min or more: a position of such a
// segment has its id long_min / 2 positions before or after it too. The
// others (the short segments' and the sentinels') are left unwritten: the
// short path forms its own products. A warp per position, a lane per 4
// columns; VEC moves them as one 16-byte (float32) or 8-byte (bf16) load.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(THREADS)
    stage_products_kernel(const void* __restrict__ rows_, const float* __restrict__ scale,
                          const int* __restrict__ sorted_ids, const int64_t* __restrict__ order,
                          float* __restrict__ staged, int n, int dim, int table_rows,
                          int long_min) {
  using TRow = std::conditional_t<BF16, __nv_bfloat16, float>;
  const TRow* rows = static_cast<const TRow*>(rows_);
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= n) return;
  const int id = sorted_ids[p], half = long_min / 2;
  if (id < 0 || id >= table_rows) return;
  if (!((p >= half && sorted_ids[p - half] == id) || (p + half < n && sorted_ids[p + half] == id)))
    return;
  const int64_t j = order[p];
  const float s = scale[j];
  const TRow* row = rows + j * dim;
  for (int col = 4 * lane; col < dim; col += 4 * 32) {
    float4 product;
    float* v = &product.x;
    if constexpr (VEC) {
      const Pack<TRow, 4> in = *reinterpret_cast<const Pack<TRow, 4>*>(row + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __fmul_rn(to_float(in.v[i]), s);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = col + i < dim ? __fmul_rn(to_float(row[col + i]), s) : 0.0f;
    }
    float* dst = staged + (static_cast<int64_t>(col / GROUP) * n + p) * GROUP + col % GROUP;
    *reinterpret_cast<float4*>(dst) = product;
  }
}

__device__ __forceinline__ bool real_id(int id, int table_rows) {
  return id >= 0 && id < table_rows;
}

// The first p in [lo, hi) with ids[p] > bound, or hi: ids ascending, the
// whole warp searching 32 ways at a time (each step a round trip of
// independent loads).
__device__ int first_above(const int* __restrict__ ids, int lo, int hi, int bound, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const int below = __popc(__ballot_sync(FULL, p < hi && ids[p] <= bound));
    if (below == 0) return lo;
    hi = min(hi, lo + below * step);
    lo += (below - 1) * step + 1;
  }
  return lo + __popc(__ballot_sync(FULL, lo + lane < hi && ids[lo + lane] <= bound));
}

// The long segments owned by SCOUTS consecutive candidates, for one plane,
// one after another through one ring: warp 1's lane 0 keeps the bulk copies
// landing, warp 0 adds (a lane a column). Both warps find the same segments
// and count the same chunks, so the ring's phases stay in step.
__device__ __forceinline__ void fold_long(const float* __restrict__ staged,
                                          const int* __restrict__ ids, float* __restrict__ out,
                                          int n, int dim, int table_rows, int planes,
                                          int long_min, unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= 2) return;
  const int g = blockIdx.x % planes;
  const int64_t first = static_cast<int64_t>(blockIdx.x / planes) * SCOUTS;
  // the owner of a segment of long_min or more is its first multiple of
  // long_min; such a segment also holds q - long_min / 2 or q + long_min / 2
  const int half = long_min / 2;
  const int64_t q_wide = (first + lane) * long_min;
  int id = 0;
  bool owner = false;
  if (lane < SCOUTS && q_wide < n) {
    const int q = static_cast<int>(q_wide);
    id = ids[q];
    const bool before = q >= long_min && ids[q - long_min] == id;
    const bool near =
        (q >= half && ids[q - half] == id) || (q + half < n && ids[q + half] == id);
    owner = real_id(id, table_rows) && !before && near;
  }
  unsigned owners = __ballot_sync(FULL, owner);
  if (owners == 0) return;

  float* ring = reinterpret_cast<float*>(smem);
  const uint32_t full = hopper::smem_address(smem + RING_BYTES);
  const uint32_t empty = full + STAGES * sizeof(uint64_t);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbarrier_init(full + 8 * s, 1);
      hopper::mbarrier_init(empty + 8 * s, 1);
    }
    hopper::fence_barrier_init();
  }
  hopper::named_barrier(1, 64);
  int chunk = 0;  // the ring's chunks so far, over every segment of the block
  for (; owners != 0; owners &= owners - 1) {
    const int j = __ffs(owners) - 1;
    const int q = static_cast<int>((first + j) * long_min);
    const int segment = __shfl_sync(FULL, id, j);
    const int start = first_above(ids, max(q - long_min + 1, 0), q + 1, segment - 1, lane);
    const int length = first_above(ids, q + 1, n, segment, lane) - start;
    if (length < long_min) continue;  // the short path's
    const int chunks = (length + RING - 1) / RING;
    if (warp == 1) {
      if (lane == 0) {
        const float* run = staged + (static_cast<int64_t>(g) * n + start) * GROUP;
        for (int c = 0; c < chunks; ++c, ++chunk) {
          const int slot = chunk % STAGES;
          if (chunk >= STAGES) hopper::mbarrier_wait(empty + 8 * slot, (chunk / STAGES - 1) & 1);
          const uint32_t bytes = min(RING, length - c * RING) * GROUP * sizeof(float);
          hopper::mbarrier_expect_tx(full + 8 * slot, bytes);
          hopper::bulk_load(hopper::smem_address(ring + slot * RING * GROUP),
                            run + static_cast<int64_t>(c) * RING * GROUP, bytes, full + 8 * slot);
        }
      }
      chunk = __shfl_sync(FULL, chunk, 0);
      continue;
    }
    float acc = 0.0f;
    for (int c = 0; c < chunks; ++c, ++chunk) {
      const int slot = chunk % STAGES;
      hopper::mbarrier_wait(full + 8 * slot, (chunk / STAGES) & 1);
      const float* v = ring + slot * RING * GROUP + lane % GROUP;
      const int count = min(RING, length - c * RING);
      if (count == RING) {
#pragma unroll
        for (int i = 0; i < RING; ++i) acc = __fadd_rn(acc, v[i * GROUP]);
      } else {
        for (int i = 0; i < count; ++i) acc = __fadd_rn(acc, v[i * GROUP]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbarrier_arrive(empty + 8 * slot);
    }
    const int col = g * GROUP + lane;
    if (lane < GROUP && col < dim) out[static_cast<int64_t>(segment) * dim + col] = acc;
  }
}

// The segments of fewer than long_min positions that start in one tile of
// TILE sorted positions, for one span of 32 columns: walked in order, each
// position's product formed here (rows[order[p]] times its scale, rounded,
// TILE positions' rows loaded ahead, a lane a column), each finished row
// written once.
template <bool BF16>
__device__ __forceinline__ void fold_short(const void* __restrict__ rows_,
                                           const float* __restrict__ scale,
                                           const int64_t* __restrict__ order,
                                           const int* __restrict__ ids, float* __restrict__ out,
                                           int n, int dim, int table_rows, int spans,
                                           int long_min, int64_t item) {
  using TRow = std::conditional_t<BF16, __nv_bfloat16, float>;
  const TRow* rows = static_cast<const TRow*>(rows_);
  const int lane = threadIdx.x & 31;
  const int64_t t0_wide = item / spans * TILE;
  const int span = static_cast<int>(item % spans);
  if (t0_wide >= n) return;
  const int t0 = static_cast<int>(t0_wide), t1 = min(t0 + TILE, n);
  const int p = t0 + lane;
  const int id = p < n ? ids[p] : 0;
  const bool starts = p < n && (p == 0 || ids[p - 1] != id);
  const unsigned start_mask = __ballot_sync(FULL, starts);
  const unsigned owned = __ballot_sync(FULL, starts && real_id(id, table_rows));
  if (owned == 0) return;
  // sorted: negative ids, then real ids, then sentinels, so the owned starts
  // are consecutive; all but the last end inside the tile (short)
  const int first = __ffs(owned) - 1, last = 31 - __clz(owned);
  const int a = t0 + first, last_start = t0 + last;
  const unsigned later = start_mask & ~((2u << last) - 1);
  int b;
  if (later != 0) {
    b = t0 + __ffs(later) - 1;
  } else {
    const int cap = min(last_start + long_min, n);
    const int end = first_above(ids, t1, cap, __shfl_sync(FULL, id, last), lane);
    b = end - last_start >= long_min ? last_start : end;  // a long one is the long path's
  }
  const int col = span * 32 + lane;
  const bool mine = col < dim;
  float acc = 0.0f;
  int segment = 0;
  for (int base = a; base < b; base += TILE) {
    // lane i fetches position base + i's row index and scale
    const bool live = base + lane < b;
    const int64_t j = live ? order[base + lane] : 0;
    const float factor = live ? scale[j] : 0.0f;
    float v[TILE];
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      const int64_t row = __shfl_sync(FULL, j, i);
      v[i] = base + i < b && mine ? to_float(rows[row * dim + col]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      const int at = base + i;
      if (at >= b) break;
      if (at < t1 && ((start_mask >> (at - t0)) & 1u)) {
        if (at > a && mine) out[static_cast<int64_t>(segment) * dim + col] = acc;
        segment = __shfl_sync(FULL, id, at - t0);
        acc = 0.0f;
      }
      acc = __fadd_rn(acc, __fmul_rn(v[i], __shfl_sync(FULL, factor, i)));
    }
  }
  if (b > a && mine) out[static_cast<int64_t>(segment) * dim + col] = acc;
}

// Pass 2: blocks [0, long_blocks) check SCOUTS long-segment candidates each
// (from SCOUTS * (blockIdx / planes), plane blockIdx % planes); the rest
// hold WARPS short-path items each (tile item / spans, 32-column span
// item % spans).
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
    segment_fold_kernel(const float* __restrict__ staged, const void* __restrict__ rows,
                        const float* __restrict__ scale, const int64_t* __restrict__ order,
                        const int* __restrict__ sorted_ids, float* __restrict__ out, int n,
                        int dim, int table_rows, int planes, int long_min, int long_blocks) {
  extern __shared__ unsigned char dynamic_smem[];
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    unsigned char* smem =
        dynamic_smem + ((128 - (hopper::smem_address(dynamic_smem) & 127)) & 127);
    fold_long(staged, sorted_ids, out, n, dim, table_rows, planes, long_min, smem);
    return;
  }
  const int64_t item =
      static_cast<int64_t>(blockIdx.x - long_blocks) * WARPS + (threadIdx.x >> 5);
  fold_short<BF16>(rows, scale, order, sorted_ids, out, n, dim, table_rows, (dim + 31) / 32,
                   long_min, item);
}

template <bool BF16>
int launch_scatter(const void* rows, const void* scale, const void* sorted_ids, const void* order,
                   void* staged, void* out, int n, int dim, int table_rows, int long_min,
                   int vec, void* stream) {
  if (n < 0 || dim < 1 || table_rows < 0 || long_min < TILE || long_min % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || table_rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ids = static_cast<const int*>(sorted_ids);
  auto* stage = static_cast<float*>(staged);
  const dim3 stage_grid((n + WARPS - 1) / WARPS);
  auto* sc = static_cast<const float*>(scale);
  auto* ord = static_cast<const int64_t*>(order);
  if (vec)
    stage_products_kernel<BF16, true><<<stage_grid, THREADS, 0, s>>>(rows, sc, ids, ord, stage, n,
                                                                   dim, table_rows, long_min);
  else
    stage_products_kernel<BF16, false><<<stage_grid, THREADS, 0, s>>>(rows, sc, ids, ord, stage,
                                                                    n, dim, table_rows, long_min);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(segment_fold_kernel<BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(FOLD_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int planes = (dim + GROUP - 1) / GROUP;
  const int candidates = (n + long_min - 1) / long_min;
  const int64_t long_blocks = static_cast<int64_t>((candidates + SCOUTS - 1) / SCOUTS) * planes;
  const int64_t items = static_cast<int64_t>((n + TILE - 1) / TILE) * ((dim + 31) / 32);
  const int64_t blocks = long_blocks + (items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  segment_fold_kernel<BF16><<<static_cast<unsigned>(blocks), THREADS, FOLD_SMEM, s>>>(
      stage, rows, sc, ord, ids, static_cast<float*>(out), n, dim, table_rows, planes, long_min,
      static_cast<int>(long_blocks));
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

// Columns of one plane of K9's staged scratch: the wrapper allocates it as
// float32 [ceil(dim / GROUP), n, GROUP].
int scatter_group_columns() { return GROUP; }

// K9: out[id] = ordered float32 sum of float(rows[j]) * scale[j] over the j
// with ids[j] == id, for every id < table_rows; other rows of out are left
// as they are (the caller's zeros). rows [n, dim] (float32 or bf16); scale
// float32 [n]; sorted_ids int32 [n] and order int64 [n], the ids sorted
// stably and their positions; staged float32 [ceil(dim / 32), n, 32]
// scratch; out float32 [table_rows, dim]. Segments of long_min (even, >= 32)
// positions or more take the long path. vec != 0 takes vector loads of the
// rows: the caller checks that dim is a multiple of 4 and rows 16-byte
// (float32) or 8-byte (bf16) aligned.
int scatter_add_rows_f32(const void* rows, const void* scale, const void* sorted_ids,
                         const void* order, void* staged, void* out, int n, int dim,
                         int table_rows, int long_min, int vec, void* stream) {
  return launch_scatter<false>(rows, scale, sorted_ids, order, staged, out, n, dim, table_rows,
                               long_min, vec, stream);
}

int scatter_add_rows_bf16(const void* rows, const void* scale, const void* sorted_ids,
                          const void* order, void* staged, void* out, int n, int dim,
                          int table_rows, int long_min, int vec, void* stream) {
  return launch_scatter<true>(rows, scale, sorted_ids, order, staged, out, n, dim, table_rows,
                              long_min, vec, stream);
}

}  // extern "C"
