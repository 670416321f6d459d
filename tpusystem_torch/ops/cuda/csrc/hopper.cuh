// Hopper (sm_90a) building blocks of the flash kernels (K1 in flash_fwd.cu,
// the fused backward K2a/K2b in flash_bwd.cu), the grouped MoE products
// (K6/K7 in grouped_matmul.cu), the decode matmul and FFN (K4, K5 in
// decode_matmul.cu)
// and the ordered fold (K9 in embedding_lookup.cu): TMA tensor maps and
// loads, 1-D bulk copies, cp.async, ldmatrix, mbarriers, named barriers,
// thread-block clusters and their distributed shared memory, mma.sync,
// wgmma shared-memory descriptors, the wgmma instructions and the
// accumulator -> A-fragment packing. Header only; every function is inline, so each source
// that includes it compiles its own copy.
//
// Layout facts the code relies on (PTX ISA 8.x, "Asynchronous warpgroup
// level matrix multiply" and "Tensor copy"; CUTLASS's cute/arch/mma_sm90_desc
// and mma_traits_sm90_gmma give the same canonical layouts):
//
//   * TMA swizzle. A box whose inner extent is R bytes, R in {32, 64, 128},
//     loaded with CU_TENSOR_MAP_SWIZZLE_{R}B, lands in shared memory as rows
//     of R bytes, row r at r * R, with the 16-byte chunk x of a row stored at
//     chunk x ^ (bits 7-9 of its address, as many bits as the row has chunk
//     bits). That is cute's Swizzle<log2(R/16), 4, 3> on byte addresses, the
//     pattern wgmma's layout types 1 (128B), 2 (64B) and 3 (32B) read. The
//     pattern repeats every 8 * R bytes, so every tile base is 1024-byte
//     aligned and the descriptors' base_offset field stays 0.
//   * The inner box is at most the swizzle width: a head dim of 128 bf16
//     (256 bytes) is two boxes of 64 columns, two separate [rows x 128 B]
//     blocks in shared memory, each with its own descriptor base.
//   * Out-of-bounds box elements (rows past the sequence end) are written as
//     zeros (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) and still count in the bytes
//     the mbarrier's transaction count waits for: expect the whole box.
//   * wgmma descriptor (64 bits): start address >> 4 in bits 0-13, leading
//     byte offset (LBO) >> 4 in bits 16-29, stride byte offset (SBO) >> 4 in
//     bits 32-45, base offset in bits 49-51, layout type in bits 62-63.
//   * K-major operand (rows of the M or N dimension, K contiguous; q and k):
//     SBO is the stride between groups of 8 rows (8 * R bytes); LBO is not
//     read while one k16 step (32 bytes) lies inside a swizzled row, and is
//     set to 16 bytes. Step k16 number i of a row starts 32 * i bytes in:
//     the hardware applies the swizzle to the address it computes, so the
//     start address advances by plain byte offsets inside the pattern.
//   * MN-major operand (rows of K, N contiguous; v for P.V, read with the
//     transpose bit): rows of R bytes hold R / 2 columns of N, 8 rows of K at
//     R bytes form a core group, SBO is the stride between groups of 8 K
//     rows (8 * R bytes), LBO the stride between R-byte column blocks of N.
//     The flash kernels issue one instruction per column block (N <= 64 at
//     the 128-byte swizzle), so LBO is not read there; the grouped products
//     read 128 columns (two blocks) in one instruction, so it is read there.
//   * An MN-major A operand (the fused backward's dQ = dS K, A = dS read
//     from the dS^T tile: rows of K = kv, M = 64 query columns contiguous)
//     is the same canonical layout with M in N's place, read with the
//     transpose bit on A (imm-trans-a = 1; 16-bit types only): R = 128
//     bytes hold the 64 rows of M, SBO is 8 * R, k16 step s starts 16 * s
//     * R bytes in. A tile written by ordinary stores must carry the TMA's
//     swizzle by hand: element (row r, column c) of a [rows x 64] bf16 tile
//     at r * 128 + ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2, from a
//     1024-byte aligned base; and fence.proxy.async must order those
//     generic-proxy stores before the wgmma (async proxy) reads them.
//   * The same MN-major B at a narrower swizzle (the k tile of the fused
//     backward, boxes of D / 2 columns at D = 64 / 32: 64 / 32-byte rows)
//     holds N = R / 2 columns in one block, so a warpgroup's half of dQ's
//     columns is one whole block with its own base: no start address ever
//     falls inside a swizzled row along N.
//   * Accumulator of wgmma.m64nNk16 (float32): thread t of the warpgroup
//     (warp w = t / 32, lane l = t % 32) holds, for each n8 column chunk j,
//     d[4j + 0..3] = (row 16w + l/4, col 8j + 2(l%4)), (same row, col + 1),
//     (row + 8, col), (row + 8, col + 1). A row's 8 * N/8 values lie in the
//     four lanes of one quad (l/4 equal), so row reductions are two
//     __shfl_xor_sync (masks 1 and 2).
//   * A fragment of wgmma.m64nNk16 from registers (16-bit types): four
//     32-bit registers, each two bf16 (lower column in the low half):
//     a0 = (row 16w + l/4, k 2(l%4), +1), a1 = (row + 8, same k),
//     a2 = (row, k 8 + 2(l%4), +1), a3 = (row + 8, k 8 + ...). For the k16
//     slice s of a float32 accumulator that is d[8s + 0..7] packed in pairs
//     in order: the accumulator's layout is already the A layout, no shuffle.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is taken
// through the runtime's entry-point query, so the libraries link no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// The swizzle of a box whose rows are `row_bytes` (32, 64 or 128) wide.
inline CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A map over a contiguous bf16 [B, S, H, D] tensor, 4-D innermost first
// (D, H, S, B), whose box is `rows` sequence positions of one head by `cols`
// head-dim columns: it lands as `rows` rows of cols * 2 bytes, swizzled at
// that width, rows past S zero-filled. Returns cudaErrorInvalidValue if the
// encoder refuses it (a base or stride off 16 bytes, a box it cannot take).
inline cudaError_t encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                               int rows, int cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1u, static_cast<cuuint32_t>(rows),
                             1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult result = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(cols * 2),
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return result == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over a contiguous bf16 [d2, d1, d0] tensor (d0 innermost) whose box
// is `rows` of d1 by `cols` of d0 within one index of d2: it lands as
// `rows` rows of cols * 2 bytes, swizzled at that width, elements past d0
// or d1 zero-filled (a group's rows never run into the next group's).
// Returns cudaErrorInvalidValue if the encoder refuses it.
inline cudaError_t encode_3d(CUtensorMap* map, const void* base, int d2, int d1, int d0,
                             int rows, int cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 2,
                                 static_cast<cuuint64_t>(d1) * d0 * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  const CUresult result = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(cols * 2),
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return result == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over a contiguous row-major [rows, cols] matrix of `element_bytes`
// (2: bf16; 1: int8 or e4m3, moved as bytes) whose box is `box_rows` rows
// by `box_cols` columns: it lands as box_rows rows of box_cols *
// element_bytes bytes, swizzled at that width when `swizzle` (32, 64 or 128
// bytes, the row's width), elements past the matrix zero-filled. Returns
// cudaErrorInvalidValue if the encoder refuses it (a base or row stride off
// 16 bytes, a box over 256 in either dimension).
inline cudaError_t encode_2d(CUtensorMap* map, const void* base, int rows, int cols,
                             int element_bytes, int box_rows, int box_cols, bool swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * element_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1u, 1u};
  const CUresult result = encode(
      map, element_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? swizzle_for(box_cols * element_bytes) : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return result == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_address(const void* pointer) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(pointer));
}

// mbarriers: one arrival (the thread that posts the expected bytes), the
// rest is the TMA's transaction count. A barrier's n-th completion (from 0)
// is waited for with parity n & 1.
__device__ __forceinline__ void mbarrier_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA); a
// __syncthreads() after it makes them visible to the block
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbarrier_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// one plain arrival (a consumer releasing what it has read)
__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spins in one asm statement (its labels are local to the braces), so the
// warp leaves it as it entered it, converged for the .aligned wgmma after it
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16) from a 16-byte aligned global
// address into shared memory at `dst`, completing `bytes` of the barrier's
// transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// makes this thread's ordinary shared-memory stores visible to the async
// proxy (a wgmma reading the tile through a descriptor); a barrier after it
// orders every thread's stores before the reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes from a 16-byte aligned global address into shared memory at
// `dst` without passing through registers, through L1 (.ca: many threads
// reading one row, as a gather's repeated ids do, hit L1 instead of one L2
// slice); `bytes` 0 writes zeros and reads nothing. cp_async_arrive makes
// the barrier see one arrival (counted in its expected arrivals) once every
// cp.async this thread issued before it landed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory, one row address a lane (lanes
// 8 m .. 8 m + 7 address matrix m's rows): thread l receives row l / 4,
// columns 2 (l % 4) and + 1 of each, the layout of an A fragment register
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t address) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(address)
               : "memory");
}

// two 8 x 8 bf16 matrices, lanes 0-7 addressing matrix 0's rows, 8-15
// matrix 1's: thread l receives row l / 4, columns 2 (l % 4) and + 1 of each
// (an A fragment's registers 0 and 2 when rows 8-15 are zero)
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t address) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(address)
               : "memory");
}

// two 8 x 8 bf16 matrices, transposed: lanes 0-7 address matrix 0's rows,
// 8-15 matrix 1's; thread l receives column l / 4, rows 2 (l % 4) and + 1 of
// each. From a row-major [k][n] tile (rows of k) that is mma.sync's B
// fragment of a k16 x n8 step: b0 from rows k..k+7, b1 from k+8..k+15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, uint32_t address) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(address)
               : "memory");
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, float32 sums (mma.sync):
// a from ldmatrix_x4 over a row-major [m][k] tile (lanes 0-15 rows 0-15 at
// k, 16-31 the same rows at k + 8), b from ldmatrix_x2_trans; thread l holds
// d0, d1 = (row l / 4, columns 2 (l % 4), + 1), d2, d3 = (row l / 4 + 8,
// the same columns)
__device__ __forceinline__ void mma_m16n8k16_bf16(float* d, const uint32_t* a,
                                                  const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// TMA: the box of `map` at coordinates (c0 innermost .. c3) into shared
// memory at `dst`, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the same for a 3-D map (c0 innermost)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the same for a 2-D map (c0 the column, c1 the row)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// this block's rank in its thread-block cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// a cluster barrier in two halves: every thread of every block arrives early
// (relaxed: it orders no memory; the barrier inits before it are published
// by their fence) and waits where another block's shared memory is first
// touched
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the address in the shared memory of the cluster's block `rank` at the
// offset `address` has in this block's own
__device__ __forceinline__ uint32_t cluster_address(uint32_t address, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(address), "r"(rank));
  return remote;
}

// four floats stored asynchronously at a 16-byte aligned cluster address
// (another block's shared memory), completing 16 bytes of the transaction
// count of the barrier at the cluster address `remote_bar` (in that block);
// the values leave from registers, so the storing block may exit at once
__device__ __forceinline__ void store_async_float4(uint32_t remote, float a, float b, float c,
                                                   float d, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(remote_bar)
      : "memory");
}

// mbarrier_wait acquiring at cluster scope: the writes other blocks released
// with their arrivals are visible after it
__device__ __forceinline__ void mbarrier_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a barrier over `threads` threads (whole warps) of the block, by id 1-15
// (0 is __syncthreads()'s): one warpgroup syncs without the others
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma layout types of the descriptor, by swizzle width
constexpr int layout_for(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

__device__ __forceinline__ uint64_t smem_descriptor(uint32_t address, uint32_t lbo, uint32_t sbo,
                                                    int layout) {
  return static_cast<uint64_t>((address & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// orders the registers and shared memory the next wgmma reads after the
// writes before it (needed whenever an accumulator or an A fragment was
// written by ordinary instructions)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across a
// wgmma issue or wait (the asm has no operands that would order them)
template <int N>
__device__ __forceinline__ void fence_registers(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the same for packed A fragments: keeps them live (unmoved, unreused) until
// the wait after the wgmma that reads them from registers
template <int N>
__device__ __forceinline__ void fence_fragments(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// two floats rounded to bf16 and packed as one A-fragment register, the
// lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n128k16(float* d, uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory; TA / TB
// = 1 reads that operand MN-major (the transpose bit), 0 K-major. An
// MN-major B of 128 columns at the 128-byte swizzle is two 64-column blocks,
// LBO apart.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A in registers, B from shared
// memory, K-major (TB = 0) or MN-major (TB = 1, two 64-column blocks LBO
// apart at the 128-byte swizzle)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory; TA / TB = 1
// reads that operand MN-major (the transpose bit), 0 K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float* d, uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n16k16(float* d, uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// the both-from-shared-memory product at N = 16, 32 or 64 columns
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 16) {
    wgmma_ss_m64n16k16<TA, TB>(d, a, b, accumulate);
  } else if constexpr (N == 32) {
    wgmma_ss_m64n32k16<TA, TB>(d, a, b, accumulate);
  } else {
    static_assert(N == 64, "wgmma_ss: N must be 16, 32 or 64");
    wgmma_ss_m64n64k16<TA, TB>(d, a, b, accumulate);
  }
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n16k16(float* d, const uint32_t* a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n32k16(float* d, const uint32_t* a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the A-from-registers product at N = 16, 32 or 64 columns
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 16) {
    wgmma_rs_m64n16k16(d, a, b, accumulate);
  } else if constexpr (N == 32) {
    wgmma_rs_m64n32k16(d, a, b, accumulate);
  } else {
    static_assert(N == 64, "wgmma_rs: N must be 16, 32 or 64");
    wgmma_rs_m64n64k16(d, a, b, accumulate);
  }
}

}  // namespace hopper
