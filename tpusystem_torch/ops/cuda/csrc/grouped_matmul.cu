// Grouped gather-matmul (K6) and matmul-scatter (K7) for Hopper (sm_90a), bf16:
// TMA-fed wgmma tiles.
//
// Replaces the Pallas TPU kernels of tpusystem/ops/pallas/grouped_matmul.py:
//   * grouped_gather_matmul_bf16          <- gather_rows_matmul / _gather_matmul_kernel  (K6)
//   * grouped_matmul_rows_bf16 followed by
//     combine_rows_bf16                   <- matmul_scatter_rows / _matmul_scatter_kernel (K7)
//
// What bounds them on an H100: operations. At the MoE training shape (8
// experts, 5120 rows each, 768 x 3072) one call is 1.9e11 flops against
// ~0.3 GB moved, some 650 flops per byte, above the ~295 where the tensor
// cores become the limit. So the products run on wgmma, fed through a
// ring of shared-memory stages (hopper.cuh notes each layout fact).
//
// What the design does:
//   * Output tiles of 128 rows of one group (expert) x 128 columns, N tiles
//     innermost, so the blocks in flight share a group's A rows and weights
//     in L2. One persistent block per SM walks tiles blockIdx.x, +
//     gridDim.x, ...: 384 threads, warpgroup 0 produces, warpgroups 1 and 2
//     each multiply 64 of the rows with wgmma.m64n128k16 into 64 float32
//     registers a thread, then round and store their half of the tile while
//     the producer already fills the next tile's stages.
//   * The contraction runs in stages 64 deep (one 128-byte swizzle row of
//     bf16) through a ring of five, each stage's "full" mbarrier counting
//     the producer's 128 threads, one arrival that posts the TMA's bytes,
//     and those bytes; its "empty" mbarrier the eight consumer warps, which
//     release a stage once the wgmma reading it has completed.
//   * B (the weights) by TMA over a 3-D map of rhs: [groups, N, K] with
//     transpose_rhs, read K-major (a box of 128 N rows x 64 K); [groups, K,
//     N] without, read MN-major through wgmma's transpose bit (two boxes of
//     64 K rows x 64 columns, one instruction over both, LBO apart): the
//     N-contiguous weights are never transposed by hand.
//   * A in K7 by TMA over a 3-D map of lhs as [groups, C, K], so the box
//     zero-fills rows past C inside a group and never reads the next
//     group's; both operands from shared memory (wgmma SS), one stage's
//     products in flight behind the next one's issue.
//   * A in K6 is gathered: TMA on sm_90 cannot gather rows by id, so the
//     producer copies each row's 16-byte chunks from the unpermuted token
//     array by row_ids (the [groups * C, K] dispatch buffer is never formed)
//     with cp.async straight to the 128-byte swizzle's addresses, and the
//     stage's "full" barrier counts each thread's copies as they land, so
//     the producer never waits for its own loads. The copies go through L1
//     (.ca): every empty slot of the MoE layer reads the same clamped row,
//     and served from L2 alone those reads queue on one L2 slice, which
//     made the gather the kernel's largest cost at the MoE shape.
//     The consumers read the tile with ldmatrix (the A fragment layout),
//     multiply each pair by bf16(scale[j]) of its row in bf16, as the
//     reference does (grouped_matmul.py:135), and issue wgmma with A from
//     registers (RS); scaling in shared memory took the producer a second
//     pass over the tile. Scale 0 masks empty slots; ids are clamped for
//     memory safety.
//   * An operand TMA cannot map (a row off 16 bytes: K or N not a multiple
//     of 8, or a base off 16 bytes) is filled by the same producer with
//     masked ordinary loads into the same swizzled tile, fenced for the
//     async proxy: a load mode of the one kernel, read by the same
//     consumers.
//   * Epilogue: K7 adds the bias to the float32 accumulator; both round once
//     to bf16 into a padded shared tile of their own, then store rows r < C
//     in 16-byte pieces (element stores where N is not a multiple of 8).
//     Every row is computed, empty slots too, as the MoE backward reads
//     them.
//   * The reference then read-modify-writes out[row_ids[j]] += scale[j] *
//     row[j] in K7's epilogue, race-free only because TPU grid steps run in
//     order (grouped_matmul.py:22-25). On the card a token's k choices sit in
//     different blocks, so the combine is a second pass: one thread per
//     (token, 8 columns) walks that token's rows in ascending row order (the
//     reference's grid order) through a token -> row index the wrapper
//     builds with a stable integer sort, starting from zero and rounding
//     every product and every add to bf16 as the reference does
//     (grouped_matmul.py:285-286). No split of the contraction and no float
//     atomics: every output repeats bitwise.
//
// Plain C interface (bound with ctypes); every entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                 // buffer rows per block, all of one group
constexpr int BN = 128;                 // output columns per block
constexpr int BK = 64;                  // contraction depth per stage: 128 bytes
constexpr int STAGES = 5;
constexpr int PRODUCERS = 128;          // warpgroup 0
constexpr int THREADS = 3 * 128;        // the producer and two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int VEC = 8;                  // bf16 values per 16-byte load
constexpr int COMBINE_THREADS = 256;

// Shared memory from a 1024-byte aligned base: per stage the A tile [128
// rows x 128 B] and the B tile (K-major [128 N rows x 128 B], or MN-major
// two [64 K rows x 128 B] blocks of 64 columns), then the output staging
// tile (rows padded to 272 B: the accumulator's pair stores hit 32
// distinct banks), then the mbarriers.
constexpr uint32_t A_BYTES = BM * BK * 2;
constexpr uint32_t B_BYTES = BN * BK * 2;
constexpr uint32_t B_BLOCK = BK * 128;  // one 64-column block of an MN-major B
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_PITCH = BN * 2 + 16;
constexpr uint32_t OUT_OFF = STAGES * STAGE_BYTES;
constexpr uint32_t FULL_OFF = OUT_OFF + BM * OUT_PITCH;    // stage s at + 8 s
constexpr uint32_t EMPTY_OFF = FULL_OFF + 8 * STAGES;
constexpr size_t SMEM_BYTES = 1024 + EMPTY_OFF + 8 * STAGES;
static_assert(STAGE_BYTES % 1024 == 0 && B_BLOCK % 1024 == 0, "1024-byte aligned tiles");
static_assert(FULL_OFF % 8 == 0, "aligned mbarriers");

// One call's operands. GATHER: A row r of group g is bf16(scale[j]) *
// a[ids[j]] with j = g * C + r; otherwise a[j]. b is [groups, K, N], or
// [groups, N, K] when TRANS_B. *_vec: rows 16-byte aligned (16-byte
// loads); *_tma: that operand comes by TMA.
struct Problem {
  const uint16_t* a;
  const int* ids;
  const float* scale;
  const uint16_t* b;
  const float* bias;          // [groups, N] or null
  __nv_bfloat16* out;         // [groups * C, N]
  int C, K, N, src_rows;
  int row_tiles, col_tiles, k_tiles, tiles;
  int a_vec, b_vec, out_vec, a_tma, b_tma;
};

// Output tile t: N tiles innermost, then row tiles, then groups.
struct Tile {
  int group, r0, n0;
};

__device__ __forceinline__ Tile tile_at(const Problem& p, int t) {
  const int rest = t / p.col_tiles;
  return {rest / p.row_tiles, (rest % p.row_tiles) * BM, (t % p.col_tiles) * BN};
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 8 bf16 values row[k0 .. k0 + 8), zeros past `limit`; `vec` when the row
// is 16-byte aligned and its length a multiple of 8.
__device__ __forceinline__ uint4 load8(const uint16_t* row, int k0, int limit, bool vec) {
  if (vec) {
    if (k0 + VEC <= limit) return *reinterpret_cast<const uint4*>(row + k0);
    return make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t h[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) h[i] = (k0 + i < limit) ? row[k0 + i] : 0u;
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                    h[6] | (h[7] << 16));
}

// Two packed bf16 values times `scale` (already a bf16 value), each
// rounded to bf16.
__device__ __forceinline__ uint32_t scale2(uint32_t bits, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
  return hopper::pack_bf16(f.x * scale, f.y * scale);
}

// 16-byte chunk `chunk` of row `row` of a [rows x 128 B] tile at the
// 128-byte swizzle (the layout TMA writes and wgmma's layout type 1 reads)
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Warpgroup 0: fills stage after stage of the block's tiles, each once the
// consumers released it. B and K7's A come by TMA (thread 0); K6's gathered
// A rows by cp.async, each thread's landing counted by the stage's "full"
// barrier itself, so the producer never waits for its loads and runs up to
// STAGES stages ahead (into the next tile while the consumers store this
// one); rows off 16 bytes and operands TMA cannot map through registers and
// ordinary stores, fenced for the async proxy. The gathered rows land
// unscaled: the consumers scale them.
template <bool GATHER, bool TRANS_B>
__device__ __forceinline__ void produce(const CUtensorMap* ta, const CUtensorMap* tb,
                                        const Problem& p, uint32_t base, unsigned char* tiles,
                                        int tid) {
  const int chunk = tid % 8;                    // A: chunk tid % 8 of rows tid / 8 + 16 i
  const bool a_async = GATHER && p.a_vec && p.b_tma;
  const bool manual = (!p.a_tma && !a_async) || !p.b_tma;
  const uint32_t tx = (p.a_tma ? A_BYTES : 0u) + (p.b_tma ? B_BYTES : 0u);
  int job = 0;                                  // stages filled so far
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tile = tile_at(p, t);
    const long long first = static_cast<long long>(tile.group) * p.C;
    const uint16_t* a_rows[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile.r0 + tid / 8 + 16 * i;
      a_rows[i] = nullptr;
      if (r < p.C) {
        const long long j = first + r;
        const long long src = GATHER ? min(max(p.ids[j], 0), p.src_rows - 1) : j;
        a_rows[i] = p.a + static_cast<size_t>(src) * p.K;
      }
    }
    const uint16_t* bg = p.b + static_cast<size_t>(tile.group) * p.K * p.N;
    for (int kt = 0; kt < p.k_tiles; ++kt, ++job) {
      const int stage = job % STAGES;
      const uint32_t full = base + FULL_OFF + 8 * stage;
      if (job >= STAGES)
        hopper::mbarrier_wait(base + EMPTY_OFF + 8 * stage, ((job / STAGES) - 1) & 1);
      const uint32_t a_s = base + stage * STAGE_BYTES;
      const uint32_t b_s = a_s + A_BYTES;
      unsigned char* a_tile = tiles + stage * STAGE_BYTES;
      unsigned char* b_tile = a_tile + A_BYTES;
      const int k0 = kt * BK;
      if (tid == 0) {
        if (tx != 0) {
          hopper::mbarrier_expect_tx(full, tx);         // the extra arrival
          if (p.a_tma) hopper::tma_load_3d(a_s, ta, full, k0, tile.r0, tile.group);
          if (p.b_tma) {
            if (TRANS_B) {
              hopper::tma_load_3d(b_s, tb, full, k0, tile.n0, tile.group);
            } else {
              hopper::tma_load_3d(b_s, tb, full, tile.n0, k0, tile.group);
              hopper::tma_load_3d(b_s + B_BLOCK, tb, full, tile.n0 + 64, k0, tile.group);
            }
          }
        } else {
          hopper::mbarrier_arrive(full);
        }
      }
      if (a_async) {
        const int k = k0 + VEC * chunk;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool inside = a_rows[i] != nullptr && k < p.K;
          hopper::cp_async16(a_s + swizzled(tid / 8 + 16 * i, chunk),
                             inside ? a_rows[i] + k : p.a, inside ? 16u : 0u);
        }
      } else if (!p.a_tma) {
        uint4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = a_rows[i] != nullptr ? load8(a_rows[i], k0 + VEC * chunk, p.K, p.a_vec)
                                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<uint4*>(a_tile + swizzled(tid / 8 + 16 * i, chunk)) = v[i];
      }
      if (!p.b_tma) {
        uint4 v[8];
        if (TRANS_B) {          // rows of N, chunks of K: as A
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int n = tile.n0 + tid / 8 + 16 * i;
            v[i] = n < p.N ? load8(bg + static_cast<size_t>(n) * p.K, k0 + VEC * chunk, p.K,
                                   p.b_vec)
                           : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            *reinterpret_cast<uint4*>(b_tile + swizzled(tid / 8 + 16 * i, chunk)) = v[i];
        } else {                // rows of K, 16 chunks of N in two 64-column blocks
          const int q = tid % 16;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int k = k0 + tid / 16 + 8 * i;
            v[i] = k < p.K ? load8(bg + static_cast<size_t>(k) * p.N, tile.n0 + VEC * q, p.N,
                                   p.b_vec)
                           : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            *reinterpret_cast<uint4*>(b_tile + (q / 8) * B_BLOCK +
                                      swizzled(tid / 16 + 8 * i, q % 8)) = v[i];
        }
      }
      if (manual) hopper::fence_proxy_async();
      if (a_async)
        hopper::cp_async_arrive(full);          // once this thread's rows landed
      else
        hopper::mbarrier_arrive(full);
    }
  }
}

// out[group * C + r, n] = sum_k A[r, k] * B_group[k, n] (+ bias[group, n]),
// rounded once to bf16, for every 128 x 128 tile of this block (tiles
// blockIdx.x, + gridDim.x, ...).
template <bool GATHER, bool TRANS_B>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                    const Problem p) {
  extern __shared__ unsigned char smem[];
  unsigned char* tiles = smem + ((1024u - (hopper::smem_address(smem) & 1023u)) & 1023u);
  const uint32_t base = hopper::smem_address(tiles);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbarrier_init(base + FULL_OFF + 8 * s, PRODUCERS + 1);
      hopper::mbarrier_init(base + EMPTY_OFF + 8 * s, CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid < PRODUCERS) {
    produce<GATHER, TRANS_B>(&ta, &tb, p, base, tiles, tid);
    return;
  }

  const int ctid = tid - PRODUCERS;
  const int wg = ctid / 128;                // consumer warpgroup: rows 64 wg ..
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int row = 16 * warp + lane / 4;     // this thread's rows: row, row + 8
  unsigned char* staged = tiles + OUT_OFF + 64 * wg * OUT_PITCH;
  int job = 0;                              // stages consumed so far
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tile = tile_at(p, t);
    const long long first = static_cast<long long>(tile.group) * p.C;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    // K6: bf16(scale) of this thread's two rows, applied to A in registers
    float scale[2] = {0.0f, 0.0f};
    if (GATHER) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tile.r0 + 64 * wg + row + 8 * h;
        if (r < p.C) scale[h] = round_bf16(p.scale[first + r]);
      }
    }

    for (int kt = 0; kt < p.k_tiles; ++kt, ++job) {
      const int stage = job % STAGES;
      hopper::mbarrier_wait(base + FULL_OFF + 8 * stage, (job / STAGES) & 1);
      const uint32_t a_s = base + stage * STAGE_BYTES + 64 * wg * 128;
      const uint32_t b_s = base + stage * STAGE_BYTES + A_BYTES;
      // B's k16 step i: K-major at 32 i bytes into each row; MN-major at 16
      // K rows of 128 bytes, the second 64-column block LBO = B_BLOCK on
      uint64_t b[BK / 16];
#pragma unroll
      for (int i = 0; i < BK / 16; ++i)
        b[i] = TRANS_B ? hopper::smem_descriptor(b_s + 32 * i, 16, 1024, 1)
                       : hopper::smem_descriptor(b_s + 16 * i * 128, B_BLOCK, 1024, 1);
      if (GATHER) {
        // A from registers: ldmatrix gives the fragment of k16 step i (lanes
        // 0-7 / 8-15 address rows 0-7 / 8-15 of the warp's 16 at chunk 2 i,
        // lanes 16-31 the same rows at chunk 2 i + 1); registers 0 and 2
        // hold row `row`, 1 and 3 row + 8
        uint32_t a[BK / 16][4];
        const int lrow = 16 * warp + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
        for (int i = 0; i < BK / 16; ++i) {
          hopper::ldmatrix_x4(a[i], a_s + swizzled(lrow, 2 * i + lane / 16));
#pragma unroll
          for (int e = 0; e < 4; ++e) a[i][e] = scale2(a[i][e], scale[e % 2]);
        }
        hopper::fence_registers<BN / 2>(acc);
        hopper::fence_fragments<4 * BK / 16>(&a[0][0]);
        hopper::wgmma_fence();
#pragma unroll
        for (int i = 0; i < BK / 16; ++i)
          hopper::wgmma_rs_n128<TRANS_B ? 0 : 1>(acc, a[i], b[i], 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_registers<BN / 2>(acc);
        hopper::fence_fragments<4 * BK / 16>(&a[0][0]);
        __syncwarp();
        if (lane == 0) hopper::mbarrier_arrive(base + EMPTY_OFF + 8 * stage);
      } else {
        hopper::fence_registers<BN / 2>(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int i = 0; i < BK / 16; ++i)
          hopper::wgmma_ss_n128<0, TRANS_B ? 0 : 1>(
              acc, hopper::smem_descriptor(a_s + 32 * i, 16, 1024, 1), b[i], 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();            // the previous stage's products are done
        hopper::fence_registers<BN / 2>(acc);
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) hopper::mbarrier_arrive(base + EMPTY_OFF + 8 * ((job - 1) % STAGES));
        }
      }
    }
    if (!GATHER) {
      hopper::wgmma_wait<0>();
      hopper::fence_registers<BN / 2>(acc);
      __syncwarp();
      if (lane == 0) hopper::mbarrier_arrive(base + EMPTY_OFF + 8 * ((job - 1) % STAGES));
    }

    // accumulator element 4 j + e: row `row` + 8 (e / 2), column 8 j + 2
    // (lane % 4) + e % 2 of this warpgroup's 64 x 128
    const float* bias =
        p.bias == nullptr ? nullptr : p.bias + static_cast<size_t>(tile.group) * p.N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      float b0 = 0.0f, b1 = 0.0f;
      if (bias != nullptr) {
        if (tile.n0 + col < p.N) b0 = bias[tile.n0 + col];
        if (tile.n0 + col + 1 < p.N) b1 = bias[tile.n0 + col + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(staged + (row + 8 * h) * OUT_PITCH + 2 * col) =
            hopper::pack_bf16(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
    hopper::named_barrier(2 + wg, 128);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int piece = ctid % 128 + 128 * i;   // 64 rows x 16 pieces of 8 columns
      const int r = tile.r0 + 64 * wg + piece / 16;
      const int n = tile.n0 + VEC * (piece % 16);
      if (r >= p.C || n >= p.N) continue;
      const unsigned char* src = staged + (piece / 16) * OUT_PITCH + 16 * (piece % 16);
      __nv_bfloat16* dst = p.out + static_cast<size_t>(first + r) * p.N + n;
      if (p.out_vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const __nv_bfloat16* values = reinterpret_cast<const __nv_bfloat16*>(src);
        for (int e = 0; e < VEC && n + e < p.N; ++e) dst[e] = values[e];
      }
    }
    hopper::named_barrier(2 + wg, 128);     // the staging tile is free for the next
  }
}

// out[t, n] = sum over t's rows j (ascending) of bf16(rows[j, n] * bf16(scale[j])),
// from zero, each add rounded to bf16. order[starts[t] .. starts[t + 1]) are t's
// rows. One thread per (token, 8 columns) when vec (N a multiple of 8), else
// per (token, column).
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_rows_kernel(const __nv_bfloat16* __restrict__ rows, const float* __restrict__ scale,
                    const int* __restrict__ order, const int* __restrict__ starts,
                    __nv_bfloat16* __restrict__ out, int tokens, int N, int vec) {
  const int width = vec ? VEC : 1;
  const int per_token = N / width;
  const long long item = static_cast<long long>(blockIdx.x) * COMBINE_THREADS + threadIdx.x;
  if (item >= static_cast<long long>(tokens) * per_token) return;
  const int t = static_cast<int>(item / per_token);
  const int n = static_cast<int>(item % per_token) * width;
  const int begin = starts[t], end = starts[t + 1];
  float total[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) total[e] = 0.0f;
  for (int s = begin; s < end; ++s) {
    const int j = order[s];
    const float weight = round_bf16(scale[j]);
    const __nv_bfloat16* row = rows + static_cast<size_t>(j) * N + n;
    if (vec) {
      const uint4 packed = *reinterpret_cast<const uint4*>(row);
      const __nv_bfloat16* values = reinterpret_cast<const __nv_bfloat16*>(&packed);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        total[e] = round_bf16(total[e] + round_bf16(__bfloat162float(values[e]) * weight));
    } else {
      total[0] = round_bf16(total[0] + round_bf16(__bfloat162float(row[0]) * weight));
    }
  }
  __nv_bfloat16* dst = out + static_cast<size_t>(t) * N + n;
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        hopper::pack_bf16(total[0], total[1]), hopper::pack_bf16(total[2], total[3]),
        hopper::pack_bf16(total[4], total[5]), hopper::pack_bf16(total[6], total[7]));
  } else {
    dst[0] = __float2bfloat16(total[0]);
  }
}

bool aligned(const void* pointer, int row_length) {
  return row_length % VEC == 0 && reinterpret_cast<uintptr_t>(pointer) % 16 == 0;
}

// Encodes the maps an operand can take (an operand whose map the encoder
// refuses is loaded by the producer instead) and launches one block per SM,
// or per tile where there are fewer.
template <bool GATHER, bool TRANS_B>
int launch_gemm(Problem p, int groups, cudaStream_t stream) {
  CUtensorMap ta{}, tb{};
  p.row_tiles = (p.C + BM - 1) / BM;
  p.col_tiles = (p.N + BN - 1) / BN;
  p.k_tiles = (p.K + BK - 1) / BK;
  p.tiles = groups * p.row_tiles * p.col_tiles;
  p.out_vec = aligned(p.out, p.N);
  if (p.a_tma) p.a_tma = hopper::encode_3d(&ta, p.a, groups, p.C, p.K, BM, BK) == cudaSuccess;
  if (p.b_tma)
    p.b_tma = (TRANS_B ? hopper::encode_3d(&tb, p.b, groups, p.N, p.K, BN, BK)
                       : hopper::encode_3d(&tb, p.b, groups, p.K, p.N, BK, 64)) == cudaSuccess;
  int device = 0, sms = 0;
  if (const cudaError_t err = cudaGetDevice(&device)) return static_cast<int>(err);
  if (const cudaError_t err =
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return static_cast<int>(err);
  auto kernel = grouped_gemm_kernel<GATHER, TRANS_B>;
  if (const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES)))
    return static_cast<int>(err);
  kernel<<<p.tiles < sms ? p.tiles : sms, THREADS, SMEM_BYTES, stream>>>(ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int groups, int C, int K, int N) {
  const long long blocks = static_cast<long long>(groups) * ((C + BM - 1) / BM) *
                           ((N + BN - 1) / BN);
  return groups < 1 || C < 1 || K < 1 || N < 1 || blocks > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// K6: out[j] = (bf16(scale[j]) * src[ids[j]]) @ rhs[j / C], j < groups * C.
// src [src_rows, K] bf16; rhs [groups, K, N] bf16 ([groups, N, K] when
// transpose_rhs); ids int32, scale float32, both [groups * C]; out
// [groups * C, N] bf16.
int grouped_gather_matmul_bf16(const void* src, const void* ids, const void* scale,
                               const void* rhs, void* out, int groups, int C, int K, int N,
                               int src_rows, int transpose_rhs, void* stream) {
  if (bad_shape(groups, C, K, N) || src_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  Problem p{};
  p.a = static_cast<const uint16_t*>(src);
  p.ids = static_cast<const int*>(ids);
  p.scale = static_cast<const float*>(scale);
  p.b = static_cast<const uint16_t*>(rhs);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.C = C, p.K = K, p.N = N, p.src_rows = src_rows;
  p.a_vec = aligned(src, K);
  p.b_vec = p.b_tma = aligned(rhs, transpose_rhs ? K : N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return transpose_rhs ? launch_gemm<true, true>(p, groups, s)
                       : launch_gemm<true, false>(p, groups, s);
}

// K7, first pass: rows[j] = bf16(lhs[j] @ rhs[j / C] + bias[j / C]). lhs
// [groups * C, K] bf16; rhs as above; bias [groups, N] float32 or null.
int grouped_matmul_rows_bf16(const void* lhs, const void* rhs, const void* bias, void* rows,
                             int groups, int C, int K, int N, int transpose_rhs, void* stream) {
  if (bad_shape(groups, C, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  Problem p{};
  p.a = static_cast<const uint16_t*>(lhs);
  p.b = static_cast<const uint16_t*>(rhs);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(rows);
  p.C = C, p.K = K, p.N = N, p.src_rows = groups * C;
  p.a_vec = p.a_tma = aligned(lhs, K);
  p.b_vec = p.b_tma = aligned(rhs, transpose_rhs ? K : N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return transpose_rhs ? launch_gemm<false, true>(p, groups, s)
                       : launch_gemm<false, false>(p, groups, s);
}

// K7, second pass: out[t] = sum of bf16(scale[j]) * rows[j] over t's rows in
// ascending order, each add rounded to bf16. order int32 lists the rows
// sorted by token (stably), starts int32 [tokens + 1] their offsets; rows
// whose token is the sentinel lie past starts[tokens] and are never read.
int combine_rows_bf16(const void* rows, const void* scale, const void* order,
                      const void* starts, void* out, int tokens, int N, void* stream) {
  if (tokens < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned(rows, N) && aligned(out, N);
  const long long items = static_cast<long long>(tokens) * (vec ? N / VEC : N);
  const long long blocks = (items + COMBINE_THREADS - 1) / COMBINE_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  combine_rows_kernel<<<static_cast<unsigned>(blocks), COMBINE_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(rows), static_cast<const float*>(scale),
      static_cast<const int*>(order), static_cast<const int*>(starts),
      static_cast<__nv_bfloat16*>(out), tokens, N, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
