// Grouped gather-matmul (K6) and matmul-scatter (K7) for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernels of tpusystem/ops/pallas/grouped_matmul.py:
//   * grouped_gather_matmul_bf16          <- gather_rows_matmul / _gather_matmul_kernel  (K6)
//   * grouped_matmul_rows_bf16 followed by
//     combine_rows_bf16                   <- matmul_scatter_rows / _matmul_scatter_kernel (K7)
//
// What bounds them on an H100: operations. At the MoE training shape (8
// experts, 5120 rows each, 768 x 3072) one call is 1.9e11 flops against
// ~0.3 GB moved, some 650 flops per byte, above the ~295 where the tensor
// cores become the limit. So the products run on the tensor cores:
// mma.sync m16n8k16 (bf16 operands, float32 accumulators). wgmma, TMA and a
// pipelined producer are later speed work; this design is simple and right.
//
// What the design does:
//   * One block owns a 64-row x 128-column output tile of one group (expert):
//     4 warps, each 32 x 64, i.e. 2 x 8 mma tiles. The contraction walks
//     32-deep stages through shared memory; both operands are stored there
//     with the contraction dim contiguous ([row][k] for A, [n][k] for B), so
//     every mma fragment is a plain 32-bit shared load, conflict-free thanks
//     to an 8-element pad per row.
//   * K6 gathers its A rows straight from the unpermuted token array by
//     row_ids (the [groups * C, K] dispatch buffer is never formed) and
//     multiplies each gathered value by its row's scale in bf16 before the
//     product, as the reference does (grouped_matmul.py:135). Scale 0 masks
//     empty slots; ids are clamped for memory safety.
//   * transpose_rhs reads rhs[g] as [N, K] in place: no transposed weight is
//     copied. Without it rhs[g] is [K, N] and the tile is transposed on its
//     way into shared memory.
//   * K7's GEMM adds the bias to the float32 accumulator, rounds once to
//     bf16 and writes the finished rows (the saved rows of save_rows). The
//     reference then read-modify-writes out[row_ids[j]] += scale[j] * row[j]
//     in its epilogue, race-free only because TPU grid steps run in order
//     (grouped_matmul.py:22-25). On the card a token's k choices sit in
//     different blocks, so the combine is a second pass instead: one block
//     per token walks that token's rows in ascending row order (the
//     reference's grid order) through a token -> row index the wrapper
//     builds with a stable integer sort, starting from zero and rounding
//     every product and every add to bf16 as the reference does
//     (grouped_matmul.py:285-286). No float atomics: every output repeats
//     bitwise. The cost is one extra write and read of the [groups * C, N]
//     rows when the caller does not need them saved.
//   * Ragged edges (C, K, N not multiples of the tile) are masked: loads past
//     an edge read zeros, stores past it are skipped. 16-byte loads are used
//     where the row length is a multiple of 8, element loads otherwise.
//
// Plain C interface (bound with ctypes); every entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;            // buffer rows per block, all of one group
constexpr int BN = 128;           // output columns per block
constexpr int BK = 32;            // contraction depth per shared-memory stage
constexpr int LDS = BK + 8;       // padded row length in shared memory (bf16)
constexpr int THREADS = 128;      // 4 warps: 2 over rows x 2 over columns
constexpr int VEC = 8;            // bf16 values per 16-byte load
constexpr int COMBINE_THREADS = 128;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 8 bf16 values row[k0 .. k0 + 8), zeros past `limit`; `vec` when the row
// length is a multiple of 8 (16-byte aligned rows).
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

// Each of 8 bf16 values times `scale` (already a bf16 value), rounded to bf16.
__device__ __forceinline__ uint4 scale8(uint4 v, float scale) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 pair = *reinterpret_cast<__nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(pair);
    pair = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    w[i] = *reinterpret_cast<uint32_t*>(&pair);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out[group * C + r, n] = sum_k A[r, k] * B_group[k, n] (+ bias[group, n]),
// rounded once to bf16. GATHER: A[r] = bf16(scale[j] * src[ids[j]]) with
// j = group * C + r; otherwise A[r] = a[j]. TRANS_B: b[group] is [N, K].
template <bool GATHER, bool TRANS_B>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const uint16_t* __restrict__ a, const int* __restrict__ ids,
                    const float* __restrict__ scale, const uint16_t* __restrict__ b,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int C,
                    int K, int N, int src_rows) {
  __shared__ __align__(16) uint16_t As[BM][LDS];
  __shared__ __align__(16) uint16_t Bs[BN][LDS];
  __shared__ long long row_src[BM];   // row of `a` for each tile row; -1 past C
  __shared__ float row_scale[BM];

  const int group = blockIdx.z;
  const int r0 = blockIdx.y * BM;              // first tile row within the group
  const int n0 = blockIdx.x * BN;
  const long long first = static_cast<long long>(group) * C;

  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const int r = r0 + i;
    long long src = -1;
    float s = 0.0f;
    if (r < C) {
      const long long j = first + r;
      if (GATHER) {
        src = min(max(ids[j], 0), src_rows - 1);
        s = round_bf16(scale[j]);
      } else {
        src = j;
      }
    }
    row_src[i] = src;
    row_scale[i] = s;
  }
  __syncthreads();

  const uint16_t* bg = b + static_cast<size_t>(group) * K * N;
  const bool vec_a = (K % VEC) == 0;
  const bool vec_b = TRANS_B ? (K % VEC) == 0 : (N % VEC) == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % 2) * 32, wn = (warp / 2) * 64;
  const int gid = lane >> 2, tig = lane & 3;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A stage: BM x BK, four 16-byte chunks per row
    for (int c = threadIdx.x; c < BM * (BK / VEC); c += THREADS) {
      const int i = c / (BK / VEC), kc = (c % (BK / VEC)) * VEC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const long long src = row_src[i];
      if (src >= 0) {
        v = load8(a + static_cast<size_t>(src) * K, k0 + kc, K, vec_a);
        if (GATHER) v = scale8(v, row_scale[i]);
      }
      *reinterpret_cast<uint4*>(&As[i][kc]) = v;
    }
    // B stage into Bs[n][k]
    if (TRANS_B) {
      for (int c = threadIdx.x; c < BN * (BK / VEC); c += THREADS) {
        const int n = c / (BK / VEC), kc = (c % (BK / VEC)) * VEC;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + n < N) v = load8(bg + static_cast<size_t>(n0 + n) * K, k0 + kc, K, vec_b);
        *reinterpret_cast<uint4*>(&Bs[n][kc]) = v;
      }
    } else {
      // lanes walk k, so the transposing 2-byte stores hit distinct words
      for (int c = threadIdx.x; c < BK * (BN / VEC); c += THREADS) {
        const int kk = c % BK, nc = (c / BK) * VEC;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + kk < K) v = load8(bg + static_cast<size_t>(k0 + kk) * N, n0 + nc, N, vec_b);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          Bs[nc + i][kk] = static_cast<uint16_t>(w[i / 2] >> (16 * (i % 2)));
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + gid;
        af[mi][0] = lds32(&As[r][kk + tig * 2]);
        af[mi][1] = lds32(&As[r + 8][kk + tig * 2]);
        af[mi][2] = lds32(&As[r][kk + tig * 2 + 8]);
        af[mi][3] = lds32(&As[r + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = wn + ni * 8 + gid;
        bf[ni][0] = lds32(&Bs[n][kk + tig * 2]);
        bf[ni][1] = lds32(&Bs[n][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // accumulator element e of tile (mi, ni): row gid + 8 * (e / 2), column
  // tig * 2 + e % 2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + wm + mi * 16 + gid + 8 * (e / 2);
        const int n = n0 + wn + ni * 8 + tig * 2 + e % 2;
        if (r < C && n < N) {
          float v = acc[mi][ni][e];
          if (bias != nullptr) v += bias[static_cast<size_t>(group) * N + n];
          out[static_cast<size_t>(first + r) * N + n] = __float2bfloat16(v);
        }
      }
}

// out[t, n] = sum over t's rows j (ascending) of bf16(rows[j, n] * bf16(scale[j])),
// from zero, each add rounded to bf16. order[starts[t] .. starts[t + 1]) are t's rows.
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_rows_kernel(const __nv_bfloat16* __restrict__ rows, const float* __restrict__ scale,
                    const int* __restrict__ order, const int* __restrict__ starts,
                    __nv_bfloat16* __restrict__ out, int N) {
  const int t = blockIdx.x;
  const int begin = starts[t], end = starts[t + 1];
  for (int n = threadIdx.x; n < N; n += COMBINE_THREADS) {
    float total = 0.0f;
    for (int s = begin; s < end; ++s) {
      const int j = order[s];
      const float weighted =
          round_bf16(__bfloat162float(rows[static_cast<size_t>(j) * N + n]) * round_bf16(scale[j]));
      total = round_bf16(total + weighted);
    }
    out[static_cast<size_t>(t) * N + n] = __float2bfloat16(total);
  }
}

template <bool GATHER, bool TRANS_B>
int launch_gemm(const void* a, const void* ids, const void* scale, const void* b,
                const void* bias, void* out, int groups, int C, int K, int N, int src_rows,
                cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, groups);
  grouped_gemm_kernel<GATHER, TRANS_B><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint16_t*>(a), static_cast<const int*>(ids),
      static_cast<const float*>(scale), static_cast<const uint16_t*>(b),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), C, K, N, src_rows);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int groups, int C, int K, int N) {
  return groups < 1 || groups > 65535 || C < 1 || (C + BM - 1) / BM > 65535 || K < 1 || N < 1;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return transpose_rhs
             ? launch_gemm<true, true>(src, ids, scale, rhs, nullptr, out, groups, C, K, N,
                                       src_rows, s)
             : launch_gemm<true, false>(src, ids, scale, rhs, nullptr, out, groups, C, K, N,
                                        src_rows, s);
}

// K7, first pass: rows[j] = bf16(lhs[j] @ rhs[j / C] + bias[j / C]). lhs
// [groups * C, K] bf16; rhs as above; bias [groups, N] float32 or null.
int grouped_matmul_rows_bf16(const void* lhs, const void* rhs, const void* bias, void* rows,
                             int groups, int C, int K, int N, int transpose_rhs, void* stream) {
  if (bad_shape(groups, C, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return transpose_rhs
             ? launch_gemm<false, true>(lhs, nullptr, nullptr, rhs, bias, rows, groups, C, K, N,
                                        1, s)
             : launch_gemm<false, false>(lhs, nullptr, nullptr, rhs, bias, rows, groups, C, K,
                                         N, 1, s);
}

// K7, second pass: out[t] = sum of bf16(scale[j]) * rows[j] over t's rows in
// ascending order, each add rounded to bf16. order int32 lists the rows
// sorted by token (stably), starts int32 [tokens + 1] their offsets; rows
// whose token is the sentinel lie past starts[tokens] and are never read.
int combine_rows_bf16(const void* rows, const void* scale, const void* order,
                      const void* starts, void* out, int tokens, int N, void* stream) {
  if (tokens < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  combine_rows_kernel<<<tokens, COMBINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(rows), static_cast<const float*>(scale),
      static_cast<const int*>(order), static_cast<const int*>(starts),
      static_cast<__nv_bfloat16*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
