// Decode-step weight-streaming kernels for Hopper (sm_90a): bf16 weights,
// or int8 / float8 e4m3 weights with a float32 scale per output channel.
//
// Replaces the Pallas TPU kernels of tpusystem/ops/pallas/decode_matmul.py:
//   * decode_matmul_{bf16,int8,fp8}  <- decode_matmul / _matmul_kernel   (K4)
//   * decode_ffn_{bf16,int8,fp8}     <- decode_ffn / _ffn_kernel         (K5)
//
// What bounds them on an H100: bytes. A greedy decode step at batch <= 16
// multiplies a few-KB activation by every weight matrix once, so each weight
// byte is read once and used for at most 2 * 16 flops; that is far below the
// ~295 flop/byte the card needs before its tensor cores become the limit.
// The least time is the weight bytes over the 3.35 TB/s of HBM: 1.06 us for
// GPT-2's bf16 qkv weight [768, 2304], 0.35 us for its out-projection.
//
// K4, decode_matmul_kernel<GELU, MODE> (MODE 0 bf16, 1 int8, 2 e4m3).
// HBM streams at its rate only with megabytes in flight; a block per
// 32-column tile, each thread with one 16-byte load outstanding, kept ~100 KB
// in flight at the out-projection and ran at 32x its bound. So:
//   * K is split across a thread-block cluster of `cluster` blocks (8, the
//     portable size): a cluster per 32-column tile, 576 blocks at qkv and 192
//     at the out-projection, so every one of the 132 SMs streams;
//   * each block asks for its whole [K / cluster, 32] weight slab at its start
//     with 2-D TMA loads (boxes of at most 256 rows) under one mbarrier, so
//     the whole weight is in flight at once with no thread spent on
//     addresses; the tensor map is encoded once per weight (pointer, shape,
//     type, box) and kept, so a call costs no host encode (1-D bulk copies
//     of the slab's 64-byte rows, which need no map, were slower on the
//     card);
//   * each block stages only its K-slice of x while its slab lands; int8 /
//     e4m3 values are widened on chip exactly (|int8| <= 127 and every e4m3
//     value are bf16 values), so the products are the reference's
//     bf16 x widen(w) products;
//   * the products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     float32 sums, x's rows zero-padded to 16): with float32 FMAs the
//     8 x 768 x 2304 product alone is ~840 FMA issue cycles an SM (0.42 us
//     at 1.98 GHz) and the loads that feed them as many again, most of the
//     weight bytes' 1.06 us bound; each warp owns 8 columns over the
//     block's whole K-slice, so no sum is split in a block;
//   * shared memory is read conflict-free: the bf16 slab arrives under TMA's
//     64-byte swizzle (the narrow slab is widened into the same layout) and
//     x's rows are padded, so each ldmatrix's 8 rows fall in 8 bank groups;
//   * every block sends its partial tile's rows of x into the leading
//     block's shared memory (distributed shared memory) with asynchronous
//     16-byte stores (st.async) that count themselves on the leader's
//     mbarrier, so no block waits for an acknowledgement and the others
//     leave once their stores are issued; the leader sums the tiles in rank
//     order (no HBM scratch, no atomics, one launch; the sums repeat
//     bitwise), applies the per-channel scale, the bias and the tanh GELU to
//     the float32 sum and rounds once to bf16.

// K5, decode_ffn_kernel (PR 1/6's design, the next to be redesigned):
//   * x ([B, K], a few KB) is staged once in shared memory; the weight is
//     streamed with 16-byte loads (8 bf16 or 16 int8 / e4m3 values), the
//     threads that cover one row of a 32-column tile neighbours in a warp,
//     64 (bf16) or 128 (narrow) rows of the weight in flight per block.
//   * int8 / e4m3 tiles are widened on chip as K4's. K5 scales its hidden
//     sums per channel before b1 and GELU, and the proj output once in the
//     epilogue, on the full sum of the ordered second pass (not on each
//     partial), before b2.
//   * No Hopper block can carry an accumulator to the next one, so the
//     hidden dimension is split over blocks instead of walked by a grid.
//     Each block computes its [B, 32] hidden slab (fc product, bias, tanh
//     GELU) in shared memory, rounds it to bf16 as the reference does before
//     the second product, and multiplies it by its 32 rows of the proj weight
//     into a float32 partial [splits, B, N]. A second, deterministic pass sums
//     the partials in split order and applies the proj bias and the rounding.
//     The [B, 4 * dim] hidden activation never reaches HBM and no float
//     atomics are used.
//   * Accumulation is float32; bias and the activation are applied to the
//     float32 sum, which is rounded to bf16 once.
//
// Plain C interface (bound with ctypes); every entry point launches on the
// given stream, allocates nothing and returns the launch's error (0 for none).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_COLS = 32;                     // output columns per block

// The streamed weight types: 16 bytes a load, widened to float on chip.
template <typename W>
struct Weight;

template <>
struct Weight<__nv_bfloat16> {
  static constexpr int VEC = 8;                   // values per 16-byte load
  static constexpr int MAX_ROWS = 16;             // rows of x per launch
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float out[VEC]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Weight<int8_t> {
  static constexpr int VEC = 16;
  static constexpr int MAX_ROWS = 8;              // 8 x 16 float sums a thread
  __device__ __forceinline__ static void load(const int8_t* p, float out[VEC]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = static_cast<float>(v[i]);
  }
};

template <>
struct Weight<__nv_fp8_e4m3> {
  static constexpr int VEC = 16;
  static constexpr int MAX_ROWS = 8;
  __device__ __forceinline__ static void load(const __nv_fp8_e4m3* p, float out[VEC]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_fp8_e4m3* v = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = static_cast<float>(v[i]);
  }
};

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True), torch's approximate='tanh'
  const float k0 = 0.7978845608028654f;           // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// Stage x [B, K] (row-major) into shared memory as [BT, K], zero rows >= B.
template <int BT>
__device__ void stage_x(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* x_s,
                        int B, int K) {
  for (int i = threadIdx.x; i < BT * K; i += THREADS) {
    x_s[i] = (i < B * K) ? x[i] : __float2bfloat16(0.0f);
  }
}

// acc[b][j] = sum over this thread's weight rows of x[b][k] * w[k][n0 + j].
template <int BT, typename W>
__device__ void tile_gemv(const __nv_bfloat16* x_s, const W* __restrict__ w, int K, int N,
                          int col0, float acc[BT][Weight<W>::VEC]) {
  constexpr int VEC = Weight<W>::VEC;
  constexpr int COL_THREADS = TILE_COLS / VEC;    // threads covering one tile row
  constexpr int K_GROUPS = THREADS / COL_THREADS; // weight rows in flight per block
  const int ct = threadIdx.x % COL_THREADS;
  const int kg = threadIdx.x / COL_THREADS;
  const int n0 = col0 + ct * VEC;
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[b][j] = 0.0f;
  if (n0 >= N) return;
  for (int k = kg; k < K; k += K_GROUPS) {
    float wv[VEC];
    Weight<W>::load(w + static_cast<size_t>(k) * N + n0, wv);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float xv = __bfloat162float(x_s[b * K + k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[b][j] = fmaf(xv, wv[j], acc[b][j]);
    }
  }
}

// Sum the row groups' partials in a fixed order into out_s [BT, TILE_COLS].
template <int BT, int VEC>
__device__ void reduce_tile(float acc[BT][VEC], float* red, float* out_s) {
  constexpr int COL_THREADS = TILE_COLS / VEC;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = acc[b][j];
      // lane = group * COL_THREADS + ct: xor over the group bits
#pragma unroll
      for (int offset = COL_THREADS; offset < 32; offset <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, offset);
      acc[b][j] = v;
    }
  if (lane < COL_THREADS) {
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        red[(warp * BT + b) * TILE_COLS + lane * VEC + j] = acc[b][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BT * TILE_COLS; i += THREADS) {
    float total = 0.0f;
    for (int w = 0; w < WARPS; ++w) total += red[w * BT * TILE_COLS + i];
    out_s[i] = total;
  }
  __syncthreads();
}

template <int BT>
constexpr size_t gemv_smem(int K) {
  return align16(static_cast<size_t>(BT) * K * sizeof(__nv_bfloat16)) +
         static_cast<size_t>(WARPS * BT * TILE_COLS + BT * TILE_COLS) * sizeof(float);
}

// s1: float32 [H] (w1's scale per hidden channel) or null; w2's scale goes on
// in splits_reduce_kernel, on the full sum.
template <int BT, typename W>
__global__ void __launch_bounds__(THREADS)
decode_ffn_kernel(const __nv_bfloat16* __restrict__ x, const W* __restrict__ w1,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const W* __restrict__ w2, float* __restrict__ partial, int B, int K, int H,
                  int N) {
  constexpr int VEC = Weight<W>::VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(static_cast<size_t>(BT) * K * 2));
  float* hid_s = red + WARPS * BT * TILE_COLS;

  stage_x<BT>(x, x_s, B, K);
  __syncthreads();
  const int col0 = blockIdx.x * TILE_COLS;          // this block's hidden slab
  {
    float acc[BT][VEC];
    tile_gemv<BT, W>(x_s, w1, K, H, col0, acc);
    reduce_tile<BT, VEC>(acc, red, hid_s);
  }
  for (int i = threadIdx.x; i < BT * TILE_COLS; i += THREADS) {
    const int h = col0 + i % TILE_COLS;
    float v = 0.0f;
    if (h < H) {
      v = hid_s[i];
      if (s1 != nullptr) v *= s1[h];              // real values before the GELU
      v = gelu_tanh(v + b1[h]);
    }
    // the reference casts the hidden slab to x's dtype before the proj product
    hid_s[i] = __bfloat162float(__float2bfloat16(v));
  }
  __syncthreads();

  const int rows = min(TILE_COLS, H - col0);
  float* mine = partial + static_cast<size_t>(blockIdx.x) * B * N;
  for (int c = threadIdx.x; c < N / VEC; c += THREADS) {
    const int n0 = c * VEC;
    float acc[BT][VEC];
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[b][j] = 0.0f;
    for (int r = 0; r < rows; ++r) {
      float wv[VEC];
      Weight<W>::load(w2 + static_cast<size_t>(col0 + r) * N + n0, wv);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float hv = hid_s[b * TILE_COLS + r];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[b][j] = fmaf(hv, wv[j], acc[b][j]);
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b < B) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) mine[static_cast<size_t>(b) * N + n0 + j] = acc[b][j];
      }
    }
  }
}

// out = (sum over splits, in split order) * scale + bias, rounded to bf16;
// scale (w2's, per output channel) and bias may be null.
__global__ void __launch_bounds__(THREADS)
splits_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int splits,
                     int B, int N) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B * N) return;
  float total = 0.0f;
  for (int s = 0; s < splits; ++s) total += partial[static_cast<size_t>(s) * B * N + i];
  if (scale != nullptr) total *= scale[i % N];
  if (bias != nullptr) total += bias[i % N];
  out[i] = __float2bfloat16(total);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ------------------------------------------------------------------ K4

constexpr int GEMV_THREADS = 128;   // 4 warps, 8 output columns each
constexpr int GEMV_COLS = 32;       // output columns of one cluster
constexpr int GEMV_ROWS = 16;       // mma.sync's M: x's rows, zero past B
constexpr int MAX_BOX_ROWS = 256;   // a TMA box's limit in each dimension
enum Mode { BF16 = 0, INT8 = 1, FP8 = 2 };

// The weight's bytes per value, and one 4-byte word of a narrow slab
// widened to 4 bf16 values, exactly (as Weight<>::load: |int8| <= 127 and
// every e4m3 value are bf16 values).
template <int MODE>
struct Word {
  static constexpr int BYTES = MODE == BF16 ? 2 : 1;
  __device__ __forceinline__ static uint2 widen(uint32_t word) {
    float f[4];
    if constexpr (MODE == INT8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = static_cast<float>(static_cast<int8_t>(word >> (8 * i)));
    } else {
      const __nv_fp8_e4m3* v = reinterpret_cast<const __nv_fp8_e4m3*>(&word);
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = static_cast<float>(v[i]);
    }
    return make_uint2(hopper::pack_bf16(f[0], f[1]), hopper::pack_bf16(f[2], f[3]));
  }
};

// The shared memory of decode_matmul_kernel, from a 1024-byte aligned base
// (the swizzle's period; `total` counts the slack to it): the weight slab
// [k_rows][GEMV_COLS] as TMA loads it (bf16 rows of 64 bytes, swizzled), the
// narrow slab widened to bf16 in the same swizzled layout, x's slice
// [GEMV_ROWS][k_rows + 8] in bf16 (rows padded by 16 bytes), the cluster's
// partial tiles [ranks][GEMV_ROWS][GEMV_COLS] in float32 (the leader's are
// written by every rank), the tile's scale and bias [2][GEMV_COLS], the
// slab's mbarrier and the tiles' mbarrier. Both ldmatrix operands are read
// 8 rows of 16 bytes at a time: the swizzle and the padding put those rows
// in 8 different bank groups.
template <int MODE>
struct GemvLayout {
  size_t wide, x, tiles, affine, bar, total;
  __host__ __device__ GemvLayout(int k_rows, int ranks) {
    const size_t slab = static_cast<size_t>(k_rows) * GEMV_COLS;
    wide = (slab * Word<MODE>::BYTES + 1023) & ~static_cast<size_t>(1023);
    x = wide + (MODE == BF16 ? 0 : slab * 2);
    tiles = x + static_cast<size_t>(GEMV_ROWS) * (k_rows + 8) * 2;
    affine = tiles + static_cast<size_t>(ranks) * GEMV_ROWS * GEMV_COLS * sizeof(float);
    bar = affine + 2 * GEMV_COLS * sizeof(float);
    total = bar + 2 * sizeof(uint64_t) + 1024;
  }
};

// Byte offset of bf16 column chunk `chunk` (8 columns, 16 bytes) of row `row`
// in a slab of 64-byte rows under TMA's 64-byte swizzle (from a 1024-byte
// aligned base): chunk bits 4-5 XOR address bits 7-8.
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// out[b, n] = act((sum_k x[b, k] w[k, n]) * scale[n] + bias[n]) for one
// 32-column tile (blockIdx.y) and one K-slice (the block's cluster rank):
// k_rows rows of w from rank * k_rows, a multiple of 16, loaded as
// k_rows / box_rows boxes. scale (narrow weights) and bias may be null.
template <bool GELU, int MODE>
__global__ void __launch_bounds__(GEMV_THREADS)
    decode_matmul_kernel(const __grid_constant__ CUtensorMap w_map,
                         const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B,
                         int K, int N, int k_rows, int box_rows) {
  using W = Word<MODE>;
  constexpr int OUTPUTS = GEMV_ROWS * GEMV_COLS;
  extern __shared__ unsigned char dynamic_smem[];
  unsigned char* smem =
      dynamic_smem + ((1024 - (hopper::smem_address(dynamic_smem) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int x_stride = k_rows + 8;  // x_s's row, in bf16 values
  const uint32_t rank = hopper::cluster_rank();
  const int ranks = static_cast<int>(gridDim.x);
  const GemvLayout<MODE> layout(k_rows, ranks);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem + layout.x);
  float* tiles = reinterpret_cast<float*>(smem + layout.tiles);
  float* affine = reinterpret_cast<float*>(smem + layout.affine);
  const uint32_t bar = hopper::smem_address(smem + layout.bar);
  const uint32_t tiles_bar = bar + sizeof(uint64_t);
  const int k0 = static_cast<int>(rank) * k_rows;
  const int n0 = blockIdx.y * GEMV_COLS;

  if (tid == 0) {
    hopper::mbarrier_init(bar, 1);
    hopper::mbarrier_init(tiles_bar, 1);
    hopper::fence_barrier_init();
    // the leader waits for every rank's rows of x: B x 32 floats a rank
    if (rank == 0)
      hopper::mbarrier_expect_tx(tiles_bar, static_cast<uint32_t>(ranks * B) * GEMV_COLS * 4);
    const int boxes = k_rows / box_rows;
    hopper::mbarrier_expect_tx(bar, static_cast<uint32_t>(k_rows) * GEMV_COLS * W::BYTES);
    for (int j = 0; j < boxes; ++j)
      hopper::tma_load_2d(hopper::smem_address(smem + static_cast<size_t>(j) * box_rows *
                                                          GEMV_COLS * W::BYTES),
                          &w_map, bar, n0, k0 + j * box_rows);
  }
  hopper::cluster_arrive_relaxed();  // this block's barriers are initialised
  // the leader fetches its tile's scale and bias while the slab lands
  if (rank == 0 && tid < 2 * GEMV_COLS) {
    const int n = n0 + tid % GEMV_COLS;
    const float* source = tid < GEMV_COLS ? scale : bias;
    affine[tid] = source != nullptr && n < N ? source[n] : 0.0f;
  }
  // x's K-slice as it is (bf16), zero past B rows and past K, while the
  // slab lands: 8 values a 16-byte copy where K allows (k_rows is a
  // multiple of 16)
  if (K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int chunks = k_rows / 8;
    for (int c = tid; c < GEMV_ROWS * chunks; c += GEMV_THREADS) {
      const int b = c / chunks, k = (c % chunks) * 8;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (b < B && k0 + k < K)
        raw = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(b) * K + k0 + k);
      *reinterpret_cast<uint4*>(x_s + b * x_stride + k) = raw;
    }
  } else {
    for (int i = tid; i < GEMV_ROWS * k_rows; i += GEMV_THREADS) {
      const int b = i / k_rows, k = i % k_rows;
      x_s[b * x_stride + k] = (b < B && k0 + k < K) ? x[static_cast<size_t>(b) * K + k0 + k]
                                                    : __float2bfloat16(0.0f);
    }
  }
  hopper::mbarrier_wait(bar, 0);
  const unsigned char* slab = smem;
  if constexpr (MODE != BF16) {  // the narrow slab widened to bf16, exactly, swizzled
    const uint32_t* words = reinterpret_cast<const uint32_t*>(smem);
    unsigned char* wide = smem + layout.wide;
    for (int i = tid; i < k_rows * GEMV_COLS / 4; i += GEMV_THREADS) {
      const int row = i / 8, column = 4 * (i % 8);  // 4 values a word
      *reinterpret_cast<uint2*>(wide + swizzled(row, column / 8) + (column % 8) * 2) =
          W::widen(words[i]);
    }
    slab = wide;
  }
  __syncthreads();

  // warp w: the [16 x 8] tile of columns 8w..8w+7 over the whole K-slice
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const uint32_t a_address =
      hopper::smem_address(x_s) + ((lane % 16) * x_stride + (lane / 16) * 8) * 2;
  const uint32_t b_base = hopper::smem_address(slab);
  for (int k = 0; k < k_rows; k += 16) {
    uint32_t a[4], b[2];
    hopper::ldmatrix_x4(a, a_address + k * 2);
    hopper::ldmatrix_x2_trans(b, b_base + swizzled(k + lane % 16, warp));
    hopper::mma_m16n8k16_bf16(d, a, b);
  }

  // the tile's rows of x into slot `rank` of the leader's tiles, 16 bytes a
  // store (the leader's shared memory takes every rank's stores, so they are
  // few and wide): an even lane of a quad stores row l / 4, columns 2 (l % 4)
  // .. + 3, its odd neighbour row l / 4 + 8, columns 2 (l % 4) - 2 .. + 1.
  // The stores are asynchronous and count themselves on the leader's
  // barrier; a rank has nothing left to do once they are issued.
  float partner[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) partner[j] = __shfl_xor_sync(0xffffffffu, d[j], 1);
  hopper::cluster_wait();  // the leader is running and its barrier armed
  const bool even = lane % 2 == 0;
  const int row = lane / 4 + (even ? 0 : 8);
  const int col = 8 * warp + 2 * (lane % 4) - (even ? 0 : 2);
  if (row < B) {
    const uint32_t leader_tile = hopper::cluster_address(hopper::smem_address(tiles), 0) +
                                 (rank * OUTPUTS + row * GEMV_COLS + col) * sizeof(float);
    const uint32_t leader_bar = hopper::cluster_address(tiles_bar, 0);
    if (even)
      hopper::store_async_float4(leader_tile, d[0], d[1], partner[0], partner[1], leader_bar);
    else
      hopper::store_async_float4(leader_tile, partner[2], partner[3], d[2], d[3], leader_bar);
  }
  if (rank != 0) return;

  // the leader: each output the ranks' partials summed in rank order, then
  // scale, bias and the activation on the float32 sum, rounded once
  hopper::mbarrier_wait_cluster(tiles_bar, 0);
  for (int i = tid; i < OUTPUTS; i += GEMV_THREADS) {
    const int b = i / GEMV_COLS, c = i % GEMV_COLS;
    if (b >= B || n0 + c >= N) continue;
    float v = tiles[i];
    for (int r = 1; r < ranks; ++r) v += tiles[r * OUTPUTS + i];
    if (scale != nullptr) v *= affine[c];
    if (bias != nullptr) v += affine[GEMV_COLS + c];
    if (GELU) v = gelu_tanh(v);
    out[static_cast<size_t>(b) * N + n0 + c] = __float2bfloat16(v);
  }
}

// A weight's tensor map, encoded on its first call and kept: the key is
// everything the map encodes, so a weight freed and another allocated at the
// same address with the same shape and type reuses a map that is right for it.
cudaError_t weight_map(CUtensorMap* map, const void* w, int K, int N, int bytes,
                       int box_rows) {
  using Key = std::tuple<const void*, int, int, int, int>;
  static std::mutex lock;
  static std::map<Key, CUtensorMap> maps;
  const Key key{w, K, N, bytes, box_rows};
  std::lock_guard<std::mutex> guard(lock);
  const auto found = maps.find(key);
  if (found != maps.end()) {
    *map = found->second;
    return cudaSuccess;
  }
  // bf16 rows of 64 bytes swizzled for ldmatrix; narrow rows are widened
  // (and swizzled) by the kernel
  const cudaError_t err = hopper::encode_2d(map, w, K, N, bytes, box_rows, GEMV_COLS, bytes == 2);
  if (err != cudaSuccess) return err;
  if (maps.size() >= 4096) maps.clear();  // bounds a long process's memory
  maps.emplace(key, *map);
  return cudaSuccess;
}

template <bool GELU, int MODE>
int launch_matmul(const void* x, const void* w, const void* scale, const void* bias, void* out,
                  int B, int K, int N, int cluster, cudaStream_t stream) {
  // k_rows: the K-slice of one rank, a multiple of 16 and of the box count
  const int slice = (K + cluster - 1) / cluster;
  const int boxes = (slice + MAX_BOX_ROWS - 1) / MAX_BOX_ROWS;
  const int box_rows = (((slice + boxes - 1) / boxes) + 15) / 16 * 16;
  const int k_rows = boxes * box_rows;
  CUtensorMap map;
  cudaError_t err = weight_map(&map, w, K, N, Word<MODE>::BYTES, box_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = decode_matmul_kernel<GELU, MODE>;
  const size_t smem = GemvLayout<MODE>(k_rows, cluster).total;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, (N + GEMV_COLS - 1) / GEMV_COLS, 1);
  config.blockDim = dim3(GEMV_THREADS, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, map, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const float*>(scale), static_cast<const float*>(bias),
                           static_cast<__nv_bfloat16*>(out), B, K, N, k_rows, box_rows);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename W, int MODE>
int decode_matmul(const void* x, const void* w, const void* scale, const void* bias,
                  void* out, int B, int K, int N, int gelu, int cluster, void* stream) {
  if (B < 1 || B > Weight<W>::MAX_ROWS || K < 1 || N % Weight<W>::VEC != 0 || cluster < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gelu ? launch_matmul<true, MODE>(x, w, scale, bias, out, B, K, N, cluster, s)
              : launch_matmul<false, MODE>(x, w, scale, bias, out, B, K, N, cluster, s);
}

template <int BT, typename W>
int launch_ffn(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
               float* partial, int B, int K, int H, int N, cudaStream_t stream) {
  const size_t smem = gemv_smem<BT>(K);
  auto kernel = decode_ffn_kernel<BT, W>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + TILE_COLS - 1) / TILE_COLS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const W*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1), static_cast<const W*>(w2),
      partial, B, K, H, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int decode_ffn(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
               const void* s2, const void* b2, void* partial, void* out, int B, int K, int H,
               int N, void* stream) {
  constexpr int VEC = Weight<W>::VEC;
  if (B < 1 || B > Weight<W>::MAX_ROWS || N % VEC != 0 || H % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(partial);
  int err;
  if (B <= 4) {
    err = launch_ffn<4, W>(x, w1, s1, b1, w2, scratch, B, K, H, N, s);
  } else if (B <= 8) {
    err = launch_ffn<8, W>(x, w1, s1, b1, w2, scratch, B, K, H, N, s);
  } else {
    err = launch_ffn<Weight<W>::MAX_ROWS, W>(x, w1, s1, b1, w2, scratch, B, K, H, N, s);
  }
  if (err != 0) return err;
  const int total = B * N;
  splits_reduce_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      scratch, static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), (H + TILE_COLS - 1) / TILE_COLS, B, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of x one launch takes (16 with bf16 weights, 8 with int8 / e4m3);
// the Python wrapper splits larger batches.
int decode_max_rows(int weight_bytes) {
  return weight_bytes == 2 ? Weight<__nv_bfloat16>::MAX_ROWS : Weight<int8_t>::MAX_ROWS;
}

// Float32 partial slabs decode_ffn_* writes for a hidden width H.
int decode_ffn_splits(int H) { return (H + TILE_COLS - 1) / TILE_COLS; }

// out[B, N] = act(x[B, K] @ w[K, N] + bias[N]); bias may be null; act is
// tanh GELU when gelu != 0. bf16 in and out, float32 accumulation; K split
// over a cluster of `cluster` blocks (8 is the portable size; a size the
// card refuses returns its launch error). w 16-byte aligned, N a multiple
// of 8 (bf16) or 16 (int8 / e4m3).
int decode_matmul_bf16(const void* x, const void* w, const void* bias, void* out, int B, int K,
                       int N, int gelu, int cluster, void* stream) {
  return decode_matmul<__nv_bfloat16, BF16>(x, w, nullptr, bias, out, B, K, N, gelu, cluster,
                                            stream);
}

// The same with int8 / e4m3 w and its float32 scale[N]:
// out = act((x @ widen(w)) * scale + bias).
int decode_matmul_int8(const void* x, const void* w, const void* scale, const void* bias,
                       void* out, int B, int K, int N, int gelu, int cluster, void* stream) {
  return decode_matmul<int8_t, INT8>(x, w, scale, bias, out, B, K, N, gelu, cluster, stream);
}

int decode_matmul_fp8(const void* x, const void* w, const void* scale, const void* bias,
                      void* out, int B, int K, int N, int gelu, int cluster, void* stream) {
  return decode_matmul<__nv_fp8_e4m3, FP8>(x, w, scale, bias, out, B, K, N, gelu, cluster,
                                           stream);
}

// out[B, N] = gelu(x[B, K] @ w1[K, H] + b1[H]) @ w2[H, N] + b2[N], the hidden
// rounded to bf16 before the second product. partial is float32 scratch of
// decode_ffn_splits(H) * B * N values.
int decode_ffn_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, void* partial, void* out, int B, int K, int H, int N,
                    void* stream) {
  return decode_ffn<__nv_bfloat16>(x, w1, nullptr, b1, w2, nullptr, b2, partial, out, B, K, H,
                                   N, stream);
}

// The same with int8 / e4m3 w1, w2 and their float32 scales s1[H], s2[N]:
// out = (bf16(gelu((x @ widen(w1)) * s1 + b1)) @ widen(w2)) * s2 + b2.
int decode_ffn_int8(const void* x, const void* w1, const void* s1, const void* b1,
                    const void* w2, const void* s2, const void* b2, void* partial, void* out,
                    int B, int K, int H, int N, void* stream) {
  return decode_ffn<int8_t>(x, w1, s1, b1, w2, s2, b2, partial, out, B, K, H, N, stream);
}

int decode_ffn_fp8(const void* x, const void* w1, const void* s1, const void* b1,
                   const void* w2, const void* s2, const void* b2, void* partial, void* out,
                   int B, int K, int H, int N, void* stream) {
  return decode_ffn<__nv_fp8_e4m3>(x, w1, s1, b1, w2, s2, b2, partial, out, B, K, H, N,
                                   stream);
}

}  // extern "C"
