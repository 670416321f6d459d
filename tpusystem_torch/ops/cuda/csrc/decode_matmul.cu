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

// K5, decode_ffn_kernel<MODE>: the fc -> tanh GELU -> proj chain in one
// cluster launch whose [B, H] hidden activation never leaves the chip. The
// kernel it replaces (a block per 32 hidden columns streaming both weights
// with one 16-byte load a thread, float32 FMAs, a float32 partial
// [H / 32, B, N] in HBM summed by a second launch) kept ~0.4 MB in flight
// and reached 0.09 of its bound. So, with K4's machinery:
//   * a cluster of `cluster` blocks (8) owns a hidden slab of cluster * 32
//     columns (12 clusters, 96 blocks of 16 warps at GPT-2's H = 3072);
//     rank r computes the slab's columns r * 32 .. + 32;
//   * at its start each rank asks for its bytes at once: x's rows and its
//     slices of s1, b1, s2 and b2 by bulk copies first (ordinary loads
//     issued beside the weights' copies landed after them), then, by 2-D
//     TMA (maps cached as K4's), its w1 slab [K, 32] in boxes of at most 256
//     rows and its w2 slab, the cluster's cluster * 32 hidden rows by its
//     share of N in whole 32-column tiles (64-byte swizzle). The boxes pass
//     through a ring of slots, each under its own mbarrier, so work starts
//     as each lands: at GPT-2 up to dim 1280 the ring holds every box, so
//     every weight byte is in flight at the launch; past that (GPT-2 XL's
//     1600) a slot takes the next box once its box has been read;
//   * the fc on the tensor cores: mma.sync m16n8k16 over the whole K, box
//     by box, so no sum is split over ranks; each warp takes one n8 tile of
//     the rank's columns over one part of each box's steps, four steps'
//     fragments loaded ahead and two accumulators, the parts summed in part
//     order; with B <= 8 the A fragments' zero rows are not loaded (the
//     bytes that ldmatrix moves, not the mma.sync issue, set the products'
//     time); on the float32 sum w1's scale, then b1, then the tanh GELU, as
//     the reference orders them; hidden columns at or past H are set to 0
//     (a TMA zero-fill does not give 0 once b1 is added), then rounded to
//     bf16 as the reference does;
//   * each rank's [16, 32] hidden tile reaches every rank of its cluster
//     that has proj columns through distributed shared memory: 16-byte
//     asynchronous stores (st.async) into the peer's hidden slab, counted
//     on the peer's mbarrier; no hidden value reaches HBM;
//   * the proj on the tensor cores: [16, cluster * 32] times the rank's w2
//     tiles, four tiles at a time; int8 / e4m3 boxes are widened exactly by
//     integer and bf16 operations (widen_bits; Word<>::widen's float
//     conversions run at a quarter of the issue rate) into a bf16 buffer;
//   * the cross-slab sum: each rank writes its float32 partial [B, its
//     columns] (H / (cluster * 32) slabs: 0.3 MB in all at GPT-2, B = 8) and
//     takes a ticket on its share's counter; the last of the slabs to take
//     one sums the partials in slab order, applies w2's scale to the full
//     sum (not to each partial), then b2, and rounds once, so the sums
//     repeat bitwise. The counters are the caller's, one set per stream:
//     launches on one stream run in order, and two launches in flight on
//     two streams never share a counter. The last holder sets its counter
//     back to 0, so the next launch on the stream finds it so.
// Probes on an H100 (PERF.md, Findings) settled 32 hidden columns a rank (16,
// at twice the clusters, was slower at every weight type) and the ticket
// (the sum as a second launch was 0.5-0.6 us slower). A block needs x's
// rows and one ring slot in its shared memory: K up to ~6,100 with bf16 at
// 9-16 rows, ~12,200 at up to 8, ~11,700 with int8 / e4m3, and any N.

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

// The weight types' launch limits: N a multiple of VEC (one 16-byte row
// segment), at most MAX_ROWS rows of x a launch.
template <typename W>
struct Weight;

template <>
struct Weight<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr int MAX_ROWS = 16;
};

template <>
struct Weight<int8_t> {
  static constexpr int VEC = 16;
  static constexpr int MAX_ROWS = 8;
};

template <>
struct Weight<__nv_fp8_e4m3> {
  static constexpr int VEC = 16;
  static constexpr int MAX_ROWS = 8;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True), torch's approximate='tanh'
  const float k0 = 0.7978845608028654f;           // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
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
// widened to 4 bf16 values, exactly (|int8| <= 127 and every e4m3 value are
// bf16 values).
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

// ------------------------------------------------------------------ K5

constexpr int FFN_THREADS = 512;  // 16 warps
constexpr int FFN_WARPS = FFN_THREADS / 32;
// a rank's hidden columns and a w2 tile's output columns: one weight box's
// 32 columns (bf16 rows of 64 bytes under the 64-byte swizzle, as K4's)
constexpr int FFN_HR = GEMV_COLS;
constexpr int FFN_TILE = GEMV_COLS;
constexpr int FFN_ROUND = 4;                // w2 tiles the proj takes at once (4 n8 warps each)
constexpr size_t MAX_SMEM = 227 * 1024;     // a Hopper block's dynamic shared memory

__host__ __device__ constexpr size_t align1024(size_t bytes) {
  return (bytes + 1023) & ~static_cast<size_t>(1023);
}

// Rank `rank`'s share of the output's 32-column tiles: `count` tiles from
// `first`, the first tiles % ranks ranks one more than the others; `most`
// is the largest share (every rank's shared memory is laid out for it).
struct Share {
  int first, count, most;
  __host__ __device__ Share(int N, int ranks, int rank) {
    const int tiles = (N + FFN_TILE - 1) / FFN_TILE;
    const int base = tiles / ranks, extra = tiles % ranks;
    first = rank * base + (rank < extra ? rank : extra);
    count = base + (rank < extra ? 1 : 0);
    most = base + (extra > 0 ? 1 : 0);
  }
};

// The shared memory of decode_ffn_kernel, from a 1024-byte aligned base
// (`total` counts the slack to it): the ring of `slots` weight boxes, each
// a w1 box [box_rows][32] or a w2 tile [w2_rows][32] as TMA lands it (bf16
// rows of 64 bytes swizzled; narrow rows of 32 bytes as they are), the bf16
// buffer of wide_rows rows narrow boxes are widened into (a round of w2
// tiles, or as many w1 boxes), x [x_rows][k_rows + 8] and the cluster's hidden [GEMV_ROWS][ranks *
// 32 + 8] in bf16 (rows padded by 16 bytes, so each ldmatrix's 8 rows fall in
// 8 bank groups), the fc's K-part sums [warps - 4][32 lanes][4] in float32,
// the rank's s1 and b1 [2][32] and its share's s2 and b2 [2][most * 32] in
// float32, an mbarrier for each slot, x's and the hidden slab's mbarriers
// and the ticket's flag.
template <int MODE>
struct FfnLayout {
  int wide_rows;
  size_t slot, wide, x, hidden, parts, vectors, bar, total;
  __host__ __device__ FfnLayout(int k_rows, int box_rows, int w2_rows, int slots, int ranks,
                                int most, int x_rows) {
    slot = align1024(static_cast<size_t>(box_rows > w2_rows ? box_rows : w2_rows) * GEMV_COLS *
                     Word<MODE>::BYTES);
    const int round = slots < FFN_ROUND ? slots : FFN_ROUND;
    const int tiles = round < most ? round : most;
    wide_rows = box_rows > tiles * w2_rows ? box_rows : tiles * w2_rows;
    wide = slots * slot;
    x = wide + (MODE == BF16 ? 0 : align1024(static_cast<size_t>(wide_rows) * GEMV_COLS * 2));
    hidden = x + static_cast<size_t>(x_rows) * (k_rows + 8) * 2;
    parts = hidden + static_cast<size_t>(GEMV_ROWS) * (ranks * FFN_HR + 8) * 2;
    vectors = parts + static_cast<size_t>(FFN_WARPS - FFN_HR / 8) * 32 * 4 * sizeof(float);
    bar = vectors + 2 * (FFN_HR + static_cast<size_t>(most) * FFN_TILE) * sizeof(float);
    total = bar + (slots + 3) * sizeof(uint64_t) + 1024;
  }
};

// The sizes of one launch: x's rows padded to k_rows (a multiple of 16, w1
// read in boxes of box_rows) and to x_rows (8 when B <= 8: the A fragments'
// rows 8-15 are not read), the cluster's hidden rows of w2 in boxes of
// w2_box_rows (w2_rows in all, at least cluster * 32), `slabs` clusters
// along H, and the most ring slots that fit a block (0: x's rows do not fit
// beside one slot).
template <int MODE>
struct FfnPlan {
  int k_rows, box_rows, w2_box_rows, w2_rows, slabs, x_rows, slots;
  size_t smem;
  FfnPlan(int B, int K, int H, int N, int cluster) {
    const int boxes = (K + MAX_BOX_ROWS - 1) / MAX_BOX_ROWS;
    box_rows = (((K + boxes - 1) / boxes) + 15) / 16 * 16;
    k_rows = boxes * box_rows;
    const int rows2 = cluster * FFN_HR;
    const int boxes2 = (rows2 + MAX_BOX_ROWS - 1) / MAX_BOX_ROWS;
    w2_box_rows = (((rows2 + boxes2 - 1) / boxes2) + 15) / 16 * 16;
    w2_rows = boxes2 * w2_box_rows;
    slabs = (H + rows2 - 1) / rows2;
    x_rows = B <= 8 ? 8 : GEMV_ROWS;
    const int most = Share(N, cluster, 0).most;
    smem = 0;
    for (slots = boxes + most; slots > 0; --slots) {
      smem = FfnLayout<MODE>(k_rows, box_rows, w2_rows, slots, cluster, most, x_rows).total;
      if (smem <= MAX_SMEM) break;
    }
  }
};

// One 4-byte word of int8 / e4m3 values as 4 bf16 values, exactly, Word<>::
// widen's result by integer and bf16 operations at the full issue rate (the
// float conversions it uses run at a quarter of it):
//   * int8 v: the float of bits 0x4B000000 | (v + 128) is 2^23 + v + 128;
//     less 2^23 + 128 it is v exactly, and a float of at most 8 significant
//     bits is its bf16 bits followed by 16 zero bits;
//   * e4m3 s eeee mmm: the bf16 s 0000eeee mmm0000 (the exponent's bias 7
//     read as bf16's 127) times 2^120, exact for normal and subnormal
//     values alike (a power of 2 within range); every finite e4m3 value.
template <int MODE>
__device__ __forceinline__ uint2 widen_bits(uint32_t word) {
  if constexpr (MODE == INT8) {
    const uint32_t biased = word ^ 0x80808080u;  // v + 128, unsigned
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(biased, 0x4B00u, 0x5440u + i)) - 8388736.0f;
    return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
  } else {
    const __nv_bfloat162 scale = __halves2bfloat162(__ushort_as_bfloat16(0x7B80),
                                                    __ushort_as_bfloat16(0x7B80));  // 2^120
    uint32_t pair[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t high = __byte_perm(word, 0u, i == 0 ? 0x1404u : 0x3424u);  // byte << 8
      const uint32_t bits = (high & 0x80008000u) | ((high >> 4) & 0x07F007F0u);
      const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&bits), scale);
      pair[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    return make_uint2(pair[0], pair[1]);
  }
}

// A narrow box [rows][32] (rows of 32 bytes, as TMA lands it) widened to
// bf16, exactly, in the layout TMA gives a bf16 box: rows of 64 bytes under
// the 64-byte swizzle. A thread takes half a row a step: one 16-byte load,
// two 16-byte stores (a quarter-warp's stores fall in 8 bank groups).
template <int MODE>
__device__ void widen_slab(const unsigned char* narrow, unsigned char* wide, int rows) {
  for (int i = threadIdx.x; i < rows * 2; i += FFN_THREADS) {
    const uint4 v = *reinterpret_cast<const uint4*>(narrow + i * 16);
    const uint2 w[4] = {widen_bits<MODE>(v.x), widen_bits<MODE>(v.y), widen_bits<MODE>(v.z),
                        widen_bits<MODE>(v.w)};
    *reinterpret_cast<uint4*>(wide + swizzled(i / 2, 2 * (i % 2))) =
        make_uint4(w[0].x, w[0].y, w[1].x, w[1].y);
    *reinterpret_cast<uint4*>(wide + swizzled(i / 2, 2 * (i % 2) + 1)) =
        make_uint4(w[2].x, w[2].y, w[3].x, w[3].y);
  }
}

// The lane's ldmatrix address in a row-major bf16 A tile [16][stride] at
// `base`: for ldmatrix_x4 (rows 0-15 at k, then at k + 8) or, when `half`
// (rows 8-15 are zero), for ldmatrix_x2 (rows 0-7 at k, then at k + 8).
__device__ __forceinline__ uint32_t a_lane(uint32_t base, int stride, bool half, int lane) {
  return base + (half ? (lane % 8) * stride + (lane / 8 % 2) * 8
                      : (lane % 16) * stride + (lane / 16) * 8) * 2;
}

// One k16 step's A fragment at `address` (see a_lane): a half tile leaves
// rows 8-15 (registers 1 and 3) zero and reads half the bytes.
__device__ __forceinline__ void load_a(uint32_t* a, uint32_t address, bool half) {
  if (half) {
    hopper::ldmatrix_x2(a, address);
    a[2] = a[1];
    a[1] = a[3] = 0u;
  } else {
    hopper::ldmatrix_x4(a, address);
  }
}

// d += A B over the k16 steps [begin, end) of one warp: A's fragment at
// a_address + 32 bytes a step (load_a), B's by ldmatrix_x2_trans at
// b_address(step); four steps' fragments are loaded before their products,
// which alternate between two accumulators (summed at the end), so the
// loads and the products of neighbouring steps overlap.
template <typename Address>
__device__ __forceinline__ void mma_steps(float* d, uint32_t a_address, bool half,
                                          Address b_address, int begin, int end) {
  float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int s = begin;
  for (; s + 4 <= end; s += 4) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      load_a(a[u], a_address + (s + u) * 32, half);
      hopper::ldmatrix_x2_trans(b[u], b_address(s + u));
    }
    hopper::mma_m16n8k16_bf16(d, a[0], b[0]);
    hopper::mma_m16n8k16_bf16(e, a[1], b[1]);
    hopper::mma_m16n8k16_bf16(d, a[2], b[2]);
    hopper::mma_m16n8k16_bf16(e, a[3], b[3]);
  }
  for (; s < end; ++s) {
    uint32_t a[4], b[2];
    load_a(a, a_address + s * 32, half);
    hopper::ldmatrix_x2_trans(b, b_address(s));
    hopper::mma_m16n8k16_bf16(d, a, b);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) d[j] += e[j];
}

// out[b, n .. n + 3] = (the slabs' partials summed in slab order) * scale +
// bias, rounded once; partial is [slabs][B][N] float32 written by this
// launch (read past L1, up to 16 slabs' loads in flight at once); scale and
// bias point at w2's scale and b2 of columns n .. n + 3 and may be null.
__device__ __forceinline__ void finish(const float* partial, const float* scale,
                                       const float* bias, __nv_bfloat16* out, int slabs, int B,
                                       int N, int b, int n) {
  constexpr int AT_ONCE = 16;
  const float4* column = reinterpret_cast<const float4*>(partial + static_cast<size_t>(b) * N + n);
  const size_t step = static_cast<size_t>(B) * N / 4;
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s0 = 0; s0 < slabs; s0 += AT_ONCE) {
    float4 v[AT_ONCE];
#pragma unroll
    for (int u = 0; u < AT_ONCE; ++u)
      if (s0 + u < slabs) v[u] = __ldcg(column + (s0 + u) * step);
#pragma unroll
    for (int u = 0; u < AT_ONCE; ++u) {
      if (s0 + u >= slabs) break;
      if (s0 + u == 0) {
        sum = v[0];
        continue;
      }
      sum.x += v[u].x;
      sum.y += v[u].y;
      sum.z += v[u].z;
      sum.w += v[u].w;
    }
  }
  float r[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (scale != nullptr) r[j] *= scale[j];
    if (bias != nullptr) r[j] += bias[j];
  }
  *reinterpret_cast<uint2*>(out + static_cast<size_t>(b) * N + n) =
      make_uint2(hopper::pack_bf16(r[0], r[1]), hopper::pack_bf16(r[2], r[3]));
}

// The ticket of a share: an atomic add that releases the block's stores
// ordered before it (by the barrier before it) and acquires the stores the
// other blocks released with theirs, at device scope.
__device__ __forceinline__ int take_ticket(int* counter) {
  int ticket;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(ticket)
               : "l"(counter)
               : "memory");
  return ticket;
}

// One cluster (blockIdx.y: its slab of ranks * 32 hidden columns) of
// out = (bf16(gelu((x @ w1) * s1 + b1)) @ w2) * s2 + b2; the block's cluster
// rank takes hidden columns rank * 32 .. + 32 of the slab and its share of
// N. w1_map boxes [box_rows][32] of w1 [K, H], w2_map boxes [w2_box_rows][32]
// of w2 [H, N]. The block's weight boxes, w1's in K order and then its w2
// tiles ("items"), pass through a ring of `slots` slots: item q in slot
// q % slots, requested at the start for q < slots and otherwise once item
// q - slots has been read. s1, s2 (narrow weights) may be null. tickets:
// one counter a rank, 0 at the launch and left 0.
template <int MODE>
__global__ void __launch_bounds__(FFN_THREADS)
    decode_ffn_kernel(const __grid_constant__ CUtensorMap w1_map,
                      const __grid_constant__ CUtensorMap w2_map,
                      const __nv_bfloat16* __restrict__ x, const float* __restrict__ s1,
                      const float* __restrict__ b1, const float* __restrict__ s2,
                      const float* __restrict__ b2, float* __restrict__ partial,
                      int* __restrict__ tickets, __nv_bfloat16* __restrict__ out, int B, int K,
                      int H, int N, int k_rows, int box_rows, int w2_box_rows, int w2_rows,
                      int slots, int x_rows) {
  using W = Word<MODE>;
  constexpr int HR = FFN_HR;
  constexpr int FC_TILES = HR / 8;              // the fc's n8 tiles
  constexpr int PARTS = FFN_WARPS / FC_TILES;   // K parts of each box, a warp each
  constexpr int CHUNKS = HR * 2 / 16;           // 16-byte chunks of a hidden tile's row
  extern __shared__ unsigned char dynamic_smem[];
  unsigned char* smem =
      dynamic_smem + ((1024 - (hopper::smem_address(dynamic_smem) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int ranks = static_cast<int>(gridDim.x);
  const int slab = blockIdx.y, slabs = gridDim.y;
  const Share share(N, ranks, rank);
  const FfnLayout<MODE> layout(k_rows, box_rows, w2_rows, slots, ranks, share.most, x_rows);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem + layout.x);
  __nv_bfloat16* hid_s = reinterpret_cast<__nv_bfloat16*>(smem + layout.hidden);
  float* parts = reinterpret_cast<float*>(smem + layout.parts);
  float* vectors = reinterpret_cast<float*>(smem + layout.vectors);  // s1, b1, s2, b2
  // an mbarrier for each ring slot, then x's and the hidden slab's
  const uint32_t slot_bars = hopper::smem_address(smem + layout.bar);
  const uint32_t x_bar = slot_bars + slots * sizeof(uint64_t);
  const uint32_t hid_bar = x_bar + sizeof(uint64_t);
  int* last = reinterpret_cast<int*>(smem + layout.bar + (slots + 2) * sizeof(uint64_t));
  const int boxes = k_rows / box_rows;
  const int items = boxes + share.count;
  const int x_stride = k_rows + 8, h_stride = ranks * HR + 8;  // in bf16 values
  const int rows2 = ranks * HR;                 // the slab's hidden columns: proj's K
  const int h0 = slab * rows2 + rank * HR;      // this rank's first hidden column
  const bool proj = share.count > 0;
  const bool half = B <= 8;                     // x's rows 8-15 are zero
  // x's rows by bulk copy where they are 16-byte aligned, and so the
  // vectors' slices of this block: s1, b1 at its hidden columns (h_cols of
  // them before H), s2, b2 at its share's output columns (n_cols before N)
  const bool bulk_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool bulk_vectors = (reinterpret_cast<uintptr_t>(s1) | reinterpret_cast<uintptr_t>(b1) |
                             reinterpret_cast<uintptr_t>(s2) | reinterpret_cast<uintptr_t>(b2)) %
                                16 == 0;
  const int c0 = share.first * FFN_TILE;
  const int h_cols = h0 < H ? (H - h0 < HR ? H - h0 : HR) : 0;
  const int n_cols = proj ? (N - c0 < share.count * FFN_TILE ? N - c0 : share.count * FFN_TILE)
                          : 0;
  const int b2_at = 2 * HR + share.most * FFN_TILE;
  const float* sources[4] = {s1 == nullptr ? nullptr : s1 + h0, b1 + h0,
                             s2 == nullptr ? nullptr : s2 + c0, b2 == nullptr ? nullptr : b2 + c0};
  const int offsets[4] = {0, HR, 2 * HR, b2_at};
  const int counts[4] = {h_cols, h_cols, n_cols, n_cols};

  // item q into its slot, under the slot's barrier; a slot's n-th item
  // (from 0) completes its barrier's phase n
  auto request = [&](int q) {
    const uint32_t bar = slot_bars + (q % slots) * sizeof(uint64_t);
    unsigned char* slot = smem + (q % slots) * layout.slot;
    if (q < boxes) {
      hopper::mbarrier_expect_tx(bar, static_cast<uint32_t>(box_rows) * HR * W::BYTES);
      hopper::tma_load_2d(hopper::smem_address(slot), &w1_map, bar, h0, q * box_rows);
      return;
    }
    hopper::mbarrier_expect_tx(bar, static_cast<uint32_t>(w2_rows) * FFN_TILE * W::BYTES);
    for (int j = 0; j < w2_rows / w2_box_rows; ++j)
      hopper::tma_load_2d(hopper::smem_address(slot + j * w2_box_rows * FFN_TILE * W::BYTES),
                          &w2_map, bar, (share.first + q - boxes) * FFN_TILE,
                          slab * rows2 + j * w2_box_rows);
  };
  auto landed = [&](int q) {
    hopper::mbarrier_wait(slot_bars + (q % slots) * sizeof(uint64_t), (q / slots) & 1);
    return smem + (q % slots) * layout.slot;
  };

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) hopper::mbarrier_init(slot_bars + s * sizeof(uint64_t), 1);
    hopper::mbarrier_init(x_bar, 1);
    hopper::mbarrier_init(hid_bar, 1);
    hopper::fence_barrier_init();
    // the other ranks' hidden tiles, GEMV_ROWS x HR bf16 each
    if (proj) hopper::mbarrier_expect_tx(hid_bar, (ranks - 1) * GEMV_ROWS * HR * 2);
    // x and the vectors first, then the block's weight boxes in the order
    // they are used, as many as the ring holds (ordinary loads issued
    // beside them land after them)
    uint32_t bytes = bulk_x ? static_cast<uint32_t>(B) * K * 2 : 0;
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (bulk_vectors && sources[v] != nullptr) bytes += counts[v] * sizeof(float);
    hopper::mbarrier_expect_tx(x_bar, bytes);
    if (bulk_x)
      for (int b = 0; b < B; ++b)
        hopper::bulk_load(hopper::smem_address(x_s + b * x_stride), x + static_cast<size_t>(b) * K,
                          K * 2, x_bar);
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (bulk_vectors && sources[v] != nullptr && counts[v] > 0)
        hopper::bulk_load(hopper::smem_address(vectors + offsets[v]), sources[v],
                          counts[v] * sizeof(float), x_bar);
    for (int q = 0; q < items && q < slots; ++q) request(q);
  }
  hopper::cluster_arrive_relaxed();  // this block's barriers are initialised
  // the vectors' entries no bulk copy brings: 1 (scales) or 0 (biases) past
  // H, past N or for a null vector, the loaded value where copies cannot
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    for (int j = tid; j < (v < 2 ? HR : share.most * FFN_TILE); j += FFN_THREADS) {
      if (j < counts[v] && sources[v] != nullptr) {
        if (!bulk_vectors) vectors[offsets[v] + j] = sources[v][j];
      } else {
        vectors[offsets[v] + j] = v % 2 == 0 ? 1.0f : 0.0f;
      }
    }
  }
  // x as it is (bf16), zero past B rows and past K: the bulk copies' rows
  // padded with zeros (16 bytes a store past B), or value by value
  if (bulk_x) {
    const int chunks = k_rows / 8;
    for (int c = tid; c < (x_rows - B) * chunks; c += FFN_THREADS)
      *reinterpret_cast<uint4*>(x_s + (B + c / chunks) * x_stride + (c % chunks) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < B * (k_rows - K); i += FFN_THREADS)
      x_s[(i / (k_rows - K)) * x_stride + K + i % (k_rows - K)] = __float2bfloat16(0.0f);
  } else {
    for (int i = tid; i < x_rows * k_rows; i += FFN_THREADS) {
      const int b = i / k_rows, k = i % k_rows;
      x_s[b * x_stride + k] =
          (b < B && k < K) ? x[static_cast<size_t>(b) * K + k] : __float2bfloat16(0.0f);
    }
  }
  hopper::mbarrier_wait(x_bar, 0);
  __syncthreads();  // x and the vectors are in place

  // the fc, a group of boxes at a time as they land: bf16 one box, read in
  // its slot; narrow as many as the wide buffer holds, widened together.
  // Warp w multiplies x by n8 tile w % FC_TILES of the rank's columns over
  // part w / FC_TILES of the group's k16 steps; the group's slots then take
  // the next items
  const int tile = warp % FC_TILES, part = warp / FC_TILES;
  const int wide_boxes = layout.wide_rows / box_rows;
  const int group = MODE == BF16 ? 1 : (wide_boxes < slots ? wide_boxes : slots);
  const uint32_t x_address = a_lane(hopper::smem_address(x_s), x_stride, half, lane);
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int g0 = 0; g0 < boxes; g0 += group) {
    const int n = boxes - g0 < group ? boxes - g0 : group;
    const unsigned char* base = smem + layout.wide;
    if constexpr (MODE == BF16) {
      base = landed(g0);
    } else {
      for (int u = 0; u < n; ++u)
        widen_slab<MODE>(landed(g0 + u), smem + layout.wide + u * box_rows * GEMV_COLS * 2,
                         box_rows);
      __syncthreads();  // the group is widened, and its slots read
      if (tid == 0)
        for (int q = g0; q < g0 + n && q + slots < items; ++q) request(q + slots);
    }
    const int steps = n * box_rows / 16;
    const uint32_t b_base = hopper::smem_address(base);
    mma_steps(d, x_address + g0 * box_rows * 2, half,
              [&](int s) { return b_base + swizzled(16 * s + lane % 16, tile); },
              part * steps / PARTS, (part + 1) * steps / PARTS);
    if (MODE == BF16 ? g0 + slots < items : g0 + group < boxes) {
      __syncthreads();  // every warp has read the box's slot (or the wide buffer)
      if (MODE == BF16 && tid == 0) request(g0 + slots);
    }
  }
  if (part > 0)
    *reinterpret_cast<float4*>(parts + ((part - 1) * FC_TILES + tile) * 128 + lane * 4) =
        make_float4(d[0], d[1], d[2], d[3]);
  __syncthreads();
  if (part == 0) {
    // the parts in part order; then w1's scale, b1 and the tanh GELU on the
    // float32 sum, 0 past H, rounded to bf16 into the rank's columns
    for (int p = 1; p < PARTS; ++p) {
      const float4 v =
          *reinterpret_cast<const float4*>(parts + ((p - 1) * FC_TILES + tile) * 128 + lane * 4);
      d[0] += v.x;
      d[1] += v.y;
      d[2] += v.z;
      d[3] += v.w;
    }
    const int column = 8 * tile + 2 * (lane % 4), row = lane / 4;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = column + j % 2;
      float h = d[j];
      if (s1 != nullptr) h *= vectors[c];
      v[j] = h0 + c < H ? gelu_tanh(h + vectors[HR + c]) : 0.0f;
    }
    *reinterpret_cast<uint32_t*>(hid_s + row * h_stride + rank * HR + column) =
        hopper::pack_bf16(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(hid_s + (row + 8) * h_stride + rank * HR + column) =
        hopper::pack_bf16(v[2], v[3]);
  }
  __syncthreads();

  // the rank's hidden tile into the same columns of every other rank that
  // has proj columns, 16 bytes a store, counted on that rank's barrier; the
  // bits leave as they are (st.async of four 32-bit words)
  hopper::cluster_wait();  // every rank is running and its barriers armed
  for (int i = tid; i < ranks * GEMV_ROWS * CHUNKS; i += FFN_THREADS) {
    const int peer = i / (GEMV_ROWS * CHUNKS);
    if (peer == rank || Share(N, ranks, peer).count == 0) continue;
    const int row = (i / CHUNKS) % GEMV_ROWS, chunk = i % CHUNKS;
    const __nv_bfloat16* mine = hid_s + row * h_stride + rank * HR + chunk * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(mine);
    hopper::store_async_float4(hopper::cluster_address(hopper::smem_address(mine), peer),
                               __uint_as_float(v.x), __uint_as_float(v.y),
                               __uint_as_float(v.z), __uint_as_float(v.w),
                               hopper::cluster_address(hid_bar, peer));
  }
  if (!proj) return;  // its stores leave from registers; nothing is sent to it

  // the proj: [16, rows2] hidden times the rank's w2 tiles, a round of up to
  // FFN_ROUND tiles at a time (all in the ring at once): warp w takes n8 tile
  // w % 4 of the round's tile w / 4 (narrow tiles widened first), stored as
  // float32 rows of the slab's partial; the round's slots then take the
  // next items
  const int round = slots < FFN_ROUND ? slots : FFN_ROUND;
  const size_t wide_tile = static_cast<size_t>(w2_rows) * FFN_TILE * 2;
  const uint32_t h_address = a_lane(hopper::smem_address(hid_s), h_stride, half, lane);
  for (int t0 = 0; t0 < share.count; t0 += round) {
    const int tiles = share.count - t0 < round ? share.count - t0 : round;
    const int t = t0 + warp / 4;
    if constexpr (MODE != BF16) {
      for (int u = 0; u < tiles; ++u)
        widen_slab<MODE>(landed(boxes + t0 + u), smem + layout.wide + u * wide_tile, w2_rows);
      __syncthreads();  // the round is widened, and its slots read
      if (tid == 0)
        for (int q = boxes + t0; q < boxes + t0 + tiles && q + slots < items; ++q)
          request(q + slots);
    }
    if (t0 == 0) hopper::mbarrier_wait_cluster(hid_bar, 0);  // the peers' hidden tiles
    if (warp / 4 < tiles) {
      const unsigned char* tile_slab = MODE == BF16 ? landed(boxes + t)
                                                    : smem + layout.wide + (warp / 4) * wide_tile;
      const uint32_t b_base = hopper::smem_address(tile_slab);
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_steps(p, h_address, half,
                [&](int s) { return b_base + swizzled(16 * s + lane % 16, warp % 4); }, 0,
                rows2 / 16);
      const int n = (share.first + t) * FFN_TILE + (warp % 4) * 8 + 2 * (lane % 4);
      const int row = lane / 4;
      float* base = partial + (static_cast<size_t>(slab) * B + row) * N + n;
      if (n < N && row < B) *reinterpret_cast<float2*>(base) = make_float2(p[0], p[1]);
      if (n < N && row + 8 < B)
        *reinterpret_cast<float2*>(base + static_cast<size_t>(8) * N) = make_float2(p[2], p[3]);
    }
    if (t0 + round < share.count) {
      __syncthreads();  // every warp has read the round's slots (or widened tiles)
      if (MODE == BF16 && tid == 0)
        for (int q = boxes + t0; q < boxes + t0 + tiles && q + slots < items; ++q)
          request(q + slots);
    }
  }

  // the ticket of the rank's share: the last slab to take it sums every
  // slab's partial of the share's columns, in slab order, and sets the
  // counter back to 0 (every slab has taken its ticket by then). The
  // barrier orders the block's partial stores before thread 0's release.
  __syncthreads();
  if (tid == 0) {
    *last = take_ticket(tickets + rank) == slabs - 1;
    if (*last) tickets[rank] = 0;
  }
  __syncthreads();
  if (!*last) return;
  const int quads = n_cols / 4;
  for (int i = tid; i < B * quads; i += FFN_THREADS) {
    const int n = 4 * (i % quads);
    finish(partial, s2 == nullptr ? nullptr : vectors + 2 * HR + n,
           b2 == nullptr ? nullptr : vectors + b2_at + n, out, slabs, B, N, i / quads, c0 + n);
  }
}

template <typename W, int MODE>
int decode_ffn(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
               const void* s2, const void* b2, void* partial, void* tickets, void* out, int B,
               int K, int H, int N, int cluster, void* stream) {
  if (B < 1 || B > Weight<W>::MAX_ROWS || K < 1 || H % Weight<W>::VEC != 0 || H < 1 ||
      N % Weight<W>::VEC != 0 || N < 1 || cluster < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FfnPlan<MODE> plan(B, K, H, N, cluster);
  if (plan.slots == 0) return static_cast<int>(cudaErrorInvalidValue);  // x does not fit
  CUtensorMap w1_map, w2_map;
  cudaError_t err = weight_map(&w1_map, w1, K, H, Word<MODE>::BYTES, plan.box_rows);
  if (err == cudaSuccess)
    err = weight_map(&w2_map, w2, H, N, Word<MODE>::BYTES, plan.w2_box_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = decode_ffn_kernel<MODE>;
  err = allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, plan.slabs, 1);
  config.blockDim = dim3(FFN_THREADS, 1, 1);
  config.dynamicSmemBytes = plan.smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, w1_map, w2_map, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const float*>(s1), static_cast<const float*>(b1),
                           static_cast<const float*>(s2), static_cast<const float*>(b2),
                           static_cast<float*>(partial), static_cast<int*>(tickets),
                           static_cast<__nv_bfloat16*>(out), B, K, H, N, plan.k_rows,
                           plan.box_rows, plan.w2_box_rows, plan.w2_rows, plan.slots,
                           plan.x_rows);
  const cudaError_t launched = cudaGetLastError();  // clears a refused launch's error
  return static_cast<int>(err != cudaSuccess ? err : launched);
}

}  // namespace

extern "C" {

// Rows of x one launch takes (16 with bf16 weights, 8 with int8 / e4m3);
// the Python wrapper splits larger batches.
int decode_max_rows(int weight_bytes) {
  return weight_bytes == 2 ? Weight<__nv_bfloat16>::MAX_ROWS : Weight<int8_t>::MAX_ROWS;
}

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
// rounded to bf16 before the second product, in one launch of clusters of
// `cluster` blocks (8 is the portable size; a size the card refuses returns
// its launch error). partial is float32 scratch of slabs * B * N values,
// slabs = ceil(H / (cluster * 32)); tickets `cluster` int32 counters that
// are 0 and that no launch in flight on another stream uses; the launch
// leaves them 0. w1, w2 16-byte aligned, H and N multiples of 8 (bf16) or
// 16 (int8 / e4m3); a K whose rows of x do not fit a block beside one
// weight box returns cudaErrorInvalidValue.
int decode_ffn_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, void* partial, void* tickets, void* out, int B, int K, int H,
                    int N, int cluster, void* stream) {
  return decode_ffn<__nv_bfloat16, BF16>(x, w1, nullptr, b1, w2, nullptr, b2, partial, tickets,
                                         out, B, K, H, N, cluster, stream);
}

// The same with int8 / e4m3 w1, w2 and their float32 scales s1[H], s2[N]:
// out = (bf16(gelu((x @ widen(w1)) * s1 + b1)) @ widen(w2)) * s2 + b2.
int decode_ffn_int8(const void* x, const void* w1, const void* s1, const void* b1,
                    const void* w2, const void* s2, const void* b2, void* partial,
                    void* tickets, void* out, int B, int K, int H, int N, int cluster,
                    void* stream) {
  return decode_ffn<int8_t, INT8>(x, w1, s1, b1, w2, s2, b2, partial, tickets, out, B, K, H, N,
                                  cluster, stream);
}

int decode_ffn_fp8(const void* x, const void* w1, const void* s1, const void* b1,
                   const void* w2, const void* s2, const void* b2, void* partial, void* tickets,
                   void* out, int B, int K, int H, int N, int cluster, void* stream) {
  return decode_ffn<__nv_fp8_e4m3, FP8>(x, w1, s1, b1, w2, s2, b2, partial, tickets, out, B, K,
                                        H, N, cluster, stream);
}

}  // extern "C"
