// Flash-attention backward for Hopper (sm_90a): bf16 q, k, v, out and dO,
// float32 lse and delta, bf16 dq, dk and dv.
//
// Replaces the Pallas TPU kernels of tpusystem/ops/pallas/flash.py reached
// through _flash_bwd_impl:
//   * flash_bwd_fused_g1 <- _flash_fused_bwd_g1_kernel (K2a, call at :541);
//   * flash_bwd_fused    <- _flash_fused_bwd_kernel    (K2b, call at :586);
//   * flash_bwd_dq       <- _flash_dq_kernel           (K3a, call at :622);
//   * flash_bwd_dkv      <- _flash_dkv_kernel          (K3b, call at :651).
//
// One __device__ routine, tile_terms, holds the per-tile math of
// _bwd_block_terms (flash.py:253-278) for all four kernels, so they cannot
// drift apart numerically: scores = (q . k) * scale with the causal mask,
// P = exp(scores - lse), dP = dO . v, dS = P * (dP - delta) * scale. P is
// rounded to bf16 (dO's dtype) before dV += P^T dO, dS to bf16 (q's dtype)
// before dK += dS^T Q and dQ += dS K; every sum is float32. Under dropout
// (flash_dropout.cuh's positional hash of the query head's row, as the
// forward hashed it) dV takes kept = P * keep / (1 - p) and dS takes
// keep * dP / (1 - p) in place of dP (flash.py:270-277).
//
// What bounds it on an H100: at the GPT-2 125M training shape
// [16, 1024, 12, 64], causal, the fused backward does 5 products of
// 2 * 64 flops per visible (query, key) pair: ~6.5e10 flops against
// ~0.18 GB of q, k, v, dO, dq, dk, dv, lse and delta, so the tensor-core
// bound is ~65 us and the memory bound ~53 us; at Llama-3 8B's
// [1, 8192, 32 q / 8 kv heads, 128] the 1.07e9 visible pairs make it
// 1.39 ms of tensor-core work. These first kernels do their products with
// scalar float32 FMAs out of shared memory (4 x D / 16 register tiles per
// thread), so they are bound by the SMs' scalar FP32 rate, far above that
// bound: mma.sync / wgmma with TMA-fed tiles is the later step.
//
// What the design does:
//   * 64 x 64 tiles; 256 threads, thread (ty, tx) owning rows ty + 16 i and
//     columns tx + 16 j of every tile product, so shared-memory reads are
//     broadcasts or conflict-free (rows padded by two bf16).
//   * flash_bwd_dkv: a block per (kv tile, batch * kv head) holds k and v in
//     shared memory and sweeps every (group member, q tile) pair that can
//     see the tile, member-major as the reference's grid does, with dk and
//     dv in registers; under GQA the mask row is the query head's row.
//   * flash_bwd_dq: a block per (q tile, batch * q head) holds q and dO and
//     sweeps the visible kv tiles with dq in registers.
//   * flash_bwd_fused: the dkv sweep that also forms dS K for every tile it
//     recomputes (5 products per tile instead of the split pair's 7). No
//     Hopper block can carry dq across blocks that run in no order, so each
//     (q tile, kv tile) writes its float32 dq partial, and a second pass
//     sums a row's partials in kv order and rounds once. Only the visible
//     pairs are stored: tiles * (tiles + 1) / 2 per query head when causal
//     (136 of 256 at S = 1024), 428 MB at the training shape instead of the
//     805 MB of a dense [kv_tiles, B * H, S, D] array.
//   * flash_bwd_fused_g1 (MHA): K2b's sweep, a block per (kv tile, batch *
//     head), without the partials. Each block adds its dS K product for q
//     tile i into a float32 dq_acc [B, S, H, D] that the wrapper zeroes
//     (50 MB at [1, 16384, 12, 64] where K2b's partials take 6.47 GB). The
//     adds to one (head row, q tile) happen in ascending kv-tile order: kv
//     tile j waits until that pair's integer ticket reads j, adds, and
//     releases it as j + 1; the last contributor (the diagonal tile when
//     causal, else the last kv tile) rounds the row to bf16 and writes dq.
//     So every dq element is ((0 + c0) + c1) + ..., the sum dq_reduce_kernel
//     takes over K2b's partials of the same products: K2a equals K2b bit
//     for bit in dq, dk and dv. A block takes its work item from an atomic
//     counter when it starts, items numbered kv-tile-major (the longest
//     causal sweeps first), so a block only ever waits on items that blocks
//     already running have claimed: no deadlock, whatever order the
//     hardware launches blocks in. The ticket is released with a fence and
//     st.release.gpu and read with ld.acquire.gpu; dq_acc moves through L2
//     (ld/st .cg), never a stale L1 line.
//   * No float atomics anywhere: two calls on the same inputs give bitwise
//     the same dq, dk and dv.
//   * Any sequence length: rows and columns past S are masked (P = 0) and
//     never written. Tensors keep the public [B, S, H, D] layout (lse and
//     delta [B, S, Hq]); the kernels compute their own strided offsets.
//   * Head dims 16, 32, 64 and 128 (by_head_dim), one design for all. At
//     128 a thread's dk and dv tiles are 4 x 8 floats each (64 registers
//     live across the sweep) and tile_terms' s and dp 32 more, beside the
//     operands: ptxas gives K2b's sweep 160 registers, K3b's 153, K2a 154
//     and the dq sweep 115, none spilling (chip_smoke.py's bwd-ptxas), so
//     K2b, K3b and K2a run one 256-thread block an SM and K3a two. The tiles take
//     83,968 bytes of dynamic shared memory (Layout<128>), under the 227 KB
//     a block may have. K2b's float32 partials grow with D: 8.66 GB a call
//     at Llama-3 8B's [1, 8192, 32, 128], one layer's backward at a time.
//
// Plain C interface (bound with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_dropout.cuh"

namespace {

constexpr int TILE = 64;               // query rows and kv rows per tile
constexpr int THREADS = 256;
constexpr int TX = 16;                 // threads along a product's columns
constexpr int TY = THREADS / TX;       // threads along its rows
constexpr int RPT = TILE / TY;         // tile rows per thread
constexpr int CPT = TILE / TX;         // score columns per thread
constexpr int SP = TILE + 2;           // padded row of the P and dS tiles

typedef __nv_bfloat16 bf16;

template <int D>
struct Layout {
  static constexpr int P = D + 2;      // padded row of a q, k, v or dO tile
  static constexpr int DPT = D / TX;   // output dims per thread
  static constexpr size_t bytes =
      (4 * TILE * P + 2 * TILE * SP) * sizeof(bf16) + 2 * TILE * sizeof(float);
};

struct Tiles {
  bf16 *q, *k, *v, *dout, *p, *ds;
  float *lse, *delta;
};

template <int D>
__device__ Tiles carve(unsigned char* smem) {
  constexpr int P = Layout<D>::P;
  Tiles t;
  t.q = reinterpret_cast<bf16*>(smem);
  t.k = t.q + TILE * P;
  t.v = t.k + TILE * P;
  t.dout = t.v + TILE * P;
  t.p = t.dout + TILE * P;
  t.ds = t.p + TILE * SP;
  t.lse = reinterpret_cast<float*>(t.ds + TILE * SP);
  t.delta = t.lse + TILE;
  return t;
}

// rows row0 .. row0 + 63 of head h of batch b of a [B, S, H, D] tensor into
// a padded shared tile; zeros past the sequence end
template <int D>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int row0, int S,
                          int H, int h, int b) {
  constexpr int P = Layout<D>::P;
  constexpr int CHUNKS = D / 8;        // 16-byte chunks per row
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = i % CHUNKS;
    const int row = row0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < S)
      raw = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * S + row) * H + h) * D + c * 8);
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + r * P + c * 8);
    out[0] = raw.x;
    out[1] = raw.y;
    out[2] = raw.z;
    out[3] = raw.w;
  }
}

// one row statistic (lse or delta, [B, S, H] float32) per tile row
__device__ void load_stats(float* dst, const float* __restrict__ src, int row0, int S,
                           int H, int h, int b) {
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int row = row0 + r;
    dst[r] = row < S ? src[(static_cast<size_t>(b) * S + row) * H + h] : 0.0f;
  }
}

// _bwd_block_terms: the kept P and dS of the (q0.., k0..) tile pair of
// query head row head_row into shared memory, both rounded to bf16. Callers
// synchronise before and after.
template <int D>
__device__ void tile_terms(const Tiles& t, int q0, int k0, int S, float scale, int causal,
                           const Dropout& drop, int head_row) {
  constexpr int P = Layout<D>::P;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.0f;

#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    float2 qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = (ty + TY * i) * P + d;
      qv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t.q + r));
      ov[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t.dout + r));
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = (tx + TX * j) * P + d;
      kv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t.k + c));
      vv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t.v + c));
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        dp[i][j] = fmaf(ov[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(ov[i].y, vv[j].y, dp[i][j]);
      }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty + TY * i;
    const int qrow = q0 + row;
    const float lse = t.lse[row];
    const float delta = t.delta[row];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = tx + TX * j;
      const int kcol = k0 + col;
      const bool visible = qrow < S && kcol < S && (!causal || kcol <= qrow);
      // masked scores are -1e30 in the reference: exp(-1e30 - lse) == 0
      const float p = visible ? expf(s[i][j] * scale - lse) : 0.0f;
      float kept = p, d_kept = dp[i][j];
      if (drop.on) {
        const float keep = keep_element(qrow, kcol, head_row, drop) ? 1.0f : 0.0f;
        kept = p * keep / drop.keep;
        d_kept = keep * d_kept / drop.keep;
      }
      const float ds = p * (d_kept - delta) * scale;
      t.p[row * SP + col] = __float2bfloat16(kept);
      t.ds[row * SP + col] = __float2bfloat16(ds);
    }
  }
}

// acc[r][d] += sum over the tile's query rows x of a[x][r] * m[x][d]
// (dV += P^T dO with a = P, dK += dS^T Q with a = dS)
template <int D>
__device__ void accumulate_transposed(float (&acc)[RPT][Layout<D>::DPT], const bf16* a,
                                      const bf16* m) {
  constexpr int P = Layout<D>::P;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll 4
  for (int x = 0; x < TILE; ++x) {
    float av[RPT], mv[Layout<D>::DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) av[i] = __bfloat162float(a[x * SP + ty + TY * i]);
#pragma unroll
    for (int j = 0; j < Layout<D>::DPT; ++j) mv[j] = __bfloat162float(m[x * P + tx + TX * j]);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < Layout<D>::DPT; ++j) acc[i][j] = fmaf(av[i], mv[j], acc[i][j]);
  }
}

// acc[r][d] += sum over the tile's kv rows c of a[r][c] * m[c][d]
// (dQ += dS K)
template <int D>
__device__ void accumulate(float (&acc)[RPT][Layout<D>::DPT], const bf16* a, const bf16* m) {
  constexpr int P = Layout<D>::P;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll 4
  for (int c = 0; c < TILE; ++c) {
    float av[RPT], mv[Layout<D>::DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) av[i] = __bfloat162float(a[(ty + TY * i) * SP + c]);
#pragma unroll
    for (int j = 0; j < Layout<D>::DPT; ++j) mv[j] = __bfloat162float(m[c * P + tx + TX * j]);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < Layout<D>::DPT; ++j) acc[i][j] = fmaf(av[i], mv[j], acc[i][j]);
  }
}

// rows row0 + ty + 16 i (below S) of head h of batch b, rounded to bf16
template <int D>
__device__ void store_rows(bf16* __restrict__ dst, const float (&acc)[RPT][Layout<D>::DPT],
                           int row0, int S, int H, int h, int b) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + ty + TY * i;
    if (row >= S) continue;
    bf16* out = dst + ((static_cast<size_t>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < Layout<D>::DPT; ++j) out[tx + TX * j] = __float2bfloat16(acc[i][j]);
  }
}

// visible (q tile, kv tile) pairs per query head, and the first pair of q tile qt
__host__ __device__ inline size_t pair_count(int tiles, int causal) {
  return causal ? static_cast<size_t>(tiles) * (tiles + 1) / 2
                : static_cast<size_t>(tiles) * tiles;
}
__host__ __device__ inline size_t pair_base(int qt, int tiles, int causal) {
  return causal ? static_cast<size_t>(qt) * (qt + 1) / 2 : static_cast<size_t>(qt) * tiles;
}

// K3b (FUSED = false) and K2b (FUSED = true): one block per (kv tile,
// batch * kv head), sweeping (group member, q tile) pairs
template <int D, bool FUSED>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dq_partial,
                    int S, int Hq, int Hkv, float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles t = carve<D>(smem);
  constexpr int DPT = Layout<D>::DPT;
  const int kt = blockIdx.x;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int group = Hq / Hkv;
  const int tiles = (S + TILE - 1) / TILE;
  const int k0 = kt * TILE;
  load_tile<D>(t.k, k, k0, S, Hkv, hk, b);
  load_tile<D>(t.v, v, k0, S, Hkv, hk, b);

  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  const int first = causal ? kt : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = first; qt < tiles; ++qt) {
      const int q0 = qt * TILE;
      __syncthreads();                   // the last pair's readers are done
      load_tile<D>(t.q, q, q0, S, Hq, h, b);
      load_tile<D>(t.dout, dout, q0, S, Hq, h, b);
      load_stats(t.lse, lse, q0, S, Hq, h, b);
      load_stats(t.delta, delta, q0, S, Hq, h, b);
      __syncthreads();
      tile_terms<D>(t, q0, k0, S, scale, causal, drop, b * Hq + h);
      __syncthreads();
      accumulate_transposed<D>(dv_acc, t.p, t.dout);
      accumulate_transposed<D>(dk_acc, t.ds, t.q);
      if (FUSED) {
        float dq_acc[RPT][DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) dq_acc[i][j] = 0.0f;
        accumulate<D>(dq_acc, t.ds, t.k);
        const size_t slot = (static_cast<size_t>(b) * Hq + h) * pair_count(tiles, causal) +
                            pair_base(qt, tiles, causal) + kt;
        float* out = dq_partial + slot * TILE * D;
        const int tx = threadIdx.x % TX;
        const int ty = threadIdx.x / TX;
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) out[(ty + TY * i) * D + tx + TX * j] = dq_acc[i][j];
      }
    }
  }
  store_rows<D>(dk, dk_acc, k0, S, Hkv, hk, b);
  store_rows<D>(dv, dv_acc, k0, S, Hkv, hk, b);
}

// second pass of the fused backward: a query row's partials summed in kv
// order, rounded once; one thread per (batch * head, row, dim)
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_reduce_kernel(const float* __restrict__ dq_partial, bf16* __restrict__ dq, int B, int S,
                 int Hq, int causal) {
  const size_t index = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (index >= static_cast<size_t>(B) * Hq * S * D) return;
  const int d = static_cast<int>(index % D);
  const int row = static_cast<int>((index / D) % S);
  const size_t bh = index / (static_cast<size_t>(D) * S);
  const int tiles = (S + TILE - 1) / TILE;
  const int qt = row / TILE;
  const int last = causal ? qt : tiles - 1;
  const float* src = dq_partial +
                     (bh * pair_count(tiles, causal) + pair_base(qt, tiles, causal)) * TILE * D +
                     (row % TILE) * D + d;
  float sum = 0.0f;
  for (int kt = 0; kt <= last; ++kt) sum += src[static_cast<size_t>(kt) * TILE * D];
  const int b = static_cast<int>(bh / Hq);
  const int h = static_cast<int>(bh % Hq);
  dq[((static_cast<size_t>(b) * S + row) * Hq + h) * D + d] = __float2bfloat16(sum);
}

// K3a: one block per (q tile, batch * q head), sweeping the visible kv tiles
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int S, int Hq, int Hkv, float scale, int causal,
                    Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles t = carve<D>(smem);
  constexpr int DPT = Layout<D>::DPT;
  const int qt = blockIdx.x;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int tiles = (S + TILE - 1) / TILE;
  const int q0 = qt * TILE;
  load_tile<D>(t.q, q, q0, S, Hq, h, b);
  load_tile<D>(t.dout, dout, q0, S, Hq, h, b);
  load_stats(t.lse, lse, q0, S, Hq, h, b);
  load_stats(t.delta, delta, q0, S, Hq, h, b);

  float dq_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq_acc[i][j] = 0.0f;

  const int last = causal ? qt : tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();                     // the last tile's readers are done
    load_tile<D>(t.k, k, k0, S, Hkv, hk, b);
    load_tile<D>(t.v, v, k0, S, Hkv, hk, b);
    __syncthreads();
    tile_terms<D>(t, q0, k0, S, scale, causal, drop, blockIdx.y);
    __syncthreads();
    accumulate<D>(dq_acc, t.ds, t.k);
  }
  store_rows<D>(dq, dq_acc, q0, S, Hq, h, b);
}

__device__ __forceinline__ int load_acquire(const int* flag) {
  int value;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(value) : "l"(flag) : "memory");
  return value;
}

__device__ __forceinline__ void store_release(int* flag, int value) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;\n" : : "l"(flag), "r"(value) : "memory");
}

// K2a: one block per work item (kv tile, batch * head), MHA. tickets[0] is
// the item counter, tickets[1 + bh * tiles + qt] the next kv tile whose dS K
// may enter dq_acc's q tile qt of head row bh.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_g1_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ dq_acc, int* __restrict__ tickets, int B, int S, int H,
                    float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int claimed;
  const Tiles t = carve<D>(smem);
  constexpr int DPT = Layout<D>::DPT;
  if (threadIdx.x == 0) claimed = atomicAdd(tickets, 1);
  __syncthreads();
  const int rows = B * H;
  const int kt = claimed / rows;       // kv-tile-major: longest sweeps first
  const int bh = claimed % rows;
  const int b = bh / H;
  const int h = bh % H;
  const int tiles = (S + TILE - 1) / TILE;
  const int k0 = kt * TILE;
  int* ticket = tickets + 1 + static_cast<size_t>(bh) * tiles;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  load_tile<D>(t.k, k, k0, S, H, h, b);
  load_tile<D>(t.v, v, k0, S, H, h, b);

  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  for (int qt = causal ? kt : 0; qt < tiles; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();                     // the last pair's readers are done
    load_tile<D>(t.q, q, q0, S, H, h, b);
    load_tile<D>(t.dout, dout, q0, S, H, h, b);
    load_stats(t.lse, lse, q0, S, H, h, b);
    load_stats(t.delta, delta, q0, S, H, h, b);
    __syncthreads();
    tile_terms<D>(t, q0, k0, S, scale, causal, drop, bh);
    __syncthreads();
    accumulate_transposed<D>(dv_acc, t.p, t.dout);
    accumulate_transposed<D>(dk_acc, t.ds, t.q);
    float part[RPT][DPT];                // this pair's dS K, as K2b's partial
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) part[i][j] = 0.0f;
    accumulate<D>(part, t.ds, t.k);

    // kv tile kt's turn on q tile qt: the tiles before it have added
    if (threadIdx.x == 0) {
      while (load_acquire(ticket + qt) != kt) __nanosleep(64);
    }
    __syncthreads();
    const bool last = kt == (causal ? qt : tiles - 1);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + TY * i;
      if (row >= S) continue;
      const size_t base = ((static_cast<size_t>(b) * S + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + TX * j;
        const float sum = __ldcg(dq_acc + base + d) + part[i][j];
        if (last)
          dq[base + d] = __float2bfloat16(sum);
        else
          __stcg(dq_acc + base + d, sum);
      }
    }
    if (!last) {
      __threadfence();                   // this thread's adds reach L2 first
      __syncthreads();
      if (threadIdx.x == 0) store_release(ticket + qt, kt + 1);
    }
  }
  store_rows<D>(dk, dk_acc, k0, S, H, h, b);
  store_rows<D>(dv, dv_acc, k0, S, H, h, b);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int D, bool FUSED>
int launch_kv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, void* dq_partial, int B, int S, int Hq,
              int Hkv, float scale, int causal, const Dropout& drop, cudaStream_t stream) {
  auto kernel = flash_bwd_kv_kernel<D, FUSED>;
  const size_t bytes = Layout<D>::bytes;
  if (const int err = prepare(kernel, bytes)) return err;
  const dim3 grid((S + TILE - 1) / TILE, B * Hkv);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dq_partial), S, Hq, Hkv, scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_reduce(const void* dq_partial, void* dq, int B, int S, int Hq, int causal,
                  cudaStream_t stream) {
  const size_t total = static_cast<size_t>(B) * Hq * S * D;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  dq_reduce_kernel<D><<<blocks, THREADS, 0, stream>>>(static_cast<const float*>(dq_partial),
                                                      static_cast<bf16*>(dq), B, S, Hq, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int S, int Hq, int Hkv, float scale,
              int causal, const Dropout& drop, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<D>;
  const size_t bytes = Layout<D>::bytes;
  if (const int err = prepare(kernel, bytes)) return err;
  const dim3 grid((S + TILE - 1) / TILE, B * Hq);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, Hq, Hkv, scale, causal,
      drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_g1(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, void* dk, void* dv, void* dq_acc, void* tickets,
              int B, int S, int H, float scale, int causal, const Dropout& drop,
              cudaStream_t stream) {
  auto kernel = flash_bwd_g1_kernel<D>;
  const size_t bytes = Layout<D>::bytes;
  if (const int err = prepare(kernel, bytes)) return err;
  const unsigned items = static_cast<unsigned>((S + TILE - 1) / TILE) * B * H;
  kernel<<<items, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dq_acc), static_cast<int*>(tickets), B, S, H,
      scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int B, int S, int Hq, int Hkv) {
  return B >= 1 && S >= 1 && Hkv >= 1 && Hq % Hkv == 0 && B * Hq <= 65535;
}

// launch(std::integral_constant<int, D>()) for the instantiated head dims
template <typename Launch>
int by_head_dim(int D, Launch launch) {
  switch (D) {
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    case 64: return launch(std::integral_constant<int, 64>());
    case 128: return launch(std::integral_constant<int, 128>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Elements of the float32 partial buffer flash_bwd_fused_bf16 needs.
size_t flash_bwd_partial_elements(int B, int S, int Hq, int D, int causal) {
  const int tiles = (S + TILE - 1) / TILE;
  return static_cast<size_t>(B) * Hq * pair_count(tiles, causal) * TILE * D;
}

// Ints of the zeroed ticket buffer flash_bwd_fused_g1_bf16 needs: the item
// counter and one ticket per (batch * head, q tile).
size_t flash_bwd_g1_tickets(int B, int S, int H) {
  return 1 + static_cast<size_t>(B) * H * ((S + TILE - 1) / TILE);
}

// q, dout [B, S, Hq, D]; k, v [B, S, Hkv, D] bf16 (contiguous); lse and
// delta [B, S, Hq] float32; dq like q, dk and dv like k; dq_partial holds
// flash_bwd_partial_elements(...) floats. D in {16, 32, 64, 128}. dropout
// NULL or off for none (as in every entry point below).
int flash_bwd_fused_bf16(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         void* dq_partial, int B, int S, int Hq, int Hkv, int D, float scale,
                         int causal, const Dropout* dropout, void* stream) {
  if (!valid(B, S, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = dropout_or_off(dropout);
  return by_head_dim(D, [&](auto dim) {
    constexpr int DIM = decltype(dim)::value;
    const int err = launch_kv<DIM, true>(q, k, v, dout, lse, delta, dk, dv, dq_partial, B, S,
                                         Hq, Hkv, scale, causal, drop, s);
    return err ? err : launch_reduce<DIM>(dq_partial, dq, B, S, Hq, causal, s);
  });
}

// MHA: q, k, v, dout [B, S, H, D] bf16 (contiguous); lse and delta
// [B, S, H] float32; dq, dk, dv like q; dq_acc [B, S, H, D] float32 and
// tickets (flash_bwd_g1_tickets(...) ints) zeroed by the caller.
int flash_bwd_fused_g1_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            void* dq_acc, void* tickets, int B, int S, int H, int D,
                            float scale, int causal, const Dropout* dropout, void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = dropout_or_off(dropout);
  return by_head_dim(D, [&](auto dim) {
    return launch_g1<decltype(dim)::value>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc,
                                           tickets, B, S, H, scale, causal, drop, s);
  });
}

int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                       int Hq, int Hkv, int D, float scale, int causal, const Dropout* dropout,
                       void* stream) {
  if (!valid(B, S, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = dropout_or_off(dropout);
  return by_head_dim(D, [&](auto dim) {
    return launch_kv<decltype(dim)::value, false>(q, k, v, dout, lse, delta, dk, dv, nullptr,
                                                  B, S, Hq, Hkv, scale, causal, drop, s);
  });
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int S, int Hq,
                      int Hkv, int D, float scale, int causal, const Dropout* dropout,
                      void* stream) {
  if (!valid(B, S, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = dropout_or_off(dropout);
  return by_head_dim(D, [&](auto dim) {
    return launch_dq<decltype(dim)::value>(q, k, v, dout, lse, delta, dq, B, S, Hq, Hkv,
                                           scale, causal, drop, s);
  });
}

}  // extern "C"
