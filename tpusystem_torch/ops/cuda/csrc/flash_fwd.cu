// Flash-attention forward for Hopper (sm_90a), bf16 in and out, float32
// logsumexp: TMA-fed wgmma tiles.
//
// Replaces the Pallas TPU kernel tpusystem/ops/pallas/flash.py:
// _flash_fwd_kernel (reached through _flash_fwd, flash_attention and
// flash_attention_lse) -- K1, with its attention-probability dropout.
//
// What bounds it on an H100: at Llama-3 8B's prefill [1, 8192, 32 q, 8 kv,
// 128] the causal products are ~550 GFLOP against ~170 MB of q, k, v, out
// and lse, 0.56 ms at the bf16 tensor-core peak and 0.05 ms of memory: the
// tensor cores bound it, at every shape the main paths give it past a few
// hundred keys. So both products run on wgmma, fed by TMA.
//
// What the design does (hopper.cuh notes each layout fact it relies on):
//   * One block per (128-row query tile, b * Hq + h): two consumer
//     warpgroups of 64 query rows, 256 threads. The grid's x is b * Hq + h
//     and its y the query tile counted from the end, so the longest causal
//     rows are dispatched first and the tail of the grid is short tiles.
//   * TMA loads into dynamic shared memory, 4-D maps over [B, S, H, D] with
//     a box of 128 rows by one swizzle row (64 columns of 128 bytes, or the
//     whole head dim of 16 / 32 at the 32 / 64-byte swizzle); the q tile is
//     loaded once, the k and v tiles of 128 rows go through a ring of two
//     stages, a "full" mbarrier a stage with the tile's bytes expected.
//     Thread 0 issues tile j + 1's loads before tile j's products, into the
//     stage of tile j - 1 once its "empty" mbarrier has seen all eight
//     warps arrive after their P.V wait; no block-wide barrier in the loop,
//     so one warpgroup's softmax can overlap the other's products, a tile
//     apart at most. TMA zero-fills rows past S.
//   * S = Q K^T with wgmma.m64n128k16, both operands K-major from shared
//     memory, D / 16 steps; the scores stay in the accumulator's registers.
//   * Online softmax in float32 on the accumulator, the TPU kernel's
//     arithmetic: running max m, sum l of the unrounded probabilities, the
//     output rescaled by exp(m_prev - m_new); a row's values lie in one quad
//     of lanes, so its max and sum are two shuffles. The causal mask
//     (row >= col on global positions, else NEG_INF = -1e30) and the ragged
//     end (col >= S) are applied on the last visible tile only: with
//     128-row tiles on both sides that is the diagonal tile, and every
//     earlier tile is wholly visible.
//   * O += P V with wgmma.m64nNk16, A = P from registers (the probabilities
//     rounded to bf16, packed in pairs: the score accumulator's layout is
//     already the A fragment's) and B = the v tile, MN-major, through the
//     transpose bit; at head dim 128 one instruction per 64-column block.
//   * Epilogue: out = acc / safe_l (then / keep under dropout) rounded to
//     bf16 and stored from registers, rows past S skipped; lse =
//     m + log(safe_l) with safe_l = 1 where l == 0, written by one lane of
//     each quad.
//   * GQA: query head h reads kv head h / (Hq / Hkv) through the maps'
//     head coordinate; grouped kv is never broadcast.
//   * Dropout (flash.py:127-157): l sums every probability, the kept ones
//     (flash_dropout.cuh's positional hash at the element's global row and
//     column and the query head's row b * Hq + h, passed explicitly) meet v,
//     and out is divided by keep. At p = 0 none of it runs.
//
// Plain C interface (bound with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_dropout.cuh"
#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 128;      // query rows per block, 64 per warpgroup
constexpr int BLOCK_N = 128;      // kv rows per tile
constexpr int THREADS = 256;      // two warpgroups
constexpr int STAGES = 2;         // the k / v ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// The shared memory of one block, from a 1024-byte aligned base: the q tile,
// then per stage the k tile and the v tile, then the mbarriers: q's, one
// "full" a stage (the TMA's bytes landed), one "empty" a stage (all eight
// warps are done reading it). A tile of D columns is D / CHUNK blocks of
// [rows x ROW_BYTES].
template <int D>
struct Tiles {
  static constexpr int CHUNK = D < 64 ? D : 64;       // columns a TMA box holds
  static constexpr int ROW_BYTES = CHUNK * 2;          // the swizzle width
  static constexpr int CHUNKS = D / CHUNK;
  static constexpr int LAYOUT = hopper::layout_for(ROW_BYTES);
  static constexpr int K_STEPS = CHUNK / 16;           // k16 steps in one block
  static constexpr uint32_t Q_CHUNK = BLOCK_M * ROW_BYTES;
  static constexpr uint32_t KV_CHUNK = BLOCK_N * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = Q_CHUNK * CHUNKS;
  static constexpr uint32_t KV_BYTES = KV_CHUNK * CHUNKS;   // one of k, v
  static constexpr uint32_t KV_OFF = Q_BYTES;               // stage s at + 2 s KV_BYTES
  static constexpr uint32_t BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
  static constexpr uint32_t FULL_OFF = BAR_OFF + 8;          // stage s at + 8 s
  static constexpr uint32_t EMPTY_OFF = FULL_OFF + 8 * STAGES;
  static constexpr size_t BYTES = 1024 + EMPTY_OFF + 8 * STAGES;
  static_assert(D % 16 == 0 && D <= 128 && (D <= 64 || D % 64 == 0), "head dim");
  static_assert(Q_CHUNK % 1024 == 0 && KV_CHUNK % 1024 == 0, "1024-byte aligned tiles");
};

template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t base, int stage, int tile, int hk, int b) {
  using T = Tiles<D>;
  const uint32_t bar = base + T::FULL_OFF + 8 * stage;
  const uint32_t k_s = base + T::KV_OFF + stage * 2 * T::KV_BYTES;
  hopper::mbarrier_expect_tx(bar, 2 * T::KV_BYTES);
#pragma unroll
  for (int c = 0; c < T::CHUNKS; ++c) {
    hopper::tma_load_4d(k_s + c * T::KV_CHUNK, tk, bar, c * T::CHUNK, hk, tile * BLOCK_N, b);
    hopper::tma_load_4d(k_s + T::KV_BYTES + c * T::KV_CHUNK, tv, bar, c * T::CHUNK, hk,
                        tile * BLOCK_N, b);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int S, int Hq, int Hkv, float scale, int causal,
                 Dropout drop) {
  using T = Tiles<D>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (hopper::smem_address(smem) + 1023) & ~1023u;
  const uint32_t bar_q = base + T::BAR_OFF;

  const int tid = threadIdx.x;
  const int wg = tid / 128;                 // warpgroup: query rows 64 wg ..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;                // columns 2 quad, 2 quad + 1 of a chunk
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const uint32_t head_row = static_cast<uint32_t>(b) * Hq + h;   // dropout's row
  const int hk = h / (Hq / Hkv);
  const int tiles = gridDim.y;
  const int qt = tiles - 1 - blockIdx.y;    // the longest causal rows first
  const int last = causal ? qt : tiles - 1; // the last visible kv tile
  // this thread's two query rows (global positions)
  const int row0 = qt * BLOCK_M + 64 * wg + 16 * warp + lane / 4;
  const int rows[2] = {row0, row0 + 8};

  if (tid == 0) {
    hopper::mbarrier_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbarrier_init(base + T::FULL_OFF + 8 * s, 1);
      hopper::mbarrier_init(base + T::EMPTY_OFF + 8 * s, THREADS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbarrier_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
    for (int c = 0; c < T::CHUNKS; ++c)
      hopper::tma_load_4d(base + c * T::Q_CHUNK, &tq, bar_q, c * T::CHUNK, h, qt * BLOCK_M, b);
    load_kv<D>(&tk, &tv, base, 0, 0, hk, b);
  }

  float acc[D / 2];                         // out: D / 8 chunks of 4
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float s_acc[BLOCK_N / 2];                 // scores: 16 chunks of 4
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) s_acc[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};

  // this warpgroup's 64 rows of q, block c, k16 step i: base + c Q_CHUNK
  // + 64 wg ROW_BYTES + 32 i
  const uint32_t q_s = base + 64 * wg * T::ROW_BYTES;
  hopper::mbarrier_wait(bar_q, 0);

  for (int j = 0; j <= last; ++j) {
    const int stage = j % STAGES;
    if (tid == 0 && j < last) {
      // tile j + 1 goes where tile j - 1 was: wait until every warp let it go
      const int next = (j + 1) % STAGES;
      if (j >= 1) hopper::mbarrier_wait(base + T::EMPTY_OFF + 8 * next, ((j - 1) / STAGES) & 1);
      load_kv<D>(&tk, &tv, base, next, j + 1, hk, b);
    }
    hopper::mbarrier_wait(base + T::FULL_OFF + 8 * stage, (j / STAGES) & 1);
    const uint32_t k_s = base + T::KV_OFF + stage * 2 * T::KV_BYTES;
    const uint32_t v_s = k_s + T::KV_BYTES;

    // S = Q K^T
    hopper::fence_registers<BLOCK_N / 2>(s_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < T::CHUNKS; ++c) {
#pragma unroll
      for (int i = 0; i < T::K_STEPS; ++i) {
        const uint64_t a = hopper::smem_descriptor(q_s + c * T::Q_CHUNK + 32 * i, 16,
                                                   8 * T::ROW_BYTES, T::LAYOUT);
        const uint64_t bk = hopper::smem_descriptor(k_s + c * T::KV_CHUNK + 32 * i, 16,
                                                    8 * T::ROW_BYTES, T::LAYOUT);
        hopper::wgmma_ss_m64n128k16(s_acc, a, bk, c + i > 0);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_registers<BLOCK_N / 2>(s_acc);

    // scale, mask (last visible tile only), the tile's row max
    float m_new[2] = {m[0], m[1]};
    const bool edge = j == last;
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) {
      const int r = (i / 2) % 2;            // row0 or row0 + 8
      float value = s_acc[i] * scale;
      if (edge) {
        const int col = j * BLOCK_N + 8 * (i / 4) + 2 * quad + i % 2;
        if (col >= S || (causal && col > rows[r])) value = NEG_INF;
      }
      s_acc[i] = value;
      m_new[r] = fmaxf(m_new[r], value);
    }
    float correction[2], m_log2[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(FULL, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(FULL, m_new[r], 2));
      correction[r] = exp2f((m[r] - m_new[r]) * LOG2E);
      m[r] = m_new[r];
      m_log2[r] = m_new[r] * LOG2E;
    }
    // probabilities: l keeps them unrounded, P meets v rounded to bf16
    uint32_t p[BLOCK_N / 4];
#pragma unroll
    for (int i = 0; i < BLOCK_N / 4; ++i) {
      const int r = i % 2;
      float lo = exp2f(s_acc[2 * i] * LOG2E - m_log2[r]);     // one FFMA
      float hi = exp2f(s_acc[2 * i + 1] * LOG2E - m_log2[r]);
      sum[r] += lo + hi;
      if (drop.on) {
        const int col = j * BLOCK_N + 8 * (i / 2) + 2 * quad;
        if (!keep_element(rows[r], col, head_row, drop)) lo = 0.0f;
        if (!keep_element(rows[r], col + 1, head_row, drop)) hi = 0.0f;
      }
      p[i] = hopper::pack_bf16(lo, hi);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(FULL, sum[r], 1);
      sum[r] += __shfl_xor_sync(FULL, sum[r], 2);
      l[r] = correction[r] * l[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= correction[(i / 2) % 2];

    // O += P V: k16 slice i of P is p[4 i .. 4 i + 3]; v rows 16 i .. at
    // 16 i ROW_BYTES in each column block
    hopper::fence_registers<D / 2>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < T::CHUNKS; ++c) {
#pragma unroll
      for (int i = 0; i < BLOCK_N / 16; ++i) {
        const uint64_t bv = hopper::smem_descriptor(
            v_s + c * T::KV_CHUNK + 16 * i * T::ROW_BYTES, T::KV_CHUNK, 8 * T::ROW_BYTES,
            T::LAYOUT);
        hopper::wgmma_rs<T::CHUNK>(acc + c * T::CHUNK / 2, p + 4 * i, bv, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_registers<D / 2>(acc);
    __syncwarp();                           // this warp is done with the stage
    if (lane == 0) hopper::mbarrier_arrive(base + T::EMPTY_OFF + 8 * stage);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    const float safe_l = (l[r] == 0.0f) ? 1.0f : l[r];
    const size_t at = (static_cast<size_t>(b) * S + rows[r]) * Hq + h;
    __nv_bfloat16* dst = o + at * D + 2 * quad;
#pragma unroll
    for (int chunk = 0; chunk < D / 8; ++chunk) {
      float lo = acc[4 * chunk + 2 * r] / safe_l;
      float hi = acc[4 * chunk + 2 * r + 1] / safe_l;
      if (drop.on) {                        // inverted-dropout scaling
        lo = lo / drop.keep;
        hi = hi / drop.keep;
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * chunk) = __floats2bfloat162_rn(lo, hi);
    }
    if (quad == 0) lse[at] = m[r] + logf(safe_l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
           int Hq, int Hkv, float scale, int causal, const Dropout& drop, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap tq, tk, tv;
  if (cudaError_t err = hopper::encode_bshd(&tq, q, B, S, Hq, D, BLOCK_M, T::CHUNK))
    return static_cast<int>(err);
  if (cudaError_t err = hopper::encode_bshd(&tk, k, B, S, Hkv, D, BLOCK_N, T::CHUNK))
    return static_cast<int>(err);
  if (cudaError_t err = hopper::encode_bshd(&tv, v, B, S, Hkv, D, BLOCK_N, T::CHUNK))
    return static_cast<int>(err);
  auto kernel = flash_fwd_kernel<D>;
  if (const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::BYTES)))
    return static_cast<int>(err);
  const dim3 grid(B * Hq, (S + BLOCK_M - 1) / BLOCK_M);
  kernel<<<grid, THREADS, T::BYTES, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                              static_cast<float*>(lse), S, Hq, Hkv, scale,
                                              causal, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, S, Hq, D], k and v [B, S, Hkv, D] bf16 (contiguous, 16-byte aligned);
// o like q; lse [B, S, Hq] float32. D in {16, 32, 64, 128}; Hq a multiple of
// Hkv. dropout NULL or off for none.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int S, int Hq, int Hkv, int D, float scale, int causal,
                   const Dropout* dropout, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || B * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const tensors[4] = {q, k, v, o};
  for (const void* pointer : tensors)
    if (reinterpret_cast<uintptr_t>(pointer) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = dropout_or_off(dropout);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, B, S, Hq, Hkv, scale, causal, drop, s);
    case 32: return launch<32>(q, k, v, o, lse, B, S, Hq, Hkv, scale, causal, drop, s);
    case 64: return launch<64>(q, k, v, o, lse, B, S, Hq, Hkv, scale, causal, drop, s);
    case 128: return launch<128>(q, k, v, o, lse, B, S, Hq, Hkv, scale, causal, drop, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
