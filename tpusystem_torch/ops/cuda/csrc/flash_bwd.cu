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
// Every kernel computes the per-tile math of _bwd_block_terms
// (flash.py:253-278): scores = (q . k) * scale with the causal mask,
// P = exp(scores - lse), dP = dO . v, dS = P * (dP - delta) * scale. P is
// rounded to bf16 (dO's dtype) before dV += P^T dO, dS to bf16 (q's dtype)
// before dK += dS^T Q and dQ += dS K; every sum is float32. Under dropout
// (flash_dropout.cuh's positional hash of the query head's row, as the
// forward hashed it) dV takes kept = P * keep / (1 - p) and dS takes
// keep * dP / (1 - p) in place of dP (flash.py:270-277).
//
// What bounds it on an H100: 5 products of 2 * D flops a visible (query,
// key) pair for the fused backward (K3a 3, K3b 4). At Llama-3 8B's
// [1, 8192, 32 q / 8 kv heads, 128] the 1.07e9 causal pairs make 1.37e12
// flops, 1.39 ms at the bf16 tensor-core peak, against ~0.2 GB of q, k, v,
// dO, dq, dk, dv, lse and delta (0.06 ms); at GPT-2's [16, 1024, 12, 64]
// ~65 us of products, ~53 us of bytes. The tensor cores bound it, so every
// kernel here runs its products on wgmma fed by TMA. The fused kernels (K2a
// and K2b, one body):
//
//   * Geometry. One block per work item (128-row kv tile, b * Hkv + hk),
//     two consumer warpgroups (256 threads) of 64 kv rows each, whose dK and
//     dV accumulators stay in registers for the whole sweep. A block takes
//     its item from an atomic counter (tickets[0]) when it starts, items
//     numbered kv-tile-major so the longest causal sweeps start first. It
//     sweeps the (64-row q tile, group member) pairs that see its kv tile,
//     q tiles in descending order and the group's members inside each
//     (causal: down to q tile 2 kt), so that every block of one kv head
//     meets the last q tile first and they follow each other a few
//     microseconds apart through the dq tickets below (a member-major
//     sweep would hold each block to the pace of the one before it).
//   * Loads. k and v once by TMA (4-D maps over [B, S, H, D], boxes of 128
//     rows by D / 2 columns, or D at D = 16; zero-filled past S). q, dO and
//     the pair's 64 lse and delta values go through a two-stage ring under
//     one "full" mbarrier a stage: thread 0 issues pair i + 1's loads before
//     pair i's products. The wrapper lays lse and delta out [B, Hq, S_pad]
//     (S_pad = S rounded up to 64; 2 MB at Llama's shape), so a pair's 64
//     values are one 256-byte 1-D bulk copy each; in [B, S, Hq] they lie Hq
//     floats apart, under a TMA box's 16-byte inner minimum. A stage is
//     refilled only after the block-wide barrier that closes the pair which
//     used it, so no "empty" barrier is needed.
//   * The five products, per warpgroup, its 64 kv rows as M. The scores are
//     formed transposed, S^T = K Q^T and dP^T = V dO^T (wgmma.m64n32k16 in
//     two halves of 32 query columns, A the k / v tile and B the q / dO
//     tile, both K-major from shared memory), so P^T and dS^T land in the
//     accumulator layout that is the A fragment of the two register-A
//     products: dV += P^T dO and dK += dS^T Q (wgmma.m64nNk16 with B the
//     dO / q tile MN-major through the transpose bit, one instruction per
//     column block), as K1's P V. Element (r, c) of the S^T accumulator is
//     query row q0 + c and key column k0 + 64 wg + r, so lse, delta, the
//     mask and keep_element take (c, r) in that order. For dQ[64 q x D] =
//     dS K over the block's 128 kv rows both warpgroups store their dS^T
//     (bf16) into one shared tile [128 kv x 64 q], 128-byte swizzled by
//     hand as the descriptor reads it (hopper.cuh), then each warpgroup
//     forms half of dQ's columns (all of them at D = 16, where both form
//     it and one adds it) with A = dS read MN-major from that tile (the
//     transpose bit on A) and B = its half of the k tile, MN-major: the k
//     tile is loaded as two boxes of D / 2 columns so that each half is a
//     whole swizzle block.
//   * P^T and dS^T on the accumulator (half_terms): one instantiation for
//     each of (causal mask or ragged end, dropout), chosen per pair, so the
//     common pair is straight-line code; exp2 on the SFU (ex2.approx.ftz)
//     of s * scale * log2(e) - lse * log2(e), the wrapper passing lse
//     already times log2(e). The causal mask and the ragged end apply only
//     to the two q tiles that straddle the kv tile's diagonal, the last q
//     tile and the last kv tile. Masked scores give P = 0 (the reference's
//     -1e30 scores: exp(-1e30 - lse) == 0); rows and columns past S are
//     never written.
//   * dq in ticket order, no partials. Each (q tile, query head) pair adds
//     its float32 dQ tile into dq_acc (one 64 x D tile for each (b * Hq +
//     h, q tile), 134 MB at Llama's shape) in ascending kv-tile order: kv
//     tile kt waits until the ticket of (b * Hq + h, q tile) reads kt
//     (thread 0 polls it with ld.acquire.gpu, then the block's barrier),
//     adds through L2, and releases kt + 1 (the block's barrier, then
//     thread 0's st.release.gpu, whose gpu-scope fence publishes the
//     block's adds, as CUTLASS's semaphores do). A dq_acc tile is laid out
//     in the order of the dQ accumulator's fragments, so each warp's float4
//     access is 512 contiguous bytes (in [B, S, Hq, D] order it was eight
//     rows of 32 bytes, eight L1 wavefronts an access); every read is
//     issued before any write (.cg accesses keep program order), at D <= 64
//     before the products, so that the L2 round trip runs under them. kv
//     tile 0 stores without reading, so dq_acc needs no zeroing; the last
//     contributor (kv tile 64 qt / 128 when causal, else the last kv tile)
//     rounds the row to bf16 and writes dq. Under GQA a query head's dq has
//     one kv head's tiles as its only contributors, so MHA (K2a) and GQA
//     (K2b) are the same body: K2a equals K2b bit for bit. A block only
//     waits on items claimed before its own, which are running or done, so
//     there is no deadlock in any launch order; a wait past ~17 s of cycles
//     traps instead of hanging the card.
//   * No float atomics: two calls give bitwise the same dq, dk and dv.
//   * Registers (ptxas, nvcc 12.9): 255 / 182 / 140 / 124 at D = 128 / 64 / 32
//     / 16, no spills. At D = 128 dK and dV take 2 x 64 floats a thread for
//     the whole sweep, a half's S^T and dP^T 16 each until packed, the 32 P^T
//     and dS^T fragments live until the products retire, then dQ's 32; the
//     loop derives its shared addresses from an opaque copy of the base so
//     that no wgmma descriptor is hoisted out of it, and reads dq_acc after
//     the products. Shared memory at D = 128: k and v 64 KB, the dS^T tile 16
//     KB, two stages of q and dO 64 KB, lse and delta 1 KB: one block an SM.
//     bwd_phases.py (repository root) builds a copy with FLASH_BWD_PHASES and
//     reports where a pair's cycles go.
//
// K3b and K3a, the split pair (two launches; the reference's A/B route):
//
//   * K3b (dk, dv) is the fused kernel's body without dQ:
//     flash_bwd_fused_kernel<D, false>. The same sweep, S^T / dP^T on wgmma,
//     P^T / dS^T by half_terms and dV += P^T dO, dK += dS^T Q from registers;
//     no dS^T tile, no dQ product, no dq_acc and no tickets (a block's item
//     is its blockIdx, numbered as the fused kernel numbers its items). Its
//     dk and dv are the fused kernel's bit for bit on the same inputs. The
//     wrapper lays lse (times log2(e)) and delta out [B, Hq, S_pad] as for
//     the fused kernel.
//   * K3a (dq) is K1's geometry: flash_bwd_dq_kernel<D>, one block per
//     (128-row q tile, b * Hq + h), the longest causal rows first, two
//     warpgroups of 64 query rows. The q and dO tiles are loaded once (TMA,
//     boxes of 128 rows by min(D, 64) columns), each thread reads its two
//     rows' lse and delta ([B, S, Hq]) once, and the 128-row k and v tiles
//     go through a two-stage ring under "full" / "empty" mbarriers, as in
//     K1; query head h reads kv head h / group through the maps' head
//     coordinate. Each kv tile is taken in two halves of 64 kv columns (so
//     that S, dP and dQ fit in registers at D = 128): S = Q K^T and
//     dP = dO V^T on wgmma.m64n64k16 (both operands K-major), then on the
//     accumulator P = exp2(s * scale * log2(e) - lse * log2(e)) and
//     dS = P (dP' - delta) scale (dP' = keep dP / (1 - p) under dropout),
//     the causal mask and the ragged ends on the edge tiles only (dq_terms),
//     dS packed to bf16 A fragments, and dQ += dS K with B the k tile
//     MN-major through the transpose bit, one instruction per column block
//     (K1's P V). dq stays in registers over the sweep, in kv order, and is
//     rounded to bf16 once: no partials, no float atomics.
//   * Registers (ptxas, nvcc 12.9), no spills: K3a 190 / 150 / 126 / 114,
//     K3b 224 / 158 / 124 / 101 at D = 128 / 64 / 32 / 16.
//
// Plain C interface (bound with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_dropout.cuh"
#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------- the fused kernel (K2a, K2b) and K3b

constexpr int KV_ROWS = 128;             // kv rows per work item, 64 a warpgroup
constexpr int Q_ROWS = 64;               // query rows per (q tile, member) pair
constexpr int FUSED_THREADS = 256;       // two consumer warpgroups
constexpr int STAGES = 2;                // the q / dO / lse / delta ring (K3a: the k / v ring)
constexpr int STATS_BYTES = 2 * Q_ROWS * 4;   // a pair's lse and delta
constexpr float LOG2E = 1.4426950408889634f;
// a ticket wait is one predecessor's pair at most (microseconds); ~17 s of
// cycles means a lost ticket, and the kernel traps instead of spinning on
constexpr long long TICKET_TIMEOUT = 1LL << 35;
// long longs a work item in the optional `clocks` buffer: the cycles thread
// 0 spent in each of PHASES phases of its pairs (built with
// FLASH_BWD_PHASES only: bwd_phases.py), then the item's cycles, then
// thread 0's cycles waiting for tickets
constexpr int PHASES = 8;
constexpr int CLOCKS = PHASES + 2;

// The shared memory of one fused block, from a 1024-byte aligned base: the
// k tile, the v tile, the dS^T tile [128 kv rows x 64 q columns] (rows of
// 128 bytes), per stage the q tile and the dO tile, per stage the pair's
// lse and delta, then the mbarriers: k / v's, one "full" a stage. A tile of
// D columns is CHUNKS blocks of [rows x ROW_BYTES]; CHUNK = D / 2 (each
// warpgroup's half of dQ's columns is one block of the k tile) but at
// D = 16, whose 8-column half would be a 16-byte row no swizzle takes.
template <int D>
struct Fused {
  static constexpr bool SPLIT_DQ = D >= 32;   // each warpgroup forms half of dQ
  static constexpr int CHUNK = SPLIT_DQ ? D / 2 : D;
  static constexpr int ROW_BYTES = CHUNK * 2;              // the swizzle width
  static constexpr int CHUNKS = D / CHUNK;
  static constexpr int LAYOUT = hopper::layout_for(ROW_BYTES);
  static constexpr int K_STEPS = CHUNK / 16;               // k16 steps in one block
  static constexpr int DQ_N = CHUNK;                       // dQ columns a warpgroup forms
  // read dq_acc before the products (at D = 128 its 32 registers would spill)
  static constexpr bool EARLY_READ = D <= 64;
  static constexpr uint32_t Q_CHUNK = Q_ROWS * ROW_BYTES;
  static constexpr uint32_t KV_CHUNK = KV_ROWS * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = Q_CHUNK * CHUNKS;    // one of q, dO
  static constexpr uint32_t KV_BYTES = KV_CHUNK * CHUNKS;  // one of k, v
  static constexpr uint32_t V_OFF = KV_BYTES;
  static constexpr uint32_t DS_OFF = 2 * KV_BYTES;
  static constexpr uint32_t STAGE_OFF = DS_OFF + KV_ROWS * Q_ROWS * 2;   // stage s at + 2 s Q_BYTES
  static constexpr uint32_t STATS_OFF = STAGE_OFF + STAGES * 2 * Q_BYTES;  // stage s at + s STATS_BYTES
  static constexpr uint32_t BAR_OFF = STATS_OFF + STAGES * STATS_BYTES;   // k / v's barrier
  static constexpr uint32_t FULL_OFF = BAR_OFF + 8;                      // stage s at + 8 s
  static constexpr size_t BYTES = 1024 + FULL_OFF + 8 * STAGES;
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static_assert(Q_CHUNK % 1024 == 0 && KV_CHUNK % 1024 == 0, "1024-byte aligned tiles");
};

__device__ __forceinline__ int load_acquire(const int* flag) {
  int value;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(value) : "l"(flag) : "memory");
  return value;
}

__device__ __forceinline__ void store_release(int* flag, int value) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;\n" : : "l"(flag), "r"(value) : "memory");
}

// pair i's q and dO tiles (TMA) and its lse * log2(e) and delta (bulk
// copies of [B, Hq, S_pad] rows) into stage i % STAGES
template <int D>
__device__ __forceinline__ void load_pair(const CUtensorMap* tq, const CUtensorMap* tdo,
                                          const float* lse, const float* delta, uint32_t base,
                                          int i, int q_tiles, int group, int hk, int b, int Hq,
                                          int s_pad) {
  using T = Fused<D>;
  const int stage = i % STAGES;
  const int qt = q_tiles - 1 - i / group;
  const int h = hk * group + i % group;
  const uint32_t bar = base + T::FULL_OFF + 8 * stage;
  const uint32_t q_s = base + T::STAGE_OFF + stage * 2 * T::Q_BYTES;
  const uint32_t stats = base + T::STATS_OFF + stage * STATS_BYTES;
  const size_t row = (static_cast<size_t>(b) * Hq + h) * s_pad + qt * Q_ROWS;
  hopper::mbarrier_expect_tx(bar, 2 * T::Q_BYTES + STATS_BYTES);
#pragma unroll
  for (int c = 0; c < T::CHUNKS; ++c) {
    hopper::tma_load_4d(q_s + c * T::Q_CHUNK, tq, bar, c * T::CHUNK, h, qt * Q_ROWS, b);
    hopper::tma_load_4d(q_s + T::Q_BYTES + c * T::Q_CHUNK, tdo, bar, c * T::CHUNK, h,
                        qt * Q_ROWS, b);
  }
  hopper::bulk_load(stats, lse + row, STATS_BYTES / 2, bar);
  hopper::bulk_load(stats + STATS_BYTES / 2, delta + row, STATS_BYTES / 2, bar);
}

// One half (32 query columns) of a pair's P^T and dS^T, from the S^T and
// dP^T accumulators [64 kv x 32 q] of a warpgroup: element 4 j + 2 r + e is
// kv row krow + 8 r and query column q0 + 32 half + 8 j + 2 quad + e. Packed
// in pairs they are the A fragments of dV and dK (k16 slice s: frag[4 s ..
// 4 s + 3]); dS^T also goes to the shared tile for dQ, row ds_row + 8 r,
// 16-byte chunk 4 half + j swizzled by the row's bits 0-2 as the 128-byte
// TMA swizzle (WITH_DQ only: K3b forms no dQ). EDGE applies the causal
// mask and the ragged end, DROP the keep hash; without them the code has no
// branch.
struct HalfTerms {
  const float* s_acc;
  const float* dp_acc;
  const float* stats;                     // the stage's lse * log2(e) [64], delta [64]
  uint32_t* p_frag;
  uint32_t* ds_frag;
  unsigned char* ds_tile;
  int half, q0, krow, ds_row, quad, S;
  float scale, scale_log2;
  uint32_t head_row;                      // dropout's row, b * Hq + h
};

// 2^x on the SFU, results under 2^-126 flushed to zero (a P that small is
// below every sum it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool EDGE, bool DROP, bool WITH_DQ>
__device__ __forceinline__ void half_terms(const HalfTerms& t, int causal, const Dropout& drop) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 32 * t.half + 8 * j + 2 * t.quad;
    const float2 lse2 = *reinterpret_cast<const float2*>(t.stats + col);
    const float2 delta2 = *reinterpret_cast<const float2*>(t.stats + Q_ROWS + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float kept[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int at = 4 * j + 2 * r + e;
        const int qrow = t.q0 + col + e;
        const int kcol = t.krow + 8 * r;
        float p = exp2_ftz(fmaf(t.s_acc[at], t.scale_log2, -(e ? lse2.y : lse2.x)));
        if (EDGE && !(qrow < t.S && kcol < t.S && (!causal || kcol <= qrow))) p = 0.0f;
        float d_kept = t.dp_acc[at];
        kept[e] = p;
        if (DROP) {
          const float keep = keep_element(qrow, kcol, t.head_row, drop) ? 1.0f : 0.0f;
          kept[e] = p * keep / drop.keep;
          d_kept = keep * d_kept / drop.keep;
        }
        ds[e] = p * (d_kept - (e ? delta2.y : delta2.x)) * t.scale;
      }
      const int frag = 2 * (4 * t.half + j) + r;
      t.p_frag[frag] = hopper::pack_bf16(kept[0], kept[1]);
      t.ds_frag[frag] = hopper::pack_bf16(ds[0], ds[1]);
      if constexpr (WITH_DQ) {
        const int row = t.ds_row + 8 * r;
        *reinterpret_cast<uint32_t*>(t.ds_tile + row * 128 +
                                     ((((4 * t.half + j) ^ (row & 7)) << 4) | (4 * t.quad))) =
            t.ds_frag[frag];
      }
    }
  }
}

// K2a and K2b (WITH_DQ), K3b (not): one block per work item (128-row kv tile,
// batch * kv head), taken from tickets[0] (K3b: its blockIdx, in the same
// order; dq, dq_acc and tickets unused); tickets[1 + (b * Hq + h) * q_tiles +
// qt] is the next kv tile whose dS K may enter dq_acc's q tile qt of head row
// b * Hq + h. lse (times log2(e)) and delta are [B, Hq, s_pad]; dq_acc holds
// a float32 tile of 64 x D for each (b * Hq + h, q tile), in the order of the
// dQ accumulator's fragments: float4 m of thread u of a warpgroup whose dQ
// columns start at block w at ((w + m) * 128 + u) * 4, so that a warp's
// float4 access is 512 contiguous bytes. With `clocks` (else NULL) thread 0
// records its item's cycles and its ticket waits (CLOCKS a work item).
template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dq_acc,
                       int* __restrict__ tickets, long long* __restrict__ clocks, int B, int S,
                       int Hq, int Hkv, float scale, int causal, Dropout drop) {
  using T = Fused<D>;
  extern __shared__ unsigned char smem[];
  __shared__ int claimed;
  __shared__ long long started, waited;     // thread 0's cycles (kept out of registers)
#ifdef FLASH_BWD_PHASES
  // thread 0's cycles by phase: 0 issuing the next pair's loads, 1 waiting
  // for this pair's, 2 S^T and dP^T, 3 P^T and dS^T, 4 the ticket and its
  // barrier, 5 dV, dK and dQ, 6 the dq adds, 7 the closing barrier and the
  // release
  __shared__ long long phase[PHASES], mark;
#define PHASE(n)                                   \
  if (tid == 0) {                                  \
    const long long now = clock64();               \
    phase[n] += now - mark;                        \
    mark = now;                                    \
  }
#else
#define PHASE(n)
#endif
  const uint32_t base = (hopper::smem_address(smem) + 1023) & ~1023u;
  unsigned char* const tiles = smem + (base - hopper::smem_address(smem));
  const uint32_t bar_kv = base + T::BAR_OFF;

  const int tid = threadIdx.x;
  const int wg = tid / 128;                 // warpgroup: kv rows 64 wg ..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;                // columns 2 quad, 2 quad + 1 of an n8 chunk
  const int row_in = 16 * warp + lane / 4;  // accumulator rows row_in, row_in + 8

  if (tid == 0) {
    started = clock64();
    waited = 0;
#ifdef FLASH_BWD_PHASES
    for (int n = 0; n < PHASES; ++n) phase[n] = 0;
    mark = started;
#endif
    if constexpr (WITH_DQ) claimed = atomicAdd(tickets, 1);
    else claimed = static_cast<int>(blockIdx.x);
    hopper::mbarrier_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) hopper::mbarrier_init(base + T::FULL_OFF + 8 * s, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int item = claimed;
  const int kt = item / (B * Hkv);          // kv-tile-major: longest sweeps first
  const int b = (item % (B * Hkv)) / Hkv;
  const int hk = item % Hkv;
  const int group = Hq / Hkv;
  const int q_tiles = (S + Q_ROWS - 1) / Q_ROWS;
  const int kv_tiles = (S + KV_ROWS - 1) / KV_ROWS;
  const int s_pad = q_tiles * Q_ROWS;
  const int k0 = kt * KV_ROWS;
  const int pairs = (q_tiles - (causal ? 2 * kt : 0)) * group;
  // global kv position of this thread's accumulator rows row_in (+ 8)
  const int krow = k0 + 64 * wg + row_in;
  const float scale_log2 = scale * LOG2E;

  if (tid == 0) {
    hopper::mbarrier_expect_tx(bar_kv, 2 * T::KV_BYTES);
#pragma unroll
    for (int c = 0; c < T::CHUNKS; ++c) {
      hopper::tma_load_4d(base + c * T::KV_CHUNK, &tk, bar_kv, c * T::CHUNK, hk, k0, b);
      hopper::tma_load_4d(base + T::V_OFF + c * T::KV_CHUNK, &tv, bar_kv, c * T::CHUNK, hk, k0,
                          b);
    }
    load_pair<D>(&tq, &tdo, lse, delta, base, 0, q_tiles, group, hk, b, Hq, s_pad);
  }

  float dk_acc[D / 2], dv_acc[D / 2];       // D / 8 n8 chunks of 4
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  // the first column of this warpgroup's dQ columns, and where its float4s
  // lie in a dq_acc tile (below)
  const int dq_col = (T::SPLIT_DQ ? wg : 0) * T::DQ_N + 2 * quad;
  const int dq_block = (T::SPLIT_DQ ? wg : 0) * (T::DQ_N / 8);
  const bool adds = T::SPLIT_DQ || wg == 0;    // at D = 16 one warpgroup adds dQ
  hopper::mbarrier_wait(bar_kv, 0);

  for (int i = 0; i < pairs; ++i) {
    const int stage = i % STAGES;
    const int qt = q_tiles - 1 - i / group;
    const int h = hk * group + i % group;
    const int q0 = qt * Q_ROWS;
    // pair i + 1 goes where pair i - 1 was: every thread left it at that
    // pair's closing barrier
    if (tid == 0 && i + 1 < pairs)
      load_pair<D>(&tq, &tdo, lse, delta, base, i + 1, q_tiles, group, hk, b, Hq, s_pad);
    PHASE(0)
    hopper::mbarrier_wait(base + T::FULL_OFF + 8 * stage, (i / STAGES) & 1);
    PHASE(1)
    // this warpgroup's 64 rows of k and v (block c, k16 step i at + c
    // KV_CHUNK + 32 i), the dS^T tile, the k block of this warpgroup's dQ
    // columns, and the stage's q and dO tiles. At D = 128 they derive from
    // an opaque copy of the base, so that no wgmma descriptor is hoisted out
    // of the loop: the ~32 loop-invariant 64-bit descriptors would take
    // registers dK and dV need (it spilled).
    uint32_t pair_base = base;
    if (D == 128) asm volatile("" : "+r"(pair_base));
    const uint32_t k_wg = pair_base + 64 * wg * T::ROW_BYTES;
    const uint32_t v_wg = pair_base + T::V_OFF + 64 * wg * T::ROW_BYTES;
    const uint32_t ds_s = pair_base + T::DS_OFF;
    const uint32_t k_dq = pair_base + (T::SPLIT_DQ ? wg : 0) * T::KV_CHUNK;
    const uint32_t q_s = pair_base + T::STAGE_OFF + stage * 2 * T::Q_BYTES;
    const uint32_t do_s = q_s + T::Q_BYTES;
    const float* stats = reinterpret_cast<const float*>(tiles + T::STATS_OFF +
                                                        stage * STATS_BYTES);
    const bool edge = (causal && qt <= 2 * kt + 1) || q0 + Q_ROWS > S || k0 + KV_ROWS > S;
    const uint32_t head_row = static_cast<uint32_t>(b) * Hq + h;   // dropout's row

    // P^T and dS^T in two halves of 32 query columns (fewer live registers):
    // S^T = K Q^T and dP^T = V dO^T [64 kv x 32 q] on wgmma, then
    // half_terms on the accumulators
    uint32_t p_frag[16], ds_frag[16];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s_acc[16], dp_acc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) s_acc[j] = dp_acc[j] = 0.0f;
      hopper::fence_registers<16>(s_acc);
      hopper::fence_registers<16>(dp_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c) {
#pragma unroll
        for (int step = 0; step < T::K_STEPS; ++step) {
          const uint32_t at = c * T::KV_CHUNK + 32 * step;
          const uint32_t bt = c * T::Q_CHUNK + 32 * half * T::ROW_BYTES + 32 * step;
          hopper::wgmma_ss_m64n32k16<0, 0>(
              s_acc, hopper::smem_descriptor(k_wg + at, 16, 8 * T::ROW_BYTES, T::LAYOUT),
              hopper::smem_descriptor(q_s + bt, 16, 8 * T::ROW_BYTES, T::LAYOUT),
              c + step > 0);
          hopper::wgmma_ss_m64n32k16<0, 0>(
              dp_acc, hopper::smem_descriptor(v_wg + at, 16, 8 * T::ROW_BYTES, T::LAYOUT),
              hopper::smem_descriptor(do_s + bt, 16, 8 * T::ROW_BYTES, T::LAYOUT),
              c + step > 0);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_registers<16>(s_acc);
      hopper::fence_registers<16>(dp_acc);
      PHASE(2)

      const HalfTerms terms = {s_acc, dp_acc, stats, p_frag, ds_frag, tiles + T::DS_OFF,
                               half, q0, krow, 64 * wg + row_in, quad, S, scale, scale_log2,
                               head_row};
      // the modes are uniform, so each instantiation is straight-line code
      if (drop.on) {
        if (edge) half_terms<true, true, WITH_DQ>(terms, causal, drop);
        else half_terms<false, true, WITH_DQ>(terms, causal, drop);
      } else {
        if (edge) half_terms<true, false, WITH_DQ>(terms, causal, drop);
        else half_terms<false, false, WITH_DQ>(terms, causal, drop);
      }
      PHASE(3)
    }
    if constexpr (WITH_DQ) hopper::fence_proxy_async();

    // kv tile kt's turn on (head row, q tile qt): the tiles before it have
    // added. Polled with no wgmma in flight. (K3b from here on: dV and dK
    // only, then the closing barrier.)
    int* ticket = tickets + 1 + static_cast<size_t>(head_row) * q_tiles + qt;
    const bool last = kt == (causal ? qt / 2 : kv_tiles - 1);
    if constexpr (WITH_DQ) {
      if (tid == 0 && kt > 0) {
        const long long polled = clock64();
        while (load_acquire(ticket) != kt) {
          __nanosleep(32);
          if (clock64() - polled > TICKET_TIMEOUT) __trap();   // fail, never hang the card
        }
        waited += clock64() - polled;
      }
      __syncthreads();                      // dS^T is whole in shared memory; the ticket is ours
    }
    PHASE(4)

    // this pair's dq_acc tile, read under the products below where the
    // registers allow (the ticket is ours); kv tile 0 stores without reading,
    // the last one writes dq
    const bool first = kt == 0;
    float4* const acc_tile = reinterpret_cast<float4*>(
        dq_acc + (static_cast<size_t>(head_row) * q_tiles + qt) * Q_ROWS * D);
    float4 sum[T::DQ_N / 8];
    const auto read_acc = [&] {
#pragma unroll
      for (int m = 0; m < T::DQ_N / 8; ++m)
        sum[m] = first || !adds ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                : __ldcg(acc_tile + (dq_block + m) * 128 + tid % 128);
    };
    if constexpr (WITH_DQ && T::EARLY_READ) read_acc();

    // dV += P^T dO and dK += dS^T Q: B the dO / q tile MN-major, its rows
    // 16 s .. at 16 s ROW_BYTES in each column block. dQ[64 q x DQ_N] = dS K
    // over the 128 kv rows: A = dS read MN-major from the dS^T tile (k16
    // step s: kv rows 16 s ..), B = this warpgroup's block of the k tile,
    // MN-major (at D = 16 both warpgroups form the same dQ; one adds it).
    float dq_part[T::DQ_N / 2];
#pragma unroll
    for (int j = 0; j < T::DQ_N / 2; ++j) dq_part[j] = 0.0f;
    hopper::fence_registers<D / 2>(dv_acc);
    hopper::fence_registers<D / 2>(dk_acc);
    if constexpr (WITH_DQ) hopper::fence_registers<T::DQ_N / 2>(dq_part);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < T::CHUNKS; ++c) {
#pragma unroll
      for (int s = 0; s < Q_ROWS / 16; ++s) {
        const uint32_t bt = c * T::Q_CHUNK + 16 * s * T::ROW_BYTES;
        hopper::wgmma_rs<T::CHUNK>(
            dv_acc + c * T::CHUNK / 2, p_frag + 4 * s,
            hopper::smem_descriptor(do_s + bt, T::Q_CHUNK, 8 * T::ROW_BYTES, T::LAYOUT), 1);
        hopper::wgmma_rs<T::CHUNK>(
            dk_acc + c * T::CHUNK / 2, ds_frag + 4 * s,
            hopper::smem_descriptor(q_s + bt, T::Q_CHUNK, 8 * T::ROW_BYTES, T::LAYOUT), 1);
      }
    }
    if constexpr (WITH_DQ) {
#pragma unroll
      for (int s = 0; s < KV_ROWS / 16; ++s) {
        hopper::wgmma_ss<T::DQ_N, 1, 1>(
            dq_part, hopper::smem_descriptor(ds_s + 16 * s * 128, 128 * KV_ROWS, 1024, 1),
            hopper::smem_descriptor(k_dq + 16 * s * T::ROW_BYTES, T::KV_CHUNK,
                                    8 * T::ROW_BYTES, T::LAYOUT),
            s > 0);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_registers<D / 2>(dv_acc);
    hopper::fence_registers<D / 2>(dk_acc);
    hopper::fence_fragments<16>(p_frag);
    hopper::fence_fragments<16>(ds_frag);
    if constexpr (WITH_DQ) hopper::fence_registers<T::DQ_N / 2>(dq_part);
    if constexpr (WITH_DQ && !T::EARLY_READ) read_acc();
    PHASE(5)

    // dq_acc (+)= dQ through L2, or dq = round(dq_acc + dQ) by the last
    if constexpr (WITH_DQ) {
      if (adds) {
#pragma unroll
        for (int m = 0; m < T::DQ_N / 8; ++m) {
          sum[m] = make_float4(sum[m].x + dq_part[4 * m], sum[m].y + dq_part[4 * m + 1],
                               sum[m].z + dq_part[4 * m + 2], sum[m].w + dq_part[4 * m + 3]);
          if (!last) __stcg(acc_tile + (dq_block + m) * 128 + tid % 128, sum[m]);
        }
        if (last) {
          // element 4 m + 2 r + e is query row q0 + row_in + 8 r, column
          // dq_col + 8 m + e
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q0 + row_in + 8 * r;
            if (row >= S) continue;
            bf16* const out = dq + ((static_cast<size_t>(b) * S + row) * Hq + h) * D + dq_col;
#pragma unroll
            for (int m = 0; m < T::DQ_N / 8; ++m)
              *reinterpret_cast<__nv_bfloat162*>(out + 8 * m) = __floats2bfloat162_rn(
                  r ? sum[m].z : sum[m].x, r ? sum[m].w : sum[m].y);
          }
        }
      }
    }
    PHASE(6)
    // every add is issued; the stage and dS^T are free. Thread 0's release
    // at gpu scope, after the block's barrier, publishes the block's adds
    // (as CUTLASS's semaphores do): no fence in every thread
    __syncthreads();
    if constexpr (WITH_DQ) {
      if (tid == 0 && !last) store_release(ticket, kt + 1);
    }
    PHASE(7)
  }

  // dK, dV rows krow, krow + 8 (below S), rounded to bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + 8 * r;
    if (row >= S) continue;
    const size_t at = ((static_cast<size_t>(b) * S + row) * Hkv + hk) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
  if (clocks != nullptr && tid == 0) {
#ifdef FLASH_BWD_PHASES
    for (int n = 0; n < PHASES; ++n) clocks[CLOCKS * item + n] = phase[n];
#endif
    clocks[CLOCKS * item + PHASES] = clock64() - started;
    clocks[CLOCKS * item + PHASES + 1] = waited;
  }
}

// ----------------------------------------------------------------- K3a

constexpr int DQ_ROWS = 128;             // query rows per block, 64 a warpgroup
constexpr int DQ_KV_ROWS = 128;          // kv rows per ring tile, two halves of 64
constexpr int DQ_THREADS = 256;          // two warpgroups

// The shared memory of one K3a block, from a 1024-byte aligned base: the q
// tile, the dO tile, per stage the k tile and the v tile, then the
// mbarriers: q / dO's, one "full" a stage (the TMA's bytes landed), one
// "empty" a stage (all eight warps are done reading it). A tile of D
// columns is CHUNKS blocks of [rows x ROW_BYTES], as K1's.
template <int D>
struct DqTiles {
  static constexpr int CHUNK = D < 64 ? D : 64;       // columns a TMA box holds
  static constexpr int ROW_BYTES = CHUNK * 2;          // the swizzle width
  static constexpr int CHUNKS = D / CHUNK;
  static constexpr int LAYOUT = hopper::layout_for(ROW_BYTES);
  static constexpr int K_STEPS = CHUNK / 16;           // k16 steps in one block
  static constexpr uint32_t Q_CHUNK = DQ_ROWS * ROW_BYTES;
  static constexpr uint32_t KV_CHUNK = DQ_KV_ROWS * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = Q_CHUNK * CHUNKS;     // one of q, dO
  static constexpr uint32_t KV_BYTES = KV_CHUNK * CHUNKS;   // one of k, v
  static constexpr uint32_t DO_OFF = Q_BYTES;
  static constexpr uint32_t KV_OFF = 2 * Q_BYTES;           // stage s at + 2 s KV_BYTES
  static constexpr uint32_t BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
  static constexpr uint32_t FULL_OFF = BAR_OFF + 8;          // stage s at + 8 s
  static constexpr uint32_t EMPTY_OFF = FULL_OFF + 8 * STAGES;
  static constexpr size_t BYTES = 1024 + EMPTY_OFF + 8 * STAGES;
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static_assert(Q_CHUNK % 1024 == 0 && KV_CHUNK % 1024 == 0, "1024-byte aligned tiles");
};

// kv tile `tile`'s k and v (TMA) into stage `stage`
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t base, int stage, int tile, int hk, int b) {
  using T = DqTiles<D>;
  const uint32_t bar = base + T::FULL_OFF + 8 * stage;
  const uint32_t k_s = base + T::KV_OFF + stage * 2 * T::KV_BYTES;
  hopper::mbarrier_expect_tx(bar, 2 * T::KV_BYTES);
#pragma unroll
  for (int c = 0; c < T::CHUNKS; ++c) {
    hopper::tma_load_4d(k_s + c * T::KV_CHUNK, tk, bar, c * T::CHUNK, hk, tile * DQ_KV_ROWS, b);
    hopper::tma_load_4d(k_s + T::KV_BYTES + c * T::KV_CHUNK, tv, bar, c * T::CHUNK, hk,
                        tile * DQ_KV_ROWS, b);
  }
}

// One half (64 kv columns) of a kv tile's dS for K3a, from the S and dP
// accumulators [64 q x 64 kv] of a warpgroup: element 4 j + 2 r + e is query
// row rows[r] and kv column kcol + 8 j + e. Packed in pairs they are the A
// fragments of dQ += dS K (k16 slice s: frag[4 s .. 4 s + 3]). EDGE applies
// the causal mask and the ragged ends, DROP the keep hash.
struct DqTerms {
  const float* s_acc;
  const float* dp_acc;
  uint32_t* ds_frag;
  float lse_log2[2], delta[2];             // the rows' lse * log2(e) and delta
  int rows[2];
  int kcol, S;
  float scale, scale_log2;
  uint32_t head_row;                       // dropout's row, b * Hq + h
};

template <bool EDGE, bool DROP>
__device__ __forceinline__ void dq_terms(const DqTerms& t, int causal, const Dropout& drop) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int at = 4 * j + 2 * r + e;
        const int kcol = t.kcol + 8 * j + e;
        float p = exp2_ftz(fmaf(t.s_acc[at], t.scale_log2, -t.lse_log2[r]));
        if (EDGE && !(t.rows[r] < t.S && kcol < t.S && (!causal || kcol <= t.rows[r])))
          p = 0.0f;
        float d_kept = t.dp_acc[at];
        if (DROP) {
          const float keep = keep_element(t.rows[r], kcol, t.head_row, drop) ? 1.0f : 0.0f;
          d_kept = keep * d_kept / drop.keep;
        }
        ds[e] = p * (d_kept - t.delta[r]) * t.scale;
      }
      t.ds_frag[2 * j + r] = hopper::pack_bf16(ds[0], ds[1]);
    }
  }
}

// K3a: one block per (128-row q tile, b * Hq + h); grid (B * Hq, q tiles),
// the last q tile first. lse and delta [B, S, Hq].
template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int S, int Hq,
                    int Hkv, float scale, int causal, Dropout drop) {
  using T = DqTiles<D>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (hopper::smem_address(smem) + 1023) & ~1023u;
  const uint32_t bar_q = base + T::BAR_OFF;

  const int tid = threadIdx.x;
  const int wg = tid / 128;                 // warpgroup: query rows 64 wg ..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;                // columns 2 quad, 2 quad + 1 of an n8 chunk
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const uint32_t head_row = static_cast<uint32_t>(b) * Hq + h;   // dropout's row
  const int hk = h / (Hq / Hkv);
  const int tiles = gridDim.y;
  const int qt = tiles - 1 - blockIdx.y;    // the longest causal rows first
  const int last = causal ? qt : tiles - 1; // the last visible kv tile
  const int q0 = qt * DQ_ROWS;
  // this thread's two query rows (global positions)
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;

  if (tid == 0) {
    hopper::mbarrier_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbarrier_init(base + T::FULL_OFF + 8 * s, 1);
      hopper::mbarrier_init(base + T::EMPTY_OFF + 8 * s, DQ_THREADS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbarrier_expect_tx(bar_q, 2 * T::Q_BYTES);
#pragma unroll
    for (int c = 0; c < T::CHUNKS; ++c) {
      hopper::tma_load_4d(base + c * T::Q_CHUNK, &tq, bar_q, c * T::CHUNK, h, q0, b);
      hopper::tma_load_4d(base + T::DO_OFF + c * T::Q_CHUNK, &tdo, bar_q, c * T::CHUNK, h, q0,
                          b);
    }
    load_kv<D>(&tk, &tv, base, 0, 0, hk, b);
  }

  // this thread's rows' lse * log2(e) and delta, read once (0 past S)
  float lse_log2[2], delta_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const size_t at = (static_cast<size_t>(b) * S + row) * Hq + h;
    lse_log2[r] = row < S ? lse[at] * LOG2E : 0.0f;
    delta_row[r] = row < S ? delta[at] : 0.0f;
  }

  float dq_acc[D / 2];                      // D / 8 n8 chunks of 4
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.0f;
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
    // this warpgroup's 64 rows of q and dO (block c, k16 step i at + c
    // Q_CHUNK + 32 i) and the stage's k and v tiles. At D = 128 they derive
    // from an opaque copy of the base, so that no wgmma descriptor is
    // hoisted out of the loop (as in the fused kernel).
    uint32_t tile_base = base;
    if (D == 128) asm volatile("" : "+r"(tile_base));
    const uint32_t q_wg = tile_base + 64 * wg * T::ROW_BYTES;
    const uint32_t do_wg = tile_base + T::DO_OFF + 64 * wg * T::ROW_BYTES;
    const uint32_t k_s = tile_base + T::KV_OFF + stage * 2 * T::KV_BYTES;
    const uint32_t v_s = k_s + T::KV_BYTES;
    const bool edge = (causal && j == qt) || (j + 1) * DQ_KV_ROWS > S || q0 + DQ_ROWS > S;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // S = Q K^T and dP = dO V^T over kv rows 64 half .. of the tile
      float s_acc[32], dp_acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s_acc[i] = dp_acc[i] = 0.0f;
      hopper::fence_registers<32>(s_acc);
      hopper::fence_registers<32>(dp_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c) {
#pragma unroll
        for (int step = 0; step < T::K_STEPS; ++step) {
          const uint32_t at = c * T::Q_CHUNK + 32 * step;
          const uint32_t bt = c * T::KV_CHUNK + 64 * half * T::ROW_BYTES + 32 * step;
          hopper::wgmma_ss<64, 0, 0>(
              s_acc, hopper::smem_descriptor(q_wg + at, 16, 8 * T::ROW_BYTES, T::LAYOUT),
              hopper::smem_descriptor(k_s + bt, 16, 8 * T::ROW_BYTES, T::LAYOUT), c + step > 0);
          hopper::wgmma_ss<64, 0, 0>(
              dp_acc, hopper::smem_descriptor(do_wg + at, 16, 8 * T::ROW_BYTES, T::LAYOUT),
              hopper::smem_descriptor(v_s + bt, 16, 8 * T::ROW_BYTES, T::LAYOUT), c + step > 0);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_registers<32>(s_acc);
      hopper::fence_registers<32>(dp_acc);

      uint32_t ds_frag[16];
      const DqTerms terms = {s_acc, dp_acc, ds_frag, {lse_log2[0], lse_log2[1]},
                             {delta_row[0], delta_row[1]}, {row0, row0 + 8},
                             j * DQ_KV_ROWS + 64 * half + 2 * quad, S, scale, scale * LOG2E,
                             head_row};
      // the modes are uniform, so each instantiation is straight-line code
      if (drop.on) {
        if (edge) dq_terms<true, true>(terms, causal, drop);
        else dq_terms<false, true>(terms, causal, drop);
      } else {
        if (edge) dq_terms<true, false>(terms, causal, drop);
        else dq_terms<false, false>(terms, causal, drop);
      }

      // dQ += dS K: k16 slice i of dS is ds_frag[4 i ..], kv rows 64 half
      // + 16 i .. of the k tile, MN-major, at (64 half + 16 i) ROW_BYTES in
      // each column block
      hopper::fence_registers<D / 2>(dq_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint64_t bk = hopper::smem_descriptor(
              k_s + c * T::KV_CHUNK + (64 * half + 16 * i) * T::ROW_BYTES, T::KV_CHUNK,
              8 * T::ROW_BYTES, T::LAYOUT);
          hopper::wgmma_rs<T::CHUNK>(dq_acc + c * T::CHUNK / 2, ds_frag + 4 * i, bk, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_registers<D / 2>(dq_acc);
      hopper::fence_fragments<16>(ds_frag);
    }
    __syncwarp();                           // this warp is done with the stage
    if (lane == 0) hopper::mbarrier_arrive(base + T::EMPTY_OFF + 8 * stage);
  }

  // dq rows row0, row0 + 8 (below S), rounded to bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* const out = dq + ((static_cast<size_t>(b) * S + row) * Hq + h) * D + 2 * quad;
#pragma unroll
    for (int chunk = 0; chunk < D / 8; ++chunk)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * chunk) =
          __floats2bfloat162_rn(dq_acc[4 * chunk + 2 * r], dq_acc[4 * chunk + 2 * r + 1]);
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int S, int Hq, int Hkv, float scale,
              int causal, const Dropout& drop, cudaStream_t stream) {
  using T = DqTiles<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (cudaError_t err = hopper::encode_bshd(&tq, q, B, S, Hq, D, DQ_ROWS, T::CHUNK))
    return static_cast<int>(err);
  if (cudaError_t err = hopper::encode_bshd(&tdo, dout, B, S, Hq, D, DQ_ROWS, T::CHUNK))
    return static_cast<int>(err);
  if (cudaError_t err = hopper::encode_bshd(&tk, k, B, S, Hkv, D, DQ_KV_ROWS, T::CHUNK))
    return static_cast<int>(err);
  if (cudaError_t err = hopper::encode_bshd(&tv, v, B, S, Hkv, D, DQ_KV_ROWS, T::CHUNK))
    return static_cast<int>(err);
  auto kernel = flash_bwd_dq_kernel<D>;
  if (const int err = prepare(kernel, T::BYTES)) return err;
  const dim3 grid(B * Hq, (S + DQ_ROWS - 1) / DQ_ROWS);
  kernel<<<grid, DQ_THREADS, T::BYTES, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), S, Hq, Hkv, scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool WITH_DQ>
int launch_fused(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, void* dk, void* dv, void* dq_acc,
                 void* tickets, void* clocks, int B, int S, int Hq, int Hkv, float scale,
                 int causal, const Dropout& drop, cudaStream_t stream) {
  using T = Fused<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (cudaError_t err = hopper::encode_bshd(&tq, q, B, S, Hq, D, Q_ROWS, T::CHUNK))
    return static_cast<int>(err);
  if (cudaError_t err = hopper::encode_bshd(&tdo, dout, B, S, Hq, D, Q_ROWS, T::CHUNK))
    return static_cast<int>(err);
  if (cudaError_t err = hopper::encode_bshd(&tk, k, B, S, Hkv, D, KV_ROWS, T::CHUNK))
    return static_cast<int>(err);
  if (cudaError_t err = hopper::encode_bshd(&tv, v, B, S, Hkv, D, KV_ROWS, T::CHUNK))
    return static_cast<int>(err);
  auto kernel = flash_bwd_fused_kernel<D, WITH_DQ>;
  if (const int err = prepare(kernel, T::BYTES)) return err;
  const unsigned items = static_cast<unsigned>((S + KV_ROWS - 1) / KV_ROWS) * B * Hkv;
  kernel<<<items, FUSED_THREADS, T::BYTES, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dq_acc), static_cast<int*>(tickets), static_cast<long long*>(clocks),
      B, S, Hq, Hkv, scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int B, int S, int Hq, int Hkv) {
  return B >= 1 && S >= 1 && Hkv >= 1 && Hq % Hkv == 0 && B * Hq <= 65535;
}

bool aligned(const void* const* pointers, int count) {
  for (int i = 0; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(pointers[i]) % 16 != 0) return false;
  return true;
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

// Ints of the zeroed ticket buffer the fused kernels need: the item counter
// and one ticket per (batch * query head, 64-row q tile).
size_t flash_bwd_tickets(int B, int S, int Hq) {
  return 1 + static_cast<size_t>(B) * Hq * ((S + Q_ROWS - 1) / Q_ROWS);
}

// Rows of the [B, Hq, S_pad] lse and delta the fused kernels read: S
// rounded up to a 64-row q tile.
int flash_bwd_padded_rows(int S) { return (S + Q_ROWS - 1) / Q_ROWS * Q_ROWS; }

// Long longs a work item of the fused kernels' optional clocks buffer.
int flash_bwd_clocks() { return CLOCKS; }

// K2a and K2b (K2a is its multi-head case, Hq = Hkv, which the wrapper
// checks): q, dout [B, S, Hq, D]; k, v [B, S, Hkv, D] bf16 (contiguous, 16-byte
// aligned); lse * log2(e) and delta [B, Hq, S_pad] float32
// (flash_bwd_padded_rows); dq like q, dk and dv like k; dq_acc B * Hq *
// S_pad * D floats (no zeroing needed); tickets (flash_bwd_tickets(...) ints) zeroed by the caller;
// clocks NULL, or flash_bwd_clocks() long longs a work item (thread 0's
// cycles by phase, the item's cycles, its ticket waits). D in {16, 32, 64,
// 128}. dropout NULL or off for none (as in every entry point below).
int flash_bwd_fused_bf16(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         void* dq_acc, void* tickets, void* clocks, int B, int S, int Hq,
                         int Hkv, int D, float scale, int causal, const Dropout* dropout,
                         void* stream) {
  const void* const tensors[6] = {q, k, v, dout, lse, delta};
  if (!valid(B, S, Hq, Hkv) || !aligned(tensors, 6))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = dropout_or_off(dropout);
  return by_head_dim(D, [&](auto dim) {
    return launch_fused<decltype(dim)::value, true>(q, k, v, dout, lse, delta, dq, dk, dv,
                                                    dq_acc, tickets, clocks, B, S, Hq, Hkv,
                                                    scale, causal, drop, s);
  });
}

// K3b: dk and dv of the fused kernel, bit for bit, without dq. The
// arguments as flash_bwd_fused_bf16's: lse * log2(e) and delta [B, Hq,
// S_pad] float32.
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                       int Hq, int Hkv, int D, float scale, int causal, const Dropout* dropout,
                       void* stream) {
  const void* const tensors[6] = {q, k, v, dout, lse, delta};
  if (!valid(B, S, Hq, Hkv) || !aligned(tensors, 6))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = dropout_or_off(dropout);
  return by_head_dim(D, [&](auto dim) {
    return launch_fused<decltype(dim)::value, false>(q, k, v, dout, lse, delta, nullptr, dk, dv,
                                                     nullptr, nullptr, nullptr, B, S, Hq, Hkv,
                                                     scale, causal, drop, s);
  });
}

// K3a: q, dout [B, S, Hq, D]; k, v [B, S, Hkv, D] bf16 (contiguous, 16-byte
// aligned); lse and delta [B, S, Hq] float32; dq like q.
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int S, int Hq,
                      int Hkv, int D, float scale, int causal, const Dropout* dropout,
                      void* stream) {
  const void* const tensors[4] = {q, k, v, dout};
  if (!valid(B, S, Hq, Hkv) || !aligned(tensors, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = dropout_or_off(dropout);
  return by_head_dim(D, [&](auto dim) {
    return launch_dq<decltype(dim)::value>(q, k, v, dout, lse, delta, dq, B, S, Hq, Hkv,
                                           scale, causal, drop, s);
  });
}

}  // extern "C"
