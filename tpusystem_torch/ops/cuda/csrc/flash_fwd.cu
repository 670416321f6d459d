// Causal flash-attention forward for Hopper (sm_90a), bf16 in and out,
// float32 logsumexp.
//
// Replaces the Pallas TPU kernel tpusystem/ops/pallas/flash.py:
// _flash_fwd_kernel (reached through _flash_fwd, flash_attention and
// flash_attention_lse) -- K1, with its attention-probability dropout.
//
// What bounds it on an H100: at the prefill shapes of GPT-2 125M (one
// sequence of 512 or 1024 tokens, 12 heads of 64) the causal work is
// ~1.6 GFLOP against ~6.3 MB of q, k, v, out and lse, so the tensor-core
// bound and the memory bound are both near 2 us. This first kernel does its
// products with scalar float32 FMAs, so it is bound by the SMs' FP32 rate,
// well above that: wgmma and TMA are the later step.
//
// What the design does:
//   * One block per (64-row query tile, batch * head). q stays in registers
//     (four threads per query row, each holding the row), k and v stream
//     through shared memory in 64-row tiles, and the [64, 64] score tile
//     never leaves the SM: O(seq) memory, like the TPU kernel.
//   * Causal: kv tiles strictly above the diagonal are skipped; the diagonal
//     tile and the ragged sequence end are masked to -1e30 (NEG_INF).
//   * Online softmax in float32, the TPU kernel's arithmetic: running max m,
//     sum l of the unrounded probabilities, the accumulator rescaled by
//     exp(m_prev - m_new); the probabilities are rounded to bf16 before the
//     product with v; out = acc / safe_l and lse = m + log(safe_l) with
//     safe_l = 1 where l == 0.
//   * GQA: query head h reads kv head h / (Hq / Hkv); grouped kv is never
//     broadcast.
//   * Tensors keep the public [B, S, H, D] layout; the kernel computes its own
//     strided offsets, so the wrapper transposes nothing.
//   * Dropout (flash.py:127-157): l sums the unmasked probabilities, the
//     kept ones (probs * keep, from flash_dropout.cuh's positional hash of
//     the query head's row b * Hq + h) are rounded to bf16 before the
//     product with v, out = acc / safe_l / (1 - p), and lse stays the full
//     denominator. At p = 0 none of it runs.
//
// Plain C interface (bound with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_dropout.cuh"

namespace {

constexpr int TILE = 64;          // query rows per block and kv rows per tile
constexpr int THREADS = 256;      // four threads per query row
constexpr int PER_ROW = THREADS / TILE;
constexpr int COLS = TILE / PER_ROW;   // score columns per thread
constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int S, int Hq, int Hkv, float scale, int causal,
                 Dropout drop) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int KP = D + 2;                 // padded k row: conflict-free reads
  constexpr int DPT = D / PER_ROW;          // output dims per thread
  __shared__ __align__(16) __nv_bfloat16 k_s[TILE * KP];
  __shared__ __align__(16) __nv_bfloat16 v_s[TILE * D];
  __shared__ float p_s[TILE * (TILE + 1)];

  const int tid = threadIdx.x;
  const int row = tid / PER_ROW;            // query row inside the tile
  const int sub = tid % PER_ROW;            // lane bits 0-1
  const int qt = blockIdx.x;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int qrow = qt * TILE + row;
  const bool live = qrow < S;

  float qv[D];
  if (live) {
    const __nv_bfloat16* src = q + (static_cast<size_t>(b) * S + qrow) * Hq * D +
                               static_cast<size_t>(h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
      const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(pairs[i]);
        qv[c * 8 + 2 * i] = f.x;
        qv[c * 8 + 2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qv[d] = 0.0f;
  }

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.0f;
  float m = NEG_INF;
  float l = 0.0f;

  const int tiles = (S + TILE - 1) / TILE;
  const int last = causal ? min(qt, tiles - 1) : tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    // stage the kv tile (zeros past the sequence end)
    for (int i = tid; i < TILE * (D / 8); i += THREADS) {
      const int r = i / (D / 8);
      const int c = i % (D / 8);
      const int krow = kt * TILE + r;
      uint4 kraw = make_uint4(0, 0, 0, 0);
      uint4 vraw = make_uint4(0, 0, 0, 0);
      if (krow < S) {
        const size_t off = (static_cast<size_t>(b) * S + krow) * Hkv * D +
                           static_cast<size_t>(hk) * D + c * 8;
        kraw = *reinterpret_cast<const uint4*>(k + off);
        vraw = *reinterpret_cast<const uint4*>(v + off);
      }
      uint32_t* kdst = reinterpret_cast<uint32_t*>(k_s + r * KP + c * 8);
      kdst[0] = kraw.x;
      kdst[1] = kraw.y;
      kdst[2] = kraw.z;
      kdst[3] = kraw.w;
      *reinterpret_cast<uint4*>(v_s + r * D + c * 8) = vraw;
    }
    __syncthreads();

    // scores for columns sub, sub + 4, ... of this row
    float s[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = sub + PER_ROW * j;
      const __nv_bfloat162* krow2 = reinterpret_cast<const __nv_bfloat162*>(k_s + col * KP);
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < D / 2; ++d) {
        const float2 kk = __bfloat1622float2(krow2[d]);
        dot = fmaf(qv[2 * d], kk.x, dot);
        dot = fmaf(qv[2 * d + 1], kk.y, dot);
      }
      dot *= scale;
      const int kcol = kt * TILE + col;
      if (kcol >= S || (causal && kcol > qrow)) dot = NEG_INF;
      s[j] = dot;
    }

    // online softmax over this tile (the row's four threads agree)
    float tile_max = s[0];
#pragma unroll
    for (int j = 1; j < COLS; ++j) tile_max = fmaxf(tile_max, s[j]);
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float correction = expf(m - m_new);
    float tile_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float p = expf(s[j] - m_new);
      tile_sum += p;
      const int col = sub + PER_ROW * j;
      // the denominator keeps every probability; dropout masks what meets v
      const float kept =
          drop.on && !keep_element(qrow, kt * TILE + col, blockIdx.y, drop) ? 0.0f : p;
      // probabilities meet v in v's dtype, as in the reference kernel
      p_s[row * (TILE + 1) + col] = __bfloat162float(__float2bfloat16(kept));
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    l = correction * l + tile_sum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= correction;
    __syncthreads();

    for (int c = 0; c < TILE; ++c) {
      const float p = p_s[row * (TILE + 1) + c];
      const __nv_bfloat16* vrow = v_s + c * D + sub * DPT;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, __bfloat162float(vrow[d]), acc[d]);
    }
    __syncthreads();
  }

  if (!live) return;
  const float safe_l = (l == 0.0f) ? 1.0f : l;
  const size_t base = (static_cast<size_t>(b) * S + qrow) * Hq + h;
  __nv_bfloat16* dst = o + base * D + sub * DPT;
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    float value = acc[d] / safe_l;
    if (drop.on) value = value / drop.keep;        // inverted-dropout scaling
    dst[d] = __float2bfloat16(value);
  }
  if (sub == 0) lse[base] = m + logf(safe_l);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
           int Hq, int Hkv, float scale, int causal, const Dropout& drop, cudaStream_t stream) {
  const dim3 grid((S + TILE - 1) / TILE, B * Hq);
  flash_fwd_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, Hq, Hkv, scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, S, Hq, D], k and v [B, S, Hkv, D] bf16 (contiguous); o like q;
// lse [B, S, Hq] float32. D in {16, 32, 64}; Hq a multiple of Hkv. dropout
// NULL or off for none.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int S, int Hq, int Hkv, int D, float scale, int causal,
                   const Dropout* dropout, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || B * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = dropout_or_off(dropout);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, B, S, Hq, Hkv, scale, causal, drop, s);
    case 32: return launch<32>(q, k, v, o, lse, B, S, Hq, Hkv, scale, causal, drop, s);
    case 64: return launch<64>(q, k, v, o, lse, B, S, Hq, Hkv, scale, causal, drop, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
