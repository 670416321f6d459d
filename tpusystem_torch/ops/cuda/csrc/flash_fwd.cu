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
//     (four threads per query row), k and v stream through shared memory in
//     64-row tiles, and the [64, 64] score tile never leaves the SM: O(seq)
//     memory, like the TPU kernel. The tiles live in dynamic shared memory
//     (FwdLayout): at head dim 128 they take 49,664 bytes, over the 48 KB a
//     block may declare statically.
//   * Head dims up to 64: each of a row's four threads holds the whole query
//     row and computes 16 of the tile's 64 scores. At head dim 128 the row
//     would take 128 registers a thread, beside the accumulator and the
//     scores, so there the row is split (SPLIT): each thread holds a quarter
//     of it (the interleaved pairs sub, sub + 4, ...), takes its part of all
//     64 dot products, 16 columns at a time, and the row's four threads
//     reduce-scatter the partial sums with two rounds of shuffles, so each
//     ends with the same 16 full scores as the unsplit kernel. Its output
//     dims are 8-wide chunks sub, sub + 4, ... so the four threads' 16-byte
//     reads of a v row hit distinct shared-memory banks.
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
constexpr unsigned FULL = 0xffffffffu;

// The dynamic shared memory of one block: the k tile (rows padded by one
// bf16 pair, so the four threads of a row read distinct banks), the v tile
// and the rounded probabilities (rows padded by one float). Every offset is
// a multiple of 16 bytes.
template <int D>
struct FwdLayout {
  static constexpr int KP = D + 2;
  static constexpr size_t k_bytes = TILE * KP * sizeof(__nv_bfloat16);
  static constexpr size_t v_bytes = TILE * D * sizeof(__nv_bfloat16);
  static constexpr size_t p_bytes = TILE * (TILE + 1) * sizeof(float);
  static constexpr size_t bytes = k_bytes + v_bytes + p_bytes;
  static_assert(k_bytes % 16 == 0 && v_bytes % 16 == 0, "16-byte offsets");
};

// SPLIT kernels hold a quarter of the query row a thread (head dim > 64)
template <int D>
constexpr bool kSplitRow = D > 64;

// the head dim of this thread's d-th accumulator: a contiguous quarter of
// the row, or with SPLIT the 8-wide chunks sub, sub + 4, ...
template <int D>
__device__ __forceinline__ int out_dim(int sub, int d) {
  if constexpr (kSplitRow<D>)
    return ((d / 8) * PER_ROW + sub) * 8 + d % 8;
  else
    return sub * (D / PER_ROW) + d;
}

// SPLIT: the scores of columns sub + 4 j (j = 0..15) of one k tile, from
// this thread's pairs sub + 4 i of the query row. Each group of 16 columns
// is summed over the row's four threads by a reduce-scatter: the xor-2
// partner takes the columns whose bit 1 differs from sub's, then the xor-1
// partner those whose bit 0 does.
template <int D>
__device__ __forceinline__ void split_scores(const float* qv, const __nv_bfloat16* k_s,
                                             int sub, float* s) {
  constexpr int KP = FwdLayout<D>::KP;
  constexpr int PAIRS = D / 2 / PER_ROW;    // query pairs a thread holds
  const bool hi = sub & 2;
  const bool odd = sub & 1;
#pragma unroll
  for (int g = 0; g < COLS / PER_ROW; ++g) {
    float part[16];
#pragma unroll
    for (int cc = 0; cc < 16; ++cc) {
      const __nv_bfloat162* krow2 =
          reinterpret_cast<const __nv_bfloat162*>(k_s + (16 * g + cc) * KP);
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const float2 kk = __bfloat1622float2(krow2[sub + PER_ROW * i]);
        dot = fmaf(qv[2 * i], kk.x, dot);
        dot = fmaf(qv[2 * i + 1], kk.y, dot);
      }
      part[cc] = dot;
    }
    float half[8];                          // columns cc with bit 1 == hi
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int low = (i >> 1) * 4 + (i & 1);
      const float keep = hi ? part[low | 2] : part[low];
      const float send = hi ? part[low] : part[low | 2];
      half[i] = keep + __shfl_xor_sync(FULL, send, 2);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {           // column 16 g + 4 j + sub
      const float keep = odd ? half[2 * j + 1] : half[2 * j];
      const float send = odd ? half[2 * j] : half[2 * j + 1];
      s[4 * g + j] = keep + __shfl_xor_sync(FULL, send, 1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int S, int Hq, int Hkv, float scale, int causal,
                 Dropout drop) {
  static_assert(D % 32 == 0 || D == 16, "head_dim must be 16 or a multiple of 32");
  constexpr bool SPLIT = kSplitRow<D>;
  constexpr int KP = FwdLayout<D>::KP;
  constexpr int DPT = D / PER_ROW;          // output dims per thread
  constexpr int QV = SPLIT ? D / PER_ROW : D;   // query values per thread
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + FwdLayout<D>::k_bytes);
  float* p_s =
      reinterpret_cast<float*>(smem + FwdLayout<D>::k_bytes + FwdLayout<D>::v_bytes);

  const int tid = threadIdx.x;
  const int row = tid / PER_ROW;            // query row inside the tile
  const int sub = tid % PER_ROW;            // lane bits 0-1
  const int qt = blockIdx.x;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int qrow = qt * TILE + row;
  const bool live = qrow < S;

  float qv[QV];
  if (live) {
    const __nv_bfloat16* src = q + (static_cast<size_t>(b) * S + qrow) * Hq * D +
                               static_cast<size_t>(h) * D;
    if constexpr (SPLIT) {
      const __nv_bfloat162* src2 = reinterpret_cast<const __nv_bfloat162*>(src);
#pragma unroll
      for (int i = 0; i < QV / 2; ++i) {
        const float2 f = __bfloat1622float2(src2[sub + PER_ROW * i]);
        qv[2 * i] = f.x;
        qv[2 * i + 1] = f.y;
      }
    } else {
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
    }
  } else {
#pragma unroll
    for (int d = 0; d < QV; ++d) qv[d] = 0.0f;
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
    if constexpr (SPLIT) {
      split_scores<D>(qv, k_s, sub, s);
    } else {
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
        s[j] = dot;
      }
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int kcol = kt * TILE + sub + PER_ROW * j;
      s[j] *= scale;
      if (kcol >= S || (causal && kcol > qrow)) s[j] = NEG_INF;
    }

    // online softmax over this tile (the row's four threads agree)
    float tile_max = s[0];
#pragma unroll
    for (int j = 1; j < COLS; ++j) tile_max = fmaxf(tile_max, s[j]);
    tile_max = fmaxf(tile_max, __shfl_xor_sync(FULL, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(FULL, tile_max, 2));
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
    tile_sum += __shfl_xor_sync(FULL, tile_sum, 1);
    tile_sum += __shfl_xor_sync(FULL, tile_sum, 2);
    l = correction * l + tile_sum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= correction;
    __syncthreads();

    for (int c = 0; c < TILE; ++c) {
      const float p = p_s[row * (TILE + 1) + c];
      if constexpr (SPLIT) {
#pragma unroll
        for (int t = 0; t < DPT / 8; ++t) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(v_s + c * D + out_dim<D>(sub, 8 * t));
          const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(pairs[i]);
            acc[8 * t + 2 * i] = fmaf(p, f.x, acc[8 * t + 2 * i]);
            acc[8 * t + 2 * i + 1] = fmaf(p, f.y, acc[8 * t + 2 * i + 1]);
          }
        }
      } else {
        const __nv_bfloat16* vrow = v_s + c * D + sub * DPT;
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, __bfloat162float(vrow[d]), acc[d]);
      }
    }
    __syncthreads();
  }

  if (!live) return;
  const float safe_l = (l == 0.0f) ? 1.0f : l;
  const size_t base = (static_cast<size_t>(b) * S + qrow) * Hq + h;
  __nv_bfloat16* dst = o + base * D;
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    float value = acc[d] / safe_l;
    if (drop.on) value = value / drop.keep;        // inverted-dropout scaling
    dst[out_dim<D>(sub, d)] = __float2bfloat16(value);
  }
  if (sub == 0) lse[base] = m + logf(safe_l);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
           int Hq, int Hkv, float scale, int causal, const Dropout& drop, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  constexpr size_t bytes = FwdLayout<D>::bytes;
  if (const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)))
    return static_cast<int>(err);
  const dim3 grid((S + TILE - 1) / TILE, B * Hq);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, Hq, Hkv, scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, S, Hq, D], k and v [B, S, Hkv, D] bf16 (contiguous); o like q;
// lse [B, S, Hq] float32. D in {16, 32, 64, 128}; Hq a multiple of Hkv. dropout
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
    case 128: return launch<128>(q, k, v, o, lse, B, S, Hq, Hkv, scale, causal, drop, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
