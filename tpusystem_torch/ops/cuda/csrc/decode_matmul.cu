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
// The least time is the weight bytes over the 3.35 TB/s of HBM.
//
// What the design does about it:
//   * x ([B, K], a few KB) is staged once in shared memory; the weight is
//     streamed with 16-byte loads (8 bf16 or 16 int8 / e4m3 values), the
//     threads that cover one row of a 32-column tile neighbours in a warp,
//     64 (bf16) or 128 (narrow) rows of the weight in flight per block.
//     Each weight element is read exactly once.
//   * int8 / e4m3 tiles are widened on chip, exactly (|int8| <= 127 and
//     every e4m3 value are bf16 values), so the products are the reference's
//     bf16 x widen(w) products. The per-output-channel scale factors out of
//     the sum: K4 multiplies the float32 sum once, before bias and
//     activation; K5 scales its hidden sums per channel before b1 and GELU,
//     and the proj output once in the epilogue, on the full sum of the
//     ordered second pass (not on each partial), before b2.
//   * Every block owns an independent column tile (the TPU grid walks the
//     tiles in order; here they run in parallel on the SMs). Partial sums of
//     the 64 row groups are reduced in a fixed order (warp shuffles, then a
//     shared-memory sum over the 8 warps), so results do not change between
//     runs.
//   * Accumulation is float32; bias and the activation are applied to the
//     float32 sum, which is rounded to bf16 once.
//   * K5: no Hopper block can carry an accumulator to the next one, so the
//     hidden dimension is split over blocks instead of walked by a grid.
//     Each block computes its [B, 32] hidden slab (fc product, bias, tanh
//     GELU) in shared memory, rounds it to bf16 as the reference does before
//     the second product, and multiplies it by its 32 rows of the proj weight
//     into a float32 partial [splits, B, N]. A second, deterministic pass sums
//     the partials in split order and applies the proj bias and the rounding.
//     The [B, 4 * dim] hidden activation never reaches HBM and no float
//     atomics are used.
//
// Plain C interface (bound with ctypes); every entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// scale: float32 [N] per output channel, or null (bf16 weights).
template <int BT, bool GELU, typename W>
__global__ void __launch_bounds__(THREADS)
decode_matmul_kernel(const __nv_bfloat16* __restrict__ x, const W* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int B, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(static_cast<size_t>(BT) * K * 2));
  float* out_s = red + WARPS * BT * TILE_COLS;

  stage_x<BT>(x, x_s, B, K);
  __syncthreads();
  const int col0 = blockIdx.x * TILE_COLS;
  float acc[BT][Weight<W>::VEC];
  tile_gemv<BT, W>(x_s, w, K, N, col0, acc);
  reduce_tile<BT, Weight<W>::VEC>(acc, red, out_s);
  for (int i = threadIdx.x; i < BT * TILE_COLS; i += THREADS) {
    const int b = i / TILE_COLS;
    const int n = col0 + i % TILE_COLS;
    if (b < B && n < N) {
      float v = out_s[i];
      if (scale != nullptr) v *= scale[n];
      if (bias != nullptr) v += bias[n];
      if (GELU) v = gelu_tanh(v);
      out[static_cast<size_t>(b) * N + n] = __float2bfloat16(v);
    }
  }
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

template <int BT, bool GELU, typename W>
int launch_matmul(const void* x, const void* w, const void* scale, const void* bias, void* out,
                  int B, int K, int N, cudaStream_t stream) {
  const size_t smem = gemv_smem<BT>(K);
  auto kernel = decode_matmul_kernel<BT, GELU, W>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE_COLS - 1) / TILE_COLS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const W*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), B, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int BT, typename W>
int launch_matmul_act(const void* x, const void* w, const void* scale, const void* bias,
                      void* out, int B, int K, int N, int gelu, cudaStream_t stream) {
  return gelu ? launch_matmul<BT, true, W>(x, w, scale, bias, out, B, K, N, stream)
              : launch_matmul<BT, false, W>(x, w, scale, bias, out, B, K, N, stream);
}

template <typename W>
int decode_matmul(const void* x, const void* w, const void* scale, const void* bias,
                  void* out, int B, int K, int N, int gelu, void* stream) {
  constexpr int VEC = Weight<W>::VEC;
  if (B < 1 || B > Weight<W>::MAX_ROWS || N % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 4) return launch_matmul_act<4, W>(x, w, scale, bias, out, B, K, N, gelu, s);
  if (B <= 8) return launch_matmul_act<8, W>(x, w, scale, bias, out, B, K, N, gelu, s);
  return launch_matmul_act<Weight<W>::MAX_ROWS, W>(x, w, scale, bias, out, B, K, N, gelu, s);
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
// tanh GELU when gelu != 0. bf16 in and out, float32 accumulation.
int decode_matmul_bf16(const void* x, const void* w, const void* bias, void* out, int B, int K,
                       int N, int gelu, void* stream) {
  return decode_matmul<__nv_bfloat16>(x, w, nullptr, bias, out, B, K, N, gelu, stream);
}

// The same with int8 / e4m3 w and its float32 scale[N]:
// out = act((x @ widen(w)) * scale + bias).
int decode_matmul_int8(const void* x, const void* w, const void* scale, const void* bias,
                       void* out, int B, int K, int N, int gelu, void* stream) {
  return decode_matmul<int8_t>(x, w, scale, bias, out, B, K, N, gelu, stream);
}

int decode_matmul_fp8(const void* x, const void* w, const void* scale, const void* bias,
                      void* out, int B, int K, int N, int gelu, void* stream) {
  return decode_matmul<__nv_fp8_e4m3>(x, w, scale, bias, out, B, K, N, gelu, stream);
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
