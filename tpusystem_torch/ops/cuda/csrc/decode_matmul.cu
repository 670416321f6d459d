// Decode-step weight-streaming kernels for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernels of tpusystem/ops/pallas/decode_matmul.py:
//   * decode_matmul_bf16  <- decode_matmul / _matmul_kernel   (K4)
//   * decode_ffn_bf16     <- decode_ffn / _ffn_kernel         (K5)
//
// What bounds them on an H100: bytes. A greedy decode step at batch <= 16
// multiplies a few-KB activation by every weight matrix once, so each weight
// byte is read once and used for at most 2 * 16 flops; that is far below the
// ~295 flop/byte the card needs before its tensor cores become the limit.
// The least time is the weight bytes over the 3.35 TB/s of HBM.
//
// What the design does about it:
//   * x ([B, K], a few KB) is staged once in shared memory; the weight is
//     streamed with 16-byte loads, four neighbouring threads covering one
//     64-byte row segment of a 32-column tile, 64 rows of the weight in
//     flight per block. Each weight element is read exactly once.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;                            // bf16 values per 16-byte load
constexpr int TILE_COLS = 32;                     // output columns per block
constexpr int COL_THREADS = TILE_COLS / VEC;      // threads covering one tile row
constexpr int K_GROUPS = THREADS / COL_THREADS;   // weight rows in flight per block

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True), torch's approximate='tanh'
  const float k0 = 0.7978845608028654f;           // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
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
template <int BT>
__device__ void tile_gemv(const __nv_bfloat16* x_s, const __nv_bfloat16* __restrict__ w,
                          int K, int N, int col0, float acc[BT][VEC]) {
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
    load8(w + static_cast<size_t>(k) * N + n0, wv);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float xv = __bfloat162float(x_s[b * K + k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[b][j] = fmaf(xv, wv[j], acc[b][j]);
    }
  }
}

// Sum the 64 row groups' partials in a fixed order into out_s [BT, TILE_COLS].
template <int BT>
__device__ void reduce_tile(float acc[BT][VEC], float* red, float* out_s) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = acc[b][j];
      // lane = group * COL_THREADS + ct: xor over the group bits
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
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

template <int BT, bool GELU>
__global__ void __launch_bounds__(THREADS)
decode_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                     int B, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(static_cast<size_t>(BT) * K * 2));
  float* out_s = red + WARPS * BT * TILE_COLS;

  stage_x<BT>(x, x_s, B, K);
  __syncthreads();
  const int col0 = blockIdx.x * TILE_COLS;
  float acc[BT][VEC];
  tile_gemv<BT>(x_s, w, K, N, col0, acc);
  reduce_tile<BT>(acc, red, out_s);
  for (int i = threadIdx.x; i < BT * TILE_COLS; i += THREADS) {
    const int b = i / TILE_COLS;
    const int n = col0 + i % TILE_COLS;
    if (b < B && n < N) {
      float v = out_s[i];
      if (bias != nullptr) v += bias[n];
      if (GELU) v = gelu_tanh(v);
      out[static_cast<size_t>(b) * N + n] = __float2bfloat16(v);
    }
  }
}

template <int BT>
__global__ void __launch_bounds__(THREADS)
decode_ffn_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                  float* __restrict__ partial, int B, int K, int H, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(static_cast<size_t>(BT) * K * 2));
  float* hid_s = red + WARPS * BT * TILE_COLS;

  stage_x<BT>(x, x_s, B, K);
  __syncthreads();
  const int col0 = blockIdx.x * TILE_COLS;          // this block's hidden slab
  {
    float acc[BT][VEC];
    tile_gemv<BT>(x_s, w1, K, H, col0, acc);
    reduce_tile<BT>(acc, red, hid_s);
  }
  for (int i = threadIdx.x; i < BT * TILE_COLS; i += THREADS) {
    const int h = col0 + i % TILE_COLS;
    const float v = (h < H) ? gelu_tanh(hid_s[i] + b1[h]) : 0.0f;
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
      load8(w2 + static_cast<size_t>(col0 + r) * N + n0, wv);
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

__global__ void __launch_bounds__(THREADS)
splits_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int splits, int B, int N) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B * N) return;
  float total = 0.0f;
  for (int s = 0; s < splits; ++s) total += partial[static_cast<size_t>(s) * B * N + i];
  if (bias != nullptr) total += bias[i % N];
  out[i] = __float2bfloat16(total);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int BT, bool GELU>
int launch_matmul(const void* x, const void* w, const void* bias, void* out, int B, int K,
                  int N, cudaStream_t stream) {
  const size_t smem = gemv_smem<BT>(K);
  auto kernel = decode_matmul_kernel<BT, GELU>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE_COLS - 1) / TILE_COLS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int BT>
int launch_ffn(const void* x, const void* w1, const void* b1, const void* w2, float* partial,
               int B, int K, int H, int N, cudaStream_t stream) {
  const size_t smem = gemv_smem<BT>(K);
  auto kernel = decode_ffn_kernel<BT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + TILE_COLS - 1) / TILE_COLS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2), partial, B, K, H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of x one launch takes; the Python wrapper splits larger batches.
int decode_max_rows() { return 16; }

// Float32 partial slabs decode_ffn_bf16 writes for a hidden width H.
int decode_ffn_splits(int H) { return (H + TILE_COLS - 1) / TILE_COLS; }

// out[B, N] = act(x[B, K] @ w[K, N] + bias[N]); bias may be null; act is
// tanh GELU when gelu != 0. bf16 in and out, float32 accumulation.
int decode_matmul_bf16(const void* x, const void* w, const void* bias, void* out, int B, int K,
                       int N, int gelu, void* stream) {
  if (B < 1 || B > 16 || N % VEC != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 4) {
    return gelu ? launch_matmul<4, true>(x, w, bias, out, B, K, N, s)
                : launch_matmul<4, false>(x, w, bias, out, B, K, N, s);
  }
  if (B <= 8) {
    return gelu ? launch_matmul<8, true>(x, w, bias, out, B, K, N, s)
                : launch_matmul<8, false>(x, w, bias, out, B, K, N, s);
  }
  return gelu ? launch_matmul<16, true>(x, w, bias, out, B, K, N, s)
              : launch_matmul<16, false>(x, w, bias, out, B, K, N, s);
}

// out[B, N] = gelu(x[B, K] @ w1[K, H] + b1[H]) @ w2[H, N] + b2[N], the hidden
// rounded to bf16 before the second product. partial is float32 scratch of
// decode_ffn_splits(H) * B * N values.
int decode_ffn_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, void* partial, void* out, int B, int K, int H, int N,
                    void* stream) {
  if (B < 1 || B > 16 || N % VEC != 0 || H % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(partial);
  int err;
  if (B <= 4) {
    err = launch_ffn<4>(x, w1, b1, w2, scratch, B, K, H, N, s);
  } else if (B <= 8) {
    err = launch_ffn<8>(x, w1, b1, w2, scratch, B, K, H, N, s);
  } else {
    err = launch_ffn<16>(x, w1, b1, w2, scratch, B, K, H, N, s);
  }
  if (err != 0) return err;
  const int total = B * N;
  splits_reduce_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      scratch, static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out),
      decode_ffn_splits(H), B, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
