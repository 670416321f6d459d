// Threefry-2x32 dropout keep mask for Hopper (sm_90a).
//
// Not the port of a Pallas kernel: in the reference, flax's nn.Dropout draws
// jax.random.bernoulli(key, 1 - rate, shape), which XLA generates. This
// kernel computes the same bits as jax 0.9 with jax_threefry_partitionable:
// element i (flat, row-major) hashes the counter (i >> 32, i & 0xffffffff)
// under the key with the 20 rounds of Threefry-2x32, xors the two output
// words, takes their top 23 bits as a float32 uniform in [0, 1) and keeps
// the element when that uniform is below keep_prob (float32). The plain
// version is tpusystem_torch/ops/threefry.py's bernoulli, bit for bit.
//
// What bounds it on an H100: integer operations. Each element costs about
// 80 32-bit adds, shifts and xors and writes one byte, so the mask of a
// [16, 1024, 768] activation (12.6 M elements) is ~1 G integer operations
// against 12.6 MB of writes. The design keeps everything in registers (the
// key words and keep_prob are kernel arguments) and lets each thread walk a
// grid-stride loop, so nothing but the mask touches memory. Without the
// kernel, PyTorch would take ~170 elementwise launches over int64 tensors
// per mask.
//
// Plain C interface (bound with ctypes); the entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;        // 16 resident blocks per SM

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2,
                                       int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// jax/_src/prng.py _threefry2x32_lowering, unrolled.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

__global__ void __launch_bounds__(THREADS)
bernoulli_mask_kernel(uint32_t k0, uint32_t k1, float keep_prob, uint8_t* __restrict__ out,
                      long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += stride) {
    const uint32_t bits = threefry_bits(k0, k1, static_cast<uint32_t>(i >> 32),
                                        static_cast<uint32_t>(i));
    // jax.random.uniform: [1, 2) from the top 23 bits, less 1 (exact)
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    out[i] = u < keep_prob ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// out[n] (bool bytes) = uniform(key, n) < keep_prob, key = (k0, k1).
int threefry_bernoulli_mask(unsigned int k0, unsigned int k1, float keep_prob, void* out,
                            long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  bernoulli_mask_kernel<<<static_cast<int>(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      k0, k1, keep_prob, static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
