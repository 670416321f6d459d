// The flash kernels' attention-probability dropout: the positional keep hash
// of tpusystem/ops/pallas/flash.py:_keep_mask (flash.py:80-103), bit for bit.
//
// A keep bit is a function of the global (query position, key position),
// the query head's row b * Hq + h and the call's int32 seed, never of the
// tile, so the forward (K1) and every backward kernel (K2a, K2b, K3a, K3b)
// regenerate the same masks from their own sweeps, and the port's 64-wide
// tiles reproduce the reference's 1024-wide masks. All arithmetic is uint32
// and wraps, as the reference's jnp.uint32 does.

#pragma once

#include <stdint.h>

// One call's keep rule; `on` is 0 at p = 0, where no kernel reads the rest.
// `threshold` is round((1 - p) * 2**24), `keep` is float32(1 - p), as the
// reference computes them.
struct Dropout {
  int on;
  uint32_t threshold;
  uint32_t seed;
  float keep;
};

__device__ __forceinline__ bool keep_element(uint32_t row, uint32_t col, uint32_t head_row,
                                             const Dropout& drop) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x = x + drop.seed + head_row * 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (x >> 8) < drop.threshold;
}

// the host's view of an optional rule (NULL = no dropout)
inline Dropout dropout_or_off(const Dropout* drop) {
  if (drop != nullptr && drop->on) return *drop;
  Dropout off = {0, 1u << 24, 0u, 1.0f};
  return off;
}
