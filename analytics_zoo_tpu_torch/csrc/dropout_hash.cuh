// The fused attention kernels' dropout bits: murmur3_32 of the three words
// (bh, row, col) with the call's seed as its seed. The mask depends on
// nothing else, so every kernel and tiling draws the same mask, and the
// plain PyTorch version (`dropout_bits` in ops/attention.py) reproduces it
// bit for bit. An entry is kept where its bits are >= thresh =
// min(int(rate * 2^32), 2^32 - 1), the TPU kernel's rule.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t k) {
  k *= 0xcc9e2d51u;
  k = rotl32(k, 15);
  k *= 0x1b873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xe6546b64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// the row's key: mix(mix(seed, bh), row); an entry's bits:
// fmix(mix(row_key, col) ^ 12), 12 being the three words' length in bytes
__device__ __forceinline__ uint32_t row_key(uint32_t seed, uint32_t bh,
                                            uint32_t row) {
  return mix(mix(seed, bh), row);
}

__device__ __forceinline__ bool kept(uint32_t key, uint32_t col,
                                     uint32_t thresh) {
  return fmix(mix(key, col) ^ 12u) >= thresh;
}

}  // namespace
