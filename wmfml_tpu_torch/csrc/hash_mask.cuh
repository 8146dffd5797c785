// The keyed-hash dropout masks of image data augmentation, as device
// functions: Sometimes(0.5) of OneOf(Dropout, CoarseDropout).
// csrc/image_da.cu includes them.
//
// Replaces wmfml_tpu/aug/image_aug.py:_fmix32, _hash_keep, dropout,
// coarse_dropout and one_of_dropout (:274-375). The JAX package draws no
// random mask: each element hashes its id (the pixel for Dropout; the cell
// of a (round(H sp), round(W sp)) grid for CoarseDropout) with the image's
// two key words through murmur3's finalizer twice, and keeps the element
// when the hash, read as a uniform in [0, 1), is at least the drop rate p.
// It is integer arithmetic and two float32 steps, so the masks equal the
// JAX package's bit for bit given the same key words, p and sp:
//   * the multiplies wrap mod 2^32 (uint32 arithmetic);
//   * the hash converts to float32 with round to nearest (__uint2float_rn);
//   * the grid size rounds half to even (rintf, as jnp.round does);
//   * floor(y hl / H) uses a true division and no FMA (the _rn intrinsics).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace da {

constexpr int ND = 5;          // gate, pick, p, sp, per_channel

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// _hash_keep: u(id) >= p for the key words (k0, k1).
__device__ __forceinline__ bool hash_keep(uint32_t k0, uint32_t k1,
                                          uint32_t id, float p) {
  uint32_t h = (id ^ k0) * 0x9E3779B9u + k1;
  h = fmix32(fmix32(h));
  return __fmul_rn(__uint2float_rn(h), 2.3283064365386963e-10f) >= p;
}

// CoarseDropout's grid size along an axis of n pixels: max(round(n sp), 1).
__device__ __forceinline__ float coarse_size(int n, float sp) {
  return fmaxf(rintf(__fmul_rn((float)n, sp)), 1.f);
}

// The grid cell of pixel i along that axis: floor(i nl / n).
__device__ __forceinline__ int coarse_cell(int i, float nl, int n) {
  return (int)floorf(__fdiv_rn(__fmul_rn((float)i, nl), (float)n));
}

}  // namespace da
