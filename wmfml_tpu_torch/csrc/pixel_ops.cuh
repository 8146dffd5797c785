// The pixel ops of image data augmentation, as device functions: Pascal1D's
// GammaContrast and the rounding AverageBlur's sums take (each op under its
// Sometimes gate), the decode of a drawn op order into its permutation, and
// the fixed 16-pixel grid of the fixed-order pipelines' CoarseDropout.
// csrc/image_da.cu includes them.
//
// Replaces wmfml_tpu/aug/image_aug.py:gamma_contrast (:211-216),
// average_blur (:243-257), jax.random.permutation's order of the five-op
// chain (:575) and coarse_dropout_fixed's grid (:356-368):
//   * gamma: clip(x, 1e-6, 1) ** g in float32 (powf, the accurate one: the
//     card's powf and the CPU's pow may differ in the last ulps, which the
//     tests' relative tolerance states), rounded by the caller's store;
//   * blur (csrc/image_da.cu:blur_sum, on the rounding types here): k = 1
//     is the identity; k = 3 the 3 x 3 window of the edge-padded image, k =
//     2 the pixel and its top and left neighbours (cv2.blur's even-kernel
//     anchor), summed in the JAX order (dy-major, from the first term), each
//     add rounded to the image's type (Round: bfloat16 sums round at every
//     add, as XLA's are computed), then divided by 9 or 4 (a true division,
//     __fdiv_rn);
//   * the order: index i of itertools.permutations(range(n)) (Lehmer code,
//     most significant position first), so that a uniform index draws a
//     uniform permutation;
//   * the fixed grid: gh = max(H / 16, 1) rows and gw = max(W / 16, 1)
//     columns of cells of H / gh x W / gw pixels (jnp.repeat's
//     upsampling); the JAX package draws one Bernoulli(1 - p) bit a cell,
//     here a cell keeps its bit from the murmur3 hash of (key words, cell
//     id gy gw + gx), as CoarseDropout's cells do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace da {

constexpr int NX = 4;          // gamma gate, gamma, blur gate, k

struct RoundF32 {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};
struct RoundBF16 {
  __device__ __forceinline__ float operator()(float v) const {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float gamma_px(float x, float g) {
  return powf(fminf(fmaxf(x, 1e-6f), 1.f), g);
}

// perm[0..n) = permutation number idx (0 <= idx < n!, n <= 8) in
// itertools.permutations order: digit j picks the d-th of the items left,
// which a bit mask holds (no array in local memory).
__host__ __device__ inline void decode_order(int idx, int n, int* perm) {
  unsigned rest = (1u << n) - 1u;
  int f = 1;
  for (int j = 2; j < n; ++j) f *= j;            // (n - 1)!
  for (int j = 0; j < n; ++j) {
    const int d = idx / f;
    idx -= d * f;
    unsigned m = rest;
    for (int t = 0; t < d; ++t) m &= m - 1u;     // drop the d lowest items
    int item = 0;
    while (!((m >> item) & 1u)) ++item;
    perm[j] = item;
    rest &= ~(1u << item);
    if (n - 1 - j > 0) f /= n - 1 - j;
  }
}

// The fixed grid's cells along an axis of n pixels: max(n / 16, 1).
__host__ __device__ __forceinline__ int fixed_cells(int n) {
  return n / 16 > 1 ? n / 16 : 1;
}

}  // namespace da
