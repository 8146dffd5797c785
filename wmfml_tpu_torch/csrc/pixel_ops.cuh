// The pixel ops of image data augmentation, as device functions: Pascal1D's
// GammaContrast and AverageBlur (each under its Sometimes gate), the
// decode of a drawn op order into its permutation, and the fixed 16-pixel
// grid of the fixed-order pipelines' CoarseDropout. csrc/image_da.cu
// includes them.
//
// Replaces wmfml_tpu/aug/image_aug.py:gamma_contrast (:211-216),
// average_blur (:243-257), jax.random.permutation's order of the five-op
// chain (:575) and coarse_dropout_fixed's grid (:356-368):
//   * gamma: clip(x, 1e-6, 1) ** g in float32 (powf, the accurate one: the
//     card's powf and the CPU's pow may differ in the last ulps, which the
//     tests' relative tolerance states), rounded by the caller's store;
//   * blur: k = 1 is the identity; k = 3 the 3 x 3 window of the edge-padded
//     image, k = 2 the pixel and its top and left neighbours (cv2.blur's
//     even-kernel anchor), summed in the JAX order (dy-major, from the first
//     term), each add rounded to the image's type (Round: bfloat16 sums round
//     at every add, as XLA's are computed), then divided by 9 or 4 (a true
//     division, __fdiv_rn);
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

// The k x k window's mean at (y, x) of the H x W image s (row-major), k 2
// or 3: both windows start one row and one column up-left of the pixel.
template <class Round>
__device__ __forceinline__ float blur_px(const float* s, int H, int W, int y,
                                         int x, int k, Round round) {
  float acc = 0.f;
  for (int dy = 0; dy < k; ++dy) {
    const int row = min(max(y + dy - 1, 0), H - 1) * W;
    for (int dx = 0; dx < k; ++dx) {
      const float t = s[row + min(max(x + dx - 1, 0), W - 1)];
      acc = (dy | dx) ? round(__fadd_rn(acc, t)) : t;
    }
  }
  return __fdiv_rn(acc, (float)(k * k));
}

// perm[0..n) = permutation number idx (0 <= idx < n!) in
// itertools.permutations order.
__host__ __device__ inline void decode_order(int idx, int n, int* perm) {
  int rest[8];
  int f = 1;
  for (int j = 0; j < n; ++j) rest[j] = j;
  for (int j = 2; j < n; ++j) f *= j;            // (n - 1)!
  for (int j = 0; j < n; ++j) {
    const int d = idx / f;
    idx -= d * f;
    perm[j] = rest[d];
    for (int r = d; r < n - 1 - j; ++r) rest[r] = rest[r + 1];
    if (n - 1 - j > 0) f /= n - 1 - j;
  }
}

// The fixed grid's cells along an axis of n pixels: max(n / 16, 1).
__host__ __device__ __forceinline__ int fixed_cells(int n) {
  return n / 16 > 1 ? n / 16 : 1;
}

}  // namespace da
