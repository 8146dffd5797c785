// The warp stages of image data augmentation, as device functions: the
// scale/translate warps of CropAndPad and Affine (each under its Sometimes
// gate), their composition into one chain with constant fill, and a warp
// applied alone (_affine_warp: Pascal1D's chain, the fixed-order
// pipelines' geometric). csrc/image_da.cu includes them; an op list of
// another task adds its warp ops here as more stage bodies, not as kernels.
//
// Replaces wmfml_tpu/aug/image_aug.py:_interp_matrix, _stage_matrices and
// _warp_chain (:57-151). The JAX package builds per-image [H, H] and [W, W]
// tent matrices relu(1 - |src_i - j|) and mixes each image as My img Mx^T.
// On the card the matrices are sparse: a tent row has at most two nonzeros
// (one for nearest, one for a stage whose gate is off), so a row of two
// composed stages has at most four. A table entry holds them for one output
// row or column, with the coverages the fill needs:
//   r, the last stage's tent row sum;
//   p, for two stages, the first stage's coverage pushed through the second.
// The fill is _warp_chain's sum of rank-1 terms, in its order:
//   one stage:  c0 - c0 ry rx
//   two stages: c0 ry2 rx2 - c0 py px + c1 - c1 ry2 rx2;
// a warp alone fills as _affine_warp: c0 (1 - ry rx).
// A gate that is off makes a stage the identity with no fill, exactly.
//
// Nearest snapping decides which pixel a tap reads, so one ulp matters: the
// sample positions use the JAX package's float32 operations in its order,
// with a true division, and none contracted into an FMA (the _rn
// intrinsics).
#pragma once

#include <cuda_runtime.h>

namespace da {

constexpr int NP = 7;          // a stage: sx, sy, tx, ty, cval, nearest, gate
constexpr int MAX_TAPS = 4;    // two composed tent rows

struct Axis {
  int idx[MAX_TAPS];
  float w[MAX_TAPS];
  float r;                     // coverage of the last stage
  float p;                     // first stage's coverage through the second
};

// Taps a stage's tent row has at most: 1 when its gate is off or it snaps
// to the nearest pixel, else 2.
__device__ __forceinline__ int stage_taps(const float* st) {
  return (st[6] > 0.5f && !(st[5] > 0.5f)) ? 2 : 1;
}

// The sample position of output index i under one stage (_stage_matrices):
// (i - c - shift) / scale + c, floor(src + .5) for nearest, i itself when
// the gate is off. axis 0 = x (sx, tx), 1 = y (sy, ty).
__device__ __forceinline__ float stage_src(int i, float c, const float* st,
                                           int axis) {
  const float j = (float)i;
  if (!(st[6] > 0.5f)) return j;
  const float src = __fadd_rn(
      __fdiv_rn(__fsub_rn(__fsub_rn(j, c), st[2 + axis]), st[axis]), c);
  return st[5] > 0.5f ? floorf(__fadd_rn(src, 0.5f)) : src;
}

// The nonzeros of the tent row relu(1 - |src - j|), j in [0, n).
__device__ __forceinline__ int tent(float src, int n, int* idx, float* w) {
  const float f = floorf(src);
  int cnt = 0;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float j = __fadd_rn(f, (float)d);
    const float wt = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(src, j))));
    if (wt > 0.f && j >= 0.f && j < (float)n) {
      idx[cnt] = (int)j;
      w[cnt] = wt;
      ++cnt;
    }
  }
  return cnt;
}

// The taps of output index i along one axis after stage st0, then st1 when
// it is not null, padded to nt taps of weight 0 on a pixel in range (nt is
// at least the product of the stages' stage_taps).
__device__ void axis_entry(int i, int n, const float* st0, const float* st1,
                           int axis, int nt, Axis* e) {
  const float c = (float)(n - 1) * 0.5f;
  int idx2[2];
  float w2[2];
  const int n2 = tent(stage_src(i, c, st1 ? st1 : st0, axis), n, idx2, w2);
  float r = 0.f, p = 0.f;
  int cnt = 0;
  for (int a = 0; a < n2; ++a) {
    r = __fadd_rn(r, w2[a]);
    if (!st1) {
      e->idx[cnt] = idx2[a];
      e->w[cnt++] = w2[a];
      continue;
    }
    int idx1[2];
    float w1[2];
    const int n1 = tent(stage_src(idx2[a], c, st0, axis), n, idx1, w1);
    float r1 = 0.f;
    for (int q = 0; q < n1; ++q) {
      e->idx[cnt] = idx1[q];
      e->w[cnt++] = __fmul_rn(w2[a], w1[q]);
      r1 = __fadd_rn(r1, w1[q]);
    }
    p = __fadd_rn(p, __fmul_rn(w2[a], r1));
  }
  const int pad = cnt > 0 ? e->idx[0] : 0;
  for (; cnt < nt; ++cnt) {
    e->idx[cnt] = pad;
    e->w[cnt] = 0.f;
  }
  e->r = r;
  e->p = p;
}

// How a chain's fill is summed: _warp_chain's rank-1 terms of one stage or
// of two, or _affine_warp's cval (1 - ry rx) for a warp op applied alone
// (the Pascal1D chain and the fixed-order pipelines' geometric)
enum Fill { CHAIN_ONE = 0, CHAIN_TWO = 1, AFFINE = 2 };

// The fill of one output pixel from its row and column entries; c0 (and c1
// for two stages) the stages' cvals.
__device__ __forceinline__ float chain_fill(float ry, float py, float rx,
                                            float px, float c0, float c1,
                                            int form) {
  const float rr = __fmul_rn(ry, rx);
  if (form == AFFINE) return __fmul_rn(c0, __fsub_rn(1.f, rr));
  if (form == CHAIN_ONE) return __fadd_rn(c0, __fmul_rn(-c0, rr));
  float fill = __fmul_rn(c0, rr);
  fill = __fadd_rn(fill, __fmul_rn(-c0, __fmul_rn(py, px)));
  fill = __fadd_rn(fill, c1);
  return __fadd_rn(fill, __fmul_rn(-c1, rr));
}

}  // namespace da
