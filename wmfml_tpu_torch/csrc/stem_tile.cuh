// The literature stem's tile, shared by K1 (stem.cu, the forward) and K1b
// (stem_bwd.cu, its backward): the tiling, the phase-layout conv0 patch and
// the device function that fills it. K1b recomputes conv0 through
// conv0_patch, the forward's own function, so its ReLU mask is the
// forward's bit for bit.
//
// A tile is one image's 4 x 4 pool outputs = 8 x 8 conv1 outputs; conv1
// reads the tile's 17 x 17 conv0 positions (one halo row and column before
// it), which read a 35 x 35 window of the input. The patch keeps conv0's
// post-ReLU outputs channel-innermost in 2 x 2 phase layout
// [phase][PH][PH][stride]: conv0 local (ly, lx) sits in phase
// ((ly & 1) * 2 + (lx & 1)) at plane position (ly / 2, lx / 2), so a conv1
// tap (kh, kw) of output (py, px) reads phase (kh & 1, kw & 1) at (py +
// kh / 2, px + kw / 2).
#pragma once

#include <cuda_runtime.h>

#include "bf16_gmma.cuh"

namespace {

constexpr int C0 = 32;             // conv0 output channels
constexpr int C1 = 48;             // conv1 output channels
constexpr int TP = 4;              // pool outputs per tile side
constexpr int T1 = 2 * TP;         // conv1 outputs per tile side (8)
constexpr int T0 = 2 * T1 + 1;     // conv0 outputs per tile side (17)
constexpr int TX = 2 * T0 + 1;     // input pixels per tile side (35)
constexpr int PH = (T0 + 1) / 2;   // side of one conv0 phase plane (9)
constexpr int PS = C0 + 4;         // float32 patch position stride (floats)
constexpr int PATCH = 4 * PH * PH * PS;
constexpr int PSB = C0 + 8;        // bfloat16 patch position stride (values)
constexpr int PATCH_B = 4 * PH * PH * PSB;
constexpr int K1 = 9 * C0;         // conv1 depth (288)
constexpr int W1 = C1 * K1;        // conv1 weights (floats)

// conv0's output at one position and channel: the float32 sum (the bias
// already in it) through ReLU; bfloat16: the sum rounded, the bias add
// rounded, ReLU
__device__ inline float conv0_out(float a, float, float) {
  return fmaxf(a, 0.f);
}
__device__ inline float conv0_out(float a, float b, __nv_bfloat16) {
  return fmaxf(tc::bf16r(tc::bf16r(a) + b), 0.f);
}

// eight channels of a conv0 position into the patch
__device__ inline void store_patch8(float* p, const float (&a)[8]) {
  float4* dst = reinterpret_cast<float4*>(p);
  dst[0] = make_float4(a[0], a[1], a[2], a[3]);
  dst[1] = make_float4(a[4], a[5], a[6], a[7]);
}
__device__ inline void store_patch8(__nv_bfloat16* p, const float (&a)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(tc::pack_bf16(a[0], a[1]), tc::pack_bf16(a[2], a[3]),
                 tc::pack_bf16(a[4], a[5]), tc::pack_bf16(a[6], a[7]));
}

// conv0 + bias + ReLU over the tile's 17 x 17 patch from its input window
// xs [Ci][TX][TX] (first pixel at input (2 r0 - 1, 2 s0 - 1); r0, s0 the
// first conv0 row and column): item (position, group of 8 channels) for
// items t, t + nt, ...; the group cg = t & 3 is the thread's for every
// item (nt % 4 == 0). Positions outside the H0 x W0 map are conv1's zero
// padding. float32 starts the sum at the bias, bfloat16 adds it after
// rounding. kOne: one input channel, whose 72 weights of the thread's
// group the caller holds in w0r; else they are read from w0s [ci][tap][c]
// (16-byte aligned; the same values, summed in the same order).
template <class T, bool kOne>
__device__ __forceinline__ void conv0_patch(
    const float* xs, T* patch, const float* w0s, const float* b0s,
    const float (&w0r)[kOne ? 9 * 8 : 1], int Ci, int r0, int s0, int H0,
    int W0, int t, int nt) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int PST = kF32 ? PS : PSB;
  const int cg = t & 3;
  for (int item = t; item < T0 * T0 * 4; item += nt) {
    const int pos = item >> 2;
    const int ly = pos / T0, lx = pos % T0;
    const int gy = r0 + ly, gx = s0 + lx;
    float a[8];
    if (gy >= 0 && gy < H0 && gx >= 0 && gx < W0) {
#pragma unroll
      for (int c = 0; c < 8; ++c) a[c] = kF32 ? b0s[8 * cg + c] : 0.f;
      for (int ci = 0; ci < (kOne ? 1 : Ci); ++ci) {
        const float* xp = xs + (ci * TX + 2 * ly) * TX + 2 * lx;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const float v = xp[(k / 3) * TX + k % 3];
          float w[8];
          if constexpr (kOne) {
#pragma unroll
            for (int c = 0; c < 8; ++c) w[c] = w0r[8 * k + c];
          } else {      // two 16-byte loads
            const float4* wv = reinterpret_cast<const float4*>(
                w0s + (ci * 9 + k) * C0 + 8 * cg);
            const float4 lo = wv[0], hi = wv[1];
            w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
            w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) a[c] = fmaf(v, w[c], a[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) a[c] = conv0_out(a[c], b0s[8 * cg + c], T());
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) a[c] = 0.f;   // conv1's zero padding
    }
    store_patch8(patch + (((ly & 1) * 2 + (lx & 1)) * PH * PH + (ly >> 1) * PH +
                          (lx >> 1)) * PST + 8 * cg, a);
  }
}

}  // namespace
