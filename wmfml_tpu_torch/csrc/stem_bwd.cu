// K1b: the literature stem's backward by the phase form (conv_bwd: phase),
// its products on Hopper's tensor cores. For the pooled map's gradient g
// [B, H/8, W/8, 48] of the fused stem (stem.cu: conv0 3x3 s2 p1 (Ci->32) +
// bias + ReLU, conv1 3x3 s2 p1 (32->48) + bias + ReLU, 2x2/s2 max pool;
// NHWC), the pool's routes that K1's forward wrote, and weights shared by
// the batch, it returns dW0 [32, Ci, 3, 3], db0 [32], dW1 [48, 32, 3, 3]
// and db1 [48] (torch OIHW), float32 or bfloat16 as the inputs.
//
// Replaces the backward of wmfml_tpu/nn/encoders.py:117 conv3x3_s2_phase
// (conv1's input gradient as one dense 2x2 stride-1 convolution over the
// padded output gradient, kernel [2, 2, Co, 4 Ci] assembled from W's taps,
// then depth-to-space, :140-177) together with the autodiff of the rest of
// the stem around it: the pool's and the ReLUs' masks, conv1's and conv0's
// weight and bias gradients. Its plain twin is kernels/stem.py:
// stem_backward_phase_plain, fed the same decisions (the route, conv0's
// mask), which it must equal up to float32 rounding.
//
// The phase form. Conv0 position r = 2i + a reads conv1 outputs p with
// r = 2p + kh - 1: parity a = 0 only tap kh = 1 of p = i; a = 1 taps kh = 2
// of p = i and kh = 0 of p = i + 1. So the (a, b) parity of conv1's input
// gradient sums 1, 2, 2 or 4 taps: 9 of the dense form's 16 [Co, Ci] blocks
// are real. The TPU multiplied the 7 zero blocks for its matrix unit's
// sake; this kernel reads only the real ones.
//
// Decisions. The pool's route (one byte a pooled value: the window position
// of the first maximum in raster order, or 4 where the pooled output is
// not positive) comes from K1's forward (stem.cu: pool_note, route_flush),
// so the gradient is routed by the forward's own decisions and K1b
// recomputes no conv1: the route holds both the pool's and conv1's ReLU
// decisions.
// conv0's ReLU mask comes from conv0_patch (stem_tile.cuh), the forward's
// own device function, so it is the forward's bit for bit.
//
// Bound (chip_smoke.py: stem_backward_bound, on the route it is given): at
// B = 300, H = W = 128 the function needs conv0 again (0.7 GFLOP, the
// patch dW1 reads and conv0's mask), and what the data routes: each pooled
// value routed to a positive maximum scatters into 9 taps x 32 channels of
// conv1's input gradient and adds 288 products to dW1 (about 2 GFLOP for
// half of them routed), and conv0's live values 9 Ci products each to dW0;
// against ~40 MB to move: bound by operations, about 0.013 ms in 3xTF32.
// What the design does about it: both of conv1's products run dense on the
// tensor cores (the routed zeros included, 17 GFLOP, ~3x 3xTF32 at 495
// TFLOP/s: 0.11 ms at best in float32, 0.018 ms in bfloat16), which costs
// a regular loop of wgmma and no indexing; the sparse sums that the bound
// counts would run on the CUDA cores at 67 TFLOP/s.
//
// Design: one kernel a call plus the reduce, the forward's tiling (a tile
// is one image's 4 x 4 pool outputs = 8 x 8 conv1 outputs, owning the 16 x
// 16 conv0 positions 16 ty .. 16 ty + 15), a persistent grid sized from
// the kernel's occupancy (one block an SM), each block one contiguous run
// of tiles and its partial weight gradients; no float atomics. A block's
// two warpgroups work on the same tile:
//   * all 256 threads stage the 35 x 35 x Ci input window (float32 by
//     cp.async), build G1, conv1's output gradient at the tile's 9 x 9
//     conv1 positions (its own 8 x 8 and the next tile's first row and
//     column), g where the route names the position, else 0 (also as dW1's
//     B operand at the own 64), from the routes and g of the 5 x 5 windows
//     it covers, loaded a tile ahead (g1_load: the loads of the next tile
//     fly while this one computes), add the tile's routed g into db1, and
//     recompute conv0 + ReLU over the 17 x 17 patch (conv0_patch);
//   * dW1 as D[(tap, ci), co] += P[positions, (tap, ci)]^T G1[positions,
//     co]: A from registers (the patch at each tap's reads; the rows are
//     (tap, ci), 288 of them in five m64 tiles, the last half zero), B =
//     G1 [48 co][64 positions] K-major, K = the tile's 64 conv1 positions;
//     wgmma m64n48k8 .tf32 (3xTF32) or m64n48k16 .bf16 into a fresh
//     accumulator each tile, added to the block's float32 sums in
//     registers (the tensor cores' own accumulation over a block's ~2,300
//     positions lost bits: dW1 1.5e-5 of its largest against float64,
//     over the check's limit); two m-tiles on warpgroup 0, three on
//     warpgroup 1;
//   * conv1's input gradient, parity by parity: a parity's 8 x 8 conv0
//     positions are the 64 rows, dX[64, 32] = sum over its 1, 2, 2 or 4
//     taps of G1[64, 48] W1_tap[48, 32]: A = G1 from registers, B = the
//     tap's weights [32 ci][48 co], staged once a block; wgmma m64n32k8
//     .tf32 (3xTF32) or m64n32k16 .bf16 (parities (0, 0), (1, 1) on
//     warpgroup 0, (0, 1), (1, 0) on warpgroup 1; every role compile-time,
//     so each accumulator is defined only between pipeline stages);
//   * conv0's mask from the patch (a post-ReLU value > 0), the gradient
//     into shared memory where G1 was, then dW0 and db0 on the CUDA cores
//     (a warp two conv0 rows, a lane a channel, the input window's taps
//     broadcast), the eight warps' partials added to the block's sums in
//     shared memory in warp order.
// Why one kernel: the routes are in device memory before the backward
// starts, so nothing a tile needs waits for another tile. Shared memory at
// Ci = 1 in float32: conv1's weights as dX's B (big | small) 110,592 B +
// G1 (A and B forms) 41,424 B (later conv0's gradient, then the warps'
// dW0 partials) + the patch 46,656 B + the window, conv0's weights and
// the block's dW0 sums 7,460 B = 206,132 B (227,744 at Ci = 4) of the
// 232,448 a block may have; bfloat16 about half.
// The reduce kernel sums each weight gradient element over the blocks'
// partials in block order, in float32, and rounds once to the output type:
// two calls give the same bits (a CUDA graph's replay = the loop, under
// deterministic algorithms).
//
// bfloat16: the rounding of the twin. conv0's float32 sums are rounded,
// the bias add rounds again, ReLU (the route was taken by K1 on the
// rounded conv1 values); conv1's input gradient is a float32 sum rounded
// to bfloat16 before the mask and conv0's weight gradient; every weight
// and bias gradient is a float32 sum rounded once at the end.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gmma.cuh"
#include "stem_tile.cuh"
#include "tf32_gmma.cuh"

namespace {

constexpr int THREADS = 256;       // two warpgroups, on one tile
constexpr int OWN = 2 * T1;        // conv0 positions a tile owns a side (16)
constexpr int GR = T1 + 1;         // conv1 rows and columns of G1 (9)
constexpr int GYS = C0 + 2;        // conv0 gradient position stride (floats)
constexpr int NMT = 3;             // dW1 m-tiles a warpgroup holds at most
constexpr int MAX_CI = 4;

constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// The element type's shared-memory layout (bytes): conv1's weights as dX's
// B operand | a region holding G1's B form (dW1) and A form (dX), later
// conv0's gradient, later the warps' dW0 partials | the patch | conv0's
// weights and bias, the block's dW0 and db0, the input window (floats)
template <class T>
struct Layout {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int parts = kF32 ? 2 : 1;              // big | small
  static constexpr int pst = kF32 ? PS : PSB;             // patch stride
  static constexpr int g1s = kF32 ? C1 + 4 : C1 + 8;      // G1 A stride
  static constexpr int w1x = parts * W1 * (int)sizeof(T);
  static constexpr int g1b = parts * C1 * T1 * T1 * (int)sizeof(T);
  static constexpr int g1a = GR * GR * g1s * (int)sizeof(T);
  static constexpr int gy0 = OWN * OWN * GYS * 4;
  static constexpr int dw0p = THREADS * (9 * MAX_CI + 1) * 4;
  static constexpr int region = max3(g1b + g1a, gy0, dw0p);
  static constexpr int patch = (kF32 ? PATCH : PATCH_B) * (int)sizeof(T);
};

// conv0's weights and bias, the block's dW0 and db0 sums, the input window
// (floats)
__host__ __device__ inline int tail_floats(int ci) {
  return ci * TX * TX + ci * 9 * C0 + C0 + C0 * (9 * ci + 1);
}

template <class T>
__host__ __device__ inline int smem_bytes(int ci) {
  using L = Layout<T>;
  return L::w1x + L::region + L::patch + 4 * tail_floats(ci);
}

// floats of a block's partial gradients: dW1 | db1 | dW0 | db0
__host__ __device__ inline int part_len(int ci) {
  return W1 + C1 + ci * K1 + C0;
}

// Element (n, k) of an N x K operand in wgmma B order (K-major, no
// swizzle): float32 in k8 steps, bfloat16 in k16 steps (tf32_gmma.cuh,
// bf16_gmma.cuh); k-step s starts at s * N * 8 (float32) or s * N * 16.
template <class T, int N>
__device__ inline int b_index(int n, int k) {
  if constexpr (sizeof(T) == 4)
    return (((k >> 3) * (N / 8) + (n >> 3)) * 2 + ((k >> 2) & 1)) * 32 +
           (n & 7) * 4 + (k & 3);
  else
    return (((k >> 4) * (N / 8) + (n >> 3)) * 2 + ((k >> 3) & 1)) * 64 +
           (n & 7) * 8 + (k & 7);
}

// a value into a B operand at i: float32 split big | small (the small
// part `part` elements on), bfloat16 as it is (v is one already)
__device__ inline void put_b(float* base, int i, int part, float v) {
  uint32_t big, small;
  tc::split(v, big, small);
  base[i] = __uint_as_float(big);
  base[part + i] = __uint_as_float(small);
}
__device__ inline void put_b(__nv_bfloat16* base, int i, int, float v) {
  base[i] = __float2bfloat16_rn(v);
}

__device__ inline void put(float* p, float v) { *p = v; }
__device__ inline void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// conv1's input gradient as the twin keeps it: float32 as it is, bfloat16
// rounded
__device__ inline float rounded(float v, float) { return v; }
__device__ inline float rounded(float v, __nv_bfloat16) { return tc::bf16r(v); }

// two neighbouring channels of the patch, as floats
__device__ inline void patch_pair(const float* p, float (&v)[2]) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  v[0] = f.x;
  v[1] = f.y;
}
__device__ inline void patch_pair(const __nv_bfloat16* p, float (&v)[2]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  v[0] = tc::bf16_lo(w);
  v[1] = tc::bf16_hi(w);
}

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// dW1's m-tile mt: rows k = 64 mt .. 64 mt + 63 of (tap, ci) = (k / 32,
// k % 32) (rows past 287 zero), K = the tile's 64 conv1 positions p = 8 py
// + px. Row r = 16 warp + g reads the patch at conv0 local (2 py + kh, 2 px
// + kw): phase (kh & 1, kw & 1), plane (py + kh / 2, px + kw / 2). float32:
// 3xTF32, A split as it is loaded, two k8 steps (conv1 rows) a commit.
template <int MT>
__device__ inline void dw1_mtile(float (&acc)[24], const float* patch,
                                 const float* g1b, int warp, int g, int t) {
  const int tap = 2 * MT + (warp >> 1);
  const bool real = tap < 9;
  const int kh = real ? tap / 3 : 0, kw = real ? tap % 3 : 0;
  const float* p = patch + ((((kh & 1) * 2 + (kw & 1)) * PH + (kh >> 1)) * PH +
                            (kw >> 1) + t) * PS + 16 * (warp & 1) + g;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      // columns t, t + 4: px = t, t + 4 of conv1 row py = 2 h + u; rows g,
      // g + 8: channels ci, ci + 8
      const float* q = p + (2 * h + u) * PH * PS;
      tc::split(real ? q[0] : 0.f, ab[u][0], as[u][0]);
      tc::split(real ? q[8] : 0.f, ab[u][1], as[u][1]);
      tc::split(real ? q[4 * PS] : 0.f, ab[u][2], as[u][2]);
      tc::split(real ? q[4 * PS + 8] : 0.f, ab[u][3], as[u][3]);
    }
    tc::fence();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* b = g1b + (2 * h + u) * (C1 * 8);
      const uint64_t big = tc::desc_b(b, 128, 256);
      const uint64_t small = tc::desc_b(b + C1 * T1 * T1, 128, 256);
      tc::mma_n48(acc, as[u][0], as[u][1], as[u][2], as[u][3], big);
      tc::mma_n48(acc, ab[u][0], ab[u][1], ab[u][2], ab[u][3], small);
      tc::mma_n48(acc, ab[u][0], ab[u][1], ab[u][2], ab[u][3], big);
    }
    tc::commit();
    tc::wait<1>();
  }
}

// bfloat16: k16 step s holds conv1 rows 2 s (columns 0-7) and 2 s + 1
// (8-15); a register two neighbouring positions (px = 2t, 2t + 1) of one
// channel; two k16 steps a commit
template <int MT>
__device__ inline void dw1_mtile(float (&acc)[24], const __nv_bfloat16* patch,
                                 const __nv_bfloat16* g1b, int warp, int g,
                                 int t) {
  const int tap = 2 * MT + (warp >> 1);
  const bool real = tap < 9;
  const int kh = real ? tap / 3 : 0, kw = real ? tap % 3 : 0;
  const uint16_t* p = reinterpret_cast<const uint16_t*>(patch) +
                      ((((kh & 1) * 2 + (kw & 1)) * PH + (kh >> 1)) * PH +
                       (kw >> 1) + 2 * t) * PSB + 16 * (warp & 1) + g;
  auto pair = [&](const uint16_t* r) {
    return real ? (uint32_t)r[0] | ((uint32_t)r[PSB] << 16) : 0u;
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t a[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint16_t* q = p + 2 * (2 * h + u) * PH * PSB;
      a[u][0] = pair(q);
      a[u][1] = pair(q + 8);
      a[u][2] = pair(q + PH * PSB);
      a[u][3] = pair(q + PH * PSB + 8);
    }
    tc::fence();
#pragma unroll
    for (int u = 0; u < 2; ++u)
      tc::mma_bf16_n48(acc, a[u][0], a[u][1], a[u][2], a[u][3],
                       tc::desc_b(g1b + (2 * h + u) * (C1 * 16), 128, 256));
    tc::commit();
    tc::wait<1>();
  }
}

// One tap of a parity's input gradient: rows (i, j) = (2 warp, g) and (2
// warp + 1, g) of the parity's 8 x 8 conv0 positions read G1 at conv1 (i +
// di, j + dj); K = the 48 conv1 channels; B = the tap's weights [32 ci][48
// co]. float32: 3xTF32, two k8 steps a commit.
__device__ inline void dx_tap(float (&acc)[16], const float* g1a,
                              const float* w1x, int tap, int di, int dj,
                              int warp, int g, int t) {
  constexpr int G1S = Layout<float>::g1s;
  const float* r0 = g1a + ((2 * warp + di) * GR + g + dj) * G1S + t;
  const float* r1 = r0 + GR * G1S;
  const float* w = w1x + tap * (C0 * C1);
#pragma unroll
  for (int h = 0; h < 3; ++h) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * h + u;
      tc::split(r0[8 * s], ab[u][0], as[u][0]);
      tc::split(r1[8 * s], ab[u][1], as[u][1]);
      tc::split(r0[8 * s + 4], ab[u][2], as[u][2]);
      tc::split(r1[8 * s + 4], ab[u][3], as[u][3]);
    }
    tc::fence();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* b = w + (2 * h + u) * (C0 * 8);
      const uint64_t big = tc::desc_b(b, 128, 256);
      const uint64_t small = tc::desc_b(b + W1, 128, 256);
      tc::mma_n32(acc, as[u][0], as[u][1], as[u][2], as[u][3], big);
      tc::mma_n32(acc, ab[u][0], ab[u][1], ab[u][2], ab[u][3], small);
      tc::mma_n32(acc, ab[u][0], ab[u][1], ab[u][2], ab[u][3], big);
    }
    tc::commit();
    tc::wait<1>();
  }
}

// bfloat16: three k16 steps, one commit; a register two neighbouring
// channels of one position
__device__ inline void dx_tap(float (&acc)[16], const __nv_bfloat16* g1a,
                              const __nv_bfloat16* w1x, int tap, int di,
                              int dj, int warp, int g, int t) {
  constexpr int G1S = Layout<__nv_bfloat16>::g1s;
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(
                           g1a + ((2 * warp + di) * GR + g + dj) * G1S) + t;
  const uint32_t* r1 = r0 + GR * G1S / 2;
  const __nv_bfloat16* w = w1x + tap * (C0 * C1);
  uint32_t a[3][4];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    a[s][0] = r0[8 * s];
    a[s][1] = r1[8 * s];
    a[s][2] = r0[8 * s + 4];
    a[s][3] = r1[8 * s + 4];
  }
  tc::fence();
#pragma unroll
  for (int s = 0; s < 3; ++s)
    tc::mma_bf16_n32(acc, a[s][0], a[s][1], a[s][2], a[s][3],
                     tc::desc_b(w + s * (C0 * 16), 128, 256));
  tc::commit();
  tc::wait<1>();
}

// parity PAR = 2 a + b of conv1's input gradient into acc: its taps (di,
// kh) = (0, 1) for a = 0; (0, 2), (1, 0) for a = 1; columns alike
template <int PAR, class T>
__device__ inline void dx_parity(float (&acc)[16], const T* g1a, const T* w1x,
                                 int warp, int g, int t) {
  constexpr int a = PAR >> 1, b = PAR & 1;
#pragma unroll
  for (int ta = 0; ta < (a ? 2 : 1); ++ta) {
    const int kh = a ? (ta ? 0 : 2) : 1;
#pragma unroll
    for (int tb = 0; tb < (b ? 2 : 1); ++tb) {
      const int kw = b ? (tb ? 0 : 2) : 1;
      dx_tap(acc, g1a, w1x, kh * 3 + kw, ta, tb, warp, g, t);
    }
  }
}

// dW1's m-tile MT of one tile in a fresh accumulator, added to its float32
// sums (the tensor cores' own accumulation over a block's thousands of
// positions would lose bits)
template <int MT, class T>
__device__ inline void dw1_add(float (&sum)[24], const T* patch, const T* g1b,
                               int warp, int g, int t) {
  float f[24];
#pragma unroll
  for (int j = 0; j < 24; ++j) f[j] = 0.f;
  dw1_mtile<MT>(f, patch, g1b, warp, g, t);
  tc::wait<0>();
  tc::pin(f);
#pragma unroll
  for (int j = 0; j < 24; ++j) sum[j] += f[j];
}

// One warpgroup's products of a tile, split by compile-time roles:
// warpgroup 0 dW1's m-tiles 0, 1 and parities (0, 0), (1, 1); warpgroup 1
// m-tiles 2, 3, 4 and parities (0, 1), (1, 0)
template <int WG, class T>
__device__ inline void products(float (&dw1)[NMT][24], float (&dx)[2][16],
                                const T* patch, const T* g1a, const T* g1b,
                                const T* w1x, int warp, int g, int t) {
  if constexpr (WG == 0) {
    dw1_add<0>(dw1[0], patch, g1b, warp, g, t);
    dw1_add<1>(dw1[1], patch, g1b, warp, g, t);
  } else {
    dw1_add<2>(dw1[0], patch, g1b, warp, g, t);
    dw1_add<3>(dw1[1], patch, g1b, warp, g, t);
    dw1_add<4>(dw1[2], patch, g1b, warp, g, t);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) dx[0][j] = dx[1][j] = 0.f;
  dx_parity<WG ? 1 : 0>(dx[0], g1a, w1x, warp, g, t);
  dx_parity<WG ? 2 : 3>(dx[1], g1a, w1x, warp, g, t);
  tc::wait<0>();
  tc::pin(dx[0]);
  tc::pin(dx[1]);
}

// A tile's G1 inputs, loaded a tile ahead: thread (c, row) = (tid % 48,
// tid / 48) of the first 240 takes channel c of the five windows of row
// `row` of the 5 x 5 windows whose conv1 positions G1 covers (the tile's
// 4 x 4 and the next row and column): their routes (4 outside the image)
// and gradients
constexpr int G1_THREADS = 5 * C1;

template <class T>
__device__ inline void g1_load(const T* __restrict__ dy,
                               const uint8_t* __restrict__ route, int b,
                               int ty, int tx, int Ho, int Wo, int tid,
                               uint32_t (&r)[5], float (&v)[5]) {
  const int c = tid % C1, oy = ty * TP + tid / C1;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int ox = tx * TP + k;
    const bool in = tid < G1_THREADS && oy < Ho && ox < Wo;
    const size_t o = ((size_t)(b * Ho + oy) * Wo + ox) * C1 + c;
    r[k] = in ? route[o] : 4u;
    v[k] = in ? tc::to_float(dy[o]) : 0.f;
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
stem_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                const T* __restrict__ b0, const T* __restrict__ w1,
                const T* __restrict__ dy, const uint8_t* __restrict__ route,
                uint8_t* __restrict__ mask_out, float* __restrict__ partial,
                int B, int H, int W, int Ci) {
  using L = Layout<T>;
  constexpr int XN = (MAX_CI * TX * TX + THREADS - 1) / THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  T* w1x = reinterpret_cast<T*>(smem);          // 9 x [32 ci][48 co] B order
  unsigned char* region = smem + L::w1x;
  T* g1b = reinterpret_cast<T*>(region);        // [48 co][64 positions] B
  T* g1a = reinterpret_cast<T*>(region + L::g1b);   // [81][g1s]
  float* gy0 = reinterpret_cast<float*>(region);    // [256][GYS]
  T* patch = reinterpret_cast<T*>(region + L::region);
  const int n0 = 9 * Ci + 1;
  float* w0s = reinterpret_cast<float*>(region + L::region + L::patch);
  float* b0s = w0s + Ci * 9 * C0;               // w0s: [ci][tap][c]
  float* dw0s = b0s + C0;                       // [c][9 ci + tap | db0]
  float* xs = dw0s + C0 * n0;                   // [ci][TX][TX]

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int warp8 = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  for (int j = tid; j < W1; j += THREADS) {
    const int co = j / K1, ci = j % K1 / 9, tap = j % 9;
    put_b(w1x + tap * (C0 * C1), b_index<T, C0>(ci, co), W1,
          tc::to_float(w1[j]));
  }
  for (int i = tid; i < Ci * 9 * C0; i += THREADS)
    w0s[i] = tc::to_float(w0[(i % C0) * Ci * 9 + i / C0]);
  if (tid < C0) b0s[tid] = tc::to_float(b0[tid]);
  for (int i = tid; i < C0 * n0; i += THREADS) dw0s[i] = 0.f;

  const int Ho = H / 8, Wo = W / 8, H0 = H / 2, W0 = W / 2;
  const int tiles_x = (Wo + TP - 1) / TP;
  const int per_image = ((Ho + TP - 1) / TP) * tiles_x;
  const long long total = (long long)B * per_image;
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;
  auto origin = [&](long long tile, int& b, int& ty, int& tx) {
    b = (int)(tile / per_image);
    const int rem = (int)(tile % per_image);
    ty = rem / tiles_x;
    tx = rem % tiles_x;
  };

  // this warpgroup's share of a tile's products: dW1's m-tiles mt0 ..
  // mt0 + nmt - 1, the input gradient's parities par0, par1 (products)
  const int mt0 = wg ? 2 : 0, nmt = wg ? 3 : 2;
  const int par0 = wg ? 1 : 0, par1 = wg ? 2 : 3;
  // dW1's float32 sums (dw1_add); db1's (channel c, window row: tid < 192)
  float dw1[NMT][24];
#pragma unroll
  for (int i = 0; i < NMT; ++i)
#pragma unroll
    for (int j = 0; j < 24; ++j) dw1[i][j] = 0.f;
  float db1 = 0.f;
  const float w0r[1] = {0.f};   // conv0_patch reads w0s (kOne off)

  uint32_t rn[5];
  float gn[5];
  if (first < last) {
    int b, ty, tx;
    origin(first, b, ty, tx);
    g1_load(dy, route, b, ty, tx, Ho, Wo, tid, rn, gn);
  }

  for (long long tile = first; tile < last; ++tile) {
    int b, ty, tx;
    origin(tile, b, ty, tx);
    const int r0 = 2 * ty * T1 - 1, s0 = 2 * tx * T1 - 1;   // patch's first
    // the previous tile's reads of the window, the patch and the region
    // are done
    __syncthreads();
    // the input window (zeros outside the image): float32 by cp.async,
    // bfloat16 loaded all at once, then converted
    {
      const int n = Ci * TX * TX;
      auto src = [&](int i, bool& in) {
        const int c = i / (TX * TX), p = i % (TX * TX);
        const int gy = 2 * r0 - 1 + p / TX, gx = 2 * s0 - 1 + p % TX;
        in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        return x + (in ? ((size_t)(b * H + gy) * W + gx) * Ci + c : 0);
      };
      if constexpr (L::kF32) {
        for (int i = tid; i < n; i += THREADS) {
          bool in;
          const T* p = src(i, in);
          tc::cp_async4(xs + i, p, in);
        }
        tc::cp_async_commit();
      } else {
        float xv[XN];
#pragma unroll
        for (int k = 0; k < XN; ++k) {
          const int i = tid + k * THREADS;
          bool in = false;
          const T* p = i < n ? src(i, in) : x;
          xv[k] = in ? tc::to_float(*p) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < XN; ++k)
          if (tid + k * THREADS < n) xs[tid + k * THREADS] = xv[k];
      }
    }
    // G1 at conv1 rows and columns 8 ty .. 8 ty + 8 from the loaded
    // windows: g at the position the route names, else 0; the own 8 x 8
    // also as dW1's B; db1 += the own windows' routed g
    if (tid < G1_THREADS) {
      const int c = tid % C1, wr = tid / C1;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ly = 2 * wr + (q >> 1), lx = 2 * k + (q & 1);
          if (ly < GR && lx < GR) {
            const float v = rn[k] == (uint32_t)q ? gn[k] : 0.f;
            put(g1a + (ly * GR + lx) * L::g1s + c, v);
            if (ly < T1 && lx < T1)
              put_b(g1b, b_index<T, C1>(c, ly * T1 + lx), C1 * T1 * T1, v);
          }
        }
        if (wr < TP && k < TP && rn[k] < 4u) db1 += gn[k];
      }
    }
    if constexpr (L::kF32) tc::cp_async_wait<0>();
    tc::fence_async_smem();   // G1's and the weights' B forms, for wgmma
    __syncthreads();
    conv0_patch<T, false>(xs, patch, w0s, b0s, w0r, Ci, r0, s0, H0, W0, tid,
                          THREADS);
    if (tile + 1 < last) {    // the next tile's G1 inputs, while this computes
      int nb, nty, ntx;
      origin(tile + 1, nb, nty, ntx);
      g1_load(dy, route, nb, nty, ntx, Ho, Wo, tid, rn, gn);
    }
    __syncthreads();

    float dx[2][16];
    if (wg == 0)
      products<0>(dw1, dx, patch, g1a, g1b, w1x, warp, g, t);
    else
      products<1>(dw1, dx, patch, g1a, g1b, w1x, warp, g, t);
    __syncthreads();          // G1's readers are done: the region is free

    // conv0's gradient at the owned positions: conv1's input gradient
    // (bfloat16: rounded) where conv0's output is positive, else 0
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const int par = pi ? par1 : par0, a = par >> 1, bb = par & 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {     // rows r, r + 8: (i, j) = (2 warp + h, g)
        const int oi = 2 * (2 * warp + h) + a, oj = 2 * g + bb;
        const int ly = oi + 1, lx = oj + 1;                 // patch local
        const T* pp = patch + (((ly & 1) * 2 + (lx & 1)) * PH * PH +
                               (ly >> 1) * PH + (lx >> 1)) * L::pst;
        const int gy = OWN * ty + oi, gx = OWN * tx + oj;
        uint8_t* mo = mask_out != nullptr && gy < H0 && gx < W0
                          ? mask_out + ((size_t)(b * H0 + gy) * W0 + gx) * C0
                          : nullptr;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = 8 * jj + 2 * t;        // channels c, c + 1
          float live[2];
          patch_pair(pp + c, live);
          float2 v;
          v.x = live[0] > 0.f ? rounded(dx[pi][4 * jj + 2 * h], T()) : 0.f;
          v.y = live[1] > 0.f ? rounded(dx[pi][4 * jj + 2 * h + 1], T()) : 0.f;
          *reinterpret_cast<float2*>(gy0 + (oi * OWN + oj) * GYS + c) = v;
          if (mo != nullptr) {
            mo[c] = live[0] > 0.f;
            mo[c + 1] = live[1] > 0.f;
          }
        }
      }
    }
    __syncthreads();

    // the tile's dW0 and db0: warp w two owned rows, lane c, conv0's
    // gradient times its input taps; then the eight warps' partials added
    // to the block's sums in warp order
    {
      float d[9 * MAX_CI + 1];
#pragma unroll
      for (int i = 0; i < 9 * MAX_CI + 1; ++i) d[i] = 0.f;
      // the warp's rows oi, oi + 1 read input rows 2 oi + 2 .. 2 oi + 6;
      // position oj columns 2 oj + 2 .. 2 oj + 4, so a step in oj keeps
      // one column and loads two
      const int oi = 2 * warp8;
      const float* g0 = gy0 + oi * OWN * GYS + lane;
#pragma unroll
      for (int ci = 0; ci < MAX_CI; ++ci) {
        if (ci < Ci) {
          const float* xr = xs + (ci * TX + 2 * oi + 2) * TX + 2;
          float win[5][3];
#pragma unroll
          for (int r = 0; r < 5; ++r) win[r][2] = xr[r * TX];
#pragma unroll
          for (int oj = 0; oj < OWN; ++oj) {
#pragma unroll
            for (int r = 0; r < 5; ++r) {
              win[r][0] = win[r][2];
              win[r][1] = xr[r * TX + 2 * oj + 1];
              win[r][2] = xr[r * TX + 2 * oj + 2];
            }
            const float v0 = g0[oj * GYS], v1 = g0[(OWN + oj) * GYS];
            if (ci == 0) d[9 * MAX_CI] += v0 + v1;
#pragma unroll
            for (int k = 0; k < 9; ++k) {
              d[9 * ci + k] = fmaf(v0, win[k / 3][k % 3], d[9 * ci + k]);
              d[9 * ci + k] = fmaf(v1, win[k / 3 + 2][k % 3], d[9 * ci + k]);
            }
          }
        }
      }
      __syncthreads();      // conv0's gradient is read: the region is free
      float* part = reinterpret_cast<float*>(region) + tid * n0;
#pragma unroll
      for (int ci = 0; ci < MAX_CI; ++ci)
        if (ci < Ci)
#pragma unroll
          for (int k = 0; k < 9; ++k) part[9 * ci + k] = d[9 * ci + k];
      part[9 * Ci] = d[9 * MAX_CI];
      __syncthreads();
      const float* parts = reinterpret_cast<const float*>(region);
      for (int i = tid; i < C0 * n0; i += THREADS) {
        float v = dw0s[i];          // element (c, r): lane c of each warp
        for (int w = 0; w < THREADS / 32; ++w)
          v += parts[(w * 32 + i / n0) * n0 + i % n0];
        dw0s[i] = v;
      }
    }
  }

  float* out = partial + (size_t)blockIdx.x * part_len(Ci);
  // dW1 as [co][ci][tap]: accumulator row k = (tap, ci), column co
#pragma unroll
  for (int i = 0; i < NMT; ++i) {
    if (i < nmt) {
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 64 * (mt0 + i) + 16 * warp + g + 8 * h;
            if (k < K1)
              out[(8 * j + 2 * t + e) * K1 + (k % C0) * 9 + k / C0] =
                  dw1[i][4 * j + 2 * h + e];
          }
    }
  }
  // db1: the window rows' partials summed in order; dW0 and db0 as summed
  float* sb = reinterpret_cast<float*>(region);      // [TP][C1]
  __syncthreads();
  if (tid < TP * C1) sb[tid] = db1;
  __syncthreads();
  if (tid < C1) {
    float v = 0.f;
    for (int k = 0; k < TP; ++k) v += sb[k * C1 + tid];
    out[W1 + tid] = v;
  }
  for (int i = tid; i < C0 * 9 * Ci; i += THREADS)
    out[W1 + C1 + i] = dw0s[i / (9 * Ci) * n0 + i % (9 * Ci)];
  if (tid < C0) out[W1 + C1 + Ci * K1 + tid] = dw0s[tid * n0 + 9 * Ci];
}

// every gradient element, the blocks' partials summed in block order
template <class T>
__global__ void stem_bwd_reduce_kernel(const float* __restrict__ partial,
                                       int blocks, T* __restrict__ dw0,
                                       T* __restrict__ db0,
                                       T* __restrict__ dw1,
                                       T* __restrict__ db1, int Ci) {
  const int n = part_len(Ci);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s += partial[(size_t)k * n + e];
  if (e < W1)
    store(dw1 + e, s);
  else if (e < W1 + C1)
    store(db1 + (e - W1), s);
  else if (e < W1 + C1 + Ci * K1)
    store(dw0 + (e - W1 - C1), s);
  else
    store(db0 + (e - W1 - C1 - Ci * K1), s);
}

template <class T>
int grid_of(int Ci, int* blocks) {
  const int smem = smem_bytes<T>(Ci);
  cudaError_t err = cudaFuncSetAttribute(
      stem_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stem_bwd_kernel<T>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return 0;
}

template <class T>
int run(const void* x, const void* w0, const void* b0, const void* w1,
        const void* g, const void* route, void* mask, void* partial,
        void* dw0, void* db0, void* dw1, void* db1, int B, int H, int W,
        int Ci, int blocks, cudaStream_t s) {
  int unused;
  const int err = grid_of<T>(Ci, &unused);
  if (err) return err;
  stem_bwd_kernel<T><<<blocks, THREADS, smem_bytes<T>(Ci), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0),
      static_cast<const T*>(b0), static_cast<const T*>(w1),
      static_cast<const T*>(g), static_cast<const uint8_t*>(route),
      static_cast<uint8_t*>(mask), static_cast<float*>(partial), B, H, W, Ci);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  stem_bwd_reduce_kernel<T><<<(part_len(Ci) + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), blocks, static_cast<T*>(dw0),
      static_cast<T*>(db0), static_cast<T*>(dw1), static_cast<T*>(db1), Ci);
  return (int)cudaGetLastError();
}

}  // namespace

// The grid at Ci input channels: the blocks the card holds at once, written
// to *blocks; the partial buffer holds one row a block. Returns a
// cudaError_t.
extern "C" int wmfml_stem_bwd_grid(int ci, int bf16, int* blocks) {
  return bf16 ? grid_of<__nv_bfloat16>(ci, blocks) : grid_of<float>(ci, blocks);
}

extern "C" int wmfml_stem_bwd_smem_bytes(int ci, int bf16) {
  return bf16 ? smem_bytes<__nv_bfloat16>(ci) : smem_bytes<float>(ci);
}

extern "C" int wmfml_stem_bwd_partials(int ci) { return part_len(ci); }

extern "C" int wmfml_stem_bwd_max_ci() { return MAX_CI; }

// x [B,H,W,Ci], w0 [32,Ci,3,3], b0 [32], w1 [48,32,3,3], g [B,H/8,W/8,48]:
// f32, or bf16 when bf16 is set; route [B,H/8,W/8,48] uint8 (K1's, or any
// of 0-4); mask null, or [B,H/2,W/2,32] uint8 for conv0's ReLU mask as K1b
// took it; partial [blocks, wmfml_stem_bwd_partials(ci)] float32 scratch,
// blocks the grid of wmfml_stem_bwd_grid; out dw0, db0, dw1, db1 in the
// inputs' type. All contiguous on the device.
extern "C" int wmfml_stem_bwd(const void* x, const void* w0, const void* b0,
                              const void* w1, const void* g,
                              const void* route, void* mask, void* partial,
                              void* dw0, void* db0, void* dw1, void* db1,
                              int B, int H, int W, int Ci, int blocks,
                              int bf16, void* stream) {
  if (Ci < 1 || Ci > MAX_CI || H % 8 || W % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return run<__nv_bfloat16>(x, w0, b0, w1, g, route, mask, partial, dw0,
                              db0, dw1, db1, B, H, W, Ci, blocks, s);
  return run<float>(x, w0, b0, w1, g, route, mask, partial, dw0, db0, dw1,
                    db1, B, H, W, Ci, blocks, s);
}
