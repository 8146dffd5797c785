// K1b: the literature stem's backward by the phase form (conv_bwd: phase).
// For the pooled map's gradient g [B, H/8, W/8, 48] of the fused stem
// (stem.cu: conv0 3x3 s2 p1 (Ci->32) + bias + ReLU, conv1 3x3 s2 p1
// (32->48) + bias + ReLU, 2x2/s2 max pool; NHWC) and weights shared by the
// batch, it returns dW0 [32, Ci, 3, 3], db0 [32], dW1 [48, 32, 3, 3] and
// db1 [48] (torch OIHW), float32 or bfloat16 as the inputs.
//
// Replaces the backward of wmfml_tpu/nn/encoders.py:117 conv3x3_s2_phase
// (conv1's input gradient as one dense 2x2 stride-1 convolution over the
// padded output gradient, kernel [2, 2, Co, 4 Ci] assembled from W's taps,
// then depth-to-space) together with the autodiff of the rest of the stem
// around it: the pool's and the ReLUs' masks, conv1's and conv0's weight
// and bias gradients. Its plain twin is kernels/stem.py:
// stem_backward_phase_plain, which it must equal up to float32 rounding.
//
// What the phase form is here. Conv0 position r = 2i + a reads conv1
// outputs p with r = 2p + kh - 1: parity a = 0 only tap kh = 1 of p = i;
// a = 1 taps kh = 2 of p = i and kh = 0 of p = i + 1. So the (a, b) parity
// of conv1's input gradient sums 1, 2, 2 or 4 taps: 9 of the dense form's
// 16 [Co, Ci] blocks are real. The TPU multiplied the 7 zero blocks for its
// matrix unit's sake; this kernel reads only the real ones.
//
// Bound: at B = 300, H = W = 128 the backward does conv1 again (8.5 GFLOP),
// its input gradient (8.5: 9 of 16 taps at a quarter of the positions each)
// and its weight gradient (8.5 dense; a quarter of that here, since at most
// one of a pool window's four positions carries a gradient), conv0 again and
// its weight gradient (0.7 each), against ~35 MB to move: bound by
// operations. This simple form runs every product on the CUDA cores in
// float32 (67 TFLOP/s), from shared memory, with the weight gradients'
// sparsity taken and the dense zeros of the phase form skipped.
//
// Design: three kernels, the forward's tiling (a tile is one image's 4 x 4
// pool outputs = 8 x 8 conv1 outputs), a persistent grid sized from the
// kernels' occupancy, each block one contiguous run of tiles, its partial
// weight gradients in registers, and no float atomics:
//   A (route): per tile, the 35 x 35 input window, conv0 + ReLU over the
//     17 x 17 patch (halo included) into shared memory, conv1 + ReLU at the
//     64 positions, the pool's first maximum in raster order of each window
//     and channel (F.max_pool2d's rule; in bfloat16 over the rounded
//     values, where positive ties are real), routed where it is positive:
//     the route (one byte a pooled value: the window position, or 4 for
//     none) goes to device memory for B, and the block adds g times the
//     routed position's conv0 patch into its dW1 and db1 partials;
//   B (input): per tile the 16 x 16 conv0 positions it owns (conv0 rows and
//     columns 16 ty .. 16 ty + 15, which read conv1 rows 8 ty .. 8 ty + 8,
//     the next tile's first included), conv1's output gradient rebuilt
//     from g and the route (9 x 9 x 48), conv0's ReLU masks recomputed,
//     conv1's input gradient by the phase form (a thread a position, its 32
//     channels in registers; a warp's positions share one parity, so its
//     weight reads are broadcasts) times the masks, and the block's dW0 and
//     db0 partials from it and the input window;
//   C (reduce): each weight gradient element sums the blocks' partials in
//     block order, in float32, and rounds once to the output type.
// The partial sums are fixed by the grid, so two calls give the same bits
// (a CUDA graph's replay = the loop, under deterministic algorithms).
//
// bfloat16: the rounding of the twin. conv0's and conv1's float32 sums are
// rounded, the bias add rounds again, ReLU (the pool takes the rounded
// values, first in raster order); conv1's input gradient is rounded to
// bfloat16 before the mask and conv0's weight gradient; every weight and
// bias gradient is a float32 sum rounded once at the end.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gmma.cuh"

namespace {

constexpr int C0 = 32;               // conv0 output channels
constexpr int C1 = 48;               // conv1 output channels
constexpr int TP = 4;                // pool outputs per tile side
constexpr int T1 = 2 * TP;           // conv1 outputs per tile side (8)
constexpr int T0 = 2 * T1 + 1;       // conv0 positions per tile side, halo in (17)
constexpr int TX = 2 * T0 + 1;       // input pixels per tile side for A (35)
constexpr int A0W = 20;              // conv0 patch row stride, positions
constexpr int A0S = C0 + 1;          // conv0 patch position stride, floats
constexpr int K1 = 9 * C0;           // conv1 depth (288)
constexpr int W1 = C1 * K1;          // conv1 weights (13,824)
constexpr int V1S = C1 + 1;          // conv1 output position stride
constexpr int NWIN = TP * TP;        // pool windows per tile
constexpr int OWN = 2 * T1;          // conv0 positions B owns per tile side
constexpr int BX = 2 * OWN + 1;      // input pixels per tile side for B (33)
constexpr int GR = T1 + 1;           // conv1 rows and columns B reads (9)
constexpr int GS = C1 + 1;           // their position stride
constexpr int GYS = C0 + 1;          // conv0 gradient position stride
constexpr int THREADS = 256;
constexpr int W1_EACH = W1 / THREADS;   // dW1 elements a thread owns (54)
constexpr int MAX_CI = 4;
constexpr int W0_EACH = (MAX_CI * K1 + THREADS - 1) / THREADS;
constexpr int PART_A = W1 + C1;      // floats of a block's A partials

static_assert(W1_EACH == 6 * 9 && THREADS / 32 * 6 == C1 && C0 == 32,
              "dW1: a warp 6 output channels, a lane an input channel");

__host__ __device__ inline int smem_floats_a(int ci) {
  return W1 + ci * K1 + C0 + C1 + ci * TX * TX + T0 * A0W * A0S + 2 * 64 * V1S;
}
__host__ __device__ inline int smem_floats_b(int ci) {
  return W1 + ci * K1 + C0 + ci * BX * BX + GR * GR * GS + 256 * GYS + 256;
}
__host__ __device__ inline int part_b(int ci) { return ci * K1 + C0; }

// a pre-activation from its float32 sum and the bias: float32 adds;
// bfloat16 rounds the sum, adds the bias and rounds again
template <class T>
__device__ inline float pre_act(float sum, float bias) {
  if constexpr (sizeof(T) == 4) {
    return sum + bias;
  } else {
    return tc::bf16r(tc::bf16r(sum) + bias);
  }
}

// a value of the twin's conv outputs: float32 as it is, bfloat16 rounded
template <class T>
__device__ inline float rounded(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return tc::bf16r(v);
  }
}

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the tile a block's k-th run position names: image b, tile row ty, col tx
struct Tiles {
  int Ho, Wo, ty_n, tx_n, per_image;
  long long first, last;
  __device__ Tiles(int B, int H, int W) {
    Ho = H / 8;
    Wo = W / 8;
    ty_n = (Ho + TP - 1) / TP;
    tx_n = (Wo + TP - 1) / TP;
    per_image = ty_n * tx_n;
    const long long total = (long long)B * per_image;
    first = total * blockIdx.x / gridDim.x;
    last = total * (blockIdx.x + 1) / gridDim.x;
  }
  __device__ void at(long long tile, int& b, int& ty, int& tx) const {
    b = (int)(tile / per_image);
    const int rem = (int)(tile % per_image);
    ty = rem / tx_n;
    tx = rem % tx_n;
  }
};

// conv0's weights as [ci][tap][c] floats, its bias
template <class T>
__device__ inline void stage_w0(const T* __restrict__ w0,
                                const T* __restrict__ b0, float* w0s,
                                float* b0s, int Ci) {
  for (int i = threadIdx.x; i < Ci * 9 * C0; i += blockDim.x)
    w0s[i] = tc::to_float(w0[(i % C0) * Ci * 9 + i / C0]);
  if (threadIdx.x < C0) b0s[threadIdx.x] = tc::to_float(b0[threadIdx.x]);
}

// a window of the input into xs [Ci][n][n], its first pixel (ry, rx),
// zeros outside the image
template <class T>
__device__ inline void stage_window(const T* __restrict__ x, float* xs, int b,
                                    int ry, int rx, int n, int H, int W,
                                    int Ci) {
  for (int i = threadIdx.x; i < Ci * n * n; i += blockDim.x) {
    const int c = i / (n * n), p = i % (n * n);
    const int gy = ry + p / n, gx = rx + p % n;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    xs[i] = in ? tc::to_float(x[((size_t)(b * H + gy) * W + gx) * Ci + c])
               : 0.f;
  }
}

// A: conv0 + conv1 again, the pool's routes, dW1 and db1 partials
template <class T>
__global__ void __launch_bounds__(THREADS, 1)
stem_bwd_route_kernel(const T* __restrict__ x, const T* __restrict__ w0,
             const T* __restrict__ b0, const T* __restrict__ w1,
             const T* __restrict__ b1, const T* __restrict__ g,
             uint8_t* __restrict__ route, float* __restrict__ partial, int B,
             int H, int W, int Ci) {
  extern __shared__ __align__(16) float sm[];
  float* w1s = sm;                      // [tap][ci][co]
  float* w0s = w1s + W1;                // [ci][tap][c]
  float* b0s = w0s + Ci * K1;
  float* b1s = b0s + C0;
  float* xs = b1s + C1;                 // [Ci][TX][TX]
  float* a0 = xs + Ci * TX * TX;        // [T0][A0W][A0S], post-ReLU
  float* v1 = a0 + T0 * A0W * A0S;      // [64][V1S], post-ReLU
  float* gy = v1 + 64 * V1S;            // [64][V1S]: conv1's gradient
  const int tid = threadIdx.x;
  // dW1: a thread one input channel (its lane) of 6 output channels (its
  // warp's), all 9 taps: acc[6 c + tap]
  const int lane = tid & 31, cog = tid >> 5;

  for (int j = tid; j < W1; j += THREADS) {
    const int co = j / K1, ci = j % K1 / 9, tap = j % 9;
    w1s[(tap * C0 + ci) * C1 + co] = tc::to_float(w1[j]);
  }
  stage_w0(w0, b0, w0s, b0s, Ci);
  if (tid < C1) b1s[tid] = tc::to_float(b1[tid]);

  float acc[W1_EACH];
#pragma unroll
  for (int i = 0; i < W1_EACH; ++i) acc[i] = 0.f;
  float acc_b = 0.f;
  const Tiles tiles(B, H, W);
  const int H0 = H / 2, W0 = W / 2, H1 = H / 4, W1o = W / 4;

  for (long long tile = tiles.first; tile < tiles.last; ++tile) {
    int b, ty, tx;
    tiles.at(tile, b, ty, tx);
    const int r0 = 2 * ty * T1 - 1, s0 = 2 * tx * T1 - 1;   // first conv0
    __syncthreads();                   // the previous tile's reads are done
    stage_window(x, xs, b, 2 * r0 - 1, 2 * s0 - 1, TX, H, W, Ci);
    __syncthreads();

    // conv0 + ReLU over the patch: item (position, group of 8 channels)
    for (int item = tid; item < T0 * T0 * 4; item += THREADS) {
      const int pos = item >> 2, cg = item & 3;
      const int ly = pos / T0, lx = pos % T0;
      const int gy = r0 + ly, gx = s0 + lx;
      float a[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) a[c] = 0.f;
      if (gy >= 0 && gy < H0 && gx >= 0 && gx < W0) {
        for (int ci = 0; ci < Ci; ++ci) {
          const float* xp = xs + (ci * TX + 2 * ly) * TX + 2 * lx;
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const float v = xp[(k / 3) * TX + k % 3];
#pragma unroll
            for (int c = 0; c < 8; ++c)
              a[c] = fmaf(v, w0s[(ci * 9 + k) * C0 + 8 * cg + c], a[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
          a[c] = fmaxf(pre_act<T>(a[c], b0s[8 * cg + c]), 0.f);
      }
      float* dst = a0 + (ly * A0W + lx) * A0S + 8 * cg;
#pragma unroll
      for (int c = 0; c < 8; ++c) dst[c] = a[c];
    }
    __syncthreads();

    // conv1 + ReLU: a thread one position and 12 channels
    {
      const int p = tid & 63, cg = tid >> 6, py = p >> 3, px = p & 7;
      float s[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) s[j] = 0.f;
      const float* ap = a0 + (2 * py * A0W + 2 * px) * A0S;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const float* at = ap + ((tap / 3) * A0W + tap % 3) * A0S;
        const float* wt = w1s + tap * C0 * C1 + 12 * cg;
#pragma unroll 4
        for (int ci = 0; ci < C0; ++ci) {
          const float v = at[ci];
          const float4* w4 = reinterpret_cast<const float4*>(wt + ci * C1);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float4 w = w4[q];
            s[4 * q] = fmaf(v, w.x, s[4 * q]);
            s[4 * q + 1] = fmaf(v, w.y, s[4 * q + 1]);
            s[4 * q + 2] = fmaf(v, w.z, s[4 * q + 2]);
            s[4 * q + 3] = fmaf(v, w.w, s[4 * q + 3]);
          }
        }
      }
      const bool valid = ty * T1 + py < H1 && tx * T1 + px < W1o;
#pragma unroll
      for (int j = 0; j < 12; ++j)
        v1[p * V1S + 12 * cg + j] =
            valid ? fmaxf(pre_act<T>(s[j], b1s[12 * cg + j]), 0.f) : 0.f;
    }
    __syncthreads();

    // the pool's routes: item (window, channel); conv1's gradient g at the
    // routed position, 0 at the window's others
    for (int item = tid; item < NWIN * C1; item += THREADS) {
      const int win = item / C1, c = item % C1;
      const int wy = win / TP, wx = win % TP;
      const int oy = ty * TP + wy, ox = tx * TP + wx;
      int at = -1;
      float gv = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gy[((2 * wy + q / 2) * T1 + 2 * wx + q % 2) * V1S + c] = 0.f;
      if (oy < tiles.Ho && ox < tiles.Wo) {
        int best = 0;
        float m = v1[(2 * wy * T1 + 2 * wx) * V1S + c];
#pragma unroll
        for (int q = 1; q < 4; ++q) {
          const float v = v1[((2 * wy + q / 2) * T1 + 2 * wx + q % 2) * V1S + c];
          if (v > m) {
            m = v;
            best = q;
          }
        }
        const size_t o = ((size_t)(b * tiles.Ho + oy) * tiles.Wo + ox) * C1 + c;
        uint8_t r = 4;
        if (m > 0.f) {
          r = (uint8_t)best;
          at = (2 * wy + best / 2) * T1 + 2 * wx + best % 2;
          gv = tc::to_float(g[o]);
        }
        route[o] = r;
      }
      if (at >= 0) gy[at * V1S + c] = gv;
    }
    __syncthreads();

    // dW1 += conv1's gradient x the conv0 patch of its position, as a dense
    // [48 x 64] x [64 x 288] product over the tile (the zeros of the
    // unrouted positions included: a regular loop of 54 products per 15
    // loads, where the sparse sum spends its time on indexing); db1 += g
#pragma unroll 1
    for (int p = 0; p < 64; ++p) {
      const float* ap = a0 + (2 * (p >> 3) * A0W + 2 * (p & 7)) * A0S + lane;
      float a[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        a[tap] = ap[((tap / 3) * A0W + tap % 3) * A0S];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float gv = gy[p * V1S + 6 * cog + c];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          acc[9 * c + tap] = fmaf(gv, a[tap], acc[9 * c + tap]);
      }
    }
    if (tid < C1)
      for (int p = 0; p < 64; ++p) acc_b += gy[p * V1S + tid];
  }
  float* out = partial + (size_t)blockIdx.x * PART_A;
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      out[(6 * cog + c) * K1 + lane * 9 + tap] = acc[9 * c + tap];
  if (tid < C1) out[W1 + tid] = acc_b;
}

// B: conv1's input gradient by the phase form at the conv0 positions a
// tile owns, conv0's masks, dW0 and db0 partials
template <class T>
__global__ void __launch_bounds__(THREADS, 1)
stem_bwd_input_kernel(const T* __restrict__ x, const T* __restrict__ w0,
             const T* __restrict__ b0, const T* __restrict__ w1,
             const T* __restrict__ g, const uint8_t* __restrict__ route,
             float* __restrict__ partial, int B, int H, int W, int Ci) {
  extern __shared__ __align__(16) float sm[];
  float* w1s = sm;                      // [tap][co][ci]
  float* w0s = w1s + W1;                // [ci][tap][c]
  float* b0s = w0s + Ci * K1;
  float* xs = b0s + C0;                 // [Ci][BX][BX]
  float* gs = xs + Ci * BX * BX;        // [GR][GR][GS]: conv1's gradient
  float* gy = gs + GR * GR * GS;        // [256][GYS]: conv0's gradient
  uint32_t* mask = reinterpret_cast<uint32_t*>(gy + 256 * GYS);  // [256]
  const int tid = threadIdx.x;

  for (int j = tid; j < W1; j += THREADS) {
    const int co = j / K1, ci = j % K1 / 9, tap = j % 9;
    w1s[(tap * C1 + co) * C0 + ci] = tc::to_float(w1[j]);
  }
  stage_w0(w0, b0, w0s, b0s, Ci);

  float acc[W0_EACH];
#pragma unroll
  for (int k = 0; k < W0_EACH; ++k) acc[k] = 0.f;
  float acc_b = 0.f;
  const Tiles tiles(B, H, W);
  const int H0 = H / 2, W0 = W / 2, H1 = H / 4, W1o = W / 4;
  // this thread's conv0 position for the phase form: a warp one parity
  const int par = tid >> 6, pa = par >> 1, pb = par & 1;
  const int pi = (tid & 63) >> 3, pj = tid & 7;
  const int lp = (2 * pi + pa) * OWN + 2 * pj + pb;

  for (long long tile = tiles.first; tile < tiles.last; ++tile) {
    int b, ty, tx;
    tiles.at(tile, b, ty, tx);
    const int r0 = OWN * ty, s0 = OWN * tx;        // first owned conv0
    __syncthreads();
    stage_window(x, xs, b, 2 * r0 - 1, 2 * s0 - 1, BX, H, W, Ci);
    // conv1's output gradient at rows and columns 8 ty .. 8 ty + 8: g
    // where the route names the position, else 0
    for (int i = tid; i < GR * GR * C1; i += THREADS) {
      const int c = i % C1, pos = i / C1, ly = pos / GR, lx = pos % GR;
      const int y1 = T1 * ty + ly, x1 = T1 * tx + lx;
      float v = 0.f;
      if (y1 < H1 && x1 < W1o) {
        const size_t o =
            ((size_t)(b * tiles.Ho + (y1 >> 1)) * tiles.Wo + (x1 >> 1)) * C1 + c;
        if (route[o] == (y1 & 1) * 2 + (x1 & 1)) v = tc::to_float(g[o]);
      }
      gs[pos * GS + c] = v;
    }
    __syncthreads();

    // conv0's ReLU masks at the owned positions, a thread a position
    {
      const int ly = tid >> 4, lx = tid & 15;
      uint32_t bits = 0;
      if (r0 + ly < H0 && s0 + lx < W0) {
        float a[C0];
#pragma unroll
        for (int c = 0; c < C0; ++c) a[c] = 0.f;
        for (int ci = 0; ci < Ci; ++ci) {
          const float* xp = xs + (ci * BX + 2 * ly) * BX + 2 * lx;
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const float v = xp[(k / 3) * BX + k % 3];
#pragma unroll
            for (int c = 0; c < C0; ++c)
              a[c] = fmaf(v, w0s[(ci * 9 + k) * C0 + c], a[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < C0; ++c)
          bits |= (pre_act<T>(a[c], b0s[c]) > 0.f ? 1u : 0u) << c;
      }
      mask[tid] = bits;
    }
    __syncthreads();

    // the phase form: parity (pa, pb) reads its own taps only, (di, kh) =
    // (0, 1) for pa = 0; (0, 2), (1, 0) for pa = 1; columns alike
    {
      float d[C0];
#pragma unroll
      for (int c = 0; c < C0; ++c) d[c] = 0.f;
      const int na = pa ? 2 : 1, nb = pb ? 2 : 1;
      for (int ta = 0; ta < na; ++ta) {
        const int di = ta, kh = pa ? (ta ? 0 : 2) : 1;
        for (int tb = 0; tb < nb; ++tb) {
          const int dj = tb, kw = pb ? (tb ? 0 : 2) : 1;
          const float* gp = gs + ((pi + di) * GR + pj + dj) * GS;
          const float* wp = w1s + (kh * 3 + kw) * C1 * C0;
#pragma unroll 2
          for (int co = 0; co < C1; ++co) {
            const float gv = gp[co];
            const float4* w4 = reinterpret_cast<const float4*>(wp + co * C0);
#pragma unroll
            for (int q = 0; q < C0 / 4; ++q) {
              const float4 w = w4[q];
              d[4 * q] = fmaf(gv, w.x, d[4 * q]);
              d[4 * q + 1] = fmaf(gv, w.y, d[4 * q + 1]);
              d[4 * q + 2] = fmaf(gv, w.z, d[4 * q + 2]);
              d[4 * q + 3] = fmaf(gv, w.w, d[4 * q + 3]);
            }
          }
        }
      }
      const uint32_t bits = mask[lp];
#pragma unroll
      for (int c = 0; c < C0; ++c)
        gy[lp * GYS + c] = (bits >> c) & 1u ? rounded<T>(d[c]) : 0.f;
    }
    __syncthreads();

    // dW0 += conv0's gradient x its input patch; db0 += conv0's gradient
#pragma unroll
    for (int k = 0; k < W0_EACH; ++k) {
      const int e = k * THREADS + tid;
      if (e < Ci * K1) {
        const int c = e / (Ci * 9), ci = e % (Ci * 9) / 9, tap = e % 9;
        const float* xp = xs + (ci * BX + tap / 3) * BX + tap % 3;
        float s = acc[k];
#pragma unroll 4
        for (int p = 0; p < 256; ++p)
          s = fmaf(gy[p * GYS + c], xp[2 * (p >> 4) * BX + 2 * (p & 15)], s);
        acc[k] = s;
      }
    }
    if (tid < C0)
      for (int p = 0; p < 256; ++p) acc_b += gy[p * GYS + tid];
  }
  float* out = partial + (size_t)blockIdx.x * part_b(Ci);
#pragma unroll
  for (int k = 0; k < W0_EACH; ++k) {
    const int e = k * THREADS + tid;
    if (e < Ci * K1) out[e] = acc[k];
  }
  if (tid < C0) out[Ci * K1 + tid] = acc_b;
}

// C: every gradient element, the blocks' partials summed in block order
template <class T>
__global__ void stem_bwd_reduce_kernel(const float* __restrict__ pa, int na,
                              const float* __restrict__ pb, int nb,
                              T* __restrict__ dw0, T* __restrict__ db0,
                              T* __restrict__ dw1, T* __restrict__ db1,
                              int Ci) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int eb = part_b(Ci);
  if (e < PART_A) {
    float s = 0.f;
    for (int k = 0; k < na; ++k) s += pa[(size_t)k * PART_A + e];
    store(e < W1 ? dw1 + e : db1 + (e - W1), s);
  } else if (e < PART_A + eb) {
    const int f = e - PART_A;
    float s = 0.f;
    for (int k = 0; k < nb; ++k) s += pb[(size_t)k * eb + f];
    store(f < Ci * K1 ? dw0 + f : db0 + (f - Ci * K1), s);
  }
}

template <class T>
int grid_of(int which, int Ci, int* blocks) {
  const int smem = 4 * (which ? smem_floats_b(Ci) : smem_floats_a(Ci));
  cudaError_t err;
  if (which)
    err = cudaFuncSetAttribute(stem_bwd_input_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  else
    err = cudaFuncSetAttribute(stem_bwd_route_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (which)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stem_bwd_input_kernel<T>, THREADS, smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stem_bwd_route_kernel<T>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return 0;
}

template <class T>
int run(const void* x, const void* w0, const void* b0, const void* w1,
        const void* b1, const void* g, void* route, void* pa, void* pb,
        void* dw0, void* db0, void* dw1, void* db1, int B, int H, int W,
        int Ci, int na, int nb, cudaStream_t s) {
  int unused;
  int err = grid_of<T>(0, Ci, &unused);
  if (err) return err;
  if ((err = grid_of<T>(1, Ci, &unused))) return err;
  const T* xt = static_cast<const T*>(x);
  const T* w0t = static_cast<const T*>(w0);
  const T* b0t = static_cast<const T*>(b0);
  const T* w1t = static_cast<const T*>(w1);
  const T* gt = static_cast<const T*>(g);
  stem_bwd_route_kernel<T><<<na, THREADS, 4 * smem_floats_a(Ci), s>>>(
      xt, w0t, b0t, w1t, static_cast<const T*>(b1), gt,
      static_cast<uint8_t*>(route), static_cast<float*>(pa), B, H, W, Ci);
  if ((err = (int)cudaGetLastError())) return err;
  stem_bwd_input_kernel<T><<<nb, THREADS, 4 * smem_floats_b(Ci), s>>>(
      xt, w0t, b0t, w1t, gt, static_cast<const uint8_t*>(route),
      static_cast<float*>(pb), B, H, W, Ci);
  if ((err = (int)cudaGetLastError())) return err;
  const int elems = PART_A + part_b(Ci);
  stem_bwd_reduce_kernel<T><<<(elems + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(pa), na, static_cast<const float*>(pb), nb,
      static_cast<T*>(dw0), static_cast<T*>(db0), static_cast<T*>(dw1),
      static_cast<T*>(db1), Ci);
  return (int)cudaGetLastError();
}

}  // namespace

// The grid of kernel A (which = 0) or B (1) at Ci input channels: the
// blocks the card holds at once, written to *blocks; the partial buffers
// hold one row a block. Returns a cudaError_t.
extern "C" int wmfml_stem_bwd_grid(int which, int ci, int bf16, int* blocks) {
  return bf16 ? grid_of<__nv_bfloat16>(which, ci, blocks)
              : grid_of<float>(which, ci, blocks);
}

extern "C" int wmfml_stem_bwd_smem_bytes(int which, int ci) {
  return 4 * (which ? smem_floats_b(ci) : smem_floats_a(ci));
}

extern "C" int wmfml_stem_bwd_partials(int which, int ci) {
  return which ? part_b(ci) : PART_A;
}

extern "C" int wmfml_stem_bwd_max_ci() { return MAX_CI; }

// x [B,H,W,Ci], w0 [32,Ci,3,3], b0 [32], w1 [48,32,3,3], b1 [48], g
// [B,H/8,W/8,48]: f32, or bf16 when bf16 is set; route [B,H/8,W/8,48]
// uint8 scratch; pa [na, wmfml_stem_bwd_partials(0)] and pb [nb, ...(1)]
// float32 scratch, na and nb the grids of wmfml_stem_bwd_grid; out dw0,
// db0, dw1, db1 in the inputs' type. All contiguous on the device.
extern "C" int wmfml_stem_bwd(const void* x, const void* w0, const void* b0,
                              const void* w1, const void* b1, const void* g,
                              void* route, void* pa, void* pb, void* dw0,
                              void* db0, void* dw1, void* db1, int B, int H,
                              int W, int Ci, int na, int nb, int bf16,
                              void* stream) {
  if (Ci < 1 || Ci > MAX_CI || H % 8 || W % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return run<__nv_bfloat16>(x, w0, b0, w1, b1, g, route, pa, pb, dw0, db0,
                              dw1, db1, B, H, W, Ci, na, nb, s);
  return run<float>(x, w0, b0, w1, b1, g, route, pa, pb, dw0, db0, dw1, db1,
                    B, H, W, Ci, na, nb, s);
}
