// MAML features block, per task: L x { 3x3 stride-1 same conv (64 -> 64,
// per-task weights and bias), batch-statistics BN over the task's real
// context rows (one pass: E[x^2] - E[x]^2 in f32, var clamped at 0, eps),
// shared scale/bias, ReLU }. NHWC f32 in and out: [T, N, H, W, 64].
//
// Replaces scripts/proto_maml_pallas_conv.py:96 features_block_pallas
// (pl.pallas_call at :108, body features_block_kernel at :37), which
// computes layers 2-4 of wmfml_tpu/models/maml.py:106-120 for one task per
// grid step with the whole task resident in VMEM, each layer as 9 taps of
// [P, 64] @ [64, 64] on the matrix unit. Two additions the MAML path needs
// and the prototype lacks: the conv bias, and the context mask (statistics
// over the task's real rows only; padded rows are still normalised and
// passed on). The 1 -> 64 lift of layer 1 stays outside.
//
// Bound: at T=10, N=15, 14x14, L=3 the block does 6.50 GFLOP of products.
// In 3xTF32 on the tensor cores that is 3 x 6.50 GFLOP at 495 TFLOP/s,
// 0.039 ms; it must move ~20 MB (0.006 ms at 3.35 TB/s), so it is bound by
// tensor-core operations.
//
// Design. One task's activation (2940 x 64 x 4 B = 753 KB) exceeds a
// block's 227 KB, and BN needs the whole task's statistics before any row
// can be normalised, so there is one launch per layer plus an epilogue:
//   * each layer is an implicit GEMM per task: M = N*H*W pixel rows
//     (ragged: 2940 = 22 x 128 + 124), N = 64 output channels, K = 9 taps x
//     64 input channels. A block owns a tile of 128 consecutive pixel rows
//     of one task (two warpgroups of 64 rows) and all 64 output channels;
//     T * ceil(N*H*W / 128) = 230 blocks of 256 threads, two resident per
//     SM (110 KB of shared memory, <= 128 registers), so the launch fits
//     the 264 slots of 132 SMs in one wave;
//   * it stages the pixels its taps can reach (the tile +- one image row and
//     one pixel, 158 x 64 floats at W = 14, row stride 68 floats so the A
//     fragment reads hit 32 banks) with the PREVIOUS layer's BN + ReLU
//     applied on load, from that task's per-tile partial sums reduced in a
//     fixed order; a tap's zero padding is a predicate on the row's image
//     coordinates, so one staging serves all 9 taps;
//   * per tap, wgmma m64n64k8 .tf32 with A from registers (gathered from the
//     staged pixels and split big/small as it is loaded) and B from shared
//     memory: the task's weights for that tap, big and small (2 x 16 KB),
//     streamed through a two-stage ring by bulk copies (TMA without a tensor
//     map) completing on mbarriers; each k-step issues small*big, big*small,
//     big*big. A first launch splits every task's weights and lays them out
//     in that order (pack_kernel; kernels/features.py:pack_weights is its
//     plain twin): one short launch on the device, where the same work as
//     PyTorch operations in the wrapper cost the host more than the block;
//   * the epilogue adds the bias, writes the pre-BN output and the tile's
//     per-channel sum and sum of squares (counted rows only; lane butterfly,
//     then the 8 warps in order) to scratch;
//   * one last launch applies the last BN + ReLU.
// No atomics: two runs agree bit for bit.
//
// bfloat16 (compute_dtype: bfloat16; conv_kernel<bf16>, bn_relu_kernel<bf16>):
// x, the weights, biases, BN scale and bias and the output are bfloat16,
// and the rounding is the JAX block's (models/maml.py:60-70 and nn.Conv in
// bf16): the conv sums in float32 and rounds, the bias add rounds; the
// statistics are float32 sums of the rounded values and of their rounded
// squares; the normalisation (x - mean) * rstd * scale + bias rounds at each
// of its four operations, mean and rstd rounded to bfloat16 first. A layer
// stages the previous layer's bfloat16 output with that BN + ReLU applied
// (exactly bfloat16 again), 72 values a row (36 words: the A-fragment loads
// hit 32 banks); per tap, four wgmma m64n64k16 .bf16 (one product a k-step,
// A two values a register) on the tap's 8 KB of weights, streamed through
// the same two-stage ring; the epilogue writes bfloat16 and float32 partial
// sums. 60 KB of shared memory a block. Its bound: 6.50 GFLOP at 989
// TFLOP/s, 0.0066 ms, against ~10 MB (0.003 ms): operations.

#include <cuda_runtime.h>

#include <type_traits>

#include "bf16_gmma.cuh"
#include "tf32_gmma.cuh"

namespace {

constexpr int C = 64;              // channels in and out
constexpr int WGS = 2;             // warpgroups per block
constexpr int TILE = 64 * WGS;     // pixel rows per block
constexpr int THREADS = 128 * WGS;
constexpr int AS = C + 4;          // staged pixel stride (floats)
constexpr int TAP = C * C;         // one tap's weights, one part (floats)
constexpr int STAGE = 2 * TAP;     // big + small
constexpr int TAPS = 9;

__host__ __device__ inline int staged_pixels(int W) {
  return TILE + 2 * (W + 1);
}

// BN statistics of task t from the per-tile partial sums [T][tiles][2][C]
// of the layer before, summed in a fixed order; threads 0..C-1 write mean,
// rstd, scale and bias of their channel to bn[0..4C).
// In bfloat16 (T = __nv_bfloat16) mean and rstd are rounded to it, and scale
// and bias are read from it.
template <class T>
__device__ void load_bn(const float* __restrict__ part,
                        const unsigned char* __restrict__ mask,
                        const T* __restrict__ scale,
                        const T* __restrict__ bias, int t, int N,
                        int tiles, int HW, float eps, float* bn) {
  const int c = threadIdx.x;
  if (c >= C) return;
  int rows = N;
  if (mask != nullptr) {
    rows = 0;
    for (int n = 0; n < N; ++n) rows += mask[t * N + n] != 0;
  }
  const float denom = fmaxf((float)rows * (float)HW, 1.f);
  const float* p = part + (size_t)t * tiles * 2 * C;
  float s1 = 0.f, s2 = 0.f;
  for (int j = 0; j < tiles; ++j) {
    s1 += p[(2 * j) * C + c];
    s2 += p[(2 * j + 1) * C + c];
  }
  const float mean = s1 / denom;
  const float var = fmaxf(s2 / denom - mean * mean, 0.f);
  if constexpr (sizeof(T) == 2) {
    bn[c] = tc::bf16r(mean);
    bn[C + c] = tc::bf16r(rsqrtf(var + eps));
    bn[2 * C + c] = __bfloat162float(scale[c]);
    bn[3 * C + c] = __bfloat162float(bias[c]);
  } else {
    bn[c] = mean;
    bn[C + c] = rsqrtf(var + eps);
    bn[2 * C + c] = scale[c];
    bn[3 * C + c] = bias[c];
  }
}

__device__ inline float bn_relu(float v, const float* bn, int c) {
  return fmaxf((v - bn[c]) * bn[C + c] * bn[2 * C + c] + bn[3 * C + c], 0.f);
}

// the bfloat16 form: every operation rounds
__device__ inline float bn_relu_bf16(float v, const float* bn, int c) {
  float y = tc::bf16r(v - bn[c]);
  y = tc::bf16r(y * bn[C + c]);
  y = tc::bf16r(y * bn[2 * C + c]);
  return fmaxf(tc::bf16r(y + bn[3 * C + c]), 0.f);
}

// eight bfloat16 (a uint4) through bn_relu_bf16, channels c..c+7
__device__ inline uint4 bn_relu_bf16x8(uint4 v, const float* bn, int c) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = tc::pack_bf16(bn_relu_bf16(tc::bf16_lo(w[i]), bn, c + 2 * i),
                         bn_relu_bf16(tc::bf16_hi(w[i]), bn, c + 2 * i + 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// w [TL][64 out][64 in][3][3] -> wk [TL][9 taps][big, small][64 x 64 in wgmma
// B order (kernels/tf32.py:gmma_b_layout of [out][in])]; one thread per
// (TL, tap, element)
__global__ void pack_kernel(const float* __restrict__ w, float* __restrict__ wk,
                            int TL) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long long)TL * TAPS * TAP) return;
  const int i = (int)(o % TAP), tap = (int)(o / TAP % TAPS);
  const long long tl = o / (TAPS * TAP);
  // i = ((s * 8 + g) * 2 + kk) * 32 + r * 4 + e: out g * 8 + r, in s * 8 + kk * 4 + e
  const int e = i & 3, r = (i >> 2) & 7, kk = (i >> 5) & 1, g = (i >> 6) & 7,
            s = i >> 9;
  const int co = g * 8 + r, ci = s * 8 + kk * 4 + e;
  uint32_t big, small;
  tc::split(w[((tl * C + co) * C + ci) * TAPS + tap], big, small);
  float* dst = wk + (tl * TAPS + tap) * STAGE + i;
  dst[0] = __uint_as_float(big);
  dst[TAP] = __uint_as_float(small);
}

// bfloat16: wk [TL][9 taps][64 x 64 in the bf16 wgmma B order] of w as it
// is; i = ((s * 8 + g) * 2 + kk) * 64 + r * 8 + e: out g * 8 + r, in
// s * 16 + kk * 8 + e
__global__ void pack_bf16_kernel(const __nv_bfloat16* __restrict__ w,
                                 __nv_bfloat16* __restrict__ wk, int TL) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long long)TL * TAPS * TAP) return;
  const int i = (int)(o % TAP), tap = (int)(o / TAP % TAPS);
  const long long tl = o / (TAPS * TAP);
  const int e = i & 7, r = (i >> 3) & 7, kk = (i >> 6) & 1, g = (i >> 7) & 7,
            s = i >> 10;
  const int co = g * 8 + r, ci = s * 16 + kk * 8 + e;
  wk[(tl * TAPS + tap) * TAP + i] = w[((tl * C + co) * C + ci) * TAPS + tap];
}

cudaError_t pack(const void* w, void* wk, int TL, bool bf16, cudaStream_t s) {
  const long long n = (long long)TL * TAPS * TAP;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (bf16)
    pack_bf16_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wk),
        TL);
  else
    pack_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(w),
                                       static_cast<float*>(wk), TL);
  return cudaGetLastError();
}

// -- the layer, for T = float (3xTF32) or __nv_bfloat16 -------------------

using bf16 = __nv_bfloat16;
constexpr int ASW = C / 2 + 4;     // bf16 staged pixel stride (words)

// a tap's weights in the ring (elements: big | small, or the bf16 weights)
// and a staged pixel's stride in 32-bit words
template <class T>
__host__ __device__ constexpr int stage_elems() {
  return sizeof(T) == 4 ? STAGE : TAP;
}
template <class T>
__host__ __device__ constexpr int pixel_words() {
  return sizeof(T) == 4 ? AS : ASW;
}

// ring of weight stages | 2 mbarriers (16 B) | bn [4][C] | staged pixels
template <class T>
__host__ __device__ inline int conv_smem_bytes(int W) {
  return 2 * stage_elems<T>() * (int)sizeof(T) + 16 + 4 * C * 4 +
         staged_pixels(W) * pixel_words<T>() * 4;
}

// 16 bytes of channels c.. through the BN + ReLU of bn
__device__ inline uint4 bn_relu16(uint4 v, const float* bn, int c, float) {
  return make_uint4(__float_as_uint(bn_relu(__uint_as_float(v.x), bn, c)),
                    __float_as_uint(bn_relu(__uint_as_float(v.y), bn, c + 1)),
                    __float_as_uint(bn_relu(__uint_as_float(v.z), bn, c + 2)),
                    __float_as_uint(bn_relu(__uint_as_float(v.w), bn, c + 3)));
}
__device__ inline uint4 bn_relu16(uint4 v, const float* bn, int c, bf16) {
  return bn_relu_bf16x8(v, bn, c);
}

// One tap's products into acc; refill() frees the ring stage of tap - 1
// once every warpgroup is done with it. 3xTF32: two halves of four k8
// steps, small*big, big*small, big*big each, A split big/small as loaded
// (refill after the first half).
template <class Refill>
__device__ inline void mma_tap(float (&acc)[32], const float* xa,
                               const float* xb, const bool (&ok)[2],
                               const float* wb, Refill refill) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = (4 * half + s) * 8;
      tc::split(ok[0] ? xa[k] : 0.f, ab[s][0], as[s][0]);
      tc::split(ok[1] ? xb[k] : 0.f, ab[s][1], as[s][1]);
      tc::split(ok[0] ? xa[k + 4] : 0.f, ab[s][2], as[s][2]);
      tc::split(ok[1] ? xb[k + 4] : 0.f, ab[s][3], as[s][3]);
    }
    tc::fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float* wstep = wb + (4 * half + s) * (8 * C);
      const uint64_t big = tc::desc_b(wstep, 128, 256);
      const uint64_t small = tc::desc_b(wstep + TAP, 128, 256);
      tc::mma_n64(acc, as[s][0], as[s][1], as[s][2], as[s][3], big);
      tc::mma_n64(acc, ab[s][0], ab[s][1], ab[s][2], ab[s][3], small);
      tc::mma_n64(acc, ab[s][0], ab[s][1], ab[s][2], ab[s][3], big);
    }
    tc::commit();
    tc::wait<1>();
    if (half == 0) refill();
  }
}

// bfloat16: four k16 steps of one product, A two values a word
template <class Refill>
__device__ inline void mma_tap(float (&acc)[32], const uint32_t* xa,
                               const uint32_t* xb, const bool (&ok)[2],
                               const bf16* wb, Refill refill) {
  uint32_t a[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = ok[0] ? xa[8 * s] : 0u;
    a[s][1] = ok[1] ? xb[8 * s] : 0u;
    a[s][2] = ok[0] ? xa[8 * s + 4] : 0u;
    a[s][3] = ok[1] ? xb[8 * s + 4] : 0u;
  }
  tc::fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    tc::mma_bf16_n64(acc, a[s][0], a[s][1], a[s][2], a[s][3],
                     tc::desc_b(wb + s * (16 * C), 128, 256));
  tc::commit();
  tc::wait<1>();
  refill();
}

// the epilogue's value: the sum plus the bias (bfloat16: the sum rounded,
// the add rounded), a counted value's square, and a square added to s2
__device__ inline float biased(float acc, float b, float) { return acc + b; }
__device__ inline float biased(float acc, float b, bf16) {
  return tc::bf16r(tc::bf16r(acc) + b);
}
__device__ inline float square(float u, float) { return u * u; }
__device__ inline float square(float u, bf16) { return tc::bf16r(u * u); }
__device__ inline float add_square(float s2, float u, float) {
  return fmaf(u, u, s2);
}
__device__ inline float add_square(float s2, float u, bf16) {
  return s2 + tc::bf16r(u * u);
}

// One layer: out = conv(act(in)) + bias, with act = BN + ReLU of the layer
// before (part_in != nullptr) or the identity (the block's first layer).
// Grid: T * tiles blocks; block (t, tile) covers pixel rows
// [tile * TILE, tile * TILE + TILE) of task t's N*H*W rows. part_out gets
// the tile's float32 per-channel sums in either element type.
template <class T>
__global__ void __launch_bounds__(THREADS, 2)
conv_kernel(const T* __restrict__ in, const T* __restrict__ wk,
            long long w_task_stride, const T* __restrict__ bias,
            int bias_task_stride, const float* __restrict__ part_in,
            const T* __restrict__ scale_in, const T* __restrict__ bias_in,
            const unsigned char* __restrict__ mask, T* __restrict__ out,
            float* __restrict__ part_out, int N, int H, int W, int tiles,
            float eps) {
  // a staged word: one float, or two bfloat16
  using Word = std::conditional_t<sizeof(T) == 4, float, uint32_t>;
  constexpr int S = stage_elems<T>(), AW = pixel_words<T>();
  constexpr int V = 16 / sizeof(T);      // channels a 16-byte load
  extern __shared__ __align__(128) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);                          // [2][S]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * S * sizeof(T));
  float* bn = reinterpret_cast<float*>(bars + 2);              // [4][C]
  Word* xs = reinterpret_cast<Word*>(bn + 4 * C);              // [SP][AW]

  const int tid = threadIdx.x;
  const int t = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int HW = H * W, P = N * HW;
  const int p0 = tile * TILE, lo = p0 - (W + 1), SP = staged_pixels(W);
  const T* wt = wk + (size_t)t * w_task_stride;
  const bool act = part_in != nullptr;

  if (tid == 0) {
    tc::bar_init(&bars[0], 1);
    tc::bar_init(&bars[1], 1);
    tc::bar_init_fence();
  }
  if (act)
    load_bn<T>(part_in, mask, scale_in, bias_in, t, N, tiles, HW, eps, bn);
  __syncthreads();
  if (tid == 0) {
    tc::bulk_load(ws, wt, S * sizeof(T), &bars[0]);
    tc::bulk_load(ws + S, wt + S, S * sizeof(T), &bars[1]);
  }

  // stage the reachable pixels, activated, 16 bytes a load; rows outside
  // the task are 0 and never read (their taps are predicated off)
  const T* src = in + (size_t)t * P * C;
  for (int i = tid; i < SP * (C / V); i += THREADS) {
    const int q = i / (C / V), cv = (i % (C / V)) * V;
    const int p = lo + q;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p >= 0 && p < P) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)p * C + cv);
      if (act) v = bn_relu16(v, bn, cv, T());
    }
    *reinterpret_cast<uint4*>(xs + q * AW + cv * sizeof(T) / 4) = v;
  }
  __syncthreads();

  // this thread's two accumulator rows (r, r + 8) and their image coordinates
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  int yy[2], xx[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + r0 + 8 * h;
    valid[h] = p < P;
    yy[h] = (p % HW) / W;
    xx[h] = p % W;
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ok[h] = valid[h] && yy[h] + dy >= 0 && yy[h] + dy < H &&
              xx[h] + dx >= 0 && xx[h] + dx < W;
    const Word* xa = xs + (r0 + W + 1 + dy * W + dx) * AW + tq;
    tc::bar_wait(&bars[tap & 1], (tap >> 1) & 1);
    mma_tap(acc, xa, xa + 8 * AW, ok, ws + (tap & 1) * S, [&] {
      // every warpgroup is done with tap - 1's stage: refill it
      __syncthreads();
      if (tid == 0 && tap >= 1 && tap + 1 < TAPS)
        tc::bulk_load(ws + ((tap + 1) & 1) * S, wt + (tap + 1) * S,
                      S * sizeof(T), &bars[(tap + 1) & 1]);
    });
  }
  tc::wait<0>();
  tc::pin(acc);

  // bias, pre-BN output, and this tile's per-channel sums over counted rows
  // (bfloat16: of the rounded values and their rounded squares)
  const T* bt = bias + (size_t)t * bias_task_stride;
  T* dst = out + ((size_t)t * P + p0 + r0) * C;
  bool counted[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    counted[h] = valid[h] &&
                 (mask == nullptr || mask[t * N + (p0 + r0 + 8 * h) / HW] != 0);
  float s1[16], s2[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float b0 = tc::to_float(bt[c]), b1 = tc::to_float(bt[c + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = biased(acc[4 * j + 2 * h], b0, T());
      const float v1 = biased(acc[4 * j + 2 * h + 1], b1, T());
      if (valid[h]) tc::store2(dst + 8 * h * C + c, v0, v1);
      const float u0 = counted[h] ? v0 : 0.f, u1 = counted[h] ? v1 : 0.f;
      if (h == 0) {
        s1[2 * j] = u0; s1[2 * j + 1] = u1;
        s2[2 * j] = square(u0, T()); s2[2 * j + 1] = square(u1, T());
      } else {
        s1[2 * j] += u0; s1[2 * j + 1] += u1;
        s2[2 * j] = add_square(s2[2 * j], u0, T());
        s2[2 * j + 1] = add_square(s2[2 * j + 1], u1, T());
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int m = 4; m <= 16; m <<= 1) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], m);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], m);
    }
  }
  __syncthreads();                 // every A read of xs is done: reuse it
  float* red = reinterpret_cast<float*>(xs);     // [warp][2][C]
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e;
        red[(warp * 2) * C + c] = s1[2 * j + e];
        red[(warp * 2 + 1) * C + c] = s2[2 * j + e];
      }
  }
  __syncthreads();
  if (tid < 2 * C) {
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w * 2 * C + tid];
    part_out[((size_t)t * tiles + tile) * 2 * C + tid] = s;
  }
}

// Epilogue: out = ReLU(BN(y)) with the last layer's statistics; one block
// per image.
template <class T>
__global__ void __launch_bounds__(256)
bn_relu_kernel(const T* __restrict__ y, const float* __restrict__ part,
               const T* __restrict__ scale, const T* __restrict__ bias,
               const unsigned char* __restrict__ mask, T* __restrict__ out,
               int N, int H, int W, int tiles, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float bn[4 * C];
  const int t = blockIdx.x / N;
  load_bn<T>(part, mask, scale, bias, t, N, tiles, H * W, eps, bn);
  __syncthreads();
  const size_t base = (size_t)blockIdx.x * H * W * C;
  const uint4* src = reinterpret_cast<const uint4*>(y + base);
  uint4* dst = reinterpret_cast<uint4*>(out + base);
  for (int i = threadIdx.x; i < H * W * C / V; i += blockDim.x)
    dst[i] = bn_relu16(src[i], bn, (i % (C / V)) * V, T());
}

}  // namespace

extern "C" int wmfml_features_smem_bytes(int W) {
  return conv_smem_bytes<float>(W);
}

extern "C" int wmfml_features_smem_bytes_bf16(int W) {
  return conv_smem_bytes<bf16>(W);
}

// The weight packing alone (for tests): w [T,L,64,64,3,3] -> wk
// [T,L,9,2,64*64] f32, or (bf16) [T,L,9,1,64*64] bf16.
extern "C" int wmfml_features_pack(const void* w, void* wk, int TL,
                                   int bf16_io, void* stream) {
  return (int)pack(w, wk, TL, bf16_io != 0, (cudaStream_t)stream);
}

// The block's L + 2 launches for element type T: the packing, a Conv launch
// a layer, the Epilogue; a layer's packed weights are `stage` elements a
// tap (f32: big | small, bf16: the weights).
template <class T, class Conv, class Epilogue>
int run_block(Conv conv, Epilogue epilogue, int smem, int stage, const T* x,
              const T* w, T* wk, const T* b, const T* scale, const T* bias,
              const unsigned char* mask, T* y0, T* y1, float* part, T* out,
              int Tn, int N, int H, int W, int L, float eps, cudaStream_t s) {
  const int tiles = (N * H * W + TILE - 1) / TILE;
  cudaError_t err = cudaFuncSetAttribute(
      conv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = pack(w, wk, Tn * L, sizeof(T) == 2, s)) != cudaSuccess)
    return (int)err;
  const size_t part_layer = (size_t)Tn * tiles * 2 * C;
  T* ys[2] = {y0, y1};
  for (int l = 0; l < L; ++l) {
    const bool first = l == 0;
    conv<<<Tn * tiles, THREADS, smem, s>>>(
        first ? x : ys[(l + 1) % 2], wk + (size_t)l * TAPS * stage,
        (long long)L * TAPS * stage, b + l * C, L * C,
        first ? nullptr : part + (l - 1) * part_layer,
        first ? nullptr : scale + (l - 1) * C,
        first ? nullptr : bias + (l - 1) * C, mask, ys[l % 2],
        part + l * part_layer, N, H, W, tiles, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  epilogue<<<Tn * N, 256, 0, s>>>(
      ys[(L - 1) % 2], part + (L - 1) * part_layer, scale + (L - 1) * C,
      bias + (L - 1) * C, mask, out, N, H, W, tiles, eps);
  return (int)cudaGetLastError();
}

// x [T,N,H,W,64]; w [T,L,64(out),64(in),3,3]; wk scratch [T,L,9,2,64*64]
// for the packed weights; b [T,L,64]; scale, bias [L,64]; mask [T,N] one
// byte each (0 = padded row) or null (every row counts); y0, y1 scratch
// like x; part scratch [L,T,tiles,2,64] with tiles = ceil(N*H*W / 128); out
// like x. All contiguous on the device, x and wk 16-byte aligned; f32, or,
// with bf16_io set, bf16 (wk [T,L,9,1,64*64]; part stays f32). Returns the
// first cudaError_t of the L + 2 launches.
extern "C" int wmfml_features_fwd(const void* x, const void* w, void* wk,
                                  const void* b, const void* scale,
                                  const void* bias,
                                  const unsigned char* mask, void* y0,
                                  void* y1, float* part, void* out, int T,
                                  int N, int H, int W, int L, float eps,
                                  int bf16_io, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16_io)
    return run_block<bf16>(
        conv_kernel<bf16>, bn_relu_kernel<bf16>, conv_smem_bytes<bf16>(W),
        stage_elems<bf16>(),
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(wk), static_cast<const bf16*>(b),
        static_cast<const bf16*>(scale), static_cast<const bf16*>(bias), mask,
        static_cast<bf16*>(y0), static_cast<bf16*>(y1), part,
        static_cast<bf16*>(out), T, N, H, W, L, eps, s);
  return run_block<float>(
      conv_kernel<float>, bn_relu_kernel<float>, conv_smem_bytes<float>(W),
      stage_elems<float>(),
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(wk), static_cast<const float*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(bias), mask,
      static_cast<float*>(y0), static_cast<float*>(y1), part,
      static_cast<float*>(out), T, N, H, W, L, eps, s);
}
