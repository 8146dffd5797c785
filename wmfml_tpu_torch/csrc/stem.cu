// Fused literature stem: conv0 3x3 s2 p1 (Ci->32) + bias + ReLU,
// conv1 3x3 s2 p1 (32->48) + bias + ReLU, 2x2/s2 max pool. NHWC f32 in,
// NHWC f32 out: [B, H, W, Ci] -> [B, H/8, W/8, 48].
//
// Replaces wmfml_tpu/nn/encoders.py:_s2d_stem (+ _s2d) and the
// max_pool2(..., "window") that follows it in LiteratureEncoder. The JAX
// version rearranges conv0/conv1 into space-to-depth phase layout so XLA
// can tile them on the TPU's matrix unit; on Hopper the cost that matters is
// the conv0 activation map ([B, H/2, W/2, 32] f32, 157 MB at B=300, H=128),
// which the unfused chain writes and reads back from device memory.
//
// Bound: at B=300, H=W=128 the stem does 9.2 GFLOP (conv1 8.5, conv0 0.7)
// and must move only ~34 MB (input + output + weights). conv1 runs in
// 3xTF32 on the tensor cores (3 x 8.5 GFLOP at 495 TFLOP/s, 0.051 ms) and
// conv0 in f32 on the CUDA cores (0.7 GFLOP at 67 TFLOP/s, 0.011 ms), the
// two side by side: 0.051 ms, bound by operations, not by bytes.
//
// Design: a tile is one image's 4x4 pool outputs = 8x8 conv1 outputs =
// exactly the 64 rows of one wgmma. A persistent grid, sized from the
// kernel's measured occupancy, gives each block one contiguous run of the
// tiles of ONE task, so it stages that task's conv1 weights once: 48 x 288
// K-major, split big | small into wgmma B order as they are loaded (2 x
// 55 KB; kernels/stem.py:pack_conv1 is the plain twin of that packing,
// which as PyTorch operations in the wrapper cost the host more than the
// kernel). The shared ANP call is the one-task case. A block runs
// two warpgroups, each on its own tiles with its own buffers:
//   * cp.async brings the next tile's 35x35xCi input into the second of two
//     buffers (zero-filled outside the image) while this tile computes;
//   * conv0 + bias + ReLU on the CUDA cores, one thread per conv0 position
//     and 8 of its 32 channels (at Ci = 1 the thread holds those channels'
//     72 weights in registers for the whole run), into a
//     17x17x32 patch kept channel-innermost in 2x2 phase layout
//     [phase][9][9][36] (stride 36 floats: a warp's A-fragment loads hit 32
//     banks); positions outside the map are conv1's zero padding;
//   * conv1 as wgmma m64n48k8 .tf32 over K = 9 taps x 32 channels: A from
//     registers, loaded from the patch and split big/small as it is loaded,
//     B from shared memory; 36 k-steps x (small*big, big*small, big*big);
//   * bias, ReLU and the 2x2 pool from the accumulator fragments: pixel
//     (py + 1, px) is row r + 8, held by the same thread, and (py, px + 1)
//     the neighbouring row, one shuffle away.
// The conv0 map never touches device memory.
// Shared memory at Ci = 1: conv1 weights 110,592 B + conv0 weights, biases
// 1,472 B + 2 x (patch 46,656 B + input double buffer 9,800 B) = 224,976 B
// of the 232,448 a block may have; one block of 256 threads per SM. A wider
// input that does not fit two warpgroups runs one.
//
// bfloat16 (compute_dtype: bfloat16; stem_fwd_kernel<__nv_bfloat16>): x,
// the weights and the output are bfloat16, and the rounding is the JAX
// stem's (encoders.py:266-314 in bf16): each conv sums in float32 and
// rounds to bfloat16, its bias add rounds again, ReLU, and the pool takes
// the rounded values. conv0 runs on the CUDA cores as above, from the
// bfloat16 input (converted exactly to float32 as a tile's window is
// staged, a plain load a value: cp.async moves 4 bytes at least) and writes
// the patch in bfloat16 (stride 40 values = 20 words, so a warp's
// A-fragment loads still hit 32 banks). conv1 is wgmma m64n48k16 .bf16: 18
// k-steps of one product each, A packed from the patch two values a
// register, B the task's weights as they are (27,648 B in wgmma B order; no
// split). The epilogue pools the float32 sums, rounds, adds the bias and
// rounds (both roundings are monotone, so pooling first gives the pool of
// the rounded values), ReLU, and stores two channels a word. One kernel
// body serves both types; the element type picks the helpers that differ.
// Its bound at B=300: both convs' 9.2 GFLOP are bfloat16 products summed in
// float32, which the tensor cores do at 989 TFLOP/s (the kernel runs conv0,
// one input channel, on the CUDA cores all the same): 0.0093 ms, against
// ~17 MB moved (0.005 ms): operations.
//
// The pool's routes (conv_bwd: phase, for K1b): where the caller passes a
// route buffer, each pooled value's window position of its first maximum
// in raster order (among the float32 sums, or in bfloat16 among the
// rounded values the pool compares, which tie), or 4 where the output is
// not positive: one byte a pooled value, 3.7 MB at 300 images. The
// epilogue notes what they need (Pool), and route_flush derives and
// stores them, branch-free, while the next tile's conv1 products run.
// The output's bits do not depend on it. conv0 is conv0_patch
// (stem_tile.cuh), which K1b runs for conv0's ReLU mask.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gmma.cuh"
#include "stem_tile.cuh"
#include "tf32_gmma.cuh"

namespace {

constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int smem_floats(int ci, int wgs) {
  // w1 big | small | w0 | b0 | b1 | patch per warpgroup | 2 inputs per wg
  return 2 * W1 + ci * 9 * C0 + C0 + C1 + wgs * (PATCH + 2 * ci * TX * TX);
}

// bfloat16 path, shared memory (bytes): w1 | w0, b0, b1 as floats | per
// warpgroup a bfloat16 patch and one float input
__host__ __device__ inline int wg_bytes_bf16(int ci) {   // 16-byte aligned
  return (2 * PATCH_B + 4 * ci * TX * TX + 15) & ~15;
}
__host__ __device__ inline int smem_bytes_bf16(int ci, int wgs) {
  return 2 * W1 + 4 * (ci * 9 * C0 + C0 + C1) + wgs * wg_bytes_bf16(ci);
}

// Where element j of a task's conv1 weights (torch OIHW, [48][32][3][3])
// goes in wgmma B order: output channel n = g * 8 + r and depth
// k = (kh * 3 + kw) * 32 + c = s * 8 + kk * 4 + e sit at
// ((s * 6 + g) * 2 + kk) * 32 + r * 4 + e.
__device__ inline int conv1_b_index(int j) {
  const int n = j / K1, c = j % K1 / 9, tap = j % 9;
  const int k = tap * C0 + c;
  return (((k >> 3) * (C1 / 8) + (n >> 3)) * 2 + ((k >> 2) & 1)) * 32 +
         (n & 7) * 4 + (k & 3);
}

// One task's conv1 weights, split big | small into wgmma B order: reads in
// source order (coalesced), scattered writes
__device__ inline void pack_conv1(const float* __restrict__ w1t, float* dst,
                                  int j0, int stride) {
#pragma unroll 4
  for (int j = j0; j < W1; j += stride) {
    uint32_t big, small;
    tc::split(w1t[j], big, small);
    const int i = conv1_b_index(j);
    dst[i] = __uint_as_float(big);
    dst[W1 + i] = __uint_as_float(small);
  }
}

__global__ void pack_kernel(const float* __restrict__ w1,
                            float* __restrict__ dst) {
  pack_conv1(w1 + (size_t)blockIdx.x * W1, dst + (size_t)blockIdx.x * 2 * W1,
             threadIdx.x, blockDim.x);
}

// The bfloat16 layout: k-steps of 16, element (n, k) of the [48][288]
// operand at (((k / 16) * 6 + n / 8) * 2 + (k / 8) % 2) * 64 + (n % 8) * 8 +
// k % 8
__device__ inline int conv1_b_index_bf16(int j) {
  const int n = j / K1, c = j % K1 / 9, tap = j % 9;
  const int k = tap * C0 + c;
  return (((k >> 4) * (C1 / 8) + (n >> 3)) * 2 + ((k >> 3) & 1)) * 64 +
         (n & 7) * 8 + (k & 7);
}

__device__ inline void pack_conv1_bf16(const __nv_bfloat16* __restrict__ w1t,
                                       __nv_bfloat16* dst, int j0,
                                       int stride) {
#pragma unroll 4
  for (int j = j0; j < W1; j += stride) dst[conv1_b_index_bf16(j)] = w1t[j];
}

__global__ void pack_bf16_kernel(const __nv_bfloat16* __restrict__ w1,
                                 __nv_bfloat16* __restrict__ dst) {
  pack_conv1_bf16(w1 + (size_t)blockIdx.x * W1,
                  dst + (size_t)blockIdx.x * W1, threadIdx.x, blockDim.x);
}

// shared memory bytes of the kernel for T: float (smem_floats) or bfloat16
template <class T>
__host__ __device__ inline int stem_smem_bytes(int ci, int wgs) {
  return sizeof(T) == 4 ? smem_floats(ci, wgs) * 4 : smem_bytes_bf16(ci, wgs);
}

// One tap of conv1 into acc, the rows' A read from the patch at pa (row r)
// and pa + one phase-plane row (r + 8). 3xTF32: four k8 steps, A split
// big/small as it is loaded, small*big, big*small, big*big each.
__device__ inline void conv1_tap(float (&acc)[24], const float* pa,
                                 const float* w1s, int tap, int tq) {
  pa += tq;
  const float* pb = pa + PH * PS;
  uint32_t ab[4][4], as[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    tc::split(pa[8 * s], ab[s][0], as[s][0]);
    tc::split(pb[8 * s], ab[s][1], as[s][1]);
    tc::split(pa[8 * s + 4], ab[s][2], as[s][2]);
    tc::split(pb[8 * s + 4], ab[s][3], as[s][3]);
  }
  tc::fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* wstep = w1s + (tap * 4 + s) * (C1 * 8);
    const uint64_t big = tc::desc_b(wstep, 128, 256);
    const uint64_t small = tc::desc_b(wstep + W1, 128, 256);
    tc::mma_n48(acc, as[s][0], as[s][1], as[s][2], as[s][3], big);
    tc::mma_n48(acc, ab[s][0], ab[s][1], ab[s][2], ab[s][3], small);
    tc::mma_n48(acc, ab[s][0], ab[s][1], ab[s][2], ab[s][3], big);
  }
  tc::commit();
  tc::wait<1>();
}

// bfloat16: two k16 steps of one product, word 8 s + t (+ 4) of the row's
// 20
__device__ inline void conv1_tap(float (&acc)[24], const __nv_bfloat16* p,
                                 const __nv_bfloat16* w1s, int tap, int tq) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(p) + tq;
  const uint32_t* pb = pa + PH * PSB / 2;
  uint32_t a[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    a[s][0] = pa[8 * s];
    a[s][1] = pb[8 * s];
    a[s][2] = pa[8 * s + 4];
    a[s][3] = pb[8 * s + 4];
  }
  tc::fence();
#pragma unroll
  for (int s = 0; s < 2; ++s)
    tc::mma_bf16_n48(acc, a[s][0], a[s][1], a[s][2], a[s][3],
                     tc::desc_b(w1s + (tap * 2 + s) * (C1 * 16), 128, 256));
  tc::commit();
  tc::wait<1>();
}

// a pooled float32 sum plus the bias, through ReLU; bfloat16: the pooled
// sum rounded, the bias add rounded (both roundings are monotone, so this
// is the pool of the rounded values), ReLU
__device__ inline float conv1_out(float m, float b, float) {
  return fmaxf(m + b, 0.f);
}
__device__ inline float conv1_out(float m, float b, __nv_bfloat16) {
  return fmaxf(tc::bf16r(tc::bf16r(m) + b), 0.f);
}

// The pool's route of a window and channel (conv_bwd: phase): the first
// maximum in raster order of the values the pool compares, or 4 where the
// pooled output is not positive (ReLU passes no gradient). float32 pools
// the sums (the bias added after), bfloat16 the sums rounded, the bias
// added and rounded again, as the twin pools the rounded values (equal
// roundings tie there). The lane with g even holds window positions 0 (row
// r) and 2 (row r + 8), the lane l ^ 4 positions 1 and 3. A tile's
// epilogue notes what its routes need (Pool); route_flush derives and
// stores them while the next tile's conv1 runs on the tensor cores, where
// the CUDA cores wait.
template <class T>
struct Pool;
// float32: bits 2 j + e of whether this lane's top (T) and bottom (B) sum
// is the window's maximum, and whether the pooled output is positive
template <>
struct Pool<float> {
  uint32_t top, bottom, pos;
};
// bfloat16: the keys round(round(s) + bias) of this lane's top and bottom
// and the pooled outputs, channel pairs as bfloat162 words
template <>
struct Pool<__nv_bfloat16> {
  uint32_t top[6], bottom[6], out[6];
};

// float32: the pooling epilogue of channel pair j (acc rows r, r + 8 of
// columns 8 j + 2 tq + e) as it always ran, plus the route's bits
__device__ inline void pool_pair(const float (&acc)[24], int j, float b0,
                                 float b1, uint32_t, float (&m)[2],
                                 Pool<float>& p, bool route) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float t = acc[4 * j + e], b = acc[4 * j + 2 + e];
    const float v = fmaxf(t, b);
    const float top = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
    m[e] = conv1_out(top, e ? b1 : b0, float());
    if (route) {
      const int bit = 2 * j + e;
      p.top |= (uint32_t)(t == top) << bit;
      p.bottom |= (uint32_t)(b == top) << bit;
      p.pos |= (uint32_t)(m[e] > 0.f) << bit;
    }
  }
}
// bfloat16 without the routes: as it always ran. With them: the keys
// of the top and bottom values two at a time in bfloat162 (bias2 the
// pair's biases, exact in bfloat16; the sum of two bfloat16 values rounds
// once to what their float sum rounds to, so each key equals the float
// path's), the window's maximum key and the output from them (the maximum
// of the rounded values is the rounded maximum: the same bits)
__device__ inline void pool_pair(const float (&acc)[24], int j, float b0,
                                 float b1, uint32_t bias2, float (&m)[2],
                                 Pool<__nv_bfloat16>& p, bool route) {
  if (!route) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = fmaxf(acc[4 * j + e], acc[4 * j + 2 + e]);
      m[e] = conv1_out(fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4)),
                       e ? b1 : b0, __nv_bfloat16());
    }
    return;
  }
  const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&bias2);
  const __nv_bfloat162 kt =
      __hadd2(__floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]), c);
  const __nv_bfloat162 kb =
      __hadd2(__floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]), c);
  const __nv_bfloat162 own = __hmax2(kt, kb);
  const uint32_t own_w = *reinterpret_cast<const uint32_t*>(&own);
  const uint32_t par_w = __shfl_xor_sync(0xffffffffu, own_w, 4);
  const __nv_bfloat162 top =
      __hmax2(own, *reinterpret_cast<const __nv_bfloat162*>(&par_w));
  m[0] = fmaxf(__low2float(top), 0.f);
  m[1] = fmaxf(__high2float(top), 0.f);
  p.top[j] = *reinterpret_cast<const uint32_t*>(&kt);
  p.bottom[j] = *reinterpret_cast<const uint32_t*>(&kb);
  p.out[j] = tc::pack_bf16(m[0], m[1]);
}

// the bits of either form
__device__ inline void pool_bits(const Pool<float>& p, uint32_t& top,
                                 uint32_t& bottom, uint32_t& pos) {
  top = p.top;
  bottom = p.bottom;
  pos = p.pos;
}
__device__ inline void pool_bits(const Pool<__nv_bfloat16>& p, uint32_t& top,
                                 uint32_t& bottom, uint32_t& pos) {
  top = bottom = pos = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float t[2] = {tc::bf16_lo(p.top[j]), tc::bf16_hi(p.top[j])};
    const float b[2] = {tc::bf16_lo(p.bottom[j]), tc::bf16_hi(p.bottom[j])};
    const float o[2] = {tc::bf16_lo(p.out[j]), tc::bf16_hi(p.out[j])};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // where the output is positive it is the window's maximum key
      top |= (uint32_t)(t[e] == o[e]) << (2 * j + e);
      bottom |= (uint32_t)(b[e] == o[e]) << (2 * j + e);
      pos |= (uint32_t)(o[e] > 0.f) << (2 * j + e);
    }
  }
}

// A tile's routes (every lane of the warp calls it; one shuffle): the
// first maximum in raster order is this lane's top (0), else the partner's
// top (1), else this lane's bottom (2), else the partner's bottom (3); the
// lane with g even and its window in the image stores its 12 (j, e)
// routes at p + 8 j + e.
template <class T>
__device__ inline void route_flush(uint8_t* p, bool store, const Pool<T>& pl) {
  uint32_t top, bottom, pos;
  pool_bits(pl, top, bottom, pos);
  const uint32_t partner = __shfl_xor_sync(0xffffffffu, top, 4);
  // route bits: 1 (r0), 2 (r1), 4 (r2: no gradient)
  const uint32_t r0 = pos & ~top & (partner | ~bottom);
  const uint32_t r1 = pos & ~top & ~partner;
  const uint32_t r2 = ~pos;
  if (store) {
    // bits 4 k .. 4 k + 3 of a mask to the low bit of bytes 0-3 of word k
    // ((j, e) = (2 k, 0), (2 k, 1), (2 k + 1, 0), (2 k + 1, 1))
    auto spread = [](uint32_t m, int k) {
      return (((m >> (4 * k)) & 0xfu) * 0x204081u) & 0x01010101u;
    };
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t w = spread(r0, k) | (spread(r1, k) << 1) |
                         (spread(r2, k) << 2);
      *reinterpret_cast<uint16_t*>(p + 16 * k) = (uint16_t)w;
      *reinterpret_cast<uint16_t*>(p + 16 * k + 8) = (uint16_t)(w >> 16);
    }
  }
}

// The stem for T = float (3xTF32) or __nv_bfloat16. kOne: one input
// channel, and each thread keeps the conv0 weights of its 8 channels in
// registers for the whole run. In float32 the next tile's input window
// arrives by cp.async into the second of two buffers while this tile
// computes; in bfloat16 each warpgroup stages its tile's window itself,
// converted to float32 (cp.async moves 4 bytes at least). route, where not
// null ([B, H/8, W/8, 48] uint8; conv_bwd: phase), gets each pooled
// value's route for K1b, which then recomputes no conv1: a tile's epilogue
// notes pool_bits, and route_flush stores them while the next tile's
// conv1 products run on the tensor cores (the CUDA cores wait there).
template <class T, bool kOne>
__global__ void __launch_bounds__(256, 1)
stem_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                const T* __restrict__ b0, const T* __restrict__ w1,
                const T* __restrict__ b1, T* __restrict__ out,
                uint8_t* __restrict__ route, int H, int W, int Ci,
                int n_per_task, int blocks_per_task) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int PST = kF32 ? PS : PSB;     // patch position stride
  extern __shared__ __align__(128) unsigned char smem[];
  const int wgs = blockDim.x / 128;
  // w1 in B order (float32: big | small) | w0 [Ci * 9][C0], b0, b1 as
  // floats | float32: every warpgroup's patch, then its two input buffers;
  // bfloat16: per warpgroup its patch and one input buffer
  T* w1s = reinterpret_cast<T*>(smem);
  float* w0s = reinterpret_cast<float*>(smem + (kF32 ? 2 : 1) * W1 * sizeof(T));
  float* b0s = w0s + Ci * 9 * C0;
  float* b1s = b0s + C0;
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127;
  T* patch;                              // [4][PH][PH][PST]
  float* xbuf;
  if constexpr (kF32) {
    patch = b1s + C1 + wg * PATCH;
    xbuf = b1s + C1 + wgs * PATCH + wg * 2 * Ci * TX * TX;
  } else {
    unsigned char* wgbase =
        reinterpret_cast<unsigned char*>(b1s + C1) + wg * wg_bytes_bf16(Ci);
    patch = reinterpret_cast<T*>(wgbase);
    xbuf = reinterpret_cast<float*>(wgbase + 2 * PATCH_B);
  }

  const int Ho = H / 8, Wo = W / 8, H0 = H / 2, W0 = W / 2;
  const int tiles_y = (Ho + TP - 1) / TP, tiles_x = (Wo + TP - 1) / TP;
  const int per_image = tiles_y * tiles_x;
  const int task = blockIdx.x / blocks_per_task;
  const int chunk = blockIdx.x % blocks_per_task;
  const long long task_tiles = (long long)n_per_task * per_image;
  const long long first = task_tiles * chunk / blocks_per_task;
  const long long last = task_tiles * (chunk + 1) / blocks_per_task;

  // the task's weights, once: conv1 into wgmma B order (float32: split),
  // conv0 as [ci][kh][kw][c]
  {
    if constexpr (kF32)
      pack_conv1(w1 + (size_t)task * W1, w1s, tid, blockDim.x);
    else
      pack_conv1_bf16(w1 + (size_t)task * W1, w1s, tid, blockDim.x);
    const T* w0t = w0 + (size_t)task * C0 * Ci * 9;
    for (int i = tid; i < Ci * 9 * C0; i += blockDim.x)
      w0s[i] = tc::to_float(w0t[(i % C0) * Ci * 9 + i / C0]);
    if (tid < C0) b0s[tid] = tc::to_float(b0[task * C0 + tid]);
    if (tid < C1) b1s[tid] = tc::to_float(b1[task * C1 + tid]);
    tc::fence_async_smem();
    __syncthreads();
  }

  auto origin = [&](long long tile, int& b, int& ty, int& tx) {
    b = task * n_per_task + (int)(tile / per_image);
    const int rem = (int)(tile % per_image);
    ty = rem / tiles_x;
    tx = rem % tiles_x;
  };
  // a tile's input window into buf, zeros outside the image: float32 by
  // cp.async, bfloat16 by plain loads, converted
  auto window = [&](long long tile, float* buf) {
    int b, ty, tx;
    origin(tile, b, ty, tx);
    // first input row / col: 2 * (first conv0 row) - 1
    const int rx = 2 * (2 * ty * T1 - 1) - 1, sx = 2 * (2 * tx * T1 - 1) - 1;
    for (int i = lt; i < Ci * TX * TX; i += 128) {
      const int c = i / (TX * TX), p = i % (TX * TX);
      const int gy = rx + p / TX, gx = sx + p % TX;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      if constexpr (kF32)
        tc::cp_async4(buf + i,
                      in ? x + ((size_t)(b * H + gy) * W + gx) * Ci + c : x,
                      in);
      else
        buf[i] = in ? tc::to_float(x[((size_t)(b * H + gy) * W + gx) * Ci + c])
                    : 0.f;
    }
  };

  const int warp = lt >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int bar_id = 1 + wg, cg = lt & 3;
  float w0r[kOne ? 9 * 8 : 1];
  if constexpr (kOne) {
#pragma unroll
    for (int i = 0; i < 9 * 8; ++i) w0r[i] = w0s[(i / 8) * C0 + 8 * cg + i % 8];
  }

  long long tile = first + wg;
  if constexpr (kF32) {
    if (tile < last) window(tile, xbuf);
    tc::cp_async_commit();
  }
  // the previous tile's routes, stored during this tile's conv1; bfloat16:
  // the channel pairs' biases as bfloat162 words
  Pool<T> pool;
  uint8_t* route_at = nullptr;
  bool pending = false, route_store = false;
  uint32_t bias2[6];
#pragma unroll
  for (int j = 0; j < 6; ++j)
    bias2[j] = tc::pack_bf16(b1s[8 * j + 2 * tq], b1s[8 * j + 2 * tq + 1]);
  for (int i = 0; tile < last; ++i, tile += wgs) {
    if constexpr (kF32) {
      if (tile + wgs < last)
        window(tile + wgs, xbuf + ((i + 1) & 1) * Ci * TX * TX);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
      // this tile's input has landed; the previous tile's patch reads are
      // done
      tc::named_sync(bar_id, 128);
    } else {
      // the previous tile's reads of the window and the patch are done
      tc::named_sync(bar_id, 128);
      window(tile, xbuf);
      tc::named_sync(bar_id, 128);
    }

    int b, ty, tx;
    origin(tile, b, ty, tx);
    const float* xs = xbuf + (kF32 ? (i & 1) * Ci * TX * TX : 0);
    const int r0 = 2 * ty * T1 - 1, s0 = 2 * tx * T1 - 1;   // first conv0 row / col

    // conv0 + bias + ReLU over the 17x17 patch (stem_tile.cuh; K1b runs
    // the same function for its masks)
    conv0_patch<T, kOne>(xs, patch, w0s, b0s, w0r, Ci, r0, s0, H0, W0, lt,
                         128);
    tc::named_sync(bar_id, 128);

    // conv1: row r = 16 warp + g is pixel (2 warp, g), row r + 8 is
    // (2 warp + 1, g); tap (kh, kw) reads conv0 local (2 py + kh, 2 px + kw),
    // phase (kh & 1, kw & 1) at plane (py + kh / 2, px + kw / 2)
    float acc[24];
#pragma unroll
    for (int j = 0; j < 24; ++j) acc[j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      conv1_tap(acc, patch + (((kh & 1) * 2 + (kw & 1)) * PH * PH +
                              (2 * warp + (kh >> 1)) * PH + g + (kw >> 1)) * PST,
                w1s, tap, tq);
      if (tap == 0 && pending) {
        route_flush(route_at, route_store, pool);
        pending = false;
      }
    }
    tc::wait<0>();
    tc::pin(acc);

    // bias + ReLU + 2x2 pool: rows r, r + 8 in this thread, columns g, g ^ 1
    // in lanes l, l ^ 4
    const int oy = ty * TP + warp, ox = tx * TP + (g >> 1);
    const bool store = (g & 1) == 0 && oy < Ho && ox < Wo;
    const size_t at = ((size_t)(b * Ho + oy) * Wo + ox) * C1 + 2 * tq;
    T* o = out + at;
    if (route != nullptr) pool = Pool<T>{};   // the bits are or-ed in
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float m[2];
      pool_pair(acc, j, b1s[8 * j + 2 * tq], b1s[8 * j + 2 * tq + 1],
                bias2[j], m, pool, route != nullptr);
      if (store) tc::store2(o + 8 * j, m[0], m[1]);
    }
    if (route != nullptr) {
      route_at = route + at;
      route_store = store;
      pending = true;
    }
  }
  if (pending) route_flush(route_at, route_store, pool);
  if constexpr (kF32) tc::cp_async_wait<0>();
}

}  // namespace

extern "C" int wmfml_stem_smem_bytes(int ci, int wgs) {
  return stem_smem_bytes<float>(ci, wgs);
}

extern "C" int wmfml_stem_smem_bytes_bf16(int ci, int wgs) {
  return stem_smem_bytes<__nv_bfloat16>(ci, wgs);
}

// The conv1 packing alone (for tests): w1 [T,48,32,3,3] -> dst [T,2,48*288]
// f32, big | small in wgmma B order, or (bf16) [T,1,48*288] bf16 in its
// wgmma B order.
extern "C" int wmfml_stem_pack(const void* w1, void* dst, int T, int bf16,
                               void* stream) {
  if (bf16)
    pack_bf16_kernel<<<T, 256, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(w1), static_cast<__nv_bfloat16*>(dst));
  else
    pack_kernel<<<T, 256, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(w1), static_cast<float*>(dst));
  return (int)cudaGetLastError();
}

// x [B,H,W,Ci]; with T = B / n_per_task tasks: w0 [T,32,Ci,3,3]; b0 [T,32];
// w1 [T,48,32,3,3]; b1 [T,48] (torch OIHW; T = 1, n_per_task = B for
// weights shared by the batch); out [B,H/8,W/8,48]; route null, or
// [B,H/8,W/8,48] uint8 for the pool's routes. All contiguous on the
// device, f32, or bf16 when bf16 is set. Returns the cudaError_t of the
// launch.
template <class T, class Kernel>
int launch_stem(Kernel kernel, int smem, int wgs, const T* x, const T* w0,
                const T* b0, const T* w1, const T* b1, T* out, uint8_t* route,
                int B, int H, int W, int Ci, int n_per_task,
                cudaStream_t stream) {
  const int threads = 128 * wgs;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tasks = B / n_per_task;
  const int tiles = n_per_task * ((H / 8 + TP - 1) / TP) * ((W / 8 + TP - 1) / TP);
  int bpt = per_sm * sms / tasks;
  bpt = bpt < 1 ? 1 : (bpt > tiles ? tiles : bpt);
  kernel<<<tasks * bpt, threads, smem, stream>>>(
      x, w0, b0, w1, b1, out, route, H, W, Ci, n_per_task, bpt);
  return (int)cudaGetLastError();
}

// launch_stem with the kernel for T and Ci, on two warpgroups where their
// shared memory fits, else one
template <class T>
int run_stem(const void* x, const void* w0, const void* b0, const void* w1,
             const void* b1, void* out, void* route, int B, int H, int W,
             int Ci, int n_per_task, cudaStream_t s) {
  const int wgs = stem_smem_bytes<T>(Ci, 2) <= MAX_SMEM ? 2 : 1;
  return launch_stem(Ci == 1 ? stem_fwd_kernel<T, true> : stem_fwd_kernel<T, false>,
                     stem_smem_bytes<T>(Ci, wgs), wgs, static_cast<const T*>(x),
                     static_cast<const T*>(w0), static_cast<const T*>(b0),
                     static_cast<const T*>(w1), static_cast<const T*>(b1),
                     static_cast<T*>(out), static_cast<uint8_t*>(route), B, H,
                     W, Ci, n_per_task, s);
}

extern "C" int wmfml_stem_fwd(const void* x, const void* w0, const void* b0,
                              const void* w1, const void* b1, void* out,
                              void* route, int B, int H, int W, int Ci,
                              int n_per_task, int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return run_stem<__nv_bfloat16>(x, w0, b0, w1, b1, out, route, B,
                                           H, W, Ci, n_per_task, s);
  return run_stem<float>(x, w0, b0, w1, b1, out, route, B, H, W, Ci,
                         n_per_task, s);
}
