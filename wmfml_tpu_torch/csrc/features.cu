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

#include <cuda_runtime.h>

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
// ring of weight stages | 2 mbarriers (16 B) | bn [4][C] | staged pixels
__host__ __device__ inline int conv_smem_bytes(int W) {
  return 2 * STAGE * 4 + 16 + 4 * C * 4 + staged_pixels(W) * AS * 4;
}

// BN statistics of task t from the per-tile partial sums [T][tiles][2][C]
// of the layer before, summed in a fixed order; threads 0..C-1 write mean,
// rstd, scale and bias of their channel to bn[0..4C).
__device__ void load_bn(const float* __restrict__ part,
                        const unsigned char* __restrict__ mask,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, int t, int N,
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
  bn[c] = mean;
  bn[C + c] = rsqrtf(var + eps);
  bn[2 * C + c] = scale[c];
  bn[3 * C + c] = bias[c];
}

__device__ inline float bn_relu(float v, const float* bn, int c) {
  return fmaxf((v - bn[c]) * bn[C + c] * bn[2 * C + c] + bn[3 * C + c], 0.f);
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

cudaError_t pack(const float* w, float* wk, int TL, cudaStream_t s) {
  const long long n = (long long)TL * TAPS * TAP;
  pack_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(w, wk, TL);
  return cudaGetLastError();
}

// One layer: out = conv(act(in)) + bias, with act = BN + ReLU of the layer
// before (part_in != nullptr) or the identity (the block's first layer).
// Grid: T * tiles blocks; block (t, tile) covers pixel rows
// [tile * TILE, tile * TILE + TILE) of task t's N*H*W rows.
__global__ void __launch_bounds__(THREADS, 2)
conv_kernel(const float* __restrict__ in, const float* __restrict__ wk,
            long long w_task_stride, const float* __restrict__ bias,
            int bias_task_stride, const float* __restrict__ part_in,
            const float* __restrict__ scale_in,
            const float* __restrict__ bias_in,
            const unsigned char* __restrict__ mask, float* __restrict__ out,
            float* __restrict__ part_out, int N, int H, int W, int tiles,
            float eps) {
  extern __shared__ __align__(128) float smem[];
  float* ws = smem;                                      // [2][STAGE]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * STAGE);
  float* bn = smem + 2 * STAGE + 4;                      // [4][C]
  float* xs = bn + 4 * C;                                // [SP][AS]

  const int tid = threadIdx.x;
  const int t = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int HW = H * W, P = N * HW;
  const int p0 = tile * TILE, lo = p0 - (W + 1), SP = staged_pixels(W);
  const float* wt = wk + (size_t)t * w_task_stride;
  const bool act = part_in != nullptr;

  if (tid == 0) {
    tc::bar_init(&bars[0], 1);
    tc::bar_init(&bars[1], 1);
    tc::bar_init_fence();
  }
  if (act) load_bn(part_in, mask, scale_in, bias_in, t, N, tiles, HW, eps, bn);
  __syncthreads();
  if (tid == 0) {
    tc::bulk_load(ws, wt, STAGE * 4, &bars[0]);
    tc::bulk_load(ws + STAGE, wt + STAGE, STAGE * 4, &bars[1]);
  }

  // stage the reachable pixels, activated; rows outside the task are 0 and
  // never read (their taps are predicated off)
  const float* src = in + (size_t)t * P * C;
  for (int i = tid; i < SP * (C / 4); i += THREADS) {
    const int q = i / (C / 4), c4 = (i % (C / 4)) * 4;
    const int p = lo + q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p >= 0 && p < P) {
      v = *reinterpret_cast<const float4*>(src + (size_t)p * C + c4);
      if (act) {
        v.x = bn_relu(v.x, bn, c4);
        v.y = bn_relu(v.y, bn, c4 + 1);
        v.z = bn_relu(v.z, bn, c4 + 2);
        v.w = bn_relu(v.w, bn, c4 + 3);
      }
    }
    *reinterpret_cast<float4*>(xs + q * AS + c4) = v;
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
    const float* xa = xs + (r0 + W + 1 + dy * W + dx) * AS + tq;
    const float* xb = xa + 8 * AS;
    const float* wb = ws + (tap & 1) * STAGE;
    tc::bar_wait(&bars[tap & 1], (tap >> 1) & 1);
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
      if (half == 0) {
        // every warpgroup is done with tap - 1's stage: refill it
        __syncthreads();
        if (tid == 0 && tap >= 1 && tap + 1 < TAPS)
          tc::bulk_load(ws + ((tap + 1) & 1) * STAGE, wt + (tap + 1) * STAGE,
                        STAGE * 4, &bars[(tap + 1) & 1]);
      }
    }
  }
  tc::wait<0>();
  tc::pin(acc);

  // bias, pre-BN output, and this tile's per-channel sums over counted rows
  const float* bt = bias + (size_t)t * bias_task_stride;
  float* dst = out + ((size_t)t * P + p0 + r0) * C;
  bool counted[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    counted[h] = valid[h] &&
                 (mask == nullptr || mask[t * N + (p0 + r0 + 8 * h) / HW] != 0);
  float s1[16], s2[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float b0 = bt[c], b1 = bt[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      if (valid[h])
        *reinterpret_cast<float2*>(dst + 8 * h * C + c) = make_float2(v0, v1);
      const float u0 = counted[h] ? v0 : 0.f, u1 = counted[h] ? v1 : 0.f;
      if (h == 0) {
        s1[2 * j] = u0; s1[2 * j + 1] = u1;
        s2[2 * j] = u0 * u0; s2[2 * j + 1] = u1 * u1;
      } else {
        s1[2 * j] += u0; s1[2 * j + 1] += u1;
        s2[2 * j] = fmaf(u0, u0, s2[2 * j]);
        s2[2 * j + 1] = fmaf(u1, u1, s2[2 * j + 1]);
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
  float* red = xs;                 // [warp][2][C]
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
__global__ void __launch_bounds__(256)
bn_relu_kernel(const float* __restrict__ y, const float* __restrict__ part,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const unsigned char* __restrict__ mask, float* __restrict__ out,
               int N, int H, int W, int tiles, float eps) {
  __shared__ float bn[4 * C];
  const int t = blockIdx.x / N;
  load_bn(part, mask, scale, bias, t, N, tiles, H * W, eps, bn);
  __syncthreads();
  const size_t base = (size_t)blockIdx.x * H * W * C;
  const float4* src = reinterpret_cast<const float4*>(y + base);
  float4* dst = reinterpret_cast<float4*>(out + base);
  for (int i = threadIdx.x; i < H * W * C / 4; i += blockDim.x) {
    const int c = (i % (C / 4)) * 4;
    float4 v = src[i];
    v.x = bn_relu(v.x, bn, c);
    v.y = bn_relu(v.y, bn, c + 1);
    v.z = bn_relu(v.z, bn, c + 2);
    v.w = bn_relu(v.w, bn, c + 3);
    dst[i] = v;
  }
}

}  // namespace

extern "C" int wmfml_features_smem_bytes(int W) { return conv_smem_bytes(W); }

// The weight packing alone (for tests): w [T,L,64,64,3,3] -> wk
// [T,L,9,2,64*64].
extern "C" int wmfml_features_pack(const float* w, float* wk, int TL,
                                   void* stream) {
  return (int)pack(w, wk, TL, (cudaStream_t)stream);
}

// x [T,N,H,W,64]; w [T,L,64(out),64(in),3,3]; wk scratch [T,L,9,2,64*64]
// for the packed weights; b [T,L,64]; scale, bias [L,64]; mask [T,N] one
// byte each (0 = padded row) or null (every row counts); y0, y1 scratch
// like x; part scratch [L,T,tiles,2,64] with tiles = ceil(N*H*W / 128); out
// like x. All contiguous on the device, x and wk 16-byte aligned. Returns
// the first cudaError_t of the L + 2 launches.
extern "C" int wmfml_features_fwd(const float* x, const float* w, float* wk,
                                  const float* b, const float* scale,
                                  const float* bias,
                                  const unsigned char* mask, float* y0,
                                  float* y1, float* part, float* out, int T,
                                  int N, int H, int W, int L, float eps,
                                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (N * H * W + TILE - 1) / TILE;
  const int smem = conv_smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = pack(w, wk, T * L, s)) != cudaSuccess) return (int)err;
  const size_t part_layer = (size_t)T * tiles * 2 * C;
  float* ys[2] = {y0, y1};
  for (int l = 0; l < L; ++l) {
    const bool first = l == 0;
    conv_kernel<<<T * tiles, THREADS, smem, s>>>(
        first ? x : ys[(l + 1) % 2], wk + (size_t)l * TAPS * STAGE,
        (long long)L * TAPS * STAGE, b + l * C, L * C,
        first ? nullptr : part + (l - 1) * part_layer,
        first ? nullptr : scale + (l - 1) * C,
        first ? nullptr : bias + (l - 1) * C, mask, ys[l % 2],
        part + l * part_layer, N, H, W, tiles, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bn_relu_kernel<<<T * N, 256, 0, s>>>(
      ys[(L - 1) % 2], part + (L - 1) * part_layer, scale + (L - 1) * C,
      bias + (L - 1) * C, mask, out, N, H, W, tiles, eps);
  return (int)cudaGetLastError();
}
