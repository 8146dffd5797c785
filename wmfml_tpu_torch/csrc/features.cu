// MAML features block, per task: L x { 3x3 stride-1 same conv (64 -> 64,
// per-task weights and bias), batch-statistics BN over the task's real
// context rows (one pass: E[x^2] - E[x]^2 in f32, var clamped at 0, eps),
// shared scale/bias, ReLU }. NHWC f32 in and out: [T, N, H, W, 64].
//
// Replaces scripts/proto_maml_pallas_conv.py:96 features_block_pallas
// (pl.pallas_call at :108, body features_block_kernel at :37), which
// computes layers 2-4 of wmfml_tpu/models/maml.py:106-120 for one task per
// grid step with the whole task resident in VMEM. Two additions the MAML
// path needs and the prototype lacks: the conv bias, and the context mask
// (statistics over the task's real rows only; padded rows are still
// normalised and passed on). The 1 -> 64 lift of layer 1 stays outside.
//
// Bound: at T=10, N=15, 14x14, L=3 the block does 6.50 GFLOP (0.097 ms at
// 67 TFLOP/s f32) and must move ~20 MB (0.006 ms at 3.35 TB/s), so it is
// bound by f32 arithmetic.
//
// Why the TPU design does not carry over: one task's activation (2940 x 64
// x 4 B = 753 KB) exceeds a block's 227 KB of shared memory, and BN needs
// the whole task's statistics before any row can be normalised. So:
//   * one launch per layer; a block takes a band of rows of one image
//     (<= 128 pixels) for all 64 output channels, staged 16 input channels
//     at a time (weights [16][9][64] and the input band with its halo);
//   * on load it applies the PREVIOUS layer's BN + ReLU to its input band,
//     reducing that task's per-block partial sums in a fixed order first;
//   * conv + bias with f32 FMAs: one warp per 8 output channels, one lane
//     per pixel column of 4 pixels (32 accumulators), weights read as
//     warp-wide broadcasts;
//   * it writes the pre-BN output and its per-channel sum and sum of
//     squares (masked rows only; warp butterfly, fixed order) to scratch;
//   * one epilogue launch applies the last BN + ReLU.
// No atomics: two runs agree bit for bit. Tensor cores, TMA and clusters
// (a cluster of 8 could hold a whole task in distributed shared memory) are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int C = 64;              // channels in and out
constexpr int THREADS = 256;
constexpr int CG = 8;              // output channels per warp
constexpr int PPT = 4;             // pixels per lane
constexpr int CK = 16;             // input channels staged per chunk
static_assert(THREADS / 32 * CG == C, "8 warps x 8 output channels");
static_assert(C % CK == 0, "whole chunks");

__host__ __device__ inline int conv_smem_floats(int W, int TR) {
  // weights chunk | input band chunk with halo | mean, rstd, scale, bias
  return CK * 9 * C + CK * (TR + 2) * (W + 2) + 4 * C;
}

// BN statistics of task t from the partial sums [T][N*NB][2][C] of the
// layer before, summed in a fixed order; threads 0..C-1 write mean, rstd,
// scale and bias of their channel to bn[0..4C).
__device__ void load_bn(const float* __restrict__ part,
                        const unsigned char* __restrict__ mask,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, int t, int N, int NB,
                        int HW, float eps, float* bn) {
  const int c = threadIdx.x;
  if (c >= C) return;
  int rows = N;
  if (mask != nullptr) {
    rows = 0;
    for (int n = 0; n < N; ++n) rows += mask[t * N + n] != 0;
  }
  const float denom = fmaxf((float)rows * (float)HW, 1.f);
  const float* p = part + (size_t)t * N * NB * 2 * C;
  float s1 = 0.f, s2 = 0.f;
  for (int j = 0; j < N * NB; ++j) {
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

// One layer: out = conv(act(in)) + bias, with act = BN + ReLU of the layer
// before (part_in != nullptr) or the identity (the block's first layer).
// Grid: T * N * NB blocks, block (t, n, band) covers rows
// [band * TR, band * TR + TR) of image n of task t.
__global__ void __launch_bounds__(THREADS)
conv_kernel(const float* __restrict__ in, const float* __restrict__ w,
            long long w_task_stride, const float* __restrict__ bias,
            int bias_task_stride, const float* __restrict__ part_in,
            const float* __restrict__ scale_in,
            const float* __restrict__ bias_in,
            const unsigned char* __restrict__ mask, float* __restrict__ out,
            float* __restrict__ part_out, int N, int H, int W, int TR, int NB,
            float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int HX = TR + 2, WX = W + 2;
  float* ws = smem;                      // [CK][3][3][C]
  float* xs = ws + CK * 9 * C;           // [CK][HX][WX]
  float* bn = xs + CK * HX * WX;         // [4][C]

  const int band = blockIdx.x % NB;
  const int n = (blockIdx.x / NB) % N;
  const int t = blockIdx.x / (NB * N);
  const int r0 = band * TR;
  const int npix = min(TR, H - r0) * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool act = part_in != nullptr;
  if (act) load_bn(part_in, mask, scale_in, bias_in, t, N, NB, H * W, eps, bn);

  int off[PPT];                          // pixel -> halo-band offset
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = min(lane + 32 * k, npix - 1);
    off[k] = (p / W) * WX + p % W;
  }
  float acc[PPT][CG];
#pragma unroll
  for (int j = 0; j < CG; ++j) {
    const float b = bias[(size_t)t * bias_task_stride + warp * CG + j];
#pragma unroll
    for (int k = 0; k < PPT; ++k) acc[k][j] = b;
  }

  const float* img = in + (size_t)(t * N + n) * H * W * C;
  const float* wt = w + (size_t)t * w_task_stride;
  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // BN stats written; previous chunk's reads done
    const float4* wsrc = reinterpret_cast<const float4*>(wt + (size_t)c0 * 9 * C);
    float4* wdst = reinterpret_cast<float4*>(ws);
    for (int i = tid; i < CK * 9 * C / 4; i += THREADS) wdst[i] = wsrc[i];
    for (int i = tid; i < CK * HX * WX; i += THREADS) {
      const int cc = i % CK, pos = i / CK;
      const int gy = r0 - 1 + pos / WX, gx = pos % WX - 1;
      float v = 0.f;                     // zero padding of the activated map
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = img[((size_t)gy * W + gx) * C + c0 + cc];
        if (act) v = bn_relu(v, bn, c0 + cc);
      }
      xs[cc * HX * WX + pos] = v;
    }
    __syncthreads();

    for (int cc = 0; cc < CK; ++cc) {
      const float* xc = xs + cc * HX * WX;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4* wp = reinterpret_cast<const float4*>(
              ws + ((cc * 3 + kh) * 3 + kw) * C + warp * CG);
          const float4 wa = wp[0], wb = wp[1];
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            const float a = xc[off[k] + kh * WX + kw];
            acc[k][0] = fmaf(a, wa.x, acc[k][0]);
            acc[k][1] = fmaf(a, wa.y, acc[k][1]);
            acc[k][2] = fmaf(a, wa.z, acc[k][2]);
            acc[k][3] = fmaf(a, wa.w, acc[k][3]);
            acc[k][4] = fmaf(a, wb.x, acc[k][4]);
            acc[k][5] = fmaf(a, wb.y, acc[k][5]);
            acc[k][6] = fmaf(a, wb.z, acc[k][6]);
            acc[k][7] = fmaf(a, wb.w, acc[k][7]);
          }
        }
      }
    }
  }

  // pre-BN output and this block's per-channel sums
  float* dst = out + ((size_t)(t * N + n) * H + r0) * W * C + warp * CG;
  float s1[CG], s2[CG];
#pragma unroll
  for (int j = 0; j < CG; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = lane + 32 * k;
    if (p < npix) {
      float4* o = reinterpret_cast<float4*>(dst + (size_t)p * C);
      o[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      o[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        s1[j] += acc[k][j];
        s2[j] = fmaf(acc[k][j], acc[k][j], s2[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CG; ++j) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], m);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], m);
    }
  }
  if (lane == 0) {
    const bool counted = mask == nullptr || mask[t * N + n] != 0;
    float* p = part_out + ((size_t)(t * N + n) * NB + band) * 2 * C + warp * CG;
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      p[j] = counted ? s1[j] : 0.f;
      p[C + j] = counted ? s2[j] : 0.f;
    }
  }
}

// Epilogue: out = ReLU(BN(y)) with the last layer's statistics; one block
// per image.
__global__ void __launch_bounds__(THREADS)
bn_relu_kernel(const float* __restrict__ y, const float* __restrict__ part,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const unsigned char* __restrict__ mask, float* __restrict__ out,
               int N, int H, int W, int NB, float eps) {
  __shared__ float bn[4 * C];
  const int t = blockIdx.x / N;
  load_bn(part, mask, scale, bias, t, N, NB, H * W, eps, bn);
  __syncthreads();
  const size_t base = (size_t)blockIdx.x * H * W * C;
  for (int i = threadIdx.x; i < H * W * C; i += THREADS)
    out[base + i] = bn_relu(y[base + i], bn, i % C);
}

}  // namespace

extern "C" int wmfml_features_smem_bytes(int W, int TR) {
  return conv_smem_floats(W, TR) * (int)sizeof(float);
}

// x [T,N,H,W,64]; w [T,L,64(in),3,3,64(out)]; b [T,L,64]; scale, bias
// [L,64]; mask [T,N] uint8 or null (every row counts); y0, y1 scratch like
// x; part scratch [L,T,N*NB,2,64] with NB = ceil(H / TR); out like x. All
// contiguous f32 on the device, w 16-byte aligned. Returns the first
// cudaError_t of the L + 1 launches.
extern "C" int wmfml_features_fwd(const float* x, const float* w,
                                  const float* b, const float* scale,
                                  const float* bias,
                                  const unsigned char* mask, float* y0,
                                  float* y1, float* part, float* out, int T,
                                  int N, int H, int W, int L, int TR,
                                  float eps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int NB = (H + TR - 1) / TR;
  const int smem = wmfml_features_smem_bytes(W, TR);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t part_layer = (size_t)T * N * NB * 2 * C;
  float* ys[2] = {y0, y1};
  for (int l = 0; l < L; ++l) {
    const bool first = l == 0;
    conv_kernel<<<T * N * NB, THREADS, smem, s>>>(
        first ? x : ys[(l + 1) % 2], w + (size_t)l * C * 9 * C,
        (long long)L * C * 9 * C, b + l * C, L * C,
        first ? nullptr : part + (l - 1) * part_layer,
        first ? nullptr : scale + (l - 1) * C,
        first ? nullptr : bias + (l - 1) * C, mask, ys[l % 2],
        part + l * part_layer, N, H, W, TR, NB, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bn_relu_kernel<<<T * N, THREADS, 0, s>>>(
      ys[(L - 1) % 2], part + (L - 1) * part_layer, scale + (L - 1) * C,
      bias + (L - 1) * C, mask, out, N, H, W, NB, eps);
  return (int)cudaGetLastError();
}
