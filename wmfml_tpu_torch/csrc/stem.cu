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
// and must move only ~34 MB (input + output + weights), so it is bound by
// f32 arithmetic on the CUDA cores (~0.14 ms at 67 TFLOP/s), not by bytes.
//
// Design: one block per (image, 4x4 tile of pool outputs), walked by a
// persistent grid; each block takes one contiguous run of tiles, so it
// stages the conv1 weights (55 KB) in shared memory once when the weights
// are shared, and again only when its run crosses into the next task when
// they are per task (MAML's inner loop: image b uses task b / n_per_task;
// a run of ~9 tiles crosses at most one task boundary at T=10, N=15).
// For its tile the block computes the 17x17x32 conv0 patch it
// needs into shared memory (in 2x2 phase layout, so conv1's stride-2 reads
// hit consecutive banks), then 8x8x48 conv1 outputs (one pixel x 12 output
// channels per thread; the weight reads are warp-wide broadcasts), then the
// pool. The conv0 map never touches device memory. No tensor cores: this is
// the simple f32 form; wgmma is later work.

#include <cuda_runtime.h>

namespace {

constexpr int C0 = 32;             // conv0 output channels
constexpr int C1 = 48;             // conv1 output channels
constexpr int TP = 4;              // pool outputs per tile side
constexpr int T1 = 2 * TP;         // conv1 outputs per tile side (8)
constexpr int T0 = 2 * T1 + 1;     // conv0 outputs per tile side (17)
constexpr int TX = 2 * T0 + 1;     // input pixels per tile side (35)
constexpr int PH = (T0 + 1) / 2;   // side of one conv0 phase plane (9)
constexpr int THREADS = 256;
constexpr int CG = 12;             // conv1 channels per thread
static_assert(C1 == CG * 4, "4 channel groups of 12");
static_assert(THREADS == 4 * T1 * T1, "one thread per (pixel, channel group)");

__host__ __device__ inline int smem_floats(int ci) {
  // w1 | w0 | b0 | b1 | x tile | conv0 patch (conv1 tile aliases it)
  return C0 * 9 * C1 + ci * 9 * C0 + C0 + C1 + ci * TX * TX + C0 * 4 * PH * PH;
}

__global__ void __launch_bounds__(THREADS)
stem_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ b1, float* __restrict__ out,
                int B, int H, int W, int Ci, int n_per_task) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w1s = smem;                    // [C0*9][C1]  (ci, kh, kw) major
  float* w0s = w1s + C0 * 9 * C1;       // [Ci*9][C0]
  float* b0s = w0s + Ci * 9 * C0;
  float* b1s = b0s + C0;
  float* xs = b1s + C1;                 // [Ci][TX][TX]
  float* a0s = xs + Ci * TX * TX;       // [C0][2][2][PH][PH]
  float* a1s = a0s;                     // [C1][T1][T1] after conv1

  const int tid = threadIdx.x;
  const int H0 = H / 2, W0 = W / 2, Ho = H / 8, Wo = W / 8;
  const int tiles_y = (Ho + TP - 1) / TP, tiles_x = (Wo + TP - 1) / TP;
  const long long ntiles = (long long)B * tiles_y * tiles_x;
  const long long per_block = (ntiles + gridDim.x - 1) / gridDim.x;
  const long long first = (long long)blockIdx.x * per_block;
  const long long last = first + per_block < ntiles ? first + per_block : ntiles;

  const int warp = tid >> 5, lane = tid & 31;
  const int cg = warp >> 1;                       // channel group 0..3
  const int pix = (warp & 1) * 32 + lane;         // conv1 pixel 0..63
  const int py = pix / T1, px = pix % T1;

  int staged = -1;                                // task whose weights are in smem
  for (long long tile = first; tile < last; ++tile) {
    const int b = (int)(tile / (tiles_y * tiles_x));
    const int rem = (int)(tile % (tiles_y * tiles_x));
    const int ty = rem / tiles_x, tx = rem % tiles_x;
    const int r1 = ty * T1, s1 = tx * T1;         // first conv1 row / col
    const int r0 = 2 * r1 - 1, s0 = 2 * s1 - 1;   // first conv0 row / col
    const int rx = 2 * r0 - 1, sx = 2 * s0 - 1;   // first input row / col

    // (re)stage the task's weights; uniform over the block. The previous
    // tile's last weight read (conv1) is behind the __syncthreads() that
    // follows it, so no thread still reads the old weights.
    const int task = b / n_per_task;
    if (task != staged) {
      const float* w1t = w1 + (size_t)task * C0 * 9 * C1;
      const float* w0t = w0 + (size_t)task * Ci * 9 * C0;
      for (int i = tid; i < C0 * 9 * C1; i += THREADS) w1s[i] = w1t[i];
      for (int i = tid; i < Ci * 9 * C0; i += THREADS) w0s[i] = w0t[i];
      if (tid < C0) b0s[tid] = b0[task * C0 + tid];
      if (tid < C1) b1s[tid] = b1[task * C1 + tid];
      staged = task;
    }

    __syncthreads();  // weights staged; previous tile's pool reads done
    for (int i = tid; i < Ci * TX * TX; i += THREADS) {
      const int c = i / (TX * TX), p = i % (TX * TX);
      const int gy = rx + p / TX, gx = sx + p % TX;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = x[((size_t)(b * H + gy) * W + gx) * Ci + c];
      xs[i] = v;
    }
    __syncthreads();

    // conv0 + bias + ReLU over the 17x17 patch; positions outside the map
    // are conv1's zero padding (not relu(bias))
    for (int i = tid; i < C0 * T0 * T0; i += THREADS) {
      const int c = i / (T0 * T0), p = i % (T0 * T0);
      const int ly = p / T0, lx = p % T0;
      const int gy = r0 + ly, gx = s0 + lx;
      float acc = 0.f;
      if (gy >= 0 && gy < H0 && gx >= 0 && gx < W0) {
        acc = b0s[c];
        for (int ci = 0; ci < Ci; ++ci)
#pragma unroll
          for (int kh = 0; kh < 3; ++kh)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw)
              acc = fmaf(xs[(ci * TX + 2 * ly + kh) * TX + 2 * lx + kw],
                         w0s[((ci * 3 + kh) * 3 + kw) * C0 + c], acc);
        acc = fmaxf(acc, 0.f);
      }
      a0s[((c * 4 + (ly & 1) * 2 + (lx & 1)) * PH + (ly >> 1)) * PH +
          (lx >> 1)] = acc;
    }
    __syncthreads();

    // conv1: pixel (py, px) reads conv0 local row 2*py + kh, which is phase
    // kh & 1 at plane row py + (kh >> 1)
    float acc[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[j] = b1s[cg * CG + j];
    for (int c = 0; c < C0; ++c) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float a =
              a0s[((c * 4 + (kh & 1) * 2 + (kw & 1)) * PH + py + (kh >> 1)) *
                      PH + px + (kw >> 1)];
          const float4* wp = reinterpret_cast<const float4*>(
              w1s + ((c * 3 + kh) * 3 + kw) * C1 + cg * CG);
#pragma unroll
          for (int q = 0; q < CG / 4; ++q) {
            const float4 w = wp[q];
            acc[4 * q + 0] = fmaf(a, w.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(a, w.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(a, w.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(a, w.w, acc[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done reading the conv0 patch
#pragma unroll
    for (int j = 0; j < CG; ++j)
      a1s[(cg * CG + j) * (T1 * T1) + pix] = fmaxf(acc[j], 0.f);
    __syncthreads();

    // 2x2 max pool; channel-fastest so the NHWC stores coalesce
    for (int i = tid; i < TP * TP * C1; i += THREADS) {
      const int c = i % C1, p = i / C1;
      const int oy = p / TP, ox = p % TP;
      const int gy = ty * TP + oy, gx = tx * TP + ox;
      if (gy < Ho && gx < Wo) {
        const float* t = a1s + c * (T1 * T1) + (2 * oy) * T1 + 2 * ox;
        const float m = fmaxf(fmaxf(t[0], t[1]), fmaxf(t[T1], t[T1 + 1]));
        out[((size_t)(b * Ho + gy) * Wo + gx) * C1 + c] = m;
      }
    }
  }
}

}  // namespace

extern "C" int wmfml_stem_smem_bytes(int ci) {
  return smem_floats(ci) * (int)sizeof(float);
}

// x [B,H,W,Ci]; with T = B / n_per_task tasks: w0 [T,Ci,3,3,32];
// b0 [T,32]; w1 [T,32,3,3,48]; b1 [T,48] (T = 1, n_per_task = B for
// weights shared by the batch); out [B,H/8,W/8,48]. All contiguous f32 on
// the device. Returns the cudaError_t of the launch.
extern "C" int wmfml_stem_fwd(const float* x, const float* w0, const float* b0,
                              const float* w1, const float* b1, float* out,
                              int B, int H, int W, int Ci, int n_per_task,
                              int grid, void* stream) {
  const int smem = wmfml_stem_smem_bytes(Ci);
  cudaError_t err = cudaFuncSetAttribute(
      stem_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  stem_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, w0, b0, w1, b1, out, B, H, W, Ci, n_per_task);
  return (int)cudaGetLastError();
}
