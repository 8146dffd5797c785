// K4: the warp chain of image data augmentation. One or two scale/translate
// warps (CropAndPad and Affine of the ShapeNet1D pipeline, each under its
// Sometimes gate) applied to a batch of NHWC float32 images in one pass,
// with the constant fill of every stage: [B, H, W, C] -> [B, H, W, C].
//
// Replaces wmfml_tpu/aug/image_aug.py:_interp_matrix, _stage_matrices and
// _warp_chain (:57-151). The JAX package builds per-image [H, H] and [W, W]
// tent matrices relu(1 - |src_i - j|) and mixes each image as My img Mx^T,
// dense work for the TPU's matrix unit (2 (H + W) operations a pixel: 1.26
// GFLOP for 150 images of 128 x 128, 18.8 us at float32's 67 TFLOP/s). On
// the card the matrices are sparse: a tent row has at most two nonzeros (one
// for nearest), so a row of two composed stages has at most four. Each
// output pixel gathers at most 4 x 4 input taps and adds the fill field.
// That is a few tens of operations a pixel; the bound is the bytes, each
// image read and written once (150 x 64 KiB each way = 19.7 MB, 5.9 us at
// 3.35 TB/s).
//
// Design: a block is one image's band of ROWS output rows. Its threads
// first build the band's row taps and the image's column taps (index,
// weight, the last stage's coverage r and, for two stages, the first
// stage's coverage pushed through the second, p) in shared memory; then
// each thread computes output elements, neighbouring threads on
// neighbouring columns, reading the taps through the read-only cache. The
// fill is _warp_chain's sum of rank-1 terms, in its order:
//   one stage:  c0 - c0 ry rx
//   two stages: c0 ry2 rx2 - c0 py px + c1 - c1 ry2 rx2.
// A gate that is off makes a stage the identity with no fill, exactly.
//
// Nearest snapping decides which pixel a tap reads, so one ulp matters: the
// sample positions use the JAX package's float32 operations in its order,
// with a true division, and none contracted into an FMA (the _rn
// intrinsics). The kernel and the plain twin then differ only in the order
// of the float32 sums of the taps. No atomics, nothing allocated: two calls
// give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int NP = 7;          // sx, sy, tx, ty, cval, nearest, gate
constexpr int ROWS = 16;       // output rows of one block
constexpr int THREADS = 256;
constexpr int MAX_TAPS = 4;    // two composed tent rows

struct Axis {
  int idx[MAX_TAPS];
  float w[MAX_TAPS];
  int n;
  float r;                     // coverage of the last stage
  float p;                     // first stage's coverage through the second
};

// The sample position of output index i under one stage (_stage_matrices):
// (i - c - shift) / scale + c, floor(src + .5) for nearest, i itself when
// the gate is off.
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

// The taps of output index i along one axis (0 = x: sx, tx; 1 = y: sy, ty)
// after stage st0, then st1 when it is not null.
__device__ void axis_entry(int i, int n, const float* st0, const float* st1,
                           int axis, Axis* e) {
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
  e->n = cnt;
  e->r = r;
  e->p = p;
}

__global__ void __launch_bounds__(THREADS)
warp_chain_kernel(const float* __restrict__ img,
                  const float* __restrict__ params, float* __restrict__ out,
                  int H, int W, int C, int op0, int op1) {
  extern __shared__ Axis tab[];            // [ROWS] rows, then [W] columns
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, H - row0);
  const float* st0 = params + ((size_t)b * 2 + op0) * NP;
  const float* st1 = op1 >= 0 ? params + ((size_t)b * 2 + op1) * NP : nullptr;
  for (int t = threadIdx.x; t < rows + W; t += blockDim.x) {
    if (t < rows)
      axis_entry(row0 + t, H, st0, st1, 1, &tab[t]);
    else
      axis_entry(t - rows, W, st0, st1, 0, &tab[ROWS + t - rows]);
  }
  __syncthreads();

  const float c0 = st0[4];
  const float c1 = st1 ? st1[4] : 0.f;
  const int row_len = W * C;
  const float* src = img + (size_t)b * H * row_len;
  float* dst = out + ((size_t)b * H + row0) * row_len;
  for (int e = threadIdx.x; e < rows * row_len; e += blockDim.x) {
    const int r = e / row_len;
    const int x = (e - r * row_len) / C;
    const int ch = e - r * row_len - x * C;
    const Axis& ay = tab[r];
    const Axis& ax = tab[ROWS + x];
    float acc = 0.f;
    for (int a = 0; a < ay.n; ++a) {
      const float* line = src + (size_t)ay.idx[a] * row_len + ch;
      float s = 0.f;
      for (int q = 0; q < ax.n; ++q) s += ax.w[q] * __ldg(line + ax.idx[q] * C);
      acc += ay.w[a] * s;
    }
    const float rr = __fmul_rn(ay.r, ax.r);
    float fill;
    if (!st1) {
      fill = __fadd_rn(c0, __fmul_rn(-c0, rr));
    } else {
      fill = __fmul_rn(c0, rr);
      fill = __fadd_rn(fill, __fmul_rn(-c0, __fmul_rn(ay.p, ax.p)));
      fill = __fadd_rn(fill, c1);
      fill = __fadd_rn(fill, __fmul_rn(-c1, rr));
    }
    dst[e] = acc + fill;
  }
}

}  // namespace

extern "C" int wmfml_warp_smem_bytes(int W) {
  return (ROWS + W) * (int)sizeof(Axis);
}

// img [B,H,W,C]; params [B,2,7] (row op: sx, sy, tx, ty, cval, nearest,
// gate); stages op0 then op1 (op1 = -1 for one stage); out [B,H,W,C]. All
// contiguous f32 on the device. Returns the cudaError_t of the launch.
extern "C" int wmfml_warp_fwd(const float* img, const float* params,
                              float* out, int B, int H, int W, int C, int op0,
                              int op1, void* stream) {
  const int smem = wmfml_warp_smem_bytes(W);
  if (smem > 48 * 1024 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((H + ROWS - 1) / ROWS, B);
  warp_chain_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      img, params, out, H, W, C, op0, op1);
  return (int)cudaGetLastError();
}
