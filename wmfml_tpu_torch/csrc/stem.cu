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
// 3xTF32 on the tensor cores (3 x 8.5 GFLOP at 495 TFLOP/s) and conv0 in
// f32 on the CUDA cores (0.7 GFLOP at 67 TFLOP/s): 0.062 ms, bound by
// operations, not by bytes.
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

#include <cuda_runtime.h>

#include "tf32_gmma.cuh"

namespace {

constexpr int C0 = 32;             // conv0 output channels
constexpr int C1 = 48;             // conv1 output channels
constexpr int TP = 4;              // pool outputs per tile side
constexpr int T1 = 2 * TP;         // conv1 outputs per tile side (8)
constexpr int T0 = 2 * T1 + 1;     // conv0 outputs per tile side (17)
constexpr int TX = 2 * T0 + 1;     // input pixels per tile side (35)
constexpr int PH = (T0 + 1) / 2;   // side of one conv0 phase plane (9)
constexpr int PS = C0 + 4;         // patch position stride (floats)
constexpr int PATCH = 4 * PH * PH * PS;
constexpr int K1 = 9 * C0;         // conv1 depth (288)
constexpr int W1 = C1 * K1;        // conv1 weights, one part (floats)
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int smem_floats(int ci, int wgs) {
  // w1 big | small | w0 | b0 | b1 | patch per warpgroup | 2 inputs per wg
  return 2 * W1 + ci * 9 * C0 + C0 + C1 + wgs * (PATCH + 2 * ci * TX * TX);
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

// kOne: one input channel, and each thread keeps the conv0 weights of its
// 8 channels in registers for the whole run
template <bool kOne>
__global__ void __launch_bounds__(256, 1)
stem_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ b1, float* __restrict__ out,
                int H, int W, int Ci, int n_per_task, int blocks_per_task) {
  extern __shared__ __align__(128) float smem[];
  const int wgs = blockDim.x / 128;
  float* w1s = smem;                    // [2][36 k-steps][48 x 8], B order
  float* w0s = w1s + 2 * W1;            // [Ci * 9][C0]
  float* b0s = w0s + Ci * 9 * C0;
  float* b1s = b0s + C0;
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127;
  float* patch = b1s + C1 + wg * PATCH; // [4][PH][PH][PS]
  float* xbuf = b1s + C1 + wgs * PATCH + wg * 2 * Ci * TX * TX;

  const int Ho = H / 8, Wo = W / 8, H0 = H / 2, W0 = W / 2;
  const int tiles_y = (Ho + TP - 1) / TP, tiles_x = (Wo + TP - 1) / TP;
  const int per_image = tiles_y * tiles_x;
  const int task = blockIdx.x / blocks_per_task;
  const int chunk = blockIdx.x % blocks_per_task;
  const long long task_tiles = (long long)n_per_task * per_image;
  const long long first = task_tiles * chunk / blocks_per_task;
  const long long last = task_tiles * (chunk + 1) / blocks_per_task;

  // the task's weights, once: conv1 split into wgmma B order, conv0 as
  // [ci][kh][kw][c]
  {
    pack_conv1(w1 + (size_t)task * W1, w1s, tid, blockDim.x);
    const float* w0t = w0 + (size_t)task * C0 * Ci * 9;
    for (int i = tid; i < Ci * 9 * C0; i += blockDim.x)
      w0s[i] = w0t[(i % C0) * Ci * 9 + i / C0];
    if (tid < C0) b0s[tid] = b0[task * C0 + tid];
    if (tid < C1) b1s[tid] = b1[task * C1 + tid];
    tc::fence_async_smem();
    __syncthreads();
  }

  auto origin = [&](long long tile, int& b, int& ty, int& tx) {
    b = task * n_per_task + (int)(tile / per_image);
    const int rem = (int)(tile % per_image);
    ty = rem / tiles_x;
    tx = rem % tiles_x;
  };
  // cp.async of a tile's input window into buf, zeros outside the image
  auto prefetch = [&](long long tile, float* buf) {
    int b, ty, tx;
    origin(tile, b, ty, tx);
    // first input row / col: 2 * (first conv0 row) - 1
    const int rx = 2 * (2 * ty * T1 - 1) - 1, sx = 2 * (2 * tx * T1 - 1) - 1;
    for (int i = lt; i < Ci * TX * TX; i += 128) {
      const int c = i / (TX * TX), p = i % (TX * TX);
      const int gy = rx + p / TX, gx = sx + p % TX;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      tc::cp_async4(buf + i,
                    in ? x + ((size_t)(b * H + gy) * W + gx) * Ci + c : x, in);
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
  if (tile < last) prefetch(tile, xbuf);
  tc::cp_async_commit();
  for (int i = 0; tile < last; ++i, tile += wgs) {
    if (tile + wgs < last) prefetch(tile + wgs, xbuf + ((i + 1) & 1) * Ci * TX * TX);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    // this tile's input has landed; the previous tile's patch reads are done
    tc::named_sync(bar_id, 128);

    int b, ty, tx;
    origin(tile, b, ty, tx);
    const float* xs = xbuf + (i & 1) * Ci * TX * TX;
    const int r0 = 2 * ty * T1 - 1, s0 = 2 * tx * T1 - 1;   // first conv0 row / col

    // conv0 + bias + ReLU over the 17x17 patch: item (position, group of 8
    // channels); the group is this thread's for every item (128 % 4 == 0)
    for (int item = lt; item < T0 * T0 * 4; item += 128) {
      const int pos = item >> 2;
      const int ly = pos / T0, lx = pos % T0;
      const int gy = r0 + ly, gx = s0 + lx;
      float a[8];
      if (gy >= 0 && gy < H0 && gx >= 0 && gx < W0) {
#pragma unroll
        for (int c = 0; c < 8; ++c) a[c] = b0s[8 * cg + c];
        for (int ci = 0; ci < (kOne ? 1 : Ci); ++ci) {
          const float* xp = xs + (ci * TX + 2 * ly) * TX + 2 * lx;
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const float v = xp[(k / 3) * TX + k % 3];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              if constexpr (kOne)
                a[c] = fmaf(v, w0r[8 * k + c], a[c]);
              else
                a[c] = fmaf(v, w0s[(ci * 9 + k) * C0 + 8 * cg + c], a[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) a[c] = fmaxf(a[c], 0.f);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) a[c] = 0.f;   // conv1's zero padding
      }
      float4* dst = reinterpret_cast<float4*>(
          patch + (((ly & 1) * 2 + (lx & 1)) * PH * PH + (ly >> 1) * PH + (lx >> 1)) * PS +
          8 * cg);
      dst[0] = make_float4(a[0], a[1], a[2], a[3]);
      dst[1] = make_float4(a[4], a[5], a[6], a[7]);
    }
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
      const float* pa = patch + (((kh & 1) * 2 + (kw & 1)) * PH * PH +
                                 (2 * warp + (kh >> 1)) * PH + g + (kw >> 1)) * PS + tq;
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
    tc::wait<0>();
    tc::pin(acc);

    // bias + ReLU + 2x2 pool: rows r, r + 8 in this thread, columns g, g ^ 1
    // in lanes l, l ^ 4
    const int oy = ty * TP + warp, ox = tx * TP + (g >> 1);
    const bool store = (g & 1) == 0 && oy < Ho && ox < Wo;
    float* o = out + ((size_t)(b * Ho + oy) * Wo + ox) * C1 + 2 * tq;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = fmaxf(acc[4 * j + e], acc[4 * j + 2 + e]);
        m[e] = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      }
      if (store)
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(fmaxf(m[0] + b1s[8 * j + 2 * tq], 0.f),
                        fmaxf(m[1] + b1s[8 * j + 2 * tq + 1], 0.f));
    }
  }
  tc::cp_async_wait<0>();
}

}  // namespace

extern "C" int wmfml_stem_smem_bytes(int ci, int wgs) {
  return smem_floats(ci, wgs) * (int)sizeof(float);
}

// The conv1 packing alone (for tests): w1 [T,48,32,3,3] -> dst [T,2,48*288],
// big | small in wgmma B order.
extern "C" int wmfml_stem_pack(const float* w1, float* dst, int T,
                               void* stream) {
  pack_kernel<<<T, 256, 0, (cudaStream_t)stream>>>(w1, dst);
  return (int)cudaGetLastError();
}

// x [B,H,W,Ci]; with T = B / n_per_task tasks: w0 [T,32,Ci,3,3]; b0 [T,32];
// w1 [T,48,32,3,3]; b1 [T,48] (torch OIHW; T = 1, n_per_task = B for
// weights shared by the batch); out [B,H/8,W/8,48]. All contiguous f32 on
// the device. Returns the cudaError_t of the launch.
extern "C" int wmfml_stem_fwd(const float* x, const float* w0, const float* b0,
                              const float* w1, const float* b1, float* out,
                              int B, int H, int W, int Ci, int n_per_task,
                              void* stream) {
  const int wgs = wmfml_stem_smem_bytes(Ci, 2) <= MAX_SMEM ? 2 : 1;
  const int smem = wmfml_stem_smem_bytes(Ci, wgs);
  const int threads = 128 * wgs;
  const auto kernel = Ci == 1 ? stem_fwd_kernel<true> : stem_fwd_kernel<false>;
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
  kernel<<<tasks * bpt, threads, smem, (cudaStream_t)stream>>>(
      x, w0, b0, w1, b1, out, H, W, Ci, n_per_task, bpt);
  return (int)cudaGetLastError();
}
