// K5: the keyed-hash dropout masks of image data augmentation. One
// elementwise pass over a batch of NHWC float32 images applies, per image,
// Sometimes(0.5) of OneOf(Dropout, CoarseDropout): [B, H, W, C] ->
// [B, H, W, C].
//
// Replaces wmfml_tpu/aug/image_aug.py:_fmix32, _hash_keep, dropout,
// coarse_dropout and one_of_dropout (:274-375). The JAX package draws no
// random mask: each element hashes its id (the pixel, or the pixel and
// channel, for Dropout; the cell of a (round(H sp), round(W sp)) grid for
// CoarseDropout) with the image's two key words through murmur3's
// finalizer twice, and keeps the element when the hash, read as a uniform
// in [0, 1), is at least the drop rate p. It is integer arithmetic and two
// float32 steps, so the masks equal the JAX package's bit for bit given the
// same key words, p and sp:
//   * the multiplies wrap mod 2^32 (uint32 arithmetic);
//   * the hash converts to float32 with round to nearest (__uint2float_rn);
//   * the grid size rounds half to even (rintf, as jnp.round does);
//   * floor(y hl / H) uses a true division and no FMA (the _rn intrinsics).
// out = img * keep where the gate is on, else img, as the JAX package
// multiplies by the mask cast to float.
//
// Bound: the bytes, each image read and written once (150 x 64 KiB each
// way = 19.7 MB, 5.9 us at 3.35 TB/s); the hash's ~40 integer operations an
// element are below that. A block covers THREADS x PER_THREAD elements of
// one image, whose parameters it reads once. No atomics, nothing
// allocated: two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ND = 5;          // gate, pick, p, sp, per_channel
constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(THREADS)
hash_dropout_kernel(const float* __restrict__ img,
                    const float* __restrict__ drop,
                    const int* __restrict__ keys, float* __restrict__ out,
                    int H, int W, int C) {
  const int b = blockIdx.y;
  const int n = H * W * C;
  const float* d = drop + (size_t)b * ND;
  const bool gate = d[0] > 0.5f;
  const bool pick = d[1] > 0.5f;              // Dropout, else CoarseDropout
  const float p = d[2];
  const float sp = d[3];
  const bool per_channel = d[4] > 0.5f;
  const uint32_t k0 = (uint32_t)keys[2 * b];
  const uint32_t k1 = (uint32_t)keys[2 * b + 1];
  const float hl = fmaxf(rintf(__fmul_rn((float)H, sp)), 1.f);
  const float wl = fmaxf(rintf(__fmul_rn((float)W, sp)), 1.f);
  const size_t base = (size_t)b * n;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int e = (blockIdx.x * PER_THREAD + k) * THREADS + threadIdx.x;
    if (e >= n) return;
    const float v = img[base + e];
    if (!gate) {
      out[base + e] = v;
      continue;
    }
    const int yx = e / C;
    const int ch = e - yx * C;
    uint32_t id;
    if (pick) {
      id = per_channel ? (uint32_t)yx * C + ch : (uint32_t)yx;
    } else {
      const int y = yx / W;
      const int x = yx - y * W;
      const float fy = floorf(__fdiv_rn(__fmul_rn((float)y, hl), (float)H));
      const float fx = floorf(__fdiv_rn(__fmul_rn((float)x, wl), (float)W));
      const uint32_t cell = (uint32_t)__fadd_rn(__fmul_rn(fy, (float)W), fx);
      id = (C > 1 && per_channel) ? cell * C + ch : cell;
    }
    uint32_t hsh = (id ^ k0) * 0x9E3779B9u + k1;
    hsh = fmix32(fmix32(hsh));
    const float u = __fmul_rn(__uint2float_rn(hsh), 2.3283064365386963e-10f);
    out[base + e] = __fmul_rn(v, u >= p ? 1.f : 0.f);
  }
}

}  // namespace

// img [B,H,W,C]; drop [B,5] (gate, pick, p, sp, per_channel); keys [B,2]
// (the two uint32 key words as int32); out [B,H,W,C]. All contiguous on the
// device. Returns the cudaError_t of the launch.
extern "C" int wmfml_hash_dropout_fwd(const float* img, const float* drop,
                                      const int* keys, float* out, int B,
                                      int H, int W, int C, void* stream) {
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const int per_block = THREADS * PER_THREAD;
  const dim3 grid((H * W * C + per_block - 1) / per_block, B);
  hash_dropout_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      img, drop, keys, out, H, W, C);
  return (int)cudaGetLastError();
}
