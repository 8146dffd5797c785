// bfloat16 warpgroup MMA for K1 (stem.cu), K1b (stem_bwd.cu) and K3
// (features.cu) under
// compute_dtype: bfloat16, beside the 3xTF32 helpers of tf32_gmma.cuh
// (whose descriptors, fences and waits these share), and the element-type
// helpers through which each of those kernels keeps one body for float and
// bfloat16.
//
// wgmma .bf16 is k16: A (64 x 16 per instruction) comes from registers,
// each 32-bit register two bfloat16 of one row, the lower column in the low
// half. Warp w of the warpgroup holds rows 16w..16w+15; lane l, with
// g = l / 4 and t = l % 4, holds a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..2t+1),
// a2 = (g, 2t+8..2t+9), a3 = (g + 8, 2t+8..2t+9): the TF32 fragment's
// order, two elements a register. The f32 accumulator is laid out as in
// tf32_gmma.cuh. B (N x 16) comes from shared memory through the same
// descriptor without swizzle, K-major: core matrices of 8 rows x 16 bytes
// (8 bfloat16), K halves 128 bytes apart and row groups 256 bytes apart, in
// the order of kernels/tf32.py:gmma_b_layout on a bfloat16 tensor.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tf32_gmma.cuh"

namespace tc {

// x rounded to bfloat16 (nearest even), as a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats rounded to bfloat16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bfloat16 of a packed word, as floats
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// an element of either type as a float, and two floats stored as two
// consecutive elements (bfloat16: rounded, one 32-bit store)
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// d += A * B^T, m64n64k16 bf16, A from registers, B from shared memory
// (K-major: imm-trans-b 0)
__device__ __forceinline__ void mma_bf16_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d += A * B^T, m64n48k16 bf16
__device__ __forceinline__ void mma_bf16_n48(float (&d)[24], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, "
      "%28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d += A * B^T, m64n32k16 bf16 (K1b's input gradient)
__device__ __forceinline__ void mma_bf16_n32(float (&d)[16], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

}  // namespace tc
