// Hopper building blocks shared by K1 (stem.cu), K1b (stem_bwd.cu), K2
// (favor.cu), K3 (features.cu) and K6 (image_da.cu, the bulk copy only):
// 3xTF32 operand splitting, warpgroup MMA (wgmma) with A from registers and
// B from shared memory, and the asynchronous copies that feed it.
//
// 3xTF32: a TF32 product reads 10 of a float's 23 mantissa bits. With
// big = tf32(x) and small = tf32(x - big) for both operands, the sum
// big*big + big*small + small*big in float32 drops only small*small
// (2^-22 of the product). cvt.rna rounds to nearest (ties away from zero),
// as kernels/tf32.py:tf32_round does for the weights; leaving the low bits
// for the tensor core to drop would truncate, and the errors would no
// longer cancel.
//
// wgmma .tf32 is K-major for both operands. A (64 x 8 per instruction) comes
// from registers (mma_nN) or, like B, from shared memory (mma_ss_nN, K2's
// wide form). From registers, warp w of the warpgroup holds rows
// 16w..16w+15, lane l holds a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4) with g = l / 4, t = l % 4. The f32 accumulator of an
// m64nN product: lane l of warp w holds, for each 8-column chunk j, d[4j] =
// (16w + g, 8j + 2t), d[4j + 1] = (16w + g, 8j + 2t + 1), d[4j + 2] =
// (16w + g + 8, 8j + 2t), d[4j + 3] = (16w + g + 8, 8j + 2t + 1). B (N x 8)
// comes from shared memory through a descriptor without swizzle, in the
// core-matrix order of kernels/tf32.py:gmma_b_layout.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (big, small) as TF32 bit patterns
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Descriptor of a B operand without swizzle: start address, leading byte
// offset (between the two K halves of a core-matrix pair) and stride byte
// offset (between row groups of 8), all in 16-byte units.
__device__ __forceinline__ uint64_t desc_b(const void* p, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers while a wgmma that
// writes them is in flight.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A * B^T, m64n64k8, A from registers, B from shared memory
__device__ __forceinline__ void mma_n64(float (&d)[32], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d += A * B^T, m64n48k8
__device__ __forceinline__ void mma_n48(float (&d)[24], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, "
      "%28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d += A * B^T, m64n32k8
__device__ __forceinline__ void mma_n32(float (&d)[16], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d += A * B^T, m64n8k8, A and B from shared memory
__device__ __forceinline__ void mma_ss_n8(float (&d)[4], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

// d += A * B^T, m64n16k8, A and B from shared memory
__device__ __forceinline__ void mma_ss_n16(float (&d)[8], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// d += A * B^T, m64n24k8, A and B from shared memory
__device__ __forceinline__ void mma_ss_n24(float (&d)[12], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(1));
}

// d += A * B^T, m64n32k8, A and B from shared memory
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d += A * B^T, m64n40k8, A and B from shared memory
__device__ __forceinline__ void mma_ss_n40(float (&d)[20], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19}, %20, %21, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(1));
}

// d += A * B^T at m64nNk8, N a multiple of 8 up to 40, both operands from
// shared memory through descriptors (K2's wide form: N its rows rounded up
// to 8)
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 40, "m64nNk8: N = 8, 16, .., 40");
  if constexpr (N == 8) mma_ss_n8(d, a, b);
  else if constexpr (N == 16) mma_ss_n16(d, a, b);
  else if constexpr (N == 24) mma_ss_n24(d, a, b);
  else if constexpr (N == 32) mma_ss_n32(d, a, b);
  else mma_ss_n40(d, a, b);
}

// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma's B reads); then a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- mbarrier + bulk copy (TMA without a tensor map) -------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One thread: expect `bytes` on `bar`, then copy them global -> shared.
// dst, src 16-byte aligned; bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// -- cp.async (per thread) -----------------------------------------------------

// 4 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// named barrier over `threads` threads (id 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace tc
