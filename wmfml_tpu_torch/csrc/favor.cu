// K2: masked FAVOR+ cross-attention core (Performer positive random
// features, non-causal linear attention), one cooperative launch per call.
//
// Replaces wmfml_tpu/nn/attention.py:softmax_kernel_features,
// linear_attention and favor_attention. Math kept exactly:
//   dash  = (d^-1/4 x) . P^T                       P: [m, d] projection
//   diag  = |x|^2 / 2 * d^-1/2                     (from the unscaled rows)
//   q'    = m^-1/2 (exp(dash_q - diag_q - max_row(dash_q)) + eps)
//   k'    = m^-1/2 (exp(dash_k - diag_k - max_all(dash_k)) + eps) * mask
//   out   = q' (k'^T v) / (q' . sum_n k')
// where max_all is ONE max over the whole key tensor [T, H, Nk, m], masked
// rows included. The key mask is applied after featurisation, so a task with
// no context rows divides 0 by 0 (NaN), which the model gates to 0.
//
// Bound: at the ANPShapeNet1D shapes (T=10, H=8, Nq=Nk=15, d=e=64, m=266)
// the call does 82 MFLOP of feature products (dash) and 12 MFLOP of the rest
// and moves about 1.3 MB: 0.0005 ms with dash in 3xTF32 on the tensor cores
// beside the rest on the CUDA cores, 0.0014 ms all in float32 on the CUDA
// cores. Both are below the device
// time of any launch on the card (a one-element torch.add: 0.0012 ms). What
// bounds this kernel is latency: a chain of dependent steps (loads, the
// products, block reductions, the grid barrier), each a few microseconds.
// The two-launch form this file replaces ran 0.0707 ms of device time in a
// 0.0750 ms call (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): not launch
// overhead, but its kernels' own time.
// What held them back: dash_k computed twice (a max pre-pass, then again),
// every product of dash a serial 64-step fmaf chain with two shared loads a
// step, 80 blocks of 8 warps on 132 SMs, the projection restaged with a
// div/mod per element by every block of both launches, A = q'k'^T as 225
// serial 266-step chains, and a third kernel casting the mask.
//
// Design:
//   * One launch, cooperative (cudaLaunchKernelEx with
//     cudaLaunchAttributeCooperative), on a persistent grid of
//     min(T*H, co-resident blocks); the co-resident count is queried once
//     per device. A refused launch is an error: there is no second path.
//     Blocks of 12 warps (three warpgroups: everything here waits on
//     memory or on a reduction, so warps are what hides it) loop over
//     (task, head) items in both phases. The other candidate, a cluster of
//     up to 16 CTAs exchanging maxima through distributed shared memory,
//     cannot hold T*H = 80 items in one cluster of 16 without looping
//     inside it anyway, and a cluster's barrier does not reach the other
//     clusters whose keys share the max; the grid barrier does, once.
//   * Phase 1, per item: dash^T = P [q; k]^T on the tensor cores in 3xTF32
//     (wgmma m64n32k8 .tf32). A is the projection, from registers: each
//     warpgroup copies the fragments of its 64-row tiles of P (5 at
//     m = 266, the fifth 10 rows deep; at most two a warpgroup) straight
//     from global memory into a per-thread stash in shared memory with
//     cp.async, in the same round of loads as the rows, and splits them
//     with cvt.rna as it loads them into registers. B is the item's rows,
//     q then k (15 + 15 of a 32-row tile), scaled by d^-1/4 and split as
//     they are staged, in the operand order below. Per k-step: small*big,
//     big*small, big*big. The item's max of dash_k over its real columns
//     (padded columns 266..271 excluded, masked rows included) goes to
//     block_maxima[item]. With one item a block (T*H <= co-resident
//     blocks, as at the ANP shape), dash, v, the unscaled rows and the mask
//     stay in shared memory through the barrier; otherwise dash goes to a
//     scratch tensor the wrapper allocates (L2-resident) and phase 2 loads
//     its item's inputs again. The first design kept P resident in shared
//     memory as B (139 KB split, each block restaging it, rows as A, m64n64
//     then m64n128 products); its staging and its wgmma chains took longer
//     than the whole of this phase does now (PERF.md).
//   * grid.sync(): every item's dash and max are written.
//   * Phase 2: every block reduces all T*H maxima in the same fixed order,
//     so every block holds the same gmax bit for bit; no atomics anywhere.
//     Per item, a warp per row: diag from the unscaled row, the row max for
//     q, then q' or k' in place (0 in the padded columns). A = q' k'^T by
//     warps over tiles of 2 q rows x 4 k rows, the lanes splitting each
//     266-long sum four columns at a time, reduced by 9 shuffles; out =
//     A v / rowsum(A), one output per thread: q' (k'^T v) / (q' . sum k')
//     reassociated, 7x fewer FLOPs at N=15, m=266.
//   * The call's whole cost on the host is this one launch: q, k, v are
//     read through their strides (the attention block hands over transposed
//     views), the bool mask's bytes through theirs (the sampler's mask is an
//     expanded view), the shared-memory attribute is set once per device,
//     and nothing is allocated here.
//   * Every global read is latency-bound, so loads are issued in rounds with
//     all of a thread's loads in flight before the first use (batched).
//   * An optional phase clock (stamps) records the global timer at nine
//     points per block; chip_smoke.py prints it.
//
// bfloat16 q, k, v (compute_dtype: bfloat16; favor_kernel<__nv_bfloat16>):
// the JAX core promotes a bfloat16 data against the float32 projection, so
// the output stays float32 and only two steps round to bfloat16 first:
// dn x (dn itself rounded: JAX casts the Python scalar) and the diagonal
// term, bf16(bf16(sum of bf16(x^2)) / 2 * dn^2) (dn^2 rounded). The rows are
// read through their strides four values (8 bytes) a load and converted to
// float32 exactly; their rounded scaled values are exact in TF32, so their
// small part is 0 and dash takes two products a k-step, not three.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_gmma.cuh"
#include "tf32_gmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WGS = 3;              // warpgroups: 12 warps to hide latency
constexpr int THREADS = 128 * WGS;
constexpr int WARPS = THREADS / 32;
constexpr int DP = 64;              // the head width d, zero-padded: d <= 64
constexpr int NT = 32;              // item rows per wgmma B tile (N)
constexpr int MAX_MP = 512;         // m padded: 4 float4 a lane per row
// dynamic shared memory requested whatever the shape, so the occupancy (one
// block per SM) is one number per device; 1 KB below the 227 KB limit
constexpr int SMEM_BYTES = 231424;
constexpr int MAX_DEVICES = 64;
// phase clock points per block: start, staged, dash done, phase 1 done,
// barrier passed, loaded, features done, A done, end (the later ones at the
// block's last item)
constexpr int STAMPS = 9;

struct Params {
  const void* q;                    // float or __nv_bfloat16, as the kernel's T
  const void* k;
  const void* v;
  const float* proj;
  const unsigned char* mask;        // [T, Nk] bytes 0/1, or null: all real
  float* dash;                      // scratch [items][R][MP], R = Nq + Nk
  float* maxima;                    // scratch [items]
  float* out;                       // [items][Nq][e]
  long long* stamps;                // [gridDim][STAMPS] or null
  long long qs_t, qs_h, qs_n, ks_t, ks_h, ks_n, vs_t, vs_h, vs_n, ms_t, ms_n;
  int items, H, Nq, Nk, d, e, m, MP;
  float dn, dn2, ratio, eps;
  const float* kmax;                // [1] the key max to take, or null: the
                                    // keys' own (a data-parallel mesh's)
};

__host__ __device__ inline int m_pad(int m) { return (m + 15) / 16 * 16; }
__host__ __device__ inline int row_tiles(int Nq, int Nk) {
  return (Nq + Nk + NT - 1) / NT;
}
// Shared memory: features (dash first) [R][MP] | v [Nk][e] | unscaled rows
// [R][DP] | A [Nq][Nk] | key mask [Nk], rounded up to 128 bytes (the
// operand rows after it are read through wgmma descriptors) | operand rows,
// big | small [tiles * NT * DP each] (phase 1) | fragment stash
// [2][DP / 2][THREADS] (phase 1) | red [WARPS]
__host__ __device__ inline int phase2_floats(int Nq, int Nk, int e, int MP) {
  const int R = Nq + Nk;
  return (R * MP + Nk * e + R * DP + Nq * Nk + Nk + 31) / 32 * 32;
}
__host__ __device__ inline int red_offset(int Nq, int Nk, int e, int MP) {
  return phase2_floats(Nq, Nk, e, MP) + 2 * row_tiles(Nq, Nk) * NT * DP +
         2 * (DP / 2) * THREADS;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// every thread gets the same value: the warps' maxima in warp order
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();                  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  return r;
}

// Sums of 8 values over the 32 lanes, scattered: lane l returns the total
// of v[l / 4] (9 shuffles instead of 8 x 5). The halves a lane sends and
// keeps follow its lane bits, so every sum is taken in one fixed order.
__device__ inline float warp_sum8(float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = v[j], hi = v[j + 4];
    v[j] = (b4 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b4 ? lo : hi, 16);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float lo = v[j], hi = v[j + 2];
    v[j] = (b3 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b3 ? lo : hi, 8);
  }
  float s = (b2 ? v[1] : v[0]) +
            __shfl_xor_sync(0xffffffffu, b2 ? v[0] : v[1], 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

__device__ inline void stamp(const Params& p, int j) {
  if (p.stamps != nullptr && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[blockIdx.x * STAMPS + j] = t;
  }
}

// n float4 copies, load(i) then store(i, x), with U loads in flight per
// thread before the first store: every global read here is latency-bound.
// NTH: the block's threads
template <int U, int NTH = THREADS, class Load, class Store>
__device__ __forceinline__ void batched(int n, Load load, Store store) {
  for (int base = threadIdx.x; base < n; base += NTH * U) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NTH;
      x[u] = i < n ? load(i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NTH;
      if (i < n) store(i, x[u]);
    }
  }
}

__device__ inline float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// four consecutive elements as float4: float32 as they are, bfloat16
// converted (exactly)
__device__ inline float4 ld4(const float* p) { return ldg4(p); }
__device__ inline float4 ld4(const __nv_bfloat16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(tc::bf16_lo(r.x), tc::bf16_hi(r.x), tc::bf16_lo(r.y),
                     tc::bf16_hi(r.y));
}

template <class T>
__device__ inline const T* qkv(const void* a) { return static_cast<const T*>(a); }

// The wgmma B operand order of the item's rows, K = DP = 64 columns: in
// float4 units, i = ((g * 8 + s) * 2 + half) * 8 + r holds row g * 8 + r,
// columns s * 8 + half * 4 .. + 3. A k-step s of row groups g.. starts at
// float (g * 8 + s) * 64, its K halves 128 B apart (the descriptor's leading
// byte offset) and its row groups 2048 B apart (its stride byte offset);
// eight consecutive threads store 128 consecutive bytes, and no index needs
// a division.
__device__ inline int op_row(int i) { return (i >> 7) * 8 + (i & 7); }
__device__ inline int op_col(int i) { return ((i >> 4) & 7) * 8 + ((i >> 3) & 1) * 4; }

// x -> big and small, in place of float4 i of each part
__device__ void split_store(float* big, int part, int i, float4 x) {
  uint32_t b[4], sm[4];
  tc::split(x.x, b[0], sm[0]);
  tc::split(x.y, b[1], sm[1]);
  tc::split(x.z, b[2], sm[2]);
  tc::split(x.w, b[3], sm[3]);
  reinterpret_cast<float4*>(big)[i] =
      make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                  __uint_as_float(b[2]), __uint_as_float(b[3]));
  reinterpret_cast<float4*>(big + part)[i] =
      make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                  __uint_as_float(sm[2]), __uint_as_float(sm[3]));
}

// the item's q rows, then its k rows, zero-padded to the NT-row tiles
template <class T>
__device__ float4 row_load(const Params& p, int item, int i) {
  const int t = item / p.H, h = item % p.H;
  const int r = op_row(i), c = op_col(i);
  if (r >= p.Nq + p.Nk || c >= p.d) return make_float4(0.f, 0.f, 0.f, 0.f);
  return r < p.Nq
             ? ld4(qkv<T>(p.q) + t * p.qs_t + h * p.qs_h + r * p.qs_n + c)
             : ld4(qkv<T>(p.k) + t * p.ks_t + h * p.ks_h + (r - p.Nq) * p.ks_n +
                   c);
}
// the B operand: scaled by d^-1/4 as the reference scales them (rounded to
// bfloat16 for bfloat16 rows), then split
template <class T>
__device__ void row_store(const Params& p, float* rows, int part, int i,
                          float4 x) {
  float4 y = make_float4(p.dn * x.x, p.dn * x.y, p.dn * x.z, p.dn * x.w);
  if constexpr (sizeof(T) == 2)
    y = make_float4(tc::bf16r(y.x), tc::bf16r(y.y), tc::bf16r(y.z),
                    tc::bf16r(y.w));
  split_store(rows, part, i, y);
}

// This thread's A fragments of projection tile mt (wgmma A from registers,
// tf32_gmma.cuh): rows 64 mt + 16 w + g and + 8, columns 8 s + t and + 4,
// zero past m and d; element (s, q) at stash[(4 s + q) * THREADS + tid].
// Copied global -> shared by cp.async, so they hold no registers while in
// flight; a k-step of a warp reads 16 rows x 32 contiguous bytes, and the
// projection never passes through shared memory in any other form.
__device__ __forceinline__ void stash_fragments(const Params& p, int mt,
                                                float* stash) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int j0 = mt * 64 + warp * 16 + (lane >> 2), c0 = lane & 3;
#pragma unroll
  for (int s = 0; s < DP / 8; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + (q & 1) * 8, c = 8 * s + c0 + (q >> 1) * 4;
      const bool ok = j < p.m && c < p.d;
      tc::cp_async4(stash + (4 * s + q) * THREADS + threadIdx.x,
                    ok ? p.proj + j * p.d + c : p.proj, ok);
    }
}

// One unit of phase 1 for this warpgroup: dash^T of projection tile mt (64
// features) against item row tile nt (NT rows), from the stashed fragments;
// small*big, big*small, big*big per k-step (kRowsExact: the rows' small
// part is 0, and its product is skipped). Stores the real rows to dst
// ([R][MP]) and returns kmax raised by the unit's key values in real
// columns.
template <bool kRowsExact>
__device__ __forceinline__ float dash_unit(const Params& p, float* dst,
                                           int mt, int nt, const float* stash,
                                           const float* rows, int part,
                                           float kmax) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  uint32_t ab[DP / 8][4], as[DP / 8][4];
#pragma unroll
  for (int s = 0; s < DP / 8; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tc::split(stash[(4 * s + q) * THREADS + threadIdx.x], ab[s][q], as[s][q]);
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  tc::fence();
#pragma unroll
  for (int s = 0; s < DP / 8; ++s) {
    const float* b = rows + (nt * NT + s) * 64;   // row group 4 nt, k-step s
    const uint64_t big = tc::desc_b(b, 128, 2048);
    const uint64_t small = tc::desc_b(b + part, 128, 2048);
    tc::mma_n32(acc, as[s][0], as[s][1], as[s][2], as[s][3], big);
    if constexpr (!kRowsExact)
      tc::mma_n32(acc, ab[s][0], ab[s][1], ab[s][2], ab[s][3], small);
    tc::mma_n32(acc, ab[s][0], ab[s][1], ab[s][2], ab[s][3], big);
  }
  tc::commit();
  tc::wait<0>();
  tc::pin(acc);

  // acc holds dash[n][j] at feature j = 64 mt + 16 w + g (+ 8), item row
  // n = NT nt + 8 jj + 2 t (+ 1)
  const int R = p.Nq + p.Nk, j0 = mt * 64 + warp * 16 + g;
#pragma unroll
  for (int jj = 0; jj < NT / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + (e >> 1) * 8, n = nt * NT + 8 * jj + 2 * tq + (e & 1);
      const float val = acc[4 * jj + e];
      if (j < p.MP && n < R) dst[(size_t)n * p.MP + j] = val;
      if (j < p.m && n >= p.Nq && n < R) kmax = fmaxf(kmax, val);
    }
  }
  return kmax;
}

// q' or k' of four consecutive columns c.. of a row
__device__ inline float4 features4(const Params& p, float4 x, int c,
                                   float diag, float stab, float keep) {
  float y[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = c + j < p.m
               ? p.ratio * (expf(y[j] - diag - stab) + p.eps) * keep
               : 0.f;
  return make_float4(y[0], y[1], y[2], y[3]);
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1) favor_kernel(const Params p) {
  constexpr bool kBF = sizeof(T) == 2;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.Nq + p.Nk, M4 = p.MP / 4, tiles = row_tiles(p.Nq, p.Nk);
  float* F = smem;                  // [R][MP]: dash, then q' and k'
  float* V = F + R * p.MP;          // [Nk][e]
  float* X = V + p.Nk * p.e;        // [R][DP], unscaled
  float* A = X + R * DP;            // [Nq][Nk]
  float* keep = A + p.Nq * p.Nk;    // [Nk]
  float* rows = smem + phase2_floats(p.Nq, p.Nk, p.e, p.MP);
  float* stash = rows + 2 * tiles * NT * DP;
  float* red = smem + red_offset(p.Nq, p.Nk, p.e, p.MP);
  float4* F4 = reinterpret_cast<float4*>(F);
  const int part = tiles * NT * DP, nr = part / 4, nv = p.Nk * p.e / 4;
  // with one item a block, dash, v, the rows and the mask stay in shared
  // memory from phase 1 to phase 2; otherwise dash goes through scratch and
  // phase 2 loads its item's inputs again
  const bool resident = p.items <= (int)gridDim.x;
  stamp(p, 0);

  // -- phase 1: dash and each item's key max ---------------------------------
  {
    const int mtiles = (p.MP + 63) / 64, units = mtiles * tiles;
    // unit u: projection tile (u + block) % mtiles, so that the blocks do not
    // all ask the same L2 lines at once, and row tile u / mtiles
    const int u0 = tid >> 7;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int t = item / p.H, h = item % p.H;
      // one round of loads: this warpgroup's first two units' fragments,
      // the rows and, resident, v and the mask; block_max below ended the
      // previous item's reads of rows and stash
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (u0 + k * WGS < units)
          stash_fragments(p, (u0 + k * WGS + blockIdx.x) % mtiles,
                          stash + k * (DP / 2) * THREADS);
      tc::cp_async_commit();
      const bool kept = tid < p.Nk && (p.mask == nullptr ||
                                       p.mask[t * p.ms_t + tid * p.ms_n]);
      const T* vb = qkv<T>(p.v) + t * p.vs_t + h * p.vs_h;
      const int e4 = p.e / 4;
      batched<3>(
          nr + (resident ? nv : 0),
          [&](int i) {
            return i < nr ? row_load<T>(p, item, i)
                          : ld4(vb + (i - nr) / e4 * p.vs_n + (i - nr) % e4 * 4);
          },
          [&](int i, float4 x) {
            if (i >= nr) {
              reinterpret_cast<float4*>(V)[i - nr] = x;
              return;
            }
            row_store<T>(p, rows, part, i, x);
            const int r = op_row(i);
            if (resident && r < R)
              *reinterpret_cast<float4*>(X + r * DP + op_col(i)) = x;
          });
      if (resident && tid < p.Nk) keep[tid] = kept ? 1.f : 0.f;
      tc::cp_async_wait<0>();       // this thread's own stash
      tc::fence_async_smem();       // the operands, for wgmma's reads
      __syncthreads();
      stamp(p, 1);
      float* dst = resident ? F : p.dash + (size_t)item * R * p.MP;
      float kmax = -INFINITY;
      for (int k = 0, u = u0; u < units; ++k, u += WGS) {
        const int mt = (u + blockIdx.x) % mtiles;
        float* st = stash + (k & 1) * (DP / 2) * THREADS;
        if (k >= 2) {               // more units than stashed (large shapes)
          stash_fragments(p, mt, st);
          tc::cp_async_commit();
          tc::cp_async_wait<0>();
        }
        kmax = dash_unit<kBF>(p, dst, mt, u / mtiles, st, rows, part, kmax);
      }
      stamp(p, 2);
      kmax = block_max(kmax, red);
      if (tid == 0) p.maxima[item] = kmax;
    }
  }
  stamp(p, 3);

  cg::this_grid().sync();
  stamp(p, 4);

  // -- phase 2: features, A = q'k'^T, out = A v / rowsum(A) --------------------
  // the block's first share of the maxima
  const float g0 = tid < p.items ? __ldcg(p.maxima + tid) : -INFINITY;
  float gmax = -INFINITY;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int t = item / p.H, h = item % p.H;
    if (!resident) {
      __syncthreads();              // the previous item's reads are done
      // the item's dash, v and rows in one round of loads, straight into
      // F | V | X, and the key mask's bytes
      const float4* src =
          reinterpret_cast<const float4*>(p.dash + (size_t)item * R * p.MP);
      const T* vb = qkv<T>(p.v) + t * p.vs_t + h * p.vs_h;
      const T* qb = qkv<T>(p.q) + t * p.qs_t + h * p.qs_h;
      const T* kb = qkv<T>(p.k) + t * p.ks_t + h * p.ks_h;
      const int nf = R * M4, e4 = p.e / 4;
      const bool kept = tid < p.Nk && (p.mask == nullptr ||
                                       p.mask[t * p.ms_t + tid * p.ms_n]);
      batched<7>(
          nf + nv + R * DP / 4,
          [&](int i) {
            if (i < nf) return __ldcg(src + i);
            if (i < nf + nv)
              return ld4(vb + (i - nf) / e4 * p.vs_n + (i - nf) % e4 * 4);
            const int j = i - nf - nv, r = j / (DP / 4), c = j % (DP / 4) * 4;
            if (c >= p.d) return make_float4(0.f, 0.f, 0.f, 0.f);
            return r < p.Nq ? ld4(qb + r * p.qs_n + c)
                            : ld4(kb + (r - p.Nq) * p.ks_n + c);
          },
          [&](int i, float4 x) { F4[i] = x; });
      if (tid < p.Nk) keep[tid] = kept ? 1.f : 0.f;
    }
    if (item == blockIdx.x) {       // every thread holds the same gmax
      float g = g0;
      for (int i = tid + THREADS; i < p.items; i += THREADS)
        g = fmaxf(g, __ldcg(p.maxima + i));
      gmax = block_max(g, red);
      if (p.kmax != nullptr) gmax = __ldg(p.kmax);
    } else {
      __syncthreads();
    }
    stamp(p, 5);

    // a warp per row: diag from the unscaled row, the row max for q, then
    // q' or k' in place (0 in the padded columns)
    for (int r = warp; r < R; r += WARPS) {
      const float x0 = X[r * DP + lane], x1 = X[r * DP + lane + 32];
      float diag;
      if constexpr (kBF)
        diag = tc::bf16r(
            tc::bf16r(warp_sum(tc::bf16r(x0 * x0) + tc::bf16r(x1 * x1))) /
            2.0f * p.dn2);
      else
        diag = warp_sum(fmaf(x1, x1, x0 * x0)) / 2.0f * p.dn2;
      float4 x[MAX_MP / 128];
#pragma unroll
      for (int j = 0; j < MAX_MP / 128; ++j) {
        const int c4 = lane + 32 * j;
        x[j] = c4 < M4 ? F4[r * M4 + c4] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float stab = gmax, kp = 1.f;
      if (r < p.Nq) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < MAX_MP / 128; ++j) {
          const int c = 4 * (lane + 32 * j);
          if (c < p.m) mx = fmaxf(mx, x[j].x);
          if (c + 1 < p.m) mx = fmaxf(mx, x[j].y);
          if (c + 2 < p.m) mx = fmaxf(mx, x[j].z);
          if (c + 3 < p.m) mx = fmaxf(mx, x[j].w);
        }
        stab = warp_max(mx);
      } else {
        kp = keep[r - p.Nq];
      }
#pragma unroll
      for (int j = 0; j < MAX_MP / 128; ++j) {
        const int c4 = lane + 32 * j;
        if (c4 < M4) F4[r * M4 + c4] = features4(p, x[j], 4 * c4, diag, stab, kp);
      }
    }
    __syncthreads();
    stamp(p, 6);

    // A = q' k'^T: a warp per tile of 2 q rows x 4 k rows, the lanes
    // splitting the sum over the features four columns at a time
    const int tk = (p.Nk + 3) / 4, ntiles = (p.Nq + 1) / 2 * tk;
    for (int tile = warp; tile < ntiles; tile += WARPS) {
      const int i0 = tile / tk * 2, n0 = tile % tk * 4;
      const float4* fq[2];
      const float4* fk[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) fq[a] = F4 + min(i0 + a, p.Nq - 1) * M4;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        fk[b] = F4 + (p.Nq + min(n0 + b, p.Nk - 1)) * M4;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int c4 = lane; c4 < M4; c4 += 32) {
        float4 x[2], y[4];
#pragma unroll
        for (int a = 0; a < 2; ++a) x[a] = fq[a][c4];
#pragma unroll
        for (int b = 0; b < 4; ++b) y[b] = fk[b][c4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float& s = acc[a * 4 + b];
            s = fmaf(x[a].x, y[b].x, s);
            s = fmaf(x[a].y, y[b].y, s);
            s = fmaf(x[a].z, y[b].z, s);
            s = fmaf(x[a].w, y[b].w, s);
          }
      }
      const float sum = warp_sum8(acc);
      const int i = i0 + (lane >> 4), n = n0 + ((lane >> 2) & 3);
      if ((lane & 3) == 0 && i < p.Nq && n < p.Nk) A[i * p.Nk + n] = sum;
    }
    __syncthreads();
    stamp(p, 7);

    // out = A v / rowsum(A): four outputs a thread, their sums interleaved
    float* ob = p.out + (size_t)item * p.Nq * p.e;
    const int no = p.Nq * p.e;
    for (int o0 = tid; o0 < no; o0 += 4 * THREADS) {
      float num[4] = {0.f, 0.f, 0.f, 0.f}, den[4] = {0.f, 0.f, 0.f, 0.f};
      int ii[4], cc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = min(o0 + u * THREADS, no - 1);
        ii[u] = o / p.e;
        cc[u] = o % p.e;
      }
      for (int n = 0; n < p.Nk; ++n) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float a = A[ii[u] * p.Nk + n];
          num[u] = fmaf(a, V[n * p.e + cc[u]], num[u]);
          den[u] += a;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (o0 + u * THREADS < no) ob[o0 + u * THREADS] = num[u] / den[u];
    }
  }
  stamp(p, 8);
}

int coresident[MAX_DEVICES];        // blocks that fit the card at once; 0 =
                                    // not queried on that device yet

}  // namespace

// Shared memory the shape needs (bytes); the launch takes SMEM_BYTES.
extern "C" int wmfml_favor_smem_bytes(int Nq, int Nk, int e, int m) {
  return (red_offset(Nq, Nk, e, m_pad(m)) + WARPS) * (int)sizeof(float);
}

// Co-resident blocks on the current device (queried once per device, the
// fewer of the two element types' kernels), or a negative cudaError_t.
template <class T>
cudaError_t per_sm_blocks(int& per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      favor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, favor_kernel<T>,
                                                       THREADS, SMEM_BYTES);
}

extern "C" int wmfml_favor_coresident() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (coresident[dev] == 0) {
    int sms = 0, per_f32 = 0, per_bf16 = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    if ((err = per_sm_blocks<float>(per_f32)) != cudaSuccess) return -(int)err;
    if ((err = per_sm_blocks<__nv_bfloat16>(per_bf16)) != cudaSuccess)
      return -(int)err;
    const int per_sm = per_f32 < per_bf16 ? per_f32 : per_bf16;
    if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
    coresident[dev] = per_sm * sms;
  }
  return coresident[dev];
}

// q [T,H,Nq,d], k [T,H,Nk,d], v [T,H,Nk,e] at element strides (t, h, n),
// each a multiple of 4, unit stride along the last axis and aligned to four
// elements; float32, or bfloat16 with bf16 set (then dn and dn2 the
// bfloat16-rounded normalizers);
// proj [m, d] contiguous, 16-byte aligned; d and e multiples of 4, d <= 64;
// mask [T, Nk] bytes at strides (t, n), or null; scratch
// [T*H * ((Nq + Nk) * MP + 1)] floats, 16-byte aligned, with MP = m rounded
// up to 16, m <= 512 (dash, then the items' key maxima); out [T,H,Nq,e]
// contiguous; stamps null, or [T*H, 9] int64 for the phase clock; kmax
// null, or one float on the card taken as the key max in place of the
// keys' own (a data-parallel mesh's max over every rank's keys). One
// cooperative launch on `stream`. Returns its cudaError_t, or -1 when the
// shape does not fit the kernel.
extern "C" int wmfml_favor_fwd(const void* q, const void* k, const void* v,
                               const float* proj, const unsigned char* mask,
                               float* scratch, float* out, long long* stamps,
                               const float* kmax,
                               long long qs_t, long long qs_h, long long qs_n,
                               long long ks_t, long long ks_h, long long ks_n,
                               long long vs_t, long long vs_h, long long vs_n,
                               long long ms_t, long long ms_n, int T, int H,
                               int Nq, int Nk, int d, int e, int m, int bf16,
                               float dn, float dn2, float ratio, float eps,
                               void* stream) {
  if (d < 1 || d > DP || d % 4 || e < 1 || e % 4 || Nq < 1 || Nk < 1 ||
      m < 1 || m_pad(m) > MAX_MP ||
      wmfml_favor_smem_bytes(Nq, Nk, e, m) > SMEM_BYTES)
    return -1;
  const int items = T * H;
  if (items == 0) return 0;
  const int blocks = wmfml_favor_coresident();
  if (blocks < 0) return -blocks;
  const int MP = m_pad(m);
  float* maxima = scratch + (size_t)items * (Nq + Nk) * MP;
  const Params p{q,    k,    v,    proj, mask, scratch, maxima, out,
                 stamps, qs_t, qs_h, qs_n, ks_t, ks_h, ks_n, vs_t, vs_h,
                 vs_n, ms_t, ms_n, items, H, Nq, Nk, d, e, m, MP,
                 dn,   dn2,  ratio, eps, kmax};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items < blocks ? items : blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      bf16 ? cudaLaunchKernelEx(&cfg, favor_kernel<__nv_bfloat16>, p)
           : cudaLaunchKernelEx(&cfg, favor_kernel<float>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// -- K2 wide: heads too wide for the kernel above ------------------------------
//
// The same function for d <= 256, any m and any Nq, Nk, float32 or bfloat16
// q, k, v: LargeCNP's full-width heads (d = e = 256, m = int(256 ln 256) =
// 1419; ANPDistractor at Nq = 18, Nk = 15 in training and Nq = 36, Nk <= 25
// in evaluation; ANP on ShapeNet3D at 15 + 15 and 30 + 25). An item's
// features take (Nq + Nk) m floats, 347 KB at R = Nq + Nk = 61: no block
// holds them, and this form never writes them out either.
//
// Bound: the dash products, 2 R m d an item (3.84 GFLOP at T = 20, H = 8,
// R = 33: 0.023 ms in 3xTF32 at the tensor cores' rate), against about
// 7 MB of inputs and output (0.002 ms at 3.35 TB/s): the products bound it.
//
// What held the earlier wide form back (0.363 device ms at D1, 16x its
// bound; phase 1 256 of 360 us): mma.sync m16n8k8 at a fraction of wgmma's
// TF32 rate, the projection split again by every warp at every k-step, rows
// in 16-row tiles (48 rows computed at R = 33), each unit restaging its rows
// with no overlap, dash written to and read back from global memory (30 MB
// each way at D1), and after the grid barrier one item a block walking 12
// feature chunks in series.
//
// Design, one cooperative launch on a persistent grid (one block of four
// warpgroups an SM; grid min(items x feature tiles, co-resident blocks)):
//   * Phase 1, units of (feature tile of FT = 64, item, row pair), tile
//     major, each block a contiguous run of units: the projection tile is
//     split into big and small once when the run enters it and stays in
//     shared memory across the run's items. A row pair is the item's rows
//     when R <= 64 (every shipped shape), else a chunk of q rows and a chunk
//     of k rows (kc = min(Nk, max(64 - Nq, 32)) k rows, 64 - kc q rows).
//     - Warpgroups 0 and 1 stage and multiply. dash^T = P_tile (dn rows)^T
//       as wgmma m64nNk8 .tf32 with both operands in shared memory, N = the
//       rows rounded up to 8 (n40 at R = 33; past 40 rows two products,
//       n40 + n24 at R = 61), split-K over the two warpgroups and the two
//       partial tiles added in a fixed order. Per k-step small*big,
//       big*small, big*big (bfloat16 rows: small part 0, two products).
//       The rows are split once a unit: each thread loads the next
//       product's rows into registers while the current one runs, then
//       scales, splits and stores them in the core-matrix order the
//       descriptors read (K halves 128 B apart, row groups 256 B apart).
//     - Warpgroups 2 and 3 run each unit's epilogue while 0 and 1 stage and
//       multiply the next unit (named barriers hand the dash tile over):
//       per (item, tile) the stabilisers c_q[i] = max over the tile's real
//       features of dash_q[i] and c_k = max over the tile and the pair's k
//       rows (masked rows included) of dash_k; E = exp(dash - c) (0 past
//       m); the partials S[i][n] = sum_j Eq[i][j] Ek[n][j], Q[i] =
//       sum_j Eq[i][j], K[n] = sum_j Ek[n][j] to the scratch tensor (about
//       5 MB at D1, against dash's 30 MB), c_k to its own array. The
//       diagonal terms are a factor of each row (e^-diag), so they leave
//       the tiles: the units of tile 0 write them for phase 2.
//     - L2 traffic of the order: at D1, 3,680 (tile, item) units restage
//       33 rows x 1 KB = 121 MB of rows over the phase, and each block
//       reads its one or two projection tiles (64 KB each) once.
//   * grid.sync().
//   * Phase 2, units of (item, slice of q rows) over every block: the one
//     key max gmax = max of all c_k (a max is exact in any order: every
//     block holds the same bits), stab_i = max_t c_q[i][t], alpha =
//     e^(c_q - stab_i - diag_i), beta = e^(c_k - gmax - diag_n) (the
//     reference's e^(dash - diag - stab) split at the tile's max), and
//       A[i][n] = ratio^2 keep_n sum_t (alpha beta S_t + eps alpha Q_t[i]
//                 + eps beta K_t[n] + eps^2 cnt_t),
//     summed over the tiles in order (cnt_t the tile's real features): q'
//     k'^T with the + eps terms expanded, the same function reassociated.
//     The unit's partials, v and the mask come in one round of loads; out =
//     (A v) / rowsum(A), k rows in phase 1's chunks, the sums carried in
//     order. The slices per item follow the grid: one at D1's 160 items,
//     four at R100's 32.
//   The reassociated sums hold TOL["favor_attention_wide"] (atol 1e-5, rtol
//   1e-4) against the reference at every shape the tests hold (a float32
//   emulation of this order in tests/test_torch_port_favor_wide.py against
//   the JAX function, and the kernel against its twin on the card), so the
//   features are never formed.
//   Where it departs from a plain Hopper pipeline, and why (PERF.md):
//   the projection's A fragments held in registers (128 a thread at two
//   warpgroups) left no room and had ptxas fence the products; shared
//   memory (232,448 bytes a block) holds A split (128 KB), B for 40 rows
//   split (80 KB) and the dash tile (17 KB), with no room for a second B or
//   a staging buffer, so the rows wait in registers and the products wait
//   for their staging; a warpgroup issuing wgmma blocks until the products
//   run, so the epilogue has warpgroups of its own.
// No atomics: two calls give the same bits. The backward stays on the twin.
// An optional phase clock (stamps: start, first unit staged, phase 1 done,
// barrier passed, end, a row a block) shows where the call's time goes.
//
// bfloat16 q, k, v (favor_kernel_wide<__nv_bfloat16>), with the narrow
// kernel's rounding points: the rows are read four values (8 bytes) a load
// and widened exactly; dn x rounds to bfloat16 (dn rounded), so its small
// part is 0 and dash takes two TF32 products a k-step, not three; the
// diagonal term is bf16(bf16(sum of bf16(x^2)) / 2 dn^2); v is widened;
// everything after is float32, and so is the output.

namespace {
namespace wide {

constexpr int THREADS = 512;        // four warpgroups: 0 and 1 stage the
                                    // rows and run the products, 2 and 3
                                    // the epilogues beside them
constexpr int WARPS = THREADS / 32;
constexpr int MT = 256;             // the product warpgroups' threads
constexpr int HT = THREADS - MT;    // the epilogue warpgroups' threads
// named barriers: 1 the dash tile is free (epilogue done), 2 it is written
// (all threads); 3 the product warpgroups; 4 the epilogue warpgroups
constexpr int BAR_FREE = 1, BAR_READY = 2, BAR_MMA = 3, BAR_EPI = 4;
constexpr int DW = 256;             // the widest head: d <= 256
constexpr int EW = 256;             // the widest v row: e <= 256
constexpr int FT = 64;              // features a tile: the wgmma M
constexpr int RG = 64;              // rows a row pair at most
constexpr int RB = 40;              // rows a product at most: its N
constexpr int GB = RB / 8;          // B's row groups
constexpr int KS = DW / 8 / 2;      // k-steps a warpgroup takes at most
constexpr int DLD = FT + 4;         // the dash tile's row stride
constexpr int QB = 64;              // phase 2: q rows a unit at most
// Shared memory (floats). Phase 1: A big, A small (the projection tile,
// FT x DW each) | B big, B small (RB x DW each; both in the core-matrix
// order the descriptors read: float4 ((s G + g) 2 + half) 8 + r holds row
// 8 g + r, columns 8 s + 4 half .. + 3, G = 8 for A and GB for B) | dash
// tile [RG][DLD] | the rows' sums of squares in two halves [2][RB] | row
// maxima [RG] | red [WARPS]. Phase 2: v [RG][EW] | A [QB][RG] | keep [RG]
// | den, stab, the q rows' diagonal terms [QB each] | the k rows' [RG] |
// the tile chunk's partials, below red.
constexpr int P1_AS = FT * DW;
constexpr int P1_B = 2 * FT * DW;
constexpr int P1_BS = P1_B + RB * DW;
constexpr int P1_D = P1_B + 2 * RB * DW;
constexpr int P1_SSQ = P1_D + RG * DLD;
constexpr int P1_RMX = P1_SSQ + 2 * RB;
constexpr int RED = P1_RMX + RG;
constexpr int SMEM_BYTES = (RED + WARPS) * 4;
constexpr int P2_A = RG * EW;
constexpr int P2_KEEP = P2_A + QB * RG;
constexpr int P2_DEN = P2_KEEP + RG;
constexpr int P2_STAB = P2_DEN + QB;
constexpr int P2_DQ = P2_STAB + QB;
constexpr int P2_DK = P2_DQ + QB;
constexpr int P2_T = P2_DK + RG;
static_assert(P2_T % 4 == 0 && P1_B % 4 == 0 && P1_D % 4 == 0,
              "float4 regions");
static_assert(SMEM_BYTES <= 232448, "one block an SM");
// phase clock points per block: start, first unit staged, phase 1 done,
// barrier passed, end
constexpr int STAMPS = 5;

__host__ __device__ inline int round_up(int x, int n) { return (x + n - 1) / n * n; }

// Phase 2's partials of a chunk of tb tiles, qr q rows and a k chunk of
// kcp (a multiple of 4) columns: S [tb][qr][kcp] | Q, alpha [tb][qr] each |
// K, beta [tb][kcp] each | c_k [tb]
__host__ __device__ inline int p2_q(int tb, int qr, int kcp) { return tb * qr * kcp; }
__host__ __device__ inline int p2_al(int tb, int qr, int kcp) {
  return p2_q(tb, qr, kcp) + tb * qr;
}
__host__ __device__ inline int p2_k(int tb, int qr, int kcp) {
  return round_up(p2_al(tb, qr, kcp) + tb * qr, 4);
}
__host__ __device__ inline int p2_be(int tb, int qr, int kcp) {
  return p2_k(tb, qr, kcp) + tb * kcp;
}
__host__ __device__ inline int p2_ck(int tb, int qr, int kcp) {
  return p2_be(tb, qr, kcp) + tb * kcp;
}
__host__ __device__ inline int p2_floats(int tb, int qr, int kcp) {
  return p2_ck(tb, qr, kcp) + tb;
}

struct Params {
  const void* q;                    // float or __nv_bfloat16, as the kernel's T
  const void* k;
  const void* v;
  const float* proj;
  const unsigned char* mask;        // [T, Nk] bytes 0/1, or null: all real
  float* part;                      // scratch [items][per_item]: the partials
  float* ck;                        // scratch [items][tiles][kchunks]: c_k
  float* diag;                      // scratch [items][Nq + Nk]
  float* out;                       // [items][Nq][e]
  long long* stamps;                // [gridDim][STAMPS] or null
  long long qs_t, qs_h, qs_n, ks_t, ks_h, ks_n, vs_t, vs_h, vs_n, ms_t, ms_n;
  int items, H, Nq, Nk, d, e, m;
  int tiles, ksteps;                // feature tiles, k-steps (d / 8 rounded
                                    // up to even)
  int qc, kc, qchunks, kchunks;     // the row pairs: q and k chunks
  int kcp;                          // kc rounded up to 4
  int oQ, oCQ, oK, per_item;        // an item's partials: S [tiles][Nq]
                                    // [kchunks][kcp] | Q, c_q [tiles][Nq] |
                                    // K [tiles][kchunks][kcp]
  int qr, qslices, tb;              // phase 2: q rows a unit, units an item,
                                    // tiles a chunk
  float dn, dn2, ratio, eps;
  const float* kmax;                // [1] the key max to take, or null: the
                                    // keys' own (a data-parallel mesh's)
};

__device__ inline void stamp(const Params& p, int j) {
  if (p.stamps != nullptr && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[blockIdx.x * STAMPS + j] = t;
  }
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

// n scalar copies, load(i) then store(i, x), U loads in flight per thread
template <int U, class Load, class Store>
__device__ __forceinline__ void batched1(int n, Load load, Store store) {
  for (int base = threadIdx.x; base < n; base += THREADS * U) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      x[u] = i < n ? load(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      if (i < n) store(i, x[u]);
    }
  }
}

// Four elements of q, k or the projection as they are read: float4, or
// four bfloat16 in a uint2
template <class T>
struct Vec4 {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};
__device__ inline float4 ldvec(const float* p) { return ldg4(p); }
__device__ inline uint2 ldvec(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ inline float4 widen(float4 x) { return x; }
__device__ inline float4 widen(uint2 r) {
  return make_float4(tc::bf16_lo(r.x), tc::bf16_hi(r.x), tc::bf16_lo(r.y),
                     tc::bf16_hi(r.y));
}
template <class V>
__device__ inline V zero_vec() {
  if constexpr (sizeof(V) == 16)
    return make_float4(0.f, 0.f, 0.f, 0.f);
  else
    return make_uint2(0u, 0u);
}

// Rows of an operand in flight through registers: task x is row 8 (x >>
// 6) + (x & 7) at the float4 columns cb + 8 k, k < 8, cb = (x >> 3) & 7.
// Eight neighbouring lanes hold eight rows of one row group, so their
// stores to the core-matrix order hit 128 contiguous bytes.
template <class T>
struct Staged {
  typename Vec4<T>::type x[2][8];   // tasks threadIdx.x and + MT
};

// task x of rows [0, nrows) from row(r) (zero past nrows and past d)
template <class T, class Row>
__device__ __forceinline__ void load_staged(typename Vec4<T>::type (&st)[8],
                                            int x, int nrows, int d, Row row) {
  using V = typename Vec4<T>::type;
  const int r = 8 * (x >> 6) + (x & 7), cb = (x >> 3) & 7;
  const bool ok = r < nrows;
  const T* src = row(ok ? r : 0);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = 4 * (cb + 8 * k);
    st[k] = ok && c < d ? ldvec(src + c) : zero_vec<V>();
  }
}

// Task x of the staged rows, times scale (rounded to bfloat16 where
// kRound), split into big and small (small only where kSmall) at the
// operand's G row groups. With ssq, the row's sum of squares of the
// unscaled values (bfloat16 rows: of their bfloat16 squares), in two
// halves: ssq[h * RB + r], h the half of the columns.
template <class T, bool kSmall, bool kRound>
__device__ __forceinline__ void store_staged(
    const typename Vec4<T>::type (&st)[8], int x, int G, float scale,
    float* big, float* small, float* ssq) {
  constexpr bool kBF = sizeof(T) == 2;
  float4* b4 = reinterpret_cast<float4*>(big);
  float4* s4 = reinterpret_cast<float4*>(small);
  const int r8 = x & 7, cb = (x >> 3) & 7, g = x >> 6;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 v = widen(st[k]);
    if (ssq != nullptr) {
      if constexpr (kBF) {
        ss += tc::bf16r(v.x * v.x);
        ss += tc::bf16r(v.y * v.y);
        ss += tc::bf16r(v.z * v.z);
        ss += tc::bf16r(v.w * v.w);
      } else {
        ss = fmaf(v.x, v.x, ss);
        ss = fmaf(v.y, v.y, ss);
        ss = fmaf(v.z, v.z, ss);
        ss = fmaf(v.w, v.w, ss);
      }
    }
    float y[4] = {scale * v.x, scale * v.y, scale * v.z, scale * v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kRound) y[i] = tc::bf16r(y[i]);
      tc::split(y[i], hi[i], lo[i]);
    }
    const int c4 = cb + 8 * k, f = (((c4 >> 1) * G + g) * 2 + (c4 & 1)) * 8 + r8;
    b4[f] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                        __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    if constexpr (kSmall)
      s4[f] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                          __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  }
  if (ssq != nullptr) {
    // the four column blocks of this row in this warp (lanes r8 + 8 j),
    // then a half: (cb >> 2) is the warp's parity
    ss += __shfl_xor_sync(0xffffffffu, ss, 8);
    ss += __shfl_xor_sync(0xffffffffu, ss, 16);
    if ((threadIdx.x & 31) < 8) ssq[(cb >> 2) * RB + 8 * g + r8] = ss;
  }
}

// A unit of phase 1: feature tile, item, the pair's q rows q0.. (nq) and k
// rows k0.. (nk), its chunk indices qi, ki
struct Unit {
  int tile, item, qi, ki, q0, nq, k0, nk;
};

__device__ inline Unit unit_of(const Params& p, int u) {
  const int pairs = p.qchunks * p.kchunks, per_tile = p.items * pairs;
  Unit w;
  w.tile = u / per_tile;
  const int rem = u - w.tile * per_tile;
  w.item = rem / pairs;
  const int pr = rem - w.item * pairs;
  w.qi = pr / p.kchunks;
  w.ki = pr - w.qi * p.kchunks;
  w.q0 = w.qi * p.qc;
  w.nq = min(p.qc, p.Nq - w.q0);
  w.k0 = w.ki * p.kc;
  w.nk = min(p.kc, p.Nk - w.k0);
  return w;
}

// The pair's row r: its row in the item (q rows, then k rows)
__device__ inline int item_row(const Params& p, const Unit& w, int r) {
  return r < w.nq ? w.q0 + r : p.Nq + w.k0 + r - w.nq;
}

// The pair's rows off .. off + n into registers, this thread's task
template <class T>
__device__ __forceinline__ void load_rows(const Params& p, Staged<T>& st,
                                          const Unit& w, int off, int n) {
  const int t = w.item / p.H, h = w.item - t * p.H;
  const T* qb = qkv<T>(p.q) + t * p.qs_t + h * p.qs_h + w.q0 * p.qs_n;
  const T* kb = qkv<T>(p.k) + t * p.ks_t + h * p.ks_h + w.k0 * p.ks_n;
  const auto row = [&](int r) {
    r += off;
    return r < w.nq ? qb + r * p.qs_n : kb + (r - w.nq) * p.ks_n;
  };
#pragma unroll
  for (int a = 0; a < 2; ++a)
    load_staged<T>(st.x[a], threadIdx.x + a * MT, n, p.d, row);
}

// The projection tile into A: big and small, rows past m zero (512 tasks)
__device__ void stage_tile(const Params& p, float* smem, int tile) {
  const int j0 = tile * FT, rows = min(FT, p.m - j0);
  Staged<float> st;
#pragma unroll
  for (int a = 0; a < 2; ++a)
    load_staged<float>(st.x[a], threadIdx.x + a * MT, rows, p.d,
                       [&](int r) { return p.proj + (size_t)(j0 + r) * p.d; });
#pragma unroll
  for (int a = 0; a < 2; ++a)
    store_staged<float, true, false>(st.x[a], threadIdx.x + a * MT, 8,
                                     1.f, smem, smem + P1_AS, nullptr);
}

// The dash tile of the pair's rows off .. off + N, on the product
// warpgroups: each one's product over its half of the k-steps from s0
// (m64nNk8, A and B through descriptors; per k-step small*big, big*small,
// big*big, bfloat16 rows two), then, once the epilogue warpgroups are done
// with the previous unit's tile (off = 0), warpgroup 0's partial +
// warpgroup 1's, in that order, into rows off .. of the dash tile. kFull
// (d > 248): the k-steps known to the compiler.
template <bool kBF, int N, bool kFull>
__device__ __forceinline__ void dash_tile(const Params& p, float* smem,
                                          int s0, int off) {
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const float* abig = smem;
  const float* asmall = smem + P1_AS;
  const float* bbig = smem + P1_B;
  const float* bsmall = smem + P1_BS;
  const int ns = p.ksteps / 2;
  tc::fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (kFull || s < ns) {
      const int ks = s0 + s;
      const uint64_t ab = tc::desc_b(abig + ks * 8 * 64, 128, 256);
      const uint64_t bb = tc::desc_b(bbig + ks * GB * 64, 128, 256);
      tc::mma_ss<N>(acc, tc::desc_b(asmall + ks * 8 * 64, 128, 256), bb);
      if constexpr (!kBF)
        tc::mma_ss<N>(acc, ab, tc::desc_b(bsmall + ks * GB * 64, 128, 256));
      tc::mma_ss<N>(acc, ab, bb);
    }
  }
  tc::commit();
  tc::wait<0>();
  tc::pin(acc);
  tc::named_sync(BAR_MMA, MT);      // both products are done: B is free
  if (off == 0) tc::named_sync(BAR_FREE, THREADS);
  // acc holds dash at feature 16 w + g (+ 8) of the tile, row 8 jj + 2 t
  // (+ 1) of the product
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  const int j0 = wl * 16 + (lane >> 2), tq = lane & 3;
  const bool second = threadIdx.x >= 128;
  float* D = smem + P1_D + off * DLD;
  if (second)
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        D[(8 * jj + 2 * tq + (e & 1)) * DLD + j0 + (e >> 1) * 8] =
            acc[4 * jj + e];
  tc::named_sync(BAR_MMA, MT);
  if (!second)
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = D[(8 * jj + 2 * tq + (e & 1)) * DLD + j0 + (e >> 1) * 8];
        x = acc[4 * jj + e] + x;
      }
}

// dash_tile at the width of the product's rows rounded up to 8
template <bool kBF, bool kFull>
__device__ __forceinline__ void product(const Params& p, float* smem, int s0,
                                        int off, int n8) {
  switch (n8 / 8) {
    case 1: dash_tile<kBF, 8, kFull>(p, smem, s0, off); break;
    case 2: dash_tile<kBF, 16, kFull>(p, smem, s0, off); break;
    case 3: dash_tile<kBF, 24, kFull>(p, smem, s0, off); break;
    case 4: dash_tile<kBF, 32, kFull>(p, smem, s0, off); break;
    default: dash_tile<kBF, 40, kFull>(p, smem, s0, off); break;
  }
}

// The epilogue of a unit, on the epilogue warpgroups while the product
// warpgroups stage and multiply the next unit: the stabilisers, E = exp(dash
// - c) in place (the diagonal terms are a factor of each row and wait for
// phase 2), and the partials S, Q, K, c_q, c_k to the scratch tensor. Each
// thread carries several independent chains: a half-warp takes its rows
// hw, hw + 16, .. together (hw = 2 warp + half), and each sum of S runs in
// four parts.
__device__ void epilogue(const Params& p, float* smem, const Unit& w) {
  constexpr int HW = HT / 32;
  constexpr int RPH = RG / (2 * HW);      // rows a half-warp at most
  const int tid = threadIdx.x - MT, lane = tid & 31, warp = tid >> 5;
  const int hl = lane & 15, hw = 2 * warp + (lane >> 4);
  const int rn = w.nq + w.nk;
  float* D = smem + P1_D;
  float* rmx = smem + P1_RMX;
  const int j = w.tile * FT + 4 * hl;     // the lane's four features
  const bool real[4] = {j < p.m, j + 1 < p.m, j + 2 < p.m, j + 3 < p.m};
  float4 x[RPH];
  float mx[RPH];
#pragma unroll
  for (int k = 0; k < RPH; ++k) {
    const int r = min(hw + 2 * HW * k, rn - 1);
    x[k] = *reinterpret_cast<const float4*>(D + r * DLD + 4 * hl);
    mx[k] = real[0] ? x[k].x : -INFINITY;
    if (real[1]) mx[k] = fmaxf(mx[k], x[k].y);
    if (real[2]) mx[k] = fmaxf(mx[k], x[k].z);
    if (real[3]) mx[k] = fmaxf(mx[k], x[k].w);
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < RPH; ++k)
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], o));
#pragma unroll
  for (int k = 0; k < RPH; ++k) {
    const int r = hw + 2 * HW * k;
    if (hl == 0 && r < rn) rmx[r] = mx[k];
  }
  tc::named_sync(BAR_EPI, HT);
  float ck = -INFINITY;                   // the k rows' max, masked rows in
  for (int r = w.nq + lane; r < rn; r += 32) ck = fmaxf(ck, rmx[r]);
  ck = warp_max(ck);
  float sum[RPH];
#pragma unroll
  for (int k = 0; k < RPH; ++k) {
    const int r = hw + 2 * HW * k;
    const float c = r < w.nq ? mx[k] : ck;
    const float4 y = make_float4(real[0] ? expf(x[k].x - c) : 0.f,
                                 real[1] ? expf(x[k].y - c) : 0.f,
                                 real[2] ? expf(x[k].z - c) : 0.f,
                                 real[3] ? expf(x[k].w - c) : 0.f);
    x[k] = y;
    sum[k] = (y.x + y.y) + (y.z + y.w);
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < RPH; ++k)
      sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], o);
  float* part = p.part + (size_t)w.item * p.per_item;
#pragma unroll
  for (int k = 0; k < RPH; ++k) {
    const int r = hw + 2 * HW * k;
    if (r < rn) {
      *reinterpret_cast<float4*>(D + r * DLD + 4 * hl) = x[k];
      if (hl == 0) {
        if (r < w.nq) {
          if (w.ki == 0) {
            const int o = w.tile * p.Nq + w.q0 + r;
            part[p.oQ + o] = sum[k];
            part[p.oCQ + o] = mx[k];
          }
        } else if (w.qi == 0) {
          part[p.oK + (w.tile * p.kchunks + w.ki) * p.kcp + r - w.nq] = sum[k];
        }
      }
    }
  }
  if (tid == 0 && w.qi == 0)
    p.ck[((size_t)w.item * p.tiles + w.tile) * p.kchunks + w.ki] = ck;
  tc::named_sync(BAR_EPI, HT);
  // S = Eq Ek^T over the tile's 64 features: a thread per (q row, k row),
  // each sum in four parts (columns 4 c + i), added in a fixed order
  for (int i = tid; i < w.nq * w.nk; i += HT) {
    const int a = i / w.nk, n = i - a * w.nk;
    const float4* xa = reinterpret_cast<const float4*>(D + a * DLD);
    const float4* yn = reinterpret_cast<const float4*>(D + (w.nq + n) * DLD);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int c = 0; c < FT / 4; ++c) {
      const float4 u = xa[c], v = yn[c];
      s0 = fmaf(u.x, v.x, s0);
      s1 = fmaf(u.y, v.y, s1);
      s2 = fmaf(u.z, v.z, s2);
      s3 = fmaf(u.w, v.w, s3);
    }
    part[(((size_t)w.tile * p.Nq + w.q0 + a) * p.kchunks + w.ki) * p.kcp + n] =
        (s0 + s1) + (s2 + s3);
  }
}

// Phase 2 for one unit: the q rows i0 .. of item `item` (slice sl).
template <class T>
__device__ void attend(const Params& p, float* smem, int item, int sl,
                       float gmax) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = sl * p.qr, nr = min(p.qr, p.Nq - i0);
  if (nr <= 0) return;
  const int t = item / p.H, h = item - t * p.H;
  const int qr = p.qr, kcp = p.kcp, k4 = kcp / 4, e4 = p.e / 4;
  float* V = smem;
  float* A = smem + P2_A;
  float* keep = smem + P2_KEEP;
  float* den = smem + P2_DEN;
  float* stab = smem + P2_STAB;
  float* dq = smem + P2_DQ;
  float* dk = smem + P2_DK;
  float* Ss = smem + P2_T;
  float* Qs = Ss + p2_q(p.tb, qr, kcp);
  float* ALs = Ss + p2_al(p.tb, qr, kcp);
  float* Ks = Ss + p2_k(p.tb, qr, kcp);
  float* BEs = Ss + p2_be(p.tb, qr, kcp);
  float* CKs = Ss + p2_ck(p.tb, qr, kcp);
  const float* part = p.part + (size_t)item * p.per_item;
  const float* dg = p.diag + (size_t)item * (p.Nq + p.Nk);
  const T* vb = qkv<T>(p.v) + t * p.vs_t + h * p.vs_h;
  float* ob = p.out + ((size_t)item * p.Nq + i0) * p.e;
  const float r2 = p.ratio * p.ratio, e2 = p.eps * p.eps;
  __syncthreads();                  // the block's previous unit is done
  for (int r = warp; r < nr; r += WARPS) {   // stab_i: a warp per row
    float s = -INFINITY;
    for (int tt = lane; tt < p.tiles; tt += 32)
      s = fmaxf(s, __ldcg(part + p.oCQ + tt * p.Nq + i0 + r));
    s = warp_max(s);
    if (lane == 0) {
      stab[r] = s;
      dq[r] = __ldcg(dg + i0 + r);
    }
  }
  for (int ki = 0; ki < p.kchunks; ++ki) {
    const int k0 = ki * p.kc, nk = min(p.kc, p.Nk - k0);
    for (int t0 = 0; t0 < p.tiles; t0 += p.tb) {
      const int tb = min(p.tb, p.tiles - t0);
      __syncthreads();              // the last reads are done
      // one round of loads: S and K of the chunk's tiles and, at its first
      // tile chunk, the k chunk's v rows; then Q, c_q, c_k, the k rows'
      // diagonal terms and the mask
      const int nS = tb * nr * k4, nK = tb * k4, nV = t0 == 0 ? nk * e4 : 0;
      batched<4, THREADS>(
          nS + nK + nV,
          [&](int i) {
            if (i < nS) {
              const int tt = i / (nr * k4), rem = i - tt * nr * k4;
              const int r = rem / k4, c = rem - r * k4;
              return __ldcg(reinterpret_cast<const float4*>(
                                part + (((size_t)(t0 + tt) * p.Nq + i0 + r) *
                                            p.kchunks + ki) * kcp) + c);
            }
            i -= nS;
            if (i < nK) {
              const int tt = i / k4, c = i - tt * k4;
              return __ldcg(reinterpret_cast<const float4*>(
                                part + p.oK +
                                ((size_t)(t0 + tt) * p.kchunks + ki) * kcp) + c);
            }
            i -= nK;
            const int n = i / e4, c = i - n * e4;
            return ld4(vb + (size_t)(k0 + n) * p.vs_n + c * 4);
          },
          [&](int i, float4 x) {
            if (i < nS) {
              const int tt = i / (nr * k4), rem = i - tt * nr * k4;
              const int r = rem / k4, c = rem - r * k4;
              store4(Ss + (tt * qr + r) * kcp + 4 * c, x);
              return;
            }
            i -= nS;
            if (i < nK) {
              const int tt = i / k4, c = i - tt * k4;
              store4(Ks + tt * kcp + 4 * c, x);
              return;
            }
            i -= nK;
            const int n = i / e4, c = i - n * e4;
            store4(V + n * p.e + 4 * c, x);
          });
      const int nq2 = tb * nr, nk2 = t0 == 0 ? 2 * nk : 0;
      batched1<4>(
          2 * nq2 + tb + nk2,
          [&](int i) {
            if (i < 2 * nq2) {
              const int j = i < nq2 ? i : i - nq2, tt = j / nr, r = j - tt * nr;
              return __ldcg(part + (i < nq2 ? p.oQ : p.oCQ) +
                            (t0 + tt) * p.Nq + i0 + r);
            }
            i -= 2 * nq2;
            if (i < tb)
              return __ldcg(p.ck + ((size_t)item * p.tiles + t0 + i) * p.kchunks +
                            ki);
            i -= tb;
            if (i < nk) return __ldcg(dg + p.Nq + k0 + i);
            i -= nk;
            return p.mask == nullptr || p.mask[t * p.ms_t + (k0 + i) * p.ms_n]
                       ? 1.f
                       : 0.f;
          },
          [&](int i, float x) {
            if (i < 2 * nq2) {
              const int j = i < nq2 ? i : i - nq2, tt = j / nr, r = j - tt * nr;
              (i < nq2 ? Qs : ALs)[tt * qr + r] = x;
              return;
            }
            i -= 2 * nq2;
            if (i < tb) {
              CKs[i] = x;
              return;
            }
            i -= tb;
            if (i < nk) {
              dk[i] = x;
              return;
            }
            keep[i - nk] = x;
          });
      __syncthreads();
      // alpha = e^(c_q - stab_i - diag_i), beta = e^(c_k - gmax - diag_n):
      // the reference's e^(dash - diag - stab) split at the tile's max
      for (int i = tid; i < tb * (nr + nk); i += THREADS) {
        if (i < tb * nr) {
          const int tt = i / nr, r = i - tt * nr;
          ALs[tt * qr + r] = expf(ALs[tt * qr + r] - stab[r] - dq[r]);
        } else {
          const int j = i - tb * nr, tt = j / nk, n = j - tt * nk;
          BEs[tt * kcp + n] = expf(CKs[tt] - gmax - dk[n]);
        }
      }
      __syncthreads();
      // A over the chunk's tiles, in tile order, carried in A
      const bool last_t = t0 + tb == p.tiles;
      for (int i = tid; i < nr * nk; i += THREADS) {
        const int r = i / nk, n = i - r * nk;
        float a = t0 == 0 ? 0.f : A[r * RG + n];
        for (int tt = 0; tt < tb; ++tt) {
          const float al = ALs[tt * qr + r], be = BEs[tt * kcp + n];
          const float cnt = (float)min(FT, p.m - (t0 + tt) * FT);
          a += al * be * Ss[(tt * qr + r) * kcp + n] +
               p.eps * al * Qs[tt * qr + r] + p.eps * be * Ks[tt * kcp + n] +
               e2 * cnt;
        }
        A[r * RG + n] = last_t ? r2 * keep[n] * a : a;
      }
    }
    __syncthreads();
    for (int r = tid; r < nr; r += THREADS) {   // the rows' sums of A
      float s = ki == 0 ? 0.f : den[r];
      for (int n = 0; n < nk; ++n) s += A[r * RG + n];
      den[r] = s;
    }
    __syncthreads();
    // the numerators A v, carried in the output from the previous k chunk
    // (each by the thread that wrote it), divided at the last: four
    // outputs a thread, their sums interleaved
    const bool last = ki + 1 == p.kchunks;
    const int no = nr * p.e;
    for (int o0 = tid; o0 < no; o0 += 4 * THREADS) {
      float num[4];
      int rr[4], cc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = min(o0 + u * THREADS, no - 1);
        rr[u] = o / p.e;
        cc[u] = o - rr[u] * p.e;
        num[u] = ki == 0 ? 0.f : ob[o];
      }
      for (int n = 0; n < nk; ++n) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          num[u] = fmaf(A[rr[u] * RG + n], V[n * p.e + cc[u]], num[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (o0 + u * THREADS < no)
          ob[o0 + u * THREADS] = last ? num[u] / den[rr[u]] : num[u];
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1) favor_kernel_wide(const Params p) {
  constexpr bool kBF = sizeof(T) == 2;
  extern __shared__ __align__(128) float smem[];
  const int pairs = p.qchunks * p.kchunks;
  const int units = p.tiles * p.items * pairs;
  const int u0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  // the warpgroup's index through a shuffle, so that the compiler knows it
  // is the same across the warp (the descriptors depend on it)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  float* ssq = smem + P1_SSQ;
  stamp(p, 0);

  // -- phase 1: dash tiles on the tensor cores, the partials -----------------
  // Products of at most RB rows, the next product's rows in flight through
  // the current one; each unit's epilogue on warpgroups 2 and 3 beside the
  // next unit's staging and products. The units of tile 0 also take each
  // row's diagonal term.
  if (wg < 2) {
    // split-K: warpgroup w the k-steps w ksteps / 2 ..
    const int s0 = wg * (p.ksteps / 2);
    const bool full = p.ksteps == 2 * KS;
    Staged<T> st;
    if (u0 < u1) {
      const Unit w = unit_of(p, u0);
      load_rows<T>(p, st, w, 0, min(RB, w.nq + w.nk));
    }
    int tile = -1;
    for (int u = u0; u < u1; ++u) {
      const Unit w = unit_of(p, u);
      const int rn = w.nq + w.nk;
      if (w.tile != tile) {         // the run enters a tile: split it once
        tile = w.tile;
        stage_tile(p, smem, tile);
      }
      for (int off = 0; off < rn; off += RB) {
        const int nsub = min(RB, rn - off), n8 = (nsub + 7) / 8 * 8;
#pragma unroll
        for (int a = 0; a < 2; ++a)
          if (threadIdx.x + a * MT < n8 * 8)  // warp-uniform
            store_staged<T, !kBF, kBF>(st.x[a], threadIdx.x + a * MT, GB,
                                       p.dn, smem + P1_B, smem + P1_BS,
                                       tile == 0 ? ssq : nullptr);
        tc::fence_async_smem();     // A and B, for wgmma's reads
        tc::named_sync(BAR_MMA, MT);
        if (tile == 0 && threadIdx.x < nsub) {  // the rows' diagonal terms
          const float s = ssq[threadIdx.x] + ssq[RB + threadIdx.x];
          p.diag[(size_t)w.item * (p.Nq + p.Nk) +
                 item_row(p, w, off + threadIdx.x)] =
              kBF ? tc::bf16r(tc::bf16r(s) / 2.0f * p.dn2) : s / 2.0f * p.dn2;
        }
        if (off + RB < rn) {
          load_rows<T>(p, st, w, off + RB, min(RB, rn - off - RB));
        } else if (u + 1 < u1) {
          const Unit nx = unit_of(p, u + 1);
          load_rows<T>(p, st, nx, 0, min(RB, nx.nq + nx.nk));
        }
        if (u == u0 && off == 0) stamp(p, 1);
        if (full)
          product<kBF, true>(p, smem, s0, off, n8);
        else
          product<kBF, false>(p, smem, s0, off, n8);
      }
      tc::named_sync(BAR_READY, THREADS);   // the tile is written
    }
  } else if (u0 < u1) {
    tc::named_sync(BAR_FREE, THREADS);       // the tile is free at first
    for (int u = u0; u < u1; ++u) {
      tc::named_sync(BAR_READY, THREADS);
      epilogue(p, smem, unit_of(p, u));
      if (u + 1 < u1) tc::named_sync(BAR_FREE, THREADS);
    }
  }
  __syncthreads();
  stamp(p, 2);
  cg::this_grid().sync();
  stamp(p, 3);

  // -- phase 2: the one key max, A, out -------------------------------------
  float g = -INFINITY;
  const int nck = p.items * p.tiles * p.kchunks;
  for (int i = threadIdx.x; i < nck; i += THREADS) g = fmaxf(g, __ldcg(p.ck + i));
  float gmax = block_max(g, smem + RED);
  if (p.kmax != nullptr) gmax = __ldg(p.kmax);
  for (int w = blockIdx.x; w < p.items * p.qslices; w += gridDim.x)
    attend<T>(p, smem, w / p.qslices, w % p.qslices, gmax);
  if (p.stamps != nullptr) {
    __syncthreads();
    stamp(p, 4);
  }
}

// blocks of favor_kernel_wide<T> an SM (the dynamic shared memory set)
template <class T>
cudaError_t per_sm_blocks(int& per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      favor_kernel_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, favor_kernel_wide<T>, THREADS, SMEM_BYTES);
}

int coresident[MAX_DEVICES];

// The row pairs and the partials' layout (Params' fields from tiles to
// per_item), for items of Nq + Nk rows and m features
void layout(Params& p, int Nq, int Nk, int d, int m) {
  p.tiles = (m + FT - 1) / FT;
  p.ksteps = round_up((d + 7) / 8, 2);  // even: half a warpgroup, 0 past d
  if (Nq + Nk <= RG) {
    p.qc = Nq;
    p.kc = Nk;
  } else {
    p.kc = min(Nk, max(RG - Nq, RG / 2));
    p.qc = min(Nq, RG - p.kc);
  }
  p.qchunks = (Nq + p.qc - 1) / p.qc;
  p.kchunks = (Nk + p.kc - 1) / p.kc;
  p.kcp = round_up(p.kc, 4);
  p.oQ = p.tiles * Nq * p.kchunks * p.kcp;
  p.oCQ = p.oQ + p.tiles * Nq;
  p.oK = round_up(p.oCQ + p.tiles * Nq, 4);
  p.per_item = p.oK + p.tiles * p.kchunks * p.kcp;
}

}  // namespace wide
}  // namespace

// Co-resident blocks of the wide kernel on the current device (queried
// once per device, the fewer of the two element types' kernels), or a
// negative cudaError_t.
extern "C" int wmfml_favor_wide_coresident() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (wide::coresident[dev] == 0) {
    int sms = 0, per_f32 = 0, per_bf16 = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    if ((err = wide::per_sm_blocks<float>(per_f32)) != cudaSuccess)
      return -(int)err;
    if ((err = wide::per_sm_blocks<__nv_bfloat16>(per_bf16)) != cudaSuccess)
      return -(int)err;
    const int per_sm = per_f32 < per_bf16 ? per_f32 : per_bf16;
    if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
    wide::coresident[dev] = per_sm * sms;
  }
  return wide::coresident[dev];
}

// Floats of the wide kernel's scratch tensor for T * H = items, Nq + Nk
// rows an item and m features: each item's partials (per (64-feature tile,
// q row, k row) S, per (tile, q row) Q and c_q, per (tile, k row) K), the
// key stabilisers c_k [items][tiles][k chunks], then the rows' diagonal
// terms [items][Nq + Nk].
extern "C" long long wmfml_favor_wide_scratch_floats(int items, int Nq, int Nk,
                                                    int m) {
  wide::Params p{};
  wide::layout(p, Nq, Nk, 8, m);
  return (long long)items * (p.per_item + p.tiles * p.kchunks + Nq + Nk);
}

// q [T,H,Nq,d], k [T,H,Nk,d], v [T,H,Nk,e] at element strides (t, h, n),
// each a multiple of 4, unit stride along the last axis and aligned to four
// elements; float32, or bfloat16 with bf16 set (then dn and dn2 the
// bfloat16-rounded normalizers); proj [m, d] contiguous; d and e multiples
// of 4 with d <= 256, e <= 256; mask [T, Nk] bytes at strides (t, n), or
// null; scratch of wmfml_favor_wide_scratch_floats floats, 16-byte
// aligned; out [T,H,Nq,e] float32 contiguous; stamps null, or
// [min(T * H * ceil(m / 64), co-resident blocks), 5] int64 for the phase
// clock; kmax as wmfml_favor_fwd takes it. One cooperative launch on
// `stream`. Returns its cudaError_t, or -1 when the shape does not fit the
// kernel.
extern "C" int wmfml_favor_wide_fwd(const void* q, const void* k,
                                    const void* v, const float* proj,
                                    const unsigned char* mask, float* scratch,
                                    float* out, long long* stamps,
                                    const float* kmax,
                                    long long qs_t, long long qs_h,
                                    long long qs_n, long long ks_t,
                                    long long ks_h, long long ks_n,
                                    long long vs_t, long long vs_h,
                                    long long vs_n, long long ms_t,
                                    long long ms_n, int T, int H, int Nq,
                                    int Nk, int d, int e, int m, int bf16,
                                    float dn, float dn2, float ratio,
                                    float eps, void* stream) {
  if (d < 1 || d > wide::DW || d % 4 || e < 4 || e > wide::EW || e % 4 ||
      Nq < 1 || Nk < 1 || m < 1)
    return -1;
  const int items = T * H;
  if (items == 0) return 0;
  const int blocks = wmfml_favor_wide_coresident();
  if (blocks < 0) return -blocks;
  wide::Params p{q,    k,    v,    proj, mask, scratch, nullptr, nullptr,
                 out,  stamps, qs_t, qs_h, qs_n, ks_t, ks_h, ks_n, vs_t,
                 vs_h, vs_n, ms_t, ms_n, items, H, Nq, Nk, d, e, m};
  wide::layout(p, Nq, Nk, d, m);
  p.ck = scratch + (size_t)items * p.per_item;
  p.diag = p.ck + (size_t)items * p.tiles * p.kchunks;
  const int grid = (long long)items * p.tiles < blocks ? items * p.tiles : blocks;
  // phase 2: q slices per item where they shorten the rounds of units over
  // the grid (a unit's time taken as one round of loads plus its share of
  // the item's work)
  int best = 1;
  double cost = 1e30;
  for (int s = 1; s <= (Nq < 8 ? Nq : 8); ++s) {
    const int qr = (Nq + s - 1) / s;
    const double rounds = ((long long)items * ((Nq + qr - 1) / qr) + grid - 1) / grid;
    const double c = rounds * (1.0 + 1.0 / s);
    if (c < cost) {
      cost = c;
      best = s;
    }
  }
  p.qr = (Nq + best - 1) / best;
  if (p.qr > wide::QB) p.qr = wide::QB;
  p.qslices = (Nq + p.qr - 1) / p.qr;
  const int room = wide::RED - wide::P2_T;
  for (p.tb = p.tiles; p.tb > 1 && wide::p2_floats(p.tb, p.qr, p.kcp) > room;)
    --p.tb;
  if (wide::p2_floats(p.tb, p.qr, p.kcp) > room) return -1;
  p.dn = dn;
  p.dn2 = dn2;
  p.ratio = ratio;
  p.eps = eps;
  p.kmax = kmax;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(wide::THREADS);
  cfg.dynamicSmemBytes = wide::SMEM_BYTES;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      bf16 ? cudaLaunchKernelEx(&cfg, wide::favor_kernel_wide<__nv_bfloat16>, p)
           : cudaLaunchKernelEx(&cfg, wide::favor_kernel_wide<float>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
