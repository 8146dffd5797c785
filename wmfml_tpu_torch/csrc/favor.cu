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
// contiguous; stamps null, or [T*H, 9] int64 for the phase clock. One
// cooperative launch on `stream`. Returns its cudaError_t, or -1 when the
// shape does not fit the kernel.
extern "C" int wmfml_favor_fwd(const void* q, const void* k, const void* v,
                               const float* proj, const unsigned char* mask,
                               float* scratch, float* out, long long* stamps,
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
                 dn,   dn2,  ratio, eps};
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
// The same computation for d <= 256, any m and any Nq, Nk, float32 or
// bfloat16 q, k, v: LargeCNP's full-width heads (d = e = 256, m = int(256
// ln 256) = 1419; ANPDistractor at Nq = 18, Nk = 15 in training and Nq = 36,
// Nk <= 25 in evaluation). The features of an item alone take (Nq + Nk) m
// floats, 347 KB at R = 61, so nothing here holds a whole item's features:
// dash goes to the scratch tensor, and the features stream through shared
// memory in chunks of FT columns.
//
// Bound: the dash products, 2 (Nq + Nk) m d a (task, head) item (3.84 GFLOP
// at T = 20, H = 8, Nq + Nk = 33: 0.023 ms in 3xTF32 at the tensor cores'
// rate), and the bytes, dash written and read back once (30 MB there).
//
// Design, one cooperative launch on a persistent grid (one block an SM):
//   * Phase 1, units of (feature tile of FT = 128, item), feature-tile major,
//     each block a contiguous run of units, so that a block restages the
//     projection tile [128 x d] only where its run crosses into the next
//     tile and the item's rows every unit. The rows go through in groups of
//     RMAX = 64 (one group at every shipped shape): dash of the tile =
//     (d^-1/4 rows) P_tile^T on the tensor cores in 3xTF32 (mma.sync
//     m16n8k8: small*big, big*small, big*big a k-step, as above), operands
//     split as they are read from shared memory, whose rows are padded to
//     d + 4 floats so that a fragment's 32 reads hit 32 banks. Eight warps:
//     four 16-row tiles of the group by two halves of the feature tile. The
//     tile goes to dash in global memory, with each row's max over its real
//     features (< m); the tile's key max (masked rows included) goes to
//     kmax[item][tile]; the unit of tile 0 also writes each row's diagonal
//     term |x|^2 / 2 d^-1/2.
//   * grid.sync().
//   * Phase 2, an item a block at a time: the global key max (every block
//     reduces all kmax: a max is exact in any order, so each block holds
//     the same bits). The item's q rows and k rows go in chunks of qc and
//     kc rows: all of them at once where Nq + Nk <= RMAX, else RMAX / 2
//     each:
//     for each pair of chunks, the query stabilisers (each q row's max over
//     its tiles), the v rows, the key mask; then per chunk of FT features,
//     dash read back and turned into q' or k' (0 past m) as it is stored,
//     and the block of A = q' k'^T accumulated over the feature chunks by
//     warp tiles of 2 q rows x 4 k rows (each entry of A added to by one
//     lane, chunk after chunk: the sum's order is fixed); then each q row's
//     sum of A and its numerators A v carried on from the previous k chunk
//     (the numerators in the output, the sums in shared memory), in the
//     order of the k rows, and divided at the last k chunk. A row's sums run
//     over the k rows in order whatever the chunks, so one chunk or several
//     give the same bits.
// Every global read is latency-bound, so each stage issues its loads in
// rounds (batched), all of a round in flight before the first store. No
// atomics: two calls give the same bits. The backward stays on the twin.
// An optional phase clock (stamps: start, phase 1 done, barrier passed,
// end, a row a block) shows where the call's time goes; on the H100 phase
// 1 takes most of it, its 3xTF32 products on mma.sync, whose TF32 rate is
// a fraction of wgmma's (PERF.md).
//
// bfloat16 q, k, v (favor_kernel_wide<__nv_bfloat16>), with the narrow
// kernel's rounding points: the rows are read four values (8 bytes) a load
// and widened exactly; dn x rounds to bfloat16 (dn rounded), so its small
// part is 0 and dash takes two TF32 products a k-step, not three; the
// diagonal term is bf16(bf16(sum of bf16(x^2)) / 2 dn^2); v is widened;
// everything after is float32, and so is the output.

namespace {
namespace wide {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DW = 256;        // the widest head: d <= 256
constexpr int EW = 256;        // the widest v row: e <= 256
constexpr int RMAX = 64;       // rows a group and a chunk pair: four 16-row
                               // mma tiles
constexpr int FT = 128;        // features a phase-1 unit and a phase-2 chunk
constexpr int LD = DW + 4;     // the staged rows' stride: conflict-free reads
constexpr int DLD = FT + 4;    // the dash tile's row stride
// Shared memory, phase 1: the projection tile [FT][LD] | the group's rows
// [RMAX][LD], whose room the dash tile [RMAX][DLD] takes after the
// products | the tile's row maxima [RMAX] | red [WARPS]. Phase 2: features
// [RMAX][FT] | v [RMAX][EW] | A [qc kc <= RMAX^2 / 4] | diag, stab, keep,
// the q rows' sums of A [RMAX each], below red.
constexpr int P1_X = FT * LD;
constexpr int P1_RMX = P1_X + RMAX * LD;
constexpr int RED = P1_RMX + RMAX;
constexpr int SMEM_BYTES = (RED + WARPS) * 4;
constexpr int P2_V = RMAX * FT;
constexpr int P2_A = P2_V + RMAX * EW;
constexpr int P2_DIAG = P2_A + RMAX * RMAX / 4;
constexpr int P2_STAB = P2_DIAG + RMAX;
constexpr int P2_KEEP = P2_STAB + RMAX;
constexpr int P2_DEN = P2_KEEP + RMAX;
static_assert(P2_DEN + RMAX <= RED, "phase 2 fits in phase 1's room");
static_assert(DLD * RMAX <= LD * RMAX, "the dash tile fits the rows' room");

struct Params {
  const void* q;                    // float or __nv_bfloat16, as the kernel's T
  const void* k;
  const void* v;
  const float* proj;
  const unsigned char* mask;        // [T, Nk] bytes 0/1, or null: all real
  float* dash;                      // scratch [items][R][MPW]
  float* rowmax;                    // scratch [items][mtiles][R]
  float* kmax;                      // scratch [items][mtiles]
  float* diag;                      // scratch [items][R]
  float* out;                       // [items][Nq][e]
  long long* stamps;                // [gridDim][STAMPS] or null
  long long qs_t, qs_h, qs_n, ks_t, ks_h, ks_n, vs_t, vs_h, vs_n, ms_t, ms_n;
  int items, H, Nq, Nk, d, e, m, mtiles, MPW;
  int qc, kc;                       // phase 2's chunks of q and k rows
  float dn, dn2, ratio, eps;
};

// phase clock points per block: start, phase 1 done, barrier passed, end
constexpr int STAMPS = 4;

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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
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

// Phase 1 unit: dash of feature tile ft for the item's rows, a group of
// RMAX at a time, into dash, rowmax, kmax (and diag at ft = 0).
template <class T>
__device__ void dash_unit(const Params& p, float* smem, int ft, int item,
                          bool stage_proj) {
  constexpr bool kBF = sizeof(T) == 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.Nq + p.Nk, t = item / p.H, h = item - t * p.H;
  float* Pt = smem;
  float* X = smem + P1_X;
  float* D = X;
  float* rmx = smem + P1_RMX;
  constexpr int D4 = DW / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();                  // the previous unit's reads are done
  if (stage_proj)
    batched<8, THREADS>(
        FT * D4,
        [&](int i) {
          const int r = i / D4, c = (i - r * D4) * 4, j = ft * FT + r;
          return j < p.m && c < p.d ? ldg4(p.proj + (size_t)j * p.d + c)
                                    : zero;
        },
        [&](int i, float4 x) { store4(Pt + i / D4 * LD + i % D4 * 4, x); });
  float km = -INFINITY;             // the tile's key max (thread 0's)
  for (int r0 = 0; r0 < R; r0 += RMAX) {
    const int rn = min(RMAX, R - r0);
    if (r0) __syncthreads();        // the previous group's reads are done
    // the group's rows of the active 16-row tiles, zero past R and past d
    batched<8, THREADS>(
        (rn + 15) / 16 * 16 * D4,
        [&](int i) {
          const int r = i / D4 + r0, c = (i - i / D4 * D4) * 4;
          if (r >= R || c >= p.d) return zero;
          return r < p.Nq
                     ? ld4(qkv<T>(p.q) + t * p.qs_t + h * p.qs_h +
                           r * p.qs_n + c)
                     : ld4(qkv<T>(p.k) + t * p.ks_t + h * p.ks_h +
                           (r - p.Nq) * p.ks_n + c);
        },
        [&](int i, float4 x) { store4(X + i / D4 * LD + i % D4 * 4, x); });
    __syncthreads();
    if (ft == 0)                    // the rows' diagonal terms, once an item
      for (int r = warp; r < rn; r += WARPS) {
        float s = 0.f;
        for (int c = lane; c < p.d; c += 32) {
          const float x = X[r * LD + c];
          if constexpr (kBF)
            s += tc::bf16r(x * x);
          else
            s = fmaf(x, x, s);
        }
        s = warp_sum(s);
        if (lane == 0)
          p.diag[(size_t)item * R + r0 + r] =
              kBF ? tc::bf16r(tc::bf16r(s) / 2.0f * p.dn2) : s / 2.0f * p.dn2;
      }

    // dash^T fragments: warp (mt, ng) computes rows 16 mt .. + 15 against
    // features 64 ng .. + 63 of the tile, eight m16n8 tiles
    const int mt = warp & 3, ng = warp >> 2, g = lane >> 2, tq = lane & 3;
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    const bool active = mt * 16 < rn;
    if (active) {
      const float* xa = X + (mt * 16 + g) * LD + tq;
      const float* pb = Pt + (ng * 64 + g) * LD + tq;
      const int ksteps = (p.d + 7) / 8;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int o = ks * 8;
        const float av[4] = {xa[o], xa[8 * LD + o], xa[o + 4],
                             xa[8 * LD + o + 4]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // bfloat16: dn x rounded as the reference rounds it, exact in TF32
          const float a = kBF ? tc::bf16r(p.dn * av[i]) : p.dn * av[i];
          tc::split(a, ab[i], as[i]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* b = pb + nt * 8 * LD + o;
          uint32_t bb0, bs0, bb1, bs1;
          tc::split(b[0], bb0, bs0);
          tc::split(b[4], bb1, bs1);
          if constexpr (!kBF) mma_tf32(acc[nt], as, bb0, bb1);
          mma_tf32(acc[nt], ab, bs0, bs1);
          mma_tf32(acc[nt], ab, bb0, bb1);
        }
      }
    }
    __syncthreads();                // X is read: the dash tile takes its room
    if (active)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = ng * 64 + nt * 8 + 2 * tq;
        float* rw = D + (mt * 16 + g) * DLD + col;
        rw[0] = acc[nt][0];
        rw[1] = acc[nt][1];
        rw[8 * DLD] = acc[nt][2];
        rw[8 * DLD + 1] = acc[nt][3];
      }
    __syncthreads();
    // the tile to dash, and each row's max over its real features
    float* dst = p.dash + ((size_t)item * R + r0) * p.MPW + ft * FT;
    for (int r = warp; r < rn; r += WARPS) {
      const float4 x = *reinterpret_cast<const float4*>(D + r * DLD + lane * 4);
      __stcg(reinterpret_cast<float4*>(dst + (size_t)r * p.MPW) + lane, x);
      const int j = ft * FT + lane * 4;
      float mx = -INFINITY;
      if (j < p.m) mx = x.x;
      if (j + 1 < p.m) mx = fmaxf(mx, x.y);
      if (j + 2 < p.m) mx = fmaxf(mx, x.z);
      if (j + 3 < p.m) mx = fmaxf(mx, x.w);
      mx = warp_max(mx);
      if (lane == 0) {
        p.rowmax[((size_t)item * p.mtiles + ft) * R + r0 + r] = mx;
        rmx[r] = mx;
      }
    }
    __syncthreads();
    if (tid == 0)                   // key rows, masked rows included
      for (int r = max(p.Nq - r0, 0); r < rn; ++r) km = fmaxf(km, rmx[r]);
  }
  if (tid == 0) p.kmax[(size_t)item * p.mtiles + ft] = km;
}

// Phase 2 for one item: per pair of q and k chunks, features chunk by
// chunk, the block of A, then the q rows' sums and numerators; out.
template <class T>
__device__ void attend(const Params& p, float* smem, int item, float gmax) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.Nq + p.Nk, t = item / p.H, h = item - t * p.H;
  float* F = smem;
  float4* F4 = reinterpret_cast<float4*>(F);
  float* V = smem + P2_V;
  float* A = smem + P2_A;
  float* diag = smem + P2_DIAG;
  float* stab = smem + P2_STAB;
  float* keep = smem + P2_KEEP;
  float* den = smem + P2_DEN;
  constexpr int C4 = FT / 4;
  const int e4 = p.e / 4;
  const float* src = p.dash + (size_t)item * R * p.MPW;
  float* ob = p.out + (size_t)item * p.Nq * p.e;
  for (int q0 = 0; q0 < p.Nq; q0 += p.qc) {
    const int nq = min(p.qc, p.Nq - q0);
    for (int k0 = 0; k0 < p.Nk; k0 += p.kc) {
      const int nk = min(p.kc, p.Nk - k0), rn = nq + nk;
      // the chunk's rows: q rows q0.. at 0.., k rows k0.. at nq..
      const auto row = [&](int r) { return r < nq ? q0 + r : p.Nq + k0 + r - nq; };
      __syncthreads();              // the previous chunk's reads are done
      batched<4, THREADS>(
          nk * e4,
          [&](int i) {
            return ld4(qkv<T>(p.v) + t * p.vs_t + h * p.vs_h +
                       (k0 + i / e4) * p.vs_n + i % e4 * 4);
          },
          [&](int i, float4 x) { store4(V + i * 4, x); });
      for (int r = tid; r < rn; r += THREADS) {
        diag[r] = __ldcg(p.diag + (size_t)item * R + row(r));
        if (r < nq) {
          float s = -INFINITY;
          for (int ft = 0; ft < p.mtiles; ++ft)
            s = fmaxf(s, __ldcg(p.rowmax + ((size_t)item * p.mtiles + ft) * R +
                                q0 + r));
          stab[r] = s;
          if (k0 == 0) den[r] = 0.f;
        } else {
          const int n = k0 + r - nq;
          keep[r - nq] =
              p.mask == nullptr || p.mask[t * p.ms_t + n * p.ms_n] ? 1.f : 0.f;
        }
      }
      for (int i = tid; i < nq * nk; i += THREADS) A[i] = 0.f;
      __syncthreads();

      const int tk = (nk + 3) / 4, ntiles = (nq + 1) / 2 * tk;
      for (int ft = 0; ft < p.mtiles; ++ft) {
        if (ft) __syncthreads();    // the previous chunk's reads of F are done
        batched<8, THREADS>(
            rn * C4,
            [&](int i) {
              return __ldcg(reinterpret_cast<const float4*>(
                                src + (size_t)row(i / C4) * p.MPW + ft * FT) +
                            i % C4);
            },
            [&](int i, float4 x) {
              const int r = i / C4;
              const bool isq = r < nq;
              F4[i] = features4(p, x, ft * FT + i % C4 * 4, diag[r],
                                isq ? stab[r] : gmax, isq ? 1.f : keep[r - nq]);
            });
        __syncthreads();
        // A += q' k'^T over the chunk: a warp per tile of 2 q rows x 4 k
        // rows, lane l the chunk's columns 4 l .. 4 l + 3
        for (int tile = warp; tile < ntiles; tile += WARPS) {
          const int i0 = tile / tk * 2, n0 = tile % tk * 4;
          float4 x[2], y[4];
#pragma unroll
          for (int a = 0; a < 2; ++a) x[a] = F4[min(i0 + a, nq - 1) * C4 + lane];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            y[b] = F4[(nq + min(n0 + b, nk - 1)) * C4 + lane];
          float acc[8];
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              float s = x[a].x * y[b].x;
              s = fmaf(x[a].y, y[b].y, s);
              s = fmaf(x[a].z, y[b].z, s);
              acc[a * 4 + b] = fmaf(x[a].w, y[b].w, s);
            }
          const float sum = warp_sum8(acc);
          const int i = i0 + (lane >> 4), n = n0 + ((lane >> 2) & 3);
          if ((lane & 3) == 0 && i < nq && n < nk) A[i * nk + n] += sum;
        }
      }
      __syncthreads();
      for (int i = tid; i < nq; i += THREADS) {   // the rows' sums of A
        float s = den[i];
        for (int n = 0; n < nk; ++n) s += A[i * nk + n];
        den[i] = s;
      }
      __syncthreads();

      // the numerators A v, carried in the output from the previous k chunk
      // (each by the thread that wrote it), divided at the last: four
      // outputs a thread, their sums interleaved
      const bool last = k0 + nk == p.Nk;
      const int no = nq * p.e;
      float* oc = ob + (size_t)q0 * p.e;
      for (int o0 = tid; o0 < no; o0 += 4 * THREADS) {
        float num[4];
        int ii[4], cc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int o = min(o0 + u * THREADS, no - 1);
          ii[u] = o / p.e;
          cc[u] = o % p.e;
          num[u] = k0 == 0 ? 0.f : oc[o];
        }
        for (int n = 0; n < nk; ++n) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            num[u] = fmaf(A[ii[u] * nk + n], V[n * p.e + cc[u]], num[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (o0 + u * THREADS < no)
            oc[o0 + u * THREADS] = last ? num[u] / den[ii[u]] : num[u];
      }
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1) favor_kernel_wide(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int units = p.mtiles * p.items;
  const int u0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  stamp(p, 0);
  for (int u = u0; u < u1; ++u) {
    const int ft = u / p.items;
    dash_unit<T>(p, smem, ft, u - ft * p.items, u == u0 || u % p.items == 0);
  }
  stamp(p, 1);
  cg::this_grid().sync();
  stamp(p, 2);
  float g = -INFINITY;
  for (int i = threadIdx.x; i < units; i += THREADS) g = fmaxf(g, __ldcg(p.kmax + i));
  const float gmax = block_max(g, smem + RED);
  for (int item = blockIdx.x; item < p.items; item += gridDim.x)
    attend<T>(p, smem, item, gmax);
  if (p.stamps != nullptr) {
    __syncthreads();
    stamp(p, 3);
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

// Floats of the wide kernel's scratch tensor for T * H = items, R = Nq + Nk
// rows an item: dash [items][R][MPW], then the row maxima [items][mtiles][R],
// the key maxima [items][mtiles] and the diagonal terms [items][R], with
// mtiles = ceil(m / 128) and MPW = 128 mtiles.
extern "C" long long wmfml_favor_wide_scratch_floats(int items, int Nq, int Nk,
                                                    int m) {
  const long long mt = (m + wide::FT - 1) / wide::FT, R = Nq + Nk;
  return (long long)items * (R * mt * wide::FT + mt * R + mt + R);
}

// q [T,H,Nq,d], k [T,H,Nk,d], v [T,H,Nk,e] at element strides (t, h, n),
// each a multiple of 4, unit stride along the last axis and aligned to four
// elements; float32, or bfloat16 with bf16 set (then dn and dn2 the
// bfloat16-rounded normalizers); proj [m, d] contiguous and 16-byte
// aligned; d and e multiples of 4 with d <= 256, e <= 256; mask [T, Nk]
// bytes at strides (t, n), or null; scratch of
// wmfml_favor_wide_scratch_floats floats, 16-byte aligned; out [T,H,Nq,e]
// float32 contiguous; stamps null, or [min(T * H * ceil(m / 128),
// co-resident blocks), 4] int64 for the phase clock. One cooperative
// launch on `stream`. Returns its cudaError_t, or -1 when the shape does
// not fit the kernel.
extern "C" int wmfml_favor_wide_fwd(const void* q, const void* k,
                                    const void* v, const float* proj,
                                    const unsigned char* mask, float* scratch,
                                    float* out, long long* stamps,
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
  const int mtiles = (m + wide::FT - 1) / wide::FT, MPW = mtiles * wide::FT;
  // phase 2's chunks: every row at once where they fit, else half each
  const bool whole = Nq + Nk <= wide::RMAX;
  const int qc = whole ? Nq : wide::RMAX / 2;
  const int kc = whole ? Nk : wide::RMAX / 2;
  const size_t nd = (size_t)items * (Nq + Nk) * MPW;
  float* rowmax = scratch + nd;
  float* kmax = rowmax + (size_t)items * mtiles * (Nq + Nk);
  float* diag = kmax + (size_t)items * mtiles;
  const wide::Params p{q,     k,    v,    proj,   mask, scratch, rowmax,
                       kmax,  diag, out,  stamps, qs_t, qs_h,    qs_n,
                       ks_t,  ks_h, ks_n, vs_t,   vs_h, vs_n,    ms_t,
                       ms_n,  items, H,   Nq,     Nk,   d,       e,
                       m,     mtiles, MPW, qc,    kc,   dn,      dn2,
                       ratio, eps};
  const int units = mtiles * items;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(units < blocks ? units : blocks);
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
