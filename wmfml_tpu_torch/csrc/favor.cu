// Masked FAVOR+ cross-attention core (Performer positive random features,
// non-causal linear attention).
//
// Replaces wmfml_tpu/nn/attention.py:softmax_kernel_features,
// linear_attention and favor_attention. Math kept exactly:
//   dash  = (d^-1/4 x) . P^T                       P: [m, d] projection
//   diag  = |x|^2 / 2 * d^-1/2
//   q'    = m^-1/2 (exp(dash_q - diag_q - max_row(dash_q)) + eps)
//   k'    = m^-1/2 (exp(dash_k - diag_k - max_all(dash_k)) + eps) * mask
//   out   = q' (k'^T v) / (q' . sum_n k')
// where max_all is ONE max over the whole key tensor [T, H, Nk, m], masked
// rows included. The key mask is applied after featurisation, so a task with
// no context rows divides 0 by 0 (NaN), which the model gates to 0.
//
// Bound: at the ANPShapeNet1D shapes (T=10, H=8, Nq=Nk=15, d=e=64, m=266)
// the whole call is ~0.2 GFLOP and ~1.3 MB, a few microseconds of the card
// either way; launch latency dominates.
//
// Design: the global key max cannot come from one block, so a first pass
// (favor_kmax_kernel, one block per (task, head)) writes each block's max of
// dash_k; the main kernel (favor_fwd_kernel, one block per (task, head))
// reduces those T*H values itself, so no atomics and no scratch to zero. The
// main kernel holds the projection (row stride d+1: conflict-free dot
// products), q, k, v and both feature maps in dynamic shared memory. With
// N << m it forms A = q' k'^T [Nq, Nk] and out = A v / rowsum(A), which is
// q' (k'^T v) / (q' . sum k') reassociated: 7x fewer FLOPs at N=15, m=266.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = (threadIdx.x < THREADS / 32) ? red[threadIdx.x] : -INFINITY;
  if (warp == 0) v = warp_max(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  return red[0];
}

// dot of a scaled data row (shared) with projection row j (shared, stride
// d+1). Both kernels use this one routine, so pass 1's max is bit-equal to
// one of the values the main kernel subtracts it from.
__device__ inline float proj_dot(const float* xs, const float* ps, int d) {
  float acc = 0.f;
  for (int l = 0; l < d; ++l) acc = fmaf(xs[l], ps[l], acc);
  return acc;
}

__global__ void __launch_bounds__(THREADS)
favor_kmax_kernel(const float* __restrict__ k, const float* __restrict__ proj,
                  float* __restrict__ block_maxima, int Nk, int d, int m,
                  float dn) {
  extern __shared__ float smem[];
  float* ps = smem;                    // [m][d+1]
  float* ks = ps + m * (d + 1);        // [Nk][d], scaled by dn
  float* red = ks + Nk * d;            // [32]
  const int bh = blockIdx.x;
  for (int i = threadIdx.x; i < m * d; i += THREADS)
    ps[(i / d) * (d + 1) + i % d] = proj[i];
  for (int i = threadIdx.x; i < Nk * d; i += THREADS)
    ks[i] = dn * k[(size_t)bh * Nk * d + i];
  __syncthreads();
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < Nk * m; i += THREADS)
    mx = fmaxf(mx, proj_dot(ks + (i / m) * d, ps + (i % m) * (d + 1), d));
  mx = block_max(mx, red);
  if (threadIdx.x == 0) block_maxima[bh] = mx;
}

__global__ void __launch_bounds__(THREADS)
favor_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ proj,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ block_maxima,
                 float* __restrict__ out, int n_blocks, int H, int Nq, int Nk,
                 int d, int e, int m, float dn, float ratio, float eps) {
  extern __shared__ float smem[];
  float* ps = smem;                    // [m][d+1]
  float* qs = ps + m * (d + 1);        // [Nq][d] scaled by dn
  float* ks = qs + Nq * d;             // [Nk][d] scaled by dn
  float* vs = ks + Nk * d;             // [Nk][e]
  float* qp = vs + Nk * e;             // [Nq][m]
  float* kp = qp + Nq * m;             // [Nk][m]
  float* A = kp + Nk * m;              // [Nq][Nk]
  float* diag = A + Nq * Nk;           // [Nq + Nk]
  float* rowmax = diag + Nq + Nk;      // [Nq]
  float* red = rowmax + Nq;            // [32]

  const int bh = blockIdx.x, t = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qo = (size_t)bh * Nq * d, ko = (size_t)bh * Nk * d;

  float g = -INFINITY;
  for (int i = tid; i < n_blocks; i += THREADS) g = fmaxf(g, block_maxima[i]);
  const float gmax = block_max(g, red);

  for (int i = tid; i < m * d; i += THREADS)
    ps[(i / d) * (d + 1) + i % d] = proj[i];
  for (int i = tid; i < Nq * d; i += THREADS) qs[i] = dn * q[qo + i];
  for (int i = tid; i < Nk * d; i += THREADS) ks[i] = dn * k[ko + i];
  for (int i = tid; i < Nk * e; i += THREADS) vs[i] = v[(size_t)bh * Nk * e + i];
  // diag from the unscaled rows, as the reference computes it
  for (int r = warp; r < Nq + Nk; r += THREADS / 32) {
    const float* row = r < Nq ? q + qo + (size_t)r * d : k + ko + (size_t)(r - Nq) * d;
    float s = 0.f;
    for (int l = lane; l < d; l += 32) s = fmaf(row[l], row[l], s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) diag[r] = s / 2.0f * (dn * dn);
  }
  __syncthreads();

  for (int i = tid; i < Nq * m; i += THREADS)
    qp[i] = proj_dot(qs + (i / m) * d, ps + (i % m) * (d + 1), d);
  for (int i = tid; i < Nk * m; i += THREADS)
    kp[i] = proj_dot(ks + (i / m) * d, ps + (i % m) * (d + 1), d);
  __syncthreads();

  for (int r = warp; r < Nq; r += THREADS / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < m; j += 32) mx = fmaxf(mx, qp[r * m + j]);
    mx = warp_max(mx);
    if (lane == 0) rowmax[r] = mx;
  }
  __syncthreads();

  for (int i = tid; i < Nq * m; i += THREADS) {
    const int r = i / m;
    qp[i] = ratio * (expf(qp[i] - diag[r] - rowmax[r]) + eps);
  }
  for (int i = tid; i < Nk * m; i += THREADS) {
    const int n = i / m;
    const float keep = mask[(size_t)t * Nk + n] ? 1.f : 0.f;
    kp[i] = ratio * (expf(kp[i] - diag[Nq + n] - gmax) + eps) * keep;
  }
  __syncthreads();

  for (int i = tid; i < Nq * Nk; i += THREADS) {
    const float* a = qp + (i / Nk) * m;
    const float* b = kp + (i % Nk) * m;
    float s = 0.f;
    for (int j = 0; j < m; ++j) s = fmaf(a[j], b[j], s);
    A[i] = s;
  }
  __syncthreads();

  for (int i = tid; i < Nq * e; i += THREADS) {
    const int r = i / e, c = i % e;
    float num = 0.f, den = 0.f;
    for (int n = 0; n < Nk; ++n) {
      const float a = A[r * Nk + n];
      num = fmaf(a, vs[n * e + c], num);
      den += a;
    }
    out[(size_t)bh * Nq * e + i] = num / den;
  }
}

}  // namespace

extern "C" int wmfml_favor_kmax_smem_bytes(int Nk, int d, int m) {
  return (m * (d + 1) + Nk * d + 32) * (int)sizeof(float);
}

extern "C" int wmfml_favor_fwd_smem_bytes(int Nq, int Nk, int d, int e, int m) {
  return (m * (d + 1) + Nq * d + Nk * d + Nk * e + Nq * m + Nk * m + Nq * Nk +
          Nq + Nk + Nq + 32) * (int)sizeof(float);
}

// q [BH, Nq, d]; k [BH, Nk, d]; v [BH, Nk, e]; proj [m, d]; mask [BH/H, Nk]
// uint8; block_maxima [BH] scratch; out [BH, Nq, e]. Two launches on
// `stream`; returns the first non-zero cudaError_t.
extern "C" int wmfml_favor_fwd(const float* q, const float* k, const float* v,
                               const float* proj, const unsigned char* mask,
                               float* block_maxima, float* out, int BH, int H,
                               int Nq, int Nk, int d, int e, int m, float dn,
                               float ratio, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int smem1 = wmfml_favor_kmax_smem_bytes(Nk, d, m);
  cudaError_t err = cudaFuncSetAttribute(
      favor_kmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  favor_kmax_kernel<<<BH, THREADS, smem1, s>>>(k, proj, block_maxima, Nk, d, m, dn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem2 = wmfml_favor_fwd_smem_bytes(Nq, Nk, d, e, m);
  err = cudaFuncSetAttribute(
      favor_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return (int)err;
  favor_fwd_kernel<<<BH, THREADS, smem2, s>>>(q, k, v, proj, mask, block_maxima,
                                             out, BH, H, Nq, Nk, d, e, m, dn,
                                             ratio, eps);
  return (int)cudaGetLastError();
}
