// K6: image data augmentation of one augmenter call in one launch. For
// [B, H, W, 1] uint8 images (the sampler's context or query slice, read
// through its task and image strides) and the call's raw draws (19 or 23
// uniforms and two key words per image, one op order for the call), it
// computes x / 255, then one op program on each image, and writes
// [B, H, W, 1] float32, or bfloat16 for compute_dtype: bfloat16. The
// programs (Program below; aug/image_aug.py:PROGRAMS):
//   0 ShapeNet1D: CropAndPad, Affine and OneOf(Dropout, CoarseDropout),
//     each under Sometimes(0.5), in one of the 3! orders, adjacent warps
//     composed into one chain (the section "Design" below);
//   1 Pascal1D: CropAndPad, GammaContrast, AverageBlur, Affine and the
//     dropout op in one of the 5! orders, each op applied alone and
//     rounded to the image's type at its end (the JAX package's per-step
//     switch chain: with 5 ops it composes no warps);
//   2 ShapeNet1D fixed order: geometric (CropAndPad and Affine as one warp
//     with composed parameters), then OneOf(Dropout, fixed-grid
//     CoarseDropout);
//   3 Pascal1D fixed order: geometric, GammaContrast, AverageBlur, then the
//     fixed-grid dropout op;
//   4 Distractor: Affine and OneOf(Dropout, CoarseDropout), each under
//     Sometimes(0.5), in one of the 2! orders, on the inverted image
//     1 - x / 255 (one warp op: the JAX package's enumerated path applies
//     Affine alone, _affine_warp, as program 1 does);
//   5 Distractor fixed order: Affine, then the fixed-grid dropout op, on
//     the inverted image;
//   6 ShapeNet3D: CropAndPad, GammaContrast, AddToBrightness, AverageBlur,
//     Affine and the dropout op, each under Sometimes(0.5), in one of the 6!
//     orders, on float RGB (the RGBA batch's first three channels), each op
//     applied alone (the JAX package's per-step switch chain);
//   7 ShapeNet3D fixed order: geometric, GammaContrast, AddToBrightness,
//     AverageBlur, then the fixed-grid dropout op, on float RGB.
//
// Replaces wmfml_tpu/aug/pipeline.py:_to_float (:34) and image_aug.py's
// _warp_chain (:120), _affine_warp (:97), gamma_contrast and average_blur
// (:211-257), _fmix32 .. one_of_dropout_fixed (:277-383), geometric
// (:386-417), the enumerated-order augment (:537-565), which draws the
// order as device data (:556) and switches to one fused branch per order
// (:562), the per-step switch chain (:567-577) and the fixed-order chain
// (:578-580), and pipeline.py's inversion 1.0 - _to_float(x) (:105) for
// programs 4 and 5, and image_aug.py's brightness (:219-240) and the
// float input's cast for programs 6 and 7. Here the order is device data in
// every program: every call
// is the same single launch, whatever the order, and the per-image
// parameters are computed in the kernel from the raw draws.
//
// Bound: the bytes (each image read once as uint8 and written once as
// float32, 5 B a pixel: 12.3 MB for 150 images of 128 x 128, 3.7 us at
// 3.35 TB/s) and Dropout's hash on every pixel (26 integer operations, 3.8
// us at 64 INT32 lanes per SM); the taps are a few tens of float
// operations a pixel.
//
// Design of programs 0, 2, 4 and 5: one block of 256 threads per image.
//   * Thread 0 starts a bulk copy (TMA without a tensor map) of the image's
//     H W bytes into shared memory and, while it runs, computes the image's
//     parameters from its uniforms with the formulas of
//     aug/image_aug.py:params_from_draw, one IEEE operation at a time (the
//     _rn intrinsics, no FMA): nearest snapping moves a whole pixel on one
//     ulp of the scale or the shift.
//   * The threads build the tap tables once per image: for the warp ops
//     before the dropout op (chain A) and after it (chain B), one entry per
//     output row and column (csrc/warp.cuh); for CoarseDropout, the cell of
//     every row and column and the keep bit of every cell, so its mask costs
//     a table read a pixel. The grid is round(H sp) x round(W sp), and the
//     size fraction's draw, 0.02 + 0.23 u for u in [0, 1), stays below
//     0.25, so the grid never holds more than (H/4 + 1) (W/4 + 1)
//     cells (1,089 hashes at 128 x 128), the table's room. Dropout hashes
//     each pixel once, where the order applies it.
//   * Then, by the order's shape (ORDERS below), with f a float32 image in
//     shared memory:
//       A then mask:  f = x / 255; out = keep * chainA(f)
//       mask then B:  f = keep * x / 255; out = chainB(f)
//       A, mask, B:   f = keep * chainA(x / 255); out = chainB(f)
//     x / 255 comes from a table of the 256 quotients (true divisions,
//     __fdiv_rn, as the twin divides): with every warp gate off the output
//     is x / 255 exactly, and elsewhere the taps' float32 sums differ from
//     the twin's only in their order. A warp walks rows and lane l owns
//     columns l + 32 k (their table entries in registers): the 32 lanes of
//     a tap read neighbouring words of f, so a tap is one shared-memory
//     wavefront, and each warp store writes 128 contiguous bytes. The
//     number of taps is a template constant (1, 2 or 4 per axis, from the
//     stages' gates and nearest flags), so the loops unroll and no integer
//     division is left in them.
//     Four adjacent columns a lane would allow float4 stores, but then
//     the lanes of a float32 tap read every fourth word (a 4-way bank
//     conflict on every tap), and taps through the quotient table conflict
//     at random; a division a pixel after the taps costs more than the
//     table.
// bfloat16 output: the JAX package rounds an image to its dtype where an op
// returns img.dtype: x / 255 (pipeline.py:34, the float32 quotient rounded)
// and the end of each run of adjacent warps (_warp_chain, :151); its masks
// multiply by 0 or 1, exactly. The kernel keeps f in float32 and rounds at
// those points: the quotient table holds the rounded quotients, chain A
// rounds as it writes f, and the output store rounds. Where a mask follows a
// chain, rounding then masking equals masking then rounding.
// Shared memory: the image (H W bytes), f (4 H W), the tables; 105.7 KB at
// 128 x 128, so two blocks fit an SM and 150 images run in one wave on 132
// SMs (18 of them hold two). No atomics, nothing allocated: two calls give
// the same bits.
//
// Program 2 (run_pixel_program): geometric's one warp from f = x / 255 into
// the output, the fixed-grid mask applied as it writes. The fixed programs'
// CoarseDropout keeps one hashed bit per cell of the fixed grid
// (pixel_ops.cuh).
//
// Programs 4 and 5 (Distractor) need no g: x / 255 comes from the table of
// inverted quotients 1 - i / 255 (the correctly rounded quotient, then the
// subtraction, as the twin and the JAX package compute it; the warp's fill
// applies to the inverted image), then Affine alone from f into the output
// with the mask applied as it writes (Affine first), or the mask in place on
// f and Affine from f into the output (the mask first); Affine's gate off,
// the masked copy. In bfloat16 the JAX package computes 1.0 -
// x.astype(bf16) / 255.0: the quotient rounds to bfloat16, then the
// difference rounds again, so the table holds bf16(1 - bf16(i / 255)), and
// Affine's output rounds as it is stored (the mask multiplies by 0 or 1:
// rounding then masking is masking then rounding). Bound in bfloat16: 1 B
// read and 2 B written a pixel.
//
// Programs 6 and 7 (ShapeNet3D) read RGBA and write RGB, [B, H, W, 3], both
// float32 or both bfloat16 (compute_dtype: bfloat16, whose sampler keeps
// the split in bfloat16). Bound: the bytes, 16 read and 12 written a pixel
// in float32 (34.4 MB for 300 images of 64 x 64, 10.3 us at 3.35 TB/s), 8
// and 6 in bfloat16 (5.1 us). Brightness needs a pixel's three channels:
// V = max(R, G, B), then every channel scaled by clip(V + b, 0, 1) / V in
// float32, or, where V <= 1e-6, the gray clip(max(b, 0), 0, 1), as the twin
// computes it. With three channels the masks are per channel where the
// draw says so: Dropout hashes y W + x, times 3 plus the channel;
// CoarseDropout keeps a bit for each (cell, channel), the cell's id times 3
// plus the channel; the fixed grid one bit a cell for all three.
//
// Programs 1, 3, 6 and 7: the pass engine (engine below). The JAX package
// applies each op alone, rounded to the image's type at its end, in the
// drawn order (the per-step switch chain); on the card the time goes to
// the ops' arithmetic (GammaContrast's powf, AverageBlur's window) and to
// one shared-memory pass and barrier an op. The engine:
//   * one block an image: 1024 threads (Pascal1D in float32: two float32
//     images and the uint8 one, 171 KB, one block an SM, so 150 images take
//     two waves) or 512 (Pascal1D in bfloat16 and ShapeNet3D in float32,
//     two blocks an SM; ShapeNet3D in bfloat16, three, so 300 images take
//     one wave), the registers capped by the launch bounds to fit them
//     (engine_threads, engine_blocks; kernels/image_da.py:launch_geometry
//     mirrors them); one kernel a family (Pascal1D's programs, ShapeNet3D's)
//     and output type, the fixed order chosen at run time, each pass
//     instantiated once for any destination (shared-memory planes or the
//     output): few instances keep nvcc's build short;
//   * warp 0 reads the uniforms and keys (a lane each), lane 0 issues the
//     image's bulk copy (uint8, or the RGBA rows into the tail of f and g)
//     and the warp draws the parameters while it runs; warp 1 reads and
//     decodes the order meanwhile;
//   * a plan of passes from the order and the gates (make_plan; host
//     mirror kernels/image_da.py:engine_passes): each moving op that is on
//     (CropAndPad or geometric, AverageBlur, Affine) is a pass, and each
//     pointwise op that is on (GammaContrast, AddToBrightness, the dropout
//     op) rides in registers with the pass before it: the load, or the
//     moving op's store. Each op is applied in the drawn order with its own
//     rounding, so each element sees the ops the twin's chain applies, in
//     its order, and at most three passes run, whatever the order: one
//     launch;
//   * the tap tables of both warps, the mask's tables and the quotient
//     table are built together behind one barrier, before the load;
//   * the load: x / 255 through the quotient table (Pascal1D), or the
//     staged RGBA read a chunk of rows at a time (each chunk read, a
//     barrier, then written into f's planes, whose last one the staging
//     shares), through the load's pointwise ops; the moving passes then go
//     f -> g -> f, the last into the output;
//   * a warp walks rows and lane l owns columns l + 32 k: a warp pass keeps
//     its column taps in registers, serves every channel from one row entry
//     and sums rows first, then columns, as the twin's einsum contracts, so
//     its float32 sums are the card twin's bit for bit (the per-op chain
//     it replaced summed columns first: one float32 ulp apart on about a
//     third of the elements, and a bfloat16 rounding the other way now and
//     then); a blur pass issues its window's K K loads (K a template
//     constant) before summing them in the JAX order;
//   * in bfloat16 f and g hold bfloat16 (each value is one an op rounded),
//     which halves them.
// Against the per-op chain it replaced (same shapes, every gate on, PERF.md
// section 6) the passes fall from up to six to at most three and the blur
// from about 20 to about 4 us a block; GammaContrast's powf (about a third
// of a block's life) is what remains.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hash_mask.cuh"
#include "pixel_ops.cuh"
#include "tf32_gmma.cuh"
#include "warp.cuh"

namespace {

using da::Axis;
using da::ND;
using da::NP;

using da::NX;

constexpr int THREADS = 256;
constexpr int COLS = 4;                // columns a lane owns: W <= 128
constexpr int NU = 19;                 // uniforms per image (ShapeNet1D)
constexpr int NU_PIXEL = NU + NX;      // with the pixel ops' four (Pascal1D)
constexpr int NB = 2;                  // brightness: gate, offset
constexpr int NU_RGB = NU_PIXEL + NB;  // and brightness's (ShapeNet3D)
constexpr int NPARAMS = 2 * NP + ND;   // the debug output's row
constexpr int NPARAMS_PIXEL = NPARAMS + NX;
constexpr int NPARAMS_RGB = NPARAMS_PIXEL + NB;
constexpr int RGB_C = 3;               // channels of programs 6 and 7
constexpr int STAMPS = 11;             // the phase clock's points
constexpr int DROP = 2;
constexpr int MAX_SMEM = 232448;       // shared memory a block may use

enum Program { SHAPENET1D = 0, PASCAL = 1, SHAPENET1D_FIXED = 2,
               PASCAL_FIXED = 3, DISTRACTOR = 4, DISTRACTOR_FIXED = 5,
               SHAPENET3D = 6, SHAPENET3D_FIXED = 7, NPROGRAMS = 8 };

// Pascal1D's ops, aug/image_aug.py:PASCAL_OPS (image_aug.py:442's order)
enum PascalOp { P_CROP = 0, P_GAMMA = 1, P_BLUR = 2, P_AFFINE = 3,
                P_DROP = 4, NPASCAL = 5 };
// ShapeNet3D's ops, aug/image_aug.py:SHAPENET3D_OPS (FULL_OPS, :441)
enum RgbOp { S_CROP = 0, S_GAMMA = 1, S_BRIGHT = 2, S_BLUR = 3,
             S_AFFINE = 4, S_DROP = 5, NRGB = 6 };

// ShapeNet3D's programs: float RGB read from RGBA
__host__ __device__ constexpr bool rgb(int prog) {
  return prog == SHAPENET3D || prog == SHAPENET3D_FIXED;
}
__host__ __device__ constexpr bool pixel_ops(int prog) {
  return prog == PASCAL || prog == PASCAL_FIXED || rgb(prog);
}
__host__ __device__ constexpr bool fixed_order(int prog) {
  return prog == SHAPENET1D_FIXED || prog == PASCAL_FIXED ||
         prog == DISTRACTOR_FIXED || prog == SHAPENET3D_FIXED;
}
// the programs whose first op is geometric (draw_geometric's one warp)
__host__ __device__ constexpr bool geometric(int prog) {
  return prog == SHAPENET1D_FIXED || prog == PASCAL_FIXED ||
         prog == SHAPENET3D_FIXED;
}
__host__ __device__ constexpr int program_nu(int prog) {
  return rgb(prog) ? NU_RGB : pixel_ops(prog) ? NU_PIXEL : NU;
}
__host__ __device__ constexpr int program_nparams(int prog) {
  return prog == SHAPENET1D ? NPARAMS
                            : rgb(prog) ? NPARAMS_RGB : NPARAMS_PIXEL;
}
// Distractor's programs: the inverted image
__host__ __device__ constexpr bool inverted(int prog) {
  return prog == DISTRACTOR || prog == DISTRACTOR_FIXED;
}

// The six op orders, aug/image_aug.py:ORDERS (0 CropAndPad, 1 Affine, 2 the
// dropout op), in itertools.permutations order.
__constant__ int ORDERS[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                                 {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};

struct Mask {
  bool on, pick;
  bool per_channel;          // RGB: Dropout and CoarseDropout per channel
  bool fixed;                // the fixed grid: one bit a cell
  float p;
  uint32_t k0, k1;
  int W, wl;
  const int* frow;
  const int* fcol;
  const uint8_t* cell;
};

// the engine's pointwise ops' parameters
struct Pointwise {
  float gamma, bright;
  Mask mask;
};

constexpr int MAX_MOVES = 3;           // moving ops of an engine program

// The engine programs' passes (make_plan): the moving ops that are on, in
// order, and the pointwise ops after the load (pw[0]) and after each moving
// op (pw[m + 1]), 4 bits an op (EngineOp + 1), the first in the low bits.
struct Plan {
  int moves;
  int move[MAX_MOVES];
  uint32_t pw[MAX_MOVES + 1];
};

struct Shared {
  float warp[2][NP];
  float drop[ND];
  float pixel[NX + NB];
  uint32_t k0, k1;
  int order;
  int perm[NRGB];
  Plan plan;
  float u[NU_RGB];             // the engine's copy of the image's uniforms
  Pointwise pw;                // and of its pointwise ops' parameters
};

struct Layout {
  int f, tab, lut, frow, fcol, cell, cap, par, bar, total;
};

// The dynamic shared memory of a block of programs 0, 2, 4 and 5: the
// uint8 image, f, the tap tables (two chains for program 0, one warp for
// the others), the quotient table, the coarse grid's rows, columns and
// cells, the parameters and the barrier. (The engine's: engine_layout.)
__host__ __device__ inline Layout layout(int H, int W) {
  Layout L;
  const int HW = H * W;
  L.f = (HW + 15) & ~15;                      // the uint8 image at 0
  L.tab = L.f + 4 * HW;
  L.lut = L.tab + 2 * (H + W) * (int)sizeof(Axis);
  L.frow = L.lut + 4 * 256;
  L.fcol = L.frow + 4 * H;
  L.cell = L.fcol + 4 * W;
  L.cap = (H / 4 + 1) * (W / 4 + 1);          // CoarseDropout's largest grid
  L.par = (L.cell + L.cap + 15) & ~15;
  L.bar = L.par + (((int)sizeof(Shared) + 15) & ~15);
  L.total = L.bar + 16;
  return L;
}

struct Args {
  const void* x;             // uint8 images, or float32 or bfloat16 RGBA
                             // (programs 6, 7: the output's type)
  long long st, ss;          // bytes between tasks and between images
  int S;                     // images per task
  const float* u;            // [B, program_nu]: 19 (programs 0, 2, 4,
                             // 5), 23 (1, 3) or 25 (6, 7)
  const int* keys;           // [B, 2]
  const long long* order;    // [1]; null for the fixed programs
  void* out;                 // [B, H, W] float32, or bfloat16 when bf16
                             // ([B, H, W, 3]: programs 6, 7)
  float* params_out;         // [B, program_nparams] or null
  long long* stamps;         // [B, STAMPS] or null
  int H, W;
  int bf16;                  // the output type: 0 float32, 1 bfloat16
  int program;               // Program
};

// The phase clock: thread 0 reads the global timer into points j .. end - 1
// (one read: a program's points after its last pass read the end).
__device__ inline void stamp(const Args& a, int j, int end = -1) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    for (int k = j; k < (end < 0 ? j + 1 : end); ++k)
      a.stamps[blockIdx.x * STAMPS + k] = t;
  }
}

// The 13 scaled uniforms v = u span + lo (aug/image_aug.py:_columns).
__device__ void columns(const float* u, int H, int W, float* v) {
  const float lo[13] = {0.f, 0.f, 0.f, 0.f, 0.f, (float)0.8, (float)0.8,
                        (float)(-0.1 * W), (float)(-0.1 * H), 0.f,
                        (float)0.01, 0.f, (float)0.02};
  const float span[13] = {(float)0.05, (float)0.05, (float)0.05,
                          (float)0.05, 1.f, (float)0.4, (float)0.4,
                          (float)(0.2 * W), (float)(0.2 * H), 1.f,
                          (float)0.09, (float)0.05, (float)0.23};
#pragma unroll
  for (int i = 0; i < 13; ++i) v[i] = __fadd_rn(__fmul_rn(u[i], span[i]), lo[i]);
}

// aug/image_aug.py:params_from_draw for one image, operation for operation.
__device__ void draw_params(const float* u, int H, int W, Shared* P) {
  float v[13];
  columns(u, H, W, v);
  // CropAndPad: per axis scale 1 / (1 + both pads), shifted toward the
  // more padded side
  const float sx = __frcp_rn(__fadd_rn(__fadd_rn(1.f, v[0]), v[2]));
  const float sy = __frcp_rn(__fadd_rn(__fadd_rn(1.f, v[1]), v[3]));
  const float w0[NP] = {
      sx, sy, __fmul_rn(__fmul_rn(sx, __fsub_rn(v[0], v[2])), 0.5f * W),
      __fmul_rn(__fmul_rn(sy, __fsub_rn(v[1], v[3])), 0.5f * H), v[4], 0.f,
      u[13] < 0.5f ? 1.f : 0.f};
  const float w1[NP] = {v[5], v[6], v[7], v[8], v[9],
                        u[15] < 0.5f ? 1.f : 0.f, u[14] < 0.5f ? 1.f : 0.f};
  const bool pick = u[17] < 0.5f;
  const float d[ND] = {u[16] < 0.5f ? 1.f : 0.f, pick ? 1.f : 0.f,
                       pick ? v[10] : v[11], v[12],
                       u[18] < (pick ? 0.5f : (float)0.2) ? 1.f : 0.f};
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    P->warp[0][i] = w0[i];
    P->warp[1][i] = w1[i];
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) P->drop[i] = d[i];
}

// aug/image_aug.py:geometric_from_draw: the fixed programs' one warp in
// row 0 (row 1 zero): CropAndPad's symmetric pad p = v0 gives s1 = 1 / (1
// + 2 p) where its gate (u13) is on, Affine's scale and shift where its
// gate (u14) is on, composed as scale s1 s_affine and shift t_affine; cval
// v9; bilinear, applied whatever the gates (off, it is the identity).
__device__ void draw_geometric(const float* u, int H, int W, Shared* P) {
  float v[13];
  columns(u, H, W, v);
  const float s1 = u[13] < 0.5f
                       ? __frcp_rn(__fadd_rn(1.f, __fmul_rn(2.f, v[0])))
                       : 1.f;
  const bool g2 = u[14] < 0.5f;
  const float w0[NP] = {__fmul_rn(s1, g2 ? v[5] : 1.f),
                        __fmul_rn(s1, g2 ? v[6] : 1.f), g2 ? v[7] : 0.f,
                        g2 ? v[8] : 0.f, v[9], 0.f, 1.f};
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    P->warp[0][i] = w0[i];
    P->warp[1][i] = 0.f;
  }
}

// aug/image_aug.py:pixel_from_draw: GammaContrast's gate (u19) and gamma ~
// U[.5, 2) (u20), AverageBlur's gate (u21) and k ~ U{1, 2, 3} (u22).
__device__ void draw_pixel(const float* u, Shared* P) {
  P->pixel[0] = u[19] < 0.5f ? 1.f : 0.f;
  P->pixel[1] = __fadd_rn(__fmul_rn(u[20], 1.5f), 0.5f);
  P->pixel[2] = u[21] < 0.5f ? 1.f : 0.f;
  P->pixel[3] = fminf(fmaxf(floorf(__fmul_rn(u[22], 3.f)), 0.f), 2.f) + 1.f;
}

// aug/image_aug.py:bright_from_draw: AddToBrightness's gate (u23) and offset
// ~ U[-30/255, 30/255) (u24).
__device__ void draw_bright(const float* u, Shared* P) {
  P->pixel[NX] = u[23] < 0.5f ? 1.f : 0.f;
  P->pixel[NX + 1] = __fadd_rn(__fmul_rn(u[24], (float)(60.0 / 255.0)),
                               (float)(-30.0 / 255.0));
}

// the id CoarseDropout hashes for cell (fy, fx): fy W + fx in float32
__device__ __forceinline__ uint32_t cell_id(int fy, int fx, int W) {
  return (uint32_t)__fadd_rn(__fmul_rn((float)fy, (float)W), (float)fx);
}

__device__ __forceinline__ bool keep(const Mask& m, int y, int x) {
  if (!m.on) return true;
  if (m.pick) return da::hash_keep(m.k0, m.k1, (uint32_t)(y * m.W + x), m.p);
  return m.cell[m.frow[y] * m.wl + m.fcol[x]] != 0;
}

// channel c of an RGB pixel (image_aug.py's dropout ids y W + x, times 3
// plus the channel when per channel; coarse cells likewise)
__device__ __forceinline__ bool keep_rgb(const Mask& m, int y, int x, int c) {
  if (!m.on) return true;
  const uint32_t yx = (uint32_t)(y * m.W + x);
  if (m.pick)
    return da::hash_keep(m.k0, m.k1, m.per_channel ? yx * RGB_C + c : yx,
                         m.p);
  const int e = m.frow[y] * m.wl + m.fcol[x];
  return m.cell[m.per_channel && !m.fixed ? e * RGB_C + c : e] != 0;
}

// a tap of the uint8 image reads x / 255 from a table of the 256 quotients
struct SrcU8 {
  const uint8_t* s;
  const float* lut;
  __device__ __forceinline__ float operator()(int i) const {
    return lut[s[i]];
  }
};

struct SrcF32 {
  const float* f;
  __device__ __forceinline__ float operator()(int i) const { return f[i]; }
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Where a pass writes its pixels: float32 as it is, float32 rounded to
// bfloat16 (chain A into f, bfloat16 output), or bfloat16
struct OutF32 {
  float* p;
  __device__ __forceinline__ void operator()(int i, float v) const { p[i] = v; }
};
struct OutRounded {
  float* p;
  __device__ __forceinline__ void operator()(int i, float v) const {
    p[i] = bf16_round(v);
  }
};
struct OutBF16 {
  __nv_bfloat16* p;
  __device__ __forceinline__ void operator()(int i, float v) const {
    p[i] = __float2bfloat16_rn(v);
  }
};

struct Chain {
  const Axis* tab;           // [H] rows, then [W] columns
  float c0, c1;
  int form;                  // da::Fill
};

// dst[y, x] = (mask ? keep : 1) * (taps of src + fill) over the image. A
// warp walks rows; lane l owns columns l, l + 32, l + 64, l + 96, so the
// lanes of one tap read neighbouring words (no bank conflict) and each
// store of a warp writes 128 contiguous bytes.
template <int NT, class Src, class Dst>
__device__ void run_chain(const Chain& ch, int H, int W, Src src, Dst dst,
                          const Mask& mask, bool apply_mask) {
  const int lane = threadIdx.x & 31;
  const Axis* rows = ch.tab;
  const Axis* cols = ch.tab + H;
  int ci[COLS][NT];
  float cw[COLS][NT], cr[COLS], cp[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const Axis& e = cols[min(lane + 32 * k, W - 1)];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      ci[k][q] = e.idx[q];
      cw[k][q] = e.w[q];
    }
    cr[k] = e.r;
    cp[k] = e.p;
  }
  for (int y = threadIdx.x >> 5; y < H; y += THREADS / 32) {
    const Axis& ay = rows[y];
    float acc[COLS] = {};
#pragma unroll
    for (int a = 0; a < NT; ++a) {
      const int base = ay.idx[a] * W;
      const float wa = ay.w[a];
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < NT; ++q) s = fmaf(cw[k][q], src(base + ci[k][q]), s);
        acc[k] = fmaf(wa, s, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int x = lane + 32 * k;
      if (x >= W) break;
      float v = __fadd_rn(acc[k], da::chain_fill(ay.r, ay.p, cr[k], cp[k],
                                                 ch.c0, ch.c1, ch.form));
      if (apply_mask) v = __fmul_rn(v, keep(mask, y, x) ? 1.f : 0.f);
      dst(y * W + x, v);
    }
  }
}

template <class Src, class Dst>
__device__ void run_any(int nt, const Chain& ch, int H, int W, Src src,
                        Dst dst, const Mask& mask, bool apply_mask) {
  if (nt == 1)
    run_chain<1>(ch, H, W, src, dst, mask, apply_mask);
  else if (nt == 2)
    run_chain<2>(ch, H, W, src, dst, mask, apply_mask);
  else
    run_chain<4>(ch, H, W, src, dst, mask, apply_mask);
}

// f = x / 255 (through the table), 0 where the mask drops a pixel when
// apply_mask (x / 255 * 0 = 0, so f equals the twin's masked image bit for
// bit). A warp converts a row, 4 pixels a lane.
__device__ void to_float(const uint8_t* img, const float* lut, float* f,
                         int H, int W, const Mask& mask, bool apply_mask) {
  const int x0 = (threadIdx.x & 31) * 4;
  if (x0 >= W) return;
  for (int y = threadIdx.x >> 5; y < H; y += THREADS / 32) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(img + y * W + x0);
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      o[c] = lut[(v >> (8 * c)) & 0xFFu];
      if (apply_mask && !keep(mask, y, x0 + c)) o[c] = 0.f;
    }
    *reinterpret_cast<float4*>(f + y * W + x0) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

__device__ inline int chain_taps(const float* s0, const float* s1) {
  return da::stage_taps(s0) * (s1 ? da::stage_taps(s1) : 1);
}

// The order's shape over f (the header's three cases); Mid writes chain A
// into f, Out the output
template <class Out, class Mid>
__device__ void run_order(const Args& a, const int (&n)[2],
                          const int (&nt)[2], const Chain& A, const Chain& B,
                          const uint8_t* src8, const float* lut, float* fbuf,
                          const Mask& mask, Out out, Mid mid) {
  const int H = a.H, W = a.W;
  const SrcU8 x8{src8, lut};
  const SrcF32 xf{fbuf};
  if (n[1] == 0) {                      // A, then the mask
    to_float(src8, lut, fbuf, H, W, mask, false);
    __syncthreads();
    stamp(a, 4);
    run_any(nt[0], A, H, W, xf, out, mask, true);
  } else if (n[0] == 0) {               // the mask, then B
    to_float(src8, lut, fbuf, H, W, mask, mask.on);
    __syncthreads();
    stamp(a, 4);
    run_any(nt[1], B, H, W, xf, out, mask, false);
  } else {                              // A, the mask, B
    run_any(nt[0], A, H, W, x8, mid, mask, true);
    __syncthreads();
    stamp(a, 4);
    run_any(nt[1], B, H, W, xf, out, mask, false);
  }
}

// The mask of the dropout op: Dropout hashes each pixel where it applies;
// for CoarseDropout the threads build the cell of every row and column and
// the keep bit of every cell: the random-size grid (programs 0, 1, 4, 6) or
// the fixed grid (programs 2, 3, 5, 7). With C = 3 channels and the draw's
// per-channel bit, the random grid keeps a bit for each (cell, channel).
template <int TH = THREADS>
__device__ Mask build_mask(const Shared* P, int H, int W, bool fixed,
                           int cap, int* frow, int* fcol, uint8_t* cell,
                           int C = 1) {
  Mask mask;
  mask.on = P->drop[0] > 0.5f;
  mask.pick = P->drop[1] > 0.5f;
  mask.per_channel = C > 1 && P->drop[4] > 0.5f;
  mask.fixed = fixed;
  mask.p = P->drop[2];
  mask.k0 = P->k0;
  mask.k1 = P->k1;
  mask.W = W;
  mask.frow = frow;
  mask.fcol = fcol;
  mask.cell = cell;
  const int tid = threadIdx.x;
  if (fixed) {
    const int gh = da::fixed_cells(H), gw = da::fixed_cells(W);
    mask.wl = gw;
    if (mask.on && !mask.pick) {
      for (int e = tid; e < H + W; e += TH) {
        if (e < H)
          frow[e] = e / (H / gh);
        else
          fcol[e - H] = (e - H) / (W / gw);
      }
      for (int e = tid; e < gh * gw; e += TH)
        cell[e] = da::hash_keep(mask.k0, mask.k1, (uint32_t)e, mask.p);
    }
    return mask;
  }
  const float hl = da::coarse_size(H, P->drop[3]);
  const float wl = da::coarse_size(W, P->drop[3]);
  mask.wl = (int)wl;
  if (mask.on && !mask.pick) {
    for (int e = tid; e < H + W; e += TH) {
      if (e < H)
        frow[e] = da::coarse_cell(e, hl, H);
      else
        fcol[e - H] = da::coarse_cell(e - H, wl, W);
    }
    // min: a size column outside [0, 1) breaks the contract, not the block
    const int cells = min((int)hl * mask.wl, cap);
    const int nc = mask.per_channel ? C : 1;
    for (int e = tid; e < cells * nc; e += TH) {
      const int ce = e / nc, ch = e - ce * nc;
      const int cy = ce / mask.wl, cx = ce - cy * mask.wl;
      const uint32_t id = cell_id(cy, cx, W);
      cell[e] = da::hash_keep(mask.k0, mask.k1,
                              mask.per_channel ? id * C + ch : id, mask.p);
    }
  }
  return mask;
}

// -- programs 2, 4 and 5: one op a pass over the float32 image f ----------

// One warp stage st alone (_affine_warp): its tap table, then src -> dst,
// masked where apply_mask.
template <class Dst>
__device__ void warp_op(const float* st, Axis* tab, int H, int W,
                        const float* src, Dst dst, const Mask& mask,
                        bool apply_mask) {
  const int nt = da::stage_taps(st);
  for (int e = threadIdx.x; e < H + W; e += THREADS) {
    if (e < H)
      da::axis_entry(e, H, st, nullptr, 1, nt, &tab[e]);
    else
      da::axis_entry(e - H, W, st, nullptr, 0, nt, &tab[e]);
  }
  __syncthreads();
  run_any(nt, Chain{tab, st[4], 0.f, da::AFFINE}, H, W, SrcF32{src}, dst,
          mask, apply_mask);
}

// A pixel op: dst[y, x] = op(src, y, x), masked where apply_mask. A warp
// walks rows and its lanes neighbouring columns.
template <class Dst, class Op>
__device__ void pixel_pass(int H, int W, Dst dst, const Mask& mask,
                           bool apply_mask, Op op) {
  const int lane = threadIdx.x & 31;
  for (int y = threadIdx.x >> 5; y < H; y += THREADS / 32) {
    for (int x = lane; x < W; x += 32) {
      float v = op(y, x);
      if (apply_mask) v = __fmul_rn(v, keep(mask, y, x) ? 1.f : 0.f);
      dst(y * W + x, v);
    }
  }
}

// Programs 2, 4 and 5 on f = x / 255 (Distractor's 1 - x / 255): Out
// writes the output, Mid f (rounded to bfloat16 in bfloat16).
template <int PROG, class Out, class Mid>
__device__ void run_pixel_program(const Args& a, const Shared* P, Axis* tab,
                                  float* f, const Mask& mask, Out out) {
  const int H = a.H, W = a.W;
  if constexpr (PROG == SHAPENET1D_FIXED) {     // geometric, then the mask
    warp_op(P->warp[0], tab, H, W, f, out, mask, true);
  } else if constexpr (inverted(PROG)) {      // Affine and the mask
    const auto copy = [&](int y, int x) { return f[y * W + x]; };
    if (P->warp[1][6] <= 0.5f) {                // Affine's gate off
      pixel_pass(H, W, out, mask, mask.on, copy);
    } else if (PROG == DISTRACTOR_FIXED || P->order == 0) {   // Affine first
      warp_op(P->warp[1], tab, H, W, f, out, mask, true);
    } else {                                    // the mask first
      if (mask.on) {
        pixel_pass(H, W, Mid{f}, mask, true, copy);
        __syncthreads();
      }
      warp_op(P->warp[1], tab, H, W, f, out, mask, false);
    }
  }
}

// AddToBrightness (image_aug.py:brightness): V = max(R, G, B); V > 1e-6
// scales every channel by clip(V + b, 0, 1) / max(V, 1e-6), else the gray
// clip(max(b, 0), 0, 1).
__device__ __forceinline__ void bright_px(const float (&x)[RGB_C], float b,
                                          float (&o)[RGB_C]) {
  const float v = fmaxf(fmaxf(x[0], x[1]), x[2]);
  if (v > 1e-6f) {
    const float scale = __fdiv_rn(fminf(fmaxf(__fadd_rn(v, b), 0.f), 1.f),
                                  fmaxf(v, 1e-6f));
#pragma unroll
    for (int c = 0; c < RGB_C; ++c) o[c] = __fmul_rn(x[c], scale);
  } else {
    const float gray = fminf(fmaxf(__fadd_rn(0.f, fmaxf(b, 0.f)), 0.f), 1.f);
#pragma unroll
    for (int c = 0; c < RGB_C; ++c) o[c] = gray;
  }
}

// -- programs 1, 3, 6 and 7: the pass engine (the header's "Programs 1, 3, 6
// and 7") --------------------------------------------------------------------

// The engine's ops; Pascal1D's and ShapeNet3D's op ids map onto them. The
// first three move pixels, the others are pointwise.
enum EngineOp { E_CROP = 0, E_AFFINE = 1, E_BLUR = 2, E_GAMMA = 3,
                E_BRIGHT = 4, E_DROP = 5 };

// a block's threads and the blocks an SM holds (its launch bounds), by
// family (R: ShapeNet3D's RGB programs, else Pascal1D's) and output type:
// the Pascal programs' float32 block (two float32 images of 128 x 128 and
// the uint8 one, 171 KB) is alone on its SM; the others fit two (Pascal in
// bfloat16, RGB in float32) or three (RGB in bfloat16)
__host__ __device__ constexpr int engine_threads(bool R, bool bf16) {
  return R || bf16 ? 512 : 1024;
}
__host__ __device__ constexpr int engine_blocks(bool R, bool bf16) {
  return R ? (bf16 ? 3 : 2) : (bf16 ? 2 : 1);
}

struct EngineLayout {
  int f, g, stage, tab, lut, frow, fcol, cell, cap, par, bar, total;
};

// The dynamic shared memory of an engine block: the uint8 image (Pascal),
// f and g (C planes each, of the output's type: bfloat16 holds every value
// an op rounds to exactly; RGB: the RGBA image staged in their tail), the
// two warps' tap tables, the quotient table (Pascal), the coarse grid's
// rows, columns and cells, the parameters and the barrier.
__host__ __device__ inline EngineLayout engine_layout(int H, int W, bool R,
                                                      bool bf16) {
  EngineLayout L;
  const int HW = H * W, C = R ? RGB_C : 1;
  const int plane = ((bf16 ? 2 : 4) * C * HW + 15) & ~15;
  L.f = R ? 0 : (HW + 15) & ~15;               // the uint8 image at 0
  L.g = L.f + plane;
  // RGB: the RGBA image's bulk copy ends where g does (from f's last plane)
  L.stage = L.g + plane - (bf16 ? 8 : 16) * HW;
  L.tab = L.g + plane;
  L.lut = L.tab + 2 * (H + W) * (int)sizeof(Axis);
  L.frow = L.lut + (R ? 0 : 4 * 256);
  L.fcol = L.frow + 4 * H;
  L.cell = L.fcol + 4 * W;
  L.cap = (H / 4 + 1) * (W / 4 + 1);
  L.par = (L.cell + C * L.cap + 15) & ~15;
  L.bar = L.par + (((int)sizeof(Shared) + 15) & ~15);
  L.total = L.bar + 16;
  return L;
}

__device__ __forceinline__ int engine_op(bool R, int op) {
  if (R) {
    switch (op) {
      case S_CROP: return E_CROP;
      case S_GAMMA: return E_GAMMA;
      case S_BRIGHT: return E_BRIGHT;
      case S_BLUR: return E_BLUR;
      case S_AFFINE: return E_AFFINE;
      default: return E_DROP;
    }
  }
  switch (op) {
    case P_CROP: return E_CROP;
    case P_GAMMA: return E_GAMMA;
    case P_BLUR: return E_BLUR;
    case P_AFFINE: return E_AFFINE;
    default: return E_DROP;
  }
}

// Whether op e changes the image: its Sometimes gate is on (the blur's with
// k > 1; geometric, the fixed programs' CropAndPad, has its gate set). An
// op that is off is the identity, exactly, and takes no pass.
__device__ __forceinline__ bool engine_on(int e, const Shared* P) {
  switch (e) {
    case E_CROP: return P->warp[0][6] > 0.5f;
    case E_AFFINE: return P->warp[1][6] > 0.5f;
    case E_BLUR: return P->pixel[2] > 0.5f && P->pixel[3] > 1.5f;
    case E_GAMMA: return P->pixel[0] > 0.5f;
    case E_BRIGHT: return P->pixel[NX] > 0.5f;
    default: return P->drop[0] > 0.5f;
  }
}

// da::axis_entry for one stage (st1 null) in registers: the tent row of
// output index i's sample position, its taps in order, r their sum from 0,
// padded to nt taps with the first tap's index and weight 0 (no array
// indexed at run time, so nothing in local memory).
__device__ __forceinline__ void axis_entry1(int i, int n, const float* st,
                                            int axis, int nt, Axis* e) {
  const float src = da::stage_src(i, (float)(n - 1) * 0.5f, st, axis);
  const float f = floorf(src);
  const float j0 = __fadd_rn(f, 0.f), j1 = __fadd_rn(f, 1.f);
  const float w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(src, j0))));
  const float w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(src, j1))));
  const bool v0 = w0 > 0.f && j0 >= 0.f && j0 < (float)n;
  const bool v1 = w1 > 0.f && j1 >= 0.f && j1 < (float)n;
  // the taps that count, first to last: (ia, wa) then (ib, wb)
  const int ia = v0 ? (int)j0 : v1 ? (int)j1 : 0;
  const float wa = v0 ? w0 : v1 ? w1 : 0.f;
  const int ib = v0 && v1 ? (int)j1 : ia;
  const float wb = v0 && v1 ? w1 : 0.f;
  float r = 0.f;
  if (v0 || v1) r = __fadd_rn(r, wa);
  if (v0 && v1) r = __fadd_rn(r, wb);
  e->idx[0] = ia;
  e->w[0] = wa;
  if (nt > 1) {
    e->idx[1] = ib;
    e->w[1] = wb;
  }
  e->r = r;
  e->p = 0.f;
}

// The plan of one image from its drawn order (or the fixed one) and gates:
// each moving op that is on is a pass; the pointwise ops that are on ride
// with the pass before them (the load's, before the first moving op), in
// their order.
template <bool R>
__device__ void make_plan(Shared* P, bool fixed) {
  const int n = R ? (fixed ? 5 : (int)NRGB) : (fixed ? 4 : (int)NPASCAL);
  // the fixed programs: geometric (the warp of row 0), GammaContrast,
  // (AddToBrightness,) AverageBlur, then the fixed-grid mask
  const int pascal_fixed[4] = {P_CROP, P_GAMMA, P_BLUR, P_DROP};
  const int rgb_fixed[5] = {S_CROP, S_GAMMA, S_BRIGHT, S_BLUR, S_DROP};
  Plan& pl = P->plan;
  int moves = 0, npw = 0;      // pointwise ops in the current group
  uint32_t code = 0;
  for (int s = 0; s < n; ++s) {
    const int op = !fixed ? P->perm[s] : R ? rgb_fixed[s] : pascal_fixed[s];
    const int e = engine_op(R, op);
    if (!engine_on(e, P)) continue;
    if (e <= E_BLUR) {
      pl.pw[moves] = code;
      pl.move[moves++] = e;
      code = 0;
      npw = 0;
    } else {
      code |= (uint32_t)(e + 1) << (4 * npw++);
    }
  }
  pl.pw[moves] = code;
  for (int g = moves + 1; g <= MAX_MOVES; ++g) pl.pw[g] = 0;
  pl.moves = moves;
}

// Warp 0 reads the draw's inputs first, one lane each (the uniforms, the
// keys), issues the image's bulk copy (uint8, or RGBA into the tail of f
// and g), which runs while it draws, then draws the image's parameters, two
// lanes side by side, each with the single-thread formulas (the bits do
// not depend on who computes them): lane 0 the warps and the dropout op
// (draw_params, then geometric's warp), lane 1 the pixel ops. Warp 1 reads
// and decodes the order meanwhile.
template <bool R>
__device__ void draw_engine(const Args& a, Shared* P, const EngineLayout& L,
                            bool fixed) {
  constexpr int nu = R ? NU_RGB : NU_PIXEL;
  const int tid = threadIdx.x, lane = tid & 31, b = blockIdx.x;
  if (tid >= 32) {                      // warp 1, lane 0: the order
    if (fixed || lane != 0) return;
    if (R) {
      P->order = (int)(((a.order[0] % 720) + 720) % 720);
      da::decode_order(P->order, NRGB, P->perm);
    } else {
      P->order = (int)(((a.order[0] % 120) + 120) % 120);
      da::decode_order(P->order, NPASCAL, P->perm);
    }
    return;
  }
  if (lane < nu) {
    P->u[lane] = a.u[(size_t)b * nu + lane];
  } else if (lane == nu) {
    P->k0 = (uint32_t)a.keys[2 * b];
    P->k1 = (uint32_t)a.keys[2 * b + 1];
  }
  __syncwarp();
  if (lane == 0) {
    const int HW = a.H * a.W, t = b / a.S, s = b - t * a.S;
    const char* image = static_cast<const char*>(a.x) + t * a.st + s * a.ss;
    unsigned char* smem = reinterpret_cast<unsigned char*>(P) - L.par;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
    tc::bar_init(bar, 1);
    tc::bar_init_fence();
    if (R)
      tc::bulk_load(smem + L.stage, image, HW * (a.bf16 ? 8 : 16), bar);
    else
      tc::bulk_load(smem, image, HW, bar);
    const float* u = P->u;
    draw_params(u, a.H, a.W, P);
    if (fixed) draw_geometric(u, a.H, a.W, P);   // geometric's one warp
  } else if (lane == 1) {
    draw_pixel(P->u, P);
    if (R) draw_bright(P->u, P);
  }
}

// plane elements: float32, or bfloat16 (exact: each value is one an op has
// rounded to bfloat16)
__device__ __forceinline__ float ldv(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ldv(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void stv(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void stv(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Where a pass writes pixel (y, x)'s C channels: the planes of an image in
// shared memory, or (to_out) the output, channels interleaved.
template <class T, int C>
struct Dest {
  T* planes;
  T* out;
  int W, HW;
  bool to_out;
  __device__ __forceinline__ void operator()(int y, int x,
                                             const float (&v)[C]) const {
    if (to_out) {
      const size_t i = ((size_t)y * W + x) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) stv(out, i + c, v[c]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) stv(planes, c * HW + y * W + x, v[c]);
    }
  }
};

// The pointwise ops of `code` (4 bits an op, EngineOp + 1, the first in the
// low bits) on pixel (y, x)'s channels in registers, in order, each rounded
// as its JAX op rounds (Round: bfloat16 where it returns img.dtype; the
// masks multiply by 0 or 1, exactly).
template <int C, class Round>
__device__ __forceinline__ void pointwise(uint32_t code, float (&v)[C], int y,
                                          int x, const Pointwise& pw,
                                          Round round) {
  for (; code != 0; code >>= 4) {
    const int e = (int)(code & 15u) - 1;
    if (e == E_GAMMA) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = round(da::gamma_px(v[c], pw.gamma));
    } else if (e == E_BRIGHT) {
      if constexpr (C == RGB_C) {
        float o[RGB_C];
        bright_px(v, pw.bright, o);
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = round(o[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const bool k = C == 1 ? keep(pw.mask, y, x)
                              : keep_rgb(pw.mask, y, x, c);
        v[c] = __fmul_rn(v[c], k ? 1.f : 0.f);
      }
    }
  }
}

// A warp op alone (_affine_warp) from src's planes, then the pointwise ops
// of `code`, into dst. A warp walks rows; lane l owns columns l + 32 k (k <
// NCOL), their table entries in registers, so the lanes of a tap read
// neighbouring elements of a plane; one row entry serves every channel.
// Each column tap's sum over the row taps comes first, then the sum over
// the column taps, each an FMA chain from 0 in index order: the grouping
// and order of the twin's einsum (rows, then columns), whose zero weights
// add nothing, so the sums equal the card twin's bit for bit.
template <int TH, int NT, int NCOL, int C, class T, class Dst, class Round>
__device__ void warp_pass(const Axis* tab, float cval, int H, int W,
                          const T* src, Dst dst, uint32_t code,
                          const Pointwise& pw, Round round) {
  const int lane = threadIdx.x & 31, HW = H * W;
  const Axis* cols = tab + H;
  int ci[NCOL][NT];
  float cw[NCOL][NT], cr[NCOL];
#pragma unroll
  for (int k = 0; k < NCOL; ++k) {
    const Axis& col = cols[min(lane + 32 * k, W - 1)];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      ci[k][q] = col.idx[q];
      cw[k][q] = col.w[q];
    }
    cr[k] = col.r;
  }
  for (int y = threadIdx.x >> 5; y < H; y += TH / 32) {
    const Axis& ay = tab[y];
    float acc[NCOL][C] = {};
#pragma unroll
    for (int q = 0; q < NT; ++q) {
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float t = 0.f;
#pragma unroll
          for (int a = 0; a < NT; ++a)
            t = fmaf(ay.w[a], ldv(src, c * HW + ay.idx[a] * W + ci[k][q]), t);
          acc[k][c] = fmaf(cw[k][q], t, acc[k][c]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NCOL; ++k) {
      const int x = lane + 32 * k;
      if (x >= W) break;
      const float fill =
          da::chain_fill(ay.r, 0.f, cr[k], 0.f, cval, 0.f, da::AFFINE);
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = round(__fadd_rn(acc[k][c], fill));
      pointwise(code, v, y, x, pw, round);
      dst(y, x, v);
    }
  }
}

// AverageBlur's K x K window of plane s at rows ry (times W) and columns cx
// (edge-clamped), summed in the JAX order (da::blur_px: dy-major, from the
// first term, each add rounded), then divided: the K K loads issue before
// the first add.
template <int K, class T, class Round>
__device__ __forceinline__ float blur_sum(const T* s, const int (&ry)[K],
                                          const int (&cx)[K], Round round) {
  float t[K * K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx) t[dy * K + dx] = ldv(s, ry[dy] + cx[dx]);
  float acc = t[0];
#pragma unroll
  for (int j = 1; j < K * K; ++j) acc = round(__fadd_rn(acc, t[j]));
  return __fdiv_rn(acc, (float)(K * K));
}

// AverageBlur (k = K) from src's planes, then the pointwise ops of `code`,
// into dst; the warps and lanes as warp_pass's.
template <int TH, int K, int NCOL, int C, class T, class Dst, class Round>
__device__ void blur_pass(int H, int W, const T* src, Dst dst, uint32_t code,
                          const Pointwise& pw, Round round) {
  const int lane = threadIdx.x & 31, HW = H * W;
  int cx[NCOL][K];
#pragma unroll
  for (int k = 0; k < NCOL; ++k)
#pragma unroll
    for (int d = 0; d < K; ++d)
      cx[k][d] = min(max(lane + 32 * k + d - 1, 0), W - 1);
  for (int y = threadIdx.x >> 5; y < H; y += TH / 32) {
    int ry[K];
#pragma unroll
    for (int d = 0; d < K; ++d) ry[d] = min(max(y + d - 1, 0), H - 1) * W;
#pragma unroll
    for (int k = 0; k < NCOL; ++k) {
      const int x = lane + 32 * k;
      if (x >= W) break;
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[c] = round(blur_sum<K>(src + c * HW, ry, cx[k], round));
      pointwise(code, v, y, x, pw, round);
      dst(y, x, v);
    }
  }
}

// One moving pass: op e from src into dst, then the pointwise ops of `code`.
template <int TH, int NCOL, int C, class T, class Dst, class Round>
__device__ void move_pass(int e, const Shared* P, const Axis* tab, int H,
                          int W, const T* src, Dst dst, uint32_t code,
                          const Pointwise& pw, Round round) {
  if (e == E_BLUR) {
    if (P->pixel[3] > 2.5f)
      blur_pass<TH, 3, NCOL, C>(H, W, src, dst, code, pw, round);
    else
      blur_pass<TH, 2, NCOL, C>(H, W, src, dst, code, pw, round);
    return;
  }
  const float* st = P->warp[e == E_AFFINE];
  const Axis* t = tab + (e == E_AFFINE) * (H + W);
  if (da::stage_taps(st) == 1)
    warp_pass<TH, 1, NCOL, C>(t, st[4], H, W, src, dst, code, pw, round);
  else
    warp_pass<TH, 2, NCOL, C>(t, st[4], H, W, src, dst, code, pw, round);
}

// The moving passes of the plan: f -> g -> f ..., the last into the output;
// a barrier between two, and the phase clock after each.
template <int TH, int NCOL, int C, class T, class Round>
__device__ void move_passes(const Args& a, const Shared* P, const Axis* tab,
                            T* f, T* g, T* out, const Pointwise& pw,
                            Round round) {
  const int H = a.H, W = a.W, HW = H * W;
  const int moves = P->plan.moves;
  T* src = f;
  T* dst = g;
  for (int m = 0; m < moves; ++m) {
    const bool last = m == moves - 1;
    move_pass<TH, NCOL, C>(P->plan.move[m], P, tab, H, W, src,
                           Dest<T, C>{dst, out, W, HW, last},
                           P->plan.pw[m + 1], pw, round);
    if (!last || a.stamps != nullptr) __syncthreads();
    T* t = src;
    src = dst;
    dst = t;
    stamp(a, 4 + m);
  }
}

// The uint8 image (in shared memory) through the quotient table, then the
// load's pointwise ops, into dst: a warp takes a row, 4 pixels a lane.
template <int TH, class Dst, class Round>
__device__ void load_u8(const uint8_t* img, const float* lut, int H, int W,
                        Dst dst, uint32_t code, const Pointwise& pw,
                        Round round) {
  const int x0 = (threadIdx.x & 31) * 4;
  if (x0 >= W) return;
  for (int y = threadIdx.x >> 5; y < H; y += TH / 32) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(img + y * W + x0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[1] = {lut[(q >> (8 * c)) & 0xFFu]};
      pointwise(code, v, y, x0 + c, pw, round);
      dst(y, x0 + c, v);
    }
  }
}

// an RGBA pixel's first three channels: a float4, or a bfloat16 uint2
// widened (R in the low half of .x)
__device__ __forceinline__ void rgb_of(const float4& p, float (&v)[RGB_C]) {
  v[0] = p.x;
  v[1] = p.y;
  v[2] = p.z;
}
__device__ __forceinline__ void rgb_of(const uint2& p, float (&v)[RGB_C]) {
  v[0] = __uint_as_float(p.x << 16);
  v[1] = __uint_as_float(p.x & 0xFFFF0000u);
  v[2] = __uint_as_float(p.y << 16);
}

// The staged RGBA image (bulk-copied into the tail of f and g, from the
// start of f's last plane) into dst, through the load's pointwise ops:
// warp w takes rows w + TH / 32 r, lane l columns l + 32 k, in chunks of
// 4 / NCOL rows a warp (4 pixels a lane); each lane reads its pixels of a
// chunk, then (after a barrier) writes them. A pixel's last channel,
// written into the plane the staging starts at, overwrites the staging of
// the pixel a quarter of its index: one this chunk or an earlier one has
// read. The next chunk's pixels lie beyond any write of this one.
template <int TH, int NCOL, class V, class Dst, class Round>
__device__ void load_rgba(const V* stg, int H, int W, Dst dst, uint32_t code,
                          const Pointwise& pw, Round round) {
  constexpr int PR = 4 / NCOL, NW = TH / 32;
  const int lane = threadIdx.x & 31, w0 = threadIdx.x >> 5;
  for (int y0 = 0; y0 < H; y0 += PR * NW) {
    V v[PR][NCOL];
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const int y = y0 + w0 + r * NW;
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        const int x = lane + 32 * k;
        if (y < H && x < W) v[r][k] = stg[y * W + x];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const int y = y0 + w0 + r * NW;
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        const int x = lane + 32 * k;
        if (y < H && x < W) {
          float c[RGB_C];
          rgb_of(v[r][k], c);
          pointwise(code, c, y, x, pw, round);
          dst(y, x, c);
        }
      }
    }
  }
}

// Programs 1, 3, 6 and 7 (the header's "Programs 1, 3, 6 and 7").
template <bool R, bool BF16, int NCOL>
__device__ void engine(const Args& a, unsigned char* smem) {
  constexpr int TH = engine_threads(R, BF16);
  constexpr int C = R ? RGB_C : 1;
  const bool fixed = fixed_order(a.program);
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  using V = typename std::conditional<BF16, uint2, float4>::type;
  using Round = typename std::conditional<BF16, da::RoundBF16,
                                          da::RoundF32>::type;
  const Round round{};
  const int H = a.H, W = a.W, HW = H * W, tid = threadIdx.x, b = blockIdx.x;
  const EngineLayout L = engine_layout(H, W, R, BF16);
  const uint8_t* src8 = smem;           // Pascal: the uint8 image
  T* f = reinterpret_cast<T*>(smem + L.f);
  T* g = reinterpret_cast<T*>(smem + L.g);
  Axis* tab = reinterpret_cast<Axis*>(smem + L.tab);  // CropAndPad, Affine
  float* lut = reinterpret_cast<float*>(smem + L.lut);
  int* frow = reinterpret_cast<int*>(smem + L.frow);
  int* fcol = reinterpret_cast<int*>(smem + L.fcol);
  uint8_t* cell = smem + L.cell;
  Shared* P = reinterpret_cast<Shared*>(smem + L.par);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  T* out = static_cast<T*>(a.out) + (size_t)b * HW * C;

  stamp(a, 0);
  if (tid < 64) draw_engine<R>(a, P, L, fixed);
  __syncthreads();
  stamp(a, 1);
  // the last thread (which builds no tap entry at the paths' shapes) makes
  // the plan, read after the tables' barrier
  if (tid == TH - 1) make_plan<R>(P, fixed);

  if (a.params_out != nullptr) {        // warp, drop, pixel: one float row
    const int width = R ? NPARAMS_RGB : NPARAMS_PIXEL;
    const float* row = &P->warp[0][0];
    for (int i = tid; i < width; i += TH)
      a.params_out[(size_t)b * width + i] = row[i];
  }
  // the tap tables of the warp ops that are on, [H] rows then [W] columns
  for (int e = tid; e < 2 * (H + W); e += TH) {
    const int w = e >= H + W;
    const int i = e - w * (H + W);
    const float* st = P->warp[w];
    if (!(st[6] > 0.5f)) continue;
    const int nt = da::stage_taps(st);
    if (i < H)
      axis_entry1(i, H, st, 1, nt, &tab[e]);
    else
      axis_entry1(i - H, W, st, 0, nt, &tab[e]);
  }
  if constexpr (!R) {
    for (int i = tid; i < 256; i += TH) {
      const float q = __fdiv_rn((float)i, 255.f);
      lut[i] = BF16 ? bf16_round(q) : q;
    }
  }
  const Mask mask = build_mask<TH>(P, H, W, fixed, L.cap, frow, fcol, cell,
                                   C);
  if (tid == TH - 1)
    P->pw = Pointwise{P->pixel[1], R ? P->pixel[NX + 1] : 0.f, mask};
  __syncthreads();
  stamp(a, 2);
  const Pointwise& pw = P->pw;     // read from shared memory where used

  // the load, then the moving passes
  const uint32_t code = P->plan.pw[0];
  const bool direct = P->plan.moves == 0;     // the load writes the output
  tc::bar_wait(bar, 0);
  const Dest<T, C> to{f, out, W, HW, direct};
  if constexpr (R)
    load_rgba<TH, NCOL>(reinterpret_cast<const V*>(smem + L.stage), H, W, to,
                        code, pw, round);
  else
    load_u8<TH>(src8, lut, H, W, to, code, pw, round);
  if (!direct || a.stamps != nullptr) __syncthreads();
  stamp(a, 3);
  move_passes<TH, NCOL, C>(a, P, tab, f, g, out, pw, round);
  stamp(a, 4 + P->plan.moves, STAMPS);
}

// Programs 1 and 3 (R false) or 6 and 7 (R true); a lane owns 4 columns of
// Pascal1D's images and 2 or 4 of ShapeNet3D's.
template <bool R, bool BF16>
__global__ void __launch_bounds__(engine_threads(R, BF16),
                                  engine_blocks(R, BF16))
    image_da_kernel_engine(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (R && a.W <= 64)
    engine<R, BF16, 2>(a, smem);
  else
    engine<R, BF16, 4>(a, smem);
}

// Program 0 after the staging (the header's "Design").
__device__ void run_shapenet1d(const Args& a, const Layout& L, Shared* P,
                               uint8_t* src8, float* fbuf, Axis* tab,
                               float* lut, int* frow, int* fcol,
                               uint8_t* cell, uint64_t* bar) {
  const int H = a.H, W = a.W, tid = threadIdx.x;
  // the order's shape: the warp ops before the dropout op (chain A) and
  // after it (chain B)
  const int* ops = ORDERS[P->order];
  const float* st[2][2] = {{nullptr, nullptr}, {nullptr, nullptr}};
  int n[2] = {0, 0}, side = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (ops[i] == DROP)
      side = 1;
    else
      st[side][n[side]++] = P->warp[ops[i]];
  }
  const int nt[2] = {n[0] ? chain_taps(st[0][0], st[0][1]) : 0,
                     n[1] ? chain_taps(st[1][0], st[1][1]) : 0};
  for (int i = tid; i < 256; i += THREADS) {
    const float q = __fdiv_rn((float)i, 255.f);
    lut[i] = a.bf16 ? bf16_round(q) : q;
  }
  for (int e = tid; e < 2 * (H + W); e += THREADS) {
    const int c = e >= H + W;
    const int i = e - c * (H + W);
    if (!n[c]) continue;
    if (i < H)
      da::axis_entry(i, H, st[c][0], st[c][1], 1, nt[c], &tab[e]);
    else
      da::axis_entry(i - H, W, st[c][0], st[c][1], 0, nt[c], &tab[e]);
  }
  const Mask mask = build_mask(P, H, W, false, L.cap, frow, fcol, cell);
  __syncthreads();
  stamp(a, 2);
  tc::bar_wait(bar, 0);
  stamp(a, 3);

  const Chain A{tab, n[0] ? st[0][0][4] : 0.f,
                n[0] == 2 ? st[0][1][4] : 0.f, n[0] == 2};
  const Chain B{tab + H + W, n[1] ? st[1][0][4] : 0.f,
                n[1] == 2 ? st[1][1][4] : 0.f, n[1] == 2};
  const int HW = H * W, b = blockIdx.x;
  if (a.bf16)
    run_order(a, n, nt, A, B, src8, lut, fbuf, mask,
              OutBF16{static_cast<__nv_bfloat16*>(a.out) + (size_t)b * HW},
              OutRounded{fbuf});
  else
    run_order(a, n, nt, A, B, src8, lut, fbuf, mask,
              OutF32{static_cast<float*>(a.out) + (size_t)b * HW},
              OutF32{fbuf});
}

template <int PROG>
__global__ void __launch_bounds__(THREADS, 2) image_da_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, HW = H * W;
  const Layout L = layout(H, W);
  uint8_t* src8 = smem;
  float* fbuf = reinterpret_cast<float*>(smem + L.f);
  Axis* tab = reinterpret_cast<Axis*>(smem + L.tab);   // chain A, chain B
  float* lut = reinterpret_cast<float*>(smem + L.lut);
  int* frow = reinterpret_cast<int*>(smem + L.frow);
  int* fcol = reinterpret_cast<int*>(smem + L.fcol);
  uint8_t* cell = smem + L.cell;
  Shared* P = reinterpret_cast<Shared*>(smem + L.par);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int tid = threadIdx.x, b = blockIdx.x;

  const int t = b / a.S, s = b - t * a.S;
  const char* image = static_cast<const char*>(a.x) + t * a.st + s * a.ss;
  stamp(a, 0);
  if (tid == 0) {
    tc::bar_init(bar, 1);
    tc::bar_init_fence();
    tc::bulk_load(src8, image, HW, bar);
    const float* u = a.u + (size_t)b * program_nu(PROG);
    draw_params(u, H, W, P);
    if (geometric(PROG)) draw_geometric(u, H, W, P);
    P->k0 = (uint32_t)a.keys[2 * b];
    P->k1 = (uint32_t)a.keys[2 * b + 1];
    if (PROG == SHAPENET1D)
      P->order = (int)(((a.order[0] % 6) + 6) % 6);   // as the twin reads it
    if (PROG == DISTRACTOR) P->order = (int)(((a.order[0] % 2) + 2) % 2);
    if (a.params_out != nullptr) {
      const int width = program_nparams(PROG);
      float* o = a.params_out + (size_t)b * width;
      for (int i = 0; i < NP; ++i) {
        o[i] = P->warp[0][i];
        o[NP + i] = P->warp[1][i];
      }
      for (int i = 0; i < ND; ++i) o[2 * NP + i] = P->drop[i];
      for (int i = NPARAMS; i < width; ++i) o[i] = 0.f;
    }
  }
  __syncthreads();
  stamp(a, 1);

  if constexpr (PROG == SHAPENET1D) {
    run_shapenet1d(a, L, P, src8, fbuf, tab, lut, frow, fcol, cell, bar);
  } else {                                    // programs 2, 4 and 5
    for (int i = tid; i < 256; i += THREADS) {
      const float q = __fdiv_rn((float)i, 255.f);
      if (inverted(PROG))           // 1 - x / 255, in bfloat16 rounded twice
        lut[i] = a.bf16 ? bf16_round(__fsub_rn(1.f, bf16_round(q)))
                        : __fsub_rn(1.f, q);
      else
        lut[i] = a.bf16 ? bf16_round(q) : q;
    }
    const Mask mask = build_mask(P, H, W, fixed_order(PROG), L.cap, frow,
                                 fcol, cell);
    __syncthreads();
    stamp(a, 2);
    tc::bar_wait(bar, 0);
    stamp(a, 3);
    to_float(src8, lut, fbuf, H, W, mask, false);
    __syncthreads();
    stamp(a, 4);
    if (a.bf16)
      run_pixel_program<PROG, OutBF16, OutRounded>(
          a, P, tab, fbuf, mask,
          OutBF16{static_cast<__nv_bfloat16*>(a.out) + (size_t)b * HW});
    else
      run_pixel_program<PROG, OutF32, OutF32>(
          a, P, tab, fbuf, mask,
          OutF32{static_cast<float*>(a.out) + (size_t)b * HW});
  }
  if (a.stamps != nullptr) {
    __syncthreads();
    stamp(a, 5, STAMPS);
  }
}

constexpr int MAX_DEVICES = 64;
// the attribute set on each program's kernel on each device so far
int configured_smem[NPROGRAMS][MAX_DEVICES];

// and on each engine kernel (float32, bfloat16; Pascal1D, ShapeNet3D)
int configured_engine[2][2][MAX_DEVICES];

template <int PROG>
cudaError_t launch(const Args& a, int B, int smem, int dev,
                   cudaStream_t stream) {
  if (smem > configured_smem[PROG][dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        image_da_kernel<PROG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured_smem[PROG][dev] = smem;
  }
  image_da_kernel<PROG><<<B, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool R, bool BF16>
cudaError_t launch_engine(const Args& a, int B, int smem, int dev,
                          cudaStream_t stream) {
  if (smem > configured_engine[BF16][R][dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        image_da_kernel_engine<R, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured_engine[BF16][R][dev] = smem;
  }
  image_da_kernel_engine<R, BF16>
      <<<B, engine_threads(R, BF16), smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool R>
cudaError_t launch_engine_any(const Args& a, int B, int smem, int dev,
                              cudaStream_t stream) {
  return a.bf16 ? launch_engine<R, true>(a, B, smem, dev, stream)
                : launch_engine<R, false>(a, B, smem, dev, stream);
}

// the dynamic shared memory of program prog's block
int smem_bytes(int prog, int H, int W, bool bf16) {
  return pixel_ops(prog) ? engine_layout(H, W, rgb(prog), bf16).total
                         : layout(H, W).total;
}

}  // namespace

// A launch's geometry for ``program`` on H x W images writing float32 (bf16
// = 0) or bfloat16: out[0] the threads of a block, out[1] its dynamic
// shared memory, out[2] the blocks an SM holds by its launch bounds. -1 for
// a program the kernel does not have.
extern "C" int wmfml_image_da_geometry(int program, int H, int W, int bf16,
                                       int* out) {
  if (program < 0 || program >= NPROGRAMS) return -1;
  const bool passes = pixel_ops(program);
  out[0] = passes ? engine_threads(rgb(program), bf16 != 0) : THREADS;
  out[1] = smem_bytes(program, H, W, bf16 != 0);
  out[2] = passes ? engine_blocks(rgb(program), bf16 != 0) : 2;
  return 0;
}

// x: uint8 images, image (t, s) at x + t st + s ss (bytes), each H x W x 1
// contiguous and 16-byte aligned (programs 6 and 7: RGBA of the output's
// type, float32 or bfloat16, H x W x 4 contiguous), B = T S of them with S
// per task; u [B, 19] f32 ([B, 23] for
// the Pascal programs, [B, 25] for ShapeNet3D's; column 12 in [0, 1)), keys
// [B, 2] i32, order [1] i64 (read modulo 6, 120 for Pascal1D, 2 for
// Distractor or 720 for ShapeNet3D; null for the fixed programs), out [B,
// H, W] f32 (bf16 = 0) or bf16 (bf16 = 1; programs 6 and 7 write [B, H, W,
// 3]), all contiguous on the current device;
// params_out null or [B, 19] f32 for program 0, [B, 25] for programs 6 and
// 7, [B, 23] for the others (the parameters the kernel computed: warp [2,
// 7], drop [5], then the pixel ops' [4] and brightness's [2]); stamps null
// or [B, STAMPS] i64 (the phase clock); program 0-7 (Program). W a multiple
// of 4 and at most 128, H W a multiple of 16, the image in one block's
// shared memory; the fixed programs also need H and W multiples of their
// grid's cells.
// Returns the cudaError_t of the launch, or -1 for a shape or program the
// kernel does not take.
extern "C" int wmfml_image_da_fwd(const void* x, long long st,
                                  long long ss, int S, int B, const float* u,
                                  const int* keys, const long long* order,
                                  void* out, float* params_out,
                                  long long* stamps, int H, int W, int bf16,
                                  int program, void* stream) {
  if (B < 1 || S < 1 || H < 1 || W < 4 || W % 4 || W > 32 * COLS ||
      (H * W) % 16 || program < 0 || program >= NPROGRAMS)
    return -1;
  if (fixed_order(program) &&
      (H % da::fixed_cells(H) || W % da::fixed_cells(W)))
    return -1;
  if (!fixed_order(program) && order == nullptr) return -1;
  const int smem = smem_bytes(program, H, W, bf16 != 0);
  if (smem > MAX_SMEM) return -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const Args a{x,   st,         ss,     S, u, keys, order,
               out, params_out, stamps, H, W, bf16 != 0, program};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (program) {
    case SHAPENET1D: err = launch<SHAPENET1D>(a, B, smem, dev, s); break;
    case SHAPENET1D_FIXED:
      err = launch<SHAPENET1D_FIXED>(a, B, smem, dev, s);
      break;
    case DISTRACTOR: err = launch<DISTRACTOR>(a, B, smem, dev, s); break;
    case DISTRACTOR_FIXED:
      err = launch<DISTRACTOR_FIXED>(a, B, smem, dev, s);
      break;
    default:                  // the engine: 1 and 3, or 6 and 7
      err = rgb(program) ? launch_engine_any<true>(a, B, smem, dev, s)
                         : launch_engine_any<false>(a, B, smem, dev, s);
      break;
  }
  return (int)err;
}
