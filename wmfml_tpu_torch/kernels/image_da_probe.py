"""K6's store layout, measured: the shipped kernel against a variant whose
lanes own four adjacent columns and store them as one float4.

    python -m wmfml_tpu_torch.kernels.image_da_probe   # on a CUDA device

``csrc/image_da.cu`` gives lane l of a warp the columns l, l + 32, l + 64,
l + 96 and stores each as a scalar: the 32 lanes of one tap then read 32
neighbouring words of the float32 image in shared memory, and each warp
store writes 128 contiguous bytes. The variant, made here from the shipped
source by two text substitutions and built beside it into
``wmfml_tpu_torch/_build/``, gives lane l the columns 4l .. 4l + 3 and
stores them as one float4 (vectorised float32 stores; float32 output
only): its taps of the
float32 image read every fourth word. Both compute the same
sums in the same order, so their outputs must be equal bit for bit; the
probe checks that, then times both in each of the six op orders on the
smoke's shape (the context slice of a [10, 30, 128, 128, 1] uint8 batch,
every gate on) and prints one JSON line per order and the card's name and
power limit. The port never imports this module.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from wmfml_tpu_torch.kernels import build
from wmfml_tpu_torch.kernels import image_da as kda

# (shipped text, variant text) in csrc/image_da.cu's run_chain
SUBSTITUTIONS = (
    ("    const Axis& e = cols[min(lane + 32 * k, W - 1)];",
     "    const Axis& e = cols[min(4 * lane + k, W - 1)];"),
    ("""#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int x = lane + 32 * k;
      if (x >= W) break;
      float v = __fadd_rn(acc[k], da::chain_fill(ay.r, ay.p, cr[k], cp[k],
                                                 ch.c0, ch.c1, ch.form));
      if (apply_mask) v = __fmul_rn(v, keep(mask, y, x) ? 1.f : 0.f);
      dst(y * W + x, v);
    }""",
     """    if (4 * lane >= W) continue;
    float o[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int x = 4 * lane + k;
      float v = __fadd_rn(acc[k], da::chain_fill(ay.r, ay.p, cr[k], cp[k],
                                                 ch.c0, ch.c1, ch.form));
      if (apply_mask) v = __fmul_rn(v, keep(mask, y, x) ? 1.f : 0.f);
      o[k] = v;
    }
    *reinterpret_cast<float4*>(dst.p + y * W + 4 * lane) =
        make_float4(o[0], o[1], o[2], o[3]);"""),
)


def build_variant() -> ctypes.CDLL:
    with open(os.path.join(build.CSRC_DIR, "image_da.cu")) as f:
        src = f.read()
    for old, new in SUBSTITUTIONS:
        if src.count(old) != 1:
            raise RuntimeError("csrc/image_da.cu changed: the probe's "
                               "substitution no longer applies")
        src = src.replace(old, new)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, "image_da_float4.cu")
    lib = os.path.join(build.BUILD_DIR, "libimage_da_float4.so")
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                          build.CSRC_DIR, "-o", lib, cu], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the variant:\n{out.stdout}"
                           f"{out.stderr}")
    fn = ctypes.CDLL(lib).wmfml_image_da_fwd
    fn.argtypes = kda._kernel().argtypes
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, x, u, keys, order):
    t_, s_ = x.shape[0], x.shape[1]
    st, ss = x.stride(0), x.stride(1)
    h, w = x.shape[2], x.shape[3]
    out = torch.empty(x.shape, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(x.data_ptr(), st, ss, s_, t_ * s_, u.data_ptr(),
                 keys.data_ptr(), order.data_ptr(), out.data_ptr(), 0, 0, h,
                 w, 0, 0, stream)           # float32, program 0 (ShapeNet1D)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")
        return out
    return launch


def device_us(launch, iters=50):
    """Mean device time of one launch (us): the mean duration of the
    kernel events torch.profiler recorded (it may drop a few)."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            launch()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not us:
        raise RuntimeError("the profiler recorded no kernel")
    return sum(us) / len(us), len(us)


def main() -> int:
    if not torch.cuda.is_available():
        print("image_da_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    from wmfml_tpu_torch.aug.image_aug import ORDERS, ShapeNet1DAugmenter

    variant = build_variant()
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = torch.randint(0, 256, (10, 30, 128, 128, 1), dtype=torch.uint8,
                          generator=gen, device="cuda")
    x = batch[:, :15]
    u, keys, _ = ShapeNet1DAugmenter().sample(150, gen, "cuda")
    u[:, 13] = u[:, 14] = u[:, 16] = 0.25          # every gate on
    for o, ops in enumerate(ORDERS):
        order = torch.tensor([o], device="cuda")
        kernels = {"shipped": launcher(kda._kernel(), x, u, keys, order),
                   "float4": launcher(variant, x, u, keys, order)}
        shipped = kernels["shipped"]().clone()
        if not torch.equal(kernels["float4"](), shipped):
            raise AssertionError(f"order {ops}: the variant's output differs")
        times = {k: [] for k in kernels}
        for name in ("shipped", "float4", "float4", "shipped"):
            times[name].append(device_us(kernels[name]))
        print(json.dumps({
            "order": list(ops),
            **{f"{k}_device_us": [t[0] for t in v] for k, v in times.items()},
            **{f"{k}_events": [t[1] for t in v] for k, v in times.items()}}),
            flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
