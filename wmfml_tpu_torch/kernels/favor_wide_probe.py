"""K2's wide form at the nine shapes phase 3 of ``chip_smoke.py`` holds,
timed on the card: the way to compare two trees of the port on one card
in one run.

    python -m wmfml_tpu_torch.kernels.favor_wide_probe           # this tree
    PYTHONPATH=<another checkout> python <this file> --label parent

The second form runs the wide kernel of whichever ``wmfml_tpu_torch`` the
path gives (the other tree builds its own ``_build/``); the probe uses only
what every tree since the wide form's bf16 path has: ``favor_launch``,
``favor_plain``, ``wide_grid``, ``WIDE_PHASES`` and
``gaussian_orthogonal_random_matrix``. Run the trees in turns (parent, change, change, parent) in one
call: two calls may land on two cards.

Per row: D1 (Nq 18, Nk 15), D4 (36, 25), S1 (15, 15), S4 (30, 25), Q2
(30, 15) in float32, D5 (18, 15) and S6 (15, 15) in bfloat16, and R100
(50, 50) in both; T = 20, H = 8, d = e = 256, m = 1419, q, k, v handed
over transposed as the attention block does, shots 1 .. Nk. One JSON line
a row: the kernel's device us a launch (torch.profiler, the mean of the
recorded launches), the CUDA events' ms a call over 50 calls, its max abs
error against ``favor_plain`` on the same inputs (the bf16 twin for bf16),
and the tree's own phase clock (us from the first block's start until the
last block reached each point, medians of 10 launches). Then the card's
name and power limit. The port never imports this module.

    python -m wmfml_tpu_torch.kernels.favor_wide_probe --breakdown

builds a copy of ``csrc/favor.cu`` with clock64 counters added by text
substitutions (``CLOCK``; it raises if the source no longer matches) into
``wmfml_tpu_torch/_build/`` and prints, per row, where phase 1's cycles go
on two threads of each block (means over the blocks): thread 0, of the
product warpgroups (tile staging, row staging and its loads, the products,
waiting for the epilogue warpgroups, the tile's combine), and thread 256,
of the epilogue warpgroups (waiting for a tile, the epilogue, waiting for
the next product).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROWS = (("D1", 18, 15, torch.float32), ("D4", 36, 25, torch.float32),
        ("S1", 15, 15, torch.float32), ("S4", 30, 25, torch.float32),
        ("Q2", 30, 15, torch.float32), ("D5", 18, 15, torch.bfloat16),
        ("S6", 15, 15, torch.bfloat16), ("R100", 50, 50, torch.float32),
        ("R100_bf16", 50, 50, torch.bfloat16))
T, H, D, M = 20, 8, 256, 1419


def inputs(nq, nk, dtype, seed):
    from wmfml_tpu_torch.nn.attention import gaussian_orthogonal_random_matrix

    proj = gaussian_orthogonal_random_matrix(
        M, D, torch.Generator().manual_seed(seed)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((T, nq, H, D), generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    k, v = (torch.randn((T, nk, H, D), generator=gen, device="cuda").to(
        dtype).transpose(1, 2) for _ in range(2))
    shots = torch.tensor([1 + ((nk - 1) * i) // (T - 1) for i in range(T)],
                         device="cuda")
    mask = torch.arange(nk, device="cuda")[None, :] < shots[:, None]
    return q, k, v, proj, mask


def device_us(fn, iters=20):
    """Mean device time of the kernels ``fn`` launches, a call (us)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not us:
        raise RuntimeError("the profiler recorded no kernel")
    return sum(us) / len(us)


def events_ms(fn, iters=50):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phases(favor, q, k, v, proj, mask, runs=10):
    rows = favor.wide_grid(q.shape[0] * q.shape[1], proj.shape[0])
    per_run = []
    for _ in range(runs):
        st = torch.full((rows, len(favor.WIDE_PHASES)), -1,
                        dtype=torch.int64, device="cuda")
        favor.favor_launch(q, k, v, proj, mask, stamps=st)
        s = st.cpu().double()
        per_run.append({name: float(s[:, j].max() - s[:, 0].min()) / 1e3
                        for j, name in enumerate(favor.WIDE_PHASES) if j})
    return {n: statistics.median(r[n] for r in per_run) for n in per_run[0]}


# (shipped text, instrumented text) in csrc/favor.cu's wide form: thread 0
# and thread 256 add the cycles since their last tick to counter j
_TICK = """
__device__ __forceinline__ long long* clk() { __shared__ long long d[20]; return d; }
__device__ __forceinline__ void tick(int j) {
  if (threadIdx.x == 0 || threadIdx.x == 256) {
    long long* d = clk() + (threadIdx.x ? 10 : 0);
    const long long n = clock64();
    d[j] += n - d[9];
    d[9] = n;
  }
}
"""
CLOCK = (
    ("struct Unit {", _TICK + "struct Unit {"),
    ("  float* ssq = smem + P1_SSQ;\n  stamp(p, 0);\n",
     "  float* ssq = smem + P1_SSQ;\n  stamp(p, 0);\n"
     "  if (threadIdx.x == 0) for (int i = 0; i < 20; ++i) clk()[i] = 0;\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0 || threadIdx.x == 256)"
     " clk()[threadIdx.x ? 19 : 9] = clock64();\n"),
    ("        stage_tile(p, smem, tile);\n",
     "        tick(0);\n        stage_tile(p, smem, tile);\n        tick(1);\n"),
    ("        tc::named_sync(BAR_MMA, MT);\n        if (tile == 0",
     "        tc::named_sync(BAR_MMA, MT);\n        tick(2);\n"
     "        if (tile == 0"),
    ("        if (u == u0 && off == 0) stamp(p, 1);\n",
     "        tick(3);\n        if (u == u0 && off == 0) stamp(p, 1);\n"),
    ("  tc::pin(acc);\n  tc::named_sync(BAR_MMA, MT);      // both products are"
     " done: B is free\n  if (off == 0) tc::named_sync(BAR_FREE, THREADS);\n",
     "  tc::pin(acc);\n  tick(4);\n  tc::named_sync(BAR_MMA, MT);\n"
     "  if (off == 0) tc::named_sync(BAR_FREE, THREADS);\n  tick(5);\n"),
    ("      tc::named_sync(BAR_READY, THREADS);   // the tile is written\n",
     "      tick(6);\n      tc::named_sync(BAR_READY, THREADS);\n"
     "      tick(7);\n"),
    ("      epilogue(p, smem, unit_of(p, u));\n"
     "      if (u + 1 < u1) tc::named_sync(BAR_FREE, THREADS);\n",
     "      tick(0);\n      epilogue(p, smem, unit_of(p, u));\n      tick(1);\n"
     "      if (u + 1 < u1) tc::named_sync(BAR_FREE, THREADS);\n"
     "      tick(2);\n"),
    ("  __syncthreads();\n  stamp(p, 2);",
     "  __syncthreads();\n"
     "  if ((threadIdx.x == 0 || threadIdx.x == 256) && p.stamps)"
     " for (int i = 0; i < 9; ++i)"
     " p.stamps[gridDim.x * STAMPS + blockIdx.x * 18 + (threadIdx.x ? 9 : 0)"
     " + i] = clk()[(threadIdx.x ? 10 : 0) + i];\n  stamp(p, 2);"),
)
PRODUCT = ("misc", "tile", "rows", "loads", "products", "wait_epilogue",
           "combine")
EPILOGUE = ("wait_tile", "epilogue", "wait_product")


def clocked_library():
    """The instrumented copy of the wide form, built and loaded."""
    from wmfml_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC_DIR, "favor.cu")) as f:
        src = f.read()
    for old, new in CLOCK:
        if src.count(old) != 1:
            raise RuntimeError("csrc/favor.cu changed: the probe's clock "
                               f"no longer applies at {old[:40]!r}")
        src = src.replace(old, new)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, "favor_clocked.cu")
    lib = os.path.join(build.BUILD_DIR, "libfavor_clocked.so")
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                          build.CSRC_DIR, "-o", lib, cu], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the clocked copy:\n{out.stdout}")
    return ctypes.CDLL(lib)


def breakdown(favor) -> None:
    """Phase 1's cycles per block on the product and epilogue threads."""
    lib = clocked_library()
    fn, size = lib.wmfml_favor_wide_fwd, lib.wmfml_favor_wide_scratch_floats
    fn.argtypes = favor._kernel_wide()[0].argtypes
    fn.restype = ctypes.c_int
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    shipped = favor._fwd_wide
    favor._fwd_wide = fn, size
    try:
        for seed, (name, nq, nk, dtype) in enumerate(ROWS):
            q, k, v, proj, mask = inputs(nq, nk, dtype, seed)
            rows = favor.wide_grid(T * H, M)
            buf = torch.zeros(rows * (len(favor.WIDE_PHASES) + 18),
                              dtype=torch.int64, device="cuda")
            favor.favor_launch(q, k, v, proj, mask)
            favor.favor_launch(q, k, v, proj, mask,
                               stamps=buf[:rows * len(favor.WIDE_PHASES)]
                               .view(rows, -1))
            c = buf[rows * len(favor.WIDE_PHASES):].view(rows, 18).double()
            c = c.mean(0).tolist()
            print(json.dumps({
                "row": name, "units_per_block": favor_units(nq, nk) / rows,
                "product_thread_cycles": dict(zip(PRODUCT, c[:7])),
                "epilogue_thread_cycles": dict(zip(EPILOGUE, c[9:12]))}),
                flush=True)
    finally:
        favor._fwd_wide = shipped


def favor_units(nq, nk):
    """Phase 1's units at a row's shape (csrc/favor.cu: wide::layout)."""
    if nq + nk <= 64:
        pairs = 1
    else:
        kc = min(nk, max(64 - nq, 32))
        qc = min(nq, 64 - kc)
        pairs = -(-nq // qc) * -(-nk // kc)
    return T * H * -(-M // 64) * pairs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("favor_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    from wmfml_tpu_torch.kernels import favor

    if args.breakdown:
        torch.backends.cuda.matmul.allow_tf32 = False
        breakdown(favor)
        print(subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip(), flush=True)
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False
    for seed, (name, nq, nk, dtype) in enumerate(ROWS):
        q, k, v, proj, mask = inputs(nq, nk, dtype, seed)
        got = favor.favor_launch(q, k, v, proj, mask)
        want = favor.favor_plain(q, k, v, proj, mask)
        ok = ~torch.isnan(want)
        if not torch.equal(torch.isnan(got), ~ok):
            raise AssertionError(f"{name}: NaN where the twin has none")
        err = float((got - want)[ok].abs().max())
        call = lambda: favor.favor_launch(q, k, v, proj, mask)  # noqa: E731
        print(json.dumps({
            "label": args.label, "row": name, "nq": nq, "nk": nk,
            "dtype": str(dtype).replace("torch.", ""),
            "device_us": device_us(call), "events_ms": events_ms(call),
            "max_abs_err": err,
            "phase_us": phases(favor, q, k, v, proj, mask)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
