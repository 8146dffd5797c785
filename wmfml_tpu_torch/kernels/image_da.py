"""K6: image data augmentation of one augmenter call in one launch.

Replaces ``wmfml_tpu/aug/pipeline.py:_to_float`` and the augmenters of
``wmfml_tpu/aug/image_aug.py`` for one call: uint8 images in (ShapeNet3D's:
float RGB, the RGB channels of the sampler's RGBA batch, in the output's
dtype), float images out, the op order and every image's parameters
computed on the card from the call's raw draws. The images come out in
float32 or, for ``compute_dtype: bfloat16``, in bfloat16, rounded where the
JAX package rounds them: x / 255 (Distractor's 1 - x / 255: the quotient,
then the difference) and the end of every op (or run of adjacent warps)
that returns ``img.dtype``; the masks are exact. ``csrc/image_da.cu`` says
what bounds the kernel and how its block of one image stages the image,
builds its tap and mask tables and runs its op program.

The op programs (``PROGRAMS``; ``aug/image_aug.py`` has each one's twin):

  * ``shapenet_1d``: ShapeNet1D's three ops in one of 3! drawn orders;
  * ``pascal_1d``: Pascal1D's five ops in one of 5! drawn orders;
  * ``shapenet_1d_fixed`` and ``pascal_1d_fixed``: the fixed-order
    pipelines (``aug_random_order: false``);
  * ``distractor``: Distractor's two ops (Affine alone, the dropout op) in
    one of 2! drawn orders, on the inverted image 1 - x / 255;
    ``distractor_fixed``: Affine, then the fixed-grid dropout op, on the
    inverted image;
  * ``shapenet_3d``: ShapeNet3D's six ops (CropAndPad, GammaContrast,
    AddToBrightness, AverageBlur, Affine, the dropout op) in one of 6!
    drawn orders on float RGB, each op alone; ``shapenet_3d_fixed``:
    geometric, GammaContrast, AddToBrightness, AverageBlur, then the
    fixed-grid dropout op. Both read RGBA of the dtype they write.

``image_da(x, u, keys, order, dtype, program)`` is the wrapper the
augmenters call: ``x`` uint8 [B, H, W, 1] or [T, S, H, W, 1] (read through
its T and S strides, not copied; ShapeNet3D's programs: float32 or
bfloat16 [..., H, W, 3] of ``dtype``, the RGB view of an RGBA tensor, pixels
4 elements apart), ``u`` float32
[B, NU[program]] (the
uniforms of the program's ``params_from_draw``; column 12, which sizes the
CoarseDropout grid, in [0, 1)), ``keys`` int32 [B, 2], ``order`` int64 [1]
(an index into the program's orders, read modulo their count; None for the
fixed programs), ``dtype`` float32 or bfloat16, that of the output. A CPU
tensor takes the plain twin ``image_da_plain`` (the program's
``params_from_draw``, then its dense twins); a CUDA tensor launches the
kernel or raises. Each launch counts in ``image_da.launches`` and in
``image_da.program_launches[program]``. Augmentation is not
differentiated, so there is no backward.

Programs 1, 3, 6 and 7 run on the kernel's pass engine: ``engine_passes``
mirrors the passes it plans for an image, ``launch_geometry`` its blocks
(``kernel_geometry`` reads the library's own), and the card checks draw
``covering_orders``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from wmfml_tpu_torch.kernels import build

# K6's op programs, in csrc/image_da.cu's order (its Program)
PROGRAMS = ("shapenet_1d", "pascal_1d", "shapenet_1d_fixed",
            "pascal_1d_fixed", "distractor", "distractor_fixed",
            "shapenet_3d", "shapenet_3d_fixed")
NU = 19                 # uniforms per image (ShapeNet1D's programs)
NU_PIXEL = NU + 4       # with the pixel ops' (Pascal1D's programs)
NU_RGB = NU_PIXEL + 2   # and brightness's (ShapeNet3D's programs)
PROGRAM_NU = {"shapenet_1d": NU, "pascal_1d": NU_PIXEL,
              "shapenet_1d_fixed": NU, "pascal_1d_fixed": NU_PIXEL,
              "distractor": NU, "distractor_fixed": NU,
              "shapenet_3d": NU_RGB, "shapenet_3d_fixed": NU_RGB}
# op orders a call draws from (3!, 5!, 2! and 6!; 1: the fixed programs, no
# order)
PROGRAM_ORDERS = {"shapenet_1d": 6, "pascal_1d": 120,
                  "shapenet_1d_fixed": 1, "pascal_1d_fixed": 1,
                  "distractor": 2, "distractor_fixed": 1,
                  "shapenet_3d": 720, "shapenet_3d_fixed": 1}
# the programs whose first op is ``geometric`` (CropAndPad and Affine as one
# warp: ``aug/image_aug.py:geometric_from_draw``)
GEOMETRIC = ("shapenet_1d_fixed", "pascal_1d_fixed", "shapenet_3d_fixed")
# the programs on float RGB (ShapeNet3D's: C = 3, read from RGBA)
RGB = ("shapenet_3d", "shapenet_3d_fixed")
NPARAMS = 2 * 7 + 5     # the kernel's parameter row: warp [2, 7], drop [5]
NPARAMS_PIXEL = NPARAMS + 4    # then the pixel ops' [4] (programs 1-5)
NPARAMS_RGB = NPARAMS_PIXEL + 2    # and brightness's [2] (programs 6, 7)
# the kernel's phase clock (csrc/image_da.cu: stamp): each block's first
# thread reads the global timer after the draw, the tables, the load (the
# image in shared memory, its first pointwise ops applied) and each pass;
# a program's unused pass points read the end
PHASES = ("start", "drawn", "tables_built", "image_staged", "pass_1",
          "pass_2", "pass_3", "pass_4", "pass_5", "pass_6", "end")
STAMPS = len(PHASES)
UNSUPPORTED = ("image DA kernel takes uint8 [B, H, W, 1] or [T, S, H, W, 1] "
               "images (ShapeNet3D's programs: float [..., H, W, 3], the "
               "RGB channels of an RGBA tensor) with W a multiple of 4 (at "
               "most 128), H W a multiple of 16 and the image in one "
               "block's shared memory (the fixed programs: H and W "
               "multiples of their grid's max(n // 16, 1) cells, as the JAX "
               "package's repeat needs); no shipped configuration has "
               "other channel counts or sizes")


DTYPES = (torch.float32, torch.bfloat16)

# -- the pass engine of programs 1, 3, 6 and 7 (csrc/image_da.cu) -----------

ENGINE = ("pascal_1d", "pascal_1d_fixed", "shapenet_3d", "shapenet_3d_fixed")
# the ops that move pixels: each is a pass; the others are pointwise
MOVING = ("crop_and_pad", "average_blur", "affine")
# the fixed programs' sequences; crop_and_pad is geometric (warp row 0)
FIXED_SEQUENCES = {
    "pascal_1d_fixed": ("crop_and_pad", "gamma_contrast", "average_blur",
                        "one_of_dropout"),
    "shapenet_3d_fixed": ("crop_and_pad", "gamma_contrast", "brightness",
                          "average_blur", "one_of_dropout")}


def op_sequence(program: str, order: Optional[int] = None) -> tuple:
    """The op names an engine program applies, in order: the order index
    read modulo the program's count, or the fixed program's sequence."""
    from wmfml_tpu_torch.aug import image_aug

    if program in FIXED_SEQUENCES:
        return FIXED_SEQUENCES[program]
    if program == "pascal_1d":
        ops, orders = image_aug.PASCAL_OPS, image_aug.PASCAL_ORDERS
    elif program == "shapenet_3d":
        ops, orders = image_aug.SHAPENET3D_OPS, image_aug.SHAPENET3D_ORDERS
    else:
        raise ValueError(f"{program!r} is not an engine program: {ENGINE}")
    return tuple(ops[i] for i in orders[int(order) % len(orders)])


def engine_passes(program: str, order: Optional[int] = None,
                  on: Optional[Sequence[str]] = None) -> tuple:
    """The passes the engine runs on one image (``csrc/image_da.cu:
    make_plan``): the load, then one per moving op whose gate is on, each
    with the pointwise ops that are on and come after it, in order; ``on``
    the names of the ops that are on (None: all). Returns ((op or "load",
    (pointwise ops, ...)), ...)."""
    passes = [("load", [])]
    for op in op_sequence(program, order):
        if on is not None and op not in on:
            continue
        if op in MOVING:
            passes.append((op, []))
        else:
            passes[-1][1].append(op)
    return tuple((op, tuple(pw)) for op, pw in passes)


def covering_orders(program: str) -> tuple:
    """Orders of ``program`` (every gate on) in which, together, each
    pointwise op rides with each moving op, and one pointwise op rides with
    the load: the first order of the program's list that adds a pair,
    until every pair is in."""
    from wmfml_tpu_torch.aug import image_aug

    ops = (image_aug.SHAPENET3D_OPS if program == "shapenet_3d"
           else image_aug.PASCAL_OPS)
    want = {(m, p) for m in MOVING + ("load",) for p in ops
            if p not in MOVING}
    picked = []
    for order in range(PROGRAM_ORDERS[program]):
        pairs = {(m, p) for m, pw in engine_passes(program, order)
                 for p in pw} & want
        if pairs:
            picked.append(order)
            want -= pairs
        if not want:
            return tuple(picked)
    raise AssertionError(f"{program}: no orders put {sorted(want)}")


# -- the launch's geometry (csrc/image_da.cu: layout, engine_layout,
# engine_threads, engine_blocks), mirrored for the host --------------------

SMS = 132                 # an H100 SXM's streaming multiprocessors
SM_SMEM = 233472          # the shared memory an SM holds (228 KB)
BLOCK_RESERVED = 1024     # what the runtime keeps of it for each block
MAX_SMEM = 232448         # the most a block may take (227 KB)
SM_THREADS = 2048
AXIS_BYTES = 40           # csrc/warp.cuh: Axis
SHARED_BYTES = 328        # csrc/image_da.cu: Shared
# (float32, bfloat16): the engine's threads a block, and the blocks an SM
# holds by its launch bounds (the registers are capped to fit them)
ENGINE_THREADS = {"pascal": (1024, 512), "rgb": (512, 512)}
ENGINE_BLOCKS = {"pascal": (1, 2), "rgb": (2, 3)}
THREADS = 256             # programs 0, 2, 4 and 5: two blocks an SM


def kernel_geometry(program: str, h: int, w: int,
                    dtype=torch.float32) -> tuple:
    """The library's own geometry for ``program`` (``csrc/image_da.cu:
    wmfml_image_da_geometry``): (threads a block, its dynamic shared
    memory, the blocks an SM holds by its launch bounds). Builds the
    kernel; for holding ``launch_geometry`` against it on the card."""
    fn = build.load("image_da").wmfml_image_da_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    if fn(PROGRAMS.index(program), h, w, int(dtype == torch.bfloat16),
          ctypes.addressof(out)) != 0:
        raise ValueError(f"image DA has no program {program!r}")
    return tuple(out)


def _up16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(program: str, h: int, w: int, dtype=torch.float32) -> int:
    """The dynamic shared memory of one block of ``program`` on h x w
    images writing ``dtype``."""
    hw, cap = h * w, (h // 4 + 1) * (w // 4 + 1)
    if program in ENGINE:
        c = 3 if program in RGB else 1
        plane = _up16((2 if dtype == torch.bfloat16 else 4) * c * hw)
        tab = (0 if program in RGB else _up16(hw)) + 2 * plane
        lut = 0 if program in RGB else 4 * 256
    else:
        c, tab, lut = 1, _up16(hw) + 4 * hw, 4 * 256
    cell = tab + 2 * (h + w) * AXIS_BYTES + lut + 4 * (h + w)
    return _up16(cell + c * cap) + _up16(SHARED_BYTES) + 16


def launch_geometry(program: str, h: int, w: int, dtype=torch.float32,
                    images: int = 1) -> dict:
    """One launch of ``program`` on ``images`` h x w images: its block's
    threads and shared memory, the blocks an SM holds (by shared memory
    and threads; the launch bounds' count, ``min_blocks``, is what the
    registers are capped to fit), and the waves the images take on
    ``SMS`` SMs."""
    if program in ENGINE:
        family = "rgb" if program in RGB else "pascal"
        i = int(dtype == torch.bfloat16)
        threads = ENGINE_THREADS[family][i]
        min_blocks = ENGINE_BLOCKS[family][i]
    else:
        threads, min_blocks = THREADS, 2
    smem = smem_bytes(program, h, w, dtype)
    blocks = min(SM_SMEM // (smem + BLOCK_RESERVED), SM_THREADS // threads)
    return dict(threads=threads, smem=smem, blocks_per_sm=blocks,
                min_blocks=min_blocks,
                waves=-(-images // (SMS * blocks)) if blocks else None)


def nparams(program: str) -> int:
    """The width of the kernel's parameter row (``params_out``)."""
    if program == "shapenet_1d":
        return NPARAMS
    return NPARAMS_RGB if program in RGB else NPARAMS_PIXEL


def image_da_plain(x, u, keys, order, dtype=torch.float32,
                   program="shapenet_1d"):
    """The twin: the program's ``params_from_draw``, then its
    ``program_input`` (x / 255 rounded to ``dtype``, Distractor's
    1 - x / 255, or ShapeNet3D's float images) through its ``apply``."""
    from wmfml_tpu_torch.aug.image_aug import (apply_program, params_for,
                                               program_input)

    h, w = x.shape[-3], x.shape[-2]
    flat = x.reshape((-1,) + tuple(x.shape[-3:]))
    params = params_for(program, u, keys, order, h, w)
    return apply_program(program, program_input(program, flat, dtype),
                         params).reshape(x.shape)


_fwd = None


def _kernel():
    """The launch function, its ctypes signature set once, at first load."""
    global _fwd
    if _fwd is None:
        fn = build.load("image_da").wmfml_image_da_fwd
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def image_da_launch(x, u, keys, order, dtype=torch.float32,
                    params_out: Optional[torch.Tensor] = None,
                    stamps: Optional[torch.Tensor] = None,
                    program: str = "shapenet_1d"):
    """Run the CUDA kernel once (no launch count). ``params_out`` (float32
    [B, nparams(program)]) receives the parameters the kernel computed,
    ``stamps`` (int64 [B, STAMPS]) its phase clock (the global timer, ns,
    at ``PHASES``); both are for tests and ``chip_smoke.py``, null on the
    path."""
    if program not in PROGRAMS:
        raise ValueError(f"image DA program {program!r}: one of {PROGRAMS}")
    fixed = PROGRAM_ORDERS[program] == 1
    if (order is None) != fixed:
        raise ValueError(f"image DA program {program!r} takes "
                         f"{'no' if fixed else 'an'} order")
    rgb = program in RGB
    if dtype not in DTYPES:
        raise TypeError(f"image DA program {program!r} writes one of "
                        f"{DTYPES}; got {dtype}")
    if (not x.is_cuda or x.dtype != (dtype if rgb else torch.uint8)
            or any(t.device != x.device for t in (u, keys))
            or u.dtype != torch.float32 or keys.dtype != torch.int32
            or (order is not None and (order.device != x.device
                                       or order.dtype != torch.int64))):
        raise TypeError("image DA kernel takes uint8 images (ShapeNet3D's "
                        "programs: RGBA of the dtype they write, float32 or "
                        "bfloat16), float32 uniforms, int32 keys and an "
                        "int64 order, all on one CUDA device")
    if x.dim() == 4:
        t_, s_, st, ss = x.shape[0], 1, x.stride(0), 0
    elif x.dim() == 5:
        t_, s_, st, ss = x.shape[0], x.shape[1], x.stride(0), x.stride(1)
    else:
        raise ValueError(f"{UNSUPPORTED}; got {tuple(x.shape)}")
    h, w, c = x.shape[-3:]
    b = t_ * s_
    # element strides of a pixel, a row and an image: uint8 C = 1 dense, or
    # RGB read from RGBA, 4 elements a pixel
    pix = 4 if rgb else 1
    st, ss = st * x.element_size(), ss * x.element_size()
    if (c != (3 if rgb else 1) or w % 4 or w > 128 or (h * w) % 16
            or x.stride()[-3:] != (w * pix, pix, 1) or x.data_ptr() % 16
            or st % 16 or ss % 16):
        raise ValueError(f"{UNSUPPORTED}; got {tuple(x.shape)} with strides "
                         f"{x.stride()}")
    nu = PROGRAM_NU[program]
    if (tuple(u.shape) != (b, nu) or tuple(keys.shape) != (b, 2)
            or (order is not None and order.numel() != 1)):
        raise ValueError(f"image DA takes u [{b}, {nu}], keys [{b}, 2] and "
                         f"one order; got {tuple(u.shape)}, "
                         f"{tuple(keys.shape)}, "
                         f"{None if order is None else tuple(order.shape)}")
    for name, t, shape, want in (("params_out", params_out,
                                   (b, nparams(program)), torch.float32),
                                  ("stamps", stamps, (b, STAMPS),
                                   torch.int64)):
        if t is not None and (t.device != x.device or t.dtype != want
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be {want} {list(shape)} on the "
                             f"images' device")
    u, keys = u.contiguous(), keys.contiguous()
    order = None if order is None else order.contiguous()
    out = torch.empty(x.shape, device=x.device, dtype=dtype)
    with torch.cuda.device(x.device):   # the launcher sets up the current one
        err = _kernel()(x.data_ptr(), st, ss, s_, b, u.data_ptr(),
                        keys.data_ptr(),
                        0 if order is None else order.data_ptr(),
                        out.data_ptr(),
                        0 if params_out is None else params_out.data_ptr(),
                        0 if stamps is None else stamps.data_ptr(), h, w,
                        int(dtype == torch.bfloat16), PROGRAMS.index(program),
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err == -1:
        raise ValueError(f"{UNSUPPORTED}; got {tuple(x.shape)}")
    if err != 0:
        raise RuntimeError(f"image DA launch failed: cudaError {err}")
    return out


def image_da(x, u, keys, order, dtype=torch.float32, program="shapenet_1d"):
    """One augmenter call: ``dtype`` images of ``x``'s shape."""
    if x.device.type == "cpu":
        return image_da_plain(x, u, keys, order, dtype, program)
    out = image_da_launch(x, u, keys, order, dtype, program=program)
    image_da.launches += 1
    image_da.bf16_launches += dtype == torch.bfloat16
    image_da.program_launches[program] += 1
    return out


image_da.launches = 0           # every launch on the path
image_da.bf16_launches = 0      # those that wrote bfloat16
image_da.program_launches = dict.fromkeys(PROGRAMS, 0)   # by program
