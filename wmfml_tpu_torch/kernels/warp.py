"""K4: the warp chain of image data augmentation.

Replaces ``wmfml_tpu/aug/image_aug.py:_interp_matrix``, ``_stage_matrices``
and ``_warp_chain`` (B2): one or two scale/translate warps with constant
fill, each under its ``Sometimes`` gate, in one pass over [B, H, W, C]
float32 images. ``csrc/warp.cu`` says why the card gathers at most 4 x 4
taps a pixel instead of the JAX package's dense tent-matrix products, what
bounds it (the bytes) and why its sample positions repeat the JAX float32
operations exactly (nearest snapping).

``warp_chain_op`` is the wrapper the augmenter calls, with the parameter
rows ``DAParams.warp`` [B, 2, 7] and the stages' op ids in order (one or
two of 0 = CropAndPad, 1 = Affine). A CPU tensor takes the plain twin
``warp_plain`` (the dense JAX math, ``aug/image_aug.py:warp_chain``); a
CUDA tensor launches the kernel or raises. Augmentation is not
differentiated, so there is no backward.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from wmfml_tpu_torch.kernels import build

NP = 7            # sx, sy, tx, ty, cval, nearest, gate
MAX_W = 1024      # widest image whose column taps fit the block's table


def warp_plain(img, warp, ops: Sequence[int]):
    """img [B, H, W, C] float32; warp [B, 2, 7]; ops the stages in order."""
    from wmfml_tpu_torch.aug.image_aug import stages_from_params, warp_chain

    return warp_chain(img, stages_from_params(warp, ops))


_fwd = None


def _kernel():
    """The launch function, its ctypes signature set once, at first load."""
    global _fwd
    if _fwd is None:
        fn = build.load("warp").wmfml_warp_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def warp_launch(img, warp, ops: Sequence[int]):
    """Run the CUDA kernel once (no launch count)."""
    if (not img.is_cuda or img.dtype != torch.float32
            or warp.device != img.device or warp.dtype != torch.float32):
        raise TypeError("warp chain kernel takes float32 CUDA tensors only")
    if img.dim() != 4 or tuple(warp.shape) != (img.shape[0], 2, NP):
        raise ValueError(f"warp chain takes img [B, H, W, C] and params "
                         f"[B, 2, {NP}]; got {tuple(img.shape)}, "
                         f"{tuple(warp.shape)}")
    ops = tuple(ops)
    if not 1 <= len(ops) <= 2 or any(op not in (0, 1) for op in ops):
        raise ValueError(f"warp chain takes one or two stages of ops 0, 1; "
                         f"got {ops}")
    b, h, w, c = img.shape
    if w > MAX_W or b > 65535:
        raise ValueError(f"warp chain takes W <= {MAX_W}, B <= 65535; got "
                         f"{tuple(img.shape)}")
    img, warp = img.contiguous(), warp.contiguous()
    out = torch.empty_like(img)
    err = _kernel()(img.data_ptr(), warp.data_ptr(), out.data_ptr(), b, h, w,
                    c, ops[0], ops[1] if len(ops) == 2 else -1,
                    torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp chain launch failed: cudaError {err}")
    return out


def warp_chain_op(img, warp, ops: Sequence[int]):
    """The stages ``ops`` of ``warp`` applied to ``img``, fill included."""
    if img.device.type == "cpu":
        return warp_plain(img, warp, ops)
    out = warp_launch(img, warp, ops)
    warp_chain_op.launches += 1
    return out


warp_chain_op.launches = 0
