"""K5: the keyed-hash dropout masks of image data augmentation.

Replaces ``wmfml_tpu/aug/image_aug.py:_fmix32``, ``_hash_keep``,
``dropout``, ``coarse_dropout`` and ``one_of_dropout`` (B3) under their
``Sometimes`` gate: one elementwise pass over [B, H, W, C] float32 images.
The masks are integer arithmetic, so ``csrc/hash_mask.cu`` reproduces the
JAX package's bit for bit given the same key words, drop rate and grid
size; it says what bounds the kernel (the bytes).

``hash_dropout`` is the wrapper the augmenter calls, with ``DAParams.drop``
[B, 5] (gate, pick, p, sp, per_channel) and ``DAParams.keys`` [B, 2]
(int32 bit patterns of the two uint32 key words). A CPU tensor takes the
plain twin ``hash_dropout_plain`` (``aug/image_aug.py:one_of_dropout``); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from wmfml_tpu_torch.kernels import build

ND = 5            # gate, pick, p, sp, per_channel


def hash_dropout_plain(img, drop, keys):
    from wmfml_tpu_torch.aug.image_aug import one_of_dropout

    return one_of_dropout(img, drop, keys)


_fwd = None


def _kernel():
    """The launch function, its ctypes signature set once, at first load."""
    global _fwd
    if _fwd is None:
        fn = build.load("hash_mask").wmfml_hash_dropout_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def hash_dropout_launch(img, drop, keys):
    """Run the CUDA kernel once (no launch count)."""
    if (not img.is_cuda or img.dtype != torch.float32
            or drop.device != img.device or drop.dtype != torch.float32
            or keys.device != img.device or keys.dtype != torch.int32):
        raise TypeError("hash dropout kernel takes float32 CUDA images and "
                        "parameters and int32 key words")
    b = img.shape[0]
    if (img.dim() != 4 or tuple(drop.shape) != (b, ND)
            or tuple(keys.shape) != (b, 2) or b > 65535):
        raise ValueError(f"hash dropout takes img [B <= 65535, H, W, C], "
                         f"drop [B, {ND}] and keys [B, 2]; got "
                         f"{tuple(img.shape)}, {tuple(drop.shape)}, "
                         f"{tuple(keys.shape)}")
    img, drop, keys = img.contiguous(), drop.contiguous(), keys.contiguous()
    out = torch.empty_like(img)
    _, h, w, c = img.shape
    err = _kernel()(img.data_ptr(), drop.data_ptr(), keys.data_ptr(),
                    out.data_ptr(), b, h, w, c,
                    torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash dropout launch failed: cudaError {err}")
    return out


def hash_dropout(img, drop, keys):
    """``Sometimes(OneOf(Dropout, CoarseDropout))`` of ``img`` at the given
    parameters."""
    if img.device.type == "cpu":
        return hash_dropout_plain(img, drop, keys)
    out = hash_dropout_launch(img, drop, keys)
    hash_dropout.launches += 1
    return out


hash_dropout.launches = 0
