"""K6's pass engine (programs 1, 3, 6 and 7) on the host: the passes it
plans for an image, the orders the card checks draw, and the launch's
geometry at every path's shape.

``csrc/image_da.cu:make_plan`` turns an image's order and gates into
passes on the card; ``kernels/image_da.py:engine_passes`` is its host
mirror, which the checks use to choose orders. The twins
(``aug/image_aug.py:apply_pascal``, ``apply_shapenet3d``, ``apply_fixed``)
apply each op alone in the drawn order: here the passes, read back as an op
sequence, must give that order with the ops that are off left out, and a
pass must hold at most one moving op. ``launch_geometry`` mirrors the
kernel's shared-memory layouts and launch bounds; the card test
``test_image_da_geometry_is_the_kernels`` holds it against the library's
``wmfml_image_da_geometry``.
"""

import itertools

import pytest
import torch

from wmfml_tpu_torch.aug import image_aug as paug
from wmfml_tpu_torch.kernels import image_da as kda

BF16 = torch.bfloat16
POINTWISE = ("gamma_contrast", "brightness", "one_of_dropout")


def _ops(program):
    return paug.SHAPENET3D_OPS if program in kda.RGB else paug.PASCAL_OPS


@pytest.mark.parametrize("program", ["pascal_1d", "shapenet_3d"])
def test_passes_replay_the_order_with_the_ops_that_are_on(program):
    """Every order and every set of gates: the passes, flattened, are the
    order's ops that are on, in order; one moving op a pass after the
    load, so at most three passes besides it."""
    ops = _ops(program)
    for order in range(kda.PROGRAM_ORDERS[program]):
        seq = kda.op_sequence(program, order)
        for bits in range(2 ** len(ops)):
            on = [op for i, op in enumerate(ops) if bits >> i & 1]
            passes = kda.engine_passes(program, order, on)
            flat = [op for m, pw in passes
                    for op in ((m,) if m != "load" else ()) + pw]
            assert flat == [op for op in seq if op in on]
            assert passes[0][0] == "load"
            assert all(m in kda.MOVING for m, _ in passes[1:])
            assert len(passes) - 1 == sum(op in kda.MOVING for op in on)
            assert all(p not in kda.MOVING for _, pw in passes for p in pw)


@pytest.mark.parametrize("program,order,want", [
    ("shapenet_3d", 0, (("load", ()),
                        ("crop_and_pad", ("gamma_contrast", "brightness")),
                        ("average_blur", ()),
                        ("affine", ("one_of_dropout",)))),
    ("pascal_1d", 119, (("load", ("one_of_dropout",)), ("affine", ()),
                        ("average_blur", ("gamma_contrast",)),
                        ("crop_and_pad", ()))),
    ("pascal_1d_fixed", None, (("load", ()),
                               ("crop_and_pad", ("gamma_contrast",)),
                               ("average_blur", ("one_of_dropout",)))),
    ("shapenet_3d_fixed", None, (("load", ()),
                                 ("crop_and_pad", ("gamma_contrast",
                                                   "brightness")),
                                 ("average_blur", ("one_of_dropout",)))),
])
def test_passes_of_the_identity_reverse_and_fixed_orders(program, order,
                                                         want):
    assert kda.engine_passes(program, order) == want


@pytest.mark.parametrize("program", ["pascal_1d", "shapenet_3d"])
def test_op_sequence_is_the_twins_order(program):
    """The order index as the twins read it: modulo the count, and for
    ShapeNet3D decoded as the kernel decodes it."""
    n = kda.PROGRAM_ORDERS[program]
    for order in (0, 1, n - 1, n, -1, 7 * n + 3):
        idx = order % n
        if program == "shapenet_3d":
            perm = paug.decode_order(idx, 6)
        else:
            perm = paug.PASCAL_ORDERS[idx]
        assert kda.op_sequence(program, order) == tuple(
            _ops(program)[i] for i in perm)


@pytest.mark.parametrize("program", ["pascal_1d", "shapenet_3d"])
def test_covering_orders_put_each_pointwise_op_after_each_moving_op(program):
    """The orders the card checks add: together each pointwise op of the
    program rides with each moving op and with the load, every gate on;
    the identity order comes first."""
    orders = kda.covering_orders(program)
    assert orders[0] == 0 and len(set(orders)) == len(orders)
    pointwise = [op for op in _ops(program) if op not in kda.MOVING]
    seen = {(m, p) for o in orders for m, pw in kda.engine_passes(program, o)
            for p in pw}
    assert seen == set(itertools.product(kda.MOVING + ("load",), pointwise))


def test_engine_refuses_a_program_it_does_not_run():
    with pytest.raises(ValueError):
        kda.op_sequence("distractor", 0)


# every path's K6 call: (program, H, W, dtype, images) and the waves it takes
PATHS = {
    "P1 pascal_1d f32": ("pascal_1d", 128, 128, torch.float32, 150, 2),
    "P1 fixed pascal_1d_fixed f32": ("pascal_1d_fixed", 128, 128,
                                     torch.float32, 150, 2),
    "pascal_1d bf16 (no path)": ("pascal_1d", 128, 128, BF16, 150, 1),
    "S1 shapenet_3d f32": ("shapenet_3d", 64, 64, torch.float32, 300, 2),
    "S3 shapenet_3d_fixed f32": ("shapenet_3d_fixed", 64, 64, torch.float32,
                                 300, 2),
    "S5 S6 shapenet_3d bf16": ("shapenet_3d", 64, 64, BF16, 300, 1),
    "ANP shapenet_1d f32": ("shapenet_1d", 128, 128, torch.float32, 150, 1),
    "P3 T40 shapenet_1d_fixed bf16": ("shapenet_1d_fixed", 128, 128, BF16,
                                      600, 3),
    "D1 distractor f32": ("distractor", 128, 128, torch.float32, 360, 2),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_path_shape_fits_a_block_and_takes_its_waves(path):
    """A block fits the 232,448 bytes a block may take; the SM holds at
    least the blocks the launch bounds cap the registers for; the images
    take the waves written beside the path (Pascal1D's float32 block is
    alone on its SM, so 150 images take two; ShapeNet3D's bfloat16 blocks,
    three an SM, take S5's and S6's 300 in one)."""
    program, h, w, dtype, images, waves = PATHS[path]
    g = kda.launch_geometry(program, h, w, dtype, images)
    assert g["smem"] <= kda.MAX_SMEM == 232448
    assert g["blocks_per_sm"] >= g["min_blocks"] >= 1
    assert g["threads"] * g["blocks_per_sm"] <= kda.SM_THREADS
    assert g["waves"] == waves


def test_geometry_follows_the_layout():
    """Pascal1D's float32 block holds the uint8 image and two float32
    images; bfloat16 halves the two; the RGB block holds two three-plane
    images and no uint8 one."""
    f32 = kda.smem_bytes("pascal_1d", 128, 128)
    bf16 = kda.smem_bytes("pascal_1d", 128, 128, BF16)
    assert f32 - bf16 == 2 * 2 * 128 * 128
    assert f32 > 16384 + 2 * 4 * 128 * 128
    rgb = kda.smem_bytes("shapenet_3d", 64, 64)
    assert rgb - kda.smem_bytes("shapenet_3d", 64, 64, BF16) == (
        2 * 2 * 3 * 64 * 64)
    assert kda.smem_bytes("shapenet_1d", 128, 128) == kda.smem_bytes(
        "shapenet_1d", 128, 128, BF16)
    assert kda.launch_geometry("shapenet_3d", 64, 64, BF16)["threads"] == 512
