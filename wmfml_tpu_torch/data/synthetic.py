"""Procedural synthetic ShapeNet1D and Pascal1D in the reference's on-disk
formats.

The real data ships as git-LFS pointers, so training without it runs on a
generated dataset:

  * ShapeNet1D: ``train_data_{small,middle,large}.pkl``, ``val_data.pkl``
    and ``test_data.pkl``;
  * Pascal1D: ``train_data_ins.pkl`` (40 classes) and ``val_data_ins.pkl``
    (10 classes); it has no test split.

Each file is ``(x [C, I, 128, 128, 1] uint8, y [C, I, 1])`` with the angle
in [0, 1). Each class is a union of soft ellipses rendered analytically in
rotated coordinates, so every angle is exact.

With the same seed the files are byte-identical to the JAX package's
(``wmfml_tpu/data/synthetic.py``): the same numpy ``RandomState`` draws in
the same order and the same float32 rendering. The other tasks' generators
are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np


def _render_blob_2d(size: int, centers, axes, intensities, angle_rad: float,
                    sharp: float = 1.5) -> np.ndarray:
    """Union of soft ellipses rotated by ``angle_rad``; float [0, 1]."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = cy = (size - 1) / 2.0
    x = xs - cx
    y = ys - cy
    c, s = np.cos(-angle_rad), np.sin(-angle_rad)
    xr = c * x - s * y
    yr = s * x + c * y
    img = np.zeros((size, size), np.float32)
    for (ex, ey), (ax_, ay_), inten in zip(centers, axes, intensities):
        d = ((xr - ex) / ax_) ** 2 + ((yr - ey) / ay_) ** 2
        img = np.maximum(img, inten * np.clip(sharp * (1.0 - d), 0.0, 1.0))
    return img


def _random_shape_params(rng: np.random.RandomState, num_ellipses: int,
                         radius: float, ax_range: Tuple[float, float]):
    centers = rng.uniform(-radius, radius, size=(num_ellipses, 2))
    # one ellipse off-centre so the azimuth has no pi symmetry
    centers[0] = [radius * 0.9, 0.0]
    axes = rng.uniform(*ax_range, size=(num_ellipses, 2))
    intensities = rng.uniform(0.55, 1.0, size=num_ellipses)
    return centers, axes, intensities


SHAPENET1D_CLASS_COUNTS = {"small": 12, "middle": 30, "large": 60}


def generate_shapenet1d(root: str, seed: int = 0, instances: int = 50,
                        val_classes: int = 15, test_classes: int = 15):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)

    def make_split(n_classes: int):
        xs = np.zeros((n_classes, instances, 128, 128, 1), np.uint8)
        ys = np.zeros((n_classes, instances, 1), np.float32)
        for c in range(n_classes):
            params = _random_shape_params(rng, 5, 38.0, (6.0, 24.0))
            angles = rng.uniform(0.0, 1.0, size=instances)
            for i, a in enumerate(angles):
                img = _render_blob_2d(128, *params, angle_rad=a * 2 * np.pi)
                xs[c, i, :, :, 0] = (img * 255).astype(np.uint8)
                ys[c, i, 0] = a
        return xs, ys

    x_all, y_all = make_split(SHAPENET1D_CLASS_COUNTS["large"])
    for size, n in SHAPENET1D_CLASS_COUNTS.items():
        with open(os.path.join(root, f"train_data_{size}.pkl"), "wb") as f:
            pickle.dump((x_all[:n], y_all[:n]), f)
    for name, n in [("val_data.pkl", val_classes), ("test_data.pkl", test_classes)]:
        x, y = make_split(n)
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump((x, y), f)


def generate_pascal1d(root: str, seed: int = 5, train_classes: int = 40,
                      val_classes: int = 10, instances: int = 50):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)

    def make_split(n_classes: int):
        xs = np.zeros((n_classes, instances, 128, 128, 1), np.uint8)
        ys = np.zeros((n_classes, instances, 1), np.float32)
        for c in range(n_classes):
            params = _random_shape_params(rng, 4, 34.0, (5.0, 20.0))
            angles = rng.uniform(0.0, 1.0, size=instances)
            for i, a in enumerate(angles):
                img = _render_blob_2d(128, *params, angle_rad=a * 2 * np.pi)
                xs[c, i, :, :, 0] = (img * 255).astype(np.uint8)
                ys[c, i, 0] = a
        return xs, ys

    for name, n in [("train_data_ins.pkl", train_classes),
                    ("val_data_ins.pkl", val_classes)]:
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(make_split(n), f)


GENERATORS = {"shapenet_1d": ("ShapeNet1D", generate_shapenet1d),
              "pascal_1d": ("Pascal1D", generate_pascal1d)}


def ensure_dataset(task: str, data_root: str = "data_synth") -> str:
    """Generate the synthetic dataset for ``task`` if missing; return its dir."""
    if task not in GENERATORS:
        raise NotImplementedError(
            f"synthetic {task!r} data is not ported yet (ROADMAP.md A12)")
    subdir, gen = GENERATORS[task]
    path = os.path.join(data_root, subdir)
    marker = os.path.join(path, ".complete")
    if not os.path.exists(marker):
        gen(path)
        with open(marker, "w") as f:
            f.write("ok")
    return path
