"""Procedural synthetic ShapeNet1D, Pascal1D, Distractor and ShapeNet3D in
the reference's on-disk formats.

The real data ships as git-LFS pointers, so training without it runs on a
generated dataset:

  * ShapeNet1D: ``train_data_{small,middle,large}.pkl``, ``val_data.pkl``
    and ``test_data.pkl``;
  * Pascal1D: ``train_data_ins.pkl`` (40 classes) and ``val_data_ins.pkl``
    (10 classes); it has no test split;
  * Distractor: ``{categ}_multi.npy`` for the 10 train and 2 test ShapeNet
    category ids, each an object array of 6 objects x 36 views of
    ``(image [128, 128, 1] float32 in [0, 1], 0, view index, centre [2])``;
  * ShapeNet3D: ``bg_images.npy`` (200 smooth random RGB backgrounds of 64
    x 64) and ``shapenet3d_azi180ele30_{train,val,test}.pkl``, each a dict
    of ``images`` [N, 64, 64, 4] float32 RGBA (alpha 1 marks background,
    composited with a random background), ``item_indices`` [N] and ``Q``
    [N, 4], the xyzw pose quaternion with component 1 >= 0, 30 views an
    item at azimuth ~ U[0, 180) and elevation ~ U[0, 30) degrees.

The ShapeNet1D and Pascal1D files are ``(x [C, I, 128, 128, 1] uint8, y [C,
I, 1])`` with the angle in [0, 1). Each class is a union of soft ellipses
rendered analytically in rotated coordinates, so every angle is exact; a
Distractor view places the object's shape (turned by the view's angle) at
its labelled pixel centre and a second shape, the distractor, elsewhere.

With the same seed the files are byte-identical to the JAX package's
(``wmfml_tpu/data/synthetic.py``): the same numpy ``RandomState`` draws in
the same order and the same float32 rendering (ShapeNet3D's poses through
``scipy.spatial.transform.Rotation``, as there).
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation


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


# real ShapeNet category ids, so the reference's loader reads the files
DISTRACTOR_TRAIN_CATEGS = [
    "02691156", "02828884", "02933112", "02958343", "02992529",
    "03001627", "03211117", "03636649", "03691459", "04379243",
]
DISTRACTOR_TEST_CATEGS = ["04256520", "04530566"]


def generate_distractor(root: str, seed: int = 3, objects_per_categ: int = 6,
                        views: int = 36):
    """Per-category ``.npy`` object lists; view v of an object turns its
    shape by 2 pi v / views and draws its centre (the label, pixels) and
    the distractor's centre ~ U[24, 104)^2."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)

    def make_categ():
        objects = []
        for _ in range(objects_per_categ):
            params = _random_shape_params(rng, 3, 14.0, (4.0, 12.0))
            d_params = _random_shape_params(rng, 2, 10.0, (3.0, 9.0))
            instances = []
            for v in range(views):
                angle = v * 2 * np.pi / views
                center = rng.uniform(24, 104, size=2)      # (x, y)
                d_center = rng.uniform(24, 104, size=2)
                obj = _render_blob_2d(48, *params, angle_rad=angle)
                dis = _render_blob_2d(48, *d_params, angle_rad=-angle)
                canvas = np.zeros((128, 128), np.float32)
                for patch, (cx, cy) in [(obj, center), (dis, d_center)]:
                    x0, y0 = int(cx) - 24, int(cy) - 24
                    canvas[y0:y0 + 48, x0:x0 + 48] = np.maximum(
                        canvas[y0:y0 + 48, x0:x0 + 48], patch)
                instances.append((canvas[..., None].astype(np.float32), 0, v,
                                  center.astype(np.float32)))
            objects.append(instances)
        return np.asarray(objects, dtype=object)

    for categ in DISTRACTOR_TRAIN_CATEGS + DISTRACTOR_TEST_CATEGS:
        np.save(os.path.join(root, f"{categ}_multi.npy"), make_categ(),
                allow_pickle=True)


def generate_bg_images(path: str, n: int = 200, seed: int = 7):
    """``n`` smooth RGB backgrounds [n, 64, 64, 3] float32: 8 x 8 uniform
    noise upsampled x 8, box-blurred once."""
    rng = np.random.RandomState(seed)
    low = rng.uniform(0.0, 1.0, size=(n, 8, 8, 3)).astype(np.float32)
    bg = low.repeat(8, axis=1).repeat(8, axis=2)
    bg = (bg + np.roll(bg, 1, 1) + np.roll(bg, 1, 2) + np.roll(bg, -1, 1)) / 4.0
    np.save(path, bg.astype(np.float32))


def _render_pose_rgba(size: int, points3d, colors, sigmas,
                      rot: Rotation) -> np.ndarray:
    """3-D gaussian blobs turned by ``rot`` and projected, painted far to
    near; RGBA with alpha 1 on the background."""
    pts = rot.apply(points3d)
    order = np.argsort(pts[:, 2])
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    c = (size - 1) / 2.0
    scale = size / 4.0
    rgb = np.zeros((size, size, 3), np.float32)
    cover = np.zeros((size, size), np.float32)
    for k in order:
        px = c + pts[k, 0] * scale
        py = c - pts[k, 1] * scale
        g = np.exp(-(((xs - px) ** 2 + (ys - py) ** 2) / (2 * sigmas[k] ** 2)))
        m = (g > 0.35).astype(np.float32)
        rgb = rgb * (1 - m[..., None]) + colors[k][None, None, :] * m[..., None]
        cover = np.maximum(cover, m)
    alpha = 1.0 - cover
    return np.concatenate([rgb, alpha[..., None]], axis=-1).astype(np.float32)


def generate_shapenet3d(root: str, seed: int = 1, items_train: int = 240,
                        items_val: int = 40, items_test: int = 40,
                        views: int = 30, small: bool = False):
    """The three ShapeNet3D splits and their background bank; ``small``
    gives 30 / 8 / 8 items (loader-sized data; 30 training items
    meta-overfit)."""
    if small:
        items_train, items_val, items_test = 30, 8, 8
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    bg_path = os.path.join(root, "bg_images.npy")
    if not os.path.exists(bg_path):
        generate_bg_images(bg_path, seed=seed + 99)
    bg = np.load(bg_path)

    def make_split(n_items: int):
        images, item_indices, quats = [], [], []
        for item in range(n_items):
            k = rng.randint(4, 7)
            pts = rng.uniform(-1.0, 1.0, size=(k, 3))
            pts[0] = [1.2, 0.0, 0.0]            # no symmetry
            colors = rng.uniform(0.3, 1.0, size=(k, 3)).astype(np.float32)
            sigmas = rng.uniform(3.0, 7.0, size=k)
            for _ in range(views):
                azi = rng.uniform(0.0, 180.0)
                ele = rng.uniform(0.0, 30.0)
                rot = Rotation.from_euler("ZYX", [ele, 0.0, azi],
                                          degrees=True)
                img = _render_pose_rgba(64, pts, colors, sigmas, rot)
                b = bg[rng.randint(bg.shape[0])]
                mask = (img[..., 3] < 1.0)[..., None]
                img[..., :3] = img[..., :3] * mask + b * (1 - mask)
                q = rot.as_quat()
                if q[1] < 0:
                    q = -q
                images.append(img)
                item_indices.append(item)
                quats.append(q)
        return dict(images=np.asarray(images, np.float32),
                    item_indices=np.asarray(item_indices),
                    Q=np.asarray(quats, np.float32))

    for split, n in [("train", items_train), ("val", items_val),
                     ("test", items_test)]:
        with open(os.path.join(root, f"shapenet3d_azi180ele30_{split}.pkl"),
                  "wb") as f:
            pickle.dump(make_split(n), f)


GENERATORS = {"shapenet_1d": ("ShapeNet1D", generate_shapenet1d),
              "pascal_1d": ("Pascal1D", generate_pascal1d),
              "distractor": ("distractor", generate_distractor),
              "shapenet_3d": ("ShapeNet3D_azi180ele30", generate_shapenet3d)}


def ensure_dataset(task: str, data_root: str = "data_synth") -> str:
    """Generate the synthetic dataset for ``task`` if missing; return its dir."""
    if task not in GENERATORS:
        raise NotImplementedError(
            f"no synthetic {task!r} data: the tasks with data are "
            f"{sorted(GENERATORS)}")
    subdir, gen = GENERATORS[task]
    path = os.path.join(data_root, subdir)
    marker = os.path.join(path, ".complete")
    if not os.path.exists(marker):
        gen(path)
        with open(marker, "w") as f:
            f.write("ok")
    return path
