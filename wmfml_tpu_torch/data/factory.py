"""Dataset factory: config -> episodic sampler.

Data root: ``config.data_path`` if set, else ``./data/<subdir>`` (the
reference layout: ``ShapeNet1D``, ``Pascal1D``, ``distractor``,
``ShapeNet3D_azi180ele30``) when it holds the task's files, else a
generated synthetic dataset under ``./data_synth/<subdir>``.
``synthetic_data: true`` forces the synthetic set.
``shapenet_3d_segmentation`` has no loader (nor has the JAX package) and
raises.
"""

from __future__ import annotations

import os

from wmfml_tpu_torch.data.pascal_1d import Pascal1D
from wmfml_tpu_torch.data.shapenet_1d import ShapeNet1D
from wmfml_tpu_torch.data.shapenet_3d import ShapeNet3DData
from wmfml_tpu_torch.data.shapenet_distractor import ShapeNetDistractor
from wmfml_tpu_torch.data.synthetic import ensure_dataset

REFERENCE_SUBDIRS = {"shapenet_1d": "ShapeNet1D", "pascal_1d": "Pascal1D",
                     "distractor": "distractor",
                     "shapenet_3d": "ShapeNet3D_azi180ele30"}
_PROBE_FILES = {"shapenet_1d": "val_data.pkl",
                "pascal_1d": "train_data_ins.pkl",
                "distractor": "04530566_multi.npy",
                "shapenet_3d": "shapenet3d_azi180ele30_train.pkl"}


def resolve_data_path(config) -> str:
    if config.data_path:
        return config.data_path
    real = os.path.join("data", REFERENCE_SUBDIRS[config.task])
    if not config.synthetic_data and os.path.exists(
            os.path.join(real, _PROBE_FILES[config.task])):
        return real
    config.logger.info(
        f"real {config.task} data not found under {real}; using synthetic dataset")
    return ensure_dataset(config.task, "data_synth")


def build_data(config, mode: str = "train", test_categ=None):
    """Host sampler for ``config.task`` (seed 42, as in the JAX package).
    ``mode="eval"`` (the evaluation CLI) reaches Distractor and ShapeNet3D:
    their queries are then all the views of an item (36, 30), Distractor's
    validation split comes from its test categories and ShapeNet3D's train
    split is not loaded; ``test_categ`` (the test split's categories)
    reaches Distractor only."""
    if config.task not in REFERENCE_SUBDIRS:
        raise NotImplementedError(
            f"task {config.task!r} has no loader, in the JAX package "
            f"either; the tasks with one are {sorted(REFERENCE_SUBDIRS)}")
    common = dict(img_size=config.img_size, seed=42, aug=config.aug_list,
                  max_ctx=config.max_ctx_num, query_num=config.query_num)
    path = resolve_data_path(config)
    if config.task == "pascal_1d":
        return Pascal1D(path, **common)
    if config.task == "shapenet_3d":
        return ShapeNet3DData(path, num_instances_per_item=30, mode=mode,
                              **common)
    if config.task == "distractor":
        return ShapeNetDistractor(path, mode=mode,
                                  load_test_categ_only=mode == "eval",
                                  test_categ=test_categ, **common)
    return ShapeNet1D(path, data_size=config.data_size, **common)
