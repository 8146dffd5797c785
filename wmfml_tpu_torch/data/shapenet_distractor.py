"""Distractor episodic sampler (2-D object localisation, 128x128x1), host
side (``wmfml_tpu/data/shapenet_distractor.py``).

Loads the per-category ``{categ}_multi.npy`` object lists (36 views an
object, each ``(image float [0, 1], _, view index, centre)``) and stores
the images x 255 as uint8, the centres as float32 pixel labels. Sampling
follows the JAX package draw for draw, from one ``RandomState`` a split:

  * the train categories' objects are shuffled once (``RandomState(seed)``)
    and cut 80/20 into train and validation; test is the 2 held-out
    categories (or ``test_categ``);
  * ``mode="eval"`` (``load_test_categ_only``) reads only the test
    categories, so validation comes from their 80/20 cut, and the queries
    are all 36 views of the object's permutation, from ``perm[0]`` on (the
    context views among them);
  * train shot ~ U[1, max]; an episode draws the object, then a
    permutation of its 36 views (first ``shot`` = context, the next
    ``query`` = queries);
  * the test split re-permutes its objects and resets its counter on every
    call (the reference's quirk), and walks that permutation;
  * labels stay raw pixel centres; the episode processor inverts the
    images and adds task augmentation's shift (``aug/pipeline.py``).

The image rows of an episode, padded to ``max_ctx``, are gathered by the
native episode core (``data/episode_core.py:NativeEpisodes``: ``get_batch``,
and ``draw_batch`` with the rows not gathered yet), as the JAX package
gathers them (``_native.assemble_episode``); the centres are numpy
indexing.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from wmfml_tpu_torch.data.basedata import BaseData
from wmfml_tpu_torch.data.episode_core import NativeEpisodes
from wmfml_tpu_torch.data.synthetic import (DISTRACTOR_TEST_CATEGS,
                                            DISTRACTOR_TRAIN_CATEGS)


class ShapeNetDistractor(NativeEpisodes, BaseData):
    raw_label_dim = 2
    task_name = "distractor"
    LABELS = "centers"

    def __init__(self, path: str, img_size, seed: int,
                 num_instances_per_item: int = 36,
                 train_fraction: float = 0.8, val_fraction: float = 0.2,
                 aug: Optional[List[str]] = None, mode: str = "train",
                 load_test_categ_only: bool = False,
                 test_categ: Optional[List[str]] = None,
                 max_ctx: int = 15, query_num: Optional[int] = None):
        super().__init__(img_size, aug)
        self.mode = mode
        self.instances_per_item = num_instances_per_item
        self.max_ctx = max_ctx
        self.query_num = (num_instances_per_item if mode == "eval"
                          else (query_num or 18))

        def load(categs):
            parts = [np.load(os.path.join(path, f"{c}_multi.npy"),
                             allow_pickle=True) for c in categs]
            return np.concatenate(parts, axis=0) if parts else None

        data_test = load(test_categ or DISTRACTOR_TEST_CATEGS)
        data_train = (data_test if load_test_categ_only
                      else load(DISTRACTOR_TRAIN_CATEGS))
        data_train = data_train[
            np.random.RandomState(seed).permutation(data_train.shape[0])]
        n_train = int(train_fraction * data_train.shape[0])
        n_val = int(val_fraction * data_train.shape[0])
        self.splits = {
            "train": self._extract(data_train[:n_train]),
            "validation": self._extract(data_train[n_train:n_train + n_val]),
            "test": self._extract(data_test),
        }
        self.rngs = {k: np.random.RandomState(seed) for k in self.splits}
        self.test_counter = 0

    def _extract(self, data):
        v = self.instances_per_item
        images = np.zeros((data.shape[0], v, *self.img_size), np.uint8)
        centers = np.zeros((data.shape[0], v, 2), np.float32)
        for i, item in enumerate(data):
            if len(item) != v:
                raise ValueError(f"distractor item {i}: expected {v} "
                                 f"instances, got {len(item)}")
            for m, inst in enumerate(item):
                img = np.asarray(inst[0], np.float32).reshape(self.img_size)
                images[i, m] = (img * 255).astype(np.uint8)
                centers[i, m] = np.asarray(inst[3], np.float32)
        return dict(images=images, centers=centers, n_items=data.shape[0])

    @property
    def x_train(self):
        return self.splits["train"]["images"]

    @property
    def y_train(self):
        return self.splits["train"]["centers"]

    def reset_eval(self, source: str, seed: int = 42):
        if source in ("validation", "test"):
            self.rngs[source] = np.random.RandomState(seed)
        if source == "test":
            self.test_counter = 0

    def _draw(self, source: str, tasks_per_batch: int, shot: int):
        """(objects [T], view permutations [T, 36], shot): the one draw
        that consumes the split's stream."""
        if source not in self.splits:
            raise TypeError("no valid dataset type split!")
        n_items, rng = self.splits[source]["n_items"], self.rngs[source]
        if source == "train":
            shot = int(rng.randint(1, shot + 1))
        if source == "test":        # the reference's quirk, every call
            perm_items = rng.permutation(n_items)
            self.test_counter = 0
        items = np.empty(tasks_per_batch, np.int64)
        perm = np.empty((tasks_per_batch, self.instances_per_item), np.int64)
        for t in range(tasks_per_batch):
            if source == "test":
                if self.test_counter >= n_items:
                    self.test_counter = 0
                items[t] = perm_items[self.test_counter]
                self.test_counter += 1
            else:
                items[t] = rng.randint(n_items)
            perm[t] = rng.permutation(self.instances_per_item)
        return items, perm, shot

    def get_batch_indices(self, source: str, tasks_per_batch: int, shot: int):
        """Index-only episode draw: (objects [T], views [T, shot+query],
        shot), consuming the split's stream exactly as ``get_batch`` does."""
        items, perm, shot = self._draw(source, tasks_per_batch, shot)
        return items, perm[:, :shot + self.query_num], shot
