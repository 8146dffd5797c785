"""ShapeNet3D episodic sampler (quaternion pose from 64 x 64 RGBA), host
side (``wmfml_tpu/data/shapenet_3d.py``).

Loads the reference's pickles (``shapenet3d_azi180ele30_{train,val,test}
.pkl``: ``images`` [N, 64, 64, 4] float32 in [0, 1] with alpha 1 on the
background, ``item_indices`` [N], ``Q`` [N, 4] xyzw quaternions, 30 views
an item) into dense [items, 30, ...] tables (a stable argsort on the item
index), and ``bg_images.npy`` beside them or one directory up. Sampling
follows the JAX package draw for draw, one ``RandomState`` a split:

  * train: a random item, a random permutation of its views, shot ~ U[1,
    max]; the queries are ``query_num`` of the remaining views (the JAX
    package's fixed count where the reference takes all the rest: the same
    estimator at a static shape);
  * validation and test: the items in a fixed permutation of the split
    (drawn once), walked by a counter that wraps; ``reset_eval`` reseeds
    the split's stream to 42 and zeroes its counter;
  * ``mode="eval"``: the train split is not loaded, and the queries are
    all 30 views of the permutation, from its first (the context views
    among them).

``get_batch`` gathers an episode's image rows, padded to ``max_ctx``,
through the native episode core (``data/episode_core.py:NativeEpisodes``,
as the JAX package's ``_native.assemble_episode``); the labels are numpy
indexing. ``draw_batch`` is the same draw with the rows not gathered yet,
for the host path's trainer to gather into pinned memory.
``gen_bg(config, data)`` composites new random backgrounds into the splits
in place (all of them, or ``data="train"``) through the core's
``composite_backgrounds``, from a stream of its own, ``RandomState(seed +
7919)``, so it never moves the episode streams: a pixel with alpha < 1 is
foreground and keeps its colour, every other one takes background ``idx %
200``'s. A lock keeps a recomposite and a gather of the same split apart
(the JAX package's ``_bg_lock``). The device sampler composites every
training batch on the card instead (``data/device_sampler.py``).
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import List, Optional

import numpy as np

from wmfml_tpu_torch.data.basedata import BaseData
from wmfml_tpu_torch.data.episode_core import (NativeEpisodes,
                                               composite_backgrounds)


class ShapeNet3DData(NativeEpisodes, BaseData):
    raw_label_dim = 4
    task_name = "shapenet_3d"

    def __init__(self, path: str, img_size, seed: int,
                 num_instances_per_item: int = 30,
                 aug: Optional[List[str]] = None, mode: str = "train",
                 max_ctx: int = 15, query_num: Optional[int] = None):
        super().__init__(img_size, aug)
        self.mode = mode
        self.instances_per_item = num_instances_per_item
        self.max_ctx = max_ctx
        self.query_num = (num_instances_per_item if mode == "eval"
                          else (query_num or 15))
        self.azimuth_only = "azimuth_only" in self.aug_list
        bg_path = os.path.join(path, "bg_images.npy")
        if not os.path.exists(bg_path):
            bg_path = os.path.join(os.path.dirname(path.rstrip("/")),
                                   "bg_images.npy")
        self.bg_imgs = np.load(bg_path).astype(np.float32)
        self._bg_lock = threading.Lock()

        names = [("validation", "val"), ("test", "test")]
        if mode != "eval":
            names.insert(0, ("train", "train"))
        self.splits = {}
        for split, name in names:
            with open(os.path.join(
                    path, f"shapenet3d_azi180ele30_{name}.pkl"), "rb") as f:
                d = pickle.load(f)
            images = np.ascontiguousarray(d["images"], dtype=np.float32)
            item_indices = np.asarray(d["item_indices"])
            q = np.asarray(d["Q"], np.float32)
            n_items = int(item_indices.max()) + 1
            v = num_instances_per_item
            if images.shape[0] != n_items * v:
                raise ValueError(f"{split} split: expected {n_items} items x "
                                 f"{v} views, got {images.shape[0]} "
                                 "instances")
            order = np.argsort(item_indices, kind="stable")
            self.splits[split] = dict(
                images=images[order].reshape(n_items, v, *images.shape[1:]),
                Q=q[order].reshape(n_items, v, 4), n_items=n_items)

        self.rngs = {k: np.random.RandomState(seed)
                     for k in ("train", "validation", "test")}
        self.bg_rng = np.random.RandomState(seed + 7919)
        self.counters = {"validation": 0, "test": 0}
        self.perms = {k: self.rngs[k].permutation(self.splits[k]["n_items"])
                      for k in ("validation", "test")}

    @property
    def x_train(self):
        return self.splits["train"]["images"]

    @property
    def y_train(self):
        return self.splits["train"]["Q"]

    def reset_eval(self, source: str, seed: int = 42):
        if source in self.counters:
            self.rngs[source] = np.random.RandomState(seed)
            self.counters[source] = 0

    def _draw(self, source: str, tasks_per_batch: int, shot: int):
        """(items [T], view permutations [T, 30], shot): the one draw that
        consumes the split's stream."""
        n_items, rng = self.splits[source]["n_items"], self.rngs[source]
        if source == "train":
            shot = int(rng.randint(1, shot + 1))
        v = self.instances_per_item
        items = np.empty(tasks_per_batch, np.int64)
        perm = np.empty((tasks_per_batch, v), np.int64)
        for t in range(tasks_per_batch):
            if source == "train":
                items[t] = rng.randint(n_items)
            else:
                if self.counters[source] >= n_items:
                    self.counters[source] = 0
                items[t] = self.perms[source][self.counters[source]]
                self.counters[source] += 1
            perm[t] = rng.permutation(v)
        return items, perm, shot

    def get_batch_indices(self, source: str, tasks_per_batch: int, shot: int):
        """Index-only episode draw, consuming the stream as ``get_batch``."""
        items, perm, shot = self._draw(source, tasks_per_batch, shot)
        return items, perm[:, :shot + self.query_num], shot

    def _composite_split(self, name: str, rng: np.random.RandomState):
        images = self.splits[name]["images"]
        flat = images.reshape(-1, *images.shape[2:])
        idx = rng.randint(0, self.bg_imgs.shape[0], size=flat.shape[0])
        with self._bg_lock:
            composite_backgrounds(flat, self.bg_imgs, idx)

    def gen_bg(self, config, data: str = "all"):
        """New backgrounds for every split (``data="all"``) or the train
        split's, from ``bg_rng``."""
        if data == "all":
            config.logger.info("=========== Generate BG for all data ============")
            names = list(self.splits)
        elif data == "train":
            config.logger.info("====== Regenerate BG for Training Data ======")
            names = ["train"]
        else:
            raise TypeError("Wrong data type for generating random "
                            "background, check gen_bg(data=**)!")
        for name in names:
            self._composite_split(name, self.bg_rng)
