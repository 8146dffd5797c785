"""The refinement sampler (``wmfml_tpu/data/refinement.py``): one held-out
task, frozen, for single-task refinement and single-task evaluation.

``RefinementSampler(base, ctx_num, seed, source)`` reseeds ``base``'s
``source`` stream (``reset_eval(source, seed)``) and keeps the first task
of one episode of ``ctx_num`` context rows: its context set (the real rows)
and its query set. Then, with its own ``RandomState(seed)``, as in the JAX
package, so every index equals JAX's:

  * ``get_batch("refine_train", T, shot)``: T resamples, with replacement,
    of the frozen context set, each as many rows as the set; the queries
    are the same images and labels (refinement predicts the context labels
    from the context images alone);
  * any other source: the frozen task tiled T times, context and queries.

``shot`` is ignored, as in the JAX package: single-task evaluation scores
the same batch, with ``ctx_num`` context rows, at every context count, so
its curve is flat. ``reset_eval`` and ``gen_bg`` do nothing (the frozen
task is the evaluation stream; no background is recomposited).
"""

from __future__ import annotations

import numpy as np

from wmfml_tpu_torch.data.basedata import BaseData
from wmfml_tpu_torch.data.episode import EpisodeBatch


class RefinementSampler(BaseData):
    def __init__(self, base: BaseData, ctx_num: int, seed: int = 42,
                 source: str = "test"):
        super().__init__(base.img_size, [])
        self.base = base
        self.ctx_num = ctx_num
        self.rng = np.random.RandomState(seed)
        self.raw_label_dim = base.raw_label_dim
        self.task_name = base.task_name

        base.reset_eval(source, seed)
        ep = base.get_batch(source, 1, ctx_num)
        n = int(ep["ctx_mask"][0].sum())
        self.task_ctx_x = ep["ctx_x"][0, :n]
        self.task_ctx_y = ep["ctx_y"][0, :n]
        self.task_qry_x = ep["qry_x"][0]
        self.task_qry_y = ep["qry_y"][0]

    def reset_eval(self, source: str, seed: int = 42):
        """The frozen task is the evaluation stream: nothing to reseed."""

    def get_batch(self, source: str, tasks_per_batch: int,
                  shot: int) -> EpisodeBatch:
        n = self.task_ctx_x.shape[0]
        if source == "refine_train":
            idx = self.rng.randint(0, n, size=(tasks_per_batch, max(n, 1)))
            ctx_x, ctx_y = self.task_ctx_x[idx], self.task_ctx_y[idx]
            mask = np.ones((tasks_per_batch, ctx_x.shape[1]), bool)
            return dict(ctx_x=ctx_x, ctx_y=ctx_y, ctx_mask=mask,
                        qry_x=ctx_x.copy(), qry_y=ctx_y.copy())
        reps = (tasks_per_batch, *([1] * self.task_qry_x.ndim))
        ctx_x = np.tile(self.task_ctx_x[None], reps)
        ctx_y = np.tile(self.task_ctx_y[None], (tasks_per_batch, 1, 1))
        mask = np.ones((tasks_per_batch, ctx_x.shape[1]), bool)
        qry_x = np.tile(self.task_qry_x[None], reps)
        qry_y = np.tile(self.task_qry_y[None], (tasks_per_batch, 1, 1))
        return dict(ctx_x=ctx_x, ctx_y=ctx_y, ctx_mask=mask,
                    qry_x=qry_x, qry_y=qry_y)

    def gen_bg(self, config, data: str = "all"):
        """No background is recomposited during refinement (as in JAX)."""
