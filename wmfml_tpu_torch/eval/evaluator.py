"""Statistical evaluator (``wmfml_tpu/eval/evaluator.py:ModelEvaluator``).

``evaluate()`` sweeps the loss against the context count: for ctx in
1..``max_ctx_num`` it scores ``val_iters`` validation episodes (and test
episodes, except for pascal_1d), the split's stream reseeded to
RandomState 42 before each point, so every point and every run sees the
same episodes as the JAX package's host sweep (``_sweep_source`` /
``_validate_iter``, :128-154). With Distractor's eval-mode data
(``build_data(config, mode="eval")``) an episode's queries are all 36 views
of its object, the context views among them, and its loss is the mean pixel
distance; with ShapeNet3D's they are all 30 views of the item, the loss the
quaternion L1, and the backgrounds are the pickles' (the JAX evaluator
recomposites only in ``refine``). It writes ``val_losses.txt`` and
``test_losses.txt`` (index, mean loss, std over the episodes with
ddof = 1, ``%1.4f``), saves the model as ``models/model.pt`` and draws
``loss_vs_ctx_num.png`` where matplotlib is installed (where it is not, it
logs that no plot was written; the numbers are in the text files).

The model is restored from ``config.checkpoint`` (a port checkpoint or a
bare reference ``state_dict``) when it names one. Episodes go to the
card one by one; the JAX package's one-dispatch device sweep
(``data/device_eval.py``) is not ported.
"""

from __future__ import annotations

import numpy as np

from wmfml_tpu_torch.ckpt.checkpoint import CheckpointManager
from wmfml_tpu_torch.cli.common import set_numerics
from wmfml_tpu_torch.train.maml import build_maml_eval_step
from wmfml_tpu_torch.train.steps import build_eval_step, require_device
from wmfml_tpu_torch.train.trainer import episode_to_device


class ModelEvaluator:
    def __init__(self, model, config, data):
        self.config = config
        self.data = data
        self.logger = config.logger
        self.device = require_device(config.device)
        set_numerics()
        self.model = model.to(self.device)
        self.ckpt = CheckpointManager(config.save_path)
        self.step = 0
        if config.checkpoint:
            self.step = self.ckpt.restore(config.checkpoint, self.model,
                                          map_location=self.device)
            self.logger.info(f"loaded checkpoint {config.checkpoint}")
        if "MAML" in config.method:
            self.eval_step = build_maml_eval_step(self.model, config)
        else:
            self.eval_step = build_eval_step(self.model, config)

    def _validate_iter(self, source: str, ctx_num: int):
        """Mean and std (ddof 1) of the loss over ``val_iters`` episodes
        with ``ctx_num`` context rows, from the reseeded stream."""
        cfg = self.config
        self.data.reset_eval(source, seed=42)
        losses = [self.eval_step(episode_to_device(
            self.data.get_batch(source, cfg.tasks_per_batch, ctx_num),
            self.device)) for _ in range(cfg.val_iters)]
        losses = np.asarray([float(x) for x in losses], np.float64)
        loss = float(losses.mean())
        std = float(losses.std(ddof=1)) if len(losses) > 1 else 0.0
        self.logger.info(f"{source} loss: {loss:.4f}\n{source} std: {std:.4f}")
        return loss, std

    def _sweep_source(self, source: str):
        points = [self._validate_iter(source, n)
                  for n in range(1, self.config.max_ctx_num + 1)]
        return [p[0] for p in points], [p[1] for p in points]

    def evaluate(self):
        cfg = self.config
        self.logger.info("================== Start Evaluation ===================")
        val_losses, val_std = self._sweep_source("validation")
        test_losses, test_std = [], []
        if cfg.task != "pascal_1d":
            test_losses, test_std = self._sweep_source("test")

        index = list(range(1, cfg.max_ctx_num + 1))
        np.savetxt(f"{cfg.save_path}/val_losses.txt",
                   np.column_stack((index, val_losses, val_std)), fmt="%1.4f")
        if cfg.task != "pascal_1d":
            np.savetxt(f"{cfg.save_path}/test_losses.txt",
                       np.column_stack((index, test_losses, test_std)),
                       fmt="%1.4f")
        self.ckpt.save("model", self.step, self.model)
        self._plot_loss_vs_ctx(index, val_losses, val_std, test_losses,
                               test_std)
        self.logger.info("================= Evaluation finished =================")
        return val_losses, test_losses

    def _plot_loss_vs_ctx(self, index, val_losses, val_std, test_losses,
                          test_std):
        try:
            import matplotlib
        except ImportError:
            self.logger.info("matplotlib is not installed: no "
                             "loss_vs_ctx_num.png written")
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        v, s = np.asarray(val_losses), np.asarray(val_std)
        plt.plot(index, v, label="val")
        plt.fill_between(index, v - s, v + s, alpha=0.1)
        if test_losses:
            t, s = np.asarray(test_losses), np.asarray(test_std)
            plt.plot(index, t, label="test")
            plt.fill_between(index, t - s, t + s, alpha=0.1)
        plt.legend(loc="best")
        plt.xlabel("ctx_num")
        plt.ylabel("error(pixel)")
        plt.savefig(f"{self.config.save_path}/loss_vs_ctx_num.png")
        plt.clf()
