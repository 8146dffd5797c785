"""Statistical evaluator and single-task refinement
(``wmfml_tpu/eval/evaluator.py:ModelEvaluator``).

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

A Bayes-by-Backprop (MR) model samples its weights at evaluation too, as
in the reference: the sweep is stochastic, but its draws come from a
generator on the device reseeded with ``seed + 20_000_000`` before every
point (the JAX evaluator's ``fold_in(base_key, 20_000_000 + v)``), so two
sweeps of one checkpoint give the same numbers.

The model is restored from ``config.checkpoint`` (a port checkpoint or a
bare reference ``state_dict``) when it names one.

With ``device_data`` auto or true (the default) and a split that
``data/device_eval.py:split_from_dataset`` takes, a split's whole sweep
runs on the device (``_device_sweep``, the JAX evaluator's,
``wmfml_tpu/eval/evaluator.py:70-126``): the host draws every point's
indices from the stream reset to RandomState 42 before the point, pads the
context indices to ``max_ctx_num`` by repeating the last real one and
masks the padding, takes all the views as queries on eval-mode data
(``query_all``), and one ``DeviceSweep`` of ``max_ctx_num x val_iters``
batches scores them, reseeding the generator before each point as the
host sweep does (CUDA graph replays on the card unless ``sweep_graphs``
is False); means and stds (ddof 1) are taken as the host path takes them,
and the log says "sweep ran device-resident". Otherwise, and for a sampler
without ``get_batch_indices`` (``RefinementSampler``), episodes go to the
card one by one.

``evaluate_one_task()`` is the sweep over the test split alone, written to
``test_losses.txt`` (over a ``data/refinement.py:RefinementSampler``: one
frozen task, the same batch at every point, so a flat curve, as in JAX).

``refine()`` (``mode: refinement``) fine-tunes the model on
``refine_train`` batches of a ``RefinementSampler`` (``:178-245``; JAX's
ShapeNet3D ``gen_bg`` there calls the sampler's no-op, so none is made
here): iterations ``0..iterations``, one eager refine step each
(``train/steps.py:build_refine_step``: one host batch, DA on both image
sets, the loss against the context labels), and after the step, whenever ``it % val_freq == 0``, a validation and a test
sweep of ``max_ctx_num`` context rows; a new best test loss saves
``models/best_test_model.pt`` and appends to ``best_test_error.txt``, and
``models/model_end_{iterations}.pt`` is saved at the end. In that mode
the evaluator builds the optimizer from the config (``lr`` of the
refinement YAML) before it restores the checkpoint, once; a port
checkpoint restores Adam's moments and step counts with the weights, as a
JAX checkpoint restores its ``TrainState``, and a bare ``state_dict``
starts Adam fresh. The step's draws (DA, TA, BBB) come from a generator
seeded with ``seed`` when the evaluator is built, so every evaluator draws
the same stream, as every JAX evaluator keys iteration ``it`` with
``fold_in(PRNGKey(seed), it)``. An evaluator's model is refined in place:
a new evaluator needs a model built or restored anew
(``cli/refinement_cli.py`` builds one per context count).

Unlike the JAX evaluator, which builds its optimizer even to evaluate (so
``cfg/evaluation/eval_and_plot/CNP_max_Distractor.yaml``, ``optimizer:
''``, raises there), this one builds it only to refine.

MMAML has no evaluator: the JAX evaluator builds ``build_eval_step``
(``wmfml_tpu/eval/evaluator.py:65``), which has no MMAML form, and no
evaluation YAML names MMAML, so an MMAML method raises here (its
validation runs in ``train/mmaml.py:MMAMLTrainer``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from wmfml_tpu_torch.ckpt.checkpoint import CheckpointManager
from wmfml_tpu_torch.cli.common import set_numerics
from wmfml_tpu_torch.configs.config import device_data_on
from wmfml_tpu_torch.data.device_eval import (build_device_eval_ctx_sweep,
                                              split_from_dataset)
from wmfml_tpu_torch.models.registry import method_family
from wmfml_tpu_torch.obs.guards import check_finite
from wmfml_tpu_torch.obs.metrics import MetricsWriter
from wmfml_tpu_torch.train.maml import build_maml_eval_step
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import (build_eval_step, build_refine_step,
                                         require_device)
from wmfml_tpu_torch.parallel import mesh
from wmfml_tpu_torch.train.trainer import episode_to_device


class ModelEvaluator:
    def __init__(self, model, config, data):
        family = method_family(config.method)
        if family == "mmaml":
            raise NotImplementedError(
                f"method {config.method!r}: MMAML has no evaluator, in the "
                "JAX package either (no MMAML form of build_eval_step); its "
                "validation runs in the trainer")
        self.config = config
        self.data = data
        self.logger = config.logger
        self.device = require_device(config.device)
        set_numerics()
        self.model = model.to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.refine_generator = torch.Generator(device=self.device)
        self.refine_generator.manual_seed(int(config.seed))
        ctx = mesh.current()
        self.lead = ctx is None or ctx.lead     # rank 0 writes the files
        self.ckpt = CheckpointManager(config.save_path)
        self.writer = MetricsWriter(config.save_path) if self.lead else None
        self.best_loss = {"validation": 10000.0, "test": 10000.0}
        self.optimizer = self.refine_step = None
        if config.mode == "refinement":
            self.optimizer = build_optimizer(config, self.model.parameters())
            self.refine_step = build_refine_step(self.model, self.optimizer,
                                                 config)
        self.step = 0
        if config.checkpoint:  # with Adam's moments and counts, where it has them
            self.step = self.ckpt.restore(config.checkpoint, self.model,
                                          self.optimizer,
                                          map_location=self.device)
            self.logger.info(f"loaded checkpoint {config.checkpoint}")
        if family == "maml":
            self.eval_step = build_maml_eval_step(self.model, config)
        else:
            self.eval_step = build_eval_step(self.model, config)
        self.sweeps = {}             # source -> DeviceSweep, or None
        self.sweep_graphs = True

    def _device_sweep(self, source: str):
        """(means, stds) over ctx 1..max_ctx_num of ``source`` from one
        device sweep, or None where the split stays on the host."""
        cfg = self.config
        if not device_data_on(cfg) or not hasattr(self.data,
                                                  "get_batch_indices"):
            return None
        eval_mode = getattr(self.data, "mode", None) == "eval"
        if source not in self.sweeps:
            split = split_from_dataset(self.data, cfg, source, self.device,
                                       query_all=eval_mode)
            self.sweeps[source] = None if split is None else \
                build_device_eval_ctx_sweep(self.eval_step, split,
                                            self.generator,
                                            graph=self.sweep_graphs)
        sweep = self.sweeps[source]
        if sweep is None:
            return None
        s, q, vi = cfg.max_ctx_num, cfg.query_num, cfg.val_iters
        cls, ctx, shots, qry = [], [], [], []
        for ctx_num in range(1, s + 1):
            self.data.reset_eval(source, seed=42)
            for _ in range(vi):
                groups, take, shot = self.data.get_batch_indices(
                    source, cfg.tasks_per_batch, ctx_num)
                assert shot == ctx_num, "eval shot must equal the ctx point"
                cls.append(groups)
                ctx.append(np.pad(take[:, :shot], ((0, 0), (0, s - shot)),
                                  mode="edge"))
                shots.append(shot)
                qry.append(take if eval_mode else take[:, shot:shot + q])
        seeds = ([int(cfg.seed) + 20_000_000] + [None] * (vi - 1)) * s
        losses = sweep(np.stack(cls), np.stack(ctx), np.stack(qry), seeds,
                       shots=np.asarray(shots))
        per_ctx = losses.cpu().numpy().astype(np.float64).reshape(s, vi)
        means = [float(m) for m in per_ctx.mean(axis=1)]
        stds = [float(r.std(ddof=1)) if vi > 1 else 0.0 for r in per_ctx]
        for m, r in zip(means, stds):
            self.logger.info(f"{source} loss: {m:.4f}\n{source} std: {r:.4f}")
        return means, stds

    def _validate_iter(self, source: str, ctx_num: int):
        """Mean and std (ddof 1) of the loss over ``val_iters`` episodes
        with ``ctx_num`` context rows, from the reseeded stream."""
        cfg = self.config
        self.data.reset_eval(source, seed=42)
        self.generator.manual_seed(int(cfg.seed) + 20_000_000)
        losses = [self.eval_step(episode_to_device(
            self.data.get_batch(source, cfg.tasks_per_batch, ctx_num),
            self.device), self.generator) for _ in range(cfg.val_iters)]
        losses = np.asarray([float(x) for x in losses], np.float64)
        loss = float(losses.mean())
        std = float(losses.std(ddof=1)) if len(losses) > 1 else 0.0
        self.logger.info(f"{source} loss: {loss:.4f}\n{source} std: {std:.4f}")
        return loss, std

    def _sweep_source(self, source: str):
        """(losses, stds) over ctx 1..max_ctx_num: the device sweep, else
        the host's."""
        dev = self._device_sweep(source)
        if dev is not None:
            self.logger.info(f"[{source}] sweep ran device-resident (one "
                             f"index upload, one read)")
            return dev
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
        if not self.lead:
            return val_losses, test_losses
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

    def evaluate_one_task(self):
        """The test split's sweep alone -> ``test_losses.txt``."""
        cfg = self.config
        test_losses, test_std = self._sweep_source("test")
        index = list(range(1, cfg.max_ctx_num + 1))
        np.savetxt(f"{cfg.save_path}/test_losses.txt",
                   np.column_stack((index, test_losses, test_std)),
                   fmt="%1.4f")
        self.ckpt.save("model", self.step, self.model)
        self._plot_loss_vs_ctx(index, None, None, test_losses, test_std)
        return test_losses

    def refine(self):
        """(best test loss, its iteration) of single-task refinement."""
        cfg = self.config
        if self.refine_step is None:
            raise ValueError(f"refine() needs mode: refinement, not "
                             f"{cfg.mode!r}")
        best_step = -1
        for it in range(cfg.iterations + 1):
            batch = episode_to_device(self.data.get_batch(
                "refine_train", cfg.tasks_per_batch, cfg.max_ctx_num),
                self.device)
            loss = self.refine_step(batch, self.refine_generator)
            self.step += 1
            if it % cfg.val_freq == 0:
                self.writer.add_scalar("Loss/train",
                                       check_finite(loss, it, self.logger), it)
                self._validate_iter("validation", cfg.max_ctx_num)
                if cfg.task != "pascal_1d":
                    test_loss, std = self._validate_iter("test",
                                                         cfg.max_ctx_num)
                    if test_loss < self.best_loss["test"]:
                        self.best_loss["test"] = test_loss
                        best_step = it
                        self._save_refined("best_test_model")
                        with open(os.path.join(cfg.save_path,
                                               "best_test_error.txt"),
                                  "a") as f:
                            f.write(f"Best Step: {it} \n")
                            f.write(f"Best test Loss: \n{test_loss}\n")
                            f.write(f"Best test Loss std: \n{std}\n")
        self._save_refined(f"model_end_{cfg.iterations}")
        return self.best_loss["test"], best_step

    def _save_refined(self, name: str):
        self.ckpt.save(name, self.step, self.model, self.optimizer,
                       self.refine_generator)

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

        if val_losses is not None:
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
