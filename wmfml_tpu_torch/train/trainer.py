"""Meta-training loop for the CNP/ANP family (``wmfml_tpu/train/trainer.py``);
``train/maml.py:MAMLTrainer`` runs the same loop with MAML steps
(``_build_steps``).

  * iteration loop; each pass of the loop is one call of the fused step
    (``train/steps.py:FusedSteps``): ``steps_per_call`` steps on episodes
    sampled on the device, one CUDA graph replay on the card, a loop on
    the CPU;
  * validation when ``it % val_freq < K`` on the validation AND test splits
    (test skipped for pascal_1d), on host episodes from streams reset to
    RandomState 42 before every sweep;
  * best-per-split checkpoints + ``best_{split}_error.txt``, an intermediate
    checkpoint when ``it % 1000 < K`` and a final one at the end;
  * NaN guard: the loss (a clone of the call's mean loss: the next replay
    overwrites the graph's outputs) stays on the device and is read at the
    validation cadence; a non-finite loss raises ``NonFiniteLossError``;
  * one random generator on the device draws every episode, DA, TA and
    Bayes-by-Backprop (MR) draw of training; checkpoints hold its state,
    so a run resumed from one draws what an unbroken run would have drawn;
    validation's BBB draws come from a second generator, reseeded with
    ``seed + 10_000_000`` before every sweep (the JAX trainer's
    ``fold_in(base_key, 10_000_000 + v)``), so a sweep is repeatable and
    does not move training's stream;
  * ShapeNet3D with ``gen_bg``: ``train()`` first composites new
    backgrounds into the host splits (``data.gen_bg``), after the device
    sampler took the train split in ``__init__``, as the JAX trainer
    orders them; validation reads those host splits, and every training
    batch is composited on the card by the sampler.

``timing`` holds the training steps and host seconds between the first and
the last loss read (each read waits for the card), validation excluded.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from wmfml_tpu_torch.ckpt.checkpoint import CheckpointManager
from wmfml_tpu_torch.cli.common import set_numerics
from wmfml_tpu_torch.data.device_sampler import DeviceEpisodeSampler
from wmfml_tpu_torch.obs.guards import check_finite
from wmfml_tpu_torch.obs.metrics import MetricsWriter
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import (build_device_data_train_step,
                                         build_eval_step, require_device)


def episode_to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class ModelTrainer:
    def __init__(self, model, config, data):
        self.config = config
        self.data = data
        self.logger = config.logger
        self.device = require_device(config.device)
        set_numerics()
        self.model = model.to(self.device)
        self.optimizer = build_optimizer(config, self.model.parameters())
        self.sampler = DeviceEpisodeSampler.from_dataset(data, config,
                                                         self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.seed))
        self.eval_generator = torch.Generator(device=self.device)
        self.steps_per_call = max(int(config.steps_per_call or 1), 1)
        self.train_step, self.eval_step = self._build_steps()
        self.writer = MetricsWriter(config.save_path)
        self.ckpt = CheckpointManager(config.save_path)
        self.best_loss = {"validation": 50000.0, "test": 20000.0}
        self.step = 0
        self.timing = {"steps": 0, "seconds": 0.0}
        if config.checkpoint:
            self.step = self.ckpt.restore(config.checkpoint, self.model,
                                          self.optimizer,
                                          map_location=self.device,
                                          generator=self.generator)
            self.logger.info(f"resumed from {config.checkpoint} at step {self.step}")

    def _build_steps(self):
        """(the fused K-step train call, eval_step) of this model family."""
        return (build_device_data_train_step(self.model, self.optimizer,
                                             self.config, self.sampler,
                                             self.steps_per_call),
                build_eval_step(self.model, self.config))

    def _save(self, name: str):
        self.ckpt.save(name, self.step, self.model, self.optimizer,
                       self.generator)

    def train(self):
        cfg = self.config
        k = self.steps_per_call
        pending = None       # (iteration, mean loss of its K steps on device)
        timer = None         # (host time, steps) at the last loss read
        if cfg.task == "shapenet_3d" and cfg.gen_bg:
            self.data.gen_bg(cfg)
        for it in range(self.step, cfg.iterations, k):
            loss = self.train_step(self.generator)["loss"]
            self.step += k
            pending = (it, loss.clone())
            if it % cfg.val_freq < k:
                train_loss = check_finite(pending[1], it, self.logger)
                pending = None
                self._tick(timer)
                self.writer.add_scalar("Loss/train", train_loss, it)
                self.logger.info(f"Iteration: {it}, loss: {train_loss:.4f}")
                self.validate(it, "validation")
                if cfg.task != "pascal_1d":
                    self.validate(it, "test")
                timer = (time.perf_counter(), self.step)
            if it % 1000 < k:
                self._save("model_intermediate")
        if pending is not None:
            check_finite(pending[1], pending[0], self.logger)
            self._tick(timer)
        self._save(f"model_end_{cfg.iterations}")

    def _tick(self, timer):
        if timer is not None:
            self.timing["seconds"] += time.perf_counter() - timer[0]
            self.timing["steps"] += self.step - timer[1]

    def validate(self, it: int, source: str) -> float:
        """One deterministic sweep of ``val_iters`` episodes."""
        cfg = self.config
        self.data.reset_eval(source, seed=42)
        self.eval_generator.manual_seed(int(cfg.seed) + 10_000_000)
        losses = [self.eval_step(episode_to_device(
            self.data.get_batch(source, cfg.tasks_per_batch, cfg.max_ctx_num),
            self.device), self.eval_generator) for _ in range(cfg.val_iters)]
        loss = float(np.mean([float(x) for x in losses]))
        self.writer.add_scalar(f"Loss/{source}", loss, it)
        self.logger.info(f"[{source}] iteration {it}: loss {loss:.4f}")
        if loss < self.best_loss[source]:
            self.best_loss[source] = loss
            self._save(f"model_best_{source}")
            self.ckpt.save_best_error(cfg.save_path, source, it, loss)
        return loss
