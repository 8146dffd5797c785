"""Meta-training loop for the CNP/ANP family (``wmfml_tpu/train/trainer.py``);
``train/maml.py:MAMLTrainer`` runs the same loop with MAML steps
(``_build_steps``), ``train/mmaml.py:MMAMLTrainer`` with MMAML's steps and
its two-group optimizer (``_build_optimizer``).

  * iteration loop; each pass of the loop is one call of the fused step
    (``train/steps.py:FusedSteps``): ``steps_per_call`` steps, one CUDA
    graph replay on the card, a loop on the CPU;
  * where the episodes come from, as the JAX package decides it
    (``device_data``, ``data/device_sampler.py:from_dataset``): with
    ``device_data`` auto or true and a train split the device takes, each
    step samples its episode on the device; otherwise (``device_data``
    off, or a split ``from_dataset`` declines: too large, a short class, an
    unknown task) the host path: a ``Prefetcher`` thread draws each call's
    K host episodes (``data.get_batch("train")``; ShapeNet3D's and
    Distractor's ``draw_batch``, whose image rows the native episode core
    gathers straight into the stack) and stacks them into pinned memory
    ``prefetch`` calls ahead, and the call copies them into the static
    buffers its graph reads (``train/steps.py:HostEpisodes``). MAML and
    MMAML take one step a call there, as in the JAX package;
  * validation when ``it % val_freq < K`` on the validation AND test splits
    (test skipped for pascal_1d), from streams reset to RandomState 42
    before every sweep. After training on the device path the val/test
    splits go to the device at the first validation and each sweep is one
    ``data/device_eval.py:DeviceSweep`` over their indices (no host read
    between batches, CUDA graph replays after a warm-up); on the host path,
    and for a split ``split_from_dataset`` declines, host episodes one at a
    time;
  * best-per-split checkpoints + ``best_{split}_error.txt``, an intermediate
    checkpoint when ``it % 1000 < K`` and a final one at the end;
  * NaN guard: the loss (a clone of the call's mean loss: the next replay
    overwrites the graph's outputs) stays on the device and is read at the
    validation cadence; a non-finite loss raises ``NonFiniteLossError``;
  * one random generator on the device draws every episode (device path),
    DA, TA and Bayes-by-Backprop (MR) draw of training; checkpoints hold
    its state, so a run resumed from one draws what an unbroken run would
    have drawn (the host path's episodes come from the dataset's own
    streams, which start anew, as in the JAX package); validation's BBB
    draws come from a second generator, reseeded with ``seed +
    10_000_000`` before every sweep (the JAX trainer's ``fold_in(base_key,
    10_000_000 + v)``), so a sweep is repeatable and does not move
    training's stream;
  * ShapeNet3D with ``gen_bg``: ``train()`` first composites new
    backgrounds into the host splits (``data.gen_bg``), after the device
    sampler took the train split in ``__init__``, as the JAX trainer
    orders them; validation reads those host splits (or their device
    copies, made after), and every training batch of the device path is
    composited on the card by the sampler. The host path recomposites the
    train split every ``bg_gen_freq`` iterations (``it > start and it %
    bg_gen_freq < K``, the JAX trainer's cadence) on the prefetch thread,
    before it draws that iteration's batch: a batch of iteration ``it`` is
    drawn after every recomposite at iterations <= ``it``. (The JAX trainer
    recomposites on the main thread while its prefetch thread reads the
    split, so which backgrounds a batch gets is not fixed there.)

``timing`` holds the training steps and host seconds between the first and
the last loss read (each read waits for the card), validation excluded.

Under a data-parallel mesh (``parallel/mesh.py``; ``cli/common.py:
start_mesh``) every rank runs this loop on its slice of each batch's tasks:
the parameters (and any restored optimizer state) are rank 0's
(``broadcast_training_state``), every rank draws what one process draws, the
steps average their gradients and losses, and validation scores each
rank's tasks and averages; rank 0 alone writes checkpoints, the metrics
and ``best_{split}_error.txt``, and every rank resumes from the same file.
With a "model" axis the state stays whole on every rank and the model
ranks of a data index run the same slice (the JAX trainer's
``wmfml_tpu/train/trainer.py:97``); collectives over the task axis run
over the data group.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from wmfml_tpu_torch.ckpt.checkpoint import CheckpointManager
from wmfml_tpu_torch.cli.common import set_numerics
from wmfml_tpu_torch.configs.config import device_data_on, torch_dtype
from wmfml_tpu_torch.data.device_eval import (DeviceSweep,
                                              build_device_eval_sweep,
                                              split_from_dataset)
from wmfml_tpu_torch.data.device_sampler import from_dataset, refusal
from wmfml_tpu_torch.data.episode_core import Rows
from wmfml_tpu_torch.obs.guards import check_finite
from wmfml_tpu_torch.obs.metrics import MetricsWriter
from wmfml_tpu_torch.parallel import mesh
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import (HostEpisodes,
                                         build_device_data_train_step,
                                         build_eval_step, require_device)


def episode_to_device(batch, device):
    """A host episode as tensors on ``device``; to the card through pinned
    memory, without blocking the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    return {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


class Prefetcher:
    """Host batches drawn on a daemon thread
    (``wmfml_tpu/train/trainer.py:37-70``): the thread puts
    ``put_fn(sample_fn())`` into a queue at most ``depth`` batches deep;
    ``next()`` takes them in the order drawn. An exception of the thread
    is raised on the next ``next()``; a ``sample_fn`` that raises
    ``StopIteration`` ends the stream, and ``next()`` raises it once the
    queue is drained. ``empty_waits`` counts the ``next()`` calls that
    found the queue empty and waited; ``close()`` stops the thread and
    joins it."""

    def __init__(self, sample_fn: Callable, put_fn: Callable, depth: int = 2):
        self.sample_fn, self.put_fn = sample_fn, put_fn
        self.q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.empty_waits = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                try:
                    item = self.sample_fn()
                except StopIteration:
                    return
                batch = self.put_fn(item)
                while not self._stop.is_set():
                    try:
                        self.q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:      # raised on the next __next__
            self._exc = e

    def __iter__(self):
        return self

    def __next__(self):
        if self.q.empty():
            self.empty_waits += 1
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                return self.q.get(timeout=0.1)
            except queue.Empty:
                if not self.thread.is_alive() and self.q.empty():
                    if self._exc is not None:
                        raise self._exc
                    raise StopIteration

    def close(self):
        self._stop.set()
        self.thread.join()


class ModelTrainer:
    def __init__(self, model, config, data):
        self.config = config
        self.data = data
        self.logger = config.logger
        self.device = require_device(config.device)
        set_numerics()
        self.model = model.to(self.device)
        self.optimizer = self._build_optimizer()
        self.sampler = self._build_sampler()
        self.streamed = isinstance(self.sampler, HostEpisodes)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.seed))
        self.eval_generator = torch.Generator(device=self.device)
        self.steps_per_call = max(int(config.steps_per_call or 1), 1)
        self.train_step, self.eval_step = self._build_steps()
        # the val/test sweeps on the device: set up at the first validation
        # after training on the device path (wmfml_tpu/train/trainer.py:145)
        self.device_eval: Optional[Dict[str, DeviceSweep]] = None
        self.prefetch_stats: Dict[str, int] = {}
        self.mesh = mesh.current()
        self.lead = self.mesh is None or self.mesh.lead
        self.writer = MetricsWriter(config.save_path) if self.lead else None
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
        mesh.broadcast_training_state(self.mesh, self.model, self.optimizer)

    def _build_optimizer(self):
        return build_optimizer(self.config, self.model.parameters())

    def _build_sampler(self):
        """The train split on the device (``from_dataset``), or
        ``HostEpisodes`` for the host path, logged once with its reason
        (``wmfml_tpu/train/trainer.py:118-131``)."""
        cfg = self.config
        if device_data_on(cfg):
            sampler = from_dataset(self.data, cfg, self.device)
            if sampler is not None:
                self.logger.info("train split resident on the device; "
                                 "episodes sampled on the device")
                return sampler
            why = f"from_dataset declined it: {refusal(self.data, cfg)}"
            if cfg.device_data != "auto":
                self.logger.info("device_data requested but split layout/"
                                 "size unsupported; falling back to host "
                                 "streaming")
        else:
            why = f"device_data is {cfg.device_data!r}"
        self.logger.info(f"train split streamed from the host ({why}): "
                         f"a prefetch thread {cfg.prefetch} calls ahead")
        return HostEpisodes(self.device)

    def _build_steps(self):
        """(the fused K-step train call, eval_step) of this model family."""
        return (build_device_data_train_step(self.model, self.optimizer,
                                             self.config, self.sampler,
                                             self.steps_per_call),
                build_eval_step(self.model, self.config))

    def _save(self, name: str):
        if self.lead:
            self.ckpt.save(name, self.step, self.model, self.optimizer,
                           self.generator)

    def _scalar(self, tag: str, value, it: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, it)

    def _host_batches(self, start: int):
        """The host path's batches in iteration order, for the prefetch
        thread; ShapeNet3D's train split recomposited first where the JAX
        trainer does it (``wmfml_tpu/train/trainer.py:194-198``)."""
        cfg, k = self.config, self.steps_per_call
        for it in range(start, cfg.iterations, k):
            if (cfg.task == "shapenet_3d" and cfg.gen_bg and it > start
                    and it % cfg.bg_gen_freq < k):
                self.data.gen_bg(cfg, data="train")
            yield self._sample_train()

    def _sample_train(self):
        """A call's K host episodes; from a sampler that draws episodes
        with their image rows not gathered yet (``draw_batch``: ShapeNet3D,
        Distractor), those, for ``_put_train_batch`` to gather."""
        cfg = self.config
        draw = getattr(self.data, "draw_batch", self.data.get_batch)
        return [draw("train", cfg.tasks_per_batch, cfg.max_ctx_num)
                for _ in range(self.steps_per_call)]

    def _put_train_batch(self, episodes):
        """K host episodes stacked [K, T, ...] into CPU tensors for
        ``HostEpisodes.load``, straight into pinned memory when the trainer
        runs on the card (the pinned allocator reuses the blocks of earlier
        calls): rows not gathered yet (``data/episode_core.py:Rows``) are
        gathered there by the native core, anything else copied once;
        float images in the compute dtype, as the device sampler keeps a
        float split."""
        pin = self.device.type == "cuda"
        out = {}
        for k, first in episodes[0].items():
            native = torch.from_numpy(np.empty(0, first.dtype)).dtype
            dtype = native
            if k in ("ctx_x", "qry_x") and dtype.is_floating_point:
                dtype = torch_dtype(self.config)
            out[k] = torch.empty((len(episodes), *first.shape), dtype=dtype,
                                 pin_memory=pin)
            for i, episode in enumerate(episodes):
                v = episode[k]
                if isinstance(v, Rows) and dtype == native:
                    v.gather(out=out[k][i].numpy())
                    continue
                if isinstance(v, Rows):
                    v = v.gather()
                out[k][i].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        return out

    def train(self):
        cfg = self.config
        k = self.steps_per_call
        start = self.step
        pending = None       # (iteration, mean loss of its K steps on device)
        timer = None         # (host time, steps) at the last loss read
        if cfg.task == "shapenet_3d" and cfg.gen_bg:
            self.data.gen_bg(cfg)
        prefetch = (Prefetcher(self._host_batches(start).__next__,
                               self._put_train_batch, depth=cfg.prefetch)
                    if self.streamed else None)
        try:
            for it in range(start, cfg.iterations, k):
                if prefetch is not None:
                    self.sampler.load(next(prefetch))
                loss = self.train_step(self.generator)["loss"]
                self.step += k
                pending = (it, loss.clone())
                if it % cfg.val_freq < k:
                    train_loss = check_finite(pending[1], it, self.logger)
                    pending = None
                    self._tick(timer)
                    self._scalar("Loss/train", train_loss, it)
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
        finally:
            if prefetch is not None:
                prefetch.close()
                self.prefetch_stats = dict(
                    calls=len(range(start, cfg.iterations, k)),
                    empty_waits=prefetch.empty_waits)

    def _tick(self, timer):
        if timer is not None:
            self.timing["seconds"] += time.perf_counter() - timer[0]
            self.timing["steps"] += self.step - timer[1]

    def _make_device_sweep(self, split) -> DeviceSweep:
        """A device sweep over ``split`` with this family's eval step
        (MAML's and MMAML's adapt ``test_num_steps`` inner steps a batch:
        the JAX package's ``build_outer_device_sweep``, ``wmfml_tpu/train/
        maml.py:312-333``)."""
        return build_device_eval_sweep(self.eval_step, split,
                                       self.eval_generator)

    def _setup_device_eval(self) -> Dict[str, DeviceSweep]:
        """The val/test splits on the device and their sweeps
        (``wmfml_tpu/train/trainer.py:248-263``); made at the first
        validation, after ``train()``'s ShapeNet3D recomposite, so the
        device copies hold what the host arrays hold."""
        sweeps = {}
        if not hasattr(self.data, "get_batch_indices"):
            return sweeps
        sources = ["validation"] + ([] if self.config.task == "pascal_1d"
                                    else ["test"])
        for source in sources:
            split = split_from_dataset(self.data, self.config, source,
                                       self.device)
            if split is not None:
                sweeps[source] = self._make_device_sweep(split)
        if sweeps:
            self.logger.info(f"eval splits resident on the device: "
                             f"{sorted(sweeps)}")
        return sweeps

    def _device_validate(self, source: str) -> np.ndarray:
        """The host draws the sweep's indices from the reseeded stream; the
        device gathers and scores every batch (``wmfml_tpu/train/
        trainer.py:265-295``)."""
        cfg = self.config
        self.data.reset_eval(source, seed=42)
        s, q = cfg.max_ctx_num, cfg.query_num
        cls, ctx_i, qry_i = [], [], []
        for _ in range(cfg.val_iters):
            groups, take, shot = self.data.get_batch_indices(
                source, cfg.tasks_per_batch, s)
            assert shot == s, "eval shot must be the requested ctx count"
            # loud, not silently clamped: a mode='eval' dataset's index
            # table is only as wide as its views
            assert take.shape[1] >= s + q, (
                f"index table too narrow ({take.shape[1]} < {s + q}) — "
                "mode='eval' datasets must go through the evaluator's "
                "query_all sweep, not the trainer")
            cls.append(groups)
            ctx_i.append(take[:, :s])
            qry_i.append(take[:, s:s + q])
        seeds = [int(cfg.seed) + 10_000_000] + [None] * (cfg.val_iters - 1)
        losses = self.device_eval[source](np.stack(cls), np.stack(ctx_i),
                                          np.stack(qry_i), seeds)
        return losses.cpu().numpy().astype(np.float64)

    def validate(self, it: int, source: str) -> float:
        """One deterministic sweep of ``val_iters`` episodes."""
        cfg = self.config
        if self.device_eval is None and not self.streamed:
            self.device_eval = self._setup_device_eval()
        if source in (self.device_eval or {}):
            losses = self._device_validate(source)
        else:
            self.data.reset_eval(source, seed=42)
            self.eval_generator.manual_seed(int(cfg.seed) + 10_000_000)
            losses = [self.eval_step(episode_to_device(
                self.data.get_batch(source, cfg.tasks_per_batch,
                                    cfg.max_ctx_num), self.device),
                self.eval_generator) for _ in range(cfg.val_iters)]
            losses = [float(x) for x in losses]
        loss = float(np.mean(np.asarray(losses, np.float64)))
        self._scalar(f"Loss/{source}", loss, it)
        self.logger.info(f"[{source}] iteration {it}: loss {loss:.4f}")
        if loss < self.best_loss[source]:
            self.best_loss[source] = loss
            self._save(f"model_best_{source}")
            if self.lead:
                self.ckpt.save_best_error(cfg.save_path, source, it, loss)
        return loss
