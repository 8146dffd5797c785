"""Device-resident evaluation sweeps (``wmfml_tpu/data/device_eval.py``).

The validation and test splits live on the device; the host draws only the
episodes' indices, from the same streams as the host sweep (each split's
RandomState reset to 42 before a sweep, or before each context point of the
evaluator's), so both paths score one episode sequence. A sweep of V
batches then issues them one after another with no host read or sync
between them: the index table goes up in one host-to-device copy, each
batch is gathered from the split on the device, scored by the caller's eval
step and its loss written into a [V] tensor on the device, read once at the
end.

  * ``DeviceSplit``: a split on the device with its ``label_scale``;
    ``gather`` builds a raw episode from [T] groups and [T, S] / [T, Q]
    instance indices, as the host sampler's ``get_batch`` builds it;
  * ``split_from_dataset``: a split of a dataset, or None where the JAX
    package's gives None (an unknown task or a missing split, more than
    ``DEVICE_DATA_BYTES_LIMIT`` bytes on the host, too few instances a
    group: ``max_ctx_num + query_num``, or ``max_ctx_num`` when the queries
    are all the views, ``query_all``);
  * ``DeviceSweep`` (``build_device_eval_sweep``): the trainer's form
    (cls [V, T], ctx_idx [V, T, S], qry_idx [V, T, Q]; every context row
    real) and, called with ``shots`` [V], the evaluator's
    (``build_device_eval_ctx_sweep``): each batch's context mask is
    ``arange(S) < shots[v]`` over indices padded to S by repeating the last
    real one, as the JAX evaluator pads them (``np.pad(mode="edge")``).
    The host sweep pads by repeating row 0; the masked aggregators give the
    same loss either way, up to FAVOR's key stabiliser, a max over every
    key, padded ones included, which cancels in exact arithmetic and moves
    the float32 loss by rounding only.

Random draws: a Bayes-by-Backprop model draws its weights from the
sweep's generator, reseeded where ``seeds`` says (the trainer before the
first batch with ``seed + 10_000_000``, the evaluator before each context
point with ``seed + 20_000_000``, as their host sweeps reseed), so a device
sweep draws what the host sweep draws.

Graphs: on the card, after ``WARM_BATCHES`` batches issued eagerly on a
side stream (they build what is built lazily), one batch is captured as a
CUDA graph (``train/steps.py:capture_graph``: the trainer's generator
pattern, syncs made errors) that reads its row of the index table through
a cursor on the device and advances it; every later batch is one replay,
the generator reseeded on the host between replays where ``seeds`` says.
``graph=False`` issues every batch eagerly. On the CPU a sweep is the same
loop, with no graph.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from wmfml_tpu_torch.data.device_sampler import split_refusal
from wmfml_tpu_torch.train.steps import capture_graph

WARM_BATCHES = 3


class DeviceSplit:
    """A dense split [groups, instances, ...] and its labels on ``device``;
    images keep their host dtype (uint8, or ShapeNet3D's float32 RGBA, as
    the host sweep hands them to the eval step)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, label_scale: float,
                 device):
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        self.y = torch.from_numpy(np.asarray(y, np.float32)).to(device)
        self.label_scale = label_scale

    def gather(self, cls: torch.Tensor, ctx_idx: torch.Tensor,
               qry_idx: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """A raw episode from [T] groups and [T, S] / [T, Q] instances;
        ``mask`` [T, S] (default: every context row real)."""
        c = cls[:, None]
        if mask is None:
            mask = torch.ones(ctx_idx.shape, dtype=torch.bool,
                              device=ctx_idx.device)
        return dict(ctx_x=self.x[c, ctx_idx],
                    ctx_y=self.y[c, ctx_idx] * self.label_scale,
                    ctx_mask=mask, qry_x=self.x[c, qry_idx],
                    qry_y=self.y[c, qry_idx] * self.label_scale)


def split_from_dataset(data, config, source: str, device,
                       query_all: bool = False) -> Optional[DeviceSplit]:
    """``data``'s ``source`` split on ``device``, or None where the JAX
    package's ``split_from_dataset`` gives None
    (``wmfml_tpu/data/device_eval.py:56-91``). ``query_all``: the queries
    are all the views of an item (eval-mode data), so the split needs only
    ``max_ctx_num`` instances a group."""
    task = getattr(data, "task_name", None)
    try:
        if task == "shapenet_1d":
            x, y = ((data.x_val, data.y_val) if source == "validation"
                    else (data.x_test, data.y_test))
            scale = 2.0 * np.pi
        elif task == "pascal_1d":
            if source != "validation":
                return None
            x, y, scale = data.x_val, data.y_val, 1.0
        elif task in ("shapenet_3d", "distractor"):
            split = data.splits[source]
            x = split["images"]
            y = split["Q"] if task == "shapenet_3d" else split["centers"]
            scale = 1.0
        else:
            return None
    except (AttributeError, KeyError):
        return None
    need = (config.max_ctx_num if query_all
            else config.max_ctx_num + config.query_num)
    if split_refusal(x, need) is not None:
        return None
    return DeviceSplit(x, y, scale, device)


class DeviceSweep:
    """``sweep(cls, ctx_idx, qry_idx, seeds, shots=None)`` -> the test
    metric of each of the V batches, [V] float32 on the device.

    ``eval_step(batch, generator)`` scores one raw episode (the trainer's
    or the evaluator's eval step: the model's eval forward and the loss at
    ``test=True`` on ``mu.float()``, MAML's after its ``test_num_steps``
    inner steps); ``seeds[v]``, where not None, reseeds ``generator``
    before batch v; ``shots`` [V] gives each batch's real context rows
    (default: all S).

    The index table, the losses and the cursor are static tensors made at
    the first call; V, T, S and Q stay those of the first call. Launch
    accounting as ``FusedSteps``: the kernel counters count host-issued
    launches; the capture issued ``captured_launches`` and each of the
    ``replays`` ran them once, the first replay included, so the card
    launched each kernel its counter's count plus ``captured_launches``
    times (``replays`` - 1). ``graph_stats`` holds the capture's host
    seconds and its pool's bytes."""

    def __init__(self, eval_step: Callable, split: DeviceSplit,
                 generator: torch.Generator, graph: bool = True):
        self.eval_step, self.split, self.generator = eval_step, split, generator
        self.device = split.x.device
        cuda = self.device.type == "cuda"
        self.use_graph = graph and cuda
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.graph = self.table = self.losses = self.cursor = None
        self.shape = None
        self.eager = self.replays = 0
        self.captured_launches, self.graph_stats = {}, {}

    def _static(self, v: int, t: int, s: int, q: int):
        if self.table is None:
            self.shape = (v, t, s, q)
            dev = self.device
            self.table = torch.zeros(v, t * (1 + s + q) + 1,
                                     dtype=torch.int64, device=dev)
            self.losses = torch.zeros(v, dtype=torch.float32, device=dev)
            self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
            self.rows = torch.arange(v, device=dev)
            self.ctx_rows = torch.arange(s, device=dev)
        elif self.shape != (v, t, s, q):
            raise ValueError(f"a sweep of (V, T, S, Q) = {(v, t, s, q)}; "
                             f"this one was built for {self.shape}")

    def _batch(self):
        """Batch ``cursor``: gather, score, write its loss, advance."""
        _, t, s, q = self.shape
        row = self.table.index_select(0, self.cursor)[0]
        cls = row[:t]
        ctx = row[t:t * (1 + s)].view(t, s)
        qry = row[t * (1 + s):t * (1 + s + q)].view(t, q)
        mask = (self.ctx_rows < row[-1]).expand(t, s)
        loss = self.eval_step(self.split.gather(cls, ctx, qry, mask),
                              self.generator)
        self.losses.copy_(torch.where(self.rows == self.cursor,
                                      loss.detach().float(), self.losses))
        self.cursor.add_(1)

    def _run(self, seeds: Sequence[Optional[int]]):
        for seed in seeds:
            if seed is not None:
                self.generator.manual_seed(int(seed))
            if (self.use_graph and self.graph is None
                    and self.eager >= WARM_BATCHES):
                self.graph, _, self.captured_launches, self.graph_stats = (
                    capture_graph(self._batch, self.stream, self.generator))
            if self.graph is not None:
                self.graph.replay()
                self.replays += 1
            else:
                self._batch()
                self.eager += 1

    def __call__(self, cls, ctx_idx, qry_idx, seeds: Sequence[Optional[int]],
                 shots=None) -> torch.Tensor:
        cls, ctx_idx, qry_idx = (np.asarray(a) for a in (cls, ctx_idx,
                                                          qry_idx))
        v, t = cls.shape
        s, q = ctx_idx.shape[-1], qry_idx.shape[-1]
        if len(seeds) != v:
            raise ValueError(f"{len(seeds)} seeds for {v} batches")
        if shots is None:
            shots = np.full(v, s)
        self._static(v, t, s, q)
        host = torch.from_numpy(np.concatenate(
            [cls.reshape(v, -1), ctx_idx.reshape(v, -1),
             qry_idx.reshape(v, -1), np.asarray(shots).reshape(v, 1)],
            1).astype(np.int64))
        if self.stream is None:
            self.table.copy_(host)
            self.cursor.zero_()
            self._run(seeds)
            return self.losses.clone()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.table.copy_(host.pin_memory(), non_blocking=True)
            self.cursor.zero_()
            self._run(seeds)
            out = self.losses.clone()
        current.wait_stream(self.stream)
        return out


def build_device_eval_sweep(eval_step: Callable, split: DeviceSplit,
                            generator: torch.Generator,
                            graph: bool = True) -> DeviceSweep:
    """The trainer's sweep (``wmfml_tpu/data/device_eval.py:94``)."""
    return DeviceSweep(eval_step, split, generator, graph)


# the evaluator's sweep (``wmfml_tpu/data/device_eval.py:128``) is the same
# sweep, called with ``shots``
build_device_eval_ctx_sweep = build_device_eval_sweep
