"""Checkpoints with the reference's names, written with ``torch.save``.

Under ``<run>/models/``: ``model_best_{split}.pt`` (best per split),
``model_intermediate.pt`` (every 1000 iterations) and
``model_end_{iterations}.pt`` (at the end), plus ``best_{split}_error.txt``
in the run directory. A file holds ``{"step", "model", "optimizer",
"generator"}``; ``model`` is a plain ``state_dict`` with the reference's
keys, ``generator`` the trainer's random generator state (a uint8 tensor),
so that a resumed run draws what an unbroken run draws (the JAX trainer
keys each step by its index, ``wmfml_tpu/train/trainer.py:200``). After
CUDA graph replays the generator's state holds the offsets the replays
drew (each replay moves it), and a capturable Adam's state (its step
counts on the card) saves as any other tensor.

A restored optimizer takes the checkpoint's moments and step counts and
keeps its own hyperparameters, as an optax state carries no learning rate:
the current config's ``lr`` (refinement's YAML, say) and its own
``capturable`` flag, whichever device wrote the checkpoint (capturable on
the card, where the fused step captures it, and not on the CPU,
``train/state.py``); its step counts go where that flag puts them.

``restore`` also takes the reference's files, model weights only (the
generator keeps its seed), in the forms ``wmfml_tpu/ckpt/torch_import.py:
619-689`` takes:

  * a bare ``state_dict``, or one under ``{"state_dict": sd}``;
  * MMAML's combined dict ``{"model_state_dict", "embedding_model_state_dict",
    "optimizers"}``, its two state_dicts prefixed ``model.`` and
    ``embedding_model.`` (the port's ``MMAMLBundle`` keys); the reference
    gated net's BN keeps running statistics the port never reads (BN on
    batch statistics, as in the JAX package), so a reference file's
    ``running_mean`` / ``running_var`` / ``num_batches_tracked`` buffers that
    the model lacks are dropped;
  * under ``learn_step_size`` a reference file carries no inner step
    sizes: they keep the model's own, ``update_lr``, with a warning.

Every file is read by ``torch.load(weights_only=True)``, whose unpickler
builds nothing but tensors, containers and the globals it is told to
trust: here the port's copy of the JAX package's allowlist
(``wmfml_tpu/ckpt/torch_import.py:529``), ``PICKLE_GLOBAL_ALLOWLIST``, which
adds the ``defaultdict`` and numpy values a reference file may carry. A
pickle that names anything else (``os.system``, ``builtins.eval``), by any
opcode and in any of a legacy file's pickles, is refused before it is
built; so is a pickle of protocol 4 or above (torch's unpickler reads the
protocol 2 that ``torch.save`` writes). Every other key must match: the
load is strict.
"""

from __future__ import annotations

import collections
import logging
import os
import pickle
from typing import Dict

import numpy as np
import torch

_MULTIARRAY = (getattr(np, "_core", None) or np.core).multiarray

# Beside torch's own list (tensors, storages, OrderedDict, set, complex,
# bytearray): numpy's reconstructors under both of their module names.
PICKLE_GLOBAL_ALLOWLIST = [
    collections.defaultdict, dict, list, int, float, np.ndarray, np.dtype,
    *[(f, f"numpy.{m}.multiarray.{f.__name__}")
      for f in (_MULTIARRAY._reconstruct, _MULTIARRAY.scalar)
      for m in ("core", "_core")],
    *{type(np.dtype(t)) for t in (np.float16, np.float32, np.float64,
                                  np.int8, np.int16, np.int32, np.int64,
                                  np.uint8, np.bool_)},
]

_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def load_checkpoint_file(path: str, map_location=None):
    """``torch.load`` tensors-only, trusting ``PICKLE_GLOBAL_ALLOWLIST``;
    ``RuntimeError`` with torch's reason where the file needs more."""
    try:
        with torch.serialization.safe_globals(PICKLE_GLOBAL_ALLOWLIST):
            return torch.load(path, map_location=map_location,
                              weights_only=True)
    except pickle.UnpicklingError as err:
        raise RuntimeError(
            f"refusing to unpickle {path}: it needs more than tensors, "
            f"containers and the allowlisted globals. {err}") from None


def reference_state_dict(payload) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` of a reference file (any form above)."""
    if "model_state_dict" in payload:
        sd = {f"model.{k}": v for k, v in payload["model_state_dict"].items()}
        sd.update({f"embedding_model.{k}": v for k, v in
                   payload.get("embedding_model_state_dict", {}).items()})
        return sd
    if "state_dict" in payload:
        return dict(payload["state_dict"])
    return dict(payload)


def load_reference_state_dict(model, sd: Dict[str, torch.Tensor]):
    """Load a reference ``state_dict`` into ``model``, strictly but for
    the BN running statistics the model lacks and, where the model learns
    its inner step sizes and the file has none, those step sizes."""
    own = model.state_dict()
    sd = {k: v for k, v in sd.items()
          if k in own or not k.endswith(_BN_STATS)}
    steps = {k: v for k, v in own.items() if k.startswith("step_size")}
    if steps and not any(k.startswith("step_size") for k in sd):
        logging.getLogger("wmfml_tpu_torch").warning(
            "the reference checkpoint carries no inner step sizes; "
            "learn_step_size starts them at update_lr")
        sd.update(steps)
    model.load_state_dict(sd)


class CheckpointManager:
    def __init__(self, run_dir: str):
        self.models_dir = os.path.abspath(os.path.join(run_dir, "models"))

    def path(self, name: str) -> str:
        return os.path.join(self.models_dir, f"{name}.pt")

    def save(self, name: str, step: int, model, optimizer=None,
             generator=None):
        payload = {"step": int(step), "model": model.state_dict(),
                   "optimizer": optimizer.state_dict() if optimizer else None,
                   "generator": generator.get_state() if generator else None}
        # made at the first save: a rank that never saves makes no directory
        os.makedirs(self.models_dir, exist_ok=True)
        tmp = self.path(name) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(name))

    def restore(self, name_or_path: str, model, optimizer=None,
                map_location=None, generator=None) -> int:
        """Load a port checkpoint (model, optimizer and generator state) or
        a reference file (model only: the generator keeps its seed); return
        the saved step (0 for a reference file)."""
        path = (name_or_path if os.path.exists(name_or_path)
                else self.path(name_or_path))
        payload = load_checkpoint_file(path, map_location)
        if "model" not in payload:                 # a reference .pt
            load_reference_state_dict(model, reference_state_dict(payload))
            return 0
        model.load_state_dict(payload["model"])
        if optimizer is not None and payload.get("optimizer"):
            saved = payload["optimizer"]
            for group, live in zip(saved["param_groups"],
                                   optimizer.param_groups):
                group.update({k: v for k, v in live.items() if k != "params"})
            optimizer.load_state_dict(saved)
        if generator is not None and payload.get("generator") is not None:
            generator.set_state(payload["generator"].cpu())
        return int(payload["step"])

    @staticmethod
    def save_best_error(run_dir: str, split: str, step: int, error: float):
        with open(os.path.join(run_dir, f"best_{split}_error.txt"), "w") as f:
            f.write(f"iter: {step}, {split} error: {error}\n")
