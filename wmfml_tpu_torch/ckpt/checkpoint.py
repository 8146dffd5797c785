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
"""

from __future__ import annotations

import os

import torch


class CheckpointManager:
    def __init__(self, run_dir: str):
        self.models_dir = os.path.abspath(os.path.join(run_dir, "models"))
        os.makedirs(self.models_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.models_dir, f"{name}.pt")

    def save(self, name: str, step: int, model, optimizer=None,
             generator=None):
        payload = {"step": int(step), "model": model.state_dict(),
                   "optimizer": optimizer.state_dict() if optimizer else None,
                   "generator": generator.get_state() if generator else None}
        tmp = self.path(name) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(name))

    def restore(self, name_or_path: str, model, optimizer=None,
                map_location=None, generator=None) -> int:
        """Load a port checkpoint (model, optimizer and generator state) or
        a bare reference ``state_dict`` (model only: the generator keeps its
        seed); return the saved step."""
        path = (name_or_path if os.path.exists(name_or_path)
                else self.path(name_or_path))
        payload = torch.load(path, map_location=map_location, weights_only=True)
        if "model" not in payload:                 # reference .pt state_dict
            model.load_state_dict(payload)
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
