"""Shared CLI plumbing: ``--config <yaml>`` plus ``key=value`` overrides,
and the card's numeric settings every entry point runs under."""

from __future__ import annotations

import argparse

import torch


def parse_args(description: str, argv=None):
    """--config <yaml> plus optional key=value overrides."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, required=True,
                        help="path of config file")
    parser.add_argument("overrides", nargs="*",
                        help="optional key=value config overrides")
    return parser.parse_args(argv)


def set_numerics() -> None:
    """The card's numeric settings, made by every entry point
    (``train_cli.build_trainer``, ``evaluation_cli.evaluate``, the trainers
    and the evaluator) before any work, and by the card checks
    (``chip_smoke.py``, the ``cuda`` tests), which so run what the entry
    points run:

      * TF32 off for cuDNN's convolutions and cuBLAS's float32 products
        (PyTorch's default runs float32 convolutions with 10-bit
        mantissas), in every ``compute_dtype``: in float32 the port computes
        what the JAX package's float32 computes, and in bfloat16 the work
        left in float32 (losses, the optimizer, the float32 sums the layers
        keep) stays float32 as it does there;
      * cuDNN's default algorithms, not its deterministic ones: with those a
        run's numbers would depend on its seed alone, as the JAX package's
        do, but a graph step costs 9-41% more on the paths measured
        (PERF.md §5, ROADMAP.md C2; README states the deviation)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
