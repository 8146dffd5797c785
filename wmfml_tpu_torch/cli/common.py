"""Shared CLI plumbing: ``--config <yaml>`` plus ``key=value`` overrides,
the card's numeric settings every entry point runs under, and the process
group of a data-parallel run (``start_mesh``)."""

from __future__ import annotations

import argparse
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from wmfml_tpu_torch.parallel import mesh


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


def launch_rank() -> int:
    """This process's rank as ``torchrun`` sets it (0 without it)."""
    return int(os.environ.get("RANK", "0"))


def wants_mesh(config) -> bool:
    """A data-parallel run: ``WORLD_SIZE`` above 1 or ``mesh_shape`` set."""
    return (int(os.environ.get("WORLD_SIZE", "1")) > 1
            or bool(getattr(config, "mesh_shape", None)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_mesh(config) -> Optional[mesh.MeshContext]:
    """Where ``wants_mesh``: put the run on ``cuda:LOCAL_RANK``, start the
    default process group (NCCL on the card, gloo on the CPU; from
    ``torchrun``'s environment, else one rank on a local port) unless one
    is running, and make the mesh of ``config`` the process's
    (``parallel/mesh.py``). None, and nothing changed, otherwise."""
    if not wants_mesh(config):
        return None
    config.device = mesh.local_device(config.device)
    device = torch.device(config.device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "RANK" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
    ctx = mesh.from_config(config)
    mesh.use(ctx)
    return ctx


def stop_mesh(ctx: Optional[mesh.MeshContext]):
    """Leave the mesh ``start_mesh`` made and end the process group."""
    if ctx is None:
        return
    mesh.use(None)
    if dist.is_initialized():
        dist.destroy_process_group()
