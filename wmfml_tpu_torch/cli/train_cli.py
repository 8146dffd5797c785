"""Meta-training CLI of the port.

Usage::

    python -m wmfml_tpu_torch.cli.train_cli --config cfg/train/ANP_DA+TA_ShapeNet1D.yaml \
        aug_list='[task_aug]' [key=value ...]
    python -m wmfml_tpu_torch.cli.train_cli --config cfg/train/MAML_DA_ShapeNet1D.yaml \
        'aug_list=[]' [key=value ...]

MMAML trains with ``MMAMLTrainer``, the other MAML methods with
``MAMLTrainer`` (second-order inner loops), the rest with ``ModelTrainer``
(``models/registry.py:method_family``).

Runs on ``cuda`` (the YAMLs' ``device: tpu`` maps there); ``device=cpu``
runs on the CPU. TF32 is off and cuDNN's determinism set as
``cli/common.py:set_numerics`` says. Exits 1 on a non-finite loss.

On n cards, data parallel over the task axis (``parallel/mesh.py``)::

    torchrun --standalone --nproc_per_node=4 -m wmfml_tpu_torch.cli.train_cli \
        --config cfg/train/ANP_DA+TA_ShapeNet1D.yaml [mesh_shape='{data: 4}']

Each rank runs on ``cuda:LOCAL_RANK``; rank 0 writes the run directory.
Ranks left over where ``tasks_per_batch`` does not divide the world sit
out (a warning says so). ``mesh_shape='{data: 2, model: 2}'`` runs as the
JAX trainer runs a model axis: the state whole on every rank, the task
axis over the data groups, the model ranks of a data group alike.
"""

from __future__ import annotations

import sys

from wmfml_tpu_torch.cli.common import (launch_rank, parse_args,
                                        set_numerics, start_mesh, stop_mesh)
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.models.registry import build_model, method_family
from wmfml_tpu_torch.obs.guards import NonFiniteLossError
from wmfml_tpu_torch.train.maml import MAMLTrainer
from wmfml_tpu_torch.train.mmaml import MMAMLTrainer
from wmfml_tpu_torch.train.steps import require_device
from wmfml_tpu_torch.train.trainer import ModelTrainer


def build_trainer(config: Config) -> ModelTrainer:
    require_device(config.device)        # before any data is generated
    set_numerics()
    cls = {"mmaml": MMAMLTrainer, "maml": MAMLTrainer,
           "np": ModelTrainer}[method_family(config.method)]
    return cls(build_model(config), config, build_data(config))


def train(config: Config) -> ModelTrainer:
    trainer = build_trainer(config)
    trainer.train()
    return trainer


def main(argv=None):
    args = parse_args("meta-training (PyTorch port)", argv)
    config = Config(args.config, overrides=args.overrides,
                    make_dirs=launch_rank() == 0)
    ctx = start_mesh(config)
    try:
        if ctx is not None and not ctx.active:
            return
        train(config)
    except NonFiniteLossError as e:
        config.logger.error(str(e))
        sys.exit(1)
    finally:
        stop_mesh(ctx)


if __name__ == "__main__":
    main()
