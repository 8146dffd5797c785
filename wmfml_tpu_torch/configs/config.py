"""YAML config for the PyTorch port.

The same schema as the JAX package's ``Config``: the shipped ``cfg/train``
YAMLs load unchanged, ``key=value`` overrides parse as JSON, then YAML, then
a raw string, and a run writes ``config.yml`` and ``log.log`` into
``results/{mode}/{method}/{timestamp}_{task}_...``.

Port-specific rules:
  * ``device`` names where tensors live. The YAMLs say ``tpu``; it maps to
    ``cuda``, as do ``gpu`` and ``cuda``. Only ``device=cpu`` runs on the
    CPU, and only when the caller asks for it.
  * ``compute_dtype``: ``float32`` (the default) or ``bfloat16``, with the
    JAX package's rounding (``torch_dtype``); any other value raises, where
    the JAX package reads it as float32.
  * MAML keys as in the JAX package (``num_updates`` -> ``num_steps``,
    ``test_num_updates`` -> ``test_num_steps``, ``num_filters`` ->
    ``dim_hidden``). ``maml_remat`` takes only ``none`` (rematerialisation
    is not ported). Accepted and ignored: ``maml_unroll``, an XLA scheduling
    knob with no effect on results, and ``maml_pool_impl``, the JAX
    package's pool lowering, whose forward is the same for every choice and
    whose gradients differ only at ties, which sit at ReLU zeros where the
    gradient is 0: the port always pools in K1.
  * ``aug_random_order`` (default true, imgaug's per-batch random op order);
    ``false`` selects the JAX package's fused fixed-order pipeline
    (``FUSED_PIPELINES``), ported for every task with a loader.
  * ``trunk_stem`` (the ResNet trunk's stem lowering): only ``conv``, the
    stock convolution; the JAX package's phase-layout ``s2d`` stem is not
    ported (ROADMAP.md B8b) and raises.
  * ShapeNet3D's backgrounds: ``gen_bg`` (default true) recomposites the
    host splits when training starts and composites every training batch
    on the device; ``bg_gen_freq`` (default 1000) is read and kept, as in
    the JAX package, whose device sampler does not use it either.
  * ``shapenet_3d_segmentation`` has a shape here, as in the JAX package,
    and no loader or model there either: building its data raises.
  * ``prng_impl`` is read and kept, but the port's random stream is
    PyTorch's Philox whatever it says: the JAX package's ``threefry`` and
    ``rbg`` differ in their bits only, and so does Philox, so no
    distribution changes.
  * Evaluation reads the same keys as training (``checkpoint``,
    ``max_ctx_num``, ``val_iters``, ``tasks_per_batch``); ``mode`` (``eval``
    in the shipped evaluation YAMLs) names the results directory, as in the
    JAX package.
"""

from __future__ import annotations

import json
import logging
import os
from time import strftime
from typing import Any, Dict, List, Optional

import torch
import yaml

# Task name -> ([H, W, C], input label dim, output dim); images are
# channel-last [H, W, C] at the port's public boundary, as in the JAX package
TASK_SHAPES: Dict[str, tuple] = {
    "shapenet_3d": ([64, 64, 4], 4, 4),
    "shapenet_3d_segmentation": ([64, 64, 4], 4, 4),
    "pascal_1d": ([128, 128, 1], 1, 1),
    "shapenet_1d": ([128, 128, 1], 3, 2),  # label [cos a, sin a, a] -> [cos, sin]
    "distractor": ([128, 128, 1], 2, 2),
}

DEFAULT_QUERY_NUM = {
    "shapenet_1d": None,  # = max_ctx_num
    "shapenet_3d": 15,
    "distractor": 18,
    "pascal_1d": None,
}

DEVICE_ALIASES = {"tpu": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _parse_override(value: str) -> Any:
    """Parse a CLI override value: try JSON, then YAML, else raw string."""
    try:
        return json.loads(value)
    except (json.JSONDecodeError, ValueError):
        try:
            return yaml.safe_load(value)
        except yaml.YAMLError:
            return value


def torch_dtype(config) -> torch.dtype:
    """The dtype ``config.compute_dtype`` names. As with Flax's ``dtype=``,
    parameters stay float32; each layer casts its input and its weights to
    this dtype and returns it, and losses and metrics are taken in float32."""
    return COMPUTE_DTYPES[config.compute_dtype]


def resolve_device(name: str) -> str:
    key = str(name).split(":")[0].lower()
    if key not in DEVICE_ALIASES:
        raise ValueError(f"device {name!r}: choose cuda (tpu, gpu) or cpu")
    return DEVICE_ALIASES[key] + str(name)[len(key):]


class Config:
    """Attribute-access config; ``make_dirs`` creates the run directory."""

    def __init__(self, config: Optional[str] = None,
                 overrides: Optional[List[str]] = None,
                 make_dirs: bool = True,
                 results_root: str = "results"):
        self.results_root = results_root
        if config:
            with open(config, "rb") as f:
                cfg = yaml.safe_load(f)
            for item in overrides or []:
                key, _, val = item.partition("=")
                cfg[key.strip()] = _parse_override(val.strip())
            self.set_init_values(cfg, make_dirs=make_dirs)

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any], make_dirs: bool = False,
                  results_root: str = "results") -> "Config":
        self = cls(results_root=results_root)
        self.set_init_values(dict(cfg), make_dirs=make_dirs)
        return self

    def set_init_values(self, cfg: Dict[str, Any], make_dirs: bool = True):
        get = cfg.get
        self.method = cfg["method"]
        self.mode = get("mode", "train")
        self.task = cfg["task"]
        self.aug_list = get("aug_list", [])
        self.checkpoint = get("checkpoint", "")
        self.agg_mode = get("agg_mode", None)
        self.img_agg = get("img_agg", None)
        self.loss_type = get("loss_type", "mse")
        self.tasks_per_batch = cfg["tasks_per_batch"]
        self.max_ctx_num = cfg["max_ctx_num"]
        self.data_size = get("data_size", None)
        self.dim_w = get("dim_w", None)
        self.n_hidden_units_r = get("n_hidden_units_r", None)
        self.dim_r = get("dim_r", None)
        self.dim_z = get("dim_z", None)
        self.beta = get("beta", 0)
        # FCL (wmfml_tpu/configs/config.py:114-116)
        self.contrastive = get("contrastive", False)
        self.contrastive_rate = get("contrastive_rate", 1)
        self.temperature = get("temperature", 0.07)
        # MAML family (wmfml_tpu/configs/config.py:126-140, 192)
        self.num_steps = get("num_updates", None)
        self.test_num_steps = get("test_num_updates", None)
        self.dim_hidden = get("num_filters", None)
        self.first_order = get("first_order", None)
        self.update_lr = get("update_lr", None)
        self.learn_step_size = get("learn_step_size", False)
        self.per_param_step_size = get("per_param_step_size", False)
        self.maml_remat = get("maml_remat", "none")
        if self.maml_remat != "none":
            raise NotImplementedError(
                f"maml_remat={self.maml_remat!r}: only 'none' is ported "
                "(ROADMAP.md A19)")
        self.lr = cfg["lr"]
        self.weight_decay = get("weight_decay", False)
        self.optimizer = get("optimizer", "Adam")
        self.val_iters = get("val_iters", 10)
        self.val_freq = get("val_freq", 50)
        self.iterations = get("iterations", 50000)
        self.device = resolve_device(get("device", "cuda"))
        self.seed = cfg["seed"]
        self.timestamp = strftime("%Y-%m-%d_%H-%M-%S")
        self.compute_dtype = get("compute_dtype", "float32")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r}: the port computes in "
                f"{' or '.join(COMPUTE_DTYPES)}")
        self.aug_random_order = get("aug_random_order", True)
        self.gen_bg = get("gen_bg", True)
        self.bg_gen_freq = get("bg_gen_freq", 1000)
        self.trunk_stem = get("trunk_stem", "conv")
        if self.trunk_stem != "conv":
            raise NotImplementedError(
                f"trunk_stem={self.trunk_stem!r}: only the stock 'conv' stem "
                "is ported (ROADMAP.md B8b)")
        self.prng_impl = get("prng_impl", "threefry")
        self.data_path = get("data_path", None)
        self.synthetic_data = get("synthetic_data", False)
        # training steps per call of the trainer loop (a Python loop of K
        # steps; validation cadence follows it as in the JAX package)
        self.steps_per_call = get("steps_per_call", 1)

        if self.task not in TASK_SHAPES:
            raise TypeError(f"{self.task} is not implemented in this experiments!")
        self.img_size, self.input_dim, self.output_dim = TASK_SHAPES[self.task]
        qn = get("query_num", DEFAULT_QUERY_NUM.get(self.task))
        self.query_num = int(qn) if qn is not None else int(self.max_ctx_num)

        aug_tag = "+".join(self.aug_list) if self.aug_list else "noaug"
        self.save_path = (
            f"{self.results_root}/{self.mode}/{self.method}/"
            f"{self.timestamp}_{self.task}_datasize_{self.data_size}_"
            f"{self.agg_mode}_{self.img_agg}{self.loss_type}_{aug_tag}_seed_{self.seed}"
        )
        if make_dirs:
            os.makedirs(f"{self.save_path}/models", exist_ok=True)
            self.save_config()
            self.add_logger()
        else:
            self.logger = logging.getLogger("wmfml_tpu_torch")

    def save_config(self):
        payload = {k: v for k, v in self.__dict__.items() if k != "logger"}
        with open(os.path.join(self.save_path, "config.yml"), "w") as f:
            yaml.dump(payload, f)

    def add_logger(self):
        self.logger = logging.getLogger("wmfml_tpu_torch")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        if not any(type(h) is logging.StreamHandler for h in self.logger.handlers):
            sh = logging.StreamHandler()
            sh.setFormatter(logging.Formatter("%(message)s"))
            self.logger.addHandler(sh)
        log_file = os.path.abspath(f"{self.save_path}/log.log")
        for h in list(self.logger.handlers):
            if isinstance(h, logging.FileHandler):
                self.logger.removeHandler(h)
                h.close()
        self.logger.addHandler(logging.FileHandler(log_file, "a"))

    def __repr__(self):
        return f"Config(method={self.method!r}, task={self.task!r}, mode={self.mode!r})"
