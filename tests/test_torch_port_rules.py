"""Rules the PyTorch port keeps, checked on the CPU.

  * the port and ``chip_smoke.py`` import neither JAX nor the JAX package;
  * entry points run on ``cuda`` unless the caller asks for the CPU, and with
    no card they raise instead of falling back;
  * what is not ported raises and names its ROADMAP item: LargeCNP in
    bfloat16, other compute dtypes, other methods; the task with no loader
    (``shapenet_3d_segmentation``) raises; the shipped ShapeNet1D,
    Pascal1D, Distractor and ShapeNet3D YAMLs, image DA and the fixed-order
    perf YAMLs included, build as they are.
"""

import ast
import os

import pytest
import torch

from wmfml_tpu_torch.aug.image_aug import build_augmenter
from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.cli import train_cli
from wmfml_tpu_torch.configs import Config, resolve_device
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.steps import build_train_step, init_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "wmfml_tpu_torch")
MAIN_YAML = os.path.join(REPO, "cfg", "train", "ANP_DA+TA_ShapeNet1D.yaml")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "wmfml_tpu"}


def _port_sources():
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 30
    for path in sources:
        bad = FORBIDDEN.intersection(_imported_roots(path))
        assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def _config(*overrides):
    return Config(MAIN_YAML, ["aug_list=[task_aug]", *overrides],
                  make_dirs=False)


def test_default_device_is_cuda():
    assert _config().device == "cuda"                  # the YAML says tpu
    assert _config("device=cpu").device == "cpu"
    assert resolve_device("gpu:1") == "cuda:1"
    cfg = dict(method="ANPShapeNet1D", task="shapenet_1d", tasks_per_batch=2,
               max_ctx_num=4, lr=1e-4, seed=0)
    assert Config.from_dict(cfg).device == "cuda"
    with pytest.raises(ValueError):
        resolve_device("tpu_v5e")


def test_without_a_card_entry_points_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg = _config(f"data_path={tmp_path}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.build_trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg)
    assert not os.listdir(tmp_path)          # raised before touching data


def test_image_data_augmentation_raises():
    """Image DA builds for every task with a loader, in random order (the
    shipped YAMLs) and in the fixed order (``aug_random_order: false``);
    DA for a task without one raises. (The name is from when Distractor
    and ShapeNet3D raised too; it is kept so that the test's record runs
    on.)"""
    process = build_episode_processor("shapenet_1d", ["task_aug", "data_aug"],
                                      train=True)
    assert process.augment.program == "shapenet_1d"
    cfg = Config(MAIN_YAML, ["device=cpu", "dim_w=16"], make_dirs=False)
    assert cfg.aug_list == ["task_aug", "data_aug"]    # the shipped YAML
    assert cfg.aug_random_order is True
    model = build_model(cfg)
    build_train_step(model, torch.optim.Adam(model.parameters()), cfg)
    cfg = Config(MAIN_YAML, ["device=cpu", "aug_random_order=false"],
                 make_dirs=False)
    assert build_episode_processor(
        cfg.task, cfg.aug_list, train=True,
        aug_random_order=cfg.aug_random_order).augment.program == \
        "shapenet_1d_fixed"
    assert build_episode_processor("pascal_1d", ["data_aug"], train=True
                                   ).augment.program == "pascal_1d"
    assert build_augmenter("distractor").program == "distractor"
    assert build_augmenter("distractor", random_order=False).program == \
        "distractor_fixed"
    assert build_augmenter("shapenet_3d").program == "shapenet_3d"
    assert build_augmenter("shapenet_3d", random_order=False).program == \
        "shapenet_3d_fixed"
    with pytest.raises(NotImplementedError, match="no image DA"):
        build_augmenter("shapenet_3d_segmentation")


def test_fixed_order_perf_yaml_raises_instead_of_running_random_order():
    """``aug_random_order: false`` selects the JAX package's fused
    fixed-order pipeline: the perf YAML's train step runs the fixed
    program, never the random-order one in its place; Distractor's and
    ShapeNet3D's fixed programs build in float32, and ShapeNet3D's in
    bfloat16 too (the perf YAML's; ROADMAP.md A24), config and model.
    (The name is from when every task raised; it is kept so
    that the test's record runs on.)"""
    yaml = os.path.join(REPO, "cfg", "train", "perf",
                        "ANP_DA+TA_ShapeNet1D_tpu.yaml")
    cfg = Config(yaml, ["compute_dtype=float32", "device=cpu"],
                 make_dirs=False)
    assert cfg.aug_random_order is False
    model = build_model(cfg)
    step = build_train_step(model, torch.optim.Adam(model.parameters()), cfg)
    assert step is not None
    assert build_episode_processor(
        cfg.task, cfg.aug_list, train=True,
        aug_random_order=False).augment.program == "shapenet_1d_fixed"
    cfg = Config(yaml, ["task=distractor", "compute_dtype=float32"],
                 make_dirs=False)
    assert cfg.aug_random_order is False
    assert build_episode_processor(
        cfg.task, cfg.aug_list, train=True,
        aug_random_order=False).augment.program == "distractor_fixed"
    cfg = Config(yaml, ["task=shapenet_3d", "device=cpu"], make_dirs=False)
    assert cfg.compute_dtype == "bfloat16"
    assert build_model(cfg) is not None
    augment = build_episode_processor(
        cfg.task, cfg.aug_list, train=True, dtype=torch.bfloat16,
        aug_random_order=cfg.aug_random_order).augment
    assert (augment.program, augment.dtype) == ("shapenet_3d_fixed",
                                                torch.bfloat16)
    cfg = Config(yaml, ["task=shapenet_3d", "compute_dtype=float32"],
                 make_dirs=False)
    assert build_episode_processor(
        cfg.task, cfg.aug_list, train=True,
        aug_random_order=cfg.aug_random_order).augment.program == \
        "shapenet_3d_fixed"
    assert _config("prng_impl=rbg").prng_impl == "rbg"
    assert _config().prng_impl == "threefry"


def test_fixed_order_perf_yaml_raises_naming_a20_with_bf16_accepted():
    """The shipped ANP perf YAMLs (bfloat16 and ``aug_random_order:
    false``, T = 10 and T = 40) build as they are, bfloat16 with the fixed
    program; bf16 and the fixed order no longer stop them. (The name is
    from when these YAMLs raised naming ROADMAP.md A20, now done; it is
    kept so that the test's record runs on.)"""
    assert _config("compute_dtype=bfloat16").compute_dtype == "bfloat16"
    for name in ("ANP_DA+TA_ShapeNet1D_tpu.yaml",
                 "ANP_DA+TA_ShapeNet1D_tpu_T40.yaml"):
        cfg = Config(os.path.join(REPO, "cfg", "train", "perf", name), [],
                     make_dirs=False)
        assert (cfg.compute_dtype, cfg.aug_random_order, cfg.device) == (
            "bfloat16", False, "cuda")
        augment = build_episode_processor(
            cfg.task, cfg.aug_list, train=True, dtype=torch.bfloat16,
            aug_random_order=cfg.aug_random_order).augment
        assert (augment.program, augment.dtype) == ("shapenet_1d_fixed",
                                                    torch.bfloat16)


@pytest.mark.parametrize("override,error", [
    ("compute_dtype=float16", NotImplementedError),
    ("method=MAMLMRShapeNet1D", NotImplementedError),
    ("method=MMAMLShapeNet1D", NotImplementedError),
    ("method=NoSuchMethod", NameError),
    ("agg_mode=max", TypeError),
])
def test_unported_options_raise(override, error):
    """(MAMLMRShapeNet1D, ROADMAP.md A13, is done and builds; its case is
    kept so that the case's record runs on.)"""
    if override == "method=MAMLMRShapeNet1D":
        model = build_model(_config("device=cpu", override))
        assert type(model).__name__ == "MAMLRegressor" and model.bbb
        return
    with pytest.raises(error):
        build_model(_config("device=cpu", override))


@pytest.mark.parametrize("method,item", [
    ("MAMLMR", "A13"), ("MAMLMRShapeNet1D", "A13"), ("ANPMR", "A13"),
    ("MMAMLShapeNet1D", "A16"), ("ANP", "A12"), ("SingleTaskShapeNet1D", "A14"),
])
def test_unported_methods_name_their_roadmap_item(method, item):
    """(The cases of ANP, whose slice, A12c, is done, and of the A13
    methods, done, now build ShapeNet3D's ANP and the MR methods and run
    them; they are kept so that the cases' records run on.)"""
    if method == "ANP":
        yaml = os.path.join(REPO, "cfg", "train", "ANP_ShapeNet3D.yaml")
        model = build_model(Config(yaml, ["device=cpu"], make_dirs=False))
        assert type(model).__name__ == "LargeCNP"
        assert model.agg_mode == "attention"
        return
    if item == "A13":
        _builds_and_runs_mr(method)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        build_model(_config("device=cpu", f"method={method}"))


def _builds_and_runs_mr(method):
    """A13's MR methods from their shipped YAMLs: one forward on the CPU at
    the YAML's width (a 32x32 image size, T = 2), finite, with a kl; two
    generators of one seed draw the same weights."""
    from wmfml_tpu_torch.nn.bbb import EpsFeed

    task = "pascal_1d" if method in ("MAMLMR", "ANPMR") else "shapenet_1d"
    name = {"MAMLMR": "MAMLMR_Pascal1D.yaml", "ANPMR": "ANPMR_Pascal1D.yaml",
            "MAMLMRShapeNet1D": "MAMLMR_ShapeNet1D.yaml"}[method]
    cfg = Config(os.path.join(REPO, "cfg", "train", name), ["device=cpu"],
                 make_dirs=False)
    assert (cfg.method, cfg.task) == (method, task)
    cfg.img_size = [32, 32, 1]
    model = build_model(cfg)
    x = torch.rand(2, 3, 32, 32, 1)
    y = torch.rand(2, 3, cfg.input_dim)
    outs = []
    for _ in range(2):
        gen = EpsFeed(generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            if method.startswith("MAML"):
                mu, kl = model.forward_with_kl(x, None, None, gen)
            else:
                out = model(x, y, x, generator=gen)
                mu, kl = out.mu, out.kl
        outs.append(mu)
        assert bool(torch.isfinite(mu).all()) and float(kl) > 0
    assert torch.equal(*outs) and gen.draws


def test_unported_maml_options_raise(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="A19"):
        _config("device=cpu", "maml_remat=step")
    monkeypatch.chdir(tmp_path)
    cfg = _config("device=cpu", "method=MMAMLShapeNet1D")
    with pytest.raises(NotImplementedError, match="A16"):
        train_cli.build_trainer(cfg)
    assert not os.listdir(tmp_path)          # raised before touching data


def test_maml_yaml_builds_a_second_order_cuda_trainer_config(monkeypatch,
                                                            tmp_path):
    yaml = os.path.join(REPO, "cfg", "train", "MAML_DA_ShapeNet1D.yaml")
    cfg = Config(yaml, ["aug_list=[]"], make_dirs=False)
    assert cfg.device == "cuda" and cfg.first_order is False
    assert (cfg.num_steps, cfg.test_num_steps, cfg.dim_hidden) == (5, 20, 64)
    model = build_model(Config(yaml, ["aug_list=[]", "device=cpu"],
                               make_dirs=False))
    assert type(model).__name__ == "MAMLRegressor" and model.side == 14
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.build_trainer(Config(yaml, ["aug_list=[]",
                                              f"data_path={tmp_path}"]))
    assert os.listdir(tmp_path) == ["results"]     # the run dir, no data


def test_unported_task_raises(tmp_path):
    """The task the JAX package has a shape for and no loader
    (``shapenet_3d_segmentation``) raises; ShapeNet3D (ROADMAP.md A12c,
    done) builds its processor. (The name is from when ShapeNet3D raised;
    it is kept so that the test's record runs on.)"""
    cfg = Config.from_dict(dict(method="CondNeuralProcess",
                                task="shapenet_3d_segmentation",
                                tasks_per_batch=2, max_ctx_num=4, lr=1e-4,
                                seed=0, device="cpu", data_path=str(tmp_path)))
    with pytest.raises(NotImplementedError, match="no loader"):
        build_data(cfg)
    with pytest.raises(NotImplementedError):
        build_episode_processor("shapenet_3d_segmentation", [], train=False)
    assert build_episode_processor("shapenet_3d", [], train=False).augment \
        is None
