"""The port's MMAML against the JAX package on the CPU.

Both networks' forwards (each modulation type, masked and unmasked), the
GRU aggregation, ``build_mmaml_outer``'s loss and both networks' gradients
in both orders, the eval loss, one optimizer step (the per-group clip and
Adam), bfloat16, the registry's full widths, the weight carry into JAX and
``train_cli`` end to end. Small widths: ``GatedConvNet(num_channels=4)``,
embedding dims (8, 16, 32, 64), hidden 16, T = 2 tasks, S = 3 padded
context rows (one task has 2), Q = 3 queries, 32x32 images, 2 inner steps.
JAX's variables come into the port through ``load_jax_variables``.

Tolerance: ``RTOL``/``ATOL`` (1e-5) for values; gradients as
``test_torch_port_maml.py`` holds MAML's (``GRAD_TOL``, and 1e-3 of each
tensor's largest entry: four batch norms, whose backward subtracts means,
in each inner step); bfloat16 under ``test_torch_port_bf16.py``'s rule.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_bf16 import (_as_written, assert_bf16_close,
                                  assert_nearer_overall)
from test_torch_port_maml import MAML_GRAD_ATOL
from torch_port_common import ATOL, GRAD_TOL, RTOL, t, to_numpy
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.models import mmaml_nets as jnets
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.train.mmaml import MMAMLBundle as JaxBundle
from wmfml_tpu.train.mmaml import build_mmaml_optimizer as jax_optimizer
from wmfml_tpu.train.mmaml import build_mmaml_outer as jax_outer
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables, mmaml_state_dict
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.models.mmaml_nets import MMAMLBundle
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.ops.cast import set_compute_dtype
from wmfml_tpu_torch.train.mmaml import (OUTER_GRAD_NORM_CLIP,
                                         build_mmaml_eval_step,
                                         build_mmaml_optimizer,
                                         build_mmaml_outer, clip_groups_)
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "cfg", "train", "MMAML_ShapeNet1D_DA+TA.yaml")
T_, S_, Q_, HW = 2, 3, 3, 32
SHOTS = (3, 2)
CH, DIMS, HIDDEN = 4, (8, 16, 32, 64), 16
CFG = dict(method="MMAMLShapeNet1D", task="shapenet_1d", aug_list=[],
           tasks_per_batch=T_, max_ctx_num=S_, query_num=Q_, num_updates=2,
           test_num_updates=2, first_order=False, update_lr=0.1, lr=1e-3,
           seed=0, loss_type="mse", device="cpu")


def _raw_batch(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        ctx_x=rng.randint(0, 255, (T_, S_, HW, HW, 1)).astype(np.uint8),
        ctx_y=rng.uniform(0, 2 * np.pi, (T_, S_, 1)).astype(np.float32),
        ctx_mask=np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None],
        qry_x=rng.randint(0, 255, (T_, Q_, HW, HW, 1)).astype(np.uint8),
        qry_y=rng.uniform(0, 2 * np.pi, (T_, Q_, 1)).astype(np.float32))


def _torch_batch(seed=0):
    return {k: t(v) for k, v in _raw_batch(seed).items()}


def _jax_bundle(condition="affine", rnn=False, dtype=None):
    return JaxBundle(
        gated=jnets.GatedConvNet(output_dim=2, num_channels=CH,
                                 condition_type=condition, tanh_out=True,
                                 dtype=dtype),
        embed=jnets.ConvEmbeddingNet(embedding_dims=DIMS, num_channels=CH,
                                     hidden_size=HIDDEN, rnn_aggregation=rnn,
                                     dtype=dtype))


def _init(bundle, x):
    """JAX's initial parameters of ``bundle`` on one task's images x."""
    @jax.jit
    def init(x):
        evars = bundle.embed.init({"params": jax.random.PRNGKey(0)}, x)
        gvars = bundle.gated.init({"params": jax.random.PRNGKey(1)}, x,
                                  embeddings=bundle.embed.apply(evars, x))
        return {"model": gvars["params"], "embedding": evars["params"]}

    return to_numpy(init(x))


@functools.lru_cache(maxsize=None)
def _jax_params(condition="affine", rnn=False):
    """JAX parameters of the small bundle."""
    return _init(_jax_bundle(condition, rnn),
                 np.random.RandomState(9).rand(S_, HW, HW, 1).astype(
                     np.float32))


def _port_bundle(condition="affine", rnn=False, params=None):
    model = MMAMLBundle(output_dim=2, num_channels=CH,
                        condition_type=condition, embedding_dims=DIMS,
                        hidden_size=HIDDEN, rnn_aggregation=rnn,
                        generator=torch.Generator().manual_seed(0))
    return load_jax_variables(model, {"params": params or _jax_params(
        condition, rnn)})


def _images(seed, n=S_):
    return np.random.RandomState(seed).rand(T_, n, HW, HW, 1).astype(
        np.float32)


def _mask():
    return np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None]


def _jax_forward(bundle, params, x, mask):
    """JAX's per-task forward under vmap: (embeddings, gated output)."""
    def one(xi, mi):
        embs = bundle.embed.apply({"params": params["embedding"]}, xi,
                                  mask=mi)
        out = bundle.gated.apply({"params": params["model"]}, xi,
                                 embeddings=embs, mask=mi)
        return embs, out

    if mask is None:
        return jax.jit(jax.vmap(lambda xi: one(xi, None)))(x)
    return jax.jit(jax.vmap(one))(x, mask)


def _port_forward(model, x, mask):
    with torch.no_grad():
        embs = model.embedding_model(x, mask)
        return embs, model.model(x, embs, mask)


# -- the two networks --------------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("condition", ["affine", "sigmoid_gate", "softmax"])
def test_forward_matches_jax(condition, masked):
    x = _images(2)
    mask = _mask() if masked else None
    if masked:
        x[1, 2] = 5.0                      # a padded row must not count
    want_embs, want = _jax_forward(_jax_bundle(condition),
                                   _jax_params(condition), x, mask)
    model = _port_bundle(condition)
    embs, got = _port_forward(model, t(x), None if mask is None else t(mask))
    assert [tuple(e.shape) for e in embs] == [(T_, d) for d in DIMS]
    for e, w in zip(embs, want_embs):
        np.testing.assert_allclose(e.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # the modulation moves the output beyond the tolerance
    with torch.no_grad():
        plain = model.model(t(x), None, None if mask is None else t(mask))
    assert (plain - got).abs().max().item() > 100 * ATOL


def test_max_pooling_matches_jax():
    """``embedding_pooling: max`` over the task's real instances."""
    x = _images(5)
    x[1, 2] = 5.0                          # a padded row must not count
    jnet = jnets.ConvEmbeddingNet(embedding_dims=DIMS, num_channels=CH,
                                  hidden_size=HIDDEN, embedding_pooling="max")
    params = _jax_params()["embedding"]
    want = jax.jit(jax.vmap(lambda xi, mi: jnet.apply(
        {"params": params}, xi, mask=mi)))(x, _mask())
    model = MMAMLBundle(output_dim=2, num_channels=CH, embedding_dims=DIMS,
                        hidden_size=HIDDEN, embedding_pooling="max")
    load_jax_variables(model, {"params": _jax_params()})
    with torch.no_grad():
        got = model.embedding_model(t(x), t(_mask()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_gru_aggregation_matches_jax():
    """``rnn_aggregation``: the bidirectional two-layer GRU carried over
    with b_hr = b_hz = 0, on a masked episode."""
    x = _images(3)
    bundle = _jax_bundle(rnn=True)
    params = _jax_params(rnn=True)
    want = jax.jit(jax.vmap(lambda xi, mi: bundle.embed.apply(
        {"params": params["embedding"]}, xi, mask=mi)))(x, _mask())
    model = _port_bundle(rnn=True)
    assert "embedding_model._rnn.weight_hh_l1_reverse" in model.state_dict()
    assert "embedding_model.linear.weight" not in model.state_dict()
    with torch.no_grad():
        got = model.embedding_model(t(x), t(_mask()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_gru_padded_episode_equals_its_truncation():
    """The carry holds on masked steps, and BN counts only real rows: a
    padded task's embeddings are its truncation's; the instance order
    matters (the average would not see it)."""
    model = _port_bundle(rnn=True)
    x = t(_images(4))
    with torch.no_grad():
        padded = model.embedding_model(x, t(_mask()))
        cut = model.embedding_model(x[1:, :SHOTS[1]],
                                    torch.ones(1, SHOTS[1], dtype=torch.bool))
        swapped = model.embedding_model(x[:1, [1, 0, 2]], None)
        full = model.embedding_model(x[:1], None)
    for a, b in zip(padded, cut):
        np.testing.assert_allclose(a[1:].numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)
    assert any((a - b).abs().max().item() > 1e-4
               for a, b in zip(swapped, full))


# -- the outer loss, its gradients and the eval loss ----------------------------------

def _configs(**over):
    cfg = dict(CFG, **over)
    return JaxConfig.from_dict(cfg), Config.from_dict(cfg)


@functools.lru_cache(maxsize=None)
def _jax_outer_grad(first_order):
    jcfg, _ = _configs(first_order=first_order)
    outer = jax_outer(_jax_bundle(), jcfg, 2, train=True, test=False)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: outer(p, b, jax.random.PRNGKey(0))))
    return to_numpy(fn(_jax_params(), _raw_batch()))


def _assert_grads(model, jax_grads):
    want = mmaml_state_dict({"params": jax_grads})
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        atol = max(GRAD_TOL["atol"], MAML_GRAD_ATOL * np.abs(w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name,
                                   rtol=GRAD_TOL["rtol"], atol=atol)


@pytest.mark.parametrize("first_order", [False, True])
def test_outer_loss_and_grads_match_jax(first_order):
    want_loss, want_grads = _jax_outer_grad(first_order)
    _, pcfg = _configs(first_order=first_order)
    model = _port_bundle()
    loss = build_mmaml_outer(model, pcfg, 2, train=True, test=False)(
        _torch_batch())
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    loss.backward()
    _assert_grads(model, want_grads)
    # the embedding net is reached through the modulation, in both orders
    for name, p in model.embedding_model.named_parameters():
        assert p.grad.abs().max().item() > 0, name


def test_second_order_terms_are_what_the_test_sees():
    """The two orders' gradients differ by far more than the tolerance, so
    the test above tells them apart."""
    second = _jax_outer_grad(False)[1]
    first = _jax_outer_grad(True)[1]
    diffs = jax.tree_util.tree_map(
        lambda a, b: np.abs(a - b).max() / max(np.abs(a).max(), 1e-12),
        second, first)
    assert max(jax.tree_util.tree_leaves(diffs)) > 10 * MAML_GRAD_ATOL


def test_eval_degree_loss_matches_jax():
    jcfg, pcfg = _configs()
    jouter = jax_outer(_jax_bundle(), jcfg, 2, train=False, test=True)
    want = jax.jit(lambda p, b: jouter(p, b, jax.random.PRNGKey(0)))(
        _jax_params(), _raw_batch(1))
    got = build_mmaml_eval_step(_port_bundle(), pcfg)(_torch_batch(1))
    assert not got.requires_grad
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


# -- one optimizer step ----------------------------------------------------------------

def test_optimizer_step_matches_optax():
    """Each group clipped to global norm 2 on its own (the gated net's
    gradients scaled above it, the embedding net's below), then Adam, twice;
    against ``build_mmaml_optimizer``."""
    params = _jax_params()
    rng = np.random.RandomState(5)
    jcfg, pcfg = _configs()

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda a: (scale * rng.randn(*a.shape)).astype(np.float32),
            params)

    grads = [{"model": draw(1.0)["model"], "embedding": draw(1e-3)[
        "embedding"]} for _ in range(2)]
    norms = [{k: float(optax.global_norm(g[k])) for k in g} for g in grads]
    assert all(n["model"] > OUTER_GRAD_NORM_CLIP > n["embedding"]
               for n in norms)

    tx = jax_optimizer(jcfg)

    @jax.jit
    def steps(params, grads):
        state = tx.init(params)
        for g in grads:
            updates, state = tx.update(g, state, params)
            params = optax.apply_updates(params, updates)
        return params

    want = steps(params, grads)

    model = _port_bundle()
    opt = build_mmaml_optimizer(model, pcfg)
    assert [grp["name"] for grp in opt.param_groups] == ["model", "embedding"]
    for g in grads:
        sd = mmaml_state_dict({"params": to_numpy(g)})
        for name, p in model.named_parameters():
            p.grad = sd[name].clone()
        clip_groups_(opt)
        opt.step()
    want_sd = mmaml_state_dict({"params": to_numpy(want)})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_gru_bundle_trains_one_step_as_jax():
    """``rnn_aggregation``: the hidden side's r and z biases start at 0 and
    never enter the function (Flax's ``GRUCell`` has none), so the outer
    loss and both nets' gradients are JAX's and theirs is 0; a clipped Adam
    step (``test_optimizer_step_matches_optax`` holds it to optax) keeps
    them at 0."""
    fresh = MMAMLBundle(output_dim=2, num_channels=CH, embedding_dims=DIMS,
                        hidden_size=HIDDEN, rnn_aggregation=True,
                        generator=torch.Generator().manual_seed(1))
    r_z = slice(0, 2 * HIDDEN)

    def biases(model):
        return [p for n, p in model.embedding_model._rnn.named_parameters()
                if n.startswith("bias_hh")]

    assert len(biases(fresh)) == 4
    assert all(torch.all(b[r_z] == 0) and torch.all(b[2 * HIDDEN:] != 0)
               for b in biases(fresh))

    jcfg, pcfg = _configs()
    outer = jax_outer(_jax_bundle(rnn=True), jcfg, 2, train=True, test=False)
    want_loss, want_grads = to_numpy(jax.jit(jax.value_and_grad(
        lambda p, b: outer(p, b, jax.random.PRNGKey(0))))(
            _jax_params(rnn=True), _raw_batch()))
    model = _port_bundle(rnn=True)
    with torch.no_grad():                    # values that must not count
        for b in biases(model):
            b[r_z] = 5.0
    loss = build_mmaml_outer(model, pcfg, 2, train=True, test=False)(
        _torch_batch())
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    loss.backward()
    _assert_grads(model, want_grads)          # JAX's b_hr, b_hz grads are 0
    with torch.no_grad():
        for b in biases(model):
            b[r_z] = 0.0
    before = [b.detach().clone() for b in biases(model)]
    opt = build_mmaml_optimizer(model, pcfg)
    clip_groups_(opt)
    opt.step()
    for b, b0 in zip(biases(model), before):
        assert torch.all(b[r_z] == 0)
        assert torch.all(b[2 * HIDDEN:] != b0[2 * HIDDEN:])


def test_clip_matches_optax_formula():
    """Above the norm a gradient becomes g / |g| * 2 (no epsilon); below it
    stays as it is, bit for bit."""
    p = torch.nn.Parameter(torch.zeros(3))
    q = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.Adam([{"params": [p]}, {"params": [q]}])
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    q.grad = torch.tensor([0.6, 0.8])
    clip_groups_(opt)
    want = optax.clip_by_global_norm(2.0).update(
        {"p": jnp.asarray([3.0, 4.0, 0.0])}, None)[0]["p"]
    assert torch.equal(p.grad, t(np.asarray(want)))
    assert torch.equal(q.grad, torch.tensor([0.6, 0.8]))


# -- bfloat16 ----------------------------------------------------------------------------

def test_bf16_forward_and_step_follow_the_bf16_rule():
    """``compute_dtype: bfloat16``: both nets' outputs, then one
    second-order outer step's loss and gradients (float32 parameters and
    gradients), against JAX in bfloat16 and in float32."""
    x, mask = _images(6), _mask()
    params = _jax_params()
    fwd = {dt: _jax_forward(_jax_bundle(dtype=dt), params, x, mask)
           for dt in (jnp.bfloat16, None)}
    model = set_compute_dtype(_port_bundle(), torch.bfloat16)
    embs, got = _port_forward(model, t(x), t(mask))
    assert got.dtype == torch.bfloat16
    for i, e in enumerate(embs):
        assert_bf16_close(e, fwd[jnp.bfloat16][0][i], fwd[None][0][i],
                          f"embedding {i}")
    assert_bf16_close(got, fwd[jnp.bfloat16][1], fwd[None][1], "output")

    want = {}
    for dtype in ("bfloat16", "float32"):
        jcfg, pcfg = _configs(compute_dtype=dtype)
        outer = jax_outer(_jax_bundle(dtype=jnp.bfloat16 if dtype ==
                                      "bfloat16" else None), jcfg, 2,
                          train=True, test=False)
        loss, grads = _as_written(jax.jit(jax.value_and_grad(
            lambda p, b: outer(p, b, jax.random.PRNGKey(0)))), params,
            _raw_batch())
        want[dtype] = (loss, mmaml_state_dict({"params": to_numpy(grads)}))
    _, pcfg = _configs(compute_dtype="bfloat16")
    loss = build_mmaml_outer(model, pcfg, 2, train=True, test=False)(
        _torch_batch())
    assert loss.dtype == torch.float32
    assert_bf16_close(loss, want["bfloat16"][0], want["float32"][0], "loss")
    loss.backward()
    distances = []
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        distances.append(assert_bf16_close(
            p.grad, want["bfloat16"][1][name], want["float32"][1][name],
            name, nearer=False))
    assert_nearer_overall(distances, "gradients")


# -- the registry's widths, the weight carry, the trainer ---------------------------------

def test_registry_full_widths_match_jax():
    """MMAMLShapeNet1D as the shipped YAML builds it: 128 x 128 x 1, gated
    channels 32-256, embedding dims 64-512, one forward of 3 images."""
    pcfg = Config(YAML, ["device=cpu"], make_dirs=False)
    jbundle = jax_build_model(JaxConfig.from_dict(dict(
        CFG, tasks_per_batch=1, max_ctx_num=3)))
    x = np.random.RandomState(7).rand(1, 3, 128, 128, 1).astype(np.float32)
    params = _init(jbundle, x[0])
    model = load_jax_variables(build_model(pcfg), {"params": params})
    assert pcfg.rnn_aggregation is False
    sd = model.state_dict()
    assert tuple(sd["model.features.layer4_conv.weight"].shape) == (
        256, 128, 3, 3)
    assert tuple(sd["embedding_model._embeddings.3.weight"].shape) == (
        512, 128)
    want_embs, want = _jax_forward(jbundle, params, x, None)
    embs, got = _port_forward(model, t(x), None)
    for e, w in zip(embs, want_embs):
        np.testing.assert_allclose(e.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_port_state_dict_imports_into_jax():
    from wmfml_tpu.ckpt.torch_import import (import_torch_checkpoint,
                                             state_dict_to_numpy)

    model = MMAMLBundle(output_dim=2, num_channels=CH, embedding_dims=DIMS,
                        hidden_size=HIDDEN,
                        generator=torch.Generator().manual_seed(3))
    assert {"model.features.layer1_conv.weight",
            "model.classifier.fully_connected.bias",
            "embedding_model.conv.conv4.bias",
            "embedding_model.conv.bn2.weight",
            "embedding_model.linear.weight",
            "embedding_model._embeddings.3.bias"} <= set(model.state_dict())
    imported = import_torch_checkpoint(
        "MMAMLShapeNet1D", state_dict_to_numpy(model.state_dict()))
    x, mask = _images(8), _mask()
    want_embs, want = _jax_forward(_jax_bundle(), imported["params"], x,
                                   mask)
    embs, got = _port_forward(model, t(x), t(mask))
    for e, w in zip(embs, want_embs):
        np.testing.assert_allclose(e.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_train_cli_runs_mmaml_and_validates(tmp_path, monkeypatch):
    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.data.synthetic import generate_shapenet1d
    from wmfml_tpu_torch.train.mmaml import MMAMLTrainer

    data = str(tmp_path / "sn1d")
    generate_shapenet1d(data, seed=0, instances=2 * S_ + 1, val_classes=3,
                        test_classes=2)
    monkeypatch.chdir(tmp_path)
    cfg = Config(YAML, ["device=cpu", f"data_path={data}", "data_size=small",
                        "iterations=2", "val_freq=1", "val_iters=1",
                        f"tasks_per_batch={T_}", f"max_ctx_num={S_}",
                        "num_updates=1", "test_num_updates=2"])
    assert (cfg.aug_list, cfg.first_order, cfg.update_lr, cfg.lr) == (
        ["data_aug", "task_aug"], False, 0.002, 0.0005)
    trainer = train_cli.train(cfg)
    assert isinstance(trainer, MMAMLTrainer) and trainer.step == 2
    assert trainer.best_loss["validation"] < 10000.0
    assert len(trainer.optimizer.param_groups) == 2
    metrics = trainer.train_step.metrics
    assert metrics["kl"] == 0.0 and metrics["contra"] == 0.0
    assert float(metrics["loss"]) == float(metrics["task_loss"])
    names = sorted(os.listdir(os.path.join(cfg.save_path, "models")))
    assert names == ["model_best_test.pt", "model_best_validation.pt",
                     "model_end_2.pt", "model_intermediate.pt"]
    with open(os.path.join(cfg.save_path, "metrics.jsonl")) as f:
        tags = [line.split('"tag": "')[1].split('"')[0] for line in f]
    assert tags.count("Loss/train") == 2 and tags.count("Loss/validation") == 2

    # the checkpoint restores into a fresh trainer, Adam's two groups too
    resumed = train_cli.build_trainer(Config(YAML, [
        "device=cpu", f"data_path={data}", "data_size=small",
        f"tasks_per_batch={T_}", f"max_ctx_num={S_}",
        f"checkpoint={trainer.ckpt.path('model_end_2')}"]))
    assert resumed.step == 2
    for a, b in zip(resumed.model.parameters(), trainer.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(resumed.optimizer.state_dict()["state"][0]["exp_avg"],
                       trainer.optimizer.state_dict()["state"][0]["exp_avg"])
