"""Worker of ``tests/test_torch_port_dp.py``: one rank of a 2-rank gloo
world on the CPU, spawned as ``tests/_multihost_worker.py`` is.

Each path runs twice in the worker from the same seeds: without a mesh
(one process, the whole batch) and on the 2-rank mesh (this rank's tasks),
and the worker writes both results, rank by rank, into
``<workdir>/rank<r>.pkl``; the test compares them. The paths: CNPShapeNet1D
on device data, fused 2 steps (task aug); ANPShapeNet1D with image DA and
TA (the key stabiliser, the draws sliced); FCLCNPShapeNet1D (NT-Xent over
every rank's views); second-order MAMLShapeNet1D with DA; a masked loss
whose masks differ between the ranks (the refinement objective); the eval
steps of ANP and MAML on a whole batch; the JAX
package's 8-device step's configuration on its batch and weights; a run
saved and resumed on 2 ranks against an unbroken one; the shrink warning;
the groups of a ``model`` axis of 2.

    python tests/_torch_dp_worker.py <rank> <world> <port> <workdir>
"""

import logging
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from wmfml_tpu_torch.ckpt.checkpoint import CheckpointManager
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.device_sampler import DeviceEpisodeSampler
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.parallel import mesh
from wmfml_tpu_torch.train.maml import (build_maml_eval_step,
                                        build_maml_train_step)
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import (build_device_data_train_step,
                                         build_eval_step, build_refine_step,
                                         build_train_step)

T, S, Q, HW = 4, 4, 3, 32
SHOTS = (4, 3, 1, 2)        # 7 real rows on rank 0, 3 on rank 1
SMALL = dict(dim_w=16, n_hidden_units_r=[10, 10], dim_r=12, dim_z=8)
BASE = dict(task="shapenet_1d", tasks_per_batch=T, max_ctx_num=S,
            query_num=Q, lr=1e-4, seed=0, loss_type="mse", device="cpu",
            optimizer="Adam", **SMALL)


def _cfg(**kw):
    cfg = Config.from_dict(dict(BASE, **kw))
    cfg.img_size = [HW, HW, 1]
    return cfg


def _raw(seed=0, t=T):
    rng = np.random.RandomState(seed)
    lab = lambda n: rng.uniform(0, 2 * np.pi, (t, n, 1)).astype(np.float32)  # noqa: E731
    img = lambda n: rng.randint(0, 255, (t, n, HW, HW, 1)).astype(np.uint8)  # noqa: E731
    return {k: torch.from_numpy(v) for k, v in dict(
        ctx_x=img(S), ctx_y=lab(S),
        ctx_mask=np.arange(S)[None, :] < np.asarray(SHOTS[:t])[:, None],
        qry_x=img(Q), qry_y=lab(Q)).items()}


def _state(model):
    """The parameters after the step, and the gradients it averaged (the
    optimizer leaves them in place)."""
    return ({k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()},
            {k: p.grad.numpy().copy() for k, p in model.named_parameters()
             if p.grad is not None})


def _model(cfg):
    torch.manual_seed(0)
    return build_model(cfg)


def cnp_fused():
    cfg = _cfg(method="CNPShapeNet1D", agg_mode="max",
               aug_list=["task_aug"], steps_per_call=2)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 255, (6, 12, HW, HW, 1)).astype(np.uint8)
    y = rng.uniform(0, 1, (6, 12, 1)).astype(np.float32)
    sampler = DeviceEpisodeSampler(x, y, S, Q, 3, 2 * np.pi, "cpu")
    model = _model(cfg)
    opt = build_optimizer(cfg, model.parameters())
    mesh.broadcast_training_state(mesh.current(), model, opt)
    step = build_device_data_train_step(model, opt, cfg, sampler, 2)
    loss = step(torch.Generator().manual_seed(3))["loss"]
    return float(loss), _state(model)


def _one_step(cfg, seed=5, maml=False):
    model = _model(cfg)
    opt = build_optimizer(cfg, model.parameters())
    build = build_maml_train_step if maml else build_train_step
    step = build(model, opt, cfg)
    ctx = mesh.sharded()
    batch = _raw(seed)
    if ctx is not None:
        batch = ctx.local_batch(batch)
    loss = step(batch, torch.Generator().manual_seed(seed))
    return float(loss), _state(model)


def anp():
    """SGD: the key projections' bias gradients nearly cancel (about 5e-9
    against the step's 0.5), and Adam's first step, g / (|g| + 1e-8), turns
    their float32 rounding in another summation order into updates that
    differ by a tenth of the learning rate; the gradients are held
    (``test_torch_port_dp.py``)."""
    return _one_step(_cfg(method="ANPShapeNet1D", agg_mode="attention",
                          aug_list=["data_aug", "task_aug"],
                          optimizer="SGD"))


def fcl():
    return _one_step(_cfg(method="FCLCNPShapeNet1D", agg_mode="max",
                          aug_list=["task_aug"], contrastive=True,
                          contrastive_rate=1, temperature=0.07))


def maml():
    return _one_step(_cfg(method="MAMLShapeNet1D", aug_list=["data_aug"],
                          dim_w=36, num_filters=8, num_updates=2,
                          test_num_updates=2, first_order=False,
                          update_lr=0.1, beta=0.0, stem_impl="conv"),
                     maml=True)


def masked():
    """The refinement objective: the query loss masked by ``ctx_mask``, a
    mean over every task's real rows."""
    cfg = _cfg(method="CNPShapeNet1D", agg_mode="mean", aug_list=[])
    model = _model(cfg)
    opt = build_optimizer(cfg, model.parameters())
    step = build_refine_step(model, opt, cfg)
    batch = _raw(7)
    batch["qry_x"], batch["qry_y"] = batch["ctx_x"], batch["ctx_y"]
    ctx = mesh.sharded()
    if ctx is not None:
        batch = ctx.local_batch(batch)
    loss = step(batch, torch.Generator().manual_seed(7))
    return float(loss), _state(model)


def evaluation():
    """The eval steps (ANP's, second-order MAML's with its inner steps) on
    a whole batch: each rank scores its tasks, the losses are averaged;
    (loss, the most tasks a forward saw)."""
    out = {}
    for name, cfg, build in (
            ("anp", _cfg(method="ANPShapeNet1D", agg_mode="attention",
                         aug_list=[]), build_eval_step),
            ("maml", _cfg(method="MAMLShapeNet1D", aug_list=[], dim_w=36,
                          num_filters=8, num_updates=2, test_num_updates=3,
                          update_lr=0.1, beta=0.0, stem_impl="conv"),
             build_maml_eval_step)):
        model, seen = _model(cfg), []
        model.register_forward_pre_hook(
            lambda m, args: seen.append(args[0].shape[0]))
        out[name] = (float(build(model, cfg)(_raw(9))), max(seen))
    return out


def jax8(workdir):
    """The JAX package's ``test_sharded_step_matches_single_device``
    configuration, batch and initial weights (written by the test)."""
    with open(os.path.join(workdir, "jax8_inputs.pkl"), "rb") as f:
        variables, batch = pickle.load(f)
    cfg = Config.from_dict(dict(
        method="CNPShapeNet1D", task="shapenet_1d", agg_mode="max",
        aug_list=[], tasks_per_batch=8, checkpoint="", loss_type="mse",
        max_ctx_num=5, query_num=4, lr=1e-4, optimizer="Adam", seed=0,
        device="cpu", dim_w=64, n_hidden_units_r=[100, 100], dim_r=64,
        dim_z=64))
    cfg.img_size = [32, 32, 1]
    model = load_jax_variables(build_model(cfg), variables)
    opt = build_optimizer(cfg, model.parameters())
    step = build_train_step(model, opt, cfg)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    ctx = mesh.sharded()
    if ctx is not None:
        batch = ctx.local_batch(batch)
    loss = step(batch, torch.Generator().manual_seed(0))
    return float(loss), _state(model)


def resumed(workdir, ctx):
    """Three fused calls unbroken, against one call, a checkpoint written
    by rank 0 and read by both, and two more calls from it."""
    cfg = _cfg(method="CNPShapeNet1D", agg_mode="max", aug_list=["task_aug"])
    rng = np.random.RandomState(2)
    x = rng.randint(0, 255, (6, 12, HW, HW, 1)).astype(np.uint8)
    y = rng.uniform(0, 1, (6, 12, 1)).astype(np.float32)

    def fresh():
        model = _model(cfg)
        opt = build_optimizer(cfg, model.parameters())
        sampler = DeviceEpisodeSampler(x, y, S, Q, 3, 2 * np.pi, "cpu")
        return model, opt, build_device_data_train_step(model, opt, cfg,
                                                        sampler, 1)

    model, opt, step = fresh()
    gen = torch.Generator().manual_seed(11)
    for _ in range(3):
        step(gen)
    unbroken = _state(model)[0]
    model, opt, step = fresh()
    gen = torch.Generator().manual_seed(11)
    step(gen)
    ckpt = CheckpointManager(os.path.join(workdir, "run"))
    if ctx.lead:
        ckpt.save("model_intermediate", 1, model, opt, gen)
    dist.barrier()
    model, opt, step = fresh()
    gen = torch.Generator().manual_seed(0)
    ckpt.restore("model_intermediate", model, opt, generator=gen)
    mesh.broadcast_training_state(ctx, model, opt)
    for _ in range(2):
        step(gen)
    return unbroken, _state(model)[0]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def main():
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    ctx = mesh.MeshContext.create(batch_divisor=T)
    assert (ctx.n, ctx.rank, ctx.active) == (world, rank, True)
    out = {}
    for name, fn in (("cnp_fused", cnp_fused), ("anp", anp), ("fcl", fcl),
                     ("maml", maml), ("masked", masked),
                     ("jax8", lambda: jax8(workdir))):
        mesh.use(None)
        one = fn()
        mesh.use(ctx)
        out[name] = (one, fn())
    out["resumed"] = resumed(workdir, ctx)
    mesh.use(None)
    one = evaluation()
    mesh.use(ctx)
    out["evaluation"] = (one, evaluation())
    mesh.use(None)

    records = _Records()
    logging.getLogger("wmfml_tpu_torch").addHandler(records)
    shrunk = mesh.MeshContext.create(batch_divisor=3)
    out["shrink"] = (shrunk.n, shrunk.active, records.messages)
    tp_ctx = mesh.MeshContext.create({"data": 1, "model": 2})
    out["model_axis"] = (tp_ctx.n, tp_ctx.model, tp_ctx.index,
                         tp_ctx.model_rank, tp_ctx.active,
                         dist.get_world_size(tp_ctx.group),
                         dist.get_world_size(tp_ctx.model_group))
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {rank}: ok", flush=True)


if __name__ == "__main__":
    main()
