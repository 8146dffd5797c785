"""Worker of ``tests/test_torch_port_tp.py``: one rank of a 4-rank gloo
world on the CPU, spawned as ``tests/_torch_dp_worker.py`` is, on the mesh
``{data: 2, model: 2}`` (``wmfml_tpu_torch/parallel/mesh.py``).

Each case runs on that mesh and, where it is held against one process,
again without a mesh from the same seeds; the worker writes both results
into ``<workdir>/rank<r>.pkl`` and the test compares them:

  * ``jax_tp``: the JAX package's tensor-parallel step's configuration
    (``tests/test_mesh.py:42-90``: CondNeuralProcess on ShapeNet3D at
    32 x 32), its weights and batch, placed by ``shard_state`` and
    stepped by ``build_train_step(state_sharding=...)``, an SGD step on
    both sides (Adam's first step divides near-zero gradients by their own
    size, where float32 reordering moves one element by two thousandths of
    the learning rate): the loss, the whole parameters after the step
    (``full_state_dict``), the keys placed, and the shard shapes of the
    parameters and of Adam's moments after an Adam step more;
  * ``anp``, ``anp_mr``: ANPShapeNet1D and ANPMRShapeNet1D at small widths
    with ``min_size`` lowered to ``MIN_SIZE`` (K1's conv1, the attention
    heads, the BBB layers' posteriors split), image DA and TA, one SGD step
    (Adam's first step turns the float32 reordering of ANP's near-zero
    key-bias gradients into a tenth of the learning rate,
    ``_torch_dp_worker.py:anp``), against one process: the loss, the whole
    parameters and gradients;
  * ``cli``: a CNPShapeNet1D trainer built by ``train_cli`` on the mesh
    (the state whole on every rank, as the JAX trainer keeps it), 2 steps,
    against one process;
  * ``order``: each rank's (data index, model index) on ``{data: 2, model:
    2}`` and on ``{model: 2, data: 2}``.

    python tests/_torch_tp_worker.py <rank> <world> <port> <workdir>
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from wmfml_tpu_torch.ckpt.jax_params import full_state_dict, load_jax_variables
from wmfml_tpu_torch.cli import train_cli
from wmfml_tpu_torch.cli.common import start_mesh
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.parallel import mesh, tp
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import build_train_step

MESH = {"data": 2, "model": 2}
MIN_SIZE = 8192
T, S, Q, HW = 4, 4, 3, 32
SMALL = dict(dim_w=32, n_hidden_units_r=[32, 32], dim_r=32, dim_z=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_YAML = os.path.join(REPO, "cfg", "train", "ANP_DA+TA_ShapeNet1D.yaml")


def _numpy(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def jax_tp(workdir, ctx):
    with open(os.path.join(workdir, "jax_tp_inputs.pkl"), "rb") as f:
        variables, batch = pickle.load(f)
    cfg = Config.from_dict(dict(
        method="CondNeuralProcess", task="shapenet_3d", agg_mode="mean",
        img_agg="reshape", aug_list=[], loss_type="mse", tasks_per_batch=4,
        max_ctx_num=3, query_num=3, lr=1e-3, seed=0, gen_bg=False,
        device="cpu", optimizer="SGD"))
    cfg.img_size = [32, 32, 4]
    model = build_model(cfg)
    placement = mesh.shard_state(ctx, model)
    load_jax_variables(model, variables)
    opt = build_optimizer(cfg, model.parameters())
    step = build_train_step(model, opt, cfg, state_sharding=placement)
    batch = ctx.local_batch({k: torch.from_numpy(np.asarray(v))
                             for k, v in batch.items()})
    loss = float(step(batch, torch.Generator().manual_seed(0)))
    params = _numpy(full_state_dict(model))
    # then an Adam step on the shards: its moments are the shards' shape
    adam = torch.optim.Adam(model.parameters(), lr=1e-3)
    build_train_step(model, adam, cfg, state_sharding=placement)(
        batch, torch.Generator().manual_seed(0))
    shards = {name: (tuple(p.shape), tp.shard_of(p)[2],
                     sorted(tuple(v.shape) for v in adam.state[p].values()
                            if torch.is_tensor(v) and v.dim()))
              for name, p in model.named_parameters() if tp.shard_of(p)}
    return (loss, params,
            sorted(k for k, d in placement.items() if d is not None), shards)


def _raw(seed):
    rng = np.random.RandomState(seed)
    lab = lambda n: rng.uniform(0, 2 * np.pi, (T, n, 1)).astype(np.float32)  # noqa: E731
    img = lambda n: rng.randint(0, 255, (T, n, HW, HW, 1)).astype(np.uint8)  # noqa: E731
    return {k: torch.from_numpy(v) for k, v in dict(
        ctx_x=img(S), ctx_y=lab(S), ctx_mask=np.ones((T, S), bool),
        qry_x=img(Q), qry_y=lab(Q)).items()}


def small_step(method, ctx):
    """One SGD step of ``method`` at small widths, placed over the model
    axis when ``ctx`` has one (``MIN_SIZE``): (loss, whole parameters,
    whole gradients, keys placed)."""
    cfg = Config.from_dict(dict(
        method=method, task="shapenet_1d", agg_mode="attention",
        aug_list=["data_aug", "task_aug"], tasks_per_batch=T, max_ctx_num=S,
        query_num=Q, lr=1e-2, seed=0, loss_type="mse", device="cpu",
        optimizer="SGD", beta=1e-3, **SMALL))
    cfg.img_size = [HW, HW, 1]
    torch.manual_seed(0)
    model = build_model(cfg)
    placed = []
    placement = None
    if ctx is not None:
        placement = mesh.shard_state(ctx, model, min_size=MIN_SIZE)
        placed = sorted(k for k, d in placement.items() if d is not None)
    opt = build_optimizer(cfg, model.parameters())
    step = build_train_step(model, opt, cfg, state_sharding=placement)
    batch = _raw(5)
    if ctx is not None:
        batch = ctx.local_batch(batch)
    loss = float(step(batch, torch.Generator().manual_seed(5)))
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad
        shard = tp.shard_of(p)
        grads[name] = (tp.gather(g, shard[0], shard[1]) if shard else g
                       ).numpy().copy()
    return loss, _numpy(full_state_dict(model)), grads, placed


def cli(workdir, with_mesh):
    """CNPShapeNet1D through ``train_cli``'s trainer, 2 steps: the whole
    parameters after them."""
    overrides = ["aug_list=[task_aug]", "device=cpu",
                 f"data_path={os.path.join(workdir, 'sn1d')}",
                 "data_size=small", "iterations=2", "val_freq=100",
                 "val_iters=1", f"tasks_per_batch={T}", f"max_ctx_num={S}",
                 "method=CNPShapeNet1D", "agg_mode=max", "dim_w=16",
                 "dim_r=12", "dim_z=8", "steps_per_call=1"]
    rank = dist.get_rank()
    if with_mesh:           # rank 0 writes the run directory
        overrides.append("mesh_shape={data: 2, model: 2}")
        root = os.path.join(workdir, "results_mesh")
    else:                   # every rank its own run, as one process
        root = os.path.join(workdir, f"results_{rank}")
    config = Config(MAIN_YAML, overrides, make_dirs=rank == 0 or not with_mesh,
                    results_root=root)
    ctx = start_mesh(config) if with_mesh else None
    try:
        trainer = train_cli.train(config)
    finally:
        mesh.use(None)
    return (_numpy(trainer.model.state_dict()),
            None if ctx is None else (ctx.n, ctx.model, ctx.index,
                                      ctx.model_rank, ctx.lead))


def main():
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    ctx = mesh.MeshContext.create(MESH, batch_divisor=T)
    out = {"jax_tp": None}
    mesh.use(ctx)
    out["jax_tp"] = jax_tp(workdir, ctx)
    for name, method in (("anp", "ANPShapeNet1D"),
                         ("anp_mr", "ANPMRShapeNet1D")):
        mesh.use(None)
        one = small_step(method, None)
        mesh.use(ctx)
        out[name] = (one, small_step(method, ctx))
    mesh.use(None)
    out["cli"] = (cli(workdir, False), cli(workdir, True))
    swapped = mesh.MeshContext.create({"model": 2, "data": 2})
    out["order"] = {"data_model": (ctx.index, ctx.model_rank),
                    "model_data": (swapped.index, swapped.model_rank)}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {rank}: ok", flush=True)


if __name__ == "__main__":
    main()
