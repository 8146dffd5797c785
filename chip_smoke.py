#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of the
                                     # training step (top kernels, busy share)

Phases, each fatal on failure (nothing is caught and reported as ok):
  1. the card's name and power limit (nvidia-smi); TF32 off for cuDNN and
     matmul, so every float32 comparison below is a float32 one;
  2. build of every kernel of the main path from ``wmfml_tpu_torch/csrc``
     (one nvcc per source, all started together);
  3. each kernel at the main path's shapes against its plain PyTorch twin on
     the same inputs, within the tolerance stated beside it; kernel, plain
     and library times by CUDA events;
  4. the main path itself: ANPShapeNet1D meta-training through
     ``wmfml_tpu_torch.cli.train_cli`` at full width (T=10, 15 + 15,
     128x128x1, dim_w 64, 8 FAVOR heads, m=266) on synthetic ShapeNet1D
     ``data_size=large`` with task augmentation, 24 steps and one validation;
     launch counts are zeroed just before and read just after, and each
     kernel must have launched; the trained model's output on a validation
     episode must agree with the same model run through the plain twins;
  5. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Exits non-zero, printing no result, without a CUDA device or without the
repository around it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_YAML = os.path.join(HERE, "cfg", "train", "ANP_DA+TA_ShapeNet1D.yaml")
TRAIN_OVERRIDES = ["aug_list=[task_aug]", "data_size=large",
                   "synthetic_data=true", "iterations=24", "val_freq=1000",
                   "val_iters=2", "steps_per_call=1", "device=cuda"]

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# max |kernel - plain| <= ATOL + RTOL * |plain|, elementwise; both sides are
# float32 sums taken in another order (<= 297 terms for the stem, 64 + 266
# for FAVOR+), so they agree to a few float32 ulps of the largest term
TOL = {"literature_stem": (1e-4, 1e-4), "favor_attention": (1e-5, 1e-4)}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=30, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, rounds=2):
    """Mean ms of each function, timed in turns a, b, c, c, b, a, ..."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(cuda_ms(fns[k]))
    return {k: sum(v) / len(v) for k, v in times.items()}


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_close(name, got, want):
    import torch

    atol, rtol = TOL[name]
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    nan_equal = torch.isnan(got) == torch.isnan(want)
    if bool(bad.any()) or not bool(nan_equal.all()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain twin: max abs err "
            f"{err.max().item()} (atol {atol}, rtol {rtol})")
    finite = ~torch.isnan(want)
    rel = (err[finite] / want[finite].abs().clamp_min(atol)).max().item()
    return err[finite].max().item(), rel


def check_stem(model, gen):
    """K1 at the main path's shape: the merged ctx+qry batch, 300 images."""
    import torch
    import torch.nn.functional as F

    from wmfml_tpu_torch.kernels import stem

    enc = model.encoder_w0
    w0, b0, w1, b1 = (p.detach() for p in (enc[0].weight, enc[0].bias,
                                           enc[2].weight, enc[2].bias))
    b, h, w = 10 * 30, 128, 128
    x = torch.rand((b, h, w, 1), generator=gen, device="cuda")
    got = stem.stem_launch(x, w0, b0, w1, b1)
    want = stem.stem_plain(x, w0, b0, w1, b1)
    torch.cuda.synchronize()
    err, rel = check_close("literature_stem", got, want)
    xn = x.permute(0, 3, 1, 2).contiguous()

    def library():      # cuDNN yardstick, NCHW; never called by the port
        a = F.relu(F.conv2d(xn, w0, b0, stride=2, padding=1))
        a = F.relu(F.conv2d(a, w1, b1, stride=2, padding=1))
        return F.max_pool2d(a, 2)

    times = in_turns({"ms": lambda: stem.stem_launch(x, w0, b0, w1, b1),
                      "plain_ms": lambda: stem.stem_plain(x, w0, b0, w1, b1),
                      "library_ms": library})
    flops = 2 * b * ((h // 2) * (w // 2) * 32 * 9 * 1
                     + (h // 4) * (w // 4) * 48 * 9 * 32)
    nbytes = 4 * (x.numel() + got.numel() + sum(t.numel() for t in
                                                 (w0, b0, w1, b1)))
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(name="literature_stem", route="cuda",
                source="wmfml_tpu_torch/csrc/stem.cu",
                replaces="wmfml_tpu/nn/encoders.py:230",
                max_abs_err=err, max_rel_err=rel, **times, bound_ms=bound_ms,
                bound_by=bound_by)


def check_favor(model, gen):
    """K2 at the main path's shape, with shots 3..15 across the 10 tasks."""
    import torch

    from wmfml_tpu_torch.kernels import favor

    proj = model.attn.projection_matrix
    t_, h, n, d = 10, 8, 15, proj.shape[1]
    q, k, v = (torch.randn((t_, h, n, d), generator=gen, device="cuda")
               for _ in range(3))
    shots = torch.tensor([3 + (12 * i) // (t_ - 1) for i in range(t_)],
                         device="cuda")
    mask = torch.arange(n, device="cuda")[None, :] < shots[:, None]
    got = favor.favor_launch(q, k, v, proj, mask)
    want = favor.favor_plain(q, k, v, proj, mask)
    torch.cuda.synchronize()
    err, rel = check_close("favor_attention", got, want)
    times = in_turns({"ms": lambda: favor.favor_launch(q, k, v, proj, mask),
                      "plain_ms": lambda: favor.favor_plain(q, k, v, proj,
                                                            mask)})
    m, e = proj.shape[0], v.shape[-1]
    # the kernel's form: features of q and k, A = q' k'^T, A v and row sums
    flops = 2 * t_ * h * (2 * n * m * d + n * n * m + n * n * e + n * n)
    nbytes = 4 * (4 * q.numel() + proj.numel()) + mask.numel()
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(name="favor_attention", route="cuda",
                source="wmfml_tpu_torch/csrc/favor.cu",
                replaces="wmfml_tpu/nn/attention.py:93",
                max_abs_err=err, max_rel_err=rel, **times, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def train_phase(card):
    """Drive the port's main path; return (trainer, launches per kernel)."""
    import torch

    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.kernels.favor import favor_attention
    from wmfml_tpu_torch.kernels.stem import literature_stem

    config = Config(MAIN_YAML, TRAIN_OVERRIDES)
    literature_stem.launches = 0
    favor_attention.launches = 0
    t0 = time.perf_counter()
    trainer = train_cli.train(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"literature_stem": literature_stem.launches,
                "favor_attention": favor_attention.launches}

    with open(os.path.join(config.save_path, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    tags = {r["tag"] for r in records}
    if not {"Loss/train", "Loss/validation", "Loss/test"} <= tags:
        raise AssertionError(f"missing metrics: {sorted(tags)}")
    if not all(math.isfinite(r["value"]) for r in records):
        raise AssertionError(f"non-finite loss in {records}")
    steps, secs = trainer.timing["steps"], trainer.timing["seconds"]
    if trainer.step != 24 or steps <= 0:
        raise AssertionError(f"trainer ran {trainer.step} steps "
                             f"({steps} timed)")
    ms_step = 1e3 * secs / steps
    log(f"train: {trainer.step} steps in {wall:.3f} s wall; "
        f"{ms_step} ms/step, {config.tasks_per_batch * 1e3 / ms_step} "
        f"tasks/s over {steps} timed steps on {card}")
    log("train: " + ", ".join(f"{r['tag']} {r['value']}" for r in records))
    for name, n in launches.items():
        log(f"train: {name} launches {n}")
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    return trainer, launches


def check_trained_output(trainer):
    """The trained model on a validation episode: kernels vs plain twins."""
    import copy

    import torch

    from wmfml_tpu_torch.aug.pipeline import build_episode_processor
    from wmfml_tpu_torch.train.trainer import episode_to_device

    cfg, data = trainer.config, trainer.data
    data.reset_eval("validation", seed=42)
    raw = data.get_batch("validation", cfg.tasks_per_batch, cfg.max_ctx_num)
    process = build_episode_processor(cfg.task, [], train=False)
    cpu_model = copy.deepcopy(trainer.model).cpu().eval()
    outs = []
    with torch.no_grad():
        for model, dev in ((trainer.model.eval(), "cuda"), (cpu_model, "cpu")):
            b = process(episode_to_device(raw, dev))
            outs.append(model(b["ctx_x"], b["ctx_y"], b["qry_x"],
                              ctx_mask=b["ctx_mask"]).mu.cpu())
    got, want = outs
    t_, q = cfg.tasks_per_batch, cfg.query_num
    if tuple(got.shape) != (t_, q, 2) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"bad model output {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    log(f"output: trained model on the card vs on the CPU (plain twins): "
        f"max abs err {err} over {tuple(got.shape)}")
    if err > 1e-4:
        raise AssertionError(f"card and CPU outputs differ by {err}")


def profile_steps(trainer, steps=8):
    """torch.profiler over a few training steps: top kernels, busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = trainer.config
    for _ in range(2):
        trainer.train_step(trainer.sampler.sample(cfg.tasks_per_batch,
                                                  trainer.generator),
                           trainer.generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(trainer.sampler.sample(cfg.tasks_per_batch,
                                                      trainer.generator),
                               trainer.generator)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    busy_us, last_end = 0.0, float("-inf")       # union of kernel intervals
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in kernels):
        busy_us += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    log(f"profile: {steps} steps, {wall_us / steps} us/step wall, device "
        f"busy {busy_us / steps} us/step = {busy_us / wall_us} of the wall "
        f"time ({len(kernels) / steps} kernels/step)")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"profile: {us / steps:10.3f} us/step  {name[:110]}")
    os.makedirs(os.path.join(HERE, "results"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(HERE, "results",
                                          "train_step_trace.json"))


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.kernels import build
    from wmfml_tpu_torch.models.registry import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, TF32 off for cuDNN and matmul")

    t0 = time.perf_counter()
    build.load_all()
    log(f"build: {', '.join(build.SOURCES)} in {time.perf_counter() - t0} s")
    for name, text in build.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    model = build_model(Config(MAIN_YAML, TRAIN_OVERRIDES,
                               make_dirs=False)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_stem(model, gen), check_favor(model, gen)]
    for r in rows:
        log(f"kernel: {r['name']}: max abs err {r['max_abs_err']}, max rel "
            f"err {r['max_rel_err']} (atol, rtol {TOL[r['name']]}); "
            f"{r['ms']} ms, plain "
            f"{r['plain_ms']} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']} ms by {r['bound_by']}")

    trainer, launches = train_phase(card)
    check_trained_output(trainer)
    if "--profile" in argv:
        profile_steps(trainer)

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
