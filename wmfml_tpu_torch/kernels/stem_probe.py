"""K1 as every path but ``conv_bwd: phase`` launches it (no routes), and
K1b's library yardstick, on the card: the way to hold two trees of the
port against each other on one card in one run.

    python -m wmfml_tpu_torch.kernels.stem_probe --out change.jsonl
    PYTHONPATH=<another checkout> python <this file> --label parent \\
        --out parent.jsonl
    python <this file> --compare parent.jsonl change.jsonl ...

The second form runs K1 of whichever ``wmfml_tpu_torch`` the path gives
(the other tree builds its own ``_build/``); the probe uses only what every
tree since K1's bf16 path has: ``stem_launch`` with five arguments and
``stem_plain``. Run the trees in turns (parent, change, change, parent) in
one call: two calls may land on two cards.

Rows (inputs from ``torch.Generator(device="cuda").manual_seed(seed)``, the
row's index the seed, so every tree gets the same bits): K1 with weights
shared by the batch at ANP's [300, 128, 128, 1] and P3 T40's [1,200, 128,
128, 1], per task at MAML's [10 x 15, 128, 128, 1], in float32 and
bfloat16, and at Ci = 3 and 4 ([64, 64, 64, Ci], shared). One JSON line a
row: a SHA-256 of the output's bytes, its max abs error against
``stem_plain``, the kernel's device ms (torch.profiler, the mean of the
recorded launches) and the CUDA events' ms a call over 50 calls. Then
``library`` rows: K1b's yardstick, autodiff of ``stem_plain`` on cuDNN for
the four weight gradients at [300, 128, 128, 1] in float32 and bfloat16
(as ``chip_smoke.py:check_stem_backward`` times it), the CUDA events' ms
a call in five rounds and the cuDNN kernels the profiler saw, with their
device ms a call. Then the card's name and power limit.

``--compare`` reads such files in the order given and prints, per row,
whether every file's output hash is the same and each file's ms. The port
never imports this module.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

# (name, images, tasks (0: shared weights), H = W, Ci, dtype)
ROWS = (("shared_300", 300, 0, 128, 1, torch.float32),
        ("shared_300_bf16", 300, 0, 128, 1, torch.bfloat16),
        ("shared_1200_bf16", 1200, 0, 128, 1, torch.bfloat16),
        ("per_task_150", 150, 10, 128, 1, torch.float32),
        ("per_task_150_bf16", 150, 10, 128, 1, torch.bfloat16),
        ("ci3_64", 64, 0, 64, 3, torch.float32),
        ("ci4_64_bf16", 64, 0, 64, 4, torch.bfloat16))
LIBRARY = (("library_300", torch.float32),
           ("library_300_bf16", torch.bfloat16))


def inputs(seed, b, tasks, hw, ci, dtype):
    """Images in [0, 1) and weights at the encoder's initial scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = (tasks,) if tasks else ()

    def rand(*shape, scale=1.0):
        return scale * (2 * torch.rand(shape, generator=gen,
                                       device="cuda") - 1)

    x = torch.rand((b, hw, hw, ci), generator=gen, device="cuda")
    w0 = rand(*lead, 32, ci, 3, 3, scale=(9 * ci) ** -0.5)
    b0 = rand(*lead, 32, scale=0.1)
    w1 = rand(*lead, 48, 32, 3, 3, scale=288 ** -0.5)
    b1 = rand(*lead, 48, scale=0.1)
    return tuple(a.to(dtype) for a in (x, w0, b0, w1, b1))


def device_ms(fn, iters=20, kernels=None):
    """Device ms a call of the kernels ``fn`` launches; ``kernels``, a dict,
    gets each kernel name's device ms a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no kernel")
    if kernels is not None:
        for name, us in events:
            kernels[name] = kernels.get(name, 0.0) + us / iters / 1e3
    return sum(us for _, us in events) / iters / 1e3


def events_ms(fn, iters=50):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def probe(label):
    import hashlib

    from wmfml_tpu_torch.cli.common import set_numerics
    from wmfml_tpu_torch.kernels import stem

    set_numerics()
    rows = []
    for seed, (name, b, tasks, hw, ci, dtype) in enumerate(ROWS):
        args = inputs(seed, b, tasks, hw, ci, dtype)
        got = stem.stem_launch(*args)
        want = stem.stem_plain(*args)
        torch.cuda.synchronize()
        call = lambda: stem.stem_launch(*args)  # noqa: E731
        rows.append({
            "label": label, "row": name, "dtype": str(dtype)[6:],
            "shape": list(args[0].shape), "tasks": tasks,
            "sha256": hashlib.sha256(got.contiguous().view(
                torch.uint8).cpu().numpy().tobytes()).hexdigest(),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "device_ms": device_ms(call), "events_ms": events_ms(call)})
    for seed, (name, dtype) in enumerate(LIBRARY, len(ROWS)):
        x, *ws = inputs(seed, 300, 0, 128, 1, dtype)
        g = torch.randn((300, 16, 16, 48), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            seed)).to(dtype)
        leaves = [w.detach().requires_grad_() for w in ws]

        def library():
            return torch.autograd.grad(stem.stem_plain(x, *leaves), leaves,
                                       g)

        kernels = {}
        rows.append({
            "label": label, "row": name, "dtype": str(dtype)[6:],
            "events_ms_rounds": [events_ms(library) for _ in range(5)],
            "device_ms": device_ms(library, kernels=kernels),
            "kernels_ms": dict(sorted(kernels.items(),
                                      key=lambda kv: -kv[1]))})
    for row in rows:
        row["card"] = card_line()
    return rows


def compare(paths):
    files = []
    for path in paths:
        with open(path) as f:
            files.append({r["row"]: r for r in map(json.loads, f)})
    out = []
    for name in files[0]:
        got = [f[name] for f in files]
        line = {"row": name, "labels": [r["label"] for r in got],
                "device_ms": [r["device_ms"] for r in got]}
        if "sha256" in got[0]:
            line["same_bits"] = len({r["sha256"] for r in got}) == 1
            line["events_ms"] = [r["events_ms"] for r in got]
        else:
            line["events_ms_rounds"] = [r["events_ms_rounds"] for r in got]
        out.append(line)
        print(json.dumps(line), flush=True)
    return all(line.get("same_bits", True) for line in out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="write the rows here (JSON lines)")
    ap.add_argument("--compare", nargs="+", metavar="FILE")
    args = ap.parse_args(argv)
    if args.compare:
        return 0 if compare(args.compare) else 1
    if not torch.cuda.is_available():
        print("stem_probe: no CUDA device", file=sys.stderr)
        return 2
    rows = probe(args.label)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
