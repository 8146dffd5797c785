#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # each path's graph replay and of its
                                     # steps issued from the host (top
                                     # kernels, busy share)
    python3 chip_smoke.py --grad-spread  # also phase 8's comparison on 8
                                     # batches, each again on 3 copies
                                     # moved by one ulp (grad_spread)

Phases, each fatal on failure (nothing is caught and reported as ok):
  1. the card's name and power limit (nvidia-smi); the port's numeric
     settings (``wmfml_tpu_torch/cli/common.py:set_numerics``, which every
     entry point also calls: TF32 off for cuDNN and matmul, cuDNN's
     determinism as the port sets it), so every float32 comparison below is
     a float32 one and every check runs what the CLIs run;
  2. build of every kernel from ``wmfml_tpu_torch/csrc`` (one nvcc per
     source, all started together);
  3. each kernel at its path's shapes against its plain PyTorch twin on the
     same inputs, within the tolerance stated beside it: K1 with shared
     weights (ANP, 300 images) and per task (MAML, 10 x 15 images), K2, K3
     masked (shots 3..15) and unmasked, K6 (image DA, one launch an
     augmenter call: 150 uint8 images, every gate on, in each of the six op
     orders against the twin on the card and on the CPU; with the warps
     off, its Dropout and CoarseDropout masks bit for bit; the parameters
     it computed bit for bit against ``params_from_draw``; its phase
     clock); kernel, plain and library
     times by CUDA events, the device time of one kernel call (the summed
     durations of its launches, torch.profiler) and its number of kernels
     (K2 and K6: one), and the floor, the device time of a one-element
     torch.add.
     K1's conv1, K2's feature products and K3's convolutions run on the
     tensor cores in 3xTF32 (float32 accuracy from split TF32 operands), so
     their bound counts 3 TF32 products per product at the tensor cores'
     rate, with the float32 CUDA-core bound beside it;
  4. the ANP path: ``cfg/train/ANP_DA+TA_ShapeNet1D.yaml`` as shipped (task
     and image augmentation) through ``wmfml_tpu_torch.cli.train_cli``'s
     trainer at full width (T=10, 15 + 15, 128x128x1, dim_w 64, 8 FAVOR
     heads, m=266) on synthetic ShapeNet1D ``data_size=large``, 32 steps, 8
     a call: one eager warm-up call, then one CUDA graph of 8 steps,
     captured and replayed (``train/steps.py:FusedSteps``), and one
     validation. Launch counts are zeroed just before and read just after;
     the launches on the card (those the host issued, each captured one
     counted once per replay) must equal what the code says for every
     kernel (K1 and K2 once a step and a validation episode, K6 twice a
     step: one launch an augmenter call, whatever the order drawn on the
     card), the captured graph's DOT (``debug_dump``) must hold as many
     nodes of each kernel as the capture issued, and a trace of one more
     replay must show each (taken again, up to three times, where the
     profiler lost one). The trained model's output on a validation
     episode must agree with the same model run through the plain twins.
     Phases 7, 9 and 10 train through graphs and are checked the same way;
  5. image DA on one full-width training batch (150 context and 150 query
     images), in each of the six op orders, through K6 against the twin on
     the CPU at the same draw, and its time per training step; one step's
     DA runs under ``torch.cuda.set_sync_debug_mode("error")``: the host
     reads none of its draws;
  6. evaluation: ``wmfml_tpu_torch.cli.evaluation_cli``'s ``evaluate`` with
     ``cfg/evaluation/ANP_ShapeNet1D.yaml`` (max_ctx_num 25, 10 episodes a
     point, validation and test) over phase 4's final checkpoint; both loss
     files must hold 25 finite rows of 3 columns, and one point's loss must
     agree with the same evaluation on the CPU;
  7. the MAML path: second-order MAMLShapeNet1D meta-training through
     ``train_cli`` (``cfg/train/MAML_DA_ShapeNet1D.yaml`` as shipped, image
     DA its only augmentation: T=10, 15 + 15, dim_w 196 -> 14x14, 4 blocks
     of 64 filters, 5 inner steps at update_lr 0.002, 20 at validation), 12
     steps, 4 a call (a warm-up call, then a graph of 4 second-order steps),
     and one validation; K1 and K3 must have launched exactly as often
     as the code says, K6 twice a step; the trained
     model's validation loss on one episode must agree between the card and
     the CPU;
  8. the second-order outer gradient of one full-width MAML batch (the
     replayed training's first, augmented once through K6: DA has no
     gradient) through the kernels against
     the same gradient by plain autograd through the twins (no custom
     autograd Function at all), on the card, on phase 7's training replayed
     under deterministic algorithms, so that its state, its sums and its
     verdict are the same on every run;
  9. the bfloat16 ANP path (``compute_dtype: bfloat16``, ``bench.py``'s
     headline configuration, as ``bench.py`` runs it: 64 steps a call):
     ``ANP_DA+TA_ShapeNet1D.yaml`` with ``compute_dtype=bfloat16``, 192
     steps (a warm-up call, the capture and its replay, one more replay),
     as phase 4; every launch of K1, K2 and K6
     must be a bfloat16 one, K6 twice a step; the trained model's
     validation loss on one episode, card against the CPU, within the
     bfloat16 rule (``check_bf16``);
 10. the bfloat16 MAML path: ``cfg/train/perf/MAML_DA_ShapeNet1D_tpu.yaml``
     as shipped (bfloat16, 4 steps a call), 8 steps and one validation;
     K1 and K3 launched in bfloat16 exactly as often as the code says, K6
     twice a step; the validation loss on one episode's first tasks, card
     against the CPU, within the bfloat16 rule;
 11. ms/step of each path's graph replays in float32 and in bfloat16, timed
     in turns (float32, bfloat16, bfloat16, float32) on the trained
     trainers;
 12. graph against loop: for each of the training configurations, two
     trainers from one seed under deterministic algorithms, one calling
     the fused step three times (warm-up, capture and replay, replay), the
     other issuing the same steps from the host: every call's metrics, the
     weights, Adam's state and the generator's state equal bit for bit.
     Then, on phases 4, 7, 9 and 10's trainers, ms/step and tasks/s of graph
     replays against the loop, timed in turns (graph, loop, loop, graph),
     with the graph's nodes, its capture's and instantiation's host seconds
     and its memory pool's bytes; with ``--profile`` the card's busy share
     of a call of each. Then cuDNN's determinism (ROADMAP.md C2): on ANP
     f32, MAML f32, D1 and S1, two fresh trainers each, one capturing its
     graph with ``torch.backends.cudnn.deterministic`` off, one with it on,
     their replays timed in turns (off, on, on, off);
 13. the Pascal1D and fixed-order paths (K6's programs 1-3), each through
     ``train_phase`` as phase 4 (launches on the card as the code says, all
     of K6's of the path's program, graph nodes, one replay's trace) and
     its validation loss on one episode, card against the CPU:
     P1 ``cfg/train/ANP_DA+TA_Pascal1D.yaml`` as shipped (ANPVanillaPascal1D,
     the five-op chain), 32 steps, 8 a call; the same with
     ``aug_random_order=false`` (Pascal1D's fixed program), 16 steps;
     P2 ``cfg/train/MAML_DA+TA_Pascal1D.yaml`` as shipped (second-order
     VanillaMAML), 8 steps, 4 a call; P3
     ``cfg/train/perf/ANP_DA+TA_ShapeNet1D_tpu.yaml`` as shipped (bfloat16,
     ShapeNet1D's fixed program, 64 steps a call), 128 steps, every launch
     a bfloat16 one, and its ``_T40`` variant (T = 40), 128 steps, its
     validation loss on one episode of all 40 tasks; P4
     ``evaluation_cli`` over P1's final checkpoint (15 points, validation
     only: no test file), one point again on the CPU; graph against loop
     bit for bit on P1, P3 and P3 at T = 40 (phase 12's check);
 14. the Distractor paths (LargeCNP on the ResNet trunk, whose convolutions
     cuDNN runs with TF32 off; K2's wide form; K6's programs 4 and 5), each
     through ``train_phase`` (launches on the card as the code says, every
     K6 launch of the path's program, every K2 launch a wide one, graph
     nodes, one replay's trace) and its validation loss on one full T = 20
     episode, card against the CPU: D1 ``cfg/train/ANP_DA+TA_Distractor.yaml``
     as shipped (ANPDistractor: 15 context rows, shot ~ U[1, 15], 18
     queries, d = e = 256, m = 1419), 32 steps, 8 a call; D2
     ``cfg/train/CNP_max_DA+TA_Distractor.yaml`` as shipped (CNPDistractor,
     max aggregation, no K2), 16 steps; D3 D1 with
     ``aug_random_order=false`` (program 5), 16 steps; D4 ``evaluation_cli``
     with ``cfg/evaluation/CNP_max_Distractor.yaml`` (25 points x 2
     episodes x 2 splits, all 36 views as queries) over D2's checkpoint,
     then with ``method=ANPDistractor agg_mode=attention`` over D1's (K2
     wide at Nq 36, Nk 25), both loss files, one point again on the CPU;
     graph against loop bit for bit on D1 (phase 12's check) and D1's and
     D2's graph and loop ms/step in turns;
 16. the ShapeNet3D paths (LargeCNP on RGB, 64 x 64, ``img_agg: reshape``:
     the trunk's 64 x 2 x 2 = 256 features; quaternion labels and loss;
     backgrounds composited on the card per batch; K6's programs 6 and 7;
     K2's wide form), each through ``train_phase`` (launches on the card as
     the code says, every K6 launch of the path's program, every K2 launch
     a wide one, graph nodes, one replay's trace) and its validation loss
     on one full T = 20 episode, card against the CPU: S1
     ``cfg/train/ANP_DA+TA_ShapeNet3D.yaml`` as shipped (ANP: 15 context
     rows, shot ~ U[1, 15], 15 queries, d = e = 256, m = 1419), 32 steps, 8
     a call, on the synthetic split at the generator's default (240 items x
     30 views, 472 MB on the card, and its 200 backgrounds); S2
     ``cfg/train/CNP_ShapeNet3D.yaml`` as shipped (CondNeuralProcess, baco,
     no K2), 16 steps; S3 S1 with ``aug_random_order=false`` (program 7),
     16 steps; S4 ``evaluation_cli`` with ``cfg/evaluation/ANP_ShapeNet3D.yaml``
     (25 points x 2 episodes x 2 splits, all 30 views as queries: K2 wide
     at Nq 30, Nk 25) over S1's checkpoint, both loss files, one point on
     the CPU; graph against loop bit for bit on S1 (phase 12's check) and
     S1's and S2's graph and loop ms/step in turns;
 17. LargeCNP in bfloat16 (K2's wide form and K6's programs 4 and 6 in
     bfloat16, the trunks' convolutions on cuDNN in bfloat16), each through
     ``train_phase`` (launches on the card as the code says, every K6
     launch a bfloat16 one of the path's program, every K2 launch a
     bfloat16 wide one, graph nodes, one replay's trace) and its
     validation loss on one full T = 20 episode, card against the CPU,
     within ``check_bf16``'s rule: S5
     ``cfg/train/perf/CondNeuralProcess_DA+TA_ShapeNet3D_tpu.yaml`` as
     shipped (bfloat16, baco, 64 steps a call, the split and its
     backgrounds kept in bfloat16 on the card), 192 steps; S6 S1 with
     ``compute_dtype=bfloat16``, 32 steps, 8 a call; D5 D1 with
     ``compute_dtype=bfloat16``, 32 steps; then float32 against bfloat16
     graph ms/step and tasks/s in turns on D1/D5, S1/S6 and S2/S5 (with
     ``--profile`` each one's busy share); graph against loop bit for bit
     on S5 (phase 12's check) and S5's, S6's and D5's graph and loop
     ms/step in turns;
 18. MR and FCL (ROADMAP.md A13), each through ``train_phase`` (launches
     on the card as the code says, graph nodes, one replay's trace) at full
     width as shipped but for depth: M1 ``cfg/train/ANPMR_DA+TA_ShapeNet1D
     .yaml`` (the BBB encoder's samples drawn inside the graph: K1 twice a
     step and a validation episode, query and context apart, K2, K6
     program 0), 32 steps, 8 a call; M2 ``MAMLMR_DA+TA_ShapeNet1D.yaml``
     (second order, a sample per task and inner step: K1 per task 6 times
     a step, K3, K6), 8 steps, 4 a call; M3 ``ANPMR_ShapeNet3D.yaml``
     (``aug_list: []``: the BBB trunk on cuDNN over the context, then the
     queries, K2 wide; no K6), 16 steps; F1
     ``contrastive/FCLCNP_DA+TA_ShapeNet1D.yaml`` (K1 merged, no K2, the
     two-view NT-Xent), 32 steps; F2 ``contrastive/FCLANP_DA+TA_ShapeNet3D
     .yaml`` (K2 wide, K6 program 6, NT-Xent over 300 query reps at t =
     0.007), 16 steps; F3 ``contrastive/FCLCNP_contrastive_max_DA_
     Distractor.yaml`` (660 trunk images a step, K6 program 4), 16 steps.
     MR validation losses on one episode, card against CPU, with the
     card's draws replayed on the CPU (``EpsFeed``); FCL's as phase 14's.
     On M1 and M2 two more replays of the captured graph draw different
     BBB weights (a tap on the encoder's first layer); M2's second-order
     gradient against float64 (phase 8's check, the same draws in every
     precision, on a fresh seeded trainer under deterministic
     algorithms); graph against loop bit for bit on M1 and F2; E1
     ``evaluation_cli`` with ``cfg/evaluation/CNP_FCL_max_Distractor.yaml``
     over F3's checkpoint and with ``cfg/evaluation/ANP_ShapeNet1D.yaml``
     as ANPMRShapeNet1D over M1's (stochastic, as the reference: two sweeps
     equal, one point card against CPU on the same draws); graph and loop
     ms/step in turns on every new path. Phase 3 also holds K1 on BBB
     samples at M1's (150 images a pass) and M2's (per task) shapes;
 15. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Phase 3 also holds the Distractor paths' kernels: K2's wide form at D1's
shape (q [20, 8, 18, 256], k, v [20, 8, 15, 256], m 1419, shots 1..15) and
D4's (Nq 36, Nk 25) against ``favor_plain`` (``TOL["favor_attention_wide"]``),
and K6's programs 4 (both orders) and 5 at D1's two DA calls (300 and 360
images): parameters bit for bit, masks on 1 - x / 255 bit for bit, values
within ``TOL["warp_chain"]`` of the card twin and the CPU twin; each timed.

Phase 3 also holds the ShapeNet3D paths' kernels: K2's wide form at S1's
shape (q, k, v [20, 8, 15, 256], shots 1..15) and S4's (Nq 30, Nk 25), and
K6's programs 6 (ten of its 720 orders: the identity, the reverse and 8
drawn) and 7 at S1's two DA calls (300 and 300 images, the RGB channels of
a float32 RGBA batch read through their strides): parameters bit for bit,
masks bit for bit with every other op off, values within
``TOL["pixel_ops"]`` of the card twin (and of the CPU twin in two orders);
each timed, with ``F.grid_sample`` of one warp stage at [300, 3, 64, 64]
as the library yardstick.

Phase 3 also holds phase 17's kernels in bfloat16: K2's wide form at S6's
(Nq 15, Nk 15) and D5's (Nq 18, Nk 15) shapes within the float32
tolerance of the bfloat16 twin (at d = 256 bfloat16 moves only the
diagonal term), K6's programs 6 and 7 at S1's two DA calls on bfloat16
RGBA and 4 and 5 at D1's into bfloat16 (parameters and masks bit for
bit, values within ``check_bf16``'s rule of the card twin and the CPU
twin in every order run, and within ``BF16_K6_ULPS`` of each element:
1 ulp for programs 4 and 5, 4 for 6 and 7, whose elements may differ on
at most ``BF16_K6_SHARE`` of them), and K2's wide form at 100 rows an
item (Nq 50, Nk 50) in float32 and bfloat16
(``favor_attention_wide_R100``), a shape no shipped configuration reaches.
No path runs programs 5 and 7 in bfloat16 or K2 wide at 100 rows: those
rows carry ``off_path`` (why) and 0 launches. Every other K6 row reports
its own program's launches on its path.

Phase 3 also holds K6's programs 1-3 at full width (150 uint8 images, every
gate on) against their twins on the card: Pascal1D's chain in 12 of its 120
orders (the identity and the reverse among them), 2 of them again against
the CPU twin, in float32 within ``TOL["pixel_ops"]`` and in two orders in
bfloat16 within ``check_bf16``'s rule; both fixed programs in float32 and
bfloat16 (ShapeNet1D's, one warp and the mask, also within 2 bfloat16
ulps of each element, as program 0); every program's parameters and, with
the warps and pixel ops off, its masks bit for bit; each timed (card,
device, plain, library ms and bound). At P3's T = 40 shapes it holds K1
(1,200 images), K2 (T = 40) and ShapeNet1D's fixed program (600 images)
again in bfloat16, as rows of their own (``_T40``) that report the T = 40
path's launches.

Phase 3 holds each kernel's bfloat16 path too (K1 both forms, K2, K3 masked
and unmasked, K6 in every order) against its bfloat16 twin at the same
shapes: within ``check_bf16``'s rule, K1's and K3's values within 2
bfloat16 ulps of each element (``BF16_FLOOR`` beside it), and K6's
parameters and masks bit for bit, its values within 2 bfloat16 ulps of each
element. Phase 8's float64 check stays on float32.

Exits non-zero, printing no result, without a CUDA device or without the
repository around it.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_YAML = os.path.join(HERE, "cfg", "train", "ANP_DA+TA_ShapeNet1D.yaml")
TRAIN_OVERRIDES = ["data_size=large", "synthetic_data=true", "iterations=32",
                   "val_freq=1000", "val_iters=2", "steps_per_call=8",
                   "device=cuda"]
MAML_YAML = os.path.join(HERE, "cfg", "train", "MAML_DA_ShapeNet1D.yaml")
MAML_OVERRIDES = ["data_size=large", "synthetic_data=true", "iterations=12",
                  "val_freq=1000", "val_iters=1", "steps_per_call=4",
                  "device=cuda"]
# bench.py's headline (bench.py:56-81): bfloat16, 64 steps a call; 192
# iterations are a warm-up call, the capture and its replay, and one replay
BF16_OVERRIDES = ["data_size=large", "synthetic_data=true", "iterations=192",
                  "val_freq=1000", "val_iters=2", "steps_per_call=64",
                  "device=cuda", "compute_dtype=bfloat16"]
PERF_MAML_YAML = os.path.join(HERE, "cfg", "train", "perf",
                              "MAML_DA_ShapeNet1D_tpu.yaml")
PERF_MAML_OVERRIDES = ["synthetic_data=true", "iterations=8", "val_freq=1000",
                       "val_iters=1"]
EVAL_YAML = os.path.join(HERE, "cfg", "evaluation", "ANP_ShapeNet1D.yaml")
EVAL_OVERRIDES = ["synthetic_data=true", "device=cuda"]
# the Pascal1D and fixed-order paths (phase 13): P1, its fixed-order twin,
# P2, P3 and P3 at T = 40, all as shipped but for their depth
PASCAL_YAML = os.path.join(HERE, "cfg", "train", "ANP_DA+TA_Pascal1D.yaml")
PASCAL_OVERRIDES = ["synthetic_data=true", "iterations=32", "val_freq=1000",
                    "val_iters=2", "steps_per_call=8", "device=cuda"]
PASCAL_FIXED_OVERRIDES = ["synthetic_data=true", "iterations=16",
                          "val_freq=1000", "val_iters=1", "steps_per_call=8",
                          "device=cuda", "aug_random_order=false"]
PASCAL_MAML_YAML = os.path.join(HERE, "cfg", "train",
                                "MAML_DA+TA_Pascal1D.yaml")
PASCAL_MAML_OVERRIDES = ["synthetic_data=true", "iterations=8",
                         "val_freq=1000", "val_iters=1", "steps_per_call=4",
                         "device=cuda"]
PERF_ANP_YAML = os.path.join(HERE, "cfg", "train", "perf",
                             "ANP_DA+TA_ShapeNet1D_tpu.yaml")
PERF_ANP_T40_YAML = os.path.join(HERE, "cfg", "train", "perf",
                                 "ANP_DA+TA_ShapeNet1D_tpu_T40.yaml")
# 128 iterations at 64 a call: a warm-up call, the capture and its replay;
# validation at the YAML's cadence (it 0 and 64)
PERF_ANP_OVERRIDES = ["synthetic_data=true", "iterations=128", "val_iters=1"]
PASCAL_EVAL_OVERRIDES = ["synthetic_data=true", "device=cuda", "mode=eval"]
# the Distractor paths (phase 14), as shipped but for their depth: D1
# ANPDistractor (32 steps, 8 a call), D2 CNPDistractor with max aggregation
# (16 steps), D3 D1 in the fixed order (16 steps); D4 the evaluation YAML
# over D2's checkpoint, then over D1's as ANPDistractor, 2 episodes a point
DISTRACTOR_YAML = os.path.join(HERE, "cfg", "train",
                               "ANP_DA+TA_Distractor.yaml")
DISTRACTOR_CNP_YAML = os.path.join(HERE, "cfg", "train",
                                   "CNP_max_DA+TA_Distractor.yaml")
DISTRACTOR_OVERRIDES = ["synthetic_data=true", "iterations=32",
                        "val_freq=1000", "val_iters=1", "steps_per_call=8",
                        "device=cuda"]
DISTRACTOR_SHORT_OVERRIDES = ["synthetic_data=true", "iterations=16",
                              "val_freq=1000", "val_iters=1",
                              "steps_per_call=8", "device=cuda"]
DISTRACTOR_FIXED_OVERRIDES = DISTRACTOR_SHORT_OVERRIDES + [
    "aug_random_order=false"]
DISTRACTOR_EVAL_YAML = os.path.join(HERE, "cfg", "evaluation",
                                    "CNP_max_Distractor.yaml")
DISTRACTOR_EVAL_OVERRIDES = ["synthetic_data=true", "device=cuda",
                             "val_iters=2"]
# the ShapeNet3D paths (phase 16), as shipped but for their depth: S1 ANP
# (32 steps, 8 a call), S2 CondNeuralProcess (16 steps), S3 S1 in the fixed
# order (16 steps); S4 the evaluation YAML over S1's checkpoint
S3D_YAML = os.path.join(HERE, "cfg", "train", "ANP_DA+TA_ShapeNet3D.yaml")
S3D_CNP_YAML = os.path.join(HERE, "cfg", "train", "CNP_ShapeNet3D.yaml")
S3D_OVERRIDES = DISTRACTOR_OVERRIDES
S3D_SHORT_OVERRIDES = DISTRACTOR_SHORT_OVERRIDES
S3D_FIXED_OVERRIDES = DISTRACTOR_FIXED_OVERRIDES
S3D_EVAL_YAML = os.path.join(HERE, "cfg", "evaluation", "ANP_ShapeNet3D.yaml")
S3D_EVAL_OVERRIDES = DISTRACTOR_EVAL_OVERRIDES
# LargeCNP in bfloat16 (phase 17): S5 the ShapeNet3D perf YAML as shipped
# (bfloat16, 64 steps a call) but for its depth, 192 steps (a warm-up call,
# the capture and its replay, one more replay) and one validation of one
# episode a split; S6 and D5 are S1 and D1 (32 steps, 8 a call) in bfloat16
S3D_PERF_YAML = os.path.join(HERE, "cfg", "train", "perf",
                             "CondNeuralProcess_DA+TA_ShapeNet3D_tpu.yaml")
S5_OVERRIDES = ["synthetic_data=true", "iterations=192", "val_freq=1000",
                "val_iters=1", "device=cuda"]
BF16 = ["compute_dtype=bfloat16"]
# MR and FCL (phase 18), as shipped but for their depth: M1 ANPMRShapeNet1D
# and F1 FCLCNPShapeNet1D as the ANP path (32 steps, 8 a call), M2
# MAMLMRShapeNet1D (8 steps, 4 a call), M3 ANPMRShapeNet3D, F2 FCLANP and
# F3 FCLCNPDistractor (16 steps, 8 a call); E1 the FCL evaluation YAML over
# F3's checkpoint and the ShapeNet1D one as ANPMRShapeNet1D over M1's
MR_ANP_YAML = os.path.join(HERE, "cfg", "train", "ANPMR_DA+TA_ShapeNet1D.yaml")
MR_MAML_YAML = os.path.join(HERE, "cfg", "train",
                            "MAMLMR_DA+TA_ShapeNet1D.yaml")
MR_MAML_OVERRIDES = ["data_size=large", "synthetic_data=true", "iterations=8",
                     "val_freq=1000", "val_iters=1", "steps_per_call=4",
                     "device=cuda"]
MR_3D_YAML = os.path.join(HERE, "cfg", "train", "ANPMR_ShapeNet3D.yaml")
FCL_CNP_YAML = os.path.join(HERE, "cfg", "train", "contrastive",
                            "FCLCNP_DA+TA_ShapeNet1D.yaml")
FCL_ANP_YAML = os.path.join(HERE, "cfg", "train", "contrastive",
                            "FCLANP_DA+TA_ShapeNet3D.yaml")
FCL_DISTRACTOR_YAML = os.path.join(HERE, "cfg", "train", "contrastive",
                                   "FCLCNP_contrastive_max_DA_Distractor.yaml")
FCL_EVAL_YAML = os.path.join(HERE, "cfg", "evaluation",
                             "CNP_FCL_max_Distractor.yaml")

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, dense TF32
# on the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# integer operations (K6's hashes): 64 INT32 lanes per SM (Hopper
# architecture white paper) x 132 SMs x 1.98 GHz boost clock
PEAK_INT32_OPS = 64 * 132 * 1.98e9

# max |kernel - plain| <= ATOL + RTOL * |plain|, elementwise; both sides are
# float32 sums taken in another order (<= 297 terms for the stem, 64 + 266
# for FAVOR+), so they agree to a few float32 ulps of the largest term. K3:
# each layer sums 576 products per output and 2940 values per channel
# statistic in another order, then divides by the channel's std, three
# times over; its O(1) outputs keep about five digits
TOL = {"literature_stem": (1e-4, 1e-4), "favor_attention": (1e-5, 1e-4),
       "favor_attention_wide": (1e-5, 1e-4),
       "maml_features": (1e-4, 1e-4), "warp_chain": (1e-5, 1e-5),
       "pixel_ops": (1e-5, 1e-5)}
# K6's programs 1-3 (pixel_ops): every term of every sum is nonnegative
# (taps, fill, blur windows), so kernel and twin differ by a few float32
# ulps of each value; the card's powf and the twin's pow differ by a few
# more, and gamma <= 2 at most doubles a relative error
# K6's warps sum at most 16 taps of values in [0, 1] plus the fill in
# another order than the dense twin's matrix products; its masks are
# integer arithmetic and its parameters the twin's float32 steps, so both
# must equal the twin's bit for bit
# the second-order outer gradient against float64 plain autograd, per
# parameter as max |difference| / max |float64|. The one-pass batch norm
# (E[x^2] - E[x]^2 in float32, as the JAX package computes it) cancels
# wherever a channel's mean dwarfs its spread, so five inner steps amplify
# rounding: the kernels must come within GRAD_TOL of float64, or within
# GRAD_FACTOR times the error of the plain float32 twins (two float32 sums in
# another order err about equally)
GRAD_TOL, GRAD_FACTOR = 1e-3, 3.0
# bfloat16 (check_bf16): the kernel and its bfloat16 twin round at the same
# points after float32 sums taken in another order, so a sum near a rounding
# boundary can round the other way and carry one ulp on. A kernel passes when
# max |kernel - twin| <= 2 max |twin - twin_f32| + 2^-7 max |twin_f32| (the
# size of bfloat16's own effect; twin_f32 is the twin on the same inputs in
# float32; the CPU parity tests' rule) and its mean error is below the
# twin's own mean distance from float32. K1 and K3 in bfloat16 also come
# within BF16_ULPS of each element of the twin, an element below
# BF16_FLOOR times the twin's largest measured in the spacing at that size
# (where a sum cancels, two float32 orders differ by about 2^-20 of its
# largest term, which no longer fits an ulp of the small result). K6 in
# bfloat16: values within BF16_ULPS of each element, with no floor,
# parameters and masks bit for bit.
BF16_ULPS, BF16_FLOOR = 2.0, 2.0 ** -8
# K6's programs 4-7 in bfloat16: every op rounds where the twin rounds, so
# an element can differ only where a float32 sum taken in another order
# (a warp's taps, a blur's window, powf's last bits) lands on the other
# side of a rounding boundary. Distractor's programs round once (Affine):
# within one bfloat16 ulp of the twin. ShapeNet3D's chain six ops that
# each round, and a later op carries a flipped value on and can widen it
# (gamma's exponent up to 2, the blur's sums rounded at every add): within
# 4 ulps of each element, on at most BF16_K6_SHARE of the elements (4 ulps
# and a share of 1.1e-5 measured on the H100), beside ``check_bf16``'s rule
BF16_K6_ULPS = {"distractor": 1.0, "distractor_fixed": 1.0,
                "shapenet_3d": 4.0, "shapenet_3d_fixed": 4.0}
BF16_K6_SHARE = 1e-4
# validation degree loss after 20 inner steps, card against CPU: float32
# sums in another order move each adapted weight a little at every step;
# |card - CPU| <= VAL_TOL * (|CPU| + 1) degrees
VAL_TOL = 1e-3


T0 = time.perf_counter()


def log(msg):
    print(msg, flush=True)


def stamp(what):
    """The host seconds since the start, at the end of ``what``."""
    log(f"time: {what} done at {time.perf_counter() - T0:.1f} s")


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


# how often torch.profiler loses device events of this run's traces: traces
# taken, traces that held no device event, traces that held fewer events
# than their kernels imply, and calls measured from a CUDA graph after
# three empty traces (``device_profile``; logged at the end)
TRACES = {"taken": 0, "empty": 0, "short": 0, "graph": 0}


def device_profile(fn, iters=20, names=None):
    """Device time of one call (ms), the summed durations of the kernels it
    launches, and the number of kernels it launches, from torch.profiler.
    Beside ``cuda_ms``, which also counts the gaps while the host enqueues,
    the time says how far a wrapper is host-bound. ``names``, a set, gets
    the names of the kernels.

    The profiler drops some of the events it should record (1 of 160 and 2
    of 10 seen on the H100), so the trace's sum over ``iters`` would read
    low. Each kernel name's launches a call are its events over ``iters``,
    rounded (at least one), its time the mean of the events recorded, and a
    call's device time the sum over names of the two multiplied; a trace
    with fewer events than that implies is logged. A trace that holds no
    device event at all is logged and taken again, up to three times; after
    three such traces (seen on the H100, in a row, now and then) the call is
    measured by ``graph_profile`` instead, and the result says which way
    (``device_ms_by``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        TRACES["taken"] += 1
        if kernels:
            break
        TRACES["empty"] += 1
        log(f"profile: a trace of {iters} calls holds no device event "
            f"(attempt {attempt + 1} of 3)")
    else:
        TRACES["graph"] += 1
        return graph_profile(fn, iters, names)
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    per_call = {n: max(1, round(len(v) / iters)) for n, v in by_name.items()}
    us = sum(per_call[n] * sum(v) / len(v) for n, v in by_name.items())
    implied = iters * sum(per_call.values())
    if len(kernels) != implied:
        TRACES["short"] += 1
        log(f"profile: a trace of {iters} calls holds {len(kernels)} of the "
            f"{implied} device events its kernels imply; each kernel's time "
            f"is the mean of its recorded events")
    if names is not None:
        names.update(by_name)
    return dict(device_ms=us / 1e3, kernels_per_call=sum(per_call.values()),
                events_recorded=len(kernels), events_implied=implied,
                device_ms_by="torch.profiler")


# kernel names a graph's DOT is searched for (``graph_profile``); the longer
# of two that overlap comes first
DOT_KERNELS = ("favor_kernel_wide", "favor_kernel", "image_da_kernel",
               "stem_fwd_kernel", "bn_relu_kernel")


def graph_profile(fn, iters=20, names=None):
    """``device_profile``'s numbers without torch.profiler: ``iters`` calls
    captured into one CUDA graph, its kernel nodes counted from the DOT
    (``debug_dump``) and named by the first of ``DOT_KERNELS`` each holds
    (else by the function's mangled name in its ID field), and a
    call's device time that of one replay over ``iters``, by CUDA events
    (the replay runs its kernels back to back, so this counts the gaps
    between them, no host time)."""
    import re
    import tempfile

    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.instantiate()
    with tempfile.TemporaryDirectory() as tmp:
        dot = os.path.join(tmp, "calls.dot")
        graph.debug_dump(dot)
        with open(dot) as f:
            text = f.read()
    nodes = re.split(r'^[ \t]*(?="graph_\d+_node_\d+"\[)', text,
                     flags=re.M)[1:]
    found = []
    for node in nodes:
        if 'label="{KERNEL' not in node:
            continue
        known = [k for k in DOT_KERNELS if k in node]
        func = re.search(r"\{ID \|[^|]*\| ([^}\\]+)", node)
        found.append(known[0] if known else
                     func.group(1).strip() if func else node[:80])
    ms = min(cuda_ms(graph.replay, iters=5, warmup=2) for _ in range(3))
    del graph
    log(f"profile: {iters} calls measured from a CUDA graph instead: "
        f"{len(found)} kernel nodes of {len(nodes)}, {sorted(set(found))}")
    if names is not None:
        names.update(found)
    return dict(device_ms=ms / iters, kernels_per_call=len(found) / iters,
                events_recorded=None, events_implied=None,
                device_ms_by="CUDA graph replay, CUDA events")


def floor_ms() -> float:
    """The least device time any launch takes on this card: that of a
    one-element ``torch.add``."""
    import torch

    x = torch.ones(1, device="cuda")
    prof = device_profile(lambda: torch.add(x, x))
    if prof["kernels_per_call"] != 1:
        raise AssertionError(f"torch.add launched {prof['kernels_per_call']} "
                             f"kernels per call")
    return prof["device_ms"]


def bound(flops: float, nbytes: float, split_flops: float = 0.0,
          split_products: int = 3, bf16_flops: float = 0.0):
    """Least time (ms), what sets it, and the float32 CUDA-core bound (ms)
    of the same work. ``flops`` run in float32 on the CUDA cores,
    ``split_flops`` in split TF32 on the tensor cores (``split_products``
    TF32 products each: 3 for float32 operands, 2 where one operand is
    bfloat16, exact in TF32), ``bf16_flops`` in bfloat16 on the tensor
    cores. The CUDA cores and the tensor cores run side by side, so the
    operations take the longer of their two times, not the sum."""
    t_ops = max(flops / PEAK_F32_FLOPS,
                split_products * split_flops / PEAK_TF32_FLOPS
                + bf16_flops / PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_f32 = max((flops + split_flops + bf16_flops) / PEAK_F32_FLOPS, t_bytes)
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_f32_ms=t_f32 * 1e3)


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


def check_bf16(name, got, want, want_f32, element_ulps=True):
    """A bfloat16 kernel against its bfloat16 twin (the rule beside
    ``BF16_ULPS``; ``element_ulps`` false leaves out the per-element ulp
    bound); returns (max abs err, max err relative to max |twin|)."""
    import torch

    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} from "
                             f"the kernel, {want.dtype} {tuple(want.shape)} "
                             f"from the twin")
    g, w, f = got.float(), want.float(), want_f32.float()
    err, own = (g - w).abs(), (w - f).abs()
    limit = 2 * own.max().item() + 2.0 ** -7 * f.abs().max().item()
    if (not bool(torch.isfinite(g).all()) or err.max().item() > limit
            or err.mean().item() > own.mean().item()):
        raise AssertionError(
            f"{name} (bfloat16): kernel disagrees with its plain twin: max "
            f"abs err {err.max().item()} (limit {limit}), mean "
            f"{err.mean().item()} (twin's own from float32 "
            f"{own.mean().item()})")
    if got.dtype == torch.bfloat16 and element_ulps:
        ulps = bf16_ulps(got, want, BF16_FLOOR * w.abs().max().item())
        log(f"kernel: {name} (bfloat16): {ulps} bfloat16 ulps from the twin "
            f"at most")
        if ulps > BF16_ULPS:
            raise AssertionError(f"{name} (bfloat16): an element lies {ulps} "
                                 f"bfloat16 ulps from the twin's")
    return err.max().item(), err.max().item() / w.abs().max().item()


def check_kernel(name, got, want, plain_f32):
    """``check_close`` for float32, ``check_bf16`` for bfloat16
    (``plain_f32`` gives the twin's float32 value on the same inputs)."""
    import torch

    if got.dtype == torch.float32 and want.dtype == torch.float32 and \
            plain_f32 is None:
        return check_close(name, got, want)
    return check_bf16(name, got, want, plain_f32())


def stem_bound(b, h, w, nbytes, bf16=False):
    """``bound`` of the stem: in float32 conv0 on the CUDA cores, conv1 in
    3xTF32; in bfloat16 both convs' products are bfloat16 summed in float32,
    what the tensor cores do at their bfloat16 rate (the kernel runs conv0,
    one input channel, on the CUDA cores all the same)."""
    conv0 = 2 * b * (h // 2) * (w // 2) * 32 * 9 * 1
    conv1 = 2 * b * (h // 4) * (w // 4) * 48 * 9 * 32
    if bf16:
        return bound(0.0, nbytes, bf16_flops=conv0 + conv1)
    return bound(conv0, nbytes, split_flops=conv1)


def _rows(name, dtype, path, tasks=10):
    """The identifying keys of a kernel row: the wrapper (``kernel``), the
    row's name (``_bf16`` for the bfloat16 path, ``_T40`` for T = 40), its
    dtype and the path whose launch count it reports."""
    import torch

    bf16 = dtype == torch.bfloat16
    return dict(name=name + ("_bf16" if bf16 else "")
                + ("" if tasks == 10 else f"_T{tasks}"), kernel=name,
                dtype="bfloat16" if bf16 else "float32",
                path=path + (" bf16" if bf16 else ""), route="cuda")


def check_stem(model, gen, dtype=None, tasks=10, path="ANP"):
    """K1 at the ANP path's shape: the merged ctx+qry batch, 30 images a
    task (300 at T = 10, 1,200 at ``tasks`` = 40), in float32 or
    (``dtype``) bfloat16; the row reports ``path``'s launches."""
    import torch
    import torch.nn.functional as F

    from wmfml_tpu_torch.kernels import stem

    dtype = dtype or torch.float32
    enc = model.encoder_w0
    w0, b0, w1, b1 = (p.detach().to(dtype) for p in (
        enc[0].weight, enc[0].bias, enc[2].weight, enc[2].bias))
    b, h, w = tasks * 30, 128, 128
    x = torch.rand((b, h, w, 1), generator=gen, device="cuda").to(dtype)
    args = (x, w0, b0, w1, b1)
    got = stem.stem_launch(*args)
    want = stem.stem_plain(*args)
    f32 = None if dtype == torch.float32 else (
        lambda: stem.stem_plain(*(a.float() for a in args)))
    err, rel = check_kernel("literature_stem", got, want, f32)
    xn = x.permute(0, 3, 1, 2).contiguous()

    def library():      # cuDNN yardstick, NCHW; never called by the port
        a = F.relu(F.conv2d(xn, w0, b0, stride=2, padding=1))
        a = F.relu(F.conv2d(a, w1, b1, stride=2, padding=1))
        return F.max_pool2d(a, 2)

    times = in_turns({"ms": lambda: stem.stem_launch(*args),
                      "plain_ms": lambda: stem.stem_plain(*args),
                      "library_ms": library})
    times.update(device_profile(lambda: stem.stem_launch(*args)))
    nbytes = x.element_size() * (x.numel() + got.numel() + sum(
        t.numel() for t in (w0, b0, w1, b1)))
    return dict(**_rows("literature_stem", dtype, path, tasks),
                shape=f"shared weights, [{b}, 128, 128, 1]",
                source="wmfml_tpu_torch/csrc/stem.cu",
                replaces="wmfml_tpu/nn/encoders.py:230",
                max_abs_err=err, max_rel_err=rel, **times,
                **stem_bound(b, h, w, nbytes, dtype == torch.bfloat16))


def check_favor(model, gen, dtype=None, tasks=10, path="ANP"):
    """K2 at the ANP path's shape, T = ``tasks`` (10, or 40: more (task,
    head) items than co-resident blocks), with shots 3..15 across the
    tasks; q, k, v are [T, N, H, d] transposed to [T, H, N, d], as the
    attention block hands them over, float32 or (``dtype``) bfloat16. One
    call must issue one kernel. The row reports ``path``'s launches."""
    import torch

    from wmfml_tpu_torch.kernels import favor

    dtype = dtype or torch.float32
    proj = model.attn.projection_matrix
    t_, h, n, d = tasks, 8, 15, proj.shape[1]
    q, k, v = (torch.randn((t_, n, h, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2) for _ in range(3))
    shots = torch.tensor([3 + (12 * i) // (t_ - 1) for i in range(t_)],
                         device="cuda")
    mask = torch.arange(n, device="cuda")[None, :] < shots[:, None]
    got = favor.favor_launch(q, k, v, proj, mask)
    want = favor.favor_plain(q, k, v, proj, mask)
    f32 = None if dtype == torch.float32 else (lambda: favor.favor_plain(
        q.float(), k.float(), v.float(), proj, mask))
    err, rel = check_kernel("favor_attention", got, want, f32)
    times = in_turns({"ms": lambda: favor.favor_launch(q, k, v, proj, mask),
                      "plain_ms": lambda: favor.favor_plain(q, k, v, proj,
                                                            mask)})
    names = set()
    times.update(device_profile(
        lambda: favor.favor_launch(q, k, v, proj, mask), names=names))
    # one kernel and nothing else (the profiler may drop an event now and
    # then, so the count may read just under 1, never over)
    if len(names) != 1 or times["kernels_per_call"] != 1:
        raise AssertionError(f"favor_attention issued "
                             f"{times['kernels_per_call']} kernels per call: "
                             f"{sorted(names)}")
    if dtype == torch.float32 and tasks == 10:
        times["phase_us"] = favor_phases(q, k, v, proj, mask)
    m, e = proj.shape[0], v.shape[-1]
    # the kernel's form: dash = [q; k] P^T in split TF32 on the tensor cores
    # (bfloat16 rows are exact in TF32: two products, not three); A = q'
    # k'^T, A v and the row sums on the CUDA cores
    split_flops = 2 * t_ * h * (2 * n) * m * d
    flops = 2 * t_ * h * (n * n * m + n * n * e + n * n)
    nbytes = (q.element_size() * 3 * q.numel() + 4 * (q.numel() + proj.numel())
              + mask.numel())
    return dict(**_rows("favor_attention", dtype, path, tasks),
                shape=f"q, k, v [{t_}, 8, 15, 64], m 266, shots 3..15",
                source="wmfml_tpu_torch/csrc/favor.cu",
                replaces="wmfml_tpu/nn/attention.py:93",
                max_abs_err=err, max_rel_err=rel, **times, library_ms=None,
                **bound(flops, nbytes, split_flops=split_flops,
                        split_products=3 if dtype == torch.float32 else 2))


def favor_phases(q, k, v, proj, mask, runs=10):
    """K2's phase clock (the global timer, ns, read by each block's first
    thread; ``favor.PHASES``): microseconds from the first block's start
    until the last block reached each point; medians over ``runs``
    launches."""
    import statistics

    import torch

    from wmfml_tpu_torch.kernels import favor

    runs_us = []
    for _ in range(runs):
        stamps = torch.full((q.shape[0] * q.shape[1], favor.STAMPS), -1,
                            dtype=torch.int64, device="cuda")
        favor.favor_launch(q, k, v, proj, mask, stamps=stamps)
        s = stamps[stamps[:, 0] >= 0].cpu().double()
        runs_us.append((s.max(0).values - s[:, 0].min()) / 1e3)
    return {name: statistics.median(float(r[j]) for r in runs_us)
            for j, name in enumerate(favor.PHASES)}


def per_task(w, tasks, gen, scale=0.05):
    """``tasks`` copies of ``w`` [T, ...], each moved off it a little."""
    import torch

    noise = torch.randn((tasks, *w.shape), generator=gen, device=w.device)
    return (w.unsqueeze(0) + scale * w.abs().mean() * noise).contiguous()


def check_stem_per_task(model, gen, dtype=None):
    """K1 with per-task weights at the MAML path's shape: 10 tasks x 15
    images, against ``stem_plain`` applied task by task; float32 or
    (``dtype``) bfloat16."""
    import torch
    import torch.nn.functional as F

    from wmfml_tpu_torch.kernels import stem

    dtype = dtype or torch.float32
    enc = model.encoder_w
    t_, n, h, w = 10, 15, 128, 128
    w0, b0, w1, b1 = (per_task(p.detach(), t_, gen).to(dtype) for p in (
        enc.layer1.conv.weight, enc.layer1.conv.bias, enc.layer2.conv.weight,
        enc.layer2.conv.bias))
    x = torch.rand((t_ * n, h, w, 1), generator=gen, device="cuda").to(dtype)
    args = (x, w0, b0, w1, b1)

    def by_task(*a):
        return torch.cat([stem.stem_plain(a[0][i * n:(i + 1) * n],
                                          *(p[i] for p in a[1:]))
                          for i in range(t_)])

    got = stem.stem_launch(*args)
    want = by_task(*args)
    f32 = None if dtype == torch.float32 else (
        lambda: by_task(*(a.float() for a in args)))
    err, rel = check_kernel("literature_stem", got, want, f32)
    xg = x.reshape(t_, n, h, w).transpose(0, 1).contiguous()   # [N, T, H, W]

    def library():      # cuDNN grouped convs, NCHW; never called by the port
        a = F.relu(F.conv2d(xg, w0.flatten(0, 1), b0.flatten(), stride=2,
                            padding=1, groups=t_))
        a = F.relu(F.conv2d(a, w1.flatten(0, 1), b1.flatten(), stride=2,
                            padding=1, groups=t_))
        return F.max_pool2d(a, 2)

    times = in_turns({"ms": lambda: stem.stem_launch(*args),
                      "plain_ms": lambda: stem.stem_plain(*args),
                      "library_ms": library})
    times.update(device_profile(lambda: stem.stem_launch(*args)))
    nbytes = x.element_size() * (x.numel() + got.numel() + sum(
        a.numel() for a in (w0, b0, w1, b1)))
    return dict(**_rows("literature_stem", dtype, "MAML"),
                shape="per-task weights, [10 x 15, 128, 128, 1]",
                source="wmfml_tpu_torch/csrc/stem.cu",
                replaces="wmfml_tpu/nn/encoders.py:230",
                max_abs_err=err, max_rel_err=rel, **times,
                **stem_bound(t_ * n, h, w, nbytes, dtype == torch.bfloat16))


def check_features(model, gen, dtype=None):
    """K3 at the MAML path's shape [10, 15, 14, 14, 64], masked with shots
    3..15 across the tasks (the context passes) and unmasked (the query
    pass), against ``features_plain``; float32 or (``dtype``) bfloat16."""
    import torch
    import torch.nn.functional as F

    from wmfml_tpu_torch.kernels import features

    dtype = dtype or torch.float32
    t_, n, s, c = 10, 15, 14, 64
    layers = [getattr(model.features, f"layer{i}") for i in (2, 3, 4)]
    w = torch.stack([per_task(blk.conv.weight.detach(), t_, gen)
                     for blk in layers], 1)                    # [T, 3, C, C, 3, 3]
    b = torch.stack([per_task(blk.conv.bias.detach(), t_, gen)
                     for blk in layers], 1)
    scale = 1.0 + 0.1 * torch.randn((3, c), generator=gen, device="cuda")
    shift = 0.1 * torch.randn((3, c), generator=gen, device="cuda")
    x = torch.relu(torch.randn((t_, n, s, s, c), generator=gen,
                               device="cuda"))
    x, w, b, scale, shift = (a.to(dtype) for a in (x, w, b, scale, shift))
    args = (x, w, b, scale, shift)
    shots = torch.tensor([3 + (12 * i) // (t_ - 1) for i in range(t_)],
                         device="cuda")
    mask = torch.arange(n, device="cuda")[None, :] < shots[:, None]
    res = {}
    for key, m in (("", mask), ("_unmasked", None)):
        got = features.features_launch(*args, m)
        want = features.features_plain(*args, m)
        f32 = None if dtype == torch.float32 else (
            lambda: features.features_plain(*(a.float() for a in args), m))
        res["max_abs_err" + key], res["max_rel_err" + key] = check_kernel(
            "maml_features", got, want, f32)
    xn = x.permute(1, 0, 4, 2, 3).reshape(n, t_ * c, s, s).contiguous()
    wg = [w[:, i].flatten(0, 1).contiguous() for i in range(3)]
    bg = [b[:, i].flatten().contiguous() for i in range(3)]
    sg = [scale[i].float().repeat(t_) for i in range(3)]
    hg = [shift[i].float().repeat(t_) for i in range(3)]

    def library():      # unmasked: cuDNN grouped conv + batch_norm + ReLU
        h = xn
        for i in range(3):
            h = F.conv2d(h, wg[i], bg[i], padding=1, groups=t_)
            h = F.relu(F.batch_norm(h, None, None, sg[i], hg[i],
                                    training=True, eps=features.EPS))
        return h

    times = in_turns({
        "ms": lambda: features.features_launch(*args, mask),
        "plain_ms": lambda: features.features_plain(*args, mask),
        "ms_unmasked": lambda: features.features_launch(*args),
        "plain_ms_unmasked": lambda: features.features_plain(*args),
        "library_ms": library})
    times.update(device_profile(
        lambda: features.features_launch(*args, mask)))
    flops = 2 * t_ * 3 * (n * s * s) * c * c * 9
    nbytes = x.element_size() * (2 * x.numel() + w.numel() + b.numel()
                                 + 6 * c) + mask.numel()
    ops = (dict(bf16_flops=flops) if dtype == torch.bfloat16
           else dict(split_flops=flops))
    return dict(**_rows("maml_features", dtype, "MAML"),
                shape="[10, 15, 14, 14, 64], 3 layers, shots 3..15",
                source="wmfml_tpu_torch/csrc/features.cu",
                replaces="scripts/proto_maml_pallas_conv.py:96",
                **res, **times, **bound(0.0, nbytes, **ops))


# integer operations of K6's masks: per Dropout pixel the id (3), the key
# mix (xor, multiply, add), two murmur3 finalizers (3 xors, 3 shifts, 2
# multiplies each), the uniform (convert, scale, compare) and the mask
# multiply; per CoarseDropout cell the same hash, and a mask multiply per
# pixel
HASH_OPS = 3 + 3 + 16 + 3 + 1


def da_draw(gen, b):
    """A call's raw draw for ``b`` images with CropAndPad's, Affine's and the
    dropout op's gates on, so that every image is warped and masked;
    Affine's nearest taps and Dropout or CoarseDropout as drawn (about half
    the images each)."""
    from wmfml_tpu_torch.aug.image_aug import ShapeNet1DAugmenter

    u, keys, _ = ShapeNet1DAugmenter().sample(b, gen, "cuda")
    u[:, 13] = u[:, 14] = u[:, 16] = 0.25
    return u, keys


def da_work(p, order, h, w):
    """(float operations, integer operations) of K6 on this draw in
    ``order``: a multiply-add per nonzero (row tap, column tap) of each warp
    chain's composed rows, then its fill, the division by 255 and the add
    (5 operations a pixel for one stage, 10 for two); the hashes of the
    dropout op where its gate is on."""
    import torch

    from wmfml_tpu_torch.aug import image_aug

    b = p.warp.shape[0]
    flops = 0.0
    for run in image_aug.order_runs(image_aug.ORDERS[order]):
        if run == (image_aug.DROP,):
            continue
        my = mx = None
        for st in image_aug.stages_from_params(p.warp, run):
            wy, wx = image_aug.stage_matrices(h, w, st["scale"],
                                              st["translate"], st["nearest"],
                                              st["gate"])
            my = wy if my is None else wy @ my
            mx = wx if mx is None else wx @ mx
        taps = ((my != 0).sum(-1).double()[:, :, None]
                * (mx != 0).sum(-1).double()[:, None, :])
        flops += float(2 * taps.sum()) + (5 if len(run) == 1 else 10) * b * h * w
    gate, pick = p.drop[:, 0] > 0.5, p.drop[:, 1] > 0.5
    cells = (torch.clamp_min(torch.round(h * p.drop[:, 3]), 1.0)
             * torch.clamp_min(torch.round(w * p.drop[:, 3]), 1.0)).double()
    iops = float((gate & pick).sum()) * HASH_OPS * h * w + float(
        (cells[gate & ~pick] * HASH_OPS + h * w).sum())
    return flops, iops


def da_phases(x, u, keys, order, runs=10):
    """K6's phase clock (the global timer, ns, read by each block's first
    thread; ``image_da.PHASES``): the mean over the blocks of the time from
    a block's start to each point, and the span from the first block's start
    to the last block's end, in microseconds; medians over ``runs``."""
    import statistics

    import torch

    from wmfml_tpu_torch.kernels import image_da as kda

    per_run = []
    for _ in range(runs):
        stamps = torch.full((u.shape[0], kda.STAMPS), -1, dtype=torch.int64,
                            device="cuda")
        kda.image_da_launch(x, u, keys, order, stamps=stamps)
        s = stamps.cpu().double()
        row = {name: float((s[:, j] - s[:, 0]).mean()) / 1e3
               for j, name in enumerate(kda.PHASES) if j}
        row["span"] = float(s[:, -1].max() - s[:, 0].min()) / 1e3
        per_run.append(row)
    return {k: statistics.median(r[k] for r in per_run) for k in per_run[0]}


def bf16_ulps(got, want, floor=0.0):
    """max |got - want| over bfloat16 tensors, in units of each element's
    spacing (the gap from |want| to the next bfloat16 above it); an element
    with |want| below ``floor`` is measured in the spacing at ``floor``."""
    import torch

    w = want.abs().clamp_min(floor).contiguous()
    gap = (w.view(torch.int16) + 1).view(torch.bfloat16).float() - w.float()
    return ((got.float() - want.float()).abs() / gap).max().item()


def check_image_da(gen, dtype=None):
    """K6 at the DA call's shape: the context slice of a [10, 30, 128, 128,
    1] uint8 batch (150 images, read through its strides), every gate on,
    writing float32 or (``dtype``) bfloat16. Its parameters bit for bit
    against ``params_from_draw`` on the card; with both warps off, its
    Dropout and CoarseDropout masks bit for bit against the twin on the
    card and on the CPU in every order; then each of the six orders against
    both twins (float32 within ``TOL["warp_chain"]``, bfloat16 within
    ``BF16_ULPS`` of each element), timed, with its phase clock in float32.
    The library yardstick, never called by the port: ``F.grid_sample``
    (bilinear, zeros, ``align_corners=True``) of the images in the same
    dtype on a prebuilt grid, Affine's warp alone with cval 0. Rows for the
    ``kernels`` line: order (0, 1, 2), the two warps chained then the mask
    (ANP), and (0, 2, 1), warp, mask, warp (MAML); the bound counts uint8
    in and the output's width out."""
    import torch
    import torch.nn.functional as F

    from wmfml_tpu_torch.aug import image_aug
    from wmfml_tpu_torch.kernels import image_da as kda

    dtype = dtype or torch.float32
    f32 = dtype == torch.float32
    bits = torch.int32 if f32 else torch.int16
    tag = "image_da" + ("" if f32 else "_bf16")
    t_, s_, h, w = 10, 15, 128, 128
    b = t_ * s_
    batch = torch.randint(0, 256, (t_, 2 * s_, h, w, 1), dtype=torch.uint8,
                          generator=gen, device="cuda")
    x = batch[:, :s_]
    u, keys = da_draw(gen, b)
    xc, uc, kc = x.cpu(), u.cpu(), keys.cpu()

    def order_t(o, dev="cuda"):
        return torch.tensor([o], device=dev)

    def launch(uu, o):
        return kda.image_da_launch(x, uu, keys, o, dtype)

    got_p = torch.empty((b, kda.NPARAMS), device="cuda")
    kda.image_da_launch(x, u, keys, order_t(0), dtype, params_out=got_p)
    p = image_aug.params_from_draw(u, keys, order_t(0), h, w)
    want_p = torch.cat([p.warp.flatten(1), p.drop], 1)
    torch.cuda.synchronize()
    if not torch.equal(got_p.view(torch.int32), want_p.view(torch.int32)):
        raise AssertionError(f"{tag}: its parameters differ from "
                             f"params_from_draw's at "
                             f"{int((got_p != want_p).sum())} entries")
    dropped = {}
    for pick, kind in ((0.25, "Dropout"), (0.75, "CoarseDropout")):
        um = u.clone()
        um[:, 13] = um[:, 14] = 0.75
        um[:, 17] = pick
        for o in range(len(image_aug.ORDERS)):
            got = launch(um, order_t(o))
            for want in (kda.image_da_plain(x, um, keys, order_t(o),
                                            dtype).cpu(),
                         kda.image_da_plain(xc, um.cpu(), kc,
                                            order_t(o, "cpu"), dtype)):
                if not torch.equal(got.cpu().view(bits), want.view(bits)):
                    raise AssertionError(
                        f"{tag} ({kind}, order {o}): the mask differs from "
                        f"the twin's at {int((got.cpu() != want).sum())} "
                        f"elements")
        dropped[kind] = float((got.cpu() == 0).double().mean()
                              - (xc == 0).double().mean())

    xf = (xc.float() / 255.0).reshape(b, 1, h, w).cuda().to(dtype)
    library_ms = library_warp_ms(xf, p.warp[:, 1])

    rows = {}
    nbytes = (1 + xf.element_size()) * x.numel() + 4 * (
        u.numel() + keys.numel()) + 8
    for o, ops in enumerate(image_aug.ORDERS):
        ot = order_t(o)
        got = launch(u, ot)
        want = kda.image_da_plain(x, u, keys, ot, dtype)
        want_cpu = kda.image_da_plain(xc, uc, kc, order_t(o, "cpu"), dtype)
        torch.cuda.synchronize()
        if f32:
            err, rel = check_close("warp_chain", got, want)
            err_cpu, _ = check_close("warp_chain", got.cpu(), want_cpu)
            ulps = {}
        else:
            ulps = dict(max_ulps_card_twin=bf16_ulps(got, want),
                        max_ulps_cpu_twin=bf16_ulps(got.cpu(), want_cpu))
            if max(ulps.values()) > BF16_ULPS:
                raise AssertionError(f"{tag} (order {ops}): {ulps} bfloat16 "
                                     f"ulps from the twins")
            err = (got.float() - want.float()).abs().max().item()
            err_cpu = (got.cpu().float() - want_cpu.float()).abs().max().item()
            rel = None
        times = in_turns({
            "ms": lambda: launch(u, ot),
            "plain_ms": lambda: kda.image_da_plain(x, u, keys, ot, dtype)})
        names = set()
        times.update(device_profile(lambda: launch(u, ot), names=names))
        if len(names) != 1 or times["kernels_per_call"] != 1:
            raise AssertionError(f"{tag} issued {times['kernels_per_call']} "
                                 f"kernels per call: {sorted(names)}")
        if f32:
            times["phase_us"] = da_phases(x, u, keys, ot)
        flops, iops = da_work(p, o, h, w)
        # the FP32 and INT32 lanes are separate pipes that run side by side
        t_ops = max(flops / PEAK_F32_FLOPS, iops / PEAK_INT32_OPS)
        t_bytes = nbytes / PEAK_BYTES_PER_S
        rows[o] = dict(
            **_rows("image_da", dtype, "MAML" if o == 1 else "ANP"),
            tol="warp_chain",
            shape=f"[10, 15 of 30, 128, 128, 1] uint8 -> {xf.dtype}, order "
                  f"{ops}, every gate on",
            source="wmfml_tpu_torch/csrc/image_da.cu",
            replaces="wmfml_tpu/aug/image_aug.py:537",
            library="F.grid_sample, bilinear, zeros, Affine alone, cval 0",
            max_abs_err=max(err, err_cpu), max_rel_err=rel,
            max_abs_err_card_twin=err, max_abs_err_cpu_twin=err_cpu, **ulps,
            **times, library_ms=library_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bound_f32_ms=max(t_ops, t_bytes) * 1e3, flops=flops, int_ops=iops,
            dropped_share=dropped)
    for o in range(1, len(image_aug.ORDERS)):   # order 0 is printed in the table
        r = rows[o]
        log(f"kernel: {tag} order {image_aug.ORDERS[o]}: max abs err "
            f"{r['max_abs_err']} (card twin {r['max_abs_err_card_twin']}, CPU "
            f"twin {r['max_abs_err_cpu_twin']}{'; ' if ulps else ''}"
            f"{ulps or ''}); {r['ms']} ms ({r['device_ms']} ms of it on the "
            f"device, {r['kernels_per_call']} kernels per call), plain "
            f"{r['plain_ms']} ms, library {library_ms} ms, bound "
            f"{r['bound_ms']} ms by {r['bound_by']}; phase clock (us) "
            f"{r.get('phase_us')}")
    log(f"kernel: {tag}: parameters equal params_from_draw's bit for bit; "
        f"masks with the warps off equal the twins' bit for bit in every "
        f"order (share of pixels dropped beyond the zeros of x: {dropped})")
    return [rows[0], rows[1]]


def library_warp_ms(xf, row):
    """The library yardstick of K6, never called by the port: ``F.grid_sample``
    (bilinear, zeros, ``align_corners=True``) of the images ``xf`` [B, 1, H,
    W] in their dtype on a prebuilt grid, one warp stage (``row`` [B, 7]:
    scale, shift) alone with cval 0."""
    import torch
    import torch.nn.functional as F

    b, _, h, w = xf.shape
    sx, sy, tx, ty = row[:, :4].unbind(-1)

    def axis_grid(n, scale, shift):    # (j - c - shift) / scale + c -> [-1, 1]
        c = (n - 1) / 2.0
        j = torch.arange(n, device="cuda", dtype=torch.float32)
        src = (j[None] - c - shift[:, None]) / scale[:, None] + c
        return 2.0 * src / (n - 1) - 1.0

    gx, gy = axis_grid(w, sx, tx), axis_grid(h, sy, ty)
    grid = torch.stack([gx[:, None, :].expand(b, h, w),
                        gy[:, :, None].expand(b, h, w)], -1).to(xf.dtype)
    return cuda_ms(lambda: F.grid_sample(
        xf, grid, mode="bilinear", padding_mode="zeros", align_corners=True))


# K6's programs 1-3, 6 and 7 -> the training phase whose launches their
# rows report
PROGRAM_PATHS = {"pascal_1d": "Pascal ANP", "pascal_1d_fixed":
                 "Pascal ANP fixed", "shapenet_1d_fixed": "ANP fixed",
                 "shapenet_3d": "ShapeNet3D ANP",
                 "shapenet_3d_fixed": "ShapeNet3D ANP fixed"}
# float operations an element of GammaContrast (the clamp's two, pow as a
# logarithm, a multiply and an exponential), and a pixel of
# AddToBrightness (V's two maxima, the add, the clamp's two, the
# denominator's maximum, the division, three multiplies)
GAMMA_OPS = 5
BRIGHT_OPS = 10


def program_draw(program, gen, b):
    """A call's raw draw for ``program`` with every gate on (the warps,
    gamma, the blur at k = 3 for even images and 2 for odd ones, the
    dropout op); Affine's nearest taps and Dropout or CoarseDropout as
    drawn."""
    import torch

    from wmfml_tpu_torch.aug import image_aug

    u, keys, _ = image_aug.Augmenter(program=program).sample(b, gen, "cuda")
    u[:, 13] = u[:, 14] = u[:, 16] = 0.25
    if u.shape[1] > 19:
        u[:, 19] = u[:, 21] = 0.25
        u[:, 22] = torch.where(torch.arange(b, device="cuda") % 2 == 0, 0.9,
                               0.5)
    return u, keys


def pixel_work(program, p, h, w, c=1):
    """(float operations, integer operations) of K6's ``program`` on this
    draw of ``c``-channel images: a multiply-add per nonzero (row tap,
    column tap) and channel of each warp op applied, and its fill (4 a
    pixel); GAMMA_OPS an element for gamma; k^2 - 1 adds and a division an
    element for the blur; BRIGHT_OPS a pixel for brightness; the dropout
    op's hashes as ``da_work``'s (the fixed grid's cells as CoarseDropout's),
    per channel where the draw says so."""
    import torch

    from wmfml_tpu_torch.aug import image_aug
    from wmfml_tpu_torch.kernels import image_da as kda

    b = p.warp.shape[0]
    fixed = kda.PROGRAM_ORDERS[program] == 1
    flops = 0.0
    # the warp rows the program applies: geometric's one warp (row 0),
    # Distractor's Affine alone (row 1), or CropAndPad and Affine
    used = ([0] if program in kda.GEOMETRIC else
            [1] if program.startswith("distractor") else [0, 1])
    for row in (p.warp[:, i] for i in used):
        gate = row[:, 6] > 0.5
        st = image_aug.stages_from_params(row[:, None], [0])[0]
        wy, wx = image_aug.stage_matrices(h, w, st["scale"], st["translate"],
                                          st["nearest"], st["gate"])
        taps = ((wy != 0).sum(-1).double()[:, :, None]
                * (wx != 0).sum(-1).double()[:, None, :])
        flops += float((2 * c * taps.sum((1, 2)) + 4 * h * w)[gate].sum())
    if p.pixel is not None:
        g_on, _, b_on, k = p.pixel[:, :4].unbind(-1)
        flops += float((g_on > 0.5).sum()) * GAMMA_OPS * h * w * c
        kk = k[(b_on > 0.5) & (k > 1.5)].double()
        flops += float((kk * kk).sum()) * h * w * c
        if p.pixel.shape[1] == 6:
            flops += float((p.pixel[:, 4] > 0.5).sum()) * BRIGHT_OPS * h * w
    gate, pick = p.drop[:, 0] > 0.5, p.drop[:, 1] > 0.5
    per_channel = torch.where(p.drop[:, 4] > 0.5, float(c), 1.0).double()
    if fixed:
        gh, gw = image_aug.fixed_grid(h, w)
        cells = torch.full((b,), float(gh * gw), dtype=torch.float64,
                           device=p.drop.device)
    else:
        cells = (torch.clamp_min(torch.round(h * p.drop[:, 3]), 1.0)
                 * torch.clamp_min(torch.round(w * p.drop[:, 3]), 1.0)
                 ).double() * per_channel
    iops = float(per_channel[gate & pick].sum()) * HASH_OPS * h * w + float(
        (cells[gate & ~pick] * HASH_OPS + h * w * c).sum())
    return flops, iops


def check_image_da_programs(gen, programs=("pascal_1d", "shapenet_1d_fixed",
                                           "pascal_1d_fixed"), tasks=10):
    """K6's ``programs`` at the DA call's shape (the context slice of a [T,
    30, 128, 128, 1] uint8 batch, 15 T images: 150 at T = 10, 600 at
    ``tasks`` = 40), every gate on, against their
    twins: each program's parameters bit for bit against its
    ``params_from_draw`` (``params_for``) on the card; with the warps and
    pixel ops off and the dropout op on (Dropout, then CoarseDropout), its
    masks bit for bit against the twin on the card and on the CPU, float32
    and bfloat16; Pascal1D's chain in 12 orders (the identity, the reverse
    and 10 drawn) against the card twin and in 2 of them against the CPU
    twin (``TOL["pixel_ops"]``), and in bfloat16 in 2 orders
    (``check_bf16``); each fixed program against both twins in float32 and
    bfloat16. Timed: Pascal1D's chain in its identity order and Pascal1D's
    fixed program in float32 (P1's and its fixed twin's dtype), ShapeNet1D's
    fixed program in bfloat16 (P3's); the library yardstick is
    ``library_warp_ms`` of the program's first warp."""
    import torch

    from wmfml_tpu_torch.aug import image_aug
    from wmfml_tpu_torch.kernels import image_da as kda

    t_, s_, h, w = tasks, 15, 128, 128
    b = t_ * s_
    batch = torch.randint(0, 256, (t_, 2 * s_, h, w, 1), dtype=torch.uint8,
                          generator=gen, device="cuda")
    x = batch[:, :s_]
    xc = x.cpu()
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    drawn = torch.randperm(118, generator=torch.Generator().manual_seed(3))
    for program in programs:
        fixed = kda.PROGRAM_ORDERS[program] == 1
        u, keys = program_draw(program, gen, b)
        uc, kc = u.cpu(), keys.cpu()
        orders = ([None] if fixed else
                  [0, 119] + [int(o) + 1 for o in drawn[:10]])

        def order_t(o, dev="cuda"):
            return None if o is None else torch.tensor([o], device=dev)

        # the order tensors made once: a launch in the timed loops copies
        # nothing from the host
        on_card = {o: order_t(o) for o in orders}

        def launch(uu, o, dtype=f32, **kw):
            return kda.image_da_launch(x, uu, keys, on_card[o], dtype,
                                       program=program, **kw)

        def twin(uu, o, dtype=f32, cpu=False):
            if cpu:
                return kda.image_da_plain(xc, uu.cpu(), kc, order_t(o, "cpu"),
                                          dtype, program)
            return kda.image_da_plain(x, uu, keys, on_card[o], dtype,
                                      program)

        got_p = torch.empty((b, kda.nparams(program)), device="cuda")
        launch(u, orders[0], params_out=got_p)
        p = image_aug.params_for(program, u, keys, on_card[orders[0]], h, w)
        want_p = image_aug.params_row(p)
        torch.cuda.synchronize()
        if not torch.equal(got_p.view(torch.int32), want_p.view(torch.int32)):
            raise AssertionError(f"image_da {program}: its parameters differ "
                                 f"from the twin's at "
                                 f"{int((got_p != want_p).sum())} entries")
        dropped = {}
        for pick, kind in ((0.25, "Dropout"), (0.75, "CoarseDropout")):
            um = u.clone()
            um[:, 13] = um[:, 14] = 0.75
            if um.shape[1] > 19:
                um[:, 19] = um[:, 21] = 0.75
            um[:, 17] = pick
            for dtype, bits in ((f32, torch.int32), (bf16, torch.int16)):
                for o in orders[:2]:
                    got = launch(um, o, dtype).cpu()
                    for want in (twin(um, o, dtype).cpu(),
                                 twin(um, o, dtype, cpu=True)):
                        if not torch.equal(got.view(bits), want.view(bits)):
                            raise AssertionError(
                                f"image_da {program} ({kind}, {dtype}, order "
                                f"{o}): the mask differs from the twin's at "
                                f"{int((got != want).sum())} elements")
            dropped[kind] = float((got == 0).double().mean()
                                  - (xc == 0).double().mean())
        worst = {"card twin": 0.0, "CPU twin": 0.0}
        for i, o in enumerate(orders):
            got = launch(u, o)
            err, _ = check_close("pixel_ops", got, twin(u, o))
            worst["card twin"] = max(worst["card twin"], err)
            if i < 2:
                err, _ = check_close("pixel_ops", got.cpu(),
                                     twin(u, o, cpu=True))
                worst["CPU twin"] = max(worst["CPU twin"], err)
            if torch.equal(got.cpu(), image_aug.to_unit(xc)):
                raise AssertionError(f"image_da {program}: order {o} left "
                                     f"the images unchanged")
        # each Pascal1D op rounds to bfloat16 at its end: a sum near a
        # rounding boundary that rounds the other way moves on through the
        # next warp, gamma and the blur's window, so no per-element ulp
        # bound there, the rule alone; ShapeNet1D's fixed program (one
        # warp, then the mask) keeps it, as program 0 does
        bf16_err = [check_bf16(f"image_da {program} order {o}",
                               launch(u, o, bf16), twin(u, o, bf16),
                               twin(u, o),
                               element_ulps=program == "shapenet_1d_fixed")[0]
                    for o in orders[:2]]
        log(f"kernel: image_da {program}: parameters bit for bit; masks bit "
            f"for bit in float32 and bfloat16 (share of pixels dropped beyond "
            f"the zeros of x: {dropped}); float32 in {len(orders)} order(s) "
            f"{orders}: max abs err {worst} (atol, rtol "
            f"{TOL['pixel_ops']}); bfloat16 in {orders[:2]}: max abs err "
            f"{bf16_err} (the bfloat16 rule)")

        dtype = bf16 if program == "shapenet_1d_fixed" else f32
        o = orders[0]
        got = launch(u, o, dtype)
        want = twin(u, o, dtype)
        err = (got.float() - want.float()).abs().max().item()
        times = in_turns({"ms": lambda: launch(u, o, dtype),
                          "plain_ms": lambda: twin(u, o, dtype)})
        names = set()
        times.update(device_profile(lambda: launch(u, o, dtype),
                                    names=names))
        if len(names) != 1 or times["kernels_per_call"] != 1:
            raise AssertionError(f"image_da {program} issued "
                                 f"{times['kernels_per_call']} kernels per "
                                 f"call: {sorted(names)}")
        xf = (xc.float() / 255.0).reshape(b, 1, h, w).cuda().to(dtype)
        library_ms = library_warp_ms(xf, p.warp[:, 0])
        flops, iops = pixel_work(program, p, h, w)
        nbytes = (1 + xf.element_size()) * x.numel() + 4 * (
            u.numel() + keys.numel()) + (0 if fixed else 8)
        t_ops = max(flops / PEAK_F32_FLOPS, iops / PEAK_INT32_OPS)
        t_bytes = nbytes / PEAK_BYTES_PER_S
        order_txt = ("fixed order" if fixed else
                     f"order {image_aug.PASCAL_ORDERS[o]}")
        ids = _rows(f"image_da_{program}", dtype, PROGRAM_PATHS[program]
                    + ("" if tasks == 10 else f" T{tasks}"), tasks)
        ids["kernel"] = "image_da"
        rows.append(dict(
            **ids, tol="pixel_ops", program=program,
            shape=f"[{t_}, 15 of 30, 128, 128, 1] uint8 -> {dtype}, "
                  f"{order_txt}, every gate on",
            source="wmfml_tpu_torch/csrc/image_da.cu",
            replaces=("wmfml_tpu/aug/image_aug.py:578" if fixed else
                      "wmfml_tpu/aug/image_aug.py:569"),
            library="F.grid_sample, bilinear, zeros, one warp stage, cval 0",
            max_abs_err=err, max_rel_err=None, max_abs_err_orders=worst,
            **times, library_ms=library_ms,
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bound_f32_ms=max(t_ops, t_bytes) * 1e3, flops=flops,
            int_ops=iops, dropped_share=dropped))
    return rows


def rgba_batch(gen, shape):
    """Float RGBA images [*shape, 64, 64, 4] as the sampler composites them:
    alpha 1 on about a third of the pixels, some black foreground pixels
    (brightness's gray branch)."""
    import torch

    x = torch.rand(shape + (64, 64, 4), generator=gen, device="cuda")
    x[..., 3] = torch.where(torch.rand(shape + (64, 64), generator=gen,
                                       device="cuda") < 0.35, 1.0,
                            x[..., 3] * 0.9)
    x[..., :3] *= torch.rand(shape + (64, 64, 1), generator=gen,
                             device="cuda") > 0.05
    return x


def check_image_da_rgb(gen, dtype=None):
    """K6's ShapeNet3D programs at S1's (and S3's) two DA calls: the RGB
    channels of the context and query slices of a [20, 30, 64, 64, 4]
    RGBA batch (300 images each), float32 or (``dtype``, S5's and S6's)
    bfloat16, read through their strides, every gate on. Per program and
    call: its parameters bit for bit against ``params_for`` on the card;
    with every other op off and the dropout op on (Dropout, then
    CoarseDropout, per channel where drawn), its masks bit for bit against
    the twin on the card and on the CPU, in two orders; its output against
    the card twin and the CPU twin in ten orders (program 6: the identity,
    the reverse and 8 drawn of the 720; float32 within
    ``TOL["pixel_ops"]``; bfloat16 within ``BF16_K6_ULPS`` of each element,
    differing on at most ``BF16_K6_SHARE`` of them, and within
    ``check_bf16``'s rule); timed in the identity or the fixed order,
    with ``library_warp_ms`` of CropAndPad's (or geometric's) warp on [300,
    3, 64, 64] as the library yardstick."""
    import torch

    from wmfml_tpu_torch.aug import image_aug
    from wmfml_tpu_torch.kernels import image_da as kda

    f32 = dtype or torch.float32      # the images' and the output's dtype
    bf16 = f32 == torch.bfloat16
    bits = torch.int16 if bf16 else torch.int32
    t_, s_, h, w = 20, 15, 64, 64
    batch = rgba_batch(gen, (t_, 2 * s_)).to(f32)
    drawn = torch.randperm(718, generator=torch.Generator().manual_seed(6))
    rows = []
    for program in ("shapenet_3d", "shapenet_3d_fixed"):
        fixed = program == "shapenet_3d_fixed"
        orders = ([None] if fixed else
                  [0, 719] + [int(o) + 1 for o in drawn[:8]])
        on_card = {o: None if o is None else torch.tensor([o], device="cuda")
                   for o in orders}
        for call, x in (("", batch[:, :s_, ..., :3]),
                        ("_qry", batch[:, s_:, ..., :3])):
            b, xc = t_ * s_, x.cpu()
            u, keys = program_draw(program, gen, b)
            u[:, 23] = 0.25                        # brightness on

            def launch(uu, o, **kw):
                return kda.image_da_launch(x, uu, keys, on_card[o], f32,
                                           program=program, **kw)

            def twin(uu, o, cpu=False, dt=f32):
                if cpu:
                    return kda.image_da_plain(
                        xc, uu.cpu(), keys.cpu(),
                        None if o is None else on_card[o].cpu(), dt, program)
                return kda.image_da_plain(x, uu, keys, on_card[o], dt,
                                          program)

            got_p = torch.empty((b, kda.nparams(program)), device="cuda")
            launch(u, orders[0], params_out=got_p)
            p = image_aug.params_for(program, u, keys, on_card[orders[0]], h,
                                     w)
            want_p = image_aug.params_row(p)
            torch.cuda.synchronize()
            if not torch.equal(got_p.view(torch.int32),
                               want_p.view(torch.int32)):
                raise AssertionError(f"image_da {program}: its parameters "
                                     f"differ from the twin's at "
                                     f"{int((got_p != want_p).sum())} entries")
            dropped = {}
            for pick, kind in ((0.25, "Dropout"), (0.75, "CoarseDropout")):
                um = u.clone()
                um[:, [13, 14, 19, 21, 23]] = 0.75    # the other ops off
                um[:, 17] = pick
                for o in orders[:2]:
                    got = launch(um, o).cpu()
                    for want in (twin(um, o).cpu(), twin(um, o, cpu=True)):
                        if not torch.equal(got.view(bits), want.view(bits)):
                            raise AssertionError(
                                f"image_da {program} ({kind}, order {o}): the "
                                f"mask differs from the twin's at "
                                f"{int((got != want).sum())} elements")
                dropped[kind] = float((got == 0).double().mean()
                                      - (xc == 0).double().mean())
            worst = {"card twin": 0.0, "CPU twin": 0.0}
            differ = dict(worst)
            for o in orders:
                got = launch(u, o)
                for where in ("card twin", "CPU twin"):
                    cpu = where == "CPU twin"
                    g, want = (got.cpu() if cpu else got), twin(u, o, cpu)
                    if not bf16:
                        err = check_close("pixel_ops", g, want)[0]
                    else:
                        err = bf16_ulps(g, want)
                        share = float((g != want).double().mean())
                        if (err > BF16_K6_ULPS[program]
                                or share > BF16_K6_SHARE):
                            raise AssertionError(
                                f"image_da {program} bfloat16 (order {o}): "
                                f"elements lie up to {err} bfloat16 ulps "
                                f"from the {where}'s, {share} of them "
                                f"differ")
                        differ[where] = max(differ[where], share)
                    worst[where] = max(worst[where], err)
                if bf16:
                    check_bf16(f"image_da_{program}", got, twin(u, o),
                               twin(u, o, dt=torch.float32),
                               element_ulps=False)
                if torch.equal(got.cpu(), xc):
                    raise AssertionError(f"image_da {program}: order {o} "
                                         f"left the images unchanged")
            log(f"kernel: image_da {program}{call} ({b} images of 64 x 64 x "
                f"3 from {'bfloat16' if bf16 else 'float32'} RGBA): "
                f"parameters bit for bit; masks bit for bit in "
                f"orders {orders[:2]} (share of elements dropped beyond the "
                f"zeros of x: {dropped}); {len(orders)} order(s) {orders}: "
                f"max {'bfloat16 ulps' if bf16 else 'abs err'} {worst}"
                + (f", largest share of elements that differ {differ} (at "
                   f"most {BF16_K6_ULPS[program]} ulps on {BF16_K6_SHARE} of "
                   f"them, and the bfloat16 rule)" if bf16 else
                   f" (atol, rtol {TOL['pixel_ops']})"))
            o = orders[0]
            err = (launch(u, o).float() - twin(u, o).float()).abs().max(
                ).item()
            times = in_turns({"ms": lambda: launch(u, o),
                              "plain_ms": lambda: twin(u, o)})
            names = set()
            times.update(device_profile(lambda: launch(u, o), names=names))
            if len(names) != 1 or times["kernels_per_call"] != 1:
                raise AssertionError(f"image_da {program} issued "
                                     f"{times['kernels_per_call']} kernels "
                                     f"per call: {sorted(names)}")
            xf = x.permute(0, 1, 4, 2, 3).reshape(b, 3, h, w).contiguous()
            library_ms = library_warp_ms(xf, p.warp[:, 0])
            flops, iops = pixel_work(program, p, h, w, c=3)
            # RGBA read once (16 B a pixel, bfloat16 8), RGB written once
            # (12 B, bfloat16 6)
            nbytes = (14 if bf16 else 28) * b * h * w + 4 * (
                u.numel() + keys.numel()) + (0 if fixed else 8)
            t_ops = max(flops / PEAK_F32_FLOPS, iops / PEAK_INT32_OPS)
            t_bytes = nbytes / PEAK_BYTES_PER_S
            ids = _rows(f"image_da_{program}{call}", f32,
                        PROGRAM_PATHS[program])
            ids["kernel"] = "image_da"
            if bf16:
                # S6 runs program 6 in bfloat16 (S5 too); no path runs
                # program 7 in bfloat16
                ids["path"] = "ShapeNet3D ANP bf16"
                if fixed:
                    ids["path"] = None
                    ids["off_path"] = ("no path runs program 7 in bfloat16 "
                                       "(S3 runs it in float32)")
            rows.append(dict(
                **ids, tol="pixel_ops", program=program,
                shape=f"[20, 15 of 30, 64, 64, 3 of 4] {ids['dtype']} -> "
                      f"{ids['dtype']}, "
                      f"{'fixed order' if fixed else 'order 0'}, every gate "
                      f"on",
                source="wmfml_tpu_torch/csrc/image_da.cu",
                replaces=("wmfml_tpu/aug/image_aug.py:578" if fixed else
                          "wmfml_tpu/aug/image_aug.py:569"),
                library=f"F.grid_sample, bilinear, zeros, one warp stage "
                        f"at [300, 3, 64, 64], cval 0, {ids['dtype']}",
                max_abs_err=err, max_rel_err=None, max_abs_err_orders=worst,
                **times, library_ms=library_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_f32_ms=max(t_ops, t_bytes) * 1e3, flops=flops,
                int_ops=iops, dropped_share=dropped))
    return rows


def check_favor_wide(proj, gen, nq, nk, name, path, dtype=None,
                     off_path=None):
    """K2's wide form at a Distractor path's shape: T = 20, 8 heads of d = e
    = 256 with ANPDistractor's projection (m = 1419); q [20, 8, nq, 256], k
    and v [20, 8, nk, 256] as the attention block hands them over ([T, N,
    H, d] transposed), float32 or (``dtype``) bfloat16, shots 1..nk across
    the tasks (masked rows present, a task with one real row), within
    ``TOL["favor_attention_wide"]`` of the twin in the same dtype. One call
    must issue one kernel, the wide one. The row reports ``path``'s
    launches, or none where ``off_path`` says why no path runs the shape."""
    import torch

    from wmfml_tpu_torch.kernels import favor

    dtype = dtype or torch.float32
    t_, h, d = 20, 8, proj.shape[1]
    q = torch.randn((t_, nq, h, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    k, v = (torch.randn((t_, nk, h, d), generator=gen, device="cuda"
                        ).to(dtype).transpose(1, 2) for _ in range(2))
    shots = torch.tensor([1 + ((nk - 1) * i) // (t_ - 1) for i in range(t_)],
                         device="cuda")
    mask = torch.arange(nk, device="cuda")[None, :] < shots[:, None]
    got = favor.favor_launch(q, k, v, proj, mask)
    want = favor.favor_plain(q, k, v, proj, mask)
    # bfloat16: at d = 256 the normalizer 256^-1/4 = 1/4 is exact, so dn x
    # rounds nothing and bfloat16 moves only the diagonal term, below
    # float32's summation noise: the kernel is held to its bfloat16 twin
    # within the float32 tolerance, far inside check_bf16's bound
    err, rel = check_close("favor_attention_wide", got, want)
    times = in_turns({"ms": lambda: favor.favor_launch(q, k, v, proj, mask),
                      "plain_ms": lambda: favor.favor_plain(q, k, v, proj,
                                                            mask)})
    names = set()
    times.update(device_profile(
        lambda: favor.favor_launch(q, k, v, proj, mask), names=names))
    if (len(names) != 1 or times["kernels_per_call"] != 1
            or "favor_kernel_wide" not in next(iter(names))):
        raise AssertionError(f"{name} issued {times['kernels_per_call']} "
                             f"kernels per call: {sorted(names)}")
    times["phase_us"] = favor_wide_phases(q, k, v, proj, mask)
    m, e, items, r = proj.shape[0], v.shape[-1], t_ * h, nq + nk
    # dash in split TF32 on the tensor cores (bfloat16 rows are exact in
    # TF32: two products, not three); A, A v and the row sums on the CUDA
    # cores; the bytes: each input read once, the output written once (the
    # kernel's round trip of dash through global memory is its own choice,
    # not the function's)
    split_flops = 2 * items * r * m * d
    flops = 2 * items * (nq * nk * m + nq * nk * e + nq * nk)
    nbytes = (q.element_size() * (q.numel() + k.numel() + v.numel())
              + 4 * (proj.numel() + got.numel()) + mask.numel())
    ids = _rows(name, torch.float32, path or "")
    ids.update(kernel="favor_attention",
               dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    if off_path:
        ids.update(path=None, off_path=off_path)
    return dict(**ids, tol="favor_attention_wide",
                shape=f"q [20, 8, {nq}, 256], k, v [20, 8, {nk}, 256] "
                      f"{ids['dtype']}, m {m}, shots 1..{nk}",
                source="wmfml_tpu_torch/csrc/favor.cu",
                replaces="wmfml_tpu/nn/attention.py:93",
                max_abs_err=err, max_rel_err=rel, **times, library_ms=None,
                **bound(flops, nbytes, split_flops=split_flops,
                        split_products=3 if dtype == torch.float32 else 2))


def favor_wide_phases(q, k, v, proj, mask, runs=10):
    """K2 wide's phase clock (``favor.WIDE_PHASES``, the global timer read
    by each block's first thread): microseconds from the first block's
    start until the last block reached each point, and each phase's mean
    over the blocks; medians over ``runs`` launches."""
    import statistics

    import torch

    from wmfml_tpu_torch.kernels import favor

    rows = favor.wide_grid(q.shape[0] * q.shape[1], proj.shape[0])
    per_run = []
    for _ in range(runs):
        st = torch.full((rows, len(favor.WIDE_PHASES)), -1,
                        dtype=torch.int64, device="cuda")
        favor.favor_launch(q, k, v, proj, mask, stamps=st)
        s = st.cpu().double()
        row = {name: float(s[:, j].max() - s[:, 0].min()) / 1e3
               for j, name in enumerate(favor.WIDE_PHASES) if j}
        row["phase1_mean"] = float((s[:, 1] - s[:, 0]).mean()) / 1e3
        row["phase2_mean"] = float((s[:, 3] - s[:, 2]).mean()) / 1e3
        per_run.append(row)
    return {k: statistics.median(r[k] for r in per_run) for k in per_run[0]}


def check_image_da_distractor(gen, dtype=None):
    """K6's Distractor programs at D1's (and D3's) two DA calls: the context
    slice of a [20, 33, 128, 128, 1] uint8 batch (300 images) and its query
    slice (360), read through their strides, every gate on, into float32
    or (``dtype``, D5's) bfloat16. Per program and call: its parameters bit
    for bit against ``params_for`` on the card; with Affine off and the
    dropout op on (Dropout, then CoarseDropout), its masks on 1 - x / 255
    (in bfloat16 the twice-rounded 1 - bf16(x / 255)) bit for bit against
    the twin on the card and on the CPU, in each order; its output against
    both twins in each order (program 4: 2; float32 within
    ``TOL["warp_chain"]``, bfloat16 within 1 bfloat16 ulp of each element
    and ``check_bf16``'s rule); timed in order 0 (program 4) or the fixed
    order, with ``library_warp_ms`` of Affine's warp on the inverted images
    as the library yardstick."""
    import torch

    from wmfml_tpu_torch.aug import image_aug
    from wmfml_tpu_torch.kernels import image_da as kda

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    t_, s_, q_, h, w = 20, 15, 18, 128, 128
    batch = torch.randint(0, 256, (t_, s_ + q_, h, w, 1), dtype=torch.uint8,
                          generator=gen, device="cuda")
    bits = torch.int16 if bf16 else torch.int32
    rows = []
    for program in ("distractor", "distractor_fixed"):
        fixed = program == "distractor_fixed"
        orders = [None] if fixed else [0, 1]
        on_card = {o: None if o is None else torch.tensor([o], device="cuda")
                   for o in orders}
        for call, x in (("", batch[:, :s_]), ("_qry", batch[:, s_:])):
            b, xc = t_ * x.shape[1], x.cpu()
            u, keys = program_draw(program, gen, b)

            def launch(uu, o, **kw):
                return kda.image_da_launch(x, uu, keys, on_card[o], dtype,
                                           program=program, **kw)

            def twin(uu, o, cpu=False, dt=dtype):
                if cpu:
                    return kda.image_da_plain(
                        xc, uu.cpu(), keys.cpu(),
                        None if o is None else on_card[o].cpu(), dt, program)
                return kda.image_da_plain(x, uu, keys, on_card[o], dt,
                                          program)

            got_p = torch.empty((b, kda.nparams(program)), device="cuda")
            launch(u, orders[0], params_out=got_p)
            p = image_aug.params_for(program, u, keys, on_card[orders[0]], h,
                                     w)
            want_p = image_aug.params_row(p)
            torch.cuda.synchronize()
            if not torch.equal(got_p.view(torch.int32),
                               want_p.view(torch.int32)):
                raise AssertionError(f"image_da {program}: its parameters "
                                     f"differ from the twin's at "
                                     f"{int((got_p != want_p).sum())} entries")
            dropped = {}
            for pick, kind in ((0.25, "Dropout"), (0.75, "CoarseDropout")):
                um = u.clone()
                um[:, 14], um[:, 17] = 0.75, pick      # Affine off
                for o in orders:
                    got = launch(um, o).cpu()
                    for want in (twin(um, o).cpu(), twin(um, o, cpu=True)):
                        if not torch.equal(got.view(bits), want.view(bits)):
                            raise AssertionError(
                                f"image_da {program} ({kind}, order {o}): the "
                                f"mask differs from the twin's at "
                                f"{int((got != want).sum())} elements")
                dropped[kind] = float((got == 0).double().mean()
                                      - (xc == 255).double().mean())
            worst = {"card twin": 0.0, "CPU twin": 0.0}
            for o in orders:
                got = launch(u, o)
                for where, want in (("card twin", twin(u, o)),
                                    ("CPU twin", twin(u, o, cpu=True))):
                    g = got if where == "card twin" else got.cpu()
                    if not bf16:
                        err = check_close("warp_chain", g, want)[0]
                    else:
                        err = bf16_ulps(g, want)
                        if err > BF16_K6_ULPS[program]:
                            raise AssertionError(
                                f"image_da {program} bfloat16 (order {o}): "
                                f"an element lies {err} bfloat16 ulps from "
                                f"the {where}'s")
                    worst[where] = max(worst[where], err)
                if bf16:
                    check_bf16(f"image_da_{program}", got, twin(u, o),
                               twin(u, o, dt=torch.float32),
                               element_ulps=False)
            log(f"kernel: image_da {program}{call} ({b} images, "
                f"{'bfloat16' if bf16 else 'float32'} out): parameters "
                f"bit for bit; masks bit for bit in orders {orders} (share "
                f"of pixels dropped beyond the zeros of 1 - x / 255: "
                f"{dropped}); max {'bfloat16 ulps' if bf16 else 'abs err'} "
                f"{worst} (" + (f"at most {BF16_K6_ULPS[program]} ulps and the "
                                f"bfloat16 rule" if bf16 else
                                f"atol, rtol {TOL['warp_chain']}") + ")")
            o = orders[0]
            err = (launch(u, o).float() - twin(u, o).float()).abs().max(
                ).item()
            times = in_turns({"ms": lambda: launch(u, o),
                              "plain_ms": lambda: twin(u, o)})
            names = set()
            times.update(device_profile(lambda: launch(u, o), names=names))
            if len(names) != 1 or times["kernels_per_call"] != 1:
                raise AssertionError(f"image_da {program} issued "
                                     f"{times['kernels_per_call']} kernels "
                                     f"per call: {sorted(names)}")
            xf = (1.0 - xc.float() / 255.0).reshape(b, 1, h, w).cuda().to(
                dtype)
            library_ms = library_warp_ms(xf, p.warp[:, 1])
            flops, iops = pixel_work(program, p, h, w)
            # a uint8 pixel read, a float32 or bfloat16 one written
            nbytes = (1 + (2 if bf16 else 4)) * x.numel() + 4 * (
                u.numel() + keys.numel()) + (0 if fixed else 8)
            t_ops = max(flops / PEAK_F32_FLOPS, iops / PEAK_INT32_OPS)
            t_bytes = nbytes / PEAK_BYTES_PER_S
            ids = _rows(f"image_da_{program}{call}", dtype,
                        "Distractor ANP" + (" fixed" if fixed else ""))
            ids["kernel"] = "image_da"
            if bf16:
                # D5 runs program 4 in bfloat16; no path runs program 5 in
                # bfloat16
                ids["path"] = "Distractor ANP bf16"
                if fixed:
                    ids["path"] = None
                    ids["off_path"] = ("no path runs program 5 in bfloat16 "
                                       "(D3 runs it in float32)")
            rows.append(dict(
                **ids, tol="warp_chain", program=program,
                shape=f"[20, {x.shape[1]} of 33, 128, 128, 1] uint8 -> "
                      f"{ids['dtype']}, "
                      f"{'fixed order' if fixed else 'order 0'}, "
                      f"every gate on",
                source="wmfml_tpu_torch/csrc/image_da.cu",
                replaces=("wmfml_tpu/aug/image_aug.py:580" if fixed else
                          "wmfml_tpu/aug/image_aug.py:562"),
                library=f"F.grid_sample, bilinear, zeros, Affine's warp, "
                        f"cval 0, {ids['dtype']}",
                max_abs_err=err, max_rel_err=None, max_abs_err_orders=worst,
                **times, library_ms=library_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_f32_ms=max(t_ops, t_bytes) * 1e3, flops=flops,
                int_ops=iops, dropped_share=dropped))
    return rows


def check_large_evaluation(tag, yaml, overrides, runs):
    """An evaluation sweep of a LargeCNP path: ``evaluation_cli`` with
    ``yaml`` over each (trainer's final checkpoint, extra overrides) of
    ``runs``. D4: ``cfg/evaluation/CNP_max_Distractor.yaml`` over D2's, then
    with ``method=ANPDistractor agg_mode=attention`` over D1's (eval-mode
    data: validation from the test categories, all 36 views as queries);
    S4: ``cfg/evaluation/ANP_ShapeNet3D.yaml`` over S1's (all 30 views as
    queries). max_ctx_num 25, so K2's wide form runs at Nq 36 or 30, Nk 25
    under no_grad. Both loss files 25 x 3 and finite, K2 launched once an
    episode on an ANP sweep and never on a CNP one, and the last point's
    validation loss against the same evaluation on the CPU. Returns the
    ANP sweep's K2 launches."""
    import copy

    import numpy as np

    from wmfml_tpu_torch.cli import evaluation_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data.factory import build_data
    from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
    from wmfml_tpu_torch.kernels.favor import favor_attention
    from wmfml_tpu_torch.models.registry import build_model

    launches = 0
    for trainer, extra in runs:
        ckpt = trainer.ckpt.path(f"model_end_{trainer.config.iterations}")
        config = Config(yaml, overrides + extra + [f"checkpoint={ckpt}"])
        favor_attention.launches = favor_attention.wide_launches = 0
        t0 = time.perf_counter()
        val, test = evaluation_cli.evaluate(config)
        wall = time.perf_counter() - t0
        n = config.max_ctx_num
        for name in ("val_losses.txt", "test_losses.txt"):
            arr = np.loadtxt(os.path.join(config.save_path, name))
            if arr.shape != (n, 3) or not np.isfinite(arr).all() or list(
                    arr[:, 0]) != list(range(1, n + 1)):
                raise AssertionError(f"{name}: {arr.shape}, {arr}")
        attention = config.agg_mode == "attention"
        want = 2 * n * config.val_iters if attention else 0
        if (favor_attention.launches, favor_attention.wide_launches) != (
                want, want):
            raise AssertionError(f"{tag} {config.method}: K2 launches "
                                 f"{favor_attention.launches}, wide "
                                 f"{favor_attention.wide_launches}; the "
                                 f"sweep says {want}")
        if attention:
            launches = favor_attention.launches
        cpu_cfg = copy.copy(config)
        cpu_cfg.device = "cpu"
        cpu_eval = ModelEvaluator(build_model(cpu_cfg), cpu_cfg,
                                  build_data(cpu_cfg, mode="eval"))
        want_loss, _ = cpu_eval._validate_iter("validation", n)
        err = abs(val[n - 1] - want_loss)
        log(f"eval: {tag} {config.method} over {ckpt}, ctx 1..{n}, "
            f"{config.val_iters} episodes a point of {config.tasks_per_batch} "
            f"tasks x {cpu_eval.data.query_num} queries, validation and "
            f"test, in {wall} s; K2 wide "
            f"launches {favor_attention.wide_launches}; validation loss "
            f"{val}; test loss {test}; at ctx {n}: card "
            f"{val[n - 1]}, CPU {want_loss}, abs err {err} (tolerance "
            f"{VAL_TOL} x |CPU| + {VAL_TOL})")
        if err > VAL_TOL * (abs(want_loss) + 1.0):
            raise AssertionError(f"{tag} {config.method}: card "
                                 f"{val[n - 1]}, CPU {want_loss}")
    return launches


# a kernel wrapper -> the kernel function whose nodes in a captured graph
# (and events in a trace) count its launches: K3's call also packs its
# weights and runs one conv_kernel a layer, then one bn_relu_kernel
GRAPH_NODE = {"literature_stem": "stem_fwd_kernel",
              "favor_attention": "favor_kernel",
              "maml_features": "bn_relu_kernel",
              "image_da": "image_da_kernel"}


def graph_nodes(dot_path):
    """Nodes of a captured graph from ``debug_dump``'s DOT (a node's record
    label spans several lines): all of them, the kernel nodes, and those of
    each of ``GRAPH_NODE``'s kernels."""
    import re

    with open(dot_path) as f:
        text = f.read()
    nodes = re.split(r'^[ \t]*(?="graph_\d+_node_\d+"\[)', text,
                     flags=re.M)[1:]
    kernels = [n for n in nodes if 'label="{KERNEL' in n]
    return dict(nodes=len(nodes), kernel_nodes=len(kernels),
                **{k: sum(name in n for n in kernels)
                   for k, name in GRAPH_NODE.items()})


def launches_per_step(trainer):
    """What the code says each kernel launches: per training step, and per
    validation episode (both splits are swept)."""
    cfg = trainer.config
    da = {"image_da": 2} if "data_aug" in cfg.aug_list else {}
    if "MAML" in cfg.method:
        inner, test = cfg.num_steps + 1, cfg.test_num_steps + 1
        return ({"literature_stem": inner, "maml_features": inner, **da},
                {"literature_stem": test, "maml_features": test})
    attention = {"favor_attention": 1} if cfg.agg_mode == "attention" else {}
    if cfg.task in ("distractor", "shapenet_3d"):   # LargeCNP: cuDNN trunk
        return {**attention, **da}, attention
    # a BBB encoder (MR) samples apart for the query and the context pass
    stem = {"literature_stem": 2 if "MR" in cfg.method else 1}
    return {**stem, **attention, **da}, {**stem, **attention}


def card_launches(trainer, issued):
    """Launches on the card from those the host issued (the counters): each
    captured launch was issued once and ran once per replay."""
    fused = trainer.train_step
    return {k: n + fused.captured_launches.get(k, 0) * (fused.replays - 1)
            for k, n in issued.items()}


def check_launches(trainer, launches):
    """Every kernel of the path launched on the card exactly as often as the
    code says (``launches_per_step``: K6 once per augmenter call, two calls
    a training step, whatever the op orders drawn on the card), and the
    capture held ``steps_per_call`` steps' launches."""
    cfg, fused = trainer.config, trainer.train_step
    step, episode = launches_per_step(trainer)
    k = fused.k
    sweeps = sum(1 for it in range(0, trainer.step, k)
                 if it % cfg.val_freq < k)
    splits = 1 if cfg.task == "pascal_1d" else 2     # Pascal1D: no test
    want = {name: trainer.step * n + splits * sweeps * cfg.val_iters
            * episode.get(name, 0) for name, n in step.items()}
    captured = {name: k * n for name, n in step.items()}
    tag = cfg.method + (" bf16" if cfg.compute_dtype == "bfloat16" else "")
    log(f"train {tag}: launches on the card {launches}, the code says "
        f"{want}; captured {fused.captured_launches}")
    if launches != want or any(fused.captured_launches[name] != n
                               for name, n in captured.items()):
        raise AssertionError(f"{tag}: launches {launches}, captured "
                             f"{fused.captured_launches}; the code says "
                             f"{want} and {captured}")


def replay_trace(trainer, tag):
    """One replay of the trained path's graph under torch.profiler: each
    kernel the capture holds shows in its trace, no more often than
    captured. A trace missing a kernel (the profiler loses events of
    ctypes launches now and then, PERF.md §7) is taken again, up to three
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fused = trainer.train_step
    want = {k: n for k, n in fused.captured_launches.items() if n}
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused(trainer.generator)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        got = {k: sum(GRAPH_NODE[k] in n for n in names) for k in want}
        TRACES["taken"] += 1
        log(f"train {tag}: one replay's trace: {len(names)} device events, "
            f"{got} of the captured {want} (attempt {attempt + 1} of 3)")
        if all(0 < got[k] <= want[k] for k in want):
            return got
        TRACES["empty" if not names else "short"] += 1
    raise AssertionError(f"{tag}: no trace of a replay showed every kernel "
                         f"of the capture {want}")


def train_phase(card, yaml, overrides, counters, tap=False):
    """Drive one path through ``train_cli``'s trainer, which trains through
    CUDA graph replays (``FusedSteps``); return (trainer, launches per
    kernel on the card in that run, the graph's nodes). In ``compute_dtype: bfloat16`` every
    launch must have been a bfloat16 one, and every K6 launch one of the
    path's program (its task's, ``_fixed`` for ``aug_random_order:
    false``). The captured graph's DOT must hold as many nodes of each
    kernel as the capture issued, and a trace of one more replay must show
    them. With ``tap`` (an MR path) the BBB encoder's first layer is
    tapped before the capture, and two more replays must draw different
    weights (``check_replays_draw_anew``)."""
    import tempfile

    import torch

    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config

    config = Config(yaml, overrides)
    for fn in counters.values():
        fn.launches = fn.bf16_launches = 0
        if hasattr(fn, "wide_launches"):
            fn.wide_launches = 0
        if hasattr(fn, "program_launches"):
            fn.program_launches = dict.fromkeys(fn.program_launches, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_cli.build_trainer(config)
    fused = trainer.train_step
    seen = tap_sample(trainer) if tap else None
    with tempfile.TemporaryDirectory() as tmp:
        fused.dot_path = os.path.join(tmp, "step.dot")
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        issued = {name: fn.launches for name, fn in counters.items()}
        nodes = graph_nodes(fused.dot_path)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = card_launches(trainer, issued)
    bf16 = config.compute_dtype == "bfloat16"
    in_bf16 = {name: fn.bf16_launches for name, fn in counters.items()}
    if in_bf16 != (issued if bf16 else {k: 0 for k in issued}):
        raise AssertionError(f"{config.method} in {config.compute_dtype}: "
                             f"launches {issued}, in bfloat16 {in_bf16}")
    if "favor_attention" in counters:     # K2's wide form: LargeCNP's
        wide = counters["favor_attention"].wide_launches
        want_wide = (issued["favor_attention"]
                     if config.task in ("distractor", "shapenet_3d") else 0)
        if wide != want_wide:
            raise AssertionError(f"{config.method}: {wide} of "
                                 f"{issued['favor_attention']} K2 launches "
                                 f"wide, the path says {want_wide}")
    program = config.task + ("" if config.aug_random_order else "_fixed")
    if "image_da" in counters:
        by_program = counters["image_da"].program_launches
        if by_program[program] != issued["image_da"]:
            raise AssertionError(f"{config.method}: K6 launches by program "
                                 f"{by_program}, {issued['image_da']} in all; "
                                 f"the path's program is {program}")

    with open(os.path.join(config.save_path, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    tags = {r["tag"] for r in records}
    want_tags = {"Loss/train", "Loss/validation"} | (
        set() if config.task == "pascal_1d" else {"Loss/test"})
    if not want_tags <= tags or "Loss/test" in tags - want_tags:
        raise AssertionError(f"metrics: {sorted(tags)}, want "
                             f"{sorted(want_tags)}")
    if not all(math.isfinite(r["value"]) for r in records):
        raise AssertionError(f"non-finite loss in {records}")
    steps, secs = trainer.timing["steps"], trainer.timing["seconds"]
    if trainer.step != config.iterations or steps <= 0:
        raise AssertionError(f"trainer ran {trainer.step} steps "
                             f"({steps} timed)")
    if fused.replays < 1:
        raise AssertionError(f"{config.method}: no graph replay in "
                             f"{fused.calls} calls")
    ms_step = 1e3 * secs / steps
    tag = config.method + (" bf16" if bf16 else "") + (
        "" if config.aug_random_order else " fixed order") + (
        f" T={config.tasks_per_batch}" if config.tasks_per_batch != 10
        else "")
    if "image_da" in counters:
        log(f"train {tag}: K6 program {program}, {by_program[program]} "
            f"host-issued launches")
    log(f"train {tag}: {trainer.step} steps in {wall:.3f} s wall, "
        f"{fused.k} a call: {fused.warm_calls} eager warm-up call(s), the "
        f"capture, {fused.replays} replay(s); {ms_step} ms/step, "
        f"{config.tasks_per_batch * 1e3 / ms_step} tasks/s over {steps} "
        f"timed steps (the capture included) on {card}; peak device memory "
        f"{peak_gib} GiB")
    log(f"train {tag}: graph of {fused.k} steps: {nodes['nodes']} nodes, "
        f"{nodes['kernel_nodes']} kernel nodes ({nodes['kernel_nodes'] / fused.k} "
        f"a step); capture {fused.graph_stats}")
    log(f"train {tag}: " + ", ".join(f"{r['tag']} {r['value']}"
                                     for r in records))
    for name, n in launches.items():
        log(f"train {tag}: {name} launches on the card {n} (host-issued "
            f"{issued[name]}, captured {fused.captured_launches[name]}, "
            f"graph nodes {nodes[name]})")
        if n <= 0:
            raise AssertionError(f"{name} never launched on the {tag} path")
        if nodes[name] != fused.captured_launches[name]:
            raise AssertionError(f"{tag}: the graph holds {nodes[name]} "
                                 f"{GRAPH_NODE[name]} nodes, the capture "
                                 f"issued {fused.captured_launches[name]}")
    check_launches(trainer, launches)
    replay_trace(trainer, tag)
    if seen is not None:
        check_replays_draw_anew(trainer, seen, tag)
    # every K6 launch of the path was one of its program (checked above)
    if "image_da" in launches:
        launches[f"image_da.{program}"] = launches["image_da"]
    return trainer, launches, nodes


def bbb_encoder(model):
    """The BBB encoder of an MR model (SmallCNP's ``encoder_w0``,
    MAMLRegressor's ``encoder_w``, LargeCNP's ``img_encoder``)."""
    for name in ("encoder_w0", "encoder_w", "img_encoder"):
        if hasattr(model, name):
            return getattr(model, name)
    raise AttributeError(f"{type(model).__name__} has no BBB encoder")


def tap_sample(trainer):
    """Keep the last weight sample the BBB encoder's first layer draws;
    once the graph is captured it is the graph's static tensor, which each
    replay writes anew."""
    layer = bbb_encoder(trainer.model).net.layer1.conv
    seen, sample = {}, layer.sample

    def tapped(noise, lead=()):
        out = sample(noise, lead)
        seen["w"] = out[0]
        return out

    layer.sample = tapped
    seen["layer"] = layer
    return seen


def check_replays_draw_anew(trainer, seen, tag):
    """Two more replays of the captured graph: the tapped BBB layer's
    sample after each must differ (the trainer's generator is registered
    with the graph, so each replay draws from where the last one left it);
    both finite."""
    import torch

    fused = trainer.train_step
    samples = []
    for _ in range(2):
        fused(trainer.generator)
        torch.cuda.synchronize()
        samples.append(seen["w"].clone())
    del seen["layer"].sample         # the class's own sample again
    differ = (samples[0] != samples[1]).float().mean().item()
    log(f"train {tag}: two replays' samples of the BBB encoder's first "
        f"layer {tuple(samples[0].shape)}: {differ} of the entries differ")
    if differ < 0.99 or not all(bool(torch.isfinite(s).all())
                                for s in samples):
        raise AssertionError(f"{tag}: two replays drew the same BBB weights "
                             f"({differ} of the entries differ)")


def check_da_batch(trainer):
    """Image DA on one full-width training batch (context and query, 150
    images each, the sampler's uint8 slices) in each of the six op orders:
    through K6 and through the twin on the CPU at the same draw. Then one
    training step's DA (the draws and both calls): once under
    ``set_sync_debug_mode("error")``, which raises if the host reads a
    draw, then its card time, device time, kernels and host time."""
    import torch

    from wmfml_tpu_torch.aug import image_aug, pipeline
    from wmfml_tpu_torch.kernels import image_da as kda

    cfg = trainer.config
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = trainer.sampler.sample(cfg.tasks_per_batch, gen)
    aug = image_aug.ShapeNet1DAugmenter()
    worst = 0.0
    for key in ("ctx_x", "qry_x"):
        x = batch[key]
        u, keys, _ = aug.sample(x.shape[0] * x.shape[1], gen, "cuda")
        xc, uc, kc = x.cpu(), u.cpu(), keys.cpu()
        for order in range(len(image_aug.ORDERS)):
            got = kda.image_da_launch(x, u, keys, torch.tensor(
                [order], device="cuda")).cpu()
            want = kda.image_da_plain(xc, uc, kc, torch.tensor([order]))
            err, _ = check_close("warp_chain", got, want)
            worst = max(worst, err)
            if torch.equal(got, image_aug.to_unit(xc)):
                raise AssertionError(f"DA left the {key} batch unchanged")
    step = pipeline.build_episode_processor(cfg.task, cfg.aug_list,
                                            train=True)

    def da_step():
        return (step.augment(batch["ctx_x"], gen),
                step.augment(batch["qry_x"], gen))

    da_step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        da_step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    times = dict(ms=cuda_ms(da_step), **device_profile(da_step))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        da_step()
    times["host_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    log(f"da: one full-width batch, six orders, K6 vs the twin on the CPU: "
        f"max abs err {worst} (atol, rtol {TOL['warp_chain']}); one training "
        f"step's DA (draws and two K6 calls) ran with no host sync; "
        f"{times['ms']} ms, {times['device_ms']} ms of device time, "
        f"{times['kernels_per_call']} kernels, {times['host_ms']} ms of host "
        f"time to issue")
    if times["kernels_per_call"] > 8:
        raise AssertionError(f"DA issued {times['kernels_per_call']} kernels "
                             f"a step")
    return times


def check_evaluation(anp_trainer):
    """``evaluation_cli`` over the ANP path's final checkpoint; both loss
    files 25 x 3 and finite; one context point's validation loss on the
    card against the same evaluation on the CPU (plain twins), which
    restores the checkpoint itself."""
    import copy

    import numpy as np

    from wmfml_tpu_torch.cli import evaluation_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data.factory import build_data
    from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
    from wmfml_tpu_torch.models.registry import build_model

    ckpt = anp_trainer.ckpt.path(f"model_end_{anp_trainer.config.iterations}")
    config = Config(EVAL_YAML, EVAL_OVERRIDES + [f"checkpoint={ckpt}"])
    t0 = time.perf_counter()
    val, test = evaluation_cli.evaluate(config)
    wall = time.perf_counter() - t0
    n = config.max_ctx_num
    for name in ("val_losses.txt", "test_losses.txt"):
        arr = np.loadtxt(os.path.join(config.save_path, name))
        if arr.shape != (n, 3) or not np.isfinite(arr).all() or list(
                arr[:, 0]) != list(range(1, n + 1)):
            raise AssertionError(f"{name}: {arr.shape}, {arr}")
    log(f"eval: {config.method} over {ckpt}, ctx 1..{n}, {config.val_iters} "
        f"episodes a point, validation and test, in {wall} s; validation "
        f"loss {val}; test loss {test}")
    point = n
    cpu_cfg = copy.copy(config)
    cpu_cfg.device = "cpu"
    cpu_eval = ModelEvaluator(build_model(cpu_cfg), cpu_cfg,
                              build_data(cpu_cfg))
    want, _ = cpu_eval._validate_iter("validation", point)
    got = val[point - 1]
    err = abs(got - want)
    log(f"eval: validation loss at ctx {point}: card {got}, CPU {want}; abs "
        f"err {err} (tolerance {VAL_TOL} x |CPU| + {VAL_TOL})")
    if err > VAL_TOL * (abs(want) + 1.0):
        raise AssertionError(f"evaluation: card {got}, CPU {want}")


def check_trained_output(trainer):
    """The trained ANP model on a validation episode: kernels vs plain twins."""
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


def check_validation_loss(trainer):
    """The trained model's validation loss on one episode (MAML: after 20
    inner steps; ShapeNet1D in degrees, Pascal1D's MSE of labels x 10): the
    card (kernels) against the CPU (plain twins)."""
    import copy

    from wmfml_tpu_torch.train.maml import build_maml_eval_step
    from wmfml_tpu_torch.train.steps import build_eval_step
    from wmfml_tpu_torch.train.trainer import episode_to_device

    cfg, data = trainer.config, trainer.data
    data.reset_eval("validation", seed=42)
    raw = data.get_batch("validation", cfg.tasks_per_batch, cfg.max_ctx_num)
    got = float(trainer.eval_step(episode_to_device(raw, "cuda")))
    build = build_maml_eval_step if "MAML" in cfg.method else build_eval_step
    cpu_step = build(copy.deepcopy(trainer.model).cpu(), cfg)
    want = float(cpu_step(episode_to_device(raw, "cpu")))
    err = abs(got - want)
    log(f"output: {cfg.method} ({cfg.task}) validation loss on one episode: "
        f"card {got}, CPU {want}; abs err {err} (tolerance {VAL_TOL} x |CPU| "
        f"+ {VAL_TOL})")
    if not math.isfinite(got) or err > VAL_TOL * (abs(want) + 1.0):
        raise AssertionError(f"{cfg.method} validation loss: card {got}, CPU "
                             f"{want}")


def check_pascal_evaluation(trainer):
    """``evaluation_cli`` over P1's final checkpoint with P1's YAML
    (``mode=eval``): 15 context points, ``val_iters`` episodes each,
    validation only; ``val_losses.txt`` must hold 15 finite rows of 3
    columns and no ``test_losses.txt`` may be written (Pascal1D has no test
    split); the last point's loss against the same evaluation on the
    CPU."""
    import copy

    import numpy as np

    from wmfml_tpu_torch.cli import evaluation_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data.factory import build_data
    from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
    from wmfml_tpu_torch.models.registry import build_model

    ckpt = trainer.ckpt.path(f"model_end_{trainer.config.iterations}")
    config = Config(PASCAL_YAML, PASCAL_EVAL_OVERRIDES + [f"checkpoint={ckpt}"])
    t0 = time.perf_counter()
    val, test = evaluation_cli.evaluate(config)
    wall = time.perf_counter() - t0
    n = config.max_ctx_num
    arr = np.loadtxt(os.path.join(config.save_path, "val_losses.txt"))
    if (arr.shape != (n, 3) or not np.isfinite(arr).all()
            or list(arr[:, 0]) != list(range(1, n + 1)) or test
            or os.path.exists(os.path.join(config.save_path,
                                           "test_losses.txt"))):
        raise AssertionError(f"Pascal1D evaluation: val_losses {arr.shape}, "
                             f"test {test}, files "
                             f"{sorted(os.listdir(config.save_path))}")
    cpu_cfg = copy.copy(config)
    cpu_cfg.device = "cpu"
    cpu_eval = ModelEvaluator(build_model(cpu_cfg), cpu_cfg,
                              build_data(cpu_cfg))
    want, _ = cpu_eval._validate_iter("validation", n)
    err = abs(val[n - 1] - want)
    log(f"eval: {config.method} over {ckpt}, ctx 1..{n}, {config.val_iters} "
        f"episodes a point, validation only (no test file), in {wall} s; "
        f"validation loss {val}; at ctx {n}: card {val[n - 1]}, CPU {want}, "
        f"abs err {err} (tolerance {VAL_TOL} x |CPU| + {VAL_TOL})")
    if err > VAL_TOL * (abs(want) + 1.0):
        raise AssertionError(f"Pascal1D evaluation: card {val[n - 1]}, CPU "
                             f"{want}")


def check_bf16_validation(trainer, tasks=None):
    """The bfloat16 model's validation loss on one episode (its first
    ``tasks`` tasks): the card (kernels, bfloat16) against the CPU (plain
    twins) in bfloat16, within the bfloat16 rule against the CPU's float32
    loss of the same weights: |card - CPU bf16| <= 2 |CPU bf16 - CPU f32|
    + 2^-7 |CPU f32|."""
    import copy

    from wmfml_tpu_torch.configs import torch_dtype
    from wmfml_tpu_torch.ops.cast import set_compute_dtype
    from wmfml_tpu_torch.train.maml import build_maml_eval_step
    from wmfml_tpu_torch.train.steps import build_eval_step
    from wmfml_tpu_torch.train.trainer import episode_to_device

    cfg, data = trainer.config, trainer.data
    data.reset_eval("validation", seed=42)
    raw = data.get_batch("validation", cfg.tasks_per_batch, cfg.max_ctx_num)
    raw = {k: v[:tasks] for k, v in raw.items()}
    got = float(trainer.eval_step(episode_to_device(raw, "cuda")))
    build = build_maml_eval_step if "MAML" in cfg.method else build_eval_step
    cpu = {}
    for dtype in ("bfloat16", "float32"):
        c = copy.copy(cfg)
        c.compute_dtype, c.device = dtype, "cpu"
        model = set_compute_dtype(copy.deepcopy(trainer.model).cpu(),
                                  torch_dtype(c))
        cpu[dtype] = float(build(model, c)(episode_to_device(raw, "cpu")))
    limit = (2 * abs(cpu["bfloat16"] - cpu["float32"])
             + 2.0 ** -7 * abs(cpu["float32"]))
    err = abs(got - cpu["bfloat16"])
    log(f"output: {cfg.method} bf16 validation loss on one episode "
        f"({len(raw['ctx_x'])} tasks): card {got}, CPU bf16 "
        f"{cpu['bfloat16']}, CPU f32 {cpu['float32']}; abs err {err} "
        f"(limit {limit})")
    if not math.isfinite(got) or err > limit:
        raise AssertionError(f"{cfg.method} bf16 validation loss: card {got}, "
                             f"CPU {cpu}")


def call_ms(trainer, calls, loop=False):
    """ms/step of ``calls`` calls of the trainer's fused step, graph replays
    or (``loop``) the same steps issued from the host: host clock over the
    calls, ending in a device sync, after one untimed call."""
    import torch

    fused = trainer.train_step
    fn = fused.loop if loop else fused
    fn(trainer.generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(trainer.generator)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (calls * fused.k)


def dtype_turns(pairs, calls, profile=False):
    """ms/step and tasks/s of each (float32, bfloat16) trainer pair's graph
    replays, timed in turns f32, bf16, bf16, f32 on the same card; with
    ``profile``, the card's busy share of one call of each."""
    out = {}
    for name, (f32, bf16) in pairs.items():
        runs = [call_ms(tr, calls) for tr in (f32, bf16, bf16, f32)]
        row = out[name] = dict(f32_ms=(runs[0] + runs[3]) / 2,
                               bf16_ms=(runs[1] + runs[2]) / 2, turns_ms=runs)
        t_ = f32.config.tasks_per_batch
        busy = ""
        if profile:
            row.update({f"{k}_profile": profile_calls(tr, f"{name} {k}")
                        for k, tr in (("f32", f32), ("bf16", bf16))})
            busy = (f"; busy share f32 {row['f32_profile']['busy_share']}, "
                    f"bf16 {row['bf16_profile']['busy_share']}")
        log(f"turns: {name}: float32 {row['f32_ms']} ms/step "
            f"({t_ * 1e3 / row['f32_ms']} tasks/s), bfloat16 "
            f"{row['bf16_ms']} ms/step ({t_ * 1e3 / row['bf16_ms']} tasks/s), "
            f"bf16 / f32 {row['bf16_ms'] / row['f32_ms']} (f32, bf16, bf16, "
            f"f32: {runs}; {calls} calls of {f32.train_step.k} and "
            f"{bf16.train_step.k} steps each){busy}")
    return out


def graph_equals_loop(yaml, overrides, calls=3):
    """Two trainers from one seed under deterministic algorithms: one takes
    ``calls`` fused calls (an eager warm-up, the capture and its replay,
    replays), the other the same steps issued from the host (``loop``).
    Every call's metrics, the weights, Adam's state and the generator's
    state must be equal bit for bit."""
    import torch

    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config

    torch.use_deterministic_algorithms(True)
    try:
        graph, loop = (train_cli.build_trainer(Config(yaml, overrides))
                       for _ in range(2))
        for i in range(calls):
            got = {k: v.clone() if torch.is_tensor(v) else v
                   for k, v in graph.train_step(graph.generator).items()}
            want = loop.train_step.loop(loop.generator)
            torch.cuda.synchronize()
            bad = [k for k in want if not torch.equal(
                torch.as_tensor(got[k]), torch.as_tensor(want[k]))]
            if bad or got.keys() != want.keys():
                raise AssertionError(f"call {i}: graph metrics {got}, loop "
                                     f"{want}")
    finally:
        torch.use_deterministic_algorithms(False)
    fused, cfg = graph.train_step, graph.config
    tensors = []
    for tr in (graph, loop):
        state = tr.optimizer.state_dict()["state"]
        tensors.append([p.detach() for p in tr.model.parameters()]
                       + [v for s in state.values() for v in s.values()]
                       + [tr.generator.get_state()])
    differ = sum(not torch.equal(a, b) for a, b in zip(*tensors))
    tag = cfg.method + (" bf16" if cfg.compute_dtype == "bfloat16" else "") + (
        "" if cfg.aug_random_order else " fixed order") + (
        f" T={cfg.tasks_per_batch}" if cfg.tasks_per_batch != 10 else "")
    log(f"graph vs loop {tag}: {calls} calls of {fused.k} steps ({fused.replays} "
        f"replays): metrics, {len(tensors[0]) - 1} weight and Adam tensors and "
        f"the generator state, {differ} of them differ")
    if differ or fused.replays < 1 or len(tensors[0]) != len(tensors[1]):
        raise AssertionError(f"{tag}: the graph path left {differ} tensors "
                             f"unlike the loop's")


def graph_loop_turns(trainers, calls, nodes, profile):
    """ms/step of graph replays against the same steps issued from the host
    (``loop``), timed in turns graph, loop, loop, graph on each trained
    trainer (``calls`` calls each), beside the graph's size, its capture's
    and instantiation's host seconds and its pool's bytes; with
    ``profile``, the card's busy share of one call of each."""
    out = {}
    for tag, trainer in trainers.items():
        fused = trainer.train_step
        runs = [call_ms(trainer, calls[tag], loop=lp)
                for lp in (False, True, True, False)]
        row = dict(graph_ms=(runs[0] + runs[3]) / 2,
                   loop_ms=(runs[1] + runs[2]) / 2, turns_ms=runs,
                   steps_per_call=fused.k, **fused.graph_stats,
                   **nodes[tag])
        if profile:
            row["graph_profile"] = profile_calls(trainer, f"{tag} graph")
            row["loop_profile"] = profile_calls(trainer, f"{tag} loop",
                                                loop=True)
        t_ = trainer.config.tasks_per_batch
        log(f"graph vs loop {tag}: graph {row['graph_ms']} ms/step "
            f"({t_ * 1e3 / row['graph_ms']} tasks/s), loop {row['loop_ms']} "
            f"ms/step ({t_ * 1e3 / row['loop_ms']} tasks/s), "
            f"{row['loop_ms'] / row['graph_ms']}x (graph, loop, loop, graph: "
            f"{runs}; {calls[tag]} calls of {fused.k} steps each); "
            f"{json.dumps({k: v for k, v in row.items() if k not in ('turns_ms', 'graph_ms', 'loop_ms')})}")
        out[tag] = row
    return out


def determinism_turns(paths, calls):
    """ROADMAP.md C2: what ``torch.backends.cudnn.deterministic`` costs a
    graph replay. For each path (yaml, overrides), two fresh trainers: one
    runs its eager warm-up calls and captures its graph with the flag off,
    the other with it on (the algorithms are chosen then, and the graph
    keeps them); their replays are timed in turns off, on, on, off. The
    port's setting is restored at the end."""
    import torch

    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.cli.common import set_numerics
    from wmfml_tpu_torch.configs import Config

    out = {}
    try:
        for tag, (yaml, overrides) in paths.items():
            trainers = {}
            for det in (False, True):
                tr = train_cli.build_trainer(Config(yaml, overrides))
                torch.backends.cudnn.deterministic = det
                for _ in range(tr.train_step.warm_calls + 1):
                    tr.train_step(tr.generator)
                torch.cuda.synchronize()
                trainers[det] = tr
            runs = [call_ms(trainers[det], calls[tag])
                    for det in (False, True, True, False)]
            off, on = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
            out[tag] = dict(graph_ms=off, deterministic_ms=on,
                            cost=on / off - 1.0, turns_ms=runs)
            log(f"determinism {tag}: graph {off} ms/step with cuDNN's "
                f"default algorithms, {on} ms/step with "
                f"torch.backends.cudnn.deterministic (off, on, on, off: "
                f"{runs}; {calls[tag]} calls of "
                f"{trainers[False].train_step.k} steps each): "
                f"{100 * (on / off - 1.0)}% a step")
            del trainers, tr
            torch.cuda.empty_cache()
    finally:
        set_numerics()
    return out


def replay_maml():
    """Phase 7's training replayed (untimed, from the same seed) under
    deterministic algorithms, which the caller has switched on.

    float32's error in phase 8's gradient swings with the last bits of any
    sum before it: cuDNN's default backward sums in no fixed order, and two
    runs on one state and batch can differ several times over in their
    distance from float64. The replay and the gradients taken on it under
    deterministic algorithms fix the state and every sum, so phase 8's
    verdict is the same on every run."""
    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config

    return train_cli.train(Config(MAML_YAML, MAML_OVERRIDES))


def check_second_order_grad(trainer):
    """One full-width MAML training batch: the second-order outer gradient
    through K1 and K3 against plain autograd through the twins, which never
    enters a custom autograd Function (a backward that dropped its
    second-order terms would show here), in float32 and in float64. The
    first-order gradient says how large the second-order terms are.
    ``trainer`` is ``replay_maml``'s. The batch is the replayed training's
    first one: drawn and augmented from a generator seeded with the
    config's seed, as the trainer draws its first step, so that no other
    phase's draws move it."""
    import torch

    first_batch = torch.Generator(device="cuda").manual_seed(
        int(trainer.config.seed))
    err, err_plain, _, second_share = second_order_errors(trainer,
                                                          first_batch)
    if not err <= max(GRAD_TOL, GRAD_FACTOR * err_plain):
        raise AssertionError(f"second-order gradient through the kernels is "
                             f"{err} from float64, the twins' {err_plain}")
    if not second_share > 10 * err:
        raise AssertionError(f"second-order part {second_share} is not "
                             f"above the error {err}: the check is blind")


def grad_spread(trainer, gens, jitters=3):
    """``--grad-spread``: how far phase 8's kernels-to-twins ratio moves
    with float32 rounding alone. On ``replay_maml``'s state, under
    deterministic algorithms, for each batch (``gens``: name -> a
    generator to draw and augment it from), phase 8's comparison as it
    stands, then ``jitters`` times on the same images with a random half of
    their nonzero pixels moved one float32 ulp up or down (the float64
    reference takes the same images): a relative change below 1.2e-7 that
    moves no true gradient, only every rounding after it. A kernel at fault
    stays far from the twins on every copy; rounding noise crosses over.
    On the jittered copies a third witness, ``shuffled_twin``: the twins
    with K1's and K3's forward differences from them added in a random
    order, which says whether the size of the kernels' rounding alone
    explains their distance from float64."""
    rows = []
    for name, gen in gens.items():
        state = gen.get_state()
        runs = []
        for jitter in (None, *range(jitters)):
            gen.set_state(state)
            err, err_plain, err_mixed, _ = second_order_errors(trainer, gen,
                                                               jitter)
            runs.append((err, err_plain, err_mixed))
        (err, err_plain, _), jittered = runs[0], runs[1:]
        row = dict(batch=name, kernels=err, twins=err_plain,
                   ratio=err / err_plain,
                   jittered_kernels=[r[0] for r in jittered],
                   jittered_twins=[r[1] for r in jittered],
                   jittered_ratios=[r[0] / r[1] for r in jittered],
                   jittered_shuffled=[r[2] for r in jittered],
                   jittered_shuffled_ratios=[r[2] / r[1] for r in jittered])
        rows.append(row)
        log(f"grad spread: {json.dumps(row)}")
    for key, what in (("ratio", "kernels / twins, as phase 8 reads them"),
                      ("jittered_ratios", "kernels / twins, jittered"),
                      ("jittered_shuffled_ratios",
                       "shuffled twins / twins, jittered")):
        v = sorted(x for r in rows
                   for x in (r[key] if isinstance(r[key], list)
                             else [r[key]]))
        log(f"grad spread: {what}: {len(v)} values {min(v)} .. {max(v)}, "
            f"median {v[len(v) // 2]}, {sum(x > GRAD_FACTOR for x in v)} "
            f"above GRAD_FACTOR {GRAD_FACTOR}")


def second_order_errors(trainer, gen, jitter=None):
    """Phase 8's comparison on ``trainer``'s model and one batch: the
    kernels' and the twins' distance from float64, the kernels' from the
    twins, and the second-order part of the gradient. ``jitter``, a seed,
    moves a random half of the augmented images' nonzero pixels one ulp
    (``grad_spread``). A BBB encoder (MAMLMR) draws its samples once, from
    ``gen``, and every gradient below replays those draws (``EpsFeed``)."""
    import copy

    import torch

    from wmfml_tpu_torch.aug import pipeline
    from wmfml_tpu_torch.kernels import features, stem
    from wmfml_tpu_torch.models import maml as maml_model
    from wmfml_tpu_torch.nn import encoders
    from wmfml_tpu_torch.nn.bbb import EpsFeed
    from wmfml_tpu_torch.train.maml import build_maml_outer

    cfg = trainer.config
    batch = trainer.sampler.sample(cfg.tasks_per_batch, gen)
    # DA has no gradient: the batch is augmented once, through K6, and
    # every gradient below is taken on those images with no DA inside
    augment = pipeline.build_episode_processor(
        cfg.task, cfg.aug_list, train=True).augment
    if augment is not None:
        batch = dict(batch, **{k: augment(batch[k], gen)
                               for k in ("ctx_x", "qry_x")})
    if jitter is not None:
        jg = torch.Generator(device="cuda").manual_seed(jitter)
        for k in ("ctx_x", "qry_x"):
            x = pipeline._to_float(batch[k])
            up = torch.rand(x.shape, generator=jg, device=x.device) < 0.5
            move = (torch.rand(x.shape, generator=jg, device=x.device) < 0.5
                    ) & (x != 0)
            batch[k] = torch.where(move, torch.nextafter(
                x, torch.where(up, 2.0, -1.0)), x)
    cfg = copy.copy(cfg)
    cfg.aug_list = [a for a in cfg.aug_list if a != "data_aug"]
    draws = None
    if trainer.model.bbb:
        rec = EpsFeed(generator=gen)
        build_maml_outer(trainer.model, cfg, int(cfg.num_steps),
                         train=False, test=False)(batch, noise=rec)
        draws = rec.draws

    def grads(model, first_order=False, plain=False, shuffled=False):
        saved = (cfg.first_order, encoders.literature_stem,
                 maml_model.maml_features, pipeline._to_float)
        cfg.first_order = first_order
        if plain:
            encoders.literature_stem = stem.stem_plain
            maml_model.maml_features = features.features_plain
        if shuffled:
            encoders.literature_stem = shuffled_twin(stem.stem_plain,
                                                     saved[1])
            maml_model.maml_features = shuffled_twin(features.features_plain,
                                                     saved[2])
        dtype = next(model.parameters()).dtype
        pipeline._to_float = lambda x, _=None: saved[3](x).to(dtype)
        try:
            outer = build_maml_outer(model, cfg, int(cfg.num_steps),
                                     train=True, test=False)
            names, params = zip(*model.named_parameters())
            noise = None if draws is None else EpsFeed(draws)
            # task augmentation (MR's DA + TA YAML) draws the same offsets
            # in every call
            ta = torch.Generator(device="cuda").manual_seed(0)
            g = torch.autograd.grad(outer(batch, ta, noise=noise)[0], params)
        finally:
            (cfg.first_order, encoders.literature_stem,
             maml_model.maml_features, pipeline._to_float) = saved
        return {n: v.double() for n, v in zip(names, g)}

    kernel = grads(trainer.model)
    plain = grads(trainer.model, plain=True)
    exact = grads(copy.deepcopy(trainer.model).double(), plain=True)
    first = grads(trainer.model, first_order=True)
    mixed = grads(trainer.model, shuffled=True) if jitter is not None \
        else None
    torch.cuda.synchronize()

    # the features blocks' conv biases feed a batch norm, which removes any
    # per-channel shift: their true gradient is 0 and float32 computes noise
    # around it, so they are held against the model's largest gradient entry
    scale = max(g.abs().max().item() for g in exact.values())

    def rel(a, b, n):
        shift_free = n.startswith("features.") and n.endswith(".conv.bias")
        den = scale if shift_free else b[n].abs().max().item()
        return (a[n] - b[n]).abs().max().item() / den

    def worst(a, b):
        errs = sorted(((rel(a, b, n), n) for n in exact), reverse=True)
        return errs[0][0], errs[:3]

    err, top = worst(kernel, exact)
    err_plain, top_plain = worst(plain, exact)
    err_pair, _ = worst(kernel, plain)
    second_share, _ = worst(exact, first)
    err_mixed = None if mixed is None else worst(mixed, exact)
    log(f"grad: second-order outer gradient over {len(exact)} parameters, "
        f"max rel err against float64 plain autograd: kernels {err} "
        f"({top}), plain float32 twins {err_plain} ({top_plain}); kernels "
        f"against plain float32 {err_pair}; second-order part of the "
        f"gradient {second_share}"
        + ("" if mixed is None else f"; twins with the kernels' forward "
           f"differences shuffled {err_mixed[0]} ({err_mixed[1]})"))
    if jitter is None:
        return err, err_plain, err_pair, second_share
    return err, err_plain, err_mixed[0], second_share


def shuffled_twin(plain_fn, kernel_fn):
    """``plain_fn`` whose forward value is moved by the kernel's own
    differences from it on the same inputs, in a random order (the
    backward stays ``plain_fn``'s, as the kernels' does): a perturbation of
    the kernel's size that carries none of its structure."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)

    def fn(*args, **kwargs):
        out = plain_fn(*args, **kwargs)
        with torch.no_grad():
            d = torch.nan_to_num(kernel_fn(*args, **kwargs) - out).flatten()
            d = d[torch.randperm(d.numel(), generator=gen, device=d.device)]
        return out + d.view_as(out)
    return fn


def profile_calls(trainer, tag, loop=False, calls=1):
    """torch.profiler over ``calls`` calls of the trainer's fused step (graph
    replays, or with ``loop`` the same steps issued from the host): the
    card's busy share of the wall time, kernels a step, the top kernels and
    DA's share; writes a Chrome trace to results/."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fused = trainer.train_step
    fn = fused.loop if loop else fused
    steps = calls * fused.k
    fn(trainer.generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(trainer.generator)
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
    log(f"profile {tag}: {steps} steps, {wall_us / steps} us/step wall, "
        f"device busy {busy_us / steps} us/step = {busy_us / wall_us} of the "
        f"wall time ({len(kernels) / steps} kernels/step)")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    # K6 launches twice a step; its events' mean, as device_profile takes
    # it, since the profiler may drop some of them
    k6 = [e.time_range.elapsed_us() for e in kernels
          if "image_da_kernel" in e.name]
    da_us = 2 * steps * sum(k6) / max(len(k6), 1)
    log(f"profile {tag}: K6 (DA) {da_us / steps} us/step of device time "
        f"= {da_us / max(busy_us, 1e-9)} of the busy time ({len(k6)} of "
        f"{2 * steps} K6 events recorded)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"profile {tag}: {us / steps:10.3f} us/step  {name[:110]}")
    os.makedirs(os.path.join(HERE, "results"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        HERE, "results", f"train_step_trace_{tag.replace(' ', '_')}.json"))
    return dict(wall_ms_step=wall_us / steps / 1e3,
                busy_ms_step=busy_us / steps / 1e3,
                busy_share=busy_us / wall_us,
                kernels_per_step=len(kernels) / steps)


def check_stem_bbb(model, gen, per_task=False):
    """K1 on Bayes-by-Backprop samples (mu + eps softplus(rho), drawn on the
    card) at the MR paths' shapes: ANPMRShapeNet1D's one sample for a pass
    of 150 images (query and context go through the encoder apart), or
    MAMLMRShapeNet1D's one sample per task, 10 x 15 images; against
    ``stem_plain`` on the same samples (task by task for the per-task
    form). The row reports the MR path's launches."""
    import torch
    import torch.nn.functional as F

    from wmfml_tpu_torch.kernels import stem
    from wmfml_tpu_torch.nn.bbb import EpsFeed

    enc = bbb_encoder(model)
    t_, n, h, w = 10, 15, 128, 128
    lead = (t_,) if per_task else ()
    with torch.no_grad():
        (w0, b0, _), (w1, b1, _) = (
            layer.sample(EpsFeed(generator=gen), lead)
            for layer in (enc.net.layer1.conv, enc.net.layer2.conv))
    x = torch.rand((t_ * n, h, w, 1), generator=gen, device="cuda")
    args = (x, w0, b0, w1, b1)

    def plain(*a):
        if not per_task:
            return stem.stem_plain(*a)
        return torch.cat([stem.stem_plain(a[0][i * n:(i + 1) * n],
                                          *(p[i] for p in a[1:]))
                          for i in range(t_)])

    got = stem.stem_launch(*args)
    want = plain(*args)
    err, rel = check_kernel("literature_stem", got, want, None)
    if per_task:
        xg = x.reshape(t_, n, h, w).transpose(0, 1).contiguous()
        groups, wl = t_, [a.flatten(0, 1) if a.dim() == 5 else a.flatten()
                          for a in (w0, b0, w1, b1)]
    else:
        xg, groups, wl = x.reshape(t_ * n, 1, h, w), 1, [w0, b0, w1, b1]

    def library():      # cuDNN, NCHW; never called by the port
        a = F.relu(F.conv2d(xg, wl[0], wl[1], stride=2, padding=1,
                            groups=groups))
        a = F.relu(F.conv2d(a, wl[2], wl[3], stride=2, padding=1,
                            groups=groups))
        return F.max_pool2d(a, 2)

    times = in_turns({"ms": lambda: stem.stem_launch(*args),
                      "plain_ms": lambda: stem.stem_plain(*args),
                      "library_ms": library})
    times.update(device_profile(lambda: stem.stem_launch(*args)))
    nbytes = x.element_size() * (x.numel() + got.numel() + sum(
        a.numel() for a in (w0, b0, w1, b1)))
    row = _rows("literature_stem", None, "MR MAML" if per_task else "MR ANP")
    row.update(name=("literature_stem_per_task_bbb" if per_task
                     else "literature_stem_bbb"), tol="literature_stem")
    return dict(**row,
                shape=(f"BBB samples per task, [10 x 15, 128, 128, 1]"
                       if per_task else
                       "a BBB sample, [150, 128, 128, 1] (one pass)"),
                source="wmfml_tpu_torch/csrc/stem.cu",
                replaces="wmfml_tpu/nn/encoders.py:230",
                max_abs_err=err, max_rel_err=rel, **times,
                **stem_bound(t_ * n, h, w, nbytes))


def check_mr_validation(trainer):
    """An MR model's validation loss on one episode (MAMLMR: after 20
    inner steps), the card against the CPU on the same BBB draws: drawn on
    the card once (``EpsFeed`` recording), moved, and replayed on the CPU
    (plain twins)."""
    import copy

    import torch

    from wmfml_tpu_torch.nn.bbb import EpsFeed
    from wmfml_tpu_torch.train.maml import build_maml_eval_step
    from wmfml_tpu_torch.train.steps import build_eval_step
    from wmfml_tpu_torch.train.trainer import episode_to_device

    cfg, data = trainer.config, trainer.data
    data.reset_eval("validation", seed=42)
    raw = data.get_batch("validation", cfg.tasks_per_batch, cfg.max_ctx_num)
    rec = EpsFeed(generator=torch.Generator(device="cuda").manual_seed(
        int(cfg.seed)))
    got = float(trainer.eval_step(episode_to_device(raw, "cuda"), rec))
    build = build_maml_eval_step if "MAML" in cfg.method else build_eval_step
    cpu_step = build(copy.deepcopy(trainer.model).cpu(), cfg)
    want = float(cpu_step(episode_to_device(raw, "cpu"),
                          EpsFeed([d.cpu() for d in rec.draws])))
    err = abs(got - want)
    log(f"output: {cfg.method} ({cfg.task}) validation loss on one episode, "
        f"{len(rec.draws)} BBB draws replayed on the CPU: card {got}, CPU "
        f"{want}; abs err {err} (tolerance {VAL_TOL} x |CPU| + {VAL_TOL})")
    if not math.isfinite(got) or err > VAL_TOL * (abs(want) + 1.0):
        raise AssertionError(f"{cfg.method} validation loss: card {got}, CPU "
                             f"{want}")


def check_mr_evaluation(trainer):
    """E1's MR sweep: ``evaluation_cli`` with ``cfg/evaluation/ANP_ShapeNet1D
    .yaml`` as ANPMRShapeNet1D over M1's final checkpoint, 25 points x 2
    episodes x 2 splits. The BBB encoder samples at evaluation, as in the
    reference, from a generator reseeded from the config's seed at each
    point: a second sweep must write the same numbers. K1 launches twice
    an episode (query, context) and K2 once. The last point's validation
    loss, card against CPU on the card's draws replayed."""
    import copy

    import numpy as np
    import torch

    from wmfml_tpu_torch.cli import evaluation_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data.factory import build_data
    from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
    from wmfml_tpu_torch.kernels.favor import favor_attention
    from wmfml_tpu_torch.kernels.stem import literature_stem
    from wmfml_tpu_torch.models.registry import build_model
    from wmfml_tpu_torch.nn.bbb import EpsFeed

    ckpt = trainer.ckpt.path(f"model_end_{trainer.config.iterations}")
    overrides = EVAL_OVERRIDES + ["val_iters=2", "method=ANPMRShapeNet1D",
                                  f"checkpoint={ckpt}"]
    literature_stem.launches = favor_attention.launches = 0
    t0 = time.perf_counter()
    sweeps = [evaluation_cli.evaluate(Config(EVAL_YAML, overrides))
              for _ in range(2)]
    wall = (time.perf_counter() - t0) / 2
    config = Config(EVAL_YAML, overrides, make_dirs=False)
    n, episodes = config.max_ctx_num, 2 * config.max_ctx_num * 2 * 2
    launches = {"literature_stem": literature_stem.launches,
                "favor_attention": favor_attention.launches}
    if launches != {"literature_stem": 2 * episodes,
                    "favor_attention": episodes}:
        raise AssertionError(f"E1 MR sweep: launches {launches} over "
                             f"{episodes} episodes")
    if sweeps[0] != sweeps[1] or not np.isfinite(sweeps[0][0]).all():
        raise AssertionError(f"E1 MR sweeps differ: {sweeps}")
    evals = {}
    for dev in ("cuda", "cpu"):
        cfg = copy.copy(config)
        cfg.device = dev
        evals[dev] = ModelEvaluator(build_model(cfg), cfg, build_data(cfg))
    rec = EpsFeed(generator=torch.Generator(device="cuda").manual_seed(0))
    card_step, cpu_step = evals["cuda"].eval_step, evals["cpu"].eval_step
    evals["cuda"].eval_step = lambda b, g: card_step(b, rec)
    got, _ = evals["cuda"]._validate_iter("validation", n)
    replay = EpsFeed([d.cpu() for d in rec.draws])
    evals["cpu"].eval_step = lambda b, g: cpu_step(b, replay)
    want, _ = evals["cpu"]._validate_iter("validation", n)
    err = abs(got - want)
    log(f"eval: E1 ANPMRShapeNet1D over {ckpt}, ctx 1..{n}, 2 episodes a "
        f"point, validation and test, {wall} s a sweep, two sweeps equal; "
        f"launches {launches}; validation loss {sweeps[0][0]}; test loss "
        f"{sweeps[0][1]}; at ctx {n} on the card's draws: card {got}, CPU "
        f"{want}, abs err {err} (tolerance {VAL_TOL} x |CPU| + {VAL_TOL})")
    if err > VAL_TOL * (abs(want) + 1.0):
        raise AssertionError(f"E1 MR evaluation: card {got}, CPU {want}")
    return launches


def check_mr_second_order():
    """Phase 8's check on M2: the second-order outer gradient of one
    full-width MAMLMRShapeNet1D batch (5 inner steps, a BBB sample per task
    and step, the same draws in every precision) through K1 and K3 against
    plain autograd through the twins in float32 and float64, on a fresh
    trainer from the config's seed under deterministic algorithms (a state
    and sums that are the same on every run)."""
    import torch

    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config

    torch.use_deterministic_algorithms(True)
    try:
        trainer = train_cli.build_trainer(Config(MR_MAML_YAML,
                                                 MR_MAML_OVERRIDES))
        check_second_order_grad(trainer)
    finally:
        torch.use_deterministic_algorithms(False)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from wmfml_tpu_torch.cli.common import set_numerics
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.kernels import build
    from wmfml_tpu_torch.kernels.favor import favor_attention
    from wmfml_tpu_torch.kernels.features import maml_features
    from wmfml_tpu_torch.kernels.image_da import PROGRAMS, RGB, image_da
    from wmfml_tpu_torch.kernels.stem import literature_stem
    from wmfml_tpu_torch.models.registry import build_model

    set_numerics()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; the port's settings: cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}, matmul TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN deterministic "
        f"{torch.backends.cudnn.deterministic}")

    t0 = time.perf_counter()
    libs = build.load_all()
    log(f"build: {', '.join(build.SOURCES)} in {time.perf_counter() - t0} s")
    log(f"build: dynamic shared memory per block: stem "
        f"{libs['stem'].wmfml_stem_smem_bytes(1, 2)} B (Ci = 1, two "
        f"warpgroups), features conv "
        f"{libs['features'].wmfml_features_smem_bytes(14)} B (W = 14), "
        f"favor {libs['favor'].wmfml_favor_smem_bytes(15, 15, 64, 266)} B used "
        f"of the 231424 B it requests (Nq = Nk = 15, m = 266); favor "
        f"co-resident blocks {libs['favor'].wmfml_favor_coresident()}, wide "
        f"form {libs['favor'].wmfml_favor_wide_coresident()}, "
        f"image_da (128 x 128) " + ", ".join(
            f"{p} {libs['image_da'].wmfml_image_da_smem_bytes(i, 128, 128)} B"
            for i, p in enumerate(PROGRAMS) if p not in RGB)
        + "; image_da (64 x 64) " + ", ".join(
            f"{p} {libs['image_da'].wmfml_image_da_smem_bytes(i, 64, 64)} B"
            for i, p in enumerate(PROGRAMS) if p in RGB))
    for name, text in build.ptxas_log.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "arning", "erformance")):
                log(f"build: {name}: {line.strip()}")

    anp = build_model(Config(MAIN_YAML, TRAIN_OVERRIDES,
                             make_dirs=False)).cuda()
    maml = build_model(Config(MAML_YAML, MAML_OVERRIDES,
                              make_dirs=False)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_stem(anp, gen), check_favor(anp, gen),
            check_stem_per_task(maml, gen), check_features(maml, gen),
            *check_image_da(gen)]
    stamp("phase 3: K1, K2, K3, K6 in float32")
    # the batch phase 8 drew before it took the config's seed
    after_phase3 = torch.Generator(device="cuda")
    after_phase3.set_state(gen.get_state())
    # the bfloat16 paths, from a generator of their own
    gen_bf16 = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    rows += [check_stem(anp, gen_bf16, bf), check_favor(anp, gen_bf16, bf),
             check_stem_per_task(maml, gen_bf16, bf),
             check_features(maml, gen_bf16, bf),
             *check_image_da(gen_bf16, bf)]
    stamp("phase 3: bfloat16")
    # K6's programs 1-3, from a generator of their own
    rows += check_image_da_programs(torch.Generator(device="cuda")
                                    .manual_seed(2))
    stamp("phase 3: K6 programs 1-3")
    # P3 at T = 40: K1, K2 and K6's ShapeNet1D fixed program in bfloat16 at
    # that path's shapes (1,200 images, T = 40, 600 images a DA call)
    gen_t40 = torch.Generator(device="cuda").manual_seed(4)
    rows += [check_stem(anp, gen_t40, bf, 40, "ANP fixed T40"),
             check_favor(anp, gen_t40, bf, 40, "ANP fixed T40"),
             *check_image_da_programs(gen_t40, ("shapenet_1d_fixed",), 40)]
    stamp("phase 3: T = 40")
    # the Distractor paths' kernels: K2's wide form at D1's shape (Nq 18, Nk
    # 15) and D4's (Nq 36, Nk 25) with ANPDistractor's projection, K6's
    # programs 4 and 5 at D1's two DA calls (300 and 360 images)
    proj = build_model(Config(DISTRACTOR_YAML, DISTRACTOR_OVERRIDES,
                              make_dirs=False)).attn.projection_matrix.cuda()
    gen_d = torch.Generator(device="cuda").manual_seed(5)
    rows += [check_favor_wide(proj, gen_d, 18, 15, "favor_attention_wide",
                              "Distractor ANP"),
             check_favor_wide(proj, gen_d, 36, 25, "favor_attention_wide_eval",
                              "Distractor eval"),
             *check_image_da_distractor(gen_d)]
    stamp("phase 3: Distractor")
    # the ShapeNet3D paths' kernels: K2's wide form at S1's shape (Nq 15, Nk
    # 15) and S4's (Nq 30, Nk 25) with ANP's projection, K6's programs 6 and
    # 7 at S1's two DA calls (300 images each)
    proj = build_model(Config(S3D_YAML, S3D_OVERRIDES, make_dirs=False)
                       ).attn.projection_matrix.cuda()
    gen_s = torch.Generator(device="cuda").manual_seed(7)
    rows += [check_favor_wide(proj, gen_s, 15, 15, "favor_attention_wide_s1",
                              "ShapeNet3D ANP"),
             check_favor_wide(proj, gen_s, 30, 25, "favor_attention_wide_s4",
                              "ShapeNet3D eval"),
             *check_image_da_rgb(gen_s)]
    stamp("phase 3: ShapeNet3D")
    # the bfloat16 LargeCNP paths' kernels (phase 17): K2's wide form in
    # bfloat16 at D5's (Nq 18, Nk 15) and S6's (Nq 15, Nk 15) shapes, K6's
    # programs 4 and 5 in bfloat16 at D1's two DA calls and 6 and 7 at
    # S1's, reading bfloat16 RGBA; then K2 wide at 100 rows an item (Nq 50,
    # Nk 50: two row groups, 32 + 32-row chunks), float32 and bfloat16, a
    # shape no shipped configuration reaches (no launches on any path)
    gen_b = torch.Generator(device="cuda").manual_seed(8)
    rows += [check_favor_wide(proj, gen_b, 15, 15,
                              "favor_attention_wide_s1_bf16",
                              "ShapeNet3D ANP bf16", bf),
             *check_image_da_rgb(gen_b, bf)]
    proj = build_model(Config(DISTRACTOR_YAML, DISTRACTOR_OVERRIDES,
                              make_dirs=False)).attn.projection_matrix.cuda()
    rows += [check_favor_wide(proj, gen_b, 18, 15, "favor_attention_wide_bf16",
                              "Distractor ANP bf16", bf),
             *check_image_da_distractor(gen_b, bf),
             *(check_favor_wide(proj, gen_b, 50, 50,
                                "favor_attention_wide_R100" + suffix, None,
                                dt, off_path="no path runs Nq + Nk > 64 (D4 "
                                "and S4 reach 61 and 55)")
               for dt, suffix in ((None, ""), (bf, "_bf16")))]
    stamp("phase 3: LargeCNP in bfloat16")
    # the MR paths' K1: on BBB samples drawn on the card, M1's pass of 150
    # images with one sample, M2's per-task samples
    gen_mr = torch.Generator(device="cuda").manual_seed(9)
    rows += [check_stem_bbb(build_model(Config(
                 MR_ANP_YAML, TRAIN_OVERRIDES, make_dirs=False)).cuda(),
                 gen_mr),
             check_stem_bbb(build_model(Config(
                 MR_MAML_YAML, MR_MAML_OVERRIDES, make_dirs=False)).cuda(),
                 gen_mr, per_task=True)]
    stamp("phase 3, the kernels against their twins")
    floor = floor_ms()
    log(f"kernel: floor: a one-element torch.add takes {floor} ms of device "
        f"time, the least any launch takes on this card")
    for r in rows:
        r["floor_ms"] = floor
        extra = ""
        if "ms_unmasked" in r:
            extra = (f"; unmasked: max abs err {r['max_abs_err_unmasked']}, "
                     f"{r['ms_unmasked']} ms, plain "
                     f"{r['plain_ms_unmasked']} ms")
        if "library" in r:
            extra = (f"; library = {r['library']}; {r['flops']} float and "
                     f"{r['int_ops']} integer operations")
        rule = ("the bfloat16 rule" if r["dtype"] == "bfloat16"
                and r.get("tol") != "favor_attention_wide" else
                f"atol, rtol {TOL[r.get('tol', r['name'])]}")
        log(f"kernel: {r['name']} ({r['shape']}): max abs err "
            f"{r['max_abs_err']}, max rel err {r['max_rel_err']} ({rule}); "
            f"{r['ms']} ms ({r['device_ms']} ms of it on "
            f"the device, {r['kernels_per_call']} kernels per call), plain "
            f"{r['plain_ms']} ms, "
            f"library {r['library_ms']} ms, bound {r['bound_ms']} ms by "
            f"{r['bound_by']} (float32 CUDA-core bound {r['bound_f32_ms']} "
            f"ms){extra}")
        if "phase_us" in r:
            log(f"kernel: {r['name']} phase clock (us, medians of 10 "
                f"launches; favor_phases, favor_wide_phases, da_phases): "
                f"{r['phase_us']}")

    da_kernels = {"image_da": image_da}
    anp_kernels = {"literature_stem": literature_stem,
                   "favor_attention": favor_attention, **da_kernels}
    maml_kernels = {"literature_stem": literature_stem,
                    "maml_features": maml_features, **da_kernels}
    trainer, anp_launches, anp_nodes = train_phase(
        card, MAIN_YAML, TRAIN_OVERRIDES, anp_kernels)
    check_trained_output(trainer)
    check_da_batch(trainer)
    check_evaluation(trainer)

    stamp("phases 4-6, ANP")
    mtrainer, maml_launches, maml_nodes = train_phase(
        card, MAML_YAML, MAML_OVERRIDES, maml_kernels)
    check_validation_loss(mtrainer)
    torch.use_deterministic_algorithms(True)
    try:
        replayed = replay_maml()
        check_second_order_grad(replayed)
        if "--grad-spread" in argv:
            seed = int(replayed.config.seed)
            gens = {f"phase 8's, seed {seed}": seed,
                    "after phase 3's draws": after_phase3,
                    **{f"seed {seed + i}": seed + i for i in range(1, 7)}}
            grad_spread(replayed, {
                k: v if isinstance(v, torch.Generator)
                else torch.Generator(device="cuda").manual_seed(v)
                for k, v in gens.items()})
    finally:
        torch.use_deterministic_algorithms(False)

    stamp("phases 7-8, MAML")
    # bfloat16: bench.py's headline configuration and the MAML perf YAML
    btrainer, anp_bf16, anp_bf16_nodes = train_phase(
        card, MAIN_YAML, BF16_OVERRIDES, anp_kernels)
    check_bf16_validation(btrainer)
    bmtrainer, maml_bf16, maml_bf16_nodes = train_phase(
        card, PERF_MAML_YAML, PERF_MAML_OVERRIDES, maml_kernels)
    check_bf16_validation(bmtrainer, tasks=3)
    dtype_turns({"ANPShapeNet1D": (trainer, btrainer),
                 "MAMLShapeNet1D": (mtrainer, bmtrainer)}, calls=2)

    stamp("phases 9-11, bf16")
    # phase 13: the Pascal1D and fixed-order paths (K6's programs 1-3)
    ptrainer, pascal_launches, pascal_nodes = train_phase(
        card, PASCAL_YAML, PASCAL_OVERRIDES, anp_kernels)
    check_validation_loss(ptrainer)
    check_pascal_evaluation(ptrainer)
    pftrainer, pascal_fixed, pascal_fixed_nodes = train_phase(
        card, PASCAL_YAML, PASCAL_FIXED_OVERRIDES, anp_kernels)
    check_validation_loss(pftrainer)
    pmtrainer, pascal_maml, pascal_maml_nodes = train_phase(
        card, PASCAL_MAML_YAML, PASCAL_MAML_OVERRIDES, maml_kernels)
    check_validation_loss(pmtrainer)
    ftrainer, anp_fixed, anp_fixed_nodes = train_phase(
        card, PERF_ANP_YAML, PERF_ANP_OVERRIDES, anp_kernels)
    check_bf16_validation(ftrainer)
    f40trainer, anp_fixed40, anp_fixed40_nodes = train_phase(
        card, PERF_ANP_T40_YAML, PERF_ANP_OVERRIDES, anp_kernels)
    check_bf16_validation(f40trainer)

    stamp("phase 13, Pascal1D and fixed order")
    # phase 14: the Distractor paths (LargeCNP on the ResNet trunk, K2's
    # wide form, K6's programs 4 and 5)
    d_anp_kernels = {"favor_attention": favor_attention, **da_kernels}
    d1trainer, d1_launches, d1_nodes = train_phase(
        card, DISTRACTOR_YAML, DISTRACTOR_OVERRIDES, d_anp_kernels)
    check_validation_loss(d1trainer)
    d2trainer, d2_launches, d2_nodes = train_phase(
        card, DISTRACTOR_CNP_YAML, DISTRACTOR_SHORT_OVERRIDES, da_kernels)
    check_validation_loss(d2trainer)
    d3trainer, d3_launches, _ = train_phase(
        card, DISTRACTOR_YAML, DISTRACTOR_FIXED_OVERRIDES, d_anp_kernels)
    check_validation_loss(d3trainer)
    d4_launches = check_large_evaluation(
        "D4", DISTRACTOR_EVAL_YAML, DISTRACTOR_EVAL_OVERRIDES,
        [(d2trainer, []),
         (d1trainer, ["method=ANPDistractor", "agg_mode=attention"])])

    stamp("phase 14, Distractor")
    # phase 16: the ShapeNet3D paths (LargeCNP on RGB, backgrounds
    # composited per batch on the card, K2's wide form, K6's programs 6 and
    # 7)
    s1trainer, s1_launches, s1_nodes = train_phase(
        card, S3D_YAML, S3D_OVERRIDES, d_anp_kernels)
    check_validation_loss(s1trainer)
    s2trainer, s2_launches, s2_nodes = train_phase(
        card, S3D_CNP_YAML, S3D_SHORT_OVERRIDES, da_kernels)
    check_validation_loss(s2trainer)
    s3trainer, s3_launches, _ = train_phase(
        card, S3D_YAML, S3D_FIXED_OVERRIDES, d_anp_kernels)
    check_validation_loss(s3trainer)
    s4_launches = check_large_evaluation(
        "S4", S3D_EVAL_YAML, S3D_EVAL_OVERRIDES, [(s1trainer, [])])

    stamp("phase 16, ShapeNet3D")
    # phase 17: LargeCNP in bfloat16 (K2 wide and K6's programs 4 and 6 in
    # bfloat16): S5 the ShapeNet3D perf YAML as shipped, S6 S1 in bfloat16,
    # D5 D1 in bfloat16
    s5trainer, s5_launches, s5_nodes = train_phase(
        card, S3D_PERF_YAML, S5_OVERRIDES, da_kernels)
    check_bf16_validation(s5trainer)
    s6trainer, s6_launches, s6_nodes = train_phase(
        card, S3D_YAML, S3D_OVERRIDES + BF16, d_anp_kernels)
    check_bf16_validation(s6trainer)
    d5trainer, d5_launches, d5_nodes = train_phase(
        card, DISTRACTOR_YAML, DISTRACTOR_OVERRIDES + BF16, d_anp_kernels)
    check_bf16_validation(d5trainer)
    dtype_turns({"Distractor ANP (D1, D5)": (d1trainer, d5trainer),
                 "ShapeNet3D ANP (S1, S6)": (s1trainer, s6trainer),
                 "ShapeNet3D CondNeuralProcess (S2, S5)": (s2trainer,
                                                           s5trainer)},
                calls=2, profile="--profile" in argv)

    stamp("phase 17, LargeCNP in bf16")
    # graph replays against the same steps issued from the host, bit for
    # bit, on fresh trainers (phase 18's M1 and F2 among them), before
    # phase 18 builds its trainers: the process's earlier state is the one
    # these checks have always run in (cuDNN picks its bf16 MAML engines
    # from it)
    for yaml, overrides in ((MAIN_YAML, TRAIN_OVERRIDES),
                            (MAIN_YAML, BF16_OVERRIDES),
                            (MAML_YAML, MAML_OVERRIDES),
                            (PERF_MAML_YAML, PERF_MAML_OVERRIDES),
                            (PASCAL_YAML, PASCAL_OVERRIDES),
                            (PERF_ANP_YAML, PERF_ANP_OVERRIDES),
                            (PERF_ANP_T40_YAML, PERF_ANP_OVERRIDES),
                            (DISTRACTOR_YAML, DISTRACTOR_OVERRIDES),
                            (S3D_YAML, S3D_OVERRIDES),
                            (S3D_PERF_YAML, S5_OVERRIDES),
                            (MR_ANP_YAML, TRAIN_OVERRIDES),
                            (FCL_ANP_YAML, DISTRACTOR_SHORT_OVERRIDES)):
        graph_equals_loop(yaml, overrides)
    stamp("graph against loop, bit for bit")
    # phase 18: MR and FCL (ROADMAP.md A13): M1-M3, F1-F3, E1
    m1trainer, m1_launches, m1_nodes = train_phase(
        card, MR_ANP_YAML, TRAIN_OVERRIDES, anp_kernels, tap=True)
    check_mr_validation(m1trainer)
    m2trainer, m2_launches, m2_nodes = train_phase(
        card, MR_MAML_YAML, MR_MAML_OVERRIDES, maml_kernels, tap=True)
    check_mr_validation(m2trainer)
    stamp("phase 18: M1, M2")
    check_mr_second_order()
    stamp("phase 18: M2's second-order gradient")
    m3trainer, m3_launches, m3_nodes = train_phase(
        card, MR_3D_YAML, DISTRACTOR_SHORT_OVERRIDES,
        {"favor_attention": favor_attention})
    check_mr_validation(m3trainer)
    f1trainer, f1_launches, f1_nodes = train_phase(
        card, FCL_CNP_YAML, TRAIN_OVERRIDES,
        {"literature_stem": literature_stem, **da_kernels})
    check_validation_loss(f1trainer)
    f2trainer, f2_launches, f2_nodes = train_phase(
        card, FCL_ANP_YAML, DISTRACTOR_SHORT_OVERRIDES, d_anp_kernels)
    check_validation_loss(f2trainer)
    f3trainer, f3_launches, f3_nodes = train_phase(
        card, FCL_DISTRACTOR_YAML, DISTRACTOR_SHORT_OVERRIDES, da_kernels)
    check_validation_loss(f3trainer)
    stamp("phase 18: M3, F1-F3")
    check_large_evaluation("E1", FCL_EVAL_YAML, DISTRACTOR_EVAL_OVERRIDES,
                           [(f3trainer, [])])
    e1_launches = check_mr_evaluation(m1trainer)

    stamp("phase 18, MR and FCL")
    graph_loop_turns(
        {"ANPShapeNet1D": trainer, "ANPShapeNet1D bf16": btrainer,
         "MAMLShapeNet1D": mtrainer, "MAMLShapeNet1D bf16": bmtrainer,
         "ANPVanillaPascal1D": ptrainer, "VanillaMAML Pascal1D": pmtrainer,
         "ANPShapeNet1D fixed bf16": ftrainer,
         "ANPShapeNet1D fixed bf16 T40": f40trainer,
         "ANPDistractor": d1trainer, "CNPDistractor": d2trainer,
         "ANP ShapeNet3D": s1trainer,
         "CondNeuralProcess ShapeNet3D": s2trainer,
         "CondNeuralProcess ShapeNet3D bf16 (S5)": s5trainer,
         "ANP ShapeNet3D bf16 (S6)": s6trainer,
         "ANPDistractor bf16 (D5)": d5trainer,
         "ANPMRShapeNet1D (M1)": m1trainer,
         "MAMLMRShapeNet1D (M2)": m2trainer,
         "ANPMRShapeNet3D (M3)": m3trainer,
         "FCLCNPShapeNet1D (F1)": f1trainer, "FCLANP (F2)": f2trainer,
         "FCLCNPDistractor (F3)": f3trainer},
        calls={"ANPShapeNet1D": 2, "ANPShapeNet1D bf16": 1,
               "MAMLShapeNet1D": 1, "MAMLShapeNet1D bf16": 1,
               "ANPVanillaPascal1D": 2, "VanillaMAML Pascal1D": 1,
               "ANPShapeNet1D fixed bf16": 1,
               "ANPShapeNet1D fixed bf16 T40": 1, "ANPDistractor": 1,
               "CNPDistractor": 1, "ANP ShapeNet3D": 1,
               "CondNeuralProcess ShapeNet3D": 1,
               "CondNeuralProcess ShapeNet3D bf16 (S5)": 1,
               "ANP ShapeNet3D bf16 (S6)": 1, "ANPDistractor bf16 (D5)": 1,
               "ANPMRShapeNet1D (M1)": 2, "MAMLMRShapeNet1D (M2)": 1,
               "ANPMRShapeNet3D (M3)": 1, "FCLCNPShapeNet1D (F1)": 2,
               "FCLANP (F2)": 1, "FCLCNPDistractor (F3)": 1},
        nodes={"ANPShapeNet1D": anp_nodes, "ANPShapeNet1D bf16": anp_bf16_nodes,
               "MAMLShapeNet1D": maml_nodes,
               "MAMLShapeNet1D bf16": maml_bf16_nodes,
               "ANPVanillaPascal1D": pascal_nodes,
               "VanillaMAML Pascal1D": pascal_maml_nodes,
               "ANPShapeNet1D fixed bf16": anp_fixed_nodes,
               "ANPShapeNet1D fixed bf16 T40": anp_fixed40_nodes,
               "ANPDistractor": d1_nodes, "CNPDistractor": d2_nodes,
               "ANP ShapeNet3D": s1_nodes,
               "CondNeuralProcess ShapeNet3D": s2_nodes,
               "CondNeuralProcess ShapeNet3D bf16 (S5)": s5_nodes,
               "ANP ShapeNet3D bf16 (S6)": s6_nodes,
               "ANPDistractor bf16 (D5)": d5_nodes,
               "ANPMRShapeNet1D (M1)": m1_nodes,
               "MAMLMRShapeNet1D (M2)": m2_nodes,
               "ANPMRShapeNet3D (M3)": m3_nodes,
               "FCLCNPShapeNet1D (F1)": f1_nodes, "FCLANP (F2)": f2_nodes,
               "FCLCNPDistractor (F3)": f3_nodes},
        profile="--profile" in argv)
    stamp("graph against loop, in turns")
    # phase 18's graphs and their pools (about 14 GB) go before the
    # determinism check builds its fresh trainers
    del m1trainer, m2trainer, m3trainer, f1trainer, f2trainer, f3trainer
    gc.collect()
    torch.cuda.empty_cache()
    # cuDNN's determinism: its cost a step on four paths (ROADMAP.md C2)
    determinism_turns(
        {"ANPShapeNet1D": (MAIN_YAML, TRAIN_OVERRIDES),
         "MAMLShapeNet1D": (MAML_YAML, MAML_OVERRIDES),
         "ANPDistractor": (DISTRACTOR_YAML, DISTRACTOR_OVERRIDES),
         "ANP ShapeNet3D": (S3D_YAML, S3D_OVERRIDES)},
        calls={"ANPShapeNet1D": 2, "MAMLShapeNet1D": 1, "ANPDistractor": 1,
               "ANP ShapeNet3D": 1})

    stamp("cuDNN's determinism")
    launches = {"ANP": anp_launches, "MAML": maml_launches,
                "ANP bf16": anp_bf16, "MAML bf16": maml_bf16,
                "Pascal ANP": pascal_launches, "Pascal ANP fixed": pascal_fixed,
                "Pascal MAML": pascal_maml, "ANP fixed bf16": anp_fixed,
                "ANP fixed T40 bf16": anp_fixed40,
                "Distractor ANP": d1_launches, "Distractor CNP": d2_launches,
                "Distractor ANP fixed": d3_launches,
                "Distractor eval": {"favor_attention": d4_launches},
                "ShapeNet3D ANP": s1_launches, "ShapeNet3D CNP": s2_launches,
                "ShapeNet3D ANP fixed": s3_launches,
                "ShapeNet3D eval": {"favor_attention": s4_launches},
                "ShapeNet3D CNP bf16": s5_launches,
                "ShapeNet3D ANP bf16": s6_launches,
                "Distractor ANP bf16": d5_launches,
                "MR ANP": m1_launches, "MR MAML": m2_launches,
                "MR ShapeNet3D": m3_launches, "FCL CNP": f1_launches,
                "FCL ANP": f2_launches, "FCL Distractor": f3_launches,
                "MR eval": e1_launches}
    for r in rows:
        if r.get("off_path"):
            r["launches"] = 0
            continue
        # a K6 row counts its own program's launches on its path
        key = r["kernel"] + (f".{r['program']}" if "program" in r else "")
        r["launches"] = launches[r["path"]].get(key, 0)
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']}: no {key} launch on the "
                                 f"{r['path']} path")
    log(f"profile: {TRACES['taken']} traces of torch.profiler, "
        f"{TRACES['empty']} holding no device event, {TRACES['short']} "
        f"fewer device events than their kernels imply; "
        f"{TRACES['graph']} calls measured from a CUDA graph instead")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
