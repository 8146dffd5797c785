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
     as the code says, K6 twice a step; the trained model's validation
     loss on one episode must agree between the card and the CPU within
     VAL_TOL, or come within GRAD_FACTOR times the CPU's own distance from
     the same loss in float64 (``check_validation_loss(exact=True)``): the
     card's distance from the CPU moves from run to run with cuDNN's
     default algorithms (0.0046 and 0.0225 degrees on two runs on an H100,
     against a VAL_TOL of 0.0223);
  8. the second-order outer gradient of four full-width MAML batches (the
     replayed training's first, then three drawn from the seeds after it,
     each augmented once through K6: DA has no gradient) through the
     kernels against the same gradient by plain autograd through the twins
     (no custom autograd Function at all), on the card, on phase 7's
     training replayed under deterministic algorithms, so that its state,
     its sums and its verdict are the same on every run: the first within
     GRAD_FACTOR times the twins' error, the others by their own rounding
     spread (``SPREAD_BATCHES``);
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
     float32 then bfloat16 on the trained trainers;
 12. graph against loop: for each of the training configurations, two
     trainers from one seed under deterministic algorithms, one calling
     the fused step three times (warm-up, capture and replay, replay), the
     other issuing the same steps from the host: every call's metrics, the
     weights, Adam's state and the generator's state equal bit for bit.
     Then, on phases 4, 7, 9 and 10's trainers, ms/step and tasks/s of graph
     replays against the loop, timed graph then loop,
     with the graph's nodes, its capture's and instantiation's host seconds
     and its memory pool's bytes; with ``--profile`` the card's busy share
     of a call of each. Then cuDNN's determinism (ROADMAP.md C2): on ANP
     f32 and D1, two fresh trainers each, one capturing its
     graph with ``torch.backends.cudnn.deterministic`` off, one with it on,
     their replays timed off, then on;
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
     D2's graph and loop ms/step;
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
     S1's and S2's graph and loop ms/step;
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
     graph ms/step and tasks/s on D1/D5, S1/S6 and S2/S5 (with
     ``--profile`` each one's busy share); graph against loop bit for bit
     on S5 (phase 12's check) and S5's, S6's and D5's graph and loop
     ms/step;
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
     ms/step on every new path. Phase 3 also holds K1 on BBB
     samples at M1's (150 images a pass) and M2's (per task) shapes;
 19. SingleTask and refinement (ROADMAP.md A14), every kernel counter
     zeroed before each path and read after it: T1
     ``cfg/train/SingleTask_DA+TA_ShapeNet1D.yaml`` (K1 once a step on the
     150 query images alone, K6 program 0 twice, no K2), 32 steps, 8 a
     call; T2 ``SingleTask_DA+TA_Distractor.yaml`` (two trunks on the
     queries, K6 program 4 twice, no K1, no K2) and T3
     ``SingleTask_DA+TA_ShapeNet3D.yaml`` (K6 program 6 twice, no K2), 16
     steps each, all through ``train_phase``, with the validation loss card
     against CPU and the encoders' input on a validation episode the
     queries alone; R1, R2 ``refinement_cli`` with
     ``cfg/refinement/Refine_DA_{ShapeNet1D,Distractor}.yaml`` over T1's
     and T2's checkpoints (all 25 counts, iterations 0..2, 2 validation
     and 2 test sweeps of 2 episodes a count; eager refine steps, K6 twice
     each; ``loss_vs_ctx.txt`` 25 rows; each count's iteration-0 loss
     equal to a fresh evaluator's, every count of R1, 3 of R2; an
     iteration's host and device ms); O1, O2 ``eval_one_task_cli`` with
     ``cfg/evaluation/eval_one_task/{ANP_ShapeNet1D,CNP_max_Distractor}
     .yaml`` over phase 4's and D2's checkpoints (``test_losses.txt`` 25
     rows, flat, std 0; K2 narrow at one task); Q1-Q3 ``eval_and_plot_cli``
     with ``cfg/evaluation/eval_and_plot/{ANP_ShapeNet1D,ANP_ShapeNet3D,
     CNP_max_Distractor}.yaml`` over phase 4's, S1's and D2's
     (``losses_all.txt`` 2 rows, the plots where matplotlib is installed,
     Distractor's test split cut to 04530566); each evaluation's first
     number against the CPU; graph and loop ms/step on T1-T3.
     Phase 3 also holds K1 at R1's 25 images, K2's narrow form at O1's
     single task (Nq = Nk = 25) and K2's wide form at Q2's shape (Nq 30,
     Nk 15);
 20. MMAML (ROADMAP.md A16): ``cfg/train/MMAML_ShapeNet1D_DA+TA.yaml``
     (MMAMLShapeNet1D at full width: the gated net's 32-256 channels, the
     embedding net, 5 second-order inner steps, 10 at validation) through
     ``train_phase``, 8 steps, 4 a call: K6 program 0 twice a step, graph
     nodes included, and K1, K2 and K3 no time, every counter zeroed
     before and read after; two more replays draw new DA (a tap on K6's
     output); the validation loss on one episode (its first three tasks),
     card against CPU; the outer loss and both networks' second-order
     outer gradients of the first three tasks of one seeded batch under
     deterministic algorithms, card against float64 on the CPU, within
     GRAD_FACTOR times the float32 CPU's own distance
     (``check_mmaml_grad``); graph and loop ms/step with the card's busy
     share, graph nodes, capture and instantiation seconds and pool bytes;
     graph against loop bit for bit (phase 12's check), which holds the
     captured per-group clip and two-group Adam against the eager ones;
 21. the ``device_data`` switch both ways (ROADMAP.md A21, A26): H1 phase
     4's YAML with ``device_data=false`` (32 steps, 8 a call: host episodes
     drawn by the prefetch thread, copied into the graph's static buffers
     each call), its first call's episodes against ``get_batch`` from a
     freshly seeded copy of the data, graph = loop on the same host batches
     under deterministic algorithms, ms/step and the card's busy share
     beside phase 4's device-sampled path and the queue's empty waits; H2
     S1's YAML with ``device_data=false`` and ``bg_gen_freq=16`` (24
     steps, 8 a call: one recomposite of the train split on the prefetch
     thread, its pixels changed), ms/step against S1's, over training and
     with no recomposite, and the thread's ms a call; V1 the validation sweep on the device
     (10 episodes, the shipped ``val_iters``; MAML 5) of phase 4's ANP,
     phase 7's MAML and M1's trainers: each batch's loss against the host
     sweep's on fresh sweeps under deterministic algorithms, the graph
     sweep's, the eager device sweep's (ANP, M1) and the host sweep's
     times and the capture's; V2 ``evaluation_cli``'s device sweep
     against its host sweep (``device_data=false``) over phase 6's, P4's,
     D4's ANPDistractor and S4's checkpoints: each point's mean and std
     within rtol 1e-4 / atol 1e-5 (stds rtol 1e-3 / atol 1e-4), the times
     (and without graphs on the ANP sweep); the kernels line gives each
     row the launches
     of the phase 21 paths that run its kernel at its shapes
     (``phase21_launches``). H3 D1's YAML with ``device_data=false`` (16
     steps, 8 a call). H1, H2 and H3 draw their episodes through the
     native episode core (``data/episode_core.py``): H2's and H3's first
     calls equal the numpy twins' from a freshly seeded copy bit for bit
     (``check_first_call_twin``), H3's host loop is timed against D1's
     graph replays with the thread's ms a call and the queue's empty
     waits, and the gather of a call at H2's and H3's shapes is timed on
     the host, the core against the numpy twin (``native_gather_ms``);
 22. ``maml_remat`` (ROADMAP.md A19): phase 7's MAML YAML (8 steps, 4 a
     call) and phase 20's MMAML YAML, each with ``maml_remat=step`` and
     ``dots``, through ``train_phase`` (K1 and K3 twice an inner step in
     training, as the code says; K6 program 0 twice a step); each one's
     second-order outer loss and gradients of one seeded batch against
     ``none``'s on the same trainer, bit for bit under deterministic
     algorithms (``check_remat_grad``); graph ms/step of none (phase 7's
     and phase 20's trainers), step and dots in one round, each one's busy
     share, pool bytes, peak allocated memory above its phase's start,
     capture and instantiation seconds and graph nodes (``remat_phase``);
 23. MMAML in bfloat16 (ROADMAP.md A27): phase 20's YAML with
     ``compute_dtype=bfloat16`` through ``train_phase`` (every K6 launch a
     bfloat16 one, K1-K3 none); its validation loss on one episode, card
     against CPU, within the bfloat16 rule; the outer loss and both nets'
     second-order gradients against float64 within the bfloat16 rule
     (``check_mmaml_grad_bf16``); float32 against bfloat16 graph ms/step
     in turns with busy shares, pool bytes and graph nodes. The kernels
     line gives each row the launches of phases 20, 22 and 23 at its
     shapes (``phase22_launches``);
 24. the phase-layout trunk stem (ROADMAP.md B8b, ``trunk_stem: s2d``):
     D1, D5 and S6 with ``trunk_stem=s2d`` (16 steps each, 8 a call)
     through ``train_phase`` (K2 wide and K6 programs 4 and 6 as the code
     says, in bfloat16 where the path is); validation on one episode, card
     against CPU (float32 tolerance, the bfloat16 rule); graph = loop bit
     for bit under deterministic algorithms; graph ms/step against phases
     14's and 17's stock-stem trainers of the same configuration, in turns
     stock, s2d, s2d, stock, and one call of each profiled (busy share, top
     kernels) (``s2d_phase``);
 25. data parallelism over the task axis (ROADMAP.md A18) on a one-rank
     NCCL group: ``cfg/train/ANP_DA+TA_ShapeNet1D.yaml`` with
     ``mesh_shape={data: 1}`` through ``train_cli``'s ``start_mesh`` and
     ``train_phase`` (16 steps, 8 a call): the gradient all-reduce is a
     node of the captured graph (``graph_nodes``' ``all_reduce``), loss,
     weights, Adam's state and the generator equal the same run's without
     a group bit for bit under deterministic algorithms
     (``group_equals_plain``), graph ms/step with the group against phase
     4's trainer without, in turns, and ``obs/profile.py:profile_trace``
     of one replay writes a trace naming K1, K2, K6 and the all-reduce;
     K2 with an outer key max (``favor_launch(kmax=...)``, what a mesh of
     more ranks passes it) against its twin with the same max, narrow and
     wide (``check_favor_kmax``). The kernels line gives each row the
     launches of phases 24 and 25 at its shapes (``phase24_launches``);
 26. ``conv_bwd: phase`` (ROADMAP.md B8a): K1b, the stem's backward kernel
     (``csrc/stem_bwd.cu``) on the pool's routes of K1's forward, against
     its twin ``stem_backward_phase_plain`` at ANP's [300, 128, 128, 1] in
     float32 (on dyadic inputs, every forward sum exact, so K1's routes
     are the twin's: each gradient within BWD_GRAD_FACTOR times the
     float32 twin's own distance from float64, or BWD_TOL of its largest;
     on uniform images and the model's weights, each gradient against the
     twin fed the decisions K1b took, at the same limits, and the
     decisions that differ from the twin's own logged) and in bfloat16
     (``check_bf16``'s rule), and at P3 T40's [1,200, 128, 128, 1] in
     bfloat16 (off_path); card, device (by kernel), plain, bound and
     library (today's backward: autodiff of the twin on cuDNN) ms
     (``check_stem_backward``); K1 with the routes against K1 without
     (outputs bit for bit, ms in turns; ``check_stem(route=True)``). Then
     ``cfg/train/ANP_DA+TA_ShapeNet1D.yaml`` with ``conv_bwd=phase`` (16
     steps, 8 a call) in float32 and bfloat16 through ``train_phase`` (K1b
     once a step, graph nodes included), card against CPU validation,
     graph = loop bit for bit, graph ms/step against ``xla`` in turns
     (``phase_bwd_phase``);
 27. the tensor-parallel "model" axis (ROADMAP.md A18c): two ranks of a
     gloo world on this card (this script again, ``--tp-worker``), S1 at
     full width with ``mesh_shape={data: 1, model: 2}``, TP_STEPS eager TP
     steps against one process's from the same state and batches under
     deterministic algorithms (``tp_phase``). The kernels line gives each
     row the launches of phases 26 and 27 at its shapes
     (``phase26_launches``, ``phase27_launches``, each rank's);
 15. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Depth cuts against the time limit: graph = loop (phase 12) checks the
paths that take 64 steps a call with graphs of 8 steps
(``GRAPH_LOOP_K8``), K6's ShapeNet3D and Distractor programs meet
their CPU twin on the first ``CPU_TWIN_TASKS`` tasks of a call (their card
twin on all 20), a replay's trace is taken on the first path of each set
of captured kernels only (``TRACED``; every path still holds its graph's
nodes and its launches), and phase 22 times none, step and dots in one
round.

Phase 3 also holds the Distractor paths' kernels: K2's wide form at D1's
shape (q [20, 8, 18, 256], k, v [20, 8, 15, 256], m 1419, shots 1..15) and
D4's (Nq 36, Nk 25) against ``favor_plain`` (``TOL["favor_attention_wide"]``),
and K6's programs 4 (both orders) and 5 at D1's two DA calls (300 and 360
images): parameters bit for bit, masks on 1 - x / 255 bit for bit, values
within ``TOL["warp_chain"]`` of the card twin and the CPU twin; each timed.

Phase 3 also holds the ShapeNet3D paths' kernels: K2's wide form at S1's
shape (q, k, v [20, 8, 15, 256], shots 1..15) and S4's (Nq 30, Nk 25), and
K6's programs 6 (eleven of its 720 orders: the identity, the reverse and
those that put each pointwise op after each moving op and after the load)
and 7 at S1's two DA calls (300 and 300 images, the RGB channels of
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
orders (the identity, the reverse, those that put each pointwise op after
each moving op and after the load, and drawn ones), 2 of them again
against the CPU twin, in float32 within ``TOL["pixel_ops"]`` and in two
orders in bfloat16 within ``check_bf16``'s rule; both fixed programs in
float32 and bfloat16 (ShapeNet1D's, one warp and the mask, also within 2
bfloat16 ulps of each element, as program 0); every program's parameters
and, with the warps and pixel ops off, its masks bit for bit; each timed
(card, device, plain, library ms, bound and the phase clock: a stamp after
the draw, the tables, the load and each pass), Pascal1D's programs in
bfloat16 too, off every path. At P3's T = 40 shapes it holds K1
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

import contextlib
import functools
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
# SingleTask and refinement (phase 19), as shipped but for their depth: T1
# SingleTask_DA+TA_ShapeNet1D as the ANP path (32 steps, 8 a call), T2
# SingleTask_DA+TA_Distractor and T3 SingleTask_DA+TA_ShapeNet3D (16 steps,
# 8 a call); R1, R2 the refinement YAMLs over T1's and T2's checkpoints
# (all 25 counts, 3 iterations each: 0..2); O1, O2 the single-task
# evaluation YAMLs over phase 4's and D2's checkpoints; Q1-Q3 the
# evaluate-and-plot YAMLs over phase 4's, S1's and D2's; 2 episodes a point
ST_YAMLS = {task: os.path.join(HERE, "cfg", "train",
                               f"SingleTask_DA+TA_{task}.yaml")
            for task in ("ShapeNet1D", "Distractor", "ShapeNet3D")}
REFINE_YAMLS = {task: os.path.join(HERE, "cfg", "refinement",
                                   f"Refine_DA_{task}.yaml")
                for task in ("ShapeNet1D", "Distractor")}
REFINE_OVERRIDES = ["synthetic_data=true", "device=cuda", "iterations=2",
                    "val_freq=2", "val_iters=2"]
ONE_TASK_DIR = os.path.join(HERE, "cfg", "evaluation", "eval_one_task")
PLOT_DIR = os.path.join(HERE, "cfg", "evaluation", "eval_and_plot")
ONE_PLOT_OVERRIDES = ["synthetic_data=true", "device=cuda", "val_iters=2"]
# MMAML (phase 20), as shipped but for its depth: 8 steps, 4 a call (an
# eager warm-up call, the capture and its replay), one validation sweep of
# one episode a split (10 inner steps each)
MMAML_YAML = os.path.join(HERE, "cfg", "train", "MMAML_ShapeNet1D_DA+TA.yaml")
MMAML_OVERRIDES = ["data_size=large", "synthetic_data=true", "iterations=8",
                   "val_freq=1000", "val_iters=1", "steps_per_call=4",
                   "device=cuda"]

# the device_data switch both ways (phase 21): H1 phase 4's path with its
# episodes streamed from the host, H2 S1's (24 steps, 8 a call) with one
# recomposite of the train split inside the run (at iteration 16); V1
# validation sweeps of the shipped val_iters on the device
HOST_OVERRIDES = TRAIN_OVERRIDES + ["device_data=false"]
H2_OVERRIDES = S3D_SHORT_OVERRIDES + ["iterations=24", "device_data=false",
                                      "bg_gen_freq=16"]
V1_ITERS = 10
# H3 (phase 21): D1's path streamed from the host (16 steps, 8 a call)
H3_OVERRIDES = DISTRACTOR_SHORT_OVERRIDES + ["device_data=false"]
# the remat rows (phase 22): phase 7's MAML YAML at 8 steps, 4 a call, and
# phase 20's MMAML overrides, each with maml_remat step and dots
MAML_REMAT_OVERRIDES = [o for o in MAML_OVERRIDES
                        if not o.startswith("iterations=")] + ["iterations=8"]
# graph = loop on the paths that take 64 steps a call checks graphs of 8
# steps: the same code (FusedSteps), an eighth of the steps
GRAPH_LOOP_K8 = ["steps_per_call=8"]
# phase 24 (ROADMAP.md B8b): the phase-layout trunk stem on D1, D5 and S6
S2D = ["trunk_stem=s2d"]
# phase 25 (ROADMAP.md A18): the ANP path on a one-rank NCCL group
DP_OVERRIDES = TRAIN_OVERRIDES + ["iterations=16", "mesh_shape={data: 1}"]
# phase 26 (ROADMAP.md B8a): the ANP path with the stem's backward through
# K1b, 16 steps, 8 a call
PHASE_BWD = ["iterations=16", "conv_bwd=phase"]
# K1b against its twin in float32 (``check_stem_backward``): the gradients
# sum up to 1.2M products (dW0 at 300 images) in another order than the
# twin's, so each is held within BWD_GRAD_FACTOR times the float32 twin's
# own distance from the twin in float64, or BWD_TOL of its largest element
BWD_TOL, BWD_GRAD_FACTOR = 1e-5, 3.0
# phase 27 (ROADMAP.md A18c): S1 on {data: 1, model: 2}, TP_STEPS eager
# steps with SGD (``tp_phase``)
TP_STEPS = 4
TP_OVERRIDES = S3D_SHORT_OVERRIDES + ["optimizer=SGD"]
# the NCCL kernel of the gradient all-reduce in a graph's DOT or a trace
# (one rank: NCCL's own average, ``oneRankReduce``; more: its ring kernels)
NCCL_KERNEL = r"nccl|oneRankReduce"

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
# phase 8 also holds SPREAD_BATCHES more batches, drawn from generators
# seeded seed + 1 .. seed + SPREAD_BATCHES: float32's error there swings
# from batch to batch with the rounding alone (``--grad-spread`` has read
# 6x the twins' on one batch in eight), so each added batch is held
# against its own rounding spread, read from the twins alone: the batch
# and SPREAD_JITTERS copies of it with half the nonzero pixels moved one
# ulp (every rounding after them moves, no true gradient does) give as
# many samples of float32's error, and the kernels' largest error over
# them must come within GRAD_FACTOR times the twins' largest (or GRAD_TOL)
SPREAD_BATCHES, SPREAD_JITTERS = 3, 1
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
# K6's ShapeNet3D and Distractor programs against their CPU twin: on the
# first CPU_TWIN_TASKS tasks of a call (every image has its own draws and
# keys, so a task's outputs depend on its images alone); the card twin
# holds all 20
CPU_TWIN_TASKS = 2
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


# host seconds spent in each timing and checking helper over the run
# (``spent``; logged at the end), to say where the script's time goes
SPENT = {}


def spent(fn):
    """Add the host seconds of each call of ``fn`` to ``SPENT``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            SPENT[fn.__name__] = (SPENT.get(fn.__name__, 0.0)
                                  + time.perf_counter() - t0)
    return wrapped


@spent
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


def device_events(prof):
    """The device events of a finished torch.profiler run, as (name, start
    us, end us), read from its raw results: the profiler's own event list
    (``prof.events()``) builds an object an event, about 65 us each on the
    host, seconds for a MAML replay's 58k events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()
            and not getattr(e, "is_hidden_event", lambda: False)()]


@spent
def device_profile(fn, iters=20, names=None, breakdown=False):
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
        kernels = device_events(prof)
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
    for name, start, end in kernels:
        by_name.setdefault(name, []).append(end - start)
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
    out = dict(device_ms=us / 1e3, kernels_per_call=sum(per_call.values()),
               events_recorded=len(kernels), events_implied=implied,
               device_ms_by="torch.profiler")
    if breakdown:       # device ms a call of each kernel
        out["device_ms_by_kernel"] = {
            n: per_call[n] * sum(v) / len(v) / 1e3 for n, v in by_name.items()}
    return out


# kernel names a graph's DOT is searched for (``graph_profile``); the longer
# of two that overlap comes first
DOT_KERNELS = ("favor_kernel_wide", "favor_kernel", "image_da_kernel",
               "stem_fwd_kernel", "stem_bwd_kernel", "stem_bwd_reduce_kernel",
               "bn_relu_kernel")


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


@spent
def check_stem(model, gen, dtype=None, tasks=10, path="ANP", images=None,
               name=None, route=False):
    """K1 at the ANP path's shape: the merged ctx+qry batch, 30 images a
    task (300 at T = 10, 1,200 at ``tasks`` = 40), or ``images`` images
    (refinement's 25 context images, row ``name``), in float32 or
    (``dtype``) bfloat16; the row reports ``path``'s launches. ``route``:
    K1 as ``conv_bwd: phase`` launches it, writing the pool's routes for
    K1b (row ``literature_stem_route``): its output must equal K1's
    without the routes bit for bit, and both are timed in turns
    (``ms_no_route``, ``device_ms_no_route``)."""
    import torch
    import torch.nn.functional as F

    from wmfml_tpu_torch.kernels import stem

    dtype = dtype or torch.float32
    enc = model.encoder_w0
    w0, b0, w1, b1 = (p.detach().to(dtype) for p in (
        enc[0].weight, enc[0].bias, enc[2].weight, enc[2].bias))
    b, h, w = images or tasks * 30, 128, 128
    x = torch.rand((b, h, w, 1), generator=gen, device="cuda").to(dtype)
    args = (x, w0, b0, w1, b1)
    got = stem.stem_launch(*args)
    want = stem.stem_plain(*args)
    if route:
        with_route, routes = stem.stem_launch(*args, route=True)
        torch.cuda.synchronize()
        if not torch.equal(with_route, got):
            raise AssertionError("literature_stem: the output with the "
                                 "pool's routes differs from the output "
                                 "without them")
        if not bool((routes <= 4).all()):
            raise AssertionError("literature_stem: a route outside 0-4")
    f32 = None if dtype == torch.float32 else (
        lambda: stem.stem_plain(*(a.float() for a in args)))
    err, rel = check_kernel("literature_stem", got, want, f32)
    xn = x.permute(0, 3, 1, 2).contiguous()

    def library():      # cuDNN yardstick, NCHW; never called by the port
        a = F.relu(F.conv2d(xn, w0, b0, stride=2, padding=1))
        a = F.relu(F.conv2d(a, w1, b1, stride=2, padding=1))
        return F.max_pool2d(a, 2)

    def launch():
        return stem.stem_launch(*args, route=route)

    fns = {"ms": launch, "plain_ms": lambda: stem.stem_plain(*args),
           "library_ms": library}
    if route:
        fns["ms_no_route"] = lambda: stem.stem_launch(*args)
    times = in_turns(fns)
    times.update(device_profile(launch))
    nbytes = x.element_size() * (x.numel() + got.numel() + sum(
        t.numel() for t in (w0, b0, w1, b1)))
    ids = _rows("literature_stem", dtype, path, tasks)
    if name is not None:
        ids.update(name=name, tol="literature_stem")
    if route:
        nbytes += got.numel()
        times["device_ms_no_route"] = device_profile(
            lambda: stem.stem_launch(*args))["device_ms"]
        ids.update(name=ids["name"].replace("literature_stem",
                                            "literature_stem_route"),
                   tol="literature_stem")
        log(f"kernel: literature_stem with the pool's routes ({ids['dtype']}"
            f", {b} images): output = without, bit for bit; device ms "
            f"{times['device_ms']} with, {times['device_ms_no_route']} "
            f"without ({times['device_ms'] / times['device_ms_no_route']}"
            f"x); card ms {times['ms']} with, {times['ms_no_route']} without")
    return dict(**ids, shape=f"shared weights, [{b}, 128, 128, 1]",
                source="wmfml_tpu_torch/csrc/stem.cu",
                replaces="wmfml_tpu/nn/encoders.py:230",
                max_abs_err=err, max_rel_err=rel, **times,
                **stem_bound(b, h, w, nbytes, dtype == torch.bfloat16))


@spent
def check_favor(model, gen, dtype=None, tasks=10, path="ANP", n=15):
    """K2 at the ANP path's shape, T = ``tasks`` (10, or 40: more (task,
    head) items than co-resident blocks), with shots 3..15 across the
    tasks, or T = 1 with all ``n`` rows real (single-task evaluation: 8
    (task, head) items, Nq = Nk = 25); q, k, v are [T, N, H, d] transposed
    to [T, H, N, d], as the attention block hands them over, float32 or
    (``dtype``) bfloat16. One call must issue one kernel. The row reports
    ``path``'s launches."""
    import torch

    from wmfml_tpu_torch.kernels import favor

    dtype = dtype or torch.float32
    proj = model.attn.projection_matrix
    t_, h, d = tasks, 8, proj.shape[1]
    q, k, v = (torch.randn((t_, n, h, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2) for _ in range(3))
    shots = torch.tensor([3 + (12 * i) // (t_ - 1) if t_ > 1 else n
                          for i in range(t_)], device="cuda")
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
                tol="favor_attention",
                shape=f"q, k, v [{t_}, 8, {n}, 64], m 266, shots "
                + ("3..15" if t_ > 1 else f"{n}"),
                source="wmfml_tpu_torch/csrc/favor.cu",
                replaces="wmfml_tpu/nn/attention.py:93",
                max_abs_err=err, max_rel_err=rel, **times, library_ms=None,
                **bound(flops, nbytes, split_flops=split_flops,
                        split_products=3 if dtype == torch.float32 else 2))


@spent
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


@spent
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


@spent
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


def image_da_geometry():
    """K6's launch geometry by program and output type, from the library
    (``image_da.kernel_geometry``), held against the host's mirror
    (``image_da.launch_geometry``), with the waves each path's images take
    (150 a Pascal1D or ShapeNet1D call, 300 a ShapeNet3D or Distractor
    context call)."""
    from wmfml_tpu_torch.kernels import image_da as kda

    out = {}
    for program in kda.PROGRAMS:
        hw, images = ((64, 300) if program in kda.RGB else
                      (128, 300 if "distractor" in program else 150))
        for dtype in kda.DTYPES:
            got = kda.kernel_geometry(program, hw, hw, dtype)
            want = kda.launch_geometry(program, hw, hw, dtype, images)
            if got != (want["threads"], want["smem"], want["min_blocks"]):
                raise AssertionError(f"image_da geometry of {program} "
                                     f"{dtype}: library {got}, host mirror "
                                     f"{want}")
            out[f"{program} {str(dtype)[6:]}"] = [
                want["threads"], want["smem"], want["blocks_per_sm"],
                want["waves"]]
    return out


@spent
def da_phases(x, u, keys, order, runs=10, dtype=None,
              program="shapenet_1d"):
    """K6's phase clock (the global timer, ns, read by each block's first
    thread after a barrier; ``image_da.PHASES``: the draw, the tables, the
    load and each pass): the mean over the blocks of each phase's length
    (from the point before it; a program's unused passes read 0), of a
    block's life, and the span from the first block's start to the last
    block's end, in microseconds; medians over ``runs``."""
    import statistics

    import torch

    from wmfml_tpu_torch.kernels import image_da as kda

    per_run = []
    for _ in range(runs):
        stamps = torch.full((u.shape[0], kda.STAMPS), -1, dtype=torch.int64,
                            device="cuda")
        kda.image_da_launch(x, u, keys, order, dtype or torch.float32,
                            stamps=stamps, program=program)
        s = stamps.cpu().double()
        row = {name: float((s[:, j] - s[:, j - 1]).mean()) / 1e3
               for j, name in enumerate(kda.PHASES) if j}
        row["life"] = float((s[:, -1] - s[:, 0]).mean()) / 1e3
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


@spent
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


@spent
def check_image_da_programs(gen, programs=("pascal_1d", "shapenet_1d_fixed",
                                           "pascal_1d_fixed"), tasks=10):
    """K6's ``programs`` at the DA call's shape (the context slice of a [T,
    30, 128, 128, 1] uint8 batch, 15 T images: 150 at T = 10, 600 at
    ``tasks`` = 40), every gate on, against their
    twins: each program's parameters bit for bit against its
    ``params_from_draw`` (``params_for``) on the card; with the warps and
    pixel ops off and the dropout op on (Dropout, then CoarseDropout), its
    masks bit for bit against the twin on the card and on the CPU, float32
    and bfloat16; Pascal1D's chain in 12 orders (``covered_orders``: the
    identity, the reverse, those that put each pointwise op after each
    moving op and after the load, and drawn ones) against the card twin
    and in 2 of them against the CPU twin (``TOL["pixel_ops"]``), and in
    bfloat16 in 2 orders (``check_bf16``); each fixed program against both
    twins in float32 and bfloat16. Timed (``time_program``, with the phase
    clock): Pascal1D's chain in its identity order and Pascal1D's fixed
    program in float32 (P1's and its fixed twin's dtype) and in bfloat16
    (off every path), ShapeNet1D's fixed program in bfloat16 (P3's); the
    library yardstick is ``library_warp_ms`` of the program's first
    warp."""
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
        orders = [None] if fixed else covered_orders(program, drawn, 12)

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

        # timed: Pascal1D's programs in float32 (P1's and its fixed twin's
        # dtype) and, off every path, bfloat16; ShapeNet1D's fixed program
        # in bfloat16 (P3's)
        for dtype in ((bf16,) if program == "shapenet_1d_fixed"
                      else (f32, bf16)):
            rows.append(time_program(program, x, xc, u, keys, orders[0],
                                     dtype, on_card, p, tasks, dropped,
                                     worst))
    return rows


def covered_orders(program, drawn, count):
    """The orders a check of ``program`` runs: the identity, the last, the
    orders that put each pointwise op after each moving op and after the
    load (``image_da.covering_orders``), then drawn ones (``drawn``, a
    permutation of 1 .. n - 2 less one) up to ``count``."""
    from wmfml_tpu_torch.kernels import image_da as kda

    n = kda.PROGRAM_ORDERS[program]
    orders = [0, n - 1] + [o for o in kda.covering_orders(program)
                           if o not in (0, n - 1)]
    for o in drawn.tolist():
        if len(orders) >= count:
            break
        if o + 1 not in orders:
            orders.append(o + 1)
    return orders


def time_program(program, x, xc, u, keys, o, dtype, on_card, p, tasks,
                 dropped, worst):
    """The timed row of K6's ``program`` (1-3) on the uint8 images ``x`` in
    order ``o``, writing ``dtype``: card, device, plain and library ms,
    bound, the engine's phase clock (Pascal1D's programs); Pascal1D's
    bfloat16 rows are off every path."""
    import torch

    from wmfml_tpu_torch.aug import image_aug
    from wmfml_tpu_torch.kernels import image_da as kda

    fixed = kda.PROGRAM_ORDERS[program] == 1
    b, h, w = u.shape[0], x.shape[-3], x.shape[-2]
    t_ = b // 15

    def launch():
        return kda.image_da_launch(x, u, keys, on_card[o], dtype,
                                   program=program)

    def twin():
        return kda.image_da_plain(x, u, keys, on_card[o], dtype, program)

    err = (launch().float() - twin().float()).abs().max().item()
    # the twin (no yardstick of speed, and 100 times the kernel's time)
    # timed on fewer calls
    times = dict(ms=cuda_ms(launch), plain_ms=cuda_ms(twin, iters=3,
                                                      warmup=1))
    names = set()
    times.update(device_profile(launch, names=names))
    if len(names) != 1 or times["kernels_per_call"] != 1:
        raise AssertionError(f"image_da {program} issued "
                             f"{times['kernels_per_call']} kernels per "
                             f"call: {sorted(names)}")
    if program in kda.ENGINE:
        times["phase_us"] = da_phases(x, u, keys, on_card[o], dtype=dtype,
                                      program=program)
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
    if dtype == torch.bfloat16 and program != "shapenet_1d_fixed":
        ids.update(path=None, off_path="no path runs Pascal1D in bfloat16 "
                                       "(P1 and P2 run it in float32)")
    return dict(
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
        int_ops=iops, dropped_share=dropped)


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


@spent
def check_image_da_rgb(gen, dtype=None):
    """K6's ShapeNet3D programs at S1's (and S3's) two DA calls: the RGB
    channels of the context and query slices of a [20, 30, 64, 64, 4]
    RGBA batch (300 images each), float32 or (``dtype``, S5's and S6's)
    bfloat16, read through their strides, every gate on. Per program and
    call: its parameters bit for bit against ``params_for`` on the card;
    with every other op off and the dropout op on (Dropout, then
    CoarseDropout, per channel where drawn), its masks bit for bit against
    the twin on the card and on the CPU (the first ``CPU_TWIN_TASKS``
    tasks), in two orders; its output against the card twin in eleven
    orders (program 6: ``covered_orders``, the identity, the reverse and
    those that put each pointwise op after each moving op and after the
    load) and the CPU twin in the first two (float32 within
    ``TOL["pixel_ops"]``; bfloat16 within ``BF16_K6_ULPS`` of each element,
    differing on at most ``BF16_K6_SHARE`` of them, and within
    ``check_bf16``'s rule); timed in the identity or the fixed order, with
    the phase clock, and ``library_warp_ms`` of CropAndPad's (or
    geometric's) warp on [300, 3, 64, 64] as the library yardstick."""
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
        orders = ([None] if fixed else covered_orders(program, drawn, 11))
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
                if cpu:         # the first CPU_TWIN_TASKS tasks' images
                    n = CPU_TWIN_TASKS * s_
                    return kda.image_da_plain(
                        xc[:CPU_TWIN_TASKS], uu[:n].cpu(), keys[:n].cpu(),
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
                        g = got[:len(want)]
                        if not torch.equal(g.view(bits), want.view(bits)):
                            raise AssertionError(
                                f"image_da {program} ({kind}, order {o}): the "
                                f"mask differs from the twin's at "
                                f"{int((g != want).sum())} elements")
                dropped[kind] = float((got == 0).double().mean()
                                      - (xc == 0).double().mean())
            worst = {"card twin": 0.0, "CPU twin": 0.0}
            differ = dict(worst)
            for i, o in enumerate(orders):
                got = launch(u, o)
                # the CPU twin in the first two orders (as programs 1-3)
                for where in ("card twin", "CPU twin")[:2 if i < 2 else 1]:
                    cpu = where == "CPU twin"
                    g = got[:CPU_TWIN_TASKS].cpu() if cpu else got
                    want = twin(u, o, cpu)
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
            times["phase_us"] = da_phases(x, u, keys, on_card[o], dtype=f32,
                                          program=program)
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


@spent
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
    # kernel's per-tile partials in global memory are its own choice, not
    # the function's)
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


@spent
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
        at = {name: j for j, name in enumerate(favor.WIDE_PHASES)}
        row["phase1_mean"] = float((s[:, at["phase1_done"]]
                                    - s[:, at["start"]]).mean()) / 1e3
        row["phase2_mean"] = float((s[:, at["end"]]
                                    - s[:, at["barrier_passed"]]).mean()) / 1e3
        per_run.append(row)
    return {k: statistics.median(r[k] for r in per_run) for k in per_run[0]}


@spent
def check_image_da_distractor(gen, dtype=None):
    """K6's Distractor programs at D1's (and D3's) two DA calls: the context
    slice of a [20, 33, 128, 128, 1] uint8 batch (300 images) and its query
    slice (360), read through their strides, every gate on, into float32
    or (``dtype``, D5's) bfloat16. Per program and call: its parameters bit
    for bit against ``params_for`` on the card; with Affine off and the
    dropout op on (Dropout, then CoarseDropout), its masks on 1 - x / 255
    (in bfloat16 the twice-rounded 1 - bf16(x / 255)) bit for bit against
    the twin on the card and on the CPU (the first ``CPU_TWIN_TASKS``
    tasks), in each order; its output against both twins in each order
    (program 4: 2; float32 within
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
                if cpu:         # the first CPU_TWIN_TASKS tasks' images
                    n = CPU_TWIN_TASKS * x.shape[1]
                    return kda.image_da_plain(
                        xc[:CPU_TWIN_TASKS], uu[:n].cpu(), keys[:n].cpu(),
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
                        g = got[:len(want)]
                        if not torch.equal(g.view(bits), want.view(bits)):
                            raise AssertionError(
                                f"image_da {program} ({kind}, order {o}): the "
                                f"mask differs from the twin's at "
                                f"{int((g != want).sum())} elements")
                dropped[kind] = float((got == 0).double().mean()
                                      - (xc == 255).double().mean())
            worst = {"card twin": 0.0, "CPU twin": 0.0}
            for o in orders:
                got = launch(u, o)
                for where, want in (("card twin", twin(u, o)),
                                    ("CPU twin", twin(u, o, cpu=True))):
                    g = (got if where == "card twin"
                         else got[:CPU_TWIN_TASKS].cpu())
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


@spent
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
        evaluator = evaluation_cli.build_evaluator(config)
        val, test = evaluator.evaluate()
        wall = time.perf_counter() - t0
        sweeps = [sw for sw in evaluator.sweeps.values() if sw]
        got = graph_launches(sweeps, {
            "favor_attention": favor_attention.launches,
            "wide": favor_attention.wide_launches})
        got["wide"] += sum(sw.captured_launches.get("favor_attention", 0)
                           * max(sw.replays - 1, 0) for sw in sweeps)
        n = config.max_ctx_num
        for name in ("val_losses.txt", "test_losses.txt"):
            arr = np.loadtxt(os.path.join(config.save_path, name))
            if arr.shape != (n, 3) or not np.isfinite(arr).all() or list(
                    arr[:, 0]) != list(range(1, n + 1)):
                raise AssertionError(f"{name}: {arr.shape}, {arr}")
        attention = config.agg_mode == "attention"
        want = 2 * n * config.val_iters if attention else 0
        if (got["favor_attention"], got["wide"]) != (want, want):
            raise AssertionError(f"{tag} {config.method}: K2 launches on "
                                 f"the card {got}; the sweep says {want}")
        if attention:
            launches = got["favor_attention"]
        cpu_cfg = copy.copy(config)
        cpu_cfg.device = "cpu"
        cpu_eval = ModelEvaluator(build_model(cpu_cfg), cpu_cfg,
                                  build_data(cpu_cfg, mode="eval"))
        want_loss, _ = cpu_eval._validate_iter("validation", n)
        err = abs(val[n - 1] - want_loss)
        log(f"eval: {tag} {config.method} over {ckpt}, ctx 1..{n}, "
            f"{config.val_iters} episodes a point of {config.tasks_per_batch} "
            f"tasks x {cpu_eval.data.query_num} queries, validation and "
            f"test, in {wall} s (device sweeps: {len(sweeps)}, "
            f"{[sw.replays for sw in sweeps]} replays); K2 wide "
            f"launches on the card {got['wide']}; validation loss "
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
              "literature_stem_backward": "stem_bwd_kernel",
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
                   for k, name in GRAPH_NODE.items()},
                all_reduce=sum(bool(re.search(NCCL_KERNEL, n, re.I))
                               for n in kernels))


def launches_per_step(trainer):
    """What the code says each kernel launches: per training step, and per
    validation episode (both splits are swept)."""
    from wmfml_tpu_torch.models.registry import method_family
    from wmfml_tpu_torch.train.maml import remat_mode

    cfg = trainer.config
    da = {"image_da": 2} if "data_aug" in cfg.aug_list else {}
    family = method_family(cfg.method)
    if family == "mmaml":             # its convolutions all run on cuDNN
        return da, {}
    if family == "maml":
        # a rematerialised inner step runs its forward twice in training
        # (train/maml.py:rematerialised); evaluation never rematerialises
        remat = 2 if remat_mode(cfg) != "none" else 1
        inner, test = remat * cfg.num_steps + 1, cfg.test_num_steps + 1
        return ({"literature_stem": inner, "maml_features": inner, **da},
                {"literature_stem": test, "maml_features": test})
    attention = {"favor_attention": 1} if cfg.agg_mode == "attention" else {}
    if cfg.task in ("distractor", "shapenet_3d"):   # LargeCNP: cuDNN trunk
        return {**attention, **da}, attention
    # a BBB encoder (MR) samples apart for the query and the context pass
    stem = {"literature_stem": 2 if "MR" in cfg.method else 1}
    # conv_bwd: phase: K1b once a training step (the backward), never in
    # evaluation
    k1b = ({"literature_stem_backward": 1}
           if getattr(trainer.model.encoder_w0, "conv_bwd", "") == "phase"
           else {})
    return {**stem, **k1b, **attention, **da}, {**stem, **attention}


def graph_launches(graphs, issued):
    """Launches on the card from those the host issued (the counters) and
    the CUDA graphs (``FusedSteps``, ``DeviceSweep``) of the run: each
    captured launch was issued once and ran once per replay."""
    out = dict(issued)
    for g in graphs:
        for k in out:
            out[k] += g.captured_launches.get(k, 0) * max(g.replays - 1, 0)
    return out


def card_launches(trainer, issued):
    """A trainer's launches on the card: its fused step's graph and its
    validation sweeps' (``trainer.device_eval``)."""
    return graph_launches([trainer.train_step, *(trainer.device_eval or {})
                           .values()], issued)


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


# the sets of captured kernels whose replay ``train_phase`` has traced
TRACED = set()


@spent
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
        names = [name for name, _, _ in device_events(prof)]
        got = {k: sum(GRAPH_NODE[k] in n for n in names) for k in want}
        TRACES["taken"] += 1
        log(f"train {tag}: one replay's trace: {len(names)} device events, "
            f"{got} of the captured {want} (attempt {attempt + 1} of 3)")
        if all(0 < got[k] <= want[k] for k in want):
            return got
        TRACES["empty" if not names else "short"] += 1
    raise AssertionError(f"{tag}: no trace of a replay showed every kernel "
                         f"of the capture {want}")


@spent
def train_phase(card, yaml, overrides, counters, tap=None):
    """Drive one path through ``train_cli``'s trainer, which trains through
    CUDA graph replays (``FusedSteps``), every kernel counter zeroed just
    before; return (trainer, launches per kernel of ``counters`` on the
    card in that run, the graph's nodes). In ``compute_dtype: bfloat16`` every
    launch must have been a bfloat16 one, and every K6 launch one of the
    path's program (its task's, ``_fixed`` for ``aug_random_order:
    false``). The captured graph's DOT must hold as many nodes of each
    kernel as the capture issued, and, on the first path of its set of
    captured kernels (``TRACED``), a trace of one more replay must show
    them. With ``tap`` (``tap_sample``: an MR path's BBB encoder's first
    layer; ``tap_da``: K6's output) a tensor the graph draws anew is tapped
    before the capture, and two more replays must draw it differently
    (``check_replays_draw_anew``)."""
    import tempfile

    import torch

    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config

    config = Config(yaml, overrides)
    if config.mesh_shape:           # phase 25: on the process group's mesh
        from wmfml_tpu_torch.cli.common import start_mesh
        start_mesh(config)
    zero_counters()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_cli.build_trainer(config)
    fused = trainer.train_step
    seen = tap(trainer) if tap else None
    with tempfile.TemporaryDirectory() as tmp:
        fused.dot_path = os.path.join(tmp, "step.dot")
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        issued = {name: fn.launches for name, fn in counters.items()}
        nodes = graph_nodes(fused.dot_path)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer.peak_bytes = torch.cuda.max_memory_allocated() - base
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
        f"{peak_gib} GiB ({trainer.peak_bytes / 2 ** 30} GiB above the "
        f"phase's start)")
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
    # a replay's trace for the first path of each set of kernels the run
    # captures (a depth cut: later paths of the same set skip it)
    captured = frozenset(k for k, n in fused.captured_launches.items() if n)
    if captured not in TRACED:
        TRACED.add(captured)
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
    replay writes anew. Every entry of a new sample differs."""
    layer = bbb_encoder(trainer.model).net.layer1.conv
    seen, sample = {}, layer.sample

    def tapped(noise, lead=()):
        out = sample(noise, lead)
        seen["w"] = out[0]
        return out

    layer.sample = tapped
    seen.update(what="samples of the BBB encoder's first layer", share=0.99,
                undo=lambda: delattr(layer, "sample"))
    return seen


def tap_da(trainer):
    """Keep the output of the last K6 launch of a step (the query images'
    DA), the graph's static tensor once captured. A new draw warps and
    drops out every object anew, but leaves most of the empty background
    as it was: at least 1% of the pixels must differ."""
    from wmfml_tpu_torch.aug import image_aug

    seen, launch = {}, image_aug.image_da

    def tapped(*args, **kwargs):
        seen["w"] = launch(*args, **kwargs)
        return seen["w"]

    image_aug.image_da = tapped
    seen.update(what="K6 outputs (a step's query images)", share=0.01,
                undo=lambda: setattr(image_aug, "image_da", launch))
    return seen


def check_replays_draw_anew(trainer, seen, tag):
    """Two more replays of the captured graph: the tapped tensor after each
    must differ in at least ``seen["share"]`` of its entries (the trainer's
    generator is registered with the graph, so each replay draws from where
    the last one left it); both finite."""
    import torch

    fused = trainer.train_step
    samples = []
    for _ in range(2):
        fused(trainer.generator)
        torch.cuda.synchronize()
        samples.append(seen["w"].clone())
    seen["undo"]()
    differ = (samples[0] != samples[1]).float().mean().item()
    log(f"train {tag}: two replays' {seen['what']} "
        f"{tuple(samples[0].shape)}: {differ} of the entries differ")
    if differ < seen["share"] or not all(bool(torch.isfinite(s).all())
                                         for s in samples):
        raise AssertionError(f"{tag}: two replays drew the same "
                             f"{seen['what']} ({differ} of the entries "
                             f"differ)")


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


def eval_step_for(method):
    """The eval-step factory of ``method``'s family
    (``models/registry.py:method_family``)."""
    from wmfml_tpu_torch.models.registry import method_family
    from wmfml_tpu_torch.train.maml import build_maml_eval_step
    from wmfml_tpu_torch.train.mmaml import build_mmaml_eval_step
    from wmfml_tpu_torch.train.steps import build_eval_step

    return {"mmaml": build_mmaml_eval_step, "maml": build_maml_eval_step,
            "np": build_eval_step}[method_family(method)]


@spent
def check_validation_loss(trainer, tasks=None, exact=False):
    """The trained model's validation loss on one episode (its first
    ``tasks`` tasks; MAML: after 20 inner steps; ShapeNet1D in degrees,
    Pascal1D's MSE of labels x 10): the card (kernels) against the CPU
    (plain twins), within VAL_TOL. With ``exact`` the loss is also taken in
    float64 (on the card, through the plain twins), and the card may
    instead come within GRAD_FACTOR times the CPU's own distance from it,
    as phase 8 holds the gradient: MAML's one-pass BN cancels in each of
    the 20 inner steps, and the card's distance from the CPU moves from run
    to run with cuDNN's default algorithms (0.0046 and 0.0225 degrees on
    two runs on an H100)."""
    import copy

    import torch

    from wmfml_tpu_torch.aug import pipeline
    from wmfml_tpu_torch.kernels import features, stem
    from wmfml_tpu_torch.models import maml as maml_model
    from wmfml_tpu_torch.nn import encoders
    from wmfml_tpu_torch.ops.cast import set_compute_dtype
    from wmfml_tpu_torch.train.trainer import episode_to_device

    cfg, data = trainer.config, trainer.data
    data.reset_eval("validation", seed=42)
    raw = data.get_batch("validation", cfg.tasks_per_batch, cfg.max_ctx_num)
    raw = {k: v[:tasks] for k, v in raw.items()}
    got = float(trainer.eval_step(episode_to_device(raw, "cuda")))
    t0 = time.perf_counter()
    cpu_step = eval_step_for(cfg.method)(copy.deepcopy(trainer.model).cpu(),
                                        cfg)
    want = float(cpu_step(episode_to_device(raw, "cpu")))
    cpu_s = time.perf_counter() - t0
    err, limit = abs(got - want), VAL_TOL * (abs(want) + 1.0)
    line = (f"output: {cfg.method} ({cfg.task}) validation loss on one "
            f"episode ({len(raw['ctx_x'])} tasks): card {got}, CPU {want} "
            f"({cpu_s:.1f} s); abs err {err} (tolerance {VAL_TOL} x |CPU| + "
            f"{VAL_TOL})")
    if exact:
        f64 = torch.float64
        model = set_compute_dtype(copy.deepcopy(trainer.model).to(f64), f64)
        saved = (encoders.literature_stem, maml_model.maml_features,
                 pipeline._to_float)
        encoders.literature_stem = lambda *a, **_: stem.stem_plain(*a)
        maml_model.maml_features = features.features_plain
        pipeline._to_float = lambda x, _=None: saved[2](x).to(f64)
        try:
            ref = float(eval_step_for(cfg.method)(model, cfg)(
                episode_to_device(raw, "cuda")))
        finally:
            (encoders.literature_stem, maml_model.maml_features,
             pipeline._to_float) = saved
        err, err_cpu = abs(got - ref), abs(want - ref)
        limit = max(VAL_TOL * (abs(ref) + 1.0), GRAD_FACTOR * err_cpu)
        line += (f"; float64 {ref}: card {err} from it, CPU {err_cpu} "
                 f"(limit max({VAL_TOL} x |float64| + {VAL_TOL}, "
                 f"{GRAD_FACTOR} x the CPU's) = {limit})")
    log(line)
    if not math.isfinite(got) or err > limit:
        raise AssertionError(f"{cfg.method} validation loss: card {got}, CPU "
                             f"{want}" + (f", float64 {ref}" if exact else ""))


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


@spent
def check_bf16_validation(trainer, tasks=None):
    """The bfloat16 model's validation loss on one episode (its first
    ``tasks`` tasks): the card (kernels, bfloat16) against the CPU (plain
    twins) in bfloat16, within the bfloat16 rule against the CPU's float32
    loss of the same weights: |card - CPU bf16| <= 2 |CPU bf16 - CPU f32|
    + 2^-7 |CPU f32|."""
    import copy

    from wmfml_tpu_torch.configs import torch_dtype
    from wmfml_tpu_torch.ops.cast import set_compute_dtype
    from wmfml_tpu_torch.train.trainer import episode_to_device

    cfg, data = trainer.config, trainer.data
    data.reset_eval("validation", seed=42)
    raw = data.get_batch("validation", cfg.tasks_per_batch, cfg.max_ctx_num)
    raw = {k: v[:tasks] for k, v in raw.items()}
    got = float(trainer.eval_step(episode_to_device(raw, "cuda")))
    build = eval_step_for(cfg.method)
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


@spent
def call_ms(trainer, calls, loop=False):
    """ms/step of ``calls`` calls of the trainer's fused step, graph replays
    or (``loop``) the same steps issued from the host: host clock over the
    calls, ending in a device sync, after one untimed call (none before
    replays of a graph that has been replayed)."""
    import torch

    fused = trainer.train_step
    fn = fused.loop if loop else fused
    if loop or not fused.replays:
        fn(trainer.generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(trainer.generator)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (calls * fused.k)


@spent
def dtype_turns(pairs, calls, profile=False):
    """ms/step and tasks/s of each (float32, bfloat16) trainer pair's graph
    replays, timed f32 then bf16 on the same card; with
    ``profile``, the card's busy share of one call of each."""
    out = {}
    for name, (f32, bf16) in pairs.items():
        runs = [call_ms(tr, calls) for tr in (f32, bf16)]
        row = out[name] = dict(f32_ms=runs[0], bf16_ms=runs[1], turns_ms=runs)
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
            f"bf16 / f32 {row['bf16_ms'] / row['f32_ms']} ({calls} calls of "
            f"{f32.train_step.k} and "
            f"{bf16.train_step.k} steps each){busy}")
    return out


@spent
def graph_equals_loop(yaml, overrides, calls=3):
    """Two trainers from one seed under deterministic algorithms: one takes
    ``calls`` fused calls (an eager warm-up, the capture and its replay,
    replays), the other the same steps issued from the host (``loop``).
    Every call's metrics, the weights, Adam's state and the generator's
    state must be equal bit for bit: the last call shows that a replay
    carries on from the one before (the generator's offset, the capturable
    optimizer's step, the static inputs written anew)."""
    import torch

    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        graph, loop = (train_cli.build_trainer(Config(yaml, overrides))
                       for _ in range(2))
        for i in range(calls):
            if graph.streamed:      # the same host batch into both
                for tr in (graph, loop):
                    tr.sampler.load(tr._put_train_batch(tr._sample_train()))
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
        f"the generator state, {differ} of them differ "
        f"({time.perf_counter() - t0:.1f} s)")
    if (differ or fused.replays < calls - fused.warm_calls
            or len(tensors[0]) != len(tensors[1])):
        raise AssertionError(f"{tag}: the graph path left {differ} tensors "
                             f"unlike the loop's")


@spent
def graph_loop_turns(trainers, calls, nodes, profile):
    """ms/step of graph replays against the same steps issued from the host
    (``loop``), timed graph, then loop, on each trained trainer (``calls``
    calls each, after an untimed one), beside the graph's size, its
    capture's and instantiation's host seconds and its pool's bytes; with
    ``profile``, the card's busy share of one call of each."""
    out = {}
    for tag, trainer in trainers.items():
        fused = trainer.train_step
        runs = [call_ms(trainer, calls[tag], loop=lp) for lp in (False, True)]
        row = dict(graph_ms=runs[0], loop_ms=runs[1], turns_ms=runs,
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
            f"{row['loop_ms'] / row['graph_ms']}x ({calls[tag]} calls of "
            f"{fused.k} steps each); "
            f"{json.dumps({k: v for k, v in row.items() if k not in ('turns_ms', 'graph_ms', 'loop_ms')})}")
        out[tag] = row
    return out


@spent
def determinism_turns(paths, calls):
    """ROADMAP.md C2: what ``torch.backends.cudnn.deterministic`` costs a
    graph replay. For each path (yaml, overrides), two fresh trainers: one
    runs its eager warm-up calls and captures its graph with the flag off,
    the other with it on (the algorithms are chosen then, and the graph
    keeps them); their replays are timed off, then on. The
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
            off, on = runs = [call_ms(trainers[det], calls[tag])
                              for det in (False, True)]
            out[tag] = dict(graph_ms=off, deterministic_ms=on,
                            cost=on / off - 1.0, turns_ms=runs)
            log(f"determinism {tag}: graph {off} ms/step with cuDNN's "
                f"default algorithms, {on} ms/step with "
                f"torch.backends.cudnn.deterministic ({calls[tag]} calls of "
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


def check_second_order_grad(trainer, batches=1 + SPREAD_BATCHES):
    """Full-width MAML training batches: the second-order outer gradient
    through K1 and K3 against plain autograd through the twins, which never
    enters a custom autograd Function (a backward that dropped its
    second-order terms would show here), in float32 and in float64. The
    first-order gradient says how large the second-order terms are.
    ``trainer`` is ``replay_maml``'s. The first batch is the replayed
    training's first one: drawn and augmented from a generator seeded with
    the config's seed, as the trainer draws its first step, so that no
    other phase's draws move it; it is held within GRAD_FACTOR times the
    twins' error (or GRAD_TOL). The ``batches`` - 1 more batches are held
    by their own rounding spread, which the twins alone set
    (``SPREAD_BATCHES``). Every batch's second-order part must stand above
    the kernels' error."""
    import torch

    seed = int(trainer.config.seed)
    for i in range(batches):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        state = gen.get_state()
        err, err_plain, _, second_share = second_order_errors(trainer, gen)
        kernels, twins = [err], [err_plain]
        for jitter in range(SPREAD_JITTERS if i else 0):
            gen.set_state(state)
            err_j, plain_j, _, _ = second_order_errors(trainer, gen, jitter)
            kernels.append(err_j)
            twins.append(plain_j)
        limit = max(GRAD_TOL, GRAD_FACTOR * max(twins))
        log(f"grad: batch {i} (seed {seed + i}): kernels {kernels}, twins "
            f"{twins} from float64 (the batch"
            + (", then its one-ulp copies" if i else "") + f"); kernels / "
            f"twins {err / err_plain}; limit {limit} (GRAD_FACTOR x the "
            f"twins' largest, or GRAD_TOL)")
        if not max(kernels) <= limit:
            raise AssertionError(f"second-order gradient through the kernels "
                                 f"is {kernels} from float64 on batch {i}, "
                                 f"the twins' {twins} (limit {limit})")
        if not second_share > 10 * err:
            raise AssertionError(f"second-order part {second_share} is not "
                                 f"above the error {err} on batch {i}: the "
                                 f"check is blind")


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


@spent
def second_order_errors(trainer, gen, jitter=None):
    """Phase 8's comparison on ``trainer``'s model and one batch: the
    kernels' and the twins' distance from float64, the kernels' from the
    twins (with ``jitter``: the shuffled twins' from float64,
    ``shuffled_twin``), and the second-order part of the gradient.
    ``jitter``, a seed, moves a random half of the augmented images'
    nonzero pixels one ulp (``grad_spread``, phase 8's added batches). A
    BBB encoder (MAMLMR) draws its samples once, from
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
            encoders.literature_stem = lambda *a, **_: stem.stem_plain(*a)
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


@spent
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
    kernels = [e for e in device_events(prof)
               if not e[0].startswith("Optimizer.")]
    busy_us, last_end = 0.0, float("-inf")       # union of kernel intervals
    for start, end in sorted(e[1:] for e in kernels):
        busy_us += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    log(f"profile {tag}: {steps} steps, {wall_us / steps} us/step wall, "
        f"device busy {busy_us / steps} us/step = {busy_us / wall_us} of the "
        f"wall time ({len(kernels) / steps} kernels/step)")
    by_name = {}
    for name, start, end in kernels:
        by_name[name] = by_name.get(name, 0.0) + end - start
    # K6 launches twice a step; its events' mean, as device_profile takes
    # it, since the profiler may drop some of them
    k6 = [end - start for name, start, end in kernels
          if "image_da_kernel" in name]
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
    from wmfml_tpu_torch.train.trainer import episode_to_device

    cfg, data = trainer.config, trainer.data
    data.reset_eval("validation", seed=42)
    raw = data.get_batch("validation", cfg.tasks_per_batch, cfg.max_ctx_num)
    rec = EpsFeed(generator=torch.Generator(device="cuda").manual_seed(
        int(cfg.seed)))
    got = float(trainer.eval_step(episode_to_device(raw, "cuda"), rec))
    cpu_step = eval_step_for(cfg.method)(copy.deepcopy(trainer.model).cpu(),
                                        cfg)
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
    evaluators = [evaluation_cli.build_evaluator(Config(EVAL_YAML, overrides))
                  for _ in range(2)]
    sweeps = [ev.evaluate() for ev in evaluators]
    wall = (time.perf_counter() - t0) / 2
    config = Config(EVAL_YAML, overrides, make_dirs=False)
    n, episodes = config.max_ctx_num, 2 * config.max_ctx_num * 2 * 2
    launches = graph_launches(
        [sw for ev in evaluators for sw in ev.sweeps.values() if sw],
        {"literature_stem": literature_stem.launches,
         "favor_attention": favor_attention.launches})
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
        check_second_order_grad(trainer, batches=1)
    finally:
        torch.use_deterministic_algorithms(False)


def mmaml_phase(card):
    """Phase 20: MMAMLShapeNet1D (``cfg/train/MMAML_ShapeNet1D_DA+TA.yaml``)
    through ``train_phase``: K6 program 0 twice a step, graph nodes
    included, and K1, K2 and K3 no time (every counter zeroed before and
    read after); two more replays draw new DA (``tap_da``); the validation
    loss on one episode (10 inner steps), card against CPU; the outer
    gradient against float64 (``check_mmaml_grad``); graph and loop ms/step
    with the card's busy share. Both CPU checks take the episode's first
    three tasks (each task's loss depends on its own rows only). Returns
    (trainer, launches, graph nodes)."""
    from wmfml_tpu_torch.kernels.image_da import image_da
    from wmfml_tpu_torch.train.steps import KERNELS

    trainer, launches, nodes = train_phase(
        card, MMAML_YAML, MMAML_OVERRIDES, {"image_da": image_da}, tap=tap_da)
    others = {n: fn.launches for n, fn in KERNELS.items() if n != "image_da"}
    log(f"train {trainer.config.method}: launches off the path {others}")
    if any(others.values()):
        raise AssertionError(f"{trainer.config.method}: launches {others} "
                             f"off the path")
    check_validation_loss(trainer, tasks=3)
    check_mmaml_grad(trainer)
    graph_loop_turns({"MMAMLShapeNet1D (P20)": trainer},
                     {"MMAMLShapeNet1D (P20)": 1},
                     {"MMAMLShapeNet1D (P20)": nodes}, profile=True)
    return trainer, launches, nodes


@spent
def check_remat_grad(trainer):
    """The trainer's ``maml_remat`` against ``none`` on the card: the
    second-order outer loss and every parameter's gradient of one seeded
    batch (drawn from the trainer's device sampler, augmented with one seed
    in both runs) on the trained weights, under deterministic algorithms:
    equal bit for bit (the recompute runs the same kernels on the same
    values). Returns the largest absolute difference (0.0)."""
    import copy

    import torch

    from wmfml_tpu_torch.models.registry import method_family
    from wmfml_tpu_torch.train.maml import build_maml_outer
    from wmfml_tpu_torch.train.mmaml import build_mmaml_outer

    cfg, model = trainer.config, trainer.model
    seed = int(cfg.seed)
    batch = trainer.sampler.sample(
        cfg.tasks_per_batch, torch.Generator(device="cuda").manual_seed(seed))
    build = (build_mmaml_outer if method_family(cfg.method) == "mmaml"
             else build_maml_outer)
    params = list(model.parameters())
    out = {}
    model.train()
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("none", cfg.maml_remat):
            c = copy.copy(cfg)
            c.maml_remat = mode
            loss = build(model, c, int(c.num_steps), train=True, test=False)(
                batch, torch.Generator(device="cuda").manual_seed(seed + 1))
            loss = loss[0] if isinstance(loss, tuple) else loss
            out[mode] = [loss.detach()] + list(torch.autograd.grad(
                loss, params))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    want, got = out["none"], out[cfg.maml_remat]
    diff = max((a - b).abs().max().item() for a, b in zip(got, want))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"remat: {cfg.method} maml_remat={cfg.maml_remat} against none, one "
        f"seeded batch ({cfg.num_steps} second-order inner steps, "
        f"deterministic algorithms): loss {got[0].item()} and "
        f"{len(params)} gradients {'equal bit for bit' if equal else 'differ'}"
        f" (max abs difference {diff}); {time.perf_counter() - t0:.1f} s")
    if not equal:
        raise AssertionError(f"{cfg.method} maml_remat={cfg.maml_remat}: "
                             f"gradient differs from none's by {diff}")
    return diff


@spent
def remat_phase(card, paths):
    """Phase 22 (A19): for each path (``family: (yaml, overrides, kernel
    counters, the trained none trainer, its graph nodes)``), ``maml_remat``
    step and dots through ``train_phase`` (launches as the code says: K1
    and K3 twice an inner step in training; graph nodes; a replay's
    trace), the remat gradient against none's (``check_remat_grad``), then
    graph ms/step of none, step and dots in one round (none, step, dots; a
    depth cut), each one's busy share, pool bytes, peak allocated memory
    above its phase's start, capture and instantiation seconds and graph
    nodes. Returns {path tag: launches}."""
    import torch

    launches = {}
    for family, (yaml, overrides, counters, none, none_nodes) in paths.items():
        trainers, nodes = {"none": none}, {"none": none_nodes}
        for mode in ("step", "dots"):
            tr, got, nodes[mode] = train_phase(
                card, yaml, overrides + [f"maml_remat={mode}"], counters)
            check_remat_grad(tr)
            trainers[mode] = tr
            launches[f"{family} remat {mode}"] = got
        ms = {m: [call_ms(tr, 1)] for m, tr in trainers.items()}
        rows = {}
        for m, tr in trainers.items():
            fused = tr.train_step
            busy = profile_calls(tr, f"{family} remat {m}")["busy_share"]
            step_ms = sum(ms[m]) / len(ms[m])
            rows[m] = dict(ms_step=step_ms, turns_ms=ms[m], busy_share=busy,
                           pool_bytes=fused.graph_stats["pool_bytes"],
                           peak_bytes=tr.peak_bytes,
                           capture_s=fused.graph_stats["capture_s"],
                           instantiate_s=fused.graph_stats["instantiate_s"],
                           nodes=nodes[m]["nodes"],
                           kernel_nodes=nodes[m]["kernel_nodes"])
            log(f"remat: {family} maml_remat={m} on {card}: graph {step_ms} "
                f"ms/step ({tr.config.tasks_per_batch * 1e3 / step_ms} "
                f"tasks/s; turns {ms[m]}), busy {busy}; pool "
                f"{rows[m]['pool_bytes'] / 2 ** 30} GiB, peak allocated "
                f"{rows[m]['peak_bytes'] / 2 ** 30} GiB above the phase's "
                f"start; capture {rows[m]['capture_s']} s, instantiate "
                f"{rows[m]['instantiate_s']} s; {rows[m]['nodes']} graph "
                f"nodes ({rows[m]['kernel_nodes']} kernel nodes, "
                f"{fused.k} steps)")
        log(f"remat: {family}: " + json.dumps(rows))
        del trainers, tr
        gc.collect()
        torch.cuda.empty_cache()
    return launches


@spent
def mmaml_bf16_phase(card, f32trainer, f32nodes):
    """Phase 23 (A27): ``cfg/train/MMAML_ShapeNet1D_DA+TA.yaml`` with
    ``compute_dtype=bfloat16`` through ``train_phase`` (8 steps, 4 a call;
    every K6 launch a bfloat16 one of program 0, K1-K3 no time); its
    validation loss on one episode, card against CPU, within the bfloat16
    rule (``check_bf16_validation``; phase 20 holds float32's); the outer
    loss and both nets' second-order gradients in bfloat16 against float64
    (``check_mmaml_grad_bf16``); graph ms/step of float32 (phase 20's
    trainer) and bfloat16 in turns with their busy shares, pool bytes and
    graph nodes. Returns (trainer, launches)."""
    from wmfml_tpu_torch.kernels.image_da import image_da
    from wmfml_tpu_torch.train.steps import KERNELS

    trainer, launches, nodes = train_phase(card, MMAML_YAML,
                                           MMAML_OVERRIDES + BF16,
                                           {"image_da": image_da})
    others = {n: fn.launches for n, fn in KERNELS.items() if n != "image_da"}
    if any(others.values()):
        raise AssertionError(f"MMAML bf16: launches {others} off the path")
    check_bf16_validation(trainer, tasks=3)
    check_mmaml_grad_bf16(trainer)
    turns = dtype_turns({"MMAMLShapeNet1D (P20, P23)": (f32trainer, trainer)},
                        calls=1, profile=True)
    for tag, tr, n in (("float32", f32trainer, f32nodes),
                       ("bfloat16", trainer, nodes)):
        log(f"turns: MMAMLShapeNet1D {tag}: pool "
            f"{tr.train_step.graph_stats['pool_bytes'] / 2 ** 30} GiB, "
            f"{n['nodes']} graph nodes ({n['kernel_nodes']} kernel nodes, "
            f"{tr.train_step.k} steps), capture {tr.train_step.graph_stats}")
    log("turns: MMAMLShapeNet1D f32 / bf16: " + json.dumps(turns))
    return trainer, launches


def mmaml_grad_inputs(trainer, tasks):
    """The inputs of phase 20's and 23's gradient checks: (the config
    without DA, the card, the first ``tasks`` tasks of one full-width
    training batch drawn and augmented through K6 from a generator seeded
    with the config's seed, the TA offsets drawn once and fed to every
    run, the bundle as the config's seed builds it). A task's loss and its
    gradient's share depend on its own rows only, so fewer tasks cut the
    CPU's time, not the check."""
    import copy

    import torch

    from wmfml_tpu_torch.aug import pipeline
    from wmfml_tpu_torch.models.registry import build_model

    cfg, card = copy.copy(trainer.config), trainer.device
    gen = torch.Generator(device=card).manual_seed(int(cfg.seed))
    batch = trainer.sampler.sample(cfg.tasks_per_batch, gen)
    augment = pipeline.build_episode_processor(cfg.task, cfg.aug_list,
                                               train=True).augment
    batch = dict(batch, **{k: augment(batch[k], gen)
                           for k in ("ctx_x", "qry_x")})
    ta_idx = torch.randint(0, 15, (cfg.tasks_per_batch,), generator=gen,
                           device=card)[:tasks]
    batch = {k: v[:tasks] for k, v in batch.items()}
    cfg.aug_list = [a for a in cfg.aug_list if a != "data_aug"]
    return cfg, card, batch, ta_idx, build_model(cfg)


def mmaml_grads(cfg, fresh, batch, ta_idx, device, dtype, first_order=False):
    """The outer loss and both networks' second-order gradients (float64,
    on the CPU, by name) of a copy of ``fresh`` computing in ``dtype`` on
    ``device``, the episode's images cast to ``dtype``."""
    import copy

    import torch

    from wmfml_tpu_torch.aug import pipeline
    from wmfml_tpu_torch.ops.cast import set_compute_dtype
    from wmfml_tpu_torch.train.mmaml import build_mmaml_outer

    c = copy.copy(cfg)
    c.first_order = first_order
    model = copy.deepcopy(fresh).to(device)
    if dtype != torch.bfloat16:     # bfloat16 keeps float32 parameters
        model = model.to(dtype)
    set_compute_dtype(model, dtype)
    saved = pipeline._to_float
    pipeline._to_float = lambda x, _=None: saved(x).to(dtype)
    try:
        outer = build_mmaml_outer(model, c, int(c.num_steps), train=True,
                                  test=False)
        loss = outer({k: v.to(device) for k, v in batch.items()},
                     ta_idx=ta_idx.to(device))
        names, params = zip(*model.named_parameters())
        g = torch.autograd.grad(loss, params)
    finally:
        pipeline._to_float = saved
    return loss.item(), {n: v.double().cpu() for n, v in zip(names, g)}


# a conv bias that feeds a batch norm has true gradient 0 (BN removes any
# per-channel shift): the MMAML checks hold it against its network's
# largest entry
MMAML_NETS = {"model": "model.", "embedding_model": "embedding_model."}


def shift_free(name):
    return name.endswith(".bias") and ("_conv." in name or ".conv.conv" in name)


@spent
def check_mmaml_grad(trainer, tasks=3):
    """Phase 20's gradient check, as phase 8's: the outer loss and both
    networks' second-order outer gradients of ``mmaml_grad_inputs``' batch
    under deterministic algorithms on the card, in float32 on the CPU and
    in float64 on the CPU. Each network's largest relative error on the
    card must come within GRAD_TOL of float64, or within GRAD_FACTOR times
    the float32 CPU's: the one-pass BN of every inner step (E[x^2] -
    E[x]^2) cancels, as MAML's does. The second-order part (the card's
    first-order gradient against float64) must be well above the error, or
    the check is blind."""
    import torch

    cfg, card, batch, ta_idx, fresh = mmaml_grad_inputs(trainer, tasks)

    def grads(device, dtype, first_order=False):
        return mmaml_grads(cfg, fresh, batch, ta_idx, device, dtype,
                           first_order)

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        card_loss, on_card = grads(card, torch.float32)
        _, first = grads(card, torch.float32, first_order=True)
    finally:
        torch.use_deterministic_algorithms(False)
    t1 = time.perf_counter()
    cpu_loss, cpu = grads("cpu", torch.float32)
    exact_loss, exact = grads("cpu", torch.float64)
    t2 = time.perf_counter()

    scale = {net: max(g.abs().max().item() for n, g in exact.items()
                      if n.startswith(p)) for net, p in MMAML_NETS.items()}

    def worst(a, b, net):
        errs = []
        for n in exact:
            if not n.startswith(MMAML_NETS[net]):
                continue
            den = scale[net] if shift_free(n) else b[n].abs().max().item()
            errs.append(((a[n] - b[n]).abs().max().item() / den, n))
        errs.sort(reverse=True)
        return errs[0][0], errs[:3]

    rel_loss = {k: abs(v - exact_loss) / abs(exact_loss)
                for k, v in (("card", card_loss), ("cpu", cpu_loss))}
    log(f"grad: MMAML, {tasks} of the batch's {cfg.tasks_per_batch} tasks, "
        f"shots {batch['ctx_mask'].sum(1).tolist()}: outer loss card "
        f"{card_loss}, CPU float32 {cpu_loss}, "
        f"float64 {exact_loss} (rel err {rel_loss}); card {t1 - t0} s, CPU "
        f"float32 + float64 {t2 - t1} s")
    if not rel_loss["card"] <= max(GRAD_TOL, GRAD_FACTOR * rel_loss["cpu"]):
        raise AssertionError(f"MMAML outer loss: card {card_loss}, float64 "
                             f"{exact_loss}, CPU float32 {cpu_loss}")
    for net in MMAML_NETS:
        err, top = worst(on_card, exact, net)
        err_cpu, top_cpu = worst(cpu, exact, net)
        second, _ = worst(exact, first, net)
        log(f"grad: MMAML {net}: second-order outer gradient, max rel err "
            f"against float64: card {err} ({top}), CPU float32 {err_cpu} "
            f"({top_cpu}); second-order part {second}")
        if not err <= max(GRAD_TOL, GRAD_FACTOR * err_cpu):
            raise AssertionError(f"MMAML {net}: the card's gradient is {err} "
                                 f"from float64, the CPU's {err_cpu}")
        if not second > 10 * err:
            raise AssertionError(f"MMAML {net}: second-order part {second} "
                                 f"is not above the error {err}: the check "
                                 f"is blind")


@spent
def check_mmaml_grad_bf16(trainer, tasks=2):
    """Phase 23's gradient check: the bfloat16 MMAML's outer loss and both
    networks' second-order gradients of ``mmaml_grad_inputs``' batch (its
    first ``tasks`` tasks) under deterministic algorithms on the card in
    bfloat16, against float64 on the CPU within the bfloat16 rule, the
    CPU's bfloat16 run setting bfloat16's own effect: per tensor, max
    |card - float64| <= 2 max |CPU bf16 - float64| + 2^-7 max |float64|
    (a BN-fed conv bias: 2^-7 of its network's largest entry), and the
    loss likewise. Parameters and gradients stay float32 (``ops/cast.py``);
    the images and every layer compute in bfloat16."""
    import torch

    cfg, card, batch, ta_idx, fresh = mmaml_grad_inputs(trainer, tasks)
    bf = torch.bfloat16
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        card_loss, on_card = mmaml_grads(cfg, fresh, batch, ta_idx, card, bf)
    finally:
        torch.use_deterministic_algorithms(False)
    t1 = time.perf_counter()
    cpu_loss, cpu = mmaml_grads(cfg, fresh, batch, ta_idx, "cpu", bf)
    exact_loss, exact = mmaml_grads(cfg, fresh, batch, ta_idx, "cpu",
                                    torch.float64)
    t2 = time.perf_counter()
    scale = {net: max(g.abs().max().item() for n, g in exact.items()
                      if n.startswith(p)) for net, p in MMAML_NETS.items()}
    limit = 2 * abs(cpu_loss - exact_loss) + 2.0 ** -7 * abs(exact_loss)
    log(f"grad: MMAML bf16, {tasks} of the batch's {cfg.tasks_per_batch} "
        f"tasks: outer loss card {card_loss}, CPU bfloat16 {cpu_loss}, "
        f"float64 {exact_loss}; |card - float64| "
        f"{abs(card_loss - exact_loss)} (limit {limit}); card {t1 - t0} s, "
        f"CPU bfloat16 + float64 {t2 - t1} s")
    if not abs(card_loss - exact_loss) <= limit:
        raise AssertionError(f"MMAML bf16 outer loss: card {card_loss}, "
                             f"CPU bf16 {cpu_loss}, float64 {exact_loss}")
    for net, prefix in MMAML_NETS.items():
        ratios = []
        for n, want in exact.items():
            if not n.startswith(prefix):
                continue
            floor = 2.0 ** -7 * (scale[net] if shift_free(n)
                                 else want.abs().max().item())
            bound = 2 * (cpu[n] - want).abs().max().item() + floor
            err = (on_card[n] - want).abs().max().item()
            ratios.append((err / bound, n, err, bound))
        ratios.sort(reverse=True)
        log(f"grad: MMAML bf16 {net}: second-order outer gradient against "
            f"float64, the worst |card - float64| / limit: {ratios[:3]}")
        if ratios[0][0] > 1.0:
            raise AssertionError(f"MMAML bf16 {net}: {ratios[0][1]} lies "
                                 f"{ratios[0][2]} from float64, limit "
                                 f"{ratios[0][3]}")


def zero_counters():
    """Every kernel wrapper's counters to 0 (``train/steps.py:KERNELS``)."""
    from wmfml_tpu_torch.train.steps import KERNELS

    for fn in KERNELS.values():
        fn.launches = fn.bf16_launches = 0
        if hasattr(fn, "wide_launches"):
            fn.wide_launches = 0
        if hasattr(fn, "program_launches"):
            fn.program_launches = dict.fromkeys(fn.program_launches, 0)


def read_counters():
    """Every kernel wrapper's host-issued launches, K2's wide ones as
    ``favor_attention.wide`` and K6's by program as ``image_da.<program>``
    (those of a run issued from the host: nothing here is captured)."""
    from wmfml_tpu_torch.kernels.favor import favor_attention
    from wmfml_tpu_torch.kernels.image_da import image_da
    from wmfml_tpu_torch.train.steps import KERNELS

    out = {name: fn.launches for name, fn in KERNELS.items()}
    out["favor_attention.wide"] = favor_attention.wide_launches
    out.update({f"image_da.{p}": n
                for p, n in image_da.program_launches.items() if n})
    return out


def check_counters(tag, got, want):
    """``got`` (``read_counters``) holds ``want``'s counts and nothing else
    but zeros."""
    extra = {k: n for k, n in got.items() if n and k not in want}
    if extra or any(got.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"{tag}: launches {got}; the code says {want} "
                             f"and no other")
    log(f"{tag}: launches {dict((k, got.get(k, 0)) for k in want)} as the "
        f"code says, no other kernel launched")


def images_of(x):
    """Images in a [..., H, W, C] batch (a tensor or an array)."""
    return math.prod(x.shape[:-3])


def single_task_phase(card, yaml, overrides, counters):
    """A SingleTask path through ``train_phase`` (which zeroes every kernel
    counter first): the kernels it does not name launch no time (T1 no K2, T2
    and T3 neither K1 nor K2); the validation loss on one episode, card
    against CPU; and on that episode the image encoder (K1's literature
    encoder, or both ResNet trunks) reads the query images alone, T x Q."""
    from wmfml_tpu_torch.train.steps import KERNELS
    from wmfml_tpu_torch.train.trainer import episode_to_device

    trainer, launches, nodes = train_phase(card, yaml, overrides, counters)
    others = {n: fn.launches for n, fn in KERNELS.items() if n not in counters}
    if any(others.values()):
        raise AssertionError(f"{trainer.config.method}: launches {others} "
                             f"off the path")
    check_validation_loss(trainer)
    cfg, model = trainer.config, trainer.model
    encoders = ([model.encoder_w0] if hasattr(model, "encoder_w0")
                else [model.img_encoder, model.decoder])
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append(images_of(args[0]))) for m in encoders]
    try:
        trainer.data.reset_eval("validation", seed=42)
        raw = trainer.data.get_batch("validation", cfg.tasks_per_batch,
                                     cfg.max_ctx_num)
        trainer.eval_step(episode_to_device(raw, "cuda"))
    finally:
        for h in hooks:
            h.remove()
    want = [images_of(raw["qry_x"])] * len(encoders)
    log(f"train {cfg.method}: the encoder passes of one validation episode "
        f"read {seen} images, its queries {want} ({raw['ctx_x'].shape[1]} "
        f"context rows ignored)")
    if seen != want:
        raise AssertionError(f"{cfg.method}: encoders read {seen} images, "
                             f"the queries are {want}")
    return trainer, launches, nodes


def fresh_refinement(config, base, ctx_num):
    """A new evaluator of ``ctx_num``'s frozen task over
    ``config.checkpoint``, as ``refinement_cli`` builds one (its model built
    from the seed and restored, its optimizer built and restored)."""
    from wmfml_tpu_torch.data.refinement import RefinementSampler
    from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
    from wmfml_tpu_torch.models.registry import build_model

    data = RefinementSampler(base, ctx_num=ctx_num, seed=42, source="test")
    config.query_num = data.task_qry_x.shape[0]
    return ModelEvaluator(build_model(config), config, data)


def check_refinement(tag, yaml, trainer, program, counts):
    """R1 / R2: ``refinement_cli`` with ``yaml`` (``max_ctx_num`` 25 as
    shipped, all 25 counts; iterations 2, ``val_freq`` 2, ``val_iters`` 2)
    over ``trainer``'s final checkpoint. ``loss_vs_ctx.txt`` holds 25 finite
    rows, the best test losses returned; each count ran 3 eager refine
    steps (K6 twice each, program ``program``; ShapeNet1D's K1 once) and 2
    validation and 2 test sweeps of 2 episodes (K1 once each), and nothing
    else launched. Each count of ``counts`` started from the checkpoint:
    its iteration-0 training loss (``metrics.jsonl``) equals the first
    refine step of a fresh evaluator of that count on the card. Then the
    host ms of an iteration at count 25 (batch, copy, step; synchronised)
    and the step's device ms (torch.profiler). Returns the launches."""
    import numpy as np
    import torch

    from wmfml_tpu_torch.cli import refinement_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data.factory import build_data
    from wmfml_tpu_torch.train.trainer import episode_to_device

    ckpt = trainer.ckpt.path(f"model_end_{trainer.config.iterations}")
    config = Config(yaml, REFINE_OVERRIDES + [f"checkpoint={ckpt}"])
    zero_counters()
    t0 = time.perf_counter()
    best = refinement_cli.refine(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    n, its = config.max_ctx_num, config.iterations + 1
    sweeps = sum(1 for it in range(its) if it % config.val_freq == 0)
    episodes = 2 * sweeps * config.val_iters
    want = {"image_da": 2 * n * its, f"image_da.{program}": 2 * n * its}
    if config.task == "shapenet_1d":
        want["literature_stem"] = n * (its + episodes)
    check_counters(f"refine {tag} {config.method}", launches, want)
    table = np.loadtxt(os.path.join(config.save_path, "loss_vs_ctx.txt"))
    if table.shape != (n,) or not np.isfinite(table).all() or np.abs(
            table - np.asarray(best)).max() > 1e-4 * (1 + np.abs(table).max()):
        raise AssertionError(f"{tag} loss_vs_ctx.txt {table}, best {best}")
    with open(os.path.join(config.save_path, "metrics.jsonl")) as f:
        first = [json.loads(line) for line in f]
    first = [r["value"] for r in first
             if r["tag"] == "Loss/train" and r["step"] == 0]
    if len(first) != n:
        raise AssertionError(f"{tag}: {len(first)} iteration-0 losses")
    base = build_data(config, mode="eval")
    diffs, ev = {}, None
    for c in counts:
        ev = fresh_refinement(config, base, c)
        batch = episode_to_device(ev.data.get_batch(
            "refine_train", config.tasks_per_batch, n), "cuda")
        got = float(ev.refine_step(batch, ev.refine_generator))
        diffs[c] = got - first[c - 1]
        if abs(diffs[c]) > 1e-6 * (abs(got) + 1.0):
            raise AssertionError(f"{tag} count {c}: iteration-0 loss "
                                 f"{first[c - 1]} in the run, {got} from a "
                                 f"fresh evaluator")
    # one iteration at count n (``ev`` is count n's)
    gen = ev.refine_generator

    def iteration():
        return ev.refine_step(episode_to_device(ev.data.get_batch(
            "refine_train", config.tasks_per_batch, n), "cuda"), gen)

    batch = episode_to_device(ev.data.get_batch(
        "refine_train", config.tasks_per_batch, n), "cuda")
    iteration()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(20):
        iteration()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t1) / 20
    dev = device_profile(lambda: ev.refine_step(batch, gen), iters=10)
    log(f"refine {tag} {config.method} over {ckpt}: counts 1..{n}, "
        f"{its} eager refine steps and {sweeps} validation and test sweeps "
        f"of {config.val_iters} episodes each, in {wall} s on {card_line()}; "
        f"best test loss by count {best}; iteration-0 loss, run against a "
        f"fresh evaluator, at counts {list(counts)}: differences {diffs}; "
        f"an iteration at count {n} (1 task x {n} images; batch, copy, step) "
        f"{host_ms} ms host-timed, its step {dev['device_ms']} ms on the "
        f"device in {dev['kernels_per_call']} kernels")
    return launches


def check_one_task(tag, yaml, trainer, cpu_check=True):
    """O1 / O2: ``eval_one_task_cli`` with ``yaml`` (``val_iters`` 2) over
    ``trainer``'s final checkpoint: ``test_losses.txt`` 25 x 3, finite,
    flat (the frozen batch at every point, as in the JAX package) with std
    0; K1 (ShapeNet1D) and K2 (attention) once an episode, K2's narrow form
    at one task, no K6; the last point against the same sweep on the
    CPU."""
    import copy

    import numpy as np
    import torch

    from wmfml_tpu_torch.cli import eval_one_task_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data.factory import build_data
    from wmfml_tpu_torch.data.refinement import RefinementSampler
    from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
    from wmfml_tpu_torch.models.registry import build_model

    ckpt = trainer.ckpt.path(f"model_end_{trainer.config.iterations}")
    config = Config(yaml, ONE_PLOT_OVERRIDES + [f"checkpoint={ckpt}"])
    zero_counters()
    t0 = time.perf_counter()
    losses = eval_one_task_cli.evaluate(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = config.max_ctx_num
    episodes = n * config.val_iters
    want = {}
    if config.task == "shapenet_1d":
        want["literature_stem"] = episodes
    if config.agg_mode == "attention":
        want["favor_attention"] = episodes
    launches = read_counters()
    check_counters(f"eval_one_task {tag} {config.method}", launches, want)
    table = np.loadtxt(os.path.join(config.save_path, "test_losses.txt"))
    if (table.shape != (n, 3) or not np.isfinite(table).all()
            or list(table[:, 0]) != list(range(1, n + 1))
            or table[:, 2].any() or max(losses) - min(losses)
            > 1e-6 * (abs(losses[0]) + 1.0)):
        raise AssertionError(f"{tag} test_losses.txt {table}")
    err = want_loss = None
    if cpu_check:
        cpu_cfg = copy.copy(config)
        cpu_cfg.device = "cpu"
        data = RefinementSampler(build_data(cpu_cfg, mode="eval"),
                                 ctx_num=n, seed=42, source="test")
        want_loss, _ = ModelEvaluator(build_model(cpu_cfg), cpu_cfg,
                                      data)._validate_iter("test", n)
        err = abs(losses[-1] - want_loss)
        if err > VAL_TOL * (abs(want_loss) + 1.0):
            raise AssertionError(f"{tag}: card {losses[-1]}, CPU {want_loss}")
    log(f"eval_one_task {tag} {config.method} over {ckpt}: ctx 1..{n}, "
        f"{config.val_iters} episodes a point of 1 task x "
        f"{config.query_num} queries, in {wall} s; test loss (flat) "
        f"{losses[0]}; at ctx {n}: card {losses[-1]}, CPU {want_loss}, abs "
        f"err {err}")
    return launches


def check_plot(tag, yaml, trainer):
    """Q1-Q3: ``eval_and_plot_cli`` with ``yaml`` (``val_iters`` 2) over
    ``trainer``'s final checkpoint: ``losses_all.txt`` 2 finite rows, the
    losses returned; K1 (ShapeNet1D) and K2 (attention; wide on
    LargeCNP) once an episode, no K6; the plots written where matplotlib
    is installed, none where it is not; Distractor's test split cut to
    category 04530566; the first episode against the same function on the
    CPU."""
    import copy

    import numpy as np
    import torch

    from wmfml_tpu_torch.cli import eval_and_plot_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.eval import plotting

    ckpt = trainer.ckpt.path(f"model_end_{trainer.config.iterations}")
    config = Config(yaml, ONE_PLOT_OVERRIDES + [f"checkpoint={ckpt}"])
    seen = {}
    real = plotting.build_data

    def recorded(cfg, mode="train", test_categ=None):
        data = real(cfg, mode=mode, test_categ=test_categ)
        seen.update(mode=mode, test_categ=test_categ,
                    query_num=data.query_num)
        if cfg.task == "distractor":
            seen["test_items"] = data.splits["test"]["n_items"]
        return data

    plotting.build_data = recorded
    try:
        zero_counters()
        t0 = time.perf_counter()
        losses = eval_and_plot_cli.evaluate(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        cpu_cfg = copy.copy(config)
        cpu_cfg.device, cpu_cfg.val_iters = "cpu", 1
        cpu_cfg.save_path = config.save_path + "_cpu"
        os.makedirs(cpu_cfg.save_path)
        want_loss = plotting.evaluate_and_plot(
            cpu_cfg, ctx_num=min(15, config.max_ctx_num))[0]
    finally:
        plotting.build_data = real
    want = {}
    if config.task == "shapenet_1d":
        want["literature_stem"] = config.val_iters
    if config.agg_mode == "attention":
        want["favor_attention"] = config.val_iters
        if config.task != "shapenet_1d":
            want["favor_attention.wide"] = config.val_iters
    check_counters(f"eval_and_plot {tag} {config.method}", launches, want)
    table = np.atleast_1d(np.loadtxt(os.path.join(config.save_path,
                                                  "losses_all.txt")))
    if table.shape != (config.val_iters,) or not np.isfinite(table).all():
        raise AssertionError(f"{tag} losses_all.txt {table}")
    plot_dir = os.path.join(config.save_path, "plots")
    plots = len(os.listdir(plot_dir)) if os.path.isdir(plot_dir) else 0
    try:
        import matplotlib  # noqa: F401
        want_plots = config.val_iters
    except ImportError:
        want_plots = 0
    if plots != want_plots:
        raise AssertionError(f"{tag}: {plots} plots written, {want_plots} "
                             f"expected")
    if config.task == "distractor" and seen.get("test_categ") != ["04530566"]:
        raise AssertionError(f"{tag}: test split {seen}")
    err = abs(losses[0] - want_loss)
    log(f"eval_and_plot {tag} {config.method} over {ckpt}: "
        f"{config.val_iters} test episodes of {config.tasks_per_batch} tasks "
        f"x {seen['query_num']} queries at ctx {min(15, config.max_ctx_num)}"
        f" ({seen}), in {wall} s; losses {losses}; {plots} plots written "
        f"(matplotlib {'present' if want_plots else 'missing'}); first "
        f"episode: "
        f"card {losses[0]}, CPU {want_loss}, abs err {err}")
    if err > VAL_TOL * (abs(want_loss) + 1.0):
        raise AssertionError(f"{tag}: card {losses[0]}, CPU {want_loss}")
    return launches


def tap_first_load(trainer):
    """Keep a CPU copy of the first host batch a host-path trainer loads
    (``trainer.first_batch``); no tensor to watch across replays."""
    load, first = trainer.sampler.load, []

    def recording(batch):
        if not first:
            first.append({k: v.clone() for k, v in batch.items()})
        load(batch)

    trainer.sampler.load = recording
    trainer.first_batch = first


def tap_gen_bg(trainer):
    """Record each recomposite of the train split during the run: whether
    its pixels changed (a strided sample of them, before and after)."""
    import numpy as np

    ds, changed = trainer.data, []
    gen_bg = ds.gen_bg

    def sample():
        return ds.splits["train"]["images"][:, :, ::7, ::7].copy()

    def recording(config, data="all"):
        before = sample() if data == "train" else None
        gen_bg(config, data)
        if before is not None:
            changed.append(not np.array_equal(before, sample()))

    ds.gen_bg = recording
    trainer.recomposites = changed


def host_loop_ms(trainer, calls, profile=False, warm=1):
    """ms/step of ``calls`` calls of the host path as ``train()`` issues
    them (the prefetch thread drawing the batches, each loaded into the
    graph's buffers, then one replay), after ``warm`` untimed ones (the
    pinned allocator has cached a block for each batch in flight after a
    few); with ``profile``, also the card's busy share of that wall time.
    The batches are ``_sample_train``'s, drawn on from where training
    left the stream, with no recomposite. Returns (ms/step, busy share or
    None, the queue's empty waits, the prefetch thread's ms a call drawing
    and putting into pinned memory, over the timed calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from wmfml_tpu_torch.train.trainer import Prefetcher

    fused = trainer.train_step
    spent_s = {"draw": 0.0, "pin": 0.0}

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent_s[name] += time.perf_counter() - t0
            return out
        return call

    pf = Prefetcher(timed("draw", trainer._sample_train),
                    timed("pin", trainer._put_train_batch),
                    depth=trainer.config.prefetch)
    try:
        for _ in range(warm):
            trainer.sampler.load(next(pf))
            fused(trainer.generator)
        torch.cuda.synchronize()
        waits, before = pf.empty_waits, dict(spent_s)
        host0 = torch.cuda.host_memory_stats()
        with (tprofile(activities=[ProfilerActivity.CUDA]) if profile
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                trainer.sampler.load(next(pf))
                fused(trainer.generator)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = None
        if profile:
            busy_us, last_end = 0.0, float("-inf")
            for _, start_us, end_us in sorted(device_events(prof),
                                              key=lambda e: e[1]):
                busy_us += max(0.0, end_us - max(start_us, last_end))
                last_end = max(last_end, end_us)
            busy = busy_us / wall_us
        host1 = torch.cuda.host_memory_stats()
        # the thread runs ahead of the timed calls by up to the queue's depth;
        # new pinned blocks (cudaHostAlloc) taken meanwhile, and their ms
        thread = {k: 1e3 * (v - before[k]) / calls for k, v in spent_s.items()}
        thread["pinned_allocs"] = (host1.get("num_host_alloc", 0)
                                   - host0.get("num_host_alloc", 0))
        thread["pinned_alloc_ms"] = 1e-3 * (
            host1.get("host_alloc_time.total", 0)
            - host0.get("host_alloc_time.total", 0))
        return (wall_us / 1e3 / (calls * fused.k), busy,
                pf.empty_waits - waits, thread)
    finally:
        pf.close()


@spent
def host_stream_phase(card, trainer, counters):
    """H1: phase 4's path with ``device_data=false`` through ``train_phase``
    (its launches, graph nodes and trace as every training phase's); its
    first call's K episodes equal ``get_batch("train")``'s from a freshly
    seeded copy of the data; graph = loop on the same host batches; ms/step
    and busy share of the host loop against phase 4's graph replays
    (``trainer``), on this card. Returns (the H1 trainer, its launches)."""
    import numpy as np

    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data.factory import build_data

    htrainer, launches, _ = train_phase(card, MAIN_YAML, HOST_OVERRIDES,
                                        counters, tap=tap_first_load)
    cfg = htrainer.config
    if not htrainer.streamed or trainer.streamed:
        raise AssertionError("H1 must stream from the host and phase 4 not")
    fresh = build_data(Config(MAIN_YAML, HOST_OVERRIDES, make_dirs=False))
    eps = [fresh.get_batch("train", cfg.tasks_per_batch, cfg.max_ctx_num)
           for _ in range(htrainer.steps_per_call)]
    first = htrainer.first_batch[0]
    for key, got in first.items():
        if not np.array_equal(got.numpy(), np.stack([e[key] for e in eps])):
            raise AssertionError(f"H1: the first call's {key} is not "
                                 f"get_batch's from a fresh copy")
    log(f"stream: H1 first call: {htrainer.steps_per_call} host episodes "
        f"({', '.join(f'{k} {tuple(v.shape)} {v.dtype}' for k, v in first.items())}) "
        f"equal get_batch('train') from a freshly seeded copy; prefetch "
        f"{htrainer.prefetch_stats}")
    graph_equals_loop(MAIN_YAML, HOST_OVERRIDES)
    calls = 3
    device_ms = call_ms(trainer, calls)
    device_busy = profile_calls(trainer, "ANP device-sampled (phase 4)",
                                calls=calls)["busy_share"]
    host_ms, _, waits, thread_ms = host_loop_ms(htrainer, calls)
    _, host_busy, pwaits, _ = host_loop_ms(htrainer, calls, profile=True)
    t_ = cfg.tasks_per_batch
    log(f"stream: ANPShapeNet1D f32 on {card}: device-sampled graph "
        f"{device_ms} ms/step ({t_ * 1e3 / device_ms} tasks/s), busy "
        f"{device_busy}; host-streamed (H1) {host_ms} ms/step "
        f"({t_ * 1e3 / host_ms} tasks/s), busy {host_busy}, host / device "
        f"{host_ms / device_ms}; {calls} calls of {htrainer.steps_per_call} "
        f"steps each; the prefetch queue ({cfg.prefetch} deep) was empty at "
        f"{waits} of {calls} calls ({pwaits} under the profiler); the "
        f"thread's ms a call {thread_ms} (draw: get_batch; pin: the "
        f"stack into pinned memory), the card's {device_ms * htrainer.steps_per_call}"
        f"; over training {htrainer.prefetch_stats}; H1 training "
        f"{1e3 * htrainer.timing['seconds'] / htrainer.timing['steps']} "
        f"ms/step over {htrainer.timing['steps']} timed steps")
    return htrainer, launches


@spent
def shapenet3d_stream_phase(card, s1trainer, counters):
    """H2: S1's path with ``device_data=false`` and ``bg_gen_freq=16``:
    one recomposite of the train split on the prefetch thread inside the
    24 steps, its pixels changed; the steps finite (``train_phase``'s
    metrics); ms/step over training and of the host loop with no
    recomposite (its thread's draw and pin ms), against S1's graph
    replays. Returns (trainer, launches)."""
    htrainer, launches, _ = train_phase(
        card, S3D_YAML, H2_OVERRIDES, counters,
        tap=lambda tr: tap_gen_bg(tr) or tap_first_load(tr))
    check_first_call_twin("H2", htrainer, S3D_YAML, H2_OVERRIDES)
    if not htrainer.streamed or htrainer.recomposites != [True]:
        raise AssertionError(f"H2: streamed {htrainer.streamed}, train "
                             f"split recomposites {htrainer.recomposites} "
                             "(one that changes the pixels expected)")
    ms = {tag: 1e3 * tr.timing["seconds"] / tr.timing["steps"]
          for tag, tr in (("S1", s1trainer), ("H2", htrainer))}
    s1_ms = call_ms(s1trainer, 1)
    loop_ms, _, waits, thread_ms = host_loop_ms(htrainer, 2, warm=6)
    log(f"stream: ANP ShapeNet3D f32 on {card}: over training, S1 "
        f"device-sampled {ms['S1']} ms/step, H2 host-streamed {ms['H2']} "
        f"ms/step (the recomposite's call among H2's timed ones), H2 / S1 "
        f"{ms['H2'] / ms['S1']}; one recomposite of the train split "
        f"(pixels changed); prefetch {htrainer.prefetch_stats}; with no "
        f"recomposite: S1 graph {s1_ms} ms/step, H2 host loop {loop_ms} "
        f"ms/step ({loop_ms / s1_ms} x; 2 calls after 6), the queue empty "
        f"at {waits} of 2 calls, the thread's ms a call {thread_ms} (draw: "
        f"the draws and "
        f"labels; pin: the image rows gathered by the native core into "
        f"pinned memory), the card's "
        f"{s1_ms * htrainer.steps_per_call}")
    native_gather_ms("H2", htrainer)
    return htrainer, launches


@spent
def distractor_stream_phase(card, d1trainer, counters):
    """H3: D1's path with ``device_data=false`` (16 steps, 8 a call)
    through ``train_phase``; its first call's episodes against the numpy
    twin's (``check_first_call_twin``); ms/step of the host loop against
    D1's graph replays, the queue's empty waits and the prefetch thread's
    ms a call; the native gather's host ms a call against the twin's
    (``native_gather_ms``). Returns (trainer, launches)."""
    htrainer, launches, _ = train_phase(card, DISTRACTOR_YAML, H3_OVERRIDES,
                                        counters, tap=tap_first_load)
    if not htrainer.streamed or d1trainer.streamed:
        raise AssertionError("H3 must stream from the host and D1 not")
    check_first_call_twin("H3", htrainer, DISTRACTOR_YAML, H3_OVERRIDES)
    calls = 2
    d1_ms = call_ms(d1trainer, calls)
    loop_ms, _, waits, thread_ms = host_loop_ms(htrainer, 2, warm=6)
    log(f"stream: ANPDistractor f32 on {card}: D1 device-sampled graph "
        f"{d1_ms} ms/step, H3 host-streamed {loop_ms} ms/step (2 calls "
        f"after 6; H3 / D1 {loop_ms / d1_ms}); over training H3 "
        f"{1e3 * htrainer.timing['seconds'] / htrainer.timing['steps']} "
        f"ms/step, prefetch {htrainer.prefetch_stats}; the host loop's "
        f"queue empty at {waits} of 2 calls, the thread's ms a call "
        f"{thread_ms} (draw: the episodes' draws and labels; pin: their "
        f"image rows gathered by the native core into pinned memory), the "
        f"card's {d1_ms * htrainer.steps_per_call}")
    native_gather_ms("H3", htrainer)
    return htrainer, launches


def check_first_call_twin(tag, trainer, yaml, overrides):
    """A host-path trainer's first call (``tap_first_load``) against the
    same call drawn by the numpy twins: a freshly seeded copy of the data,
    its gather (and ShapeNet3D's compositing, ``train()``'s recomposite of
    every split first) replaced by ``assemble_episode_plain`` and
    ``composite_backgrounds_plain``: bit for bit."""
    import numpy as np

    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data import episode_core as core
    from wmfml_tpu_torch.data import shapenet_3d
    from wmfml_tpu_torch.data.factory import build_data

    def plain_gather(data, items, perm, shot, query, query_offset=0,
                     n_threads=None, out=None):
        return core.assemble_episode_plain(data, items, perm, shot, query,
                                           query_offset)

    cfg = Config(yaml, overrides, make_dirs=False)
    fresh = build_data(cfg)
    saved = core.assemble_episode, shapenet_3d.composite_backgrounds
    core.assemble_episode = plain_gather
    shapenet_3d.composite_backgrounds = core.composite_backgrounds_plain
    try:
        if cfg.task == "shapenet_3d" and cfg.gen_bg:
            fresh.gen_bg(cfg)
        eps = [fresh.get_batch("train", cfg.tasks_per_batch, cfg.max_ctx_num)
               for _ in range(trainer.steps_per_call)]
    finally:
        core.assemble_episode, shapenet_3d.composite_backgrounds = saved
    first = trainer.first_batch[0]
    for key, got in first.items():
        if not np.array_equal(got.numpy(), np.stack([e[key] for e in eps])):
            raise AssertionError(f"{tag}: the first call's {key} is not the "
                                 f"numpy twin's")
    log(f"stream: {tag} first call: {trainer.steps_per_call} host episodes "
        f"({', '.join(f'{k} {tuple(v.shape)} {v.dtype}' for k, v in first.items())}) "
        f"through the native core equal the numpy twins' from a freshly "
        f"seeded copy, bit for bit")


@spent
def native_gather_ms(tag, trainer, calls=5):
    """Host ms a call (``steps_per_call`` episodes of the trainer's train
    split, at its shapes) of the image gather: the native core over the
    padded views (``data/episode_core.py``, ``threads()`` threads, and one;
    into new arrays, and into arrays written before, as the host path's
    reused pinned stack) against the numpy twin (fancy indexing, then
    ``make_episode``'s padding: the host path before the core), on the
    same draws, the outputs equal bit for bit; median of ``calls``
    calls."""
    import numpy as np

    from wmfml_tpu_torch.data import episode_core as core
    from wmfml_tpu_torch.data.episode import make_episode

    data, cfg = trainer.data, trainer.config
    split = data.splits["train"]
    images, s, q = split["images"], data.max_ctx, data.query_num
    draws = [data._draw("train", cfg.tasks_per_batch, cfg.max_ctx_num)
             for _ in range(trainer.steps_per_call)]

    reused = [tuple(np.empty((cfg.tasks_per_batch, n) + images.shape[2:],
                             images.dtype) for n in (s, q)) for _ in draws]

    def native(threads, into=None):
        return [core.assemble_episode(images, items,
                                      core.padded_views(perm, shot, s, q),
                                      s, q, n_threads=threads,
                                      out=None if into is None else into[i])
                for i, (items, perm, shot) in enumerate(draws)]

    def twin():
        out = []
        for items, perm, shot in draws:
            ctx, qry = core.assemble_episode_plain(images, items, perm, shot,
                                                   q)
            pad = make_episode(ctx, np.zeros(ctx.shape[:2] + (1,)), qry,
                               np.zeros(qry.shape[:2] + (1,)), max_ctx=s,
                               shot=shot)
            out.append((pad["ctx_x"], pad["qry_x"]))
        return out

    fns = {"native": lambda: native(None), "native_1_thread":
           lambda: native(1), "native_reused": lambda: native(None, reused),
           "numpy_twin": twin}
    for (a, b), (c, d) in zip(fns["native"](), fns["numpy_twin"]()):
        if not (np.array_equal(a, c) and np.array_equal(b, d)):
            raise AssertionError(f"{tag}: the native gather differs from "
                                 f"the numpy twin's")
    ms = {}
    for name, fn in fns.items():
        runs = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            runs.append(1e3 * (time.perf_counter() - t0))
        ms[name] = sorted(runs)[calls // 2]
    nbytes = sum(images.itemsize * (s + q) * cfg.tasks_per_batch
                 * int(np.prod(images.shape[2:])) for _ in draws)
    log(f"native: {tag} gather of a call ({len(draws)} episodes, "
        f"{nbytes / 2 ** 20} MiB of {images.dtype} image rows, "
        f"{images.shape[2:]} each): native core {ms['native']} ms "
        f"({core.threads()} threads), one thread {ms['native_1_thread']} ms, "
        f"into buffers written before (as the pinned stack the host path "
        f"reuses) {ms['native_reused']} ms, numpy twin {ms['numpy_twin']} "
        f"ms (twin / core {ms['numpy_twin'] / ms['native']}), median of "
        f"{calls}; equal bit for bit")
    return ms


def host_sweep(trainer, source):
    """The trainer's host sweep of ``source`` (``validate``'s host path),
    each batch's loss."""
    import numpy as np

    from wmfml_tpu_torch.train.trainer import episode_to_device

    cfg = trainer.config
    trainer.data.reset_eval(source, seed=42)
    trainer.eval_generator.manual_seed(int(cfg.seed) + 10_000_000)
    losses = [trainer.eval_step(episode_to_device(trainer.data.get_batch(
        source, cfg.tasks_per_batch, cfg.max_ctx_num), "cuda"),
        trainer.eval_generator) for _ in range(cfg.val_iters)]
    return np.asarray([float(x) for x in losses])


@spent
def check_device_validation(trainer, tag, episodes=V1_ITERS, eager=True):
    """V1: the trainer's validation sweep on the device at ``episodes``
    episodes. Under deterministic algorithms, on fresh sweeps: the graph
    sweep's losses (three eager batches, the capture, replays; then all
    replays) against the host sweep's, batch for batch, rtol 1e-5; then in
    the port's settings the times of a graph sweep, an eager device sweep
    (with ``eager``) and the host sweep, and the capture's. Returns the
    launches on the card of the two timed graph sweeps."""
    import numpy as np
    import torch

    from wmfml_tpu_torch.data.device_eval import DeviceSweep
    from wmfml_tpu_torch.train.steps import KERNELS

    cfg = trainer.config
    saved = cfg.val_iters, trainer.device_eval
    split = saved[1]["validation"].split

    def sweep_s(sweep, n=1):
        trainer.device_eval = {"validation": sweep}
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = trainer._device_validate("validation")
            out.append((time.perf_counter() - t0, losses))
        return out

    cfg.val_iters = episodes
    try:
        torch.use_deterministic_algorithms(True)
        try:
            runs = sweep_s(trainer._make_device_sweep(split), 2)
            want = host_sweep(trainer, "validation")
        finally:
            torch.use_deterministic_algorithms(False)
        rel = max(float(np.max(np.abs(got - want) / np.abs(want)))
                  for _, got in runs)
        log(f"sweep: V1 {tag}: {episodes} validation episodes, device "
            f"sweep (graph) {list(runs[1][1])}, host {list(want)}; max "
            f"rel err {rel} (rtol 1e-5); first sweep = second: "
            f"{np.array_equal(runs[0][1], runs[1][1])}")
        if rel > 1e-5 or not np.array_equal(runs[0][1], runs[1][1]):
            raise AssertionError(f"V1 {tag}: device sweep {runs}, host "
                                 f"{want}")
        zero_counters()
        graph = trainer._make_device_sweep(split)
        timed = sweep_s(graph, 2)
        launches = {k: n for k, n in graph_launches(
            [graph], read_counters()).items() if n and k in KERNELS}
        eager = sweep_s(DeviceSweep(trainer.eval_step, split,
                                    trainer.eval_generator, graph=False)
                        ) if eager else [(None, None)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_sweep(trainer, "validation")
        host_s = time.perf_counter() - t0
    finally:
        cfg.val_iters, trainer.device_eval = saved
    log(f"sweep: V1 {tag} on {card_line()}: {episodes} episodes, graph "
        f"sweep {timed[1][0]} s (the first, with 3 eager batches and the "
        f"capture, {timed[0][0]} s; capture {graph.graph_stats}), eager "
        f"device sweep {eager[0][0]} s, host sweep {host_s} s; host / graph "
        f"{host_s / timed[1][0]}; {graph.replays} replays; launches on the "
        f"card {launches}")
    return launches


@spent
def check_device_evaluation(tag, yaml, overrides, trainer, no_graph=False):
    """V2: ``evaluation_cli`` over ``trainer``'s final checkpoint with the
    device sweep (graphs, and with ``no_graph`` also without) and with the
    host sweep (``device_data=false``): each split's per-point means and
    stds agree as ``tests/test_eval_device_cli.py`` holds them (rtol 1e-4
    / atol 1e-5, stds rtol 1e-3 / atol 1e-4) and both write the same files
    to their printed digits; the wall times. Returns the graph sweep's
    launches on the card."""
    import numpy as np
    import torch

    from wmfml_tpu_torch.cli import evaluation_cli
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.train.steps import KERNELS

    ckpt = trainer.ckpt.path(f"model_end_{trainer.config.iterations}")
    # the host sweep first: every later run finds cuDNN's kernels loaded
    modes = [("host", "false", None), ("graph", "auto", True)] + (
        [("eager", "auto", False)] if no_graph else [])
    runs, launches = {}, {}
    for name, device_data, graphs in modes:
        config = Config(yaml, overrides + [f"checkpoint={ckpt}",
                                           f"device_data={device_data}"])
        zero_counters()
        ev = evaluation_cli.build_evaluator(config)
        if graphs is not None:
            ev.sweep_graphs = graphs
        points = {}
        sweep_source = ev._sweep_source

        def recording(source, sweep_source=sweep_source, points=points):
            points[source] = sweep_source(source)
            return points[source]

        ev._sweep_source = recording
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.evaluate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sweeps = [sw for sw in ev.sweeps.values() if sw]
        if (name == "host") == bool(sweeps):
            raise AssertionError(f"V2 {tag} {name}: sweeps {ev.sweeps}")
        if name == "graph":
            launches = {k: n for k, n in graph_launches(
                sweeps, read_counters()).items() if n and k in KERNELS}
        files = {n: np.loadtxt(os.path.join(config.save_path, n))
                 for n in ("val_losses.txt", "test_losses.txt")
                 if os.path.exists(os.path.join(config.save_path, n))}
        runs[name] = dict(wall=wall, points=points, files=files,
                          capture=[sw.graph_stats for sw in sweeps],
                          replays=[sw.replays for sw in sweeps])
        del ev, sweeps, sweep_source, recording
        gc.collect()
        torch.cuda.empty_cache()
    host = runs["host"]
    for name, run in runs.items():
        if name == "host":
            continue
        for source, (means, stds) in host["points"].items():
            got = run["points"][source]
            np.testing.assert_allclose(got[0], means, rtol=1e-4, atol=1e-5,
                                       err_msg=f"V2 {tag} {name} {source}")
            np.testing.assert_allclose(got[1], stds, rtol=1e-3, atol=1e-4,
                                       err_msg=f"V2 {tag} {name} {source}")
        for n, arr in host["files"].items():
            np.testing.assert_allclose(run["files"][n], arr, atol=1.01e-4,
                                       err_msg=f"V2 {tag} {name} {n}")
        if sorted(run["files"]) != sorted(host["files"]):
            raise AssertionError(f"V2 {tag}: files {sorted(run['files'])}")
    err = max(float(np.max(np.abs(np.subtract(run["points"][s][0],
                                              host["points"][s][0]))
                           / np.abs(host["points"][s][0])))
              for name, run in runs.items() if name != "host"
              for s in host["points"])
    log(f"sweep: V2 {tag} on {card_line()}: " + "; ".join(
        f"{name} {run['wall']} s" + (
            f" (replays {run['replays']}, capture {run['capture']})"
            if run["capture"] else "") for name, run in runs.items())
        + f"; host / graph {host['wall'] / runs['graph']['wall']}; max rel "
        f"err of the means, device against host, {err}; launches on the "
        f"card (graph) {launches}")
    return launches


@spent
def s2d_phase(card, stock, counters):
    """Phase 24 (ROADMAP.md B8b): D1, D5 and S6 with ``trunk_stem=s2d``
    through ``train_phase``, their validation card against CPU, graph =
    loop bit for bit, and graph ms/step against ``stock``'s trainer of the
    same configuration, in turns stock, s2d, s2d, stock, and one call of
    each under torch.profiler (busy share, top kernels); returns the
    launches on the card of each."""
    paths = {"D1": (DISTRACTOR_YAML, DISTRACTOR_SHORT_OVERRIDES,
                    check_validation_loss),
             "D5": (DISTRACTOR_YAML, DISTRACTOR_SHORT_OVERRIDES + BF16,
                    check_bf16_validation),
             "S6": (S3D_YAML, S3D_SHORT_OVERRIDES + BF16,
                    check_bf16_validation)}
    out = {}
    for tag, (yaml, overrides, check) in paths.items():
        trainer, out[tag], nodes = train_phase(card, yaml, overrides + S2D,
                                               counters)
        model = trainer.model
        if not (model.img_encoder.trunk_stem == model.decoder.trunk_stem
                == "s2d"):
            raise AssertionError(f"{tag} s2d: the trunks run "
                                 f"{model.img_encoder.trunk_stem}")
        check(trainer)
        graph_equals_loop(yaml, overrides + S2D)
        runs = {"stock": [], "s2d": []}
        trainers = {"stock": stock[tag], "s2d": trainer}
        for key in ("stock", "s2d", "s2d", "stock"):
            runs[key].append(call_ms(trainers[key], 2))
        ms = {k: sum(v) / len(v) for k, v in runs.items()}
        t_ = trainer.config.tasks_per_batch
        busy = {k: profile_calls(tr, f"{tag} {k} stem")["busy_share"]
                for k, tr in trainers.items()}
        log(f"s2d: {tag} graph ms/step: stock stem {ms['stock']} "
            f"({t_ * 1e3 / ms['stock']} tasks/s), s2d {ms['s2d']} "
            f"({t_ * 1e3 / ms['s2d']} tasks/s), s2d / stock "
            f"{ms['s2d'] / ms['stock']} (turns {json.dumps(runs)}, 2 calls "
            f"of 8 steps each; busy share {busy}); s2d graph "
            f"{nodes['kernel_nodes']} kernel "
            f"nodes, capture {trainer.train_step.graph_stats}; on {card}")
        del trainer, trainers
        gc.collect()
    return out


def stem_backward_inputs(model, gen, b, dtype, dyadic):
    """K1b's inputs at ``b`` images of 128 x 128 x 1 in ``dtype``: the
    pooled map's gradient g ~ N(0, 1) and, with ``dyadic``, images in {0,
    1/8, ..., 1} and weights on grids of 1/8, 1/64 (conv0's weight and
    bias), 1/64 and 1/4096 (conv1's): conv0's sums are then multiples of
    2^-6 below 3 and conv1's multiples of 2^-12 below 2^6, exact in float32
    whatever the order, so every implementation takes the same ReLU masks
    and pool routes (first maxima among exact ties included); else uniform
    images and ``model``'s stem weights."""
    import torch

    def grid(lo, hi, shape, step):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device="cuda").float() * step

    if dyadic:
        x = grid(0, 8, (b, 128, 128, 1), 1 / 8)
        w = (grid(-2, 2, (32, 1, 3, 3), 1 / 8), grid(-2, 2, (32,), 1 / 64),
             grid(-4, 4, (48, 32, 3, 3), 1 / 64),
             grid(-64, 64, (48,), 1 / 4096))
    else:
        enc = model.encoder_w0
        x = torch.rand((b, 128, 128, 1), generator=gen, device="cuda")
        w = tuple(p.detach() for p in (enc[0].weight, enc[0].bias,
                                       enc[2].weight, enc[2].bias))
    g = torch.randn((b, 16, 16, 48), generator=gen, device="cuda")
    return tuple(a.to(dtype) for a in (x, *w, g))


def stem_backward_bound(args, route):
    """``bound`` of K1b on ``args`` (x, w0, b0, w1, b1, g) and the pool's
    routes ``route`` of K1's forward (K1b's input: no conv1 again): conv0
    again (the patch dW1 reads and conv0's ReLU mask), then what this
    data needs of the backward: each pooled value routed to a positive
    maximum scatters into 9 taps x 32 channels of conv1's input gradient
    and adds 288 products to dW1; each conv0 value with its ReLU on adds 9
    Ci products to dW0. In float32 conv0's products on the CUDA cores and
    conv1's in 3xTF32 on the tensor cores, in bfloat16 all at the bfloat16
    tensor-core rate. ``bound_with_forward_ms``: the same with conv1 run
    again, as the bound counted the backward before K1 wrote the routes
    (K1b recomputed conv1 then)."""
    import torch
    import torch.nn.functional as F

    from wmfml_tpu_torch.ops.cast import conv2d

    x, w0, b0, w1, b1, g = args
    b, h, w, ci = x.shape
    a0 = F.relu(conv2d(x.permute(0, 3, 1, 2), w0, b0, stride=2, padding=1))
    routed = int(torch.count_nonzero((route < 4) & (g != 0)))
    live0 = int(torch.count_nonzero(a0))
    conv0 = 2 * b * (h // 2) * (w // 2) * 32 * 9 * ci
    conv1 = 2 * b * (h // 4) * (w // 4) * 48 * 9 * 32
    back1 = 2 * 2 * routed * 9 * 32
    back0 = 2 * live0 * 9 * ci
    nbytes = sum(a.numel() for a in args) * x.element_size() + sum(
        a.numel() for a in (w0, b0, w1, b1)) * x.element_size() + route.numel()
    if x.dtype == torch.bfloat16:
        out = bound(0.0, nbytes, bf16_flops=conv0 + back1 + back0)
        old = bound(0.0, nbytes, bf16_flops=conv0 + conv1 + back1 + back0)
    else:
        out = bound(conv0 + back0, nbytes, split_flops=back1)
        old = bound(conv0 + back0, nbytes, split_flops=conv1 + back1)
    return dict(out, routed=routed, conv0_live=live0,
                bound_with_forward_ms=old["bound_ms"])


STEM_GRADS = ("dW0", "db0", "dW1", "db1")


def hold_f64(name, got, want, ref):
    """K1b's float32 gradients ``got`` against the float32 twin ``want`` and
    the twin in float64 ``ref`` (the same decisions): each within
    BWD_GRAD_FACTOR times the float32 twin's own distance from float64, or
    BWD_TOL of its largest element. Returns the notes and |got - want|."""
    import torch

    notes, errs = [], []
    for grad, k, t, r in zip(STEM_GRADS, got, want, ref):
        err_k = (k.double() - r).abs().max().item()
        err_t = (t.double() - r).abs().max().item()
        limit = max(BWD_TOL * r.abs().max().item(), BWD_GRAD_FACTOR * err_t)
        errs.append((k - t).abs().max().item())
        notes.append(f"{grad} kernel {err_k} / twin {err_t} from float64 "
                     f"(limit {limit})")
        if not err_k <= limit or not bool(torch.isfinite(k).all()):
            raise AssertionError(f"literature_stem_backward {name} {grad}: "
                                 f"kernel {err_k} from float64, the float32 "
                                 f"twin {err_t} (limit {limit})")
    return notes, errs


@spent
def check_stem_backward(model, gen, dtype=None, tasks=10, path="ANP phase",
                        off_path=False):
    """K1b (``conv_bwd: phase``, ROADMAP.md B8a) on the pool's routes of
    K1's forward (``stem_launch(..., route=True)``, as the path runs them)
    against its plain twin ``stem_backward_phase_plain`` at the ANP path's
    shape (30 images a task, 300 at T = 10, 1,200 at ``tasks`` = 40).
    float32: on dyadic inputs (``stem_backward_inputs``: every forward sum
    exact, so K1's routes must be the twin's own, checked), each gradient
    within BWD_GRAD_FACTOR times the float32 twin's own distance from the
    twin in float64 or BWD_TOL of its largest element; then on uniform
    images and ``model``'s weights, where a value within float32 rounding
    of 0 or of its window's maximum can take the other decision in
    another summation order, each gradient against the twin fed the
    decisions K1b took (``debug=True``: K1's routes and conv0's mask) at
    the same limits, and how many of those differ from the twin's own
    decisions logged. bfloat16, on uniform images and the model's weights:
    ``check_bf16``'s rule against the bfloat16 twin. Two calls equal bit
    for bit. Times: K1b, the twin, and the library's way, today's backward
    (``conv_bwd: xla``: autodiff of the stem's plain twin on cuDNN, the
    forward recomputed with grad)."""
    import torch

    from wmfml_tpu_torch.kernels import stem

    dtype = dtype or torch.float32
    b = tasks * 30
    f32 = dtype == torch.float32
    args = stem_backward_inputs(model, gen, b, dtype, dyadic=f32)
    route = stem.stem_launch(*args[:5], route=True)[1]
    got = stem.stem_backward_launch(*args, route)
    again = stem.stem_backward_launch(*args, route)
    want = stem.stem_backward_phase_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError("literature_stem_backward: two calls differ")
    notes = []
    own_route, own_mask = stem.stem_decisions_plain(*args[:5])
    if f32:
        if not torch.equal(route, own_route):
            raise AssertionError(
                f"literature_stem: on dyadic inputs K1's routes differ from "
                f"the twin's first maxima at "
                f"{int((route != own_route).sum())} pooled values")
        ref = stem.stem_backward_phase_plain(*(a.double() for a in args))
        held, errs = hold_f64("dyadic", got, want, ref)
        notes += held
        real = stem_backward_inputs(model, gen, b, dtype, dyadic=False)
        got_r, (route_r, mask_r) = stem.stem_backward_launch(
            *real, stem.stem_launch(*real[:5], route=True)[1], debug=True)
        fed = stem.stem_backward_phase_plain(*real, route=route_r,
                                             mask0=mask_r)
        ref_r = stem.stem_backward_phase_plain(
            *(a.double() for a in real), route=route_r, mask0=mask_r)
        own_r, own_m = stem.stem_decisions_plain(*real[:5])
        held, _ = hold_f64("uniform, fed K1b's decisions", got_r, fed, ref_r)
        notes.append(
            "uniform images and the model's weights, against the twin fed "
            "K1b's decisions: " + "; ".join(held) + f"; decisions that "
            f"differ from the twin's own: routes "
            f"{int((route_r != own_r).sum())} of {route_r.numel()}, conv0 "
            f"mask {int((mask_r.bool() != own_m).sum())} of {mask_r.numel()}")
    else:
        want_f32 = stem.stem_backward_phase_plain(*(a.float() for a in args))
        errs = []
        for name, k, t, t32 in zip(STEM_GRADS, got, want, want_f32):
            err, _ = check_bf16(f"literature_stem_backward {name}", k, t, t32,
                                element_ulps=False)
            errs.append(err)
        notes.append(f"K1's routes differ from the twin's own at "
                     f"{int((route != own_route).sum())} of {route.numel()}")
    log(f"kernel: literature_stem_backward [{b}, 128, 128, 1] "
        f"{'float32, dyadic inputs' if f32 else 'bfloat16'}: "
        + "; ".join(notes) + f"; max abs err against the twin {errs}")
    x, w0, b0, w1, b1, g = args
    leaves = [a.clone().requires_grad_() for a in (w0, b0, w1, b1)]

    def library():      # today's backward (conv_bwd: xla); not K1b's path
        y = stem.stem_plain(x, *leaves)
        return torch.autograd.grad(y, leaves, g)

    times = in_turns({"ms": lambda: stem.stem_backward_launch(*args, route),
                      "plain_ms": lambda: stem.stem_backward_phase_plain(
                          *args),
                      "library_ms": library})
    times.update(device_profile(lambda: stem.stem_backward_launch(*args,
                                                                  route),
                                breakdown=True))
    ids = _rows("literature_stem_backward", dtype, path, tasks)
    row = dict(**ids, shape=f"shared weights, [{b}, 128, 128, 1], g "
               f"[{b}, 16, 16, 48], K1's routes"
               + (", dyadic inputs" if f32 else ""),
               source="wmfml_tpu_torch/csrc/stem_bwd.cu",
               replaces="wmfml_tpu/nn/encoders.py:117",
               max_abs_err=max(errs), **times,
               **stem_backward_bound(args, route))
    if off_path:
        row["off_path"] = True
    return row


def warm_trainer(yaml, overrides):
    """A trainer built as ``train_cli`` builds it, its fused step past the
    warm-up and the capture (one replay run), ready for ``call_ms``."""
    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config

    trainer = train_cli.build_trainer(Config(yaml, overrides))
    while not trainer.train_step.replays:
        trainer.train_step(trainer.generator)
    return trainer


@spent
def phase_bwd_phase(card, stock):
    """Phase 26 (ROADMAP.md B8a): ANPShapeNet1D as shipped with
    ``conv_bwd=phase``, 16 steps, 8 a call, in float32 and bfloat16,
    through ``train_phase`` (K1b once a step, graph nodes included); the
    trained model's output (float32) and validation loss card against
    CPU; graph = loop bit for bit; graph
    ms/step against the default ``xla`` in turns xla, phase, phase, xla
    (float32: ``stock``, phase 4's trainer; bfloat16: a fresh trainer at 8
    steps a call). Returns the launches on the card of each."""
    import torch

    from wmfml_tpu_torch.kernels.favor import favor_attention
    from wmfml_tpu_torch.kernels.image_da import image_da
    from wmfml_tpu_torch.kernels.stem import (literature_stem,
                                              literature_stem_backward)

    counters = {"literature_stem": literature_stem,
                "literature_stem_backward": literature_stem_backward,
                "favor_attention": favor_attention, "image_da": image_da}
    out = {}
    for tag, extra, check in (("f32", [], check_validation_loss),
                              ("bf16", BF16, check_bf16_validation)):
        overrides = TRAIN_OVERRIDES + PHASE_BWD + extra
        trainer, out[tag], nodes = train_phase(card, MAIN_YAML, overrides,
                                               counters)
        if trainer.model.encoder_w0.conv_bwd != "phase":
            raise AssertionError("phase 26 ran without conv_bwd: phase")
        if tag == "f32":
            check_trained_output(trainer)
        check(trainer)
        graph_equals_loop(MAIN_YAML, overrides)
        xla = stock if tag == "f32" else warm_trainer(
            MAIN_YAML, TRAIN_OVERRIDES + extra + ["iterations=16"])
        runs = {"xla": [], "phase": []}
        trainers = {"xla": xla, "phase": trainer}
        for key in ("xla", "phase", "phase", "xla"):
            runs[key].append(call_ms(trainers[key], 2))
        ms = {k: sum(v) / len(v) for k, v in runs.items()}
        log(f"phase: ANPShapeNet1D {tag} graph ms/step: conv_bwd xla "
            f"{ms['xla']}, phase {ms['phase']}, phase / xla "
            f"{ms['phase'] / ms['xla']} (turns {json.dumps(runs)}, 2 calls "
            f"of 8 steps each); phase graph {nodes['kernel_nodes']} kernel "
            f"nodes, capture {trainer.train_step.graph_stats}; on {card}")
        del trainer, trainers, xla
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _allclose_report(got, want, rtol, atol):
    """The largest excess over |got - want| <= atol + rtol |want| among the
    tensors of two dicts (<= 0: every element within), and its key."""
    worst, where = -math.inf, None
    for k, w in want.items():
        g = got[k].double()
        excess = ((g - w.double()).abs() - atol - rtol * w.double().abs()
                  ).max().item()
        if excess > worst:
            worst, where = excess, k
    return worst, where


def tp_worker(rank: int, port: str, outdir: str) -> int:
    """Phase 27's rank ``rank`` of a 2-rank gloo world on cuda:0 (started
    by ``tp_phase`` as ``chip_smoke.py --tp-worker <rank> <port> <dir>``):
    S1's model and TP_STEPS host batches of its train split, the same on
    both ranks; TP_STEPS eager steps without a mesh (one process), then the
    same from the same state and batches on ``{data: 1, model: 2}``
    (``parallel/mesh.py:shard_state``, ``train/steps.py:build_train_step
    (state_sharding=...)``), both under deterministic algorithms; writes
    ``rank<r>.json``: each step's loss, the largest excess of the gathered
    parameters over the tolerance, the keys split and the JAX leaves they
    are, K2's wide and K6's launches on this rank, ms a step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from wmfml_tpu_torch.ckpt.jax_params import full_state_dict
    from wmfml_tpu_torch.cli.common import set_numerics
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.data.factory import build_data
    from wmfml_tpu_torch.kernels.favor import favor_attention
    from wmfml_tpu_torch.kernels.image_da import image_da
    from wmfml_tpu_torch.parallel import mesh
    from wmfml_tpu_torch.train.state import build_optimizer
    from wmfml_tpu_torch.train.steps import build_train_step, init_model
    from wmfml_tpu_torch.train.trainer import episode_to_device

    set_numerics()
    torch.cuda.set_device(0)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    config = Config(S3D_YAML, TP_OVERRIDES, make_dirs=False)
    data = build_data(config)
    batches = [episode_to_device(data.get_batch(
        "train", config.tasks_per_batch, config.max_ctx_num), "cuda")
        for _ in range(TP_STEPS)]

    def run(ctx):
        mesh.use(ctx)
        try:
            model = init_model(config)
            placement = None if ctx is None else mesh.shard_state(ctx, model)
            opt = build_optimizer(config, model.parameters())
            step = build_train_step(model, opt, config,
                                    state_sharding=placement)
            gen = torch.Generator(device="cuda").manual_seed(config.seed)
            zero_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [float(step(b, gen)) for b in batches]
            ms = 1e3 * (time.perf_counter() - t0) / len(batches)
            launches = {"favor_attention": favor_attention.launches,
                        "favor_attention.wide": favor_attention.wide_launches,
                        "image_da": image_da.launches,
                        f"image_da.{config.task}":
                        image_da.program_launches[config.task]}
            params = {k: v.detach().cpu()
                      for k, v in full_state_dict(model).items()}
            return losses, params, launches, placement, ms
        finally:
            mesh.use(None)

    one = run(None)
    ctx = mesh.MeshContext.create({"data": 1, "model": 2})
    two = run(ctx)
    split = sorted(k for k, d in two[3].items() if d is not None)
    leaves = sorted({mesh._HEAD.sub(r"\1\2", k) for k in split})
    excess, where = _allclose_report(two[1], one[1], 1e-4, 1e-6)
    loss_err = max(abs(a - b) for a, b in zip(one[0], two[0]))
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, index=ctx.index, model_rank=ctx.model_rank,
                       losses_one=one[0], losses_tp=two[0],
                       loss_err=loss_err, param_excess=excess,
                       param_worst=where, split_keys=len(split),
                       jax_leaves=len(leaves), jax_leaf_names=leaves,
                       params=len(one[1]), launches=two[2],
                       launches_one=one[2], ms_one=one[4], ms_tp=two[4],
                       finite=bool(np.isfinite(two[0]).all())), f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


@spent
def tp_phase(card):
    """Phase 27 (ROADMAP.md A18c): a 2-rank gloo world on this card (NCCL
    takes one rank a card), ``tp_worker`` on each, S1
    (``cfg/train/ANP_DA+TA_ShapeNet3D.yaml`` at full width: T = 20, 64 x 64
    RGB, K2 wide, K6 program 6) with ``mesh_shape={data: 1, model: 2}``,
    TP_STEPS eager steps through the TP step against one process's from
    the same state and batches, under deterministic algorithms: each
    step's loss within 1e-5, the gathered parameters within rtol 1e-4 /
    atol 1e-6 (``tests/test_torch_port_dp.py``'s tolerances; SGD, as that
    test steps ANP: Adam's first step divides ANP's near-zero key-bias
    gradients by their own size), K2 wide and K6 launched on each rank.
    Both processes are waited for and killed before it returns. Returns
    each rank's launches."""
    import socket
    import tempfile

    mode = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=compute_mode",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    log(f"tp: compute mode {mode} (two processes on one card need Default)")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-worker",
             str(r), port, tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"tp worker {r} failed (rc "
                                     f"{p.returncode}):\n{out[-4000:]}")
        results = []
        for r in (0, 1):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
    out = {}
    for res in results:
        r = res["rank"]
        launches = res["launches"]
        log(f"tp: S1 rank {r} (data {res['index']}, model "
            f"{res['model_rank']}): {TP_STEPS} eager steps, losses one "
            f"process {res['losses_one']}, TP {res['losses_tp']}, max "
            f"|diff| {res['loss_err']}; gathered parameters' largest excess "
            f"over rtol 1e-4 / atol 1e-6 {res['param_excess']} "
            f"({res['param_worst']}; <= 0 within); {res['split_keys']} of "
            f"{res['params']} parameters split, the JAX rule's "
            f"{res['jax_leaves']} leaves ({res['jax_leaf_names']}); launches "
            f"{launches} (one process {res['launches_one']}); ms a step: one "
            f"process {res['ms_one']}, TP {res['ms_tp']}; on {card}")
        if not (res["finite"] and res["loss_err"] < 1e-5
                and res["param_excess"] <= 0 and res["split_keys"] > 0
                and launches["favor_attention.wide"] == TP_STEPS
                and launches["favor_attention"] == TP_STEPS
                and launches["image_da.shapenet_3d"] == 2 * TP_STEPS):
            raise AssertionError(f"phase 27 rank {r}: {res}")
        out[f"ShapeNet3D ANP TP rank {r} (P27)"] = {
            "favor_attention": launches["favor_attention"],
            "image_da": launches["image_da"],
            "image_da.shapenet_3d": launches["image_da.shapenet_3d"]}
    if sorted((res["index"], res["model_rank"]) for res in results) != [
            (0, 0), (0, 1)]:
        raise AssertionError(f"phase 27: mesh positions {results}")
    log(f"tp: phase 27 in {time.perf_counter() - t0:.1f} s")
    return out


@contextlib.contextmanager
def on_mesh(ctx):
    """Run the block with ``ctx`` as the process's mesh (None: none)."""
    from wmfml_tpu_torch.parallel import mesh

    before = mesh.use(ctx)
    try:
        yield
    finally:
        mesh.use(before)


@spent
def group_equals_plain(yaml, overrides, ctx, calls=3):
    """Two trainers from one seed under deterministic algorithms, one on the
    one-rank group ``ctx``, one on none: every call's metrics (an eager
    warm-up, the capture and its replay, a replay), the weights, Adam's
    state and the generator's state equal bit for bit."""
    import torch

    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.configs import Config

    t0 = time.perf_counter()
    meshes = {"group": ctx, "plain": None}
    torch.use_deterministic_algorithms(True)
    try:
        trainers = {}
        for name, m in meshes.items():
            with on_mesh(m):
                trainers[name] = train_cli.build_trainer(Config(yaml,
                                                                overrides))
        for i in range(calls):
            got = {}
            for name, m in meshes.items():
                tr = trainers[name]
                with on_mesh(m):
                    got[name] = {k: v.clone() if torch.is_tensor(v) else v
                                 for k, v in tr.train_step(
                                     tr.generator).items()}
            torch.cuda.synchronize()
            if got["group"].keys() != got["plain"].keys() or any(
                    not torch.equal(torch.as_tensor(got["group"][k]),
                                    torch.as_tensor(got["plain"][k]))
                    for k in got["plain"]):
                raise AssertionError(f"call {i}: with the group {got['group']}"
                                     f", without {got['plain']}")
    finally:
        torch.use_deterministic_algorithms(False)
    tensors = []
    for tr in trainers.values():
        state = tr.optimizer.state_dict()["state"]
        tensors.append([p.detach() for p in tr.model.parameters()]
                       + [v for s in state.values() for v in s.values()]
                       + [tr.generator.get_state()])
    differ = sum(not torch.equal(a, b) for a, b in zip(*tensors))
    fused = trainers["group"].train_step
    log(f"dp: group vs none: {calls} calls of {fused.k} steps "
        f"({fused.replays} replays): metrics, {len(tensors[0]) - 1} weight "
        f"and Adam tensors and the generator state, {differ} of them differ "
        f"({time.perf_counter() - t0:.1f} s)")
    if differ or fused.replays < 1 or len(tensors[0]) != len(tensors[1]):
        raise AssertionError(f"the one-rank group left {differ} tensors "
                             f"unlike the run without one")


@spent
def check_profile_trace(trainer, tag):
    """``obs/profile.py:profile_trace`` around one replay of the trainer's
    graph: the file exists and names K1, K2, K6 and the all-reduce (taken
    again, up to three times, where the profiler lost an event)."""
    import re
    import tempfile

    from wmfml_tpu_torch.obs.profile import TRACE_NAME, profile_trace

    want = [GRAPH_NODE[k] for k in ("literature_stem", "favor_attention",
                                    "image_da")]
    for attempt in range(3):
        with tempfile.TemporaryDirectory() as tmp:
            with profile_trace(tmp):
                trainer.train_step(trainer.generator)
            path = os.path.join(tmp, TRACE_NAME)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events
                 if e.get("cat") == "kernel"}
        found = {k: any(k in n for n in names) for k in want}
        found["all_reduce"] = any(re.search(NCCL_KERNEL, n, re.I)
                                  for n in names)
        TRACES["taken"] += 1
        log(f"dp: {tag}: profile_trace of one replay: {len(events)} events, "
            f"{len(names)} kernel names; found {found} (attempt "
            f"{attempt + 1} of 3)")
        if all(found.values()):
            return
        TRACES["short"] += 1
    raise AssertionError(f"{tag}: no profile_trace named every kernel and "
                         f"the all-reduce")


@spent
def check_favor_kmax(gen, projections):
    """K2 with an outer key max (``favor_launch(kmax=...)``: what a mesh of
    n ranks passes it, the max over every rank's keys) against its twin
    with the same max: the keys' own max, and one 2 above it (another
    rank's keys reaching higher), at the ANP path's narrow shape and D1's
    wide shape with their paths' projections (``projections``: the row
    name's), q, k, v as the attention block hands them over, shots
    1..Nk."""
    import torch

    from wmfml_tpu_torch.kernels import favor

    shapes = {"favor_attention": (10, 15, 15),
              "favor_attention_wide": (20, 18, 15)}
    for name, proj in projections.items():
        t, nq, nk = shapes[name]
        d = proj.shape[1]
        q, k, v = (torch.randn((t, n, 8, d), generator=gen, device="cuda"
                               ).transpose(1, 2) for n in (nq, nk, nk))
        shots = torch.tensor([1 + ((nk - 1) * i) // (t - 1)
                              for i in range(t)], device="cuda")
        mask = torch.arange(nk, device="cuda")[None, :] < shots[:, None]
        own = favor.dash(k, proj).amax()
        for label, kmax in (("own", own), ("raised", own + 2.0)):
            got = favor.favor_launch(q, k, v, proj, mask, kmax=kmax)
            want = favor.favor_plain(q, k, v, proj, mask, kmax=kmax)
            err, rel = check_close(name, got, want)
            log(f"dp: {name} with kmax = the keys' {label} max "
                f"({kmax.item()}): max abs err {err}, max rel err {rel} "
                f"(atol, rtol {TOL[name]})")


@spent
def dp_phase(card, plain, counters):
    """Phase 25 (ROADMAP.md A18): the ANP path on a one-rank NCCL group
    (``start_mesh``, as the CLIs start it), through ``train_phase``; the
    all-reduce in the captured graph, group = none bit for bit, graph
    ms/step against ``plain`` (phase 4's trainer: the same configuration
    without a group) in turns plain, group, group, plain, and
    ``profile_trace`` of a replay; then the process group ends. Returns
    the launches on the card."""
    import torch

    from wmfml_tpu_torch.cli.common import stop_mesh
    from wmfml_tpu_torch.parallel import mesh

    trainer, launches, nodes = train_phase(card, MAIN_YAML, DP_OVERRIDES,
                                           counters)
    ctx = mesh.current()
    try:
        if ctx is None or ctx.group is None or ctx.n != 1:
            raise AssertionError(f"phase 25 ran without a one-rank group: "
                                 f"{ctx}")
        backend = torch.distributed.get_backend(ctx.group)
        log(f"dp: one-rank {backend} group; the captured graph of "
            f"{trainer.train_step.k} steps holds {nodes['all_reduce']} "
            f"all-reduce kernel nodes ({NCCL_KERNEL})")
        if backend != "nccl" or nodes["all_reduce"] != trainer.train_step.k:
            raise AssertionError(f"the graph holds {nodes['all_reduce']} "
                                 f"all-reduce nodes, one a step wanted")
        group_equals_plain(MAIN_YAML, DP_OVERRIDES, ctx)
        runs = {"plain": [], "group": []}
        trainers = {"plain": plain, "group": trainer}
        for key in ("plain", "group", "group", "plain"):
            with on_mesh(ctx if key == "group" else None):
                runs[key].append(call_ms(trainers[key], 2))
        ms = {k: sum(v) / len(v) for k, v in runs.items()}
        log(f"dp: ANPShapeNet1D graph ms/step: without a group "
            f"{ms['plain']}, one-rank NCCL group {ms['group']}, group / none "
            f"{ms['group'] / ms['plain']} (turns {json.dumps(runs)}, 2 calls "
            f"of 8 steps each) on {card}")
        check_profile_trace(trainer, "ANPShapeNet1D one-rank group")
    finally:
        del trainer
        gc.collect()
        torch.cuda.synchronize()
        stop_mesh(ctx)
    return launches


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if argv[:1] == ["--tp-worker"]:          # phase 27's ranks
        return tp_worker(int(argv[1]), argv[2], argv[3])
    from wmfml_tpu_torch.cli.common import set_numerics
    from wmfml_tpu_torch.configs import Config
    from wmfml_tpu_torch.kernels import build
    from wmfml_tpu_torch.kernels.favor import favor_attention
    from wmfml_tpu_torch.kernels.features import maml_features
    from wmfml_tpu_torch.kernels.image_da import image_da
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
        f"warpgroups), stem backward (K1b) "
        f"{libs['stem_bwd'].wmfml_stem_bwd_smem_bytes(1, 0)} B (Ci = 1) "
        f"and {libs['stem_bwd'].wmfml_stem_bwd_smem_bytes(1, 1)} B (bf16), "
        f"features conv "
        f"{libs['features'].wmfml_features_smem_bytes(14)} B (W = 14), "
        f"favor {libs['favor'].wmfml_favor_smem_bytes(15, 15, 64, 266)} B used "
        f"of the 231424 B it requests (Nq = Nk = 15, m = 266); favor "
        f"co-resident blocks {libs['favor'].wmfml_favor_coresident()}, wide "
        f"form {libs['favor'].wmfml_favor_wide_coresident()}")
    log("build: image_da launch geometry (threads, shared memory, blocks "
        "an SM holds, waves at the path's images; 128 x 128 uint8, "
        "ShapeNet3D's 64 x 64 RGB): " + json.dumps(image_da_geometry()))
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
    # the SingleTask and refinement paths' K1 and K2 (phase 19): K1 on R1's
    # refine batch of 25 images (count 25: one task's 25 context images as
    # the queries), K2's narrow form at O1's single task (T = 1: 8 (task,
    # head) items, Nq = Nk = 25, every row real), K2's wide form at Q2's
    # shape (all 30 views as queries, Nk 15) with Q2's projection
    gen_st = torch.Generator(device="cuda").manual_seed(10)
    proj = build_model(Config(os.path.join(PLOT_DIR, "ANP_ShapeNet3D.yaml"),
                              ONE_PLOT_OVERRIDES, make_dirs=False)
                       ).attn.projection_matrix.cuda()
    rows += [check_stem(build_model(Config(ST_YAMLS["ShapeNet1D"],
                                           TRAIN_OVERRIDES,
                                           make_dirs=False)).cuda(),
                        gen_st, path="Refine ShapeNet1D", images=25,
                        name="literature_stem_R1"),
             check_favor(anp, gen_st, tasks=1, path="One task ANP", n=25),
             check_favor_wide(proj, gen_st, 30, 15, "favor_attention_wide_q2",
                              "Plot ANP ShapeNet3D")]
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
    check_validation_loss(mtrainer, exact=True)
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
    # phase 24: the phase-layout trunk stem (ROADMAP.md B8b)
    p24_launches = s2d_phase(card, {"D1": d1trainer, "D5": d5trainer,
                                    "S6": s6trainer}, d_anp_kernels)
    stamp("phase 24, trunk_stem s2d")
    # phase 25: data parallelism on a one-rank NCCL group (ROADMAP.md A18)
    p25_launches = dp_phase(card, trainer, anp_kernels)
    check_favor_kmax(torch.Generator(device="cuda").manual_seed(11),
                     {"favor_attention": anp.attn.projection_matrix,
                      "favor_attention_wide":
                      d1trainer.model.attn.projection_matrix})
    stamp("phase 25, the data axis on one rank")
    # phase 26: conv_bwd phase, K1b (ROADMAP.md B8a)
    gen_k1b = torch.Generator(device="cuda").manual_seed(26)
    k1b_rows = [check_stem_backward(anp, gen_k1b),
                check_stem_backward(anp, gen_k1b, torch.bfloat16),
                check_stem_backward(anp, gen_k1b, torch.bfloat16, tasks=40,
                                    off_path=True),
                check_stem(anp, gen_k1b, path="ANP phase", route=True),
                check_stem(anp, gen_k1b, torch.bfloat16, path="ANP phase",
                           route=True)]
    for r in k1b_rows:
        r["floor_ms"] = floor
        if r.get("off_path"):
            r["off_path"] = ("no shipped configuration runs conv_bwd: phase "
                             "at T = 40 (P3 T40 runs xla)")
    rows += k1b_rows
    p26_launches = phase_bwd_phase(card, trainer)
    stamp("phase 26, conv_bwd phase (K1b)")
    # phase 27: the tensor-parallel model axis on two ranks (ROADMAP.md A18c)
    p27_launches = tp_phase(card)
    stamp("phase 27, the model axis on two ranks")
    # graph replays against the same steps issued from the host, bit for
    # bit, on fresh trainers (phase 18's M1 and F2 among them), before
    # phase 18 builds its trainers: the process's earlier state is the one
    # these checks have always run in (cuDNN picks its bf16 MAML engines
    # from it)
    for yaml, overrides in ((MAIN_YAML, TRAIN_OVERRIDES),
                            (MAIN_YAML, BF16_OVERRIDES + GRAPH_LOOP_K8),
                            (MAML_YAML, MAML_OVERRIDES),
                            (PERF_MAML_YAML, PERF_MAML_OVERRIDES),
                            (PASCAL_YAML, PASCAL_OVERRIDES),
                            (PERF_ANP_YAML, PERF_ANP_OVERRIDES + GRAPH_LOOP_K8),
                            (PERF_ANP_T40_YAML,
                             PERF_ANP_OVERRIDES + GRAPH_LOOP_K8),
                            (DISTRACTOR_YAML, DISTRACTOR_OVERRIDES),
                            (S3D_YAML, S3D_OVERRIDES),
                            (S3D_PERF_YAML, S5_OVERRIDES + GRAPH_LOOP_K8),
                            (MR_ANP_YAML, TRAIN_OVERRIDES),
                            (FCL_ANP_YAML, DISTRACTOR_SHORT_OVERRIDES)):
        graph_equals_loop(yaml, overrides)
    stamp("graph against loop, bit for bit")
    # phase 18: MR and FCL (ROADMAP.md A13): M1-M3, F1-F3, E1
    m1trainer, m1_launches, m1_nodes = train_phase(
        card, MR_ANP_YAML, TRAIN_OVERRIDES, anp_kernels, tap=tap_sample)
    check_mr_validation(m1trainer)
    m2trainer, m2_launches, m2_nodes = train_phase(
        card, MR_MAML_YAML, MR_MAML_OVERRIDES, maml_kernels,
        tap=tap_sample)
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
    # phase 19: SingleTask and refinement (ROADMAP.md A14): T1-T3, R1, R2,
    # O1, O2, Q1-Q3
    t1trainer, t1_launches, t1_nodes = single_task_phase(
        card, ST_YAMLS["ShapeNet1D"], TRAIN_OVERRIDES,
        {"literature_stem": literature_stem, **da_kernels})
    t2trainer, t2_launches, t2_nodes = single_task_phase(
        card, ST_YAMLS["Distractor"], DISTRACTOR_SHORT_OVERRIDES, da_kernels)
    t3trainer, t3_launches, t3_nodes = single_task_phase(
        card, ST_YAMLS["ShapeNet3D"], S3D_SHORT_OVERRIDES, da_kernels)
    stamp("phase 19: T1-T3")
    r1_launches = check_refinement("R1", REFINE_YAMLS["ShapeNet1D"],
                                   t1trainer, "shapenet_1d", range(1, 26))
    r2_launches = check_refinement("R2", REFINE_YAMLS["Distractor"],
                                   t2trainer, "distractor", (1, 13, 25))
    stamp("phase 19: R1, R2")
    o1_launches = check_one_task(
        "O1", os.path.join(ONE_TASK_DIR, "ANP_ShapeNet1D.yaml"), trainer)
    o2_launches = check_one_task(
        "O2", os.path.join(ONE_TASK_DIR, "CNP_max_Distractor.yaml"),
        d2trainer)
    q1_launches = check_plot(
        "Q1", os.path.join(PLOT_DIR, "ANP_ShapeNet1D.yaml"), trainer)
    q2_launches = check_plot(
        "Q2", os.path.join(PLOT_DIR, "ANP_ShapeNet3D.yaml"), s1trainer)
    q3_launches = check_plot(
        "Q3", os.path.join(PLOT_DIR, "CNP_max_Distractor.yaml"), d2trainer)

    stamp("phase 19, SingleTask and refinement")
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
         "FCLCNPDistractor (F3)": f3trainer,
         "SingleTaskShapeNet1D (T1)": t1trainer,
         "SingleTaskDistractor (T2)": t2trainer,
         "SingleTaskShapeNet3D (T3)": t3trainer},
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
               "FCLANP (F2)": 1, "FCLCNPDistractor (F3)": 1,
               "SingleTaskShapeNet1D (T1)": 1,
               "SingleTaskDistractor (T2)": 1,
               "SingleTaskShapeNet3D (T3)": 1},
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
               "FCLCNPDistractor (F3)": f3_nodes,
               "SingleTaskShapeNet1D (T1)": t1_nodes,
               "SingleTaskDistractor (T2)": t2_nodes,
               "SingleTaskShapeNet3D (T3)": t3_nodes},
        profile="--profile" in argv)
    stamp("graph against loop, timed")
    # phase 18's and 19's graphs and their pools (about 20 GB) go before
    # phase 21 and the determinism check build their trainers (M1's after
    # phase 21's validation sweeps)
    del m2trainer, m3trainer, f1trainer, f2trainer, f3trainer
    del t1trainer, t2trainer, t3trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"memory: {torch.cuda.memory_reserved() / 2 ** 30} GiB reserved "
        f"before phase 21")
    # phase 21: the device_data switch both ways (ROADMAP.md A21, A26)
    h1trainer, h1_launches = host_stream_phase(card, trainer, anp_kernels)
    del h1trainer
    h2trainer, h2_launches = shapenet3d_stream_phase(card, s1trainer,
                                                     d_anp_kernels)
    del h2trainer
    h3trainer, h3_launches = distractor_stream_phase(card, d1trainer,
                                                     d_anp_kernels)
    del h3trainer
    stamp("phase 21: H1, H2, H3")
    v1_launches = {
        "ANP device validation": check_device_validation(trainer, "ANP"),
        "MAML device validation": check_device_validation(
            mtrainer, "MAML", episodes=5, eager=False),
        "MR ANP device validation": check_device_validation(m1trainer,
                                                            "M1")}
    stamp("phase 21: V1")
    v2_launches = {
        "ANP eval sweep": check_device_evaluation(
            "ANPShapeNet1D", EVAL_YAML, EVAL_OVERRIDES, trainer,
            no_graph=True),
        "Pascal eval sweep": check_device_evaluation(
            "P4", PASCAL_YAML, PASCAL_EVAL_OVERRIDES + ["val_iters=2"],
            ptrainer),
        "Distractor eval sweep": check_device_evaluation(
            "D4 ANPDistractor", DISTRACTOR_EVAL_YAML,
            DISTRACTOR_EVAL_OVERRIDES + ["method=ANPDistractor",
                                         "agg_mode=attention"], d1trainer),
        "ShapeNet3D eval sweep": check_device_evaluation(
            "S4", S3D_EVAL_YAML, S3D_EVAL_OVERRIDES, s1trainer)}
    log(f"memory: {torch.cuda.max_memory_reserved() / 2 ** 30} GiB "
        f"reserved at most so far, {torch.cuda.memory_reserved() / 2 ** 30} "
        f"GiB now")
    stamp("phase 21, the device_data switch")
    # every trainer but phase 7's (the remat rows' none) has done its work
    del m1trainer, trainer, btrainer, bmtrainer, ptrainer, pftrainer
    del pmtrainer, ftrainer, f40trainer, d1trainer, d2trainer, d3trainer
    del d5trainer, s1trainer, s2trainer, s3trainer, s5trainer, s6trainer
    gc.collect()
    torch.cuda.empty_cache()
    # phase 20: MMAML (ROADMAP.md A16)
    mmtrainer, mmaml_launches, mmaml_nodes = mmaml_phase(card)
    stamp("phase 20, MMAML")
    # phase 22: maml_remat step and dots on MAML and MMAML (ROADMAP.md A19)
    remat_launches = remat_phase(card, {
        "MAMLShapeNet1D": (MAML_YAML, MAML_REMAT_OVERRIDES, maml_kernels,
                           mtrainer, maml_nodes),
        "MMAMLShapeNet1D": (MMAML_YAML, MMAML_OVERRIDES, da_kernels,
                            mmtrainer, mmaml_nodes)})
    del mtrainer
    stamp("phase 22, maml_remat")
    # phase 23: MMAML in bfloat16 (ROADMAP.md A27)
    mbtrainer, mmaml_bf16_launches = mmaml_bf16_phase(card, mmtrainer,
                                                      mmaml_nodes)
    del mbtrainer, mmtrainer
    gc.collect()
    torch.cuda.empty_cache()
    stamp("phase 23, MMAML in bf16")
    graph_equals_loop(MMAML_YAML, MMAML_OVERRIDES)
    stamp("phase 20, MMAML graph = loop")
    # cuDNN's determinism: its cost a step on two paths (ROADMAP.md C2
    # records MAML's and S1's from earlier runs)
    determinism_turns(
        {"ANPShapeNet1D": (MAIN_YAML, TRAIN_OVERRIDES),
         "ANPDistractor": (DISTRACTOR_YAML, DISTRACTOR_OVERRIDES)},
        calls={"ANPShapeNet1D": 2, "ANPDistractor": 1})

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
                "MR eval": e1_launches,
                "SingleTask ShapeNet1D": t1_launches,
                "SingleTask Distractor": t2_launches,
                "SingleTask ShapeNet3D": t3_launches,
                "Refine ShapeNet1D": r1_launches,
                "Refine Distractor": r2_launches,
                "One task ANP": o1_launches,
                "One task CNP Distractor": o2_launches,
                "Plot ANP ShapeNet1D": q1_launches,
                "Plot ANP ShapeNet3D": q2_launches,
                "Plot CNP Distractor": q3_launches,
                "MMAML": mmaml_launches,
                "MMAML bf16": mmaml_bf16_launches,
                **remat_launches,
                "ANP phase": p26_launches["f32"],
                "ANP phase bf16": p26_launches["bf16"]}
    log("launches on the new paths (phases 20, 22, 23): " + json.dumps(
        {k: launches[k] for k in list(launches)[-6:]}))
    # phase 21's paths, each beside the row path whose shapes it runs
    phase21 = {"ANP host-streamed (H1)": ("ANP", h1_launches),
               "ShapeNet3D host-streamed (H2)": ("ShapeNet3D ANP",
                                                 h2_launches),
               "Distractor host-streamed (H3)": ("Distractor ANP",
                                                 h3_launches),
               **{f"{k} (V1)": (k.replace(" device validation", ""), v)
                  for k, v in v1_launches.items()},
               "Distractor eval device sweep (V2)": (
                   "Distractor eval", v2_launches["Distractor eval sweep"]),
               "ShapeNet3D eval device sweep (V2)": (
                   "ShapeNet3D eval", v2_launches["ShapeNet3D eval sweep"])}
    later = {"MMAML (P20)": ("MAML", mmaml_launches),
             "MMAML bf16 (P23)": ("MAML bf16", mmaml_bf16_launches),
             **{f"{k} (P22)": ("MAML", v) for k, v in remat_launches.items()}}
    # phases 24 and 25's paths, each beside the row path whose shapes it
    # runs
    slice19 = {"D1 s2d (P24)": ("Distractor ANP", p24_launches["D1"]),
               "D5 s2d (P24)": ("Distractor ANP bf16", p24_launches["D5"]),
               "S6 s2d (P24)": ("ShapeNet3D ANP bf16", p24_launches["S6"]),
               "ANP one-rank NCCL (P25)": ("ANP", p25_launches)}
    log("launches on phases 24 and 25's paths: " + json.dumps(
        {k: v for k, (_, v) in slice19.items()}))
    # phases 26 and 27's paths, each beside the row path whose shapes it
    # runs (phase 27 on each of its ranks)
    slice20 = {"phase26_launches": {
        "ANP conv_bwd phase (P26)": ("ANP", p26_launches["f32"]),
        "ANP conv_bwd phase bf16 (P26)": ("ANP bf16", p26_launches["bf16"])},
        "phase27_launches": {name: ("ShapeNet3D ANP", got)
                             for name, got in p27_launches.items()}}
    log("launches on phases 26 and 27's paths: " + json.dumps(
        {k: {n: v for n, (_, v) in d.items()} for k, d in slice20.items()}))
    log("launches on phase 21's paths: " + json.dumps(
        {**{k: v for k, (_, v) in phase21.items()},
         **{f"{k} (V2)": v for k, v in v2_launches.items()}}))
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
        # phase 21's paths that run this kernel at this row's shapes (the
        # same model and data as the row's path, in the row's dtype)
        new = {name: got.get(key, 0) for name, (path, got) in phase21.items()
               if path == r["path"] and got.get(r["kernel"], 0) > 0}
        if new:
            r["phase21_launches"] = new
            if min(new.values()) <= 0:
                raise AssertionError(f"{r['name']}: no {key} launch on "
                                     f"phase 21's {new}")
        # phases 20, 22 and 23: MMAML's K6 at the MAML path's shapes (f32
        # and bf16), the remat paths' K1, K3 and K6
        new = {name: got.get(key, 0) for name, (path, got) in later.items()
               if path == r["path"] and got.get(r["kernel"], 0) > 0}
        if new:
            r["phase22_launches"] = new
            if min(new.values()) <= 0:
                raise AssertionError(f"{r['name']}: no {key} launch on "
                                     f"{new}")
        # phases 24 and 25: the s2d trunk paths' K2 wide and K6, the
        # one-rank group's K1, K2 and K6
        new = {name: got.get(key, 0) for name, (path, got) in slice19.items()
               if path == r["path"] and got.get(r["kernel"], 0) > 0}
        if new:
            r["phase24_launches"] = new
            if min(new.values()) <= 0:
                raise AssertionError(f"{r['name']}: no {key} launch on "
                                     f"{new}")
        # phases 26 and 27: conv_bwd phase's K1, K2 and K6, and each TP
        # rank's K2 wide and K6 program 6
        for field, paths in slice20.items():
            new = {name: got.get(key, 0) for name, (path, got)
                   in paths.items()
                   if path == r["path"] and got.get(r["kernel"], 0) > 0}
            if new:
                r[field] = new
                if min(new.values()) <= 0:
                    raise AssertionError(f"{r['name']}: no {key} launch on "
                                         f"{new}")
    log("time: host seconds in each helper over the run (nested calls "
        "counted in each): " + json.dumps({k: round(v, 1) for k, v in
                                           SPENT.items()}))
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
