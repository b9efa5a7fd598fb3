#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. card identity (name and power limit from nvidia-smi, torch and CUDA);
2. build every CUDA kernel of ``maskplanner_tpu_torch/csrc`` with nvcc;
3. the serving kernels against their plain PyTorch versions on the card, at
   the flagship shapes with a batch of 64: FPS indices identical at batch
   64 and 1, and on clouds of duplicated points and of sizes that leave the
   kernel's last warp partly empty; an FPS start index out of range traps
   the kernel in a child process, which must exit non-zero; fused SA
   forward indices identical, pooled max|Δ| <= 1e-4 · max|ref|, and two
   launches' pooled outputs bitwise equal; times (FPS also at batch 1 and
   a step), and bounds by the f32 rule and by the design's mix (products
   on the tensor cores in 3xTF32);
4. the flagship forward (``config=[maskplanner,windows_v2,longx_v2]``,
   seeded weights) on 64 clouds of the synthetic windows-v2 data: finite
   outputs of the right shapes, FPS and the fused SA forward launched
   exactly twice each, 2 samples on the CPU (plain ops) within
   1e-4 · max|ref|; forward time at batch 64 and 1, and device time by
   kernel at both;
5. serving end to end: a run dir with the frozen config and a port
   checkpoint, an OBJ mesh, ``Predictor(device="cuda").predict_program``
   with ``cover_all=True``; per-request latency;
6. the training kernels at the training shapes (a batch of 64 of the
   synthetic windows-v2 train split, the seeded model): the fused SA
   backward (K1 ``fused_sa_bwd`` then K2 ``sa_weight_grad``) at sa1 and sa2
   against autograd through the plain level, each gradient held against
   the same level in float64: its rms error within 3 x the larger of the
   plain float32 version's and 5e-4 of the norm (see
   ``check_against_exact``), every positive max-pool output's gradient
   routed (``check_routing``), the weight gradients bitwise equal across
   two launches (``check_deterministic``), K1 and K2 timed apart; the
   nearest-neighbour argmin at the step's three calls with their real
   masks, and on inputs with exact ties on a grid (d 6 and 24), a mask
   that is not a prefix and sizes that are multiples of no tile, indices
   identical; each call timed, and a second bound, this design's f32
   instruction floor; the LAP on the
   step's real 64 x 22 x 22 costs, permutations of equal total cost
   (1e-5 relative), its chain floor (the longest problem's dependent
   steps x the cycles a step of ``csrc/lap.cu``'s note, at the SM clock)
   and ns a dependent step, and on both of its paths' edges (n in {1, 2,
   21, 31, 32, 33, 64, 128} at batch 1 and 64, random and integer costs,
   permutations within 1e-5 relative of the plain version's total cost);
   median times, bounds (for K1 and K2 also by the design's mix), the
   library yardstick ``torch.cdist(x, y).argmin(-1)`` for the argmin;
7. one training step at batch 64: every kernel's launches counted, exactly
   fps 2, fused_sa_fwd 2, fused_sa_bwd 2, sa_weight_grad 2, nn_argmin 3,
   lap 1;
8. the card against the CPU (plain ops) on 2 samples of the batch: the loss
   within 1e-4 relative, every parameter gradient's rms difference within
   1e-3 of its norm plus a float32 rounding allowance measured against the
   CPU step in float64;
9. 30 Adam steps on the batch of 64: finite losses, the last below the
   first;
10. step time at batch 64 (host clock, median of 10) and device time by
    kernel for one step (torch.profiler);
11. ``train_maskplanner.main`` for 2 epochs of 8 steps with
    ``profile=true``, on the driver's default path (the device-resident
    epoch, the step a CUDA graph; the first step runs eagerly and is then
    captured, every later step is a replay): the chrome trace of the second
    epoch holds 8 CUDA graph replays whose kernels, by their symbols, are
    phase 7's counts each (``trace_launches``, ``per_replay``), and the
    wrappers count the fused SA backward's kernels twice those (the eager
    step and the capture); its
    final eval's ``results/*.npy`` with the JAX
    dumps' keys (numpy, float32 outputs) and ``summary.json`` with
    ``last_eval_loss``, ``final_test_loss``, ``final_test_point-wise
    chamfer distance`` and ``test_inference_ms``; the eval CLI
    (``python -m maskplanner_tpu_torch.test_maskplanner --run RUN --model
    last --save``) in a child process exits 0 with the final eval's test
    loss within 1e-5 relative; then a ``Predictor`` serves the checkpoint
    it wrote;
12. the eval (``train.loop.evaluate``) at full width on 64 test clouds at
    batch 64 with ``pcd`` and ``stroke_masks_metrics`` and the
    single-sample latency, in f32 and in bf16 on the same weights: exactly
    fps 6, fused_sa_fwd (bf16: fused_sa_fwd_bf16) 6, nn_argmin 5 (the
    loss's 3, the pcd metric's 2) and lap 1 launches; finite results; the
    card's outputs scored on the CPU (the plain argmin) give the pcd
    within 1e-5 relative and the same stroke counts; the host time of an
    eval batch with its metrics and of the metrics alone, and
    ``test_inference_ms``; in f32 the nearest-neighbour argmin at the pcd
    metric's two searches (the predicted poses against the GT poses with
    the batch's real mask, the −100-padded GT poses against the predicted
    poses) with indices identical to the plain version, CUDA-event
    medians, bound, instruction floor and ``torch.cdist(x, y).argmin(-1)``;
13. resume on the card: three uninterrupted 2-epoch runs of the flagship
    on the driver's default (graphed) path, one stopped by SIGTERM after
    epoch 1 on the host loader's path (``device_dataset=false``) and
    resumed with ``resume=<run_dir>`` on the graphed path, one stopped on
    the graphed path and resumed on the host loader's, and a control
    resumed from a checkpoint whose Adam moments were zeroed; each
    parameter group's relative L2 distance from the first run, each
    resumed run's at most 2x the largest of the three uninterrupted pairs'
    distances plus 1e-6, the control's beyond that in some group;
14. the reference BatchNorm recipe (``model.norm=batch``, seeded weights,
    BatchNorm running statistics away from 0/1), its kernels against their
    plain versions at the step's sa1 and sa2 shapes (a batch of 64 of the
    train split, sa2's features from the model's sa1): the ball-group
    gather indices identical and values within 1e-6 · max|ref|, its
    backward within 1e-5 · max|ref| of autograd through the plain grouping,
    the ball query indices identical, the folded level pooled within
    1e-4 · max|ref|; times (the ball kernels' per level) and bounds (the
    folded level also by the design's mix); the ball-group gather, its
    single pass and the ball query on edge inputs (``ball_edge_cases``:
    batch 1, S off a block's queries, N below a warp and off the scan
    step, duplicated points, balls with fewer than K points and empty
    ones, K above N, rows off 16 bytes, one feature channel, a cloud past
    the staging limit): indices identical, values within 1e-6 · max|ref|,
    the single pass bit-equal;
15. the BatchNorm recipe's forward at batch 64: exactly fps 2 and
    ball_group 2 launches, finite outputs, 2 samples on the CPU within
    1e-4 · max|ref|, forward time at batch 64 and 1, one ``Predictor``
    request on a checkpoint of the model;
16. its training step at batch 64: exactly fps 2, ball_group 2, nn_argmin 3,
    lap 1 launches, the card against the CPU by phase 8's rule on 16
    samples (on 2, the heads' BatchNorms normalise 2 rows and amplify the
    encoder's float32 rounding past any fixed tolerance), 12 Adam steps
    with falling loss, step time and device time by kernel;
17. bf16 serving (``model.bf16=true``, the JAX CLI's default), both
    recipes, on the same weights as their f32 phases: the fused SA
    forward's bf16 mode at sa1 and sa2 (batch 64) against the plain bf16
    level, indices identical, pooled within 3 x the plain level's own
    spread between float32 and float64 sums of the same bf16 operands;
    the single-pass ball-group gather against its plain version, indices
    and values identical; times and bounds (bf16 products at the tensor
    cores' bf16 rate); each recipe's bf16 forward (exactly fps 2 and
    fused_sa_fwd_bf16 2, or fps 2 and ball_group_single 2), finite, 2
    samples on the CPU within a relative L2 error of 2e-2 (the JAX
    package's bf16 tolerance), the bf16 − f32 gap at batch 64, forward
    times and device time by kernel; a bf16 ``Predictor`` request each;
18. bf16 training (``model.bf16=true``), both recipes, on the same weights:
    the fused SA backward's bf16 mode (K1 ``fused_sa_bwd_bf16``, K2
    ``sa_weight_grad_bf16``) at sa1 and sa2 (batch 64, on the bf16
    forward's pooled output) against the plain bf16 backward, each
    gradient's rms error from the float64 plain level within 3 x the
    float32 plain level's (``check_against_exact``), every positive max
    routed, dW bitwise equal across two launches, times and bounds (bf16
    products at the tensor cores' bf16 rate, the function's own bytes;
    beside them ``design_bound_ms`` with the scratch rows this design
    writes and reads); each recipe's bf16 step
    (exactly fps 2, fused_sa_fwd_bf16 2, fused_sa_bwd_bf16 2,
    sa_weight_grad_bf16 2, nn_argmin 3, lap 1; or fps 2, ball_group_single
    2, nn_argmin 3, lap 1), 30 Adam steps with falling loss, the step time
    and device time by kernel, the card against the CPU on 16 samples (the
    step's loss within 2e-2 relative, which catches gross faults only;
    the train-mode outputs and the encoder levels' gradients for a fixed
    cotangent, by relative L2 error, within 0.6 of the CPU's own bf16 −
    f32 gap, where the card's f32 model, the control, must fail; see
    ``phase_bf16_card_vs_cpu``), the bf16 − f32 step gap at batch 64;
    ``train_maskplanner`` with ``model.bf16=true`` for 2 epochs, then a
    bf16 ``Predictor`` request on what it wrote, with phase 11's checks
    of its final eval and the eval CLI;
19. the health check on the fixture corpus, as ``bench.py`` runs it: the
    port's ``data/fixture_category.py`` writes cuboids-v2 (8 train, 2
    test, seed 7, deterministic) under a temporary ``PAINTNET_ROOT`` and
    ``train_maskplanner`` trains ``config=[maskplanner,cuboids_v2,
    longx_v2,debug]`` at pc_points 1024, batch 8 for 80 epochs, eval every
    40 (graphed); every loss finite and the last 10 epochs' mean train loss
    below the first epoch's; both evals' pcd printed;
20. the driver's default loop, both recipes in f32 and in bf16, on a
    staged synthetic windows-v2 train split of 512 items (8 steps of 64
    an epoch; its bytes printed) from the same seeded weights: (a) the host
    loader through the ``Prefetcher``, (b) the device-resident epoch run
    eagerly, three times, (c) the device-resident epoch as CUDA graph
    replays; in the first two graphed epochs (the eager first step, the
    capture, 15 replays) the wrappers count phase 7's, 16's or 18's
    kernels twice (the eager step and the capture), and a
    ``torch.profiler`` trace of a later epoch of 8 replays holds those a
    replay (by their symbols, ``trace_launches``, ``per_replay``); the
    graphed epochs
    leave the generator in the eager runs' state, their losses are finite
    and fall over 30 steps; after the capture an LR milestone, a PSACD step
    and a delayed activation update the tensors the graph reads, and from
    one state a graphed epoch's 8 losses lie within ``ONE_STATE_LOSS_TOL``
    of an eager epoch's (their mean relative difference), its parameters
    and BatchNorm statistics within ``ONE_STATE_PARAM_TOL`` and
    ``ONE_STATE_BN_TOL`` of the eager epoch's move, its Adam step counts
    and generator equal, where the control (the graph replayed with the LR
    zeroed) must fail both the losses and the state (``one_state``); after 2 epochs each parameter group's
    distance from the first eager run is logged, the graphed run's beside
    the eager pairs' (``phase_device_epoch``); for each loop ms a step
    (host clock, whole epochs ending in a synchronize), device busy ms a
    step (the union of the kernel intervals in a ``torch.profiler`` trace
    of one epoch; in the eager loops its wrapper counts must be the step's
    a step) and the idle share, 1 - busy / wall; the graph's private pool
    bytes;
21. warm starts (``model.pretrained_custom``): on phase 11's run at the
    flagship's width, a fresh model warm-started from it is bitwise its
    checkpoint (``fc3`` and ``fc_normals`` at the fresh init's unless
    ``model.load_strict``); on phase 19's run, 2 epochs of its recipe on
    the graphed loop warm-started with ``load_strict=true`` begin within
    ``WARM_START_SHARE`` of the source's fall from its last-10 mean, and
    the control (no warm start) must not;
22. coverage on phase 19's run, its test items: the eval CLI's ``--save``
    dumps through the port's three tools (``standalone/``: programs, spray
    thickness, coverage), the exported GT programs against the originals
    at least 0.9 on average, the predicted coverage printed per item; a
    ``Predictor`` on the card answers each test mesh, its program
    simulated and scored against the original's, with request and scoring
    ms;
23. the exported forward: ``torch.library.opcheck`` of every custom op
    (``ops/library.py``) on the card at sa1 and sa2; ``Predictor.
    export_compiled`` of the default recipe in f32 and bf16 at batch 1
    and 64 and of ``model.norm=batch`` in f32 and bf16 at batch 64,
    served in a child process that imports only ``load_exported``:
    launches exactly fps 2 and fused_sa_fwd 2 (bf16: fused_sa_fwd_bf16 2;
    the BatchNorm recipe ball_group 2 or ball_group_single 2), outputs
    within ``EXPORT_REL_TOL`` · max|ref| of the live ``Predictor.forward``
    (bitwise expected); host ms, median of 10, exported against live;
    beside that child, at once, ``predict --from_export`` in a child gives
    the live request's rows, ``predict --export`` in another writes a
    program bitwise the live forward, and a byte-flipped artifact's child
    exits non-zero;
24. the other recipes at the flagship's width, batch 64, f32: the paper's
    baselines ``segmentWise`` and ``pointWise`` (the symmetric segment
    chamfer with stroke masks, at λ=4 and at λ=1: 1350 segments of one
    6-value pose) and the composites ``asymm_chamfer_v11`` and
    ``symm_chamfer_v1``, each step's launches (exactly fps 2, fused_sa_fwd
    2, fused_sa_bwd 2, sa_weight_grad 2, lap 1 and nn_argmin 2, or 4 for
    symm_v1) and the card against the CPU on 2 samples by phase 8's rule
    (``pointWise``'s gradients for fixed seeded cotangents on the train
    forward's outputs: at random init its 1350 one-pose segments lie so
    close that rounding flips many matchings, so its loss's gradient is
    not comparable; its loss is held on identical inputs below);
    for the two baselines also phase 9's 30 steps, the step time and
    device time by kernel, and their graphed device-resident loop on a
    512-item split of their own (``recipe_epoch``: the wrappers count the
    step twice in the first 2 epochs, 30 falling losses, then ms a step,
    device busy ms a step, idle share, the replays' launches from a trace
    and the graph's pool bytes); the step captured with every new term
    that a CUDA graph takes (``ALL_TERMS``, at λ=4 and λ=1: 2 graphed
    epochs, the wrappers' counts, finite losses); every loss term of this
    slice at the
    flagship's shapes on 8 samples, value and ``y_pred`` gradient card
    against CPU within 1e-4 (relative; of max|ref|) plus 3 x the CPU's own
    float32 error (``phase_terms``); the argmin's d ≤ 8 instantiation at
    d = 3 on the attraction, velocity and centroid searches at batch 64
    and on ``nn_argmin_edges``, indices identical to the plain version,
    times, bound and ``torch.cdist(x, y).argmin(-1)`` (``phase_argmin_d3``);
    the regressor (``model.backbone=pointnet2 loss=[chamfer,repulsion]
    eval_metrics=[pcd]``) through ``train_maskplanner`` for 2 epochs of 8
    steps on the graphed loop with phase 11's trace (8 replays) and
    final-eval checks (no request: a ``Predictor`` serves the mask
    models);
25. the limits (``phase_limits``): the shapes past the small paths of
    #1, #4 and #5, which the JAX package computes, on the kernels' paths
    for them. FPS above 8192 points (``fps_large``): N 8193 and 16384 at
    batch 4 and 64, 60000 at batch 4, npoint 512, and the large path
    forced at 5120 points, indices identical to the plain version; a start
    index out of range at 8193 points traps in a child; the flagship
    forward at ``pc_points=16384``, batch 64: exactly fps 2 (fps_large 1)
    and fused_sa_fwd 2, finite, 2 samples on the CPU within
    1e-4 · max|ref|; at that size on 8 clouds a train-mode forward and
    backward of each recipe in f32 and bf16 with its step's launches and
    finite gradients, and the ball query identical to its plain version. The argmin above 128 coordinates
    (``nn_argmin_chunked``): d 129, 132, 192 and 384 with exact ties on a
    grid, a mask that is not a prefix and sizes off every tile, and the
    chunked path forced at d 6 and 24, indices identical; the training step
    at ``lambda_points=22`` (d 132), batch 64: exactly the step's
    launches with nn_argmin_chunked 2, the card against the CPU on 2
    samples by phase 8's rule. The LAP above 128 rows (``lap_large``): n
    129, 200 and 256 at batch 1 and 64, random and integer costs, and the
    large path forced at n 22 and 128, total costs within 1e-5 relative of
    the plain version's (run in child processes on the CPU); n 1024 and
    4096, random and integer, and 9000 (past the shared-memory cut),
    random, at batch 1 against ``scipy.optimize.linear_sum_assignment``
    (the oracle only, in child processes), with each one's Dijkstra steps
    and time; ``losses/stroke_losses.py::emd`` on 64 x 200 predictions
    against 50 GT rows, card against CPU within 1e-5 relative, its LAP's
    total within 1e-5 relative of the CPU's, with exactly lap 1
    (lap_large 1). Each new path's CUDA-event median at its
    main-path shape, plain time, bound (the LAP's also its chain floor,
    ``lap_large_step_cycles``; the argmin's its instruction floor);
26. the stroke-wise and start-of-path families (``phase_zoo``) at full
    width on the 64 train clouds, with every extra of ``load_extra_data``
    and ``max_n_stroke_points``, ``out_points_per_stroke`` and
    ``out_segments_per_stroke`` set to the longest GT stroke among them
    (printed), ``out_prototypes`` 44, tokens of 4 poses: the eval forwards
    of ``pointnet2_strokewise``, ``pointnet2_sops`` (with confidences) and
    ``pointnet2_3dbbox`` (a BatchNorm encoder), each with exactly the
    flagship's or the BatchNorm recipe's forward launches, 2 samples on the
    CPU within 1e-4 · max|ref|, ms at batch 64; #1, #2 and #3 at the
    stroke-wise model's sa1 and sa2 and #6 at the 3D-box model's against
    their plain versions (phase 6's and 14's rules); the nine loss names
    of the slice through ``LossHandler`` (exactly nn_argmin 4 and lap 2),
    each value and prediction gradient card against CPU by phase 8's
    rules, #4 on the stroke stack with indices identical and times, #5 on
    the 64 x 22 x 22 and 64 x 44 x 44 costs those terms gave it, totals
    equal to the plain version's, with times; the gradient of
    ``masked_mse_strokes_v2`` through the stroke-wise model (exactly fps
    2, fused_sa_fwd 2, fused_sa_bwd 2, sa_weight_grad 2, lap 1), card
    against CPU on 2 samples by phase 8's rule, ms at batch 64; the
    rollout (``mlp_rollout``, 20 steps from a cloud's 44 tokens) card
    against CPU, ``sop_metrics`` and ``sop_metrics_v2``; ``point_transformer``
    at its defaults, teacher-forced and autoregressive, card against CPU;
27. the segmenters and the GAN recipe (``phase_segmenters_gan``): (i)
    ``pointnet2_segmenter_v1`` (``ball_in_xyz_space``, ``latent_dim`` 64)
    on the 64 flagship train items' GT segments (449 of 24 values a
    cloud): FPS of 512 centres from 449 centroids identical to the plain
    version, the ball query (#7) at sa1 identical to ``ball_query_plain``
    with its time, plain time and bound; the eval forward (exactly fps 2,
    ball_query 1, ball_group 1), finite, 2 samples on the CPU within
    1e-4 · max|ref|, ms at batch 64; the train forward with
    ``contrastive_v1`` and its backward (the same launches); the latents,
    the loss and every gradient through the segmenter on 8 clouds card
    against CPU by phase 8's rule (``hold_rule``), in eval and in train
    mode (the same FPS starts), the uniform draw fed to both and the card
    making the CPU float32 run's ReLU and max-pool choices
    (``shared_choices``); the PaintNet
    segmenter (the BatchNorm recipe's forward launches) and ``pointnet``
    (none) at batch 64, each 2 samples on the CPU within 1e-4 · max|ref|.
    (ii)
    ``train_maskplanner`` with ``config=[pointWise,windows_v2,longx_v2]
    loss=[chamfer,wdiscriminator]`` for 2 epochs of 2 steps (the host
    loader; DGCNN at k 20 over 1350 poses): every loss and
    ``d_internal_train_loss`` finite, then a resume restoring the
    critic's state bitwise; the GAN step at batch 64 (exactly fps 2,
    fused_sa_fwd 2, fused_sa_bwd 2, sa_weight_grad 2, nn_argmin 2), ms a
    step, the critic's share, the peak memory; one minimax step; card
    against CPU (``phase_gan_card_vs_cpu``): the critic's update (loss,
    gradients, statistics) and the generator's term in float64 within
    1e-9, then in float32 by phase 8's rule on the CPU float64 run's
    critic graphs and choices (``critic_neighbours``,
    ``shared_choices``), with the generator's gradients through the
    critic on its graphs; every allowance printed; the phase's seconds;
28. data-parallel training (``phase_data_parallel``; ``parallel/``) and
    the multi-scale level. (a) A process group of one over NCCL around
    the graphed device-resident epoch of the default recipe at batch 64
    for 4 steps (``phase_dp_world_one``): at LR 0 its losses, terms,
    parameters, BatchNorm statistics, Adam step counts and generator
    bitwise those of the ungrouped graphed epoch from the same seeded
    state, and Adam's moments (K1's float atomics give two runs of one
    graph other last bits) within 2x the largest distance between 3
    ungrouped runs plus 1e-6 (``dp_within_noise``); at the config's LR the
    first loss bitwise and the parameters after 4 steps within that
    noise; a trace of two epochs of the grouped graph (8 replays) with
    the step's port kernels a replay (one rank's collectives launch
    nothing); host ms a
    step of both graphs in turns. (b) 2 ranks over gloo on
    the one card with CUDA tensors (``dp_worker``, processes started by the
    ``spawn`` method), the eager device-resident epoch on 32 rows each of
    a global batch of 64: the first step's global loss and all-reduced
    gradients held against the single process's eager step by phase 8's
    rule (``hold_rule``; the own error two single-process runs' distance,
    the BatchNorm-fed biases by their norm), after 3 steps the ranks'
    parameters bitwise equal, ms a step. (c) The same over NCCL, graphed,
    on two cards (and on four, where there are four), with NCCL kernels in
    a traced replay and their share of its busy time; with one card a line says ``not run: 1 device``. (d) ``SetAbstractionMsg``
    (``MSG_LEVEL``) at batch 64: exactly fps 1 and ball_query 3 launches,
    every scale's indices identical to ``ball_query_plain``'s, the
    forward's ms, #7's at the widest scale with plain time and bound;
29. the card line, a ``kernels`` JSON line (launches: the kernels that ran
    in the traced graphed epoch of 8 replays, the three large-shape paths'
    in phase 25's forward, step and ``emd``, the ball query's on the
    segmenter's eval forward; for the five kernels of the exported forward
    their custom op and the child's launches; the argmin's row also its
    launches a step in each recipe of phase 24 and its d = 3 numbers, the
    LAP's the n of those recipes; ``zoo_launches``, each kernel's launches
    on phase 26's paths, and for #4 and #5 their ``zoo`` times;
    ``segmenters_gan_launches``, each kernel's on phase 27's paths; the
    ball query's numbers its segmenter inputs', its own check's under
    ``own_check``, its launches and times on the multi-scale level under
    ``msg_*``), and the result line last.

It needs one CUDA card and the repository around it; without either it
exits non-zero.
"""
from __future__ import annotations

import contextlib
import copy
import collections
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
BATCH_NORM = "model.norm=batch"
BATCH = 64
REL_TOL = 1e-4
PEAK_F32_OPS = 67e12      # H100 SXM, f32 outside the tensor cores (op/s)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 (byte/s)
PEAK_TF32_OPS = 495e12    # H100 SXM, TF32 on the tensor cores (op/s)
PEAK_BF16_OPS = 989e12    # H100 SXM, dense bf16 on the tensor cores (op/s)
# bf16 card against CPU: the relative L2 error within the JAX package's bf16
# tolerance. Not a max: the bf16 pose assembly normalises small raw
# orientations, where one flipped bf16 rounding moves a single element by
# percents of max|ref| (the bf16 − f32 gap itself does so)
BF16_REL_TOL = 2e-2
# bf16 step, card against CPU: each output's and encoder level's relative
# L2 error within this share of the CPU's own bf16 − f32 gap (sound runs
# read at most 0.41 of it, the card's f32 model about 1)
BF16_GAP_SHARE = 0.6
F32_LANES = 128           # f32 add, multiply or compare lanes of an SM
KERNELS = {
    "fps": dict(source="maskplanner_tpu_torch/csrc/fps.cu",
                replaces="maskplanner_tpu/ops/pallas/fps.py:84"),
    "fused_sa_fwd": dict(
        source="maskplanner_tpu_torch/csrc/fused_sa_fwd.cu",
        replaces="maskplanner_tpu/ops/pallas/fused_sa_train.py:540"),
    "fused_sa_bwd": dict(
        source="maskplanner_tpu_torch/csrc/fused_sa_bwd.cu",
        replaces="maskplanner_tpu/ops/pallas/fused_sa_train.py:589"),
    # the backward's second kernel: the weight gradients
    "sa_weight_grad": dict(
        source="maskplanner_tpu_torch/csrc/sa_weight_grad.cu",
        replaces="maskplanner_tpu/ops/pallas/fused_sa_train.py:589"),
    "nn_argmin": dict(source="maskplanner_tpu_torch/csrc/nn_argmin.cu",
                      replaces="maskplanner_tpu/ops/pallas/nn_argmin.py:54"),
    "lap": dict(source="maskplanner_tpu_torch/csrc/lap.cu",
                replaces="maskplanner_tpu/ops/pallas/lap.py:150"),
    "ball_group": dict(
        source="maskplanner_tpu_torch/csrc/group_gather.cu",
        replaces="maskplanner_tpu/ops/pallas/group_gather.py:175"),
    "ball_query": dict(
        source="maskplanner_tpu_torch/csrc/group_gather.cu",
        replaces="maskplanner_tpu/ops/pallas/ball_query.py:62"),
    "fused_sa_folded": dict(
        source="maskplanner_tpu_torch/csrc/fused_sa_fwd.cu",
        replaces="maskplanner_tpu/ops/pallas/fused_sa.py:158"),
    # the bf16 modes of #2 and #6
    "fused_sa_fwd_bf16": dict(
        source="maskplanner_tpu_torch/csrc/fused_sa_fwd.cu",
        replaces="maskplanner_tpu/ops/pallas/fused_sa_train.py:540",
        mode='precision="default"'),
    "ball_group_single": dict(
        source="maskplanner_tpu_torch/csrc/group_gather.cu",
        replaces="maskplanner_tpu/ops/pallas/group_gather.py:175",
        mode="single_pass=True"),
    # the bf16 mode of #3 (bf16 training): K1 and K2
    "fused_sa_bwd_bf16": dict(
        source="maskplanner_tpu_torch/csrc/fused_sa_bwd.cu",
        replaces="maskplanner_tpu/ops/pallas/fused_sa_train.py:589",
        mode='precision="default"'),
    "sa_weight_grad_bf16": dict(
        source="maskplanner_tpu_torch/csrc/sa_weight_grad.cu",
        replaces="maskplanner_tpu/ops/pallas/fused_sa_train.py:589",
        mode='precision="default"'),
    # the paths for the shapes past the small paths' limits (phase 25),
    # whose launches the kernels' own counts include
    "fps_large": dict(source="maskplanner_tpu_torch/csrc/fps.cu",
                      replaces="maskplanner_tpu/ops/pallas/fps.py:84",
                      mode="more than 8192 points"),
    "nn_argmin_chunked": dict(
        source="maskplanner_tpu_torch/csrc/nn_argmin.cu",
        replaces="maskplanner_tpu/ops/pallas/nn_argmin.py:54",
        mode="more than 128 coordinates"),
    "lap_large": dict(source="maskplanner_tpu_torch/csrc/lap.cu",
                      replaces="maskplanner_tpu/ops/pallas/lap.py:150",
                      mode="more than 128 rows"),
}
# each large-shape path and the kernel whose count includes its launches
PATH_OF = {"fps_large": "fps", "nn_argmin_chunked": "nn_argmin",
           "lap_large": "lap"}


def launches_of(**counts) -> dict:
    """Every kernel's expected launches: the given counts, 0 elsewhere."""
    return {name: counts.get(name, 0) for name in KERNELS}


FORWARD_LAUNCHES = launches_of(fps=2, fused_sa_fwd=2)
STEP_LAUNCHES = launches_of(fps=2, fused_sa_fwd=2, fused_sa_bwd=2,
                            sa_weight_grad=2, nn_argmin=3, lap=1)
BN_FORWARD_LAUNCHES = launches_of(fps=2, ball_group=2)
BN_STEP_LAUNCHES = launches_of(fps=2, ball_group=2, nn_argmin=3, lap=1)
BF16_FORWARD_LAUNCHES = launches_of(fps=2, fused_sa_fwd_bf16=2)
BN_BF16_FORWARD_LAUNCHES = launches_of(fps=2, ball_group_single=2)
BF16_STEP_LAUNCHES = launches_of(fps=2, fused_sa_fwd_bf16=2,
                                 fused_sa_bwd_bf16=2, sa_weight_grad_bf16=2,
                                 nn_argmin=3, lap=1)
BN_BF16_STEP_LAUNCHES = launches_of(fps=2, ball_group_single=2, nn_argmin=3,
                                    lap=1)
# an eval batch with its single-sample latency: the batch's forward and the
# latency's two batch-1 forwards, the loss's 3 argmin searches and LAP, the
# pcd metric's 2 searches
EVAL_LAUNCHES = launches_of(fps=6, fused_sa_fwd=6, nn_argmin=5, lap=1)
BF16_EVAL_LAUNCHES = launches_of(fps=6, fused_sa_fwd_bf16=6, nn_argmin=5,
                                 lap=1)
EVAL_METRICS = ["pcd", "stroke_masks_metrics"]
# the paper's baselines (segmentWise, pointWise: the symmetric segment
# chamfer with stroke masks searches both directions) and the other shipped
# composites (v11: forward segments and reverse poses; symm_v1: both
# directions of segments and of poses), each step's launches
RECIPE_STEP_LAUNCHES = launches_of(fps=2, fused_sa_fwd=2, fused_sa_bwd=2,
                                   sa_weight_grad=2, nn_argmin=2, lap=1)
RECIPES = {
    "segmentWise": ("config=[segmentWise,windows_v2,longx_v2]",
                    RECIPE_STEP_LAUNCHES),
    "pointWise": ("config=[pointWise,windows_v2,longx_v2]",
                  RECIPE_STEP_LAUNCHES),
    "asymm_chamfer_v11": ("config=[asymm_chamfer_v11,delayMasksLoss,"
                          "traj_sampling_v2,sched_v9,windows_v2,longx_v2]",
                          RECIPE_STEP_LAUNCHES),
    "symm_chamfer_v1": ("config=[symm_chamfer_v1,delayMasksLoss,"
                        "traj_sampling_v2,sched_v9,windows_v2,longx_v2]",
                        launches_of(fps=2, fused_sa_fwd=2, fused_sa_bwd=2,
                                    sa_weight_grad=2, nn_argmin=4, lap=1)),
}
# the card-against-CPU rules (``phase_card_vs_cpu``) that a recipe's step
# asks for beyond the main path's. pointWise at random init puts 1350
# one-pose segments so close that a rounding flips many matchings (the CPU's
# own float32 gradient lies 0.6% from float64 and the card's 2.6% over 16
# samples; its loss 1.9e-3 relative from the CPU's against the CPU's own
# 1.0e-3), so its gradients are held for fixed cotangents on the outputs
# (its loss terms' gradients on the card are phase_terms') and its loss
# within its own error. asymm_chamfer_v11's fc2.bias, which bn2
# normalises, has gradient 0 in exact arithmetic, and its rounding noise on
# the card lies just over 3 x the CPU's, so the BatchNorm-fed biases are
# held by their norm.
RECIPE_RULES = {"pointWise": dict(cotangent=True, loss_own=True),
                "asymm_chamfer_v11": dict(zero_biases=True)}
# the new terms that a CUDA graph captures, in one step each (align and
# intra_align take singular values, which do not capture): at λ=4 the
# symmetric segment and pose chamfers 2 searches each, the stochastic
# reverse chamfer 1, the attraction chamfer 2, the rich attraction, the
# repulsion and Sinkhorn's EMD none; at λ=1 the velocity cosine none
ALL_TERMS = [
    ("all-terms-epoch", RECIPES["segmentWise"][0],
     "loss=[chamfer_with_stroke_masks,stoch_reverse_asymm_segment_chamfer,"
     "attraction_chamfer,rich_attraction_chamfer,repulsion,emd,"
     "symm_point_chamfer]",
     launches_of(fps=2, fused_sa_fwd=2, fused_sa_bwd=2, sa_weight_grad=2,
                 nn_argmin=7, lap=1)),
    ("all-terms-λ1-epoch", RECIPES["pointWise"][0],
     "loss=[chamfer_with_stroke_masks,velcosine,repulsion]",
     RECIPE_STEP_LAUNCHES),
]
# the plain regressor (the pointnet2 backbone) on the flagship's data: the
# symmetric chamfer's 2 searches, the repulsion's neighbours in plain ops,
# no masks and so no LAP
REGRESSOR = ["model.backbone=pointnet2", "loss=[chamfer,repulsion]",
             "eval_metrics=[pcd]"]
REGRESSOR_STEP_LAUNCHES = launches_of(fps=2, fused_sa_fwd=2, fused_sa_bwd=2,
                                      sa_weight_grad=2, nn_argmin=2)
# the keys of the JAX eval loop's .npy dumps (maskplanner_tpu/train/loop.py),
# which render_results.py and standalone/ read
DUMP_KEYS = {"dirnames", "traj", "stroke_ids", "stroke_ids_as_pc",
             "traj_as_pc", "traj_pred", "pred_stroke_masks",
             "stroke_masks_scores", "seg_logits", "n_strokes", "point_cloud",
             "batch", "suffix"}
SUMMARY_KEYS = ("last_eval_loss", "final_test_loss",
                "final_test_point-wise chamfer distance", "test_inference_ms")
# the device-resident epochs' split: 8 steps of 64 an epoch
EPOCH_ITEMS = 512
# the graphed epoch against the eager one from one state (``one_state``):
# the mean of the 8 losses' relative differences, and the share of the
# eager epoch's own move, over all groups, of the parameters and of the
# BatchNorm statistics. Over 16 readings sound runs read at most 1.8e-4,
# 0.162 and 0.05 (the scatters' summation order, amplified over 8 steps),
# the control (the LR zeroed in the graph) at least 2.8e-3, 1.0 and 0.189;
# each limit between the two (PERF.md §6). Adam's moments are not gated:
# there the two overlap (sound up to 0.39, the control down to 0.33)
ONE_STATE_LOSS_TOL = 7e-4
ONE_STATE_PARAM_TOL = 0.4
ONE_STATE_BN_TOL = 0.1
# the health check on the fixture corpus (bench.py's recipe)
HEALTH = ["config=[maskplanner,cuboids_v2,longx_v2,debug]",
          "dataset=cuboids-v2", "pc_points=1024", "traj_points=512",
          "n_pred_traj_points=256", "max_n_strokes=12",
          "traj_with_equally_spaced_points=false", "data_scale_factor=800.0",
          "batch_size=8", "epochs=80", "eval_freq=40", "no_save=false",
          "skip_rendering=true", "seed=7"]
HEALTH_CORPUS = dict(n_train=8, n_test=2, seed=7, deterministic=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from maskplanner_tpu_torch.ops.cuda import launch_counters

    return launch_counters()


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters().items()}


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events), the
    host's launch gap included."""
    from maskplanner_tpu_torch.bench_fps_argmin import median_ms as timed

    return timed(fn, reps, warmup)


def median_host_s(fn, reps: int, warmup: int = 1) -> float:
    """Median wall time of ``fn`` ending in a device synchronize."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def busy_ms(kernels: list) -> float:
    """The union of a chrome trace's kernel intervals, ms: the time the
    card ran at least one kernel."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(
            e.get("dur", 0))) for e in kernels):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def traced_kernels(fn) -> list:
    """The card's kernels in a ``torch.profiler`` chrome trace of ``fn``."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


# replays a trace held by ``per_replay`` spans: phase 18's trace of two
# replays lost four of one replay's records (fps 2, fused_sa_fwd_bf16 2),
# which the rounding over 2 replays cannot absorb (PERF.md §6)
TRACED_REPLAYS = 8


def per_replay(traced: dict, replays: int, expect: dict, what: str) -> dict:
    """Hold a trace of ``replays`` replays of a captured step against the
    step's counts ``expect``: each kernel's traced count over the replays,
    rounded, must be its count a step, and no count may exceed ``replays``
    times it. A fault of the capture moves a count by a multiple of the
    replays; the profiler's lost records (``trace_launches``) move it by
    one to four, and are logged -> the rounded counts a replay. Hold
    ``TRACED_REPLAYS`` replays: the rounding absorbs up to a whole lost
    replay in 8, not in 2."""
    want = {k: v * replays for k, v in expect.items()}
    rounded = {k: int(v / replays + 0.5) for k, v in traced.items()}
    if rounded != expect or any(v > want[k] for k, v in traced.items()):
        raise AssertionError(f"{what}: {replays} replays launched {traced}, "
                             f"{expect} a replay expected")
    lost = {k: want[k] - v for k, v in traced.items() if v != want[k]}
    if lost:
        log(f"{what}: the trace lacks {lost} kernel record(s) of "
            f"{sum(want.values())}")
    return rounded


# the port's kernel symbols (``csrc/*.cu``), each in its source's anonymous
# namespace
KERNEL_SYMBOLS = ("fps_kernel", "fused_sa_fwd_kernel", "fused_sa_bwd_kernel",
                  "dw_partial", "vec_partial", "::finish(", "nn_argmin_kernel",
                  "lap_warp_kernel", "lap_block_kernel", "ball_group_kernel",
                  "fps_large_kernel", "nn_argmin_chunked_kernel",
                  "lap_large_kernel")


def kernel_of(symbol: str) -> str | None:
    """The ``KERNELS`` name of a kernel in a chrome trace, by its demangled
    symbol in its source's anonymous namespace (a template's with its
    return type, ``void``; a plain function's without), or None for any
    other kernel. Where one symbol serves several modes its template
    arguments
    tell them apart; #8 runs #2's f32 kernel, so a trace counts it as
    ``fused_sa_fwd`` (no training path runs #8). K2's two other kernels,
    which each of its calls launches after ``dw_partial``, come back as
    ``k2_vec_partial`` and ``k2_finish``."""
    m = re.match(
        r"(?:void )?\(anonymous namespace\)::(\w+)(?:<([^()]*)>)?\(", symbol)
    if m is None:
        return None
    name = m.group(1)
    args = [a.strip() for a in (m.group(2) or "").split(",")]
    if name == "fused_sa_fwd_kernel":     # <kResident, kBf16>
        return "fused_sa_fwd_bf16" if args[1] == "true" else "fused_sa_fwd"
    if name == "fused_sa_bwd_kernel":     # <kBf16>
        return "fused_sa_bwd_bf16" if args[0] == "true" else "fused_sa_bwd"
    if name == "ball_group_kernel":       # <kGather, kStaged, Out>
        if args[0] == "false":
            return "ball_query"
        return "ball_group_single" if "bfloat16" in args[2] else "ball_group"
    return {"fps_kernel": "fps", "dw_partial": "sa_weight_grad",
            "dw_partial_bf16": "sa_weight_grad_bf16",
            "vec_partial": "k2_vec_partial", "finish": "k2_finish",
            "nn_argmin_kernel": "nn_argmin", "lap_warp_kernel": "lap",
            "lap_block_kernel": "lap", "fps_large_kernel": "fps_large",
            "nn_argmin_chunked_kernel": "nn_argmin_chunked",
            "lap_large_kernel": "lap_large"}.get(name)


def trace_launches(kernels: list) -> dict:
    """Each kernel's launches in a trace's kernel events (``kernel_of``),
    every ``KERNELS`` name, 0 where none ran: what ran on the card, graph
    replays included. Fails unless K2's two other kernels ran once for
    each of its ``dw_partial`` launches. The profiler loses a kernel record
    now and then (about one in ten traced epochs lacked one of its FPS or
    forward launches, eager or replayed: PERF.md §6), so a trace's counts
    are held by ``per_replay``."""
    counts = collections.Counter(kernel_of(e.get("name", ""))
                                 for e in kernels)
    missed = {e.get("name", "") for e in kernels
              if kernel_of(e.get("name", "")) is None} & {
        e.get("name", "") for e in kernels if any(
            sym in e.get("name", "") for sym in KERNEL_SYMBOLS)}
    if missed:
        raise AssertionError(f"kernels of the port's sources that "
                             f"kernel_of does not know: {sorted(missed)}")
    out = {name: counts[name] for name in KERNELS}
    # a kernel's count includes its large-shape path's, as its wrapper's does
    for path, kernel in PATH_OF.items():
        out[kernel] += out[path]
    k2 = out["sa_weight_grad"] + out["sa_weight_grad_bf16"]
    if counts["k2_vec_partial"] != k2 or counts["k2_finish"] != k2:
        raise AssertionError(f"K2 ran dw_partial {k2} times, vec_partial "
                             f"{counts['k2_vec_partial']}, finish "
                             f"{counts['k2_finish']}")
    return out


def bound(ops: float, nbytes: float, tf32_ops: float = 0.0,
          prefix: str = "", bf16_ops: float = 0.0) -> dict:
    """The least time for ``ops`` f32 operations on the CUDA cores plus
    ``tf32_ops`` operations of 3xTF32 tensor-core products (each three
    passes at the TF32 rate) plus ``bf16_ops`` of bf16 tensor-core products,
    and ``nbytes`` moved."""
    t_ops = (ops / PEAK_F32_OPS + 3.0 * tf32_ops / PEAK_TF32_OPS
             + bf16_ops / PEAK_BF16_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {f"{prefix}bound_ms": max(t_ops, t_bytes),
            f"{prefix}bound_by": "operations" if t_ops >= t_bytes
            else "bytes"}


def phase_identity() -> dict:
    """The card's name and power limit (logged), its SMs and its largest SM
    clock (Hz)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "clock_hz": float(clock) * 1e6}
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}, {card['sms']} SMs, largest "
        f"SM clock {clock} MHz")
    # the bf16 forward turns it off around itself (models.maskplanner.
    # f32_accumulation): the JAX reference sums bf16 products in f32
    log(f"cuBLAS bf16 reduced-precision reduction allowed by default: "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return card


def phase_build() -> None:
    from maskplanner_tpu_torch.ops.cuda import build

    t = time.perf_counter()
    paths = build.build_all()
    log(f"[build] {len(paths)} kernels in {time.perf_counter() - t:.1f} s")
    for name, out in build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                log(f"[build] {name}: {line.strip()}")


def load_items(cfg, split: str) -> list[dict]:
    """64 items of the synthetic windows-v2 ``split``."""
    from maskplanner_tpu_torch.data import PaintDataset

    ds = PaintDataset(cfg, split=split, size=BATCH)
    return [ds[i] for i in range(BATCH)]


def mlp_macs(level) -> int:
    """Multiply-adds of one neighbour row through a level's MLP."""
    return sum(c.in_features * c.out_features for c in level.mlp_convs)


def sa_backward_work(k1: dict, k2: dict, product: str, sa, pts, new_xyz,
                     feats, idx, pooled, scratch_bytes: float) -> None:
    """Add one fused level's backward to K1's and K2's work: operations,
    ``product`` operations (the tensor-core products), ``bytes`` (what the
    function must move) and ``design_bytes`` (what this design moves).

    Operations: K1 the recompute and the input-gradient products, the
    LayerNorms and sums (about 20 f32 operations an activation); K2 the
    weight-gradient products. The function reads the points, centroids,
    features, indices, pooled output, its gradient and the weights once,
    and writes the features' gradient and the weights' gradients once:
    those bytes are split between K1 and K2 by their products. In this
    design K1 reads the inputs and writes the features' gradient, the
    scratch rows (``scratch_bytes``) and the per-query sums; K2 reads those
    two and writes the weights' gradients."""
    acts = sum(c.out_features for c in sa.mlp_convs)
    macs = mlp_macs(sa)
    din = macs - (0 if feats is not None else
                  sa.mlp_convs[0].in_features * sa.mlp_convs[0].out_features)
    R = idx.numel()
    k1["ops"] += R * 20.0 * acts
    k1[product] += R * 2.0 * (macs + din)
    k2[product] += R * 2.0 * macs
    w_bytes = 4.0 * sum(p.numel() for p in sa.parameters())
    fn_bytes = (4.0 * (pts.numel() + new_xyz.numel() + idx.numel()
                       + 2 * pooled.numel()
                       + 2 * (0 if feats is None else feats.numel()))
                + 2 * w_bytes)
    share = (macs + din) / (2 * macs + din)
    k1["bytes"] += share * fn_bytes
    k2["bytes"] += (1 - share) * fn_bytes
    side = scratch_bytes + 4.0 * pooled.shape[0] * pooled.shape[1] * 3 * acts
    k1["design_bytes"] += fn_bytes - w_bytes + side
    k2["design_bytes"] += side + w_bytes


def phase_kernels(model, xyz: torch.Tensor, res: dict) -> None:
    """Serving kernels vs plain at the flagship sa1/sa2 shapes."""
    from maskplanner_tpu_torch.ops.cuda.fps import fps_cuda
    from maskplanner_tpu_torch.ops.cuda.fused_sa import fused_sa_cuda
    from maskplanner_tpu_torch.ops.fused_sa import fused_sa_forward_plain
    from maskplanner_tpu_torch.ops.sampling import fps_plain, index_points

    start = torch.zeros(BATCH, dtype=torch.int32, device=xyz.device)
    pts, feats = xyz, None
    ops = {"fps": 0.0, "fused_sa_fwd": 0.0}
    nbytes = {"fps": 0.0, "fused_sa_fwd": 0.0}
    tf32 = 0.0  # the fused forward's products, on the tensor cores
    rf = res["fps"]
    rf.update(ms_batch1=0.0, us_per_step={})
    for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
        B, N, _ = pts.shape
        S, K = sa.npoint, sa.nsample
        for b in (1, BATCH):        # got: the batch's picks
            got = fps_cuda(pts[:b], S, start[:b])
            ref = fps_plain(pts[:b], S, start[:b])
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"FPS {name} batch {b}: kernel indices differ from the "
                    f"plain version at {int((got != ref).sum())} places")
        ms = median_ms(lambda: fps_cuda(pts, S, start), 20)
        one = pts[:1].contiguous()
        ms1 = median_ms(lambda: fps_cuda(one, S, start[:1]), 20)
        plain = median_ms(lambda: fps_plain(pts, S, start), 5, 1)
        log(f"[kernels] fps {name} {tuple(pts.shape)}->{S}: identical at "
            f"batch {BATCH} and 1; kernel {ms:.4f} ms ({1e3 * ms / S:.4f} us "
            f"a step), batch 1 {ms1:.4f} ms ({1e3 * ms1 / S:.4f} us a step); "
            f"plain {plain:.4f} ms")
        rf["ms"] += ms
        rf["ms_batch1"] += ms1
        rf["plain_ms"] += plain
        rf["us_per_step"].update({f"{name} batch {BATCH}": 1e3 * ms / S,
                                  f"{name} batch 1": 1e3 * ms1 / S})
        # per step and point: 3 sub, 3 mul, 2 add, a min and a compare
        ops["fps"] += 10.0 * B * S * N
        nbytes["fps"] += 4.0 * (B * N * 3 + B + B * S)
        # fused SA level on those centroids
        new_xyz = index_points(pts, got)
        params = sa.layer_params()
        args = (sa.radius, K)
        with torch.no_grad():
            pooled, idx = fused_sa_cuda(*args, True, pts, new_xyz, feats,
                                        params)
            pooled_ref, idx_ref = fused_sa_forward_plain(
                *args, "layer", pts, new_xyz, feats, params)
        torch.cuda.synchronize()
        if not torch.equal(idx, idx_ref):
            raise AssertionError(f"fused SA {name}: kernel neighbour indices "
                                 f"differ from the plain version")
        err = float((pooled - pooled_ref).abs().max())
        scale = float(pooled_ref.abs().max())
        if not err <= REL_TOL * scale:
            raise AssertionError(f"fused SA {name}: max|Δ| {err} > "
                                 f"{REL_TOL} x {scale}")
        # the backward routes by equality with this output: a launch gives
        # the same bits every time
        with torch.no_grad():
            again, _ = fused_sa_cuda(*args, True, pts, new_xyz, feats, params)
        if not torch.equal(pooled, again):
            raise AssertionError(f"fused SA {name}: two launches' pooled "
                                 f"outputs differ")
        with torch.no_grad():
            ms = median_ms(lambda: fused_sa_cuda(*args, True, pts, new_xyz,
                                                 feats, params), 20)
            plain = median_ms(lambda: fused_sa_forward_plain(
                *args, "layer", pts, new_xyz, feats, params), 5, 1)
        distinct = float((idx_ref != idx_ref[..., :1]).sum(-1).float().mean()
                         + 1)
        log(f"[kernels] fused_sa_fwd {name} N={N} S={S} K={K}: idx "
            f"identical, max|Δ| {err:.3e} (max|ref| {scale:.3e}), two "
            f"launches bitwise equal (mean "
            f"distinct neighbours {distinct:.1f}); kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms")
        fa = res["fused_sa_fwd"]
        fa["max_abs_err"] = max(fa["max_abs_err"], err)
        fa["ms"] += ms
        fa["plain_ms"] += plain
        # the MLP's multiply-adds and the LayerNorms (about 8 operations an
        # activation); the data-dependent ball-query scan is not counted,
        # so the figure stays a lower bound
        acts = sum(c.out_features for c in sa.mlp_convs)
        ops["fused_sa_fwd"] += B * S * K * 8.0 * acts
        tf32 += B * S * K * 2.0 * mlp_macs(sa)
        w_bytes = 4.0 * sum(p.numel() for p in sa.parameters())
        nbytes["fused_sa_fwd"] += (4.0 * (B * N * 3 + B * S * 3)
                                   + (0 if feats is None else 4.0 *
                                      feats.numel()) + w_bytes
                                   + 4.0 * pooled.numel() + 4.0 * idx.numel())
        pts, feats = new_xyz, pooled_ref      # the next level's inputs
    res["fps"].update(bound(ops["fps"], nbytes["fps"]))
    check_fps_edges(xyz)
    check_fps_trap()
    # the f32 rule of earlier rows: every operation at the CUDA cores'
    # rate; beside it, this design's mix (products on the tensor cores)
    fa = res["fused_sa_fwd"]
    fa.update(bound(ops["fused_sa_fwd"] + tf32, nbytes["fused_sa_fwd"]))
    fa.update(bound(ops["fused_sa_fwd"], nbytes["fused_sa_fwd"], tf32,
                    "mix_"))
    for name in ops:
        res[name]["library_ms"] = None
    log(f"[kernels] fused_sa_fwd bound: f32 rule {fa['bound_ms']:.4f} ms "
        f"({fa['bound_by']}), this design's mix {fa['mix_bound_ms']:.4f} ms "
        f"({fa['mix_bound_by']})")


def check_fps_edges(xyz: torch.Tensor) -> None:
    """FPS against its plain version on clouds of duplicated points and of
    sizes that leave the kernel's last warp partly empty."""
    from maskplanner_tpu_torch.ops.cuda.fps import fps_cuda
    from maskplanner_tpu_torch.ops.sampling import fps_plain

    gen = torch.Generator(device=xyz.device).manual_seed(3)
    # each of a cloud's first 1280 points 4 times, in shuffled order
    order = torch.randperm(5120, generator=gen, device=xyz.device)
    dup = xyz[:8, :1280].repeat(1, 4, 1)[:, order].contiguous()
    cases = {"duplicated points": (dup, 512)}
    for n in (1, 33, 1000, 5121):
        cases[f"{n} points"] = (torch.randn((8, n, 3), generator=gen,
                                            device=xyz.device),
                                min(n + 3, 512))
    for what, (pts, npoint) in cases.items():
        start = torch.randint(0, pts.shape[1], (pts.shape[0],),
                              generator=gen, device=xyz.device,
                              dtype=torch.int32)
        got = fps_cuda(pts, npoint, start)
        if not torch.equal(got, fps_plain(pts, npoint, start)):
            raise AssertionError(f"FPS on {what}: kernel indices differ from "
                                 f"the plain version")
    log(f"[kernels] fps identical on {', '.join(cases)}")


def check_fps_trap(n: int = 100) -> None:
    """A start index out of range traps the FPS kernel on clouds of ``n``
    points (the context is lost then, so a child process launches it): the
    child must fail after the launch."""
    code = ("import torch\n"
            "from maskplanner_tpu_torch.ops.sampling import "
            "farthest_point_sample\n"
            f"x = torch.rand(2, {n}, 3, device='cuda')\n"
            f"farthest_point_sample(x, 8, torch.tensor([0, {n}], "
            "dtype=torch.int32, device='cuda'))\n"
            "print('launched', flush=True)\n"
            "torch.cuda.synchronize()\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    said = " ".join(p.stdout.split())
    if p.returncode == 0 or "launched" not in p.stdout:
        raise AssertionError(f"an out-of-range FPS start did not fail after "
                             f"the launch: exit {p.returncode}, {said!r}, "
                             f"{p.stderr[-400:]!r}")
    log(f"[kernels] fps start out of range on {n} points: the child exited "
        f"{p.returncode} after the launch ({said!r})")


def phase_forward(model, clouds: np.ndarray, label: str = "forward",
                  expect: dict = FORWARD_LAUNCHES,
                  bf16: bool = False) -> dict:
    """One forward's launches (returned), outputs, the card against the CPU
    on 2 samples (max|Δ| within 1e-4 · max|ref|; a bf16 model's relative L2
    error within ``BF16_REL_TOL``), times and profiles."""
    dev = torch.device("cuda")
    x = torch.from_numpy(clouds).to(dev)
    reset_counts()
    with torch.inference_mode():
        out = model(x)
    launches = read_counts()
    log(f"[{label}] launches in one forward: {launches}")
    if launches != expect:
        raise AssertionError(f"one forward launched {launches}, expected "
                             f"{expect}")
    v, m = 449, 22
    expect = {"traj": (BATCH, v, 24), "stroke_masks": (BATCH, m, v),
              "mask_scores": (BATCH, m)}
    for field, shape in expect.items():
        t = getattr(out, field)
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{field}: shape {tuple(t.shape)} "
                                 f"(expected {shape}) or non-finite values")
    if out.seg_conf is not None:
        raise AssertionError("the flagship has no segment confidences")

    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        ref = cpu_model(torch.from_numpy(clouds[:2]))
    for field in expect:
        a = getattr(out, field)[:2].cpu()
        b = getattr(ref, field)
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        l2 = float((a - b).double().norm() / b.double().norm())
        log(f"[{label}] {field}: card vs CPU max|Δ| {err:.3e} "
            f"(max|ref| {scale:.3e}), relative L2 {l2:.3e}")
        if bf16 and not l2 <= BF16_REL_TOL:
            raise AssertionError(f"{field}: card and CPU disagree, relative "
                                 f"L2 {l2} > {BF16_REL_TOL}")
        if not bf16 and not err <= REL_TOL * scale:
            raise AssertionError(f"{field}: card and CPU disagree, {err} > "
                                 f"{REL_TOL} x {scale}")

    def fwd(inp):
        with torch.inference_mode():
            return model(inp)

    t64 = median_host_s(lambda: fwd(x), 10)
    t1 = median_host_s(lambda: fwd(x[:1]), 20)
    log(f"[{label}] batch {BATCH}: {t64 * 1e3:.3f} ms "
        f"({BATCH / t64:.1f} point clouds/s); batch 1: {t1 * 1e3:.3f} ms")
    profile(lambda: fwd(x), label, 3)
    # a request's device part: how much of the batch-1 forward is FPS
    profile(lambda: fwd(x[:1]), f"{label} batch 1", 10, also=("fps",))
    return launches


def profile(fn, what: str, reps: int, also: tuple = ()) -> None:
    """Device time by kernel over ``reps`` calls of ``fn``
    (torch.profiler): the ten largest, and any other whose name holds one
    of ``also``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # the kernels' own rows (an operator's or an annotation's row also
    # holds its kernels' time)
    rows = [(e.key, e.device_time_total / (reps * 1e3))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0
            and not e.key.startswith("Optimizer.")]
    if not rows:
        log(f"[profile] {what}: no device time recorded: not measured")
        return
    total = sum(ms for _, ms in rows)
    log(f"[profile] {what}: device time {total:.3f} ms (sum over kernels)")
    for i, (key, ms) in enumerate(sorted(rows, key=lambda r: -r[1])):
        if i < 10 or any(a in key for a in also):
            log(f"[profile] {what} {ms:9.3f} ms {100 * ms / total:5.1f}%  "
                f"{key[:90]}")


def write_box_obj(path: str, dims, center) -> None:
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float64)
    verts = corners * np.asarray(dims) / 2 + np.asarray(center)
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
             (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
             (1, 5, 7), (1, 7, 3)]
    with open(path, "w") as fh:
        for v in verts:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def serve_request(run_dir: str, label: str, reps: int,
                  expect: dict = FORWARD_LAUNCHES,
                  compute_dtype: str | None = None) -> None:
    """A Predictor on the card (in ``compute_dtype``) answers program
    requests for a box mesh, launching ``expect`` each."""
    from maskplanner_tpu_torch.serve import Predictor

    mesh = os.path.join(run_dir, "window.obj")
    # a window-sized box in millimetres, off the origin
    write_box_obj(mesh, dims=(900.0, 120.0, 1100.0),
                  center=(400.0, 1500.0, 900.0))
    pred = Predictor(run_dir, model="last", device="cuda",
                     compute_dtype=compute_dtype)
    reset_counts()
    rows = pred.predict_program(mesh, cover_all=True)
    launches = read_counts()
    if launches != expect:
        raise AssertionError(f"{label}: the serving request launched "
                             f"{launches}, expected {expect}")
    if rows.ndim != 2 or rows.shape[1] != 7 or rows.shape[0] == 0 \
            or not np.isfinite(rows).all():
        raise AssertionError(f"{label}: bad program rows: shape {rows.shape}")
    n_strokes = len(np.unique(rows[:, 6]))
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        pred.predict_program(mesh, cover_all=True)
        times.append(time.perf_counter() - t)
    if times:
        log(f"[{label}] program {rows.shape[0]} poses, {n_strokes} strokes; "
            f"request latency median {statistics.median(times) * 1e3:.1f} ms "
            f"(min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f})")
        # the request's parts: the rest is the host postprocess and export
        t = time.perf_counter()
        pc, _ = pred.preprocess(mesh)
        t_pre = time.perf_counter() - t
        t_fwd = median_host_s(lambda: pred.forward(pc[None]), 10)
        log(f"[{label}] of which preprocess {t_pre * 1e3:.1f} ms, forward "
            f"{t_fwd * 1e3:.3f} ms")
    else:
        log(f"[{label}] program {rows.shape[0]} poses, {n_strokes} strokes")


def phase_serve(cfg, model, label: str = "serve", reps: int = 3,
                expect: dict = FORWARD_LAUNCHES,
                compute_dtype: str | None = None) -> None:
    from maskplanner_tpu_torch.convert import save_checkpoint
    from maskplanner_tpu_torch.utils.config import save_config

    with tempfile.TemporaryDirectory() as run_dir:
        save_config(cfg, run_dir)
        save_checkpoint(run_dir, "last_checkpoint", model)
        serve_request(run_dir, label, reps=reps, expect=expect,
                      compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def active_weights(cfg, handler) -> dict:
    """The loss weights after the delayed stroke-mask activation (1.0 and
    100.0), so that every head has a gradient."""
    from maskplanner_tpu_torch.train import apply_delayed_activations

    return apply_delayed_activations(cfg, handler.init_weights(), 10 ** 6)


def check_against_exact(name: str, got, plain, exact) -> float:
    """Hold a kernel's gradient against the same level's in float64.

    A float32 gradient of this network is only as good as its conditioning
    allows. At the flagship shapes the plain float32 version itself lies
    from 6e-5 to several percent of max|ref| from the float64 one, tensor by
    tensor: LayerNorm rows of near-constant values amplify rounding, and
    near-ties in the max over K neighbours fall to another neighbour when
    the activations are summed in another order, each such flip moving a
    few weight-gradient entries by O(1). The kernel's activations are
    summed in another order than the plain version's, so its flips are its
    own. Hence the measure is the root-mean-square error, which a handful
    of flipped entries do not dominate: the kernel passes when
    ||kernel − exact|| <= 3 · max(||plain − exact||, 5e-4 · ||exact||),
    within three times the larger of the plain float32 version's own error
    and the JAX package's fused-vs-unfused tolerance. Max-abs errors are
    logged beside it. Returns max|kernel − plain|."""
    exact = exact.double()
    got64 = got.double()
    plain64 = plain.double()
    norm = float(exact.norm())
    rms_k = float((got64 - exact).norm())
    rms_p = float((plain64 - exact).norm())
    scale = float(exact.abs().max())
    max_k = float((got64 - exact).abs().max())
    max_p = float((plain64 - exact).abs().max())
    tiny = 1e-30
    log(f"[train-kernels]   {name:14s} rel. rms error kernel "
        f"{rms_k / max(norm, tiny):.2e} plain {rms_p / max(norm, tiny):.2e}; "
        f"max error kernel {max_k / max(scale, tiny):.2e} plain "
        f"{max_p / max(scale, tiny):.2e} of max|exact| {scale:.3e}")
    tol = 3.0 * max(rms_p, 5e-4 * norm)
    if not rms_k <= tol:
        raise AssertionError(f"{name}: kernel rms error from float64 {rms_k} "
                             f"> {tol} (3 x max(plain's {rms_p}, 5e-4 x "
                             f"{norm}))")
    return float((got - plain).abs().max())


def check_routing(name, sa, leaves, params, idx, pooled,
                  bf16: bool = False) -> None:
    """The max-pool backward finds the forward's winner for every (query,
    channel): with d_pooled = 1 the last LayerNorm's beta gradient counts
    the routed pairs that pass the ReLU, which must be every pair with a
    positive maximum (a recompute that differed from the forward in one bit
    would lose the pair). ``bf16``: the kernels' bf16 modes, on the bf16
    forward's ``pooled``."""
    from maskplanner_tpu_torch.ops.cuda.fused_sa import fused_sa_backward_cuda

    det = [None if t is None else t.detach() for t in leaves]
    dparams = [tuple(t.detach() for t in layer) for layer in params]
    pooled = pooled.detach()
    _, _, _, grads = fused_sa_backward_cuda(sa.nsample, True, *det, dparams,
                                            idx, pooled,
                                            torch.ones_like(pooled),
                                            bf16=bf16)
    routed = float(grads[-1][3].double().sum())
    want = int((pooled > 0).sum())
    log(f"[train-kernels]   routing: {routed:.0f} of {want} (query, channel) "
        f"pairs with a positive max")
    if routed != want:
        raise AssertionError(f"fused SA {name}: the backward routed {routed} "
                             f"max-pool gradients, expected {want}")


def check_deterministic(name, args, bf16: bool = False) -> None:
    """Two launches of the level's backward (K1 then K2; their bf16 modes
    with ``bf16``) give the same weight gradients, bit for bit: no atomic
    and a summation order fixed by the shapes."""
    from maskplanner_tpu_torch.ops.cuda.fused_sa import fused_sa_backward_cuda

    first = fused_sa_backward_cuda(*args, bf16=bf16)[3]
    second = fused_sa_backward_cuda(*args, bf16=bf16)[3]
    for j, (a, b) in enumerate(zip(first, second)):
        for n, x, y in zip(("dW", "db", "dgamma", "dbeta"), a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"fused SA {name}: L{j}.{n} differs "
                                     f"between two launches")
    log(f"[train-kernels]   weight gradients bitwise equal across two "
        f"launches ({len(first)} layers x dW, db, dgamma, dbeta)")


def nn_argmin_edges(x, y, mask) -> dict:
    """Inputs that stress the argmin's exactness, beside a step call's
    (x, y, mask): the call's shapes on a grid whose squared distances are
    exact in float32 (many exact ties), a random mask that is not a prefix,
    and sizes that are multiples of no tile or warp count."""
    gen = torch.Generator(device=x.device).manual_seed(4)

    def grid(shape, step):
        return torch.randint(-2, 3, shape, generator=gen, device=x.device,
                             dtype=torch.float32) * step

    D = x.shape[-1]
    step = 0.5 if D <= 8 else 0.25
    valid = torch.rand(y.shape[:2], generator=gen, device=x.device) > 0.4
    odd = (torch.randn((3, 257, D), generator=gen, device=x.device),
           torch.randn((3, 1031, D), generator=gen, device=x.device),
           torch.rand((3, 1031), generator=gen, device=x.device) > 0.4)
    return {f"ties d={D}": (grid(x.shape, step), grid(y.shape, step), mask),
            f"non-prefix mask d={D}": (x, y, valid),
            f"odd sizes d={D}": odd}


def hold_argmin(calls, card: dict, tag: str) -> dict:
    """The nearest-neighbour argmin at each ``(what, x, y, mask)`` call:
    indices identical to the plain version, and the calls' summed kernel
    time (CUDA-event medians), plain time, ``torch.cdist(x, y).argmin(-1)``
    time, bound and this design's instruction floor."""
    from maskplanner_tpu_torch.ops.cuda.nn_argmin import nn_argmin_cuda
    from maskplanner_tpu_torch.ops.nn_argmin import nn_argmin_plain

    out = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, call_ms={})
    ops = nbytes = instr = 0.0
    for what, x, y, mask in calls:
        got = nn_argmin_cuda(x, y, mask)
        ref = nn_argmin_plain(x, y, mask)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"nn_argmin {what}: indices differ at "
                                 f"{int((got != ref).sum())} places")
        ms = median_ms(lambda: nn_argmin_cuda(x, y, mask), 20)
        plain = median_ms(lambda: nn_argmin_plain(x, y, mask), 5, 1)
        cd = median_ms(lambda: torch.cdist(x, y).argmin(-1), 10)
        Bx, P1, D = x.shape
        P2 = y.shape[1]
        log(f"[{tag}] nn_argmin {what} {tuple(x.shape)} x "
            f"{tuple(y.shape)} mask={mask is not None}: identical; kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, torch.cdist+argmin "
            f"{cd:.4f} ms")
        out["ms"] += ms
        out["call_ms"][what] = ms
        out["plain_ms"] += plain
        out["library_ms"] += cd
        ops += Bx * P1 * P2 * (3.0 * D + 1.0)
        # this design: d subtracts, d multiplies, d - 1 adds (no FMA), a
        # compare and two selects a pair, each an instruction of a lane
        instr += Bx * P1 * P2 * (3.0 * D + 2.0)
        nbytes += 4.0 * (Bx * P1 * D + Bx * P2 * D + Bx * P1) + (
            0 if mask is None else Bx * P2)
    out.update(bound(ops, nbytes))
    # the f32 lanes of every SM at the card's largest clock
    out["instr_bound_ms"] = instr / (F32_LANES * card["sms"]
                                     * card["clock_hz"]) * 1e3
    out["instr_bound_by"] = "f32 instruction issue"
    return out


def hold_sa_backward(name, sa, pts, new_xyz, feats, gen) -> dict:
    """The fused SA level (#2, and #3 as K1 and K2) against the plain level
    on the card, on one level's inputs: the backward launches K1 and K2
    once each, the neighbour indices are identical, pooled within
    1e-4 · max|ref|, every max routed (``check_routing``), and each
    gradient for a seeded cotangent (from ``gen``) within
    ``check_against_exact``'s rule of the plain level's in float64 -> the
    level's leaves, parameters, ``wrt`` (the tensors differentiated),
    indices, pooled output, cotangent, and each gradient's max|kernel −
    plain| by name (K2's names start with "L")."""
    from maskplanner_tpu_torch.ops.fused_sa import (fused_sa_forward,
                                                    fused_sa_forward_plain)

    params = [tuple(t.detach().clone().requires_grad_(True) for t in l)
              for l in sa.layer_params()]
    leaves = [pts.detach().clone().requires_grad_(True),
              new_xyz.detach().clone().requires_grad_(True),
              None if feats is None
              else feats.detach().clone().requires_grad_(True)]
    wrt = [t for t in leaves if t is not None] + [t for l in params
                                                  for t in l]
    names = ["d_xyz", "d_new_xyz"] + ([] if feats is None
                                      else ["d_features"])
    names += [f"L{j}.{n}" for j in range(len(params))
              for n in ("dW", "db", "dgamma", "dbeta")]
    args = (sa.radius, sa.nsample, "layer")
    pooled, idx = fused_sa_forward(*args, *leaves, params)
    ct = torch.randn(pooled.shape, generator=gen, device=pooled.device)
    reset_counts()
    g = torch.autograd.grad((pooled * ct).sum(), wrt)
    counts = read_counts()
    if (counts["fused_sa_bwd"], counts["sa_weight_grad"]) != (1, 1):
        raise AssertionError("the level's backward did not run K1 and K2 "
                             "once each")
    ref, ridx = fused_sa_forward_plain(*args, *leaves, params)
    if not torch.equal(idx, ridx):
        raise AssertionError(f"fused SA {name}: neighbour indices differ")
    check_close(f"fused SA {name}", pooled.detach(), ref.detach(), REL_TOL)
    gp = torch.autograd.grad((ref * ct).sum(), wrt)
    l64 = [None if t is None else t.detach().double().requires_grad_(True)
           for t in leaves]
    p64 = [tuple(t.detach().double().requires_grad_(True) for t in l)
           for l in params]
    ref64, _ = fused_sa_forward_plain(*args, *l64, p64)
    g64 = torch.autograd.grad(
        (ref64 * ct.double()).sum(),
        [t for t in l64 if t is not None] + [t for l in p64 for t in l])
    check_routing(name, sa, leaves, params, idx, pooled)
    errs = {n: check_against_exact(n, a, b, c)
            for n, a, b, c in zip(names, g, gp, g64)}
    return dict(leaves=leaves, params=params, wrt=wrt, idx=idx,
                pooled=pooled, ct=ct, errs=errs)


def phase_train_kernels(cfg, model, batch, res: dict, card: dict) -> None:
    """The training kernels against their plain versions at the step's
    shapes and inputs."""
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.ops.cuda.fused_sa import (fused_sa_bwd_cuda,
                                                         sa_weight_grad_cuda,
                                                         scratch_floats)
    from maskplanner_tpu_torch.ops.cuda.lap import lap_step_cycles
    from maskplanner_tpu_torch.ops.cuda.nn_argmin import nn_argmin_cuda
    from maskplanner_tpu_torch.ops.fused_sa import fused_sa_forward_plain
    from maskplanner_tpu_torch.ops.nn_argmin import nn_argmin_plain
    from maskplanner_tpu_torch.ops.sampling import (farthest_point_sample,
                                                    index_points)
    from maskplanner_tpu_torch.train import build_loss_batch

    gen = torch.Generator(device="cuda").manual_seed(1)
    # -- fused SA backward (K1 + K2) at sa1 and sa2 -----------------------------
    k1, k2 = res["fused_sa_bwd"], res["sa_weight_grad"]
    work = {name: dict(ops=0.0, tf32=0.0, bytes=0.0, design_bytes=0.0)
            for name in ("fused_sa_bwd", "sa_weight_grad")}
    pts, feats = batch["point_cloud"], None
    for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
        B, N, _ = pts.shape
        S, K = sa.npoint, sa.nsample
        new_xyz = index_points(pts, farthest_point_sample(pts, S))
        log(f"[train-kernels] fused_sa_bwd {name} B={B} N={N} S={S} K={K}:")
        lv = hold_sa_backward(name, sa, pts, new_xyz, feats, gen)
        for n, err in lv["errs"].items():
            r = k2 if n.startswith("L") else k1
            r["max_abs_err"] = max(r["max_abs_err"], err)
        leaves, params, idx, pooled, ct = (lv[k] for k in (
            "leaves", "params", "idx", "pooled", "ct"))
        # times: K1 with the step's flags (sa2's features alone carry a
        # gradient), K2 on its rows, and autograd's backward of the plain
        # level
        det = [None if t is None else t.detach() for t in leaves]
        dparams = [tuple(t.detach() for t in l) for l in params]
        needs = (False, False, feats is not None)
        args = (K, True, *det, dparams, idx, pooled.detach(), ct)
        check_deterministic(name, args)
        _, _, _, scratch, vec, chans = fused_sa_bwd_cuda(*args, needs)
        rows = idx.numel()
        ms1 = median_ms(lambda: fused_sa_bwd_cuda(*args, needs), 5)
        ms2 = median_ms(lambda: sa_weight_grad_cuda(scratch, vec, chans,
                                                    True, rows), 5)
        del scratch, vec
        ref, _ = fused_sa_forward_plain(sa.radius, K, "layer", *leaves,
                                        params)
        plain = median_ms(lambda: torch.autograd.grad(
            (ref * ct).sum(), lv["wrt"], retain_graph=True), 3, 1)
        log(f"[train-kernels] fused_sa_bwd {name}: K1 {ms1:.3f} ms + K2 "
            f"{ms2:.3f} ms = {ms1 + ms2:.3f} ms, plain (autograd) "
            f"{plain:.3f} ms")
        k1["ms"] += ms1
        k2["ms"] += ms2
        # the plain version computes both kernels' function at once
        k1["plain_ms"] += plain
        k2["plain_ms"] += plain
        # K1: the recompute (the forward's MLP and LayerNorms), the
        # LayerNorm backward (about 12 operations an activation) and, for
        # every layer the step asks it of, the input-gradient product; K2:
        # the weight-gradient products. Together the 6x MAC + 20x acts of
        # the whole backward. Every product runs on the tensor cores.
        sa_backward_work(work["fused_sa_bwd"], work["sa_weight_grad"],
                         "tf32", sa, pts, new_xyz, feats, idx, pooled,
                         4.0 * scratch_floats(chans, idx.numel()))
        pts, feats = new_xyz.detach(), pooled.detach()
    for kname, wk in work.items():
        # the f32 rule of earlier rows: every operation at the CUDA cores'
        # rate; beside it, this design's mix (products on the tensor cores),
        # and the mix with the scratch rows this design moves
        res[kname].update(bound(wk["ops"] + wk["tf32"], wk["bytes"]))
        res[kname].update(bound(wk["ops"], wk["bytes"], wk["tf32"], "mix_"))
        res[kname].update(bound(wk["ops"], wk["design_bytes"], wk["tf32"],
                                "design_"))
        res[kname]["library_ms"] = None
    log(f"[train-kernels] fused SA backward bound (f32 rule) "
        f"{k1['bound_ms'] + k2['bound_ms']:.4f} ms; K1 "
        f"{k1['bound_ms']:.4f} ({k1['bound_by']}), K2 {k2['bound_ms']:.4f} "
        f"({k2['bound_by']}); this design's mix: K1 {k1['mix_bound_ms']:.4f} "
        f"({k1['mix_bound_by']}), K2 {k2['mix_bound_ms']:.4f} "
        f"({k2['mix_bound_by']}); with its scratch rows: K1 "
        f"{k1['design_bound_ms']:.4f} ({k1['design_bound_by']}), K2 "
        f"{k2['design_bound_ms']:.4f} ({k2['design_bound_by']})")

    # -- the step's nearest-neighbour and LAP inputs --------------------------
    model.train()
    with torch.no_grad():
        out = model(batch["point_cloud"])
    handler = LossHandler(cfg["loss"], cfg)
    lb = build_loss_batch(out, batch)
    B = lb["y_pred"].shape[0]
    poses = lb["y_pred"].reshape(B, -1, 6)
    # the step's three searches (the loss's forward segment term searches
    # one direction only)
    calls = [("forward segments", lb["y_pred"], lb["y"], lb["y_mask"]),
             ("reverse segments", lb["y"], lb["y_pred"], None),
             ("reverse points", lb["traj_as_pc"], poses, None)]
    r = res["nn_argmin"]
    r.update(hold_argmin(calls, card, "train-kernels"))
    for what, x, y, mask in calls[::2]:        # d = 24 and d = 6
        for edge, (ex, ey, em) in nn_argmin_edges(x, y, mask).items():
            got = nn_argmin_cuda(ex, ey, em)
            ref = nn_argmin_plain(ex, ey, em)
            if not torch.equal(got, ref):
                raise AssertionError(f"nn_argmin {edge}: indices differ at "
                                     f"{int((got != ref).sum())} places")
            log(f"[train-kernels] nn_argmin {edge} {tuple(ex.shape)} x "
                f"{tuple(ey.shape)} mask={em is not None}: identical")
    log(f"[train-kernels] nn_argmin: {len(calls)} calls {r['ms']:.4f} ms; "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), this design's "
        f"instruction floor {r['instr_bound_ms']:.4f} ms")

    # the LAP's input, recorded from the loss itself
    with lap_costs() as seen, torch.no_grad():
        handler.compute(active_weights(cfg, handler), **lb)
    if [tuple(c.shape) for c, _ in seen] != [(BATCH, 22, 22)]:
        raise AssertionError(f"expected one 64 x 22 x 22 LAP, got "
                             f"{[tuple(c.shape) for c, _ in seen]}")
    r = res["lap"]
    r.update(library_ms=None, **hold_lap(seen[0][0], "train-kernels"))
    # the chain floor: the longest problem's dependent steps at the cycles
    # one step needs (csrc/lap.cu's note), at the SM clock right after the
    # timing
    mhz = sm_clock_mhz()
    cycles = lap_step_cycles()
    r.update(
        chain_bound_ms=r["max_steps"] * cycles / (mhz * 1e6) * 1e3,
        chain_bound_by=f"{r['max_steps']} dependent steps x {cycles} "
                       f"cycles at {mhz:.0f} MHz",
        ns_per_step=r["ms"] * 1e6 / r["max_steps"])
    log(f"[train-kernels] lap chain: longest problem {r['max_steps']} of "
        f"{r['steps']} steps; floor {res['lap']['chain_bound_ms']:.4f} ms "
        f"({cycles} cycles a step at {mhz:.0f} MHz); kernel "
        f"{res['lap']['ns_per_step']:.1f} ns a dependent step (launch gap "
        f"included)")
    check_lap_edges()
    model.eval()


def hold_lap(cost, tag: str) -> dict:
    """The LAP kernel on ``cost`` (B, n, n) on the card: a permutation per
    problem whose total cost lies within 1e-5 relative of the plain
    version's; its time (CUDA-event median), the plain version's, the
    largest total-cost gap, the Dijkstra steps (all and the longest
    problem's) and the bound."""
    from maskplanner_tpu_torch.ops.cuda.lap import lap_cuda
    from maskplanner_tpu_torch.ops.hungarian import lap_plain

    stats = {}
    got = lap_cuda(cost)
    ref = lap_plain(cost, stats)
    rel, gap = check_assignment(f"[{tag}] lap {tuple(cost.shape)}", cost,
                                got, ref)
    agree = float((got == ref).float().mean())
    ms = median_ms(lambda: lap_cuda(cost), 20)
    plain = median_ms(lambda: lap_plain(cost), 3, 1)
    log(f"[{tag}] lap {tuple(cost.shape)}: permutations, total cost max rel "
        f"Δ {rel:.2e}, index agreement {agree:.4f}, {stats['steps']} "
        f"Dijkstra steps (longest {stats['max_steps']}); kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms")
    B, n, _ = cost.shape
    return dict(ms=ms, plain_ms=plain, max_abs_err=gap, steps=stats["steps"],
                max_steps=stats["max_steps"],
                # per step and column: 3 add/sub, 2 compares, a select
                **bound(6.0 * stats["steps"] * n,
                        4.0 * (cost.numel() + B * n)))


def check_assignment(what: str, cost, got, ref) -> tuple[float, float]:
    """``got`` (B, n) must be a permutation per problem whose total cost lies
    within 1e-5 relative of ``ref``'s -> (the largest relative and absolute
    total-cost gaps)."""
    B, n = got.shape
    perm = torch.sort(got.long(), dim=1).values
    if not torch.equal(perm, torch.arange(n, device=got.device).expand(B, n)):
        raise AssertionError(f"{what}: not a permutation")
    c_got = cost.double().gather(2, got.long()[..., None]).sum((1, 2))
    c_ref = cost.double().gather(2, ref.long()[..., None]).sum((1, 2))
    gap = (c_got - c_ref).abs()
    rel = float((gap / c_ref.abs().clamp(min=1e-30)).max())
    if not rel <= 1e-5:
        raise AssertionError(f"{what}: total cost differs by {rel} relative")
    return rel, float(gap.max())


def sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def check_lap_edges() -> None:
    """The LAP kernel on both of its paths and their edges: n in {1, 2, 21,
    31, 32, 33, 64, 128} at batch 1 and 64, on random costs and on small
    integers (many exact ties): every result a permutation whose total
    cost lies within 1e-5 relative of the plain version's (run on the
    CPU)."""
    from maskplanner_tpu_torch.ops.cuda.lap import lap_cuda
    from maskplanner_tpu_torch.ops.hungarian import lap_plain

    gen = torch.Generator().manual_seed(4)
    for n in (1, 2, 21, 31, 32, 33, 64, 128):
        for batch in (1, BATCH):
            for kind in ("random", "integer"):
                cost = torch.randn((batch, n, n), generator=gen)
                if kind == "integer":
                    cost = torch.randint(0, 4, (batch, n, n),
                                         generator=gen).float()
                check_assignment(f"lap n={n} b={batch} {kind}", cost,
                                 lap_cuda(cost.cuda()).cpu(), lap_plain(cost))
        log(f"[train-kernels] lap edges n={n}: batch 1 and {BATCH}, random "
            f"and integer costs: permutations of the plain version's total "
            f"cost")


def to_batch(items: list[dict], device) -> dict:
    from maskplanner_tpu_torch.data import collate
    from maskplanner_tpu_torch.train import batch_to_device

    return batch_to_device(collate(items), device)


def phase_train_step(cfg, items, label: str = "train",
                     expect: dict = STEP_LAUNCHES, steps: int = 30,
                     compare: int = 2, **rules) -> tuple[dict, list]:
    """Launch counts of one training step at batch 64 and the shapes of
    the LAP's cost tensors it launched on, the card against the CPU on
    ``compare`` samples (none at 0; ``rules``: ``phase_card_vs_cpu``'s
    keywords), a ``steps``-step health check and the step time (neither at
    ``steps`` 0) -> (launches, LAP shapes)."""
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import make_optimizer, train_step

    batch = to_batch(items, "cuda")
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    handler = LossHandler(cfg["loss"], cfg)
    weights = active_weights(cfg, handler)
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_step(model, opt, handler, batch, weights, gen)   # warm up
    reset_counts()
    with lap_costs() as seen:
        loss, _ = train_step(model, opt, handler, batch, weights, gen)
    launches = read_counts()
    shapes = [tuple(c.shape) for c, _ in seen]
    log(f"[{label}] launches in one step: {launches}; LAP costs {shapes}")
    if launches != expect:
        raise AssertionError(f"one training step launched {launches}, "
                             f"expected {expect}")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"non-finite training loss {float(loss)}")

    if compare:
        phase_card_vs_cpu(cfg, items[:compare], handler, label, **rules)
    if not steps:
        return launches, shapes

    # health: Adam steps on the batch
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model, cfg)
    curve = [float(train_step(model, opt, handler, batch, weights, gen)[0])
             for _ in range(steps)]
    log(f"[{label}] {steps}-step loss curve: "
        + " ".join(f"{v:.1f}" for v in curve))
    if not all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise AssertionError(f"the loss did not fall over {steps} steps, or "
                             f"went non-finite")

    t = median_host_s(lambda: train_step(model, opt, handler, batch, weights,
                                         gen), 10)
    log(f"[{label}] step at batch {BATCH}: {t * 1e3:.3f} ms "
        f"({BATCH / t:.1f} point clouds/s)")
    # index_add_: the ball-group backward's scatter
    profile(lambda: train_step(model, opt, handler, batch, weights, gen),
            f"{label} step", 1, also=("indexFunc",))
    return launches, shapes


@contextlib.contextmanager
def lap_costs():
    """The (cost, col4row) pairs of the calls of ``ops.hungarian.lap``
    inside the block, in call order, each cost a detached copy."""
    from maskplanner_tpu_torch.ops import hungarian

    seen, lap = [], hungarian.lap

    def recorded(cost):
        seen.append((cost.detach().clone(), lap(cost)))
        return seen[-1][1]

    hungarian.lap = recorded
    try:
        yield seen
    finally:
        hungarian.lap = lap


def step_grads(model, handler, batch, weights, cotangent: bool = False):
    """The step's loss and parameter gradients; with ``cotangent`` the
    gradients of the train forward's outputs against fixed seeded
    cotangents instead (the loss's matchings left out)."""
    from maskplanner_tpu_torch.train import train_step

    opt = torch.optim.Adam(model.parameters(), lr=0.0)
    loss, _ = train_step(model, opt, handler, batch, weights)
    if cotangent:
        opt.zero_grad(set_to_none=True)
        out = model(batch["point_cloud"])
        gen = torch.Generator().manual_seed(6)
        sum((o * torch.randn(o.shape, generator=gen, dtype=torch.float64)
             .to(o.device, o.dtype)).sum()
            for o in out if o is not None).backward()
    return float(loss), {n: p.grad.detach().cpu().double()
                         for n, p in model.named_parameters()}


def phase_card_vs_cpu(cfg, items, handler, label: str = "train",
                      cotangent: bool = False, loss_own: bool = False,
                      zero_biases: bool = False) -> None:
    """One step's loss and gradients on the card and on the CPU.

    The same weights, FPS from index 0, head dropout 0, the activated loss
    weights, held by ``hold_rule``: the loss within 1e-4 relative; each
    gradient's rms difference within 1e-3 of its norm plus 3 x the CPU
    step's own float32 rms error on that tensor, measured against the CPU
    step in float64.

    Three rules that only the recipes of ``phase_recipes`` ask for: with
    ``cotangent`` the gradients are those for fixed seeded cotangents on
    the train forward's outputs (``step_grads``); with ``loss_own`` the
    loss may also differ by 3 x the CPU step's own float32 error on it (its
    distance from the CPU step in float64: at ``pointWise``'s 1350
    one-pose segments the matchings' near-ties put it at 1e-3 relative);
    with ``zero_biases`` the biases that a train-mode BatchNorm normalises,
    whose exact gradient is 0 (``batchnorm_fed_biases``), are held by their
    norm on the card, within 1e-4 of the largest gradient norm, in place
    of the rms rule against their own rounding noise."""
    from maskplanner_tpu_torch.models import get_model

    weights = active_weights(cfg, handler)
    models = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64)):
        m = get_model(cfg, device="cpu", dropout=0.0,
                      generator=torch.Generator().manual_seed(0))
        models[dev, dtype] = m.to(device=dev, dtype=dtype)
    res = {}
    for (dev, dtype), m in models.items():
        b = to_batch(items, dev)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in b.items()}
        res[dev, dtype] = step_grads(m, handler, b, weights, cotangent)
    (l_gpu, g_gpu), (l_cpu, g_cpu), (l_64, g_64) = res.values()
    zero = (batchnorm_fed_biases(models["cpu", torch.float32])
            if zero_biases else frozenset())
    hold_rule(f"card-vs-cpu {label}", (l_gpu, l_cpu, l_64),
              (g_gpu, g_cpu, g_64), loss_own=loss_own, zero=zero)


def hold_rule(label: str, loss: tuple | None, tensors: tuple,
              loss_own: bool = False, zero=frozenset(),
              each: bool = False) -> None:
    """Phase 8's rule on (card, CPU, exact) triples. The card and the CPU
    ran in the compared dtype (float32); the exact run is the CPU's in
    float64, and the CPU run's distance from it is the compared dtype's
    own error on that value.

    ``loss``: three floats, the card's within 1e-4 of the CPU's, relative
    (with ``loss_own`` plus 3 x the CPU's own error); None holds no loss.
    ``tensors``: three {name: tensor} dicts (gradients, or outputs), each
    card tensor's rms distance from the CPU's within 1e-3 of its norm plus
    3 x the CPU's own error on it (rms, not max: near-ties in the
    max-pools and the matchings fall apart in another summation order and
    move single entries by O(1); see ``check_against_exact``). The names
    in ``zero`` are 0 in exact arithmetic (``batchnorm_fed_biases``):
    their norm on the card within 1e-4 of the largest norm. Logs each
    tensor's distance beside its allowance with ``each``, else the
    tightest."""
    if loss is not None:
        l_gpu, l_cpu, l_64 = loss
        own = abs(l_cpu - l_64)
        limit = REL_TOL * abs(l_cpu) + (3.0 * own if loss_own else 0.0)
        d = abs(l_gpu - l_cpu)
        log(f"[{label}] loss card {l_gpu:.9g} cpu {l_cpu:.9g} (float64 "
            f"{l_64:.9g}): |Δ| {d:.3e}, the CPU's own {own:.3e}, allowed "
            f"{limit:.3e}")
        if not d <= limit:
            raise AssertionError(f"[{label}] the card's loss {l_gpu} differs "
                                 f"from the CPU's {l_cpu} by {d} (allowed "
                                 f"{limit})")
    g_gpu, g_cpu, g_64 = ({n: t.detach().cpu().double() for n, t in g.items()}
                          for g in tensors)
    scale = max(float(g.norm()) for g in g_cpu.values())
    tight, worst = (0.0, "", 0.0, 0.0), (0.0, "")
    for n, ref in g_cpu.items():
        if n in zero:
            # exactly 0: both sides' values are rounding noise
            if not float(g_gpu[n].norm()) <= 1e-4 * scale:
                raise AssertionError(f"[{label}] {n} (0 in exact arithmetic):"
                                     f" norm {float(g_gpu[n].norm())} on the "
                                     f"card > 1e-4 x {scale}")
            continue
        norm = float(ref.norm())
        d = float((g_gpu[n] - ref).norm())
        own = float((ref - g_64[n]).norm())
        tol = 1e-3 * norm + 3.0 * own
        if each:
            log(f"[{label}] {n}: rms Δ {d:.3e}, allowed {tol:.3e} (1e-3 x "
                f"{norm:.3e} + 3 x {own:.3e})")
        if not d <= tol:
            raise AssertionError(f"[{label}] {n}: card vs CPU rms {d} > "
                                 f"{tol} (1e-3 x {norm} + 3 x {own})")
        share = d / tol if tol > 0 else 0.0
        tight = max(tight, (share, n, d, tol))
        rel_max = float((g_gpu[n] - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
        worst = max(worst, (rel_max, n))
    log(f"[{label}] {len(g_cpu) - len(zero)} tensors agree"
        + (f", {len(zero)} that are 0 in exact arithmetic within 1e-4 of "
           f"the largest norm" if zero else "")
        + f"; the tightest {tight[1]} (rms Δ {tight[2]:.3e}, allowed "
        f"{tight[3]:.3e}); largest card-vs-CPU max|Δ| {worst[0]:.2e} of "
        f"max|ref| ({worst[1]})")


def hold_float64(label: str, loss: tuple, tensors: tuple,
                 limit: float = 1e-9, zero=frozenset()) -> None:
    """Card against CPU, both in float64: ``loss`` (card, CPU) within
    ``limit`` relative, and each tensor of ``tensors`` (card, CPU dicts)
    by rms within ``limit`` of its norm, those in ``zero`` (0 in exact
    arithmetic: both sides hold rounding noise) by their card norm within
    ``limit`` of the largest norm; logs each. Float64 rounds at 1e-16:
    the limit leaves room for other summation orders, none for a float32
    error or a different choice (a neighbour, a max-pool winner)."""
    (l_gpu, l_cpu), (g_gpu, g_cpu) = loss, (
        {n: t.detach().cpu().double() for n, t in g.items()}
        for g in tensors)
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    log(f"[{label}] loss card {l_gpu:.15g} cpu {l_cpu:.15g}: rel Δ "
        f"{rel:.2e}, allowed {limit:.0e}")
    if not rel <= limit:
        raise AssertionError(f"[{label}] the loss differs by {rel} relative "
                             f"(allowed {limit})")
    scale = max(float(g.norm()) for g in g_cpu.values())
    for n, ref in g_cpu.items():
        if n in zero:
            got = float(g_gpu[n].norm())
            log(f"[{label}] {n} (0 in exact arithmetic): norm {got:.3e} on "
                f"the card, allowed {limit * scale:.3e}")
            if not got <= limit * scale:
                raise AssertionError(f"[{label}] {n}: norm {got} on the card "
                                     f"> {limit} x {scale}")
            continue
        norm = float(ref.norm())
        d = float((g_gpu[n] - ref).norm())
        log(f"[{label}] {n}: rms Δ {d:.3e}, allowed {limit * norm:.3e} "
            f"({limit:.0e} x {norm:.3e})")
        if not d <= limit * norm:
            raise AssertionError(f"[{label}] {n}: card vs CPU rms {d} > "
                                 f"{limit} x {norm}")


def batchnorm_fed_biases(model) -> set:
    """The biases of the Linear layers whose output a BatchNorm normalises
    directly: in train mode the BatchNorm subtracts the batch mean, so
    their exact gradient is 0."""
    mods = dict(model.named_modules())
    out = set()
    for name, m in mods.items():
        if isinstance(m, torch.nn.Linear):
            bn = (name.replace("mlp_convs", "mlp_bns") if "mlp_convs" in name
                  else re.sub(r"(fc|conv)(\d)$", r"bn\2", name))
            if bn != name and isinstance(mods.get(bn), torch.nn.BatchNorm1d):
                out.add(f"{name}.bias")
    return out


def phase_train_then_serve(extra=(), expect: dict = STEP_LAUNCHES,
                           serve: dict = FORWARD_LAUNCHES,
                           label: str = "train-then-serve",
                           then=None, steps: int = TRACED_REPLAYS) -> dict:
    """The training entry point in-process (with the ``extra`` config
    arguments, ``profile=true``) for 2 epochs of ``steps`` steps on the
    driver's default loop: the first step runs eagerly and is then
    captured, every later step is a replay. The trace of the second epoch
    must hold ``steps`` CUDA graph replays launching ``expect`` each
    (``trace_launches``, ``per_replay``); the wrappers must count the fused SA backward's
    kernels twice ``expect`` (the eager step and the capture; the run's
    evals also launch the forward's). Then a Predictor serves what it wrote
    in the run's own dtype, launching ``serve`` (None: no request);
    ``then(run_dir)``, when given, last -> the traced launches a replay."""
    from maskplanner_tpu_torch import train_maskplanner

    with tempfile.TemporaryDirectory() as out:
        reset_counts()
        run_dir, _ = train_maskplanner.main([
            FLAGSHIP, *extra, "device=cuda", "epochs=2", "eval_freq=1",
            f"dataset_size={steps * BATCH}", "test_dataset_size=8", "seed=1",
            "profile=true", f"output_dir={out}"])
        launches = read_counts()
        path = os.path.join(run_dir, "profile", "trace.json")
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if not kernels:
            raise AssertionError(f"{path} holds no kernel of the card")
        # the driver's default epoch replays the step's CUDA graph
        replays = [e for e in events
                   if e.get("name", "").startswith("cudaGraphLaunch")]
        traced = trace_launches(kernels)
        log(f"[{label}] profile=true: {path} holds the second epoch's "
            f"step, {len(replays)} CUDA graph replay(s), {len(kernels)} "
            f"kernels on the card, {busy_ms(kernels):.3f} ms busy; the "
            f"replay's kernels {traced}")
        if len(replays) != steps:
            raise AssertionError(f"the second epoch's trace holds "
                                 f"{len(replays)} CUDA graph replays")
        replayed = per_replay(traced, steps, expect,
                              f"[{label}] the second epoch")
        backward = [k for k in ("fused_sa_bwd", "sa_weight_grad",
                                "fused_sa_bwd_bf16", "sa_weight_grad_bf16")
                    if expect[k]]
        if not backward or any(launches[k] != 2 * expect[k]
                               for k in backward):
            raise AssertionError(f"the eager step and the capture counted "
                                 f"{launches}")
        if not os.path.isfile(os.path.join(run_dir,
                                           "last_checkpoint.torch.pt")):
            raise AssertionError("train_maskplanner wrote no "
                                 "last_checkpoint")
        check_final_eval(run_dir, label)
        if serve is not None:
            serve_request(run_dir, label, reps=0, expect=serve)
        if then is not None:
            then(run_dir)
    return replayed


# ---------------------------------------------------------------------------
# the eval: metrics, the eval loop, the final eval, the eval CLI, resume
# ---------------------------------------------------------------------------

def phase_eval(cfg, model, res: dict, card: dict, label: str,
               expect: dict) -> dict:
    """``train.loop.evaluate`` at full width on 64 test clouds at batch 64,
    with ``pcd`` and ``stroke_masks_metrics`` and the single-sample latency:
    every kernel's launches (``expect``), finite results; the card's
    outputs scored on the CPU (the plain argmin), pcd within 1e-5 relative
    and the stroke counts equal; the host time of an eval batch with its
    metrics and of the metrics alone. In f32 also the argmin at the pcd
    metric's two searches with the batch's real mask (into ``res``) ->
    the eval's results."""
    from maskplanner_tpu_torch.data import DataLoader, PaintDataset
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.metrics import MetricsHandler
    from maskplanner_tpu_torch.train import batch_to_device, eval_step, forward
    from maskplanner_tpu_torch.train.loop import evaluate

    loader = DataLoader(PaintDataset(cfg, split="test", size=BATCH), BATCH,
                        shuffle=False, drop_last=False)
    handler = LossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    metrics = MetricsHandler(cfg, EVAL_METRICS)
    reset_counts()
    loss, _, values, ms = evaluate(model, loader, handler, weights,
                                   metrics, "cuda", forward=forward)
    launches = read_counts()
    log(f"[{label}] launches in an eval batch with its latency: {launches}")
    if launches != expect:
        raise AssertionError(f"an eval batch launched {launches}, expected "
                             f"{expect}")
    if not all(np.isfinite([loss, ms, *values.values()])):
        raise AssertionError(f"non-finite eval results {loss} {values} {ms}")
    log(f"[{label}] loss {loss:.6f}, " + ", ".join(
        f"{k} {v:.6g}" for k, v in values.items())
        + f"; test_inference_ms {ms:.3f}")

    batch = next(loader.epoch(0))
    b = batch_to_device(batch, "cuda")
    _, _, out = eval_step(model, handler, b, weights)
    kw = dict(y_pred=out.traj, traj_as_pc=b["traj_as_pc"],
              pc_mask=b["stroke_ids_as_pc"] >= 0, n_strokes=batch["n_strokes"],
              pred_stroke_masks=out.stroke_masks, mask_scores=out.mask_scores)
    on_card = metrics.compute(**kw)
    on_cpu = metrics.compute(**{k: v.cpu() if isinstance(v, torch.Tensor)
                                else v for k, v in kw.items()})
    pcd = "point-wise chamfer distance"
    rel = abs(on_card[pcd] - on_cpu[pcd]) / abs(on_cpu[pcd])
    if not rel <= 1e-5 or any(on_card[k] != on_cpu[k] for k in on_cpu
                              if k != pcd):
        raise AssertionError(f"the card's metrics {on_card} differ from its "
                             f"outputs scored on the CPU {on_cpu}")
    if abs(on_card[pcd] - values[pcd]) > 1e-6 * abs(values[pcd]):
        raise AssertionError("evaluate's pcd is not the batch's")
    log(f"[{label}] the card's outputs scored on the CPU: pcd rel Δ "
        f"{rel:.2e}, stroke counts equal")

    def batch_with_metrics():
        _, _, o = eval_step(model, handler, b, weights)
        metrics.compute(**dict(kw, y_pred=o.traj, pred_stroke_masks=o
                               .stroke_masks, mask_scores=o.mask_scores))

    t_batch = median_host_s(batch_with_metrics, 5)
    t_metrics = median_host_s(lambda: metrics.compute(**kw), 5)
    log(f"[{label}] host time at batch {BATCH}: an eval batch with its "
        f"metrics {t_batch * 1e3:.3f} ms, the metrics alone "
        f"{t_metrics * 1e3:.3f} ms")

    if label == "eval":
        poses = out.traj.reshape(BATCH, -1, 6)
        calls = [("pcd predicted poses", poses, b["traj_as_pc"], kw["pc_mask"]),
                 ("pcd GT poses", b["traj_as_pc"], poses, None)]
        r = hold_argmin(calls, card, label)
        r["launches"] = launches["nn_argmin"] - 3
        res["nn_argmin"]["eval_pcd"] = r
        log(f"[{label}] nn_argmin at the pcd metric: {len(calls)} calls "
            f"{r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), instruction floor {r['instr_bound_ms']:.4f} "
            f"ms, torch.cdist+argmin {r['library_ms']:.4f} ms")
    return dict(launches=launches, loss=loss, metrics=values)


def check_final_eval(run_dir: str, label: str) -> None:
    """The final eval of a training run: its dumps load as the JAX tools
    load them, with the JAX dump's keys and numpy arrays; its summary holds
    the final keys; the eval CLI, in a child process, reproduces its test
    loss within 1e-5 relative."""
    results = os.path.join(run_dir, "results")
    names = sorted(os.listdir(results))
    if "last_train_batch0.npy" not in names or not any(
            n.startswith("last_test_batch") for n in names):
        raise AssertionError(f"the final eval wrote {names}")
    for name in names:
        dump = np.load(os.path.join(results, name), allow_pickle=True).item()
        if set(dump) != DUMP_KEYS:
            raise AssertionError(f"{name} holds {sorted(dump)}")
        if not all(dump[k] is None or isinstance(dump[k], np.ndarray)
                   for k in DUMP_KEYS - {"dirnames", "batch", "suffix"}) \
                or dump["traj_pred"].dtype != np.float32:
            raise AssertionError(f"{name}: not numpy float32 on the host")
    with open(os.path.join(run_dir, "summary.json")) as fh:
        summary = json.load(fh)
    missing = [k for k in SUMMARY_KEYS if k not in summary]
    if missing:
        raise AssertionError(f"summary.json lacks {missing}")
    proc = subprocess.run(
        [sys.executable, "-m", "maskplanner_tpu_torch.test_maskplanner",
         "--run", run_dir, "--model", "last", "--save"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the eval CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    line = [l for l in proc.stdout.splitlines() if l.startswith("test loss:")]
    loss = float(line[0].split(":")[1])
    rel = abs(loss - summary["final_test_loss"]) / abs(
        summary["final_test_loss"])
    if not rel <= 1e-5:
        raise AssertionError(f"the eval CLI's test loss {loss} differs from "
                             f"the final eval's {summary['final_test_loss']}")
    log(f"[{label}] final eval: {names}; summary final_test_loss "
        f"{summary['final_test_loss']:.6f}, pcd "
        f"{summary['final_test_point-wise chamfer distance']:.6g}, "
        f"test_inference_ms {summary['test_inference_ms']:.3f}; the eval "
        f"CLI's test loss {loss} (rel Δ {rel:.1e})")


def phase_resume() -> None:
    """Three uninterrupted 2-epoch runs of the flagship on the driver's
    default path (the CUDA-graphed device-resident epoch), one stopped by
    SIGTERM in epoch 1 on the host loader's path (``device_dataset=false``)
    and resumed on the graphed path, one stopped on the graphed path and
    resumed on the host loader's, and a control stopped on the graphed path
    and resumed from a checkpoint whose Adam moments were zeroed.

    The card's scatters sum in launch-dependent order, so no run is bitwise
    another: each parameter group's relative L2 distance between two
    uninterrupted runs is noise, whose size is the largest of the three
    pairs' (one pair alone read 7.4e-4 to 9.2e-4 at sa1, and once 2.30e-4,
    where a sound resume at 7.55e-4 failed a bound of twice it). Each
    resumed run lies within 2x that plus 1e-6 of the first run in every
    group, and the control must lie outside it in some group: the gate
    still catches a resume that loses Adam's state."""
    import signal

    from maskplanner_tpu_torch import train_maskplanner

    args = [FLAGSHIP, "device=cuda", "epochs=2", "eval_freq=1",
            f"dataset_size={BATCH}", "test_dataset_size=8", "seed=1"]

    def params(run_dir):
        blob = torch.load(os.path.join(run_dir, "last_checkpoint.torch.pt"),
                          weights_only=True)
        return {n: v.double() for n, v in blob["model"].items()
                if v.is_floating_point()}

    def zero_moments(path):
        blob = torch.load(path, weights_only=True)
        for state in blob["optimizer"]["state"].values():
            for key in ("exp_avg", "exp_avg_sq"):
                state[key].zero_()
        torch.save(blob, path)

    def stopped_then_resumed(out, stop_on, patched, resume_on, tamper=None):
        """A run on ``device_dataset=stop_on`` whose ``patched`` (module or
        class, attribute) sends SIGTERM after its first call, resumed on
        ``device_dataset=resume_on`` (``tamper(checkpoint path)`` first)."""
        owner, name = patched
        original, calls = getattr(owner, name), []

        def then_sigterm(*a, **k):
            result = original(*a, **k)
            calls.append(1)
            if len(calls) == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return result

        setattr(owner, name, then_sigterm)
        try:
            stopped, _ = train_maskplanner.main(
                [*args, f"device_dataset={stop_on}", f"output_dir={out}"])
        finally:
            setattr(owner, name, original)
        path = os.path.join(stopped, "last_checkpoint.torch.pt")
        if torch.load(path, weights_only=True)["epoch"] != 1:
            raise AssertionError("the stopped run saved another epoch")
        if tamper is not None:
            tamper(path)
        train_maskplanner.main([f"resume={stopped}",
                                f"device_dataset={resume_on}"])
        return stopped

    graphed = (train_maskplanner.DeviceEpoch, "run")
    with tempfile.TemporaryDirectory() as out:
        runs = [params(train_maskplanner.main(
            [*args, f"output_dir={out}/{k}"])[0]) for k in ("a", "b", "c")]
        resumed = {
            "host then graphed": stopped_then_resumed(
                f"{out}/d", "false", (train_maskplanner, "train_step"),
                "auto"),
            "graphed then host": stopped_then_resumed(
                f"{out}/e", "auto", graphed, "false")}
        control = stopped_then_resumed(f"{out}/f", "auto", graphed, "auto",
                                       tamper=zero_moments)
        ref = runs[0]
        pairs = [group_rel_l2(runs[i], runs[j])
                 for i, j in ((0, 1), (0, 2), (1, 2))]
        dist = {k: group_rel_l2(params(r), ref) for k, r in resumed.items()}
        ctrl = group_rel_l2(params(control), ref)
    caught = []
    for g in pairs[0]:
        noise = max(p[g] for p in pairs)
        limit = 2.0 * noise + 1e-6
        log(f"[resume] {g}: uninterrupted pairs "
            + ", ".join(f"{p[g]:.3e}" for p in pairs)
            + "; " + ", ".join(f"{k} {d[g]:.3e}" for k, d in dist.items())
            + f"; limit {limit:.3e}; control (Adam's moments zeroed) "
            f"{ctrl[g]:.3e}")
        for k, d in dist.items():
            if not d[g] <= limit:
                raise AssertionError(f"the run stopped and resumed ({k}) "
                                     f"lies {d[g]} from the first run in "
                                     f"{g}, beyond {limit} (noise {noise})")
        if not ctrl[g] <= limit:
            caught.append(g)
    if not caught:
        raise AssertionError("a resume with Adam's moments zeroed passed the "
                             "resume gate in every group")
    log(f"[resume] the control fails the gate in {len(caught)} group(s): "
        f"{caught}")


def phase_health(then=None) -> None:
    """bench.py's health check on the fixture corpus: 80 epochs of the
    cuboids-v2 debug recipe at batch 8 on the card; every loss finite and
    the last 10 epochs' mean train loss below the first epoch's.
    ``then(run_dir, root, train_losses)``, when given, runs after the
    check on the run, with ``PAINTNET_ROOT`` at the corpus (``root``)."""
    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.data.fixture_category import write_category

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "paintnet")
        write_category(root, "cuboids-v2", **HEALTH_CORPUS)
        os.environ["PAINTNET_ROOT"] = root
        try:
            run_dir, _ = train_maskplanner.main(
                [*HEALTH, "device=cuda", f"output_dir={tmp}"])
            with open(os.path.join(run_dir, "logs.jsonl")) as fh:
                logs = [json.loads(line) for line in fh]
            train = [log_["train_loss"] for log_ in logs]
            evals = [(log_["epoch"], log_["eval_loss"],
                      log_["point-wise chamfer distance"])
                     for log_ in logs if "eval_loss" in log_]
            finite = all(np.isfinite(train)) and all(
                np.isfinite(v) for e in evals for v in e)
            tail = float(np.mean(train[-10:]))
            log(f"[health] {len(train)} epochs in "
                f"{time.perf_counter() - t:.1f} s: train loss epoch 1 "
                f"{train[0]:.2f}, last 10 epochs' mean {tail:.2f}; evals "
                f"(epoch, loss, pcd): {evals}")
            if len(train) != 80 or not finite or not tail < train[0]:
                raise AssertionError("the fixture health check failed")
            if then is not None:
                then(run_dir, root, train)
        finally:
            os.environ.pop("PAINTNET_ROOT", None)


# ---------------------------------------------------------------------------
# the driver's default loop: the device-resident epoch, graphed
# ---------------------------------------------------------------------------

def epoch_split(cfg):
    """The synthetic windows-v2 train split of ``EPOCH_ITEMS`` items,
    materialised once (the dataset caches its items) and staged on the
    card -> (dataset, staged split)."""
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.data.device_dataset import (
        stage_device_dataset, staged_bytes)

    t = time.perf_counter()
    dataset = PaintDataset(cfg, split="train", size=EPOCH_ITEMS)
    data = stage_device_dataset(dataset, device="cuda")
    if data is None:
        raise AssertionError("the train split was not staged")
    log(f"[epoch] {EPOCH_ITEMS} items materialised and staged in "
        f"{time.perf_counter() - t:.1f} s: {staged_bytes(data)} bytes "
        f"({staged_bytes(data) / 2**20:.1f} MiB) on the card")
    return dataset, data


def one_state(ep, perm, cfg, label: str) -> dict:
    """The graphed epoch against the eager one from one state, after the
    host's updates between epochs. Once ``ep``'s graph is captured: an LR
    milestone (the driver's ``MultiStepLR``, milestone 1, gamma 0.5), a
    PSACD step (factor 2) and a delayed stroke-mask activation to targets
    other than the current weights (0.5 and 50), loaded into the loss
    weights' tensors; they must change the LR tensor in place and the
    weights the loss reads. Then from one state (the model's parameters and
    BatchNorm statistics, Adam's moments and step counts, the generator):
    an epoch of the graphed ``DeviceEpoch`` ``ep`` over ``perm``, one of an
    eager ``DeviceEpoch`` on the same model, optimizer, weights and
    generator, and the control, the graph replayed with the LR tensor
    zeroed, which must fail the gate that the graphed epoch must pass
    (``check_one_state``) -> for the graphed epoch and the control, against
    the eager epoch: ``losses``, each loss's relative difference; for each
    kind of state (parameters, BatchNorm statistics, Adam's two moments)
    the L2 distance from the eager epoch's end over the eager epoch's own
    move from the start, over all parameter groups (``whole``) and the
    largest of the groups' (``share``); whether Adam's step counts and the
    generator's state are equal."""
    from maskplanner_tpu_torch.train import (PSACDScheduler,
                                             apply_delayed_activations,
                                             make_lr_scheduler)
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch

    upd = copy.deepcopy(cfg)
    upd["lr_sched"]["step_sizes"] = [1]
    upd["psacd_scheduler"] = dict(active=True, factor=2.0, freq=None,
                                  milestones=[1])
    upd.update(delay_stroke_masks_loss=True, start_stroke_masks_loss_at=1,
               target_explicit_weight_stroke_masks=0.5,
               target_explicit_weight_stroke_masks_confidence=50.0)
    group = ep.optimizer.param_groups[0]
    lr = group["lr"]
    old_lr = float(lr)
    old = {k: float(v) for k, v in ep.weights.items()}
    make_lr_scheduler(ep.optimizer, upd).step()
    floats = PSACDScheduler(upd["psacd_scheduler"]).step_loss_weights(
        dict(old))
    ep.weights.load(apply_delayed_activations(upd, floats, 0))
    moved = {k for k, v in ep.weights.items() if float(v) != old[k]}
    read = {"weight_reverse_asymm_point_chamfer",
            "weight_reverse_asymm_segment_chamfer",
            "explicit_weight_stroke_masks",
            "explicit_weight_stroke_masks_confidence"}
    log(f"[{label}] after the capture: LR {old_lr:.3e} -> {float(lr):.3e} "
        f"in place; loss weights moved: " + ", ".join(
            f"{k} {old[k]:g} -> {float(ep.weights[k]):g}" for k in
            sorted(moved)))
    if group["lr"] is not lr or float(lr) != 0.5 * old_lr or not \
            read <= moved:
        raise AssertionError("the LR milestone, the PSACD step or the "
                             "activation did not update the tensors the "
                             "graph reads")

    names = {p: n for n, p in ep.model.named_parameters()}
    live = {("parameters", n): p for n, p in ep.model.named_parameters()}
    live.update({("BatchNorm statistics", n): b
                 for n, b in ep.model.named_buffers()
                 if b.is_floating_point()})
    for p, st in ep.optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            live[(k, names[p])] = st[k]
    counts = [st["step"] for st in ep.optimizer.state.values()]
    start = {k: t.detach().clone() for k, t in live.items()}
    start_cpu = {k: t.double().cpu() for k, t in start.items()}
    start_counts = [t.clone() for t in counts]
    gen = ep.generator.get_state()

    def epoch(run) -> dict:
        with torch.no_grad():
            for k, t in live.items():
                t.copy_(start[k])
            for t, v in zip(counts, start_counts):
                t.copy_(v)
        ep.generator.set_state(gen)
        losses = run(perm)[0].double().cpu()
        return dict(losses=losses, gen=ep.generator.get_state(),
                    counts=[t.clone() for t in counts],
                    state={k: t.detach().double().cpu()
                           for k, t in live.items()})

    graphed = epoch(ep.run)
    eager = epoch(DeviceEpoch(ep.model, ep.optimizer, ep.handler, ep.data,
                              ep.weights, ep.generator, ep.pc_points,
                              graphed=False).run)
    saved = lr.clone()
    lr.zero_()
    try:
        control = epoch(ep.run)
    finally:
        lr.copy_(saved)

    def against(got: dict) -> dict:
        num, den = {}, {}
        for (kind, n), ref in eager["state"].items():
            key = (kind, group_of(n))
            num[key] = num.get(key, 0.0) + float(
                ((got["state"][(kind, n)] - ref) ** 2).sum())
            den[key] = den.get(key, 0.0) + float(
                ((ref - start_cpu[(kind, n)]) ** 2).sum())
        share, whole = {}, {}
        for (kind, g), d in den.items():
            v = ((num[kind, g] / d) ** 0.5 if d > 0
                 else 0.0 if num[kind, g] == 0 else float("inf"))
            share[kind] = max(share.get(kind, 0.0), v)
            n0, d0 = whole.get(kind, (0.0, 0.0))
            whole[kind] = (n0 + num[kind, g], d0 + d)
        whole = {k: (n / d) ** 0.5 if d > 0 else float("inf")
                 for k, (n, d) in whole.items()}
        losses = ((got["losses"] - eager["losses"]).abs()
                  / eager["losses"].abs()).tolist()
        return dict(losses=losses, share=share, whole=whole,
                    counts=all(torch.equal(a, b) for a, b in
                               zip(got["counts"], eager["counts"])),
                    gen=torch.equal(got["gen"], eager["gen"]))

    out = {"graphed": against(graphed), "control": against(control)}
    for name, r in out.items():
        log(f"[{label}] from one state, the {name} epoch against the eager "
            f"epoch: losses relative " + " ".join(
                f"{v:.1e}" for v in r["losses"])
            + f" (mean {statistics.mean(r['losses']):.2e})"
            + "; share of the eager epoch's move, all groups / the largest "
            "group's: " + ", ".join(f"{k} {r['whole'][k]:.2e} / {v:.2e}"
                                    for k, v in r["share"].items())
            + f"; Adam step counts equal {r['counts']}, generator equal "
            f"{r['gen']}")
    return out


def check_one_state(readings: dict, label: str) -> None:
    """``one_state``'s gate: the mean of the 8 losses' relative differences
    within ``ONE_STATE_LOSS_TOL``, the parameters' and the BatchNorm
    statistics' shares (all groups) within ``ONE_STATE_PARAM_TOL`` and
    ``ONE_STATE_BN_TOL``, Adam's step counts and the generator equal. The
    graphed epoch must pass it; the control must fail both its loss part
    and its state part."""
    def fails(r: dict) -> dict:
        whole = r["whole"]
        return dict(losses=not statistics.mean(r["losses"])
                    <= ONE_STATE_LOSS_TOL,
                    state=not (whole["parameters"] <= ONE_STATE_PARAM_TOL
                               and whole["BatchNorm statistics"]
                               <= ONE_STATE_BN_TOL),
                    counts=not r["counts"], generator=not r["gen"])

    graphed, control = fails(readings["graphed"]), fails(readings["control"])
    if any(graphed.values()):
        raise AssertionError(f"[{label}] from one state the graphed epoch "
                             f"fails the gate: {graphed}")
    if not (control["losses"] and control["state"]):
        raise AssertionError(f"[{label}] the control (the graph replayed "
                             f"with the LR zeroed) passes the gate: "
                             f"{control}")


def phase_device_epoch(cfg, dataset, data, label: str,
                       expect: dict) -> dict:
    """The driver's training loops at batch 64 over ``dataset`` (staged as
    ``data``), each from the same seeded weights and generator seed: (a)
    the host loader through the ``Prefetcher``, (b) the device-resident
    epoch run eagerly, three times, (c) the device-resident epoch as CUDA
    graph replays. In the first two graphed epochs (the eager first step,
    the capture, 15 replays) the wrappers must count ``expect`` twice (the
    eager step and the capture; a replay runs no Python). The graphed
    epochs leave the generator in the eager runs' state, and their losses
    are finite and fall over 30 steps. The gate from one state after the
    host's updates, with its control (``one_state``, ``check_one_state``).
    After 2 epochs each parameter group's relative L2 distance from the
    first eager run is logged, the graphed run's beside the three eager
    pairs'. For each loop: ms a step by the host clock (two epochs after
    the first two, each ending in a synchronize, their mean), device busy
    ms a step (the union of the kernel intervals in a ``torch.profiler``
    trace of the next epoch) and the idle share, 1 - busy / wall. The
    traced epoch's launches, with the counts set to 0 just before it: in
    the eager loops the wrappers' counts, which must be ``expect`` a step;
    in the graphed loop (8 replays) the trace's (``trace_launches``), which
    must be ``expect`` a replay (``per_replay``), with the wrappers' 0 ->
    the graphed traced epoch's launches, each loop's numbers and the
    graph's pool bytes."""
    from maskplanner_tpu_torch.data import DataLoader
    from maskplanner_tpu_torch.data.device_dataset import epoch_perm
    from maskplanner_tpu_torch.data.prefetch import Prefetcher
    from maskplanner_tpu_torch.losses import DeviceWeights, LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import make_optimizer
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch, host_epoch

    n = len(dataset)
    steps = n // BATCH
    handler = LossHandler(cfg["loss"], cfg)

    def loop(kind: str):
        """A fresh run -> (model, its epoch function, its DeviceEpoch)."""
        model = get_model(cfg, device="cuda",
                          generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(model, cfg)
        weights = DeviceWeights(active_weights(cfg, handler), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        if kind == "host loader":
            fetch = Prefetcher(DataLoader(dataset, BATCH, shuffle=True,
                                          seed=0), "cuda")
            return model, lambda e: host_epoch(
                model, opt, handler, fetch.epoch(e), weights, gen), None
        ep = DeviceEpoch(model, opt, handler, data, weights, gen,
                         int(cfg["pc_points"]), graphed=kind == "graphed")
        return model, lambda e: ep.run(epoch_perm(n, BATCH, 0, e)), ep

    def params(model, gen):
        return ({k: p.detach().double().cpu()
                 for k, p in model.named_parameters()}, gen.get_state())

    def measure(kind: str, run, first: int) -> dict:
        walls = []
        for e in range(first, first + 2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(e)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3 / steps)
        wall = statistics.mean(walls)
        reset_counts()
        kernels = traced_kernels(lambda: run(first + 2))
        wrapped = read_counts()
        busy = busy_ms(kernels) / steps
        log(f"[{label}] {kind}: {wall:.3f} ms a step (host clock, epochs "
            f"{first + 1}-{first + 2}: " + ", ".join(f"{w:.3f}"
                                                    for w in walls)
            + f"), device busy {busy:.3f} ms a step, idle share "
            f"{1.0 - busy / wall:.3f}")
        want = {k: v * steps for k, v in expect.items()}
        res = dict(ms=wall, busy_ms=busy, idle=1.0 - busy / wall)
        if "graphed" not in kind:
            if wrapped != want:
                raise AssertionError(f"an epoch of {kind} launched "
                                     f"{wrapped}, expected {want}")
            return res
        # the main path: every step a replay, which runs no Python, so
        # its kernels come from the trace, with the counts set to 0 just
        # before it
        res["launches"] = trace_launches(kernels)
        log(f"[{label}] launches in a graphed epoch of {steps} replays, "
            f"from its trace: {res['launches']}")
        if any(wrapped.values()):
            raise AssertionError(f"a graphed epoch's replays counted "
                                 f"{wrapped} in the wrappers")
        per_replay(res["launches"], steps, expect,
                   f"[{label}] a graphed epoch")
        return res

    out = {}
    # (b) three times, for the spread of the eager runs
    eager = []
    for i in range(3):
        model, run, ep = loop("eager")
        for e in range(2):
            run(e)
        eager.append(params(model, ep.generator))
        if i == 0:
            out["eager"] = measure("device-resident, eager", run, 2)
        del model, run, ep
    # (c)
    model, run, ep = loop("graphed")
    reset_counts()
    curve = [run(e)[0] for e in range(2)]
    wrapped = read_counts()
    log(f"[{label}] launches in 2 graphed epochs of {steps} steps counted "
        f"by the wrappers (the eager first step and the capture): "
        f"{wrapped}; CUDA graph pool {ep.pool_bytes} bytes "
        f"({ep.pool_bytes / 2**20:.1f} MiB)")
    if wrapped != {k: v * 2 for k, v in expect.items()}:
        raise AssertionError(f"the eager step and the capture counted "
                             f"{wrapped}, {expect} each expected")
    graphed, gen_state = params(model, ep.generator)
    if not all(torch.equal(gen_state, g) for _, g in eager):
        raise AssertionError("the graphed epochs left the generator "
                             "elsewhere than the eager epochs")
    curve += [run(e)[0] for e in range(2, 4)]
    curve = torch.cat(curve).tolist()[:30]
    log(f"[{label}] graphed 30-step loss curve: "
        + " ".join(f"{v:.1f}" for v in curve))
    first, last = np.mean(curve[:steps]), np.mean(curve[-steps:])
    if not all(np.isfinite(curve)) or not last < first:
        raise AssertionError(f"the graphed epochs' loss did not fall over 30 "
                             f"steps ({first} -> {last}), or went "
                             f"non-finite")
    out["graphed"] = measure("device-resident, graphed", run, 4)
    launches = out["graphed"].pop("launches")
    out["pool_bytes"] = ep.pool_bytes
    check_one_state(one_state(ep, epoch_perm(n, BATCH, 0, 7), cfg, label),
                    label)
    del model, run, ep
    pairs = [group_rel_l2(eager[j][0], eager[i][0])
             for i, j in ((0, 1), (0, 2), (1, 2))]
    dist = group_rel_l2(graphed, eager[0][0])
    log(f"[{label}] after 2 epochs, each group's relative L2 distance from "
        f"the first eager run, graphed / the eager pairs (1-2, 1-3, 2-3): "
        + ", ".join(f"{g} {dist[g]:.2e} / " + " ".join(
            f"{p[g]:.2e}" for p in pairs) for g in dist))
    # (a)
    model, run, _ = loop("host loader")
    for e in range(2):
        run(e)
    out["host loader"] = measure("host loader (Prefetcher)", run, 2)
    del model, run
    torch.cuda.empty_cache()
    return dict(launches=launches, **out)


# ---------------------------------------------------------------------------
# the reference BatchNorm recipe (model.norm=batch)
# ---------------------------------------------------------------------------

def bn_model(cfg):
    """The seeded BatchNorm-recipe model in eval, its running statistics
    drawn away from 0/1 so that the folded weights differ from the raw
    ones."""
    from maskplanner_tpu_torch.models import get_model

    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return model


def scan_ops(radius: float, K: int, xyz, new_xyz) -> float:
    """Operations of the first-K ball-query scan that these inputs need:
    per query, every point up to its K-th in-radius neighbour (all N
    without K of them), 9 operations a point (3 sub, 3 mul, 2 add, a
    compare)."""
    from maskplanner_tpu_torch.ops.distance import square_distance

    N = xyz.shape[1]
    rank = (square_distance(new_xyz, xyz) <= radius ** 2).int().cumsum(-1)
    # the points before the K-th in-radius one have rank < K
    scanned = torch.where(rank[..., -1] >= K, (rank < K).sum(-1) + 1, N)
    return 9.0 * float(scanned.double().sum())


def check_close(what: str, got, ref, rel: float) -> float:
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= rel * scale:
        raise AssertionError(f"{what}: max|Δ| {err} > {rel} x {scale}")
    return err


def phase_bn_kernels(model, batch, res: dict) -> dict:
    """The ball-group gather, its backward, the ball query and the folded
    level against their plain versions at the step's sa1 and sa2 shapes.
    Returns the launches of the ball query and the folded level, driven
    once a level through their entry points (no model path runs them)."""
    from maskplanner_tpu_torch.ops.cuda.group_gather import ball_group_cuda
    from maskplanner_tpu_torch.ops.fused_sa import (fold_pointmlp_params,
                                                    fused_sa_forward_plain,
                                                    fused_set_abstraction)
    from maskplanner_tpu_torch.ops.group_gather import (ball_group_backward,
                                                        ball_group_plain)
    from maskplanner_tpu_torch.ops.sampling import (ball_query_plain,
                                                    farthest_point_sample,
                                                    index_points,
                                                    query_ball_point)

    pc = batch["point_cloud"]
    gen = torch.Generator(device=pc.device).manual_seed(2)
    own = launches_of()
    ops = {k: 0.0 for k in ("ball_group", "ball_query", "fused_sa_folded")}
    nbytes = dict(ops)
    tf32 = 0.0  # the folded level's products, on the tensor cores
    # sa2's inputs: the model's own sa1 (eval)
    for name, sa, pts, feats in (("sa1", model.sa1, pc, None),
                                 ("sa2", model.sa2, *model.sa1(pc, None))):
        B, N, _ = pts.shape
        S, K, r = sa.npoint, sa.nsample, sa.radius
        new_xyz = index_points(pts, farthest_point_sample(pts, S))
        F = 0 if feats is None else feats.shape[-1]
        scan = scan_ops(r, K, pts, new_xyz)
        in_bytes = 4.0 * (pts.numel() + new_xyz.numel()
                          + (0 if feats is None else feats.numel()))
        idx_bytes = 4.0 * B * S * K
        # -- the ball-group gather (#6) ---------------------------------------
        got, idx = ball_group_cuda(r, K, pts, new_xyz, feats)
        ref, ref_idx = ball_group_plain(r, K, pts, new_xyz, feats)
        torch.cuda.synchronize()
        if not torch.equal(idx, ref_idx):
            raise AssertionError(f"ball_group {name}: indices differ at "
                                 f"{int((idx != ref_idx).sum())} places")
        err = check_close(f"ball_group {name}", got, ref, 1e-6)
        ms = median_ms(lambda: ball_group_cuda(r, K, pts, new_xyz, feats), 20)
        plain = median_ms(lambda: ball_group_plain(r, K, pts, new_xyz, feats),
                          5, 1)
        log(f"[bn-kernels] ball_group {name} B={B} N={N} S={S} K={K} F={F}: "
            f"idx identical, max|Δ| {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms")
        rb = res["ball_group"]
        rb["max_abs_err"] = max(rb["max_abs_err"], err)
        rb["ms"] += ms
        rb.setdefault("level_ms", {})[name] = ms
        rb["plain_ms"] += plain
        ops["ball_group"] += scan + B * S * K * 3.0
        nbytes["ball_group"] += in_bytes + 4.0 * got.numel() + idx_bytes
        # -- its backward (index_add_), against autograd through the plain
        leaves = [pts.clone().requires_grad_(True),
                  new_xyz.clone().requires_grad_(True),
                  None if feats is None
                  else feats.clone().requires_grad_(True)]
        ct = torch.randn(got.shape, generator=gen, device=got.device)
        with torch.enable_grad():
            g_ref = torch.autograd.grad(
                (ball_group_plain(r, K, *leaves)[0] * ct).sum(),
                [t for t in leaves if t is not None])
        g_got = ball_group_backward(idx, ct, N, True, True, feats is not None)
        for what, a, b in zip(("d_xyz", "d_new_xyz", "d_features"), g_got,
                              g_ref):
            e = check_close(f"ball_group backward {name} {what}", a, b, 1e-5)
            log(f"[bn-kernels]   backward {what}: max|Δ| {e:.3e} "
                f"(max|ref| {float(b.abs().max()):.3e})")
        if feats is not None:
            # the step's backward: d_features alone (the points are data)
            bwd = median_ms(lambda: ball_group_backward(idx, ct, N, False,
                                                        False, True), 10)
            log(f"[bn-kernels] ball_group backward {name} (index_add_ of "
                f"d_features, as in the step): {bwd:.4f} ms")
        # -- the ball query (#7), through its entry point -----------------------
        reset_counts()
        q_idx = query_ball_point(r, K, pts, new_xyz)
        own["ball_query"] += read_counts()["ball_query"]
        q_ref = ball_query_plain(r, K, pts, new_xyz)
        if not torch.equal(q_idx, q_ref) or not torch.equal(q_idx, idx):
            raise AssertionError(f"ball_query {name}: indices differ")
        ms = median_ms(lambda: query_ball_point(r, K, pts, new_xyz), 20)
        plain = median_ms(lambda: ball_query_plain(r, K, pts, new_xyz), 5, 1)
        log(f"[bn-kernels] ball_query {name}: identical; kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms")
        res["ball_query"]["ms"] += ms
        res["ball_query"].setdefault("level_ms", {})[name] = ms
        res["ball_query"]["plain_ms"] += plain
        ops["ball_query"] += scan
        nbytes["ball_query"] += 4.0 * (pts.numel() + new_xyz.numel()) \
            + idx_bytes
        # -- the folded level (#8), through its entry point ---------------------
        folded = [(w.detach(), b.detach()) for w, b in
                  fold_pointmlp_params(sa)]
        reset_counts()
        pooled = fused_set_abstraction(r, K, pts, new_xyz, feats, folded)
        own["fused_sa_folded"] += read_counts()["fused_sa_folded"]
        p_ref, _ = fused_sa_forward_plain(r, K, "none", pts, new_xyz, feats,
                                          folded)
        err = check_close(f"fused_sa_folded {name}", pooled, p_ref, REL_TOL)
        ms = median_ms(lambda: fused_set_abstraction(r, K, pts, new_xyz,
                                                     feats, folded), 20)
        plain = median_ms(lambda: fused_sa_forward_plain(
            r, K, "none", pts, new_xyz, feats, folded), 5, 1)
        log(f"[bn-kernels] fused_sa_folded {name}: max|Δ| {err:.3e} "
            f"(max|ref| {float(p_ref.abs().max()):.3e}); kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms")
        rf = res["fused_sa_folded"]
        rf["max_abs_err"] = max(rf["max_abs_err"], err)
        rf["ms"] += ms
        rf["plain_ms"] += plain
        acts = sum(c.out_features for c in sa.mlp_convs)
        # the MLP's multiply-adds, a ReLU an activation, and the scan
        ops["fused_sa_folded"] += scan + B * S * K * acts
        tf32 += B * S * K * 2.0 * mlp_macs(sa)
        nbytes["fused_sa_folded"] += in_bytes + 4.0 * sum(
            w.numel() + b.numel() for w, b in folded) \
            + 4.0 * pooled.numel()
    for name in ops:
        # the f32 rule: the folded level's products at the CUDA cores' rate
        extra = tf32 if name == "fused_sa_folded" else 0.0
        res[name].update(bound(ops[name] + extra, nbytes[name]))
        res[name]["library_ms"] = None
    rf = res["fused_sa_folded"]
    rf.update(bound(ops["fused_sa_folded"], nbytes["fused_sa_folded"], tf32,
                    "mix_"))
    log(f"[bn-kernels] fused_sa_folded bound: f32 rule {rf['bound_ms']:.4f} "
        f"ms, this design's mix {rf['mix_bound_ms']:.4f} ms "
        f"({rf['mix_bound_by']})")
    return own


def ball_edge_cases() -> dict:
    """Inputs at the edges of the ball kernels' design (name: radius, K,
    xyz, new_xyz, features), on the card: the queries are points of the
    cloud (as FPS picks them) unless moved away on purpose."""
    gen = torch.Generator().manual_seed(5)

    def case(B, N, S, K, F, r, cloud=None, far=0):
        xyz = (torch.rand((B, N, 3), generator=gen) * 2 - 1
               if cloud is None else cloud)
        pick = torch.stack([torch.randperm(N, generator=gen)[:S]
                            for _ in range(B)])
        q = torch.gather(xyz, 1, pick[..., None].expand(B, S, 3)).clone()
        q[:, :far] += 100.0          # empty balls
        f = torch.randn((B, N, F), generator=gen) if F else None
        return tuple(None if t is None else t.cuda()
                     for t in (xyz, q, f)), (r, K)

    dup = (torch.rand((2, 40, 3), generator=gen) * 2 - 1).repeat(1, 16, 1)
    cases = {
        "batch 1, sa1 widths": case(1, 5120, 512, 32, 0, 0.2),
        "batch 1, sa2 widths": case(1, 512, 128, 64, 128, 0.4),
        # 140 clouds: enough blocks that a staged block takes 32 queries
        "S off a block's queries (staged, 32 a block)": case(140, 5120, 37,
                                                             32, 0, 0.3),
        "S off a block's queries (8 a block)": case(3, 512, 13, 16, 7, 0.5),
        "N below a warp": case(2, 20, 7, 8, 5, 0.8),
        "N off the scan step": case(2, 300, 50, 16, 3, 0.5),
        "duplicated points": case(2, 640, 64, 32, 4, 0.6, cloud=dup),
        "sparse and empty balls": case(2, 1000, 64, 16, 2, 0.05, far=20),
        "K above N": case(2, 20, 9, 48, 6, 1.0),
        "odd K, rows off 16 bytes": case(2, 512, 30, 7, 128, 0.5),
        "one feature channel": case(2, 256, 33, 5, 1, 0.4),
        "cloud past the staging limit": case(2, 13000, 40, 32, 0, 0.1),
    }
    return cases


def check_ball_edges() -> None:
    """The ball-group gather (#6), its single pass (6b) and the ball query
    (#7) against their plain versions on ``ball_edge_cases``: indices
    identical, f32 values within 1e-6 · max|ref|, the single pass
    bit-equal."""
    from maskplanner_tpu_torch.ops.cuda.group_gather import (
        ball_group_cuda, ball_group_single_cuda, ball_query_cuda)
    from maskplanner_tpu_torch.ops.distance import square_distance
    from maskplanner_tpu_torch.ops.group_gather import ball_group_plain

    for what, ((xyz, q, f), (r, K)) in ball_edge_cases().items():
        got, idx = ball_group_cuda(r, K, xyz, q, f)
        ref, ref_idx = ball_group_plain(r, K, xyz, q, f)
        one, one_idx = ball_group_single_cuda(r, K, xyz, q, f)
        one_ref, _ = ball_group_plain(r, K, xyz, q, f, single_pass=True)
        q_idx = ball_query_cuda(r, K, xyz, q)
        torch.cuda.synchronize()
        for name, a in (("ball_group", idx), ("ball_group_single", one_idx),
                        ("ball_query", q_idx)):
            if not torch.equal(a, ref_idx):
                raise AssertionError(f"{name} {what}: indices differ at "
                                     f"{int((a != ref_idx).sum())} places")
        err = check_close(f"ball_group {what}", got, ref, 1e-6)
        if not torch.equal(one, one_ref):
            raise AssertionError(f"ball_group_single {what}: values differ")
        found = (square_distance(q, xyz) <= r ** 2).sum(-1)
        log(f"[bn-kernels] ball edges, {what}: B={xyz.shape[0]} "
            f"N={xyz.shape[1]} S={q.shape[1]} K={K} "
            f"F={0 if f is None else f.shape[-1]}: indices identical (#6, "
            f"6b, #7), max|Δ| {err:.3e}, single pass bit-equal; "
            f"{float((found < K).double().mean()):.2f} of the balls hold "
            f"fewer than K points, {float((found == 0).double().mean()):.2f} "
            f"none")


# ---------------------------------------------------------------------------
# bf16 serving (model.bf16=true)
# ---------------------------------------------------------------------------

def bf16_twin(cfg, model):
    """The bf16 model of the f32 ``cfg`` on ``model``'s weights, in eval on
    the card."""
    from maskplanner_tpu_torch.models import get_model

    bf16_cfg = copy.deepcopy(cfg)
    bf16_cfg["model"]["bf16"] = True
    twin = get_model(bf16_cfg, device="cuda")
    twin.load_state_dict(model.state_dict())
    return twin


def phase_bf16_kernels(model, xyz: torch.Tensor, res: dict) -> None:
    """The fused SA forward's bf16 mode against the plain bf16 level at the
    flagship sa1/sa2 shapes (batch 64). Kernel and plain round the same
    operands but sum in other orders, and a one-ulp float32 difference can
    flip the bf16 rounding of the next layer's input: so the plain level's
    own spread, max|float32 − float64 sums of the same bf16 operands|, is
    measured, and the kernel held within 3x that of the float64 level."""
    from maskplanner_tpu_torch.ops.cuda.fused_sa import fused_sa_bf16_cuda
    from maskplanner_tpu_torch.ops.fused_sa import fused_sa_forward_plain
    from maskplanner_tpu_torch.ops.sampling import (farthest_point_sample,
                                                    index_points)

    r = res["fused_sa_fwd_bf16"]
    r["spread"] = {}
    ops = products = nbytes = 0.0
    pts, feats = xyz, None
    for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
        B, N, _ = pts.shape
        S, K = sa.npoint, sa.nsample
        new_xyz = index_points(pts, farthest_point_sample(pts, S))
        params = [tuple(t.detach() for t in layer)
                  for layer in sa.layer_params()]
        args = (sa.radius, K)
        pooled, idx = fused_sa_bf16_cuda(*args, True, pts, new_xyz, feats,
                                         params)
        ref, ref_idx = fused_sa_forward_plain(*args, "layer", pts, new_xyz,
                                              feats, params, "bf16")
        ref64, _ = fused_sa_forward_plain(
            *args, "layer", pts.double(), new_xyz.double(),
            None if feats is None else feats.double(),
            [tuple(t.double() for t in layer) for layer in params], "bf16")
        torch.cuda.synchronize()
        if not torch.equal(idx, ref_idx):
            raise AssertionError(f"fused SA bf16 {name}: kernel neighbour "
                                 f"indices differ from the plain version")
        spread = float((ref.double() - ref64).abs().max())
        err = float((pooled.double() - ref64).abs().max())
        scale = float(ref64.abs().max())
        rms_k = float((pooled.double() - ref64).norm() / ref64.norm())
        rms_p = float((ref.double() - ref64).norm() / ref64.norm())
        if not err <= 3.0 * spread:
            raise AssertionError(f"fused SA bf16 {name}: max|kernel − "
                                 f"float64| {err} > 3 x the plain level's "
                                 f"{spread}")
        ms = median_ms(lambda: fused_sa_bf16_cuda(*args, True, pts, new_xyz,
                                                  feats, params), 20)
        plain = median_ms(lambda: fused_sa_forward_plain(
            *args, "layer", pts, new_xyz, feats, params, "bf16"), 5, 1)
        log(f"[bf16-kernels] fused_sa_fwd_bf16 {name} N={N} S={S} K={K}: "
            f"idx identical; from the float64 sums max|Δ| kernel {err:.3e}, "
            f"plain {spread:.3e} (max|ref| {scale:.3e}; rel. rms kernel "
            f"{rms_k:.2e}, plain {rms_p:.2e}); kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms")
        r["max_abs_err"] = max(r["max_abs_err"],
                               float((pooled - ref).abs().max()))
        r["spread"][name] = spread
        r["ms"] += ms
        r["plain_ms"] += plain
        rows = B * S * K
        acts = sum(c.out_features for c in sa.mlp_convs)
        ops += rows * 8.0 * acts            # bias, LayerNorm, ReLU, max
        products += rows * 2.0 * mlp_macs(sa)
        # the clouds, the bf16 weights, the f32 vectors, pooled and idx
        nbytes += (4.0 * (pts.numel() + new_xyz.numel()
                          + (0 if feats is None else feats.numel()))
                   + sum(2.0 * w.numel() + 4.0 * sum(t.numel() for t in v)
                         for w, *v in params)
                   + 4.0 * (pooled.numel() + idx.numel()))
        pts, feats = new_xyz, pooled
    r.update(bound(ops, nbytes, bf16_ops=products))
    r["library_ms"] = None
    log(f"[bf16-kernels] fused_sa_fwd_bf16: {r['ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {products / 1e9:.1f} "
        f"GFLOP of bf16 products)")


def phase_bf16_group(model, clouds: np.ndarray, res: dict) -> None:
    """The single-pass ball-group gather against its plain version at the
    BatchNorm recipe's serving shapes (batch 64; sa2's features from the
    bf16 model's sa1): indices and values identical."""
    from maskplanner_tpu_torch.ops.cuda.group_gather import \
        ball_group_single_cuda
    from maskplanner_tpu_torch.ops.group_gather import ball_group_plain
    from maskplanner_tpu_torch.ops.sampling import (farthest_point_sample,
                                                    index_points)

    r = res["ball_group_single"]
    ops = nbytes = 0.0
    pc = torch.from_numpy(clouds).cuda()
    for name, sa, pts, feats in (("sa1", model.sa1, pc, None),
                                 ("sa2", model.sa2, *model.sa1(pc, None))):
        B, N, _ = pts.shape
        S, K, rad = sa.npoint, sa.nsample, sa.radius
        new_xyz = index_points(pts, farthest_point_sample(pts, S))
        got, idx = ball_group_single_cuda(rad, K, pts, new_xyz, feats)
        ref, ref_idx = ball_group_plain(rad, K, pts, new_xyz, feats,
                                        single_pass=True)
        torch.cuda.synchronize()
        if not torch.equal(idx, ref_idx) or not torch.equal(got, ref):
            raise AssertionError(f"ball_group_single {name}: indices or "
                                 f"values differ from the plain version")
        ms = median_ms(lambda: ball_group_single_cuda(rad, K, pts, new_xyz,
                                                      feats), 20)
        plain = median_ms(lambda: ball_group_plain(
            rad, K, pts, new_xyz, feats, single_pass=True), 5, 1)
        log(f"[bf16-kernels] ball_group_single {name} B={B} N={N} S={S} "
            f"K={K}: idx and values identical; kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms")
        r["ms"] += ms
        r.setdefault("level_ms", {})[name] = ms
        r["plain_ms"] += plain
        ops += scan_ops(rad, K, pts, new_xyz) + B * S * K * 6.0
        nbytes += (4.0 * (pts.numel() + new_xyz.numel()
                          + (0 if feats is None else feats.numel()))
                   + 2.0 * got.numel() + 4.0 * idx.numel())
    r.update(bound(ops, nbytes))
    r["library_ms"] = None
    log(f"[bf16-kernels] ball_group_single: {r['ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def phase_bf16_gap(f32_model, bf16_model, clouds: np.ndarray,
                   label: str) -> None:
    """The bf16 forward against the f32 one on the same weights and the 64
    clouds: relative errors of the segments, the stroke-mask logits and
    the mask scores, and the share of mask logits whose sign (a segment's
    membership) agrees."""
    x = torch.from_numpy(clouds).cuda()
    with torch.inference_mode():
        ref, got = f32_model(x), bf16_model(x)
    parts = []
    for field in ("traj", "stroke_masks", "mask_scores"):
        a, b = getattr(ref, field).double(), getattr(got, field).double()
        l2 = float((b - a).norm() / a.norm())
        mx = float((b - a).abs().max() / a.abs().max())
        parts.append(f"{field} rel. L2 {l2:.3e}, max {mx:.3e}")
        if field == "traj" and not l2 <= 5e-2:
            raise AssertionError(f"{label}: bf16 traj lies {l2} (relative "
                                 f"L2) from f32")
    agree = float(((got.stroke_masks > 0) == (ref.stroke_masks > 0))
                  .double().mean())
    log(f"[{label}] bf16 − f32 at batch {BATCH}: {'; '.join(parts)}; "
        f"mask-logit signs agree {agree:.5f}")


def phase_bf16(cfg, model, clouds: np.ndarray, label: str, expect: dict):
    """A recipe's bf16 serving on ``model``'s weights: its forward (launch
    counts, card against CPU, times, profiles), its gap from f32, and a
    Predictor request -> (the forward's launches, the bf16 model)."""
    twin = bf16_twin(cfg, model)
    launches = phase_forward(twin, clouds, label, expect, bf16=True)
    phase_bf16_gap(model, twin, clouds, label)
    phase_serve(cfg, model, f"{label}-serve", 1, expect, "bf16")
    return launches, twin


# ---------------------------------------------------------------------------
# bf16 training (model.bf16=true)
# ---------------------------------------------------------------------------

def phase_bf16_train_kernels(model, batch, res: dict) -> None:
    """The fused SA backward's bf16 mode (K1 ``fused_sa_bwd_bf16`` then K2
    ``sa_weight_grad_bf16``) at the step's sa1 and sa2 shapes (a batch of
    64 of the train split, sa2's features from the bf16 forward of sa1),
    against the plain bf16 backward (``fused_sa_backward_plain(...,
    precision="bf16")`` on the plain forward's own pooled output).

    Each gradient is held against the plain level with float64 sums of the
    same bf16 operands (``check_against_exact``): kernel and plain round
    the same operands but sum in other orders, and one float32 ulp can
    flip the bf16 rounding of a later operand or a max-pool near-tie, so
    the kernel is allowed 3x the plain float32 level's own rms error from
    the float64 one (the bf16 forward's rule, ``phase_bf16_kernels``).
    Every positive max-pool output routed (``check_routing`` on the bf16 forward's
    pooled), the weight gradients bitwise equal across two launches; K1
    and K2 timed apart, the plain backward beside them; the bound by this
    design's mix (bf16 products at the tensor cores' bf16 rate, the rest at
    the f32 rate)."""
    from maskplanner_tpu_torch.ops.cuda.fused_sa import (
        fused_sa_backward_cuda, fused_sa_bf16_cuda, fused_sa_bwd_bf16_cuda,
        sa_weight_grad_bf16_cuda, scratch_floats)
    from maskplanner_tpu_torch.ops.fused_sa import (fused_sa_backward_plain,
                                                    fused_sa_forward_plain)
    from maskplanner_tpu_torch.ops.sampling import (farthest_point_sample,
                                                    index_points)

    gen = torch.Generator(device="cuda").manual_seed(2)
    k1, k2 = res["fused_sa_bwd_bf16"], res["sa_weight_grad_bf16"]
    work = {name: dict(ops=0.0, bf16=0.0, bytes=0.0, design_bytes=0.0)
            for name in ("fused_sa_bwd_bf16", "sa_weight_grad_bf16")}
    pts, feats = batch["point_cloud"], None
    for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
        B, N, _ = pts.shape
        S, K = sa.npoint, sa.nsample
        new_xyz = index_points(pts, farthest_point_sample(pts, S))
        params = [tuple(t.detach() for t in layer)
                  for layer in sa.layer_params()]
        leaves = [pts, new_xyz, feats]
        pooled, idx = fused_sa_bf16_cuda(sa.radius, K, True, *leaves, params)
        ct = torch.randn(pooled.shape, generator=gen, device="cuda")
        reset_counts()
        d_xyz, d_new, d_feat, grads = fused_sa_backward_cuda(
            K, True, *leaves, params, idx, pooled, ct, bf16=True)
        counts = read_counts()
        if (counts["fused_sa_bwd_bf16"], counts["sa_weight_grad_bf16"]) \
                != (1, 1):
            raise AssertionError("the bf16 backward did not run K1 and K2 "
                                 "once each")
        got = [d_xyz, d_new] + ([] if feats is None else [d_feat]) + [
            g for layer in grads for g in layer]

        def plain(ls, ps):
            out, i = fused_sa_forward_plain(sa.radius, K, "layer", *ls, ps,
                                            "bf16")
            dx, dn, df, gs = fused_sa_backward_plain(
                K, "layer", *ls, ps, i, out, ct.to(out.dtype),
                precision="bf16")
            return i, [dx, dn] + ([] if df is None else [df]) + [
                g for layer in gs for g in layer]

        ridx, ref = plain(leaves, params)
        if not torch.equal(idx, ridx):
            raise AssertionError(f"fused SA bf16 {name}: neighbour indices "
                                 f"differ")
        _, ref64 = plain([None if t is None else t.double() for t in leaves],
                         [tuple(t.double() for t in l) for l in params])
        names = ["d_xyz", "d_new_xyz"] + ([] if feats is None
                                          else ["d_features"])
        names += [f"L{j}.{n}" for j in range(len(params))
                  for n in ("dW", "db", "dgamma", "dbeta")]
        log(f"[bf16-train-kernels] fused_sa_bwd_bf16 {name} B={B} N={N} "
            f"S={S} K={K}:")
        check_routing(name, sa, leaves, params, idx, pooled, bf16=True)
        for n, a, b, c in zip(names, got, ref, ref64):
            err = check_against_exact(n, a, b, c)
            r = k2 if n.startswith("L") else k1
            r["max_abs_err"] = max(r["max_abs_err"], err)
        # times: K1 with the step's flags (sa2's features alone carry a
        # gradient), K2 on its rows, and the plain bf16 backward
        needs = (False, False, feats is not None)
        args = (K, True, *leaves, params, idx, pooled, ct)
        check_deterministic(name, args, bf16=True)
        _, _, _, scratch, vec, chans = fused_sa_bwd_bf16_cuda(*args, needs)
        rows = idx.numel()
        ms1 = median_ms(lambda: fused_sa_bwd_bf16_cuda(*args, needs), 5)
        ms2 = median_ms(lambda: sa_weight_grad_bf16_cuda(scratch, vec, chans,
                                                         True, rows), 5)
        del scratch, vec
        ref_pooled, _ = fused_sa_forward_plain(sa.radius, K, "layer",
                                               *leaves, params, "bf16")
        plain_ms = median_ms(lambda: fused_sa_backward_plain(
            K, "layer", *leaves, params, idx, ref_pooled, ct, needs=needs,
            precision="bf16"), 3, 1)
        log(f"[bf16-train-kernels] fused_sa_bwd_bf16 {name}: K1 {ms1:.3f} ms "
            f"+ K2 {ms2:.3f} ms = {ms1 + ms2:.3f} ms, plain {plain_ms:.3f} "
            f"ms")
        k1["ms"] += ms1
        k2["ms"] += ms2
        k1.setdefault("level_ms", {})[name] = ms1
        k2.setdefault("level_ms", {})[name] = ms2
        # the plain version computes both kernels' function at once
        k1["plain_ms"] += plain_ms
        k2["plain_ms"] += plain_ms
        # the scratch rows are bf16 here, two to a 32-bit word
        sa_backward_work(work["fused_sa_bwd_bf16"],
                         work["sa_weight_grad_bf16"], "bf16", sa, pts,
                         new_xyz, feats, idx, pooled,
                         2.0 * scratch_floats(chans, rows + rows % 2))
        pts, feats = new_xyz, pooled
    for kname, wk in work.items():
        res[kname].update(bound(wk["ops"], wk["bytes"], bf16_ops=wk["bf16"]))
        res[kname].update(bound(wk["ops"], wk["design_bytes"],
                                prefix="design_", bf16_ops=wk["bf16"]))
        res[kname]["library_ms"] = None
    log(f"[bf16-train-kernels] fused SA backward bf16: K1 {k1['ms']:.4f} ms "
        f"(bound {k1['bound_ms']:.4f}, {k1['bound_by']}; with its scratch "
        f"rows {k1['design_bound_ms']:.4f}, {k1['design_bound_by']}), K2 "
        f"{k2['ms']:.4f} ms (bound {k2['bound_ms']:.4f}, {k2['bound_by']}; "
        f"with its scratch rows {k2['design_bound_ms']:.4f}, "
        f"{k2['design_bound_by']})")


def group_of(param: str) -> str:
    """A parameter's group: its level (sa1..sa3) or head module."""
    return param.split(".")[0]


def group_rel_l2(got: dict, ref: dict) -> dict:
    """Relative L2 error of each parameter group's gradients."""
    num, den = {}, {}
    for n, r in ref.items():
        g = group_of(n)
        num[g] = num.get(g, 0.0) + float(((got[n] - r) ** 2).sum())
        den[g] = den.get(g, 0.0) + float((r ** 2).sum())
    return {g: (num[g] / max(den[g], 1e-300)) ** 0.5 for g in num}


def bf16_step_models(cfg, dev: str):
    """The seeded f32 model of ``cfg`` and its bf16 twin on ``dev``, head
    dropout 0."""
    from maskplanner_tpu_torch.models import get_model

    out = []
    for bf16 in (False, True):
        c = copy.deepcopy(cfg)
        c["model"]["bf16"] = bf16
        out.append(get_model(c, device=dev, dropout=0.0,
                             generator=torch.Generator().manual_seed(0)))
    return out


def encoder_grads(model, x: torch.Tensor) -> dict:
    """The train-mode encoder's (sa1..sa3) parameter gradients of
    ⟨global feature, ct⟩, ct fixed (numpy, seed 3): its backward alone
    (FPS from index 0, the bf16 products summed in f32 as in a step)."""
    from maskplanner_tpu_torch.models.maskplanner import f32_accumulation
    from maskplanner_tpu_torch.models.pointnet2 import PointNet2Encoder

    model.train()
    model.zero_grad(set_to_none=True)
    with f32_accumulation():
        feat = PointNet2Encoder.forward(model, x)
        ct = np.random.default_rng(3).standard_normal(feat.shape)
        (feat * torch.from_numpy(ct.astype(np.float32)).to(feat.device)) \
            .sum().backward()
    return {n: p.grad.detach().cpu().double()
            for n, p in model.named_parameters() if p.grad is not None}


def train_outputs(model, x: torch.Tensor) -> dict:
    """The train-mode forward's outputs (FPS from index 0, dropout 0)."""
    model.train()
    with torch.no_grad():
        out = model(x)
    return {f: getattr(out, f).detach().cpu().double()
            for f in ("traj", "stroke_masks", "mask_scores")}


def rel_l2(got: dict, ref: dict) -> dict:
    return {k: float((got[k] - r).norm() / r.norm()) for k, r in ref.items()}


def phase_bf16_card_vs_cpu(cfg, items, handler, label: str) -> None:
    """A bf16 step on the card against the CPU (plain versions with the
    same roundings), the same weights, FPS from index 0, head dropout 0,
    on 16 samples: the train-mode outputs and the encoder's gradients for
    a fixed cotangent on its global feature (``encoder_grads``, per level),
    each by relative L2 error within ``BF16_GAP_SHARE`` of the distance
    from the CPU's bf16 step to its f32 step (the gap bf16 itself makes:
    a port with another precision or other rounding places lands near
    it). A control holds the card's f32 model to the same rule against
    the CPU's bf16 step, and the phase fails unless the control fails.
    The step's loss is held within ``BF16_REL_TOL`` relative, which
    catches gross faults only: bf16 moves the loss far less than that.

    Not a fixed tolerance on those, and not the step's own gradients: at
    random init the clouds' global features nearly coincide, so a train-mode
    BatchNorm of the heads divides their differences by a small batch
    deviation, and a bf16 rounding that falls the other way upstream moves
    the normalised outputs by percents (bf16 against f32: 26-45% relative
    L2 on the card and on the CPU alike, where eval moves them by 4e-3;
    the JAX package's bf16 step does the same, tests/test_torch_port_bf16_
    train.py); the loss's matchings (the LAP, the nearest-neighbour
    argmins) then reassign segments, which moves the step's gradients by
    O(1) (so does a 1e-4 relative perturbation of the weights in float32).
    On 2 samples those BatchNorms normalise 2 rows, and the card's loss
    moved 1.2e-2 from the CPU's where bf16 moved it by 5e-4 (PERF.md §6)."""
    weights = active_weights(cfg, handler)
    res = {}
    for dev in ("cuda", "cpu"):
        f32, bf16 = bf16_step_models(cfg, dev)
        b = to_batch(items, dev)
        x = b["point_cloud"]
        res[dev] = (step_grads(bf16, handler, b, weights)[0],
                    train_outputs(bf16, x), encoder_grads(bf16, x))
        res[dev + " f32"] = (step_grads(f32, handler, b, weights)[0],
                             train_outputs(f32, x), encoder_grads(f32, x))
    (l_gpu, o_gpu, e_gpu), (l_cpu, o_cpu, e_cpu), (l_f32, o_f32, e_f32), \
        (l_ctl, o_ctl, e_ctl) = (res[k] for k in ("cuda", "cpu", "cpu f32",
                                                  "cuda f32"))
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    gaps = {**rel_l2(o_cpu, o_f32), **group_rel_l2(e_cpu, e_f32)}
    share = {k: e / gaps[k] for k, e in
             {**rel_l2(o_gpu, o_cpu), **group_rel_l2(e_gpu, e_cpu)}.items()}
    control = {k: e / gaps[k] for k, e in
               {**rel_l2(o_ctl, o_cpu), **group_rel_l2(e_ctl, e_cpu)}.items()}
    log(f"[{label}] card vs CPU on {len(items)} samples: step loss card "
        f"{l_gpu:.6f} cpu {l_cpu:.6f}: rel Δ {rel:.2e} (the CPU's bf16 − "
        f"f32 {abs(l_cpu - l_f32) / abs(l_f32):.2e}; the card's f32 model "
        f"{abs(l_ctl - l_cpu) / abs(l_cpu):.2e}); rel. L2 of the outputs and "
        f"the encoder levels' gradients as a share of the CPU's bf16 − f32 "
        f"gap (limit {BF16_GAP_SHARE}), card bf16 / card f32 (control): "
        + ", ".join(f"{k} {share[k]:.3f} / {control[k]:.3f} (gap "
                    f"{gaps[k]:.2e})" for k in gaps))
    if not rel <= BF16_REL_TOL:
        raise AssertionError(f"{label}: the card's bf16 loss differs from "
                             f"the CPU's by {rel} relative")
    bad = {k: v for k, v in share.items() if not v <= BF16_GAP_SHARE}
    if bad:
        raise AssertionError(f"{label}: card vs CPU (relative L2) beyond "
                             f"{BF16_GAP_SHARE} of the CPU's bf16 − f32 "
                             f"gap: {bad}")
    if all(v <= BF16_GAP_SHARE for v in control.values()):
        raise AssertionError(f"{label}: the card's f32 model passes the bf16 "
                             f"check too (shares {control}): it does not "
                             f"tell the precisions apart")


def phase_bf16_step_gap(cfg, items, label: str) -> None:
    """The bf16 step against the f32 step on the card, the same weights and
    the batch of 64: the loss, the train-mode outputs, and each parameter
    group's gradients (the step's and the encoder's for a fixed cotangent)
    by relative L2 error (what bf16 training costs; logged, not held)."""
    from maskplanner_tpu_torch.losses import LossHandler

    handler = LossHandler(cfg["loss"], cfg)
    weights = active_weights(cfg, handler)
    batch = to_batch(items, "cuda")
    x = batch["point_cloud"]
    (l32, g32, o32, e32), (l16, g16, o16, e16) = (
        (*step_grads(m, handler, batch, weights), train_outputs(m, x),
         encoder_grads(m, x)) for m in bf16_step_models(cfg, "cuda"))
    log(f"[{label}] bf16 − f32 at batch {BATCH}: step loss {l16:.6f} vs "
        f"{l32:.6f} (rel {abs(l16 - l32) / abs(l32):.2e}); outputs' rel. "
        f"L2 " + ", ".join(f"{k} {e:.2e}" for k, e in rel_l2(o16, o32).items())
        + "; encoder gradients' rel. L2 " + ", ".join(
            f"{g} {e:.2e}" for g, e in group_rel_l2(e16, e32).items())
        + "; the step's gradients' rel. L2 " + ", ".join(
            f"{g} {e:.2e}" for g, e in group_rel_l2(g16, g32).items()))


def phase_bf16_train(cfg, items, label: str, expect: dict,
                     compare: int) -> dict:
    """A recipe's bf16 training: the step's launches, the card against the
    CPU on ``compare`` samples, 30 Adam steps, the step time and device
    time by kernel (``phase_train_step``), then the bf16 − f32 step gap ->
    the step's launches."""
    from maskplanner_tpu_torch.losses import LossHandler

    bf16_cfg = copy.deepcopy(cfg)
    bf16_cfg["model"]["bf16"] = True
    launches, _ = phase_train_step(bf16_cfg, items, label, expect, 30,
                                   compare=0)
    phase_bf16_card_vs_cpu(cfg, items[:compare],
                           LossHandler(cfg["loss"], cfg), label)
    phase_bf16_step_gap(cfg, items, label)
    return launches


# ---------------------------------------------------------------------------
# the exported serving forward, warm starts, coverage
# ---------------------------------------------------------------------------

# the custom op of each kernel that the exported forward carries
CUSTOM_OPS = {"fps": "maskplanner::fps",
              "fused_sa_fwd": "maskplanner::fused_sa_fwd",
              "fused_sa_fwd_bf16": "maskplanner::fused_sa_fwd_bf16",
              "ball_group": "maskplanner::ball_group",
              "ball_group_single": "maskplanner::ball_group_single"}
# the exported forward against the live one, on the same kernels: bitwise
# expected, held within this share of max|ref|
EXPORT_REL_TOL = 1e-6
# serves exported programs with nothing but ``load_exported``: per job the
# launches of one call and its outputs
EXPORT_CHILD = """
import json, sys
import numpy as np
import torch
from maskplanner_tpu_torch.serve import load_exported
from maskplanner_tpu_torch.ops.cuda import launch_counters

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
report = {}
for job in json.loads(sys.argv[1]):
    fn = load_exported(job["path"])
    x = np.load(job["input"])
    for f in launch_counters().values():
        f.launches = 0
    out = fn(x)
    torch.cuda.synchronize()
    report[job["path"]] = {k: f.launches
                           for k, f in launch_counters().items()}
    np.savez(job["output"], *[t.cpu().numpy() for t in out[:3]])
print(json.dumps(report))
"""
# serves a (byte-flipped) artifact: it must exit non-zero
FLIPPED_CHILD = """
import sys
import numpy as np
from maskplanner_tpu_torch.serve import load_exported

load_exported(sys.argv[1])(np.load(sys.argv[2]))
"""
# the warm-started health run's first epoch: its train loss's distance from
# the source's last-10 mean over the source's own fall (first epoch − that
# mean). Over five readings warm-started runs read 0.018-0.097 and the
# control (no warm start) 1.0000 (PERF.md §6)
WARM_START_SHARE = 0.3
# the largest mesh edge (in the corpus's normalised units) of the copy of
# the fixture corpus that coverage scores on (0.1 scores the same within
# 0.01 and simulates 5x slower)
COVERAGE_MESH_EDGE = 0.2


def opcheck_ops(model, bn, xyz: torch.Tensor) -> None:
    """``torch.library.opcheck`` of every custom op on CUDA inputs at the
    flagship's sa1 and sa2 shapes (2 clouds): the fake kernels' shapes,
    dtypes and strides against the CUDA kernels', the schemas, the
    dispatch."""
    from maskplanner_tpu_torch.ops import library
    from maskplanner_tpu_torch.ops.sampling import index_points

    t = time.perf_counter()
    x = xyz[:2].contiguous()
    start = torch.zeros(2, dtype=torch.int32, device=x.device)
    with torch.no_grad():
        l1 = index_points(x, library.fps(x, 512, start))
        f1, _ = library.fused_sa_fwd(
            x, l1, None, [a.detach() for layer in model.sa1.layer_params()
                          for a in layer], 0.2, 32, True)
        l2 = index_points(l1, library.fps(l1, 128, start))
    checks = [(library.fps, (x, 512, start)), (library.fps, (l1, 128, start))]
    for level, pts, new, feats, radius, k in (
            ("sa1", x, l1, None, 0.2, 32), ("sa2", l1, l2, f1, 0.4, 64)):
        flat = [a.detach() for layer in getattr(model, level).layer_params()
                for a in layer]
        for op in (library.fused_sa_fwd, library.fused_sa_fwd_bf16):
            checks.append((op, (pts, new, feats, flat, radius, k, True)))
        for op in (library.ball_group, library.ball_group_single):
            checks.append((op, (pts, new, feats, radius, k)))
    for op, args in checks:
        torch.library.opcheck(op, args)
    log(f"[export] opcheck: {len(checks)} calls of "
        f"{sorted(CUSTOM_OPS.values())} on the card pass, "
        f"{time.perf_counter() - t:.1f} s")


def phase_export(cases, clouds: np.ndarray) -> dict:
    """The exported forward (``Predictor.export_compiled``, torch.export
    through the custom ops) of each case ``(label, cfg, model,
    compute_dtype, batches, expect)``: exported on the card, then served in
    a child process that imports only ``load_exported``, on the same clouds
    as the live ``Predictor.forward``: outputs within ``EXPORT_REL_TOL`` ·
    max|ref| (bitwise expected), launches exactly ``expect``; host ms,
    median of 10, exported against live in this process. Beside that child,
    ``predict --from_export`` in a child gives the live request's rows,
    ``predict --export`` in another writes a program bitwise the live
    forward, and a byte-flipped artifact makes its child exit non-zero ->
    the child's launches by case."""
    from maskplanner_tpu_torch.convert import save_checkpoint
    from maskplanner_tpu_torch.serve import Predictor, load_exported
    from maskplanner_tpu_torch.utils.config import save_config

    t0 = time.perf_counter()
    counted = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs, refs = [], {}
        for label, cfg, model, dtype, batches, expect in cases:
            run_dir = os.path.join(tmp, label)
            os.makedirs(run_dir)
            save_config(cfg, run_dir)
            save_checkpoint(run_dir, "last_checkpoint", model)
            pred = Predictor(run_dir, device="cuda", compute_dtype=dtype)
            for b in batches:
                path = os.path.join(tmp, f"{label}-b{b}.pt2")
                t = time.perf_counter()
                blob = pred.export_compiled(path, batch=b)
                t_export = time.perf_counter() - t
                x = clouds[:b]
                np.save(path + ".in.npy", x)
                refs[path] = (label, b, expect,
                              [o.cpu() for o in pred.forward(x)[:3]])
                fn = load_exported(path)
                t_live = median_host_s(lambda: pred.forward(x), 10)
                t_exp = median_host_s(lambda: fn(x), 10)
                t_live2 = median_host_s(lambda: pred.forward(x), 10)
                log(f"[export] {label} batch {b}: {len(blob)} bytes, "
                    f"exported in {t_export:.2f} s; host ms (median of 10) "
                    f"live {t_live * 1e3:.3f} / {t_live2 * 1e3:.3f}, "
                    f"exported {t_exp * 1e3:.3f}")
                jobs.append(dict(path=path, input=path + ".in.npy",
                                 output=path + ".out.npz"))
        log(f"[export] exported and timed in {time.perf_counter() - t0:.1f} "
            f"s")
        # the children, all at once: the served programs, a flipped one,
        # and the CLI's export and its serving from this process's bf16
        # batch-1 program (the CLI's default dtype)
        mesh = os.path.join(tmp, "window.obj")
        write_box_obj(mesh, dims=(900.0, 120.0, 1100.0),
                      center=(400.0, 1500.0, 900.0))
        run_dir = os.path.join(tmp, cases[0][0])
        cli = os.path.join(tmp, "cli.pt2")
        bf16_b1 = os.path.join(tmp, f"{cases[1][0]}-b1.pt2")
        predict = [sys.executable, "-m", "maskplanner_tpu_torch.predict",
                   "--run", run_dir]
        flipped_proc = spawn([sys.executable, "-c", FLIPPED_CHILD,
                              flipped_copy(jobs[0]["path"], tmp),
                              jobs[0]["input"]])
        children = {
            "the exported forward's child": spawn(
                [sys.executable, "-c", EXPORT_CHILD, json.dumps(jobs)]),
            "predict --export": spawn([*predict, "--export", cli]),
            "predict --from_export": spawn(
                [*predict, "--meshes", mesh, "--out", f"{tmp}/exported",
                 "--from_export", bf16_b1])}
        try:
            live = Predictor(run_dir, device="cuda", compute_dtype="bf16")
            live.save_program(mesh, f"{tmp}/live/window.txt")
            said = flipped_proc.communicate(timeout=600)[1]
            done = {what: finish(proc, what)
                    for what, proc in children.items()}
        finally:                 # a failure stops the children still running
            for proc in [flipped_proc, *children.values()]:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        said = (said.strip().splitlines() or ["(nothing)"])[-1]
        log(f"[export] a byte-flipped artifact: its child exits "
            f"{flipped_proc.returncode}: {said}")
        if flipped_proc.returncode == 0:
            raise AssertionError("a byte-flipped artifact served")

        rows = {how: np.genfromtxt(f"{tmp}/{how}/window.txt", delimiter=";",
                                   skip_header=1)
                for how in ("live", "exported")}
        if rows["live"].shape[0] == 0 or not np.array_equal(
                rows["live"], rows["exported"]):
            raise AssertionError(f"predict --from_export gave "
                                 f"{rows['exported'].shape} rows unlike the "
                                 f"live request's {rows['live'].shape}")
        x = clouds[:1]
        want = [o.cpu() for o in live.forward(x)[:3]]
        got = [o.cpu() for o in load_exported(cli)(x)[:3]]
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("predict --export wrote a program unlike "
                                 "the live bf16 forward")
        log(f"[export] predict --from_export (bf16, a child): "
            f"{rows['live'].shape[0]} rows, equal to the live request's; "
            f"predict --export's program (a child) bitwise the live forward")

        report = json.loads(done["the exported forward's child"]
                            .strip().splitlines()[-1])
        for job in jobs:
            label, b, expect, ref = refs[job["path"]]
            launches = {k: report[job["path"]][k] for k in KERNELS}
            if launches != expect:
                raise AssertionError(f"[export] {label} batch {b}: the "
                                     f"child launched {launches}, expected "
                                     f"{expect}")
            counted[f"{label}-b{b}"] = {k: n for k, n in launches.items()
                                        if n}
            with np.load(job["output"]) as out:
                got = [torch.from_numpy(out[f"arr_{i}"]) for i in range(3)]
            for field, a, r in zip(("traj", "stroke_masks", "mask_scores"),
                                   got, ref):
                err = float((a - r).abs().max())
                scale = float(r.abs().max())
                log(f"[export] {label} batch {b} {field}: exported (child) "
                    f"vs live max|Δ| {err:.3e} (max|ref| {scale:.3e}), "
                    f"bitwise {torch.equal(a, r)}")
                if a.shape != r.shape or not err <= EXPORT_REL_TOL * scale:
                    raise AssertionError(f"[export] {label} batch {b} "
                                         f"{field}: {err} > "
                                         f"{EXPORT_REL_TOL} x {scale}")
        log(f"[export] the child's launches: {counted}")
    log(f"[export] done in {time.perf_counter() - t0:.1f} s")
    return counted


def spawn(cmd: list) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, what: str) -> str:
    """Wait for a child that must succeed -> its standard output."""
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{err[-3000:]}")
    return out


def flipped_copy(path: str, tmp: str) -> str:
    """A copy of the artifact with one byte flipped in its middle."""
    with open(path, "rb") as fh:
        bad = bytearray(fh.read())
    bad[len(bad) // 2] ^= 0xFF
    flipped = os.path.join(tmp, "flipped.pt2")
    with open(flipped, "wb") as fh:
        fh.write(bytes(bad))
    return flipped


def check_flagship_warm_start(run_dir: str) -> None:
    """``model.pretrained_custom`` on phase 11's run at the flagship's
    width: the warm-started model is bitwise the run's checkpoint, the
    output layers at the fresh init's unless ``load_strict``."""
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train_maskplanner import warm_start_custom
    from maskplanner_tpu_torch.utils.args import load_args

    saved = torch.load(os.path.join(run_dir, "last_checkpoint.torch.pt"),
                       weights_only=True)["model"]
    for strict in (False, True):
        cfg = load_args(argv=[FLAGSHIP, f"model.pretrained_custom={run_dir}",
                              f"model.load_strict={str(strict).lower()}"])
        model = get_model(cfg, device="cuda",
                          generator=torch.Generator().manual_seed(11))
        fresh = {k: v.cpu().clone() for k, v in model.state_dict().items()}
        loaded = warm_start_custom(model, cfg)
        got = model.state_dict()
        heads = [k for k in got if k.startswith(("fc3.", "fc_normals."))]
        for k in got:
            want = fresh[k] if k in heads and not strict else saved[k]
            if not torch.equal(got[k].cpu(), want):
                raise AssertionError(f"warm start (load_strict={strict}): "
                                     f"{k} is not what it should be")
        log(f"[warm-start] flagship, load_strict={strict}: {len(loaded)} "
            f"tensors loaded, the model bitwise the checkpoint, "
            f"{len(heads)} head tensors at "
            + ("the checkpoint's" if strict else "the fresh init's"))


def phase_warm_start(run_dir: str, root: str, source: list) -> None:
    """Phase 19's health run as the source: 2 epochs of its recipe on the
    graphed default loop with ``model.pretrained_custom`` and
    ``model.load_strict=true``, and the control without: the warm-started
    first epoch's train loss must lie within ``WARM_START_SHARE`` of the
    source's fall from its last-10 mean, the control's outside."""
    from maskplanner_tpu_torch import train_maskplanner

    tail = float(np.mean(source[-10:]))
    fall = source[0] - tail
    keep = [a for a in HEALTH if not a.startswith(("epochs=", "eval_freq=",
                                                   "no_save="))]
    shares = {}
    for how, extra in (("warm start", [f"model.pretrained_custom={run_dir}",
                                       "model.load_strict=true"]),
                       ("control", [])):
        with tempfile.TemporaryDirectory() as out:
            t = time.perf_counter()
            run, _ = train_maskplanner.main(
                [*keep, "epochs=2", "eval_freq=2", "no_save=true",
                 "device=cuda", *extra, f"output_dir={out}"])
            with open(os.path.join(run, "logs.jsonl")) as fh:
                first = json.loads(fh.readline())["train_loss"]
        shares[how] = abs(first - tail) / fall
        log(f"[warm-start] {how}: first epoch's train loss {first:.4f} "
            f"(source: epoch 1 {source[0]:.4f}, last-10 mean {tail:.4f}), "
            f"share of the source's fall {shares[how]:.4f}, "
            f"{time.perf_counter() - t:.1f} s")
    if not shares["warm start"] <= WARM_START_SHARE:
        raise AssertionError(f"the warm-started run starts "
                             f"{shares['warm start']} of the fall away")
    if shares["control"] <= WARM_START_SHARE:
        raise AssertionError(f"the control passes the warm-start gate "
                             f"({shares['control']})")


def phase_coverage(run_dir: str, root: str) -> None:
    """Coverage on the fixture run's test items: the eval CLI's ``--save``
    dumps through the port's three tools (programs, thickness, coverage):
    the exported GT programs against the original ones (the round trip) at
    least 0.9 on average, the predicted coverage printed per item; then a
    ``Predictor`` on the card answers each test mesh, and its program is
    simulated and scored against the original's, with the request and
    scoring ms. The metric counts mesh faces, so it scores on a copy of the
    corpus whose box faces are subdivided to edges of at most
    ``COVERAGE_MESH_EDGE`` (the same boxes and programs): on the corpus's
    12-triangle boxes a face is 1/9 of the painted ones."""
    import shutil

    from maskplanner_tpu_torch.data.fixture_category import write_category
    from maskplanner_tpu_torch.data.io import save_traj_file
    from maskplanner_tpu_torch.serve import Predictor
    from maskplanner_tpu_torch.sim import (coverage_for_pair,
                                           get_thicknesses_values_per_face,
                                           simulate_program)
    from maskplanner_tpu_torch.standalone import (
        compute_paint_coverage_per_face, from_pred_to_offline_v2,
        simulate_spray_thickness)

    t0 = time.perf_counter()
    cat_dir = write_category(os.path.join(run_dir, "fine"), "cuboids-v2",
                             **HEALTH_CORPUS,
                             mesh_max_edge=COVERAGE_MESH_EDGE)
    proc = subprocess.run(
        [sys.executable, "-m", "maskplanner_tpu_torch.test_maskplanner",
         "--run", run_dir, "--model", "last", "--save"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the eval CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-2000:]}")
    progs = os.path.join(run_dir, "programs")
    gt_dir, pred_dir = from_pred_to_offline_v2.main(
        ["--run", run_dir, "--output_dir", progs, "--force_overwrite"])
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(gt_dir))
    truth = os.path.join(progs, "truth")
    os.makedirs(truth)
    for name in names:
        original = os.path.join(root, "cuboids-v2", name,
                                f"{name}_trajectory.txt")
        with open(original) as a, open(os.path.join(
                cat_dir, name, f"{name}_trajectory.txt")) as b:
            if a.read() != b.read():
                raise AssertionError(f"the fine copy's {name} program "
                                     f"differs from the corpus's")
        shutil.copy(original, os.path.join(truth, f"{name}.txt"))
    thick = os.path.join(run_dir, "thickness")
    simulate_spray_thickness.main(["--programs", truth, gt_dir, pred_dir,
                                   "--meshes", cat_dir, "--out", thick])
    cov = compute_paint_coverage_per_face.main(
        ["--gt-run", os.path.join(thick, "truth"), "--runs",
         os.path.join(thick, os.path.basename(gt_dir)),
         os.path.join(thick, os.path.basename(pred_dir)),
         "--percentile", "10"])
    log(f"[coverage] eval dumps -> programs -> thickness -> coverage on "
        f"{names}: GT round trip {cov[0].tolist()}, predicted "
        f"{cov[1].tolist()}, {time.perf_counter() - t0:.1f} s")
    if not cov[0].mean() >= 0.9 or not ((cov[1] >= 0) & (cov[1] <= 1)).all():
        raise AssertionError(f"coverage: GT round trip {cov[0]}, predicted "
                             f"{cov[1]}")

    pred = Predictor(run_dir, model="last", device="cuda")
    for name in names:
        mesh = os.path.join(cat_dir, name, f"{name}.obj")
        t = time.perf_counter()
        rows = pred.predict_program(os.path.join(root, "cuboids-v2", name,
                                                 f"{name}.obj"),
                                    keep_centroid=False)
        t_request = time.perf_counter() - t
        program = os.path.join(run_dir, f"served_{name}.txt")
        save_traj_file(rows, program, kind="euler")
        t = time.perf_counter()
        faces = simulate_program(mesh, program).reshape(-1, 3).mean(1)
        want = get_thicknesses_values_per_face(
            os.path.join(thick, "truth", f"{name}.txt"))
        c = coverage_for_pair(want, faces, percentile=10)
        t_score = time.perf_counter() - t
        log(f"[coverage] served {name}: {rows.shape[0]} poses, coverage "
            f"{c:.4f}; request {t_request * 1e3:.1f} ms, simulate and score "
            f"{t_score * 1e3:.1f} ms")
        if not 0.0 <= c <= 1.0:
            raise AssertionError(f"coverage of the served {name}: {c}")


# ---------------------------------------------------------------------------
# the paper's baselines, the other composites, the regressor, every term
# ---------------------------------------------------------------------------

def recipe_epoch(cfg, label: str, expect: dict, timed: bool = True) -> dict:
    """The driver's default loop for ``cfg`` at batch 64: its train split
    of ``EPOCH_ITEMS`` items staged on the card and the device-resident
    epoch as CUDA graph replays, from seeded weights. The first 2 epochs
    (the eager first step, the capture, 15 replays) must count ``expect``
    twice in the wrappers and give finite losses. With ``timed``: 4
    epochs' first 30 losses fall; then ms a step by the host clock (2
    epochs, each ending in a synchronize), device busy ms a step and the
    idle share from a ``torch.profiler`` trace of a third, whose replays
    must launch ``expect`` each (``trace_launches``, ``per_replay``), and
    the graph's private pool."""
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.data.device_dataset import (
        epoch_perm, stage_device_dataset)
    from maskplanner_tpu_torch.losses import DeviceWeights, LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import make_optimizer
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch

    data = stage_device_dataset(PaintDataset(cfg, split="train",
                                             size=EPOCH_ITEMS), device="cuda")
    steps = EPOCH_ITEMS // BATCH
    handler = LossHandler(cfg["loss"], cfg)
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    ep = DeviceEpoch(model, make_optimizer(model, cfg), handler, data,
                     DeviceWeights(active_weights(cfg, handler), "cuda"),
                     torch.Generator(device="cuda").manual_seed(0),
                     int(cfg["pc_points"]))

    def run(e):
        return ep.run(epoch_perm(EPOCH_ITEMS, BATCH, 0, e))[0]

    reset_counts()
    curve = [run(e) for e in range(2)]
    wrapped = read_counts()
    if wrapped != {k: 2 * v for k, v in expect.items()}:
        raise AssertionError(f"[{label}] the eager step and the capture "
                             f"counted {wrapped}, {expect} each expected")
    if not timed:
        losses = torch.cat(curve).tolist()
        log(f"[{label}] 2 graphed epochs (the step captured with every term, "
            f"pool {ep.pool_bytes} bytes): losses " + " ".join(
                f"{v:.1f}" for v in losses))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[{label}] a non-finite loss")
        return dict(pool_bytes=ep.pool_bytes)
    curve = torch.cat(curve + [run(e) for e in range(2, 4)]).tolist()[:30]
    log(f"[{label}] graphed 30-step loss curve: "
        + " ".join(f"{v:.1f}" for v in curve))
    first, last = np.mean(curve[:steps]), np.mean(curve[-steps:])
    if not all(np.isfinite(curve)) or not last < first:
        raise AssertionError(f"[{label}] the graphed epochs' loss did not "
                             f"fall over 30 steps ({first} -> {last})")
    walls = []
    for e in (4, 5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(e)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3 / steps)
    wall = statistics.mean(walls)
    reset_counts()
    kernels = traced_kernels(lambda: run(6))
    if any(read_counts().values()):
        raise AssertionError(f"[{label}] a replay counted in the wrappers")
    per_replay(trace_launches(kernels), steps, expect,
               f"[{label}] a graphed epoch")
    busy = busy_ms(kernels) / steps
    out = dict(ms=wall, busy_ms=busy, idle=1.0 - busy / wall,
               pool_bytes=ep.pool_bytes)
    log(f"[{label}] graphed: {wall:.3f} ms a step (host clock, epochs 5-6: "
        + ", ".join(f"{w:.3f}" for w in walls) + f"), device busy "
        f"{busy:.3f} ms a step, idle share {out['idle']:.3f}; CUDA graph "
        f"pool {ep.pool_bytes} bytes ({ep.pool_bytes / 2**20:.1f} MiB)")
    del ep, model, data
    torch.cuda.empty_cache()
    return out


def term_inputs(items: list[dict], n: int) -> dict:
    """``n`` samples of the flagship's train split as loss inputs on the
    CPU, with predictions near the GT segments (seeded noise; random rows
    where the GT is padding) and seeded mask logits of the flagship's 22
    masks."""
    batch = to_batch(items[:n], "cpu")
    gen = torch.Generator().manual_seed(5)
    y = batch["traj"]
    noise = torch.randn(y.shape, generator=gen)
    y_pred = torch.where(y == -100.0, noise, y + 0.05 * noise)
    S = y.shape[1]
    return dict(y_pred=y_pred, y=y, y_mask=batch["stroke_ids"] >= 0,
                traj_as_pc=batch["traj_as_pc"],
                pc_mask=batch["stroke_ids_as_pc"] >= 0,
                stroke_ids=batch["stroke_ids"],
                pred_stroke_masks=torch.randn((n, 22, S), generator=gen),
                mask_scores=torch.randn((n, 22), generator=gen),
                perm=torch.rand((n, S), generator=gen).argsort(-1))


def new_terms():
    """name -> (λ=1 rows?, the term on (modules C, M, R, S, y_pred,
    inputs)): every loss term this slice ported, at its registry's
    arguments (the stochastic term with its subset given)."""
    w = dict(weight_asymm_segment_chamfer=1.0,
             weight_reverse_asymm_point_chamfer=100.0,
             weight_symm_segment_chamfer=0.01, weight_symm_point_chamfer=100.0,
             explicit_weight_stroke_masks=1.0,
             explicit_weight_stroke_masks_confidence=100.0,
             explicit_no_stroke_weight=1.0)

    def std(d):
        return dict(y=d["y"], y_mask=d["y_mask"], traj_as_pc=d["traj_as_pc"],
                    pc_mask=d["pc_mask"], outdim=6)

    def masks(d):
        return dict(pred_stroke_masks=d["pred_stroke_masks"],
                    mask_scores=d["mask_scores"], stroke_ids=d["stroke_ids"],
                    weights=w)

    return {
        "chamfer": (False, lambda C, M, R, S, yp, d: C.chamfer(yp, **std(d))),
        "chamfer min_centroids": (False, lambda C, M, R, S, yp, d: C.chamfer(
            yp, min_centroids=True, **std(d))),
        "chamfer velocities": (True, lambda C, M, R, S, yp, d: C.chamfer(
            yp, velocities=True, **std(d))),
        "symm_segment_chamfer": (False, lambda C, M, R, S, yp, d:
                                 C.symm_segment_chamfer(yp, **std(d))),
        "symm_point_chamfer": (False, lambda C, M, R, S, yp, d:
                               C.symm_point_chamfer(yp, **std(d))),
        "asymm_segment_chamfer": (False, lambda C, M, R, S, yp, d:
                                  C.asymm_segment_chamfer(yp, **std(d))),
        "stoch_reverse_asymm_segment_chamfer": (
            False, lambda C, M, R, S, yp, d:
            C.stoch_reverse_asymm_segment_chamfer(
                yp, d["y"], y_mask=d["y_mask"], perm=d["perm"])),
        "attraction_chamfer": (False, lambda C, M, R, S, yp, d:
                               C.attraction_chamfer(yp)),
        "rich_attraction_chamfer": (False, lambda C, M, R, S, yp, d:
                                    C.rich_attraction_chamfer(yp, 6)),
        "rich_attraction_chamfer soft": (
            False, lambda C, M, R, S, yp, d: C.rich_attraction_chamfer(
                yp, 6, soft_attraction=True)),
        "chamfer_bbox": (False, lambda C, M, R, S, yp, d: C.chamfer_bbox(
            yp, d["y"], bbox_mask=d["y_mask"])),
        "repulsion": (False, lambda C, M, R, S, yp, d: R.repulsion(
            yp, lambda_points=4, **std(d))),
        "repulsion λ=1": (True, lambda C, M, R, S, yp, d: R.repulsion(
            yp, knn_repulsion=3, lambda_points=1, **std(d))),
        "align": (True, lambda C, M, R, S, yp, d: R.align(
            yp, knn_repulsion=3)),
        "intra_align": (False, lambda C, M, R, S, yp, d: R.intra_align(yp)),
        "velcosine": (True, lambda C, M, R, S, yp, d: R.velcosine(
            yp, knn_repulsion=3)),
        "mse": (False, lambda C, M, R, S, yp, d: R.mse(yp, d["y"])),
        "emd (Sinkhorn)": (False, lambda C, M, R, S, yp, d: S.emd(
            yp, d["y"], y_mask=d["y_mask"])),
        "chamfer_with_stroke_masks": (
            False, lambda C, M, R, S, yp, d: M.chamfer_with_stroke_masks(
                yp, d["y"], y_mask=d["y_mask"], **masks(d))),
        "chamfer_with_stroke_masks λ=1": (
            True, lambda C, M, R, S, yp, d: M.chamfer_with_stroke_masks(
                yp, d["y"], y_mask=d["y_mask"], **masks(d))),
        "asymm_v11_chamfer_with_stroke_masks": (
            False, lambda C, M, R, S, yp, d:
            M.asymm_v11_chamfer_with_stroke_masks(
                yp, seg_logits=None, **std(d), **masks(d))),
        "symm_v1_chamfer_with_stroke_masks": (
            False, lambda C, M, R, S, yp, d:
            M.symm_v1_chamfer_with_stroke_masks(yp, **std(d), **masks(d))),
    }


def phase_terms(items: list[dict], n: int = 8) -> None:
    """Every term this slice ported, at the flagship's shapes (449 segments
    of 4 poses of 6 values, or the same rows as 1796 segments of 1 pose
    for the terms the JAX handler allows at λ=1 only) on ``n`` samples:
    the value and its gradient with respect to ``y_pred`` on the card
    against the CPU, the value within 1e-4 relative and the gradient
    within 1e-4 · max|ref| (max), each plus 3 x the CPU's own float32
    error measured against the CPU in float64 (Sinkhorn's 60 iterations at
    eps 0.005 magnify rounding)."""
    from maskplanner_tpu_torch.losses import chamfer_losses as C
    from maskplanner_tpu_torch.losses import mask_losses as M
    from maskplanner_tpu_torch.losses import regularizers as R
    from maskplanner_tpu_torch.losses import stroke_losses as S

    base = term_inputs(items, n)
    for name, (lam1, fn) in new_terms().items():
        d = dict(base)
        if lam1:
            d.update(y_pred=d["y_pred"].reshape(n, -1, 6),
                     y=d["y"].reshape(n, -1, 6),
                     y_mask=d["y_mask"].repeat_interleave(4, dim=1),
                     stroke_ids=d["stroke_ids"].repeat_interleave(4, dim=1),
                     pred_stroke_masks=d["pred_stroke_masks"]
                     .repeat_interleave(4, dim=2))
        res = []
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                           ("cpu", torch.float64)):
            dd = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                  for k, v in d.items()}
            yp = dd["y_pred"].clone().requires_grad_(True)
            value = fn(C, M, R, S, yp, dd)
            value.backward()
            res.append((float(value.detach()), yp.grad.double().cpu()))
        (v, g), (ref, ref_g), (v64, g64) = res
        own, own_g = abs(ref - v64), float((ref_g - g64).abs().max())
        dg = float((g - ref_g).abs().max())
        tol_g = 1e-4 * float(ref_g.abs().max()) + 3.0 * own_g
        log(f"[terms] {name} {tuple(d['y_pred'].shape)}: card {v:.6g}, cpu "
            f"{ref:.6g} (float64 {v64:.6g}); gradient max|Δ| {dg:.2e}, "
            f"allowed {tol_g:.2e}")
        if not np.isfinite(v) or not abs(v - ref) <= 1e-4 * abs(ref) \
                + 3.0 * own or not dg <= tol_g:
            raise AssertionError(f"[terms] {name}: the card's value or "
                                 f"gradient differs from the CPU's")
    log("[terms] align, intra_align: no CUDA graph (torch.linalg.svdvals "
        "copies to the host during capture); the driver trains them on "
        "the host loader, eagerly")


def phase_argmin_d3(items: list[dict], res: dict, card: dict) -> None:
    """#4's instantiation for d <= 8 at its model shapes, d = 3: the
    attraction chamfer's search (segment starts against ends, 449 x 449),
    the velocity search (positions of 1796 λ=1 rows against the GT's,
    with its mask) and the centroid search (449 window centroids against
    the GT's), batch 64, with ``nn_argmin_edges`` at the attraction shape:
    indices identical to the plain version (``hold_argmin``). Their times,
    plain times, ``torch.cdist(x, y).argmin(-1)`` times and bound go into
    the argmin's row as ``d3``."""
    d = term_inputs(items, BATCH)
    yp, y = d["y_pred"].cuda(), d["y"].cuda()
    mask = d["y_mask"].cuda()
    starts = yp[:, :, :3].contiguous()
    ends = yp[:, :, -3:].contiguous()
    calls = [("attraction", starts, ends, None),
             ("velocities", yp.reshape(BATCH, -1, 6)[..., :3].contiguous(),
              y.reshape(BATCH, -1, 6)[..., :3].contiguous(),
              mask.repeat_interleave(4, dim=1)),
             ("centroids", yp.reshape(BATCH, -1, 8, 3).mean(-2),
              y.reshape(BATCH, -1, 8, 3).mean(-2), mask)]
    held = hold_argmin(calls, card, "argmin d=3")
    hold_argmin([(what, *xs) for what, xs in nn_argmin_edges(
        starts, ends, None).items()], card, "argmin d=3 edges")
    res["nn_argmin"]["d3"] = {k: held[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "instr_bound_ms", "call_ms")}


def phase_recipes(items: list[dict], res: dict, card: dict) -> dict:
    """The paper's baselines and the other composites at the flagship's
    width: each step's launches, the card against the CPU on 2 samples
    (``phase_train_step``); for the baselines also 30 steps, the step time
    and their graphed device-resident loop (``recipe_epoch``); every new
    term card against CPU (``phase_terms``), #4 at d = 3
    (``phase_argmin_d3``); the regressor through the driver for 2 epochs
    with its final eval (``phase_train_then_serve``, no request: a
    Predictor serves the mask models) -> {recipe: its epoch's numbers}."""
    from maskplanner_tpu_torch.utils.args import load_args

    epochs, launched, lap_n = {}, {}, {}
    for name, (config, expect) in RECIPES.items():
        cfg = load_args(argv=[config])
        baseline = name in ("segmentWise", "pointWise")
        launched[name], shapes = phase_train_step(
            cfg, load_items(cfg, "train"), name, expect,
            steps=30 if baseline else 0, **RECIPE_RULES.get(name, {}))
        lap_n[name] = sorted({shape[-1] for shape in shapes})
        if baseline:
            epochs[name] = recipe_epoch(cfg, f"{name}-epoch", expect)
    # every capturable new term in one captured step, at λ=4 and λ=1
    for label, config, extra, expect in ALL_TERMS:
        recipe_epoch(load_args(argv=[config, extra]), label, expect,
                     timed=False)
    phase_terms(items)
    phase_argmin_d3(items, res, card)
    launched["regressor"] = phase_train_then_serve(
        REGRESSOR, REGRESSOR_STEP_LAUNCHES, None, "regressor")
    # what each recipe's counted step launched (the regressor's: its traced
    # replays) and the n of the LAP's cost tensors in that step
    res["nn_argmin"]["recipe_launches"] = {
        name: n["nn_argmin"] for name, n in launched.items()}
    res["lap"]["recipe_launches"] = {
        name: n["lap"] for name, n in launched.items()}
    res["lap"]["recipe_n"] = lap_n
    return epochs

# phase 25: the shapes past the small paths of #1, #4 and #5
LIMITS_PC_POINTS = 16384
LIMITS_LAMBDA = 22          # the segment chamfer's d = 6 λ = 132
LIMITS_LAUNCHES = launches_of(fps=2, fps_large=1, fused_sa_fwd=2)
LIMITS_STEP_LAUNCHES = launches_of(fps=2, fused_sa_fwd=2, fused_sa_bwd=2,
                                   sa_weight_grad=2, nn_argmin=3,
                                   nn_argmin_chunked=2, lap=1)
# the LAP's large path against the plain version (on the CPU), forced at n
# 22 and 128 and past the small paths at 129, 200 and 256, batch 1 and 64;
# and against scipy at batch 1 at n 1024, 4096 and 9000, past the path's
# shared-memory cut (about 8900 columns)
LAP_PLAIN_N = (22, 128, 129, 200, 256)
LAP_SCIPY = ((1024, "random"), (1024, "integer"), (4096, "random"),
             (4096, "integer"), (9000, "random"))
# the references, each group in a child process of its own beside the
# phase's work on the card: argv root, "plain" or "scipy", the output
# file, then the cases n:batch:kind
LAP_REFERENCE_CHILD = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from chip_smoke import lap_cost
cases = [c.split(":") for c in sys.argv[4:]]
out = {}
if sys.argv[2] == "scipy":
    from scipy.optimize import linear_sum_assignment
    for n, batch, kind in cases:
        cost = lap_cost(int(n), int(batch), kind)
        out[f"{n}:{batch}:{kind}"] = np.stack(
            [linear_sum_assignment(c)[1] for c in cost]).astype(np.int32)
else:
    import torch
    from maskplanner_tpu_torch.ops.hungarian import lap_plain
    torch.set_num_threads(1)
    for n, batch, kind in cases:
        cost = torch.from_numpy(lap_cost(int(n), int(batch), kind))
        out[f"{n}:{batch}:{kind}"] = lap_plain(cost).numpy()
np.savez(sys.argv[3], **out)
"""


def lap_cost(n: int, batch: int, kind: str) -> np.ndarray:
    """Phase 25's (batch, n, n) float32 LAP costs, seeded by the case:
    standard normal, or small integers (exact ties): in [0, 4) up to 256
    rows, in [0, 16 n) above (where [0, 4) makes every augmentation walk
    about n steps)."""
    rng = np.random.default_rng([n, batch, kind == "integer"])
    if kind == "integer":
        top = 4 if n <= 256 else 16 * n
        return rng.integers(0, top, (batch, n, n)).astype(np.float32)
    return rng.standard_normal((batch, n, n), dtype=np.float32)


def start_lap_references(tmp: str) -> dict:
    """The children of ``LAP_REFERENCE_CHILD``: {output file: (its cases,
    the process)}, one a plain n, and one for each scipy case but n 1024's
    two."""
    groups = [("plain", [(n, b, kind) for b in (1, BATCH)
                         for kind in ("random", "integer")])
              for n in LAP_PLAIN_N]
    groups += [("scipy", [(n, 1, kind) for n, kind in LAP_SCIPY
                          if n == 1024])]
    groups += [("scipy", [(n, 1, kind)]) for n, kind in LAP_SCIPY if n > 1024]
    children = {}
    for i, (oracle, cases) in enumerate(groups):
        path = os.path.join(tmp, f"lap_{oracle}_{i}.npz")
        children[path] = (cases, spawn(
            [sys.executable, "-c", LAP_REFERENCE_CHILD, ROOT, oracle, path]
            + [f"{n}:{b}:{kind}" for n, b, kind in cases]))
    return children


def limits_fps(res: dict) -> None:
    """FPS above 8192 points on the large path: indices identical to the
    plain version (on the card) at N 8193 and 16384, batch 4 and 64, and
    60000 at batch 4, npoint 512; the large path forced at 5120 points;
    a start index out of range traps in a child; the time, plain time and
    bound at the forward's shape (64 x 16384 -> 512)."""
    from maskplanner_tpu_torch.ops.cuda.fps import fps_cuda
    from maskplanner_tpu_torch.ops.sampling import fps_plain

    gen = torch.Generator(device="cuda").manual_seed(25)
    S = 512
    cases = [(n, b) for n in (8193, LIMITS_PC_POINTS) for b in (4, BATCH)]
    cases += [(60000, 4), (5120, 8)]
    for n, b in cases:
        pts = torch.rand((b, n, 3), generator=gen, device="cuda")
        start = torch.randint(0, n, (b,), generator=gen, device="cuda",
                              dtype=torch.int32)
        got = fps_cuda(pts, S, start, large=True)
        ref = fps_plain(pts, S, start)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"FPS large path {b} x {n}: indices differ "
                                 f"at {int((got != ref).sum())} places")
    log(f"[limits] fps large path identical to the plain version at "
        f"{', '.join(f'{b} x {n}' for n, b in cases)} -> {S}")
    check_fps_trap(8193)
    pts = torch.rand((BATCH, LIMITS_PC_POINTS, 3), generator=gen,
                     device="cuda")
    start = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    ms = median_ms(lambda: fps_cuda(pts, S, start), 10)
    plain = median_ms(lambda: fps_plain(pts, S, start), 3, 1)
    B, N = BATCH, LIMITS_PC_POINTS
    res.update(ms=ms, plain_ms=plain, library_ms=None,
               us_per_step=1e3 * ms / S,
               **bound(10.0 * B * S * N, 4.0 * (B * N * 3 + B + B * S)))
    log(f"[limits] fps large {B} x {N} -> {S}: kernel {ms:.4f} ms "
        f"({res['us_per_step']:.3f} us a step), plain {plain:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")


def limits_argmin() -> None:
    """The argmin above 128 coordinates on the chunked path, and the
    chunked path forced at d 6 and 24: exact ties on a grid, a mask that
    is not a prefix, sizes off every tile; indices identical to the plain
    version."""
    from maskplanner_tpu_torch.ops.cuda.nn_argmin import nn_argmin_cuda
    from maskplanner_tpu_torch.ops.nn_argmin import nn_argmin_plain

    gen = torch.Generator(device="cuda").manual_seed(26)
    checked = []
    for d in (6, 24, 129, 132, 192, 384):
        x = torch.randn((BATCH, 449, d), generator=gen, device="cuda")
        y = torch.randn((BATCH, 449, d), generator=gen, device="cuda")
        mask = torch.rand((BATCH, 449), generator=gen, device="cuda") > 0.3
        for what, (ex, ey, em) in {"random": (x, y, mask),
                                   **nn_argmin_edges(x, y, mask)}.items():
            got = nn_argmin_cuda(ex, ey, em, chunked=True)
            ref = nn_argmin_plain(ex, ey, em)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"nn_argmin chunked {what}: indices "
                                     f"differ at {int((got != ref).sum())} "
                                     f"places")
            checked.append(what)
    log(f"[limits] nn_argmin chunked path identical to the plain version on "
        f"{len(checked)} inputs: {', '.join(checked)}")


def limits_lap(children: dict) -> None:
    """The LAP's large path on every case of ``start_lap_references``,
    random and integer costs: permutations whose totals lie within 1e-5
    relative of the reference's (the plain version, or scipy past 256
    rows), with the large path's Dijkstra steps and time at scipy's
    sizes."""
    from maskplanner_tpu_torch.ops.cuda.lap import lap_cuda

    for path, (cases, proc) in children.items():
        got = {}
        for n, b, kind in cases:
            cost = torch.from_numpy(lap_cost(n, b, kind))
            steps = torch.zeros(b, dtype=torch.int32, device="cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            got[n, b, kind] = lap_cuda(cost.cuda(), large=True, steps=steps)
            torch.cuda.synchronize()
            took = time.perf_counter() - t
            if n > 256:
                log(f"[limits] lap large n={n} {kind}: {int(steps.sum())} "
                    f"Dijkstra steps in {took:.3f} s "
                    f"({1e9 * took / int(steps.sum()):.1f} ns a step)")
        finish(proc, f"the LAP references of {cases}")
        refs = np.load(path)
        for (n, b, kind), col4row in got.items():
            cost = torch.from_numpy(lap_cost(n, b, kind))
            rel, _ = check_assignment(
                f"lap large n={n} b={b} {kind}", cost, col4row.cpu(),
                torch.from_numpy(refs[f"{n}:{b}:{kind}"]))
            log(f"[limits] lap large n={n} batch {b} {kind}: permutations "
                f"within {rel:.2e} relative of "
                f"{'scipy' if n > 256 else 'the plain version'}")


def limits_emd(res: dict) -> int:
    """``losses/stroke_losses.py::emd`` on 64 x 200 predictions against 50
    GT rows (the exact route: a 200 x 200 LAP a sample) on the card
    against the CPU within 1e-5 relative -> its LAP launches, held to
    exactly lap 1 (lap_large 1). The large path's time, plain time, bound
    and chain floor on that LAP's costs."""
    from maskplanner_tpu_torch.losses.stroke_losses import emd
    from maskplanner_tpu_torch.ops import hungarian as hung
    from maskplanner_tpu_torch.ops.cuda.lap import (lap_cuda,
                                                    lap_large_step_cycles)

    gen = torch.Generator().manual_seed(28)
    y_pred = torch.randn((BATCH, 200, 24), generator=gen)
    y = torch.randn((BATCH, 50, 24), generator=gen)
    y_mask = torch.rand((BATCH, 50), generator=gen) > 0.2
    y_mask[:, 0] = True
    # (costs, col4row) of each LAP, the card's then the CPU's
    with lap_costs() as seen:
        reset_counts()
        card = float(emd(y_pred.cuda(), y.cuda(), y_mask.cuda()))
        launches = read_counts()
        cpu = float(emd(y_pred, y, y_mask))
    rel = abs(card - cpu) / abs(cpu)
    log(f"[limits] emd 64 x 200 against 50: card {card:.7f}, cpu {cpu:.7f}, "
        f"rel Δ {rel:.2e}; launches {launches}")
    if not rel <= 1e-5:
        raise AssertionError(f"emd: card and CPU differ by {rel} relative")
    want = launches_of(lap=1, lap_large=1)
    if launches != want or len(seen) != 2:
        raise AssertionError(f"emd launched {launches}, expected {want}")
    (cost, got), (cost_cpu, ref) = seen
    _, gap = check_assignment("lap large (emd)", cost_cpu, got.cpu(), ref)
    B, n, _ = cost.shape
    steps = torch.zeros(B, dtype=torch.int32, device="cuda")
    lap_cuda(cost, steps=steps)
    ms = median_ms(lambda: lap_cuda(cost), 10)
    t = time.perf_counter()
    hung.lap_plain(cost)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t) * 1e3
    mhz = sm_clock_mhz()
    cycles = lap_large_step_cycles(n)
    longest = int(steps.max())
    res.update(ms=ms, plain_ms=plain, library_ms=None, max_abs_err=gap,
               **bound(6.0 * int(steps.sum()) * n,
                       4.0 * (cost.numel() + B * n)),
               chain_bound_ms=longest * cycles / (mhz * 1e6) * 1e3,
               chain_bound_by=f"{longest} dependent steps x {cycles} cycles "
                              f"at {mhz:.0f} MHz",
               ns_per_step=ms * 1e6 / longest)
    log(f"[limits] lap large {tuple(cost.shape)} (emd): kernel {ms:.4f} ms, "
        f"plain (one call, on the card) {plain:.1f} ms; {int(steps.sum())} "
        f"steps, the longest problem {longest}; bound {res['bound_ms']:.6f} "
        f"ms ({res['bound_by']}), chain floor {res['chain_bound_ms']:.4f} ms "
        f"({cycles} cycles a step at {mhz:.0f} MHz), "
        f"{res['ns_per_step']:.1f} ns a dependent step")
    return launches["lap_large"]


def limits_forward() -> tuple[int, np.ndarray]:
    """The flagship forward at ``pc_points=16384``, batch 64: exactly fps 2
    (fps_large 1) and fused_sa_fwd 2, finite outputs of the flagship's
    shapes, 2 samples on the CPU within 1e-4 · max|ref| -> (fps_large's
    launches, the clouds)."""
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=[FLAGSHIP, f"pc_points={LIMITS_PC_POINTS}"])
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    clouds = np.stack([it["point_cloud"] for it in load_items(cfg, "test")])
    x = torch.from_numpy(clouds).cuda()
    reset_counts()
    with torch.inference_mode():
        out = model(x)
    launches = read_counts()
    log(f"[limits] forward at pc_points={LIMITS_PC_POINTS}: launches "
        f"{launches}")
    if launches != LIMITS_LAUNCHES:
        raise AssertionError(f"the forward launched {launches}, expected "
                             f"{LIMITS_LAUNCHES}")
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        ref = cpu_model(torch.from_numpy(clouds[:2]))
    shapes = {"traj": (BATCH, 449, 24), "stroke_masks": (BATCH, 22, 449),
              "mask_scores": (BATCH, 22)}
    for field, shape in shapes.items():
        t = getattr(out, field)
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{field}: shape {tuple(t.shape)} "
                                 f"(expected {shape}) or non-finite values")
        a, b = t[:2].cpu(), getattr(ref, field)
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not err <= REL_TOL * scale:
            raise AssertionError(f"{field} at pc_points={LIMITS_PC_POINTS}: "
                                 f"card and CPU disagree, {err} > {REL_TOL} "
                                 f"x {scale}")
        log(f"[limits] {field}: card vs CPU max|Δ| {err:.3e} (max|ref| "
            f"{scale:.3e})")
    with torch.inference_mode():
        t64 = median_host_s(lambda: model(x), 5)
    log(f"[limits] forward at pc_points={LIMITS_PC_POINTS}, batch {BATCH}: "
        f"{t64 * 1e3:.3f} ms")
    return launches["fps_large"], clouds


def limits_other_kernels(clouds: np.ndarray) -> None:
    """The other kernels of the forwards and the steps at
    ``pc_points=16384`` (8 clouds): a train-mode forward and backward of
    each recipe in f32 and bf16 (#2/2b with K1/K2 and their bf16 modes;
    #6/6b), each with exactly its step's kernel launches (FPS on its large
    path once) and finite outputs and gradients; the ball query (#7) at
    sa1's shape, indices identical to its plain version."""
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.ops.sampling import (ball_query_plain,
                                                    farthest_point_sample,
                                                    index_points,
                                                    query_ball_point)
    from maskplanner_tpu_torch.utils.args import load_args

    x = torch.from_numpy(clouds[:8]).cuda()
    cases = (("f32", [], dict(fused_sa_fwd=2, fused_sa_bwd=2,
                              sa_weight_grad=2)),
             ("bf16", ["model.bf16=true"],
              dict(fused_sa_fwd_bf16=2, fused_sa_bwd_bf16=2,
                   sa_weight_grad_bf16=2)),
             ("model.norm=batch", [BATCH_NORM], dict(ball_group=2)),
             ("model.norm=batch bf16", [BATCH_NORM, "model.bf16=true"],
              dict(ball_group_single=2)))
    for label, extra, counts in cases:
        cfg = load_args(argv=[FLAGSHIP, f"pc_points={LIMITS_PC_POINTS}",
                              *extra])
        model = get_model(cfg, device="cuda", dropout=0.0,
                          generator=torch.Generator().manual_seed(0))
        model.train()
        reset_counts()
        out = model(x)
        sum(o.float().sum() for o in out if o is not None).backward()
        launches = read_counts()
        want = launches_of(fps=2, fps_large=1, **counts)
        if launches != want:
            raise AssertionError(f"{label} forward and backward at "
                                 f"pc_points={LIMITS_PC_POINTS} launched "
                                 f"{launches}, expected {want}")
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        if bad or not all(bool(torch.isfinite(o).all())
                          for o in out if o is not None):
            raise AssertionError(f"{label} at pc_points={LIMITS_PC_POINTS}: "
                                 f"non-finite outputs or gradients {bad}")
        log(f"[limits] {label} forward and backward at "
            f"pc_points={LIMITS_PC_POINTS}, batch 8: launches as expected, "
            f"finite")
    new_xyz = index_points(x, farthest_point_sample(x, 512))
    got = query_ball_point(0.2, 32, x, new_xyz)
    if not torch.equal(got, ball_query_plain(0.2, 32, x, new_xyz)):
        raise AssertionError(f"ball query at {LIMITS_PC_POINTS} points: "
                             f"indices differ from the plain version")
    log(f"[limits] ball query at {LIMITS_PC_POINTS} points, 512 x 32: "
        f"identical to the plain version")


def limits_step(res: dict, card: dict) -> int:
    """The training step at ``lambda_points=22`` (the segment chamfer at
    d 132), batch 64: exactly the step's launches with nn_argmin_chunked 2,
    the card against the CPU on 2 samples by phase 8's rule; the chunked
    path's time, plain time, ``torch.cdist(x, y).argmin(-1)``, bound and
    instruction floor at the step's two d = 132 searches -> its
    launches."""
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import build_loss_batch
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=[FLAGSHIP, f"lambda_points={LIMITS_LAMBDA}"])
    items = load_items(cfg, "train")
    launches, _ = phase_train_step(cfg, items, "limits-train",
                                   LIMITS_STEP_LAUNCHES, steps=0, compare=2)
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    batch = to_batch(items, "cuda")
    with torch.no_grad():
        lb = build_loss_batch(model(batch["point_cloud"]), batch)
    d = lb["y_pred"].shape[-1]
    if d != 6 * LIMITS_LAMBDA:
        raise AssertionError(f"the segment rows have {d} values, expected "
                             f"{6 * LIMITS_LAMBDA}")
    calls = [("forward segments", lb["y_pred"], lb["y"], lb["y_mask"]),
             ("reverse segments", lb["y"], lb["y_pred"], None)]
    res.update(hold_argmin(calls, card, "limits"))
    log(f"[limits] nn_argmin chunked at the step's d = {d} searches: "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"torch.cdist+argmin {res['library_ms']:.4f} ms; bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}), instruction floor "
        f"{res['instr_bound_ms']:.4f} ms")
    return launches["nn_argmin_chunked"]


def phase_limits(res: dict, card: dict) -> dict:
    """Phase 25 -> each large-shape path's launches on its main path (the
    forward at pc_points 16384, the step at λ=22, ``emd``)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        children = start_lap_references(tmp)
        limits_fps(res["fps_large"])
        limits_argmin()
        launched = {"lap_large": limits_emd(res["lap_large"])}
        launched["fps_large"], clouds = limits_forward()
        limits_other_kernels(clouds)
        launched["nn_argmin_chunked"] = limits_step(
            res["nn_argmin_chunked"], card)
        limits_lap(children)
    log(f"[limits] phase took {time.perf_counter() - t0:.1f} s")
    return launched


# phase 26: the stroke-wise and start-of-path families
ZOO_EXTRAS = ["load_extra_data=[stroke_prototypes,segments_per_stroke,"
              "history_of_segments_per_stroke_v2]",
              "start_of_path_token_length=4", "out_prototypes=44",
              "sop_confidence_scores=true", "substroke_points=4",
              "stroke_prototype_dim=24", "rollout_loss=[mse_nexttoken_v2]",
              "end_of_path_confidence=true",
              "explicit_weight_masked_mse_loss=1.0",
              "explicit_weight_point_confidence_loss=1.0",
              "explicit_weight_stroke_confidence_loss=1.0",
              "explicit_no_sop_weight=0.2",
              "explicit_weight_sop_confidence_loss=1.0",
              "explicit_weight_endofpath_confidence_loss=1.0"]
# the nine loss names of the slice, and those the JAX handler takes at
# λ = 4 (the others are held under a λ = 1 configuration: the handler's
# check only, the data stay the same)
ZOO_TERMS = ("mse_strokes", "chamfer_strokes", "asymm_v6_chamfer_strokes",
             "masked_mse_strokes", "masked_mse_strokes_v2",
             "masked_mse_strokes_from_segments", "mse_nexttoken",
             "mse_nexttoken_v2", "hungarian_SoPs")
ZOO_LAMBDA4 = ("chamfer_strokes", "masked_mse_strokes_from_segments",
               "mse_nexttoken", "mse_nexttoken_v2", "hungarian_SoPs")
ZOO_ROLLOUT_STEPS = 20
ZOO_FORWARD_LAUNCHES = {"pointnet2_strokewise": FORWARD_LAUNCHES,
                        "pointnet2_sops": FORWARD_LAUNCHES,
                        "pointnet2_3dbbox": BN_FORWARD_LAUNCHES}
# chamfer_strokes and asymm_v6_chamfer_strokes search both directions on
# the stroke stack; masked_mse_strokes_v2 and hungarian_SoPs solve a LAP
ZOO_TERM_LAUNCHES = launches_of(nn_argmin=4, lap=2)
ZOO_GRAD_LAUNCHES = launches_of(fps=2, fused_sa_fwd=2, fused_sa_bwd=2,
                                sa_weight_grad=2, lap=1)
ZOO_HISTORY_KEYS = ("strokewise_history_batch", "strokewise_target_batch",
                    "strokewise_stroke_ids_batch",
                    "strokewise_end_of_path_batch")


def zoo_config():
    """The zoo's configuration with every GT stroke's length: the longest
    stroke over the 64 train clouds of the flagship data, in poses and in
    λ-segments -> (config, train items)."""
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.utils.args import load_args

    probe = load_args(argv=[FLAGSHIP, "pc_points=64"])
    ds = PaintDataset(probe, split="train", size=BATCH)
    points = segments = 0
    for i in range(BATCH):
        it = ds[i]
        for ids, what in ((it["stroke_ids_as_pc"], "points"),
                          (it["stroke_ids"], "segments")):
            longest = int(np.bincount(ids[ids >= 0]).max())
            if what == "points":
                points = max(points, longest)
            else:
                segments = max(segments, longest)
    log(f"[zoo] the longest GT stroke over {BATCH} train clouds: {points} "
        f"poses, {segments} segments: max_n_stroke_points={points}, "
        f"out_points_per_stroke={points}, out_segments_per_stroke="
        f"{segments}; out_prototypes 44, start_of_path_token_length 4, "
        f"substroke_points 4, {ZOO_ROLLOUT_STEPS} rollout steps")
    cfg = load_args(argv=[FLAGSHIP, *ZOO_EXTRAS,
                          f"max_n_stroke_points={points}",
                          f"out_points_per_stroke={points}",
                          f"out_segments_per_stroke={segments}"])
    ds = PaintDataset(cfg, split="train", size=BATCH)
    return cfg, [ds[i] for i in range(BATCH)]


def zoo_batch(items: list[dict], device) -> tuple[dict, dict]:
    """The items' extras as a batch, the next-token histories (a row count
    of their own an item, which ``collate`` cannot stack) concatenated."""
    from maskplanner_tpu_torch.data import collate

    batch = collate([{k: v for k, v in it.items()
                      if k not in ZOO_HISTORY_KEYS} for it in items])
    hist = {k: np.concatenate([it[k] for it in items])
            for k in ZOO_HISTORY_KEYS}
    to = (lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in d.items()})
    return to(batch), to(hist)


def zoo_models(cfg) -> dict:
    from maskplanner_tpu_torch.models import get_model

    return {name: get_model(cfg, device="cuda", which=name,
                            generator=torch.Generator().manual_seed(3))
            for name in ("pointnet2_strokewise", "pointnet2_sops",
                         "pointnet2_3dbbox", "mlp_rollout",
                         "point_transformer")}


def zoo_forwards(models: dict, clouds: torch.Tensor) -> dict:
    """Each regressor's eval forward at batch 64: its launches (exactly
    the flagship forward's, or the BatchNorm recipe's), finite outputs, 2
    samples on the CPU within 1e-4 · max|ref|, ms at batch 64 (host
    clock, median of 10) -> {model: (outputs, launches)}."""
    out = {}
    for name, expect in ZOO_FORWARD_LAUNCHES.items():
        model = models[name]
        reset_counts()
        with torch.inference_mode():
            got = model(clouds)
        launches = read_counts()
        if launches != expect:
            raise AssertionError(f"[zoo] {name} forward launched "
                                 f"{launches}, expected {expect}")
        cpu = copy.deepcopy(model).cpu()
        with torch.inference_mode():
            ref = cpu(clouds[:2].cpu())
        for i, (a, b) in enumerate(zip(got, ref)):
            if a is None:
                continue
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"[zoo] {name} output {i}: not finite")
            err = float((a[:2].cpu() - b).abs().max())
            scale = float(b.abs().max())
            if not err <= REL_TOL * scale:
                raise AssertionError(f"[zoo] {name} output {i}: card vs CPU "
                                     f"{err} > {REL_TOL} x {scale}")
            log(f"[zoo] {name} output {i} {tuple(a.shape)}: card vs CPU "
                f"max|Δ| {err:.3e} (max|ref| {scale:.3e})")

        def fwd(m=model):
            with torch.inference_mode():
                return m(clouds)

        ms = median_host_s(fwd, 10) * 1e3
        log(f"[zoo] {name} forward at batch {BATCH}: {ms:.3f} ms; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        out[name] = (got, launches, ms)
    return out


def zoo_encoder_kernels(models: dict, clouds: torch.Tensor) -> None:
    """#1, #2 and #3 at the stroke-wise model's sa1 and sa2 and #6 at the
    3D-box model's, on the zoo's clouds, against their plain versions on
    the card: FPS indices identical, the fused level's neighbour indices
    identical and pooled within 1e-4 · max|ref|, its backward (K1 and K2)
    for a seeded cotangent within phase 6's rule (``check_against_exact``)
    with every max routed (``check_routing``), the ball-group gather's
    indices identical and values within 1e-6 · max|ref|."""
    from maskplanner_tpu_torch.ops.cuda.fps import fps_cuda
    from maskplanner_tpu_torch.ops.cuda.group_gather import ball_group_cuda
    from maskplanner_tpu_torch.ops.group_gather import ball_group_plain
    from maskplanner_tpu_torch.ops.sampling import fps_plain, index_points

    gen = torch.Generator(device="cuda").manual_seed(9)
    start = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    model = models["pointnet2_strokewise"]
    pts, feats = clouds, None
    for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
        S = sa.npoint
        idx = fps_cuda(pts, S, start)
        if not torch.equal(idx, fps_plain(pts, S, start)):
            raise AssertionError(f"[zoo] fps {name}: indices differ")
        new_xyz = index_points(pts, idx)
        log(f"[zoo] fps {name}: indices identical; fused_sa_fwd, "
            f"fused_sa_bwd and sa_weight_grad:")
        pooled = hold_sa_backward(name, sa, pts, new_xyz, feats,
                                  gen)["pooled"]
        pts, feats = new_xyz.detach(), pooled.detach()
    bbox = models["pointnet2_3dbbox"]
    with torch.no_grad():
        sa2_in = bbox.sa1(clouds, None)
        for name, sa, pts, feats in (("sa1", bbox.sa1, clouds, None),
                                     ("sa2", bbox.sa2, *sa2_in)):
            r, K = sa.radius, sa.nsample
            new_xyz = index_points(pts, fps_cuda(pts, sa.npoint,
                                                 start[:pts.shape[0]]))
            got, idx = ball_group_cuda(r, K, pts, new_xyz, feats)
            ref, ridx = ball_group_plain(r, K, pts, new_xyz, feats)
            if not torch.equal(idx, ridx):
                raise AssertionError(f"[zoo] ball_group {name}: indices "
                                     f"differ")
            err = check_close(f"[zoo] ball_group {name}", got, ref, 1e-6)
            log(f"[zoo] ball_group {name} (pointnet2_3dbbox): indices "
                f"identical, max|Δ| {err:.3e}")


def zoo_term_inputs(cfg, batch: dict, hist: dict, fwd: dict) -> dict:
    """Each of the nine terms' inputs on the card: the stroke-wise model's
    strokes and the SoP model's tokens where a model gives them, else the
    GT near which seeded noise puts the predictions (random where the GT
    is padding) -> {name: (its inputs, the prediction keys)}."""
    gen = torch.Generator(device="cuda").manual_seed(8)

    def near(gt):
        noise = torch.randn(gt.shape, generator=gen, device=gt.device)
        return torch.where(gt == -100.0, noise, gt + 0.05 * noise)

    def logits(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    valid = batch["stroke_valid"]
    B, M = valid.shape
    segs = batch["segments_per_stroke"][valid]          # (K, S, 24)
    pts = batch["points_per_stroke"][valid]             # (K, N, 6)
    K, N = pts.shape[:2]
    zeroed = torch.where(pts == -100.0, 0.0, pts)
    tgt, eop = hist["strokewise_target_batch"], hist[
        "strokewise_end_of_path_batch"]
    strokes, point_conf, stroke_conf = fwd["pointnet2_strokewise"][0]
    tokens, sop_conf = fwd["pointnet2_sops"][0]
    return {
        "mse_strokes": (dict(stacked_strokes_pred=near(zeroed.reshape(K, -1)),
                             stacked_strokes_gt=zeroed.reshape(K, -1)),
                        ("stacked_strokes_pred",)),
        "chamfer_strokes": (dict(stacked_segments_per_stroke_pred=near(segs),
                                 stacked_segments_per_stroke_gt=segs),
                            ("stacked_segments_per_stroke_pred",)),
        "asymm_v6_chamfer_strokes": (
            dict(stacked_segments_per_stroke_pred=near(segs),
                 stacked_segments_per_stroke_gt=segs),
            ("stacked_segments_per_stroke_pred",)),
        "masked_mse_strokes": (
            dict(stacked_points_per_stroke_pred=near(pts),
                 stacked_points_per_stroke_gt=pts,
                 confidence_scores=logits((K, N, 1))),
            ("stacked_points_per_stroke_pred", "confidence_scores")),
        "masked_mse_strokes_v2": (
            dict(pred_points_per_stroke=strokes.clone(),
                 points_per_stroke=batch["points_per_stroke"].reshape(
                     B, M, -1),
                 pred_point_scores=point_conf.clone(),
                 pred_stroke_scores=stroke_conf.clone(),
                 gt_stroke_mask=valid),
            ("pred_points_per_stroke", "pred_point_scores",
             "pred_stroke_scores")),
        "masked_mse_strokes_from_segments": (
            dict(stacked_points_per_stroke_pred=near(zeroed),
                 stacked_points_per_stroke_gt=zeroed,
                 confidence_scores=torch.sigmoid(logits((K, N, 1))),
                 output_mask=~torch.all(pts == -100.0, dim=-1)),
            ("stacked_points_per_stroke_pred", "confidence_scores")),
        "mse_nexttoken": (dict(stacked_pred_nexttoken=near(tgt),
                               stacked_gt_nexttoken=tgt),
                          ("stacked_pred_nexttoken",)),
        "mse_nexttoken_v2": (
            dict(stacked_pred_nexttoken=near(tgt), stacked_gt_nexttoken=tgt,
                 end_of_path_scores=logits(eop.shape), end_of_path_gt=eop),
            ("stacked_pred_nexttoken", "end_of_path_scores")),
        "hungarian_SoPs": (
            dict(sop_pred=tokens.clone(), sop_gt=batch["stroke_prototypes"],
                 pred_sop_conf_scores=sop_conf.clone()),
            ("sop_pred", "pred_sop_conf_scores")),
    }


def zoo_handler(cfg, name: str):
    from maskplanner_tpu_torch.losses import LossHandler

    c = copy.deepcopy(cfg)
    c[f"weight_{name}"] = 1.0
    if name not in ZOO_LAMBDA4:
        c["lambda_points"], c["overlapping"] = 1, 0
    return LossHandler([name], c)


def zoo_term_value(handler, inputs: dict, preds, dev, dtype):
    """The term and its gradients with respect to ``preds`` on ``dev`` in
    ``dtype`` -> (value, {key: float64 gradient on the CPU})."""
    d = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
         for k, v in inputs.items()}
    for k in preds:
        d[k] = d[k].detach().clone().requires_grad_(True)
    total = handler.compute(handler.init_weights(), **d)[0]
    total.backward()
    return float(total.detach()), {k: d[k].grad.double().cpu()
                                   for k in preds}


def zoo_terms(cfg, terms: dict, card: dict, res: dict) -> dict:
    """The nine loss names through ``LossHandler`` at batch 64: their
    launches on the card (exactly nn_argmin 4 and lap 2), each value card
    against CPU within 1e-4 relative plus 3 x the CPU's own float32 error
    and each prediction gradient's rms within 1e-3 of its norm plus 3 x
    the CPU's own (phase 8's rules); #4 on the stroke stacks and #5 at
    64 x 22 x 22 and 64 x 44 x 44 against their plain versions on the
    card -> the launches."""
    handlers = {name: zoo_handler(cfg, name) for name in ZOO_TERMS}
    with lap_costs() as seen:
        reset_counts()
        card_runs = {name: zoo_term_value(handlers[name], *terms[name],
                                          "cuda", torch.float32)
                     for name in ZOO_TERMS}
        launches = read_counts()
    if launches != ZOO_TERM_LAUNCHES:
        raise AssertionError(f"[zoo] the nine terms launched {launches}, "
                             f"expected {ZOO_TERM_LAUNCHES}")
    for name in ZOO_TERMS:
        v, g = card_runs[name]
        ref, ref_g = zoo_term_value(handlers[name], *terms[name], "cpu",
                                    torch.float32)
        v64, g64 = zoo_term_value(handlers[name], *terms[name], "cpu",
                                  torch.float64)
        hold_rule(f"zoo {name}", (v, ref, v64), (g, ref_g, g64),
                  loss_own=True)
    # #4 on the stroke stacks: chamfer_strokes' two searches
    segs_pred, segs = (terms["chamfer_strokes"][0][k] for k in (
        "stacked_segments_per_stroke_pred", "stacked_segments_per_stroke_gt"))
    from maskplanner_tpu_torch.ops.chamfer import mask_from_padding
    res["nn_argmin"]["zoo"] = hold_argmin(
        [("stroke stack forward", segs_pred, segs, mask_from_padding(segs)),
         ("stroke stack reverse", segs, segs_pred, None)], card, "zoo")
    # #5 on the costs the two matching terms gave it
    shapes = sorted(tuple(c.shape) for c, _ in seen)
    if shapes != [(BATCH, 22, 22), (BATCH, 44, 44)]:
        raise AssertionError(f"[zoo] LAP costs {shapes}, expected 64 x 22 x "
                             f"22 and 64 x 44 x 44")
    res["lap"]["zoo"] = {f"n{cost.shape[1]}": hold_lap(cost, "zoo")
                         for cost, _ in seen}
    return launches


def zoo_gradient(cfg, batch: dict) -> dict:
    """The gradient of ``masked_mse_strokes_v2`` through the stroke-wise
    model in train mode (dropout 0, FPS from index 0): its launches at
    batch 64 (exactly ZOO_GRAD_LAUNCHES) and the ms of a forward, loss and
    backward (host clock, median of 5);
    on 2 samples the card against the CPU by phase 8's rule, the loss
    within 1e-4 relative and each parameter gradient's rms within 1e-3 of
    its norm plus 3 x the CPU's own float32 error -> the launches."""
    from maskplanner_tpu_torch.models import get_model

    handler = zoo_handler(cfg, "masked_mse_strokes_v2")
    B, M = batch["stroke_valid"].shape
    gt = dict(points_per_stroke=batch["points_per_stroke"].reshape(B, M, -1),
              gt_stroke_mask=batch["stroke_valid"])

    def backward(model, pc, g):
        model.zero_grad(set_to_none=True)
        strokes, point_conf, stroke_conf = model(pc)
        loss = handler.compute(
            handler.init_weights(), pred_points_per_stroke=strokes,
            pred_point_scores=point_conf, pred_stroke_scores=stroke_conf,
            **{k: v[:pc.shape[0]].to(pc.device) if k == "gt_stroke_mask"
               else v[:pc.shape[0]].to(pc.device, pc.dtype)
               for k, v in g.items()})[0]
        loss.backward()
        return loss

    def grads(model, pc, g):
        loss = backward(model, pc, g)
        return float(loss.detach()), {n: p.grad.detach().double().cpu()
                                      for n, p in model.named_parameters()}

    def fresh(dev, dtype):
        m = get_model(cfg, device="cpu", dropout=0.0,
                      which="pointnet2_strokewise",
                      generator=torch.Generator().manual_seed(3))
        return m.to(dev, dtype).train()

    card_model = fresh("cuda", torch.float32)
    pc = batch["point_cloud"]
    reset_counts()
    backward(card_model, pc, gt)
    launches = read_counts()
    if launches != ZOO_GRAD_LAUNCHES:
        raise AssertionError(f"[zoo] the stroke-wise gradient launched "
                             f"{launches}, expected {ZOO_GRAD_LAUNCHES}")
    ms = median_host_s(lambda: backward(card_model, pc, gt), 5) * 1e3
    two = pc[:2]
    l_gpu, g_gpu = grads(fresh("cuda", torch.float32), two, gt)
    l_cpu, g_cpu = grads(fresh("cpu", torch.float32), two.cpu(), gt)
    l_64, g_64 = grads(fresh("cpu", torch.float64), two.cpu().double(), gt)
    hold_rule("zoo masked_mse_strokes_v2 through pointnet2_strokewise",
              (l_gpu, l_cpu, l_64), (g_gpu, g_cpu, g_64))
    log(f"[zoo] masked_mse_strokes_v2 through pointnet2_strokewise: forward "
        f"and backward at batch {BATCH}: {ms:.3f} ms; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def zoo_rollout(cfg, models: dict, fwd: dict) -> None:
    """The rollout from the 44 SoP tokens of a cloud (``mlp_rollout``, 4
    history segments, ``ZOO_ROLLOUT_STEPS`` steps) on the card against the
    CPU within 1e-4 · max|ref|, the paths cut at their end-of-path
    logits, its time (host clock, median of 10 after a warm-up), and both
    SoP metric families on the batch's tokens."""
    from maskplanner_tpu_torch.metrics import MetricsHandler
    from maskplanner_tpu_torch.postprocess.sop import (
        postprocess_sop_predictions, truncate_autoregressive_eop)
    from maskplanner_tpu_torch.train.rollout import \
        sample_autoregressive_inference_sop

    tokens, conf = fwd["pointnet2_sops"][0]
    head = models["mlp_rollout"]
    args = (4, 24, ZOO_ROLLOUT_STEPS)
    paths, eops = sample_autoregressive_inference_sop(head, tokens[0], *args)
    ms = median_host_s(lambda: sample_autoregressive_inference_sop(
        head, tokens[0], *args), 10) * 1e3
    ref_paths, ref_eops = sample_autoregressive_inference_sop(
        copy.deepcopy(head).cpu(), tokens[0].cpu(), *args)
    for what, a, b in (("paths", paths, ref_paths), ("eops", eops, ref_eops)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"[zoo] rollout {what}: not finite")
        check_close(f"[zoo] rollout {what}", a.cpu(), b, REL_TOL)
    cut = truncate_autoregressive_eop(paths.cpu().numpy(),
                                      eops.cpu().numpy()[..., 0])
    log(f"[zoo] rollout of {tokens.shape[1]} tokens x "
        f"{ZOO_ROLLOUT_STEPS} steps: {tuple(paths.shape)}, card vs CPU "
        f"within {REL_TOL} of max|ref|, {ms:.3f} ms; lengths at the "
        f"end-of-path logits {[len(c) for c in cut][:8]}...")
    processed = postprocess_sop_predictions(tokens.cpu().numpy(),
                                            conf.cpu().numpy(), 0.5)
    metrics = MetricsHandler(cfg, ["sop_metrics", "sop_metrics_v2"]).compute(
        sop_pred=tokens, sop_gt=fwd["sop_gt"], pred_sop_conf_scores=conf,
        sop_conf_threshold=0.5, processed_sop_pred=processed)
    if not all(np.isfinite(v) for v in metrics.values()) or len(metrics) != 15:
        raise AssertionError(f"[zoo] SoP metrics {metrics}")
    log(f"[zoo] SoP metrics: {metrics}")


def zoo_transformer(models: dict, batch: dict) -> None:
    """``point_transformer`` at its defaults on the GT segments (449 of
    24 values): teacher forcing on the first 100 segments and the
    autoregressive decoding over ``max_seq_len`` 100, batch 64, finite,
    2 samples on the CPU within 1e-4 · max|ref|, ms of each (host clock,
    median of 5 after a warm-up)."""
    model = models["point_transformer"]
    src = torch.where(batch["traj"] == -100.0, 0.0, batch["traj"])
    tgt = src[:, :model.max_seq_len]
    for what, inputs in (("teacher forcing", (src, tgt)),
                         ("autoregressive", (src,))):
        with torch.no_grad():
            got = model(*inputs)
            ms = median_host_s(lambda: model(*inputs), 5) * 1e3
            ref = copy.deepcopy(model).cpu()(*(x[:2].cpu() for x in inputs))
        for a, b in zip(got, ref):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"[zoo] point_transformer {what}: not "
                                     f"finite")
            check_close(f"[zoo] point_transformer {what}", a[:2].cpu(), b,
                        REL_TOL)
        log(f"[zoo] point_transformer {what}: {tuple(got[0].shape)} at batch "
            f"{BATCH} in {ms:.3f} ms, 2 samples on the CPU within {REL_TOL} "
            f"of max|ref|")


def phase_zoo(res: dict, card: dict) -> dict:
    """Phase 26 -> {path: launches} of the zoo's main paths."""
    t0 = time.perf_counter()
    cfg, items = zoo_config()
    batch, hist = zoo_batch(items, "cuda")
    models = zoo_models(cfg)
    fwd = zoo_forwards(models, batch["point_cloud"])
    fwd["sop_gt"] = batch["stroke_prototypes"]
    paths = {f"{name} forward": fwd[name][1]
             for name in ZOO_FORWARD_LAUNCHES}
    zoo_encoder_kernels(models, batch["point_cloud"])
    paths["the nine terms"] = zoo_terms(
        cfg, zoo_term_inputs(cfg, batch, hist, fwd), card, res)
    paths["masked_mse_strokes_v2 gradient"] = zoo_gradient(cfg, batch)
    zoo_rollout(cfg, models, fwd)
    zoo_transformer(models, batch)
    for name in KERNELS:
        ran = {p: n[name] for p, n in paths.items() if n[name]}
        if ran:
            res[name]["zoo_launches"] = ran
    log(f"[zoo] phase took {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 27: the segmenters and the GAN recipe
# ---------------------------------------------------------------------------

# the contrastive segmenter on the flagship's GT segments (λ=4, 449 a cloud)
SEGMENTER = ["model.backbone=pointnet2_segmenter_v1", "ball_in_xyz_space=true",
             "latent_dim=64", "loss=[contrastive_v1]",
             "weight_contrastive_v1=1.0"]
# sa1: FPS and the ball query (#7) on the R³ centroids, the full segments
# grouped; sa2: FPS and the ball-group gather (#6); sa3: plain ops. The
# train forward's BallGroup launches #6 too (its backward is index_add_)
SEG_LAUNCHES = launches_of(fps=2, ball_query=1, ball_group=1)
# the GAN recipe: pointWise's generator (1350 one-pose segments) against a
# full-width DGCNN critic (k = knn_gcn = 20); the critic launches no kernel
GAN_RECIPE = ["config=[pointWise,windows_v2,longx_v2]",
              "loss=[chamfer,wdiscriminator]", "weight_wdiscriminator=0.01"]
GAN_STEP_LAUNCHES = launches_of(fps=2, fused_sa_fwd=2, fused_sa_bwd=2,
                                sa_weight_grad=2, nn_argmin=2)
# samples of the card-against-CPU checks: the generator's (as phase 8) and
# the critic's: its pooled BatchNorms normalise one row a cloud, and at 4
# clouds a channel's variance can be 2.6e-6 of its E[x²], where the
# one-pass variance (Flax's) loses six float32 digits: the update's loss
# lay 7.2e-4 from float64 on the CPU, and 4.2e-6 at 8 (H100; PERF.md §6)
GAN_COMPARE = 2
CRITIC_COMPARE = 8
# the critic's parameters whose update gradient is 0 in exact arithmetic:
# bn7 normalises linear2's output in train mode, and neither the WGAN loss
# (a difference of two logit means) nor the penalty (an input gradient)
# moves with the logit's bias
CRITIC_ZERO = frozenset({"linear2.bias", "linear3.bias"})


@contextlib.contextmanager
def shared_choices(record: list | None = None,
                   replay: list | None = None):
    """The (leaky) ReLUs' signs and the max-pools' winners inside the
    block: ``torch.relu``, ``functional.leaky_relu`` and ``Tensor.amax``
    run as they are and append their choices to ``record`` (the inputs
    above 0; the entries equal to the max), or, with ``replay``, make the
    recorded ones call by call (all of them): x · mask, x or x · slope by
    the mask, the mean of the recorded winners (one winner: its value;
    ties: the gradient split among them, as ``amax`` splits it). So two
    runs make the same choices where an input within rounding of 0, or
    two entries within rounding of each other, would fall either way with
    the summation order; with neither the block is left as it is."""
    if record is None and replay is None:
        yield
        return
    functional = torch.nn.functional
    relu, leaky, amax = torch.relu, functional.leaky_relu, torch.Tensor.amax
    calls, used = iter(replay or ()), []

    def recorded(x, mask):
        record.append(mask.cpu())

    def replayed(x):
        used.append(1)
        return next(calls).to(x.device)

    def shared_relu(x):
        if replay is None:
            recorded(x, x > 0)
            return relu(x)
        return x * replayed(x).to(x.dtype)

    def shared_leaky(x, negative_slope=0.01):
        if replay is None:
            recorded(x, x > 0)
            return leaky(x, negative_slope)
        return torch.where(replayed(x), x, x * negative_slope)

    def shared_amax(x, dim, keepdim=False):
        if replay is None:
            out = amax(x, dim, keepdim=True)
            recorded(x, x == out)
            return out if keepdim else out.squeeze(dim)
        won = replayed(x).to(x.dtype)
        out = (x * won).sum(dim, keepdim=True) / won.sum(dim, keepdim=True)
        return out if keepdim else out.squeeze(dim)

    torch.relu, functional.leaky_relu = shared_relu, shared_leaky
    torch.Tensor.amax = shared_amax
    try:
        yield
    finally:
        torch.relu, functional.leaky_relu = relu, leaky
        torch.Tensor.amax = amax
    if replay is not None and len(used) != len(replay):
        raise AssertionError(f"{len(used)} choices made, {len(replay)} "
                             f"recorded")


def segmenter_grads(model, segs, ids, uniform, n_strokes_max: int,
                    fps_seed: int | None = None, **choices):
    """The contrastive loss on the segmenter's latents (the uniform draw
    given) -> (loss, {"latents": the latents, parameter: its gradient}).
    Eval mode, or with ``fps_seed`` train mode, its FPS starts drawn from a
    CPU generator of that seed (the same starts on either device);
    ``choices``: ``shared_choices``'s."""
    from maskplanner_tpu_torch.losses import regularizers as R

    model.zero_grad(set_to_none=True)
    with shared_choices(**choices):
        if fps_seed is None:
            lat = model.eval()(segs)
        else:
            lat = model.train()(segs, generator=torch.Generator().manual_seed(
                fps_seed))
        loss = R.contrastive_v1(lat, ids, margin=0.3, balance_negatives=True,
                                n_strokes_max=n_strokes_max, uniform=uniform)
        loss.backward()
    return loss.item(), {"latents": lat.detach(), **{
        n: p.grad.detach() for n, p in model.named_parameters()}}


def phase_segmenter(items: list, res: dict) -> dict:
    """(i) of phase 27 -> {path: launches}."""
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.ops.sampling import (ball_query_plain,
                                                    farthest_point_sample,
                                                    fps_plain, index_points,
                                                    query_ball_point)
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=[FLAGSHIP, *SEGMENTER])
    batch = to_batch(items, "cuda")
    segs, ids = batch["traj"], batch["stroke_ids"]
    B, N, D = segs.shape
    model = get_model(cfg, device="cuda", io_type="ContrastiveClustering",
                      generator=torch.Generator().manual_seed(0))
    sa = model.sa1
    # sa1's FPS and ball on the centroids: 512 centres from N < 512 points
    xyz = segs.reshape(B, N, 4, D // 4)[..., :3].mean(-2)
    idx = farthest_point_sample(xyz, sa.npoint)
    ref = fps_plain(xyz, sa.npoint, torch.zeros(B, dtype=torch.int32,
                                                device="cuda"))
    if not torch.equal(idx, ref):
        raise AssertionError(f"FPS of {sa.npoint} centres from {N} "
                             f"centroids differs from its plain version")
    log(f"[segmenter] {B} clouds of {N} segments ({D} values): FPS of "
        f"{sa.npoint} > {N} centres identical to the plain version "
        f"(index 0 repeated {int((idx[:, N:] == 0).sum())} times)")
    new_xyz = index_points(xyz, idx)
    r, K = sa.radius, sa.nsample
    q = query_ball_point(r, K, xyz, new_xyz)
    q_ref = ball_query_plain(r, K, xyz, new_xyz)
    if not torch.equal(q, q_ref):
        raise AssertionError("ball_query on the segmenter's sa1: indices "
                             "differ from ball_query_plain")
    ms = median_ms(lambda: query_ball_point(r, K, xyz, new_xyz), 20)
    plain = median_ms(lambda: ball_query_plain(r, K, xyz, new_xyz), 5, 1)
    rq = res["ball_query"]
    rq["own_check"] = {k: rq.pop(k) for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "level_ms")}
    rq.update(ms=ms, plain_ms=plain, max_abs_err=0.0,
              shape=[B, N, sa.npoint, K])
    rq.update(bound(scan_ops(r, K, xyz, new_xyz),
                    4.0 * (xyz.numel() + new_xyz.numel() + q.numel())))
    log(f"[segmenter] ball_query at sa1 (B={B} N={N} S={sa.npoint} K={K}): "
        f"identical to ball_query_plain; kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {rq['bound_ms']:.4f} ms ({rq['bound_by']})")

    paths = {}
    with torch.no_grad():
        model(segs)                                   # warm up
        reset_counts()
        lat = model(segs)
        paths["segmenter eval forward"] = read_counts()
        fwd_ms = median_host_s(lambda: model(segs), 10) * 1e3
    if paths["segmenter eval forward"] != SEG_LAUNCHES:
        raise AssertionError(f"the segmenter's forward launched "
                             f"{paths['segmenter eval forward']}")
    if lat.shape != (B, N, 64) or not bool(torch.isfinite(lat).all()):
        raise AssertionError(f"segmenter latents {tuple(lat.shape)}, not "
                             f"finite or not (B, N, 64)")
    cpu = copy.deepcopy(model).cpu().eval()
    with torch.no_grad():
        err = check_close("[segmenter] forward, card vs CPU", lat[:2].cpu(),
                          cpu(segs[:2].cpu()), REL_TOL)
    log(f"[segmenter] eval forward at batch {B}: {fwd_ms:.3f} ms, launches "
        f"{paths['segmenter eval forward']}; 2 samples on the CPU within "
        f"max|Δ| {err:.3e}")

    # train mode: random FPS starts, batch statistics, the loss's backward
    handler = LossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    gen = torch.Generator(device="cuda").manual_seed(3)
    model.train()
    reset_counts()
    total, _ = handler.compute(weights, generator=gen,
                               latent_segments=model(segs, generator=gen),
                               stroke_ids=ids)
    total.backward()
    total = total.detach()
    paths["segmenter train forward and backward"] = read_counts()
    if paths["segmenter train forward and backward"] != SEG_LAUNCHES \
            or not bool(torch.isfinite(total)):
        raise AssertionError(
            f"the segmenter's train step launched "
            f"{paths['segmenter train forward and backward']}, loss "
            f"{float(total)}")
    log(f"[segmenter] train forward, contrastive_v1 {float(total):.6f} and "
        f"backward at batch {B}: launches "
        f"{paths['segmenter train forward and backward']}")

    # the latents, the loss and its gradient, card vs CPU on 8 clouds, in
    # eval and in train mode (the same FPS starts and uniform draw), the
    # card making the CPU float32 run's ReLU and max-pool choices: one ReLU
    # input within 1.2e-8 of 0 that falls the other way carries 8.7e-4 of
    # the eval gradients' norm, and in train mode reversing the batch on
    # the CPU alone moves the encoder's gradients by up to 7.9e-3 (H100;
    # PERF.md §6)
    n = min(8, B)
    uniform = torch.rand((n, N, N), generator=torch.Generator().manual_seed(4))
    for mode, fps_seed in (("eval", None), ("train", 5)):
        res_g, choices = {}, []
        for dev, dtype, kw in (("cpu", torch.float32, {"record": choices}),
                               ("cuda", torch.float32, {"replay": choices}),
                               ("cpu", torch.float64, {})):
            m = copy.deepcopy(model).to(device=dev, dtype=dtype)
            res_g[dev, dtype] = segmenter_grads(
                m, segs[:n].to(dev, dtype), ids[:n].to(dev),
                uniform.to(dev, dtype), int(cfg["max_n_strokes"]),
                fps_seed, **kw)
        # in train mode the BatchNorm-fed biases' gradients are 0 exactly
        zero = batchnorm_fed_biases(model) if fps_seed else frozenset()
        hold_rule(f"segmenter {mode} latents and contrastive_v1 on shared "
                  f"choices, card vs CPU", *zip(*(res_g[k] for k in (
                      ("cuda", torch.float32), ("cpu", torch.float32),
                      ("cpu", torch.float64)))), zero=zero)

    # the PaintNet segmenter and PointNet, eval at batch 64 on the clouds
    pc = batch["point_cloud"]
    for which, extra, expect in (
            ("pointnet2_segmenter_paintnet_v1", [], BN_FORWARD_LAUNCHES),
            ("pointnet", ["extra_data=[]"], launches_of())):
        c = load_args(argv=[FLAGSHIP, f"model.backbone={which}", *extra])
        m = get_model(c, device="cuda",
                      generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            m(pc)
            reset_counts()
            out = m(pc)
            paths[f"{which} eval forward"] = got = read_counts()
            t = median_host_s(lambda: m(pc), 5) * 1e3
            e = check_close(f"[segmenter] {which}, card vs CPU",
                            out[:2].cpu(), copy.deepcopy(m).cpu()(
                                pc[:2].cpu()), REL_TOL)
        if got != expect or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{which}'s forward launched {got}, or is "
                                 f"not finite")
        log(f"[segmenter] {which} eval forward {tuple(out.shape)} at batch "
            f"{B}: {t:.3f} ms, launches {got}; 2 samples on the CPU within "
            f"max|Δ| {e:.3e}")
    return paths


def phase_gan_driver() -> None:
    """The GAN recipe through ``train_maskplanner`` for 2 epochs of 2 steps
    (the host loader), then a resume that must restore the critic's state
    bitwise."""
    from maskplanner_tpu_torch import train_maskplanner

    with tempfile.TemporaryDirectory() as out:
        t = time.perf_counter()
        run_dir, _ = train_maskplanner.main([
            *GAN_RECIPE, "device=cuda", "epochs=2", "eval_freq=1",
            f"dataset_size={2 * BATCH}", "test_dataset_size=8", "seed=1",
            "skip_rendering=true", f"output_dir={out}"])
        took = time.perf_counter() - t
        with open(os.path.join(run_dir, "logs.jsonl")) as fh:
            logs = [json.loads(line) for line in fh]
        for entry in logs:
            for k, v in entry.items():
                if k.endswith("_loss") and not np.isfinite(v):
                    raise AssertionError(f"GAN driver: {k} = {v}")
        if not all("d_internal_train_loss" in e for e in logs):
            raise AssertionError("GAN driver: no d_internal_train_loss")
        aux = os.path.join(run_dir, "last_checkpoint_aux.torch.pt")
        saved = torch.load(aux, weights_only=True)
        seen = []
        load = train_maskplanner.load_aux_state

        def recorded(run, name, critic):
            found = load(run, name, critic)
            seen.append((found, critic.state_dict()))
            return found

        train_maskplanner.load_aux_state = recorded
        try:
            train_maskplanner.main([f"resume={run_dir}"])
        finally:
            train_maskplanner.load_aux_state = load
        (found, state), = seen
        same = found and all(torch.equal(state["module"][k], v)
                             for k, v in saved["module"].items()) and all(
            torch.equal(state["optimizer"]["state"][i][k], v)
            for i, s in saved["optimizer"]["state"].items()
            for k, v in s.items())
        if not same:
            raise AssertionError("the resumed GAN run's critic is not the "
                                 "saved one")
    log(f"[gan] train_maskplanner {' '.join(GAN_RECIPE)}: 2 epochs of 2 "
        f"steps at batch {BATCH} in {took:.1f} s; losses finite, "
        f"d_internal_train_loss " + ", ".join(
            f"{e['d_internal_train_loss']:.4g}" for e in logs)
        + "; resume restored the critic's state bitwise")


def gan_critic(cfg, kind: str = "wdiscriminator"):
    """The adversarial loss and its seeded full-width critic on the card."""
    from maskplanner_tpu_torch.losses.gan import AdversarialLoss

    adv = AdversarialLoss(cfg, kind)
    return adv, adv.init_state(torch.zeros(1, 1350, 6), "cuda",
                               torch.Generator().manual_seed(17))


def gan_parts(cfg, kind: str = "wdiscriminator"):
    """The seeded generator, its Adam, the loss handler and weights, the
    adversarial loss and its critic on the card."""
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import make_optimizer

    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    handler = LossHandler(cfg["loss"], cfg)
    return (model, make_optimizer(model, cfg), handler,
            active_weights(cfg, handler), *gan_critic(cfg, kind))


def phase_gan_step(items: list) -> dict:
    """The GAN step at batch 64: launches, ms a step, the critic's share,
    the peak memory; one minimax step -> its launches."""
    from maskplanner_tpu_torch.train import gan_train_step
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=GAN_RECIPE)
    batch = to_batch(items, "cuda")
    model, opt, handler, weights, adv, critic = gan_parts(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = itertools.count()

    def step():
        return gan_train_step(model, opt, handler, batch, weights, gen,
                              adv=adv, critic=critic, step=next(steps))

    step()                                              # warm up
    reset_counts()
    loss, terms = step()
    launches = read_counts()
    if launches != GAN_STEP_LAUNCHES:
        raise AssertionError(f"the GAN step launched {launches}")
    if not all(bool(torch.isfinite(v)) for v in (loss, *terms.values())):
        raise AssertionError(f"the GAN step: {float(loss)}, {terms}")
    torch.cuda.reset_peak_memory_stats()
    ms = median_host_s(step, 3) * 1e3
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        model.train()
        y_pred = model(batch["point_cloud"], generator=gen).traj.float()

    def critic_loss_fwd_bwd():
        yp = y_pred.detach().requires_grad_(True)
        adv.generator_loss(critic, yp).backward()

    update = median_host_s(lambda: adv.discriminator_update(
        critic, y_pred, batch["traj"], gen), 3) * 1e3
    g_loss = median_host_s(critic_loss_fwd_bwd, 3) * 1e3
    log(f"[gan] step at batch {BATCH} (1350 poses a cloud, critic k="
        f"{critic.module.k}): {ms:.3f} ms; launches {launches}; the critic "
        f"{update + g_loss:.3f} ms of it ({(update + g_loss) / ms:.3f}: its "
        f"update {update:.3f} ms, the generator's term forward and backward "
        f"{g_loss:.3f} ms); peak memory {peak / 2**30:.2f} GiB; terms "
        + ", ".join(f"{k} {float(v):.6g}" for k, v in terms.items()))

    mm = load_args(argv=[*GAN_RECIPE, "loss=[chamfer,discriminator]",
                         "weight_discriminator=0.01"])
    model, opt, handler, weights, adv, critic = gan_parts(mm,
                                                          "discriminator")
    reset_counts()
    loss, terms = gan_train_step(model, opt, handler, batch, weights, gen,
                                 adv=adv, critic=critic, step=0)
    minimax = read_counts()
    if minimax != GAN_STEP_LAUNCHES or not all(
            bool(torch.isfinite(v)) for v in (loss, *terms.values())):
        raise AssertionError(f"the minimax step launched {minimax}: "
                             f"{float(loss)}, {terms}")
    log(f"[gan] one minimax (discriminator) step: loss {float(loss):.6f}, "
        + ", ".join(f"{k} {float(v):.6g}" for k, v in terms.items()))
    return {"GAN step (wdiscriminator)": launches,
            "GAN step (discriminator)": minimax}


@contextlib.contextmanager
def critic_neighbours(record: list | None = None,
                      replay: list | None = None):
    """``models.dgcnn``'s kNN inside the block: it appends each call's
    neighbour indices to ``record``, or, with ``replay``, hands out the
    recorded ones call by call in place of its own (and must use them
    all), so that two runs share the critic's graphs; with neither it is
    left as it is."""
    from maskplanner_tpu_torch.models import dgcnn

    if record is None and replay is None:
        yield
        return
    knn, calls, used = dgcnn.knn, iter(replay or ()), []

    def recorded(k, query, points, *args, **kw):
        d, idx = knn(k, query, points, *args, **kw)
        record.append(idx.cpu())
        return d, idx

    def replayed(k, query, points, *args, **kw):
        used.append(1)
        return None, next(calls).to(query.device)

    dgcnn.knn = replayed if replay is not None else recorded
    try:
        yield
    finally:
        dgcnn.knn = knn
    if replay is not None and len(used) != len(replay):
        raise AssertionError(f"the critic built {len(used)} graphs, "
                             f"{len(replay)} recorded")


def phase_gan_card_vs_cpu(items: list) -> None:
    """One GAN step at fixed weights, card against CPU, on 8 clouds of the
    recipe's GT and of the CPU generator's prediction, with one set of
    mixing weights and dropout masks:

    - the critic's update (its loss; its gradient, from Adam's first
      moment; the statistics it moved) and the generator's term (its
      value; its gradient with respect to the prediction) in float64 on
      both sides, each within 1e-9 (``hold_float64``): the card's kNN in
      feature space picks the CPU's neighbours;
    - the same in float32 by phase 8's rule (``hold_rule``), each float32
      run on the critic graphs and the leaky ReLU and max-pool choices of
      the CPU's float64 run (``critic_neighbours``, ``shared_choices``):
      on the GT's −100 padding (most of the 1350 poses, printed) the
      float32 matmul-expansion distances over near-equal features decide
      near-ties by rounding, which moved the critic's loss 52% from
      float64 on the CPU (H100; PERF.md §6);
    - the generator's parameter gradients through the critic in float32
      by phase 8's rule (2 clouds: FPS from index 0, no dropout, the
      critic in eval) on the CPU float64 run's critic graphs.

    Every allowance is printed beside its distance."""
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=GAN_RECIPE)
    adv, critic = gan_critic(cfg)
    weight = float(cfg["weight_wdiscriminator"])
    b = to_batch(items[:CRITIC_COMPARE], "cpu")
    masks = critic.module.dropout_masks(CRITIC_COMPARE,
                                        torch.Generator().manual_seed(5),
                                        "cpu")
    eps = torch.rand(1, CRITIC_COMPARE, 1, 1,
                     generator=torch.Generator().manual_seed(6))

    def generator(dev, dtype):
        model = get_model(cfg, device="cpu", dropout=0.0,
                          generator=torch.Generator().manual_seed(0))
        return model.to(device=dev, dtype=dtype).train()

    def critic_on(dev, dtype):
        c = copy.deepcopy(critic)
        c.module.to(device=dev, dtype=dtype)
        c.module.dropout_masks = (
            lambda batch, gen, device, d=dev, t=dtype:
            tuple(m.to(d, t) for m in masks))
        return c

    def critic_step(key, mode=None):
        """The generator's term, then the critic's update, with ``mode``
        "record" or "replay" the critic's graphs (``critic_neighbours``)
        and choices (``shared_choices``) -> ((value, {"y_pred": gradient}),
        (loss, {name: gradient or statistic}))."""
        c = critic_on(*key)
        with critic_neighbours(**{mode: graphs} if mode else {}), \
                shared_choices(**{mode: choices} if mode else {}):
            yp = fake.to(*key).clone().requires_grad_(True)
            t = weight * adv.generator_loss(c, yp)
            t.backward()
            loss = adv.discriminator_update(c, fake.to(*key),
                                            b["traj"].to(*key),
                                            eps=eps.to(*key))
        named = c.module.named_parameters()
        return ((t.item(), {"y_pred": yp.grad}), (float(loss), {
            **{n: c.optimizer.state[p]["exp_avg"] / 0.1 for n, p in named},
            **{f"statistic {n}": v for n, v in c.module.named_buffers()}}))

    with torch.no_grad():
        fake = generator("cpu", torch.float32)(b["point_cloud"]).traj
    padded = (b["traj"] == -100.0).all(-1).sum(-1).tolist()
    log(f"[gan] GT poses that are −100 padding, of "
        f"{b['traj'].shape[1]} a cloud: {padded}")
    c64, f32, f64 = (("cuda", torch.float64), ("cpu", torch.float32),
                     ("cpu", torch.float64))
    graphs, choices = [], []
    runs = {f64: critic_step(f64, "record"), c64: critic_step(c64)}
    for key in (("cuda", torch.float32), f32):
        runs[key] = critic_step(key, "replay")
    for i, what in enumerate(("generator's term", "critic update")):
        zero = CRITIC_ZERO if i else frozenset()
        hold_float64(f"gan {what} in float64, card vs CPU",
                     *zip(runs[c64][i], runs[f64][i]), zero=zero)
        hold_rule(f"gan {what} in float32 on shared critic graphs and "
                  f"choices, card vs CPU", *zip(*(runs[k][i] for k in (
                      ("cuda", torch.float32), f32, f64))), zero=zero,
                  each=True)

    graphs, grads = [], {}
    for key, kw in ((f64, {"record": graphs}),
                    (("cuda", torch.float32), {"replay": graphs}),
                    (f32, {"replay": graphs})):
        model = generator(*key)
        c = critic_on(*key)
        pc = b["point_cloud"][:GAN_COMPARE].to(*key)
        with critic_neighbours(**kw):
            term = weight * adv.generator_loss(c, model(pc).traj)
            term.backward()
        grads[key] = {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None}
    # (the term's value moves with the generator's own float32 error, which
    # phase 24 allows pointWise's loss; on one prediction it is held above)
    hold_rule("gan generator gradients through the critic in float32 on "
              "shared critic graphs, card vs CPU", None,
              tuple(grads[k] for k in (("cuda", torch.float32), f32, f64)),
              each=True)


def phase_segmenters_gan(items: list, res: dict) -> dict:
    """Phase 27 -> {path: launches}."""
    from maskplanner_tpu_torch.utils.args import load_args

    t0 = time.perf_counter()
    paths = phase_segmenter(items, res)
    t1 = time.perf_counter()
    gan_items = load_items(load_args(argv=GAN_RECIPE), "train")
    phase_gan_driver()
    paths.update(phase_gan_step(gan_items))
    phase_gan_card_vs_cpu(gan_items)
    log(f"[segmenters-gan] phase took {time.perf_counter() - t0:.1f} s (the "
        f"segmenters {t1 - t0:.1f} s)")
    return paths


# ---------------------------------------------------------------------------
# data-parallel training (``maskplanner_tpu_torch/parallel``) and the
# multi-scale level
# ---------------------------------------------------------------------------

# steps of the data-parallel epochs: phase 28's (a) at batch 64
DP_STEPS = 4
# steps a rank of (b) or (c) times, after the 3 it holds
DP_TIMED_STEPS = 8
# the multi-scale level of (d): the original repository's
# ``pointnet2_cls_msg`` sa1 (512 centres, three balls), on the flagship's
# 5120-point clouds without normals
MSG_LEVEL = dict(npoint=512, radii=(0.1, 0.2, 0.4), nsamples=(16, 32, 128),
                 in_channel=0, mlps=((32, 32, 64), (64, 64, 128),
                                     (64, 96, 128)))
# the NCCL kernels in a trace: its ring and tree kernels, and the one a
# group of one runs for an averaging all-reduce (``onerank.cu``)
NCCL_KERNEL = re.compile(r"nccl|oneRankReduce", re.IGNORECASE)
# (a)'s rule for what K1's float atomics leave unreproducible: a grouped
# run's relative L2 distance from an ungrouped run at most this many times
# the largest distance between two of DP_NOISE_RUNS ungrouped runs, plus
# DP_NOISE_FLOOR
DP_NOISE_FACTOR = 2.0
DP_NOISE_FLOOR = 1e-6
DP_NOISE_RUNS = 3


def dp_perm(steps: int, seed: int) -> np.ndarray:
    """(steps, 64) rows, each a seeded permutation of the 64 staged
    items."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(BATCH) for _ in range(steps)]
                    ).astype(np.int32)


def dp_epoch(cfg, data: dict, graphed: bool, draws: bool = True):
    """A fresh run of the default recipe on ``data``, the seeded model (as
    every rank builds it) and generator -> its ``DeviceEpoch``. Without
    ``draws`` no generator and no dropout: FPS from index 0, and a step's
    result depends on its batch's order only through float32 rounding."""
    from maskplanner_tpu_torch.losses import DeviceWeights, LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import make_optimizer
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch

    device = data["point_cloud"].device
    model = get_model(cfg, device=device, dropout=0.3 if draws else 0.0,
                      generator=torch.Generator().manual_seed(0))
    handler = LossHandler(cfg["loss"], cfg)
    weights = DeviceWeights(active_weights(cfg, handler), device)
    gen = torch.Generator(device=device).manual_seed(0) if draws else None
    return DeviceEpoch(model, make_optimizer(model, cfg), handler, data,
                       weights, gen, int(cfg["pc_points"]), graphed=graphed)


def dp_state(ep) -> dict:
    """Every tensor a step reads and writes: the parameters, the BatchNorm
    statistics, Adam's moments and step counts, by name."""
    names = {p: n for n, p in ep.model.named_parameters()}
    out = {f"param {n}": p for n, p in ep.model.named_parameters()}
    out.update({f"buffer {n}": b for n, b in ep.model.named_buffers()})
    for p, st in ep.optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            out[f"{k} {names[p]}"] = st[k]
    return out


def dp_run(ep, perm, start: dict | None, gen_state, lr: float) -> dict:
    """An epoch of ``ep`` over ``perm`` from the state ``start``
    (``dp_state``'s names; none before the first run) and the generator
    state, at LR ``lr`` -> its losses and terms, the state after it and the
    generator's, on the host."""
    with torch.no_grad():
        if start is not None:
            # Adam's state starts at zero (moments and step counts)
            for k, t in dp_state(ep).items():
                t.copy_(start[k]) if k in start else t.zero_()
        ep.optimizer.param_groups[0]["lr"].fill_(lr)
    ep.generator.set_state(gen_state)
    losses, terms = ep.run(perm)
    torch.cuda.synchronize()
    return dict(losses=losses.cpu(), terms={k: v.cpu()
                                            for k, v in terms.items()},
                state={k: t.detach().cpu().clone()
                       for k, t in dp_state(ep).items()},
                gen=ep.generator.get_state())


def dp_rel_l2(a: dict, b: dict, keys) -> float:
    """The relative L2 distance of ``a``'s tensors from ``b``'s over
    ``keys`` (``dp_run``'s states)."""
    num = sum(float((a[k].double() - b[k].double()).norm() ** 2)
              for k in keys)
    den = sum(float(b[k].double().norm() ** 2) for k in keys)
    return (num / den) ** 0.5


def dp_within_noise(label: str, got: dict, runs: list, prefix: str
                    ) -> tuple[float, float]:
    """``got``'s state tensors named ``prefix``... within the noise of the
    ungrouped ``runs`` (``DP_NOISE_FACTOR``, ``DP_NOISE_FLOOR``) -> its
    distance from ``runs[0]`` and the largest between two runs."""
    keys = [k for k in runs[0]["state"] if k.startswith(prefix)]
    pairs = max(dp_rel_l2(a["state"], b["state"], keys)
                for a, b in itertools.combinations(runs, 2))
    d = dp_rel_l2(got["state"], runs[0]["state"], keys)
    if not d <= DP_NOISE_FACTOR * pairs + DP_NOISE_FLOOR:
        raise AssertionError(f"[{label}] {prefix}*: grouped-ungrouped "
                             f"{d:.3e} > {DP_NOISE_FACTOR:g} x {pairs:.3e} "
                             f"+ {DP_NOISE_FLOOR:g} (ungrouped pairs)")
    return d, pairs


def dp_bitwise(label: str, got: dict, want: dict) -> None:
    """``got`` and ``want`` (``dp_run``'s) bit for bit, but for Adam's
    moments (``phase_dp_world_one``)."""
    differ = [k for k in want["state"] if not k.startswith("exp_avg")
              and not torch.equal(got["state"][k], want["state"][k])]
    differ += [f"term {k}" for k in want["terms"]
               if not torch.equal(got["terms"][k], want["terms"][k])]
    if not torch.equal(got["losses"], want["losses"]):
        differ.append("losses")
    if not torch.equal(got["gen"], want["gen"]):
        differ.append("generator")
    if differ:
        raise AssertionError(f"[{label}] not bitwise equal: "
                             f"{differ[:8]} ({len(differ)} in all)")


def dp_first_step(ep) -> dict:
    """The parameter gradients of an eager ``ep``'s last step (after the
    step's all-reduce), on the host."""
    return {n: p.grad.detach().cpu().double()
            for n, p in ep.model.named_parameters()}


def dp_worker(rank: int, world: int, store: str, backend: str, graphed: bool,
              inputs: str, out: str) -> None:
    """One rank of phase 28's (b) or (c) on its rows of the 64 staged
    items: the default recipe's eager device-resident epoch of one step,
    then a fresh run (graphed with ``graphed``: an eager step, the capture,
    then replays) of 3 one-step epochs -> ``out``: the first step's global
    loss and all-reduced gradients, the 3 steps' losses and the parameters
    after them, the host ms of a step over ``DP_TIMED_STEPS`` more, the
    NCCL kernels of a traced replay (one more step) and their share of its
    busy device time."""
    from maskplanner_tpu_torch import parallel
    from maskplanner_tpu_torch.utils.args import load_args

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    parallel.distributed_init(f"file://{store}", rank, world, device=device,
                              backend=backend)
    ep = None
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = load_args(argv=[FLAGSHIP])
        data = {k: v.to(device)
                for k, v in torch.load(inputs, weights_only=True).items()}
        perm = dp_perm(3, 1)
        first = {}
        for draws in (False, True):
            ep = dp_epoch(cfg, data, graphed=False, draws=draws)
            first[draws] = (float(ep.run(perm[:1])[0][0]), dp_first_step(ep))
        ep = dp_epoch(cfg, data, graphed)
        losses = torch.cat([ep.run(perm[i:i + 1])[0] for i in range(3)])
        params = {n: p.detach().cpu().clone()
                  for n, p in ep.model.named_parameters()}
        # the ranks start the clock together, as they leave a collective
        parallel.agree(False)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(DP_TIMED_STEPS):
            ep.run(perm[i % 3:i % 3 + 1])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / DP_TIMED_STEPS
        nccl, share = [], None
        if graphed:
            kernels = traced_kernels(lambda: ep.run(perm[2:3]))
            nccl = [e for e in kernels
                    if NCCL_KERNEL.search(e.get("name", ""))]
            share = busy_ms(nccl) / busy_ms(kernels)
            nccl = [e["name"] for e in nccl]
        torch.save(dict(first=first, ms=ms, nccl=nccl, share=share,
                        losses=losses.cpu(), params=params), out)
    finally:
        if ep is not None:
            ep.close()
        parallel.destroy()
    log(f"[dp] {backend} rank {rank}: done, its group destroyed")


def dp_spawn(world: int, backend: str, graphed: bool, inputs: str,
             tmp: str, timeout: float = 120.0) -> list[dict]:
    """``world`` ``dp_worker`` ranks, started with the ``spawn`` method and
    joined; every rank must exit 0 within ``timeout`` s; none is left
    running -> each rank's result."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(tmp, f"store-{backend}-{world}")
    outs = [os.path.join(tmp, f"{backend}-rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=dp_worker, args=(
        r, world, store, backend, graphed, inputs, outs[r]))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{world} {backend} ranks exited {codes}")
    return [torch.load(o, weights_only=False) for o in outs]


def dp_ranks_agree(label: str, ranks: list[dict]) -> None:
    """Every rank's reported losses and its parameters bitwise rank 0's."""
    for r, got in enumerate(ranks[1:], 1):
        if got["first"][True][0] != ranks[0]["first"][True][0] or \
                not torch.equal(got["losses"], ranks[0]["losses"]):
            raise AssertionError(f"[{label}] rank {r} reports other losses")
        differ = [n for n, p in ranks[0]["params"].items()
                  if not torch.equal(p, got["params"][n])]
        if differ:
            raise AssertionError(f"[{label}] after 3 steps rank {r}'s "
                                 f"parameters differ from rank 0's: "
                                 f"{differ[:5]} ({len(differ)})")
    log(f"[{label}] after 3 steps the {len(ranks)} ranks' parameters are "
        f"bitwise equal ({len(ranks[0]['params'])} tensors), their "
        f"losses too")


def phase_dp_world_one(cfg, data: dict) -> dict:
    """(a): a group of one process over NCCL around the graphed
    device-resident epoch of the default recipe at batch 64 for
    ``DP_STEPS`` steps, against the ungrouped graphed epoch from the same
    seeded model and generator. K1's float atomics scatter the input
    gradient in no fixed order, so two runs of one graph differ in their
    last bits after a backward; what they leave unreproducible is held by
    ``dp_within_noise`` against ``DP_NOISE_RUNS`` ungrouped runs. At LR 0
    (the Adam update multiplies its move by the LR, so every step's
    forward runs on the same weights) the two epochs' losses, terms,
    parameters, BatchNorm statistics, Adam step counts and generator must
    be bitwise equal, and Adam's moments (every step's gradient, after the
    graph's collectives) within the noise. At the config's LR the first
    step's loss must be bitwise equal and the parameters after the epoch
    within the noise. On one rank NCCL's in-place SUM is a no-op, so the
    captured collectives launch nothing: a traced epoch of the grouped
    graph holds the port's kernels, those of a step a replay
    (``per_replay``), and counts NCCL's; the collectives' kernels are
    (c)'s, on two or more cards. Host ms a step of both graphs, in turns
    -> the numbers."""
    from maskplanner_tpu_torch import parallel

    perm = dp_perm(DP_STEPS, 0)
    lr = float(cfg["lr"])
    ungrouped = dp_epoch(cfg, data, graphed=True)
    gen0 = ungrouped.generator.get_state()
    want = dp_run(ungrouped, perm, None, gen0, 0.0)
    start = grouped = None
    with tempfile.TemporaryDirectory() as tmp:
        parallel.distributed_init(f"file://{tmp}/store", 0, 1,
                                  device=torch.device("cuda", 0))
        try:
            grouped = dp_epoch(cfg, data, graphed=True)
            start = {k: t.detach().clone()
                     for k, t in dp_state(grouped).items()}
            got = dp_run(grouped, perm, None, gen0, 0.0)
            dp_bitwise("dp world-1", got, want)
            # the driver's stop flag, reduced on the card over NCCL
            if not parallel.agree(True) or parallel.agree(False):
                raise AssertionError("agree over a group of one")
            log(f"[dp] (a) world-1 NCCL group, graphed epoch of {DP_STEPS} "
                f"steps at batch {BATCH}, LR 0: losses, terms, parameters, "
                f"BatchNorm statistics, step counts and generator bitwise "
                f"the ungrouped graph's; losses "
                + " ".join(f"{v:.6f}" for v in got["losses"].tolist()))
            reset_counts()
            epochs = TRACED_REPLAYS // DP_STEPS
            kernels = traced_kernels(
                lambda: [grouped.run(perm) for _ in range(epochs)])
            wrapped = read_counts()
            if any(wrapped.values()):
                raise AssertionError(f"a replay counted {wrapped}")
            per_replay(trace_launches(kernels), TRACED_REPLAYS,
                       STEP_LAUNCHES, "[dp] (a) grouped graph")
            nccl = [e for e in kernels if NCCL_KERNEL.search(e["name"])]
            busy = busy_ms(kernels)
            log(f"[dp] (a) {epochs} traced epochs of {DP_STEPS} grouped "
                f"replays: {len(nccl)} NCCL kernels, "
                f"{busy / TRACED_REPLAYS:.3f} busy ms a step")
            times = {"ungrouped": [], "grouped": []}
            for kind in ("ungrouped", "grouped", "grouped", "ungrouped"):
                ep = ungrouped if kind == "ungrouped" else grouped
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(2):
                    ep.run(perm)
                torch.cuda.synchronize()
                times[kind].append((time.perf_counter() - t) * 1e3
                                   / (2 * DP_STEPS))
            ms = {k: statistics.mean(v) for k, v in times.items()}
            log(f"[dp] (a) graphed step at batch {BATCH}, ms (host clock, "
                f"2 epochs of {DP_STEPS}, in turns): ungrouped "
                f"{ms['ungrouped']:.3f} ({times['ungrouped'][0]:.3f}, "
                f"{times['ungrouped'][1]:.3f}), world-1 NCCL group "
                f"{ms['grouped']:.3f} ({times['grouped'][0]:.3f}, "
                f"{times['grouped'][1]:.3f})")
            moved = dp_run(grouped, perm, start, gen0, lr)
        finally:
            if grouped is not None:
                grouped.close()
            parallel.destroy()
    still = [want] + [dp_run(ungrouped, perm, start, gen0, 0.0)
                      for _ in range(DP_NOISE_RUNS - 1)]
    noise = {f"LR 0 {prefix}": dp_within_noise("dp (a) LR 0", got, still,
                                               prefix)
             for prefix in ("exp_avg ", "exp_avg_sq ")}
    runs = [dp_run(ungrouped, perm, start, gen0, lr)
            for _ in range(DP_NOISE_RUNS)]
    if not all(torch.equal(r["losses"][0], moved["losses"][0])
               for r in runs):
        raise AssertionError("[dp] (a) at the LR the grouped graph's first "
                             "loss differs from the ungrouped one's")
    noise[f"LR {lr:g} param"] = dp_within_noise(f"dp (a) LR {lr:g}", moved,
                                                runs, "param ")
    log(f"[dp] (a) within the noise of {DP_NOISE_RUNS} ungrouped runs "
        f"(relative L2, grouped-ungrouped / the largest ungrouped pair): "
        + "; ".join(f"{k.strip()} {d:.3e} / {p:.3e}"
                    for k, (d, p) in noise.items())
        + f"; at LR {lr:g} the first loss bitwise, losses grouped "
        + " ".join(f"{v:.4f}" for v in moved["losses"].tolist())
        + ", ungrouped " + " ".join(f"{v:.4f}"
                                    for v in runs[0]["losses"].tolist()))
    # a replay's NCCL kernels (the profiler loses a record now and then)
    return dict(ungrouped_ms=ms["ungrouped"], grouped_ms=ms["grouped"],
                nccl_kernels=int(len(nccl) / TRACED_REPLAYS + 0.5))


def phase_dp_ranks(cfg, data_cpu: dict) -> dict:
    """(b) 2 ranks over gloo on the one card with CUDA tensors, and (c) 2
    over NCCL on two cards, graphed, where there are two (and 4 on four,
    where there are four). Each rank runs
    the device-resident epoch (eager in (b)) on its 32 rows of every
    global batch of 64. Their first step's global loss and all-reduced
    gradients against the single process's eager first step at batch 64
    by phase 8's rule (``hold_rule``), without draws (FPS from index 0,
    no dropout), where the single process's own float32 error is its
    distance from the same step on the batch in reverse order (the card
    has no float64 step); the same with the draws (the FPS starts and
    dropout masks over the global batch), each group's distance logged
    beside the other's; after 3 steps with the draws the ranks'
    parameters bitwise equal -> each case's ms a step and, graphed, the
    NCCL kernels' share of a traced replay's busy time, by case and world
    size."""
    data = {k: v.cuda() for k, v in data_cpu.items()}
    row = dp_perm(3, 1)[:1]
    single = {}
    for name, draws, perm in (("plain", False, row),
                              ("reversed", False, row[:, ::-1].copy()),
                              ("drawn", True, row)):
        ep = dp_epoch(cfg, data, graphed=False, draws=draws)
        losses, _ = ep.run(perm)
        single[name] = (float(losses[0]), dp_first_step(ep))
    # 0 in exact arithmetic: both sides' values are rounding noise
    zero = batchnorm_fed_biases(ep.model)
    del ep, data
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save(data_cpu, inputs)
        cases = [("b", 2, "gloo", False)]
        cards = torch.cuda.device_count()
        cases += [("c", w, "nccl", True) for w in (2, 4) if cards >= w]
        if cards < 2:
            log(f"[dp] (c) 2 NCCL ranks, graphed: not run: {cards} device")
        for case, world, backend, graphed in cases:
            t = time.perf_counter()
            ranks = dp_spawn(world, backend, graphed, inputs, tmp)
            label = f"dp ({case}) {world} {backend} ranks"
            plain, drawn = ranks[0]["first"][False], ranks[0]["first"][True]
            own = {n: g - single["reversed"][1][n]
                   for n, g in single["plain"][1].items()}
            dists = {"DP-single": group_rel_l2(plain[1], single["plain"][1]),
                     "single-reversed": group_rel_l2(
                         single["reversed"][1], single["plain"][1]),
                     "DP-single, drawn": group_rel_l2(drawn[1],
                                                      single["drawn"][1])}
            log(f"[{label}] first step, each group's relative L2 gradient "
                f"distance, " + "; ".join(
                    f"{k}: " + ", ".join(f"{g} {v:.2e}" for g, v in d.items())
                    for k, d in dists.items())
                + f"; losses DP {plain[0]:.9g} / single "
                f"{single['plain'][0]:.9g} / reversed "
                f"{single['reversed'][0]:.9g}, drawn DP "
                f"{drawn[0]:.9g} / single {single['drawn'][0]:.9g}")
            hold_rule(label, (plain[0], single["plain"][0],
                              single["reversed"][0]),
                      (plain[1], single["plain"][1], single["reversed"][1]),
                      zero=zero)
            # the draws move the step; the same allowance, the own error
            # that of the step without them
            hold_rule(f"{label}, drawn", (drawn[0], single["drawn"][0],
                                          single["drawn"][0]),
                      (drawn[1], single["drawn"][1],
                       {n: g - own[n] for n, g in single["drawn"][1].items()}),
                      zero=zero)
            dp_ranks_agree(label, ranks)
            if graphed and not all(r["nccl"] for r in ranks):
                raise AssertionError(f"[{label}] no NCCL kernel in a traced "
                                     f"replay")
            out[f"{case}{world}_ms"] = statistics.mean(r["ms"]
                                                       for r in ranks)
            if graphed:
                out[f"{case}{world}_all_reduce_share"] = statistics.mean(
                    r["share"] for r in ranks)
                log(f"[{label}] a traced replay: NCCL kernels "
                    + ", ".join(f"rank {i} {len(r['nccl'])}"
                                for i, r in enumerate(ranks))
                    + ", their share of the busy time " + ", ".join(
                        f"{r['share']:.5f}" for r in ranks))
            log(f"[{label}] ms a step (host clock, {DP_TIMED_STEPS} steps "
                f"after a collective, eager {not graphed}), each rank: "
                + ", ".join(f"{r['ms']:.3f}" for r in ranks)
                + f"; {time.perf_counter() - t:.1f} s")
    return out


def phase_msg(clouds: np.ndarray, res: dict) -> None:
    """(d): ``SetAbstractionMsg`` (``MSG_LEVEL``) on 64 clouds, eval: one
    FPS and a ball query a scale, exactly fps 1 and ball_query 3 launches
    (the counts set to 0 just before the forward and read just after),
    finite; each scale's ball indices (#7) identical to
    ``ball_query_plain``'s on the same centres; the forward's ms, #7's at
    the widest scale with its plain time and bound."""
    from maskplanner_tpu_torch.models import pointnet2
    from maskplanner_tpu_torch.ops.cuda.group_gather import ball_query_cuda
    from maskplanner_tpu_torch.ops.sampling import ball_query_plain

    torch.manual_seed(0)
    level = pointnet2.SetAbstractionMsg(**MSG_LEVEL).cuda().eval()
    xyz = torch.from_numpy(clouds).cuda()
    seen, query = [], pointnet2.query_ball_point

    def recorded(radius, nsample, x, q):
        seen.append((radius, nsample, q, query(radius, nsample, x, q)))
        return seen[-1][-1]

    pointnet2.query_ball_point = recorded
    try:
        with torch.no_grad():
            reset_counts()
            new_xyz, feats = level(xyz, None)
            launches = read_counts()
    finally:
        pointnet2.query_ball_point = query
    want = launches_of(fps=1, ball_query=len(MSG_LEVEL["radii"]))
    if launches != want:
        raise AssertionError(f"the MSG forward launched {launches}, "
                             f"expected {want}")
    width = sum(m[-1] for m in MSG_LEVEL["mlps"])
    if feats.shape != (BATCH, MSG_LEVEL["npoint"], width) or not bool(
            torch.isfinite(feats).all()):
        raise AssertionError(f"MSG output {tuple(feats.shape)}, finite "
                             f"{bool(torch.isfinite(feats).all())}")
    for radius, nsample, q, idx in seen:
        if q is not seen[0][2] or not torch.equal(
                idx.long(), ball_query_plain(radius, nsample, xyz, q).long()):
            raise AssertionError(f"MSG scale r={radius} K={nsample}: the "
                                 f"ball indices differ from the plain "
                                 f"version's")
    with torch.no_grad():
        ms = median_host_s(lambda: level(xyz, None), 5) * 1e3
    radius, nsample, q, _ = seen[-1]
    kernel = median_ms(lambda: ball_query_cuda(radius, nsample, xyz, q), 10)
    plain = median_ms(lambda: ball_query_plain(radius, nsample, xyz, q), 3)
    b = bound(scan_ops(radius, nsample, xyz, q),
              4.0 * (xyz.numel() + q.numel() + BATCH * q.shape[1] * nsample))
    res["ball_query"].update(msg_launches=launches["ball_query"],
                             msg_ms=kernel, msg_plain_ms=plain,
                             msg_bound_ms=b["bound_ms"],
                             msg_bound_by=b["bound_by"])
    log(f"[dp] (d) SetAbstractionMsg at batch {BATCH} (512 centres, K "
        f"{MSG_LEVEL['nsamples']}): {launches}, every scale's indices "
        f"identical to the plain version's; forward {ms:.3f} ms; #7 at "
        f"r={radius} K={nsample} {kernel:.4f} ms, plain {plain:.3f}, bound "
        f"{b['bound_ms']:.4f} ({b['bound_by']})")


def phase_data_parallel(cfg, items: list, clouds: np.ndarray,
                        res: dict) -> dict:
    """Phase 28 -> its numbers."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()     # the ranks of (b) share the card
    data_cpu = to_batch(items, "cpu")
    data = {k: v.cuda() for k, v in data_cpu.items()}
    out = phase_dp_world_one(cfg, data)
    del data
    torch.cuda.empty_cache()
    out.update(phase_dp_ranks(cfg, data_cpu))
    phase_msg(clouds, res)
    torch.cuda.empty_cache()
    log(f"[dp] phase took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.args import load_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    card = phase_identity()
    phase_build()
    cfg = load_args(argv=[FLAGSHIP])
    res = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
           for name in KERNELS}
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    clouds = np.stack([it["point_cloud"] for it in load_items(cfg, "test")])
    with torch.inference_mode():
        phase_kernels(model, torch.from_numpy(clouds).cuda(), res)
    phase_forward(model, clouds)
    phase_serve(cfg, model)
    with torch.inference_mode():
        phase_bf16_kernels(model, torch.from_numpy(clouds).cuda(), res)
    # the bf16 forward's path: counts set to 0 just before, read just after
    phase_bf16(cfg, model, clouds, "bf16-forward", BF16_FORWARD_LAUNCHES)
    log(f"[time] serving phases done at {time.perf_counter() - t0:.1f} s")

    train_items = load_items(cfg, "train")
    phase_train_kernels(cfg, model, to_batch(train_items, "cuda"), res, card)
    phase_train_step(cfg, train_items)
    # and the flagship warm start from its checkpoint
    phase_train_then_serve(then=check_flagship_warm_start)
    # the eval's path, f32 then bf16: counts set to 0 just before each and
    # read just after
    eval_launches = phase_eval(cfg, model, res, card, "eval",
                               EVAL_LAUNCHES)["launches"]
    phase_eval(cfg, bf16_twin(cfg, model), res, card, "bf16-eval",
               BF16_EVAL_LAUNCHES)
    phase_resume()
    log(f"[time] flagship phases done at {time.perf_counter() - t0:.1f} s")

    bn_cfg = load_args(argv=[FLAGSHIP, BATCH_NORM])
    bn = bn_model(bn_cfg)
    with torch.no_grad():   # the backward check turns autograd on itself
        own = phase_bn_kernels(bn, to_batch(train_items, "cuda"), res)
        check_ball_edges()
    phase_forward(bn, clouds, "bn-forward", BN_FORWARD_LAUNCHES)
    phase_serve(bn_cfg, bn, "bn-serve", 1, BN_FORWARD_LAUNCHES)
    _, bn16 = phase_bf16(bn_cfg, bn, clouds, "bn-bf16-forward",
                         BN_BF16_FORWARD_LAUNCHES)
    with torch.inference_mode():
        phase_bf16_group(bn16, clouds, res)
    # on 2 samples the heads' BatchNorms normalise 2 rows, which turns the
    # encoder's float32 rounding into an O(1) difference (PERF.md §6)
    phase_train_step(bn_cfg, train_items, "bn-train", BN_STEP_LAUNCHES, 12,
                     compare=16)
    log(f"[time] f32 and bf16-serving phases done at "
        f"{time.perf_counter() - t0:.1f} s")

    # bf16 training, both recipes; each step's counts set to 0 just before
    # it and read just after
    bf16_model = bf16_twin(cfg, model)
    with torch.no_grad():
        phase_bf16_train_kernels(bf16_model, to_batch(train_items, "cuda"),
                                 res)
    del bf16_model
    # 16 samples: on 2 the heads' BatchNorms normalise 2 rows (see
    # phase_bf16_card_vs_cpu)
    phase_bf16_train(cfg, train_items, "bf16-train", BF16_STEP_LAUNCHES,
                     compare=16)
    phase_train_then_serve(["model.bf16=true"], BF16_STEP_LAUNCHES,
                           BF16_FORWARD_LAUNCHES, "bf16-train-then-serve")
    phase_bf16_train(bn_cfg, train_items, "bn-bf16-train",
                     BN_BF16_STEP_LAUNCHES, compare=16)
    # and, on its run, the warm start of another run and the coverage
    phase_health(then=lambda run_dir, root, train: (
        phase_warm_start(run_dir, root, train),
        phase_coverage(run_dir, root)))
    log(f"[time] bf16 and health phases done at "
        f"{time.perf_counter() - t0:.1f} s")

    # the driver's default loop, both recipes in f32 and bf16; each graphed
    # run's counts set to 0 just before it and read just after
    dataset, data = epoch_split(cfg)
    bf16_cfg, bn_bf16_cfg = copy.deepcopy(cfg), copy.deepcopy(bn_cfg)
    bf16_cfg["model"]["bf16"] = bn_bf16_cfg["model"]["bf16"] = True
    epochs = {label: phase_device_epoch(c, dataset, data, label, expect)
              for label, c, expect in (
                  ("epoch", cfg, STEP_LAUNCHES),
                  ("bn-epoch", bn_cfg, BN_STEP_LAUNCHES),
                  ("bf16-epoch", bf16_cfg, BF16_STEP_LAUNCHES),
                  ("bn-bf16-epoch", bn_bf16_cfg, BN_BF16_STEP_LAUNCHES))}
    del data
    log("[epoch] ms a step / device busy ms a step / idle share: " + "; ".join(
        f"{label} " + ", ".join(
            f"{kind} {r[kind]['ms']:.3f} / {r[kind]['busy_ms']:.3f} / "
            f"{r[kind]['idle']:.3f}"
            for kind in ("host loader", "eager", "graphed"))
        + f", pool {r['pool_bytes']} bytes"
        for label, r in epochs.items()))

    # the exported forward: each program's counts set to 0 in its child just
    # before its call and read just after
    opcheck_ops(model, bn, torch.from_numpy(clouds).cuda())
    exported = phase_export(
        [("export", cfg, model, "f32", (1, BATCH), FORWARD_LAUNCHES),
         ("bf16-export", cfg, model, "bf16", (1, BATCH),
          BF16_FORWARD_LAUNCHES),
         ("bn-export", bn_cfg, bn, "f32", (BATCH,), BN_FORWARD_LAUNCHES),
         ("bn-bf16-export", bn_cfg, bn, "bf16", (BATCH,),
          BN_BF16_FORWARD_LAUNCHES)], clouds)
    log(f"[time] export phases done at {time.perf_counter() - t0:.1f} s")

    # the other recipes, each step's and each graphed run's counts set to 0
    # just before it and read just after
    recipe_epochs = phase_recipes(train_items, res, card)
    log("[recipes] ms a step / device busy ms a step / idle share / pool "
        "bytes of the graphed loop: " + "; ".join(
            f"{name} {r['ms']:.3f} / {r['busy_ms']:.3f} / {r['idle']:.3f} "
            f"/ {r['pool_bytes']}" for name, r in recipe_epochs.items()))
    # the shapes past the small paths: each main path's counts set to 0
    # just before it and read just after
    limits = phase_limits(res, card)
    # the stroke-wise and start-of-path families: each path's counts set to
    # 0 just before it and read just after
    phase_zoo(res, card)
    # the segmenters and the GAN recipe: likewise
    seg_gan = phase_segmenters_gan(train_items, res)
    # data-parallel training and the multi-scale level: likewise (the
    # graphed epoch's from its trace)
    dp = phase_data_parallel(cfg, train_items, clouds, res)
    log("[dp] " + json.dumps(dp))
    log(f"[time] all phases done at {time.perf_counter() - t0:.1f} s")

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "maskplanner_tpu", "jax", "flax"))
    if leaked:
        raise AssertionError(f"the JAX package or jax was imported: {leaked}")
    # each kernel's launches on its path: the kernels that ran in a graphed
    # epoch of 8 replays of the flagship (f32 or bf16, either recipe), from
    # its trace, or (no model path runs it) its own check
    paths = {"epoch": "flagship graphed epoch (trace)",
             "bn-epoch": "model.norm=batch graphed epoch (trace)",
             "bf16-epoch": "bf16 graphed epoch (trace)",
             "bn-bf16-epoch": "model.norm=batch bf16 graphed epoch (trace)"}
    counted = {}
    for label, path in paths.items():
        for name, n in epochs[label]["launches"].items():
            if n and name not in counted:
                counted[name] = (path, n)
    counted["fused_sa_folded"] = ("own check, through its entry point",
                                  own["fused_sa_folded"])
    counted["ball_query"] = (
        "pointnet2_segmenter_v1 (ball_in_xyz_space) eval forward, sa1",
        seg_gan["segmenter eval forward"]["ball_query"])
    for name, path in (("fps_large", "forward at pc_points=16384"),
                       ("nn_argmin_chunked", "training step at "
                                             "lambda_points=22"),
                       ("lap_large", "emd, 200 predictions x 50 GT rows")):
        counted[name] = (path, limits[name])
    if eval_launches["nn_argmin"] == 0:
        raise AssertionError("the eval launched no nn_argmin")
    for name in KERNELS:
        counted.setdefault(name, ("no path", 0))
        ran = {p: n[name] for p, n in seg_gan.items() if n[name]}
        if ran:
            res[name]["segmenters_gan_launches"] = ran
    for name, (path, n) in counted.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on {path}")
    for name in CUSTOM_OPS:
        if not any(name in c for c in exported.values()):
            raise AssertionError(f"no exported forward launched {name}")
    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=counted[name][1], launched_on=counted[name][0],
                    **res[name], custom_op=CUSTOM_OPS.get(name),
                    exported_launches={c: n[name] for c, n in exported.items()
                                       if name in n})
               for name in KERNELS]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
