#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases (each prints one line with what it measured and the seconds elapsed):

1. env      the card's name and power limit (nvidia-smi);
2. build    compile the port's CUDA kernels from `upliftingtabletennis_torch/ops/csrc`
            into `upliftingtabletennis_torch/_build/` (one nvcc per source, in parallel);
            meanwhile the host work of later phases that needs no kernel (item7's tree,
            `rally_inputs`, `hrnet_conv_shapes`); after the kernel phases, on a thread of
            its own, count the warpgroup products, TMA loads and stores and mma.sync
            products in K3's and K5's SASS (`cuobjdump`, where the toolkit has it; the line
            `[sass]`);
3. k1       K1 (fused attention half-block) against its plain PyTorch version, run in
            f32 on the same bf16 inputs, at the four SegFormer-b2 stage shapes of the
            1600x896 ball model, on two input sets (keys of std 1, and of std 3 where the
            softmax is sharp); two planted faults simulated with the plain version (a
            skipped key chunk, a dropped head) that the limit must reject; kernel, plain
            and stock-PyTorch times, per call and pipelined; the bound;
4. k2       the same for K2 (fused LN + MixFFN half-block) along its launch plan, plus
            one shape whose H and W are not multiples of the tile and b0's widths; the
            other route where a width has both (fused and split), timed beside the plan's;
            planted faults: the last hidden chunk skipped, the halo rows between tiles
            zeroed;
4b. probe   P1/P2, the phase probes of K2/K1 (`upliftingtabletennis_torch/tools/`): every
            mode at the four b2 stage shapes at batch 4, held against its plain version
            at the k1/k2 limits, timed interleaved; the implied phase shares; launches of
            the probe kernels counted over the phase;
5. slice    `ball_detection("segformerpp_b2", device="cuda", chunk=4).predict` on 8
            seeded synthetic 1920x1080 triplets (the main path, with launch counts
            reset just before it and read just after); heatmaps of the kernel path
            (bf16) against `SegFormerNet(kernels=False)` in f32; peaks finite and in
            the frame; warm frames/s;
6. k5       K5a/K5b (fused conv + bias + ReLU (+ residual), `ops/fused_conv.py`) against
            their plain versions (f32 on the same bf16 inputs) at every distinct
            (Ci, Co, H, W, residual) one HRNet forward launches at chunk 8 and 1280x704
            (recorded from one forward of each HRNet on the meta device), plus two
            ragged shapes, each along its launch plan (`conv_plan`: route, tile, channel
            group, ring depth); planted faults simulated with the plain version (the halo
            rows at the tile seams zeroed, one tap left out, one tile from a stale ring
            stage) that the limit must reject; kernel, plain and stock (channels_last
            cuDNN + eager epilogue) times, per call and pipelined, launches per forward,
            the bound;
7. hrnet    WASB and TableHRNet at 1280x704, chunk 8, seeded random weights with
            perturbed BatchNorm statistics: the K5 route of each conv shape, heatmaps of
            the kernel path (bf16) against the plain path (f32), and 40 K5a / 14 K5b
            launches per forward;
8. detectors the four detectors of the main path through `hub.ball_detection` and
            `hub.table_detection` at chunk 8 on the same synthetic 1920x1080 frames (b2
            ball and WASB on the triplets, b2 table and HRNet table on the centre
            frames), with all four kernels' launch counts reset just before and read
            just after, and the K5 routes; frames/s of each and of the four together;
            each detector's
            heatmaps on one chunk of 8 against a `kernels=False` copy in f32 with the
            same weights; then both `filter_trajectory` calls;
9. k3       K3 (flash cross-attention, `ops/flash_attention.py`) against its plain version
            (f32 on the same bf16 inputs) at the four b2 ToMe stage shapes at chunk 8 and
            1600x896, one b0 shape (hd 32, Nkv 2040) and one ragged shape, at K3's own
            limit, which must also reject three faults simulated with the plain version (a
            skipped key chunk; one chunk read from the stage a ring depth earlier; the
            ragged shape's tail unmasked); kernel, plain and
            `F.scaled_dot_product_attention` times, per call and pipelined; K3's host time
            per call; its route; the bound; and the gradients of
            `flash_cross_attention_diff` (K3 forward, dense recompute backward) against the
            plain version's at one b2 ToMe shape;
10. tome    the b2 ball detector with ToMe at ratio 0.4 (`SegFormerNet(tome_ratio=0.4)`
            with the detector's weights) on the 16 triplets at chunk 8: 16 K3, 0 K1 and
            16 K2 launches per forward, K3's route, frames/s, peak device memory with and
            without ToMe;
            K3 against its plain version on the (q, k, v) of the first block of each stage;
            heatmaps against a `kernels=False` copy in bf16 with its own merge plans and
            with the kernel path's; planted faults (wrong merge partners, a K3 that skips a
            key chunk) that must fail those limits; the share of tokens whose merge partner
            differs between the two paths, and how many of them a tie decides;
11. flip    `ball_detection("segformerpp_b2", chunk=8, flip_test=True)` on the triplets:
            32 K1 and 32 K2 launches per chunk, frames/s, heatmaps against a
            `kernels=False` f32 copy with the same flip test;
12. b0      `table_detection("segformerpp_b0", chunk=8)` on the centre frames (K2 at
            b0's widths 32 and 160 on the main path): launches, frames/s, heatmaps against
            a `kernels=False` f32 copy;
13. k6      K6 (box NMS, `ops/nms.py`): `nms(dets, thresh)` through the public entry
            point on seeded boxes (N in 1 ... 4096, thresh 0.3, 0.5, 0.7) and on a planted
            set (IoU exactly at each threshold, identical boxes, tied scores, boxes that
            overlap nothing), with the launch counts reset just before and read just
            after (2 per call); the kernel's suppression words against the plain version's
            bit for bit and the keep lists equal; a planted fault (`>` in place of `>=`)
            that the check must see; kernel and plain times per call at N = 400 and 4096,
            split into the overlap and the resolve launch; the bound, and the floor of the
            resolve's serial chain (its steps at the latency of one, which a one-thread
            kernel of the chain alone measures);
14. vitpose `hub.ball_detection("vitpose")` on the triplets and `hub.table_detection("vitpose")`
            on the centre frames at chunk 8, 1152x640: peak device memory and no port
            kernel launched on the 16 frames; frames/s as the median and range of 3 warm
            calls over 64 frames each; heatmaps against a `kernels=False` f32 copy (einsum attention);
            `keypoints_from_heatmaps` (default and unbiased) on the table heatmaps against
            the same call on their CPU copy;
15. k4      K4 (depthwise 3x3, `ops/dwconv.py`) against its plain versions (f32 on the same
            bf16 inputs), forward, and the backward kernel's dx, dw and db (through the
            autograd Function, as the trainer calls it), at the four b2 hidden shapes of the
            1600x896 trainer at batch 4 and one ragged shape; dw and db bit-identical over
            two calls; planted faults that the limits must reject (dx with the unflipped
            taps, the halo rows between the forward's row tiles dropped, one block's partial
            sum of dw and db left out, the halo column at the backward's tile seams dropped
            from dw); kernel, plain and library times (`F.conv2d(groups=C)` and
            `aten.convolution_backward`, channels_last bf16) and the bounds of both;
16. train   the SegFormer trainer (`train/run_detection.py`) on segformerpp_b2, ball,
            1600x896, batch 4, the loss at 1920x1080, on four synthetic triplets: (a) one
            step's loss and every parameter's gradient on the kernel path (bf16) against the
            f32 plain path (`kernels=False`, no TF32) on the same augmented batch, and a
            planted fault (K4's dx with the unflipped taps) that must break the limit; (b)
            one `train_step` (the main path, launch counts reset just before and read just
            after): 16 K1, 16 K2, 16 K4 forward and 32 K4 backward launches (16 calls,
            each the fused pass and the sum of its partials) and no other launch; (c) ten
            steps on one fixed
            batch: the loss finite and lower at the end; (d) ms per step (median of the warm
            steps), images/s and peak memory; (e) the CLI on the card: 2 steps and a
            validation pass on a tiny TTHQ layout written as PNGs, its checkpoint loaded by
            `BallDetector`;
16b. vitpose_train ViTPose-S in training mode (`run_detection` with `--model vitpose`):
            (a) one warm full-width step (batch 4, 1152x640, the loss at 1920x1080, bf16
            forward through `F.scaled_dot_product_attention`): ms (median of 3), images/s,
            peak memory, no port kernel launched; (b) the card's f32 step (einsum
            attention) against the CPU's from the same weights, batch and drop masks at
            256x192 batch 2 and at 32x32 batch 1, at the HRNet step's limits (loss 2e-2,
            gradients 5e-2, running statistics 1e-3), with planted faults that must break
            them (the drop path without `/ keep`, the head's BatchNorms on their running
            statistics in training, and at 32x32 the unbiased variance); the CPU's steps
            and these limits run beside the card tests (phase card_tests); (c)
            `run_detection --model vitpose --torch_init` on a synthetic MAE checkpoint for
            2 steps on a tiny TTHQ layout:
            it prints the counts `utils/port_torch.torch_init_detector` gives, and its
            checkpoint loads into `BallDetector`; (d) world size 1: one segformerpp_b0
            trainer step under DDP over NCCL against the same step without DDP (loss and
            gradients within twice the plain step's own repeat difference, the larger of
            two repeats; K1, K2 and K4
            forward and backward launched, as many as without DDP); `run_rally` of
            `hub.full_pipeline`'s pipeline given a one-card mesh, and `generate_dataset` on
            a one-card mesh, against the runs without (the latter from the same generator);
17. rally  `hub.full_pipeline()` (seeded random weights, chunk 8) on 64 synthetic 1920x1080
            frames at 50 fps through `TableTennisPipeline.run_rally`, the main path: launches
            per piece (32 K1, 32 K2, 80 K5a, 28 K5b; half of each on a ball-only piece of
            `table_stride` 16) with every count set to 0 just before and read just after;
            frames/s (one warm call each, RALLY_CALLS, after the counted ones) in rgb
            and i420 (`rally_inputs`, made during the build), with upload_res
            "model" and None, table_stride 1 and 2; the host downscale's ms per frame and
            the rate it would leave if it overlapped nothing (`no_overlap_frames_per_s`); every
            detector's peaks through the slab step (`_rally_peaks`) on 29 frames (triplets
            across piece edges, a padded last piece) against the same detector's own
            `predict` within 1e-3 px; rgb against i420 (shapes equal, the largest peak
            difference);
            i420 -> RGB of the 64 frames on the card against the CPU within 1 grey level;
            the uplifting tail (a pipeline whose ball aux is its ball main, so the filter
            keeps every interior frame): pos3d and the world-frame spin against the CPU f32
            model on the same inputs;
18. uplifting `hub.uplifting()` (connectstage / large, seeded weights) at T = 50 and a
            padded T = 12 against its CPU f32 copy; ms per call on the card and the CPU;
19. calib   `TableTennisPipeline.calibrate_camera` on the 13 table points projected through
            a known 1920x1080 camera with 1 px noise and one gross outlier: inlier count,
            the outlier rejected, the mean reprojection error (`reproject` on the card) of
            the others under 3 px (tests/test_calibration.py's bounds), on the card and on
            the CPU; ms per call;
20. physics S1 (the integrator, `ops/csrc/physics.cu`) against its plain version
            (`core/physics.py`) on the card: forward mode on 8,192 "intermediate" candidates
            of each direction over 500 frames, tangent mode on fit_physics's 32 starts over
            502 frames; per trajectory |dr| <= 1e-4 m, |dv| <= 1e-3 m/s, |dw| <= 1e-2 rad/s
            and dr/dq within 1e-3 of its largest, all but S1_KNIFE_EDGES, and every output
            bit-equal at both shapes (the plain version run as one captured step replayed,
            a CUDA graph of its own kernels: `graph=True`); planted faults (the net left
            out of the contacts, one tangent direction zeroed) that must fail those limits;
            ms per call (and back to back) and SM cycles per step, the plain version's
            time (its graph replay, capture included), the bound (bytes,
            operations, and the serial chain worked out from the code at the latencies of
            physics.cu's op_latency_kernel); the kernel on one trajectory, beside it; the
            tangent also at the physics-fit evaluation's 512 starts; ptxas' registers and
            spills and the SASS facts of each step loop (`ptxas=`, `sass=`); the step's
            anatomy (`anatomy=`: a one-thread %clock64 probe of the flight, the contact
            tests, the bounces and the frame stores) and the fast division and square root
            against IEEE on 2^30 operand pairs (`fast_ops=`, gated);
21. datagen `generate_dataset("intermediate")` at batch 8,192 until 1,024 accepted, cold and
            warm: trajectories/s, the acceptance rate, 1 S1 launch per batch; the first
            batch's candidates on the CPU's plain path (run beside the card tests) against
            the card's (accept mask and bounce counts on at least 99.5% of them);
22. fit     `TableTennisPipeline.fit_physics` at its defaults (32 starts, 250 Adam, 12 LM
            steps: 262 tangent and 14 forward S1 launches per call) on tests/test_fitting.py's
            topspin and backspin states observed through the simulation camera at 50 fps over
            the JAX tests' 0.46 s and over 1 s, and on one accepted datagen trajectory over
            1 s (each once): seconds per fit,
            reproj_px, basin_spread_m, the mean 3D
            error against the truth and the spin class (gates on the two test states over
            0.46 s: under 10 cm and the right class); one warm start (`init=`) from the
            topspin truth perturbed by 2 cm; the two states over 1 s from JAX's own draws
            (tests/fit_witness_1s.npz) beside the JAX fit's outcome on them, gated where
            the JAX fit recovers the state;
23. uplift_train the uplifting trainer at run_uplifting's defaults (connectstage large,
            batch 64, the default augmentations): `generate_production.main` at 1% of the
            paper's recipe (1,400 trajectories over the six modes, final_win capped; S1
            launches counted, trajectories/s per shard and mode) and a 64-trajectory TTST
            layout (`make_synthetic_ttst`); gate 1: `assemble_batch` and `train_augment` on
            the card against the CPU from the same draws (camera picks, px, masks); gate 2:
            one step (loss, every gradient) on the card against the CPU in f32, and the
            clip/Adam/EMA update from the same gradients (the changes of the parameters, EMA
            and both moments), with two planted faults (the clip left out, the EMA not
            updated) that must fail it; gate 3: tests/test_data_pipeline.py's 60 steps at lr
            1e-3 from the weights and batch JAX used (tests/uplift_witness_60.npz) lower the
            loss below 0.9 of the first and follow JAX's losses; ms per assembly and per
            step (median of 5 warm), trajectories/s, kernel launches of each, the idle share,
            peak memory; the CLI
            (`run_uplifting.main`) over two epochs with --ttst_dir, then --resume for a third
            (the state as loaded bit-equal to the first run's, every checkpoint the metrics
            call for present, `hub.uplifting(checkpoint=model_synthetic)` equal to the run's
            EMA weights), and `run_uplifting_eval.main` on it: finite metrics under the four
            robustness transforms;
24. closed_loop the closed-loop protocol (`eval/closed_loop.py`) with the committed trained
            weights (`upliftingtabletennis_torch/weights/closed_loop/`: WASB and b0 at
            960x544, the back-view uplifting model): (a) CL_RALLIES held-out rallies of a
            store generated on the card, rendered at 1920x1080 and scored through
            `run_rally` against the simulation (K1/K2 in b0, K5a/K5b in WASB, counted),
            gated on the ball, table, calibration and 3D medians, printed beside the JAX
            package's numbers, ms per rally; the kernel path's ball and table peaks on one
            rally's frames against a `kernels=False` f32 copy's; (b) one training step of
            WASB (batch 2, 960x544) and the table HRNet with remat, on the card and on the
            CPU in f32 from the same weights and batch (the CPU's steps, and the limits
            that read them, beside the card tests): the loss, every gradient and the
            running statistics, a planted fault (the statistics moved again by the remat
            recompute) that must fail, and the unbiased-variance fault's error; ms per
            bf16 step and peak memory with and without remat at 960x544 batch 2 and at
            run_detection's 1280x704 batch 4; (c) `closed_loop.main` for a few training
            steps per task and 2 rallies, and `run_detection --model wasb` / `--task table
            --model hrnet` for 2 steps on a tiny TTHQ layout, whose checkpoints
            `BallDetector` / `TableDetector` load; (d) the evaluation entry points on
            (a)'s pipeline and store (EV_RALLIES): `evaluate_rally` and
            `evaluate_rally_ttst` on held-out rallies (finite, TTST under the ball and
            table gates, launches per piece counted) and `visualize_rally`'s two PNGs;
            `run_detection_eval`'s detections on tiny_tthq with the committed WASB and b0,
            the card against the CPU under the peak rule; `run_physics_fit_eval`'s store
            protocol on 16 test trajectories at its defaults (S1 launches counted, the
            coverage and the 3D median reported); `compare_speed` of WASB and b0;
            `hub.download_example_images` and `run_rally` on its frames;
25. item7   the last modules' card paths: (a) BlurBall pretraining through `run_detection
            --data blurball` at its defaults (b2, batch 4, 1600x896, 3 frames) on a
            synthetic tree of 1080p PNGs: 2 ball steps and a validation, 1 table step, each
            step's K1 / K2 / K4 / K4b launches against phase train's 16 / 16 / 16 / 32, the
            losses finite, ms per step and per batch load, the checkpoint at
            `pretraining_blurball/segformerpp_b2/model.pt` and `run_detection.warm_start`
            (what `--pretraining` calls) loading every tensor of it into a fresh b2 ball
            detector; (b) the uplifting trainer's step under DDP over NCCL at world size 1
            against the plain step (connectstage large, batch 64, 3 steps from one seed,
            deterministic algorithms): every parameter bit-equal; ms per step and the last
            step's launches, both in deterministic mode; (c)
            `hub.full_pipeline(weights_url="file://...")` on a reference weights zip (WASB,
            the table HRNet, the uplifting model; the b2 slots seeded): one `run_rally`
            piece of 8 frames bit-equal to a pipeline of the same weights mapped directly,
            its K1 / K2 / K5a / K5b launches those of a rally piece (RALLY_PER_PIECE), a
            second call served by the cache; (d) `extract_ttst` on a two-event raw layout at 2560x1440 (each
            camera within 2 px of the truth, at least 6 inliers), `annotation_qa` on a
            planted left/right swap, `one_euro_trajectory` on the card against the CPU;
26. card_tests the card's unit tests (`tests/test_torch_cuda_kernels.py`,
            `tests/test_torch_cuda_uplifting.py`) in a child pytest on the kernels the
            build left (a library built anew fails the run), after the parent frees its
            cached device memory, beside the earlier phases' CPU references and the gates
            that read them: the counts of passed, failed, errors and skipped, and the
            seconds; any failure or error, or fewer than CARD_TESTS_MIN passed, fails the
            run;
27. hygiene  neither JAX nor the JAX package was imported.

Any failed phase raises and the exit code is not 0. Without CUDA, or without the
port's package beside it, it exits non-zero before printing any result. The line
before the last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

T0 = time.time()

B2_STAGES = [  # (H, W, C, heads, Nkv, depth) of segformerpp_b2 at 1600x896
    (224, 400, 64, 1, 1400, 3),
    (112, 200, 128, 2, 1400, 4),
    (56, 100, 320, 5, 1400, 6),
    (28, 50, 512, 8, 1400, 3),
]
K2_RAGGED = (34, 60, 256)  # segformerpp_b0 stage 4 at 1920x1088: H, W not tile multiples
K2_B0 = [(272, 480, 32), (68, 120, 160)]  # segformerpp_b0 stages 1 and 3 at 1920x1088
CHUNK = 4  # the first slice's chunk: the batch K1/K2 see in the k1, k2 and slice phases
N_TRIPLETS = 8
DEVICE = "cuda"
HR_CHUNK = 8  # the four-detector phase's chunk: the batch K5 sees on the main path
HR_H, HR_W = 704, 1280  # WASB / HRNet model input
N_FRAMES = 16  # centre frames of the four-detector phase (2 chunks of 8)

# K5 shapes outside the HRNet: (ks, Ci, Co, H, W, residual, relu), H and W not tile multiples
K5_RAGGED = [(3, 16, 16, 701, 1277, True, True), (1, 32, 16, 349, 637, False, False)]
K5A_PER_FORWARD, K5B_PER_FORWARD, STRIDE2_PER_FORWARD = 40, 14, 18
B2_PER_FORWARD = 16  # MiTBlocks of segformerpp_b2: one K1 and one K2 launch each
B0_PER_FORWARD = 8   # MiTBlocks of segformerpp_b0
TOME_RATIO = 0.4  # the ratio of the JAX package's own ToMe test (tests/test_token_merge.py)
TOME_PLANS_PER_FORWARD = 16  # merging starts at N >= 256: every b2 block at 1600x896
# K3 shapes: (B, Nq, Nkv, heads, hd, depth). The four b2 stages at chunk 8, 1600x896,
# with ToMe at 0.4 (Nq = N - int(0.4 N)); b0 stage 1 at 1920x1088 (130,560 tokens); ragged.
K3_RAGGED = (2, 1037, 777, 2, 64)  # the last 128-key chunk holds 9 keys and 119 zero-filled
K3_ROUTE = "tma+wgmma"  # K3's one route: TMA ring, wgmma products, ping-pong warpgroups
K3_SHAPES = [(8, 53760, 1400, 1, 64, 3), (8, 13440, 1400, 2, 64, 4), (8, 3360, 1400, 5, 64, 6),
             (8, 840, 1400, 8, 64, 3), (8, 78336, 2040, 1, 32, 0), (*K3_RAGGED, 0)]

# K1's second input set: keys of std 3 (logits of std ~3, so a few keys carry each row's
# softmax and the attention term is as large as x). On the first set (keys of std 1) the
# head outputs are about 0.04 and a fault that skips one key chunk moves the output by
# about 0.01, below K1's absolute limit; on this one it moves the rows whose keys it
# skips by about 1.
K1_SHARP_K_STD = 3.0

# H100 SXM peaks (NVIDIA H100 data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12
SM_CLOCK_HZ = 1.98e9  # boost clock
# 16 MUFU results per clock per SM on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput) x 132 SMs x the boost clock
SFU_PER_S = 16 * 132 * SM_CLOCK_HZ

# |kernel - plain| <= ATOL + RTOL * |plain|: bf16 output rounding alone is up to half
# an ulp (0.0156 at |x| in [4, 8)); bf16 rounding of LN(x), q or the hidden tensor and
# of the attention weights adds a few ulps of the half-block's update.
ATOL, RTOL = 6e-2, 2e-2
# K3 (its inputs are the same bf16 tensors on both sides): the kernel rounds each
# probability to bf16 before P.V (relative error at most u = 2^-8, bf16's unit roundoff;
# the row sum l stays f32) and its output (at most u |out|), so |kernel - plain| <=
# u (sum_j p_j |v_j| / l + |out|) to first order in u; the f32 sums add about 1e-7 of it.
# The limit is that bound, per element (`k3_check`). On random inputs it is about 3e-3,
# where a mean |out| of 0.04 sits below K1's 6e-2 absolute term.
K3_ULPS = 2.0 ** -8
# K5: its inputs are the same bf16 tensors on both sides and only its output is
# rounded to bf16 (half an ulp: at most 2^-8 |plain|, 0.031 at |x| in [8, 16)); the
# rest is the order of the f32 sums
K5_ATOL, K5_RTOL = 1e-2, 8e-3
# heatmaps of the bf16 kernel path vs the f32 plain path, relative to max |plain|:
# 16 residual blocks each round their output to bf16 (2^-9 relative).
HEAT_TOL = 5e-2
# the ToMe kernel path (bf16) against the ToMe plain path in bf16, each with the merge
# plans of its own activations. In bf16 (spacing 2^-8 near 1) the best similarities of
# neighbouring tokens tie: on the 1600x896 synthetic triplets a tie decides the merge of
# 26-48% of the tokens per block, and 99% of the tokens whose partner differs between the
# two paths. A tied token takes the mean query of another, similar neighbour. Readings:
# the two paths 3.6e-2 of max; ties broken by the last argmax instead of the first 6.0e-2;
# a wrong plan (every partner half of set B away) 0.18. The limit lies between; on the
# kernel path's own plans the two paths are held to HEAT_TOL.
TOME_HEAT_TOL = 1e-1
# the same for the HRNets: every one of their 72 convs and 9 fuse sums rounds to bf16
# (2^-9 relative), through 16 residual blocks; the plain path run in bf16 on the CPU
# (the kernels' roundings) gave 1.2e-2 (WASB) and 2.4e-2 (table) at 176x320, and the
# maximum over 8 x 704 x 1280 pixels is larger than over 2 x 176 x 320.
HRNET_HEAT_TOL = 8e-2
# ViTPose (no port kernel: SDPA, cuBLAS linears and cuDNN deconvolutions in bf16) against
# its f32 copy: 12 pre-LN blocks each round their residual stream to bf16 (2^-9 relative),
# as SegFormer's 16 blocks do
VIT_HEAT_TOL = 5e-2
# keypoints_from_heatmaps on the card against the same call on the CPU copy of the
# heatmaps: the argmax and the quarter shift are exact; DARK's blur sums in another order
KP_TOL_PX = 1e-3

K6_SIZES = (1, 13, 64, 65, 130, 400, 1000, 4096)
K6_THRESHOLDS = (0.3, 0.5, 0.7)
K6_TIMED = (400, 4096)  # N of the timed calls, at thresh 0.5
K6_FLOPS_PER_PAIR = 20  # max, min, sub, add, mul, div, compare over one pair of boxes
# the resolve's serial chain alone, timed on the card (nms.cu's serial_chain_kernel): this
# many dependent scans of 64 steps (about a million steps), in one thread, three calls
K6_CHAIN_CHUNKS, K6_CHAIN_CALLS = 16384, 3
VIT_RES = (1152, 640)  # ViTPose's native (W, H)
# ViTPose's frames/s: the median (and the range) of this many warm predict calls, each
# over VIT_RATE_ITEMS times the phase's 16 frames (8 chunks, about half a second): one
# call of 2 chunks lasts 0.1 s, too short a window for the host's clock on a shared host
VIT_RATE_CALLS, VIT_RATE_ITEMS = 3, 4

# the trainer: segformerpp_b2, ball, at its 1600x896 input, batch 4 (the JAX default), the
# loss at the 1920x1080 evaluation resolution
TRAIN_BATCH, TRAIN_RES, EVAL_RES = 4, (1600, 896), (1920, 1080)
# K4's shapes on that step: b2's hidden tensors (H, W, 4C), depth blocks per stage, each
# one forward launch (K2's recompute) and one backward call (its dx, dw and db)
K4_SHAPES = [(TRAIN_BATCH, H, W, 4 * C, depth) for H, W, C, _, _, depth in B2_STAGES]
K4_RAGGED = (2, 45, 77, 136, 0)  # H, W not multiples of the 8-column tile, C of 64 or 32
# dw and db (f32 sums over B*H*W, rounded to bf16) against the f32 plain version:
# |kernel - plain| <= K4_SUM_ATOL * max |plain| + K4_SUM_RTOL * |plain| per element. The
# output's bf16 rounding is at most 2^-9 |plain|; the two f32 sums in other orders differ
# by about 1e-6 of max |plain| (the sum of |g x| is about sqrt(B H W) times the sum's
# typical size). A block's partial left out moves its 32 channels by a sum of rows * 8
# products (its largest change is 10 or more times the limit at every shape here), a
# dropped halo column every side tap by a sum of 1/8 of its products.
K4_SUM_ATOL, K4_SUM_RTOL = 1e-3, 2.0 ** -8
# one step of the kernel path (bf16 forward, f32 loss) against the f32 plain path: the
# loss within 2e-2 relative (16 blocks round their residual stream to bf16, 2^-9
# relative). Each parameter's gradient err = ||g - g_f32|| / ||g_f32|| within 5e-2, or,
# where bf16 alone does worse, within TRAIN_GRAD_NOISE times the error of the plain path
# run in bf16 (`kernels=False`, the same bf16 batch): a sum over tokens that nearly
# cancels (the biases of the last blocks) carries the bf16 noise of every token. Measured
# on the card (H100, this phase): the plain path in bf16 has err > 5e-2 on 84-85 of b2's
# 340 tensors, up to 0.32 (stage3_block2.ffn.fc2.bias); the kernel path 1.66-1.73x the
# plain bf16 error at most (median 1.16x); the planted fault (K4's dx unflipped) reaches
# 1.9-2.0x this limit.
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_GRAD_NOISE = 2e-2, 5e-2, 2.5
# gradients that are zero in exact arithmetic: a per-channel constant before the head's
# batch-statistics BatchNorm cancels. Both paths must hold noise there, below 1e-3 of the
# largest gradient norm.
ZERO_GRAD = ("backbone.stage_norm_3.bias", "decode_head.linear_c0.bias",
             "decode_head.linear_c1.bias", "decode_head.linear_c2.bias",
             "decode_head.linear_c3.bias")
ZERO_GRAD_REL = 1e-3
TRAIN_STEPS = 10
K3_GRAD_SHAPE = (2, 13440, 1400, 2, 64)  # b2 ToMe stage 2 at batch 2

# the rally: 64 frames at 50 fps through the production ensemble at chunk 8 (8 pieces);
# the slab check on 61 frames: 7 whole pieces and a last piece of 5 padded to 8
RALLY_FRAMES, RALLY_FPS, RALLY_CALLS, RALLY_EDGE_FRAMES = 64, 50.0, 1, 61
# launches of one piece with table frames: two b2 (16 K1 + 16 K2 each), WASB and the table
# HRNet (40 K5a + 14 K5b each); a ball-only piece runs half of each
RALLY_PER_PIECE = {"fused_attention_block": 32, "fused_ln_ffn": 32, "conv3x3_bias_act": 80,
                   "conv1x1_bias_act": 28}
# the slab step against `predict` on the same triplets: the same kernels on the same images
SLAB_TOL_PX = 1e-3
# the uplifting model on the card (f32, no TF32) against its CPU copy: positions within
# 1e-4 of max |positions| and the world-frame spin within 1e-4 of |spin|, the same f32
# arithmetic summed in another order through 16 layers (the CPU tests hold the port to JAX
# at the same 1e-4). The card returns the spin in the flight frame of its own first step;
# the check turns it back with the card's own positions, so that the frame's turn, large
# where that step is short, does not enter the comparison.
UPLIFT_RTOL = 1e-4
UPLIFT_LENGTHS = (50, 12)  # a full sequence and one padded to SEQUENCE_LEN
UPLIFT_WARM_CALLS, UPLIFT_TIMED_CALLS = 2, 5  # ms per call: the median of the timed calls
# the calibration: a broadcast camera at 1920x1080, 1 px noise, keypoint 3 moved by
# (300, -200) px; tests/test_calibration.py's bounds: the others within 3 px on average,
# the outlier beyond 50 px
CALIB_RES, CALIB_NOISE_PX, CALIB_OUTLIER = (1920, 1080), 1.0, (3, (300.0, -200.0))
CALIB_MEAN_PX, CALIB_OUTLIER_PX, CALIB_CALLS = 3.0, 50.0, 1

# S1, the integrator (ops/csrc/physics.cu): forward mode at the datagen batch (8,192
# "intermediate" candidates, 500 frames, each direction), tangent mode at the fit's shape
# (fit_physics's 32 starts on a 1 s track: 502 frames)
S1_BATCH, S1_FRAMES = 8192, 500
FIT_STARTS, FIT_FRAMES = 32, 502
# the kernel against its plain version, per trajectory over the whole run: |dr| <= 1e-4 m,
# |dv| <= 1e-3 m/s, |dw| <= 1e-2 rad/s, and dr/dq within 1e-3 of the trajectory's largest
# |dr/dq|. The two run the same float32 operations in the same order, and the phase also
# requires every output bit-equal (`bitwise_differing` 0) at both shapes; a contact that
# they saw one step apart on a knife-edge crossing would move a trajectory by far more
# than the limit, and at most this many trajectories per call may do so
S1_ATOL = (1e-4, 1e-3, 1e-2)
S1_JAC_RTOL = 1e-3
S1_KNIFE_EDGES = {"forward": 8, "tangent": 1}  # of 8,192 and of 32 trajectories
S1_TIMED_CALLS = 10
S1_LAT_CHAIN = 4096  # dependent operations per kind in physics.cu's op_latency_kernel
S1_FAULT_DIRECTION = 4  # the planted tangent fault zeroes d r / d v0_y
S1_EVAL_STARTS = 512  # run_physics_fit_eval's tangent launches: 16 tracks x 32 starts
# the fit: fit_physics at its defaults (32 starts, 250 Adam and 12 LM steps), each fit
# once, on tests/test_fitting.py's topspin and backspin states observed through
# the simulation camera at 50 fps, over the JAX tests' window (24 detections, 0.46 s) and
# over 1 s (50 detections), and on one accepted datagen trajectory over 1 s. Gates, as
# the JAX tests set them (on their window): mean 3D error under 10 cm and the spin class,
# on the two test states and the warm start. The 1 s tracks are reported, and held
# against the JAX fit from JAX's own draws (`fit_witness`): from most keys the JAX fit
# itself misses the 1 s tracks, by 34 cm to meters
FIT_STATES = {"topspin": ((-1.1, 0.25, 1.05), (7.0, -0.6, 0.8), (5.0, 90.0, -15.0)),
              "backspin": ((-1.0, -0.2, 1.2), (7.0, 0.4, -0.6), (-10.0, -100.0, 15.0))}
FIT_SPIN_CLASS = {"topspin": 1.0, "backspin": 2.0}
FIT_OBS, FIT_OBS_LONG, FIT_STRIDE = 24, 50, 10  # detections; 500 fps frames between two
FIT_GATE_CM = 10.0
FIT_DATAGEN_TRACKS = 1  # accepted datagen trajectories fitted over 1 s, reported, not gated
FIT_LAUNCHES = {"simulate_tangent": 250 + 12, "simulate": 1 + 12 + 1}  # per fit_physics call
# datagen: generate_dataset("intermediate") at its production batch until this many
# accepted; the first batch again on the CPU's plain path must agree with the card on the
# accept mask and the bounce counts of at least this share of its candidates
DATAGEN_ACCEPTED, DATAGEN_BATCH, DATAGEN_CPU_AGREEMENT = 1024, 8192, 0.995
# uplift_train: the uplifting trainer at run_uplifting's defaults, the paper's (connectstage
# large, dynamic table tokens, time rotation "new", transform "global"; batch 64, 50 frames,
# lr 1e-4, clip 5, EMA 0.999, the default AugmentConfig). The corpus: generate_production
# at 1% of the paper's recipe (1,400 trajectories over the six modes and two directions),
# each final_win shard capped at UPLIFT_CAP_S seconds; a synthetic TTST layout of
# UPLIFT_TTST trajectories. Step times: the median of UPLIFT_TIMED_STEPS warm steps.
UPLIFT_SCALE, UPLIFT_GEN_BATCH, UPLIFT_CAP_S, UPLIFT_TTST = 0.01, 8192, 3.0, 64
UPLIFT_BATCH, UPLIFT_TIMED_STEPS, UPLIFT_PROFILED_STEPS = 64, 5, 1
# gate 1: the batch assembly on the card against the CPU from the same draws. The cameras'
# sin, cos and norms round differently on the two, so a candidate whose projection touches
# the image border, or the 15% span, within a rounding can be judged differently there: at
# most this many of the 64 rows may pick another camera. Where the picks agree the
# projections agree within UPLIFT_PX_ATOL px (f32 at up to 2560 px: ulp 2.4e-4) before and
# after the augmentations (from the same draws), and the augmented masks are equal.
UPLIFT_PICK_KNIFE_EDGES, UPLIFT_PX_ATOL = 1, 1e-2
# gate 2: one step on the card against the same step on the CPU in f32 (no TF32), from the
# same weights, EMA and batch: the loss within 1e-4 relative and each gradient within 1e-3
# of its tensor's max |grad| (the same f32 arithmetic summed in other orders through 16
# layers; the CPU tests hold the port to JAX at 1e-5 and 2e-4 at size small). Then the
# update (clip, Adam, EMA) from the card's gradients on both: the change of the
# parameters, of the EMA and of both Adam moments within 1e-2 of each tensor's largest
# change (the same operations on the same inputs: roundings of the updated values; the
# EMA starts UPLIFT_EMA_OFFSET x N(0, 1) away from the parameters so that its change, 1e-3
# of that gap, stands far above them). Planted faults that must fail it: the clip left out
# (max_norm = inf: the moments move by the gradient's norm over the clip; the step asserts
# that norm is at least twice the clip) and the EMA not updated (decay 1: no change).
UPLIFT_LOSS_RTOL, UPLIFT_GRAD_REL, UPLIFT_UPDATE_REL, UPLIFT_EMA_OFFSET = 1e-4, 1e-3, 1e-2, 0.1
# gate 3, as tests/test_data_pipeline.py::test_train_step_reduces_loss asks of JAX: its 60
# steps at lr 1e-3 on its one validation batch (connectstage small, batch 16), from the
# weights and the batch JAX used there (tests/uplift_witness_60.npz, made by
# tests/make_uplift_witness.py): the loss falls below 0.9 of the first, and every step's
# loss stays within UPLIFT_FIT_RTOL of JAX's (roundings grow through Adam's steps; the CPU
# test holds the port to the same file at the same limit). From other draws of the same
# initialisation the ratio lands on either side of 0.9 for both packages, hence the JAX
# test's own draws. At full width (large, batch 64) no 60-step run is held, since there
# rounding decides the ratio: from the same weights JAX ends at 0.896, JAX with half its
# weights one ulp up at 0.925, the port at 0.909 and the port in float64 at 0.917; the
# port and JAX agree within 2.2e-6 over the first 5 steps and part beyond 1e-3 from step
# 14, JAX one ulp off from step 17, and the port stays nearer the float64 run (1.0e-2
# against JAX's 2.3e-2; tests/make_uplift_witness.py, on the CPU). The full-width step is
# held to JAX on the CPU (tests/test_torch_uplifting_train.py::test_full_width_*) and the
# card's to the CPU's by gate 2.
UPLIFT_FIT_STEPS, UPLIFT_FIT_LR, UPLIFT_FIT_RATIO, UPLIFT_FIT_RTOL = 60, 1e-3, 0.9, 1e-2
# closed_loop: the committed trained weights scored on CL_RALLIES held-out rallies of a
# 256-trajectory store generated on the card (seed 0), detectors at their trained
# 960x544. The gates sit at about twice the JAX package's 63-rally numbers (README's
# round-5 table, artifacts/closed_loop/closed_loop_results.json: ball 0.48, table 0.92,
# calibration 1.08 px, 3D 6.62 cm medians): 8 rallies give a noisy median, and the port
# runs its own draws (cameras, noise, RANSAC). Spin accuracy is reported, not gated.
CL_RALLIES = 8
CL_GATES = {"ball_detection_px_median": 1.0, "table_detection_px_median": 2.0,
            "calib_reproj_px_median": 3.0, "pos3d_err_cm_median": 15.0}
CL_JAX = {"ball_detection_px_median": 0.48, "ball_detection_px_mean": 0.53,
          "table_detection_px_median": 0.92, "table_detection_px_mean": 1.23,
          "calib_reproj_px_median": 1.08, "pos3d_err_cm_median": 6.62,
          "pos3d_err_cm_mean": 8.91, "spin_accuracy": 0.857, "spin_macro_f1": 0.837,
          "physfit_coverage": 0.746, "physfit_pos3d_err_cm_median_converged": 4.05}
# the kernel path (bf16) against a kernels=False f32 copy on the same frames of
# CL_PEAK_RALLIES rallies, with the copy also run in bf16 (the kernels' type without the
# kernels). A detection is a heatmap peak of at least CL_PEAK_MIN (the table detector's
# visibility threshold) on either path; one seen by one path only is a miss. bf16 alone
# moves a sub-pixel peak by up to 0.6 px and flips an ambiguous table keypoint's argmax by
# 23 px (on an H100: the bf16 copy 0.620 px worst on 70 ball detections, 22.81
# px on 988 table detections; the kernel path 0.503 and 22.83). So a detection where the
# kernel path misses the f32 peak by more than CL_PEAK_PX is charged to the kernels only
# where the bf16 copy is within CL_PEAK_PX of it; at least CL_PEAK_SHARE of the
# detections must carry no charge. Both bf16 paths' shares within CL_PEAK_NEAR and
# CL_PEAK_PX of the f32 peaks, and the kernel path's of the bf16 copy's, are logged.
CL_PEAK_PX, CL_PEAK_SHARE, CL_PEAK_MIN, CL_PEAK_RALLIES, CL_PEAK_NEAR = 1.0, 0.99, 0.1, 2, 0.5
# one HRNet training step on the card against the CPU, both f32 (no TF32), from the same
# weights and batch: the trainer's limits (the loss within 2e-2 relative, each gradient
# within 5e-2 of its tensor's max |grad|) and the running statistics within 1e-3 of each
# tensor's max. The statistics moved twice (the remat recompute running the update in
# place) move them by 10% of their distance to the batch's: that must fail. The unbiased
# variance moves them by var / (n - 1), n >= 2 x 68 x 120 at 960x544: its error is logged
# (phase vitpose_train gates that fault at a size where it shows, VT_UNBIASED_CASE).
HR_STEP_RES, HR_STEP_BATCH = (960, 544), 2
HR_LOSS_RTOL, HR_GRAD_REL, HR_STATS_REL = 2e-2, 5e-2, 1e-3
HR_TIMED = (((960, 544), 2), ((1280, 704), 4))  # (W, H), batch: the closed loop, run_detection
HR_TIMED_STEPS = 1
# the CLI: a few steps per task at the closed loop's default resolution, 2 rallies
CL_CLI_STEPS, CL_CLI_RES = 2, (960, 544)
# closed_loop (d): the evaluation entry points on the closed loop's pipeline and store.
# EV_RALLIES held-out rallies through `evaluate_rally` (TTHQ) and `evaluate_rally_ttst`
# (TTST: the store's truth as annotations at 2560x1440, laid out as extract_ttst lays them
# out, one padding frame at each end), every number finite, TTST's ball detection and
# table errors (their means over the rallies) under CL_GATES' ball and table gates, the
# kernels launched per piece as in (a); `run_detection_eval`'s detections with the
# committed WASB and b0 at their trained 960x544 on a TTHQ layout of EV_DET_FRAMES frames
# of a held-out rendered rally (the truth as labels; the test split is every other
# sample), EV_DET_LIMIT[task] test samples each, the card's against the CPU's f32 under the
# peak rule of CL_PEAK_* over both tasks' detections (the CPU's run beside the card
# tests, as (b)'s CPU steps do); the physics-fit
# evaluation's store protocol on EV_FIT_TRAJ test trajectories at its defaults (one batch:
# FIT_LAUNCHES S1 launches); `compare_speed` of WASB and b0 at batch 8, EV_SPEED_ITERS
# forwards; `download_example_images`, and `run_rally` on its frames.
EV_RALLIES, EV_FIT_TRAJ, EV_SPEED_ITERS = 2, 16, 5
EV_DET_FRAMES, EV_DET_LIMIT = 18, {"ball": 4, "table": 8}
# vitpose_train: (a) ViTPose-S trained as the JAX trainer trains it (batch VT_BATCH at
# 1152x640, the loss at 1920x1080), VT_TIMED warm steps timed; (b) the card's f32 step
# (einsum attention, no TF32) against the CPU's from the same weights, batch and drop masks,
# at the HRNet step's limits (HR_*): at a reduced size, and at batch 1 on a 2x2 token grid,
# where the head's first BatchNorm sees 16 values per channel, so that the unbiased
# variance (16/15 of the biased) moves the running variance past HR_STATS_REL; (c) the CLI
# at VT_CLI_RES; (d) the b0 trainer under DDP at world size 1 (VT_DDP_*) against the same
# step without DDP, both deterministic, at VT_DDP_TOL; run_rally on
# VT_RALLY_FRAMES frames and generate_dataset (VT_DATAGEN: accepted, batch) with a
# one-card mesh.
VT_BATCH, VT_TIMED = 4, 3
VT_CHECK = (((256, 192), 2), ((32, 32), 1))
VT_UNBIASED_CASE = "32x32_b1"
VT_CLI_RES = (256, 192)
VT_DDP_RES, VT_DDP_BATCH = (960, 544), 2
VT_DDP_TOL = 1e-6  # the loss and every gradient tensor, of its max |grad|
VT_RALLY_FRAMES = 16
VT_DATAGEN = (64, 2048)
# phase item7: BlurBall pretraining at the trainer's defaults (b2, batch 4, 1600x896, 3
# frames) on a synthetic tree of 1080p frames (train video 1, holdout video 3: 8 train and
# 4 val samples), the uplifting trainer under DDP, the reference weights zip, and the
# extraction and QA on the card.
I7_BLURBALL_VIDEOS = ((1, 10), (3, 10))
I7_BALL_STEPS, I7_TABLE_STEPS = 2, 1
I7_STEP_LAUNCHES = {"fused_attention_block": 16, "fused_ln_ffn": 16, "depthwise_conv3x3": 16,
                    "dwconv3x3_backward": 32}  # phase train's b2 step
I7_DDP_STEPS, I7_DDP_BATCH, I7_DDP_STORE = 3, 64, 256
I7_ZIP_FRAMES = 8  # one run_rally piece
I7_TTST_RES = (2560, 1440)
I7_PX_TOL, I7_MIN_INLIERS = 2.0, 6
I7_SMOOTH_TOL = 1e-6
# phase card_tests: the card's unit tests (odd shapes, limits and gradient routes that the
# phases do not cover) in a child pytest on the built kernels; every case must pass, and at
# least CARD_TESTS_MIN of them (the count the two files held when the phase came in)
CARD_TEST_FILES = ("tests/test_torch_cuda_kernels.py", "tests/test_torch_cuda_uplifting.py")
CARD_TESTS_MIN, CARD_TESTS_TIMEOUT_S = 223, 600
# the CUDA API calls that launch a kernel, as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
CARD = ""  # nvidia-smi's name and power limit, set by main


def sass_counts(_build, sources, ops=("HGMMA", "UTMALDG", "UTMASTG", "HMMA")):
    """{source: {SASS instruction: count}} of built libraries, by `cuobjdump -sass` from
    the toolkit (warpgroup products, TMA loads and stores, mma.sync); {} without it."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    counts = {}
    for src in sources:
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(src))], capture_output=True,
                              text=True, check=True).stdout
        counts[src] = {op: len([w for w in sass.split() if w.split(".")[0] == op]) for op in ops}
    return counts


def timed(fn, *args):
    """(fn(*args), its seconds on the host's clock)."""
    t = time.time()
    return fn(*args), time.time() - t


def log(phase: str, **kv) -> None:
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {items} elapsed_s={time.time() - T0:.1f}", flush=True)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pipelined_ms(torch, fn, reps: int = 20) -> float:
    """Device ms of one call when calls are issued back to back (the host runs ahead, as
    in a model's forward): CUDA events around `reps` calls, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_breakdown(torch, fn, calls: int = 5) -> dict:
    """{kernel name: device us per call} over `calls` warm calls of `fn` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][:60]: e.self_device_time_total / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


def k1_bound(B, N, C, heads, Nkv, softmax=True):
    """(ms, bound_by) for K1 (softmax=False: the probe's no_softmax, no exponentials):
    each input read once, the output written once."""
    nbytes = 2 * (2 * B * N * C + 2 * B * Nkv * C + 2 * C * C + 4 * C)
    flops = 4 * B * N * C * C + 4 * B * N * Nkv * C  # q/out projections, QK^T, PV
    exps = B * N * Nkv * heads if softmax else 0
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / BF16_TC_FLOPS, exps / SFU_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound(B, N, C, HID, taps=9):
    """(ms, bound_by) for K2 (taps=1: the probe's centre-tap modes): each input read once,
    the output written once."""
    nbytes = 2 * (2 * B * N * C + 2 * C * HID + 9 * HID + 2 * HID + 3 * C)
    flops = 4 * B * N * C * HID  # fc1 and fc2 on the tensor cores
    dw_flops = 2 * taps * B * N * HID  # depthwise 3x3 on the f32 cores
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / BF16_TC_FLOPS, dw_flops / FP32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_bound(B, Nq, Nkv, heads, hd):
    """(ms, bound_by) for K3: q, k, v read once, the output written once."""
    nbytes = 2 * (2 * B * Nq * heads * hd + 2 * B * Nkv * heads * hd)
    flops = 4 * B * heads * Nq * Nkv * hd  # QK^T and PV on the tensor cores
    exps = B * heads * Nq * Nkv
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / BF16_TC_FLOPS, exps / SFU_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


_MADE = {}  # inputs made once and shared by the phases (most during the build)


def synthetic_frames(n_frames: int):
    """(n_frames, 1080, 1920, 3) uint8: a textured background and a bright Gaussian
    blob moving across the frames. Frame t is the same whatever n_frames, so every call
    copies the first frames of one set of max(n_frames, RALLY_FRAMES), made once."""
    import numpy as np

    made = _MADE.get("frames")
    if made is None or len(made) < n_frames:
        rng = np.random.default_rng(0)
        yy, xx = np.mgrid[0:1080, 0:1920].astype(np.float32)
        bg = 90 + 40 * np.sin(xx / 37.0)[..., None] * np.cos(yy / 23.0)[..., None] \
            + rng.normal(0, 12, (1080, 1920, 3)).astype(np.float32)
        frames = []
        for t in range(max(n_frames, RALLY_FRAMES)):
            cx, cy = 300 + 140 * t, 700 - 45 * t
            blob = 160 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 6.0**2))
            frames.append(np.clip(bg + blob[..., None], 0, 255).astype(np.uint8))
        made = _MADE["frames"] = np.stack(frames)
    return made[:n_frames].copy()


def rally_inputs(torch):
    """The rally phase's 64 frames in rgb and in i420 (`rgb_to_i420`, on the host), and
    the CPU's `i420_to_rgb` of the i420 frames (the reference of the card's), made once."""
    if "rally" not in _MADE:
        import numpy as np

        from upliftingtabletennis_torch.data.image_transforms import i420_to_rgb, rgb_to_i420

        frames = synthetic_frames(RALLY_FRAMES)
        with ThreadPoolExecutor(max_workers=4) as pool:  # numpy frees the GIL: 4 at once
            i420 = np.concatenate(list(pool.map(rgb_to_i420, np.array_split(frames, 4))))
        _MADE["rally"] = ({"rgb": frames, "i420": i420},
                          i420_to_rgb(torch.from_numpy(i420), 1080, 1920))
    return _MADE["rally"]


def compare(torch, got, want, atol=ATOL, rtol=RTOL):
    err = (got.float() - want.float()).abs()
    max_abs = err.max().item()
    max_rel = (err / want.float().abs().clamp_min(1e-3)).max().item()
    ok = bool((err <= atol + rtol * want.float().abs()).all().item())
    return max_abs, max_rel, ok


def k3_check(torch, got, q, k, v, want, scale=None):
    """K3's output `got` against its plain version `want` (f32) at K3's limit,
    K3_ULPS (|want| + softmax(q kᵀ) |v|) per element: (max_abs_err, max of err / limit,
    ok)."""
    from upliftingtabletennis_torch.ops.flash_attention import cross_attention_plain

    limit = K3_ULPS * (want.abs() + cross_attention_plain(q.float(), k.float(),
                                                          v.float().abs(), scale))
    err = (got.float() - want).abs()
    ok = bool((err <= limit).all().item())
    worst = (err / limit.clamp_min(1e-30)).max().item()
    return err.max().item(), worst, ok


def k3_stale_keys(Nkv):
    """Key indices of K3 with one stale ring stage: the chunk STAGES chunks after the first
    holds the first chunk's keys (what a consumer reads when it waits on the wrong mbarrier
    parity), and the keys beyond it are as they are."""
    import torch

    from upliftingtabletennis_torch.ops.flash_attention import CHUNK, STAGES

    idx = torch.arange(Nkv)
    lo = CHUNK * STAGES
    n = min(CHUNK, Nkv - lo)
    if n > 0:
        idx[lo:lo + n] = torch.arange(n)
    return idx


def host_us_per_call(torch, fn, calls: int = 20) -> float:
    """Host microseconds per call issued back to back (argument checks, tensor maps, the
    launch): the host clock around `calls` calls after a synchronise, without one inside."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def k1_inputs(torch, gen, B, N, C, heads, Nkv, k_std=1.0):
    """x and K1's parameters (gamma, beta, wq, bq, k, v, wp, bp), seeded bf16 on the card."""
    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=DEVICE) * std).to(torch.bfloat16)

    hd = C // heads
    x = rnd(B, N, C)
    # wq and wp as the model passes them: views of torch Linear weights (out, in)
    return x, (1 + rnd(C, std=0.1), rnd(C, std=0.1), rnd(C, C, std=C ** -0.5).t(), rnd(C, std=0.1),
               rnd(B, Nkv, heads, hd, std=k_std), rnd(B, Nkv, heads, hd),
               rnd(C, C, std=C ** -0.5).t(), rnd(C, std=0.1))


def k1_faults(torch, x, heads, args, want):
    """K1's planted faults, simulated with the plain version and rounded as the kernel
    rounds: the keys of one 64-key chunk skipped (keys 64..127), and the last head's
    output dropped from the concat (its V zeroed). {fault: caught by the k1 limit}."""
    from upliftingtabletennis_torch.ops.fused_attention import attention_block_plain

    gamma, beta, wq, bq, k, v, wp, bp = [a.float() for a in args]
    keep = torch.cat([torch.arange(64), torch.arange(128, k.shape[1])]).to(DEVICE)
    v_drop = v.clone()
    v_drop[:, :, -1] = 0
    faults = {
        "key_chunk_skipped": attention_block_plain(x.float(), heads, gamma, beta, wq, bq, k[:, keep],
                                                   v[:, keep], wp, bp),
        "head_dropped": attention_block_plain(x.float(), heads, gamma, beta, wq, bq, k, v_drop,
                                              wp, bp),
    }
    return {name: not compare(torch, f.to(torch.bfloat16), want)[2] for name, f in faults.items()}


def run_k1(torch, F, ops, gen, profile=False):
    from upliftingtabletennis_torch.ops.fused_attention import attention_block_plain, attention_plan

    entries = []
    for H, W, C, heads, Nkv, depth in B2_STAGES:
        B, N, hd = CHUNK, H * W, C // heads
        x, args = k1_inputs(torch, gen, B, N, C, heads, Nkv)
        gamma, beta, wq, bq, k, v, wp, bp = args

        def kernel():
            return ops.fused_attention_block(x, H, W, heads, *args)

        def plain():
            return attention_block_plain(x.float(), heads, *[a.float() for a in args])

        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        max_abs, max_rel, ok = compare(torch, got, want)
        del want
        # the same check on sharp attention (keys 3x larger: logits of std ~3, a few keys
        # carry each row), where one skipped key chunk or one dropped head moves the
        # output beyond the limit; the planted faults are simulated on these inputs
        xs, sharp = k1_inputs(torch, gen, B, N, C, heads, Nkv, k_std=K1_SHARP_K_STD)
        got_sharp = ops.fused_attention_block(xs, H, W, heads, *sharp)
        torch.cuda.synchronize()
        want_sharp = attention_block_plain(xs.float(), heads, *[a.float() for a in sharp])
        sharp_abs, _, sharp_ok = compare(torch, got_sharp, want_sharp)
        caught = k1_faults(torch, xs, heads, sharp, want_sharp)
        del want_sharp, got_sharp, xs, sharp
        wq_t, wp_t = wq.t(), wp.t()  # the Linear weights themselves
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

        def stock():
            y = F.layer_norm(x, (C,), gamma, beta, 1e-6)
            q = F.linear(y, wq_t, bq).view(B, N, heads, hd).transpose(1, 2)
            o = F.scaled_dot_product_attention(q, kt, vt)
            return x + F.linear(o.transpose(1, 2).reshape(B, N, C), wp_t, bp)

        stock_err = (stock().float() - got.float()).abs().max().item()
        ms, plain_ms, stock_ms = time_ms(torch, kernel), time_ms(torch, plain, iters=5), \
            time_ms(torch, stock)
        ms_pipe, stock_pipe = pipelined_ms(torch, kernel), pipelined_ms(torch, stock)
        host_us = host_us_per_call(torch, kernel)
        breakdown = kernel_breakdown(torch, kernel) if profile else None
        bound_ms, bound_by = k1_bound(B, N, C, heads, Nkv)
        plan = attention_plan(B, N, C, heads)
        e = dict(shape=dict(B=B, N=N, C=C, heads=heads, Nkv=Nkv), depth=depth, ms=ms,
                 host_us=host_us, plain_ms=plain_ms, library_ms=stock_ms, bound_ms=bound_ms,
                 bound_by=bound_by,
                 ms_pipelined=ms_pipe, library_ms_pipelined=stock_pipe, device_us=breakdown,
                 max_abs_err=max(max_abs, sharp_abs), max_rel_err=max_rel,
                 sharp_max_abs_err=sharp_abs, faults_caught=caught,
                 stock_vs_kernel_max_abs=stock_err,
                 blocks=[g for g in (plan["ln_grid"], plan["attention_grid"], plan["proj_grid"]) if g])
        log("k1", H=H, W=W, C=C, heads=heads, max_abs_err=f"{max_abs:.4g}",
            sharp_max_abs_err=f"{sharp_abs:.4g}", max_rel_err=f"{max_rel:.4g}", ms=f"{ms:.4f}",
            host_us=f"{host_us:.1f}", stock_ms=f"{stock_ms:.4f}", ms_pipelined=f"{ms_pipe:.4f}",
            stock_ms_pipelined=f"{stock_pipe:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, faults_caught=json.dumps(caught), ok=ok and sharp_ok)
        if not (ok and sharp_ok):
            raise AssertionError(f"K1 disagrees with its plain version at {(H, W, C)}: "
                                 f"max_abs_err={max_abs}, on sharp attention {sharp_abs}")
        if not all(caught.values()):
            raise AssertionError(f"K1's limit does not reject a planted fault at {(H, W, C)}: "
                                 f"{caught}")
        entries.append(e)
    return entries


def k2_faults(torch, x, H, W, th, args, want):
    """K2's planted faults, simulated with the plain version and rounded as the kernel
    rounds: the last 64-channel hidden chunk skipped (its W2 rows zeroed), and the halo
    rows between the plan's TH-row tiles zeroed (each band of TH rows convolved alone).
    {fault: caught by the k2 limit}."""
    from upliftingtabletennis_torch.ops.fused_ffn import ln_ffn_plain

    f32 = [a.float() for a in args]
    w2_cut = f32[6].clone()
    w2_cut[-64:] = 0
    B, _, C = x.shape
    xi = x.float().reshape(B, H, W, C)
    bands = [ln_ffn_plain(xi[:, r:r + th].reshape(B, -1, C), min(th, H - r), W, *f32)
             .reshape(B, -1, W, C) for r in range(0, H, th)]
    faults = {"last_hidden_chunk_skipped": ln_ffn_plain(x.float(), H, W, *f32[:6], w2_cut, f32[7]),
              "tile_halo_rows_zeroed": torch.cat(bands, 1).reshape(B, H * W, C)}
    return {name: not compare(torch, f.to(torch.bfloat16), want)[2] for name, f in faults.items()}


def run_k2(torch, F, ops, gen, profile=False):
    import upliftingtabletennis_torch.ops.fused_ffn as k2
    from upliftingtabletennis_torch.ops.fused_ffn import ffn_plan, ln_ffn_plain

    shapes = [(H, W, C, depth) for H, W, C, _, _, depth in B2_STAGES] + [(*K2_RAGGED, 0)]
    shapes += [(*hwc, 0) for hwc in K2_B0]
    entries = []
    for H, W, C, depth in shapes:
        B, N, HID = CHUNK, H * W, 4 * C

        def rnd(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device=DEVICE) * std).to(torch.bfloat16)

        x = rnd(B, N, C)
        # w1 and w2 as the model passes them: views of torch Linear weights (out, in)
        args = (1 + rnd(C, std=0.1), rnd(C, std=0.1), rnd(HID, C, std=C ** -0.5).t(),
                rnd(HID, std=0.1), rnd(3, 3, HID, std=1 / 3), rnd(HID, std=0.1),
                rnd(C, HID, std=HID ** -0.5).t(), rnd(C, std=0.1))
        gamma, beta, w1, b1, dw, bdw, w2, b2 = args
        plan = ffn_plan(B, H, W, C, HID)

        def kernel():
            return ops.fused_ln_ffn(x, H, W, *args)

        def plain():
            return ln_ffn_plain(x.float(), H, W, *[a.float() for a in args])

        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        max_abs, max_rel, ok = compare(torch, got, want)
        caught = k2_faults(torch, x, H, W, plan.th, args, want)
        # where the width has both routes (the plan's choice, measured): the other one held
        # to the same limit, and both timed back to back through the same C entry
        # (comparison launches: not counted)
        other = {"fused": "split", "split": "fused"}[plan.route]
        alt = None
        if C in k2.FUSED_WIDTHS:
            operands = k2._operands(x, H, W, *args)[0]

            def route_kernel(route):
                return lambda: k2.run_kernel(k2._lib(), "uttk_fused_ffn", (), operands,
                                             ffn_plan(B, H, W, C, HID, route), H, W, 1e-6,
                                             "fused_ln_ffn")

            alt_abs, _, alt_ok = compare(torch, route_kernel(other)(), want)
            alt = dict(route=other, max_abs_err=alt_abs, ok=alt_ok,
                       ms_pipelined={r: pipelined_ms(torch, route_kernel(r))
                                     for r in (plan.route, other)})
            ok = ok and alt_ok
        del want
        w1_t, w2_t = w1.t(), w2.t()  # the Linear weights themselves
        dw_conv = dw.permute(2, 0, 1).unsqueeze(1).contiguous()

        def stock():
            y = F.layer_norm(x, (C,), gamma, beta, 1e-6)
            h = F.linear(y, w1_t, b1).view(B, H, W, HID).permute(0, 3, 1, 2)
            h = F.conv2d(h, dw_conv, bdw, padding=1, groups=HID)
            z = F.gelu(h).permute(0, 2, 3, 1).reshape(B, N, HID)
            return x + F.linear(z, w2_t, b2)

        ms, plain_ms, stock_ms = time_ms(torch, kernel), time_ms(torch, plain, iters=5), \
            time_ms(torch, stock)
        ms_pipe, stock_pipe = pipelined_ms(torch, kernel), pipelined_ms(torch, stock)
        host_us = host_us_per_call(torch, kernel)
        breakdown = kernel_breakdown(torch, kernel) if profile else None
        bound_ms, bound_by = k2_bound(B, N, C, HID)
        e = dict(shape=dict(B=B, H=H, W=W, C=C, HID=HID), route=plan.route,
                 ms_pipelined=ms_pipe, library_ms_pipelined=stock_pipe, device_us=breakdown,
                 tile=[plan.th, plan.tw],
                 blocks=[g for g in (plan.ln_grid, plan.fc1_grid, plan.grid, plan.fc2_grid) if g],
                 depth=depth, ms=ms, host_us=host_us,
                 plain_ms=plain_ms, library_ms=stock_ms, bound_ms=bound_ms, bound_by=bound_by,
                 max_abs_err=max_abs, max_rel_err=max_rel, faults_caught=caught, other_route=alt)
        log("k2", H=H, W=W, C=C, route=plan.route, tile=f"{plan.th}x{plan.tw}",
            max_abs_err=f"{max_abs:.4g}", max_rel_err=f"{max_rel:.4g}", ms=f"{ms:.4f}",
            host_us=f"{host_us:.1f}", stock_ms=f"{stock_ms:.4f}", ms_pipelined=f"{ms_pipe:.4f}",
            stock_ms_pipelined=f"{stock_pipe:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, faults_caught=json.dumps(caught),
            other_route=json.dumps(alt), ok=ok)
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {(H, W, C)}: "
                                 f"max_abs_err={max_abs}, other route {alt}")
        if not all(caught.values()):
            raise AssertionError(f"K2's limit does not reject a planted fault at {(H, W, C)}: "
                                 f"{caught}")
        entries.append(e)
    return entries


def run_probe(torch, ops):
    """P1/P2 through their public `run`: every mode at the four b2 stage shapes at batch
    CHUNK, against its plain version at the k1/k2 limits, timed interleaved; the launch
    counts of the probe kernels set to 0 just before and read just after."""
    from upliftingtabletennis_torch.tools import probe_attn_phases as p2
    from upliftingtabletennis_torch.tools import probe_ffn_phases as p1

    p2.attention_probe.launches = p1.ffn_probe.launches = 0
    for name in ops.ALL:
        getattr(ops, name).launches = 0
    reports = {"attention_probe": p2.run(batch=CHUNK, plain_iters=3),
               "ffn_probe": p1.run(batch=CHUNK, plain_iters=3)}
    launches = {"attention_probe": p2.attention_probe.launches, "ffn_probe": p1.ffn_probe.launches,
                "fused_attention_block": ops.fused_attention_block.launches,
                "fused_ln_ffn": ops.fused_ln_ffn.launches}
    bad = []
    for probe, modes in (("attention_probe", p2.MODES), ("ffn_probe", p1.MODES)):
        for stage, e in reports[probe].items():
            B, H, W, C = (e["shape"][k] for k in "BHWC")
            for m in modes:
                if probe == "attention_probe":
                    bound = k1_bound(B, H * W, C, e["shape"]["heads"], e["shape"]["Nkv"],
                                     softmax=m != "no_softmax")
                else:
                    bound = k2_bound(B, H * W, C, 4 * C, taps=1 if "dw" in m else 9)
                e[m]["bound_ms"], e[m]["bound_by"] = bound
                if not e[m]["ok"]:
                    bad.append((probe, stage, m, e[m]["max_abs_err"]))
            log("probe", kernel=probe, stage=stage,
                ms=json.dumps({m: round(e[m]["ms"], 4) for m in modes}),
                plain_ms=json.dumps({m: round(e[m]["plain_ms"], 4) for m in modes}),
                max_abs_err=json.dumps({m: round(e[m]["max_abs_err"], 4) for m in modes}),
                shares=json.dumps({k: round(v, 3) for k, v in e["shares"].items()}),
                ok=all(e[m]["ok"] for m in modes))
    log("probe", launches=json.dumps(launches))
    if bad:
        raise AssertionError(f"a probe variant disagrees with its plain version: {bad}")
    if not (launches["attention_probe"] and launches["ffn_probe"]):
        raise AssertionError(f"the probe phase launched no probe kernel: {launches}")
    return {"reports": reports, "launches": launches}


def probe_summary(probe_res, name, source, replaces, modes):
    """The kernels-line entry of one probe: its variants (every mode but `full`) summed
    over the four b2 stages at batch CHUNK."""
    rep = probe_res["reports"][name]
    cells = [e[m] for e in rep.values() for m in modes[1:]]
    bytes_share = sum(c["bound_ms"] for c in cells if c["bound_by"] == "bytes")
    bound = sum(c["bound_ms"] for c in cells)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": probe_res["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cells),
            "ms": sum(c["ms"] for c in cells), "plain_ms": sum(c["plain_ms"] for c in cells),
            "bound_ms": bound, "bound_by": "bytes" if bytes_share * 2 > bound else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes a phase-probe variant",
            "per": f"each variant ({', '.join(modes[1:])}) once at each of the four b2 stages "
                   f"at batch {CHUNK}, summed; launches over the probe phase",
            "per_stage": rep}


def run_k3(torch, F, ops, gen):
    from upliftingtabletennis_torch.ops.flash_attention import cross_attention_plain

    entries = []
    for B, Nq, Nkv, heads, hd, depth in K3_SHAPES:
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE).to(torch.bfloat16)

        q, k, v = rnd(B, Nq, heads, hd), rnd(B, Nkv, heads, hd), rnd(B, Nkv, heads, hd)

        def kernel():
            return ops.flash_cross_attention(q, k, v)

        def plain():
            return cross_attention_plain(q.float(), k.float(), v.float())

        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        max_abs, worst, ok = k3_check(torch, got, q, k, v, want)
        # the limit must see two faults, simulated with the plain version: the keys of
        # one 64-key chunk skipped, and (at the ragged shape) the last chunk's
        # zero-filled slots left unmasked, logit 0
        keep = torch.cat([torch.arange(64), torch.arange(128, Nkv)]).to(DEVICE)
        faults = {"chunk": cross_attention_plain(q.float(), k[:, keep].float(),
                                                 v[:, keep].float()).to(q.dtype)}
        # a wrong mbarrier parity: one chunk's K/V read from the stage a ring depth earlier
        stale = k3_stale_keys(Nkv).to(DEVICE)
        faults["stale"] = cross_attention_plain(q.float(), k[:, stale].float(),
                                                v[:, stale].float()).to(q.dtype)
        if (B, Nq, Nkv, heads, hd) == K3_RAGGED:
            pad = torch.zeros(B, -Nkv % 128, heads, hd, device=DEVICE, dtype=k.dtype)
            faults["tail"] = cross_attention_plain(
                q.float(), torch.cat([k, pad], 1).float(), torch.cat([v, pad], 1).float()
            ).to(q.dtype)
        fault_worst = {name: k3_check(torch, f, q, k, v, want)[1] for name, f in faults.items()}
        del want, faults
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, h, N, hd) views

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt)

        lib_err = (library().transpose(1, 2).float() - got.float()).abs().max().item()
        ms, plain_ms, lib_ms = time_ms(torch, kernel), time_ms(torch, plain, iters=5), \
            time_ms(torch, library)
        ms_pipe, lib_pipe = pipelined_ms(torch, kernel), pipelined_ms(torch, library)
        host_us = host_us_per_call(torch, kernel)
        bound_ms, bound_by = k3_bound(B, Nq, Nkv, heads, hd)
        e = dict(shape=dict(B=B, Nq=Nq, Nkv=Nkv, heads=heads, hd=hd), depth=depth,
                 route=K3_ROUTE, ms=ms, ms_pipelined=ms_pipe, host_us=host_us,
                 plain_ms=plain_ms, library_ms=lib_ms, library_ms_pipelined=lib_pipe,
                 bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_abs,
                 err_over_limit=worst, fault_err_over_limit=fault_worst,
                 library_vs_kernel_max_abs=lib_err)
        log("k3", B=B, Nq=Nq, Nkv=Nkv, heads=heads, hd=hd, route=K3_ROUTE,
            max_abs_err=f"{max_abs:.4g}", err_over_limit=f"{worst:.4g}", ms=f"{ms:.4f}",
            ms_pipelined=f"{ms_pipe:.4f}", host_us=f"{host_us:.1f}", sdpa_ms=f"{lib_ms:.4f}",
            sdpa_ms_pipelined=f"{lib_pipe:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            fault_err_over_limit=json.dumps({n: round(w, 3) for n, w in fault_worst.items()}),
            ok=ok)
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version at {(B, Nq, Nkv, heads, hd)}"
                                 f": max_abs_err={max_abs}, max err / limit {worst}")
        if not all(w > 1 for w in fault_worst.values()):
            raise AssertionError(f"K3's limit does not reject a simulated fault at "
                                 f"{(B, Nq, Nkv, heads, hd)}: {fault_worst}")
        entries.append(e)
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    # the backward Function: K3's forward, the dense recompute's gradients, against the
    # plain version's gradients on f32 copies of the same bf16 inputs
    B, Nq, Nkv, heads, hd = K3_GRAD_SHAPE
    inputs = [torch.randn(B, n, heads, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
              for n in (Nq, Nkv, Nkv)]
    leaves = [t.clone().requires_grad_() for t in inputs]
    ref = [t.float().requires_grad_() for t in inputs]
    out = ops.flash_cross_attention(*leaves)
    cot = torch.randn(out.shape, generator=gen, device=DEVICE).to(out.dtype)
    got = torch.autograd.grad(out, leaves, cot)
    want = torch.autograd.grad(cross_attention_plain(*ref), ref, cot.float())
    grad_err = {n: ((a.float() - b).norm() / b.norm()).item()
                for n, a, b in zip("qkv", got, want)}
    log("k3", backward_shape=json.dumps(K3_GRAD_SHAPE), grad_rel_err=json.dumps(
        {n: round(v, 5) for n, v in grad_err.items()}))
    if not max(grad_err.values()) <= TRAIN_GRAD_REL:
        raise AssertionError(f"flash_cross_attention_diff's gradients differ from the plain "
                             f"version's: {grad_err}")
    entries[0]["backward_grad_rel_err"] = grad_err
    del inputs, leaves, ref, out, got, want
    torch.cuda.empty_cache()
    return entries


def k6_bound(n):
    """(ms, bound_by) for one nms_mask call: dets (N, 5) f32 read once, the suppression
    words (N x ceil(N / 64) uint64, about N^2 / 8 bytes) and the keep mask written once;
    K6_FLOPS_PER_PAIR f32 operations on each of the N (N - 1) / 2 pairs."""
    nbytes = 20 * n + 8 * n * (-(-n // 64)) + n
    flops = K6_FLOPS_PER_PAIR * n * (n - 1) / 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k6_serial_step(torch, words):
    """The latency of one step of the resolve's serial chain, measured on the card: nms.cu's
    serial_chain_kernel runs K6_CHAIN_CHUNKS dependent scans of 64 steps over the diagonal
    words of the first chunk of `words` and reads %globaltimer and %clock64 around them.
    Returns (ns, SM cycles) per step, the least of K6_CHAIN_CALLS calls."""
    import ctypes

    from upliftingtabletennis_torch.ops import _build

    lib = _build.library("nms.cu")
    chain = lib.uttk_nms_serial_chain
    chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    chain.restype = ctypes.c_int
    diag = torch.zeros(64, dtype=torch.int64, device=words.device)
    diag[:min(64, words.shape[0])] = words[:64, 0]
    out = torch.zeros(3, dtype=torch.int64, device=words.device)
    steps, best = K6_CHAIN_CHUNKS * 64, None
    for _ in range(K6_CHAIN_CALLS):
        status = _build.call_on_device(out, lambda stream: chain(
            diag.data_ptr(), K6_CHAIN_CHUNKS, out.data_ptr(), stream))
        _build.check(lib, status, "nms serial chain")
        ns, cycles = out[1:].tolist()
        best = min(best or (ns, cycles), (ns, cycles))
    return best[0] / steps, best[1] / steps


def nms_dets(n, seed):
    """(n, 5) f32 boxes as tests/test_nms.py makes them: x1, y1 uniform over 800 x 500,
    sides 10-200, scores uniform in [0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x1, y1 = rng.uniform(0, 800, n), rng.uniform(0, 500, n)
    w, h, s = rng.uniform(10, 200, n), rng.uniform(10, 200, n), rng.uniform(0, 1, n)
    return np.stack([x1, y1, x1 + w, y1 + h, s], -1).astype(np.float32)


def planted_dets():
    """Boxes whose decisions ties and exact roundings make: IoU exactly 0.5, 0.3 and 0.7
    in f32 (one pair each, the last pair tied in score), identical boxes with tied
    scores, tied boxes that overlap nothing."""
    import numpy as np

    return np.array([
        [0, 0, 9, 9, 0.9], [0, 0, 9, 4, 0.8], [100, 0, 109, 9, 0.9], [100, 0, 109, 2, 0.7],
        [200, 0, 209, 9, 0.6], [200, 0, 209, 6, 0.6], [300, 300, 350, 350, 0.5],
        [300, 300, 350, 350, 0.5], [300, 300, 350, 350, 0.4], [500, 500, 510, 510, 0.5],
        [600, 600, 610, 610, 0.5], [700, 0, 720, 20, 0.5]], np.float32)


def run_k6(torch, ops):
    import numpy as np

    from upliftingtabletennis_torch.ops import nms as k6

    cases = [(f"n{n}", nms_dets(n, seed=n)) for n in K6_SIZES] + [("planted", planted_dets())]
    # the main path: the public entry point on every case and threshold
    for k in ops.ALL:
        getattr(ops, k).launches = 0
    kept = {(name, t): k6.nms(d, t, device=DEVICE) for name, d in cases for t in K6_THRESHOLDS}
    launches = {k: getattr(ops, k).launches for k in ops.ALL}
    want = {k: 0 for k in ops.ALL}
    want.update(overlap_words=len(kept), resolve_words=len(kept))
    if launches != want:
        raise AssertionError(f"k6 main path launches {launches}, expected {want}")

    def keep_list(keep, dets):  # the `nms` contract: kept indices by descending score
        idx = np.nonzero(keep.cpu().numpy())[0]
        return idx[np.argsort(-dets[idx, 4], kind="stable")].tolist()

    bad_bits, bad_keep, fault_bits, per_case = 0, [], {}, []
    for name, d in cases:
        dets = torch.from_numpy(d).to(DEVICE)
        order = k6.score_order(dets)
        boxes = dets[order, :4].contiguous()
        n = len(d)
        for t in K6_THRESHOLDS:
            words = k6.overlap_words(boxes, t)
            plain = k6.overlap_words_plain(boxes, t)
            diff = int(k6.unpack_words(words ^ plain, n).sum().item())
            keep = k6.resolve_words(words, order)
            keep_plain = k6.resolve_plain(plain, order)
            lists = {"main_path": kept[(name, t)], "kernel": keep_list(keep, d),
                     "plain": keep_list(keep_plain, d), "cpu": k6.nms(d, t, device="cpu")}
            bad_bits += diff
            if any(v != lists["plain"] for v in lists.values()):
                bad_keep.append((name, t))
            if name == "planted":  # the planted fault: `>` in place of `>=`
                over = k6.pair_iou_plain(boxes) > torch.tensor(t, dtype=torch.float32)
                over &= torch.ones(n, n, dtype=torch.bool, device=DEVICE).triu(1)
                fault_bits[t] = int(k6.unpack_words(k6.pack_words(over) ^ words, n).sum().item())
            per_case.append(dict(case=name, n=n, thresh=t, differing_bits=diff,
                                 kept=len(lists["plain"])))
    torch.cuda.synchronize()

    timed = []
    for n in K6_TIMED:
        d = nms_dets(n, seed=n)
        dets = torch.from_numpy(d).to(DEVICE)
        order = k6.score_order(dets)
        boxes = dets[order, :4].contiguous()
        words = k6.overlap_words(boxes, 0.5)
        ms = time_ms(torch, lambda: k6.resolve_words(k6.overlap_words(boxes, 0.5), order))
        overlap_ms = time_ms(torch, lambda: k6.overlap_words(boxes, 0.5))
        resolve_ms = time_ms(torch, lambda: k6.resolve_words(words, order))
        call_ms = time_ms(torch, lambda: k6.nms_mask(dets, 0.5))
        piped = {k: pipelined_ms(torch, f) for k, f in (
            ("ms", lambda: k6.resolve_words(k6.overlap_words(boxes, 0.5), order)),
            ("overlap_ms", lambda: k6.overlap_words(boxes, 0.5)),
            ("resolve_ms", lambda: k6.resolve_words(words, order)))}
        plain_ms = time_ms(torch, lambda: k6.resolve_plain(k6.overlap_words_plain(boxes, 0.5),
                                                           order), iters=3, warmup=1)
        bound_ms, bound_by = k6_bound(n)
        # the floor of a serial resolve: its 64 steps per chunk at the measured step latency
        step_ns, step_cycles = k6_serial_step(torch, words)
        floor_ms = 1e-6 * step_ns * 64 * words.shape[1]
        e = dict(n=n, thresh=0.5, ms=ms, overlap_ms=overlap_ms, resolve_ms=resolve_ms,
                 nms_mask_call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, serial_floor_ms=floor_ms, serial_step_ns=step_ns,
                 serial_step_cycles=step_cycles, launches_per_call=2,
                 **{f"{k}_pipelined": v for k, v in piped.items()})
        log("k6", n=n, ms=f"{ms:.4f}", overlap_ms=f"{overlap_ms:.4f}",
            resolve_ms=f"{resolve_ms:.4f}", nms_mask_call_ms=f"{call_ms:.4f}",
            pipelined=json.dumps({k: round(v, 5) for k, v in piped.items()}),
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
            serial_floor_ms=f"{floor_ms:.5f}", serial_step_ns=f"{step_ns:.4f}",
            serial_step_cycles=f"{step_cycles:.3f}")
        timed.append(e)
    log("k6", calls=len(kept), launches=launches, differing_bits=bad_bits,
        keep_lists_differ=len(bad_keep), planted_fault_bits=json.dumps(fault_bits))
    if bad_bits or bad_keep:
        raise AssertionError(f"K6 disagrees with its plain version: {bad_bits} bits differ, "
                             f"keep lists differ at {bad_keep}")
    if not all(fault_bits.get(t, 0) > 0 for t in K6_THRESHOLDS):
        raise AssertionError(f"the check does not see a `>` in place of `>=`: {fault_bits}")
    torch.cuda.empty_cache()
    return dict(launches=launches, calls=len(kept), differing_bits=bad_bits,
                planted_fault_bits=fault_bits, cases=per_case, timed=timed)


def run_slice(torch, ops, profile=False):
    import numpy as np

    from upliftingtabletennis_torch.data.image_transforms import normalize_image
    from upliftingtabletennis_torch.hub import ball_detection
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.ops.resize import resize_bilinear_down
    from upliftingtabletennis_torch.pipeline.interface import HEIGHT, WIDTH

    frames = synthetic_frames(N_TRIPLETS + 2)
    triples = [(frames[t], frames[t + 1], frames[t + 2]) for t in range(N_TRIPLETS)]
    det = ball_detection("segformerpp_b2", device=DEVICE, chunk=CHUNK)
    det.predict(triples)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()

    ops.fused_attention_block.launches = 0
    ops.fused_ln_ffn.launches = 0
    t = time.time()
    pos, _ = det.predict(triples)  # the main path
    dt = time.time() - t
    launches = {"fused_attention_block": ops.fused_attention_block.launches,
                "fused_ln_ffn": ops.fused_ln_ffn.launches}
    fps = N_TRIPLETS / dt

    if pos.shape != (N_TRIPLETS, 3) or not np.isfinite(pos).all():
        raise AssertionError(f"bad peaks: shape {pos.shape}, finite {np.isfinite(pos).all()}")
    # the 3x3 fit may place a peak up to 2 heatmap pixels beyond its argmax
    MW, MH = det.resolution
    mx, my = 2 * WIDTH / (MW // 4), 2 * HEIGHT / (MH // 4)
    if not ((pos[:, 0] >= -mx) & (pos[:, 0] <= WIDTH + mx) & (pos[:, 1] >= -my)
            & (pos[:, 1] <= HEIGHT + my)).all():
        raise AssertionError(f"peaks outside the {WIDTH}x{HEIGHT} frame: {pos}")
    expected = (N_TRIPLETS // CHUNK) * 16  # 16 MiTBlocks per forward, one forward per chunk
    if launches["fused_attention_block"] != expected or launches["fused_ln_ffn"] != expected:
        raise AssertionError(f"main path launches {launches}, expected {expected} each")

    # heatmaps: kernel path (bf16) vs the plain path in f32 with the same weights
    ref, _ = get_detector("segformerpp_b2", "ball", kernels=False)
    ref.load_state_dict(det.model.state_dict())
    ref.eval().to(DEVICE, torch.float32)
    images = torch.from_numpy(np.stack([np.concatenate(tr, -1) for tr in triples[:CHUNK]]))
    images = images.to(DEVICE)
    with torch.no_grad():
        heat = det.heatmaps(images)
        x = normalize_image(resize_bilinear_down(images, MH, MW)).to(torch.bfloat16).float()
        heat_ref = ref(x)[0].permute(0, 3, 1, 2).float()
    heat_err = ((heat - heat_ref).abs().max() / heat_ref.abs().max()).item()
    log("slice", frames_per_s=f"{fps:.3f}", predict_s=f"{dt:.3f}", launches=launches,
        heat_rel_err=f"{heat_err:.4g}", heat_max_abs=f"{heat_ref.abs().max().item():.4g}",
        peaks=json.dumps(np.round(pos, 2).tolist()))
    if not heat_err <= HEAT_TOL:
        raise AssertionError(f"heatmaps of the kernel path differ from the f32 plain path: "
                             f"{heat_err} > {HEAT_TOL}")
    res = dict(frames_per_s=fps, predict_s=dt, launches=launches, heat_rel_err=heat_err,
               peaks=pos.tolist())
    if profile:
        res["profile"] = profile_calls(torch, lambda: det.predict(triples),
                                       "one warm b2 ball predict of 8 triplets")
    return res


def k5_bound(ks, B, H, W, Ci, Co, residual):
    """(ms, bound_by) for K5: x, w, b and the residual read once, out written once."""
    npix = B * H * W
    nbytes = 2 * npix * (Ci + Co * (2 if residual else 1)) + 2 * ks * ks * Ci * Co + 4 * Co
    flops = 2 * npix * ks * ks * Ci * Co
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def hrnet_conv_shapes(torch):
    """{(ks, Ci, Co, H, W, residual, relu): [per WASB forward, per table-HRNet forward]}
    of the stride-1 convs, recorded from one forward of each HRNet at 1280x704 on the
    meta device (shapes only, no data): the graph K5 runs on the main path. Recorded once
    per process (the phases k5 and hrnet read the same record)."""
    from upliftingtabletennis_torch.models import hrnet
    from upliftingtabletennis_torch.models.factory import get_detector

    if "hrnet_conv_shapes" in _MADE:
        return dict(_MADE["hrnet_conv_shapes"])
    shapes = collections.defaultdict(lambda: [0, 0])
    saved = hrnet.conv3x3_bias_act_plain, hrnet.conv1x1_bias_act_plain

    def spy(ks, fn, col):
        def wrapped(x, w, b=None, residual=None, *, relu):
            key = (ks, x.shape[-1], w.shape[-1], x.shape[1], x.shape[2], residual is not None,
                   relu)
            shapes[key][col] += 1
            return fn(x, w, b, residual, relu=relu)
        return wrapped

    try:
        for col, (name, task, n_in) in enumerate((("wasb", "ball", 3), ("hrnet", "table", 1))):
            hrnet.conv3x3_bias_act_plain = spy(3, saved[0], col)
            hrnet.conv1x1_bias_act_plain = spy(1, saved[1], col)
            model, _ = get_detector(name, task, kernels=False)
            with torch.no_grad():
                model.eval().to("meta")(torch.empty(1, HR_H, HR_W, 3 * n_in, device="meta"))
    finally:
        hrnet.conv3x3_bias_act_plain, hrnet.conv1x1_bias_act_plain = saved
    for col in (0, 1):
        per_ks = {k: sum(n[col] for key, n in shapes.items() if key[0] == k) for k in (3, 1)}
        if per_ks != {3: K5A_PER_FORWARD, 1: K5B_PER_FORWARD}:
            raise AssertionError(f"one HRNet forward runs {per_ks} stride-1 convs")
    _MADE["hrnet_conv_shapes"] = dict(shapes)
    return dict(shapes)


def k5_routes(torch):
    """{"ks Ci->Co": "route th x tw / nb / depth"} of the stride-1 convs both HRNets run:
    the launch plan `conv_plan` gives each on the main path."""
    from upliftingtabletennis_torch.ops.fused_conv import conv_plan

    routes = {}
    for ks, ci, co, *_ in hrnet_conv_shapes(torch):
        p = conv_plan(ks, ci, co)
        routes[f"{ks}x{ks} {ci}->{co}"] = f"{p.route} {p.th}x{p.tw} nb{p.nb} d{p.depth}"
    return routes


def k5_err_over_limit(torch, got, want):
    """max |got - want| / (K5_ATOL + K5_RTOL |want|): above 1 where K5's limit fails."""
    err = (got.float() - want).abs()
    return (err / (K5_ATOL + K5_RTOL * want.abs())).max().item()


def k5_faults(torch, plain_fn, plan, x, w, b, res, relu, want):
    """K5's planted faults, simulated with the plain version and rounded to bf16 as the
    kernel rounds, each as its max err / limit against `want` (which must exceed 1):
    `halo` (3x3 only) the halo rows at the seams of the plan's row tiles zeroed, as if
    the halo were not loaded; `tap` one tap's weights left out (the centre row's right
    tap; a 1x1 conv's only tap); `stale` the output tile at (row tile 0, column tile 1)
    computed from the previous tile's input and residual, as from a stale ring stage
    (the tile at (1, 0) from the one above where the image is one tile wide)."""
    def plain(xs, ws, rs):
        return plain_fn(xs.float(), ws.float(), b.float(), None if rs is None else rs.float(),
                        relu=relu).to(torch.bfloat16)

    faults = {}
    if w.ndim == 4:
        th = plan.th
        bands = [plain(x[:, i:i + th], w, None if res is None else res[:, i:i + th])
                 for i in range(0, x.shape[1], th)]
        faults["halo"] = k5_err_over_limit(torch, torch.cat(bands, 1), want)
        del bands
    w_tap = w.clone()
    if w.ndim == 4:
        w_tap[1, 2] = 0
    else:
        w_tap.zero_()
    faults["tap"] = k5_err_over_limit(torch, plain(x, w_tap, res), want)
    tw, th = plan.tw, plan.th
    stale = want.clone()
    if want.shape[2] >= 2 * tw:
        stale[:, :th, tw:2 * tw] = want[:, :th, :tw]
    else:  # one column of tiles: the previous tile is the one above
        stale[:, th:2 * th, :tw] = want[:, :th, :tw]
    faults["stale"] = k5_err_over_limit(torch, stale, want)
    return faults


def run_k5(torch, F, gen):
    from upliftingtabletennis_torch.ops import fused_conv as k5

    shapes = [(*key, *n) for key, n in hrnet_conv_shapes(torch).items()]
    shapes += [(*r, 0, 0) for r in K5_RAGGED]
    entries = []
    for ks, Ci, Co, H, W, has_res, relu, n_wasb, n_table in shapes:
        B = HR_CHUNK

        def rnd(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device=DEVICE) * std).to(torch.bfloat16)

        x = rnd(B, H, W, Ci)
        w = rnd(*((3, 3) if ks == 3 else ()), Ci, Co, std=(ks * ks * Ci) ** -0.5)
        b = rnd(Co, std=0.1)
        res = rnd(B, H, W, Co) if has_res else None
        packed = k5.pack(w, b)
        fn = k5.conv3x3_bias_act if ks == 3 else k5.conv1x1_bias_act
        plain_fn = k5.conv3x3_bias_act_plain if ks == 3 else k5.conv1x1_bias_act_plain

        def kernel():
            return fn(x, packed, None, res, relu=relu)

        def plain():
            return plain_fn(x.float(), w.float(), b.float(),
                            None if res is None else res.float(), relu=relu)

        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        max_abs, max_rel, ok = compare(torch, got, want, K5_ATOL, K5_RTOL)
        plan = k5.conv_plan(ks, Ci, Co)
        faults = k5_faults(torch, plain_fn, plan, x, w, b, res, relu, want)
        del want, got
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC tensor
        w_oihw = (w if ks == 3 else w[None, None]).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        res_nchw = None if res is None else res.permute(0, 3, 1, 2)

        def stock():
            y = F.conv2d(x_nchw, w_oihw, padding=ks // 2) + b.view(1, -1, 1, 1)
            if res_nchw is not None:
                y = y + res_nchw
            return torch.relu(y) if relu else y

        ms, plain_ms, stock_ms = time_ms(torch, kernel), time_ms(torch, plain, iters=3, warmup=1), \
            time_ms(torch, stock)
        ms_pipe, stock_pipe = pipelined_ms(torch, kernel), pipelined_ms(torch, stock)
        host_us = host_us_per_call(torch, kernel)
        bound_ms, bound_by = k5_bound(ks, B, H, W, Ci, Co, has_res)
        name = "conv3x3_bias_act" if ks == 3 else "conv1x1_bias_act"
        e = dict(kernel=name, shape=dict(B=B, H=H, W=W, Ci=Ci, Co=Co, residual=has_res,
                                         relu=relu),
                 per_forward={"wasb": n_wasb, "hrnet": n_table}, plan=plan._asdict(),
                 route=plan.route, ms=ms, ms_pipelined=ms_pipe, host_us=host_us, plain_ms=plain_ms,
                 library_ms=stock_ms, library_ms_pipelined=stock_pipe, bound_ms=bound_ms,
                 bound_by=bound_by, max_abs_err=max_abs, max_rel_err=max_rel,
                 fault_err_over_limit=faults)
        log("k5", kernel=name, Ci=Ci, Co=Co, H=H, W=W, res=has_res, per_fwd=f"{n_wasb}/{n_table}",
            route=plan.route, tile=f"{plan.th}x{plan.tw}", nb=plan.nb, depth=plan.depth,
            max_abs_err=f"{max_abs:.4g}", ms=f"{ms:.4f}", ms_pipelined=f"{ms_pipe:.4f}",
            host_us=f"{host_us:.1f}", stock_ms=f"{stock_ms:.4f}",
            stock_ms_pipelined=f"{stock_pipe:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            fault_err_over_limit=json.dumps({n: round(v, 3) for n, v in faults.items()}), ok=ok)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at "
                                 f"{(Ci, Co, H, W, has_res)}: max_abs_err={max_abs}")
        if not all(v > 1 for v in faults.values()):
            raise AssertionError(f"K5's limit does not reject a planted fault at "
                                 f"{(ks, Ci, Co, H, W, has_res)}: {faults}")
        entries.append(e)
        del x, res, packed
    torch.cuda.empty_cache()
    return entries


def perturb_batch_norms(torch, model, seed):
    """Non-trivial running statistics (init_weights leaves mean 0, var 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.add_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.mul_(0.5 + torch.rand(m.running_var.shape, generator=g))


def run_hrnet(torch, frames):
    import numpy as np

    from upliftingtabletennis_torch.data.image_transforms import normalize_image
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.ops import fused_conv as k5
    from upliftingtabletennis_torch.ops.resize import resize_bilinear_down
    from upliftingtabletennis_torch.pipeline.interface import init_weights

    res = {"routes": k5_routes(torch)}
    log("hrnet", k5_routes=json.dumps(res["routes"]))
    for name, task, n_in in (("wasb", "ball", 3), ("hrnet", "table", 1)):
        imgs = np.stack([np.concatenate(frames[t:t + n_in], -1) for t in range(HR_CHUNK)])
        images = torch.from_numpy(imgs).to(DEVICE)
        x = normalize_image(resize_bilinear_down(images, HR_H, HR_W)).to(torch.bfloat16)
        model, _ = get_detector(name, task)
        init_weights(model)
        perturb_batch_norms(torch, model, seed=1)
        strided = sum(isinstance(m, torch.nn.Conv2d) and m.stride[0] == 2
                      for m in model.modules())
        if strided != STRIDE2_PER_FORWARD:
            raise AssertionError(f"{name}: {strided} stride-2 convs, "
                                 f"expected {STRIDE2_PER_FORWARD}")
        ref, _ = get_detector(name, task, kernels=False)
        ref.load_state_dict(model.state_dict())
        model.eval().to(DEVICE)  # both fold their BatchNorms at their first forward
        ref.eval().to(DEVICE)

        def heat(out):
            return (out[0] if isinstance(out, tuple) else out).float()

        with torch.no_grad():
            heat(model(x))  # warm-up
            torch.cuda.synchronize()
            k5.conv3x3_bias_act.launches = k5.conv1x1_bias_act.launches = 0
            t = time.time()
            got = heat(model(x))
            torch.cuda.synchronize()
            fwd_ms = 1e3 * (time.time() - t)
            launches = {"conv3x3_bias_act": k5.conv3x3_bias_act.launches,
                        "conv1x1_bias_act": k5.conv1x1_bias_act.launches}
            want = heat(ref(x.float()))
        err = ((got - want).abs().max() / want.abs().max()).item()
        log("hrnet", model=name, forward_ms=f"{fwd_ms:.2f}", launches=launches,
            heat_rel_err=f"{err:.4g}", heat_max_abs=f"{want.abs().max().item():.4g}")
        if launches != {"conv3x3_bias_act": K5A_PER_FORWARD, "conv1x1_bias_act": K5B_PER_FORWARD}:
            raise AssertionError(f"{name}: K5 launches per forward {launches}")
        if not err <= HRNET_HEAT_TOL:
            raise AssertionError(f"{name}: heatmaps of the kernel path differ from the f32 "
                                 f"plain path: {err} > {HRNET_HEAT_TOL}")
        res[name] = dict(forward_ms=fwd_ms, launches=launches, heat_rel_err=err)
        del model, ref, got, want
    torch.cuda.empty_cache()
    return res


def plain_heat_err(torch, det, images):
    """max |heatmaps of the detector (bf16, kernels) - those of a `kernels=False` copy
    in f32 with the same weights, on the same bf16-rounded input| / max |copy|."""
    from upliftingtabletennis_torch.data.image_transforms import normalize_image
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.ops.resize import resize_bilinear_down

    from upliftingtabletennis_torch.ops.heatmap_decode import flip_test_heatmaps

    ref, _ = get_detector(det.model_name, det.task, kernels=False, resolution=det.resolution)
    ref.load_state_dict(det.model.state_dict())
    ref.eval().to(DEVICE, torch.float32)
    MW, MH = det.resolution

    def forward(t):
        out = ref(t)
        return out[0] if isinstance(out, tuple) else out

    with torch.no_grad():
        heat = det.heatmaps(images)
        x = normalize_image(resize_bilinear_down(images, MH, MW)).to(det.dtype).float()
        heat_ref = flip_test_heatmaps(forward, x) if det.flip_test else forward(x)
        heat_ref = heat_ref.permute(0, 3, 1, 2).float()
    err = ((heat - heat_ref).abs().max() / heat_ref.abs().max()).item()
    del ref, heat, heat_ref, x
    torch.cuda.empty_cache()
    return err


def run_detectors(torch, ops, frames, profile=False):
    import numpy as np

    from upliftingtabletennis_torch.hub import ball_detection, table_detection
    from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector

    triples = [(frames[t], frames[t + 1], frames[t + 2]) for t in range(N_FRAMES)]
    centres = [frames[t + 1] for t in range(N_FRAMES)]
    dets = {"segformerpp_b2_ball": (ball_detection("segformerpp_b2", device=DEVICE,
                                                   chunk=HR_CHUNK), triples),
            "wasb_ball": (ball_detection("wasb", device=DEVICE, chunk=HR_CHUNK), triples),
            "segformerpp_b2_table": (table_detection("segformerpp_b2", device=DEVICE,
                                                     chunk=HR_CHUNK), centres),
            "hrnet_table": (table_detection("hrnet", device=DEVICE, chunk=HR_CHUNK), centres)}
    for det, items in dets.values():  # warm-up: cuDNN algorithm choice, allocator
        det.predict(items)
    torch.cuda.synchronize()

    for k in ops.ALL:
        getattr(ops, k).launches = 0
    out, secs = {}, {}
    for name, (det, items) in dets.items():  # the main path
        t = time.time()
        out[name] = det.predict(items)[0]
        secs[name] = time.time() - t
    launches = {k: getattr(ops, k).launches for k in ops.ALL}

    n_chunks = N_FRAMES // HR_CHUNK
    expected = {k: 0 for k in ops.ALL}
    expected.update({"fused_attention_block": 2 * n_chunks * B2_PER_FORWARD,
                     "fused_ln_ffn": 2 * n_chunks * B2_PER_FORWARD,
                     "conv3x3_bias_act": 2 * n_chunks * K5A_PER_FORWARD,
                     "conv1x1_bias_act": 2 * n_chunks * K5B_PER_FORWARD})
    for name, p in out.items():
        check_peaks(name, dets[name][0], p, N_FRAMES, (3,) if name.endswith("ball") else (13, 3),
                    stride=4 if name.startswith("segformer") else 1)
    positions, idx, times = BallDetector.filter_trajectory(out["segformerpp_b2_ball"],
                                                           out["wasb_ball"], 30.0)
    table = TableDetector.filter_trajectory(out["segformerpp_b2_table"], out["hrnet_table"])
    if positions.shape != (len(idx), 2) or times.shape != idx.shape or table.shape != (13, 3):
        raise AssertionError("filter_trajectory returned bad shapes")
    # random weights make the two models of a pair disagree; a model always agrees with
    # itself: every frame kept (the ball is always visible, threshold -inf), and every
    # table keypoint seen in 3 or more frames is fused
    b2 = out["segformerpp_b2_ball"]
    _, self_idx, self_times = BallDetector.filter_trajectory(b2, b2, 30.0)
    kp = out["hrnet_table"]
    self_table = TableDetector.filter_trajectory(kp, kp)
    if (list(self_idx) != list(range(N_FRAMES)) or not np.allclose(self_times, self_idx / 30.0)
            or list(self_table[:, 2]) != list((kp[..., 2].sum(0) >= 3).astype(float))):
        raise AssertionError("filter_trajectory of a model with itself dropped detections")
    fps = {k: N_FRAMES / v for k, v in secs.items()}
    fps["four_detectors"] = N_FRAMES / sum(secs.values())
    log("detectors", frames=N_FRAMES, chunk=HR_CHUNK,
        frames_per_s=json.dumps({k: round(v, 3) for k, v in fps.items()}), launches=launches,
        ball_kept=len(idx), table_visible=int(table[:, 2].sum()),
        k5_routes=json.dumps(k5_routes(torch)))
    if launches != expected:
        raise AssertionError(f"main path launches {launches}, expected {expected}")

    # the main path's kernels at its batch (K1/K2 at 8 here, 4 in the k1/k2 phases):
    # each detector's heatmaps on its first chunk against its plain path in f32
    heat_err = {}
    for name, (det, items) in dets.items():
        tol = HEAT_TOL if name.startswith("segformer") else HRNET_HEAT_TOL
        heat_err[name] = plain_heat_err(torch, det, chunk_images(torch, items))
        if not heat_err[name] <= tol:
            raise AssertionError(f"{name}: heatmaps of the kernel path differ from the f32 "
                                 f"plain path: {heat_err[name]} > {tol}")
    log("detectors", heat_rel_err=json.dumps({k: round(v, 5) for k, v in heat_err.items()}))
    res = dict(frames_per_s=fps, seconds=secs, launches=launches, ball_kept=int(len(idx)),
               table_keypoints=table.tolist(), heat_rel_err=heat_err)
    if profile:
        chunk = {k: (d, items[:HR_CHUNK]) for k, (d, items) in dets.items()}
        res["profile"] = profile_calls(
            torch, lambda: [d.predict(items) for d, items in chunk.values()],
            "one warm chunk of 8 frames through the four detectors")
    return res


def check_peaks(name, det, pos, n, per_frame, stride=4):
    """Peaks finite, of shape (n, *per_frame), inside the frame up to the margin of the
    3x3 fit: 2 heatmap pixels beyond the argmax. The heatmap is at 1/stride of the
    model input (4 for SegFormer, 1 for the HRNets)."""
    import numpy as np

    from upliftingtabletennis_torch.pipeline.interface import HEIGHT, WIDTH

    if pos.shape != (n, *per_frame) or not np.isfinite(pos).all():
        raise AssertionError(f"{name}: bad peaks, shape {pos.shape}")
    MW, MH = det.resolution
    mx, my = 2 * WIDTH * stride / MW, 2 * HEIGHT * stride / MH
    x, y = pos[..., 0], pos[..., 1]
    if not ((x >= -mx) & (x <= WIDTH + mx) & (y >= -my) & (y <= HEIGHT + my)).all():
        raise AssertionError(f"{name}: peaks outside the {WIDTH}x{HEIGHT} frame")


def counted(torch, ops, fn, expected):
    """A main path: every launch count set to 0 just before `fn()` and read just after;
    fails unless they equal `expected` (0 for a kernel it does not name). Returns
    (fn's result, seconds, launches)."""
    for k in ops.ALL:
        getattr(ops, k).launches = 0
    t = time.time()
    out = fn()
    secs = time.time() - t
    launches = {k: getattr(ops, k).launches for k in ops.ALL}
    want = {k: expected.get(k, 0) for k in ops.ALL}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, expected {want}")
    return out, secs, launches


def drive(torch, ops, det, items, expected):
    """The main path of one detector, `det.predict(items)`, counted. Returns (peaks,
    seconds, launches)."""
    return counted(torch, ops, lambda: det.predict(items)[0], expected)


def chunk_images(torch, items):
    """The first chunk of `items` (tuples of frames) as one (chunk, H, W, 3 * n) uint8
    tensor on the card, the channels concatenated as `predict` does."""
    import numpy as np

    chunk = [it if isinstance(it, tuple) else (it,) for it in items[:HR_CHUNK]]
    return torch.cat([torch.from_numpy(np.stack([it[k] for it in chunk])).to(DEVICE)
                      for k in range(len(chunk[0]))], dim=-1)


def merge_partners(torch, plan):
    """Per source token (B, N): the index of the B token it merges into, or -1 where it
    keeps a slot of its own (every B token, and every A token that does not merge).
    Unlike `plan.dst`, this does not shift the slots of the later unmerged A tokens when
    one A token merges on one path and not on the other."""
    N = plan.dst.shape[1]
    base = plan.n_merged - N // 2  # the unmerged A tokens' slots come first
    partner = torch.where(plan.dst >= base, plan.dst - base, -1)
    partner[:, 1::2] = -1
    return partner


def tie_decided(torch, plan, val, idx, last):
    """(B, N) bool: the A tokens whose merge a tie decides, from the matching's row max
    `val`, first argmax `idx` and last argmax `last` (B, |A|): a merged token whose row
    max is reached at more than one B token, and every token whose max equals the r-th
    largest where that value also continues past the cut (stable sort: index order)."""
    B, N = plan.dst.shape
    r = N - plan.n_merged
    srt = val.sort(dim=-1, descending=True).values
    at_cut = torch.zeros_like(val, dtype=torch.bool)
    if 0 < r < val.shape[1]:
        at_cut = (val == srt[:, r - 1:r]) & (srt[:, r - 1:r] == srt[:, r:r + 1])
    merged = merge_partners(torch, plan)[:, 0::2] >= 0
    out = torch.zeros(B, N, dtype=torch.bool, device=val.device)
    out[:, 0::2] = at_cut | (merged & (idx != last))
    return out


@contextlib.contextmanager
def patched(module, **attrs):
    """Set attributes of `module` inside a with block, and restore them after it."""
    old = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(module, name, value)


def run_tome(torch, ops, frames, profile=False):
    from upliftingtabletennis_torch.data.image_transforms import normalize_image
    from upliftingtabletennis_torch.hub import ball_detection
    from upliftingtabletennis_torch.models import segformer
    from upliftingtabletennis_torch.ops import token_merge
    from upliftingtabletennis_torch.ops.flash_attention import cross_attention_plain
    from upliftingtabletennis_torch.ops.resize import resize_bilinear_down

    triples = [(frames[t], frames[t + 1], frames[t + 2]) for t in range(N_FRAMES)]
    det = ball_detection("segformerpp_b2", device=DEVICE, chunk=HR_CHUNK)
    det.predict(triples[:HR_CHUNK])  # the same detector without ToMe: its peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    det.predict(triples)
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = segformer.SegFormerNet(1, 3, "b2", tome_ratio=TOME_RATIO)
    model.load_state_dict(det.model.state_dict())
    det.model = model.eval().to(DEVICE, det.dtype)  # bf16 on the card
    det.predict(triples[:HR_CHUNK])  # warm-up
    torch.cuda.synchronize()

    n_chunks = N_FRAMES // HR_CHUNK
    torch.cuda.reset_peak_memory_stats()
    pos, secs, launches = drive(torch, ops, det, triples, {
        "flash_cross_attention": n_chunks * B2_PER_FORWARD,
        "fused_ln_ffn": n_chunks * B2_PER_FORWARD})  # and no K1: every block is merged
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_peaks("tome", det, pos, N_FRAMES, (3,))
    fps = N_FRAMES / secs
    log("tome", frames=N_FRAMES, chunk=HR_CHUNK, ratio=TOME_RATIO, frames_per_s=f"{fps:.3f}",
        predict_s=f"{secs:.3f}", launches=launches, k3_route=K3_ROUTE,
        peak_mem_gb=f"{peak_gb:.3f}",
        peak_mem_gb_without_tome=f"{plain_peak_gb:.3f}")

    # the checks: the ToMe model and a bf16 `kernels=False` copy on the first chunk's
    # model input, with spies on the merge plan, on its row max/argmax and on K3
    images = chunk_images(torch, triples)
    MW, MH = det.resolution
    x = normalize_image(resize_bilinear_down(images, MH, MW)).to(det.dtype)
    del images
    ref = segformer.SegFormerNet(1, 3, "b2", tome_ratio=TOME_RATIO, kernels=False)
    ref.load_state_dict(model.state_dict())
    ref.eval().to(DEVICE, det.dtype)
    real_k3, real_plan = segformer.flash_cross_attention, segformer.bipartite_soft_matching
    real_best = token_merge._best_match
    flip_equal = []

    def forward(net, replay=None, best=real_best, k3=real_k3, capture=None):
        """(heatmaps (B, 1, h, w) f32, the net's merge plans, per plan the (B, N) tokens
        whose merge a tie decides). replay: plans used in place of the net's own; best:
        the matching's row max and argmax; capture: a list that receives K3's (q, k, v)."""
        plans, tied, cur = [], [], {}

        def best_spy(a, b, rows):
            val, idx = best(a, b, rows)
            val_rev, rev = real_best(a, b.flip(1), rows)  # the last argmax: not the first if tied
            flip_equal.append(torch.equal(val_rev, val))  # the same products in another order
            cur.update(val=val, idx=idx, last=b.shape[1] - 1 - rev)
            return val, idx

        def plan_spy(metric, r):
            plan = replay[len(plans)] if replay is not None else real_plan(metric, r)
            if replay is None:
                tied.append(tie_decided(torch, plan, **cur))
            plans.append(plan)
            return plan

        def k3_spy(q, k, v, scale=None):
            if capture is not None:
                capture.append((q, k, v))
            return k3(q, k, v, scale)

        with patched(token_merge, _best_match=best_spy), patched(
                segformer, bipartite_soft_matching=plan_spy, flash_cross_attention=k3_spy):
            heat = net(x)[0].permute(0, 3, 1, 2).float()
        return heat, plans, tied

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def drop_chunk(t):  # keys 64..127 left out: a K3 that skips one chunk
        return torch.cat([t[:, :64], t[:, 128:]], 1)

    def far(a, b, rows):  # a wrong plan: every partner half of set B away from the best
        val, idx = real_best(a, b, rows)
        return val, (idx + b.shape[1] // 2) % b.shape[1]

    def last(a, b, rows):  # ties broken the other way: the last argmax of each row
        val, rev = real_best(a, b.flip(1), rows)
        return val, b.shape[1] - 1 - rev

    firsts = [sum(B2_STAGES[i][5] for i in range(s)) for s in range(4)]  # block 0 of each stage
    calls = []
    with torch.no_grad():
        heat, plans, tied = forward(model, capture=calls)
        # K3 held strictly: on the (q, k, v) it gets at the first block of each stage
        strict = []
        for i in firsts:
            q, k, v = calls[i]
            want = cross_attention_plain(q.float(), k.float(), v.float())
            max_abs, worst, ok = k3_check(torch, real_k3(q, k, v), q, k, v, want)
            # the same limit must reject a K3 that skips keys 64..127 on these tensors
            skipped = cross_attention_plain(q.float(), drop_chunk(k).float(),
                                            drop_chunk(v).float()).to(q.dtype)
            strict.append(dict(Nq=q.shape[1], heads=q.shape[2], max_abs_err=max_abs,
                               err_over_limit=worst, ok=ok,
                               chunk_fault_over_limit=k3_check(torch, skipped, q, k, v, want)[1]))
            del want, skipped
        calls.clear()
        heat_ref, plans_ref, tied_ref = forward(ref)  # the plain path with its own plans
        same_err = rel(heat, forward(ref, replay=plans)[0])  # ... with the kernel path's
        # planted faults in the kernel path, and how far each moves its heatmaps from the
        # plain path's (with the plain path's own plans; for the K3 fault also with the
        # faulty run's plans). A wrong plan must exceed TOME_HEAT_TOL. A K3 that skips
        # a key chunk stays within the heatmap limits: the strict check above sees it.
        fault_err = {"wrong_partner": rel(forward(model, best=far)[0], heat_ref),
                     "last_argmax": rel(forward(model, best=last)[0], heat_ref)}
        heat_drop, plans_drop, _ = forward(
            model, k3=lambda q, k, v, scale=None: real_k3(q, drop_chunk(k), drop_chunk(v), scale))
        fault_err["k3_chunk"] = rel(heat_drop, heat_ref)
        fault_err["k3_chunk_same_plans"] = rel(heat_drop, forward(ref, replay=plans_drop)[0])
        del heat_drop, plans_drop
    heat_err = rel(heat, heat_ref)
    differ = [merge_partners(torch, a) != merge_partners(torch, b) for a, b in zip(plans, plans_ref)]
    share = [d.float().mean().item() for d in differ]
    tie_share = [t.float().mean().item() for t in tied]
    n_differ = sum(d.sum().item() for d in differ)
    n_explained = sum((d & (t | u)).sum().item() for d, t, u in zip(differ, tied, tied_ref))
    explained = n_explained / max(1, n_differ)
    dst_share = sum(share) / len(share)
    log("tome", k3_strict=json.dumps([{k: (round(v, 5) if isinstance(v, float) else v)
                                       for k, v in e.items()} for e in strict]),
        heat_rel_err=f"{heat_err:.4g}", heat_rel_err_same_plans=f"{same_err:.4g}",
        heat_max_abs=f"{heat_ref.abs().max().item():.4g}",
        fault_heat_rel_err=json.dumps({k: round(v, 5) for k, v in fault_err.items()}),
        dst_differ_share=f"{dst_share:.5f}", differ_tie_decided_share=f"{explained:.5f}",
        dst_differ_per_block=json.dumps([round(d, 5) for d in share]),
        tie_decided_per_block=json.dumps([round(t, 5) for t in tie_share]),
        flip_values_equal=all(flip_equal))
    if not len(plans) == len(plans_ref) == TOME_PLANS_PER_FORWARD:
        raise AssertionError(f"merge plans per forward: {len(plans)} (kernels), "
                             f"{len(plans_ref)} (plain); expected {TOME_PLANS_PER_FORWARD}")
    if not all(e["ok"] for e in strict):
        raise AssertionError(f"K3 disagrees with its plain version on the model's tensors: "
                             f"{strict}")
    if not all(e["chunk_fault_over_limit"] > 1 for e in strict):
        raise AssertionError(f"K3's limit does not reject a skipped key chunk on the model's "
                             f"tensors: {strict}")
    if not heat_err <= TOME_HEAT_TOL:
        raise AssertionError(f"ToMe heatmaps of the kernel path differ from the bf16 plain "
                             f"path: {heat_err} > {TOME_HEAT_TOL}")
    if not same_err <= HEAT_TOL:
        raise AssertionError(f"ToMe heatmaps of the kernel path differ from the bf16 plain "
                             f"path on the same plans: {same_err} > {HEAT_TOL}")
    if not fault_err["wrong_partner"] > TOME_HEAT_TOL:
        raise AssertionError(f"a wrong merge plan passes TOME_HEAT_TOL: {fault_err}")
    res = dict(frames_per_s=fps, predict_s=secs, launches=launches, k3_route=K3_ROUTE,
               peak_mem_gb=peak_gb, peak_mem_gb_without_tome=plain_peak_gb, k3_strict=strict,
               heat_rel_err=heat_err,
               heat_rel_err_same_plans=same_err, fault_heat_rel_err=fault_err,
               dst_differ_share=dst_share, dst_differ_per_block=share,
               differ_tie_decided_share=explained, tie_decided_per_block=tie_share,
               flip_values_equal=all(flip_equal))
    del ref, heat, heat_ref, x, plans, plans_ref, tied, tied_ref, differ
    if profile:
        res["profile"] = profile_calls(torch, lambda: det.predict(triples[:HR_CHUNK]),
                                       "one warm b2 ToMe ball predict of 8 triplets")
    del det, model
    torch.cuda.empty_cache()
    return res


def run_flip(torch, ops, frames):
    from upliftingtabletennis_torch.hub import ball_detection

    triples = [(frames[t], frames[t + 1], frames[t + 2]) for t in range(N_FRAMES)]
    det = ball_detection("segformerpp_b2", device=DEVICE, chunk=HR_CHUNK, flip_test=True)
    det.predict(triples[:HR_CHUNK])  # warm-up
    torch.cuda.synchronize()
    n = 2 * (N_FRAMES // HR_CHUNK) * B2_PER_FORWARD  # two forwards per chunk
    pos, secs, launches = drive(torch, ops, det, triples,
                                {"fused_attention_block": n, "fused_ln_ffn": n})
    check_peaks("flip", det, pos, N_FRAMES, (3,))
    err = plain_heat_err(torch, det, chunk_images(torch, triples))
    fps = N_FRAMES / secs
    log("flip", frames=N_FRAMES, chunk=HR_CHUNK, frames_per_s=f"{fps:.3f}",
        predict_s=f"{secs:.3f}", launches=launches, heat_rel_err=f"{err:.4g}")
    if not err <= HEAT_TOL:
        raise AssertionError(f"flip-test heatmaps of the kernel path differ from the f32 "
                             f"plain path: {err} > {HEAT_TOL}")
    del det
    torch.cuda.empty_cache()
    return dict(frames_per_s=fps, predict_s=secs, launches=launches, heat_rel_err=err)


def run_b0(torch, ops, frames):
    from upliftingtabletennis_torch.hub import table_detection

    centres = [frames[t + 1] for t in range(N_FRAMES)]
    det = table_detection("segformerpp_b0", device=DEVICE, chunk=HR_CHUNK)
    det.predict(centres[:HR_CHUNK])  # warm-up
    torch.cuda.synchronize()
    n = (N_FRAMES // HR_CHUNK) * B0_PER_FORWARD
    pos, secs, launches = drive(torch, ops, det, centres,
                                {"fused_attention_block": n, "fused_ln_ffn": n})
    check_peaks("b0", det, pos, N_FRAMES, (13, 3))
    err = plain_heat_err(torch, det, chunk_images(torch, centres))
    fps = N_FRAMES / secs
    log("b0", model="segformerpp_b0 table", frames=N_FRAMES, chunk=HR_CHUNK,
        frames_per_s=f"{fps:.3f}", predict_s=f"{secs:.3f}", launches=launches,
        heat_rel_err=f"{err:.4g}")
    if not err <= HEAT_TOL:
        raise AssertionError(f"b0 table heatmaps of the kernel path differ from the f32 plain "
                             f"path: {err} > {HEAT_TOL}")
    del det
    torch.cuda.empty_cache()
    return dict(frames_per_s=fps, predict_s=secs, launches=launches, heat_rel_err=err)


def run_vitpose(torch, ops, frames, profile=False):
    from upliftingtabletennis_torch.hub import ball_detection, table_detection
    from upliftingtabletennis_torch.ops.heatmap_decode import keypoints_from_heatmaps

    triples = [(frames[t], frames[t + 1], frames[t + 2]) for t in range(N_FRAMES)]
    centres = [frames[t + 1] for t in range(N_FRAMES)]
    dets = {"vitpose_ball": (ball_detection("vitpose", device=DEVICE, chunk=HR_CHUNK), triples,
                             (3,)),
            "vitpose_table": (table_detection("vitpose", device=DEVICE, chunk=HR_CHUNK), centres,
                              (13, 3))}
    res = {}
    for name, (det, items, per_frame) in dets.items():
        if det.resolution != VIT_RES:
            raise AssertionError(f"{name}: resolution {det.resolution}, expected {VIT_RES}")
        det.predict(items[:HR_CHUNK])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pos, secs, launches = drive(torch, ops, det, items, {})  # no port kernel on this path
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check_peaks(name, det, pos, N_FRAMES, per_frame)
        rates = []
        for _ in range(VIT_RATE_CALLS):  # predict returns numpy peaks: it waits for the card
            t = time.time()
            det.predict(items * VIT_RATE_ITEMS)
            rates.append(N_FRAMES * VIT_RATE_ITEMS / (time.time() - t))
        fps = statistics.median(rates)
        images = chunk_images(torch, items)
        err = plain_heat_err(torch, det, images)
        r = dict(frames_per_s=fps, frames_per_s_range=[min(rates), max(rates)],
                 frames_per_s_calls=rates, predict_s=secs, launches=launches,
                 peak_mem_gb=peak_gb, heat_rel_err=err)
        if name == "vitpose_table":  # the decoder on the card against its CPU copy
            with torch.no_grad():
                heat = det.heatmaps(images)
            r["keypoints_max_px_err"] = {}
            for mode in ("default", "unbiased"):
                c, m = keypoints_from_heatmaps(heat, mode)
                c_cpu, m_cpu = keypoints_from_heatmaps(heat.cpu(), mode)
                r["keypoints_max_px_err"][mode] = (c.cpu() - c_cpu).abs().max().item()
                if not (torch.equal(m.cpu(), m_cpu) and r["keypoints_max_px_err"][mode] <= KP_TOL_PX):
                    raise AssertionError(f"keypoints_from_heatmaps ({mode}) on the card differs "
                                         f"from its CPU copy: {r['keypoints_max_px_err']}")
            del heat
        log("vitpose", model=name, frames=N_FRAMES, chunk=HR_CHUNK, frames_per_s=f"{fps:.3f}",
            frames_per_s_range=f"{min(rates):.3f}-{max(rates):.3f}",
            frames_per_s_of=f"median of {VIT_RATE_CALLS} calls x {N_FRAMES * VIT_RATE_ITEMS} "
                            "frames", predict_s=f"{secs:.3f}", launches=launches, peak_mem_gb=f"{peak_gb:.3f}",
            heat_rel_err=f"{err:.4g}", **({"keypoints_max_px_err": json.dumps(
                r["keypoints_max_px_err"])} if "keypoints_max_px_err" in r else {}))
        if not err <= VIT_HEAT_TOL:
            raise AssertionError(f"{name}: heatmaps of the bf16 path differ from the f32 copy: "
                                 f"{err} > {VIT_HEAT_TOL}")
        if profile:
            r["profile"] = profile_calls(
                torch, lambda: det.predict(items[:HR_CHUNK]),
                f"one warm {name} predict of one chunk of 8",
                categories={"sdpa": "aten::scaled_dot_product_attention",
                            "linears": "aten::linear",
                            "deconvolutions": "aten::conv_transpose2d"})
        res[name] = r
        del det, images
        dets[name] = None
        torch.cuda.empty_cache()
    return res


def k4_bound(B, H, W, C):
    """(ms, bound_by) for K4's forward: x read once, the output written once (bf16); 18 f32
    operations per element."""
    nbytes = 2 * (2 * B * H * W * C + 10 * C)
    flops = 18 * B * H * W * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k4_bwd_bound(B, H, W, C):
    """(ms, bound_by) for K4's backward: g and x read once, dx written once (bf16), the taps
    read and dw and db written once; 38 f32 operations per element (dx's 9 and dw's 9
    multiply-adds, db's add)."""
    nbytes = 2 * (3 * B * H * W * C + 9 * C) + 4 * 10 * C
    flops = 38 * B * H * W * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k4_sums_ok(torch, got, want):
    """(max abs err, ok) of dw or db against the f32 plain version at K4's sum limit."""
    err = (got.float() - want).abs()
    limit = K4_SUM_ATOL * want.abs().max() + K4_SUM_RTOL * want.abs()
    return err.max().item(), bool((err <= limit).all())


def k4_faults(torch, x, w, b, g, plans):
    """K4's planted faults, simulated with the plain versions (f32) and rounded as the
    kernels round: {name: (tensor, what it stands for)}. `plans` are the forward's and the
    backward's `dwconv_plan`s; a fault needs a seam (two tiles) along its axis."""
    from upliftingtabletennis_torch.ops.dwconv import TILE_C, TILE_W, dwconv3x3_plain

    B, H, W, C = x.shape
    fwd, bwd = plans
    zero = torch.zeros(C, device=x.device)
    xf, gf = x.float(), g.float()
    out = {"unflipped_dx": (dwconv3x3_plain(gf, w.float(), zero).to(torch.bfloat16), "dx")}
    if fwd.tiles_h > 1:  # the halo rows between the forward's row tiles dropped
        out["halo_rows_dropped"] = (torch.cat(
            [dwconv3x3_plain(xf[:, i:i + fwd.rows], w.float(), b.float())
             for i in range(0, H, fwd.rows)], 1).to(torch.bfloat16), "out")

    def sums(gm):  # dw and db of the cotangent gm, f32
        xp = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))
        dw = torch.stack([torch.stack([(gm[j] * xp[:, i:i + H, j:j + W]).sum((0, 1, 2))
                                       for j in range(3)]) for i in range(3)])
        return dw, gm[1].sum((0, 1, 2))

    # one block's partial sum left out: a block near the middle of sample 0, channel group 0
    th, tw, cg = bwd.tiles_h // 2, bwd.tiles_w // 2, TILE_C[True]
    gm = gf.clone()
    gm[0, th * bwd.rows:(th + 1) * bwd.rows, tw * TILE_W:(tw + 1) * TILE_W, :cg] = 0
    dw, db = sums([gm] * 3)
    out["partial_left_out_dw"] = (dw.to(torch.bfloat16), "dw")
    out["partial_left_out_db"] = (db.to(torch.bfloat16), "db")
    if bwd.tiles_w > 1:  # dw without the halo columns at the tile seams: tap column 0 misses
        # the x column left of each tile's first column, tap column 2 the one right of its last
        col = torch.arange(W, device=x.device) % TILE_W
        left, right = gf * (col != 0)[:, None], gf * (col != TILE_W - 1)[:, None]
        out["halo_column_dropped_dw"] = (sums([left, gf, right])[0].to(torch.bfloat16), "dw")
    return out


def run_k4(torch, F, ops, gen):
    from upliftingtabletennis_torch.ops import dwconv as k4

    fwd_entries, bwd_entries = [], []
    for B, H, W, C, depth in K4_SHAPES + [K4_RAGGED]:
        def rnd(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device=DEVICE) * std).to(torch.bfloat16)

        x, w, b, g = rnd(B, H, W, C), rnd(3, 3, C, std=1 / 3), rnd(C, std=0.1), rnd(B, H, W, C)
        plans = (k4.dwconv_plan(B, H, W, C), k4.dwconv_plan(B, H, W, C, backward=True))

        def kernel():
            return ops.depthwise_conv3x3(x, w, b)

        def plain():
            return k4.dwconv3x3_plain(x.float(), w.float(), b.float())

        def backward():
            return ops.dwconv3x3_backward(x, w, g)

        def backward_plain():
            return k4.dwconv3x3_backward_plain(x.float(), w.float(), g.float())

        got = kernel()
        # the backward as the trainer reaches it: through the autograd Function
        xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
        ops.depthwise_conv3x3(xg, wg, bg).backward(g)
        # dw and db before their rounding to w's dtype, from two calls
        sums = [k4._launch_backward(x, k4._dx_taps(w), g) for _ in range(2)]
        torch.cuda.synchronize()
        want = plain()
        dx_want, dw_want, db_want = backward_plain()
        fwd_abs, _, fwd_ok = compare(torch, got, want, K5_ATOL, K5_RTOL)
        dx_abs, _, dx_ok = compare(torch, xg.grad, dx_want, K5_ATOL, K5_RTOL)
        dw_abs, dw_ok = k4_sums_ok(torch, wg.grad, dw_want)
        db_abs, db_ok = k4_sums_ok(torch, bg.grad, db_want)
        repeat = all(torch.equal(a, c) for a, c in zip(*sums))
        refs = {"out": want, "dx": dx_want, "dw": dw_want, "db": db_want}
        caught = {}
        for name, (bad, what) in k4_faults(torch, x, w, b, g, plans).items():
            caught[name] = not (k4_sums_ok(torch, bad, refs[what])[1] if what in ("dw", "db")
                                else compare(torch, bad, refs[what], K5_ATOL, K5_RTOL)[2])
        del want, dx_want, xg, sums
        w_conv = w.permute(2, 0, 1).unsqueeze(1).contiguous()
        x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # NHWC: channels_last views

        def library():
            return F.conv2d(x_cl, w_conv, b, padding=1, groups=C)

        def library_backward():
            return torch.ops.aten.convolution_backward(
                g_cl, x_cl, w_conv, [C], (1, 1), (1, 1), (1, 1), False, (0, 0), C,
                [True, True, True])

        lib_err = (library().permute(0, 2, 3, 1).float() - got.float()).abs().max().item()
        lib_dw = library_backward()[1][:, 0].permute(1, 2, 0).float()
        lib_dw_err = (lib_dw - dw_want).abs().max().item()
        ms, plain_ms, lib_ms = time_ms(torch, kernel), time_ms(torch, plain, iters=5), \
            time_ms(torch, library)
        bwd_ms, bwd_plain_ms, bwd_lib_ms = time_ms(torch, backward), \
            time_ms(torch, backward_plain, iters=5), time_ms(torch, library_backward)
        piped = {k: pipelined_ms(torch, f) for k, f in (("fwd", kernel), ("fwd_lib", library),
                                                        ("bwd", backward),
                                                        ("bwd_lib", library_backward))}
        host_us = {k: host_us_per_call(torch, f) for k, f in (("fwd", kernel), ("bwd", backward))}
        bound_ms, bound_by = k4_bound(B, H, W, C)
        bwd_bound_ms, bwd_bound_by = k4_bwd_bound(B, H, W, C)
        shape = dict(B=B, H=H, W=W, C=C)
        fwd_entries.append(dict(
            shape=shape, depth=depth, plan=plans[0]._asdict(), ms=ms, host_us=host_us["fwd"],
            ms_pipelined=piped["fwd"], plain_ms=plain_ms, library_ms=lib_ms,
            library_ms_pipelined=piped["fwd_lib"], bound_ms=bound_ms, bound_by=bound_by,
            max_abs_err=fwd_abs, library_vs_kernel_max_abs=lib_err))
        bwd_entries.append(dict(
            shape=shape, depth=depth, plan=plans[1]._asdict(), ms=bwd_ms,
            host_us=host_us["bwd"], ms_pipelined=piped["bwd"], plain_ms=bwd_plain_ms,
            library_ms=bwd_lib_ms,
            library_ms_pipelined=piped["bwd_lib"], bound_ms=bwd_bound_ms,
            bound_by=bwd_bound_by, max_abs_err=max(dx_abs, dw_abs, db_abs),
            dx_max_abs_err=dx_abs, dw_max_abs_err=dw_abs, db_max_abs_err=db_abs,
            dw_db_repeat_bitwise=repeat, faults_caught=caught,
            library_dw_vs_plain_max_abs=lib_dw_err))
        ok = fwd_ok and dx_ok and dw_ok and db_ok
        log("k4", B=B, H=H, W=W, C=C, fwd_max_abs_err=f"{fwd_abs:.4g}",
            dx_max_abs_err=f"{dx_abs:.4g}", dw_max_abs_err=f"{dw_abs:.4g}",
            db_max_abs_err=f"{db_abs:.4g}", repeat_bitwise=repeat, ms=f"{ms:.4f}",
            host_us=f"{host_us['fwd']:.1f}", bwd_host_us=f"{host_us['bwd']:.1f}",
            ms_pipelined=f"{piped['fwd']:.4f}", conv2d_ms=f"{lib_ms:.4f}",
            conv2d_ms_pipelined=f"{piped['fwd_lib']:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bwd_ms=f"{bwd_ms:.4f}",
            bwd_ms_pipelined=f"{piped['bwd']:.4f}", conv_backward_ms=f"{bwd_lib_ms:.4f}",
            conv_backward_ms_pipelined=f"{piped['bwd_lib']:.4f}",
            bwd_plain_ms=f"{bwd_plain_ms:.4f}", bwd_bound_ms=f"{bwd_bound_ms:.4f}",
            rows=f"{plans[0].rows}/{plans[1].rows}", faults_caught=json.dumps(caught), ok=ok)
        if not ok:
            raise AssertionError(f"K4 disagrees with its plain version at {(B, H, W, C)}: "
                                 f"forward {fwd_abs}, dx {dx_abs}, dw {dw_abs}, db {db_abs}")
        if not repeat:
            raise AssertionError(f"K4's backward does not repeat bit for bit at {(B, H, W, C)}")
        if not all(caught.values()):
            raise AssertionError(f"K4's limits do not reject a planted fault at "
                                 f"{(B, H, W, C)}: {caught}")
        del x, g, got
    torch.cuda.empty_cache()
    return fwd_entries, bwd_entries


def grad_limit_ratios(errs, noise):
    """{name: err / limit}, limit = max(TRAIN_GRAD_REL, TRAIN_GRAD_NOISE * the bf16 plain
    path's err): above 1 fails."""
    return {n: e / max(TRAIN_GRAD_REL, TRAIN_GRAD_NOISE * noise[n]) for n, e in errs.items()}


def grad_rel_errors(torch, names, got, want):
    """{name: ||got - want|| / ||want||} over the parameters whose gradient is not zero in
    exact arithmetic, and the largest norm of `got` and of `want` over ZERO_GRAD, each over
    the largest gradient norm of `want`."""
    top = max(b.norm().item() for b in want)
    errs, zero = {}, [0.0, 0.0]
    for n, a, b in zip(names, got, want):
        if n in ZERO_GRAD:
            zero = [max(zero[0], a.float().norm().item() / top), max(zero[1], b.norm().item() / top)]
        else:
            errs[n] = ((a.float() - b).norm() / b.norm()).item()
    return errs, zero


def tiny_tthq(root, n_frames=8, hw=(180, 320)):
    """A TTHQ layout of two videos of synthetic frames (a bright blob on texture), written as
    PNGs, with ball and table (13 random keypoints) labels: video 1 is the val/test pool,
    video 2 trains."""
    import numpy as np

    from upliftingtabletennis_torch.data.png import write_png

    H, W = hw
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:H, 0:W]
    rows = ["video;frame;ball_x;ball_y;ball_flag"]
    table_rows = ["video;frame;" + ";".join(f"point_{k}_x;point_{k}_y;point_{k}_flag"
                                            for k in range(1, 14))]
    for video in (1, 2):
        os.makedirs(os.path.join(root, "tthq", f"{video:02d}"))
        for f in range(n_frames):
            bx, by = rng.uniform(20, W - 20), rng.uniform(20, H - 20)
            img = 80 + 30 * np.sin(xx / 9.0)[..., None] + rng.normal(0, 8, (H, W, 3))
            img += 170 * np.exp(-((xx - bx) ** 2 + (yy - by) ** 2) / 18.0)[..., None]
            write_png(os.path.join(root, "tthq", f"{video:02d}", f"{video:02d}_{f:06d}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
            if 1 <= f < n_frames - 1:
                rows.append(f"{video};{f};{bx:.2f};{by:.2f};2")
                table_rows.append(f"{video};{f};" + ";".join(
                    f"{rng.uniform(5, W - 5):.2f};{rng.uniform(5, H - 5):.2f};2"
                    for _ in range(13)))
    with open(os.path.join(root, "tthq", "ball_detection.csv"), "w") as fh:
        fh.write("\n".join(rows))
    with open(os.path.join(root, "tthq", "table_detection.csv"), "w") as fh:
        fh.write("\n".join(table_rows))


def tiny_blurball(root, videos=((1, 10), (3, 10)), hw=(180, 320), invisible=(), seed=1):
    """A BlurBall layout (`data/detection.py`) of synthetic frames written as PNGs: for each
    (video, n_frames) one sequence 000 of n frames (a bright streak on texture), its CSV
    (Frame, X, Y, l, theta, Visibility; the frames in `invisible` annotated invisible) and
    a table calibration (rvec, tvec, f) that puts the table in view. Video 3 is in the
    val/test pool, video 1 trains."""
    import numpy as np

    from upliftingtabletennis_torch.data.png import write_png

    H, W = hw
    rng = np.random.default_rng(seed)
    r = max(2, W // 150)  # the blob's radius
    oy, ox = np.mgrid[-3 * r:3 * r + 1, -3 * r:3 * r + 1]
    blob = (170 * np.exp(-(ox ** 2 + oy ** 2) / (2.0 * r * r)))[..., None]
    ann = os.path.join(root, "blurball", "all_csv_annotations")
    calib = os.path.join(root, "blurball", "all_calib_files")
    os.makedirs(ann, exist_ok=True)
    os.makedirs(calib, exist_ok=True)
    for vid, n_frames in videos:
        seq = os.path.join(root, "blurball", f"{vid:02d}", "frames", "000")
        os.makedirs(seq, exist_ok=True)
        rows = ["Frame,X,Y,l,theta,Visibility"]
        texture = 80 + 30 * np.sin(np.arange(W + n_frames) / 9.0 + vid)
        texture = texture[None, :, None] + 20 * np.sin(np.arange(H) / 13.0)[:, None, None]
        texture = np.repeat(texture, 3, axis=2).astype(np.uint8)
        for f in range(n_frames):
            bx = int(rng.integers(3 * r, W - 3 * r))
            by = int(rng.integers(3 * r, H - 3 * r))
            length, theta = rng.uniform(1, 0.02 * W), rng.uniform(-90, 90)
            img = np.ascontiguousarray(texture[:, f:f + W])
            patch = img[by - 3 * r:by + 3 * r + 1, bx - 3 * r:bx + 3 * r + 1]
            patch[:] = np.clip(patch + blob, 0, 255).astype(np.uint8)
            write_png(os.path.join(seq, f"{f:05d}.png"), img)
            rows.append(f"{f},{bx},{by},{length:.3f},{theta:.2f},{0 if f in invisible else 1}")
        with open(os.path.join(ann, f"{vid:02d}_csv_000.csv"), "w") as fh:
            fh.write("\n".join(rows))
        with open(os.path.join(calib, f"{vid:02d}_table_pose.yaml"), "w") as fh:
            fh.write(f"rvec: [1.2, 0.0, 0.0]\ntvec: [0.0, 0.5, 5.0]\nf: {0.9 * W:.1f}\n")


def project_np(Mint, Mext, pts3d):
    """Pixels (N, 2) of world points (N, 3) through a camera, numpy float64."""
    import numpy as np

    p = np.concatenate([pts3d, np.ones((len(pts3d), 1))], -1) @ np.asarray(Mext).T
    q = (p[:, :3] / p[:, 3:4]) @ np.asarray(Mint).T
    return q[:, :2] / q[:, 2:3]


def raw_ttst(root, Mint, Mext, n_events=2, jitter=0.5, seed=0):
    """Raw TTST annotations of one video (`01_keypoints.csv`, `01_events.csv`: sep ';',
    the header on the second line) through a known camera: n_events spin-annotated events
    (Begin, Frontspin or Backspin, Bounce, End over 20 frames, the ball annotated on all
    but the eighth, the 13 table points on every second frame with +-jitter px) and one
    event without a spin annotation, which the extraction drops. Returns the noise-free
    table pixels (13, 2)."""
    import numpy as np

    from upliftingtabletennis_torch.core.geometry import TABLE_POINTS

    rng = np.random.default_rng(seed)
    table_px = project_np(Mint, Mext, np.asarray(TABLE_POINTS, np.float64))
    t = np.arange(20) / 50.0
    events = ["junk line to skip", "frame;event"]
    rows = ["junk line to skip", "frame;ball_x;ball_y;ball_flag;" + ";".join(
        f"{p:02}_x;{p:02}_y;{p:02}_flag" for p in range(1, 14))]
    for k in range(n_events + 1):
        start = 100 + 40 * k
        ball3d = np.stack([-1.2 + 3.0 * t, 0.2 - 0.3 * t + 0.1 * k,
                           1.1 - 2.0 * t + 4.0 * t ** 2], -1)
        ball_px = project_np(Mint, Mext, ball3d)
        spin = [f"{start + 3};{'Frontspin' if k % 2 == 0 else 'Backspin'}"] if k < n_events else []
        events += [f"{start};Begin", *spin, f"{start + 8};Bounce", f"{start + 19};End"]
        for i in range(25):
            annotated = i < 20 and i != 7
            ball = (f"{ball_px[i][0]:.2f};{ball_px[i][1]:.2f};2" if annotated else "-1;-1;0")
            cells = [f"{x + dx:.2f};{y + dy:.2f};2" for (x, y), (dx, dy) in
                     zip(table_px, rng.uniform(-jitter, jitter, (13, 2)))] if i % 2 == 0 else \
                ["-1;-1;0"] * 13
            rows.append(f"{start + i};{ball};" + ";".join(cells))
    with open(os.path.join(root, "01_keypoints.csv"), "w") as f:
        f.write("\n".join(rows))
    with open(os.path.join(root, "01_events.csv"), "w") as f:
        f.write("\n".join(events))
    return table_px


def run_train(torch, ops, frames, profile=False):
    import glob
    import tempfile

    import numpy as np

    from upliftingtabletennis_torch.data.image_transforms import (ImageAugmentConfig,
                                                                 augment_detection_batch)
    from upliftingtabletennis_torch.eval.metrics import render_gaussian_heatmaps
    from upliftingtabletennis_torch.hub import ball_detection
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.ops import dwconv
    from upliftingtabletennis_torch.pipeline.interface import init_weights
    from upliftingtabletennis_torch.train import run_detection as T

    B = TRAIN_BATCH
    images = torch.from_numpy(np.stack([np.concatenate(frames[t:t + 3], -1) for t in range(B)]))
    images = images.to(DEVICE).float()
    # the blob's centre in the middle frame of each triplet (synthetic_frames), 3 rows
    # (centre, streak min, streak max) as TTHQ annotates it
    coords = torch.tensor([[[300 + 140 * (t + 1), 700 - 45 * (t + 1)]] * 3 for t in range(B)],
                          dtype=torch.float32, device=DEVICE)
    vis = torch.ones(B, 3, device=DEVICE)
    model, _ = get_detector("segformerpp_b2", "ball", train=True)
    init_weights(model, 0)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    model.to(DEVICE)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    gen = torch.Generator().manual_seed(0)
    cfg = ImageAugmentConfig()
    imgs, c_model, v = augment_detection_batch(gen, images, coords, vis, TRAIN_RES, cfg, True)
    target = render_gaussian_heatmaps(T.eval_coords(c_model, TRAIN_RES, EVAL_RES)[:, :1],
                                      v[:, :1], EVAL_RES[1], EVAL_RES[0])
    x = imgs.to(torch.bfloat16)
    del imgs

    def grads_of(net, inp, outs=None):
        """The loss and the parameters' gradients; `outs` collects every MiTBlock's
        output and the heatmap (f32) of the forward."""
        hooks = []
        if outs is not None:
            mods = [(n, m) for n, m in net.backbone.named_children() if "block" in n]
            for n, m in mods + [("heat", net.decode_head)]:
                hooks.append(m.register_forward_hook(
                    lambda mod, a, o, n=n: outs.__setitem__(n, o.detach().float())))
        try:
            loss, _ = T.loss_fn(net, inp, target)
        finally:
            for h in hooks:
                h.remove()
        return loss.item(), torch.autograd.grad(loss, list(net.parameters()))

    # (a) the kernel path against the f32 plain path on the same batch; the plain path
    # in bf16 measures what bf16 alone costs
    acts_k, acts_b, acts_p = {}, {}, {}
    loss_k, g_k = grads_of(model, x, acts_k)
    ref, _ = get_detector("segformerpp_b2", "ball", train=True, kernels=False)
    ref.load_state_dict(state0)
    ref.to(DEVICE)
    loss_b, g_b = grads_of(ref, x, acts_b)
    loss_p, g_p = grads_of(ref, x.float(), acts_p)
    del ref

    def act_err(acts):  # per block output and heatmap: max |a - f32| / max |f32|
        return {n: ((a - acts_p[n]).abs().max() / acts_p[n].abs().max()).item()
                for n, a in acts.items()}

    fwd_k, fwd_b = act_err(acts_k), act_err(acts_b)
    del acts_k, acts_b, acts_p
    torch.cuda.empty_cache()
    errs, zero = grad_rel_errors(torch, names, g_k, g_p)
    noise, zero_b = grad_rel_errors(torch, names, g_b, g_p)
    del g_k, g_b
    with patched(dwconv, _dx_taps=lambda w: w):  # the planted fault: dx with unflipped taps
        _, g_f = grads_of(model, x)
    fault_errs, _ = grad_rel_errors(torch, names, g_f, g_p)
    del g_f, g_p
    torch.cuda.empty_cache()
    ratios = grad_limit_ratios(errs, noise)
    fault_ratios = grad_limit_ratios(fault_errs, noise)
    worst, worst_ratio = max(errs, key=errs.get), max(ratios, key=ratios.get)
    fault_worst = max(fault_ratios, key=fault_ratios.get)
    loss_rel, loss_rel_b = abs(loss_k - loss_p) / abs(loss_p), abs(loss_b - loss_p) / abs(loss_p)
    over = sum(e > TRAIN_GRAD_REL for e in errs.values())
    log("train", step="a", loss_kernel=f"{loss_k:.6g}", loss_plain_bf16=f"{loss_b:.6g}",
        loss_plain=f"{loss_p:.6g}", loss_rel_err=f"{loss_rel:.3g}",
        loss_rel_err_plain_bf16=f"{loss_rel_b:.3g}", worst_grad=worst,
        worst_grad_rel_err=f"{errs[worst]:.4g}", its_plain_bf16_err=f"{noise[worst]:.4g}",
        tensors_over_5e_2=f"{over}/{len(errs)}", worst_over_limit=worst_ratio,
        worst_err_over_limit=f"{ratios[worst_ratio]:.4g}",
        zero_grad_norms=json.dumps([round(z, 8) for z in zero + zero_b]),
        fault_worst=fault_worst, fault_err_over_limit=f"{fault_ratios[fault_worst]:.4g}",
        heat_rel_err=f"{fwd_k['heat']:.4g}", heat_rel_err_plain_bf16=f"{fwd_b['heat']:.4g}",
        block_rel_err_max=f"{max(v for n, v in fwd_k.items() if n != 'heat'):.4g}",
        block_rel_err_max_plain_bf16=f"{max(v for n, v in fwd_b.items() if n != 'heat'):.4g}")
    if not fwd_k["heat"] <= HEAT_TOL:
        raise AssertionError(f"the training forward's heatmaps differ from the f32 plain "
                             f"path: {fwd_k['heat']} > {HEAT_TOL}")
    if not loss_rel <= TRAIN_LOSS_RTOL or not ratios[worst_ratio] <= 1:
        raise AssertionError(f"one b2 training step of the kernel path differs from the f32 "
                             f"plain path: loss {loss_rel}, gradient of {worst_ratio} "
                             f"{errs[worst_ratio]} (bf16 plain {noise[worst_ratio]})")
    if not max(zero + zero_b) <= ZERO_GRAD_REL:
        raise AssertionError(f"gradients that are zero in exact arithmetic are not: {zero}")
    if not fault_ratios[fault_worst] > 1:
        raise AssertionError(f"the gradient limit does not see dx with unflipped taps: "
                             f"{fault_ratios[fault_worst]}")

    # (b) the main path: one train_step of the trainer, counts reset just before
    opt = T.init_adam(params)
    ema = [p.detach().clone() for p in params]
    for k in ops.ALL:
        getattr(ops, k).launches = 0
    torch.cuda.synchronize()
    t = time.time()
    T.train_step(model, params, opt, ema, gen, images, coords, vis, TRAIN_RES, EVAL_RES, cfg,
                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    first_step_s = time.time() - t
    launches = {k: getattr(ops, k).launches for k in ops.ALL}
    want = {k: 0 for k in ops.ALL}
    want.update(fused_attention_block=B2_PER_FORWARD, fused_ln_ffn=B2_PER_FORWARD,
                depthwise_conv3x3=B2_PER_FORWARD, dwconv3x3_backward=2 * B2_PER_FORWARD)
    log("train", step="b", launches=json.dumps(launches), first_step_s=f"{first_step_s:.3f}")
    if launches != want:
        raise AssertionError(f"a b2 training step launched {launches}, expected {want}")

    # (c), (d) ten steps on one fixed batch: the loss falls; time per step, memory
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t = time.time()
        loss, _ = T.loss_fn(model, x, target)
        T.apply_update(params, torch.autograd.grad(loss, params), opt, ema)
        losses.append(loss.item())  # waits for the step's kernels
        step_ms.append(1e3 * (time.time() - t))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(step_ms[1:])
    aug_ms = time_ms(torch, lambda: augment_detection_batch(gen, images, coords, vis, TRAIN_RES,
                                                            cfg, True), iters=5, warmup=1)
    res = dict(loss_kernel=loss_k, loss_plain_bf16=loss_b, loss_plain=loss_p,
               loss_rel_err=loss_rel, loss_rel_err_plain_bf16=loss_rel_b, grad_rel_err=errs,
               grad_rel_err_plain_bf16=noise, worst_grad=worst, worst_over_limit=worst_ratio,
               worst_err_over_limit=ratios[worst_ratio], zero_grad_norms=zero + zero_b,
               fault_worst=fault_worst, fault_err_over_limit=fault_ratios[fault_worst],
               forward_rel_err=fwd_k, forward_rel_err_plain_bf16=fwd_b,
               launches=launches, first_step_s=first_step_s, losses=losses, step_ms=step_ms,
               ms_per_step=ms, images_per_s=1e3 * B / ms, peak_mem_gb=peak_gb,
               augment_ms=aug_ms)
    log("train", step="cd", losses=json.dumps([round(v, 5) for v in losses]),
        ms_per_step=f"{ms:.2f}", step_ms_range=f"{min(step_ms[1:]):.2f}-{max(step_ms[1:]):.2f}",
        images_per_s=f"{res['images_per_s']:.3f}", peak_mem_gb=f"{peak_gb:.3f}",
        augment_ms=f"{aug_ms:.3f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"ten steps on one batch did not lower the loss: {losses}")
    if profile:
        def step():
            loss, _ = T.loss_fn(model, x, target)
            T.apply_update(params, torch.autograd.grad(loss, params), opt, ema)

        res["profile"] = profile_calls(
            torch, step, "one warm b2 training step (batch 4, 1600x896)",
            categories={"k1_backward": "autograd::engine::evaluate_function: "
                                       "_FusedAttentionBlockBackward",
                        "k2_backward": "autograd::engine::evaluate_function: _FusedLnFfnBackward",
                        "k4_backward": "autograd::engine::evaluate_function: "
                                       "_DepthwiseConv3x3Backward"})
    del model, params, opt, ema, x, target
    torch.cuda.empty_cache()

    # (e) the CLI on the card: 2 steps, a validation pass, a checkpoint BallDetector loads
    with tempfile.TemporaryDirectory() as d:
        tiny_tthq(d)
        t = time.time()
        T.main(["--task", "ball", "--model", "segformerpp_b2", "--data_root", d,
                "--batch_size", "2", "--num_epochs", "1", "--val_iterations", "2",
                "--max_steps", "2", "--resolution", "320", "192", "--eval_resolution", "640",
                "360", "--save_dir", os.path.join(d, "ckpt"), "--logdir", os.path.join(d, "runs"),
                "--device", DEVICE])
        cli_s = time.time() - t
        (ckpt,) = glob.glob(os.path.join(d, "ckpt", "*", "model.pt"))
        det = ball_detection("segformerpp_b2", checkpoint=ckpt, device=DEVICE,
                             resolution=(320, 192))
        tri = synthetic_frames(3)
        pos, _ = det.predict([(tri[0], tri[1], tri[2])])
    log("train", step="e", cli_s=f"{cli_s:.1f}", peak=json.dumps(np.round(pos, 2).tolist()))
    if pos.shape != (1, 3) or not np.isfinite(pos).all():
        raise AssertionError(f"the trained checkpoint's detector gave {pos}")
    res["cli_s"] = cli_s
    return res


def mae_state_dict(torch, seed=0):
    """A synthetic MAE ViT-S checkpoint (`mae_pretrain_vit_small.pth['model']`): a
    3-channel patch embedding, a cls token, a 197-row position embedding (224x224), 12
    blocks under the timm names, a final `norm`."""
    g = torch.Generator().manual_seed(seed)
    D = 384
    sd = {"cls_token": torch.randn(1, 1, D, generator=g),
          "pos_embed": torch.randn(1, 197, D, generator=g) * 0.02,
          "patch_embed.proj.weight": torch.randn(D, 3, 16, 16, generator=g) * 0.02,
          "patch_embed.proj.bias": torch.zeros(D), "norm.weight": torch.ones(D),
          "norm.bias": torch.zeros(D)}
    for i in range(12):
        p = f"blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = torch.ones(D), torch.zeros(D)
        for n, (o, k) in (("attn.qkv", (3 * D, D)), ("attn.proj", (D, D)),
                          ("mlp.fc1", (4 * D, D)), ("mlp.fc2", (D, 4 * D))):
            sd[p + n + ".weight"] = torch.randn(o, k, generator=g) * k ** -0.5
            sd[p + n + ".bias"] = torch.zeros(o)
    return sd


def vt_step(torch, model, x, target, masks):
    """One ViTPose training step's loss, gradients and running statistics (on the host):
    the trainer's loss_fn with explicit drop masks."""
    from upliftingtabletennis_torch.train import run_detection as T

    loss, _ = T.loss_fn(model, x, target, masks)
    grads = torch.autograd.grad(loss, list(model.parameters()), materialize_grads=True)
    stats = {k: v.detach().float().cpu() for k, v in model.named_buffers() if "running" in k}
    return loss.item(), [g.float().cpu() for g in grads], stats


def vt_case(torch, size):
    """One case of (b): (name, the f32 model in training mode (einsum attention) with
    perturbed statistics, input, target at the input's size, drop masks), seeded, on the
    host. size: ((W, H), B) of VT_CHECK."""
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.models.vit import draw_drop_masks
    from upliftingtabletennis_torch.pipeline.interface import init_weights

    (W, H), B = size
    base, _ = get_detector("vitpose", "ball", train=True, kernels=False, resolution=(W, H))
    init_weights(base, 3)
    perturb_batch_norms(torch, base, 4)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(B, H, W, 9, generator=g)
    target = torch.rand(B, 1, H, W, generator=g)
    return f"{W}x{H}_b{B}", base, x, target, draw_drop_masks(g, B)


def vt_check(torch, out, name, cpu_case, card, broken):
    """vitpose_train (b)'s gates on one case: the CPU's f32 step (`cpu_case`: the model,
    input, target and masks on the host) against the card's step `card`, and the card's
    steps under the planted faults (`broken`) against it. Fills out[name]."""
    t = time.time()
    cpu = vt_step(torch, *cpu_case)
    cpu_s = time.time() - t

    def errs(got):
        loss = abs(got[0] - cpu[0]) / abs(cpu[0])
        grad = max(hr_rel(a, b) for a, b in zip(got[1], cpu[1]) if b.any())
        stats = max(hr_rel(got[2][k], cpu[2][k]) for k in cpu[2])
        return {"loss_rel_err": loss, "grad_max_rel_err": grad, "stats_max_rel_err": stats}

    r = out[name] = {**errs(card), "faults": {f: errs(b) for f, b in broken.items()},
                     "cpu_step_s": cpu_s}
    log("vitpose_train", step="b", case=name, loss_rel_err=f"{r['loss_rel_err']:.3g}",
        grad_max_rel_err=f"{r['grad_max_rel_err']:.3g}",
        stats_max_rel_err=f"{r['stats_max_rel_err']:.3g}",
        faults=json.dumps({f: {k: float(f"{v:.3g}") for k, v in e.items()}
                           for f, e in r["faults"].items()}), cpu_step_s=f"{cpu_s:.1f}")
    if (r["loss_rel_err"] > HR_LOSS_RTOL or r["grad_max_rel_err"] > HR_GRAD_REL
            or r["stats_max_rel_err"] > HR_STATS_REL):
        raise AssertionError(f"ViTPose {name}: the card's training step differs from the "
                             f"CPU's: {r}")
    for fault in ("no_keep_scaling", "running_stats_in_training"):
        e = r["faults"][fault]
        if e["loss_rel_err"] <= HR_LOSS_RTOL and e["grad_max_rel_err"] <= HR_GRAD_REL:
            raise AssertionError(f"ViTPose {name}: the fault {fault} passes the limits: {e}")
    if name == VT_UNBIASED_CASE and r["faults"]["unbiased_variance"][
            "stats_max_rel_err"] <= HR_STATS_REL:
        raise AssertionError(f"ViTPose {name}: the unbiased variance passes the statistics "
                             f"limit: {r['faults']['unbiased_variance']}")


def vt_faults(torch):
    """The planted faults of (b): context managers that break the ViTPose step."""
    import torch.nn.functional as F

    from upliftingtabletennis_torch.models import batch_norm as BN
    from upliftingtabletennis_torch.models import vit as V

    def running_stats(self, x, deconv, bn):  # the head's BatchNorms as in inference
        x = F.conv_transpose2d(x, deconv.weight.to(x.dtype), None, stride=2, padding=1)
        return F.relu(F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                   False, 0.0, bn.eps))

    return {"no_keep_scaling": lambda: patched(
                V, _drop_path=lambda y, m, keep: y * m.to(y.dtype)[:, None, None]),
            "running_stats_in_training": lambda: patched(V.HeatmapHead,
                                                         _deconv_bn_relu=running_stats),
            "unbiased_variance": lambda: patched(V, batch_norm=unbiased_stats_fault(
                BN.batch_norm))}


@contextlib.contextmanager
def deterministic_step(torch):
    """Make a b0 training step give the same bits on every run: cuDNN's deterministic
    algorithms, and every bilinear resize of a tensor that needs a gradient (the decode
    head's, the loss's to 1920x1080) as two products with its interpolation matrices,
    the same resize without the atomic adds of the stock backward."""
    import torch.nn.functional as F

    stock = F.interpolate

    def weights(n_in, n_out, like):  # half-pixel centres, clamped at the edges
        src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out)
               - 0.5).clamp(min=0)
        i0 = src.floor().long().clamp(max=n_in - 1)
        rows = torch.arange(n_out)
        A = torch.zeros(n_out, n_in, dtype=torch.float64)
        A.index_put_((rows, i0), 1 - (src - i0), accumulate=True)
        A.index_put_((rows, (i0 + 1).clamp(max=n_in - 1)), src - i0, accumulate=True)
        return A.to(like.device, like.dtype)

    def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=None,
                    recompute_scale_factor=None, antialias=False):
        if not (x.requires_grad and x.ndim == 4 and mode == "bilinear"
                and isinstance(size, (tuple, list)) and not align_corners and not antialias):
            return stock(x, size, scale_factor, mode, align_corners, recompute_scale_factor,
                         antialias)
        return weights(x.shape[2], size[0], x) @ x @ weights(x.shape[3], size[1], x).T

    with patched(F, interpolate=interpolate), patched(torch.backends.cudnn, deterministic=True):
        yield


def run_vitpose_train(torch, ops, frames, pipe, later, profile=False):
    """Phase vitpose_train: (a) one warm full-width ViTPose step timed, (b) the card's
    step against the CPU's with planted faults (the CPU's side appended to `later`, which
    the card_tests phase runs), (c) the CLI with --torch_init, (d) world size 1 on the
    card: DDP over NCCL, a one-card mesh for run_rally and generate_dataset."""
    import copy
    import glob
    import io
    import socket
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.data.image_transforms import ImageAugmentConfig
    from upliftingtabletennis_torch.models import batch_norm as BN
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.parallel.mesh import make_mesh
    from upliftingtabletennis_torch.pipeline.interface import BallDetector, init_weights
    from upliftingtabletennis_torch.train import run_detection as T
    from upliftingtabletennis_torch.utils.port_torch import torch_init_detector

    res = {}
    cfg = ImageAugmentConfig()

    def batch_of(B):  # B triplets at 1920x1080 with the blob's centre labelled (run_train's)
        images = torch.from_numpy(np.stack([np.concatenate(frames[t:t + 3], -1)
                                            for t in range(B)])).to(DEVICE).float()
        coords = torch.tensor([[[300 + 140 * (t + 1), 700 - 45 * (t + 1)]] * 3
                               for t in range(B)], dtype=torch.float32, device=DEVICE)
        return images, coords, torch.ones(B, 3, device=DEVICE)

    # (a) one warm full-width step: ViTPose-S at 1152x640, batch 4, the loss at 1920x1080
    model, _ = get_detector("vitpose", "ball", train=True)
    init_weights(model, 0)
    model.to(DEVICE)
    params = list(model.parameters())
    opt, ema = T.init_adam(params), [p.detach().clone() for p in params]
    gen = torch.Generator().manual_seed(0)
    images, coords, vis = batch_of(VT_BATCH)

    def step():
        return T.train_step(model, params, opt, ema, gen, images, coords, vis, VIT_RES,
                            EVAL_RES, cfg, dtype=torch.bfloat16).item()

    first, first_s, launches = counted(torch, ops, step, {})  # no port kernel on this path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], [first]
    for _ in range(VT_TIMED):
        t = time.time()
        losses.append(step())  # .item() waits for the step
        step_ms.append(1e3 * (time.time() - t))
    ms = statistics.median(step_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res["timing"] = dict(ms_per_step=ms, step_ms=step_ms, images_per_s=1e3 * VT_BATCH / ms,
                         peak_mem_gb=peak_gb, first_step_s=first_s, losses=losses,
                         launches=launches)
    log("vitpose_train", step="a", config=f"{VIT_RES[0]}x{VIT_RES[1]}_b{VT_BATCH}",
        ms_per_step=f"{ms:.2f}", step_ms=json.dumps([round(v, 2) for v in step_ms]),
        images_per_s=f"{1e3 * VT_BATCH / ms:.3f}", peak_mem_gb=f"{peak_gb:.3f}",
        first_step_s=f"{first_s:.3f}", losses=json.dumps([round(v, 5) for v in losses]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"ViTPose training losses not finite: {losses}")
    if profile:
        res["timing"]["profile"] = profile_calls(
            torch, step, "one warm ViTPose-S training step (batch 4, 1152x640, the loss at "
            "1920x1080)", categories={"sdpa": "aten::scaled_dot_product_attention",
                                      "linears": "aten::linear",
                                      "deconvolutions": "aten::conv_transpose2d",
                                      "loss_upsample": "aten::upsample_bilinear2d",
                                      "augmentation_gathers": "aten::gather"})
    del model, params, opt, ema
    torch.cuda.empty_cache()

    # (b) the card's f32 step and its planted faults here; the CPU's step on the same case
    # and the limits that hold the two together (`vt_check`) beside the card tests
    faults = vt_faults(torch)
    res["check"] = {}
    for size in VT_CHECK:
        name, base, x, target, masks = vt_case(torch, size)
        cpu_case = (copy.deepcopy(base), x, target, masks)
        args = (x.to(DEVICE), target.to(DEVICE), masks.to(DEVICE))
        on_card = base.to(DEVICE)
        state = {k: v.clone() for k, v in on_card.state_dict().items()}

        def card_step():  # from the case's weights and statistics
            on_card.load_state_dict(state)
            return vt_step(torch, on_card, *args)

        card = card_step()
        broken = {}
        for fault, ctx in faults.items():
            with ctx():
                broken[fault] = card_step()
        later.append(functools.partial(vt_check, torch, res["check"], name, cpu_case, card,
                                       broken))
        del on_card, state, args
    torch.cuda.empty_cache()

    # (c) the CLI with the reference's MAE initialisation, 2 steps on a tiny TTHQ layout
    with tempfile.TemporaryDirectory() as d:
        tiny_tthq(d)
        mae = mae_state_dict(torch)
        path = os.path.join(d, "mae_pretrain_vit_small.pth")
        torch.save({"model": mae}, path)
        ref, _ = get_detector("vitpose", "ball", train=True, resolution=VT_CLI_RES)
        # the counts depend on the keys and shapes alone
        _, n_loaded, n_total = torch_init_detector(ref.state_dict(), mae, "vitpose", 3)
        out = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(out):
            T.main(["--task", "ball", "--model", "vitpose", "--data_root", d, "--batch_size",
                    "2", "--num_epochs", "1", "--val_iterations", "2", "--max_steps", "2",
                    "--resolution", str(VT_CLI_RES[0]), str(VT_CLI_RES[1]),
                    "--eval_resolution", "640", "360", "--torch_init", path,
                    "--save_dir", os.path.join(d, "ckpt"), "--logdir", os.path.join(d, "runs"),
                    "--device", DEVICE])
        cli_s = time.time() - t
        printed = out.getvalue()
        (ckpt,) = glob.glob(os.path.join(d, "ckpt", "*", "model.pt"))
        det = BallDetector("vitpose", checkpoint=ckpt, device=DEVICE, resolution=VT_CLI_RES)
        tri = synthetic_frames(3)
        pos, _ = det.predict([(tri[0], tri[1], tri[2])])
    want = f"[init] loaded {n_loaded}/{n_total} tensors from {path}"
    res["cli"] = dict(cli_s=cli_s, n_loaded=n_loaded, n_total=n_total, peak=pos.tolist())
    log("vitpose_train", step="c", cli_s=f"{cli_s:.1f}", init=json.dumps(want.split(" from ")[0]),
        peak=json.dumps(np.round(pos, 2).tolist()))
    if want not in printed:
        raise AssertionError(f"run_detection --torch_init did not print {want!r}: {printed}")
    if pos.shape != (1, 3) or not np.isfinite(pos).all():
        raise AssertionError(f"the trained ViTPose checkpoint's detector gave {pos}")

    # (d) world size 1: one b0 trainer step under DDP over NCCL against the same step
    # without DDP, both made deterministic (`deterministic_step`), so that they must agree
    # to the bit and a repeat of the plain step shows that they can
    t = time.time()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        b0, _ = get_detector("segformerpp_b0", "ball", train=True)
        init_weights(b0, 1)
        b0.to(DEVICE)
        state0 = {k: v.clone() for k, v in b0.state_dict().items()}
        names = [n for n, _ in b0.named_parameters()]
        images, coords, vis = batch_of(VT_DDP_BATCH)

        def b0_step(ddp):
            b0.load_state_dict(state0)
            params = list(b0.parameters())
            opt, ema = T.init_adam(params), [p.detach().clone() for p in params]
            net, shard = b0, None
            if ddp:  # the last step: the model stays wrapped after it
                BN.sync_batch_stats(b0)
                net = DistributedDataParallel(b0, device_ids=[torch.cuda.current_device()],
                                              broadcast_buffers=False)
                shard = (slice(0, VT_DDP_BATCH), VT_DDP_BATCH)
            captured, update = {}, T.apply_update

            def keep(p, g, *a, **k):
                captured["grads"] = [x.detach().float().clone() for x in g]
                return update(p, g, *a, **k)

            for k in ops.ALL:
                getattr(ops, k).launches = 0
            with patched(T, apply_update=keep):
                loss = T.train_step(net, params, opt, ema, torch.Generator().manual_seed(2),
                                    images, coords, vis, VT_DDP_RES, EVAL_RES, cfg,
                                    dtype=torch.bfloat16, shard=shard).item()
            counts = {k: getattr(ops, k).launches for k in ops.ALL}
            return loss, captured["grads"], counts

        setup_s, t = time.time() - t, time.time()
        with deterministic_step(torch):
            plain, again, ddp = b0_step(False), b0_step(False), b0_step(True)
        steps_s = time.time() - t
    finally:
        dist.destroy_process_group()

    def step_err(a, b):
        """The loss's relative error and the worst gradient tensor's (of its max |grad|)."""
        grads = {n: hr_rel(x, y) for n, x, y in zip(names, a[1], b[1])}
        worst = max(grads, key=grads.get)
        return max(abs(a[0] - b[0]) / abs(b[0]), grads[worst]), worst

    repeat_err, repeat_worst = step_err(again, plain)
    ddp_err, ddp_worst = step_err(ddp, plain)
    launches = ddp[2]
    res["ddp"] = dict(loss=ddp[0], loss_plain=plain[0], max_rel_err=ddp_err,
                      worst=ddp_worst, repeat_max_rel_err=repeat_err, repeat_worst=repeat_worst,
                      launches=launches, launches_plain=plain[2], tol=VT_DDP_TOL,
                      setup_s=setup_s, steps_s=steps_s)
    log("vitpose_train", step="d_ddp", config=f"b0_{VT_DDP_RES[0]}x{VT_DDP_RES[1]}_b"
        f"{VT_DDP_BATCH}", loss=f"{ddp[0]:.6g}", loss_plain=f"{plain[0]:.6g}",
        max_rel_err=f"{ddp_err:.3g}", worst=ddp_worst, repeat_max_rel_err=f"{repeat_err:.3g}",
        repeat_worst=repeat_worst, tol=VT_DDP_TOL, setup_s=f"{setup_s:.2f}",
        steps_s=f"{steps_s:.2f}", launches=json.dumps({k: v for k, v in launches.items() if v}))
    if launches != plain[2] or not all(launches[k] for k in (
            "fused_attention_block", "fused_ln_ffn", "depthwise_conv3x3", "dwconv3x3_backward")):
        raise AssertionError(f"the DDP step launched {launches}, the plain step {plain[2]}")
    if repeat_err > VT_DDP_TOL or ddp_err > VT_DDP_TOL:
        raise AssertionError(f"the DDP step differs from the plain step by {ddp_err} "
                             f"({ddp_worst}); the plain step from itself by {repeat_err} "
                             f"({repeat_worst}); the limit is {VT_DDP_TOL}")

    # (d) a one-card mesh: run_rally and generate_dataset equal the runs without
    mesh = make_mesh(1, devices=[DEVICE])
    rally = synthetic_frames(VT_RALLY_FRAMES)
    one = pipe.run_rally(rally, fps=50)
    with patched(pipe, mesh=mesh):
        two = pipe.run_rally(rally, fps=50)
    same_shape = all(np.shape(two[k]) == np.shape(one[k]) for k in one)
    rally_err = max(float(np.abs(np.asarray(two[k]) - np.asarray(one[k])).max(initial=0.0))
                    if same_shape else float("inf") for k in ("ball", "table"))
    n, batch = VT_DATAGEN
    plain_dg = DG.generate_dataset(n, batch=batch, device=DEVICE,
                                   generator=torch.Generator(device=DEVICE).manual_seed(1))
    mesh_dg = DG.generate_dataset(n, batch=batch, mesh=mesh,
                                  generator=torch.Generator(device=DEVICE).manual_seed(1))
    dg_equal = all(np.array_equal(plain_dg[k], mesh_dg[k]) for k in plain_dg)
    res["mesh"] = dict(rally_max_px_err=rally_err, rally_shapes_equal=same_shape,
                       datagen_equal=dg_equal)
    log("vitpose_train", step="d_mesh", rally_max_px_err=f"{rally_err:.3g}",
        rally_shapes_equal=same_shape, datagen_equal=dg_equal)
    if not (same_shape and rally_err <= SLAB_TOL_PX and dg_equal):
        raise AssertionError(f"a one-card mesh changes the result: {res['mesh']}")
    return res


def rally_launches(pipe, n_frames, table_stride):
    """Launches of one rally: RALLY_PER_PIECE per piece with table frames, half of each on a
    ball-only piece."""
    chunk = pipe.ball_detector.chunk
    n_pieces = -(-n_frames // chunk)
    with_table = len({c // chunk for c in range(0, n_frames, table_stride)})
    return {k: v * with_table + v // 2 * (n_pieces - with_table)
            for k, v in RALLY_PER_PIECE.items()}


def result_shapes(out):
    return {k: None if v is None else tuple(v.shape) for k, v in out.items()}


def uplift_check(torch, cpu_model, inputs, got, what):
    """The card's (spin, pos3d) against the CPU f32 copy on the same normalised inputs
    (ball, table, mask, times): the position error over max |pos3d| and the world-frame
    spin's error over |spin| (UPLIFT_RTOL each). The card's flight-frame spin is turned
    back into the world frame with the card's own positions. Raises past the limits."""
    import numpy as np

    from upliftingtabletennis_torch.core.geometry import inverse_transform_rotation_axes

    b, t, m, tt = (torch.as_tensor(a) for a in inputs)
    with torch.no_grad():
        rot, pos = cpu_model.model(b, t, m, tt)
    rot, pos = rot[0].numpy(), pos[0, :len(got[1])].numpy()
    spin_card = inverse_transform_rotation_axes(torch.from_numpy(got[0]),
                                                torch.from_numpy(got[1])).numpy()
    err = {"pos3d": float(np.abs(got[1] - pos).max() / np.abs(pos).max()),
           "spin": float(np.linalg.norm(spin_card - rot) / np.linalg.norm(rot))}
    if got[1].shape != pos.shape or not (err["pos3d"] <= UPLIFT_RTOL
                                         and err["spin"] <= UPLIFT_RTOL):
        raise AssertionError(f"{what}: the uplifting model on the card differs from the CPU: "
                             f"{err}")
    return err


def run_rally_phase(torch, ops, pipe, profile=False):
    import copy

    import numpy as np

    from upliftingtabletennis_torch.data.image_transforms import host_downscale, i420_to_rgb
    from upliftingtabletennis_torch.pipeline import filters
    from upliftingtabletennis_torch.pipeline.interface import HEIGHT, WIDTH, UpliftingModel

    inputs, i420_rgb_cpu = rally_inputs(torch)
    frames = inputs["rgb"]
    chunk = pipe.ball_detector.chunk
    for fmt, x in inputs.items():  # warm-up: cuDNN's algorithms, the allocator, pinned blocks
        for up in ("model", None):
            pipe.run_rally(x[:2 * chunk], RALLY_FPS, pixel_format=fmt, upload_res=up)
    torch.cuda.synchronize()

    # the main path, counted: every piece with table frames, then every other piece ball-only
    out, secs, launches = counted(torch, ops, lambda: pipe.run_rally(frames, RALLY_FPS),
                                  rally_launches(pipe, RALLY_FRAMES, 1))
    if (out["ball"].shape != (len(out["valid_idx"]), 2) or out["table"].shape != (13, 3)
            or not np.isfinite(out["ball"]).all()):
        raise AssertionError(f"run_rally returned {result_shapes(out)}")
    stride = 2 * chunk
    _, _, launches_strided = counted(
        torch, ops, lambda: pipe.run_rally(frames, RALLY_FPS, table_stride=stride),
        rally_launches(pipe, RALLY_FRAMES, stride))
    log("rally", frames=RALLY_FRAMES, chunk=chunk, launches=launches,
        launches_table_stride_16=launches_strided, first_call_s=f"{secs:.3f}",
        ball_kept=len(out["valid_idx"]), table_visible=int(out["table"][:, 2].sum()))

    # frames/s: the median and range of RALLY_CALLS warm calls of each configuration
    rates, shapes = {}, {}
    for fmt, x in inputs.items():
        for up in ("model", None):
            for st in (1, 2):
                key = f"{fmt}_upload_{up or 'full'}_stride{st}"
                calls = []
                for _ in range(RALLY_CALLS):
                    t = time.time()
                    o = pipe.run_rally(x, RALLY_FPS, table_stride=st, pixel_format=fmt,
                                       upload_res=up)
                    calls.append(RALLY_FRAMES / (time.time() - t))
                rates[key] = {"median": statistics.median(calls), "range": [min(calls),
                                                                            max(calls)],
                              "calls": calls}
                shapes[key] = result_shapes(o)
                log("rally", config=key, frames_per_s=f"{rates[key]['median']:.3f}",
                    frames_per_s_range=f"{min(calls):.3f}-{max(calls):.3f}")
    for key, sh in shapes.items():
        if sh != shapes[key.replace("i420", "rgb")]:
            raise AssertionError(f"rgb and i420 rallies differ in shape: {shapes}")

    # the host downscale alone, on the host's clock
    target = (max(d.resolution[0] for d in pipe._detectors()),
              max(d.resolution[1] for d in pipe._detectors()))
    downscale_ms = {}
    for fmt, x in inputs.items():
        t = time.time()
        host_downscale(x, target, fmt)
        downscale_ms[fmt] = 1e3 * (time.time() - t) / RALLY_FRAMES
    # what the downscale would cost if it overlapped nothing: its host time added to a
    # rally that uploads full frames, beside the measured rate of upload_res "model"
    serial = {fmt: 1e3 / (downscale_ms[fmt] + 1e3 / rates[f"{fmt}_upload_full_stride1"]["median"])
              for fmt in inputs}
    log("rally", host_downscale_ms_per_frame=json.dumps({k: round(v, 3) for k, v in
                                                         downscale_ms.items()}),
        to=f"{target[0]}x{target[1]}",
        no_overlap_frames_per_s=json.dumps({k: round(v, 3) for k, v in serial.items()}))

    # rgb against i420: the same detectors on frames whose chroma went through 4:2:0
    peaks_rgb = pipe._rally_peaks(frames)
    peaks_i420 = pipe._rally_peaks(inputs["i420"], pixel_format="i420")
    if [p.shape for p in peaks_rgb] != [p.shape for p in peaks_i420]:
        raise AssertionError("rgb and i420 peaks differ in shape")
    i420_px = max(float(np.abs(a[..., :2] - b[..., :2]).max())
                  for a, b in zip(peaks_rgb, peaks_i420))

    # the slab step against each detector's own predict on the same triplets and frames:
    # RALLY_EDGE_FRAMES frames uploaded as given, so both resize on the card from 1920x1080
    edge = frames[:RALLY_EDGE_FRAMES]
    T = len(edge)
    slab = pipe._rally_peaks(edge, upload_res=None)
    triples = [(edge[max(t - 1, 0)], edge[t], edge[min(t + 1, T - 1)]) for t in range(T)]
    # the pipeline's own detectors (hub.ball_detection / table_detection at the same chunk
    # build these four with the same seeded weights)
    refs = [(pipe.ball_detector, triples), (pipe.ball_detector_aux, triples),
            (pipe.table_detector, list(edge)), (pipe.table_detector_aux, list(edge))]
    slab_px = {}
    for (det, items), got in zip(refs, slab):
        want = det.predict(items)[0]
        name = f"{det.model_name}_{det.task}"
        slab_px[name] = float(np.abs(got[..., :2] - want[..., :2]).max())
        if got.shape != want.shape or not np.array_equal(got[..., 2], want[..., 2]) \
                or not slab_px[name] <= SLAB_TOL_PX:
            raise AssertionError(f"{name}: the slab step's peaks differ from predict's: "
                                 f"{slab_px[name]} px")
    del refs

    # i420 -> RGB on the card against the CPU, piece by piece
    diff_values, diff_max = 0, 0
    for s in range(0, RALLY_FRAMES, chunk):
        x = torch.from_numpy(inputs["i420"][s:s + chunk])
        d = (i420_to_rgb(x.to(DEVICE), 1080, 1920).cpu().int() - i420_rgb_cpu[s:s + chunk].int())
        diff_values += int((d != 0).sum())
        diff_max = max(diff_max, int(d.abs().max()))
    if diff_max > 1:
        raise AssertionError(f"i420_to_rgb on the card differs from the CPU by {diff_max}")
    log("rally", slab_vs_predict_px=json.dumps(slab_px), rgb_vs_i420_max_px=f"{i420_px:.4g}",
        i420_to_rgb_differing_values=diff_values, i420_to_rgb_max_diff=diff_max)

    # the uplifting tail on the card: the ball aux is the ball main, so every interior
    # frame passes the filter; the same inputs through the CPU f32 model
    tail = copy.copy(pipe)
    tail.ball_detector_aux = tail.ball_detector
    out_t = tail.run_rally(frames, RALLY_FPS)
    if len(out_t["valid_idx"]) != RALLY_FRAMES - 2 or out_t["spin"] is None:
        raise AssertionError(f"the tail rally kept {len(out_t['valid_idx'])} frames")
    cpu_model = UpliftingModel({k: v.cpu() for k, v in
                                pipe.uplifting_model.model.state_dict().items()}, device="cpu")
    b, t, tt, m = filters.uplifting_inputs(out_t["ball"], out_t["table"], out_t["times"],
                                           WIDTH, HEIGHT)
    tail_err = uplift_check(torch, cpu_model, (b, t, m, tt), (out_t["spin"], out_t["pos3d"]),
                            "the rally's uplifting tail")
    log("rally", tail_kept=len(out_t["valid_idx"]), tail_pos3d=list(out_t["pos3d"].shape),
        tail_err=json.dumps(tail_err), tol=UPLIFT_RTOL)

    res = dict(frames=RALLY_FRAMES, fps_video=RALLY_FPS, chunk=chunk, launches=launches,
               launches_table_stride_16=launches_strided, frames_per_s=rates,
               host_downscale_ms_per_frame=downscale_ms, downscale_to=list(target),
               no_overlap_frames_per_s=serial,
               slab_vs_predict_px=slab_px, rgb_vs_i420_max_px=i420_px,
               i420_to_rgb_differing_values=diff_values, tail_err=tail_err,
               result_shapes=shapes)
    if profile:
        res["profile"] = profile_calls(torch, lambda: pipe.run_rally(frames[:chunk], RALLY_FPS),
                                       f"one warm piece of {chunk} frames through run_rally "
                                       "(rgb, upload_res model)")
    return res


def run_uplifting(torch):
    import numpy as np

    from upliftingtabletennis_torch import hub
    from upliftingtabletennis_torch.pipeline import filters
    from upliftingtabletennis_torch.pipeline.interface import HEIGHT, WIDTH, UpliftingModel

    model = hub.uplifting(device=DEVICE)
    cpu = UpliftingModel({k: v.cpu() for k, v in model.model.state_dict().items()},
                         device="cpu")
    rng = np.random.default_rng(0)
    table = np.concatenate([rng.uniform(0, [WIDTH, HEIGHT], (13, 2)),
                            rng.uniform(0, 1, (13, 1)) > 0.2], -1)
    res = {}
    for T in UPLIFT_LENGTHS:
        ball = rng.uniform(0, [WIDTH, HEIGHT], (T, 2))
        b, t, tt, m = filters.uplifting_inputs(ball, table, np.arange(T) / RALLY_FPS, WIDTH,
                                               HEIGHT)
        got = model.predict_without_normalization(b, t, m, tt)
        err = uplift_check(torch, cpu, (b, t, m, tt), got, f"uplifting at T = {T}")
        ms = {}
        for name, mdl in (("card", model), ("cpu", cpu)):
            calls = []
            for _ in range(UPLIFT_WARM_CALLS + UPLIFT_TIMED_CALLS):  # each returns numpy:
                t0 = time.perf_counter()                             # it waits for the card
                mdl.predict_without_normalization(b, t, m, tt)
                calls.append(1e3 * (time.perf_counter() - t0))
            ms[name] = statistics.median(calls[UPLIFT_WARM_CALLS:])
        res[f"T{T}"] = {"err": err, "pos3d_shape": list(got[1].shape), "ms": ms["card"],
                        "cpu_ms": ms["cpu"]}
        log("uplifting", T=T, valid=int(m.sum()), err=json.dumps(err),
            ms_per_call=f"{ms['card']:.3f}", cpu_ms_per_call=f"{ms['cpu']:.3f}")
        if got[1].shape != (min(T, filters.SEQUENCE_LEN), 3):
            raise AssertionError(f"uplifting at T = {T}: pos3d of shape {got[1].shape}")
    return res


def calib_keypoints():
    """(keypoints (13, 3), the noise-free projections (13, 2)) of a broadcast camera at
    CALIB_RES: 1 px noise, one gross outlier."""
    import numpy as np
    import torch

    from upliftingtabletennis_torch.core.geometry import TABLE_POINTS, get_Mext, world2img

    rng = np.random.default_rng(7)
    c = np.array([1.2, 9.5, 4.0])
    f = np.array([0.1, -0.1, 0.76]) - c
    f = f / np.linalg.norm(f)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r = r / np.linalg.norm(r)
    Mext = get_Mext(*(torch.from_numpy(v) for v in (c, f, r)))
    Mint = torch.tensor([[2000.0, 0, CALIB_RES[0] // 2], [0, 2100.0, CALIB_RES[1] // 2],
                         [0, 0, 1.0]], dtype=torch.float64)
    gt = world2img(torch.from_numpy(TABLE_POINTS).double(), Mext, Mint).numpy()
    pts = gt + rng.normal(0, CALIB_NOISE_PX, gt.shape)
    k, shift = CALIB_OUTLIER
    pts[k] += shift
    return np.concatenate([pts, np.ones((13, 1))], -1), gt


def run_calib(torch, pipe):
    import numpy as np

    from upliftingtabletennis_torch.core.geometry import TABLE_POINTS
    from upliftingtabletennis_torch.pipeline.interface import TableDetector

    kp, gt = calib_keypoints()
    if pipe._last_frame_res != CALIB_RES:
        raise AssertionError(f"the pipeline's frame is {pipe._last_frame_res}")
    k_out = CALIB_OUTLIER[0]
    res = {}
    for where, fn, calls in (
            ("card", lambda: pipe.calibrate_camera(kp), CALIB_CALLS),
            ("cpu", lambda: TableDetector.calibrate_camera(kp, CALIB_RES, device="cpu"), 1)):
        cam = fn()  # warm-up
        times = []
        for _ in range(calls):
            t = time.perf_counter()
            cam = fn()
            times.append(1e3 * (time.perf_counter() - t))
        Mint, Mext, n = cam
        pix = pipe.reproject(TABLE_POINTS, Mint, Mext, device=DEVICE)  # on the card
        err = np.linalg.norm(pix - kp[:, :2], axis=-1)
        err_gt = np.linalg.norm(pix - gt, axis=-1)
        res[where] = dict(inliers=n, mean_px=float(np.delete(err, k_out).mean()),
                          outlier_px=float(err[k_out]), mean_px_vs_truth=float(err_gt.mean()),
                          fx=float(Mint[0, 0]), fy=float(Mint[1, 1]),
                          ms=statistics.median(times), Mint=Mint.tolist(), Mext=Mext.tolist())
        log("calib", on=where, inliers=n, mean_px=f"{res[where]['mean_px']:.3f}",
            outlier_px=f"{err[k_out]:.1f}", mean_px_vs_truth=f"{err_gt.mean():.3f}",
            fx=f"{Mint[0, 0]:.1f}", fy=f"{Mint[1, 1]:.1f}",
            ms_per_call=f"{res[where]['ms']:.1f}")
        if not (6 <= n <= 12 and res[where]["mean_px"] < CALIB_MEAN_PX
                and err[k_out] > CALIB_OUTLIER_PX):
            raise AssertionError(f"calibration on the {where}: {res[where]}")
    res["card_vs_cpu"] = {"Mint": float(np.abs(np.subtract(res["card"]["Mint"],
                                                           res["cpu"]["Mint"])).max()),
                          "Mext": float(np.abs(np.subtract(res["card"]["Mext"],
                                                           res["cpu"]["Mext"])).max())}
    log("calib", card_vs_cpu=json.dumps(res["card_vs_cpu"]))
    return res


def s1_errors(torch, got, want):
    """Per-trajectory max |got - want| over frames and components: (N,) for each of the
    BallStates' fields, trajectories along dim 1."""
    return [(g - w).abs().transpose(0, 1).reshape(g.shape[1], -1).amax(1)
            for g, w in zip(got, want)]


def s1_over(torch, errs, tols):
    """(N,) bool: trajectories over any of the limits."""
    over = torch.zeros_like(errs[0], dtype=torch.bool)
    for e, t in zip(errs, tols):
        over |= ~(e <= t)
    return over


def s1_op_latency(torch):
    """SM cycles of one dependent add, multiply, divide and square root as S1 rounds them
    (physics.cu's op_latency_kernel: S1_LAT_CHAIN of each in one thread, timed by
    %clock64), the least of 3 calls."""
    import ctypes

    from upliftingtabletennis_torch.ops import _build

    lib = _build.library("physics.cu")
    fn = lib.uttk_physics_op_latency
    fn.argtypes = [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sink = torch.zeros(4, dtype=torch.float32, device=DEVICE)
    cycles = torch.zeros(4, dtype=torch.int64, device=DEVICE)
    best = None
    for _ in range(3):
        status = _build.call_on_device(cycles, lambda stream: fn(
            1.0, 1.0000001, S1_LAT_CHAIN, sink.data_ptr(), cycles.data_ptr(), stream))
        _build.check(lib, status, "S1 op latency")
        got = cycles.tolist()
        best = got if best is None else [min(a, b) for a, b in zip(best, got)]
    return {k: c / S1_LAT_CHAIN for k, c in zip(("add", "mul", "div", "sqrt"), best)}


def s1_ptxas(report):
    """{kernel: {registers, spill_stores, spill_loads, stack}} of physics.cu's kernels
    and out-of-line functions, from nvcc's `-Xptxas -v` report."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)",
                      line.strip())
        if m:
            name = s1_short_name(m.group(1))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def s1_short_name(mangled):
    """forward_kernel, tangent_kernel, exact_step<Real>, exact_step<Dual>, or None."""
    for kernel in ("forward_kernel", "tangent_kernel"):
        if kernel in mangled:
            return kernel
    if "exact_step" in mangled:
        return "exact_step<Dual>" if "Dual" in mangled else "exact_step<Real>"
    return None


S1_SASS_KINDS = ("FFMA", "FMUL", "FADD", "MUFU", "FCHK", "CALL", "BSSY", "BSYNC", "BRA", "LDL",
                 "STL", "LDC", "ULDC", "LDG", "LD", "STG", "ST", "STS")


def s1_sass_facts(sass):
    """What the SASS of physics.cu's kernels shows: per function, its instruction count
    and, for its step loop (the innermost backward branch whose span holds at least 100
    float instructions), the span in bytes and instructions, the count of each kind in
    S1_SASS_KINDS, and `const_operands`: instructions that read a constant-bank operand
    (c[bank][offset]) directly."""
    import re

    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = s1_short_name(m.group(1))
            if name:
                funcs[name] = {"labels": {}, "ins": [], "pending": []}
            continue
        if not name:
            continue
        f = funcs[name]
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            f["pending"].append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for label in f["pending"]:
                f["labels"][label] = addr
            f["pending"] = []
            f["ins"].append((addr, m.group(2)))
    facts = {}
    for name, f in funcs.items():
        ins = [(a, t, re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0])
               for a, t in f["ins"]]
        loops = []
        for a, t, op in ins:
            if op != "BRA":
                continue
            m = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", t)
            target = (f["labels"].get(m.group(1)) if m and m.group(1)
                      else int(m.group(2), 16) if m else None)
            if target is not None and target <= a:
                body = [x for x in ins if target <= x[0] <= a]
                fp = sum(x[2] in ("FFMA", "FMUL", "FADD") for x in body)
                loops.append((a - target + 16, body, fp))
        entry = {"instructions": len(ins)}
        hot = [lp for lp in loops if lp[2] >= 100]
        if hot:
            span, body, _ = min(hot, key=lambda lp: lp[0])
            counts = collections.Counter(x[2] for x in body)
            entry["step_loop"] = {
                "bytes": span, "instructions": len(body),
                **{k: counts.get(k, 0) for k in S1_SASS_KINDS},
                "const_operands": sum("c[0x" in x[1] and x[2] not in ("LDC", "ULDC")
                                      for x in body)}
        facts[name] = entry
    return facts


def s1_sass(_build, path):
    """cuobjdump -sass of a built library ("" without the tool)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return ""
    return subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout


S1_ANATOMY_STEPS = 1000
S1_ANATOMY_MODES = ("forward_ieee", "forward", "tangent_ieee", "tangent")


def s1_anatomy(torch, lib, state):
    """physics.cu's anatomy_kernel on one trajectory (state: r, v, w of 3 floats) over
    S1_ANATOMY_STEPS steps, a frame every 2: SM cycles per step of each part (the flight,
    the contact tests, the bounces, the frame stores; `loop` the whole), for the kernels'
    step (forward, tangent) and for the same step with IEEE divisions and square roots
    throughout (*_ieee); the steps that hit a surface; the SM clock over the loop
    (%clock64 over %globaltimer); the least of 3 calls."""
    import ctypes

    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.ops import _build
    from upliftingtabletennis_torch.ops import physics as S1

    fn = lib.uttk_physics_anatomy
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    r0, v0, w0 = (torch.tensor(x, dtype=torch.float32, device=DEVICE) for x in state)
    out = torch.zeros(S1_ANATOMY_STEPS // 2 + 1, 9, dtype=torch.float32, device=DEVICE)
    cycles = torch.zeros(7, dtype=torch.int64, device=DEVICE)
    want = S1.simulate(P.BallState(r0[None], v0[None], w0[None]), S1_ANATOMY_STEPS // 2 + 1,
                       first_step=False)
    want = torch.cat([x[:, 0] for x in want], -1)
    res = {}
    for mode, name in enumerate(S1_ANATOMY_MODES):
        best = None
        for _ in range(3):
            status = _build.call_on_device(cycles, lambda stream: fn(
                r0.data_ptr(), v0.data_ptr(), w0.data_ptr(), mode, S1_ANATOMY_STEPS, 2,
                S1._consts(P.DT), out.data_ptr(), cycles.data_ptr(), stream))
            _build.check(lib, status, "S1 anatomy")
            got = cycles.tolist()
            best = got if best is None or got[4] < best[4] else best
        parts = dict(zip(("flight", "tests", "bounce", "frame_store", "loop"),
                         (c / S1_ANATOMY_STEPS for c in best[:5])))
        res[name] = {**parts, "steps_that_hit": best[5], "sm_ghz": best[4] / best[6],
                     "frames_equal_kernel": bool(torch.equal(out, want))}
    return res


S1_FAST_OPS_PAIRS = 1 << 30


def s1_fast_ops_check(torch, lib):
    """physics.cu's fast_ops_check_kernel over S1_FAST_OPS_PAIRS operand pairs: the fast
    division and square root of the kernels' hot step against __fdiv_rn and __fsqrt_rn.
    Fails if any result outside NaN (the exact step's cue) differs in a bit."""
    import ctypes

    from upliftingtabletennis_torch.ops import _build

    fn = lib.uttk_physics_fast_ops_check
    fn.argtypes = [ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    counts = torch.zeros(4, dtype=torch.int64, device=DEVICE)
    status = _build.call_on_device(counts, lambda stream: fn(S1_FAST_OPS_PAIRS, 12345,
                                                             counts.data_ptr(), stream))
    _build.check(lib, status, "S1 fast ops check")
    res = dict(zip(("div_differing", "div_to_exact_step", "sqrt_differing",
                    "sqrt_to_exact_step"), counts.tolist()), pairs=S1_FAST_OPS_PAIRS)
    if res["div_differing"] or res["sqrt_differing"]:
        raise AssertionError(f"S1: the fast division or square root differs from IEEE: {res}")
    return res


def s1_chain(lat, mode, steps=64):
    """S1's serial chain and float operations per step, worked out from the code: the
    plain version's flight step (core/physics.py `_implicit_velocity_update`, then
    r' = r + dt v: the arithmetic of physics.cu's `step` outside a contact, in the same
    order) run on scalars that carry only the cycle at which they are ready. An add,
    multiply, divide or square root is ready its latency `lat` after the later of its
    operands and counts one operation; a compare, a select or a sign flip costs nothing,
    and the contact tests are left out, so both counts are floors. The tangent mode runs
    the plain version's dual numbers over such scalars: one thread's value and tangent.
    Returns (cycles per step, float operations per step and thread): the growth of the
    latest ready time over the second half of `steps` steps, and one step's count."""
    import types

    import torch as _torch

    from upliftingtabletennis_torch.core import physics as P

    count = [0]

    class Chain:
        __slots__ = ("c",)

        def __init__(self, c=0.0):
            self.c = c

        def _op(self, o, kind):
            if isinstance(o, P.Dual):
                return NotImplemented
            count[0] += 1
            return Chain(max(self.c, o.c if isinstance(o, Chain) else 0.0) + lat[kind])

        def __add__(self, o):
            return self._op(o, "add")

        __radd__ = __sub__ = __rsub__ = __add__

        def __mul__(self, o):
            return self._op(o, "mul")

        __rmul__ = __mul__

        def __truediv__(self, o):
            return self._op(o, "div")

        def __neg__(self):
            return self

        def __gt__(self, o):
            return Chain(max(self.c, o.c if isinstance(o, Chain) else 0.0))

        __lt__ = __gt__

        def expand_as(self, other):
            return self

        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            ready = max((a.c for a in args if isinstance(a, Chain)), default=0.0)
            if func is _torch.sqrt:
                count[0] += 1
                return Chain(ready + lat["sqrt"])
            if func in (_torch.maximum, _torch.minimum, _torch.where, _torch.abs):
                return Chain(ready)
            if func is _torch.zeros_like:
                return Chain()
            return NotImplemented

    def scalar():
        return Chain() if mode == "forward" else P.Dual(Chain(), Chain())

    def ready(state):
        return max(max(x.v.c, x.t.c) if isinstance(x, P.Dual) else x.c
                   for part in state for x in part)

    k = types.SimpleNamespace(**{name: Chain() for name in P.KERNEL_CONSTANTS})
    r, v, w = ((scalar(), scalar(), scalar()) for _ in range(3))
    for i in range(steps):
        count[0] = 0
        v, w = P._implicit_velocity_update(v, w, k)
        r = tuple(ri + k.DT * vi for ri, vi in zip(r, v))
        if i == steps // 2 - 1:
            mid = ready((r, v, w))
    return (ready((r, v, w)) - mid) / (steps - steps // 2), count[0]


def s1_cycles_per_step(entry, steps):
    """SM cycles per step at the boost clock of the timed calls: per call, back to back,
    and of one trajectory alone where it was timed."""
    keys = {"ms": "cycles_per_step", "ms_pipelined": "cycles_per_step_pipelined",
            "one_trajectory_ms": "one_trajectory_cycles_per_step"}
    return {c: entry[k] * 1e-3 * SM_CLOCK_HZ / steps for k, c in keys.items() if k in entry}


def s1_bound(mode, n, steps, out_bytes, in_bytes, lat):
    """S1's bound: the largest of its bytes over the HBM rate, its float operations over
    the f32 rate and its serial chain (`s1_chain`) at the boost clock. `bound_by` says
    bytes or operations, as the kernels line allows; `bound_term` names the term that
    won (the serial chain is one of operations)."""
    cycles, flops = s1_chain(lat, mode)
    threads = n * (1 if mode == "forward" else 9)
    terms = {"bytes": 1e3 * (out_bytes + in_bytes) / HBM_BYTES_PER_S,
             "operations": 1e3 * threads * steps * flops / FP32_FLOPS,
             "serial_chain": 1e3 * steps * cycles / SM_CLOCK_HZ}
    term = max(terms, key=terms.get)
    return {"bytes_ms": terms["bytes"], "ops_ms": terms["operations"],
            "chain_ms": terms["serial_chain"], "chain_cycles_per_step": cycles,
            "flops_per_step": flops, "op_latency_cycles": lat,
            "bound_ms": terms[term], "bound_term": term,
            "bound_by": "bytes" if term == "bytes" else "operations"}


def no_net_table(P, dtype, device, dt):
    """The plain version's constants with the net out of reach (|y| < -1 never holds):
    the planted fault that drops the net from the contact selection."""
    import types

    tab = vars(P._table(dtype, device, dt)).copy()
    tab["NET_Y_R"] = tab["NET_Y_R"] * 0 - 1.0
    return types.SimpleNamespace(**tab)


def fit_track(torch, state, n_obs=FIT_OBS, stride=FIT_STRIDE):
    """A flight observed through the simulation camera: (obs (T, 2), times (T,), truth
    (T, 3), Mint, Mext), numpy float32; state (r, v, w) of 3-tuples, simulated by S1."""
    import numpy as np

    from upliftingtabletennis_torch.core.geometry import world2img
    from upliftingtabletennis_torch.core.physics import BallState
    from upliftingtabletennis_torch.data.datagen import sim_camera
    from upliftingtabletennis_torch.ops import physics as S1

    s0 = BallState(*(torch.tensor([x], dtype=torch.float32, device=DEVICE) for x in state))
    r = S1.simulate(s0, (n_obs - 1) * stride + 1).r[::stride, 0]
    Mext, Mint = sim_camera(DEVICE)
    obs = world2img(r, Mext, Mint)
    times = np.arange(n_obs, dtype=np.float32) * stride / 500.0
    return (obs.cpu().numpy(), times, r.cpu().numpy(), Mint.cpu().numpy(), Mext.cpu().numpy())


def run_physics(torch, ptxas_report="", sass=None):
    """S1 against its plain version on the card, at the datagen and the fit shapes, with
    the planted faults; ms per call, cycles per step, the bound and the plain version's
    time; ptxas' registers and spills and the SASS facts of the step loops (from `sass`,
    the library's `s1_sass`, read here when None), the step anatomy probe and the check
    of the fast division and square root."""
    import numpy as np

    from upliftingtabletennis_torch.core import fitting as FIT
    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.ops import _build
    from upliftingtabletennis_torch.ops import physics as S1

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    lib = _build.library("physics.cu")
    res = {"ptxas": s1_ptxas(ptxas_report) if ptxas_report else "not rebuilt in this run",
           "sass": s1_sass_facts(s1_sass(_build, _build._lib_path("physics.cu"))
                                 if sass is None else sass)}
    for key in ("ptxas", "sass"):
        log("physics", **{key: json.dumps(res[key])})
    lat = s1_op_latency(torch)
    log("physics", op_latency_cycles=json.dumps(lat))
    res.update(op_latency_cycles=lat, fast_ops=s1_fast_ops_check(torch, lib),
               anatomy=s1_anatomy(torch, lib, FIT_STATES["topspin"]))
    for key in ("fast_ops", "anatomy"):
        log("physics", **{key: json.dumps(res[key])})
    res["forward"] = []
    for direction in DG.DIRECTIONS:
        s0 = DG.sample_initial_conditions(S1_BATCH, "intermediate", direction, gen, DEVICE)
        got = S1.simulate(s0, S1_FRAMES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = P.simulate(s0, S1_FRAMES, graph=True)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t)
        errs = s1_errors(torch, got, want)
        over = int(s1_over(torch, errs, S1_ATOL).sum())
        differ = int(torch.stack([e > 0 for e in errs]).any(0).sum())
        entry = {"direction": direction, "n": S1_BATCH, "frames": S1_FRAMES,
                 "over_limit": over, "bitwise_differing": differ,
                 "max_abs_err": {k: float(e.max()) for k, e in zip("rvw", errs)},
                 "plain_ms": plain_ms}
        if over > S1_KNIFE_EDGES["forward"] or differ:
            raise AssertionError(f"S1 forward ({direction}): {over} trajectories over the "
                                 f"limits {S1_ATOL}, {differ} not bit-equal: {entry}")
        if direction == DG.DIRECTIONS[0]:  # the planted fault: the net left out
            no_net = no_net_table(P, s0.r.dtype, s0.r.device, P.DT)
            with patched(P, _table=lambda *_: no_net):
                fault = P.simulate(s0, S1_FRAMES, graph=True)
            caught = int(s1_over(torch, s1_errors(torch, got, fault), S1_ATOL).sum())
            entry["fault_no_net_over_limit"] = caught
            if caught <= S1_KNIFE_EDGES["forward"]:
                raise AssertionError(f"S1 forward: the planted fault (no net) passes the "
                                     f"limits ({caught} trajectories over them)")
        steps = 1 + (S1_FRAMES - 1) * 2
        entry["ms"] = time_ms(torch, lambda: S1.simulate(s0, S1_FRAMES), iters=S1_TIMED_CALLS)
        entry["ms_pipelined"] = pipelined_ms(torch, lambda: S1.simulate(s0, S1_FRAMES),
                                             reps=S1_TIMED_CALLS)
        one = P.BallState(*(x[:1].contiguous() for x in s0))
        entry["one_trajectory_ms"] = time_ms(torch, lambda: S1.simulate(one, S1_FRAMES),
                                             iters=S1_TIMED_CALLS)
        entry.update(s1_bound("forward", S1_BATCH, steps, 9 * S1_FRAMES * S1_BATCH * 4,
                              9 * S1_BATCH * 4, lat))
        entry.update(s1_cycles_per_step(entry, steps))
        res["forward"].append(entry)
        log("physics", mode="forward", **{k: (f"{v:.4f}" if isinstance(v, float) else
                                              json.dumps(v)) for k, v in entry.items()})
        del got, want

    # tangent mode: the fit's 32 starts on the topspin track, 502 frames
    obs, times, _, Mint, Mext = fit_track(torch, FIT_STATES["topspin"], FIT_OBS_LONG)
    dev = torch.device(DEVICE)
    o, t_, m, Ki, Ke = (torch.as_tensor(a, device=dev) for a in
                        (obs, times, np.ones(len(obs), np.float32), Mint, Mext))
    st = FIT.default_inits(o, t_, m, Ki, Ke, FIT_STARTS,
                           torch.Generator(device=dev).manual_seed(0))
    args = (FIT_FRAMES, 2, P.DT, FIT.V_SCALE, FIT.W_SCALE)
    r, jac = S1.simulate_tangent(st, *args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rp, jp = P.simulate_tangent(st, *args, graph=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)

    def tangent_over(jac_got):
        r_err = (r - rp).abs().amax(dim=(0, 2))
        j_err = (jac_got - jp).abs().amax(dim=(0, 2, 3))
        j_lim = S1_JAC_RTOL * jp.abs().amax(dim=(0, 2, 3))
        return (~(r_err <= S1_ATOL[0])) | (~(j_err <= j_lim)), r_err, j_err / j_lim * S1_JAC_RTOL

    over, r_err, j_rel = tangent_over(jac)
    faulty = jac.clone()
    faulty[..., S1_FAULT_DIRECTION] = 0
    caught = int(tangent_over(faulty)[0].sum())
    entry = {"n": FIT_STARTS, "frames": FIT_FRAMES, "over_limit": int(over.sum()),
             "bitwise_differing": int(((r != rp).any(0).any(-1)
                                       | (jac != jp).any(0).any(-1).any(-1)).sum()),
             "max_abs_err": {"r": float(r_err.max()), "jac": float((jac - jp).abs().max())},
             "max_rel_jac_err": float(j_rel.max()), "fault_direction_zeroed_over_limit": caught,
             "plain_ms": plain_ms}
    if entry["over_limit"] > S1_KNIFE_EDGES["tangent"] or entry["bitwise_differing"]:
        raise AssertionError(f"S1 tangent: {entry}")
    if caught <= S1_KNIFE_EDGES["tangent"]:
        raise AssertionError(f"S1 tangent: the planted fault (direction {S1_FAULT_DIRECTION} "
                             f"zeroed) passes the limits ({caught} over them)")
    entry["ms"] = time_ms(torch, lambda: S1.simulate_tangent(st, *args), iters=S1_TIMED_CALLS)
    entry["ms_pipelined"] = pipelined_ms(torch, lambda: S1.simulate_tangent(st, *args),
                                         reps=S1_TIMED_CALLS)
    one = P.BallState(*(x[:1].contiguous() for x in st))
    entry["one_trajectory_ms"] = time_ms(torch, lambda: S1.simulate_tangent(one, *args),
                                         iters=S1_TIMED_CALLS)
    steps = 1 + (FIT_FRAMES - 1) * 2
    entry.update(s1_bound("tangent", FIT_STARTS, steps, 40 * FIT_FRAMES * FIT_STARTS * 3,
                          9 * FIT_STARTS * 4, lat))
    entry.update(s1_cycles_per_step(entry, steps))
    # the physics-fit evaluation's batch: 16 tracks x 32 starts
    wide = P.BallState(*(x.repeat(S1_EVAL_STARTS // FIT_STARTS, 1) for x in st))
    entry["eval_batch"] = {"n": S1_EVAL_STARTS, "frames": FIT_FRAMES,
                           "ms": time_ms(torch, lambda: S1.simulate_tangent(wide, *args),
                                         iters=S1_TIMED_CALLS),
                           "ms_pipelined": pipelined_ms(
                               torch, lambda: S1.simulate_tangent(wide, *args),
                               reps=S1_TIMED_CALLS)}
    entry["eval_batch"].update(s1_cycles_per_step(entry["eval_batch"], steps))
    res["tangent"] = entry
    log("physics", mode="tangent", **{k: (f"{v:.4f}" if isinstance(v, float) else json.dumps(v))
                                      for k, v in entry.items()})
    return res


def datagen_cpu_check(res, s0_cpu, card):
    """datagen's gate on the first batch's candidates: `validate_candidates` on the CPU's
    plain path (s0_cpu: a BallState of CPU tensors) against the card's result `card`
    (accept, n_bounces, positions on the host): the accept mask and the bounce counts
    agree on at least DATAGEN_CPU_AGREEMENT of them. Fills res["cpu_check"]."""
    from upliftingtabletennis_torch.data import datagen as DG

    t = time.perf_counter()
    cpu = DG.validate_candidates(s0_cpu, "intermediate", "left_to_right")
    cpu_s = time.perf_counter() - t
    acc_agree = float((card["accept"] == cpu["accept"]).float().mean())
    nb_agree = float((card["n_bounces"] == cpu["n_bounces"]).float().mean())
    res["cpu_check"] = {"accept_agreement": acc_agree, "n_bounces_agreement": nb_agree,
                        "accepted_card": int(card["accept"].sum()),
                        "accepted_cpu": int(cpu["accept"].sum()), "cpu_seconds": cpu_s,
                        "positions_max_abs_diff": float((card["positions"]
                                                         - cpu["positions"]).abs().max())}
    log("datagen", cpu_check=json.dumps(res["cpu_check"]))
    if min(acc_agree, nb_agree) < DATAGEN_CPU_AGREEMENT:
        raise AssertionError(f"datagen: the card and the CPU agree on too few candidates: "
                             f"{res['cpu_check']}")


def run_datagen(torch, later, profile=False):
    """generate_dataset("intermediate") at the production batch until DATAGEN_ACCEPTED
    accepted (the main path of datagen, launches counted), twice; then the first batch's
    candidates again on the card, and on the CPU's plain path (`datagen_cpu_check`,
    appended to `later`, which the card_tests phase runs)."""
    import numpy as np

    from upliftingtabletennis_torch.core.physics import BallState
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.ops import physics as S1

    res = {"calls": []}
    for call in ("cold", "warm"):
        S1.simulate.launches = S1.simulate_tangent.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = DG.generate_dataset(DATAGEN_ACCEPTED, "intermediate", "left_to_right",
                                  batch=DATAGEN_BATCH,
                                  generator=torch.Generator(device=DEVICE).manual_seed(0),
                                  device=DEVICE)
        seconds = time.perf_counter() - t
        launches = S1.simulate.launches
        batches = out["candidates"] // DATAGEN_BATCH
        n = len(out["positions"])
        entry = {"call": call, "accepted": n, "batches": batches, "seconds": seconds,
                 "trajectories_per_s": n / seconds,
                 "acceptance": out["accepted_total"] / out["candidates"],
                 "launches": launches, "launches_per_batch": launches / batches,
                 "tangent_launches": S1.simulate_tangent.launches}
        res["calls"].append(entry)
        log("datagen", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                          for k, v in entry.items()})
        if n != DATAGEN_ACCEPTED or launches != batches or S1.simulate_tangent.launches:
            raise AssertionError(f"datagen: {entry}")
        if not (np.isfinite(out["positions"]).all() and out["frame_valid"].sum(1).min()
                >= DG.MIN_TRAJ_LEN_FRAMES):
            raise AssertionError("datagen: non-finite or short accepted trajectories")
    res["launches"] = res["calls"][-1]["launches"]
    if profile:
        res["profile"] = profile_calls(
            torch, lambda: DG.generate_dataset(DATAGEN_ACCEPTED, batch=DATAGEN_BATCH,
                                               generator=torch.Generator(device=DEVICE)
                                               .manual_seed(0), device=DEVICE),
            f"one warm generate_dataset call ({DATAGEN_ACCEPTED} accepted, batch "
            f"{DATAGEN_BATCH})")
    res["tracks"] = [tuple(out[k][i, 0] for k in ("positions", "velocities", "rotations"))
                     for i in range(FIT_DATAGEN_TRACKS)]
    res["track_frames"] = [int(out["frame_valid"][i].sum())
                           for i in range(FIT_DATAGEN_TRACKS)]

    # the first batch's candidates (the generator's first draws) on the card (S1), and
    # later on the CPU (the plain version)
    s0 = DG.sample_initial_conditions(DATAGEN_BATCH, "intermediate", "left_to_right",
                                      torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    card = DG.validate_candidates(s0, "intermediate", "left_to_right")
    later.append(functools.partial(
        datagen_cpu_check, res, BallState(*(x.cpu() for x in s0)),
        {k: card[k].cpu() for k in ("accept", "n_bounces", "positions")}))
    return res


def run_fit(torch, pipe, datagen_tracks, profile=False):
    """TableTennisPipeline.fit_physics at its defaults on the two test states and, over
    1 s, on them and FIT_DATAGEN_TRACKS accepted datagen trajectories (each once), and one
    warm start; launches counted per call."""
    import numpy as np

    from upliftingtabletennis_torch.core import fitting as FIT
    from upliftingtabletennis_torch.core import geometry as G
    from upliftingtabletennis_torch.ops import physics as S1

    cases = {name: (state, FIT_OBS) for name, state in FIT_STATES.items()}
    cases.update({f"{name}_1s": (state, FIT_OBS_LONG) for name, state in FIT_STATES.items()})
    for i, state in enumerate(datagen_tracks):
        cases[f"datagen_{i}_1s"] = (tuple(tuple(float(c) for c in x) for x in state),
                                    FIT_OBS_LONG)
    res = {"cases": {}}

    def fit(obs, times, Mint, Mext, **kw):
        S1.simulate.launches = S1.simulate_tangent.launches = 0
        t = time.perf_counter()
        out = pipe.fit_physics(obs, times, Mint, Mext, **kw)
        seconds = time.perf_counter() - t
        launches = {"simulate": S1.simulate.launches,
                    "simulate_tangent": S1.simulate_tangent.launches}
        if launches != FIT_LAUNCHES:
            raise AssertionError(f"fit_physics launched {launches}, expected {FIT_LAUNCHES}")
        return out, seconds, launches

    for name, (state, n_obs) in cases.items():
        obs, times, truth, Mint, Mext = fit_track(torch, state, n_obs)
        # once each: no gate reads a second call (the witness fits below are warm calls)
        (spin, pos, r), seconds, launches = fit(obs, times, Mint, Mext)
        err_cm = 100 * np.linalg.norm(pos - truth, axis=-1)
        cls = float(FIT.spin_class_from_fit(r))
        true_local = G.transform_rotation_axes(torch.tensor(state[2]), torch.from_numpy(truth))
        entry = {"detections": n_obs,
                 "n_frames": int(np.ceil((float(times[-1]) + 1e-3) / 0.25)) * 125 + 2,
                 "seconds": seconds,
                 "mean_err_cm": float(err_cm.mean()), "max_err_cm": float(err_cm.max()),
                 "reproj_px": float(r.reproj_px), "basin_spread_m": float(r.basin_spread_m),
                 "spin_class": cls, "true_spin_class": 1.0 if true_local[1] > 0 else 2.0,
                 "spin_local": [float(x) for x in spin], "launches": launches}
        res["cases"][name] = entry
        log("fit", case=name, **{k: (f"{v:.4f}" if isinstance(v, float) else json.dumps(v))
                                 for k, v in entry.items()})
        if name in FIT_SPIN_CLASS and not (entry["mean_err_cm"] < FIT_GATE_CM
                                           and cls == FIT_SPIN_CLASS[name]):
            raise AssertionError(f"fit_physics on {name}: {entry}")

    # the warm start: seeded with the topspin truth, positions perturbed by 2 cm
    obs, times, truth, Mint, Mext = fit_track(torch, FIT_STATES["topspin"])
    spin_local = G.transform_rotation_axes(torch.tensor(FIT_STATES["topspin"][2]),
                                           torch.from_numpy(truth)).numpy()
    pos3d = truth + 0.02 * np.random.default_rng(0).normal(size=truth.shape).astype(np.float32)
    (spin, pos, r), s, launches = fit(obs, times, Mint, Mext, init=(spin_local, pos3d))
    err = float((100 * np.linalg.norm(pos - truth, axis=-1)).mean())
    res["warm_start"] = {"seconds": s, "mean_err_cm": err, "reproj_px": float(r.reproj_px),
                         "spin_sign_ok": bool(np.sign(spin[1]) == np.sign(spin_local[1]))}
    log("fit", case="warm_start", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                                     for k, v in res["warm_start"].items()})
    if not (err < FIT_GATE_CM and res["warm_start"]["spin_sign_ok"]):
        raise AssertionError(f"fit_physics warm start: {res['warm_start']}")
    res["launches"] = launches  # counted over this last fit_physics call
    res["witness"] = fit_witness(torch, fit)
    if profile:
        obs, times, _, Mint, Mext = fit_track(torch, FIT_STATES["topspin"])
        res["profile"] = profile_calls(torch, lambda: pipe.fit_physics(obs, times, Mint, Mext),
                                       f"one warm fit_physics call ({FIT_OBS} detections)")
    return res


def fit_witness(torch, fit):
    """The 1 s tracks against the JAX fit on the same starts: tests/fit_witness_1s.npz
    (tests/make_fit_witness.py) holds the two test states observed over 0.98 s by the JAX
    package, JAX's draws of `default_inits` from PRNGKey(k) for each k in it, and the
    JAX fit's outcome on the CPU from them. fit_physics fits the same observations from
    the same draws (`draws=`) on the card. Gates: where the JAX fit recovers the state
    (mean 3D error under FIT_GATE_CM and the spin class), the port must too; on every
    draw the port must reach JAX's outcome (the same spin class, mean errors within
    FIT_GATE_CM of each other)."""
    import numpy as np

    from upliftingtabletennis_torch.core import fitting as FIT

    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                             "fit_witness_1s.npz"))
    res = {}
    for name in FIT_STATES:
        obs, times, truth, Mint, Mext = (d[f"{name}/{k}"] for k in
                                         ("obs", "times", "truth", "Mint", "Mext"))
        keys = sorted({int(k.split("/")[1][3:]) for k in d.files
                       if k.startswith(f"{name}/key")})
        for key in keys:
            p = f"{name}/key{key}/"
            draws = {k: d[p + k] for k in ("z_t", "v_mult", "v_noise", "w_noise")}
            (spin, pos, r), seconds, launches = fit(obs, times, Mint, Mext, draws=draws)
            err = float((100 * np.linalg.norm(pos - truth, axis=-1)).mean())
            cls = float(FIT.spin_class_from_fit(r))
            jax_err, jax_cls = float(d[p + "mean_err_cm"]), float(d[p + "spin_class"])
            entry = {"mean_err_cm": err, "spin_class": cls, "reproj_px": float(r.reproj_px),
                     "basin_spread_m": float(r.basin_spread_m), "seconds": seconds,
                     "jax_mean_err_cm": jax_err, "jax_spin_class": jax_cls,
                     "jax_reproj_px": float(d[p + "reproj_px"]),
                     "jax_basin_spread_m": float(d[p + "basin_spread_m"]),
                     "recovered": err < FIT_GATE_CM and cls == FIT_SPIN_CLASS[name],
                     "jax_recovered": jax_err < FIT_GATE_CM and jax_cls == FIT_SPIN_CLASS[name],
                     "same_outcome": cls == jax_cls and abs(err - jax_err) < FIT_GATE_CM}
            res[f"{name}_key{key}"] = entry
            log("fit", witness=f"{name}_key{key}",
                **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in entry.items()})
            if (entry["jax_recovered"] and not entry["recovered"]) or not entry["same_outcome"]:
                raise AssertionError(f"fit_physics over 1 s on {name} from JAX's draws of "
                                     f"PRNGKey({key}) does not reach the JAX fit's outcome: "
                                     f"{entry}")
    return res


def uplift_update_deltas(UT, start, grads, device, **kw):
    """The changes of the parameters, EMA and both Adam moments (CPU tensors) that one
    `apply_update` on `device` makes to the start state (dict of CPU tensor lists)."""
    groups = UT.TrainState._fields[:4]
    st = UT.TrainState(*[[t.to(device).clone() for t in start[g]] for g in groups], [0])
    UT.apply_update(st, [g.to(device) for g in grads], **kw)
    return {g: [a.cpu() - b for a, b in zip(getattr(st, g), start[g])] for g in groups}


def uplift_update_errs(got, want):
    """Per group, the largest |got - want| of a tensor over that tensor's largest |want|."""
    return {g: max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(got[g], want[g])) for g in want}


def run_uplift_train(torch, profile=False):
    """The uplifting trainer at full width: the corpus by generate_production, a synthetic
    TTST set, gates 1-3 (assembly and one step on the card against the CPU, planted faults,
    60 steps on one batch), step timing, and the CLI over two epochs and a resume, whose
    checkpoint hub.uplifting loads and run_uplifting_eval scores."""
    import argparse
    import copy
    import tempfile

    import numpy as np

    from upliftingtabletennis_torch import hub
    from upliftingtabletennis_torch.core.geometry import HEIGHT, WIDTH
    from upliftingtabletennis_torch.data import augment as A
    from upliftingtabletennis_torch.data import generate_production, make_synthetic_ttst
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.eval import run_uplifting_eval
    from upliftingtabletennis_torch.models.uplifting import get_uplifting_model, reference_init
    from upliftingtabletennis_torch.ops import physics as S1
    from upliftingtabletennis_torch.train import run_uplifting
    from upliftingtabletennis_torch.train import uplifting_train as UT

    res = {"card": CARD}

    def fresh_model():
        """The trainer's starting point: the JAX model's initialisation, seed 0."""
        return reference_init(get_uplifting_model(), torch.Generator().manual_seed(0))

    def on(device, tree):
        """A copy of a tree of tensors (dicts, tuples, named tuples) on `device`."""
        if isinstance(tree, dict):
            return {k: on(device, v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(on(device, v) for v in tree)) if hasattr(tree, "_fields") \
                else tuple(on(device, v) for v in tree)
        return tree.to(device) if torch.is_tensor(tree) else tree

    with tempfile.TemporaryDirectory() as root:
        data_dir, ttst_dir = os.path.join(root, "data"), os.path.join(root, "ttst")
        # the corpus: one S1 launch per candidate batch
        S1.simulate.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        shards = generate_production.main(
            ["--out", data_dir, "--scale", str(UPLIFT_SCALE), "--batch", str(UPLIFT_GEN_BATCH),
             "--max_seconds_per_shard", str(UPLIFT_CAP_S), "--device", DEVICE])
        gen_s = time.perf_counter() - t
        total = sum(e["accepted"] for e in shards)
        by_mode = {}
        for e in shards:
            m = by_mode.setdefault(e["mode"], {"accepted": 0, "seconds": 0.0, "candidates": 0})
            for k in m:
                m[k] += e[k]
        for m in by_mode.values():
            m["trajectories_per_s"] = m["accepted"] / m["seconds"]
            m["acceptance"] = m["accepted"] / m["candidates"]
        res["generation"] = {"shards": shards, "by_mode": by_mode, "seconds": gen_s,
                             "accepted": total, "trajectories_per_s": total / gen_s,
                             "s1_launches": S1.simulate.launches}
        log("uplift_train", step="generate", accepted=total, seconds=f"{gen_s:.2f}",
            trajectories_per_s=f"{total / gen_s:.1f}", s1_launches=S1.simulate.launches,
            by_mode=json.dumps({k: round(v["trajectories_per_s"], 1)
                                for k, v in by_mode.items()}), card=json.dumps(CARD))
        if len(shards) != 12 or min(e["accepted"] for e in shards) < 1:
            raise AssertionError(f"generate_production wrote {shards}")
        n_ttst = make_synthetic_ttst.write_synthetic_ttst(root, UPLIFT_TTST, device=DEVICE)
        if n_ttst != UPLIFT_TTST:
            raise AssertionError(f"make_synthetic_ttst wrote {n_ttst} trajectories")
        store, train_idx, val_idx = run_uplifting.build_store(
            argparse.Namespace(data_dir=data_dir, generate=0), DEVICE)
        store_d, store_c = SYN.store_to_device(store, DEVICE), SYN.store_to_device(store, "cpu")
        if not np.isfinite(store.blur_positions).all():
            raise AssertionError("non-finite trajectories in the generated shards")

        # gate 1: the assembly and the augmentations on the card against the CPU
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        idx = torch.as_tensor(train_idx[:UPLIFT_BATCH])
        draws = SYN.draw_batch(UPLIFT_BATCH, True, gen, DEVICE)
        aug = A.draw_augment(UPLIFT_BATCH, SYN.SEQUENCE_LEN, A.AugmentConfig(), gen, DEVICE)
        card = SYN.assemble_batch_from_draws(store_d, idx.to(DEVICE), draws)
        cpu = SYN.assemble_batch_from_draws(store_c, idx, on("cpu", draws))
        same = card["camera_pick"].cpu() == cpu["camera_pick"]
        card_aug = A.train_augment(card, draws=aug)
        cpu_aug = A.train_augment(cpu, draws=on("cpu", aug))
        wh = torch.tensor([float(WIDTH), float(HEIGHT)])  # the augmented batch is normalised
        g1 = {"pick_differs": int((~same).sum()), "found": int(card["camera_found"].sum()),
              "px": float((card["r_img"].cpu() - cpu["r_img"])[same].abs().max()),
              "px_augmented": float(((card_aug["r_img"].cpu() - cpu_aug["r_img"]) * wh)[same]
                                    .abs().max()),
              "masks_equal": bool((card_aug["mask"].cpu() == cpu_aug["mask"])[same].all())}
        res["gate1"] = g1
        log("uplift_train", step="gate1", **{k: json.dumps(v) for k, v in g1.items()})
        if not (g1["pick_differs"] <= UPLIFT_PICK_KNIFE_EDGES and g1["masks_equal"]
                and max(g1["px"], g1["px_augmented"]) <= UPLIFT_PX_ATOL):
            raise AssertionError(f"the batch assembly on the card differs from the CPU: {g1}")

        # gate 2: one training step on the card against the CPU, then the update
        model_c = fresh_model()
        model_d = copy.deepcopy(model_c).to(DEVICE)
        batch_d = UT.batch_from(card_aug)
        batch_c = UT.Batch(*on("cpu", tuple(batch_d)))
        offset = torch.Generator().manual_seed(1)
        params = [p.detach().clone() for p in model_c.parameters()]
        start = {"params": params,
                 "ema": [p + UPLIFT_EMA_OFFSET * torch.randn(p.shape, generator=offset)
                         for p in params],
                 "mu": [torch.zeros_like(p) for p in params],
                 "nu": [torch.zeros_like(p) for p in params]}
        loss_d, _ = UT.loss_fn(model_d, batch_d)
        grads_d = torch.autograd.grad(loss_d, list(model_d.parameters()))
        t = time.perf_counter()
        loss_c, _ = UT.loss_fn(model_c, batch_c)
        grads_c = torch.autograd.grad(loss_c, list(model_c.parameters()))
        cpu_step_s = time.perf_counter() - t
        names = [n for n, _ in model_c.named_parameters()]
        grad_err = {n: float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    for n, a, b in zip(names, grads_d, grads_c)}
        g_norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads_c])))
        loss_rel = abs(loss_d.item() - loss_c.item()) / abs(loss_c.item())
        grads_d_cpu = [g.cpu() for g in grads_d]
        want = uplift_update_deltas(UT, start, grads_d_cpu, "cpu")
        upd = uplift_update_errs(uplift_update_deltas(UT, start, grads_d, DEVICE), want)
        faults = {name: uplift_update_errs(uplift_update_deltas(UT, start, grads_d, DEVICE, **kw),
                                           want)
                  for name, kw in (("no_clip", {"max_norm": float("inf")}),
                                   ("ema_not_updated", {"ema_decay": 1.0}))}
        worst = max(grad_err, key=grad_err.get)
        res["gate2"] = {"loss_card": loss_d.item(), "loss_cpu": loss_c.item(),
                        "loss_rel_err": loss_rel, "grad_rel_err": grad_err,
                        "worst_grad": worst, "grad_norm": g_norm, "update_rel_err": upd,
                        "faults": faults, "cpu_step_s": cpu_step_s}
        log("uplift_train", step="gate2", loss_rel_err=f"{loss_rel:.3g}",
            worst_grad=worst, worst_grad_rel_err=f"{grad_err[worst]:.3g}",
            grad_norm=f"{g_norm:.4g}", update_rel_err=json.dumps(upd),
            faults=json.dumps(faults), cpu_step_s=f"{cpu_step_s:.2f}")
        if not (loss_rel <= UPLIFT_LOSS_RTOL and grad_err[worst] <= UPLIFT_GRAD_REL
                and max(upd.values()) <= UPLIFT_UPDATE_REL):
            raise AssertionError(f"one training step on the card differs from the CPU: loss "
                                 f"{loss_rel}, {worst} {grad_err[worst]}, update {upd}")
        if g_norm < 2 * UT.CLIP_NORM:
            raise AssertionError(f"the gradient's norm {g_norm} is too small for the clip "
                                 f"fault to show")
        for name, errs in faults.items():
            if not max(errs.values()) > UPLIFT_UPDATE_REL:
                raise AssertionError(f"gate 2 does not see the planted fault {name}: {errs}")
        del model_c, grads_c, batch_c, model_d, grads_d

        # gate 3: the JAX test's 60 steps from its weights and batch
        def fit_losses(model, batch):
            state = UT.init_train_state(model.to(DEVICE))
            return torch.stack([UT.train_step(model, state, batch, UPLIFT_FIT_LR)["loss"]
                                for _ in range(UPLIFT_FIT_STEPS)]).cpu().numpy()

        with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                  "uplift_witness_60.npz")) as z:
            witness = {k: z[k] for k in z.files}
        small = get_uplifting_model(size="small")
        small.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in witness.items()
                               if k.startswith("param.")})
        losses = fit_losses(small, UT.Batch(*(torch.from_numpy(witness[f]).to(DEVICE)
                                              for f in UT.Batch._fields)))
        want = witness["losses"]
        res["gate3"] = {"losses": losses.tolist(), "jax_losses": want.tolist(),
                        "ratio": float(losses[-1] / losses[0]),
                        "jax_ratio": float(want[-1] / want[0]),
                        "rel_err": float(np.max(np.abs(losses - want) / want))}
        log("uplift_train", step="gate3", **{k: f"{v:.4g}" for k, v in res["gate3"].items()
                                             if isinstance(v, float)})
        if not (losses[-1] < UPLIFT_FIT_RATIO * losses[0]
                and res["gate3"]["rel_err"] <= UPLIFT_FIT_RTOL):
            raise AssertionError(f"{UPLIFT_FIT_STEPS} steps on the JAX test's batch: {losses} "
                                 f"against JAX's {want}")

        # the step at full width: assembly + augmentations, then forward, backward, clip,
        # Adam and EMA, as the CLI runs them
        model = fresh_model().to(DEVICE)
        state = UT.init_train_state(model)
        train_d = torch.as_tensor(train_idx, device=DEVICE)

        def assemble():
            sel = train_d[torch.randperm(len(train_d), generator=gen, device=DEVICE)[:UPLIFT_BATCH]]
            return A.train_augment(SYN.assemble_batch(store_d, sel, generator=gen), generator=gen)

        def step(sample):
            return UT.train_step(model, state, UT.batch_from(sample))

        for _ in range(3):
            step(assemble())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        asm_ms, step_ms = [], []
        for _ in range(UPLIFT_TIMED_STEPS):
            t0 = time.perf_counter()
            sample = assemble()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(sample)
            torch.cuda.synchronize()
            asm_ms.append(1e3 * (t1 - t0))
            step_ms.append(1e3 * (time.perf_counter() - t1))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        sample = assemble()
        asm_p, step_p, both_p = (
            profile_calls(torch, fn, what, calls=UPLIFT_PROFILED_STEPS, quiet=True)
            for fn, what in ((assemble, "assembly"), (lambda: step(sample), "step"),
                             (lambda: step(assemble()), "assembly and step")))
        asm_launches, asm_busy = asm_p["launches"], asm_p["device_busy_ms"]
        step_launches, step_busy = step_p["launches"], step_p["device_busy_ms"]
        busy, wall = both_p["device_busy_ms"], both_p["wall_ms"]
        timing = {"assembly_ms": statistics.median(asm_ms), "step_ms": statistics.median(step_ms),
                  "assembly_ms_range": [min(asm_ms), max(asm_ms)],
                  "step_ms_range": [min(step_ms), max(step_ms)],
                  "assembly_launches": asm_launches, "step_launches": step_launches,
                  "assembly_device_ms": asm_busy, "step_device_ms": step_busy,
                  "profiled_wall_ms": wall, "profiled_device_ms": busy,
                  "idle_share": 1 - busy / wall, "peak_mem_gb": peak_gb}
        timing["trajectories_per_s"] = 1e3 * UPLIFT_BATCH / (timing["assembly_ms"]
                                                             + timing["step_ms"])
        res["timing"] = timing
        log("uplift_train", step="timing", card=json.dumps(CARD),
            **{k: (f"{v:.4g}" if isinstance(v, float) else json.dumps(v))
               for k, v in timing.items()})
        if profile:
            res["profile"] = profile_calls(torch, lambda: step(assemble()),
                                           f"one warm uplifting training step (batch "
                                           f"{UPLIFT_BATCH}, assembly included)")
        del model, state

        # gates 5 and 6: the CLI over two epochs, a resume for a third, the checkpoints
        ck, runs = os.path.join(root, "ckpt"), os.path.join(root, "runs")
        common = ["--data_dir", data_dir, "--ttst_dir", ttst_dir, "--save_dir", ck,
                  "--logdir", runs, "--save_latest_every", "1", "--seed", "0",
                  "--device", DEVICE] + (["--profile"] if profile else [])
        t = time.perf_counter()
        first = run_uplifting.main(common + ["--num_epochs", "2"])
        first_s = time.perf_counter() - t
        latest = os.path.join(first["run_dir"], "latest")
        t = time.perf_counter()
        second = run_uplifting.main(common + ["--num_epochs", "3", "--resume", latest])
        second_s = time.perf_counter() - t
        final = run_uplifting.state_dict_of(get_uplifting_model(), first["state"])
        unequal = [k for k, v in final.items() if not torch.equal(v.cpu(),
                                                                 second["resume_state"][k])]
        best, replay = dict(run_uplifting.INITIAL_BEST), []
        for rec in first["history"] + second["history"]:
            names, best = run_uplifting.save_decisions(best, rec["metric_traj"],
                                                       rec["metric_spin"], rec["val/metric"])
            replay.append(names)
        recorded = [rec["saved"] for rec in first["history"] + second["history"]]
        missing = [n for n in set(sum(recorded, [])) if not os.path.isfile(
            os.path.join(first["run_dir"], n))]
        name = "model_synthetic"
        _, ema_sd = second["saved"].get(name) or first["saved"][name]
        up = hub.uplifting(checkpoint=os.path.join(first["run_dir"], name), device=DEVICE)
        val_batch = UT.batch_from(A.eval_augment(SYN.assemble_batch(
            store_d, torch.as_tensor(val_idx[:UPLIFT_BATCH]), train=False)))
        ref = get_uplifting_model()
        ref.load_state_dict(ema_sd)
        ref.to(DEVICE).eval()
        with torch.no_grad():
            inputs = (val_batch.ball_img, val_batch.table_img, val_batch.mask, val_batch.times)
            hub_equal = all(torch.equal(a, b) for a, b in zip(up.model(*inputs), ref(*inputs)))
        cli = {"first_s": first_s, "second_s": second_s,
               "start_epoch": second["start_epoch"], "state_unequal": unequal,
               "saved": recorded, "replayed": replay, "missing": missing,
               "hub_equal": hub_equal, "transform_mode": up.transform_mode,
               "epochs": [{k: v for k, v in rec.items() if not k.startswith("val/sign")}
                          for rec in first["history"] + second["history"]]}
        res["cli"] = cli
        log("uplift_train", step="cli", first_s=f"{first_s:.1f}", second_s=f"{second_s:.1f}",
            start_epoch=second["start_epoch"], state_unequal=len(unequal),
            saved=json.dumps(recorded), hub_equal=hub_equal)
        if not (second["start_epoch"] == 2 and not unequal and replay == recorded
                and not missing and hub_equal and up.transform_mode == "global"):
            raise AssertionError(f"the CLI's resume or checkpoints are wrong: {cli}")
        out = run_uplifting_eval.main(["--checkpoint", os.path.join(first["run_dir"], name),
                                       "--ttst_dir", ttst_dir, "--device", DEVICE])
        res["eval"] = out["ttst"]
        if list(out["ttst"]) != ["Identity", "HalfFPS", "Drop", "Combine"] or not all(
                np.isfinite(v) for m in out["ttst"].values() for v in m.values()):
            raise AssertionError(f"run_uplifting_eval gave {out['ttst']}")
        log("uplift_train", step="eval", ttst=json.dumps(
            {k: round(v["mean_2d_px"], 2) for k, v in out["ttst"].items()}))
    return res


def cl_weights(name):
    """A committed closed-loop checkpoint of the port."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "upliftingtabletennis_torch",
                        "weights", "closed_loop", name)


def cl_peak_check(torch, det, items):
    """The detector's peaks (kernel path, bf16) against a kernels=False f32 copy's on the
    same bf16-rounded inputs, with the copy run in bf16 beside them, over `items` (N, H,
    W, C) uint8 on the card at the model's resolution, in chunks of HR_CHUNK. Returns the
    detections (a peak of at least CL_PEAK_MIN on either path), the share free of a
    charge to the kernels (see CL_PEAK_SHARE), and each path's shares and worst px."""
    import numpy as np

    from upliftingtabletennis_torch.data.image_transforms import normalize_image
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.ops.peak import extract_peaks
    from upliftingtabletennis_torch.pipeline.interface import HEIGHT, WIDTH

    ref, _ = get_detector(det.model_name, det.task, kernels=False, resolution=det.resolution)
    ref.load_state_dict(det.model.state_dict())
    ref.eval().to(DEVICE)
    d_k, d_b, d_kb = [], [], []  # kernel-f32, bf16 copy-f32, kernel-bf16 copy, px
    n = charged = missed = weak = 0
    with torch.no_grad():
        for s in range(0, len(items), HR_CHUNK):
            x = normalize_image(items[s:s + HR_CHUNK].float()).to(det.dtype)
            p = {}
            for what, model, dtype in (("kernel", det.model, det.dtype),
                                       ("bf16", ref, torch.bfloat16),
                                       ("f32", ref, torch.float32)):
                out = model(x.to(dtype))
                heat = (out[0] if isinstance(out, tuple) else out).permute(0, 3, 1, 2).float()
                p[what] = extract_peaks(heat, WIDTH, HEIGHT, CL_PEAK_MIN)
            seen = {k: v[..., 2] > 0 for k, v in p.items()}
            both = seen["kernel"] & seen["f32"]
            missed += int((seen["kernel"] ^ seen["f32"]).sum())
            n_c, charged_c = peak_rule(p["kernel"][..., :2], p["bf16"][..., :2],
                                       p["f32"][..., :2], seen["kernel"], seen["f32"])
            n, charged = n + n_c, charged + charged_c
            weak += int((~seen["kernel"] & ~seen["f32"]).sum())

            def dist(a, b):
                return torch.linalg.norm(p[a][..., :2] - p[b][..., :2], dim=-1)[both].tolist()

            d_k += dist("kernel", "f32")
            d_b += dist("bf16", "f32")
            d_kb += dist("kernel", "bf16")
    del ref
    torch.cuda.empty_cache()
    k, b, kb = (np.asarray(v or [0.0]) for v in (d_k, d_b, d_kb))
    return {"detections": n, "seen_by_one_path": missed, "below_min": weak,
            "charged_to_kernels": charged, "share_free": 1 - charged / max(n, 1),
            "kernel_vs_f32": {"within_near": float((k <= CL_PEAK_NEAR).mean()),
                              "within": float((k <= CL_PEAK_PX).mean()),
                              "worst_px": float(k.max())},
            "bf16_plain_vs_f32": {"within_near": float((b <= CL_PEAK_NEAR).mean()),
                                  "within": float((b <= CL_PEAK_PX).mean()),
                                  "worst_px": float(b.max())},
            "kernel_vs_bf16_plain": {"within_near": float((kb <= CL_PEAK_NEAR).mean()),
                                     "within": float((kb <= CL_PEAK_PX).mean()),
                                     "worst_px": float(kb.max())}}


def rally_tthq(root, store_d, ti, pool):
    """A TTHQ layout (video 1, the val/test pool) of the first EV_DET_FRAMES frames of
    held-out rally `ti`, rendered at 1920x1080 on the card, labelled with the simulation's
    truth: the ball in every frame but the first and last, the 13 table keypoints (visible
    where inside the frame). The files are written on `pool`: its future."""
    from upliftingtabletennis_torch.eval import closed_loop as CL

    sample, T, frames = CL.render_held_out(store_d, ti, 0)
    n = min(EV_DET_FRAMES, T)
    ball = sample["ball_eval"][:n].cpu().numpy()
    table = sample["table_eval"].cpu().numpy()
    return pool.submit(write_tthq, root, frames[:n].cpu().numpy(), ball, table)


def write_tthq(root, frames, ball, table):
    """`rally_tthq`'s files: the frames as PNGs and the two label CSVs."""
    from upliftingtabletennis_torch.data.png import write_png

    n = len(frames)
    inside = (table[:, 0] >= 0) & (table[:, 0] < 1920) & (table[:, 1] >= 0) & (table[:, 1] < 1080)
    os.makedirs(os.path.join(root, "tthq", "01"))
    for f, frame in enumerate(frames):
        write_png(os.path.join(root, "tthq", "01", f"01_{f:06d}.png"), frame)
    rows = ["video;frame;ball_x;ball_y;ball_flag"]
    table_rows = ["video;frame;" + ";".join(f"point_{k}_x;point_{k}_y;point_{k}_flag"
                                            for k in range(1, 14))]
    for f in range(1, n - 1):
        rows.append(f"1;{f};{ball[f, 0]:.4f};{ball[f, 1]:.4f};2")
        table_rows.append(f"1;{f};" + ";".join(f"{x:.4f};{y:.4f};{2 if ok else 0}"
                                               for (x, y), ok in zip(table, inside)))
    with open(os.path.join(root, "tthq", "ball_detection.csv"), "w") as fh:
        fh.write("\n".join(rows))
    with open(os.path.join(root, "tthq", "table_detection.csv"), "w") as fh:
        fh.write("\n".join(table_rows))


def ev_detection_check(torch, res, det_dir, card):
    """closed_loop (d)'s gate on run_detection_eval: the committed detectors' f32
    detections on the CPU of `rally_tthq`'s test samples (in `det_dir`, removed after)
    against the card's and its bf16 plain copy's (`card`: {task: (preds, gts, bf16 preds,
    seconds)} on the host) under the peak rule. Fills res["detection"]."""
    from upliftingtabletennis_torch.eval import run_detection_eval as DE

    det_res, n_all, charged_all = {}, 0, 0
    for task in ("ball", "table"):
        det, _ = DE.load_detector(task, cl_weights(f"{task}_detector"), device="cpu")
        f32, f32_gts = DE.detections(task, det, det_dir.name, 4, limit=EV_DET_LIMIT[task])
        preds, gts, bf16, card_s = card[task]
        if not torch.allclose(gts, f32_gts, rtol=0, atol=1e-3):  # the same labels, rescaled
            raise AssertionError(f"evaluate_checkpoint {task}: the card and the CPU read "
                                 f"other samples")
        n, charged = peak_rule(preds[..., :2], bf16[..., :2], f32[..., :2],
                               preds[..., 2] > 0, f32[..., 2] > 0)
        n_all, charged_all = n_all + n, charged_all + charged
        det_res[task] = {"card": DE.detection_metrics(task, preds, gts),
                         "cpu": DE.detection_metrics(task, f32, gts),
                         "detections": n, "charged_to_kernels": charged,
                         "worst_px": float((preds[..., :2] - f32[..., :2]).norm(dim=-1).max()),
                         "card_s": card_s}
    det_dir.cleanup()
    det_res["share_free"] = 1 - charged_all / max(n_all, 1)
    res["detection"] = det_res
    log("closed_loop", part="eval", detection=json.dumps(det_res))
    if det_res["share_free"] < CL_PEAK_SHARE:
        raise AssertionError(f"evaluate_checkpoint, the card against the CPU: {det_res}")


def peak_rule(card, plain_bf16, f32, seen_card, seen_f32):
    """The closed loop's peak rule on peaks (..., 2) of the kernel path (`card`), its bf16
    plain copy and the f32 plain path: a detection (seen on either side) charged to the
    kernels where only one side sees it, or where the kernel path misses the f32 peak by
    more than CL_PEAK_PX and the bf16 copy does not. Returns (detections, charged)."""
    both = seen_card & seen_f32
    k = (card - f32).norm(dim=-1)[both]
    b = (plain_bf16 - f32).norm(dim=-1)[both]
    missed = int((seen_card ^ seen_f32).sum())
    return int(both.sum()) + missed, int(((k > CL_PEAK_PX) & (b <= CL_PEAK_PX)).sum()) + missed


def run_eval(torch, ops, pipe, store, test_idx, det_dir, later):
    """closed_loop (d): the evaluation entry points (see EV_RALLIES). det_dir: the
    TemporaryDirectory of `rally_tthq`'s TTHQ layout, whose CPU detections
    (`ev_detection_check`) are appended to `later`."""
    import glob
    import math
    import tempfile
    import types

    import numpy as np

    from upliftingtabletennis_torch import hub
    from upliftingtabletennis_torch.core import geometry as G
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.data.png import read_png
    from upliftingtabletennis_torch.eval import closed_loop as CL
    from upliftingtabletennis_torch.eval import compare_speed as CS
    from upliftingtabletennis_torch.eval import run_combined_eval as CE
    from upliftingtabletennis_torch.eval import run_detection_eval as DE
    from upliftingtabletennis_torch.eval import run_physics_fit_eval as PF
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.models.segformer import MiTBlock
    from upliftingtabletennis_torch.ops import physics as S1

    res = {}
    t0 = time.time()
    store_d = SYN.store_to_device(store, DEVICE)
    rallies = [CL.render_held_out(store_d, ti, j) for j, ti in enumerate(test_idx[:EV_RALLIES])]

    # the combined evaluation, both protocols, and the pictures of one rally
    for k in ops.ALL:
        getattr(ops, k).launches = 0
    torch.cuda.synchronize()
    tthq, ttst, tthq_s, pieces = [], [], [], 0
    with tempfile.TemporaryDirectory() as d:
        for j, (sample, T, frames) in enumerate(rallies):
            frames = frames.cpu().numpy()
            times = sample["times"][0, :T].cpu().numpy()
            fps = 1.0 / float(times[1] - times[0])
            t = time.time()
            tthq.append(CE.evaluate_rally(pipe, frames, fps))
            tthq_s.append(time.time() - t)
            w_local = G.transform_rotation_axes(sample["rotation"][0].cpu(),
                                                sample["r_world"][0, :T].cpu())
            ann = {"r_img": sample["r_img"][0, 1:T - 1].cpu().numpy(), "times": times[1:T - 1],
                   "Mint": sample["Mint"][0].cpu().numpy(),
                   "Mext": sample["Mext"][0].cpu().numpy(),
                   "spin_class": 1 if float(w_local[1]) > 0 else 2,
                   "table_img": sample["table_img"][0, :, :2].cpu().numpy()}
            ttst.append(CE.evaluate_rally_ttst(pipe, frames, ann))
            pieces += 2 * math.ceil(T / HR_CHUNK)
            if j == 0:
                CE.visualize_rally(pipe, frames, fps, d, "rally", ann["spin_class"])
                pieces += math.ceil(T / HR_CHUNK)
                pngs = sorted(os.path.basename(f) for f in glob.glob(os.path.join(d, "*.png")))
        torch.cuda.synchronize()
    launches = {k: getattr(ops, k).launches for k in ops.ALL}
    blocks = sum(isinstance(m, MiTBlock) for m in pipe.table_detector.model.modules())
    want = {k: 0 for k in ops.ALL}
    want.update(fused_attention_block=blocks * pieces, fused_ln_ffn=blocks * pieces,
                conv3x3_bias_act=RALLY_PER_PIECE["conv3x3_bias_act"] // 2 * pieces,
                conv1x1_bias_act=RALLY_PER_PIECE["conv1x1_bias_act"] // 2 * pieces)
    if launches != want:
        raise AssertionError(f"the combined evaluation's launches {launches}, expected {want}")
    keys = {"tthq": ("table_reproj_px", "ball_reproj_px"),
            "ttst": ("table_px", "ball_detection_px", "ball_uplifting_px")}
    nums = {p: {k: [r[k] for r in rs] for k in keys[p]} for p, rs in (("tthq", tthq),
                                                                      ("ttst", ttst))}
    if not all(np.isfinite(v).all() for p in nums.values() for v in p.values()):
        raise AssertionError(f"the combined evaluation gave {nums}")
    gated = {"ball_detection_px": (float(np.mean(nums["ttst"]["ball_detection_px"])),
                                   CL_GATES["ball_detection_px_median"]),
             "table_px": (float(np.mean(nums["ttst"]["table_px"])),
                          CL_GATES["table_detection_px_median"])}
    if any(v > lim for v, lim in gated.values()):
        raise AssertionError(f"TTST over the closed loop's gates: {gated}")
    if pngs != ["rally_2d.png", "rally_3d.png"]:
        raise AssertionError(f"visualize_rally wrote {pngs}")
    res["combined"] = {"numbers": nums, "gated": gated, "launches": launches, "pieces": pieces,
                       "s_per_rally_evaluate_rally": tthq_s}
    log("closed_loop", part="eval", combined=json.dumps(nums), gated=json.dumps(gated),
        s_per_rally=json.dumps([round(v, 3) for v in tthq_s]), pieces=pieces,
        launches=json.dumps({k: v for k, v in launches.items() if v}))

    # detection evaluation: the card's detections here, the CPU's f32 ones later
    card_det = {}
    for task in ("ball", "table"):
        det, _ = DE.load_detector(task, cl_weights(f"{task}_detector"), device=DEVICE)
        t = time.time()
        card, gts = DE.detections(task, det, det_dir.name, 4, limit=EV_DET_LIMIT[task])
        card_s = time.time() - t
        ref, _ = get_detector(det.model_name, task, kernels=False, resolution=det.resolution)
        ref.load_state_dict(det.model.state_dict())
        ref.eval().to(DEVICE)
        plain = types.SimpleNamespace(
            device=det.device, dtype=torch.bfloat16, resolution=det.resolution,
            _forward=lambda x, m=ref: (lambda o: o[0] if isinstance(o, tuple) else o)(m(x)))
        bf16, _ = DE.detections(task, plain, det_dir.name, 4, limit=EV_DET_LIMIT[task])
        del ref, plain
        card_det[task] = (card.cpu(), gts.cpu(), bf16.cpu(), card_s)
    later.append(functools.partial(ev_detection_check, torch, res, det_dir, card_det))

    # the physics-fit evaluation's store protocol at its defaults, one batch
    args = PF._parser().parse_args(["--batch", str(EV_FIT_TRAJ), "--device", DEVICE])
    idx = PF.eval_indices(len(store), SYN.split_indices(len(store), "train"),
                          SYN.split_indices(len(store), "val"), "test", EV_FIT_TRAJ, 0)
    S1.simulate.launches = S1.simulate_tangent.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    fit = PF.evaluate_store(store, idx, args, DEVICE)
    fit_s = time.time() - t
    s1 = {"simulate": S1.simulate.launches, "simulate_tangent": S1.simulate_tangent.launches}
    if s1 != FIT_LAUNCHES or fit["n_traj"] != EV_FIT_TRAJ or not all(
            np.isfinite(fit[k]) for k in ("err3d_cm_mean", "err3d_cm_median", "coverage")):
        raise AssertionError(f"the physics-fit evaluation: {fit}, S1 launches {s1}")
    res["physics_fit"] = {"summary": fit, "s_per_batch": fit_s, "s1_launches": s1}
    log("closed_loop", part="eval", physics_fit_s=f"{fit_s:.2f}", coverage=fit["coverage"],
        err3d_cm_median=f"{fit['err3d_cm_median']:.2f}", s1_launches=json.dumps(s1))

    # compare_speed
    res["compare_speed"] = {f"{task}/{name}": CS.measure(task, name, 8, EV_SPEED_ITERS,
                                                         device=DEVICE)
                            for task, name in (("ball", "wasb"), ("table", "segformerpp_b0"))}
    torch.cuda.empty_cache()
    log("closed_loop", part="eval", compare_speed=json.dumps(
        {k: f"{v['sec_per_batch'] * 1e3:.2f} ms/batch {v['resolution']}"
         for k, v in res["compare_speed"].items()}))

    # the example images, and the pipeline on them
    with tempfile.TemporaryDirectory() as d:
        t = time.time()
        folder = hub.download_example_images(os.path.join(d, "examples"), device=DEVICE)
        gen_s = time.time() - t
        with open(os.path.join(folder, "meta.json")) as f:
            meta = json.load(f)
        frames = np.stack([read_png(os.path.join(folder, f"frame_{i:04d}.png"))
                           for i in range(meta["n_frames"])])
    out = pipe.run_rally(frames, meta["fps"])
    truth = np.asarray(meta["ball_px_1920x1080"])[np.asarray(out["valid_idx"]) + 1]
    err = np.linalg.norm(out["ball"] - truth, axis=-1)
    if frames.shape[1:] != (1080, 1920, 3) or not len(err) or not np.isfinite(err).all():
        raise AssertionError(f"the example rally: {frames.shape}, {len(err)} detections")
    res["examples"] = {"n_frames": meta["n_frames"], "seconds": gen_s, "detections": len(err),
                       "ball_px_median": float(np.median(err))}
    log("closed_loop", part="eval", examples=json.dumps(res["examples"]),
        eval_s=f"{time.time() - t0:.1f}")
    return res


def hr_step(torch, CL, model, batch):
    """One f32 training step's loss, gradients and running statistics (on the host)."""
    loss, _, _ = CL.detector_loss(model, *batch)
    grads = torch.autograd.grad(loss, list(model.parameters()), materialize_grads=True)
    stats = {k: v.detach().float().cpu() for k, v in model.named_buffers() if "running" in k}
    return float(loss), [g.float().cpu() for g in grads], stats


def hr_rel(a, b):
    """max |a - b| / max |b| (0 when both are 0)."""
    m = float(b.abs().max())
    return float((a - b).abs().max()) / m if m > 0 else float((a - b).abs().max())


def unbiased_stats_fault(batch_norm):
    """The fault of nn.BatchNorm2d's rule: the running variance moved by the unbiased
    batch variance (the normalisation unchanged), for a caller with a sink or without."""
    from upliftingtabletennis_torch.models.batch_norm import update_running_stats

    def fn(x, bn, sink=None):
        pending = [] if sink is None else sink
        y = batch_norm(x, bn, pending)
        if bn.training:
            n = x.numel() // x.shape[-1]
            b, mean, var = pending[-1]
            pending[-1] = (b, mean, var * n / (n - 1))
            if sink is None:
                update_running_stats(*pending.pop())
        return y
    return fn


def hr_train_cases(torch, CL, store, train_idx):
    """(b)'s cases: (name, the model's initial weights, a batch rendered on the card) for
    WASB and the table HRNet, with remat."""
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.pipeline.interface import init_weights

    W, H = HR_STEP_RES
    cases = []
    for name, task in (("wasb", "ball"), ("hrnet", "table")):
        base, _ = get_detector(name, task, train=True, remat=True)
        init_weights(base, 3)
        g = torch.Generator(device=DEVICE).manual_seed(5)
        images, coords, vis = CL.sample_rendered(store, train_idx, HR_STEP_BATCH, task,
                                                 HR_STEP_RES, g)
        batch = CL.make_batch(images, coords, vis, 1 if task == "ball" else 13, (H, W),
                              max(6.0 * W / CL.EVAL_W, 1.5))
        cases.append((name, base, batch))
    return cases


def hr_cpu_reference(torch, CL, base, host_batch):
    """The CPU's f32 step from the same weights and batch (on the host), without remat
    (remat changes no value: tests/test_torch_hrnet_train.py): (the step, seconds)."""
    import copy

    cpu = copy.deepcopy(base)
    cpu.model.remat = False
    t = time.time()
    return hr_step(torch, CL, cpu, host_batch), time.time() - t


def run_hr_train_check(torch, CL, cases, later):
    """(b): one WASB and one table-HRNet training step on the card (remat) and the
    planted faults here; the CPU's steps (`hr_cpu_reference`) and the limits that hold
    them together (`hr_train_verdict`) appended to `later`. Returns the dict those fill."""
    import copy

    from upliftingtabletennis_torch.models import batch_norm as BN
    from upliftingtabletennis_torch.models import hrnet as HR

    res = {}
    for name, base, batch in cases:
        t = time.time()
        card = hr_step(torch, CL, copy.deepcopy(base).to(DEVICE), batch)
        card_s = time.time() - t
        with patched(HR, batch_norm=lambda x, bn, sink=None: BN.batch_norm(x, bn)):
            twice = hr_step(torch, CL, copy.deepcopy(base).to(DEVICE), batch)
        with patched(HR, batch_norm=unbiased_stats_fault(BN.batch_norm)):
            unbiased = hr_step(torch, CL, copy.deepcopy(base).to(DEVICE), batch)
        later.append(functools.partial(hr_train_verdict, torch, CL, res, name, base,
                                       [b.cpu() for b in batch], card, card_s, twice, unbiased))
        del batch
        torch.cuda.empty_cache()
    return res


def hr_train_verdict(torch, CL, res, name, base, host_batch, card, card_s, twice, unbiased):
    """closed_loop (b)'s gates on one model: the CPU's step against the card's `card`,
    and the card's steps under the planted faults (`twice`, `unbiased`). Fills res[name]."""
    cpu, cpu_s = hr_cpu_reference(torch, CL, base, host_batch)
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    names = [n for n, _ in base.named_parameters()]
    grad_errs = {n: hr_rel(a, b) for n, a, b in zip(names, card[1], cpu[1]) if b.any()}
    zero_ok = all(not a.any() for a, b in zip(card[1], cpu[1]) if not b.any())
    stats_err = max(hr_rel(card[2][k], cpu[2][k]) for k in cpu[2])
    twice_err = max(hr_rel(twice[2][k], cpu[2][k]) for k in cpu[2])
    unbiased_err = max(hr_rel(unbiased[2][k], cpu[2][k]) for k in cpu[2])
    worst = max(grad_errs, key=grad_errs.get)
    res[name] = {"loss_card": card[0], "loss_cpu": cpu[0], "loss_rel_err": loss_err,
                 "grad_max_rel_err": grad_errs[worst], "grad_worst": worst,
                 "grad_median_rel_err": statistics.median(grad_errs.values()),
                 "stats_max_rel_err": stats_err, "fault_twice_stats_err": twice_err,
                 "fault_unbiased_stats_err": unbiased_err, "card_step_s": card_s,
                 "cpu_step_s": cpu_s}
    log("closed_loop", what=f"train_step_{name}", loss_rel_err=f"{loss_err:.3g}",
        grad_max_rel_err=f"{grad_errs[worst]:.3g}", grad_worst=worst,
        stats_max_rel_err=f"{stats_err:.3g}", fault_twice=f"{twice_err:.3g}",
        fault_unbiased=f"{unbiased_err:.3g}", cpu_step_s=f"{cpu_s:.1f}")
    if (loss_err > HR_LOSS_RTOL or grad_errs[worst] > HR_GRAD_REL or not zero_ok
            or stats_err > HR_STATS_REL):
        raise AssertionError(f"{name}: the card's training step differs from the CPU's: "
                             f"{res[name]}")
    if twice_err <= HR_STATS_REL:
        raise AssertionError(f"{name}: the statistics moved twice pass the limit")


def run_hr_train_timing(torch, CL):
    """ms per bf16 training step (forward, backward, clip, Adam, EMA) and peak memory of
    WASB and the table HRNet, with and without remat, at HR_TIMED."""
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.pipeline.interface import init_weights
    from upliftingtabletennis_torch.train.run_detection import apply_update, init_adam

    out = {}
    for name, task in (("wasb", "ball"), ("hrnet", "table")):
        n_ch, n_pts = (9, 1) if task == "ball" else (3, 13)
        for (W, H), B in HR_TIMED:
            for remat in (True, False):
                model, _ = get_detector(name, task, train=True, remat=remat)
                init_weights(model, 3)
                model.to(DEVICE)
                params = list(model.parameters())
                opt, ema = init_adam(params), [p.detach().clone() for p in params]
                g = torch.Generator(device=DEVICE).manual_seed(0)
                x = torch.randn(B, H, W, n_ch, generator=g, device=DEVICE).to(torch.bfloat16)
                target = torch.rand(B, n_pts, H, W, generator=g, device=DEVICE)
                coords = torch.rand(B, n_pts, 2, generator=g, device=DEVICE) * 100
                vis = torch.ones(B, n_pts, device=DEVICE)

                def step():
                    loss, _, _ = CL.detector_loss(model, x, target, coords, vis)
                    grads = torch.autograd.grad(loss, params, materialize_grads=True)
                    apply_update(params, grads, opt, ema, 1e-4, 0.999)

                step()  # warm-up: cuDNN's algorithms, the allocator
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(HR_TIMED_STEPS):
                    t = time.time()
                    step()
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.time() - t))
                key = f"{name}_{W}x{H}_b{B}_{'remat' if remat else 'plain'}"
                out[key] = {"ms": statistics.median(times), "ms_range": [min(times), max(times)],
                            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
                log("closed_loop", what="train_step_timing", config=key,
                    ms=f"{out[key]['ms']:.2f}", peak_mem_gb=f"{out[key]['peak_mem_gb']:.2f}")
                del model, params, opt, ema, x, target
                torch.cuda.empty_cache()
    return out


def start_closed_loop(torch):
    """The closed_loop phase's store, (b)'s cases and (d)'s TTHQ layout, whose files a
    thread of their own writes: (store, cases, (d)'s layout directory, the writer's
    future)."""
    import tempfile

    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.eval import closed_loop as CL

    store = CL._load_store(None, device=DEVICE)
    store_d = SYN.store_to_device(store, DEVICE)
    cases = hr_train_cases(torch, CL, store_d, SYN.split_indices(len(store), "train"))
    det_dir = tempfile.TemporaryDirectory()
    writer = ThreadPoolExecutor(max_workers=1)
    written = rally_tthq(det_dir.name, store_d, SYN.split_indices(len(store), "test")[EV_RALLIES],
                         writer)
    writer.shutdown(wait=False)
    return store, cases, det_dir, written


def run_closed_loop(torch, ops, later):
    """Phase closed_loop: (a) scoring with the committed trained weights, (b) the HRNet
    training step, (c) the CLI, (d) the evaluation entry points; the CPU references of
    (b) and (d), and the gates that read them, appended to `later`."""
    import glob
    import math
    import tempfile
    import types

    import numpy as np

    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.data.image_transforms import host_downscale
    from upliftingtabletennis_torch.eval import closed_loop as CL
    from upliftingtabletennis_torch.models.segformer import MiTBlock
    from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector
    from upliftingtabletennis_torch.train import run_detection
    from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint

    res = {}
    t0 = time.time()
    store, cases, det_dir, written = start_closed_loop(torch)
    store_d = SYN.store_to_device(store, DEVICE)
    test_idx = SYN.split_indices(len(store), "test")
    pipe = CL._pipeline_from(cl_weights("ball_detector"), cl_weights("table_detector"),
                             cl_weights("uplifting"), (960, 544), device=DEVICE)
    log("closed_loop", store=len(store), setup_s=f"{time.time() - t0:.1f}",
        ball=pipe.ball_detector.model_name, table=pipe.table_detector.model_name,
        res=list(pipe.ball_detector.resolution))

    # (a) the scoring, CL_RALLIES counted (s_per_rally includes the first call's warm-up:
    # the rendering and every draw are seeded per rally, so no call needs another first)
    with tempfile.TemporaryDirectory() as d:
        args = types.SimpleNamespace(n_eval=CL_RALLIES + 1,  # one shorter than 8 frames
                                     uplifting_checkpoint=cl_weights("uplifting"),  # is skipped
                                     render_res=(960, 544), skip_physics_fit=True,
                                     physfit_min_rallies=8, out=d)
        for k in ops.ALL:
            getattr(ops, k).launches = 0
        torch.cuda.synchronize()
        t = time.time()
        score = CL.evaluate_pipeline(store, None, args, DEVICE, pipe=pipe)
        secs = time.time() - t
        launches = {k: getattr(ops, k).launches for k in ops.ALL}
        diag = json.load(open(os.path.join(d, "rally_diag.json")))
    pieces = sum(math.ceil(r["T"] / HR_CHUNK) for r in diag)
    blocks = sum(isinstance(m, MiTBlock) for m in pipe.table_detector.model.modules())
    want = {k: 0 for k in ops.ALL}
    want.update(fused_attention_block=blocks * pieces, fused_ln_ffn=blocks * pieces,
                conv3x3_bias_act=RALLY_PER_PIECE["conv3x3_bias_act"] // 2 * pieces,
                conv1x1_bias_act=RALLY_PER_PIECE["conv1x1_bias_act"] // 2 * pieces)
    if launches != want:
        raise AssertionError(f"closed-loop scoring launches {launches}, expected {want}")
    res.update(score=score, launches=launches, rallies=len(diag), pieces=pieces,
               s_per_rally=secs / max(len(diag), 1), jax=CL_JAX, gates=CL_GATES)
    beside = {k: [score.get(k), CL_JAX[k]] for k in CL_JAX if k in score}
    log("closed_loop", rallies=len(diag), frames=int(sum(r["T"] for r in diag)),
        s_per_rally=f"{res['s_per_rally']:.3f}", launches=json.dumps(launches),
        port_vs_jax=json.dumps(beside))
    failed = {k: score.get(k) for k, lim in CL_GATES.items()
              if score.get(k) is None or not score[k] <= lim}
    if failed or score["n_rallies"] < CL_RALLIES:
        raise AssertionError(f"closed-loop scores over their gates: {failed} (gates {CL_GATES}), "
                             f"{score['n_rallies']} rallies")

    # the kernel path's peaks against the f32 plain path's on the frames of a few rallies
    triplets, singles = [], []
    for j, ti in enumerate(test_idx[:CL_PEAK_RALLIES]):
        frames = CL.render_held_out(store_d, ti, j)[2].cpu().numpy()
        small = torch.from_numpy(host_downscale(frames, pipe.ball_detector.resolution))
        triplets.append(torch.cat([small[:-2], small[1:-1], small[2:]], dim=-1))
        singles.append(small)
    peaks = {}
    for what, det, items in (("ball", pipe.ball_detector, torch.cat(triplets)),
                             ("table", pipe.table_detector, torch.cat(singles))):
        peaks[what] = cl_peak_check(torch, det, items.to(DEVICE))
        if peaks[what]["share_free"] < CL_PEAK_SHARE:
            raise AssertionError(f"{what}: the kernel path's peaks against the f32 plain "
                                 f"path's: {peaks[what]}")
    res["peaks_vs_plain"] = peaks
    # render_frames alone: ms per 1080p frame of a whole padded rally (50 frames)
    from upliftingtabletennis_torch.data.render_rally import render_frames

    ball = torch.rand(50, 2, device=DEVICE) * torch.tensor([1920.0, 1080.0], device=DEVICE)
    table = torch.rand(13, 2, device=DEVICE) * torch.tensor([1920.0, 1080.0], device=DEVICE)
    ctx = torch.rand(3, 4, 2, device=DEVICE) * torch.tensor([1920.0, 1080.0], device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    res["render_ms_per_frame"] = time_ms(torch, lambda: render_frames(
        ball, torch.ones(50, device=DEVICE), table, 1080, 1920, ctx, generator=gen),
        iters=5, warmup=2) / 50
    log("closed_loop", peaks_vs_plain=json.dumps(peaks), tol_px=CL_PEAK_PX,
        near_px=CL_PEAK_NEAR, min_share=CL_PEAK_SHARE, render_ms_per_frame=f"{res['render_ms_per_frame']:.3f}")
    del triplets, singles
    # (d) the evaluation entry points on the same pipeline and store
    written.result()
    res["eval"] = run_eval(torch, ops, pipe, store, test_idx, det_dir, later)
    del pipe
    torch.cuda.empty_cache()

    res["train_step_timing"] = run_hr_train_timing(torch, CL)

    # (c) the CLI: a few steps per task (WASB, the table HRNet), 2 rallies
    with tempfile.TemporaryDirectory() as d:
        t = time.time()
        cli = CL.main(["--out", d, "--train_steps", str(CL_CLI_STEPS), "--eval_every", "2",
                       "--render_res", *(str(v) for v in CL_CLI_RES),
                       "--n_eval", "2", "--uplifting_checkpoint", cl_weights("uplifting"),
                       "--physfit_starts", "4", "--physfit_adam_steps", "20",
                       "--physfit_lm_steps", "2", "--device", DEVICE])
        cli_s = time.time() - t
        frame = synthetic_frames(3)
        for task, cls in (("ball", BallDetector), ("table", TableDetector)):
            path = os.path.join(d, f"{task}_detector")
            _, _, info = load_checkpoint(path)
            det = cls(info["model"], path, 2, resolution=tuple(info["render_res"]),
                      device=DEVICE)
            got = (det.predict([tuple(frame)])[0] if task == "ball" else
                   det.predict(list(frame))[0])
            if not np.isfinite(got).all():
                raise AssertionError(f"the CLI's {task} checkpoint predicts {got}")
        # the HRNet trainers' CLI on a tiny TTHQ layout: 2 steps each, checkpoints loaded
        tiny_tthq(d)
        t = time.time()
        for task, model, cls in (("ball", "wasb", BallDetector),
                                 ("table", "hrnet", TableDetector)):
            run_detection.main(["--task", task, "--model", model, "--data_root", d,
                                "--batch_size", "2", "--num_epochs", "1",
                                "--val_iterations", "2", "--max_steps", "2",
                                "--resolution", "320", "192", "--eval_resolution", "640", "360",
                                "--save_dir", os.path.join(d, "ckpt"),
                                "--logdir", os.path.join(d, "runs"), "--device", DEVICE])
            (path,) = glob.glob(os.path.join(d, "ckpt", f"{task}_{model}_*", "model.pt"))
            det = cls(model, path, 2, resolution=(320, 192), device=DEVICE)
            got = (det.predict([tuple(frame)])[0] if task == "ball" else
                   det.predict(list(frame))[0])
            if not np.isfinite(got).all():
                raise AssertionError(f"run_detection's {model} checkpoint predicts {got}")
        detection_cli_s = time.time() - t
    # (b) the card's training step against the CPU's, whose reference ran meanwhile
    res["train_step"] = run_hr_train_check(torch, CL, cases, later)
    if cli["n_rallies"] != 2:
        raise AssertionError(f"the CLI scored {cli['n_rallies']} rallies")
    res["cli"] = {"seconds": cli_s, "n_rallies": cli["n_rallies"],
                  "ball_detection_px_median": cli["ball_detection_px_median"],
                  "run_detection_s": detection_cli_s}
    log("closed_loop", cli_s=f"{cli_s:.1f}", cli_rallies=cli["n_rallies"],
        run_detection_s=f"{detection_cli_s:.1f}", phase_s=f"{time.time() - t0:.1f}")
    return res



def reference_weights_zip(torch, root):
    """The reference's weights zip in its layout (`inference_*/<name>/model.pt`, one wrapping
    folder) from seeded port state dicts renamed to the reference's keys: WASB, the table
    HRNet and the `ours` uplifting model (connectstage large), as
    tests/test_torch_port_reference_weights.py builds them (weights scaled by fan-in^-1/2,
    variances positive). Returns (the zip's path, {slot: the reference state dict})."""
    import re
    import zipfile

    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.models.uplifting import get_uplifting_model

    def seeded(state, seed):
        g = torch.Generator().manual_seed(seed)
        out = {}
        for k, v in state.items():
            if v.is_floating_point():
                v = torch.randn(v.shape, generator=g)
                v = v.abs() + 0.5 if k.endswith("running_var") else (
                    v * v[0].numel() ** -0.5 if v.ndim >= 2 else v)
            out[k] = v.clone()
        return out

    refs = {}
    for slot, (name, task), seed in (("ball_aux", ("wasb", "ball"), 1),
                                     ("table_aux", ("hrnet", "table"), 2)):
        state = seeded(get_detector(name, task)[0].state_dict(), seed)
        refs[slot] = {re.sub(r"_(\d+)", r".\1", k): v for k, v in state.items()}
    up = seeded(get_uplifting_model("connectstage", "large", "dynamic", "new").state_dict(), 3)
    refs["uplifting"] = {}
    for k, v in up.items():
        k = ".".join(re.sub(r"^(.+)_(\d+)$", r"\1.\2", p) for p in k.replace("table_stage.", "")
                     .split("."))
        refs["uplifting"][k] = v * 0.5
    infos = {"ball_aux": ("inference_balldetection/wasb", {"model_name": "wasb", "in_frames": 3,
                                                           "image_resolution": (1280, 704)}),
             "table_aux": ("inference_tabledetection/hrnet",
                           {"model_name": "hrnet", "image_resolution": (1280, 704)}),
             "uplifting": ("inference_uplifting/ours",
                           {"name": "connectstage", "size": "large", "tabletoken_mode": "dynamic",
                            "time_rotation": "new", "transform_mode": "global"})}
    path = os.path.join(root, "tt_weights.zip")
    with zipfile.ZipFile(path, "w") as z:
        for slot, (rel, info) in infos.items():
            pt = os.path.join(root, "model.pt")
            torch.save({"model_state_dict": refs[slot], "identifier": rel,
                        "additional_info": info}, pt)
            z.write(pt, f"tt_weights/{rel}/model.pt")
            os.remove(pt)
    return path, refs


def start_item7(pool):
    """Phase item7's BlurBall tree (1080p PNG files), written on `pool` (during the
    build). Returns (the directory, the future)."""
    import tempfile

    d = tempfile.TemporaryDirectory()
    return d, pool.submit(tiny_blurball, os.path.join(d.name, "bb"), I7_BLURBALL_VIDEOS,
                          hw=(EVAL_RES[1], EVAL_RES[0]))


def run_item7(torch, ops, pre=None):
    """Phase item7: the last modules' card paths. (a) BlurBall pretraining through
    `run_detection --data blurball` at its defaults (the ball for I7_BALL_STEPS steps and a
    validation, the table for I7_TABLE_STEPS), K1 / K2 / K4 / K4b launches of every step
    against phase train's, ms per step and per batch load, the checkpoint at
    `pretraining_blurball/segformerpp_b2/model.pt` and `run_detection.warm_start`, what
    `--pretraining` calls, loading every tensor of it into a fresh b2 ball detector (the
    tree `start_item7` wrote, `pre`, or written here); (b) the uplifting trainer's
    step under DDP over NCCL at world size 1 against the plain step, I7_DDP_STEPS steps of
    connectstage large at batch 64 from one seed, the parameters bit-equal under
    deterministic algorithms (ms and launches are those of that mode; the launches counted
    on the last step); (c)
    `hub.full_pipeline(weights_url="file://...")` on a reference weights zip: one
    `run_rally` piece (and the uplifting model on a track) bit-equal to a pipeline of the
    same weights mapped directly by `utils/port_torch.py`, and a second call served by the
    cache; (d) `extract_ttst` on a two-event raw layout, `annotation_qa` on a planted swap
    and `one_euro_trajectory`, on the card."""
    import contextlib
    import copy
    import io
    import socket
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from upliftingtabletennis_torch import hub
    from upliftingtabletennis_torch.core.geometry import TABLE_POINTS, get_Mext
    from upliftingtabletennis_torch.data import annotation_qa as QA
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.data import detection as D
    from upliftingtabletennis_torch.data import extract_ttst as XT
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.data.augment import AugmentConfig
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.models.uplifting import get_uplifting_model, reference_init
    from upliftingtabletennis_torch.pipeline.interface import (BallDetector, TableDetector,
                                                               UpliftingModel)
    from upliftingtabletennis_torch.train import run_detection as T
    from upliftingtabletennis_torch.train import run_uplifting as RU
    from upliftingtabletennis_torch.train import uplifting_train as UT
    from upliftingtabletennis_torch.utils import port_reference_weights as PRW
    from upliftingtabletennis_torch.utils import port_torch as PP
    from upliftingtabletennis_torch.utils.smoothing import one_euro_trajectory

    t_phase = time.time()
    res = {}

    # (a) BlurBall pretraining at the trainer's defaults, then the TTHQ hand-off
    steps, loads = [], []
    stock_step = T.train_step

    def counted_step(*a, **k):
        for name in ops.ALL:
            getattr(ops, name).launches = 0
        torch.cuda.synchronize()
        t = time.time()
        loss = stock_step(*a, **k)
        value = loss.item()  # waits for the step
        steps.append({"ms": 1e3 * (time.time() - t), "loss": value,
                      "launches": {n: getattr(ops, n).launches for n in ops.ALL}})
        return loss

    def timed(load):
        def call(*a, **k):
            t = time.time()
            out = load(*a, **k)
            loads.append(1e3 * (time.time() - t))
            return out
        return call

    t = time.time()
    trees, written = pre if pre is not None else start_item7(ThreadPoolExecutor(1))
    written.result()
    write_s = time.time() - t  # waiting for the writer; the writing itself when run alone
    with trees:
        d = trees.name
        bb, save = os.path.join(d, "bb"), os.path.join(d, "ckpt")
        common = ["--model", "segformerpp_b2", "--save_dir", save,
                  "--logdir", os.path.join(d, "runs"), "--device", DEVICE]
        out = io.StringIO()
        per_task = {}
        with patched(T, train_step=counted_step), \
                patched(D, load_blurball_ball_batch=timed(D.load_blurball_ball_batch),
                        load_blurball_table_batch=timed(D.load_blurball_table_batch)), \
                contextlib.redirect_stdout(out):
            for task, n in (("ball", I7_BALL_STEPS), ("table", I7_TABLE_STEPS)):
                first, first_load, t = len(steps), len(loads), time.time()
                T.main(["--task", task, "--data", "blurball", "--data_root", bb,
                        "--batch_size", str(TRAIN_BATCH), "--val_iterations", str(n),
                        "--max_steps", str(n), *common])
                per_task[task] = dict(cli_s=time.time() - t, steps=steps[first:],
                                      load_ms=loads[first_load:])
        ckpt = T.pretraining_path(save, "segformerpp_b2")
        have_ckpt = os.path.isfile(ckpt)
        t = time.time()
        fresh = get_detector("segformerpp_b2", "ball", train=True)[0]
        n_loaded, n_total = (T.warm_start(fresh, ckpt, "ball/segformerpp_b2") if have_ckpt
                             else (0, len(fresh.state_dict())))
        handoff_s = time.time() - t
        del fresh
    ball = per_task["ball"]
    res["blurball"] = dict(
        write_s=write_s, handoff_s=handoff_s, checkpoint=have_ckpt, n_total=n_total,
        n_loaded=n_loaded,
        **{task: dict(cli_s=v["cli_s"], losses=[s["loss"] for s in v["steps"]],
                      step_ms=[s["ms"] for s in v["steps"]],
                      launches=[s["launches"] for s in v["steps"]], load_ms=v["load_ms"])
           for task, v in per_task.items()})
    launches = {k: v for k, v in ball["steps"][-1]["launches"].items() if v}
    res["blurball"]["launches_per_step"] = launches
    log("item7", step="a_blurball", cli_s=json.dumps({k: round(v["cli_s"], 2)
                                                       for k, v in per_task.items()}),
        ms_per_step=json.dumps({k: [round(s["ms"], 1) for s in v["steps"]]
                                for k, v in per_task.items()}),
        ms_per_batch_load=json.dumps({k: [round(x, 1) for x in v["load_ms"]]
                                      for k, v in per_task.items()}),
        losses=json.dumps({k: [round(s["loss"], 5) for s in v["steps"]]
                           for k, v in per_task.items()}),
        launches_per_step=json.dumps(launches), checkpoint=have_ckpt,
        handoff=f"{n_loaded}/{n_total}", handoff_s=f"{handoff_s:.1f}",
        write_s=f"{write_s:.1f}")
    for task, v in per_task.items():
        if len(v["steps"]) != dict(ball=I7_BALL_STEPS, table=I7_TABLE_STEPS)[task]:
            raise AssertionError(f"BlurBall {task}: {len(v['steps'])} steps")
        for s in v["steps"]:
            if not np.isfinite(s["loss"]):
                raise AssertionError(f"BlurBall {task}: the loss is {s['loss']}")
            got = {k: s["launches"][k] for k in I7_STEP_LAUNCHES}
            if got != I7_STEP_LAUNCHES or sum(s["launches"].values()) != sum(got.values()):
                raise AssertionError(f"a BlurBall {task} step launched {s['launches']}, "
                                     f"expected {I7_STEP_LAUNCHES}")
    if not have_ckpt:
        raise AssertionError(f"no BlurBall checkpoint at {ckpt}")
    if n_loaded != n_total:
        raise AssertionError(f"the hand-off loaded {n_loaded}/{n_total} tensors of {ckpt}")
    torch.cuda.empty_cache()

    # (b) the uplifting trainer under DDP at world size 1 against the plain trainer
    t = time.time()
    store = SYN.store_from_datagen(DG.generate_dataset(
        I7_DDP_STORE, "intermediate", "left_to_right", device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(5)))
    store_d = SYN.store_to_device(store, DEVICE)
    perm = torch.randperm(len(store), generator=torch.Generator().manual_seed(6))
    idx_all = perm.to(DEVICE)
    cfg = AugmentConfig()
    B = I7_DDP_BATCH
    store_s = time.time() - t

    model0 = get_uplifting_model("connectstage", "large", "dynamic", "new")
    reference_init(model0, torch.Generator().manual_seed(7))
    model0.to(DEVICE)

    def uplift_run(ddp):
        model = copy.deepcopy(model0)
        state = UT.init_train_state(model)
        net = (DistributedDataParallel(model, device_ids=[torch.cuda.current_device()],
                                       broadcast_buffers=False) if ddp else None)
        gen = torch.Generator(device=DEVICE).manual_seed(8)
        shard = slice(0, B) if ddp else None
        ms, losses = [], []

        def step(s):
            batch, _ = RU.train_batch(store_d, idx_all[(s * B) % len(store):][:B], gen, cfg,
                                      shard=shard)
            return UT.train_step(model, state, batch, 1e-4, 0.999, "global", net)

        for s in range(I7_DDP_STEPS - 1):
            torch.cuda.synchronize()
            t0 = time.time()
            m = step(s)
            losses.append(m["loss"].item())
            ms.append(1e3 * (time.time() - t0))
        counted = profile_calls(  # the last step, its launches counted
            torch, lambda: losses.append(step(I7_DDP_STEPS - 1)["loss"].item()),
            "uplifting step", quiet=True)
        params = [p.detach().clone() for p in state.params]
        return params, ms, losses, counted["launches"]

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with patched(torch.backends.cudnn, deterministic=True):
            t1 = time.time()
            plain = uplift_run(False)
            t2 = time.time()
            ddp = uplift_run(True)
            run_s = {"store": store_s, "plain": t2 - t1, "ddp": time.time() - t2}
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    differ = sum(int((a != b).sum()) for a, b in zip(ddp[0], plain[0]))
    res["uplift_ddp"] = dict(differing_params=differ, algorithms="deterministic",
                             ms_plain=plain[1], ms_ddp=ddp[1], losses_plain=plain[2],
                             losses_ddp=ddp[2], launches_plain=plain[3], launches_ddp=ddp[3],
                             parts_s=run_s, seconds=time.time() - t)
    log("item7", step="b_uplift_ddp", config=f"connectstage_large_b{B}_steps{I7_DDP_STEPS}",
        algorithms="deterministic", differing_params=differ,
        ms_plain=json.dumps([round(x, 2) for x in plain[1]]),
        ms_ddp=json.dumps([round(x, 2) for x in ddp[1]]),
        losses=json.dumps([round(x, 4) for x in ddp[2]]), launches_per_step_plain=plain[3],
        launches_per_step_ddp=ddp[3],
        parts_s=json.dumps({k: round(v, 2) for k, v in run_s.items()}),
        seconds=f"{time.time() - t:.1f}")
    if differ or ddp[2] != plain[2]:
        raise AssertionError(f"the DDP trainer differs from the plain one in {differ} "
                             f"parameters; losses {ddp[2]} vs {plain[2]}")
    del store_d
    torch.cuda.empty_cache()

    # (c) the reference weights zip through hub.full_pipeline(weights_url=...)
    t = time.time()
    with tempfile.TemporaryDirectory() as d:
        zpath, refs = reference_weights_zip(torch, d)
        with patched(PRW, CACHE_DIR=os.path.join(d, "cache")):
            out = io.StringIO()
            t1 = time.time()
            with contextlib.redirect_stdout(out):
                pipe = hub.full_pipeline(weights_url=f"file://{zpath}", device=DEVICE)
            first_s, first_out = time.time() - t1, out.getvalue()
            out = io.StringIO()
            t1 = time.time()
            # the second call resolves its checkpoints from the cache; its models are not
            # built again (they are the first call's)
            with contextlib.redirect_stdout(out), \
                    patched(hub, TableTennisPipeline=lambda ck, device=None, **kw: ck):
                cached_ck = hub.full_pipeline(weights_url=f"file://{zpath}", device=DEVICE)
            cached_s, cached_out = time.time() - t1, out.getvalue()
            cached_ok = sorted(cached_ck) == sorted(refs) and all(
                os.path.isfile(v) for v in cached_ck.values())
    direct = {slot: PP.port_cnn_state_dict(refs[slot], get_detector(*nt)[0].state_dict())
              for slot, nt in (("ball_aux", ("wasb", "ball")), ("table_aux", ("hrnet", "table")))}
    direct["uplifting"] = PP.port_uplifting_state_dict(refs["uplifting"])
    twin = copy.copy(pipe)  # the seeded b2 detectors shared; the other slots mapped directly
    chunk = pipe.ball_detector.chunk
    twin.ball_detector_aux = BallDetector("wasb", direct["ball_aux"], chunk, device=DEVICE)
    twin.table_detector_aux = TableDetector("hrnet", direct["table_aux"], chunk, device=DEVICE)
    twin.uplifting_model = UpliftingModel(direct["uplifting"], device=DEVICE)
    frames = synthetic_frames(I7_ZIP_FRAMES)
    for k in ops.ALL:
        getattr(ops, k).launches = 0
    got = pipe.run_rally(frames, fps=50)
    zip_launches = {k: getattr(ops, k).launches for k in ops.ALL if getattr(ops, k).launches}
    want = twin.run_rally(frames, fps=50)
    # the uplifting slot on a track of its own (random detectors find no ball to lift)
    rng = np.random.default_rng(10)
    track = (np.stack([np.linspace(300, 1500, 30), 500 + 80 * np.sin(np.linspace(0, 3, 30))], 1)
             + rng.normal(0, 2, (30, 2))).astype(np.float32)
    table = np.concatenate([rng.uniform([400, 500], [1500, 900], (13, 2)), np.ones((13, 1))],
                           1).astype(np.float32)
    times = (np.arange(30) / 50.0).astype(np.float32)
    got["uplifting"] = np.concatenate([a.ravel() for a in pipe.uplifting_model.predict(
        track, table, times)])
    want["uplifting"] = np.concatenate([a.ravel() for a in twin.uplifting_model.predict(
        track, table, times)])
    equal = {k: (got[k] is None and want[k] is None) or (
        got[k] is not None and want[k] is not None
        and np.array_equal(np.asarray(got[k]), np.asarray(want[k]), equal_nan=True))
        for k in want}
    converted = first_out.count("  ok")
    res["weights_zip"] = dict(first_s=first_s, cached_s=cached_s, converted=converted,
                              cached_ok=cached_ok, equal=equal, launches=zip_launches,
                              seconds=time.time() - t)
    log("item7", step="c_weights_zip", first_s=f"{first_s:.2f}", cached_s=f"{cached_s:.2f}",
        converted=converted, cached_ok=cached_ok, equal=json.dumps(equal),
        launches=json.dumps(zip_launches),
        seconds=f"{time.time() - t:.1f}")
    if converted != 3 or not cached_ok or "downloading" in cached_out \
            or "extracting" in cached_out or "  ok" in cached_out:
        raise AssertionError(f"the zip converted {converted} checkpoints; the second call "
                             f"printed {cached_out!r}")
    if not all(equal.values()):
        raise AssertionError(f"the weights-zip pipeline differs from the direct map: {equal}")
    want_launches = rally_launches(pipe, I7_ZIP_FRAMES, 1)
    if zip_launches != want_launches:
        raise AssertionError(f"the weights-zip piece launched {zip_launches}, expected "
                             f"{want_launches}")
    del pipe, twin
    torch.cuda.empty_cache()

    # (d) extraction and QA on the card
    t = time.time()
    c = torch.tensor([1.0, 9.0, 5.0], dtype=torch.float64)
    look = torch.tensor([0.0, 0.0, 0.76], dtype=torch.float64)
    fwd = (look - c) / (look - c).norm()
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64))
    Mext = get_Mext(c, fwd, right / right.norm()).numpy()
    Mint = np.array([[2710.0, 0, 1280], [0, 2907.0, 720], [0, 0, 1]])
    with tempfile.TemporaryDirectory() as d:
        table_px = raw_ttst(d, Mint, Mext)
        r_imgs, _, Mints, Mexts, _, spins, _ = XT.transform_annotations(
            d, ("01",), I7_TTST_RES, device=DEVICE)
    cams = []
    for Mi, Me in zip(Mints, Mexts):
        err = np.linalg.norm(project_np(Mi, Me, np.asarray(TABLE_POINTS, np.float64)) - table_px,
                             axis=1)
        cams.append(dict(max_px=float(err.max()), inliers=int((err < 3.5).sum())))
    kps = np.concatenate([table_px, np.ones((13, 1))], -1).astype(np.float32)
    bad = kps.copy()
    a, b = QA.LEFT_RIGHT_PAIRS[0]
    bad[[a, b], :2] = bad[[b, a], :2]
    flagged, base = QA.detect_left_right_swaps(bad, I7_TTST_RES, device=DEVICE)
    rng = np.random.default_rng(9)
    times = torch.from_numpy(np.cumsum(rng.uniform(0.015, 0.025, 64)).astype(np.float32))
    xs = torch.from_numpy((np.cumsum(rng.normal(0, 3, (64, 17, 2)), 0) + 500).astype(np.float32))
    smooth_card = one_euro_trajectory(times.to(DEVICE), xs.to(DEVICE)).cpu()
    smooth_cpu = one_euro_trajectory(times, xs)
    smooth_err = float((smooth_card - smooth_cpu).abs().max() / smooth_cpu.abs().max())
    res["extract"] = dict(events=len(Mints), spins=spins, cameras=cams, flagged=flagged,
                          swap_base_px=base, smooth_rel_err=smooth_err, seconds=time.time() - t)
    log("item7", step="d_extract", events=len(Mints), spins=json.dumps(spins),
        cameras=json.dumps(cams), flagged=json.dumps(flagged), swap_base_px=f"{base:.2f}",
        smooth_rel_err=f"{smooth_err:.3g}", seconds=f"{time.time() - t:.1f}")
    if len(Mints) != 2 or spins != [1, 2] or any(
            cam["max_px"] > I7_PX_TOL or cam["inliers"] < I7_MIN_INLIERS for cam in cams):
        raise AssertionError(f"TTST extraction on the card: {res['extract']}")
    if 0 not in flagged:
        raise AssertionError(f"annotation QA on the card flagged {flagged} (planted swap: "
                             f"pair 0)")
    if smooth_err > I7_SMOOTH_TOL:
        raise AssertionError(f"one_euro_trajectory on the card differs from the CPU by "
                             f"{smooth_err}")
    res["seconds"] = time.time() - t_phase
    log("item7", seconds=f"{res['seconds']:.1f}")
    return res


def pytest_counts(output: str) -> dict:
    """{"passed", "failed", "errors", "skipped", "seconds"} from the summary line that ends
    pytest's output ("1 failed, 222 passed, 2 warnings in 51.08s"); raises without one."""
    import re

    for line in reversed(output.strip().splitlines()):
        done = re.search(r"\bin ([0-9.]+)s\b", line)
        found = dict((kind, int(n)) for n, kind in
                     re.findall(r"(\d+) (passed|failed|errors?|skipped)\b", line))
        if done and found:
            counts = {k: found.get(k, 0) for k in ("passed", "failed", "skipped")}
            counts["errors"] = found.get("error", 0) + found.get("errors", 0)
            counts["seconds"] = float(done.group(1))
            return counts
    raise AssertionError("pytest printed no summary line")


def card_tests_verdict(counts: dict, returncode: int, minimum: int = CARD_TESTS_MIN) -> None:
    """Raises unless the child pytest exited 0 with no failure or error and at least
    `minimum` cases passed."""
    if returncode != 0 or counts["failed"] or counts["errors"] or counts["passed"] < minimum:
        raise AssertionError(f"the card tests: exit code {returncode}, {counts} (at least "
                             f"{minimum} must pass, none fail)")


def run_card_tests(torch, later=()):
    """Phase card_tests: CARD_TEST_FILES in a child pytest (without tests/conftest.py, which
    imports JAX) on the kernels the build phase left in `_build/`, after the parent gives
    back its cached device memory. Meanwhile the parent runs `later`: the earlier phases'
    CPU references and the gates that read them, which use no card."""
    import gc
    import re
    import tempfile

    from upliftingtabletennis_torch.ops import _build

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    built = sorted(os.listdir(_build.BUILD_DIR))
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
           "--durations=8", *CARD_TEST_FILES]
    t = time.time()
    with tempfile.TemporaryFile("w+") as out:
        child = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                 stdout=out, stderr=subprocess.STDOUT, text=True)
        try:
            for check in later:
                check()
            returncode = child.wait(timeout=CARD_TESTS_TIMEOUT_S - (time.time() - t))
        finally:
            if child.poll() is None:  # a check failed, or the tests outlasted their limit
                child.kill()
                child.wait()
        seconds = time.time() - t
        out.seek(0)
        output = out.read()
    if returncode != 0:
        print(output[-12000:], file=sys.stderr, flush=True)
    counts = pytest_counts(output)
    slowest = [line.split()[0] + " " + line.split()[-1].split("::")[-1]
               for line in output.splitlines() if re.match(r"[0-9.]+s (call|setup) ", line)]
    log("card_tests", passed=counts["passed"], failed=counts["failed"], errors=counts["errors"],
        skipped=counts["skipped"], minimum=CARD_TESTS_MIN, exit_code=returncode,
        seconds=f"{seconds:.1f}", pytest_s=counts["seconds"], slowest=json.dumps(slowest))
    card_tests_verdict(counts, returncode, CARD_TESTS_MIN)
    if sorted(os.listdir(_build.BUILD_DIR)) != built:
        raise AssertionError(f"the card tests built kernels of their own: "
                             f"{sorted(set(os.listdir(_build.BUILD_DIR)) - set(built))}")
    return {**counts, "exit_code": returncode, "wall_s": seconds, "slowest": slowest}


def profile_calls(torch, fn, label, categories=None, calls=1, quiet=False):
    """Device time by kernel over `calls` warm calls of `fn` (torch.profiler), the idle
    share, the kernel launches per call, and the Python lines that make the host wait for
    the card; `quiet` returns the numbers (wall, busy and launches per call) and no more."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.time()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t)
    avg = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in avg
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    launches = sum(e.count for e in avg if e.key in LAUNCH_CALLS)
    res = {"what": label, "wall_ms": wall_ms / calls, "device_busy_ms": busy_ms / calls,
           "idle_share": 1 - busy_ms / wall_ms, "launches": launches / calls}
    if quiet:
        return res
    host = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in avg
            if e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0]
    host.sort(key=lambda r: -r[1])
    res.update(top=[{"kernel": k[:120], "ms": ms, "count": n} for k, ms, n in kernels[:40]],
               host_top=[{"op": k[:120], "self_ms": ms, "count": n} for k, ms, n in host[:15]])
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    res["host_syncs"] = dict(where)
    if categories:  # device time of the kernels each top-level op launched, over busy
        total = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CPU}
        res["category_ms"] = {c: total.get(op, 0.0) for c, op in categories.items()}
        res["category_share"] = {c: ms / busy_ms for c, ms in res["category_ms"].items()}
        log("profile", category_ms=json.dumps({c: round(v, 3) for c, v in
                                               res["category_ms"].items()}),
            category_share=json.dumps({c: round(v, 4) for c, v in
                                       res["category_share"].items()}))
    log("profile", what=json.dumps(label), wall_ms=f"{wall_ms:.1f}",
        device_busy_ms=f"{busy_ms:.1f}", idle_share=f"{res['idle_share']:.3f}",
        host_syncs=json.dumps(dict(where)))
    for r in res["top"][:20]:
        print(f"  {r['ms']:9.3f} ms  x{r['count']:<4d} {r['kernel'][:100]}", flush=True)
    print("  host ops by self CPU time:", flush=True)
    for r in res["host_top"]:
        print(f"  {r['self_ms']:9.3f} ms  x{r['count']:<4d} {r['op'][:100]}", flush=True)
    return res


def k6_summary(k6_res):
    """The kernels-line entry of K6: one nms_mask call at the largest timed N."""
    head = max(k6_res["timed"], key=lambda e: e["n"])
    return {"name": "nms_mask", "route": "cuda",
            "source": "upliftingtabletennis_torch/ops/csrc/nms.cu",
            "replaces": "upliftingtabletennis_tpu/ops/nms.py:39",
            "launches": k6_res["launches"]["overlap_words"] + k6_res["launches"]["resolve_words"],
            "max_abs_err": k6_res["differing_bits"],
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "overlap_ms": head["overlap_ms"], "resolve_ms": head["resolve_ms"],
            "ms_pipelined": head["ms_pipelined"],
            "overlap_ms_pipelined": head["overlap_ms_pipelined"],
            "resolve_ms_pipelined": head["resolve_ms_pipelined"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes greedy NMS (torchvision is not "
                            "installed)",
            "per": f"one nms_mask call at N = {head['n']}, thresh 0.5: its 2 launches "
                   f"(mask, resolve); max_abs_err counts differing bits; launches over the k6 "
                   f"phase's {k6_res['calls']} nms calls",
            "per_size": k6_res["timed"]}


def s1_summaries(physics_res, datagen_res, fit_res):
    """The kernels-line entries of S1's two modes: forward at the datagen batch (launches
    over the datagen phase's warm generate_dataset call), tangent at the fit's starts
    (launches over one fit_physics call)."""
    common = {"route": "cuda", "source": "upliftingtabletennis_torch/ops/csrc/physics.cu",
              "replaces": "upliftingtabletennis_tpu/core/physics.py:335", "library_ms": None,
              "library_note": "no PyTorch call integrates the flight; the plain version runs "
                              "about 300 elementwise launches per step"}
    fwd = max(physics_res["forward"], key=lambda e: e["ms"])
    tan = physics_res["tangent"]
    keys = ("ms", "ms_pipelined", "plain_ms", "bound_ms", "bound_by", "bound_term", "bytes_ms",
            "ops_ms", "chain_ms", "chain_cycles_per_step", "flops_per_step",
            "op_latency_cycles", "one_trajectory_ms", "cycles_per_step",
            "cycles_per_step_pipelined", "one_trajectory_cycles_per_step")
    return [
        {"name": "simulate", **common, "launches": datagen_res["launches"],
         "max_abs_err": max(max(e["max_abs_err"].values()) for e in physics_res["forward"]),
         **{k: fwd[k] for k in keys},
         "per": f"one forward-mode call at {S1_BATCH} trajectories x {S1_FRAMES} frames (the "
                f"datagen batch; the slower direction); chain_ms: the serial chain worked out "
                f"from the code (s1_chain); one_trajectory_ms: the kernel on one trajectory, "
                f"measured; launches over one generate_dataset call of "
                f"{DATAGEN_ACCEPTED} accepted"},
        {"name": "simulate_tangent", **common, "launches": fit_res["launches"]["simulate_tangent"],
         "max_abs_err": max(tan["max_abs_err"].values()), **{k: tan[k] for k in keys},
         "eval_batch": tan["eval_batch"],
         "per": f"one tangent-mode call at {FIT_STARTS} starts x {FIT_FRAMES} frames (fit_physics "
                f"at its defaults); chain_ms: the serial chain worked out from the code "
                f"(s1_chain); one_trajectory_ms: the kernel on one start (9 threads), "
                f"measured; launches over one fit_physics call"},
    ]


def kernel_ops():
    """The wrappers whose launch counts the main path is held to."""
    import upliftingtabletennis_torch.ops.dwconv as k4
    import upliftingtabletennis_torch.ops.flash_attention as k3
    import upliftingtabletennis_torch.ops.fused_attention as k1
    import upliftingtabletennis_torch.ops.fused_conv as k5
    import upliftingtabletennis_torch.ops.fused_ffn as k2
    import upliftingtabletennis_torch.ops.nms as k6

    class Ops:
        fused_attention_block = k1.fused_attention_block
        fused_ln_ffn = k2.fused_ln_ffn
        conv3x3_bias_act = k5.conv3x3_bias_act
        conv1x1_bias_act = k5.conv1x1_bias_act
        flash_cross_attention = k3.flash_cross_attention
        overlap_words = k6.overlap_words  # K6's two kernels: 2 launches per nms_mask call
        resolve_words = k6.resolve_words
        depthwise_conv3x3 = k4.depthwise_conv3x3
        dwconv3x3_backward = k4.dwconv3x3_backward  # 2 launches per call: the pass and its sum
        ALL = ("fused_attention_block", "fused_ln_ffn", "conv3x3_bias_act", "conv1x1_bias_act",
               "flash_cross_attention", "overlap_words", "resolve_words", "depthwise_conv3x3",
               "dwconv3x3_backward")

    return Ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm b2 predict, one warm chunk of the four "
                         "detectors, one warm b2 training step, one warm ViTPose training "
                         "step, one warm rally piece, one "
                         "warm generate_dataset, one warm fit_physics and one warm uplifting "
                         "training step with torch.profiler (time by kernel), and the "
                         "uplifting CLI's epoch 1")
    opts = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from upliftingtabletennis_torch.ops import _build

    # the f32 references run in full f32 (no TF32 in matmuls or cuDNN convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build, started first (nvcc needs no card); meanwhile 1. env, and the host work of
    # later phases that needs no kernel: item7's BlurBall tree, the rally's inputs and the
    # HRNets' conv shapes (on the meta device)
    global CARD
    t = time.time()
    with ThreadPoolExecutor(max_workers=3) as prep:
        built = prep.submit(timed, _build.build)
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        log("env", device=json.dumps(kind), count=torch.cuda.device_count(),
            torch=torch.__version__, cuda=torch.version.cuda)
        print(smi, flush=True)
        CARD = smi
        item7_pre = start_item7(prep)
        rally_made = prep.submit(rally_inputs, torch)
        _, prep_s = timed(hrnet_conv_shapes, torch)
        reports, build_s = built.result()
        rally_made.result()
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"  {src}: {line.strip()}", flush=True)
    log("build", seconds=f"{build_s:.1f}", wall_s=f"{time.time() - t:.1f}",
        conv_shapes_s=f"{prep_s:.1f}", compiled=sorted(reports))

    Ops = kernel_ops()
    # the CPU references of later phases and the gates that read them, run beside the
    # card tests so that no phase times its work beside them
    later = []
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    k1_entries = run_k1(torch, F, Ops, gen, profile=opts.profile)
    k2_entries = run_k2(torch, F, Ops, gen, profile=opts.profile)
    probe_res = run_probe(torch, Ops)
    torch.cuda.empty_cache()
    slice_res = run_slice(torch, Ops, profile=opts.profile)
    k5_entries = run_k5(torch, F, gen)
    frames = synthetic_frames(N_FRAMES + 2)
    hrnet_res = run_hrnet(torch, frames)
    det_res = run_detectors(torch, Ops, frames, profile=opts.profile)
    k3_entries = run_k3(torch, F, Ops, gen)
    tome_res = run_tome(torch, Ops, frames, profile=opts.profile)
    flip_res = run_flip(torch, Ops, frames)
    b0_res = run_b0(torch, Ops, frames)
    k6_res = run_k6(torch, Ops)
    vit_res = run_vitpose(torch, Ops, frames, profile=opts.profile)
    torch.cuda.empty_cache()
    k4_entries, k4_bwd_entries = run_k4(torch, F, Ops, gen)

    # the SASS readings beside the phases from here on, after the kernel phases
    sass = ThreadPoolExecutor(max_workers=1)
    sass_k = sass.submit(sass_counts, _build, ("flash_attention.cu", "fused_conv.cu"))
    sass_s1 = sass.submit(s1_sass, _build, _build._lib_path("physics.cu"))
    sass.shutdown(wait=False)
    train_res = run_train(torch, Ops, frames, profile=opts.profile)

    torch.cuda.empty_cache()
    from upliftingtabletennis_torch import hub

    pipe = hub.full_pipeline(device=DEVICE)
    vt_res = run_vitpose_train(torch, Ops, frames, pipe, later, profile=opts.profile)
    torch.cuda.empty_cache()
    rally_res = run_rally_phase(torch, Ops, pipe, profile=opts.profile)
    uplifting_res = run_uplifting(torch)
    calib_res = run_calib(torch, pipe)
    log("sass", counts=json.dumps(sass_k.result()))
    physics_res = run_physics(torch, reports.get("physics.cu", ""), sass_s1.result())
    datagen_res = run_datagen(torch, later, profile=opts.profile)
    fit_res = run_fit(torch, pipe, datagen_res.pop("tracks"), profile=opts.profile)
    del pipe
    torch.cuda.empty_cache()
    uplift_res = run_uplift_train(torch, profile=opts.profile)

    torch.cuda.empty_cache()
    closed_res = run_closed_loop(torch, Ops, later)
    torch.cuda.empty_cache()
    item7_res = run_item7(torch, Ops, item7_pre)
    card_res = run_card_tests(torch, later)

    # 27. hygiene
    banned = [m for m in ("jax", "flax", "upliftingtabletennis_tpu") if m in sys.modules]
    if banned:
        raise AssertionError(f"imported {banned}")
    log("hygiene", jax_free=True)

    def summary(name, source, replaces, entries, launches=None, per=None):
        staged = [e for e in entries if e["depth"]]

        def per_forward(key):  # summed over the launches of one forward (or step)
            return sum(e[key] * e["depth"] for e in staged)

        bytes_share = sum(e["bound_ms"] * e["depth"] for e in staged
                          if e["bound_by"] == "bytes")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": slice_res["launches"][name] if launches is None else launches,
                "max_abs_err": max(e["max_abs_err"] for e in entries),
                "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
                "bound_ms": per_forward("bound_ms"),
                "bound_by": "bytes" if bytes_share * 2 > per_forward("bound_ms") else "operations",
                "library_ms": per_forward("library_ms"),
                **({"ms_pipelined": per_forward("ms_pipelined"),
                    "library_ms_pipelined": per_forward("library_ms_pipelined")}
                   if all("ms_pipelined" in e for e in staged) else {}),
                "per": per or "one b2 forward at batch %d (sum over its 16 blocks)" % CHUNK,
                "per_stage": entries}

    def k5_summary(name, replaces):
        entries = [e for e in k5_entries if e["kernel"] == name]

        def per_forward(key):  # summed over the launches of one WASB forward at chunk 8
            return sum(e[key] * e["per_forward"]["wasb"] for e in entries)

        bytes_share = sum(e["bound_ms"] * e["per_forward"]["wasb"] for e in entries
                          if e["bound_by"] == "bytes")
        n = sum(e["per_forward"]["wasb"] for e in entries)
        return {"name": name, "route": "cuda",
                "source": "upliftingtabletennis_torch/ops/csrc/fused_conv.cu",
                "replaces": replaces, "launches": det_res["launches"][name],
                "max_abs_err": max(e["max_abs_err"] for e in entries),
                "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
                "bound_ms": per_forward("bound_ms"),
                "bound_by": "bytes" if bytes_share * 2 > per_forward("bound_ms") else "operations",
                "library_ms": per_forward("library_ms"),
                "ms_pipelined": per_forward("ms_pipelined"),
                "library_ms_pipelined": per_forward("library_ms_pipelined"),
                "per": f"one WASB forward at batch {HR_CHUNK}, 1280x704 "
                       f"(sum over its {n} launches)",
                "per_shape": entries}

    kernels = [
        summary("fused_attention_block", "upliftingtabletennis_torch/ops/csrc/fused_attention.cu",
                "upliftingtabletennis_tpu/ops/fused_attention.py:34", k1_entries),
        summary("fused_ln_ffn", "upliftingtabletennis_torch/ops/csrc/fused_ffn.cu",
                "upliftingtabletennis_tpu/ops/fused_ffn.py:50", k2_entries),
        probe_summary(probe_res, "attention_probe",
                      "upliftingtabletennis_torch/ops/csrc/fused_attention_probe.cu",
                      "tools/probe_attn_phases.py:37", ("full", "no_softmax", "no_ln")),
        probe_summary(probe_res, "ffn_probe", "upliftingtabletennis_torch/ops/csrc/fused_ffn_probe.cu",
                      "tools/probe_ffn_phases.py:41", ("full", "no_dw", "no_gelu", "no_dwgelu")),
        k5_summary("conv3x3_bias_act", "upliftingtabletennis_tpu/ops/fused_conv.py:70"),
        k5_summary("conv1x1_bias_act", "upliftingtabletennis_tpu/ops/fused_conv.py:98"),
        summary("flash_cross_attention", "upliftingtabletennis_torch/ops/csrc/flash_attention.cu",
                "upliftingtabletennis_tpu/ops/flash_attention.py:34", k3_entries,
                launches=tome_res["launches"]["flash_cross_attention"],
                per=f"one b2 ToMe forward at batch {HR_CHUNK}, 1600x896, ratio {TOME_RATIO} "
                    f"(sum over its 16 blocks); launches over the tome phase's "
                    f"{N_FRAMES // HR_CHUNK} forwards"),
        k6_summary(k6_res),
        summary("depthwise_conv3x3", "upliftingtabletennis_torch/ops/csrc/dwconv.cu",
                "upliftingtabletennis_tpu/ops/dwconv.py:50", k4_entries,
                launches=train_res["launches"]["depthwise_conv3x3"],
                per=f"one b2 training step at batch {TRAIN_BATCH}, 1600x896 (sum over its "
                    f"{B2_PER_FORWARD} launches: K2's recompute in each of the 16 blocks, at "
                    f"the block's hidden shape)"),
        summary("dwconv3x3_backward", "upliftingtabletennis_torch/ops/csrc/dwconv.cu",
                "upliftingtabletennis_tpu/ops/dwconv.py:155", k4_bwd_entries,
                launches=train_res["launches"]["dwconv3x3_backward"],
                per=f"one b2 training step at batch {TRAIN_BATCH}, 1600x896 (sum over its "
                    f"{B2_PER_FORWARD} calls, {2 * B2_PER_FORWARD} launches: each call the fused "
                    f"pass and the sum of its partials: "
                    f"dx, dw and db of K2's recompute in each of the 16 blocks); library: "
                    f"aten.convolution_backward (dx, dw, db) in channels_last bf16"),
    ]
    kernels += s1_summaries(physics_res, datagen_res, fit_res)
    next(e for e in kernels if e["name"] == "simulate")["launches_generate_production"] = \
        uplift_res["generation"]["s1_launches"]
    for entry in kernels:  # the b0 trainer step under DDP at world size 1: K1, K2, K4
        if vt_res["ddp"]["launches"].get(entry["name"]):
            entry["launches_ddp"] = vt_res["ddp"]["launches"][entry["name"]]
    for entry in kernels:  # the rally's main path: K1, K2, K5a and K5b over 64 frames
        if rally_res["launches"].get(entry["name"]):
            entry["launches_rally"] = rally_res["launches"][entry["name"]]
        if closed_res["launches"].get(entry["name"]):  # b0 and WASB at 960x544
            entry["launches_closed_loop"] = closed_res["launches"][entry["name"]]
        eval_launches = {**closed_res["eval"]["combined"]["launches"],
                         **closed_res["eval"]["physics_fit"]["s1_launches"]}
        if eval_launches.get(entry["name"]):  # closed_loop (d): the evaluation entry points
            entry["launches_eval"] = eval_launches[entry["name"]]
        blurball = item7_res["blurball"]["launches_per_step"]
        if blurball.get(entry["name"]):  # item7 (a): one BlurBall b2 step
            entry["launches_blurball"] = blurball[entry["name"]]
        if item7_res["weights_zip"]["launches"].get(entry["name"]):  # item7 (c): one piece
            entry["launches_weights_zip"] = item7_res["weights_zip"]["launches"][entry["name"]]
    total = time.time() - T0
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "kernels": kernels,
                       "probe": probe_res, "slice": slice_res, "hrnet": hrnet_res, "detectors": det_res,
                       "tome": tome_res, "flip": flip_res, "b0": b0_res, "k6": k6_res,
                       "vitpose": vit_res, "k4": k4_entries, "k4_backward": k4_bwd_entries,
                       "train": train_res, "vitpose_train": vt_res, "rally": rally_res,
                       "uplifting": uplifting_res,
                       "calib": calib_res, "physics": physics_res, "datagen": datagen_res,
                       "fit": fit_res, "uplift_train": uplift_res,
                       "closed_loop": closed_res, "item7": item7_res,
                       "card_tests": card_res, "total_s": total}, f,
                      indent=1)
    print(f"[done] total_s={total:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
