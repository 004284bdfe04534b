#!/usr/bin/env python3
"""Smoke run of the PyTorch port (feat3dnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from
feat3dnet_tpu_torch/csrc with nvcc (one process per source), then:
  1. holds K1-K3 against their plain PyTorch versions at the forward's
     shapes (FPS and ball query index-exact on the four vendored clouds
     and a synthetic masked case, FPS also at the training shape, masked,
     on duplicated points, an all-masked cloud and 70 000 points
     (k1_cases), the ball query also at the training shape, on an
     all-masked cloud, 70 000 points, N and M off every boundary and the
     cluster-pair validator's shape, 512 masked clusters of up to 1 024
     points with one centre each (k2_cases); the fused describe kernel on 7 680
     clusters within stated tolerances, with seeded weights and, in f32
     and bf16_act, with the trained weights at phase 1's and phase 13's
     limits);
  2. drives the forward/serving path with launch counters reset:
     Feat3DNet eval at the paper config (seeded weights, perturbed BN
     statistics) on each vendored cloud, then 8 ClusterDescriptorServer
     requests of 7 680 packed clusters; every kernel must have launched;
  3. checks those outputs (shapes, unit norms, agreement with the model
     on the CPU and with the model path on the card);
  4. times K1-K3 against their plain versions (CUDA events, in turns)
     and the server's descriptors/s; per vendored cloud and at the
     training shape (k1_step) K1's time at npoint 2, 64 and 512, its time
     per step and its set-up (fps_step_split), at every cluster size, with
     its shared memory and resident clusters; per vendored cloud, the
     Oxford pair and the training batch (k2_step) K2's work counted on the
     card (k2_counts: points scanned per centre, balls with >= ns hits,
     pairs tested and the longest chain of the first design and of the
     cluster design), its shared memory, CTAs per SM and resident clusters
     per cluster size, and its time split (ball_query_time_split: the
     plain version, the kernel alone, the wrapper, the kernel ending after
     its count and after its exchange, and at every cluster size, in
     turns); per K3 forward mode and weights
     (seeded, trained; k3_step) K3's shared memory and blocks per SM, its
     time split (fused_describe_time_split: the weight packing, the kernel
     leaving each cluster after each stage, the kernel alone, the whole
     wrapper on weights packed once, in turns) and the rows each of its
     two pooled convs re-sums;
  5. holds the Morton layout built on the card (build_sorted_cloud)
     bit-equal to the host's numpy build in all four fields and times both
     (layout_step), then holds K4 (sorted ball query) and K5 (ball max)
     index-exact and K6
     (detector-only tower) within 1e-5 against their plain versions at the
     extraction shapes: the vendored clouds at their buckets and a seeded
     200 000-point synthetic cloud (plain versions on 8 192 of its
     centres), with the trained weights (assets/ckpt4480_variables.npz);
     per cloud, K4's work counted in torch (k4_counts: hit blocks per
     tile, tests per centre under the tile's and the per-centre cull),
     its shared memory and blocks per SM, and its time split
     (sorted_ball_query_time_split: the hit mask, the kernel alone on it,
     the whole wrapper, in turns); per cloud, K5's work counted in torch
     (k5_counts: tests per centre under the tile's and the per-centre
     cull, covered blocks, blocks the value skip drops, the padding share),
     its shared memory and blocks per SM and its time split
     (ball_max_time_split: the torch hit mask, the pre-pass, the walk, the
     kernel, the whole wrapper, in turns); per cloud and K6 mode, K6's shared
     memory and blocks per SM, its time split (fused_detect_time_split:
     the weight packing, the kernel leaving each cluster after each stage,
     the kernel alone, the whole wrapper on weights packed once, in turns)
     and the pool's candidates it re-sums;
  6. drives the extraction path with launch counters reset:
     InferencePipeline.extract on the five clouds, default route and
     use_fused_detector, then process_directory over examples/data; K3-K6
     must have launched;
  7. checks the extraction: the hashed route equals the dense route in
     keypoints (features within 1e-4, attention 1e-5); the fused route
     keeps >= 99 % of the keypoints, >= 99 % of the shared ones with
     features within 1e-4 and all at cosine >= 0.9999 (K3's folded BN
     rounds differently from the model tower); both routes on the layout
     built on the host (host_layout) give the same outputs bit for bit;
     every written file is (K, 35) float32 rows;
  8. times K4-K6 against their plain versions and the extract latency of
     both routes per cloud, on the device layout and in turns on the host
     layout (beside it the device layout's and the host layout's own
     time), and profiles
     one extract of each of the two largest clouds per route;
  9. holds K7-K10 (the fused training passes) against their plain versions
     at the training shapes: 18 clouds of 4 096 points (the vendored clouds
     cropped to 20 m and resampled under several seeds), FPS + K2 groups
     (64, 9 216, 3), 256 clusters with every slot tied, both tower plans,
     f32 and bf16 cotangents; two kernel runs must be bit-equal; then K8,
     K9 and K10's top call on tie- and pad-heavy inputs (check_pool_cases:
     every slot tied, 40 of 64 slots, ReLU-zero channels);
  10. drives the training path with launch counters reset: cli.train
     --fused_towers for 20 steps at the paper config on a 12-entry dataset
     written under build/ (three z-rotations of each vendored cloud, and a
     clusters/ folder of 32 cluster pairs cropped from them), validating
     after step 1 and every 10 steps, then --auto_resume for 4 more; K1,
     K2 and K7-K10 must have launched, every loss be finite, the resumed
     run start at step 20, and an FP Rate in [0, 1] be logged at steps 1,
     10 and 20;
  11. checks a step: the fused route against the autograd route (f32
     cotangents: loss, batch_stats, grads per leaf; bf16: cosine >= 0.99
     per leaf), the card against the CPU (loss, grads, params after Adam),
     and that 30 steps with the kernels on one batch lower the loss;
  12. times a training step per route (median of 12, synchronised, with
     peak memory and a torch.profiler breakdown) and K7-K10 per call
     against their plain versions, each beside its bound (the products on
     the tensor cores at the TF32 peak, conv 0's on the CUDA cores at the
     f32 peak; the all-f32 bound printed beside it) and their ptxas and SASS
     lines, then splits K8's and K10's time by stage (train_final_time_split:
     K8 leaving each cluster after the recompute; train_bwd_time_split: K10
     after the recompute, the dy step, dW, dy W^T) and prints each training
     launch's shared memory and blocks per SM (occupancy_report);
  13. holds K3's bf16-activation mode against its plain version on the 7 680
     serving clusters with phase 1's weights (min cosine >= 0.9999, >= 99.9 %
     of descriptors within 2^-8, attention relative <= 1e-2) and prints it
     against f32 K3 (min cosine >= 0.995);
  14. drives the bf16 serving path with counters reset:
     ClusterDescriptorServer(bf16_act=True), 8 describe_packed and 8 __call__
     requests; only K3's bf16 mode may launch, answers equal across
     requests; descriptors/s beside the f32 server's, in turns;
  15. holds K3's decomposition bodies against their plain versions: stream
     (exact), matmul (_ablate_kernel_t's) and matmul_2d (_ablate_kernel_2d's),
     both within 1e-5 max|ref| of the plain bodies on TF32 operands (the
     kernel's pooled convs) and within ABLATE_F32_LIMIT of the all-f32 ones;
     then with counters reset splits K3's time (serving_time_split):
     elementwise share (f32 - matmul), product share (matmul - stream) and
     pct_matmul_floor (matmul / f32) of the f32 forward, which must hold
     stream <= matmul, matmul_2d <= f32;
  16. holds K6's folded mode (attention relative 1e-5, orientation 1e-5
     rad) and bf16_operands mode (>= 99.9 % of centres within 1e-4 relative
     attention and 1e-4 rad, while the f32 kernel against the same plain
     bf16_operands version must fail that limit) against their plain
     versions at phase 5's shapes and trained weights, after a counted run
     of both modes on every cloud; folded vs unfolded attention <= 1e-3
     relative; times per mode;
  17. runs the model with ModelConfig.compute_dtype bf16: the eval forward
     on the vendored clouds against f32 with the JAX package's gate
     (cosine > 0.98 on > 90 % of descriptors) and a median attention gap
     to f32 of at least 1e-4 (the bf16 rounding shows), then one training
     step, which takes the autograd route: a finite loss, no fused-tower
     launch;
  18. reruns the held-out accuracy: the 24-pair held-out set rebuilt from
     RandomState(0) (eval/heldout.py), the trained weights in
     ModelConfig(num_clusters=256, num_samples=64) under
     InferenceConfig(min_response_ratio=0, nms_radius=0.2) through
     process_directory on the default and the fused route (counters reset;
     K4 and K5, and K6 and K3 on the fused route, must launch); per route
     fig4 precision@1m within 1.0 point of 87.198 %, total putative and
     keypoints per cloud within 1 % of 24 567 and 1 023.8, registration
     success >= 20/24 (the record of
     examples/results/scaled_accuracy/inference_sweep.json); then
     cli.match --device cuda on the first pair's outputs;
  19. batched and pipelined extraction with the trained weights
     (batch_phase): on the union of the four vendored clouds (bucket
     32 768, 131 072 points) build_sorted_cloud_batch equal to the
     per-cloud builds in every field, K4 and K5 with segment= index-exact
     against their plain versions on every centre and equal per cloud to
     the cloud alone, each timed against its plain version and bound;
     then, launch counters reset, per route: extract_batch on the
     vendored clouds, extract_many (depth 2, batch_size 1 and 4) on 8
     seeded 120 000-point submap clouds (bucket 131 072), extract_many on
     the vendored clouds and an odd trailing cloud,
     process_directory(batch_size=4) and cli.infer --batch_size 4 --device
     cuda, every cloud bit-equal to extract, and extract_batch on a
     4 000-point cloud with a KITTI cloud (buckets 4 096 and 32 768)
     equal to extract; K3-K6 must have launched;
     one extract_batch launches K4 and K5 once (K6 and K3 once on the
     fused route); a cloud and a batch are queued with torch's sync debug
     mode set to raise; clouds/s of the extract loop,
     extract_many(batch_size=1), extract_batch(4) and
     extract_many(batch_size=4) in turns on a KITTI stream and the submap
     stream, 8 clouds each and 64 / 16 (past the pipeline's fill and
     drain), one profiled batch each (device busy share, top kernels); and
     a fresh process with and without warmup (the first extract against
     the next three);
  20. the workflow around the model (workflow_phase), at the paper config
     and TrainConfig() widths, under build/chip_smoke_workflow/:
     a. prepare: metadata.txt files for two datasets of crops of the
        vendored clouds (24 each, 6 m apart), cli.prepare train-cases
        --no_test_split, the train.txt read back through TripletDataset (and
        a 6-entry set, one step an epoch); cli.prepare submaps --normals on
        two seeded 5 000-point submap binaries in dataprep/submap.py's
        layout: (N, 6) float32 rows with unit normals and their metadata
        rows;
     b. TF1: assets/ckpt4480_variables.npz exported under the TF1 names
        (export_tf1_arrays); cli.infer --tf1_checkpoint and --variables over
        examples/data on both routes, every file bit-equal; cli.verify_parity
        --device cuda --cloud kitti_00_001554.bin against the --variables
        output: exit 0 with median cosine >= 0.999 (the internal K3 gate's
        cosines printed), and exit 1 with one descriptor kernel x 1.5;
     c. training through cli.train --fused_towers --device cuda, launch
        counters reset for each run: stage 1 (the two-stage script's flags,
        --num_epochs 1, 8 steps), stage 2 (--checkpoint stage 1
        --restore_exclude detection: before its first step every detector
        parameter's Adam step equals stage 1's count with zero moments), one
        step from --variables assets/ckpt4480_train_state.npz (before it the
        moments bit-equal to the asset's, count and step 4 480) and one from
        --tf1_checkpoint (before it the parameters equal ckpt4480's); in
        every run K1, K2 and K7-K10 launch, every loss is finite, each
        metrics.jsonl row carries hist_det_cnt (16 counts summing to num,
        hi <= 64) and, with attention, hist_normalized_attention, and
        log.txt holds the Arguments line; stage 1's median ms between
        consecutive metrics rows;
     d. device_histogram on card tensors under
        torch.cuda.set_sync_debug_mode("error"): no host sync, counts, lo,
        hi and num equal to a numpy float32 evaluation of its formula;
     e. entry(): fn(*example_args) launches K1 and K2 and gives finite
        (2, 512, 3), (2, 512, 32) and (2, 512) outputs;
     each sub-phase's wall time, with the card's name and power limit.
  21. data and point parallelism (parallel_phase), at the paper config and
     TrainConfig() widths:
     a. a one-rank nccl group on cuda:0: 3 steps of the data-parallel step
        (parallel/data_parallel.make_fused_dp_train_step, the model built
        with bn_group) on each route, fused (K7-K10 with their all-reduces
        between the launches) and autograd, from the state of 3 plain
        steps: params, BN buffers and metrics bit-equal (a sum over one
        rank is the identity); the steps' ms in turns (plain, DP, DP,
        plain) and, per DP step, the all-reduces' and the all-gather's
        count and ms (CUDA events around each);
     b. two gloo ranks both on cuda:0 (run_ranks), each with its
        role-aligned half of phase 9's batch, fused route with f32
        cotangents: K7-K10 launched on each rank; every gradient leaf
        against the one-process step on the combined batch at phase 9's
        rule (cosine >= 0.999; the analytically zero leaves |g| <= 1e-3),
        the loss within 1e-5 relative (gloo takes the CUDA tensors; it
        stages them through the host);
     c. extraction on a mesh of (cuda:0, cuda:0) with the trained weights
        on the vendored KITTI clouds, on the default, fused (K6, K3) and
        dense routes: the sharded extract launches K4 and K5 per shard (K6
        and K3 on the fused route, K2 on the dense one) and equals extract
        (keypoints index-exact, attention and features bit-equal);
        cloud_mesh extract_batch of 4 over 2 shards equals extract per
        cloud on the default and fused routes;
     the phase's wall time.
  22. the point-op API (point_api_phase): K2's per-centre form (a (B, M)
     radius, f3d_ball_query_radii) index-exact against its plain version
     on k2_cases' inputs with radii drawn per centre from 0.5-3.0 m and one
     centre each at 0, 1e-3 and 1e3 m, and bit-equal to the scalar launch
     when every radius is 2 m; then, launch counters reset, sample_points,
     sample_and_group (FPS centres, masked, not normalised, keypoints,
     keypoints with orientations, both not normalised) and ops.ball_query
     with per-centre radii on the vendored clouds (512 x 64, r 2 m): K1,
     K2 and K2's per-centre form must launch; those calls against the same
     calls on the CPU (centres, idx and cnt exact, grouped within 1e-6),
     sample_and_group_all exact; knn_points (k 16) on the training batch
     and a cloud of duplicated points, index-exact with dist2 equal to the
     CPU's; prob_sample against the CPU (random weights: at most 1e-3 of
     the draws one index over, each within 4 ulp of the row total of its
     boundary; dyadic weights index-exact); FullyConnected card against
     CPU within rtol 1e-5, atol 1e-5 (eval and training, BN statistics),
     dropout's kept share, values and seed; then per vendored cloud the
     per-centre launch, the scalar launch and the plain version in turns,
     on the device alone (graph_ms), beside the bound.
  23. the training modes (training_modes_phase), at the paper config and
     TrainConfig() widths, under build/chip_smoke_modes/ (phase 20 trains
     on the numpy reader, numpy_reader(), so that its figure stays
     comparable):
     a. the native reader (csrc/host/pointcloud_io.cpp, built with g++ at
        first use; its build seconds): TripletDataset("auto") takes it; two
        batches of phase 20's cli.prepare dataset equal per-cloud
        load_processed calls with the epoch's seeds; a batch of 6 triplets
        x 4 096 points, native against numpy, in turns; cli.train stage 1
        with phase 20's flags on it (K1, K2, K7-K10 launched, log.txt naming
        the reader) and its median ms between metrics rows beside phase
        20's numpy figure;
     b. the chained step (k = 4), fused and autograd, from one state: one
        chained call under torch.cuda.set_sync_debug_mode("error")
        bit-equal to 4 fused calls (params, BN buffers, Adam moments,
        metrics), K1, K2 and K7-K10 launched 4 times one step's count; ms per
        step of the chained call and of the loop, in turns, synchronised,
        and each one's device busy share (profiler); a one-rank nccl
        chained data-parallel step bit-equal to the chained step on both
        routes;
     c. the int16 upload: the card's dequantized batch equal to the host's
        q * scale bit for bit, a fused step from (q, scale) equal to one
        from that f32 batch; the bytes and each copy's ms;
     d. the memory modes on the autograd route in f32 and bf16 compute
        (remat_towers, residual_dtype bfloat16, the trainer's remat): peak
        GiB and step ms beside plain; remat_towers and remat bit-equal to
        plain in loss, every gradient and the BN buffers after one step;
        residual_dtype's f32 step bit-equal to the same squash points
        through plain autograd (the packing changes nothing), its loss
        within 1e-4 of the CPU's step of the same mode, and the gradients'
        card-vs-CPU cosines printed (not gated: the squash points round
        the two devices' f32 sums to bf16 with other flips, which moves
        noise-dominated leaves to cosines near 0.97);
     e. cli.train for 8 steps each, launch counters reset per run:
        --steps_per_dispatch 4 (rows and losses bit-equal to a's run), with
        and without --upload_quant int16 (bit-equal to --upload_quant int16
        alone), --remat_towers, --compute_dtype bfloat16 --residual_dtype
        bfloat16, each run's rows held to phase 20c's rules;
     the phase's wall time.
  24. the accuracy programs (recipe_phase; feat3dnet_tpu_torch/examples/),
     under build/chip_smoke_recipe/:
     a. scaled_accuracy_run.main --places 48 --stage1_epochs 1
        --stage2_epochs 4 --fused_towers --test_pairs 8 (32 + 128 steps; 8
        held-out registration pairs keep the phase within 90 s): each stage ran
        every step, stage 2's log names the restore of stage 1's last step
        and the restore replayed (CheckpointManager, restore_exclude
        detection) gives stage 1's weights and count outside `detection` and
        the seeded init inside it; K1, K2, K7-K10 launched in training, K4,
        K5 in the evaluation; every section of the JAX
        examples/results/scaled_accuracy/summary.json present and finite;
     b. the committed port-trained weights (examples/results/scaled_accuracy/
        autograd_seed0/variables.npz under the port) at kp1024_ratio0_nms02
        on the default and the fused route (K4, K5; K6, K3 on the fused),
        each held to that run's committed summary at phase 18's limits
        (precision@1m +- 1.0, putative and keypoints per cloud +- 1 %,
        registration >= 20/24);
     the phase's launches on a line of their own (not in the kernels line)
     and its wall time.
  25. the last public API (public_api_phase): with counters reset,
     fused_describe_clusters on phase 1's 7 680 clusters (seeded weights,
     f32 and bf16_act: K3) and convbn_maxpool_fused forward and backward on
     phase 9's detector inputs (bf16 and f32 cotangents: K7-K10), every
     kernel launched (a line of its own, not in the kernels line); then
     a. fused_describe_clusters bit-equal to pack_clusters_lanes_torch +
        fused_describe_clusters_t (f32, bf16_act, bf16_matmul), and per
        mode its ms a call timed in turns against fused_describe_clusters_t
        on clusters packed in advance (weights packed per call, and once);
     b. convbn_maxpool_fused's pooled rows, moments and gradients bit-equal
        to tower_prepool_fused on detector_plan, reference_convbn_maxpool
        to reference_tower;
     c. jitter, shift, rotate_z, rotate_y, rotate_small and scale on a CUDA
        generator bit-equal to their draw + apply from a generator of the
        same seed (default and other arguments), and to augment_clouds at
        the defaults;
     the phase's wall time.
  26. K11 (three_interp_phase) at PointNet++'s four FP levels of a
     segment-kitti-16k unit (8 KITTI frames sampled to 16 384 points, the
     coarser levels by K1): index-exact against its plain twin, weights
     and sums within 1e-6 relative; its ms, the twin's and the bound; then
     K2's work at every SA level and radius (k2_counts at each nsample);
     then one 8-frame unit through SegmentationPipeline.segment_many
     (step graphs captured by a call before it), with the K1, K2 and K11
     counters set to 0 just before: K1 x4, K2 x8 and K11 x4, K11's count
     the kernels line's launches.
Option: --parent DIR also builds another tree's training kernels, K1-K6
(its csrc/fused_train.cu, csrc/fps.cu, csrc/ball_query.cu,
csrc/fused_describe.cu, csrc/sorted_ball_query.cu, csrc/ball_max.cu,
csrc/fused_detect.cu and the headers it has; DIR a checkout, e.g. a parent
commit unpacked with git archive, or its csrc/; its K5 is called with
the arguments of one cloud, as before K5 took a union). It prints the parent's
ptxas lines and SASS counts for K1-K6 and whether K4's, K6's, K3's
forward modes' and K7-K10's SASS equals this tree's, instruction for
instruction; in
phase 1 it holds the parent's K1 index-exact to this one on k1_cases, in
phase 4 on every vendored cloud and the training batch,
timed in turns (k1_step); in phase 1 it holds the parent's K2 index-exact
to this one on the synthetic masked case and k2_cases, in phase 4 on
every vendored cloud, the Oxford pair and the training batch, timed in
turns (k2_step); in phase 4 it holds the parent's K3 bit-equal to this one in
f32 and bf16_act under the seeded and the trained weights, each tree on
the weights it packs itself, timed in turns with the split of each tree
that has it, and in phase 15 its stream body equal to this one's and its
matmul bodies within ABLATE_F32_LIMIT (an FFMA-era parent sums them in
f32); in phase 5 it holds the parent's K4 and K5 bit-equal to
this one on every centre of every cloud, padding centres included, and
times both in turns (the split of each), and holds the parent's K6
bit-equal to this one in each mode, each tree on the weights it packs
itself, timed in turns with the split of each tree that has it; at the end
of phase
12 it holds K7-K10 against the parent's on phase 9's inputs (parent_ab:
ptxas lines of both; K8's pooled and K9's sums equal to the parent's, K7
and K10 at phase 9's tolerances; each timed in turns; and, where the
parent has the split build, K8's split of both trees in turns).
It writes only under build/ in the checkout.
The line before last is a JSON summary of the eighteen kernel entries
(K1-K11, K2's per-centre form and K3's and K6's extra modes: times, their bounds from this run's shapes at
the H100's f32 (bf16 modes: bf16 tensor-core; K7-K10's products and K3's
and K6's per-slot convs at least 8 wide: TF32 tensor-core; K6
bf16_operands: all bf16 tensor-core) and HBM peaks,
launches on their path); the last line is
{"ok": true, "device": {...}}. Any failure
raises (non-zero exit). It needs a CUDA device and refuses to run without
one.
"""
import contextlib
import functools
import itertools
import json
import logging
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CLOUDS = ("oxford_270.bin", "oxford_456.bin", "kitti_00_001554.bin",
          "kitti_00_004534.bin")
NPOINT, RADIUS, NS = 512, 2.0, 64
NMS_RADIUS = 0.5      # InferenceConfig().nms_radius
SYN_POINTS = 200_000  # the synthetic cloud above 131 072 points
SYN_SLICE = 8192      # sorted centres of it that the plain versions check
FULL_CHECK = 32768    # buckets up to this size: plain versions on every centre
BATCH = 7680          # clusters per serving request (2 048 distinct, tiled)
REQUESTS = 8
SEED = 0
VAL_BATCH, VAL_POINTS = 512, 1024   # ClusterPairValidator's batch and cluster size
# H100 SXM peaks: f32 outside the tensor cores, bf16 dense tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps):
    """Mean ms per call of `fn` over `reps` back-to-back calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops, moved, peak=PEAK_F32_FLOPS):
    """(ms, "operations" | "bytes"): the larger of the operations over the
    card's peak for their type (f32 unless given) and the bytes moved over
    its memory rate."""
    t_ops = flops / peak * 1e3
    t_mem = moved / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def mean_bound(bounds):
    """Mean (ms, what bounds the most of that time) over per-call bounds."""
    per_kind = {}
    for ms, kind in bounds:
        per_kind[kind] = per_kind.get(kind, 0.0) + ms
    return float(np.mean([b[0] for b in bounds])), max(per_kind, key=per_kind.get)


def tower_macs(cfg, detector=True, descriptor=True):
    """Multiply-adds of one 64-slot cluster through K3's / K6's towers."""
    def chain(cin, widths):
        macs = 0
        for w in widths:
            macs, cin = macs + cin * w, w
        return macs, cin
    macs = 0
    if detector:
        slot, c = chain(3, cfg.detector_mlp)
        post, c = chain(c, cfg.detector_mlp2)
        macs += cfg.num_samples * slot + post + 3 * c
    if descriptor:
        slot, c = chain(3, cfg.descriptor_mlp)
        mid, c = chain(2 * c, cfg.descriptor_mlp2)
        post, _ = chain(c, cfg.descriptor_mlp3)
        macs += cfg.num_samples * (slot + mid) + post
    return macs


def in_turns(kernel_fn, plain_fn, reps_k, reps_p):
    """(kernel ms, plain ms), warmed up, timed plain, kernel, kernel, plain."""
    import torch

    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain_fn, reps_p)
    k1 = cuda_ms(kernel_fn, reps_k)
    k2 = cuda_ms(kernel_fn, reps_k)
    p2 = cuda_ms(plain_fn, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def ms_in_turns(runs, reps):
    """{key: ms per call} of each callable in `runs` (CUDA events, `reps`
    back-to-back calls, warmed up, in turns forward then backward)."""
    import torch

    for run in runs.values():
        run()
    torch.cuda.synchronize()
    ms = dict.fromkeys(runs, 0.0)
    for k in list(runs) + list(runs)[::-1]:
        ms[k] += cuda_ms(runs[k], reps) / 2
    return ms


def graph_ms(runs, reps):
    """{key: ms per call} of each callable in `runs` on the device alone:
    `reps` calls captured in one CUDA graph, whose replays are timed as
    ms_in_turns times a callable, so the host's launch time is not
    counted."""
    import torch

    graphs = {}
    for key, run in runs.items():
        run()
        torch.cuda.synchronize()
        graphs[key] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[key], capture_error_mode="relaxed"):
            for _ in range(reps):
                run()
    ms = ms_in_turns({key: g.replay for key, g in graphs.items()}, 3)
    return {key: t / reps for key, t in ms.items()}


def serving_time_split(k3, weights_t, packed, cfg, reps=10):
    """K3's time split, as the JAX bench's `pct_matmul_floor` reads it: ms
    per call of the f32 forward, the bf16 forward and the decomposition
    bodies, each on its weights packed once (CUDA events, `reps`
    back-to-back calls, warmed up, in turns forward then backward), plus
    elementwise_share = (f32 - matmul) / f32, product_share = (matmul -
    stream) / f32 and pct_matmul_floor = 100 matmul / f32 (bench.py's
    name). The bodies run the f32 forward's own code less the work they
    leave out (the launch, the input load, the pooled convs' TF32 tiles,
    the chains), so in one run stream <= matmul <= f32 and the shares
    split the forward; fused_describe_time_split splits it by stage."""
    from feat3dnet_tpu_torch.ops import fused_describe as fd

    calls = {"f32": {}, "bf16": {"bf16_act": True}, "matmul": {"ablate": "matmul"},
             "matmul_2d": {"ablate": "matmul_2d"}, "stream": {"ablate": "stream"}}
    packs = {k: fd._describe_kernel_weights(weights_t, cfg, packed.device, k) for k in calls}
    ms = ms_in_turns({k: (lambda k=k, kw=kw: k3(weights_t, packed, cfg, packed=packs[k], **kw))
                      for k, kw in calls.items()}, reps)
    ms["elementwise_share"] = (ms["f32"] - ms["matmul"]) / ms["f32"]
    ms["product_share"] = (ms["matmul"] - ms["stream"]) / ms["f32"]
    ms["pct_matmul_floor"] = 100.0 * ms["matmul"] / ms["f32"]
    return ms


def synthetic_cloud(seed, n=SYN_POINTS):
    """n points uniform in a 160 m x 160 m x 8 m box (about 33 per 2 m ball)."""
    rs = np.random.RandomState(seed)
    box = np.array([160.0, 160.0, 8.0])
    return (rs.rand(n, 3) * box - box / 2).astype(np.float32)


def _wrapped(d):
    import torch

    return torch.remainder(d + np.pi, 2 * np.pi) - np.pi


def padded_cloud(cloud):
    """(padded (nb, 3), valid (nb,)): a cloud at its bucket, as the
    pipeline pads it."""
    from feat3dnet_tpu_torch.config import bucket_for

    n = cloud.shape[0]
    padded = np.zeros((bucket_for(n), 3), np.float32)
    padded[:n] = cloud[:, :3]
    return padded, np.arange(padded.shape[0]) < n


LAYOUT_FIELDS = ("pts4", "blk_bbox", "orig_idx", "inv_perm")


def layout_step(card, name, dev, cloud):
    """The Morton layout of a cloud at its bucket (r RADIUS, 256-point
    blocks, as the pipeline builds it): build_sorted_cloud on the card
    bit-equal to build_sorted_cloud_host (numpy) in all four fields, with no
    host sync inside (torch's sync debug mode set to raise); times the
    device build (CUDA events, 10 back-to-back builds), the host's time to
    queue one, its device ops' busy time (profiler) and the host build
    (host clock, 3 builds). Returns (device ms, host ms)."""
    import torch

    from feat3dnet_tpu_torch.ops import hash_grid as hg

    padded, valid = padded_cloud(cloud)
    x, v = torch.from_numpy(padded).to(dev), torch.from_numpy(valid).to(dev)

    def build():
        return hg.build_sorted_cloud(x, v, cell_size=RADIUS, block_size=256)
    sc = build()
    host = hg.build_sorted_cloud_host(padded, valid, cell_size=RADIUS, block_size=256)
    for f in LAYOUT_FIELDS:
        a, b = getattr(sc, f).cpu().numpy(), getattr(host, f)
        require(a.dtype == b.dtype and np.array_equal(a, b),
                f"device layout != host layout in {f} on {name}")
    # no host sync inside the build: torch raises on any synchronising call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        build()
        queue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dev_ms = cuda_ms(build, 10)
    # the device's own share: its kernels' time in one profiled build
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        build()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    launched = sum(e.count for e in ev)
    t0 = time.perf_counter()
    for _ in range(3):
        hg.build_sorted_cloud_host(padded, valid, cell_size=RADIUS, block_size=256)
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"[{card}] layout {name} N={cloud.shape[0]} bucket {padded.shape[0]}: device build "
          f"{dev_ms:.4f} ms (CUDA events, back to back; the host queues one in {queue_ms:.4f} "
          f"ms, no sync; its {launched} device ops busy {busy_ms:.4f} ms), host numpy build "
          f"{host_ms:.2f} ms; bit-equal in {', '.join(LAYOUT_FIELDS)}")
    return dev_ms, host_ms


@contextlib.contextmanager
def layout_builder(make):
    """The pipeline's Morton layout builder replaced by make(device_build)
    for as long as the context lasts."""
    from feat3dnet_tpu_torch.inference import pipeline

    device_build = pipeline.build_sorted_cloud_batch
    pipeline.build_sorted_cloud_batch = make(device_build)
    try:
        yield
    finally:
        pipeline.build_sorted_cloud_batch = device_build


def host_layout():
    """The pipeline's Morton layout built on the host in numpy (the route
    before the device builder)."""
    from feat3dnet_tpu_torch.ops import hash_grid as hg

    def host_layouts(xyz, valid, **kw):
        scs = [hg.build_sorted_cloud_host(x, v, **kw) for x, v in zip(xyz.cpu().numpy(),
                                                                      valid.cpu().numpy())]
        return hg.SortedCloud(np.concatenate([s.pts4 for s in scs]),
                              np.concatenate([s.blk_bbox for s in scs]),
                              np.stack([s.orig_idx for s in scs]),
                              np.stack([s.inv_perm for s in scs]),
                              kw["block_size"]).to(xyz.device)

    return layout_builder(lambda device_build: host_layouts)


def layout_queue_clock(out):
    """The device builder, appending to `out` the host ms each layout takes
    to queue (the interval of the span `f3d.extract.layout`; nothing
    waited on)."""
    def timed(device_build):
        def build(*args, **kw):
            t0 = time.perf_counter()
            sc = device_build(*args, **kw)
            out.append((time.perf_counter() - t0) * 1e3)
            return sc
        return build

    return layout_builder(timed)


def sorted_clusters(dev, cloud):
    """A cloud at its bucket, Morton-sorted on the card, and the (M, ns, 3)
    origin-centred K4 clusters of every sorted centre (the attention pass's
    input). Returns (sorted cloud, centres, K4 top, K4 count, clusters, the
    slice of centres the plain versions check: every centre, or SYN_SLICE
    contiguous sorted centres of a cloud past FULL_CHECK)."""
    import torch

    from feat3dnet_tpu_torch.ops import hash_grid as hg

    padded, valid = padded_cloud(cloud)
    nb = padded.shape[0]
    sc = hg.build_sorted_cloud(torch.from_numpy(padded).to(dev),
                               torch.from_numpy(valid).to(dev), cell_size=RADIUS,
                               block_size=256)
    ctr = sc.pts4[:, :3]
    top, cnt = hg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, RADIUS, NS, tile=256)
    grouped, _, _ = hg._finish_grouped(top, cnt, ctr, NS)
    sl = slice(0, nb) if nb <= FULL_CHECK else slice(nb // 4, nb // 4 + SYN_SLICE)
    return sc, ctr, top, cnt, (grouped - ctr[:, None, :]).contiguous(), sl


def k4_launcher(lib):
    """K4 of the ctypes library `lib` as f(pts4, blk_bbox, hit, block,
    centers, tile, r2, ns, top, cnt), launched on the current stream. A
    library without f3d_sorted_ball_query_occupancy has the entry point of
    K4's first design, which takes no box table."""
    import ctypes

    import torch

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.f3d_sorted_ball_query
    boxes = hasattr(lib, "f3d_sorted_ball_query_occupancy")
    fn.argtypes = ([P, P] if boxes else [P]) + [I, P, I, I, P, I, I, F, I, P, P, P]
    fn.restype = I

    def launch(pts4, blk_bbox, hit, block, centers, tile, r2, ns, top, cnt):
        def ptr(t):
            return ctypes.c_void_p(t.data_ptr())
        head = [ptr(pts4), ptr(blk_bbox)] if boxes else [ptr(pts4)]
        err = fn(*head, pts4.shape[0], ptr(hit), hit.shape[1], block, ptr(centers),
                 centers.shape[0], tile, r2, ns, ptr(top), ptr(cnt),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        require(err == 0, f"K4 launch returned CUDA error {err}")
    return launch


def k4_counts(sc, ctr, tile=256, chunk=4096):
    """What K4's walk must do on this layout, counted in torch: hit blocks
    per tile of the hit mask (mean, max); distance tests per real centre
    under the tile's cull (every point of every hit block) and under the
    per-centre cull (the hit blocks whose box comes within r of the centre
    itself, the same gap expression); of those blocks, the ones that lie
    wholly inside the ball (no test needed); and the share of the tile
    cull's tests that serve tiles of padding centres only."""
    import torch

    from feat3dnet_tpu_torch.ops import hash_grid as hg

    r2 = hg._r2(RADIUS)
    L = sc.pts4.shape[0] // sc.blk_bbox.shape[0]
    hit = hg._padded_hitmask(ctr, sc.blk_bbox, r2, tile).bool()
    per_tile = hit.sum(1)
    m = ctr.shape[0]
    tile_of = torch.arange(m, device=ctr.device) // tile
    real = ctr[:, 0] < 5e8
    tests_tile = per_tile[tile_of].double() * L
    bmin, bmax = sc.blk_bbox[:, :3], sc.blk_bbox[:, 3:6]
    culled = torch.empty(m, dtype=torch.float64, device=ctr.device)
    covered = torch.empty_like(culled)
    for c0 in range(0, m, chunk):
        c = ctr[c0:c0 + chunk, None, :]
        g = torch.clamp(torch.maximum(bmin - c, c - bmax), min=0.0)
        g = g * g
        near = ((g[..., 0] + g[..., 1]) + g[..., 2] < r2) & hit[tile_of[c0:c0 + chunk]]
        f = torch.maximum((c - bmin).abs(), (c - bmax).abs())
        f = f * f
        inside = near & ((f[..., 0] + f[..., 1]) + f[..., 2] < r2)
        culled[c0:c0 + chunk] = near.sum(1).double()
        covered[c0:c0 + chunk] = inside.sum(1).double()
    pad = -m % tile
    real_tiles = torch.cat([real, real.new_zeros(pad)]).view(-1, tile).any(1)
    return {"hit blocks per tile mean": per_tile.double().mean().item(),
            "hit blocks per tile max": per_tile.max().item(),
            "tests per real centre, tile cull": tests_tile[real].mean().item(),
            "tests per real centre, per-centre cull": (culled[real] * L).mean().item(),
            "blocks per real centre, per-centre cull": culled[real].mean().item(),
            "max": culled[real].max().item(),
            "of them wholly inside the ball": covered[real].mean().item(),
            "share of tile-cull tests on padding-only tiles":
                (tests_tile[~real_tiles[tile_of]].sum() / tests_tile.sum()).item()}


@functools.lru_cache(maxsize=None)
def other_fused_describe(csrc):
    """Another tree's ops/fused_describe.py (beside its csrc/), loaded under
    a name of its own, for its own K6 weight packing."""
    import importlib.util
    import re

    path = os.path.join(os.path.dirname(os.path.abspath(csrc)), "ops", "fused_describe.py")
    spec = importlib.util.spec_from_file_location(re.sub(r"\W", "_", path), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def detect_pack(csrc, w, cfg, device, unfolded, bf16):
    """K6's weights as a tree (None: this one; else its csrc/) packs them
    for its own K6, as the arguments of this tree's launch: a tree whose K6
    takes no offsets of tensor-core fragments (K6's FFMA design) gets an
    empty offset table, which other_library drops."""
    import torch

    from feat3dnet_tpu_torch.ops import fused_describe as fd

    mod = other_fused_describe(csrc) if csrc else fd
    packed = tuple(mod._detect_kernel_weights(w, cfg, device, unfolded, bf16=bf16))
    return packed if len(packed) == 3 else (*packed, torch.zeros((0, 2), dtype=torch.int32))


def fused_detect_time_split(w, offs, cfg, kw, trees, reps):
    """K6's time split on clusters `offs` in one mode (kw: the wrapper's
    unfolded / bf16_operands), ms per call (CUDA events, `reps`
    back-to-back calls, in turns): this tree's weight packing alone
    (`_detect_kernel_weights`); per tree (`trees` maps a tag to None for
    this one or to another tree's csrc/) the kernel alone on the weights
    that tree packs, the kernel leaving each cluster after each stage where
    the tree has the split entry (kernels.detect_stops: input and
    membership, each per-slot conv, the pool's candidates marked, the pool;
    the rest is the post convs and heads), and the whole wrapper on those
    packed weights, as the pipeline calls it."""
    import torch

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import fused_describe as fd

    unf, bf16 = kw.get("unfolded", False), kw.get("bf16_operands", False)
    out = torch.empty((offs.shape[0], 3), device=offs.device)
    runs = {"pack": lambda: fd._detect_kernel_weights(w, cfg, offs.device, unf, bf16=bf16)}
    for tag, csrc in trees.items():
        def within(fn, csrc=csrc):
            with kernels_from(csrc) if csrc else contextlib.nullcontext():
                fn()
        packed = detect_pack(csrc, w, cfg, offs.device, unf, bf16)
        stops = kernels.detect_stops(len(cfg.detector_mlp))
        lib = other_library(csrc) if csrc else kernels.library()
        for stop in ((*stops, None) if hasattr(lib, "f3d_fused_detect_split") else (None,)):
            runs[f"{tag} {stop or 'kernel'}"] = functools.partial(
                within, functools.partial(fd._launch_detect, offs, packed, cfg, unf, bf16, out,
                                          stop=stop))
        runs[f"{tag} whole"] = functools.partial(
            within, functools.partial(fd.fused_detect_clusters, w, offs, cfg, packed=packed, **kw))
    return ms_in_turns(runs, reps)


def detect_occupancy_line(tag, w, cfg, kw, ns, csrc=None):
    """K6's launch in a tree (None: this one) that has the occupancy entry:
    dynamic shared memory and blocks per SM."""
    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import fused_describe as fd

    lib = other_library(csrc) if csrc else kernels.library()
    if not hasattr(lib, "f3d_fused_detect_occupancy"):
        return
    unf, bf16 = kw.get("unfolded", False), kw.get("bf16_operands", False)
    with kernels_from(csrc) if csrc else contextlib.nullcontext():
        layers = detect_pack(csrc, w, cfg, "cpu", unf, bf16)[1]
        smem, blocks = kernels.detect_occupancy(ns, layers, len(cfg.detector_mlp),
                                                len(cfg.detector_mlp2), bf16)
    print(f"  occupancy ({tag}): fused_detect {fd._detect_mode(unf, bf16)}: {smem} B, "
          f"{blocks} blocks/SM")


def describe_pack(csrc, w, cfg, device, mode):
    """K3's weights as a tree (None: this one; else its csrc/) packs them
    for its own K3 in `mode`, as the arguments of this tree's launch: a
    tree whose K3 takes no offsets of tensor-core fragments (K3's FFMA
    design) gets None for them, which other_library drops."""
    from feat3dnet_tpu_torch.ops import fused_describe as fd

    mod = other_fused_describe(csrc) if csrc else fd
    if hasattr(mod, "_describe_kernel_weights"):
        packed = tuple(mod._describe_kernel_weights(w, cfg, device, mode))
    else:
        packed = tuple(mod._kernel_weights(w, cfg, device, bf16=mode == "bf16"))
    return packed if len(packed) == 3 else (*packed, None)


# K3's forward modes as the wrapper takes them
K3_MODES = {"f32": {}, "bf16": {"bf16_act": True}}


def fused_describe_time_split(w, x, cfg, mode, trees, reps):
    """K3's time split on packed clusters `x` in one forward mode, ms per
    call (CUDA events, `reps` back-to-back calls, in turns): this tree's
    weight packing alone (`_describe_kernel_weights`); per tree (`trees`
    maps a tag to None for this one or to another tree's csrc/) the kernel
    alone on the weights that tree packs, the kernel leaving each cluster
    after each stage where the tree has the split entry
    (kernels.describe_stops: input and membership, each detector conv below
    the top one, the top conv and its pool, the post convs and heads, the
    rotation, the descriptor convs, the mid conv and its pool; the rest is
    the post conv and the L2 norm), and the whole wrapper on those packed
    weights, as the server calls it."""
    import torch

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import fused_describe as fd

    b = x.shape[1]
    desc = torch.empty((b, cfg.feature_dim), device=x.device)
    att = torch.empty((b,), device=x.device)
    runs = {"pack": lambda: fd._describe_kernel_weights(w, cfg, x.device, mode)}
    for tag, csrc in trees.items():
        def within(fn, csrc=csrc):
            with kernels_from(csrc) if csrc else contextlib.nullcontext():
                fn()
        packed = describe_pack(csrc, w, cfg, x.device, mode)
        lib = other_library(csrc) if csrc else kernels.library()
        stops = [k for k in kernels.describe_stops(len(cfg.detector_mlp))
                 if "candidates" not in k]
        for stop in ((*stops, None) if hasattr(lib, "f3d_fused_describe_split") else (None,)):
            runs[f"{tag} {stop or 'kernel'}"] = functools.partial(
                within, functools.partial(fd._launch_describe, x, packed, cfg, mode, desc, att,
                                          stop=stop))
        runs[f"{tag} whole"] = functools.partial(
            within, functools.partial(fd.fused_describe_clusters_t, w, x, cfg, packed=packed,
                                      **K3_MODES[mode]))
    return ms_in_turns(runs, reps)


def describe_occupancy_line(tag, w, cfg, mode, csrc=None):
    """K3's launch in a tree (None: this one) that has the occupancy entry:
    dynamic shared memory and blocks per SM."""
    from feat3dnet_tpu_torch import kernels

    lib = other_library(csrc) if csrc else kernels.library()
    if not hasattr(lib, "f3d_fused_describe_occupancy"):
        return
    with kernels_from(csrc) if csrc else contextlib.nullcontext():
        layers = describe_pack(csrc, w, cfg, "cpu", mode)[1]
        smem, blocks = kernels.describe_occupancy(cfg.num_samples, layers,
                                                  len(cfg.detector_mlp),
                                                  len(cfg.detector_mlp2),
                                                  len(cfg.descriptor_mlp), mode)
    print(f"  occupancy ({tag}): fused_describe {mode}: {smem} B, {blocks} blocks/SM")


def k3_step(card, label, w, x, cfg, parent):
    """K3 per forward mode on packed clusters `x` and weights `w` (`label`
    names them): each tree's occupancy line, the time split of each tree in
    turns (fused_describe_time_split), the pool candidates this tree's
    kernel re-sums per pooled conv where it has the candidate stages, and,
    with a parent tree (its csrc/), the parent's descriptors and attention
    held bit-equal to this tree's, each on the weights it packs itself.
    Returns {mode: (parent kernel ms, this kernel ms)} (parent None without
    one)."""
    import torch

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import fused_describe as fd

    trees = {"this": None} if parent is None else {"parent": parent, "this": None}
    b = x.shape[1]
    times = {}
    for mode, kw in K3_MODES.items():
        for tag, csrc in trees.items():
            describe_occupancy_line(tag, w, cfg, mode, csrc)
        sp = fused_describe_time_split(w, x, cfg, mode, trees, reps=5)
        print_split(card, f"fused_describe {mode} {label} B={b}", sp)
        times[mode] = (sp.get("parent kernel"), sp["this kernel"])
        packed = fd._describe_kernel_weights(w, cfg, x.device, mode)
        stops = kernels.describe_stops(len(cfg.detector_mlp))
        if "top_candidates" in stops:
            # the pools' work: their candidates, counted per block by the
            # candidate stages; a block holds TOWER_CLUSTERS_PER_BLOCK clusters
            desc = torch.empty((b, cfg.feature_dim), device=x.device)
            att = torch.empty((b,), device=x.device)
            nblk = -(-b // TOWER_CLUSTERS_PER_BLOCK)
            line = []
            for conv, width in (("top", cfg.detector_mlp[-1]), ("mid", cfg.descriptor_mlp2[-1])):
                fd._launch_describe(x, packed, cfg, mode, desc, att, stop=f"{conv}_candidates")
                per = desc.view(-1)[:nblk] / (TOWER_CLUSTERS_PER_BLOCK * width)
                line.append(f"{conv} conv {per.mean().item():.4f} (a block's max "
                            f"{per.max().item():.4f})")
            print(f"  fused_describe {mode} {label}: pool candidates per cluster and channel: "
                  + ", ".join(line))
        if parent is None:
            continue
        d, a = fd.fused_describe_clusters_t(w, x, cfg, packed=packed, **kw)
        with kernels_from(parent):
            d_p, a_p = fd.fused_describe_clusters_t(
                w, x, cfg, packed=describe_pack(parent, w, cfg, x.device, mode), **kw)
        require(torch.equal(d, d_p) and torch.equal(a, a_p),
                f"K3 {mode} {label}: not bit-equal to the parent (desc max|d| "
                f"{(d - d_p).abs().max().item():.3e}, att {(a - a_p).abs().max().item():.3e})")
        print(f"[{card}] fused_describe {mode} {label} B={b}: parent {sp['parent kernel']:.4f} "
              f"ms, this {sp['this kernel']:.4f} ms (kernels alone, in turns); wrapper on "
              f"packed weights parent {sp['parent whole']:.4f}, this {sp['this whole']:.4f} ms; "
              "descriptors and attention bit-equal to the parent")
    return times


def sorted_ball_query_time_split(sc, ctr, launchers, reps):
    """K4's time split at tile 256: ms per call (CUDA events, `reps`
    back-to-back calls, in turns) of the hit mask alone (`_padded_hitmask`),
    of each library's kernel alone on that precomputed mask, and of each
    library's whole call (the mask, the outputs, the kernel). `launchers`
    maps a tag to a `k4_launcher`; this tree's whole call is the wrapper
    itself. Returns (ms by key, {tag: (top, cnt)} from the kernel-alone
    runs)."""
    import torch

    from feat3dnet_tpu_torch.ops import hash_grid as hg

    r2 = hg._r2(RADIUS)
    L = sc.pts4.shape[0] // sc.blk_bbox.shape[0]
    m = ctr.shape[0]
    ctr = ctr.contiguous()
    hit = hg._padded_hitmask(ctr, sc.blk_bbox, r2, 256)
    outs = {tag: (torch.empty((m, NS, 4), device=ctr.device),
                  torch.empty((m,), dtype=torch.int32, device=ctr.device))
            for tag in launchers}

    def whole(launch):
        top = torch.empty((m, NS, 4), device=ctr.device)
        cnt = torch.empty((m,), dtype=torch.int32, device=ctr.device)
        launch(sc.pts4, sc.blk_bbox, hg._padded_hitmask(ctr, sc.blk_bbox, r2, 256), L, ctr,
               256, r2, NS, top, cnt)

    runs = {"mask": lambda: hg._padded_hitmask(ctr, sc.blk_bbox, r2, 256)}
    for tag, launch in launchers.items():
        runs[f"{tag} kernel"] = functools.partial(launch, sc.pts4, sc.blk_bbox, hit, L, ctr,
                                                  256, r2, NS, *outs[tag])
        runs[f"{tag} whole"] = (
            functools.partial(hg.sorted_ball_query, sc.pts4, sc.blk_bbox, ctr, RADIUS, NS,
                              tile=256)
            if tag == "this" else functools.partial(whole, launch))
    return ms_in_turns(runs, reps), outs


def k4_step(card, name, nb, sc, ctr, cnt_k, top_k, parent_lib):
    """Step 0 of K4's redesign and, with a parent library, K4 against it:
    the counts (`k4_counts`), the time split of this tree's K4 (and the
    parent's, in turns), the parent's top and cnt bit-equal to this tree's
    on every centre, padding centres included, and the bound of this
    cloud's work."""
    import ctypes

    import torch

    from feat3dnet_tpu_torch import kernels

    counts = k4_counts(sc, ctr)
    print(f"K4 counts {name} bucket {nb} (tile 256): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in counts.items()))
    libs = {"this": kernels.library()}
    if parent_lib is not None:
        libs = {"parent": parent_lib, **libs}
    n_blocks = sc.blk_bbox.shape[0]
    for tag, lib in libs.items():
        if hasattr(lib, "f3d_sorted_ball_query_occupancy"):
            out = torch.zeros(2, dtype=torch.int32)
            lib.f3d_sorted_ball_query_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
            require(lib.f3d_sorted_ball_query_occupancy(
                n_blocks, ctypes.c_void_p(out.data_ptr())) == 0, "K4 occupancy query")
            print(f"  occupancy ({tag}): sorted_ball_query {name} ({n_blocks} blocks): "
                  f"{int(out[0])} B, {int(out[1])} blocks/SM")
    launchers = {tag: k4_launcher(lib) for tag, lib in libs.items()}
    sp, outs = sorted_ball_query_time_split(sc, ctr, launchers,
                                            reps=5 if nb <= FULL_CHECK else 3)
    real = ctr[:, 0] < 5e8
    b = bound_ms(8.0 * cnt_k[real].sum().item(), nbytes(sc.pts4, ctr, top_k, cnt_k))
    print_split(card, f"sorted_ball_query {name} bucket {nb} (bound {b[0]:.4f} ms, {b[1]})",
                sp)
    for tag, (top, cnt) in outs.items():
        require(bool((cnt == cnt_k).all()) and bool((top == top_k).all()),
                f"K4 of {tag} (kernel alone) != this tree's wrapper on {name}")
    if parent_lib is not None:
        print(f"[{card}] sorted_ball_query {name} bucket {nb}: parent {sp['parent kernel']:.4f} "
              f"ms, this {sp['this kernel']:.4f} ms (kernels alone, in turns); top and cnt "
              f"bit-equal to the parent on all {ctr.shape[0]} centres")


def k5_counts(sc, ctr, values, ballmax, tile=512, chunk=2048):
    """What K5 must do on this layout at the pipeline's tile (512), counted
    in torch: hit blocks per tile of the hit mask (mean, max); distance
    tests per real centre under the tile's cull (every point of every hit
    block) and under a per-centre cull (the hit blocks whose box comes
    within r of the centre itself, K4's gap expression); of those blocks,
    the ones wholly inside the 0.5 m ball (their block maximum serves, no
    test); the ones a per-centre value skip drops (block maximum <= the
    running maximum) once the centre's own block and its covered blocks
    are taken, and at best (block maximum <= the centre's ball maximum,
    `ballmax`); the tests left after that skip; and the share of the tile
    cull's tests that go to padding centres (x >= 5e8, and a partial last
    tile's empty slots, which today's kernel runs too)."""
    import torch

    from feat3dnet_tpu_torch.ops import hash_grid as hg

    r2 = hg._r2(NMS_RADIUS)
    nb = sc.blk_bbox.shape[0]
    L = sc.pts4.shape[0] // nb
    m = ctr.shape[0]
    dev = ctr.device
    hit = hg._padded_hitmask(ctr, sc.blk_bbox, r2, tile).bool()
    per_tile = hit.sum(1).double()
    tile_of = torch.arange(m, device=dev) // tile
    real = ctr[:, 0] < 5e8
    blkmax = values.view(nb, L).amax(1)
    bmin, bmax = sc.blk_bbox[:, :3], sc.blk_bbox[:, 3:6]
    init = hg._init_ballmax(ctr)
    stats = {k: torch.empty(m, dtype=torch.float64, device=dev)
             for k in ("near", "covered", "drop", "drop_best", "left")}
    for c0 in range(0, m, chunk):
        c = ctr[c0:c0 + chunk, None, :]
        n_c = c.shape[0]
        g = torch.clamp(torch.maximum(bmin - c, c - bmax), min=0.0)
        g = g * g
        near = ((g[..., 0] + g[..., 1]) + g[..., 2] < r2) & hit[tile_of[c0:c0 + chunk]]
        f = torch.maximum((c - bmin).abs(), (c - bmax).abs())
        f = f * f
        inside = near & ((f[..., 0] + f[..., 1]) + f[..., 2] < r2)
        # the centre's own block (the sorted rows are the centres), scanned first
        rows = torch.arange(c0, c0 + n_c, device=dev)
        own = (rows // L)[:, None] == torch.arange(nb, device=dev)[None, :]
        pts = sc.pts4[:, :3].view(nb, L, 3)[rows // L]                    # (n_c, L, 3)
        d = c - pts
        d = d * d
        in_own = (d[..., 0] + d[..., 1]) + d[..., 2] < r2
        own_max = torch.where(in_own, values.view(nb, L)[rows // L],
                              torch.full_like(pts[..., 0], -1e30)).amax(1)
        cov_max = torch.where(inside, blkmax[None, :], torch.full_like(g[..., 0], -1e30)).amax(1)
        best0 = torch.maximum(torch.maximum(init[c0:c0 + chunk], own_max), cov_max)
        rest = near & ~inside & ~own
        drop = rest & (blkmax[None, :] <= best0[:, None])
        drop_best = rest & (blkmax[None, :] <= ballmax[c0:c0 + chunk, None])
        stats["near"][c0:c0 + n_c] = near.sum(1).double()
        stats["covered"][c0:c0 + n_c] = inside.sum(1).double()
        stats["drop"][c0:c0 + n_c] = drop.sum(1).double()
        stats["drop_best"][c0:c0 + n_c] = drop_best.sum(1).double()
        stats["left"][c0:c0 + n_c] = ((rest & ~drop).sum(1)
                                      + (own & near & ~inside).sum(1)).double() * L
    tests_tile = per_tile[tile_of] * L
    pad = -m % tile
    pad_tests = (tests_tile[~real].sum() + pad * per_tile[-1] * L).item()
    all_tests = (tests_tile.sum() + pad * per_tile[-1] * L).item()
    return {"hit blocks per tile mean": per_tile.mean().item(),
            "hit blocks per tile max": int(per_tile.max().item()),
            "tests per real centre, tile cull": tests_tile[real].mean().item(),
            "tests per real centre, per-centre cull": (stats["near"][real] * L).mean().item(),
            "blocks per real centre, per-centre cull": stats["near"][real].mean().item(),
            "of them wholly inside the ball": stats["covered"][real].mean().item(),
            "dropped by the value skip after own and covered blocks":
                stats["drop"][real].mean().item(),
            "dropped at best": stats["drop_best"][real].mean().item(),
            "tests per real centre after the skip": stats["left"][real].mean().item(),
            "share of tile-cull tests on padding centres": pad_tests / max(all_tests, 1.0)}


def k5_runs(lib, tag, sc, values, tile, r2):
    """The calls of one library's K5 at the pipeline's call (every sorted row
    a centre) for ball_max_time_split, and the output the kernel-alone run
    writes. A library without f3d_ball_max_occupancy has K5's first design,
    which takes the torch hit mask: its 'kernel' runs on a mask made once,
    its 'whole' makes the mask and the output, as its wrapper did. Else the
    kernel makes its own hit rows: 'prep' is its pre-pass, 'walk' the walk
    on that pre-pass's output and 'kernel' both, on scratch made once; this
    tree's 'whole' is the wrapper itself."""
    import ctypes

    import torch

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import hash_grid as hg

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.f3d_ball_max
    pts4, bbox, values = sc.pts4, sc.blk_bbox, values.contiguous()
    np_, nb = pts4.shape[0], bbox.shape[0]
    L = np_ // nb
    out = torch.empty((np_,), dtype=torch.float32, device=pts4.device)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call(*args):
        require(fn(*args) == 0, f"K5 ({tag}) launch returned a CUDA error")

    ctr = pts4[:, :3].contiguous()
    runs = {}
    if not hasattr(lib, "f3d_ball_max_occupancy"):
        fn.argtypes = [P, P, I, P, I, I, P, I, I, F, P, P]
        fn.restype = I
        hit = hg._padded_hitmask(ctr, bbox, r2, tile)

        def old(h, o):
            call(ptr(pts4), ptr(values), np_, ptr(h), nb, L, ptr(ctr), np_, tile, r2, ptr(o),
                 stream())
        runs[f"{tag} kernel"] = functools.partial(old, hit, out)
        runs[f"{tag} whole"] = lambda: old(hg._padded_hitmask(ctr, bbox, r2, tile),
                                           torch.empty_like(out))
    else:
        # seg_centres, seg_blocks: 0, 0 is one cloud
        fn.argtypes = [P, P, I, P, I, P, I, I, F, P, P, P, I, I, I, P]
        fn.restype = I
        tiles = -(-np_ // tile)
        hit = torch.empty((tiles, nb), dtype=torch.uint8, device=pts4.device)
        blkmax = torch.empty((nb,), dtype=torch.float32, device=pts4.device)

        def new(stage, h, bm, o):
            call(ptr(pts4), ptr(values), np_, ptr(bbox), nb, None, np_, tile, r2, ptr(h),
                 ptr(bm), ptr(o), 0, 0, stage, stream())
        for stage in ("prep", "walk"):
            runs[f"{tag} {stage}"] = functools.partial(new, kernels.BALL_MAX_STAGES[stage], hit,
                                                       blkmax, out)
        runs[f"{tag} kernel"] = functools.partial(new, 0, hit, blkmax, out)
        runs[f"{tag} whole"] = lambda: new(0, torch.empty_like(hit), torch.empty_like(blkmax),
                                           torch.empty_like(out))
    if tag == "this":
        runs[f"{tag} whole"] = functools.partial(hg.ball_max_sorted, pts4, bbox, values,
                                                 NMS_RADIUS, tile)
    return runs, out


def ball_max_time_split(sc, values, libs, reps, tile=512):
    """K5's time split at the pipeline's call (tile 512, every sorted row a
    centre): ms per call (CUDA events, `reps` back-to-back calls, in turns)
    of the torch hit mask alone (`_padded_hitmask`), and per library of
    k5_runs' calls (the kernel alone, its pre-pass and walk where it has
    them, the whole call). Returns (ms by key, {tag: the kernel-alone
    output})."""
    from feat3dnet_tpu_torch.ops import hash_grid as hg

    r2 = hg._r2(NMS_RADIUS)
    ctr = sc.pts4[:, :3].contiguous()
    runs = {"mask": lambda: hg._padded_hitmask(ctr, sc.blk_bbox, r2, tile)}
    outs = {}
    for tag, lib in libs.items():
        more, outs[tag] = k5_runs(lib, tag, sc, values, tile, r2)
        runs.update(more)
    return ms_in_turns(runs, reps), outs


def k5_step(card, name, nb, sc, ctr, values, bm_k, parent_lib):
    """Step 0 of K5's redesign and, with a parent library, K5 against it:
    the counts (`k5_counts`), this tree's occupancy where it has the entry
    point, the time split of each tree in turns (ball_max_time_split), each
    tree's kernel-alone output bit-equal to this tree's wrapper on every
    centre, padding centres included."""
    import ctypes

    import torch

    from feat3dnet_tpu_torch import kernels

    counts = k5_counts(sc, ctr, values, bm_k)
    print(f"K5 counts {name} bucket {nb} (tile 512, r {NMS_RADIUS}): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in counts.items()))
    libs = {"this": kernels.library()}
    if parent_lib is not None:
        libs = {"parent": parent_lib, **libs}
    n_blocks = sc.blk_bbox.shape[0]
    for tag, lib in libs.items():
        if hasattr(lib, "f3d_ball_max_occupancy"):
            out = torch.zeros(2, dtype=torch.int32)
            lib.f3d_ball_max_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
            require(lib.f3d_ball_max_occupancy(n_blocks, ctypes.c_void_p(out.data_ptr())) == 0,
                    "K5 occupancy query")
            print(f"  occupancy ({tag}): ball_max {name} ({n_blocks} blocks): "
                  f"{int(out[0])} B, {int(out[1])} blocks/SM")
    sp, outs = ball_max_time_split(sc, values, libs, reps=5 if nb <= FULL_CHECK else 3)
    print_split(card, f"ball_max {name} bucket {nb}", sp)
    for tag, out in outs.items():
        require(torch.equal(out, bm_k), f"K5 of {tag} (kernel alone) != this tree's wrapper "
                                        f"on {name}")
    if parent_lib is not None:
        print(f"[{card}] ball_max {name} bucket {nb}: parent {sp['parent kernel']:.4f} ms, this "
              f"{sp['this kernel']:.4f} ms (kernels alone, in turns); wrapper parent "
              f"{sp['parent whole']:.4f}, this {sp['this whole']:.4f} ms; bit-equal to the "
              f"parent on all {ctr.shape[0]} centres")
    return sp


def fps_launcher(lib):
    """K1 of the ctypes library `lib` as f(xyz, npoint, mask=None,
    cluster=None) -> (B, npoint) int32, on the current stream. A library
    without f3d_fps_occupancy has K1's first design (one block a cloud, no
    cluster size); this tree's takes the cluster size, by default the
    wrapper's choice (ops.fps.fps_cluster_size)."""
    import ctypes

    import torch

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.f3d_fps
    clustered = hasattr(lib, "f3d_fps_occupancy")
    fn.argtypes = [P, P, P, I, I, I] + ([I] if clustered else []) + [P, P]
    fn.restype = I
    lib.f3d_fps_max_smem_points.argtypes = [I] if clustered else []
    lib.f3d_fps_max_smem_points.restype = I

    def launch(xyz, npoint, mask=None, cluster=None):
        from feat3dnet_tpu_torch.ops import fps

        b, n, _ = xyz.shape
        if clustered:
            c = fps.fps_cluster_size(n) if cluster is None else cluster
            cap = lib.f3d_fps_max_smem_points(c)
        else:
            cap = lib.f3d_fps_max_smem_points()
        scratch = torch.empty((b, n), device=xyz.device) if n > cap else None
        out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)

        def ptr(t):
            return ctypes.c_void_p(None if t is None else t.data_ptr())
        args = [ptr(xyz), ptr(mask), ptr(scratch), b, n, npoint] + ([c] if clustered else [])
        err = fn(*args, ptr(out), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        require(err == 0, f"K1 launch returned CUDA error {err}")
        return out
    launch.clustered = clustered
    return launch


# K1's step split: the kernel at these npoint, so (t[512] - t[64]) / 448 is
# the time of one of the sequential steps and t[2] - that step the set-up
FPS_SPLIT_NPOINTS = (2, 64, 512)
FPS_CLUSTERS = (1, 2, 4, 8, 16)


def k1_cases(dev, parent_lib):
    """K1 index-exact against its plain version (and, with a parent library,
    the parent's K1) at the training shape (18 x 4 096, npoint 512), on a
    masked batch, duplicated points, an all-masked cloud and 70 000 points
    (past the shared-memory path of one block)."""
    import torch

    from feat3dnet_tpu_torch.ops import fps

    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    pts = torch.randn(3, 3000, 3, generator=g)
    mask = torch.rand(3, 3000, generator=g) > 0.5
    mask[2] = False                                              # all masked
    cases = {"training batch": (training_batch(dev, SEED), None, NPOINT),
             "masked (3, 3000)": (pts.to(dev), mask.to(dev), 100),
             "duplicated points": (torch.cat([pts[:1, :500]] * 3, 1).contiguous().to(dev),
                                   None, 64),
             "70 000 points": (torch.randn(1, 70000, 3, generator=g).to(dev), None, 32)}
    parent = None if parent_lib is None else fps_launcher(parent_lib)
    for name, (xyz, m, k) in cases.items():
        got = fps.farthest_point_sample(xyz, k, m)
        require(torch.equal(got, fps.farthest_point_sample_scan(xyz, k, m)),
                f"fps kernel != plain on {name}")
        if parent is not None:
            require(torch.equal(parent(xyz, k, m), got), f"K1: parent != this on {name}")
        print(f"K1 fps {name} {tuple(xyz.shape)} npoint {k} (cluster "
              f"{fps.fps_cluster_size(xyz.shape[1])}): index-exact vs plain"
              + ("" if parent is None else " and the parent"))


def fps_step_split(xyz, launchers, reps):
    """K1's time per call (CUDA events, `reps` back-to-back calls, in turns)
    at each of FPS_SPLIT_NPOINTS, per library in `launchers` ({tag:
    fps_launcher}) and, for a clustered library, at each cluster size of
    FPS_CLUSTERS too ('this c4'), and this tree's wrapper at NPOINT; then
    per run its time per step and its set-up. Returns {run: {npoint: ms,
    'step': ms, 'setup': ms}}."""
    from feat3dnet_tpu_torch.ops import fps

    runs = {}
    for tag, launch in launchers.items():
        variants = {tag: None}
        if launch.clustered:
            variants.update({f"{tag} c{c}": c for c in FPS_CLUSTERS})
        for label, c in variants.items():
            for k in FPS_SPLIT_NPOINTS:
                runs[(label, k)] = functools.partial(launch, xyz, k, None, c)
    runs[("this wrapper", NPOINT)] = functools.partial(fps.farthest_point_sample, xyz, NPOINT)
    ms = ms_in_turns(runs, reps)
    out = {}
    for (label, k), t in ms.items():
        out.setdefault(label, {})[k] = t
    lo, hi = FPS_SPLIT_NPOINTS[1], FPS_SPLIT_NPOINTS[2]
    for d in out.values():
        if all(k in d for k in FPS_SPLIT_NPOINTS):
            d["step"] = (d[hi] - d[lo]) / (hi - lo)
            d["setup"] = d[FPS_SPLIT_NPOINTS[0]] - d["step"]
    return out


def k1_step(card, name, xyz, parent_lib):
    """Step 0 of K1's redesign and, with a parent library, K1 against it on
    one batch of clouds: each tree's step split (fps_step_split, in turns;
    this tree also at every cluster size) beside the bound per step, this
    tree's shared memory and active clusters per cluster size, and the
    parent's indices equal to this tree's at npoint 512."""
    import torch

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import fps

    libs = {"this": kernels.library()}
    if parent_lib is not None:
        libs = {"parent": parent_lib, **libs}
    launchers = {tag: fps_launcher(lib) for tag, lib in libs.items()}
    b, n, _ = xyz.shape
    occ = ["c{} {} B, {} active clusters".format(c, *kernels.fps_occupancy(n, c))
           for c in FPS_CLUSTERS]
    print(f"  occupancy (this): fps {name} N={n} (wrapper's cluster "
          f"{fps.fps_cluster_size(n)}): " + "; ".join(occ))
    sp = fps_step_split(xyz, launchers, reps=5)
    # the bound of the table (row 1): it prices the work, not the chain of steps
    bnd = bound_ms(9.0 * (NPOINT - 1) * n * b, (n * 12 + NPOINT * 4) * b)
    print(f"  fps {name}: bound {bnd[0]:.4f} ms ({bnd[1]}) for npoint {NPOINT}, "
          f"{1e3 * bnd[0] / (NPOINT - 1):.4f} us a step; this tree's step "
          f"{1e3 * sp['this']['step']:.3f} us")
    for label, d in sp.items():
        if "step" not in d:
            print(f"[{card}] fps {name} {tuple(xyz.shape)} {label}: npoint {NPOINT} "
                  f"{d[NPOINT]:.4f} ms")
            continue
        print(f"[{card}] fps {name} {tuple(xyz.shape)} {label}: " + ", ".join(
            f"npoint {k} {d[k]:.4f} ms" for k in FPS_SPLIT_NPOINTS)
              + f"; per step {1e3 * d['step']:.3f} us, set-up {d['setup']:.4f} ms")
    if parent_lib is not None:
        want = fps.farthest_point_sample(xyz, NPOINT)
        require(torch.equal(launchers["parent"](xyz, NPOINT), want),
                f"K1: the parent's indices != this tree's on {name}")
        print(f"[{card}] fps {name}: parent {sp['parent'][NPOINT]:.4f} ms, this "
              f"{sp['this'][NPOINT]:.4f} ms at npoint {NPOINT} (kernels alone, in turns); "
              "indices equal to the parent's")
    return sp


# K2's kernel as ptxas and cuobjdump name it: the mangled name's length
# prefix keeps K4's sorted_ball_query_kernel out
K2_MARKER = "17ball_query_kernel"
K2_CLUSTERS = (1, 2, 4, 8, 16)
# blocks of turns (parent, this, this, parent) of the model forward with
# either tree's K2
FWD_BLOCKS = 10


def k2_launcher(lib):
    """K2 of the ctypes library `lib` as f(xyz, centers, mask, ns, idx, cnt,
    cluster=None, stop=0, r2=RADIUS^2), on the current stream. A library
    without f3d_ball_query_occupancy has K2's first design (a warp a
    centre: no cluster size, no stop); this tree's takes the cluster size,
    by default the wrapper's (ops.batch_group.k2_cluster_size), and
    a stop (kernels.BALL_QUERY_STOPS) for the time split."""
    import ctypes

    import torch

    from feat3dnet_tpu_torch.ops import batch_group

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.f3d_ball_query
    clustered = hasattr(lib, "f3d_ball_query_occupancy")
    fn.argtypes = [P, P, P, I, I, I, F, I] + ([I, I] if clustered else []) + [P, P, P]
    fn.restype = I
    r2 = float(np.float32(RADIUS) * np.float32(RADIUS))

    def launch(xyz, centers, mask, ns, idx, cnt, cluster=None, stop=0, r2=r2):
        b, n, _ = xyz.shape
        m = centers.shape[1]
        if clustered:
            extra = [batch_group.k2_cluster_size(b, m, n, xyz.device) if cluster is None
                     else cluster, stop]
        else:
            require(cluster is None and stop == 0, "K2's first design takes no cluster or stop")
            extra = []

        def ptr(t):
            return ctypes.c_void_p(None if t is None else t.data_ptr())
        err = fn(ptr(xyz), ptr(centers), ptr(mask), b, n, m, r2, ns, *extra, ptr(idx), ptr(cnt),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        require(err == 0, f"K2 launch returned CUDA error {err}")
    launch.clustered = clustered
    return launch


@contextlib.contextmanager
def k2_from(lib):
    """Every K2 launch inside (the wrapper's) goes through the ctypes
    library `lib`'s K2 (k2_launcher: another tree's, whatever its design);
    the rest of the path is this tree's."""
    from feat3dnet_tpu_torch import kernels

    launch = k2_launcher(lib)
    saved = kernels.launch_ball_query

    def shim(xyz, centers, mask, r2, ns, cluster, idx, cnt, stop=None, radii=None):
        require(stop is None and radii is None, "k2_from: no stop, no per-centre radii")
        launch(xyz, centers, mask, ns, idx, cnt, cluster if launch.clustered else None, r2=r2)
    kernels.launch_ball_query = shim
    try:
        yield
    finally:
        kernels.launch_ball_query = saved


def k2_occupancy(lib, cluster):
    """(static shared memory bytes a CTA, CTAs resident on one SM, clusters
    resident on the card) of a clustered K2's launch at `cluster` CTAs."""
    import ctypes

    import torch

    out = torch.zeros(3, dtype=torch.int32)
    lib.f3d_ball_query_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.f3d_ball_query_occupancy.restype = ctypes.c_int
    require(lib.f3d_ball_query_occupancy(cluster, ctypes.c_void_p(out.data_ptr())) == 0,
            "K2 occupancy query")
    return tuple(int(v) for v in out)


def k2_counts(xyz, ik, ck, cluster, ns=NS):
    """What K2 must do on one call (r RADIUS, ns NS or `ns`), counted on the card
    from its output: per centre the points scanned up to its ns-th hit (all
    N when it has fewer), their mean and max, the share of balls with >= ns
    hits; the pairs tested and the longest dependent chain of K2's first
    design (a warp a centre, 32 points a step, so ceil(scanned / 32) steps);
    and of the cluster design at `cluster` CTAs a group of 32 centres
    (rounds of cluster x warps x chunks x 32 points at
    kernels.ball_query_shape's sizes, a group stopping after the first
    round that holds every one of its centres' ns-th hit):
    the rounds it runs, the pairs it tests (its centres times the points of
    those rounds) and the points one lane passes over in them (its warp's
    chunks x 32, the chain of a lane)."""
    import torch

    from feat3dnet_tpu_torch import kernels

    b, n, _ = xyz.shape
    m = ik.shape[1]
    sat = ck >= ns
    scanned = torch.where(sat, ik[..., ns - 1].long() + 1, torch.full_like(ck, n).long())
    w, k, _ = kernels.ball_query_shape()
    v = cluster * w
    per_round = v * k * 32
    pad = -m % 32
    need = torch.nn.functional.pad(-(-scanned // per_round), (0, pad))
    rounds = need.view(b, -1, 32).amax(-1)                      # (b, groups)
    real = torch.nn.functional.pad(torch.ones_like(scanned), (0, pad)).view(b, -1, 32).sum(-1)
    pts = torch.clamp(rounds * per_round, max=n)
    chunks = -(-n // 32)
    lane = sum(-(-min(v * k, chunks - r * v * k) // v) * 32 for r in range(int(rounds.max())))
    return {"centres": b * m,
            "share of balls with >= ns hits": sat.double().mean().item(),
            "points scanned per centre mean": scanned.double().mean().item(),
            "max": int(scanned.max().item()),
            "pairs tested (a warp a centre)": int(scanned.sum().item()),
            "longest chain (a warp a centre), warp steps":
                int(((scanned + 31) // 32).max().item()),
            "all pairs": b * m * n,
            f"cluster {cluster}: rounds max": int(rounds.max().item()),
            f"cluster {cluster}: pairs tested": int((pts * real).sum().item()),
            f"cluster {cluster}: points a lane passes": lane}


def ball_query_time_split(xyz, ctr, launchers, reps):
    """K2's time split at r RADIUS, ns NS: ms per call (CUDA events, `reps`
    back-to-back calls, in turns) of the plain version, and per launcher
    ({tag: k2_launcher}) of the kernel alone on outputs made once and of
    the whole call (this tree's wrapper; another tree's kernel on fresh
    outputs), each with the host's launch time; then on the device alone
    (graph_ms, keys ending in "dev") the kernel alone and, for a clustered
    design, the kernel stopped after its count (every round's stage and
    masks, no exchange) and after its exchange (no writes), and at each
    cluster size of K2_CLUSTERS. Returns (ms by key, {tag: (idx, cnt) of
    the kernel-alone runs})."""
    import torch

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import batch_group

    b, _, _ = xyz.shape
    m = ctr.shape[1]

    def fresh():
        return (torch.empty((b, m, NS), dtype=torch.int32, device=xyz.device),
                torch.empty((b, m), dtype=torch.int32, device=xyz.device))

    runs = {"plain": functools.partial(batch_group.ball_query_fused.plain, xyz, ctr, RADIUS, NS)}
    dev = {}
    outs = {}
    for tag, launch in launchers.items():
        outs[tag] = fresh()
        runs[f"{tag} kernel"] = functools.partial(launch, xyz, ctr, None, NS, *outs[tag])
        runs[f"{tag} whole"] = (
            functools.partial(batch_group.ball_query_fused, xyz, ctr, RADIUS, NS)
            if tag == "this" else (lambda launch=launch: launch(xyz, ctr, None, NS, *fresh())))
        scratch = fresh()
        dev[f"{tag} kernel dev"] = functools.partial(launch, xyz, ctr, None, NS, *scratch)
        if launch.clustered:
            for stage, stop in kernels.BALL_QUERY_STOPS.items():
                dev[f"{tag} {stage} dev"] = functools.partial(launch, xyz, ctr, None, NS,
                                                              *scratch, stop=stop)
            for c in K2_CLUSTERS:
                dev[f"{tag} c{c} dev"] = functools.partial(launch, xyz, ctr, None, NS, *scratch,
                                                           cluster=c)
    return {**ms_in_turns(runs, reps), **graph_ms(dev, 20)}, outs


def k2_step(card, name, xyz, ctr, parent_lib):
    """Step 0 of K2's redesign and, with a parent library, K2 against it on
    one call (r RADIUS, ns NS): the counts (k2_counts), each tree's launch
    (occupancy where it has the entry point), the time split of each tree
    with the plain version, in turns (ball_query_time_split), beside the
    bound, and each tree's kernel-alone output index-exact to this tree's
    wrapper. Returns (the split, the bound)."""
    import torch

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import batch_group

    b, n, _ = xyz.shape
    m = ctr.shape[1]
    libs = {"this": kernels.library()}
    if parent_lib is not None:
        libs = {"parent": parent_lib, **libs}
    launchers = {tag: k2_launcher(lib) for tag, lib in libs.items()}
    ik, ck = batch_group.ball_query_fused(xyz, ctr, RADIUS, NS)
    c = batch_group.k2_cluster_size(b, m, n, xyz.device)
    counts = k2_counts(xyz, ik, ck, c)
    print(f"K2 counts {name} {tuple(xyz.shape)} x {m} centres: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in counts.items()))
    for tag, launch in launchers.items():
        if launch.clustered:
            occ = ["c{} {} B, {} blocks/SM, {} active clusters".format(
                cl, *k2_occupancy(libs[tag], cl)) for cl in K2_CLUSTERS]
            print(f"  occupancy ({tag}): ball_query {name} (wrapper's cluster {c}, "
                  f"{b * -(-m // 32) * c} CTAs): " + "; ".join(occ))
        else:
            print(f"  occupancy ({tag}): ball_query {name}: {-(-b * m // 8)} blocks of 256 "
                  "threads, a warp a centre, no shared memory (no occupancy entry point)")
    sp, outs = ball_query_time_split(xyz, ctr, launchers, reps=5)
    scanned = torch.where(ck >= NS, ik[..., NS - 1].long() + 1,
                          torch.full_like(ck, n).long()).sum().item()
    bnd = bound_ms(8.0 * scanned, nbytes(xyz, ctr, ik, ck))
    print_split(card, f"ball_query {name} {tuple(xyz.shape)} x {m} (bound {bnd[0]:.4f} ms, "
                f"{bnd[1]})", sp)
    for tag, (i_t, c_t) in outs.items():
        require(torch.equal(i_t, ik) and torch.equal(c_t, ck),
                f"K2 of {tag} (kernel alone) != this tree's wrapper on {name}")
    if parent_lib is not None:
        print(f"[{card}] ball_query {name}: parent {sp['parent kernel dev']:.4f} ms, this "
              f"{sp['this kernel dev']:.4f} ms (kernels alone on the device, in turns); with "
              f"the host's launch parent {sp['parent kernel']:.4f}, this "
              f"{sp['this kernel']:.4f} ms; wrapper parent {sp['parent whole']:.4f}, this "
              f"{sp['this whole']:.4f} ms; plain {sp['plain']:.4f} ms; idx and cnt equal to "
              "the parent's")
    return sp, bnd


def k2_case_inputs(dev):
    """{name: (xyz, centres, mask or None)} of K2's cases (k2_cases)."""
    import torch

    from feat3dnet_tpu_torch.ops import fps
    from feat3dnet_tpu_torch.ops.neighborhoods import gather_points

    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    xyz_t = training_batch(dev, SEED)
    ragged = torch.randn(3, 3001, 3, generator=g) * 3.0
    ragged[:, 1500:1700] = ragged[:, 100:300]                   # duplicates
    ragged_mask = torch.rand(3, 3001, generator=g) > 0.33
    big = torch.randn(1, 70000, 3, generator=g) * 6.0
    val = torch.randn(VAL_BATCH, VAL_POINTS, 3, generator=g) * 2.0
    val_mask = (torch.arange(VAL_POINTS)[None, :]
                < torch.randint(64, VAL_POINTS + 1, (VAL_BATCH, 1), generator=g))
    val = torch.where(val_mask[..., None], val, torch.zeros(()))
    return {
        "training batch": (xyz_t, gather_points(
            xyz_t, fps.farthest_point_sample(xyz_t, NPOINT)).contiguous(), None),
        "all masked (2, 3000)": (ragged[:2, :3000].contiguous().to(dev),
                                 ragged[:2, :300].contiguous().to(dev),
                                 torch.zeros(2, 3000, dtype=torch.bool, device=dev)),
        "70 000 points": (big.to(dev), big[:, ::137][:, :NPOINT].contiguous().to(dev), None),
        "ragged (3, 3001) x 77, masked": (ragged.to(dev), (ragged[:, ::39][:, :77] + 0.5)
                                          .contiguous().to(dev), ragged_mask.to(dev)),
        f"validator ({VAL_BATCH}, {VAL_POINTS}) x 1, masked": (
            val.to(dev), torch.zeros(VAL_BATCH, 1, 3, device=dev), val_mask.to(dev))}


def k2_cases(dev, parent_lib):
    """K2 index-exact (idx and cnt) against its plain version and, with a
    parent library, the parent's K2, at r RADIUS, ns NS: the training batch
    (18 x 4 096, its 512 FPS centres), an all-masked cloud, 70 000 points
    (past a round of the widest cluster), N and M off every chunk, round
    and group boundary with duplicated points and a third masked, and the
    cluster-pair validator's shape (VAL_BATCH clusters of 64-1 024 points
    padded to 1 024, the padding masked at the origin, one centre at the
    origin each)."""
    import torch

    from feat3dnet_tpu_torch.ops import batch_group

    parent = None if parent_lib is None else k2_launcher(parent_lib)
    for name, (xyz, ctr, mask) in k2_case_inputs(dev).items():
        ik, ck = batch_group.ball_query_fused(xyz, ctr, RADIUS, NS, mask)
        ip, cp = batch_group.ball_query_fused.plain(xyz, ctr, RADIUS, NS, mask)
        require(torch.equal(ik, ip) and torch.equal(ck, cp), f"K2 != plain on {name}")
        if parent is not None:
            i2, c2 = torch.empty_like(ik), torch.empty_like(ck)
            parent(xyz, ctr, mask, NS, i2, c2)
            require(torch.equal(i2, ik) and torch.equal(c2, ck), f"K2: parent != this on {name}")
        print(f"K2 ball_query {name} {tuple(xyz.shape)} x {ctr.shape[1]} (cluster "
              f"{batch_group.k2_cluster_size(xyz.shape[0], ctr.shape[1], xyz.shape[1], dev)}, "
              f"mean cnt {ck.float().mean().item():.2f}): index-exact vs plain"
              + ("" if parent is None else " and the parent"))
        torch.cuda.empty_cache()


# K6's modes as the wrapper takes them (the weights: unfolded, or folded)
K6_MODES = {"unfolded": {"unfolded": True}, "folded": {},
            "bf16_operands": {"unfolded": True, "bf16_operands": True}}


def tower_bound(cfg, m, moved, bf16, descriptor=False):
    """K6's (descriptor False) or K3's bound on m clusters, priced by the
    function and not by the kernel's choice of unit: in f32 the per-slot
    convs at least 8 wide (the descriptor's mid conv among them) at the
    TF32 peak and the rest (the 3-wide first convs, the single-row layers)
    at the f32 peak; where every product takes bf16 operands (bf16), all at
    the bf16 peak; against the bytes moved. Beside it, the bound with every
    product at the f32 peak."""
    def wide(widths):
        return sum(a * b for a, b in zip(widths, widths[1:]) if a >= 8)
    per_slot = wide((3,) + tuple(cfg.detector_mlp))
    if descriptor:
        per_slot += (wide((3,) + tuple(cfg.descriptor_mlp))
                     + wide((2 * cfg.descriptor_mlp[-1],) + tuple(cfg.descriptor_mlp2)))
    wide_macs = cfg.num_samples * per_slot
    total = tower_macs(cfg, descriptor=descriptor)
    if bf16:
        t_ops = 2.0 * total / PEAK_BF16_FLOPS * m * 1e3
    else:
        t_ops = (2.0 * wide_macs / PEAK_TF32_FLOPS
                 + 2.0 * (total - wide_macs) / PEAK_F32_FLOPS) * m * 1e3
    t_mem = moved / PEAK_HBM_BYTES * 1e3
    return (((t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")),
            bound_ms(2.0 * total * m, moved))


# clusters per block of K3's and K6's launches (csrc/tower_pool.cuh kC)
TOWER_CLUSTERS_PER_BLOCK = 2


def k6_step(card, name, offs, weights, cfg, parent):
    """Step 0 of K6's redesign and, with a parent tree (its csrc/), K6
    against it, in each mode: each tree's occupancy line, the time split of
    each tree in turns (fused_detect_time_split: the parent's and this
    kernel alone in turns), the pool's candidates this tree's kernel
    re-sums, and the parent's outputs (on the weights it packs itself)
    equal to this tree's bit for bit in every mode."""
    import torch

    from feat3dnet_tpu_torch.ops import fused_describe as fd

    trees = {"this": None} if parent is None else {"parent": parent, "this": None}
    for mode, kw in K6_MODES.items():
        w = weights[mode]
        for tag, csrc in trees.items():
            detect_occupancy_line(tag, w, cfg, kw, offs.shape[1], csrc)
        sp = fused_detect_time_split(w, offs, cfg, kw, trees,
                                     reps=3 if offs.shape[0] <= FULL_CHECK else 2)
        print_split(card, f"fused_detect {mode} {name} M={offs.shape[0]}", sp)
        unf, bf16 = kw.get("unfolded", False), kw.get("bf16_operands", False)
        packed = fd._detect_kernel_weights(w, cfg, offs.device, unf, bf16=bf16)
        out = torch.empty((offs.shape[0], 3), device=offs.device)
        # the pool's work: its candidates, counted per block by the
        # candidates stage (kernels.detect_stops)
        fd._launch_detect(offs, packed, cfg, unf, bf16, out, stop="candidates")
        nblk = -(-offs.shape[0] // TOWER_CLUSTERS_PER_BLOCK)
        per = out.view(-1)[:nblk] / (TOWER_CLUSTERS_PER_BLOCK * cfg.detector_mlp[-1])
        print(f"  fused_detect {mode} {name}: pool candidates per cluster and channel mean "
              f"{per.mean().item():.4f}, a block's max {per.max().item():.4f}")
        if parent is None:
            continue
        att, ori = fd.fused_detect_clusters(w, offs, cfg, packed=packed, **kw)
        with kernels_from(parent):
            att_p, ori_p = fd.fused_detect_clusters(
                w, offs, cfg, packed=detect_pack(parent, w, cfg, offs.device, unf, bf16), **kw)
        require(torch.equal(att, att_p) and torch.equal(ori, ori_p),
                f"K6 {mode} vs parent on {name}: not bit-equal (att max|d| "
                f"{(att - att_p).abs().max().item():.3e}, ori max|d| "
                f"{_wrapped(ori - ori_p).abs().max().item():.3e})")
        print(f"[{card}] fused_detect {mode} {name} M={offs.shape[0]}: parent "
              f"{sp['parent kernel']:.4f} ms, this {sp['this kernel']:.4f} ms (kernels alone, "
              f"in turns); bit-equal to the parent")


def extraction_phases(dev, card, clouds, npz_path, data_dir, out_dir, parent_lib=None,
                      parent=None):
    """Phases 5-8: K4/K5/K6 against their plain versions at the extraction
    shapes, InferencePipeline.extract with the trained weights (launch
    counters reset), its outputs against the dense route and across the
    two routes, then times (with `parent`, another tree's csrc/, its K4
    and K6 against this one's). `clouds` maps names to (N, >=3) host arrays;
    process_directory writes into `out_dir` (emptied first). Returns
    {kernel: report} for K4, K5, K6 and the extraction path's launches."""
    import shutil

    import torch

    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, bucket_for
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import batch_group, fps
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.ops import hash_grid as hg
    from feat3dnet_tpu_torch.utils import load_variables, load_variables_npz

    cfg = ModelConfig()
    variables = load_variables_npz(npz_path)
    model = load_variables(Feat3DNet(cfg), variables).eval().to(dev)
    w_det = [w.to(dev) for w in fd.transpose_unfolded_detector(
        fd.detector_weights_unfolded(variables, cfg))]
    w_fold = [w.to(dev) for w in fd.transpose_folded_weights(fd.folded_weights(variables, cfg))]
    k6_weights = {"unfolded": w_det, "folded": w_fold, "bf16_operands": w_det}
    pk_det = fd._detect_kernel_weights(w_det, cfg, dev, unfolded=True)   # packed once
    report = {"sorted_ball_query": {"max_abs_err": 0}, "ball_max": {"max_abs_err": 0},
              "fused_detect": {"max_abs_err": 0.0}}
    times = {k: [] for k in report}
    bounds = {k: [] for k in report}
    layout_ms = {}

    # ---- 5. the Morton layout on the card against the host's; K4, K5, K6
    # against their plain versions at the extraction shapes
    with torch.no_grad():
        for name, cloud in clouds.items():
            n, nb = cloud.shape[0], bucket_for(cloud.shape[0])
            layout_ms[name] = layout_step(card, name, dev, cloud)
            sc, ctr, top_k, cnt_k, offs, sl = sorted_clusters(dev, cloud)
            ctr_sl = ctr[sl].contiguous()
            top_p, cnt_p = hg.sorted_ball_query_plain(sc.pts4, ctr_sl, RADIUS, NS)
            require(torch.equal(top_k[sl], top_p) and torch.equal(cnt_k[sl], cnt_p),
                    f"sorted ball query kernel != plain on {name}")
            att_k, ori_k = fd.fused_detect_clusters(w_det, offs, cfg, unfolded=True)
            att_p, ori_p = fd.fused_detect_clusters_plain(w_det, offs[sl], cfg, unfolded=True)
            a_err = (att_k[sl] - att_p).abs()
            a_rel = (a_err / att_p.abs().clamp(min=1e-6)).max().item()
            o_err = _wrapped(ori_k[sl] - ori_p).abs().max().item()
            require(a_rel <= 1e-5 and o_err <= 1e-5,
                    f"fused detect kernel outside tolerance on {name}: att rel {a_rel:.3e}, "
                    f"ori {o_err:.3e} rad")
            report["fused_detect"]["max_abs_err"] = max(report["fused_detect"]["max_abs_err"],
                                                        a_err.max().item())
            k4_step(card, name, nb, sc, ctr, cnt_k, top_k, parent_lib)
            k6_step(card, name, offs, k6_weights, cfg, parent)
            bm_k = hg.ball_max_sorted(sc.pts4, sc.blk_bbox, att_k, NMS_RADIUS)
            bm_p = hg.ball_max_plain(sc.pts4, att_k, NMS_RADIUS, centers=ctr_sl)
            require(torch.equal(bm_k[sl], bm_p), f"ball max kernel != plain on {name}")
            k5_step(card, name, nb, sc, ctr, att_k, bm_k, parent_lib)
            real = ctr[:, 0] < 5e8
            sat = (cnt_k[real] > NS).float().mean().item()
            print(f"K4/K5/K6 {name} N={n} bucket {nb} (plain on {sl.stop - sl.start} centres): "
                  f"K4 top/cnt exact, mean in-ball {cnt_k[real].float().mean().item():.1f}, "
                  f"{100 * sat:.1f} % saturated; K6 att rel {a_rel:.3e} (<= 1e-5), ori "
                  f"{o_err:.3e} rad (<= 1e-5); K5 ball max exact, "
                  f"{(att_k[real] >= bm_k[real]).sum().item()} local maxima")
            if nb <= FULL_CHECK:      # times at the vendored clouds' shapes
                # what this cloud's data needs: every in-ball pair tested once
                # (8 flops), the NMS balls' pairs also maxed (9)
                _, cnt_nms = hg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, NMS_RADIUS, 1,
                                                  tile=256)
                bounds["sorted_ball_query"].append(bound_ms(
                    8.0 * cnt_k[real].sum().item(), nbytes(sc.pts4, ctr, top_k, cnt_k)))
                bounds["ball_max"].append(bound_ms(
                    9.0 * cnt_nms[real].sum().item(), nbytes(sc.pts4, att_k, bm_k)))
                b6, b6_f32 = tower_bound(cfg, offs.shape[0],
                                          nbytes(offs, *w_det) + offs.shape[0] * 8, False)
                bounds["fused_detect"].append(b6)
                print(f"  fused_detect {name} bound {b6[0]:.4f} ms ({b6[1]}; every product at "
                      f"the f32 peak: {b6_f32[0]:.4f} ms)")
                pairs = (
                    ("sorted_ball_query",
                     lambda: hg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, RADIUS, NS, tile=256),
                     lambda: hg.sorted_ball_query_plain(sc.pts4, ctr, RADIUS, NS), 5, 1),
                    ("fused_detect",
                     lambda: fd.fused_detect_clusters(w_det, offs, cfg, unfolded=True,
                                                      packed=pk_det),
                     lambda: fd.fused_detect_clusters_plain(w_det, offs, cfg, unfolded=True),
                     3, 2),
                    ("ball_max", lambda: hg.ball_max_sorted(sc.pts4, sc.blk_bbox, att_k, NMS_RADIUS),
                     lambda: hg.ball_max_plain(sc.pts4, att_k, NMS_RADIUS), 10, 2))
                for key, kf, pf, rk, rp in pairs:
                    ms_k, ms_p = in_turns(kf, pf, rk, rp)
                    times[key].append((ms_k, ms_p))
                    print(f"[{card}] {key} {name} bucket {nb}: kernel {ms_k:.4f} ms, "
                          f"plain {ms_p:.4f} ms")
            del sc, top_k, top_p, offs
    for key, per in times.items():
        report[key]["ms"] = float(np.mean([p[0] for p in per]))
        report[key]["plain_ms"] = float(np.mean([p[1] for p in per]))
        report[key]["bound_ms"], report[key]["bound_by"] = mean_bound(bounds[key])

    # ---- 6. the extraction path, trained weights, counters from zero --------
    pipes = {"default": InferencePipeline(model, None, cfg, InferenceConfig(), device=dev),
             "fused": InferencePipeline(model, None, cfg,
                                        InferenceConfig(use_fused_detector=True), device=dev)}
    wrappers = {"fps": fps.farthest_point_sample, "ball_query": batch_group.ball_query_fused,
                "fused_describe": fd.fused_describe_clusters_t,
                "sorted_ball_query": hg.sorted_ball_query, "ball_max": hg.ball_max_sorted,
                "fused_detect": fd.fused_detect_clusters}
    for w in wrappers.values():
        w.launches = 0
    results = {route: {} for route in pipes}
    shutil.rmtree(out_dir, ignore_errors=True)
    for route, pipe in pipes.items():
        for name, cloud in clouds.items():
            results[route][name] = pipe.extract(cloud)
    n_files = pipes["default"].process_directory(data_dir, out_dir, log=lambda *_: None)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"extraction path launches: {launches}")
    for k in ("sorted_ball_query", "ball_max", "fused_detect", "fused_describe"):
        require(launches[k] > 0, f"kernel {k} was not launched on the extraction path")

    # ---- 7. outputs: hashed == dense, fused ~ default, files ----------------
    dense = InferencePipeline(model, None, cfg, InferenceConfig(use_hashed_grouping=False),
                              device=dev)
    dense_ms = {}
    for name, cloud in clouds.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rd = dense.extract(cloud)
        dense_ms[name] = (time.perf_counter() - t0) * 1e3
        rh, rf = results["default"][name], results["fused"][name]
        require(rh.num_keypoints == rd.num_keypoints and np.array_equal(rh.keypoints, rd.keypoints),
                f"hashed extract keypoints != dense on {name}")
        f_err = float(np.abs(rh.features - rd.features).max())
        a_rel = float((np.abs(rh.attention - rd.attention)
                       / np.maximum(np.abs(rd.attention), 1e-6)).max())
        require(f_err <= 1e-4 and a_rel <= 1e-5,
                f"hashed extract outputs != dense on {name}: {f_err:.3e}, {a_rel:.3e}")
        require(np.isfinite(rh.features).all() and rh.features.shape == (rh.num_keypoints, 32),
                f"extract output shape on {name}")
        kd = {r.tobytes(): i for i, r in enumerate(rh.keypoints)}
        shared = [(kd[r.tobytes()], j) for j, r in enumerate(rf.keypoints) if r.tobytes() in kd]
        overlap = len(shared) / max(rh.num_keypoints, rf.num_keypoints, 1)
        # the fused route's descriptors come from K3, whose BN is folded into
        # the weights: they round differently from the model tower (the
        # serving envelope), so a rare cluster lands past 1e-4
        fa = rh.features[[i for i, _ in shared]]
        fb = rf.features[[j for _, j in shared]]
        dmax = np.abs(fa - fb).max(axis=1)
        cos = (fa * fb).sum(1) / np.linalg.norm(fa, axis=1) / np.linalg.norm(fb, axis=1)
        within = float((dmax <= 1e-4).mean())
        print(f"extract {name}: hashed == dense ({rh.num_keypoints} keypoints, features "
              f"max|d| {f_err:.3e}, attention rel {a_rel:.3e}); fused route {rf.num_keypoints} "
              f"keypoints, overlap {len(shared)}/{max(rh.num_keypoints, rf.num_keypoints)} = "
              f"{100 * overlap:.2f} % (>= 99 %); shared features max|d| {dmax.max():.3e}, "
              f"{100 * within:.2f} % within 1e-4 (>= 99 %), min cos {cos.min():.7f} (>= 0.9999)")
        require(overlap >= 0.99 and within >= 0.99 and cos.min() >= 0.9999,
                f"fused route disagrees on {name}")
        # both routes on the host-built layout (the route before the device
        # builder) give the same outputs bit for bit
        with host_layout():
            for route, pipe in pipes.items():
                r_host, r_dev = pipe.extract(cloud), results[route][name]
                require(r_host.num_keypoints == r_dev.num_keypoints
                        and all(np.array_equal(getattr(r_host, f), getattr(r_dev, f))
                                for f in ("keypoints", "attention", "features")),
                        f"{route} extract on the device layout != on the host layout, {name}")
        print(f"extract {name}: default and fused routes on the device layout equal to the "
              "host-layout route (keypoints, attention, features bit for bit)")
    written = sorted(os.listdir(out_dir))
    require(len(written) == n_files == 4, f"process_directory wrote {written}")
    for fname in written:
        rows = np.fromfile(os.path.join(out_dir, fname), np.float32)
        require(rows.size % 35 == 0 and rows.size > 0, f"{fname}: not (K, 35) float32 rows")
        want = results["default"].get(fname)
        if want is not None:
            require(np.array_equal(rows.reshape(-1, 35),
                                   np.concatenate([want.keypoints, want.features], 1)),
                    f"{fname}: written rows differ from extract")
    print(f"process_directory: {n_files} files of (K, 35) float32 rows, equal to extract")

    # ---- 8. times: extract latency per cloud, both routes, in turns ---------
    for name, cloud in clouds.items():
        # each route on the device layout and, in turns, on the host layout
        ms = {key: [] for key in itertools.product(("device", "host"), pipes)}
        queue_ms = []
        for layout in ("device", "host", "host", "device"):
            with host_layout() if layout == "host" else layout_queue_clock(queue_ms):
                for route in (("default", "fused") if layout == "device"
                              else ("fused", "default")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = pipes[route].extract(cloud)
                    ms[layout, route].append((time.perf_counter() - t0) * 1e3)
        print(f"[{card}] extract {name} N={cloud.shape[0]}: default "
              f"{np.mean(ms['device', 'default']):.2f} ms, fused "
              f"{np.mean(ms['device', 'fused']):.2f} ms (on the host layout, in turns: "
              f"{np.mean(ms['host', 'default']):.2f}, {np.mean(ms['host', 'fused']):.2f} ms), "
              f"dense route {dense_ms[name]:.2f} ms (host clock, synchronised); Morton layout "
              f"on the device {layout_ms[name][0]:.4f} ms (CUDA events; queued on the host "
              f"in {np.mean(queue_ms):.3f} ms of the extract), the old host numpy layout "
              f"{layout_ms[name][1]:.2f} ms; {res.num_keypoints} keypoints")
    # where the device time goes in one extract of the two largest clouds
    for name, route in itertools.product(
            sorted(clouds, key=lambda k: clouds[k].shape[0])[-2:], pipes):
        pipe = pipes[route]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.extract(clouds[name])
            wall = (time.perf_counter() - t0) * 1e3
        # the device-side entries are the kernels themselves
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        ev.sort(key=lambda e: e.self_device_time_total, reverse=True)
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
        print(f"[{card}] profile extract {name} ({route}): wall {wall:.2f} ms, device busy "
              f"{dev_ms:.2f} ms ({100 * dev_ms / wall:.1f} %)")
        for e in ev[:8]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return report, launches


TRAIN_CLOUDS = 18        # 3B: TrainConfig().batch_size = 6 triplets of clouds
TRAIN_POINTS = 4096      # TrainConfig().num_points
TRAIN_EPOCHS, RESUME_EPOCHS = 10, 2   # 12 entries / 6 per step: 20, then 4 more steps
VAL_PAIRS, VAL_EVERY = 32, 10          # cli.train's cluster pairs, validation cadence
TIE_CLUSTERS = 256       # clusters whose 64 slots are made equal (every slot ties)
POOL_PAD_SLOTS = 40      # check_pool_cases: slots kept (24 pad slots)
RELU_ZERO_CHANNELS = 8   # check_pool_cases: top-conv channels with every pre-ReLU value < 0
# elementwise outputs (dx, the streamed cotangent) may differ past their
# tolerance where a ReLU input or a pool candidate sits within rounding of
# its rival: the kernel and the plain version sum in other orders
FLIP_SHARE = 1e-5
# check_pool_cases: there a flip at a pool near-tie moves every slot of the
# tie group (up to ns rows of one cluster) and with them dW; at most this
# share of the clusters may flip, and K10 is held on the others
FLIP_CLUSTER_SHARE = 1e-3
TRAIN_KERNELS = ("train_stats", "train_final", "train_bwd_top", "train_bwd")
# --parent: the passes whose outputs must equal the parent tree's bit for bit
# (a max and a tie count are exact in any order)
EXACT_TO_PARENT = ("train_final", "train_bwd_top")
# --parent: the sources and headers of the other tree that are built (and
# its tensor-core header where it has one)
PARENT_BUILD = (("fused_train.cu", "sorted_ball_query.cu", "fused_detect.cu",
                 "fused_describe.cu", "ball_max.cu", "fps.cu", "ball_query.cu"),
                ("common.cuh", "slot_layer.cuh"))
PARENT_OPTIONAL_HEADERS = ("tc_mma.cuh", "tower_pool.cuh", "block_cull.cuh")


def compare(name, got, want, rtol, atol, max_share=0.0):
    """|got - want| <= atol + rtol |want| on all but max_share of the
    elements; returns (max |d|, share outside)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    share = (d > atol + rtol * want.abs()).float().mean().item()
    require(share <= max_share,
            f"{name}: {100 * share:.5f} % of elements outside rtol {rtol:g} / atol "
            f"{atol:.3g} (max |d| {d.max().item():.3e})")
    return d.max().item(), share


def compare_bwd(tag, got, want, j, cot_rtol):
    """K10's outputs (dW, db, do_prev or dx, the next conv's sums) for conv
    j against `want` at phase 9's tolerances; returns dW's max |d|."""
    dw_k, db_k, out_k, bst_k = got
    dw_p, db_p, out_p, bst_p = want
    dw_scale = dw_p.abs().max().item()
    e, _ = compare(f"{tag} dW", dw_k, dw_p, 5e-3, 5e-4 * dw_scale)
    # db is analytically zero under BN: both sides are the rounding noise of
    # a sum over ns * G rows, held to the layer's weight-gradient scale
    compare(f"{tag} db", db_k, db_p, 0.0, 5e-4 * dw_scale)
    if j > 0:
        _, share = compare(f"{tag} do_prev", out_k, out_p, cot_rtol, 5e-5, FLIP_SHARE)
        compare(f"{tag} next sums", bst_k, bst_p, 5e-3, 5e-4 * bst_p.abs().max().item())
    else:
        _, share = compare(f"{tag} dx", out_k, out_p, 5e-3, 5e-5, FLIP_SHARE)
    if share:
        print(f"  {tag}: {100 * share:.5f} % of the elementwise output past tolerance "
              f"(<= {100 * FLIP_SHARE:g} %)")
    return e


def training_batch(dev, seed):
    """One step's 18 clouds: the vendored clouds in turn, cropped to 20 m and
    resampled to 4 096 points under seeds seed, seed + 1, ..."""
    from feat3dnet_tpu_torch.data.datagenerator import crop_and_resample
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud

    raw = {n: load_point_cloud(example_cloud_path(n)) for n in CLOUDS}
    out = [crop_and_resample(raw[CLOUDS[i % len(CLOUDS)]], TRAIN_POINTS,
                             np.random.RandomState(seed + i))[:, :3]
           for i in range(TRAIN_CLOUDS)]
    return torch_from(np.stack(out), dev)


def torch_from(a, dev):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def write_train_dataset(root):
    """12 entries in the train.txt format: each vendored cloud under three
    seeded z-rotations, the other two copies its positives; and a clusters/
    folder of VAL_PAIRS cluster pairs (filenames.txt, half of them two views
    of one crop) for the validator."""
    import shutil

    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.eval.heldout import write_cluster_pairs

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "train"))
    rs = np.random.RandomState(SEED)
    lines = []
    for ci, name in enumerate(CLOUDS):
        cloud = load_point_cloud(example_cloud_path(name))
        for r in range(3):
            a = rs.uniform(0.0, 2 * np.pi)
            rot = np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]],
                           np.float32)
            out = cloud.copy()
            out[:, :3], out[:, 3:6] = cloud[:, :3] @ rot, cloud[:, 3:6] @ rot
            fname = f"{name[:-4]}_r{r}.bin"
            out.astype(np.float32).tofile(os.path.join(root, "train", fname))
            pos = " ".join(str(3 * ci + k) for k in range(3) if k != r)
            lines.append(f"{fname} | {pos} | ")
    with open(os.path.join(root, "train", "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    # cluster pairs for the validator: 4 m crops of the vendored clouds
    places = [load_point_cloud(example_cloud_path(name))[:, :3] for name in CLOUDS]
    write_cluster_pairs(os.path.join(root, "clusters"), rs, places, VAL_PAIRS)


def tower_inputs(cfg, xyz):
    """Slot-major (ns, G, 3) inputs of the two towers for one training batch:
    FPS (K1) + ball query (K2) groupings, and the same rotated by seeded
    angles for the descriptor; the first TIE_CLUSTERS clusters have every
    slot equal to slot 0."""
    import torch

    from feat3dnet_tpu_torch.models.feat3dnet import _rotate_z
    from feat3dnet_tpu_torch.ops import batch_group, fps
    from feat3dnet_tpu_torch.ops.neighborhoods import gather_points, group_points

    ctr = gather_points(xyz, fps.farthest_point_sample(xyz, cfg.num_clusters)).contiguous()
    nidx, _ = batch_group.ball_query_fused(xyz, ctr, cfg.base_scale, cfg.num_samples)
    grouped = (group_points(xyz, nidx) - ctr[:, :, None]) / cfg.base_scale
    g = torch.Generator().manual_seed(SEED)
    ang = (torch.rand(grouped.shape[:2], generator=g) * (2 * np.pi)).to(xyz.device)
    xs = []
    for gr in (grouped, _rotate_z(grouped, ang)):
        x = gr.permute(2, 0, 1, 3).reshape(cfg.num_samples, -1, 3).contiguous()
        x[:, :TIE_CLUSTERS] = x[0:1, :TIE_CLUSTERS].clone()
        xs.append(x)
    return xs


def tower_params(model, cfg):
    """{tower: (plan, flat (W, b, gamma, beta) per conv)} of the model."""
    from feat3dnet_tpu_torch.ops import fused_train as ft

    def flat(blocks):
        return [t.detach().contiguous() for b in blocks
                for t in (b.conv2d.weight.t(), b.conv2d.bias, b.bn.scale, b.bn.bias)]

    det = [getattr(model.detection, f"conv{i}") for i in range(len(cfg.detector_mlp))]
    desc = ([getattr(model.description, f"conv{i}") for i in range(len(cfg.descriptor_mlp))]
            + [getattr(model.description, f"conv_mid_{i}")
               for i in range(len(cfg.descriptor_mlp2))])
    return {"detector": (ft.detector_plan(len(det)), flat(det)),
            "descriptor": (ft.descriptor_plan(len(cfg.descriptor_mlp),
                                              len(cfg.descriptor_mlp2)), flat(desc))}


def compare_stats(tag, got, want, count):
    """K7's (sum y, sum y^2) against `want` at phase 9's tolerances, as
    means and variances; returns the means' max |d|."""
    mk, mp = got[0] / count, want[0] / count
    e, _ = compare(f"{tag} means", mk, mp, 1e-5, 1e-6)
    compare(f"{tag} vars", got[1] / count - mk * mk, want[1] / count - mp * mp, 1e-4, 1e-6)
    return e


def timed_call(kernel_fn, plain_fn, flops, moved, check, label, occupancy):
    """(kernel_fn, plain_fn, bound) for the timing phase. flops: (on the CUDA
    cores, on the tensor cores); the bound prices each at its peak (f32,
    TF32). The kernel_fn carries the all-f32 bound (`f32_bound`, printed
    beside it), `check(tag, got, want)`, phase 9's comparison of two of its
    outputs, its `label` (tower and conv) and `occupancy()`, its launch's
    (shared-memory bytes, blocks per SM) in the library in use."""
    cuda, tc = flops
    kernel_fn.f32_bound, kernel_fn.check = bound_ms(cuda + tc, moved)[0], check
    kernel_fn.label, kernel_fn.occupancy = label, occupancy
    return kernel_fn, plain_fn, bound_ms(cuda + tc * PEAK_F32_FLOPS / PEAK_TF32_FLOPS, moved)


def check_train_passes(tag, x, plan, flat, cot, eps):
    """Phase 9 for one tower and cotangent type: K7-K10 against their plain
    versions on the same inputs (each backward pass gets the plain chain's
    cotangent), twice for bit-equality. Returns ({kernel: max |d|},
    {kernel: [(kernel_fn, plain_fn, bound)]}) for the timing phase."""
    import torch

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import fused_train as ft

    ns, gp, _ = x.shape
    count = float(ns * gp)
    n = len(flat) // 4
    tower = tag.split("/")[0]
    io = ft.plan_conv_widths(plan, [flat[4 * j].shape[1] for j in range(n)], x.shape[2])
    macs = [ci * co for ci, co in io]
    rows = ns * gp
    nblk = min(gp, ft.GRID_BLOCKS)
    wbytes = nbytes(*flat)
    errs = {k: 0.0 for k in TRAIN_KERNELS}
    calls = {k: [] for k in TRAIN_KERNELS}
    folded, means, isigs = [], [], []

    def recompute_flops(upto):
        """(CUDA-core, tensor-core) flops of convs < upto: a conv whose input
        is narrower than one mma step (conv 0's x) runs on the CUDA cores."""
        split = [0.0, 0.0]
        for (ci, _), m in zip(io[:upto], macs[:upto]):
            split[ci >= 8] += 2.0 * rows * m
        return tuple(split)

    def occupancy(kind, convs, is_top=False):
        table = ft._pack(kind, x, plan, convs)[1]
        return lambda: kernels.train_occupancy(kind, x, table, is_top)

    def rerun_equal(name, fn, got):
        again = fn()
        got, again = (got, again) if isinstance(got, tuple) else ((got,), (again,))
        require(all(a is b or torch.equal(a, b) for a, b in zip(again, got)),
                f"{tag} {name}: not bit-equal")

    for j in range(n):
        w, b, g, be = flat[4 * j:4 * j + 4]
        pre = list(folded)
        kf = lambda pre=pre, w=w, b=b: ft.stats_pass(x, plan, pre, w, b, gp)
        st_k, st_p = kf(), ft.stats_pass.plain(x, plan, pre, w, b, gp)
        rerun_equal(f"K7 {j}", kf, st_k)
        e = compare_stats(f"{tag} K7 conv {j}", st_k, st_p, count)
        errs["train_stats"] = max(errs["train_stats"], e)
        mean, var, a, c, isig = ft._finalize_stats(st_p, count, g, be, eps)
        folded.append((w, b, a, c))
        means.append(mean)
        isigs.append(isig)
        calls["train_stats"].append(timed_call(
            kf, lambda pre=pre, w=w, b=b: ft.stats_pass.plain(x, plan, pre, w, b, gp),
            recompute_flops(j + 1), nbytes(x) + wbytes + nblk * 2 * w.shape[1] * 4,
            functools.partial(compare_stats, count=count), f"{tower} conv {j}",
            occupancy("train_stats", pre + [(w, b)])))
    kf = lambda **kw: ft.final_pass(x, plan, folded, **kw)
    pk, pp = kf(), ft.final_pass.plain(x, plan, folded)
    rerun_equal("K8", kf, pk)
    check = lambda name, got, want: compare(name, got, want, 0.0, 1e-4)[0]
    errs["train_final"] = check(f"{tag} K8 pooled", pk, pp)
    calls["train_final"].append(timed_call(kf, lambda: ft.final_pass.plain(x, plan, folded),
                                           recompute_flops(n), nbytes(x, pk) + wbytes, check,
                                           tower, occupancy("train_final", folded)))
    g = torch.Generator().manual_seed(SEED + 1)
    dpool = torch.randn(pk.shape, generator=g).to(x.device)
    kf = lambda: ft.bwd_top_pass(x, plan, folded, means[-1], isigs[-1], dpool)
    bk = kf()
    bp = ft.bwd_top_pass.plain(x, plan, folded, means[-1], isigs[-1], dpool)
    rerun_equal("K9", kf, bk)
    check = lambda name, got, want: compare(name, got, want, 5e-3,
                                            5e-4 * want.abs().max().item())[0]
    errs["train_bwd_top"] = check(f"{tag} K9 sums", bk, bp)
    calls["train_bwd_top"].append(timed_call(
        kf, lambda: ft.bwd_top_pass.plain(x, plan, folded, means[-1], isigs[-1], dpool),
        recompute_flops(n), nbytes(x, dpool, bk) + wbytes + nblk * bk.numel() * 4, check,
        tower, occupancy("train_bwd_top", folded)))
    src, bst = dpool, bp
    cot_rtol = 2.0 ** -7 if cot == torch.bfloat16 else 5e-3     # one bf16 step either way
    for j in range(n - 1, -1, -1):
        args = (x, plan, folded[:j + 1], means[j], isigs[j], src, bst[0] / count,
                bst[1] / count, flat[4 * j + 2] * isigs[j], means[j - 1] if j else None,
                isigs[j - 1] if j else None, gp, cot)
        kf = lambda args=args, **kw: ft.bwd_pass(*args, **kw)
        got, want = kf(), ft.bwd_pass.plain(*args)
        rerun_equal(f"K10 {j}", kf, got)
        check = functools.partial(compare_bwd, j=j, cot_rtol=cot_rtol)
        errs["train_bwd"] = max(errs["train_bwd"], check(f"{tag} K10 conv {j}", got, want))
        # the recompute and K10's own products, dW and dy W^T (dx), on the tensor cores
        rec = recompute_flops(j + 1)
        own = 2.0 * rows * (macs[j] + (macs[j] if j > 0 else 3 * io[0][1]))
        moved = nbytes(x, src, got[2]) + wbytes + nblk * (got[0].numel() + got[1].numel()) * 4
        calls["train_bwd"].append(timed_call(
            kf, lambda args=args: ft.bwd_pass.plain(*args), (rec[0], rec[1] + own), moved, check,
            f"{tower} conv {j}", occupancy("train_bwd", folded[:j + 1], j == n - 1)))
        src, bst = want[2], want[3]
    return errs, calls


def check_pool_cases(tower, x, plan, flat, eps):
    """Phase 9's tie- and pad-heavy inputs for the passes that read the top
    conv's slot max-pool: K8, K9 and K10's top call against their plain
    versions (f32 cotangents), each twice for bit-equality, on x with every
    slot of every cluster made equal to its slot 0 (each channel ties ns
    ways), on its first POOL_PAD_SLOTS slots (pad slots past ns), and, where
    the top conv has a ReLU, with RELU_ZERO_CHANNELS of its channels shifted
    so that every pre-ReLU value is negative (a ReLU-zero tie). The folded
    affines come from the plain statistics of each input. K10 is held on
    the clusters whose elementwise output agrees; the others, rounding flips
    at a pool near-tie, may be at most FLIP_CLUSTER_SHARE of them. Returns
    {kernel: max |d|}."""
    import torch

    from feat3dnet_tpu_torch.ops import fused_train as ft

    n = len(flat) // 4
    cases = {"all slots tied": x[0:1].expand_as(x).contiguous(),
             "pad slots": x[:POOL_PAD_SLOTS].contiguous()}
    if ft._relu_of(plan, n - 1):
        cases["ReLU-zero channels"] = x
    errs = {k: 0.0 for k in TRAIN_KERNELS[1:]}
    for case, xc in cases.items():
        ns, gp, _ = xc.shape
        count = float(ns * gp)
        folded, means, isigs = [], [], []
        for j in range(n):
            w, b, g, be = flat[4 * j:4 * j + 4]
            st = ft.stats_pass.plain(xc, plan, folded, w, b, gp)
            mean, _, a, c, isig = ft._finalize_stats(st, count, g, be, eps)
            if case == "ReLU-zero channels" and j == n - 1:
                c = c.clone()
                c[:RELU_ZERO_CHANNELS] -= 1e3
            folded.append((w, b, a, c))
            means.append(mean)
            isigs.append(isig)
        tag = f"{tower} {case}"
        runs = {"train_final": lambda: ft.final_pass(xc, plan, folded)}
        pk = runs["train_final"]()
        errs["train_final"] = max(errs["train_final"], compare(
            f"{tag} K8 pooled", pk, ft.final_pass.plain(xc, plan, folded), 0.0, 1e-4)[0])
        dpool = torch.randn(pk.shape, generator=torch.Generator().manual_seed(SEED + 2))
        dpool = dpool.to(xc.device)
        top = (xc, plan, folded, means[-1], isigs[-1], dpool)
        runs["train_bwd_top"] = lambda: ft.bwd_top_pass(*top)
        bk, bp = runs["train_bwd_top"](), ft.bwd_top_pass.plain(*top)
        errs["train_bwd_top"] = max(errs["train_bwd_top"], compare(
            f"{tag} K9 sums", bk, bp, 5e-3, 5e-4 * bp.abs().max().item())[0])
        rest = (bp[0] / count, bp[1] / count, flat[4 * n - 2] * isigs[-1],
                means[-2] if n > 1 else None, isigs[-2] if n > 1 else None)
        args = (*top, *rest, gp, torch.float32)
        runs["train_bwd"] = lambda: ft.bwd_pass(*args)
        # clusters whose elementwise output (do_prev or dx) differs past phase
        # 9's tolerance: rounding flips at a pool near-tie or a ReLU input ~ 0
        got, want = runs["train_bwd"]()[2], ft.bwd_pass.plain(*args)[2]
        flip = ((got - want).abs() > 5e-5 + 5e-3 * want.abs()).any(2).any(0)
        flips = int(flip.sum().item())
        require(flips <= FLIP_CLUSTER_SHARE * gp,
                f"{tag} K10 conv {n - 1}: {flips} of {gp} clusters differ")
        keep = (~flip).nonzero().squeeze(1)
        kept = (xc[:, keep].contiguous(), *top[1:5], dpool[keep].contiguous(), *rest,
                keep.numel(), torch.float32)
        errs["train_bwd"] = max(errs["train_bwd"], compare_bwd(
            f"{tag} K10 conv {n - 1}", ft.bwd_pass(*kept), ft.bwd_pass.plain(*kept), n - 1,
            5e-3))
        for k, fn in runs.items():
            got, again = fn(), fn()
            got, again = (got, again) if isinstance(got, tuple) else ((got,), (again,))
            require(all(a is b or torch.equal(a, b) for a, b in zip(got, again)),
                    f"{tag} {k}: not bit-equal")
        print(f"  {tag} (ns {ns}): K8, K9 and K10's top call within phase 9's tolerances "
              f"(K10 on {keep.numel()} of {gp} clusters, {flips} flipped left out), bit-equal on repeat")
    return errs


def model_grads(model, clouds, margin):
    """Loss, grads per parameter and the BN buffers after one training forward."""
    import torch

    from feat3dnet_tpu_torch.train.loss import alignment_triplet_loss

    model.zero_grad(set_to_none=True)
    out = model(clouds, training=True)
    fa, fp, fn = torch.chunk(out.features, 3)
    loss, _ = alignment_triplet_loss(fa, fp, fn, torch.chunk(out.attention, 3)[0], margin)
    loss.backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().clone()
             for k, p in model.named_parameters()}
    return loss.item(), grads, {k: b.detach().cpu().clone() for k, b in model.named_buffers()}


def f64_grads(model, clouds, margin):
    """Float64 reference grads of the model's loss: the grouping in f32 as
    the model makes it (K1, K2), the towers, BN and the loss in float64."""
    import copy

    import torch

    from feat3dnet_tpu_torch.models.feat3dnet import _group_normalized, _rotate_z
    from feat3dnet_tpu_torch.ops import farthest_point_sample, gather_points
    from feat3dnet_tpu_torch.train.loss import alignment_triplet_loss

    cfg = model.cfg
    m = copy.deepcopy(model).double()
    xyz = clouds[..., :3].contiguous()
    ctr = gather_points(xyz, farthest_point_sample(xyz, cfg.num_clusters)).contiguous()
    grouped, _, _ = _group_normalized(xyz, ctr, cfg.base_scale, cfg.num_samples, None)
    att, ori = m.detection(grouped.double(), True)
    feat = m.description(_rotate_z(grouped.double(), ori), True)
    fa, fp, fn = torch.chunk(feat, 3)
    alignment_triplet_loss(fa, fp, fn, torch.chunk(att, 3)[0], margin)[0].backward()
    return {k: p.grad.float().cpu() for k, p in m.named_parameters()}


def noise_leaves(grads):
    """Leaves whose grad is analytically zero (a shift the next BN removes):
    rounding noise on both sides."""
    top = max(g.abs().max().item() for g in grads.values())
    return {k for k, g in grads.items() if g.abs().max().item() <= 1e-4 * top}


def train_kernel_phase(dev):
    """Phase 9: K7-K10 against their plain versions at the training shapes.
    Returns ({kernel: report}, {kernel: [(kernel_fn, plain_fn, bound)]} of
    the f32-cotangent calls, for the times)."""
    import torch

    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.utils import init_variables, load_variables

    cfg = ModelConfig()
    report = {k: {"max_abs_err": 0.0} for k in TRAIN_KERNELS}
    xyz = training_batch(dev, SEED)
    t0 = time.perf_counter()
    model = load_variables(Feat3DNet(cfg), init_variables(cfg, seed=SEED, bn_perturb=0.1)).to(dev)
    towers = tower_params(model, cfg)
    timed = {k: [] for k in TRAIN_KERNELS}
    with torch.no_grad():
        xs = dict(zip(("detector", "descriptor"), tower_inputs(cfg, xyz)))
        for (tower, (plan, flat)), cot in itertools.product(towers.items(),
                                                             (torch.float32, torch.bfloat16)):
            errs, calls = check_train_passes(f"{tower}/{str(cot)[6:]}", xs[tower], plan, flat,
                                             cot, cfg.bn_epsilon)
            for k, e in errs.items():
                report[k]["max_abs_err"] = max(report[k]["max_abs_err"], e)
            if cot == torch.float32:
                for k, c in calls.items():
                    timed[k] += c
                errs = check_pool_cases(tower, xs[tower], plan, flat, cfg.bn_epsilon)
                for k, e in errs.items():
                    report[k]["max_abs_err"] = max(report[k]["max_abs_err"], e)
            torch.cuda.empty_cache()
    errs = ", ".join(f"{k} {v['max_abs_err']:.3e}" for k, v in report.items())
    print(f"K7-K10 at (ns, G) = {tuple(xs['detector'].shape[:2])}, both plans, f32 and bf16 "
          f"cotangents, {TIE_CLUSTERS} all-ties clusters, and the tie- and pad-heavy cases: "
          f"within tolerance, bit-equal on repeat; max |d|: {errs} "
          f"({time.perf_counter() - t0:.1f} s)")
    return report, timed


def train_kernel_times(timed, report, card):
    """Phase 12's kernel part: the training kernels' ptxas and SASS lines,
    K7-K10 per call against their plain versions (in turns), each beside
    its bound, then K10's time split."""
    import torch

    from feat3dnet_tpu_torch import kernels

    train_build_report("this", kernels.build())

    with torch.no_grad():
        for k, cl in timed.items():
            per = [(*in_turns(kf, pf, 3, 2), b) for kf, pf, b in cl]
            report[k]["ms"] = float(np.mean([q[0] for q in per]))
            report[k]["plain_ms"] = float(np.mean([q[1] for q in per]))
            report[k]["bound_ms"], report[k]["bound_by"] = mean_bound([q[2] for q in per])
            print(f"[{card}] {k}: {len(per)} calls (both towers), kernel "
                  f"{[round(q[0], 4) for q in per]} ms, plain {[round(q[1], 4) for q in per]} ms, "
                  f"bound {[round(q[2][0], 4) for q in per]} ms (TF32; at the f32 CUDA-core "
                  f"peak {[round(kf.f32_bound, 4) for kf, _, _ in cl]} ms, mean "
                  f"{np.mean([kf.f32_bound for kf, _, _ in cl]):.4f})")
        for i, (kf, _, _) in enumerate(timed["train_final"]):
            print_split(card, f"train_final call {i} ({kf.label})", train_final_time_split(kf))
        for i, (kf, _, _) in enumerate(timed["train_bwd"]):
            print_split(card, f"train_bwd call {i}", train_bwd_time_split(kf))
        occupancy_report("this", timed)


def stage_split(kernel_fn, stops, reps=3):
    """A training kernel's time split by stage: ms per call of the kernel
    that leaves each cluster after each stage in `stops` (in order) and of
    the whole kernel ("full"), timed by ms_in_turns, with each stage's
    share of the whole (the last share, "full_share", is the rest)."""
    ms = ms_in_turns({k or "full": (lambda k=k: kernel_fn(stop=k)) for k in stops + (None,)},
                     reps)
    prev = 0.0
    for k in list(ms):
        ms[f"{k}_share"] = (ms[k] - prev) / ms["full"]
        prev = ms[k]
    return ms


def train_bwd_time_split(kernel_fn, reps=3):
    """K10's time split, as serving_time_split splits K3: the kernel that
    leaves each cluster after the recompute, the dy step, dW and dy W^T, and
    the whole kernel; the rest is the cotangent's pool routing, rounding and
    the next conv's sums."""
    return stage_split(kernel_fn, ("recompute", "dy", "dw", "dcat"), reps)


def train_final_time_split(kernel_fn, reps=3):
    """K8's time split, modelled on train_bwd_time_split: the kernel that
    leaves each cluster after the recompute (every conv, the top one's
    product included, and in this tree the pool's reduction into its
    per-tile partials) against the whole kernel; the rest is the pool
    epilogue and the pooled write."""
    return stage_split(kernel_fn, ("recompute",), reps)


def print_split(card, what, sp):
    print(f"[{card}] {what} split: " + ", ".join(
        f"{k} {v:.4f}" + ("" if k.endswith("share") else " ms") for k, v in sp.items()))


def parent_csrc(parent):
    """The csrc/ of `--parent` (a checkout or its csrc/), which must hold
    PARENT_BUILD's files."""
    csrc = os.path.join(parent, "feat3dnet_tpu_torch", "csrc")
    csrc = os.path.abspath(csrc if os.path.isdir(csrc) else parent)
    missing = [f for f in sum(PARENT_BUILD, ()) if not os.path.isfile(os.path.join(csrc, f))]
    require(not missing, f"--parent: {csrc} has no {', '.join(missing)}")
    return csrc


def parent_build(csrc):
    """Another tree's PARENT_BUILD sources built alone, with the headers it
    has."""
    from feat3dnet_tpu_torch import kernels

    sources, headers = PARENT_BUILD
    headers += tuple(h for h in PARENT_OPTIONAL_HEADERS if os.path.isfile(os.path.join(csrc, h)))
    return kernels.build(csrc, sources, headers)


@functools.lru_cache(maxsize=None)
def parent_cdll(csrc):
    """Another tree's PARENT_BUILD sources, built alone and loaded."""
    import ctypes

    return ctypes.CDLL(parent_build(csrc).path)


@functools.lru_cache(maxsize=None)
def other_library(csrc):
    """This tree's entry points, but the training passes' (f3d_train_*),
    K6's (f3d_fused_detect*) and K3's (f3d_fused_describe*) from another
    tree's csrc/, built alone; one the other tree lacks is left undefined.
    The training passes are declared as this tree's are. K6's and K3's are
    called with this tree's arguments and the weights that tree packs itself
    (detect_pack, describe_pack): a tree whose K6 or K3 takes no offsets of
    tensor-core fragments (their FFMA designs) gets the same call without
    them."""
    import ctypes
    import types

    from feat3dnet_tpu_torch import kernels

    mine = kernels.library()
    theirs = parent_cdll(csrc)
    lib = types.SimpleNamespace(**{n: getattr(mine, n) for n in dir(mine) if n.startswith("f3d_")})
    for name in [n for n in vars(lib) if n.startswith("f3d_train_")]:
        if hasattr(theirs, name):
            fn, ref = getattr(theirs, name), getattr(mine, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            setattr(lib, name, fn)
        else:
            delattr(lib, name)
    for src, prefix in (("fused_detect.cu", "f3d_fused_detect"),
                        ("fused_describe.cu", "f3d_fused_describe")):
        with open(os.path.join(csrc, src)) as f:
            ffma = "const int* extra" not in f.read()
        for name in [n for n in vars(lib) if n.startswith(prefix)]:
            if not hasattr(theirs, name):
                delattr(lib, name)
                continue
            fn, ref = getattr(theirs, name), getattr(mine, name)
            fn.restype = ctypes.c_int
            if not ffma or name.endswith("_occupancy"):
                fn.argtypes = ref.argtypes
                setattr(lib, name, fn)
            else:
                # packed or clusters, ns, batch, weights, layers | extra | n_det ...
                fn.argtypes = ref.argtypes[:5] + ref.argtypes[6:]
                setattr(lib, name, lambda *a, fn=fn: fn(*a[:5], *a[6:]))
    return lib


@contextlib.contextmanager
def kernels_from(csrc):
    """Every launch inside goes through other_library(csrc)."""
    from feat3dnet_tpu_torch import kernels

    saved = kernels.library
    lib = other_library(os.path.abspath(csrc))
    kernels.library = lambda: lib
    try:
        yield
    finally:
        kernels.library = saved


def ptxas_lines(tag, info, marker):
    """A build's lines of its ptxas report (entry, registers, spills) for
    the kernels whose entry name holds `marker`."""
    entry = ""
    for line in info.ptxas.splitlines():
        if "Compiling entry" in line:
            entry = line
        if marker in entry and ("Compiling entry" in line or "Used" in line
                                or "spill" in line):
            print(f"  ptxas ({tag}): {line.strip()}")


@functools.lru_cache(maxsize=None)
def _sass(lib_path):
    """`cuobjdump -sass` of a built library."""
    from feat3dnet_tpu_torch import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout


def sass_bodies(info, pattern):
    """{kernel: its SASS instructions} of a build's library for the kernels
    whose mangled name `pattern` (a regex) matches, without addresses,
    encodings, (per-file hashed) symbol names or the NOPs that pad a
    function to its alignment, so two builds of the same code compare
    equal."""
    import re

    bodies, name = {}, None
    for line in _sass(info.path).splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            name = m.group(0) if m else None
            if name:
                bodies[name] = []
        elif line.startswith("Fatbin"):   # the next section's header, not code
            name = None
        elif name:
            ins = re.sub(r"/\*[^*]*\*/", "", line)
            ins = re.sub(r"\S*_GLOBAL__N__\S*", "SYM", ins).strip()
            if ins and not ins.startswith(".") and ins != "NOP ;":
                bodies[name].append(ins)
    return bodies


def sass_counts(info, pattern, ops):
    """{kernel: {op: count}} for sass_bodies' kernels: each op counted on
    the instructions that hold it."""
    return {name: {op: sum(op in ins for ins in body) for op in ops}
            for name, body in sass_bodies(info, pattern).items()}


def train_build_report(tag, info):
    """A build's lines of its ptxas report for the training kernels
    (registers, spills) and, from `cuobjdump -sass` of its library, each
    training kernel's count of tensor-core (HMMA) and f32 CUDA-core (FFMA)
    instructions."""
    ptxas_lines(tag, info, "train_")
    for name, c in sass_counts(info, r"train_(?:stats|final|bwd_top|bwd)_kernel(?:ILi\d)?",
                               ("HMMA", "FFMA")).items():
        print(f"  sass ({tag}): {name}: {c['HMMA']} HMMA, {c['FFMA']} FFMA")


TOWER_SASS_OPS = ("HMMA", "FFMA", "LDS", "LDG", "LDL", "STL")
# K1, K4 and K5: shared, global, generic (a peer's shared memory) and local
# memory, shuffles, block and cluster barriers, min / max
WALK_SASS_OPS = ("LDG", "LDS", "STS", "LD.", "LDL", "STL", "SHFL", "VOTE", "BAR", "CGABAR",
                 "FMNMX", "FFMA")
# the kernels whose ptxas lines and SASS counts the build reports print
WALK_MARKERS = ("fps", "sorted_ball_query", "ball_max", K2_MARKER)


def tower_build_report(tag, info, marker, ops=TOWER_SASS_OPS):
    """The lines of a build's ptxas report and its SASS counts for the
    kernels whose name holds `marker` (K3: "describe", K6: "fused_detect"):
    by default tensor-core (HMMA), f32 CUDA-core (FFMA), shared (LDS),
    global (LDG) and local (LDL, STL) memory instructions, per
    instantiation."""
    ptxas_lines(tag, info, marker)
    for name, c in sass_counts(info, rf"\w*{marker}\w*", ops).items():
        print(f"  sass ({tag}): {name}: " + ", ".join(f"{c[op]} {op}" for op in ops))


def sass_equal(tag, this_info, other_info, marker):
    """Print whether the kernels whose name holds `marker` (a regex)
    compile to the same SASS in both builds (sass_bodies, paired in the
    order of their names, which cuobjdump does not keep), and the first
    differing instructions where they do not."""
    a, b = ([body for _, body in sorted(sass_bodies(i, rf"\w*{marker}\w*").items())]
            for i in (this_info, other_info))
    same = a == b
    print(f"{marker}: SASS equal to the {tag}'s, instruction for instruction: {same} "
          f"({sum(map(len, a))} instructions; the {tag} {sum(map(len, b))})")
    if not same:
        for x, y in zip(a, b):
            diff = [(i, s, t) for i, (s, t) in enumerate(zip(x, y)) if s != t]
            print(f"  {len(diff)} of {len(x)} instructions differ (the {tag} {len(y)})")
            for i, s, t in diff[:4]:
                print(f"  #{i}: this {s!r}, {tag} {t!r}")


def occupancy_report(tag, timed):
    """Each training kernel's launches: dynamic shared memory and the blocks
    that fit on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), per
    call, in the library in use."""
    for k, cl in timed.items():
        print(f"  occupancy ({tag}): {k}: " + "; ".join(
            "{} {} B, {} blocks/SM".format(kf.label, *kf.occupancy()) for kf, _, _ in cl))


def parent_ab(parent, timed, card, fused_step_ms):
    """The training kernels of another tree (`--parent`: a checkout or its
    csrc/, of which only fused_train.cu and common.cuh are built) against
    this one's on phase 9's f32-cotangent inputs: both trees' ptxas lines
    for fused_train.cu (and occupancy, where the parent reports it), then
    each call of K7-K10 against the parent's, K8 and K9 bit for bit
    (EXACT_TO_PARENT), K7 and K10 at phase 9's tolerances, timed in turns
    (parent, this, this, parent); then, where the parent has K8's split
    build, K8's split of both trees in turns; then the fused training step
    (`fused_step_ms()`: median ms, peak GiB) with either tree's kernels, in
    turns."""
    import torch

    from feat3dnet_tpu_torch import kernels

    csrc = parent_csrc(parent)
    train_build_report("parent", parent_build(csrc))
    lib = other_library(csrc)
    if hasattr(lib, "f3d_train_occupancy"):
        with kernels_from(csrc):
            occupancy_report("parent", timed)

    def parent_fn(kf, **kw):
        with kernels_from(csrc):
            return kf(**kw)

    with torch.no_grad():
        for k, cl in timed.items():
            total = np.zeros(2)
            for i, (kf, _, _) in enumerate(cl):
                pf = functools.partial(parent_fn, kf)
                if k in EXACT_TO_PARENT:
                    compare(f"{k} call {i} vs parent", kf(), pf(), 0.0, 0.0)
                    held = "exact: max |d| 0"
                else:
                    e = kf.check(f"{k} call {i} vs parent", kf(), pf())
                    held = f"within phase 9's tolerances of the parent (max |d| {e:.3e})"
                ms, ms_parent = in_turns(kf, pf, 3, 3)
                total += (ms_parent, ms)
                print(f"[{card}] {k} call {i} ({kf.label}): parent {ms_parent:.4f} ms, this "
                      f"{ms:.4f} ms; {held}")
            print(f"[{card}] {k} over its {len(cl)} calls: parent {total[0]:.4f} ms, "
                  f"this {total[1]:.4f} ms")
        if hasattr(lib, "f3d_train_final_split"):
            for i, (kf, _, _) in enumerate(timed["train_final"]):
                sp = ms_in_turns({
                    "parent recompute": functools.partial(parent_fn, kf, stop="recompute"),
                    "parent full": functools.partial(parent_fn, kf),
                    "this recompute": lambda kf=kf: kf(stop="recompute"),
                    "this full": kf}, 3)
                print_split(card, f"train_final call {i} ({kf.label}), parent and this in turns",
                            sp)
    steps = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        with kernels_from(csrc) if who == "parent" else contextlib.nullcontext():
            steps[who].append(fused_step_ms())
    print(f"[{card}] fused train step, parent and this in turns: " + "; ".join(
        f"{who} median {np.mean([v[0] for v in vals]):.2f} ms (runs "
        f"{[round(v[0], 2) for v in vals]}), peak {max(v[1] for v in vals):.2f} GiB"
        for who, vals in steps.items()))


def training_phases(dev, card, parent=None):
    """Phases 9-12: K7-K10 against their plain versions at the training
    shapes, the training path through cli.train with counters reset, checks
    on the step, and times (and `parent_ab` when a parent tree is given).
    Returns ({kernel: report} for K7-K10, the training path's launches)."""
    import statistics

    import torch

    from feat3dnet_tpu_torch.cli import train as train_cli
    from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
    from feat3dnet_tpu_torch.data.augment import resolve_augmentations
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import batch_group, fps
    from feat3dnet_tpu_torch.ops import fused_train as ft
    from feat3dnet_tpu_torch.train import init_state, make_fused_train_step, make_train_step
    from feat3dnet_tpu_torch.utils import init_variables, load_variables

    cfg = ModelConfig()
    tcfg = TrainConfig()

    # ---- 9. K7-K10 against their plain versions at the training shapes -------
    report, timed = train_kernel_phase(dev)

    # ---- 10. the training path, counters from zero -----------------------------
    root = os.path.join(HERE, "build", "chip_smoke_train")
    write_train_dataset(root)
    wrappers = {"fps": fps.farthest_point_sample, "ball_query": batch_group.ball_query_fused,
                "train_stats": ft.stats_pass, "train_final": ft.final_pass,
                "train_bwd_top": ft.bwd_top_pass, "train_bwd": ft.bwd_pass}
    for w in wrappers.values():
        w.launches = 0
    log_dir = os.path.join(root, "log")
    args = ["--data_dir", root, "--log_dir", log_dir, "--fused_towers", "--device", "cuda",
            "--num_points", str(TRAIN_POINTS), "--batch_size", str(TRAIN_CLOUDS // 3),
            "--summary_every_n_steps", "1", "--checkpoint_every_n_steps", "10",
            "--validate_every_n_steps", str(VAL_EVERY)]
    per_epoch = 12 // (TRAIN_CLOUDS // 3)
    first, total = TRAIN_EPOCHS * per_epoch, (TRAIN_EPOCHS + RESUME_EPOCHS) * per_epoch
    fp_logged = []
    handler = logging.Handler()
    handler.emit = lambda record: fp_logged.append(record.getMessage())
    train_logger = logging.getLogger("feat3dnet_tpu_torch.train")
    train_logger.addHandler(handler)
    try:
        t0 = time.perf_counter()
        state = train_cli.main(args + ["--num_epochs", str(TRAIN_EPOCHS)])
        first_s = time.perf_counter() - t0
        require(state.step == first, f"cli.train took {state.step} steps, not {first}")
        state = train_cli.main(args + ["--num_epochs", str(RESUME_EPOCHS), "--auto_resume"])
    finally:
        train_logger.removeHandler(handler)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"training path launches: {launches}")
    for k, n_launch in launches.items():
        require(n_launch > 0, f"kernel {k} was not launched on the training path")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    rows = [r for r in logged if "loss" in r]
    require([r["step"] for r in rows] == list(range(1, total + 1)) and state.step == total,
            f"training steps logged {[r['step'] for r in rows]}, resumed run at {state.step}")
    require(all(np.isfinite(r["loss"]) for r in rows), "non-finite loss on the training path")
    print(f"cli.train --fused_towers: {first} steps ({first_s:.1f} s with set-up), then "
          f"--auto_resume from step {first} to {total}; losses "
          f"{[round(r['loss'], 4) for r in rows]}")
    # validation: after the first step and every VAL_EVERY steps of the first run
    fp_rows = [(r["step"], r["fp_rate"]) for r in logged if "fp_rate" in r]
    fp_msgs = [m for m in fp_logged if "FP Rate" in m]
    want = [1] + list(range(VAL_EVERY, first + 1, VAL_EVERY))
    require([st for st, _ in fp_rows] == want and len(fp_msgs) == len(want)
            and all(0.0 <= fp <= 1.0 for _, fp in fp_rows),
            f"cli.train validation: logged {fp_msgs}, metrics rows {fp_rows}")
    print(f"cli.train validation ({VAL_PAIRS} cluster pairs, batch {VAL_BATCH} x "
          f"{VAL_POINTS} points, K2 at M 1): {fp_msgs}")

    # ---- 11. checks on the step ---------------------------------------------------
    # At these shapes the f32 grads of every route carry discrete choices (the
    # loss's argmin, pool argmaxes, ReLU masks) that flip under f32 rounding,
    # so each route is measured against float64 grads of the same init and
    # batch (K1/K2 groupings shared): per leaf the relative L2 error and the
    # cosine. Leaves whose grad is analytically zero (conv biases under BN)
    # are rounding noise everywhere and are held to |g| <= 1e-3.
    variables = init_variables(cfg, seed=SEED)
    clouds = training_batch(dev, SEED + 100)
    ref = load_variables(Feat3DNet(cfg), variables).to(dev)
    l_ref, g_ref, b_ref = model_grads(ref, clouds, cfg.margin)
    g64 = f64_grads(ref, clouds, cfg.margin)
    noise = noise_leaves(g64)
    routes = {"autograd f32": g_ref}
    for cot in (torch.float32, torch.bfloat16):
        fused = load_variables(Feat3DNet(ModelConfig(fused_towers=True, fused_cot_dtype=cot)),
                               variables).to(dev)
        l_f, g_f, b_f = model_grads(fused, clouds, cfg.margin)
        require(abs(l_f - l_ref) <= 1e-5 * abs(l_ref), f"fused loss {l_f} vs autograd {l_ref}")
        for k, w in b_ref.items():
            compare(f"batch_stats {k}", b_f[k], w, 1e-4, 1e-6)
        routes[f"fused {str(cot)[6:]}"] = g_f
        del fused
    # (b) the card against the CPU: one step each, the autograd route on both,
    # and the card's fused route (f32 cotangents) beside them
    steps = []
    for d, fused in ((dev, False), (dev, True), (torch.device("cpu"), False)):
        m = Feat3DNet(ModelConfig(fused_towers=fused, fused_cot_dtype=torch.float32))
        st = init_state(m, tcfg, cfg, variables=variables, device=d)
        a, p, n = torch.chunk(clouds.to(d), 3)
        _, met = make_train_step(m, cfg.margin, cfg.attention)(st, a, p, n)
        steps.append((met["loss"].item(),
                      {k: q.grad.detach().cpu() for k, q in m.named_parameters()},
                      {k: q.detach().cpu() for k, q in m.named_parameters()}))
    (lc, gc, pc), (_, _, pf), (lh, gh, ph) = steps
    del st, steps
    routes["CPU autograd f32"] = gh

    def leaf_stats(g):
        out = {}
        for k, w in g64.items():
            if k not in noise:
                d = (g[k] - w).norm().item() / max(w.norm().item(), 1e-30)
                c = torch.nn.functional.cosine_similarity(g[k].flatten(), w.flatten(), dim=0)
                out[k] = (d, c.item())
        return out

    # which GEMMs the card's autograd step runs, under the precision flags set
    flags = {n: getattr(torch.backends.cuda.matmul, n, None)
             for n in ("allow_tf32", "fp32_precision")}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        model_grads(ref, clouds, cfg.margin)
    gemms = sorted({e.key[:70] for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and ("gemm" in e.key.lower() or "xmma" in e.key.lower())})
    print(f"(a/b) card autograd step: matmul flags {flags}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}; GEMM kernels: {gemms}")
    stats = {r: leaf_stats(g) for r, g in routes.items()}
    checks = []                       # (ok, what): all printed, then required
    for r, st_r in stats.items():
        worst = sorted(st_r, key=lambda k: st_r[k][0], reverse=True)[:4]
        noise_max = max(routes[r][k].abs().max().item() for k in noise)
        print(f"(a/b) {r} vs float64: worst rel L2 " + ", ".join(
            f"{k} {st_r[k][0]:.2e} (cos {st_r[k][1]:.6f})" for k in worst)
            + f"; median rel L2 {statistics.median(v[0] for v in st_r.values()):.2e}; "
            f"noise leaves max |g| {noise_max:.2e} ({len(noise)} leaves)")
        checks.append((noise_max <= 1e-3, f"{r}: a conv-bias grad under BN is {noise_max}"))
        k = min(st_r, key=lambda q: st_r[q][1])
        floor = 0.999 if r in ("fused float32", "CPU autograd f32") else 0.99
        checks.append((st_r[k][1] >= floor, f"{r}: cosine {st_r[k][1]:.6f} to float64 on {k} "
                                            f"(>= {floor})"))
    worst_f = max(v[0] for v in stats["fused float32"].values())
    worst_a = max(v[0] for v in stats["autograd f32"].values())
    checks.append((worst_f <= 1.5 * worst_a + 1e-3,
                   f"fused route rel L2 to float64 {worst_f:.3e} vs autograd {worst_a:.3e}"))
    for r in ("fused float32", "fused bfloat16", "CPU autograd f32"):
        cos = {k: torch.nn.functional.cosine_similarity(routes[r][k].flatten(),
                                                        g_ref[k].flatten(), dim=0).item()
               for k in g64 if k not in noise}
        worst = min(cos, key=cos.get)
        print(f"(a/b) {r} vs the card's autograd route: worst cosine {cos[worst]:.6f} on {worst}")
        checks.append((cos[worst] >= 0.99, f"{r} vs autograd: cosine {cos[worst]:.6f} on "
                                           f"{worst} (>= 0.99)"))
    print(f"(a) fused vs autograd route: loss {l_f:.7f} vs {l_ref:.7f}, batch_stats within rtol "
          f"1e-4; f32 cotangents: worst leaf rel L2 to float64 {worst_f:.2e} (autograd "
          f"{worst_a:.2e})")
    checks.append((abs(lc - lh) <= 1e-5 * abs(lh), f"card loss {lc} vs CPU {lh}"))
    # Adam's first update is about lr * sign(g): where a grad is analytically
    # zero (element by element: |g64| <= 1e-4 of the largest, e.g. the beta of
    # a channel that every cluster's pool keeps positive, whose uniform shift
    # the next BN removes) its sign, and the update, can differ by 2 lr. The
    # card's autograd route is 10x further from float64 than the CPU's and
    # the kernels' (printed above), so it is held to 99 % instead of 99.9 %.
    lr = tcfg.learning_rate
    thr = 1e-4 * max(g.abs().max().item() for g in g64.values())
    for route, params, need in (("fused f32", pf, 0.999), ("autograd", pc, 0.99)):
        shares, within, total, dmax = {}, 0.0, 0, 0.0
        for k, w in ph.items():
            d = (params[k] - w).abs()
            dmax = max(dmax, d.max().item())
            real = g64[k].abs() > thr
            if real.any():
                shares[k] = (d[real] <= 1e-2 * lr).float().mean().item()
                within += shares[k] * real.sum().item()
                total += real.sum().item()
        low = min(shares, key=shares.get)
        print(f"(b) card ({route} step) vs CPU (autograd step): params after Adam "
              f"{100 * within / total:.4f} % of the {total} with a grad above the noise "
              f"within 1e-2 lr (lowest leaf {low} "
              f"{100 * shares[low]:.3f} %), every one within {dmax / lr:.4f} lr")
        checks.append((within / total >= need, f"{route}: params after Adam "
                                               f"{100 * within / total:.4f} % within 1e-2 lr "
                                               f"(>= {100 * need:g} %)"))
        checks.append((dmax <= 2 * lr + 1e-7, f"{route}: a param after Adam differs by "
                                               f"{dmax / lr:.4f} lr (<= 2)"))
    print(f"(b) loss on the card {lc:.7f}, on the CPU {lh:.7f}")
    bad = [what for ok, what in checks if not ok]
    for what in bad:
        print(f"(a/b) FAILED: {what}")
    require(not bad, "; ".join(bad))
    # (c) the loss falls: 30 steps with the kernels on one batch, lr 1e-3, margin 1.0
    m = Feat3DNet(ModelConfig(fused_towers=True))
    s3 = init_state(m, TrainConfig(learning_rate=1e-3), cfg, variables=variables, device=dev)
    step = make_fused_train_step(m, 1.0, True)
    losses = [step(s3, clouds)[1]["loss"].item() for _ in range(30)]
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], f"loss did not fall: {losses}")
    print(f"(c) 30 steps with the kernels on one batch: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    del s3, m

    # ---- 12. times -------------------------------------------------------------------
    aug = tuple(resolve_augmentations(tcfg.augmentations, tcfg.upright_axis))

    def step_ms(fused, profile_as=None):
        """(median ms of 12 synchronised training steps after 2, peak GiB) of
        a fresh model on the fused or the autograd route; `profile_as`: also
        profile one more step and print it under that name."""
        m = Feat3DNet(ModelConfig(fused_towers=fused))
        s4 = init_state(m, tcfg, cfg, variables=variables, device=dev)
        step = make_fused_train_step(m, cfg.margin, cfg.attention, augmentations=aug, aug_seed=1)
        for _ in range(2):
            step(s4, clouds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per = []
        for _ in range(12):
            t0 = time.perf_counter()
            step(s4, clouds)
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if profile_as:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(s4, clouds)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            ev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            ev.sort(key=lambda e: e.self_device_time_total, reverse=True)
            busy = sum(e.self_device_time_total for e in ev) / 1e3
            print(f"[{card}] profile train step ({profile_as}): wall {wall:.2f} ms, device busy "
                  f"{busy:.2f} ms ({100 * busy / wall:.1f} %)")
            for e in ev[:10]:
                print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
        del s4, m, step
        torch.cuda.empty_cache()
        return statistics.median(per), peak

    route_ms = {}
    for route, fused in (("autograd", False), ("fused", True), ("fused", True), ("autograd", False)):
        again = route in route_ms       # the second run of a route is profiled
        route_ms.setdefault(route, []).append(step_ms(fused, route if again else None))
    for route, vals in route_ms.items():
        print(f"[{card}] train step ({route} route, {TRAIN_CLOUDS} x {TRAIN_POINTS} points, "
              f"augmented): median "
              f"{np.mean([v[0] for v in vals]):.2f} ms (runs {[round(v[0], 2) for v in vals]}), "
              f"peak memory {max(v[1] for v in vals):.2f} GiB")
    train_kernel_times(timed, report, card)
    if parent:
        parent_ab(parent, timed, card, functools.partial(step_ms, True))
    return report, launches


def bf16_model_phase(dev, card):
    """Phase 17: the model with ModelConfig.compute_dtype bf16 on the card.
    The eval forward on the vendored clouds against the f32 forward with the
    JAX package's own gate (cosine > 0.98 on > 90 % of descriptors), outputs
    f32; then one training step, which takes the autograd route (the fused
    towers are f32 only, as in JAX): a finite loss, no fused-tower launch."""
    import torch

    from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import fused_train as ft
    from feat3dnet_tpu_torch.train import init_state, make_fused_train_step
    from feat3dnet_tpu_torch.utils import init_variables, load_variables

    cfg32 = ModelConfig()
    cfg16 = ModelConfig(compute_dtype=torch.bfloat16, fused_towers=True)
    variables = init_variables(cfg32, seed=SEED, bn_perturb=0.1)
    m32 = load_variables(Feat3DNet(cfg32), variables).to(dev).eval()
    m16 = load_variables(Feat3DNet(cfg16), variables).to(dev).eval()
    with torch.no_grad():
        for name in CLOUDS:
            xyz = torch_from(load_point_cloud(example_cloud_path(name))[None, :, :3], dev)
            o32, o16 = m32(xyz), m16(xyz)
            require(all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
                        for t in (o16.features, o16.attention, o16.orientation)),
                    f"bf16 model outputs on {name}: not finite float32")
            cos = (o32.features * o16.features).sum(-1)
            frac = (cos > 0.98).float().mean().item()
            att = ((o16.attention - o32.attention).abs()
                   / o32.attention.abs().clamp(min=1e-6)).median().item()
            print(f"bf16 model {name}: {100 * frac:.2f} % of descriptors at cosine > 0.98 to "
                  f"f32 (> 90 %), min cosine {cos.min().item():.5f}, attention median "
                  f"relative {att:.2e} (>= 1e-4)")
            require(frac > 0.9, f"bf16 model on {name}: {100 * frac:.2f} % at cosine > 0.98")
            # a model that ignored compute_dtype would pass the gate above:
            # bf16 rounding (2^-9 relative) must show in the attention
            require(att >= 1e-4, f"bf16 model on {name}: attention median relative gap to "
                                 f"f32 {att:.2e}, not computed in bf16")
    fused = (ft.stats_pass, ft.final_pass, ft.bwd_top_pass, ft.bwd_pass)
    for w in fused:
        w.launches = 0
    state = init_state(Feat3DNet(cfg16), TrainConfig(), cfg16, variables=variables, device=dev)
    step = make_fused_train_step(state.model, cfg16.margin, cfg16.attention)
    clouds = training_batch(dev, SEED + 100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, met = step(state, clouds)
    loss = met["loss"].item()
    ms = (time.perf_counter() - t0) * 1e3
    require(np.isfinite(loss), f"bf16 training step: loss {loss}")
    require(all(w.launches == 0 for w in fused), "bf16 training step launched a fused kernel")
    print(f"[{card}] bf16 training step (autograd route, {TRAIN_CLOUDS} x {TRAIN_POINTS} "
          f"points): loss {loss:.6f}, {ms:.1f} ms (first step, with set-up)")


def serving_mode_phases(dev, card, model, server, weights_t, packed, packed_host,
                        clusters_host, cfg, parent=None):
    """Phases 13-15: K3's bf16 mode against its plain version and f32, the
    bf16 serving path with counters reset, K3's decomposition bodies (and,
    with a parent tree, held to the parent's: stream bit-equal, the matmul
    bodies within ABLATE_F32_LIMIT) and the time split.
    Returns ({kernel entry: report}, {entry: launches})."""
    import torch

    from feat3dnet_tpu_torch.inference import ClusterDescriptorServer
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.utils import profiling

    k3 = fd.fused_describe_clusters_t
    names = {"bf16": "fused_describe_bf16", "stream": "fused_describe_ablate_stream",
             "matmul": "fused_describe_ablate_matmul",
             "matmul_2d": "fused_describe_ablate_matmul_2d"}
    ablations = ("stream", "matmul", "matmul_2d")
    report = {n: {} for n in names.values()}
    cos = torch.nn.functional.cosine_similarity
    macs = 2.0 * tower_macs(cfg) * BATCH
    io_bytes = nbytes(packed, *weights_t) + BATCH * (cfg.feature_dim + 1) * 4

    # ---- 13. bf16 activations against the plain bf16 version and f32 -----------
    with torch.no_grad():
        (dk, ak), (dp, ap) = (k3(weights_t, packed, cfg, bf16_act=True),
                              k3.plain(weights_t, packed, cfg, bf16_act=True))
        d32, _ = k3(weights_t, packed, cfg)
        torch.cuda.synchronize()
    dmax = (dk - dp).abs().amax(dim=1)
    c_min = cos(dk, dp, dim=1).min().item()
    within = (dmax <= 2.0 ** -8).float().mean().item()
    a_rel = ((ak - ap).abs() / ap.abs().clamp(min=1e-6)).max().item()
    c32 = cos(dk, d32, dim=1)
    print(f"K3 bf16 {BATCH} clusters vs plain bf16: min cos {c_min:.7f} (>= 0.9999), "
          f"{100 * within:.3f} % of descriptors within 2^-8 (>= 99.9 %), max|d| "
          f"{dmax.max().item():.3e}, att rel {a_rel:.3e} (<= 1e-2); vs f32 K3: min cos "
          f"{c32.min().item():.6f} (>= 0.995), median {c32.median().item():.7f}")
    require(c_min >= 0.9999 and within >= 0.999 and a_rel <= 1e-2,
            "K3 bf16 mode outside tolerance vs its plain version")
    require(c32.min().item() >= 0.995, "K3 bf16 mode too far from f32")
    report[names["bf16"]]["max_abs_err"] = dmax.max().item()

    # ---- 14. the bf16 serving path, counters from zero -----------------------------
    bf_server = ClusterDescriptorServer(model, device=dev, bf16_act=True)
    k3.launches = 0
    k3.mode_launches.update(dict.fromkeys(k3.mode_launches, 0))
    with torch.no_grad():
        packed_ans = [tuple(t.cpu() for t in bf_server.describe_packed(packed_host))
                      for _ in range(REQUESTS)]
        call_ans = [tuple(t.cpu() for t in bf_server(clusters_host)) for _ in range(REQUESTS)]
    launches = {names["bf16"]: k3.mode_launches["bf16"]}
    print(f"bf16 serving path launches: {dict(k3.mode_launches)}")
    require(k3.mode_launches["bf16"] == 2 * REQUESTS and k3.mode_launches["f32"] == 0,
            f"bf16 server launched {dict(k3.mode_launches)}")
    for d, a in packed_ans + call_ans:
        require(torch.equal(d, packed_ans[0][0]) and torch.equal(a, packed_ans[0][1]),
                "bf16 server answers differ between requests or entry points")
    require(torch.equal(packed_ans[0][0], dk.cpu()), "bf16 server != K3 bf16 mode")
    serve = {"f32": [], "bf16": []}
    with torch.no_grad():
        for kind, srv in (("f32", server), ("bf16", bf_server), ("bf16", bf_server),
                          ("f32", server)):
            srv.describe_packed(packed_host)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REQUESTS):
                d, a = srv.describe_packed(packed_host)
                d.cpu(), a.cpu()
            serve[kind].append(REQUESTS * BATCH / (time.perf_counter() - t0))
    print(f"[{card}] server bf16_act: {np.mean(serve['bf16']):.0f} descriptors/s "
          f"(runs {[round(x) for x in serve['bf16']]}), f32 {np.mean(serve['f32']):.0f} "
          f"(runs {[round(x) for x in serve['f32']]}), {REQUESTS} requests x {BATCH} clusters "
          f"each, host packed array in, host results out, in turns")

    # ---- 15. the decomposition bodies, then the time split --------------------------
    def share(got, want):   # the larger of desc's and att's max|got - want| / max|want|
        return max((g - w).abs().max().item() / w.abs().max().item() for g, w in zip(got, want))

    limit = fd.ABLATE_F32_LIMIT
    with torch.no_grad():
        for ab in ablations:
            (dk, ak), (dp, ap) = (k3(weights_t, packed, cfg, ablate=ab),
                                  k3.plain(weights_t, packed, cfg, ablate=ab))
            torch.cuda.synchronize()
            if ab == "stream":
                require(torch.equal(dk, dp) and torch.equal(ak, ap),
                        "K3 stream body != its plain version")
                held = "exact"
            else:
                err = share((dk, ak), (dp, ap))
                err_f32 = share((dk, ak), fd._describe_ablate_plain(
                    weights_t, packed.reshape(cfg.num_samples, 8, -1), cfg, ab, tf32=False))
                held = (f"{err:.3e} of max|ref| (<= 1e-5); vs the all-f32 plain body "
                        f"{err_f32:.3e} (<= ABLATE_F32_LIMIT {limit:.3e})")
                require(err <= 1e-5 and err_f32 <= limit, f"K3 {ab} body vs plain: {held}")
            report[names[ab]]["max_abs_err"] = max((dk - dp).abs().max().item(),
                                                   (ak - ap).abs().max().item())
            same = ""
            if parent is not None:
                with kernels_from(parent):
                    dq, aq = k3(weights_t, packed, cfg, ablate=ab,
                                packed=describe_pack(parent, weights_t, cfg, dev, ab))
                if ab == "stream":
                    require(torch.equal(dk, dq) and torch.equal(ak, aq),
                            "K3 stream body != the parent's")
                    same = "; equal to the parent's"
                else:   # the parent's bodies may sum in f32 on FFMA
                    e_par = share((dk, ak), (dq, aq))
                    require(e_par <= limit, f"K3 {ab} body vs the parent's: {e_par:.3e}")
                    same = f"; vs the parent's {e_par:.3e} of max|ref| (<= {limit:.3e})"
            print(f"K3 {ab} body vs plain: {held}{same}")
        k3.mode_launches.update(dict.fromkeys(k3.mode_launches, 0))
        split = serving_time_split(k3, weights_t, packed, cfg, reps=10)
        for ab in ablations:
            launches[names[ab]] = k3.mode_launches[ab]
        require(all(launches[names[ab]] > 0 for ab in ablations),
                f"decomposition launches {dict(k3.mode_launches)}")
        host_ms = profiling.timed_device_call(
            functools.partial(k3, packed=fd._describe_kernel_weights(weights_t, cfg, dev)),
            weights_t, packed, cfg, repeats=7) * 1e3
        for mode, kw in [("bf16", {"bf16_act": True})] + [(ab, {"ablate": ab})
                                                          for ab in ablations]:
            pk = fd._describe_kernel_weights(weights_t, cfg, dev, mode)   # packed once
            report[names[mode]].update(zip(("ms", "plain_ms"), in_turns(
                lambda kw=kw, pk=pk: k3(weights_t, packed, cfg, packed=pk, **kw),
                lambda kw=kw: k3.plain(weights_t, packed, cfg, **kw), 10, 3)))
    print(f"[{card}] K3 time split at {BATCH} clusters (CUDA events, in turns): f32 "
          f"{split['f32']:.4f} ms, bf16 {split['bf16']:.4f} ms, matmul {split['matmul']:.4f} ms, "
          f"matmul_2d {split['matmul_2d']:.4f} ms, stream {split['stream']:.4f} ms; elementwise share (f32 - matmul) / f32 "
          f"{100 * split['elementwise_share']:.2f} %, product share (matmul - stream) / f32 "
          f"{100 * split['product_share']:.2f} %, pct_matmul_floor (matmul / f32) "
          f"{split['pct_matmul_floor']:.2f} %; f32 on the host clock (timed_device_call, "
          f"synchronised) {host_ms:.4f} ms")
    require(all(split["stream"] <= split[ab] <= split["f32"] for ab in ("matmul", "matmul_2d")),
            "K3 time split: not stream <= matmul, matmul_2d <= f32")
    b_bf = bound_ms(macs, io_bytes, PEAK_BF16_FLOPS)
    b_f32 = bound_ms(macs, io_bytes)
    b_tf32 = tower_bound(cfg, BATCH, io_bytes, False, descriptor=True)[0]   # row 3's f32 pricing
    report[names["bf16"]].update(bound_ms=b_bf[0], bound_by=b_bf[1])
    report[names["matmul"]].update(bound_ms=b_tf32[0], bound_by=b_tf32[1])
    report[names["matmul_2d"]].update(bound_ms=b_tf32[0], bound_by=b_tf32[1])
    stream_bytes = 12 * cfg.num_samples * BATCH + BATCH * (cfg.feature_dim + 1) * 4
    report[names["stream"]].update(bound_ms=stream_bytes / PEAK_HBM_BYTES * 1e3,
                                   bound_by="bytes")
    for name in names.values():
        r = report[name]
        print(f"[{card}] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"; at the f32 FMA peak the bound is {b_f32[0]:.4f} ms"
                 if name in (names["bf16"], names["matmul"], names["matmul_2d"]) else ""))
    return report, launches


def detector_mode_phase(dev, card, clouds, npz_path):
    """Phase 16: K6's folded and bf16_operands modes on the extraction
    shapes with the trained weights: a counted run of both modes on every
    cloud's K4 clusters, then each against its plain version, folded
    against unfolded, and times. Returns ({entry: report}, {entry: launches})."""
    import torch

    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.utils import load_variables_npz

    cfg = ModelConfig()
    variables = load_variables_npz(npz_path)
    w_unf = [w.to(dev) for w in fd.transpose_unfolded_detector(
        fd.detector_weights_unfolded(variables, cfg))]
    w_fold = [w.to(dev) for w in fd.transpose_folded_weights(fd.folded_weights(variables, cfg))]
    modes = {"folded": (w_fold, {}),
             "bf16_operands": (w_unf, {"unfolded": True, "bf16_operands": True})}
    # each mode's weights packed once, as the pipeline packs them
    packs = {m: fd._detect_kernel_weights(w, cfg, dev, kw.get("unfolded", False),
                                          bf16=kw.get("bf16_operands", False))
             for m, (w, kw) in modes.items()}
    pk_unf = fd._detect_kernel_weights(w_unf, cfg, dev, unfolded=True)
    names = {"folded": "fused_detect_folded", "bf16_operands": "fused_detect_bf16_operands"}
    k6 = fd.fused_detect_clusters
    report = {n: {"max_abs_err": 0.0} for n in names.values()}
    cases = {}
    with torch.no_grad():
        for name, cloud in clouds.items():
            _, ctr, _, _, offs, sl = sorted_clusters(dev, cloud)
            cases[name] = (offs, sl, ctr[:, 0] < 5e8)
        # the path: both modes on every cloud's clusters, counters from zero
        k6.mode_launches.update(dict.fromkeys(k6.mode_launches, 0))
        outs = {name: {m: k6(w, offs, cfg, packed=packs[m], **kw)
                       for m, (w, kw) in modes.items()}
                for name, (offs, _, _) in cases.items()}
        torch.cuda.synchronize()
        launches = {names[m]: k6.mode_launches[m] for m in modes}
        print(f"K6 modes path launches: {dict(k6.mode_launches)}")
        require(all(n > 0 for n in launches.values()) and k6.mode_launches["unfolded"] == 0,
                f"K6 mode launches {dict(k6.mode_launches)}")
        times = {m: [] for m in modes}
        bounds = {m: [] for m in modes}
        for name, (offs, sl, real) in cases.items():
            att_u, ori_u = k6(w_unf, offs, cfg, unfolded=True, packed=pk_unf)
            line = []
            for m, (w, kw) in modes.items():
                att_k, ori_k = outs[name][m]
                att_p, ori_p = fd.fused_detect_clusters_plain(w, offs[sl], cfg, **kw)
                a_err = (att_k[sl] - att_p).abs()
                a_rel = a_err / att_p.abs().clamp(min=1e-6)
                o_err = _wrapped(ori_k[sl] - ori_p).abs()
                report[names[m]]["max_abs_err"] = max(report[names[m]]["max_abs_err"],
                                                      a_err.max().item())
                if m == "folded":
                    require(a_rel.max().item() <= 1e-5 and o_err.max().item() <= 1e-5,
                            f"K6 folded vs plain on {name}: att rel {a_rel.max().item():.3e}, "
                            f"ori {o_err.max().item():.3e} rad")
                    fu = ((att_k - att_u).abs() / att_u.abs().clamp(min=1e-6))[real].max().item()
                    require(fu <= 1e-3, f"K6 folded vs unfolded attention {fu:.3e} on {name}")
                    line.append(f"folded att rel {a_rel.max().item():.3e}, ori "
                                f"{o_err.max().item():.3e} rad (<= 1e-5); folded vs unfolded "
                                f"att rel {fu:.3e} (<= 1e-3)")
                else:
                    def share(att, ori):
                        rel = (att[sl] - att_p).abs() / att_p.abs().clamp(min=1e-6)
                        err = _wrapped(ori[sl] - ori_p).abs()
                        return ((rel <= 1e-4) & (err <= 1e-4)).float().mean().item()

                    # the control: the f32 kernel must fail the limit the mode is held to
                    s_k, s_f = share(att_k, ori_k), share(att_u, ori_u)
                    require(s_k >= 0.999, f"K6 bf16_operands vs plain on {name}: "
                                          f"{100 * s_k:.3f} % within 1e-4")
                    require(s_f < 0.999, f"K6 f32 vs plain bf16_operands on {name}: "
                                         f"{100 * s_f:.3f} % within 1e-4, the check cannot "
                                         "tell a kernel that skips the rounding")
                    line.append(f"bf16_operands {100 * s_k:.3f} % within 1e-4 (>= 99.9 %), "
                                f"max att rel {a_rel.max().item():.3e}, ori "
                                f"{o_err.max().item():.3e} rad; control f32 kernel vs plain "
                                f"bf16_operands {100 * s_f:.3f} % within 1e-4 (< 99.9 %)")
            print(f"K6 modes {name} ({sl.stop - sl.start} centres vs plain): " + "; ".join(line))
            if offs.shape[0] <= FULL_CHECK:
                ms = {}
                for m, (w, kw) in modes.items():
                    ms[m] = in_turns(lambda w=w, m=m, kw=kw: k6(w, offs, cfg, packed=packs[m],
                                                                **kw),
                                     lambda w=w, kw=kw: fd.fused_detect_clusters_plain(
                                         w, offs, cfg, **kw), 3, 2)
                    times[m].append(ms[m])
                    moved = nbytes(offs, *w) + offs.shape[0] * 8
                    bounds[m].append(tower_bound(cfg, offs.shape[0], moved,
                                                 m == "bf16_operands")[0])
                ms_u, _ = in_turns(lambda: k6(w_unf, offs, cfg, unfolded=True, packed=pk_unf),
                                   lambda: k6(w_fold, offs, cfg, packed=packs["folded"]), 3, 3)
                print(f"[{card}] K6 modes {name} M={offs.shape[0]}: folded {ms['folded'][0]:.4f} "
                      f"ms (plain {ms['folded'][1]:.4f}), bf16_operands "
                      f"{ms['bf16_operands'][0]:.4f} ms (plain {ms['bf16_operands'][1]:.4f}), "
                      f"unfolded {ms_u:.4f} ms in turns with folded")
    for m in modes:
        r = report[names[m]]
        r["ms"] = float(np.mean([t[0] for t in times[m]]))
        r["plain_ms"] = float(np.mean([t[1] for t in times[m]]))
        r["bound_ms"], r["bound_by"] = mean_bound(bounds[m])
        print(f"[{card}] {names[m]}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) mean over the vendored clouds")
    return report, launches



# the recorded held-out accuracy of the kp1024_ratio0_nms02 setting
# (examples/results/scaled_accuracy/inference_sweep.json, 24 pairs)
ACC_PAIRS = 24
ACC_PRECISION, ACC_PUTATIVE, ACC_KEYPOINTS = 87.19827410754264, 24567, 1023.8125
ACC_MIN_SUCCESS = 20 / 24


def accuracy_phase(dev, card, npz_path):
    """Phase 18: the held-out accuracy rerun. Rebuilds the 24-pair held-out
    set (eval/heldout.py, RandomState(0)), runs the trained weights in
    ModelConfig(num_clusters=256, num_samples=64) with
    InferenceConfig(min_response_ratio=0, nms_radius=0.2) through
    process_directory on the default and the fused route (launch counters
    reset), and holds each route's fig4 and registration to the record;
    then cli.match --device cuda on two of the outputs."""
    import io
    import shutil

    import torch

    from feat3dnet_tpu_torch.cli import match as match_cli
    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig
    from feat3dnet_tpu_torch.eval.heldout import build_test_set, evaluate_setting
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.ops import hash_grid as hg
    from feat3dnet_tpu_torch.utils import load_variables_npz

    root = os.path.join(HERE, "build", "chip_smoke_accuracy")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    test_dir = build_test_set(root, ACC_PAIRS)
    print(f"held-out set: {ACC_PAIRS} pairs rebuilt in {time.perf_counter() - t0:.1f} s")
    cfg = ModelConfig(num_clusters=256, num_samples=64)
    variables = load_variables_npz(npz_path)
    icfg = dict(min_response_ratio=0.0, nms_radius=0.2)
    wrappers = {"sorted_ball_query": hg.sorted_ball_query, "ball_max": hg.ball_max_sorted,
                "fused_detect": fd.fused_detect_clusters,
                "fused_describe": fd.fused_describe_clusters_t}
    kernels_of = {"default": ("sorted_ball_query", "ball_max"),
                  "fused": ("sorted_ball_query", "ball_max", "fused_detect", "fused_describe")}
    out_dirs = {}
    for route, extra in (("default", {}), ("fused", {"use_fused_detector": True})):
        pipe = InferencePipeline(Feat3DNet(cfg), variables, cfg,
                                 InferenceConfig(**icfg, **extra), device=dev)
        for w in wrappers.values():
            w.launches = 0
        out_dirs[route] = os.path.join(root, f"results_{route}")
        t0 = time.perf_counter()
        entry = evaluate_setting(pipe, test_dir, out_dirs[route])
        run_s = time.perf_counter() - t0
        launches = {k: wrappers[k].launches for k in kernels_of[route]}
        f4, reg = entry["fig4"], entry["registration"]
        kp = entry["keypoints_per_cloud"]
        print(f"accuracy kp1024_ratio0_nms02 ({route} route; {run_s:.1f} s, launches "
              f"{launches}): fig4 precision@1m {f4['precision_at_1m']:.4f} % (record "
              f"{ACC_PRECISION:.3f} +- 1.0), total putative {int(f4['total_putative'])} (record "
              f"{ACC_PUTATIVE} +- 1 %), total correct {int(f4['total_correct'])}; keypoints per "
              f"cloud {kp:.4f} (record {ACC_KEYPOINTS} +- 1 %); registration success "
              f"{reg['success_rate']:.4f} = {round(reg['success_rate'] * ACC_PAIRS)}/{ACC_PAIRS} "
              f"(>= 20/24), median rotation error {reg['median_rot_err_deg']:.4f} deg, "
              f"translation error {reg['median_trans_err_m']:.4f} m, inliers "
              f"{reg['median_inliers']:.1f}")
        print(f"accuracy {route} json: {json.dumps(entry)}")
        for k, n_launch in launches.items():
            require(n_launch > 0, f"kernel {k} was not launched on the {route} accuracy run")
        require(abs(f4["precision_at_1m"] - ACC_PRECISION) <= 1.0,
                f"{route}: precision@1m {f4['precision_at_1m']:.4f} off the record")
        require(abs(f4["total_putative"] - ACC_PUTATIVE) <= 0.01 * ACC_PUTATIVE,
                f"{route}: total putative {f4['total_putative']} off the record")
        require(abs(kp - ACC_KEYPOINTS) <= 0.01 * ACC_KEYPOINTS,
                f"{route}: keypoints per cloud {kp:.4f} off the record")
        require(reg["success_rate"] >= ACC_MIN_SUCCESS - 1e-9,
                f"{route}: registration success {reg['success_rate']:.4f} < 20/24")
    # cli.match on the first pair's outputs, on the card
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = match_cli.main(["--desc1", os.path.join(out_dirs["default"], "0.bin"),
                                 "--desc2", os.path.join(out_dirs["default"], "1.bin"),
                                 "--device", "cuda"])
    printed = json.loads(buf.getvalue())
    require(printed == result and result["num_inliers"] > 0
            and np.isfinite(np.asarray(result["rotation"])).all(),
            f"cli.match printed {buf.getvalue()[:200]}")
    print(f"cli.match --device cuda (pair 0 -> 1, default route): {result['num_matches']} "
          f"matches, {result['num_inliers']} inliers, rotation "
          f"{np.round(result['rotation'], 4).tolist()}, translation "
          f"{np.round(result['translation'], 4).tolist()}")
    torch.cuda.synchronize()

SUBMAPS, SUBMAP_POINTS = 8, 120_000   # the JAX package's bench_extract_many.py stream
LONG_KITTI, LONG_SUBMAPS = 64, 16      # the longer streams, past the pipeline's fill and drain
UNIT = 4                               # clouds per extract_batch / extract_many unit
COLD_START = r"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig
from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
from feat3dnet_tpu_torch.inference import InferencePipeline
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.utils import load_variables_npz
torch.backends.cuda.matmul.allow_tf32 = False
cfg = ModelConfig()
t0 = time.perf_counter()
pipe = InferencePipeline(Feat3DNet(cfg), load_variables_npz(sys.argv[2]), cfg,
                         InferenceConfig(use_fused_detector=True), device="cuda")
cloud = load_point_cloud(example_cloud_path("kitti_00_004534.bin"))
out = {"setup_s": time.perf_counter() - t0}
if sys.argv[3] == "warm":
    out["warmup"] = {f"{n}x{b}": s for (n, b), s in pipe.warmup(
        point_counts=[cloud.shape[0]], batch_sizes=(1, 4)).items()}
ms = []
for _ in range(4):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.extract(cloud)
    ms.append((time.perf_counter() - t0) * 1e3)
out["first_ms"], out["steady_ms"] = ms[0], float(np.mean(ms[1:]))
print(json.dumps(out))
"""


def submap_clouds(seed, count=SUBMAPS):
    """`count` seeded clouds of SUBMAP_POINTS points uniform in a 100 m x
    100 m x 10 m box (the JAX package's bench_extract_many.py stream; bucket
    131 072)."""
    rs = np.random.RandomState(seed)
    box = np.array([100.0, 100.0, 10.0], np.float32)
    return [rs.rand(SUBMAP_POINTS, 3).astype(np.float32) * box for _ in range(count)]


def same_results(what, got, want):
    """Each cloud's keypoints, attention and features equal bit for bit."""
    require(len(got) == len(want), f"{what}: {len(got)} results for {len(want)} clouds")
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.num_keypoints == w.num_keypoints
                and all(np.array_equal(getattr(g, f), getattr(w, f))
                        for f in ("keypoints", "attention", "features")),
                f"{what}: cloud {i} differs from extract")


def union_kernel_step(card, dev, clouds, pipe):
    """Phase 19's kernel checks on the union of `clouds` at their shared
    bucket (256-point blocks, the pipeline's tiles): build_sorted_cloud_batch
    equal to the per-cloud builds in every field; K4 and K5 with segment=
    index-exact against their plain versions on every centre and, per
    cloud, equal to their run on that cloud alone; the union build, K4 and
    K5 timed against their plain versions and bounds, beside the four
    clouds' own calls."""
    import torch

    from feat3dnet_tpu_torch.config import bucket_for
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.ops import hash_grid as hg

    b = len(clouds)
    nb = max(bucket_for(c.shape[0]) for c in clouds)
    xyz = torch.zeros((b, nb, 3), device=dev)
    valid = torch.zeros((b, nb), dtype=torch.bool, device=dev)
    for i, c in enumerate(clouds):
        xyz[i, :c.shape[0]] = torch.from_numpy(np.ascontiguousarray(c[:, :3])).to(dev)
        valid[i, :c.shape[0]] = True

    def union():
        return hg.build_sorted_cloud_batch(xyz, valid, cell_size=RADIUS, block_size=256)

    def each():
        return [hg.build_sorted_cloud(xyz[i], valid[i], cell_size=RADIUS, block_size=256)
                for i in range(b)]
    sc, alone = union(), each()
    for f in LAYOUT_FIELDS:
        join = torch.cat if f in ("pts4", "blk_bbox") else torch.stack
        require(torch.equal(getattr(sc, f), join([getattr(a, f) for a in alone])),
                f"build_sorted_cloud_batch != the per-cloud builds in {f}")
    ms_union, ms_each = cuda_ms(union, 10), cuda_ms(each, 10)
    ctr = sc.pts4[:, :3]
    top_k, cnt_k = hg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, RADIUS, NS, tile=256,
                                        segment=nb)
    top_p, cnt_p = hg.sorted_ball_query_plain(sc.pts4, ctr, RADIUS, NS, segment=nb)
    require(torch.equal(top_k, top_p) and torch.equal(cnt_k, cnt_p),
            "K4 with segment != its plain version on the union")
    grouped, _, _ = hg._finish_grouped(top_k, cnt_k, ctr, NS)
    offs = (grouped - ctr[:, None, :]).contiguous()
    weights_t, packed = pipe.kernel_weights.detect()
    att, _ = fd.fused_detect_clusters(weights_t, offs, pipe.mcfg, unfolded=True, packed=packed)
    bm_k = hg.ball_max_sorted(sc.pts4, sc.blk_bbox, att, NMS_RADIUS, segment=nb)
    bm_p = hg.ball_max_plain(sc.pts4, att, NMS_RADIUS, segment=nb)
    require(torch.equal(bm_k, bm_p), "K5 with segment != its plain version on the union")
    for i, a in enumerate(alone):
        rows = slice(i * nb, (i + 1) * nb)
        t1, c1 = hg.sorted_ball_query(a.pts4, a.blk_bbox, a.pts4[:, :3], RADIUS, NS, tile=256)
        require(torch.equal(t1, top_k[rows]) and torch.equal(c1, cnt_k[rows]),
                f"K4 on the union != K4 on cloud {i} alone")
        require(torch.equal(hg.ball_max_sorted(a.pts4, a.blk_bbox, att[rows].contiguous(),
                                               NMS_RADIUS), bm_k[rows]),
                f"K5 on the union != K5 on cloud {i} alone")
    real = ctr[:, 0] < 5e8
    _, cnt_nms = hg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, NMS_RADIUS, 1, tile=256,
                                      segment=nb)
    b4 = bound_ms(8.0 * cnt_k[real].sum().item(), nbytes(sc.pts4, ctr, top_k, cnt_k))
    b5 = bound_ms(9.0 * cnt_nms[real].sum().item(), nbytes(sc.pts4, att, bm_k))
    k4 = in_turns(lambda: hg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, RADIUS, NS, tile=256,
                                               segment=nb),
                  lambda: hg.sorted_ball_query_plain(sc.pts4, ctr, RADIUS, NS, segment=nb), 5, 1)
    k5 = in_turns(lambda: hg.ball_max_sorted(sc.pts4, sc.blk_bbox, att, NMS_RADIUS, segment=nb),
                  lambda: hg.ball_max_plain(sc.pts4, att, NMS_RADIUS, segment=nb), 10, 1)
    each4 = cuda_ms(lambda: [hg.sorted_ball_query(a.pts4, a.blk_bbox, a.pts4[:, :3], RADIUS, NS,
                                                  tile=256) for a in alone], 5)
    each5 = cuda_ms(lambda: [hg.ball_max_sorted(a.pts4, a.blk_bbox,
                                                att[i * nb:(i + 1) * nb].contiguous(),
                                                NMS_RADIUS) for i, a in enumerate(alone)], 10)
    n_pts = sc.pts4.shape[0]
    print(f"[{card}] union of {b} clouds at bucket {nb} ({n_pts} points): "
          f"build_sorted_cloud_batch {ms_union:.4f} ms, the {b} per-cloud builds {ms_each:.4f} "
          f"ms (CUDA events, back to back); bit-equal in {', '.join(LAYOUT_FIELDS)}")
    print(f"[{card}] sorted_ball_query union segment={nb}: kernel {k4[0]:.4f} ms, plain "
          f"{k4[1]:.4f} ms, bound {b4[0]:.4f} ms ({b4[1]}); the {b} clouds alone "
          f"{each4:.4f} ms; index-exact vs plain on all {n_pts} centres, equal per cloud to "
          "the cloud alone")
    print(f"[{card}] ball_max union segment={nb}: kernel {k5[0]:.4f} ms, plain {k5[1]:.4f} ms, "
          f"bound {b5[0]:.6f} ms ({b5[1]}); the {b} clouds alone {each5:.4f} ms; exact vs plain "
          f"on all {n_pts} centres, equal per cloud to the cloud alone")


def throughput(card, name, pipe, route, clouds, rounds=2):
    """Clouds/s of the four entry points on one stream (host clock,
    synchronised), in turns forward then backward, `rounds` times. On a
    short stream the pipelined entry points' rates include the fill and
    drain of their `depth` units."""
    import torch

    runs = {"extract loop": lambda: [pipe.extract(c) for c in clouds],
            "extract_many(batch_size=1)": lambda: pipe.extract_many(clouds, batch_size=1),
            f"extract_batch({UNIT})": lambda: [pipe.extract_batch(clouds[i:i + UNIT])
                                               for i in range(0, len(clouds), UNIT)],
            f"extract_many(batch_size={UNIT})": lambda: pipe.extract_many(clouds,
                                                                          batch_size=UNIT)}
    rates = {k: [] for k in runs}
    for k in (list(runs) + list(runs)[::-1]) * rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[k]()
        torch.cuda.synchronize()
        rates[k].append(len(clouds) / (time.perf_counter() - t0))
    print(f"[{card}] throughput {name} ({len(clouds)} clouds, {route} route; clouds/s, host "
          f"clock, synchronised, {2 * rounds} turns each): " + ", ".join(
              f"{k} {np.mean(v):.3f} (min {np.min(v):.3f}, max {np.max(v):.3f})"
              for k, v in rates.items()))


def profile_batch(card, name, pipe, route, clouds):
    """One profiled extract_batch: device busy share and top kernels."""
    import torch

    pipe.extract_batch(clouds)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.extract_batch(clouds)
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    print(f"[{card}] profile extract_batch {name} x{len(clouds)} ({route}): wall {wall:.2f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall:.1f} %)")
    for e in ev[:6]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")


def batch_phase(dev, card, npz_path, data_dir):
    """Phase 19: batched and pipelined extraction with the trained weights on
    both routes. The union kernel checks (union_kernel_step) on the four
    vendored clouds; then, launch counters reset, per route: extract_batch
    on the vendored clouds, extract_many (depth 2, batch_size 1 and UNIT)
    on SUBMAPS seeded submap clouds, extract_many on the vendored clouds
    and an odd trailing one, process_directory(batch_size=UNIT) and
    cli.infer --batch_size UNIT --device cuda, each cloud's results equal
    to extract bit for bit, and extract_batch on a cloud of bucket 4 096
    with one of 32 768 (detector chunks of 4 096 and 8 192 rows) equal to
    extract; K3-K6 must have launched. Then one
    extract_batch's launches (K4, K5 once; on the fused route K6 and K3
    once too), a unit queued under torch's sync debug mode set to raise,
    throughput (`throughput`) on a KITTI stream and the submap stream of
    8 clouds each and on longer ones (LONG_KITTI frames, LONG_SUBMAPS
    submaps), one profiled batch per stream and route, and warmup in a
    fresh process against a cold one (first request and steady state)."""
    import io
    import shutil

    import torch

    from feat3dnet_tpu_torch.cli import infer as infer_cli
    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.ops import hash_grid as hg
    from feat3dnet_tpu_torch.utils import load_variables, load_variables_npz

    cfg = ModelConfig()
    model = load_variables(Feat3DNet(cfg), load_variables_npz(npz_path)).eval().to(dev)
    routes = {"default": {}, "fused": {"use_fused_detector": True}}
    pipes = {r: InferencePipeline(model, None, cfg, InferenceConfig(**kw), device=dev)
             for r, kw in routes.items()}
    pipes["fused"].kernel_weights.detect()      # K6's and K3's weights, packed once
    pipes["fused"].kernel_weights.describe()
    vendored = {n: load_point_cloud(example_cloud_path(n)) for n in CLOUDS}
    clouds = list(vendored.values())
    with torch.no_grad():
        union_kernel_step(card, dev, clouds, pipes["fused"])

    wrappers = {"sorted_ball_query": hg.sorted_ball_query, "ball_max": hg.ball_max_sorted,
                "fused_detect": fd.fused_detect_clusters,
                "fused_describe": fd.fused_describe_clusters_t}
    subs = submap_clouds(SEED)
    trailing = clouds[0][::2].copy()          # 8 192 points: a bucket of its own
    small = clouds[2][:4000].copy()           # bucket 4 096, batched with bucket 32 768
    root = os.path.join(HERE, "build", "chip_smoke_batch")
    shutil.rmtree(root, ignore_errors=True)
    for w in wrappers.values():
        w.launches = 0
    for route, pipe in pipes.items():
        want = [pipe.extract(c) for c in clouds]
        same_results(f"{route} extract_batch on the vendored clouds", pipe.extract_batch(clouds),
                     want)
        same_results(f"{route} extract_batch on a {small.shape[0]}-point cloud and "
                     f"{CLOUDS[2]}", pipe.extract_batch([small, clouds[2]]),
                     [pipe.extract(small), want[2]])
        want_s = [pipe.extract(c) for c in subs]
        for bs in (1, UNIT):
            same_results(f"{route} extract_many(depth=2, batch_size={bs}) on the submaps",
                         pipe.extract_many(subs, depth=2, batch_size=bs), want_s)
        same_results(f"{route} extract_many(batch_size={UNIT}) on the vendored clouds + a "
                     "trailing one", pipe.extract_many(clouds + [trailing], batch_size=UNIT),
                     want + [pipe.extract(trailing)])
        out_pd, out_cli = os.path.join(root, f"pd_{route}"), os.path.join(root, f"cli_{route}")
        pipe.process_directory(data_dir, out_pd, log=lambda *_: None, batch_size=UNIT)
        with contextlib.redirect_stderr(io.StringIO()):
            infer_cli.main(["--data_dir", data_dir, "--output_dir", out_cli, "--variables",
                            npz_path, "--batch_size", str(UNIT), "--device", "cuda"]
                           + (["--use_fused_detector"] if route == "fused" else []))
        by_name = dict(zip(CLOUDS, want))
        for out_dir in (out_pd, out_cli):
            written = sorted(os.listdir(out_dir))
            require(written == sorted(CLOUDS), f"{out_dir}: wrote {written}")
            for fname in written:
                r = by_name[fname]
                require(np.array_equal(np.fromfile(os.path.join(out_dir, fname), np.float32),
                                       np.concatenate([r.keypoints, r.features], 1).ravel()),
                        f"{route}: {os.path.relpath(out_dir, HERE)}/{fname} differs from extract")
        print(f"batch {route} route: extract_batch (vendored x{len(clouds)}; a "
              f"{small.shape[0]}-point cloud with {CLOUDS[2]}), extract_many "
              f"(depth 2, batch_size 1 and {UNIT}; {SUBMAPS} submaps of {SUBMAP_POINTS} points, "
              f"bucket 131072), extract_many(batch_size={UNIT}) on the vendored clouds + a "
              f"trailing {trailing.shape[0]}-point one, process_directory(batch_size={UNIT}) and "
              f"cli.infer --batch_size {UNIT} --device cuda: every cloud bit-equal to extract")
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"batch path launches: {launches}")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched on the batch path")

    kitti = [vendored["kitti_00_001554.bin"], vendored["kitti_00_004534.bin"]] * UNIT
    for route, pipe in pipes.items():
        # one batch: K4 and K5 once, and on the fused route K6 and K3 once
        for w in wrappers.values():
            w.launches = 0
        pipe.extract_batch(clouds)
        got = {k: w.launches for k, w in wrappers.items()}
        fused = route == "fused"
        require(got == {"sorted_ball_query": 1, "ball_max": 1, "fused_detect": int(fused),
                        "fused_describe": int(fused)},
                f"{route}: one extract_batch of {len(clouds)} clouds launched {got}")
        # a unit is queued without a host sync: torch raises on one
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            pending = [pipe._enqueue(pipe._prep(c)) for c in ([clouds[2]], clouds)]
            queue_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for p in pending:
            pipe._finish(p)
        print(f"batch {route}: one extract_batch of {len(clouds)} clouds launched {got}; one "
              f"cloud and a batch of {len(clouds)} queued with no host sync ({queue_ms:.2f} ms "
              "on the host)")
    subs_long = submap_clouds(SEED + 1, LONG_SUBMAPS)
    for route, pipe in pipes.items():
        for stream, rounds in ((kitti, 2), (kitti * (LONG_KITTI // len(kitti)), 1)):
            throughput(card, "KITTI stream (the two vendored KITTI clouds in turn, bucket 32768)",
                       pipe, route, stream, rounds)
        for stream in (subs, subs_long):
            throughput(card, f"submap stream ({SUBMAP_POINTS} points, bucket 131072)", pipe,
                       route, stream, rounds=1)
        for name, stream in (("KITTI", kitti[:UNIT]), ("submap", subs[:UNIT])):
            profile_batch(card, name, pipe, route, stream)
    # warmup: a fresh process with and without it (kernels already built)
    for mode in ("cold", "warm"):
        proc = subprocess.run([sys.executable, "-c", COLD_START, HERE, npz_path, mode],
                              capture_output=True, text=True, timeout=300)
        require(proc.returncode == 0, f"warmup process ({mode}) failed: {proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[{card}] fresh process, fused route, kitti_00_004534 ({mode}): " + (
            f"warmup {json.dumps(res['warmup'])} s; " if mode == "warm" else "no warmup; ")
            + f"first extract {res['first_ms']:.2f} ms, the next three {res['steady_ms']:.2f} "
            f"ms (host clock, synchronised); set-up {res['setup_s']:.2f} s")


# ---- 20. the workflow around the model ------------------------------------------------------
WF_CROPS = 24          # crops a dataset in phase 20's train.txt: 48 entries, 8 steps an epoch
WF_SUBMAP_POINTS = 5000
WF_SPACING = 6.0       # m between neighbouring crops' positions (positives within 11 m)


def write_crop_dataset(folder, name, clouds, count, x0, rs):
    """`count` crops of `clouds` (in turn) as <folder>/<name>/<i>.bin, each
    centred on a seeded point within 10 m of its cloud's origin and cut to
    30 m, with a metadata.txt placing crop i at (x0 + WF_SPACING i, 0, 0)."""
    d = os.path.join(folder, name)
    os.makedirs(d)
    rows = ["Idx\tDataset\tStartIdx\tEndIdx\tNumPts\tX\tY\tZ"]
    for i in range(count):
        cloud = clouds[i % len(clouds)]
        near = np.nonzero(np.sum(cloud[:, :3] ** 2, axis=1) < 100.0)[0]
        crop = cloud.copy()
        crop[:, :3] -= cloud[rs.choice(near), :3]
        crop = crop[np.sum(crop[:, :3] ** 2, axis=1) < 900.0]
        crop.astype(np.float32).tofile(os.path.join(d, f"{i}.bin"))
        rows.append(f"{i}\t{name}\t\t\t{crop.shape[0]}\t{x0 + WF_SPACING * i}\t0.0\t0.0")
    with open(os.path.join(d, "metadata.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def write_submap_file(path, rs, world):
    """A seeded WF_SUBMAP_POINTS-point submap binary in dataprep/submap.py's
    layout (header, no features, point records): a noisy ground plane and
    two walls."""
    from feat3dnet_tpu_torch.dataprep import submap

    n = WF_SUBMAP_POINTS
    pts = rs.rand(n, 3).astype(np.float32) * np.float32([40.0, 40.0, 0.0])
    pts[:, 2] = rs.randn(n).astype(np.float32) * 0.02
    wall = rs.rand(n) < 0.3
    pts[wall, 0] = 5.0 + rs.randn(int(wall.sum())).astype(np.float32) * 0.02
    pts[wall, 2] = rs.rand(int(wall.sum())).astype(np.float32) * 4.0
    header = np.zeros((), submap._HEADER_DTYPE)
    header["f0"] = 123456
    header["f10"], header["f11"], header["f12"] = world
    header["f16"], header["f17"] = 0, n
    rec = np.zeros(n, np.dtype([("xyz", "3f4"), ("extra", submap._POINT_EXTRA_DTYPE)]))
    rec["xyz"] = pts
    with open(path, "wb") as f:
        header.tofile(f)
        rec.tofile(f)
    return pts


@contextlib.contextmanager
def numpy_reader():
    """TripletDataset's "auto" takes the numpy reader while active (phase 20's
    runs keep the reader they were measured with; phase 23 runs the native
    one beside them)."""
    from feat3dnet_tpu_torch.utils import native

    saved = native.native_available
    native.native_available = lambda: False
    try:
        yield
    finally:
        native.native_available = saved


class FirstStepProbe:
    """Patches trainer.make_fused_train_step (which cli.train imports when it
    runs) so that the first step of a run records, before it runs, the
    state's step and count, its parameters (flax layout) and each
    parameter's Adam state, on the host."""

    def __init__(self):
        self.seen = None

    def __enter__(self):
        from feat3dnet_tpu_torch.train import trainer
        from feat3dnet_tpu_torch.utils.convert import variables_from_module

        self._orig = orig = trainer.make_fused_train_step

        def make(model, *a, **kw):
            step = orig(model, *a, **kw)

            def probed(state, clouds):
                if self.seen is None:
                    names = {id(p): n for n, p in state.model.named_parameters()}
                    opt = {names[id(p)]: {k: v.detach().cpu().clone() for k, v in st.items()}
                           for p, st in state.optimizer.state.items()}
                    host = lambda t: ({k: host(v) for k, v in t.items()}
                                      if isinstance(t, dict) else t.detach().cpu().numpy().copy())
                    self.seen = {"step": state.step, "count": state.count, "opt": opt,
                                 "variables": host(variables_from_module(state.model))}
                return step(state, clouds)

            return probed

        trainer.make_fused_train_step = make
        return self

    def __exit__(self, *exc):
        from feat3dnet_tpu_torch.train import trainer

        trainer.make_fused_train_step = self._orig


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def param_path(name):
    *scope, leaf = name.split(".")
    return "/".join(scope + ["kernel" if leaf == "weight" else leaf]), leaf == "weight"


def workflow_phase(dev, card, npz_path, data_dir):
    """Phase 20: the workflow around the model on the card, at the paper
    config and TrainConfig() widths (see the module docstring, 20a-20e)."""
    import io
    import shutil

    import torch

    from feat3dnet_tpu_torch.cli import infer as infer_cli
    from feat3dnet_tpu_torch.cli import prepare as prepare_cli
    from feat3dnet_tpu_torch.cli import train as train_cli
    from feat3dnet_tpu_torch.cli import verify_parity
    from feat3dnet_tpu_torch.data.datagenerator import TripletDataset
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.entry import entry
    from feat3dnet_tpu_torch.ops import batch_group, fps
    from feat3dnet_tpu_torch.ops import fused_train as ft
    from feat3dnet_tpu_torch.utils.convert import load_variables_npz
    from feat3dnet_tpu_torch.utils.metrics_writer import device_histogram
    from feat3dnet_tpu_torch.utils.tf1_loader import export_tf1_arrays

    root = os.path.join(HERE, "build", "chip_smoke_workflow")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rs = np.random.RandomState(SEED)
    vendored = {n: load_point_cloud(example_cloud_path(n)) for n in CLOUDS}
    times = {}

    # ---- 20a. prepare ------------------------------------------------------------------
    t0 = time.perf_counter()
    datasets = {"oxford": [vendored[n] for n in CLOUDS[:2]],
                "kitti": [vendored[n] for n in CLOUDS[2:]]}
    data, one = os.path.join(root, "data"), os.path.join(root, "one_step")
    for k, (name, clouds) in enumerate(datasets.items()):
        write_crop_dataset(os.path.join(data, "train"), name, clouds, WF_CROPS, 1000.0 * k, rs)
    # a dataset of TrainConfig().batch_size crops, one step an epoch: two groups far apart
    write_crop_dataset(os.path.join(one, "train"), "near", datasets["oxford"], 3, 0.0, rs)
    write_crop_dataset(os.path.join(one, "train"), "far", datasets["kitti"], 3, 1000.0, rs)
    for folder, names in ((data, list(datasets)), (one, ["near", "far"])):
        with contextlib.redirect_stdout(io.StringIO()):
            prepare_cli.main(["train-cases", "--train_folder", os.path.join(folder, "train"),
                              "--datasets", *names, "--no_test_split"])
    ds = TripletDataset(os.path.join(data, "train", "train.txt"))
    require(ds.size == 2 * WF_CROPS and all(len(m.positives) >= 2 for m in ds.meta)
            and all(len(pool) > 0 for pool in ds._neg_pool),
            f"train-cases: {ds.size} entries, positives {[len(m.positives) for m in ds.meta]}")
    a, p, n = next(ds.epoch_triplets(0, 6, TRAIN_POINTS))
    require(a.shape == p.shape == n.shape == (6, TRAIN_POINTS, 6), "TripletDataset batch shape")
    require(TripletDataset(os.path.join(one, "train", "train.txt")).size == 6,
            "one-step train.txt")
    raw = os.path.join(root, "submaps_raw", "seq")
    os.makedirs(raw)
    subs = [os.path.join(raw, f"s{i}.bin") for i in range(2)]
    pts = [write_submap_file(s, rs, (10.0 * i, 20.0, 0.5)) for i, s in enumerate(subs)]
    sub_out = os.path.join(root, "submaps")
    with contextlib.redirect_stdout(io.StringIO()):
        prepare_cli.main(["submaps", "--normals", "--out", sub_out] + subs)
    for i, want in enumerate(pts):
        rows = np.fromfile(os.path.join(sub_out, "seq", f"{i}.bin"), np.float32)
        require(rows.size == WF_SUBMAP_POINTS * 6, f"submap {i}: {rows.size} floats")
        rows = rows.reshape(-1, 6)
        norms = np.linalg.norm(rows[:, 3:], axis=1)
        require(np.array_equal(rows[:, :3], want) and np.all(np.abs(norms - 1.0) <= 1e-5),
                f"submap {i}: points or normals (norms {norms.min()}..{norms.max()})")
    with open(os.path.join(sub_out, "seq", "metadata.txt")) as f:
        meta = f.read().splitlines()
    require(meta[0].startswith("Idx\tDataset") and len(meta) == 3
            and sorted(r.split("\t")[0] for r in meta[1:]) == ["0", "1"],
            f"submap metadata: {meta}")
    times["a"] = time.perf_counter() - t0
    print(f"workflow a. prepare: train-cases on 2 datasets of {WF_CROPS} crops -> "
          f"{ds.size} entries read back through TripletDataset (a batch "
          f"{a.shape}), a 6-entry one-step set; submaps --normals on 2 x "
          f"{WF_SUBMAP_POINTS} points: (N, 6) float32 rows, unit normals, metadata rows "
          f"({times['a']:.2f} s)")

    # ---- 20b. TF1 weights --------------------------------------------------------------
    t0 = time.perf_counter()
    tf1_npz = os.path.join(root, "ckpt4480_tf1.npz")
    np.savez(tf1_npz, **export_tf1_arrays(load_variables_npz(npz_path)))
    outs = {}
    for route in ("default", "fused"):
        for src in ("tf1", "variables"):
            out = os.path.join(root, f"infer_{route}_{src}")
            flag = ["--tf1_checkpoint", tf1_npz] if src == "tf1" else ["--variables", npz_path]
            with contextlib.redirect_stderr(io.StringIO()):
                infer_cli.main(["--data_dir", data_dir, "--output_dir", out, "--device", "cuda"]
                               + flag + (["--use_fused_detector"] if route == "fused" else []))
            outs[route, src] = out
        files = sorted(os.listdir(outs[route, "tf1"]))
        require(files == sorted(CLOUDS) and files == sorted(os.listdir(outs[route, "variables"])),
                f"cli.infer {route}: wrote {files}")
        for fname in files:
            a_, b_ = (open(os.path.join(outs[route, s], fname), "rb").read()
                      for s in ("tf1", "variables"))
            require(a_ == b_, f"cli.infer {route}: --tf1_checkpoint != --variables on {fname}")
    cloud = example_cloud_path("kitti_00_001554.bin")
    ref = os.path.join(outs["default", "variables"], "kitti_00_001554.bin")
    gate = {}
    bad_npz = os.path.join(root, "ckpt4480_tf1_bad.npz")
    arrays = dict(np.load(tf1_npz))
    key = "description/layer1/conv0/conv2d/weights"
    arrays[key] = arrays[key] * np.float32(1.5)
    np.savez(bad_npz, **arrays)
    for tag, path in (("true", tf1_npz), ("corrupted", bad_npz)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = verify_parity.main(["--npz", path, "--device", "cuda", "--cloud", cloud,
                                     "--reference_output", ref])
        out = buf.getvalue()
        line = next(x for x in out.splitlines() if x.startswith("descriptor cosine"))
        internal = next(x for x in out.splitlines() if x.startswith("fused-vs-model cosine"))
        gate[tag] = (rc, line.split(":", 1)[1].strip(), internal)
    require(gate["true"][0] == 0 and gate["corrupted"][0] == 1,
            f"verify_parity exit codes: true {gate['true'][0]}, corrupted {gate['corrupted'][0]}")
    median = float(re.search(r"'median': ([0-9.e+-]+)", gate["true"][1]).group(1))
    require(median >= 0.999, f"verify_parity median cosine {median}")
    times["b"] = time.perf_counter() - t0
    print(f"workflow b. TF1: cli.infer --tf1_checkpoint == --variables bit for bit on "
          f"{len(CLOUDS)} clouds, both routes; verify_parity --device cuda on "
          f"kitti_00_001554.bin: exit 0, {gate['true'][1]}; internal gate {gate['true'][2]}; "
          f"with {key} x 1.5: exit 1, {gate['corrupted'][1]} ({times['b']:.2f} s)")

    # ---- 20c. training -----------------------------------------------------------------
    t0 = time.perf_counter()
    wrappers = {"fps": fps.farthest_point_sample, "ball_query": batch_group.ball_query_fused,
                "train_stats": ft.stats_pass, "train_final": ft.final_pass,
                "train_bwd_top": ft.bwd_top_pass, "train_bwd": ft.bwd_pass}
    common = ["--fused_towers", "--device", "cuda", "--num_epochs", "1",
              "--summary_every_n_steps", "1", "--validate_every_n_steps", "0"]
    stage1 = os.path.join(root, "stage1")
    asset = os.path.join(HERE, "feat3dnet_tpu_torch", "assets", "ckpt4480_train_state.npz")
    runs = {
        "stage 1": ["--data_dir", data, "--log_dir", stage1, "--augmentation", "Jitter",
                    "RotateSmall", "Shift", "--noattention", "--noregress"],
        "stage 2": ["--data_dir", data, "--log_dir", os.path.join(root, "stage2"),
                    "--augmentation", "Jitter", "RotateSmall", "Shift", "Rotate1D",
                    "--checkpoint", stage1, "--restore_exclude", "detection"],
        "bridged asset": ["--data_dir", one, "--log_dir", os.path.join(root, "asset"),
                          "--variables", asset],
        "TF1": ["--data_dir", one, "--log_dir", os.path.join(root, "tf1"),
                "--tf1_checkpoint", tf1_npz],
    }
    states, seen, step_ms = {}, {}, None
    for name, args in runs.items():
        for w in wrappers.values():
            w.launches = 0
        with FirstStepProbe() as probe, numpy_reader(), \
                contextlib.redirect_stdout(io.StringIO()):
            states[name] = train_cli.main(args + common)
        seen[name] = probe.seen
        got = {k: w.launches for k, w in wrappers.items()}
        require(all(v > 0 for v in got.values()), f"cli.train {name}: launches {got}")
        log_dir = args[args.index("--log_dir") + 1]
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps = states[name].step - probe.seen["step"]
        require(len(rows) == steps and all(np.isfinite(r["loss"]) for r in rows),
                f"cli.train {name}: {len(rows)} rows for {steps} steps, losses "
                f"{[r.get('loss') for r in rows]}")
        for r in rows:
            h = r["hist_det_cnt"]
            require(len(h["counts"]) == 16 and sum(h["counts"]) == h["num"]
                    and h["hi"] <= NS, f"cli.train {name}: hist_det_cnt {h}")
            require(("hist_normalized_attention" in r) == (name != "stage 1"),
                    f"cli.train {name}: hist_normalized_attention in {sorted(r)}")
        with open(os.path.join(log_dir, "log.txt")) as f:
            require("Arguments" in f.read(), f"cli.train {name}: no Arguments line in log.txt")
        if name == "stage 1":
            ts = np.diff([r["ts"] for r in rows]) * 1e3
            step_ms = float(np.median(ts))
        print(f"workflow c. cli.train {name}: steps {probe.seen['step']} -> "
              f"{states[name].step}, losses {[round(r['loss'], 4) for r in rows]}, "
              f"launches {got}")
    # stage 2: the detector's Adam state right after the restore
    s1 = states["stage 1"]
    det = {k: v for k, v in seen["stage 2"]["opt"].items() if k.startswith("detection")}
    n_det = sum(1 for k, _ in s1.model.named_parameters() if k.startswith("detection"))
    require(len(det) == n_det and all(
        v["step"].item() == s1.count and not v["exp_avg"].any() and not v["exp_avg_sq"].any()
        for v in det.values()),
        f"stage 2: detector Adam state after the restore (stage 1 count {s1.count})")
    # the bridged asset: moments bit-equal, count 4 480
    with np.load(asset) as z:
        mu = {k[len("opt_state/mu/"):]: z[k] for k in z.files if k.startswith("opt_state/mu/")}
        nu = {k[len("opt_state/nu/"):]: z[k] for k in z.files if k.startswith("opt_state/nu/")}
    b = seen["bridged asset"]
    require(b["count"] == b["step"] == 4480 and len(b["opt"]) == len(mu) == len(nu),
            f"bridged asset: step {b['step']}, count {b['count']}, {len(b['opt'])} states")
    for pname, st in b["opt"].items():
        path, transpose = param_path(pname)
        for slot, want in (("exp_avg", mu[path]), ("exp_avg_sq", nu[path])):
            got = st[slot].numpy()
            require(np.array_equal(got.T if transpose else got, want) and st["step"].item()
                    == 4480, f"bridged asset: {slot} of {pname}")
    # TF1: the parameters before the step are ckpt4480's
    want = flat_tree(load_variables_npz(npz_path))
    got = flat_tree(seen["TF1"]["variables"])
    require(got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want),
            "TF1: the parameters before the first step differ from ckpt4480's")
    times["c"] = time.perf_counter() - t0
    print(f"workflow c. stage 2 restore: {n_det} detector parameters at step {s1.count} "
          f"(stage 1's count) with zero moments; bridged asset: moments bit-equal, count "
          f"4480; TF1: parameters equal to ckpt4480's ({times['c']:.2f} s)")
    print(f"[{card}] workflow stage 1 (cli.train --fused_towers --noattention --noregress, "
          f"{TRAIN_CLOUDS} x {TRAIN_POINTS} points): median {step_ms:.2f} ms between "
          f"consecutive metrics rows (one step each, its metrics read on the host), "
          f"{states['stage 1'].step} steps")

    # ---- 20d. histograms on the card ---------------------------------------------------
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(SEED)
    inputs = {"seeded": torch.randn(18, 512, generator=g) * 2.0 + 1.0,
              "counts": torch.randint(0, NS + 1, (18, 512), generator=g).float(),
              "constant": torch.full((64,), 3.0)}
    for name, x in inputs.items():
        xd = x.to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            h = device_histogram(xd)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        xs = x.numpy().reshape(-1).astype(np.float32)
        lo, hi = xs.min(), xs.max()
        width = np.maximum(hi - lo, np.float32(1e-12))
        bins = np.clip(((xs - lo) / width * np.float32(16)).astype(np.int32), 0, 15)
        want_counts = np.bincount(bins, minlength=16)
        require(np.array_equal(h["counts"].cpu().numpy(), want_counts)
                and h["lo"].item() == lo and h["hi"].item() == hi
                and h["num"].item() == xs.size, f"device_histogram {name}")
    times["d"] = time.perf_counter() - t0
    print(f"workflow d. device_histogram on {sorted(inputs)}: no host sync under "
          f"set_sync_debug_mode('error'), counts equal to numpy float32 ({times['d']:.2f} s)")

    # ---- 20e. entry() -----------------------------------------------------------------
    t0 = time.perf_counter()
    fn, example_args = entry()
    for w in (fps.farthest_point_sample, batch_group.ball_query_fused):
        w.launches = 0
    outs = fn(*example_args)
    torch.cuda.synchronize()
    got = {"fps": fps.farthest_point_sample.launches,
           "ball_query": batch_group.ball_query_fused.launches}
    require(all(v > 0 for v in got.values()), f"entry(): launches {got}")
    require([tuple(o.shape) for o in outs] == [(2, 512, 3), (2, 512, 32), (2, 512)]
            and all(bool(torch.isfinite(o).all()) for o in outs),
            f"entry(): outputs {[tuple(o.shape) for o in outs]}")
    times["e"] = time.perf_counter() - t0
    print(f"workflow e. entry(): fn(*example_args) on {example_args[1].device}, outputs "
          f"{[tuple(o.shape) for o in outs]} finite, launches {got} ({times['e']:.2f} s)")
    print(f"[{card}] workflow phase wall times (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    return {"data": data, "stage1": runs["stage 1"] + common, "step_ms": step_ms}


# ---- 21. data and point parallelism ------------------------------------------------


class CollectiveClock:
    """Counts and times (CUDA events on the current stream) every all-reduce
    and all-gather of the port's data-parallel step while active."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        import torch

        from feat3dnet_tpu_torch.ops import fused_train
        from feat3dnet_tpu_torch.train import trainer
        from feat3dnet_tpu_torch.utils import collectives

        self._saved = [(collectives, "all_reduce_", collectives.all_reduce_),
                       (fused_train, "all_reduce_", fused_train.all_reduce_),
                       (trainer, "all_reduce_", trainer.all_reduce_),
                       (trainer, "all_gather_rows", trainer.all_gather_rows)]

        def timed(kind, fn):
            def run(t, group):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(t, group)
                end.record()
                self.events.append((kind, t.numel(), start, end))
                return out
            return run

        for mod, name, fn in self._saved:
            setattr(mod, name, timed("all_gather" if "gather" in name else "all_reduce", fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def summary(self):
        """{kind: (count, ms, elements)} over the events recorded."""
        import torch

        torch.cuda.synchronize()
        out = {}
        for kind, n, start, end in self.events:
            c, ms, el = out.get(kind, (0, 0.0, 0))
            out[kind] = (c + 1, ms + start.elapsed_time(end), el + n)
        return out


def dp_rank_21b(rank, world, group, dev, variables, clouds):
    """Phase 21b's rank: one data-parallel fused step on its half of the
    combined batch; returns its loss, grads, K7-K10 launches and wall ms."""
    import torch

    from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import fused_train as tft
    from feat3dnet_tpu_torch.parallel import make_fused_dp_train_step, shard_batch
    from feat3dnet_tpu_torch.train import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(fused_towers=True, fused_cot_dtype=torch.float32)
    model = Feat3DNet(cfg, bn_group=group)
    state = init_state(model, TrainConfig(), cfg, variables=variables, device=dev)
    local = shard_batch(torch.from_numpy(clouds).to(dev), rank, world)
    step = make_fused_dp_train_step(model, cfg.margin, cfg.attention, group)
    wrappers = (tft.stats_pass, tft.final_pass, tft.bwd_top_pass, tft.bwd_pass)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, local)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"ms": ms, "loss": metrics["loss"].item(),
            "launches": [w.launches for w in wrappers],
            "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()}}


def parallel_phase(dev, card, npz_path):
    """Phase 21: a, b and c of the module's docstring."""
    import statistics

    import torch
    import torch.distributed as dist

    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, TrainConfig
    from feat3dnet_tpu_torch.data.augment import resolve_augmentations
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import batch_group, fused_describe, hash_grid
    from feat3dnet_tpu_torch.ops import fused_train as tft
    from feat3dnet_tpu_torch.parallel import make_fused_dp_train_step, run_ranks
    from feat3dnet_tpu_torch.train import init_state, make_fused_train_step
    from feat3dnet_tpu_torch.utils import init_variables, load_variables_npz

    t_phase = time.perf_counter()
    cfg, tcfg = ModelConfig(), TrainConfig()
    aug = tuple(resolve_augmentations(tcfg.augmentations, tcfg.upright_axis))
    stores = os.path.join(HERE, "build", "chip_smoke_ranks")
    os.makedirs(stores, exist_ok=True)

    def store(tag):
        path = os.path.join(stores, f"{tag}_{os.getpid()}")
        if os.path.exists(path):
            os.remove(path)
        return path

    def host(metrics):
        return [x for k in sorted(metrics) for x in (
            [metrics[k][f] for f in sorted(metrics[k])] if isinstance(metrics[k], dict)
            else [metrics[k]])]

    # ---- a. a one-rank nccl group ------------------------------------------------
    t_a = time.perf_counter()
    clouds = training_batch(dev, SEED + 200)
    variables = init_variables(cfg, seed=SEED)
    train_wrappers = (tft.stats_pass, tft.final_pass, tft.bwd_top_pass, tft.bwd_pass)
    dist.init_process_group("nccl", init_method="file://" + store("a"), world_size=1, rank=0)
    group = dist.group.WORLD
    try:
        states = {}
        for route in ("fused", "autograd"):
            rcfg = ModelConfig(fused_towers=route == "fused")
            runs = {}
            for kind in ("plain", "dp"):
                model = Feat3DNet(rcfg, bn_group=group if kind == "dp" else None)
                st = init_state(model, tcfg, rcfg, variables=variables, device=dev)
                make = (make_fused_train_step if kind == "plain" else
                        functools.partial(make_fused_dp_train_step, group=group))
                step = make(model, rcfg.margin, rcfg.attention, augmentations=aug, aug_seed=1)
                for w in train_wrappers:
                    w.launches = 0
                for _ in range(3):
                    st, met = step(st, clouds)
                torch.cuda.synchronize()
                launched = [w.launches for w in train_wrappers]
                runs[kind] = (st, step, met, launched)
            (sp, _, mp, lp), (sd, _, md, ld) = runs["plain"], runs["dp"]
            if route == "fused":
                require(min(ld) > 0, f"21a: the DP step launched K7-K10 {ld} times")
            require(all(torch.equal(x, y) for x, y in zip(sp.model.parameters(),
                                                           sd.model.parameters())),
                    f"21a {route}: params of the one-rank DP step differ from the plain step's")
            require(all(torch.equal(x, y) for x, y in zip(sp.model.buffers(),
                                                           sd.model.buffers())),
                    f"21a {route}: BN buffers differ")
            require(all(torch.equal(x, y) for x, y in zip(host(mp), host(md))),
                    f"21a {route}: metrics differ")
            print(f"21a {route} route: 3 steps of the one-rank nccl DP step bit-equal to the "
                  f"plain step (params, BN buffers, metrics; K7-K10 launches {ld}, plain {lp})")
            states[route] = runs
        # times: the fused route in turns, plain, DP, DP, plain (10 steps a block)
        for route, runs in states.items():
            per = {"plain": [], "dp": []}
            for kind in ("plain", "dp", "dp", "plain"):
                st, step = runs[kind][0], runs[kind][1]
                for _ in range(10):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(st, clouds)
                    torch.cuda.synchronize()
                    per[kind].append((time.perf_counter() - t0) * 1e3)
            with CollectiveClock() as clock:
                st, step = runs["dp"][0], runs["dp"][1]
                for _ in range(3):
                    step(st, clouds)
                summ = clock.summary()
            coll = ", ".join(f"{c // 3} {kind}s of {el // c} elements on average, "
                             f"{ms / 3:.3f} ms" for kind, (c, ms, el) in sorted(summ.items()))
            print(f"[{card}] 21a {route} route ({TRAIN_CLOUDS} x {TRAIN_POINTS} points, "
                  f"augmented): plain step median {statistics.median(per['plain']):.2f} ms, "
                  f"one-rank nccl DP step median {statistics.median(per['dp']):.2f} ms (20 "
                  f"steps each, in turns); per DP step: {coll}")
        del states, runs
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"[{card}] 21a wall {time.perf_counter() - t_a:.1f} s")

    # ---- b. two gloo ranks on cuda:0 ----------------------------------------------
    t_b = time.perf_counter()
    clouds_np = clouds.cpu().numpy()
    ranks = run_ranks(dp_rank_21b, 2, "gloo", devices=[dev, dev], init_file=store("b"),
                      args=(variables, clouds_np), timeout=900, collective_timeout=300)
    fcfg = ModelConfig(fused_towers=True, fused_cot_dtype=torch.float32)
    model = Feat3DNet(fcfg)
    st = init_state(model, tcfg, fcfg, variables=variables, device=dev)
    _, met = make_fused_train_step(model, fcfg.margin, fcfg.attention)(st, clouds)
    loss = met["loss"].item()
    want = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    noise = noise_leaves(want)
    del st, model
    for r, res in enumerate(ranks):
        require(min(res["launches"]) > 0, f"21b rank {r}: K7-K10 launched {res['launches']}")
        require(abs(res["loss"] - loss) <= 1e-5 * abs(loss),
                f"21b rank {r}: loss {res['loss']} vs one process {loss}")
        cos = {k: torch.nn.functional.cosine_similarity(res["grads"][k].flatten(),
                                                        w.flatten(), dim=0).item()
               for k, w in want.items() if k not in noise}
        worst = min(cos, key=cos.get)
        noise_max = max(res["grads"][k].abs().max().item() for k in noise)
        require(cos[worst] >= 0.999, f"21b rank {r}: cosine {cos[worst]:.6f} on {worst}")
        require(noise_max <= 1e-3, f"21b rank {r}: an analytically zero leaf at {noise_max}")
        print(f"21b rank {r}: loss {res['loss']:.7f} (one process {loss:.7f}), "
              f"worst leaf cosine {cos[worst]:.7f} on {worst} (>= 0.999), noise leaves max |g| "
              f"{noise_max:.2e}, K7-K10 launches {res['launches']}")
    print(f"[{card}] 21b two gloo ranks on one card (gloo on CUDA tensors, staged through "
          f"the host: a check, not a speed figure): first DP step {ranks[0]['ms']:.1f} / {ranks[1]['ms']:.1f} ms; wall "
          f"{time.perf_counter() - t_b:.1f} s")

    # ---- c. extraction on a mesh that names cuda:0 twice ---------------------------------
    t_c = time.perf_counter()
    trained = load_variables_npz(npz_path)
    kitti = [load_point_cloud(example_cloud_path(n)) for n in CLOUDS if n.startswith("kitti")]
    counted = {"K2": batch_group.ball_query_fused, "K4": hash_grid.sorted_ball_query,
               "K5": hash_grid.ball_max_sorted, "K6": fused_describe.fused_detect_clusters,
               "K3": fused_describe.fused_describe_clusters_t}
    need = {"default": ("K4", "K5"), "fused": ("K4", "K5", "K6", "K3"), "dense": ("K2",)}
    mesh = (dev, dev)
    for route, icfg in (("default", InferenceConfig()),
                        ("fused", InferenceConfig(use_fused_detector=True)),
                        ("dense", InferenceConfig(use_hashed_grouping=False))):
        model = Feat3DNet(cfg)
        single = InferencePipeline(model, trained, cfg, icfg, device=dev)
        meshed = InferencePipeline(model, None, cfg, icfg, mesh=mesh)
        want = [single.extract(c) for c in kitti]
        for w in counted.values():
            w.launches = 0
        got = [meshed.extract(c) for c in kitti]
        launched = {k: w.launches for k, w in counted.items()}
        require(all(launched[k] > 0 for k in need[route]),
                f"21c {route}: the mesh extract launched {launched}")
        for g, w in zip(got, want):
            require(g.num_keypoints == w.num_keypoints > 0
                    and all(np.array_equal(getattr(g, f), getattr(w, f))
                            for f in ("keypoints", "attention", "features")),
                    f"21c {route}: the mesh extract differs from extract")
        t0 = time.perf_counter()
        for c in kitti:
            single.extract(c)
        t_single = (time.perf_counter() - t0) * 1e3 / len(kitti)
        t0 = time.perf_counter()
        for c in kitti:
            meshed.extract(c)
        t_mesh = (time.perf_counter() - t0) * 1e3 / len(kitti)
        msg = (f"[{card}] 21c {route} route: mesh (cuda:0, cuda:0) extract on "
               f"{len(kitti)} KITTI clouds bit-equal to extract (keypoints {[g.num_keypoints for g in got]}); "
               f"launches {launched}; {t_mesh:.2f} ms a cloud against {t_single:.2f}")
        if route != "dense":
            cm = InferencePipeline(model, None, cfg, icfg, cloud_mesh=mesh)
            batch = kitti * 2
            for g, w in zip(cm.extract_batch(batch), want * 2):
                require(g.num_keypoints == w.num_keypoints
                        and all(np.array_equal(getattr(g, f), getattr(w, f))
                                for f in ("keypoints", "attention", "features")),
                        f"21c {route}: cloud_mesh extract_batch differs from extract")
            msg += "; cloud_mesh extract_batch of 4 over 2 shards bit-equal per cloud"
        print(msg)
        del single, meshed, model
    torch.cuda.empty_cache()
    print(f"[{card}] 21c wall {time.perf_counter() - t_c:.1f} s")
    print(f"[{card}] phase 21 wall {time.perf_counter() - t_phase:.1f} s")


# ---- 22. the point-op API on the card ------------------------------------------------

# per-centre radii of phase 22: uniform in [lo, hi) m, and one centre each at
# these radii
RADII_RANGE = (0.5, 3.0)
RADII_EDGES = (0.0, 1e-3, 1e3)
KNN_K = 16
FC_TOL = (1e-5, 1e-5)     # FullyConnected, card against CPU: rtol, atol


def centre_radii(b, m, seed, dev):
    """(b, m) f32 radii in RADII_RANGE from `seed`, the first centres (in
    row-major order) at RADII_EDGES."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    lo, hi = RADII_RANGE
    r = torch.rand(b, m, generator=g) * (hi - lo) + lo
    flat = r.view(-1)
    k = min(len(RADII_EDGES), flat.numel())
    flat[:k] = torch.tensor(RADII_EDGES[:k])
    return r.to(dev)


def prob_boundary_rule(got, want, probs, uniforms, share=1e-3, ulps=4):
    """(draws that differ, worst distance in ulp(total)): prob_sample's
    results on two devices may differ on at most `share` of the draws, each
    by one index, with its target within `ulps` ulp(row total) of the
    float64 cdf at the boundary between the two."""
    diff = np.nonzero(got != want)
    require(len(diff[0]) <= share * got.size and bool((np.abs(got[diff] - want[diff]) == 1).all()),
            f"prob_sample: {len(diff[0])} of {got.size} draws differ (or by more than 1)")
    cdf = np.cumsum(probs.astype(np.float64), axis=-1)
    ulp = np.spacing(probs.astype(np.float32).sum(-1, dtype=np.float32))
    rows, cols = diff
    k = np.minimum(got[diff], want[diff])
    dist = np.abs(uniforms[rows, cols].astype(np.float64) * cdf[rows, -1] - cdf[rows, k]) \
        / ulp[rows]
    worst = float(dist.max()) if dist.size else 0.0
    require(worst <= ulps, f"prob_sample: a differing draw {worst:.2f} ulp from its boundary")
    return len(diff[0]), worst


def point_api_calls(xyz, mask, ori):
    """{call: its outputs} of the point-op API on one cloud (1, N, 3), on
    xyz's device: FPS centres, sample_and_group with each option (mask
    (1, N), orientations (1, NPOINT)), and ops.ball_query with per-centre
    radii (centre_radii) at those centres."""
    from feat3dnet_tpu_torch import ops

    ctr = ops.sample_points(xyz, NPOINT)
    kp = (ctr + 0.3).contiguous()
    radii = centre_radii(1, NPOINT, SEED + 50, xyz.device)

    def sag(**kw):
        return ops.sample_and_group(NPOINT, RADIUS, NS, xyz, **kw)
    return {"sample_points": (ctr,),
            "fps": sag(),
            "fps, masked": sag(valid_mask=mask),
            "fps, not normalized": sag(normalize_radius=False),
            "keypoints": sag(keypoints=kp),
            "keypoints, orientations": sag(keypoints=kp, orientations=ori),
            "keypoints, orientations, not normalized": sag(keypoints=kp, orientations=ori,
                                                           normalize_radius=False),
            "ball_query radii": ops.ball_query(xyz, ctr, radii, NS)}


def point_api_phase(dev, card, gpu, cpu):
    """Phase 22: (a) K2's per-centre form index-exact against its plain
    version on k2_cases' inputs and bit-equal to the scalar form at equal
    radii; then, counters reset, the slice's path (sample_points,
    sample_and_group and per-centre ops.ball_query on the vendored clouds,
    `gpu` / `cpu` by name); (b) those calls against the same calls on the
    CPU, sample_and_group_all exact; (c) knn_points; (d) prob_sample; (e)
    FullyConnected and dropout; then the per-centre launch timed in turns
    against the scalar launch and the plain version. Returns ({
    "ball_query_radii": the kernels line's numbers}, its launches)."""
    import torch

    from feat3dnet_tpu_torch import ops
    from feat3dnet_tpu_torch.models.layers import FullyConnected, dropout
    from feat3dnet_tpu_torch.ops import batch_group, fps

    t_phase = time.perf_counter()
    bq = batch_group.ball_query_fused

    # (a) K2's per-centre form against its plain version
    for i, (name, (xyz, ctr, mask)) in enumerate(k2_case_inputs(dev).items()):
        radii = centre_radii(ctr.shape[0], ctr.shape[1], SEED + 30 + i, dev)
        ik, ck = bq(xyz, ctr, radii, NS, mask)
        ip, cp = bq.plain(xyz, ctr, radii, NS, mask)
        require(torch.equal(ik, ip) and torch.equal(ck, cp), f"K2 radii != plain on {name}")
        same = torch.full_like(radii, RADIUS)
        (ie, ce), (i_s, cs) = bq(xyz, ctr, same, NS, mask), bq(xyz, ctr, RADIUS, NS, mask)
        require(torch.equal(ie, i_s) and torch.equal(ce, cs),
                f"K2: every radius {RADIUS} != the scalar launch on {name}")
        print(f"K2 ball_query_radii {name} {tuple(xyz.shape)} x {ctr.shape[1]} (radii "
              f"{RADII_RANGE}, edges {RADII_EDGES}; mean cnt {ck.float().mean().item():.2f}): "
              f"index-exact vs plain; all radii {RADIUS}: bit-equal to the scalar launch")
        torch.cuda.empty_cache()

    # the slice's path, counters from zero
    g = torch.Generator(device="cpu").manual_seed(SEED + 40)
    inputs = {}
    for name in CLOUDS:
        n = gpu[name].shape[1]
        inputs[name] = {"mask": torch.rand(1, n, generator=g) > 0.2,
                        "ori": (torch.rand(1, NPOINT, generator=g) * 2 - 1) * np.pi}
    fps.farthest_point_sample.launches = bq.launches = 0
    bq.mode_launches = dict.fromkeys(bq.mode_launches, 0)
    with torch.no_grad():
        card_out = {name: point_api_calls(gpu[name], inputs[name]["mask"].to(dev),
                                          inputs[name]["ori"].to(dev)) for name in CLOUDS}
        torch.cuda.synchronize()
    launches = {"fps": fps.farthest_point_sample.launches, **bq.mode_launches}
    print(f"point-op API path launches: {launches}")
    require(all(v > 0 for v in launches.values()),
            "K1, K2 and K2's per-centre form must launch on the point-op API path")

    # (b) the same calls on the CPU
    worst = 0.0
    for name in CLOUDS:
        want = point_api_calls(cpu[name], inputs[name]["mask"], inputs[name]["ori"])
        for call, w in want.items():
            got = [t.cpu() for t in card_out[name][call]]
            exact = [0, 2, 3] if len(w) == 4 else range(len(w))
            require(all(torch.equal(got[i], w[i]) for i in exact),
                    f"{call} on {name}: card != CPU (centres, idx, cnt)")
            if len(w) == 4:
                err = (got[1] - w[1]).abs().max().item()
                worst = max(worst, err)
                require(err <= 1e-6, f"{call} on {name}: grouped card vs CPU {err:.3e} > 1e-6")
        ca, ga, ia = ops.sample_and_group_all(gpu[name])
        n = gpu[name].shape[1]
        require(torch.equal(ca.cpu(), torch.zeros(1, 1, 3)) and torch.equal(ga[:, 0], gpu[name])
                and torch.equal(ia.cpu(), torch.arange(n, dtype=torch.int32).expand(1, 1, n)),
                f"sample_and_group_all on {name}")
        require(torch.equal(ops.sample_points(gpu[name], 0), gpu[name]), "sample_points(0)")
    print(f"point-op API on the card vs the CPU, {len(CLOUDS)} clouds x {len(want)} calls "
          f"({NPOINT} x {NS}, r {RADIUS}): centres, idx and cnt exact, grouped max|d| "
          f"{worst:.3e} (<= 1e-6); sample_and_group_all exact")

    # (c) knn_points on the training batch (and a cloud with duplicates)
    xyz_t = training_batch(dev, SEED)
    ctr_t = ops.sample_points(xyz_t, NPOINT)
    dup = xyz_t[:1].clone()
    dup[:, TRAIN_POINTS // 2:] = dup[:, :TRAIN_POINTS // 2]
    for name, (x, c) in {"training batch": (xyz_t, ctr_t),
                         "duplicated points": (dup, ctr_t[:1].contiguous())}.items():
        t0 = time.perf_counter()
        dk, ik = ops.knn_points(KNN_K, x, c)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        dc, ic = ops.knn_points(KNN_K, x.cpu(), c.cpu())
        require(torch.equal(ik.cpu(), ic) and torch.equal(dk.cpu(), dc),
                f"knn_points on {name}: card != CPU")
        print(f"[{card}] knn_points k={KNN_K} {name} {tuple(x.shape)} x {c.shape[1]}: idx and "
              f"dist2 equal to the CPU's; {ms:.3f} ms (host clock, one call)")
    del xyz_t, ctr_t, dup
    torch.cuda.empty_cache()

    # (d) prob_sample
    rs = np.random.RandomState(SEED + 60)
    probs = rs.rand(4, 5000).astype(np.float32)
    u = rs.rand(4, 2000).astype(np.float32)
    got = ops.prob_sample(torch.from_numpy(probs).to(dev), torch.from_numpy(u).to(dev))
    want = ops.prob_sample(torch.from_numpy(probs), torch.from_numpy(u))
    require(got.dtype == torch.int32, "prob_sample: int32")
    nd, far = prob_boundary_rule(got.cpu().numpy(), want.numpy(), probs, u)
    dy = rs.randint(0, 6, (4, 5000)).astype(np.float32)
    require(torch.equal(ops.prob_sample(torch.from_numpy(dy).to(dev),
                                        torch.from_numpy(u).to(dev)).cpu(),
                        ops.prob_sample(torch.from_numpy(dy), torch.from_numpy(u))),
            "prob_sample on dyadic weights: card != CPU")
    print(f"prob_sample 4 x 5000 random weights, 4 x 2000 draws: {nd} draws differ from the "
          f"CPU (<= 1e-3 of them, each by one index), the farthest {far:.2f} ulp(total) from "
          "its boundary (<= 4); dyadic weights index-exact")

    # (e) FullyConnected and dropout
    torch.manual_seed(SEED)
    rtol, atol = FC_TOL
    x = torch.randn(4096, 32, generator=torch.Generator().manual_seed(SEED + 70))
    for use_bn, act in ((False, torch.relu), (True, torch.relu), (True, None)):
        fc_c = FullyConnected(32, 64, use_bn=use_bn, activation=act)
        if use_bn:
            with torch.no_grad():
                fc_c.bn.mean.normal_(0.0, 0.2)
                fc_c.bn.var.uniform_(0.5, 2.0)
                fc_c.bn.scale.uniform_(0.5, 1.5)
        fc_g = FullyConnected(32, 64, use_bn=use_bn, activation=act).to(dev)
        fc_g.load_state_dict(fc_c.state_dict())
        for training in (False, True) if use_bn else (False,):
            with torch.no_grad():
                yc, yg = fc_c(x, training), fc_g(x.to(dev), training).cpu()
            err = ((yg - yc).abs() - rtol * yc.abs()).max().item()
            require(err <= atol, f"FullyConnected use_bn={use_bn} training={training}: card "
                    f"vs CPU beyond rtol {rtol} by {err:.3e} > atol {atol}")
            for k in ("mean", "var") if training else ():
                a, b = getattr(fc_g.bn, k).cpu(), getattr(fc_c.bn, k)
                require(torch.allclose(a, b, rtol=rtol, atol=atol),
                        f"FullyConnected BN {k}: card vs CPU")
            print(f"FullyConnected(32, 64, use_bn={use_bn}, activation="
                  f"{'relu' if act else None}) training={training} on 4096 rows: card vs CPU "
                  f"within rtol {rtol}, atol {atol} (excess {err:.3e})")
    xd = torch.randn(1024, 1024, device=dev)
    y1 = dropout(xd, torch.Generator(device=dev).manual_seed(SEED), keep_prob=0.5)
    y2 = dropout(xd, torch.Generator(device=dev).manual_seed(SEED), keep_prob=0.5)
    kept = y1 != 0
    share = kept.float().mean().item()
    require(abs(share - 0.5) < 0.005 and torch.equal(y1, y2)
            and torch.equal(y1[kept], xd[kept] / 0.5)
            and dropout(xd, None, training=False) is xd, "dropout's contract on the card")
    print(f"dropout keep_prob 0.5 on 1024 x 1024: kept share {share:.5f} (0.5 +- 0.005), kept "
          "values x / keep_prob exactly, same seed same mask, identity when not training")

    # the per-centre launch against the scalar launch and the plain version
    per, bounds = [], []
    for name in CLOUDS:
        x = gpu[name]
        ctr = card_out[name]["sample_points"][0]
        radii = centre_radii(1, NPOINT, SEED + 50, dev)
        ik, ck = bq(x, ctr, radii, NS)
        n = x.shape[1]
        scanned = torch.where(ck >= NS, ik[..., NS - 1].long() + 1,
                              torch.full_like(ck, n).long()).sum().item()
        bounds.append(bound_ms(8.0 * scanned, nbytes(x, ctr, radii, ik, ck)))
        ms = ms_in_turns({"radii": lambda: bq(x, ctr, radii, NS),
                          "scalar": lambda: bq(x, ctr, RADIUS, NS),
                          "plain": lambda: bq.plain(x, ctr, radii, NS)}, 10)
        same = torch.full_like(radii, RADIUS)
        dev_ms = graph_ms({"radii": lambda: bq(x, ctr, radii, NS),
                           "scalar": lambda: bq(x, ctr, RADIUS, NS),
                           "same": lambda: bq(x, ctr, same, NS)}, 20)
        per.append((ms["radii"], ms["plain"]))
        print(f"[{card}] ball_query_radii {name} N={n} x {NPOINT} (radii {RADII_RANGE}): "
              f"per-centre {ms['radii']:.4f} ms, scalar (r {RADIUS}) {ms['scalar']:.4f} ms, "
              f"plain {ms['plain']:.4f} ms (wrappers, in turns); on the device alone "
              f"per-centre {dev_ms['radii']:.4f}, scalar {dev_ms['scalar']:.4f}, per-centre "
              f"at every radius {RADIUS} {dev_ms['same']:.4f} ms (the same scans: the "
              f"per-centre form's own cost); bound "
              f"{bounds[-1][0]:.4f} ms ({bounds[-1][1]}; 8 flop x {scanned} points scanned)")
    report = {"max_abs_err": 0, "ms": float(np.mean([p[0] for p in per])),
              "plain_ms": float(np.mean([p[1] for p in per]))}
    report["bound_ms"], report["bound_by"] = mean_bound(bounds)
    print(f"[{card}] phase 22 (the point-op API): {time.perf_counter() - t_phase:.1f} s")
    return {"ball_query_radii": report}, {"ball_query_radii": launches["radii"]}


# ---- 23. the training modes ------------------------------------------------------------------
MODE_K = 4             # steps a chained call in phase 23
MODE_STEPS = 3         # timed steps a memory mode


def host_tree(tree):
    """A metrics tree on the host (numpy), for bit-equality checks."""
    return {k: host_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def trees_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def state_equal(s1, s2):
    """Parameters, BN buffers and Adam's moments and steps bit-equal."""
    import torch

    m1, m2 = s1.model, s2.model
    if not (all(torch.equal(x, y) for x, y in zip(m1.parameters(), m2.parameters()))
            and all(torch.equal(x, y) for x, y in zip(m1.buffers(), m2.buffers()))
            and (s1.step, s1.count) == (s2.step, s2.count)):
        return False
    for p, q in zip(m1.parameters(), m2.parameters()):
        a, b = s1.optimizer.state[p], s2.optimizer.state[q]
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
            return False
    return True


def metrics_rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_rows(tag, log_dir, steps, attention):
    """Phase 20c's rules on a cli.train run's rows; returns them without ts."""
    rows = metrics_rows(log_dir)
    require(len(rows) == steps and all(np.isfinite(r["loss"]) for r in rows),
            f"{tag}: {len(rows)} rows for {steps} steps, losses {[r.get('loss') for r in rows]}")
    for r in rows:
        h = r["hist_det_cnt"]
        require(len(h["counts"]) == 16 and sum(h["counts"]) == h["num"] and h["hi"] <= NS,
                f"{tag}: hist_det_cnt {h}")
        require(("hist_normalized_attention" in r) == attention,
                f"{tag}: hist_normalized_attention in {sorted(r)}")
    with open(os.path.join(log_dir, "log.txt")) as f:
        require("Arguments" in f.read(), f"{tag}: no Arguments line in log.txt")
    return [{k: v for k, v in r.items() if k != "ts"} for r in rows]


def row_gap_ms(log_dir):
    return float(np.median(np.diff([r["ts"] for r in metrics_rows(log_dir)]) * 1e3))


def profiled_busy(fn):
    """(wall ms, device busy ms) of one call of fn under torch.profiler."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, busy


def training_modes_phase(dev, card, workflow):
    """Phase 23: a-e of the module docstring, at the paper config and
    TrainConfig() widths."""
    import io
    import shutil

    import torch
    import torch.distributed as dist

    from feat3dnet_tpu_torch.cli import train as train_cli
    from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
    from feat3dnet_tpu_torch.data.augment import resolve_augmentations
    from feat3dnet_tpu_torch.data.datagenerator import TripletDataset
    from feat3dnet_tpu_torch.data.quant import quantize_clouds
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import batch_group, fps
    from feat3dnet_tpu_torch.ops import fused_train as ft
    from feat3dnet_tpu_torch.parallel import make_chained_dp_train_step
    from feat3dnet_tpu_torch.train import (init_state, make_chained_train_step,
                                           make_fused_train_step)
    from feat3dnet_tpu_torch.train.trainer import dequantize, upload
    from feat3dnet_tpu_torch.utils import init_variables, native

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "chip_smoke_modes")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg, tcfg = ModelConfig(), TrainConfig()
    aug = tuple(resolve_augmentations(tcfg.augmentations, tcfg.upright_axis))
    variables = init_variables(cfg, seed=SEED)
    wrappers = {"fps": fps.farthest_point_sample, "ball_query": batch_group.ball_query_fused,
                "train_stats": ft.stats_pass, "train_final": ft.final_pass,
                "train_bwd_top": ft.bwd_top_pass, "train_bwd": ft.bwd_pass}
    times = {}

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def cli_run(tag, args):
        with contextlib.redirect_stdout(io.StringIO()):
            return train_cli.main(args)

    # ---- 23a. the native reader --------------------------------------------------------
    t0 = time.perf_counter()
    built = native.build()
    meta = os.path.join(workflow["data"], "train", "train.txt")
    ds = TripletDataset(meta)
    require(ds.use_native, "23a: TripletDataset('auto') did not take the native reader")
    batch = tcfg.batch_size
    got = ds.epoch_triplets(0, batch, TRAIN_POINTS)
    order, rng = ds.epoch_order(0), np.random.RandomState((ds.seed, 0, ds.shard_index, 0xA5))
    for start in (0, batch):
        ids = []
        for anchor in order[start:start + batch]:
            ids.extend((int(anchor),) + ds.sample_triplet_indices(int(anchor), rng))
        seeds = [int(rng.randint(0, 2 ** 31)) for _ in ids]
        want = np.stack([native.load_processed(os.path.join(ds.folder, ds.meta[i].fname),
                                               ds.num_cols, tcfg.crop_radius, TRAIN_POINTS, s)
                         for i, s in zip(ids, seeds)]).reshape(batch, 3, TRAIN_POINTS, -1)
        require(all(np.array_equal(x, want[:, r]) for r, x in enumerate(next(got))),
                f"23a: the native batch at {start} differs from per-cloud load_processed")
    readers = {"native": ds, "numpy": TripletDataset(meta, use_native="no")}
    read_ms = {k: [] for k in readers}
    for rnd in range(5):
        for k in (("numpy", "native", "native", "numpy") if rnd % 2 else
                  ("native", "numpy", "numpy", "native")):
            t1 = time.perf_counter()
            next(readers[k].epoch_triplets(rnd, batch, TRAIN_POINTS))
            read_ms[k].append((time.perf_counter() - t1) * 1e3)
    native_run = os.path.join(root, "stage1_native")
    args = list(workflow["stage1"])
    args[args.index("--log_dir") + 1] = native_run
    zero()
    cli_run("23a", args)
    require(all(v > 0 for v in counts().values()), f"23a cli.train: launches {counts()}")
    native_rows = check_rows("23a cli.train stage 1 (native)", native_run, 8, False)
    with open(os.path.join(native_run, "log.txt")) as f:
        require("Triplet reader: native" in f.read(), "23a: log.txt does not name the native reader")
    times["a"] = time.perf_counter() - t0
    print(f"23a. native reader: built in {built.seconds:.2f} s ({os.path.relpath(built.path, HERE)}); "
          "TripletDataset('auto') takes it; 2 batches of phase 20's dataset equal per-cloud "
          f"load_processed with the epoch's seeds ({times['a']:.2f} s)")
    print(f"[{card}] 23a. a batch of {batch} triplets x {TRAIN_POINTS} points (first batch of a "
          f"fresh epoch, 10 each in turns): native median {np.median(read_ms['native']):.3f} ms "
          f"(min {min(read_ms['native']):.3f}), numpy {np.median(read_ms['numpy']):.3f} ms "
          f"(min {min(read_ms['numpy']):.3f})")
    print(f"[{card}] 23a. cli.train stage 1 (phase 20's flags) on the native reader: median "
          f"{row_gap_ms(native_run):.2f} ms between consecutive metrics rows; phase 20 on numpy "
          f"{workflow['step_ms']:.2f} ms")

    # ---- 23b. the chained step ---------------------------------------------------------
    t0 = time.perf_counter()
    clouds_k = torch.stack([training_batch(dev, SEED + 300 + j) for j in range(MODE_K)])
    chained_ms = {}
    for route in ("fused", "autograd"):
        rcfg = ModelConfig(fused_towers=route == "fused")
        states = {k: init_state(Feat3DNet(rcfg), tcfg, rcfg, variables=variables, device=dev)
                  for k in ("chained", "loop")}
        chained = make_chained_train_step(states["chained"].model, rcfg.margin, rcfg.attention,
                                          augmentations=aug, aug_seed=1)
        single = make_fused_train_step(states["loop"].model, rcfg.margin, rcfg.attention,
                                       augmentations=aug, aug_seed=1)
        zero()
        metrics = []
        for j in range(MODE_K):
            metrics.append(host_tree(single(states["loop"], clouds_k[j])[1]))
        torch.cuda.synchronize()
        loop_counts = counts()
        zero()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, met_k = chained(states["chained"], clouds_k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        chain_counts = counts()
        met_k = host_tree(met_k)
        require(state_equal(states["chained"], states["loop"]),
                f"23b {route}: the chained call's state differs from {MODE_K} fused calls'")
        require(all(trees_equal({k: (v[j] if not isinstance(v, dict) else
                                     {f: x[j] for f, x in v.items()})
                                 for k, v in met_k.items()}, metrics[j])
                    for j in range(MODE_K)), f"23b {route}: metrics differ")
        require(chain_counts == loop_counts and loop_counts["fps"] == MODE_K
                and (route == "autograd" or min(loop_counts[k] for k in wrappers
                                                if k.startswith("train")) > 0),
                f"23b {route}: launches chained {chain_counts}, loop {loop_counts}")
        one = {k: v // MODE_K for k, v in loop_counts.items()}
        print(f"23b. {route}: one chained call of {MODE_K} steps under "
              "set_sync_debug_mode('error') bit-equal to 4 fused calls (params, BN buffers, "
              f"Adam moments, metrics); launches {chain_counts} = {MODE_K} x {one}")

        def run_chained():
            chained(states["chained"], clouds_k)

        def run_loop():
            for j in range(MODE_K):
                single(states["loop"], clouds_k[j])

        per = {"chained": [], "loop": []}
        for kind in ("loop", "chained", "chained", "loop") * 2:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (run_chained if kind == "chained" else run_loop)()
            torch.cuda.synchronize()
            per[kind].append((time.perf_counter() - t1) * 1e3 / MODE_K)
        busy = {k: profiled_busy(f) for k, f in (("chained", run_chained), ("loop", run_loop))}
        chained_ms[route] = per
        print(f"[{card}] 23b. {route} route, ms per step ({MODE_K} steps a call, 4 calls each in "
              "turns, synchronised): chained " + ", ".join(f"{x:.2f}" for x in per["chained"])
              + " (median " + f"{np.median(per['chained']):.2f}), loop of fused calls "
              + ", ".join(f"{x:.2f}" for x in per["loop"])
              + f" (median {np.median(per['loop']):.2f}); profiled: chained busy "
              f"{busy['chained'][1]:.2f} of {busy['chained'][0]:.2f} ms "
              f"({100 * busy['chained'][1] / busy['chained'][0]:.1f} %), loop "
              f"{busy['loop'][1]:.2f} of {busy['loop'][0]:.2f} ms "
              f"({100 * busy['loop'][1] / busy['loop'][0]:.1f} %)")
        del states, chained, single
    # a one-rank nccl chained data-parallel step against the plain chained step
    store = os.path.join(root, f"store_{os.getpid()}")
    dist.init_process_group("nccl", init_method="file://" + store, world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        for route in ("fused", "autograd"):
            rcfg = ModelConfig(fused_towers=route == "fused")
            sp = init_state(Feat3DNet(rcfg), tcfg, rcfg, variables=variables, device=dev)
            sd = init_state(Feat3DNet(rcfg, bn_group=group), tcfg, rcfg, variables=variables,
                            device=dev)
            _, mp = make_chained_train_step(sp.model, rcfg.margin, rcfg.attention,
                                            augmentations=aug, aug_seed=1)(sp, clouds_k)
            _, md = make_chained_dp_train_step(sd.model, rcfg.margin, rcfg.attention, group,
                                               augmentations=aug, aug_seed=1)(sd, clouds_k)
            require(state_equal(sp, sd) and trees_equal(host_tree(mp), host_tree(md)),
                    f"23b {route}: the one-rank chained DP step differs from the chained step")
            del sp, sd
        print(f"23b. one-rank nccl chained DP step ({MODE_K} steps) bit-equal to the chained "
              "step on both routes (params, BN buffers, Adam moments, metrics)")
    finally:
        dist.destroy_process_group()
    times["b"] = time.perf_counter() - t0

    # ---- 23c. the int16 upload ---------------------------------------------------------
    t0 = time.perf_counter()
    host = training_batch(torch.device("cpu"), SEED + 400).numpy()
    q, scale = quantize_clouds(host)
    qd, sd_ = upload(host, dev, quant=True)
    deq = dequantize((qd, sd_)).cpu().numpy()
    require(np.array_equal(deq, q.astype(np.float32) * scale),
            "23c: the card's dequantized batch differs from the host's q * scale")
    rcfg = ModelConfig(fused_towers=True)
    s1 = init_state(Feat3DNet(rcfg), tcfg, rcfg, variables=variables, device=dev)
    s2 = init_state(Feat3DNet(rcfg), tcfg, rcfg, variables=variables, device=dev)
    _, m1 = make_fused_train_step(s1.model, rcfg.margin, rcfg.attention, augmentations=aug,
                                  aug_seed=1)(s1, (qd, sd_))
    _, m2 = make_fused_train_step(s2.model, rcfg.margin, rcfg.attention, augmentations=aug,
                                  aug_seed=1)(s2, torch.from_numpy(deq).to(dev))
    require(state_equal(s1, s2) and trees_equal(host_tree(m1), host_tree(m2)),
            "23c: a fused step from (q, scale) differs from one from its f32 batch")
    del s1, s2
    copy_ms = {"f32": [], "int16": []}
    quant_ms = []
    for rnd in range(10):
        for kind in (("f32", "int16") if rnd % 2 else ("int16", "f32")):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if kind == "f32":
                torch.from_numpy(host).to(dev)
            else:
                torch.from_numpy(q).to(dev)
                torch.from_numpy(np.asarray(scale, np.float32)).to(dev)
            torch.cuda.synchronize()
            copy_ms[kind].append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        quantize_clouds(host)
        quant_ms.append((time.perf_counter() - t1) * 1e3)
    times["c"] = time.perf_counter() - t0
    print(f"23c. int16 upload: the card's q * scale equals the host's bit for bit; a fused "
          f"step from (q, scale) equals one from that f32 batch ({times['c']:.2f} s)")
    print(f"[{card}] 23c. upload of one {tuple(host.shape)} batch (pageable, synchronised, 10 "
          f"each in turns): f32 {host.nbytes} bytes median {np.median(copy_ms['f32']):.4f} ms; "
          f"int16 {q.nbytes} + 4 bytes median {np.median(copy_ms['int16']):.4f} ms (q and scale); "
          f"quantize_clouds on the host median {np.median(quant_ms):.4f} ms")

    # ---- 23d. the memory modes on the autograd route -------------------------------------
    t0 = time.perf_counter()
    clouds = clouds_k[0]
    modes = {"plain": ({}, False), "remat_towers": ({"remat_towers": True}, False),
             "residual_dtype": ({"residual_dtype": torch.bfloat16}, False),
             "remat": ({}, True)}
    mem = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        first = {}
        for mode, (kw, remat) in modes.items():
            mcfg = ModelConfig(compute_dtype=dtype, **kw)
            st = init_state(Feat3DNet(mcfg), tcfg, mcfg, variables=variables, device=dev)
            step = make_fused_train_step(st.model, mcfg.margin, mcfg.attention, remat=remat)
            _, met = step(st, clouds)
            first[mode] = (met["loss"].item(),
                           {k: p.grad.detach().clone() for k, p in st.model.named_parameters()},
                           [b.detach().clone() for b in st.model.buffers()])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            per = []
            for _ in range(MODE_STEPS):
                t1 = time.perf_counter()
                step(st, clouds)
                torch.cuda.synchronize()
                per.append((time.perf_counter() - t1) * 1e3)
            mem[dname, mode] = (torch.cuda.max_memory_allocated() / 2 ** 30, float(np.median(per)))
            del st, step
            torch.cuda.empty_cache()
        if dname == "float32":
            first_f32 = first
        lp, gp, bp = first["plain"]
        for mode in ("remat_towers", "remat"):
            lm, gm, bm = first[mode]
            require(lm == lp and all(torch.equal(gm[k], gp[k]) for k in gp)
                    and all(torch.equal(x, y) for x, y in zip(bm, bp)),
                    f"23d {dname} {mode}: loss, gradients or BN buffers differ from plain")
        print(f"23d. {dname}: remat_towers and remat bit-equal to plain autograd (loss, every "
              "gradient, BN buffers after one step: the EMA once)")
    # residual_dtype on the card: packing the saved tensors changes nothing
    # (bit-equal to the same squash points through plain autograd), and the
    # step against the CPU's step of the same mode
    from feat3dnet_tpu_torch.models import feat3dnet as model_module

    rcfg = ModelConfig(residual_dtype=torch.bfloat16)
    packed_at = model_module._maybe_remat
    model_module._maybe_remat = lambda per_point, c, training: per_point
    try:
        st = init_state(Feat3DNet(rcfg), tcfg, rcfg, variables=variables, device=dev)
        _, met = make_fused_train_step(st.model, rcfg.margin, rcfg.attention)(st, clouds)
    finally:
        model_module._maybe_remat = packed_at
    loss_card, resid_card = first_f32["residual_dtype"][0], first_f32["residual_dtype"][1]
    require(met["loss"].item() == loss_card and all(
        torch.equal(p.grad, resid_card[k]) for k, p in st.model.named_parameters()),
        "23d residual_dtype: the packed step differs from the same squash points unpacked")
    st = init_state(Feat3DNet(rcfg), tcfg, rcfg, variables=variables, device="cpu")
    t1 = time.perf_counter()
    _, met = make_fused_train_step(st.model, rcfg.margin, rcfg.attention)(st, clouds.cpu())
    cpu_s = time.perf_counter() - t1
    loss_cpu = met["loss"].item()
    resid_cpu = {k: p.grad for k, p in st.model.named_parameters()}
    zeros = {k for k in resid_cpu if k.endswith("conv2d.bias") and ".conv" in k} | {
        f"description.conv_mid_{len(rcfg.descriptor_mlp2) - 1}.bn.bias"}
    cos = {k: torch.nn.functional.cosine_similarity(resid_card[k].cpu().flatten(),
                                                    g.flatten(), dim=0).item()
           for k, g in resid_cpu.items() if k not in zeros}
    worst = sorted(cos, key=cos.get)[:3]
    zmax = max(max(resid_card[k].abs().max().item(), resid_cpu[k].abs().max().item())
               for k in zeros)
    require(abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu),
            f"23d residual_dtype: loss on the card {loss_card} vs the CPU {loss_cpu}")
    del st
    times["d"] = time.perf_counter() - t0
    print(f"23d. residual_dtype (bf16), one step: packed bit-equal to unpacked on the card; "
          f"loss card {loss_card:.7f} vs CPU {loss_cpu:.7f} (rel <= 1e-4); gradients card vs "
          "CPU (not gated: the squash points round the two devices' f32 sums to bf16 with "
          "other flips) worst cosine " + ", ".join(f"{k} {cos[k]:.6f}" for k in worst)
          + f", analytic zeros max |g| {zmax:.2e}; CPU step {cpu_s:.1f} s")
    for (dname, mode), (gib, ms) in mem.items():
        print(f"[{card}] 23d. autograd route {dname} {mode}: peak {gib:.3f} GiB, step "
              f"{ms:.2f} ms (median of {MODE_STEPS}; plain {mem[dname, 'plain'][0]:.3f} GiB, "
              f"{mem[dname, 'plain'][1]:.2f} ms)")

    # ---- 23e. cli.train with the modes ---------------------------------------------------
    t0 = time.perf_counter()
    base = [a for a in workflow["stage1"]]
    runs = {"chained": ["--steps_per_dispatch", str(MODE_K)],
            "int16": ["--upload_quant", "int16"],
            "chained int16": ["--steps_per_dispatch", str(MODE_K), "--upload_quant", "int16"],
            "remat_towers": ["--remat_towers"],
            "bf16 residual": ["--compute_dtype", "bfloat16", "--residual_dtype", "bfloat16"]}
    rows = {}
    for name, extra in runs.items():
        args = list(base)
        log_dir = os.path.join(root, name.replace(" ", "_"))
        args[args.index("--log_dir") + 1] = log_dir
        if name in ("remat_towers", "bf16 residual"):
            args.remove("--fused_towers")
        zero()
        cli_run(name, args + extra)
        got = counts()
        fused_run = "--fused_towers" in args
        require(got["fps"] > 0 and got["ball_query"] > 0
                and (not fused_run or min(got[k] for k in wrappers if k.startswith("train")) > 0),
                f"23e cli.train {name}: launches {got}")
        rows[name] = check_rows(f"23e cli.train {name}", log_dir, 8, False)
        print(f"23e. cli.train {' '.join(extra)}: 8 rows, losses "
              f"{[round(r['loss'], 4) for r in rows[name]]}, launches {got}")
    require(rows["chained"] == native_rows,
            f"23e: --steps_per_dispatch {MODE_K} rows differ from --steps_per_dispatch 1's")
    require(rows["chained int16"] == rows["int16"],
            f"23e: --steps_per_dispatch {MODE_K} --upload_quant int16 rows differ from "
            "--upload_quant int16's")
    times["e"] = time.perf_counter() - t0
    print(f"23e. --steps_per_dispatch {MODE_K}: rows and losses bit-equal to one step a call, "
          f"with and without --upload_quant int16 ({times['e']:.2f} s)")
    print(f"[{card}] phase 23 (training modes) wall {time.perf_counter() - t_phase:.1f} s; "
          "sub-phases (s): " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))


RECIPE_DIR = os.path.join(HERE, "feat3dnet_tpu_torch", "examples", "results", "scaled_accuracy",
                          "autograd_seed0")   # the committed port-trained run
RECIPE_PLACES, RECIPE_EPOCHS = 48, (1, 4)     # 32 + 128 steps of 6 triplets
RECIPE_TEST_PAIRS = 8                         # held-out pairs of 24a (24b takes all 24)
JAX_SUMMARY = os.path.join(HERE, "examples", "results", "scaled_accuracy", "summary.json")


def recipe_phase(dev, card):
    """Phase 24: the accuracy programs (feat3dnet_tpu_torch/examples/).
    a. scaled_accuracy_run.main at smoke size on the fused route (8 held-out
       pairs, so that the phase stays within 90 s): both stages
       ran every step, stage 2 restored stage 1 minus `detection` at stage
       1's count, K1, K2 and K7-K10 launched in training and K4, K5 in the
       evaluation, and every section of the JAX summary.json present with
       finite values;
    b. the committed port-trained weights (RECIPE_DIR's variables.npz) at
       kp1024_ratio0_nms02 on both extraction routes (K3 and K6 launched on
       the fused one), held to that run's committed summary at phase 18's
       limits."""
    import shutil

    import torch

    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, TrainConfig
    from feat3dnet_tpu_torch.eval.heldout import build_test_set, evaluate_setting
    from feat3dnet_tpu_torch.examples import scaled_accuracy_run as sar
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.train.trainer import init_state
    from feat3dnet_tpu_torch.utils import init_variables, load_variables_npz
    from feat3dnet_tpu_torch.utils.checkpoint import CheckpointManager
    from feat3dnet_tpu_torch.utils.convert import variables_from_module

    root = os.path.join(HERE, "build", "chip_smoke_recipe")
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()

    # ---- 24a. the recipe at smoke size through scaled_accuracy_run.main ------------------
    data, res = os.path.join(root, "data"), os.path.join(root, "results")
    s1_epochs, s2_epochs = RECIPE_EPOCHS
    summary = sar.main(["--places", str(RECIPE_PLACES), "--stage1_epochs", str(s1_epochs),
                        "--stage2_epochs", str(s2_epochs), "--fused_towers", "--device", str(dev),
                        "--test_pairs", str(RECIPE_TEST_PAIRS), "--keep_dir", data,
                        "--results_dir", res])
    t_a = time.perf_counter() - t_phase
    spe = RECIPE_PLACES * 4 // 6
    s1, s2 = os.path.join(data, "run_stage1"), os.path.join(data, "run_stage2")
    s1_ckpt = CheckpointManager(os.path.join(s1, "ckpt"))
    require(s1_ckpt.latest_step() == spe * s1_epochs,
            f"24a: stage 1 ended at step {s1_ckpt.latest_step()}, not {spe * s1_epochs}")
    require(summary["final_step"] == summary["final_count"] == spe * (s1_epochs + s2_epochs),
            f"24a: stage 2 ended at step {summary['final_step']}, count "
            f"{summary['final_count']}, not {spe * (s1_epochs + s2_epochs)}")
    with open(os.path.join(s2, "log.txt")) as f:
        require(f"Restored checkpoint at step {spe * s1_epochs}" in f.read(),
                "24a: stage 2's log names no restore of stage 1's last step")
    # stage 2's restore, replayed as cli.train makes it: stage 1's weights and
    # count outside `detection`, the seeded init inside it
    mcfg = ModelConfig(num_clusters=256, num_samples=64, fused_towers=True)
    state = init_state(Feat3DNet(mcfg), TrainConfig(batch_size=6, learning_rate=5e-5), mcfg,
                       0, None, dev)
    state = s1_ckpt.restore(state, restore_exclude=("detection",))
    got = flat_tree(sar.host_variables(variables_from_module(state.model)))
    ckpt = torch.load(os.path.join(s1, "ckpt", f"ckpt_{spe * s1_epochs}.pt"),
                      map_location="cpu", weights_only=True)
    stage1, fresh = flat_tree(ckpt["variables"]), flat_tree(init_variables(mcfg, seed=0))
    det = [k for k in got if k.split("/")[1] == "detection"]
    require(det and state.count == spe * s1_epochs == ckpt["count"],
            f"24a: restored count {state.count}, stage 1's {ckpt['count']}")
    for k, v in got.items():
        want = fresh[k] if k in det else stage1[k]
        require(np.array_equal(v, want),
                f"24a: restored {k} is not {'the init' if k in det else 'stage 1'}'s")
    train_k = ("fps", "ball_query", "train_stats", "train_final", "train_bwd_top", "train_bwd")
    for k in train_k:
        require(summary["launches"]["train"][k] > 0, f"24a: {k} not launched in training")
    for k in ("sorted_ball_query", "ball_max"):
        require(summary["launches"]["eval"][k] > 0, f"24a: {k} not launched in evaluation")
    with open(JAX_SUMMARY) as f:
        sections = sorted(json.load(f))
    for k in sections:
        require(k in summary and sar.finite(summary[k]), f"24a: summary section {k}: "
                f"{json.dumps(summary.get(k))[:200]}")
    mb = summary["matched_budget"]["kp1024_ratio0_nms02"]
    print(f"[{card}] 24a. scaled_accuracy_run --places {RECIPE_PLACES} --stage1_epochs "
          f"{s1_epochs} --stage2_epochs {s2_epochs} --fused_towers --test_pairs "
          f"{RECIPE_TEST_PAIRS}: {summary['final_step']} "
          f"steps (stage 1 {spe * s1_epochs}, restored minus detection at count "
          f"{spe * s1_epochs}), train {summary['train_s']:.1f} s, ms a step "
          f"{summary['ms_per_step']}, peak {summary['peak_gib']:.3f} GiB; held-out FPR@95 "
          f"{summary['heldout_fpr95']:.4f}, default precision@1m "
          f"{summary['fig4']['precision_at_1m']:.4f} % ({summary['keypoints_per_cloud']:.2f} "
          f"kp a cloud), kp1024_ratio0_nms02 {mb['fig4']['precision_at_1m']:.4f} %, "
          f"handcrafted {summary['handcrafted_baseline']['fig4']['precision_at_1m']:.4f} %; "
          f"sections {sections} finite; {t_a:.1f} s")

    # ---- 24b. the committed port-trained weights on both extraction routes --------------
    with open(os.path.join(RECIPE_DIR, "summary.json")) as f:
        record = json.load(f)["matched_budget"]["kp1024_ratio0_nms02"]
    rec_p, rec_n = record["fig4"]["precision_at_1m"], record["fig4"]["total_putative"]
    rec_k = record["keypoints_per_cloud"]
    test_dir = build_test_set(os.path.join(root, "heldout"), ACC_PAIRS)
    cfg = ModelConfig(num_clusters=256, num_samples=64)
    variables = load_variables_npz(os.path.join(RECIPE_DIR, "variables.npz"))
    before = sar.launch_counts()
    eval_k = {"default": ("sorted_ball_query", "ball_max"),
              "fused": ("sorted_ball_query", "ball_max", "fused_detect", "fused_describe")}
    for route, fused in (("default", False), ("fused", True)):
        t0 = time.perf_counter()
        pipe = InferencePipeline(Feat3DNet(cfg), variables, cfg, InferenceConfig(
            min_response_ratio=0.0, nms_radius=0.2, use_fused_detector=fused), device=dev)
        ran = sar.launch_counts()
        entry = evaluate_setting(pipe, test_dir, os.path.join(root, f"results_{route}"))
        ran = {k: n - ran[k] for k, n in sar.launch_counts().items()}
        f4, reg, kp = entry["fig4"], entry["registration"], entry["keypoints_per_cloud"]
        print(f"[{card}] 24b. port-trained autograd_seed0 kp1024_ratio0_nms02 ({route} route; "
              f"{time.perf_counter() - t0:.1f} s): precision@1m {f4['precision_at_1m']:.4f} % "
              f"(its record {rec_p:.4f} +- 1.0), total putative {int(f4['total_putative'])} "
              f"({int(rec_n)} +- 1 %), keypoints per cloud {kp:.4f} ({rec_k:.4f} +- 1 %), "
              f"registration {round(reg['success_rate'] * ACC_PAIRS)}/{ACC_PAIRS} (>= 20)")
        for k in eval_k[route]:
            require(ran[k] > 0, f"24b: {k} not launched on the {route} route")
        require(abs(f4["precision_at_1m"] - rec_p) <= 1.0,
                f"24b {route}: precision@1m {f4['precision_at_1m']:.4f} off {rec_p:.4f}")
        require(abs(f4["total_putative"] - rec_n) <= 0.01 * rec_n,
                f"24b {route}: total putative {f4['total_putative']} off {rec_n}")
        require(abs(kp - rec_k) <= 0.01 * rec_k,
                f"24b {route}: keypoints per cloud {kp:.4f} off {rec_k:.4f}")
        require(reg["success_rate"] >= ACC_MIN_SUCCESS - 1e-9,
                f"24b {route}: registration success {reg['success_rate']:.4f} < 20/24")
    ran = {k: n - before[k] for k, n in sar.launch_counts().items()}
    print(f"phase 24 launches (24b): {json.dumps(ran)}; (24a): "
          f"{json.dumps(summary['launches'])}")
    print(f"[{card}] phase 24 (the accuracy programs) wall "
          f"{time.perf_counter() - t_phase:.1f} s; a {t_a:.1f} s")
    torch.cuda.synchronize()


# the JAX package's one-step augmentations: name -> (chain key, non-default arguments)
ONE_STEP_AUGMENT = {
    "jitter": ("Jitter", {"sigma": 0.03, "clip": 0.04}),
    "shift": ("Shift", {"shift_range": 0.3}),
    "rotate_z": ("RotateZ", {}),
    "rotate_y": ("RotateY", {}),
    "rotate_small": ("RotateSmall", {"angle_sigma": 0.2, "angle_clip": 0.25}),
    "scale": ("Scale", {"low": 0.5, "high": 2.0}),
}
ENTRY_REPS = 10        # calls a timing of phase 25a


def public_api_phase(dev, card, clusters, variables):
    """Phase 25: the JAX public entries that wrap kernels the port already
    has. Counters from zero, the entries alone: fused_describe_clusters on
    phase 1's serving clusters in f32 and bf16_act (K3), convbn_maxpool_fused
    forward and backward on phase 9's detector inputs with bf16 and f32
    cotangents (K7-K10); every kernel must launch. Then (a)
    fused_describe_clusters bit-equal to pack_clusters_lanes_torch +
    fused_describe_clusters_t in f32, bf16_act and bf16_matmul, and timed in
    turns against fused_describe_clusters_t on clusters packed in advance
    (with the weights packed per call, and packed once); (b)
    convbn_maxpool_fused's pooled rows, moments and gradients bit-equal to
    tower_prepool_fused on detector_plan, reference_convbn_maxpool to
    reference_tower; (c) jitter, shift, rotate_z, rotate_y, rotate_small and
    scale on a CUDA generator bit-equal to AUGMENTATIONS' draw + apply from
    a generator of the same seed, at the default arguments and others."""
    import torch

    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.data import augment
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.ops import fused_train as ft
    from feat3dnet_tpu_torch.utils import init_variables, load_variables

    t_phase = time.perf_counter()
    cfg = ModelConfig()
    weights = fd.folded_weights(variables, cfg)
    k3 = fd.fused_describe_clusters_t
    passes = {k: getattr(ft, k[6:] + "_pass") for k in TRAIN_KERNELS}
    xyz = training_batch(dev, SEED)
    model = load_variables(Feat3DNet(cfg), init_variables(cfg, seed=SEED, bn_perturb=0.1)).to(dev)
    plan, flat = tower_params(model, cfg)["detector"]
    widths = tuple(cfg.detector_mlp)
    with torch.no_grad():
        x = tower_inputs(cfg, xyz)[0]
    ns, g_total = x.shape[0], x.shape[1]
    lw = torch_from(np.random.RandomState(SEED + 60).randn(g_total, widths[-1]), dev)

    def tower_grads(tower, cot):
        """pooled, means, vars, dx, dW / db / dgamma / dbeta of `tower`
        under the loss sum(pooled * lw)."""
        xt = x.clone().requires_grad_(True)
        fl = [t.clone().requires_grad_(True) for t in flat]
        pooled, (means, vars_) = tower(xt, fl, cot)
        (pooled * lw).sum().backward()
        return [pooled.detach(), *means, *vars_, xt.grad, *[t.grad for t in fl]]

    def entry(xt, fl, cot):
        return ft.convbn_maxpool_fused(xt, fl, widths, ns, g_total, cfg.bn_epsilon, cot)

    def tower(xt, fl, cot):
        return ft.tower_prepool_fused(xt, fl, ft.detector_plan(len(widths)), widths, ns,
                                      g_total, cfg.bn_epsilon, cot)

    # the entries alone, counters from zero
    k3.launches = 0
    k3.mode_launches = dict.fromkeys(k3.mode_launches, 0)
    for w in passes.values():
        w.launches = 0
    cots = {"bf16": torch.bfloat16, "f32": torch.float32}
    with torch.no_grad():
        desc = {mode: fd.fused_describe_clusters(weights, clusters, cfg, **kw)
                for mode, kw in K3_MODES.items()}
    train = {c: tower_grads(entry, cot) for c, cot in cots.items()}
    torch.cuda.synchronize()
    launches = {f"fused_describe_{m}": n for m, n in k3.mode_launches.items() if m in K3_MODES}
    launches.update({k: w.launches for k, w in passes.items()})
    print(f"phase 25 launches (fused_describe_clusters, convbn_maxpool_fused): "
          f"{json.dumps(launches)}")
    require(all(n > 0 for n in launches.values()),
            "K3 (f32 and bf16) and K7-K10 must launch through the new entries")

    # (a) fused_describe_clusters = pack + fused_describe_clusters_t
    wt = [w.to(dev) for w in fd.transpose_folded_weights(weights)]
    with torch.no_grad():
        pk = fd.pack_clusters_lanes_torch(clusters)
        for mode, kw in K3_MODES.items():
            want = k3(wt, pk, cfg, **kw)
            require(all(torch.equal(a, b) for a, b in zip(desc[mode], want)),
                    f"fused_describe_clusters {mode} != pack + fused_describe_clusters_t")
            if mode != "f32":
                got = fd.fused_describe_clusters(weights, clusters, cfg, bf16_matmul=True)
                require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        "fused_describe_clusters bf16_matmul != bf16_act")
        print(f"25a. fused_describe_clusters on {clusters.shape[0]} clusters: bit-equal to "
              f"pack_clusters_lanes_torch + fused_describe_clusters_t in "
              f"{', '.join(K3_MODES)} (bf16_matmul = bf16_act)")
        for mode, kw in K3_MODES.items():
            once = fd._describe_kernel_weights(wt, cfg, dev, "bf16" if kw else "f32")
            ms = ms_in_turns({
                "entry": lambda kw=kw: fd.fused_describe_clusters(weights, clusters, cfg, **kw),
                "t_prepacked": lambda kw=kw: k3(wt, pk, cfg, **kw),
                "t_packed_once": lambda kw=kw, once=once: k3(wt, pk, cfg, packed=once, **kw)},
                ENTRY_REPS)
            print(f"[{card}] 25a. {mode}: fused_describe_clusters {ms['entry']:.4f} ms a call, "
                  f"fused_describe_clusters_t on clusters packed in advance "
                  f"{ms['t_prepacked']:.4f} ms (the pack's share "
                  f"{ms['entry'] - ms['t_prepacked']:.4f} ms), on weights packed once too "
                  f"{ms['t_packed_once']:.4f} ms ({ENTRY_REPS} calls, in turns)")

    # (b) convbn_maxpool_fused = tower_prepool_fused on the detector's plan
    for c, cot in cots.items():
        want = tower_grads(tower, cot)
        require(all(torch.equal(a, b) for a, b in zip(train[c], want)),
                f"convbn_maxpool_fused ({c} cotangents) != tower_prepool_fused(detector_plan)")
    with torch.no_grad():
        got = ft.reference_convbn_maxpool(x, flat, widths, ns, g_total, cfg.bn_epsilon)
        want = ft.reference_tower(x, flat, ft.detector_plan(len(widths)), widths, ns, g_total,
                                  cfg.bn_epsilon)
        require(torch.equal(got[0], want[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1][0] + got[1][1], want[1][0] + want[1][1])),
            "reference_convbn_maxpool != reference_tower(detector_plan)")
    print(f"25b. convbn_maxpool_fused at (ns, G) = ({ns}, {g_total}), widths {widths}: pooled, "
          f"moments, dx, dW, db, dgamma and dbeta bit-equal to tower_prepool_fused on "
          f"detector_plan ({', '.join(cots)} cotangents); reference_convbn_maxpool bit-equal "
          "to reference_tower")
    del train
    torch.cuda.empty_cache()

    # (c) the one-step augmentations on a CUDA generator
    for i, (fn, (key, other)) in enumerate(ONE_STEP_AUGMENT.items()):
        draw, apply = augment.AUGMENTATIONS[key]
        for kw in [{}] + ([other] if other else []):
            seed = SEED + 70 + i

            def gen(seed=seed):
                return torch.Generator(device=dev).manual_seed(seed)

            got = getattr(augment, fn)(gen(), xyz, **kw)
            want = apply(xyz, draw(gen(), xyz, **kw))
            require(got.is_cuda and torch.equal(got, want) and not torch.equal(got, xyz),
                    f"{fn}({kw}) on the card != its draw + apply")
            if not kw:
                require(torch.equal(got, augment.augment_clouds(gen(), xyz, [key])),
                        f"{fn} != augment_clouds(gen, xyz, [{key!r}])")
    print(f"25c. {', '.join(ONE_STEP_AUGMENT)} on {tuple(xyz.shape)} with a CUDA generator: "
          "bit-equal to draw + apply from a generator of the same seed (default and other "
          "arguments) and, at the defaults, to augment_clouds")
    print(f"[{card}] phase 25 (the last public API) wall {time.perf_counter() - t_phase:.1f} s")


SEG_BATCH = 8          # clouds a unit of the segment-kitti-16k cell
SEG_POINTS = 16384


def seg_levels(dev, batch=SEG_BATCH):
    """PointNet++'s five levels of `batch` KITTI frames (the two vendored
    scans in turn, each sampled to SEG_POINTS points without replacement
    from a seeded generator), the coarser ones by K1 from the finer:
    [(B, n_k, 3)] for n_k = 16 384, 4 096, 1 024, 256, 64."""
    import torch

    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.ops import fps
    from feat3dnet_tpu_torch.ops.neighborhoods import gather_points

    rs = np.random.RandomState(SEED + 26)
    scans = [load_point_cloud(example_cloud_path(n))[:, :3]
             for n in ("kitti_00_001554.bin", "kitti_00_004534.bin")]
    xyz = np.stack([scans[i % 2][rs.choice(len(scans[i % 2]), SEG_POINTS, replace=False)]
                    for i in range(batch)]).astype(np.float32)
    levels = [torch.from_numpy(xyz).to(dev)]
    for npoint in (4096, 1024, 256, 64):
        levels.append(gather_points(levels[-1],
                                    fps.farthest_point_sample(levels[-1], npoint)).contiguous())
    return levels


def three_interp_phase(dev, card):
    """Phase 26: K11 (csrc/three_interp.cu) at the FP levels of a
    segment-kitti-16k unit (8 frames of 16 384 points, FP4 to FP1, seeded
    known features of each level's width): index-exact against its plain
    twin, its weights and sum against the twin's, then ms of the kernel
    (CUDA events, 50 calls), the plain twin (5) and the bound (8 flop a
    pair + 6 C a point at f32's peak, or the bytes); then K2's work at
    each SA level and radius (k2_counts: how many balls reach nsample hits,
    so how often its early exit fires); then one unit of 8 frames through
    the main path, SegmentationPipeline.segment_many on PointNet2MSG at the
    published widths (its step graphs captured by a call before it), with
    the K1, K2 and K11 counters set to 0 just before it. Returns
    ({"three_interp": the kernels line's numbers}, K11's launches in that
    unit)."""
    import torch

    from feat3dnet_tpu_torch.ops import batch_group
    from feat3dnet_tpu_torch.ops.interpolate import three_interpolate

    t_phase = time.perf_counter()
    levels = seg_levels(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 27)
    widths = {4: 1024, 3: 512, 2: 512, 1: 256}       # the known features' width at FP k
    k11, plain = three_interpolate, three_interpolate.plain
    per, bounds, err = [], [], 0.0
    for k in (4, 3, 2, 1):
        unknown, known = levels[k - 1], levels[k]
        b, n, m, c = unknown.shape[0], unknown.shape[1], known.shape[1], widths[k]
        feats = torch.randn(b, m, c, generator=g, device=dev)
        (ok, ik, wk), (op, ip, wp) = k11(unknown, known, feats), plain(unknown, known, feats)
        torch.cuda.synchronize()
        require(torch.equal(ik, ip), f"K11 FP{k}: indices != the plain twin's")
        w_rel = ((wk - wp).abs() / wp.abs().clamp(min=1e-30)).max().item()
        e = (ok - op).abs().max().item()
        err = max(err, e)
        require(w_rel <= 1e-6 and e <= 1e-6 * op.abs().max().item(),
                f"K11 FP{k}: weights rel {w_rel:.3e}, sum max|d| {e:.3e}")
        ms_k = cuda_ms(lambda: k11(unknown, known, feats), 50)
        ms_p = cuda_ms(lambda: plain(unknown, known, feats), 5)
        flop = 8.0 * b * n * m + 6.0 * b * n * c
        moved = nbytes(unknown, known, feats, ok, ik, wk)
        bounds.append(bound_ms(flop, moved))
        per.append((ms_k, ms_p))
        exact = torch.equal(ok, op) and torch.equal(wk, wp)
        print(f"[{card}] K11 three_interp FP{k} (B={b}, n={n}, m={m}, C={c}): indices exact, "
              f"weights rel {w_rel:.2e}, sum max|d| {e:.3e} ({'bit-equal' if exact else 'not bit-equal'}"
              f" to the twin); kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound "
              f"{bounds[-1][0]:.4f} ms ({bounds[-1][1]})")
    report = {"max_abs_err": err, "ms": float(np.mean([p[0] for p in per])),
              "plain_ms": float(np.mean([p[1] for p in per]))}
    report["bound_ms"], report["bound_by"] = mean_bound(bounds)
    radii = ((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0))
    for k in range(4):
        xyz, ctr = levels[k], levels[k + 1]
        for r, ns in zip(radii[k], (16, 32)):
            ik, ck = batch_group.ball_query_fused(xyz, ctr, r, ns)
            cl = batch_group.k2_cluster_size(xyz.shape[0], ctr.shape[1], xyz.shape[1], dev)
            counts = k2_counts(xyz, ik, ck, cl, ns=ns)
            ms = cuda_ms(lambda: batch_group.ball_query_fused(xyz, ctr, r, ns), 20)
            print(f"[{card}] K2 at SA{k + 1} r {r} ns {ns} ({xyz.shape[1]} points, "
                  f"{ctr.shape[1]} centres, B={xyz.shape[0]}): {ms:.4f} ms; "
                  + ", ".join(f"{key} {v:.4g}" if isinstance(v, float) else f"{key} {v}"
                              for key, v in counts.items()))
    launches = seg_unit_launches(dev, card)
    print(f"[{card}] phase 26 (K11, K2 at PointNet++'s levels): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"three_interp": report}, {"three_interp": launches}


def seg_unit_launches(dev, card):
    """K1's, K2's and K11's launches in one unit of 8 KITTI frames (the two
    vendored scans in turn) through SegmentationPipeline.segment_many, at
    PointNet++ MSG's published widths, counted from 0 just before the unit,
    once a call of the same shape has captured the step graphs: each
    replayed graph adds what its capture counted. Requires K1 x4, K2 x8
    (scalar radius) and K11 x4 and finite logits; returns K11's count."""
    import torch

    from feat3dnet_tpu_torch.config import PointNet2Config
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.inference import SegmentationPipeline
    from feat3dnet_tpu_torch.models import PointNet2MSG
    from feat3dnet_tpu_torch.ops import batch_group, fps
    from feat3dnet_tpu_torch.ops.interpolate import three_interpolate

    torch.manual_seed(SEED + 28)
    pipe = SegmentationPipeline(PointNet2MSG(PointNet2Config()), device=dev)
    scans = [np.ascontiguousarray(load_point_cloud(example_cloud_path(n))[:, :3])
             for n in ("kitti_00_001554.bin", "kitti_00_004534.bin")]
    frames = [scans[i % 2] for i in range(SEG_BATCH)]
    pipe.segment_many(frames, np.random.default_rng(SEED), batch_size=SEG_BATCH)
    k1, k2, k11 = fps.farthest_point_sample, batch_group.ball_query_fused, three_interpolate
    k1.launches = k2.launches = k11.launches = 0
    k2.mode_launches = dict.fromkeys(k2.mode_launches, 0)
    out = pipe.segment_many(frames, np.random.default_rng(SEED + 1), batch_size=SEG_BATCH)
    got = {"K1": k1.launches, "K2": k2.launches, "K2 scalar": k2.mode_launches["scalar"],
           "K11": k11.launches}
    print(f"[{card}] one unit of {SEG_BATCH} frames through segment_many (step graphs "
          f"replayed): launches " + ", ".join(f"{k} {n}" for k, n in got.items()))
    require(got == {"K1": 4, "K2": 8, "K2 scalar": 8, "K11": 4},
            f"segment_many's unit launched {got}, not K1 x4, K2 x8, K11 x4")
    require(len(out) == SEG_BATCH and all(np.isfinite(r.logits).all() for r in out),
            "segment_many: a non-finite logit")
    return k11.launches


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another tree (a checkout or its csrc/): build its K1-K6 and "
                         "training kernels too and hold this tree's against them (phases 1, "
                         "4, 5, 15, parent_ab)")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script needs a CUDA device")
    sys.path.insert(0, HERE)
    import feat3dnet_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(feat3dnet_tpu_torch.__file__))
    require(pkg_dir == os.path.join(HERE, "feat3dnet_tpu_torch"),
            f"feat3dnet_tpu_torch imported from {pkg_dir}, not from this checkout")

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.inference import ClusterDescriptorServer
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.ops import batch_group, fps, fused_describe
    from feat3dnet_tpu_torch.ops.neighborhoods import gather_points, group_points
    from feat3dnet_tpu_torch.utils import init_variables, load_variables, load_variables_npz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- build -----------------------------------------------------------
    info = kernels.build()
    kernels.library()
    print(f"build: {info.seconds:.1f} s -> {os.path.relpath(info.path, HERE)}")
    ptxas_lines("this", info, "")
    for marker in ("fused_detect", "describe"):
        tower_build_report("this", info, marker)
    for marker in WALK_MARKERS:
        tower_build_report("this", info, marker, WALK_SASS_OPS)
    parent_lib = parent = None
    if opts.parent:
        parent = parent_csrc(opts.parent)
        for marker in ("fused_detect", "describe"):
            tower_build_report("parent", parent_build(parent), marker)
        for marker in WALK_MARKERS:
            tower_build_report("parent", parent_build(parent), marker, WALK_SASS_OPS)
        # K4's, K6's, K3's forward modes (describe_kernel<0>, <1>) and K7-K10
        # against the parent's
        for marker in ("sorted_ball_query", "fused_detect", r"describe_kernelIL[bi][01]E",
                       "train_"):
            sass_equal("parent", info, parent_build(parent), marker)
        parent_lib = parent_cdll(parent)
    clouds = {n: torch.from_numpy(
        np.ascontiguousarray(load_point_cloud(example_cloud_path(n))[:, :3]))[None]
        for n in CLOUDS}
    gpu = {n: c.to(dev) for n, c in clouds.items()}
    wrappers = {"fps": fps.farthest_point_sample,
                "ball_query": batch_group.ball_query_fused,
                "fused_describe": fused_describe.fused_describe_clusters_t}
    report = {k: {} for k in wrappers}

    # ---- 1. kernels against their plain versions ----------------------------
    fps_k, fps_p = wrappers["fps"], wrappers["fps"].plain
    pair = torch.cat([gpu["oxford_270.bin"], gpu["oxford_456.bin"]], dim=0)
    centers = {}
    for name, xyz in list(gpu.items()) + [("oxford_pair(B=2)", pair)]:
        k, p = fps_k(xyz, NPOINT), fps_p(xyz, NPOINT)
        require(torch.equal(k, p), f"fps kernel != plain on {name}")
        centers[name] = gather_points(xyz, k).contiguous()
        print(f"K1 fps {name} {tuple(xyz.shape)}: index-exact vs plain")
    k1_cases(dev, parent_lib)
    report["fps"]["max_abs_err"] = 0

    bq_k, bq_p = wrappers["ball_query"], wrappers["ball_query"].plain
    for name, xyz in list(gpu.items()) + [("oxford_pair(B=2)", pair)]:
        (ik, ck), (ip, cp) = bq_k(xyz, centers[name], RADIUS, NS), bq_p(
            xyz, centers[name], RADIUS, NS)
        require(torch.equal(ik, ip) and torch.equal(ck, cp),
                f"ball query kernel != plain on {name}")
        print(f"K2 ball_query {name}: idx/cnt exact vs plain "
              f"(mean cnt {ck.float().mean().item():.2f})")
    g = torch.Generator(device="cpu").manual_seed(SEED)
    syn = (torch.randn(2, 5000, 3, generator=g) * 3.0).to(dev)
    syn_mask = (torch.rand(2, 5000, generator=g) > 0.3).to(dev)
    syn_ctr = torch.cat([syn[:, :100], syn[:, 100:200] + 40.0], dim=1).contiguous()
    (ik, ck), (ip, cp) = bq_k(syn, syn_ctr, RADIUS, NS, syn_mask), bq_p(
        syn, syn_ctr, RADIUS, NS, syn_mask)
    require(torch.equal(ik, ip) and torch.equal(ck, cp),
            "ball query kernel != plain on the synthetic masked case")
    require(bool((ck[:, 100:] == 0).all()) and bool(syn_mask.gather(
        1, ik.reshape(2, -1).long()).all()), "synthetic case: empty balls / mask")
    print("K2 ball_query synthetic (B=2, N=5000, 30% masked, 200 empty balls): exact")
    if parent_lib is not None:
        i2, c2 = torch.empty_like(ik), torch.empty_like(ck)
        k2_launcher(parent_lib)(syn, syn_ctr, syn_mask, NS, i2, c2)
        require(torch.equal(i2, ik) and torch.equal(c2, ck),
                "K2: parent != this on the synthetic masked case")
        print("K2 ball_query synthetic: idx and cnt equal to the parent's")
    k2_cases(dev, parent_lib)
    report["ball_query"]["max_abs_err"] = 0

    # the serving batch: 512 FPS-centred neighbourhoods of each cloud,
    # origin-centred, 2 048 distinct clusters tiled to BATCH
    per_cloud = []
    for name in CLOUDS:
        nidx, _ = bq_k(gpu[name], centers[name], RADIUS, NS)
        per_cloud.append((group_points(gpu[name], nidx) - centers[name][:, :, None])[0])
    distinct = torch.cat(per_cloud, dim=0)
    clusters = distinct.repeat(-(-BATCH // distinct.shape[0]), 1, 1)[:BATCH].contiguous()

    cfg = ModelConfig()
    variables = init_variables(cfg, seed=SEED, bn_perturb=0.1)
    model = load_variables(Feat3DNet(cfg), variables).eval()
    cpu_model = load_variables(Feat3DNet(cfg), variables).eval()
    model.to(dev)
    server = ClusterDescriptorServer(model, device=dev)
    weights_t, _ = server.kernel_weights.describe()
    packed_host = ClusterDescriptorServer.pack_clusters(clusters.cpu().numpy())
    packed = torch.from_numpy(packed_host).to(dev)
    k3, k3_plain = wrappers["fused_describe"], wrappers["fused_describe"].plain
    (dk, ak), (dp, ap) = k3(weights_t, packed, cfg), k3_plain(weights_t, packed, cfg)
    torch.cuda.synchronize()
    err = (dk - dp).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(dk, dp, dim=1).min().item()
    att_rel = ((ak - ap).abs() / ap.abs().clamp(min=1e-6)).max().item()
    print(f"K3 fused_describe {BATCH} clusters: max|d| {err:.3e} (<= 1e-4), "
          f"min cos {cos:.7f} (>= 0.99999), att rel {att_rel:.3e} (<= 1e-4)")
    require(err <= 1e-4 and cos >= 0.99999 and att_rel <= 1e-4,
            "fused describe kernel outside tolerance vs plain")
    report["fused_describe"]["max_abs_err"] = err
    # the trained weights (ckpt/4480) on the same clusters: f32 at the limits
    # above, bf16_act at phase 13's
    npz_path = os.path.join(HERE, "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz")
    wt_trained = [w.to(dev) for w in fused_describe.transpose_folded_weights(
        fused_describe.folded_weights(load_variables_npz(npz_path), cfg))]
    for mode, kw in K3_MODES.items():
        (dk, ak), (dp, ap) = (k3(wt_trained, packed, cfg, **kw),
                              k3_plain(wt_trained, packed, cfg, **kw))
        torch.cuda.synchronize()
        dmax = (dk - dp).abs().amax(dim=1)
        cos = torch.nn.functional.cosine_similarity(dk, dp, dim=1).min().item()
        att_rel = ((ak - ap).abs() / ap.abs().clamp(min=1e-6)).max().item()
        if mode == "f32":
            ok = dmax.max().item() <= 1e-4 and cos >= 0.99999 and att_rel <= 1e-4
            held = "(<= 1e-4, cos >= 0.99999, att rel <= 1e-4)"
        else:
            within = (dmax <= 2.0 ** -8).float().mean().item()
            ok = cos >= 0.9999 and within >= 0.999 and att_rel <= 1e-2
            held = (f"{100 * within:.3f} % within 2^-8 (>= 99.9 %, cos >= 0.9999, att rel "
                    "<= 1e-2)")
        print(f"K3 fused_describe {mode} trained weights {BATCH} clusters: max|d| "
              f"{dmax.max().item():.3e}, min cos {cos:.7f}, att rel {att_rel:.3e} {held}")
        require(ok, f"fused describe kernel {mode} outside tolerance vs plain, trained weights")

    # ---- 2. the main path, with launch counters from zero --------------------
    for w in wrappers.values():
        w.launches = 0
    outs = {}
    with torch.no_grad():
        for name in CLOUDS:
            outs[name] = model(gpu[name])
        torch.cuda.synchronize()
        answers = []
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            d, a = server.describe_packed(packed_host)
            answers.append((d.cpu(), a.cpu()))
        serve_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"main path launches: {launches}")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched on the main path")

    # ---- 3. outputs ------------------------------------------------------------
    for name, out in outs.items():
        require(tuple(out.keypoints.shape) == (1, cfg.num_clusters, 3)
                and tuple(out.features.shape) == (1, cfg.num_clusters, cfg.feature_dim),
                f"model output shapes on {name}")
        norms = out.features.norm(dim=-1)
        require(bool(((norms - 1).abs() < 1e-5).all()), f"unit descriptors on {name}")
        require(bool(torch.isfinite(out.attention).all())
                and bool(torch.isfinite(out.orientation).all()), f"finite heads on {name}")
    print(f"model: {len(outs)} clouds -> keypoints (1, {cfg.num_clusters}, 3), features "
          f"(1, {cfg.num_clusters}, {cfg.feature_dim}) unit-norm, finite attention")
    with torch.no_grad():
        ref = cpu_model(clouds["oxford_270.bin"])
    got = outs["oxford_270.bin"]
    require(torch.equal(got.keypoints.cpu(), ref.keypoints), "keypoints: card != CPU")
    f_err = (got.features.cpu() - ref.features).abs().max().item()
    a_err = ((got.attention.cpu() - ref.attention).abs()
             / ref.attention.abs().clamp(min=1e-6)).max().item()
    print(f"model card vs CPU (oxford_270): keypoints equal, features max|d| "
          f"{f_err:.3e} (<= 1e-4), attention rel {a_err:.3e} (<= 1e-4)")
    require(f_err <= 1e-4 and a_err <= 1e-4, "model on the card disagrees with the CPU")

    d0 = answers[0][0]
    for d, a in answers:
        require(torch.equal(d, d0) and bool(torch.isfinite(a).all()),
                "server answers differ between requests")
    with torch.no_grad():
        dm, _ = server._model_path(clusters)
    cos_all = torch.nn.functional.cosine_similarity(d0, dm.cpu(), dim=1)
    frac = (cos_all >= 0.9999).float().mean().item()
    print(f"server vs model path: min cos {cos_all.min().item():.6f} (>= 0.999), "
          f"{100 * frac:.2f} % at >= 0.9999 (>= 99 %)")
    require(cos_all.min().item() >= 0.999 and frac >= 0.99,
            "server disagrees with the model path")

    # ---- 4. times ------------------------------------------------------------------
    with torch.no_grad():
        per, bounds = [], []
        for name in CLOUDS:
            xyz = gpu[name]
            n_pts = xyz.shape[1]
            # (npoint - 1) sweeps of 3 sub, 3 mul, 2 add and a min per point
            bounds.append(bound_ms(9.0 * (NPOINT - 1) * n_pts, n_pts * 12 + NPOINT * 4))
            ms_k, ms_p = in_turns(lambda x=xyz: fps_k(x, NPOINT), lambda x=xyz: fps_p(x, NPOINT),
                                  10, 2)
            per.append((ms_k, ms_p))
            print(f"[{card}] fps {name} N={n_pts}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
        report["fps"]["ms"] = float(np.mean([p[0] for p in per]))
        report["fps"]["plain_ms"] = float(np.mean([p[1] for p in per]))
        report["fps"]["bound_ms"], report["fps"]["bound_by"] = mean_bound(bounds)
        # K1's time per step and set-up, per cluster size (and the parent's)
        for name in CLOUDS:
            k1_step(card, name, gpu[name], parent_lib)
        k1_step(card, "training batch", training_batch(dev, SEED), parent_lib)
        # K2's work, launch and time split per call of the path (and the parent's)
        per, bounds, dev_ms = [], [], []
        for name in list(CLOUDS) + ["oxford_pair(B=2)"]:
            sp, bnd = k2_step(card, name, pair if name == "oxford_pair(B=2)" else gpu[name],
                              centers[name], parent_lib)
            if name not in CLOUDS:
                continue
            # the kernels line's time, as for every kernel: the wrapper called
            # back to back (the host's launch included), in turns with plain
            xyz, c = gpu[name], centers[name]
            ms_k, ms_p = in_turns(lambda: bq_k(xyz, c, RADIUS, NS),
                                  lambda: bq_p(xyz, c, RADIUS, NS), 20, 5)
            per.append((ms_k, ms_p))
            bounds.append(bnd)
            dev_ms.append(sp["this kernel dev"])
            print(f"[{card}] ball_query {name} N={xyz.shape[1]}: kernel {ms_k:.4f} ms, "
                  f"plain {ms_p:.4f} ms; on the device alone {sp['this kernel dev']:.4f} ms")
        report["ball_query"]["ms"] = float(np.mean([p[0] for p in per]))
        report["ball_query"]["plain_ms"] = float(np.mean([p[1] for p in per]))
        report["ball_query"]["bound_ms"], report["ball_query"]["bound_by"] = mean_bound(bounds)
        print(f"[{card}] ball_query mean over the clouds: wrapper {report['ball_query']['ms']:.4f}"
              f" ms (the kernels line's ms), on the device alone {np.mean(dev_ms):.4f} ms "
              "(graph_ms; not in the kernels line)")
        xyz_t = training_batch(dev, SEED)
        k2_step(card, "training batch", xyz_t,
                gather_points(xyz_t, fps_k(xyz_t, NPOINT)).contiguous(), parent_lib)
        pk3 = fused_describe._describe_kernel_weights(weights_t, cfg, dev)   # packed once
        ms_k, ms_p = in_turns(lambda: k3(weights_t, packed, cfg, packed=pk3),
                              lambda: k3_plain(weights_t, packed, cfg), 10, 3)
        b3, b3_f32 = tower_bound(cfg, BATCH, nbytes(packed, *weights_t)
                                 + BATCH * (cfg.feature_dim + 1) * 4, False, descriptor=True)
        report["fused_describe"].update(ms=ms_k, plain_ms=ms_p, bound_ms=b3[0], bound_by=b3[1])
        print(f"[{card}] fused_describe {BATCH} clusters: kernel {ms_k:.4f} ms "
              f"({BATCH / ms_k * 1e3:.0f} desc/s), plain {ms_p:.4f} ms, bound {b3[0]:.4f} ms "
              f"({b3[1]}; every product at the f32 peak: {b3_f32[0]:.4f} ms)")
        # K3 per forward mode: split, occupancy, candidates (and the parent)
        for label, w in (("seeded", weights_t), ("trained", wt_trained)):
            k3_step(card, label, w, packed, cfg, parent)
        # server: host-packed requests in, descriptors on the host out
        server.describe_packed(packed_host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            d, a = server.describe_packed(packed_host)
            d.cpu(), a.cpu()
        serve_s2 = time.perf_counter() - t0
        # one request split into its stages on the device timeline
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        x = torch.as_tensor(packed_host, device=dev)
        ev[1].record()
        d, a = server.describe_packed(x)
        ev[2].record()
        d.cpu(), a.cpu()
        ev[3].record()
        ev[3].synchronize()
        stages = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        # the model forward on each cloud (FPS, ball query, towers); with a
        # parent, in FWD_BLOCKS blocks of turns (parent, this, this, parent)
        # with the parent's K2 in the same forward
        fwd, fwd_parent = {}, {}

        def forward_ms(x):
            model(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(5):
                model(x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t1) / 5 * 1e3

        def k2_tree(tag):
            return k2_from(parent_lib) if tag == "parent" else contextlib.nullcontext()
        tags = ("this",) if parent_lib is None else ("parent", "this")
        for name in CLOUDS:
            if parent_lib is None:
                fwd[name] = [forward_ms(gpu[name])]
                continue
            t = {"parent": [], "this": []}
            for _ in range(FWD_BLOCKS):
                for tag in ("parent", "this", "this", "parent"):
                    with k2_tree(tag):
                        t[tag].append(forward_ms(gpu[name]))
            fwd[name], fwd_parent[name] = t["this"], t["parent"]
        # one profiled forward per cloud and tree's K2: device busy time, and
        # K2's share
        fwd_dev = {}
        for name in CLOUDS:
            for tag in tags:
                with k2_tree(tag):
                    model(gpu[name])
                    torch.cuda.synchronize()
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        t1 = time.perf_counter()
                        model(gpu[name])
                        torch.cuda.synchronize()
                        wall = (time.perf_counter() - t1) * 1e3
                ev = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
                busy = sum(e.self_device_time_total for e in ev) / 1e3
                k2 = sum(e.self_device_time_total for e in ev
                         if re.search(r"(?<![A-Za-z_])ball_query_kernel", e.key)) / 1e3
                fwd_dev[name, tag] = (wall, busy, k2)
    print(f"[{card}] server: {REQUESTS} requests x {BATCH} clusters, "
          f"{REQUESTS * BATCH / serve_s2:.0f} descriptors/s end to end "
          f"(host packed array in, host results out; first run {REQUESTS * BATCH / serve_s:.0f})")
    print(f"[{card}] one request: host->device {stages[0]:.3f} ms, describe_packed "
          f"{stages[1]:.3f} ms, device->host {stages[2]:.3f} ms")
    for name, ms in fwd.items():
        print(f"[{card}] model forward {name} N={gpu[name].shape[1]}: {np.mean(ms):.3f} ms "
              "(host clock, synchronised)")
        if name in fwd_parent:
            # the parent's minus this tree's forward, per block of turns
            diff = (np.asarray(fwd_parent[name]).reshape(-1, 2).mean(1)
                    - np.asarray(ms).reshape(-1, 2).mean(1))
            print(f"[{card}] model forward {name}, {FWD_BLOCKS} blocks of turns (parent, "
                  f"this, this, parent; 5 forwards a turn): this {np.mean(ms):.3f} ms (min "
                  f"{np.min(ms):.3f}, max {np.max(ms):.3f}), with the parent's K2 "
                  f"{np.mean(fwd_parent[name]):.3f} ms (min {np.min(fwd_parent[name]):.3f}, "
                  f"max {np.max(fwd_parent[name]):.3f}); parent - this per block: mean "
                  f"{diff.mean():.3f}, sd {diff.std(ddof=1):.3f}, min {diff.min():.3f}, max "
                  f"{diff.max():.3f} ms")
        for tag in tags:
            wall, busy, k2 = fwd_dev[name, tag]
            print(f"[{card}] profile model forward {name} ({tag}'s K2): wall {wall:.3f} ms, "
                  f"device busy {busy:.3f} ms ({100 * busy / wall:.1f} %; "
                  f"{100 * busy / np.mean(fwd_parent[name] if tag == 'parent' else ms):.1f} % "
                  f"of the unprofiled forward), K2 {k2:.4f} ms of it")

    # ---- 5-8. whole-cloud extraction, trained weights ----------------------------
    ext_clouds = {n: load_point_cloud(example_cloud_path(n)) for n in CLOUDS}
    ext_clouds["synthetic_200k"] = synthetic_cloud(SEED)
    ext_report, ext_launches = extraction_phases(
        dev, card, ext_clouds,
        os.path.join(HERE, "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz"),
        os.path.dirname(example_cloud_path(CLOUDS[0])),
        os.path.join(HERE, "build", "chip_smoke_extract"), parent_lib, parent)
    report.update(ext_report)
    # K1-K3 count on the forward/serving path, K4-K6 on the extraction path
    launches.update({k: ext_launches[k] for k in ext_report})

    # ---- 9-12. triplet training, random weights -------------------------------------
    train_report, train_launches = training_phases(dev, card, opts.parent)
    report.update(train_report)
    launches.update({k: train_launches[k] for k in train_report})

    # ---- 13-16. K3's bf16 and decomposition modes, K6's folded and bf16 modes -----------
    for more in (serving_mode_phases(dev, card, model, server, weights_t, packed, packed_host,
                                     clusters.cpu().numpy(), cfg, parent),
                 detector_mode_phase(dev, card, ext_clouds, os.path.join(
                     HERE, "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz"))):
        report.update(more[0])
        launches.update(more[1])

    # ---- 17. the model in bf16 (compute_dtype): forward and a training step ------------
    bf16_model_phase(dev, card)

    # ---- 18. the held-out accuracy rerun, both extract routes; cli.match -----------------
    accuracy_phase(dev, card, os.path.join(HERE, "feat3dnet_tpu_torch", "assets",
                                           "ckpt4480_variables.npz"))

    # ---- 19. batched and pipelined extraction, both routes ---------------------------------
    batch_phase(dev, card, os.path.join(HERE, "feat3dnet_tpu_torch", "assets",
                                        "ckpt4480_variables.npz"),
                os.path.dirname(example_cloud_path(CLOUDS[0])))

    # ---- 20. the workflow around the model: prepare, TF1, training, histograms, entry() -----
    workflow = workflow_phase(dev, card, os.path.join(HERE, "feat3dnet_tpu_torch", "assets",
                                                      "ckpt4480_variables.npz"),
                              os.path.dirname(example_cloud_path(CLOUDS[0])))

    # ---- 21. data and point parallelism: DP steps over process groups, sharded extraction ----
    parallel_phase(dev, card, os.path.join(HERE, "feat3dnet_tpu_torch", "assets",
                                           "ckpt4480_variables.npz"))

    # ---- 22. the point-op API: per-centre radii through K2, the pointnet wrappers, kNN ----
    more = point_api_phase(dev, card, gpu, clouds)
    report.update(more[0])
    launches.update(more[1])

    # ---- 23. the training modes: native reader, chained step, int16 upload, memory modes ----
    training_modes_phase(dev, card, workflow)

    # ---- 24. the accuracy programs: the recipe at smoke size, the port-trained weights ----
    recipe_phase(dev, card)

    # ---- 25. the last public API: fused_describe_clusters, convbn_maxpool_fused, augment ----
    public_api_phase(dev, card, clusters, variables)

    # ---- 26. K11 at PointNet++'s FP shapes; K2's work at its SA levels ----
    more = three_interp_phase(dev, card)
    report.update(more[0])
    launches.update(more[1])

    meta = {
        "fps": ("feat3dnet_tpu_torch/csrc/fps.cu", "feat3dnet_tpu/ops/fps.py:103"),
        "ball_query": ("feat3dnet_tpu_torch/csrc/ball_query.cu",
                       "feat3dnet_tpu/ops/batch_group.py:51"),
        "ball_query_radii": ("feat3dnet_tpu_torch/csrc/ball_query.cu",
                             "feat3dnet_tpu/ops/batch_group.py:51"),
        "fused_describe": ("feat3dnet_tpu_torch/csrc/fused_describe.cu",
                           "feat3dnet_tpu/ops/fused_describe.py:883"),
        "sorted_ball_query": ("feat3dnet_tpu_torch/csrc/sorted_ball_query.cu",
                              "feat3dnet_tpu/ops/hash_grid.py:787"),
        "ball_max": ("feat3dnet_tpu_torch/csrc/ball_max.cu",
                     "feat3dnet_tpu/ops/hash_grid.py:1139"),
        "fused_detect": ("feat3dnet_tpu_torch/csrc/fused_detect.cu",
                         "feat3dnet_tpu/ops/fused_describe.py:1286"),
        "train_stats": ("feat3dnet_tpu_torch/csrc/fused_train.cu",
                        "feat3dnet_tpu/ops/fused_train.py:253"),
        "train_final": ("feat3dnet_tpu_torch/csrc/fused_train.cu",
                        "feat3dnet_tpu/ops/fused_train.py:274"),
        "train_bwd_top": ("feat3dnet_tpu_torch/csrc/fused_train.cu",
                          "feat3dnet_tpu/ops/fused_train.py:285"),
        "train_bwd": ("feat3dnet_tpu_torch/csrc/fused_train.cu",
                      "feat3dnet_tpu/ops/fused_train.py:316"),
        "fused_describe_bf16": ("feat3dnet_tpu_torch/csrc/fused_describe.cu",
                                "feat3dnet_tpu/ops/fused_describe.py:883"),
        "fused_describe_ablate_stream": ("feat3dnet_tpu_torch/csrc/fused_describe.cu",
                                         "feat3dnet_tpu/ops/fused_describe.py:984"),
        "fused_describe_ablate_matmul": ("feat3dnet_tpu_torch/csrc/fused_describe.cu",
                                         "feat3dnet_tpu/ops/fused_describe.py:984"),
        "fused_describe_ablate_matmul_2d": ("feat3dnet_tpu_torch/csrc/fused_describe.cu",
                                            "feat3dnet_tpu/ops/fused_describe.py:518"),
        "fused_detect_folded": ("feat3dnet_tpu_torch/csrc/fused_detect.cu",
                                "feat3dnet_tpu/ops/fused_describe.py:1286"),
        "fused_detect_bf16_operands": ("feat3dnet_tpu_torch/csrc/fused_detect.cu",
                                       "feat3dnet_tpu/ops/fused_describe.py:1286"),
        "three_interp": ("feat3dnet_tpu_torch/csrc/three_interp.cu",
                         "none (PointNet++'s feature propagation, new in the port)"),
    }
    # no single PyTorch call computes any of these functions: library_ms is null
    summary = [{"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
                "launches": launches[k], "max_abs_err": report[k]["max_abs_err"],
                "ms": report[k]["ms"], "plain_ms": report[k]["plain_ms"],
                "bound_ms": report[k]["bound_ms"], "bound_by": report[k]["bound_by"],
                "library_ms": None}
               for k in meta]
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
