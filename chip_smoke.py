#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's nine CUDA kernel sources from ``gencomm_tpu_torch/csrc``
(twelve entries: K1 and K3 also in bf16, K3's pair entry; N1, the rotated
NMS's keep-set)
with nvcc (sm_90a) into ``build/``, then drives the port's paths through its
entry points (SyntheticScenes, trim_agent_slots, host decoration for lidar,
HeterModel, InferencePipeline.run and run_stream,
train.trainer.make_train_step), fp32 activations with TF32 off, random
weights from a seed: the lidar flagship -- GenComm stage 1, PointPillars on
a 512 x 256 pillar grid, 2 agents, attentive fusion, 3-step diffusion,
Enhancer, heads, decode and rotated NMS -- and the camera model of
configs/opv2v/gencomm/stage1/m2_att.yaml at full width -- Lift-Splat-Shoot,
4 cameras of 384 x 512 per agent, 48 depth bins, top-8, a 256 x 256 BEV
grid, the same neck, diffusion, fusion and heads.

The lidar and camera eval paths also run at bf16 (``half=True``, as bench.py
builds the flagship): the same frames, weights and noise, with K1 and K3 on
their bf16 instantiations.

Phases, each of which raises on failure:
  1. the card, its power limit, torch / CUDA versions, fp32 settings;
  2. the kernel build, timed; K1 and K1b once on their general route
     (channel counts the tensor-core route does not take, a ragged map,
     offsets to +-9), K2b once on its (6 channels) and K3b on four thetas
     no path builds (zero, a 4x zoom, a nearly singular shear, a scaled
     rotation; 128 channels on its warp route, 6, 3, 2 and 1 on its pixel
     route, which must also give the warp route's bits) against their
     plain versions, and K3 on the same thetas on each of its routes (rows
     at 8 and 128 channels, pixel at 1, 3 and at 4 off a 16-byte boundary,
     scalar at 5, 17, 65 and at 128 off a 16-byte boundary; each map off
     the boundary with the bits of its rows route);
  3. every path counted and timed, before the process's first
     torch.profiler session (a finished session left later launches slower,
     ROADMAP p1): lidar eval fp32 and bf16, lidar training, camera eval fp32
     and bf16, camera training, phase 12's paths (V2X-ViT eval fp32
     and bf16 and training; every other fusion's frames and steps, which
     take no profiler session), phase 13's (the HEAL pyramid's eval and
     training), phase 14's (SECOND's) and phase 15 (the baselines). An eval
     path runs 1 warm-up + 4 frames looped (InferencePipeline.run) and the
     same 4 frames and seeds
     streamed (InferencePipeline.run_stream: one frame captured in a CUDA
     graph, replayed per frame), each streamed frame bit for bit equal to
     its looped frame; a training path 1 warm-up + 3 steps (CUDA events).
     Every launch count is set to 0 just before a run and read just after
     (each of the path's kernels must be > 0; a graph's kernels count as
     captured launches x replays): frames/s looped and streamed, detections,
     finite outputs; for training the loss terms of every step, ms/step,
     steps/s, training frames/s and peak memory;
  4. the lidar eval path's checks: each kernel (K1 deformable conv, K2 pillar
     canvas, K3 affine warp) on the inputs the path gives it, held against
     its plain PyTorch version (K2 bit-exact and the same bits on a second
     launch, K1 / K3 within the stated fp32 tolerance) and timed beside the
     plain version, a one-call PyTorch yardstick where one exists, and its
     bound on the card. K1 and K1b are timed warm and with the L2 cache
     evicted before every launch ("cold_ms"), and their rows name the route
     the wrapper took ("path_route"; "route_launches" counts the path's
     launches by route); K3 and F.grid_sample are timed in turns, 200
     launches a turn ("turns_ms"). Every kernel and every library yardstick
     also has the profiler's device time per call ("device_ms",
     "library_device_ms"), which leaves out the host work between launches
     that the event time of a short kernel is made of: each launch's mean
     over the records the profiler saw, times its launches a call, and a
     row whose records fall short of the wrappers' counted launches says so
     ("records_short", ROADMAP p3); K2 and K3b log the
     profiler's split by launch (K3b: one kernel a call, no memset). Then a
     one-frame device profile (PROFILE_CALLS), looped and streamed, and the same frame,
     weights and noise through the port on the CPU (plain versions):
     cls/reg/dir must agree. The late and no-fusion modes on the flagship
     built with supervise_single (each mode's per-agent heads and
     detections, card against CPU) and evaluate() in late mode (AP over 4
     frames of 5 slots with the boxes on their anchors, card against CPU:
     an AP at IoU 0.3 above 0 and the same APs). N1 (the NMS
     keep-set) held bit for bit against its plain version (the host-synced
     round loop) on the lidar frame's overlap matrix (K = 512), the late
     unions (K = 1,024 and 2,560), random box sets and suppression chains K
     boxes deep at K = 512, 1,024, 2,560 and 5,120, a random
     upper-triangular matrix (at the random sets' density) and a chain at
     K = 8,192, and timed on each beside the plain loop on the card and its
     bound, also over a CUDA graph of 200 launches ("graph_ms");
  5. the lidar eval path at bf16: K1 and K3 on their bf16 instantiations
     (rows "deform_conv3x3_bf16", "warp_affine_bf16"; bound by the bf16
     tensor-core rate or the bytes) and K2 on the path's arguments, against
     their plain versions (one bf16 step beside the fp32 tolerance) and
     against the fp32 kernels on the widened maps, rounded once: K3 bit for
     bit, K1 (a split bf16 product) the same bits on two launches and each
     output that differs within one bf16 step, the count logged; the
     profile (with cuDNN's FFT kernels counted); the card's bf16 run
     against its fp32 run on scripts/bf16_parity.py's statistics (the
     top-100 overlap must be >= 0.9), and against the port's bf16 run on the
     CPU (a relative L2 within sqrt(2) x the card's bf16-vs-fp32 one, the
     same top-100 overlap), the CPU's time logged;
  6. the lidar training path (configs/opv2v/gencomm/stage1/m1_att.yaml:
     batch 2 x 2 agents, AdamW, multistep LR, point_pillar_gencomm_loss,
     through gencomm_tpu_torch.train.trainer): K2 and the backward kernels
     (K1b deformable conv, K2b pillar canvas, K3b affine warp) on the
     arguments the train step gives them, held against their plain versions
     (K2 and K2b bit-exact; K3b also twice for the same bits) and timed; a
     one-step profile; 4 steps on one repeated batch, whose loss must fall;
     one step on the card and on the port's CPU (the first batch), whose
     losses must agree and whose gradients must differ no
     more than the CPU's own under a 1e-7 input jitter;
  7. the camera eval path: K4 (top-K depth splat) on the arguments the path
     gives it, held against its plain version (fp32 sum-order tolerance; K4
     itself gives the same bits on every run), once more with bf16 rows,
     the order it summed in held against a stable torch.sort's, and timed,
     with the device time of each of its launches by name (none may be a
     library's kernel); K1 and K3 held and timed again on this path's
     arguments (maps of 64 x 64, not 64 x 128); the device profile and the
     same frame on the CPU;
  8. the camera eval path at bf16 as in phase 5 (K1 and K3 bf16 on its
     maps; the trunk in bf16, K4 with bf16 rows);
  9. the camera train step with the optimizer, schedule and
     point_pillar_depth_loss of m2_att.yaml (batch 2 x 2 agents): K1, K3 and
     K4 at the step's shapes, K1b, K3b and K4b (K4's backward) on the step's
     arguments, against their plain versions and timed; the profile, 4 steps
     on one batch, whose loss must fall; one step on the card and on the
     CPU, held as in phase 6;
 10. one run of ``python -m gencomm_tpu_torch.bench`` (the bf16 flagship,
     looped and streamed, in its own process), its JSON line echoed;
 11. the GenComm two-stage workflow through the command-line tools, at the
     full width of the repo's yamls, in its own process (``chip_smoke.py
     --workflow DIR``, after no profiler session; its kernel counts are its
     own), on the card with --dataset synthetic: each tool's main(argv) --
     train stage1/m1_att.yaml for 2 epochs of 12 steps, the same run again
     to epoch 3 (it must resume at epoch 2), stage1/m2_att.yaml for 1 epoch
     (the camera runs cycle a pool of 4 batches, --batch_pool: the host
     renders a camera batch slower than the card steps it, its time
     logged), heal_tools merge, stage2/m1m2_att.yaml from the merge for 1
     epoch, inference of the stage-2 run over 1 frame with the payload
     report, inference_heter_in_order over 2 frames and 1-2 agents. Held:
     every model's parameters and every training batch on the card; K1-K4,
     K1b-K4b and N1 each launched; stage 2 left every parameter and running
     statistic outside message_extractor_m2 bit for bit and changed
     message_extractor_m2; every logged loss finite; inference again with
     --device cpu on the same frame (both runs draw the diffusion noise
     of a frame's seed from the host generator, so that they share it) gives
     the card's APs within 1e-6 for the stage-2 checkpoint, for a copy with
     its running statistics refreshed (trainer.refresh_batch_stats; its
     fused heads within 1e-3 of the CPU's on every frame, and the same kept
     boxes) and for a copy whose heads put every box on its anchor (the
     same kept boxes, and an AP at IoU 0.3 above 0, so the APs held are not
     all zeros). Then each training run's step, once more on its last batch,
     under torch.profiler: device busy ms/step. One JSON line: each
     training run's ms/step as the CLI prints it at it = 10 and by CUDA
     events over the same steps, its device busy ms/step, each tool's wall
     seconds and kernel launches, the APs, the payload report and the
     kernel counts. Phase 12 (c) adds stage1/m1_v2xvit.yaml: trained for 1
     epoch of 12 steps, then inference over 1 frame on the card and with
     --device cpu, its refreshed and anchor-box copies held as stage 2's;
 12. the intermediate-fusion family on the flagship (fp32 unless said,
     random weights from seed 0, the same frames and batches): (a) the
     V2X-ViT GenComm model (stage1/m1_v2xvit.yaml's fusion block and, for
     its step, optimizer and loss) timed as the lidar paths are, eval fp32
     and bf16 looped and streamed (bit for bit) and 1 + 3 train steps, then
     K3 (fp32 and bf16) and K3b held on its arguments, its profiles, card
     against CPU (heads; bf16 by phase 5's statistics; the step's losses
     and gradients as phase 6, gradients of cancellation noise logged, not
     held); (b) CoBEVT, Where2comm with its communication mask (comm_rate
     logged), V2VNet, max, DiscoNet and Who2com (configs/opv2v/
     point_pillar_<fusion>.yaml's blocks), each 1 + 2 eval frames and 1 + 1
     train steps (m1_att.yaml's optimizer and loss), card against CPU on a
     frame and a step as in (a); V2VNet's K3 launches a forward must be 2 L
     num_iteration, half of them on K3's rows route (the node stack) and half
     on its pixel route (the map of ones), and K3 is held on a non-ego
     theta for its 128-channel and its 1-channel map of ones, K3b on the
     latter; then one
     make_kd_train_step step (DiscoNet, the teacher on the student's
     weights), card against CPU;
 13. the HEAL pyramid (configs/opv2v/heal/stage1/m1_pyramid.yaml at full
     width on the train CLI's sampler and host adaptation, fp32, random
     weights from seed 0): (a) eval timed with the other paths in phase 3,
     1 + 4 frames looped and streamed (bit for bit), then K3 on each map
     the path warps (each level's feature at 64 / 128 / 256 channels on the
     rows route and its 1-channel score on the pixel route, warped together
     in one pair launch a level, which must give the bits of the two maps'
     own launches and of one launch on the 65 / 129 / 257 channels
     concatenated, the JAX package's form, and is timed against both; each
     map's device time also over a CUDA graph of 200 launches, beside
     grid_sample's), K2 and N1 held and timed, the
     profiles, heads card against CPU (max and relative L2); (b) 1 + 3
     train steps (batch 2, its Adam and point_pillar_pyramid_loss with the
     occupancy pass; K3b's pixel route launched for every 1-channel score,
     its warp route for every feature), K3b on each map twice for the same
     bits (on the scores the pixel route also against the warp route, bit
     for bit, and both routes and autograd of grid_sample over CUDA
     graphs), K2 and K2b, the profile, 4 steps on one batch (the loss
     must fall), one step card against CPU as in phase 6; (c) in the
     workflow process HEAL's three stages through the tools' main(argv):
     stage1/m1_pyramid.yaml for 1 epoch of 12 steps,
     stage2/m2_single_pyramid.yaml from it (--init_from) for 1 epoch on 4
     pooled camera batches (every pyramid and head tensor bit for bit, the
     camera branch moved), heal_tools merge, inference of
     final_infer/m1m2.yaml over 1 frame on the card and the CPU (the same
     APs; the payload report), of its copy refreshed on one batch of that
     config (heads card against CPU) and of an anchor-box copy on a
     51.2 x 25.6 m range (AP at IoU 0.3 above 0), inference_heter_in_order
     over 2 frames; K2, K3, K4, K2b, K3b, K4b and N1 each launched.
 14. SECOND, the third agent type (configs/opv2v/gencomm/stage1/m3_att.yaml's
     model at full width, fp32 with TF32 off, random weights from seed 0:
     0.1 m voxels over 204.8 x 102.4 x 4 m, 32,000 an agent slot,
     VoxelBackBone8x on the sparse convolution of ops/sparse.py to a
     256-channel 128 x 256 BEV, the pillar neck, heads at 32 x 64), on the
     flagship's scenes with raw points on the card and anchors and labels
     at feature_stride 8, the heads' grid (reference fault n): (a) eval fp32
     and bf16 (the encoder stays fp32) timed with the other paths in phase
     3, 1 + 4 frames looped and streamed (bit for bit), and 1 + 3 train
     steps at batch 2 x 2 agents with its Adam, multistep schedule and
     point_pillar_gencomm_loss (K1, K3, N1 and, in training, K1b and K3b
     launched, peak memory logged); (b) each sparse op the encoder calls,
     re-run on the card and on the port's CPU with the path's own
     arguments (integer outputs equal, features within 1e-5 x max(1,
     max|cpu|)), timed, the voxels each list holds against its capacity,
     the voxel means (a segment sum in point order) the same bits on a
     second run; the encoder's BEV card against CPU; K1 and K3 (fp32 and
     bf16) on the (2, 32, 64, 128) maps and N1 held and timed, heads card
     against CPU (check_eval); the encoder's share of the frame's device
     time (profiles of the frame and of the encoder alone) and its
     operators by their own device time, those over 2% of the streamed
     frame named; K1b and K3b on the step's arguments, the profile, 4
     steps on one batch (the loss must fall), one step card against CPU as
     in phase 6, the jitter keeping every point in its voxel
     (jitter_within_voxels), each parameter's gap against its own spread
     logged, and where the offset gradients part (offset_gap: sampling
     taps whose floor differs, K1b against its plain version, the gap over
     the taps that agree; logged); the encoder's share of the step's
     device time; (c) in the workflow process stage1/m3_att.yaml (a copy in
     its run's directory with only feature_stride 8) trained for 1 epoch
     of 12 steps and evaluated over 1 frame on the card and with --device
     cpu (the same APs; a copy refreshed on its last batch, heads within
     1e-3 and the same kept boxes; an anchor-box copy, AP at IoU 0.3 above
     0); K1, K3, K1b, K3b and N1 each launched. ROADMAP p6
     (hold_repeat_step): no index_add_ runs in the step, the encoder's
     backward twice gives every gradient the same bits, and the whole step
     twice with cudnn.deterministic every gradient (K1b sums its input
     gradient in a fixed order, p8); the lidar and camera steps (phases 6
     and 9) are held alike;
 15. the paper's heterogeneous baselines at full width (fp32, TF32 off,
     random weights from seed 0, the train CLI's sampler and host
     adaptation): BackAlign, CodeFilling and MPDA on
     configs/opv2v/baselines/stage2/<method>/m1m2_att.yaml, STAMP on
     stamp/m0m2_att.yaml (the camera m2 the protocol space, m0's pillar
     feature through its ConvNeXt adapter). (a) Timed with the other
     paths, no profiler session: 1 + 3 eval frames looped and streamed
     (bit for bit; K2, K3, K4 and N1 launched), 1 + 2 train steps with the
     method's loss and the train CLI's freeze (K3b where the loss reaches
     the fusion, K4b where the camera branch trains, K2b nowhere); every
     frozen tensor keeps its bits and every trainable one moves; heads
     card against CPU (max and relative L2 within 1e-3), CodeFilling's
     codes equal but at most 4 rounding-level near-ties; one step card
     against CPU as in phase 6, every floating input jittered, the card
     and the jittered CPU step on the CPU step's discrete choices
     (cpu_choices: top-K depth picks, straight-through codes; at most 16 a
     call differ from a side's own, each a near-tie); (b) in the workflow process
     (baseline_workflow, alone: chip_smoke.py --baseline-workflow DIR):
     CodeFilling trained 4 steps and evaluated over 2 frames on the card
     and the CPU with --report_comm (the same APs, heads within 1e-3, the
     same kept boxes, the code bytes per stage), STAMP trained 4 steps,
     merged by heal_tools merge-final with its own checkpoint without the
     adapters (heal_tools remove) and the merge evaluated on the card;
     each run moved only its schedule's tensors;
 16. the robustness evaluation and late, no and early fusion training, in
     the workflow process after phase 13 (c): (a) the m1_att run's copy
     with its running statistics refreshed on its last batch through
     inference_w_noise (levels 0 and 0.4, and 0.4 Laplace) and
     inference_w_delay (0 and 200 ms), 1 frame a level, on the card and
     with --device cpu (the frames' diffusion noise from the host): every
     frame's kept boxes and scores card against CPU within 1e-3, every
     level's APs within 1e-6, and the anchor-box copy at level 0 on one
     frame (AP30 above 0); (b) K3 and K3b against their plain versions on the thetas the card
     took at noise 0.4, which must differ from level 0's (their numbers
     under "other_paths" of the K3 and K3b rows); (c) single/m1_pretrain.yaml
     (late fusion: the ego slot) and point_pillar_early_fusion.yaml (the
     clouds merged into the ego frame) at full width through the train CLI,
     1 + 3 steps each, then from each run's starting state 4 steps on the
     CLI's first batch (the loss must fall) and one step card against CPU
     as in phase 6; (d) CoAlign's pose refinement card against CPU on a
     chain of three agents with injected pose errors (within 1e-4, each
     error recovered) and tools/pose_graph.py evaluated on the card (the
     refinement must lower the position error at every noise level);
 17. the remaining encoders and the tools, in their own process after the
     workflow's (``chip_smoke.py --phase17 DIR``), fp32 with TF32 off, random
     weights from seed 0, each config on the train CLI's sampler with raw
     points on the card: (a) VoxelNet (voxel_net.yaml), PIXOR (pixor.yaml),
     the legacy second.yaml and second_intermediate.yaml and the raw-point
     path of stage1/m1_att.yaml at full width, each an eval cell as in
     phase 3 (1 + 3 frames looped and streamed, bit for bit; K3 and N1
     launched as each model fuses, K2 never: the raw points are
     max-reduced in plain PyTorch; the device profile; heads card against
     CPU); (b) each through the train CLI for one epoch of 1 + 2 steps
     (--no_host_decorate for the raw path), then a training cell as in
     phase 6 on the CLI's batches, its card-vs-CPU step on the yaml cut to
     25.6 x 12.8 m and one sample a batch (each point jittered within its cell; both steps take
     the CPU step's segment maxima and ReLU gates, the differing ones held
     to near-ties); (c) HEAL's stage1/m3_pyramid.yaml and
     stage2/m3_single_pyramid.yaml through the train and inference CLIs,
     the anchors' stride taken from the heads' grid (fault n); (d) the
     profiler on m1_att.yaml (eval and --train, --trace, --by_module:
     FLOPs in both parts, MFU in (0, 1]; an unknown card raises),
     inference_time, sustained_fps and bench_matrix (its default and
     --added_cost rows; none may err; K4 held against its plain version on
     the last camera row's arguments); K3 and N1 held on the eval paths'
     arguments, K3b on the steps'.
 18. the real-data loaders, in their own process after phase 17's
     (``chip_smoke.py --phase18 DIR``), fp32 with TF32 off, random weights
     from seed 0: (a) an OPV2V-layout tree (binary .pcd, per-CAV yamls) and
     a V2X-Real-layout tree (KITTI .bin, CAV ids 1, 2 and -1, objects of
     every class name and two unknown ones, a validation scenario of
     2023-04-07 that eval mode vc leaves out) written from seeds: a
     training and a validation scenario, 3 CAVs, 12 and 2 timestamps, 80,000
     points a cloud, 40 objects a scene; every sample of both loaders
     timed (s/sample, the host data layer); (b) V2X-Real's multi-class
     GenComm stage 1 (configs/v2xreal/gencomm/stage1/m1_att.yaml, a copy
     pointed at the tree) through the train CLI (--dataset v2xreal, 2
     epochs of 6 steps: K1, K1b, K2, K2b, K3, K3b launched, every logged
     loss finite), a training cell on the CLI's first 1 + 2 batches and an
     eval cell on the first validation frame (1 + 2 frames looped and
     streamed, bit for bit, through the multi-class decode); K1, K2 (bit
     for bit, twice) and K3 on the path's arguments and N1 on its
     multi-class top-512 overlap matrix, against their plain versions and
     timed; the profiles; heads card against CPU; K2, K1b, K2b and K3b on
     the training cell's step against their plain versions; the loss
     falling over 4 steps; one card-vs-CPU step on one loader sample of
     the yaml cut to 25.6 x 12.8 m on the training path (host decoration,
     K2, K2b), both steps on the CPU step's K2 rows (so its pillar maxima)
     and ReLU gates, the jittered CPU step's canvas jittered where the
     backbone takes it in fp32 besides its points (the rows' bf16 rounding
     swallows a points-only jitter); the direction head, which the
     multi-class loss does not reach, without a gradient on either side,
     every other parameter held; the train CLI's own ms/step an epoch
     (loading included) reported beside the cell's; the inference CLI on the
     trained run, and on a copy with seeded weights (the regression scaled
     down, each slot's own class raised, 2,048 boxes into N1) on the card
     and with --device cpu (an AP at IoU 0.3 above 0):
     per-class APs and mAPs within 1e-6, heads within 1e-3, the same kept
     boxes; (c) OPV2V's stage1/m1_att.yaml the same way through the CLIs
     (--dataset opv2v; its cells timed, not checked again: the flagship's
     model).
K1b's row counts the launches of its dx sum ("dx_sum_launches") and
carries the repeat-step counts ("repeat_step").
A profile's device busy time is the union of its kernels' intervals, the
sum logged beside it (ROADMAP p7).
Each phase prints its wall time, every line the seconds since its process
started. A profile traces the device alone, but the flagship's lidar eval
and step profiles and SECOND's encoder profiles also trace the host's
operators and list the convolution operators by the shapes of their
arguments. The last line is {"ok": true, "device":
{...}}; before it come the card's nvidia-smi line and one JSON line with
every kernel's numbers on the path that ran it first and, under
"other_paths", on later paths' arguments where those differ (N1's other
inputs under "cases").
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import time

from gencomm_tpu_torch.bench import (
    LIDAR_RANGE, POSTPROCESS, VOXEL, flagship_kwargs, scenes_config,
)
from gencomm_tpu_torch.config.yaml_utils import load_yaml
from gencomm_tpu_torch.models.heter_baseline import model_kwargs
from gencomm_tpu_torch.models.heter_pyramid import pyramid_kwargs
from gencomm_tpu_torch.tools.profiler import kernel_ops

# fp32 peak outside the tensor cores, bf16 tensor-core peak and memory rate
# of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# the flagship as the bench program builds it, at fp32
FLAGSHIP = flagship_kwargs(half=False)
FEATURE_SHAPE = (64, 128, 128)  # the fused map, H x W x C
NMS_TOPK = POSTPROCESS["nms_topk"]

# the camera model and both paths' training hypes from the repo's yamls:
# configs/opv2v/gencomm/stage1/m2_att.yaml built as create_model builds it
# (model_kwargs, so that a cell can set half), m1_att.yaml's and m2_att.yaml's
# optimizer, schedule and loss (create_loss)
GENCOMM_CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "opv2v", "gencomm")
TRAIN_HYPES = load_yaml(os.path.join(GENCOMM_CONFIGS, "stage1", "m1_att.yaml"))
CAMERA_TRAIN_HYPES = load_yaml(os.path.join(GENCOMM_CONFIGS, "stage1",
                                            "m2_att.yaml"))
CAMERA = model_kwargs(CAMERA_TRAIN_HYPES)
_CAMERA_ENC = CAMERA["modality_args"]["m1"]["encoder_args"]
CAMERA_RANGE = tuple(CAMERA_TRAIN_HYPES["preprocess"]["cav_lidar_range"])
CAMERA_DIM = tuple(_CAMERA_ENC["data_aug_conf"]["final_dim"])
CAMERA_NCAM = _CAMERA_ENC["data_aug_conf"]["Ncams"]
CAMERA_GRID = _CAMERA_ENC["grid_conf"]
CAMERA_FEATURE_SHAPE = (64, 64, 128)
TIMED_FRAMES = 4  # eval frames, looped and streamed, after one warm-up
# N1's sizes: nms_topk (intermediate and no-fusion modes), the late union
# over 2 and 5 agent slots, and over 5 slots at an nms_topk of 1,024; and a
# K past the parent kernel's 4,096 boxes whose pairwise IoU would cost too
# much, built as a random matrix (nms_cases)
NMS_KS = (512, 1024, 2560, 5120)
NMS_DENSE_K = 8192
# device times of one-channel maps and of N1: CUDA events over replays of a
# CUDA graph of this many captured launches (graph_ms)
GRAPH_LAUNCHES = 200
# the frames or steps of a path's device profile (torch.profiler, CPU and
# CUDA activity with shapes): the session's cost on the host grows with
# them, what it reads per frame or step does not
PROFILE_CALLS = 1
EVAL_FRAMES = 2  # evaluate(): AP over these frames, card against CPU
AP_TOL = 1e-6
# bf16 eval (half=True): the card's bf16 run against its fp32 run keeps at
# least TOP100_MIN of the fp32 top-100 cells (scripts/bf16_parity.py's
# statistic). Two bf16 runs whose sums are taken in other orders (cuDNN on
# the card, oneDNN on the CPU) differ by two draws of bf16 rounding noise,
# which the 3-pass bf16 diffusion at random weights carries to the heads
# (tests/test_torch_half.py::test_bf16_generation_amplifies_a_one_step_
# change): the card's bf16 run is held to the port's CPU bf16 run within
# HALF_SPREAD times the CPU bf16 run's relative L2 of sigmoid(cls) against
# the card's fp32 run (a limit that the card's bf16 run does not move),
# and by the same top-100 overlap
TOP100_MIN = 0.9
HALF_SPREAD = math.sqrt(2.0)
# V2X-ViT's bf16 attention rounds every elementwise step to bf16, as eager
# PyTorch does, where XLA keeps fused steps in fp32 (excess precision). On
# the narrowed slice over 9 seeds (scripts/v2xvit_bf16_effect_torch.py)
# JAX's half run keeps 0.92-0.98 of its fp32 top-100, 0.88-0.97 with
# --xla_allow_excess_precision=false, the port's 0.87-0.97; 0.85 on the
# card at the flagship's width. Its top-100 overlaps are held at this bar
V2XVIT_TOP100_MIN = 0.8
# card vs CPU on the whole model, fp32 with TF32 off: sums in other orders
# over ~30 layers, and a bf16 canvas whose rounding can flip by one ulp
# where the two PFN matmuls differ in the last bit
CPU_TOL = 1e-3

TRAIN_BATCH = 2
TRAIN_SEED = 0  # tools/train.py batches(): sample(seed * 10000 + step, 2)
TIMED_STEPS = 3
# K1b vs its plain version: fp32 sums of up to 32,768 random-sign terms
# (dW over the pixels, dx over each pixel's records) taken in other orders;
# each term rounds at ~6e-8 relative, and the cancellation between terms is
# bounded well inside 1e-3 of the output's largest value
K1B_TOL = 1e-3
# card vs CPU gradients. At the random-weight flagship point they move with
# the last bits of the inputs: a 1e-7 relative jitter of the CPU step's
# input points moves them by up to ~4e-2 (L2, the deep backbone levels),
# and two card runs differ by ~1e-4 (cuDNN's default algorithms). So the
# card's gradients are held to GRAD_FACTOR x the CPU's own jitter sensitivity, measured in the
# same run, per worst parameter (L2 norm of the difference over the norm)
JITTER = 1e-7
GRAD_FACTOR = 3.0
GRAD_FLOOR = 1e-4
# the most pixels (or code vectors) of one call whose own discrete choice
# may differ from the CPU step's where a step takes the CPU's choices
# (cpu_choices; each must be a near-tie besides): scripts/lss_choices_torch.py
# saw the top-K picks part at 1-8 entries a camera slot, and a batch of 2
# holds 2 camera slots
CHOICE_FLIPS = 16
# the largest share of a segment max's (segment, channel) pairs whose own
# max row may differ from the CPU step's where a step takes the CPU's rows
# (cpu_choices; each a near-tie besides)
SEGMENT_FLIPS = 1e-3
# and of a ReLU's entries whose gate may differ (cpu_choices with gates)
GATE_FLIPS = 1e-4
# and of K2's bf16 rows' entries (the host decoration's path) that may
# differ where a step takes the CPU step's rows (cpu_choices with rows),
# each by one bf16 step besides: the rounding of fp32 values that lie near
# the midpoint of two bf16 numbers, which the fp32 sums' order moves
ROW_FLIPS = 1e-3
# CodeFilling's eval codes, card against CPU: at most CODE_FLIPS differ, each
# where the two codes' CPU distances lie within CODE_TIE x max(1, d), a
# rounding-level gap (the card has read one flip, at an exact tie)
CODE_FLIPS = 4
CODE_TIE = 1e-6
LOSS_TOL = 1e-3  # relative, the losses of the same step
# K4 / K4b vs their plain versions: fp32 sums (a cell's rows; 128 products
# and K rows) taken in another order, relative to the output's largest value
SPLAT_TOL = 1e-5
K3_TURN_LAUNCHES = 200
# channel counts and a map that only the general route of K1 / K1b takes
GENERAL_SHAPE = (2, 20, 36, 40, 70)
# agents, rows per agent, channels, cells per agent: K2b's general route
GENERAL_CANVAS = (3, 1000, 6, 200)
# K3b on thetas the system never builds (it builds rigid ones): zero, a 4x
# zoom, a nearly singular shear, a rotation with scale; on (H, W) maps
GENERAL_THETAS = [[[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                  [[0.25, 0.0, 0.1], [0.0, 0.25, -0.05]],
                  [[1.0, 0.5, 0.1], [2.0, 1.000001, -0.2]],
                  [[1.2, -0.6, 0.3], [0.5, 0.9, -0.4]]]
GENERAL_WARP_MAP = (48, 64)

# phase 12, the intermediate-fusion family on the flagship (fp32, TF32 off).
# V2X-ViT: the fusion block of configs/opv2v/gencomm/stage1/m1_v2xvit.yaml
# (dim 128, depth 2; build_fusion's defaults for the rest: 8 HMSA heads of
# 32, windows 4, 8, 16), trained with that yaml's AdamW and loss. The other
# fusions: the blocks of configs/opv2v/point_pillar_<fusion>.yaml (with
# Where2comm's communication block), trained with m1_att.yaml's AdamW and
# point_pillar_gencomm_loss, and DiscoNet's distillation with
# point_pillar_disconet_loss on the same loss arguments
V2XVIT_HYPES = load_yaml(os.path.join(GENCOMM_CONFIGS, "stage1",
                                      "m1_v2xvit.yaml"))


def flagship_with_fusion(hypes, num_agents=None):
    """The flagship's ``HeterModel`` arguments with the fusion that
    ``hypes`` builds (``model_kwargs``), for batches of ``num_agents`` agent
    slots."""
    kw = model_kwargs(hypes)
    return dict(FLAGSHIP, num_agents=num_agents, **{
        k: kw[k] for k in ("fusion_method", "fusion_args", "use_comm_mask",
                           "comm_thre")})


V2XVIT = flagship_with_fusion(V2XVIT_HYPES)
FUSION_FAMILY = ("cobevt", "where2comm", "v2vnet", "max", "disconet",
                 "who2com")
FUSION_FRAMES = 2  # a fusion's eval frames after one warm-up
FUSION_STEPS = 1   # and its train steps
# parameters whose gradient is zero in exact arithmetic: a bias that shifts
# every agent's score alike before a softmax over agents. Their gradients
# are the noise of cancelling terms, which a 1e-7 input jitter moved by up
# to 1.4 of their size, so hold_step logs them and holds the rest
EXACT_ZERO_GRADS = {
    "v2xvit": ("hmsa.k_typed.bias",), "who2com": ("key_proj.bias",),
    "where2comm": ("k_proj.bias",),
    "disconet": ("PixelWeightLayer_0.Conv_0.bias",)}


# phase 13, the HEAL pyramid: configs/opv2v/heal/stage1/m1_pyramid.yaml at
# full width (PointPillars m1 on a 512 x 256 grid, the ResNet backbone and
# the ResNeXt pyramid 64 / 128 / 256 at 3 / 5 / 8 blocks, heads at stride
# 2), its Adam and point_pillar_pyramid_loss with the occupancy pass; K3
# warps each level's feature and its 1-channel score in one pair launch
# (the two maps' own launches and one launch on the C + 1 channels, the
# JAX package's form, are timed beside), K3b each in its own launch
HEAL_CONFIGS = os.path.join(os.path.dirname(GENCOMM_CONFIGS), "heal")
PYRAMID_HYPES = load_yaml(os.path.join(HEAL_CONFIGS, "stage1",
                                       "m1_pyramid.yaml"))
PYRAMID = pyramid_kwargs(PYRAMID_HYPES)
PYRAMID_WARP_WIDTHS = [c for f in PYRAMID["fusion_backbone"]["num_filters"]
                       for c in (f, 1)]
# the kernels HEAL's workflow (phase 13 (c)) must launch
HEAL_KERNELS = ("pillar_canvas", "warp_affine", "splat_topk",
                "pillar_canvas_bwd", "warp_affine_bwd", "splat_topk_bwd",
                "nms_closure")

# phase 14, SECOND (modality m3): configs/opv2v/gencomm/stage1/m3_att.yaml's
# model at full width (0.1 m voxels over 204.8 x 102.4 x 4 m, 32,000 an
# agent slot; VoxelBackBone8x to a 256-channel 128 x 256 BEV; the pillar
# neck; heads at 32 x 64) on the flagship's scenes, with its Adam,
# multistep schedule and point_pillar_gencomm_loss. Its anchors and labels
# sit at feature_stride 8, the heads' grid: the yaml's 4 gives anchors of
# 64 x 128 (reference fault n)
SECOND_YAML = os.path.join(GENCOMM_CONFIGS, "stage1", "m3_att.yaml")
SECOND_STRIDE = 8
SECOND_HYPES = load_yaml(SECOND_YAML)
SECOND_HYPES["postprocess"]["anchor_args"]["feature_stride"] = SECOND_STRIDE
SECOND = model_kwargs(SECOND_HYPES)
SECOND_FEATURE_SHAPE = (32, 64, 128)
# the sparse ops of ops/sparse.py that the encoder calls, card against CPU:
# integer outputs equal, features within SPARSE_TOL x max(1, max|cpu|)
SPARSE_OPS = ("voxelize_mean", "subm_conv3d", "spconv3d_downsample",
              "scatter_to_dense")
SPARSE_TOL = 1e-5
# an operation of the frame's profile above this share of the streamed
# frame's device time queues a hand-written sparse kernel (ROADMAP section 2)
SPARSE_KERNEL_SHARE = 0.02


_T0 = time.perf_counter()


def log(*a):
    """Prints a line, led by the seconds since the process started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


_L2_FLUSH = []  # one buffer larger than the card's 50 MB L2, made at first use


def time_ms(fn, iters=20, warmup=3, cold=False):
    """Mean ms of ``fn`` over ``iters`` launches after ``warmup``. Warm: the
    launches follow each other, so what one left in the L2 cache the next
    finds. ``cold``: a 128 MB buffer is rewritten before every launch, which
    evicts the L2, and each launch is timed on its own."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.zeros(32 << 20, device="cuda"))
    pairs = []
    for _ in range(iters):
        _L2_FLUSH[0].add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def graph_ms(fn, n=GRAPH_LAUNCHES, reps=3):
    """Device ms per call of ``fn``: ``n`` calls captured in a CUDA graph
    (after two on a side stream), the graph replayed ``reps`` times between
    two CUDA events. No host work stands between the launches, so a short
    kernel's time is its own, where the profiler may drop its records
    (ROADMAP p3)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n)


def device_launches(fn, n=20):
    """{name: (device ms per launch, launches per call)} of every kernel,
    copy and memset ``fn`` launches, from torch.profiler, and the wrappers'
    counted launches per call. A launch's time is its records' total over
    the records the profiler saw, not over the calls made, so a dropped
    record leaves the mean right (ROADMAP p3)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gencomm_tpu_torch.ops import _cuda

    fn()
    torch.cuda.synchronize()
    counted = sum(_cuda.LAUNCHES.values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    counted = (sum(_cuda.LAUNCHES.values()) - counted) / n
    return {ev.key: (ev.self_device_time_total / ev.count / 1e3, ev.count / n)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0}, counted


def cold_device_ms(fn):
    """Device ms per call of ``fn``'s own launches with the L2 evicted
    before each call (``time_ms``'s buffer rewritten, its kernel left out
    of the sum), or None if the profiler saw none of them."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.zeros(32 << 20, device="cuda"))
    split, _ = device_launches(lambda: (_L2_FLUSH[0].add_(1.0), fn()))
    return per_call({k: v for k, v in split.items() if "at::" not in k}) or None


def per_call(split):
    """Device ms per call of a ``device_launches`` split: each launch's mean
    time times its launches a call, rounded and at least one."""
    return sum(ms * max(1, round(count)) for ms, count in split.values())


def records_short(split, counted):
    """Whether the profiler saw fewer records than ``fn`` launched: a name
    whose records are not a whole number a call, or fewer kernel records (no
    memset, no copy) a call than the wrappers counted launches."""
    kernels = sum(c for k, (_, c) in split.items()
                  if "Memset" not in k and "Memcpy" not in k)
    return (any(abs(c - round(c)) > 1e-9 for _, c in split.values())
            or kernels < counted - 1e-9)


def device_time(fn, n=20):
    """{"device_ms": device ms per call of ``fn`` (None if the profiler saw
    nothing), "records_short": whether records fell short of launches} for a
    kernel's row."""
    split, counted = device_launches(fn, n)
    short = records_short(split, counted)
    if short:
        log(f"  profiler records short of the launches: {split}, "
            f"{counted:g} counted a call")
    return {"device_ms": per_call(split) or None, "records_short": short}


def split_ms(label, fn, one_launch):
    """``device_time`` of ``fn``, logging the profiler's split of a call by
    launch; a library kernel (``at::``, ``cub::``) among them fails. With
    ``one_launch`` the call must launch one kernel and nothing else (no
    memset, no copy)."""
    # the profiler may drop a call's records (ROADMAP p3), now and then all
    # of them, three sessions in a row once: profile again, up to six
    # sessions, before reading an empty split
    for _ in range(6):
        split, counted = device_launches(fn)
        if split:
            break
    log(f"  {label}, one call's launches (device ms, launches): " + ", ".join(
        f"{short_name(k)} {ms:.4f} x{count:g}" for k, (ms, count) in split.items()))
    if any("at::" in k or "cub::" in k for k in split):
        raise AssertionError(f"{label} launched a library kernel: "
                             f"{sorted(split)}")
    if one_launch and (len(split) != 1 or any(
            round(count) > 1 or "Mem" in k for k, (_, count) in split.items())):
        raise AssertionError(f"{label}: one kernel launch a call expected, "
                             f"got {split}")
    return {"device_ms": per_call(split) or None,
            "records_short": records_short(split, counted)}


def short_name(key):
    """A kernel's profiler name without its namespace and arguments."""
    return (key.replace("void ", "").replace("(anonymous namespace)::", "")
            .split("(")[0].strip())


def warp_tolerance(src):
    """K3 vs its plain version: the plain version's scalar divisions round
    the sampling coordinate (up to max(H, W) pixels) differently in the
    last bit, which moves the bilinear blend by up to one coordinate ulp
    times the largest step between neighbours (<= 2 max|src|)."""
    h, w = src.shape[1], src.shape[2]
    return 4.0 * max(h, w) * 2.0 ** -23 * max(1.0, float(src.abs().max()))


def bf16_step(ref, scale):
    """One bf16 step (2^-7 of the leading bit) at |ref|, taken at no less
    than 2^-8 of ``scale``, the output's largest value: below that an
    fp32-level error of either product (1e-5 of the largest value,
    tests/test_torch_bf16_split.py) is more than a step of the value."""
    import torch

    m = torch.clamp(ref.float().abs(), min=2.0 ** -8 * scale)
    return torch.ldexp(torch.ones_like(m), torch.frexp(m).exponent - 8)


def bf16_steps_apart(got, ref):
    """(outputs that differ, outputs more than one bf16 step apart) of two
    bf16 tensors, the step taken at ``ref`` (``bf16_step``)."""
    got, ref = got.float(), ref.float()
    step = bf16_step(ref, float(ref.abs().max()))
    return int((got != ref).sum()), int(((got - ref).abs() > step).sum())


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops, moved, peak=PEAK_FP32_FLOPS):
    """(ms, what bounds it): the least time for ``flops`` operations at the
    rate ``peak`` (default fp32) and ``moved`` bytes on the card."""
    t_ops, t_bytes = flops / peak, moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def log_rows(rows):
    for row in rows:
        cold = (f" (cold L2 {row['cold_ms']:.4f} ms"
                + (f", {row['cold_device_ms']} on the device"
                   if "cold_device_ms" in row else "")
                + f", route {row['path_route']})" if "cold_ms" in row else "")
        short = (" (profiler records short of the launches)"
                 if row.get("records_short") else "")
        log(f"  {row['name']}: kernel {row['ms']:.4f} ms by events, "
            f"{row['device_ms']} ms on the device{short}{cold}, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms "
            f"({row['library_device_ms']} on the device), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")


def record_all(targets, run):
    """Calls ``run()`` with each wrapper ``(module, name)`` of ``targets``
    replaced by one that records its arguments (tensors detached and
    cloned); returns [(name, args, kwargs)] of every call, in order."""
    import torch
    from torch.utils._pytree import tree_map

    seen = []

    def clone(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            seen.append((name, tree_map(clone, args), tree_map(clone, kwargs)))
            return fn(*args, **kwargs)
        return wrapped

    saved = [getattr(mod, attr) for mod, attr in targets]
    try:
        for (mod, attr), fn in zip(targets, saved):
            setattr(mod, attr, recorder(attr, fn))
        run()
    finally:
        for (mod, attr), fn in zip(targets, saved):
            setattr(mod, attr, fn)
    return seen


def record_calls(targets, run):
    """``record_all``'s arguments of each wrapper's last call: {name:
    args}."""
    return {name: args for name, args, _ in record_all(targets, run)}


def add_rows(kernel_rows, path, rows):
    """Adds a later path's rows to the kernels JSON line: a kernel that has
    no row yet gets this one; for a kernel that has one (from the path that
    ran it first), the numbers taken on ``path``'s arguments go under
    ``other_paths`` of that row."""
    by_name = {row["name"]: row for row in kernel_rows}
    for row in rows:
        first = by_name.get(row["name"])
        if first is None:
            kernel_rows.append(row)
        else:
            first.setdefault("other_paths", {})[path] = {
                k: row[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "cold_ms", "cold_device_ms",
                                    "path_route", "route_launches",
                                    "turns_ms", "device_ms", "dtype",
                                    "library_device_ms", "records_short",
                                    "differ_from_fp32_kernel", "graph_ms",
                                    "library_graph_ms", "warp_route_graph_ms",
                                    "dx_sum_launches", "same_bits_twice")
                if k in row}


def route_launches():
    """{kernel name: {route: launches}} of the kernels that have routes."""
    from gencomm_tpu_torch.ops import deform_conv, pillar_canvas, warp

    return {**deform_conv.ROUTE_LAUNCHES, **deform_conv.HALF_ROUTE_LAUNCHES,
            "pillar_canvas_bwd": pillar_canvas.ROUTE_LAUNCHES,
            "warp_affine": warp.FORWARD_ROUTE_LAUNCHES,
            "warp_affine_bwd": warp.ROUTE_LAUNCHES}


def reset_launch_counts():
    """Every wrapper's launch count, and those by route, to 0."""
    from gencomm_tpu_torch.ops import _cuda

    for k in _cuda.LAUNCHES:
        _cuda.LAUNCHES[k] = 0
    for counts in route_launches().values():
        for route in counts:
            counts[route] = 0


def route_counts():
    """A copy of the launch counts by route, read where a path's run ends."""
    return {k: dict(v) for k, v in route_launches().items()}


def fill_launches(rows, launches, by_kernel, path):
    """The path's launch counts into the kernels' rows; for a kernel with
    routes also the counts by route (``by_kernel``, read with ``launches``
    where the path's run ended), which must show the route the check
    timed."""
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["name"] == "deform_conv3x3_bwd":
            # the input gradient's sum, one launch of K4's kernels a call
            row["dx_sum_launches"] = launches["deform_conv3x3_bwd_dx"]
        by_route = by_kernel.get(row["name"])
        if by_route is not None:
            row["route_launches"] = dict(by_route)
            if by_route[row["path_route"]] != row["launches"]:
                raise AssertionError(
                    f"{row['name']} on the {path} path: route "
                    f"{row['path_route']} expected, launches {by_route}")
    log(f"{path} path, launches by route: {by_kernel}")


def postprocess_cfg(gt_range):
    return dict(POSTPROCESS, gt_range=list(gt_range))


def phase_done(label, t0):
    log(f"phase wall time, {label}: {time.perf_counter() - t0:.1f} s")


def profile_device(run, period_ms, n, unit, operators=False):
    """Device busy time per ``unit`` and the kernels that take it, from
    torch.profiler over ``n`` calls of ``run(i)``; the busy time is the
    union of the kernels' intervals (the sum of their times logged beside
    it); the idle share is against the CUDA-event time ``period_ms`` per
    unit, where one is given. Returns the busy ms and the launches per unit
    and {operator: the device ms per unit of the kernels it launched
    itself}. The session traces the device alone unless ``operators`` is
    set: then it also traces the host's operators with their argument
    shapes, logs the operators and the convolution operators by shape (a
    cuDNN kernel's layer), and fills the dict. Host tracing costs the
    session 5-9 s on the host for a training step's ~10,000 kernels; the
    device's alone 1-3 s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if operators
                  else [ProfilerActivity.CUDA])
    with profile(activities=activities, record_shapes=operators) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    # kernel-level events only: the aten ops above them, and annotations
    # such as the optimizer's step range, carry the same device time again
    rows = [(ev.self_device_time_total / n / 1e3, ev.count / n, ev.key)
            for ev in avg
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)
            and not ev.key.startswith("Optimizer.")]
    ops = {ev.key: ev.self_device_time_total / n / 1e3 for ev in avg
           if ev.device_type == DeviceType.CPU
           and ev.self_device_time_total > 0}
    busy_sum = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    if busy_sum <= 0:
        log("profile: the profiler saw no device time")
        return 0.0, 0.0, ops
    # ROADMAP p7: the busy time is the union of the kernels' intervals on
    # the device's clock, so that kernels that overlap (two streams, a
    # cooperative launch beside a copy) count once; the sum beside it
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)
                   and not ev.key.startswith("Optimizer.")
                   and ev.time_range.end > ev.time_range.start)
    union, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo >= end:
            union += hi - lo
            end = hi
        elif hi > end:
            union += hi - end
            end = hi
    busy = union / n / 1e3 if spans else busy_sum
    union_text = (f"union of {len(spans)} kernel intervals; their sum "
                  f"{busy_sum:.3f}" if spans else
                  f"sum of kernel times (the union not measured: no "
                  f"intervals)")
    idle = (f" of {period_ms:.3f} ms (idle share {1 - busy / period_ms:.3f})"
            if period_ms else "")
    log(f"profile: device busy {busy:.3f} ms/{unit}{idle} ({union_text}), "
        f"{launches:.0f} kernels and copies per {unit}; top by device time "
        f"(ms/{unit}, calls/{unit}):")
    for dev_ms, calls, key in sorted(rows, reverse=True)[:15]:
        log(f"  {dev_ms:8.4f} {calls:6.0f}  {key[:90]}")
    if operators:
        log(f"profile: operators by the device time of their own kernels "
            f"(ms/{unit}):")
        for key, v in sorted(ops.items(), key=lambda kv: -kv[1])[:12]:
            log(f"  {v:8.4f}  {key}")
        # which layers the convolution kernels belong to: the operators
        # that launch them, by the shapes of their arguments
        convs = [(ev.self_device_time_total / n / 1e3, ev.count / n, ev.key,
                  [s for s in (getattr(ev, "input_shapes", None) or []) if s])
                 for ev in prof.key_averages(group_by_input_shape=True)
                 if ev.device_type == DeviceType.CPU and "conv" in ev.key
                 and ev.self_device_time_total > 0]
        log(f"profile: convolution operators by argument shapes (device "
            f"ms/{unit}, calls/{unit}):")
        for dev_ms, calls, key, shapes in sorted(convs, reverse=True)[:8]:
            log(f"  {dev_ms:8.4f} {calls:6.0f}  {key} {shapes}")
    # cuDNN's FFT convolutions (PERF.md section 5: which dtypes pick them):
    # the transforms and the product in the frequency domain
    fft = [r for r in rows if "fft" in r[2].lower() or "complex" in r[2]]
    log(f"profile: FFT convolution kernels {sum(r[0] for r in fft):.3f} "
        f"ms/{unit} in {len(fft)} kernels")
    return busy, launches, ops


def check_deform(inputs, where, graph=False):
    """K1 (deformable 3x3 conv) against its plain version on the arguments
    the path ``where`` gives it; returns its row of the kernels JSON line
    (launches filled in later). On a bf16 map (``half``) the row is K1's
    bf16 instantiation's, which must also give the same bits on two
    launches and lie within one bf16 step of the fp32 kernel's output on the
    widened map, rounded once (the outputs that differ are counted). With
    ``graph`` the row also has the device time over a CUDA graph
    (``graph_ms``)."""
    import torch
    from gencomm_tpu_torch.ops.deform_conv import (
        deform_conv3x3, deform_conv3x3_plain, kernel_route,
    )

    x, off, wt = inputs["deform_conv3x3"]
    half = x.dtype == torch.bfloat16
    b, h, w, cin = x.shape
    cout = wt.shape[-1]
    got, want = deform_conv3x3(x, off, wt), deform_conv3x3_plain(x, off, wt)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    # fp32 sums in another order; in bf16 then one rounding each, which may
    # land one bf16 step (2^-7 of the largest value) apart
    tol = 1e-4 * max(1.0, scale) + (2.0 ** -7 * scale if half else 0.0)
    log(f"K1 deform_conv3x3 ({where}, {x.dtype}) x{tuple(x.shape)} "
        f"w{tuple(wt.shape)}: max|kernel-plain| {err:.3e} (tol {tol:.3e}: "
        f"fp32 sums of {9 * cin} products in another order"
        + (", then one bf16 rounding)" if half else ")"))
    if not err <= tol:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")
    differ = None
    if half:
        # the tensor-core route's split bf16 product sums in another order
        # than the fp32 kernel: a rounded output may land one bf16 step from
        # the fp32 kernel's on the widened map
        again = deform_conv3x3(x, off, wt)
        ref = deform_conv3x3(x.float(), off, wt).to(torch.bfloat16)
        torch.cuda.synchronize()
        twice = torch.equal(got, again)
        differ, beyond = bf16_steps_apart(got, ref)
        log(f"  K1 bf16: two launches bit-equal {twice}; {differ} of "
            f"{got.numel()} outputs differ from the fp32 kernel's on the "
            f"widened map, rounded once, {beyond} of them by more than one "
            f"bf16 step")
        if not twice:
            raise AssertionError("K1 bf16 gave different bits on a second launch")
        if beyond:
            raise AssertionError(f"K1 bf16: {beyond} outputs more than one "
                                 f"bf16 step from the fp32 kernel's")
    bound_ms, bound_by = bound(kernel_ops("deform_conv3x3", x, off, wt),
                               nbytes(x, off, wt, got),
                               PEAK_BF16_FLOPS if half else PEAK_FP32_FLOPS)
    row = dict(
        name="deform_conv3x3_bf16" if half else "deform_conv3x3",
        route="cuda", dtype="bf16" if half else "fp32",
        source="gencomm_tpu_torch/csrc/deform_conv.cu",
        replaces="gencomm_tpu/ops/deform_pallas.py:34",
        max_abs_err=err,
        ms=time_ms(lambda: deform_conv3x3(x, off, wt)),
        **device_time(lambda: deform_conv3x3(x, off, wt)),
        cold_ms=time_ms(lambda: deform_conv3x3(x, off, wt), cold=True),
        path_route=kernel_route(cin, cout), differ_from_fp32_kernel=differ,
        plain_ms=time_ms(lambda: deform_conv3x3_plain(x, off, wt), iters=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library_device_ms=None)
    if graph:
        row["graph_ms"] = graph_ms(lambda: deform_conv3x3(x, off, wt))
        log(f"  K1 over a graph of {GRAPH_LAUNCHES} launches: "
            f"{row['graph_ms']:.4f} ms")
    log_rows([row])
    return row


def check_deform_general(dev):
    """K1 and K1b on their general route (channel counts the tensor-core
    route does not take, a ragged map, offsets up to +-9 so that corners lie
    anywhere in the map) against the plain versions; returns the two
    errors for the kernels JSON line."""
    import torch
    from gencomm_tpu_torch.ops.deform_conv import (
        ROUTE_LAUNCHES, deform_conv3x3_bwd, deform_conv3x3_bwd_plain,
        deform_conv3x3_fwd, deform_conv3x3_plain, kernel_route,
    )

    b, h, w, cin, cout = GENERAL_SHAPE
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(b, h, w, cin, generator=gen).to(dev)
    off = (torch.randn(b, h, w, 18, generator=gen) * 3.0).clamp(-9, 9).to(dev)
    wt = (torch.randn(3, 3, cin, cout, generator=gen) * 0.1).to(dev)
    g = torch.randn(b, h, w, cout, generator=gen).to(dev)
    if kernel_route(cin, cout) != "general":
        raise AssertionError(f"{GENERAL_SHAPE} does not take the general route")
    before = {k: v["general"] for k, v in ROUTE_LAUNCHES.items()}
    want = deform_conv3x3_plain(x, off, wt)
    err = float((deform_conv3x3_fwd(x, off, wt) - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    if not err <= tol:
        raise AssertionError(f"K1 general route disagrees: {err} > {tol}")
    err_b = 0.0
    for name, gv, wv in zip(("dx", "doffsets", "dweight"),
                            deform_conv3x3_bwd(x, off, wt, g),
                            deform_conv3x3_bwd_plain(x, off, wt, g)):
        e, scale = float((gv - wv).abs().max()), float(wv.abs().max())
        if not e <= K1B_TOL * scale:
            raise AssertionError(f"K1b general route, {name}: {e} vs {scale}")
        err_b = max(err_b, e)
    torch.cuda.synchronize()
    if any(ROUTE_LAUNCHES[k]["general"] != before[k] + 1 for k in before):
        raise AssertionError("the general route was not launched")
    log(f"K1 / K1b general route x{GENERAL_SHAPE[:4]} -> {cout}, offsets to "
        f"+-9: max|kernel-plain| {err:.3e} (tol {tol:.3e}) / {err_b:.3e} "
        f"(tol {K1B_TOL:.0e} x max|plain|)")
    return {"deform_conv3x3": err, "deform_conv3x3_bwd": err_b}


def check_pillar(inputs, where):
    """K2 (pillar segment-max canvas) against its plain version, bit for
    bit, on the arguments the path ``where`` gives it; returns its row."""
    import torch
    from gencomm_tpu_torch.ops.pillar_canvas import (
        pillar_canvas, pillar_canvas_plain,
    )

    r, g, n_agents, ncell = inputs["pillar_canvas"]
    got, want = pillar_canvas(r, g, n_agents, ncell), pillar_canvas_plain(
        r, g, n_agents, ncell)
    again = pillar_canvas(r, g, n_agents, ncell)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    twice = torch.equal(got.view(torch.int16), again.view(torch.int16))
    err = float((got.float() - want.float()).abs().max())
    tail = [int((g.view(n_agents, -1)[a] >= ncell - 1).sum())
            for a in range(n_agents)]
    log(f"K2 pillar_canvas ({where}) rows{tuple(r.shape)} -> "
        f"{tuple(got.shape)}: "
        f"bit-exact {same}, two launches bit-equal {twice}, occupied cells "
        f"{int((want > 0).any(-1).sum())}, rows in each agent's last cell "
        f"{tail}")
    if not same:
        raise AssertionError(f"K2 is not bit-exact (max abs diff {err})")
    if not twice:
        raise AssertionError("K2 gave different bits on a second launch")
    m, c = r.shape
    idx = (torch.arange(m, device=r.device) // (m // n_agents) * ncell
           + g.long().clamp(0, ncell - 1))[:, None].expand(m, c)
    zeros = torch.zeros(n_agents * ncell, c, dtype=r.dtype, device=r.device)
    k2_bytes = nbytes(r, g, got)

    def library():
        return torch.scatter_reduce(zeros, 0, idx, r, "amax",
                                    include_self=True)

    row = dict(
        name="pillar_canvas", route="cuda",
        source="gencomm_tpu_torch/csrc/pillar_canvas.cu",
        replaces="gencomm_tpu/ops/pillar_pallas.py:58",
        max_abs_err=err,
        ms=time_ms(lambda: pillar_canvas(r, g, n_agents, ncell)),
        # a memset and one kernel
        **split_ms("K2", lambda: pillar_canvas(r, g, n_agents, ncell),
                   one_launch=False),
        plain_ms=time_ms(lambda: pillar_canvas_plain(r, g, n_agents, ncell)),
        bound_ms=k2_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=time_ms(library),
        library_device_ms=device_time(library)["device_ms"])
    log_rows([row])
    return row


def check_warp(inputs, where, graph=False):
    """K3 (affine bilinear warp) against its plain version on the arguments
    the path ``where`` gives it; returns its row. On a bf16 map (``half``)
    the row is K3's bf16 instantiation's, which must also give the bits of
    the fp32 kernel on the widened map, rounded once; its library yardstick
    is ``F.grid_sample`` on the bf16 map (with a bf16 grid, which that call
    requires). With ``graph`` the row also has device times over CUDA
    graphs (``graph_ms``, ``library_graph_ms``)."""
    import torch
    import torch.nn.functional as F
    from gencomm_tpu_torch.ops.warp import (
        forward_route, warp_affine, warp_affine_plain,
    )

    src, theta = inputs["warp_affine"]
    half = src.dtype == torch.bfloat16
    route = forward_route(src.shape[-1], src.data_ptr() % 16 == 0,
                          8 if half else 4)
    got, want = warp_affine(src, theta), warp_affine_plain(src, theta)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = warp_tolerance(src.float()) + (
        2.0 ** -7 * float(src.float().abs().max()) if half else 0.0)
    log(f"K3 warp_affine ({where}, {src.dtype}) src{tuple(src.shape)}, "
        f"route {route}: max|kernel-plain| {err:.3e} "
        f"(tol {tol:.3e}: a one-ulp difference of the sampling coordinate "
        f"times the largest neighbour step"
        + (", then one bf16 rounding)" if half else ")"))
    if not err <= tol:
        raise AssertionError(f"K3 disagrees with its plain version: {err}")
    if half:
        same = torch.equal(got, warp_affine(src.float(), theta).to(
            torch.bfloat16))
        log(f"  K3 bf16 equals the fp32 kernel on the widened map, rounded "
            f"once: {same}")
        if not same:
            raise AssertionError("K3 bf16 differs from the fp32 kernel's "
                                 "rounded output")
    src_nchw = src.permute(0, 3, 1, 2).contiguous()
    grid = F.affine_grid(theta.to(src.dtype), list(src_nchw.shape),
                         align_corners=False)
    k3_bytes = nbytes(src, theta, got)

    def library():
        return F.grid_sample(src_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=False)

    # K3 and the library call in turns in this one process, K3_TURN_LAUNCHES
    # launches a turn: the spread of the repeats says whether a difference
    # between the two is one
    turns = [(time_ms(lambda: warp_affine(src, theta), iters=K3_TURN_LAUNCHES),
              time_ms(library, iters=K3_TURN_LAUNCHES)) for _ in range(3)]
    k3_ms, lib_ms = ([t[i] for t in turns] for i in (0, 1))
    k3_time = device_time(lambda: warp_affine(src, theta))
    k3_dev = k3_time["device_ms"]
    lib_dev = device_time(library)["device_ms"]
    log(f"  K3 against F.grid_sample in turns, {K3_TURN_LAUNCHES} launches "
        f"each: K3 {', '.join(f'{t:.4f}' for t in k3_ms)} ms; grid_sample "
        f"{', '.join(f'{t:.4f}' for t in lib_ms)} ms; device time alone "
        f"(torch.profiler): K3 {k3_dev} ms, grid_sample {lib_dev} ms")
    row = dict(
        name="warp_affine_bf16" if half else "warp_affine", route="cuda",
        dtype="bf16" if half else "fp32", path_route=route,
        source="gencomm_tpu_torch/csrc/warp_affine.cu",
        replaces="gencomm_tpu/ops/warp_pallas.py:43",
        max_abs_err=err,
        ms=sum(k3_ms) / len(k3_ms),
        cold_ms=time_ms(lambda: warp_affine(src, theta), cold=True),
        cold_device_ms=cold_device_ms(lambda: warp_affine(src, theta)),
        plain_ms=time_ms(lambda: warp_affine_plain(src, theta)),
        bound_ms=k3_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=sum(lib_ms) / len(lib_ms),
        turns_ms={"kernel": k3_ms, "library": lib_ms},
        **k3_time, library_device_ms=lib_dev)
    if graph:
        row.update(graph_ms=graph_ms(lambda: warp_affine(src, theta)),
                   library_graph_ms=graph_ms(library))
        log(f"  K3 over a graph of {GRAPH_LAUNCHES} launches: "
            f"{row['graph_ms']:.4f} ms, grid_sample "
            f"{row['library_graph_ms']:.4f} ms")
    log_rows([row])
    return row


def check_deform_bwd(inputs, where):
    """K1b (deformable conv backward) against its plain version on the
    arguments the train step ``where`` gives it; returns its row of the
    kernels JSON line (launches filled in later)."""
    import torch
    from gencomm_tpu_torch.ops.deform_conv import (
        deform_conv3x3_bwd, deform_conv3x3_bwd_plain, kernel_route,
    )

    x, off, wt, g = inputs["deform_conv3x3_bwd"]
    b, h, w, cin = x.shape
    cout = wt.shape[-1]
    got = deform_conv3x3_bwd(x, off, wt, g)
    again = deform_conv3x3_bwd(x, off, wt, g)
    want = deform_conv3x3_bwd_plain(x, off, wt, g)
    torch.cuda.synchronize()
    # every gradient is summed in a fixed order, dx by K4's kernels
    twice = {n: torch.equal(a, c) for n, a, c in zip(
        ("dx", "doffsets", "dweight"), got, again)}
    log(f"K1b ({where}): two launches bit-equal {twice}")
    if not all(twice.values()):
        raise AssertionError(f"K1b differs between two runs: {twice}")
    err = 0.0
    for name, gv, wv in zip(("dx", "doffsets", "dweight"), got, want):
        e = float((gv - wv).abs().max())
        scale = float(wv.abs().max())
        log(f"K1b {name}{tuple(gv.shape)} ({where}): max|kernel-plain| "
            f"{e:.3e}, "
            f"max|plain| {scale:.3e} (tol {K1B_TOL:.0e} x max|plain|: fp32 "
            f"sums of up to {b * h * w} terms in other orders)")
        if not e <= K1B_TOL * scale:
            raise AssertionError(f"K1b {name} disagrees with its plain "
                                 f"version: {e} vs scale {scale}")
        err = max(err, e)
    npix = b * h * w
    bound_ms, bound_by = bound(
        kernel_ops("deform_conv3x3_bwd", x, off, wt, g),
        nbytes(x, off, wt, g, *got))
    row = dict(
        name="deform_conv3x3_bwd", route="cuda",
        source="gencomm_tpu_torch/csrc/deform_conv_bwd.cu",
        replaces="gencomm_tpu/ops/deform_pallas.py:93",
        max_abs_err=err, same_bits_twice=all(twice.values()),
        ms=time_ms(lambda: deform_conv3x3_bwd(x, off, wt, g)),
        **device_time(lambda: deform_conv3x3_bwd(x, off, wt, g)),
        cold_ms=time_ms(lambda: deform_conv3x3_bwd(x, off, wt, g), cold=True),
        path_route=kernel_route(cin, cout, backward=True),
        plain_ms=time_ms(lambda: deform_conv3x3_bwd_plain(x, off, wt, g),
                         iters=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library_device_ms=None)
    log_rows([row])
    return row


def check_pillar_bwd(inputs, where):
    """K2b (pillar canvas backward) against its plain version, bit for bit,
    on the arguments the train step ``where`` gives it; returns its row."""
    import torch
    from gencomm_tpu_torch.ops.pillar_canvas import (
        backward_route, pillar_canvas_bwd, pillar_canvas_bwd_plain,
    )

    r, gids, canvas, gout, n_agents, ncell = inputs["pillar_canvas_bwd"]
    got = pillar_canvas_bwd(r, gids, canvas, gout, n_agents, ncell)
    want = pillar_canvas_bwd_plain(r, gids, canvas, gout, n_agents, ncell)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    err = float((got.float() - want.float()).abs().max())
    m, c = r.shape
    cells = (torch.arange(m, device=r.device) // (m // n_agents) * ncell
             + gids.long().clamp(0, ncell - 1))
    n_cells = int(torch.unique(cells).numel())
    log(f"K2b pillar_canvas_bwd ({where}) rows{tuple(r.shape)}: bit-exact "
        f"{same}, "
        f"{n_cells} cells hold rows, {int((got != 0).any(-1).sum())} rows "
        f"get a gradient")
    if not same:
        raise AssertionError(f"K2b is not bit-exact (max abs diff {err})")
    # the library's yardstick: autograd of one scatter_reduce amax
    r_req = r.detach().clone().requires_grad_()
    lib_out = torch.zeros(n_agents * ncell, c, dtype=r.dtype,
                          device=r.device).scatter_reduce(
        0, cells[:, None].expand(m, c), r_req, "amax", include_self=True)
    gflat = gout.reshape(-1, c)
    k2b_bytes = nbytes(r, gids, got) + 2 * n_cells * c * r.element_size()

    def kernel():
        return pillar_canvas_bwd(r, gids, canvas, gout, n_agents, ncell)

    def library():
        return torch.autograd.grad(lib_out, r_req, gflat, retain_graph=True)

    row = dict(
        name="pillar_canvas_bwd", route="cuda",
        source="gencomm_tpu_torch/csrc/pillar_canvas_bwd.cu",
        replaces="gencomm_tpu/models/encoders/point_pillar.py:189",
        max_abs_err=err,
        ms=time_ms(kernel), **device_time(kernel),
        path_route=backward_route(c, m, n_agents * ncell),
        plain_ms=time_ms(lambda: pillar_canvas_bwd_plain(
            r, gids, canvas, gout, n_agents, ncell)),
        bound_ms=k2b_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=time_ms(library),
        library_device_ms=device_time(library)["device_ms"])
    log_rows([row])
    return row


def check_pillar_bwd_general(dev):
    """K2b on its general route (a channel count the 64-channel route does
    not take, an odd number of channel pairs) against the plain version, bit
    for bit: short runs with ties, all-zero rows, an agent boundary inside a
    chunk and a clamped tail longer than 256 rows. Returns the error for the
    kernels JSON line."""
    import torch
    from gencomm_tpu_torch.ops.pillar_canvas import (
        ROUTE_LAUNCHES, backward_route, pillar_canvas_bwd,
        pillar_canvas_bwd_plain, pillar_canvas_plain,
    )

    n_agents, per_agent, c, ncell = GENERAL_CANVAS
    if backward_route(c, n_agents * per_agent, n_agents * ncell) != "general":
        raise AssertionError(f"{GENERAL_CANVAS} does not take the general route")
    gen = torch.Generator().manual_seed(6)
    gids = torch.randint(0, 3 * ncell, (n_agents, per_agent), generator=gen,
                         dtype=torch.int32).sort(dim=1).values.reshape(-1)
    # a few values only, so rows tie at their cell's max; ids >= ncell are
    # the zeroed invalid tail
    rows = torch.randint(0, 4, (n_agents * per_agent, c), generator=gen) * 0.5
    rows[gids >= ncell] = 0.0
    rows, gids = rows.to(dev, torch.bfloat16), gids.to(dev)
    gout = torch.randn(n_agents, ncell, c, generator=gen).to(dev, torch.bfloat16)
    canvas = pillar_canvas_plain(rows, gids, n_agents, ncell)
    before = ROUTE_LAUNCHES["general"]
    got = pillar_canvas_bwd(rows, gids, canvas, gout, n_agents, ncell)
    want = pillar_canvas_bwd_plain(rows, gids, canvas, gout, n_agents, ncell)
    torch.cuda.synchronize()
    if ROUTE_LAUNCHES["general"] != before + 1:
        raise AssertionError("K2b's general route was not launched")
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    err = float((got.float() - want.float()).abs().max())
    log(f"K2b general route rows{tuple(rows.shape)}, {n_agents} agents, "
        f"{ncell} cells: bit-exact {same}")
    if not same:
        raise AssertionError(f"K2b general route is not bit-exact ({err})")
    return {"pillar_canvas_bwd": err}


def hold_warp_bwd(g3, theta, where):
    """K3b on its route for this map against its plain version, and two of
    its launches against each other bit for bit; on the pixel route also
    against the warp route, bit for bit. Returns the error."""
    import torch
    from gencomm_tpu_torch.ops.warp import (
        backward_route, warp_affine_bwd, warp_affine_bwd_plain,
    )

    route = backward_route(g3.shape[-1])
    got = warp_affine_bwd(g3, theta)
    again = warp_affine_bwd(g3, theta)
    want = warp_affine_bwd_plain(g3, theta)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    twice = torch.equal(got, again)
    h3, w3 = g3.shape[1], g3.shape[2]
    tol = 16.0 * max(h3, w3) * 2.0 ** -23 * float(g3.abs().max())
    log(f"K3b warp_affine_bwd ({where}) g{tuple(g3.shape)}, route {route}: "
        f"max|kernel-plain| "
        f"{err:.3e} (tol {tol:.3e}: a one-ulp difference of the sampling "
        f"coordinate times the cotangent, over up to 16 contributions), two "
        f"launches bit-equal {twice}")
    if not err <= tol:
        raise AssertionError(f"K3b disagrees with its plain version: {err}")
    if not twice:
        raise AssertionError("K3b gave different bits on a second launch")
    if route != "warp":
        same = torch.equal(got, warp_affine_bwd(g3, theta, "warp"))
        log(f"  K3b route {route} gives the warp route's bits: {same}")
        if not same:
            raise AssertionError(f"K3b's {route} route differs from its "
                                 f"warp route ({where})")
    return err


def check_warp_bwd_general(dev):
    """K3b on thetas that no path of the system builds (every one it builds
    is rigid): a zero theta (a singular map: every source pixel searches the
    whole map), a 4x zoom, a nearly singular shear and a rotation with
    scale, at 128 channels (the warp route) and at 6, 3, 2 and 1 (the
    pixel route, also held to the warp route's bits). Returns the error
    for the kernels JSON line."""
    import torch

    thetas = torch.tensor(GENERAL_THETAS, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(7)
    err = 0.0
    for c in (128, 6, 3, 2, 1):
        g3 = torch.randn((len(thetas),) + GENERAL_WARP_MAP + (c,),
                         generator=gen).to(dev)
        err = max(err, hold_warp_bwd(g3, thetas, f"general thetas, {c} "
                                                 f"channels"))
    return {"warp_affine_bwd": err}


def check_warp_general(dev):
    """K3 on the thetas of ``check_warp_bwd_general`` on each of its
    routes: rows (8 and 128 channels), pixel (1, 3, and 4 off a 16-byte
    boundary), scalar (5, 17, 65, and 128 off a 16-byte boundary), against its
    plain version and twice for the same bits; each map off the boundary
    also with its rows route's bits. Returns the error for the kernels
    JSON line."""
    import torch
    from gencomm_tpu_torch.ops.warp import (
        FORWARD_ROUTE_LAUNCHES, forward_route, warp_affine, warp_affine_plain,
    )

    thetas = torch.tensor(GENERAL_THETAS, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(8)
    err = 0.0
    for c, offset in ((8, False), (128, False), (1, False), (3, False),
                      (4, True), (5, False), (17, False), (65, False),
                      (128, True)):
        src = torch.randn((len(thetas),) + GENERAL_WARP_MAP + (c,),
                          generator=gen).to(dev)
        rows = warp_affine(src, thetas) if offset else None
        if offset:  # a copy 4 bytes past a 16-byte boundary
            buf = torch.empty(src.numel() + 1, device=dev)
            buf[1:].copy_(src.reshape(-1))
            src = buf[1:].view(src.shape)
        route = forward_route(c, not offset)
        before = dict(FORWARD_ROUTE_LAUNCHES)
        got, again = warp_affine(src, thetas), warp_affine(src, thetas)
        want = warp_affine_plain(src, thetas)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        tol = warp_tolerance(src)
        same = torch.equal(got, again) and (rows is None
                                            or torch.equal(got, rows))
        log(f"K3 general thetas, {c} channels{' off 16 bytes' if offset else ''}"
            f": route {route}, max|kernel-plain| {e:.3e} (tol {tol:.3e}), "
            f"same bits twice{' and as its rows route' if offset else ''}: "
            f"{same}")
        if FORWARD_ROUTE_LAUNCHES[route] != before[route] + 2:
            raise AssertionError(f"K3 at {c} channels: route {route} "
                                 f"expected, launches {FORWARD_ROUTE_LAUNCHES}")
        if not (e <= tol and same):
            raise AssertionError(f"K3's {route} route at {c} channels: error "
                                 f"{e}, same bits {same}")
        err = max(err, e)
    return {"warp_affine": err}


def check_warp_bwd(inputs, where, graph=False):
    """K3b (affine warp backward) against its plain version on the
    arguments the train step ``where`` gives it; returns its row. With
    ``graph`` the row also has device times over CUDA graphs (``graph_ms``)
    of K3b on its route, on the warp route and of the library call."""
    import torch
    import torch.nn.functional as F
    from gencomm_tpu_torch.ops.warp import (
        backward_route, warp_affine_bwd, warp_affine_bwd_plain,
    )

    g3, theta = inputs["warp_affine_bwd"]
    err = hold_warp_bwd(g3, theta, where)
    src_req = torch.zeros(g3.shape, device=g3.device).permute(
        0, 3, 1, 2).contiguous().requires_grad_()
    grid = F.affine_grid(theta, list(src_req.shape), align_corners=False)
    lib_out = F.grid_sample(src_req, grid, mode="bilinear",
                            padding_mode="zeros", align_corners=False)
    g_nchw = g3.permute(0, 3, 1, 2).contiguous()

    def library():
        return torch.autograd.grad(lib_out, src_req, g_nchw, retain_graph=True)

    row = dict(
        name="warp_affine_bwd", route="cuda",
        source="gencomm_tpu_torch/csrc/warp_affine_bwd.cu",
        replaces="gencomm_tpu/ops/warp_pallas.py:122",
        max_abs_err=err,
        ms=time_ms(lambda: warp_affine_bwd(g3, theta)),
        **split_ms("K3b", lambda: warp_affine_bwd(g3, theta),
                   one_launch=True),
        plain_ms=time_ms(lambda: warp_affine_bwd_plain(g3, theta)),
        bound_ms=nbytes(g3, theta, g3) / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=time_ms(library),
        library_device_ms=device_time(library)["device_ms"],
        path_route=backward_route(g3.shape[-1]))
    if graph:
        n, h, w, c = g3.shape
        zeros = torch.zeros(n, c, h, w, device=g3.device)
        row.update(
            graph_ms=graph_ms(lambda: warp_affine_bwd(g3, theta)),
            warp_route_graph_ms=graph_ms(
                lambda: warp_affine_bwd(g3, theta, "warp")),
            library_graph_ms=graph_ms(
                lambda: torch.ops.aten.grid_sampler_2d_backward(
                    g_nchw, zeros, grid, 0, 0, False, [True, False])))
        log(f"  K3b over a graph of {GRAPH_LAUNCHES} launches: route "
            f"{row['path_route']} {row['graph_ms']:.4f} ms, route warp "
            f"{row['warp_route_graph_ms']:.4f} ms, autograd of grid_sample "
            f"(aten::grid_sampler_2d_backward) {row['library_graph_ms']:.4f} "
            f"ms")
    log_rows([row])
    return row


def grad_errors(model, ref_model, names=None):
    """Per parameter (of ``names``, default all): (|g - g_ref| / |g_ref|
    (L2), max|g - g_ref| / max|g_ref|) of the gradients."""
    ref = dict(ref_model.named_parameters())
    errs = {}
    for name, p in model.named_parameters():
        if names is not None and name not in names:
            continue
        want = ref[name].grad.double()
        diff = p.grad.detach().cpu().double() - want
        errs[name] = (float(diff.norm() / want.norm()),
                      float(diff.abs().max() / want.abs().max()))
    return errs


def log_grad_errors(label, errs):
    """Logs the worst five of ``grad_errors``' by L2."""
    worst = sorted((l2, mx, n) for n, (l2, mx) in errs.items())[-5:]
    log(f"{label}, gradients of {len(errs)} parameters, worst five by L2: "
        + ", ".join(f"{n} {l2:.2e} (max {mx:.2e})" for l2, mx, n in worst))


def check_splat(inputs, where):
    """K4 against its plain version on the arguments ``where`` (the camera
    eval path or train step) gives it; returns its row of the kernels JSON
    line (launches filled in later)."""
    import torch
    from gencomm_tpu_torch.ops.splat import (
        sort_ids, splat_topk_fwd, splat_topk_plain, splat_topk_with_order,
    )

    dvals, feats, ids, num_cells, bf16_rows = inputs["splat_topk"]
    (p, k), c = dvals.shape, feats.shape[-1]
    err = 0.0
    for bf16 in (bf16_rows, True):
        got = splat_topk_fwd(dvals, feats, ids, num_cells, bf16)
        again = splat_topk_fwd(dvals, feats, ids, num_cells, bf16)
        want = splat_topk_plain(dvals, feats, ids, num_cells, bf16)
        torch.cuda.synchronize()
        e, scale = float((got - want).abs().max()), float(want.abs().max())
        tol = SPLAT_TOL * max(1.0, scale)
        log(f"K4 splat_topk ({where}, bf16_rows={bf16}) dvals{(p, k)} "
            f"feats{(p, c)} -> {tuple(got.shape)}: max|kernel-plain| {e:.3e}, "
            f"max|plain| {scale:.3e} (tol {tol:.3e}: fp32 sums of a cell's "
            f"rows in another order; the plain index_add_ uses atomics), "
            f"two launches bit-equal {torch.equal(got, again)}")
        if not e <= tol:
            raise AssertionError(f"K4 disagrees with its plain version: {e}")
        if not torch.equal(got, again):
            raise AssertionError("K4 gave different bits on a second launch")
        if not bool((got[(want == 0).all(-1)] == 0).all()):
            raise AssertionError("K4 left a cell that receives nothing non-zero")
        err = max(err, e)
    valid = (ids >= 0) & (ids < num_cells)
    kept = int(valid.sum())
    cells, counts = torch.unique(ids[valid], return_counts=True)
    log(f"  {kept} of {p * k} rows land in {cells.numel()} of "
        f"{num_cells} cells, the longest run {int(counts.max())} rows; "
        f"{p * k - kept} rows are dropped")
    # the order the kernel summed in is a stable sort's, without its tail of
    # dropped rows
    _, sids, order = splat_topk_with_order(dvals, feats, ids, num_cells,
                                           bf16_rows)
    want_sids, want_order = sort_ids(ids, num_cells)
    stable = (sids.numel() == kept and torch.equal(order, want_order[:kept])
              and torch.equal(sids, want_sids[:kept]))
    log(f"  the kernel's order of the {kept} kept rows equals "
        f"torch.sort(stable=True)'s: {stable}")
    if not stable:
        raise AssertionError("K4's row order is not the stable sort's")
    flat = torch.where(valid, ids, torch.full_like(ids, num_cells)).reshape(-1)
    rows = (dvals[..., None] * feats[:, None, :]).reshape(-1, c)
    zeros = torch.zeros(num_cells + 1, c, device=dvals.device)
    flat_long = flat.long()
    bound_ms, bound_by = bound(kernel_ops("splat_topk", dvals, feats),
                               nbytes(dvals, feats, ids) + num_cells * c * 4)

    def kernel():
        return splat_topk_fwd(dvals, feats, ids, num_cells, bf16_rows)

    def library():
        return torch.index_add(zeros, 0, flat_long, rows)

    row = dict(
        name="splat_topk", route="cuda",
        source="gencomm_tpu_torch/csrc/splat_topk.cu",
        replaces="gencomm_tpu/ops/splat_pallas.py:61",
        max_abs_err=err, ms=time_ms(kernel),
        **split_ms("K4", kernel, one_launch=False),
        plain_ms=time_ms(lambda: splat_topk_plain(dvals, feats, ids,
                                                  num_cells, bf16_rows)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(library),
        library_device_ms=device_time(library)["device_ms"])
    log_rows([row])
    return row


def check_splat_bwd(inputs):
    """K4b against its plain version on the camera train step's arguments;
    returns its row."""
    import torch
    from gencomm_tpu_torch.ops.splat import (
        splat_topk_bwd, splat_topk_bwd_plain,
    )

    dvals, feats, ids, gout, num_cells = inputs["splat_topk_bwd"]
    (p, k), c = dvals.shape, feats.shape[-1]
    got = splat_topk_bwd(dvals, feats, ids, gout, num_cells)
    want = splat_topk_bwd_plain(dvals, feats, ids, gout, num_cells)
    torch.cuda.synchronize()
    err = 0.0
    for name, gv, wv in zip(("d_dvals", "d_feats"), got, want):
        e, scale = float((gv - wv).abs().max()), float(wv.abs().max())
        tol = SPLAT_TOL * max(1.0, scale)
        log(f"K4b {name}{tuple(gv.shape)}: max|kernel-plain| {e:.3e}, "
            f"max|plain| {scale:.3e} (tol {tol:.3e}: fp32 sums of {c} "
            f"products / {k} rows in another order)")
        if not e <= tol:
            raise AssertionError(f"K4b {name} disagrees with its plain "
                                 f"version: {e}")
        err = max(err, e)
    valid = (ids >= 0) & (ids < num_cells)
    touched = int(torch.unique(ids[valid]).numel())
    # the library's yardstick: autograd of one index_add on materialised rows
    flat = torch.where(valid, ids, torch.full_like(ids, num_cells)
                       ).reshape(-1).long()
    rows_req = (dvals[..., None] * feats[:, None, :]).reshape(
        -1, c).requires_grad_()
    lib_out = torch.index_add(
        torch.zeros(num_cells + 1, c, device=dvals.device), 0, flat, rows_req)
    g_pad = torch.cat([gout, torch.zeros(1, c, device=gout.device)])
    bound_ms, bound_by = bound(
        kernel_ops("splat_topk_bwd", dvals, feats),
        2 * nbytes(dvals, feats) + nbytes(ids) + touched * c * 4)

    def library():
        return torch.autograd.grad(lib_out, rows_req, g_pad, retain_graph=True)

    row = dict(
        name="splat_topk_bwd", route="cuda",
        source="gencomm_tpu_torch/csrc/splat_topk_bwd.cu",
        replaces="gencomm_tpu/ops/splat_pallas.py:188",
        max_abs_err=err,
        ms=time_ms(lambda: splat_topk_bwd(dvals, feats, ids, gout, num_cells)),
        **device_time(lambda: splat_topk_bwd(dvals, feats, ids, gout,
                                             num_cells)),
        plain_ms=time_ms(lambda: splat_topk_bwd_plain(dvals, feats, ids, gout,
                                                      num_cells)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library),
        library_device_ms=device_time(library)["device_ms"])
    log(f"  the cotangent rows of {touched} touched cells are read")
    log_rows([row])
    return row


def sigmoid_closeness(cls, ref):
    """The protocol of scripts/bf16_parity.py on one frame's class logits:
    (max |sigmoid difference|, relative L2 of the sigmoids, top-100 and
    top-50 overlap of the scoring cells, as fractions)."""
    import torch

    p = torch.sigmoid(cls.float().cpu()).reshape(-1)
    q = torch.sigmoid(ref.float().cpu()).reshape(-1)

    def overlap(k):
        a = set(torch.topk(p, k).indices.tolist())
        return len(a & set(torch.topk(q, k).indices.tolist())) / k

    return (float((p - q).abs().max()), float((p - q).norm() / q.norm()),
            overlap(100), overlap(50))


def setup_eval(dev, model_kw, feature_shape, scenes, host, half=False,
               state=None, build=None, postprocess=None, samples=1):
    """One eval cell: the model (``build``, default ``HeterModel``; bf16
    activations with ``half``) with seeded random weights (``state``, to
    give a bf16 cell its fp32 cell's), the frame on the card, the pipeline
    (``postprocess``, default the bench's on the model's range), the
    diffusion noise (fp32, from one seed for every cell) and the samples a
    frame decodes into (``samples``: each agent its own for the legacy
    ``second`` core)."""
    import torch
    from types import SimpleNamespace
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
    from gencomm_tpu_torch.weights import random_state_dict

    build = build or HeterModel
    kw = dict(model_kw, half=half) if build is HeterModel else dict(model_kw)
    model = build(**kw, device=dev)
    state = state if state is not None else random_state_dict(model, seed=0)
    model.load_state_dict(state)
    gen = torch.Generator().manual_seed(1)
    n = host["agent_mask"].size
    noises = [torch.randn((n,) + feature_shape, generator=gen)
              for _ in range(3)]
    return SimpleNamespace(
        model_kw=kw, half=half, model=model, build=build, state=state,
        host=host, batch=batch_to_device(host, dev), n=n, noises=noises,
        samples=samples,
        noises_dev=[t.to(dev) for t in noises],
        pipe=InferencePipeline(model, scenes.anchors, postprocess or
                               postprocess_cfg(model_kw["lidar_range"]),
                               device=dev))


def time_eval(smi, cell, label, expected, frames=None):
    """An eval path counted and timed, looped and streamed, before the
    process's first profiler session (ROADMAP p1). Looped: every launch
    count to 0, then 1 warm-up + TIMED_FRAMES frames through
    InferencePipeline.run (seeds 1..N, CUDA events), the counts read just
    after. Streamed: the counts to 0 again, InferencePipeline.run_stream
    over the same frames and seeds twice (the first call captures the frame
    in a CUDA graph and replays it, the second is timed), the counts read
    just after; a replay launches the captured kernels without counting
    them, so the streamed path's launches are the graph's captured
    launches x its replays. Every streamed frame must equal its looped
    frame bit for bit. ``frames`` (default TIMED_FRAMES) sets N."""
    import torch
    from gencomm_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    n_frames = frames or TIMED_FRAMES
    reset_launch_counts()
    cell.pipe.run(cell.batch, seed=0)  # warm-up
    torch.cuda.synchronize()
    seeds = list(range(1, n_frames + 1))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    looped = [cell.pipe.run(cell.batch, seed=s) for s in seeds]
    end.record()
    end.synchronize()
    cell.launches, cell.routes = dict(_cuda.LAUNCHES), route_counts()
    cell.ms = start.elapsed_time(end) / n_frames
    dets = looped[-1]
    dtype = "bf16" if cell.half else "fp32"
    log(f"{label} eval path ({dtype}), looped: {1 + n_frames} frames, "
        f"{cell.ms:.3f} ms/frame, {1000.0 / cell.ms:.2f} frames/s (batch 1, "
        f"{cell.n} agents) on {smi}; {int(dets.valid.sum())} detections "
        f"kept in the last frame; launches {cell.launches}")
    shape = tuple(dets.corners3d.shape)
    if (shape[0], shape[2:]) != (cell.samples, (8, 3)) or not (
            0 < shape[1] <= cell.pipe.topk):
        raise AssertionError(f"detections shape {tuple(dets.corners3d.shape)}")
    if not (torch.isfinite(dets.corners3d[dets.valid]).all()
            and torch.isfinite(dets.scores).all()):
        raise AssertionError("non-finite detections")
    for name in expected:
        if cell.launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label} {dtype} eval path")

    cell.frames = {k: v.expand((n_frames,) + tuple(v.shape))
                   for k, v in cell.batch.items()}
    reset_launch_counts()
    t0 = time.perf_counter()
    cell.pipe.run_stream(cell.frames, seeds)  # captures, then replays
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    start.record()
    streamed = cell.pipe.run_stream(cell.frames, seeds)
    end.record()
    end.synchronize()
    cell.stream_ms = start.elapsed_time(end) / n_frames
    (graph,) = cell.pipe.graphs.values()
    eager = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    cell.stream_launches = {k: v * graph.replays
                            for k, v in graph.launches.items()}
    differ = [f for f in range(n_frames) if not all(
        torch.equal(v[f], getattr(looped[f], name))
        for name, v in streamed._asdict().items())]
    log(f"{label} eval path ({dtype}), streamed: {n_frames} frames, "
        f"{cell.stream_ms:.3f} ms/frame, {1000.0 / cell.stream_ms:.2f} "
        f"frames/s ({cell.ms / cell.stream_ms:.2f}x the looped rate); the "
        f"first call (warm-up, capture, {n_frames} replays) "
        f"{capture_s:.2f} s; the graph holds {graph.launches} and was "
        f"replayed {graph.replays} times: kernel launches {cell.stream_launches}"
        f" (eager, warm-up and capture: {eager}); frames not bit-equal to "
        f"the looped run: {differ}")
    if differ:
        raise AssertionError(f"streamed frames {differ} differ from looped")
    for name in expected:
        if cell.stream_launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} is not in the {label} "
                                 f"{dtype} graph")
    phase_done(f"{label} eval ({dtype}), timed", t_phase)


def check_eval(smi, cell, label, targets, check, fp32_cell=None,
               top100_min=TOP100_MIN, operators=False):
    """An eval path's checks, after every path is timed: the kernels named
    by ``targets`` on the arguments the path gives them (``check``), the
    device profile, and the same frame, weights and noise on the CPU (fp32:
    each head within CPU_TOL x max(1, max|cpu|) and its relative L2 error
    within CPU_TOL, which also holds the values that the largest dwarf, as
    the pyramid's at random weights). A bf16
    cell (``fp32_cell`` given) is also held against the card's fp32 run of
    its frame and against the CPU's bf16 run: each keeps at least
    ``top100_min`` of the other's top-100 cells, and the relative L2 against
    the CPU's run is within HALF_SPREAD x the CPU's own against the card's
    fp32 run. ``operators``: the looped frame's profile also traces the
    host's operators (``profile_device``). Returns the kernels' rows."""
    import torch
    from gencomm_tpu_torch.pipeline import batch_to_device

    t_phase = time.perf_counter()
    dtype = "bf16" if cell.half else "fp32"

    def forward():
        with torch.inference_mode():
            cell.model(cell.batch, noises=cell.noises_dev)

    rows = check(record_calls(targets, forward))
    fill_launches(rows, cell.launches, cell.routes, f"{label} eval {dtype}")
    cell.busy = profile_device(
        lambda i: cell.pipe.run(cell.batch, seed=100 + i), cell.ms,
        PROFILE_CALLS, "frame", operators=operators)[0]
    # the captured frame's replays, one frame a call, against the streamed
    # frame time; then the graph and its memory pool go. The frame is
    # captured anew first, outside the profiler: replaying SECOND bf16's
    # graph from the timed phase, minutes and many profiler sessions later,
    # crashed in cudaGraphLaunch under the profiler (ROADMAP p9)
    first = {k: v[:1] for k, v in cell.frames.items()}
    cell.pipe.graphs.clear()
    cell.pipe.run_stream(first, [99])
    profile_device(lambda i: cell.pipe.run_stream(first, [100 + i]),
                   cell.stream_ms, PROFILE_CALLS, "streamed frame")
    cell.pipe.graphs.clear()

    with torch.inference_mode():
        out_dev = cell.model(cell.batch, noises=cell.noises_dev)
    cell.cls = out_dev["cls_preds"]
    # the legacy SECOND and PIXOR models have no direction head
    heads = [k for k in ("cls_preds", "reg_preds", "dir_preds")
             if k in out_dev]
    for key in heads:
        if out_dev[key].dtype != torch.float32:
            raise AssertionError(f"{key} is {out_dev[key].dtype}, not fp32")
        if not torch.isfinite(out_dev[key]).all():
            raise AssertionError(f"{key} on the card is not finite")
    want_pred = torch.bfloat16 if cell.half else torch.float32
    if (getattr(cell.model, "use_gencomm", False)
            and out_dev["pred_feature"].dtype != want_pred):
        raise AssertionError(f"pred_feature is {out_dev['pred_feature'].dtype}")

    # the same frame, weights and noise through the port on the CPU
    with torch.inference_mode():
        cpu_model = cell.build(**cell.model_kw, device="cpu")
        cpu_model.load_state_dict(cell.state)
        t0 = time.perf_counter()
        out_cpu = cpu_model(batch_to_device(cell.host, "cpu"),
                            noises=cell.noises)
        cpu_s = time.perf_counter() - t0
    if cell.half:
        # the bf16 run on the card against the fp32 one (same weights, noise
        # and frame), on the protocol of scripts/bf16_parity.py
        bar = f"must be >= {top100_min}"
        mx, rel, top100, _ = sigmoid_closeness(cell.cls, fp32_cell.cls)
        log(f"{label} card bf16 vs card fp32, sigmoid(cls): max abs "
            f"{mx:.4f}, rel L2 {rel:.4f}, top-100 overlap {top100:.2f} "
            f"({bar})")
        if not top100 >= top100_min:
            raise AssertionError(f"bf16 keeps {top100} of the fp32 top-100")
        # the port's own bf16 run on the CPU against the card's fp32 one,
        # which sets the limit of the card's bf16 run against the CPU's
        _, rel_p, top100_p, _ = sigmoid_closeness(out_cpu["cls_preds"],
                                                  fp32_cell.cls)
        log(f"{label} CPU bf16 vs card fp32, sigmoid(cls): rel L2 "
            f"{rel_p:.4f}, top-100 overlap {top100_p:.2f} (logged)")
        mx_c, rel_c, top100_c, _ = sigmoid_closeness(cell.cls,
                                                     out_cpu["cls_preds"])
        tol = HALF_SPREAD * rel_p
        log(f"{label} card bf16 vs CPU bf16, sigmoid(cls): max abs "
            f"{mx_c:.4f}, rel L2 {rel_c:.4f} (tol {tol:.4f}: "
            f"{HALF_SPREAD:.3f} x the CPU's bf16-vs-card-fp32 {rel_p:.4f}), "
            f"top-100 overlap {top100_c:.2f} ({bar})")
        if not (rel_c <= tol and top100_c >= top100_min):
            raise AssertionError(f"card and CPU bf16 runs disagree "
                                 f"({rel_c} > {tol} or {top100_c})")
    else:
        for key in heads:
            a, b = out_dev[key].float().cpu(), out_cpu[key]
            err = float((a - b).abs().max())
            scale = max(1.0, float(b.abs().max()))
            rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
            log(f"card vs CPU {key} {tuple(a.shape)}: max abs diff {err:.3e}, "
                f"max |cpu| {scale:.3e}, median |cpu| "
                f"{float(b.abs().median()):.3e}, tol {CPU_TOL:.0e} x max(1, "
                f"max|cpu|); relative L2 {rel:.3e} (tol {CPU_TOL:.0e})")
            if not err <= CPU_TOL * scale:
                raise AssertionError(f"{key}: card and CPU disagree ({err})")
            if not rel <= CPU_TOL:
                raise AssertionError(f"{key}: card and CPU disagree (relative "
                                     f"L2 {rel})")
    log(f"CPU forward ({dtype}) took {cpu_s:.1f} s")
    phase_done(f"{label} eval ({dtype}), checks", t_phase)
    return rows


def scale_jitter(x, noise):
    """hold_step's default input jitter: x * (1 + noise)."""
    return x * (1.0 + noise)


def time_train(smi, dev, label, model_kw, hypes, feature_shape, hosts,
               expected, jitter_key, build=None, supervise_single=False,
               frozen=None):
    """A training path counted and timed before the process's first
    profiler session (ROADMAP p1): every launch count to 0, 1 warm-up +
    len(hosts) - 1 steps (CUDA events), the counts read just after. The
    model is ``build``'s (default ``HeterModel``); ``supervise_single``
    goes to the train step, and ``frozen`` (a freeze schedule's predicate)
    to the optimizer and the step. Returns the cell for ``check_train`` and
    ``hold_step``, which jitters the input ``jitter_key``."""
    import torch
    from types import SimpleNamespace
    from gencomm_tpu_torch.loss import create_loss
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.ops import _cuda
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.train.trainer import make_optimizer, make_train_step
    from gencomm_tpu_torch.weights import random_state_dict

    t_phase = time.perf_counter()
    build = build or HeterModel
    cell = SimpleNamespace(label=label, dev=dev, hosts=hosts,
                           jitter_key=jitter_key,
                           batches=[batch_to_device(h, dev) for h in hosts],
                           criterion=create_loss(hypes))

    def fresh(device):
        model = build(**model_kw, device=device)
        model.load_state_dict(cell.state)
        model.train()
        opt, sched = make_optimizer(hypes, model.named_parameters(), 1,
                                    frozen)
        return model, make_train_step(model, cell.criterion, opt, sched,
                                      supervise_single=supervise_single,
                                      frozen_predicate=frozen)

    cell.fresh = fresh
    cell.state = random_state_dict(build(**model_kw, device=dev), seed=0)
    cell.n_slots = hosts[0]["agent_mask"].size
    gen = torch.Generator().manual_seed(2)
    cell.noises = [torch.randn((cell.n_slots,) + feature_shape, generator=gen)
                   for _ in range(3)]
    cell.noises_dev = [t.to(dev) for t in cell.noises]
    cell.model, cell.step = fresh(dev)

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    cell.dgen = torch.Generator(device=dev).manual_seed(3)
    step_losses = [cell.step(cell.batches[0], generator=cell.dgen)]  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    steps = len(hosts) - 1
    for i in range(1, 1 + steps):
        step_losses.append(cell.step(cell.batches[i], generator=cell.dgen))
    end.record()
    end.synchronize()
    cell.launches, cell.routes = dict(_cuda.LAUNCHES), route_counts()
    cell.ms = start.elapsed_time(end) / steps
    for i, losses in enumerate(step_losses):
        vals = {k: float(v) for k, v in losses.items()}
        log(f"  step {i}{' (warm-up)' if i == 0 else ''}: "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(vals.items())))
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step {i}: non-finite loss {vals}")
        if set(vals) != set(step_losses[0]):
            raise AssertionError(f"step {i}: loss terms {sorted(vals)}")
    log(f"{label} train path: {1 + steps} steps, {cell.ms:.3f} ms/step, "
        f"{1000.0 / cell.ms:.3f} steps/s, {TRAIN_BATCH * 1000.0 / cell.ms:.2f} "
        f"training frames/s (fp32, TF32 off, batch {TRAIN_BATCH} x "
        f"{cell.n_slots // TRAIN_BATCH} agents) on {smi}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"launches {cell.launches}")
    for name in expected:
        if cell.launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label} training path")
    phase_done(f"{label} training, timed", t_phase)
    return cell


def check_train(cell, targets, check, exact_zero=(), jitter=scale_jitter,
                explain_offsets=False, step_cell=None, same_choices=False,
                operators=False, same_rows=False, no_grad=()):
    """A training path's checks, after every path is timed: the kernels
    named by ``targets`` on the arguments the train step gives them
    (``check``), the step's profile (its busy ms in ``cell.busy``), the
    loss falling on one batch, and one step on the card against the CPU
    (``hold_step`` on ``step_cell``, default ``cell``, with
    ``exact_zero``, ``jitter``, ``explain_offsets``, ``same_rows`` and
    ``no_grad``; with ``same_choices`` both steps take the CPU step's
    discrete choices and ReLU gates; ``operators``: the profile also traces
    the host's operators). Returns the kernels' rows."""
    t_phase = time.perf_counter()
    model, batches, noises_dev = cell.model, cell.batches, cell.noises_dev

    # the kernels on the train step's arguments: one forward and backward,
    # no update
    def forward_backward():
        cell.criterion(model(batches[0], noises=noises_dev),
                       batches[0])["total_loss"].backward()

    inputs = record_calls(targets, forward_backward)
    model.zero_grad(set_to_none=True)
    rows = check(inputs)
    fill_launches(rows, cell.launches, cell.routes, f"{cell.label} training")
    cell.busy = profile_device(
        lambda i: cell.step(batches[i], generator=cell.dgen), cell.ms,
        PROFILE_CALLS, "step", operators=operators)[0]

    # the loss falls over 4 steps on one repeated batch
    model, step = cell.fresh(cell.dev)
    totals = [float(step(batches[0], noises=noises_dev)["total_loss"])
              for _ in range(4)]
    log(f"4 steps on one batch: total_loss {totals}")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"the loss did not fall: {totals}")
    hold_step(step_cell or cell, exact_zero, jitter, explain_offsets,
              same_choices=same_choices, same_gates=same_choices,
              same_rows=same_rows, no_grad=no_grad)
    phase_done(f"{cell.label} training, checks", t_phase)
    return rows


class cpu_choices:
    """Within it, the discrete choices of a step are recorded into
    ``store`` call by call, with the values each was made from
    (``replay=False``), or taken from it in the same order
    (``replay=True``): the LSS encoders' top-K depth picks
    (``LSSEncoder.topk_picks``, from the depth probabilities), the
    codebook's straight-through codes (``codebook.hard_index``, from the
    soft sample) and the row that holds each segment's max in each channel
    (``ops/voxel.py:segment_max``: the pillar canvas of the raw-point path,
    VoxelNet's voxel maxima). In replay, ``flips`` counts call by call the
    pixels (or vectors, or segment channels) whose own choice differs from
    the one taken, and ``loose`` those of them that are not a near-tie: at
    each place where the two choices part, the side's own values at its
    choice and at the taken one must lie within twice the largest gap
    between the side's values and the recorded ones (an order statistic
    moves no further than the values do), so a flip is one that the
    values' own deviation explains. A segment's max replayed is the value
    of the taken row, its gradient shared by the rows that tie with it
    (as ``segment_max`` shares it). ``hold`` fails the run when a call of
    the picks or codes flips more than CHOICE_FLIPS, one of the segment
    max flips more than SEGMENT_FLIPS of its segment channels, or any flip
    is loose. With ``rows`` the host decoration's path takes the CPU step's
    bf16 rows into K2 (``point_pillar.pillar_canvas``), so that K2's maxima
    are the CPU step's: each entry whose own rounding differs must lie one
    bf16 step from the taken one, or within 2^-8 of the call's largest row
    value (a step floored there, as K1 bf16's checks floor it: a value near
    zero that the norm's cancellation leaves with few bits moves by more
    steps), else it is loose; at most ROW_FLIPS of a call's entries may
    differ."""

    def __init__(self, store, replay=False, gates=False, rows=False):
        self.store, self.replay = store, replay
        self.gates, self.rows = gates, rows
        self.flips, self.loose, self.worst = [], 0, 0.0
        self.max_flips, self.max_share = [], 0.0
        self.gate_flips, self.gate_share = [], 0.0
        self.row_flips, self.row_share = [], 0.0

    def _next(self, device):
        return (t.to(device) for t in self.store[
            len(self.flips) + len(self.max_flips) + len(self.gate_flips)
            + len(self.row_flips)])

    def take(self, own, values):
        values = values.detach()
        if not self.replay:
            self.store.append((own.cpu(), values.cpu()))
            return own
        chosen, ref = self._next(own.device)
        differ = (chosen != own).any(-1)
        self.flips.append(int(differ.sum()))
        if self.flips[-1]:
            gap = (values.gather(-1, own)
                   - values.gather(-1, chosen)).abs().amax(-1)[differ]
            moved = (values - ref).abs().amax(-1)[differ]
            self.loose += int((gap > 2 * (1 + 1e-6) * moved).sum())
            self.worst = max(self.worst, float(gap.max()))
        return chosen

    def take_max(self, segment_max, feats, seg, valid, num_segments):
        import torch

        x = feats.detach()
        c = x.shape[-1]
        idx = torch.where(valid, seg, torch.full_like(seg, num_segments))
        idx = idx[:, None].expand(-1, c)

        def seg_max(v):
            return v.new_full((num_segments + 1, c), float("-inf")
                              ).scatter_reduce(0, idx, v, "amax",
                                               include_self=True)

        own = seg_max(x)
        if not self.replay:
            # the first row at each segment channel's max
            rows = torch.arange(x.shape[0], device=x.device)[:, None]
            at = (x == own.gather(0, idx)) & valid[:, None]
            first = torch.full_like(own, x.shape[0], dtype=torch.long
                                    ).scatter_reduce(
                0, idx, torch.where(at, rows, x.shape[0]).expand(-1, c),
                "amin", include_self=True)
            self.store.append((((rows == first.gather(0, idx)) & at).cpu(),
                               x.cpu()))
            return segment_max(feats, seg, valid, num_segments)
        chosen, ref = self._next(x.device)
        neg = torch.full_like(x, float("-inf"))
        taken = seg_max(torch.where(chosen, x, neg))
        held = torch.isfinite(own[:num_segments])
        if not torch.equal(held, torch.isfinite(taken[:num_segments])):
            raise AssertionError("segment max: the recorded rows do not "
                                 "cover this step's segments")
        differ = (own > taken)[:num_segments] & held
        self.max_flips.append(int(differ.sum()))
        self.max_share = max(self.max_share, self.max_flips[-1]
                             / max(int(held.sum()), 1))
        if self.max_flips[-1]:
            gap = (own - taken)[:num_segments][differ]
            moved = seg_max(torch.where(valid[:, None], (x - ref).abs(),
                                        neg))[:num_segments][differ]
            self.loose += int((gap > 2 * (1 + 1e-6) * moved).sum())
            self.worst = max(self.worst, float(gap.max()))
        # the taken row's value; the rows that tie with it share its
        # gradient
        tie = (x == taken.gather(0, idx)) & valid[:, None]
        out = feats.new_full((num_segments + 1, c), float("-inf")
                             ).scatter_reduce(
            0, idx, torch.where(tie, feats, neg), "amax",
            include_self=True)[:num_segments]
        return torch.where(torch.isneginf(out), torch.zeros_like(out), out)

    def take_gate(self, relu, x):
        import torch

        own = x.detach() > 0
        if not self.replay:
            self.store.append((own.cpu(), x.detach().cpu()))
            return relu(x)
        chosen, ref = self._next(x.device)
        differ = chosen != own
        self.gate_flips.append(int(differ.sum()))
        self.gate_share = max(self.gate_share,
                              self.gate_flips[-1] / max(x.numel(), 1))
        if self.gate_flips[-1]:
            gap = x.detach()[differ].abs()
            moved = float((x.detach() - ref).abs().max())
            self.loose += int((gap > 2 * (1 + 1e-6) * moved).sum())
            self.worst = max(self.worst, float(gap.max()))
        return torch.where(chosen, x, torch.zeros_like(x))

    def take_rows(self, canvas, rows, gids, n_agents, ncell):
        import torch

        if not self.replay:
            own = rows.detach().cpu()
            self.store.append((own, own))
            return canvas(rows, gids, n_agents, ncell)
        chosen, _ = self._next(rows.device)
        own = rows.detach()
        differ = own != chosen
        self.row_flips.append(int(differ.sum()))
        self.row_share = max(self.row_share,
                             self.row_flips[-1] / max(own.numel(), 1))
        if self.row_flips[-1]:
            # bf16 steps between the two roundings (same sign: the bit
            # patterns' distance)
            steps = (own.view(torch.int16).int()
                     - chosen.view(torch.int16).int()).abs()[differ]
            gap = (own.float() - chosen.float()).abs()[differ]
            floor = 2.0 ** -8 * float(chosen.float().abs().max())
            self.loose += int(((steps > 1) & (gap > floor)).sum())
            self.worst = max(self.worst, float(gap.max()))
        # the taken values (exact: two bf16 numbers differ by an fp32 one),
        # the gradient of the own rows
        return canvas((rows.float() + (chosen.float() - own.float())).to(
            rows.dtype), gids, n_agents, ncell)

    def hold(self, label):
        log(f"{label} on the CPU step's discrete choices: "
            f"{len(self.flips)} calls of the picks and codes taken, pixels "
            f"or vectors whose own choice differs {self.flips} (at most "
            f"{CHOICE_FLIPS} a call); {len(self.max_flips)} segment maxima "
            f"taken, segment channels whose own max row differs "
            f"{self.max_flips} (at most {SEGMENT_FLIPS:.0e} of a call's, "
            f"the most {self.max_share:.2e}); {len(self.gate_flips)} ReLU "
            f"gates taken, {sum(self.gate_flips)} entries open on one side "
            f"only (at most {GATE_FLIPS:.0e} of a call's, the most "
            f"{self.gate_share:.2e}); {len(self.row_flips)} calls of K2's "
            f"bf16 rows taken, entries rounded otherwise {self.row_flips} "
            f"(at most {ROW_FLIPS:.0e} of a call's, the most "
            f"{self.row_share:.2e}); {self.loose} of them not a near-tie, "
            f"the widest own-value gap {self.worst:.3e}")
        if (max(self.flips, default=0) > CHOICE_FLIPS
                or self.max_share > SEGMENT_FLIPS
                or self.gate_share > GATE_FLIPS
                or self.row_share > ROW_FLIPS or self.loose):
            raise AssertionError(
                f"{label}: discrete choices differ from the CPU step's "
                f"beyond near-ties: {self.flips}, {self.max_flips}, "
                f"{self.gate_flips}, {self.row_flips}, {self.loose} not "
                "near-ties")

    def __enter__(self):
        import torch
        from gencomm_tpu_torch.models import codebook
        from gencomm_tpu_torch.models.encoders import lss, point_pillar
        from gencomm_tpu_torch.ops import voxel

        self.real = (lss.LSSEncoder.topk_picks, codebook.hard_index,
                     voxel.segment_max, torch.relu,
                     point_pillar.pillar_canvas)
        picks, index, segment_max, relu, canvas = self.real
        lss.LSSEncoder.topk_picks = (
            lambda enc, depth: self.take(picks(enc, depth), depth))
        codebook.hard_index = (
            lambda soft: self.take(index(soft)[..., None], soft)[..., 0])
        voxel.segment_max = functools.partial(self.take_max, segment_max)
        if self.gates:
            torch.relu = functools.partial(self.take_gate, relu)
        if self.rows:
            point_pillar.pillar_canvas = functools.partial(self.take_rows,
                                                           canvas)
        return self

    def __exit__(self, *exc):
        import torch
        from gencomm_tpu_torch.models import codebook
        from gencomm_tpu_torch.models.encoders import lss, point_pillar
        from gencomm_tpu_torch.ops import voxel

        (lss.LSSEncoder.topk_picks, codebook.hard_index, voxel.segment_max,
         torch.relu, point_pillar.pillar_canvas) = self.real
        return False


def hold_step(cell, exact_zero=(), jitter=scale_jitter,
              explain_offsets=False, same_choices=False, same_gates=False,
              same_rows=False, no_grad=()):
    """One step on the card and on the port's CPU from ``cell.fresh``, on
    the path's first batch: the losses within LOSS_TOL, the gradients
    within GRAD_FACTOR x the CPU's own spread, the CPU step once more with
    its input (``jitter_key``, a key or a tuple of keys, each jittered)
    jittered by ``jitter(x, noise)``, noise JITTER (relative) normal draws,
    which measures how far the gradients move with the last bits of the
    inputs; where the cell names a ``jitter_module`` (a submodule's dotted
    name), that module's first input is jittered too (``scale_jitter``), for
    an input whose jitter does not survive a rounding before it. Each
    parameter's gap against its own spread is logged, the worst first.
    Only the trainable parameters are held (a freeze schedule's have no
    gradient); those named by a prefix in ``no_grad`` are reached by no
    loss term and must have no gradient on either side, and any other
    trainable parameter without a gradient fails. The numbers held are
    left in ``cell.step_gap``. The parameters named by a suffix in
    ``exact_zero`` (``EXACT_ZERO_GRADS``) are logged, not held: their
    gradients are zero in exact arithmetic and what is left is the noise
    of cancelling terms. With ``explain_offsets``, the step's K1b arguments
    on both sides go to ``offset_gap`` (logged, not held). With
    ``same_choices`` the CPU step runs first, and the card step and the
    jittered CPU step both take its discrete choices (``cpu_choices``: the
    top-K depth picks, the codebook's straight-through codes; the choices
    of either that differ from its own are held to near-ties and to
    CHOICE_FLIPS a call): a choice at a near-tie is one that the card's
    fp32 sums in another order (cuDNN's) can flip, as can a 1e-7 input
    jitter, and a flipped choice moves the gradients by more than rounding
    does, on either side of the comparison. ``same_gates`` takes the CPU
    step's ReLU gates as well, ``same_rows`` its K2 rows (``cpu_choices``)."""
    import contextlib
    import torch
    from gencomm_tpu_torch.ops import deform_conv
    from gencomm_tpu_torch.pipeline import batch_to_device

    k1b = [(deform_conv, "deform_conv3x3_bwd")] if explain_offsets else []
    out = {}

    def run(side, step, batch, noises):
        out[side] = step(batch, noises=noises)

    def choices(replay):
        return (cpu_choices(store, replay, same_gates, same_rows)
                if same_choices else contextlib.nullcontext())

    store = []
    cpu_batch = batch_to_device(cell.hosts[0], "cpu")
    cpu_model, cpu_step = cell.fresh("cpu")
    t0 = time.perf_counter()
    with choices(False):
        cpu_k1b = record_calls(k1b, lambda: run("cpu", cpu_step, cpu_batch,
                                                cell.noises))
    cpu_s = time.perf_counter() - t0
    model, step = cell.fresh(cell.dev)
    with choices(True) as replay:
        card_k1b = record_calls(k1b, lambda: run(
            "card", step, cell.batches[0], cell.noises_dev))
    if same_choices:
        replay.hold("card step")
    card, cpu = out["card"], out["cpu"]
    for k, v in cpu.items():
        a, b = float(card[k]), float(v)
        log(f"card vs CPU {k}: {a:.7f} vs {b:.7f}")
        if not abs(a - b) <= LOSS_TOL * max(abs(b), 1e-6):
            raise AssertionError(f"{k}: card and CPU disagree ({a} vs {b})")
    jit_model, jit_step = cell.fresh("cpu")
    jgen = torch.Generator().manual_seed(4)
    jittered = dict(cpu_batch)
    keys = ((cell.jitter_key,) if isinstance(cell.jitter_key, str)
            else cell.jitter_key)
    for key in keys:
        noise = JITTER * torch.randn(cpu_batch[key].shape, generator=jgen)
        jittered[key] = jitter(cpu_batch[key], noise)

    def jitter_input(module, args):
        noise = JITTER * torch.randn(args[0].shape, generator=jgen)
        return (scale_jitter(args[0], noise),) + args[1:]

    module = getattr(cell, "jitter_module", None)
    hook = (jit_model.get_submodule(module).register_forward_pre_hook(
        jitter_input) if module else None)
    with choices(True) as replay:
        jit_k1b = record_calls(k1b, lambda: jit_step(jittered,
                                                     noises=cell.noises))
    if hook is not None:
        hook.remove()
    if same_choices:
        replay.hold("jittered CPU step")
    log(f"CPU step took {cpu_s:.1f} s")
    # the trainable parameters (a freeze schedule leaves the others without
    # a gradient), less those named in no_grad, which no loss term reaches
    unreached = sorted(n for n, p in cpu_model.named_parameters()
                       if p.requires_grad and n.startswith(tuple(no_grad)))
    if no_grad:
        log(f"parameters no loss term reaches: {unreached}")
        card_grads = dict(model.named_parameters())
        cpu_grads = dict(cpu_model.named_parameters())
        given = [n for n in unreached if card_grads[n].grad is not None
                 or cpu_grads[n].grad is not None]
        if not unreached or given:
            raise AssertionError(f"of {no_grad}, {unreached} were found and "
                                 f"{given} got a gradient")
    names = {n for n, p in cpu_model.named_parameters() if p.requires_grad
             and n not in unreached and not n.endswith(tuple(exact_zero))}
    card_params = dict(model.named_parameters())
    missing = sorted(n for n, p in cpu_model.named_parameters()
                     if p.requires_grad and n not in unreached
                     and (p.grad is None or card_params[n].grad is None))
    if missing:
        raise AssertionError(f"trainable parameters without a gradient: "
                             f"{missing}")
    if exact_zero:
        noise = [n for n, p in cpu_model.named_parameters()
                 if p.requires_grad and n not in names
                 and n not in unreached]
        log_grad_errors("zero in exact arithmetic (logged, not held): CPU "
                        f"vs CPU with a {JITTER:.0e} input jitter",
                        grad_errors(jit_model, cpu_model, set(noise)))
        log_grad_errors("zero in exact arithmetic (logged, not held): card "
                        "vs CPU", grad_errors(model, cpu_model, set(noise)))
    spread = grad_errors(jit_model, cpu_model, names)
    gap = grad_errors(model, cpu_model, names)
    log_grad_errors(f"CPU vs CPU with a {JITTER:.0e} input jitter", spread)
    log_grad_errors("card vs CPU", gap)
    ratios = sorted(((gap[n][0] / max(spread[n][0], 1e-30), n)
                     for n in gap), reverse=True)
    log("card vs CPU, each parameter against its own spread (logged, not "
        "held), worst five: " + ", ".join(
            f"{n} {gap[n][0]:.2e} / {spread[n][0]:.2e} = {r:.1f}"
            for r, n in ratios[:5]))
    worst = max(v[0] for v in gap.values())
    sensitivity = max(v[0] for v in spread.values())
    tol = GRAD_FACTOR * sensitivity + GRAD_FLOOR
    log(f"card vs CPU gradients: worst |card-cpu|/|cpu| (L2) {worst:.3e}, "
        f"tol {GRAD_FACTOR} x {sensitivity:.3e} + {GRAD_FLOOR:.0e}")
    cell.step_gap = dict(worst=worst, sensitivity=sensitivity, tol=tol,
                         worst_ratios=[(n, gap[n][0], spread[n][0])
                                       for _, n in ratios[:5]])
    if explain_offsets:
        for label, args, errs in (("card", card_k1b, gap),
                                  ("jittered CPU", jit_k1b, spread)):
            offset_gap(label, args["deform_conv3x3_bwd"],
                       cpu_k1b["deform_conv3x3_bwd"], errs, cpu_model)
    if not worst <= tol:
        raise AssertionError(f"gradients disagree: {worst} > {tol}")
    return card, cpu


def offset_gap(label, args, cpu_args, errs, cpu_model):
    """Logs where the offset gradients of a step (``label``: the card's, or
    the jittered CPU step's) part from the CPU step's, from K1b's arguments
    in each (x, offsets, weight, cotangent): the sampling taps whose floor
    differs between the two sides' offsets (the offset gradient, a
    difference of corners, jumps there), K1b's offset gradient against its
    plain version on the step's own arguments, and the step's against the
    CPU's, over every tap and over the taps whose floors agree, elementwise
    and summed over the pixels (the offset conv's bias gradient), beside
    the step's gaps ``errs`` (``grad_errors``) of the offset conv's weight
    and bias."""
    from gencomm_tpu_torch.ops.deform_conv import (
        MAX_OFFSET, _geometry, deform_conv3x3_bwd, deform_conv3x3_bwd_plain,
    )

    def rel(a, ref):
        return float((a.double() - ref.double()).norm()
                     / ref.double().norm().clamp_min(1e-30))

    def pixels(d, m):  # summed over the pixels: the bias gradient
        return (d.double() * m).sum((0, 1, 2))

    off, off_cpu = args[1].cpu(), cpu_args[1]
    b, h, w, _ = off_cpu.shape
    y0, x0 = _geometry(off, b, h, w)[:2]
    y0_cpu, x0_cpu = _geometry(off_cpu, b, h, w)[:2]
    flipped = (y0 != y0_cpu) | (x0 != x0_cpu)  # (B, H, W, 9)
    agree = (~flipped)[..., None].expand(b, h, w, 9, 2).reshape(b, h, w, 18)
    # the clamp passes the gradient of an offset inside its bound
    inside = (off.abs() < MAX_OFFSET) & (off_cpu.abs() < MAX_OFFSET)
    both = inside & agree
    got = deform_conv3x3_bwd(*args)[1].cpu()
    plain = deform_conv3x3_bwd_plain(*(t.cpu() for t in args))[1]
    want = deform_conv3x3_bwd_plain(*cpu_args)[1]
    (bias_name, bias), = ((n, p.grad) for n, p in cpu_model.named_parameters()
                          if n.endswith("offset.bias"))
    log(f"offset gradient, {label} vs CPU: {int(flipped.sum())} of "
        f"{flipped.numel()} sampling taps take another floor (offsets: "
        f"relative L2 {rel(off, off_cpu):.2e}, max |d| "
        f"{float((off - off_cpu).abs().max()):.2e}); K1b's offset gradient "
        f"vs its plain version on the same arguments {rel(got, plain):.2e}; "
        f"{label} vs CPU over every tap {rel(got * inside, want * inside):.2e}"
        f", over the taps whose floors agree "
        f"{rel(got * both, want * both):.2e}; summed over the pixels "
        f"{rel(pixels(got, inside), pixels(want, inside)):.2e} and "
        f"{rel(pixels(got, both), pixels(want, both)):.2e} (the CPU's sum vs "
        f"its {bias_name} gradient {rel(pixels(want, inside), bias):.2e}); "
        "the step's gaps: " + ", ".join(
            f"{n} {v[0]:.2e}" for n, v in errs.items()
            if n.endswith(("offset.weight", "offset.bias"))))


def nms_cases(dev):
    """N1's inputs besides the paths': car-sized boxes at random (a few
    overlaps a box, 10% invalid) and a suppression chain K boxes deep (box j
    overlaps box j + 1 only), at each K of NMS_KS; at NMS_DENSE_K a random
    upper-triangular matrix at the density of the largest random case (its
    true entries over its pairs; 10% invalid) and a chain; {label:
    (overlap, valid)}."""
    import torch
    from gencomm_tpu_torch.ops.nms import overlap_matrix
    from gencomm_tpu_torch.utils.box_utils import boxes_to_corners_3d

    gen = torch.Generator().manual_seed(8)
    cases = {}
    for k in NMS_KS:
        side = 2.0 * k ** 0.5

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(k, generator=gen)

        boxes = torch.stack([uniform(-side, side), uniform(-side, side),
                             torch.full((k,), -1.0), torch.full((k,), 1.56),
                             uniform(1.5, 2.0), uniform(3.5, 4.5),
                             uniform(-math.pi, math.pi)], -1)
        quads = boxes_to_corners_3d(boxes, "hwl")[:, :4, :2].to(dev)
        cases[f"random K={k}"] = (overlap_matrix(quads, 0.15),
                                  (torch.rand(k, generator=gen) > 0.1).to(dev))
        cases[f"chain K={k}"] = nms_chain(k, dev)
    over, _ = cases[f"random K={NMS_KS[-1]}"]
    k = NMS_DENSE_K
    density = float(over.sum()) / (over.shape[0] * (over.shape[0] - 1) / 2)
    gen = torch.Generator(device=dev).manual_seed(9)
    cases[f"random K={k}"] = (
        torch.triu(torch.rand(k, k, generator=gen, device=dev) < density, 1),
        torch.rand(k, generator=gen, device=dev) > 0.1)
    cases[f"chain K={k}"] = nms_chain(k, dev)
    return cases


def nms_chain(k, dev):
    """(overlap, valid) of a suppression chain k boxes deep, all valid."""
    import torch

    chain = torch.zeros(k, k, dtype=torch.bool, device=dev)
    idx = torch.arange(k - 1, device=dev)
    chain[idx, idx + 1] = True
    return chain, torch.ones(k, dtype=torch.bool, device=dev)


def nms_bound(keep):
    """(ms, "bytes"): N1's least bytes on these inputs, over the memory
    rate: the upper part of each kept box's row (the rows greedy NMS must
    read), the valid mask read and the keep mask written."""
    import torch

    k = keep.numel()
    kept = torch.nonzero(keep.cpu()).flatten()
    moved = int((k - 1 - kept).sum()) + 2 * k
    return moved / PEAK_BYTES * 1e3, "bytes"


def hold_nms(overlap, valid, label):
    """N1 against its plain version (the host-synced round loop, on the
    card): the keep masks must be equal, and two launches too. Returns
    (mismatches, kept)."""
    import torch
    from gencomm_tpu_torch.ops.nms import nms_closure, nms_closure_plain

    got = nms_closure(overlap, valid)
    again = nms_closure(overlap, valid)
    want = nms_closure_plain(overlap, valid)
    torch.cuda.synchronize()
    differ = int((got != want).sum())
    log(f"N1 nms_closure ({label}): K {valid.numel()}, {int(valid.sum())} "
        f"valid, {int(want.sum())} kept, keep-mask entries that differ from "
        f"the plain version {differ}, two launches bit-equal "
        f"{torch.equal(got, again)}")
    if differ or not torch.equal(got, again):
        raise AssertionError(f"N1 disagrees with its plain version ({label})")
    return differ, got


def check_nms(overlap, valid, where, cases):
    """N1 held against its plain version on the path's own overlap matrix
    (``where``) and on ``cases``, and timed on each: events, the profiler's
    device time, the device time over a CUDA graph (``graph_ms``), the
    plain version's loop on the card (its host reads included; no one
    PyTorch call computes the closure, so no library yardstick) and the
    bound. Returns the row of the path's matrix, with the other cases under
    ``cases``."""
    from gencomm_tpu_torch.ops.nms import (
        nms_closure, nms_closure_plain, storage_route,
    )

    def numbers(over, val, label):
        differ, keep = hold_nms(over, val, label)
        bound_ms, bound_by = nms_bound(keep)
        return dict(
            max_abs_err=differ, kept=int(keep.sum()), k=int(val.numel()),
            storage=storage_route(val.numel()),
            ms=time_ms(lambda: nms_closure(over, val)),
            **device_time(lambda: nms_closure(over, val)),
            graph_ms=graph_ms(lambda: nms_closure(over, val)),
            # once: hold_nms ran it just before (a chain of 8,192 boxes
            # takes ~2 s a call)
            plain_ms=time_ms(lambda: nms_closure_plain(over, val), iters=1,
                             warmup=0),
            bound_ms=bound_ms, bound_by=bound_by)

    row = dict(name="nms_closure", route="cuda",
               source="gencomm_tpu_torch/csrc/nms_closure.cu",
               replaces="gencomm_tpu/ops/nms.py:54",
               library_ms=None, library_device_ms=None,
               **numbers(overlap, valid, where))
    row["cases"] = {label: numbers(o, v, label)
                    for label, (o, v) in cases.items()}
    for label, r in [(where, row)] + list(row["cases"].items()):
        log(f"  N1 {label}: {r['ms']:.4f} ms by events, {r['device_ms']} ms "
            f"on the device, {r['graph_ms']:.4f} ms over a graph (storage "
            f"{r['storage']}), the plain loop {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), {r['kept']} of "
            f"{r['k']} kept")
    return row


def compare_dets(label, card, cpu):
    """Detections of one frame, card against CPU: the same number kept, and
    the kept boxes' scores and corners (in score order) within CPU_TOL x
    max(1, max|cpu|), the eval path's tolerance."""
    import torch

    cv, pv = card.valid.cpu(), cpu.valid
    log(f"{label}: {int(cv.sum())} detections kept on the card, "
        f"{int(pv.sum())} on the CPU")
    if int(cv.sum()) != int(pv.sum()):
        raise AssertionError(f"{label}: card and CPU keep different boxes")
    for name in ("scores", "corners3d"):
        a, b = getattr(card, name).cpu()[cv], getattr(cpu, name)[pv]
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite {name}")
        err = float((a - b).abs().max()) if a.numel() else 0.0
        tol = CPU_TOL * max(1.0, float(b.abs().max()) if b.numel() else 0.0)
        log(f"  {name} of the kept boxes: max |card-cpu| {err:.3e} (tol "
            f"{tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{label}: {name} differ by {err}")


def match_dets(label, card, cpu):
    """Detections of one frame, card against CPU, as sets: the same number
    kept, and each card box matched to a CPU box of its own with the score
    within CPU_TOL and the corners within CPU_TOL x max(1, max|cpu|). Two
    kept boxes whose scores differ by less than the card's and the CPU's
    scores do may come in either order, so the order is not held."""
    import torch

    cv, pv = card.valid.cpu(), cpu.valid.cpu()
    a_s, b_s = card.scores.cpu()[cv], cpu.scores.cpu()[pv]
    a_c = card.corners3d.cpu()[cv].flatten(1)
    b_c = cpu.corners3d.cpu()[pv].flatten(1)
    log(f"{label}: {len(a_s)} detections kept on the card, {len(b_s)} on "
        "the CPU")
    if len(a_s) != len(b_s):
        raise AssertionError(f"{label}: card and CPU keep different boxes")
    if not (torch.isfinite(a_s).all() and torch.isfinite(a_c).all()):
        raise AssertionError(f"{label}: non-finite detections")
    c_tol = CPU_TOL * max(1.0, float(b_c.abs().max()) if b_c.numel()
                          else 0.0)
    free = torch.ones(len(b_s), dtype=torch.bool)
    worst_s = worst_c = 0.0
    swapped = 0
    for i in range(len(a_s)):
        ds = (b_s - a_s[i]).abs()
        dc = (b_c - a_c[i]).abs().amax(1)
        ok = free & (ds <= CPU_TOL) & (dc <= c_tol)
        if not ok.any():
            raise AssertionError(f"{label}: the card's box {i} (score "
                                 f"{float(a_s[i])}) has no CPU match")
        j = int(torch.where(ok, dc, torch.full_like(dc, math.inf)).argmin())
        free[j] = False
        swapped += int(j != i)
        worst_s, worst_c = max(worst_s, float(ds[j])), max(worst_c, float(dc[j]))
    log(f"  kept boxes matched: scores max |card-cpu| {worst_s:.3e} (tol "
        f"{CPU_TOL:.0e}), corners {worst_c:.3e} (tol {c_tol:.3e}); {swapped} "
        "at another rank")


def check_modes(dev, scenes, host):
    """The late and no-fusion modes on the lidar flagship built with
    supervise_single (fp32): each mode's frame on the card with the launch
    counts set to 0 before and read after (N1 once a sample in no mode, L +
    1 times in late mode), its per-agent heads and its detections held
    against the port's CPU run (the single heads do not depend on the
    diffusion noise); N1 held on the late union's overlap matrix (K = L x
    512); then evaluate() in late mode over EVAL_FRAMES untrimmed frames (5
    slots: a union of 2,560) with the boxes on their anchors, card against
    CPU: an AP at IoU 0.3 above 0 and the same APs. Returns the N1 rows'
    extra cases."""
    import torch
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.ops import _cuda, nms
    from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
    from gencomm_tpu_torch.weights import random_state_dict

    t_phase = time.perf_counter()
    kw = dict(FLAGSHIP, supervise_single=True)
    model = HeterModel(**kw, device=dev)
    state = random_state_dict(model, seed=0)
    model.load_state_dict(state)
    cpu_model = HeterModel(**kw, device="cpu")
    cpu_model.load_state_dict(state)
    batch, cpu_batch = batch_to_device(host, dev), batch_to_device(host, "cpu")
    with torch.inference_mode():
        out_dev, out_cpu = model(batch, generator=torch.Generator(
            device=dev).manual_seed(0)), cpu_model(cpu_batch)
    for key in ("cls_preds_single", "reg_preds_single", "dir_preds_single"):
        a, b = out_dev[key].cpu(), out_cpu[key]
        err = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        log(f"card vs CPU {key} {tuple(a.shape)}: max abs diff {err:.3e}, tol "
            f"{CPU_TOL:.0e} x max(1, max|cpu|) = {CPU_TOL * scale:.3e}")
        if not err <= CPU_TOL * scale:
            raise AssertionError(f"{key}: card and CPU disagree ({err})")
    l = host["agent_mask"].shape[1]
    cases = {}
    pipes = {}
    for mode in ("no", "late"):
        pipe = InferencePipeline(model, scenes.anchors,
                                 postprocess_cfg(LIDAR_RANGE), mode=mode,
                                 device=dev)
        cpu_pipe = InferencePipeline(cpu_model, scenes.anchors,
                                     postprocess_cfg(LIDAR_RANGE), mode=mode,
                                     device="cpu")
        reset_launch_counts()
        card = pipe.run(batch, seed=0)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        want_n1 = 1 if mode == "no" else l + 1
        log(f"{mode} mode, lidar flagship with supervise_single: launches "
            f"{launches} (N1 {want_n1} expected)")
        if launches.get("nms_closure") != want_n1:
            raise AssertionError(f"{mode} mode launched N1 "
                                 f"{launches.get('nms_closure')} times")
        for name in ("deform_conv3x3", "pillar_canvas", "warp_affine"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{mode} mode did not launch {name}")
        want_k = NMS_TOPK
        if tuple(card.corners3d.shape) != (1, want_k, 8, 3):
            raise AssertionError(f"{mode}: shape {tuple(card.corners3d.shape)}")
        compare_dets(f"{mode} mode, card vs CPU", card,
                     cpu_pipe.run(host, seed=0))
        pipes[mode] = (pipe, cpu_pipe)
    seen = record_calls([(nms, "nms_closure")],
                        lambda: pipes["late"][0].run(batch, seed=0))
    cases[f"late union K={l * NMS_TOPK}"] = seen["nms_closure"]

    # evaluate: untrimmed frames (5 slots), late mode, with the regression
    # heads zeroed (every box is its anchor, car-sized) and the class biases
    # raised, as tests/test_torch_serving.py::test_evaluate_matches_jax
    # does, so that some boxes match GT at IoU 0.3 and the APs held are not
    # zeros
    ev_state = {k: v.clone() for k, v in state.items()}
    for h in ("heads", "heads_single"):
        ev_state[f"{h}.reg_head.weight"].zero_()
        ev_state[f"{h}.reg_head.bias"].zero_()
        ev_state[f"{h}.cls_head.bias"] += 1.0
    model.load_state_dict(ev_state)
    cpu_model.load_state_dict(ev_state)
    pipe, cpu_pipe = pipes["late"]
    t0 = time.perf_counter()
    seen = record_calls([(nms, "nms_closure")], lambda: pipe.evaluate(
        scenes, n_frames=1, seed0=300))
    card_ap = pipe.evaluate(scenes, n_frames=EVAL_FRAMES, seed0=300)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_ap = cpu_pipe.evaluate(scenes, n_frames=EVAL_FRAMES, seed0=300)
    cpu_s = time.perf_counter() - t0
    log(f"evaluate (late mode, {EVAL_FRAMES} frames of 5 slots; random "
        f"weights, boxes on their anchors: not a quality number): card "
        f"{card_ap} in {card_s:.1f} s, CPU {cpu_ap} in {cpu_s:.1f} s")
    if not card_ap["ap30"] > 0:
        raise AssertionError(f"evaluate: no box matched GT at IoU 0.3 "
                             f"({card_ap}), so the APs held are zeros")
    for key, v in card_ap.items():
        if not abs(v - cpu_ap[key]) <= AP_TOL:
            raise AssertionError(f"evaluate {key}: card {v}, CPU {cpu_ap[key]}")
    over, val = seen["nms_closure"]
    cases[f"evaluate late union K={val.numel()}"] = (over, val)
    phase_done("late and no modes, evaluate", t_phase)
    return cases


def fusion_kwargs(method, num_agents):
    """``flagship_with_fusion`` of configs/opv2v/point_pillar_<method>.yaml."""
    return flagship_with_fusion(load_yaml(os.path.join(
        os.path.dirname(GENCOMM_CONFIGS), f"point_pillar_{method}.yaml")),
        num_agents)


def hold_heads(label, out_dev, out_cpu):
    """cls / reg / dir (those the model has), card against CPU, within
    CPU_TOL x max(1, max|cpu|); returns the worst of max|d| / max(1,
    max|cpu|)."""
    import torch

    worst = 0.0
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        if key not in out_cpu:
            continue
        a, b = out_dev[key].float().cpu(), out_cpu[key]
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {key} on the card is not finite")
        err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        worst = max(worst, err)
        log(f"{label}: card vs CPU {key} {tuple(a.shape)}: max abs diff / "
            f"max(1, max|cpu|) {err:.3e} (tol {CPU_TOL:.0e})")
        if not err <= CPU_TOL:
            raise AssertionError(f"{label} {key}: card and CPU disagree "
                                 f"({err})")
    return worst


def fusion_cell(smi, dev, method, scenes, host, hosts):
    """Phase 12 (b): one fusion on the flagship, the weights random from
    seed 0. Eval: every launch count to 0, 1 warm-up + FUSION_FRAMES frames
    through InferencePipeline.run (CUDA events), K1, K2, K3 and N1 each
    launched; one forward's K3 launches counted (V2VNet: 2 L num_iteration,
    every agent's map and a 1-channel map of ones warped into each agent's
    frame, held against K3's plain version on a non-ego theta at both
    widths, with K3b on the 1-channel map); the same frame, weights and
    noise on the CPU, heads within CPU_TOL (Where2comm's comm_rate logged
    on both). Training: 1 warm-up + FUSION_STEPS steps, K1b, K2b, K3b each
    launched, then one step card against CPU (``hold_step``). Returns the
    fusion's numbers."""
    import torch
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.ops import _cuda, warp
    from gencomm_tpu_torch.pipeline import batch_to_device

    t_phase = time.perf_counter()
    l = host["agent_mask"].shape[1]
    kw = fusion_kwargs(method, l)
    cell = setup_eval(dev, kw, FEATURE_SHAPE, scenes, host)
    reset_launch_counts()
    cell.pipe.run(cell.batch, seed=0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    dets = [cell.pipe.run(cell.batch, seed=s)
            for s in range(1, 1 + FUSION_FRAMES)]
    end.record()
    end.synchronize()
    frame_ms = start.elapsed_time(end) / FUSION_FRAMES
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    log(f"fusion {method}: eval, {1 + FUSION_FRAMES} frames looped, "
        f"{frame_ms:.3f} ms/frame on {smi}; {int(dets[-1].valid.sum())} "
        f"detections kept in the last frame; launches {launches}")
    for name in ("deform_conv3x3", "pillar_canvas", "warp_affine",
                 "nms_closure"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{method}: kernel {name} was not launched")

    def forward():
        with torch.inference_mode():
            return cell.model(cell.batch, noises=cell.noises_dev)

    reset_launch_counts()
    warps = [a for _, a, _ in record_all([(fusion, "warp_affine")],
                                              forward)]
    k3 = _cuda.LAUNCHES["warp_affine"]
    k3_routes = dict(warp.FORWARD_ROUTE_LAUNCHES)
    want_k3 = 1
    want_routes = {"rows": 1, "pixel": 0, "scalar": 0}
    if method == "v2vnet":
        want_k3 = 2 * l * kw["fusion_args"]["v2vnet"].get("num_iteration", 2)
        # the node stack on rows, the map of ones on the pixel route
        want_routes = {"rows": want_k3 // 2, "pixel": want_k3 // 2,
                       "scalar": 0}
    log(f"fusion {method}: K3 launches in one forward {k3} (expected "
        f"{want_k3}), by route {k3_routes} (expected {want_routes}), maps "
        f"{[tuple(w[0].shape) for w in warps]}")
    if k3 != want_k3 or len(warps) != want_k3:
        raise AssertionError(f"{method}: {k3} K3 launches, {want_k3} expected")
    if k3_routes != want_routes:
        raise AssertionError(f"{method}: K3 by route {k3_routes}, "
                             f"{want_routes} expected")
    k3_rows = {}
    if method == "v2vnet":
        # the first iteration's warps into agent 1's frame: the node stack
        # and the map of ones
        for src, theta in warps[2:4]:
            where = f"v2vnet eval, non-ego theta, {src.shape[-1]} channels"
            k3_rows[where] = dict(check_warp({"warp_affine": (src, theta)},
                                             where),
                                  launches=launches["warp_affine"])
        src1, theta1 = warps[3]
        gen = torch.Generator().manual_seed(9)
        hold_warp_bwd(torch.randn(src1.shape, generator=gen).to(dev), theta1,
                      "v2vnet, the 1-channel map, a non-ego theta")
    out_dev = forward()
    with torch.inference_mode():
        cpu_model = HeterModel(**cell.model_kw, device="cpu")
        cpu_model.load_state_dict(cell.state)
        out_cpu = cpu_model(batch_to_device(cell.host, "cpu"),
                            noises=cell.noises)
    err = hold_heads(f"fusion {method}", out_dev, out_cpu)
    rates = None
    if "comm_rate" in out_dev:
        rates = (float(out_dev["comm_rate"]), float(out_cpu["comm_rate"]))
        log(f"fusion {method}: comm_rate card {rates[0]:.6f}, CPU "
            f"{rates[1]:.6f}")
    del cell, cpu_model

    train = time_train(smi, dev, f"fusion {method}", kw, TRAIN_HYPES,
                       FEATURE_SHAPE, hosts[:1 + FUSION_STEPS],
                       ("deform_conv3x3", "pillar_canvas", "warp_affine",
                        "deform_conv3x3_bwd", "pillar_canvas_bwd",
                        "warp_affine_bwd"), "decorated_m1")
    card, cpu = hold_step(train, EXACT_ZERO_GRADS.get(method, ()))
    phase_done(f"fusion {method}", t_phase)
    return {"ms_per_frame": round(frame_ms, 3),
            "ms_per_step": round(train.ms, 3),
            "eval_launches": launches,
            "step_launches": {k: v for k, v in train.launches.items() if v},
            "k3_per_forward": k3, "heads_err": err, "comm_rate": rates,
            "losses_card": {k: float(v) for k, v in card.items()},
            "losses_cpu": {k: float(v) for k, v in cpu.items()}}, k3_rows


def kd_cell(dev, hosts):
    """Phase 12 (b), last: one ``make_kd_train_step`` step of the DiscoNet
    flagship, the teacher a DiscoNet model on the student's weights (frozen,
    eval mode), PointPillarDiscoNetLoss on m1_att.yaml's loss arguments
    (kd weight 1), card against CPU (``hold_step``)."""
    import torch
    from types import SimpleNamespace
    from gencomm_tpu_torch.loss.point_pillar_loss import (
        PointPillarDiscoNetLoss,
    )
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.ops import _cuda
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.train.trainer import (
        make_kd_train_step, make_optimizer,
    )
    from gencomm_tpu_torch.weights import random_state_dict

    t_phase = time.perf_counter()
    kw = fusion_kwargs("disconet", hosts[0]["agent_mask"].shape[1])
    criterion = PointPillarDiscoNetLoss(TRAIN_HYPES["loss"]["args"])
    state = random_state_dict(HeterModel(**kw, device=dev), seed=0)

    def fresh(device):
        student, teacher = (HeterModel(**kw, device=device) for _ in range(2))
        for m in (student, teacher):
            m.load_state_dict(state)
        teacher.requires_grad_(False)
        opt, sched = make_optimizer(TRAIN_HYPES, student.named_parameters())
        return student, make_kd_train_step(student, teacher, criterion, opt,
                                           sched)

    gen = torch.Generator().manual_seed(2)
    noises = [torch.randn((hosts[0]["agent_mask"].size,) + FEATURE_SHAPE,
                          generator=gen) for _ in range(3)]
    cell = SimpleNamespace(fresh=fresh, dev=dev, hosts=hosts,
                           batches=[batch_to_device(hosts[0], dev)],
                           noises=noises,
                           noises_dev=[t.to(dev) for t in noises],
                           jitter_key="decorated_m1")
    reset_launch_counts()
    card, cpu = hold_step(cell, EXACT_ZERO_GRADS["disconet"])
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    log(f"KD step (DiscoNet, teacher on the student's weights): losses card "
        f"{ {k: float(v) for k, v in card.items()} }; launches {launches}")
    if not card["kd_loss"] > 0:
        raise AssertionError(f"the KD term is {float(card['kd_loss'])}")
    phase_done("DiscoNet distillation step", t_phase)
    return {"losses_card": {k: float(v) for k, v in card.items()},
            "losses_cpu": {k: float(v) for k, v in cpu.items()},
            "launches": launches}


def fusion_timed(smi, dev, scenes, host, hosts):
    """Phase 12's timed part, before the process's first profiler session
    (ROADMAP p1): V2X-ViT eval fp32 and bf16 (``time_eval``) and its
    training (``time_train``), then every other fusion and the distillation
    step (``fusion_cell``, ``kd_cell``: no profiler session)."""
    from types import SimpleNamespace

    kernels = ("deform_conv3x3", "pillar_canvas", "warp_affine",
               "nms_closure")
    kernels16 = ("deform_conv3x3_bf16", "pillar_canvas", "warp_affine_bf16",
                 "nms_closure")
    fam = SimpleNamespace(vx=setup_eval(dev, V2XVIT, FEATURE_SHAPE, scenes,
                                        host))
    time_eval(smi, fam.vx, "v2xvit", kernels)
    fam.vx16 = setup_eval(dev, V2XVIT, FEATURE_SHAPE, scenes, host,
                          half=True, state=fam.vx.state)
    time_eval(smi, fam.vx16, "v2xvit", kernels16)
    fam.train = time_train(
        smi, dev, "v2xvit", V2XVIT, V2XVIT_HYPES, FEATURE_SHAPE, hosts,
        ("deform_conv3x3", "pillar_canvas", "warp_affine",
         "deform_conv3x3_bwd", "deform_conv3x3_bwd_dx", "pillar_canvas_bwd",
         "warp_affine_bwd"), "decorated_m1")
    fam.cells, fam.k3_rows = {}, {}
    for method in FUSION_FAMILY:
        fam.cells[method], rows = fusion_cell(smi, dev, method, scenes, host,
                                              hosts)
        fam.k3_rows.update(rows)
    fam.kd = kd_cell(dev, hosts)
    return fam


def fusion_checks(smi, fam, kernel_rows):
    """Phase 12's checks, after every path is timed: V2X-ViT's K3 (eval,
    fp32 and bf16) and K3b (step) on its arguments, its profiles, card
    against CPU (bf16 by phase 5's statistics); their rows, and V2VNet's
    K3 rows, go into ``kernel_rows`` under their path names. Returns the
    phase's numbers for the log."""
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.ops import warp

    t_phase = time.perf_counter()
    add_rows(kernel_rows, "v2xvit eval", check_eval(
        smi, fam.vx, "v2xvit", [(fusion, "warp_affine")],
        lambda inputs: [check_warp(inputs, "v2xvit eval")]))
    add_rows(kernel_rows, "v2xvit eval bf16", check_eval(
        smi, fam.vx16, "v2xvit", [(fusion, "warp_affine")],
        lambda inputs: [check_warp(inputs, "v2xvit eval bf16")],
        fp32_cell=fam.vx, top100_min=V2XVIT_TOP100_MIN))
    add_rows(kernel_rows, "v2xvit train step", check_train(
        fam.train, [(warp, "warp_affine_bwd")],
        lambda inputs: [check_warp_bwd(inputs, "v2xvit train step")],
        exact_zero=EXACT_ZERO_GRADS["v2xvit"]))
    for where, row in fam.k3_rows.items():
        add_rows(kernel_rows, where, [row])
    summary = {
        "v2xvit": {
            "eval_fp32": {"looped_ms": round(fam.vx.ms, 3),
                          "streamed_ms": round(fam.vx.stream_ms, 3),
                          "launches": fam.vx.launches},
            "eval_bf16": {"looped_ms": round(fam.vx16.ms, 3),
                          "streamed_ms": round(fam.vx16.stream_ms, 3),
                          "launches": fam.vx16.launches},
            "train_ms_per_step": round(fam.train.ms, 3)},
        **fam.cells, "kd": fam.kd}
    log(f"fusion family: {json.dumps(summary)}")
    phase_done("fusion family, checks", t_phase)
    return summary


def pyramid_timed(smi, dev):
    """Phase 13 (a) and (b), timed with the other paths before the
    process's first profiler session: stage1/m1_pyramid.yaml's model at
    full width on the train CLI's sampler and host adaptation (2 agents
    trimmed from 5, decorated), eval looped and streamed (``time_eval``)
    and 1 + 10 train steps at batch 2 with its optimizer and
    point_pillar_pyramid_loss, the occupancy pass included
    (``time_train``)."""
    from types import SimpleNamespace
    from gencomm_tpu_torch.models.heter_pyramid import HeterPyramidModel
    from gencomm_tpu_torch.tools import train as train_cli

    t0 = time.perf_counter()
    scenes = train_cli.build_dataset(PYRAMID_HYPES, True, "synthetic")
    adapt = train_cli.Adapt(PYRAMID_HYPES)
    host = adapt(scenes.sample(0, 1))
    hosts = [adapt(scenes.sample(TRAIN_SEED * 10000 + i, TRAIN_BATCH))
             for i in range(1 + TIMED_STEPS)]
    log(f"pyramid frame and {len(hosts)} train batches sampled, labelled "
        f"(per agent too) and decorated on the host in "
        f"{time.perf_counter() - t0:.3f} s; {host['agent_mask'].shape[1]} "
        f"agent slots; labels {host['pos_equal_one'].shape}, per agent "
        f"{hosts[0]['pos_equal_one_single'].shape}")
    pyr = SimpleNamespace(scenes=scenes)
    pyr.eval = setup_eval(dev, PYRAMID, FEATURE_SHAPE, scenes, host,
                          build=HeterPyramidModel,
                          postprocess=PYRAMID_HYPES["postprocess"])
    time_eval(smi, pyr.eval, "pyramid",
              ("pillar_canvas", "warp_affine", "nms_closure"))
    pyr.train = time_train(
        smi, dev, "pyramid", PYRAMID, PYRAMID_HYPES, FEATURE_SHAPE, hosts,
        ("pillar_canvas", "warp_affine", "pillar_canvas_bwd",
         "warp_affine_bwd"), "decorated_m1", build=HeterPyramidModel,
        supervise_single=True)
    return pyr


def pair_warp(feat, score, theta):
    """K3's pair launch on a pyramid level's feature and occupancy score
    (the model's one launch) against the two maps' own launches (rows
    route, pixel route) and against one launch on the C + 1 channels
    concatenated (the JAX package's form, scalar route): the same bits,
    and the three timed by events, by the profiler and over CUDA graphs,
    the one launch with the concatenation it needs."""
    import torch
    from gencomm_tpu_torch.ops.warp import warp_affine, warp_affine_pair

    got, got_s = warp_affine_pair(feat, score, theta)
    two = warp_affine(feat, theta), warp_affine(score, theta)
    cat = warp_affine(torch.cat([feat, score], dim=-1), theta)
    c = feat.shape[-1]
    same = (torch.equal(got, two[0]) and torch.equal(got_s, two[1])
            and torch.equal(cat[..., :c], two[0])
            and torch.equal(cat[..., c:], two[1]))

    def pair():
        return warp_affine_pair(feat, score, theta)

    def two_launches():
        return warp_affine(feat, theta), warp_affine(score, theta)

    def one_launch():
        return warp_affine(torch.cat([feat, score], dim=-1), theta)

    out = {"pair_same_bits": same}
    for key, fn in (("pair", pair), ("two_launch", two_launches),
                    ("one_launch", one_launch)):
        out[f"{key}_ms"] = time_ms(fn, iters=K3_TURN_LAUNCHES)
        out[f"{key}_device_ms"] = device_time(fn)["device_ms"]
        out[f"{key}_graph_ms"] = graph_ms(fn)
    log(f"  K3 at {c} + {score.shape[-1]} channels: one pair launch, two "
        f"launches (feature, score) and one on the concatenation: the same "
        f"bits {same}; events {out['pair_ms']:.4f} / "
        f"{out['two_launch_ms']:.4f} / {out['one_launch_ms']:.4f} ms, device "
        f"{out['pair_device_ms']} / {out['two_launch_device_ms']} / "
        f"{out['one_launch_device_ms']} ms, over graphs "
        f"{out['pair_graph_ms']:.4f} / {out['two_launch_graph_ms']:.4f} / "
        f"{out['one_launch_graph_ms']:.4f} ms")
    if not same:
        raise AssertionError("K3's pair launch, the two launches and the "
                             "concatenated map disagree")
    return out


def pyramid_checks(smi, pyr, kernel_rows):
    """Phase 13's checks, after every path is timed. Eval: K3 on every map
    the path warps (each level's feature, 64 / 128 / 256 channels, and its
    1-channel score, which the model warps in one pair launch a level) held
    and timed with the grid_sample yardstick, and each level's pair launch
    against the two maps' own launches and one on the 65 / 129 / 257
    channels concatenated; K2 and N1 on the path's arguments, the profiles, card
    against CPU (``check_eval``). Training: K3b on every map, twice for the
    same bits (``check_warp_bwd``), the step's profile, the loss falling on
    one batch, one step card against CPU (``check_train``); K2 and K2b on
    the step's arguments."""
    import torch
    from gencomm_tpu_torch.models.encoders import point_pillar
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.ops import _cuda, nms, pillar_canvas, warp

    t_phase = time.perf_counter()
    cell = pyr.eval

    def forward():
        with torch.inference_mode():
            cell.model(cell.batch)

    reset_launch_counts()
    pairs = [a for _, a, _ in record_all(
        [(fusion, "warp_affine_pair")], forward)]
    widths = [c for feat, score, _ in pairs
              for c in (feat.shape[-1], score.shape[-1])]
    k3, routes = _cuda.LAUNCHES["warp_affine"], dict(warp.FORWARD_ROUTE_LAUNCHES)
    log(f"pyramid eval: K3 launches in one forward {k3}, by route {routes}"
        f", maps {[(tuple(f.shape), tuple(s.shape)) for f, s, _ in pairs]}")
    # one pair launch a level, on the feature's rows route
    if widths != PYRAMID_WARP_WIDTHS or k3 != len(PYRAMID_WARP_WIDTHS) // 2 \
            or routes != {"rows": k3, "pixel": 0, "scalar": 0}:
        raise AssertionError(f"pyramid: K3 widths {widths}, "
                             f"{PYRAMID_WARP_WIDTHS} expected in "
                             f"{len(PYRAMID_WARP_WIDTHS) // 2} pair launches "
                             f"on the rows route; launches {k3}, {routes}")
    for level, (feat, score, theta) in enumerate(pairs):
        for src, what in ((feat, "feature"), (score, "score")):
            where = (f"pyramid eval, level {level} {what}, {src.shape[-1]} "
                     "channels")
            row = check_warp({"warp_affine": (src, theta)}, where,
                             graph=True)
            row["launches"] = cell.launches["warp_affine"]
            if what == "score":
                row.update(pair_warp(feat, src, theta))
            add_rows(kernel_rows, where, [row])
    add_rows(kernel_rows, "pyramid eval", check_eval(
        smi, cell, "pyramid", [(point_pillar, "pillar_canvas")],
        lambda inputs: [check_pillar(inputs, "pyramid eval")]))
    seen = record_calls([(nms, "nms_closure")],
                        lambda: cell.pipe.run(cell.batch, seed=0))
    n1 = check_nms(*seen["nms_closure"], "pyramid eval", {})
    n1["launches"] = cell.launches["nms_closure"]
    add_rows(kernel_rows, "pyramid eval", [n1])

    train = pyr.train

    def forward_backward():
        train.criterion(train.model(train.batches[0]),
                        train.batches[0])["total_loss"].backward()

    grads = [a for _, a, _ in record_all([(warp, "warp_affine_bwd")],
                                          forward_backward)]
    train.model.zero_grad(set_to_none=True)
    if sorted(g.shape[-1] for g, _ in grads) != sorted(PYRAMID_WARP_WIDTHS):
        raise AssertionError(f"pyramid step: K3b widths "
                             f"{[g.shape[-1] for g, _ in grads]}")
    # the timed steps took K3b's pixel route on every one-channel score
    routes = train.routes["warp_affine_bwd"]
    steps = train.launches["warp_affine_bwd"] // len(PYRAMID_WARP_WIDTHS)
    narrow = sum(warp.backward_route(c) == "pixel"
                 for c in PYRAMID_WARP_WIDTHS)
    log(f"pyramid step: K3b launches by route {routes} over {steps} steps")
    if steps < 1 or routes["pixel"] != narrow * steps:
        raise AssertionError(f"pyramid step: K3b's pixel route expected "
                             f"{narrow} times a step, launches {routes}")

    def check(inputs):
        for i, (g3, theta) in enumerate(grads):
            where = f"pyramid train step, {g3.shape[-1]} channels ({i})"
            row = check_warp_bwd({"warp_affine_bwd": (g3, theta)}, where,
                                 graph=g3.shape[-1] == 1)
            row["launches"] = train.launches["warp_affine_bwd"]
            row["route_launches"] = train.routes["warp_affine_bwd"]
            add_rows(kernel_rows, where, [row])
        return [check_pillar(inputs, "pyramid train step"),
                check_pillar_bwd(inputs, "pyramid train step")]

    add_rows(kernel_rows, "pyramid train step", check_train(
        train, [(point_pillar, "pillar_canvas"),
                (pillar_canvas, "pillar_canvas_bwd")], check))
    summary = {"eval": {"looped_ms": round(cell.ms, 3),
                        "streamed_ms": round(cell.stream_ms, 3),
                        "launches": cell.launches},
               "train_ms_per_step": round(train.ms, 3),
               "step_launches": {k: v for k, v in train.launches.items() if v},
               "step_k3b_routes": routes}
    log(f"pyramid: {json.dumps(summary)}")
    phase_done("HEAL pyramid, checks", t_phase)
    return summary


def second_timed(smi, dev):
    """Phase 14 (a), timed with the other paths before the process's first
    profiler session: m3_att.yaml's model at full width on the flagship's
    scenes (2 agents trimmed from 5, raw points to the card), eval fp32 and
    bf16 looped and streamed (``time_eval``), and 1 + 10 train steps at
    batch 2 x 2 agents with its optimizer and loss (``time_train``)."""
    import dataclasses
    from types import SimpleNamespace
    import torch
    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.synthetic import SyntheticScenes

    t0 = time.perf_counter()
    scenes = SyntheticScenes(dataclasses.replace(
        scenes_config(), feature_stride=SECOND_STRIDE))
    host = trim_agent_slots(scenes.sample(seed=0, batch_size=1),
                            buckets=(2, 3, 5))
    hosts = [trim_agent_slots(scenes.sample(TRAIN_SEED * 10000 + i,
                                            TRAIN_BATCH), buckets=(2, 3, 5))
             for i in range(1 + TIMED_STEPS)]
    log(f"second frame and {len(hosts)} train batches sampled and labelled "
        f"on the host in {time.perf_counter() - t0:.3f} s (raw points "
        f"{host['points_m1'].shape}, no decoration); anchors "
        f"{scenes.anchors.shape}, labels {hosts[0]['pos_equal_one'].shape}; "
        f"{int(hosts[0]['pos_equal_one'].sum())} positive anchors in the "
        "first batch")
    sec = SimpleNamespace(scenes=scenes)
    sec.eval = setup_eval(dev, SECOND, SECOND_FEATURE_SHAPE, scenes, host)
    if "points_m1" not in sec.eval.batch or "decorated_m1" in sec.eval.batch:
        raise AssertionError("the SECOND frame does not carry raw points")
    time_eval(smi, sec.eval, "second", ("deform_conv3x3", "warp_affine",
                                        "nms_closure"))
    sec.eval16 = setup_eval(dev, SECOND, SECOND_FEATURE_SHAPE, scenes, host,
                            half=True, state=sec.eval.state)
    time_eval(smi, sec.eval16, "second", ("deform_conv3x3_bf16",
                                          "warp_affine_bf16", "nms_closure"))
    # the step's peak above what the process held before (the other
    # paths' cells), its model and optimizer state included
    held = torch.cuda.memory_allocated()
    sec.train = time_train(
        smi, dev, "second", SECOND, SECOND_HYPES, SECOND_FEATURE_SHAPE, hosts,
        ("deform_conv3x3", "warp_affine", "deform_conv3x3_bwd",
         "deform_conv3x3_bwd_dx", "warp_affine_bwd"), "points_m1")
    sec.train_peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    log(f"second train path: peak memory {sec.train_peak_gib:.2f} GiB above "
        f"the {held / 2 ** 30:.2f} GiB the process held before it")
    return sec


def jitter_in_grid(points, noise, lidar_range, voxel_size):
    """Points times (1 + noise), each point whose jitter would take it to
    another cell of the grid (``lidar_range``, ``voxel_size``) left where
    it was."""
    import torch
    from gencomm_tpu_torch.ops.sparse import voxel_index

    moved = points * (1.0 + noise)
    same = torch.ones(points.shape[:-1], dtype=torch.bool)
    for ax in range(3):
        lo, size = lidar_range[ax], voxel_size[ax]
        same &= (voxel_index(moved[..., ax], lo, size)
                 == voxel_index(points[..., ax], lo, size))
    return torch.where(same[..., None], moved, points)


def jitter_within_voxels(points, noise):
    """SECOND's points times (1 + noise), each point whose jitter would take
    it to another voxel left where it was. hold_step's yardstick is the
    gradients' move under rounding-sized changes of the inputs, as the
    decorated fields' jitter is for the pillar paths; a point that changes
    voxel changes the sparse lists themselves, which moved the CPU's own
    gradients of the full-width step by up to 1.12 of their norm."""
    enc = SECOND["modality_args"]["m1"]["encoder_args"]
    return jitter_in_grid(points, noise, enc["lidar_range"], enc["voxel_size"])


def hold_sparse_ops(calls):
    """Each recorded sparse op on the card against the port's CPU on its
    own arguments: integer and boolean outputs equal, features within
    SPARSE_TOL x max(1, max|cpu|); its time on the card (CUDA events); the
    voxels each list holds against its capacity and the sites proposed,
    by agent. The voxel means must give the same bits on a second run.
    Returns {op: summed ms} and the lists' fill."""
    import torch
    from torch.utils._pytree import tree_map
    from gencomm_tpu_torch.ops import sparse

    def to_cpu(a):
        return a.cpu() if torch.is_tensor(a) else a

    ms, fill, n_agents = {}, [], 1
    for i, (name, args, kwargs) in enumerate(calls):
        fn = getattr(sparse, name)
        card = fn(*args, **kwargs)
        cpu = fn(*tree_map(to_cpu, args), **tree_map(to_cpu, kwargs))
        card = card if isinstance(card, tuple) else (card,)
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        worst = 0.0
        for a, b in zip(card, cpu):
            if not torch.is_tensor(b):
                if a != b:
                    raise AssertionError(f"{name} ({i}): {a} != {b}")
                continue
            a = a.cpu()
            if b.is_floating_point():
                err = float((a - b).abs().max()) if b.numel() else 0.0
                scale = max(1.0, float(b.abs().max()) if b.numel() else 0.0)
                worst = max(worst, err / scale)
                if not err <= SPARSE_TOL * scale:
                    raise AssertionError(f"{name} ({i}): card and CPU differ "
                                         f"by {err} (scale {scale})")
            elif not torch.equal(a, b):
                raise AssertionError(f"{name} ({i}): card and CPU integer "
                                     "outputs differ")
        t = time_ms(lambda: fn(*args, **kwargs), iters=10, warmup=2)
        ms[name] = ms.get(name, 0.0) + t
        extra = ""
        if name == "voxelize_mean":
            again = fn(*args, **kwargs)
            same = all(torch.equal(x, y) for x, y in zip(card, again))
            bits_cpu = torch.equal(card[0].cpu(), cpu[0])
            points, mask, _, _, grid, capacity = args
            n_agents = points.shape[0]
            keys = sparse.linear_key(torch.stack([
                torch.arange(points.shape[0], device=points.device,
                             dtype=torch.int32)[:, None].expand(
                                 points.shape[:2])]
                + [sparse.voxel_index(points[..., ax], args[2][ax],
                                      args[3][ax]) for ax in (2, 1, 0)],
                -1), grid, mask.bool())
            distinct = int(torch.unique(keys[keys != sparse.INVALID_KEY])
                           .numel())
            held = int(card[2].sum())
            per_agent = torch.bincount(card[1][card[2]][:, 0].long(),
                                       minlength=points.shape[0]).tolist()
            fill.append({"op": name, "held": held, "capacity": capacity,
                         "distinct": distinct, "per_agent": per_agent})
            extra = (f"; {held} voxels held of {capacity} ({distinct} "
                     f"distinct, by agent {per_agent}); the same bits on a "
                     f"second run {same}, bit-equal to the CPU {bits_cpu}")
            if not same:
                raise AssertionError("the voxel means differ between two "
                                     "runs on the card")
        elif name == "spconv3d_downsample":
            held, capacity = int(card[2].sum()), args[7]
            # every site the strided conv proposes: the list at a capacity
            # of 8 a voxel, which holds them all
            uncapped = fn(*args[:7], 8 * args[0].shape[0])
            distinct = int(uncapped[2].sum())
            per_agent = torch.bincount(card[1][card[2]][:, 0].long(),
                                       minlength=n_agents).tolist()
            fill.append({"op": name, "held": held, "capacity": capacity,
                         "distinct": distinct, "per_agent": per_agent,
                         "grid": list(card[3])})
            extra = (f"; {held} sites held of {capacity} ({distinct} "
                     f"proposed, held by agent {per_agent}), grid {card[3]}")
        log(f"  {name} ({i}): card vs CPU worst {worst:.2e} of max(1, "
            f"max|cpu|) (tol {SPARSE_TOL:.0e}), integers equal; {t:.4f} ms "
            f"on the card{extra}")
    return ms, fill


def hold_repeat_step(train, sparse=False):
    """ROADMAP p6 and p8, on a training cell's step from one state (the same
    weights, batch and diffusion noise). Held: the whole step twice with
    cudnn.deterministic gives every gradient the same bits (K1b sums its
    input gradient in a fixed order). Logged: how many differ
    twice with cuDNN's default algorithms, and the operators that PyTorch
    still calls nondeterministic in one step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, with
    every warning caught in the step as it came, those of two operators
    that PyTorch flags (histc, kthvalue: the capture's control) and those
    of a cuBLAS product. With
    ``sparse`` (SECOND) also held: no ``index_add_`` (an add by atomics)
    among the step's operators under torch.profiler, and the encoder's
    forward and backward twice on the step's points with one fixed
    cotangent gives every encoder gradient the same bits (the sparse
    convs' backward, ``ops/sparse.py:gather_matmul``). Returns the
    numbers."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile

    result = {}
    if sparse:
        model, step = train.fresh(train.dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(train.batches[0], noises=train.noises_dev)
            torch.cuda.synchronize()
        ops = sorted({ev.key for ev in prof.key_averages()})
        atomic = [k for k in ops if "index_add" in k]
        log(f"p6: the step's operators holding index_add: {atomic} (of "
            f"{len(ops)} operators)")
        if atomic:
            raise AssertionError(f"p6: the SECOND step still runs {atomic}")
        points = train.batches[0]["points_m1"]
        mask = train.batches[0]["point_mask_m1"]

        def encoder_grads():
            model, _ = train.fresh(train.dev)
            enc = model.branch_m1.encoder
            out = enc(points, mask)
            cot = torch.randn(out.shape, device=train.dev,
                              generator=torch.Generator(
                                  train.dev).manual_seed(6))
            out.backward(cot)
            torch.cuda.synchronize()
            return {n: p.grad.clone() for n, p in enc.named_parameters()}

        first, second = encoder_grads(), encoder_grads()
        enc_differ = [n for n in first
                      if not torch.equal(first[n], second[n])]
        log(f"p6: the SECOND encoder's backward twice: {len(first)} "
            f"gradients, {len(enc_differ)} differ {enc_differ[:5]}")
        if enc_differ:
            raise AssertionError(f"p6: the encoder's gradients differ "
                                 f"between two runs: {enc_differ[:5]}")
        result.update(index_add_ops=atomic, encoder_gradients=len(first),
                      encoder_differ=0)

    def step_grads():
        model, step = train.fresh(train.dev)
        step(train.batches[0], noises=train.noises_dev)
        torch.cuda.synchronize()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    saved = torch.backends.cudnn.deterministic
    for label, deterministic in (("cuDNN default", False),
                                 ("cudnn.deterministic", True)):
        torch.backends.cudnn.deterministic = deterministic
        try:
            a, b = step_grads(), step_grads()
        finally:
            torch.backends.cudnn.deterministic = saved
        differ = [n for n in a if not torch.equal(a[n], b[n])]
        log(f"p6 / p8, {train.label}: the whole step twice ({label}): "
            f"{len(differ)} of {len(a)} gradients differ {differ[:5]}")
        result[label] = {"gradients": len(a), "differ": len(differ)}
        if deterministic and differ:
            raise AssertionError(f"p8: with cudnn.deterministic the "
                                 f"{train.label} step's gradients differ "
                                 f"between two runs: {differ[:5]}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step_grads()
            in_step = len(caught)
            # controls: histc and kthvalue on the card, which PyTorch's
            # documentation lists as nondeterministic (a warning here shows
            # that the capture sees such alerts), then a cuBLAS product (no
            # CUBLAS_WORKSPACE_CONFIG is set)
            ones = torch.ones(8, 8, device=train.dev)
            torch.histc(ones, bins=4)
            torch.kthvalue(ones, 2, dim=0)
            in_controls = len(caught)
            ones @ ones
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    raw = [f"{w.category.__name__}: {str(w.message)[:200]}" for w in caught]
    log(f"p8, {train.label}: {in_step} warnings caught in the step under "
        f"use_deterministic_algorithms(warn_only), raw: "
        f"{sorted(set(raw[:in_step]))}")
    log(f"p8, {train.label}: the controls' warnings, histc and kthvalue: "
        f"{sorted(set(raw[in_step:in_controls]))}; a cuBLAS product: "
        f"{sorted(set(raw[in_controls:]))}")
    flagged = sorted({str(w.message).split(".")[0][:160]
                      for w in caught[:in_step]
                      if "deterministic" in str(w.message)})
    log(f"p8, {train.label}: operators flagged nondeterministic in one step "
        f"under use_deterministic_algorithms(warn_only): {flagged}")
    result.update(flagged_nondeterministic=flagged, warnings_in_step=in_step,
                  control_warnings=in_controls - in_step,
                  cublas_warnings=len(caught) - in_controls)
    return result


def second_checks(smi, sec, kernel_rows):
    """Phase 14's checks, after every path is timed. Eval: each sparse op
    of the encoder on the card against the CPU on the path's own arguments
    (``hold_sparse_ops``), the encoder's BEV card against CPU, K1 and K3
    (fp32 and bf16) and N1 on the path's arguments, the profiles with the
    encoder's share of the frame's device time and its operators, the
    heads card against CPU (``check_eval``). Training: K1b and K3b on the
    step's arguments, the step's profile and the encoder's share, the loss
    falling on one batch, one step card against CPU (``check_train``)."""
    import copy
    import torch
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.ops import deform_conv, nms, sparse, warp

    t_phase = time.perf_counter()
    cell = sec.eval
    enc = cell.model.branch_m1.encoder
    points, mask = cell.batch["points_m1"], cell.batch["point_mask_m1"]

    def encode():
        with torch.inference_mode():
            return enc(points, mask)

    calls = record_all([(sparse, name) for name in SPARSE_OPS], encode)
    log(f"second eval: the encoder's sparse op calls "
        f"{[name for name, _, _ in calls]}")
    op_ms, fill = hold_sparse_ops(calls)
    enc_ms = time_ms(encode, iters=10, warmup=2)
    bev = encode()
    enc_cpu = copy.deepcopy(enc).cpu()
    with torch.inference_mode():
        bev_cpu = enc_cpu(points.cpu(), mask.cpu())
    err = float((bev.cpu() - bev_cpu).abs().max())
    scale = max(1.0, float(bev_cpu.abs().max()))
    rel = float((bev.cpu() - bev_cpu).norm() / bev_cpu.norm().clamp_min(1e-30))
    log(f"second encoder: BEV {tuple(bev.shape)} card vs CPU max |d| "
        f"{err:.3e} (tol {CPU_TOL:.0e} x {scale:.3e}), relative L2 {rel:.3e}"
        f"; {enc_ms:.3f} ms a call on the card (events; sparse ops "
        f"{ {k: round(v, 4) for k, v in op_ms.items()} })")
    if not (err <= CPU_TOL * scale and rel <= CPU_TOL):
        raise AssertionError(f"the SECOND encoder's BEV: card and CPU "
                             f"disagree ({err}, {rel})")
    # 41 z planes -> 2 of 128 channels at 1/8 of the 2048 x 1024 grid
    if tuple(bev.shape[2:]) != enc.bev_grid[1:] + (enc.out_channels,):
        raise AssertionError(f"the SECOND BEV is {tuple(bev.shape)}")

    # K1 and K3 on this path's (2, 32, 64, 128) maps, fp32 and bf16; device
    # times also over CUDA graphs, where the profiler keeps no record
    add_rows(kernel_rows, "second eval", check_eval(
        smi, cell, "second",
        [(deform_conv, "deform_conv3x3"), (fusion, "warp_affine")],
        lambda inputs: [check_deform(inputs, "second eval", graph=True),
                        check_warp(inputs, "second eval", graph=True)]))
    add_rows(kernel_rows, "second eval bf16", check_eval(
        smi, sec.eval16, "second",
        [(deform_conv, "deform_conv3x3"), (fusion, "warp_affine")],
        lambda inputs: [check_deform(inputs, "second eval bf16", graph=True),
                        check_warp(inputs, "second eval bf16", graph=True)],
        fp32_cell=cell))
    seen = record_calls([(nms, "nms_closure")],
                        lambda: cell.pipe.run(cell.batch, seed=0))
    n1 = check_nms(*seen["nms_closure"], "second eval", {})
    n1["launches"] = cell.launches["nms_closure"]
    add_rows(kernel_rows, "second eval", [n1])

    # the encoder's share of the looped frame's device time (check_eval's
    # profile), and its operators
    enc_busy, _, enc_ops = profile_device(lambda i: encode(), enc_ms,
                                          PROFILE_CALLS, "call",
                                          operators=True)
    share = enc_busy / cell.busy if cell.busy else float("nan")
    big = {k: round(v / cell.stream_ms, 4) for k, v in enc_ops.items()
           if v > SPARSE_KERNEL_SHARE * cell.stream_ms}
    log(f"second eval: the encoder takes {enc_busy:.3f} of the frame's "
        f"{cell.busy:.3f} device ms ({share:.3f}); operators over "
        f"{SPARSE_KERNEL_SHARE} of the streamed frame ({cell.stream_ms:.3f} "
        f"ms): {big}")

    train = sec.train
    tmodel = train.model
    tenc = tmodel.branch_m1.encoder
    tpoints = train.batches[0]["points_m1"]
    tmask = train.batches[0]["point_mask_m1"]
    gen = torch.Generator(device=train.dev).manual_seed(5)
    with torch.no_grad():
        probe = tenc(tpoints, tmask)
    cot = torch.randn(probe.shape, generator=gen, device=train.dev)

    def enc_step(i):
        tenc(tpoints, tmask).backward(cot)

    add_rows(kernel_rows, "second train step", check_train(
        train,
        [(deform_conv, "deform_conv3x3_bwd"), (warp, "warp_affine_bwd")],
        lambda inputs: [check_deform_bwd(inputs, "second train step"),
                        check_warp_bwd(inputs, "second train step")],
        jitter=jitter_within_voxels, explain_offsets=True))
    enc_step_busy, _, _ = profile_device(enc_step, None, PROFILE_CALLS,
                                         "step", operators=True)
    tmodel.zero_grad(set_to_none=True)
    p6 = hold_repeat_step(train, sparse=True)
    next(r for r in kernel_rows if r["name"] == "deform_conv3x3_bwd").setdefault(
        "repeat_step", {})["second"] = p6
    step_share = enc_step_busy / train.busy if train.busy else float("nan")
    log(f"second train: the encoder's forward and backward take "
        f"{enc_step_busy:.3f} of the step's {train.busy:.3f} device ms "
        f"({step_share:.3f}); the timed steps' peak memory "
        f"{sec.train_peak_gib:.2f} GiB above the other paths' cells")
    summary = {
        "eval_fp32": {"looped_ms": round(cell.ms, 3),
                      "streamed_ms": round(cell.stream_ms, 3),
                      "launches": {k: v for k, v in cell.launches.items()
                                   if v}},
        "eval_bf16": {"looped_ms": round(sec.eval16.ms, 3),
                      "streamed_ms": round(sec.eval16.stream_ms, 3)},
        "train_ms_per_step": round(train.ms, 3),
        "train_peak_gib": round(sec.train_peak_gib, 3),
        "step_launches": {k: v for k, v in train.launches.items() if v},
        "frame_busy_ms": round(cell.busy, 3),
        "encoder_busy_ms": round(enc_busy, 3),
        "encoder_share": round(share, 3),
        "encoder_ms": round(enc_ms, 3),
        "sparse_ops_ms": {k: round(v, 4) for k, v in op_ms.items()},
        "ops_over_share": big, "lists": fill,
        "step_busy_ms": round(train.busy, 3),
        "encoder_step_busy_ms": round(enc_step_busy, 3),
        "encoder_step_share": round(step_share, 3), "p6": p6}
    log(f"second: {json.dumps(summary)}")
    phase_done("SECOND, checks", t_phase)
    return summary


# phase 15, the paper's heterogeneous baselines (ROADMAP item 16) at full
# width, fp32 with TF32 off, random weights from seed 0, each on the train
# CLI's sampler and host adaptation (tools/train.py: build_dataset, Adapt;
# the ego slot takes the yaml's first modality, the other slot its second):
# BackAlign, CodeFilling and MPDA on m1m2_att.yaml (PointPillars m1 and the
# Lift-Splat-Shoot camera m2 of m2_att.yaml), STAMP on m0m2_att.yaml (the
# camera m2 the protocol space, m0's pillar feature through its
# adapterconvnext adapter). Each trains with its own loss and the train
# CLI's freeze schedule (frozen_predicate)
BASELINE_YAMLS = {
    m: os.path.join(os.path.dirname(GENCOMM_CONFIGS), "baselines", "stage2",
                    m, cfg + ".yaml")
    for m, cfg in (("backalign", "m1m2_att"), ("codefilling", "m1m2_att"),
                   ("mpda", "m1m2_att"), ("stamp", "m0m2_att"))}
BASELINE_FRAMES = 2  # eval frames after one warm-up, looped and streamed
BASELINE_STEPS = 1   # train steps after one warm-up
# the kernels each path must launch, and those it must not: K2b in none,
# since each schedule freezes the pillar branch; K4b where the camera
# branch trains, BackAlign; K3b where the loss reaches the fusion
BASELINE_EVAL_KERNELS = ("pillar_canvas", "warp_affine", "splat_topk",
                         "nms_closure")
BASELINE_TRAIN_KERNELS = {
    "backalign": ("pillar_canvas", "warp_affine", "splat_topk",
                  "warp_affine_bwd", "splat_topk_bwd"),
    "codefilling": ("pillar_canvas", "warp_affine", "splat_topk",
                    "warp_affine_bwd"),
    "mpda": ("pillar_canvas", "warp_affine", "splat_topk",
             "warp_affine_bwd"),
    "stamp": ("pillar_canvas", "warp_affine", "splat_topk")}
BASELINE_NOT_LAUNCHED = {
    "backalign": ("pillar_canvas_bwd",),
    "codefilling": ("pillar_canvas_bwd", "splat_topk_bwd"),
    "mpda": ("pillar_canvas_bwd", "splat_topk_bwd"),
    "stamp": ("pillar_canvas_bwd", "splat_topk_bwd", "warp_affine_bwd")}
# the inputs each card-vs-CPU step jitters: every floating input the step
# reads, the pillar modality's decorated points and the camera's images
# (the trainable modules of CodeFilling, MPDA and STAMP read both slots'
# features, BackAlign's camera branch the images)
BASELINE_JITTER_KEY = {
    "backalign": ("decorated_m1", "imgs_m2"),
    "codefilling": ("decorated_m1", "imgs_m2"),
    "mpda": ("decorated_m1", "imgs_m2"),
    "stamp": ("decorated_m0", "imgs_m2")}
# gradients zero in exact arithmetic (hold_step logs them): a shift of
# every key of a query (MPDA's cross-attention) and a conv bias before a
# train-mode batch norm (its resizer's residual blocks)
BASELINE_EXACT_ZERO = {
    "mpda": ("norm_k.bias", "to_k.bias") + tuple(
        f"res_{i}.Conv_{j}.bias" for i in (0, 1) for j in (0, 1))}


def hold_codes(method, card, cpu, dists, seg):
    """CodeFilling's codes (B, L, stages, H W seg), card against CPU, as
    integers: equal, but for at most CODE_FLIPS where the CPU's nearest
    code and the card's lie within CODE_TIE x max(1, d) of each other in the
    CPU's squared distance (``dists``: (n, seg, k) per stage), a near-tie
    that the card's fp32 sums in another order may break the other way.
    Returns the numbers."""
    b, l, n_stages, per = card.shape
    flips = (card != cpu).nonzero().tolist()
    gaps = []
    for bi, li, s, j in flips:
        d = dists[s][(bi * l + li) * (per // seg) + j // seg, j % seg]
        gaps.append(float((d[card[bi, li, s, j]] - d[cpu[bi, li, s, j]]).abs()
                          / max(1.0, float(d[cpu[bi, li, s, j]]))))
    out = {"shape": [b, l, n_stages, per], "differ": len(flips),
           "worst_gap": max(gaps, default=0.0),
           "distinct": int(card.unique().numel())}
    log(f"{method}: codes card vs CPU {out} (at most {CODE_FLIPS} may differ, "
        f"each within {CODE_TIE:.0e} x max(1, d) of the CPU's nearest)")
    if len(flips) > CODE_FLIPS or any(g > CODE_TIE for g in gaps):
        raise AssertionError(f"{method}: codes differ card against CPU beyond "
                             f"near-ties ({gaps})")
    return out


@contextlib.contextmanager
def host_gumbel():
    """Within it, the codebook's Gumbel draw is each level's noise from a
    CPU generator seeded by the level (the n-th call of a forward), moved
    to the device, so that the card and the CPU draw the same noise."""
    import torch
    from gencomm_tpu_torch.models import codebook

    calls, real = [0], codebook.gumbel

    def draw(shape, generator, device):
        g = torch.Generator().manual_seed(1000 + calls[0] % 3)
        calls[0] += 1
        u = torch.rand(tuple(shape), generator=g).clamp_min(
            torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(device)

    codebook.gumbel = draw
    try:
        yield
    finally:
        codebook.gumbel = real


def baseline_cell(smi, dev, method):
    """Phase 15 (a), one baseline, timed with the other paths before the
    process's first profiler session: 1 + BASELINE_FRAMES eval frames
    looped and streamed (``time_eval``: bit for bit, K2, K3, K4 and N1
    launched), 1 + BASELINE_STEPS train steps with the method's loss and
    freeze (``time_train``; the kernels of BASELINE_TRAIN_KERNELS launched,
    those of BASELINE_NOT_LAUNCHED not); every frozen tensor keeps its bits
    and every trainable one moves; the same frame, weights and inputs on
    the CPU (heads within CPU_TOL x max(1, max|cpu|) and by relative L2
    within CPU_TOL, CodeFilling's codes equal); one step card against CPU
    (``hold_step``). Returns the cell's numbers."""
    import argparse
    import torch
    from gencomm_tpu_torch.models import codebook
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.tools import train as train_cli

    t_phase = time.perf_counter()
    hypes = load_yaml(BASELINE_YAMLS[method])
    kw = model_kwargs(hypes)
    frozen = train_cli.frozen_predicate(
        argparse.Namespace(freeze_prefixes=""), hypes)
    ds = train_cli.build_dataset(hypes, True, "synthetic")
    adapt = train_cli.Adapt(hypes)
    t0 = time.perf_counter()
    host = adapt(ds.sample(1000, 1))
    batches = train_cli.batches(ds, hypes["train_params"]["batch_size"],
                                TRAIN_SEED, "synthetic")
    hosts = [adapt(next(batches)) for _ in range(1 + BASELINE_STEPS)]
    log(f"{method}: a frame and {len(hosts)} train batches sampled and "
        f"adapted on the host in {time.perf_counter() - t0:.3f} s; agent "
        f"slots {host['agent_mask'].shape[1]}, modalities by slot "
        + str({m: host[f'modality_mask_{m}'][0].tolist()
               for m in kw["modality_args"]}))
    cell = setup_eval(dev, kw, FEATURE_SHAPE, ds, host)
    time_eval(smi, cell, method, BASELINE_EVAL_KERNELS,
              frames=BASELINE_FRAMES)
    train = time_train(
        smi, dev, method, kw, hypes, FEATURE_SHAPE, hosts,
        BASELINE_TRAIN_KERNELS[method], BASELINE_JITTER_KEY[method],
        frozen=frozen)
    idle = [k for k in BASELINE_NOT_LAUNCHED[method]
            if train.launches[k] != 0]
    if idle:
        raise AssertionError(f"{method} training launched {idle}")
    # the freeze: every frozen tensor (parameters and the frozen
    # modules' running statistics) kept its bits over the steps; every
    # trainable parameter moved
    after = train.model.state_dict()
    frozen_keys = [k for k in after if frozen(tuple(k.split(".")))]
    trainable = [n for n, p in train.model.named_parameters()
                 if p.requires_grad]
    changed = [k for k in frozen_keys
               if not torch.equal(after[k].cpu(), train.state[k].cpu())]
    still = [n for n in trainable
             if torch.equal(after[n].cpu(), train.state[n].cpu())]
    modules = sorted({n.partition(".")[0] for n in trainable})
    log(f"{method}: after {1 + BASELINE_STEPS} steps {len(frozen_keys)} "
        f"frozen tensors, {len(changed)} changed; {len(trainable)} "
        f"trainable parameters in {modules}, {len(still)} did not move")
    if not frozen_keys or changed or not trainable or still:
        raise AssertionError(f"{method}: frozen tensors changed "
                             f"{changed[:5]}, trainable ones did not "
                             f"move {still[:5]}")

    # the same frame and weights on the CPU (the codebook's distances
    # kept, level by level)
    dists, real_distance = [], codebook.UMGMQuantizer._distance

    def distance(self, x, table):
        d = real_distance(self, x, table)
        dists.append(d)
        return d

    with torch.inference_mode():
        out_dev = cell.model(cell.batch)
        cpu_model = HeterModel(**cell.model_kw, device="cpu")
        cpu_model.load_state_dict(cell.state)
        t0 = time.perf_counter()
        codebook.UMGMQuantizer._distance = distance
        try:
            out_cpu = cpu_model(batch_to_device(host, "cpu"))
        finally:
            codebook.UMGMQuantizer._distance = real_distance
        cpu_s = time.perf_counter() - t0
    err = hold_heads(method, out_dev, out_cpu)
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        a, b = out_dev[key].float().cpu(), out_cpu[key]
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        log(f"{method}: card vs CPU {key} relative L2 {rel:.3e} (tol "
            f"{CPU_TOL:.0e})")
        if not rel <= CPU_TOL:
            raise AssertionError(f"{method} {key}: relative L2 {rel}")
    codes = None
    if "codebook_codes" in out_dev:
        codes = hold_codes(method, out_dev["codebook_codes"].cpu(),
                           out_cpu["codebook_codes"], dists,
                           cpu_model.codebook.seg_num)
        log(f"{method}: comm_rate card {float(out_dev['comm_rate']):.6f}"
            f", CPU {float(out_cpu['comm_rate']):.6f}")
    log(f"{method}: CPU forward took {cpu_s:.1f} s")
    del cpu_model, out_cpu
    # the CPU's Gumbel noise on both sides, for this step only: the timed
    # steps draw theirs on the device from the step's generator
    with host_gumbel():
        card, cpu = hold_step(train, BASELINE_EXACT_ZERO.get(method, ()),
                              same_choices=True)
    phase_done(f"baseline {method}", t_phase)
    return {"looped_ms": round(cell.ms, 3),
            "streamed_ms": round(cell.stream_ms, 3),
            "ms_per_step": round(train.ms, 3),
            "eval_launches": {k: v for k, v in cell.launches.items() if v},
            "stream_launches": cell.stream_launches,
            "step_launches": {k: v for k, v in train.launches.items() if v},
            "trainable_modules": modules, "frozen_tensors": len(frozen_keys),
            "heads_err": err, "codes": codes,
            "losses_card": {k: float(v) for k, v in card.items()},
            "losses_cpu": {k: float(v) for k, v in cpu.items()}}


def baselines(smi, dev):
    """Phase 15 (a): the four baselines (``baseline_cell``), one at a time,
    each model freed before the next; returns their numbers."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    for method in BASELINE_YAMLS:
        out[method] = baseline_cell(smi, dev, method)
        torch.cuda.empty_cache()
    log(f"baselines: {json.dumps(out)}")
    for method, r in out.items():
        log(f"eval {method} fp32: looped {r['looped_ms']:.3f} ms/frame, "
            f"streamed {r['streamed_ms']:.3f} ms/frame; training "
            f"{r['ms_per_step']:.3f} ms/step on {smi}")
    phase_done("baselines", t_phase)
    return out


def run_bench():
    """One run of ``python -m gencomm_tpu_torch.bench`` (bf16 flagship); its
    JSON line echoed; streamed must equal looped."""
    t_phase = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gencomm_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the bench failed:\n{proc.stderr[-4000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    log(f"bench: {line}")
    for key in ("fps_dispatch_loop", "fps_streamed", "dtype",
                "device_busy_ms", "launches_per_frame"):
        if key not in result:
            raise AssertionError(f"the bench's line has no {key}")
    if not result["streamed_equals_looped"]:
        raise AssertionError("the bench's streamed frames differ from looped")
    phase_done("bench", t_phase)
    return result


WORKFLOW_STEPS = 12  # steps per epoch of each training run
WORKFLOW_KERNELS = ("deform_conv3x3", "pillar_canvas", "warp_affine",
                    "splat_topk", "deform_conv3x3_bwd", "deform_conv3x3_bwd_dx",
                    "pillar_canvas_bwd", "warp_affine_bwd", "splat_topk_bwd",
                    "nms_closure")
WORKFLOW_POOL = 4  # --batch_pool of the runs with a camera modality
# the kernels SECOND's training run and inference (phase 14 (c)) must launch
SECOND_WORKFLOW_KERNELS = ("deform_conv3x3", "warp_affine",
                           "deform_conv3x3_bwd", "deform_conv3x3_bwd_dx",
                           "warp_affine_bwd", "nms_closure")
# the anchor-box evaluation: the first ANCHOR_TOPK of the 16,384 anchors by
# score into N1; scores by anchor type (yaw 0, yaw 90)
ANCHOR_TOPK = 2048
ANCHOR_LOGITS = (1.0, 0.0)
# the HEAL heads sit at stride 2: the first 2,048 of the 204.8 x 102.4 m
# grid's 65,536 anchors are a 3.2 m strip at its edge, where no vehicle
# spawns (0.9 of the range), so the anchor-box copy of phase 13 (c) is
# evaluated on a 51.2 x 25.6 m range (--range: 4,096 anchors, the first
# 2,048 half of the map)
HEAL_ANCHOR_RANGE = "-25.6,-12.8,-3,25.6,12.8,1"
# phase 12 (c): m1_v2xvit's evaluation frames, and the GenComm stage-2,
# HEAL and SECOND evaluations' (phases 11, 13 (c), 14 (c)). On its first
# frame each anchor-box copy reaches GT at IoU 0.3 on the CPU
# (scripts/anchor_box_ap_torch.py --frames 1 on the run's yaml: stage 2
# and V2X-ViT 2, SECOND 3, HEAL on its range 4), so AP30 > 0 holds on one
V2XVIT_FRAMES = 1
WORKFLOW_EVAL_FRAMES = 1
# phase 15 (b): the baselines' training steps (one epoch) and evaluation
# frames in the workflow process
BASELINE_WORKFLOW_STEPS = 4
BASELINE_WORKFLOW_FRAMES = 2


def host_noise_draw(real_draw):
    """``GenCommDiffusion.draw_noises`` (``real_draw``) drawing a frame's
    diffusion noise from the host generator seeded with the frame's seed, so
    that the card's and the CPU's evaluations of a frame share it."""
    import torch

    def draw(self, shape, generator, device):
        g = torch.Generator().manual_seed(generator.initial_seed())
        return [z.to(device) for z in real_draw(self, shape, g, "cpu")]
    return draw


class _Tee:
    """Writes to a buffer and to the process's stdout."""

    def __init__(self, buf, out):
        self.buf, self.out = buf, out

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def workflow(root: str) -> dict:
    """Phases 11, 12 (c), 13 (c), 14 (c), 16 and 15 (b), in their own
    process: the GenComm two-stage workflow, HEAL's and SECOND's stage 1,
    the robustness sweeps and late and early fusion training through the
    tools' main(argv) on the card; raises on any failed check and returns
    the phases' numbers."""
    import ast
    import contextlib
    import io
    import re
    import shutil

    import torch
    import yaml
    from gencomm_tpu_torch.models.gencomm.diffusion import GenCommDiffusion
    from gencomm_tpu_torch.ops import _cuda
    from gencomm_tpu_torch.pipeline import InferencePipeline
    from gencomm_tpu_torch.config.yaml_utils import save_yaml
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.tools import (
        heal_tools, inference, inference_heter_in_order, train,
    )
    from gencomm_tpu_torch.train import checkpoint, trainer

    if not torch.cuda.is_available():
        raise RuntimeError("the workflow phase needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _cuda.build_all()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    run = {k: os.path.join(root, k)
           for k in ("stage1_m1", "stage1_m2", "stage2_m1m2")}
    merged = os.path.join(run["stage2_m1m2"], "merged")
    yaml_of = {k: os.path.join(GENCOMM_CONFIGS, *k.split("_", 1)) + "_att.yaml"
               for k in run}
    run["stage1_v2xvit"] = os.path.join(root, "stage1_v2xvit")
    yaml_of["stage1_v2xvit"] = os.path.join(GENCOMM_CONFIGS, "stage1",
                                            "m1_v2xvit.yaml")
    # phase 13 (c): HEAL's base, its back-aligned camera model and the
    # final m1 + m2 inference (scripts/heal_pipeline_torch.sh)
    for key, rel in (("heal_base_m1", "stage1/m1_pyramid"),
                     ("heal_single_m2", "stage2/m2_single_pyramid")):
        run[key] = os.path.join(root, key)
        yaml_of[key] = os.path.join(HEAL_CONFIGS, rel + ".yaml")
    heal_final = os.path.join(root, "heal_final_m1m2")
    heal_final_yaml = os.path.join(HEAL_CONFIGS, "final_infer", "m1m2.yaml")
    # phase 14 (c): SECOND's stage 1 on a copy of m3_att.yaml in its run's
    # directory, with only its anchors' feature_stride changed (fault n)
    run["stage1_m3"] = os.path.join(root, "stage1_m3")
    yaml_of["stage1_m3"] = os.path.join(run["stage1_m3"], "m3_att.yaml")
    os.makedirs(run["stage1_m3"])
    with open(SECOND_YAML) as f:
        m3_raw = yaml.safe_load(f)
    m3_raw["postprocess"]["anchor_args"]["feature_stride"] = SECOND_STRIDE
    with open(yaml_of["stage1_m3"], "w") as f:
        yaml.safe_dump(m3_raw, f)

    # every model the tools build and every batch they step, on the card
    models = []
    real_create, real_inf_create = train.create_model, inference.create_model
    real_to_device = train.batch_to_device

    def recorded(create):
        def create_model(hypes, device=None):
            models.append(create(hypes, device=device))
            return models[-1]
        return create_model

    def to_device(batch, device):
        out = real_to_device(batch, device)
        off = sorted(k for k, v in out.items() if not v.is_cuda)
        if off:
            raise AssertionError(f"batch fields {off} are not on the card")
        return out

    train.create_model = recorded(real_create)
    inference.create_model = recorded(real_inf_create)
    train.batch_to_device = to_device
    # the state each training run starts its steps from, CUDA events
    # around every step (a cross-check of the CLI's host-clock ms/step) and
    # each run's step with its last arguments (profiled after every timing)
    starts, step_events, last_calls = [], [], []
    real_make_step = trainer.make_train_step

    def make_train_step(model, *a, **kw):
        starts.append({k: v.detach().clone()
                       for k, v in model.state_dict().items()})
        step, events = real_make_step(model, *a, **kw), []
        step_events.append(events)
        last_calls.append([step, None])

        def timed(*sa, **skw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*sa, **skw)
            end.record()
            events.append((start, end))
            last_calls[-1][1] = (sa, skw)
            return out
        return timed

    trainer.make_train_step = make_train_step
    # a frame's diffusion noise from the host generator, seeded with the
    # frame's seed, for the card's and the CPU's evaluation alike
    real_draw = GenCommDiffusion.draw_noises
    host_drawn = host_noise_draw(real_draw)

    # the heads of every frame an inference run decodes, by tool
    heads, real_detect = {}, InferencePipeline._detect
    current = [None]

    def recorded_detect(self, out, batch):
        heads.setdefault(current[0], []).append(
            {k: out[k].float().cpu() for k in ("cls_preds", "reg_preds",
                                               "dir_preds")})
        return real_detect(self, out, batch)

    InferencePipeline._detect = recorded_detect
    # and the detections of every frame
    dets, real_run = {}, InferencePipeline.run

    def recorded_run(self, *a, **kw):
        out = real_run(self, *a, **kw)
        dets.setdefault(current[0], []).append(out)
        return out

    InferencePipeline.run = recorded_run
    walls, texts, by_tool = {}, {}, {}

    def tool(label, main_fn, argv):
        log(f"workflow: {label}: {' '.join(argv)}")
        buf = io.StringIO()
        before = dict(_cuda.LAUNCHES)
        current[0] = label
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(buf, sys.stdout)):
            result = main_fn(argv)
        torch.cuda.synchronize()
        walls[label] = round(time.perf_counter() - t0, 3)
        texts[label] = buf.getvalue()
        by_tool[label] = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                          if v != before[k]}
        log(f"workflow: {label} took {walls[label]} s; launches "
            f"{by_tool[label]}")
        return result

    def train_argv(key, epochs, *extra):
        return ["-y", yaml_of[key], "--model_dir", run[key], "--dataset",
                "synthetic", "--device", "cuda", "--epochs", str(epochs),
                "--steps_per_epoch", str(WORKFLOW_STEPS), "--val_steps", "1",
                *extra]

    # how long the host takes for one camera batch (sampled and adapted)
    hypes_m2 = load_yaml(yaml_of["stage1_m2"])
    ds = train.build_dataset(hypes_m2, True, "synthetic")
    t0 = time.perf_counter()
    train.Adapt(hypes_m2)(ds.sample(0, hypes_m2["train_params"]["batch_size"]))
    host_camera_s = round(time.perf_counter() - t0, 3)
    log(f"workflow: the host makes one m2_att batch in {host_camera_s} s")

    reset_launch_counts()
    pool = ["--batch_pool", str(WORKFLOW_POOL)]
    tool("train stage1 m1_att", train.main, train_argv("stage1_m1", 2))
    tool("train stage1 m1_att, resumed", train.main, train_argv("stage1_m1", 3))
    if "resumed from" not in texts["train stage1 m1_att, resumed"] or \
            "(epoch 2)" not in texts["train stage1 m1_att, resumed"]:
        raise AssertionError("the second m1_att run did not resume at epoch 2")
    tool("train stage1 m2_att", train.main, train_argv("stage1_m2", 1, *pool))
    tool("heal_tools merge", heal_tools.main, [
        "--device", "cuda", "merge", "--new_ckpt", run["stage1_m2"],
        "--base_ckpt", run["stage1_m1"], "--out", merged])
    tool("train stage2 m1m2_att", train.main, train_argv(
        "stage2_m1m2", 1, "--init_from", merged, *pool))
    stage2_index = len(last_calls) - 1
    GenCommDiffusion.draw_noises = host_drawn
    card = tool("inference", inference.main, [
        "--model_dir", run["stage2_m1m2"], "--dataset", "synthetic",
        "--frames", str(WORKFLOW_EVAL_FRAMES), "--report_comm", "--device", "cuda"])
    GenCommDiffusion.draw_noises = real_draw
    tool("inference_heter_in_order", inference_heter_in_order.main, [
        "--model_dir", run["stage2_m1m2"], "--dataset", "synthetic",
        "--frames", "2", "--max_cav", "2", "--device", "cuda"])
    # phase 12 (c): V2X-ViT's stage 1, one epoch, and its evaluation
    tool("train stage1 m1_v2xvit", train.main, train_argv("stage1_v2xvit", 1))
    GenCommDiffusion.draw_noises = host_drawn
    tool("inference m1_v2xvit", inference.main, [
        "--model_dir", run["stage1_v2xvit"], "--dataset", "synthetic",
        "--frames", str(V2XVIT_FRAMES), "--device", "cuda"])
    GenCommDiffusion.draw_noises = real_draw
    # phase 14 (c): SECOND's stage 1, one epoch, and its evaluation
    m3_index = len(last_calls)
    tool("train stage1 m3_att", train.main, train_argv("stage1_m3", 1))
    GenCommDiffusion.draw_noises = host_drawn
    tool("inference m3_att", inference.main, [
        "--model_dir", run["stage1_m3"], "--dataset", "synthetic",
        "--frames", str(WORKFLOW_EVAL_FRAMES), "--device", "cuda"])
    GenCommDiffusion.draw_noises = real_draw
    m3_launches = {k: by_tool["train stage1 m3_att"].get(k, 0)
                   + by_tool["inference m3_att"].get(k, 0)
                   for k in SECOND_WORKFLOW_KERNELS}
    log(f"workflow: SECOND kernel launches {m3_launches}")
    if not all(m3_launches.values()):
        raise AssertionError(f"the SECOND runs launched {m3_launches}")
    launches = {k: _cuda.LAUNCHES[k] for k in WORKFLOW_KERNELS}
    log(f"workflow: GenComm kernel launches {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"the workflow launched no {missing}")
    # phase 13 (c): HEAL's three stages (scripts/heal_pipeline_torch.sh)
    heal_start = len(by_tool)
    tool("train heal m1_pyramid", train.main, train_argv("heal_base_m1", 1))
    heal_single_index = len(last_calls)
    tool("train heal m2_single_pyramid", train.main, train_argv(
        "heal_single_m2", 1, "--init_from", run["heal_base_m1"], *pool))
    tool("heal_tools merge, HEAL", heal_tools.main, [
        "--device", "cuda", "merge", "--new_ckpt", run["heal_single_m2"],
        "--base_ckpt", run["heal_base_m1"], "--out", heal_final])
    shutil.copy(heal_final_yaml, os.path.join(heal_final, "config.yaml"))
    heal_card = tool("inference heal m1m2", inference.main, [
        "--model_dir", heal_final, "--dataset", "synthetic",
        "--frames", str(WORKFLOW_EVAL_FRAMES), "--report_comm", "--device", "cuda"])
    tool("inference_heter_in_order heal m1m2", inference_heter_in_order.main, [
        "--model_dir", heal_final, "--dataset", "synthetic", "--frames", "2",
        "--max_cav", "2", "--device", "cuda"])
    heal_launches = {k: sum(t.get(k, 0) for t in
                            list(by_tool.values())[heal_start:])
                     for k in HEAL_KERNELS}
    log(f"workflow: HEAL kernel launches {heal_launches}")
    missing = [k for k, n in heal_launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"the HEAL workflow launched no {missing}")
    for m in models:
        off = [n for n, t in itertools.chain(m.named_parameters(),
                                             m.named_buffers())
               if not t.is_cuda]
        if off:
            raise AssertionError(f"model tensors {off[:5]} are not on the card")

    def latest(run_dir):
        return checkpoint.load_checkpoint(
            checkpoint.latest_checkpoint(run_dir))["state_dict"]

    # stage 2: only message_extractor_m2 moved
    start = starts[stage2_index]
    final = latest(run["stage2_m1m2"])
    trained = [k for k in final if k.startswith("message_extractor_m2.")]
    moved = [k for k in final if not torch.equal(final[k], start[k].cpu())]
    log(f"workflow: stage 2 moved {len(moved)} of {len(final)} tensors, "
        f"{len(trained)} trainable ones")
    if not moved or set(moved) - set(trained):
        raise AssertionError(
            f"stage 2 moved {sorted(set(moved) - set(trained))[:5]} "
            "outside message_extractor_m2, or nothing")
    result = dict(stage2_moved=len(moved), stage2_tensors=len(final),
                  launches=launches)
    # HEAL's stage 2: every parameter and running statistic of the pyramid
    # and the heads is the base's, bit for bit; the camera branch
    # (encoder_m2, backbone_m2) moved
    base, single = latest(run["heal_base_m1"]), latest(run["heal_single_m2"])
    start = starts[heal_single_index]
    shared = [k for k in single
              if k.startswith(("pyramid_backbone.", "heads."))]
    kept_bits = all(torch.equal(single[k], base[k]) for k in shared)
    moved = [k for k in single if not torch.equal(single[k], start[k].cpu())]
    log(f"workflow: HEAL stage 2 kept {len(shared)} pyramid and head tensors "
        f"bit for bit: {kept_bits}; moved {len(moved)} of {len(single)}")
    if not (shared and kept_bits and moved and all(
            k.startswith(("encoder_m2.", "backbone_m2.")) for k in moved)
            and any(k.startswith("backbone_m2.") for k in moved)):
        raise AssertionError(f"HEAL stage 2 froze the wrong tensors: "
                             f"kept {kept_bits}, moved {moved[:5]}")
    result["heal"] = {"launches": heal_launches, "frozen": len(shared),
                      "moved": len(moved), "tensors": len(single)}

    # every logged loss finite; each run's ms/step at it = 10
    ms_per_step, ms_per_step_events = {}, {}
    for key, d in run.items():
        with open(os.path.join(d, "metrics.jsonl")) as f:
            for line in f:
                vals = json.loads(line)
                if not all(math.isfinite(v) for v in vals.values()):
                    raise AssertionError(f"{key}: a non-finite loss {vals}")
    for label, text in texts.items():
        rates = [float(x) for x in re.findall(
            r"\]\[10\] .*\[([0-9.]+) ms/step\]", text)]
        if label.startswith("train"):
            ms_per_step[label] = rates

    # the per-step device clock: from the start of an epoch's step 1 to the
    # end of its step 10, as the CLI's line at it = 10 spans
    for label, events in zip([k for k in texts if k.startswith("train")],
                             step_events):
        for e in range(len(events) // WORKFLOW_STEPS):
            ep = events[e * WORKFLOW_STEPS:(e + 1) * WORKFLOW_STEPS]
            ms_per_step_events.setdefault(label, []).append(round(
                ep[1][0].elapsed_time(ep[10][1]) / 10, 3))

    # the same 4 frames on the CPU, for three checkpoints. (1) The trained
    # stage-2 checkpoint: the same APs. After 36 + 12 steps its norms'
    # running statistics are far from the data's, so eval-mode activations
    # reach 1e7-1e9 in the lidar backbone and the message extractor's
    # offsets 1e5-1e7 pixels, where the last bits of an offset move a
    # sample by whole pixels: its heads, card against CPU, read 3.3e-5 to
    # 6.5e-3 of their scale over five runs, so they are logged, not held
    # (scripts/workflow_module_diff_torch.py compares it module by module).
    # (2) The same checkpoint with its running statistics refreshed on the
    # stage-2 run's last batch (trainer.refresh_batch_stats): the heads of
    # every frame within CPU_TOL (the fused cls / reg / dir maps, which no
    # NMS decision stands between), the same kept boxes and the same APs.
    # (3) The stage-2 checkpoint with its heads' weights zeroed, so that
    # every box is its anchor (car-sized) with the score of its type's bias,
    # the same on the card and the CPU (ties kept in anchor order by the
    # stable sorts), and the first ANCHOR_TOPK into N1: its AP at IoU 0.3
    # must be above 0 (a lattice over a quarter of the map: 8 of the 48 GT
    # at IoU 0.3 on the CPU, scripts/anchor_box_ap_torch.py), and the same
    # kept boxes and APs on both
    def evaluate_run(name, run_dir, frames, batch, card_label,
                     anchor_range=None):
        """The checks above for the trained checkpoint of ``run_dir`` (its
        card run, ``card_label``, already made), its refreshed copy (none
        without a ``batch``) and its anchor-box copy (on the detection
        range ``anchor_range``, where one is given), over ``frames``
        frames; returns (APs, kept boxes a frame, the trained heads' error,
        the refreshed heads' error)."""
        hypes = load_yaml(None, run_dir)
        final = latest(run_dir)
        derived = {f"{name}_refreshed": hypes,
                   f"{name}_anchor_boxes": {**hypes, "postprocess": {
                       **hypes["postprocess"], "nms_topk": ANCHOR_TOPK}}}
        if batch is None:
            del derived[f"{name}_refreshed"]
        for dname, dhypes in derived.items():
            os.makedirs(os.path.join(root, dname))
            save_yaml(dhypes, os.path.join(root, dname, "config.yaml"))
        if batch is not None:
            model = create_model(hypes, device="cuda")
            model.load_state_dict(final)
            trainer.refresh_batch_stats(model, [batch],
                                        generator=torch.Generator(
                                            device="cuda").manual_seed(0))
            checkpoint.save_checkpoint(
                os.path.join(root, f"{name}_refreshed"),
                {k: v.cpu() for k, v in model.state_dict().items()}, 0,
                epoch=0)
            del model
        anchor_state = {k: v.clone() for k, v in final.items()}
        for head in ("cls_head", "reg_head", "dir_head"):
            anchor_state[f"heads.{head}.weight"].zero_()
            anchor_state[f"heads.{head}.bias"].zero_()
        anchor_state["heads.cls_head.bias"].copy_(torch.tensor(ANCHOR_LOGITS))
        checkpoint.save_checkpoint(
            os.path.join(root, f"{name}_anchor_boxes"), anchor_state, 0,
            epoch=0)
        GenCommDiffusion.draw_noises = host_drawn
        tool(f"{card_label} on the CPU", inference.main, [
            "--model_dir", run_dir, "--dataset", "synthetic",
            "--frames", str(frames), "--infer_info", "cpu", "--device", "cpu"])
        for dname in derived:
            argv = ["--model_dir", os.path.join(root, dname), "--dataset",
                    "synthetic", "--frames", str(frames)]
            if anchor_range and dname.endswith("_anchor_boxes"):
                argv.append(f"--range={anchor_range}")
            tool(f"inference, {dname}", inference.main,
                 argv + ["--device", "cuda"])
            tool(f"inference, {dname}, on the CPU", inference.main, argv + [
                "--infer_info", "cpu", "--device", "cpu"])
        GenCommDiffusion.draw_noises = real_draw

        def head_error(label, cpu_label):
            got, ref = heads[label], heads[cpu_label]
            if len(got) != frames or len(ref) != frames:
                raise AssertionError(f"{label}: the frames' heads were not "
                                     "recorded")
            worst = 0.0
            for a, b in zip(got, ref):
                for key in a:
                    err = float((a[key] - b[key]).abs().max())
                    worst = max(worst, err / max(1.0,
                                                 float(b[key].abs().max())))
            return worst

        trained_err = head_error(card_label, f"{card_label} on the CPU")
        head_err = None
        if batch is not None:
            head_err = head_error(f"inference, {name}_refreshed",
                                  f"inference, {name}_refreshed, on the CPU")
        log(f"workflow: {name} heads over {frames} frames, max |d| / max(1, "
            f"max|cpu|), card vs CPU: trained {trained_err:.3e} (not held), "
            f"refreshed {head_err} (tol {CPU_TOL:.0e})")
        if head_err is not None and not head_err <= CPU_TOL:
            raise AssertionError(f"{name}: card and CPU heads disagree "
                                 f"({head_err})")
        kept = {}
        for dname in derived:
            label = f"inference, {dname}"
            card_dets, cpu_dets = dets[label], dets[f"{label}, on the CPU"]
            if len(card_dets) != frames or len(cpu_dets) != frames:
                raise AssertionError(f"{label}: the frames' detections were "
                                     "not recorded")
            for f, (a, b) in enumerate(zip(card_dets, cpu_dets)):
                match_dets(f"workflow: {label}, frame {f}, card vs CPU", a, b)
            kept[dname] = [int(a.valid.sum()) for a in card_dets]
        aps = {}
        for dname, d in [(name, run_dir)] + [
                (dname, os.path.join(root, dname)) for dname in derived]:
            for tag in ("eval", "eval_global_sort"):
                with open(os.path.join(d, f"{tag}.yaml")) as f:
                    on_card = yaml.safe_load(f)
                with open(os.path.join(d, f"{tag}_cpu.yaml")) as f:
                    on_cpu = yaml.safe_load(f)
                aps[f"{dname} {tag}"] = {"card": on_card, "cpu": on_cpu}
                bad = [k for k in on_card
                       if not abs(on_card[k] - on_cpu[k]) <= AP_TOL]
                if bad or set(on_card) != set(on_cpu):
                    raise AssertionError(f"{dname} {tag}: card {on_card} and "
                                         f"CPU {on_cpu} disagree")
        log(f"workflow: {name} APs card and CPU {aps}")
        if not aps[f"{name}_anchor_boxes eval"]["card"]["ap30"] > 0:
            raise AssertionError(
                f"{name}: the anchor boxes matched no GT at IoU 0.3 "
                f"({aps[f'{name}_anchor_boxes eval']}), so the APs held are "
                "zeros")
        return aps, kept, trained_err, head_err

    def comm_report(label):
        return ast.literal_eval(re.search(r"comm report: (\{.*\})",
                                          texts[label]).group(1))

    stage2_batch = last_calls[stage2_index][1][0][0]
    aps, kept, trained_err, head_err = evaluate_run(
        "stage2", run["stage2_m1m2"], WORKFLOW_EVAL_FRAMES, stage2_batch,
        "inference")
    if card != aps["stage2 eval_global_sort"]["card"]:
        raise AssertionError(f"inference returned {card}")
    # phase 12 (c): V2X-ViT's stage 1 through the same tools and checks
    vx_aps, vx_kept, vx_trained_err, vx_head_err = evaluate_run(
        "v2xvit", run["stage1_v2xvit"], V2XVIT_FRAMES,
        last_calls[stage2_index + 1][1][0][0], "inference m1_v2xvit")
    # phase 14 (c): SECOND's stage 1, its trained checkpoint, its copy
    # refreshed on its run's last batch and its anchor-box copy (heads on a
    # 3.2 m lattice, twice the flagship's: 17 of the 48 GT at IoU 0.3 on
    # the CPU, scripts/anchor_box_ap_torch.py on the run's yaml)
    m3_aps, m3_kept, m3_trained_err, m3_head_err = evaluate_run(
        "m3", run["stage1_m3"], WORKFLOW_EVAL_FRAMES,
        last_calls[m3_index][1][0][0],
        "inference m3_att")
    result["m3"] = {"aps": m3_aps, "kept_per_frame": m3_kept,
                    "card_vs_cpu_heads_refreshed": m3_head_err,
                    "card_vs_cpu_heads_trained": m3_trained_err,
                    "launches": m3_launches}
    result.update(
        aps=aps, kept_per_frame=kept, comm=comm_report("inference"),
        card_vs_cpu_heads_refreshed=head_err,
        card_vs_cpu_heads_trained=trained_err,
        v2xvit={"aps": vx_aps, "kept_per_frame": vx_kept,
                "card_vs_cpu_heads_refreshed": vx_head_err,
                "card_vs_cpu_heads_trained": vx_trained_err})
    # phase 13 (c): the final m1 + m2 model on the card and the CPU, its
    # copy refreshed on one batch of its own config (no training run has
    # one: a lidar agent and a camera agent, the score masks, the crop and
    # K4 before the pyramid, held at the heads), its anchor-box copy; the
    # payload report of a pyramid model (fault l)
    final_hypes = load_yaml(heal_final_yaml)
    final_batch = train.batch_to_device(train.Adapt(final_hypes)(
        train.build_dataset(final_hypes, True, "synthetic").sample(
            0, final_hypes["train_params"]["batch_size"])), "cuda")
    h_aps, h_kept, h_trained_err, h_head_err = evaluate_run(
        "heal", heal_final, WORKFLOW_EVAL_FRAMES, final_batch,
        "inference heal m1m2",
        anchor_range=HEAL_ANCHOR_RANGE)
    if heal_card != h_aps["heal eval_global_sort"]["card"]:
        raise AssertionError(f"inference returned {heal_card}")
    result["heal"].update(aps=h_aps, kept_per_frame=h_kept,
                          card_vs_cpu_heads_refreshed=h_head_err,
                          card_vs_cpu_heads_trained=h_trained_err,
                          comm=comm_report("inference heal m1m2"))
    # phase 16: the robustness sweeps on the m1_att run, late and early
    # fusion through the train CLI, CoAlign
    @contextlib.contextmanager
    def host_noise():
        GenCommDiffusion.draw_noises = host_drawn
        try:
            yield
        finally:
            GenCommDiffusion.draw_noises = real_draw

    t16 = time.perf_counter()
    m1_index = [k for k in texts if k.startswith("train")].index(
        "train stage1 m1_att, resumed")
    result["robustness"], noisy = robustness_sweeps(
        root, tool, dets, heads, run["stage1_m1"],
        last_calls[m1_index][1][0][0], host_noise)
    InferencePipeline._detect = real_detect
    InferencePipeline.run = real_run
    result["late_early"] = late_early_training(root, tool, starts)
    result["coalign"] = coalign_card(root)
    phase_done("phase 16, all", t16)

    # K3 and K3b on the noisy eval's last theta (phase 16's rows)
    src, theta, g = noisy
    result["robustness_rows"] = [
        check_warp({"warp_affine": (src, theta)}, "noisy eval"),
        check_warp_bwd({"warp_affine_bwd": (g, theta)}, "noisy eval")]
    for row in result["robustness_rows"]:
        row["launches"] = None

    # device time per step of each training run, from torch.profiler over 2
    # more steps on its last batch, after every timing of the phase: what
    # freezing saves on the card, whatever pace the host sets
    device_ms_per_step = {}
    train_labels = [k for k in texts if k.startswith("train")]
    for label, (step, call), events in zip(train_labels, last_calls,
                                           step_events):
        if "resumed" in label:
            continue
        sa, skw = call
        log(f"workflow: {label}, {PROFILE_CALLS} step(s) on its last batch "
            "under the profiler")
        busy, n_launches, _ = profile_device(
            lambda i: step(*sa, **skw), ms_per_step_events[label][-1],
            PROFILE_CALLS, "step")
        device_ms_per_step[label] = {"busy_ms": round(busy, 3),
                                     "launches": round(n_launches)}
    log(f"workflow: device time per step {device_ms_per_step}")
    # phase 15 (b), in this process after every check of the others
    result["baselines"] = baseline_workflow(os.path.join(root, "baselines"))
    return dict(result, ms_per_step=ms_per_step,
                ms_per_step_events=ms_per_step_events,
                device_ms_per_step=device_ms_per_step, wall_s=walls,
                launches_by_tool=by_tool, host_camera_batch_s=host_camera_s)


# phase 16, the robustness evaluation (ROADMAP item 21): the sweeps' frames
# a level (the anchor-box copy's first frame reaches 2 GT at IoU 0.3 on the
# CPU, as above, so it takes one), their levels, and the configs the train
# CLI now trains in late, no and early fusion
ROBUST_FRAMES = 1
ROBUST_ANCHOR_FRAMES = 1
NOISE_LEVELS, LAPLACE_LEVEL, DELAYS = "0,0.4", "0.4", "0,200"
# the refreshed m1_att copy keeps no box at the yaml's score threshold (0.2),
# so its threshold is set into the widest gap of its own scores that leaves
# each frame at least ROBUST_KEPT kept boxes and at most ROBUST_MOST anchors
# above it (card and CPU scores part by ~1e-5; score_gap)
ROBUST_KEPT, ROBUST_MOST = 3, 200
LATE_EARLY_YAMLS = {"m1_pretrain": "configs/opv2v/single/m1_pretrain.yaml",
                    "early_fusion": "configs/opv2v/point_pillar_early_fusion.yaml"}
LATE_EARLY_STEPS = 4  # 1 + 3 steps through the CLI, one epoch
# CoAlign card against CPU: fp32 Gauss-Newton, the normal equations' sums in
# another order (the CPU against JAX read up to 1.1e-6, tests/test_torch_
# coalign.py)
COALIGN_TOL = 1e-4


def score_gap(probs, kept, n_keep=ROBUST_KEPT, most=ROBUST_MOST):
    """(threshold, gap): the midpoint of the widest gap between neighbouring
    scores of ``probs`` (every anchor's score, a tensor a frame) that leaves
    at least ``n_keep`` of each frame's ``kept`` scores (the boxes a run at
    threshold 0 kept) and at most ``most`` of each frame's anchors above it.
    The boxes kept above a threshold are then the ones kept at 0 above it:
    N1 suppresses a box only by higher-scored ones."""
    import torch

    if min(k.numel() for k in kept) < n_keep:
        raise AssertionError(f"a frame keeps fewer than {n_keep} boxes at "
                             f"threshold 0: {[k.numel() for k in kept]}")
    hi = min(float(torch.sort(k, descending=True).values[n_keep - 1])
             for k in kept)
    lo = max(float(p.flatten().topk(most + 1).values[-1]) for p in probs)
    vals = torch.unique(torch.cat([p.flatten() for p in probs]))
    vals = vals[vals >= lo].double()
    mids, gaps = (vals[1:] + vals[:-1]) / 2, vals[1:] - vals[:-1]
    gaps = torch.where(mids < hi, gaps, torch.zeros_like(gaps))
    if not gaps.numel() or float(gaps.max()) <= 0:
        raise AssertionError(f"no score gap between {lo} and {hi}")
    i = int(gaps.argmax())
    return float(mids[i]), float(gaps[i])


def robustness_sweeps(root, tool, dets, heads, m1_run, m1_batch,
                      noise_draws):
    """Phase 16 (a) and (b), in the workflow process: the m1_att run's copy
    with its running statistics refreshed on its last batch, through
    inference_w_noise (NOISE_LEVELS, and LAPLACE_LEVEL Laplace) and
    inference_w_delay (DELAYS) on the card and on the CPU (each side its own
    copy of the run dir, the frames' diffusion noise from the host,
    ``noise_draws``): per frame the fused heads (``heads``, recorded by
    tool label) within CPU_TOL x max(1, max|cpu|) and the kept boxes and
    scores (``match_dets``, at least one a frame at every level) card
    against CPU, every level's APs within AP_TOL. The refreshed copy's
    score threshold comes from a probe of every level on the card at
    threshold 0 (``score_gap``). The anchor-box copy
    at level 0 (AP30 > 0 on both, the same APs). The thetas K3 took on the
    card at noise 0.4 differ from level 0's, and K3 and K3b are held against
    their plain versions on them. Returns the numbers and the K3 / K3b
    rows."""
    import shutil

    import torch
    import yaml
    from gencomm_tpu_torch.config.yaml_utils import save_yaml
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.tools import inference_w_delay, inference_w_noise
    from gencomm_tpu_torch.train import checkpoint, trainer

    t_phase = time.perf_counter()
    hypes = load_yaml(None, m1_run)
    final = checkpoint.load_checkpoint(
        checkpoint.latest_checkpoint(m1_run))["state_dict"]
    model = create_model(hypes, device="cuda")
    model.load_state_dict(final)
    trainer.refresh_batch_stats(model, [m1_batch], generator=torch.Generator(
        device="cuda").manual_seed(0))
    refreshed = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    anchor_state = {k: v.clone() for k, v in final.items()}
    for head in ("cls_head", "reg_head", "dir_head"):
        anchor_state[f"heads.{head}.weight"].zero_()
        anchor_state[f"heads.{head}.bias"].zero_()
    anchor_state["heads.cls_head.bias"].copy_(torch.tensor(ANCHOR_LOGITS))
    dirs = {}
    for name, state, hyp in (
            ("refreshed", refreshed, hypes),
            ("anchor_boxes", anchor_state, {**hypes, "postprocess": {
                **hypes["postprocess"], "nms_topk": ANCHOR_TOPK}})):
        for side in ("card", "cpu"):
            d = dirs[name, side] = os.path.join(root, f"robust_{name}_{side}")
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            save_yaml(hyp, os.path.join(d, "config.yaml"))
            checkpoint.save_checkpoint(d, state, 0, epoch=0)
    frames = ["--frames", str(ROBUST_FRAMES)]

    def refreshed_threshold(threshold):
        pp = hypes["postprocess"]
        hyp = {**hypes, "postprocess": {**pp, "target_args": {
            **pp["target_args"], "score_threshold": threshold}}}
        for side in ("card", "cpu"):
            save_yaml(hyp, os.path.join(dirs["refreshed", side],
                                        "config.yaml"))
    sweeps = (("noise", inference_w_noise.main,
               ["--levels", NOISE_LEVELS], [f"noise_{float(x)}" for x in
                                            NOISE_LEVELS.split(",")]),
              ("laplace", inference_w_noise.main,
               ["--levels", LAPLACE_LEVEL, "--laplace"],
               [f"noise_{float(LAPLACE_LEVEL)}_laplace"]),
              ("delay", inference_w_delay.main, ["--delays", DELAYS],
               [f"delay_{int(x)}ms" for x in DELAYS.split(",")]))
    thetas = {}
    with noise_draws():
        refreshed_threshold(0.0)
        for sweep, main_fn, extra, _ in sweeps:
            tool(f"robustness {sweep}, probe", main_fn, [
                "--model_dir", dirs["refreshed", "card"], "--dataset",
                "synthetic", *frames, "--device", "cuda", *extra])
        probe = [f"robustness {sweep}, probe" for sweep, *_ in sweeps]
        probs = [torch.sigmoid(h["cls_preds"]) for k in probe
                 for h in heads[k]]
        kept_probe = [d.scores.cpu()[d.valid.cpu()] for k in probe
                      for d in dets[k]]
        threshold, gap = score_gap(probs, kept_probe)
        above = [int((k > threshold).sum()) for k in kept_probe]
        log(f"robustness: the refreshed copy's score threshold {threshold:.6f} "
            f"(a gap of {gap:.3e} between its scores; the yaml's "
            f"{hypes['postprocess']['target_args']['score_threshold']}); the "
            f"probe's kept boxes above it, a frame: {above}")
        refreshed_threshold(threshold)
        for sweep, main_fn, extra, infos in sweeps:
            for side, device in (("card", "cuda"), ("cpu", "cpu")):
                label = f"robustness {sweep}, {side}"
                argv = ["--model_dir", dirs["refreshed", side], "--dataset",
                        "synthetic", *frames, "--device", device, *extra]
                if side == "card" and sweep == "noise":
                    calls = record_all([(fusion, "warp_affine")],
                                       lambda: tool(label, main_fn, argv))
                    thetas = [a for _, a, _ in calls]
                else:
                    tool(label, main_fn, argv)
            for f, (a, b) in enumerate(zip(dets[f"robustness {sweep}, card"],
                                           dets[f"robustness {sweep}, cpu"])):
                match_dets(f"robustness {sweep}, frame {f} of the levels, card "
                           "vs CPU", a, b)
                if not int(a.valid.sum()) > 0:
                    raise AssertionError(f"robustness {sweep}, frame {f} of "
                                         "the levels: no box kept")
            worst = 0.0
            for a, b in zip(heads[f"robustness {sweep}, card"],
                            heads[f"robustness {sweep}, cpu"]):
                for key in a:
                    worst = max(worst, float((a[key] - b[key]).abs().max())
                                / max(1.0, float(b[key].abs().max())))
            log(f"robustness {sweep}: heads card vs CPU, max |d| / max(1, "
                f"max|cpu|) {worst:.3e} (tol {CPU_TOL:.0e})")
            if not worst <= CPU_TOL:
                raise AssertionError(f"robustness {sweep}: heads differ "
                                     f"({worst})")
            frames_seen = len(heads[f"robustness {sweep}, card"])
            if frames_seen != ROBUST_FRAMES * len(infos):
                raise AssertionError(f"robustness {sweep}: {frames_seen} "
                                     "frames' heads recorded")
        for side, device in (("card", "cuda"), ("cpu", "cpu")):
            tool(f"robustness anchor boxes, {side}", inference_w_noise.main, [
                "--model_dir", dirs["anchor_boxes", side], "--dataset",
                "synthetic", "--frames", str(ROBUST_ANCHOR_FRAMES),
                "--levels", "0", "--device", device])
    aps = {}
    for name, infos in (("refreshed", [i for _, _, _, inf in sweeps
                                       for i in inf]),
                        ("anchor_boxes", ["noise_0.0"])):
        for info in infos:
            for tag in (f"eval_{info}", f"eval_global_sort_{info}"):
                got = []
                for side in ("card", "cpu"):
                    with open(os.path.join(dirs[name, side],
                                           f"{tag}.yaml")) as f:
                        got.append(yaml.safe_load(f))
                aps[f"{name} {tag}"] = {"card": got[0], "cpu": got[1]}
                if set(got[0]) != set(got[1]) or any(
                        not abs(got[0][k] - got[1][k]) <= AP_TOL
                        for k in got[0]):
                    raise AssertionError(f"robustness {name} {tag}: card "
                                         f"{got[0]} and CPU {got[1]} differ")
    log(f"robustness: APs card and CPU {aps}")
    if not aps["anchor_boxes eval_noise_0.0"]["card"]["ap30"] > 0:
        raise AssertionError("robustness: the anchor boxes matched no GT at "
                             "IoU 0.3 at level 0, so the APs held are zeros")
    # K3 at level 0 then 0.4, one launch a frame: the noisy thetas differ
    n = len(thetas) // 2
    if n != ROBUST_FRAMES or len(thetas) != 2 * n:
        raise AssertionError(f"robustness: {len(thetas)} K3 calls recorded")
    moved = [float((b[1] - a[1]).abs().max())
             for a, b in zip(thetas[:n], thetas[n:])]
    log(f"robustness: the noisy thetas' largest change from the clean ones, "
        f"a frame: {moved}")
    if not all(m > 0 for m in moved):
        raise AssertionError("robustness: the noise did not reach K3's thetas")
    src, theta = thetas[-1]
    g = torch.randn(src.shape, device=src.device,
                    generator=torch.Generator(src.device).manual_seed(16))
    phase_done("robustness sweeps (phase 16 (a), (b))", t_phase)
    return {"aps": aps, "theta_moved": moved,
            "refreshed_threshold": threshold, "threshold_gap": gap,
            "probe_kept_above": above,
            "kept_per_frame": {k: [int(d.valid.sum()) for d in v]
                               for k, v in dets.items()
                               if k.startswith("robustness")}}, (src, theta, g)


def late_early_training(root, tool, starts):
    """Phase 16 (c): single/m1_pretrain.yaml (late fusion, the ego slot) and
    point_pillar_early_fusion.yaml (the clouds merged into the ego frame)
    through the train CLI, one epoch of LATE_EARLY_STEPS steps on the card;
    then each from its run's starting state: 4 steps on the CLI's first
    batch (the loss must fall) and one step card against CPU on it as in
    phase 6 (hold_step, the decorated points jittered)."""
    from types import SimpleNamespace

    import torch
    from gencomm_tpu_torch.loss import create_loss
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.tools import train
    from gencomm_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name, rel in LATE_EARLY_YAMLS.items():
        run_dir = os.path.join(root, f"train_{name}")
        index = len(starts)
        tool(f"late/early fusion: train {name}", train.main, [
            "-y", os.path.join(repo, rel), "--model_dir", run_dir,
            "--dataset", "synthetic", "--device", "cuda", "--epochs", "1",
            "--steps_per_epoch", str(LATE_EARLY_STEPS), "--val_steps", "1"])
        hypes = load_yaml(None, run_dir)
        host = train.Adapt(hypes)(next(train.batches(
            train.build_dataset(hypes, True, "synthetic"),
            hypes["train_params"]["batch_size"], 0, "synthetic")))
        start = starts[index]
        single = bool(hypes["model"]["args"].get("supervise_single"))

        def fresh(device, hypes=hypes, start=start, single=single):
            model = create_model(hypes, device=device)
            model.load_state_dict(start)
            model.train()
            opt, sched = trainer.make_optimizer(hypes,
                                                model.named_parameters(), 1)
            return model, trainer.make_train_step(
                model, create_loss(hypes), opt, sched,
                supervise_single=single)

        cell = SimpleNamespace(label=name, dev=torch.device("cuda"),
                               hosts=[host], batches=[batch_to_device(
                                   host, "cuda")], jitter_key="decorated_m1",
                               noises=None, noises_dev=None, fresh=fresh)
        log(f"{name}: the CLI's first batch, agent slots "
            f"{host['agent_mask'].shape}, points "
            f"{host['decorated_m1'].shape}")
        model, step = fresh(cell.dev)
        totals = [float(step(cell.batches[0])["total_loss"])
                  for _ in range(4)]
        log(f"{name}: 4 steps on one batch: total_loss {totals}")
        if not totals[-1] < totals[0]:
            raise AssertionError(f"{name}: the loss did not fall: {totals}")
        del model, step
        card, cpu = hold_step(cell)
        out[name] = {"losses_one_batch": totals,
                     "card_vs_cpu": {k: [float(card[k]), float(v)]
                                     for k, v in cpu.items()}}
    phase_done("late and early fusion training (phase 16 (c))", t_phase)
    return out


def coalign_card(root):
    """Phase 16 (d): CoAlign on the card against the CPU. Three agents in a
    chain (the ego shares boxes with agent 1, agent 1 with agent 2, which
    the ego never sees), agent 2 given a pose error: the refined poses card
    and CPU within COALIGN_TOL, the error recovered; then the
    pose-graph tool (precalc, evaluate on the card) must lower the
    position error at every noise level."""
    import numpy as np
    import torch
    from gencomm_tpu_torch.models.coalign import box_align_relative
    from gencomm_tpu_torch.tools import pose_graph

    # tests/test_coalign.py's chain (make_chain_scene, seed 3): 4 boxes
    # shared by the ego and agent 1, 4 by agents 1 and 2
    rng = np.random.RandomState(3)
    true = np.array([[0.0, 0.0, 0.0], [12.0, 1.0, 0.2], [24.0, -1.0, -0.1]])
    groups = [np.stack([rng.uniform(a, b, 4), rng.uniform(-6, 6, 4)], 1)
              for a, b in ((3, 9), (15, 21))]
    yaws = [rng.uniform(-np.pi, np.pi, 4) for _ in groups]
    seen = ((0,), (0, 1), (1,))
    k = 8
    centers = np.zeros((3, k, 2), np.float32)
    yaw = np.zeros((3, k), np.float32)
    mask = np.zeros((3, k), bool)
    for i, grp in enumerate(seen):
        xy = np.concatenate([groups[g] for g in grp])
        yw = np.concatenate([yaws[g] for g in grp])
        c, s = np.cos(true[i, 2]), np.sin(true[i, 2])
        centers[i, :len(xy)] = (xy - true[i, :2]) @ np.array([[c, s],
                                                               [-s, c]]).T
        yaw[i, :len(xy)] = yw - true[i, 2]
        mask[i, :len(xy)] = True
    noisy = true.copy()
    noisy[2] += [0.9, -0.6, 0.06]
    got = {}
    for dev in ("cuda", "cpu"):
        args = [torch.as_tensor(a, device=dev) for a in (centers, yaw, mask)]
        got[dev] = box_align_relative(
            *args, torch.as_tensor(noisy, dtype=torch.float32, device=dev),
            thres=3.0).cpu().numpy()
    gap = float(np.abs(got["cuda"] - got["cpu"]).max())
    before = np.abs(noisy - true)[1:].max(0)
    after = np.abs(got["cuda"] - true)[1:].max(0)
    log(f"CoAlign: refined poses card vs CPU max |d| {gap:.3e} (tol "
        f"{COALIGN_TOL:.0e}); the non-ego error x, y, yaw {before} -> "
        f"{after}")
    if not gap <= COALIGN_TOL:
        raise AssertionError(f"CoAlign: card and CPU differ by {gap}")
    if not (after[:2] < 0.1).all() or not after[2] < 0.02:
        raise AssertionError(f"CoAlign did not recover the error: {after}")
    out_dir = os.path.join(root, "pose_graph")
    pose_graph.main(["precalc", "--out", out_dir, "--frames", "3"])
    report = pose_graph.main(["evaluate", "--out", out_dir, "--device",
                              "cuda"])
    if not all(v["pos_err_refined_m"] < v["pos_err_noisy_m"]
               for v in report.values()):
        raise AssertionError(f"pose_graph: no level improved {report}")
    return {"card_vs_cpu": gap, "error_before": before.tolist(),
            "error_after": after.tolist(), "pose_graph": report}


def baseline_workflow(root: str) -> dict:
    """Phase 15 (b), through the tools' main(argv) on the card: CodeFilling
    (m1m2_att.yaml) trained for one epoch of BASELINE_WORKFLOW_STEPS steps
    (the codebook only) and evaluated over BASELINE_WORKFLOW_FRAMES frames
    with --report_comm on the card and with --device cpu (the same APs,
    heads within CPU_TOL and the same kept boxes, the code bytes per stage
    equal); STAMP (m0m2_att.yaml) trained likewise (the adapters and
    reverters only), merged by heal_tools merge-final with a second run
    dir (its own checkpoint without the adapters, made by heal_tools
    remove), which must hold every tensor of the run, and the merged model
    evaluated on the card. Each run's tensors that moved are held to its
    freeze schedule, and each tool's kernel launches to the table of
    BASELINE_TRAIN_KERNELS / BASELINE_EVAL_KERNELS. Raises on any failed
    check; returns the phase's numbers."""
    import ast
    import contextlib
    import io
    import re
    import shutil

    import torch
    import yaml
    from gencomm_tpu_torch.ops import _cuda
    from gencomm_tpu_torch.pipeline import InferencePipeline
    from gencomm_tpu_torch.tools import heal_tools, inference, train
    from gencomm_tpu_torch.train import checkpoint, trainer

    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    run = {m: os.path.join(root, m) for m in ("codefilling", "stamp")}
    # the state each training run starts from; each frame's heads and
    # detections by tool
    starts, heads, dets, current = [], {}, {}, [None]
    real_make_step = trainer.make_train_step
    real_detect, real_run = InferencePipeline._detect, InferencePipeline.run

    def make_train_step(model, *a, **kw):
        starts.append({k: v.detach().clone()
                       for k, v in model.state_dict().items()})
        return real_make_step(model, *a, **kw)

    def recorded_detect(self, out, batch):
        heads.setdefault(current[0], []).append(
            {k: out[k].float().cpu() for k in ("cls_preds", "reg_preds",
                                               "dir_preds")})
        return real_detect(self, out, batch)

    def recorded_run(self, *a, **kw):
        out = real_run(self, *a, **kw)
        dets.setdefault(current[0], []).append(out)
        return out

    texts, by_tool = {}, {}

    def tool(label, main_fn, argv):
        log(f"baselines workflow: {label}: {' '.join(argv)}")
        buf = io.StringIO()
        before = dict(_cuda.LAUNCHES)
        current[0] = label
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(buf, sys.stdout)):
            result = main_fn(argv)
        torch.cuda.synchronize()
        texts[label] = buf.getvalue()
        by_tool[label] = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                          if v != before[k]}
        log(f"baselines workflow: {label} took "
            f"{time.perf_counter() - t0:.3f} s; launches {by_tool[label]}")
        return result

    def train_argv(method):
        return ["-y", BASELINE_YAMLS[method], "--model_dir", run[method],
                "--dataset", "synthetic", "--device", "cuda", "--epochs", "1",
                "--steps_per_epoch", str(BASELINE_WORKFLOW_STEPS),
                "--val_steps", "1"]

    def infer_argv(model_dir, device, info=None):
        return ["--model_dir", model_dir, "--dataset", "synthetic",
                "--frames", str(BASELINE_WORKFLOW_FRAMES),
                "--device", device] + (["--infer_info", info] if info else [])

    def latest(run_dir):
        return checkpoint.load_checkpoint(
            checkpoint.latest_checkpoint(run_dir))["state_dict"]

    def comm_report(label):
        return ast.literal_eval(re.search(r"comm report: (\{.*\})",
                                          texts[label]).group(1))

    trainer.make_train_step = make_train_step
    InferencePipeline._detect = recorded_detect
    InferencePipeline.run = recorded_run
    try:
        tool("train codefilling", train.main, train_argv("codefilling"))
        for label, device, info in (
                ("inference codefilling", "cuda", None),
                ("inference codefilling on the CPU", "cpu", "cpu")):
            tool(label, inference.main, infer_argv(
                run["codefilling"], device, info) + ["--report_comm"])
        tool("train stamp", train.main, train_argv("stamp"))
        stamp_base = os.path.join(root, "stamp_without_adapters")
        stamp_merged = os.path.join(root, "stamp_merged")
        tool("heal_tools remove", heal_tools.main, [
            "--device", "cuda", "remove", "--ckpt", run["stamp"], "--out",
            stamp_base, "--prefix", "adapter_", "reverter_"])
        tool("heal_tools merge-final", heal_tools.main, [
            "--device", "cuda", "merge-final", "--ckpts", stamp_base,
            run["stamp"], "--out", stamp_merged])
        shutil.copy(os.path.join(run["stamp"], "config.yaml"),
                    os.path.join(stamp_merged, "config.yaml"))
        stamp_aps = tool("inference stamp merged", inference.main,
                         infer_argv(stamp_merged, "cuda"))
    finally:
        trainer.make_train_step = real_make_step
        InferencePipeline._detect = real_detect
        InferencePipeline.run = real_run

    # CodeFilling: the same APs, heads and kept boxes card against CPU, and
    # the code bytes per stage on both
    cf_aps = {}
    for tag in ("eval", "eval_global_sort"):
        with open(os.path.join(run["codefilling"], f"{tag}.yaml")) as f:
            on_card = yaml.safe_load(f)
        with open(os.path.join(run["codefilling"], f"{tag}_cpu.yaml")) as f:
            on_cpu = yaml.safe_load(f)
        cf_aps[tag] = {"card": on_card, "cpu": on_cpu}
        if set(on_card) != set(on_cpu) or any(
                abs(on_card[k] - on_cpu[k]) > AP_TOL for k in on_card):
            raise AssertionError(f"codefilling {tag}: card {on_card} and CPU "
                                 f"{on_cpu} disagree")
    report = comm_report("inference codefilling")
    report_cpu = comm_report("inference codefilling on the CPU")
    stages = report.get("code_bytes_per_stage")
    log(f"baselines workflow: codefilling APs card and CPU {cf_aps}; the "
        f"card's report {report}")
    if report.get("payload") != "codebook_codes" or not stages or \
            len(stages) != 3 or stages != report_cpu.get(
                "code_bytes_per_stage"):
        raise AssertionError(f"codefilling's report: card {report}, CPU "
                             f"{report_cpu}")
    card_heads = heads["inference codefilling"]
    cpu_heads = heads["inference codefilling on the CPU"]
    if len(card_heads) != BASELINE_WORKFLOW_FRAMES or \
            len(cpu_heads) != BASELINE_WORKFLOW_FRAMES:
        raise AssertionError("codefilling: the frames' heads were not "
                             "recorded")
    heads_err = max(
        float((a[k] - b[k]).abs().max()) / max(1.0, float(b[k].abs().max()))
        for a, b in zip(card_heads, cpu_heads) for k in a)
    log(f"baselines workflow: codefilling heads card vs CPU, max |d| / "
        f"max(1, max|cpu|) {heads_err:.3e} (tol {CPU_TOL:.0e})")
    if not heads_err <= CPU_TOL:
        raise AssertionError(f"codefilling: card and CPU heads disagree "
                             f"({heads_err})")
    for f, (a, b) in enumerate(zip(dets["inference codefilling"],
                                   dets["inference codefilling on the CPU"])):
        match_dets(f"baselines workflow: codefilling, frame {f}, card vs CPU",
                   a, b)
    # each run moved the tensors of its schedule only; the merge holds
    # every tensor of the STAMP run
    moved_by = {}
    for (method, prefixes), start in zip(
            (("codefilling", ("codebook.",)),
             ("stamp", ("adapter_", "reverter_"))), starts):
        final = latest(run[method])
        moved = [k for k in final
                 if not torch.equal(final[k], start[k].cpu())]
        moved_by[method] = len(moved)
        log(f"baselines workflow: {method} moved {len(moved)} of "
            f"{len(final)} tensors")
        if not moved or any(not k.startswith(prefixes) for k in moved):
            raise AssertionError(f"{method} moved {moved[:5]}")
    merged, own = latest(stamp_merged), latest(run["stamp"])
    base = latest(stamp_base)
    if set(merged) != set(own) or not all(torch.equal(merged[k], own[k])
                                          for k in own) or \
            any(k.startswith(("adapter_", "reverter_")) for k in base):
        raise AssertionError("merge-final: the merged checkpoint does not "
                             "hold the STAMP run's tensors")
    for label, names in (("train codefilling",
                          BASELINE_TRAIN_KERNELS["codefilling"]),
                         ("inference codefilling", BASELINE_EVAL_KERNELS),
                         ("train stamp", BASELINE_TRAIN_KERNELS["stamp"]),
                         ("inference stamp merged", BASELINE_EVAL_KERNELS)):
        missing = [k for k in names if not by_tool[label].get(k)]
        if missing:
            raise AssertionError(f"{label} launched no {missing}")
    phase_done("baselines workflow", t_phase)
    return {"codefilling": {"aps": cf_aps, "report": report,
                            "heads_err": heads_err,
                            "moved": moved_by["codefilling"]},
            "stamp": {"aps_card": stamp_aps, "moved": moved_by["stamp"],
                      "merged_tensors": len(merged),
                      "without_adapters": len(base)},
            "launches": by_tool}


# phase 17 (ROADMAP items 21 (d) and 18), in its own process after the
# workflow's (``chip_smoke.py --phase17 DIR``): the raw-point pillar path and the
# legacy encoders and detectors at full width, fp32 with TF32 off, random
# weights from seed 0, on the train CLI's sampler; HEAL's SECOND stages
# through the CLIs; every tool on configs/opv2v/gencomm/stage1/m1_att.yaml
LEGACY_YAMLS = {
    "voxel_net": "configs/opv2v/voxel_net.yaml",
    "pixor": "configs/opv2v/pixor.yaml",
    "second": "configs/opv2v/second.yaml",
    "second_intermediate": "configs/opv2v/second_intermediate.yaml",
    "m1_att_raw": "configs/opv2v/gencomm/stage1/m1_att.yaml"}
LEGACY_FRAMES = 3  # eval frames after one warm-up, looped and streamed
LEGACY_STEPS = 3   # the train CLI's one epoch: 1 + 2 steps
# the kernels each eval path must launch; K2 and K2b on none of them (the
# raw points are max-reduced in plain PyTorch, ops/voxel.py)
LEGACY_EVAL_KERNELS = {
    "voxel_net": ("warp_affine", "nms_closure"),
    "pixor": ("warp_affine", "nms_closure"),
    "second": ("nms_closure",),
    "second_intermediate": ("warp_affine", "nms_closure"),
    "m1_att_raw": ("deform_conv3x3", "warp_affine", "nms_closure")}
LEGACY_TRAIN_KERNELS = {
    "voxel_net": ("warp_affine", "warp_affine_bwd"),
    "pixor": ("warp_affine", "warp_affine_bwd"),
    "second": (),
    "second_intermediate": ("warp_affine", "warp_affine_bwd"),
    "m1_att_raw": ("deform_conv3x3", "deform_conv3x3_bwd", "warp_affine",
                   "warp_affine_bwd")}
LEGACY_NOT_LAUNCHED = ("pillar_canvas", "pillar_canvas_bwd")
# the grid within whose cells a card-vs-CPU step's jitter keeps each point:
# the encoder's voxels (PIXOR's raster slices)
LEGACY_JITTER_GRID = {
    "voxel_net": (0.4, 0.4, 0.4), "pixor": (0.4, 0.4, 0.1),
    "second": (0.1, 0.1, 0.1), "second_intermediate": (0.1, 0.1, 0.1),
    "m1_att_raw": (0.4, 0.4, 4.0)}
# the card-vs-CPU step runs on the yaml cut to this range, 1/64 of the
# area: on the card machine's CPU the full-width VoxelNet step's backward
# did not end within 14 minutes, and the full-width legacy SECOND step
# took 49 s (its CPU forward and backward, once). Both steps take the CPU
# step's segment maxima and ReLU gates (cpu_choices): a gate whose input
# lies within rounding of zero, opening on one side only, moved a CPU
# step's own gradients by up to 1.8e-2 under a 1e-7 jitter of the points,
# and by 7e-5 with the gates taken
LEGACY_STEP_RANGE = [-12.8, -6.4, -3.0, 12.8, 6.4, 1.0]
# and one sample of the cut yaml's sampler (the yamls' batch holds 2): the
# legacy SECOND step's CPU forward and backward took 16-26 s at 2, the cut
# area barely shortening it (its sparse lists keep JAX's fixed capacities)
LEGACY_STEP_BATCH = 1
HEAL_M3 = ("stage1/m3_pyramid", "stage2/m3_single_pyramid")
HEAL_M3_STEPS = 3
HEAL_M3_KERNELS = {"m3_pyramid": ("warp_affine", "nms_closure"),
                   "m3_single_pyramid": ("nms_closure",)}
TOOL_ITERS = 3


class _Tool:
    """Runs a tool's ``main(argv)`` on the card: its output echoed, its
    wall time and kernel launches logged (under ``phase``) and kept."""

    def __init__(self, phase="phase 17"):
        self.phase = phase
        self.walls, self.launches, self.texts = {}, {}, {}

    def __call__(self, label, main_fn, argv):
        import contextlib
        import io

        import torch
        from gencomm_tpu_torch.ops import _cuda

        log(f"{self.phase}: {label}: {' '.join(argv)}")
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(buf, sys.stdout)):
            result = main_fn(argv)
        torch.cuda.synchronize()
        self.walls[label] = round(time.perf_counter() - t0, 3)
        self.texts[label] = buf.getvalue()
        self.launches[label] = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        log(f"{self.phase}: {label} took {self.walls[label]} s; launches "
            f"{self.launches[label]}")
        return result


def _hypes_model(hypes, device):
    """``setup_eval``'s and ``time_train``'s ``build`` for a yaml's model."""
    from gencomm_tpu_torch.models import create_model

    return create_model(hypes, device=device)


def _heads_grid_shape(hypes):
    """The diffusion noise's shape for a yaml: its anchors' grid and the
    fused map's channels."""
    from gencomm_tpu_torch.data.postprocessor import generate_anchor_box

    h, w = generate_anchor_box(hypes["postprocess"]["anchor_args"]).shape[:2]
    return (h, w, FEATURE_SHAPE[-1])


def legacy_eval_cell(smi, dev, name, hypes):
    """Phase 17 (a), one config's eval cell (``setup_eval`` on the yaml's
    model, seeded weights, one frame of its sampler with the raw points on
    the card), timed by ``time_eval``: 1 + LEGACY_FRAMES frames looped and
    streamed, bit for bit, the kernels of LEGACY_EVAL_KERNELS launched and
    K2 not."""
    from types import SimpleNamespace

    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.postprocessor import generate_anchor_box
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.tools import train

    buckets = create_model(hypes, device="cpu").agent_buckets
    ds = train.build_dataset(hypes, False, "synthetic")
    host = trim_agent_slots(ds.sample(1000, 1), buckets=buckets)
    if "decorated_m1" in host or "points_m1" not in host:
        raise AssertionError(f"{name}: the frame does not hold raw points")
    pp = hypes["postprocess"]
    anchors = generate_anchor_box(pp["anchor_args"], pp.get("order", "hwl"))
    cell = setup_eval(dev, {"hypes": hypes}, _heads_grid_shape(hypes),
                      SimpleNamespace(anchors=anchors), host,
                      build=_hypes_model, postprocess=pp,
                      samples=host["agent_mask"].size if name == "second"
                      else 1)
    time_eval(smi, cell, name, LEGACY_EVAL_KERNELS[name],
              frames=LEGACY_FRAMES)
    extra = [k for k in LEGACY_NOT_LAUNCHED if cell.launches[k]]
    if extra:
        raise AssertionError(f"{name} eval launched {extra}")
    cell.pipe.graphs.clear()  # check_eval captures the frame anew
    return cell


def legacy_eval_checks(smi, name, cell):
    """Phase 17 (a), one config's eval checks (``check_eval``): the
    profile, the heads card against the port's CPU, K3 on the path's maps
    (VoxelNet's and the raw-point m1_att's are the flagship's shapes) and
    N1 on its overlap matrix. Returns the kernels' rows as [path, row]
    pairs."""
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.ops import nms

    warp = ("warp_affine" in LEGACY_EVAL_KERNELS[name]
            and name not in ("voxel_net", "m1_att_raw"))
    path = f"{name} eval (phase 17)"
    rows = check_eval(smi, cell, name, [(fusion, "warp_affine")] if warp else [],
                      lambda inputs: [check_warp(inputs, f"{name} eval",
                                                 graph=True)] if warp else [])
    if name in ("second", "pixor"):
        seen = record_calls([(nms, "nms_closure")],
                            lambda: cell.pipe.run(cell.batch, seed=0))
        nms_rows = [check_nms(*seen["nms_closure"], f"{name} eval", {})]
        fill_launches(nms_rows, cell.launches, cell.routes, path)
        rows += nms_rows
    return [(path, row) for row in rows]


def legacy_train_cell(smi, dev, name, path, root, tool):
    """Phase 17 (b), one config's training: one epoch of LEGACY_STEPS steps
    through the train CLI on the card (``--no_host_decorate`` for the
    raw-point pillar path; the kernels of LEGACY_TRAIN_KERNELS launched, K2
    and K2b not), then the path timed by ``time_train`` on the CLI's first
    LEGACY_STEPS batches and seeded weights; with the cell, the card-vs-CPU
    step's cell on the yaml cut to LEGACY_STEP_RANGE and LEGACY_STEP_BATCH
    samples a batch (its sampler's first batch, seeded weights)."""
    import copy
    from types import SimpleNamespace

    import torch
    from gencomm_tpu_torch.loss import create_loss
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.tools import inference, train
    from gencomm_tpu_torch.train import trainer
    from gencomm_tpu_torch.weights import random_state_dict

    raw = name == "m1_att_raw"
    run_dir = os.path.join(root, f"train_{name}")
    label = f"train {name}"
    tool(label, train.main, [
        "-y", path, "--model_dir", run_dir, "--dataset", "synthetic",
        "--device", "cuda", "--epochs", "1", "--steps_per_epoch",
        str(LEGACY_STEPS), "--val_steps", "1"]
        + (["--no_host_decorate"] if raw else []))
    launches = tool.launches[label]
    missing = [k for k in LEGACY_TRAIN_KERNELS[name] if not launches.get(k)]
    extra = [k for k in LEGACY_NOT_LAUNCHED if launches.get(k)]
    if missing or extra:
        raise AssertionError(f"{label} launched none of {missing}, or "
                             f"{extra}")

    def host_batches(hypes, n):
        adapt = train.Adapt(hypes, host_decorate=not raw)
        it = train.batches(train.build_dataset(hypes, True, "synthetic"),
                           hypes["train_params"]["batch_size"], 0,
                           "synthetic")
        return [adapt(next(it)) for _ in range(n)]

    run_hypes = load_yaml(None, run_dir)
    hosts = host_batches(run_hypes, LEGACY_STEPS)
    log(f"{name}: the CLI's first batch, agent slots "
        f"{hosts[0]['agent_mask'].shape}, points "
        f"{hosts[0]['points_m1'].shape}, "
        f"{int(hosts[0]['pos_equal_one'].sum())} positive anchors")
    cell = time_train(smi, dev, name, {"hypes": run_hypes}, run_hypes,
                      _heads_grid_shape(run_hypes), hosts,
                      LEGACY_TRAIN_KERNELS[name], "points_m1",
                      build=_hypes_model)
    extra = [k for k in LEGACY_NOT_LAUNCHED if cell.launches[k]]
    if extra:
        raise AssertionError(f"{name} training launched {extra}")

    cut = inference.override_range(copy.deepcopy(run_hypes),
                                   LEGACY_STEP_RANGE)
    cut["train_params"]["batch_size"] = LEGACY_STEP_BATCH
    cut_host = host_batches(cut, 1)[0]
    state = random_state_dict(create_model(cut, device="cpu"), seed=0)

    def fresh(device):
        model = create_model(cut, device=device)
        model.load_state_dict(state)
        model.train()
        opt, sched = trainer.make_optimizer(cut, model.named_parameters(), 1)
        return model, trainer.make_train_step(model, create_loss(cut), opt,
                                              sched)

    gen = torch.Generator().manual_seed(3)
    noises = [torch.randn((cut_host["agent_mask"].size,)
                          + _heads_grid_shape(cut), generator=gen)
              for _ in range(3)]
    cell.cut = SimpleNamespace(
        label=name, dev=dev, hosts=[cut_host],
        batches=[batch_to_device(cut_host, dev)], jitter_key="points_m1",
        noises=noises, noises_dev=[z.to(dev) for z in noises], fresh=fresh)
    log(f"{name}: the card-vs-CPU step on the yaml cut to "
        f"{LEGACY_STEP_RANGE}: agent slots {cut_host['agent_mask'].shape}, "
        f"{int(cut_host['pos_equal_one'].sum())} positive anchors")
    return cell


def legacy_train_checks(name, cell):
    """Phase 17 (b), one config's training checks (``check_train``): K3b on
    the step's arguments, the profile, the loss falling over 4 steps on one
    batch, and the card-vs-CPU step on the cut yaml, both steps taking the
    CPU step's segment maxima and ReLU gates, each point jittered within its
    cell of LEGACY_JITTER_GRID. Returns the kernels' rows as [path, row]
    pairs."""
    from gencomm_tpu_torch.ops import warp

    bwd = "warp_affine_bwd" in LEGACY_TRAIN_KERNELS[name]
    rows = check_train(
        cell, [(warp, "warp_affine_bwd")] if bwd else [],
        lambda inputs: [check_warp_bwd(inputs, f"{name} train step")]
        if bwd else [],
        jitter=functools.partial(jitter_in_grid,
                                 lidar_range=LEGACY_STEP_RANGE,
                                 voxel_size=LEGACY_JITTER_GRID[name]),
        step_cell=cell.cut, same_choices=True)
    return [(f"{name} train step (phase 17)", row) for row in rows]


def heal_m3(root, tool):
    """Phase 17 (c): HEAL's SECOND stages through the CLIs on the card:
    stage1/m3_pyramid.yaml (collab) one epoch of HEAL_M3_STEPS steps, then
    stage2/m3_single_pyramid.yaml from it (``--init_from``), each evaluated
    by the inference CLI (1 frame). Each runs on a copy of its yaml whose
    anchors' feature_stride puts the anchors on the heads' grid (fault n:
    the yaml's stride puts them on twice it), found from one frame of the
    model. K3 and N1 must be launched (the single model's N1 alone), and
    K3b in the collab model's training."""
    import copy

    import torch
    import yaml
    from gencomm_tpu_torch.config.yaml_utils import update_yaml
    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.tools import inference, train

    t_phase = time.perf_counter()
    out, prev = {}, None
    for rel in HEAL_M3:
        key = rel.split("/")[1]
        run_dir = os.path.join(root, f"heal_{key}")
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(HEAL_CONFIGS, rel + ".yaml")) as f:
            raw = yaml.safe_load(f)
        hypes = update_yaml(copy.deepcopy(raw))
        model = create_model(hypes, device="cuda")
        host = trim_agent_slots(train.build_dataset(hypes, False, "synthetic")
                                .sample(0, 1), buckets=model.agent_buckets)
        with torch.inference_mode():
            heads_h = model(batch_to_device(host, "cuda"))["cls_preds"].shape[1]
        del model
        lr = raw["postprocess"]["anchor_args"]["cav_lidar_range"]
        vy = raw["preprocess"]["args"]["voxel_size"][1]
        stride = int(round((lr[4] - lr[1]) / vy / heads_h))
        log(f"heal {key}: heads {heads_h} rows, the yaml's feature_stride "
            f"{raw['postprocess']['anchor_args']['feature_stride']}, the "
            f"copy's {stride}")
        raw["postprocess"]["anchor_args"]["feature_stride"] = stride
        ypath = os.path.join(run_dir, f"{key}.yaml")
        with open(ypath, "w") as f:
            yaml.safe_dump(raw, f)
        argv = ["-y", ypath, "--model_dir", run_dir, "--dataset", "synthetic",
                "--device", "cuda", "--epochs", "1", "--steps_per_epoch",
                str(HEAL_M3_STEPS), "--val_steps", "1"]
        if prev is not None:
            argv += ["--init_from", prev]
        tool(f"train heal {key}", train.main, argv)
        aps = tool(f"inference heal {key}", inference.main, [
            "--model_dir", run_dir, "--dataset", "synthetic", "--frames", "1",
            "--device", "cuda"])
        # the collab model warps and fuses the agents' levels; the single
        # model (one agent's heads) warps nothing
        launched = {k: tool.launches[f"train heal {key}"].get(k, 0)
                    + tool.launches[f"inference heal {key}"].get(k, 0)
                    for k in HEAL_M3_KERNELS[key]}
        if key == "m3_pyramid":
            launched["warp_affine_bwd"] = tool.launches[
                f"train heal {key}"].get("warp_affine_bwd", 0)
        log(f"heal {key}: launches {launched}, APs {aps}")
        if not all(launched.values()):
            raise AssertionError(f"heal {key} launched {launched}")
        out[key] = {"feature_stride": stride, "launches": launched,
                    "aps": aps}
        prev = run_dir
    phase_done("HEAL's SECOND stages (phase 17)", t_phase)
    return out


def tools_card(tool):
    """Phase 17 (d), every tool on the card: the profiler on m1_att.yaml
    (the eval frame and ``--train``, with ``--trace`` and ``--by_module``:
    params, FLOPs in both parts, latencies, MFU in (0, 1] against the
    card's fp32 peak; an unknown card raises), ``inference_time``,
    ``sustained_fps`` on m1_att.yaml, and ``bench_matrix``'s default rows
    and ``--added_cost`` rows (none may err; K4 held against its plain
    version on the last camera row's arguments). Returns the numbers and
    K4's row as a [path, row] pair."""
    from gencomm_tpu_torch.models.encoders import lss
    from gencomm_tpu_torch.tools import (
        bench_matrix, inference_time, profiler, sustained_fps,
    )

    t_phase = time.perf_counter()
    yaml_path = os.path.join(GENCOMM_CONFIGS, "stage1", "m1_att.yaml")
    prof = tool("profiler m1_att", profiler.main, [
        "--hypes_yaml", yaml_path, "--iters", str(TOOL_ITERS), "--train",
        "--trace", "--by_module"])
    mfus = [prof["looped"]["mfu"], prof["streamed"]["mfu"],
            prof["train"]["mfu"]]
    if not (prof["flops"]["library"] > 0 and prof["flops"]["hand_kernels"] > 0
            and prof["params"] > 0 and all(m is not None and 0 < m <= 1
                                           for m in mfus)):
        raise AssertionError(f"the profiler's numbers: {prof['flops']}, "
                             f"MFU {mfus}")
    try:
        profiler.peak_flops_per_s("fp32", "an unknown card")
    except ValueError as exc:
        log(f"profiler: an unknown card raises: {exc}")
    else:
        raise AssertionError("the profiler took an unknown card's peak")
    times = tool("inference_time", inference_time.main,
                 ["--iters", str(2 * TOOL_ITERS)])
    if not all(r["ms"] > 0 for r in times.values()):
        raise AssertionError(f"inference_time: {times}")
    fps = tool("sustained_fps m1_att", sustained_fps.main,
               ["-y", yaml_path, "--frames", str(2 * TOOL_ITERS)])
    rows = []
    bench = record_all([(lss, "splat_topk")], lambda: rows.extend(
        tool("bench_matrix", bench_matrix.main, ["--iters", "2"])
        + tool("bench_matrix --added_cost", bench_matrix.main,
               ["--iters", "2", "--added_cost"])))
    errs = [r for r in rows if "error" in r]
    if errs or len(rows) != len(bench_matrix.DEFAULT_CONFIGS) + 1 + len(
            bench_matrix.HETERO_METHODS):
        raise AssertionError(f"bench_matrix rows erred: {errs}")
    if not bench:
        raise AssertionError("no bench_matrix row launched K4")
    k4_launches = sum(tool.launches[label].get("splat_topk", 0) for label
                      in ("bench_matrix", "bench_matrix --added_cost"))
    k4_row = check_splat({"splat_topk": bench[-1][1]},
                         "bench_matrix camera row")
    fill_launches([k4_row], {"splat_topk": k4_launches}, {},
                  "bench_matrix camera row (phase 17)")
    phase_done("tools (phase 17)", t_phase)
    summary = {
        "profiler": {k: prof[k] for k in ("params", "dtype",
                                          "peak_flops_per_s")}
        | {"flops": prof["flops"], "looped": prof["looped"],
           "streamed": prof["streamed"],
           "train": {k: prof["train"][k] for k in ("flops", "step", "mfu",
                                                   "peak_bytes")},
           "by_module_top": prof.get("by_module", [])[:8]},
        "inference_time": times, "sustained_fps": fps, "bench_matrix": rows}
    return summary, ("bench_matrix camera row (phase 17)", k4_row)


def phase17(root: str) -> dict:
    """Phase 17 in its own process, after the workflow's; raises on any
    failed check and returns the numbers and the kernel rows (as [path,
    row] pairs). Every eval and training path is timed before the
    process's first profiler session (ROADMAP p1), then checked, its
    kernels held against their plain versions on the path's arguments."""
    import shutil

    import torch
    from gencomm_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise RuntimeError("phase 17 needs a CUDA device")
    t_all = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    tool, rows = _Tool(), []
    repo = os.path.dirname(os.path.abspath(__file__))
    paths = {name: os.path.join(repo, rel)
             for name, rel in LEGACY_YAMLS.items()}
    out = {"legacy": {}}
    _cuda.build_all()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    evals = {name: legacy_eval_cell(smi, dev, name, load_yaml(path))
             for name, path in paths.items()}
    trains = {name: legacy_train_cell(smi, dev, name, path, root, tool)
              for name, path in paths.items()}
    out["heal_m3"] = heal_m3(root, tool)
    for name in paths:
        rows += legacy_eval_checks(smi, name, evals[name])
        rows += legacy_train_checks(name, trains[name])
        ev, tr = evals.pop(name), trains.pop(name)
        out["legacy"][name] = {
            "looped_ms": round(ev.ms, 3),
            "streamed_ms": round(ev.stream_ms, 3),
            "eval_busy_ms": round(ev.busy, 3),
            "eval_launches": {k: v for k, v in ev.launches.items() if v},
            "graph_launches": ev.stream_launches,
            "ms_per_step": round(tr.ms, 3),
            "step_busy_ms": round(tr.busy, 3),
            "step_launches": {k: v for k, v in tr.launches.items() if v},
            "cli_train_s": tool.walls[f"train {name}"]}
        del ev, tr
        torch.cuda.empty_cache()
    out["tools"], k4 = tools_card(tool)
    rows.append(k4)
    out["walls"] = tool.walls
    out["rows"] = rows
    for name, r in out["legacy"].items():
        log(f"phase 17 {name}: looped {r['looped_ms']} ms/frame, streamed "
            f"{r['streamed_ms']} ms/frame (device busy {r['eval_busy_ms']} "
            f"ms), {r['ms_per_step']} ms/step (busy {r['step_busy_ms']} ms) "
            f"on {smi}")
    phase_done("phase 17", t_all)
    return out


def run_phase17():
    """Phase 17 in its own process (``chip_smoke.py --phase17 DIR``), after
    the workflow's has ended; its output echoed, its last line (the phase's
    JSON) returned."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase17")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--phase17", root],
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines()[:-1]:
        log(f"  17| {line}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 17 failed:\n{proc.stderr[-6000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"phase 17: {json.dumps({k: v for k, v in result.items() if k != 'rows'})}")
    phase_done("phase 17 (its process)", t_phase)
    return result


# ---------------------------------------------------------------- phase 18
P18_YAMLS = {"v2xreal": "configs/v2xreal/gencomm/stage1/m1_att.yaml",
             "opv2v": "configs/opv2v/gencomm/stage1/m1_att.yaml"}
# the trees' size: 3 CAVs a scenario, 12 training and 2 validation
# timestamps, 80,000 points a cloud (over the loaders' 40,000 cap) and 40
# objects a scene within the 204.8 x 102.4 m range
P18_CAVS, P18_POINTS, P18_OBJECTS = 3, 80000, 40
P18_TIMESTAMPS = {"train": 12, "validate": 2}
# the train CLI: 2 epochs of 6 steps (the 12 training frames at the yamls'
# batch of 2: an epoch long enough that its loader still runs beside the
# steps whose rate the CLI reports), the first 1 + 2 timed again by
# time_train
P18_EPOCHS, P18_STEPS = 2, 6
P18_FRAMES = 2  # timed eval frames after one warm-up, looped and streamed
# the card-vs-CPU step on the V2X-Real yaml cut to 1/64 of its area, one
# loader sample, on the training path (the host decoration, K2 and K2b):
# both steps take the CPU step's K2 rows and ReLU gates. A 1e-7 jitter of
# the decorated points does not survive the rows' bf16 rounding (its
# jittered CPU step moved no gradient past the encoder), so the jittered
# CPU step also jitters the canvas where the backbone takes it in fp32
P18_STEP_RANGE = [-12.8, -6.4, -15.0, 12.8, 6.4, 15.0]
P18_JITTER_MODULE = "branch_m1.backbone"
# the multi-class loss has no direction term: no loss term reaches the
# direction head
P18_NO_GRAD = ("heads.dir_head.",)
# the evaluated copies: the regression scaled down (boxes near their
# anchors, off the anchor grid, ROADMAP fault u), each anchor-class slot's
# own class score raised and the first ANCHOR_TOPK boxes into N1, so that
# the APs held are not all zeros (at 512 every V2X-Real AP was 0 at random
# weights; at 2,048, on the CPU, vehicles' AP30 2e-4 and OPV2V's 0.0165)
P18_REG_SCALE, P18_OWN_LOGIT = 0.02, 2.0
P18_EVAL_KERNELS = ("deform_conv3x3", "pillar_canvas", "warp_affine",
                    "nms_closure")
P18_TRAIN_KERNELS = ("deform_conv3x3", "pillar_canvas", "warp_affine",
                     "deform_conv3x3_bwd", "deform_conv3x3_bwd_dx",
                     "pillar_canvas_bwd", "warp_affine_bwd")
# V2X-Real's scenarios: a training one, a validation one and one of
# 2023-04-07, which eval mode vc leaves out
P18_V2XREAL_SCENES = {"train": ["2023-03-17-15-53-02_1_0"],
                      "validate": ["2023-03-23-16-37-20_1_0",
                                   "2023-04-07-15-01-07_1_0"]}
# every raw class name of the vocabulary and two that no class takes
P18_UNKNOWN = ("Tree", "TrafficCone")


def _write_binary_pcd(path, pts):
    """(N, 4) float32 points as a binary PCD (x y z intensity)."""
    n = len(pts)
    header = ("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
              "TYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.astype("<f4").tobytes())


def write_tree(root, layout, seed):
    """A scenario tree in a dataset's own layout (``layout``: "opv2v",
    binary .pcd; "v2xreal", KITTI .bin, CAV ids 1, 2 and -1 and objects of
    every class name plus unknown ones), from ``seed``: per split its
    scenarios (V2X-Real: P18_V2XREAL_SCENES), P18_CAVS CAVs within 30 m of
    the first, P18_TIMESTAMPS[split] timestamps, P18_OBJECTS objects within
    the range around the first CAV, moving 1 m a timestamp, and per CAV and
    timestamp a yaml (lidar_pose, vehicles) and P18_POINTS points in the
    CAV's frame, half on the objects, half on the ground within 100 m.
    Returns the number of files written."""
    import numpy as np
    import yaml
    from gencomm_tpu_torch.data.v2xreal import SUPER_CLASS_MAP
    from gencomm_tpu_torch.utils.transformation_utils import x_to_world

    rng = np.random.RandomState(seed)
    names = [n for ns in SUPER_CLASS_MAP.values() for n in ns] \
        + list(P18_UNKNOWN)
    sizes = {sup: s for sup, s in (("vehicle", (4.2, 1.8, 1.5)),
                                   ("pedestrian", (0.8, 0.6, 1.7)),
                                   ("truck", (8.0, 2.8, 3.0)))}
    sup_of = {n: sup for sup, ns in SUPER_CLASS_MAP.items() for n in ns}
    cav_ids = (["1", "2", "-1"] if layout == "v2xreal"
               else ["641", "650", "659"])[:P18_CAVS]
    files = 0
    for split, n_ts in P18_TIMESTAMPS.items():
        scenes = (P18_V2XREAL_SCENES[split] if layout == "v2xreal"
                  else [f"2021_08_2{3 if split == 'train' else 4}_scene"])
        for sc in scenes:
            ego = np.array([rng.uniform(-50, 50), rng.uniform(-50, 50), 1.9,
                            0.0, rng.uniform(-180, 180), 0.0])
            poses = [ego]
            for c in range(1, P18_CAVS):
                p = ego.copy()
                p[:2] += rng.uniform(-30, 30, 2) / np.sqrt(2)
                p[2] = 4.5 if cav_ids[c].startswith("-") else 1.9
                p[4] = rng.uniform(-180, 180)
                poses.append(p)
            # objects in the first CAV's frame, then in the world
            e2w = x_to_world(ego)
            loc = np.stack([rng.uniform(-95, 95, P18_OBJECTS),
                            rng.uniform(-48, 48, P18_OBJECTS),
                            np.zeros(P18_OBJECTS), np.ones(P18_OBJECTS)], 1)
            loc = (loc @ e2w.T)[:, :3]
            loc[:, 2] = 0.0
            yaw = rng.uniform(-180, 180, P18_OBJECTS)
            kinds = [names[i % len(names)] for i in range(P18_OBJECTS)]
            if layout == "opv2v":
                kinds = ["Car"] * P18_OBJECTS
            dims = np.array([sizes.get(sup_of.get(k), (0.6, 0.6, 1.2))
                             for k in kinds]) * rng.uniform(0.9, 1.1,
                                                            (P18_OBJECTS, 3))
            for t in range(n_ts):
                ts = f"{2 * t:06d}"
                heading = np.radians(yaw)
                at = loc + t * np.stack([np.cos(heading), np.sin(heading),
                                         np.zeros_like(heading)], 1)
                vehicles = {}
                for k in range(P18_OBJECTS):
                    obj = {"location": [float(v) for v in at[k]],
                           "angle": [0.0, float(yaw[k]), 0.0],
                           "center": [0.0, 0.0, float(dims[k, 2] / 2)],
                           "extent": [float(v) for v in dims[k] / 2]}
                    if layout == "v2xreal":
                        obj["obj_type"] = kinds[k]
                    vehicles[1000 + k] = obj
                for cav, pose in zip(cav_ids, poses):
                    pose_t = pose + np.array([0.5 * t, 0, 0, 0, 0, 0])
                    cav_dir = os.path.join(root, split, sc, cav)
                    os.makedirs(cav_dir, exist_ok=True)
                    with open(os.path.join(cav_dir, f"{ts}.yaml"), "w") as f:
                        yaml.safe_dump({"lidar_pose": [float(v)
                                                       for v in pose_t],
                                        "vehicles": vehicles}, f)
                    half = P18_POINTS // 2
                    which = rng.randint(0, P18_OBJECTS, half)
                    c, s = np.cos(heading[which]), np.sin(heading[which])
                    u = rng.uniform(-0.5, 0.5, (half, 3)) * dims[which]
                    on_obj = at[which] + np.stack(
                        [c * u[:, 0] - s * u[:, 1], s * u[:, 0] + c * u[:, 1],
                         u[:, 2] + dims[which, 2] / 2], 1)
                    r = 100 * np.sqrt(rng.uniform(0, 1, P18_POINTS - half))
                    a = rng.uniform(0, 2 * np.pi, P18_POINTS - half)
                    ground = np.stack([pose_t[0] + r * np.cos(a),
                                       pose_t[1] + r * np.sin(a),
                                       rng.normal(0, 0.05, len(r))], 1)
                    world = np.concatenate([on_obj, ground])
                    hom = np.concatenate([world, np.ones((len(world), 1))], 1)
                    local = (hom @ np.linalg.inv(x_to_world(pose_t)).T)[:, :3]
                    pts = np.concatenate(
                        [local, rng.uniform(0, 1, (len(local), 1))],
                        1).astype(np.float32)
                    if layout == "v2xreal":
                        pts.tofile(os.path.join(cav_dir, f"{ts}.bin"))
                    else:
                        _write_binary_pcd(os.path.join(cav_dir, f"{ts}.pcd"),
                                          pts)
                    files += 2
    return files


def p18_yaml(root, name, tree):
    """A copy of P18_YAMLS[name] with root_dir and validate_dir pointed at
    ``tree``; returns its path."""
    import yaml

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, P18_YAMLS[name])) as f:
        raw = yaml.safe_load(f)
    raw["root_dir"] = os.path.join(tree, "train")
    raw["validate_dir"] = os.path.join(tree, "validate")
    os.makedirs(os.path.join(root, name), exist_ok=True)
    path = os.path.join(root, name, f"{name}_m1_att.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def loader_seconds(name, hypes):
    """Phase 18 (a)-(c): every sample of a dataset's training and
    validation loaders, timed (the host data layer): s/sample, the points
    each keeps, the GT boxes and classes. V2X-Real's validation set must
    leave 2023-04-07 out, its GT hold every class and no unknown name."""
    import numpy as np
    from gencomm_tpu_torch.tools import train

    out = {}
    for split, is_train in (("train", True), ("validate", False)):
        ds = train.build_dataset(hypes, is_train, name)
        t0 = time.perf_counter()
        samples = [ds[i] for i in range(len(ds))]
        batch = ds.collate(samples)
        s = (time.perf_counter() - t0) / len(samples)
        kept = batch["point_mask_m1"].sum(-1)
        n_gt = batch["gt_mask"].sum(-1)
        log(f"phase 18: {name} {split} loader: {len(samples)} samples, "
            f"{s:.4f} s/sample (reading, labels, collate), points kept an "
            f"agent {kept.tolist()} (of {P18_POINTS}), GT boxes {n_gt.tolist()}"
            f", scenarios {list(ds.scenario_database)}")
        if not (kept.max() == min(P18_POINTS, ds.max_points)
                and n_gt.min() > 0):
            raise AssertionError(f"{name} {split}: points {kept}, GT {n_gt}")
        if name == "v2xreal":
            classes = set(batch["gt_classes"][batch["gt_mask"] > 0].tolist())
            log(f"phase 18: v2xreal {split} GT classes {sorted(classes)}, "
                f"labels {sorted(set(np.unique(batch['pos_equal_one']).tolist()))}")
            if classes != {1, 2, 3}:
                raise AssertionError(f"v2xreal {split}: GT classes {classes}")
            if not is_train and (len(ds) != P18_TIMESTAMPS["validate"] or any(
                    "2023-04-07" in sc for sc in ds.scenario_database)):
                raise AssertionError("v2xreal eval kept the 2023-04-07 "
                                     "scenario")
        out[split] = round(s, 4)
    return out


def p18_train_cli(root, name, path, tool):
    """Phase 18 (b), (c): the train CLI on a dataset's tree, P18_EPOCHS
    epochs of P18_STEPS steps on the card: every kernel of
    P18_TRAIN_KERNELS launched, every logged loss finite, the detection
    and generation terms among them. Returns the run dir and the CLI's own
    ms/step an epoch (its steps after the first, loading included)."""
    from gencomm_tpu_torch.tools import train

    run = os.path.join(root, name, "run")
    label = f"train {name}"
    tool(label, train.main, [
        "-y", path, "--model_dir", run, "--dataset", name, "--device",
        "cuda", "--epochs", str(P18_EPOCHS), "--steps_per_epoch",
        str(P18_STEPS), "--val_steps", "1"])
    missing = [k for k in P18_TRAIN_KERNELS if not tool.launches[label].get(k)]
    if missing:
        raise AssertionError(f"{label} launched none of {missing}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    terms = {k for r in recs for k in r}
    log(f"phase 18: {label}: logged {recs}")
    if not all(math.isfinite(v) for r in recs for v in r.values()) or not {
            "train/cls_loss", "train/reg_loss", "train/gen_loss",
            "val/total_loss"} <= terms:
        raise AssertionError(f"{label}: logged losses {recs}")
    return run, [r["train/ms_per_step"] for r in recs
                 if "train/ms_per_step" in r]


def p18_eval_copy(root, name, run):
    """A run dir of the trained run's config with seeded weights (seed 0),
    the heads' regression scaled by P18_REG_SCALE, each anchor-class slot's
    own class logit raised by P18_OWN_LOGIT and ANCHOR_TOPK boxes into N1:
    boxes near anchors of their class, so that APs are not all zeros at
    random weights."""
    from gencomm_tpu_torch.config.yaml_utils import save_yaml
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.train import checkpoint
    from gencomm_tpu_torch.weights import random_state_dict

    hypes = load_yaml(None, run)
    hypes["postprocess"]["nms_topk"] = ANCHOR_TOPK
    state = random_state_dict(create_model(hypes, device="cpu"), seed=0)
    state["heads.reg_head.weight"].mul_(P18_REG_SCALE)
    state["heads.reg_head.bias"].zero_()
    c = int(hypes["postprocess"].get("num_class", 1))
    bias = state["heads.cls_head.bias"].view(c, -1, c)
    for k in range(c):
        bias[k, :, k] += P18_OWN_LOGIT
    out = os.path.join(root, name, "eval_copy")
    os.makedirs(out, exist_ok=True)
    save_yaml(hypes, os.path.join(out, "config.yaml"))
    checkpoint.save_checkpoint(out, state, 0, epoch=0)
    return out


def p18_cli_eval(name, run, copy_dir, tool):
    """Phase 18 (b), (c): the inference CLI on the trained run (the card)
    and on the evaluated copy on the card and with --device cpu over the
    validation frames, each frame's diffusion noise drawn from the host
    generator with its seed: the copy's APs card = CPU within AP_TOL, its
    heads of every frame within CPU_TOL x max(1, max|cpu|), the same number
    of kept boxes. Returns the APs and the heads' error."""
    from gencomm_tpu_torch.models.gencomm.diffusion import GenCommDiffusion
    from gencomm_tpu_torch.pipeline import InferencePipeline
    from gencomm_tpu_torch.tools import inference

    real_draw, real_detect = GenCommDiffusion.draw_noises, \
        InferencePipeline._detect
    heads, dets, current = {}, {}, [None]

    def recorded_detect(self, out, batch):
        heads.setdefault(current[0], []).append(
            {k: out[k].float().cpu() for k in ("cls_preds", "reg_preds",
                                               "dir_preds")})
        d = real_detect(self, out, batch)
        dets.setdefault(current[0], []).append(d)
        return d

    GenCommDiffusion.draw_noises = host_noise_draw(real_draw)
    InferencePipeline._detect = recorded_detect
    aps = {}
    try:
        for label, d, dev in (("trained", run, "cuda"), ("copy", copy_dir,
                                                         "cuda"),
                              ("copy cpu", copy_dir, "cpu")):
            current[0] = label
            aps[label] = tool(f"inference {name} {label}", inference.main, [
                "--model_dir", d, "--dataset", name, "--frames",
                str(P18_TIMESTAMPS["validate"]), "--device", dev,
                "--infer_info", label.replace(" ", "_")])
    finally:
        GenCommDiffusion.draw_noises = real_draw
        InferencePipeline._detect = real_detect
    if not all(math.isfinite(v) for a in aps.values() for v in a.values()):
        raise AssertionError(f"{name}: APs {aps}")
    worst = 0.0
    for a, b in zip(heads["copy"], heads["copy cpu"]):
        for key in a:
            worst = max(worst, float((a[key] - b[key]).abs().max())
                        / max(1.0, float(b[key].abs().max())))
    kept = [(int(a.valid.sum()), int(b.valid.sum()))
            for a, b in zip(dets["copy"], dets["copy cpu"])]
    gaps = {k: abs(aps["copy"][k] - aps["copy cpu"][k]) for k in aps["copy"]}
    log(f"phase 18: {name} inference, the copy card vs CPU over "
        f"{len(heads['copy'])} frames: heads max |d| / max(1, max|cpu|) "
        f"{worst:.3e} (tol {CPU_TOL:.0e}), kept boxes a frame {kept}, APs "
        f"{aps['copy']} (CPU {aps['copy cpu']}; the trained run's "
        f"{aps['trained']}), the largest AP gap {max(gaps.values()):.2e} "
        f"(tol {AP_TOL:.0e})")
    if len(heads["copy"]) != P18_TIMESTAMPS["validate"] or not \
            worst <= CPU_TOL:
        raise AssertionError(f"{name}: card and CPU heads disagree ({worst})")
    if any(a != b for a, b in kept) or max(gaps.values()) > AP_TOL:
        raise AssertionError(f"{name}: card and CPU detections disagree "
                             f"({kept}, {gaps})")
    ap30 = [v for k, v in aps["copy"].items() if k.endswith("ap30")]
    if not max(ap30) > 0:
        raise AssertionError(f"{name}: every AP at IoU 0.3 is 0: {aps}")
    return {"aps": aps, "heads_err": worst, "kept": kept}


def phase18(root: str) -> dict:
    """Phase 18 in its own process, after phase 17's: the real-data loaders
    (OPV2V and V2X-Real) on trees written in their own layouts, V2X-Real's
    multi-class GenComm stage 1 and OPV2V's through the train and
    inference CLIs on the card; raises on any failed check and returns the
    numbers and the kernel rows (as [path, row] pairs). Every path is timed
    before the process's first profiler session (ROADMAP p1)."""
    import copy
    import shutil
    from types import SimpleNamespace

    import torch
    from gencomm_tpu_torch.data.postprocessor import (
        generate_anchor_box, generate_anchor_box_multiclass,
    )
    from gencomm_tpu_torch.loss import create_loss
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.models.encoders import point_pillar
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.ops import (
        _cuda, deform_conv, nms, pillar_canvas, warp,
    )
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.tools import inference, train
    from gencomm_tpu_torch.train import trainer
    from gencomm_tpu_torch.weights import random_state_dict

    if not torch.cuda.is_available():
        raise RuntimeError("phase 18 needs a CUDA device")
    t_all = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    tool, rows, out = _Tool("phase 18"), [], {}
    _cuda.build_all()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    # (a) the trees
    t0 = time.perf_counter()
    paths, hypes = {}, {}
    for seed, name in enumerate(P18_YAMLS):
        tree = os.path.join(root, f"{name}_tree")
        n = write_tree(tree, name, seed=18 + seed)
        paths[name] = p18_yaml(root, name, tree)
        hypes[name] = load_yaml(paths[name])
        log(f"phase 18: wrote the {name} tree ({n} files) in {tree}")
    phase_done("phase 18 trees", t0)
    out["loader_s_per_sample"] = {name: loader_seconds(name, hypes[name])
                                  for name in P18_YAMLS}

    # (b), (c): the train CLI on each tree
    runs, cli_ms = {}, {}
    for name in P18_YAMLS:
        runs[name], cli_ms[name] = p18_train_cli(root, name, paths[name],
                                                 tool)

    # each dataset's training cell on the CLI's first 1 + 2 batches and
    # eval cell on the first validation frame, as the inference CLI
    # prepares it (V2X-Real's with its multi-class anchors and decode),
    # timed; OPV2V's cells are the flagship's model on the loader's frames
    cells = {}
    for name in P18_YAMLS:
        run_hypes = load_yaml(None, runs[name])
        adapt = train.Adapt(run_hypes)
        ds = train.build_dataset(run_hypes, True, name)
        bs = run_hypes["train_params"]["batch_size"]
        hosts = [adapt(b) for b in itertools.islice(
            train.batches(ds, bs, 0, name), 3)]
        log(f"phase 18: {name}'s CLI batches: agent slots "
            f"{hosts[0]['agent_mask'].shape}, positive anchor slots "
            f"{[int((h['pos_equal_one'] > 0).sum()) for h in hosts]}")
        grid = _heads_grid_shape(run_hypes)
        tr = time_train(smi, dev, name, {"hypes": run_hypes}, run_hypes,
                        grid, hosts, P18_TRAIN_KERNELS, "decorated_m1",
                        build=_hypes_model)
        val = train.build_dataset(run_hypes, False, name)
        pp = run_hypes["postprocess"]
        anchors = (generate_anchor_box_multiclass(pp["anchor_args"],
                                                  pp.get("order", "hwl"))[0]
                   if name == "v2xreal" else generate_anchor_box(
                       pp["anchor_args"], pp.get("order", "hwl")))
        ev = setup_eval(dev, {"hypes": run_hypes}, grid,
                        SimpleNamespace(anchors=anchors),
                        adapt(val.collate([val[0]])), build=_hypes_model,
                        postprocess=pp)
        time_eval(smi, ev, name, P18_EVAL_KERNELS, frames=P18_FRAMES)
        ev.pipe.graphs.clear()  # check_eval captures the frame anew (p9)
        out[name] = {
            "looped_ms": round(ev.ms, 3),
            "streamed_ms": round(ev.stream_ms, 3),
            "eval_launches": {k: v for k, v in ev.launches.items() if v},
            "graph_launches": ev.stream_launches,
            "ms_per_step": round(tr.ms, 3),
            "cli_ms_per_step": cli_ms[name],
            "step_launches": {k: v for k, v in tr.launches.items() if v}}
        cells[name] = (run_hypes, grid, tr, ev)
    run_hypes, grid, tr, ev = cells.pop("v2xreal")
    del cells
    torch.cuda.empty_cache()
    # its card-vs-CPU step on the yaml cut to P18_STEP_RANGE, one sample
    cut = inference.override_range(copy.deepcopy(run_hypes), P18_STEP_RANGE)
    cut["train_params"]["batch_size"] = 1
    cut_ds = train.build_dataset(cut, True, "v2xreal")
    cut_host = train.Adapt(cut)(cut_ds.collate([cut_ds[0]]))
    cut_state = random_state_dict(create_model(cut, device="cpu"), seed=0)

    def fresh(device):
        model = create_model(cut, device=device)
        model.load_state_dict(cut_state)
        model.train()
        opt, sched = trainer.make_optimizer(cut, model.named_parameters(), 1)
        return model, trainer.make_train_step(model, create_loss(cut), opt,
                                              sched)

    gen = torch.Generator().manual_seed(3)
    noises = [torch.randn((cut_host["agent_mask"].size,)
                          + _heads_grid_shape(cut), generator=gen)
              for _ in range(3)]
    tr.cut = SimpleNamespace(
        label="v2xreal", dev=dev, hosts=[cut_host],
        batches=[batch_to_device(cut_host, dev)], jitter_key="decorated_m1",
        jitter_module=P18_JITTER_MODULE, noises=noises,
        noises_dev=[z.to(dev) for z in noises], fresh=fresh)
    log(f"phase 18: the card-vs-CPU step on the yaml cut to "
        f"{P18_STEP_RANGE}: agent slots {cut_host['agent_mask'].shape}, "
        f"{int((cut_host['pos_equal_one'] > 0).sum())} positive slots")

    # (d) the kernels on this path's arguments, N1 on the multi-class
    # top-512 overlap matrix; the profiles; card against CPU
    path = "v2xreal eval (phase 18)"
    ev_rows = check_eval(
        smi, ev, "v2xreal",
        [(point_pillar, "pillar_canvas"), (deform_conv, "deform_conv3x3"),
         (fusion, "warp_affine")],
        lambda inputs: [check_deform(inputs, "v2xreal eval"),
                        check_pillar(inputs, "v2xreal eval"),
                        check_warp(inputs, "v2xreal eval")])
    seen = record_calls([(nms, "nms_closure")],
                        lambda: ev.pipe.run(ev.batch, seed=0))
    overlap, valid = seen["nms_closure"]
    nms_row = check_nms(overlap, valid, "v2xreal eval", {})
    fill_launches([nms_row], ev.launches, ev.routes, path)
    rows += [(path, r) for r in ev_rows + [nms_row]]
    # ROADMAP p2's limits on this path's arguments
    vfe = run_hypes["model"]["args"]["m1"]["encoder_args"]["pillar_vfe"]
    limits = {"K2 channels (even)": int(vfe["num_filters"][-1]),
              "N1 K (<= 262,112)": int(valid.numel()),
              "K3 N and H (<= 65,535)": [int(ev.n), grid[0]]}
    log(f"phase 18: p2's limits on this path: {limits}")
    # (e) the training checks: K2, K1b, K2b and K3b on the train step's
    # arguments, the profile, the loss falling, the card-vs-CPU step on the
    # cut yaml taking the CPU step's K2 rows (so its pillar maxima) and
    # ReLU gates
    where = "v2xreal train step (phase 18)"
    train_rows = check_train(
        tr, [(point_pillar, "pillar_canvas"),
             (deform_conv, "deform_conv3x3_bwd"),
             (pillar_canvas, "pillar_canvas_bwd"), (warp, "warp_affine_bwd")],
        lambda inputs: [check_pillar(inputs, where),
                        check_deform_bwd(inputs, where),
                        check_pillar_bwd(inputs, where),
                        check_warp_bwd(inputs, where)],
        step_cell=tr.cut, same_choices=True, same_rows=True,
        no_grad=P18_NO_GRAD)
    rows += [(where, r) for r in train_rows]
    out["v2xreal"]["cut_step"] = tr.cut.step_gap
    out["v2xreal"].update(eval_busy_ms=round(ev.busy, 3),
                          step_busy_ms=round(tr.busy, 3), p2_limits=limits)
    del ev, tr
    torch.cuda.empty_cache()

    # (b), (c): the inference CLI, card against CPU
    for name in P18_YAMLS:
        out[name] = dict(out.get(name, {}), cli=p18_cli_eval(
            name, runs[name], p18_eval_copy(root, name, runs[name]), tool))
    out["walls"] = tool.walls
    out["rows"] = rows
    for name in P18_YAMLS:
        r = out[name]
        log(f"phase 18 {name}: looped {r['looped_ms']} ms/frame, streamed "
            f"{r['streamed_ms']} ms/frame, {r['ms_per_step']} ms/step on "
            f"loaded batches, the train CLI's {r['cli_ms_per_step']} ms/step "
            f"an epoch (loading included), loader "
            f"{out['loader_s_per_sample'][name]} s/sample on {smi}")
    phase_done("phase 18", t_all)
    return out


def run_phase18():
    """Phase 18 in its own process (``chip_smoke.py --phase18 DIR``), after
    phase 17's has ended; its output echoed, its last line (the phase's
    JSON) returned."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase18")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--phase18", root],
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines()[:-1]:
        log(f"  18| {line}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 18 failed:\n{proc.stderr[-6000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"phase 18: {json.dumps({k: v for k, v in result.items() if k != 'rows'})}")
    phase_done("phase 18 (its process)", t_phase)
    return result


def run_workflow():
    """Phases 11, 12 (c), 13 (c), 14 (c), 15 (b) and 16 in their own
    process (``chip_smoke.py --workflow DIR``); its last line is the
    phases' JSON, echoed here and returned."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "workflow")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--workflow", root],
                          capture_output=True, text=True, timeout=1000)
    for line in proc.stdout.splitlines()[:-1]:
        log(f"  | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the workflow phase failed:\n"
                             f"{proc.stderr[-6000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"workflow: {json.dumps(result)}")
    phase_done("two-stage workflow", t_phase)
    return result


def main() -> int:
    """All phases."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.decorate import decorate_modality
    from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
    from gencomm_tpu_torch.models.encoders import lss, point_pillar
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.native import PillarVoxelizer
    from gencomm_tpu_torch.ops import (
        _cuda, deform_conv, nms, pillar_canvas, splat, warp,
    )

    # phase 1: the card
    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; host: {len(os.sched_getaffinity(0))} "
        f"cores, torch's CPU threads {torch.get_num_threads()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"fp32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"matmul precision={torch.get_float32_matmul_precision()}")
    dev = torch.device("cuda")

    # phase 2: build
    build_s = _cuda.build_all()
    log(f"built {sorted(_cuda.SIGNATURES)} with nvcc in {build_s:.1f} s "
        f"into {_cuda.BUILD_DIR}")
    for name, text in sorted(_cuda.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    general_errs = {**check_deform_general(dev),
                    **check_pillar_bwd_general(dev),
                    **check_warp_bwd_general(dev),
                    **check_warp_general(dev)}

    # the frames and batches of every path, sampled (and decorated) on the
    # host
    scenes = SyntheticScenes(scenes_config())
    voxelizer = PillarVoxelizer(LIDAR_RANGE, VOXEL)
    t0 = time.perf_counter()
    host = decorate_modality(trim_agent_slots(
        scenes.sample(seed=0, batch_size=1), buckets=(2, 3, 5)), voxelizer)
    log(f"lidar frame: sampled, trimmed to {host['agent_mask'].shape[1]} "
        f"agents and decorated on the host in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    hosts = [decorate_modality(trim_agent_slots(
        scenes.sample(TRAIN_SEED * 10000 + i, TRAIN_BATCH), buckets=(2, 3, 5)),
        voxelizer) for i in range(1 + TIMED_STEPS)]
    log(f"lidar train batches: {len(hosts)} x {TRAIN_BATCH} samples, "
        f"{hosts[0]['agent_mask'].shape[1]} agent slots each, sampled, "
        f"labelled and decorated on the host in "
        f"{time.perf_counter() - t0:.3f} s; "
        f"{int(hosts[0]['pos_equal_one'].sum())} positive anchors in the first")
    # the camera sampler is configured as tools/train.py configures it for a
    # camera-labelled model: the vehicles spawn within d_max - 2 of the ego
    cam_cfg = SyntheticConfig(
        lidar_range=CAMERA_RANGE, max_cav=5, num_agents=2, num_vehicles=12,
        points_per_vehicle=300,
        modalities={"m1": {"sensor": "camera", "final_dim": CAMERA_DIM,
                           "ncam": CAMERA_NCAM}},
        max_spawn_radius=CAMERA_GRID["ddiscr"][1] - 2.0)
    cam_scenes = SyntheticScenes(cam_cfg)
    t0 = time.perf_counter()
    cam_host = trim_agent_slots(cam_scenes.sample(seed=0, batch_size=1),
                                buckets=(2, 3, 5))
    log(f"camera frame: sampled (images {cam_host['imgs_m1'].shape}) and "
        f"trimmed to {cam_host['agent_mask'].shape[1]} agents on the host in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    cam_hosts = [trim_agent_slots(
        cam_scenes.sample(TRAIN_SEED * 10000 + i, TRAIN_BATCH),
        buckets=(2, 3, 5)) for i in range(1 + TIMED_STEPS)]
    log(f"camera train batches: {len(cam_hosts)} x {TRAIN_BATCH} samples, "
        f"{cam_hosts[0]['agent_mask'].shape[1]} agent slots each, sampled and "
        f"labelled on the host in {time.perf_counter() - t0:.3f} s; "
        f"{int(cam_hosts[0]['pos_equal_one'].sum())} positive anchors in the "
        f"first")

    # every path timed first, before the process's first profiler session
    # (ROADMAP p1: a finished session left later launches slower); each
    # run sets every launch count to 0 before and reads them after
    lidar_kernels = ("deform_conv3x3", "pillar_canvas", "warp_affine",
                     "nms_closure")
    lidar_kernels16 = ("deform_conv3x3_bf16", "pillar_canvas",
                       "warp_affine_bf16", "nms_closure")
    camera_kernels = ("deform_conv3x3", "warp_affine", "splat_topk",
                      "nms_closure")
    camera_kernels16 = ("deform_conv3x3_bf16", "warp_affine_bf16",
                        "splat_topk", "nms_closure")
    lidar = setup_eval(dev, FLAGSHIP, FEATURE_SHAPE, scenes, host)
    time_eval(smi, lidar, "lidar", lidar_kernels)
    lidar16 = setup_eval(dev, FLAGSHIP, FEATURE_SHAPE, scenes, host,
                         half=True, state=lidar.state)
    time_eval(smi, lidar16, "lidar", lidar_kernels16)
    lidar_train = time_train(
        smi, dev, "lidar", FLAGSHIP, TRAIN_HYPES, FEATURE_SHAPE, hosts,
        ("deform_conv3x3", "pillar_canvas", "warp_affine",
         "deform_conv3x3_bwd", "deform_conv3x3_bwd_dx", "pillar_canvas_bwd",
         "warp_affine_bwd"), "decorated_m1")
    camera = setup_eval(dev, CAMERA, CAMERA_FEATURE_SHAPE, cam_scenes,
                        cam_host)
    time_eval(smi, camera, "camera", camera_kernels)
    camera16 = setup_eval(dev, CAMERA, CAMERA_FEATURE_SHAPE, cam_scenes,
                          cam_host, half=True, state=camera.state)
    time_eval(smi, camera16, "camera", camera_kernels16)
    camera_train = time_train(
        smi, dev, "camera", CAMERA, CAMERA_TRAIN_HYPES, CAMERA_FEATURE_SHAPE,
        cam_hosts,
        ("deform_conv3x3", "warp_affine", "splat_topk", "deform_conv3x3_bwd",
         "deform_conv3x3_bwd_dx", "warp_affine_bwd", "splat_topk_bwd"),
        "imgs_m1")
    # phases 12 and 13: the fusion family and the HEAL pyramid, timed with
    # the paths above
    fam = fusion_timed(smi, dev, scenes, host, hosts)
    pyr = pyramid_timed(smi, dev)
    # phase 14: SECOND, timed with the paths above
    sec = second_timed(smi, dev)
    # phase 15: the paper's heterogeneous baselines, timed with the paths
    # above and checked (no profiler session)
    baselines(smi, dev)
    for cell, label in ((lidar, "lidar fp32"), (lidar16, "lidar bf16"),
                        (camera, "camera fp32"), (camera16, "camera bf16"),
                        (fam.vx, "v2xvit fp32"), (fam.vx16, "v2xvit bf16"),
                        (pyr.eval, "pyramid fp32"), (sec.eval, "second fp32"),
                        (sec.eval16, "second bf16")):
        log(f"eval {label}: looped {cell.ms:.3f} ms/frame "
            f"({1000.0 / cell.ms:.2f} frames/s), streamed {cell.stream_ms:.3f}"
            f" ms/frame ({1000.0 / cell.stream_ms:.2f} frames/s) on {smi} "
            "(every path timed before the first profiler session)")

    # then each path's kernel checks, profiles and CPU comparisons
    kernel_rows = check_eval(
        smi, lidar, "lidar",
        [(point_pillar, "pillar_canvas"), (deform_conv, "deform_conv3x3"),
         (fusion, "warp_affine")],
        lambda inputs: [check_deform(inputs, "lidar eval"),
                        check_pillar(inputs, "lidar eval"),
                        check_warp(inputs, "lidar eval")], operators=True)
    # K1 and K3 take bf16 maps here: rows of their bf16 instantiations; K2
    # is held again on the bf16 PFN's rows (its canvas is bf16 at both
    # dtypes)
    add_rows(kernel_rows, "lidar eval bf16", check_eval(
        smi, lidar16, "lidar",
        [(point_pillar, "pillar_canvas"), (deform_conv, "deform_conv3x3"),
         (fusion, "warp_affine")],
        lambda inputs: [check_deform(inputs, "lidar eval bf16"),
                        check_pillar(inputs, "lidar eval bf16"),
                        check_warp(inputs, "lidar eval bf16")],
        fp32_cell=lidar))
    # N1 on the lidar eval frame's own overlap matrix (K = 512), on random
    # sets and chains, and on the late mode's unions; the late and no modes
    # and evaluate, card against CPU
    seen = record_calls([(nms, "nms_closure")],
                        lambda: lidar.pipe.run(lidar.batch, seed=0))
    nms_row = check_nms(*seen["nms_closure"], "lidar eval",
                        {**check_modes(dev, scenes, host), **nms_cases(dev)})
    nms_row["launches"] = lidar.launches["nms_closure"]
    kernel_rows.append(nms_row)
    add_rows(kernel_rows, "lidar train step", check_train(
        lidar_train,
        [(point_pillar, "pillar_canvas"), (deform_conv, "deform_conv3x3_bwd"),
         (pillar_canvas, "pillar_canvas_bwd"), (warp, "warp_affine_bwd")],
        lambda inputs: [check_pillar(inputs, "lidar train step"),
                        check_deform_bwd(inputs, "lidar train step"),
                        check_pillar_bwd(inputs, "lidar train step"),
                        check_warp_bwd(inputs, "lidar train step")],
        operators=True))
    # p8: the whole step the same bits twice, K1b's row carrying the counts
    k1b_row = next(r for r in kernel_rows if r["name"] == "deform_conv3x3_bwd")
    k1b_row["repeat_step"] = {"lidar": hold_repeat_step(lidar_train)}
    del lidar_train

    # K1 and K3 get (A, 64, 64, 128) maps here, not the lidar path's
    # (A, 64, 128, 128): they are held against their plain versions again
    add_rows(kernel_rows, "camera eval", check_eval(
        smi, camera, "camera",
        [(deform_conv, "deform_conv3x3"), (fusion, "warp_affine"),
         (lss, "splat_topk")],
        lambda inputs: [check_deform(inputs, "camera eval"),
                        check_warp(inputs, "camera eval"),
                        check_splat(inputs, "camera eval")]))
    add_rows(kernel_rows, "camera eval bf16", check_eval(
        smi, camera16, "camera",
        [(deform_conv, "deform_conv3x3"), (fusion, "warp_affine"),
         (lss, "splat_topk")],
        lambda inputs: [check_deform(inputs, "camera eval bf16"),
                        check_warp(inputs, "camera eval bf16")],
        fp32_cell=camera))

    def check_camera_train(inputs):
        # the forward kernels once more at the train step's shapes (4 agent
        # slots; logged, no rows of their own), then the backward kernels
        where = "camera train step"
        check_deform(inputs, where)
        check_warp(inputs, where)
        check_splat(inputs, where)
        return [check_deform_bwd(inputs, where), check_warp_bwd(inputs, where),
                check_splat_bwd(inputs)]

    add_rows(kernel_rows, "camera train step", check_train(
        camera_train,
        [(deform_conv, "deform_conv3x3"), (fusion, "warp_affine"),
         (lss, "splat_topk"), (deform_conv, "deform_conv3x3_bwd"),
         (warp, "warp_affine_bwd"), (splat, "splat_topk_bwd")],
        check_camera_train))
    k1b_row["repeat_step"]["camera"] = hold_repeat_step(camera_train)
    del camera_train

    fusion_checks(smi, fam, kernel_rows)
    del fam, hosts
    pyramid_checks(smi, pyr, kernel_rows)
    del pyr
    second_checks(smi, sec, kernel_rows)
    del sec

    general_cases = {"pillar_canvas_bwd": ("general_route", GENERAL_CANVAS),
                     "deform_conv3x3": ("general_route", GENERAL_SHAPE),
                     "deform_conv3x3_bwd": ("general_route", GENERAL_SHAPE),
                     "warp_affine_bwd": ("general_thetas", GENERAL_WARP_MAP),
                     "warp_affine": ("general_routes", GENERAL_WARP_MAP)}
    for row in kernel_rows:
        if row["name"] in general_errs:
            key, shape = general_cases[row["name"]]
            row[key] = {"shape": list(shape),
                        "max_abs_err": general_errs[row["name"]]}
    run_bench()
    torch.cuda.empty_cache()
    # phase 16's K3 and K3b on noisy thetas come back from the workflow's
    # process, phase 17's kernel rows from its own, which starts after the
    # workflow's has ended
    add_rows(kernel_rows, "noisy eval (phase 16)",
             run_workflow()["robustness_rows"])
    for path, row in run_phase17()["rows"]:
        add_rows(kernel_rows, path, [row])
    # phase 18's rows from its own process, after phase 17's
    for path, row in run_phase18()["rows"]:
        add_rows(kernel_rows, path, [row])
    return finish(smi, t_all, kernel_rows)


def finish(smi, t_all, kernel_rows) -> int:
    """The run's last lines: the card, the kernels' numbers, the result."""
    import torch

    phase_done("all phases", t_all)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    # a crash in native code (the profiler, a CUDA call) prints every
    # thread's Python stack to stderr before the process dies
    import faulthandler

    faulthandler.enable()
    if sys.argv[1:2] == ["--workflow"]:
        print(json.dumps(workflow(sys.argv[2])), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == ["--phase17"]:
        print(json.dumps(phase17(sys.argv[2])), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == ["--phase18"]:
        print(json.dumps(phase18(sys.argv[2])), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == ["--baseline-workflow"]:
        # phase 15 (b) alone
        import torch
        from gencomm_tpu_torch.ops import _cuda

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            sys.exit(1)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        _cuda.build_all()
        print(json.dumps(baseline_workflow(sys.argv[2])), flush=True)
        sys.exit(0)
    sys.exit(main())
