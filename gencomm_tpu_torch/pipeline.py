"""Inference pipeline: model forward -> decode -> rotated NMS -> AP.

Counterpart of ``gencomm_tpu/pipeline.py`` (``InferencePipeline``) in its
three modes: ``intermediate`` decodes the fused heads; ``no`` decodes the
ego's own heads (``supervise_single``); ``late`` decodes every agent's own
heads in its frame, projects the boxes into the ego frame through
``pairwise_t_matrix[:, j, 0]``, masks the absent agents and runs one rotated
NMS over the union, keeping the first ``min(topk, L * K)``. ``run`` takes
one batch, ``run_stream`` a stack of frames, ``evaluate`` gives AP on
synthetic scenes. A multi-class model (the postprocess block's
``num_class`` > 1, V2X-Real) is decoded in ``intermediate`` mode by
``decode_and_nms_multiclass`` from per-class anchors (C, H', W', A, 7),
its detections carrying ``labels``. Everything runs under
``torch.inference_mode()``. A
``half`` model runs unchanged: its heads are fp32, so decode and NMS run in
fp32 either way.

On a CUDA tensor a frame (forward, decode, NMS) reads nothing back to the
host, so ``run_stream`` captures one frame in a CUDA graph
(``torch.cuda.graphs``), once per frame shape, and replays it per frame:
the counterpart of the JAX package's single ``lax.scan`` dispatch. The
diffusion noise is drawn outside the graph: per frame, the pipeline's
generator, seeded with the frame's seed, draws what ``run(frame, seed)``
draws (``GenCommDiffusion.draw_noises``), and the draws are copied into the
graph's static noise buffers, as the frame's fields are copied into its
static inputs; a replay does no other host work. A capture that fails
raises; nothing falls back to eager launches.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.data.decorate import decorate_modality
from gencomm_tpu_torch.data.postprocessor import (
    Detections, decode_and_nms, decode_and_nms_multiclass,
    decode_pixor_and_nms, stack_detections,
)
from gencomm_tpu_torch.native import PillarVoxelizer
from gencomm_tpu_torch.ops import _cuda
from gencomm_tpu_torch.ops.nms import rotated_nms
from gencomm_tpu_torch.utils import eval_utils

MODES = ("intermediate", "late", "no")


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy arrays / tensors -> tensors on ``device``. The host decoration
    has already replaced a pillar modality's raw points; a SECOND
    modality's are kept for its encoder."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               device=device)
            for k, v in batch.items()}


class FrameGraph:
    """One frame captured in a CUDA graph: its static inputs and noise
    buffers, the detections it writes, the kernel launches it holds (the
    wrappers' counts while it was captured; a replay runs them again without
    counting) and the number of replays."""

    def __init__(self, graph, inputs, noises, dets, launches):
        self.graph, self.inputs, self.noises = graph, inputs, noises
        self.dets, self.launches, self.replays = dets, launches, 0


class InferencePipeline:
    def __init__(self, model, anchors: np.ndarray,
                 postprocess_cfg: Dict[str, Any], mode: str = "intermediate",
                 device=None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, pipeline on "
                             f"{self.device}")
        if mode != "intermediate" and model.heads_single is None:
            raise ValueError(f"{mode!r} inference decodes each agent's own "
                             "heads: build the model with supervise_single")
        pp = postprocess_cfg
        self.num_class = int(pp.get("num_class", 1))
        if self.num_class > 1 and (mode != "intermediate"
                                   or np.ndim(anchors) != 5):
            raise ValueError(
                "a multi-class model is decoded in 'intermediate' mode from "
                "per-class anchors (C, H', W', A, 7); got mode "
                f"{mode!r} and anchors of shape {np.shape(anchors)}")
        self.model, self.mode = model, mode
        self.anchors = torch.as_tensor(anchors, dtype=torch.float32,
                                       device=self.device)
        self.gt_range = tuple(pp["gt_range"])
        self.score_threshold = pp["target_args"]["score_threshold"]
        self.nms_thresh = pp["nms_thresh"]
        self.dir_offset = pp["dir_args"]["dir_offset"]
        self.num_bins = pp["dir_args"]["num_bins"]
        self.topk = pp.get("nms_topk", 512)
        self._eye = torch.eye(4, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._voxelizers: Dict[str, PillarVoxelizer] = {}
        self.graphs: Dict[Any, FrameGraph] = {}  # frame signature -> capture

    def _decode(self, c, r, d, tfm) -> Detections:
        if self.num_class > 1:
            return decode_and_nms_multiclass(
                c, r, self.anchors, tfm, self.gt_range,
                score_threshold=self.score_threshold,
                nms_thresh=self.nms_thresh, topk=self.topk)
        return decode_and_nms(c, r, d, self.anchors, tfm, self.gt_range,
                              score_threshold=self.score_threshold,
                              nms_thresh=self.nms_thresh, topk=self.topk,
                              dir_offset=self.dir_offset,
                              num_bins=self.num_bins)

    def _decode_pixor(self, c, r) -> Detections:
        return decode_pixor_and_nms(
            c, r, self.anchors, self._eye, self.gt_range,
            self.model.lidar_range, self.model.decode_cell,
            score_threshold=self.score_threshold, nms_thresh=self.nms_thresh,
            topk=self.topk)

    def _late(self, cls_a, reg_a, dir_a, pairwise, amask) -> Detections:
        """One sample's late fusion: each agent j decoded through
        T[j -> 0], absent agents masked, one NMS over the union."""
        per = [self._decode(c, r, d, pairwise[j, 0])
               for j, (c, r, d) in enumerate(zip(cls_a, reg_a, dir_a))]
        corners = torch.cat([p.corners3d for p in per])
        boxes7 = torch.cat([p.boxes7 for p in per])
        scores = torch.cat([p.scores for p in per])
        valid = torch.cat([p.valid & amask[j] for j, p in enumerate(per)])
        order, keep = rotated_nms(corners[:, :4, :2], scores, valid,
                                  self.nms_thresh)
        kq = min(self.topk, corners.shape[0])
        order = order[:kq]
        # a multi-class model is decoded in intermediate mode only
        return Detections(corners[order], boxes7[order], scores[order],
                          keep[:kq], torch.ones_like(keep[:kq],
                                                     dtype=torch.long))

    def _detect(self, out, batch) -> Detections:
        """The model's output -> detections stacked over the batch."""
        if self.mode == "intermediate" and hasattr(self.model, "decode_cell"):
            dets = [self._decode_pixor(c, r) for c, r in zip(
                out["cls_preds"], out["reg_preds"])]
        elif self.mode == "intermediate":
            # the legacy SECOND detectors have no direction head
            dirs = out.get("dir_preds")
            dets = [self._decode(c, r, d, self._eye) for c, r, d in zip(
                out["cls_preds"], out["reg_preds"],
                dirs if dirs is not None else [None] * len(out["cls_preds"]))]
        else:
            b, l = batch["agent_mask"].shape
            single = [out[f"{k}_preds_single"].reshape(
                (b, l) + out[f"{k}_preds_single"].shape[1:])
                for k in ("cls", "reg", "dir")]
            if self.mode == "no":
                dets = [self._decode(c[0], r[0], d[0], self._eye)
                        for c, r, d in zip(*single)]
            else:
                dets = [self._late(*a) for a in zip(
                    *single, batch["pairwise_t_matrix"].to(torch.float32),
                    batch["agent_mask"].bool())]
        return stack_detections(dets)

    def _frame(self, batch, noises=None, generator=None) -> Detections:
        return self._detect(self.model(batch, noises=noises,
                                       generator=generator), batch)

    def _seeded(self, seed: int) -> torch.Generator:
        return self._gen.manual_seed(int(seed))

    def run(self, batch: Dict[str, Any], seed: int = 0,
            noises=None) -> Detections:
        """Detections stacked over the batch: corners3d (B, K, 8, 3),
        boxes7 (B, K, 7), scores (B, K), valid (B, K). The diffusion noise
        comes from ``noises`` or else the pipeline's generator seeded with
        ``seed``."""
        with torch.inference_mode():
            batch = batch_to_device(batch, self.device)
            return self._frame(batch, noises,
                               None if noises is not None else self._seeded(seed))

    def _capture(self, frame: Dict[str, torch.Tensor]) -> FrameGraph:
        """Capture one frame of this shape. A warm-up frame on a side stream
        first builds and loads the kernels, sets their attributes and fills
        the caches that a capture must not touch."""
        inputs = {k: v.clone() for k, v in frame.items()}
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.model(inputs, generator=self._seeded(0))
            self._detect(out, inputs)
            noises = None
            if self.model.use_gencomm:
                shape = out["pred_feature"].shape
                noises = [torch.zeros(shape, dtype=torch.float32,
                                      device=self.device)
                          for _ in range(self.model.gencomm.num_timesteps)]
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = dict(_cuda.LAUNCHES)
        with torch.cuda.graph(graph):
            dets = self._frame(inputs, noises=noises)
        launches = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                    if v != before[k]}
        return FrameGraph(graph, inputs, noises, dets, launches)

    def run_stream(self, frames: Dict[str, Any],
                   seeds: Sequence[int]) -> Detections:
        """frames: the batch's fields stacked on a leading frame axis (numpy
        arrays or tensors); seeds: one diffusion seed per frame. Returns
        Detections stacked per frame, (F, B, K, ...), equal to
        ``run(frame_f, seed=seeds[f])`` frame by frame. On a CUDA pipeline
        the frame is captured once per frame shape (``graphs``) and
        replayed; on the CPU, a loop over ``run``."""
        seeds = [int(s) for s in seeds]
        with torch.inference_mode():
            frames = batch_to_device(frames, self.device)
            for k, v in frames.items():
                if v.shape[0] != len(seeds):
                    raise ValueError(f"{k} holds {v.shape[0]} frames, "
                                     f"{len(seeds)} seeds given")
            if self.device.type != "cuda":
                dets = [self.run({k: v[f] for k, v in frames.items()}, seed=s)
                        for f, s in enumerate(seeds)]
                return stack_detections(dets)
            key = tuple(sorted((k, tuple(v.shape[1:]), v.dtype)
                               for k, v in frames.items()))
            fg = self.graphs.get(key)
            if fg is None:
                fg = self.graphs[key] = self._capture(
                    {k: v[0] for k, v in frames.items()})
            stacked = [torch.empty((len(seeds),) + t.shape, dtype=t.dtype,
                                   device=t.device) for t in fg.dets]
            for f, s in enumerate(seeds):
                for k, buf in fg.inputs.items():
                    buf.copy_(frames[k][f])
                if fg.noises is not None:
                    draws = self.model.gencomm.draw_noises(
                        fg.noises[0].shape, self._seeded(s), self.device)
                    for buf, z in zip(fg.noises, draws):
                        buf.copy_(z)
                fg.graph.replay()
                fg.replays += 1
                for out, t in zip(stacked, fg.dets):
                    out[f].copy_(t)
            return Detections(*stacked)

    def decorate(self, host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A sampled batch with every pillar modality's raw points replaced
        by the host decoration on its encoder's grid (data/decorate.py); a
        SECOND modality keeps its raw points."""
        for m in self.model.modalities:
            if f"points_{m}" not in host:
                continue
            vox = self._voxelizers.get(m)
            if vox is None:
                enc = self.model.lidar_encoder(m)
                if enc.takes_raw_points:
                    continue
                vox = self._voxelizers[m] = PillarVoxelizer(enc.lidar_range,
                                                            enc.voxel_size)
            host = decorate_modality(host, vox, m)
        return host

    def evaluate(self, scenes, n_frames: int = 10, batch_size: int = 1,
                 seed0: int = 100) -> Dict[str, float]:
        """AP at IoU 0.3 / 0.5 / 0.7 over ``n_frames`` synthetic frames
        (``scenes.sample(seed0 + f, batch_size)``, decorated on the host,
        diffusion seed ``f``) against ``scenes.gt_corners``; per-frame
        ordering (``eval_utils.eval_final_results``)."""
        stat = eval_utils.new_result_stat()
        for f in range(n_frames):
            host = scenes.sample(seed0 + f, batch_size)
            dets = self.run(self.decorate(host), seed=f)
            valid = dets.valid.cpu().numpy()
            corners, scores = dets.corners3d.cpu().numpy(), dets.scores.cpu().numpy()
            for b in range(batch_size):
                gt = scenes.gt_corners(host, b)
                for t in (0.3, 0.5, 0.7):
                    eval_utils.calculate_tp_fp(corners[b][valid[b]],
                                               scores[b][valid[b]], gt, stat, t)
        return eval_utils.eval_final_results(stat)
