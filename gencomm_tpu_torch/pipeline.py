"""Inference pipeline: model forward -> decode -> rotated NMS.

Counterpart of ``gencomm_tpu/pipeline.py`` (``InferencePipeline`` in
``intermediate`` mode): the fused heads are decoded per sample on the
device. Runs under ``torch.inference_mode()``. A ``half`` model runs
unchanged: its heads are fp32, so decode and NMS run in fp32 either way.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.data.postprocessor import Detections, decode_and_nms


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy arrays / tensors -> tensors on ``device``; raw points are left
    out (the model takes the host-decorated fields)."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               device=device)
            for k, v in batch.items()
            if not k.startswith(("points_", "point_mask_"))}


class InferencePipeline:
    def __init__(self, model, anchors: np.ndarray,
                 postprocess_cfg: Dict[str, Any], mode: str = "intermediate",
                 device=None):
        if mode != "intermediate":
            raise NotImplementedError(f"{mode!r} fusion inference is not "
                                      "ported yet")
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, pipeline on "
                             f"{self.device}")
        self.model = model
        self.anchors = torch.as_tensor(anchors, dtype=torch.float32,
                                       device=self.device)
        pp = postprocess_cfg
        self.gt_range = tuple(pp["gt_range"])
        self.score_threshold = pp["target_args"]["score_threshold"]
        self.nms_thresh = pp["nms_thresh"]
        self.dir_offset = pp["dir_args"]["dir_offset"]
        self.num_bins = pp["dir_args"]["num_bins"]
        self.topk = pp.get("nms_topk", 512)
        self._eye = torch.eye(4, device=self.device)

    def run(self, batch: Dict[str, Any], seed: int = 0,
            noises=None) -> Detections:
        """Detections stacked over the batch: corners3d (B, K, 8, 3),
        boxes7 (B, K, 7), scores (B, K), valid (B, K). The diffusion noise
        comes from ``noises`` or else a generator seeded with ``seed``."""
        with torch.inference_mode():
            batch = batch_to_device(batch, self.device)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            out = self.model(batch, noises=noises, generator=gen)
            dets = [
                decode_and_nms(c, r, d, self.anchors, self._eye, self.gt_range,
                               score_threshold=self.score_threshold,
                               nms_thresh=self.nms_thresh, topk=self.topk,
                               dir_offset=self.dir_offset,
                               num_bins=self.num_bins)
                for c, r, d in zip(out["cls_preds"], out["reg_preds"],
                                   out["dir_preds"])]
            return Detections(*(torch.stack(f) for f in zip(*dets)))
