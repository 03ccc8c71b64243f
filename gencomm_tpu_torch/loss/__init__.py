"""Losses of the port (counterpart of ``gencomm_tpu/loss``)."""

from __future__ import annotations

from gencomm_tpu_torch.loss.point_pillar_loss import (
    PointPillarGenCommLoss,
    PointPillarLoss,
)
from gencomm_tpu_torch.loss.pyramid_loss import PointPillarDepthLoss

LOSSES = {
    "point_pillar_loss": PointPillarLoss,
    "point_pillar_gencomm_loss": PointPillarGenCommLoss,
    "point_pillar_depth_loss": PointPillarDepthLoss,
}


def build_loss(loss_hypes: dict):
    """The criterion named by the hypes ``loss`` block's ``core_method``,
    built from its ``args``."""
    name = loss_hypes["core_method"]
    if name not in LOSSES:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet; ported: {sorted(LOSSES)}")
    return LOSSES[name](dict(loss_hypes["args"]))
