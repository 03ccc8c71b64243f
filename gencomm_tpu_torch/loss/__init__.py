"""Losses of the port (counterpart of ``gencomm_tpu/loss``)."""

from __future__ import annotations

from gencomm_tpu_torch.loss.point_pillar_loss import (
    AdapterLoss,
    PointPillarCodebookLoss,
    PointPillarDiscoNetLoss,
    PointPillarGenCommLoss,
    PointPillarLoss,
    PointPillarMPDALoss,
)
from gencomm_tpu_torch.loss.pyramid_loss import (
    PointPillarDepthLoss,
    PointPillarPyramidLoss,
)
from gencomm_tpu_torch.registry import LOSSES

LOSSES.register("point_pillar_loss", PointPillarLoss)
LOSSES.register("point_pillar_gencomm_loss", PointPillarGenCommLoss)
LOSSES.register("point_pillar_disconet_loss", PointPillarDiscoNetLoss)
LOSSES.register("point_pillar_depth_loss", PointPillarDepthLoss)
LOSSES.register("point_pillar_pyramid_loss", PointPillarPyramidLoss)
LOSSES.register("point_pillar_codebook_loss", PointPillarCodebookLoss)
LOSSES.register("point_pillar_mpda_loss", PointPillarMPDALoss)
LOSSES.register("adapter_loss", AdapterLoss)


def build_loss(loss_hypes: dict):
    """The criterion named by the hypes ``loss`` block's ``core_method``,
    built from its ``args``."""
    name = loss_hypes["core_method"]
    if name not in LOSSES:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet; ported: {LOSSES.names()}")
    return LOSSES.get(name)(dict(loss_hypes["args"]))


def create_loss(hypes: dict):
    """The criterion of a hypes dict, as ``gencomm_tpu/loss/__init__.py:
    create_loss`` builds it: the pyramid mode tag from the model's
    ``core_method``, the model's lidar range and, for the IoU-rescore
    losses, the anchor grid are injected into the loss arguments. With
    ``model.args.supervise_single`` the criterion is wrapped: where the
    output has per-agent heads (``cls_preds_single``) and the target
    per-agent labels (``pos_equal_one_single``), a second pass with the
    suffix "_single" against those labels, their (B, L) lead flattened,
    adds its terms as ``single_<term>`` and its total to ``total_loss``."""
    args = dict(hypes["loss"]["args"])
    core = hypes.get("model", {}).get("core_method", "").lower()
    if "pyramid" in args and isinstance(args["pyramid"], dict):
        args["pyramid"] = dict(args["pyramid"])
        args["pyramid"].setdefault("mode",
                                   "collab" if "collab" in core else "single")
    mr = hypes.get("model", {}).get("args", {}).get("lidar_range")
    if mr is not None:
        args.setdefault("lidar_range", mr)
    if ("iou" in args or "stage1" in args) and "_anchors" not in args \
            and "anchor_args" in hypes.get("postprocess", {}):
        from gencomm_tpu_torch.data.postprocessor import generate_anchor_box

        anchors = generate_anchor_box(hypes["postprocess"]["anchor_args"])
        args["_anchors"] = anchors
        if isinstance(args.get("stage1"), dict):
            args["stage1"] = dict(args["stage1"], _anchors=anchors)
    criterion = build_loss({"core_method": hypes["loss"]["core_method"],
                            "args": args})
    if not hypes.get("model", {}).get("args", {}).get("supervise_single"):
        return criterion
    base = criterion

    def with_single(output, target, suffix=""):
        losses = base(output, target, suffix)
        if "cls_preds_single" in output and "pos_equal_one_single" in target:
            tgt = {k[:-len("_single")]: v.reshape((-1,) + tuple(v.shape[2:]))
                   for k, v in target.items() if k.endswith("_single")}
            single = base(output, tgt, suffix="_single")
            for k, v in single.items():
                if k != "total_loss":
                    losses[f"single_{k}"] = v
            losses["total_loss"] = losses["total_loss"] + single["total_loss"]
        return losses

    return with_single
