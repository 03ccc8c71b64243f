"""Detection evaluation: greedy TP/FP matching + VOC-2010 AP.

Counterpart of ``gencomm_tpu/utils/eval_utils.py``, copied whole: host-side
numpy, so the port keeps its own copy. Parity: opencood/utils/eval_utils.py:
  caluclate_tp_fp   :207-261 (score-descending greedy polygon-IoU matching,
                              matched GT removed from the pool)
  calculate_ap/voc_ap :171-204, :264-318 (VOC-2010 all-points AP)
  eval_final_results :321-347 (both global-sort and per-frame variants)

Polygon IoU uses an exact Sutherland-Hodgman convex clip (the reference
uses shapely; results agree for convex quads).
"""

from __future__ import annotations

import numpy as np


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip convex ``subject`` by convex CCW ``clip``."""
    output = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        inp = output
        output = []
        if not inp:
            break

        def inside(p):
            return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= 0

        def intersect(p, q):
            dc = a - b
            dp = p - q
            n1 = a[0] * b[1] - a[1] * b[0]
            n2 = p[0] * q[1] - p[1] * q[0]
            n3 = dc[0] * dp[1] - dc[1] * dp[0]
            return np.array(
                [(n1 * dp[0] - n2 * dc[0]) / n3, (n1 * dp[1] - n2 * dc[1]) / n3]
            )

        s = inp[-1]
        for e in inp:
            if inside(e):
                if not inside(s):
                    output.append(intersect(s, e))
                output.append(e)
            elif inside(s):
                output.append(intersect(s, e))
            s = e
    return np.array(output) if output else np.zeros((0, 2))


def _area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _ccw(poly: np.ndarray) -> np.ndarray:
    x, y = poly[:, 0], poly[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return poly if signed >= 0 else poly[::-1]


def polygon_iou(quad_a: np.ndarray, quads_b: np.ndarray) -> np.ndarray:
    """IoU of one quad (4, 2) against many (M, 4, 2). A quad whose bounding
    box lies apart from ``quad_a``'s shares no area with it: its IoU stays
    0 without the clip."""
    a = _ccw(np.asarray(quad_a, np.float64))
    quads_b = np.asarray(quads_b, np.float64)
    ious = np.zeros(len(quads_b))
    if not len(quads_b):
        return ious
    area_a = _area(a)
    near = np.all((quads_b.min(axis=1) <= a.max(axis=0))
                  & (quads_b.max(axis=1) >= a.min(axis=0)), axis=1)
    for i in np.flatnonzero(near):
        b = _ccw(quads_b[i])
        inter = _area(_clip_polygon(a, b))
        union = area_a + _area(b) - inter
        ious[i] = inter / union if union > 0 else 0.0
    return ious


def new_result_stat(iou_thresholds=(0.3, 0.5, 0.7)) -> dict:
    return {t: {"tp": [], "fp": [], "gt": 0, "score": []} for t in iou_thresholds}


def calculate_tp_fp(det_corners, det_score, gt_corners, result_stat: dict,
                    iou_thresh: float) -> None:
    """Accumulate per-frame TP/FP (corners: (N, 8, 3) or (N, 4, 2))."""
    stat = result_stat[iou_thresh]
    stat["gt"] += len(gt_corners)
    if det_corners is None or len(det_corners) == 0:
        return
    det_corners = np.asarray(det_corners)
    det_score = np.asarray(det_score)
    if det_corners.ndim == 3 and det_corners.shape[1] == 8:
        det_quads = det_corners[:, :4, :2]
    else:
        det_quads = det_corners
    gt = np.asarray(gt_corners)
    gt_quads = list(gt[:, :4, :2] if gt.ndim == 3 and gt.shape[1] == 8 else gt)

    order = np.argsort(-det_score)
    fp, tp = [], []
    for i in order:
        if len(gt_quads):
            ious = polygon_iou(det_quads[i], np.asarray(gt_quads))
        else:
            ious = np.array([])
        if len(ious) == 0 or ious.max() < iou_thresh:
            fp.append(1)
            tp.append(0)
            continue
        fp.append(0)
        tp.append(1)
        gt_quads.pop(int(np.argmax(ious)))
    stat["score"] += det_score[order].tolist()
    stat["fp"] += fp
    stat["tp"] += tp


def voc_ap(rec: list, prec: list):
    rec = [0.0] + list(rec) + [1.0]
    prec = [0.0] + list(prec) + [0.0]
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    idx = [i for i in range(1, len(rec)) if rec[i] != rec[i - 1]]
    ap = sum((rec[i] - rec[i - 1]) * prec[i] for i in idx)
    return ap, rec, prec


def calculate_ap(result_stat: dict, iou_thresh: float,
                 global_sort_detections: bool):
    stat = result_stat[iou_thresh]
    fp, tp = list(stat["fp"]), list(stat["tp"])
    if global_sort_detections:
        score = np.array(stat["score"])
        order = np.argsort(-score)
        fp = list(np.array(fp)[order])
        tp = list(np.array(tp)[order])
    gt_total = stat["gt"]
    fp_cum = np.cumsum(fp)
    tp_cum = np.cumsum(tp)
    if gt_total == 0 or len(tp) == 0:
        return 0.0
    rec = (tp_cum / gt_total).tolist()
    prec = (tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)).tolist()
    ap, _, _ = voc_ap(rec, prec)
    return ap


def eval_final_results(result_stat: dict, global_sort_detections: bool = False):
    """Returns {ap30, ap50, ap70}."""
    return {
        "ap30": calculate_ap(result_stat, 0.3, global_sort_detections),
        "ap50": calculate_ap(result_stat, 0.5, global_sort_detections),
        "ap70": calculate_ap(result_stat, 0.7, global_sort_detections),
    }


def new_multiclass_stat(class_names, iou_thresholds=(0.3, 0.5, 0.7)):
    """Per-class accumulators (reference eval_utils.py:349-383 v2xreal
    multiclass mAP)."""
    return {c: new_result_stat(iou_thresholds) for c in class_names}


def eval_multiclass_results(stats: dict,
                            global_sort_detections: bool = False):
    """Per-class AP + mAP across classes."""
    out = {}
    for cls, stat in stats.items():
        out[cls] = eval_final_results(stat, global_sort_detections)
    for t in ("ap30", "ap50", "ap70"):
        vals = [out[c][t] for c in stats]
        out[f"m{t}"] = float(np.mean(vals)) if vals else 0.0
    return out
