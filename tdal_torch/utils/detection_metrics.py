"""Self-contained 3D detection AP / APH evaluation (no Waymo devkit required).

A copy of ``tdal/utils/detection_metrics.py``, numpy throughout except for the IoU
matrices, which come from the port's ``tdal_torch.core.iou`` on the CPU in f32 (tdal's
come from its native C++ op or its JAX IoU; the same edge-integral clipping).

- per-class Average Precision at 3D IoU thresholds (0.7 vehicle, 0.5 ped/cyclist),
- APH (AP weighted by heading accuracy, the Waymo mAPH metric shape).

Caveat (hence the ``_l2approx`` summary-key tag): Waymo's L1/L2 difficulty split needs
num_points AND the labeler-assigned LEVEL_2 tag from the source protos, which the
per-frame anno pickles don't carry, so this evaluator scores ALL objects together
(closest to the devkit's L2 cumulative split, which also includes every box). Treat
absolute numbers as a tracking metric; devkit scoring is the acceptance path.

Matching is greedy by descending score against unmatched GTs with max IoU (the
standard AP protocol).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from tdal_torch.core.iou import boxes_iou_3d, boxes_iou_bev
from tdal_torch.data.waymo_schema import AnnoStore, box7_from_box9

DEFAULT_IOU_THRESH = {"VEHICLE": 0.7, "PEDESTRIAN": 0.5, "CYCLIST": 0.5}
CLASS_NAMES = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]


def _t(boxes: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(boxes, np.float32))


def _iou_matrix(det_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(det_boxes), len(gt_boxes)))
    return boxes_iou_3d(_t(det_boxes), _t(gt_boxes)).numpy().astype(np.float64)


def _average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """All-point interpolated AP."""
    r = np.concatenate([[0.0], recalls, [1.0]])
    p = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def evaluate_detection(
    detections: Dict[str, dict],
    ground_truths: Dict[str, dict],
    iou_thresholds: Dict[str, float] = None,
    class_names: Sequence[str] = CLASS_NAMES,
) -> Dict[str, float]:
    """detections: token -> {'boxes' (K, 7) geometric lidar convention, 'scores',
    'labels' (0-based)}. ground_truths: token -> {'boxes' (G, 7), 'labels' (0-based),
    'num_points' (G,)}. Returns {'{CLS}_AP', '{CLS}_APH', 'mAP_l2approx',
    'mAPH_l2approx'}.

    The summary keys carry the ``_l2approx`` tag (VERDICT r2 item 9) so logs
    from multi-day runs are never mistaken for devkit numbers: this evaluator
    is in-framework, with the L2 difficulty definition approximated by
    num_points only (module docstring). Devkit scoring of detection_pred.bin
    remains the acceptance path."""
    iou_thresholds = iou_thresholds or DEFAULT_IOU_THRESH
    results = {}
    ap_all, aph_all = [], []
    for ci, cname in enumerate(class_names):
        thresh = iou_thresholds.get(cname, 0.5)
        rows = []  # (score, tp, heading_acc)
        n_gt = 0
        for token, gt in ground_truths.items():
            gsel = np.asarray(gt["labels"]) == ci
            gboxes = np.asarray(gt["boxes"])[gsel]
            n_gt += len(gboxes)
            det = detections.get(token, {"boxes": np.zeros((0, 7)), "scores": [], "labels": []})
            dsel = np.asarray(det["labels"]) == ci
            dboxes = np.asarray(det["boxes"])[dsel]
            dscores = np.asarray(det["scores"])[dsel]
            order = np.argsort(-dscores)
            iou = _iou_matrix(dboxes[order], gboxes)
            taken = np.zeros(len(gboxes), bool)
            for r, d in enumerate(order):
                if iou.shape[1]:
                    j = int(np.argmax(np.where(taken, -1.0, iou[r])))
                    ok = (not taken[j]) and iou[r, j] >= thresh
                else:
                    ok = False
                if ok:
                    taken[j] = True
                    dh = dboxes[order][r][6] - gboxes[j][6]
                    dh = abs((dh + np.pi) % (2 * np.pi) - np.pi)
                    h_acc = min(1.0, max(0.0, 1.0 - dh / np.pi))
                    rows.append((dscores[d], 1, h_acc))
                else:
                    rows.append((dscores[d], 0, 0.0))
        if n_gt == 0:
            continue
        if not rows:
            results[f"{cname}_AP"] = 0.0
            results[f"{cname}_APH"] = 0.0
            ap_all.append(0.0)
            aph_all.append(0.0)
            continue
        rows.sort(key=lambda x: -x[0])
        tp = np.cumsum([r[1] for r in rows])
        hacc = np.cumsum([r[1] * r[2] for r in rows])
        fp = np.cumsum([1 - r[1] for r in rows])
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1)
        # APH: precision weighted by mean heading accuracy of the TPs so far
        precision_h = hacc / np.maximum(tp + fp, 1)
        ap = _average_precision(recall, precision)
        aph = _average_precision(recall, precision_h)
        results[f"{cname}_AP"] = ap
        results[f"{cname}_APH"] = aph
        ap_all.append(ap)
        aph_all.append(aph)
    results["mAP_l2approx"] = float(np.mean(ap_all)) if ap_all else 0.0
    results["mAPH_l2approx"] = float(np.mean(aph_all)) if aph_all else 0.0
    return results


def _iou_matrix_bev(det_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(det_boxes), len(gt_boxes)))
    return boxes_iou_bev(_t(det_boxes), _t(gt_boxes)).numpy().astype(np.float64)


def _match_rows(detections, ground_truths, class_idx, iou_fn, thresh):
    """Greedy score-descending matching for one class. Returns (rows, n_gt)
    where rows = [(score, tp)] over all detections of the class."""
    rows, n_gt = [], 0
    for token, gt in ground_truths.items():
        gsel = np.asarray(gt["labels"]) == class_idx
        gboxes = np.asarray(gt["boxes"])[gsel]
        n_gt += len(gboxes)
        det = detections.get(token, {"boxes": np.zeros((0, 7)), "scores": [], "labels": []})
        dsel = np.asarray(det["labels"]) == class_idx
        dboxes = np.asarray(det["boxes"])[dsel]
        dscores = np.asarray(det["scores"])[dsel]
        order = np.argsort(-dscores)
        iou = iou_fn(dboxes[order], gboxes)
        taken = np.zeros(len(gboxes), bool)
        for r, d in enumerate(order):
            ok = False
            if iou.shape[1]:
                j = int(np.argmax(np.where(taken, -1.0, iou[r])))
                ok = (not taken[j]) and iou[r, j] >= thresh
            if ok:
                taken[j] = True
            rows.append((dscores[d], int(ok)))
    return rows, n_gt


def _ap_r41(rows, n_gt, n_sample_pts: int = 41) -> float:
    """KITTI-protocol sampled AP: mean over n_sample_pts equally spaced recall
    positions of the max precision at recall >= r (R41 interpolation;
    capability parity with reference datasets/utils/eval.py:144-281, which
    realizes the same sampling through per-threshold statistics)."""
    if n_gt == 0 or not rows:
        return 0.0
    rows = sorted(rows, key=lambda x: -x[0])
    tp = np.cumsum([r[1] for r in rows])
    fp = np.cumsum([1 - r[1] for r in rows])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    # monotone envelope: max precision at recall >= r
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    samples = np.linspace(0.0, 1.0, n_sample_pts)
    ap = 0.0
    for r in samples:
        idx = np.searchsorted(recall, r, side="left")
        ap += prec_env[idx] if idx < len(prec_env) else 0.0
    return float(ap / n_sample_pts)


def kitti_style_eval(
    detections: Dict[str, dict],
    ground_truths: Dict[str, dict],
    iou_thresholds: Dict[str, float] = None,
    class_names: Sequence[str] = CLASS_NAMES,
    n_sample_pts: int = 41,
) -> Dict[str, Dict[str, float]]:
    """KITTI-style AP tables on the in-framework evaluator (capability parity
    with reference ``datasets/utils/eval.py:9-366``: sampled-recall AP with
    separate BEV-overlap and 3D-overlap criteria; the image-plane bbox/aos
    criteria need camera annotations the lidar pipeline doesn't carry).

    Returns {"bev": {cls: ap}, "3d": {cls: ap}} with AP in [0, 100] like the
    reference's printed tables. Matching is greedy score-descending (the same
    protocol as :func:`evaluate_detection`)."""
    iou_thresholds = iou_thresholds or DEFAULT_IOU_THRESH
    out = {"bev": {}, "3d": {}}
    for ci, cname in enumerate(class_names):
        thresh = iou_thresholds.get(cname, 0.5)
        for metric, iou_fn in (("bev", _iou_matrix_bev), ("3d", _iou_matrix)):
            rows, n_gt = _match_rows(detections, ground_truths, ci, iou_fn, thresh)
            if n_gt == 0:
                continue
            out[metric][cname] = 100.0 * _ap_r41(rows, n_gt, n_sample_pts)
    return out


def format_kitti_table(
    results: Dict[str, Dict[str, float]],
    iou_thresholds: Dict[str, float] = None,
) -> str:
    """Render :func:`kitti_style_eval` results as the familiar KITTI-style
    text table (reference get_official_eval_result capability)."""
    iou_thresholds = iou_thresholds or DEFAULT_IOU_THRESH
    lines = []
    classes = sorted(set(results.get("bev", {})) | set(results.get("3d", {})))
    for cname in classes:
        thr = iou_thresholds.get(cname, 0.5)
        lines.append(f"{cname} AP(R41)@{thr:.2f}:")
        bev = results.get("bev", {}).get(cname)
        b3d = results.get("3d", {}).get(cname)
        lines.append(
            "bev  AP: " + (f"{bev:.2f}" if bev is not None else "n/a")
        )
        lines.append(
            "3d   AP: " + (f"{b3d:.2f}" if b3d is not None else "n/a")
        )
    return "\n".join(lines)


def gt_from_annos(infos: Dict[str, dict]) -> Dict[str, dict]:
    """Build the evaluator's GT dict from anno pickles (geometric box7)."""
    annos = AnnoStore(infos)
    label_map = {1: 0, 2: 1, 4: 2}  # waymo type -> class index
    out = {}
    for token in infos:
        objs = annos.get(token)["annos"]["objects"]
        keep = [o for o in objs if o["label"] in label_map]
        out[token] = {
            "boxes": np.stack(
                [box7_from_box9(np.asarray(o["box"])) for o in keep]
            ) if keep else np.zeros((0, 7)),
            "labels": np.array([label_map[o["label"]] for o in keep]),
            "num_points": np.array([o.get("num_points", 99) for o in keep]),
        }
    return out


def detections_to_eval_format(detections: Dict[str, dict]) -> Dict[str, dict]:
    """Detector prediction.pkl entries (KITTI convention) -> evaluator format
    (geometric lidar box7)."""
    out = {}
    for token, det in detections.items():
        boxes = np.asarray(det["box3d_lidar"], np.float64).copy()
        if len(boxes):
            boxes[:, -1] = -boxes[:, -1] - np.pi / 2
            boxes[:, [3, 4]] = boxes[:, [4, 3]]
            boxes = boxes[:, [0, 1, 2, 3, 4, 5, boxes.shape[1] - 1]]
        else:
            boxes = np.zeros((0, 7))
        out[token] = {
            "boxes": boxes,
            "scores": np.asarray(det["scores"]),
            "labels": np.asarray(det["label_preds"]),
        }
    return out
