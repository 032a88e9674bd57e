"""The chained offboard pipeline: detect -> track -> extract -> motion split -> label.

Port of ``benchmarks/pipeline_e2e.py``'s chain (reference docs/GETTING_STARTED.md
:58-114), through the port's entry points on one device:

1. detector inference (``run_inference``) and the det_annos of its boxes;
2. tracking (global boxes, the greedy tracker);
3. trackData extraction (crop, GT match) and its reorganisation by track id;
4. trackGT, the motion-state features and the classifier's static/dynamic split;
5. the static labeler's boxes and their postprocessing (det_annos patched);
6. the dynamic labeler's likewise.

``label_chain`` runs stages 2-6 from detections; ``run_chain`` runs stage 1 and then
``label_chain``; ``measure`` keeps ``pipeline_e2e``'s warm pass on a short segment
before the timed pass, and reports frames/s with each stage's seconds and the
``counts`` (detected boxes, tracks, static/dynamic tracks, boxes labeled) that show a
hollow run. The labelers are whatever models the caller passes, trained or not.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from tdal_torch.data.track_datasets import (
    DynamicTrackDataset, StaticTrackDataset, preprocess_tracks,
)
from tdal_torch.device import resolve_device
from tdal_torch.pipeline.detector_run import run_inference
from tdal_torch.pipeline.labeler_run import (
    build_token2idx, postprocess_dynamic, postprocess_static, predict_final_boxes,
    sort_detections,
)
from tdal_torch.pipeline.motion_state import (
    build_track_gt, fit_motion_classifier, split_by_prediction, track_features,
)
from tdal_torch.pipeline.track_extraction import (
    convert_detection_to_global_box, create_pd_detection, reorganize, run_tracking,
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def label_chain(detections: dict, info_map: dict, annos, labelers, out, logger,
                score_thresh: float = 0.75, score_percentile: float | None = None,
                match_iou: float = 0.75, npoints_static: int = 4096,
                npoints_dynamic: int = 1024, predict_batch: int = 64, device=None,
                det_annos=None) -> dict:
    """Stages 2-6 from per-frame detections (detector convention) on ``device``.

    ``labelers`` = ((static model, inputs_fn, kind), (dynamic model, inputs_fn, kind)).
    The tracker keeps boxes scoring at least ``score_thresh``, or, given
    ``score_percentile``, that percentile of all the detections' scores. Returns the
    stages' outputs, ``stage_s`` and ``counts``."""
    dev = resolve_device(device)
    out = Path(out)
    (s_model, s_inputs, s_kind), (d_model, d_inputs, d_kind) = labelers
    stage_s, counts, res = {}, {}, {}
    if det_annos is None:
        det_annos, _ = create_pd_detection(detections, info_map, out / "det", logger=logger)

    t0 = time.perf_counter()
    global_preds, det_results = convert_detection_to_global_box(detections, info_map, annos)
    if score_percentile is not None:
        scores = np.concatenate([np.asarray(d["scores"]) for d in detections.values()])
        score_thresh = float(np.percentile(scores, score_percentile)) if len(scores) else 1.0
    predictions, _ = run_tracking(global_preds, det_results, score_thresh=score_thresh)
    stage_s["track"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, frame_track = create_pd_detection(predictions, info_map, out / "track", tracking=True,
                                         logger=logger, match_iou=match_iou, device=dev)
    track = reorganize(frame_track)
    stage_s["extract"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    X, y, new_track = track_features(track, build_track_gt(list(info_map.values())))
    clf = fit_motion_classifier(X, y)
    track_static, track_dynamic = split_by_prediction(new_track, clf.predict(X) if len(X) else [])
    stage_s["motion"] = time.perf_counter() - t0
    counts.update(tracks=len(new_track), static_tracks=len(track_static),
                  dynamic_tracks=len(track_dynamic))

    det_annos = sort_detections([dict(d, boxes_lidar=d["boxes_lidar"].copy()) for d in det_annos])
    token2idx = build_token2idx(info_map, annos, det_annos)
    boxes, metrics, batches = {}, {}, 0

    t0 = time.perf_counter()
    ts, _ = preprocess_tracks(track_static, annos, ratio=0.0, seed=0)
    boxes["static"] = np.zeros((0, 7))
    if ts:
        s_ds = StaticTrackDataset(ts, annos, npoints=npoints_static, seed=0)
        boxes["static"] = predict_final_boxes(s_model, s_ds, s_inputs, s_kind, predict_batch,
                                              device=dev)
        metrics["static"] = postprocess_static(ts, annos, boxes["static"], logger, det_annos,
                                               token2idx, device=dev)
        batches += math.ceil(len(s_ds) / predict_batch)
    _sync(dev)
    stage_s["static_label"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    boxes["dynamic"] = np.zeros((0, 7))
    if track_dynamic:
        d_ds = DynamicTrackDataset(track_dynamic, annos, npoints=npoints_dynamic, seed=0)
        boxes["dynamic"] = predict_final_boxes(d_model, d_ds, d_inputs, d_kind, predict_batch,
                                               device=dev)
        metrics["dynamic"] = postprocess_dynamic(track_dynamic, annos, boxes["dynamic"],
                                                 logger, det_annos, token2idx, device=dev)
        batches += math.ceil(len(d_ds) / predict_batch)
    _sync(dev)
    stage_s["dynamic_label"] = time.perf_counter() - t0
    counts.update(static_boxes_labeled=len(boxes["static"]),
                  dynamic_boxes_labeled=len(boxes["dynamic"]), predict_batches=batches)
    res.update(global_preds=global_preds, predictions=predictions, frame_track=frame_track,
               track=track, track_static=track_static, track_dynamic=track_dynamic,
               static_labeled=ts, boxes=boxes, metrics=metrics, det_annos=det_annos,
               score_thresh=score_thresh, stage_s=stage_s, counts=counts)
    return res


def run_chain(state, dataset, test_cfg: dict, info_map: dict, annos, labelers, out, logger,
              batch_size: int = 4, **chain_kw) -> dict:
    """Stage 1 (``run_inference`` of ``state.model`` over ``dataset``, the frames of
    ``info_map``, in order) and its det_annos, then ``label_chain`` on the model's
    device."""
    dev = next(state.model.parameters()).device
    out = Path(out)
    t0 = time.perf_counter()
    detections = run_inference(state, dataset, test_cfg, batch_size, logger)
    det_annos, _ = create_pd_detection(detections, info_map, out / "det", logger=logger)
    _sync(dev)
    detect_s = time.perf_counter() - t0
    res = label_chain(detections, info_map, annos, labelers, out, logger, device=dev,
                      det_annos=det_annos, **chain_kw)
    res["stage_s"] = {"detect": detect_s, **res["stage_s"]}
    res["counts"] = {"det_boxes": int(sum(len(d["scores"]) for d in detections.values())),
                     **res["counts"]}
    res["detections"] = detections
    return res


def measure(state, test_cfg: dict, segment, warm_segment, labelers, out, logger,
            before_timed=None, **chain_kw) -> dict:
    """``run_chain`` on ``warm_segment``, then timed on ``segment``; each segment is
    (dataset, info_map, annos). ``before_timed``, if given, is called between the two
    passes (a harness resets its counters there). Returns frames/s over the timed
    chain's stages with ``stage_s``, ``counts``, the warm pass's counts and the timed
    chain's result."""
    out = Path(out)
    warm = run_chain(state, warm_segment[0], test_cfg, *warm_segment[1:], labelers,
                     out / "warm", logger, **chain_kw)
    if before_timed is not None:
        before_timed()
    timed = run_chain(state, segment[0], test_cfg, *segment[1:], labelers, out / "timed",
                      logger, **chain_kw)
    total = sum(timed["stage_s"].values())
    return {"frames_per_sec": len(segment[1]) / total, "n_frames": len(segment[1]),
            "total_s": total, "stage_s": timed["stage_s"], "counts": timed["counts"],
            "warm_counts": warm["counts"], "result": timed}
