"""Prediction writing + per-object track-data extraction (pipeline stages 2-3).

Port of ``tdal/pipeline/track_extraction.py`` and of ``reorganize`` from
``tools/trackData.py:18-35``:
- ``convert_detection_to_global_box`` and ``run_tracking`` (host numpy, copies);
- ``create_pd_detection``: det_annos, the per-box point crop into the global frame,
  GT matching by 3D IoU > 0.75 cached per track id, trackData pickles. The crop and
  the det-vs-GT IoU run as one batched torch call per chunk of frames on ``device``
  (tdal's ``_crop_and_match_jax``), pipelined as tdal's: chunk i's call is launched,
  then chunk i-1's result (the in-box bits packed 8 to a byte and the IoUs, one
  buffer) reaches the host in one copy and is emitted while chunk i computes. Frames
  are read from their ``.tdc`` cache where one was built, else from their pickles.
  The Waymo devkit proto output is replaced by its schema-equivalent pickle rows
  (``<bin>.pkl``), tdal's path when the devkit is absent;
- ``create_gt_detection``: the GT boxes as proto rows (``gt_preds.bin.pkl``);
- ``reorganize``: frame-keyed trackData -> trackID-keyed tracks.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from tdal_torch.core.geometry import points_in_rbbox
from tdal_torch.core.iou import boxes_iou_3d
from tdal_torch.data.frame_cache import read_frame_points
from tdal_torch.data.waymo_schema import AnnoStore, load_pickle
from tdal_torch.device import resolve_device

LABEL_TO_TYPE = {0: 1, 1: 2, 2: 4}  # det label -> waymo proto type (veh, ped, cyc)
LABEL2NAME = {0: "Vehicle", 1: "Pedestrian", 2: "Cyclist"}
TRACK_NAMES = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]
CHUNK_FRAMES = 8  # frames batched per device call


def label_to_name(label: int) -> str:
    return TRACK_NAMES[int(label)]


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.packbits' big-endian order


def _crop_and_match(points, det_boxes, gt_boxes):
    """Batched crop + IoU on the device: points (F, N, 3), det (F, D, 7), gt (F, G, 7)
    -> one uint8 tensor: the in-box bits (F, D, ceil(N/8)), box-major and packed as
    ``np.packbits`` packs them, then the IoUs (F, D, G) f32 as bytes."""
    f, n = points.shape[:2]
    inside = points_in_rbbox(points, det_boxes).transpose(1, 2)  # (F, D, N)
    inside = torch.nn.functional.pad(inside, (0, -n % 8))
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=points.device)
    packed = (inside.reshape(f, det_boxes.shape[1], -1, 8).to(torch.uint8) * w).sum(
        -1, dtype=torch.uint8)
    iou = boxes_iou_3d(det_boxes, gt_boxes).contiguous()
    return torch.cat([packed.reshape(-1), iou.reshape(-1).view(torch.uint8)])


def _unpack_chunk(buf: np.ndarray, shape):
    """The host side of ``_crop_and_match``'s buffer: (packed (F, D, N8), iou (F, D, G))."""
    f, d, n8, g = shape
    split = f * d * n8
    return buf[:split].reshape(f, d, n8), buf[split:].view(np.float32).reshape(f, d, g)


def _packed_nonzero(packed: np.ndarray) -> np.ndarray:
    """Sorted flat indices of the set bits of a packed bit array: nonzero over the
    bytes first, then the bits of the bytes that hold one."""
    nzb = np.flatnonzero(packed)
    bits = np.unpackbits(packed.reshape(-1)[nzb]).reshape(-1, 8).astype(bool)
    return (nzb[:, None] * 8 + np.arange(8)[None, :])[bits]


def _frame_xyz(info) -> np.ndarray:
    """A frame's lidar xyz: from its .tdc cache where one was built, else its pickle."""
    cached = read_frame_points(info["path"])
    if cached is not None:
        return cached[:, :3]
    return load_pickle(info["path"])["lidars"]["points_xyz"]


def sort_detections_by_token(ret_list: List[dict]) -> List[dict]:
    """Order frames by (sequence, frame) parsed from the token filename.

    Parity: tools/waymo_tracking/test.py:184-199."""
    def key(det):
        f = det["token"]
        seq_id = int(f.split("_")[1])
        frame_id = int(f.split("_")[3][: -4])
        return seq_id * 1000 + frame_id

    return sorted(ret_list, key=key)


def convert_detection_to_global_box(detections: Dict[str, dict], infos: Dict[str, dict], annos: AnnoStore):
    """Per-frame detections (vehicle frame, detector convention) -> global-frame box
    dicts for the tracker. Parity: waymo_tracking/test.py:201-249."""
    ret_list = []
    detection_results = {}
    for token in infos.keys():
        if token not in detections:
            continue
        detection = detections[token]
        detection_results[token] = {k: np.asarray(v) for k, v in detection.items()}
        pose = annos.pose(token)
        box3d = np.array(detection["box3d_lidar"], np.float64)
        labels = np.asarray(detection["label_preds"])
        scores = np.asarray(detection["scores"])
        if box3d.shape[1] == 7:  # no velocity head: pad zeros
            box3d = np.concatenate(
                [box3d[:, :6], np.zeros((len(box3d), 2)), box3d[:, 6:]], axis=1
            )
        else:
            box3d = box3d[:, [0, 1, 2, 3, 4, 5, 6, 7, 8]]
        # detector (KITTI) -> Waymo convention (test.py:219-220)
        box3d[:, -1] = -box3d[:, -1] - np.pi / 2
        box3d[:, [3, 4]] = box3d[:, [4, 3]]
        # to global, velocity rotated (test.py:150-172)
        center = box3d[:, :3] @ pose[:3, :3].T + pose[:3, 3]
        vel = np.concatenate(
            [box3d[:, 6:8], np.zeros((len(box3d), 1))], axis=1
        ) @ pose[:3, :3].T
        anno_list = [
            {
                "translation": center[i],
                "velocity": vel[i, :2],
                "detection_name": label_to_name(labels[i]),
                "score": float(scores[i]),
                "box_id": i,
            }
            for i in range(len(box3d))
        ]
        ret_list.append(
            {
                "token": token,
                "frame_id": int(token.split("_")[3][:-4]),
                "global_boxs": anno_list,
                "timestamp": infos[token]["timestamp"],
            }
        )
    return sort_detections_by_token(ret_list), detection_results


def run_tracking(global_preds, detection_results, max_age=3, max_dist=None, score_thresh=0.75):
    """Sequential tracking over sorted frames. Parity: waymo_tracking/test.py:88-134.

    Returns (predictions {token: {box3d_lidar, label_preds, scores, tracking_ids}},
    id_count)."""
    from tdal_torch.pipeline.tracker import GreedyTracker

    max_dist = max_dist or {"VEHICLE": 0.8, "PEDESTRIAN": 0.4, "CYCLIST": 0.6}
    tracker = GreedyTracker(max_age=max_age, max_dist=max_dist, score_thresh=score_thresh)
    predictions = {}
    last_time_stamp = 0.0
    for pred in global_preds:
        token = pred["token"]
        if pred["frame_id"] == 0:
            tracker.reset()
            last_time_stamp = pred["timestamp"]
        time_lag = pred["timestamp"] - last_time_stamp
        last_time_stamp = pred["timestamp"]
        outputs = tracker.step(pred["global_boxs"], time_lag)
        box_ids, tracking_ids = [], []
        for item in outputs:
            if item["active"] == 0:
                continue
            box_ids.append(item["box_id"])
            tracking_ids.append(item["tracking_id"])
        det = detection_results[token]
        sel = np.asarray(box_ids, np.int64)
        predictions[token] = {
            "tracking_ids": np.asarray(tracking_ids),
            "box3d_lidar": det["box3d_lidar"][sel],
            "label_preds": det["label_preds"][sel],
            "scores": det["scores"][sel],
        }
    return predictions, tracker.id_count


def create_pd_detection(
    detections: Dict[str, dict],
    infos: Dict[str, dict],
    result_path: str | os.PathLike,
    tracking: bool = False,
    ratio: float = 0.25,
    split: int = 16,
    logger=None,
    match_iou: float = 0.75,
    device=None,
):
    """Write det_annos.pkl, the proto-row pickle, and (tracking) the trackData pickles.

    Parity: waymo_common._create_pd_detection (:67-231); 'train' in result_path takes
    the first ``ratio`` of frames and shards trackData ``split`` ways. With
    ``tracking`` the crop and GT matching run on ``device`` (None means CUDA)."""
    result_path = Path(result_path)
    result_path.mkdir(parents=True, exist_ok=True)
    annos = AnnoStore(infos)
    dev = resolve_device(device) if tracking else None

    proto_rows: list = []
    matching: Dict = {}
    trackData: Dict[str, dict] = {}
    det_annos = []

    items = list(detections.items())
    if "train" in str(result_path):
        items = items[: int(len(items) * ratio)]

    def emit(frames, packed=None, iou_b=None):
        for fi, (token, detection, entry, gt_box7, lidars, box3d) in enumerate(frames):
            obj = entry["annos"]
            pose = entry["pose"]
            scores = np.asarray(detection["scores"])
            labels = np.asarray(detection["label_preds"])
            det_annos.append(
                {
                    "name": np.array([LABEL2NAME[int(i)] for i in labels]),
                    "score": np.asarray(scores),
                    "boxes_lidar": box3d.copy(),
                    "frame_id": f"segment-{obj['scene_name']}_with_camera_labels_{obj['frame_id']:03d}",
                    "metadata": {
                        "context_name": obj["scene_name"],
                        "timestamp_micros": int(str(infos[token]["timestamp"]).replace(".", "")),
                    },
                }
            )
            if tracking:
                # box-major bits of the real boxes only; padding points lie in no box
                n_bits = packed.shape[2] * 8
                flat = _packed_nonzero(packed[fi, : len(box3d)])
                counts = np.bincount(flat // n_bits, minlength=len(box3d))
                lidars_global = lidars @ pose[:3, :3].T + pose[:3, 3]
                crops = np.split(lidars_global[flat % n_bits], np.cumsum(counts)[:-1])
                iou = iou_b[fi, : len(box3d), : len(gt_box7)]
            else:
                # no crops/matching consumers without tracking (waymo_common.py:168-194
                # computes them anyway)
                crops = [np.zeros((0, 3))] * len(box3d)
                iou = np.zeros((len(box3d), 0))
            td = {k: [] for k in ("id", "type", "bbox", "score", "point", "match")}
            _emit_frame_boxes(
                box3d, scores, labels, detection.get("tracking_ids"), token, obj, pose,
                crops, iou, matching, td, proto_rows, tracking, match_iou,
            )
            trackData[token] = td

    pending = None  # (frames, host buffer, its copy's event, shape) of the last chunk
    for chunk_start in range(0, len(items), CHUNK_FRAMES):
        frames = []
        for token, detection in items[chunk_start : chunk_start + CHUNK_FRAMES]:
            entry = annos.get(token)
            gt_box9 = np.array(
                [o["box"] for o in entry["annos"]["objects"]], np.float64
            ).reshape(-1, 9)
            gt_box7 = gt_box9[:, [0, 1, 2, 3, 4, 5, 8]] if gt_box9.size else np.zeros((0, 7))
            lidars = _frame_xyz(infos[token]) if tracking else np.zeros((0, 3), np.float32)
            box3d = np.array(detection["box3d_lidar"], np.float64)
            # detector (KITTI) -> Waymo convention (waymo_common.py:106-111)
            if len(box3d):
                box3d[:, -1] = -box3d[:, -1] - np.pi / 2
                box3d = box3d[:, [0, 1, 2, 4, 3, 5, -1]]
            else:
                box3d = np.zeros((0, 7))
            frames.append((token, detection, entry, gt_box7, lidars, box3d))
        if not tracking:
            emit(frames)
            continue

        # one device call per chunk; padding boxes are degenerate, padding points
        # far away, and neither reaches the emitted rows
        d_pad = max(max(len(f[5]) for f in frames), 1)
        g_pad = max(max(len(f[3]) for f in frames), 1)
        n_pad = max(max(len(f[4]) for f in frames), 1)
        det_b = np.zeros((len(frames), d_pad, 7), np.float32)
        det_b[..., 3:6] = 1e-3
        gt_b = np.zeros((len(frames), g_pad, 7), np.float32)
        gt_b[..., 3:6] = 1e-3
        pts_b = np.full((len(frames), n_pad, 3), 1e9, np.float32)
        for fi, (_, _, _, gt_box7, lidars, box3d) in enumerate(frames):
            det_b[fi, : len(box3d)] = box3d
            gt_b[fi, : len(gt_box7)] = gt_box7
            pts_b[fi, : len(lidars)] = lidars
        out = _crop_and_match(torch.from_numpy(pts_b).to(dev), torch.from_numpy(det_b).to(dev),
                              torch.from_numpy(gt_b).to(dev))
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=dev.type == "cuda")
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event() if dev.type == "cuda" else None
        if event is not None:
            event.record()
        if pending is not None:
            _emit_pending(pending, emit)
        pending = (frames, host, event, (len(frames), d_pad, -(-n_pad // 8), g_pad))
    if pending is not None:
        _emit_pending(pending, emit)

    with open(result_path / "det_annos.pkl", "wb") as f:
        pickle.dump(det_annos, f)
    if logger:
        logger.info(f"Saved det_annos.pkl ({len(det_annos)} frames)")

    if tracking:
        if "train" in str(result_path):
            td_list = list(trackData.items())
            for i in range(split):
                shard = dict(
                    td_list[len(td_list) * i // split : len(td_list) * (i + 1) // split]
                )
                with open(result_path / f"trackData_{i}.pkl", "wb") as f:
                    pickle.dump(shard, f)
        else:
            with open(result_path / "trackData.pkl", "wb") as f:
                pickle.dump(trackData, f)

    bin_name = "tracking_pred.bin" if tracking else "detection_pred.bin"
    with open(result_path / (bin_name + ".pkl"), "wb") as f:
        pickle.dump(proto_rows, f)
    return det_annos, trackData


def _emit_pending(pending, emit):
    """Wait for a chunk's copy to the host, then emit its frames."""
    frames, host, event, shape = pending
    if event is not None:
        event.synchronize()
    emit(frames, *_unpack_chunk(host.numpy(), shape))


def _emit_frame_boxes(box3d, scores, labels, tracking_ids, token, obj, pose,
                      crops, iou, matching, td, proto_rows, tracking, match_iou):
    """Per-box proto rows + GT matching + trackData rows (host loop).

    Parity: waymo_common.py:106-205 (IoU > match_iou, cached per track id)."""
    for i in range(len(box3d)):
        det = box3d[i]
        obj_id = (
            str(int(tracking_ids[i])) if tracking_ids is not None else f"{token}_{i}"
        )
        proto_rows.append(
            dict(context_name=obj["scene_name"],
                 frame_timestamp_micros=int(obj["frame_name"].split("_")[-1]),
                 box=det.tolist(), score=float(scores[i]),
                 type=LABEL_TO_TYPE[int(labels[i])],
                 id=obj_id if tracking else None)
        )
        if obj_id in matching:
            match = matching[obj_id]
        elif iou.shape[1]:
            best = int(np.argmax(iou[i]))
            if iou[i, best] > match_iou:
                match = obj["objects"][best]["name"]
                matching[obj_id] = match
            else:
                match = None
        else:
            match = None

        td["id"].append(obj_id)
        td["type"].append(LABEL_TO_TYPE[int(labels[i])])
        td["bbox"].append(_transform_box7(det, pose))
        td["score"].append(float(scores[i]))
        td["point"].append(crops[i])
        td["match"].append(match)


def _transform_box7(box7: np.ndarray, pose: np.ndarray) -> np.ndarray:
    heading = box7[-1] + np.arctan2(pose[1, 0], pose[0, 0])
    center = box7[:3] @ pose[:3, :3].T + pose[:3, 3]
    return np.concatenate([center, box7[3:6], [heading]])


CAT_NAME_TO_ID = {"VEHICLE": 1, "PEDESTRIAN": 2, "SIGN": 3, "CYCLIST": 4}
TYPE_NAMES = ["UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST"]


def create_gt_detection(infos: List[dict], result_path, logger=None):
    """Write ``gt_preds.bin.pkl``: every GT box with points and a known type as a
    proto row (score 1, id = the object's name), for a local tracking evaluation.

    Parity: waymo_common._create_gt_detection (:233-290), the devkit-absent path of
    tdal's ``create_gt_detection``."""
    result_path = Path(result_path)
    result_path.mkdir(parents=True, exist_ok=True)
    rows = []
    for info in infos:
        obj = load_pickle(info["anno_path"])
        annos = obj["objects"]
        if not annos:
            continue
        num_points = np.array([a["num_points"] for a in annos])
        box3d = np.array([a["box"] for a in annos], np.float64)[:, [0, 1, 2, 3, 4, 5, -1]]
        names = [TYPE_NAMES[a["label"]] for a in annos]
        for i in range(len(box3d)):
            if num_points[i] == 0 or names[i] == "UNKNOWN":
                continue
            rows.append(dict(context_name=obj["scene_name"],
                             frame_timestamp_micros=int(obj["frame_name"].split("_")[-1]),
                             box=box3d[i].tolist(), score=1.0,
                             type=CAT_NAME_TO_ID[names[i]],
                             num_lidar_points_in_box=int(num_points[i]),
                             id=annos[i]["name"]))
    with open(result_path / "gt_preds.bin.pkl", "wb") as f:
        pickle.dump(rows, f)
    if logger:
        logger.info(f"wrote gt_preds.bin.pkl ({len(rows)} GT boxes)")


def reorganize(track: dict) -> dict:
    """frame-keyed trackData -> trackID-keyed {type, bbox, score, point, match, token}.

    Parity: tools/trackData.py:18-35 (reference trackData.py:26-45)."""
    tracking = {}
    for token, frame in track.items():
        ids = frame["id"]
        for idx in range(len(ids)):
            entry = tracking.setdefault(
                ids[idx],
                {"type": [], "bbox": [], "score": [], "point": [], "match": [], "token": []},
            )
            entry["type"].append(frame["type"][idx])
            entry["bbox"].append(frame["bbox"][idx])
            entry["score"].append(frame["score"][idx])
            entry["point"].append(frame["point"][idx])
            entry["match"].append(frame["match"][idx])
            entry["token"].append(token)
    return tracking
