"""Waymo Open Dataset infos: port of ``tdal/data/waymo_converter.py``.

``create_waymo_infos`` scans the decoded per-frame pickles
(``<root>/<split>/lidar|annos/seq_X_frame_Y.pkl``) and writes one info a frame: its
paths, token, timestamp, the sweeps before it (each with ``transform_matrix`` =
ref_from_global @ global_from_car of that sweep, ``None`` for frame 0's self-sweep)
and, outside the test split, its GT boxes in the detector (KITTI) convention with the
zero-point boxes filtered out, saved as
``<root>/infos_<split>_<nsweeps:02d>sweeps_filter_zero_gt.pkl``. Plain numpy, the same
values and the same file as tdal's.

``convert_tfrecords`` (tfrecords -> the per-frame pickles) needs the optional Waymo
devkit and TensorFlow, as tdal's does; it raises ``ImportError`` without them.
"""

from __future__ import annotations

from functools import reduce
from pathlib import Path
from typing import List

import numpy as np

from tdal_torch.data.waymo_schema import dump_pickle, load_pickle

TYPE_LIST = ["UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST"]


def _veh_pos_to_transform(veh_pos: np.ndarray):
    """pose -> (global_from_car, car_from_global)."""
    global_from_car = np.asarray(veh_pos, np.float64)
    car_from_global = np.linalg.inv(global_from_car)
    return global_from_car, car_from_global


def sort_frame(frames: List[str]) -> List[str]:
    """Order 'seq_X_frame_Y.pkl' filenames by (seq, frame)."""
    def key(f):
        seq_id = int(f.split("_")[1])
        frame_id = int(f.split("_")[3][:-4])
        return seq_id * 100000 + frame_id

    return sorted(frames, key=key)


def fill_infos(root_path, frames: List[str], split: str = "train", nsweeps: int = 1) -> List[dict]:
    """One info a frame of ``frames`` (``tdal.data.waymo_converter.fill_infos``)."""
    root_path = Path(root_path)
    infos = []
    for frame_name in frames:
        lidar_path = str(root_path / split / "lidar" / frame_name)
        ref_path = str(root_path / split / "annos" / frame_name)
        ref_obj = load_pickle(ref_path)
        ref_time = 1e-6 * int(ref_obj["frame_name"].split("_")[-1])
        ref_pose = np.reshape(np.asarray(ref_obj["veh_to_global"], np.float64), (4, 4))
        _, ref_from_global = _veh_pos_to_transform(ref_pose)

        info = {
            "path": lidar_path,
            "anno_path": ref_path,
            "token": frame_name,
            "timestamp": ref_time,
            "sweeps": [],
        }
        sequence_id = int(frame_name.split("_")[1])
        frame_id = int(frame_name.split("_")[3][:-4])

        prev_id = frame_id
        sweeps = []
        while len(sweeps) < nsweeps - 1:
            if prev_id <= 0:
                if len(sweeps) == 0:
                    sweeps.append({"path": lidar_path, "token": frame_name,
                                   "transform_matrix": None, "time_lag": 0})
                else:
                    sweeps.append(sweeps[-1])
            else:
                prev_id -= 1
                curr_name = f"seq_{sequence_id}_frame_{prev_id}.pkl"
                curr_lidar_path = str(root_path / split / "lidar" / curr_name)
                curr_anno_path = str(root_path / split / "annos" / curr_name)
                curr_obj = load_pickle(curr_anno_path)
                curr_pose = np.reshape(np.asarray(curr_obj["veh_to_global"], np.float64), (4, 4))
                global_from_car, _ = _veh_pos_to_transform(curr_pose)
                tm = reduce(np.dot, [ref_from_global, global_from_car])
                curr_time = int(curr_obj["frame_name"].split("_")[-1])
                sweeps.append({"path": curr_lidar_path, "transform_matrix": tm,
                               "time_lag": ref_time - 1e-6 * curr_time})
        info["sweeps"] = sweeps

        if split != "test":
            annos = ref_obj["objects"]
            num_points_in_gt = np.array([a["num_points"] for a in annos])
            gt_boxes = np.array([a["box"] for a in annos], np.float64).reshape(-1, 9)
            if len(gt_boxes) != 0:
                # Waymo -> KITTI convention
                gt_boxes[:, -1] = -np.pi / 2 - gt_boxes[:, -1]
                gt_boxes[:, [3, 4]] = gt_boxes[:, [4, 3]]
            gt_names = np.array([TYPE_LIST[a["label"]] for a in annos])
            mask = (num_points_in_gt > 0).reshape(-1)
            info["gt_boxes"] = gt_boxes[mask].astype(np.float32)
            info["gt_names"] = gt_names[mask].astype(str)
        infos.append(info)
    return infos


def create_waymo_infos(root_path, split: str = "train", nsweeps: int = 1) -> List[dict]:
    """Scan ``<root>/<split>/annos/*.pkl``, build the infos and save them as
    ``infos_<split>_<nsweeps:02d>sweeps_filter_zero_gt.pkl`` under ``root_path``."""
    root_path = Path(root_path)
    frames = sort_frame([p.name for p in (root_path / split / "annos").glob("*.pkl")])
    infos = fill_infos(root_path, frames, split, nsweeps)
    out = root_path / f"infos_{split}_{nsweeps:02d}sweeps_filter_zero_gt.pkl"
    dump_pickle(infos, out)
    print(f"saved {len(infos)} infos to {out}")
    return infos


def convert_tfrecords(record_paths: List[str], out_root, split: str = "train", workers: int = 4):
    """tfrecords -> per-frame lidar/anno pickles. Needs the optional Waymo devkit
    (``waymo_open_dataset``) and TensorFlow: raises ``ImportError`` without them."""
    try:
        import tensorflow  # type: ignore  # noqa: F401
        from waymo_open_dataset import dataset_pb2  # type: ignore  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "convert_tfrecords needs the optional 'waymo_open_dataset' + tensorflow "
            "packages (reference docs/INSTALL.md). The remaining pipeline stages "
            "consume the per-frame pickles directly (tdal_torch.data.waymo_schema)."
        ) from e
    raise NotImplementedError("decoding tfrecords (tdal.data.waymo_decoder_tf) is not "
                              "ported yet (ROADMAP.md section 1)")
