"""Waymo on-disk schema helpers: infos, per-frame annos, lidar pickles.

A copy of ``tdal/data/waymo_schema.py``: both packages read and write the same files.

The on-disk formats are bit-compatible with the reference's converter output
(det3d/datasets/waymo/waymo_decoder.py:35-68):

- lidar pickle:  {'scene_name', 'frame_name', 'frame_id',
                  'lidars': {'points_xyz' (N,3) f32, 'points_feature' (N,2) f32}}
- anno pickle:   {'scene_name', 'frame_name', 'frame_id', 'veh_to_global' (16,) f64,
                  'objects': [{'id', 'name', 'label', 'box' (9,) f32
                               [x,y,z,l,w,h,vx,vy,heading], 'num_points',
                               'detection_difficulty_level',
                               'combined_difficulty_level', 'global_speed',
                               'global_accel'}]}
- info entry:    {'path', 'anno_path', 'token', 'timestamp', 'sweeps': [...]}
                 (waymo_common.py:307-396)

``AnnoStore`` memoizes anno pickles and their inverse poses — the reference reloads
and re-inverts them per dataset item (static_model.py:536-538,
dynamic_model.py:449-483), which SURVEY.md §7 flags as the dominant CPU cost.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

# Waymo devkit class ids (waymo proto label.py): TYPE_VEHICLE=1, TYPE_PEDESTRIAN=2,
# TYPE_SIGN=3, TYPE_CYCLIST=4. The pipeline labels vehicles/peds/cyclists.
LABEL_VEHICLE = 1
LABEL_PEDESTRIAN = 2
LABEL_SIGN = 3
LABEL_CYCLIST = 4
CAT_NAMES = {LABEL_VEHICLE: "VEHICLE", LABEL_PEDESTRIAN: "PEDESTRIAN", LABEL_CYCLIST: "CYCLIST"}


def reorganize_info(infos: List[dict]) -> Dict[str, dict]:
    """List of info dicts -> token-keyed dict. Parity: tools/utils.py:46-51."""
    return {info["token"]: info for info in infos}


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_pickle(obj, path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


class AnnoStore:
    """Memoizing reader of per-frame anno pickles keyed by token.

    Precomputes veh_to_global (4,4), its inverse, and a name->object index."""

    def __init__(self, infos: Dict[str, dict]):
        self.infos = infos
        self._cache: Dict[str, dict] = {}

    def get(self, token: str) -> dict:
        entry = self._cache.get(token)
        if entry is None:
            annos = load_pickle(self.infos[token]["anno_path"])
            pose = np.reshape(np.asarray(annos["veh_to_global"], np.float64), (4, 4))
            entry = {
                "annos": annos,
                "pose": pose,
                "inv_pose": np.linalg.inv(pose),
                "by_name": {obj["name"]: obj for obj in annos["objects"]},
            }
            self._cache[token] = entry
        return entry

    def pose(self, token: str) -> np.ndarray:
        return self.get(token)["pose"]

    def inv_pose(self, token: str) -> np.ndarray:
        return self.get(token)["inv_pose"]

    def find_object(self, token: str, name: str) -> Optional[dict]:
        """GT object with the given name in the frame, else None.

        Replaces the reference's linear scans over annos['objects']
        (static_model.py:550-553, dynamic_model.py:470-479)."""
        return self.get(token)["by_name"].get(name)


def box7_from_box9(box9: np.ndarray) -> np.ndarray:
    """[x,y,z,l,w,h,vx,vy,heading] -> [x,y,z,l,w,h,heading] (drop velocity).

    Parity: the [[0,1,2,3,4,5,-1]] select in static_model.py:554 etc."""
    box9 = np.asarray(box9)
    return box9[..., [0, 1, 2, 3, 4, 5, 8]]


def transform_box_np(box: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Numpy box transform for host-side pipelines.

    Parity: reference transform_box (waymo_common.py:52-65 and 7 copies)."""
    box = np.asarray(box, np.float64)
    heading = box[..., 6] + np.arctan2(pose[1, 0], pose[0, 0])
    center = box[..., :3] @ pose[:3, :3].T + pose[:3, 3]
    return np.concatenate([center, box[..., 3:6], heading[..., None]], axis=-1)


def transform_points_np(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    xyz = np.asarray(points)[..., :3] @ pose[:3, :3].T + pose[:3, 3]
    return np.concatenate([xyz, np.asarray(points)[..., 3:]], axis=-1)


def points_in_rbbox_np(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Host-side points-in-rotated-box half-space test. points (N,>=3), boxes (M,7)
    -> bool (N, M). Same semantics as tdal_torch.core.geometry.points_in_rbbox and
    reference box_np_ops.points_in_rbbox (box_np_ops.py:641-647)."""
    xyz = np.asarray(points)[:, :3]
    boxes = np.atleast_2d(np.asarray(boxes))
    d = xyz[:, None, :] - boxes[None, :, :3]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    lx = c[None] * d[..., 0] + s[None] * d[..., 1]
    ly = -s[None] * d[..., 0] + c[None] * d[..., 1]
    half = boxes[:, 3:6] * 0.5
    return (
        (np.abs(lx) <= half[None, :, 0])
        & (np.abs(ly) <= half[None, :, 1])
        & (np.abs(d[..., 2]) <= half[None, :, 2])
    )


def rotz_np(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
