"""Fabricated miniature "Waymo" sequences for tests, smoke runs, and benchmarks.

A copy of ``tdal/data/synthetic.py`` (same numpy draws, so both packages write
identical segments from one seed), with its own ``combined_difficulty`` and the
GT-as-detections fabricator ``fabricate_detections``.

The reference has no test fixtures (SURVEY.md §4); its on-disk formats are plain
pickles (waymo_decoder.py:35-68), so we fabricate bit-compatible ones: moving ego,
static + dynamic objects, lidar points sampled inside each object's box plus background
clutter. From the same scene we can emit:

- per-frame lidar/anno pickles + an infos list (detector/pipeline input),
- detection dicts shaped like the detector's prediction.pkl,
- ``trackData``-style frame-keyed dicts and track-keyed ``track*`` dicts (labeler input)
  with the exact schema of waymo_common._create_pd_detection (waymo_common.py:190-203)
  and tools/trackData.py:25-57.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from tdal_torch.data.waymo_schema import (
    dump_pickle,
    rotz_np,
    transform_box_np,
)


def combined_difficulty(detection_difficulty_level: int, num_points: int) -> int:
    """The Waymo combined-difficulty rule (waymo_decoder.py:175-185): an unset (0)
    labeler level becomes LEVEL_1 with >= 5 points in the box, else LEVEL_2."""
    if detection_difficulty_level == 0:
        return 1 if num_points >= 5 else 2
    return int(detection_difficulty_level)


def _pose(x: float, y: float, yaw: float) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = rotz_np(yaw)
    m[0, 3] = x
    m[1, 3] = y
    return m


def _sample_box_points(rng, box7, n):
    """Uniform points inside a 7-dof box (vehicle-frame)."""
    local = (rng.random((n, 3)) - 0.5) * box7[3:6]
    return local @ rotz_np(box7[6]).T + box7[:3]


class SyntheticScene:
    """One fabricated sequence: ego path, objects with global-frame trajectories."""

    def __init__(
        self,
        scene_id: int = 0,
        n_frames: int = 10,
        n_static: int = 2,
        n_dynamic: int = 2,
        points_per_object: int = 256,
        n_background: int = 2048,
        seed: int = 0,
        object_dims=(4.8, 1.8, 1.5),
        x_range=(5.0, 30.0),
        background_follows_ego: bool = True,
        dynamic_motion: str = "random",
    ):
        self.scene_id = scene_id
        self.scene_name = f"synthetic_{scene_id:03d}"
        self.n_frames = n_frames
        self.rng = np.random.default_rng(seed + 1000 * scene_id)
        self.dt = 0.1

        # Ego drives along +x at 5 m/s.
        self.ego_poses = [_pose(5.0 * self.dt * i, 0.0, 0.0) for i in range(n_frames)]

        # Object x placement: pass a wide x_range to spread objects along the
        # ego path for LONG segments — the default (5, 30) puts everything
        # behind the ego (out of detector range) once it has driven ~35 m
        # (~70 frames), emptying the back half of the segment.
        self.background_follows_ego = background_follows_ego
        self.objects = []
        rng = self.rng
        for k in range(n_static):
            center = np.array([rng.uniform(*x_range), rng.uniform(-15, 15), rng.uniform(0.5, 1.2)])
            dims = np.array(object_dims) * rng.uniform(0.9, 1.1, 3)
            self.objects.append(
                dict(name=f"st{scene_id}_{k}", label=1, center=center, dims=dims,
                     heading=rng.uniform(-np.pi, np.pi), vel=np.zeros(2), static=True)
            )
        # dynamic_motion="traffic": objects cruise along the ego path (+x,
        # near ego speed, placed near the ego start) so they STAY in detector
        # range over long segments — random-heading objects wander out of the
        # detection window before a far-along ego window reaches them, so a
        # long segment's dynamic objects are never seen at all. Still >1 m/s,
        # so the trackGT rule classifies them dynamic.
        for k in range(n_dynamic):
            if dynamic_motion == "traffic":
                center = np.array(
                    [rng.uniform(5.0, 45.0), rng.uniform(-15, 15), rng.uniform(0.5, 1.2)]
                )
                heading = 0.0
                speed = rng.uniform(3.0, 8.0)
            else:
                center = np.array(
                    [rng.uniform(*x_range), rng.uniform(-15, 15), rng.uniform(0.5, 1.2)]
                )
                heading = rng.uniform(-np.pi, np.pi)
                speed = rng.uniform(3.0, 8.0)
            dims = np.array(object_dims) * rng.uniform(0.9, 1.1, 3)
            vel = speed * np.array([np.cos(heading), np.sin(heading)])
            self.objects.append(
                dict(name=f"dy{scene_id}_{k}", label=1, center=center, dims=dims,
                     heading=heading, vel=vel, static=False)
            )
        self.points_per_object = points_per_object
        self.n_background = n_background

    def gt_box_global(self, obj, frame: int) -> np.ndarray:
        """9-dof global-frame GT box [x,y,z,l,w,h,vx,vy,heading] at a frame."""
        c = obj["center"].copy()
        c[:2] = c[:2] + obj["vel"] * self.dt * frame
        return np.concatenate([c, obj["dims"], obj["vel"], [obj["heading"]]])

    def frame_token(self, frame: int) -> str:
        # Reference token format: the per-frame filename 'seq_{id}_frame_{fid}.pkl'
        # (waymo_common._fill_infos:327-328) — tooling parses seq/frame ids from it.
        return f"seq_{self.scene_id}_frame_{frame}.pkl"

    def frame(self, frame: int) -> dict:
        """Returns {'token', 'pose', 'points' (vehicle frame), 'objects': [anno objs]}."""
        pose = self.ego_poses[frame]
        inv = np.linalg.inv(pose)
        rng = np.random.default_rng(self.rng.bit_generator.seed_seq.entropy % (2**31) + frame)

        # Background clutter on the ground plane. It tracks the EGO (like a
        # real lidar's field of view) so long segments keep constant point
        # density in the vehicle frame — anchored at the origin it all falls
        # behind the ego after ~20 s and late frames go empty.
        bg_x0 = pose[0, 3] if self.background_follows_ego else 0.0
        pts_global = [
            np.column_stack(
                [
                    bg_x0 + rng.uniform(-10, 60, self.n_background),
                    rng.uniform(-40, 40, self.n_background),
                    rng.uniform(-0.2, 0.2, self.n_background),
                ]
            )
        ]
        anno_objects = []
        for obj in self.objects:
            box9 = self.gt_box_global(obj, frame)
            pts_global.append(
                _sample_box_points(rng, box9[[0, 1, 2, 3, 4, 5, 8]], self.points_per_object)
            )
            # anno 'box' is in VEHICLE frame (waymo_decoder.extract_objects:164-207).
            box7_v = transform_box_np(box9[None, [0, 1, 2, 3, 4, 5, 8]], inv)[0]
            vel_v = box9[6:8] @ pose[:2, :2]  # rotate global vel into vehicle frame
            box9_v = np.concatenate([box7_v[:6], vel_v, box7_v[6:]])
            anno_objects.append(
                {
                    "id": obj["name"],
                    "name": obj["name"],
                    "label": obj["label"],
                    "box": box9_v.astype(np.float32),
                    "num_points": self.points_per_object,
                    "detection_difficulty_level": 0,
                    # Same rule real infos carry (waymo_decoder.py:175-185 via
                    # waymo_decoder_tf.combined_difficulty): unset labeler level
                    # -> L1 if >=5 points else L2, so _l2approx metrics see the
                    # same field semantics as real Waymo.
                    "combined_difficulty_level": combined_difficulty(
                        0, self.points_per_object
                    ),
                    "global_speed": np.asarray(obj["vel"], np.float32),
                    "global_accel": np.zeros(2, np.float32),
                }
            )
        points_global = np.concatenate(pts_global, axis=0)
        points_vehicle = points_global @ inv[:3, :3].T + inv[:3, 3]
        return {
            "token": self.frame_token(frame),
            "pose": pose,
            "points": points_vehicle.astype(np.float32),
            "objects": anno_objects,
        }

    # ------------------------------------------------------------------
    # On-disk emission (bit-compatible with the reference converter output)
    # ------------------------------------------------------------------

    def write(self, root: str | Path, split: str | None = None) -> List[dict]:
        """Write lidar/anno pickles (filenames == tokens, reference layout
        <root>[/<split>]/lidar|annos/seq_X_frame_Y.pkl); return the infos list."""
        root = Path(root) if split is None else Path(root) / split
        infos = []
        for f in range(self.n_frames):
            fr = self.frame(f)
            token = fr["token"]
            lidar_path = root / "lidar" / token
            anno_path = root / "annos" / token
            dump_pickle(
                {
                    "scene_name": self.scene_name,
                    "frame_name": f"{self.scene_name}_loc_{f}_{1000000 + f * 100000}",
                    "frame_id": f,
                    "lidars": {
                        "points_xyz": fr["points"],
                        "points_feature": np.ones((fr["points"].shape[0], 2), np.float32),
                    },
                },
                lidar_path,
            )
            dump_pickle(
                {
                    "scene_name": self.scene_name,
                    "frame_name": f"{self.scene_name}_loc_{f}_{1000000 + f * 100000}",
                    "frame_id": f,
                    "veh_to_global": fr["pose"].reshape(-1),
                    "objects": fr["objects"],
                },
                anno_path,
            )
            infos.append(
                {
                    "path": str(lidar_path),
                    "anno_path": str(anno_path),
                    "token": token,
                    "timestamp": (1000000 + f * 100000) / 1e6,
                    "sweeps": [],
                }
            )
        return infos

    # ------------------------------------------------------------------
    # Track-data fabrication (perfect-tracker output, with optional noise)
    # ------------------------------------------------------------------

    def make_track_data(self, box_noise: float = 0.1, only: Optional[str] = None) -> Dict[str, dict]:
        """Track-keyed dict in the schema of tools/trackData.py output:
        track_id -> {'type','bbox' (global box7),'score','point' (global pts),
                     'match','token'} lists. only: 'static'|'dynamic'|None."""
        tracks: Dict[str, dict] = {}
        for obj in self.objects:
            if only == "static" and not obj["static"]:
                continue
            if only == "dynamic" and obj["static"]:
                continue
            tid = f"track_{obj['name']}"
            tr = {"type": [], "bbox": [], "score": [], "point": [], "match": [], "token": []}
            for f in range(self.n_frames):
                box9 = self.gt_box_global(obj, f)
                box7 = box9[[0, 1, 2, 3, 4, 5, 8]].copy()
                noise = self.rng.normal(0, box_noise, 7) * np.array(
                    [1, 1, 0.3, 0.5, 0.3, 0.3, 0.3]
                )
                det_box = box7 + noise
                rng_pts = np.random.default_rng(hash((obj["name"], f)) % (2**31))
                pts = _sample_box_points(rng_pts, box7, self.points_per_object)
                tr["type"].append(obj["label"])
                tr["bbox"].append(det_box)
                tr["score"].append(float(self.rng.uniform(0.5, 1.0)))
                tr["point"].append(pts)
                tr["match"].append(obj["name"])
                tr["token"].append(self.frame_token(f))
            tracks[tid] = tr
        return tracks


def make_synthetic_dataset(root: str | Path, n_scenes: int = 2, n_frames: int = 10, seed: int = 0, **kw):
    """Write scenes + infos pickle; return (infos list, list of SyntheticScene)."""
    root = Path(root)
    scenes = [SyntheticScene(i, n_frames=n_frames, seed=seed, **kw) for i in range(n_scenes)]
    infos = []
    for s in scenes:
        infos.extend(s.write(root))
    dump_pickle(infos, root / "infos.pkl")
    return infos, scenes


def fabricate_detections(scenes, annos, noise: float = 0.05, seed: int = 0) -> Dict[str, dict]:
    """GT boxes as per-token detections in the detector (KITTI) convention, with
    Gaussian box noise and scores in [0.8, 1): the input of stage 2 when no trained
    detector is at hand. ``annos`` is an ``AnnoStore`` over the scenes' infos."""
    rng = np.random.default_rng(seed)
    detections = {}
    for scene in scenes:
        for f in range(scene.n_frames):
            token = scene.frame_token(f)
            inv = annos.inv_pose(token)
            rows = []
            for obj in scene.objects:
                box9 = scene.gt_box_global(obj, f)
                b7 = transform_box_np(box9[None, [0, 1, 2, 3, 4, 5, 8]], inv)[0]
                vel_v = box9[6:8] @ annos.pose(token)[:2, :2]
                # waymo -> detector convention (inverse of waymo_common.py:106-111)
                heading = -np.pi / 2 - b7[6]
                rows.append(
                    np.concatenate([b7[:3], [b7[4], b7[3], b7[5]], vel_v, [heading]])
                    + rng.normal(0, noise, 9) * np.array([1, 1, 0.2, 0.2, 0.2, 0.2, 0.1, 0.1, 0.05])
                )
            boxes = np.stack(rows)
            detections[token] = {
                "box3d_lidar": boxes.astype(np.float32),
                "scores": rng.uniform(0.8, 1.0, len(rows)).astype(np.float32),
                "label_preds": np.zeros(len(rows), np.int64),
            }
    return detections
