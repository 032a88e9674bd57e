"""Detection data pipeline: point loading, augmentation, target assignment.

Port of ``tdal/data/detection.py`` (host-side numpy, the same draws from the same
seed): point loading with tanh-normalised intensity and the multi-sweep merge
(reference loading.py:61-172), the train-time augmentations (double random flip,
global rotation / scaling / translation, preprocess.py:771-963), class and range
filtering, point shuffling, and CenterNet targets (``tdal_torch.core.targets``).
Frames come out as fixed-shape NaN-padded point clouds; voxelization runs on the
device inside the detector. Points are read from a frame's ``.tdc`` cache
(``tdal_torch.data.frame_cache``) where one was built, else from its pickle. With a
``db_sampler`` (``tdal_torch.data.gt_augment.DBSampler``) training frames get GT-aug:
sampled database objects, boxes and points, pasted before the global augmentations.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from tdal_torch.core.targets import AssignerConfig, assign_centernet_targets
from tdal_torch.core.voxel import VoxelConfig, pad_points
from tdal_torch.data.waymo_schema import load_pickle
from tdal_torch.runtime.tracing import timed

TYPE_LIST = ["UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST"]


# ---------------------------------------------------------------------------
# Augmentations (host-side numpy; parity with core/sampler/preprocess.py numba)
# ---------------------------------------------------------------------------


def random_flip_both(gt_boxes, points, rng, probability=0.5):
    """Parity: preprocess.py:803-833 (independent x and y flips)."""
    if rng.random() < probability:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + np.pi
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    if rng.random() < probability:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        points[:, 0] = -points[:, 0]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + 2 * np.pi
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 6] = -gt_boxes[:, 6]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rng, rotation=(-np.pi / 4, np.pi / 4)):
    """Parity: preprocess.py:771-789. The det3d rotation convention is CLOCKWISE for
    positive angles (box_np_ops.rotation_points_single_angle; SURVEY.md geometry
    notes), which is what makes `rot += noise` consistent for the negated-yaw
    detector heading: yaw' = yaw - noise  =>  rot' = -pi/2 - yaw' = rot + noise."""
    noise = rng.uniform(rotation[0], rotation[1])
    c, s = np.cos(noise), np.sin(noise)
    rot = np.array([[c, s], [-s, c]])  # clockwise
    points[:, :2] = points[:, :2] @ rot.T
    gt_boxes[:, :2] = gt_boxes[:, :2] @ rot.T
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 6:8] = gt_boxes[:, 6:8] @ rot.T
    gt_boxes[:, -1] += noise
    return gt_boxes, points


def global_scaling_v2(gt_boxes, points, rng, min_scale=0.95, max_scale=1.05):
    """Parity: preprocess.py:835-839."""
    noise = rng.uniform(min_scale, max_scale)
    points[:, :3] *= noise
    gt_boxes[:, :-1] *= noise
    return gt_boxes, points


def global_translate(gt_boxes, points, rng, noise_translate_std=0.0):
    """Parity: preprocess.py:940-963."""
    if (
        isinstance(noise_translate_std, (int, float))
        and noise_translate_std == 0
    ):
        return gt_boxes, points
    std = np.broadcast_to(np.asarray(noise_translate_std, float), (3,))
    t = rng.normal(0.0, std)
    points[:, :3] += t
    gt_boxes[:, :3] += t
    return gt_boxes, points


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def _load_frame_points(path) -> np.ndarray:
    """[xyz, tanh(intensity), elongation] for one frame: its .tdc cache where
    ``tdal_torch.data.frame_cache.build_cache`` wrote one, else its pickle."""
    from tdal_torch.data.frame_cache import read_frame_points

    cached = read_frame_points(path)
    if cached is not None:
        return cached
    obj = load_pickle(path)
    xyz = np.asarray(obj["lidars"]["points_xyz"], np.float32)
    feat = np.array(obj["lidars"]["points_feature"], np.float32)
    feat[:, 0] = np.tanh(feat[:, 0])
    return np.concatenate([xyz, feat], axis=1)


def read_points(info: dict, nsweeps: int = 1) -> np.ndarray:
    """Lidar points in the reference frame with tanh-normalized intensity; multi-sweep
    concat adds a time-lag channel. Parity: loading.py:61-172. The earlier sweeps'
    reading and merging is the host timer ``data.sweeps`` (``runtime/tracing.py``), one
    count a frame."""
    points = _load_frame_points(info["path"])
    if nsweeps <= 1:
        return points
    clouds = [points]
    times = [np.zeros((points.shape[0], 1), np.float32)]
    with timed("data.sweeps"):
        for sweep in info["sweeps"][: nsweeps - 1]:
            spts = _load_frame_points(sweep["path"])
            sxyz = spts[:, :3].copy()
            sfeat = spts[:, 3:]
            if sweep["transform_matrix"] is not None:
                # in float64, written back as float32 as det3d's read_sweep writes them
                tm = np.asarray(sweep["transform_matrix"])
                sxyz = (sxyz @ tm[:3, :3].T + tm[:3, 3]).astype(np.float32)
            clouds.append(np.concatenate([sxyz, sfeat], axis=1))
            times.append(
                np.full((sxyz.shape[0], 1), sweep["time_lag"], np.float32)
            )
    return np.concatenate(
        [np.concatenate(clouds, 0), np.concatenate(times, 0)], axis=1
    )


def read_gt(info: dict) -> Dict[str, np.ndarray]:
    """GT boxes in detector (KITTI) convention + names.

    Prefers precomputed info['gt_boxes'] (infos builder output), else derives from the
    anno pickle with the Waymo->KITTI conversion and zero-point filtering
    (waymo_common.py:376-396)."""
    if "gt_boxes" in info:
        return {"boxes": np.asarray(info["gt_boxes"], np.float32),
                "names": np.asarray(info["gt_names"])}
    anno = load_pickle(info["anno_path"])
    objs = anno["objects"]
    if not objs:
        return {"boxes": np.zeros((0, 9), np.float32), "names": np.zeros((0,), dtype="<U10")}
    boxes = np.array([o["box"] for o in objs], np.float32).reshape(-1, 9)
    boxes[:, -1] = -np.pi / 2 - boxes[:, -1]
    boxes[:, [3, 4]] = boxes[:, [4, 3]]
    names = np.array([TYPE_LIST[o["label"]] for o in objs])
    num_pts = np.array([o.get("num_points", 1) for o in objs])
    keep = num_pts > 0
    return {"boxes": boxes[keep], "names": names[keep]}


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


class DetectionDataset:
    """Per-frame detection samples with fixed-shape padded points + CenterNet targets
    (WaymoDataset + its pipeline, datasets/waymo/waymo.py:18-104), with the GT-aug
    ``db_sampler`` where one is given."""

    def __init__(
        self,
        infos: List[dict],
        class_names: Sequence[str],
        assigner: AssignerConfig,
        voxel_cfg: VoxelConfig,
        mode: str = "train",
        nsweeps: int = 1,
        max_points: int = 200000,
        global_rot_noise=(-0.78539816, 0.78539816),
        global_scale_noise=(0.95, 1.05),
        global_translate_std=0.0,
        shuffle_points: bool = True,
        seed: int = 0,
        db_sampler=None,
    ):
        self.infos = infos
        self.class_names = list(class_names)
        self.assigner = assigner
        self.voxel_cfg = voxel_cfg
        self.mode = mode
        self.nsweeps = nsweeps
        self.max_points = max_points
        self.global_rot_noise = global_rot_noise
        self.global_scale_noise = global_scale_noise
        self.global_translate_std = global_translate_std
        self.shuffle_points = shuffle_points
        self.rng = np.random.default_rng(seed)
        self.db_sampler = db_sampler

    def __len__(self):
        return len(self.infos)

    # Subclass hooks (``tdal_torch.data.nuscenes.NuScenesDataset`` reads its own schema)
    def _read_points(self, info) -> np.ndarray:
        return read_points(info, self.nsweeps)

    def _read_gt(self, info) -> Dict[str, np.ndarray]:
        return read_gt(info)

    def __getitem__(self, index: int) -> dict:
        info = self.infos[index]
        points = self._read_points(info)
        item = {"token": info["token"]}

        if self.mode == "train":
            gt = self._read_gt(info)
            keep = np.array(
                [n in self.class_names for n in gt["names"]], bool
            )
            boxes, names = gt["boxes"][keep].copy(), gt["names"][keep]

            if self.db_sampler is not None:
                sampled = self.db_sampler.sample_all(boxes, names, self.rng)
                if sampled is not None:
                    boxes = np.concatenate([boxes, sampled["gt_boxes"]], axis=0)
                    names = np.concatenate([names, sampled["gt_names"]], axis=0)
                    # the pasted points first, zero-padded to the frame's feature width
                    spts = sampled["points"]
                    width = points.shape[1]
                    if spts.shape[1] < width:
                        spts = np.concatenate(
                            [spts, np.zeros((len(spts), width - spts.shape[1]), np.float32)],
                            axis=1)
                    points = np.concatenate([spts[:, :width], points], axis=0)

            boxes, points = random_flip_both(boxes, points, self.rng)
            boxes, points = global_rotation(boxes, points, self.rng, self.global_rot_noise)
            boxes, points = global_scaling_v2(boxes, points, self.rng, *self.global_scale_noise)
            boxes, points = global_translate(boxes, points, self.rng, self.global_translate_std)

            # Filter boxes outside BEV range (pipelines/preprocess.py:184-188).
            pcr = np.asarray(self.voxel_cfg.point_cloud_range)
            in_range = (
                (boxes[:, 0] >= pcr[0]) & (boxes[:, 0] <= pcr[3])
                & (boxes[:, 1] >= pcr[1]) & (boxes[:, 1] <= pcr[4])
            )
            boxes, names = boxes[in_range], names[in_range]
            classes = np.array(
                [self.class_names.index(n) + 1 for n in names], np.int32
            )
            targets = assign_centernet_targets(
                boxes,
                classes,
                self.assigner,
                self.voxel_cfg.grid_size,
                self.voxel_cfg.point_cloud_range,
                self.voxel_cfg.voxel_size,
            )
            item.update(targets)

        if self.shuffle_points and self.mode == "train":
            # the rows of rng.shuffle(points), from the same draws, in one gather
            # (shuffling a 2-D array in place moves one row at a time: 20x slower)
            points = points[self.rng.permutation(len(points))]
        item["points"] = pad_points(points, self.max_points)
        return item


def collate_detection(items: List[dict]) -> dict:
    """Stack detection items into batch-major arrays; per-task target lists become
    lists of stacked (B, ...) arrays."""
    out = {"token": [it["token"] for it in items]}
    out["points"] = np.stack([it["points"] for it in items])
    if "hm" in items[0]:
        n_tasks = len(items[0]["hm"])
        for key in ("hm", "anno_box", "ind", "mask", "cat"):
            out[key] = [
                np.stack([it[key][t] for it in items]) for t in range(n_tasks)
            ]
        out["gt_boxes_and_cls"] = np.stack(
            [it["gt_boxes_and_cls"] for it in items]
        )
    return out
