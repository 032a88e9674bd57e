"""GT augmentation: the ground-truth object database and its class-balanced sampler:
port of ``tdal/data/gt_augment.py`` (plain numpy, the same draws from the same seed
and the same bytes on disk).

- ``create_groundtruth_database`` crops each GT object's points (relative to its box
  centre) into ``<db>/<class>/<frame index>_<class>_<box index>.bin`` and writes the
  dbinfos pickle, keeping tdal's Waymo storage subsampling: VEHICLE boxes only from
  every 4th frame, PEDESTRIAN boxes only from every 2nd.
- ``DBSampler`` pastes, for each class, the deficit to its sample group's count,
  drawn without replacement from an epoch-shuffled list (``_BatchSampler``) and
  rejected where it collides in BEV with a box of the frame or one already kept, after
  the min-points and difficulty filters. Every draw comes from the generator seeded at
  construction: ``sample_all``'s ``rng`` argument is never read, as in tdal.
- ``box_collision_test``: a separating-axis test on BEV rectangles with a 1e-9 margin.
- ``build_db_sampler`` builds the sampler from a config's ``db_sampler`` block, or
  returns None when the block is off or its dbinfos file is missing.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from tdal_torch.data.detection import read_gt, read_points
from tdal_torch.data.waymo_schema import points_in_rbbox_np


# ---------------------------------------------------------------------------
# BEV collision test (separating-axis theorem on rotated rectangles)
# ---------------------------------------------------------------------------


def _bev_corners(boxes: np.ndarray) -> np.ndarray:
    """boxes (N, >=7) detector convention [x, y, z, w, l, h, ..., rot] ->
    (N, 4, 2) BEV corners. Uses dims at 3:5, heading last."""
    n = boxes.shape[0]
    dims = boxes[:, 3:5]
    ang = boxes[:, -1]
    local = np.array(
        [[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]]
    )[None] * dims[:, None, :]
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)  # (N,2,2)
    return np.einsum("nij,nkj->nki", rot, local) + boxes[:, None, :2]


def box_collision_test(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise BEV overlap test via SAT. boxes (N,.)/(M,.) -> bool (N, M)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), bool)
    ca = _bev_corners(boxes_a)  # (N, 4, 2)
    cb = _bev_corners(boxes_b)  # (M, 4, 2)

    def axes(corners):
        e = np.roll(corners, -1, axis=1) - corners  # (K, 4, 2)
        ax = np.stack([-e[..., 1], e[..., 0]], axis=-1)
        return ax / (np.linalg.norm(ax, axis=-1, keepdims=True) + 1e-12)

    axes_all = np.concatenate(
        [
            np.broadcast_to(axes(ca)[:, None], (len(ca), len(cb), 4, 2)),
            np.broadcast_to(axes(cb)[None], (len(ca), len(cb), 4, 2)),
        ],
        axis=2,
    )  # (N, M, 8, 2)
    pa = np.einsum("nmax,nkx->nmak", axes_all, ca)  # project A corners
    pb = np.einsum("nmax,mkx->nmak", axes_all, cb)
    sep = (pa.max(-1) < pb.min(-1) - 1e-9) | (pb.max(-1) < pa.min(-1) - 1e-9)
    return ~sep.any(-1)


# ---------------------------------------------------------------------------
# GT database creation
# ---------------------------------------------------------------------------


def create_groundtruth_database(
    infos: List[dict],
    root_path: str | os.PathLike,
    used_classes: Optional[Sequence[str]] = None,
    nsweeps: int = 1,
    db_path=None,
    dbinfo_path=None,
    waymo_subsample: bool = True,
):
    """Crop per-object points into db .bin files + dbinfos pickle."""
    root_path = Path(root_path)
    if db_path is None:
        db_path = root_path / f"gt_database_{nsweeps}sweeps_withvelo"
    if dbinfo_path is None:
        dbinfo_path = root_path / f"dbinfos_train_{nsweeps}sweeps_withvelo.pkl"
    db_path = Path(db_path)
    db_path.mkdir(parents=True, exist_ok=True)
    point_features = 5 if nsweeps == 1 else 6

    all_db_infos: Dict[str, list] = {}
    for index, info in enumerate(infos):
        points = read_points(info, nsweeps)
        gt = read_gt(info)
        gt_boxes, names = gt["boxes"], gt["names"]
        if waymo_subsample:
            # tdal's storage subsampling
            if index % 4 != 0:
                keep = names != "VEHICLE"
                gt_boxes, names = gt_boxes[keep], names[keep]
            if index % 2 != 0:
                keep = names != "PEDESTRIAN"
                gt_boxes, names = gt_boxes[keep], names[keep]
        if len(gt_boxes) == 0:
            continue
        inside = points_in_rbbox_np(
            points, gt_boxes[:, [0, 1, 2, 3, 4, 5, 8]]
        )
        for i in range(len(gt_boxes)):
            if used_classes is not None and names[i] not in used_classes:
                continue
            filename = f"{index}_{names[i]}_{i}.bin"
            (db_path / names[i]).mkdir(exist_ok=True)
            gt_points = points[inside[:, i]].astype(np.float32).copy()
            gt_points[:, :3] -= gt_boxes[i, :3]
            gt_points[:, :point_features].tofile(db_path / names[i] / filename)
            all_db_infos.setdefault(names[i], []).append(
                {
                    "name": names[i],
                    "path": str(Path(db_path.name) / names[i] / filename),
                    "image_idx": index,
                    "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": int(inside[:, i].sum()),
                    "difficulty": 0,
                }
            )
    with open(dbinfo_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return all_db_infos


# ---------------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------------


class _BatchSampler:
    """Epoch-shuffled draws without replacement; a new permutation when the next
    ``num`` would reach the list's end."""

    def __init__(self, sampled_list, rng):
        self._list = sampled_list
        self._rng = rng
        self._idx = rng.permutation(len(sampled_list))
        self._pos = 0

    def sample(self, num):
        if self._pos + num >= len(self._list):
            self._idx = self._rng.permutation(len(self._list))
            self._pos = 0
        out = [self._list[i] for i in self._idx[self._pos : self._pos + num]]
        self._pos += num
        return out


class DBSampler:
    """Class-balanced GT-paste sampler with the database's min-points and difficulty
    filters (``tdal.data.gt_augment.DBSampler``)."""

    def __init__(
        self,
        dbinfos: Dict[str, list],
        root_path: str | os.PathLike,
        sample_groups: Dict[str, int],
        min_points: Optional[Dict[str, int]] = None,
        filter_difficulty: Optional[Sequence[int]] = None,
        point_features: int = 5,
        rate: float = 1.0,
        seed: int = 0,
    ):
        self.root_path = Path(root_path)
        self.rate = rate
        self.point_features = point_features
        rng = np.random.default_rng(seed)
        self._infos = {}
        for name, infos in dbinfos.items():
            if min_points and name in min_points:
                infos = [i for i in infos if i["num_points_in_gt"] >= min_points[name]]
            if filter_difficulty:
                infos = [i for i in infos if i["difficulty"] not in filter_difficulty]
            if infos:
                self._infos[name] = _BatchSampler(infos, rng)
        self.sample_groups = {
            k: v for k, v in sample_groups.items() if k in self._infos
        }

    def sample_all(self, gt_boxes: np.ndarray, gt_names, rng) -> Optional[dict]:
        """gt_boxes (N, 9) detector convention. Returns dict with sampled gt_boxes,
        gt_names, points — or None if nothing sampled. ``rng`` is not read: every
        draw comes from the generator seeded at construction."""
        avoid = gt_boxes.reshape(-1, gt_boxes.shape[-1] if len(gt_boxes) else 9)
        sampled_infos = []
        sampled_boxes = []
        for name, max_num in self.sample_groups.items():
            deficit = int(
                np.round(self.rate * (max_num - int(np.sum(np.asarray(gt_names) == name))))
            )
            if deficit <= 0:
                continue
            cands = self._infos[name].sample(deficit)
            cand_boxes = np.stack([c["box3d_lidar"] for c in cands]).astype(np.float64)
            # collision rejection against existing + kept boxes
            kept = []
            pool = avoid.copy()
            for j, cb in enumerate(cand_boxes):
                if len(pool) and box_collision_test(cb[None], pool).any():
                    continue
                kept.append(j)
                pool = np.concatenate([pool, cb[None]], axis=0)
            if not kept:
                continue
            for j in kept:
                sampled_infos.append(cands[j])
            sampled_boxes.append(cand_boxes[kept])
            avoid = pool
        if not sampled_infos:
            return None
        boxes = np.concatenate(sampled_boxes, axis=0)
        pts_list = []
        for info in sampled_infos:
            pts = np.fromfile(
                self.root_path / info["path"], dtype=np.float32
            ).reshape(-1, self.point_features)
            pts = pts.copy()
            pts[:, :3] += np.asarray(info["box3d_lidar"][:3], np.float32)
            pts_list.append(pts)
        return {
            "gt_names": np.array([i["name"] for i in sampled_infos]),
            "gt_boxes": boxes.astype(np.float32),
            "points": np.concatenate(pts_list, axis=0),
            "gt_masks": np.ones(len(sampled_infos), bool),
        }


def build_db_sampler(cfg_db: dict, point_features: int = 5, seed: int = 0):
    """Build a DBSampler from the config's db_sampler block (configs/waymo/**).

    Returns None when disabled or when the dbinfos pickle doesn't exist yet: GT-aug is
    an optional training enhancement, as in tdal."""
    if not cfg_db or not cfg_db.get("enable", False):
        return None
    db_info_path = Path(cfg_db["db_info_path"])
    if not db_info_path.exists():
        return None
    with open(db_info_path, "rb") as f:
        dbinfos = pickle.load(f)
    sample_groups: Dict[str, int] = {}
    for g in cfg_db.get("sample_groups", []):
        sample_groups.update(g)
    min_points, filter_difficulty = None, None
    for step in cfg_db.get("db_prep_steps", []):
        if "filter_by_min_num_points" in step:
            min_points = dict(step["filter_by_min_num_points"])
        if "filter_by_difficulty" in step:
            filter_difficulty = list(step["filter_by_difficulty"])
    return DBSampler(
        dbinfos,
        db_info_path.parent,
        sample_groups=sample_groups,
        min_points=min_points,
        filter_difficulty=filter_difficulty,
        point_features=point_features,
        rate=float(cfg_db.get("rate", 1.0)),
        seed=seed,
    )
