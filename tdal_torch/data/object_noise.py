"""Per-object noise augmentation and BEV occupancy maps: port of
``tdal/data/object_noise.py`` (plain numpy, the same draws from the same generator).

``noise_per_object``: each GT box tries up to ``num_try`` random (translation,
rotation) perturbations and keeps the first that collides with no other (possibly
already perturbed) box; its points move rigidly with it. ``points_to_bev``: a BEV
occupancy map, with the largest height per cell.
"""

from __future__ import annotations

import numpy as np

from tdal_torch.data.gt_augment import box_collision_test
from tdal_torch.data.waymo_schema import points_in_rbbox_np, rotz_np


def noise_per_object(
    gt_boxes: np.ndarray,
    points: np.ndarray = None,
    rng=None,
    rotation_perturb=np.pi / 4,
    center_noise_std=1.0,
    num_try: int = 5,
):
    """In-place-style per-object perturbation. gt_boxes (N, >=7) detector convention
    (dims at 3:5, heading last); points (M, D) or None. Returns (gt_boxes, points)."""
    rng = rng or np.random.default_rng(0)
    n = len(gt_boxes)
    if n == 0:
        return gt_boxes, points
    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if not isinstance(center_noise_std, (list, tuple, np.ndarray)):
        center_noise_std = [center_noise_std] * 3

    gt_boxes = np.array(gt_boxes, np.float64)
    points = None if points is None else np.array(points)
    loc_noises = rng.normal(scale=center_noise_std, size=(n, num_try, 3))
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1], (n, num_try))

    # geometric box7 for the point-in-box test (undo the detector w/l swap)
    def as_geo(b):
        g = b[..., [0, 1, 2, 4, 3, 5, -1]].copy()
        g[..., 6] = -np.pi / 2 - g[..., 6]
        return g

    if points is not None:
        inside = points_in_rbbox_np(points, as_geo(gt_boxes))

    for i in range(n):
        others = np.delete(gt_boxes, i, axis=0)
        for t in range(num_try):
            cand = gt_boxes[i].copy()
            cand[:3] += loc_noises[i, t]
            cand[-1] += rot_noises[i, t]
            if len(others) and box_collision_test(cand[None], others).any():
                continue
            if points is not None:
                sel = inside[:, i]
                center = gt_boxes[i, :3].copy()
                rel = points[sel, :3] - center
                rot = rotz_np(-rot_noises[i, t])  # detector heading is negated yaw
                points[sel, :3] = rel @ rot.T + center + loc_noises[i, t]
            gt_boxes[i] = cand
            break
    return gt_boxes, points


def points_to_bev(
    points: np.ndarray,
    pc_range,
    voxel_size,
    with_height: bool = True,
):
    """Points -> BEV occupancy (+ max-height) map. (ny, nx, 1|2) float32."""
    pc_range = np.asarray(pc_range, np.float64)
    voxel_size = np.asarray(voxel_size, np.float64)
    nx = int(round((pc_range[3] - pc_range[0]) / voxel_size[0]))
    ny = int(round((pc_range[4] - pc_range[1]) / voxel_size[1]))
    ix = np.floor((points[:, 0] - pc_range[0]) / voxel_size[0]).astype(int)
    iy = np.floor((points[:, 1] - pc_range[1]) / voxel_size[1]).astype(int)
    ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    ok &= (points[:, 2] >= pc_range[2]) & (points[:, 2] <= pc_range[5])
    occ = np.zeros((ny, nx), np.float32)
    occ[iy[ok], ix[ok]] = 1.0
    if not with_height:
        return occ[..., None]
    hmax = np.full((ny, nx), pc_range[2], np.float32)
    np.maximum.at(hmax, (iy[ok], ix[ok]), points[ok, 2].astype(np.float32))
    return np.stack([occ, hmax], axis=-1)
