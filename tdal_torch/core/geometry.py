"""Box geometry in plain torch: port of ``tdal/core/geometry.py``.

Conventions as tdal's: boxes are [x, y, z, l, w, h, heading], z at the volumetric
center, heading counter-clockwise about +z. Detector-convention (det3d/KITTI) boxes
convert with ``kitti_to_waymo_box`` / ``waymo_to_kitti_box``. Poses are 4x4 rigid
transforms.
"""

from __future__ import annotations

import math

import torch

# Corner layout of reference box_np_ops.corners_nd (box_np_ops.py:55-86), as in
# tdal.core.geometry._CORNERS2D: (-,-), (-,+), (+,+), (+,-) in local half-dims.
_CORNERS2D = ((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5))
# 3D: the unravel ordering [0,1,3,2,4,5,7,6], bottom and top faces interleaved in z.
_CORNERS3D = ((-0.5, -0.5, -0.5), (-0.5, -0.5, 0.5), (-0.5, 0.5, 0.5), (-0.5, 0.5, -0.5),
              (0.5, -0.5, -0.5), (0.5, -0.5, 0.5), (0.5, 0.5, 0.5), (0.5, 0.5, -0.5))


def rot_mat_z(angle: torch.Tensor) -> torch.Tensor:
    """Counter-clockwise rotation matrix about +z: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def rotate_points_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate the first two lanes of (..., N, D>=2) points CCW by ``angle``
    (broadcastable to points.shape[:-1])."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y = points[..., 0], points[..., 1]
    return torch.cat(
        [torch.stack([c * x - s * y, s * x + c * y], dim=-1), points[..., 2:]], dim=-1
    )


def center_to_corner_box2d(centers, dims, angles=None) -> torch.Tensor:
    """BEV box -> 4 corners. centers/dims (..., 2), angles (...,) -> (..., 4, 2)."""
    unit = torch.tensor(_CORNERS2D, dtype=dims.dtype, device=dims.device)
    corners = dims[..., None, :] * unit
    if angles is not None:
        corners = rotate_points_z(corners, angles[..., None])
    return corners + centers[..., None, :]


def points_in_rbbox(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Half-space points-in-rotated-box test, batched over leading dims.

    points (..., N, D>=3), boxes (..., M, 7) -> bool (..., N, M). Same arithmetic as
    tdal.core.geometry.points_in_rbbox (reference box_np_ops.py:641-647)."""
    d = points[..., :, None, :3] - boxes[..., None, :, :3]  # (..., N, M, 3)
    c = torch.cos(boxes[..., 6])[..., None, :]
    s = torch.sin(boxes[..., 6])[..., None, :]
    lx = c * d[..., 0] + s * d[..., 1]
    ly = -s * d[..., 0] + c * d[..., 1]
    half = (boxes[..., 3:6] * 0.5)[..., None, :, :]
    return (
        (lx.abs() <= half[..., 0])
        & (ly.abs() <= half[..., 1])
        & (d[..., 2].abs() <= half[..., 2])
    )


def center_to_corner_box3d(centers, dims, angles=None) -> torch.Tensor:
    """3D box -> 8 corners. centers/dims (..., 3) (dims l, w, h), angles (...,) ->
    (..., 8, 3), in the corner layout of reference box_np_ops.center_to_corner_box3d
    (box_np_ops.py:241-262), rotated CCW."""
    unit = torch.tensor(_CORNERS3D, dtype=dims.dtype, device=dims.device)
    corners = dims[..., None, :] * unit
    if angles is not None:
        corners = rotate_points_z(corners, angles[..., None])
    return corners + centers[..., None, :]


def corner_to_standup(corners: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bounds of corners: (..., K, D) -> (..., 2 * D) [mins, maxes]."""
    return torch.cat([corners.amin(-2), corners.amax(-2)], -1)


def points_count_rbbox(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Points inside each box: points (N, D), boxes (M, 7) -> (M,) int32 (reference
    box_np_ops.points_count_rbbox, box_np_ops.py:15-20)."""
    return points_in_rbbox(points, boxes).sum(0).to(torch.int32)


def limit_period(val: torch.Tensor, offset: float = 0.5, period: float = math.pi):
    """val - floor(val / period + offset) * period (box_np_ops.py:360-361)."""
    return val - torch.floor(val / period + offset) * period


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """A 4x4 rigid transform of (..., N, D>=3) points; the lanes past xyz pass
    through."""
    xyz = points[..., :3] @ pose[:3, :3].T + pose[:3, 3]
    return torch.cat([xyz, points[..., 3:]], -1)


def transform_box(box: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """7-dof upright boxes (..., 7) by a 4x4 pose: center' = R center + t, heading' =
    heading + atan2(R[1,0], R[0,0]) (reference tools/static_model.py:574-588)."""
    heading = box[..., 6] + torch.atan2(pose[1, 0], pose[0, 0])
    center = box[..., :3] @ pose[:3, :3].T + pose[:3, 3]
    return torch.cat([center, box[..., 3:6], heading[..., None]], -1)


def transform_box_with_velocity(box: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """9-dof boxes (..., 9) = [x, y, z, l, w, h, vx, vy, heading] by a 4x4 pose; the
    velocity turns with R (reference tools/waymo_tracking/test.py:150-172)."""
    heading = box[..., 8] + torch.atan2(pose[1, 0], pose[0, 0])
    center = box[..., :3] @ pose[:3, :3].T + pose[:3, 3]
    vel3 = torch.cat([box[..., 6:8], torch.zeros_like(box[..., :1])], -1)
    vel = (vel3 @ pose[:3, :3].T)[..., :2]
    return torch.cat([center, box[..., 3:6], vel, heading[..., None]], -1)


def kitti_to_waymo_box(box: torch.Tensor) -> torch.Tensor:
    """Detector-convention box -> raw Waymo: heading' = -heading - pi/2, l and w
    swapped (reference waymo_common.py:106-111); 7-dof or 9-dof, heading last."""
    heading = -box[..., -1] - math.pi / 2.0
    mid = torch.cat([box[..., [4, 3]], box[..., 5:-1]], -1)
    return torch.cat([box[..., :3], mid, heading[..., None]], -1)


def waymo_to_kitti_box(box: torch.Tensor) -> torch.Tensor:
    """The inverse of ``kitti_to_waymo_box`` (the same map)."""
    return kitti_to_waymo_box(box)


def mask_points_in_range_bev(points: torch.Tensor, pc_range) -> torch.Tensor:
    """Points inside the axis-aligned range [x0, y0, z0, x1, y1, z1] -> bool (N,)."""
    r = torch.as_tensor(pc_range, dtype=points.dtype, device=points.device)
    m = (points[:, 0] >= r[0]) & (points[:, 0] <= r[3])
    m &= (points[:, 1] >= r[1]) & (points[:, 1] <= r[4])
    m &= (points[:, 2] >= r[2]) & (points[:, 2] <= r[5])
    return m


def center_in_range(boxes: torch.Tensor, pc_range) -> torch.Tensor:
    """Box centers inside the BEV rectangle [x0, y0, x1, y1] -> bool (N,) (reference
    CenterHead.post_processing, center_head.py:459-465)."""
    r = torch.as_tensor(pc_range, dtype=boxes.dtype, device=boxes.device)
    return ((boxes[:, 0] >= r[0]) & (boxes[:, 0] <= r[2])
            & (boxes[:, 1] >= r[1]) & (boxes[:, 1] <= r[3]))
