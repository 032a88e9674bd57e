"""Box geometry in plain torch: the parts of ``tdal/core/geometry.py`` that the track
crop and the labeler metrics need.

Conventions as tdal's: boxes are [x, y, z, l, w, h, heading], z at the volumetric
center, heading counter-clockwise about +z.
"""

from __future__ import annotations

import torch

# Corner layout of reference box_np_ops.corners_nd (box_np_ops.py:55-86), as in
# tdal.core.geometry._CORNERS2D: (-,-), (-,+), (+,+), (+,-) in local half-dims.
_CORNERS2D = ((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5))


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
