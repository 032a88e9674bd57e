"""Voxelization / pillarization in plain PyTorch on the device, static shapes.

Port of ``tdal/core/voxel.py``. Points are hashed to grid cells with one flat stable
sort; each voxel's points are then a contiguous run of the sorted array, and the
dense ``(max_voxels, max_points, D)`` buffer is gathered from those runs. Semantics
(the reference's ``points_to_voxel``, point_cloud_ops.py:8-55):

- out-of-range and non-finite (NaN-padded) points are dropped;
- at most ``max_points`` points per voxel, first-come in point order;
- at most ``max_voxels`` voxels, clamped to the padded point count;
- coordinates are (z, y, x) integer indices; empty slots are -1.

The sort key is ``batch * (cells + 1) + cell`` in int64, so voxels come out in tdal's
order, batch-major, cell-sorted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    point_cloud_range: tuple  # (x0, y0, z0, x1, y1, z1)
    voxel_size: tuple  # (vx, vy, vz)
    max_points_per_voxel: int
    max_voxels: int

    @property
    def grid_size(self) -> np.ndarray:
        """(nx, ny, nz)."""
        pc = np.asarray(self.point_cloud_range)
        vs = np.asarray(self.voxel_size)
        return np.round((pc[3:] - pc[:3]) / vs).astype(np.int64)


def voxelize_batch(points, cfg: VoxelConfig):
    """points (B, N, D) (NaN rows = padding) -> (voxels (B, V, P, D), coords (B, V, 3)
    zyx int64, num_points (B, V) int64, n_voxels (B,) int64), V = min(max_voxels, N)."""
    b, n, d = points.shape
    dev, dt = points.device, points.dtype
    nx, ny, nz = (int(g) for g in cfg.grid_size)
    big = nx * ny * nz  # the cell of dropped points
    max_points = cfg.max_points_per_voxel
    max_voxels = min(cfg.max_voxels, n)
    pc3 = torch.tensor(cfg.point_cloud_range[:3], dtype=dt, device=dev)
    vs3 = torch.tensor(cfg.voxel_size, dtype=dt, device=dev)

    finite = torch.isfinite(points[..., :3]).all(dim=-1)
    rel = (points[..., :3] - pc3) / vs3
    idx = torch.floor(torch.where(finite[..., None], rel, -1.0)).long()
    valid = (
        finite
        & (idx[..., 0] >= 0) & (idx[..., 0] < nx)
        & (idx[..., 1] >= 0) & (idx[..., 1] < ny)
        & (idx[..., 2] >= 0) & (idx[..., 2] < nz)
    )
    cell = idx[..., 2] * (ny * nx) + idx[..., 1] * nx + idx[..., 0]
    cell = torch.where(valid, cell, big)
    offset = (big + 1) * torch.arange(b, device=dev)[:, None]
    order = torch.argsort((cell + offset).reshape(-1), stable=True)
    cell_s = (cell + offset).reshape(-1)[order].reshape(b, n) - offset
    pts_s = points.reshape(-1, d)[order].reshape(b, n, d)
    valid_s = cell_s < big

    first = torch.cat(
        [torch.ones(b, 1, dtype=torch.bool, device=dev), cell_s[:, 1:] != cell_s[:, :-1]],
        dim=1) & valid_s
    vox_id = torch.cumsum(first.long(), dim=1) - 1
    pos = torch.arange(n, device=dev).expand(b, n)
    slot = torch.where(first & (vox_id < max_voxels), vox_id, max_voxels)
    voxel_start = torch.zeros(b, max_voxels + 1, dtype=torch.long, device=dev)
    voxel_start = voxel_start.scatter(1, slot, pos)[:, :max_voxels]
    n_valid_pts = valid_s.sum(dim=1)
    n_voxels = first.sum(dim=1).clamp_max(max_voxels)
    vslots = torch.arange(max_voxels, device=dev)
    voxel_valid = vslots[None, :] < n_voxels[:, None]
    next_start = torch.where(vslots[None, :] + 1 < n_voxels[:, None],
                             torch.roll(voxel_start, -1, dims=1), n_valid_pts[:, None])
    num_points = torch.where(voxel_valid, (next_start - voxel_start).clamp_max(max_points), 0)

    # slab gather: voxel v holds pts_s[start : start + P]; P zero rows of padding keep
    # every slab in range
    pts_pad = torch.cat([pts_s, torch.zeros(b, max_points, d, dtype=dt, device=dev)], 1)
    rows = voxel_start[:, :, None] + torch.arange(max_points, device=dev)
    slabs = torch.gather(pts_pad, 1, rows.reshape(b, -1, 1).expand(-1, -1, d))
    slabs = slabs.reshape(b, max_voxels, max_points, d)
    in_voxel = torch.arange(max_points, device=dev) < num_points[..., None]
    voxels = torch.where(in_voxel[..., None], slabs, torch.zeros((), dtype=dt, device=dev))

    # coords (z, y, x) from each voxel's first point: the same float ops on the same
    # values as the pre-sort index
    fidx = torch.floor((voxels[:, :, 0, :3] - pc3) / vs3).long()
    coords = torch.where(voxel_valid[..., None], fidx.flip(-1), -1)
    return voxels, coords, num_points, n_voxels


def pad_points(points: np.ndarray, n: int) -> np.ndarray:
    """Host-side: pad/truncate a point cloud to exactly n rows with NaN padding."""
    out = np.full((n, points.shape[1]), np.nan, points.dtype)
    m = min(n, points.shape[0])
    out[:m] = points[:m]
    return out
