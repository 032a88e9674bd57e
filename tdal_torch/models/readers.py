"""Point-cloud readers: PointPillars' pillar feature net and BEV scatter, VoxelNet's
voxel mean.

Port of ``tdal/models/readers.py`` (``PFNLayer``, ``PillarFeatureNet``,
``VoxelMeanEncoder``, ``scatter_to_bev``). Batch-major (B, V, P, C); padded points and
pillars are masked out of the BatchNorm statistics, the per-pillar max and the mean.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tdal_torch.models.layers import MaskedBatchNorm


class PFNLayer(nn.Module):
    """Linear (no bias) + masked BN + ReLU + per-pillar max; non-last layers concat the
    max back onto every point. ``linear`` / ``norm`` are flax's ``Dense_0`` /
    ``MaskedBatchNorm_0``."""

    def __init__(self, in_features: int, out_features: int, last: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.last, self.dtype = last, dtype
        units = out_features if last else out_features // 2
        self.linear = nn.Linear(in_features, units, bias=False)
        self.norm = MaskedBatchNorm(units, dtype=dtype)

    def forward(self, x, point_mask):
        x = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype))
        x = torch.relu(self.norm(x, point_mask))
        x = x * point_mask[..., None]
        x_max = x.amax(dim=-2, keepdim=True)
        if self.last:
            return x_max[..., 0, :]
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarFeatureNet(nn.Module):
    """voxels (B, V, P, D), num_points (B, V), coords (B, V, 3 zyx) -> (B, V, C).

    Each point is decorated with its offset from the pillar's point mean (+3) and from
    the pillar centre in x, y (+2) before the PFN layers."""

    def __init__(self, num_input_features: int = 5, num_filters: Sequence[int] = (64,),
                 voxel_size: Sequence[float] = (0.2, 0.2, 4.0),
                 pc_range: Sequence[float] = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
                 dtype=torch.float32):
        super().__init__()
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        widths = [num_input_features + 5, *num_filters]
        self.pfn_layers = nn.ModuleList(
            PFNLayer(a, f, last=(i == len(num_filters) - 1), dtype=dtype)
            for i, (a, f) in enumerate(zip(widths, num_filters))
        )

    def forward(self, voxels, num_points, coords):
        p = voxels.shape[2]
        dt = voxels.dtype
        denom = num_points.clamp_min(1).to(dt)[..., None]
        point_mask = (torch.arange(p, device=voxels.device) < num_points[..., None]).to(dt)
        voxels = voxels * point_mask[..., None]
        points_mean = voxels[..., :3].sum(dim=-2, keepdim=True) / denom[..., None]
        f_cluster = voxels[..., :3] - points_mean
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        cx = coords[..., 2].to(dt) * vx + (vx / 2.0 + self.pc_range[0])
        cy = coords[..., 1].to(dt) * vy + (vy / 2.0 + self.pc_range[1])
        f_center = torch.stack(
            [voxels[..., 0] - cx[..., None], voxels[..., 1] - cy[..., None]], dim=-1)
        x = torch.cat([voxels, f_cluster, f_center], dim=-1) * point_mask[..., None]
        for layer in self.pfn_layers:
            x = layer(x, point_mask)
        return x


class VoxelMeanEncoder(nn.Module):
    """The mean of the points in each voxel (reference VoxelFeatureExtractorV3):
    voxels (B, V, P, D), num_points (B, V) -> (B, V, D); no parameters."""

    def forward(self, voxels, num_points):
        p = voxels.shape[-2]
        mask = (torch.arange(p, device=voxels.device) < num_points[..., None]).to(voxels.dtype)
        s = (voxels * mask[..., None]).sum(dim=-2)
        return s / num_points.clamp_min(1).to(voxels.dtype)[..., None]


def scatter_to_bev(features, coords, valid, ny: int, nx: int):
    """features (B, V, C), coords (B, V, 3 zyx), valid (B, V) bool -> canvas
    (B, ny, nx, C), one batched scatter. Invalid rows go to a dropped slot."""
    b, _, c = features.shape
    lin = torch.where(valid, coords[..., 1] * nx + coords[..., 2], ny * nx)
    canvas = torch.zeros(b, ny * nx + 1, c, dtype=features.dtype, device=features.device)
    canvas = canvas.scatter(1, lin[..., None].expand(-1, -1, c), features)
    return canvas[:, : ny * nx].reshape(b, ny, nx, c)
