"""CenterPoint detectors: PointPillars and VoxelNet.

Port of ``tdal/models/detectors.py``. Both take raw padded points (B, N, D) and
voxelize on the device.

- ``PointPillars``: pillar feature net -> BEV scatter -> RPN -> CenterHead.
- ``VoxelNet``: voxel mean -> 3D middle backbone -> RPN -> CenterHead. The backbone is
  the sparse submanifold one (``scn_sparse``) where the grid has more than 2^24 cells
  (the Waymo grid: 40 x 1504 x 1504), else the dense one (``scn``), as tdal picks.

Train or eval follows ``module.training``; ``return_feature=True`` also returns the
RPN's BEV feature map, which the two-stage detector samples. ``dcn_head`` swaps each
task's SepHead for a ``DCNSepHead`` (``tdal_torch.models.dcn``).

``bev_sharding`` (tdal's field of the same name): a ``SpatialSharding`` of a mesh with a
spatial axis (``tdal_torch.parallel.mesh.spatial_sharding``), or None. Set, the dense
BEV stack is spatially partitioned over the mesh's spatial group: every rank builds the
whole canvas (PointPillars, after ``scatter_to_bev``) or the middle backbone's BEV output
(VoxelNet) from its frames and keeps its rows (``RowSlab.take``: the other rows get a
zero cotangent, so the reader's and backbone's gradient is summed once over the ranks),
the RPN and head run on the rows (hand halo exchanges, the conv kernels in their halo
form), and the head's maps (and the returned feature map) come back whole on every
rank. The row partition is that of the RPN's coarsest level (``spatial_slab``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from tdal_torch.core.voxel import VoxelConfig, voxelize_batch
from tdal_torch.models.center_head import COMMON_HEADS, CenterHead
from tdal_torch.models.readers import PillarFeatureNet, VoxelMeanEncoder, scatter_to_bev
from tdal_torch.models.rpn import RPN
from tdal_torch.models.scn import MiddleBackbone
from tdal_torch.models.scn_sparse import SparseMiddleBackbone
from tdal_torch.parallel.mesh import spatial_slab


def _dense_stack(rpn, head, bev, bev_sharding, return_feature: bool):
    """RPN + CenterHead on the BEV map, spatially partitioned under ``bev_sharding``."""
    if bev_sharding is None:
        x = rpn(bev)
        preds = head(x)
        return (preds, x) if return_feature else preds
    slab = spatial_slab(bev_sharding.mesh, bev.shape[1], int(np.prod(rpn.ds_layer_strides)))
    x = rpn(slab.take(bev), slab)
    out = rpn.out_slab(slab)
    preds = head(x, slab=out)
    return (preds, out.gather(x)) if return_feature else preds


class PointPillars(nn.Module):
    def __init__(self, voxel_cfg: VoxelConfig, tasks: Sequence[dict],
                 num_input_features: int = 5, num_filters: Sequence[int] = (64, 64),
                 rpn_layer_nums: Sequence[int] = (3, 5, 5),
                 rpn_ds_strides: Sequence[int] = (1, 2, 2),
                 rpn_ds_filters: Sequence[int] = (64, 128, 256),
                 rpn_us_strides: Sequence[int] = (1, 2, 4),
                 rpn_us_filters: Sequence[int] = (128, 128, 128),
                 with_velocity: bool = False, dcn_head: bool = False,
                 bev_sharding=None, dtype=torch.float32):
        super().__init__()
        self.voxel_cfg, self.bev_sharding = voxel_cfg, bev_sharding
        self.tasks = [dict(t) for t in tasks]
        self.with_velocity = with_velocity
        self.rpn_ds_strides, self.rpn_us_strides = tuple(rpn_ds_strides), tuple(rpn_us_strides)
        self.reader = PillarFeatureNet(
            num_input_features, num_filters, voxel_cfg.voxel_size,
            voxel_cfg.point_cloud_range, dtype=dtype)
        self.rpn = RPN(num_filters[-1], rpn_layer_nums, rpn_ds_strides, rpn_ds_filters,
                       rpn_us_strides, rpn_us_filters, dtype=dtype)
        common = dict(COMMON_HEADS)
        if with_velocity:
            common["vel"] = (2, 2)
        self.head = CenterHead(self.rpn.out_channels, self.tasks, common, dcn_head=dcn_head,
                               dtype=dtype)

    @property
    def out_size_factor(self) -> int:
        f = int(np.prod(self.rpn_ds_strides))
        return max(f // int(self.rpn_us_strides[-1]), 1)

    @property
    def num_classes(self):
        return [len(t["class_names"]) for t in self.tasks]

    def forward(self, points, return_feature: bool = False):
        voxels, coords, num_points, n_vox = voxelize_batch(points, self.voxel_cfg)
        feats = self.reader(voxels, num_points, coords)
        valid = torch.arange(feats.shape[1], device=feats.device)[None, :] < n_vox[:, None]
        nx, ny, _ = (int(g) for g in self.voxel_cfg.grid_size)
        canvas = scatter_to_bev(feats * valid[..., None], coords, valid, ny, nx)
        return _dense_stack(self.rpn, self.head, canvas, self.bev_sharding, return_feature)


class VoxelNet(nn.Module):
    def __init__(self, voxel_cfg: VoxelConfig, tasks: Sequence[dict],
                 num_input_features: int = 5, rpn_layer_nums: Sequence[int] = (5, 5),
                 rpn_ds_strides: Sequence[int] = (1, 2),
                 rpn_ds_filters: Sequence[int] = (128, 256),
                 rpn_us_strides: Sequence[int] = (1, 2),
                 rpn_us_filters: Sequence[int] = (256, 256),
                 with_velocity: bool = False, sparse_middle: bool = None,
                 dcn_head: bool = False, bev_sharding=None, dtype=torch.float32):
        super().__init__()
        self.voxel_cfg, self.bev_sharding = voxel_cfg, bev_sharding
        self.tasks = [dict(t) for t in tasks]
        self.with_velocity = with_velocity
        self.rpn_ds_strides, self.rpn_us_strides = tuple(rpn_ds_strides), tuple(rpn_us_strides)
        self.reader = VoxelMeanEncoder()
        nx, ny, nz = (int(g) for g in voxel_cfg.grid_size)
        if sparse_middle is None:
            sparse_middle = nz * ny * nx > 2**24
        middle = SparseMiddleBackbone if sparse_middle else MiddleBackbone
        self.backbone = middle((nz, ny, nx), num_input_features, dtype=dtype)
        self.rpn = RPN(self.backbone.out_channels, rpn_layer_nums, rpn_ds_strides,
                       rpn_ds_filters, rpn_us_strides, rpn_us_filters, dtype=dtype)
        common = dict(COMMON_HEADS)
        if with_velocity:
            common["vel"] = (2, 2)
        self.head = CenterHead(self.rpn.out_channels, self.tasks, common, dcn_head=dcn_head,
                               dtype=dtype)

    @property
    def out_size_factor(self) -> int:
        # the middle backbone downsamples the BEV by 8, the RPN by its net factor
        f = 8 * int(np.prod(self.rpn_ds_strides))
        return max(f // int(self.rpn_us_strides[-1]), 1)

    @property
    def num_classes(self):
        return [len(t["class_names"]) for t in self.tasks]

    def forward(self, points, return_feature: bool = False):
        voxels, coords, num_points, n_vox = voxelize_batch(points, self.voxel_cfg)
        feats = self.reader(voxels, num_points)
        valid = torch.arange(feats.shape[1], device=feats.device)[None, :] < n_vox[:, None]
        bev = self.backbone(feats * valid[..., None], coords, valid)
        return _dense_stack(self.rpn, self.head, bev, self.bev_sharding, return_feature)
