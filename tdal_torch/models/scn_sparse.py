"""Sparse submanifold VoxelNet middle backbone: the full-resolution spconv path.

Port of ``tdal/models/scn_sparse.py`` (reference ``SpMiddleResNetFHD``, det3d/models/
backbones/scn.py:83-177): a SubM input conv -> 4 stages (16 -> 32 -> 64 -> 128) of two
residual submanifold SparseBasicBlocks each, joined by stride-2 sparse convs -> the
(3, 1, 1) z-stride conv -> the dense BEV with z folded into channels. Built on
``tdal_torch.ops.sparse_conv``; one neighbour table per resolution is shared by that
resolution's convs. BatchNorms are ``MaskedBatchNorm``s (flax momentum 0.99, eps 1e-3)
over the valid voxels only.

Parameters keep tdal's names: ``w_in``, ``w_blk{i}_{j}_a`` / ``_b``, ``w_down{i}``
(27, Cin, Cout) and ``w_z`` (3, C, C); ``norms[k]`` is flax's ``MaskedBatchNorm_k``
(the order in which tdal's forward creates them).

``occupancy`` keeps each level's occupied voxels of the last forward; while a profiler
records they are also counted as ``sparse.voxels.l<level>`` (``runtime/tracing.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from tdal_torch.models.layers import MaskedBatchNorm
from tdal_torch.ops.sparse_conv import (
    down2_grid, downz_grid, scatter_dense_bev, sort_voxels, sparse_conv3d_down2,
    sparse_conv3d_downz, subm_conv3d, subm_neighbors,
)
from tdal_torch.runtime.tracing import count_device, recording


def bev_channels(grid_size, channels: Sequence[int] = (16, 32, 64, 128)) -> int:
    """The BEV's channels for a (nz, ny, nx) grid: the last stage's width times the
    depth left after three stride-2 convs and the z-stride conv (each ceil(n / 2))."""
    nz = grid_size[0]
    for _ in range(len(channels)):
        nz = (nz + 1) // 2
    return nz * channels[-1]


class SparseMiddleBackbone(nn.Module):
    def __init__(self, grid_size: Tuple[int, int, int], in_channels: int,
                 channels: Sequence[int] = (16, 32, 64, 128), voxel_caps: Sequence[int] = None,
                 blocks_per_stage: int = 2, dtype=torch.float32):
        super().__init__()
        self.grid_size = tuple(int(g) for g in grid_size)
        self.channels, self.dtype = tuple(channels), dtype
        self.voxel_caps = None if voxel_caps is None else tuple(voxel_caps)
        self.blocks_per_stage = blocks_per_stage
        chans = self.channels

        def w(*shape):
            return nn.Parameter(torch.empty(*shape))

        self.w_in = w(27, in_channels, chans[0])
        norms = [MaskedBatchNorm(chans[0], dtype=dtype)]
        for i, c in enumerate(chans):
            for j in range(blocks_per_stage):
                setattr(self, f"w_blk{i}_{j}_a", w(27, c, c))
                setattr(self, f"w_blk{i}_{j}_b", w(27, c, c))
                norms += [MaskedBatchNorm(c, dtype=dtype), MaskedBatchNorm(c, dtype=dtype)]
            if i + 1 < len(chans):
                setattr(self, f"w_down{i}", w(27, c, chans[i + 1]))
                norms.append(MaskedBatchNorm(chans[i + 1], dtype=dtype))
        self.w_z = w(3, chans[-1], chans[-1])
        norms.append(MaskedBatchNorm(chans[-1], dtype=dtype))
        self.norms = nn.ModuleList(norms)
        self.out_channels = bev_channels(self.grid_size, chans)
        # per level: (occupied voxels per sample (B,), cap), kept from the last forward
        self.occupancy = []

    def forward(self, feats, coords, valid):
        """feats (B, V, Cin), coords (B, V, 3) zyx, valid (B, V) -> BEV (B, ny, nx, C)."""
        v = feats.shape[1]
        grid = self.grid_size
        caps = self.voxel_caps or (v, v // 2, v // 4, v // 8)
        chans = self.channels
        norms = iter(self.norms)

        def bn_relu(x, valid):
            return torch.relu(next(norms)(x, valid.to(x.dtype))) * valid[..., None]

        # each level's voxels sort first: the occupied count is each conv's ``rows``
        coords, feats, valid, keys = sort_voxels(coords, feats, valid, grid)
        self.occupancy = [(valid.sum(1), v)]
        nbrs, rows = subm_neighbors(coords, valid, keys, grid), self.occupancy[-1][0]
        x = bn_relu(subm_conv3d(coords, feats, valid, keys, grid, self.w_in, neighbors=nbrs,
                                rows=rows), valid)
        for i in range(len(chans)):
            for j in range(self.blocks_per_stage):
                wa, wb = getattr(self, f"w_blk{i}_{j}_a"), getattr(self, f"w_blk{i}_{j}_b")
                y = bn_relu(subm_conv3d(coords, x, valid, keys, grid, wa, neighbors=nbrs,
                                        rows=rows), valid)
                y = subm_conv3d(coords, y, valid, keys, grid, wb, neighbors=nbrs, rows=rows)
                y = next(norms)(y, valid.to(y.dtype))
                x = torch.relu(y + x) * valid[..., None]
            if i + 1 < len(chans):
                cap = int(caps[i + 1]) if i + 1 < len(caps) else v
                coords, x, valid, keys = sparse_conv3d_down2(
                    coords, x, valid, keys, grid, getattr(self, f"w_down{i}"), cap, rows=rows)
                self.occupancy.append((valid.sum(1), cap))
                grid = down2_grid(grid)
                nbrs, rows = subm_neighbors(coords, valid, keys, grid), self.occupancy[-1][0]
                x = bn_relu(x, valid)
        cap = int(caps[-1]) if len(caps) >= len(chans) else v
        coords, x, valid, keys = sparse_conv3d_downz(coords, x, valid, keys, grid, self.w_z,
                                                     cap, rows=rows)
        self.occupancy.append((valid.sum(1), cap))
        if recording():
            for i, (n, _) in enumerate(self.occupancy):
                count_device(f"sparse.voxels.l{i}", n)
        grid = downz_grid(grid)
        x = bn_relu(x, valid)
        return scatter_dense_bev(coords, x, valid, grid)
