"""Dense 3D middle backbone of VoxelNet for small grids.

Port of ``tdal/models/scn.py``: the voxels scattered into a dense (B, nz, ny, nx, C)
grid, then the channel plan of SpMiddleResNetFHD as dense 3D convs (cuDNN): 16 ->
[16, 16] -> s2 32 -> [32, 32] -> s2 64 -> [64, 64] -> s2 128 -> [128, 128] -> the
(3, 1, 1) z-stride conv -> z folded into channels. VoxelNet takes it where the grid has
at most 2^24 cells (``detectors.VoxelNet``). Padding is flax's SAME (for a stride-2
conv over an even size: none before, one after), BatchNorms flax's (momentum 0.99,
eps 1e-3).

``layers`` holds tdal's ``Conv3DBNReLU_0``, ``BasicBlock3D_0``, ``BasicBlock3D_1``,
``Conv3DBNReLU_1``, ... in forward order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tdal_torch.models.layers import BatchNorm


def _conv3d_same(x, weight, stride, dtype):
    """flax ``nn.Conv(padding='SAME')`` of an NDHWC ``x`` with an (O, I, kd, kh, kw)
    weight, in ``dtype``."""
    pads = []
    for n, k, s in zip(x.shape[1:4], weight.shape[2:], stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    xin = x.to(dtype).permute(0, 4, 1, 2, 3)
    xin = F.pad(xin, [p for lo_hi in reversed(pads) for p in lo_hi])
    return F.conv3d(xin, weight.to(dtype), stride=stride).permute(0, 2, 3, 4, 1)


class Conv3DBNReLU(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.dtype = tuple(stride), dtype
        self.conv = nn.Conv3d(in_channels, features, kernel, bias=False)
        self.bn = BatchNorm(features, 0.01, 1e-3, dtype)

    def forward(self, x):
        return torch.relu(self.bn(_conv3d_same(x, self.conv.weight, self.stride, self.dtype)))


class BasicBlock3D(nn.Module):
    """Residual 3x3x3 block (reference scn.SparseBasicBlock, :37-80)."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_bn_relu = Conv3DBNReLU(features, features, dtype=dtype)
        self.conv = nn.Conv3d(features, features, 3, bias=False)
        self.bn = BatchNorm(features, 0.01, 1e-3, dtype)

    def forward(self, x):
        y = _conv3d_same(self.conv_bn_relu(x), self.conv.weight, (1, 1, 1), self.dtype)
        return torch.relu(self.bn(y) + x)


def scatter_to_grid3d(features, coords, valid, nz: int, ny: int, nx: int):
    """(B, V, C) voxel features + (B, V, 3 zyx) coords -> dense (B, nz, ny, nx, C);
    invalid rows go to a dropped slot."""
    b, _, c = features.shape
    lin = coords[..., 0] * (ny * nx) + coords[..., 1] * nx + coords[..., 2]
    lin = torch.where(valid, lin, nz * ny * nx)
    grid = features.new_zeros(b, nz * ny * nx + 1, c)
    grid = grid.scatter(1, lin[..., None].expand(-1, -1, c), features)
    return grid[:, : nz * ny * nx].reshape(b, nz, ny, nx, c)


class MiddleBackbone(nn.Module):
    def __init__(self, grid_size: Tuple[int, int, int], in_channels: int, dtype=torch.float32):
        super().__init__()
        self.grid_size = tuple(int(g) for g in grid_size)
        layers, c = [], in_channels
        for f in (16, 32, 64, 128):
            layers.append(Conv3DBNReLU(c, f, stride=(1, 1, 1) if f == 16 else (2, 2, 2),
                                       dtype=dtype))
            layers += [BasicBlock3D(f, dtype), BasicBlock3D(f, dtype)]
            c = f
        layers.append(Conv3DBNReLU(128, 128, kernel=(3, 1, 1), stride=(2, 1, 1), dtype=dtype))
        self.layers = nn.ModuleList(layers)
        nz = self.grid_size[0]
        for _ in range(4):
            nz = (nz + 1) // 2
        self.out_channels = nz * 128

    def forward(self, feats, coords, valid):
        """feats (B, V, Cin), coords (B, V, 3) zyx, valid (B, V) -> BEV (B, ny, nx, C)."""
        x = scatter_to_grid3d(feats, coords, valid, *self.grid_size)
        for layer in self.layers:
            x = layer(x)
        b, d, h, w, c = x.shape
        return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)
