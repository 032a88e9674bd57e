"""RPN neck: the 2D conv FPN over the BEV canvas, NHWC.

Port of ``tdal/models/rpn.py``: per stage a stride-s entry ConvBNReLU and
``layer_nums[i]`` 3x3 FusedConvBNs chained through their BN affine (each layer's
normalise + ReLU runs on the next layer's input side, so in training every stride-1
conv is one K3 launch), then a deblock per upsampled stage; deblock outputs are
concatenated on the channel axis.

Children: ``blocks[i]`` is a ``ModuleList`` [entry, layer_1, ..., layer_n] of
``ConvBNReLU``s; ``deblocks[j]`` a ``DeconvBNReLU``.

BEV spatial partitioning: given the input's ``RowSlab`` (``forward(x, slab)``), each
stage runs on its level's rows of the partition (the input's ranges over the stage's
total stride: ``tdal_torch.parallel.mesh.spatial_slab`` makes them nest), its convs
exchanging one-row halos with the neighbours, and the deblocks' outputs concatenate
row for row.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from tdal_torch.models.layers import ConvBNReLU, DeconvBNReLU


class RPN(nn.Module):
    def __init__(self, in_channels: int, layer_nums: Sequence[int] = (3, 5, 5),
                 ds_layer_strides: Sequence[int] = (1, 2, 2),
                 ds_num_filters: Sequence[int] = (64, 128, 256),
                 us_layer_strides: Sequence[float] = (1, 2, 4),
                 us_num_filters: Sequence[int] = (128, 128, 128), dtype=torch.float32):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.ds_layer_strides = tuple(ds_layer_strides)
        self.us_layer_strides = tuple(us_layer_strides)
        self.dtype = dtype
        self.up_start = len(layer_nums) - len(us_num_filters)
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        c = in_channels
        for i, n_layers in enumerate(layer_nums):
            f = ds_num_filters[i]
            block = [ConvBNReLU(c, f, stride=ds_layer_strides[i], dtype=dtype)]
            block += [ConvBNReLU(f, f, dtype=dtype) for _ in range(n_layers)]
            self.blocks.append(nn.ModuleList(block))
            c = f
            j = i - self.up_start
            if j >= 0:
                stride = us_layer_strides[j]
                if stride >= 1:
                    self.deblocks.append(
                        DeconvBNReLU(c, us_num_filters[j], stride=int(stride), dtype=dtype))
                else:
                    self.deblocks.append(
                        DeconvBNReLU(c, us_num_filters[j], stride=int(round(1 / stride)),
                                     downsample=True, dtype=dtype))
        self.out_channels = sum(us_num_filters) if len(us_num_filters) else c

    @property
    def downsample_factor(self) -> int:
        factor = int(np.prod(self.ds_layer_strides))
        if len(self.us_layer_strides) > 0:
            factor //= int(self.us_layer_strides[-1])
        return max(factor, 1)

    def out_slab(self, slab):
        """The output's ``RowSlab`` given the input's (None: None)."""
        if slab is None:
            return None
        stride = int(np.prod(self.ds_layer_strides))
        us = self.us_layer_strides[-1] if len(self.us_layer_strides) else 1
        return slab.scaled(*((int(us), stride) if us >= 1 else (1, stride * int(round(1 / us)))))

    def forward(self, x, slab=None):
        """x: the map, or ``slab``'s rows of it (then the output is its rows too)."""
        ups = []
        dt = self.dtype
        for i, block in enumerate(self.blocks):
            entry, layers = block[0], block[1:]
            stride = self.ds_layer_strides[i]
            if stride == 1:
                x, pre = entry(x, emit_raw=True, slab=slab)
            else:
                x, pre = entry(x, slab=slab), None
                slab = None if slab is None else slab.scaled(1, stride)
            for layer in layers:
                x, pre = layer(x, pre=pre, emit_raw=True, slab=slab)
            if pre is not None:
                x = torch.relu(x.to(dt) * pre[0].to(dt) + pre[1].to(dt))
            j = i - self.up_start
            if j >= 0:
                ups.append(self.deblocks[j](x))
        if ups:
            x = torch.cat(ups, dim=-1)
        return x
