"""Layers of the detection stack: flax-equivalent BatchNorms and the conv blocks.

Port of ``tdal/models/layers.py``. Activations are channels-last (B, ..., C) as in
tdal; convolution weights are stored in torch's (Co, Ci, kh, kw) layout and the
cuDNN convs run on the NCHW view of an NHWC tensor (channels_last memory).

BatchNorm semantics are flax's, not ``torch.nn.BatchNorm*``'s: batch statistics are
taken in f32 over every axis but the last, the *biased* variance feeds the running
average, and ``momentum`` is the weight of the batch statistic (flax 0.99 -> 0.01,
flax 0.9 -> 0.1). ``BatchNorm`` uses E[x^2] - E[x]^2 clipped at 0 (flax's fast
variance); ``MaskedBatchNorm`` keeps padded rows out of its two-pass statistics.
Under an active mesh (``tdal_torch.parallel.mesh``) every statistic is over the global
batch, as in tdal's sharded step: the sums and the counts are all-reduced (the sums'
cotangents too, in the backward) before the mean and variance are formed, over the
whole world, so a map split by rows over a spatial axis (unevenly too) and a batch
split over a data axis both give the statistics of the whole.

BEV spatial partitioning: the 3x3 convs take ``slab`` (a ``RowSlab`` of the map they
run on) and then run on this rank's rows with its neighbours' edge rows as the halo:
``FusedConvBN`` in training through ``conv3x3_act_stats``' halo form (in a chain the
neighbours' raw rows travel and the global scale/shift is applied to them in the
kernel), in eval and in ``rows_conv`` (cuDNN) through ``RowSlab.exchange`` and a conv
valid in H, zero-padded only at the map's own edges; the strided entry conv of
``ConvBNReLU`` takes one row above. The deblocks need no halo.

``FusedConvBN`` in train mode runs ``tdal_torch.ops.conv3x3.conv3x3_act_stats``: on a
CUDA tensor the conv, its output moments and the producer's normalise + ReLU
(``pre``) are the K3 kernel. Its backward is K7 (the dgrad through ``pre``'s ReLU
and affine) + K5 where ``pre`` is given, and K4 (the plain dgrad) + K6 where it is
not. In eval mode it is a cuDNN conv with the running statistics folded into one
affine.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tdal_torch.ops.conv3x3 import conv3x3_act_stats, conv3x3_bias
from tdal_torch.parallel.mesh import all_reduce_sum


def conv_nhwc(x, weight, bias=None, stride: int = 1, padding: int = 0, dtype=None):
    """cuDNN ``conv2d`` of an NHWC tensor with an OIHW weight, in ``dtype``."""
    dtype = dtype or x.dtype
    b = None if bias is None else bias.to(dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype), b, stride, padding)
    return y.permute(0, 2, 3, 1)


def rows_conv(x, weight, bias=None, slab=None, stride: int = 1, act=None, dtype=None):
    """A k x k conv with k // 2 zero padding (cuDNN), NHWC, on the whole map or on
    ``slab``'s rows of it: the neighbours' edge rows joined (``RowSlab.exchange``: one
    above, and one below at stride 1), ``act`` (an elementwise function) applied to
    every real row, then zero padding only where the map ends and a conv valid in H."""
    pad = weight.shape[-1] // 2
    if slab is None or pad == 0:
        if act is not None:
            x = act(x)
        return conv_nhwc(x, weight, bias, stride, pad, dtype)
    if pad > 1:
        raise ValueError("a row slab's halo is one row: kernels of 3 or less")
    x = slab.exchange(x, True, stride == 1)
    if act is not None:
        x = act(x)
    first, last = slab.index == 0, slab.index == len(slab.ranges) - 1
    x = F.pad(x, (0, 0, 0, 0, pad * first, pad * last))
    return conv_nhwc(x, weight, bias, stride, (0, pad), dtype)


def moments(sums, count: int):
    """(mean, var) from per-channel [sum, sum of squares] (2, C) and the element count,
    both summed over the active mesh's whole world in one all-reduce (the count rides
    along as a third row); var = max(E[x^2] - mean^2, 0)."""
    total = all_reduce_sum(torch.cat([sums, sums.new_full((1, sums.shape[1]), float(count))]))
    n = total[2]
    mean = total[0] / n
    return mean, (total[1] / n - mean * mean).clamp_min(0.0)


def update_running(module, mean, var):
    """running = (1 - momentum) running + momentum batch, for ``module``'s
    ``running_mean`` / ``running_var``."""
    with torch.no_grad():
        m = module.momentum
        module.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
        module.running_var.mul_(1 - m).add_(var.detach(), alpha=m)


def hwio(weight):
    """OIHW conv weight -> tdal's HWIO layout (contiguous)."""
    return weight.permute(2, 3, 1, 0).contiguous()


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis of (..., C)."""

    def __init__(self, num_features: int, momentum: float = 0.01, eps: float = 1e-3,
                 dtype=torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            mean, var = moments(torch.stack([xf.sum(dim=axes), (xf * xf).sum(dim=axes)]),
                                xf[..., 0].numel())
            update_running(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean) * mul + self.bias).to(self.dtype)


class MaskedBatchNorm(BatchNorm):
    """``tdal.models.layers.MaskedBatchNorm``: BatchNorm whose two-pass statistics
    skip the rows where ``mask`` (x's shape without its last axis) is 0; normalises in
    ``dtype``."""

    def forward(self, x, mask):
        if self.training:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            w = mask[..., None].expand(x.shape).float()
            # two passes, each summed over the mesh: the mean first, then the centred
            # squares (a one-pass E[x^2] - E[x]^2 rounds differently from tdal)
            sums = all_reduce_sum(torch.stack([(xf * w).sum(dim=axes), w.sum(dim=axes)]))
            denom = sums[1].clamp_min(1.0)
            mean = sums[0] / denom
            var = all_reduce_sum(((xf - mean) ** 2 * w).sum(dim=axes)) / denom
            update_running(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        dt = self.dtype
        inv = torch.rsqrt(var + self.eps).to(dt)
        y = (x.to(dt) - mean.to(dt)) * inv
        return y * self.weight.to(dt) + self.bias.to(dt)


class Conv3x3(nn.Module):
    """3x3 stride-1 SAME conv through ``conv3x3_bias`` (K4 forward, K4 + K6
    backward on the card): the counterpart of ``PallasConv3x3``."""

    def __init__(self, in_channels: int, features: int, use_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        bias = self.bias if self.bias is not None else torch.zeros(
            self.weight.shape[0], device=x.device)
        return conv3x3_bias(x.to(self.dtype).contiguous(),
                            hwio(self.weight).to(self.dtype), bias)


class FusedConvBN(nn.Module):
    """3x3 stride-1 conv + BatchNorm + optional ReLU, chainable in train mode.

    Train: ``conv3x3_act_stats`` gives the raw output and its per-channel moments in
    one pass; var = max(E[y^2] - mean^2, 0). In a chain this layer's normalise + ReLU
    goes to the next layer as ``pre=(scale, shift)`` (``emit_raw=True``) and is
    applied to that layer's input inside its kernel. Eval: cuDNN conv with the running
    statistics (and the conv bias) folded into the output affine."""

    def __init__(self, in_channels: int, features: int, use_bias: bool = False,
                 relu: bool = True, momentum: float = 0.01, eps: float = 1e-3,
                 dtype=torch.float32):
        super().__init__()
        self.relu, self.momentum, self.eps, self.dtype = relu, momentum, eps, dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.conv_bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _cbias(self, device):
        if self.conv_bias is not None:
            return self.conv_bias
        return torch.zeros(self.weight.shape[0], device=device)

    def forward(self, x, pre=None, emit_raw: bool = False, slab=None):
        dt = self.dtype
        f = self.weight.shape[0]
        cbias = self._cbias(x.device)
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.scale
            shift = self.bias + (cbias - self.running_mean) * inv
            act = None
            if pre is not None:  # chained eval: the predecessor's BN applied here
                act = lambda v: torch.relu(v.to(dt) * pre[0].to(dt) + pre[1].to(dt))  # noqa: E731
            y = rows_conv(x.to(dt), self.weight, slab=slab, act=act, dtype=dt)
            y = y * inv.to(dt) + shift.to(dt)
            if emit_raw:
                ones = torch.ones(f, device=x.device)
                return y, (ones, torch.zeros_like(ones))
            return torch.relu(y) if self.relu else y
        if (emit_raw or pre is not None) and not self.relu:
            raise ValueError("a chained FusedConvBN needs relu=True")
        c = x.shape[-1]
        if pre is None:
            in_scale = torch.ones(c, device=x.device)
            in_shift = torch.zeros(c, device=x.device)
        else:
            in_scale, in_shift = pre
        y, stats = conv3x3_act_stats(x.to(dt).contiguous(), hwio(self.weight).to(dt), cbias,
                                     in_scale, in_shift, pre is not None, slab=slab)
        # the moments over the global batch: their cotangents, summed over the mesh in
        # the backward, are what K5/K7 take through _ConvActStats' backward
        mean, var = moments(stats, y.numel() // f)
        update_running(self, mean, var)
        inv = torch.rsqrt(var + self.eps) * self.scale
        shift = self.bias - mean * inv
        if emit_raw:
            return y, (inv, shift)
        y = y.to(dt) * inv.to(dt) + shift.to(dt)
        return torch.relu(y) if self.relu else y


class ConvBNReLU(nn.Module):
    """k x k Conv + BN + ReLU, NHWC. The 3x3 stride-1 bias-free case is a
    ``FusedConvBN`` (``self.fused``); the others are a cuDNN conv with symmetric k//2
    padding (the reference's ZeroPad2d(1) + valid strided conv) and a ``BatchNorm``."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 use_bias: bool = False, momentum: float = 0.01, eps: float = 1e-3,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        if kernel == 3 and stride == 1 and not use_bias:
            self.fused = FusedConvBN(in_channels, features, momentum=momentum, eps=eps,
                                     dtype=dtype)
        else:
            self.fused = None
            self.conv = nn.Conv2d(in_channels, features, kernel, stride, kernel // 2,
                                  bias=use_bias)
            self.bn = BatchNorm(features, momentum, eps, dtype)

    def forward(self, x, pre=None, emit_raw: bool = False, slab=None):
        """``slab``: the input's rows (BEV spatial partitioning)."""
        if self.fused is not None:
            return self.fused(x, pre=pre, emit_raw=emit_raw, slab=slab)
        if pre is not None or emit_raw:
            raise ValueError("chaining needs the 3x3 stride-1 fused path")
        c = self.conv
        if slab is None:
            x = conv_nhwc(x, c.weight, c.bias, c.stride, c.padding, self.dtype)
        else:
            x = rows_conv(x, c.weight, c.bias, slab, c.stride[0], dtype=self.dtype)
        return torch.relu(self.bn(x))


class DeconvBNReLU(nn.Module):
    """Upsample (k == s transposed conv), 1x1 conv (stride 1) or strided conv
    (``downsample``), then BatchNorm + ReLU. ``self.conv`` is a ``ConvTranspose2d``
    for the transposed case, else a ``Conv2d``."""

    def __init__(self, in_channels: int, features: int, stride: int = 2,
                 downsample: bool = False, momentum: float = 0.01, eps: float = 1e-3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        if downsample:
            self.conv = nn.Conv2d(in_channels, features, stride, stride, bias=False)
        elif stride == 1:
            self.conv = nn.Conv2d(in_channels, features, 1, bias=False)
        else:
            self.conv = nn.ConvTranspose2d(in_channels, features, stride, stride, bias=False)
        self.bn = BatchNorm(features, momentum, eps, dtype)

    def forward(self, x):
        c, dt = self.conv, self.dtype
        if isinstance(c, nn.ConvTranspose2d):
            y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), c.weight.to(dt),
                                   stride=c.stride).permute(0, 2, 3, 1)
        else:
            y = conv_nhwc(x, c.weight, stride=c.stride[0], dtype=dt)
        return torch.relu(self.bn(y))
