"""Deformable convolution (DCNv1) and the deformable CenterHead branch, NHWC.

Port of ``tdal/models/dcn.py`` (``deform_sample`` :19-70, ``DeformConv`` :73-90,
``FeatureAdaption`` :93-110, ``DCNSepHead`` :113-148). tdal writes the bilinear
sampling as XLA gathers and the tap contraction as one matmul, with no Pallas kernel;
the port keeps it plain PyTorch.

The sampling splits every coordinate with ``floor`` and gathers the four corners with
their indices clipped to the image, each corner then zeroed by its own in-bounds mask:
the reference's im2col zero padding, which is not ``grid_sample``'s padding rule.
``deform_sample`` is one autograd function that saves only its inputs: the forward
sums the four corners into the output, and the backward recomputes the corners one at
a time, scatters the cotangent into ``x`` (``index_add_``, which takes PyTorch's
deterministic path under ``torch.use_deterministic_algorithms``) and sums the offset
cotangent, so no corner's tap tensor outlives its turn.

BEV spatial partitioning (``DCNSepHead.forward(x, slab)``): the sampling reads the whole
canvas, so the shared conv's output is gathered (``RowSlab.gather`` with ``same=False``:
each rank samples for its own output rows, so the cotangent is summed over the ranks
before each keeps its rows) and each rank computes its own rows, their taps at global
row coordinates (``row0``); the offset convs are 1x1 on the rank's rows, the 3x3 convs
run on the slab with one-row halos.

Dtypes follow tdal's promotion: the sampling coordinates and the corner weights are
f32, so the sampled taps (and the deformable conv's matmul) are f32 also where ``x``
is bf16; the 1x1 offset conv and the hm branch run in the head's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from tdal_torch.models.layers import BatchNorm, conv_nhwc, rows_conv

_HEAD_BN = dict(momentum=0.1, eps=1e-5)
# (row step, column step) of the four corners, in tdal's order a, b, c, d
_CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _cell(v):
    """The corner at or below a sampling coordinate (tdal dcn.py:40-41)."""
    return torch.floor(v)


def sampling_coordinates(offsets, kernel_size: int = 3, row0: int = 0):
    """(ys, xs), each (B, H, W, K*K) f32: every output position's taps, ordered (ky, kx)
    row-major over the kernel (``meshgrid(..., indexing="ij")``), moved by ``offsets``
    (B, H, W, 2*K*K), a (dy, dx) pair per tap. The output rows are the map's rows
    row0 .. row0 + H - 1."""
    b, h, w, _ = offsets.shape
    k = kernel_size
    half = (k - 1) // 2
    r = torch.arange(-half, half + 1, device=offsets.device)
    ky, kx = torch.meshgrid(r, r, indexing="ij")
    base_y = (torch.arange(row0, row0 + h, device=offsets.device)[:, None, None]
              + ky.reshape(1, 1, k * k)).float()  # (H, 1, K2)
    base_x = (torch.arange(w, device=offsets.device)[None, :, None]
              + kx.reshape(1, 1, k * k)).float()  # (1, W, K2)
    off = offsets.float().reshape(b, h, w, k * k, 2)
    return base_y + off[..., 0], base_x + off[..., 1]


def _corners(ys, xs, h: int, w: int):
    """Per corner: (row step, column step, flat index into (B*H*W) of the clipped
    corner, its in-bounds mask as f32), and the fractional parts (wy, wx)."""
    y0, x0 = _cell(ys), _cell(xs)
    wy, wx = ys - y0, xs - x0
    b = ys.shape[0]
    batch = torch.arange(b, device=ys.device).view(b, 1, 1, 1) * (h * w)
    out = []
    for dy, dx in _CORNERS:
        yy, xx = y0 + dy, x0 + dx
        inb = ((yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)).float()
        lin = (yy.long().clamp(0, h - 1) * w + xx.long().clamp(0, w - 1) + batch).reshape(-1)
        out.append((dy, dx, lin, inb))
    return out, wy, wx


class _DeformSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offsets, kernel_size, row0):
        b, h, w, c = x.shape
        ys, xs = sampling_coordinates(offsets, kernel_size, row0)
        corners, wy, wx = _corners(ys, xs, h, w)
        flat = x.reshape(b * h * w, c)
        out = None
        for dy, dx, lin, inb in corners:
            weight = (wy if dy else 1 - wy) * (wx if dx else 1 - wx) * inb
            term = flat.index_select(0, lin).view(*ys.shape, c) * weight[..., None]
            out = term if out is None else out.add_(term)
        ctx.save_for_backward(x, offsets)
        ctx.kernel_size, ctx.row0 = kernel_size, row0
        return out

    @staticmethod
    def backward(ctx, grad):
        x, offsets = ctx.saved_tensors
        b, h, w, c = x.shape
        ys, xs = sampling_coordinates(offsets, ctx.kernel_size, ctx.row0)
        corners, wy, wx = _corners(ys, xs, h, w)
        flat = x.reshape(b * h * w, c)
        g = grad.float()
        gx = torch.zeros(b * h * w, c, dtype=torch.float32, device=x.device)
        gwy, gwx = torch.zeros_like(wy), torch.zeros_like(wx)
        for dy, dx, lin, inb in corners:
            ay, ax = (wy if dy else 1 - wy), (wx if dx else 1 - wx)
            # the cotangent of this corner's weight: sum over channels of g * value
            s = (g * flat.index_select(0, lin).view(*ys.shape, c)).sum(-1) * inb
            gwy.add_(s * ax, alpha=1 if dy else -1)
            gwx.add_(s * ay, alpha=1 if dx else -1)
            gx.index_add_(0, lin, (g * (ay * ax * inb)[..., None]).reshape(-1, c))
        goff = torch.stack([gwy, gwx], dim=-1).reshape(offsets.shape)
        return gx.view(x.shape).to(x.dtype), goff.to(offsets.dtype), None, None


def deform_sample(x, offsets, kernel_size: int = 3, row0: int = 0):
    """Bilinear samples of ``x`` (B, H, W, C) at the deformed taps of every output
    position: (B, Ho, W, K*K, C), f32 (or wider where ``x`` is), for the Ho output rows
    row0 .. of ``offsets`` (B, Ho, W, 2*K*K): all of x's rows by default."""
    return _DeformSample.apply(x, offsets, kernel_size, row0)


class DeformConv(nn.Module):
    """K x K deformable conv without bias, offsets supplied by the caller. ``kernel``
    is (K*K*C, F), tdal's layout: row tap * C + channel."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.dtype = kernel_size, dtype
        self.kernel = nn.Parameter(torch.empty(kernel_size**2 * in_channels, features))

    def forward(self, x, offsets, row0: int = 0):
        taps = deform_sample(x, offsets, self.kernel_size, row0)
        b, h, w, k2, c = taps.shape
        kernel = self.kernel.to(self.dtype)
        return taps.reshape(b, h, w, k2 * c) @ kernel.to(torch.promote_types(taps.dtype,
                                                                             kernel.dtype))


class FeatureAdaption(nn.Module):
    """A 1x1 conv with a bias predicts the taps' offsets (weights and bias start at
    zero), then ``DeformConv`` and ReLU."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.offset = nn.Conv2d(in_channels, 2 * kernel_size**2, 1)
        nn.init.zeros_(self.offset.weight)
        nn.init.zeros_(self.offset.bias)
        self.deform = DeformConv(in_channels, features, kernel_size, dtype)

    def offsets(self, x):
        return conv_nhwc(x, self.offset.weight, self.offset.bias, dtype=self.dtype)

    def forward(self, x, whole=None, row0: int = 0):
        """x: the map, or this rank's rows of it from row ``row0`` with the whole map
        ``whole`` to sample."""
        return torch.relu(self.deform(x if whole is None else whole, self.offsets(x), row0))


class DCNSepHead(nn.Module):
    """Deformable feature adaption, one for the heatmap and one for the regression
    branches. The heatmap: 3x3 conv with a bias, BatchNorm (eps 1e-5, momentum 0.1),
    ReLU, 3x3 conv to ``num_cls`` with its bias at ``init_bias``. The regression heads
    (``heads``, without ``hm``): a ``SepHead`` on the regression features."""

    def __init__(self, in_channels: int, heads: dict, num_cls: int, head_conv: int = 64,
                 init_bias: float = -2.19, dtype=torch.float32):
        from tdal_torch.models.center_head import SepHead

        super().__init__()
        self.dtype = dtype
        self.center_adapt = FeatureAdaption(in_channels, in_channels, dtype=dtype)
        self.reg_adapt = FeatureAdaption(in_channels, in_channels, dtype=dtype)
        self.cls_conv = nn.Conv2d(in_channels, head_conv, 3, padding=1)
        self.cls_bn = BatchNorm(head_conv, dtype=dtype, **_HEAD_BN)
        self.hm_conv = nn.Conv2d(head_conv, num_cls, 3, padding=1)
        with torch.no_grad():
            self.cls_conv.bias.zero_()
            self.hm_conv.bias.fill_(init_bias)
        self.reg = SepHead(in_channels, heads, head_conv, dtype=dtype)

    def forward(self, x, slab=None):
        """x: the map, or ``slab``'s rows of it (then the outputs are its rows too)."""
        whole, row0 = (None, 0) if slab is None else (slab.gather(x, same=False), slab.start)
        center, reg = self.center_adapt(x, whole, row0), self.reg_adapt(x, whole, row0)
        h = rows_conv(center, self.cls_conv.weight, self.cls_conv.bias, slab,
                      dtype=self.dtype)
        h = torch.relu(self.cls_bn(h))
        ret = self.reg(reg, slab=slab)
        ret["hm"] = rows_conv(h, self.hm_conv.weight, self.hm_conv.bias, slab,
                              dtype=self.dtype)
        return ret
