"""3x3 stride-1 SAME NHWC convolution kernels (K3, K4, K5/K6, K7), their plain-PyTorch
twins, and the differentiable ops built on them.

Port of ``tdal/ops/pallas_conv.py``. The CUDA source is
``tdal_torch/ops/csrc/conv3x3.cu`` (design notes there), built at first use by
``tdal_torch.ops.build``. Layout is tdal's: x (B, H, W, C), w (3, 3, C, Co) HWIO.

Kernel wrappers (each runs its twin ``*_plain`` only when given CPU tensors; for CUDA
tensors it launches the kernel or raises):

- ``conv3x3_fwd_stats`` (K3): y = conv(act(x), w) + bias and stats = [sum y, sum y^2]
  per channel over the image, with act(x) = relu(x*s + t) when ``in_act`` (the halo
  outside the image stays zero) and x otherwise.
- ``conv3x3_fwd`` (K4): y = conv(x, w) * scale + shift, optional ReLU.
- ``conv3x3_wgrad`` (K5, and K6 with ``in_act=False``): dw (3, 3, C, Co) in f32.
- ``conv3x3_dgrad_act`` (K7): the dgrad of the in_act chain in one pass. With acc =
  conv(gy, wt) in f32 and dxh = acc * [x*s + t > 0]: dx = dxh * s in x's type (rounded
  once) and stats = [sum dxh * x, sum dxh] per channel over the image.

x, w (and y, gy) are f32 or bf16, one type per call; the vectors (bias, scale, shift)
are f32. In bf16 the activated input is rounded to bf16 before the taps, products
accumulate in f32, the statistics come from the f32 accumulator and y is rounded to
bf16, as the TPU kernels do.

The row halo form (BEV spatial partitioning, ``tdal_torch.parallel.mesh``): every
wrapper and twin takes ``halo=(top, bottom)``, each 0 or 1. The conv input (x of K3,
K4 and K5/K6; gy of K7) then holds top + H + bottom rows, all real image rows: a
rank's H rows of a map split by rows, with its neighbours' edge rows above and below.
Zero padding stays only on a side with no halo row (the image's own edge); the input
affine + ReLU applies to the halo rows as to any real row, never to padding. The
output, the statistics, K7's x and the wgrad's gy cover the H own rows. ``halo=(0, 0)``
is the whole-image kernel of before (``csrc/conv3x3.cu``); any other launches the halo
instantiations (``csrc/conv3x3_halo.cu``).

Differentiable ops, as in tdal: ``conv3x3_act_stats`` (forward K3; backward K5 wgrad
and, with flipped, in/out-swapped weights, the dgrad: K7 with ``in_act``, else K4),
``conv3x3_bias`` (forward K4;
backward K4 + K6), ``conv3x3`` and ``conv3x3_affine`` (inference only). tdal's TPU
tiling, its Pallas/XLA gate and its tiny-output XLA backward are not semantics: on
the card every call goes through the kernels. ``conv3x3_act_stats`` also runs on a row
slab (``slab``, a ``tdal_torch.parallel.mesh.RowSlab``): its forward exchanges x's edge
rows with the neighbours and launches K3 in the halo form, its backward exchanges the
cotangent's edge rows and launches K7 (or the K4 dgrad) and K5/K6 in the halo form,
so each rank's dx is whole for its own rows and no cotangent travels back.

``launches`` counts wrapper calls that launched their kernel, ``halo_launches`` those
of them in the halo form; twins do not count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

launches = {"conv3x3_fwd_stats": 0, "conv3x3_fwd": 0, "conv3x3_wgrad": 0,
            "conv3x3_dgrad_act": 0}
halo_launches = dict.fromkeys(launches, 0)

_DTYPES = (torch.float32, torch.bfloat16)
_WGRAD_BLOCKS_PER_SM = 4  # wgrad blocks per SM over the grid: one resident, four waves


# ---------------------------------------------------------------------------
# Plain twins: what the kernels compute
# ---------------------------------------------------------------------------


def _activate(x, in_scale, in_shift, in_act: bool):
    """f32 input of the taps: relu(x*s + t) rounded to x's type, or x."""
    xf = x.float()
    if in_act:
        xf = torch.relu(xf * in_scale.float() + in_shift.float()).to(x.dtype).float()
    return xf


def _taps(xf, halo=(0, 0)):
    """The 9 shifted (B, H, W, C) views of xf, tap order: xf zero-padded by one pixel,
    but for the rows of ``halo`` (top, bottom), which are xf's own (then H is xf's rows
    less the halo's)."""
    top, bottom = halo
    _, h, w, _ = xf.shape
    h -= top + bottom
    xp = F.pad(xf, (0, 0, 1, 1, 1 - top, 1 - bottom))
    return [xp[:, ky : ky + h, kx : kx + w] for ky in range(3) for kx in range(3)]


def _conv_f32(xf, wf, halo=(0, 0)):
    """SAME 3x3 conv as 9 shifted products, f32: (B, H, W, C) x (3, 3, C, Co); with
    ``halo`` valid in the halo's rows."""
    wt = wf.reshape(9, *wf.shape[2:])
    out = None
    for k, tap in enumerate(_taps(xf, halo)):
        term = tap @ wt[k]
        out = term if out is None else out + term
    return out


def conv3x3_fwd_stats_plain(x, w, bias, in_scale, in_shift, in_act: bool, halo=(0, 0)):
    """Twin of K3: (y in x's type, stats (2, Co) f32)."""
    acc = _conv_f32(_activate(x, in_scale, in_shift, in_act), w.float(), halo) + bias.float()
    stats = torch.stack([acc.sum(dim=(0, 1, 2)), (acc * acc).sum(dim=(0, 1, 2))])
    return acc.to(x.dtype), stats


def conv3x3_fwd_plain(x, w, shift, scale=None, relu: bool = False, halo=(0, 0)):
    """Twin of K4: conv(x, w) * scale + shift, optional ReLU, in x's type."""
    acc = _conv_f32(x.float(), w.float(), halo)
    if scale is not None:
        acc = acc * scale.float()
    acc = acc + shift.float()
    return (torch.relu(acc) if relu else acc).to(x.dtype)


def conv3x3_wgrad_plain(x, gy, in_scale, in_shift, in_act: bool, halo=(0, 0)):
    """Twin of K5/K6: dw[ky, kx] = sum over b, h, w of act(x) shifted by the tap times
    gy, f32 (3, 3, C, Co)."""
    g = gy.float().reshape(-1, gy.shape[-1])
    taps = _taps(_activate(x, in_scale, in_shift, in_act), halo)
    dw = torch.stack([t.reshape(-1, t.shape[-1]).t() @ g for t in taps])
    return dw.reshape(3, 3, x.shape[-1], gy.shape[-1])


def conv3x3_dgrad_act_plain(gy, wt, x, s, t, halo=(0, 0)):
    """Twin of K7: (dx in x's type, stats (2, C) f32 = [sum dxh * x, sum dxh]).

    In bf16 this rounds once, at dx, as tdal's Pallas K7 does (tdal's XLA route rounds
    dxhat to bf16 before the mask as well)."""
    xf = x.float()
    dxh = _conv_f32(gy.float(), wt.float(), halo) * (xf * s.float() + t.float() > 0)
    stats = torch.stack([(dxh * xf).sum(dim=(0, 1, 2)), dxh.sum(dim=(0, 1, 2))])
    return (dxh * s.float()).to(x.dtype), stats


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _require(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _halo(kind, halo):
    top, bottom = (int(v) for v in halo)
    if top not in (0, 1) or bottom not in (0, 1):
        raise ValueError(f"{kind}: halo rows (top, bottom) must each be 0 or 1, got {halo}")
    return top, bottom


def _require_input(kind, x, halo=(0, 0)):
    """(B, H, W, C) of a conv input with ``halo``'s rows around H own rows."""
    top, bottom = _halo(kind, halo)
    if x.device.type != "cuda":
        raise ValueError(f"{kind}: expected a CUDA tensor, got device {x.device}")
    if x.dim() != 4 or min(x.shape) < 1 or x.shape[1] - top - bottom < 1:
        raise ValueError(f"{kind}: x must be (B, top + H + bottom, W, C) with every dim "
                         f">= 1, got {tuple(x.shape)} for halo {halo}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{kind}: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{kind}: expected a contiguous x")
    b, h, w, c = x.shape
    return b, h - top - bottom, w, c


def _count(name, halo):
    launches[name] += 1
    if tuple(halo) != (0, 0):
        halo_launches[name] += 1


def conv3x3_fwd_stats(x, w, bias, in_scale, in_shift, in_act: bool, halo=(0, 0)):
    """K3: (y (B, H, W, Co) in x's type, stats (2, Co) f32)."""
    if x.device.type == "cpu":
        return conv3x3_fwd_stats_plain(x, w, bias, in_scale, in_shift, in_act, halo)
    B, H, W, C = _require_input("conv3x3_fwd_stats", x, halo)
    Co = w.shape[-1]
    dev = x.device
    _require("conv3x3_fwd_stats w", w, (3, 3, C, Co), x.dtype, dev)
    _require("conv3x3_fwd_stats bias", bias, (Co,), torch.float32, dev)
    _require("conv3x3_fwd_stats in_scale", in_scale, (C,), torch.float32, dev)
    _require("conv3x3_fwd_stats in_shift", in_shift, (C,), torch.float32, dev)

    from tdal_torch.ops.build import kernels

    lib = kernels()
    y = torch.empty(B, H, W, Co, device=dev, dtype=x.dtype)
    partial = torch.empty(B * lib.conv3x3_tiles(H, W), 2, Co, device=dev,
                          dtype=torch.float32)
    stats = torch.empty(2, Co, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        lib.conv3x3_fwd_stats(x, w, in_scale, in_shift, bool(in_act), bias, y, partial,
                              stats, halo)
    _count("conv3x3_fwd_stats", halo)
    return y, stats


def conv3x3_fwd(x, w, shift, scale=None, relu: bool = False, halo=(0, 0)):
    """K4: conv(x, w) * scale + shift (scale None means 1), optional ReLU; x's type."""
    if x.device.type == "cpu":
        return conv3x3_fwd_plain(x, w, shift, scale, relu, halo)
    B, H, W, C = _require_input("conv3x3_fwd", x, halo)
    Co = w.shape[-1]
    dev = x.device
    _require("conv3x3_fwd w", w, (3, 3, C, Co), x.dtype, dev)
    _require("conv3x3_fwd shift", shift, (Co,), torch.float32, dev)
    if scale is not None:
        _require("conv3x3_fwd scale", scale, (Co,), torch.float32, dev)

    from tdal_torch.ops.build import kernels

    lib = kernels()
    y = torch.empty(B, H, W, Co, device=dev, dtype=x.dtype)
    with torch.cuda.device(dev):
        lib.conv3x3_fwd(x, w, scale, shift, bool(relu), y, halo)
    _count("conv3x3_fwd", halo)
    return y


def _wgrad_splits(n_tiles: int, chunks: int, sms: int) -> int:
    """Splits of the wgrad's pixel tiles: about ``_WGRAD_BLOCKS_PER_SM`` blocks per SM
    over the grid, rounded down, so that the last of the waves of one resident block
    per SM is nearly full (rounding up left 2 of 132 SMs busy in a fifth wave at the
    head branch's 10 channel chunks)."""
    return max(1, min(n_tiles, _WGRAD_BLOCKS_PER_SM * sms // chunks))


def conv3x3_wgrad(x, gy, in_scale, in_shift, in_act: bool, halo=(0, 0)):
    """K5 (``in_act``) / K6: dw (3, 3, C, Co) f32. With ``halo`` x has its rows around
    gy's H."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, gy, in_scale, in_shift, in_act, halo)
    B, H, W, C = _require_input("conv3x3_wgrad", x, halo)
    Co = gy.shape[-1]
    dev = x.device
    _require("conv3x3_wgrad gy", gy, (B, H, W, Co), x.dtype, dev)
    _require("conv3x3_wgrad in_scale", in_scale, (C,), torch.float32, dev)
    _require("conv3x3_wgrad in_shift", in_shift, (C,), torch.float32, dev)

    from tdal_torch.ops.build import kernels

    lib = kernels()
    splits = _wgrad_splits(B * lib.conv3x3_tiles(H, W), lib.conv3x3_wgrad_chunks(C, Co),
                           torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty(splits, 3, 3, C, Co, device=dev, dtype=torch.float32)
    dw = torch.empty(3, 3, C, Co, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        lib.conv3x3_wgrad(x, gy, in_scale, in_shift, bool(in_act), splits, partial, dw,
                          halo)
    _count("conv3x3_wgrad", halo)
    return dw


def conv3x3_dgrad_act(gy, wt, x, s, t, halo=(0, 0)):
    """K7: gy (B, H, W, Co), wt (3, 3, Co, C) flipped and in/out-swapped, x (B, H, W, C)
    the forward's input, s and t (C,) f32 -> (dx (B, H, W, C) in x's type, stats
    (2, C) f32). With ``halo`` gy has its rows around x's H."""
    if gy.device.type == "cpu":
        return conv3x3_dgrad_act_plain(gy, wt, x, s, t, halo)
    B, H, W, Co = _require_input("conv3x3_dgrad_act", gy, halo)
    C = wt.shape[-1]
    dev = gy.device
    _require("conv3x3_dgrad_act wt", wt, (3, 3, Co, C), gy.dtype, dev)
    _require("conv3x3_dgrad_act x", x, (B, H, W, C), gy.dtype, dev)
    _require("conv3x3_dgrad_act s", s, (C,), torch.float32, dev)
    _require("conv3x3_dgrad_act t", t, (C,), torch.float32, dev)

    from tdal_torch.ops.build import kernels

    lib = kernels()
    dx = torch.empty(B, H, W, C, device=dev, dtype=gy.dtype)
    partial = torch.empty(B * lib.conv3x3_tiles(H, W), 2, C, device=dev,
                          dtype=torch.float32)
    stats = torch.empty(2, C, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        lib.conv3x3_dgrad_act(gy, wt, x, s, t, dx, partial, stats, halo)
    _count("conv3x3_dgrad_act", halo)
    return dx, stats


# ---------------------------------------------------------------------------
# Differentiable ops
# ---------------------------------------------------------------------------


def _flip_swap(w):
    """dgrad weights of a stride-1 SAME conv: spatially flipped, in/out swapped."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _vec(v):
    return v.float().contiguous()


def _with_halo(t, slab):
    """(t with its neighbours' edge rows, the halo (top, bottom)); (t, (0, 0)) without a
    slab."""
    if slab is None:
        return t, (0, 0)
    return slab.pad_rows(t).contiguous(), slab.halo()


class _ConvActStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, in_scale, in_shift, in_act, slab):
        s, t = _vec(in_scale), _vec(in_shift)
        xh, halo = _with_halo(x, slab)
        y, stats = conv3x3_fwd_stats(xh, w, _vec(bias), s, t, in_act, halo)
        ctx.save_for_backward(x, xh, w, s, t, y)
        ctx.in_act, ctx.slab = in_act, slab
        ctx.dtypes = (bias.dtype, in_scale.dtype, in_shift.dtype)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, xh, w, s, t, y = ctx.saved_tensors
        bdt, sdt, tdt = ctx.dtypes
        # cotangent into the raw conv output: direct + through the two moments
        gy_tot = (gy.float() + gstats[0] + 2.0 * y.float() * gstats[1]).to(y.dtype)
        gy_tot = gy_tot.contiguous()
        db = gy_tot.float().sum(dim=(0, 1, 2))
        dx = dw = ds = dt = None
        if ctx.needs_input_grad[1]:
            halo = (0, 0) if ctx.slab is None else ctx.slab.halo()
            dw = conv3x3_wgrad(xh, gy_tot, s, t, ctx.in_act, halo).to(w.dtype)
        if any(ctx.needs_input_grad[i] for i in (0, 3, 4)):
            # on a slab the neighbours' cotangent rows join this rank's: its dx rows are
            # then whole, and nothing travels back
            gh, halo = _with_halo(gy_tot, ctx.slab)
            if ctx.in_act:
                dx, dst = conv3x3_dgrad_act(gh, _flip_swap(w), x, s, t, halo)
                ds, dt = dst[0].to(sdt), dst[1].to(tdt)
            else:
                dx = conv3x3_fwd(gh, _flip_swap(w), torch.zeros(x.shape[-1], device=x.device),
                                 halo=halo).to(x.dtype)
                ds = torch.zeros(x.shape[-1], device=x.device, dtype=sdt)
                dt = torch.zeros(x.shape[-1], device=x.device, dtype=tdt)
        return dx, dw, db.to(bdt), ds, dt, None, None


class _ConvBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        return conv3x3_fwd(x, w, _vec(bias))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        ones = torch.ones(x.shape[-1], device=x.device)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_fwd(g, _flip_swap(w), torch.zeros_like(ones))
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, g, ones, torch.zeros_like(ones), False).to(w.dtype)
        db = g.float().sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db


def conv3x3_act_stats(x, w, bias, in_scale, in_shift, in_act: bool, slab=None):
    """3x3 s1 SAME conv returning ``(y, stats)``, stats = [sum y, sum y^2] per channel
    over the image. With ``in_act`` the producer's BatchNorm normalise + ReLU
    (``in_scale``, ``in_shift``) is applied to the input inside the kernel. With
    ``slab`` (a ``RowSlab``) x is this rank's rows of the map, y and the statistics
    cover them (the statistics are this rank's share: sum them over the ranks)."""
    return _ConvActStats.apply(x, w, bias, in_scale, in_shift, bool(in_act), slab)


def conv3x3_bias(x, w, bias):
    """3x3 stride-1 SAME NHWC conv + bias. x (B, H, W, C), w (3, 3, C, Co), bias (Co,)."""
    return _ConvBias.apply(x, w, bias)


def conv3x3(x, w):
    """Bias-free 3x3 stride-1 SAME conv (the zero bias takes no gradient)."""
    return conv3x3_bias(x, w, torch.zeros(w.shape[-1], device=x.device))


def conv3x3_affine(x, w, scale, shift, relu: bool = True):
    """Inference-only conv + per-channel affine (+ ReLU) in one pass (a folded eval
    BatchNorm: scale = gamma * rsqrt(var + eps), shift = beta - mean * scale)."""
    return conv3x3_fwd(x, w, _vec(shift), _vec(scale), relu)
