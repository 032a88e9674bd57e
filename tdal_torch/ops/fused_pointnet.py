"""Fused Frustum-PointNet instance-seg kernels (K1 encoder, K2 decoder) and their
plain-PyTorch twins.

Port of ``tdal/ops/pallas_pointnet.py``. The CUDA sources are
``tdal_torch/ops/csrc/fused_pointnet.cu`` (design notes there), built at first use by
``tdal_torch.ops.build``.

- ``fold_bn`` / ``fold_pointnet_seg_params``: eval-mode BatchNorm folded into the
  preceding Dense, weights in tdal's (in, out) layout.
- ``fused_seg_encoder`` (K1): pts (B, N, Cin) -> skip (B, N, 64), gmax (B, 1024).
- ``fused_seg_decoder`` (K2): (skip, gmax) -> logits (B, N, 2).
- ``pointnet_seg_logits``: K1 then K2, what ``PointNetSeg`` computes in eval mode.

Each wrapper runs its twin (``*_plain``) only when given CPU tensors; for CUDA
tensors it launches the kernel or raises. ``bf16_operands=True`` rounds both
operands of every product to bf16 and accumulates in f32, reproducing the TPU
kernels; ``False`` (the labelers' default) keeps f32 operands, as tdal's runtime
labelers run ``PointNetSeg`` in f32.

``launches`` counts kernel launches per wrapper (one per call, however many CUDA
kernels the call runs); twins do not count.
"""

from __future__ import annotations

import torch

ENC_FEATURES = (64, 64, 64, 128, 1024)
DEC_FEATURES = (512, 256, 128, 128)
SKIP_CH = ENC_FEATURES[1]
GLOBAL_CH = ENC_FEATURES[-1]

launches = {"fused_seg_encoder": 0, "fused_seg_decoder": 0}


def fold_bn(dense_kernel, dense_bias, bn_scale, bn_bias, bn_mean, bn_var, eps=1e-5):
    """Fold eval-mode BatchNorm into the preceding Dense (kernel (in, out)): (w, b)."""
    g = bn_scale / torch.sqrt(bn_var + eps)
    w = dense_kernel * g[None, :]
    b = (dense_bias if dense_bias is not None else 0.0) * g + bn_bias - bn_mean * g
    return w, b


def fold_pointnet_seg_params(seg):
    """Folded weights of a ``tdal_torch.models.pointnet.PointNetSeg``:
    (enc_w, enc_b, dec_w, dec_b, logit_w, logit_b), kernels (in, out) contiguous."""

    def layer(mlp, i):
        dense, bn = mlp.dense[i], mlp.bn[i]
        w, b = fold_bn(
            dense.weight.t(), dense.bias, bn.weight, bn.bias,
            bn.running_mean, bn.running_var, bn.eps,
        )
        return w.contiguous(), b.contiguous()

    enc = [layer(seg.enc1, i) for i in range(2)] + [layer(seg.enc2, i) for i in range(3)]
    dec = [layer(seg.dec, i) for i in range(4)]
    enc_w, enc_b = (list(t) for t in zip(*enc))
    dec_w, dec_b = (list(t) for t in zip(*dec))
    return (
        enc_w, enc_b, dec_w, dec_b,
        seg.logits.weight.t().contiguous(), seg.logits.bias.contiguous(),
    )


# ---------------------------------------------------------------------------
# Plain twins: what the kernels compute
# ---------------------------------------------------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _mm(x, w, bf16_operands: bool):
    if bf16_operands:
        x, w = _bf16(x), _bf16(w)
    return x @ w


def fused_seg_encoder_plain(pts, enc_w, enc_b, bf16_operands: bool = False):
    """Twin of K1: 5 x (Dense + folded BN + ReLU); skip after layer 2; per-set max."""
    x = pts
    for i, (w, b) in enumerate(zip(enc_w, enc_b)):
        x = torch.relu(_mm(x, w, bf16_operands) + b)
        if i == 1:
            skip = x
    return skip, x.amax(dim=1)


def fused_seg_decoder_plain(skip, gmax, dec_w, dec_b, logit_w, logit_b,
                            bf16_operands: bool = False):
    """Twin of K2. concat(skip, gmax) @ W0 is taken as skip @ W0[:64] plus a per-set
    gmax @ W0[64:], the same products summed in another order."""
    w0 = dec_w[0]
    gproj = _mm(gmax, w0[SKIP_CH:], bf16_operands) + dec_b[0]
    x = torch.relu(_mm(skip, w0[:SKIP_CH], bf16_operands) + gproj[:, None, :])
    for w, b in zip(dec_w[1:], dec_b[1:]):
        x = torch.relu(_mm(x, w, bf16_operands) + b)
    return _mm(x, logit_w, bf16_operands) + logit_b


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _require_cuda_f32(name, t, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _require_layers(kind, ws, bs, widths, cin, device):
    if len(ws) != len(widths) or len(bs) != len(widths):
        raise ValueError(f"{kind}: expected {len(widths)} layers")
    for i, (w, b, cout) in enumerate(zip(ws, bs, widths)):
        _require_cuda_f32(f"{kind} w[{i}]", w, (cin, cout))
        _require_cuda_f32(f"{kind} b[{i}]", b, (cout,))
        if w.device != device or b.device != device:
            raise ValueError(f"{kind}: layer {i} lies on another device")
        cin = cout


def fused_seg_encoder(pts, enc_w, enc_b, bf16_operands: bool = False):
    """K1: pts (B, N, Cin) f32, Cin in {3, 4}, any N >= 1 ->
    (skip (B, N, 64), gmax (B, 1024))."""
    if pts.device.type == "cpu":
        return fused_seg_encoder_plain(pts, enc_w, enc_b, bf16_operands)
    if pts.dim() != 3:
        raise ValueError(f"fused_seg_encoder: pts must be (B, N, Cin), got {tuple(pts.shape)}")
    B, N, cin = pts.shape
    if cin not in (3, 4) or B < 1 or N < 1:
        raise ValueError(f"fused_seg_encoder: unsupported pts shape {tuple(pts.shape)}")
    _require_cuda_f32("fused_seg_encoder pts", pts, (B, N, cin))
    _require_layers("fused_seg_encoder", enc_w, enc_b, ENC_FEATURES, cin, pts.device)

    from tdal_torch.ops.build import kernels

    lib = kernels()
    n_tiles = -(-N // lib.encoder_tile())
    kw = dict(device=pts.device, dtype=torch.float32)
    skip = torch.empty(B, N, SKIP_CH, **kw)
    partial = torch.empty(B, n_tiles, GLOBAL_CH, **kw)
    gmax = torch.empty(B, GLOBAL_CH, **kw)
    with torch.cuda.device(pts.device):
        lib.seg_encoder(pts, list(enc_w), list(enc_b), skip, partial, gmax, bool(bf16_operands))
    launches["fused_seg_encoder"] += 1
    return skip, gmax


def fused_seg_decoder(skip, gmax, dec_w, dec_b, logit_w, logit_b,
                      bf16_operands: bool = False):
    """K2: (skip (B, N, 64), gmax (B, 1024)) -> logits (B, N, 2)."""
    if skip.device.type == "cpu":
        return fused_seg_decoder_plain(skip, gmax, dec_w, dec_b, logit_w, logit_b, bf16_operands)
    if skip.dim() != 3:
        raise ValueError(f"fused_seg_decoder: skip must be (B, N, 64), got {tuple(skip.shape)}")
    B, N, _ = skip.shape
    if B < 1 or N < 1:
        raise ValueError(f"fused_seg_decoder: unsupported skip shape {tuple(skip.shape)}")
    _require_cuda_f32("fused_seg_decoder skip", skip, (B, N, SKIP_CH))
    _require_cuda_f32("fused_seg_decoder gmax", gmax, (B, GLOBAL_CH))
    _require_layers(
        "fused_seg_decoder", dec_w, dec_b, DEC_FEATURES, SKIP_CH + GLOBAL_CH, skip.device
    )
    _require_cuda_f32("fused_seg_decoder logit_w", logit_w, (DEC_FEATURES[-1], 2))
    _require_cuda_f32("fused_seg_decoder logit_b", logit_b, (2,))
    if len({t.device for t in (skip, gmax, logit_w, logit_b)}) != 1:
        raise ValueError("fused_seg_decoder: inputs lie on different devices")

    from tdal_torch.ops.build import kernels

    lib = kernels()
    kw = dict(device=skip.device, dtype=torch.float32)
    gproj = torch.empty(B, DEC_FEATURES[0], **kw)
    out = torch.empty(B, N, 2, **kw)
    with torch.cuda.device(skip.device):
        lib.seg_decoder(
            skip, gmax, list(dec_w), list(dec_b), logit_w, logit_b, gproj, out,
            bool(bf16_operands),
        )
    launches["fused_seg_decoder"] += 1
    return out


def pointnet_seg_logits(folded, pts, bf16_operands: bool = False):
    """K1 then K2 on folded weights (``fold_pointnet_seg_params``): (B, N, Cin) ->
    logits (B, N, 2), the eval-mode ``PointNetSeg`` forward."""
    enc_w, enc_b, dec_w, dec_b, lw, lb = folded
    skip, gmax = fused_seg_encoder(pts, enc_w, enc_b, bf16_operands)
    return fused_seg_decoder(skip, gmax, dec_w, dec_b, lw, lb, bf16_operands)
