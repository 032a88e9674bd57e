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
# The kernels' weight streams
# ---------------------------------------------------------------------------

# The kernels read a tf32 A fragment's k positions 0..7 from accumulator columns
# 0, 2, 4, 6, 1, 3, 5, 7 of each group of 8, so with f32 operands a weight whose input
# is a kernel accumulator has its input rows permuted the same way.
PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)


def _layout(parts, e: int, k_slice: int | None = None, n_slice: int | None = None,
            permute: bool = False, n_outer: bool = False):
    """Weight parts (P, K, N), (in, out), in the kernels' wgmma B operand order (flat).

    The stream is cut into slices of ``k_slice`` input x ``n_slice`` output channels
    (default: all), ordered by input then output slice, each the shared-memory image of
    one ring stage: its P parts (f32: hi, lo; bf16: one) one after the other. A part
    is 64-output tiles; a tile is K-major core matrices of 8 output rows x 16 bytes of
    inputs (``e`` elements), ordered by 16-byte input column, then 8-row group.
    ``permute`` orders the input rows by ``PERM8`` (f32 only: the bf16 fragments take
    accumulator columns as they lie); ``n_outer`` orders slices by output slice first."""
    p, k, n = parts.shape
    if permute and e == 4:
        idx = torch.arange(k, device=parts.device)
        parts = parts[:, (idx // 8) * 8 + torch.tensor(PERM8, device=parts.device)[idx % 8]]
    ks, ns = k_slice or k, n_slice or n
    t = parts.reshape(p, k // ks, ks // e, e, n // ns, ns // 64, 8, 8)
    # (part, k slice, input column, element, n slice, tile, row group, row) ->
    # (k slice, n slice, part, tile, input column, row group, row, element)
    order = (4, 1) if n_outer else (1, 4)
    return t.permute(*order, 0, 5, 2, 6, 7, 3).reshape(-1)


def _encoder_layout(ws, parts_of, e):
    """K1 reads layers 2, 3 and 4 whole, then layer 5 by 128 outputs, each in two slices
    of 64 inputs (every input is a kernel accumulator)."""
    return torch.cat([*(_layout(parts_of(w), e, permute=True) for w in ws[:3]),
                      _layout(parts_of(ws[3]), e, k_slice=64, n_slice=128, n_outer=True,
                              permute=True)])


def _decoder_layout(ws, parts_of, e):
    """K2's point kernel reads, for each 64-output chunk c of layer 1, W0[:64]'s columns
    of c (its input is the skip, read as it lies) and layer 2's rows of c in two slices
    of 32; then layers 3 and 4 in slices of 32 inputs. Its gproj kernel then reads
    W0[64:] (input gmax, as it lies) by 64-output tile, each in 8 slices of 128 inputs."""
    chunks = _layout(parts_of(ws[0]), e, n_slice=64).view(8, -1)
    l1 = _layout(parts_of(ws[1]), e, k_slice=32, permute=True).view(8, -1)
    return torch.cat([torch.cat([chunks, l1], dim=1).reshape(-1),
                      *(_layout(parts_of(w), e, k_slice=32, permute=True) for w in ws[2:4]),
                      _layout(parts_of(ws[4]), e, k_slice=128, n_slice=64, n_outer=True)])


def _stream_weights(decoder: bool, ws):
    """The weights a kernel's stream holds: K1 layers 2-5; K2 W0[:64], layers 2-4 and
    W0[64:]."""
    return [ws[0][:SKIP_CH], *ws[1:4], ws[0][SKIP_CH:]] if decoder else list(ws[1:5])


def _tf32_parts(w):
    """(hi, lo) of f32 weights: hi with its 13 low mantissa bits cleared, lo = w - hi."""
    hi = (w.view(torch.int32) & ~0x1FFF).view(torch.float32)
    return torch.stack([hi, w - hi])


def weight_stream(decoder: bool, ws, bf16: bool):
    """The packed weight stream K1 (``decoder`` False, ``ws`` = enc_w) or K2 (``ws`` =
    dec_w) reads: f32 operands as hi (the 13 low mantissa bits cleared) and lo = w - hi,
    bf16 operands rounded once. Made on the weights' device."""
    if bf16:
        parts_of, e = (lambda w: w.to(torch.bfloat16)[None]), 8
    else:
        parts_of, e = _tf32_parts, 4
    layout = _decoder_layout if decoder else _encoder_layout
    return layout(_stream_weights(decoder, ws), parts_of, e)


def seg_weight_streams(folded, bf16_operands: bool = False):
    """K1's and K2's weight streams of folded weights (``fold_pointnet_seg_params``), for
    callers that launch both many times on the same weights (``PointNetSeg`` keeps them
    while its weights are unchanged)."""
    return (weight_stream(False, folded[0], bool(bf16_operands)),
            weight_stream(True, folded[2], bool(bf16_operands)))


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


def _require_stream(lib, stream, decoder: bool, bf16: bool):
    want = lib.seg_stream_bytes(decoder, bf16)
    if stream.numel() * stream.element_size() != want:
        raise RuntimeError(f"weight stream of {stream.numel() * stream.element_size()} "
                           f"bytes, the kernel reads {want}")


def fused_seg_encoder(pts, enc_w, enc_b, bf16_operands: bool = False, stream=None):
    """K1: pts (B, N, Cin) f32, Cin in {3, 4}, any N >= 1 ->
    (skip (B, N, 64), gmax (B, 1024)). ``stream``: ``weight_stream(False, enc_w,
    bf16_operands)`` made before, else it is made here."""
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
    bf16 = bool(bf16_operands)
    if stream is None:
        stream = weight_stream(False, enc_w, bf16)
    _require_stream(lib, stream, False, bf16)
    n_tiles = -(-N // lib.encoder_tile())
    kw = dict(device=pts.device, dtype=torch.float32)
    skip = torch.empty(B, N, SKIP_CH, **kw)
    partial = torch.empty(B, n_tiles, GLOBAL_CH, **kw)
    gmax = torch.empty(B, GLOBAL_CH, **kw)
    with torch.cuda.device(pts.device):
        lib.seg_encoder(pts, enc_w[0], list(enc_b), stream, skip, partial, gmax, bf16)
    launches["fused_seg_encoder"] += 1
    return skip, gmax


def fused_seg_decoder(skip, gmax, dec_w, dec_b, logit_w, logit_b,
                      bf16_operands: bool = False, stream=None):
    """K2: (skip (B, N, 64), gmax (B, 1024)) -> logits (B, N, 2). ``stream``:
    ``weight_stream(True, dec_w, bf16_operands)`` made before, else it is made here."""
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
    bf16 = bool(bf16_operands)
    if stream is None:
        stream = weight_stream(True, dec_w, bf16)
    _require_stream(lib, stream, True, bf16)
    kw = dict(device=skip.device, dtype=torch.float32)
    gproj = torch.empty(B, DEC_FEATURES[0], **kw)
    out = torch.empty(B, N, 2, **kw)
    with torch.cuda.device(skip.device):
        lib.seg_decoder(skip, gmax, list(dec_b), stream, logit_w, logit_b, gproj, out, bf16)
    launches["fused_seg_decoder"] += 1
    return out


def pointnet_seg_logits(folded, pts, bf16_operands: bool = False, streams=(None, None)):
    """K1 then K2 on folded weights (``fold_pointnet_seg_params``): (B, N, Cin) ->
    logits (B, N, 2), the eval-mode ``PointNetSeg`` forward. ``streams``: their
    ``seg_weight_streams`` in this operand mode, where made before."""
    enc_w, enc_b, dec_w, dec_b, lw, lb = folded
    skip, gmax = fused_seg_encoder(pts, enc_w, enc_b, bf16_operands, streams[0])
    return fused_seg_decoder(skip, gmax, dec_w, dec_b, lw, lb, bf16_operands, streams[1])
