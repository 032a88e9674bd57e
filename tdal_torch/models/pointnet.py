"""PointNet building blocks of the Frustum-PointNet auto-labelers.

Port of ``tdal/models/pointnet.py``. Layout is channels-last ``(B, N, C)``: every
shared-MLP layer is an ``nn.Linear`` over the last axis, followed by flax's
BatchNorm (``tdal_torch.models.layers.BatchNorm``: momentum 0.9 in flax's terms, eps
1e-5, batch statistics over all other axes with the biased variance feeding the
running average), then ReLU.

In eval mode on a CUDA tensor, ``PointNetSeg`` runs folded BN -> K1 -> K2
(``tdal_torch.ops.fused_pointnet``) on weights folded and packed once per state of its
parameters and buffers; everywhere else, training included, it runs its layers.
Training takes its random draws as inputs: the dropout keep-mask of ``PointNetSeg``
and the gather noise of ``gather_object_points`` (``train_draws`` makes both from a
``torch.Generator``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from tdal_torch.core.codecs import (
    NUM_HEADING_BIN,
    NUM_SIZE_CLUSTER,
    class2angle,
    class2size,
    mean_size,
)
from tdal_torch.models.layers import BatchNorm
from tdal_torch.ops.fused_pointnet import (
    fold_pointnet_seg_params,
    pointnet_seg_logits,
    seg_weight_streams,
)
from tdal_torch.parallel.mesh import data_size, rank_rows

BOX_PRED_DIM = 3 + NUM_HEADING_BIN * 2 + NUM_SIZE_CLUSTER * 4  # 59

# flax BatchNorm momentum 0.9 keeps 0.9 of the old running stat: the port's 0.1 is the
# weight of the batch statistic
_BN_KW = dict(eps=1e-5, momentum=0.1)
DROPOUT_RATE = 0.5  # before the seg logits (tdal pointnet.py:113)


class DenseBNStack(nn.Module):
    """Linear + BatchNorm + ReLU per layer over the last axis of (..., C).

    ``dense[i]`` / ``bn[i]`` are flax's ``Dense_i`` / ``BatchNorm_i``."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        widths = [in_features, *features]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.bn = nn.ModuleList(BatchNorm(f, **_BN_KW) for f in features)

    def forward(self, x):
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x)))
        return x


class SharedMLP(DenseBNStack):
    """Per-point Linear + BatchNorm + ReLU stack over (B, N, C): the reference's
    Conv1d(k=1) + BatchNorm1d + ReLU."""


class PointNetSeg(nn.Module):
    """3D instance-segmentation PointNet: (B, N, C) -> logits (B, N, 2).

    Encoder (64, 64 | 64, 128, 1024) -> per-set max -> concat with the 64-ch skip
    (1088) -> decoder (512, 256, 128, 128) -> dropout -> 2 logits. Dropout is the
    identity in eval; in training ``keep`` (B, N, 128) bool is its keep-mask, and a
    kept activation is scaled by 1 / (1 - rate), as flax's ``nn.Dropout``."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.enc1 = SharedMLP(in_channels, [64, 64])
        self.enc2 = SharedMLP(64, [64, 128, 1024])
        self.dec = SharedMLP(64 + 1024, [512, 256, 128, 128])
        self.logits = nn.Linear(128, 2)
        self._packed_key, self._packed = None, None

    def packed(self):
        """(folded weights, K1's and K2's f32-operand weight streams), made again only
        when a parameter or buffer was replaced or written in place (its device, address
        or version counter changed; a write through ``.data`` bypasses the counter) since
        the last call. Weights made under ``torch.inference_mode`` keep no version
        counter and are packed on every call."""
        tensors = [*self.parameters(), *self.buffers()]
        key = None
        if not any(t.is_inference() for t in tensors):
            key = tuple((t.device, t.data_ptr(), t._version) for t in tensors)
        if key is None or key != self._packed_key:
            with torch.no_grad():
                folded = fold_pointnet_seg_params(self)
                # the cache holds the tensors it was made from, so that no new tensor
                # can take one of their addresses while it is kept
                self._packed_key = key
                self._packed = (folded, seg_weight_streams(folded), [t.detach() for t in tensors])
        return self._packed[:2]

    def forward(self, pts, keep=None):
        if not self.training and pts.is_cuda:
            folded, streams = self.packed()
            return pointnet_seg_logits(folded, pts, streams=streams)
        enc1 = self.enc1(pts)
        enc2 = self.enc2(enc1)
        global_feat = enc2.amax(dim=1, keepdim=True).expand(-1, pts.shape[1], -1)
        x = self.dec(torch.cat([enc1, global_feat], dim=-1))
        if self.training:
            if keep is None:
                raise ValueError("PointNetSeg: training needs the dropout keep-mask "
                                 "(see train_draws)")
            x = torch.where(keep, x / (1.0 - DROPOUT_RATE), torch.zeros_like(x))
        return self.logits(x)


class PointNetBoxEst(nn.Module):
    """Amodal box-estimation PointNet: (B, M, C) -> (B, 59).

    Shared MLP (128, 128, 256, 512) -> max-pool -> FC 512, 256 (+BN+ReLU) -> FC 59."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.mlp = SharedMLP(in_channels, [128, 128, 256, 512])
        self.fc = DenseBNStack(512, [512, 256])
        self.out = nn.Linear(256, BOX_PRED_DIM)

    def forward(self, pts):
        return self.out(self.fc(self.mlp(pts).amax(dim=1)))


def gather_object_points(pts, logits, n_pts: int, noise=None):
    """Gather ``n_pts`` predicted-object points per set.

    pts (B, N, C), logits (B, N, 2) -> (object_pts (B, n_pts, C), mask (B, N)).
    Positive points (logit 1 > logit 0) come first, ordered by ``noise`` (B, N) in
    [0, 1) when given, else by index; slot k >= n_pos wraps modulo n_pos; a set
    with no positive point gives zero rows. The sort is stable, as ``jnp.argsort``
    is: at eval every positive key ties at 2.0, and the lowest indices win when
    there are more positives than slots. Parity: tdal.models.pointnet."""
    b, n, _ = pts.shape
    mask = logits[..., 1] > logits[..., 0]
    key = mask.to(torch.float32) * 2.0
    if noise is not None:
        key = key + noise
    order = torch.argsort(-key, dim=1, stable=True)
    n_pos = mask.sum(dim=1)
    slot = torch.arange(n_pts, device=pts.device)[None, :]
    take = slot % n_pos.clamp_min(1)[:, None]
    idx = torch.gather(order, 1, take)
    gathered = torch.gather(pts, 1, idx[..., None].expand(-1, -1, pts.shape[-1]))
    return gathered * (n_pos > 0)[:, None, None].to(pts.dtype), mask


def train_draws(pts, generator: torch.Generator) -> dict:
    """The random draws of one labeler train forward over ``pts`` (B, N, C), from
    ``generator`` (on ``pts``' device), in this order: ``noise`` (B, N) uniform in
    [0, 1), the gather's sort key, and ``keep`` (B, N, 128) bool, the seg head's
    dropout keep-mask with keep probability 1 - ``DROPOUT_RATE``. Under an active
    data-parallel mesh both are drawn over the global batch (B times the world size
    rows, from the same generator on every rank) and this rank's rows are kept, so
    each row gets the draws of a single-process step."""
    b, n = pts.shape[0] * data_size(), pts.shape[1]
    noise = torch.rand((b, n), generator=generator, device=pts.device)
    keep = torch.rand((b, n, 128), generator=generator, device=pts.device) >= DROPOUT_RATE
    return {"noise": rank_rows(noise), "keep": rank_rows(keep)}


def parse_box_pred(box_pred):
    """Split the 59-dim box head output. Parity: tdal.models.pointnet.parse_box_pred."""
    b = box_pred.shape[0]
    c = 3
    center_delta = box_pred[:, :c]
    heading_scores = box_pred[:, c : c + NUM_HEADING_BIN]
    c += NUM_HEADING_BIN
    heading_residuals_normalized = box_pred[:, c : c + NUM_HEADING_BIN]
    c += NUM_HEADING_BIN
    size_scores = box_pred[:, c : c + NUM_SIZE_CLUSTER]
    c += NUM_SIZE_CLUSTER
    size_residuals_normalized = box_pred[:, c : c + 3 * NUM_SIZE_CLUSTER].reshape(
        b, NUM_SIZE_CLUSTER, 3
    )
    return {
        "center_delta": center_delta,
        "heading_scores": heading_scores,
        "heading_residuals_normalized": heading_residuals_normalized,
        "heading_residuals": heading_residuals_normalized * (np.pi / NUM_HEADING_BIN),
        "size_scores": size_scores,
        "size_residuals_normalized": size_residuals_normalized,
        "size_residuals": size_residuals_normalized * mean_size(box_pred),
    }


def decode_box_pred(parsed, center_base, heading_base):
    """Argmax-decode a parsed box prediction to a 7-dof box, detached.

    heading = class2angle(argmax bin) + heading_base, size = class2size(argmax
    cluster), center = center_delta + center_base."""
    heading_class = parsed["heading_scores"].argmax(dim=1)
    heading_residual = torch.gather(
        parsed["heading_residuals"], 1, heading_class[:, None]
    )[:, 0]
    size_class = parsed["size_scores"].argmax(dim=1)
    size_residual = parsed["size_residuals"][
        torch.arange(size_class.shape[0], device=size_class.device), size_class
    ]
    heading = class2angle(heading_class, heading_residual) + heading_base
    size = class2size(size_class, size_residual)
    box = torch.cat([parsed["center_delta"] + center_base, size, heading[:, None]], dim=1)
    return box.detach()
