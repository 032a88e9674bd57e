"""Two-stage CenterPoint: the BEV feature gather at box sample points and the RoIHead.

Port of ``tdal/models/two_stage.py``, batch-major:

- ``bilinear_interpolate``, ``get_box_centers`` (5-point sampling: centre and the four
  side midpoints) and ``BEVFeatureExtractor``;
- ``RoIHead``: the shared FC stack and the IoU-score / box-regression branches, with
  flax-semantics BatchNorms (momentum 0.9 -> 0.1, eps 1e-5, biased running variance:
  ``layers.BatchNorm``). Its dropout masks are inputs (``roi_head_draws`` draws them
  from a ``torch.Generator``), so a test can feed both sides the same ones;
- ``proposal_targets`` (per-image subsampling of ``roi_per_image`` RoIs: fg, hard and
  easy bg by masked sorts with wrap-around, fixed shapes). Its random draws are an
  input too: (B, 3, K) uniforms, one row each for the fg, hard-bg and easy-bg orders
  (``proposal_draws``), where tdal splits a key per sample and then in three;
- ``assign_roi_targets``, ``roi_losses``, ``generate_predicted_boxes`` and
  ``two_stage_post_process`` (sqrt(iou * score) rescoring). Under an active
  data-parallel mesh the losses' normalizers are global sums, so each rank's loss is
  its share of the global batch's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from tdal_torch.core.iou import boxes_iou_3d
from tdal_torch.models.layers import BatchNorm
from tdal_torch.parallel.mesh import all_reduce_sum

# ---------------------------------------------------------------------------
# BEV feature extraction
# ---------------------------------------------------------------------------


def _bilinear(im, x, y):
    """im (B, H, W, C); x, y (B, N) continuous grid coords -> (B, N, C)."""
    b, h, w, c = im.shape
    xf, yf = torch.floor(x), torch.floor(y)
    x0 = xf.long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y0 = yf.long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    flat = im.reshape(b, h * w, c)

    def at(yy, xx):
        return flat.gather(1, (yy * w + xx)[..., None].expand(-1, -1, c))

    wa = (xf + 1 - x) * (yf + 1 - y)
    wb = (xf + 1 - x) * (y - yf)
    wc = (x - xf) * (yf + 1 - y)
    wd = (x - xf) * (y - yf)
    return (at(y0, x0) * wa[..., None] + at(y1, x0) * wb[..., None]
            + at(y0, x1) * wc[..., None] + at(y1, x1) * wd[..., None])


def bilinear_interpolate(im, x, y):
    """im (H, W, C); x, y (N,) -> (N, C). The weights use the unclamped neighbour
    positions (tdal's choice: the reference clamps first, which zeroes samples on the far
    border)."""
    return _bilinear(im[None], x[None], y[None])[0]


def get_box_centers(boxes, num_point: int = 5):
    """boxes (B, K, >=7, heading last) -> (B, K, num_point, 3) sample points: the
    centre, then the (-dx, 0), (dx, 0), (0, -dy), (0, dy) side midpoints."""
    center = boxes[..., :3]
    if num_point == 1:
        return center[..., None, :]
    if num_point != 5:
        raise ValueError(f"num_point must be 1 or 5, not {num_point}")
    h = boxes[..., -1]
    c, s = torch.cos(h), torch.sin(h)
    dx, dy = boxes[..., 3] / 2.0, boxes[..., 4] / 2.0
    zero = torch.zeros_like(dx)

    def world(lx, ly):
        return torch.stack([center[..., 0] + c * lx - s * ly,
                            center[..., 1] + s * lx + c * ly, center[..., 2]], dim=-1)

    return torch.stack([center, world(-dx, zero), world(dx, zero), world(zero, -dy),
                        world(zero, dy)], dim=-2)


@dataclasses.dataclass(frozen=True)
class BEVFeatureExtractor:
    """Bilinear gather of BEV features at box sample points."""

    pc_start: tuple
    voxel_size: tuple
    out_stride: int

    def __call__(self, bev_feature, centers):
        """bev_feature (B, H, W, C); centers (B, K, P, 3) -> (B, K, P * C)."""
        b, k, p, _ = centers.shape
        xs = (centers[..., 0] - self.pc_start[0]) / self.voxel_size[0] / self.out_stride
        ys = (centers[..., 1] - self.pc_start[1]) / self.voxel_size[1] / self.out_stride
        feats = _bilinear(bev_feature, xs.reshape(b, -1), ys.reshape(b, -1))
        return feats.reshape(b, k, p * bev_feature.shape[-1])


# ---------------------------------------------------------------------------
# RoIHead
# ---------------------------------------------------------------------------


class _FCBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=False)
        self.bn = BatchNorm(cout, momentum=0.1, eps=1e-5)

    def forward(self, x):
        return torch.relu(self.bn(self.linear(x)))


class RoIHead(nn.Module):
    """(B, K, Cin) RoI features -> (rcnn_cls (B, K, num_class), rcnn_reg (B, K,
    code_size)). ``shared`` / ``cls_layers`` / ``reg_layers`` are Linear (no bias) +
    BatchNorm + ReLU; ``cls_out`` / ``reg_out`` the final Linears (bias, init
    normal(0.001)). In training, dropout follows every shared layer but the last and
    the first layer of each branch, with the keep-masks ``dropout`` (``roi_head_draws``)
    in that order."""

    def __init__(self, in_channels: int, shared_fc: Sequence[int] = (256, 256),
                 cls_fc: Sequence[int] = (256, 256), reg_fc: Sequence[int] = (256, 256),
                 code_size: int = 7, num_class: int = 1, dp_ratio: float = 0.3):
        super().__init__()
        self.code_size, self.dp_ratio = code_size, dp_ratio

        def stack(cin, widths):
            layers = []
            for f in widths:
                layers.append(_FCBN(cin, f))
                cin = f
            return nn.ModuleList(layers), cin

        self.shared, c = stack(in_channels, shared_fc)
        self.cls_layers, c_cls = stack(c, cls_fc)
        self.reg_layers, c_reg = stack(c, reg_fc)
        self.cls_out = nn.Linear(c_cls, num_class)
        self.reg_out = nn.Linear(c_reg, code_size)

    def dropout_sites(self) -> list:
        """(layer list, index) of each dropout, in the order the masks are taken."""
        sites = []
        if self.dp_ratio > 0:
            sites += [(self.shared, i) for i in range(len(self.shared) - 1)]
        if self.dp_ratio >= 0:
            sites += [(layers, 0) for layers in (self.cls_layers, self.reg_layers) if layers]
        return sites

    def forward(self, roi_features, dropout=None):
        if self.training and dropout is None and self.dropout_sites():
            raise ValueError("RoIHead in train mode needs its dropout masks "
                             "(roi_head_draws)")
        masks = iter(dropout or ())
        keep = 1.0 - self.dp_ratio
        sites = {(id(layers), i) for layers, i in self.dropout_sites()}

        def run(layers, x):
            for i, layer in enumerate(layers):
                x = layer(x)
                if self.training and (id(layers), i) in sites:
                    x = torch.where(next(masks), x / keep, torch.zeros_like(x))
            return x

        x = run(self.shared, roi_features)
        return self.cls_out(run(self.cls_layers, x)), self.reg_out(run(self.reg_layers, x))


def roi_head_draws(head: RoIHead, b: int, k: int, generator: torch.Generator, device=None):
    """The keep-masks (B, K, width) of ``head``'s dropouts, Bernoulli(1 - dp_ratio)
    from ``generator``, in the order ``RoIHead.forward`` takes them."""
    masks = []
    for layers, i in head.dropout_sites():
        width = layers[i].linear.out_features
        u = torch.rand(b, k, width, generator=generator)
        masks.append((u < 1.0 - head.dp_ratio).to(device))
    return masks


# ---------------------------------------------------------------------------
# Proposal target assignment (train only)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoiTargetConfig:
    roi_per_image: int = 128
    fg_ratio: float = 0.5
    sample_roi_by_each_class: bool = True
    cls_score_type: str = "roi_iou"
    cls_fg_thresh: float = 0.75
    cls_bg_thresh: float = 0.25
    cls_bg_thresh_lo: float = 0.1
    hard_bg_ratio: float = 0.8
    reg_fg_thresh: float = 0.55


def proposal_draws(b: int, k: int, generator: torch.Generator, device=None):
    """(B, 3, K) uniforms in [0, 1) for ``proposal_targets``' fg / hard-bg / easy-bg
    orders."""
    return torch.rand(b, 3, k, generator=generator).to(device)


def _subsample(draws, iou_max, cfg: RoiTargetConfig):
    """Fixed-shape fg / hard-bg / easy-bg subsampling over a batch: draws (B, 3, K),
    iou_max (B, K) -> (B, M) indices into the RoIs (proposal_target_layer.py:
    119-210)."""
    m = cfg.roi_per_image
    fg_target = int(round(cfg.fg_ratio * m))
    fg = iou_max >= min(cfg.reg_fg_thresh, cfg.cls_fg_thresh)
    easy = iou_max < cfg.cls_bg_thresh_lo
    hard = ~fg & ~easy

    def order(mask, u):
        return torch.argsort(-(mask.float() * 2.0 + u), dim=1, stable=True)

    fg_order, hard_order, easy_order = (order(mask, draws[:, i])
                                        for i, mask in enumerate((fg, hard, easy)))
    n_fg, n_hard, n_easy = (x.sum(1, keepdim=True) for x in (fg, hard, easy))
    n_fg_take = n_fg.clamp_max(fg_target)
    n_bg = m - n_fg_take
    n_hard_take = torch.where(
        n_easy > 0, torch.minimum((n_bg * cfg.hard_bg_ratio).long(), n_hard),
        torch.where(n_hard > 0, n_bg, 0))
    n_hard_take = torch.where(n_hard > 0, n_hard_take, 0)
    slots = torch.arange(m, device=iou_max.device)[None, :]
    fg_idx = fg_order.gather(1, slots % n_fg.clamp_min(1))
    hard_idx = hard_order.gather(1, (slots - n_fg_take) % n_hard.clamp_min(1))
    easy_idx = easy_order.gather(1, (slots - n_fg_take - n_hard_take) % n_easy.clamp_min(1))
    idx = torch.where(slots < n_fg_take, fg_idx,
                      torch.where(slots < n_fg_take + n_hard_take, hard_idx, easy_idx))
    # no background at all: fg fills every slot, with replacement
    return torch.where((n_hard + n_easy) == 0, fg_idx, idx)


def _take(x, idx):
    """x (B, K, ...) rows at idx (B, M)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape[0], -1, *([1] * (x.dim() - 2)))
    return x.gather(1, flat.expand(-1, -1, *x.shape[2:])).reshape(shape)


def proposal_targets(draws, rois, roi_scores, roi_labels, roi_features, gt_boxes_and_cls,
                     cfg: RoiTargetConfig) -> dict:
    """Batched RoI sampling and target assignment. rois (B, K, >=7, heading at 6),
    roi_labels (B, K) 1-based (0 = padding), gt_boxes_and_cls (B, G, code + 1), class
    last (all-zero rows = padding); draws (B, 3, K) from ``proposal_draws``. Returns a
    dict of (B, M, ...) tensors."""
    gt_labels = gt_boxes_and_cls[..., -1]
    iou = boxes_iou_3d(rois[..., :7], gt_boxes_and_cls[..., :7])  # (B, K, G)
    if cfg.sample_roi_by_each_class:
        iou = torch.where(roi_labels[..., :, None] == gt_labels[..., None, :], iou, 0.0)
    valid_gt = gt_boxes_and_cls.abs().sum(-1) > 0
    iou = torch.where(valid_gt[..., None, :], iou, 0.0)
    iou_max, gt_assign = iou.max(dim=-1)
    sel = _subsample(draws, iou_max, cfg)
    b_rois = _take(rois, sel)
    b_gt = _take(gt_boxes_and_cls, gt_assign.gather(1, sel))
    b_iou = iou_max.gather(1, sel)
    targets = {
        "rois": b_rois,
        "gt_of_rois_src": b_gt,
        "gt_iou_of_rois": b_iou,
        "roi_scores": roi_scores.gather(1, sel),
        "roi_labels": roi_labels.gather(1, sel),
        "roi_features": _take(roi_features, sel),
        "reg_valid_mask": (b_iou > cfg.reg_fg_thresh).int(),
    }
    if cfg.cls_score_type == "roi_iou":
        fg, bg = b_iou > cfg.cls_fg_thresh, b_iou < cfg.cls_bg_thresh
        soft = (b_iou - cfg.cls_bg_thresh) / (cfg.cls_fg_thresh - cfg.cls_bg_thresh)
        targets["rcnn_cls_labels"] = torch.where(
            fg, 1.0, torch.where(~fg & ~bg, soft, torch.zeros_like(soft)))
    else:
        targets["rcnn_cls_labels"] = (b_iou > cfg.cls_fg_thresh).float()
    targets["gt_of_rois"] = assign_roi_targets(b_rois, b_gt)
    return targets


def assign_roi_targets(rois, gt_of_rois):
    """GT boxes in each RoI's frame, heading flipped into [-pi/2, pi/2]
    (roi_head_template.assign_targets, :43-86). rois (B, M, C), gt_of_rois
    (B, M, C + 1) -> (B, M, C + 1)."""
    two_pi = 2 * math.pi
    roi_ry = rois[..., 6] - torch.floor(rois[..., 6] / two_pi + 0.5) * two_pi
    gt = gt_of_rois
    delta = gt[..., :6] - rois[..., :6]
    heading = gt[..., 6] - roi_ry
    c, s = torch.cos(-roi_ry), torch.sin(-roi_ry)
    x = c * delta[..., 0] - s * delta[..., 1]
    y = s * delta[..., 0] + c * delta[..., 1]
    rest = gt[..., 7:]
    if rois.shape[-1] == 9:
        rest = torch.cat([gt[..., 7:-1] - rois[..., 7:9], gt[..., -1:]], dim=-1)
    h = torch.remainder(heading, two_pi)
    opp = (h > math.pi * 0.5) & (h < math.pi * 1.5)
    h = torch.where(opp, torch.remainder(h + math.pi, two_pi), h)
    h = torch.where(h > math.pi, h - two_pi, h)
    h = h.clamp(-math.pi / 2, math.pi / 2)
    return torch.cat([torch.stack([x, y], dim=-1), delta[..., 2:6], h[..., None], rest],
                     dim=-1)


def roi_losses(rcnn_cls, rcnn_reg, targets, code_weights, cls_weight=1.0, reg_weight=1.0):
    """BCE on the IoU soft labels + masked, weighted L1 on the canonical residuals
    (roi_head_template.get_loss, :88-151) -> (cls loss, reg loss)."""
    labels = targets["rcnn_cls_labels"].reshape(-1)
    p = torch.sigmoid(rcnn_cls.reshape(-1)).clamp(1e-7, 1 - 1e-7)
    bce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    valid = (labels >= 0).float()
    loss_cls = (bce * valid).sum() / all_reduce_sum(valid.sum(), "data").clamp_min(1.0) * cls_weight
    code_size = rcnn_reg.shape[-1]
    reg_targets = targets["gt_of_rois"][..., :code_size].reshape(-1, code_size)
    fg = (targets["reg_valid_mask"].reshape(-1) > 0).float()
    l1 = (rcnn_reg.reshape(-1, code_size) - reg_targets).abs()
    l1 = l1 * torch.as_tensor(code_weights, dtype=l1.dtype, device=l1.device)
    loss_reg = (l1 * fg[:, None]).sum() / all_reduce_sum(fg.sum(), "data").clamp_min(1.0) * reg_weight
    return loss_cls, loss_reg


def generate_predicted_boxes(rois, rcnn_reg):
    """Canonical residuals back to world boxes (roi_head_template, :153-182)."""
    code_size = rcnn_reg.shape[-1]
    local = rcnn_reg + torch.cat([torch.zeros_like(rois[..., :3]), rois[..., 3:code_size]],
                                 dim=-1)
    c, s = torch.cos(rois[..., 6]), torch.sin(rois[..., 6])
    x = c * local[..., 0] - s * local[..., 1]
    y = s * local[..., 0] + c * local[..., 1]
    return torch.cat([torch.stack([x + rois[..., 0], y + rois[..., 1]], dim=-1),
                      (local[..., 2] + rois[..., 2])[..., None], local[..., 3:]], dim=-1)


def two_stage_post_process(batch_box_preds, rcnn_cls, roi_scores, roi_labels, valid):
    """sqrt(sigmoid(iou) * first-stage score) rescoring, labels back to 0-based
    (two_stage.py:121-151): a fixed-shape dict with ``valid``."""
    scores = torch.sqrt(torch.sigmoid(rcnn_cls[..., 0]) * roi_scores.clamp_min(0.0))
    boxes = batch_box_preds
    if boxes.shape[-1] == 9:
        boxes = boxes[..., [0, 1, 2, 3, 4, 5, 7, 8, 6]]
    ok = valid & (roi_labels != 0)
    return {"box3d_lidar": boxes,
            "scores": torch.where(ok, scores, torch.full_like(scores, -math.inf)),
            "label_preds": (roi_labels - 1).clamp_min(0),
            "valid": ok}
