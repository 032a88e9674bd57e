"""Static-object auto-labeler (Frustum-PointNet over merged track points): the
forwards and the frustum losses of ``tdal/models/static_labeler.py``.

Inputs are canonicalized object point sets (B, N, 3) in the init-box frame and the
init box (B, 7) in the labeling frame (``tdal_torch.data.track_datasets``). In
training the forwards also take the random draws of ``tdal_torch.models.pointnet.
train_draws``: ``noise`` orders the object-point gather, ``keep`` is the seg head's
dropout mask.

The losses' means are ``partial_mean``s: under an active data-parallel mesh each rank's
loss is its share of the mean over the global batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdal_torch.core.codecs import NUM_HEADING_BIN, NUM_SIZE_CLUSTER, angle2class, mean_size
from tdal_torch.models.pointnet import (
    PointNetBoxEst,
    PointNetSeg,
    decode_box_pred,
    gather_object_points,
    parse_box_pred,
)
from tdal_torch.parallel.mesh import partial_mean

NUM_OBJECT_POINT = 512  # static_model.py:14
NUM_POINT = 4096  # static_model.py:15

_HEAD_KEYS = (
    "heading_scores",
    "heading_residuals_normalized",
    "heading_residuals",
    "size_scores",
    "size_residuals_normalized",
    "size_residuals",
)


def _train_noise(module: nn.Module, noise):
    """The gather noise a forward uses: ``noise`` in training (where it is required),
    None (index order) in eval."""
    if not module.training:
        return None
    if noise is None:
        raise ValueError(f"{type(module).__name__}: training needs the gather noise "
                         "(see tdal_torch.models.pointnet.train_draws)")
    return noise


class StaticLabelerOneBox(nn.Module):
    """Instance-seg PointNet -> object-point gather -> single box-estimation head."""

    def __init__(self, n_object_points: int = NUM_OBJECT_POINT):
        super().__init__()
        self.n_object_points = n_object_points
        self.seg = PointNetSeg(3)
        self.box_est = PointNetBoxEst(3)

    def forward(self, pts, init_box, bbox_gt=None, noise=None, keep=None):
        """pts (B, N, 3), init_box (B, 7) -> output dict (reference :131-145)."""
        logits = self.seg(pts, keep)
        object_pts, mask = gather_object_points(pts[..., :3], logits, self.n_object_points,
                                                _train_noise(self, noise))
        out = parse_box_pred(self.box_est(object_pts))
        out["logits"] = logits
        out["mask"] = mask
        out["center_boxnet"] = out["center_delta"]
        out["center"] = out["center_delta"] + init_box[:, :3]
        return out


class StaticLabelerTwoBox(nn.Module):
    """Cascade: head one refines the init box, the object points are re-canonicalized
    into box one's frame (detached), head two refines again."""

    def __init__(self, n_object_points: int = NUM_OBJECT_POINT):
        super().__init__()
        self.n_object_points = n_object_points
        self.seg = PointNetSeg(3)
        self.box_est_one = PointNetBoxEst(3)
        self.box_est_two = PointNetBoxEst(3)

    def forward(self, pts, init_box, bbox_gt=None, noise=None, keep=None):
        logits = self.seg(pts, keep)
        object_pts, mask = gather_object_points(pts[..., :3], logits, self.n_object_points,
                                                _train_noise(self, noise))

        one = parse_box_pred(self.box_est_one(object_pts))
        center_one = one["center_delta"] + init_box[:, :3]
        box_one = decode_box_pred(
            {**one, "center_delta": center_one.detach()},
            center_base=torch.zeros_like(center_one),
            heading_base=init_box[:, 6],
        )  # (B, 7) in the labeling frame

        # init-box frame -> labeling frame -> box-one frame (reference :196-200); no
        # gradient reaches head one or the seg net through box one or these points
        p = object_pts.detach()
        ci, si = torch.cos(init_box[:, 6:7]), torch.sin(init_box[:, 6:7])
        x = ci * p[..., 0] - si * p[..., 1] + init_box[:, 0:1] - box_one[:, 0:1]
        y = si * p[..., 0] + ci * p[..., 1] + init_box[:, 1:2] - box_one[:, 1:2]
        z = p[..., 2] + init_box[:, 2:3] - box_one[:, 2:3]
        c1, s1 = torch.cos(-box_one[:, 6:7]), torch.sin(-box_one[:, 6:7])
        object_pts_two = torch.stack([c1 * x - s1 * y, s1 * x + c1 * y, z], dim=-1)

        two = parse_box_pred(self.box_est_two(object_pts_two))
        center_two = two["center_delta"] + center_one
        out = {
            "logits": logits,
            "mask": mask,
            "center_one": center_one,
            "box_one": box_one,
            "center_two": center_two,
            "center": center_two,
        }
        for k in _HEAD_KEYS:
            out[k + "_one"] = one[k]
            out[k + "_two"] = two[k]
            out[k] = two[k]
        if bbox_gt is not None:  # labels for head two, relative to box one (:207-212)
            h2_cls, h2_res = angle2class(bbox_gt[:, 6] - box_one[:, 6])
            out["heading_class_label_two"] = h2_cls
            out["heading_residuals_label_two"] = h2_res
        return out


# ---------------------------------------------------------------------------
# Losses (tdal/models/static_labeler.py:154-288)
# ---------------------------------------------------------------------------


def huber(error, delta: float = 1.0):
    """Elementwise-then-mean huber. Parity: static_model.py:341-346."""
    abs_error = error.abs()
    quadratic = abs_error.clamp_max(delta)
    linear = abs_error - quadratic
    return partial_mean(0.5 * quadratic**2 + delta * linear)


def _nll(logits, labels):
    """Mean negative log-likelihood of integer ``labels`` under ``logits`` (B, K)."""
    return -partial_mean(torch.gather(F.log_softmax(logits, dim=1), 1, labels.long()[:, None]))


def _seg_loss(logits, mask_label):
    return _nll(logits.reshape(-1, 2), mask_label.reshape(-1))


def _box_terms(center, heading_scores, heading_residuals_normalized, size_scores,
               size_residuals_normalized, center_label, heading_class_label,
               heading_residuals_label, size_class_label, size_residuals_label):
    """The center/heading/size loss terms shared by every labeler head.

    Parity: FrustumPointNetLossOneBoxEst body (static_model.py:383-412)."""
    center_loss = huber(torch.linalg.norm(center - center_label, dim=1), delta=2.0)

    heading_class_loss = _nll(heading_scores, heading_class_label)
    h_onehot = F.one_hot(heading_class_label.long(), NUM_HEADING_BIN).to(center.dtype)
    h_res_norm_label = heading_residuals_label / (np.pi / NUM_HEADING_BIN)
    h_res_norm_pred = (heading_residuals_normalized * h_onehot).sum(dim=1)
    heading_res_loss = huber(h_res_norm_pred - h_res_norm_label, delta=1.0)

    size_class_loss = _nll(size_scores, size_class_label)
    s_onehot = F.one_hot(size_class_label.long(), NUM_SIZE_CLUSTER).to(center.dtype)
    s_res_norm_pred = (size_residuals_normalized * s_onehot[:, :, None]).sum(dim=1)
    s_res_norm_label = size_residuals_label / (s_onehot @ mean_size(size_scores))
    size_res_loss = huber(torch.linalg.norm(s_res_norm_label - s_res_norm_pred, dim=1),
                          delta=1.0)
    return center_loss, heading_class_loss, heading_res_loss, size_class_loss, size_res_loss


def frustum_loss_one_box(output, labels, w_box: float = 1.0):
    """labels: mask_label (B, N), center_label (B, 3), heading_class_label (B,),
    heading_residuals_label (B,), size_class_label (B,), size_residuals_label (B, 3).

    Parity: FrustumPointNetLossOneBoxEst (static_model.py:348-425); also the dynamic
    labeler's loss (DynamicModelLoss, dynamic_model.py:321-398)."""
    mask_loss = _seg_loss(output["logits"], labels["mask_label"])
    c, hc, hr, sc, sr = _box_terms(
        output["center"], output["heading_scores"], output["heading_residuals_normalized"],
        output["size_scores"], output["size_residuals_normalized"], labels["center_label"],
        labels["heading_class_label"], labels["heading_residuals_label"],
        labels["size_class_label"], labels["size_residuals_label"],
    )
    total = mask_loss + w_box * (c * 10 + hc + sc + hr * 20 + sr * 20)
    return {
        "total_loss": total,
        "mask_loss": mask_loss,
        "center_loss": w_box * c * 10,
        "heading_class_loss": w_box * hc,
        "size_class_loss": w_box * sc,
        "heading_residuals_normalized_loss": w_box * hr * 20,
        "size_residuals_normalized_loss": w_box * sr * 20,
    }


def frustum_loss_two_box(output, labels, w_box: float = 1.0):
    """Parity: FrustumPointNetLossTwoBoxEst (static_model.py:427-517); head two's
    heading labels are the output's (relative to box one)."""
    mask_loss = _seg_loss(output["logits"], labels["mask_label"])
    common = (labels["center_label"],)
    one = _box_terms(
        output["center_one"], output["heading_scores_one"],
        output["heading_residuals_normalized_one"], output["size_scores_one"],
        output["size_residuals_normalized_one"], *common, labels["heading_class_label"],
        labels["heading_residuals_label"], labels["size_class_label"],
        labels["size_residuals_label"],
    )
    two = _box_terms(
        output["center_two"], output["heading_scores_two"],
        output["heading_residuals_normalized_two"], output["size_scores_two"],
        output["size_residuals_normalized_two"], *common,
        output["heading_class_label_two"], output["heading_residuals_label_two"],
        labels["size_class_label"], labels["size_residuals_label"],
    )
    (c1, hc1, hr1, sc1, sr1), (c2, hc2, hr2, sc2, sr2) = one, two
    total = mask_loss + w_box * (
        c1 * 10 + hc1 + sc1 + hr1 * 20 + sr1 * 20
        + c2 * 10 + hc2 + sc2 + hr2 * 20 + sr2 * 20
    )
    out = {"total_loss": total, "mask_loss": mask_loss}
    for tag, (c, hc, hr, sc, sr) in (("one", one), ("two", two)):
        out[f"center_loss_{tag}"] = w_box * c * 10
        out[f"heading_class_loss_{tag}"] = w_box * hc
        out[f"size_class_loss_{tag}"] = w_box * sc
        out[f"heading_residuals_normalized_loss_{tag}"] = w_box * hr * 20
        out[f"size_residuals_normalized_loss_{tag}"] = w_box * sr * 20
    return out
