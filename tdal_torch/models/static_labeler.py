"""Static-object auto-labeler (Frustum-PointNet over merged track points): eval
forwards of ``tdal/models/static_labeler.py:38-146``. The frustum losses arrive with
the training slice.

Inputs are canonicalized object point sets (B, N, 3) in the init-box frame and the
init box (B, 7) in the labeling frame (``tdal_torch.data.track_datasets``).
"""

from __future__ import annotations

import torch
from torch import nn

from tdal_torch.core.codecs import angle2class
from tdal_torch.models.pointnet import (
    PointNetBoxEst,
    PointNetSeg,
    decode_box_pred,
    gather_object_points,
    parse_box_pred,
)

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


def _require_eval(module: nn.Module):
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: only the eval forward is ported; call .eval()"
        )


class StaticLabelerOneBox(nn.Module):
    """Instance-seg PointNet -> object-point gather -> single box-estimation head."""

    def __init__(self, n_object_points: int = NUM_OBJECT_POINT):
        super().__init__()
        self.n_object_points = n_object_points
        self.seg = PointNetSeg(3)
        self.box_est = PointNetBoxEst(3)

    def forward(self, pts, init_box, bbox_gt=None):
        """pts (B, N, 3), init_box (B, 7) -> output dict (reference :131-145)."""
        _require_eval(self)
        logits = self.seg(pts)
        object_pts, mask = gather_object_points(pts[..., :3], logits, self.n_object_points)
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

    def forward(self, pts, init_box, bbox_gt=None):
        _require_eval(self)
        logits = self.seg(pts)
        object_pts, mask = gather_object_points(pts[..., :3], logits, self.n_object_points)

        one = parse_box_pred(self.box_est_one(object_pts))
        center_one = one["center_delta"] + init_box[:, :3]
        box_one = decode_box_pred(
            {**one, "center_delta": center_one.detach()},
            center_base=torch.zeros_like(center_one),
            heading_base=init_box[:, 6],
        )  # (B, 7) in the labeling frame

        # init-box frame -> labeling frame -> box-one frame (reference :196-200)
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
