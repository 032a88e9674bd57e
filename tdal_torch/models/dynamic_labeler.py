"""Dynamic-object auto-labeler: per-frame Frustum-PointNet + box-trajectory
embedding. Port of ``tdal/models/dynamic_labeler.py``: the forward (training takes
the draws of ``tdal_torch.models.pointnet.train_draws``) and ``dynamic_loss``, the
one-box frustum loss.

pts (B, 5*1024, 4) (xyz + frame time), boxes (B, 101, 8) (box + time) -> the 59-dim
box prediction; the predicted center is a delta from the center-frame init box.
"""

from __future__ import annotations

import torch
from torch import nn

from tdal_torch.models.pointnet import (
    BOX_PRED_DIM,
    DenseBNStack,
    PointNetSeg,
    SharedMLP,
    gather_object_points,
    parse_box_pred,
)
from tdal_torch.models.static_labeler import _train_noise, frustum_loss_one_box

NUM_POINT = 1024  # points per frame (dynamic_model.py:15)
NUM_FRAME = 5  # +-2 frame window (dynamic_model.py:16)
NUM_OBJECT_POINT = 512  # gathered object points per frame (dynamic_model.py:14)
BOX_SEQ_LEN = 101  # +-50 frame box trajectory (dynamic_model.py:115-116)


class PointEmbedding(nn.Module):
    """Object-point window -> 256-d: shared MLP (64,128,256,512) -> max -> FC 512, 256."""

    def __init__(self, in_channels: int = 4):
        super().__init__()
        self.mlp = SharedMLP(in_channels, [64, 128, 256, 512])
        self.fc = DenseBNStack(512, [512, 256])

    def forward(self, pts):
        return self.fc(self.mlp(pts).amax(dim=1))


class BoxEmbedding(nn.Module):
    """Box trajectory (B, 101, 8) -> 128-d: shared MLP (64,64,128,512) -> max -> FC 128, 128."""

    def __init__(self, in_channels: int = 8):
        super().__init__()
        self.mlp = SharedMLP(in_channels, [64, 64, 128, 512])
        self.fc = DenseBNStack(512, [128, 128])

    def forward(self, boxes):
        return self.fc(self.mlp(boxes).amax(dim=1))


class EmbeddingBoxHead(nn.Module):
    """(B, 384) embedding -> FC 128, 128 -> 59-dim box prediction."""

    def __init__(self, in_features: int = 256 + 128):
        super().__init__()
        self.fc = DenseBNStack(in_features, [128, 128])
        self.out = nn.Linear(128, BOX_PRED_DIM)

    def forward(self, emb):
        return self.out(self.fc(emb))


class DynamicLabeler(nn.Module):
    """pts (B, 5*1024, 4), boxes (B, 101, 8) -> per-frame refined box prediction."""

    def __init__(self, n_object_points: int = NUM_FRAME * NUM_OBJECT_POINT):
        super().__init__()
        self.n_object_points = n_object_points
        self.seg = PointNetSeg(4)
        self.point_emb = PointEmbedding(4)
        self.box_emb = BoxEmbedding(8)
        self.head = EmbeddingBoxHead(256 + 128)

    def forward(self, pts, boxes, bbox_gt=None, noise=None, keep=None):
        logits = self.seg(pts, keep)
        # all 4 channels (xyz + time) are gathered (dynamic_model.py:52-63)
        object_pts, mask = gather_object_points(pts, logits, self.n_object_points,
                                                _train_noise(self, noise))
        emb = torch.cat([self.point_emb(object_pts), self.box_emb(boxes)], dim=1)
        out = parse_box_pred(self.head(emb))
        out["logits"] = logits
        out["mask"] = mask
        out["center"] = out["center_delta"]  # a delta; eval adds the init box back
        return out


dynamic_loss = frustum_loss_one_box
