"""Double-flip test-time augmentation.

Port of ``tdal/models/tta.py``: the four point-set variants of a frame, and the merge
of their prediction maps before decode (the reference's ``CenterHead.predict`` with
``double_flip``).
"""

from __future__ import annotations

import numpy as np
import torch


def double_flip_points(points: np.ndarray):
    """points (N, D) -> [orig, yflip (y = -y), xflip (x = -x), both]."""
    yflip = points.copy()
    yflip[:, 1] = -yflip[:, 1]
    xflip = points.copy()
    xflip[:, 0] = -xflip[:, 0]
    both = points.copy()
    both[:, :2] = -both[:, :2]
    return [points, yflip, xflip, both]


def average_double_flip_preds(preds: dict) -> dict:
    """One task's NHWC maps with leading batch B*4, ordered [orig, yflip, xflip, both]
    per frame -> maps with batch B.

    Each variant's maps are flipped back (H for the y flip, W for the x flip, both for
    the double flip), then averaged after activation: the mean of sigmoid(hm) and of
    exp(dim), not the activation of the mean. So the returned hm and dim are already
    activated: decode them with ``decode_preds(..., activated=True)``. The reg, rot
    and vel components flip sign or become 1 - x on the variants that mirror them."""
    shaped = {}
    for k, v in preds.items():
        b4, h, w, c = v.shape
        v = v.reshape(b4 // 4, 4, h, w, c).clone()
        v[:, 1] = v[:, 1].flip(1)
        v[:, 2] = v[:, 2].flip(2)
        v[:, 3] = v[:, 3].flip(1, 2)
        shaped[k] = v

    out = {"hm": torch.sigmoid(shaped["hm"]).mean(dim=1),
           "dim": torch.exp(shaped["dim"]).mean(dim=1)}
    if "height" in shaped:
        out["height"] = shaped["height"].mean(dim=1)

    reg = shaped["reg"]
    reg[:, 1, ..., 1] = 1 - reg[:, 1, ..., 1]
    reg[:, 2, ..., 0] = 1 - reg[:, 2, ..., 0]
    reg[:, 3, ..., 0] = 1 - reg[:, 3, ..., 0]
    reg[:, 3, ..., 1] = 1 - reg[:, 3, ..., 1]
    out["reg"] = reg.mean(dim=1)

    rot = shaped["rot"]  # (..., 2): the sine-like and the cosine-like component
    rots, rotc = rot[..., 0:1].clone(), rot[..., 1:2].clone()
    rotc[:, 1] *= -1  # y flip: the cosine flips
    rots[:, 2] *= -1  # x flip: the sine flips
    rots[:, 3] *= -1  # double flip: both
    rotc[:, 3] *= -1
    out["rot"] = torch.cat([rots.mean(dim=1), rotc.mean(dim=1)], dim=-1)

    if "vel" in shaped:
        vel = shaped["vel"]
        vel[:, 1, ..., 1] *= -1
        vel[:, 2, ..., 0] *= -1
        vel[:, 3] *= -1
        out["vel"] = vel.mean(dim=1)
    return out
