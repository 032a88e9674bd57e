"""Greedy NMS in plain torch, with fixed-shape outputs.

Port of ``tdal/core/nms.py`` (``rotated_nms``, ``circle_nms``). Both sort by
descending score (stable, so ties keep their input order) and keep the set a plain
sequential greedy keeps: a candidate survives unless an earlier survivor overlaps it.
Scores of -inf (masked candidates) sort last and are never kept, so they suppress
nothing. The loop takes the first ``T`` live candidates at a time, resolves them among
themselves on the host (a ``T`` x ``T`` recurrence), and lets the survivors suppress
every candidate at once from one (``T``, m) block of overlaps: a round per ``T`` live
candidates, each of (T, m) polygon clippings, not a 4096^2 matrix. Each round waits
for the device (the greedy decision is sequential), as tdal's early-exit loop does.

Outputs are ``(idx (post_max,), valid (post_max,))``: indices into the original
arrays, in keep order, and which slots hold a kept candidate (the rest index 0).
"""

from __future__ import annotations

import numpy as np
import torch

from tdal_torch.core.geometry import center_to_corner_box2d
from tdal_torch.core.iou import quad_intersection_area

_TILE = 32
_EPS = 1e-8


def _tiled_greedy(alive, suppresses, post_max: int, tile: int):
    """Sequential greedy over candidates in sorted order. ``alive`` (m,) bool: live
    candidates; ``suppresses(pos)`` -> (len(pos), m) bool: whether candidate pos[i],
    if kept, suppresses each candidate. Returns the kept positions (at most
    ``post_max``), in order."""
    alive = alive.clone()
    kept: list = []
    while len(kept) < post_max:
        pos = torch.nonzero(alive).flatten()[:tile]
        if pos.numel() == 0:
            break
        over = suppresses(pos)
        within = over[:, pos].cpu().numpy()
        keep = np.ones(len(pos), bool)
        for i in range(len(pos)):
            if keep[i]:
                keep[i + 1 :] &= ~within[i, i + 1 :]
        keep_t = torch.from_numpy(keep).to(alive.device)
        alive &= ~(over & keep_t[:, None]).any(dim=0)
        alive[pos] = False
        kept.extend(pos.cpu().numpy()[keep].tolist())
    return kept[:post_max]


def _fixed(order, kept, post_max: int):
    idx = torch.zeros(post_max, dtype=order.dtype, device=order.device)
    valid = torch.zeros(post_max, dtype=torch.bool, device=order.device)
    if kept:
        k = torch.as_tensor(kept, device=order.device)
        idx[: len(kept)] = order[k]
        valid[: len(kept)] = True
    return idx, valid


def rotated_nms(boxes, scores, iou_threshold: float, pre_max_size: int,
                post_max_size: int):
    """Rotated BEV NMS of [x, y, z, l, w, h, heading] boxes (N, 7): of the
    ``pre_max_size`` best candidates, keep greedily those whose BEV IoU with every
    earlier kept box is at most ``iou_threshold``."""
    order = torch.sort(scores, descending=True, stable=True).indices[:pre_max_size]
    b, s = boxes[order], scores[order]
    corners = center_to_corner_box2d(b[:, :2], b[:, 3:5], b[:, 6])  # (m, 4, 2)
    areas = b[:, 3] * b[:, 4]

    def suppresses(pos):
        ca, cb = torch.broadcast_tensors(corners[pos][:, None], corners[None])
        inter = quad_intersection_area(ca, cb)
        iou = inter / (areas[pos][:, None] + areas[None] - inter).clamp_min(_EPS)
        return iou > iou_threshold

    tile = min(_TILE, post_max_size, int(b.shape[0]))
    kept = _tiled_greedy(torch.isfinite(s), suppresses, post_max_size, tile)
    return _fixed(order, kept, post_max_size)


def circle_nms(centers, scores, dist_threshold: float, post_max_size: int):
    """Center-distance greedy NMS of centers (N, 2): a kept candidate suppresses those
    within squared distance ``dist_threshold``."""
    order = torch.sort(scores, descending=True, stable=True).indices
    c, s = centers[order], scores[order]

    def suppresses(pos):
        return ((c[pos][:, None, :] - c[None, :, :]) ** 2).sum(-1) <= dist_threshold

    tile = min(_TILE, post_max_size, int(c.shape[0]))
    kept = _tiled_greedy(torch.isfinite(s), suppresses, post_max_size, tile)
    return _fixed(order, kept, post_max_size)
