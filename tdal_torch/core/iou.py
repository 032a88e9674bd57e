"""Rotated-box IoU in plain torch: the edge-integral polygon clipping of
``tdal/core/iou.py:84-140``, batched over any leading dims.

The intersection area of two convex quads is the Green's-theorem line integral over
the parts of each quad's edges that lie inside the other; each edge is clipped
against the other quad's four half-planes (Liang-Barsky). No polygon is built and
nothing is sorted, so every pair is the same fixed elementwise program.
"""

from __future__ import annotations

import torch

from tdal_torch.core.geometry import center_to_corner_box2d

_EPS = 1e-8


def _ccw(corners: torch.Tensor) -> torch.Tensor:
    """Orient convex quads (..., 4, 2) counter-clockwise."""
    nxt = torch.roll(corners, -1, dims=-2)
    signed = (corners[..., 0] * nxt[..., 1] - corners[..., 1] * nxt[..., 0]).sum(-1)
    return torch.where(signed[..., None, None] >= 0, corners, corners.flip(-2))


def _edge_integral(edges_p, edges_q, clip_corners, boundary_eps: float):
    """Signed-area contribution of directed segments (..., E, 2) clipped to CCW quads
    (..., 4, 2). Parity: tdal.core.iou._edge_integral."""
    d = edges_q - edges_p
    c0 = clip_corners
    c1 = torch.roll(clip_corners, -1, dims=-2)
    n_in = torch.stack([-(c1[..., 1] - c0[..., 1]), c1[..., 0] - c0[..., 0]], dim=-1)
    # signed distance of p to each half-plane (>0 inside), and velocity along d
    sp = (edges_p[..., :, None, :] * n_in[..., None, :, :]).sum(-1) - (
        (c0 * n_in).sum(-1)[..., None, :]
    )  # (..., E, 4)
    sv = (d[..., :, None, :] * n_in[..., None, :, :]).sum(-1)
    sp = sp + boundary_eps

    big = 1e9
    safe_sv = torch.where(sv.abs() > _EPS, sv, torch.ones_like(sv))
    t_enter = torch.where(
        sv > _EPS,
        -sp / safe_sv,
        torch.where(
            sv < -_EPS,
            torch.full_like(sv, -big),
            torch.where(sp >= 0, torch.full_like(sv, -big), torch.full_like(sv, big)),
        ),
    )
    t_exit = torch.where(
        sv < -_EPS,
        -sp / safe_sv,
        torch.where(
            sv > _EPS,
            torch.full_like(sv, big),
            torch.where(sp >= 0, torch.full_like(sv, big), torch.full_like(sv, -big)),
        ),
    )
    t0 = t_enter.amax(-1).clamp(0.0, 1.0)
    t1 = t_exit.amin(-1).clamp(0.0, 1.0)
    p0 = edges_p + t0[..., None] * d
    p1 = edges_p + t1[..., None] * d
    contrib = p0[..., 0] * p1[..., 1] - p0[..., 1] * p1[..., 0]
    return 0.5 * torch.where(t1 > t0, contrib, torch.zeros_like(contrib)).sum(-1)


def quad_intersection_area(corners_a, corners_b) -> torch.Tensor:
    """Intersection area of convex quads (..., 4, 2) x (..., 4, 2) -> (...).

    B's edges are clipped with a slightly shrunk A so a shared boundary is counted
    once (tdal.core.iou.quad_intersection_area)."""
    a = _ccw(corners_a)
    b = _ccw(corners_b)
    area = _edge_integral(a, torch.roll(a, -1, dims=-2), b, 1e-5) + _edge_integral(
        b, torch.roll(b, -1, dims=-2), a, -1e-5
    )
    return area.clamp_min(0.0)


def _overlap_bev(bev_a, bev_b) -> torch.Tensor:
    """BEV intersection of broadcastable [x, y, l, w, heading] boxes (..., 5)."""
    ca = center_to_corner_box2d(bev_a[..., :2], bev_a[..., 2:4], bev_a[..., 4])
    cb = center_to_corner_box2d(bev_b[..., :2], bev_b[..., 2:4], bev_b[..., 4])
    ca, cb = torch.broadcast_tensors(ca, cb)
    return quad_intersection_area(ca, cb)


def boxes_overlap_bev(boxes_a, boxes_b) -> torch.Tensor:
    """Pairwise BEV intersection areas: (..., N, 7) x (..., M, 7) -> (..., N, M)."""
    sel = [0, 1, 3, 4, 6]
    return _overlap_bev(boxes_a[..., :, None, sel], boxes_b[..., None, :, sel])


def boxes_iou_bev(boxes_a, boxes_b) -> torch.Tensor:
    """Pairwise rotated BEV IoU: (..., N, 7) x (..., M, 7) -> (..., N, M).

    Parity: tdal.core.iou.boxes_iou_bev."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / (area_a + area_b - overlap).clamp_min(_EPS)


def boxes_iou_3d(boxes_a, boxes_b) -> torch.Tensor:
    """Pairwise 3D IoU, batched: (..., N, 7) x (..., M, 7) -> (..., N, M).

    Parity: tdal.core.iou.boxes_iou_3d (pcdet boxes_iou3d_gpu semantics)."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    za_max = (boxes_a[..., 2] + boxes_a[..., 5] / 2.0)[..., :, None]
    za_min = (boxes_a[..., 2] - boxes_a[..., 5] / 2.0)[..., :, None]
    zb_max = (boxes_b[..., 2] + boxes_b[..., 5] / 2.0)[..., None, :]
    zb_min = (boxes_b[..., 2] - boxes_b[..., 5] / 2.0)[..., None, :]
    overlap_h = (torch.minimum(za_max, zb_max) - torch.maximum(za_min, zb_min)).clamp_min(0.0)
    inter = overlap_bev * overlap_h
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return inter / (vol_a + vol_b - inter).clamp_min(_EPS)


def labeler_box3d_iou(boxes_a, boxes_b):
    """Elementwise (iou3d, iou2d) of (..., 7) boxes with frustum-pointnet
    ``box3d_iou`` semantics: the footprint lives in the (x, z) plane, rotated
    clockwise by heading, and the vertical extent is y +- h/2.

    Parity: tdal.core.iou.labeler_box3d_iou (reference tools/utils.py:81-103)."""
    a, b = boxes_a, boxes_b
    fa = torch.stack([a[..., 0], a[..., 2], a[..., 3], a[..., 4], -a[..., 6]], dim=-1)
    fb = torch.stack([b[..., 0], b[..., 2], b[..., 3], b[..., 4], -b[..., 6]], dim=-1)
    inter_area = _overlap_bev(fa, fb)
    area_a = a[..., 3] * a[..., 4]
    area_b = b[..., 3] * b[..., 4]
    iou2d = inter_area / (area_a + area_b - inter_area).clamp_min(_EPS)
    ymax = torch.minimum(a[..., 1] + a[..., 5] / 2.0, b[..., 1] + b[..., 5] / 2.0)
    ymin = torch.maximum(a[..., 1] - a[..., 5] / 2.0, b[..., 1] - b[..., 5] / 2.0)
    inter_vol = inter_area * (ymax - ymin).clamp_min(0.0)
    vol_a = area_a * a[..., 5]
    vol_b = area_b * b[..., 5]
    iou3d = inter_vol / (vol_a + vol_b - inter_vol).clamp_min(_EPS)
    return iou3d, iou2d


def compute_box3d_iou(center_pred, heading_logits, heading_residuals, size_logits,
                      size_residuals, center_label, heading_class_label,
                      heading_residual_label, size_class_label, size_residual_label):
    """Argmax-decode labeler outputs and their labels to boxes and measure their corner
    IoU: (iou2d (B,), iou3d (B,)).

    Parity: tdal.core.iou.compute_box3d_iou (reference tools/utils.py:81-103), the
    fpointnet corner IoU of ``labeler_box3d_iou`` included."""
    from tdal_torch.core.codecs import class2angle, class2size

    b = torch.arange(center_pred.shape[0], device=center_pred.device)
    heading_class = heading_logits.argmax(dim=1)
    size_class = size_logits.argmax(dim=1)
    heading = class2angle(heading_class, heading_residuals[b, heading_class])
    size = class2size(size_class, size_residuals[b, size_class])
    box_pred = torch.cat([center_pred, size, heading[:, None]], dim=1)
    heading_l = class2angle(heading_class_label, heading_residual_label)
    size_l = class2size(size_class_label, size_residual_label)
    box_label = torch.cat([center_label, size_l, heading_l[:, None]], dim=1)
    iou3d, iou2d = labeler_box3d_iou(box_pred, box_label)
    return iou2d, iou3d
