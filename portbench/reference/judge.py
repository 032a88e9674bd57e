"""Judging a detector's answers against the reference's maps.

A frame's answer is the set of boxes the program kept after decode and greedy
rotated NMS (score threshold, the post-center range, the best ``nms_pre_max_size``
candidates, IoU threshold, at most ``nms_post_max_size`` kept). The reference decodes
every candidate of the frame from its own maps. Each kept box is matched to the
reference candidate whose center is nearest; the gaps of its score and box are
measured. Then the kept set is held to what greedy NMS guarantees, on the reference's
scores and boxes, with the margins ``score_eps`` and ``iou_eps`` (a decision that
the margins leave open is no violation):

- a kept candidate passes the threshold and its label is the reference's best class;
- no kept candidate overlaps a better kept one by more than the IoU threshold;
- every candidate left out that passes the threshold, ranks among the best
  ``nms_pre_max_size`` and beats the last kept score where the slots ran out is
  overlapped above the threshold by a kept candidate at least as good.

A greedy NMS keeps exactly the set that meets these three; a changed box, a lost or an
extra one breaks one of them. The rotated BEV IoU is the edge-integral clipping of two
convex quads (Green's theorem over each quad's edges clipped to the other), a frozen
copy of the arithmetic that det3d's ``boxes_iou_bev`` computes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_CORNERS = ((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5))


def corners(boxes):
    """[x, y, z, l, w, h, heading] (..., 7) -> BEV corners (..., 4, 2)."""
    unit = torch.tensor(_CORNERS, dtype=boxes.dtype, device=boxes.device)
    c = boxes[..., None, 3:5] * unit
    a = boxes[..., 6, None]
    cs, sn = torch.cos(a), torch.sin(a)
    rot = torch.stack([cs * c[..., 0] - sn * c[..., 1], sn * c[..., 0] + cs * c[..., 1]], -1)
    return rot + boxes[..., None, :2]


def _ccw(c):
    nxt = torch.roll(c, -1, dims=-2)
    signed = (c[..., 0] * nxt[..., 1] - c[..., 1] * nxt[..., 0]).sum(-1)
    return torch.where(signed[..., None, None] >= 0, c, c.flip(-2))


def _edge_integral(p, q, clip, eps):
    d = q - p
    c0, c1 = clip, torch.roll(clip, -1, dims=-2)
    n = torch.stack([-(c1[..., 1] - c0[..., 1]), c1[..., 0] - c0[..., 0]], -1)
    sp = (p[..., :, None, :] * n[..., None, :, :]).sum(-1) - (c0 * n).sum(-1)[..., None, :] + eps
    sv = (d[..., :, None, :] * n[..., None, :, :]).sum(-1)
    big, tiny = 1e9, 1e-8
    safe = torch.where(sv.abs() > tiny, sv, torch.ones_like(sv))
    inside = torch.where(sp >= 0, -big, big)
    t_in = torch.where(sv > tiny, -sp / safe, torch.where(sv < -tiny, torch.full_like(sv, -big),
                                                          torch.full_like(sv, 1.0) * inside))
    t_out = torch.where(sv < -tiny, -sp / safe, torch.where(sv > tiny, torch.full_like(sv, big),
                                                            -torch.full_like(sv, 1.0) * inside))
    t0, t1 = t_in.amax(-1).clamp(0.0, 1.0), t_out.amin(-1).clamp(0.0, 1.0)
    a, b = p + t0[..., None] * d, p + t1[..., None] * d
    contrib = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return 0.5 * torch.where(t1 > t0, contrib, torch.zeros_like(contrib)).sum(-1)


def iou_bev(a, b):
    """Pairwise rotated BEV IoU of boxes (N, 7) x (M, 7) -> (N, M)."""
    ca, cb = torch.broadcast_tensors(_ccw(corners(a))[:, None], _ccw(corners(b))[None])
    inter = (_edge_integral(ca, torch.roll(ca, -1, dims=-2), cb, 1e-5)
             + _edge_integral(cb, torch.roll(cb, -1, dims=-2), ca, -1e-5)).clamp_min(0.0)
    area_a = (a[:, 3] * a[:, 4])[:, None]
    area_b = (b[:, 3] * b[:, 4])[None]
    return inter / (area_a + area_b - inter).clamp_min(1e-8)


def _iou_rows(a, b, chunk=256):
    return torch.cat([iou_bev(a[i : i + chunk], b) for i in range(0, len(a), chunk)]) if len(
        a) else a.new_zeros(0, len(b))


def nearest(kb, ks, boxes, best, chunk=64):
    """For each kept box (K, 7) with its score, the candidate it is: the nearest in
    center, size, heading and score, distances taken elementwise (no cancellation)."""
    key = torch.cat([boxes, best[:, None]], 1)
    q = torch.cat([kb, ks[:, None]], 1)
    return torch.cat([((q[i : i + chunk, None, :] - key[None]) ** 2).sum(-1).argmin(1)
                      for i in range(0, len(q), chunk)])


def judge_frame(boxes, scores, kept, test_cfg, score_eps, iou_eps, label_offset=0):
    """One task of one frame. ``boxes`` (HW, 7) and ``scores`` (HW, C): the reference's
    decoded candidates; ``kept``: the program's answer for this task, a dict of numpy
    ``box3d_lidar`` (K, 7), ``scores`` (K,), ``label_preds`` (K,). Returns
    {score_gap, box_gap, violations, kept, detail}."""
    dev = boxes.device
    nms = test_cfg["nms"]
    thr, iou_thr = float(test_cfg["score_threshold"]), float(nms["nms_iou_threshold"])
    pre_max, post_max = int(nms["nms_pre_max_size"]), int(nms["nms_post_max_size"])
    best, label = scores.max(-1)
    lim = torch.tensor(test_cfg["post_center_limit_range"], dtype=boxes.dtype, device=dev)
    in_range = (boxes[:, :3] >= lim[:3]).all(-1) & (boxes[:, :3] <= lim[3:]).all(-1)
    kb = torch.as_tensor(kept["box3d_lidar"], dtype=boxes.dtype, device=dev).reshape(-1, 7)
    ks = torch.as_tensor(kept["scores"], dtype=boxes.dtype, device=dev).reshape(-1)
    kl = torch.as_tensor(kept["label_preds"], device=dev).reshape(-1).long() - label_offset
    out = dict(score_gap=0.0, box_gap=0.0, violations=0, kept=len(kb), detail=[])
    if len(kb):
        match = nearest(kb, ks, boxes, best)
        rb = boxes[match]
        gap = (kb - rb).abs()
        gap[:, 6] = torch.remainder(kb[:, 6] - rb[:, 6] + math.pi, 2 * math.pi).sub(math.pi).abs()
        out["box_gap"] = float((gap / rb.abs().clamp_min(1.0)).max())
        out["score_gap"] = float((ks - best[match]).abs().max())
    else:
        match = torch.zeros(0, dtype=torch.long, device=dev)

    def violate(what):
        out["violations"] += 1
        if len(out["detail"]) < 5:
            out["detail"].append(what)

    if len(match):
        fails = (best[match] <= thr - score_eps) | ~in_range[match]
        top2 = scores[match].topk(min(2, scores.shape[-1]), dim=-1).values
        margin = top2[:, 0] - top2[:, -1] if top2.shape[1] > 1 else torch.full_like(
            top2[:, 0], math.inf)
        relabel = (kl != label[match]) & (margin > score_eps)
        for i in (fails | relabel).nonzero().flatten().tolist():
            c = int(match[i])
            violate(f"kept candidate {c}: score {float(best[c]):.7f}, label {int(kl[i])} "
                    f"against the reference's {int(label[c])}")
    if len(match) > 1:
        iou = _iou_rows(boxes[match], boxes[match])
        better = best[match][:, None] > best[match][None] + score_eps  # row beats column
        bad = better & (iou > iou_thr + iou_eps)
        for a, b in bad.nonzero().tolist()[:5]:
            violate(f"kept {int(match[b])} overlaps better kept {int(match[a])}: "
                    f"IoU {float(iou[a, b]):.5f}")
        out["violations"] += max(0, int(bad.sum()) - 5)
    # the candidates left out that greedy NMS would have had to keep
    ok = in_range & (best > thr + score_eps)
    order = torch.sort(torch.where(in_range & (best > thr), best, -1.0), descending=True).values
    if int((in_range & (best > thr)).sum()) > pre_max:
        ok &= best > order[pre_max - 1] + score_eps
    if len(match) >= post_max:
        ok &= best > best[match].min() + score_eps
    ok[match] = False
    left = ok.nonzero().flatten()
    if len(left):
        if len(match) == 0:
            for c in left.tolist()[:5]:
                violate(f"candidate {c} (score {float(best[c]):.7f}) left out, nothing kept")
            out["violations"] += max(0, len(left) - 5)
        else:
            # each kept box as the suppressor, as greedy NMS computes it: the clipping
            # is not symmetric for boxes of centimetres
            iou = _iou_rows(boxes[match], boxes[left]).t()  # (left, kept)
            cover = (iou > iou_thr - iou_eps) & (best[match][None] >= best[left][:, None] - score_eps)
            lost = left[~cover.any(1)]
            lost_rows = (~cover.any(1)).nonzero().flatten()
            for r in lost_rows.tolist()[:5]:
                c, j = int(left[r]), int(iou[r].argmax())
                violate(f"candidate {c} (score {float(best[c]):.7f}, box "
                        f"{[round(v, 4) for v in boxes[c].tolist()]}) left out, no kept box "
                        f"covers it: the most overlapping kept one, {int(match[j])} (score "
                        f"{float(best[match[j]]):.7f}), by IoU {float(iou[r, j]):.6f}; "
                        f"{len(match)} kept")
            out["violations"] += max(0, len(lost) - 5)
    return out


def greedy_nms(boxes, scores, test_cfg) -> dict:
    """Plain greedy rotated NMS of one frame's candidates (the control's answers):
    threshold and range, the best ``nms_pre_max_size``, then each candidate in score
    order kept unless a kept one overlaps it above the IoU threshold, at most
    ``nms_post_max_size`` kept -> numpy ``box3d_lidar``, ``scores``, ``label_preds``."""
    nms = test_cfg["nms"]
    best, label = scores.max(-1)
    lim = torch.tensor(test_cfg["post_center_limit_range"], dtype=boxes.dtype,
                       device=boxes.device)
    ok = (boxes[:, :3] >= lim[:3]).all(-1) & (boxes[:, :3] <= lim[3:]).all(-1) & (
        best > float(test_cfg["score_threshold"]))
    masked = torch.where(ok, best, torch.full_like(best, -torch.inf))
    order = torch.sort(masked, descending=True, stable=True).indices
    order = order[: min(int(nms["nms_pre_max_size"]), int(ok.sum()))]
    over = (_iou_rows(boxes[order], boxes[order]) > float(nms["nms_iou_threshold"])).cpu().numpy()
    gone = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if gone[i]:
            continue
        keep.append(i)
        if len(keep) == int(nms["nms_post_max_size"]):
            break
        gone |= over[i]
    idx = order[keep]
    return {"box3d_lidar": boxes[idx].cpu().numpy(), "scores": best[idx].cpu().numpy(),
            "label_preds": label[idx].cpu().numpy()}
