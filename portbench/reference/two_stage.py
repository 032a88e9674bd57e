"""The plain reference of the two-stage detector (CenterPoint's two-sweep VoxelNet with
velocity, frozen, and its BEV 5-point second stage), in eval, float32 torch.

Written from the published description (CenterPoint, Yin et al. 2021, and the det3d
code of its ``TwoStageDetector``, ``BEVFeatureExtractor`` and ``RoIHead``):

- ``merged_points``: a frame's points and its previous sweep's, moved into the
  current frame by the sweep's ``transform_matrix``, with a time-lag channel (0 for the
  current sweep), the current sweep first (det3d ``read_sweep`` / ``LoadPointCloudFromFile``);
- ``first_stage``: the VoxelNet eval forward of ``models.py`` and ``sparse.py`` with
  the CenterHead's ``vel`` branch added (the code is 10 wide), -> the maps and the BEV
  feature that the RPN hands the head (512 channels at stride 8);
- ``decode``: every BEV cell's box [x, y, z, l, w, h, vx, vy, heading] and class scores;
- ``box_points``: each box's centre and its four side midpoints;
- ``bev_sample``: the bilinear sample of the BEV map at those points, the five
  samples of a box concatenated point by point (5 x 512 = 2560 features);
- ``roi_head``: the shared FC stack (Linear without bias + BatchNorm with its running
  statistics + ReLU), then the IoU-score branch and the box-residual branch, each an FC
  stack and a final Linear with bias; no dropout in eval;
- ``refine``: the residuals back onto the RoI (heading at 6, velocity at 7:9): x, y
  rotated by the RoI's heading and added to its centre, the rest added to the RoI's
  columns; ``second_stage`` then rescores sqrt(sigmoid(IoU logit) x first-stage score)
  and gives the boxes in the answer's column order [x, y, z, l, w, h, vx, vy, heading].

Departures from the published code, each the measured program's too:

- the bilinear weights come from the unclamped corners (floor(x) and floor(x) + 1),
  where ``bilinear_interpolate_torch`` clamps the corners to the map first, which
  zeroes a sample on the far border; and the second corner is the first one, clamped,
  plus one (clamped), where the published code clamps floor(x) + 1: the two differ for
  a sample below the map's low edge (x or y under 0 cells), where this reads the next
  column or row; inside the map the two are the same arithmetic;
- the side midpoints turn the box's local (+-l/2, 0) and (0, +-w/2) counter-clockwise
  by its heading column, as the box IoU does; det3d's ``center_to_corner_box2d`` turns
  its corners with ``rotation_2d``, which its docstring calls clockwise for a positive
  angle, so its midpoints are these mirrored about the box's axes where the heading is
  not a multiple of pi/2;
- the BatchNorms of the first stage follow ``models.py`` (flax's conventions, eps 1e-3
  in the backbone and RPN, 1e-5 in the head); the RoI head's are eps 1e-5 as published;
- the head's fused branch weights are cut in the program's branch order (reg, height,
  dim, rot, vel, hm), where the published config lists vel before rot: the same
  branches, another layout of the one weight tensor.

Weights come in as one dict keyed by the program's parameter names (``first.`` and
``roi_head.``), made by the benchmark from the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import judge as ref_judge
from portbench.reference import models as ref_models
from portbench.reference import sparse
from portbench.reference.data import grid_size, voxelize

BRANCHES = ("reg", "height", "dim", "rot", "vel", "hm")
ROI_EPS = 1e-5
# a RoI's columns from a decoded box's [x, y, z, l, w, h, vx, vy, heading]
ROI = (0, 1, 2, 3, 4, 5, 8, 6, 7)  # x, y, z, l, w, h, heading, vx, vy


# ---------------------------------------------------------------------------
# Host data: the sweep merge
# ---------------------------------------------------------------------------


def loader_points(points: np.ndarray) -> np.ndarray:
    """A sweep's raw points (N, 5) as the loader hands them on: tanh of the intensity."""
    pts = points.astype(np.float32, copy=True)
    pts[:, 3] = np.tanh(pts[:, 3])
    return pts


def merged_points(frame: dict) -> np.ndarray:
    """(N + N', 6) float32: the current sweep with lag 0, then the previous sweep moved
    into the current frame by its 4 x 4 ``transform_matrix`` (float64 arithmetic) with
    its ``time_lag``."""
    cur = loader_points(frame["points"])
    prev = loader_points(frame["sweep_points"])
    tm = np.asarray(frame["transform_matrix"], np.float64)
    xyz = prev[:, :3].astype(np.float64) @ tm[:3, :3].T + tm[:3, 3]
    prev = np.concatenate([xyz, prev[:, 3:]], 1)
    lag = np.concatenate([np.zeros(len(cur)), np.full(len(prev), frame["time_lag"])])
    return np.concatenate([np.concatenate([cur, prev], 0), lag[:, None]], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# The first stage
# ---------------------------------------------------------------------------


def first_cfg(cfg: dict) -> dict:
    """The configuration seen as a one-stage VoxelNet's: its voxel generator and the
    first stage's model tree."""
    return {"voxel_generator": cfg["voxel_generator"], "model": cfg["model"]["first_stage_cfg"]}


def head_outs(task) -> dict:
    return {"reg": 2, "height": 1, "dim": 3, "rot": 2, "vel": 2, "hm": int(task["num_class"])}


def param_fan_in(name: str, shape, cfg) -> int:
    """The lecun fan-in of the program's parameter ``name`` (``first.`` or ``roi_head.``):
    ``models.param_fan_in``'s, with six branches in the head's block-diagonal final conv."""
    if name.startswith("first.") and name.endswith("final_conv_weight"):
        return int(shape[1] // len(BRANCHES) * shape[2] * shape[3])
    return ref_models.param_fan_in(name.split(".", 1)[1], shape, first_cfg(cfg))


def _first_weights(w: dict) -> dict:
    return {k[len("first."):]: v for k, v in w.items() if k.startswith("first.")}


def center_head(x, w, tasks):
    """``models.center_head`` with the ``vel`` branch: -> per task {name: (B, C, H, W)}."""
    p = "head.shared."
    x = F.conv2d(x, w[p + "weight"], w[p + "conv_bias"], padding=1)
    x = torch.relu(ref_models._bn(x, w, p, ref_models.HEAD_EPS, False, "scale"))
    out = []
    for t, task in enumerate(tasks):
        q = f"head.tasks.{t}."
        outs = head_outs(task)
        hc = w[q + "branch_convbn0.weight"].shape[0] // len(BRANCHES)
        preds, co = {}, 0
        for i, name in enumerate(BRANCHES):
            rows = slice(i * hc, (i + 1) * hc)
            h = F.conv2d(x, w[q + "branch_convbn0.weight"][rows],
                         w[q + "branch_convbn0.conv_bias"][rows], padding=1)
            bnw = {name + k: w[q + "branch_convbn0." + k][rows]
                   for k in ("scale", "bias", "running_mean", "running_var")}
            h = torch.relu(ref_models._bn(h, bnw, name, ref_models.HEAD_EPS, False, "scale"))
            c = outs[name]
            preds[name] = F.conv2d(h, w[q + "final_conv_weight"][co : co + c, rows],
                                   w[q + "final_conv_bias"][co : co + c], padding=1)
            co += c
        out.append(preds)
    return out


def first_stage(points, w, cfg):
    """The first stage's eval forward on padded merged points (B, N, 6) -> (per-task
    maps, the BEV feature (B, C, H, W) the head reads)."""
    vg, model = cfg["voxel_generator"], cfg["model"]["first_stage_cfg"]
    fw = _first_weights(w)
    vox, coords, num, n_vox = voxelize(points, vg, vg["max_voxel_num"][1])
    mask = (torch.arange(vox.shape[2], device=vox.device) < num[..., None]).float()
    feats = (vox * mask[..., None]).sum(-2) / num.clamp_min(1).float()[..., None]
    valid = torch.arange(feats.shape[1], device=feats.device)[None] < n_vox[:, None]
    nx, ny, nz = (int(g) for g in grid_size(vg))
    bev, _ = sparse.middle_backbone(feats * valid[..., None], coords, valid, (nz, ny, nx), fw)
    x = ref_models.rpn(bev.permute(0, 3, 1, 2), fw, model["neck"], False)
    return center_head(x, fw, model["bbox_head"]["tasks"]), x


def decode(preds, test_cfg):
    """Per-task maps -> (boxes (B, HW, 9) [x, y, z, l, w, h, vx, vy, heading], class
    scores (B, HW, C))."""
    boxes, scores = ref_models.decode(preds, test_cfg)
    b = boxes.shape[0]
    vel = preds["vel"].reshape(b, 2, -1).transpose(1, 2)
    return torch.cat([boxes[..., :6], vel, boxes[..., 6:]], -1), scores


# ---------------------------------------------------------------------------
# The second stage
# ---------------------------------------------------------------------------


def box_points(rois):
    """RoIs (..., 9) [x, y, z, l, w, h, heading, vx, vy] -> (..., 5, 3): the centre, then
    the midpoints of the sides at local (-l/2, 0), (l/2, 0), (0, -w/2), (0, w/2)."""
    c, s = torch.cos(rois[..., 6]), torch.sin(rois[..., 6])
    half_l, half_w = rois[..., 3] / 2, rois[..., 4] / 2
    zero = torch.zeros_like(half_l)
    pts = [rois[..., :3]]
    for lx, ly in ((-half_l, zero), (half_l, zero), (zero, -half_w), (zero, half_w)):
        pts.append(torch.stack([rois[..., 0] + (c * lx - s * ly),
                                rois[..., 1] + (s * lx + c * ly), rois[..., 2]], -1))
    return torch.stack(pts, -2)


def bilinear(im, x, y):
    """im (H, W, C); x, y (N,) in map cells -> (N, C): the four corners' features, the
    first corner clamped to the map and the second one past it (clamped), weighted by
    the unclamped corners."""
    h, w = im.shape[:2]
    x0f, y0f = torch.floor(x), torch.floor(y)
    x1f, y1f = x0f + 1, y0f + 1
    x0, y0 = x0f.long().clamp(0, w - 1), y0f.long().clamp(0, h - 1)
    x1, y1 = (x0 + 1).clamp(0, w - 1), (y0 + 1).clamp(0, h - 1)
    wa = (x1f - x) * (y1f - y)
    wb = (x1f - x) * (y - y0f)
    wc = (x - x0f) * (y1f - y)
    wd = (x - x0f) * (y - y0f)
    return (im[y0, x0] * wa[:, None] + im[y1, x0] * wb[:, None] + im[y0, x1] * wc[:, None]
            + im[y1, x1] * wd[:, None])


def bev_sample(bev, points, sec: dict):
    """bev (C, H, W) of one frame; points (K, P, 3) in metres -> (K, P * C), the P
    samples of a box one after the other."""
    k, p, _ = points.shape
    xs = (points[..., 0] - sec["pc_start"][0]) / sec["voxel_size"][0] / sec["out_stride"]
    ys = (points[..., 1] - sec["pc_start"][1]) / sec["voxel_size"][1] / sec["out_stride"]
    feats = bilinear(bev.permute(1, 2, 0), xs.reshape(-1), ys.reshape(-1))
    return feats.reshape(k, p * bev.shape[0])


def _fc_stack(x, w, prefix: str, n: int):
    for i in range(n):
        q = f"{prefix}.{i}."
        x = x @ w[q + "linear.weight"].t()
        inv = torch.rsqrt(w[q + "bn.running_var"] + ROI_EPS) * w[q + "bn.weight"]
        x = torch.relu((x - w[q + "bn.running_mean"]) * inv + w[q + "bn.bias"])
    return x


def roi_head(feats, w, mc: dict):
    """(K, 2560) RoI features -> (IoU logits (K,), residuals (K, code)), in eval."""
    x = _fc_stack(feats, w, "roi_head.shared", len(mc["SHARED_FC"]))
    hc = _fc_stack(x, w, "roi_head.cls_layers", len(mc["CLS_FC"]))
    hr = _fc_stack(x, w, "roi_head.reg_layers", len(mc["REG_FC"]))
    cls = hc @ w["roi_head.cls_out.weight"].t() + w["roi_head.cls_out.bias"]
    return cls[:, 0], hr @ w["roi_head.reg_out.weight"].t() + w["roi_head.reg_out.bias"]


def refine(rois, reg):
    """Residuals (K, 9) on RoIs (K, 9) -> refined boxes in the RoI's column order."""
    c, s = torch.cos(rois[:, 6]), torch.sin(rois[:, 6])
    x = c * reg[:, 0] - s * reg[:, 1] + rois[:, 0]
    y = s * reg[:, 0] + c * reg[:, 1] + rois[:, 1]
    return torch.cat([x[:, None], y[:, None], reg[:, 2:3] + rois[:, 2:3], reg[:, 3:] + rois[:, 3:]],
                     1)


def second_stage(bev, boxes, best, w, cfg, chunk: int = 8192):
    """One frame's candidates, boxes (K, 9) in the decoded order and their first-stage
    scores (K,), through the second stage -> (refined boxes (K, 9) in the answers' order,
    rescored scores (K,), IoU logits (K,))."""
    sec = cfg["model"]["second_stage_modules"][0]
    mc = cfg["model"]["roi_head"]["model_cfg"]
    out_b, out_s, out_l = [], [], []
    for i in range(0, len(boxes), chunk):
        rois = boxes[i : i + chunk][:, list(ROI)]
        logit, reg = roi_head(bev_sample(bev, box_points(rois), sec), w, mc)
        out_b.append(refine(rois, reg)[:, [0, 1, 2, 3, 4, 5, 7, 8, 6]])
        out_s.append(torch.sqrt(torch.sigmoid(logit) * best[i : i + chunk].clamp_min(0.0)))
        out_l.append(logit)
    return torch.cat(out_b), torch.cat(out_s), torch.cat(out_l)


# ---------------------------------------------------------------------------
# Judging the answers
# ---------------------------------------------------------------------------


def judge_frame(boxes, scores, refined, rescored, kept, test_cfg, score_eps, iou_eps,
                chunk=64):
    """One frame's answer against the reference's candidates: ``boxes`` (HW, 9) and
    ``scores`` (HW, C) from the first stage, ``refined`` (HW, 9) and ``rescored`` (HW,)
    from the second; ``kept``: the program's numpy ``box3d_lidar`` (K, 9), ``scores``
    (K,), ``label_preds`` (K,). Each answer is matched to the candidate of its label
    (the first stage's best class) whose refined box and rescored score are nearest,
    among those in range that pass the score threshold less a margin. Returns
    {refine_gap, rescore_gap, violations, kept, detail}: the largest relative gap of a
    refined box's columns (the heading's wrapped), the largest rescored score's gap, and
    the violations of greedy NMS's guarantees by the matched candidates on their
    first-stage boxes and scores (``judge.judge_frame``, margins ``score_eps`` and
    ``iou_eps``)."""
    dev = boxes.device
    best, label = scores.max(-1)
    lim = torch.tensor(test_cfg["post_center_limit_range"], dtype=boxes.dtype, device=dev)
    in_range = (boxes[:, :3] >= lim[:3]).all(-1) & (boxes[:, :3] <= lim[3:]).all(-1)
    cand = (in_range & (best > float(test_cfg["score_threshold"]) - 100 * score_eps)
            ).nonzero().flatten()
    kb = torch.as_tensor(kept["box3d_lidar"], dtype=boxes.dtype, device=dev).reshape(-1, 9)
    ks = torch.as_tensor(kept["scores"], dtype=boxes.dtype, device=dev).reshape(-1)
    kl = torch.as_tensor(kept["label_preds"], device=dev).reshape(-1).long()
    out = dict(refine_gap=0.0, rescore_gap=0.0, violations=0, kept=len(kb), detail=[],
               refine_at="")
    match = torch.zeros(0, dtype=torch.long, device=dev)
    if len(kb) and not len(cand):
        out["violations"] += len(kb)
        out["detail"].append(f"{len(kb)} answers, no candidate passes the threshold")
        return out
    if len(kb):
        key = torch.cat([refined[cand], rescored[cand, None]], 1)
        q = torch.cat([kb, ks[:, None]], 1)
        same = label[cand]
        dist = torch.cat([torch.where(kl[i : i + chunk, None] == same[None],
                                      ((q[i : i + chunk, None, :] - key[None]) ** 2).sum(-1),
                                      torch.full((1,), math.inf, device=dev))
                          for i in range(0, len(q), chunk)])
        d, j = dist.min(1)
        if not torch.isfinite(d).all():
            out["violations"] += int((~torch.isfinite(d)).sum())
            out["detail"].append("an answer's label has no candidate")
        match = cand[j]
        rb = refined[match]
        gap = (kb - rb).abs()
        gap[:, 8] = torch.remainder(kb[:, 8] - rb[:, 8] + math.pi, 2 * math.pi).sub(math.pi).abs()
        rel = gap / rb.abs().clamp_min(1.0)
        i, c = divmod(int(rel.argmax()), rel.shape[1])
        out["refine_gap"] = float(rel[i, c])
        out["refine_at"] = (f"column {c} of candidate {int(match[i])}: the answer's "
                            f"{float(kb[i, c])!r}, the reference's {float(rb[i, c])!r}, its "
                            f"first-stage box {[round(v, 5) for v in boxes[match[i]].tolist()]}")
        out["rescore_gap"] = float((ks - rescored[match]).abs().max())
    cols = [0, 1, 2, 3, 4, 5, 8]
    first = {"box3d_lidar": boxes[match][:, cols].cpu().numpy(),
             "scores": best[match].cpu().numpy(), "label_preds": kl.cpu().numpy()}
    r = ref_judge.judge_frame(boxes[:, cols], scores, first, test_cfg, score_eps, iou_eps)
    out["violations"] += r["violations"]
    out["detail"] += r["detail"]
    return out


# ---------------------------------------------------------------------------
# Calibrating fresh weights
# ---------------------------------------------------------------------------


def calibrate(w, batches, cfg, spread: dict, kept: float, iou_pass: float, reg_share: float):
    """Scale the last layers of fresh weights ``w`` on ``batches`` of padded points
    (B, N, 6), the first of them alone but for the heatmap's bias:

    - each first-stage head branch's block of the final conv so that its outputs
      spread about their bias by ``spread[name]`` (``models.calibrate_head``'s robust
      spread), and the heatmap's bias so that greedy NMS at the test settings keeps
      ``kept`` boxes a frame over all of ``batches`` (``kept_bias``);
    - then, on the candidates that pass the threshold, the RoI head's IoU output so
      that 99% of its scores lie in (1 - iou_pass, iou_pass), and its residual output
      so that each residual spreads by ``reg_share`` of the candidates' mean size.

    A final layer is linear in its weights: this sets the spread of the outputs of a
    network whose deeper layers keep their draws."""
    test_cfg = cfg["test_cfg"]
    thr = float(test_cfg["score_threshold"])
    points = batches[0]
    tasks = cfg["model"]["first_stage_cfg"]["bbox_head"]["tasks"]
    with torch.no_grad():
        maps, _ = first_stage(points, w, cfg)
    hm = []
    for t, (task, preds) in enumerate(zip(tasks, maps)):
        key = f"first.head.tasks.{t}.final_conv_weight"
        bkey = f"first.head.tasks.{t}.final_conv_bias"
        w[key], w[bkey] = w[key].clone(), w[bkey].clone()
        co = 0
        for name in BRANCHES:
            c = head_outs(task)[name]
            dev = preds[name] - w[bkey][co : co + c, None, None]
            w[key][co : co + c] *= float(spread[name]) * 2.576 / max(_q99(dev), 1e-30)
            if name == "hm":
                hm.append(slice(co, co + c))
            co += c
    with torch.no_grad():
        every = [first_stage(pts, w, cfg)[0] for pts in batches]
    for t in range(len(tasks)):
        preds = {name: torch.cat([m[t][name] for m in every]) for name in BRANCHES}
        w[f"first.head.tasks.{t}.final_conv_bias"][hm[t]] += kept_bias(preds, test_cfg, kept)
    del every
    with torch.no_grad():
        maps, bev = first_stage(points, w, cfg)
        boxes, scores = decode(maps[0], test_cfg)
        best = scores.max(-1).values
        sec = cfg["model"]["second_stage_modules"][0]
        mc = cfg["model"]["roi_head"]["model_cfg"]
        feats = []
        size = []
        for j in range(len(boxes)):
            keep = best[j] > thr
            rois = boxes[j][keep][:, list(ROI)]
            feats.append(bev_sample(bev[j], box_points(rois), sec))
            size.append(rois[:, 3:6])
        feats = torch.cat(feats)
        mean_size = float(torch.cat(size).mean())
        x = _fc_stack(feats, w, "roi_head.shared", len(mc["SHARED_FC"]))
        hc = _fc_stack(x, w, "roi_head.cls_layers", len(mc["CLS_FC"]))
        hr = _fc_stack(x, w, "roi_head.reg_layers", len(mc["REG_FC"]))
    lim = math.log(iou_pass / (1 - iou_pass))
    wc, wr = w["roi_head.cls_out.weight"].clone(), w["roi_head.reg_out.weight"].clone()
    wc *= lim / max(_q99(hc @ wc.t()), 1e-30)
    dev = hr @ wr.t()
    for col in range(wr.shape[0]):
        wr[col] *= reg_share * mean_size * 2.576 / max(_q99(dev[:, col]), 1e-30)
    w["roi_head.cls_out.weight"], w["roi_head.reg_out.weight"] = wc, wr
    return w


def kept_bias(preds, test_cfg, kept: float, steps: int = 16) -> float:
    """The shift of the heatmap's logits ``preds['hm']`` (B, C, H, W) at which greedy NMS
    at the test settings (``judge.greedy_nms``) keeps at least ``kept`` boxes a frame on
    average, found by bisection between the shifts that let ``kept`` and ``4 * kept``
    cells a frame pass the score threshold (more where that keeps too few). The boxes
    do not move with the heatmap's bias: the shift changes only which cells pass."""
    boxes, _ = decode(dict(preds, hm=torch.zeros_like(preds["hm"])), test_cfg)
    boxes = boxes[..., [0, 1, 2, 3, 4, 5, 8]]
    logits = preds["hm"].flatten(2).transpose(1, 2)  # (B, HW, C)
    b, cells = logits.shape[:2]
    thr = float(test_cfg["score_threshold"])
    target = math.log(thr / (1 - thr))
    top = torch.sort(logits.amax(-1).flatten(), descending=True).values

    def passing(n):  # the shift that lets n cells a frame pass
        return target - float(top[min(int(n * b), len(top)) - 1])

    def mean_kept(shift):
        return sum(len(ref_judge.greedy_nms(boxes[j], torch.sigmoid(logits[j] + shift),
                                            test_cfg)["scores"]) for j in range(b)) / b

    lo, n = passing(kept), 4 * kept
    hi = passing(n)
    while mean_kept(hi) < kept and n < cells:
        lo, n = hi, 2 * n
        hi = passing(n)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if mean_kept(mid) < kept else (lo, mid)
    return hi


def _q99(dev) -> float:
    """The 99th percentile of |dev| (2.576 standard deviations of a normal)."""
    flat = dev.abs().flatten()
    return float(torch.quantile(flat[:: max(1, flat.numel() // 2**24)], 0.99))
