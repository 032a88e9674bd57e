"""The plain reference of the two detectors: CenterPoint-PointPillars (train forward and
loss) and CenterPoint-VoxelNet (eval forward), in float32 torch, NCHW.

Written from the published architecture (det3d: PillarFeatureNet, PointPillarsScatter,
SpMiddleResNetFHD, RPN, CenterHead with SepHead branches, FastFocalLoss and RegLoss)
with flax's BatchNorm conventions, which the measured program keeps: batch statistics
over every axis but the channel one with the biased variance, eps 1e-3 in the
readers, sparse backbone and RPN, 1e-5 in the head. Every conv is a plain
``F.conv2d``; each head branch is its own pair of convs. Weights come in as one dict
keyed by the program's parameter names, made by the benchmark from the seed; the
block-diagonal layout of the head's fused branch weights is taken apart here.

Departures from the published code, each the measured program's too: the VoxelNet
grid has 40 z cells (6 m / 0.15 m), so the z-compressed BEV has 3 x 128 channels;
every sparse level keeps at most the buffer's share of voxels (V, V/2, V/4, V/8,
lowest keys first), which these frames never reach.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import sparse
from portbench.reference.data import grid_size, voxelize

COMMON = ("reg", "height", "dim", "rot")
BN_EPS, HEAD_EPS = 1e-3, 1e-5


def _bn_train(x, weight, bias, eps):
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight[:, None, None] + bias[:, None, None]


def _bn_eval(x, w, prefix, eps, scale_key="weight"):
    rm, rv = w[prefix + "running_mean"], w[prefix + "running_var"]
    inv = torch.rsqrt(rv + eps) * w[prefix + scale_key]
    return (x - rm[:, None, None]) * inv[:, None, None] + w[prefix + "bias"][:, None, None]


def _bn(x, w, prefix, eps, train, scale_key="weight"):
    """BatchNorm of (B, C, H, W): batch statistics where ``train``, else the running
    ones."""
    if train:
        return _bn_train(x, w[prefix + scale_key], w[prefix + "bias"], eps)
    return _bn_eval(x, w, prefix, eps, scale_key)


def conv_block(x, w, prefix, train, stride=1):
    """The RPN's conv + BN + ReLU blocks: a 3x3 stride-1 one keeps its conv under
    ``fused.`` (weight, scale, bias), a strided one under ``conv.`` / ``bn.``."""
    if prefix + "fused.weight" in w:
        y = F.conv2d(x, w[prefix + "fused.weight"], padding=1)
        return torch.relu(_bn(y, w, prefix + "fused.", BN_EPS, train, "scale"))
    y = F.conv2d(x, w[prefix + "conv.weight"], stride=stride, padding=1)
    return torch.relu(_bn(y, w, prefix + "bn.", BN_EPS, train))


def rpn(x, w, neck, train):
    ups = []
    layer_nums, strides = neck["layer_nums"], neck["ds_layer_strides"]
    us = neck["us_layer_strides"]
    up_start = len(layer_nums) - len(neck["us_num_filters"])
    for i, n in enumerate(layer_nums):
        x = conv_block(x, w, f"rpn.blocks.{i}.0.", train, strides[i])
        for j in range(1, n + 1):
            x = conv_block(x, w, f"rpn.blocks.{i}.{j}.", train)
        j = i - up_start
        if j >= 0:
            p = f"rpn.deblocks.{j}."
            wt = w[p + "conv.weight"]
            s = us[j]
            if s > 1:
                y = F.conv_transpose2d(x, wt, stride=int(s))
            elif s == 1:
                y = F.conv2d(x, wt)
            else:
                y = F.conv2d(x, wt, stride=int(round(1 / s)))
            ups.append(torch.relu(_bn(y, w, p + "bn.", BN_EPS, train)))
    return torch.cat(ups, 1) if ups else x


def head_names(task):
    return list(COMMON) + ["hm"]


def head_outs(task):
    return {"reg": 2, "height": 1, "dim": 3, "rot": 2, "hm": int(task["num_class"])}


def center_head(x, w, tasks, train):
    """-> per task {name: (B, C, H, W)}: the shared conv, then per branch a conv + BN +
    ReLU and a final conv, each branch cut out of the fused weights."""
    p = "head.shared."
    x = F.conv2d(x, w[p + "weight"], w[p + "conv_bias"], padding=1)
    x = torch.relu(_bn(x, w, p, HEAD_EPS, train, "scale"))
    out = []
    for t, task in enumerate(tasks):
        q = f"head.tasks.{t}."
        outs = head_outs(task)
        hc = w[q + "branch_convbn0.weight"].shape[0] // len(outs)
        preds, co = {}, 0
        for i, name in enumerate(head_names(task)):
            rows = slice(i * hc, (i + 1) * hc)
            h = F.conv2d(x, w[q + "branch_convbn0.weight"][rows],
                         w[q + "branch_convbn0.conv_bias"][rows], padding=1)
            bnw = {name + k: w[q + "branch_convbn0." + k][rows]
                   for k in ("scale", "bias", "running_mean", "running_var")}
            h = torch.relu(_bn(h, bnw, name, HEAD_EPS, train, "scale"))
            c = outs[name]
            preds[name] = F.conv2d(h, w[q + "final_conv_weight"][co : co + c, rows],
                                   w[q + "final_conv_bias"][co : co + c], padding=1)
            co += c
        out.append(preds)
    return out


# ---------------------------------------------------------------------------
# PointPillars
# ---------------------------------------------------------------------------


def _masked_bn_train(x, mask, weight, bias, eps):
    m = mask[..., None]
    axes = tuple(range(x.dim() - 1))
    denom = m.expand_as(x).sum(axes).clamp_min(1.0)
    mean = (x * m).sum(axes) / denom
    var = (((x - mean) ** 2) * m).sum(axes) / denom
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def pillar_features(voxels, num_points, coords, w, reader):
    """The PFN layers on (B, V, P, D) pillars (train mode) -> (B, V, C)."""
    p = voxels.shape[2]
    mask = (torch.arange(p, device=voxels.device) < num_points[..., None]).float()
    voxels = voxels * mask[..., None]
    mean = voxels[..., :3].sum(-2, keepdim=True) / num_points.clamp_min(1).float()[..., None, None]
    vx, vy = reader["voxel_size"][0], reader["voxel_size"][1]
    cx = coords[..., 2].float() * vx + (vx / 2.0 + reader["pc_range"][0])
    cy = coords[..., 1].float() * vy + (vy / 2.0 + reader["pc_range"][1])
    x = torch.cat([voxels, voxels[..., :3] - mean, voxels[..., 0:1] - cx[..., None, None],
                   voxels[..., 1:2] - cy[..., None, None]], -1) * mask[..., None]
    n = len(reader["num_filters"])
    for i in range(n):
        q = f"reader.pfn_layers.{i}."
        x = x @ w[q + "linear.weight"].t()
        x = torch.relu(_masked_bn_train(x, mask, w[q + "norm.weight"], w[q + "norm.bias"],
                                        BN_EPS)) * mask[..., None]
        xmax = x.amax(-2, keepdim=True)
        x = xmax[..., 0, :] if i == n - 1 else torch.cat([x, xmax.expand_as(x)], -1)
    return x


def pointpillars_train(points, w, cfg):
    """The train-mode forward of CenterPoint-PointPillars on padded points (B, N, D)."""
    vg, model = cfg["voxel_generator"], cfg["model"]
    vox, coords, num, n_vox = voxelize(points, vg, vg["max_voxel_num"][0])
    feats = pillar_features(vox, num, coords, w, model["reader"])
    b, v, c = feats.shape
    nx, ny, _ = (int(g) for g in grid_size(vg))
    valid = torch.arange(v, device=feats.device)[None] < n_vox[:, None]
    lin = torch.where(valid, coords[..., 1] * nx + coords[..., 2], ny * nx)
    canvas = feats.new_zeros(b, ny * nx + 1, c).scatter(
        1, lin[..., None].expand(-1, -1, c), feats * valid[..., None])
    canvas = canvas[:, : ny * nx].reshape(b, ny, nx, c).permute(0, 3, 1, 2)
    return center_head(rpn(canvas, w, model["neck"], True), w, model["bbox_head"]["tasks"],
                       True)


def center_loss(preds, targets, code_weights, weight):
    """CenterPoint's loss: per task the penalty-reduced focal loss of the heatmap and
    the masked L1 of [reg, height, dim, rot] against [dx, dy, z, log dims, sin, cos]."""
    total = 0.0
    for p, (hm_t, anno, ind, mask, cat) in zip(preds, targets):
        out = torch.clamp(torch.sigmoid(p["hm"]), 1e-4, 1 - 1e-4)
        b, c = out.shape[:2]
        neg = (torch.log(1 - out) * out**2 * (1 - hm_t) ** 4).sum()
        flat = out.reshape(b, c, -1)
        pos_all = torch.gather(flat, 2, ind[:, None, :].expand(-1, c, -1))  # (B, C, M)
        pos = torch.gather(pos_all, 1, cat[:, None, :])[:, 0]
        num_pos = mask.sum()
        pos_loss = (torch.log(pos) * (1 - pos) ** 2 * mask).sum()
        hm_loss = -neg if num_pos == 0 else -(pos_loss + neg) / num_pos
        reg = torch.cat([p[k] for k in COMMON], 1).reshape(b, 8, -1)
        pred = torch.gather(reg, 2, ind[:, None, :].expand(-1, 8, -1)).transpose(1, 2)
        target = torch.cat([anno[..., :6], anno[..., 8:10]], -1)
        m = mask[..., None]
        l1 = (torch.abs(pred * m - target * m) / (m.sum() + 1e-4)).sum((0, 1))
        loc = (l1 * torch.as_tensor(code_weights, dtype=l1.dtype, device=l1.device)).sum()
        total = total + hm_loss + weight * loc
    return total


# ---------------------------------------------------------------------------
# VoxelNet
# ---------------------------------------------------------------------------


def voxelnet_eval(points, w, cfg):
    """The eval forward of CenterPoint-VoxelNet on padded points (B, N, D) -> per-task
    maps, and the occupied voxels of each sparse level (B,) per level."""
    vg, model = cfg["voxel_generator"], cfg["model"]
    vox, coords, num, n_vox = voxelize(points, vg, vg["max_voxel_num"][1])
    mask = (torch.arange(vox.shape[2], device=vox.device) < num[..., None]).float()
    feats = (vox * mask[..., None]).sum(-2) / num.clamp_min(1).float()[..., None]
    v = feats.shape[1]
    valid = torch.arange(v, device=feats.device)[None] < n_vox[:, None]
    nx, ny, nz = (int(g) for g in grid_size(vg))
    bev, occupancy = sparse.middle_backbone(feats * valid[..., None], coords, valid,
                                            (nz, ny, nx), w)
    x = rpn(bev.permute(0, 3, 1, 2), w, model["neck"], False)
    return center_head(x, w, model["bbox_head"]["tasks"], False), occupancy


def calibrate_head(w, points, cfg, spread: dict, pass_share: float, threshold: float):
    """Scale each head branch's block of the final conv weights of ``w`` so that, on
    the batch ``points``, the branch's outputs spread about their bias by
    ``spread[name]`` (as a normal's standard deviation, read from the 99th percentile
    of the deviations), then shift the heatmap's bias so that
    ``pass_share`` of the batch's BEV cells score above ``threshold``. The final conv is
    linear in its weights: this sets the spread of the outputs of a detector whose
    deeper layers keep their draws."""
    with torch.no_grad():
        maps, _ = voxelnet_eval(points, w, cfg)
    logit = math.log(threshold / (1 - threshold))
    for t, (task, preds) in enumerate(zip(cfg["model"]["bbox_head"]["tasks"], maps)):
        key, bkey = f"head.tasks.{t}.final_conv_weight", f"head.tasks.{t}.final_conv_bias"
        w[key], w[bkey] = w[key].clone(), w[bkey].clone()
        co = 0
        for name in head_names(task):
            c = head_outs(task)[name]
            bias = w[bkey][co : co + c]
            dev = preds[name] - bias[:, None, None]
            # a robust spread: the 99th percentile of |dev| is 2.576 standard deviations
            # of a normal; the std itself is ruled by the few cells of the largest features
            q = float(torch.quantile(dev.abs().flatten()[:: max(1, dev.numel() // 2**24)], 0.99))
            gain = float(spread[name]) * 2.576 / max(q, 1e-30)
            w[key][co : co + c] *= gain
            if name == "hm":
                best = (bias[:, None, None] + gain * dev).amax(1).flatten()
                top = torch.sort(best, descending=True).values
                k = max(1, int(round(pass_share * len(top))))
                w[bkey][co : co + c] += logit - float(top[k - 1])
            co += c
    return w


def decode(preds, test_cfg):
    """Per-task maps (B, C, H, W) -> (boxes (B, HW, 7) [x, y, z, l, w, h, heading],
    class scores (B, HW, C))."""
    hm = torch.sigmoid(preds["hm"])
    b, c, h, wd = hm.shape
    dim = torch.exp(preds["dim"].clamp(-10.0, 10.0))
    rot = torch.atan2(preds["rot"][:, 0:1], preds["rot"][:, 1:2])
    ys, xs = torch.meshgrid(torch.arange(h, device=hm.device, dtype=hm.dtype),
                            torch.arange(wd, device=hm.device, dtype=hm.dtype), indexing="ij")
    f, vs, pc = test_cfg["out_size_factor"], test_cfg["voxel_size"], test_cfg["pc_range"]
    x = (xs + preds["reg"][:, 0]) * f * vs[0] + pc[0]
    y = (ys + preds["reg"][:, 1]) * f * vs[1] + pc[1]
    boxes = torch.cat([x[:, None], y[:, None], preds["height"], dim, rot], 1)
    return boxes.reshape(b, 7, -1).transpose(1, 2), hm.reshape(b, c, -1).transpose(1, 2)


def param_fan_in(name: str, shape, cfg) -> int:
    """The fan-in of a weight of the program's parameter ``name``: lecun-normal draws
    scale by it, as det3d's flax port initialises the detector."""
    if len(shape) == 1:
        return 0
    if len(shape) == 2:  # a dense (out, in)
        return int(shape[1])
    if len(shape) == 3:  # a sparse (taps, Cin, Cout)
        return int(shape[0] * shape[1])
    if name.endswith("final_conv_weight"):  # block-diagonal: one branch's block
        n_branch = len(COMMON) + 1
        return int(shape[1] // n_branch * shape[2] * shape[3])
    if ".deblocks." in name:
        j = int(name.split(".deblocks.")[1].split(".")[0])
        if cfg["model"]["neck"]["us_layer_strides"][j] > 1:  # transposed: (in, out, s, s)
            return int(shape[0] * shape[2] * shape[3])
    return int(np.prod(shape[1:]))
