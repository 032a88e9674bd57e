"""CenterPoint detection head and its CenterNet losses, NHWC.

Port of ``tdal/models/center_head.py`` (``SepHead`` :28-223, ``CenterHead`` :226-282,
``_gather_feat``, ``fast_focal_loss``, ``reg_loss``, ``center_head_loss`` :290-370,
``decode_preds``, ``post_process_task``, ``predict`` :378-473).

``SepHead`` fuses its branches as tdal does: at the configs' depth of two, the first
conv is one dense ``FusedConvBN`` over every branch (``branch_convbn0``; in training
its input side applies the shared conv's normalise + ReLU inside the K3 kernel) and
the final conv is block-diagonal (``final_conv_weight`` OIHW, ``final_conv_bias``),
run by cuDNN as tdal leaves it to XLA; other depths as ``SepHead`` says. With
``dcn_head`` the tasks are ``tdal_torch.models.dcn.DCNSepHead``. Head BatchNorms are
the reference's default ``BatchNorm2d``: eps 1e-5, momentum 0.1.

Under an active data-parallel mesh the losses' normalizers (the focal loss's positive
count, the reg loss's mask sum) are global sums over the data axis, taken with no
gradient, so each rank's loss is its share of the loss of the global batch (the ranks
of a spatial group hold the same gathered maps, so their counts are not summed again).

BEV spatial partitioning: ``CenterHead.forward(x, slab)`` runs the shared conv and
every branch conv on the slab's rows with one-row halos (``FusedConvBN``'s kernel halo
form, ``rows_conv`` for the cuDNN convs at every depth) and returns each map gathered
to the whole height (``RowSlab.gather``), so the losses, decode and NMS see the whole
map.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tdal_torch.core.nms import circle_nms, rotated_nms
from tdal_torch.models.layers import BatchNorm, FusedConvBN, conv_nhwc, rows_conv
from tdal_torch.parallel.mesh import all_reduce_sum
from tdal_torch.runtime.tracing import span

_HEAD_BN = dict(momentum=0.1, eps=1e-5)
COMMON_HEADS = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2)}


class SepHead(nn.Module):
    """Separate conv branches per output name. heads: {name: (out_ch, num_conv)}.

    Where there are several branches of one depth D they are fused as tdal fuses them
    (center_head.py:142-192): every branch reads the same input, so the first conv is
    one dense ``FusedConvBN`` over all of them (``branch_convbn0``); each deeper conv
    is block-diagonal (``branch_conv{d}_weight`` / ``_bias``, a masked cuDNN conv, then
    ``branch_bn{d}`` and ReLU); the final conv is block-diagonal too
    (``final_conv_weight`` / ``_bias``), or at D = 1 one dense conv (``final_conv``).
    Branches of unequal depths, or a single branch, are independent
    (``branches[i].convs`` / ``.bns``). A masked weight is multiplied by its mask, so
    its gradient outside the blocks is zero. ``pre`` (the shared conv's normalise +
    ReLU) goes into ``branch_convbn0``'s kernel where there is one, and is applied to
    the input otherwise. Every conv is 3x3 (tdal's ``final_kernel``, which no caller
    sets otherwise)."""

    def __init__(self, in_channels: int, heads: dict, head_conv: int = 64,
                 final_kernel: int = 3, init_bias: float = -2.19, dtype=torch.float32):
        super().__init__()
        self.names = list(heads)
        self.outs = [heads[n][0] for n in self.names]
        depths = [heads[n][1] for n in self.names]
        bias_vals = [init_bias if n == "hm" else 0.0 for n in self.names]
        if final_kernel != 3:
            raise ValueError("tdal_torch SepHead takes a 3x3 final kernel (every config's)")
        self.dtype = dtype
        g = len(self.names)
        self.fused = g > 1 and len(set(depths)) == 1
        if not self.fused:
            self.branches = nn.ModuleList()
            for (c, depth), bias in zip((heads[n] for n in self.names), bias_vals):
                branch = nn.Module()
                widths = [in_channels] + [head_conv] * (depth - 1)
                branch.convs = nn.ModuleList(
                    _biased_conv(a, b, bias if i == depth - 1 else 0.0)
                    for i, (a, b) in enumerate(zip(widths, widths[1:] + [c])))
                branch.bns = nn.ModuleList(BatchNorm(head_conv, dtype=dtype, **_HEAD_BN)
                                           for _ in range(depth - 1))
                self.branches.append(branch)
            return
        self.depth = depths[0]
        hc = head_conv
        if self.depth > 1:
            self.branch_convbn0 = FusedConvBN(in_channels, hc * g, use_bias=True,
                                              dtype=dtype, **_HEAD_BN)
        for d in range(1, self.depth - 1):
            self._masked(f"branch_conv{d}", [hc] * g, [hc] * g, [0.0] * g)
            setattr(self, f"branch_bn{d}", BatchNorm(hc * g, dtype=dtype, **_HEAD_BN))
        if self.depth == 1:
            self.final_conv = _biased_conv(in_channels, sum(self.outs), torch.cat([
                torch.full((c,), v) for v, c in zip(bias_vals, self.outs)]))
        else:
            self._masked("final_conv", [hc] * g, self.outs, bias_vals)

    def _masked(self, name, cin_per, cout_per, bias_vals):
        """A block-diagonal 3x3 conv: branch i maps its ``cin_per[i]`` input slice to
        its ``cout_per[i]`` output slice (``{name}_weight`` OIHW, ``{name}_bias``, the
        ``{name}_mask`` buffer)."""
        mask = torch.zeros(sum(cout_per), sum(cin_per), 3, 3)
        ci = co = 0
        for a, c in zip(cin_per, cout_per):
            mask[co : co + c, ci : ci + a] = 1.0
            ci, co = ci + a, co + c
        setattr(self, f"{name}_weight", nn.Parameter(torch.zeros(mask.shape)))
        setattr(self, f"{name}_bias", nn.Parameter(torch.cat([
            torch.full((c,), v) for v, c in zip(bias_vals, cout_per)])))
        self.register_buffer(f"{name}_mask", mask, persistent=False)

    def masked_convs(self):
        """The names of the block-diagonal convs."""
        if not self.fused:
            return []
        return [f"branch_conv{d}" for d in range(1, self.depth - 1)] + (
            ["final_conv"] if self.depth > 1 else [])

    def _conv(self, h, weight, bias, slab=None):
        return rows_conv(h, weight, slab=slab, dtype=self.dtype) + bias.to(self.dtype)

    def _apply_masked(self, h, name, slab=None):
        w = getattr(self, f"{name}_weight") * getattr(self, f"{name}_mask")
        return self._conv(h, w, getattr(self, f"{name}_bias"), slab)

    def _materialise(self, x, pre):
        dt = self.dtype
        return torch.relu(x.to(dt) * pre[0].to(dt) + pre[1].to(dt))

    def forward(self, x, pre=None, slab=None):
        """``slab``: x is its rows of the map (so are the outputs)."""
        if not self.fused:
            if pre is not None:
                x = self._materialise(x, pre)
            out = {}
            for name, branch in zip(self.names, self.branches):
                h = x
                for conv, bn in zip(branch.convs, branch.bns):
                    h = torch.relu(bn(self._conv(h, conv.weight, conv.bias, slab)))
                out[name] = self._conv(h, branch.convs[-1].weight, branch.convs[-1].bias,
                                       slab)
            return out
        if self.depth == 1:
            h = x if pre is None else self._materialise(x, pre)
            y = self._conv(h, self.final_conv.weight, self.final_conv.bias, slab)
        else:
            h = self.branch_convbn0(x, pre=pre, slab=slab)
            for d in range(1, self.depth - 1):
                h = torch.relu(getattr(self, f"branch_bn{d}")(
                    self._apply_masked(h, f"branch_conv{d}", slab)))
            y = self._apply_masked(h, "final_conv", slab)
        out, co = {}, 0
        for name, c in zip(self.names, self.outs):
            out[name] = y[..., co : co + c]
            co += c
        return out


def _biased_conv(cin: int, cout: int, bias) -> nn.Conv2d:
    """A 3x3 conv whose bias starts at ``bias`` (a number or a (cout,) tensor); the
    builder draws its weight."""
    conv = nn.Conv2d(cin, cout, 3, padding=1)
    with torch.no_grad():
        conv.bias.copy_(torch.as_tensor(bias, dtype=torch.float32).expand(cout))
    return conv


class CenterHead(nn.Module):
    """x (B, H, W, Cin) -> list of per-task dicts of NHWC maps. The shared conv
    (``shared``, a FusedConvBN with a conv bias) hands its normalise + ReLU to every
    task's first branch conv (``emit_raw`` chain). With ``dcn_head`` every task is a
    ``DCNSepHead`` on the shared conv's materialised output (the deformable sampling
    reads the whole canvas)."""

    def __init__(self, in_channels: int, tasks: Sequence[dict], common_heads: dict = None,
                 share_conv_channel: int = 64, num_hm_conv: int = 2,
                 init_bias: float = -2.19, dcn_head: bool = False, dtype=torch.float32):
        from tdal_torch.models.dcn import DCNSepHead

        super().__init__()
        common = dict(common_heads or COMMON_HEADS)
        self.dcn_head = dcn_head
        self.shared = FusedConvBN(in_channels, share_conv_channel, use_bias=True,
                                  dtype=dtype, **_HEAD_BN)
        self.tasks = nn.ModuleList()
        for task in tasks:
            if dcn_head:
                self.tasks.append(DCNSepHead(share_conv_channel, dict(common),
                                             len(task["class_names"]), init_bias=init_bias,
                                             dtype=dtype))
                continue
            heads = dict(common)
            heads["hm"] = (len(task["class_names"]), num_hm_conv)
            self.tasks.append(SepHead(share_conv_channel, heads, final_kernel=3,
                                      init_bias=init_bias, dtype=dtype))

    def forward(self, x, slab=None):
        """x: the map, or ``slab``'s rows of it; the maps returned are whole."""
        if self.dcn_head:
            x = self.shared(x, slab=slab)
            preds = [task(x, slab=slab) for task in self.tasks]
        else:
            x, pre = self.shared(x, emit_raw=True, slab=slab)
            preds = [task(x, pre=pre, slab=slab) for task in self.tasks]
        if slab is None:
            return preds
        return [{k: slab.gather(v) for k, v in p.items()} for p in preds]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _gather_feat(feat, ind):
    """feat (B, HW, C), ind (B, M) -> (B, M, C)."""
    return torch.gather(feat, 1, ind[..., None].expand(-1, -1, feat.shape[-1]))


def fast_focal_loss(out, target, ind, mask, cat):
    """out/target (B, H, W, C) in [0, 1]; ind/mask/cat (B, M). CornerNet
    penalty-reduced focal loss (losses/centernet_loss.py:26-54)."""
    b = out.shape[0]
    gt = torch.pow(1 - target, 4)
    neg_loss = (torch.log(1 - out) * torch.pow(out, 2) * gt).sum()
    pos_all = _gather_feat(out.reshape(b, -1, out.shape[-1]), ind)
    pos_pred = (pos_all * F.one_hot(cat, out.shape[-1]).to(pos_all.dtype)).sum(-1)
    num_pos = all_reduce_sum(mask.sum().detach(), "data")
    pos_loss = (torch.log(pos_pred) * torch.pow(1 - pos_pred, 2) * mask).sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp_min(1))


def reg_loss(output, mask, ind, target):
    """output (B, H, W, D); mask/ind (B, M); target (B, M, D) -> per-dim L1 (D,)
    (losses/centernet_loss.py:6-24)."""
    b = output.shape[0]
    pred = _gather_feat(output.reshape(b, -1, output.shape[-1]), ind)
    m = mask.to(pred.dtype)[..., None]
    loss = torch.abs(pred * m - target * m) / (all_reduce_sum(m.sum().detach(), "data")
                                               + 1e-4)
    return loss.sum(dim=(0, 1))


def center_head_loss(preds_dicts, targets, code_weights, weight: float = 2.0,
                     has_vel: bool = False):
    """Total CenterHead loss over tasks and its logs. targets: per-task lists
    {hm, anno_box, ind, mask, cat} of tensors (center_head.py:250-291). The focal loss
    runs in f32 whatever the head's dtype (the box loss is f32 already: its targets
    are)."""
    total, logs = 0.0, {}
    for task_id, preds in enumerate(preds_dicts):
        # in f32 for a bf16 head too: tdal clips a bf16 sigmoid at 1 - 1e-4, which
        # rounds to 1 in bf16, so any heatmap logit above about 5.5 gives log(0)
        hm = torch.clamp(torch.sigmoid(preds["hm"].float()), 1e-4, 1 - 1e-4)
        hm_loss = fast_focal_loss(
            hm, targets["hm"][task_id], targets["ind"][task_id],
            targets["mask"][task_id].float(), targets["cat"][task_id],
        )
        target_box = targets["anno_box"][task_id]
        parts = [preds["reg"], preds["height"], preds["dim"]]
        if has_vel:
            parts.append(preds["vel"])
        else:
            target_box = torch.cat([target_box[..., :6], target_box[..., -2:]], dim=-1)
        parts.append(preds["rot"])
        box_loss = reg_loss(torch.cat(parts, dim=-1), targets["mask"][task_id],
                            targets["ind"][task_id], target_box)
        loc_loss = (box_loss * torch.as_tensor(code_weights, dtype=box_loss.dtype,
                                               device=box_loss.device)).sum()
        total = total + hm_loss + weight * loc_loss
        logs[f"hm_loss_task{task_id}"] = hm_loss
        logs[f"loc_loss_task{task_id}"] = loc_loss
        logs[f"num_positive_task{task_id}"] = targets["mask"][task_id].sum()
    logs["loss"] = total
    return total, logs


# ---------------------------------------------------------------------------
# Decode + post-process
# ---------------------------------------------------------------------------


def decode_preds(preds, test_cfg, activated: bool = False):
    """Per-task NHWC maps -> (boxes (B, HW, 7|9), hm (B, HW, C)): sigmoid of hm, exp of
    dim clipped to +-10, heading atan2(rot[..., 0], rot[..., 1]), grid offsets to world
    coordinates. Columns [x, y, z, l, w, h, (vx, vy,) heading]. ``activated``: hm and
    dim already hold probabilities and sizes (the double-flip merge averages after
    activation)."""
    hm = preds["hm"] if activated else torch.sigmoid(preds["hm"])
    b, H, W, num_cls = hm.shape
    dim = preds["dim"] if activated else torch.exp(preds["dim"].clamp(-10.0, 10.0))
    rot = torch.atan2(preds["rot"][..., 0:1], preds["rot"][..., 1:2])
    reg = preds["reg"]
    ys, xs = torch.meshgrid(torch.arange(H, device=reg.device, dtype=reg.dtype),
                            torch.arange(W, device=reg.device, dtype=reg.dtype),
                            indexing="ij")
    xs = xs[None, ..., None] + reg[..., 0:1]
    ys = ys[None, ..., None] + reg[..., 1:2]
    xs = xs * test_cfg["out_size_factor"] * test_cfg["voxel_size"][0] + test_cfg["pc_range"][0]
    ys = ys * test_cfg["out_size_factor"] * test_cfg["voxel_size"][1] + test_cfg["pc_range"][1]
    parts = [xs, ys, preds["height"], dim]
    if "vel" in preds:
        parts.append(preds["vel"])
    parts.append(rot)
    boxes = torch.cat(parts, dim=-1).reshape(b, H * W, -1)
    return boxes, hm.reshape(b, H * W, num_cls)


def post_process_task(batch_box_preds, batch_hm, test_cfg, task_id: int = 0):
    """Score threshold, the post-center-range mask and NMS per frame (rotated, or
    circle with ``test_cfg['circular_nms']``). Returns (B, post_max) tensors
    ``box3d_lidar``, ``scores`` (-inf in invalid slots), ``label_preds``, ``valid``, and
    ``index``, the kept candidates' positions in the HW axis. The rotated NMS reads the
    heading from the boxes' last column."""
    nms = test_cfg["nms"]
    pre_max, post_max = int(nms["nms_pre_max_size"]), int(nms["nms_post_max_size"])
    iou_thr = float(nms["nms_iou_threshold"])
    pcr = torch.tensor(test_cfg["post_center_limit_range"], dtype=batch_box_preds.dtype,
                       device=batch_box_preds.device)
    scores, labels = batch_hm.amax(dim=-1), batch_hm.argmax(dim=-1)
    centers = batch_box_preds[..., :3]
    dist_ok = (centers >= pcr[:3]).all(-1) & (centers <= pcr[3:]).all(-1)
    ok = (scores > float(test_cfg["score_threshold"])) & dist_ok
    masked = torch.where(ok, scores, torch.full_like(scores, -torch.inf))
    cols = [0, 1, 2, 3, 4, 5, batch_box_preds.shape[-1] - 1]
    outs = []
    for boxes, sc, lb in zip(batch_box_preds, masked, labels):
        if test_cfg.get("circular_nms", False):
            r = test_cfg["min_radius"]
            r = r[task_id] if isinstance(r, (list, tuple)) else r
            idx, valid = circle_nms(boxes[:, :2], sc, float(r), post_max)
        else:
            idx, valid = rotated_nms(boxes[:, cols], sc, iou_thr, pre_max, post_max)
        outs.append((boxes[idx], sc[idx], lb[idx], valid, idx))
    sel_boxes, sel_scores, sel_labels, valid, index = (torch.stack([o[j] for o in outs])
                                                       for j in range(5))
    return {
        "box3d_lidar": sel_boxes,
        "scores": torch.where(valid, sel_scores, torch.full_like(sel_scores, -torch.inf)),
        "label_preds": sel_labels,
        "valid": valid,
        "index": index,
    }


def predict(preds_dicts, test_cfg, num_classes: Sequence[int], activated: bool = False):
    """Decode and NMS per task (the spans ``predict.decode`` and ``predict.nms``), labels
    offset by the classes of the earlier tasks, the tasks' results concatenated along
    the box axis."""
    outs, flag = [], 0
    for task_id, preds in enumerate(preds_dicts):
        with span("predict.decode"):
            boxes, hm = decode_preds(preds, test_cfg, activated=activated)
        with span("predict.nms"):
            r = post_process_task(boxes, hm, test_cfg, task_id)
        r["label_preds"] = r["label_preds"] + flag
        flag += num_classes[task_id]
        outs.append(r)
    return {k: torch.cat([o[k] for o in outs], dim=1)
            for k in ("box3d_lidar", "scores", "label_preds", "valid")}
