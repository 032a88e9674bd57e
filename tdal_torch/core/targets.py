"""CenterNet target assignment: gaussian heatmaps + regression targets.

A copy of ``tdal/core/targets.py`` (host-side numpy, run in the data pipeline): the
per-task class split, the gaussian-radius heatmap splat, the anno_box encoding
[dx, dy, z, log(dim), vx, vy, sin, cos], the ind/mask/cat buffers and the padded
gt_boxes_and_cls of the two-stage model (reference ``AssignLabel``,
det3d/datasets/pipelines/preprocess.py:273-447, and center_utils.py:17-63).
Heatmaps are (H, W, C), channels last.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


def gaussian_radius(det_size, min_overlap: float = 0.5) -> float:
    """Parity: center_utils.py:17-37."""
    height, width = det_size
    a1, b1 = 1, height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(b1**2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2
    a2, b2 = 4, 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(b2**2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2
    a3, b3 = 4 * min_overlap, -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(b3**2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def gaussian_2d(shape, sigma: float = 1.0) -> np.ndarray:
    """Parity: center_utils.py:39-45."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0):
    """In-place max-splat of a gaussian onto heatmap (H, W).

    Parity: center_utils.draw_umich_gaussian (:48-63)."""
    diameter = 2 * radius + 1
    gaussian = gaussian_2d((diameter, diameter), sigma=diameter / 6)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    masked_hm = heatmap[y - top : y + bottom, x - left : x + right]
    masked_g = gaussian[radius - top : radius + bottom, radius - left : radius + right]
    if min(masked_g.shape) > 0 and min(masked_hm.shape) > 0:
        np.maximum(masked_hm, masked_g * k, out=masked_hm)
    return heatmap


@dataclasses.dataclass(frozen=True)
class AssignerConfig:
    tasks: Sequence[dict]  # [{'num_class': int, 'class_names': [...]}]
    out_size_factor: int
    gaussian_overlap: float = 0.1
    max_objs: int = 500
    min_radius: int = 2


def assign_centernet_targets(
    gt_boxes: np.ndarray,
    gt_classes: np.ndarray,
    cfg: AssignerConfig,
    grid_size,
    pc_range,
    voxel_size,
) -> Dict[str, List[np.ndarray]]:
    """gt_boxes (N, 9) detector-convention [x,y,z,w,l,h,vx,vy,rot]; gt_classes (N,)
    1-based over the flattened task class list.

    Returns per-task lists: hm (H, W, C), anno_box (max_objs, 10), ind/mask/cat
    (max_objs,), plus 'gt_boxes_and_cls' (max_objs, 10). Parity: AssignLabel.__call__
    (preprocess.py:284-447)."""
    grid_size = np.asarray(grid_size)
    pc_range = np.asarray(pc_range)
    voxel_size = np.asarray(voxel_size)
    fm_w, fm_h = (grid_size[:2] // cfg.out_size_factor).astype(int)
    max_objs = cfg.max_objs

    # Limit heading to [-pi, pi) (preprocess.py:331-335).
    gt_boxes = np.array(gt_boxes, np.float32).reshape(-1, 9)
    if len(gt_boxes):
        v = gt_boxes[:, -1]
        gt_boxes[:, -1] = v - np.floor(v / (2 * np.pi) + 0.5) * (2 * np.pi)

    hms, anno_boxs, inds, masks, cats = [], [], [], [], []
    flag = 0
    for task in cfg.tasks:
        n_cls = len(task["class_names"])
        sel = (gt_classes > flag) & (gt_classes <= flag + n_cls)
        boxes_t = gt_boxes[sel]
        classes_t = gt_classes[sel] - flag  # 1-based within task

        hm = np.zeros((fm_h, fm_w, n_cls), np.float32)
        anno_box = np.zeros((max_objs, 10), np.float32)
        ind = np.zeros((max_objs,), np.int64)
        mask = np.zeros((max_objs,), np.uint8)
        cat = np.zeros((max_objs,), np.int64)

        for k in range(min(len(boxes_t), max_objs)):
            cls_id = int(classes_t[k]) - 1
            w, l, h = boxes_t[k, 3], boxes_t[k, 4], boxes_t[k, 5]
            w_g = w / voxel_size[0] / cfg.out_size_factor
            l_g = l / voxel_size[1] / cfg.out_size_factor
            if w_g <= 0 or l_g <= 0:
                continue
            radius = max(
                cfg.min_radius, int(gaussian_radius((l_g, w_g), cfg.gaussian_overlap))
            )
            x, y, z = boxes_t[k, 0], boxes_t[k, 1], boxes_t[k, 2]
            coor_x = (x - pc_range[0]) / voxel_size[0] / cfg.out_size_factor
            coor_y = (y - pc_range[1]) / voxel_size[1] / cfg.out_size_factor
            ct = np.array([coor_x, coor_y], np.float32)
            ct_int = ct.astype(np.int32)
            if not (0 <= ct_int[0] < fm_w and 0 <= ct_int[1] < fm_h):
                continue
            draw_gaussian(hm[..., cls_id], ct, radius)
            cat[k] = cls_id
            ind[k] = ct_int[1] * fm_w + ct_int[0]
            mask[k] = 1
            vx, vy = boxes_t[k, 6:8]
            rot = boxes_t[k, -1]
            anno_box[k] = np.concatenate(
                [
                    ct - ct_int,
                    [z],
                    np.log(boxes_t[k, 3:6]),
                    [vx, vy, np.sin(rot), np.cos(rot)],
                ]
            )
        hms.append(hm)
        anno_boxs.append(anno_box)
        inds.append(ind)
        masks.append(mask)
        cats.append(cat)
        flag += n_cls

    # Padded gt boxes + class for the two-stage model (preprocess.py:425-445),
    # reordered to [x, y, z, w, l, h, rot, vx, vy, cls].
    gt_boxes_and_cls = np.zeros((max_objs, 10), np.float32)
    n = min(len(gt_boxes), max_objs)
    if n:
        packed = np.concatenate(
            [gt_boxes[:n], gt_classes[:n, None].astype(np.float32)], axis=1
        )
        gt_boxes_and_cls[:n] = packed[:, [0, 1, 2, 3, 4, 5, 8, 6, 7, 9]]

    return {
        "hm": hms,
        "anno_box": anno_boxs,
        "ind": inds,
        "mask": masks,
        "cat": cats,
        "gt_boxes_and_cls": gt_boxes_and_cls,
    }
