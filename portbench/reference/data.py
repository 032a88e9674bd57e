"""The reference's host data: the training batches of a frame pool, worked out again.

Frozen copies, in plain numpy and torch, of the arithmetic of the port's training data
path as CenterPoint publishes it: the train-time augmentations (double random flip,
global rotation, global scaling; det3d preprocess.py:771-963), the class and BEV-range
filters, the point shuffle, the CenterNet targets (det3d AssignLabel and
center_utils.py) and the static-shape voxelization of the points
(point_cloud_ops.points_to_voxel's semantics). Nothing here imports the port.

``train_batches`` draws what the port's host pipeline draws, in its order: epoch e of
a pool of n frames visits ``numpy.random.default_rng(seed + e).permutation``-order
frames (an in-place ``shuffle`` of ``arange(n)``), and the dataset's one generator
``default_rng(dataset_seed)`` gives each visited frame, in turn, two flip draws, a
rotation, a scale and a permutation of its points.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Augmentations
# ---------------------------------------------------------------------------


def random_flip_both(gt_boxes, points, rng, probability=0.5):
    if rng.random() < probability:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + np.pi
        points[:, 1] = -points[:, 1]
        gt_boxes[:, 7] = -gt_boxes[:, 7]
    if rng.random() < probability:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        points[:, 0] = -points[:, 0]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + 2 * np.pi
        gt_boxes[:, 6] = -gt_boxes[:, 6]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rng, rotation):
    """Clockwise for a positive angle (det3d's rotation_points_single_angle)."""
    noise = rng.uniform(rotation[0], rotation[1])
    c, s = np.cos(noise), np.sin(noise)
    rot = np.array([[c, s], [-s, c]])
    points[:, :2] = points[:, :2] @ rot.T
    gt_boxes[:, :2] = gt_boxes[:, :2] @ rot.T
    gt_boxes[:, 6:8] = gt_boxes[:, 6:8] @ rot.T
    gt_boxes[:, -1] += noise
    return gt_boxes, points


def global_scaling(gt_boxes, points, rng, scale):
    noise = rng.uniform(scale[0], scale[1])
    points[:, :3] *= noise
    gt_boxes[:, :-1] *= noise
    return gt_boxes, points


# ---------------------------------------------------------------------------
# CenterNet targets
# ---------------------------------------------------------------------------


def gaussian_radius(det_size, min_overlap):
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1**2 - 4 * c1)) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2**2 - 16 * c2)) / 2
    a3, b3 = 4 * min_overlap, -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3**2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def draw_gaussian(heatmap, center, radius):
    diameter = 2 * radius + 1
    sigma = diameter / 6
    m = (diameter - 1.0) / 2.0
    y, x = np.ogrid[-m : m + 1, -m : m + 1]
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    x0, y0 = int(center[0]), int(center[1])
    height, width = heatmap.shape
    left, right = min(x0, radius), min(width - x0, radius + 1)
    top, bottom = min(y0, radius), min(height - y0, radius + 1)
    hm = heatmap[y0 - top : y0 + bottom, x0 - left : x0 + right]
    gg = g[radius - top : radius + bottom, radius - left : radius + right]
    if min(gg.shape) > 0 and min(hm.shape) > 0:
        np.maximum(hm, gg, out=hm)


def centernet_targets(boxes, classes, n_cls, grid, pc_range, voxel_size, out_size_factor,
                      overlap, max_objs, min_radius):
    """One task's targets: hm (C, H, W), anno_box (M, 10), ind, mask, cat (M,)."""
    fm_w, fm_h = (np.asarray(grid[:2]) // out_size_factor).astype(int)
    boxes = np.array(boxes, np.float32).reshape(-1, 9)
    if len(boxes):
        v = boxes[:, -1]
        boxes[:, -1] = v - np.floor(v / (2 * np.pi) + 0.5) * (2 * np.pi)
    hm = np.zeros((n_cls, fm_h, fm_w), np.float32)
    anno = np.zeros((max_objs, 10), np.float32)
    ind = np.zeros(max_objs, np.int64)
    mask = np.zeros(max_objs, np.float32)
    cat = np.zeros(max_objs, np.int64)
    for k in range(min(len(boxes), max_objs)):
        w_g = boxes[k, 3] / voxel_size[0] / out_size_factor
        l_g = boxes[k, 4] / voxel_size[1] / out_size_factor
        if w_g <= 0 or l_g <= 0:
            continue
        radius = max(min_radius, int(gaussian_radius((l_g, w_g), overlap)))
        ct = np.array([(boxes[k, 0] - pc_range[0]) / voxel_size[0] / out_size_factor,
                       (boxes[k, 1] - pc_range[1]) / voxel_size[1] / out_size_factor],
                      np.float32)
        ci = ct.astype(np.int32)
        if not (0 <= ci[0] < fm_w and 0 <= ci[1] < fm_h):
            continue
        c = int(classes[k]) - 1
        draw_gaussian(hm[c], ct, radius)
        cat[k], ind[k], mask[k] = c, ci[1] * fm_w + ci[0], 1.0
        rot = boxes[k, -1]
        anno[k] = np.concatenate([ct - ci, [boxes[k, 2]], np.log(boxes[k, 3:6]),
                                  boxes[k, 6:8], [np.sin(rot), np.cos(rot)]])
    return hm, anno, ind, mask, cat


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def grid_size(vg) -> np.ndarray:
    pc, vs = np.asarray(vg["range"]), np.asarray(vg["voxel_size"])
    return np.round((pc[3:] - pc[:3]) / vs).astype(np.int64)


def train_item(points, gt_boxes, gt_names, cfg, rng):
    """One training sample of a frame (its points as loaded: tanh'd intensity)."""
    pre, vg = cfg["train_preprocessor"], cfg["voxel_generator"]
    names_all = list(cfg["class_names"])
    keep = np.array([n in names_all for n in gt_names], bool)
    boxes, names = np.array(gt_boxes, np.float32)[keep].copy(), np.asarray(gt_names)[keep]
    points = points.copy()
    boxes, points = random_flip_both(boxes, points, rng)
    boxes, points = global_rotation(boxes, points, rng, pre["global_rot_noise"])
    boxes, points = global_scaling(boxes, points, rng, pre["global_scale_noise"])
    pcr = np.asarray(vg["range"])
    inr = ((boxes[:, 0] >= pcr[0]) & (boxes[:, 0] <= pcr[3]) & (boxes[:, 1] >= pcr[1])
           & (boxes[:, 1] <= pcr[4]))
    boxes, names = boxes[inr], names[inr]
    classes = np.array([names_all.index(n) + 1 for n in names], np.int32)
    a = cfg["assigner"]
    grid = grid_size(vg)
    out_size = int(a["out_size_factor"])
    targets, flag = [], 0
    for task in cfg["tasks"]:
        n = len(task["class_names"])
        sel = (classes > flag) & (classes <= flag + n)
        targets.append(centernet_targets(
            boxes[sel], classes[sel] - flag, n, grid, pcr, vg["voxel_size"], out_size,
            float(a["gaussian_overlap"]), int(a["max_objs"]), int(a["min_radius"])))
        flag += n
    if pre.get("shuffle_points", True):
        points = points[rng.permutation(len(points))]
    return pad_points(points, int(cfg["data"]["train"]["max_points"])), targets


def pad_points(points, n):
    out = np.full((n, points.shape[1]), np.nan, points.dtype)
    m = min(n, len(points))
    out[:m] = points[:m]
    return out


def train_batches(frames, cfg, batch_size, seed, dataset_seed, n_batches):
    """The first ``n_batches`` training batches over the pool ``frames`` (dicts with
    loader ``points``, ``gt_boxes`` and ``gt_names``): [(points (B, N, D), per-task
    targets stacked over the batch)]."""
    rng = np.random.default_rng(dataset_seed)
    out, epoch = [], 0
    steps = len(frames) // batch_size
    while len(out) < n_batches:
        idx = np.arange(len(frames))
        np.random.default_rng(seed + epoch).shuffle(idx)
        for s in range(steps):
            items = [train_item(frames[i]["points"], frames[i]["gt_boxes"],
                                frames[i]["gt_names"], cfg, rng)
                     for i in idx[s * batch_size : (s + 1) * batch_size]]
            pts = np.stack([it[0] for it in items])
            tasks = [tuple(np.stack([it[1][t][j] for it in items]) for j in range(5))
                     for t in range(len(cfg["tasks"]))]
            out.append((pts, tasks))
            if len(out) == n_batches:
                return out
        epoch += 1
    return out


# ---------------------------------------------------------------------------
# Voxelization
# ---------------------------------------------------------------------------


def voxelize(points, vg, max_voxels):
    """points (B, N, D) with NaN rows as padding -> voxels (B, V, P, D), coords (B, V, 3)
    zyx, num_points (B, V), n_voxels (B,), V = min(max_voxels, N): points outside the
    range dropped, at most P points a voxel in point order, voxels in the order of
    their (batch, z, y, x) cell."""
    b, n, d = points.shape
    dev, dt = points.device, points.dtype
    nx, ny, nz = (int(g) for g in grid_size(vg))
    big = nx * ny * nz
    p = int(vg["max_points_in_voxel"])
    v = min(int(max_voxels), n)
    lo = torch.tensor(vg["range"][:3], dtype=dt, device=dev)
    vs = torch.tensor(vg["voxel_size"], dtype=dt, device=dev)
    finite = torch.isfinite(points[..., :3]).all(-1)
    idx = torch.floor(torch.where(finite[..., None], (points[..., :3] - lo) / vs, -1.0)).long()
    ok = finite & (idx[..., 0] >= 0) & (idx[..., 0] < nx) & (idx[..., 1] >= 0) & (
        idx[..., 1] < ny) & (idx[..., 2] >= 0) & (idx[..., 2] < nz)
    cell = torch.where(ok, idx[..., 2] * (ny * nx) + idx[..., 1] * nx + idx[..., 0], big)
    offset = (big + 1) * torch.arange(b, device=dev)[:, None]
    order = torch.argsort((cell + offset).reshape(-1), stable=True)
    cell_s = (cell + offset).reshape(-1)[order].reshape(b, n) - offset
    pts = points.reshape(-1, d)[order].reshape(b, n, d)
    valid = cell_s < big
    first = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=dev),
                       cell_s[:, 1:] != cell_s[:, :-1]], 1) & valid
    vid = torch.cumsum(first.long(), 1) - 1
    pos = torch.arange(n, device=dev).expand(b, n)
    slot = torch.where(first & (vid < v), vid, v)
    start = torch.zeros(b, v + 1, dtype=torch.long, device=dev).scatter(1, slot, pos)[:, :v]
    n_vox = first.sum(1).clamp_max(v)
    slots = torch.arange(v, device=dev)
    live = slots[None] < n_vox[:, None]
    nxt = torch.where(slots[None] + 1 < n_vox[:, None], torch.roll(start, -1, 1),
                      valid.sum(1)[:, None])
    num = torch.where(live, (nxt - start).clamp_max(p), 0)
    pad = torch.cat([pts, torch.zeros(b, p, d, dtype=dt, device=dev)], 1)
    rows = (start[:, :, None] + torch.arange(p, device=dev)).reshape(b, -1, 1)
    vox = torch.gather(pad, 1, rows.expand(-1, -1, d)).reshape(b, v, p, d)
    vox = torch.where((torch.arange(p, device=dev) < num[..., None])[..., None], vox,
                      torch.zeros((), dtype=dt, device=dev))
    coords = torch.floor((vox[:, :, 0, :3] - lo) / vs).long().flip(-1)
    return vox, torch.where(live[..., None], coords, -1), num, n_vox
