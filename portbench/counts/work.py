"""Operations and bytes the detectors need, from their shapes, and the card's peaks.

Everything is counted from a configuration's published sizes and, for the sparse
layers, from the voxels these frames occupy: a multiply-add is 2 FLOP; a kernel's
bytes are each input read once and each output written once, in float32.

- ``dense_layers``: every dense conv of the RPN and CenterHead of a configuration
  (kernel, stride, input and output sizes), from which ``dense_flops`` is summed.
- ``pfn_flops``: the pillar feature net's dense layers over the points it keeps.
- ``conv3x3_sites``: the 3x3 stride-1 conv + BN sites that the port's hand kernels
  K3-K7 run in PointPillars training, with each launch's FLOP and bytes
  (``conv3x3_launches``).
- ``sparse_levels`` / ``sparse_convs``: the occupied voxels of each level of the sparse
  backbone, and each sparse conv's pairs (an output site and an input voxel under one
  tap), FLOP and bytes.

``PEAK_FLOPS`` is NVIDIA's published dense TF32 rate of an H100 SXM, the peak for
products of float32 operands; ``PEAK_BYTES`` its HBM3 bandwidth (data sheet, at the
700 W limit).
"""

from __future__ import annotations

import numpy as np
import torch

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32 = 4

HEAD_BRANCHES = {"reg": 2, "height": 1, "dim": 3, "rot": 2}
HEAD_CONV = 64  # CenterHead's shared and branch width
SPARSE_CHANNELS = (16, 32, 64, 128)
SPARSE_BLOCKS = 2


def least_seconds(flops: float, nbytes: float) -> tuple:
    """(the least time on the card, the bound that sets it: 'compute' or 'memory')."""
    t_c, t_m = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_c, "compute") if t_c >= t_m else (t_m, "memory")


def grid_size(vg) -> np.ndarray:
    pc, vs = np.asarray(vg["range"]), np.asarray(vg["voxel_size"])
    return np.round((pc[3:] - pc[:3]) / vs).astype(np.int64)


def bev_input(cfg) -> tuple:
    """(H, W, C) of the BEV map that enters the RPN."""
    nx, ny, nz = (int(g) for g in grid_size(cfg["voxel_generator"]))
    model = cfg["model"]
    if model["type"] == "PointPillars":
        return ny, nx, int(model["reader"]["num_filters"][-1])
    for _ in SPARSE_CHANNELS:  # three stride-2 convs and the z-compression
        nz = (nz + 1) // 2
    return (ny + 7) // 8, (nx + 7) // 8, nz * SPARSE_CHANNELS[-1]


def dense_layers(cfg) -> list:
    """[(name, k, stride, H_out, W_out, Cin, Cout, transposed)] of the RPN and head."""
    neck, head = cfg["model"]["neck"], cfg["model"]["bbox_head"]
    h, w, c = bev_input(cfg)
    out, ups = [], []
    up_start = len(neck["layer_nums"]) - len(neck["us_num_filters"])
    for i, n in enumerate(neck["layer_nums"]):
        s, f = int(neck["ds_layer_strides"][i]), int(neck["ds_num_filters"][i])
        h, w = (h + s - 1) // s, (w + s - 1) // s
        out.append((f"rpn{i}.0", 3, s, h, w, c, f, False))
        out += [(f"rpn{i}.{j}", 3, 1, h, w, f, f, False) for j in range(1, n + 1)]
        c = f
        j = i - up_start
        if j >= 0:
            us, uf = neck["us_layer_strides"][j], int(neck["us_num_filters"][j])
            if us > 1:
                out.append((f"deblock{j}", int(us), int(us), h * int(us), w * int(us), c, uf, True))
                ups.append((h * int(us), w * int(us), uf))
            else:
                d = int(round(1 / us))
                out.append((f"deblock{j}", d, d, h // d, w // d, c, uf, False))
                ups.append((h // d, w // d, uf))
    h, w = ups[-1][:2]
    c = sum(u[2] for u in ups)
    out.append(("head.shared", 3, 1, h, w, c, HEAD_CONV, False))
    for t, task in enumerate(head["tasks"]):
        branches = dict(HEAD_BRANCHES, hm=int(task["num_class"]))
        for name, co in branches.items():
            out.append((f"head{t}.{name}.0", 3, 1, h, w, HEAD_CONV, HEAD_CONV, False))
            out.append((f"head{t}.{name}.1", 3, 1, h, w, HEAD_CONV, co, False))
    return out


def layer_flops(k, s, h, w, cin, cout, transposed) -> float:
    if transposed:  # each input pixel scatters a k x k block
        return 2.0 * (h // s) * (w // s) * k * k * cin * cout
    return 2.0 * h * w * k * k * cin * cout


def dense_flops(cfg) -> float:
    """Forward FLOP of one frame's RPN and head."""
    return sum(layer_flops(*l[1:]) for l in dense_layers(cfg))


def pfn_flops(n_points: int, cfg) -> float:
    """Forward FLOP of the PFN's dense layers over ``n_points`` kept points."""
    reader = cfg["model"]["reader"]
    widths = [int(reader["num_input_features"]) + 5, *reader["num_filters"]]
    n = len(reader["num_filters"])
    total = 0.0
    for i in range(n):
        units = widths[i + 1] if i == n - 1 else widths[i + 1] // 2
        total += 2.0 * n_points * widths[i] * units
    return total


def conv3x3_sites(cfg, batch: int) -> list:
    """The FusedConvBN sites of PointPillars training: [(name, B, H, W, C, Co, has_bias,
    chained)], ``chained`` where the site's input is its predecessor's raw output (the
    kernels apply the predecessor's BN + ReLU on the way in)."""
    sites = []
    for name, k, s, h, w, cin, cout, tr in dense_layers(cfg):
        if k != 3 or s != 1 or tr:
            continue
        if name.startswith("rpn"):
            i, j = (int(v) for v in name[3:].split("."))
            stride0 = int(cfg["model"]["neck"]["ds_layer_strides"][i]) == 1
            chained = j > 1 or (j == 1 and stride0)
            sites.append((name, batch, h, w, cin, cout, False, chained))
        elif name == "head.shared":
            sites.append((name, batch, h, w, cin, cout, True, False))
    # every task's branch convs run as one 3x3 conv over all branches, chained on the
    # shared conv's output
    for t, task in enumerate(cfg["model"]["bbox_head"]["tasks"]):
        n = len(HEAD_BRANCHES) + 1
        h, w = sites[-1][2], sites[-1][3]
        sites.append((f"head{t}.branches", batch, h, w, HEAD_CONV, HEAD_CONV * n, True, True))
    return sites


def conv3x3_launches(sites) -> list:
    """[(kernel, FLOP, bytes)] of one training step's hand-kernel launches: per site the
    forward with its statistics (K3), the weight gradient (K5 chained, K6 not) and the
    input gradient (K7 chained, through the BN + ReLU; K4 not)."""
    out = []
    for _, b, h, w, c, co, _, chained in sites:
        px = b * h * w
        flops = 2.0 * px * 9 * c * co
        wts = 9 * c * co * F32
        vec = (2 * c if chained else 0) + co  # the input affine, the conv bias
        out.append(("conv3x3_fwd_stats", flops, F32 * (px * (c + co) + vec + 2 * co) + wts))
        out.append(("conv3x3_wgrad", flops,
                    F32 * (px * (c + co) + (2 * c if chained else 0)) + wts))
        if chained:  # gy, x, s, t -> dx and the (2, C) sums
            out.append(("conv3x3_dgrad_act", flops, F32 * (px * (co + 2 * c) + 4 * c) + wts))
        else:
            out.append(("conv3x3_fwd", flops, F32 * px * (co + c) + wts))
    return out


# ---------------------------------------------------------------------------
# Sparse backbone
# ---------------------------------------------------------------------------


def _keys(c, grid):
    return (c[:, 0] * grid[1] + c[:, 1]) * grid[2] + c[:, 2]


def _count_found(keys_sorted, query, grid):
    ok = ((query >= 0) & (query < torch.as_tensor(grid, device=query.device))).all(-1)
    q = torch.where(ok, _keys(query.reshape(-1, 3), grid).reshape(ok.shape), -1)
    slot = torch.searchsorted(keys_sorted, q.reshape(-1)).clamp_max(len(keys_sorted) - 1)
    found = ok.reshape(-1) & (keys_sorted[slot] == q.reshape(-1))
    return int(found.sum())


_TAPS = torch.stack(torch.meshgrid(*[torch.arange(-1, 2)] * 3, indexing="ij"), -1).reshape(27, 3)


def sparse_levels(points: np.ndarray, cfg, device="cpu") -> list:
    """One frame's voxels at each level of the sparse backbone: [(name, coords (n, 3)
    zyx, grid)], from its points (N, >= 3) in the vehicle frame."""
    vg = cfg["voxel_generator"]
    nx, ny, nz = (int(g) for g in grid_size(vg))
    p = torch.as_tensor(points[:, :3], dtype=torch.float32, device=device)
    lo = torch.tensor(vg["range"][:3], dtype=torch.float32, device=device)
    vs = torch.tensor(vg["voxel_size"], dtype=torch.float32, device=device)
    idx = torch.floor((p - lo) / vs).long()
    ok = ((idx >= 0) & (idx < torch.tensor([nx, ny, nz], device=device))).all(-1)
    coords = torch.unique(idx[ok].flip(-1), dim=0)
    grid = (nz, ny, nx)
    levels = [("input", coords, grid)]
    for i in range(1, len(SPARSE_CHANNELS)):
        lo2, hi2 = coords // 2, (coords + 1) // 2
        cand = torch.cat([torch.stack([(hi2 if bz else lo2)[:, 0], (hi2 if by else lo2)[:, 1],
                                       (hi2 if bx else lo2)[:, 2]], -1)
                          for bz in (0, 1) for by in (0, 1) for bx in (0, 1)])
        grid = tuple((g + 1) // 2 for g in grid)
        cand = cand[((cand >= 0) & (cand < torch.as_tensor(grid, device=device))).all(-1)]
        coords = torch.unique(cand, dim=0)
        levels.append((f"level {i}", coords, grid))
    cand = torch.cat([torch.stack([coords[:, 0] // 2, coords[:, 1], coords[:, 2]], -1),
                      torch.stack([(coords[:, 0] + 1) // 2, coords[:, 1], coords[:, 2]], -1)])
    grid = ((grid[0] + 1) // 2, grid[1], grid[2])
    cand = cand[cand[:, 0] < grid[0]]
    levels.append(("z-compressed", torch.unique(cand, dim=0), grid))
    return levels


def sparse_convs(levels) -> list:
    """[(name, pairs, FLOP, bytes)] of one frame's sparse convs, in forward order."""
    out = []
    chans = SPARSE_CHANNELS
    cin0 = 5
    for i, (name, coords, grid) in enumerate(levels):
        keys = torch.sort(_keys(coords, grid)).values
        n = len(coords)
        if i < len(chans):
            subm = _count_found(keys, coords[:, None, :] + _TAPS.to(coords.device)[None], grid)
            c = chans[i]
            convs = ([("subm in", subm, cin0, c)] if i == 0 else []) + [
                (f"subm L{i}", subm, c, c)] * (2 * SPARSE_BLOCKS)
            for label, pairs, a, b in convs:
                out.append((label, pairs, 2.0 * pairs * a * b,
                            F32 * (n * a + n * b + 27 * a * b)))
        if i > 0:  # the strided conv into this level: input = stride * out + tap
            _, pcoords, pgrid = levels[i - 1]
            pkeys = torch.sort(_keys(pcoords, pgrid)).values
            z_only = i == len(levels) - 1
            if z_only:
                taps = torch.tensor([[-1, 0, 0], [0, 0, 0], [1, 0, 0]], device=coords.device)
                stride = torch.tensor([2, 1, 1], device=coords.device)
                a = b = chans[-1]
            else:
                taps, stride = _TAPS.to(coords.device), torch.tensor([2, 2, 2], device=coords.device)
                a, b = chans[i - 1], chans[i]
            q = coords[:, None, :] * stride + taps[None]
            pairs = _count_found(pkeys, q, pgrid)
            out.append((f"down {name}", pairs, 2.0 * pairs * a * b,
                        F32 * (len(pcoords) * a + n * b + len(taps) * a * b)))
    return out
