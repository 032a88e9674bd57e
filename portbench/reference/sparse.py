"""The reference's sparse middle backbone (det3d SpMiddleResNetFHD, eval mode): plain
torch over sorted voxel buffers, batch-major.

A frozen copy of the forward arithmetic of a submanifold / strided sparse conv as
spconv defines it: neighbour tables by ``searchsorted`` over the sorted linear keys,
the contraction ``sum_k feats[nbr_k] @ W_k`` one tap at a time, and the strided convs'
output sites deduplicated and capped at a level's buffer, lowest keys first. It has no
backward: the reference never trains VoxelNet.

    coords (B, V, 3) zyx, feats (B, V, C), valid (B, V) bool, keys (B, V) int64
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = 2**31 - 1
OFFSETS_3 = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2),
                                 indexing="ij"), axis=-1).reshape(27, 3)
OFFSETS_Z = np.array([[-1, 0, 0], [0, 0, 0], [1, 0, 0]])
CHANNELS = (16, 32, 64, 128)
BLOCKS = 2
EPS = 1e-3


def _linearize(c, grid):
    return c[..., 0] * (grid[1] * grid[2]) + c[..., 1] * grid[2] + c[..., 2]


def _in_grid(c, grid):
    return ((c[..., 0] >= 0) & (c[..., 0] < grid[0]) & (c[..., 1] >= 0) & (c[..., 1] < grid[1])
            & (c[..., 2] >= 0) & (c[..., 2] < grid[2]))


def down2_grid(grid):
    return tuple((g + 1) // 2 for g in grid)


def sort_voxels(coords, feats, valid, grid):
    keys = torch.where(valid, _linearize(coords.long(), grid), SENTINEL)
    order = torch.argsort(keys, dim=1, stable=True)
    return (coords.gather(1, order[..., None].expand(-1, -1, 3)),
            feats.gather(1, order[..., None].expand(-1, -1, feats.shape[-1])),
            valid.gather(1, order), keys.gather(1, order))


def lookup(keys, query, ok, grid):
    """Slots of ``query`` (B, M, K, 3) among the sorted ``keys``: (idx, found)."""
    b = ok.shape[0]
    q = torch.where(ok, _linearize(query, grid), -1).reshape(b, -1)
    slot = torch.searchsorted(keys, q).clamp_max(keys.shape[1] - 1)
    found = ok.reshape(b, -1) & (keys.gather(1, slot) == q)
    return torch.where(found, slot, 0).reshape(ok.shape), found.reshape(ok.shape)


def neighbours(coords, valid, keys, grid):
    nb = coords.long()[:, :, None, :] + torch.as_tensor(OFFSETS_3, device=coords.device)
    return lookup(keys, nb, _in_grid(nb, grid) & valid[..., None], grid)


def contract(feats, idx, found, weights):
    """out (B, V_out, Cout) = sum_k feats[idx[..., k]] @ W_k over the found taps."""
    b, v, cin = feats.shape
    rows = idx + (torch.arange(b, device=idx.device) * v)[:, None, None]
    rows = torch.where(found, rows, b * v).reshape(-1, idx.shape[-1])
    fp = torch.cat([feats.reshape(b * v, cin), feats.new_zeros(1, cin)])
    out = feats.new_zeros(rows.shape[0], weights.shape[2])
    for k in range(rows.shape[1]):
        out.addmm_(fp.index_select(0, rows[:, k]), weights[k])
    return out.reshape(b, idx.shape[1], -1)


def dedup_sites(cand, ok, out_grid, v_out):
    b = cand.shape[0]
    skey = torch.sort(torch.where(ok, _linearize(cand, out_grid), SENTINEL), dim=1).values
    first = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=cand.device),
                       skey[:, 1:] != skey[:, :-1]], 1) & (skey < SENTINEL)
    uid = torch.cumsum(first.long(), 1) - 1
    slot = torch.where(first & (uid < v_out), uid, v_out)
    keys = torch.full((b, v_out + 1), SENTINEL, dtype=torch.long, device=cand.device)
    keys = keys.scatter(1, slot, skey)[:, :v_out]
    valid = torch.arange(v_out, device=cand.device)[None] < first.sum(1).clamp_max(v_out)[:, None]
    _, oy, ox = out_grid
    coords = torch.stack([keys // (oy * ox), (keys % (oy * ox)) // ox, keys % ox], -1)
    return torch.where(valid[..., None], coords, 0), valid, torch.where(valid, keys, SENTINEL)


def strided(coords, feats, valid, keys, grid, weights, v_out, z_only):
    """A k3/s2/p1 sparse conv (``z_only``: the (3, 1, 1) / (2, 1, 1) z-compression)."""
    c = coords.long()
    if z_only:
        out_grid = ((grid[0] + 1) // 2, grid[1], grid[2])
        lo = torch.stack([c[..., 0] // 2, c[..., 1], c[..., 2]], -1)
        hi = torch.stack([(c[..., 0] + 1) // 2, c[..., 1], c[..., 2]], -1)
        cand, reps, offsets, stride = torch.cat([lo, hi], 1), 2, OFFSETS_Z, (2, 1, 1)
    else:
        out_grid = down2_grid(grid)
        lo, hi = c // 2, (c + 1) // 2
        cand = torch.cat([torch.stack([(hi if bz else lo)[..., 0], (hi if by else lo)[..., 1],
                                       (hi if bx else lo)[..., 2]], -1)
                          for bz in (0, 1) for by in (0, 1) for bx in (0, 1)], 1)
        reps, offsets, stride = 8, OFFSETS_3, (2, 2, 2)
    ok = _in_grid(cand, out_grid) & valid.repeat(1, reps)
    oc, ov, ok_keys = dedup_sites(cand, ok, out_grid, v_out)
    st = torch.as_tensor(stride, device=c.device)
    q = oc[:, :, None, :] * st + torch.as_tensor(offsets, device=c.device)
    idx, found = lookup(keys, q, _in_grid(q, grid) & ov[..., None], grid)
    y = contract(feats, idx, found, weights) * ov[..., None]
    return oc, y, ov, ok_keys, out_grid


def middle_backbone(feats, coords, valid, grid, w):
    """feats (B, V, Cin), coords (B, V, 3) zyx, valid -> (BEV (B, ny, nx, nz * C), the
    occupied voxels of each level: [(B,) counts])."""
    v = feats.shape[1]
    caps = (v, v // 2, v // 4, v // 8)
    norms = iter(range(10**6))

    def bn(x, valid):
        k = next(norms)
        p = f"backbone.norms.{k}."
        mean, var = w[p + "running_mean"], w[p + "running_var"]
        return (x - mean) * torch.rsqrt(var + EPS) * w[p + "weight"] + w[p + "bias"]

    def relu(x, valid):
        return torch.relu(x) * valid[..., None]

    coords, feats, valid, keys = sort_voxels(coords, feats, valid, grid)
    occupancy = [valid.sum(1)]
    nb = neighbours(coords, valid, keys, grid)
    x = relu(bn(contract(feats, *nb, w["backbone.w_in"]) * valid[..., None], valid), valid)
    for i in range(len(CHANNELS)):
        for j in range(BLOCKS):
            y = contract(x, *nb, w[f"backbone.w_blk{i}_{j}_a"]) * valid[..., None]
            y = relu(bn(y, valid), valid)
            y = bn(contract(y, *nb, w[f"backbone.w_blk{i}_{j}_b"]) * valid[..., None], valid)
            x = relu(y + x, valid)
        if i + 1 < len(CHANNELS):
            coords, x, valid, keys, grid = strided(coords, x, valid, keys, grid,
                                                   w[f"backbone.w_down{i}"], caps[i + 1], False)
            occupancy.append(valid.sum(1))
            nb = neighbours(coords, valid, keys, grid)
            x = relu(bn(x, valid), valid)
    coords, x, valid, keys, grid = strided(coords, x, valid, keys, grid, w["backbone.w_z"],
                                           caps[-1], True)
    occupancy.append(valid.sum(1))
    x = relu(bn(x, valid), valid)
    nz, ny, nx = grid
    b, vv, c = x.shape
    cells = nz * ny * nx
    lin = torch.where(valid, _linearize(coords.long(), grid),
                      cells + torch.arange(vv, device=x.device))
    rows = lin + (torch.arange(b, device=x.device) * (cells + vv))[:, None]
    dense = x.new_zeros(b * (cells + vv), c).index_copy(0, rows.reshape(-1), x.reshape(-1, c))
    dense = dense.reshape(b, cells + vv, c)[:, :cells].reshape(b, nz, ny, nx, c)
    return dense.permute(0, 2, 3, 1, 4).reshape(b, ny, nx, nz * c), occupancy
