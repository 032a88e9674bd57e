"""Sparse 3D convolution over sorted voxel buffers: submanifold and strided convs.

Port of ``tdal/ops/sparse_conv.py`` (the spconv-equivalent of the VoxelNet backbone),
batch-major: every function takes (B, V, ...) buffers where tdal vmaps over samples.

    coords (B, V, 3) zyx, feats (B, V, C), valid (B, V) bool, keys (B, V) int64

sorted by linearised key, invalid rows last with the int32-max sentinel
(``sort_voxels``). The ops are plain PyTorch, as tdal leaves them to XLA (no Pallas):

- neighbour tables by ``torch.searchsorted`` over the sorted keys. It finds the same
  slots as tdal's bitmap rank/select table (``build_bitmap_table``), which is a TPU
  memory layout: a slot is a voxel's rank among the valid keys either way;
- the contraction ``sum_k feats[idx[:, k]] @ W_k``: on a CUDA tensor one launch of the
  gather-GEMM kernel (``csrc/sparse_conv.cu``, built by ``tdal_torch.ops.build``), which
  gathers each tap's rows into shared memory, skips the rows past each sample's
  occupied count and the taps that no row of a tile finds, and writes each output row
  once; on a CPU tensor its twin, one gather and one ``addmm`` per tap (tdal's default
  per-tap path; its ``_PACKED_GATHER`` and ``_FUSED_MAX_V`` TPU experiments are not
  ported). For a CUDA tensor the kernel runs or the call raises: nothing falls back.
  Products are taken in f32 (bf16 operands rounded to bf16 first), as tdal's
  ``preferred_element_type=f32``;
- a backward without a scatter. Every conv carries, beside its forward table (for
  each output site and tap, the input slot), a backward table (for each input slot and
  tap, the output slot), so d feats is a gather too: for the submanifold conv the
  forward table itself with the taps flipped and the weights transposed (tdal's
  ``_subm_pertap_bwd``), for the strided convs its transpose, built by the same
  ``searchsorted`` lookup. d W_k = gather_k(feats)^T @ g. Every sum has a fixed order,
  so a step repeats bit for bit on the card (an ``index_add_`` of f32 rows is atomic
  there and would not).

A table holds global rows of the flattened (B * V) buffer; a missing neighbour is the
row count, B * V, which the twin reads as one zero row appended past the last. Each
conv hands the kernel each sample's occupied rows, up to its last valid row
(``occupied_rows``; for sorted voxels the valid count): the rows past them find no tap,
and the kernel skips them. Counted (``runtime/tracing.py``), for each forward table:
``sparse.rows_gathered``, K x the table's rows, from its shape, and, on the card,
``sparse.tile_taps``, K x the kernel's tiles of the table's rows (``tile_rows``); while a
profiler records, ``sparse.pairs``, the taps that found a voxel, and, on the card,
``sparse.tile_taps_loaded``, the (tile, tap)s of which some row finds the tap, which the
kernel loads: the shares of the padded table that are real neighbour pairs and that the
kernel loads. ``sparse_conv.launches`` counts the kernel's launches (forward and
dgrad).
"""

from __future__ import annotations

import numpy as np
import torch

from tdal_torch.runtime import tracing

SENTINEL = 2**31 - 1  # int32 max: invalid rows sort last

# the 27 taps (dz, dy, dx), dz slowest and dx fastest: tdal's _OFFSETS_3
OFFSETS_3 = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2),
                                 indexing="ij"), axis=-1).reshape(27, 3)
# the (3, 1, 1) z-compression's taps
OFFSETS_Z = np.array([[-1, 0, 0], [0, 0, 0], [1, 0, 0]])


def _linearize(coords, grid):
    _, ny, nx = grid
    return coords[..., 0] * (ny * nx) + coords[..., 1] * nx + coords[..., 2]


def _in_grid(coords, grid):
    nz, ny, nx = grid
    return ((coords[..., 0] >= 0) & (coords[..., 0] < nz) & (coords[..., 1] >= 0)
            & (coords[..., 1] < ny) & (coords[..., 2] >= 0) & (coords[..., 2] < nx))


def down2_grid(grid):
    return ((grid[0] + 1) // 2, (grid[1] + 1) // 2, (grid[2] + 1) // 2)


def downz_grid(grid):
    return ((grid[0] + 1) // 2, grid[1], grid[2])


def sort_voxels(coords, feats, valid, grid):
    """Sort the voxel buffers by linearised key, invalid rows last (a stable sort).
    Returns (coords, feats, valid, keys): the layout every op here expects."""
    keys = torch.where(valid, _linearize(coords.long(), grid), SENTINEL)
    order = torch.argsort(keys, dim=1, stable=True)
    return (coords.gather(1, order[..., None].expand(-1, -1, 3)),
            feats.gather(1, order[..., None].expand(-1, -1, feats.shape[-1])),
            valid.gather(1, order), keys.gather(1, order))


def _lookup(keys, query, ok, grid):
    """Slots of the voxels at ``query`` (B, M, 3) among the sorted ``keys`` (B, V):
    (idx (B, M), found (B, M)), idx 0 where not found. ``ok`` masks the queries."""
    b = ok.shape[0]
    qkey = torch.where(ok, _linearize(query, grid), -1).reshape(b, -1)
    slot = torch.searchsorted(keys, qkey).clamp_max(keys.shape[1] - 1)
    found = ok.reshape(b, -1) & (keys.gather(1, slot) == qkey)
    return torch.where(found, slot, 0).reshape(ok.shape), found.reshape(ok.shape)


def _offsets(offsets, like):
    return torch.as_tensor(offsets, dtype=torch.long, device=like.device)


def subm_neighbors(coords, valid, keys, grid):
    """The 3x3x3 neighbour table of a voxel set: (idx (B, V, 27), found (B, V, 27)) in
    ``OFFSETS_3`` order, exactly tdal's. Every submanifold conv at one resolution
    shares it."""
    nb = coords.long()[:, :, None, :] + _offsets(OFFSETS_3, coords)
    return _lookup(keys, nb, _in_grid(nb, grid) & valid[..., None], grid)


def occupied_rows(valid):
    """(B,) int64: each sample's rows up to and including its last valid one, of a
    (B, V) ``valid``; no table row past them finds a tap. For sorted voxels (valid rows
    first, as ``sort_voxels`` and the strided convs leave them) it is the valid count; a
    mask with holes keeps every valid row inside it."""
    pos = torch.arange(1, valid.shape[1] + 1, device=valid.device)
    return torch.where(valid, pos, 0).amax(1)


def tile_rows(cout: int) -> int:
    """Output rows of one tile of the gather-GEMM kernel for ``cout`` output channels,
    as the kernel (``csrc/sparse_conv.cu``) tiles them; -1 past 128 channels."""
    from tdal_torch.ops import build

    return build.kernels().sparse_conv_tile_rows(cout)


def tile_taps_loaded(found, rows: int):
    """Of a (B, V_out, K) ``found``, cut into tiles of ``rows`` rows of the flattened
    table: the (tile, tap)s of which some row finds the tap, a device count."""
    f = found.reshape(-1, found.shape[-1])
    pad = (-f.shape[0]) % rows
    if pad:
        f = torch.cat([f, f.new_zeros(pad, f.shape[1])])
    return f.reshape(-1, rows, f.shape[1]).any(1).sum()


def _count_gathers(found, rows=None):
    """A forward table's gathers, from its (B, V_out, K) ``found``; with ``rows``, the
    kernel's tile rows, also its tiles' taps."""
    b, v, k = found.shape
    tracing.count("sparse.rows_gathered", found.numel())
    if rows is not None:
        tracing.count("sparse.tile_taps", k * (-(-b * v // rows)))
    if tracing.recording():
        tracing.count_device("sparse.pairs", found.sum())
        if rows is not None:
            tracing.count_device("sparse.tile_taps_loaded", tile_taps_loaded(found, rows))


def _count(found, feats, weights):
    """``_count_gathers`` of a conv of ``feats`` by ``weights``: tiles on the card."""
    _count_gathers(found, tile_rows(weights.shape[2]) if feats.is_cuda else None)


def _table(idx, found, v_in):
    """(B, V_out, K) per-sample slots into inputs of ``v_in`` rows -> a tap-major (K,
    B * V_out) table of rows of the flattened (B * v_in) inputs; a missing tap points
    at row B * v_in (the zero row)."""
    b, _, k = idx.shape
    rows = idx + (torch.arange(b, device=idx.device) * v_in)[:, None, None]
    return torch.where(found, rows, b * v_in).reshape(-1, k).t().contiguous()


def _pertap(feats, table, weights):
    """The kernel's twin: sum_k feats[table[k]] @ weights[k] over a flattened (N, Cin)
    ``feats``, with products in f32; the zero row past N stands for a missing tap."""
    fp = torch.cat([feats, feats.new_zeros(1, feats.shape[1])])
    w = weights.to(feats.dtype).float()
    out = feats.new_zeros(table.shape[1], weights.shape[2], dtype=torch.float32)
    for k in range(table.shape[0]):
        out.addmm_(fp.index_select(0, table[k]).float(), w[k])
    return out.to(feats.dtype)


def gather_gemm(feats, table, weights, counts):
    """The kernel: ``_pertap(feats, table, weights)`` on the card in one launch.
    ``counts`` (B,) holds each sample's occupied rows of the output (table.shape[1] / B
    rows a sample), past which no row finds a tap: the kernel writes them as zero
    without reading their table entries. As in the twin, the weights are
    rounded to the features' type and the products taken in f32: bf16 features are read
    as they are, those of any other float type as f32, and the output has the features'
    type. Raises where the kernel takes no such shape: Cout a multiple of 8 up to 128,
    up to 27 taps, Cin past 8 in whole 16-byte rows."""
    from tdal_torch.ops import build

    if not feats.is_floating_point():
        raise TypeError(f"sparse_conv: float features, got {feats.dtype}")
    for name, t in (("table", table), ("counts", counts)):
        if t.device != feats.device or t.dtype != torch.int64:
            raise ValueError(f"sparse_conv: {name} must be int64 on {feats.device}")
    b = counts.numel()
    if table.shape[1] % b:
        raise ValueError(f"sparse_conv: {table.shape[1]} rows over {b} samples")
    x = (feats if feats.dtype == torch.bfloat16 else feats.float()).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    w = weights.to(feats.dtype).float().contiguous()  # as the twin rounds them
    out = torch.empty(table.shape[1], w.shape[2], dtype=x.dtype, device=x.device)
    build.kernels().sparse_conv(x, table.contiguous(), w, counts.contiguous(), out)
    tracing.count("sparse_conv.launches")
    return out.to(feats.dtype)


def _contract(feats, table, weights, counts):
    """sum_k feats[table[k]] @ weights[k]: the kernel on a CUDA tensor, the twin on the
    CPU."""
    if feats.is_cuda:
        return gather_gemm(feats, table, weights, counts)
    return _pertap(feats, table, weights)


def _wgrad(feats, table, g):
    """d W_k = feats[table[k]]^T @ g for each tap: (K, Cin, Cout) in f32."""
    fp = torch.cat([feats, feats.new_zeros(1, feats.shape[1])]).float()
    g = g.float()
    return torch.stack([fp.index_select(0, table[k]).t() @ g for k in range(table.shape[0])])


class _GatherConv(torch.autograd.Function):
    """out = sum_k feats[fwd[k]] @ W_k over flattened rows. Backward: for a
    submanifold conv (``bwd`` None) d feats = sum_k g[fwd[k]] @ W_{K-1-k}^T (the
    neighbour relation is symmetric: tap k of v is u iff tap K-1-k of u is v); for a
    strided conv d feats = sum_k g[bwd[k]] @ W_k^T with ``bwd`` the transposed table.
    ``n_out`` / ``n_in``: each sample's occupied rows of the output / the input (B,)."""

    @staticmethod
    def forward(ctx, feats, weights, fwd, bwd, n_out, n_in):
        ctx.save_for_backward(feats, weights, fwd, bwd, n_in)
        ctx.subm = bwd is None
        return _contract(feats, fwd, weights, n_out)

    @staticmethod
    def backward(ctx, g):
        feats, weights, fwd, bwd, n_in = ctx.saved_tensors
        dfeats = None
        if ctx.needs_input_grad[0]:
            if ctx.subm:
                dfeats = _contract(g, fwd, weights.flip(0).transpose(1, 2), n_in)
            else:
                dfeats = _contract(g, bwd, weights.transpose(1, 2), n_in)
            dfeats = dfeats.to(feats.dtype)
        return (dfeats, _wgrad(feats, fwd, g).to(weights.dtype), None, None, None, None)


def subm_conv3d(coords, feats, valid, keys, grid, weights, bias=None, neighbors=None,
                rows=None):
    """Submanifold 3x3x3 conv: out[v] = sum_k W_k @ feats[neighbour_k(v)], (B, V, Cout).

    ``weights`` (27, Cin, Cout) in ``OFFSETS_3`` order; ``neighbors`` =
    ``subm_neighbors(...)`` and ``rows`` = ``occupied_rows(valid)`` (or, for sorted
    voxels, the valid count) share the lookup and the count across the convs of one
    resolution. A ``rows`` short of a sample's last valid row zeroes its valid rows
    past it on the card."""
    if neighbors is None:
        neighbors = subm_neighbors(coords, valid, keys, grid)
    if rows is None:
        rows = occupied_rows(valid)
    b, v, cin = feats.shape
    fwd = _table(*neighbors, v)
    _count(neighbors[1], feats, weights)
    out = _GatherConv.apply(feats.reshape(b * v, cin), weights, fwd, None, rows, rows)
    out = out.reshape(b, v, -1)
    if bias is not None:
        out = out + bias
    return out * valid[..., None]


def _dedup_sites(cand, ok, out_grid, v_out):
    """Unique keys of the candidate output sites ``cand`` (B, M, 3) where ``ok``, the
    lowest ``v_out`` of them per sample: (out_coords, out_valid, out_keys, n_out), as
    tdal's sort + first-of-run + capped scatter computes them."""
    b = cand.shape[0]
    ckey = torch.where(ok, _linearize(cand, out_grid), SENTINEL)
    skey = torch.sort(ckey, dim=1).values
    first = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=cand.device),
                       skey[:, 1:] != skey[:, :-1]], dim=1) & (skey < SENTINEL)
    uid = torch.cumsum(first.long(), dim=1) - 1
    slot = torch.where(first & (uid < v_out), uid, v_out)
    out_keys = torch.full((b, v_out + 1), SENTINEL, dtype=torch.long, device=cand.device)
    out_keys = out_keys.scatter(1, slot, skey)[:, :v_out]
    n_out = first.sum(dim=1).clamp_max(v_out)
    out_valid = torch.arange(v_out, device=cand.device)[None, :] < n_out[:, None]
    _, oy, ox = out_grid
    out_coords = torch.stack([out_keys // (oy * ox), (out_keys % (oy * ox)) // ox,
                              out_keys % ox], dim=-1)
    out_coords = torch.where(out_valid[..., None], out_coords, 0)
    return out_coords, out_valid, torch.where(out_valid, out_keys, SENTINEL), n_out


def downsample_sites(coords, valid, grid, v_out: int):
    """Output sites of a k3/s2/p1 sparse conv: each input's (up to 2 per axis)
    receiving output positions, deduplicated into a fixed (B, v_out) buffer; on
    overflow the lowest keys are kept. Returns (out_coords, out_valid, out_keys, n_out)
    in sorted order."""
    out_grid = down2_grid(grid)
    c = coords.long()
    lo, hi = c // 2, (c + 1) // 2
    cands = [torch.stack([(hi if bz else lo)[..., 0], (hi if by else lo)[..., 1],
                          (hi if bx else lo)[..., 2]], dim=-1)
             for bz in (0, 1) for by in (0, 1) for bx in (0, 1)]
    cand = torch.cat(cands, dim=1)  # (B, 8V, 3), tap-combination major as tdal's
    ok = _in_grid(cand, out_grid) & valid.repeat(1, 8)
    return _dedup_sites(cand, ok, out_grid, v_out)


def _strided_conv(coords, feats, valid, keys, grid, weights, out, offsets, stride, bias,
                  rows):
    """The contraction of a strided sparse conv onto the output sites ``out`` =
    (out_coords, out_valid, out_keys, n_out): input coord = stride * o + offset for each
    tap, and, for the backward, each input's output slot o = (c - offset) / stride.
    ``rows``: ``occupied_rows(valid)``, or None to count them here."""
    out_coords, out_valid, out_keys, n_out = out
    if rows is None:
        rows = occupied_rows(valid)
    out_grid = tuple((n + s - 1) // s for n, s in zip(grid, stride))
    b, v, cin = feats.shape
    v_out = out_coords.shape[1]
    off = _offsets(offsets, feats)
    st = torch.as_tensor(stride, dtype=torch.long, device=feats.device)
    q = out_coords[:, :, None, :] * st + off  # (B, V_out, K, 3)
    idx, found = _lookup(keys, q, _in_grid(q, grid) & out_valid[..., None], grid)
    num = coords.long()[:, :, None, :] - off  # (B, V, K, 3)
    o = torch.div(num, st, rounding_mode="floor")
    ok = (o * st == num).all(-1) & _in_grid(o, out_grid) & valid[..., None]
    tidx, tfound = _lookup(out_keys, o, ok, out_grid)
    _count(found, feats, weights)
    y = _GatherConv.apply(feats.reshape(b * v, cin), weights, _table(idx, found, v),
                          _table(tidx, tfound, v_out), n_out, rows).reshape(b, v_out, -1)
    if bias is not None:
        y = y + bias
    return out_coords, y * out_valid[..., None], out_valid, out_keys


def sparse_conv3d_down2(coords, feats, valid, keys, grid, weights, v_out: int, bias=None,
                        rows=None):
    """k3/s2/p1 sparse conv (spconv SparseConv3d stride 2) onto ``downsample_sites``:
    for output site o and tap d, input coord = 2 o + d. Returns (out_coords, out_feats,
    out_valid, out_keys) on the grid ``down2_grid(grid)``; ``rows`` as ``subm_conv3d``'s."""
    sites = downsample_sites(coords, valid, grid, v_out)
    return _strided_conv(coords, feats, valid, keys, grid, weights, sites, OFFSETS_3,
                         (2, 2, 2), bias, rows)


def sparse_conv3d_downz(coords, feats, valid, keys, grid, weights, v_out: int, bias=None,
                        rows=None):
    """(3, 1, 1) kernel, stride (2, 1, 1) sparse conv: the backbone's final
    z-compression (reference scn.py:139-144), onto the grid ``downz_grid(grid)``;
    ``rows`` as ``subm_conv3d``'s."""
    out_grid = downz_grid(grid)
    c = coords.long()
    lo = torch.stack([c[..., 0] // 2, c[..., 1], c[..., 2]], dim=-1)
    hi = torch.stack([(c[..., 0] + 1) // 2, c[..., 1], c[..., 2]], dim=-1)
    cand = torch.cat([lo, hi], dim=1)
    ok = _in_grid(cand, out_grid) & valid.repeat(1, 2)
    sites = _dedup_sites(cand, ok, out_grid, v_out)
    return _strided_conv(coords, feats, valid, keys, grid, weights, sites, OFFSETS_Z,
                         (2, 1, 1), bias, rows)


def scatter_dense_bev(coords, feats, valid, grid):
    """Sparse -> dense (nz, ny, nx, C) -> BEV (B, ny, nx, nz * C) (spconv ``.dense()``
    and the reference's z-fold, scn.py:170-176).

    PRECONDITION: valid rows carry UNIQUE, IN-GRID coords (the strided convs' dedup
    gives that). Each invalid row goes to a dump row of its own past the grid, so every
    row has a distinct target and the scatter's backward is a plain gather."""
    nz, ny, nx = grid
    b, v, c = feats.shape
    n_cells = nz * ny * nx
    lin = torch.where(valid, _linearize(coords.long(), grid),
                      n_cells + torch.arange(v, device=feats.device))
    rows = lin + (torch.arange(b, device=feats.device) * (n_cells + v))[:, None]
    dense = feats.new_zeros(b * (n_cells + v), c).index_copy(0, rows.reshape(-1),
                                                             feats.reshape(-1, c))
    dense = dense.reshape(b, n_cells + v, c)[:, :n_cells].reshape(b, nz, ny, nx, c)
    return dense.permute(0, 2, 3, 1, 4).reshape(b, ny, nx, nz * c)
