"""The port's sparse 3D convolution (``tdal_torch.ops.sparse_conv``) against tdal's
(``tdal.ops.sparse_conv``, vmapped over the batch), on the CPU, on small grids: tdal's
own (4, 8, 8), (4, 4, 4) and (5, 4, 4), and a ragged (5, 6, 7).

Tolerances:
- sorted buffers, keys, neighbour tables, downsampled sites and the dense BEV scatter:
  exactly equal (integer arithmetic, and the scatter moves values without arithmetic);
- conv outputs, d feats and d W: 1e-5 of max(1, |tdal|) (f32 sums of the same
  products in another order: tdal's d feats of a strided conv is XLA's scatter-add, the
  port's a gather over the transposed table).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdal.ops import sparse_conv as J
from tdal_torch.ops import sparse_conv as T

torch.set_num_threads(2)

GRIDS = [(4, 8, 8), (4, 4, 4), (5, 4, 4), (5, 6, 7)]
TOL = 1e-5


def _close(got, want, msg=""):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= TOL * max(1.0, float(np.abs(want).max())), f"{msg}: {err:.3e}"


def _voxels(grid, n_active=(30, 17), v=40, c=4, seed=0):
    """(B, V) buffers in arbitrary order: distinct in-grid coords in the first n rows,
    invalid rows (coords 0, as tdal's tests pad them) after."""
    rng = np.random.default_rng(seed)
    b = len(n_active)
    coords = np.zeros((b, v, 3), np.int32)
    valid = np.zeros((b, v), bool)
    n_cells = int(np.prod(grid))
    for i, n in enumerate(n_active):
        n = min(n, n_cells)
        lin = rng.choice(n_cells, n, replace=False)
        coords[i, :n] = np.stack([lin // (grid[1] * grid[2]), (lin // grid[2]) % grid[1],
                                  lin % grid[2]], 1)
        valid[i, :n] = True
        perm = rng.permutation(v)
        coords[i], valid[i] = coords[i, perm], valid[i, perm]
    feats = (rng.normal(size=(b, v, c)) * valid[..., None]).astype(np.float32)
    return coords, feats, valid


def _sorted_pair(grid, **kw):
    coords, feats, valid = _voxels(grid, **kw)
    ref = jax.vmap(lambda c, f, m: J.sort_voxels(c, f, m, grid))(
        jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid))
    got = T.sort_voxels(torch.from_numpy(coords), torch.from_numpy(feats),
                        torch.from_numpy(valid), grid)
    return ref, got


@pytest.mark.parametrize("grid", GRIDS)
def test_sort_voxels_and_neighbor_tables_are_exactly_tdal(grid):
    ref, got = _sorted_pair(grid)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    jc, _, jv, jk = ref
    tc, _, tv, tk = got
    jn = jax.vmap(lambda c, m, k: J.subm_neighbors(c, m, k, grid))(jc, jv, jk)
    tn = T.subm_neighbors(tc, tv, tk, grid)
    assert int(tn[1].sum()) > int(tv.sum())  # some voxel has a neighbour beyond itself
    for r, g in zip(jn, tn):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sort_voxels_is_stable_on_equal_keys():
    """Invalid rows all carry the sentinel: they keep their order, after the valid."""
    coords = torch.tensor([[[0, 0, 1], [0, 0, 0], [1, 1, 1], [0, 0, 2]]])
    feats = torch.arange(4.0).reshape(1, 4, 1)
    valid = torch.tensor([[False, True, False, True]])
    _, f, v, k = T.sort_voxels(coords, feats, valid, (2, 2, 3))
    assert f.flatten().tolist() == [1.0, 3.0, 0.0, 2.0]
    assert k[0, 2:].tolist() == [T.SENTINEL, T.SENTINEL] and v.tolist() == [[1, 1, 0, 0]]


@pytest.mark.parametrize("grid", GRIDS)
def test_subm_conv3d_forward_and_gradients_match_tdal(grid):
    (jc, jf, jv, jk), (tc, tf, tv, tk) = _sorted_pair(grid, seed=1)
    rng = np.random.default_rng(2)
    w = rng.normal(size=(27, 4, 5)).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)

    def ref_fn(f, w):
        return jax.vmap(lambda c, f_, m, k: J.subm_conv3d(c, f_, m, k, grid, w, bias))(
            jc, f, jv, jk)

    y_ref, vjp = jax.vjp(ref_fn, jf, jnp.asarray(w))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    df_ref, dw_ref = vjp(jnp.asarray(g))
    tw = torch.from_numpy(w).requires_grad_()
    tff = tf.clone().requires_grad_()
    y = T.subm_conv3d(tc, tff, tv, tk, grid, tw, torch.from_numpy(bias))
    y.backward(torch.from_numpy(g))
    _close(y.detach().numpy(), y_ref, "forward")
    _close(tff.grad.numpy(), df_ref, "d feats")
    _close(tw.grad.numpy(), dw_ref, "d W")


@pytest.mark.parametrize("cap", [40, 5])
@pytest.mark.parametrize("grid", GRIDS)
def test_downsample_sites_are_exactly_tdal(grid, cap):
    """Without and with overflow of the v_out buffer (the lowest keys are kept)."""
    (jc, _, jv, _), (tc, _, tv, _) = _sorted_pair(grid, seed=3)
    ref = jax.vmap(lambda c, m: J.downsample_sites(c, m, grid, cap))(jc, jv)
    got = T.downsample_sites(tc, tv, grid, cap)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if cap == 5:
        assert (got[3] == cap).all()  # overflowed


@pytest.mark.parametrize("cap", [40, 9])
@pytest.mark.parametrize("which", ["down2", "downz"])
@pytest.mark.parametrize("grid", GRIDS)
def test_strided_sparse_convs_match_tdal(grid, which, cap):
    (jc, jf, jv, jk), (tc, tf, tv, tk) = _sorted_pair(grid, seed=4)
    jfn, tfn, taps = {"down2": (J.sparse_conv3d_down2, T.sparse_conv3d_down2, 27),
                      "downz": (J.sparse_conv3d_downz, T.sparse_conv3d_downz, 3)}[which]
    rng = np.random.default_rng(5)
    w = rng.normal(size=(taps, 4, 6)).astype(np.float32)

    def ref_fn(f, w):
        return jax.vmap(lambda c, f_, m, k: jfn(c, f_, m, k, grid, w, cap))(jc, f, jv, jk)

    ref, vjp = jax.vjp(ref_fn, jf, jnp.asarray(w))
    g = rng.normal(size=ref[1].shape).astype(np.float32)
    zero = [np.zeros(r.shape, jax.dtypes.float0) if r.dtype != np.float32 else None
            for r in ref]
    df_ref, dw_ref = vjp(tuple(jnp.asarray(g) if i == 1 else zero[i] for i in range(4)))
    tw = torch.from_numpy(w).requires_grad_()
    tff = tf.clone().requires_grad_()
    got = tfn(tc, tff, tv, tk, grid, tw, cap)
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    got[1].backward(torch.from_numpy(g))
    _close(got[1].detach().numpy(), ref[1], "forward")
    _close(tff.grad.numpy(), df_ref, "d feats")
    _close(tw.grad.numpy(), dw_ref, "d W")


@pytest.mark.parametrize("grid", GRIDS)
def test_scatter_dense_bev_is_exactly_tdal(grid):
    (jc, jf, jv, _), (tc, tf, tv, _) = _sorted_pair(grid, seed=6)
    ref = jax.vmap(lambda c, f, m: J.scatter_dense_bev(c, f, m, grid))(jc, jf, jv)
    got = T.scatter_dense_bev(tc, tf, tv, grid)
    assert got.shape == (2, grid[1], grid[2], grid[0] * 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sparse_backward_runs_no_scatter_add():
    """No sparse backward reaches a scatter-add (atomic on the card, so its sums would
    differ from run to run): the aten ops of the backward of a subm conv, a strided conv
    and the BEV scatter, as the dispatcher sees them, hold none."""
    from torch.utils._python_dispatch import TorchDispatchMode

    grid = (4, 8, 8)
    _, (tc, tf, tv, tk) = _sorted_pair(grid, seed=7)
    tff = tf.clone().requires_grad_()
    w = torch.randn(27, 4, 4, requires_grad=True)
    wz = torch.randn(3, 4, 4, requires_grad=True)
    y = T.subm_conv3d(tc, tff, tv, tk, grid, w)
    c2, y2, v2, k2 = T.sparse_conv3d_down2(tc, y, tv, tk, grid, w, 40)
    c3, y3, v3, _ = T.sparse_conv3d_downz(c2, y2, v2, k2, T.down2_grid(grid), wz, 40)
    bev = T.scatter_dense_bev(c3, y3, v3, T.downz_grid(T.down2_grid(grid)))

    class Ops(TorchDispatchMode):
        seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.seen.add(str(func))
            return func(*args, **(kwargs or {}))

    with Ops():
        (bev ** 2).sum().backward()
    assert any("index_select" in n for n in Ops.seen) and any("mm" in n for n in Ops.seen)
    assert not [n for n in Ops.seen if "index_add" in n or "scatter_add" in n
                or "index_put" in n or "scatter_reduce" in n], sorted(Ops.seen)


def _refuse_kernels():
    raise AssertionError("a CPU tensor reached the CUDA kernel library")


@pytest.mark.parametrize("which", ["subm", "down2", "downz"])
def test_a_cpu_tensor_takes_the_twin_which_still_matches_tdal(which, monkeypatch):
    """On the CPU every contraction (forward and d feats) is the per-tap twin: the kernel
    library is never asked for, no kernel launch is counted, and the twin's outputs and
    gradients are tdal's."""
    from tdal_torch.ops import build
    from tdal_torch.runtime import tracing

    monkeypatch.setattr(build, "kernels", _refuse_kernels)
    grid = (5, 6, 7)
    (jc, jf, jv, jk), (tc, tf, tv, tk) = _sorted_pair(grid, seed=8)
    taps = 3 if which == "downz" else 27
    rng = np.random.default_rng(9)
    w = rng.normal(size=(taps, 4, 8)).astype(np.float32)
    jfn, tfn = {"subm": (J.subm_conv3d, T.subm_conv3d),
                "down2": (J.sparse_conv3d_down2, T.sparse_conv3d_down2),
                "downz": (J.sparse_conv3d_downz, T.sparse_conv3d_downz)}[which]
    extra = () if which == "subm" else (40,)

    def ref_fn(f, w):
        out = jax.vmap(lambda c, f_, m, k: jfn(c, f_, m, k, grid, w, *extra))(jc, f, jv, jk)
        return out if which == "subm" else out[1]

    ref, vjp = jax.vjp(ref_fn, jf, jnp.asarray(w))
    g = rng.normal(size=ref.shape).astype(np.float32)
    df_ref, _ = vjp(jnp.asarray(g))
    launches = tracing.counters().get("sparse_conv.launches", 0)
    tff = tf.clone().requires_grad_()
    got = tfn(tc, tff, tv, tk, grid, torch.from_numpy(w), *extra)
    got = got if which == "subm" else got[1]
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), ref, "forward")
    _close(tff.grad.numpy(), df_ref, "d feats")
    assert tracing.counters().get("sparse_conv.launches", 0) == launches


def test_the_tile_counters_on_a_hand_made_table():
    """``sparse.tile_taps`` is K x the kernel's tiles of a forward table's rows;
    ``sparse.tile_taps_loaded`` (while a profiler records) the (tile, tap)s that some row
    of the tile finds; tiles run over the flattened rows, across samples. Without tile
    rows (a CPU conv: no kernel, no tiles) neither is counted."""
    from tdal_torch.runtime import tracing

    # 2 samples x 5 rows, 3 taps; tiles of 4 rows: rows 0-3, 4-7, 8-9
    found = torch.zeros(2, 5, 3, dtype=torch.bool)
    found[0, 0, 1] = found[0, 3, 2] = True  # tile 0: taps 1, 2
    found[0, 4, 1] = found[1, 2, 1] = True  # tile 1: tap 1 twice (samples 0 and 1)
    assert int(T.tile_taps_loaded(found, 4)) == 3
    assert int(T.tile_taps_loaded(found, 5)) == 3  # one tile a sample: {1, 2}, {1}
    assert int(T.tile_taps_loaded(found, 16)) == 2  # one tile: taps 1, 2

    before = tracing.counters()
    big = torch.zeros(2, 300, 27, dtype=torch.bool)
    big[0, 0, 13] = big[1, 299, 0] = big[1, 299, 26] = True  # rows 0 and 599
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        T._count_gathers(big, 128)  # 5 tiles
        T._count_gathers(big, 256)  # 3 tiles
        T._count_gathers(big)  # no tiles
    after = tracing.counters()

    def d(name):
        return after.get(name, 0) - before.get(name, 0)

    assert d("sparse.rows_gathered") == 3 * 600 * 27
    assert d("sparse.tile_taps") == 27 * (5 + 3)
    assert d("traced.sparse.tile_taps") == 27 * (5 + 3)
    assert d("traced.sparse.tile_taps_loaded") == 3 + 3  # rows 0 and 599 in tiles apart
    assert d("traced.sparse.pairs") == 3 * 3


def test_occupied_rows_reach_each_samples_last_valid_row():
    """The kernel skips a sample's rows past ``occupied_rows``: for sorted voxels that is
    the valid count, and a mask with holes still covers its last valid row."""
    valid = torch.tensor([[1, 1, 1, 0, 0, 0], [1, 0, 1, 0, 1, 0], [0, 0, 0, 0, 0, 0],
                          [0, 0, 0, 0, 0, 1]], dtype=torch.bool)
    rows = T.occupied_rows(valid)
    assert rows.dtype == torch.int64 and rows.tolist() == [3, 5, 0, 6]
    assert rows[0] == valid[0].sum()
