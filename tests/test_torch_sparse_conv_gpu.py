"""The sparse conv's gather-GEMM kernel (``tdal_torch/ops/csrc/sparse_conv.cu``) against
its plain twin, the per-tap path (``sparse_conv._pertap``), on the card: at every width
pair of the VoxelNet backbone's convs and their dgrads, 27 and 3 taps, f32 and bf16
operands, on tables whose tiles straddle two samples, with rows past a sample's occupied
count and taps that no row finds; the dgrad through autograd against the twin's on the
CPU; a valid mask with holes; two calls bit-equal; the tile rows the counters take; and
the shapes it refuses, which raise instead of falling back.

This file imports no jax, so it also runs where only PyTorch is installed:
``python -m pytest --noconftest -q tests/test_torch_sparse_conv_gpu.py``. Without a card
every case skips.

Tolerances, relative to max(1, max |twin|):
- f32: 1e-5; the kernel sums the same f32 products as the twin's cuBLAS GEMMs (TF32
  off) in another order.
- bf16 operands: each element within one bf16 step of the twin's (2^-7 of its size) and
  1e-5: both sum exact products in f32 and round once, and a summation-order difference
  can move a sum across a bf16 rounding boundary.
"""

import numpy as np
import pytest
import torch

from tdal_torch.ops import sparse_conv as sc
from tdal_torch.runtime import tracing

torch.set_num_threads(2)

TOL = 1e-5
# (Cin, Cout): the backbone's convs (the input conv takes 5 or 6 channels) and the
# dgrads of its strided convs
PAIRS = [(5, 16), (6, 16), (16, 16), (16, 32), (32, 16), (32, 32), (32, 64), (64, 32),
         (64, 64), (64, 128), (128, 64), (128, 128)]
BF16_PAIRS = [(6, 16), (16, 32), (64, 64), (128, 128)]
# 3 samples of 300 rows: the 128- and 256-row tiles straddle samples; sample 2 has no
# occupied row, sample 1 fewer than a tile
ROWS, COUNTS = 300, (300, 171, 0)
NEVER = (0, 1)  # taps that no row finds


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def table_case(cin, cout, taps, dtype, device, seed=0, n_in=500, p_found=0.3):
    """(x (n_in, cin), table (taps, 3 * ROWS), w (taps, cin, cout), counts (3,)): each
    live row finds each tap but ``NEVER`` with probability ``p_found``, and its middle
    tap always, at a random input row; rows past COUNTS find nothing (entry n_in)."""
    rng = np.random.default_rng(seed)
    n_out = len(COUNTS) * ROWS
    live = np.concatenate([np.arange(ROWS) < c for c in COUNTS])
    found = (rng.random((taps, n_out)) < p_found) & live[None]
    found[taps // 2] = live
    found[[t for t in NEVER if t < taps and t != taps // 2]] = False
    table = np.where(found, rng.integers(0, n_in, (taps, n_out)), n_in)
    x = torch.from_numpy(rng.normal(size=(n_in, cin)).astype(np.float32))
    w = rng.normal(size=(taps, cin, cout)) / np.sqrt(taps * cin * p_found)
    return (x.to(device, dtype), torch.from_numpy(table).to(device),
            torch.from_numpy(w.astype(np.float32)).to(device),
            torch.tensor(COUNTS, device=device))


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(1.0, float(want.abs().max()))


def assert_bf16_close(got, want):
    got, want = got.float(), want.float()
    slack = 2.0**-7 * want.abs() + TOL * max(1.0, float(want.abs().max()))
    assert bool(((got - want).abs() <= slack).all()), rel_err(got, want)


def launches():
    return tracing.counters().get("sparse_conv.launches", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("taps", [27, 3])
@pytest.mark.parametrize("cin,cout", PAIRS)
def test_kernel_matches_twin_f32(cuda, cin, cout, taps):
    x, table, w, counts = table_case(cin, cout, taps, torch.float32, cuda, seed=cin + cout)
    n = launches()
    got = sc.gather_gemm(x, table, w, counts)
    want = sc._pertap(x, table, w)
    torch.cuda.synchronize()
    assert launches() == n + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= TOL, rel_err(got, want)
    dead = torch.cat([torch.arange(ROWS, device=cuda) >= c for c in COUNTS])
    assert not bool(got[dead].any())  # rows past the occupied count: exact zeros


@pytest.mark.gpu
@pytest.mark.parametrize("taps", [27, 3])
@pytest.mark.parametrize("cin,cout", BF16_PAIRS)
def test_kernel_matches_twin_bf16(cuda, cin, cout, taps):
    x, table, w, counts = table_case(cin, cout, taps, torch.bfloat16, cuda, seed=7 * cin)
    got = sc.gather_gemm(x, table, w, counts)
    want = sc._pertap(x, table, w)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want)


@pytest.mark.gpu
def test_f64_features_take_the_twins_f32_products(cuda):
    """Features of another float type than f32 and bf16 are read as f32, as the twin
    reads them, and the output keeps their type."""
    x, table, w, counts = table_case(16, 32, 27, torch.float64, cuda, seed=5)
    got = sc.gather_gemm(x, table, w, counts)
    want = sc._pertap(x, table, w)
    assert got.dtype == torch.float64
    assert rel_err(got, want) <= TOL, rel_err(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_are_bit_equal(cuda, dtype):
    x, table, w, counts = table_case(64, 128, 27, dtype, cuda, seed=3)
    a = sc.gather_gemm(x, table, w, counts)
    b = sc.gather_gemm(x, table, w, counts)
    assert torch.equal(a, b)


def _voxels(grid, n_active, v, c, device, seed):
    """Sorted (coords, feats, valid, keys) of random distinct voxels, B = len(n_active)."""
    rng = np.random.default_rng(seed)
    b = len(n_active)
    coords = np.zeros((b, v, 3), np.int32)
    valid = np.zeros((b, v), bool)
    n_cells = int(np.prod(grid))
    for i, n in enumerate(n_active):
        lin = rng.choice(n_cells, n, replace=False)
        coords[i, :n] = np.stack([lin // (grid[1] * grid[2]), (lin // grid[2]) % grid[1],
                                  lin % grid[2]], 1)
        valid[i, :n] = True
    feats = (rng.normal(size=(b, v, c)) * valid[..., None]).astype(np.float32)
    return sc.sort_voxels(*(torch.from_numpy(a).to(device) for a in (coords, feats, valid)),
                          grid)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["subm", "down2", "downz"])
def test_forward_and_dgrad_through_autograd_match_the_twin(cuda, which):
    """A conv on the card (the kernel, forward and d feats) against the same conv on the
    CPU (the twin), on dense-ish random voxels: outputs, d feats and d W."""
    grid, cin, cout = (6, 20, 20), 32, 64
    taps = 3 if which == "downz" else 27
    coords, feats, valid, keys = _voxels(grid, (900, 517), 1100, cin, cuda, seed=11)
    rng = np.random.default_rng(12)
    w = torch.from_numpy((rng.normal(size=(taps, cin, cout)) / np.sqrt(taps * cin))
                         .astype(np.float32))
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        f = feats.to(dev).clone().requires_grad_()
        wd = w.to(dev).clone().requires_grad_()
        args = (coords.to(dev), f, valid.to(dev), keys.to(dev), grid, wd)
        if which == "subm":
            y = sc.subm_conv3d(*args)
        elif which == "down2":
            y = sc.sparse_conv3d_down2(*args, 700)[1]
        else:
            y = sc.sparse_conv3d_downz(*args, 1100)[1]
        g = torch.from_numpy(np.random.default_rng(13).normal(size=tuple(y.shape))
                             .astype(np.float32)).to(dev)
        n = launches()
        y.backward(g)
        if dev.type == "cuda":
            assert launches() == n + 1  # the dgrad is the kernel
        outs[dev.type] = (y.detach().cpu(), f.grad.cpu(), wd.grad.cpu())
    for name, got, want in zip(("forward", "d feats", "d W"), outs["cuda"], outs["cpu"]):
        assert rel_err(got, want) <= TOL, (name, rel_err(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["subm", "down2"])
def test_a_valid_mask_with_holes_matches_the_twin(cuda, which):
    """Valid rows need not come first: with holes punched into each sample's valid rows,
    the rows past the last hole still match the CPU twin (the kernel skips only the rows
    past each sample's last valid one), forward and d feats."""
    grid, cin, cout = (6, 20, 20), 16, 32
    coords, feats, valid, keys = _voxels(grid, (600, 350), 700, cin, cuda, seed=21)
    holed = valid.clone()
    holed[0, 100:400:3] = False
    holed[1, :200] = False
    assert bool((sc.occupied_rows(holed) > holed.sum(1)).all())
    rng = np.random.default_rng(22)
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin))
                         .astype(np.float32))
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        f = feats.to(dev).clone().requires_grad_()
        args = (coords.to(dev), f, holed.to(dev), keys.to(dev), grid, w.to(dev))
        y = sc.subm_conv3d(*args) if which == "subm" else sc.sparse_conv3d_down2(*args, 500)[1]
        y.backward(torch.ones_like(y))
        outs[dev.type] = (y.detach().cpu(), f.grad.cpu())
    late = holed.cpu() & (torch.arange(holed.shape[1])[None] >= holed.sum(1).cpu()[:, None])
    assert bool(outs["cpu"][1][late].any())  # rows that a valid count would skip
    for name, got, want in zip(("forward", "d feats"), outs["cuda"], outs["cpu"]):
        assert rel_err(got, want) <= TOL, (name, rel_err(got, want))


@pytest.mark.gpu
def test_tile_rows_are_the_kernels(cuda):
    """The counters' tile rows come from the kernel's own tiles: 256 rows up to 16
    output channels, 128 up to 128, none past."""
    assert sc.tile_rows(8) == sc.tile_rows(16) == 256
    assert {sc.tile_rows(c) for c in (24, 32, 64, 128)} == {128}
    assert sc.tile_rows(136) == -1


@pytest.mark.gpu
def test_the_dgrad_is_skipped_where_feats_need_none(cuda):
    """The input conv's features need no gradient, and its dgrad (16 -> 5 channels) is
    no shape the kernel takes: it is not computed."""
    coords, feats, valid, keys = _voxels((6, 20, 20), (300,), 400, 5, cuda, seed=14)
    w = torch.randn(27, 5, 16, device=cuda, requires_grad=True)
    y = sc.subm_conv3d(coords, feats, valid, keys, (6, 20, 20), w)
    n = launches()
    y.sum().backward()
    assert launches() == n and w.grad is not None


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,taps", [(16, 12, 27), (16, 136, 27), (18, 16, 27),
                                           (16, 16, 28)])
def test_shapes_the_kernel_does_not_take_raise(cuda, cin, cout, taps):
    """Cout not a multiple of 8 or past 128, Cin past 8 that does not fill 16-byte
    copies, more than 27 taps: raised, never handed to the twin."""
    x, table, w, counts = table_case(cin, cout, taps, torch.float32, cuda)
    with pytest.raises(ValueError):
        sc.gather_gemm(x, table, w, counts)
