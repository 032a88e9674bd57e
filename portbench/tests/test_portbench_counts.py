"""The benchmark's counts against shapes worked out by hand."""

import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from portbench.counts import work

HERE = Path(__file__).resolve().parents[1]


def cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["config"]


def test_pointpillars_forward_flops():
    px = 468 * 468
    conv = lambda h, w, c, o, k=3: 2.0 * h * w * k * k * c * o  # noqa: E731
    rpn = (4 * conv(468, 468, 64, 64) + conv(234, 234, 64, 128) + 5 * conv(234, 234, 128, 128)
           + conv(117, 117, 128, 256) + 5 * conv(117, 117, 256, 256)
           + 2.0 * px * 64 * 128 + 2.0 * 234 * 234 * 128 * 128 * 4 + 2.0 * 117 * 117 * 256 * 128 * 16)
    head = conv(468, 468, 384, 64) + 5 * conv(468, 468, 64, 64) + conv(468, 468, 64, 11)
    assert work.dense_flops(cfg("waymo_pp_3x")) == pytest.approx(rpn + head, rel=1e-12)
    # about 445 GFLOP a frame, as the issue worked out
    assert 440e9 < work.dense_flops(cfg("waymo_pp_3x")) < 450e9
    assert work.pfn_flops(1000, cfg("waymo_pp_3x")) == 2.0 * 1000 * (10 * 32 + 64 * 64)


def test_voxelnet_bev_and_flops():
    c = cfg("waymo_voxelnet_3x")
    assert work.bev_input(c) == (188, 188, 3 * 128)
    conv = lambda h, w, ci, o, k=3: 2.0 * h * w * k * k * ci * o  # noqa: E731
    rpn = (conv(188, 188, 384, 128) + 5 * conv(188, 188, 128, 128) + conv(94, 94, 128, 256)
           + 5 * conv(94, 94, 256, 256) + 2.0 * 188 * 188 * 128 * 256
           + 2.0 * 94 * 94 * 256 * 256 * 4)
    head = conv(188, 188, 512, 64) + 5 * conv(188, 188, 64, 64) + conv(188, 188, 64, 11)
    assert work.dense_flops(c) == pytest.approx(rpn + head, rel=1e-12)


def test_conv3x3_launches_per_step():
    sites = work.conv3x3_sites(cfg("waymo_pp_3x"), 4)
    assert len(sites) == 16
    kinds = Counter(k for k, _, _ in work.conv3x3_launches(sites))
    assert kinds == {"conv3x3_fwd_stats": 16, "conv3x3_wgrad": 16, "conv3x3_dgrad_act": 12,
                     "conv3x3_fwd": 4}
    name, b, h, w, c, co, bias, chained = sites[-1]
    assert (b, h, w, c, co, bias, chained) == (4, 468, 468, 64, 320, True, True)
    flops, nbytes = work.conv3x3_launches(sites[:1])[0][1:]
    assert flops == 2.0 * 4 * 468 * 468 * 9 * 64 * 64
    assert nbytes == 4 * (4 * 468 * 468 * 128 + 64 + 128) + 9 * 64 * 64 * 4
    t, bound = work.least_seconds(flops, nbytes)
    assert bound == "memory" and t == pytest.approx(nbytes / 3.35e12)


def test_sparse_pairs_by_hand():
    """Three voxels (z, y, x): two side by side in x and one alone."""
    c = cfg("waymo_voxelnet_3x")
    vg = c["voxel_generator"]
    zyx = torch.tensor([[4, 4, 4], [4, 4, 5], [10, 10, 10]], dtype=torch.float64)
    lo = torch.tensor(vg["range"][:3], dtype=torch.float64)
    vs = torch.tensor(vg["voxel_size"], dtype=torch.float64)
    points = ((zyx.flip(-1) + 0.5) * vs + lo).numpy()
    levels = work.sparse_levels(points, c)
    assert [len(coords) for _, coords, _ in levels[:2]] == [3, 3]
    # stride 2: (4,4,4) -> (2,2,2); (4,4,5) -> (2,2,2) and (2,2,3); (10,10,10) -> (5,5,5)
    assert sorted(levels[1][1].tolist()) == [[2, 2, 2], [2, 2, 3], [5, 5, 5]]
    convs = {name: (pairs, flops) for name, pairs, flops, _ in work.sparse_convs(levels)}
    # submanifold: each voxel with itself, and the pair with each other
    assert convs["subm in"] == (5, 2.0 * 5 * 5 * 16)
    # input = 2 o + tap: (2,2,2) <- (4,4,4), (4,4,5); (2,2,3) <- (4,4,5); (5,5,5) <- (10,10,10)
    assert convs["down level 1"] == (4, 2.0 * 4 * 16 * 32)
