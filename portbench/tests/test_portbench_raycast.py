"""The ray-cast traffic: the same frames from the same seed, no more points than the
top lidar's rays, a point in every labelled box, occupied pillars and voxels of every
level below the two configurations' caps, and the scenes' occupancy against a published
count of a real lidar's."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.counts import work
from portbench.traffic import waymo_raycast as rc

HERE = Path(__file__).resolve().parents[1]
P = json.loads((HERE / "traffic" / "raycast_train.json").read_text())
SEED = 2**31 + 977


@pytest.fixture(scope="module")
def frames():
    return [rc.make_frame(SEED, s, P, "cpu") for s in (0, 5)]


def test_same_seed_same_frames(frames):
    again = rc.make_frame(SEED, 0, P, "cpu")
    assert np.array_equal(again["points"], frames[0]["points"])
    assert np.array_equal(again["gt_boxes"], frames[0]["gt_boxes"])
    other = rc.make_frame(SEED + 1, 0, P, "cpu")
    assert not np.array_equal(other["points"], frames[0]["points"])
    assert rc._pool_order(SEED, 32) == rc._pool_order(SEED, 32)
    assert sorted(rc._pool_order(SEED, 32)) == list(range(32))


def test_points_within_the_rays(frames):
    for f in frames:
        assert f["points"].shape[1] == 5
        assert 0.5 * P["beams"] * P["azimuth_steps"] < len(f["points"]) <= (
            P["beams"] * P["azimuth_steps"])
        r = np.linalg.norm(f["points"][:, :3] - [0, 0, P["mount_height_m"]], axis=1)
        assert r.max() < P["max_range_m"] + 0.2


def test_every_label_has_points(frames):
    for f in frames:
        assert len(f["gt_boxes"]) > 10
        assert (f["num_points"] > 0).all()
        # the points inside each labelled box (det3d convention: w, l, rot = -pi/2 - yaw)
        pts = f["points"]
        for box in f["gt_boxes"]:
            yaw = -np.pi / 2 - box[8]
            d = pts[:, :2] - box[:2]
            lx = np.cos(yaw) * d[:, 0] + np.sin(yaw) * d[:, 1]
            ly = -np.sin(yaw) * d[:, 0] + np.cos(yaw) * d[:, 1]
            inside = ((np.abs(lx) <= box[4] / 2 + 0.05) & (np.abs(ly) <= box[3] / 2 + 0.05)
                      & (np.abs(pts[:, 2] - box[2]) <= box[5] / 2 + 0.05))
            assert inside.any()


@pytest.mark.parametrize("config", ["waymo_pp_3x", "waymo_voxelnet_3x"])
def test_occupancy_below_the_caps(frames, config):
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())["config"]
    vg = cfg["voxel_generator"]
    for f in frames:
        if config == "waymo_pp_3x":
            pc, vs = np.asarray(vg["range"]), np.asarray(vg["voxel_size"])
            pillars = np.unique(np.floor((f["points"][:, :2] - pc[:2]) / vs[:2]).astype(int), axis=0)
            assert len(pillars) < min(vg["max_voxel_num"])
        else:
            v = min(vg["max_voxel_num"][1], cfg["data"]["val"]["max_points"])
            caps = (v, v // 2, v // 4, v // 8, v // 8)
            levels = work.sparse_levels(f["points"], cfg, torch.device("cpu"))
            for (_, coords, _), cap in zip(levels, caps):
                assert 0 < len(coords) < cap


# KITTI's Velodyne HDL-64E as modelled here: 64 beams in two blocks of 32 (+2 to -8.33
# and -8.83 to -24.33 degrees), about 2080 azimuth steps a turn (about 130k points a scan
# at 10 Hz), 1.73 m up, 120 m of range (Geiger et al., IJRR 2013: 64 beams, 10 Hz, 1.73 m
# up, 120 m)
HDL64 = dict(beam_inclinations_deg=np.concatenate([np.linspace(2.0, -8.33, 32),
                                                   np.linspace(-8.83, -24.33, 32)]).tolist(),
             beams=64, azimuth_steps=2083, max_range_m=120.0, mount_height_m=1.73)


def kitti_pillars(points: np.ndarray, height: float) -> int:
    """Non-empty 0.16 m pillars in the range PointPillars uses on KITTI (x 0-69.12 m,
    y within 39.68 m, z -3 to 1 m of the sensor) and the camera's 81 degrees of view."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2] - height
    keep = ((x >= 0) & (x < 69.12) & (np.abs(y) < 39.68) & (z > -3) & (z < 1)
            & (np.abs(np.degrees(np.arctan2(y, x))) < 40.7))
    ij = np.floor(np.stack([x[keep], y[keep] + 39.68], 1) / 0.16).astype(np.int64)
    return len(np.unique(ij[:, 0] * 1000 + ij[:, 1]))


def test_scenes_occupy_as_a_real_lidar_does():
    """The scenes seen by KITTI's lidar: the median of their non-empty pillars lies in
    the 6k-9k that PointPillars (Lang et al., CVPR 2019, section 2.1) gives for an
    HDL-64E's frames at 0.16 m in KITTI's range. The sensor's geometry is KITTI's, the
    scenes (streets, parked rows, clutter, road users) the traffic's own."""
    p = dict(P, **HDL64)
    counts = []
    for s in range(8):
        layout = rc.make_scene(int(P["scene_seed"]), s, P)
        points, _ = rc.raycast(layout, p, "cpu", rc._rng(SEED, s))
        counts.append(kitti_pillars(points, HDL64["mount_height_m"]))
    assert 6000 <= np.median(counts) <= 9000, counts
