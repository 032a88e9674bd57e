"""The two-sweep traffic: the previous sweep's ``transform_matrix`` takes its points into
the current frame, where buildings, parked rows and clutter line up with the current
layout and each mover lies drawn back by its velocity x the lag; the labels carry the
velocities; the same seed gives the same sweeps."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench.traffic import waymo_raycast as rc
from portbench.traffic import waymo_sweeps as ws

HERE = Path(__file__).resolve().parents[1]
SEED = 2**31 + 1701
MARGIN = 0.15  # metres: the range noise (2 cm) along grazing rays, and the box faces


def _params():
    p = json.loads((HERE / "traffic" / "raycast_sweeps_detect.json").read_text())
    p.update(beams=32, azimuth_steps=720, max_range_m=40.0, max_object_range_m=35.0,
             clutter_count=[5, 15])
    return p


def _inside(points, box, margin):
    """Which of the points (N, 3) lie in ``box`` [x, y, z, l, w, h, heading] grown by
    ``margin``."""
    c, s = np.cos(box[6]), np.sin(box[6])
    d = points - box[:3]
    local = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1], d[:, 2]], 1)
    return (np.abs(local) <= np.asarray(box[3:6]) / 2 + margin).all(1)


@pytest.fixture(scope="module")
def scene():
    """The fastest ego's scene of the first eight: (params, scene, frame, layout, ego,
    velocities)."""
    p = _params()
    speeds = [ws.motion(rc.make_scene(p["scene_seed"], i, p), i, p)[0] for i in range(8)]
    i = int(np.argmax(speeds))
    layout = rc.make_scene(p["scene_seed"], i, p)
    ego, vel = ws.motion(layout, i, p)
    return p, i, ws.make_frame(SEED, i, p, "cpu"), layout, ego, vel


def _moved(frame, tm):
    return frame["sweep_points"][:, :3].astype(np.float64) @ tm[:3, :3].T + tm[:3, 3]


def _explained(points, layout, vel, lag):
    """The share of points on the ground or on a box where it stood ``lag`` seconds
    before the current frame."""
    ok = np.abs(points[:, 2]) < MARGIN
    for box, v in zip(layout["boxes"], vel):
        earlier = box.copy()
        earlier[:2] -= v * lag
        ok |= _inside(points, earlier, MARGIN)
    return ok.mean()


def test_the_transform_takes_the_previous_sweep_into_the_current_frame(scene):
    p, _, frame, layout, ego, vel = scene
    lag = frame["time_lag"]
    assert lag == pytest.approx(0.1) and ego * lag > 0.5
    tm = frame["transform_matrix"]
    assert tm.shape == (4, 4) and tm[0, 3] == pytest.approx(-ego * lag)
    right = _explained(_moved(frame, tm), layout, vel, lag)
    assert right > 0.999
    # left in its own vehicle frame, the previous sweep does not line up
    assert _explained(_moved(frame, np.eye(4)), layout, vel, lag) < right - 0.005


def test_movers_are_drawn_back_and_static_boxes_line_up(scene):
    p, _, frame, layout, _, vel = scene
    lag = frame["time_lag"]
    pts = _moved(frame, frame["transform_matrix"])
    static = layout["kinds"] < 0
    assert (vel[static] == 0).all()
    on_static = sum(_inside(pts, b, MARGIN).sum() for b in layout["boxes"][static])
    assert on_static > 1000  # the buildings and parked rows, where they stand now
    cur = frame["points"][:, :3].astype(np.float64)
    movers = 0
    for box, v, kind in zip(layout["boxes"], vel, layout["kinds"]):
        speed = np.hypot(*v)
        if kind < 0:
            continue
        lo, hi = p["objects"][rc.CLASSES[kind]]["speed_m_s"]
        assert lo <= speed <= hi
        if speed * lag < 0.5:
            continue
        assert np.isclose(np.arctan2(v[1], v[0]), np.arctan2(np.sin(box[6]), np.cos(box[6])))
        earlier = box.copy()
        earlier[:2] -= v * lag
        # the object's points in both sweeps (off the ground): the earlier ones sit
        # drawn back along its velocity by speed x lag
        then = pts[(_inside(pts, earlier, 0.05) | _inside(pts, box, 0.05)) & (pts[:, 2] > MARGIN)]
        now = cur[(_inside(cur, earlier, 0.05) | _inside(cur, box, 0.05)) & (cur[:, 2] > MARGIN)]
        if len(then) >= 20 and len(now) >= 20:
            along = (then[:, :2].mean(0) - now[:, :2].mean(0)) @ (v / speed)
            assert abs(along + speed * lag) < 0.5 * speed * lag, (along, speed * lag)
            movers += 1
    assert movers >= 1


def test_labels_carry_the_velocities_and_a_seed_repeats(scene):
    p, i, frame, layout, _, vel = scene
    gt = frame["gt_boxes"]
    labelled = np.flatnonzero(layout["kinds"] >= 0)
    for row in gt:  # each label's (vx, vy) is its box's
        j = labelled[np.argmin(np.abs(layout["boxes"][labelled, 0] - row[0]))]
        np.testing.assert_allclose(row[6:8], vel[j], rtol=1e-6, atol=1e-6)
    again = ws.make_frame(SEED, i, p, "cpu")
    assert np.array_equal(again["sweep_points"], frame["sweep_points"])
    assert np.array_equal(again["points"], frame["points"])
    other = ws.make_frame(SEED + 1, i, p, "cpu")
    assert not np.array_equal(other["sweep_points"], frame["sweep_points"])
