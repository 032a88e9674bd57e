"""The port's geometry helpers (``tdal_torch.core.geometry``: the twelve functions of
``tdal/core/geometry.py`` it gained) and logging helpers
(``tdal_torch.runtime.logging_utils``: ``LogBuffer``, ``Timer``, ``ProgressCounter``,
``MetricsWriter``) against tdal's on the same seeded inputs.

Geometry tolerance: f32 inputs; trigonometry and matrix products of jnp and torch may
round differently, so floats are held to 2e-6 of max(1, |tdal|) elementwise (a few f32
ulps at the inputs' magnitudes, up to 40 m); masks and counts must be equal."""

import json
import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdal.core import geometry as J
from tdal.runtime import logging_utils as JL
from tdal_torch.core import geometry as T
from tdal_torch.runtime import logging_utils as TL

torch.set_num_threads(2)

TOL = 2e-6


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())))


def _inputs(seed=0, n=64, m=12):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(-40, 40, (m, 2)), rng.uniform(-1, 2, (m, 1)),
                            rng.uniform(0.5, 6, (m, 3)), rng.uniform(-4, 4, (m, 1))],
                           1).astype(np.float32)
    points = np.concatenate([rng.uniform(-40, 40, (n, 2)), rng.uniform(-2, 3, (n, 1)),
                             rng.uniform(0, 1, (n, 2))], 1).astype(np.float32)
    # points inside some boxes, so that the counts are not all 0
    inside = boxes[:4, None, :3] + rng.uniform(-0.2, 0.2, (4, 8, 3)) * boxes[:4, None, 3:6]
    points[: 32, :3] = inside.reshape(-1, 3)
    yaw = rng.uniform(-np.pi, np.pi)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
    pose[:3, 3] = rng.uniform(-20, 20, 3)
    box9 = np.concatenate([boxes[:, :6], rng.uniform(-5, 5, (m, 2)), boxes[:, 6:]],
                          1).astype(np.float32)
    return boxes, points, pose, box9


CASES = {
    "rot_mat_z": lambda b, p, pose, b9: (b[:, 6],),
    "center_to_corner_box3d": lambda b, p, pose, b9: (b[:, :3], b[:, 3:6], b[:, 6]),
    "corner_to_standup": lambda b, p, pose, b9: (
        np.array(J.center_to_corner_box3d(b[:, :3], b[:, 3:6], b[:, 6])),),
    "points_count_rbbox": lambda b, p, pose, b9: (p, b),
    "limit_period": lambda b, p, pose, b9: (b[:, 6] * 3,),
    "transform_points": lambda b, p, pose, b9: (p, pose),
    "transform_box": lambda b, p, pose, b9: (b, pose),
    "transform_box_with_velocity": lambda b, p, pose, b9: (b9, pose),
    "kitti_to_waymo_box": lambda b, p, pose, b9: (b9,),
    "waymo_to_kitti_box": lambda b, p, pose, b9: (b,),
    "mask_points_in_range_bev": lambda b, p, pose, b9: (p, [-20, -10, -1, 30, 25, 2]),
    "center_in_range": lambda b, p, pose, b9: (b, [-20, -10, 30, 25]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_matches_tdal(name):
    args = CASES[name](*_inputs())
    want = getattr(J, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                              for a in args])
    got = getattr(T, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                             for a in args])
    want, got = np.asarray(want), got.numpy()
    if want.dtype.kind in "bi":
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert 0 < want.sum() < want.size or name == "points_count_rbbox"
    else:
        _close(got, want)
    if name == "points_count_rbbox":
        assert want.sum() > 0


def test_geometry_extras():
    """limit_period's offset and period arguments, 2D corners through standup, and the
    box conventions as an involution."""
    b, _, _, b9 = _inputs(1)
    for offset, period in ((0.0, np.pi), (0.5, 2 * np.pi), (1.0, np.pi / 2)):
        _close(T.limit_period(torch.from_numpy(b[:, 6]), offset, period).numpy(),
               np.asarray(J.limit_period(jnp.asarray(b[:, 6]), offset, period)))
    c2 = J.center_to_corner_box2d(jnp.asarray(b[:, :2]), jnp.asarray(b[:, 3:5]),
                                  jnp.asarray(b[:, 6]))
    _close(T.corner_to_standup(torch.from_numpy(np.array(c2))).numpy(),
           np.asarray(J.corner_to_standup(c2)))
    twice = T.waymo_to_kitti_box(T.kitti_to_waymo_box(torch.from_numpy(b9)))
    _close(twice.numpy(), b9)


def test_log_buffer_matches_tdal():
    """The same updates (counts included) give the same windowed averages."""
    rng = np.random.default_rng(0)
    bufs = (TL.LogBuffer(), JL.LogBuffer())
    outputs = ([], [])
    for step in range(23):
        row = {"loss": float(rng.normal()), "hm_loss": float(rng.uniform())}
        count = int(rng.integers(1, 4))
        for buf, out in zip(bufs, outputs):
            buf.update(row, count)
            if (step + 1) % 5 == 0:
                buf.average(5)
                out.append(dict(buf.output))
                assert buf.ready
                buf.clear_output()
    for buf, out in zip(bufs, outputs):
        buf.average()
        out.append(dict(buf.output))
        buf.clear()
        assert not buf.ready and not buf.val_history
    assert outputs[0] == outputs[1] and len(outputs[0]) == 5


def test_timer_and_progress_counter_match_tdal(capsys):
    """Timer's running and checkpoint times and its printed seconds; the progress lines
    of the same updates (their rates and times masked)."""
    for mod in (TL, JL):
        t = mod.Timer(start=False)
        assert not t.is_running
        with t:
            assert t.is_running
            assert t.since_start() >= 0 and t.since_last_check() >= 0
        assert not t.is_running
    printed = capsys.readouterr().out.split()
    assert len(printed) == 2 and all(re.fullmatch(r"\d+\.\d{3}", p) for p in printed)
    lines = []
    for mod in (TL, JL):
        log = logging.Logger(f"progress.{mod.__name__}")
        records = []
        log.addHandler(type("H", (logging.Handler,), {
            "emit": lambda self, r: records.append(r.getMessage())})())
        pc = mod.ProgressCounter(7, logger=log, every=3, prefix="frames ")
        for _ in range(7):
            pc.update()
        lines.append([re.sub(r"\(.*\)", "(...)", m) for m in records])
    assert lines[0] == lines[1] == ["frames 3/7 (...)", "frames 6/7 (...)", "frames 7/7 (...)"]


@pytest.mark.parametrize("tensorboard", [False, True], ids=["jsonl", "tensorboard"])
def test_metrics_writer_matches_tdal(tmp_path, tensorboard):
    """The same JSON rows; with ``tensorboard=True`` (tensorboardX is installed here)
    both write an event file under ``tf_logs``."""
    rows = {}
    for side, mod in (("port", TL), ("tdal", JL)):
        w = mod.MetricsWriter(tmp_path / side, tensorboard=tensorboard)
        w.write(3, {"loss": np.float32(0.25), "acc": 1})
        w.write(4, {"iou": 0.5}, mode="val")
        w.close()
        rows[side] = [json.loads(r) for r in (tmp_path / side / "metrics.jsonl").read_text()
                      .splitlines()]
        events = list((tmp_path / side).glob("tf_logs/*"))
        assert bool(events) == tensorboard, side
    assert rows["port"] == rows["tdal"] == [
        {"mode": "train", "step": 3, "loss": 0.25, "acc": 1.0},
        {"mode": "val", "step": 4, "iou": 0.5}]
