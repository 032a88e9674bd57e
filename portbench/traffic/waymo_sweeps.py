"""Two-sweep lidar frames: each ``waymo_raycast`` frame with the sweep before it.

Waymo's top lidar turns at 10 Hz, so a frame's previous sweep is 0.1 s older
(``time_lag_s``). The ego drives along the street (the x axis) at a speed drawn per
scene from ``ego_speed_m_s``; each labelled object moves along its heading at a speed
drawn from its class's ``speed_m_s`` (vehicles and cyclists along the road,
pedestrians along their sidewalk heading); buildings, parked rows and clutter stand
still. The current sweep is ``waymo_raycast``'s frame, cast from the ego's pose at
t = 0; the previous sweep is cast from the ego's pose at t = -lag into the same scene
with every mover drawn back along its velocity by v x lag, and its points are kept in
that earlier vehicle frame. Its ``transform_matrix`` (4 x 4) takes them into the
current frame, as the Waymo infos' ``sweeps`` entries do and the port's
``read_points`` applies. Each label carries its (vx, vy) in the current frame.

The speeds are the scene's: drawn from ``numpy.random.SeedSequence([scene_seed, scene,
1])``, the same for every seed, so every run does the same work. ``--seed`` draws the
previous sweep's range noise, intensities and elongations
(``SeedSequence([seed, scene, 1])``) beside the current sweep's own.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from portbench.traffic import waymo_raycast as rc


def _stream(seed: int, scene: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, scene, 1]))


def motion(layout: dict, scene: int, p: dict) -> tuple:
    """(the ego's speed along +x in m/s, each box's (vx, vy) (M, 2)) of one scene."""
    rng = _stream(int(p["scene_seed"]), scene)
    ego = float(rng.uniform(*p["ego_speed_m_s"]))
    vel = np.zeros((len(layout["kinds"]), 2))
    for i, (box, kind) in enumerate(zip(layout["boxes"], layout["kinds"])):
        if kind < 0:  # buildings, parked rows, clutter
            continue
        speed = rng.uniform(*p["objects"][rc.CLASSES[kind]]["speed_m_s"])
        vel[i] = speed * np.cos(box[6]), speed * np.sin(box[6])
    return ego, vel


def transform(ego: float, lag: float) -> np.ndarray:
    """The 4 x 4 matrix from the vehicle frame ``lag`` seconds ago to the current one:
    the ego has since driven ``ego * lag`` metres along +x."""
    t = np.eye(4)
    t[0, 3] = -ego * lag
    return t


def make_frame(seed: int, scene: int, p: dict, device) -> dict:
    """``waymo_raycast.make_frame``'s frame with its labels' velocities, and
    ``sweep_points`` (N', 5), its previous sweep in that sweep's vehicle frame, with the
    sweep's ``transform_matrix`` and ``time_lag``."""
    frame = rc.make_frame(seed, scene, p, device)
    layout = rc.make_scene(int(p["scene_seed"]), scene, p)
    lag = float(p["time_lag_s"])
    ego, vel = motion(layout, scene, p)
    earlier = layout["boxes"].copy()
    earlier[:, :2] -= vel * lag  # where each mover was
    earlier[:, 0] += ego * lag  # in the vehicle frame of then: the ego stood ego * lag behind
    sweep, _ = rc.raycast({"boxes": earlier, "kinds": layout["kinds"]}, p, device,
                          _stream(seed, scene))
    # the labels ``make_frame`` kept (the labelled boxes that got points), in the
    # layout's order: found by their x, which it copies into float32
    labelled = np.flatnonzero(layout["kinds"] >= 0)
    kept = labelled[np.isin(layout["boxes"][labelled, 0].astype(np.float32),
                            frame["gt_boxes"][:, 0])]
    frame["gt_boxes"][:, 6:8] = vel[kept]
    frame.update(sweep_points=sweep, transform_matrix=transform(ego, lag), time_lag=lag,
                 ego_speed=ego)
    return frame


def make_pool(seed: int, p: dict, device) -> list:
    """The pool of ``p['pool_frames']`` two-sweep frames of ``seed``, its scenes in the
    seed's order (``waymo_raycast``'s)."""
    n = int(p["pool_frames"])
    return [make_frame(seed, i, p, device) for i in rc._pool_order(seed, n)]


def write_pool(frames, root) -> list:
    """Write each frame and its previous sweep as the lidar pickles the port's
    ``DetectionDataset`` reads, and return the infos, each with its ``sweeps`` entry:
    the sweep's ``path``, ``transform_matrix`` and ``time_lag``."""
    root = Path(root)
    infos = rc.write_pool(frames, root)
    for fr, info in zip(frames, infos):
        path = root / f"sweep_{fr['token']}"
        pts = fr["sweep_points"]
        with open(path, "wb") as f:
            pickle.dump({"lidars": {"points_xyz": pts[:, :3].copy(),
                                    "points_feature": pts[:, 3:].copy()}}, f, protocol=4)
        info["sweeps"] = [{"path": str(path), "transform_matrix": fr["transform_matrix"],
                           "time_lag": fr["time_lag"]}]
    return infos
