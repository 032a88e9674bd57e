"""Lidar-like frames: a ray-cast of the Waymo Open Dataset's top lidar over a street scene.

The top lidar of the Waymo Open Dataset returns a 64 x 2650 range image (64 beams,
-17.6 to +2.4 degrees of inclination, 2650 azimuth steps, 75 m of range; Sun et al.,
"Scalability in Perception for Autonomous Driving: Waymo Open Dataset", CVPR 2020).
Each frame here casts those rays from a sensor ``mount_height`` above a ground plane
at z = 0 (the vehicle frame's ground) into a scene of:

- static boxes, unlabelled: building fronts along both sides of the street, rows of
  parked cars against them, and clutter (trees, poles, bushes) beside the road;
- labelled vehicles, pedestrians and cyclists at Waymo's class sizes.

Each ray keeps its first hit within range, with a little range noise. A point carries
5 features: x, y, z, a raw intensity (by surface kind) and an elongation. A label is
kept only where its box got a point (Waymo labels no object without points; the
port's infos are ``filter_zero_gt``). Labels are in the detector's (det3d) convention:
[x, y, z, w, l, h, vx, vy, rot] with rot = -pi/2 - heading.

Every number that shapes a scene comes from the traffic's parameters
(``portbench/traffic/<name>.json``). The pool's scenes are the same for every seed:
their layouts come from the traffic's ``scene_seed``, so every run does the same amount
of work. ``--seed`` draws the rest: the order of the scenes in the pool, and each
frame's range noise, intensities and elongations (``numpy.random.SeedSequence([seed,
scene])``), so a seed gives the same frames. The ray-cast runs in torch on the given
device, in float32.
"""

from __future__ import annotations

import math
import pickle
from pathlib import Path

import numpy as np
import torch

CLASSES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")
_KIND_WALL, _KIND_PARKED, _KIND_CLUTTER, _KIND_GROUND = -1, -2, -3, -4


def _rng(seed: int, frame: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, frame]))


def _pool_order(seed: int, n: int) -> list:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64])).permutation(n).tolist()


def _overlaps(x, y, r, placed) -> bool:
    return any((x - px) ** 2 + (y - py) ** 2 < (r + pr) ** 2 for px, py, pr in placed)


def make_scene(scene_seed: int, scene: int, p: dict) -> dict:
    """One scene's boxes: (M, 7) [x, y, z, l, w, h, heading] float64 with z the
    volumetric center, and their kinds (M,): a class index for a labelled object,
    negative for static boxes."""
    rng = _rng(scene_seed, scene)
    boxes, kinds, placed = [], [], []
    street = rng.uniform(*p["street_half_width_m"])
    for side in (-1.0, 1.0):  # building fronts along x, with gaps between them
        x = -p["max_range_m"]
        while x < p["max_range_m"]:
            length = rng.uniform(*p["building_length_m"])
            depth = rng.uniform(*p["building_depth_m"])
            height = rng.uniform(*p["building_height_m"])
            y = side * (street + rng.uniform(0.0, p["building_setback_m"]) + depth / 2)
            boxes.append([x + length / 2, y, height / 2, length, depth, height, 0.0])
            kinds.append(_KIND_WALL)
            x += length + rng.uniform(*p["building_gap_m"])
    for side in (-1.0, 1.0):  # parked rows: cars nose to tail along the kerb
        x = -p["max_range_m"]
        while x < p["max_range_m"]:
            if rng.random() < p["parked_density"]:
                length, width, height = (rng.normal(m, s) for m, s in p["parked_size_m"])
                y = side * (street - width / 2 - 0.2)
                boxes.append([x + length / 2, y, height / 2, length, width, height,
                              rng.normal(0.0, 0.03)])
                kinds.append(_KIND_PARKED)
                placed.append((x + length / 2, y, length / 2))
            x += rng.uniform(*p["parked_pitch_m"])
    for _ in range(int(rng.integers(p["clutter_count"][0], p["clutter_count"][1] + 1))):
        # trees, poles, bushes and signs beside the road
        x, y = rng.uniform(-p["max_range_m"], p["max_range_m"], 2)
        if abs(y) < street:
            continue
        size = rng.uniform(*p["clutter_size_m"], 3)
        boxes.append([x, y, size[2] / 2, size[0], size[1], size[2], rng.uniform(-math.pi, math.pi)])
        kinds.append(_KIND_CLUTTER)
    for cls, name in enumerate(CLASSES):
        spec = p["objects"][name]
        n = int(rng.integers(spec["count"][0], spec["count"][1] + 1))
        tries = 0
        while n > 0 and tries < 50 * spec["count"][1] + 50:
            tries += 1
            length, width, height = (max(rng.normal(m, s), 0.3) for m, s in spec["size_m"])
            # uniform along the street: on its lanes or on a sidewalk, within range
            x = rng.uniform(-p["max_object_range_m"], p["max_object_range_m"])
            if spec["where"] == "road":
                y = rng.uniform(-(street - 2.5), street - 2.5)
            else:
                y = rng.choice((-1.0, 1.0)) * (street + rng.uniform(0.0, 3.0))
            if not p["min_object_range_m"] <= math.hypot(x, y) <= p["max_object_range_m"]:
                continue
            heading = rng.uniform(-math.pi, math.pi)
            if spec["where"] == "road":
                heading = (0.0 if rng.random() < 0.5 else math.pi) + rng.normal(0.0, 0.15)
            radius = math.hypot(length, width) / 2
            if _overlaps(x, y, radius, placed):
                continue
            placed.append((x, y, radius))
            boxes.append([x, y, height / 2, length, width, height, heading])
            kinds.append(cls)
            n -= 1
    return {"boxes": np.asarray(boxes, np.float64).reshape(-1, 7),
            "kinds": np.asarray(kinds, np.int64)}


def ray_directions(p: dict, device) -> torch.Tensor:
    """(beams * azimuth_steps, 3) unit directions, beam-major: the beams spread evenly
    over ``inclination_deg``, or at the angles ``beam_inclinations_deg`` lists."""
    if "beam_inclinations_deg" in p:
        incl = torch.tensor(np.radians(p["beam_inclinations_deg"]), dtype=torch.float64)
    else:
        incl = torch.linspace(math.radians(p["inclination_deg"][0]),
                              math.radians(p["inclination_deg"][1]), p["beams"],
                              dtype=torch.float64)
    az = torch.arange(p["azimuth_steps"], dtype=torch.float64) * (
        2 * math.pi / p["azimuth_steps"]) - math.pi
    ci, si = torch.cos(incl)[:, None], torch.sin(incl)[:, None]
    d = torch.stack([ci * torch.cos(az)[None], ci * torch.sin(az)[None],
                     si.expand(-1, len(az))], dim=-1)
    return d.reshape(-1, 3).to(device=device, dtype=torch.float32)


def raycast(scene: dict, p: dict, device, rng: np.random.Generator) -> tuple:
    """The first hit of each ray, its range noise and features drawn from ``rng``:
    (points (N, 5) float32, per-box hit counts (M,))."""
    dirs = ray_directions(p, device)
    h = float(p["mount_height_m"])
    boxes = torch.as_tensor(scene["boxes"], dtype=torch.float32, device=device)
    big = torch.tensor(float("inf"), device=device)
    t_best = torch.where(dirs[:, 2] < 0, h / -dirs[:, 2].clamp(max=-1e-9), big)
    hit = torch.full((len(dirs),), -1, dtype=torch.long, device=device)
    origin = torch.tensor([0.0, 0.0, h], device=device)
    for i0 in range(0, len(boxes), 32):  # slab test in each box's frame
        b = boxes[i0 : i0 + 32]
        c, s = torch.cos(b[:, 6]), torch.sin(b[:, 6])
        o = origin[None] - b[:, :3]  # (K, 3)
        o_loc = torch.stack([c * o[:, 0] + s * o[:, 1], -s * o[:, 0] + c * o[:, 1], o[:, 2]], -1)
        d_loc = torch.stack([c[None] * dirs[:, None, 0] + s[None] * dirs[:, None, 1],
                             -s[None] * dirs[:, None, 0] + c[None] * dirs[:, None, 1],
                             dirs[:, None, 2].expand(-1, len(b))], -1)  # (R, K, 3)
        half = b[:, 3:6] / 2
        inv = 1.0 / torch.where(d_loc.abs() < 1e-12, torch.full_like(d_loc, 1e-12), d_loc)
        t1, t2 = (-half - o_loc) * inv, (half - o_loc) * inv
        t_near = torch.minimum(t1, t2).amax(-1)
        t_far = torch.maximum(t1, t2).amin(-1)
        t = torch.where((t_near <= t_far) & (t_near > 0), t_near, big)
        t_min, k = t.min(dim=1)
        closer = t_min < t_best
        t_best = torch.where(closer, t_min, t_best)
        hit = torch.where(closer, k + i0, hit)
    noise = torch.as_tensor(rng.normal(0.0, p["range_noise_m"], len(dirs)),
                            dtype=torch.float32, device=device)
    keep = t_best < p["max_range_m"]
    t = (t_best + noise)[keep]
    hit = hit[keep]
    xyz = origin[None] + t[:, None] * dirs[keep]
    kinds = torch.as_tensor(scene["kinds"], device=device)
    kind = torch.where(hit >= 0, kinds[hit.clamp(min=0)], _KIND_GROUND)
    # raw intensity by surface (the loader takes its tanh), elongation small
    base = torch.tensor(p["intensity_by_kind"], dtype=torch.float32, device=device)
    n = int(keep.sum())
    u = torch.as_tensor(rng.random((n, 2)), dtype=torch.float32, device=device)
    intensity = base[kind - _KIND_GROUND] * (0.5 + u[:, 0])
    elongation = 0.1 * u[:, 1]
    points = torch.cat([xyz, intensity[:, None], elongation[:, None]], 1)
    counts = torch.bincount(hit[hit >= 0], minlength=len(boxes))
    return points.cpu().numpy(), counts.cpu().numpy()


def make_frame(seed: int, scene: int, p: dict, device) -> dict:
    """One frame of the scene ``scene``: its points (N, 5), its labels (the boxes of
    labelled objects that got points) and their point counts."""
    layout = make_scene(int(p["scene_seed"]), scene, p)
    points, counts = raycast(layout, p, device, _rng(seed, scene))
    lab = (layout["kinds"] >= 0) & (counts > 0)
    b = layout["boxes"][lab]
    gt = np.zeros((len(b), 9), np.float32)
    gt[:, :3] = b[:, :3]
    gt[:, 3], gt[:, 4], gt[:, 5] = b[:, 4], b[:, 3], b[:, 5]  # w, l, h
    gt[:, 8] = -np.pi / 2 - b[:, 6]
    return {"points": points, "gt_boxes": gt, "scene": scene,
            "gt_names": np.asarray([CLASSES[k] for k in layout["kinds"][lab]]),
            "num_points": counts[lab], "token": f"portbench_{scene:04d}.pkl"}


def write_pool(frames, root) -> list:
    """Write each frame as the lidar pickle the port's ``DetectionDataset`` reads (raw
    intensity and elongation as ``points_feature``) and return the infos."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    infos = []
    for fr in frames:
        path = root / fr["token"]
        pts = fr["points"]
        with open(path, "wb") as f:
            pickle.dump({"lidars": {"points_xyz": pts[:, :3].copy(),
                                    "points_feature": pts[:, 3:].copy()}}, f, protocol=4)
        infos.append({"path": str(path), "token": fr["token"], "sweeps": [],
                      "gt_boxes": fr["gt_boxes"], "gt_names": fr["gt_names"]})
    return infos


def make_pool(seed: int, p: dict, device) -> list:
    """The pool of ``p['pool_frames']`` frames of ``seed``, its scenes in the seed's
    order."""
    n = int(p["pool_frames"])
    return [make_frame(seed, i, p, device) for i in _pool_order(seed, n)]


def loader_points(frame: dict) -> np.ndarray:
    """The points as the port's loader hands them on: tanh of the intensity."""
    pts = frame["points"].copy()
    pts[:, 3] = np.tanh(pts[:, 3])
    return pts
