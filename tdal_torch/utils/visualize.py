"""Visualisation: BEV renders with matplotlib (headless) and open3d viewers.

Port of ``tdal/utils/visualize.py`` (reference tools/visualize/vis_{data,track,pred}.py:
open3d line sets and labels). ``plot_bev`` and ``plot_track`` draw with matplotlib on
the Agg backend, imported when first called; ``show_open3d``, ``show_track_open3d`` and
``show_sequence_open3d`` need the optional ``open3d`` package and raise ``ImportError``
with ``tdal``'s message without it. Host work on numpy arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from tdal_torch.data.waymo_schema import rotz_np

CLASS_COLORS = {0: "tab:green", 1: "tab:red", 2: "tab:orange", 4: "tab:purple"}


def _box_corners_bev(box7: np.ndarray) -> np.ndarray:
    x, y, _, l, w, _, h = box7
    local = np.array([[-l / 2, -w / 2], [-l / 2, w / 2], [l / 2, w / 2], [l / 2, -w / 2]])
    c, s = np.cos(h), np.sin(h)
    return local @ np.array([[c, s], [-s, c]]) + np.array([x, y])


def _closed(corners: np.ndarray) -> np.ndarray:
    return np.vstack([corners, corners[:1]]).T


def plot_bev(points: Optional[np.ndarray] = None, boxes: Optional[np.ndarray] = None,
             labels: Optional[Sequence] = None, gt_boxes: Optional[np.ndarray] = None,
             out_path: Optional[str] = None, title: str = "", xlim=(-80, 80), ylim=(-80, 80)):
    """A BEV frame: points (N, >=2) in grey, ``gt_boxes`` (M, 7) in blue, ``boxes``
    (M, 7, lidar convention) coloured by ``labels``. Saved to ``out_path`` (which is
    returned), else the figure is returned."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10))
    if points is not None and len(points):
        ax.scatter(points[:, 0], points[:, 1], s=0.2, c="0.6", linewidths=0)
    if gt_boxes is not None:
        for b in np.atleast_2d(gt_boxes):
            ax.plot(*_closed(_box_corners_bev(np.asarray(b, float)[:7])), c="tab:blue", lw=1.0)
    if boxes is not None:
        for i, b in enumerate(np.atleast_2d(boxes)):
            color = CLASS_COLORS.get(labels[i] if labels is not None else 0, "tab:red")
            ax.plot(*_closed(_box_corners_bev(np.asarray(b, float)[:7])), c=color, lw=1.0)
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    ax.set_title(title)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def plot_track(track: dict, annos, out_path=None, title=""):
    """One track's global-frame boxes over its merged points, 30 m around its mean
    center."""
    boxes = np.stack([np.asarray(b).reshape(-1)[:7] for b in track["bbox"]])
    pts = np.concatenate([np.asarray(p).reshape(-1, 3) for p in track["point"]], axis=0)
    c = boxes[:, :2].mean(0)
    return plot_bev(points=pts, boxes=boxes, out_path=out_path, title=title,
                    xlim=(c[0] - 30, c[0] + 30), ylim=(c[1] - 30, c[1] + 30))


_BOX_LINES = [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
              [0, 4], [1, 5], [2, 6], [3, 7]]


def box_corners_3d(box7: np.ndarray) -> np.ndarray:
    """(7,) box -> (8, 3) corners, lidar convention (reference vis_pred.get_points +
    rotz, vis_pred.py:77-92)."""
    x, y, z, l, w, h, yaw = np.asarray(box7, float)[:7]
    local = np.array([[sx * l / 2, sy * w / 2, sz * h / 2]
                      for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])[
        [0, 2, 6, 4, 1, 3, 7, 5]]
    return local @ rotz_np(yaw).T + np.array([x, y, z])


def _require_open3d():
    try:
        import open3d as o3d
    except ImportError as e:
        raise ImportError(
            "open3d is not installed in this environment; use plot_bev for headless "
            "PNG rendering instead") from e
    return o3d


def _box_lineset(o3d, box7, color):
    ls = o3d.geometry.LineSet(o3d.utility.Vector3dVector(box_corners_3d(box7)),
                              o3d.utility.Vector2iVector(_BOX_LINES))
    ls.colors = o3d.utility.Vector3dVector([color] * len(_BOX_LINES))
    return ls


def _box_sets(boxes, box_sets):
    sets = list(box_sets or [])
    if boxes is not None:
        sets.insert(0, {"boxes": boxes, "color": (0.0, 0.8, 0.0), "name": "GT"})
    return sets


def show_open3d(points, boxes=None, box_sets=None, score_thresh=0.5, verbose=True):
    """Interactive 3D view: the points, ``boxes`` as a green GT set and each of
    ``box_sets`` ({boxes, color (r, g, b in 0..1), scores?, name?}) in its colour,
    with boxes under ``score_thresh`` left out and the rest printed (reference
    vis_{data,pred}.py draw_3dbbox)."""
    o3d = _require_open3d()
    geo = [o3d.geometry.PointCloud(o3d.utility.Vector3dVector(np.asarray(points)[:, :3]))]
    for bs in _box_sets(boxes, box_sets):
        color = tuple(bs.get("color", (0.9, 0.1, 0.1)))
        scores, name = bs.get("scores"), bs.get("name", "boxes")
        for i, b in enumerate(np.atleast_2d(np.asarray(bs["boxes"]))):
            if scores is not None and float(scores[i]) < score_thresh:
                continue
            geo.append(_box_lineset(o3d, b, color))
            if verbose and scores is not None:
                x, y, z, l, w, h, yaw = np.asarray(b, float)[:7]
                print(f"[{name}] score: {float(scores[i]):.2f}, box: ({x:6.2f}, "
                      f"{y:6.2f}, {z:6.2f}, {l:5.2f}, {w:5.2f}, {h:5.2f}, {yaw:5.2f})")
    geo.append(o3d.geometry.TriangleMesh.create_coordinate_frame())
    o3d.visualization.draw_geometries(geo)


def show_track_open3d(track: dict):
    """Interactive view of one track: its merged points, its boxes coloured by time
    (blue to red) and its center trajectory (reference vis_track.py)."""
    o3d = _require_open3d()
    pts = np.concatenate([np.asarray(p).reshape(-1, 3) for p in track["point"]], axis=0)
    geo = [o3d.geometry.PointCloud(o3d.utility.Vector3dVector(pts))]
    boxes = [np.asarray(b).reshape(-1)[:7] for b in track["bbox"]]
    n = max(len(boxes) - 1, 1)
    for i, b in enumerate(boxes):
        geo.append(_box_lineset(o3d, b, (i / n, 0.2, 1.0 - i / n)))
    centers = np.stack([b[:3] for b in boxes])
    if len(centers) > 1:
        traj = o3d.geometry.LineSet(
            o3d.utility.Vector3dVector(centers),
            o3d.utility.Vector2iVector([[i, i + 1] for i in range(len(centers) - 1)]))
        traj.colors = o3d.utility.Vector3dVector([(0.1, 0.1, 0.1)] * (len(centers) - 1))
        geo.append(traj)
    o3d.visualization.draw_geometries(geo)


def show_sequence_open3d(frames, score_thresh=0.5, window_name="tdal"):
    """Interactive playback of ``frames`` ({points, gt?, sets: [{boxes, scores?,
    color?, name?}]}): the N and P keys step forward and back (reference
    vis_pred.py's VisualizerWithKey loop)."""
    o3d = _require_open3d()
    state = {"i": 0}
    vis = o3d.visualization.VisualizerWithKeyCallback()
    vis.create_window(window_name=window_name)

    def load(idx):
        vis.clear_geometries()
        fr = frames[idx]
        vis.add_geometry(o3d.geometry.PointCloud(
            o3d.utility.Vector3dVector(np.asarray(fr["points"])[:, :3])))
        for bs in _box_sets(fr.get("gt"), fr.get("sets", [])):
            color = tuple(bs.get("color", (0.9, 0.1, 0.1)))
            scores = bs.get("scores")
            for i, b in enumerate(np.atleast_2d(np.asarray(bs["boxes"]))):
                if scores is not None and float(scores[i]) < score_thresh:
                    continue
                vis.add_geometry(_box_lineset(o3d, b, color), reset_bounding_box=False)
        print(f"frame {idx + 1}/{len(frames)}")

    def step(delta):
        def callback(v):
            state["i"] = min(max(state["i"] + delta, 0), len(frames) - 1)
            load(state["i"])
            return False
        return callback

    vis.register_key_callback(ord("N"), step(1))
    vis.register_key_callback(ord("P"), step(-1))
    load(0)
    vis.run()
    vis.destroy_window()
