"""Greedy center-distance 3D multi-object tracker (a copy of ``tdal/pipeline/tracker.py``).

Capability parity with reference ``tools/waymo_tracking/tracker.py``: per-frame greedy
assignment on predicted centers (ct - vel*dt), class-gated distance thresholds,
score-threshold birth, max_age aging with constant-velocity coasting. The tracker is
stateful and tiny (O(N*M) numpy per frame, SURVEY.md §7 keeps it host-side).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

WAYMO_TRACKING_NAMES = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]


def greedy_assignment(dist: np.ndarray) -> np.ndarray:
    """Row-greedy matching: each det takes its nearest unclaimed track.

    Parity: tracker.py:6-15."""
    matched = []
    if dist.shape[1] == 0:
        return np.zeros((0, 2), np.int32)
    dist = dist.copy()
    for i in range(dist.shape[0]):
        j = int(dist[i].argmin())
        if dist[i][j] < 1e16:
            dist[:, j] = 1e18
            matched.append([i, j])
    return np.array(matched, np.int32).reshape(-1, 2)


class GreedyTracker:
    """Parity: tracker.PubTracker (tracker.py:24-133)."""

    def __init__(self, max_age: int = 0, max_dist: Dict[str, float] | None = None, score_thresh: float = 0.1):
        self.max_age = max_age
        self.max_dist = max_dist or {}
        self.score_thresh = score_thresh
        self.id_count = 0
        self.reset()

    def reset(self):
        self.tracks: List[dict] = []

    def step(self, results: List[dict], time_lag: float) -> List[dict]:
        """results: [{'translation' (3,), 'velocity' (2,), 'detection_name', 'score',
        'box_id'}]. Returns live tracks; entries with active == 0 are coasting."""
        if len(results) == 0:
            self.tracks = []
            return []
        dets_in = []
        for det in results:
            if det["detection_name"] not in WAYMO_TRACKING_NAMES:
                continue
            det = dict(det)
            det["ct"] = np.asarray(det["translation"][:2], np.float64)
            det["tracking"] = np.asarray(det["velocity"][:2], np.float64) * -1 * time_lag
            det["label_preds"] = WAYMO_TRACKING_NAMES.index(det["detection_name"])
            dets_in.append(det)
        results = dets_in

        n, m = len(results), len(self.tracks)
        if n == 0:
            self.tracks = []
            return []

        dets = np.array([d["ct"] + d["tracking"] for d in results])  # (N, 2)
        item_cat = np.array([d["label_preds"] for d in results])
        track_cat = np.array([t["label_preds"] for t in self.tracks], np.int32).reshape(-1)
        max_diff = np.array(
            [self.max_dist[d["detection_name"]] for d in results]
        )
        tracks_ct = np.array([t["ct"] for t in self.tracks]).reshape(m, 2)

        if m > 0:
            dist = np.sqrt(
                ((tracks_ct[None] - dets[:, None]) ** 2).sum(axis=2)
            )  # (N, M)
            invalid = (dist > max_diff[:, None]) | (
                item_cat[:, None] != track_cat[None, :]
            )
            dist = dist + invalid * 1e18
            matched = greedy_assignment(dist)
        else:
            matched = np.zeros((0, 2), np.int32)

        unmatched_dets = [d for d in range(n) if d not in matched[:, 0]]
        unmatched_tracks = [d for d in range(m) if d not in matched[:, 1]]

        ret = []
        for i, j in matched:
            track = results[i]
            track["tracking_id"] = self.tracks[j]["tracking_id"]
            track["age"] = 1
            track["active"] = self.tracks[j]["active"] + 1
            ret.append(track)
        for i in unmatched_dets:
            track = results[i]
            if track["score"] > self.score_thresh:
                self.id_count += 1
                track["tracking_id"] = self.id_count
                track["age"] = 1
                track["active"] = 1
                ret.append(track)
        for i in unmatched_tracks:
            track = self.tracks[i]
            if track["age"] < self.max_age:
                track["age"] += 1
                track["active"] = 0
                if "tracking" in track:
                    track["ct"] = track["ct"] + track["tracking"] * -1
                ret.append(track)
        self.tracks = ret
        return ret
