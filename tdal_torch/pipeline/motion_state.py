"""GT track building + motion-state classification (pipeline stage 4).

A copy of ``tdal/pipeline/motion_state.py``. The classifier rule is the same: sklearn's
linear ``SVC`` where sklearn is installed, else the numpy fallback, so each machine
makes the choice tdal makes there.

Capability parity with reference ``tools/trackGT.py`` and ``tools/motionState.py``:
- ``build_track_gt``: group GT boxes by object name across frames in the global frame;
  a track is static iff first-to-last displacement < 1m AND max speed < 1 m/s
  (trackGT.py:37-66).
- ``track_features``: per track [‖first-last center‖, ‖var(centers)‖] features +
  filtering (drop unmatched / short / pedestrian / empty tracks)
  (motionState.py:30-67).
- ``fit_motion_classifier`` / ``predict_motion``: 2-feature linear SVM (sklearn when
  available, with a numpy perceptron-margin fallback so the pipeline has no hard
  sklearn dependency).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tdal_torch.data.waymo_schema import load_pickle, transform_box_np

PEDESTRIAN_TYPE = 2


def build_track_gt(infos: list) -> Dict[str, dict]:
    """infos: list of info dicts. Returns name-keyed GT tracks with 'static' bit.

    Parity: trackGT.py:37-66."""
    trackGT: Dict[str, dict] = {}
    for info in infos:
        annos = load_pickle(info["anno_path"])
        pose = np.reshape(np.asarray(annos["veh_to_global"], np.float64), (4, 4))
        for obj in annos["objects"]:
            name = obj["name"]
            box = np.asarray(obj["box"], np.float64)[[0, 1, 2, 3, 4, 5, -1]]
            box = transform_box_np(box[None], pose)[0]
            vel = float(np.linalg.norm(np.asarray(obj["box"])[[6, 7]]))
            entry = trackGT.setdefault(
                name, {"box": [], "vel": [], "pose": pose, "num_points": []}
            )
            entry["box"].append(box)
            entry["vel"].append(vel)
            entry["num_points"].append(obj["num_points"])
    for name, obj in trackGT.items():
        bbox = np.array(obj["box"])
        dist = np.linalg.norm(bbox[0, :3] - bbox[-1, :3])
        vel = np.max(obj["vel"])
        obj["static"] = 1 if (dist < 1 and vel < 1) else 0
    return trackGT


def track_features(track: dict, trackGT: Dict[str, dict], training: bool = False):
    """Filter tracks and compute the 2 motion features per track.

    Parity: motionState.py:30-67. Returns (X, y, static, dynamic) when training,
    else (X, y, filtered_track)."""
    new_track = {}
    for track_id, obj in track.items():
        match = obj["match"][-1]
        bbox = np.array([np.asarray(b).reshape(-1)[:7] for b in obj["bbox"]])
        types = np.array(obj["type"])
        n_points = sum(np.asarray(p).shape[0] for p in obj["point"])
        if (
            match is None
            or bbox.shape[0] < 7
            or types[0] == PEDESTRIAN_TYPE
            or n_points == 0
            or match not in trackGT
        ):
            continue
        new_track[track_id] = obj

    X, y = [], []
    static, dynamic = {}, {}
    for track_id, obj in new_track.items():
        match = obj["match"][-1]
        bbox = np.array([np.asarray(b).reshape(-1)[:7] for b in obj["bbox"]])
        distance = np.linalg.norm(bbox[0, :3] - bbox[-1, :3])
        var = np.linalg.norm(np.var(bbox[:, :3], axis=0))
        X.append([distance, var])
        is_static = int(trackGT[match]["static"])
        y.append(is_static)
        if training:
            (static if is_static else dynamic)[track_id] = obj
    X = np.array(X).reshape(-1, 2)
    y = np.array(y)
    if training:
        return X, y, static, dynamic
    return X, y, new_track


class _FallbackLinearSVM:
    """Tiny numpy linear classifier (logistic regression by gradient descent) used
    when sklearn is unavailable. 2 features, so this converges instantly."""

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        self.mu = X.mean(0)
        self.sd = X.std(0) + 1e-9
        Xn = (X - self.mu) / self.sd
        w = np.zeros(X.shape[1] + 1)
        t = np.where(np.asarray(y) > 0, 1.0, -1.0)
        A = np.concatenate([Xn, np.ones((len(Xn), 1))], axis=1)
        for _ in range(2000):
            m = t * (A @ w)
            g = -(t[:, None] * A * (1 / (1 + np.exp(m)))[:, None]).mean(0) + 1e-4 * w
            w -= 0.5 * g
        self.w = w
        return self

    def predict(self, X):
        Xn = (np.asarray(X, np.float64) - self.mu) / self.sd
        A = np.concatenate([Xn, np.ones((len(Xn), 1))], axis=1)
        return (A @ self.w > 0).astype(int)

    def score(self, X, y):
        return float((self.predict(X) == np.asarray(y)).mean())


def fit_motion_classifier(X, y):
    """Linear SVM on the 2 motion features. Parity: motionState.py:128 SVC(linear)."""
    if len(np.unique(y)) < 2:
        clf = _ConstantClassifier(int(y[0]) if len(y) else 1)
        return clf
    try:
        from sklearn.svm import SVC
    except ImportError:
        return _FallbackLinearSVM().fit(X, y)
    return SVC(kernel="linear").fit(X, y)


class _ConstantClassifier:
    def __init__(self, value: int):
        self.value = value

    def predict(self, X):
        return np.full(len(X), self.value, int)

    def score(self, X, y):
        return float((self.predict(X) == np.asarray(y)).mean())


def split_by_prediction(track: dict, preds) -> Tuple[dict, dict]:
    """Split a filtered track dict into (static, dynamic) by classifier output.

    Parity: motionState.py:133-140."""
    static, dynamic = {}, {}
    for (track_id, obj), p in zip(track.items(), preds):
        (static if p == 1 else dynamic)[track_id] = obj
    return static, dynamic
