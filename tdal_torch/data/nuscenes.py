"""nuScenes: the reference's second dataset.

Port of ``tdal/data/nuscenes.py`` (host-side numpy, the same draws from the same seed):
- ``GENERAL_TO_DETECTION`` and ``NUSC_TASKS`` (the reference's nusc_common tables);
- ``class_balanced_resample``, CBGS's duplication of the infos at train time;
- ``NuScenesDataset``: 5-wide ``.bin`` sweeps, each moved into the reference frame by
  its ``transform_matrix``, the time-lag channel, 9-wide GT boxes, on the port's
  ``DetectionDataset`` augmentations and targets;
- the quaternion helpers, ``transform_matrix`` and ``quaternion_yaw`` in numpy, so
  that ``_fill_trainval_infos`` runs on any object with the devkit's accessors;
- ``create_nuscenes_infos`` (which opens the database) and ``eval_main`` (the
  devkit's scoring), which need the optional nuScenes devkit and raise tdal's
  ``ImportError`` without it;
- ``evaluate_detections`` and ``write_nusc_results_json``, the submission json.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import List, Sequence

import numpy as np

from tdal_torch.data.detection import DetectionDataset

# reference det3d/datasets/nuscenes/nusc_common.py general_to_detection
GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}

NUSC_TASKS = [
    dict(num_class=1, class_names=["car"]),
    dict(num_class=2, class_names=["truck", "construction_vehicle"]),
    dict(num_class=2, class_names=["bus", "trailer"]),
    dict(num_class=1, class_names=["barrier"]),
    dict(num_class=2, class_names=["motorcycle", "bicycle"]),
    dict(num_class=2, class_names=["pedestrian", "traffic_cone"]),
]

_DEVKIT = ("create_nuscenes_infos needs the optional nuscenes-devkit package "
           "(reference requirements); tdal consumes the emitted info pickles")


def class_balanced_resample(infos: List[dict], class_names: Sequence[str], rng=None) -> List[dict]:
    """CBGS (nuscenes.py:74-118): every class's infos (those holding the class)
    drawn with replacement, int(n * frac / share) of them, so each class appears about
    equally often; the infos unchanged where no info holds a class."""
    rng = rng or np.random.default_rng(0)
    cls_infos = {name: [] for name in class_names}
    for info in infos:
        for name in set(np.asarray(info["gt_names"]).tolist()):
            if name in class_names:
                cls_infos[name].append(info)
    duplicated = sum(len(v) for v in cls_infos.values())
    if duplicated == 0:
        return list(infos)
    frac = 1.0 / len(class_names)
    out = []
    for name, lst in cls_infos.items():
        if not lst:
            continue
        ratio = frac / max(len(lst) / duplicated, 1e-9)
        idx = rng.integers(0, len(lst), int(len(lst) * ratio))
        out += [lst[i] for i in idx]
    return out


class NuScenesDataset(DetectionDataset):
    """Info schema: {'lidar_path', 'sweeps': [{'lidar_path', 'transform_matrix',
    'time_lag'}], 'gt_boxes' (N, 9), 'gt_names', 'token'} (nusc_common.py infos).
    Train mode resamples the infos by ``class_balanced_resample`` from ``seed``
    unless ``resample=False``."""

    NUM_POINT_FEATURES = 5

    def __init__(self, infos, class_names, assigner, voxel_cfg, mode="train",
                 nsweeps=10, resample=True, seed=0, **kw):
        if mode == "train" and resample:
            infos = class_balanced_resample(infos, class_names, np.random.default_rng(seed))
        super().__init__(infos, class_names, assigner, voxel_cfg, mode=mode,
                         nsweeps=nsweeps, seed=seed, **kw)

    def _read_bin(self, path) -> np.ndarray:
        return np.fromfile(str(path), dtype=np.float32).reshape(-1, 5)

    def _read_points(self, info) -> np.ndarray:
        """[x, y, z, intensity, time lag] of the keyframe and its first ``nsweeps - 1``
        sweeps, each sweep moved by its ``transform_matrix`` (nusc_common read_file /
        read_sweep)."""
        points = self._read_bin(info["lidar_path"])[:, :4]
        clouds = [points]
        times = [np.zeros((len(points), 1), np.float32)]
        for sweep in info.get("sweeps", [])[: self.nsweeps - 1]:
            sp = self._read_bin(sweep["lidar_path"])[:, :4]
            tm = sweep.get("transform_matrix")
            if tm is not None:
                tm = np.asarray(tm)
                sp[:, :3] = sp[:, :3] @ tm[:3, :3].T + tm[:3, 3]
            clouds.append(sp)
            times.append(np.full((len(sp), 1), sweep["time_lag"], np.float32))
        return np.concatenate([np.concatenate(clouds, 0), np.concatenate(times, 0)], axis=1)

    def _read_gt(self, info):
        return {
            "boxes": np.asarray(info["gt_boxes"], np.float32).reshape(-1, 9),
            "names": np.asarray([GENERAL_TO_DETECTION.get(n, n) for n in info["gt_names"]]),
        }


# ---------------------------------------------------------------------------
# Info creation (nusc_common.py:203-507): numpy geometry in place of pyquaternion, so
# _fill_trainval_infos works on any object with the NuScenes accessors (the devkit's
# database or a stub); only create_nuscenes_infos and eval_main need the devkit.
# ---------------------------------------------------------------------------


def _quat_to_rot(q) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _quat_mul(a, b) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _quat_inv(q) -> np.ndarray:
    """Inverse of a unit quaternion (its conjugate)."""
    w, x, y, z = q
    return np.array([w, -x, -y, -z])


def transform_matrix(translation, rotation, inverse: bool = False) -> np.ndarray:
    """4x4 homogeneous transform from a translation and a (w, x, y, z) quaternion, or
    its inverse (nuscenes.utils.geometry_utils.transform_matrix)."""
    tm = np.eye(4)
    rot = _quat_to_rot(rotation)
    t = np.asarray(translation, np.float64)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ t
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = t
    return tm


def quaternion_yaw(q) -> float:
    """Yaw of a box quaternion from its rotated x axis (nusc_common.py:429-444)."""
    v = _quat_to_rot(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def _get_available_scenes(nusc) -> list:
    """Scenes whose first lidar file exists on disk (nusc_common.py:203-224)."""
    available = []
    for scene in nusc.scene:
        sample = nusc.get("sample", scene["first_sample_token"])
        sd_rec = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        if Path(nusc.get_sample_data_path(sd_rec["token"])).exists():
            available.append(scene)
    return available


def _boxes_in_sensor_frame(nusc, sample) -> list:
    """A sample's annotations as box dicts in the lidar frame (nusc_common.py:227-272):
    each global box moved into the ego frame, then into the sensor frame; its velocity
    (``nusc.box_velocity``, NaN read as 0) rotated the same way."""
    sd_rec = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
    cs = nusc.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
    pose = nusc.get("ego_pose", sd_rec["ego_pose_token"])
    r_pose_inv = _quat_to_rot(pose["rotation"]).T
    r_cs_inv = _quat_to_rot(cs["rotation"]).T
    q_pose_inv = _quat_inv(pose["rotation"])
    q_cs_inv = _quat_inv(cs["rotation"])
    boxes = []
    for tok in sample["anns"]:
        anno = nusc.get("sample_annotation", tok)
        center = np.asarray(anno["translation"], np.float64)
        vel = np.asarray(nusc.box_velocity(tok), np.float64)
        vel = np.where(np.isfinite(vel), vel, 0.0)
        center = r_pose_inv @ (center - np.asarray(pose["translation"]))
        center = r_cs_inv @ (center - np.asarray(cs["translation"]))
        vel = r_cs_inv @ (r_pose_inv @ vel)
        q = _quat_mul(q_cs_inv, _quat_mul(q_pose_inv, anno["rotation"]))
        boxes.append({
            "center": center,
            "wlh": np.asarray(anno["size"], np.float64),
            "yaw": quaternion_yaw(q),
            "velocity": vel,
            "name": anno["category_name"],
            "token": tok,
            "num_pts": int(anno.get("num_lidar_pts", 1)) + int(anno.get("num_radar_pts", 0)),
        })
    return boxes


def _fill_trainval_infos(nusc, train_scenes, val_scenes, test=False, nsweeps=10,
                         filter_zero=True):
    """The info dicts ``NuScenesDataset`` reads (nusc_common.py:275-426): the
    ref_from_car / car_from_global transforms, the sweeps along the ``prev`` chain (the
    keyframe itself where the first one is missing, then the last one repeated), and
    ``gt_boxes`` = [xyz, wlh, vx, vy, -yaw - pi/2], boxes without points dropped unless
    ``filter_zero`` is off."""
    train_infos, val_infos = [], []
    for sample in nusc.sample:
        ref_sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        ref_cs = nusc.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
        ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]
        ref_lidar_path = nusc.get_sample_data_path(ref_sd["token"])
        ref_from_car = transform_matrix(ref_cs["translation"], ref_cs["rotation"],
                                        inverse=True)
        car_from_global = transform_matrix(ref_pose["translation"], ref_pose["rotation"],
                                           inverse=True)
        info = {
            "lidar_path": ref_lidar_path,
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }
        curr, sweeps = ref_sd, []
        while len(sweeps) < nsweeps - 1:
            if curr["prev"] == "":
                if not sweeps:
                    sweeps.append({"lidar_path": ref_lidar_path,
                                   "sample_data_token": curr["token"],
                                   "transform_matrix": None, "time_lag": 0.0})
                else:
                    sweeps.append(sweeps[-1])
                continue
            curr = nusc.get("sample_data", curr["prev"])
            pose = nusc.get("ego_pose", curr["ego_pose_token"])
            cs = nusc.get("calibrated_sensor", curr["calibrated_sensor_token"])
            global_from_car = transform_matrix(pose["translation"], pose["rotation"])
            car_from_current = transform_matrix(cs["translation"], cs["rotation"])
            sweeps.append({
                "lidar_path": nusc.get_sample_data_path(curr["token"]),
                "sample_data_token": curr["token"],
                "transform_matrix": (ref_from_car @ car_from_global @ global_from_car
                                     @ car_from_current),
                "global_from_car": global_from_car,
                "car_from_current": car_from_current,
                "time_lag": ref_time - 1e-6 * curr["timestamp"],
            })
        info["sweeps"] = sweeps

        if not test:
            boxes = _boxes_in_sensor_frame(nusc, sample)
            locs = np.array([b["center"] for b in boxes]).reshape(-1, 3)
            dims = np.array([b["wlh"] for b in boxes]).reshape(-1, 3)
            rots = np.array([b["yaw"] for b in boxes]).reshape(-1, 1)
            velocity = np.array([b["velocity"] for b in boxes]).reshape(-1, 3)
            names = np.array([GENERAL_TO_DETECTION.get(b["name"], b["name"]) for b in boxes])
            tokens = np.array([b["token"] for b in boxes])
            mask = np.array([b["num_pts"] > 0 for b in boxes], bool)
            gt_boxes = np.concatenate([locs, dims, velocity[:, :2], -rots - np.pi / 2], axis=1)
            if not filter_zero:
                mask = np.ones(len(boxes), bool)
            info["gt_boxes"] = gt_boxes[mask]
            info["gt_boxes_velocity"] = velocity[mask]
            info["gt_names"] = names[mask]
            info["gt_boxes_token"] = tokens[mask]

        (train_infos if sample["scene_token"] in train_scenes else val_infos).append(info)
    return train_infos, val_infos


def create_nuscenes_infos(root_path, version="v1.0-trainval", nsweeps=10, filter_zero=True):
    """Open the nuScenes database (the devkit is required) and write the train / val
    info pickles under tdal's names (nusc_common.py:447-507)."""
    try:
        from nuscenes.nuscenes import NuScenes  # type: ignore
        from nuscenes.utils import splits  # type: ignore
    except ImportError as e:
        raise ImportError(_DEVKIT) from e

    nusc = NuScenes(version=version, dataroot=str(root_path), verbose=True)
    if version == "v1.0-trainval":
        train_names, val_names = splits.train, splits.val
    elif version == "v1.0-test":
        train_names, val_names = splits.test, []
    elif version == "v1.0-mini":
        train_names, val_names = splits.mini_train, splits.mini_val
    else:
        raise ValueError(f"unknown version {version}")
    test = "test" in version
    root_path = Path(root_path)
    available = _get_available_scenes(nusc)
    names = [s["name"] for s in available]
    train_scenes = {available[names.index(s)]["token"] for s in train_names if s in names}
    val_scenes = {available[names.index(s)]["token"] for s in val_names if s in names}
    train_infos, val_infos = _fill_trainval_infos(nusc, train_scenes, val_scenes, test,
                                                  nsweeps=nsweeps, filter_zero=filter_zero)
    if test:
        with open(root_path / f"infos_test_{nsweeps:02d}sweeps_withvelo.pkl", "wb") as f:
            pickle.dump(train_infos, f)
    else:
        suffix = f"{nsweeps:02d}sweeps_withvelo_filter_{filter_zero}"
        with open(root_path / f"infos_train_{suffix}.pkl", "wb") as f:
            pickle.dump(train_infos, f)
        with open(root_path / f"infos_val_{suffix}.pkl", "wb") as f:
            pickle.dump(val_infos, f)
    return train_infos, val_infos


def eval_main(nusc, eval_version, res_path, eval_set, output_dir):
    """The devkit's scoring of a results json (nusc_common.py:509-521)."""
    from nuscenes.eval.detection.config import config_factory  # type: ignore
    from nuscenes.eval.detection.evaluate import NuScenesEval  # type: ignore

    nusc_eval = NuScenesEval(nusc, config=config_factory(eval_version), result_path=res_path,
                             eval_set=eval_set, output_dir=output_dir, verbose=True)
    return nusc_eval.main(plot_examples=0)


def evaluate_detections(detections, out_dir, mapped_class_names, root_path=None,
                        version="v1.0-trainval", eval_version="detection_cvpr_2019",
                        eval_set="val"):
    """Write the submission json and, where the devkit is installed, score it
    (nuscenes.py:188-326). Returns (json path, the metrics or None)."""
    out_dir = Path(out_dir)
    res_path = write_nusc_results_json(detections, None, out_dir / "infos.json",
                                       mapped_class_names)
    try:
        from nuscenes.nuscenes import NuScenes  # type: ignore
    except ImportError:
        return res_path, None
    nusc = NuScenes(version=version, dataroot=str(root_path), verbose=False)
    return res_path, eval_main(nusc, eval_version, str(res_path), eval_set, str(out_dir))


def write_nusc_results_json(detections: dict, infos: dict, out_path,
                            mapped_class_names: Sequence[str]):
    """The nuScenes submission json of the detector's outputs (nuscenes.py:188-290):
    per sample token its boxes' translation, size (w, l, h), yaw quaternion, velocity
    (zero for 7-wide boxes), class name and score."""
    nusc_annos = {"results": {}, "meta": {"use_camera": False, "use_lidar": True,
                                          "use_radar": False, "use_map": False,
                                          "use_external": False}}
    for token, det in detections.items():
        boxes = np.asarray(det["box3d_lidar"])
        scores = np.asarray(det["scores"])
        labels = np.asarray(det["label_preds"])
        annos = []
        for i in range(len(boxes)):
            b = boxes[i]
            annos.append({
                "sample_token": token,
                "translation": b[:3].tolist(),
                "size": b[[4, 3, 5]].tolist(),
                "rotation": [float(np.cos(b[-1] / 2)), 0.0, 0.0, float(np.sin(b[-1] / 2))],
                "velocity": b[6:8].tolist() if boxes.shape[1] == 9 else [0.0, 0.0],
                "detection_name": mapped_class_names[int(labels[i])],
                "detection_score": float(scores[i]),
                "attribute_name": "",
            })
        nusc_annos["results"][token] = annos
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(nusc_annos, f)
    return out_path
