"""nuScenes in the port against tdal, on the CPU, value for value: the info builder
over a stub database (a copy of ``tests/test_nuscenes.py``'s ``StubNusc``, an object
with the devkit's accessors), ``NuScenesDataset`` items with class-balanced
resampling from a seed, the quaternion helpers, the results json, and the devkit gate
of ``create_nuscenes_infos``, ``eval_main`` and ``create_data nuscenes_data_prep``
(the devkit is not installed, so the two are not run past the gate)."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tdal.data.nuscenes as jnus
from tdal.core.targets import AssignerConfig as JAssignerConfig
from tdal.core.voxel import VoxelConfig as JVoxelConfig
from tdal_torch.core.targets import AssignerConfig
from tdal_torch.core.voxel import VoxelConfig
from tdal_torch.data import nuscenes as nus

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _yaw_quat(yaw):
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


class StubNusc:
    """Minimal NuScenes DB: one scene, n_samples keyframes, one prev sweep each."""

    def __init__(self, root, n_samples=3, n_annos=2, seed=0):
        rng = np.random.default_rng(seed)
        self.root = root
        self._tables = {"sample_data": {}, "ego_pose": {}, "calibrated_sensor": {},
                        "sample_annotation": {}, "sample": {}}
        self.sample = []
        self.scene = [{"token": "scene0", "name": "scene-0001",
                       "first_sample_token": "samp0"}]
        cs_tok = "cs0"
        self._tables["calibrated_sensor"][cs_tok] = {
            "translation": [0.9, 0.0, 1.8],
            "rotation": _yaw_quat(0.1).tolist(),
        }
        prev_tok = ""
        for i in range(n_samples):
            samp_tok, sd_tok, sweep_tok = f"samp{i}", f"sd{i}", f"sw{i}"
            # keyframe pose + a sweep 50ms earlier with a slightly different pose
            for tok, dt in ((sweep_tok, 0.05), (sd_tok, 0.0)):
                pose_tok = f"pose_{tok}"
                self._tables["ego_pose"][pose_tok] = {
                    "translation": [5.0 * (i - dt), 0.1 * i, 0.0],
                    "rotation": _yaw_quat(0.02 * i).tolist(),
                }
                ts = int((100.0 + i * 0.5 - dt) * 1e6)
                self._tables["sample_data"][tok] = {
                    "token": tok,
                    "timestamp": ts,
                    "ego_pose_token": pose_tok,
                    "calibrated_sensor_token": cs_tok,
                    "prev": prev_tok if tok == sweep_tok else sweep_tok,
                }
                # write a .bin point file for each sample_data
                pts = rng.uniform(-20, 20, (512, 5)).astype(np.float32)
                pts.tofile(str(root / f"{tok}.bin"))
            prev_tok = sd_tok
            anns = []
            for k in range(n_annos):
                tok = f"anno{i}_{k}"
                anns.append(tok)
                self._tables["sample_annotation"][tok] = {
                    "translation": [10.0 + 2 * k + 5.0 * i, 1.0 + k, 0.5],
                    "size": [1.9, 4.6, 1.6],  # (w, l, h)
                    "rotation": _yaw_quat(0.3 + 0.1 * k).tolist(),
                    "category_name": "vehicle.car" if k == 0 else
                                     "human.pedestrian.adult",
                    "num_lidar_pts": 5 if k == 0 else 0,
                    "num_radar_pts": 0,
                }
            rec = {"token": samp_tok, "scene_token": "scene0",
                   "data": {"LIDAR_TOP": sd_tok}, "anns": anns,
                   "timestamp": self._tables["sample_data"][sd_tok]["timestamp"]}
            self._tables["sample"][samp_tok] = rec
            self.sample.append(rec)

    def get(self, table, token):
        return self._tables[table][token]

    def get_sample_data_path(self, token):
        return str(self.root / f"{token}.bin")

    def box_velocity(self, anno_token):
        return np.array([1.0, 0.5, 0.0])


def assert_same(a, b, where="root"):
    """Deep equality: dicts (keys in order), lists, arrays (dtype and values), scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_tables_match_tdal():
    assert nus.GENERAL_TO_DETECTION == jnus.GENERAL_TO_DETECTION
    assert nus.NUSC_TASKS == jnus.NUSC_TASKS


@pytest.mark.parametrize("kw", [dict(nsweeps=3), dict(nsweeps=4), dict(nsweeps=2,
                                filter_zero=False), dict(nsweeps=3, test=True)],
                         ids=["3 sweeps", "4 sweeps (the chain runs out)", "no filter",
                              "test split"])
def test_info_builder_matches_tdal(tmp_path, kw):
    """``_get_available_scenes``, ``_boxes_in_sensor_frame`` and
    ``_fill_trainval_infos`` over the stub database: the same scenes, boxes and infos."""
    nusc = StubNusc(tmp_path)
    assert_same(nus._get_available_scenes(nusc), jnus._get_available_scenes(nusc))
    for sample in nusc.sample:
        assert_same(nus._boxes_in_sensor_frame(nusc, sample),
                    jnus._boxes_in_sensor_frame(nusc, sample))
    got = nus._fill_trainval_infos(nusc, {"scene0"}, set(), **kw)
    want = jnus._fill_trainval_infos(nusc, {"scene0"}, set(), **kw)
    assert len(got[0]) == 3 and not got[1]
    assert_same(got, want)
    val = nus._fill_trainval_infos(nusc, set(), {"scene0"}, **kw)
    assert not val[0] and len(val[1]) == 3


def test_quaternion_helpers_match_tdal():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r = rng.normal(size=4)
        r /= np.linalg.norm(r)
        t = rng.normal(size=3) * 10
        np.testing.assert_array_equal(nus._quat_to_rot(q), jnus._quat_to_rot(q))
        np.testing.assert_array_equal(nus._quat_mul(q, r), jnus._quat_mul(q, r))
        np.testing.assert_array_equal(nus._quat_inv(q), jnus._quat_inv(q))
        for inverse in (False, True):
            np.testing.assert_array_equal(nus.transform_matrix(t, q, inverse),
                                          jnus.transform_matrix(t, q, inverse))
        assert nus.quaternion_yaw(q) == jnus.quaternion_yaw(q)
    np.testing.assert_allclose(nus.transform_matrix(t, q) @ nus.transform_matrix(t, q, True),
                               np.eye(4), atol=1e-12)


def test_class_balanced_resample_matches_tdal():
    """The same draws from the same seeded generator; the rare class pushed toward
    parity; the infos unchanged where no info holds a class."""
    infos = ([{"gt_names": ["car"]} for _ in range(90)]
             + [{"gt_names": ["bicycle", "car"]} for _ in range(10)])
    got = nus.class_balanced_resample(infos, ["car", "bicycle"], np.random.default_rng(3))
    want = jnus.class_balanced_resample(infos, ["car", "bicycle"], np.random.default_rng(3))
    assert [id(i) for i in got] == [id(i) for i in want]  # the same infos, in order
    assert sum("bicycle" in i["gt_names"] for i in got) >= 30
    assert nus.class_balanced_resample(infos, ["truck"]) == infos


def test_dataset_items_match_tdal(tmp_path):
    """``NuScenesDataset`` in train mode with CBGS (seed 5) over the stub's infos: the
    same resampled infos and, item for item, the same points (3 sweeps, the time-lag
    channel) and targets; and the test-mode items."""
    nusc = StubNusc(tmp_path)
    infos, _ = nus._fill_trainval_infos(nusc, {"scene0"}, set(), nsweeps=3, filter_zero=False)
    tasks = [dict(num_class=1, class_names=["car"]),
             dict(num_class=1, class_names=["pedestrian"])]
    vox = ((-50, -50, -5, 50, 50, 3), (0.25, 0.25, 8.0), 10, 4000)
    names = ["car", "pedestrian"]
    for mode in ("train", "test"):
        ds = nus.NuScenesDataset(infos, names, AssignerConfig(tasks=tasks, out_size_factor=4,
                                                              max_objs=50),
                                 VoxelConfig(*vox), mode=mode, nsweeps=3, seed=5,
                                 max_points=2048)
        jds = jnus.NuScenesDataset(infos, names, JAssignerConfig(tasks=tasks,
                                                                 out_size_factor=4,
                                                                 max_objs=50),
                                   JVoxelConfig(*vox), mode=mode, nsweeps=3, seed=5,
                                   max_points=2048)
        assert [i["token"] for i in ds.infos] == [i["token"] for i in jds.infos]
        if mode == "train":
            assert len(ds) > len(infos)  # CBGS duplicated infos
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            assert_same(got, want, f"{mode} item {i}")
            finite = np.isfinite(got["points"][:, 4])
            assert got["points"].shape[1] == 5
            assert len(np.unique(got["points"][finite, 4])) >= 2  # the sweeps' time lags


def _detections():
    return {
        "tok0": {"box3d_lidar": np.array([[1, 2, 0.5, 4.6, 1.9, 1.6, 0.5, 0.1, 0.3],
                                          [-3, 4, 0.2, 0.8, 0.7, 1.7, 0.0, 0.2, -1.1]]),
                 "scores": np.array([0.9, 0.4]), "label_preds": np.array([0, 1])},
        "tok1": {"box3d_lidar": np.zeros((0, 9)), "scores": np.zeros(0),
                 "label_preds": np.zeros(0, int)},
        "tok2": {"box3d_lidar": np.array([[5, 6, 0.1, 4.0, 2.0, 1.5, 2.0]]),
                 "scores": np.array([0.6]), "label_preds": np.array([1])},
    }


def test_results_json_matches_tdal(tmp_path):
    """``write_nusc_results_json`` and ``evaluate_detections`` (which writes it and,
    without the devkit, scores nothing): the same bytes."""
    dets, names = _detections(), ["car", "pedestrian"]
    got = nus.write_nusc_results_json(dets, None, tmp_path / "port" / "res.json", names)
    want = jnus.write_nusc_results_json(dets, None, tmp_path / "tdal" / "res.json", names)
    assert Path(got).read_bytes() == Path(want).read_bytes()
    row = json.loads(Path(got).read_text())["results"]["tok0"][0]
    assert row["size"] == [1.9, 4.6, 1.6] and row["velocity"] == [0.5, 0.1]
    got = nus.evaluate_detections(dets, tmp_path / "port_eval", names)
    want = jnus.evaluate_detections(dets, tmp_path / "tdal_eval", names)
    assert got[1] is None and want[1] is None
    assert Path(got[0]).read_bytes() == Path(want[0]).read_bytes()


def test_devkit_gates_match_tdal(tmp_path, monkeypatch):
    """Without the nuScenes devkit ``create_nuscenes_infos`` raises tdal's
    ``ImportError``, through ``create_data nuscenes_data_prep`` as through
    ``tools/create_data.py``, and ``eval_main`` cannot import its scorer."""
    with pytest.raises(ImportError) as got:
        nus.create_nuscenes_infos(tmp_path)
    with pytest.raises(ImportError) as want:
        jnus.create_nuscenes_infos(tmp_path)
    assert str(got.value) == str(want.value)
    for module in (nus, jnus):
        with pytest.raises(ImportError):
            module.eval_main(None, "detection_cvpr_2019", "res.json", "val", tmp_path)
    from tdal_torch.tools import create_data

    spec = importlib.util.spec_from_file_location("tools_create_data",
                                                  ROOT / "tools" / "create_data.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    argv = ["create_data", "nuscenes_data_prep", "--root_path", str(tmp_path),
            "--version", "v1.0-mini", "--nsweeps", "3"]
    messages = []
    for main in (create_data.main, tool.main):
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(ImportError) as e:
            main()
        messages.append(str(e.value))
    assert messages[0] == messages[1] == str(want.value)
