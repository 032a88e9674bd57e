"""The offboard chain through the port's CLIs (``python -m tdal_torch.tools.<stage>``,
``--device cpu``), mirroring ``tests/test_full_pipeline.py::test_full_pipeline_chain``
at its sizes: fabricated detections -> tracking -> reorganisation -> trackGT +
motionState -> static labeler train + eval -> dynamic labeler train + eval, every
stage reading the previous stage's files.

Stages 2-4 are deterministic: every file they write must equal, value for value,
what ``tools/`` writes on the same segment from the same prediction.pkl. The training
CLIs are checked for their files and schema, as the reference test checks them.
Also: the detector CLIs (``train`` one epoch of pp_tiny, ``dist_test --evaluate``)
write their checkpoint, prediction.pkl and det_annos.
"""

import importlib
import importlib.util
import json
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tdal.data.synthetic import make_synthetic_dataset
from tdal.data.waymo_schema import AnnoStore, dump_pickle, load_pickle, reorganize_info
from test_pipeline_stages import _fabricate_detections

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def _run_tdal(relpath, argv):
    path = ROOT / "tools" / relpath
    spec = importlib.util.spec_from_file_location(f"tool_{relpath.replace('/', '_')[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _main(mod, relpath, argv)


def _run_port(module, argv):
    _main(importlib.import_module(f"tdal_torch.tools.{module}"), module, argv)


def _main(mod, name, argv):
    old = sys.argv
    sys.argv = [name] + [str(a) for a in argv]
    try:
        mod.main()
    finally:
        sys.argv = old


def assert_same(a, b, where="root"):
    """Deep equality of pickled values: dicts (keys in order), lists, arrays, scalars."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


@pytest.fixture(scope="module")
def segment(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    infos, scenes = make_synthetic_dataset(
        root, n_scenes=1, n_frames=10, seed=21, n_static=2, n_dynamic=2,
        points_per_object=128, n_background=512,
    )
    annos = AnnoStore(reorganize_info(infos))
    dump_pickle(_fabricate_detections(scenes, annos, noise=0.03), root / "prediction.pkl")
    return root


def _stages_2_to_4(run, root, side):
    """waymo_tracking/test, trackData, trackGT, motionState into ``root/side``."""
    val, train = root / side / "val", root / side / "train"
    val.mkdir(parents=True, exist_ok=True)
    train.mkdir(exist_ok=True)
    info_path = root / "infos.pkl"
    extra = CPU if run is _run_port else []
    run("waymo_tracking/test.py" if run is _run_tdal else "waymo_tracking.test",
        ["--work_dir", val, "--checkpoint", root / "prediction.pkl", "--info_path", info_path,
         "--score_thresh", "0.5", *extra])
    run("trackData.py" if run is _run_tdal else "trackData", ["--work_dir", val])
    run("trackGT.py" if run is _run_tdal else "trackGT",
        ["--infos", info_path, "--result", val / "trackGT.pkl"])
    # the train side reuses the val tracks, 16-way sharded (test_full_pipeline.py)
    items = list(load_pickle(val / "track.pkl").items())
    for i in range(16):
        dump_pickle(dict(items[len(items) * i // 16 : len(items) * (i + 1) // 16]),
                    train / f"track_{i}.pkl")
    dump_pickle(load_pickle(val / "trackGT.pkl"), train / "trackGT.pkl")
    run("motionState.py" if run is _run_tdal else "motionState",
        ["--track_train", train, "--track_val", val])
    return val, train


STAGE_FILES = {
    "val": ["det_annos.pkl", "trackData.pkl", "tracking_pred.bin.pkl", "gt_preds.bin.pkl",
            "track.pkl", "trackGT.pkl", "trackStatic.pkl", "trackDynamic.pkl"],
    "train": [f"{name}_{i}.pkl" for name in ("trackStatic", "trackDynamic")
              for i in range(16)],
}


def test_stages_2_to_4_write_tdal_files(segment):
    j_val, j_train = _stages_2_to_4(_run_tdal, segment, "jax")
    t_val, t_train = _stages_2_to_4(_run_port, segment, "torch")
    for split, (j_dir, t_dir) in {"val": (j_val, t_val), "train": (j_train, t_train)}.items():
        for name in STAGE_FILES[split]:
            assert_same(load_pickle(t_dir / name), load_pickle(j_dir / name), f"{split}/{name}")
    track = load_pickle(t_val / "track.pkl")
    assert len(track) >= 4 and sum(len(p) for t in track.values() for p in t["point"]) > 0
    assert load_pickle(t_val / "trackStatic.pkl") and load_pickle(t_val / "trackDynamic.pkl")


def test_labeler_clis_label_the_chain(segment):
    """Stages 5-6 through the port's CLIs on the port's stage-4 files."""
    val = segment / "torch" / "val"
    if not (val / "trackStatic.pkl").exists():  # this file's first test writes them
        _stages_2_to_4(_run_port, segment, "torch")
    info_path = segment / "infos.pkl"
    static_work, dyn_work = segment / "static_work", segment / "dyn_work"
    _run_port("static_train", [
        "--track", val / "trackStatic.pkl", "--infos", info_path, "--model_type",
        "one_box_est", "--n_epoch", 2, "--batch_size", 2, "--npoints", 256,
        "--n_object_points", 64, "--work_dir", static_work, *CPU])
    model_dir = static_work / "model" / "one_box_est"
    # 2 static tracks: the 90/10 split leaves the eval set empty, so its metrics are
    # empty and every epoch ties at 0 (tdal's train_labeler alike)
    best = json.loads((model_dir / "best.json").read_text())
    assert best == {"epoch": 2, "eval_iou3d_acc": 0.0, "step": 2}
    assert (model_dir / "ckpt_00000002.pt").exists()
    rows = [json.loads(r) for r in (model_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["mode"] for r in rows] == ["train", "val"] * 2
    assert all(np.isfinite(r["total_loss"]) and 0 <= r["seg_acc"] <= 1
               for r in rows if r["mode"] == "train")
    _run_port("static_eval", [
        "--track", val / "trackStatic.pkl", "--infos", info_path, "--model_path", model_dir,
        "--model_type", "one_box_est", "--batch_size", 2, "--npoints", 256,
        "--n_object_points", 64, "--det_annos", val / "det_annos.pkl",
        "--work_dir", static_work, *CPU])
    patched = load_pickle(static_work / "box" / "one_box_est.pkl")
    assert len(patched) == 10  # one per frame

    _run_port("dynamic_train", [
        "--track", val / "trackDynamic.pkl", "--infos", info_path, "--n_epoch", 1,
        "--batch_size", 2, "--npoints", 64, "--n_object_points", 64, "--work_dir", dyn_work,
        *CPU])
    assert (dyn_work / "model" / "best.json").exists()
    _run_port("dynamic_eval", [
        "--track", val / "trackDynamic.pkl", "--infos", info_path, "--model_path",
        dyn_work / "model", "--batch_size", 2, "--npoints", 64, "--n_object_points", 64,
        "--det_annos", static_work / "box" / "one_box_est.pkl", "--work_dir", dyn_work, *CPU])
    final = load_pickle(dyn_work / "box" / "box.pkl")
    assert len(final) == 10
    # the final det_annos rows keep the detector schema
    assert {"name", "score", "boxes_lidar", "frame_id", "metadata"} <= set(final[0])
    # the labelers moved boxes: the static patch and the dynamic patch each changed rows
    unpatched = {d["frame_id"]: d["boxes_lidar"] for d in load_pickle(val / "det_annos.pkl")}
    changed = sum(int((d["boxes_lidar"] != unpatched[d["frame_id"]]).any(axis=1).sum())
                  for d in final)
    assert changed > 0


def test_detector_clis_fit_and_predict(tmp_path):
    """``train`` (one epoch of pp_tiny) then ``dist_test --evaluate`` from its
    checkpoint directory, on the CPU. (No "train" in the test's name: a result path
    holding it makes ``create_pd_detection`` keep the first quarter of the frames.)"""
    infos, _ = make_synthetic_dataset(tmp_path / "data", n_scenes=1, n_frames=4, seed=3,
                                      n_static=2, n_dynamic=1, points_per_object=64,
                                      n_background=256)
    info_path = tmp_path / "data" / "infos.pkl"
    cfg = ROOT / "configs" / "synthetic" / "pp_tiny.py"
    work = tmp_path / "det"
    _run_port("train", [cfg, "--work_dir", work, "--info_path", info_path, "--total_epochs", 1,
                        "--batch_size", 2, "--no_val", *CPU])
    ckpts = sorted((work / "checkpoints").glob("step_*.pt"))
    assert [c.name for c in ckpts] == ["step_00000002.pt"]
    ckpt = torch.load(ckpts[0], weights_only=True)
    assert ckpt["step"] == 2 and all(torch.isfinite(v).all() for v in ckpt["model"].values()
                                     if v.is_floating_point())
    _run_port("dist_test", [cfg, "--work_dir", work / "test", "--checkpoint", work / "checkpoints",
                            "--info_path", info_path, "--batch_size", 2, "--evaluate", *CPU])
    pred = load_pickle(work / "test" / "prediction.pkl")
    assert sorted(pred) == sorted(i["token"] for i in infos)
    for d in pred.values():
        assert d["box3d_lidar"].shape[1] == 9 and np.isfinite(d["box3d_lidar"]).all()
    assert len(load_pickle(work / "test" / "det_annos.pkl")) == 4


def test_static_train_cli_trains_data_parallel_under_torchrun(segment, tmp_path):
    """``static_train --data_parallel`` on two gloo ranks (``torchrun``): the same best
    checkpoint choice as one process, rank 0 alone writing, and the same epoch-1 train
    metrics (one step on the same weights, sets and draws). The seg terms within 1e-5
    relative (its BatchNorms normalise over 512 points); the box terms within 1e-2: the
    box head's (B, C) BatchNorms normalise over the batch's 2 sets with E[x^2] - E[x]^2,
    which turns the sums' float reassociation into 1e-3 relative here."""
    from test_torch_parallel import torchrun

    val = segment / "torch" / "val"
    if not (val / "trackStatic.pkl").exists():  # this file's first test writes them
        _stages_2_to_4(_run_port, segment, "torch")
    args = ["--track", val / "trackStatic.pkl", "--infos", segment / "infos.pkl",
            "--model_type", "one_box_est", "--n_epoch", 2, "--batch_size", 2, "--npoints", 256,
            "--n_object_points", 64, *CPU]
    torchrun("tdal_torch.tools.static_train", [*args, "--work_dir", tmp_path / "dp",
                                               "--data_parallel"])
    _run_port("static_train", [*args, "--work_dir", tmp_path / "single"])
    rows = {}
    for side in ("dp", "single"):
        model_dir = tmp_path / side / "model" / "one_box_est"
        assert json.loads((model_dir / "best.json").read_text()) == \
            {"epoch": 2, "eval_iou3d_acc": 0.0, "step": 2}
        rows[side] = [json.loads(r) for r in
                      (model_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["mode"] for r in rows["dp"]] == ["train", "val"] * 2  # written once
    for k, v in rows["single"][0].items():
        rel = 1e-5 if k in ("mask_loss", "seg_acc", "step") else 1e-2
        assert rows["dp"][0][k] == pytest.approx(v, rel=rel, abs=1e-6), k


def test_detector_clis_write_profiler_traces(tmp_path):
    """``train --profile_dir`` and ``dist_test --profile_dir`` on the CPU each write a
    Chrome trace of their step window (tdal's profiler hooks, through torch.profiler)."""
    infos, _ = make_synthetic_dataset(tmp_path / "data", n_scenes=1, n_frames=4, seed=3,
                                      n_static=2, n_dynamic=1, points_per_object=64,
                                      n_background=256)
    info_path = tmp_path / "data" / "infos.pkl"
    cfg = ROOT / "configs" / "synthetic" / "pp_tiny.py"
    work, prof = tmp_path / "det", tmp_path / "prof"
    _run_port("train", [cfg, "--work_dir", work, "--info_path", info_path, "--total_epochs", 1,
                        "--batch_size", 2, "--no_val", "--profile_dir", prof, *CPU])
    _run_port("dist_test", [cfg, "--work_dir", work / "test", "--checkpoint", work / "checkpoints",
                            "--info_path", info_path, "--batch_size", 2, "--profile_dir", prof,
                            *CPU])
    for name in ("train", "inference"):
        trace = json.loads((prof / f"{name}.trace.json").read_text())
        assert trace["traceEvents"], name


def _messages(log_file):
    """A log file's messages, without the time and level the loggers put before them."""
    return [line.split("  ", 2)[2] for line in Path(log_file).read_text().splitlines()]


def test_create_data_writes_tdals_files(tmp_path):
    """``create_data waymo_data_prep`` on a Waymo-layout root writes the infos pickle, the
    dbinfos pickle and the ``.bin`` crops that ``tools/create_data.py`` writes there, byte
    for byte; with ``--no_gt_database`` the infos only; ``frame_cache`` writes one
    ``.tdc`` a frame; ``nuscenes_data_prep`` raises tdal's ``ImportError`` without the
    nuScenes devkit, as ``tools/create_data.py`` does, and ``waymo_convert`` needs the
    Waymo devkit."""
    from tdal.data.synthetic import SyntheticScene

    for i in range(2):
        SyntheticScene(i, n_frames=5, seed=7, n_static=2, n_dynamic=1, points_per_object=64,
                       n_background=256).write(tmp_path, split="train")
    outputs = {}
    for side, run in (("tdal", _run_tdal), ("port", _run_port)):
        run("create_data.py" if side == "tdal" else "create_data",
            ["waymo_data_prep", "--root_path", tmp_path])
        files = sorted(p for p in tmp_path.rglob("*")
                       if p.is_file() and "train" not in p.relative_to(tmp_path).parts)
        outputs[side] = {p.relative_to(tmp_path): p.read_bytes() for p in files}
        for p in tmp_path.iterdir():
            if p.name != "train":
                shutil.rmtree(p) if p.is_dir() else p.unlink()
    assert outputs["port"].keys() == outputs["tdal"].keys()
    names = {str(p) for p in outputs["port"]}
    assert {"infos_train_01sweeps_filter_zero_gt.pkl",
            "dbinfos_train_1sweeps_withvelo.pkl"} <= names
    assert sum(n.endswith(".bin") for n in names) == 9  # VEHICLE at frames 0, 4 and 8
    for name, data in outputs["port"].items():
        if name.suffix == ".pkl":
            assert_same(pickle.loads(data), pickle.loads(outputs["tdal"][name]), str(name))
        else:
            assert data == outputs["tdal"][name], name
    _run_port("create_data", ["waymo_data_prep", "--root_path", tmp_path, "--split", "train",
                              "--nsweeps", 2, "--no_gt_database"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "infos_train_02sweeps_filter_zero_gt.pkl", "train"]
    _run_port("create_data", ["frame_cache", "--info_path",
                              tmp_path / "infos_train_02sweeps_filter_zero_gt.pkl"])
    assert len(list(tmp_path.rglob("*.tdc"))) == 10
    for side, run in (("tdal", _run_tdal), ("port", _run_port)):  # no nuScenes devkit here
        with pytest.raises(ImportError, match="nuscenes-devkit"):
            run("create_data.py" if side == "tdal" else "create_data",
                ["nuscenes_data_prep", "--root_path", tmp_path])
    with pytest.raises(ImportError, match="waymo_open_dataset"):
        _run_port("create_data", ["waymo_convert", "--records", "a.tfrecord", "--out_root",
                                  tmp_path])


def test_baseline_eval_and_line_search_clis_match_tools(segment, tmp_path, capsys):
    """``static_init``, ``dynamic_init``, ``eval`` and ``waymo_tracking.line_search``
    (``--device cpu``) on the segment's stage-4 files: the same logged and printed
    values, and the same patched det_annos, as their ``tools/`` files."""
    from tdal.data.waymo_schema import transform_box_np

    val = segment / "torch" / "val"
    if not (val / "trackStatic.pkl").exists():  # this file's first test writes them
        _stages_2_to_4(_run_port, segment, "torch")
    info_path = segment / "infos.pkl"
    runs = {"tdal": (_run_tdal, "", []), "port": (_run_port, ".py", CPU)}

    def both(tool, argv, work=None):
        out = {}
        for side, (run, suffix, extra) in runs.items():
            name = tool + ".py" if side == "tdal" else tool.replace("/", ".")
            capsys.readouterr()
            run(name, [*argv, *(["--work_dir", tmp_path / side / work] if work else []),
                       *(extra if tool != "waymo_tracking/line_search" else [])])
            out[side] = capsys.readouterr().out
        return out

    both("static_init", ["--track", val / "trackStatic.pkl", "--infos", info_path,
                         "--det_annos", val / "det_annos.pkl"], "static")
    logs = {s: [m.replace(str(tmp_path / s), "W") for m in
                _messages(tmp_path / s / "static" / "log" / "init.txt")] for s in runs}
    assert logs["port"] == logs["tdal"]
    assert any("[Init]" in m for m in logs["port"]) and any("[Static]" in m for m in logs["port"])
    assert_same(load_pickle(tmp_path / "port" / "static" / "box" / "static_init.pkl"),
                load_pickle(tmp_path / "tdal" / "static" / "box" / "static_init.pkl"))

    both("dynamic_init", ["--track", val / "trackDynamic.pkl", "--infos", info_path], "dynamic")
    logs = {s: _messages(tmp_path / s / "dynamic" / "log" / "init.txt") for s in runs}
    assert logs["port"] == logs["tdal"] and any("[Init]" in m for m in logs["port"])

    # static labels: each track's box at its first frame, in that frame, moved and turned
    # clear of the GT box: where a label's edges nearly coincide with the GT's, the
    # edge-integral IoU of both packages is discontinuous (ROADMAP.md section 3)
    track = load_pickle(val / "track.pkl")
    annos = AnnoStore(reorganize_info(load_pickle(info_path)))
    labels = {}
    for i, (ID, t) in enumerate(track.items()):
        box = transform_box_np(np.asarray(t["bbox"][0], np.float64)[None],
                               annos.inv_pose(t["token"][0]))
        move = np.array([0.3 + 0.1 * (i % 3), -0.2, 0.05, 0, 0, 0, 0.12])
        labels[ID] = {"token": t["token"][0], "bbox": box[0] + move}
    dump_pickle(labels, tmp_path / "static_labels.pkl")
    printed = both("eval", ["--track", val / "track.pkl", "--infos", info_path,
                            "--static", tmp_path / "static_labels.pkl"])
    assert printed["port"] == printed["tdal"] and "mIOU of static" in printed["port"]

    printed = both("waymo_tracking/line_search", [
        "--checkpoint", segment / "prediction.pkl", "--info_path", info_path,
        "--score_thresholds", 0.5, 0.9, "--vehicle_dists", 0.8, 2.0])
    assert printed["port"] == printed["tdal"] and printed["port"].count("tracks") == 4


def test_train_cli_trains_with_gt_aug(tmp_path):
    """``train`` on a config whose ``db_sampler`` is enabled (the refusal is gone): with
    the database that ``create_data waymo_data_prep`` wrote it trains with the sampler
    on, and says so; with the database missing it says the sampler is off."""
    from tdal.data.synthetic import SyntheticScene

    for i in range(2):
        SyntheticScene(i, n_frames=4, seed=5, n_static=3, n_dynamic=1, points_per_object=64,
                       n_background=256).write(tmp_path / "data", split="train")
    _run_port("create_data", ["waymo_data_prep", "--root_path", tmp_path / "data"])
    for case, db in (("on", "dbinfos_train_1sweeps_withvelo.pkl"),
                     ("missing", "dbinfos_train_01sweeps_withvelo.pkl")):  # the configs' name
        cfg = tmp_path / f"pp_tiny_gt_aug_{case}.py"
        cfg.write_text((ROOT / "configs" / "synthetic" / "pp_tiny.py").read_text() + (
            f"\ntrain_preprocessor['db_sampler'] = dict(enable=True, db_info_path="
            f"{str(tmp_path / 'data' / db)!r}, sample_groups=[dict(VEHICLE=15)], "
            f"db_prep_steps=[dict(filter_by_min_num_points=dict(VEHICLE=5))], rate=1.0)\n"))
        work = tmp_path / case
        _run_port("train", [cfg, "--work_dir", work, "--info_path",
                            tmp_path / "data" / "infos_train_01sweeps_filter_zero_gt.pkl",
                            "--total_epochs", 1, "--batch_size", 4, "--no_val", *CPU])
        log = (work / "train.log").read_text()
        want = ("GT-aug database sampler on" if case == "on" else
                "GT-aug database sampler off: its database")
        assert want in log, log
        assert [c.name for c in (work / "checkpoints").glob("step_*.pt")] == ["step_00000002.pt"]
