"""The port's spans and counters (``tdal_torch.runtime.tracing``) on the CPU: nothing
is recorded off a profiler; a train step's phases nest under ``train.step`` in the
trace, and a two-stage predict step's under ``predict.step``; the NMS, sparse-gather,
batch-build, sweep-merge and RoI counts match counts made by hand; the hand kernels'
launches are in the snapshot; ``summarize`` reads spans, launches and idle gaps back
from a Chrome trace built by hand."""

import json
import logging
import pickle

import numpy as np
import pytest
import torch

from tdal_torch.core import nms
from tdal_torch.ops import conv3x3, sparse_conv
from tdal_torch.pipeline import detector_run
from tdal_torch.runtime import tracing

torch.set_num_threads(2)

CONFIG = "configs/synthetic/pp_tiny.py"


def _diff(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_off_a_profiler_nothing_is_recorded(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called off a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.recording()
    before = tracing.counters()
    first, second = tracing.span("train.step"), tracing.span("predict.nms")
    assert first is second  # one shared no-op context
    with first:
        tracing.count_device("sparse.pairs", torch.ones(3))
    assert not any(k.startswith("traced.") for k in _diff(before, tracing.counters()))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """pp_tiny on the CPU over four synthetic frames: (model, dataset, config)."""
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config
    from tdal_torch.runtime.config import Config

    cfg = Config.fromfile(CONFIG)
    vox = build_voxel_config(cfg.voxel_generator)
    model = build_detector(cfg.model, vox, device="cpu", seed=0)
    infos, _ = make_synthetic_dataset(tmp_path_factory.mktemp("data"), n_scenes=1,
                                      n_frames=4, seed=2, n_background=300,
                                      points_per_object=32)
    ds = DetectionDataset(infos, cfg.class_names, build_assigner(cfg.assigner, model), vox,
                          max_points=1024)
    return model, ds, cfg


def test_data_batch_counts_the_batches_of_detection_batches(tiny):
    _, ds, _ = tiny
    before = tracing.counters()
    batches = list(detector_run.detection_batches(ds, 3))
    d = _diff(before, tracing.counters())
    assert len(batches) == 2 and d["data.batch.n"] == 2 and d["data.batch.s"] > 0
    assert d["data.wait.n"] >= 2


def test_data_sweeps_times_the_sweep_merge_of_each_frame(tmp_path):
    from tdal_torch.data.detection import read_points

    rng = np.random.default_rng(3)
    infos = []
    for i in range(3):
        for name in (f"f{i}.pkl", f"s{i}.pkl"):
            with open(tmp_path / name, "wb") as f:
                pickle.dump({"lidars": {"points_xyz": rng.normal(size=(50, 3)).astype(np.float32),
                                        "points_feature": rng.random((50, 2)).astype(np.float32)}}, f)
        infos.append({"path": str(tmp_path / f"f{i}.pkl"), "sweeps": [
            {"path": str(tmp_path / f"s{i}.pkl"), "transform_matrix": np.eye(4), "time_lag": 0.1}]})
    before = tracing.counters()
    assert read_points(infos[0]).shape == (50, 5)  # one sweep: no merge, nothing counted
    assert "data.sweeps.n" not in _diff(before, tracing.counters())
    assert all(read_points(info, nsweeps=2).shape == (100, 6) for info in infos)
    d = _diff(before, tracing.counters())
    assert d["data.sweeps.n"] == 3 and d["data.sweeps.s"] > 0


def test_a_train_step_writes_its_phases_nested_under_train_step(tiny, tmp_path):
    from tdal_torch.pipeline.detector_engine import make_detector_steps
    from tdal_torch.runtime.schedules import adam_with_schedule
    from tdal_torch.runtime.train_state import TrainState

    model, ds, cfg = tiny
    head = cfg.model["bbox_head"]
    opt = adam_with_schedule(model.parameters(), lambda n: 1e-3, 0.01, 35.0)
    step = make_detector_steps(model, head["code_weights"], head["weight"])
    batch = next(iter(detector_run.detection_batches(ds, 2)))
    cpu = torch.device("cpu")
    prof = detector_run.start_trace(cpu)  # the ``.start()`` form the benchmark uses
    assert tracing.recording()
    step(TrainState(model, opt), batch)
    path = detector_run.stop_trace(prof, tmp_path, "train", cpu)
    assert not tracing.recording()
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e["name"].split(".")[0] in tracing.SPAN_LAYERS):  # not torch's own
            assert e["name"] not in spans, e["name"]  # one step: one of each
            spans[e["name"]] = (e["ts"], e["ts"] + e["dur"])
    phases = ["train.to_device", "train.forward", "train.loss", "train.backward",
              "train.optimizer"]
    a, b = spans["train.step"]
    for name in phases + ["model.voxelize", "model.reader", "model.rpn_head"]:
        assert a <= spans[name][0] <= spans[name][1] <= b, name
    starts = [spans[n][0] for n in phases]
    assert starts == sorted(starts)
    a, b = spans["train.optimizer"]
    assert a <= spans["optimizer.clip"][0] < spans["optimizer.update"][0] <= b
    summary = tracing.summarize(path)["spans"]
    assert summary["train.step"]["n"] == 1 and summary["train.step"]["host_s"] > 0


def test_a_two_stage_predict_step_writes_its_phases_nested_under_predict_step(tmp_path):
    from tdal_torch.models.builder import (
        build_detector, build_test_cfg, build_two_stage_engine, build_voxel_config,
    )
    from tdal_torch.pipeline.two_stage_engine import make_two_stage_steps
    from tdal_torch.runtime.config import Config
    from tdal_torch.runtime.train_state import TrainState

    cfg = Config.fromfile("configs/synthetic/pp_two_stage_tiny.py")
    vox = build_voxel_config(cfg.voxel_generator, train=False)
    first = build_detector(cfg.model["first_stage_cfg"], vox, device="cpu")
    test_cfg = dict(build_test_cfg(cfg.test_cfg, first, vox), score_threshold=0.0)
    engine = build_two_stage_engine(cfg.model, vox, test_cfg, device="cpu")
    rng = np.random.default_rng(1)
    pts = rng.uniform([-20, -20, -1.5, 0, 0], [40, 20, 2.0, 1, 1], (2, 1500, 5))
    points = torch.as_tensor(pts, dtype=torch.float32)
    step = make_two_stage_steps(engine)[1]
    before = tracing.counters()
    cpu = torch.device("cpu")
    prof = detector_run.start_trace(cpu)
    out = step(TrainState(engine, None), points)
    path = detector_run.stop_trace(prof, tmp_path, "predict", cpu)
    d = _diff(before, tracing.counters())
    post_max = test_cfg["nms"]["nms_post_max_size"]
    assert d["predict.steps"] == 1
    assert d["two_stage.rois"] == d["traced.two_stage.rois"] == 2 * post_max
    assert d["traced.two_stage.rois_valid"] == int(out["valid"].sum()) > 0
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e["name"].split(".")[0] in tracing.SPAN_LAYERS):
            spans.setdefault(e["name"], (e["ts"], e["ts"] + e["dur"]))
    phases = ["predict.forward", "predict.decode", "predict.nms", "two_stage.bev_gather",
              "two_stage.roi_head", "two_stage.rescore"]
    a, b = spans["predict.step"]
    for name in phases + ["model.voxelize", "model.rpn_head"]:
        assert a <= spans[name][0] <= spans[name][1] <= b, name
    starts = [spans[n][0] for n in phases]
    assert starts == sorted(starts)
    summary = tracing.summarize(path)["spans"]
    assert all(summary[n]["n"] == 1 for n in phases[3:])


def _line(n, apart):
    """``n`` centres on a line, ``apart`` metres apart, scores falling along it."""
    centers = torch.stack([torch.arange(n, dtype=torch.float32) * apart,
                           torch.zeros(n)], dim=1)
    return centers, torch.linspace(1.0, 0.5, n)


@pytest.mark.parametrize("n,apart,post_max,rounds,kept", [
    (40, 10.0, 50, 2, 40),  # 32 + 8 live, nothing suppressed, then an empty look
    (40, 10.0, 16, 1, 16),  # a tile of 16 fills post_max: no further look
    (40, 0.0, 50, 1, 1),  # the first suppresses every other one
])
def test_nms_counts_its_rounds_and_waits(n, apart, post_max, rounds, kept):
    centers, scores = _line(n, apart)
    before = tracing.counters()
    _, valid = nms.circle_nms(centers, scores, 1.0, post_max)
    d = _diff(before, tracing.counters())
    looked_again = int(kept < post_max)  # a last ``nonzero`` that finds nothing live
    assert d["nms.calls"] == 1 and d["nms.rounds"] == rounds
    assert d["nms.host_syncs"] == 3 * rounds + looked_again
    assert d["nms.kept"] == kept == int(valid.sum())


def _voxels(rng, b, v, grid, n_valid):
    coords = np.zeros((b, v, 3), np.int64)
    valid = np.zeros((b, v), bool)
    cells = np.stack(np.meshgrid(*[np.arange(g) for g in grid], indexing="ij"), -1)
    cells = cells.reshape(-1, 3)
    for i in range(b):
        pick = rng.choice(len(cells), n_valid[i], replace=False)
        coords[i, : n_valid[i]] = cells[pick]
        valid[i, : n_valid[i]] = True
    return torch.as_tensor(coords), torch.as_tensor(valid)


def _pairs(coords, valid, sites, site_valid, stride):
    """Brute force: (site, tap) pairs whose input voxel exists, over ``OFFSETS_3``."""
    n = 0
    for i in range(coords.shape[0]):
        have = {tuple(c) for c, ok in zip(coords[i].tolist(), valid[i].tolist()) if ok}
        for o, ok in zip(sites[i].tolist(), site_valid[i].tolist()):
            if ok:
                n += sum(tuple(s * x + d for s, x, d in zip(stride, o, off)) in have
                         for off in sparse_conv.OFFSETS_3.tolist())
    return n


def test_sparse_counts_match_a_brute_force_count():
    rng = np.random.default_rng(5)
    grid, b, v, cin = (4, 6, 6), 2, 24, 3
    coords, valid = _voxels(rng, b, v, grid, [20, 13])
    feats = torch.as_tensor(rng.normal(size=(b, v, cin)), dtype=torch.float32)
    coords, feats, valid, keys = sparse_conv.sort_voxels(coords, feats, valid, grid)
    w = torch.ones(27, cin, 2)
    v_out = 16
    before = tracing.counters()
    prof = detector_run.start_trace(torch.device("cpu"))
    sparse_conv.subm_conv3d(coords, feats, valid, keys, grid, w)
    out_coords, _, out_valid, _ = sparse_conv.sparse_conv3d_down2(coords, feats, valid, keys,
                                                                  grid, w, v_out)
    prof.stop()
    d = _diff(before, tracing.counters())
    want = (_pairs(coords, valid, coords, valid, (1, 1, 1))
            + _pairs(coords, valid, out_coords, out_valid, (2, 2, 2)))
    assert d["traced.sparse.pairs"] == want
    rows = 27 * b * (v + v_out)
    assert d["sparse.rows_gathered"] == d["traced.sparse.rows_gathered"] == rows


def test_counters_carry_the_hand_kernels_launches(monkeypatch):
    before = tracing.counters()
    monkeypatch.setitem(conv3x3.launches, "conv3x3_fwd", conv3x3.launches["conv3x3_fwd"] + 5)
    monkeypatch.setitem(conv3x3.halo_launches, "conv3x3_wgrad",
                        conv3x3.halo_launches["conv3x3_wgrad"] + 2)
    assert _diff(before, tracing.counters()) == {"conv3x3.launches.conv3x3_fwd": 5,
                                                 "conv3x3.halo_launches.conv3x3_wgrad": 2}


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summarize_reads_spans_launches_and_idle_from_a_trace(tmp_path):
    """One step by hand (times in us): its phases' launches, their kernels by
    correlation id, the idle gaps under the spans open when each began."""
    events = [
        _x("user_annotation", "train.step", 0, 100),
        _x("user_annotation", "train.forward", 10, 30),
        _x("user_annotation", "train.optimizer", 50, 40),
        _x("user_annotation", "ProfilerStep#1", 0, 100),  # not the program's
        _x("cuda_runtime", "cudaLaunchKernel", 15, 2, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 2, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 2, 3),
        _x("cuda_runtime", "cudaMemcpyAsync", 70, 2, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 2, 5),  # outside every span
        _x("kernel", "k1", 16, 14, 1),
        _x("kernel", "k2", 30, 15, 2),
        _x("kernel", "k3", 70, 10, 3),
        _x("gpu_memcpy", "Memcpy HtoD", 85, 3, 4),
        _x("kernel", "k5", 200, 10, 5),
        _x("gpu_user_annotation", "train.forward", 16, 29),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tracing.summarize(path)
    assert set(s["spans"]) == {"train.step", "train.forward", "train.optimizer"}
    step, fwd, opt = (s["spans"][n] for n in ("train.step", "train.forward",
                                              "train.optimizer"))
    assert (step["n"], step["launches"], fwd["launches"], opt["launches"]) == (1, 3, 2, 1)
    assert step["host_s"] == pytest.approx(100e-6)
    assert fwd["device_s"] == pytest.approx(29e-6)  # k1 start to k2 end
    assert opt["device_s"] == pytest.approx(18e-6)  # k3 start to the copy's end
    assert step["device_s"] == pytest.approx(72e-6)
    assert fwd["annotated_s"] == pytest.approx(29e-6)
    # gaps: 45-70 inside train.step; 80-85 inside train.step and train.optimizer;
    # 88-200 inside train.step and train.optimizer (which ends at 90)
    assert s["idle_total_s"] == pytest.approx(142e-6)
    assert s["idle_s"]["train.step"] == pytest.approx(142e-6)
    assert s["idle_s"]["train.optimizer"] == pytest.approx(117e-6)
    assert tracing.OUTSIDE not in s["idle_s"]
    late = events + [_x("cuda_runtime", "cudaLaunchKernel", 250, 2, 6),
                     _x("kernel", "k6", 260, 5, 6)]
    assert tracing.summarize(late)["idle_s"][tracing.OUTSIDE] == pytest.approx(50e-6)
    lines = tracing.summary_lines(s)
    assert lines[-1].startswith("device idle 0.142 ms") and len(lines) == 4
    logging.getLogger("t").info("\n".join(lines))
