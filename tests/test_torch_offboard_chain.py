"""The detector-fed offboard chain through the port against tdal (CPU, f32).

A module fixture trains tdal's pp_tiny (``configs/synthetic/pp_tiny.py`` with its own
10 code weights, its ``vel`` head included) for 16 epochs at batch 2 on the segment of
``tests/test_full_pipeline.py::test_full_pipeline_real_detector`` (seed 7, 4 static
and 1 dynamic bus-sized objects, no global augmentation noise), as that test's first
round does, and converts the weights with ``load_flax_pointpillars``.

- The port's ``run_inference`` keeps the boxes tdal's keeps (knife edges counted).
- Stages 2-6 run in both packages from tdal's detections (the port through its driver
  ``tdal_torch.pipeline.offboard.label_chain``), so that a knife edge in NMS cannot move
  the rest: global boxes, tracking ids, det_annos and trackData are equal, the
  reorganised tracks and the static/dynamic split are equal, and the static labeler's
  boxes, the postprocess metrics and the patched det_annos agree within TOL, with the
  labeler weights converted from tdal's. The chain must yield tracks and static boxes.
  This segment's one dynamic object fragments into tracks shorter than 7 frames, so no
  track is dynamic: the dynamic half is held in ``tests/test_torch_labeler_train.py``
  (the train step), ``tests/test_torch_labeling_chain.py`` and
  ``tests/test_torch_cli_chain.py`` (stages 2-6 from fabricated detections).
- The ``.tdc`` frame cache round-trips between the packages, and ``create_pd_detection``
  gives the same output from it as from the pickles.

Tolerances: boxes and scores of the detector 1e-4 of max(1, |x|) (f32 convolutions
summed in another order, as in ``tests/test_torch_detector_infer.py``); labeler boxes
and patched rows TOL = 1e-5 (as in ``tests/test_torch_labeling_chain.py``); metrics
1e-4 absolute.
"""

import importlib.util
import logging
import pickle
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tdal.data import frame_cache as jcache
from tdal.data import track_datasets as jtd
from tdal.data.detection import DetectionDataset as JDetectionDataset
from tdal.data.synthetic import make_synthetic_dataset
from tdal.data.waymo_schema import AnnoStore as JAnnoStore
from tdal.data.waymo_schema import reorganize_info as j_reorganize_info
from tdal.models.builder import build_assigner as jbuild_assigner
from tdal.models.builder import build_detector as jbuild_detector
from tdal.models.builder import build_test_cfg as jbuild_test_cfg
from tdal.models.builder import build_voxel_config as jbuild_voxel_config
from tdal.pipeline import factories as jfac
from tdal.pipeline import labeler_run as jrun
from tdal.pipeline import motion_state as jms
from tdal.pipeline import track_extraction as jte
from tdal.pipeline.detector_run import run_inference as j_run_inference
from tdal.pipeline.detector_run import train_detector as j_train_detector
from tdal.runtime.config import Config as JConfig
from tdal.runtime.train_state import TrainState as JTrainState
from tdal.runtime.train_state import init_model
from tdal_torch.convert import load_flax, load_flax_pointpillars
from tdal_torch.data import frame_cache
from tdal_torch.data.detection import DetectionDataset
from tdal_torch.data.synthetic import fabricate_detections
from tdal_torch.core.iou import boxes_iou_bev
from tdal_torch.data.track_datasets import StaticTrackDataset, batch_iterator
from tdal_torch.data.waymo_schema import AnnoStore, reorganize_info
from tdal_torch.models.builder import (
    build_assigner, build_detector, build_test_cfg, build_voxel_config,
)
from tdal_torch.pipeline import factories as tfac
from tdal_torch.pipeline import track_extraction as tte
from tdal_torch.pipeline.detector_run import run_inference
from tdal_torch.pipeline.offboard import label_chain
from tdal_torch.runtime.config import Config
from tdal_torch.runtime.train_state import TrainState
from test_torch_cli_chain import assert_same
from test_torch_labeling_chain import _decisive, margins

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PP_TINY = ROOT / "configs/synthetic/pp_tiny.py"
NAMES = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]
SEGMENT = dict(n_scenes=1, n_frames=10, seed=7, n_static=4, n_dynamic=1,
               points_per_object=384, n_background=512, object_dims=(10.0, 2.6, 3.2))
DET_TOL, TOL = 1e-4, 1e-5
CHAIN = dict(score_percentile=90, match_iou=0.25, npoints_static=512, npoints_dynamic=64,
             predict_batch=4)
LOG = logging.getLogger("test_torch_offboard_chain")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, flax.core.unfreeze(tree))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """tdal's pp_tiny trained 16 epochs (the real-detector test's first round, with
    the config's 10 code weights), its detections over the segment, and the port's
    detector with the same weights."""
    root = tmp_path_factory.mktemp("offboard")
    infos, _ = make_synthetic_dataset(root / "segment", **SEGMENT)
    jcfg = JConfig.fromfile(str(PP_TINY))
    code_weights = jcfg.model["bbox_head"]["code_weights"]
    jvox = jbuild_voxel_config(jcfg.voxel_generator, train=True)
    jdet = jbuild_detector(jcfg.model, jvox)
    jassigner = jbuild_assigner(jcfg.train_cfg["assigner"], jdet)
    jcfg.test_cfg["score_threshold"] = 0.02  # briefly trained: low confidences
    jtest_cfg = jbuild_test_cfg(jcfg.test_cfg, jdet, jvox)
    train_ds = JDetectionDataset(infos, NAMES, jassigner, jvox, mode="train", max_points=4096,
                                 global_rot_noise=(0.0, 0.0), global_scale_noise=(1.0, 1.0))
    key = jax.random.PRNGKey(0)
    params, bs = init_model(jdet, {"params": key},
                            jnp.asarray(np.stack([train_ds[0]["points"]] * 2)))
    state = JTrainState.create(
        params, optax.chain(optax.clip_by_global_norm(35.0), optax.adam(3e-3)), bs)
    state = j_train_detector(jdet, state, train_ds, jtest_cfg, code_weights, 16, 2, LOG,
                             root / "work", seed=0)
    jval = JDetectionDataset(infos, NAMES, jassigner, jvox, mode="val", max_points=4096,
                             shuffle_points=False)
    detections = j_run_inference(jdet, state, jval, jtest_cfg, code_weights, 2, LOG)

    cfg = Config.fromfile(PP_TINY)
    vox = build_voxel_config(cfg.voxel_generator, train=False)
    model = build_detector(cfg.model, vox, device="cpu")
    load_flax_pointpillars(model, _np_tree(state.params), _np_tree(state.batch_stats))
    test_cfg = build_test_cfg(dict(cfg.test_cfg, score_threshold=0.02), model, vox)
    ds = DetectionDataset(infos, NAMES, build_assigner(cfg.train_cfg["assigner"], model), vox,
                          mode="val", max_points=4096, shuffle_points=False)
    return dict(root=root, infos=infos, detections=detections, model=model,
                test_cfg=test_cfg, ds=ds, nms_iou=jtest_cfg["nms"]["nms_iou_threshold"])


def _bev_iou(a, b):
    return boxes_iou_bev(torch.as_tensor(a[:, [0, 1, 2, 3, 4, 5, -1]]),
                         torch.as_tensor(b[:, [0, 1, 2, 3, 4, 5, -1]])).numpy()


def test_run_inference_keeps_tdal_boxes(trained):
    """Every frame keeps the same boxes, or each box kept on one side only sits on a
    knife edge: its score within DET_TOL of the threshold, or its BEV IoU with a box
    the other side kept within DET_TOL of the NMS threshold."""
    ref = trained["detections"]
    got = run_inference(TrainState(trained["model"], None), trained["ds"],
                        trained["test_cfg"], 2, LOG)
    assert list(got) == list(ref)
    n_boxes, knife_edges = 0, 0
    for token, r in ref.items():
        g = got[token]
        n_boxes += len(r["scores"])
        if len(g["scores"]) == len(r["scores"]) and np.array_equal(g["label_preds"],
                                                                    r["label_preds"]):
            np.testing.assert_allclose(g["box3d_lidar"], r["box3d_lidar"], rtol=DET_TOL,
                                       atol=DET_TOL * max(1.0, np.abs(r["box3d_lidar"]).max()))
            np.testing.assert_allclose(g["scores"], r["scores"], rtol=DET_TOL, atol=DET_TOL)
            continue
        for one, other in ((g, r), (r, g)):
            iou = _bev_iou(one["box3d_lidar"], other["box3d_lidar"])
            for i in np.flatnonzero(iou.max(axis=1, initial=0.0) < 1 - DET_TOL):
                near_thr = abs(float(one["scores"][i]) - 0.02) <= DET_TOL
                near_nms = (np.abs(iou[i] - trained["nms_iou"]) <= DET_TOL).any()
                assert near_thr or near_nms, (token, i, float(one["scores"][i]))
                knife_edges += 1
    assert n_boxes >= 10 * 50  # a trained detector's boxes, not an empty run
    print(f"run_inference: {n_boxes} boxes in tdal's frames, {knife_edges} knife edges")


def _trackdata_reorganize():
    path = ROOT / "tools" / "trackData.py"
    spec = importlib.util.spec_from_file_location("tool_trackData", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.reorganize


def _tdal_chain(detections, infos, out, labeler):
    """tdal's stages 2-5 as tests/test_full_pipeline.py drives them, at CHAIN's
    settings, with the static labeler ``labeler`` = (model, state, inputs_fn, kind)."""
    info_map = j_reorganize_info(infos)
    annos = JAnnoStore(info_map)
    det_annos, _ = jte.create_pd_detection(detections, info_map, out / "det")
    global_preds, det_results = jte.convert_detection_to_global_box(detections, info_map,
                                                                    annos)
    scores = np.concatenate([np.asarray(d["scores"]) for d in detections.values()])
    thresh = float(np.percentile(scores, CHAIN["score_percentile"]))
    predictions, _ = jte.run_tracking(global_preds, det_results, score_thresh=thresh)
    _, frame_track = jte.create_pd_detection(predictions, info_map, out / "track",
                                             tracking=True, match_iou=CHAIN["match_iou"])
    track = _trackdata_reorganize()(frame_track)
    X, y, new_track = jms.track_features(track, jms.build_track_gt(list(info_map.values())))
    clf = jms.fit_motion_classifier(X, y)
    static, dynamic = jms.split_by_prediction(new_track, clf.predict(X) if len(X) else [])
    det_annos = jrun.sort_detections([dict(d, boxes_lidar=d["boxes_lidar"].copy())
                                      for d in det_annos])
    token2idx = jrun.build_token2idx(info_map, annos, det_annos)
    ts, _ = jtd.preprocess_tracks(static, annos, ratio=0.0, seed=0)
    model, state, inputs_fn, kind = labeler
    ds = jtd.StaticTrackDataset(ts, annos, npoints=CHAIN["npoints_static"], seed=0)
    boxes = jrun.predict_final_boxes(model, state, ds, inputs_fn, kind,
                                     batch_size=CHAIN["predict_batch"])
    metrics = jrun.postprocess_static(ts, annos, boxes, LOG, det_annos, token2idx)
    return dict(global_preds=global_preds, predictions=predictions, frame_track=frame_track,
                track=track, track_static=static, track_dynamic=dynamic, static_labeled=ts,
                boxes=boxes, metrics=metrics, det_annos=det_annos, score_thresh=thresh,
                annos=annos)


def _labelers():
    """tdal's fresh one-box and dynamic labelers, made decisive as in
    test_torch_labeling_chain, and the port's with the same weights."""
    key = jax.random.PRNGKey(0)
    out = {}
    for model_type, example in (
        ("one_box_est", (np.zeros((4, CHAIN["npoints_static"], 3), np.float32),
                         np.zeros((4, 7), np.float32), np.zeros((4, 7), np.float32))),
        ("dynamic", (np.zeros((4, 5 * CHAIN["npoints_dynamic"], 4), np.float32),
                     np.zeros((4, 101, 8), np.float32), np.zeros((4, 7), np.float32))),
    ):
        j_model, _, j_inputs, j_kind = jfac.make_labeler(model_type)
        params, bs = init_model(j_model, {"params": key, "gather": key, "dropout": key},
                                *example)
        params = _decisive(jax.tree_util.tree_map(np.array, params), model_type)
        bs = jax.tree_util.tree_map(np.asarray, bs)
        j_state = JTrainState.create(params, optax.adam(1e-3), bs)
        t_model, _, t_inputs, t_kind = tfac.make_labeler(model_type, device="cpu")
        load_flax(t_model, params, bs)
        out[model_type] = ((j_model, j_state, j_inputs, j_kind), (t_model, t_inputs, t_kind))
    return out


def test_chain_from_tdal_detections_matches_tdal(trained, tmp_path_factory):
    root = tmp_path_factory.mktemp("chains")
    labelers = _labelers()
    j = _tdal_chain(trained["detections"], trained["infos"], root / "jax",
                    labelers["one_box_est"][0])
    info_map = reorganize_info(trained["infos"])
    t = label_chain(trained["detections"], info_map, AnnoStore(info_map),
                    (labelers["one_box_est"][1], labelers["dynamic"][1]), root / "torch", LOG,
                    device="cpu", **CHAIN)

    assert t["score_thresh"] == j["score_thresh"]
    for k in ("global_preds", "predictions", "frame_track", "track", "track_static",
              "track_dynamic", "static_labeled"):
        assert_same(t[k], j[k], k)
    counts = t["counts"]
    assert counts["tracks"] > 0 and counts["static_tracks"] > 0, counts
    assert counts["static_boxes_labeled"] > 0, counts
    assert counts["dynamic_tracks"] == len(j["track_dynamic"]) == 0, counts

    # the labeler's decisions sit far from their boundaries, so its boxes compare
    # element by element
    t_model, t_inputs, _ = labelers["one_box_est"][1]
    m = {}  # a fresh dataset replays the same draws
    m_ds = StaticTrackDataset(t["static_labeled"], AnnoStore(info_map),
                              npoints=CHAIN["npoints_static"], seed=0)
    with torch.inference_mode():
        for batch in batch_iterator(m_ds, CHAIN["predict_batch"], pad_to_full=True):
            out = t_model.eval()(*(torch.as_tensor(np.asarray(x)) for x in t_inputs(batch)))
            for name, v in margins({k: v.numpy() for k, v in out.items()}).items():
                m[name] = min(m.get(name, np.inf), v)
    assert min(m.values()) > 100 * TOL, m
    assert t["boxes"]["static"].shape == j["boxes"].shape
    np.testing.assert_allclose(t["boxes"]["static"], j["boxes"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t["metrics"]["static"], j["metrics"], atol=1e-4)
    n_patched = 0
    unpatched = {d["frame_id"]: d["boxes_lidar"] for d in jte.create_pd_detection(
        trained["detections"], j_reorganize_info(trained["infos"]), root / "plain")[0]}
    for a, b in zip(t["det_annos"], j["det_annos"], strict=True):
        assert a["frame_id"] == b["frame_id"]
        np.testing.assert_allclose(a["boxes_lidar"], b["boxes_lidar"], rtol=TOL, atol=TOL)
        n_patched += int((a["boxes_lidar"] != unpatched[a["frame_id"]]).any(axis=1).sum())
    assert n_patched > 0
    print(f"chain: {counts}")


def test_frame_cache_round_trip_and_extraction(tmp_path):
    infos, scenes = make_synthetic_dataset(tmp_path / "seg", n_scenes=1, n_frames=4, seed=5,
                                           n_static=2, n_dynamic=1, points_per_object=64,
                                           n_background=300)
    # one file of each package's writer, read by the other's reader
    pts = np.random.default_rng(0).normal(size=(37, 5)).astype(np.float32)
    frame_cache.write_points_cache(tmp_path / "port.tdc", pts)
    jcache.write_points_cache(tmp_path / "tdal.tdc", pts)
    assert (tmp_path / "port.tdc").read_bytes() == (tmp_path / "tdal.tdc").read_bytes()
    np.testing.assert_array_equal(np.asarray(jcache.read_points_cache(tmp_path / "port.tdc")), pts)
    np.testing.assert_array_equal(frame_cache.read_points_cache(tmp_path / "tdal.tdc"), pts)
    (tmp_path / "bad.tdc").write_bytes((tmp_path / "port.tdc").read_bytes()[:-4])
    with pytest.raises(ValueError, match="TDC body"):
        frame_cache.read_points_cache(tmp_path / "bad.tdc")

    info_map = reorganize_info(infos)
    annos = AnnoStore(info_map)
    detections = fabricate_detections(scenes, annos)
    global_preds, det_results = tte.convert_detection_to_global_box(detections, info_map, annos)
    predictions, _ = tte.run_tracking(global_preds, det_results, score_thresh=0.5)
    from_pickle = tte.create_pd_detection(predictions, info_map, tmp_path / "pickle",
                                          tracking=True, device="cpu")
    assert frame_cache.build_cache(infos) == 4 and frame_cache.build_cache(infos) == 0
    want = jcache.read_frame_points(infos[0]["path"])
    np.testing.assert_array_equal(frame_cache.read_frame_points(infos[0]["path"]), want)
    from_cache = tte.create_pd_detection(predictions, info_map, tmp_path / "cache",
                                         tracking=True, device="cpu")
    assert_same(from_cache, from_pickle)
    for name in ("det_annos.pkl", "trackData.pkl", "tracking_pred.bin.pkl"):
        with open(tmp_path / "cache" / name, "rb") as f, open(tmp_path / "pickle" / name, "rb") as g:
            assert_same(pickle.load(f), pickle.load(g), name)
    assert sum(len(p) for td in from_cache[1].values() for p in td["point"]) > 0
