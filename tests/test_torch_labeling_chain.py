"""Stages 2-6 through tdal and through tdal_torch (device="cpu") on one tiny segment.

Fabricated detections -> tracking -> trackData extraction + reorganisation ->
motion-state split -> static labeler -> dynamic labeler, with the same flax weights
on both sides. Track IDs, reorganised tracks and the static/dynamic split must be
exactly equal; final boxes and the patched det_annos rows agree within TOL (f32 on
both sides, XLA vs torch summation order; measured <= 2e-6 relative).

The seg head's logit bias is offset (class 1 by +5) and the box head's score
columns are scaled by 30 on both sides (``_decisive``), so every seg logit margin
and argmax gap is far from zero; each is asserted to exceed 100x TOL, so no flipped
mask or bin hides behind TOL.
"""

import importlib.util
import logging
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from tdal.data import synthetic as jsyn
from tdal.data import track_datasets as jtd
from tdal.data.waymo_schema import AnnoStore as JAnnoStore
from tdal.data.waymo_schema import reorganize_info as j_reorganize_info
from tdal.pipeline import factories as jfac
from tdal.pipeline import labeler_run as jrun
from tdal.pipeline import motion_state as jms
from tdal.pipeline import track_extraction as jte
from tdal.runtime.train_state import TrainState, init_model
from tdal_torch.convert import load_flax
from tdal_torch.data import synthetic as tsyn
from tdal_torch.data import track_datasets as ttd
from tdal_torch.data.waymo_schema import AnnoStore, reorganize_info
from tdal_torch.pipeline import factories as tfac
from tdal_torch.pipeline import labeler_run as trun
from tdal_torch.pipeline import motion_state as tms
from tdal_torch.pipeline import track_extraction as tte
from test_pipeline_stages import _fabricate_detections
from test_torch_labelers import margins

torch.set_num_threads(2)

TOL = 1e-5
BATCH = 8
SEGMENT = dict(n_scenes=1, n_frames=8, seed=7, n_static=3, n_dynamic=3,
               points_per_object=128, n_background=2000)
NPOINTS_STATIC, NPOINTS_DYNAMIC = 256, 64
LOG = logging.getLogger("test_torch_labeling_chain")


def _trackdata_reorganize():
    path = Path(__file__).resolve().parent.parent / "tools" / "trackData.py"
    spec = importlib.util.spec_from_file_location("tool_trackData", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.reorganize


def _stages_2_to_4(pkg, root, scenes_infos):
    """Tracking, extraction, reorganisation, motion split with one package."""
    syn, te, ms, reorganize, store, reorg_info, extra = pkg
    infos, scenes = scenes_infos
    info_map = reorg_info(infos)
    annos = store(info_map)
    detections = syn(scenes, annos)
    global_preds, det_results = te.convert_detection_to_global_box(detections, info_map, annos)
    predictions, _ = te.run_tracking(global_preds, det_results, score_thresh=0.5)
    det_annos, _ = te.create_pd_detection(detections, info_map, root / "det", **extra)
    _, frame_track = te.create_pd_detection(
        predictions, info_map, root / "track", tracking=True, **extra
    )
    track = reorganize(frame_track)
    X, y, new_track = ms.track_features(track, ms.build_track_gt(infos))
    clf = ms.fit_motion_classifier(X, y)
    static, dynamic = ms.split_by_prediction(new_track, clf.predict(X))
    return dict(detections=detections, predictions=predictions, det_annos=det_annos,
                track=track, static=static, dynamic=dynamic, annos=annos,
                info_map=info_map)


HEAD = {"one_box_est": "PointNetBoxEst_0", "dynamic": "EmbeddingBoxHead_0"}
SCORE_COLUMNS = np.r_[3:15, 27:30]  # heading and size-cluster scores of the 59-dim head


def _decisive(params, model_type):
    """Offset the seg logit bias (class 1 by +5) and scale the box head's score
    columns by 30, on the weights both sides load: fresh-init score gaps reach 4e-4,
    too close to TOL for the argmax decode to be a fair comparison."""
    params["PointNetSeg_0"]["Dense_0"]["bias"] = np.array([-5.0, 5.0], np.float32)
    out = params[HEAD[model_type]]["Dense_0"]
    out["kernel"][:, SCORE_COLUMNS] *= 30.0
    out["bias"][SCORE_COLUMNS] *= 30.0
    return params


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    jax_side = _stages_2_to_4(
        (_fabricate_detections, jte, jms, _trackdata_reorganize(), JAnnoStore,
         j_reorganize_info, {}),
        root / "jax", jsyn.make_synthetic_dataset(root / "jax", **SEGMENT),
    )
    torch_side = _stages_2_to_4(
        (tsyn.fabricate_detections, tte, tms, tte.reorganize, AnnoStore, reorganize_info,
         {"device": "cpu"}),
        root / "torch", tsyn.make_synthetic_dataset(root / "torch", **SEGMENT),
    )
    return jax_side, torch_side


def test_detections_and_tracking_ids_equal(chain):
    j, t = chain
    assert j["detections"].keys() == t["detections"].keys()
    for tok in j["detections"]:
        for k, v in j["detections"][tok].items():
            np.testing.assert_array_equal(t["detections"][tok][k], v)
    assert j["predictions"].keys() == t["predictions"].keys()
    for tok, p in j["predictions"].items():
        for k, v in p.items():
            np.testing.assert_array_equal(t["predictions"][tok][k], v, err_msg=k)


def test_reorganised_tracks_equal(chain):
    j, t = chain
    assert list(j["track"]) == list(t["track"])
    assert len(j["track"]) >= SEGMENT["n_static"] + SEGMENT["n_dynamic"]
    for tid, jt in j["track"].items():
        tt = t["track"][tid]
        assert tt.keys() == jt.keys()
        for k in ("type", "score", "match", "token"):
            assert tt[k] == jt[k], (tid, k)
        for k in ("bbox", "point"):
            assert len(tt[k]) == len(jt[k])
            for a, b in zip(tt[k], jt[k]):
                np.testing.assert_array_equal(a, b, err_msg=f"{tid} {k}")
    n_points = sum(len(p) for tr in t["track"].values() for p in tr["point"])
    assert n_points > 0


def test_motion_split_equal(chain):
    j, t = chain
    assert list(t["static"]) == list(j["static"])
    assert list(t["dynamic"]) == list(j["dynamic"])
    assert t["static"] and t["dynamic"]


def _labelers(kind, j, t):
    """(tdal final boxes, port final boxes, port inputs' margins) for one labeler."""
    model_type = "one_box_est" if kind == "static" else "dynamic"
    keys = ("pts", "init_box", "bbox_gt") if kind == "static" else ("pts", "boxes", "bbox_gt")

    def dataset(pkg, side):
        if kind == "static":
            tracks, _ = pkg.preprocess_tracks(side["static"], side["annos"], ratio=0.0, seed=0)
            return tracks, pkg.StaticTrackDataset(tracks, side["annos"], npoints=NPOINTS_STATIC)
        return side["dynamic"], pkg.DynamicTrackDataset(
            side["dynamic"], side["annos"], npoints=NPOINTS_DYNAMIC
        )

    j_model, _, j_inputs, j_kind = jfac.make_labeler(model_type)
    item = dataset(jtd, j)[1][0]  # its own dataset: indexing one draws from its rng
    example = tuple(np.repeat(np.asarray(item[k])[None], BATCH, 0) for k in keys)
    key = jax.random.PRNGKey(0)
    params, bs = init_model(j_model, {"params": key, "gather": key, "dropout": key}, *example)
    params = _decisive(jax.tree_util.tree_map(np.array, params), model_type)
    bs = jax.tree_util.tree_map(np.asarray, bs)
    state = TrainState.create(params, optax.adam(1e-3), bs)
    j_tracks, j_ds = dataset(jtd, j)
    j_boxes = jrun.predict_final_boxes(j_model, state, j_ds, j_inputs, j_kind, batch_size=BATCH)

    t_tracks, t_ds = dataset(ttd, t)
    t_model, _, t_inputs, t_kind = tfac.make_labeler(model_type, device="cpu")
    load_flax(t_model, params, bs)
    t_boxes = trun.predict_final_boxes(t_model, t_ds, t_inputs, t_kind, batch_size=BATCH,
                                       device="cpu")
    # the same batches again (a fresh dataset replays the draws) for the margins
    _, m_ds = dataset(ttd, t)
    m = {}
    with torch.inference_mode():
        for batch in ttd.batch_iterator(m_ds, BATCH, pad_to_full=True):
            out = t_model(*(torch.as_tensor(np.asarray(x)) for x in t_inputs(batch)))
            for name, v in margins({k: v.numpy() for k, v in out.items()}).items():
                m[name] = min(m.get(name, np.inf), v)
    return (j_tracks, j_boxes), (t_tracks, t_boxes), m


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_labeled_boxes_and_patched_det_annos_match(chain, kind):
    j, t = chain
    (j_tracks, j_boxes), (t_tracks, t_boxes), m = _labelers(kind, j, t)
    assert min(m.values()) > 100 * TOL, m
    assert list(j_tracks) == list(t_tracks)
    assert t_boxes.shape == j_boxes.shape and len(t_boxes) > 0
    np.testing.assert_allclose(t_boxes, j_boxes, rtol=TOL, atol=TOL)

    post = {"static": (jrun.postprocess_static, trun.postprocess_static),
            "dynamic": (jrun.postprocess_dynamic, trun.postprocess_dynamic)}[kind]
    results = []
    for side, run, tracks, boxes, extra in (
        (j, post[0], j_tracks, j_boxes, {}),
        (t, post[1], t_tracks, t_boxes, {"device": "cpu"}),
    ):
        det_annos = [dict(d, boxes_lidar=d["boxes_lidar"].copy()) for d in side["det_annos"]]
        det_annos = (jrun if side is j else trun).sort_detections(det_annos)
        token2idx = (jrun if side is j else trun).build_token2idx(
            side["info_map"], side["annos"], det_annos
        )
        metrics = run(tracks, side["annos"], boxes, LOG, det_annos, token2idx, **extra)
        results.append((metrics, det_annos))
    (j_metrics, j_det), (t_metrics, t_det) = results
    np.testing.assert_allclose(t_metrics, j_metrics, atol=1e-4)
    n_patched = 0
    for a, b in zip(t_det, j_det, strict=True):
        assert a["frame_id"] == b["frame_id"]
        np.testing.assert_allclose(a["boxes_lidar"], b["boxes_lidar"], rtol=TOL, atol=TOL)
        n_patched += int((a["boxes_lidar"] != np.asarray(
            next(d for d in t["det_annos"] if d["frame_id"] == a["frame_id"])["boxes_lidar"]
        )).any(axis=1).sum())
    assert n_patched > 0


def _boxes(rng, n):
    return np.concatenate(
        [rng.uniform(-3, 3, (n, 3)), rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
        axis=1,
    ).astype(np.float32)


def test_crop_and_iou_geometry_match_tdal():
    """The device crop's points-in-box test and the rotated IoUs behind GT matching
    and the labeler metrics, on random boxes plus identical and touching pairs.
    Tolerance GEOM_TOL: f32 on both sides, the same arithmetic in another order."""
    from tdal.core.geometry import points_in_rbbox as j_inside
    from tdal.core.iou import boxes_iou_3d as j_iou3d
    from tdal.core.iou import labeler_box3d_iou as j_labeler_iou
    from tdal_torch.core.geometry import points_in_rbbox
    from tdal_torch.core.iou import boxes_iou_3d, labeler_box3d_iou

    geom_tol = 1e-5
    rng = np.random.default_rng(11)
    a, b = _boxes(rng, 12), _boxes(rng, 9)
    b[0] = a[0]  # identical
    b[1] = a[1]
    b[1, 0] += a[1, 3] * np.cos(a[1, 6])  # sharing the edge at +length/2
    b[1, 1] += a[1, 3] * np.sin(a[1, 6])
    pts = rng.uniform(-6, 6, (500, 3)).astype(np.float32)

    inside = points_in_rbbox(torch.from_numpy(pts), torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(inside, np.asarray(j_inside(pts, a)))
    assert 0 < inside.sum() < inside.size

    iou = boxes_iou_3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(iou, np.asarray(j_iou3d(a, b)), rtol=0, atol=geom_tol)
    assert iou[0, 0] == pytest.approx(1.0, abs=geom_tol)
    # the touching pair: tdal counts one shared edge's line integral without its
    # partner and reports a spurious overlap; the port keeps tdal's arithmetic
    assert iou[1, 1] > 1.0

    got = labeler_box3d_iou(torch.from_numpy(a[:9]), torch.from_numpy(b))
    want = j_labeler_iou(a[:9], b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=geom_tol)
