"""PointPillars inference in the port against tdal, on the CPU: decode, the two greedy
NMS variants, post-processing and predict, double-flip TTA, the predict steps,
``run_inference``, ``evaluate_detector`` and the AP/APH evaluator, and validation
inside ``train_detector``. Inputs come from seeded numpy; the detector is the
``configs/synthetic/pp_tiny.py`` PointPillars (9-column boxes: it has a velocity head)
with tdal's flax init converted by ``load_flax_pointpillars``.

The heatmap's score threshold is 0.1 and a fresh head's heatmap bias is -2.19, so a
fresh detector scores sigmoid(-2.19) = 0.1007 at nearly every pixel: which of those
pass the threshold is decided by the last bits of two libraries' sums. The detector
tests therefore set the final heatmap bias to 0 on both sides (scores spread around
0.5), and the map tests move random heatmap logits at least 0.01 away from
logit(0.1). What is compared is the decision, not a coin flip.

Tolerances:
- kept indices, valid slots and labels: exactly equal;
- decoded maps and kept boxes or scores: rtol 1e-5, atol 1e-5 x max(1, max |ref|)
  for maps built directly from numpy (the same f32 operations, with each library's
  sigmoid, exp and atan2); 1e-4 for the detector's outputs (f32 convolutions summed in
  another order, as in ``tests/test_torch_detector_train.py``);
- AP/APH: equal to 1e-9 (the same numpy arithmetic on IoUs that agree to f32
  rounding, none of them at a threshold).
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
import optax

from tdal.core import nms as jnms
from tdal.data.detection import DetectionDataset as JDetectionDataset
from tdal.models import center_head as jhead
from tdal.models import tta as jtta
from tdal.models.builder import build_assigner as jbuild_assigner
from tdal.models.builder import build_detector as jbuild_detector
from tdal.models.builder import build_test_cfg as jbuild_test_cfg
from tdal.models.builder import build_voxel_config as jbuild_voxel_config
from tdal.pipeline import detector_engine as jengine
from tdal.pipeline import detector_run as jrun
from tdal.runtime.config import Config as JConfig
from tdal.runtime.train_state import TrainState as JTrainState
from tdal.runtime.train_state import init_model
from tdal.utils import detection_metrics as jdm
from tdal_torch.convert import load_flax_pointpillars
from tdal_torch.core import nms
from tdal_torch.core.iou import boxes_iou_bev
from tdal_torch.data.detection import DetectionDataset
from tdal_torch.data.synthetic import make_synthetic_dataset
from tdal_torch.data.waymo_schema import reorganize_info
from tdal_torch.models import center_head as head
from tdal_torch.models import tta
from tdal_torch.models.builder import (
    build_assigner, build_detector, build_test_cfg, build_voxel_config,
)
from tdal_torch.pipeline import detector_engine as engine
from tdal_torch.pipeline import detector_run as run
from tdal_torch.runtime import schedules
from tdal_torch.runtime.config import Config
from tdal_torch.runtime.train_state import TrainState
from tdal_torch.utils import detection_metrics as dm

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PP_TINY = ROOT / "configs/synthetic/pp_tiny.py"
LOGIT_THR = float(np.log(0.1 / 0.9))  # the logit of the 0.1 score threshold
MAP_CFG = dict(post_center_limit_range=[-12.0, -10.0, -10.0, 12.0, 10.0, 10.0],
               nms=dict(nms_pre_max_size=200, nms_post_max_size=24, nms_iou_threshold=0.3),
               score_threshold=0.1, pc_range=[-10.0, -8.0], out_size_factor=2,
               voxel_size=[0.5, 0.5])


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _maps(seed, b=2, h=16, w=20, n_cls=3, vel=True):
    """Random per-task head maps, with the heatmap logits kept at least 0.01 from the
    score threshold's logit."""
    rng = np.random.default_rng(seed)
    hm = rng.normal(-1.0, 1.5, (b, h, w, n_cls)).astype(np.float32)
    near = np.abs(hm - LOGIT_THR) < 0.01
    hm[near] += np.float32(0.02) * np.sign(hm[near] - LOGIT_THR + 1e-9)
    maps = {"reg": rng.uniform(0, 1, (b, h, w, 2)), "height": rng.normal(size=(b, h, w, 1)),
            "dim": rng.normal(0.3, 0.3, (b, h, w, 3)), "rot": rng.normal(size=(b, h, w, 2)),
            "hm": hm}
    if vel:
        maps["vel"] = rng.normal(size=(b, h, w, 2))
    return {k: np.asarray(v, np.float32) for k, v in maps.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# decode and NMS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activated", [False, True])
@pytest.mark.parametrize("vel", [False, True], ids=["7-col", "9-col"])
def test_decode_preds_matches_tdal(vel, activated):
    maps = _maps(0, vel=vel)
    if activated:  # probabilities and sizes, as the double-flip merge hands them over
        maps["hm"] = 1 / (1 + np.exp(-maps["hm"]))
        maps["dim"] = np.exp(maps["dim"])
    boxes_ref, hm_ref = jhead.decode_preds(_j(maps), MAP_CFG, activated=activated)
    boxes, hm = head.decode_preds(_t(maps), MAP_CFG, activated=activated)
    assert boxes.shape == boxes_ref.shape == (2, 320, 9 if vel else 7)
    _close(boxes.numpy(), boxes_ref)
    _close(hm.numpy(), hm_ref)


def _clusters(rng, n_clusters=6, per_cluster=5):
    """Boxes in tight clusters: overlaps well above and well below any threshold."""
    c = rng.uniform(-40, 40, (n_clusters, 1, 2))
    n = n_clusters * per_cluster
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = (c + rng.uniform(-0.6, 0.6, (n_clusters, per_cluster, 2))).reshape(n, 2)
    boxes[:, 2] = rng.uniform(-1, 1, n)
    boxes[:, 3:6] = rng.uniform((3.5, 1.6, 1.4), (4.5, 2.0, 1.8), (n, 3))
    boxes[:, 6] = rng.uniform(-0.4, 0.4, n)
    return boxes


def _nms_case(name):
    """(boxes, scores, iou threshold, pre_max, post_max) of a rotated NMS case."""
    rng = np.random.default_rng(3)
    boxes = _clusters(rng)
    scores = rng.uniform(0.1, 1.0, len(boxes)).astype(np.float32)
    if name == "masked":  # -inf scores: never kept, never suppress
        scores[rng.choice(len(boxes), 12, replace=False)] = -np.inf
    elif name == "ties":  # equal scores keep their input order
        scores = np.round(scores * 4) / 4
    elif name == "post-max":
        return boxes, scores, 0.1, 64, 3
    elif name == "pre-max":
        return boxes, scores, 0.5, 7, 16
    elif name == "many":  # more live candidates than one tile of 32
        boxes = _clusters(rng, n_clusters=40, per_cluster=3)
        scores = rng.uniform(0.1, 1.0, len(boxes)).astype(np.float32)
        return boxes, scores, 0.2, 100, 64
    return boxes, scores, 0.5, 64, 16


def _sequential_greedy(boxes, scores, thr, pre_max, post_max):
    """Plain greedy, one candidate at a time, on the port's BEV IoU."""
    order = np.argsort(-scores, kind="stable")[:pre_max]
    iou = boxes_iou_bev(torch.from_numpy(boxes[order]), torch.from_numpy(boxes[order])).numpy()
    kept = []
    for i in range(len(order)):
        if np.isfinite(scores[order[i]]) and all(iou[k, i] <= thr for k in kept):
            kept.append(i)
    return [int(order[i]) for i in kept][:post_max]


@pytest.mark.parametrize("case", ["clusters", "masked", "ties", "post-max", "pre-max", "many"])
def test_rotated_nms_keeps_what_tdal_keeps(case):
    boxes, scores, thr, pre_max, post_max = _nms_case(case)
    idx_ref, valid_ref = jnms.rotated_nms(boxes, scores, thr, pre_max, post_max)
    idx, valid = nms.rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                                 pre_max, post_max)
    assert idx.shape == valid.shape == (post_max,)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))
    np.testing.assert_array_equal(idx.numpy()[valid.numpy()],
                                  np.asarray(idx_ref)[np.asarray(valid_ref)])
    assert idx.numpy()[valid.numpy()].tolist() == _sequential_greedy(boxes, scores, thr,
                                                                    pre_max, post_max)
    assert 0 < valid.sum() <= post_max


@pytest.mark.parametrize("case", ["random", "masked-ties", "post-max"])
def test_circle_nms_keeps_what_tdal_keeps(case):
    rng = np.random.default_rng(4)
    centers = rng.uniform(-20, 20, (60, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, 60).astype(np.float32)
    post_max = 60
    if case == "masked-ties":
        scores = np.round(scores * 3) / 3
        scores[::7] = -np.inf
    elif case == "post-max":
        post_max = 5
    idx_ref, valid_ref = jnms.circle_nms(centers, scores, 4.0, post_max_size=post_max)
    idx, valid = nms.circle_nms(torch.from_numpy(centers), torch.from_numpy(scores), 4.0,
                                post_max)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))
    np.testing.assert_array_equal(idx.numpy()[valid.numpy()],
                                  np.asarray(idx_ref)[np.asarray(valid_ref)])


def _assert_same_predictions(got, ref, tol=1e-5):
    valid = got["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["label_preds"].numpy()[valid],
                                  np.asarray(ref["label_preds"])[valid])
    _close(got["box3d_lidar"].numpy()[valid], np.asarray(ref["box3d_lidar"])[valid], tol)
    _close(got["scores"].numpy()[valid], np.asarray(ref["scores"])[valid], tol)
    assert np.isneginf(got["scores"].numpy()[~valid]).all()
    assert valid.any()


@pytest.mark.parametrize("circular", [False, True], ids=["rotated", "circle"])
def test_predict_matches_tdal(circular):
    """Two tasks (labels offset by the first task's classes), the post-center range
    mask, the score threshold and per-frame NMS."""
    cfg = dict(MAP_CFG, circular_nms=circular, min_radius=[1.0, 0.6])
    tasks = [_maps(5, n_cls=2), _maps(6, n_cls=3)]
    ref = jhead.predict([_j(m) for m in tasks], cfg, [2, 3])
    got = head.predict([_t(m) for m in tasks], cfg, [2, 3])
    _assert_same_predictions(got, ref)
    assert set(got["label_preds"].numpy()[got["valid"].numpy()]) > {0, 1}


def test_double_flip_matches_tdal():
    pts = np.random.default_rng(7).normal(size=(50, 5)).astype(np.float32)
    for a, b in zip(tta.double_flip_points(pts), jtta.double_flip_points(pts)):
        np.testing.assert_array_equal(a, b)
    maps = _maps(8, b=8)  # 2 frames x 4 variants
    ref = jtta.average_double_flip_preds(_j(maps))
    got = tta.average_double_flip_preds(_t(maps))
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k].numpy(), ref[k])
    _assert_same_predictions(head.predict([got], MAP_CFG, [3], activated=True),
                             jhead.predict([ref], MAP_CFG, [3], activated=True))


# ---------------------------------------------------------------------------
# the pp_tiny detector
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, flax.core.unfreeze(tree))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tdal's pp_tiny detector with its flax init, random BatchNorm running statistics
    (eval folds them) and a zero final heatmap bias, on both sides; a 3-frame
    synthetic test split read by both packages' datasets."""
    root = tmp_path_factory.mktemp("tiny")
    jcfg = JConfig.fromfile(str(PP_TINY))
    jvox = jbuild_voxel_config(jcfg.voxel_generator, train=False)
    jdet = jbuild_detector(jcfg.model, jvox)
    infos, _ = make_synthetic_dataset(root / "data", n_scenes=1, n_frames=3, seed=2,
                                      n_background=1500, points_per_object=96)
    names = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]
    jds = JDetectionDataset(infos, names, jbuild_assigner(jcfg.assigner, jdet), jvox,
                            mode="test", max_points=4096)
    params, bs = init_model(jdet, {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(np.stack([jds[0]["points"]] * 2)))
    params, bs = _np_tree(params), _np_tree(bs)
    rng = np.random.default_rng(1)

    def randomise(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomise(v)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    randomise(bs)
    cfg = Config.fromfile(PP_TINY)
    vox = build_voxel_config(cfg.voxel_generator, train=False)
    model = build_detector(cfg.model, vox, device="cpu")
    sep = model.head.tasks[0]
    start = sum(sep.outs[: sep.names.index("hm")])
    params["CenterHead_0"]["SepHead_0"]["final_conv_bias"][start:] = 0.0
    load_flax_pointpillars(model, params, bs)
    ds = DetectionDataset(infos, names, build_assigner(cfg.assigner, model), vox,
                          mode="test", max_points=4096)
    return dict(jdet=jdet, jstate=JTrainState.create(params, optax.adam(1e-3), bs),
                jtest_cfg=jbuild_test_cfg(jcfg.test_cfg, jdet, jvox), jds=jds,
                model=model, test_cfg=build_test_cfg(cfg.test_cfg, model, vox), ds=ds,
                infos=infos, cfg=cfg, params=params, bs=bs)


def test_eval_forward_reads_every_running_statistic(tiny):
    """Eval folds each BatchNorm's running mean and variance into its affine: with
    random statistics, a site whose statistics were not carried across would differ."""
    pts = np.stack([tiny["ds"][i]["points"] for i in range(2)])
    ref = tiny["jdet"].apply({"params": tiny["params"], "batch_stats": tiny["bs"]},
                             jnp.asarray(pts), False)
    with torch.no_grad():
        got = tiny["model"].eval()(torch.from_numpy(pts))
    for k in ref[0]:
        _close(got[0][k].numpy(), ref[0][k], 1e-4)


@pytest.mark.parametrize("double_flip", [False, True], ids=["plain", "double-flip"])
def test_predict_step_matches_tdal(tiny, double_flip):
    pts = np.stack([tiny["ds"][i]["points"] for i in range(2)])
    if double_flip:
        pts = np.stack([v for p in pts for v in tta.double_flip_points(p)])
        ref_step = jengine.make_tta_predict_step(tiny["jdet"], tiny["jtest_cfg"])
        step = engine.make_tta_predict_step(tiny["model"], tiny["test_cfg"])
    else:
        _, ref_step = jengine.make_detector_steps(tiny["jdet"], tiny["jtest_cfg"], [1.0] * 10,
                                                 donate=False)
        step = engine.make_predict_step(tiny["model"], tiny["test_cfg"])
    ref = ref_step(tiny["jstate"], jnp.asarray(pts))
    got = step(TrainState(tiny["model"], None), torch.from_numpy(pts))
    assert got["box3d_lidar"].shape == (2, 128, 9)  # pp_tiny: x y z l w h vx vy heading
    _assert_same_predictions(got, ref, 1e-4)


@pytest.mark.parametrize("double_flip", [False, True], ids=["plain", "double-flip"])
def test_run_inference_and_evaluate_detector_match_tdal(tiny, double_flip):
    """Batch 2 over 3 frames (the last batch padded), per-frame detections keyed by
    token; and AP/APH of the same frames."""
    log = logging.getLogger("t")
    ref = jrun.run_inference(tiny["jdet"], tiny["jstate"], tiny["jds"], tiny["jtest_cfg"],
                             [1.0] * 10, 2, log, double_flip=double_flip)
    state = TrainState(tiny["model"], None)
    got = run.run_inference(state, tiny["ds"], tiny["test_cfg"], 2, log, speed_test=True,
                            double_flip=double_flip)
    assert list(got) == list(ref) == [info["token"] for info in tiny["infos"]]
    for token, r in ref.items():
        g = got[token]
        np.testing.assert_array_equal(g["label_preds"], r["label_preds"])
        _close(g["box3d_lidar"], r["box3d_lidar"], 1e-4)
        _close(g["scores"], r["scores"], 1e-4)
        assert len(g["scores"]) > 0
    if not double_flip:
        want = jrun.evaluate_detector(tiny["jdet"], tiny["jstate"], tiny["jds"],
                                      tiny["jtest_cfg"], [1.0] * 10, 2, log, max_frames=2)
        res = run.evaluate_detector(state, tiny["ds"], tiny["test_cfg"], 2, log, max_frames=2)
        assert res.keys() == want.keys()
        for k in want:
            assert res[k] == pytest.approx(want[k], abs=1e-9), k


def test_detection_metrics_match_tdal(tmp_path):
    """The evaluator on the same detections (the GT moved, resized, relabelled and
    re-scored, plus false positives) and the same annos: AP/APH, the KITTI-style
    tables, the GT and the detection format."""
    infos, _ = make_synthetic_dataset(tmp_path, n_scenes=1, n_frames=4, seed=5,
                                      n_background=50, points_per_object=16)
    info_map = reorganize_info(infos)
    gts, gts_ref = dm.gt_from_annos(info_map), jdm.gt_from_annos(info_map)
    rng = np.random.default_rng(9)
    detections = {}
    for token, gt in gts.items():
        n, k = len(gt["boxes"]), 3
        boxes = np.zeros((n + k, 9), np.float32)
        boxes[:n, :6] = gt["boxes"][:, :6] + rng.normal(0, 0.15, (n, 6))
        boxes[:n, [3, 4]] = boxes[:n, [4, 3]]  # the detector's (KITTI) convention
        boxes[:n, 8] = -gt["boxes"][:, 6] - np.pi / 2 + rng.normal(0, 0.3, n)
        boxes[n:, :2] = rng.uniform(-30, 30, (k, 2))
        boxes[n:, 3:6] = rng.uniform(1, 4, (k, 3))
        labels = np.concatenate([gt["labels"], rng.integers(0, 3, k)])
        labels[rng.uniform(size=n + k) < 0.1] = 0
        detections[token] = {"box3d_lidar": boxes, "scores": rng.uniform(0.1, 1, n + k),
                             "label_preds": labels}
    for token in gts:
        for k in ("boxes", "labels", "num_points"):
            np.testing.assert_array_equal(gts[token][k], gts_ref[token][k])
    dets = dm.detections_to_eval_format(detections)
    dets_ref = jdm.detections_to_eval_format(detections)
    for token in dets:
        for k in dets[token]:
            np.testing.assert_array_equal(dets[token][k], dets_ref[token][k])
    res, want = dm.evaluate_detection(dets, gts), jdm.evaluate_detection(dets, gts)
    assert res.keys() == want.keys() and 0 < want["mAP_l2approx"] < 1
    for k in want:
        assert res[k] == pytest.approx(want[k], abs=1e-9), k
    kitti, kitti_ref = dm.kitti_style_eval(dets, gts), jdm.kitti_style_eval(dets, gts)
    assert kitti.keys() == kitti_ref.keys()
    for metric in kitti_ref:
        assert kitti[metric] == pytest.approx(kitti_ref[metric], abs=1e-9), metric
    assert dm.format_kitti_table(kitti) == jdm.format_kitti_table(kitti_ref)


def test_train_detector_validates_every_epoch(tiny, tmp_path):
    """``val_ds``: each epoch ends with ``evaluate_detector`` on ``val_max_frames``
    frames, written to metrics.jsonl as a "val" row equal to evaluating the final
    state directly. pp_tiny without its velocity head: the assigner's 8-wide box
    targets do not train one (ROADMAP, the reference's known faults)."""
    cfg = tiny["cfg"]
    bbox_head = dict(cfg.model["bbox_head"])
    bbox_head["common_heads"] = {k: v for k, v in bbox_head["common_heads"].items()
                                 if k != "vel"}
    model = build_detector(dict(cfg.model, bbox_head=bbox_head),
                           build_voxel_config(cfg.voxel_generator, train=False),
                           device="cpu")
    infos, _ = make_synthetic_dataset(tmp_path / "train", n_scenes=1, n_frames=2, seed=3,
                                      n_background=800, points_per_object=64)
    vox = build_voxel_config(cfg.voxel_generator, train=True)
    train_ds = DetectionDataset(infos, cfg.class_names, build_assigner(cfg.assigner, model),
                                vox, max_points=4096)
    lr, mom = schedules.one_cycle(cfg.lr_config["lr_max"], 2)
    opt = schedules.adam_with_schedule(model.parameters(), lr, cfg.optimizer["wd"], 35.0, mom)
    state = TrainState(model, opt)
    log = logging.getLogger("t")
    run.train_detector(state, train_ds, [1.0] * 8, n_epoch=2, batch_size=2, logger=log,
                       work_dir=tmp_path / "work", log_every=1, val_ds=tiny["ds"],
                       test_cfg=tiny["test_cfg"], val_every=2, val_max_frames=2)
    rows = [json.loads(x) for x in
            (tmp_path / "work" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["mode"] for r in rows] == ["train", "train", "val"]
    want = run.evaluate_detector(state, tiny["ds"], tiny["test_cfg"], 2, log, max_frames=2)
    assert {k: v for k, v in rows[-1].items() if k not in ("mode", "step")} == want
    assert rows[-1]["step"] == 2
    with pytest.raises(ValueError, match="test_cfg"):
        run.train_detector(state, train_ds, [1.0] * 8, 1, 2, log, tmp_path / "w2",
                           val_ds=tiny["ds"])


def test_phase7_check_explains_only_knife_edges(tiny):
    """chip_smoke's phase-7 rule: a candidate kept on one side only must sit on a knife
    edge (score at the threshold, a tie for the last slot of a side that filled all its
    slots, an overlapping box's score within reach, or a cascade from such a candidate);
    any other difference is unexplained. And the whole check
    passes a model against its own CPU copy."""
    import chip_smoke

    boxes = torch.tensor([[0, 0, 0, 4, 2, 1.5, 0], [0.2, 0, 0, 4, 2, 1.5, 0],
                          [20, 0, 0, 4, 2, 1.5, 0], [40, 0, 0, 4, 2, 1.5, 0],
                          [40.2, 0, 0, 4, 2, 1.5, 0]])  # IoU(0, 1) = IoU(3, 4) = 0.905
    cfg = dict(score_threshold=0.1,
               nms=dict(nms_iou_threshold=0.7, nms_pre_max_size=10, nms_post_max_size=10))

    def explain(card, cpu, scores):
        return chip_smoke.explain_kept_difference(torch.tensor(card), torch.tensor(cpu),
                                                  torch.tensor(scores), boxes, cfg)

    assert explain([0, 2, 3], [0, 2], [0.9, 0.8, 0.5, 0.10005, 0.3]) == ({"score": 1}, [])
    assert explain([0, 1, 2], [0, 2], [0.9, 0.8, 0.5, 0.4, 0.3]) == ({}, [1])
    assert explain([1, 2], [0, 2], [0.9, 0.89995, 0.5, 0.4, 0.3]) == ({"order": 2}, [])
    assert explain([0, 2, 3], [0, 2, 4], [0.9, 0.8, 0.5, 0.10005, 0.3]) == (
        {"score": 1, "cascade": 1}, [])
    # the post-NMS cut: both sides fill their 3 slots; a tie for the last slot between
    # two far-apart boxes is a knife edge, a clear score gap is not
    apart = torch.tensor([[20.0 * i, 0, 0, 4, 2, 1.5, 0] for i in range(4)])
    full = dict(cfg, nms=dict(cfg["nms"], nms_post_max_size=3))

    def explain_full(card, cpu, scores):
        return chip_smoke.explain_kept_difference(torch.tensor(card), torch.tensor(cpu),
                                                  torch.tensor(scores), apart, full)

    assert explain_full([0, 1, 2], [0, 1, 3], [0.9, 0.8, 0.5, 0.50005]) == (
        {"post-cut": 2}, [])
    assert explain_full([0, 1, 2], [0, 1, 3], [0.9, 0.8, 0.5, 0.45]) == ({}, [2, 3])

    pts = torch.from_numpy(np.stack([tiny["ds"][i]["points"] for i in range(2)]))
    out = chip_smoke.check_infer_against_cpu(tiny["model"], pts, tiny["test_cfg"])
    assert out["differing"] == out["unexplained"] == 0 and out["kept_cpu"] > 0
