"""The two-stage detector in the port against tdal, on the CPU: every function of
``tdal_torch.models.two_stage``, ``proposal_targets`` fed the draws ``jax.random``
makes from tdal's key, one frozen-first-stage train step and predict of
``configs/synthetic/pp_two_stage_tiny.py`` (tdal's weights converted by
``tdal_torch.convert.load_flax_two_stage``; the dropout masks made with numpy and
handed to both sides, tdal's through its ``bernoulli``, patched in the test), and the
``train`` / ``dist_test`` CLIs' two-stage branch with ``--device cpu``.

Tolerances:
- integer outputs (sampled indices, labels, masks, valid slots): exactly equal;
- the RoIs' IoU with their GT box and the soft labels from it: 1e-4 (the port's rotated
  overlap sums its clipped edges in another order; near-coincident boxes make the
  overlap a small difference of large areas, measured 1.7e-5);
- elementwise functions (bilinear sampling, box centres, target canonicalisation,
  decode, rescoring, losses): 1e-6 of max(1, |tdal|) (the same f32 operations);
- the RoI head's forwards: 1e-5 of max(1, |tdal|) (f32 matmuls summed in another order,
  through BatchNorms over a batch of 64 rows); its gradients: 1e-5 of the leaf's
  largest |tdal| gradient + 1e-7;
- the first stage's RoIs, scores and features: 1e-4 of max(1, |tdal|) (the eval forward
  through 7 convs, as ``tests/test_torch_detector_infer.py`` holds predict);
- parameters after the AdamW step: 1e-5 x (1 + |p|), plus 2 lr where the gradient is
  within its tolerance of zero (Adam's first step may take either sign there).
"""

import contextlib
import copy

import numpy as np
import optax
import pytest
import torch

import flax
import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp

from tdal.core.voxel import pad_points
from tdal.models import two_stage as J
from tdal.models.builder import build_detector as jbuild_detector
from tdal.models.builder import build_test_cfg as jbuild_test_cfg
from tdal.models.builder import build_two_stage_engine as jbuild_two_stage_engine
from tdal.models.builder import build_voxel_config as jbuild_voxel_config
from tdal.pipeline.two_stage_engine import make_frozen_tx
from tdal.runtime import schedules as jsched
from tdal.runtime.config import Config as JConfig
from tdal.runtime.train_state import TrainState as JTrainState
from tdal_torch.convert import load_flax_two_stage, roi_head_state_dict
from tdal_torch.core.targets import AssignerConfig, assign_centernet_targets
from tdal_torch.data.detection import collate_detection
from tdal_torch.data.synthetic import make_synthetic_dataset
from tdal_torch.data.waymo_schema import load_pickle
from tdal_torch.models import two_stage as T
from tdal_torch.models.builder import (
    build_detector, build_test_cfg, build_two_stage_engine, build_voxel_config,
)
from tdal_torch.pipeline.two_stage_engine import make_two_stage_steps
from tdal_torch.runtime import schedules
from tdal_torch.runtime.config import Config
from tdal_torch.runtime.train_state import TrainState

torch.set_num_threads(2)

CONFIG = "configs/synthetic/pp_two_stage_tiny.py"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, flax.core.unfreeze(tree))


def _close(got, want, atol_scale=1e-6, msg=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol_scale * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def _boxes(rng, b, k, width=7):
    boxes = np.zeros((b, k, width), np.float32)
    boxes[..., :2] = rng.uniform(-6, 6, (b, k, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (b, k))
    boxes[..., 3:6] = rng.uniform(0.5, 4.0, (b, k, 3))
    if width == 9:
        boxes[..., 7:9] = rng.normal(size=(b, k, 2))
    boxes[..., 6] = rng.uniform(-7, 7, (b, k))
    return boxes


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def test_bilinear_interpolate_and_bev_extractor_match_tdal():
    rng = np.random.default_rng(0)
    im = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    x = np.concatenate([rng.uniform(-2, 13, 40), [0.0, 10.0, 10.5]]).astype(np.float32)
    y = np.concatenate([rng.uniform(-2, 11, 40), [0.0, 8.0, 8.0]]).astype(np.float32)
    ref = J.bilinear_interpolate(jnp.asarray(im[0]), jnp.asarray(x), jnp.asarray(y))
    got = T.bilinear_interpolate(torch.from_numpy(im[0]), torch.from_numpy(x),
                                 torch.from_numpy(y))
    _close(got, ref)
    centers = rng.uniform(-5, 5, (2, 7, 5, 3)).astype(np.float32)
    kw = dict(pc_start=(-4.0, -4.5), voxel_size=(0.5, 0.5), out_stride=2)
    ref = J.BEVFeatureExtractor(**kw)(jnp.asarray(im), jnp.asarray(centers))
    got = T.BEVFeatureExtractor(**kw)(torch.from_numpy(im), torch.from_numpy(centers))
    assert got.shape == (2, 7, 30)
    _close(got, ref)


@pytest.mark.parametrize("num_point", [1, 5])
@pytest.mark.parametrize("width", [7, 9])
def test_get_box_centers_match_tdal(num_point, width):
    boxes = _boxes(np.random.default_rng(1), 2, 6, width)
    ref = J.get_box_centers(jnp.asarray(boxes), num_point)
    _close(T.get_box_centers(torch.from_numpy(boxes), num_point), ref)


@pytest.mark.parametrize("width", [7, 9])
def test_assign_targets_and_decode_match_tdal(width):
    rng = np.random.default_rng(2)
    rois = _boxes(rng, 2, 8, width)
    gt = np.concatenate([_boxes(rng, 2, 8, width), rng.integers(1, 4, (2, 8, 1))], -1)
    gt = gt.astype(np.float32)
    ref = J.assign_roi_targets(jnp.asarray(rois), jnp.asarray(gt))
    got = T.assign_roi_targets(torch.from_numpy(rois), torch.from_numpy(gt))
    _close(got, ref)
    reg = rng.normal(size=(2, 8, width)).astype(np.float32)
    _close(T.generate_predicted_boxes(torch.from_numpy(rois), torch.from_numpy(reg)),
           J.generate_predicted_boxes(jnp.asarray(rois), jnp.asarray(reg)))


def test_roi_losses_and_post_process_match_tdal():
    rng = np.random.default_rng(3)
    targets = {"rcnn_cls_labels": rng.uniform(0, 1, (2, 16)).astype(np.float32),
               "gt_of_rois": rng.normal(size=(2, 16, 8)).astype(np.float32),
               "reg_valid_mask": rng.integers(0, 2, (2, 16)).astype(np.int32)}
    cls = rng.normal(size=(2, 16, 1)).astype(np.float32)
    reg = rng.normal(size=(2, 16, 7)).astype(np.float32)
    cw = [1.0, 2.0, 1.0, 0.5, 1.0, 1.0, 3.0]
    ref = J.roi_losses(jnp.asarray(cls), jnp.asarray(reg),
                       {k: jnp.asarray(v) for k, v in targets.items()}, cw, 1.5, 0.5)
    got = T.roi_losses(torch.from_numpy(cls), torch.from_numpy(reg),
                       {k: torch.from_numpy(v) for k, v in targets.items()}, cw, 1.5, 0.5)
    for g, r in zip(got, ref):
        _close(g, r)
    for width in (7, 9):
        boxes = _boxes(rng, 2, 16, width)
        scores = rng.uniform(-0.1, 1, (2, 16)).astype(np.float32)
        labels = rng.integers(0, 4, (2, 16)).astype(np.int32)
        valid = rng.random((2, 16)) > 0.2
        ref = J.two_stage_post_process(jnp.asarray(boxes), jnp.asarray(cls),
                                       jnp.asarray(scores), jnp.asarray(labels),
                                       jnp.asarray(valid))
        got = T.two_stage_post_process(torch.from_numpy(boxes), torch.from_numpy(cls),
                                       torch.from_numpy(scores), torch.from_numpy(labels),
                                       torch.from_numpy(valid))
        for k in ("valid", "label_preds"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        ok = np.asarray(ref["valid"])
        _close(got["scores"].numpy()[ok], np.asarray(ref["scores"])[ok])
        assert np.isneginf(got["scores"].numpy()[~ok]).all()
        _close(got["box3d_lidar"], ref["box3d_lidar"])


def jax_proposal_draws(key, b, k):
    """The uniforms tdal's ``proposal_targets`` draws from ``key``: the key split per
    sample, each split in three (fg, hard bg, easy bg), ``uniform((K,))`` of each."""
    out = np.zeros((b, 3, k), np.float32)
    for i, r in enumerate(jax.random.split(key, b)):
        for j, rr in enumerate(jax.random.split(r, 3)):
            out[i, j] = np.asarray(jax.random.uniform(rr, (k,)))
    return out


@pytest.mark.parametrize("case", ["mixed", "no background", "no fg"])
def test_proposal_targets_match_tdal_on_its_draws(case):
    rng = np.random.default_rng(4)
    b, k, g = 2, 40, 6
    gt = np.zeros((b, 8, 8), np.float32)
    gt[:, :g, :7] = _boxes(rng, b, g)[..., :7]
    gt[:, :g, 7] = rng.integers(1, 4, (b, g))
    rois = _boxes(rng, b, k)
    labels = rng.integers(1, 4, (b, k)).astype(np.int32)
    if case != "no fg":  # some RoIs near a GT box of their class: fg and hard bg
        src = rng.integers(0, g, (b, k))
        near = np.take_along_axis(gt[..., :7], src[..., None], 1)
        jitter = rng.normal(size=(b, k, 7)).astype(np.float32) * np.where(
            rng.random((b, k, 1)) < 0.5, 0.05, 0.5)
        pick = rng.random((b, k)) < (1.0 if case == "no background" else 0.6)
        rois = np.where(pick[..., None], near + jitter, rois).astype(np.float32)
        rois[..., 3:6] = np.abs(rois[..., 3:6]) + 0.1
        labels = np.where(pick, np.take_along_axis(gt[..., 7], src, 1), labels).astype(np.int32)
    labels[:, -3:] = 0  # padding RoIs
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    feats = rng.normal(size=(b, k, 5)).astype(np.float32)
    cfg = dict(roi_per_image=16)
    key = jax.random.PRNGKey(7)
    ref = J.proposal_targets(key, *map(jnp.asarray, (rois, scores, labels, feats, gt)),
                             J.RoiTargetConfig(**cfg))
    draws = torch.from_numpy(jax_proposal_draws(key, b, k))
    got = T.proposal_targets(draws, *map(torch.from_numpy, (rois, scores, labels, feats, gt)),
                             T.RoiTargetConfig(**cfg))
    assert got.keys() == ref.keys()
    iou = np.asarray(ref["gt_iou_of_rois"])
    if case == "mixed":
        assert (iou >= 0.55).any() and ((iou > 0.1) & (iou < 0.55)).any() and (iou < 0.1).any()
    for name in ("roi_labels", "reg_valid_mask"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]))
    for name in ("rois", "gt_of_rois_src", "roi_scores", "roi_features"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]), err_msg=name)
    _close(got["gt_of_rois"], ref["gt_of_rois"], msg="gt_of_rois")
    for name in ("gt_iou_of_rois", "rcnn_cls_labels"):
        _close(got[name], ref[name], 1e-4, msg=name)


@contextlib.contextmanager
def tdal_dropout_masks(masks):
    """tdal's dropouts take ``masks`` (numpy, in call order) in place of their draws."""
    queue = list(masks)
    real = flax_stochastic.random

    class Random:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def bernoulli(rng, p, shape):
            m = queue.pop(0)
            assert tuple(m.shape) == tuple(shape)
            return jnp.asarray(m)

    flax_stochastic.random = Random()
    try:
        yield
    finally:
        flax_stochastic.random = real
    assert not queue, "unused dropout masks"


def _roi_head_pair(seed=5):
    jhead = J.RoIHead(shared_fc=(32, 32), cls_fc=(16, 16), reg_fc=(16,), code_size=7)
    x = np.random.default_rng(seed).normal(size=(2, 12, 20)).astype(np.float32)
    v = _np_tree(jhead.init({"params": jax.random.PRNGKey(seed),
                             "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    head = T.RoIHead(20, shared_fc=(32, 32), cls_fc=(16, 16), reg_fc=(16,), code_size=7)
    head.load_state_dict(roi_head_state_dict(head, v["params"], v["batch_stats"]))
    return jhead, v, head, x


def test_roi_head_matches_tdal_in_eval_and_train():
    jhead, v, head, x = _roi_head_pair()
    _close(head.eval()(torch.from_numpy(x))[0], jhead.apply(v, jnp.asarray(x))[0], 1e-5)
    masks = T.roi_head_draws(head, 2, 12, torch.Generator().manual_seed(0))
    assert [m.shape[-1] for m in masks] == [32, 16, 16]
    with tdal_dropout_masks([m.numpy() for m in masks]):
        ref, mut = jhead.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(2)})
    head.train()
    got = head(torch.from_numpy(x), dropout=masks)
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)
    want = roi_head_state_dict(head, v["params"], _np_tree(mut)["batch_stats"])
    for k, val in head.state_dict().items():
        if "running" in k:
            _close(val, want[k], 1e-5, msg=k)
    with pytest.raises(ValueError, match="dropout"):
        head(torch.from_numpy(x))


# ---------------------------------------------------------------------------
# one frozen-first-stage step and predict on pp_two_stage_tiny
# ---------------------------------------------------------------------------


def _tiny_batch(cfg, voxel_cfg, b=2, seed=0):
    """Collated numpy batch: a few boxes a frame with points on them and background
    points; the GT rows carry vx = 1 (their last column after tdal's slice, read as the
    class: tdal's quirk), so some RoIs match a class-1 GT box."""
    rng = np.random.default_rng(seed)
    tasks = [dict(num_class=3, class_names=list(cfg.class_names))]
    asg = AssignerConfig(tasks=tasks, out_size_factor=1, max_objs=50)
    items = []
    for i in range(b):
        n = 3
        boxes = np.zeros((n, 9), np.float32)
        boxes[:, 0] = rng.uniform(-15, 40, n)
        boxes[:, 1] = rng.uniform(-18, 18, n)
        boxes[:, 2] = 0.5
        boxes[:, 3:6] = [4.5, 2.0, 1.6]
        boxes[:, 6] = 1.0
        boxes[:, 8] = rng.uniform(-3, 3, n)
        t = assign_centernet_targets(boxes, np.ones(n, np.int32), asg, voxel_cfg.grid_size,
                                     voxel_cfg.point_cloud_range, voxel_cfg.voxel_size)
        pts = [rng.uniform([-25, -25, -1.5], [50, 25, 2.0], (1500, 3))]
        for bx in boxes:
            local = (rng.random((150, 3)) - 0.5) * bx[3:6]
            c, s = np.cos(bx[8]), np.sin(bx[8])
            pts.append(local @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]) + bx[:3])
        p = np.concatenate(pts).astype(np.float32)
        p = np.concatenate([p, rng.uniform(0, 1, (len(p), 2)).astype(np.float32)], 1)
        items.append(dict(t, points=pad_points(p, cfg.data["train"]["max_points"]),
                          token=f"f{i}"))
    return collate_detection(items)


@pytest.fixture(scope="module")
def tiny():
    """tdal's two-stage engine on pp_two_stage_tiny (score threshold 0: no candidate
    sits on the threshold's knife edge at a fresh init), its variables, and the port's
    engine loaded from them."""
    jcfg, cfg = JConfig.fromfile(CONFIG), Config.fromfile(CONFIG)
    jvox = jbuild_voxel_config(jcfg.voxel_generator, train=True)
    vox = build_voxel_config(cfg.voxel_generator, train=True)
    jfirst = jbuild_detector(jcfg.model["first_stage_cfg"], jvox)
    jtest = dict(jbuild_test_cfg(jcfg.test_cfg, jfirst, jvox), score_threshold=0.0)
    jengine = jbuild_two_stage_engine(jcfg.model, jvox, jtest)
    batch = _tiny_batch(cfg, vox)
    params, bs = jax.jit(jengine.init)(jax.random.PRNGKey(0), jnp.asarray(batch["points"]),
                                       jnp.asarray(batch["gt_boxes_and_cls"]))
    params, bs = _np_tree(params), _np_tree(bs)
    first = build_detector(cfg.model["first_stage_cfg"], vox, device="cpu")
    test_cfg = dict(build_test_cfg(cfg.test_cfg, first, vox), score_threshold=0.0)
    engine = build_two_stage_engine(cfg.model, vox, test_cfg, device="cpu")
    load_flax_two_stage(engine, params, bs)
    return dict(jengine=jengine, params=params, bs=bs, engine=engine, batch=batch, cfg=cfg)


def test_first_stage_rois_match_tdal(tiny):
    jengine, engine, batch = tiny["jengine"], tiny["engine"], tiny["batch"]
    vf = {"params": tiny["params"]["first"], "batch_stats": tiny["bs"]["first"]}
    ref = jax.jit(lambda v, p: jengine._first_stage_rois(v, p, train=False)[2:])(
        vf, jnp.asarray(batch["points"]))
    got = engine.first_stage_rois(torch.from_numpy(batch["points"]), train=False)[1:]
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))  # valid
    assert int(got[4].sum()) > 10
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))  # labels
    for name, g, r in zip(("rois", "labels", "scores", "features"), got[:4], ref[:4]):
        _close(g, r, 1e-4, msg=name)


def test_frozen_train_step_matches_tdal(tiny):
    """One step of the frozen-first-stage engine on the same weights, batch, proposal
    draws (jax's, from tdal's key) and dropout masks: the loss, the RoI head's
    gradients (tdal's, captured in its optimizer chain), its running statistics and
    its parameters after the AdamW step; the first stage's parameters and running
    statistics unchanged on both sides."""
    jengine, params, bs, batch = tiny["jengine"], tiny["params"], tiny["bs"], tiny["batch"]
    engine = copy.deepcopy(tiny["engine"])
    lr_max, total = 3e-3, 10
    captured = {}

    def capture(g):
        captured["g"] = jax.tree_util.tree_map(np.asarray, g)

    def update(g, s, p=None):
        jax.debug.callback(capture, g)
        return g, s

    keep = optax.GradientTransformation(lambda p: optax.EmptyState(), update)
    jlr, jmom = jsched.one_cycle(lr_max, total)
    tx = make_frozen_tx(optax.chain(keep, jsched.adam_with_schedule(
        jlr, weight_decay=0.01, grad_clip=35.0, momentum_schedule=jmom)))
    jstate = JTrainState.create(params, tx, bs)
    jtrain, _ = jengine.make_steps(donate=False)
    key = jax.random.PRNGKey(3)
    b = batch["points"].shape[0]
    k = 128  # NMS post max of the one task
    proposal = jax_proposal_draws(jax.random.fold_in(jax.random.fold_in(key, 0), 0), b, k)
    masks = T.roi_head_draws(engine.roi_head, b, engine.roi_cfg.roi_per_image,
                             torch.Generator().manual_seed(1))
    jb = {kk: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
          for kk, v in batch.items() if kk != "token"}
    with tdal_dropout_masks([m.numpy() for m in masks]):
        jnew, jlogs = jtrain(jstate, jb, key)
        jax.block_until_ready(jnew.params)

    lr, mom = schedules.one_cycle(lr_max, total)
    opt = schedules.adam_with_schedule(engine.trainable_parameters(), lr, 0.01, 35.0, mom)
    state = TrainState(engine, opt)
    first_before = copy.deepcopy(engine.first.state_dict())
    old = {k: v.clone() for k, v in engine.roi_head.state_dict().items()}
    grads = {}
    for name, p in engine.roi_head.named_parameters():
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    train_step, _ = make_two_stage_steps(engine)
    logs = train_step(state, batch, draws={"proposal": torch.from_numpy(proposal),
                                           "dropout": masks})
    for name in ("rcnn_loss_cls", "rcnn_loss_reg", "loss"):
        assert float(logs[name]) == pytest.approx(float(jlogs[name]), rel=1e-5, abs=1e-7), name
    assert float(jlogs["rcnn_loss_cls"]) > 0

    g_want = roi_head_state_dict(engine.roi_head, captured["g"]["roi"], bs["roi"])
    new_want = roi_head_state_dict(engine.roi_head, _np_tree(jnew.params)["roi"],
                                   _np_tree(jnew.batch_stats)["roi"])
    new_got = engine.roi_head.state_dict()
    assert set(grads) == {k for k in new_got if "running" not in k}
    for name, g in grads.items():
        want = g_want[name].numpy().astype(np.float64)
        tol = 1e-5 * np.abs(want).max() + 1e-7
        err = np.abs(g.numpy() - want).max()
        assert err <= tol, f"grad {name}: {err:.3e} > {tol:.3e}"
        flip = np.abs(want) <= tol
        allowed = 1e-5 * (1 + old[name].abs().numpy()) + flip * 2.0 * lr(0)
        assert (np.abs(new_got[name].numpy() - new_want[name].numpy()) <= allowed).all(), name
    for name, v in new_got.items():
        if "running" in name:
            _close(v, new_want[name], 1e-5, msg=name)
    for name, v in engine.first.state_dict().items():
        assert torch.equal(v, first_before[name]), name
    jfirst = jax.tree_util.tree_leaves(_np_tree(jnew.params)["first"])
    for a, r in zip(jfirst, jax.tree_util.tree_leaves(params["first"])):
        np.testing.assert_array_equal(a, r)
    assert state.step == 1 and opt.count == 1


def test_two_stage_predict_matches_tdal(tiny):
    jengine, params, bs, batch = tiny["jengine"], tiny["params"], tiny["bs"], tiny["batch"]
    jstate = JTrainState.create(params, optax.adam(1e-3), bs)
    _, jpredict = jengine.make_steps(donate=False)
    ref = jax.tree_util.tree_map(np.asarray, jpredict(jstate, jnp.asarray(batch["points"])))
    _, predict_step = make_two_stage_steps(tiny["engine"])
    got = predict_step(TrainState(tiny["engine"], None), torch.from_numpy(batch["points"]))
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    ok = ref["valid"]
    np.testing.assert_array_equal(got["label_preds"].numpy()[ok], ref["label_preds"][ok])
    _close(got["box3d_lidar"].numpy()[ok], ref["box3d_lidar"][ok], 1e-4)
    _close(got["scores"].numpy()[ok], ref["scores"][ok], 1e-4)


def test_waymo_two_stage_engine_width_matches_tdal():
    """The freeze config's engine at full width: the RoI head's 512 x 5 inputs, 128 RoIs
    an image, the frozen bf16 first stage, and each stage's parameter count against
    tdal's engine's (``jax.eval_shape`` of its init: no computation at the full grid)."""
    config = ("configs/waymo/voxelnet/two_stage/"
              "waymo_centerpoint_voxelnet_two_stage_bev_5point_ft_6epoch_freeze.py")
    jcfg, cfg = JConfig.fromfile(config), Config.fromfile(config)
    jvox = jbuild_voxel_config(jcfg.voxel_generator, train=True)
    jfirst = jbuild_detector(jcfg.model["first_stage_cfg"], jvox)
    jengine = jbuild_two_stage_engine(jcfg.model, jvox, jbuild_test_cfg(jcfg.test_cfg, jfirst,
                                                                        jvox))
    params, _ = jax.eval_shape(jengine.init, jax.random.PRNGKey(0),
                               jax.ShapeDtypeStruct((1, 1000, 5), jnp.float32),
                               jax.ShapeDtypeStruct((1, 500, 10), jnp.float32))
    vox = build_voxel_config(cfg.voxel_generator, train=True)
    first = build_detector(cfg.model["first_stage_cfg"], vox, device="cpu")
    engine = build_two_stage_engine(cfg.model, vox, build_test_cfg(cfg.test_cfg, first, vox),
                                    device="cpu")

    def count(tree):
        return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))

    assert sum(p.numel() for p in engine.first.parameters()) == count(params["first"])
    assert sum(p.numel() for p in engine.roi_head.parameters()) == count(params["roi"])
    assert engine.roi_head.shared[0].linear.in_features == 512 * 5 == (
        params["roi"]["Dense_0"]["kernel"].shape[0])
    assert engine.freeze_first and engine.roi_cfg.roi_per_image == 128
    assert engine.first.rpn.dtype == torch.bfloat16
    assert {id(p) for p in engine.trainable_parameters()} == {
        id(p) for p in engine.roi_head.parameters()}


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_two_stage_clis_train_and_test(tmp_path):
    """``train`` then ``dist_test`` on a ``TwoStageDetector`` config with ``--device
    cpu``: the first stage loads from a detector checkpoint named by the config's
    ``pretrained``, stays as it was through the RoI head's epoch, and the two-stage
    predictions are written."""
    import importlib
    import sys

    def run(module, argv):
        mod = importlib.import_module(f"tdal_torch.tools.{module}")
        old = sys.argv
        sys.argv = [module] + [str(a) for a in argv]
        try:
            mod.main()
        finally:
            sys.argv = old

    infos, _ = make_synthetic_dataset(tmp_path / "data", n_scenes=1, n_frames=4, seed=3,
                                      n_static=2, n_dynamic=1, points_per_object=64,
                                      n_background=256)
    info_path = tmp_path / "data" / "infos.pkl"
    cfg = Config.fromfile(CONFIG)
    vox = build_voxel_config(cfg.voxel_generator)
    first = build_detector(cfg.model["first_stage_cfg"], vox, device="cpu", seed=5)
    pre = tmp_path / "first" / "checkpoints"
    TrainState(first, schedules.adam_with_schedule(first.parameters(), lambda s: 0.0)).save(
        pre / "step_00000007.pt")
    text = open(CONFIG).read().replace("pretrained=None", f"pretrained={str(pre)!r}")
    cfg_path = tmp_path / "two_stage.py"
    cfg_path.write_text(text)
    work = tmp_path / "two"
    run("train", [cfg_path, "--work_dir", work, "--info_path", info_path, "--total_epochs", 1,
                  "--batch_size", 2, "--device", "cpu"])
    (ckpt,) = sorted((work / "checkpoints").glob("step_*.pt"))
    sd = torch.load(ckpt, weights_only=True)["model"]
    assert sd.keys() == build_two_stage_engine(cfg.model, vox, {}, device="cpu").state_dict().keys()
    for k, v in first.state_dict().items():
        assert torch.equal(sd[f"first.{k}"], v), k
    run("dist_test", [cfg_path, "--work_dir", work / "test", "--checkpoint", work / "checkpoints",
                      "--info_path", info_path, "--batch_size", 2, "--device", "cpu"])
    pred = load_pickle(work / "test" / "prediction.pkl")
    assert sorted(pred) == sorted(i["token"] for i in infos)
    for d in pred.values():
        assert d["box3d_lidar"].shape[1] == 7 and np.isfinite(d["box3d_lidar"]).all()
        assert (d["scores"] >= 0).all()
