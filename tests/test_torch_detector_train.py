"""PointPillars detector training in the port against tdal, on the CPU, at a narrow
size: a 32x32 BEV grid, PFN (16, 16), RPN layer_nums (1, 1, 1) with (16, 32, 64)
channels. Weights are tdal's flax init converted with
``tdal_torch.convert.load_flax_pointpillars``; inputs come from seeded numpy.

Tolerances:
- voxelization, targets, dataset items and the config: exactly equal (the same
  integer and float operations on the same values);
- the OneCycle schedules: 1e-6 of their peak (the port evaluates them in float64,
  tdal in float32, whose cosine is off by a few 1e-8 where lr nears lr_max / 1e4);
- forwards: rtol 1e-4, atol 1e-4 x max(1, |ref|): f32 sums in another order,
  amplified by the train-mode BatchNorms (1/std of a batch of a few pixels);
- BN running statistics: rtol 1e-5, atol 1e-6;
- gradients: per leaf max(1e-4 x max |ref| + 1e-6, 8 x noise), noise being the
  larger of tdal's and the port's own change under a permutation of the batch (the
  loss and BN statistics are permutation invariant, so that change is float
  reassociation noise, which the BN backward amplifies), the method of
  ``tests/test_mesh_production.py:74-141``;
- parameters after the clipped, OneCycle'd AdamW step: 1e-5 x (1 + |p|), except where
  the reference gradient lies within its leaf's tolerance of zero, where Adam's first
  step (about lr x sign(g)) may take either sign: there 2 lr more.
"""

import copy
import json
import logging

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from tdal.core import targets as jtargets
from tdal.core.voxel import VoxelConfig as JVoxelConfig
from tdal.core.voxel import voxelize_batch as jvoxelize
from tdal.data.detection import DetectionDataset as JDetectionDataset
from tdal.data.detection import collate_detection as jcollate
from tdal.models.center_head import center_head_loss as jloss
from tdal.models.detectors import PointPillars as JPointPillars
from tdal.models.layers import FusedConvBN as JFusedConvBN
from tdal.pipeline.detector_engine import make_detector_steps as jmake_steps
from tdal.runtime import schedules as jsched
from tdal.runtime.config import Config as JConfig
from tdal.runtime.train_state import TrainState as JTrainState
from tdal_torch.convert import load_flax_pointpillars, pointpillars_state_dict
from tdal_torch.core import targets
from tdal_torch.core.voxel import VoxelConfig, voxelize_batch
from tdal_torch.data.detection import DetectionDataset, collate_detection
from tdal_torch.data.synthetic import make_synthetic_dataset
from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config
from tdal_torch.models.center_head import center_head_loss
from tdal_torch.models.detectors import PointPillars
from tdal_torch.models.layers import FusedConvBN
from tdal_torch.pipeline.detector_engine import TARGET_KEYS, make_detector_steps
from tdal_torch.pipeline.detector_run import train_detector
from tdal_torch.runtime import schedules
from tdal_torch.runtime.config import Config
from tdal_torch.runtime.train_state import TrainState

torch.set_num_threads(2)

TASKS = [dict(num_class=3, class_names=("VEHICLE", "PEDESTRIAN", "CYCLIST"))]
VOX = ((-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.5, 0.5, 6.0), 8, 300)
NARROW = dict(num_filters=(16, 16), rpn_layer_nums=(1, 1, 1), rpn_ds_filters=(16, 32, 64),
              rpn_us_filters=(16, 16, 16))
ASSIGNER = dict(tasks=[dict(num_class=3, class_names=list(TASKS[0]["class_names"]))],
                out_size_factor=1, max_objs=16)
TEST_CFG = dict(post_center_limit_range=[-10, -10, -10, 10, 10, 10],
                nms=dict(nms_pre_max_size=64, nms_post_max_size=16, nms_iou_threshold=0.7),
                score_threshold=0.1, pc_range=[-8.0, -8.0], out_size_factor=1,
                voxel_size=[0.5, 0.5])
CODE_WEIGHTS = [1.0] * 8
CONFIG = "configs/waymo/pp/waymo_centerpoint_pp_two_pfn_stride1_3x.py"


def _points(rng, b, n=400, valid=350):
    pts = np.full((b, n, 5), np.nan, np.float32)
    pts[:, :valid] = rng.uniform(-9, 9, (b, valid, 5))
    pts[:, :valid, 2] = rng.uniform(-1.0, 2.0, (b, valid))
    return pts


def _batch(b=3, seed=0):
    """Collated numpy batch: points + targets of a few boxes per frame."""
    rng = np.random.default_rng(seed)
    cfg = targets.AssignerConfig(**ASSIGNER)
    items = []
    for i in range(b):
        k = 2 + i % 2
        boxes = np.zeros((k, 9), np.float32)
        boxes[:, :2] = rng.uniform(-6, 6, (k, 2))
        boxes[:, 2] = rng.uniform(0, 1, k)
        boxes[:, 3:6] = rng.uniform(0.8, 4.0, (k, 3))
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, k)
        t = targets.assign_centernet_targets(
            boxes, rng.integers(1, 4, k).astype(np.int32), cfg,
            VoxelConfig(*VOX).grid_size, VOX[0], VOX[1])
        items.append(dict(t, points=_points(rng, 1)[0], token=f"f{i}"))
    batch = collate_detection(items)
    return {k: batch[k] for k in ("points", *TARGET_KEYS)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, flax.core.unfreeze(tree))


@pytest.fixture(scope="module")
def pair():
    """(tdal detector, its variables as numpy trees, the port's detector loaded from
    them)."""
    jdet = JPointPillars(voxel_cfg=JVoxelConfig(*VOX), tasks=tuple(TASKS), **NARROW)
    variables = _np_tree(jax.jit(jdet.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(_points(np.random.default_rng(9), 2)), False))
    tdet = PointPillars(VoxelConfig(*VOX), TASKS, **NARROW)
    load_flax_pointpillars(tdet, variables["params"], variables["batch_stats"])
    return jdet, variables, tdet


def _close(got, want, rtol=1e-4, atol_scale=1e-4, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_scale * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def _jbatch(batch):
    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data side: exact
# ---------------------------------------------------------------------------


def _assert_same_targets(got, ref):
    """Per-task target lists and the padded gt_boxes_and_cls, exactly equal."""
    assert got.keys() == ref.keys()
    for k in TARGET_KEYS:
        assert len(got[k]) == len(ref[k]), k
        for g, r in zip(got[k], ref[k]):
            np.testing.assert_array_equal(g, r, err_msg=k)
    np.testing.assert_array_equal(got["gt_boxes_and_cls"], ref["gt_boxes_and_cls"])


def test_voxelize_batch_is_exactly_tdal():
    rng = np.random.default_rng(1)
    pts = _points(rng, 3, n=600, valid=560)
    pts[0, :200, :2] = rng.uniform(-0.4, 0.4, (200, 2))  # crowd one pillar past P=8
    cfg = (VOX[0], VOX[1], 8, 120)  # and more pillars than max_voxels
    ref = jvoxelize(jnp.asarray(pts), JVoxelConfig(*cfg))
    got = voxelize_batch(torch.from_numpy(pts), VoxelConfig(*cfg))
    assert int(got[3].max()) == 120 and int(got[2].max()) == 8
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_assign_centernet_targets_is_exactly_tdal():
    rng = np.random.default_rng(2)
    boxes = np.zeros((12, 9), np.float32)
    boxes[:, :2] = rng.uniform(-10, 10, (12, 2))  # some outside the grid
    boxes[:, 3:6] = rng.uniform(0.3, 5.0, (12, 3))
    boxes[:, 6:8] = rng.normal(size=(12, 2))
    boxes[:, 8] = rng.uniform(-7, 7, 12)
    classes = rng.integers(1, 4, 12).astype(np.int32)
    grid = VoxelConfig(*VOX).grid_size
    ref = jtargets.assign_centernet_targets(
        boxes, classes, jtargets.AssignerConfig(**ASSIGNER), grid, VOX[0], VOX[1])
    got = targets.assign_centernet_targets(
        boxes, classes, targets.AssignerConfig(**ASSIGNER), grid, VOX[0], VOX[1])
    _assert_same_targets(got, ref)


def test_detection_dataset_items_are_tdal_items(tmp_path):
    infos, _ = make_synthetic_dataset(tmp_path, n_scenes=1, n_frames=3, seed=0,
                                      n_background=800, points_per_object=64)
    kw = dict(class_names=list(TASKS[0]["class_names"]), mode="train", max_points=1500,
              seed=0)
    vox = ((0.0, -16.0, -2.0, 32.0, 16.0, 4.0), (1.0, 1.0, 6.0), 8, 300)  # holds the objects
    ref = JDetectionDataset(infos, assigner=jtargets.AssignerConfig(**ASSIGNER),
                            voxel_cfg=JVoxelConfig(*vox), **kw)
    got = DetectionDataset(infos, assigner=targets.AssignerConfig(**ASSIGNER),
                           voxel_cfg=VoxelConfig(*vox), **kw)
    items_ref = jcollate([ref[i] for i in (0, 1, 2, 0)])
    items_got = collate_detection([got[i] for i in (0, 1, 2, 0)])
    assert items_got.keys() == items_ref.keys()
    assert items_got["token"] == items_ref["token"]
    np.testing.assert_array_equal(items_got["points"], items_ref["points"])
    assert int(sum(m.sum() for m in items_got["mask"])) > 0
    _assert_same_targets(items_got, items_ref)


def test_config_and_one_cycle_match_tdal():
    assert Config.fromfile(CONFIG).to_dict() == JConfig.fromfile(CONFIG).to_dict()
    lr, mom = schedules.one_cycle(3e-3, 50, (0.95, 0.85), 10.0, 0.4)
    jlr, jmom = jsched.one_cycle(3e-3, 50, (0.95, 0.85), 10.0, 0.4)
    for step in (0, 1, 7, 19, 20, 21, 40, 49, 50, 60):
        assert lr(step) == pytest.approx(float(jlr(step)), rel=0, abs=3e-3 * 1e-6)
        assert mom(step) == pytest.approx(float(jmom(step)), rel=0, abs=0.95 * 1e-6)


# the torchie LR policies (tdal/runtime/schedules.py:82-164), built the same way from
# either package's module
LR_POLICIES = {
    "fixed": lambda m: m.fixed_lr(1e-3),
    "step, every 30 epochs": lambda m: m.step_lr(1e-3, 30, 0.5, steps_per_epoch=2),
    "step, milestones": lambda m: m.step_lr(1e-3, [20, 45, 80], 0.1),
    "exp": lambda m: m.exp_lr(1e-3, 0.98, steps_per_epoch=3),
    "poly": lambda m: m.poly_lr(1e-3, 150, power=0.9, min_lr=1e-5),
    "inv": lambda m: m.inv_lr(1e-3, 0.05, power=0.75, steps_per_epoch=2),
    "cosine": lambda m: m.cosine_lr(1e-3, 150, target_lr=1e-5),
    "warmup constant": lambda m: m.with_warmup(m.cosine_lr(1e-3, 150), 40, 0.25, "constant"),
    "warmup linear": lambda m: m.with_warmup(m.poly_lr(1e-3, 150), 40, 0.25, "linear"),
    "warmup exp": lambda m: m.with_warmup(m.step_lr(1e-3, [60, 120]), 40, 0.25, "exp"),
}


@pytest.mark.parametrize("policy", list(LR_POLICIES))
def test_lr_policies_match_tdal(policy):
    """Every update count of 200, against tdal's f32 values (to f32 rounding: 1e-6
    relative, or 1e-9 absolute near zero)."""
    lr, jlr = LR_POLICIES[policy](schedules), LR_POLICIES[policy](jsched)
    for step in range(200):
        assert lr(step) == pytest.approx(float(jlr(step)), rel=1e-6, abs=1e-9), step
    with pytest.raises(ValueError):
        schedules.with_warmup(lr, 10, mode="cubic")(0)


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_schedule_matches_the_optax_chain(clip):
    """Identical gradients into both optimizers for 4 steps: the global-norm clip
    (which triggers at 1.0 on these gradients), decoupled weight decay on every
    parameter, and b1 / lr scheduled at the count of updates already taken."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    jlr, jmom = jsched.one_cycle(3e-3, 10)
    tx = jsched.adam_with_schedule(jlr, weight_decay=0.01, grad_clip=clip,
                                   momentum_schedule=jmom)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    lr, mom = schedules.one_cycle(3e-3, 10)
    opt = schedules.adam_with_schedule(list(tp.values()), lr, weight_decay=0.01,
                                       grad_clip=clip, momentum_schedule=mom)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_fused_conv_bn_train_and_eval_match_tdal():
    """A chained pair (the first emits its raw output and affine, the second applies
    it on its input side), train then eval, with the running statistics."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)

    class JChain(flax.linen.Module):
        @flax.linen.compact
        def __call__(self, x, train):
            y, pre = JFusedConvBN(8, use_bias=True, momentum=0.9, epsilon=1e-5)(
                x, train, emit_raw=True)
            return JFusedConvBN(5)(y, train, pre=pre)

    jm = JChain()
    v = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False))
    a = FusedConvBN(6, 8, use_bias=True, momentum=0.1, eps=1e-5)
    b = FusedConvBN(8, 5)
    for mod, name in ((a, "FusedConvBN_0"), (b, "FusedConvBN_1")):
        p, s = v["params"][name], v["batch_stats"][name]
        sd = {"weight": torch.from_numpy(p["kernel"]).permute(3, 2, 0, 1),
              "scale": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"]),
              "running_mean": torch.from_numpy(s["mean"]) + 0.3,
              "running_var": torch.from_numpy(s["var"]) * 1.7}
        if "conv_bias" in p:
            sd["conv_bias"] = torch.from_numpy(p["conv_bias"]) + 0.2
            p["conv_bias"] = sd["conv_bias"].numpy()
        s["mean"], s["var"] = sd["running_mean"].numpy(), sd["running_var"].numpy()
        mod.load_state_dict(sd)

    def port(train):
        a.train(train)
        b.train(train)
        y, pre = a(torch.from_numpy(x), emit_raw=True)
        return b(y, pre=pre)

    ref_eval = jm.apply(v, jnp.asarray(x), False)
    _close(port(False).detach().numpy(), ref_eval)
    ref_train, mut = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    _close(port(True).detach().numpy(), ref_train)
    for mod, name in ((a, "FusedConvBN_0"), (b, "FusedConvBN_1")):
        s = mut["batch_stats"][name]
        _close(mod.running_mean.numpy(), s["mean"], 1e-5, 1e-6)
        _close(mod.running_var.numpy(), s["var"], 1e-5, 1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_detector_forward_matches_tdal(pair, train):
    jdet, variables, tdet = pair
    model = copy.deepcopy(tdet).train(train)
    pts = _points(np.random.default_rng(5), 2)
    if train:
        ref, mut = jdet.apply(variables, jnp.asarray(pts), True, mutable=["batch_stats"])
    else:
        ref = jdet.apply(variables, jnp.asarray(pts), False)
    with torch.no_grad():
        got = model(torch.from_numpy(pts))
    for r, g in zip(ref, got):
        assert r.keys() == g.keys()
        for k in r:
            _close(g[k].numpy(), r[k], msg=k)
    if train:
        want = pointpillars_state_dict(model, variables["params"], _np_tree(mut)["batch_stats"])
        for k, v in model.state_dict().items():
            if "running" in k:
                _close(v.numpy(), want[k].numpy(), 1e-5, 1e-6, msg=k)


def test_center_head_loss_matches_tdal():
    rng = np.random.default_rng(6)
    batch = _batch(2, seed=6)
    preds = [{k: rng.normal(size=(2, 32, 32, c)).astype(np.float32)
              for k, c in (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("hm", 3))}]
    jt = _jbatch(batch)
    ref_total, ref_logs = jloss([{k: jnp.asarray(v) for k, v in preds[0].items()}],
                                {k: jt[k] for k in TARGET_KEYS}, CODE_WEIGHTS, 2.0)
    tt = {k: [torch.from_numpy(x) for x in batch[k]] for k in TARGET_KEYS}
    total, logs = center_head_loss([{k: torch.from_numpy(v) for k, v in preds[0].items()}],
                                   tt, CODE_WEIGHTS, 2.0)
    assert logs.keys() == ref_logs.keys()
    for k in logs:
        assert float(logs[k]) == pytest.approx(float(ref_logs[k]), rel=1e-5), k
    assert float(total) == pytest.approx(float(ref_total), rel=1e-5)


def test_bf16_heads_focal_loss_runs_in_f32():
    """A bf16 head's focal loss is the f32 focal loss of its (exactly widened) heatmap,
    finite where a heatmap logit saturates a bf16 sigmoid; tdal's bf16 loss is inf
    there (its clip at 1 - 1e-4 rounds to 1 in bf16), a fault of the reference that the
    port leaves out. The box loss keeps tdal's bf16 arithmetic."""
    rng = np.random.default_rng(7)
    batch = _batch(2, seed=7)
    preds = {k: rng.normal(size=(2, 32, 32, c)).astype(np.float32)
             for k, c in (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("hm", 3))}
    preds["hm"][0, 5, 5, 0] = 8.0  # sigmoid(8) is 1 in bf16
    bf16 = {k: torch.from_numpy(v).bfloat16() for k, v in preds.items()}
    tt = {k: [torch.from_numpy(x) for x in batch[k]] for k in TARGET_KEYS}
    total, logs = center_head_loss([bf16], tt, CODE_WEIGHTS, 2.0)
    _, widened = center_head_loss([{k: v.float() for k, v in bf16.items()}], tt,
                                  CODE_WEIGHTS, 2.0)
    assert torch.isfinite(total)
    assert float(logs["hm_loss_task0"]) == float(widened["hm_loss_task0"])
    jt = _jbatch(batch)
    ref, _ = jloss([{k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                     for k, v in bf16.items()}], {k: jt[k] for k in TARGET_KEYS},
                   CODE_WEIGHTS, 2.0)
    assert not np.isfinite(float(ref))


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


def _port_grads(model, batch):
    m = copy.deepcopy(model).train()
    preds = m(torch.from_numpy(batch["points"]))
    total, _ = center_head_loss(
        preds, {k: [torch.from_numpy(x) for x in batch[k]] for k in TARGET_KEYS},
        CODE_WEIGHTS, 2.0)
    total.backward()
    return {k: p.grad.numpy().astype(np.float64) for k, p in m.named_parameters()}


def _permute(batch, perm):
    return {k: ([x[perm] for x in v] if isinstance(v, list) else v[perm])
            for k, v in batch.items()}


def test_train_step_matches_tdal(pair):
    """One make_detector_steps step on the same weights and batch: the loss, the
    gradients against the measured noise floor, the BN running statistics, and the
    parameters after the clipped, OneCycle'd AdamW update."""
    jdet, variables, tdet = pair
    batch = _batch(3, seed=7)
    perm = np.array([2, 0, 1])
    lr_max, total_steps = 3e-3, 20

    def loss_of(params, b):
        preds, mut = jdet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                b["points"], train=True, mutable=["batch_stats"])
        return jloss(preds, {k: b[k] for k in TARGET_KEYS}, CODE_WEIGHTS, 2.0)[0]

    gfn = jax.jit(jax.value_and_grad(loss_of))
    loss_ref, g_ref = gfn(variables["params"], _jbatch(batch))
    _, g_ref_perm = gfn(variables["params"], _jbatch(_permute(batch, perm)))
    jlr, jmom = jsched.one_cycle(lr_max, total_steps)
    tx = jsched.adam_with_schedule(jlr, weight_decay=0.01, grad_clip=35.0,
                                   momentum_schedule=jmom)
    jstate = JTrainState.create(variables["params"], tx, variables["batch_stats"])
    jstep, _ = jmake_steps(jdet, TEST_CFG, CODE_WEIGHTS, 2.0, donate=False)
    jnew, jlogs = jstep(jstate, _jbatch(batch))
    assert float(jlogs["loss"]) == pytest.approx(float(loss_ref), rel=1e-6)

    g_port = _port_grads(tdet, batch)
    g_port_perm = _port_grads(tdet, _permute(batch, perm))
    bs = variables["batch_stats"]
    as_port = lambda tree: {k: v.numpy().astype(np.float64)  # noqa: E731
                            for k, v in pointpillars_state_dict(tdet, _np_tree(tree), bs).items()}
    g_want, g_want_perm = as_port(g_ref), as_port(g_ref_perm)

    model = copy.deepcopy(tdet)
    lr, mom = schedules.one_cycle(lr_max, total_steps)
    opt = schedules.adam_with_schedule(model.parameters(), lr, weight_decay=0.01,
                                       grad_clip=35.0, momentum_schedule=mom)
    state = TrainState(model, opt)
    logs = make_detector_steps(model, CODE_WEIGHTS, 2.0)(state, batch)
    assert state.step == 1
    assert float(logs["loss"]) == pytest.approx(float(loss_ref), rel=1e-5)

    new_want = {k: v.numpy().astype(np.float64) for k, v in pointpillars_state_dict(
        tdet, _np_tree(jnew.params), _np_tree(jnew.batch_stats)).items()}
    new_got = {k: v.numpy().astype(np.float64) for k, v in model.state_dict().items()}
    old = {k: v.numpy().astype(np.float64) for k, v in tdet.state_dict().items()}
    for k, g in g_port.items():
        want = g_want[k]
        noise = max(np.abs(want - g_want_perm[k]).max(), np.abs(g - g_port_perm[k]).max())
        tol = max(1e-4 * np.abs(want).max() + 1e-6, 8.0 * noise)
        err = np.abs(g - want).max()
        assert err <= tol, f"grad {k}: {err:.3e} > {tol:.3e} (noise {noise:.3e})"
        flip = np.abs(want) <= tol  # Adam's ~lr*sign(g) may take either sign here
        allowed = 1e-5 * (1 + np.abs(old[k])) + flip * 2.0 * lr(0)
        assert (np.abs(new_got[k] - new_want[k]) <= allowed).all(), k
        assert np.abs(new_got[k] - old[k]).max() > 0, f"{k} did not move"
    for k in new_got:
        if "running" in k:
            _close(new_got[k], new_want[k], 1e-5, 1e-6, msg=k)


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


def _narrow_config_path(tmp_path):
    """The Waymo PP config cut to the narrow size: (cfg with the narrow ``model``,
    voxel config, model on the CPU, 4-frame synthetic dataset)."""
    cfg = Config.fromfile(CONFIG)
    vox = dict(cfg.voxel_generator, range=list(VOX[0]), voxel_size=list(VOX[1]),
               max_points_in_voxel=8, max_voxel_num=[300, 300])
    voxel_cfg = build_voxel_config(vox)
    cfg.model = dict(cfg.model)
    cfg.model["reader"] = dict(cfg.model["reader"], num_filters=[16, 16])
    cfg.model["neck"] = dict(cfg.model["neck"], layer_nums=[1, 1, 1],
                             ds_num_filters=[16, 32, 64], us_num_filters=[16, 16, 16])
    model = build_detector(cfg.model, voxel_cfg, device="cpu", seed=0)
    assigner = build_assigner(dict(cfg.assigner, max_objs=16), model)
    infos, _ = make_synthetic_dataset(tmp_path / "data", n_scenes=1, n_frames=4, seed=1,
                                      n_background=600, points_per_object=32)
    ds = DetectionDataset(infos, cfg.class_names, assigner, voxel_cfg, max_points=800)
    return cfg, voxel_cfg, model, ds


def test_train_detector_runs_on_the_cpu(tmp_path):
    """The config path on a narrow model: Config.fromfile, build_detector on the CPU,
    a synthetic dataset, two steps of train_detector, a checkpoint that loads back."""
    cfg, voxel_cfg, model, ds = _narrow_config_path(tmp_path)
    model_cfg = cfg.model
    lr, mom = schedules.one_cycle(cfg.lr_config["lr_max"], 2)
    opt = schedules.adam_with_schedule(model.parameters(), lr, cfg.optimizer["wd"],
                                       cfg.grad_clip["max_norm"], mom)
    state = train_detector(TrainState(model, opt), ds, CODE_WEIGHTS, n_epoch=1,
                           batch_size=2, logger=logging.getLogger("t"),
                           work_dir=tmp_path / "work", log_every=1)
    assert state.step == 2
    lines = (tmp_path / "work" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all(np.isfinite(json.loads(x)["loss"]) for x in lines)
    (ckpt,) = (tmp_path / "work" / "checkpoints").glob("*.pt")
    fresh = build_detector(model_cfg, voxel_cfg, device="cpu", seed=1)
    restored = TrainState(fresh, schedules.adam_with_schedule(fresh.parameters(), lr)).load(ckpt)
    assert restored.step == 2
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_phase6_comparison_fails_both_controls(tmp_path):
    """chip_smoke's check of the card's train step against a CPU copy, run with the CPU
    on both sides: the sound step passes, and both controls (the statistics' backward
    without its 2*y*gss term; the same weights with bf16 activations) must fail it,
    each by far more than the margin between a pass and a fail."""
    import chip_smoke

    cfg, voxel_cfg, model, ds = _narrow_config_path(tmp_path)
    model_bf16 = build_detector(dict(cfg.model, dtype="bfloat16"), voxel_cfg,
                                device="cpu", seed=0)
    model_bf16.load_state_dict(model.state_dict())
    batch = collate_detection([ds[i] for i in range(4)])
    out = chip_smoke.check_step_against_cpu(model, model_bf16, batch, torch.device("cpu"),
                                            cfg, 4).result()
    assert out["grad_err_over_tol"] == 0.0  # the same device on both sides
    for name, reading in out["controls"].items():
        print(name, json.dumps(reading))
        assert reading["grad_err_over_tol"] > 10, name


def test_phase10_data_parallel_check_fails_both_controls(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 10's check of (a) and (c), run on the CPU (two gloo ranks
    against one process) on a narrow PointPillars and 256-point labeler sets: the sound
    steps pass, and both controls of each miss the gradient tolerance by more than 10x
    (the script raises when one passes)."""
    import chip_smoke
    from tdal_torch.parallel.controls import CONTROLS

    cfg, _, model, _ = _narrow_config_path(tmp_path)
    batch = _batch(4, seed=7)  # boxes inside the narrow grid: the heads have positives
    monkeypatch.setattr(chip_smoke, "NPOINTS_STATIC", 256)
    monkeypatch.setattr(chip_smoke, "log", print)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each spawned rank
    out = chip_smoke.check_dp_steps(model, batch, cfg, 4, torch.device("cpu"), ["cpu"] * 2,
                                    "gloo", tmp_path, labeler=chip_smoke.dp_labeler_inputs())
    assert out["readings"]["sound"]["grad_err_over_tol"] <= 1
    for name in CONTROLS:
        assert out["readings"][name]["grad_err_over_tol"] > 10, name
        assert out["labeler"]["readings"][name]["grad_err_over_tol"] > 10, name


def test_build_detector_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    cfg = Config.fromfile(CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, build_voxel_config(cfg.voxel_generator))


def test_detection_batches_raise_the_data_pipeline_error():
    """An error while a batch is prepared on the prefetch thread reaches the caller."""
    from tdal_torch.pipeline.detector_run import detection_batches

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError(f"frame {i} unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(detection_batches(Broken(), 2))
