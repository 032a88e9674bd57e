"""VoxelNet in the port against tdal, on the CPU, at a narrow size: the voxel mean,
the sparse and the dense middle backbone, and the tiny VoxelNet of
``tests/test_mesh_production.py`` (``sparse_middle=True``: the sparse backbone on a
(8, 16, 16) grid) through its forward, one train step and predict. Weights are tdal's
flax init converted by ``tdal_torch.convert``; inputs come from seeded numpy. At the
Waymo configs' full width the BEV channels and the parameter count are held against
tdal's through ``jax.eval_shape`` (no computation at the full grid).

Tolerances:
- the voxel mean: 1e-6 of max(1, |tdal|) (the same sums in another order);
- forwards: 1e-5 of max(1, |tdal|) for the backbones' outputs, and, through the
  train-mode BatchNorms of the RPN and head, rtol 1e-4 with atol 1e-4 of max(1,
  |tdal|), as ``tests/test_torch_detector_train.py`` (1/std of a batch of a few pixels
  amplifies f32 reassociation);
- BN running statistics: rtol 1e-5, atol 1e-6;
- gradients: per leaf max(1e-5 x max |tdal| + 1e-6, 8 x noise), noise being the
  larger of tdal's and the port's own change under a permutation of the batch (the
  method of ``tests/test_mesh_production.py:74-141``);
- parameters after the clipped, OneCycle'd AdamW step: 1e-5 x (1 + |p|), plus 2 lr
  where the gradient is within its tolerance of zero (Adam's first step may take
  either sign there);
- predictions: the kept boxes and scores within 1e-4 of max(1, |tdal|), the same
  labels and valid slots.
"""

import copy

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from tdal.core.voxel import VoxelConfig as JVoxelConfig
from tdal.models.builder import build_detector as jbuild_detector
from tdal.models.builder import build_voxel_config as jbuild_voxel_config
from tdal.models.center_head import center_head_loss as jloss
from tdal.models.detectors import VoxelNet as JVoxelNet
from tdal.models.readers import VoxelMeanEncoder as JVoxelMeanEncoder
from tdal.models.scn import MiddleBackbone as JMiddleBackbone
from tdal.models.scn_sparse import SparseMiddleBackbone as JSparseMiddleBackbone
from tdal.pipeline.detector_engine import make_detector_steps as jmake_steps
from tdal.runtime import schedules as jsched
from tdal.runtime.config import Config as JConfig
from tdal.runtime.train_state import TrainState as JTrainState
from tdal_torch.convert import (
    dense_backbone_state_dict, load_flax_voxelnet, sparse_backbone_state_dict,
    voxelnet_state_dict,
)
from tdal_torch.core.voxel import VoxelConfig, pad_points
from tdal_torch.data.detection import collate_detection
from tdal_torch.models.builder import build_detector, build_voxel_config
from tdal_torch.models.center_head import center_head_loss
from tdal_torch.models.detectors import VoxelNet
from tdal_torch.models.readers import VoxelMeanEncoder
from tdal_torch.models.scn import MiddleBackbone
from tdal_torch.models.scn_sparse import SparseMiddleBackbone
from tdal_torch.pipeline.detector_engine import (
    TARGET_KEYS, make_detector_steps, make_predict_step,
)
from tdal_torch.runtime import schedules
from tdal_torch.runtime.config import Config
from tdal_torch.runtime.train_state import TrainState

torch.set_num_threads(2)

VOX = ((-8, -8, -2, 8, 8, 4.0), (1.0, 1.0, 0.75), 5, 256)
TASKS = [dict(num_class=1, class_names=("VEHICLE",))]
TINY = dict(rpn_layer_nums=(1,), rpn_ds_strides=(1,), rpn_ds_filters=(8,),
            rpn_us_strides=(1,), rpn_us_filters=(8,))
TEST_CFG = dict(post_center_limit_range=[-10, -10, -10, 10, 10, 10],
                nms=dict(nms_pre_max_size=64, nms_post_max_size=32, nms_iou_threshold=0.7),
                score_threshold=0.0, pc_range=[-8, -8], out_size_factor=8,
                voxel_size=[1.0, 1.0])
CODE_WEIGHTS = [1.0] * 8
PERM, LR_MAX, TOTAL_STEPS = np.array([2, 0, 1]), 3e-3, 20
CONFIGS = ["configs/waymo/voxelnet/waymo_centerpoint_voxelnet_3x.py",
           "configs/waymo/voxelnet/two_stage/"
           "waymo_centerpoint_voxelnet_two_stage_bev_5point_ft_6epoch_freeze.py"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, flax.core.unfreeze(tree))


def _close(got, want, rtol=0.0, atol_scale=1e-5, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_scale * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def _sparse_inputs(b=2, v=64, n=(40, 31), grid=(4, 8, 8), c=5, seed=0):
    rng = np.random.default_rng(seed)
    coords = np.zeros((b, v, 3), np.int64)
    valid = np.zeros((b, v), bool)
    for i in range(b):
        lin = rng.choice(int(np.prod(grid)), n[i], replace=False)
        coords[i, : n[i]] = np.stack([lin // (grid[1] * grid[2]), (lin // grid[2]) % grid[1],
                                      lin % grid[2]], 1)
        valid[i, : n[i]] = True
    feats = (rng.normal(size=(b, v, c)) * valid[..., None]).astype(np.float32)
    return feats, coords, valid


def test_voxel_mean_encoder_matches_tdal():
    rng = np.random.default_rng(1)
    voxels = rng.normal(size=(2, 30, 5, 5)).astype(np.float32)
    num = rng.integers(0, 6, (2, 30))
    ref = JVoxelMeanEncoder().apply({}, jnp.asarray(voxels), jnp.asarray(num))
    got = VoxelMeanEncoder()(torch.from_numpy(voxels), torch.from_numpy(num))
    _close(got.numpy(), ref, atol_scale=1e-6)


def _backbone_pair(kind):
    """(tdal module, numpy variables, port module loaded from them, inputs). The
    variables are seeded normals of the shapes tdal's init gives (``jax.eval_shape``:
    no init run), running statistics away from 0 / 1 so eval normalises by them; the
    sparse backbone has one block a stage (tdal's ``blocks_per_stage``), so XLA compiles
    fewer convs."""
    if kind == "sparse":
        inputs = _sparse_inputs()
        jm = JSparseMiddleBackbone(grid_size=(4, 8, 8), channels=(8, 16), voxel_caps=(64, 64),
                                   blocks_per_stage=1)
        tm = SparseMiddleBackbone((4, 8, 8), 5, channels=(8, 16), voxel_caps=(64, 64),
                                  blocks_per_stage=1)
    else:
        inputs = _sparse_inputs(grid=(5, 6, 6), n=(50, 33))
        jm = JMiddleBackbone(grid_size=(5, 6, 6))
        tm = MiddleBackbone((5, 6, 6), 5)
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a),
                            *map(jnp.asarray, inputs))
    rng = np.random.default_rng(2)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "var" in name or "scale" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if "mean" in name or "bias" in name:
            return rng.uniform(-0.3, 0.3, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    v = _np_tree(jax.tree_util.tree_map_with_path(fill, shapes))
    if kind == "sparse":
        sd = sparse_backbone_state_dict(v["params"], v["batch_stats"])
    else:
        sd = dense_backbone_state_dict(tm, v["params"], v["batch_stats"])
    tm.load_state_dict(sd)
    return jm, v, tm, inputs, sd


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_middle_backbone_forward_and_gradients_match_tdal(kind):
    """Eval, then train: outputs, running statistics and every parameter's gradient of
    a random linear functional of the BEV. Train-mode outputs and gradients are held
    to max(1e-5 of max(1, |tdal|), 8 x tdal's own change under a swap of the two
    samples): the dense backbone's last BatchNorms see 8 values a channel, which
    amplify f32 reassociation to about 4e-4."""
    jm, v, tm, inputs, _ = _backbone_pair(kind)
    jin = [jnp.asarray(a) for a in inputs]
    tin = [torch.from_numpy(a) for a in inputs]
    ref_eval = jax.jit(jm.apply)(v, *jin)
    with torch.no_grad():
        got_eval = tm.eval()(*tin)
    assert got_eval.shape == ref_eval.shape
    assert got_eval.shape[-1] == tm.out_channels
    _close(got_eval.numpy(), ref_eval, msg="eval")

    r = np.random.default_rng(3).normal(size=ref_eval.shape).astype(np.float32)

    def loss(params, ins, r):
        out, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, *ins,
                            train=True, mutable=["batch_stats"])
        return (out * r).sum(), (out, mut)

    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))

    def ref_train(perm):
        ins = [a[np.asarray(perm)] for a in jin]
        (_, (out, mut)), g = grad_fn(v["params"], ins, r[perm])
        out = np.asarray(out)[np.argsort(perm)]
        if kind == "sparse":
            sd = sparse_backbone_state_dict(_np_tree(g), _np_tree(mut)["batch_stats"])
        else:
            sd = dense_backbone_state_dict(tm, _np_tree(g), _np_tree(mut)["batch_stats"])
        return out, sd

    (out_ref, want), (out_perm, want_perm) = ref_train([0, 1]), ref_train([1, 0])
    tm.train()
    out = tm(*tin)
    (out * torch.from_numpy(r)).sum().backward()
    params = dict(tm.named_parameters())
    pairs = [("train output", out.detach().numpy(), out_ref, out_perm)]
    pairs += [(f"grad {k}", params[k].grad.numpy(), w.numpy(), want_perm[k].numpy())
              for k, w in want.items() if "running" not in k]
    for name, got, ref, ref_perm in pairs:
        noise = np.abs(ref - ref_perm).max()
        tol = max(1e-5 * max(1.0, np.abs(ref).max()), 8.0 * noise)
        err = np.abs(got - ref).max()
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e} (noise {noise:.3e})"
    for k, w in want.items():
        if "running" in k:
            _close(tm.state_dict()[k].numpy(), w.numpy(), 1e-5, 1e-6, msg=k)


def _batch(n_items=3, seed=0):
    """Collated numpy batch of the tiny VoxelNet: one box a frame and 200 points."""
    rng = np.random.default_rng(seed)
    from tdal_torch.core.targets import AssignerConfig, assign_centernet_targets

    vox = VoxelConfig(*VOX)
    asg = AssignerConfig(tasks=[dict(num_class=1, class_names=["VEHICLE"])],
                         out_size_factor=8, max_objs=10)
    items = []
    for i in range(n_items):
        box = np.array([[rng.uniform(-4, 4), rng.uniform(-4, 4), 0.2, 1.8, 4.8, 1.5, 0, 0,
                         rng.uniform(-3, 3)]], np.float32)
        t = assign_centernet_targets(box, np.array([1], np.int32), asg, vox.grid_size,
                                     vox.point_cloud_range, vox.voxel_size)
        p = rng.uniform(-8, 8, (200, 5)).astype(np.float32)
        p[:, 2] = rng.uniform(-1.9, 3.9, 200)
        items.append(dict(t, points=pad_points(p, 256), token=f"t{i}"))
    batch = collate_detection(items)
    return {k: batch[k] for k in ("points", *TARGET_KEYS)}


def _jbatch(batch):
    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    """(tdal's tiny VoxelNet, its variables as numpy trees, the port's loaded from them)."""
    jdet = JVoxelNet(voxel_cfg=JVoxelConfig(*VOX), tasks=tuple(TASKS), sparse_middle=True,
                     **TINY)
    variables = _np_tree(jax.jit(jdet.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(_batch(2)["points"]), False))
    tdet = VoxelNet(VoxelConfig(*VOX), TASKS, sparse_middle=True, **TINY)
    assert isinstance(tdet.backbone, SparseMiddleBackbone)
    load_flax_voxelnet(tdet, variables["params"], variables["batch_stats"])
    return jdet, variables, tdet


@pytest.fixture(scope="module")
def tdal_step(pair):
    """tdal's train-mode loss, maps, running statistics and gradients (one jitted
    program) on the step's batch and on its permutation, and tdal's updated state
    after ``TrainState.apply_gradients`` with the clipped, OneCycle'd AdamW."""
    jdet, variables, _ = pair
    batch = _batch(3, seed=7)

    def loss_of(params, b):
        preds, mut = jdet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                b["points"], train=True, mutable=["batch_stats"])
        loss = jloss(preds, {k: b[k] for k in TARGET_KEYS}, CODE_WEIGHTS, 2.0)[0]
        return loss, (preds, mut)

    gfn = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    (loss, (preds, mut)), grads = gfn(variables["params"], _jbatch(batch))
    _, grads_perm = gfn(variables["params"], _jbatch(_permute(batch, PERM)))
    jlr, jmom = jsched.one_cycle(LR_MAX, TOTAL_STEPS)
    tx = jsched.adam_with_schedule(jlr, weight_decay=0.01, grad_clip=35.0,
                                   momentum_schedule=jmom)
    jstate = JTrainState.create(variables["params"], tx, variables["batch_stats"])
    new = jstate.apply_gradients(grads, mut["batch_stats"])
    return dict(batch=batch, loss=float(loss), preds=preds, batch_stats=mut["batch_stats"],
                grads=grads, grads_perm=grads_perm, new=new)


def test_voxelnet_train_forward_matches_tdal(pair, tdal_step):
    """The train-mode maps and running statistics (the eval forward is held through
    predict, below)."""
    _, variables, tdet = pair
    model = copy.deepcopy(tdet).train()
    with torch.no_grad():
        got = model(torch.from_numpy(tdal_step["batch"]["points"]))
    for r, g in zip(tdal_step["preds"], got):
        assert r.keys() == g.keys()
        for k in r:
            _close(g[k].numpy(), r[k], 1e-4, 1e-4, msg=k)
    want = voxelnet_state_dict(model, variables["params"],
                               _np_tree(tdal_step["batch_stats"]))
    for k, v in model.state_dict().items():
        if "running" in k:
            _close(v.numpy(), want[k].numpy(), 1e-5, 1e-6, msg=k)


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


def test_voxelnet_train_step_matches_tdal(pair, tdal_step):
    """One make_detector_steps step on the same weights and batch against tdal's step
    (its loss and gradient, ``TrainState.apply_gradients`` with the clipped,
    OneCycle'd AdamW): the loss, every gradient against the measured noise floor, the
    BN running statistics and the parameters after the update."""
    jdet, variables, tdet = pair
    batch, loss_ref, jnew = tdal_step["batch"], tdal_step["loss"], tdal_step["new"]
    g_ref, g_ref_perm = tdal_step["grads"], tdal_step["grads_perm"]
    perm, lr_max, total_steps = PERM, LR_MAX, TOTAL_STEPS

    g_port = _port_grads(tdet, batch)
    g_port_perm = _port_grads(tdet, _permute(batch, perm))
    bs = variables["batch_stats"]
    as_port = lambda tree: {k: v.numpy().astype(np.float64)  # noqa: E731
                            for k, v in voxelnet_state_dict(tdet, _np_tree(tree), bs).items()}
    g_want, g_want_perm = as_port(g_ref), as_port(g_ref_perm)

    model = copy.deepcopy(tdet)
    lr, mom = schedules.one_cycle(lr_max, total_steps)
    opt = schedules.adam_with_schedule(model.parameters(), lr, weight_decay=0.01,
                                       grad_clip=35.0, momentum_schedule=mom)
    state = TrainState(model, opt)
    logs = make_detector_steps(model, CODE_WEIGHTS, 2.0)(state, batch)
    assert float(logs["loss"]) == pytest.approx(float(loss_ref), rel=1e-5)

    new_want = {k: v.numpy().astype(np.float64) for k, v in voxelnet_state_dict(
        tdet, _np_tree(jnew.params), _np_tree(jnew.batch_stats)).items()}
    new_got = {k: v.numpy().astype(np.float64) for k, v in model.state_dict().items()}
    old = {k: v.numpy().astype(np.float64) for k, v in tdet.state_dict().items()}
    assert any(k.startswith("backbone.w_blk") for k in g_port)
    for k, g in g_port.items():
        want = g_want[k]
        noise = max(np.abs(want - g_want_perm[k]).max(), np.abs(g - g_port_perm[k]).max())
        tol = max(1e-5 * np.abs(want).max() + 1e-6, 8.0 * noise)
        err = np.abs(g - want).max()
        assert err <= tol, f"grad {k}: {err:.3e} > {tol:.3e} (noise {noise:.3e})"
        flip = np.abs(want) <= tol
        allowed = 1e-5 * (1 + np.abs(old[k])) + flip * 2.0 * lr(0)
        assert (np.abs(new_got[k] - new_want[k]) <= allowed).all(), k
    for k in new_got:
        if "running" in k:
            _close(new_got[k], new_want[k], 1e-5, 1e-6, msg=k)


def test_voxelnet_predict_matches_tdal(pair):
    jdet, variables, tdet = pair
    pts = _batch(2, seed=9)["points"]
    jstate = JTrainState.create(variables["params"], jsched.adam_with_schedule(
        jsched.one_cycle(1e-3, 10)[0]), variables["batch_stats"])
    _, jpredict = jmake_steps(jdet, TEST_CFG, CODE_WEIGHTS, 2.0, donate=False)
    ref = jax.tree_util.tree_map(np.asarray, jpredict(jstate, jnp.asarray(pts)))
    got = make_predict_step(tdet, TEST_CFG)(TrainState(tdet, None), torch.from_numpy(pts))
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    assert ref["valid"].sum() > 0
    ok = ref["valid"]
    np.testing.assert_array_equal(got["label_preds"].numpy()[ok], ref["label_preds"][ok])
    _close(got["box3d_lidar"].numpy()[ok], ref["box3d_lidar"][ok], atol_scale=1e-4)
    _close(got["scores"].numpy()[ok], ref["scores"][ok], atol_scale=1e-4)


@pytest.mark.parametrize("config", CONFIGS)
def test_waymo_voxelnet_width_matches_tdal(config):
    """The full-width Waymo VoxelNet (the two-stage config's first stage in bf16): the
    grid, the sparse backbone's choice, 384 BEV channels into the RPN, 512 out of it,
    and the parameter count, against tdal's shapes from ``jax.eval_shape``."""
    cfg, jcfg = Config.fromfile(config), JConfig.fromfile(config)
    assert cfg.to_dict() == jcfg.to_dict()
    model_cfg = cfg.model.get("first_stage_cfg", cfg.model)
    vox = build_voxel_config(cfg.voxel_generator)
    model = build_detector(model_cfg, vox, device="cpu")
    jmodel_cfg = jcfg.model.get("first_stage_cfg", jcfg.model)
    jdet = jbuild_detector(jmodel_cfg, jbuild_voxel_config(jcfg.voxel_generator))
    points = jax.ShapeDtypeStruct((1, 1000, 5), jnp.float32)

    def init_and_apply(p):
        variables = jdet.init(jax.random.PRNGKey(0), p)
        return variables["params"], jdet.apply(variables, p, return_feature=True)[1]

    jparams, bev = jax.eval_shape(init_and_apply, points)
    rpn_in = jparams["RPN_0"]["ConvBNReLU_0"]["FusedConvBN_0"]["kernel"].shape[2]
    assert tuple(int(g) for g in vox.grid_size) == (1504, 1504, 40)
    assert isinstance(model.backbone, SparseMiddleBackbone)
    assert rpn_in == model.backbone.out_channels == 384
    assert bev.shape[-1] == model.rpn.out_channels == 512
    assert model.out_size_factor == 8 and bev.shape[1:3] == (188, 188)
    n_tdal = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in model.parameters()) == n_tdal
    bf16 = jmodel_cfg.get("dtype") == "bfloat16"
    assert model.rpn.dtype == (torch.bfloat16 if bf16 else torch.float32)
