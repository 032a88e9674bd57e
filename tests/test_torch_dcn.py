"""The deformable head and the SepHead depths in the port against tdal, on the CPU:
``deform_sample`` and its gradients, ``DCNSepHead``, ``CenterHead(dcn_head=True)``,
``SepHead`` at depths 1, 3 and unequal, and the two-sweep velocity VoxelNet config
(``configs/waymo/voxelnet/waymo_centerpoint_voxelnet_two_sweeps_3x_with_velo.py``),
narrowed, with and without ``dcn_head``: one train step against tdal's, and predict
with the deformable head. Weights are tdal's flax init (or seeded normals of its
shapes) converted by ``tdal_torch.convert``; inputs come from seeded numpy.

Tolerances:
- ``deform_sample``: forward 1e-6 of max(1, |tdal|); the gradients with respect to
  ``x`` and to the offsets 1e-5 of max(1, |tdal|) against ``jax.grad`` (the same f32
  products summed in another order). Sampling coordinates are kept 1e-3 from the
  integers, where bilinear sampling has a kink;
- heads: outputs and BN running statistics 1e-5 of max(1, |tdal|);
- the train step, as ``tests/test_torch_voxelnet.py``: the loss 1e-5 relative, each
  gradient within max(1e-5 x max |tdal| + 1e-6, 8 x noise), the parameters after the
  AdamW step within 1e-5 x (1 + |p|) plus 2 lr where the gradient is within its
  tolerance of zero, the running statistics rtol 1e-5 with atol 1e-6. The noise is the
  largest of the two packages' own change under a permutation of the batch and tdal's
  under a mirrored pair of rounding-level weight changes (x (1 +- 2^-19 u), the terms
  of ``chip_smoke.py``'s floor): the dense middle backbone's BatchNorms over a filled
  grid move whole ReLU patterns under such a change, which no permutation shows;
- predict: the kept boxes and scores 1e-4 of max(1, |tdal|), the same labels and
  valid slots.
The step runs the config in f32 (the config declares bf16; parity is judged in f32).
"""

import copy
import functools

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from tdal.models.builder import build_detector as jbuild_detector
from tdal.models.builder import build_voxel_config as jbuild_voxel_config
from tdal.models.center_head import CenterHead as JCenterHead
from tdal.models.center_head import SepHead as JSepHead
from tdal.models.center_head import center_head_loss as jloss
from tdal.models.dcn import DCNSepHead as JDCNSepHead
from tdal.models.dcn import deform_sample as jdeform_sample
from tdal.pipeline.detector_engine import make_detector_steps as jmake_steps
from tdal.runtime import schedules as jsched
from tdal.runtime.config import Config as JConfig
from tdal.runtime.train_state import TrainState as JTrainState
from tdal_torch.convert import (
    _fused, dcn_sep_head_state_dict, load_flax_voxelnet, sep_head_state_dict,
    voxelnet_state_dict,
)
from tdal_torch.core.targets import AssignerConfig, assign_centernet_targets
from tdal_torch.core.voxel import pad_points
from tdal_torch.data.detection import collate_detection
from tdal_torch.models.builder import build_detector, build_voxel_config
from tdal_torch.models.center_head import CenterHead, SepHead, center_head_loss
from tdal_torch.models.dcn import DCNSepHead, FeatureAdaption, deform_sample
from tdal_torch.pipeline.detector_engine import (
    TARGET_KEYS, make_detector_steps, make_predict_step,
)
from tdal_torch.runtime import schedules
from tdal_torch.runtime.config import Config
from tdal_torch.runtime.train_state import TrainState

torch.set_num_threads(2)

TWO_SWEEPS = "configs/waymo/voxelnet/waymo_centerpoint_voxelnet_two_sweeps_3x_with_velo.py"
# the narrowed config: a 64 x 64 x 4 grid (the dense middle backbone, as tdal picks
# below 2^24 cells) that the points fill (an empty region would share one value a
# channel, whose ReLU either package may flip), an 8 x 8 BEV into one-layer RPN stages
# of 16 / 32 channels
HALF, N_POINTS = 16.0, 60000
NARROW_VOX = dict(range=[-HALF, -HALF, -2.0, HALF, HALF, 4.0], voxel_size=[0.5, 0.5, 1.5],
                  max_points_in_voxel=5, max_voxel_num=[16384, 16384])
NARROW_NECK = dict(layer_nums=[1, 1], ds_num_filters=[16, 32], us_num_filters=[16, 16])
NARROW_TEST = dict(post_center_limit_range=[-20, -20, -10, 20, 20, 10],
                   nms=dict(nms_pre_max_size=64, nms_post_max_size=16, nms_iou_threshold=0.7),
                   score_threshold=0.0, pc_range=[-HALF, -HALF], out_size_factor=8,
                   voxel_size=[0.5, 0.5])
PERM, LR_MAX, TOTAL_STEPS = np.array([2, 0, 1]), 3e-3, 20


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, flax.core.unfreeze(tree))


def _close(got, want, rtol=0.0, atol_scale=1e-5, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_scale * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# deform_sample
# ---------------------------------------------------------------------------


def _sample_inputs(zero_offsets=False, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    if zero_offsets:
        return x, np.zeros((2, 7, 9, 18), np.float32)
    off = rng.uniform(-2.5, 2.5, (2, 7, 9, 18)).astype(np.float32)
    # keep every coordinate (integer base + offset) 1e-3 from the integers
    frac = off - np.round(off)
    off = np.where(np.abs(frac) < 1e-3, off + 2e-3 * np.where(frac < 0, -1, 1), off)
    return x, off.astype(np.float32)


@pytest.mark.parametrize("zero_offsets", [False, True])
def test_deform_sample_and_its_gradients_match_tdal(zero_offsets):
    """Random offsets in [-2.5, 2.5] (taps outside the image included), or exactly
    zero ones, where both packages take the same side of the kink."""
    x, off = _sample_inputs(zero_offsets)
    r = np.random.default_rng(1).normal(size=(2, 7, 9, 9, 5)).astype(np.float32)
    jx, joff = jnp.asarray(x), jnp.asarray(off)
    ref = jdeform_sample(jx, joff)
    gx, goff = jax.grad(lambda a, b: (jdeform_sample(a, b) * r).sum(), argnums=(0, 1))(jx, joff)
    tx = torch.from_numpy(x).requires_grad_()
    toff = torch.from_numpy(off).requires_grad_()
    got = deform_sample(tx, toff)
    assert got.shape == ref.shape == (2, 7, 9, 9, 5) and got.dtype == torch.float32
    (got * torch.from_numpy(r)).sum().backward()
    _close(got.detach().numpy(), ref, atol_scale=1e-6, msg="taps")
    _close(tx.grad.numpy(), gx, msg="d x")
    _close(toff.grad.numpy(), goff, msg="d offsets")
    if not zero_offsets:  # some taps fall outside the image, and gather nothing there
        coords = np.arange(7)[None, :, None, None] + off.reshape(2, 7, 9, 9, 2)[..., 0]
        assert (coords < -1).any() and (coords > 7).any()


def test_deform_sample_pins_the_reference_cases():
    """``tests/test_aux_components.py:10-31``: zero offsets give the conv patch (the
    centre tap is x, out-of-image taps are 0), and a +0.5 row offset of the centre tap
    gives the midpoint of two rows."""
    x = torch.arange(2 * 5 * 5, dtype=torch.float32).reshape(2, 5, 5, 1)
    taps = deform_sample(x, torch.zeros(2, 5, 5, 18))
    assert taps.shape == (2, 5, 5, 9, 1)
    assert taps[0, 2, 2, 4, 0] == x[0, 2, 2, 0]
    assert taps[0, 0, 0, 0, 0] == 0.0
    x = torch.arange(25, dtype=torch.float32).reshape(1, 5, 5, 1)
    offsets = torch.zeros(1, 5, 5, 18)
    offsets[..., 8] = 0.5  # tap 4 (the centre), dy = +0.5
    assert float(deform_sample(x, offsets)[0, 2, 2, 4, 0]) == (12 + 17) / 2


# ---------------------------------------------------------------------------
# the heads, converted from tdal's variables
# ---------------------------------------------------------------------------


def _variables(module, *inputs, **kw):
    """tdal's variables of ``module`` as seeded normals of its init shapes (no init
    run), non-zero offset convs included, running statistics away from 0 / 1."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw),
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

    return _np_tree(jax.tree_util.tree_map_with_path(fill, shapes))


def _head_pair(kind, heads=None):
    """(tdal module, variables, port module loaded from them, state_dict function)."""
    if kind == "sep":
        jm = JSepHead(heads, head_conv=8)
        tm = SepHead(6, heads, head_conv=8)
        convert = lambda v: sep_head_state_dict(tm, v["params"], v.get("batch_stats", {}))  # noqa: E731
    elif kind == "dcn":
        jm = JDCNSepHead(heads={"reg": (2, 2), "height": (1, 2), "vel": (2, 2)}, num_cls=3,
                         head_conv=8)
        tm = DCNSepHead(6, {"reg": (2, 2), "height": (1, 2), "vel": (2, 2)}, 3, head_conv=8)
        convert = lambda v: dcn_sep_head_state_dict(tm, v["params"], v["batch_stats"])  # noqa: E731
    else:
        tasks = ({"num_class": 1, "class_names": ["VEHICLE"]},
                 {"num_class": 2, "class_names": ["PEDESTRIAN", "CYCLIST"]})
        common = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2)}
        jm = JCenterHead(tasks=tasks, common_heads=common, share_conv_channel=6,
                         dcn_head=True)
        tm = CenterHead(5, tasks, common, share_conv_channel=6, dcn_head=True)

        def convert(v):
            p, bs, out = v["params"], v["batch_stats"], {}
            _fused(out, "shared.", p["FusedConvBN_0"], bs["FusedConvBN_0"])
            for t, task in enumerate(tm.tasks):
                out.update(dcn_sep_head_state_dict(task, p[f"DCNSepHead_{t}"],
                                                   bs[f"DCNSepHead_{t}"], f"tasks.{t}."))
            return out
    return jm, tm, convert


def _run_head_pair(jm, tm, convert, x, pre=None):
    """Eval, then train: the maps (a dict, or a list of dicts) and the running
    statistics of both packages."""
    kw = {} if pre is None else {"pre": tuple(map(jnp.asarray, pre))}
    v = _variables(jm, x, **kw)
    tm.load_state_dict(convert(v))
    tin = torch.from_numpy(x)
    tkw = {} if pre is None else {"pre": tuple(map(torch.from_numpy, pre))}
    flat = lambda o: o if isinstance(o, list) else [o]  # noqa: E731
    ref_eval = flat(jm.apply(v, jnp.asarray(x), **kw))
    with torch.no_grad():
        got_eval = flat(tm.eval()(tin, **tkw))
    ref_train, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"], **kw)
    with torch.no_grad():
        got_train = flat(tm.train()(tin, **tkw))
    for tag, refs, gots in (("eval", ref_eval, got_eval),
                            ("train", flat(ref_train), got_train)):
        for r, g in zip(refs, gots):
            assert r.keys() == g.keys()
            for k in r:
                assert g[k].shape == r[k].shape
                _close(g[k].numpy(), r[k], msg=f"{tag} {k}")
    want = convert({"params": v["params"], "batch_stats": _np_tree(mut.get("batch_stats", {}))})
    stats = [k for k in want if "running" in k]
    for k in stats:
        _close(tm.state_dict()[k].numpy(), want[k].numpy(), 1e-5, 1e-6, msg=k)
    return stats


@pytest.mark.parametrize("kind", ["dcn", "center"])
def test_dcn_heads_match_tdal(kind):
    """``DCNSepHead`` (velocity among its heads) and ``CenterHead(dcn_head=True)``
    over two tasks, in eval and in train, with their BN running statistics."""
    jm, tm, convert = _head_pair(kind)
    x = np.random.default_rng(3).normal(size=(2, 9, 11, 6 if kind == "dcn" else 5))
    stats = _run_head_pair(jm, tm, convert, x.astype(np.float32))
    assert any("cls_bn" in k for k in stats) and any("branch_convbn0" in k for k in stats)


SEP_CASES = {
    "depth 1": {"reg": (2, 1), "height": (1, 1), "hm": (3, 1)},
    "depth 3": {"reg": (2, 3), "height": (1, 3), "hm": (3, 3)},
    "depth 4": {"reg": (2, 4), "hm": (3, 4)},
    "unequal depths": {"reg": (2, 2), "height": (1, 3), "hm": (3, 1)},
    "one branch": {"hm": (3, 2)},
}


@pytest.mark.parametrize("chained", [False, True])
@pytest.mark.parametrize("case", list(SEP_CASES))
def test_sep_head_depths_match_tdal(case, chained):
    """``SepHead`` at the depths the configs do not use, with and without the shared
    conv's normalise + ReLU handed in (``pre``)."""
    jm, tm, convert = _head_pair("sep", SEP_CASES[case])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    pre = ((rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.normal(size=6).astype(np.float32))
           if chained else None)
    _run_head_pair(jm, tm, convert, x, pre)


# ---------------------------------------------------------------------------
# the two-sweep velocity VoxelNet config, narrowed
# ---------------------------------------------------------------------------


def _narrowed(cfg, dcn_head):
    """The config's model and voxel dicts narrowed (``NARROW_*``), in f32."""
    model = copy.deepcopy(cfg.model)
    model["dtype"] = "float32"
    model["neck"].update(NARROW_NECK)
    model["bbox_head"]["dcn_head"] = dcn_head
    return model, dict(cfg.voxel_generator, **NARROW_VOX)


def _batch(n_items=3, seed=0):
    """Collated numpy batch: two sweeps' points (x, y, z, intensity, elongation, time
    lag 0 or 0.1) and two moving boxes a frame."""
    rng = np.random.default_rng(seed)
    vox = build_voxel_config(NARROW_VOX)
    asg = AssignerConfig(tasks=[dict(num_class=3, class_names=["VEHICLE", "PEDESTRIAN",
                                                               "CYCLIST"])],
                         out_size_factor=8, max_objs=10)
    items = []
    for i in range(n_items):
        boxes = np.array([[rng.uniform(-12, 12), rng.uniform(-12, 12), 0.2, 1.8, 4.8, 1.5,
                           rng.uniform(-5, 5), rng.uniform(-5, 5), rng.uniform(-3, 3)]
                          for _ in range(2)], np.float32)
        t = assign_centernet_targets(boxes, np.array([1, 3], np.int32), asg, vox.grid_size,
                                     vox.point_cloud_range, vox.voxel_size)
        n = N_POINTS
        p = np.concatenate([rng.uniform(-HALF, HALF, (n, 3)), rng.uniform(-1, 1, (n, 2)),
                            np.repeat([[0.0], [0.1]], n // 2, axis=0)], 1).astype(np.float32)
        p[:, 2] = rng.uniform(-1.9, 3.9, n)
        items.append(dict(t, points=pad_points(p, n), token=f"t{i}"))
    batch = collate_detection(items)
    return {k: batch[k] for k in ("points", *TARGET_KEYS)}


def _jbatch(batch):
    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
            for k, v in batch.items()}


def _permute(batch, perm):
    return {k: ([x[perm] for x in v] if isinstance(v, list) else v[perm])
            for k, v in batch.items()}


def test_two_sweep_config_matches_tdal_at_full_width():
    """The config reads the same in both packages, and the deformable head on it
    builds at full width with tdal's parameter count (``jax.eval_shape``)."""
    cfg, jcfg = Config.fromfile(TWO_SWEEPS), JConfig.fromfile(TWO_SWEEPS)
    assert cfg.to_dict() == jcfg.to_dict()
    model = copy.deepcopy(cfg.model)
    model["bbox_head"]["dcn_head"] = True
    det = build_detector(model, build_voxel_config(cfg.voxel_generator), device="cpu")
    jdet = jbuild_detector(model, jbuild_voxel_config(jcfg.voxel_generator))
    jparams = jax.eval_shape(lambda p: jdet.init(jax.random.PRNGKey(0), p)["params"],
                             jax.ShapeDtypeStruct((1, 1000, 6), jnp.float32))
    assert sum(p.numel() for p in det.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jparams))
    assert det.with_velocity and det.head.dcn_head and det.rpn.dtype == torch.bfloat16
    assert det.backbone.out_channels == 384 and det.out_size_factor == 8


@functools.lru_cache(maxsize=None)
def _pair(dcn_head):
    """(tdal's narrowed detector, its variables as numpy trees, the port's loaded from
    them, the code weights)."""
    cfg = Config.fromfile(TWO_SWEEPS)
    model, vox = _narrowed(cfg, dcn_head)
    jdet = jbuild_detector(model, jbuild_voxel_config(vox))
    variables = _np_tree(jax.jit(jdet.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(_batch(2)["points"]), False))
    tdet = build_detector(model, build_voxel_config(vox), device="cpu")
    load_flax_voxelnet(tdet, variables["params"], variables["batch_stats"])
    return jdet, variables, tdet, list(model["bbox_head"]["code_weights"])


def _perturbed(params, sign, seed=1):
    """tdal's params with every weight scaled by 1 + sign * 2^-19 * u, u uniform in
    [-1, 1] from ``seed``: a rounding-level change of the weights."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * (1 + sign * 2.0**-19 * rng.uniform(-1, 1, a.shape))).astype(np.float32),
        params)


def _port_grads(model, batch, code_weights):
    m = copy.deepcopy(model).train()
    preds = m(torch.from_numpy(batch["points"]))
    total, _ = center_head_loss(
        preds, {k: [torch.from_numpy(x) for x in batch[k]] for k in TARGET_KEYS},
        code_weights, 2.0, has_vel=True)
    total.backward()
    return {k: p.grad.numpy().astype(np.float64) for k, p in m.named_parameters()}


@pytest.mark.parametrize("dcn_head", [False, True])
def test_two_sweep_train_step_matches_tdal(dcn_head):
    """One ``make_detector_steps`` step against tdal's (its loss and gradient, then
    ``TrainState.apply_gradients`` with the clipped, OneCycle'd AdamW): the loss,
    every gradient against the measured noise floor, the parameters after the update
    and the BN running statistics. The step moves the deformable head's offset convs
    and kernels."""
    jdet, variables, tdet, code_weights = _pair(dcn_head)
    batch = _batch(3, seed=7)

    def loss_of(params, b):
        preds, mut = jdet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                b["points"], train=True, mutable=["batch_stats"])
        loss = jloss(preds, {k: b[k] for k in TARGET_KEYS}, code_weights, 2.0,
                     has_vel=True)[0]
        return loss, mut

    gfn = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    (loss_ref, mut), g_ref = gfn(variables["params"], _jbatch(batch))
    _, g_ref_perm = gfn(variables["params"], _jbatch(_permute(batch, PERM)))
    g_ref_moved = [gfn(_perturbed(variables["params"], sign), _jbatch(batch))[1]
                   for sign in (1, -1)]
    jlr, jmom = jsched.one_cycle(LR_MAX, TOTAL_STEPS)
    tx = jsched.adam_with_schedule(jlr, weight_decay=0.01, grad_clip=35.0,
                                   momentum_schedule=jmom)
    jnew = JTrainState.create(variables["params"], tx, variables["batch_stats"]
                              ).apply_gradients(g_ref, mut["batch_stats"])

    g_port = _port_grads(tdet, batch, code_weights)
    g_port_perm = _port_grads(tdet, _permute(batch, PERM), code_weights)
    bs = variables["batch_stats"]
    as_port = lambda tree: {k: v.numpy().astype(np.float64)  # noqa: E731
                            for k, v in voxelnet_state_dict(tdet, _np_tree(tree), bs).items()}
    g_want, g_want_perm = as_port(g_ref), as_port(g_ref_perm)
    g_want_moved = [as_port(g) for g in g_ref_moved]

    model = copy.deepcopy(tdet)
    lr, mom = schedules.one_cycle(LR_MAX, TOTAL_STEPS)
    opt = schedules.adam_with_schedule(model.parameters(), lr, weight_decay=0.01,
                                       grad_clip=35.0, momentum_schedule=mom)
    logs = make_detector_steps(model, code_weights, 2.0)(TrainState(model, opt), batch)
    assert float(logs["loss"]) == pytest.approx(float(loss_ref), rel=1e-5)

    new_want = {k: v.numpy().astype(np.float64) for k, v in voxelnet_state_dict(
        tdet, _np_tree(jnew.params), _np_tree(jnew.batch_stats)).items()}
    new_got = {k: v.numpy().astype(np.float64) for k, v in model.state_dict().items()}
    old = {k: v.numpy().astype(np.float64) for k, v in tdet.state_dict().items()}
    if tdet.head.dcn_head:
        moved = [k for k in g_port if "offset" in k or "deform" in k]
        assert len(moved) == 6 and all(np.abs(g_port[k]).max() > 0 for k in moved)
    for k, g in g_port.items():
        want = g_want[k]
        noise = max(np.abs(want - g_want_perm[k]).max(), np.abs(g - g_port_perm[k]).max(),
                    *(np.abs(want - m[k]).max() for m in g_want_moved))
        tol = max(1e-5 * np.abs(want).max() + 1e-6, 8.0 * noise)
        err = np.abs(g - want).max()
        assert err <= tol, f"grad {k}: {err:.3e} > {tol:.3e} (noise {noise:.3e})"
        flip = np.abs(want) <= tol
        allowed = 1e-5 * (1 + np.abs(old[k])) + flip * 2.0 * lr(0)
        assert (np.abs(new_got[k] - new_want[k]) <= allowed).all(), k
    for k in new_got:
        if "running" in k:
            _close(new_got[k], new_want[k], 1e-5, 1e-6, msg=k)


def test_two_sweep_dcn_predict_matches_tdal():
    jdet, variables, tdet, code_weights = _pair(True)
    pts = _batch(2, seed=9)["points"]
    jstate = JTrainState.create(variables["params"], jsched.adam_with_schedule(
        jsched.one_cycle(1e-3, 10)[0]), variables["batch_stats"])
    _, jpredict = jmake_steps(jdet, NARROW_TEST, code_weights, 2.0, donate=False)
    ref = jax.tree_util.tree_map(np.asarray, jpredict(jstate, jnp.asarray(pts)))
    got = make_predict_step(tdet, NARROW_TEST)(TrainState(tdet, None), torch.from_numpy(pts))
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    assert ref["valid"].sum() > 0 and ref["box3d_lidar"].shape[-1] == 9
    ok = ref["valid"]
    np.testing.assert_array_equal(got["label_preds"].numpy()[ok], ref["label_preds"][ok])
    _close(got["box3d_lidar"].numpy()[ok], ref["box3d_lidar"][ok], atol_scale=1e-4)
    _close(got["scores"].numpy()[ok], ref["scores"][ok], atol_scale=1e-4)


def test_phase12_comparison_fails_the_trunc_control():
    """``chip_smoke.py`` phase 12's check of the card's step against a CPU copy, run
    with the CPU on both sides on the narrowed two-sweep deformable VoxelNet, its offset
    convs' biases moved off zero (as the warm epoch moves them): the sound step passes,
    and the sampler that splits coordinates with ``trunc`` in place of ``floor`` fails
    it by far more than the margin between a pass and a fail."""
    import chip_smoke

    cfg = Config.fromfile(TWO_SWEEPS)
    model_cfg, vox = _narrowed(cfg, True)
    model = build_detector(model_cfg, build_voxel_config(vox), device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FeatureAdaption):
                m.offset.bias.uniform_(-0.3, 0.3, generator=gen)
    control = {"trunc": (model, chip_smoke.trunc_sampling, "grad_err_over_tol")}
    out = chip_smoke.check_step_with_controls(model, _batch(2, seed=3), torch.device("cpu"),
                                              cfg, 4, control, stat_noise=True).result()
    assert out["grad_err_over_tol"] == 0.0  # the same device on both sides
    assert out["controls"]["trunc"]["grad_err_over_tol"] > 10
    coords = chip_smoke.knife_edges(model, torch.from_numpy(_batch(2, seed=3)["points"]),
                                    torch.device("cpu"))
    assert {k: v["floors_differ"] for k, v in coords.items()} == {"center_adapt": 0,
                                                                   "reg_adapt": 0}

