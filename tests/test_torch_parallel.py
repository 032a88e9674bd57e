"""Data parallelism in the port (``tdal_torch.parallel.mesh``) and its per-sequence
fan-out (``tdal_torch.pipeline.shard``) against tdal, on the CPU over gloo.

The data-parallel steps run in two spawned ranks (one thread each) that import this
module, so jax and tdal are imported only inside the tests and fixtures that use them:
a rank loads neither. One module fixture spawns the ranks once for every step below.

Cases and tolerances:
- ``pad_to_multiple``, the rank slices, ``shard.py``: exactly tdal's results.
- Two processes from ``torchrun``'s environment: exact sums and gathers.
- pp_tiny (``configs/synthetic/pp_tiny.py``) at a global batch of 4 on 2 ranks against
  tdal's step on a 2-device slice of the conftest's 8-device CPU mesh, on the same numpy
  batch and converted weights. The tolerances of ``tests/test_torch_detector_train.py``,
  tighter than ``tests/test_multihost.py:155``'s (rtol 2e-3, atol 5e-4) and passing:
  the loss 1e-5 relative; each gradient leaf within max(1e-4 of its largest value +
  1e-6, 8 x noise), noise the larger of tdal's and the port's change under a
  permutation of the batch (float reassociation, which the BatchNorm backward
  amplifies); the parameters after the clipped AdamW step 1e-5 (1 + |p|), plus 2 lr
  where the gradient is within its tolerance of 0 (Adam's first step may take either
  sign); the running statistics rtol 1e-5, atol 1e-6 of max(1, |x|).
- The static labeler (``__graft_entry__.dryrun_multichip``'s setup: one box, 16 object
  points, 64 points, batch 4) on 2 ranks against tdal's sharded labeler step, with the
  same gather noise and dropout mask on both sides; the tolerances of
  ``tests/test_torch_labeler_train.py`` (8 x tdal's permutation floor, or 1e-5 of
  max(1, |x|); parameters 1e-6 (1 + |p|) plus Adam's sign either way).
- A tiny VoxelNet (sparse backbone) and the two-stage RoI head on 2 ranks against the
  port's single-process step: the same gradient rule with the port's own permutation
  floor; loss and logs 1e-5 relative.
- ``train_detector`` with a validation on 2 ranks (sharded inference, rank 0's AP/APH):
  the val row equals one process's ``evaluate_detector`` of the same weights within
  1e-6, and the gathered detections one process's within 1e-5 (each rank predicts
  half the rows of a batch: float reassociation only).
- The controls (per-rank BatchNorm statistics; per-rank loss normalizers) must miss the
  gradient tolerance by more than 10x.
- Every rank ends a step with the same weights and running statistics, bit for bit.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from tdal_torch.parallel import mesh as pmesh
from tdal_torch.parallel.controls import CONTROLS, control
from tdal_torch.pipeline import shard

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PP_TINY = ROOT / "configs/synthetic/pp_tiny.py"
TWO_STAGE_TINY = ROOT / "configs/synthetic/pp_two_stage_tiny.py"
WORLD, BATCH = 2, 4
PERM = [2, 0, 3, 1]
GRAD_MARGIN = 8
LR_MAX, TOTAL_STEPS = 3e-3, 20
FIRST_LR = LR_MAX / 10.0  # OneCycle's rate at step 0: lr_max / div_factor
LABELER_LR, LABELER_WD = 1e-3, 1e-4


# ---------------------------------------------------------------------------
# what the ranks run (and the parent, with mesh None)
# ---------------------------------------------------------------------------


def _recording(model, optimizer) -> dict:
    """The gradients that reach ``optimizer.step`` (after the all-reduce), by name."""
    grads = {}
    step = optimizer.step

    def recorded(*args, **kwargs):
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return step(*args, **kwargs)

    optimizer.step = recorded
    return grads


def detector_step(mesh, model, batch, code_weights, control_name=None) -> dict:
    """One ``make_detector_steps`` step of a copy of ``model`` (clipped, OneCycle'd
    AdamW) on this rank's rows of ``batch``: logs, gradients, state after."""
    from tdal_torch.pipeline.detector_engine import make_detector_steps
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState

    model = copy.deepcopy(model)
    lr, mom = one_cycle(LR_MAX, TOTAL_STEPS)
    opt = adam_with_schedule(model.parameters(), lr, 0.01, 35.0, mom)
    grads = _recording(model, opt)
    step = make_detector_steps(model, code_weights, 2.0)
    with control(control_name), pmesh.scope(mesh):
        logs = step(TrainState(model, opt), pmesh.shard_batch(batch, mesh))
    return dict(logs={k: float(v) for k, v in logs.items()}, grads=grads,
                state={k: v.clone() for k, v in model.state_dict().items()})


def labeler_step(mesh, model, batch, draws, control_name=None) -> dict:
    """One ``labeler_engine.make_steps`` step of a copy of the static one-box labeler
    (AdamW on the step decay) on this rank's rows, with this rank's rows of the global
    ``draws`` (numpy) as its gather noise and dropout mask."""
    from tdal_torch.models.static_labeler import frustum_loss_one_box
    from tdal_torch.pipeline import labeler_engine
    from tdal_torch.runtime.schedules import adam_with_schedule, labeler_step_decay
    from tdal_torch.runtime.train_state import TrainState

    model = copy.deepcopy(model)
    opt = adam_with_schedule(model.parameters(), labeler_step_decay(LABELER_LR, 1), LABELER_WD)
    grads = _recording(model, opt)
    train_step, _ = labeler_engine.make_steps(
        model, frustum_loss_one_box, lambda b: (b["pts"], b["init_box"], b["bbox_gt"]))
    fixed = lambda pts, gen: {k: pmesh.rank_rows(torch.from_numpy(v))  # noqa: E731
                              for k, v in draws.items()}
    with mock.patch.object(labeler_engine, "train_draws", fixed), control(control_name), \
            pmesh.scope(mesh):
        logs = train_step(TrainState(model, opt), pmesh.shard_batch(batch, mesh), None)
    return dict(logs={k: float(v) for k, v in logs.items()}, grads=grads,
                state={k: v.clone() for k, v in model.state_dict().items()})


def two_stage_step(mesh, engine, batch, control_name=None) -> dict:
    """One ``make_two_stage_steps`` step of a copy of the frozen-first-stage engine,
    its draws from a generator seeded with 1 (drawn over the global batch)."""
    from tdal_torch.pipeline.two_stage_engine import make_two_stage_steps
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState

    engine = copy.deepcopy(engine)
    lr, mom = one_cycle(LR_MAX, TOTAL_STEPS)
    opt = adam_with_schedule(engine.trainable_parameters(), lr, 0.01, 35.0, mom)
    grads = _recording(engine, opt)
    train_step, _ = make_two_stage_steps(engine)
    with control(control_name), pmesh.scope(mesh):
        logs = train_step(TrainState(engine, opt), pmesh.shard_batch(batch, mesh),
                          generator=torch.Generator().manual_seed(1))
    return dict(logs={k: float(v) for k, v in logs.items()}, grads=grads,
                state={k: v.clone() for k, v in engine.state_dict().items()})


def draws_of(mesh, pts_shape, engine) -> dict:
    """The labelers' ``train_draws`` and the two-stage engine's ``draws`` for this
    rank's rows, from generators seeded with 3."""
    from tdal_torch.models.pointnet import train_draws

    b = pts_shape[0] // (1 if mesh is None else mesh.world)
    with pmesh.scope(mesh):
        labeler = train_draws(torch.zeros(b, *pts_shape[1:]), torch.Generator().manual_seed(3))
        roi = engine.draws(b, 16, torch.Generator().manual_seed(3))
    return dict(labeler=labeler, proposal=roi["proposal"], dropout=roi["dropout"])


def _validation_setup(train_infos, val_infos):
    """pp_tiny without its velocity head (the synthetic boxes' 8-wide targets train
    none), fresh from seed 0, score threshold 0 (every kept box, none on the threshold's
    edge); a training set and a test-mode validation set; its test_cfg."""
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.models.builder import (
        build_assigner, build_detector, build_test_cfg, build_voxel_config,
    )
    from tdal_torch.runtime.config import Config

    cfg = Config.fromfile(PP_TINY)
    head = dict(cfg.model["bbox_head"])
    head["common_heads"] = {k: v for k, v in head["common_heads"].items() if k != "vel"}
    vox = build_voxel_config(cfg.voxel_generator, train=False)
    model = build_detector(dict(cfg.model, bbox_head=head), vox, device="cpu", seed=0)
    assigner = build_assigner(cfg.assigner, model)
    train_ds = DetectionDataset(train_infos, cfg.class_names, assigner,
                                build_voxel_config(cfg.voxel_generator, train=True),
                                max_points=4096)
    val_ds = DetectionDataset(val_infos, cfg.class_names, assigner, vox, mode="test",
                              max_points=4096)
    return model, train_ds, val_ds, dict(build_test_cfg(cfg.test_cfg, model, vox),
                                          score_threshold=0.0)


def detector_validation(mesh, train_infos, val_infos, work_dir) -> dict:
    """``train_detector`` for one epoch at a global batch of 2 ending in a validation
    (each rank predicts its rows, rank 0 computes the AP/APH), then ``run_inference``
    over the 3 validation frames at a global batch of 2 (the last batch padded: rank 1
    holds no valid frame of it). This rank's val row (rank 0's file), detections and
    weights after training."""
    import logging

    from tdal_torch.pipeline import detector_run as run
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState

    model, train_ds, val_ds, test_cfg = _validation_setup(train_infos, val_infos)
    lr, mom = one_cycle(LR_MAX, TOTAL_STEPS)
    state = TrainState(model, adam_with_schedule(model.parameters(), lr, 0.01, 35.0, mom))
    work = Path(work_dir) / f"rank{0 if mesh is None else mesh.rank}"
    log = logging.getLogger("t")
    run.train_detector(state, train_ds, [1.0] * 8, n_epoch=1, batch_size=2, logger=log,
                       work_dir=work, val_ds=val_ds, test_cfg=test_cfg, mesh=mesh)
    metrics = work / "logs" / "metrics.jsonl"
    rows = metrics.read_text().splitlines() if metrics.exists() else []
    return dict(rows=rows, state={k: v.clone() for k, v in model.state_dict().items()},
                detections=run.run_inference(state, val_ds, test_cfg, 2, log, mesh=mesh))


def gt_aug_rows(mesh, info_path, db_info_path, epochs=2) -> dict:
    """pp_tiny's training set with the GT-aug sampler on (``train``'s
    ``build_train_dataset``, seed 0): every global batch of ``BATCH`` over ``epochs``
    epochs as ``train_detector`` builds them, cut to this rank's rows, and the boxes the
    sampler pasted."""
    from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config
    from tdal_torch.pipeline.detector_run import detection_batches
    from tdal_torch.runtime.config import Config
    from tdal_torch.data.waymo_schema import load_pickle
    from tdal_torch.tools.train import build_train_dataset

    cfg = Config.fromfile(PP_TINY)
    cfg.train_preprocessor["db_sampler"] = dict(
        enable=True, db_info_path=db_info_path, sample_groups=[dict(VEHICLE=15)],
        db_prep_steps=[dict(filter_by_min_num_points=dict(VEHICLE=5))], rate=1.0)
    vox = build_voxel_config(cfg.voxel_generator, train=True)
    assigner = build_assigner(cfg.assigner, build_detector(cfg.model, vox, "cpu", 0))
    ds = build_train_dataset(cfg, load_pickle(info_path), assigner, vox, seed=0)
    pasted, sample_all = [], ds.db_sampler.sample_all

    def recorded(*args):
        out = sample_all(*args)
        pasted.append(0 if out is None else len(out["gt_boxes"]))
        return out

    ds.db_sampler.sample_all = recorded
    rows = [pmesh.shard_batch({k: v for k, v in batch.items() if k != "token"}, mesh)
            for epoch in range(epochs)
            for batch in detection_batches(ds, BATCH, shuffle=True, seed=epoch)]
    return dict(rows=rows, pasted=pasted)


def _rank_jobs(mesh, job_file, out_dir):
    """A spawned rank: every job of ``job_file`` (name -> (function, kwargs)), its
    results saved to ``out_dir/<rank>.pt``."""
    torch.set_num_threads(1)
    jobs = torch.load(job_file, weights_only=False)
    results = {name: fn(mesh, **kwargs) for name, (fn, kwargs) in jobs.items()}
    torch.save(results, Path(out_dir) / f"{mesh.rank}.pt")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _np_tree(tree):
    import flax
    import jax

    return jax.tree_util.tree_map(np.array, flax.core.unfreeze(tree))


def _jbatch(batch):
    import jax.numpy as jnp

    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
            for k, v in batch.items()}


def _permuted(batch, perm=PERM):
    return {k: ([x[perm] for x in v] if isinstance(v, list) else v[perm])
            for k, v in batch.items()}


def _pp_batch(cfg, vox, model, seed=0):
    """pp_tiny's training inputs for ``BATCH`` frames: a few boxes a frame (with
    velocities), background points and points on the boxes."""
    from tdal_torch.core.targets import assign_centernet_targets
    from tdal_torch.core.voxel import pad_points
    from tdal_torch.data.detection import collate_detection
    from tdal_torch.models.builder import build_assigner
    from tdal_torch.pipeline.detector_engine import TARGET_KEYS

    rng = np.random.default_rng(seed)
    asg = build_assigner(cfg.train_cfg["assigner"], model)
    items = []
    for i in range(BATCH):
        k = 2 + i % 3
        boxes = np.zeros((k, 9), np.float32)
        boxes[:, 0] = rng.uniform(-20, 45, k)
        boxes[:, 1] = rng.uniform(-20, 20, k)
        boxes[:, 3:6] = rng.uniform(0.8, 4.5, (k, 3))
        boxes[:, 6:8] = rng.normal(0, 2, (k, 2))
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, k)
        t = assign_centernet_targets(boxes, rng.integers(1, 4, k).astype(np.int32), asg,
                                     vox.grid_size, vox.point_cloud_range, vox.voxel_size)
        p = [rng.uniform([-25, -25, -1.5, 0, 0], [51, 25, 2.0, 1, 1], (700, 5))]
        for bx in boxes:
            p.append(np.concatenate([bx[:3] + rng.normal(0, 0.5, (40, 3)),
                                     rng.uniform(0, 1, (40, 2))], 1))
        items.append(dict(t, points=pad_points(np.concatenate(p).astype(np.float32), 1024),
                          token=f"f{i}"))
    batch = collate_detection(items)
    return {k: batch[k] for k in ("points", *TARGET_KEYS)}


@pytest.fixture(scope="module")
def pp_case():
    """tdal's pp_tiny, its variables, the port's model loaded from them, the batch."""
    import jax
    import jax.numpy as jnp

    from tdal.models.builder import build_detector as jbuild_detector
    from tdal.models.builder import build_test_cfg as jbuild_test_cfg
    from tdal.models.builder import build_voxel_config as jbuild_voxel_config
    from tdal.runtime.config import Config as JConfig
    from tdal_torch.convert import load_flax_pointpillars
    from tdal_torch.models.builder import build_detector, build_voxel_config
    from tdal_torch.runtime.config import Config

    jcfg, cfg = JConfig.fromfile(str(PP_TINY)), Config.fromfile(PP_TINY)
    jvox = jbuild_voxel_config(jcfg.voxel_generator, train=True)
    jdet = jbuild_detector(jcfg.model, jvox)
    vox = build_voxel_config(cfg.voxel_generator, train=True)
    model = build_detector(cfg.model, vox, device="cpu", seed=0)
    batch = _pp_batch(cfg, vox, model)
    variables = _np_tree(jax.jit(jdet.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(batch["points"][:2]), False))
    load_flax_pointpillars(model, variables["params"], variables["batch_stats"])
    return dict(jdet=jdet, variables=variables, model=model, batch=batch,
                jtest_cfg=jbuild_test_cfg(jcfg.test_cfg, jdet, jvox),
                code_weights=list(cfg.model["bbox_head"]["code_weights"]))


@pytest.fixture(scope="module")
def labeler_case():
    """``dryrun_multichip``'s labeler (static one-box, 16 object points) at a batch of 4
    sets of 64 points, its flax variables, the port's model loaded from them, the batch
    and the draws (numpy)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _labeler_setup
    from tdal_torch.convert import load_flax
    from tdal_torch.models.static_labeler import StaticLabelerOneBox

    jmodel, params, bs, pts, init_box = _labeler_setup(BATCH, 64, 16)
    key = jax.random.PRNGKey(0)
    batch = {
        "pts": pts, "init_box": init_box, "bbox_gt": init_box,
        "mask_label": (jax.random.uniform(key, (BATCH, 64)) > 0.5).astype(jnp.float32),
        "center_label": init_box[:, :3],
        "heading_class_label": jnp.zeros((BATCH,), jnp.int32),
        "heading_residuals_label": jnp.zeros((BATCH,)),
        "size_class_label": jnp.zeros((BATCH,), jnp.int32),
        "size_residuals_label": jnp.zeros((BATCH, 3)),
    }
    batch = {k: np.asarray(v) for k, v in batch.items()}
    rng = np.random.default_rng(11)
    draws = {"noise": rng.random((BATCH, 64), dtype=np.float32),
             "keep": rng.random((BATCH, 64, 128)) >= 0.5}
    params, bs = _np_tree(params), _np_tree(bs)
    model = load_flax(StaticLabelerOneBox(n_object_points=16), params, bs)
    return dict(jmodel=jmodel, params=params, bs=bs, model=model, batch=batch, draws=draws)


@pytest.fixture(scope="module")
def voxelnet_case():
    """The tiny VoxelNet of ``tests/test_torch_voxelnet.py`` (sparse backbone), fresh
    from seed 0, and a batch of 4 of its frames."""
    from test_torch_voxelnet import TASKS, TINY, VOX, _batch
    from tdal_torch.core.voxel import VoxelConfig
    from tdal_torch.models.builder import init_detector
    from tdal_torch.models.detectors import VoxelNet

    model = init_detector(VoxelNet(VoxelConfig(*VOX), TASKS, sparse_middle=True, **TINY),
                          torch.Generator().manual_seed(0))
    return dict(model=model, batch=_batch(BATCH, seed=3), code_weights=[1.0] * 8)


@pytest.fixture(scope="module")
def two_stage_case():
    """``pp_two_stage_tiny``'s frozen-first-stage engine, fresh from seed 0 (score
    threshold 0, as ``tests/test_torch_two_stage.py``), and a batch of 4 frames."""
    from test_torch_two_stage import _tiny_batch
    from tdal_torch.models.builder import (
        build_detector, build_test_cfg, build_two_stage_engine, build_voxel_config,
    )
    from tdal_torch.runtime.config import Config

    cfg = Config.fromfile(TWO_STAGE_TINY)
    vox = build_voxel_config(cfg.voxel_generator, train=True)
    first = build_detector(cfg.model["first_stage_cfg"], vox, device="cpu")
    test_cfg = dict(build_test_cfg(cfg.test_cfg, first, vox), score_threshold=0.0)
    engine = build_two_stage_engine(cfg.model, vox, test_cfg, device="cpu", seed=0)
    batch = _tiny_batch(cfg, vox, b=BATCH, seed=2)
    return dict(engine=engine, batch={k: v for k, v in batch.items() if k != "token"})


@pytest.fixture(scope="module")
def validation_case(tmp_path_factory):
    """Synthetic infos: 2 training frames and 3 validation frames."""
    from tdal_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("validation")
    train_infos, _ = make_synthetic_dataset(root / "train", n_scenes=1, n_frames=2, seed=3,
                                            n_background=800, points_per_object=64)
    val_infos, _ = make_synthetic_dataset(root / "val", n_scenes=1, n_frames=3, seed=2,
                                          n_background=800, points_per_object=64)
    return dict(train_infos=train_infos, val_infos=val_infos)


@pytest.fixture(scope="module")
def gt_aug_case(tmp_path_factory):
    """A Waymo-layout training root (2 scenes of 4 frames) and its GT database, from
    ``create_data``'s ``waymo_data_prep``."""
    from tdal_torch.data.synthetic import SyntheticScene
    from tdal_torch.tools.create_data import waymo_data_prep

    root = tmp_path_factory.mktemp("gt_aug")
    for i in range(2):
        SyntheticScene(i, n_frames=4, seed=5, n_static=3, n_dynamic=1, points_per_object=64,
                       n_background=256).write(root, split="train")
    waymo_data_prep(root)
    return dict(info_path=str(root / "infos_train_01sweeps_filter_zero_gt.pkl"),
                db_info_path=str(root / "dbinfos_train_1sweeps_withvelo.pkl"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, pp_case, labeler_case, voxelnet_case, two_stage_case,
          validation_case, gt_aug_case):
    """Every data-parallel job on 2 spawned gloo ranks: name -> [rank 0's, rank 1's]."""
    work = tmp_path_factory.mktemp("ranks")
    pp = dict(model=pp_case["model"], batch=pp_case["batch"],
              code_weights=pp_case["code_weights"])
    lab = dict(model=labeler_case["model"], batch=labeler_case["batch"],
               draws=labeler_case["draws"])
    jobs = {"draws": (draws_of, dict(pts_shape=(BATCH, 64, 3),
                                     engine=two_stage_case["engine"]))}
    for name in (None, *CONTROLS):
        jobs[("pp", name)] = (detector_step, dict(pp, control_name=name))
        jobs[("labeler", name)] = (labeler_step, dict(lab, control_name=name))
    jobs[("voxelnet", None)] = (detector_step, voxelnet_case)
    jobs[("two_stage", None)] = (two_stage_step, two_stage_case)
    jobs["validation"] = (detector_validation, dict(validation_case, work_dir=str(work)))
    jobs["gt_aug"] = (gt_aug_rows, gt_aug_case)
    torch.save(jobs, work / "jobs.pt")
    pmesh.spawn(_rank_jobs, (str(work / "jobs.pt"), str(work)), devices=["cpu"] * WORLD)
    per_rank = [torch.load(work / f"{r}.pt", weights_only=False) for r in range(WORLD)]
    return {name: [p[name] for p in per_rank] for name in jobs}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _params_only(model, tree):
    names = {n for n, _ in model.named_parameters()}
    return {k: v for k, v in tree.items() if k in names}


def _as64(tree):
    return {k: np.asarray(v, np.float64) for k, v in tree.items()}


def floor_of(a, b) -> dict:
    """Per leaf, the largest change between two gradients of the same step."""
    return {k: float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).max())
            for k in a}


def grad_tolerances(want, floors, rel=1e-4, abs_=1e-6):
    """Per leaf: max(rel x max |want| + abs_, GRAD_MARGIN x the largest of ``floors``)."""
    return {k: max(rel * np.abs(w).max() + abs_, GRAD_MARGIN * max(f[k] for f in floors))
            for k, w in want.items()}


def worst_grad_ratio(got, want, tol) -> float:
    return max(float(np.abs(np.asarray(got[k], np.float64) - w).max() / tol[k])
               for k, w in want.items())


def check_params(old, got, want, grad_want, tol, lr0, rel=1e-5):
    """Each parameter after the update within rel (1 + |p|), plus 2 lr where its
    gradient is within its tolerance of 0."""
    for k, g in grad_want.items():
        allowed = rel * (1 + np.abs(old[k])) + (np.abs(g) <= tol[k]) * 2.0 * lr0
        err = np.abs(np.asarray(got[k], np.float64) - want[k])
        assert (err <= allowed).all(), f"param {k}: {float((err / allowed).max()):.3f} of allowed"


def check_running(got, want, rtol=1e-5, atol=1e-6):
    for k, w in want.items():
        if "running" in k:
            np.testing.assert_allclose(np.asarray(got[k], np.float64), w, rtol=rtol,
                                       atol=atol * max(1.0, float(np.abs(w).max())), err_msg=k)


def check_ranks_agree(results):
    """Every rank ends the step with the same weights and running statistics."""
    for k, v in results[0]["state"].items():
        for other in results[1:]:
            assert torch.equal(v, other["state"][k]), k
    for k in results[0]["logs"]:
        assert all(r["logs"][k] == results[0]["logs"][k] for r in results[1:]), k


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,multiple", [(10, 4), (8, 4), (7, 2), (1, 3)])
def test_pad_to_multiple_and_rank_rows_match_tdal(n, multiple):
    """tdal's ``pad_to_multiple``, and ``shard_batch``'s per-device shards on a mesh of
    ``multiple`` devices, against the port's ``pad_to_multiple`` and ``rank_rows``."""
    import jax

    from tdal.parallel.mesh import make_mesh as jmake_mesh
    from tdal.parallel.mesh import pad_to_multiple as jpad
    from tdal.parallel.mesh import shard_batch as jshard

    rng = np.random.default_rng(n)
    arr = rng.normal(size=(n, 3, 2)).astype(np.float32)
    want, want_n = jpad(arr, multiple)
    got, got_n = pmesh.pad_to_multiple(arr, multiple)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got, want)
    batch = {"x": got, "targets": [got[:, 0], got[:, 1]],
             "token": [f"t{i}" for i in range(len(got))]}
    jsharded = jshard({"x": got, "t0": got[:, 0]}, jmake_mesh(devices=jax.devices()[:multiple]))
    for rank in range(multiple):
        mine = pmesh.shard_batch(batch, pmesh.Mesh(multiple, rank, torch.device("cpu")))
        for key, ours in (("x", mine["x"]), ("t0", mine["targets"][0])):
            shards = sorted(jsharded[key].addressable_shards, key=lambda s: s.index[0].start)
            np.testing.assert_array_equal(ours, np.asarray(shards[rank].data))
        assert mine["token"] == batch["token"]  # leaves that are not arrays stay whole
    with pytest.raises(ValueError, match="does not split"):
        pmesh.rank_rows(np.zeros((len(got) + 1, 2)), pmesh.Mesh(multiple, 0, torch.device("cpu")))


def _fake_info_map():
    """tests/test_shard.py's info map: sequences of 10, 4, 7 and 1 frames."""
    return {f"seq_{seq}_frame_{f}.pkl": {"timestamp": float(f)}
            for seq, n in ((0, 10), (1, 4), (2, 7), (3, 1)) for f in range(n)}


def sequence_stage(shard_id, shard_infos):
    """A stage for the shard tests: each token's sequence and its shard."""
    return {t: (shard.sequence_of(t), shard_id) for t in shard_infos}


@pytest.mark.parametrize("n_shards", [1, 2, 3, 6])
def test_partition_and_run_sharded_match_tdal(n_shards):
    from tdal.pipeline import shard as jshard

    info_map = _fake_info_map()
    assert shard.partition_by_sequence(info_map, n_shards) == \
        jshard.partition_by_sequence(info_map, n_shards)
    want = jshard.run_sharded(sequence_stage, info_map, n_shards=n_shards)
    assert shard.run_sharded(sequence_stage, info_map, n_shards=n_shards) == want
    assert shard.merge_dicts(want) == jshard.merge_dicts(want)
    dets = {t: i for i, t in enumerate(info_map)}
    part = shard.partition_by_sequence(info_map, n_shards)[0]
    assert shard.shard_detections(dets, part) == jshard.shard_detections(dets, part)


def test_run_sharded_in_processes_and_resumable_match_tdal(tmp_path):
    """Spawned workers give the in-process results; the resumable run recomputes only
    a missing shard, in processes too."""
    from tdal.pipeline import shard as jshard

    info_map = _fake_info_map()
    want = jshard.run_sharded(sequence_stage, info_map, n_shards=3)
    assert shard.run_sharded(sequence_stage, info_map, n_shards=3, processes=True) == want
    out = tmp_path / "stage"
    first = shard.run_sharded_resumable(sequence_stage, info_map, out, n_shards=3)
    assert first == jshard.run_sharded_resumable(sequence_stage, info_map, tmp_path / "j",
                                                 n_shards=3)
    victim = sorted(out.glob("shard_*.pkl"))[0]
    victim.unlink()
    again = shard.run_sharded_resumable(sequence_stage, info_map, out, n_shards=3,
                                        processes=True)
    assert again == first and victim.exists()


_TORCHRUN_RANK = textwrap.dedent(
    """
    import numpy as np
    import torch
    from tdal_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    mesh = pmesh.init_distributed("cpu")
    assert (mesh.world, mesh.backend) == (2, "gloo"), mesh
    x = (torch.arange(4.0) + 4.0 * mesh.rank).requires_grad_()
    with mesh:
        total = pmesh.all_reduce_sum(x)
        (total * torch.arange(4.0)).sum().backward()
    assert total.tolist() == [4.0, 6.0, 8.0, 10.0], total
    assert x.grad.tolist() == [0.0, 2.0, 4.0, 6.0], x.grad  # the cotangent, summed
    gathered = pmesh.process_allgather({"r": np.array([mesh.rank]), "v": [1.5 * mesh.rank]},
                                       mesh)
    assert gathered["r"].tolist() == [[0], [1]] and gathered["v"][0].tolist() == [0.0, 1.5]
    w = torch.nn.Parameter(torch.full((3,), float(mesh.rank)))
    w.grad = torch.full((3,), 1.0 + mesh.rank)
    pmesh.all_reduce_grads([w], mesh)
    assert w.grad.tolist() == [3.0] * 3
    torch.manual_seed(mesh.rank)
    lin = torch.nn.Linear(3, 2)
    pmesh.broadcast_module(lin, mesh)
    weights = pmesh.process_allgather(lin.weight.detach().numpy(), mesh)
    assert (weights[0] == weights[1]).all()
    pmesh.barrier(mesh)
    print(f"rank {mesh.rank}: OK", flush=True)
    torch.distributed.destroy_process_group()
    """
)


def test_two_process_gloo_init_from_the_launcher_environment(tmp_path):
    """Two processes join one gloo group from torchrun's variables (as
    ``tests/test_multihost.py`` does for ``jax.distributed``): the sum, its backward,
    the host gather, the gradient all-reduce and the broadcast."""
    script = tmp_path / "rank.py"
    script.write_text(_TORCHRUN_RANK)
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(pmesh.free_port()), PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: OK" in out, out


def test_gt_aug_global_batches_are_the_single_process_rows(ranks, gt_aug_case):
    """With the GT-aug sampler on, each rank builds the whole global batch from the same
    seeds (the dataset's and the sampler's), so its rows of every batch over two epochs
    are the single process's rows, exactly, pasted boxes included."""
    from test_torch_cli_chain import assert_same

    single = gt_aug_rows(None, **gt_aug_case)
    assert sum(single["pasted"]) > 0
    b = BATCH // WORLD
    for r, got in enumerate(ranks["gt_aug"]):
        assert got["pasted"] == single["pasted"]
        for i, (rows, batch) in enumerate(zip(got["rows"], single["rows"], strict=True)):
            want = {k: ([a[r * b:(r + 1) * b] for a in v] if isinstance(v, list)
                        else v[r * b:(r + 1) * b] if isinstance(v, np.ndarray) else v)
                    for k, v in batch.items()}
            assert_same(rows, want, f"rank {r}, batch {i}")


def test_draws_are_the_single_process_rows(ranks, two_stage_case):
    """The labelers' ``train_draws`` and the two-stage engine's draws on each rank are
    that rank's rows of the single-process draws from the same generator."""
    single = draws_of(None, (BATCH, 64, 3), two_stage_case["engine"])
    b = BATCH // WORLD
    for r, got in enumerate(ranks["draws"]):
        rows = slice(r * b, (r + 1) * b)
        for k in ("noise", "keep"):
            assert torch.equal(got["labeler"][k], single["labeler"][k][rows]), k
        assert torch.equal(got["proposal"], single["proposal"][rows])
        for g, s in zip(got["dropout"], single["dropout"], strict=True):
            assert torch.equal(g, s[rows])


def _tdal_pp(pp_case, batch, mesh):
    """tdal's loss and gradients (port names, float64) on ``batch`` sharded over
    ``mesh``, and its state after ``make_detector_steps``' step."""
    import jax

    from tdal.models.center_head import center_head_loss as jloss
    from tdal.parallel.mesh import shard_batch as jshard
    from tdal.pipeline.detector_engine import make_detector_steps as jmake_steps
    from tdal.runtime import schedules as jsched
    from tdal.runtime.train_state import TrainState as JTrainState
    from tdal_torch.convert import pointpillars_state_dict
    from tdal_torch.pipeline.detector_engine import TARGET_KEYS

    jdet, variables, model = pp_case["jdet"], pp_case["variables"], pp_case["model"]
    cw = pp_case["code_weights"]
    sharded = jshard(_jbatch(batch), mesh)

    def loss_of(params, b):
        preds, _ = jdet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              b["points"], train=True, mutable=["batch_stats"])
        return jloss(preds, {k: b[k] for k in TARGET_KEYS}, cw, 2.0, has_vel=True)[0]

    loss, g = jax.jit(jax.value_and_grad(loss_of))(variables["params"], sharded)
    bs = variables["batch_stats"]
    grads = _as64(_params_only(model, pointpillars_state_dict(model, _np_tree(g), bs)))
    jlr, jmom = jsched.one_cycle(LR_MAX, TOTAL_STEPS)
    tx = jsched.adam_with_schedule(jlr, weight_decay=0.01, grad_clip=35.0,
                                   momentum_schedule=jmom)
    jstep, _ = jmake_steps(jdet, pp_case["jtest_cfg"], cw, 2.0, donate=False)
    jnew, jlogs = jstep(JTrainState.create(variables["params"], tx, bs), sharded)
    state = _as64(pointpillars_state_dict(model, _np_tree(jnew.params),
                                          _np_tree(jnew.batch_stats)))
    return float(loss), grads, state, {k: float(v) for k, v in jlogs.items()}


@pytest.fixture(scope="module")
def pp_reference(pp_case):
    """tdal's sharded step on the batch, and the noise floor: tdal's and the port's
    single-process change under a permutation of the batch."""
    import jax

    from tdal.parallel.mesh import make_mesh as jmake_mesh

    mesh = jmake_mesh(devices=jax.devices()[:WORLD])
    ref = _tdal_pp(pp_case, pp_case["batch"], mesh)
    perm = _tdal_pp(pp_case, _permuted(pp_case["batch"]), mesh)
    args = (pp_case["model"], pp_case["batch"], pp_case["code_weights"])
    port = detector_step(None, *args)
    port_perm = detector_step(None, args[0], _permuted(args[1]), args[2])
    tol = grad_tolerances(ref[1], [floor_of(ref[1], perm[1]),
                                   floor_of(port["grads"], port_perm["grads"])])
    return dict(ref=ref, tol=tol)


def test_pp_tiny_data_parallel_step_matches_tdal_sharded_step(ranks, pp_case, pp_reference):
    """pp_tiny at a global batch of 4 on 2 gloo ranks against tdal's step on a 2-device
    mesh: the loss and the logs, every gradient, the parameters after the update and
    the running statistics; both ranks hold the same state."""
    loss, grads, state, jlogs = pp_reference["ref"]
    tol = pp_reference["tol"]
    results = ranks[("pp", None)]
    check_ranks_agree(results)
    got = results[0]
    assert got["logs"]["loss"] == pytest.approx(loss, rel=1e-5)
    for k, v in jlogs.items():
        assert got["logs"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert got["logs"]["num_positive_task0"] == sum(
        float(m.sum()) for m in pp_case["batch"]["mask"])  # a global count
    ratio = worst_grad_ratio(got["grads"], grads, tol)
    assert ratio <= 1.0, f"gradients at {ratio:.3f} of their tolerance"
    old = _as64({k: v for k, v in pp_case["model"].state_dict().items()})
    check_params(old, got["state"], state, grads, tol, FIRST_LR)
    check_running(got["state"], state)


@pytest.mark.parametrize("name", CONTROLS)
def test_pp_tiny_controls_fail_the_comparison(ranks, pp_reference, name):
    """The same step with per-rank BN statistics, or with per-rank loss normalizers,
    misses the gradient tolerance by more than 10x."""
    _, grads, _, _ = pp_reference["ref"]
    ratio = worst_grad_ratio(ranks[("pp", name)][0]["grads"], grads, pp_reference["tol"])
    print(f"{name}: gradients at {ratio:.1f} of their tolerance")
    assert ratio > 10


def _tdal_labeler(labeler_case, batch, draws, mesh, set_draws):
    """tdal's loss terms and metrics, gradients (port names) and state after its
    ``make_steps`` step, with ``batch`` sharded over ``mesh`` and ``draws`` patched in."""
    import jax

    from tdal.models.static_labeler import frustum_loss_one_box as jloss
    from tdal.parallel.mesh import shard_batch as jshard
    from tdal.pipeline.labeler_engine import LABEL_KEYS
    from tdal.pipeline.labeler_engine import make_steps as jmake_steps
    from tdal.runtime.schedules import adam_with_schedule as jadam
    from tdal.runtime.schedules import labeler_step_decay as jdecay
    from tdal.runtime.train_state import TrainState as JTrainState
    from tdal_torch.convert import flax_to_state_dict

    jmodel, params, bs, model = (labeler_case[k] for k in ("jmodel", "params", "bs", "model"))
    set_draws(draws)
    sharded = jshard(_jbatch(batch), mesh)
    key = jax.random.PRNGKey(0)
    inputs = lambda b: (b["pts"], b["init_box"], b["bbox_gt"])  # noqa: E731
    labels = lambda b: {k: b[k] for k in LABEL_KEYS}  # noqa: E731

    def loss_of(p, b):
        out, _ = jmodel.apply({"params": p, "batch_stats": bs}, *inputs(b), train=True,
                              rngs={"gather": key, "dropout": key}, mutable=["batch_stats"])
        return jloss(out, labels(b))["total_loss"]

    g = jax.jit(jax.grad(loss_of))(params, sharded)
    grads = _as64(_params_only(model, flax_to_state_dict(model, _np_tree(g), bs)))
    tx = jadam(jdecay(LABELER_LR, 1), weight_decay=LABELER_WD)
    train_step, _ = jmake_steps(jmodel, jloss, inputs, donate=False)
    jnew, metrics = train_step(JTrainState.create(params, tx, bs), sharded, key)
    state = _as64(flax_to_state_dict(model, _np_tree(jnew.params), _np_tree(jnew.batch_stats)))
    return {k: float(v) for k, v in metrics.items()}, grads, state


@contextlib.contextmanager
def tdal_fixed_draws():
    """tdal's labelers with the gather noise and dropout mask of
    ``test_torch_labeler_train``'s ``tdal_draws`` (its ``_DRAWS``): yields their setter."""
    import types

    import flax.linen as fnn
    import jax

    import tdal.models.pointnet as jpn
    import test_torch_labeler_train as tlt

    nn_proxy = types.SimpleNamespace(**{k: getattr(fnn, k) for k in dir(fnn)
                                        if not k.startswith("__")})
    nn_proxy.Dropout = tlt._FixedDropout
    jax_proxy = types.SimpleNamespace(
        vmap=jax.vmap, lax=jax.lax, random=types.SimpleNamespace(
            uniform=lambda key, shape: jax.numpy.asarray(tlt._DRAWS["noise"])))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpn, "nn", nn_proxy)
        mp.setattr(jpn, "jax", jax_proxy)
        try:
            yield tlt._DRAWS.update
        finally:
            tlt._DRAWS.clear()


@pytest.fixture(scope="module")
def labeler_reference(labeler_case):
    """tdal's sharded labeler step on the batch and on its permutation (the noise
    floor), with the port's draws."""
    import jax

    from tdal.parallel.mesh import make_mesh as jmake_mesh

    mesh = jmake_mesh(devices=jax.devices()[:WORLD])
    b, d = labeler_case["batch"], labeler_case["draws"]
    with tdal_fixed_draws() as set_draws:
        ref = _tdal_labeler(labeler_case, b, d, mesh, set_draws)
        perm = _tdal_labeler(labeler_case, _permuted(b), {k: v[PERM] for k, v in d.items()},
                             mesh, set_draws)
    tol = grad_tolerances(ref[1], [floor_of(ref[1], perm[1])], rel=1e-5, abs_=1e-12)
    return dict(ref=ref, perm=perm, tol=tol)


def test_static_labeler_data_parallel_step_matches_tdal_sharded_step(ranks, labeler_case,
                                                                    labeler_reference):
    """The static labeler on 2 ranks against tdal's sharded labeler step: the loss terms
    and metrics, the gradients, the parameters after the AdamW update and the running
    statistics; both ranks hold the same state."""
    metrics, grads, state = labeler_reference["ref"]
    perm_metrics = labeler_reference["perm"][0]
    results = ranks[("labeler", None)]
    check_ranks_agree(results)
    got = results[0]
    assert set(got["logs"]) == set(metrics)
    for k, v in metrics.items():
        floor = GRAD_MARGIN * abs(perm_metrics[k] - v)
        assert abs(got["logs"][k] - v) <= max(floor, 1e-5 * max(1.0, abs(v))), k
    tol = labeler_reference["tol"]
    ratio = worst_grad_ratio(got["grads"], grads, tol)
    assert ratio <= 1.0, f"gradients at {ratio:.3f} of their tolerance"
    old = _as64(labeler_case["model"].state_dict())
    check_params(old, got["state"], state, grads, tol, LABELER_LR, rel=1e-6)
    perm_state = labeler_reference["perm"][2]
    for k, w in state.items():
        if "running" in k:
            err = np.abs(np.asarray(got["state"][k], np.float64) - w)
            allowed = np.maximum(GRAD_MARGIN * np.abs(perm_state[k] - w).max(),
                                 1e-5 * np.maximum(1.0, np.abs(w)))
            assert (err <= allowed).all(), k


@pytest.mark.parametrize("name", CONTROLS)
def test_static_labeler_controls_fail_the_comparison(ranks, labeler_reference, name):
    _, grads, _ = labeler_reference["ref"]
    ratio = worst_grad_ratio(ranks[("labeler", name)][0]["grads"], grads,
                             labeler_reference["tol"])
    print(f"{name}: gradients at {ratio:.1f} of their tolerance")
    assert ratio > 10


def _against_single(results, single, perm, keys=None):
    """A data-parallel step against the port's single-process step, with the port's
    permutation floor."""
    check_ranks_agree(results)
    got = results[0]
    for k, v in single["logs"].items():
        assert got["logs"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    want = _as64(single["grads"])
    tol = grad_tolerances(want, [floor_of(single["grads"], perm["grads"])])
    ratio = worst_grad_ratio(got["grads"], want, tol)
    assert ratio <= 1.0, f"gradients at {ratio:.3f} of their tolerance"
    return got, want, tol


def test_voxelnet_data_parallel_step_matches_the_single_process_step(ranks, voxelnet_case):
    c = voxelnet_case
    single = detector_step(None, c["model"], c["batch"], c["code_weights"])
    perm = detector_step(None, c["model"], _permuted(c["batch"]), c["code_weights"])
    got, want, tol = _against_single(ranks[("voxelnet", None)], single, perm)
    old = _as64(c["model"].state_dict())
    check_params(old, got["state"], _as64(single["state"]), want, tol, FIRST_LR)
    check_running(got["state"], _as64(single["state"]))
    assert any("backbone" in k and "running" in k for k in single["state"])  # masked BNs


def test_roi_head_data_parallel_step_matches_the_single_process_step(ranks, two_stage_case):
    """The frozen-first-stage two-stage step on 2 ranks (its draws sliced from the
    global draws, its RoI losses' normalizers global) against one process."""
    c = two_stage_case
    single = two_stage_step(None, c["engine"], c["batch"])
    perm = two_stage_step(None, c["engine"], _permuted(c["batch"]))
    got, want, tol = _against_single(ranks[("two_stage", None)], single, perm)
    assert single["logs"]["rcnn_loss_cls"] > 0
    old = _as64(c["engine"].state_dict())
    check_params(old, got["state"], _as64(single["state"]), want, tol, FIRST_LR)
    check_running(got["state"], _as64(single["state"]))


def _same_detections(got, want, tol=1e-5):
    assert got.keys() == want.keys()
    for token, w in want.items():
        g = got[token]
        assert len(g["scores"]) == len(w["scores"]) > 0, token
        order_g, order_w = np.argsort(-g["scores"]), np.argsort(-w["scores"])
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_allclose(g[k][order_g], w[k][order_w], rtol=tol, atol=tol,
                                       err_msg=f"{token} {k}")


def test_validation_is_sharded_and_rank_0_evaluates_every_frame(ranks, validation_case):
    """``train_detector`` with a validation on 2 ranks: rank 0 alone writes metrics.jsonl,
    and its val row is the single-process ``evaluate_detector`` of the same weights
    (within 1e-6); ``run_inference`` on the ranks gives rank 0 every frame's detections,
    those of one process within 1e-5 (each rank predicted 1 row where one process
    predicts 2), and the other rank nothing."""
    import logging

    from tdal_torch.pipeline import detector_run as run
    from tdal_torch.runtime.train_state import TrainState

    main, other = ranks["validation"]
    assert [json.loads(r)["mode"] for r in main["rows"]] == ["val"] and other["rows"] == []
    assert other["detections"] == {}
    for k, v in main["state"].items():
        assert torch.equal(v, other["state"][k]), k
    model, _, val_ds, test_cfg = _validation_setup(**validation_case)
    model.load_state_dict(main["state"])
    state, log = TrainState(model, None), logging.getLogger("t")
    want = run.evaluate_detector(state, val_ds, test_cfg, 2, log)
    got = json.loads(main["rows"][0])
    assert got["step"] == 1
    assert {k: v for k, v in got.items() if k not in ("mode", "step")} == pytest.approx(
        want, abs=1e-6)
    _same_detections(main["detections"], run.run_inference(state, val_ds, test_cfg, 2, log))


def test_launch_rule_without_a_launcher():
    """``--device cpu`` with no launcher is one process (mesh None); the default device
    without a card raises rather than fall back; a launcher with data parallelism off
    is refused."""
    seen = []
    pmesh.launch(lambda mesh, x: seen.append((mesh, x)), (1,), "cpu", data_parallel=True)
    assert seen == [(None, 1)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.launch(lambda mesh: None, (), None)
    with mock.patch.dict(os.environ, {"WORLD_SIZE": "2"}):
        with pytest.raises(ValueError, match="data parallelism is off"):
            pmesh.launch(lambda mesh: None, (), "cpu", data_parallel=False)


def torchrun(module, argv, nproc=WORLD, timeout=300) -> str:
    """``python -m torch.distributed.run`` of ``-m module argv`` on ``nproc`` CPU ranks
    (one thread each); returns its output, raising with it on a non-zero exit."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(nproc), "--master_addr", "localhost",
           "--master_port", str(pmesh.free_port()), "-m", module, *map(str, argv)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    return out


def test_train_cli_trains_data_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 2 -m tdal_torch.tools.train pp_tiny --device cpu``:
    two gloo ranks on the global batch of 4, rank 0 alone writing the log and one
    checkpoint, which holds the single-process run's step: the running statistics
    within rtol 1e-5 (atol 1e-6 of max(1, |x|)), every parameter within 1e-5 (1 + |p|)
    plus 2 lr (Adam's first step may take either sign where a gradient is near 0)."""
    import importlib

    from tdal_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(tmp_path / "data", n_scenes=1, n_frames=4, seed=3, n_static=2,
                           n_dynamic=1, points_per_object=64, n_background=256)
    common = [PP_TINY, "--info_path", tmp_path / "data" / "infos.pkl", "--total_epochs", 1,
              "--batch_size", BATCH, "--no_val", "--device", "cpu"]
    torchrun("tdal_torch.tools.train", [*common, "--work_dir", tmp_path / "dp"])
    train = importlib.import_module("tdal_torch.tools.train")
    with mock.patch.object(sys, "argv", ["train", *map(str, common), "--work_dir",
                                         str(tmp_path / "single")]):
        train.main()
    log = (tmp_path / "dp" / "train.log").read_text()
    assert "data-parallel over 2 ranks (gloo)" in log
    assert log.count("Epoch 1 done") == 1  # rank 1 logs nothing
    (dp,) = (tmp_path / "dp" / "checkpoints").glob("step_*.pt")
    (single,) = (tmp_path / "single" / "checkpoints").glob("step_*.pt")
    assert dp.name == single.name == "step_00000001.pt"
    got = torch.load(dp, weights_only=True)["model"]
    want = torch.load(single, weights_only=True)["model"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        if "running" in k:
            assert torch.allclose(g, w, rtol=1e-5, atol=1e-6 * max(1.0, float(w.abs().max()))), k
        else:
            assert ((g - w).abs() <= 1e-5 * (1 + w.abs()) + 2 * FIRST_LR).all(), k

