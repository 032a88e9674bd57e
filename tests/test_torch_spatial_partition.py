"""BEV spatial partitioning in the port (``tdal_torch.parallel.mesh``: a spatial mesh
axis, row slabs, hand halo exchanges; the detectors' ``bev_sharding``; the conv
kernels' row halo form; ``dist_test --spatial_shards``) against tdal's unsharded
program on the same numpy inputs and converted weights, on the CPU over gloo.

The partitioned runs happen in 4 spawned ranks (one thread each) that import this
module, so jax and tdal are imported only inside the tests and fixtures: a rank loads
neither. One module fixture spawns the ranks once. They form two meshes over the same
processes: spatial 4 (data 1), and data 2 x spatial 2. The detector is
``tests/test_spatial_partition.py``'s (a PointPillars of width 8, one VEHICLE task) with
a second RPN stage (strides 1, 2; its strided entry conv takes a top halo, its deblock
none) on a canvas of 34 x 32 (its y range widened by one row a side), so the coarsest
level's 17 rows split unevenly: 5/4/4/4 over 4 ranks, 9/8 over 2.

Cases and tolerances (``tests/test_spatial_partition.py``'s, which the port's
single-process parity tests do not undercut):
- (1) SP predict over 4 spatial ranks == tdal's unsharded predict: the head maps and the
  predictions' valid slots rtol = atol = 1e-5, valid slots and labels exactly;
- (2) data 2 x spatial 2 predict == tdal's, the same way;
- (3) one SP train step (SGD(1.0), so the parameter change is the gradient) == tdal's
  unsharded step: loss rtol 1e-5, parameters rtol 1e-3 atol 5e-5, BN running statistics
  rtol 1e-4 atol 1e-6; every rank ends with the same state; the two controls (the halo
  rows replaced by zeros; BN moments per slab) miss the parameter tolerance;
- (4) each rank's RPN input and output hold its slab's rows only, equal to those rows
  of tdal's RPN input and output (eval) within 1e-5;
- (5) the sparse VoxelNet predicting over data 2 x spatial 2 == tdal's unsharded
  predict, as (1);
- (6) the deformable head (``dcn_head``) over 4 spatial ranks against the port's own
  single-process predict (maps 1e-5) and train step (loss 1e-5, parameters rtol 1e-3
  atol 5e-5, statistics rtol 1e-4 atol 1e-6);
- (7) ``dist_test --device cpu --spatial_shards 2`` writes the ``prediction.pkl`` of
  ``--spatial_shards 1`` (boxes and scores 1e-5, labels exactly) and logs tdal's line;
  ``--spatial_shards 2`` on the card of a machine without two refuses;
- (8) the kernels' halo twins (K3, K4, K5/K6, K7), run slab by slab over uneven slabs
  and concatenated (outputs) or summed (statistics, dw), equal tdal's ``pallas_conv``
  functions on the whole image (tdal's CPU route is its XLA conv): rtol 1e-5, atol 1e-5
  of max(1, |x|).
"""

import copy
import logging
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from tdal_torch.parallel import mesh as pmesh
from tdal_torch.parallel.controls import SP_CONTROLS, control

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PP_TINY = ROOT / "configs/synthetic/pp_tiny.py"
WORLD = 4
VOX = ((-8.0, -8.5, -2.0, 8.0, 8.5, 4.0), (0.5, 0.5, 6.0), 5, 128)
VOX3D = ((-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.5, 0.5, 0.75), 5, 256)
TASKS = [dict(num_class=1, class_names=["VEHICLE"])]
TEST_CFG = dict(
    post_center_limit_range=[-10, -10, -10, 10, 10, 10],
    nms=dict(nms_pre_max_size=64, nms_post_max_size=16, nms_iou_threshold=0.7),
    score_threshold=0.1, pc_range=[-8.0, -8.5], out_size_factor=1, voxel_size=[0.5, 0.5],
)
PP = dict(num_filters=(8,), rpn_layer_nums=(1, 1), rpn_ds_strides=(1, 2),
          rpn_ds_filters=(8, 8), rpn_us_strides=(1, 2), rpn_us_filters=(8, 8))
VN = dict(rpn_layer_nums=(1,), rpn_ds_strides=(1,), rpn_ds_filters=(8,),
          rpn_us_strides=(1,), rpn_us_filters=(8,))
CODE_WEIGHTS = [1.0] * 8
PREDICT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-3, atol=5e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------


def _pp(dcn_head=False):
    from tdal_torch.core.voxel import VoxelConfig
    from tdal_torch.models.detectors import PointPillars

    return PointPillars(VoxelConfig(*VOX), TASKS, dcn_head=dcn_head, **PP)


def _sharded(model, mesh):
    model = copy.deepcopy(model)
    model.bev_sharding = pmesh.spatial_sharding(mesh)
    return model


def predict_job(mesh, model, points) -> dict:
    """The eval forward's (gathered) maps and ``make_predict_step``'s predictions of
    this rank's rows of ``points``, and the RPN's input and output (this rank's rows)."""
    from tdal_torch.pipeline.detector_engine import make_predict_step
    from tdal_torch.runtime.train_state import TrainState

    model = _sharded(model, mesh).eval()
    seen = {}
    hook = model.rpn.register_forward_hook(
        lambda m, args, out: seen.update(rpn_in=args[0].clone(), rpn_out=out.clone(),
                                         slab=(args[1].start, args[1].stop)))
    pts = pmesh.rank_rows(torch.from_numpy(points), mesh)
    with torch.no_grad():
        maps = model(pts)
    hook.remove()
    preds = make_predict_step(model, TEST_CFG)(TrainState(model, None), pts)
    return dict(maps=maps, preds=preds, **seen)


def train_job(mesh, model, batch, control_name=None) -> dict:
    """One ``make_detector_steps`` step with SGD(1.0) on this rank's rows of ``batch``:
    logs and the state after."""
    from tdal_torch.pipeline.detector_engine import make_detector_steps
    from tdal_torch.runtime.train_state import TrainState

    model = _sharded(model, mesh)
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    step = make_detector_steps(model, CODE_WEIGHTS)
    with control(control_name), pmesh.scope(mesh):
        logs = step(TrainState(model, opt), pmesh.shard_batch(batch, mesh))
    return dict(logs={k: float(v) for k, v in logs.items()},
                state={k: v.clone() for k, v in model.state_dict().items()})


def _rank_jobs(mesh, job_file, out_dir):
    """A spawned rank of the data 2 x spatial 2 mesh ``mesh``, which also forms the
    spatial 4 mesh over the same ranks: every job of ``job_file`` (name -> (function,
    mesh name, kwargs)), its results saved to ``out_dir/<rank>.pt``."""
    torch.set_num_threads(1)
    meshes = {"2x2": mesh, "sp4": pmesh.make_mesh(mesh.device, spatial=WORLD)}
    jobs = torch.load(job_file, weights_only=False)
    results = {name: fn(meshes[m], **kwargs) for name, (fn, m, kwargs) in jobs.items()}
    torch.save(results, Path(out_dir) / f"{mesh.rank}.pt")


# ---------------------------------------------------------------------------
# inputs and tdal's references
# ---------------------------------------------------------------------------


def _np_tree(tree):
    import flax
    import jax

    return jax.tree_util.tree_map(np.array, flax.core.unfreeze(tree))


def _batch(vox_args, out_size_factor, n=2, seed=0):
    """tdal's collated training batch (numpy) of ``n`` frames of 200 uniform points and
    one box, as ``tests/test_spatial_partition.py`` makes it."""
    from tdal.core.targets import AssignerConfig, assign_centernet_targets
    from tdal.core.voxel import VoxelConfig, pad_points
    from tdal.data.detection import collate_detection

    vox = VoxelConfig(*vox_args)
    rng = np.random.default_rng(seed)
    asg = AssignerConfig(tasks=TASKS, out_size_factor=out_size_factor, max_objs=10)
    lo, hi = np.array(vox_args[0][:2]), np.array(vox_args[0][3:5])
    items = []
    for i in range(n):
        p = rng.uniform([*lo, -2, 0, 0], [*hi, 4, 1, 1], (200, 5)).astype(np.float32)
        boxes = np.array([[1.0, 2.0, 0.2, 1.8, 4.8, 1.5, 0, 0, 0.3]], np.float32)
        t = assign_centernet_targets(boxes, np.array([1], np.int32), asg, vox.grid_size,
                                     vox.point_cloud_range, vox.voxel_size)
        items.append(dict(t, points=pad_points(p, 256), token=f"t{i}"))
    b = collate_detection(items)
    return {k: (list(v) if isinstance(v, list) else np.asarray(v)) for k, v in b.items()
            if k not in ("token", "gt_boxes_and_cls")}


def _jbatch(batch):
    import jax.numpy as jnp

    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def pp_case():
    """tdal's detector, its predictions, maps, RPN input and output (eval), one SGD(1.0)
    train step; the port's model loaded from its variables; the batch."""
    import jax
    import optax

    from tdal.core.voxel import VoxelConfig as JVoxelConfig
    from tdal.models.detectors import PointPillars as JPointPillars
    from tdal.models.rpn import RPN as JRPN
    from tdal.pipeline.detector_engine import make_detector_steps
    from tdal.runtime.train_state import TrainState, init_model
    from tdal_torch.convert import load_flax_pointpillars, pointpillars_state_dict

    jdet = JPointPillars(voxel_cfg=JVoxelConfig(*VOX), tasks=tuple(TASKS), **PP)
    batch = _batch(VOX, 1)
    jb = _jbatch(batch)
    params, bs = init_model(jdet, {"params": jax.random.PRNGKey(0)}, jb["points"])
    state = TrainState.create(params, optax.sgd(1.0), bs)
    train_step, predict_step = make_detector_steps(jdet, TEST_CFG, CODE_WEIGHTS, donate=False)
    preds = {k: np.asarray(v) for k, v in predict_step(state, jb["points"]).items()}
    variables = {"params": params, "batch_stats": bs}
    seen = {}

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JRPN) and context.method_name == "__call__":
            seen.update(rpn_in=np.asarray(args[0]), rpn_out=np.asarray(out))
        return out

    import flax.linen as nn

    with nn.intercept_methods(capture):
        maps = jdet.apply(variables, jb["points"], train=False)
    maps = [{k: np.asarray(v) for k, v in m.items()} for m in maps]
    new_state, logs = train_step(state, jb)
    model = load_flax_pointpillars(_pp(), _np_tree(params), _np_tree(bs))
    stepped = pointpillars_state_dict(model, _np_tree(new_state.params),
                                      _np_tree(new_state.batch_stats))
    return dict(model=model, batch=batch, preds=preds, maps=maps, loss=float(logs["loss"]),
                stepped=stepped, **seen)


@pytest.fixture(scope="module")
def voxelnet_case():
    """tdal's sparse VoxelNet (``tests/test_spatial_partition.py``'s), its predictions,
    and the port's model loaded from its variables."""
    import jax
    import optax

    from tdal.core.voxel import VoxelConfig as JVoxelConfig
    from tdal.models.detectors import VoxelNet as JVoxelNet
    from tdal.pipeline.detector_engine import make_detector_steps
    from tdal.runtime.train_state import TrainState, init_model
    from tdal_torch.convert import load_flax_voxelnet
    from tdal_torch.core.voxel import VoxelConfig
    from tdal_torch.models.detectors import VoxelNet

    jdet = JVoxelNet(voxel_cfg=JVoxelConfig(*VOX3D), tasks=tuple(TASKS), sparse_middle=True,
                     **VN)
    batch = _batch(VOX3D, 8)
    jb = _jbatch(batch)
    params, bs = init_model(jdet, {"params": jax.random.PRNGKey(0)}, jb["points"])
    cfg = dict(TEST_CFG, pc_range=[-8.0, -8.0], out_size_factor=8)
    _, predict_step = make_detector_steps(jdet, cfg, CODE_WEIGHTS, donate=False)
    state = TrainState.create(params, optax.adam(1e-3), bs)
    preds = {k: np.asarray(v) for k, v in predict_step(state, jb["points"]).items()}
    model = load_flax_voxelnet(VoxelNet(VoxelConfig(*VOX3D), TASKS, sparse_middle=True, **VN),
                               _np_tree(params), _np_tree(bs))
    return dict(model=model, points=batch["points"], preds=preds, test_cfg=cfg)


@pytest.fixture(scope="module")
def dcn_case(pp_case):
    """The detector with the deformable head, fresh from seed 0."""
    from tdal_torch.models.builder import init_detector

    return dict(model=init_detector(_pp(dcn_head=True), torch.Generator().manual_seed(0)),
                batch=pp_case["batch"])


def voxelnet_predict_job(mesh, model, points, test_cfg) -> dict:
    from tdal_torch.pipeline.detector_engine import make_predict_step
    from tdal_torch.runtime.train_state import TrainState

    model = _sharded(model, mesh).eval()
    pts = pmesh.rank_rows(torch.from_numpy(points), mesh)
    return dict(preds=make_predict_step(model, test_cfg)(TrainState(model, None), pts))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, pp_case, voxelnet_case, dcn_case):
    """Every partitioned job on 4 spawned gloo ranks: name -> [each rank's result]."""
    work = tmp_path_factory.mktemp("sp_ranks")
    pp = dict(model=pp_case["model"])
    dcn = dict(model=dcn_case["model"])
    jobs = {
        "predict sp4": (predict_job, "sp4", dict(pp, points=pp_case["batch"]["points"])),
        "predict 2x2": (predict_job, "2x2", dict(pp, points=pp_case["batch"]["points"])),
        "voxelnet 2x2": (voxelnet_predict_job, "2x2", {
            k: voxelnet_case[k] for k in ("model", "points", "test_cfg")}),
        "dcn predict sp4": (predict_job, "sp4", dict(dcn, points=pp_case["batch"]["points"])),
        "dcn train sp4": (train_job, "sp4", dict(dcn, batch=pp_case["batch"])),
    }
    for name in (None, *SP_CONTROLS):
        jobs[("train sp4", name)] = (train_job, "sp4", dict(pp, batch=pp_case["batch"],
                                                            control_name=name))
    torch.save(jobs, work / "jobs.pt")
    pmesh.spawn(_rank_jobs, (str(work / "jobs.pt"), str(work)), devices=["cpu"] * WORLD,
                spatial=2)
    per_rank = [torch.load(work / f"{r}.pt", weights_only=False) for r in range(WORLD)]
    return {name: [p[name] for p in per_rank] for name in jobs}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _close(got, want, tol=PREDICT_TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=what, **tol)


def _check_preds(got, want, what):
    """Valid slots and labels exactly, boxes and scores of the valid slots within
    ``PREDICT_TOL``."""
    valid = np.asarray(got["valid"])
    np.testing.assert_array_equal(valid, want["valid"], err_msg=what)
    assert valid.any(), what
    np.testing.assert_array_equal(np.asarray(got["label_preds"])[valid],
                                  want["label_preds"][valid], err_msg=what)
    for k in ("box3d_lidar", "scores"):
        _close(np.asarray(got[k])[valid], want[k][valid], what=f"{what} {k}")


def _cat_rows(results, key):
    """The data axis's rows of a 2 x 2 mesh's predictions (ranks 0 and 2: spatial 0)."""
    return {k: torch.cat([results[r][key][k] for r in (0, 2)]).numpy()
            for k in results[0][key]}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_row_partition_nests_and_refuses_what_does_not():
    """The coarsest level's rows in near-equal ranges, every finer level the same ranges
    times its factor; a level that does not nest, or more ranks than rows, refuses."""
    assert pmesh.row_ranges(117, 2) == ((0, 59), (59, 117))
    assert pmesh.row_ranges(17, 4) == ((0, 5), (5, 9), (9, 13), (13, 17))
    mesh = pmesh.Mesh(2, 1, torch.device("cpu"), spatial=2)
    slab = pmesh.spatial_slab(mesh, 468, 4)
    assert (slab.start, slab.stop, slab.height) == (236, 468, 468)
    assert [(s.start, s.stop) for s in (slab.scaled(1, 2), slab.scaled(1, 4))] == [
        (118, 234), (59, 117)]
    assert slab.halo() == (1, 0) and slab.halo(True, False) == (1, 0)
    with pytest.raises(ValueError, match="do not nest"):
        pmesh.spatial_slab(mesh, 470, 4)
    with pytest.raises(ValueError, match="do not nest"):
        slab.scaled(1, 8)
    with pytest.raises(ValueError, match="cannot split"):
        pmesh.spatial_slab(pmesh.Mesh(8, 0, torch.device("cpu"), spatial=8), 28, 4)


def test_sp_predict_matches_tdal_unsharded(ranks, pp_case):
    """(1) Over 4 spatial ranks (coarse rows 5/4/4/4): every rank's gathered head maps
    and predictions are tdal's unsharded ones."""
    for r, res in enumerate(ranks["predict sp4"]):
        for name, want in pp_case["maps"][0].items():
            _close(res["maps"][0][name], want, what=f"rank {r} map {name}")
        _check_preds({k: v.numpy() for k, v in res["preds"].items()}, pp_case["preds"],
                     f"rank {r}")


def test_data_by_spatial_predict_matches_tdal_unsharded(ranks, pp_case):
    """(2) Data 2 x spatial 2: each data rank's frame predicted from its two slabs; the
    spatial ranks of a data rank agree exactly."""
    res = ranks["predict 2x2"]
    for a, b in ((0, 1), (2, 3)):
        for k, v in res[a]["preds"].items():
            assert torch.equal(v, res[b]["preds"][k]), k
    _check_preds(_cat_rows(res, "preds"), pp_case["preds"], "2 x 2")


def test_sp_train_step_matches_tdal_unsharded(ranks, pp_case):
    """(3) One SGD(1.0) step over 4 spatial ranks against tdal's unsharded step: the
    loss, every parameter after the step and every running statistic; every rank ends
    with the same state."""
    res = ranks[("train sp4", None)]
    want = pp_case["stepped"]
    np.testing.assert_allclose(res[0]["logs"]["loss"], pp_case["loss"], rtol=LOSS_RTOL)
    for k, v in res[0]["state"].items():
        tol = STAT_TOL if "running" in k else PARAM_TOL
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **tol)
    for other in res[1:]:
        assert other["logs"] == res[0]["logs"]
        for k, v in res[0]["state"].items():
            assert torch.equal(v, other["state"][k]), k


@pytest.mark.parametrize("name", SP_CONTROLS)
def test_sp_train_step_controls_fail(ranks, pp_case, name):
    """(3) The halo rows replaced by zeros (each slab a separate image), and BN moments
    left per slab: the same comparison must fail on the parameters."""
    state = ranks[("train sp4", name)][0]["state"]
    worst = 0.0
    for k, v in state.items():
        if "running" in k:
            continue
        w = pp_case["stepped"][k].numpy().astype(np.float64)
        allowed = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(w)
        worst = max(worst, float((np.abs(v.numpy() - w) / allowed).max()))
    assert worst > 10, f"control {name}: worst parameter at {worst:.3f} of its tolerance"


def test_rpn_runs_on_the_slab_rows_only(ranks, pp_case):
    """(4) Each rank's RPN input and output hold its slab's rows (5/4/4/4 of the 17
    coarse rows, times 2 here) and equal those rows of tdal's."""
    starts = []
    for r, res in enumerate(ranks["predict sp4"]):
        a, b = res["slab"]
        starts.append(a)
        assert res["rpn_in"].shape[1] == res["rpn_out"].shape[1] == b - a
        _close(res["rpn_in"], pp_case["rpn_in"][:, a:b], what=f"rank {r} RPN input")
        _close(res["rpn_out"], pp_case["rpn_out"][:, a:b], what=f"rank {r} RPN output")
    assert starts == [0, 10, 18, 26]


def test_sp_sparse_voxelnet_predict_matches_tdal_unsharded(ranks, voxelnet_case):
    """(5) The sparse VoxelNet over data 2 x spatial 2 (its 4 BEV rows 2/2 a spatial
    group) against tdal's unsharded predict."""
    _check_preds(_cat_rows(ranks["voxelnet 2x2"], "preds"), voxelnet_case["preds"],
                 "VoxelNet 2 x 2")


def test_dcn_head_sp_matches_one_process(ranks, dcn_case):
    """(6) The deformable head over 4 spatial ranks (the sampling reads the gathered
    shared map; each rank computes its rows) against the port's single process: the
    eval maps, and one SGD(1.0) train step."""
    model = dcn_case["model"]
    with torch.no_grad():
        maps = copy.deepcopy(model).eval()(torch.from_numpy(dcn_case["batch"]["points"]))
    for r, res in enumerate(ranks["dcn predict sp4"]):
        for name, want in maps[0].items():
            _close(res["maps"][0][name], want, what=f"rank {r} map {name}")
    single = _single_step(model, dcn_case["batch"])
    got = ranks["dcn train sp4"][0]
    np.testing.assert_allclose(got["logs"]["loss"], single["logs"]["loss"], rtol=LOSS_RTOL)
    for k, v in got["state"].items():
        tol = STAT_TOL if "running" in k else PARAM_TOL
        np.testing.assert_allclose(v.numpy(), single["state"][k].numpy(), err_msg=k, **tol)


def _single_step(model, batch) -> dict:
    from tdal_torch.pipeline.detector_engine import make_detector_steps
    from tdal_torch.runtime.train_state import TrainState

    model = copy.deepcopy(model)
    logs = make_detector_steps(model, CODE_WEIGHTS)(
        TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0)), batch)
    return dict(logs={k: float(v) for k, v in logs.items()},
                state={k: v.clone() for k, v in model.state_dict().items()})


def test_dist_test_spatial_shards_match_one_process(tmp_path, monkeypatch):
    """(7) ``dist_test --device cpu --spatial_shards 2`` (two gloo ranks) writes the
    ``prediction.pkl`` of ``--spatial_shards 1``; on the card, a machine with fewer
    cards than shards refuses before it loads anything."""
    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.models.builder import build_detector, build_voxel_config
    from tdal_torch.runtime.config import Config
    from tdal_torch.tools import dist_test

    make_synthetic_dataset(tmp_path / "val", n_scenes=1, n_frames=2, seed=2,
                           n_background=800, points_per_object=64)
    cfg = Config.fromfile(PP_TINY)
    model = build_detector(cfg.model, build_voxel_config(cfg.voxel_generator), "cpu", 0)
    ckpt = tmp_path / "model.pt"
    torch.save({"model": model.state_dict()}, ckpt)
    common = [str(PP_TINY), "--checkpoint", str(ckpt), "--info_path",
              str(tmp_path / "val" / "infos.pkl"), "--batch_size", "2"]
    out = {}
    for n in (1, 2):
        work = tmp_path / f"shards{n}"
        dist_test.main([*common, "--work_dir", str(work), "--device", "cpu",
                        "--spatial_shards", str(n)])
        out[n] = pickle.loads((work / "prediction.pkl").read_bytes())
    assert "spatial partitioning: BEV canvas H over 2 devices" in (
        tmp_path / "shards2" / "test.log").read_text()
    assert out[1].keys() == out[2].keys() and len(out[1]) == 2
    for token, want in out[1].items():
        got = out[2][token]
        np.testing.assert_array_equal(got["label_preds"], want["label_preds"])
        _close(got["box3d_lidar"], want["box3d_lidar"], what=token)
        _close(got["scores"], want["scores"], what=token)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards; this machine has 1"):
        dist_test.main([*common, "--work_dir", str(tmp_path / "card"), "--spatial_shards",
                        "2"])


def _slabs(h, cuts):
    return list(zip([0, *cuts], [*cuts, h]))


@pytest.mark.parametrize("in_act", [True, False])
def test_halo_twins_slab_by_slab_match_tdal_whole_image(in_act):
    """(8) K3, K4, K5/K6 and K7 as their halo twins on three uneven slabs (the first and
    last at the image's edges), f32, against tdal's ``pallas_conv`` on the whole image:
    with the input affine (K3, K5, K7) or without (K3, K6, the K4 dgrad), through
    ``jax.vjp`` of ``conv3x3_act_stats`` with the statistics' cotangent zero; and K4's
    affine + ReLU forward against ``conv3x3_affine``."""
    import jax
    import jax.numpy as jnp

    from tdal.ops import pallas_conv as jpc
    from tdal_torch.ops import conv3x3 as cv

    rng = np.random.default_rng(3)
    b, h, w, c, co = 2, 11, 9, 8, 16
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, c, co)) * 0.2).astype(np.float32)
    bias = rng.normal(size=co).astype(np.float32)
    s = rng.uniform(0.5, 1.5, c).astype(np.float32)
    t = rng.uniform(0.1, 0.6, c).astype(np.float32)  # positive: a leaked relu(t) shows
    gy = rng.normal(size=(b, h, w, co)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    J = jnp.asarray
    T = V = torch.from_numpy
    slabs = _slabs(h, [4, 7])
    big = lambda a: dict(tol, atol=tol["atol"] * max(1.0, float(np.abs(a).max())))  # noqa: E731
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    g = lambda a: a.float().numpy()  # noqa: E731
    if True:
        fwd = lambda xx, ww, ss, tt: jpc.conv3x3_act_stats(  # noqa: E731
            xx, ww, jnp.asarray(bias), ss, tt, in_act)
        (jy, jst), vjp = jax.vjp(fwd, J(x), J(wt), jnp.asarray(s), jnp.asarray(t))
        jdx, jdw, jds, jdt_ = vjp((J(gy), jnp.zeros_like(jst)))
        ys, sts, dws, dxs, dsts = [], 0, 0, [], 0
        for i, (a, bb) in enumerate(slabs):
            halo = (int(i > 0), int(i < len(slabs) - 1))
            lo, hi = a - halo[0], bb + halo[1]
            y, st = cv.conv3x3_fwd_stats_plain(T(x[:, lo:hi]), T(wt), V(bias), V(s), V(t),
                                               in_act, halo)
            ys.append(y)
            sts = sts + st
            dws = dws + cv.conv3x3_wgrad_plain(T(x[:, lo:hi]), T(gy[:, a:bb]), V(s), V(t),
                                               in_act, halo)
            flipped = T(np.ascontiguousarray(np.flip(wt, (0, 1)).transpose(0, 1, 3, 2)))
            if in_act:
                dx, dst = cv.conv3x3_dgrad_act_plain(T(gy[:, lo:hi]), flipped, T(x[:, a:bb]),
                                                     V(s), V(t), halo)
                dsts = dsts + dst
            else:
                dx = cv.conv3x3_fwd_plain(T(gy[:, lo:hi]), flipped, torch.zeros(c),
                                          halo=halo)
            dxs.append(dx)
        np.testing.assert_allclose(g(torch.cat(ys, 1)), f(jy), **big(f(jy)), err_msg="K3 y")
        np.testing.assert_allclose(g(sts), f(jst), **big(f(jst)), err_msg="K3 stats")
        np.testing.assert_allclose(g(dws), f(jdw), **big(f(jdw)), err_msg="K5/K6 dw")
        np.testing.assert_allclose(g(torch.cat(dxs, 1)), f(jdx), **big(f(jdx)),
                                   err_msg="K7 / K4 dgrad dx")
        if in_act:
            np.testing.assert_allclose(g(dsts[0]), f(jds), **big(f(jds)), err_msg="K7 ds")
            np.testing.assert_allclose(g(dsts[1]), f(jdt_), **big(f(jdt_)), err_msg="K7 dt")
    # K4 forward (an affine + ReLU) slab by slab against tdal's conv3x3_affine
    scale, shift = rng.uniform(0.5, 2, co).astype(np.float32), bias
    want = f(jpc.conv3x3_affine(J(x), J(wt), jnp.asarray(scale), jnp.asarray(shift), True))
    got = torch.cat([cv.conv3x3_fwd_plain(
        T(x[:, a - (i > 0) : bb + (i < 2)]), T(wt), V(shift), V(scale), True,
        (int(i > 0), int(i < 2))) for i, (a, bb) in enumerate(slabs)], 1)
    np.testing.assert_allclose(g(got), want, **big(want), err_msg="K4")
