"""The plain reference against the port at a small width: one PointPillars train step
(loss, every parameter's gradient) and one VoxelNet predict (its kept set judged on the
reference's maps). The same on the card is marked ``gpu``."""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import common
from portbench.modes import detect
from portbench.reference import data as ref_data
from portbench.reference import judge
from portbench.reference import models as ref_models
from portbench.reference import optim as ref_optim
from portbench.tests import tiny
from portbench.traffic import waymo_raycast as rc

HERE = Path(__file__).resolve().parents[1]
SEED = 2**31 + 4242


@pytest.fixture
def device(request):
    """The parametrised device, with both TF32 switches off as the benchmark runs (the
    configs state float32; PyTorch's default lets cuDNN's convs take TF32)."""
    kind = request.param
    if kind == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device(kind)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _cell(kind, mode, tmp):
    base = tiny.make_copy(Path(tmp))
    return common.load_cell(f"tiny_{kind}_{mode}", base)


def pp_step(device):
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config
    from tdal_torch.pipeline.detector_engine import make_detector_steps
    from tdal_torch.pipeline.detector_run import detection_batches
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState

    with tempfile.TemporaryDirectory() as tmp:
        cell = _cell("pp", "train", tmp)
        cfg, p = cell["config_file"]["config"], cell["traffic_params"]
        frames = rc.make_pool(SEED, p, device)
        infos = rc.write_pool(frames, Path(tmp) / "pool")
        vox = build_voxel_config(cfg["voxel_generator"], train=True)
        model = build_detector(cfg["model"], vox, device=device)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        fan = lambda k, s: ref_models.param_fan_in(k, s, cfg)  # noqa: E731
        w = common.make_weights(shapes, fan, SEED, device, 3)
        model.load_state_dict(w)
        lr, mom = one_cycle(3e-3, 1000)
        opt = adam_with_schedule(model.parameters(), lr, 0.01, 35.0, mom)
        pre = cfg["train_preprocessor"]
        ds = DetectionDataset(infos, cfg["class_names"], build_assigner(cfg["assigner"], model),
                              vox, max_points=cfg["data"]["train"]["max_points"],
                              global_rot_noise=tuple(pre["global_rot_noise"]),
                              global_scale_noise=tuple(pre["global_scale_noise"]), seed=11)
        batch = int(cfg["data"]["samples_per_gpu"])
        head = cfg["model"]["bbox_head"]
        logs = make_detector_steps(model, head["code_weights"], head["weight"])(
            TrainState(model, opt), next(detection_batches(ds, batch, shuffle=True, seed=5)))
        grads = {k: float(opt.state[pp]["m"].norm()) / (1 - mom(0))
                 for k, pp in model.named_parameters()}
        params = list(grads)
        pool = [dict(points=rc.loader_points(f), gt_boxes=f["gt_boxes"], gt_names=f["gt_names"])
                for f in frames]
        ref = ref_optim.reference_steps(w, params, ref_data.train_batches(pool, cfg, batch, 5, 11, 1),
                                        cfg, 1000, device)
    return float(logs["loss"]), grads, ref


def vn_predict(device):
    from tdal_torch.models.builder import build_detector, build_test_cfg, build_voxel_config
    from tdal_torch.pipeline.detector_engine import make_predict_step, predictions_to_host
    from tdal_torch.runtime.train_state import TrainState

    with tempfile.TemporaryDirectory() as tmp:
        cell = _cell("vn", "detect", tmp)
        run = common.Run(cell=cell, seed=SEED, seconds=0, trace=False, device=device,
                         workdir=Path(tmp))
        cfg = run.config
        frames = rc.make_pool(SEED, run.traffic, device)[:2]
        vox = build_voxel_config(cfg["voxel_generator"], train=False)
        model = build_detector(cfg["model"], vox, device=device)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        w = detect.detector_weights(run, shapes, frames)
        model.load_state_dict(w)
        test_cfg = build_test_cfg(cfg["test_cfg"], model, vox)
        points = detect._padded(frames, cfg, device)
        answers = predictions_to_host(make_predict_step(model, test_cfg)(
            TrainState(model, None), points), ["a", "b"])
        with torch.no_grad():
            maps, _ = ref_models.voxelnet_eval(points, w, cfg)
        boxes, scores = ref_models.decode(maps[0], test_cfg)
        return [judge.judge_frame(boxes[i], scores[i], answers[t], test_cfg, 1e-5, 1e-4)
                for i, t in enumerate("ab")]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)],
                         indirect=True)
def test_pointpillars_train_step(device):
    loss, grads, ref = pp_step(device)
    assert loss == pytest.approx(ref["losses"][0], rel=1e-5)
    med = float(np.median(list(ref["grad1"].values())))
    gaps = {k: abs(grads[k] - ref["grad1"][k]) / max(ref["grad1"][k], med) for k in grads}
    # the median leaf, as the cell compares it (rounding alone moves the worst leaf's
    # norm by up to 1e-2 at the cell's size: PERF.md section 2)
    assert float(np.median(list(gaps.values()))) < 1e-4
    assert max(gaps.values()) < 2e-2, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)],
                         indirect=True)
def test_voxelnet_predict(device):
    for r in vn_predict(device):
        assert r["kept"] > 0
        assert r["violations"] == 0, r["detail"]
        assert r["score_gap"] < 1e-5 and r["box_gap"] < 1e-4
