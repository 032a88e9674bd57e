"""The port's two-stage detector against the benchmark's plain reference
(``portbench/reference/two_stage.py``) at a tiny size on the CPU: the two-sweep,
velocity, two-stage configuration cut to a 704-cell grid, a 32-channel BEV map and 16
RoIs a frame, on two ray-cast frames with their previous sweeps, with the benchmark's
seeded and calibrated weights. Held: the merged two-sweep points that
``DetectionDataset`` hands on, the first stage's maps (``vel`` included), the RoIs,
the five-point BEV samples, and the final rescored boxes and scores; and the reference
loads nothing of the program."""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import common
from portbench.reference import two_stage as ref
from portbench.reference.data import pad_points
from portbench.tests import tiny_two_stage as tt
from portbench.traffic import waymo_sweeps

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 1913
SPREAD = {"reg": 0.3, "height": 0.3, "dim": 0.3, "rot": 1.0, "vel": 0.3, "hm": 1.0}


@pytest.fixture(scope="module")
def setup():
    """(config, frames, the dataset's batch, engine, reference weights)."""
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.models.builder import (
        build_assigner, build_detector, build_test_cfg, build_two_stage_engine,
        build_voxel_config,
    )
    from tdal_torch.pipeline.detector_run import detection_batches

    conf = json.loads((ROOT / "portbench/configs/waymo_voxelnet_2sweep_two_stage.json").read_text())
    cfg = tt.tiny_vn2ts(conf["config"])
    p = tt.tiny_traffic()
    frames = [waymo_sweeps.make_frame(SEED, s, p, "cpu") for s in (0, 1)]
    vox = build_voxel_config(cfg["voxel_generator"], train=False)
    first = build_detector(cfg["model"]["first_stage_cfg"], vox, device="cpu")
    engine = build_two_stage_engine(cfg["model"], vox, build_test_cfg(cfg["test_cfg"], first, vox),
                                    device="cpu")
    n = int(cfg["data"]["val"]["max_points"])
    points = torch.as_tensor(np.stack([pad_points(ref.merged_points(f), n) for f in frames]))
    shapes = {k: tuple(v.shape) for k, v in engine.state_dict().items()}
    w = common.make_weights(shapes, lambda k, s: ref.param_fan_in(k, s, cfg), SEED, "cpu", 3)
    w = ref.calibrate(w, [points], cfg, SPREAD, tt.KEPT, 0.95, 0.1)
    engine.load_state_dict(w)
    engine.eval()
    with tempfile.TemporaryDirectory() as tmp:
        infos = waymo_sweeps.write_pool(frames, tmp)
        ds = DetectionDataset(infos, cfg["class_names"], build_assigner(cfg["assigner"], first),
                              vox, mode="test", nsweeps=2, max_points=n)
        batch = next(iter(detection_batches(ds, 2, shuffle=False)))
    return cfg, frames, batch, points, engine, w


def test_the_dataset_merges_the_sweeps_as_the_reference(setup):
    """Bit for bit and in float32: each sweep's points moved by its transform_matrix in
    float64 and written back as float32, as det3d's ``read_sweep`` does."""
    _, frames, batch, points, _, _ = setup
    got = np.asarray(batch["points"])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, points.numpy())
    assert (got[0, : len(frames[0]["points"]), 5] == 0).all()
    assert np.isclose(got[0, len(frames[0]["points"]), 5], 0.1)


def _max_gap(a, b):
    return float((a - b).abs().max())


def test_first_stage_rois_and_samples_match_the_reference(setup):
    cfg, _, _, points, engine, w = setup
    with torch.no_grad():
        maps, rois, labels, scores, feats, valid = engine.first_stage_rois(points, False)
        rmaps, rbev = ref.first_stage(points, w, cfg)
    assert set(maps[0]) == set(ref.BRANCHES)
    for name, m in rmaps[0].items():
        # the port's per-tap sparse contraction and its convs sum in another order than
        # the reference's: float32 rounding, 1e-5 of the map's largest magnitude
        got = maps[0][name].permute(0, 3, 1, 2)
        assert _max_gap(got, m) <= 1e-5 * max(1.0, float(m.abs().max())), name
    boxes, cls = ref.decode(rmaps[0], cfg["test_cfg"])
    sec = cfg["model"]["second_stage_modules"][0]
    assert int(valid.sum()) > 8 and rois.shape[1] == tt.ROIS
    for j in range(len(points)):
        best, label = cls[j].max(-1)
        v = valid[j]
        # each valid RoI is a decoded candidate of the reference's (heading at 6, the
        # velocity at 7:9), with its best score and class: rounding of the maps above,
        # carried through exp and atan2, 1e-4 of a box's columns
        d = ((boxes[j][:, None, list(ref.ROI)] - rois[j][v][None]) ** 2).sum(-1)
        near = d.argmin(0)
        assert _max_gap(boxes[j][near][:, list(ref.ROI)], rois[j][v]) <= 1e-4
        assert _max_gap(best[near], scores[j][v]) <= 1e-5  # a sigmoid of the maps above
        assert torch.equal(label[near] + 1, labels[j][v])
        assert (rois[j][~v] == 0).all() and (labels[j][~v] == 0).all()
        # the five-point samples at the program's RoIs: the same bilinear arithmetic
        # on maps equal to rounding, 1e-5 of the map's largest magnitude
        want = ref.bev_sample(rbev[j], ref.box_points(rois[j][v]), sec)
        assert _max_gap(feats[j][v], want) <= 1e-5 * max(1.0, float(rbev[j].abs().max()))


def test_final_boxes_and_scores_match_the_reference(setup):
    """The predict step's rescored answers against the reference's second stage on the
    reference's own candidates, through the benchmark's judge: refine_gap and
    rescore_gap under the cell's limits, no NMS violation."""
    from tdal_torch.pipeline.detector_engine import predictions_to_host
    from tdal_torch.pipeline.two_stage_engine import make_two_stage_steps
    from tdal_torch.runtime.train_state import TrainState

    cfg, _, _, points, engine, w = setup
    cell = json.loads((ROOT / "portbench/workloads/vn2ts_detect.json").read_text())
    out = predictions_to_host(make_two_stage_steps(engine)[1](TrainState(engine, None), points),
                              ["a", "b"])
    with torch.no_grad():
        rmaps, rbev = ref.first_stage(points, w, cfg)
        boxes, cls = ref.decode(rmaps[0], cfg["test_cfg"])
    kept = 0
    for j, tok in enumerate(("a", "b")):
        best = cls[j].max(-1).values
        refined, rescored, _ = ref.second_stage(rbev[j], boxes[j], best, w, cfg)
        r = ref.judge_frame(boxes[j], cls[j], refined, rescored, out[tok], cfg["test_cfg"],
                            cell["nms_margins"]["score"], cell["nms_margins"]["iou"])
        assert r["violations"] == 0, r["detail"]
        assert r["refine_gap"] <= cell["checks"]["refine_gap"]
        assert r["rescore_gap"] <= cell["checks"]["rescore_gap"]
        assert out[tok]["box3d_lidar"].shape[1] == 9
        kept += r["kept"]
    assert kept > 8


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
            "import portbench.reference.two_stage, portbench.traffic.waymo_sweeps; "
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tdal", "tdal_torch"}
