"""The two-stage cell: a sound run at a tiny size on the CPU is correct; ``correct``
comes out false with each of three faults planted in the program here (the second
stage skipped, so the first stage's boxes and scores come back; the velocity columns
zeroed; one RoI's score altered). At the cell's own size on the card (marker ``gpu``):
the same three faults, and the TF32 control through ``run.py``."""

import contextlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import pytest
import torch

from portbench import common
from portbench.tests import tiny_two_stage as tt

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SEED = 2**31 + 2718


@pytest.fixture(scope="module")
def base():
    with tempfile.TemporaryDirectory() as tmp:
        yield tt.make_copy(Path(tmp))


@contextlib.contextmanager
def fault(name: str):
    """The program with the fault ``name`` planted where it produces its answers."""
    from tdal_torch.pipeline import two_stage_engine as ts

    if name is None:
        yield
        return
    real = ts.two_stage_post_process
    if name == "second_stage_skipped":
        def post(boxes, rcnn_cls, roi_scores, roi_labels, valid):
            out = real(boxes, rcnn_cls, roi_scores, roi_labels, valid)
            out["scores"] = torch.where(out["valid"], roi_scores, out["scores"])
            return out

        with mock.patch.object(ts, "generate_predicted_boxes", lambda rois, reg: rois), \
                mock.patch.object(ts, "two_stage_post_process", post):
            yield
        return

    def post(*a):
        out = real(*a)
        if name == "velocity_zeroed":
            out["box3d_lidar"] = out["box3d_lidar"].clone()
            out["box3d_lidar"][..., 6:8] = 0.0
        else:  # "score_altered": the first valid RoI of the batch
            i = int(out["valid"].flatten().nonzero()[0]) if out["valid"].any() else 0
            out["scores"] = out["scores"].clone()
            out["scores"].view(-1)[i] += 0.01
        return out

    with mock.patch.object(ts, "two_stage_post_process", post):
        yield


FAULTS = ("second_stage_skipped", "velocity_zeroed", "score_altered")


def run_cell(cell, device, seconds, fault_name=None, trace=False, benchmark=None):
    from portbench import run as runner

    with tempfile.TemporaryDirectory() as tmp, fault(fault_name):
        r = common.Run(cell=cell, seed=SEED, seconds=seconds, trace=trace,
                       device=torch.device(device), workdir=Path(tmp))
        return runner.execute(r, benchmark or tt.benchmark(), 0.0)


def test_a_sound_run_is_correct(base):
    res = run_cell(common.load_cell(tt.CELL, base), "cpu", 1.0, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"nms_violations", "refine_gap", "rescore_gap"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"  # never a device metric from the CPU
    m = res["metrics"]
    assert 0 < m["roi_fill.two_stage"]["value"] <= 100
    assert m["sweep_merge_ms.two_stage"]["value"] > 0
    assert not any(k.startswith(("mfu", "device_idle", "sparse_conv", "second_stage",
                                 "backbone")) for k in m)


@pytest.mark.parametrize("name", FAULTS)
def test_a_fault_is_not_correct(base, name):
    res = run_cell(common.load_cell(tt.CELL, base), "cpu", 0.5, name)
    assert not res["correct"], res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAULTS)
def test_a_fault_at_the_cells_size_is_not_correct(card, name):
    cell = common.load_cell("vn2ts_detect")
    res = run_cell(cell, card, 2.0, name, benchmark=common.load_json(ROOT / "BENCHMARK.json"))
    print(json.dumps(res["checks"]))
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
def test_the_tf32_control_fails(card):
    r = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "vn2ts_detect",
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0",
                        "--control", "tf32"], capture_output=True, text=True, cwd=ROOT,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    print(json.dumps(res["checks"]))
    assert res["correct"] is False, res["checks"]
