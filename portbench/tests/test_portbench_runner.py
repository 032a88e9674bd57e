"""The runner: cells found by name, a run's result on the CPU at a tiny size, and
``correct`` coming out false when the timed path is broken underneath, once for each
fault the cell can have (``portbench/controls.py``). The control (the program's TF32
path on) at the cells' own size is marked ``gpu``."""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from portbench import common
from portbench.tests import tiny

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SEED = 2**31 + 31337


@pytest.fixture(scope="module")
def base():
    with tempfile.TemporaryDirectory() as tmp:
        yield tiny.make_copy(Path(tmp))


def benchmark_for(base) -> dict:
    """BENCHMARK.json with the tiny cells reporting what the cells they stand for do."""
    b = common.load_json(ROOT / "BENCHMARK.json")
    stand = {"pp_train": "tiny_pp_train", "vn_detect": "tiny_vn_detect"}
    for group in ("end_to_end", "per_layer"):
        for m in b[group]:
            if "workloads" in m:
                m["workloads"] = m["workloads"] + [stand[w] for w in m["workloads"]]
    return b


def run_cell(base, name, seed=SEED, trace=False, seconds=1.0, device="cpu", control=None):
    from portbench import run as runner

    cell = common.load_cell(name, base)
    with tempfile.TemporaryDirectory() as tmp:
        r = common.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                       device=torch.device(device), workdir=Path(tmp), control=control)
        return runner.execute(r, benchmark_for(base), 0.0)


def test_a_cell_added_as_a_file_is_listed_without_an_edit(base):
    assert {"pp_train", "vn_detect", "tiny_pp_train", "tiny_vn_detect"} <= set(common.cells(base))
    dummy = dict(common.load_json(base / "workloads" / "tiny_pp_train.json"), chips=1)
    (base / "workloads" / "dummy_cell.json").write_text(json.dumps(dummy))
    assert "dummy_cell" in common.cells(base)
    assert common.load_cell("dummy_cell", base)["config_file"]["config"]["data"][
        "samples_per_gpu"] == 2
    (base / "workloads" / "dummy_cell.json").unlink()


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "pp_train",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_checkout_without_the_program_gives_no_result():
    with tempfile.TemporaryDirectory() as tmp:
        import shutil

        shutil.copytree(HERE, Path(tmp) / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp)
        env = dict(os.environ, PYTHONPATH="")
        r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "pp_train",
                            "--seed", "1", "--seconds", "1", "--trace", "0"],
                           capture_output=True, text=True, cwd=tmp, env=env, timeout=300)
        assert r.returncode != 0 and r.stdout == ""


@pytest.mark.parametrize("name,checks", [
    ("tiny_pp_train", {"loss1_gap", "loss_gap", "grad_median_gap", "update_gap",
                       "update_dir_median_gap"}),
    ("tiny_vn_detect", {"score_gap", "box_gap", "nms_violations"})])
def test_a_sound_run_is_correct(base, name, checks):
    res = run_cell(base, name, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == checks and list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"  # never a device metric from the CPU
    assert not any(k.startswith(("mfu", "device_idle", "conv3x3", "sparse_conv"))
                   for k in res["metrics"])


@pytest.mark.parametrize("name,fault", [
    ("tiny_pp_train", "unchanged_state"), ("tiny_pp_train", "half_batch"),
    ("tiny_pp_train", "flipped_update"),
    ("tiny_vn_detect", "half_answers"), ("tiny_vn_detect", "altered_answer")])
def test_a_broken_timed_path_is_not_correct(base, name, fault):
    res = run_cell(base, name, control=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pp_train", "vn_detect"])
def test_the_tf32_control_fails(name):
    """At the cell's own size on the card: the program with its TF32 path on, through
    ``run.py`` and its comparison, comes out not correct."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    r = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", name,
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0",
                        "--control", "tf32"], capture_output=True, text=True, cwd=ROOT,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
