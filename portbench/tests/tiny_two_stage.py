"""A tiny two-stage cell for the CPU tests: the two-sweep two-stage configuration at
small widths and grid (16 RoIs a frame), and a ray-cast of a few beams with its
previous sweep, written as files of their own beside ``tiny.py``'s cells in a copy of
the benchmark's folder."""

from __future__ import annotations

import json
from pathlib import Path

from portbench import common
from portbench.tests import tiny

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CELL = "tiny_vn2ts_detect"
ROIS = 16
KEPT = 10  # boxes a frame that the calibrated first stage keeps, of its 16 RoIs


def tiny_vn2ts(cfg: dict) -> dict:
    c = json.loads(json.dumps(cfg))
    rng = [-35.2, -35.2, -2, 35.2, 35.2, 4]
    c["voxel_generator"].update(range=rng, max_voxel_num=[12000, 12000])
    first = c["model"]["first_stage_cfg"]
    first["neck"].update(layer_nums=[1, 1], ds_num_filters=[16, 32], us_num_filters=[16, 16])
    c["model"]["second_stage_modules"][0]["pc_start"] = rng[:2]
    c["model"]["roi_head"]["input_channels"] = 5 * 32
    c["model"]["NMS_POST_MAXSIZE"] = ROIS
    c["test_cfg"].update(pc_range=rng[:2], post_center_limit_range=[-40, -40, -10, 40, 40, 10])
    c["test_cfg"]["nms"]["nms_post_max_size"] = ROIS
    c["data"]["samples_per_gpu"] = 2
    c["data"]["val"]["max_points"] = 12000
    return c


def tiny_traffic() -> dict:
    """``raycast_sweeps_detect`` cut as ``tiny.py`` cuts the other cells' traffic."""
    return tiny._traffic("sweeps_detect")


def make_copy(dest: Path) -> Path:
    """``tiny.make_copy``'s folder with the cell ``tiny_vn2ts_detect`` added as files."""
    base = tiny.make_copy(dest)
    conf = json.loads((HERE / "configs" / "waymo_voxelnet_2sweep_two_stage.json").read_text())
    conf["config"] = tiny_vn2ts(conf["config"])
    (base / "configs" / "tiny_vn2ts.json").write_text(json.dumps(conf))
    (base / "traffic" / "tiny_sweeps_detect.json").write_text(json.dumps(tiny_traffic()))
    cell = json.loads((HERE / "workloads" / "vn2ts_detect.json").read_text())
    cell.update(config="tiny_vn2ts", traffic="tiny_sweeps_detect")
    cell["weights"]["kept_per_frame"] = KEPT
    (base / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    return base


def benchmark() -> dict:
    """BENCHMARK.json with the tiny cell reporting what ``vn2ts_detect`` reports."""
    b = common.load_json(ROOT / "BENCHMARK.json")
    for group in ("end_to_end", "per_layer"):
        for m in b[group]:
            if "vn2ts_detect" in m.get("workloads", []):
                m["workloads"] = m["workloads"] + [CELL]
    return b
