"""Tiny cells for the CPU tests: the two configurations at small widths and grids, and a
ray-cast of a few beams, written as files of their own into a copy of the benchmark's
folder, so that the runner finds them by name as it finds any cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _traffic(name: str) -> dict:
    t = json.loads((HERE / "traffic" / f"raycast_{name}.json").read_text())
    t.update(beams=12, azimuth_steps=360, max_range_m=24.0, pool_frames=4, repeats=4,
             trace_steps=2, warm_batches=1, max_object_range_m=22.0,
             clutter_count=[5, 15], street_half_width_m=[6.0, 9.0])
    t["objects"] = {k: dict(v, count=[1, 4]) for k, v in t["objects"].items()}
    return t


def tiny_pp(cfg: dict) -> dict:
    c = json.loads(json.dumps(cfg))
    rng = [-25.6, -25.6, -2, 25.6, 25.6, 4.0]
    c["voxel_generator"].update(range=rng, voxel_size=[0.8, 0.8, 6.0], max_voxel_num=[2048, 2048])
    c["model"]["reader"].update(num_filters=[16, 16], voxel_size=[0.8, 0.8, 6.0], pc_range=rng)
    c["model"]["neck"].update(layer_nums=[1, 2, 1], ds_num_filters=[16, 32, 32],
                              us_num_filters=[16, 16, 16], num_input_features=16)
    c["test_cfg"].update(pc_range=rng[:2], voxel_size=[0.8, 0.8])
    c["data"]["samples_per_gpu"] = 2
    c["data"]["train"]["max_points"] = 6000
    return c


def tiny_vn(cfg: dict) -> dict:
    c = json.loads(json.dumps(cfg))
    rng = [-35.2, -35.2, -2, 35.2, 35.2, 4]
    c["voxel_generator"].update(range=rng, max_voxel_num=[6000, 6000])
    c["model"]["neck"].update(layer_nums=[1, 1], ds_num_filters=[16, 32],
                              us_num_filters=[16, 16])
    c["test_cfg"].update(pc_range=rng[:2], post_center_limit_range=[-40, -40, -10, 40, 40, 10])
    c["data"]["samples_per_gpu"] = 2
    c["data"]["val"]["max_points"] = 6000
    return c


def make_copy(dest: Path) -> Path:
    """A copy of the benchmark's folder under ``dest`` with the tiny cells
    ``tiny_pp_train`` and ``tiny_vn_detect`` added as files; returns the copy."""
    base = dest / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for kind, src, fn, mode in (("pp", "waymo_pp_3x", tiny_pp, "train"),
                                ("vn", "waymo_voxelnet_3x", tiny_vn, "detect")):
        conf = json.loads((HERE / "configs" / f"{src}.json").read_text())
        conf["config"] = fn(conf["config"])
        (base / "configs" / f"tiny_{kind}.json").write_text(json.dumps(conf))
        (base / "traffic" / f"tiny_{mode}.json").write_text(
            json.dumps(_traffic(mode)))
        cell = json.loads((HERE / "workloads" / ("pp_train.json" if kind == "pp"
                                                 else "vn_detect.json")).read_text())
        cell.update(config=f"tiny_{kind}", traffic=f"tiny_{mode}")
        (base / "workloads" / f"tiny_{kind}_{mode}.json").write_text(json.dumps(cell))
    return base
