"""tdal_torch stands alone and never falls back to the CPU.

- Importing every tdal_torch submodule (in a fresh interpreter) loads no jax, flax,
  optax, tdal, orbax, tensorstore, zstandard, zarr or numcodecs module and builds no
  kernel.
- No source of tdal_torch, nor chip_smoke.py, imports one (AST scan).
- Without a card, the entry points refuse the default device (CUDA) instead of
  running on the CPU; ``dist_test`` too, with and without ``--spatial_shards``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tdal_torch.device import resolve_device
from tdal_torch.pipeline import factories, labeler_run, track_extraction

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
import tdal_torch
for m in pkgutil.walk_packages(tdal_torch.__path__, "tdal_torch."):
    importlib.import_module(m.name)
from tdal_torch.ops.build import kernels
print(kernels.cache_info().currsize)
print(" ".join(sorted(sys.modules)))
"""


def _forbidden(module: str) -> bool:
    """jax*, flax*, optax, tdal or tdal.* (tdal_torch is the port itself), and the
    checkpoint stack that the port's orbax reader replaces: orbax, tensorstore,
    zstandard, zarr and numcodecs."""
    top = module.split(".")[0]
    return top.startswith(("jax", "flax")) or top in (
        "optax", "tdal", "orbax", "tensorstore", "zstandard", "zarr", "numcodecs")


def test_importing_the_port_loads_no_reference_module():
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    n_built, modules = res.stdout.strip().splitlines()
    assert n_built == "0"  # importing builds nothing
    loaded = modules.split()
    for name in ("tdal_torch.pipeline.labeler_run", "tdal_torch.ops.sparse_conv",
                 "tdal_torch.models.scn_sparse", "tdal_torch.models.scn",
                 "tdal_torch.models.two_stage", "tdal_torch.pipeline.two_stage_engine",
                 "tdal_torch.pipeline.two_stage_run", "tdal_torch.parallel.mesh",
                 "tdal_torch.parallel.controls", "tdal_torch.tools.dist_test"):
        assert name in loaded, name
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize(
    "path", sorted(ROOT.glob("tdal_torch/**/*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_imports_a_reference_module(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_default_device_is_cuda_and_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_refuse_the_cpu_unless_asked(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        factories.make_labeler("one_box_est")
    model, _, inputs_fn, kind = factories.make_labeler("one_box_est", device="cpu")
    dataset = [{"pts": np.zeros((16, 3), np.float32), "init_box": np.zeros(7, np.float32),
                "bbox_gt": np.zeros(7, np.float32)}]
    with pytest.raises(RuntimeError, match="CUDA"):
        labeler_run.predict_final_boxes(model, dataset, inputs_fn, kind, batch_size=2)
    boxes = labeler_run.predict_final_boxes(model, dataset, inputs_fn, kind, batch_size=2,
                                            device="cpu")
    assert boxes.shape == (1, 7) and np.isfinite(boxes).all()
    with pytest.raises(RuntimeError, match="CUDA"):
        track_extraction.create_pd_detection({}, {}, tmp_path, tracking=True)


# the two-sweep velocity config with the deformable head switched on (no shipped config
# sets ``dcn_head``)
DCN_CONFIG = "configs/waymo/voxelnet/waymo_centerpoint_voxelnet_two_sweeps_3x_with_velo.py"


@pytest.mark.parametrize("config", [
    "configs/waymo/voxelnet/waymo_centerpoint_voxelnet_3x.py",
    "configs/waymo/voxelnet/two_stage/"
    "waymo_centerpoint_voxelnet_two_stage_bev_5point_ft_6epoch_freeze.py",
    DCN_CONFIG])
def test_voxelnet_and_two_stage_builders_refuse_the_cpu_unless_asked(no_card, config):
    from tdal_torch.models.builder import (
        build_detector, build_test_cfg, build_two_stage_engine, build_voxel_config,
    )
    from tdal_torch.runtime.config import Config

    cfg = Config.fromfile(ROOT / config)
    vox = build_voxel_config(cfg.voxel_generator)
    if cfg.model["type"] == "TwoStageDetector":
        first = build_detector(cfg.model["first_stage_cfg"], vox, device="cpu")
        test_cfg = build_test_cfg(cfg.test_cfg, first, vox)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_two_stage_engine(cfg.model, vox, test_cfg)
    else:
        model = dict(cfg.model, bbox_head=dict(cfg.model["bbox_head"],
                                               dcn_head=config == DCN_CONFIG))
        with pytest.raises(RuntimeError, match="CUDA"):
            build_detector(model, vox)
        if config == DCN_CONFIG:
            det = build_detector(model, vox, device="cpu")
            assert det.head.dcn_head and next(det.parameters()).device.type == "cpu"



def test_dist_test_defaults_to_the_card(no_card, tmp_path):
    """``dist_test`` without ``--device`` runs on the card: without one it refuses, on one
    process and with ``--spatial_shards`` (which counts the cards first)."""
    from tdal_torch.tools import dist_test

    args = ["configs/synthetic/pp_tiny.py", "--work_dir", str(tmp_path), "--checkpoint",
            str(tmp_path / "none.pt"), "--info_path", str(tmp_path / "none.pkl")]
    with pytest.raises(RuntimeError, match="CUDA"):
        dist_test.main([str(ROOT / args[0]), *args[1:]])
    with pytest.raises(RuntimeError, match="needs 2 cards; this machine has 0"):
        dist_test.main([str(ROOT / args[0]), *args[1:], "--spatial_shards", "2"])
