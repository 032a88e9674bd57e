"""Config-driven detector construction.

Port of ``tdal/models/builder.py`` for the PointPillars detector
(``build_voxel_config``, ``build_detector``, ``build_assigner``, ``build_test_cfg``).
VoxelNet and the two-stage engine arrive with their slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tdal_torch.core.targets import AssignerConfig
from tdal_torch.core.voxel import VoxelConfig
from tdal_torch.device import resolve_device
from tdal_torch.models.center_head import SepHead
from tdal_torch.models.detectors import PointPillars
from tdal_torch.models.layers import Conv3x3, FusedConvBN

# flax's lecun_normal: a normal truncated at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def build_voxel_config(cfg_vox: dict, train: bool = True) -> VoxelConfig:
    max_num = cfg_vox["max_voxel_num"]
    if isinstance(max_num, (list, tuple)):
        max_num = max_num[0] if train else max_num[1]
    return VoxelConfig(
        point_cloud_range=tuple(cfg_vox["range"]),
        voxel_size=tuple(cfg_vox["voxel_size"]),
        max_points_per_voxel=int(cfg_vox["max_points_in_voxel"]),
        max_voxels=int(max_num),
    )


def _lecun_(w, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def init_detector(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh init from ``generator``, as flax initialises tdal's detector: every conv,
    transposed-conv and dense weight lecun-normal over its fan-in (the masked SepHead
    conv's fan-in is its branch's block), biases and BatchNorms as constructed (zero
    biases, the heatmap bias -2.19, unit scales, running stats 0 / 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, FusedConvBN, Conv3x3)):
                w = m.weight
                _lecun_(w, w[0].numel(), generator)
            elif isinstance(m, nn.ConvTranspose2d):
                w = m.weight  # (cin, cout, s, s)
                _lecun_(w, w.shape[0] * w.shape[2] * w.shape[3], generator)
            elif isinstance(m, nn.Linear):
                _lecun_(m.weight, m.in_features, generator)
            elif isinstance(m, SepHead):
                w, mask = m.final_conv_weight, m.final_conv_mask
                _lecun_(w, int(mask[0].sum()), generator)  # fan-in of one branch's block
                w.mul_(mask)
    return model


def build_detector(cfg_model: dict, voxel_cfg: VoxelConfig, device=None, seed: int = 0):
    """cfg_model: the config's ``model`` dict -> a fresh ``PointPillars`` on ``device``
    (None means CUDA) initialised from ``torch.Generator().manual_seed(seed)``.
    ``model.dtype = 'bfloat16'`` runs the convs and activations in bf16 (f32 parameters
    and accumulation)."""
    if cfg_model["type"] != "PointPillars":
        raise KeyError(f"tdal_torch builds PointPillars only, not {cfg_model['type']!r}")
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg_model.get("dtype") == "bfloat16" else torch.float32
    head = cfg_model["bbox_head"]
    if head.get("dcn_head", False):
        raise NotImplementedError("tdal_torch: the deformable head is not ported yet")
    neck = cfg_model.get("neck", {})
    reader = cfg_model["reader"]
    model = PointPillars(
        voxel_cfg,
        tasks=[dict(num_class=t["num_class"], class_names=tuple(t["class_names"]))
               for t in head["tasks"]],
        num_input_features=int(reader.get("num_input_features", 5)),
        num_filters=tuple(reader.get("num_filters", (64, 64))),
        rpn_layer_nums=tuple(neck.get("layer_nums", (3, 5, 5))),
        rpn_ds_strides=tuple(neck.get("ds_layer_strides", (1, 2, 2))),
        rpn_ds_filters=tuple(neck.get("ds_num_filters", (64, 128, 256))),
        rpn_us_strides=tuple(neck.get("us_layer_strides", (1, 2, 4))),
        rpn_us_filters=tuple(neck.get("us_num_filters", (128, 128, 128))),
        with_velocity="vel" in head.get("common_heads", {}),
        dtype=dtype,
    )
    init_detector(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def build_assigner(cfg_assigner: dict, detector) -> AssignerConfig:
    return AssignerConfig(
        tasks=[
            dict(num_class=len(t["class_names"]), class_names=list(t["class_names"]))
            for t in detector.tasks
        ],
        out_size_factor=int(cfg_assigner.get("out_size_factor", detector.out_size_factor)),
        gaussian_overlap=float(cfg_assigner.get("gaussian_overlap", 0.1)),
        max_objs=int(cfg_assigner.get("max_objs", 500)),
        min_radius=int(cfg_assigner.get("min_radius", 2)),
    )


def build_test_cfg(cfg_test: dict, detector, voxel_cfg: VoxelConfig) -> dict:
    return dict(
        post_center_limit_range=list(cfg_test["post_center_limit_range"]),
        nms=dict(cfg_test["nms"]),
        score_threshold=float(cfg_test["score_threshold"]),
        pc_range=list(cfg_test.get("pc_range", voxel_cfg.point_cloud_range[:2])),
        out_size_factor=int(cfg_test.get("out_size_factor", detector.out_size_factor)),
        voxel_size=list(cfg_test.get("voxel_size", voxel_cfg.voxel_size[:2])),
    )
