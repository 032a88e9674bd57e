"""Config-driven detector construction.

Port of ``tdal/models/builder.py``: ``build_voxel_config``, ``build_detector``
(PointPillars and VoxelNet, with the deformable head where ``bbox_head.dcn_head`` is
set), ``build_two_stage_engine`` (the first stage, the BEV extractor, the RoI head and
its target config from a ``TwoStageDetector`` model tree), ``build_assigner`` and
``build_test_cfg``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tdal_torch.core.targets import AssignerConfig
from tdal_torch.core.voxel import VoxelConfig
from tdal_torch.device import resolve_device
from tdal_torch.models.center_head import SepHead
from tdal_torch.models.dcn import DeformConv, FeatureAdaption
from tdal_torch.models.detectors import PointPillars, VoxelNet
from tdal_torch.models.layers import Conv3x3, FusedConvBN
from tdal_torch.models.scn_sparse import SparseMiddleBackbone
from tdal_torch.models.two_stage import BEVFeatureExtractor, RoIHead, RoiTargetConfig
from tdal_torch.pipeline.two_stage_engine import TwoStageEngine

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
    transposed-conv and dense weight lecun-normal over its fan-in (a masked SepHead
    conv's fan-in is its branch's block; a sparse conv's (K, Cin, Cout) weight has
    K * Cin; a deformable conv's (K*K*C, F) kernel K*K*C), the deformable head's offset
    convs zero, biases and BatchNorms as constructed (zero biases, the heatmap bias
    -2.19, unit scales, running stats 0 / 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SparseMiddleBackbone):
                for w in m.parameters(recurse=False):
                    _lecun_(w, w.shape[0] * w.shape[1], generator)
            elif isinstance(m, (nn.Conv2d, nn.Conv3d, FusedConvBN, Conv3x3)):
                w = m.weight
                _lecun_(w, w[0].numel(), generator)
            elif isinstance(m, nn.ConvTranspose2d):
                w = m.weight  # (cin, cout, s, s)
                _lecun_(w, w.shape[0] * w.shape[2] * w.shape[3], generator)
            elif isinstance(m, nn.Linear):
                _lecun_(m.weight, m.in_features, generator)
            elif isinstance(m, DeformConv):
                _lecun_(m.kernel, m.kernel.shape[0], generator)
            elif isinstance(m, SepHead):
                for name in m.masked_convs():
                    w, mask = getattr(m, f"{name}_weight"), getattr(m, f"{name}_mask")
                    _lecun_(w, int(mask[0].sum()), generator)  # fan-in of one branch's block
                    w.mul_(mask)
        for m in model.modules():
            if isinstance(m, FeatureAdaption):  # the offsets start at zero
                m.offset.weight.zero_()
    return model


def build_detector(cfg_model: dict, voxel_cfg: VoxelConfig, device=None, seed: int = 0):
    """cfg_model: the config's ``model`` dict -> a fresh ``PointPillars`` or
    ``VoxelNet`` on ``device`` (None means CUDA) initialised from
    ``torch.Generator().manual_seed(seed)``. ``model.dtype = 'bfloat16'`` runs the convs
    and activations in bf16 (f32 parameters and accumulation)."""
    if cfg_model["type"] not in ("PointPillars", "VoxelNet"):
        raise KeyError(f"unknown detector type {cfg_model['type']!r}")
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg_model.get("dtype") == "bfloat16" else torch.float32
    head = cfg_model["bbox_head"]
    neck = cfg_model.get("neck", {})
    reader = cfg_model["reader"]
    common = dict(
        tasks=[dict(num_class=t["num_class"], class_names=tuple(t["class_names"]))
               for t in head["tasks"]],
        num_input_features=int(reader.get("num_input_features", 5)),
        rpn_layer_nums=tuple(neck.get("layer_nums", (3, 5, 5))),
        rpn_ds_strides=tuple(neck.get("ds_layer_strides", (1, 2, 2))),
        rpn_ds_filters=tuple(neck.get("ds_num_filters", (64, 128, 256))),
        rpn_us_strides=tuple(neck.get("us_layer_strides", (1, 2, 4))),
        rpn_us_filters=tuple(neck.get("us_num_filters", (128, 128, 128))),
        with_velocity="vel" in head.get("common_heads", {}),
        dcn_head=bool(head.get("dcn_head", False)),
        dtype=dtype,
    )
    if cfg_model["type"] == "PointPillars":
        model = PointPillars(voxel_cfg, num_filters=tuple(reader.get("num_filters", (64, 64))),
                             **common)
    else:
        model = VoxelNet(voxel_cfg, **common)
    init_detector(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def init_roi_head(head: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh init of a ``RoIHead`` as flax initialises tdal's: the hidden Linears
    lecun-normal, the two output Linears normal(0, 0.001) with zero biases."""
    init_detector(head, generator)
    with torch.no_grad():
        for out in (head.cls_out, head.reg_out):
            out.weight.normal_(0.0, 0.001, generator=generator)
            out.bias.zero_()
    return head


def build_two_stage_engine(cfg_model: dict, voxel_cfg: VoxelConfig, test_cfg: dict,
                           device=None, seed: int = 0):
    """A ``TwoStageEngine`` on ``device`` (None means CUDA) from the config's
    ``TwoStageDetector`` model tree (reference two_stage.py:9-46): the first stage as
    ``build_detector`` builds it, the RoIHead (input width ``num_point`` times the
    first stage's BEV channels), the BEV extractor and the RoI target config; fresh
    weights from ``seed``."""
    dev = resolve_device(device)
    first = build_detector(cfg_model["first_stage_cfg"], voxel_cfg, device="cpu", seed=seed)
    mc = cfg_model["roi_head"]["model_cfg"]
    tc = mc["TARGET_CONFIG"]
    num_point = int(cfg_model.get("num_point", 5))
    roi_head = RoIHead(
        num_point * first.rpn.out_channels,
        shared_fc=tuple(mc["SHARED_FC"]), cls_fc=tuple(mc["CLS_FC"]),
        reg_fc=tuple(mc["REG_FC"]), code_size=int(cfg_model["roi_head"].get("code_size", 7)),
        dp_ratio=float(mc.get("DP_RATIO", 0.3)))
    init_roi_head(roi_head, torch.Generator().manual_seed(seed + 1))
    sec = cfg_model["second_stage_modules"][0]
    bev = BEVFeatureExtractor(pc_start=tuple(sec["pc_start"]),
                              voxel_size=tuple(sec["voxel_size"]),
                              out_stride=int(sec["out_stride"]))
    roi_cfg = RoiTargetConfig(
        roi_per_image=int(tc["ROI_PER_IMAGE"]), fg_ratio=float(tc["FG_RATIO"]),
        sample_roi_by_each_class=bool(tc.get("SAMPLE_ROI_BY_EACH_CLASS", True)),
        cls_score_type=str(tc.get("CLS_SCORE_TYPE", "roi_iou")),
        cls_fg_thresh=float(tc["CLS_FG_THRESH"]), cls_bg_thresh=float(tc["CLS_BG_THRESH"]),
        cls_bg_thresh_lo=float(tc["CLS_BG_THRESH_LO"]),
        hard_bg_ratio=float(tc["HARD_BG_RATIO"]), reg_fg_thresh=float(tc["REG_FG_THRESH"]))
    weights = mc.get("LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {})
    first_head = cfg_model["first_stage_cfg"]["bbox_head"]
    engine = TwoStageEngine(
        first, roi_head, test_cfg, bev, roi_cfg=roi_cfg, num_point=num_point,
        code_weights_first=tuple(first_head.get("code_weights", [1.0] * 8)),
        code_weights_roi=tuple(weights.get("code_weights", [1.0] * 7)),
        first_weight=float(first_head.get("weight", 2.0)),
        freeze_first=bool(cfg_model.get("freeze", False)))
    return engine.to(dev)


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
