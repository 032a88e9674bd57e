"""flax parameter and batch-stats trees -> the port's ``state_dict``s.

The trees are nested dicts of numpy arrays (the caller does any ``jax -> numpy``
step; nothing here sees a jax array). Dense ``kernel (in, out)`` becomes Linear
``weight (out, in)``; BatchNorm ``scale/bias`` + ``mean/var`` become
``weight/bias/running_mean/running_var``. For the labelers flax's auto-names map to
the port's attribute paths through ``_CHILDREN``; the PointPillars detector has its
own walk (``pointpillars_state_dict``): conv ``kernel`` HWIO becomes OIHW, the flax
``ConvTranspose`` kernel (which flax applies spatially flipped) becomes the
``ConvTranspose2d`` weight (Ci, Co, s, s), and ``FusedConvBN``'s ``kernel,
conv_bias, scale, bias`` + ``mean, var`` keep their names on the port's module.
The head's walk covers every SepHead depth (``sep_head_state_dict``) and the
deformable head (``dcn_sep_head_state_dict``). VoxelNet (``voxelnet_state_dict``)
shares the RPN and head walk; its sparse backbone's
(K, Cin, Cout) weights map one to one, its dense backbone's 3D conv kernels (kd, kh, kw,
Ci, Co) become (Co, Ci, kd, kh, kw). ``two_stage_state_dict`` adds the RoI head.
``load_tdal_checkpoint`` reads a checkpoint directory that tdal wrote (without orbax:
``tdal_torch.runtime.orbax_format``) and loads it through these converters.
"""

from __future__ import annotations

import itertools
import re

import numpy as np
import torch
from torch import nn

from tdal_torch.models.layers import BatchNorm

# flax child scope -> port attribute, per port module class
_CHILDREN = {
    "PointNetSeg": {"SharedMLP_0": "enc1", "SharedMLP_1": "enc2", "SharedMLP_2": "dec",
                    "Dense_0": "logits"},
    "PointNetBoxEst": {"SharedMLP_0": "mlp", "DenseBNStack_0": "fc", "Dense_0": "out"},
    "StaticLabelerOneBox": {"PointNetSeg_0": "seg", "PointNetBoxEst_0": "box_est"},
    "StaticLabelerTwoBox": {"PointNetSeg_0": "seg", "PointNetBoxEst_0": "box_est_one",
                            "PointNetBoxEst_1": "box_est_two"},
    "PointEmbedding": {"SharedMLP_0": "mlp", "DenseBNStack_0": "fc"},
    "BoxEmbedding": {"SharedMLP_0": "mlp", "DenseBNStack_0": "fc"},
    "EmbeddingBoxHead": {"DenseBNStack_0": "fc", "Dense_0": "out"},
    "DynamicLabeler": {"PointNetSeg_0": "seg", "PointEmbedding_0": "point_emb",
                       "BoxEmbedding_0": "box_emb", "EmbeddingBoxHead_0": "head"},
}
_STACK = re.compile(r"(Dense|BatchNorm)_(\d+)$")


def _attr(module: nn.Module, flax_name: str) -> str:
    table = _CHILDREN.get(type(module).__name__)
    if table is not None:
        return table[flax_name]
    m = _STACK.match(flax_name)  # SharedMLP / DenseBNStack: Dense_i, BatchNorm_i
    if m is None:
        raise KeyError(f"{type(module).__name__}: no counterpart for flax {flax_name!r}")
    return f"{'dense' if m.group(1) == 'Dense' else 'bn'}.{m.group(2)}"


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a bfloat16 leaf of a tdal checkpoint
        return a.float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def flax_to_state_dict(model: nn.Module, params: dict, batch_stats: dict | None = None) -> dict:
    """``state_dict`` for ``model`` from flax ``params`` / ``batch_stats`` trees."""
    out: dict = {}
    batch_stats = batch_stats or {}

    def walk(module, p, bs, prefix):
        for name, sub in p.items():
            path = _attr(module, name)
            child = module.get_submodule(path)
            key = f"{prefix}{path}."
            if isinstance(child, nn.Linear):
                out[key + "weight"] = _t(sub["kernel"]).t().contiguous()
                out[key + "bias"] = _t(sub["bias"])
            elif isinstance(child, BatchNorm):
                _bn(out, key, sub, bs[name])
            else:
                walk(child, sub, bs.get(name, {}), key)

    walk(model, params, batch_stats, "")
    return out


def load_flax(model: nn.Module, params: dict, batch_stats: dict | None = None) -> nn.Module:
    """Load flax trees into ``model`` (strict: every parameter must be covered)."""
    model.load_state_dict(flax_to_state_dict(model, params, batch_stats))
    return model


# ---------------------------------------------------------------------------
# PointPillars detector
# ---------------------------------------------------------------------------


def _conv(kernel) -> torch.Tensor:
    """flax conv kernel (kh, kw, Ci, Co) -> torch (Co, Ci, kh, kw)."""
    return _t(kernel).permute(3, 2, 0, 1).contiguous()


def _deconv(kernel) -> torch.Tensor:
    """flax ConvTranspose kernel (s, s, Ci, Co), applied flipped (output offset (u, v)
    reads kernel[s-1-u, s-1-v]) -> torch ConvTranspose2d weight (Ci, Co, s, s)."""
    return _t(kernel).flip(0, 1).permute(2, 3, 0, 1).contiguous()


def _bn(out, prefix, p, stats):
    out[prefix + "weight"] = _t(p["scale"])
    out[prefix + "bias"] = _t(p["bias"])
    out[prefix + "running_mean"] = _t(stats["mean"])
    out[prefix + "running_var"] = _t(stats["var"])


def _fused(out, prefix, p, stats):
    out[prefix + "weight"] = _conv(p["kernel"])
    if "conv_bias" in p:
        out[prefix + "conv_bias"] = _t(p["conv_bias"])
    out[prefix + "scale"] = _t(p["scale"])
    out[prefix + "bias"] = _t(p["bias"])
    out[prefix + "running_mean"] = _t(stats["mean"])
    out[prefix + "running_var"] = _t(stats["var"])


def _rpn_and_head(out: dict, model: nn.Module, params: dict, batch_stats: dict,
                  prefix: str = ""):
    p, bs = params["RPN_0"], batch_stats["RPN_0"]
    k = 0
    for i, block in enumerate(model.rpn.blocks):
        for j, layer in enumerate(block):
            name, pre = f"ConvBNReLU_{k}", f"{prefix}rpn.blocks.{i}.{j}."
            k += 1
            if layer.fused is not None:
                _fused(out, pre + "fused.", p[name]["FusedConvBN_0"],
                       bs[name]["FusedConvBN_0"])
            elif "Conv_0" in p[name]:
                out[pre + "conv.weight"] = _conv(p[name]["Conv_0"]["kernel"])
                _bn(out, pre + "bn.", p[name]["BatchNorm_0"], bs[name]["BatchNorm_0"])
            else:
                # migrate_legacy_conv_params names every 3x3 Conv_0 + BatchNorm_0 pair
                # FusedConvBN_0, the strided ones too
                f = p[name]["FusedConvBN_0"]
                out[pre + "conv.weight"] = _conv(f["kernel"])
                _bn(out, pre + "bn.", f, bs[name]["FusedConvBN_0"])
    for j in range(len(model.rpn.deblocks)):
        name, pre = f"DeconvBNReLU_{j}", f"{prefix}rpn.deblocks.{j}."
        d = p[name]
        out[pre + "conv.weight"] = (_deconv(d["ConvTranspose_0"]["kernel"])
                                    if "ConvTranspose_0" in d else _conv(d["Conv_0"]["kernel"]))
        _bn(out, pre + "bn.", d["BatchNorm_0"], bs[name]["BatchNorm_0"])

    p, bs = params["CenterHead_0"], batch_stats["CenterHead_0"]
    _fused(out, f"{prefix}head.shared.", p["FusedConvBN_0"], bs["FusedConvBN_0"])
    for t, task in enumerate(model.head.tasks):
        pre = f"{prefix}head.tasks.{t}."
        if model.head.dcn_head:
            out.update(dcn_sep_head_state_dict(task, p[f"DCNSepHead_{t}"],
                                               bs[f"DCNSepHead_{t}"], pre))
        else:
            out.update(sep_head_state_dict(task, p[f"SepHead_{t}"], bs[f"SepHead_{t}"], pre))


def _conv_and_bias(out, key, p):
    out[key + "weight"] = _conv(p["kernel"])
    out[key + "bias"] = _t(p["bias"])


def sep_head_state_dict(sep: nn.Module, params: dict, batch_stats: dict,
                        prefix: str = "") -> dict:
    """``state_dict`` of a ``tdal_torch.models.center_head.SepHead`` from tdal's
    SepHead trees, at any depth: the fused branches' ``branch_convbn0`` (FusedConvBN),
    ``branch_bn{d}``, the masked ``branch_conv{d}_kernel`` / ``_bias`` and
    ``final_conv_kernel`` / ``_bias`` (or the dense ``final_conv`` at depth 1);
    independent branches' ``Conv_i`` / ``BatchNorm_j`` in creation order."""
    out: dict = {}
    if not sep.fused:
        convs, bns = itertools.count(), itertools.count()
        for i, branch in enumerate(sep.branches):
            key = f"{prefix}branches.{i}."
            for j in range(len(branch.convs)):
                _conv_and_bias(out, f"{key}convs.{j}.", params[f"Conv_{next(convs)}"])
                if j < len(branch.bns):
                    b = f"BatchNorm_{next(bns)}"
                    _bn(out, f"{key}bns.{j}.", params[b], batch_stats[b])
        return out
    if "branch_convbn0" in params:
        _fused(out, prefix + "branch_convbn0.", params["branch_convbn0"],
               batch_stats["branch_convbn0"])
    for d in range(1, sep.depth - 1):
        _bn(out, f"{prefix}branch_bn{d}.", params[f"branch_bn{d}"],
            batch_stats[f"branch_bn{d}"])
    for name in sep.masked_convs():
        out[f"{prefix}{name}_weight"] = _conv(params[f"{name}_kernel"])
        out[f"{prefix}{name}_bias"] = _t(params[f"{name}_bias"])
    if sep.depth == 1:
        _conv_and_bias(out, prefix + "final_conv.", params["final_conv"])
    return out


def dcn_sep_head_state_dict(head: nn.Module, params: dict, batch_stats: dict,
                            prefix: str = "") -> dict:
    """``state_dict`` of a ``tdal_torch.models.dcn.DCNSepHead`` from tdal's
    DCNSepHead trees: ``FeatureAdaption_{0,1}`` (its ``Conv_0`` the offset conv, its
    ``DeformConv_0/kernel`` kept (K*K*C, F)), ``Conv_0`` / ``BatchNorm_0`` / ``Conv_1``
    the heatmap branch, ``SepHead_0`` the regression heads."""
    out: dict = {}
    for i, name in enumerate(("center_adapt", "reg_adapt")):
        fa = params[f"FeatureAdaption_{i}"]
        _conv_and_bias(out, f"{prefix}{name}.offset.", fa["Conv_0"])
        out[f"{prefix}{name}.deform.kernel"] = _t(fa["DeformConv_0"]["kernel"])
    _conv_and_bias(out, prefix + "cls_conv.", params["Conv_0"])
    _bn(out, prefix + "cls_bn.", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    _conv_and_bias(out, prefix + "hm_conv.", params["Conv_1"])
    out.update(sep_head_state_dict(head.reg, params["SepHead_0"], batch_stats["SepHead_0"],
                                   prefix + "reg."))
    return out


def pointpillars_state_dict(model: nn.Module, params: dict, batch_stats: dict,
                            prefix: str = "") -> dict:
    """``state_dict`` of a ``tdal_torch.models.detectors.PointPillars`` from the flax
    trees of ``tdal.models.detectors.PointPillars`` (keys under ``prefix``)."""
    out: dict = {}
    p, bs = params["PillarFeatureNet_0"], batch_stats["PillarFeatureNet_0"]
    for i in range(len(model.reader.pfn_layers)):
        name, pre = f"PFNLayer_{i}", f"{prefix}reader.pfn_layers.{i}."
        out[pre + "linear.weight"] = _t(p[name]["Dense_0"]["kernel"]).t().contiguous()
        _bn(out, pre + "norm.", p[name]["MaskedBatchNorm_0"], bs[name]["MaskedBatchNorm_0"])
    _rpn_and_head(out, model, params, batch_stats, prefix)
    return out


def load_flax_pointpillars(model: nn.Module, params: dict, batch_stats: dict) -> nn.Module:
    """Load tdal's PointPillars trees into ``model`` (strict)."""
    model.load_state_dict(pointpillars_state_dict(model, params, batch_stats))
    return model


# ---------------------------------------------------------------------------
# VoxelNet and the two-stage detector
# ---------------------------------------------------------------------------


def _conv3d(kernel) -> torch.Tensor:
    """flax 3D conv kernel (kd, kh, kw, Ci, Co) -> torch (Co, Ci, kd, kh, kw)."""
    return _t(kernel).permute(4, 3, 0, 1, 2).contiguous()


def sparse_backbone_state_dict(params: dict, batch_stats: dict, prefix: str = "") -> dict:
    """``state_dict`` of a ``SparseMiddleBackbone`` from tdal's: the (K, Cin, Cout)
    weights keep their names, ``MaskedBatchNorm_k`` becomes ``norms.k``."""
    out: dict = {}
    for name, w in params.items():
        if name.startswith("MaskedBatchNorm_"):
            _bn(out, f"{prefix}norms.{name.split('_')[-1]}.", w, batch_stats[name])
        else:
            out[prefix + name] = _t(w)
    return out


def dense_backbone_state_dict(backbone: nn.Module, params: dict, batch_stats: dict,
                              prefix: str = "") -> dict:
    """``state_dict`` of a dense ``MiddleBackbone`` from tdal's: its
    ``Conv3DBNReLU_i`` / ``BasicBlock3D_j`` in forward order are ``layers``."""
    out: dict = {}

    def conv_bn(key, cp, cbs):
        out[key + "conv.weight"] = _conv3d(cp["Conv_0"]["kernel"])
        _bn(out, key + "bn.", cp["BatchNorm_0"], cbs["BatchNorm_0"])

    counts = {"Conv3DBNReLU": 0, "BasicBlock3D": 0}
    for i, layer in enumerate(backbone.layers):
        kind = type(layer).__name__
        name = f"{kind}_{counts[kind]}"
        counts[kind] += 1
        key = f"{prefix}layers.{i}."
        if kind == "BasicBlock3D":
            conv_bn(key + "conv_bn_relu.", params[name]["Conv3DBNReLU_0"],
                    batch_stats[name]["Conv3DBNReLU_0"])
        conv_bn(key, params[name], batch_stats[name])
    return out


def voxelnet_state_dict(model: nn.Module, params: dict, batch_stats: dict,
                        prefix: str = "") -> dict:
    """``state_dict`` of a ``tdal_torch.models.detectors.VoxelNet`` from the flax trees
    of ``tdal.models.detectors.VoxelNet`` (sparse or dense backbone; keys under
    ``prefix``)."""
    from tdal_torch.models.scn_sparse import SparseMiddleBackbone

    pre = f"{prefix}backbone."
    if isinstance(model.backbone, SparseMiddleBackbone):
        name = "SparseMiddleBackbone_0"
        out = sparse_backbone_state_dict(params[name], batch_stats[name], pre)
    else:
        name = "MiddleBackbone_0"
        out = dense_backbone_state_dict(model.backbone, params[name], batch_stats[name], pre)
    _rpn_and_head(out, model, params, batch_stats, prefix)
    return out


def load_flax_voxelnet(model: nn.Module, params: dict, batch_stats: dict) -> nn.Module:
    """Load tdal's VoxelNet trees into ``model`` (strict)."""
    model.load_state_dict(voxelnet_state_dict(model, params, batch_stats))
    return model


def roi_head_state_dict(head: nn.Module, params: dict, batch_stats: dict,
                        prefix: str = "") -> dict:
    """``state_dict`` of a ``tdal_torch.models.two_stage.RoIHead`` from tdal's RoIHead
    trees: its ``Dense_i`` / ``BatchNorm_j`` in creation order are the shared layers,
    the cls branch and its output Linear, then the reg branch and its output."""
    out: dict = {}
    dense, bn = itertools.count(), itertools.count()
    for stack, final in (("shared", None), ("cls_layers", "cls_out"),
                         ("reg_layers", "reg_out")):
        for i in range(len(getattr(head, stack))):
            key = f"{prefix}{stack}.{i}."
            out[key + "linear.weight"] = _t(params[f"Dense_{next(dense)}"]["kernel"]).t().contiguous()
            b = f"BatchNorm_{next(bn)}"
            _bn(out, key + "bn.", params[b], batch_stats[b])
        if final is not None:
            d = params[f"Dense_{next(dense)}"]
            out[f"{prefix}{final}.weight"] = _t(d["kernel"]).t().contiguous()
            out[f"{prefix}{final}.bias"] = _t(d["bias"])
    return out


def load_flax_two_stage(engine: nn.Module, params: dict, batch_stats: dict) -> nn.Module:
    """Load tdal's two-stage trees (``{"first": ..., "roi": ...}`` for params and for
    batch_stats, as ``TwoStageEngine.init`` returns them) into a ``TwoStageEngine``
    (strict)."""
    from tdal_torch.models.detectors import VoxelNet

    first = (voxelnet_state_dict if isinstance(engine.first, VoxelNet)
             else pointpillars_state_dict)
    sd = first(engine.first, params["first"], batch_stats["first"], prefix="first.")
    sd.update(roi_head_state_dict(engine.roi_head, params["roi"], batch_stats["roi"],
                                  prefix="roi_head."))
    engine.load_state_dict(sd)
    return engine


# ---------------------------------------------------------------------------
# tdal's checkpoints
# ---------------------------------------------------------------------------


def load_tdal_checkpoint(model: nn.Module, path, step=None, prefer_best: bool = False) -> dict:
    """Load the checkpoint that tdal's ``CheckpointManager`` wrote under ``path`` (a
    manager's directory or one step directory; ``restore_tdal`` picks the step) into
    ``model``, on its device: its ``params`` / ``batch_stats`` tree through
    ``migrate_legacy_conv_params``, then the strict converter of the model's kind (a
    tree that does not fit raises). Returns the checkpoint's meta."""
    from tdal_torch.runtime.checkpoint import migrate_legacy_conv_params, restore_tdal

    tree, meta = restore_tdal(path, step, prefer_best=prefer_best)
    tree = migrate_legacy_conv_params(tree)
    loader = {"PointPillars": load_flax_pointpillars, "VoxelNet": load_flax_voxelnet,
              "TwoStageEngine": load_flax_two_stage}.get(type(model).__name__, load_flax)
    loader(model, tree["params"], tree.get("batch_stats", {}))
    return meta
