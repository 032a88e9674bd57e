"""Labeler factory (port of ``tdal/pipeline/factories.py:make_labeler``)."""

from __future__ import annotations

import math

import torch
from torch import nn

from tdal_torch.device import resolve_device
from tdal_torch.models.dynamic_labeler import DynamicLabeler
from tdal_torch.models.pointnet import PointNetSeg
from tdal_torch.models.static_labeler import StaticLabelerOneBox, StaticLabelerTwoBox

_MODELS = {
    "one_box_est": (StaticLabelerOneBox, ("pts", "init_box", "bbox_gt"), "static_one"),
    "two_box_est": (StaticLabelerTwoBox, ("pts", "init_box", "bbox_gt"), "static_two"),
    "dynamic": (DynamicLabeler, ("pts", "boxes", "bbox_gt"), "dynamic"),
}


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh init from ``generator``: every Linear's weight and bias uniform in
    +-1/sqrt(fan_in) (torch's default bounds); BatchNorms keep unit scale, zero
    shift and running stats 0/1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
    return model


def random_pointnet_seg(cin: int, seed: int) -> PointNetSeg:
    """A ``PointNetSeg`` on the CPU in eval mode with seeded weights and seeded
    BatchNorm affine and running stats, so that folding BN has work to do."""
    g = torch.Generator().manual_seed(seed)
    model = init_weights(PointNetSeg(cin), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm1d):
                n = m.num_features
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model.eval()


def make_labeler(model_type: str, n_object_points: int | None = None, device=None,
                 seed: int = 0):
    """model_type in {'one_box_est', 'two_box_est', 'dynamic'} ->
    (model on ``device`` in eval mode, fresh-init from a ``torch.Generator`` seeded
    with ``seed``; inputs_fn(batch) -> the forward's arguments; decode kind).

    The loss functions of tdal's factory arrive with the training slice."""
    if model_type not in _MODELS:
        raise ValueError(f"unknown model_type {model_type!r}")
    dev = resolve_device(device)
    cls, keys, kind = _MODELS[model_type]
    model = cls(**({"n_object_points": n_object_points} if n_object_points else {}))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), (lambda b: tuple(b[k] for k in keys)), kind
