"""Factories of the labeler stages: port of ``tdal/pipeline/factories.py``
(``make_labeler``, ``load_track_data``, ``restore_labeler_state``)."""

from __future__ import annotations

import math
import pickle
from pathlib import Path

import torch
from torch import nn

from tdal_torch.device import resolve_device
from tdal_torch.models.dynamic_labeler import DynamicLabeler, dynamic_loss
from tdal_torch.models.layers import BatchNorm
from tdal_torch.models.pointnet import PointNetSeg
from tdal_torch.models.static_labeler import (
    StaticLabelerOneBox, StaticLabelerTwoBox, frustum_loss_one_box, frustum_loss_two_box,
)
from tdal_torch.convert import load_tdal_checkpoint
from tdal_torch.runtime.checkpoint import CheckpointManager, is_tdal_checkpoint

_MODELS = {
    "one_box_est": (StaticLabelerOneBox, frustum_loss_one_box, ("pts", "init_box", "bbox_gt"),
                    "static_one"),
    "two_box_est": (StaticLabelerTwoBox, frustum_loss_two_box, ("pts", "init_box", "bbox_gt"),
                    "static_two"),
    "dynamic": (DynamicLabeler, dynamic_loss, ("pts", "boxes", "bbox_gt"), "dynamic"),
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
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model.eval()


def make_labeler(model_type: str, n_object_points: int | None = None, device=None,
                 seed: int = 0):
    """model_type in {'one_box_est', 'two_box_est', 'dynamic'} ->
    (model on ``device`` in eval mode, fresh-init from a ``torch.Generator`` seeded
    with ``seed``; loss_fn(output, labels); inputs_fn(batch) -> the forward's
    arguments; decode kind)."""
    if model_type not in _MODELS:
        raise ValueError(f"unknown model_type {model_type!r}")
    dev = resolve_device(device)
    cls, loss_fn, keys, kind = _MODELS[model_type]
    model = cls(**({"n_object_points": n_object_points} if n_object_points else {}))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), loss_fn, (lambda b: tuple(b[k] for k in keys)), kind


def load_track_data(path, split: int = 16, prefix: str | None = None) -> dict:
    """A track dict from one pickle, or merged from the ``{prefix}_{i}.pkl`` shards of
    a directory (the reference's 16-way train sharding, static_train.py:192-198)."""
    p = Path(path)
    if p.is_file():
        with open(p, "rb") as f:
            return pickle.load(f)
    if prefix is None:
        raise ValueError("load_track_data: a shard directory needs its prefix")
    track: dict = {}
    for i in range(split):
        shard = p / f"{prefix}_{i}.pkl"
        if shard.exists():
            with open(shard, "rb") as f:
                track.update(pickle.load(f))
    return track


def restore_labeler_state(model: nn.Module, ckpt_dir, prefer_best: bool = True):
    """Load the best (or, with ``prefer_best`` False or no best marker, the latest)
    checkpoint that ``train_labeler`` saved under ``ckpt_dir`` into ``model``, on its
    device: (model in eval mode, the checkpoint's meta). A directory that ``tdal``'s
    labeler training wrote is read and converted (``load_tdal_checkpoint``), with the
    same choice of step."""
    if is_tdal_checkpoint(ckpt_dir):
        meta = load_tdal_checkpoint(model, ckpt_dir, prefer_best=prefer_best)
        return model.eval(), meta
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.best_step() if prefer_best else None
    state, meta = mgr.restore(step)
    model.load_state_dict(state["model"])
    return model.eval(), meta
