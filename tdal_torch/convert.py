"""flax parameter and batch-stats trees -> the port's ``state_dict``s.

The trees are nested dicts of numpy arrays (the caller does any ``jax -> numpy``
step; nothing here sees a jax array). Dense ``kernel (in, out)`` becomes Linear
``weight (out, in)``; BatchNorm ``scale/bias`` + ``mean/var`` become
``weight/bias/running_mean/running_var``. flax's auto-names map to the port's
attribute paths through ``_CHILDREN``.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

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
            elif isinstance(child, nn.BatchNorm1d):
                stats = bs[name]
                out[key + "weight"] = _t(sub["scale"])
                out[key + "bias"] = _t(sub["bias"])
                out[key + "running_mean"] = _t(stats["mean"])
                out[key + "running_var"] = _t(stats["var"])
                out[key + "num_batches_tracked"] = torch.tensor(0)
            else:
                walk(child, sub, bs.get(name, {}), key)

    walk(model, params, batch_stats, "")
    return out


def load_flax(model: nn.Module, params: dict, batch_stats: dict | None = None) -> nn.Module:
    """Load flax trees into ``model`` (strict: every parameter must be covered)."""
    model.load_state_dict(flax_to_state_dict(model, params, batch_stats))
    return model
