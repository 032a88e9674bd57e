"""Train and eval steps of the static and dynamic auto-labelers.

Port of ``tdal/pipeline/labeler_engine.py``: the train step (train-mode forward with
batch statistics, the frustum loss, its backward, one optimizer step, and the loss
terms and metrics of the batch), the eval step (eval-mode forward: ``PointNetSeg`` on
a CUDA tensor runs K1 + K2), ``labeler_metrics`` and ``average_metrics``. The random
draws of a train step (gather noise, dropout mask) come from a ``torch.Generator`` on
the model's device that the caller seeds; every metric stays on the device until
``average_metrics`` reads it.

Under an active data-parallel mesh (``tdal_torch.parallel.mesh``) a step is given this
rank's rows of the batch (``shard_batch``); its loss terms and metrics are shares of the
global batch's (``partial_mean``), summed over the ranks (``sum_logs``), so every rank
returns the single-process step's values.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tdal_torch.core.iou import compute_box3d_iou
from tdal_torch.models.pointnet import train_draws
from tdal_torch.parallel.mesh import partial_mean, sum_logs
from tdal_torch.runtime.train_state import TrainState

LABEL_KEYS = (
    "mask_label",
    "center_label",
    "heading_class_label",
    "heading_residuals_label",
    "size_class_label",
    "size_residuals_label",
)


def _tensor(x, device):
    return torch.as_tensor(np.asarray(x), device=device)


def batch_labels(batch, device) -> dict:
    return {k: _tensor(batch[k], device) for k in LABEL_KEYS}


def batch_inputs(batch, inputs_fn: Callable, device) -> list:
    return [_tensor(x, device) for x in inputs_fn(batch)]


@torch.no_grad()
def labeler_metrics(output, labels) -> dict:
    """Seg accuracy, IoU 2D/3D and IoU3D accuracy at 0.7 and 0.5 of one batch (this
    rank's shares under a mesh), as device scalars. For the two-box model the heading
    labels come from the output (relative to box one), as in the reference
    (static_train.py:107-120)."""
    h_cls = output.get("heading_class_label_two", labels["heading_class_label"])
    h_res = output.get("heading_residuals_label_two", labels["heading_residuals_label"])
    iou2d, iou3d = compute_box3d_iou(
        output["center"], output["heading_scores"], output["heading_residuals"],
        output["size_scores"], output["size_residuals"], labels["center_label"], h_cls,
        h_res, labels["size_class_label"], labels["size_residuals_label"],
    )
    seg_correct = output["logits"].argmax(dim=2) == labels["mask_label"].long()
    return {
        "seg_acc": partial_mean(seg_correct.float()),
        "iou2d": partial_mean(iou2d),
        "iou3d": partial_mean(iou3d),
        "iou3d_acc_07": partial_mean((iou3d >= 0.7).float()),
        "iou3d_acc_05": partial_mean((iou3d >= 0.5).float()),
    }


def make_steps(model, loss_fn: Callable, inputs_fn: Callable):
    """(train_step, eval_step) of a labeler. ``inputs_fn(batch)`` gives the forward's
    positional inputs, ``loss_fn(output, labels)`` a dict with ``total_loss``.

    ``train_step(state, batch, generator)`` takes one optimizer step of ``state``
    (whose model is ``model``) on a host batch, with the random draws from
    ``generator``, and returns the batch's loss terms and metrics;
    ``eval_step(state, batch)`` returns (metrics, output) of the eval forward."""

    def train_step(state: TrainState, batch, generator: torch.Generator):
        device = next(model.parameters()).device
        inputs = batch_inputs(batch, inputs_fn, device)
        labels = batch_labels(batch, device)
        model.train()
        out = model(*inputs, **train_draws(inputs[0], generator))
        losses = loss_fn(out, labels)
        losses["total_loss"].backward()
        state.apply_gradients()
        return sum_logs({**{k: v.detach() for k, v in losses.items()},
                         **labeler_metrics(out, labels)})

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        device = next(model.parameters()).device
        model.eval()
        out = model(*batch_inputs(batch, inputs_fn, device))
        labels = batch_labels(batch, device)
        return sum_logs({**loss_fn(out, labels), **labeler_metrics(out, labels)}), out

    return train_step, eval_step


def average_metrics(metric_list) -> dict:
    """Host-side mean of a list of metric dicts (one read of the device)."""
    if not metric_list:
        return {}
    keys = list(metric_list[0])
    stacked = torch.stack([torch.stack([m[k].float() for k in keys]) for m in metric_list])
    means = stacked.mean(dim=0).cpu().tolist()
    return dict(zip(keys, means))
