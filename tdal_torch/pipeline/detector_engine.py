"""Detector train and predict steps for CenterPoint models.

Port of ``tdal/pipeline/detector_engine.py``: the train step of
``make_detector_steps`` (the forward in train mode, BatchNorm running statistics
updated in place, the CenterHead loss, the backward, one optimizer step), its predict
step (``make_predict_step``: the eval forward, decode and NMS), the double-flip predict
step (``make_tta_predict_step``) and ``predictions_to_host``. Under an active
data-parallel mesh the train step is given this rank's rows of the batch; its BatchNorm
statistics and loss normalizers are global (``models/layers.py``,
``models/center_head.py``), and its logs are summed over the ranks.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tdal_torch.models.center_head import center_head_loss, predict
from tdal_torch.models.tta import average_double_flip_preds
from tdal_torch.parallel.mesh import sum_logs
from tdal_torch.runtime.train_state import TrainState

TARGET_KEYS = ("hm", "anno_box", "ind", "mask", "cat")


def batch_to_device(batch: dict, device) -> dict:
    """Collated numpy batch -> tensors on ``device``: ``points`` and the per-task
    target lists; other keys are dropped."""
    out = {"points": torch.as_tensor(np.asarray(batch["points"]), device=device)}
    for k in TARGET_KEYS:
        out[k] = [torch.as_tensor(np.asarray(v), device=device) for v in batch[k]]
    return out


def make_detector_steps(detector, code_weights: Sequence[float], weight: float = 2.0):
    """-> ``train_step(state, batch) -> logs`` (a dict of scalar tensors).

    ``batch`` holds numpy arrays (``collate_detection``) or tensors; they are moved to
    the device of the detector's parameters."""
    has_vel = detector.with_velocity

    def train_step(state: TrainState, batch):
        device = next(state.model.parameters()).device
        b = batch_to_device(batch, device)
        state.model.train()
        preds = state.model(b["points"])
        total, logs = center_head_loss(
            preds, {k: b[k] for k in TARGET_KEYS}, code_weights, weight=weight,
            has_vel=has_vel,
        )
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.apply_gradients()
        return sum_logs({k: v.detach() for k, v in logs.items()})

    return train_step


def make_predict_step(detector, test_cfg: dict):
    """-> ``predict_step(state, points) -> predictions``: the eval forward of
    ``state.model`` on points (B, N, D) (a tensor on the model's device) and
    ``predict``: (B, post_max * tasks) tensors ``box3d_lidar``, ``scores``,
    ``label_preds``, ``valid``."""
    num_classes = detector.num_classes

    @torch.no_grad()
    def predict_step(state: TrainState, points):
        state.model.eval()
        return predict(state.model(points), test_cfg, num_classes)

    return predict_step


def make_tta_predict_step(detector, test_cfg: dict):
    """The double-flip predict step: points (B*4, N, D) ordered [orig, yflip, xflip,
    both] per frame; each task's maps are flipped back and averaged after activation
    before decode -> predictions with batch B."""
    num_classes = detector.num_classes

    @torch.no_grad()
    def predict_step(state: TrainState, points):
        state.model.eval()
        averaged = [average_double_flip_preds(p) for p in state.model(points)]
        return predict(averaged, test_cfg, num_classes, activated=True)

    return predict_step


def predictions_to_host(batch_preds: dict, tokens) -> dict:
    """Fixed-shape predictions -> per-frame numpy dicts keyed by token:
    {'box3d_lidar' (K, 7|9), 'scores' (K,), 'label_preds' (K,)} of the valid slots.
    The four tensors travel as one f32 block, so a batch costs one device-to-host copy
    (labels are small integers, exact in f32)."""
    boxes = batch_preds["box3d_lidar"]
    d = boxes.shape[-1]
    block = torch.cat([boxes.float(), batch_preds["scores"].float()[..., None],
                       batch_preds["label_preds"].float()[..., None],
                       batch_preds["valid"].float()[..., None]], dim=-1).cpu().numpy()
    out = {}
    for i, token in enumerate(tokens):
        rows = block[i][block[i, :, d + 2] > 0]
        out[token] = {"box3d_lidar": rows[:, :d], "scores": rows[:, d],
                      "label_preds": rows[:, d + 1].astype(np.int64)}
    return out
