"""Detector train step for CenterPoint models.

Port of the train half of ``tdal/pipeline/detector_engine.py:make_detector_steps``:
the forward in train mode (BatchNorm running statistics update in place), the
CenterHead loss, the backward, and one optimizer step. The predict step arrives with
the inference slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tdal_torch.models.center_head import center_head_loss
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
        return {k: v.detach() for k, v in logs.items()}

    return train_step
