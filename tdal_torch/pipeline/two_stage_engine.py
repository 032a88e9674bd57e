"""The two-stage detector's train and predict steps.

Port of ``tdal/pipeline/two_stage_engine.py`` (reference TwoStageDetector.forward,
two_stage.py:154-193): the first stage's forward with its BEV feature -> its decoded,
NMS'd boxes as fixed-shape (B, K) RoIs -> the BEV gather at 5 points a box -> proposal
targets -> the RoIHead -> the RoI losses (plus the first stage's CenterHead loss when
it is not frozen), or the sqrt-rescored predictions.

The predict step's phases are spans (``runtime/tracing.py``), named as in
``detector_engine``: ``predict.step`` around ``predict.forward`` (the first stage),
``center_head.predict``'s ``predict.decode`` and ``predict.nms``, then
``two_stage.bev_gather`` (the five-point BEV samples), ``two_stage.roi_head`` and
``two_stage.rescore``. It counts ``predict.steps``, ``two_stage.rois`` (the RoI rows, K
a frame, from the shapes) and, while a profiler records, ``two_stage.rois_valid`` (the
rows that carry a box, on the device).

``TwoStageEngine`` is an ``nn.Module`` holding ``first`` and ``roi_head``, so one
``TrainState`` and one checkpoint carry both. With ``freeze_first`` the first stage
runs in eval mode under ``torch.no_grad()`` (its running statistics stay as they are)
and ``trainable_parameters`` gives the optimizer the RoI head's parameters only: no
update and no weight decay reach the first stage, as tdal's ``optax.multi_transform``
with ``set_to_zero`` (``make_frozen_tx``). The first stage's maps are decoded in f32
(a bf16 first stage's boxes and NMS would be bf16 in tdal). Under an active
data-parallel mesh the train step is given this rank's rows, draws over the global
batch and keeps its rows, and sums its logs over the ranks.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch
from torch import nn

from tdal_torch.models.center_head import center_head_loss, predict
from tdal_torch.models.two_stage import (
    BEVFeatureExtractor, RoIHead, RoiTargetConfig, generate_predicted_boxes,
    get_box_centers, proposal_draws, proposal_targets, roi_head_draws, roi_losses,
    two_stage_post_process,
)
from tdal_torch.parallel.mesh import data_size, rank_rows, sum_logs
from tdal_torch.pipeline.detector_engine import TARGET_KEYS
from tdal_torch.runtime.tracing import count, count_device, span
from tdal_torch.runtime.train_state import TrainState


class TwoStageEngine(nn.Module):
    def __init__(self, first_stage: nn.Module, roi_head: RoIHead, test_cfg: dict,
                 bev_extractor: BEVFeatureExtractor, roi_cfg: RoiTargetConfig = RoiTargetConfig(),
                 num_point: int = 5, code_weights_first: Sequence[float] = (1.0,) * 8,
                 code_weights_roi: Sequence[float] = (1.0,) * 7, first_weight: float = 2.0,
                 freeze_first: bool = True):
        super().__init__()
        self.first, self.roi_head = first_stage, roi_head
        self.test_cfg, self.bev_extractor, self.roi_cfg = test_cfg, bev_extractor, roi_cfg
        self.num_point = num_point
        self.code_weights_first = tuple(code_weights_first)
        self.code_weights_roi = tuple(code_weights_roi)
        self.first_weight, self.freeze_first = first_weight, freeze_first
        self.code_size = roi_head.code_size

    def trainable_parameters(self):
        return (self.roi_head if self.freeze_first else self).parameters()

    def first_stage_rois(self, points, train: bool):
        """The first stage's pass: (maps, rois (B, K, 7|9, heading at 6), roi_labels
        (B, K) 1-based with 0 in empty slots, roi_scores, roi features (B, K, P * C),
        valid (B, K))."""
        learn = train and not self.freeze_first
        self.first.train(learn)
        with contextlib.nullcontext() if learn else torch.no_grad():
            with span("train.forward" if train else "predict.forward"):
                maps, bev = self.first(points, return_feature=True)
            boxes = predict([{k: v.float() for k, v in m.items()} for m in maps],
                            self.test_cfg, self.first.num_classes)
            raw, valid = boxes["box3d_lidar"], boxes["valid"]
            with span("two_stage.bev_gather"):
                feats = self.bev_extractor(bev, get_box_centers(raw, self.num_point))
        rois = raw[..., [0, 1, 2, 3, 4, 5, 8, 6, 7]] if raw.shape[-1] == 9 else raw
        rois = rois * valid[..., None]
        roi_labels = torch.where(valid, boxes["label_preds"] + 1, 0)
        roi_scores = torch.where(valid, boxes["scores"], 0.0)
        return maps, rois, roi_labels, roi_scores, feats * valid[..., None], valid

    def draws(self, b: int, k: int, generator: torch.Generator, device=None) -> dict:
        """A train step's random inputs: the proposal draws (B, 3, K) and the RoI head's
        dropout keep-masks (B, roi_per_image, width). Under an active data-parallel mesh
        ``b`` is this rank's rows: they are drawn over the global batch (from the same
        generator on every rank) and this rank's rows kept."""
        g = b * data_size()
        proposal = proposal_draws(g, k, generator, device)
        dropout = roi_head_draws(self.roi_head, g, self.roi_cfg.roi_per_image, generator,
                                 device)
        return {"proposal": rank_rows(proposal), "dropout": [rank_rows(m) for m in dropout]}


def _gt_of(engine, gt_boxes_and_cls):
    """tdal's slice of the padded [x, y, z, l, w, h, rot, vx, vy, cls] rows: the first
    code_size + 1 columns for a 7-wide code (so its last column, which
    ``proposal_targets`` reads as the class, is vx: tdal's quirk, kept)."""
    return gt_boxes_and_cls[..., : engine.code_size + 1] if engine.code_size == 7 \
        else gt_boxes_and_cls


def make_two_stage_steps(engine: TwoStageEngine):
    """-> (``train_step(state, batch, draws=None, generator=None) -> logs``,
    ``predict_step(state, points) -> predictions``). A train step takes its random
    inputs as ``draws`` (``TwoStageEngine.draws``), or draws them from ``generator``.
    ``batch`` holds numpy arrays or tensors; they move to the engine's device."""

    def train_step(state: TrainState, batch, draws=None, generator=None):
        eng = state.model
        device = next(eng.parameters()).device
        points = torch.as_tensor(np.asarray(batch["points"]), device=device)
        gt = _gt_of(eng, torch.as_tensor(np.asarray(batch["gt_boxes_and_cls"]), device=device))
        maps, rois, roi_labels, roi_scores, feats, _ = eng.first_stage_rois(points, True)
        if draws is None:
            draws = eng.draws(rois.shape[0], rois.shape[1], generator, device)
        targets = proposal_targets(draws["proposal"], rois, roi_scores, roi_labels, feats, gt,
                                   eng.roi_cfg)
        eng.roi_head.train()
        rcnn_cls, rcnn_reg = eng.roi_head(targets["roi_features"], dropout=draws["dropout"])
        cls_loss, reg_loss = roi_losses(rcnn_cls, rcnn_reg, targets, eng.code_weights_roi)
        total = cls_loss + reg_loss
        logs = {"rcnn_loss_cls": cls_loss, "rcnn_loss_reg": reg_loss}
        if not eng.freeze_first:
            first_targets = {k: [torch.as_tensor(np.asarray(v), device=device)
                                 for v in batch[k]] for k in TARGET_KEYS}
            one_total, one_logs = center_head_loss(
                maps, first_targets, eng.code_weights_first, weight=eng.first_weight,
                has_vel=eng.first.with_velocity)
            total = total + one_total
            logs.update(one_logs)
        logs["loss"] = total
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.apply_gradients()
        return sum_logs({k: v.detach() for k, v in logs.items()})

    @torch.no_grad()
    def predict_step(state: TrainState, points):
        count("predict.steps")
        with span("predict.step"):
            eng = state.model
            eng.eval()
            _, rois, roi_labels, roi_scores, feats, valid = eng.first_stage_rois(points, False)
            count("two_stage.rois", rois.shape[0] * rois.shape[1])
            count_device("two_stage.rois_valid", valid.sum())
            with span("two_stage.roi_head"):
                rcnn_cls, rcnn_reg = eng.roi_head(feats)
            with span("two_stage.rescore"):
                return two_stage_post_process(generate_predicted_boxes(rois, rcnn_reg),
                                              rcnn_cls, roi_scores, roi_labels, valid)

    return train_step, predict_step
