"""Two-stage training and inference drivers.

Port of ``tdal/pipeline/two_stage_run.py``: the fine-tuning flow of the
``configs/waymo/*/two_stage/*_freeze*.py`` configs. ``load_pretrained_first`` loads the
first stage from the config's ``first_stage_cfg.pretrained`` (a checkpoint of
``train_detector``, or the newest one in its directory, or the latest step of a
directory that ``tdal``'s training wrote; reference single_stage.py: 33-40),
``train_two_stage`` trains the RoI head (and the first stage, unless frozen) on
proposal targets with a checkpoint per epoch, and ``run_two_stage_inference`` runs the
sqrt-rescored two-stage prediction over a dataset; its predict step opens the spans
``predict.step`` and ``two_stage.*`` and counts ``predict.steps``
(``two_stage_engine``), and ``predictions_to_host`` opens ``predict.to_host``.
``train_two_stage`` takes a data-parallel mesh as ``train_detector`` does (tdal's
``mesh`` path).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from tdal_torch.convert import load_tdal_checkpoint
from tdal_torch.parallel.mesh import rank_step, start_run
from tdal_torch.pipeline.detector_engine import predictions_to_host
from tdal_torch.pipeline.detector_run import detection_batches
from tdal_torch.pipeline.two_stage_engine import make_two_stage_steps
from tdal_torch.runtime.checkpoint import is_tdal_checkpoint
from tdal_torch.runtime.logging_utils import LogBuffer, MetricsWriter
from tdal_torch.runtime.train_state import TrainState, checkpoint_file


def load_pretrained_first(engine, cfg, logger) -> bool:
    """Load ``cfg.model.first_stage_cfg.pretrained`` into ``engine.first`` where the
    config names one; a missing checkpoint is logged and the fresh weights stay."""
    pretrained = cfg.model["first_stage_cfg"].get("pretrained")
    if not pretrained:
        return False
    if is_tdal_checkpoint(pretrained):
        meta = load_tdal_checkpoint(engine.first, pretrained)
        logger.info(f"loaded pretrained first stage from tdal's {pretrained}: {meta}")
        return True
    try:
        path = checkpoint_file(pretrained)
    except FileNotFoundError:
        logger.warning(f"pretrained first stage not found at {pretrained}")
        return False
    device = next(engine.parameters()).device
    engine.first.load_state_dict(torch.load(path, map_location=device,
                                            weights_only=True)["model"])
    logger.info(f"loaded pretrained first stage from {path}")
    return True


def train_two_stage(state: TrainState, train_ds, n_epoch: int, batch_size: int, logger,
                    work_dir, seed: int = 0, log_every: int = 10, mesh=None) -> TrainState:
    """Train ``state.model`` (a ``TwoStageEngine``) for ``n_epoch`` epochs: each step's
    proposal draws and dropout masks from one ``torch.Generator`` seeded with ``seed``;
    windowed logs to the logger and ``work_dir/logs/metrics.jsonl``, a checkpoint per
    epoch under ``work_dir/checkpoints``. With a data-parallel ``mesh`` ``batch_size`` is
    the global batch, each rank trains on its rows from rank 0's weights, and rank 0
    alone logs and writes files."""
    main, logger = start_run(mesh, batch_size, state.model, logger)
    train_step, _ = make_two_stage_steps(state.model)
    generator = torch.Generator().manual_seed(seed)
    steps_per_epoch = max(1, len(train_ds) // batch_size)
    buf = LogBuffer()
    writer = MetricsWriter(Path(work_dir) / "logs") if main else None
    for epoch in range(n_epoch):
        t0 = time.time()
        for i, batch in enumerate(
            detection_batches(train_ds, batch_size, shuffle=True, seed=seed + epoch)
        ):
            with rank_step(mesh, batch) as rows:
                logs = train_step(state, rows, generator=generator)
            if not main:
                continue
            buf.update(logs)
            if (i + 1) % log_every == 0:
                buf.average(log_every)
                logger.info(f"Epoch [{epoch + 1}/{n_epoch}][{i + 1}/{steps_per_epoch}] "
                            + ", ".join(f"{k}: {v:.4f}" for k, v in buf.output.items()))
                writer.write(state.step, buf.output)
                buf.clear_output()
        logger.info(f"Epoch {epoch + 1} done in {time.time() - t0:.1f}s")
        if main:
            state.save(Path(work_dir) / "checkpoints" / f"step_{state.step:08d}.pt")
    return state


def run_two_stage_inference(state: TrainState, dataset, batch_size: int, logger,
                            speed_test: bool = False) -> dict:
    """Two-stage inference over ``dataset`` in order -> {token: {box3d_lidar, scores,
    label_preds}} (numpy), with the sqrt rescoring. ``speed_test`` logs the mean
    synchronised seconds per frame over the middle third of the batches, as
    ``run_inference`` does."""
    _, predict_step = make_two_stage_steps(state.model)
    device = next(state.model.parameters()).device
    detections = {}
    n_batches = (len(dataset) + batch_size - 1) // batch_size
    start_idx, times = n_batches // 3, []
    for bi, batch in enumerate(detection_batches(dataset, batch_size, shuffle=False)):
        t0 = time.perf_counter()
        preds = predict_step(state, torch.as_tensor(np.asarray(batch["points"]), device=device))
        if speed_test:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if start_idx <= bi < 2 * start_idx:
                times.append((time.perf_counter() - t0) / batch_size)
        detections.update(predictions_to_host(preds, batch["token"][: batch["n_valid"]]))
    if speed_test and times:
        logger.info("Total time per frame: %s s (middle third)", float(np.mean(times)))
    return detections
