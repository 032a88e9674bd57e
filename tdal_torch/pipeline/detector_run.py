"""Detector training, inference and evaluation.

Port of ``tdal/pipeline/detector_run.py`` (``detection_batches``, ``train_detector``,
``run_inference``, ``evaluate_detector``): an epoch loop over the host data pipeline
with one-batch-ahead prefetch on a thread, the train step of ``detector_engine``,
windowed metric logging to the logger and to ``work_dir/logs/metrics.jsonl``, a
checkpoint per epoch (``torch.save`` of the state dicts under
``work_dir/checkpoints``) and, with ``val_ds``, AP/APH on a validation split; inference
over a dataset (plain or double-flip) and its AP/APH; and tdal's profiler hooks, a
``torch.profiler`` trace of a window of train steps or inference batches written to
``profile_dir`` as a Chrome trace.

With a data-parallel ``mesh`` (``tdal_torch.parallel.mesh``) every rank builds each
global batch whole (the same shuffle and augmentation draws as one process) and trains
on its rows, starting from rank 0's weights; rank 0 alone logs, writes metrics and
checkpoints and traces. The validation's inference is sharded the same way (each rank
predicts its rows of every batch, rank 0 gathers the detections), and rank 0 alone
computes its AP/APH while the other ranks wait: the metric is tdal's unsharded one,
over every frame.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from pathlib import Path

import numpy as np

import torch

from tdal_torch.data.detection import collate_detection
from tdal_torch.data.waymo_schema import reorganize_info
from tdal_torch.models.tta import double_flip_points
from tdal_torch.parallel.mesh import (
    barrier, gather_to_main, is_main, per_rank, rank_rows, rank_step, start_run,
)
from tdal_torch.pipeline.detector_engine import (
    make_detector_steps, make_predict_step, make_tta_predict_step, predictions_to_host,
)
from tdal_torch.runtime.logging_utils import LogBuffer, MetricsWriter
from tdal_torch.runtime.train_state import TrainState
from tdal_torch.utils.detection_metrics import (
    detections_to_eval_format, evaluate_detection, gt_from_annos,
)


def _prefetch(iterator, depth: int = 2):
    """Run ``iterator`` on a thread, ``depth`` items ahead of the consumer; an error
    raised there is raised again in the consumer."""
    q = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in iterator:
                q.put((True, item))
        except Exception as e:  # handed over to the consumer
            q.put((False, e))
        q.put((True, end))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        ok, item = q.get()
        if not ok:
            raise item
        if item is end:
            return
        yield item


def detection_batches(dataset, batch_size, shuffle=False, seed=0):
    """Collated batches of ``dataset``, prepared on a thread ahead of the consumer; a
    short last batch is padded with its last frame (``n_valid`` counts the real ones)."""
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)

    def gen():
        for start in range(0, n, batch_size):
            sel = idx[start : start + batch_size]
            sel = np.concatenate([sel, np.full(batch_size - len(sel), sel[-1])])
            batch = collate_detection([dataset[int(i)] for i in sel])
            batch["n_valid"] = min(batch_size, n - start)
            yield batch

    return _prefetch(gen())


def start_trace(device):
    """A started ``torch.profiler`` profile (CPU, and CUDA on a card)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, profile_dir, name: str, device) -> Path:
    """Stop ``prof`` (after the device's work) and write its Chrome trace to
    ``profile_dir/<name>.trace.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    path = Path(profile_dir) / f"{name}.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


def train_detector(state: TrainState, train_ds, code_weights, n_epoch: int,
                   batch_size: int, logger, work_dir, weight: float = 2.0,
                   log_every: int = 10, seed: int = 0, val_ds=None, test_cfg=None,
                   val_every: int = 1, val_max_frames: int = None, mesh=None,
                   profile_dir=None):
    """Train ``state.model`` (on its device) for ``n_epoch`` epochs and return ``state``.
    With ``val_ds`` (and its ``test_cfg``), every ``val_every`` epochs end with
    ``evaluate_detector`` on at most ``val_max_frames`` of its frames, logged and
    written to metrics.jsonl as a ``"val"`` row. ``batch_size`` is the global batch;
    with ``mesh`` each rank trains on its share of it and predicts its share of each
    validation batch. With ``profile_dir``, train
    steps 5-9 of the first epoch (fewer in a short epoch, as tdal's hook) are traced."""
    if val_ds is not None and test_cfg is None:
        raise ValueError("train_detector: validation needs the test_cfg")
    main, logger = start_run(mesh, batch_size, state.model, logger)
    if not main:
        profile_dir = None
    train_step = make_detector_steps(state.model, code_weights, weight)
    device = next(state.model.parameters()).device
    writer = MetricsWriter(Path(work_dir) / "logs") if main else None
    steps_per_epoch = max(1, len(train_ds) // batch_size)
    prof_start = min(5, max(steps_per_epoch - 2, 0))
    prof_stop = min(prof_start + 4, steps_per_epoch - 1)
    prof, buf = None, LogBuffer()
    for epoch in range(n_epoch):
        t0 = time.time()
        for i, batch in enumerate(
            detection_batches(train_ds, batch_size, shuffle=True, seed=seed + epoch)
        ):
            if profile_dir is not None and epoch == 0 and i == prof_start:
                prof = start_trace(device)
            with rank_step(mesh, batch) as rows:
                logs = train_step(state, rows)
            if prof is not None and i == prof_stop:
                path = stop_trace(prof, profile_dir, "train", device)
                logger.info(f"profiler trace (steps {prof_start}-{prof_stop}) -> {path}")
                prof = profile_dir = None
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
        if val_ds is not None and (epoch + 1) % val_every == 0:
            val = evaluate_detector(state, val_ds, test_cfg, batch_size, logger,
                                    max_frames=val_max_frames, mesh=mesh)
            if main:
                logger.info(f"Val epoch {epoch + 1}: "
                            + ", ".join(f"{k}: {v:.4f}" for k, v in val.items()))
                writer.write(state.step, val, mode="val")
            if mesh is not None:
                barrier(mesh)
    return state


def run_inference(state: TrainState, dataset, test_cfg: dict, batch_size: int, logger,
                  speed_test: bool = False, double_flip: bool = False,
                  profile_dir=None, mesh=None) -> dict:
    """Inference of ``state.model`` (on its device) over ``dataset`` in order ->
    {token: {box3d_lidar, scores, label_preds}} (numpy).

    ``double_flip`` feeds each frame's four variants (B*4, N, D) to the double-flip
    predict step. ``speed_test`` times every batch, synchronised with the card, and
    logs the mean seconds per frame over the middle third of the batches (the
    reference's dist_test.py measurement) as ``"Total time per frame: %s s (middle
    third)"`` with the unrounded value as the record's argument. With ``profile_dir``
    the first three batches of the middle third are traced, as tdal's hook.

    With a data-parallel ``mesh`` ``batch_size`` is the global batch: each rank predicts
    its rows of every batch, and rank 0 gathers the detections and returns them all
    (the other ranks return {}). Under BEV spatial partitioning (the model's
    ``bev_sharding`` over the mesh's spatial axis) the ranks of a spatial group predict
    the same rows, and the first of them reports them."""
    model = state.model
    device = next(model.parameters()).device
    step = (make_tta_predict_step if double_flip else make_predict_step)(model, test_cfg)
    detections = {}
    n_batches = (len(dataset) + batch_size - 1) // batch_size
    start_idx, times = n_batches // 3, []
    prof_stop, prof = min(start_idx + 2, n_batches - 1), None
    rows = per_rank(batch_size, mesh)
    first = 0 if mesh is None else mesh.data_rank * rows
    # the ranks of a spatial group predict the same rows: the first of them reports them
    reports = mesh is None or mesh.spatial_rank == 0
    for bi, batch in enumerate(detection_batches(dataset, batch_size, shuffle=False)):
        points = rank_rows(np.asarray(batch["points"]), mesh)
        tokens = batch["token"][first : min(first + rows, batch["n_valid"])]
        if double_flip:
            points = np.stack([v for p in points for v in double_flip_points(p)])
        if profile_dir is not None and bi == start_idx:
            prof = start_trace(device)
        t0 = time.perf_counter()
        preds = step(state, torch.as_tensor(points, device=device))
        if speed_test:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if start_idx <= bi < 2 * start_idx:
                times.append((time.perf_counter() - t0) / rows)
        mine = predictions_to_host(preds, tokens) if reports else {}
        for part in gather_to_main(mine, mesh) or ():
            detections.update(part)
        if prof is not None and bi == prof_stop:
            path = stop_trace(prof, profile_dir, "inference", device)
            logger.info(f"profiler trace (middle batches) -> {path}")
            prof = profile_dir = None
        if (bi + 1) % 20 == 0:
            logger.info(f"inference {bi + 1}/{n_batches}")
    if speed_test and times:
        logger.info("Total time per frame: %s s (middle third)", float(np.mean(times)))
    return detections


def evaluate_detector(state: TrainState, val_ds, test_cfg: dict, batch_size: int, logger,
                      max_frames: int = None, mesh=None) -> dict | None:
    """``run_inference`` over ``val_ds`` (its first ``max_frames`` frames) and the
    in-framework AP/APH of ``tdal_torch.utils.detection_metrics`` against its annos.
    With a data-parallel ``mesh`` the inference is sharded and rank 0 alone computes the
    metrics; the other ranks return None."""
    if max_frames is not None and len(val_ds.infos) > max_frames:
        val_ds = copy.copy(val_ds)
        val_ds.infos = val_ds.infos[:max_frames]
    detections = run_inference(state, val_ds, test_cfg, batch_size, logger, mesh=mesh)
    if not is_main(mesh):
        return None
    gts = gt_from_annos(reorganize_info(val_ds.infos))
    return evaluate_detection(detections_to_eval_format(detections), gts)
