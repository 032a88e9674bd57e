"""Detector training loop.

Port of ``tdal/pipeline/detector_run.py`` (``detection_batches``, ``train_detector``):
an epoch loop over the host data pipeline with one-batch-ahead prefetch on a thread,
the train step of ``detector_engine``, windowed metric logging to the logger and to
``work_dir/logs/metrics.jsonl``, and a checkpoint per epoch (``torch.save`` of the
state dicts under ``work_dir/checkpoints``). The mesh, the profiler hook and the
in-training validation arrive with later slices.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from pathlib import Path

import numpy as np

from tdal_torch.data.detection import collate_detection
from tdal_torch.pipeline.detector_engine import make_detector_steps
from tdal_torch.runtime.train_state import TrainState


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
    short last batch is padded with its last frame."""
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)

    def gen():
        for start in range(0, n, batch_size):
            sel = idx[start : start + batch_size]
            sel = np.concatenate([sel, np.full(batch_size - len(sel), sel[-1])])
            yield collate_detection([dataset[int(i)] for i in sel])

    return _prefetch(gen())


def train_detector(state: TrainState, train_ds, code_weights, n_epoch: int,
                   batch_size: int, logger, work_dir, weight: float = 2.0,
                   log_every: int = 10, seed: int = 0):
    """Train ``state.model`` (on its device) for ``n_epoch`` epochs and return ``state``."""
    train_step = make_detector_steps(state.model, code_weights, weight)
    metrics = Path(work_dir) / "logs" / "metrics.jsonl"
    metrics.parent.mkdir(parents=True, exist_ok=True)
    steps_per_epoch = max(1, len(train_ds) // batch_size)
    window = []
    for epoch in range(n_epoch):
        t0 = time.time()
        for i, batch in enumerate(
            detection_batches(train_ds, batch_size, shuffle=True, seed=seed + epoch)
        ):
            logs = train_step(state, batch)
            window.append(logs)
            if (i + 1) % log_every == 0:
                avg = {k: float(np.mean([float(w[k]) for w in window])) for k in logs}
                logger.info(f"Epoch [{epoch + 1}/{n_epoch}][{i + 1}/{steps_per_epoch}] "
                            + ", ".join(f"{k}: {v:.4f}" for k, v in avg.items()))
                with open(metrics, "a") as f:
                    f.write(json.dumps({"mode": "train", "step": state.step, **avg}) + "\n")
                window.clear()
        logger.info(f"Epoch {epoch + 1} done in {time.time() - t0:.1f}s")
        state.save(Path(work_dir) / "checkpoints" / f"step_{state.step:08d}.pt")
    return state
