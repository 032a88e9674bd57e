"""Logging, metric rows and seeding of the port's drivers and CLIs.

Port of ``tdal/runtime/logging_utils.py``: ``create_logger``, ``fix_seed`` and the
reference seed (tools/utils.py:24-44), ``LogBuffer`` (the trainers' windowed log lines)
and ``MetricsWriter`` (JSON rows, and TensorBoard scalars where ``tensorboardX`` is
installed and asked for); and ``quiet_logger``. Timing is ``runtime/tracing.py``'s.
"""

from __future__ import annotations

import json
import logging
import random
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

DEFAULT_SEED = 10922081  # reference tools/utils.py:24


def create_logger(log_file=None, name: str = "tdal_torch", level=logging.INFO):
    """A logger writing to stdout and, given ``log_file``, to that file."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file is not None:
        log_file = Path(log_file)
        log_file.parent.mkdir(parents=True, exist_ok=True)
        if not any(getattr(h, "baseFilename", None) == str(log_file.resolve())
                   for h in logger.handlers):
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def quiet_logger() -> logging.Logger:
    """A logger that emits nothing: the training loops' and CLIs' logger on data-parallel
    ranks other than 0."""
    return logging.Logger("tdal_torch.quiet", level=logging.CRITICAL + 1)


def fix_seed(seed: int = DEFAULT_SEED) -> int:
    """Seed python's, numpy's and torch's global generators; returns ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


class LogBuffer:
    """Windowed scalar averaging (reference torchie/trainer/log_buffer.py:6-40): every
    ``update`` is kept, ``average(n)`` puts the count-weighted mean of each key's
    latest ``n`` values (all of them for 0) in ``output``."""

    def __init__(self):
        self.val_history = OrderedDict()
        self.n_history = OrderedDict()
        self.output = OrderedDict()
        self.ready = False

    def clear(self):
        self.val_history.clear()
        self.n_history.clear()
        self.clear_output()

    def clear_output(self):
        self.output.clear()
        self.ready = False

    def update(self, vars: dict, count: int = 1):
        for k, v in vars.items():
            self.val_history.setdefault(k, []).append(float(v))
            self.n_history.setdefault(k, []).append(count)

    def average(self, n: int = 0):
        for k in self.val_history:
            v = np.array(self.val_history[k][-n:] if n else self.val_history[k])
            c = np.array(self.n_history[k][-n:] if n else self.n_history[k])
            self.output[k] = float((v * c).sum() / c.sum())
        self.ready = True


class MetricsWriter:
    """Appends one JSON row per call to ``log_dir/metrics.jsonl``; with
    ``tensorboard=True`` and ``tensorboardX`` installed, also writes each value as a
    scalar under ``log_dir/tf_logs`` (reference TextLoggerHook and
    TensorboardLoggerHook, hooks/logger/text.py:111-133, tensorboard.py:9-55)."""

    def __init__(self, log_dir, tensorboard: bool = False):
        self.path = Path(log_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(str(Path(log_dir) / "tf_logs"))

    def write(self, step: int, metrics: dict, mode: str = "train"):
        row = {"mode": mode, "step": int(step), **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{mode}/{k}", float(v), int(step))

    def close(self):
        if self._tb is not None:
            self._tb.close()
