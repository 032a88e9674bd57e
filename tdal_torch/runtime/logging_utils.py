"""Logging, metric rows and seeding of the port's drivers and CLIs.

Port of ``tdal/runtime/logging_utils.py`` (``create_logger``, ``MetricsWriter``,
``fix_seed`` and the reference seed, tools/utils.py:24-44), and ``quiet_logger``.
"""

from __future__ import annotations

import json
import logging
import random
import sys
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


class MetricsWriter:
    """Appends one JSON row per call to ``log_dir/metrics.jsonl``."""

    def __init__(self, log_dir):
        self.path = Path(log_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, step: int, metrics: dict, mode: str = "train"):
        row = {"mode": mode, "step": int(step), **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
