"""Step-numbered checkpoints with latest and best markers.

Port of ``tdal/runtime/checkpoint.py``'s ``CheckpointManager`` (the labeler tools'
best-by-eval-accuracy saving, tools/static_train.py:149-165): each checkpoint is one
``torch.save`` file ``ckpt_<step>.pt`` of a dict of state dicts beside its
``ckpt_<step>.json`` meta; ``latest.json`` and ``best.json`` name a step. The newest
``max_to_keep`` checkpoints are kept, and the best one always. Import of tdal's orbax
checkpoints is not ported.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 5):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int, suffix: str) -> Path:
        return self.directory / f"ckpt_{step:08d}{suffix}"

    def save(self, step: int, state: dict, meta: Optional[dict] = None,
             is_best: bool = False) -> Path:
        """``state``: a dict of state dicts (or tensors); saved on the CPU."""
        path = self._path(step, ".pt")
        torch.save(_to_cpu(state), path)
        meta = {**(meta or {}), "step": step}
        self._path(step, ".json").write_text(json.dumps(meta, default=float))
        (self.directory / "latest.json").write_text(json.dumps({"step": step}))
        if is_best:
            (self.directory / "best.json").write_text(json.dumps(meta, default=float))
        self._gc()
        return path

    def _gc(self):
        best = self.best_step()
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.max_to_keep)]:
            if s != best:
                self._path(s, ".pt").unlink(missing_ok=True)
                self._path(s, ".json").unlink(missing_ok=True)

    def all_steps(self) -> list:
        return [int(p.stem.split("_")[1]) for p in self.directory.glob("ckpt_*.pt")]

    def _marked(self, name: str) -> Optional[int]:
        marker = self.directory / name
        if marker.exists():
            step = json.loads(marker.read_text())["step"]
            if self._path(step, ".pt").exists():
                return step
        return None

    def latest_step(self) -> Optional[int]:
        step = self._marked("latest.json")
        if step is None and self.all_steps():
            step = max(self.all_steps())
        return step

    def best_step(self) -> Optional[int]:
        return self._marked("best.json")

    def restore(self, step: Optional[int] = None, map_location="cpu"):
        """(state, meta) of checkpoint ``step``; None means the latest."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        state = torch.load(self._path(step, ".pt"), map_location=map_location,
                           weights_only=True)
        meta_path = self._path(step, ".json")
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {"step": step}
        return state, meta


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree
