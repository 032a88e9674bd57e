"""Train state: the model, its optimizer and the step count.

Port of ``tdal/runtime/train_state.py``. Where tdal's state is an immutable pytree
(params + batch_stats + opt_state), the port's holds the ``nn.Module`` (parameters and
BatchNorm running statistics, which the train-mode forward updates in place) and the
optimizer; ``apply_gradients`` takes one optimizer step on the gradients left in
``.grad`` by the backward pass. Under an active data-parallel mesh it first sums them
over the ranks (``tdal_torch.parallel.mesh.all_reduce_grads``), so the global-norm clip
and AdamW see the gradient of the global batch and every rank takes the same update.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch
from torch import nn

from tdal_torch.parallel.mesh import active, all_reduce_grads


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def apply_gradients(self):
        mesh = active()
        if mesh is not None:
            all_reduce_grads([p for g in self.optimizer.param_groups for p in g["params"]],
                             mesh)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def save(self, path) -> Path:
        """``torch.save`` of the state dicts to ``path``."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(self.state_dict(), path)
        return path

    def load(self, path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.step = int(ckpt["step"])
        if hasattr(self.optimizer, "count"):
            self.optimizer.count = self.step
        return self


def checkpoint_file(path) -> Path:
    """``path`` itself, or the newest ``step_*.pt`` (``train_detector``'s checkpoints)
    in the directory ``path``."""
    path = Path(path)
    if path.is_dir():
        found = sorted(path.glob("step_*.pt"))
        if not found:
            raise FileNotFoundError(f"no step_*.pt checkpoint in {path}")
        path = found[-1]
    return path


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
