"""The control and the faults of the benchmark's correctness check, planted in the
program by name, so that a run with them goes through the harness's own comparison
and its ``correct``:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --control <name>

- ``tf32``: the control, the program's own TF32 path switched on (PyTorch's matmul and
  cuDNN switches, which the benchmark otherwise turns off because the configurations
  state float32): the nearest precision below float32 (both modes);
- ``unchanged_state``: the optimizer's step left out, the state returned as it was
  (``train``);
- ``half_batch``: each training step on the first half of its batch, the loss's means
  over the rest (``train``);
- ``flipped_update``: each optimizer update applied with its sign reversed (``train``);
- ``half_answers``: the second half of each batch's answers left out (``detect``);
- ``altered_answer``: one box of each batch moved by half a metre where it is produced
  (``detect``).

The benchmark's own runs plant nothing; the tests and the readings that set the
limits do.
"""

from __future__ import annotations

import contextlib
from unittest import mock

TRAIN = ("tf32", "unchanged_state", "half_batch", "flipped_update")
DETECT = ("tf32", "half_answers", "altered_answer")


def tf32_on(run) -> bool:
    """Whether the run's matmuls and convs may take TF32: only under the control."""
    return run.control == "tf32"


def _unchanged_state():
    from tdal_torch.runtime.train_state import TrainState

    def apply_gradients(self):
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self

    return mock.patch.object(TrainState, "apply_gradients", apply_gradients)


def _flipped_update():
    import torch

    from tdal_torch.runtime.train_state import TrainState

    real = TrainState.apply_gradients

    def apply_gradients(self):
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        out = real(self)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(2 * b - p)
        return out

    return mock.patch.object(TrainState, "apply_gradients", apply_gradients)


def _half_batch():
    from tdal_torch.pipeline import detector_engine as de

    real = de.batch_to_device

    def half(batch, device):
        b = real(batch, device)
        n = b["points"].shape[0] // 2
        return {k: (v[:n] if k == "points" else [t[:n] for t in v]) for k, v in b.items()}

    return mock.patch.object(de, "batch_to_device", half)


def _half_answers():
    from tdal_torch.pipeline import detector_engine as de

    real = de.predict

    def half(*a, **k):
        out = real(*a, **k)
        n = out["valid"].shape[0]
        out["valid"] = out["valid"].clone()
        out["valid"][n // 2 :] = False
        return out

    return mock.patch.object(de, "predict", half)


def _altered_answer():
    from tdal_torch.pipeline import detector_engine as de

    real = de.predict

    def altered(*a, **k):
        out = real(*a, **k)
        out["box3d_lidar"] = out["box3d_lidar"].clone()
        out["box3d_lidar"][0, 0, 0] += 0.5
        return out

    return mock.patch.object(de, "predict", altered)


FAULTS = {"unchanged_state": _unchanged_state, "flipped_update": _flipped_update,
          "half_batch": _half_batch, "half_answers": _half_answers,
          "altered_answer": _altered_answer}


@contextlib.contextmanager
def planted(name: str | None, mode: str):
    """The program with the control or fault ``name`` planted (None: as it is)."""
    if name is not None and name not in (TRAIN if mode == "train" else DETECT):
        raise SystemExit(f"portbench: no control or fault {name!r} in mode {mode!r}")
    if name in FAULTS:
        with FAULTS[name]():
            yield
    else:  # None, or tf32, which the modes read through tf32_on
        yield
