"""The controls of a data-parallel check: two wrong data-parallel steps that a comparison
of the data-parallel step with the single-process step must tell apart from the sound
one (``tests/test_torch_parallel.py``, ``chip_smoke.py`` phase 10).

- per-rank BatchNorm statistics: the layers' sums are not all-reduced and their counts
  are the rank's own;
- per-rank loss normalizers: the detector's and the RoI head's counts are the rank's
  own, and the labelers' means are over the rank's rows.
"""

from __future__ import annotations

import contextlib
from unittest import mock

CONTROLS = ("per-rank BN statistics", "per-rank loss normalizers")


@contextlib.contextmanager
def control(name):
    """Within the block, data-parallel steps run as the control ``name`` (one of
    ``CONTROLS``); None: the sound step."""
    from tdal_torch.models import center_head, layers, static_labeler, two_stage

    patches = {
        None: [],
        CONTROLS[0]: [(layers, "all_reduce_sum", lambda x: x),
                      (layers, "world_size", lambda: 1)],
        CONTROLS[1]: [(center_head, "all_reduce_sum", lambda x: x),
                      (two_stage, "all_reduce_sum", lambda x: x),
                      (static_labeler, "partial_mean", lambda x: x.mean())],
    }[name]
    with contextlib.ExitStack() as stack:
        for module, attr, value in patches:
            stack.enter_context(mock.patch.object(module, attr, value))
        yield
