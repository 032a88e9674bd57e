"""The controls of a data-parallel or spatially partitioned check: wrong steps that a
comparison with the single-process step must tell apart from the sound one
(``tests/test_torch_parallel.py``, ``tests/test_torch_spatial_partition.py``,
``chip_smoke.py`` phases 10 and 14).

- per-rank BatchNorm statistics: the layers' sums are not all-reduced and their counts
  are the rank's own (under spatial partitioning: BN moments per slab);
- per-rank loss normalizers: the detector's and the RoI head's counts are the rank's
  own, and the labelers' means are over the rank's rows;
- zero halo rows (spatial partitioning, ``SP_CONTROLS``): every row a rank receives from
  a neighbour is zeros, in the forward and the backward, so each slab is a separate
  image.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

CONTROLS = ("per-rank BN statistics", "per-rank loss normalizers")
SP_CONTROLS = ("zero halo rows", CONTROLS[0])


@contextlib.contextmanager
def control(name):
    """Within the block, data-parallel or partitioned steps run as the control ``name``
    (one of ``CONTROLS`` or ``SP_CONTROLS``); None: the sound step."""
    from tdal_torch.models import center_head, layers, static_labeler, two_stage
    from tdal_torch.parallel.mesh import RowSlab

    def zero_swap(slab, up, down, swap=RowSlab._swap):
        return tuple(None if r is None else torch.zeros_like(r) for r in swap(slab, up, down))

    patches = {
        None: [],
        CONTROLS[0]: [(layers, "all_reduce_sum", lambda x, axis=None: x)],
        CONTROLS[1]: [(center_head, "all_reduce_sum", lambda x, axis=None: x),
                      (two_stage, "all_reduce_sum", lambda x, axis=None: x),
                      (static_labeler, "partial_mean", lambda x: x.mean())],
        SP_CONTROLS[0]: [(RowSlab, "_swap", zero_swap)],
    }[name]
    with contextlib.ExitStack() as stack:
        for module, attr, value in patches:
            stack.enter_context(mock.patch.object(module, attr, value))
        yield
