"""The reader of the sparse gather-GEMM kernel's tile counters
(``metrics/sparse_tile_load.detect.py``): it reads them, and gives None where the
program has none, as the port before the kernel has not."""

import sys

import pytest

from portbench import common


def test_sparse_tile_load_reads_its_counters_and_nothing_without_them(monkeypatch):
    import tdal_torch.runtime
    from tdal_torch.runtime import tracing

    name = "sparse_tile_load.detect"
    counts = {"traced.sparse.tile_taps_loaded": 54, "traced.sparse.tile_taps": 216}
    monkeypatch.setattr(tracing, "counters", lambda: dict(counts))
    assert common.read_metric(name, None) == pytest.approx(25.0)
    # the parent's program: the gather fill's counters, no tile counters
    monkeypatch.setattr(tracing, "counters", lambda: {
        "traced.sparse.pairs": 30, "traced.sparse.rows_gathered": 400})
    assert common.read_metric(name, None) is None
    # a program without the tracing module
    monkeypatch.delattr(tdal_torch.runtime, "tracing")
    monkeypatch.setitem(sys.modules, "tdal_torch.runtime.tracing", None)
    assert common.read_metric(name, None) is None
