"""The readers of the program's own spans and counters (``tdal_torch.runtime.tracing``):
each reads its counters, and gives None where the program has none, as the port before
them has not; and the program's spans in a trace leave every reading of
``common.reduce_trace`` as it was."""

import json
import sys

import pytest

from portbench import common

READERS = {
    "data_build_ms.train": ({"data.batch.s": 1.5, "data.batch.n": 10}, 150.0),
    "data_build_ms.detect": ({"data.batch.s": 0.5, "data.batch.n": 4}, 125.0),
    "nms_rounds.detect": ({"nms.rounds": 90, "predict.steps": 4}, 22.5),
    "sparse_pair_fill.detect": ({"traced.sparse.pairs": 30,
                                 "traced.sparse.rows_gathered": 400}, 7.5),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_its_counters_and_nothing_without_them(name, monkeypatch):
    import tdal_torch.runtime
    from tdal_torch.runtime import tracing

    counts, want = READERS[name]
    monkeypatch.setattr(tracing, "counters", lambda: dict(counts))
    assert common.read_metric(name, None) == pytest.approx(want)
    monkeypatch.setattr(tracing, "counters", lambda: {"conv3x3.launches.conv3x3_fwd": 0})
    assert common.read_metric(name, None) is None
    # a program without the tracing module
    monkeypatch.delattr(tdal_torch.runtime, "tracing")
    monkeypatch.setitem(sys.modules, "tdal_torch.runtime.tracing", None)
    assert common.read_metric(name, None) is None


class _Trace:
    """Stands for a stopped profiler: its Chrome trace is ``events``."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def test_the_programs_spans_leave_reduce_trace_as_it_was(tmp_path):
    ops = [_x("cpu_op", "aten::mul", 0, 30), _x("cuda_runtime", "cudaLaunchKernel", 10, 2, 1),
           _x("kernel", "k1", 12, 10, 1), _x("cpu_op", "aten::add", 40, 20),
           _x("cuda_runtime", "cudaLaunchKernel", 45, 2, 2), _x("kernel", "k2", 50, 5, 2),
           _x("cuda_runtime", "cudaLaunchKernel", 90, 2, 3), _x("kernel", "k3", 100, 4, 3)]
    spans = [_x("user_annotation", "train.step", 0, 95),
             _x("user_annotation", "train.forward", 5, 50),
             _x("gpu_user_annotation", "train.forward", 12, 43)]
    plain = common.reduce_trace(_Trace(ops), 1.0, tmp_path / "a.json")
    traced = common.reduce_trace(_Trace(ops + spans), 1.0, tmp_path / "b.json")
    assert plain == traced
    assert plain["idle"] == {"aten::mul": pytest.approx(28e-6),
                             "aten::add": pytest.approx(45e-6)}
