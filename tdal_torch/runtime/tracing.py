"""Spans and counters at the port's layer boundaries.

Spans go into the ``torch.profiler`` trace of whatever profiler is recording (the
``--profile_dir`` exporter's, or a benchmark's), so they share one clock with the
device's kernels: the profiler writes each span on the host timeline and, on a card,
as a ``gpu_user_annotation`` on the device timeline. Spans nest on their thread; the
spans of one train step or predict batch share one outermost span, ``train.step`` or
``predict.step``. Off a recording profiler ``span`` hands back one shared no-op
context: no allocation and no ``record_function`` call.

A profiler started on the main thread does not record a ``record_function`` opened on
another thread (the prefetch thread of ``detection_batches``), so work there is
``timed`` on the host's clock instead.

Counters are host numbers, always on, and take Python numbers only, so they never
wait for the device. ``count_device`` keeps device tensors, and only while a profiler
records; every count made while one records is also kept under ``traced.<name>``, so
that the counts of the profiled stretches can be read beside their trace.
``counters()`` is one flat snapshot of all of them, with the hand kernels' launch
counts (``tdal_torch.ops.conv3x3.launches``, ``fused_pointnet.launches``) under
prefixed names.

``summarize`` reads a profiler's Chrome trace back: for each program span its
occurrences, host time, device range, kernel launches and the device's idle time that
began inside it.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

from tdal_torch.ops import conv3x3, fused_pointnet

_NOOP = contextlib.nullcontext()
_LOCK = threading.Lock()
_host: dict = {}  # name -> int or float, every count
_traced: dict = {}  # name -> int or float, the counts made while a profiler records
_device: dict = {}  # name -> [tensor], ``count_device`` while a profiler records

# the first word of every program span's name: what ``summarize`` reads as the program's
SPAN_LAYERS = ("train", "predict", "optimizer", "dp", "model", "data")
OUTSIDE = "outside every span"
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def recording() -> bool:
    """Whether a torch profiler is recording (in any thread of the process)."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """``with span(name):`` a ``record_function`` range while a profiler records, else
    a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NOOP


def count(name: str, n=1):
    """Add the Python number ``n`` to the counter ``name``."""
    with _LOCK:
        _host[name] = _host.get(name, 0) + n
        if _profiler._is_profiler_enabled:
            _traced[name] = _traced.get(name, 0) + n


def count_device(name: str, t: torch.Tensor):
    """While a profiler records, keep the tensor ``t`` (summed when read) under
    ``traced.<name>``; otherwise keep nothing. Nothing waits for the device here."""
    if _profiler._is_profiler_enabled:
        with _LOCK:
            _device.setdefault(name, []).append(t.detach())


@contextlib.contextmanager
def timed(name: str):
    """``with timed(name):`` adds the body's host seconds to ``<name>.s`` and one to
    ``<name>.n`` (a body that raises counts nothing)."""
    t0 = time.perf_counter()
    yield
    count(f"{name}.s", time.perf_counter() - t0)
    count(f"{name}.n")


def counters() -> dict:
    """A flat snapshot: every host counter, ``traced.<name>`` for the counts made while a
    profiler recorded (device tensors summed, which waits for them), and the hand
    kernels' launches as ``conv3x3.launches.<op>``, ``conv3x3.halo_launches.<op>`` and
    ``fused_pointnet.launches.<op>``."""
    with _LOCK:
        out = dict(_host)
        out.update((f"traced.{k}", v) for k, v in _traced.items())
        device = {k: list(v) for k, v in _device.items()}
    for k, ts in device.items():
        total = torch.stack([t.sum() for t in ts]).sum()
        with _LOCK:  # keep the sum alone, so that a long recording holds one tensor a name
            _device[k][: len(ts)] = [total]
        v = total.item()
        out[f"traced.{k}"] = int(v) if not total.is_floating_point() else v
    for prefix, table in (("conv3x3.launches", conv3x3.launches),
                          ("conv3x3.halo_launches", conv3x3.halo_launches),
                          ("fused_pointnet.launches", fused_pointnet.launches)):
        out.update((f"{prefix}.{k}", v) for k, v in table.items())
    return out


# ---------------------------------------------------------------------------
# Reading a trace back
# ---------------------------------------------------------------------------


def _is_program_span(name: str) -> bool:
    return name.split(".", 1)[0] in SPAN_LAYERS and "." in name


def summarize(trace) -> dict:
    """A ``torch.profiler`` Chrome trace (a path, or its ``traceEvents``) -> ``{"spans":
    {name: {...}}, "idle_s": {name: s}, "idle_total_s": s}``.

    For each program span (a ``user_annotation`` named ``<layer>.<what>``, ``layer`` in
    ``SPAN_LAYERS``): ``n`` occurrences, ``host_s`` (their summed host durations),
    ``device_s`` (the summed device range of each occurrence: from the first start to
    the last end of the device work, matched to its launch by the trace's ``correlation``
    id, that was launched on any thread while the occurrence was open), ``launches``
    (the kernel launch calls made while it was open), ``annotated_s`` (the summed
    ``gpu_user_annotation`` ranges of the same name, the profiler's own device view).
    ``idle_s``: each gap between the device's busy intervals, its seconds under every
    program span open on the host when it began, or under ``OUTSIDE``."""
    events = trace
    if isinstance(trace, (str, Path)):
        events = json.loads(Path(trace).read_text())["traceEvents"]
    spans, calls, device, annotated = [], [], {}, {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and _is_program_span(name):
            spans.append((a, b, name))
        elif cat == "gpu_user_annotation" and _is_program_span(name):
            annotated[name] = annotated.get(name, 0.0) + (b - a) / 1e6
        elif cat in ("cuda_runtime", "cuda_driver"):
            calls.append((a, name, corr))
        elif cat in _DEVICE_CATS:
            device.setdefault(corr, []).append((a, b))
    spans.sort()
    calls.sort(key=lambda c: c[0])
    call_ts = [c[0] for c in calls]
    out = {}
    for a, b, name in spans:
        s = out.setdefault(name, dict(n=0, host_s=0.0, device_s=0.0, launches=0,
                                      annotated_s=annotated.get(name, 0.0)))
        s["n"] += 1
        s["host_s"] += (b - a) / 1e6
        lo, hi = bisect.bisect_left(call_ts, a), bisect.bisect_right(call_ts, b)
        first, last = float("inf"), float("-inf")
        for _, call, corr in calls[lo:hi]:
            s["launches"] += call in _LAUNCH_CALLS
            for da, db in device.get(corr, ()) if corr is not None else ():
                first, last = min(first, da), max(last, db)
        if last > first:
            s["device_s"] += (last - first) / 1e6
    busy = sorted(iv for ivs in device.values() for iv in ivs)
    gaps, reach = [], None
    for a, b in busy:
        if reach is not None and a > reach:
            gaps.append((reach, a))
        reach = b if reach is None else max(reach, b)
    # sweep: span starts, then gap starts, then span ends at equal times
    marks = sorted([(a, 0, n) for a, _, n in spans] + [(g0, 1, g1 - g0) for g0, g1 in gaps]
                   + [(b, 2, n) for _, b, n in spans], key=lambda m: (m[0], m[1]))
    open_, idle = {}, {}
    for _, kind, x in marks:
        if kind == 0:
            open_[x] = open_.get(x, 0) + 1
        elif kind == 2:
            open_[x] -= 1
        else:
            inside = [n for n, c in open_.items() if c > 0] or [OUTSIDE]
            for n in inside:
                idle[n] = idle.get(n, 0.0) + x / 1e6
    total = sum(g1 - g0 for g0, g1 in gaps) / 1e6
    return {"spans": out, "idle_s": idle, "idle_total_s": total}


def summary_lines(summary: dict) -> list:
    """``summarize``'s result as log lines, one a span, then the idle time by span."""
    lines = []
    for name, s in sorted(summary["spans"].items()):
        n = s["n"]
        lines.append(f"span {name}: {n} x, host {1e3 * s['host_s'] / n:.3f} ms, device "
                     f"{1e3 * s['device_s'] / n:.3f} ms, {s['launches'] / n:.1f} launches "
                     f"(each occurrence)")
    total = summary["idle_total_s"]
    if total > 0:
        parts = sorted(summary["idle_s"].items(), key=lambda kv: -kv[1])
        lines.append(f"device idle {1e3 * total:.3f} ms, began inside: " + ", ".join(
            f"{n} {1e3 * s:.3f} ms" for n, s in parts))
    return lines
