"""The hand conv kernels' (K3-K7) share of their roofline in PointPillars training, in
%: the least time of their launches in the profiled steps (each launch the larger of
FLOP / 495 TFLOP/s and bytes / 3.35 TB/s, from the sites' shapes in
``portbench/counts``) over the device time of the kernels by name in the trace
(``conv3x3_kernel``, ``wgrad_kernel`` and their ``*_reduce_kernel`` steps). Silent
where the launches counted by ``tdal_torch.ops.conv3x3.launches`` over the profiled
steps differ from the sites' count."""

from collections import Counter

from portbench.counts.work import least_seconds

NAMES = ("conv3x3_kernel", "wgrad_kernel", "stats_reduce_kernel", "wgrad_reduce_kernel")


def read(run):
    r = run.readings
    t, n = r.get("trace"), r.get("traced_steps")
    if not t or not n or not t["device_events"]:
        return None
    per_step = r["conv3x3_per_step"]
    want = Counter(k for k, _, _ in per_step)
    if any(r["trace_launches"].get(k, 0) != want[k] * n for k in want):
        return None
    device_s = sum(s for name, s in t["by_name"].items() if any(k in name for k in NAMES))
    if device_s <= 0:
        return None
    least = n * sum(least_seconds(f, b)[0] for _, f, b in per_step)
    return 100.0 * least / device_s
