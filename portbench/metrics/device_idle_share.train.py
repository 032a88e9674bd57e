"""The device's idle share in training, in %: 100 minus the device's busy seconds a step
(the union of its CUDA intervals in the window's traced stretch, over its steps) over
the untraced rest's seconds a step. The profiler slows the host in the stretch
itself, so its own wall time would count the profiler's gaps as the device's
(``common.Segment``)."""


def read(run):
    t = run.readings.get("trace")
    if not t or t["device_events"] == 0 or t["busy_over_untraced"] is None:
        return None
    return 100.0 * (1.0 - t["busy_over_untraced"])
