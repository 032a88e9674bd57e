"""The device's idle share in detection, in %: 100 minus the device's busy seconds a batch
(the union of its CUDA intervals in the window's traced stretch, over its batchs) over
the untraced rest's seconds a batch. The profiler slows the host in the stretch
itself, so its own wall time would count the profiler's gaps as the device's
(``common.Segment``)."""


def read(run):
    t = run.readings.get("trace")
    if not t or t["device_events"] == 0 or t["busy_over_untraced"] is None:
        return None
    return 100.0 * (1.0 - t["busy_over_untraced"])
