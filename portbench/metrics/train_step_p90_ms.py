"""The 90th percentile of the window's step intervals, in ms: CUDA events recorded
after each step's update (and one at the window's start), read once the window has
closed."""

from portbench.common import quantile


def read(run):
    ms = run.readings.get("step_ms")
    return quantile(ms, 0.9) if ms else None
