"""Host data: the ms the port's loader took a frame to read its earlier sweeps, move
them into the frame and merge them (``read_points``' sweep loop, on the prefetch
thread), the mean over every frame the process loaded: the program's ``data.sweeps``
timer (``tdal_torch.runtime.tracing``), on the host's clock. None from a program without
the timer."""


def read(run):
    try:
        from tdal_torch.runtime import tracing
    except ImportError:  # a program without the port's counters
        return None
    c = tracing.counters()
    n = c.get("data.sweeps.n")
    return 1e3 * c["data.sweeps.s"] / n if n else None
