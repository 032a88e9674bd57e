"""Frames detected per second: the frames whose boxes reached the host in the window,
over the window's whole time (the last batch finished). Host clock."""


def read(run):
    r = run.readings
    if r.get("batches") is None:
        return None
    return r["frames"] / r["window_s"]
