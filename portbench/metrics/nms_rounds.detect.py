"""Decode and NMS: the greedy NMS's rounds a predict batch, each of which waits for
the device (``tdal_torch/core/nms.py``: a round per 32 live candidates, per frame and
task), over every batch the process predicted, set-up's included: the program's
``nms.rounds`` over its ``predict.steps`` (``tdal_torch.runtime.tracing``). None from
a program without those counters."""


def read(run):
    try:
        from tdal_torch.runtime import tracing
    except ImportError:  # a program without the port's counters
        return None
    c = tracing.counters()
    steps = c.get("predict.steps")
    return c["nms.rounds"] / steps if steps and "nms.rounds" in c else None
