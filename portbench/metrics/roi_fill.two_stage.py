"""The second stage's fill, in %: of the RoI rows it runs (``NMS_POST_MAXSIZE`` a frame,
valid or not), the share that carry a first-stage box, over the batches the profiler
recorded (the traced stretch and the set-up batch that warms the profiler): 100 x the
program's ``traced.two_stage.rois_valid`` over ``traced.two_stage.rois``
(``tdal_torch.runtime.tracing``). None from a program without those counters."""


def read(run):
    try:
        from tdal_torch.runtime import tracing
    except ImportError:  # a program without the port's counters
        return None
    c = tracing.counters()
    rows = c.get("traced.two_stage.rois")
    valid = c.get("traced.two_stage.rois_valid")
    return 100.0 * valid / rows if rows and valid is not None else None
