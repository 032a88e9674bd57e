"""The sparse backbone's gather fill, in %: of the rows its forward tables gather (K
taps x every row of the fixed voxel buffer, valid or not), the share that are real
neighbour pairs, over the batches the profiler recorded (the traced stretch and the
set-up batch that warms the profiler): 100 x the program's ``traced.sparse.pairs``
over ``traced.sparse.rows_gathered`` (``tdal_torch.runtime.tracing``). The rest is
what compacting the buffer would save. None from a program without those counters."""


def read(run):
    try:
        from tdal_torch.runtime import tracing
    except ImportError:  # a program without the port's counters
        return None
    c = tracing.counters()
    rows = c.get("traced.sparse.rows_gathered")
    pairs = c.get("traced.sparse.pairs")
    return 100.0 * pairs / rows if rows and pairs is not None else None
