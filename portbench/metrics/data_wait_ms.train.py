"""Host data: the mean ms the loop waited for its next batch from
``detection_batches`` (the port's prefetch thread), over the window. Host clock."""


def read(run):
    w = run.readings.get("waits")
    return 1e3 * sum(w) / len(w) if w else None
