"""Host data: the ms the port's prefetch thread took to build a batch (its frames' loading
and the collate), the mean over every batch the process built, set-up's and those built
ahead of the window's end included: the program's own ``data.batch`` timer
(``tdal_torch.runtime.tracing``), on the host's clock. The loop waits for it
(``data_wait_ms.detect``) only where it outlasts a batch. None from a program without
the timer."""


def read(run):
    try:
        from tdal_torch.runtime import tracing
    except ImportError:  # a program without the port's counters
        return None
    c = tracing.counters()
    n = c.get("data.batch.n")
    return 1e3 * c["data.batch.s"] / n if n else None
