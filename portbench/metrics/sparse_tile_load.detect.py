"""The sparse backbone's tile load, in %: of the (tile, tap)s of its forward tables (K
taps x each tile of rows of the padded table that the gather-GEMM kernel walks, valid
or not), the share that some row of the tile finds, which the kernel loads, over the
batches the profiler recorded: 100 x the program's ``traced.sparse.tile_taps_loaded``
over ``traced.sparse.tile_taps`` (``tdal_torch.runtime.tracing``). The rest is what the
kernel's two skips (rows past a sample's occupied count, taps that no row of a tile
finds) leave out. None from a program without those counters."""


def read(run):
    try:
        from tdal_torch.runtime import tracing
    except ImportError:  # a program without the port's counters
        return None
    c = tracing.counters()
    tiles = c.get("traced.sparse.tile_taps")
    loaded = c.get("traced.sparse.tile_taps_loaded")
    return 100.0 * loaded / tiles if tiles and loaded is not None else None
