"""Data parallelism over ``torch.distributed`` (``mesh``) and the two wrong steps that
check it (``controls``). The per-sequence fan-out of the offboard stages is
``tdal_torch.pipeline.shard``."""
