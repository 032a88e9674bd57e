"""The sparse middle backbone's ms a batch in detection: CUDA events in a forward
pre-hook and a forward hook on ``model.backbone``, every batch of the window."""


def read(run):
    ms = run.readings.get("backbone_ms")
    return sum(ms) / len(ms) if ms else None
