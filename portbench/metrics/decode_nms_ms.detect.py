"""Decode + NMS ms a batch: from a CUDA event at the end of the model's forward (a
forward hook) to one recorded once the batch's boxes are on the host."""


def read(run):
    ms = run.readings.get("decode_nms_ms")
    return sum(ms) / len(ms) if ms else None
