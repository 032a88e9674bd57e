"""The sparse backbone's convs' share of their roofline in detection, in %: the least
time of every sparse conv of the frames detected (2 FLOP a pair, input channels and
output channels; features in and out and the weights once, from ``portbench/counts``;
the larger of FLOP / 495 TFLOP/s and bytes / 3.35 TB/s) over the backbone's time
(``backbone_ms.detect``) of those batches."""


def read(run):
    r = run.readings
    ms = r.get("backbone_ms")
    if not ms or len(ms) != r.get("batches"):
        return None
    return 100.0 * r["sparse_least_s"] / (sum(ms) / 1e3)
