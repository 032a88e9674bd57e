"""Model FLOP utilisation of detection, in %: the dense FLOP of the RPN and head and the
sparse backbone's pairs-based FLOP of each frame detected (``portbench/counts``), over
the window's time and the card's float32-operand peak (495 TFLOP/s, TF32 dense).
In a traced run, over the window's untraced rest."""

from portbench.counts.work import PEAK_FLOPS


def read(run):
    r = run.readings
    if not r.get("batches") or run.device.type != "cuda":
        return None
    return 100.0 * r["model_flops"] / r["model_flops_s"] / PEAK_FLOPS
