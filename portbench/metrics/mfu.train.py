"""Model FLOP utilisation of training, in %: the forward FLOP of a frame (RPN, head and
PFN, from ``portbench/counts``) times 3 for the backward, times the frames trained,
over the window's time and the card's float32-operand peak (495 TFLOP/s, TF32 dense).
In a traced run, over the window's untraced rest."""

from portbench.counts.work import PEAK_FLOPS


def read(run):
    r = run.readings
    if not r.get("steps") or run.device.type != "cuda":
        return None
    frames, seconds = r.get("rest_frames", r["frames"]), r.get("rest_s", r["window_s"])
    if not frames:
        return None
    return 100.0 * 3 * r["fwd_flops_per_frame"] * frames / seconds / PEAK_FLOPS
