"""Frames trained per second: every frame of every step the window ran, over the
window's whole time, from its start to the card's end of the last step. Host clock."""


def read(run):
    r = run.readings
    if r.get("steps") is None:
        return None
    return r["frames"] / r["window_s"]
