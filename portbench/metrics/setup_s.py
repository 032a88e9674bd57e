"""Set-up seconds: from the start of the process to the start of the window (frames
made and written, the program built and loaded, the first steps or batches run;
in a checkout's first run, the kernels' build too). Host clock."""


def read(run):
    return run.readings.get("setup_s")
