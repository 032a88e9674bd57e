"""The second stage's device ms a batch: the summed device time of the kernels launched
while one of the program's ``two_stage.*`` spans was open (the five-point BEV gather,
the RoI head, the rescoring; ``tdal_torch/pipeline/two_stage_engine.py``), over the
traced batches, read from the traced stretch's profiler trace. None from a program
without those spans."""


def read(run):
    return run.readings.get("second_stage_ms")
