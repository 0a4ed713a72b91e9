"""Milliseconds of the grid step's Schur solve on the device per LM
iteration, in whole traced solves: the ``deeparc.grid.schur`` spans'
CUDA-event time (everything of the step's solve before its trial
evaluation) over the ``deeparc.lm.step`` count."""

from portbench.spans import device_ms_per


def read(rec):
    return device_ms_per("deeparc.grid.schur",
                         lambda by: len(by.get("deeparc.lm.step", ())))
