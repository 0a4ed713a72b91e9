"""The share of the device's idle time, over the profiled sub-window of
whole solves, that falls in no named host range of the profiler's trace
(``portbench/spans.py`` ``unnamed_share``): what the program's spans
leave unexplained. In the grid engine's cells."""

from portbench.spans import unnamed_share


def read(rec):
    return unnamed_share(rec, "solve")
