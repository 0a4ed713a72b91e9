"""``idle_unnamed_share`` over a profiled sub-window of whole pipelines;
the benchmark entry's own answer extraction is in no named range."""

from portbench.spans import unnamed_share


def read(rec):
    return unnamed_share(rec, "pipeline")
