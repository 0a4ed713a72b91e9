"""Milliseconds of one pose-graph LM iteration of an incremental
reconstruction on the device: the ``deeparc.incremental.pose_graph``
spans' CUDA-event time over the sum of their ``iterations``, under the
``deeparc.incremental`` root."""

from portbench.spans import rooted


def read(rec):
    got = rooted("deeparc.incremental")
    if got is None:
        return None
    recs = got[1].get("deeparc.incremental.pose_graph", ())
    dev = [r["device_s"] for r in recs]
    its = sum(r["counts"].get("iterations", 0) for r in recs)
    if not dev or None in dev or not its:
        return None
    return 1e3 * sum(dev) / its
