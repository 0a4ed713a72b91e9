"""Host milliseconds a batch of an incremental reconstruction spends
capturing its new pose-graph edges and their measurements
(``deeparc.incremental.edges``), under the ``deeparc.incremental`` root,
over its ``deeparc.incremental.batch`` spans."""

from portbench.spans import host_s, rooted


def read(rec):
    got = rooted("deeparc.incremental")
    if got is None:
        return None
    by_name = got[1]
    batches = by_name.get("deeparc.incremental.batch", ())
    edges = by_name.get("deeparc.incremental.edges", ())
    if not batches or not edges:
        return None
    return 1e3 * host_s(edges) / len(batches)
