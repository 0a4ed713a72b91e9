"""Host milliseconds a batch of an incremental reconstruction spends
outside its LM loops on the batch's own set-up: the masked grid and the
free masks (``deeparc.incremental.mask``) and its solves' band prep
(``deeparc.grid.band_prep``, ``band_grid_update`` of the full mask's
prep), under the ``deeparc.incremental`` root, over its
``deeparc.incremental.batch`` spans."""

from portbench.spans import host_s, rooted


def read(rec):
    got = rooted("deeparc.incremental")
    if got is None:
        return None
    by_name = got[1]
    batches = by_name.get("deeparc.incremental.batch", ())
    recs = [r for name in ("deeparc.incremental.mask",
                           "deeparc.grid.band_prep")
            for r in by_name.get(name, ())]
    if not batches or not recs:
        return None
    return 1e3 * host_s(recs) / len(batches)
