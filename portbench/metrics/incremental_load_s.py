"""Host seconds an incremental reconstruction spends before its first
batch: the scene on the card (``deeparc.incremental.load``), the dense
grid (``.layout``), the BFS order over cell covisibility (``.order``) and
the band prep of the full mask (``.band``), per reconstruction."""

from portbench.spans import per_root_s


def read(rec):
    return per_root_s("deeparc.incremental", (
        "deeparc.incremental.load", "deeparc.incremental.layout",
        "deeparc.incremental.order", "deeparc.incremental.band"))
