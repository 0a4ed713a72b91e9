"""Host seconds a traced pipeline spends loading the scene and building
its solver layout (``deeparc.pipeline.load`` + ``.layout``: the scene on
the card, the dense grid), per pipeline."""

from portbench.spans import per_root_s


def read(rec):
    return per_root_s("deeparc.pipeline", ("deeparc.pipeline.load",
                                           "deeparc.pipeline.layout"))
