"""Host seconds a traced pipeline spends in its filter rounds outside
the solves (``deeparc.pipeline.filter`` + ``.sync``: the outlier masks,
their counts, the masks back onto the scene), per pipeline."""

from portbench.spans import per_root_s


def read(rec):
    return per_root_s("deeparc.pipeline", ("deeparc.pipeline.filter",
                                           "deeparc.pipeline.sync"))
