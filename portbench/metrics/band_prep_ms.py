"""Host milliseconds of the grid engine's band prep
(``deeparc.grid.band_prep``: ``band_grid``, or ``band_grid_update`` with
a caller's ``band_reuse``) per whole traced solve."""

from portbench.spans import per_root_s


def read(rec):
    s = per_root_s("deeparc.solve", ("deeparc.grid.band_prep",))
    return None if s is None else s * 1e3
