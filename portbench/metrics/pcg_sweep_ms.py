"""Milliseconds of one PCG iteration of the tile step on the device, in
whole traced solves: the ``deeparc.tiles.pcg`` spans' CUDA-event time
over the sum of their ``iterations``."""

from portbench.spans import device_ms_per


def read(rec):
    return device_ms_per("deeparc.tiles.pcg", lambda by: sum(
        r["counts"].get("iterations", 0)
        for r in by.get("deeparc.tiles.pcg", ())))
