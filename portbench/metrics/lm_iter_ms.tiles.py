"""``lm_iter_ms`` of the tile engine's cells (independent cameras):
the same reading, a metric of its own because these cells report
``solve_s.tiles``."""

from portbench.run import load_module

read = load_module("metrics", "lm_iter_ms").read
