"""``linearize_roofline`` of the tile engine's cells (independent
cameras), whose linearize is ``linearize_tiles_mixed``: the same reading,
a metric of its own because these cells report ``solve_s.tiles``."""

from portbench.run import load_module

read = load_module("metrics", "linearize_roofline").read
