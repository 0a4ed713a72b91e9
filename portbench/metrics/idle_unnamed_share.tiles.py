"""``idle_unnamed_share`` of the tile engine's cells: the same reading,
a metric of its own because these cells report ``solve_s.tiles``."""

from portbench.run import load_module

read = load_module("metrics", "idle_unnamed_share").read
