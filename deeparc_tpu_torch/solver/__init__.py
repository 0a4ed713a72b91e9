"""Solvers: robust losses, trust region, small linear algebra, dense LM,
and the grid engine (``rig_grid``) with its live-band prep (``rig_band``)."""
