"""Solvers: robust losses, trust region, small linear algebra and PCG,
dense LM, the indexed engine (``ba``, ``schur``), the grid engine
(``rig_grid``) with its live-band prep (``rig_band``), and the tile engine
(``tiles``)."""
