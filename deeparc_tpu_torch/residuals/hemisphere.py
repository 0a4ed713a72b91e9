"""Hemisphere-radius prior residual (reference ``src/hemisphere_radius.hh:19-28``):
residual_i = |center - position_i|^2 - radius, so the fitted "radius" is the
mean SQUARED distance r^2 (kept for parity with the downstream cut)."""

from __future__ import annotations

import torch


def hemisphere_residuals(params: torch.Tensor,
                         camera_centers: torch.Tensor) -> torch.Tensor:
    """params = [cx, cy, cz, radius] (4,), camera_centers (C, 3) -> (C,)."""
    d2 = torch.sum((params[:3][None, :] - camera_centers) ** 2, dim=-1)
    return d2 - params[3]
