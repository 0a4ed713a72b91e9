from deeparc_tpu_torch.residuals.hemisphere import hemisphere_residuals
from deeparc_tpu_torch.residuals.reprojection import (
    cost,
    flatten_camera,
    residuals,
    unflatten_camera,
)

__all__ = ["hemisphere_residuals", "cost", "flatten_camera", "residuals",
           "unflatten_camera"]
