from deeparc_tpu_torch.geometry.camera import (
    camera_center_composed,
    camera_center_single,
    hemisphere_camera_centers,
)
from deeparc_tpu_torch.geometry.projection import (
    CameraSlice,
    StructureMasks,
    project_observation,
    transform_point,
)
from deeparc_tpu_torch.geometry.rotation import (
    angle_axis_rotate,
    angle_axis_to_matrix,
    cross_matrix,
    matrix_to_angle_axis,
    quaternion_to_angle_axis,
    so3_right_jacobian,
)

__all__ = [
    "camera_center_composed", "camera_center_single",
    "hemisphere_camera_centers", "CameraSlice", "StructureMasks",
    "project_observation", "transform_point", "angle_axis_rotate",
    "angle_axis_to_matrix", "cross_matrix", "matrix_to_angle_axis",
    "quaternion_to_angle_axis", "so3_right_jacobian",
]
