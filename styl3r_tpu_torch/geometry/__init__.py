from .gaussians import Gaussians, build_covariance, covariance_components, quat_to_rotmat
from .projection import get_fov, invert_se3
from .ptc_geometry import (
    depthmap_to_absolute_camera_coordinates,
    depthmap_to_camera_coordinates,
    geotrf,
    get_joint_pointcloud_center_scale,
    get_joint_pointcloud_depth,
    normalize_pointcloud,
)
from .se3 import camera_normalization, se3_exp, so3_exp, update_pose

__all__ = [
    "Gaussians",
    "build_covariance",
    "covariance_components",
    "quat_to_rotmat",
    "get_fov",
    "invert_se3",
    "depthmap_to_absolute_camera_coordinates",
    "depthmap_to_camera_coordinates",
    "geotrf",
    "get_joint_pointcloud_center_scale",
    "get_joint_pointcloud_depth",
    "normalize_pointcloud",
    "camera_normalization",
    "se3_exp",
    "so3_exp",
    "update_pose",
]
