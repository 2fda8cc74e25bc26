from .gaussians import Gaussians, build_covariance, covariance_components, quat_to_rotmat
from .projection import get_fov, invert_se3
from .se3 import camera_normalization, se3_exp, so3_exp, update_pose

__all__ = [
    "Gaussians",
    "build_covariance",
    "covariance_components",
    "quat_to_rotmat",
    "get_fov",
    "invert_se3",
    "camera_normalization",
    "se3_exp",
    "so3_exp",
    "update_pose",
]
