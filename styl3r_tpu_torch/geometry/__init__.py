from .gaussians import Gaussians, build_covariance, covariance_components, quat_to_rotmat
from .projection import get_fov, invert_se3
from .se3 import se3_exp, so3_exp

__all__ = [
    "Gaussians",
    "build_covariance",
    "covariance_components",
    "quat_to_rotmat",
    "get_fov",
    "invert_se3",
    "se3_exp",
    "so3_exp",
]
