from .basic import mse_loss
from .lpips import LPIPSVgg16, convert_lpips_state
from .regr3d import normalize_pointcloud_avg_dis, regr3d_loss
from .ssim import ssim
from .style import calc_mean_std, identity_loss, style_loss
from .vgg import VGG19Features, imagenet_normalize

__all__ = [
    "mse_loss",
    "LPIPSVgg16",
    "convert_lpips_state",
    "normalize_pointcloud_avg_dis",
    "regr3d_loss",
    "ssim",
    "calc_mean_std",
    "identity_loss",
    "style_loss",
    "VGG19Features",
    "imagenet_normalize",
]
