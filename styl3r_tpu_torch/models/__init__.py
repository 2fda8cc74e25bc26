from .decoder import DecoderOutput, render_gaussians
from .encoder import Styl3rEncoder
from .styl3r import Batch, Styl3rModel, batch_to, normalize_images, transpose_intrinsics

__all__ = [
    "DecoderOutput",
    "render_gaussians",
    "Styl3rEncoder",
    "Batch",
    "Styl3rModel",
    "batch_to",
    "normalize_images",
    "transpose_intrinsics",
]
