from .adapter import map_pdf_to_opacity, posed_gaussian_adapter, unified_gaussian_adapter
from .decoder import DecoderOutput, render_gaussians
from .distiller import Dust3RTeacher
from .encoder import NoPoSplatMultiEncoder, Styl3rEncoder, Styl3rTokenStyleEncoder2View
from .registry import get_backbone, get_decoder, get_distiller, get_encoder, get_head
from .styl3r import Batch, Styl3rModel, batch_to, normalize_images, transpose_intrinsics

__all__ = [
    "map_pdf_to_opacity",
    "posed_gaussian_adapter",
    "unified_gaussian_adapter",
    "DecoderOutput",
    "render_gaussians",
    "Dust3RTeacher",
    "NoPoSplatMultiEncoder",
    "Styl3rEncoder",
    "Styl3rTokenStyleEncoder2View",
    "get_backbone",
    "get_decoder",
    "get_distiller",
    "get_encoder",
    "get_head",
    "Batch",
    "Styl3rModel",
    "batch_to",
    "normalize_images",
    "transpose_intrinsics",
]
