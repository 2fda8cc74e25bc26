from .camera import RasterCamera, make_raster_camera
from .project import ProjectedGaussians, eval_sh, project_gaussians
from .render import RenderOutput, render, render_many

__all__ = [
    "RasterCamera",
    "make_raster_camera",
    "ProjectedGaussians",
    "eval_sh",
    "project_gaussians",
    "RenderOutput",
    "render",
    "render_many",
]
