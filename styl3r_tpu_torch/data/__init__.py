"""Host-side data: chunked RE10K-style scenes, view samplers, shims, the
streaming dataset and its batches (counterpart of styl3r_tpu/data/), plus
the COLMAP readers of the inference entry points. numpy arrays in the JAX
package's layouts."""

from .chunks import convert_poses_re10k, iter_chunk_examples, list_chunks, load_chunk, load_index
from .dataset import DatasetConfig, RE10kStyleDataset, batch_iterator, collate_examples
from .shims import (
    apply_augmentation,
    center_crop,
    normalize_to_unit,
    prepare_style_image,
    rescale,
    rescale_and_crop,
)
from .types import Example, Stage, Views
from .view_samplers import (
    ViewSamplerAll,
    ViewSamplerArbitrary,
    ViewSamplerBounded,
    ViewSamplerEvaluation,
    make_view_sampler,
)

__all__ = [
    "Example",
    "Views",
    "Stage",
    "iter_chunk_examples",
    "list_chunks",
    "load_chunk",
    "load_index",
    "convert_poses_re10k",
    "ViewSamplerAll",
    "ViewSamplerArbitrary",
    "ViewSamplerBounded",
    "ViewSamplerEvaluation",
    "make_view_sampler",
    "apply_augmentation",
    "center_crop",
    "normalize_to_unit",
    "prepare_style_image",
    "rescale",
    "rescale_and_crop",
    "RE10kStyleDataset",
    "DatasetConfig",
    "collate_examples",
    "batch_iterator",
]
