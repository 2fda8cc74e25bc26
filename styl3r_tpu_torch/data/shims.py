"""Host-side image/camera shims (counterpart of styl3r_tpu/data/shims.py;
reference `src/dataset/shims/`): numpy arrays, PIL for the resize.

  * rescale, center_crop, rescale_and_crop with the intrinsics fixup
    (crop_shim.py:12-76);
  * the x-flip augmentation with the extrinsics' reflection
    (augmentation_shim.py:9-38) and the style image's resize and crop
    (augmentation_shim.py:40-62);
  * normalize_to_unit, the depth bounds and the random patch crop
    (normalize_shim.py, bounds_shim.py:41-80, patch_shim.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .types import Example, Views


def rescale(image: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """(h, w, 3) float [0, 1] -> LANCZOS resize to shape, through 8 bits.
    PIL returns a copy when the size is unchanged, so the 8-bit rounding
    applies either way."""
    from PIL import Image

    h, w = shape
    as_uint8 = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    resized = Image.fromarray(as_uint8).resize((w, h), Image.LANCZOS)
    return np.asarray(resized, dtype=np.float32) / 255.0


def center_crop(
    images: np.ndarray, intrinsics: np.ndarray, shape: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """(v, h, w, 3) images + (v, 3, 3) normalized K -> cropped images + K."""
    h_in, w_in = images.shape[1:3]
    h_out, w_out = shape
    row = (h_in - h_out) // 2
    col = (w_in - w_out) // 2
    images = images[:, row : row + h_out, col : col + w_out]
    intrinsics = intrinsics.copy()
    intrinsics[:, 0, 0] *= w_in / w_out
    intrinsics[:, 1, 1] *= h_in / h_out
    return images, intrinsics


def rescale_and_crop(
    images: np.ndarray, intrinsics: np.ndarray, shape: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Resize so the image covers `shape`, then center-crop to it."""
    h_in, w_in = images.shape[1:3]
    h_out, w_out = shape
    if h_out > h_in or w_out > w_in:
        raise ValueError(f"cannot upscale {images.shape[1:3]} -> {shape}")
    scale = max(h_out / h_in, w_out / w_in)
    h_scaled = round(h_in * scale)
    w_scaled = round(w_in * scale)
    images = np.stack([rescale(im, (h_scaled, w_scaled)) for im in images])
    return center_crop(images, intrinsics, shape)


def prepare_style_image(image: np.ndarray, size: int = 256) -> np.ndarray:
    """Resize the short side to `size`, then center-crop to size x size (the
    reference does so at train and test time alike)."""
    h, w = image.shape[:2]
    if h < w:
        new_h, new_w = size, int(round(w / h * size))
    else:
        new_h, new_w = int(round(h / w * size)), size
    image = rescale(image, (new_h, new_w))
    row = (new_h - size) // 2
    col = (new_w - size) // 2
    return image[row : row + size, col : col + size]


def reflect_extrinsics(extrinsics: np.ndarray) -> np.ndarray:
    """c2w poses of the x-mirrored scene."""
    reflect = np.eye(4, dtype=np.float32)
    reflect[0, 0] = -1
    return reflect @ extrinsics @ reflect


def _reflect_views(views: Views) -> Views:
    return Views(
        extrinsics=reflect_extrinsics(views.extrinsics),
        intrinsics=views.intrinsics,
        image=views.image[:, :, ::-1].copy(),
        near=views.near,
        far=views.far,
        index=views.index,
        overlap=views.overlap,
    )


def apply_augmentation(example: Example, rng: np.random.Generator) -> Example:
    """With probability 1/2, flip every view horizontally and reflect the
    extrinsics (one draw from `rng`)."""
    if rng.random() < 0.5:
        return example
    return Example(
        context=_reflect_views(example.context),
        target=_reflect_views(example.target),
        scene=example.scene,
        style_image=example.style_image,
        style_name=example.style_name,
    )


def normalize_to_unit(images: np.ndarray) -> np.ndarray:
    """[0, 1] -> [-1, 1] (mean and std 0.5)."""
    return images * 2.0 - 1.0


def compute_depth_bounds(
    extrinsics: np.ndarray, near_disparity: float = 25.0, far_disparity: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Near/far planes from the mean distance between consecutive cameras
    (bounds_shim.py:41-80). The dataset keeps its fixed near 0.1 and far 100,
    as the reference's configs do."""
    origins = extrinsics[:, :3, 3]
    n = len(origins)
    if n < 2:
        baseline = 1.0
    else:
        deltas = origins[1:] - origins[:-1]
        baseline = max(float(np.linalg.norm(deltas, axis=-1).mean()), 1e-6)
    near = np.full((n,), baseline / near_disparity, np.float32)
    far = np.full((n,), baseline / far_disparity, np.float32)
    return near, far


def random_patch_crop(
    image: np.ndarray, intrinsics: np.ndarray, patch: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """A random patch x patch crop of (h, w, 3) and its normalized K: the
    focal lengths scaled, the principal point moved into the patch."""
    h, w = image.shape[:2]
    row = int(rng.integers(0, h - patch + 1))
    col = int(rng.integers(0, w - patch + 1))
    out = image[row : row + patch, col : col + patch]
    k = intrinsics.copy()
    k[0, 0] *= w / patch
    k[1, 1] *= h / patch
    k[0, 2] = (k[0, 2] * w - col) / patch
    k[1, 2] = (k[1, 2] * h - row) / patch
    return out, k
