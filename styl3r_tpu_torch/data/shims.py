"""Host-side image/camera shims (counterpart of the inference part of
styl3r_tpu/data/shims.py; reference `src/dataset/shims/crop_shim.py:12-76`,
`augmentation_shim.py:40-62`): numpy arrays, PIL for the resize."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
