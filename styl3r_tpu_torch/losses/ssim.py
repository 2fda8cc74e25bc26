"""SSIM with an 11x11 Gaussian window, for the eval metrics (counterpart of
styl3r_tpu/losses/ssim.py::ssim; reference `src/loss/loss_ssim.py`,
`src/evaluation/metrics.py:33-53`)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2d(img: Tensor, kernel: Tensor) -> Tensor:
    """Depthwise 2D filter of (n, h, w, c) images, VALID padding."""
    n, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    out = F.conv2d(x, kernel[None, None])
    return out.reshape(n, c, *out.shape[-2:]).permute(0, 2, 3, 1)


def ssim(
    img1: Tensor,
    img2: Tensor,
    max_val: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
    return_map: bool = False,
) -> Tensor:
    """SSIM of (n, h, w, c) images, one value an image (or of (h, w, c)
    images, one value)."""
    squeeze = img1.ndim == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    kernel = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(img1.device, img1.dtype)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu1 = _filter2d(img1, kernel)
    mu2 = _filter2d(img2, kernel)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(img1 * img1, kernel) - mu1_sq
    sigma2_sq = _filter2d(img2 * img2, kernel) - mu2_sq
    sigma12 = _filter2d(img1 * img2, kernel) - mu12

    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    if return_map:
        return ssim_map[0] if squeeze else ssim_map
    out = ssim_map.mean(dim=(1, 2, 3))
    return out[0] if squeeze else out
