"""SSIM with an 11x11 Gaussian window, for the eval metrics and the
photometric pose refinement, and its multi-scale form (counterpart of
styl3r_tpu/losses/ssim.py; reference `src/loss/loss_ssim.py`,
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


def _ssim_cs_per_channel(img1: Tensor, img2: Tensor, kernel: Tensor, c1: float, c2: float):
    """Per-channel SSIM and contrast-sensitivity means, each (n, c)
    (reference _ssim, loss_ssim.py:58-128, size_average=False)."""
    mu1 = _filter2d(img1, kernel)
    mu2 = _filter2d(img2, kernel)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(img1 * img1, kernel) - mu1_sq
    sigma2_sq = _filter2d(img2 * img2, kernel) - mu2_sq
    sigma12 = _filter2d(img1 * img2, kernel) - mu12
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2)), cs_map.mean(dim=(1, 2))


def _avg_pool2_pad(x: Tensor) -> Tensor:
    """torch's avg_pool2d(kernel 2, padding h%2 / w%2, count_include_pad) on
    NHWC, the reference's downsampling between levels."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, padding=(x.shape[1] % 2, x.shape[2] % 2))
    return out.permute(0, 2, 3, 1)


def ms_ssim(
    img1: Tensor,
    img2: Tensor,
    max_val: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
    weights=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    size_average: bool = True,
) -> Tensor:
    """Multi-scale SSIM of (n, h, w, c) images (or one (h, w, c) pair), as
    the reference's `ms_ssim` (loss_ssim.py:190-271) means it: 5 dyadic
    levels, the relu'd cs of the coarse levels and the relu'd ssim of the
    last, combined as a weighted product and averaged over channels.
    Requires min(h, w) > (window_size - 1) * 16."""
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    if min(img1.shape[1:3]) <= (window_size - 1) * 16:
        raise ValueError(
            f"image {tuple(img1.shape[1:3])} too small for {len(weights)}-level ms-ssim with window {window_size}"
        )
    kernel = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(img1.device, img1.dtype)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mcs = []
    for level in range(len(weights)):
        ssim_pc, cs_pc = _ssim_cs_per_channel(img1, img2, kernel, c1, c2)
        if level < len(weights) - 1:
            mcs.append(torch.relu(cs_pc))
            img1, img2 = _avg_pool2_pad(img1), _avg_pool2_pad(img2)
    stack = torch.stack(mcs + [torch.relu(ssim_pc)], dim=0)  # (levels, n, c)
    w = torch.tensor(weights, dtype=stack.dtype, device=stack.device)[:, None, None]
    val = torch.prod(stack**w, dim=0).mean(dim=-1)  # (n,)
    return val.mean() if size_average else val
