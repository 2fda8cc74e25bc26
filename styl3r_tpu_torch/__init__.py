"""styl3r_tpu_torch: the PyTorch/CUDA port of styl3r_tpu.

Feed-forward stylized 3D Gaussian splatting on an NVIDIA H100. The package
mirrors the layout of `styl3r_tpu` (geometry/, ops/, ops/rasterizer/,
models/, utils/) and keeps its public array layouts (NHWC images in [0, 1],
c2w extrinsics, normalized intrinsics, xyzw quaternions), so the same numpy
arrays feed both. Hand-written CUDA kernels live under `csrc/` and are built
with nvcc at first use.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
