"""What the measurement entry points share: the widths of --tiny, the
compositor a run renders through (--impl), the serving model, and the
names of the device."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ..models.styl3r import Styl3rModel
from ..ops.rasterizer import composite
from .timing import card_line

# bench.py:103 and profile_stages.py's --tiny: the trunks cut, the heads at
# full width.
TINY = dict(enc_depth=2, dec_depth=4, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2)
# bench_train_step.py's --tiny: the heads cut too.
TINY_HEADS = dict(TINY, head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16))
# The model widths utils/flops.py reads.
FLOPS_DIMS = ("enc_depth", "dec_depth", "enc_dim", "dec_dim")


def flops_dims(dims: Dict[str, object]) -> Dict[str, object]:
    return {k: dims[k] for k in FLOPS_DIMS if k in dims}


def resolve_impl(impl: str, device: torch.device) -> str:
    """--impl of the JAX scripts on the port: "pallas" renders through the
    compositor kernels and needs the card, "jnp" through their plain
    versions; "auto" follows the device."""
    if impl == "auto":
        return "pallas" if device.type == "cuda" else "jnp"
    if impl == "pallas" and device.type != "cuda":
        raise RuntimeError("--impl pallas launches the compositor kernels and needs a CUDA device")
    return impl


@contextlib.contextmanager
def plain_compositor():
    """render_gaussians and its gradient through the plain versions on the
    card's tensors: composite_tiles and composite_backward are swapped for
    composite_tiles_plain and composite_backward_plain (no launch counted)."""
    saved = composite.composite_tiles, composite.composite_backward
    composite.composite_tiles = composite.composite_tiles_plain
    composite.composite_backward = lambda *args, max_per_tile: composite.composite_backward_plain(*args)
    try:
        yield
    finally:
        composite.composite_tiles, composite.composite_backward = saved


def route(impl: str):
    """The context a run of `impl` renders in: the plain compositor for
    "jnp" (a no-op on CPU tensors, which take it anyway)."""
    return plain_compositor() if impl == "jnp" else contextlib.nullcontext()


def route_name(impl: str) -> str:
    return "plain compositor" if impl == "jnp" else "compositor kernels"


def serving_model(device: torch.device, dims: Dict[str, object], keep_f32_params: bool = False) -> Styl3rModel:
    """bench.py's model: random weights from seed 0, sh degree 0, bf16
    backbone, stylizer and DPT trunks, stored in bf16 unless
    `keep_f32_params`."""
    model = Styl3rModel(sh_degree=0, backbone_dtype=torch.bfloat16, head_trunk_dtype=torch.bfloat16,
                        device=device, seed=0, **dims)
    return model if keep_f32_params else model.cast_dtypes()


def device_names(device: torch.device) -> Dict[str, Optional[str]]:
    """{"device": torch's name of it, "card": nvidia-smi's name and power
    limit (None on the CPU)}."""
    if device.type != "cuda":
        return {"device": "cpu", "card": None}
    return {"device": torch.cuda.get_device_name(device), "card": card_line()}


def no_tf32() -> None:
    """f32 stays f32 on the card: no TF32 in the f32 matmuls and convs (the
    heads' last layers, the renderer, VGG)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
