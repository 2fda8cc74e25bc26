"""The encoders: unposed context images (+ a style image) -> 3D Gaussians
(counterpart of styl3r_tpu/models/encoder.py).

  * Styl3rEncoder, the production encoder (reference
    `encoder_noposplat_multi_token_style.py:46-263`): view 0 goes through
    head1 / gaussian_param_head, views 1.. are folded into the batch for
    head2 / gaussian_param_head2, as in the JAX encoder;
  * Styl3rTokenStyleEncoder2View, the 2-view token-style encoder
    (`encoder_noposplat_token_style.py:150-283`);
  * NoPoSplatMultiEncoder, the style-free N-view encoder
    (`encoder_noposplat_multi.py:126-233`).

Each module keeps the reference's key names (`downstream_head1`, ...).

Styl3rEncoder replays an inference forward from CUDA graphs. Where
`graph_engages` holds (CUDA inputs, eval mode, no grad, no dropout
generator, no aux outputs, the whole forward), the first call of an input
signature (`graph_key`) runs eagerly on a side stream, the second captures
one graph a span segment (backbone, heads, stylizer, heads, adapter) in one
memory pool, and each later call copies its inputs into the graphs' own,
replays the segments, each inside its span, and returns clones of the
Gaussians. A replay is a handful of host calls in place of the forward's
~2,800 launches, and runs the same kernels on the same data.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch import Tensor

from ..geometry.gaussians import Gaussians
from ..utils import trace
from ..utils.cuda_build import KERNELS
from .adapter import d_sh, map_pdf_to_opacity, opacity_exponent, raw_gaussian_channels, unified_gaussian_adapter
from .croco import CrocoEncBackbone, MultiViewCrocoBackbone, StructureBuilder, TokenStylizer
from .dpt import DPTGSHead, DPTGSSHHead, DPTPts3dHead
from .precision import compute_in


def _head_dims(enc_dim, dec_dim, dec_depth, head_feature_dim, head_layer_dims, patch_size, head_trunk_dtype):
    """The DPT heads' shared arguments: hooks [0, l/2, 3l/4, l] over the
    (dec_depth + 1)-level pyramid, whose level 0 is the encoder's tokens."""
    l2 = dec_depth
    return dict(
        hook_dims=(enc_dim, dec_dim, dec_dim, dec_dim),
        hooks=(0, l2 * 2 // 4, l2 * 3 // 4, l2),
        feature_dim=head_feature_dim,
        layer_dims=head_layer_dims,
        patch_size=patch_size,
        trunk_dtype=head_trunk_dtype,
    )


def _adapt(raw: Tensor, pts: Tensor, encoder: nn.Module, global_step: int, return_aux: bool):
    """Raw (b, v, h, w, 1 + channels) head outputs and (b, v, h, w, 3) points
    -> Gaussians through the unified adapter (+ the aux dict). The caller
    opens the `adapter` span."""
    b, v, h, w, _ = raw.shape
    densities = torch.sigmoid(raw[..., 0])
    opacities = map_pdf_to_opacity(
        densities, global_step, encoder.opacity_initial, encoder.opacity_final, encoder.opacity_warm_up,
    )
    gaussians = unified_gaussian_adapter(
        means=pts.reshape(b, v * h * w, 3),
        opacities=opacities.reshape(b, v * h * w),
        raw=raw[..., 1:].reshape(b, v * h * w, -1),
        sh_degree=encoder.sh_degree,
    )
    if return_aux:
        return gaussians, {"pts3d": pts, "depths": pts[..., 2], "densities": densities}
    return gaussians


GRAPH_SIGNATURES = 4  # the input signatures whose graphs a Styl3rEncoder keeps, the most recent


def graph_engages(training: bool, grad_enabled: bool, inputs: Sequence[Tensor], return_aux: bool,
                  generator: Optional[torch.Generator], distill_only: bool) -> bool:
    """Whether Styl3rEncoder.forward runs from CUDA graphs: an inference
    forward (eval mode, grad off) of CUDA inputs that draws no dropout and
    returns the Gaussians alone."""
    return (not training and not grad_enabled and generator is None and not return_aux and not distill_only
            and all(t.is_cuda for t in inputs))


def graph_key(inputs: Sequence[Tensor], transpose_maps: bool, exponent: float) -> tuple:
    """What the forward's Python decides on besides the weights: each
    input's shape, strides, dtype and device; `transpose_maps`; inference
    mode (an inference tensor is written only inside it); autocast on the
    inputs' device; the flags that pick kernels (TF32 in cuDNN and in
    matmuls, the matmul precision, SDPA's fused backends, cuDNN's); and the
    opacity warm-up's exponent (1 at every step of the release config)."""
    device = inputs[0].device.type
    cudnn, cuda = torch.backends.cudnn, torch.backends.cuda
    return (
        tuple((t.shape, t.stride(), t.dtype, t.device) for t in inputs), transpose_maps,
        torch.is_inference_mode_enabled(), torch.is_autocast_enabled(device), torch.get_autocast_dtype(device),
        cudnn.allow_tf32, cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
        cuda.flash_sdp_enabled(), cuda.mem_efficient_sdp_enabled(), cuda.cudnn_sdp_enabled(),
        cudnn.enabled, cudnn.benchmark, cudnn.deterministic, exponent,
    )


_side_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream a device's graphs are captured on, and warmed up on."""
    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(device)
    return stream


@contextlib.contextmanager
def _on_side_stream(device: torch.device):
    """Runs the scope's work on the side stream, after the current stream's
    work so far and before its work to come."""
    current, side = torch.cuda.current_stream(device), _side_stream(device)
    side.wait_stream(current)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        current.wait_stream(side)


class _Graph(NamedTuple):
    """One signature's captured forward: the inputs its graphs read, its
    segments (span name, graph) in order, the Gaussians they write, and the
    kernel launches a forward counts."""

    inputs: Tuple[Tensor, ...]
    segments: List[Tuple[str, torch.cuda.CUDAGraph]]
    outputs: Gaussians
    launches: Dict[str, int]

    def replay(self, inputs: Sequence[Tensor]) -> Gaussians:
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        for name, graph in self.segments:
            with trace.span(name):
                graph.replay()
        for name, n in self.launches.items():
            trace.count(name, n)
        # Clones: the next replay overwrites the graphs' own.
        return Gaussians(*(None if t is None else t.clone() for t in self.outputs))


class _Graphs(OrderedDict):
    """A Styl3rEncoder's graphs by graph_key, the most recently used last;
    None for a signature seen once. Copies and pickles start empty."""

    def __reduce__(self):
        return _Graphs, ()


class Styl3rEncoder(nn.Module):
    """Structure branch: multiview backbone -> pts3d heads + dpt_gs heads.
    Appearance branch: token stylizer -> dpt_gs_sh head. The channel groups
    concat into the unified Gaussian adapter.

    `backbone_dtype` and `head_trunk_dtype` are compute dtypes, as in flax:
    the weights stay f32 and are cast at use (models/precision.py), which
    training needs. Serving may store them in those dtypes with
    `cast_dtypes()`, as bench.py does."""

    def __init__(
        self,
        sh_degree: int = 0,
        patch_size: int = 16,
        opacity_initial: float = 0.0,
        opacity_final: float = 0.0,
        opacity_warm_up: int = 1,
        backbone_dtype: torch.dtype = torch.float32,
        head_trunk_dtype: Optional[torch.dtype] = None,
        enc_depth: int = 24,
        dec_depth: int = 12,
        enc_dim: int = 1024,
        dec_dim: int = 768,
        enc_heads: int = 16,
        dec_heads: int = 12,
        head_feature_dim: int = 256,
        head_last_dim: int = 128,
        head_layer_dims: tuple = (96, 192, 384, 768),
        pts3d_bound: Optional[float] = None,
    ):
        super().__init__()
        self.sh_degree = sh_degree
        self.opacity_initial = opacity_initial
        self.opacity_final = opacity_final
        self.opacity_warm_up = opacity_warm_up
        self.backbone_dtype = backbone_dtype
        self.head_trunk_dtype = head_trunk_dtype
        dims = dict(
            enc_depth=enc_depth, dec_depth=dec_depth, enc_dim=enc_dim,
            dec_dim=dec_dim, enc_heads=enc_heads, dec_heads=dec_heads,
        )
        self.backbone = MultiViewCrocoBackbone(patch_size=patch_size, **dims)
        self.token_stylizer = TokenStylizer(patch_size=patch_size, **dims)
        head_dims = _head_dims(
            enc_dim, dec_dim, dec_depth, head_feature_dim, head_layer_dims, patch_size, head_trunk_dtype
        )
        self.downstream_head1 = DPTPts3dHead(last_dim=head_last_dim, pts3d_bound=pts3d_bound, **head_dims)
        self.downstream_head2 = DPTPts3dHead(last_dim=head_last_dim, pts3d_bound=pts3d_bound, **head_dims)
        structure_channels = 1 + raw_gaussian_channels(sh_degree) - 3 * d_sh(sh_degree)
        self.gaussian_param_head = DPTGSHead(out_channels=structure_channels, **head_dims)
        self.gaussian_param_head2 = DPTGSHead(out_channels=structure_channels, **head_dims)
        self.gaussian_appearance_head = DPTGSSHHead(out_channels=3 * d_sh(sh_degree), **head_dims)
        self._graphs = _Graphs()

    def heads(self):
        return (
            self.downstream_head1, self.downstream_head2, self.gaussian_param_head,
            self.gaussian_param_head2, self.gaussian_appearance_head,
        )

    def cast_dtypes(self) -> None:
        """Store the backbone, the stylizer and the DPT trunks in their
        compute dtypes (serving only: training keeps f32 weights)."""
        self._graphs.clear()
        self.backbone.to(self.backbone_dtype)
        self.token_stylizer.to(self.backbone_dtype)
        if self.head_trunk_dtype is not None:
            for head in self.heads():
                head.cast_trunk(self.head_trunk_dtype)

    def _apply(self, fn, recurse=True):
        # .to(), .half(), ...: the parameters may move, so the graphs go.
        self._graphs.clear()
        return super()._apply(fn, recurse)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, *args, **kwargs):
        # assign=True puts new tensors in the parameters' place; an in-place
        # load writes the storage the graphs read.
        if local_metadata.get("assign_to_params_buffers", False):
            self._graphs.clear()
        super()._load_from_state_dict(state_dict, prefix, local_metadata, *args, **kwargs)

    def forward(
        self,
        context_images: Tensor,
        context_intrinsics: Tensor,
        style_image: Tensor,
        global_step: int = 0,
        return_aux: bool = False,
        transpose_maps: bool = False,
        generator: Optional[torch.Generator] = None,
        distill_only: bool = False,
    ) -> Gaussians | Tuple[Gaussians, Dict[str, Tensor]] | Dict[str, Tensor]:
        """context_images: (b, v, h, w, 3) in [-1, 1]; context_intrinsics:
        (b, v, 3, 3); style_image: (b, hs, ws, 3) in [-1, 1].
        transpose_maps: portrait mode; the dense maps are transposed back
        (h/w swap) before the adapter. generator: the dropout masks' source
        in training mode. Returns Gaussians with g = v*h*w.

        distill_only (stage-0 distillation): stop after the point maps and
        return {"pts3d", "depths"}. The JAX step runs the whole encoder and
        XLA drops the stylizer and the gs heads, which its loss does not
        read; here they are not run.

        An inference forward replays CUDA graphs (the module docstring)."""
        inputs = (context_images, context_intrinsics, style_image)
        if context_images.is_cuda:
            trace.count("encoder_calls")
        if not graph_engages(self.training, torch.is_grad_enabled(), inputs, return_aux, generator, distill_only):
            return self._forward(*inputs, global_step, return_aux, transpose_maps, generator, distill_only,
                                 trace.span)
        exponent = opacity_exponent(global_step, self.opacity_initial, self.opacity_final, self.opacity_warm_up)
        key = graph_key(inputs, transpose_maps, exponent)
        graphs = self._graphs
        if key not in graphs:
            graphs[key] = None
            while len(graphs) > GRAPH_SIGNATURES:
                graphs.popitem(last=False)
            # The first call runs eagerly, on the stream the second captures
            # on: what the libraries set up there lazily is set up outside
            # the capture.
            with _on_side_stream(context_images.device):
                return self._forward(*inputs, global_step, False, transpose_maps, None, False, trace.span)
        graphs.move_to_end(key)
        graph = graphs[key]
        if graph is None:
            graph = graphs[key] = self._capture(inputs, global_step, transpose_maps)
            trace.count("encoder_captures")
        else:
            trace.count("encoder_replays")
        return graph.replay(inputs)

    def _capture(self, inputs: Sequence[Tensor], global_step: int, transpose_maps: bool) -> _Graph:
        """The forward on inputs shaped as `inputs`, captured one graph a
        segment into one memory pool on the side stream. The kernels it
        records do not run, so their launches leave the counters until a
        replay counts them."""
        device = inputs[0].device
        static = tuple(torch.empty_like(t) for t in inputs)
        pool, stream, segments = torch.cuda.graph_pool_handle(), _side_stream(device), []

        @contextlib.contextmanager
        def segment(name):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                yield
            segments.append((name, graph))

        before = trace.counters()
        # No autocast cache: a weight cast cached by an autocast scope
        # around this call would be read by the graphs after it is freed.
        cache = torch.is_autocast_cache_enabled()
        torch.set_autocast_cache_enabled(False)
        try:
            with torch.cuda.device(device):
                outputs = self._forward(*static, global_step, False, transpose_maps, None, False, segment)
        finally:
            torch.set_autocast_cache_enabled(cache)
        after = trace.counters()
        launches = {name: after[name] - before[name] for name in KERNELS if after[name] != before[name]}
        for name, n in launches.items():
            trace.count(name, -n)
        return _Graph(static, segments, outputs, launches)

    def _forward(
        self, context_images: Tensor, context_intrinsics: Tensor, style_image: Tensor, global_step: int,
        return_aux: bool, transpose_maps: bool, generator: Optional[torch.Generator], distill_only: bool,
        segment: Callable[[str], contextlib.AbstractContextManager],
    ):
        """The forward, each span segment inside `segment(name)`: the span
        eagerly, a graph's capture in _capture. Every kernel runs inside a
        segment, since a capture records nothing else."""
        b, v, h, w, _ = context_images.shape

        with segment("backbone"), compute_in(self.backbone_dtype, self.backbone.dtype, context_images.device.type):
            enc_feat, enc_pos, dec_feat = self.backbone(context_images, context_intrinsics)

        with segment("heads"):
            dec0 = [t[:, 0].float() for t in dec_feat]
            decr = [t[:, 1:].reshape(b * (v - 1), *t.shape[2:]).float() for t in dec_feat]
            pts0 = self.downstream_head1(dec0, (h, w))
            ptsr = self.downstream_head2(decr, (h, w)).reshape(b, v - 1, h, w, 3)
            pts_all = torch.cat([pts0[:, None], ptsr], dim=1)  # (b, v, h, w, 3)
        if distill_only:
            pts = pts_all.transpose(2, 3) if transpose_maps else pts_all
            return {"pts3d": pts, "depths": pts[..., 2]}

        with segment("stylizer"), compute_in(self.backbone_dtype, self.backbone.dtype, context_images.device.type):
            sty_feat = self.token_stylizer(style_image, enc_feat, enc_pos)

        with segment("heads"):
            imgs = context_images.float()
            gs0 = self.gaussian_param_head(dec0, imgs[:, 0], (h, w), generator)
            gsr = self.gaussian_param_head2(
                decr, imgs[:, 1:].reshape(b * (v - 1), h, w, 3), (h, w), generator
            )
            gs_struct = torch.cat([gs0[:, None], gsr.reshape(b, v - 1, h, w, -1)], dim=1)

            sty_flat = [t.reshape(b * v, *t.shape[2:]).float() for t in sty_feat]
            gs_appear = self.gaussian_appearance_head(sty_flat, (h, w), generator).reshape(b, v, h, w, -1)
            raw = torch.cat([gs_struct, gs_appear], dim=-1)

        if transpose_maps:
            pts_all = pts_all.transpose(2, 3)
            raw = raw.transpose(2, 3)
        with segment("adapter"):
            return _adapt(raw, pts_all, self, global_step, return_aux)


class Styl3rTokenStyleEncoder2View(nn.Module):
    """The 2-view `noposplat_token_style` encoder: the encoder-only
    `croco_enc` backbone -> StructureBuilder (self-attention over both
    views' tokens) for structure, TokenStylizer for appearance; ONE pts3d
    head and ONE dpt_gs_sh structure head shared by both views, a dpt_gs_sh
    appearance head on the stylized tokens.

    The reference's forward calls `self.token_stylizer(style, feat1, pos1,
    feat2, pos2)`, which TokenStylizer.forward(style, content_feat,
    content_pos) does not take, so its 2-view style path crashes. As in the
    JAX encoder, the stylizer gets both views stacked, the evident intent.

    With `distill_only` (stage-0 distillation) the forward stops after the
    points: {"pts3d", "depths"}, no stylization and no Gaussians."""

    def __init__(
        self,
        sh_degree: int = 0,
        patch_size: int = 16,
        opacity_initial: float = 0.0,
        opacity_final: float = 0.0,
        opacity_warm_up: int = 1,
        backbone_dtype: torch.dtype = torch.float32,
        head_trunk_dtype: Optional[torch.dtype] = None,
        enc_depth: int = 24,
        dec_depth: int = 12,
        enc_dim: int = 1024,
        dec_dim: int = 768,
        enc_heads: int = 16,
        dec_heads: int = 12,
        head_feature_dim: int = 256,
        head_last_dim: int = 128,
        head_layer_dims: tuple = (96, 192, 384, 768),
        pts3d_bound: Optional[float] = None,
    ):
        super().__init__()
        self.sh_degree = sh_degree
        self.opacity_initial = opacity_initial
        self.opacity_final = opacity_final
        self.opacity_warm_up = opacity_warm_up
        self.backbone_dtype = backbone_dtype
        self.backbone = CrocoEncBackbone(
            patch_size=patch_size, enc_depth=enc_depth, enc_dim=enc_dim, enc_heads=enc_heads
        )
        self.structure_builder = StructureBuilder(
            enc_dim=enc_dim, dec_dim=dec_dim, dec_depth=dec_depth, dec_heads=dec_heads
        )
        self.token_stylizer = TokenStylizer(
            patch_size=patch_size, enc_depth=enc_depth, dec_depth=dec_depth, enc_dim=enc_dim,
            dec_dim=dec_dim, enc_heads=enc_heads, dec_heads=dec_heads,
        )
        head_dims = _head_dims(
            enc_dim, dec_dim, dec_depth, head_feature_dim, head_layer_dims, patch_size, head_trunk_dtype
        )
        self.downstream_head1 = DPTPts3dHead(last_dim=head_last_dim, pts3d_bound=pts3d_bound, **head_dims)
        structure_channels = 1 + raw_gaussian_channels(sh_degree) - 3 * d_sh(sh_degree)
        self.gaussian_structure_head = DPTGSSHHead(out_channels=structure_channels, **head_dims)
        self.gaussian_appearance_head = DPTGSSHHead(out_channels=3 * d_sh(sh_degree), **head_dims)

    def forward(
        self,
        context_images: Tensor,  # (b, 2, h, w, 3) in [-1, 1]
        context_intrinsics: Tensor,  # (b, 2, 3, 3)
        style_image: Tensor,  # (b, hs, ws, 3) in [-1, 1]
        global_step: int = 0,
        return_aux: bool = False,
        distill_only: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        b, v, h, w, _ = context_images.shape
        if v != 2:
            raise ValueError("the token_style encoder is strictly 2-view")
        device = context_images.device.type
        with compute_in(self.backbone_dtype, self.backbone.dtype, device):
            feats, pos = self.backbone(context_images, context_intrinsics)
            structure = self.structure_builder(feats, pos)
        struct_flat = [t.reshape(b * v, *t.shape[2:]).float() for t in structure]
        pts = self.downstream_head1(struct_flat, (h, w)).reshape(b, v, h, w, 3)
        if distill_only:
            return {"pts3d": pts, "depths": pts[..., 2]}

        with compute_in(self.backbone_dtype, self.token_stylizer.dtype, device):
            sty = self.token_stylizer(style_image, feats, pos)
        sty_flat = [t.reshape(b * v, *t.shape[2:]).float() for t in sty]
        gs_struct = self.gaussian_structure_head(struct_flat, (h, w), generator).reshape(b, v, h, w, -1)
        gs_appear = self.gaussian_appearance_head(sty_flat, (h, w), generator).reshape(b, v, h, w, -1)
        raw = torch.cat([gs_struct, gs_appear], dim=-1)
        with trace.span("adapter"):
            return _adapt(raw, pts, self, global_step, return_aux)


class NoPoSplatMultiEncoder(nn.Module):
    """The style-free NoPoSplat N-view encoder: the multiview CroCo backbone
    -> per-view pts3d heads and dpt_gs heads that emit all the raw Gaussian
    channels (opacity, scale/rotation and 3*d_sh SH); no stylizer. The
    style image is accepted and ignored."""

    def __init__(
        self,
        sh_degree: int = 0,
        patch_size: int = 16,
        opacity_initial: float = 0.0,
        opacity_final: float = 0.0,
        opacity_warm_up: int = 1,
        backbone_dtype: torch.dtype = torch.float32,
        head_trunk_dtype: Optional[torch.dtype] = None,
        enc_depth: int = 24,
        dec_depth: int = 12,
        enc_dim: int = 1024,
        dec_dim: int = 768,
        enc_heads: int = 16,
        dec_heads: int = 12,
        head_feature_dim: int = 256,
        head_last_dim: int = 128,
        head_layer_dims: tuple = (96, 192, 384, 768),
        pts3d_bound: Optional[float] = None,
    ):
        super().__init__()
        self.sh_degree = sh_degree
        self.opacity_initial = opacity_initial
        self.opacity_final = opacity_final
        self.opacity_warm_up = opacity_warm_up
        self.backbone_dtype = backbone_dtype
        self.backbone = MultiViewCrocoBackbone(
            patch_size=patch_size, enc_depth=enc_depth, dec_depth=dec_depth, enc_dim=enc_dim,
            dec_dim=dec_dim, enc_heads=enc_heads, dec_heads=dec_heads,
        )
        head_dims = _head_dims(
            enc_dim, dec_dim, dec_depth, head_feature_dim, head_layer_dims, patch_size, head_trunk_dtype
        )
        self.downstream_head1 = DPTPts3dHead(last_dim=head_last_dim, pts3d_bound=pts3d_bound, **head_dims)
        self.downstream_head2 = DPTPts3dHead(last_dim=head_last_dim, pts3d_bound=pts3d_bound, **head_dims)
        full_channels = 1 + raw_gaussian_channels(sh_degree)
        self.gaussian_param_head = DPTGSHead(out_channels=full_channels, **head_dims)
        self.gaussian_param_head2 = DPTGSHead(out_channels=full_channels, **head_dims)

    def forward(
        self,
        context_images: Tensor,
        context_intrinsics: Tensor,
        style_image: Optional[Tensor] = None,
        global_step: int = 0,
        return_aux: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        b, v, h, w, _ = context_images.shape
        with compute_in(self.backbone_dtype, self.backbone.dtype, context_images.device.type):
            _, _, dec_feat = self.backbone(context_images, context_intrinsics)
        dec0 = [t[:, 0].float() for t in dec_feat]
        decr = [t[:, 1:].reshape(b * (v - 1), *t.shape[2:]).float() for t in dec_feat]
        pts0 = self.downstream_head1(dec0, (h, w))
        ptsr = self.downstream_head2(decr, (h, w)).reshape(b, v - 1, h, w, 3)
        pts = torch.cat([pts0[:, None], ptsr], dim=1)

        imgs = context_images.float()
        gs0 = self.gaussian_param_head(dec0, imgs[:, 0], (h, w), generator)
        gsr = self.gaussian_param_head2(decr, imgs[:, 1:].reshape(b * (v - 1), h, w, 3), (h, w), generator)
        raw = torch.cat([gs0[:, None], gsr.reshape(b, v - 1, h, w, -1)], dim=1)
        with trace.span("adapter"):
            return _adapt(raw, pts, self, global_step, return_aux)
