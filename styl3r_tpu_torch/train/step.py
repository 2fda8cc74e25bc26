"""The train step and its optimizer (counterpart of styl3r_tpu/train/step.py;
the reference's `model_wrapper_style.py` training_step and
configure_optimizers).

One step: forward (encoder -> render, and with the identity branch a second
forward with style := context view 0), the loss, backward through the
compositor kernels, then one clip by the global norm and AdamW per group:
betas (0.9, 0.95), eps 1e-8, decoupled weight decay 0.05 times the
scheduled lr, linear warmup from 0 then cosine decay to 0.1 * lr. The lr of
update k is schedule(k) from k = 0, as optax counts.

The model's weights stay f32 (the compute dtypes are set on the model) and
are updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch import Tensor
from torch.distributed.tensor import DTensor

from ..parallel.mesh import all_reduce_grads_, local_tensor, reduce_metrics
from ..parallel.tp import global_sq_norm
from ..utils import trace


def make_schedule(
    lr: float, warmup_steps: int, total_steps: int, final_scale: float = 0.1
) -> Callable[[int], float]:
    """Linear warmup from 0 -> cosine decay to final_scale * lr
    (optax.join_schedules of linear_schedule and cosine_decay_schedule)."""
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / warmup_steps
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return lr * ((1.0 - final_scale) * cosine + final_scale)

    return schedule


def clip_by_global_norm_(params: Sequence[Tensor], max_norm: float) -> Tensor:
    """optax.clip_by_global_norm in place on the params' grads: g * max_norm
    / |g| where |g| >= max_norm (torch's clip_grad_norm_ adds 1e-6 to the
    norm). Under tensor parallelism the norm is the whole gradient's
    (parallel/tp.py::global_sq_norm). Returns the norm before clipping."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(global_sq_norm(grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([local_tensor(g) for g in grads], scale)
    return norm


class GroupedAdamW:
    """optax.chain(clip_by_global_norm, multi_transform({group: adamw})):
    one global-norm clip across every trained parameter, then AdamW with a
    per-group lr scale on one shared warmup + cosine schedule. Parameters
    left out of every group are not touched (optax's set_to_zero)."""

    def __init__(
        self,
        groups: Dict[str, Tuple[List[nn.Parameter], float]],
        lr: float,
        warmup_steps: int,
        total_steps: int,
        weight_decay: float,
        grad_clip: float,
    ):
        groups = {k: v for k, v in groups.items() if v[0]}
        self.params = [p for ps, _ in groups.values() for p in ps]
        self.grad_clip = grad_clip
        # A tensor-parallel model's DTensor weights go in param groups of their
        # own: AdamW's foreach kernels take no list that mixes them with
        # plain tensors.
        param_groups = [
            {"params": kind, "lr": lr * scale}
            for ps, scale in groups.values()
            for kind in ([p for p in ps if not isinstance(p, DTensor)], [p for p in ps if isinstance(p, DTensor)])
            if kind
        ]
        self.adamw = torch.optim.AdamW(param_groups, lr=lr, betas=(0.9, 0.95), eps=1e-8, weight_decay=weight_decay)
        factor = make_schedule(1.0, warmup_steps, total_steps)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.adamw, [factor] * len(param_groups))

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict[str, Any]:
        """AdamW's moments and step counts (of the trained parameters only)
        and the schedule's position."""
        return {"adamw": self.adamw.state_dict(), "schedule": self.schedule.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.schedule.load_state_dict(state["schedule"])

    def step(self) -> Tensor:
        """Clip, then update. A parameter the loss did not reach gets a zero
        gradient, so weight decay still applies to it, as with optax.
        Returns the gradient's global norm before clipping."""
        with trace.span("clip"):
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            norm = clip_by_global_norm_(self.params, self.grad_clip)
        with trace.span("adamw"):
            self.adamw.step()
            self.schedule.step()
        return norm


def _top(name: str) -> List[str]:
    """A parameter name's path below the model's `encoder.`."""
    parts = name.split(".")
    return parts[1:] if parts[0] == "encoder" else parts


def backbone_param_labels(model: nn.Module) -> Dict[str, str]:
    """'backbone' for the CroCo trunk, 'rest' for the heads and the stylizer
    (the reference's new/pretrained split in stage 1)."""
    return {
        name: "backbone" if _top(name)[0] == "backbone" else "rest"
        for name, _ in model.named_parameters()
    }


# The token stylizer's encoder: its flax subtree `token_stylizer/encoder`
# (tests/test_torch_train.py holds this against stage2_param_labels through
# the weights bridge).
_STYLIZER_ENCODER = ("patch_embed", "enc_blocks", "enc_norm")


def stage2_param_labels(model: nn.Module) -> Dict[str, str]:
    """The stage-2 freeze: the stylizer's decoder side and the appearance
    head are 'new' (full lr), the stylizer's encoder 'pretrained' (0.1x),
    everything else 'frozen' (model_wrapper_style.py:843-916)."""

    def label(name: str) -> str:
        path = _top(name)
        if path[0] == "gaussian_appearance_head":
            return "new"
        if path[0] == "token_stylizer":
            return "pretrained" if path[1] in _STYLIZER_ENCODER else "new"
        return "frozen"

    return {name: label(name) for name, _ in model.named_parameters()}


def _grouped(model: nn.Module, labels: Dict[str, str], scales: Dict[str, float]):
    params = dict(model.named_parameters())
    return {g: ([params[n] for n, l in labels.items() if l == g], s) for g, s in scales.items()}


def make_optimizer(
    model: nn.Module,
    lr: float = 2e-4,
    warmup_steps: int = 125,
    total_steps: int = 15_000,
    weight_decay: float = 0.05,
    grad_clip: float = 0.5,
    backbone_lr_multiplier: float = 1.0,
) -> GroupedAdamW:
    """Stage-1 optimizer over every parameter. With backbone_lr_multiplier
    != 1 the CroCo backbone is its own group at that lr scale (and its own
    schedule, as in optax); one clip covers both groups."""
    if backbone_lr_multiplier == 1.0:
        groups = {"all": (list(model.parameters()), 1.0)}
    else:
        groups = _grouped(model, backbone_param_labels(model), {"backbone": backbone_lr_multiplier, "rest": 1.0})
    return GroupedAdamW(groups, lr, warmup_steps, total_steps, weight_decay, grad_clip)


def make_stage2_optimizer(
    model: nn.Module,
    lr: float = 2e-4,
    warmup_steps: int = 125,
    total_steps: int = 35_000,
    weight_decay: float = 0.05,
    grad_clip: float = 0.5,
    pretrained_lr_scale: float = 0.1,
) -> GroupedAdamW:
    """Stage-2 optimizer: 'new' at 1x, 'pretrained' at pretrained_lr_scale;
    'frozen' parameters get requires_grad_(False) and stay out of the
    optimizer, so neither the clip nor weight decay sees them."""
    labels = stage2_param_labels(model)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    groups = _grouped(model, labels, {"new": 1.0, "pretrained": pretrained_lr_scale})
    return GroupedAdamW(groups, lr, warmup_steps, total_steps, weight_decay, grad_clip)


class DistillCfg(NamedTuple):
    """Distillation settings (reference model_wrapper_style.py:95-100): a
    frozen DUSt3R/MASt3R teacher (models/distiller.py, on the model's
    device) gives pseudo-GT point maps; Regr3D without normalization on the
    encoder's per-view pts3d, weighted and gated by `max_steps`, or alone
    and unweighted with `distill_only` (stage 0: no render)."""

    teacher: Any
    weight: float = 0.1
    max_steps: int = 1_000_000
    conf_threshold: float = 3.0
    distill_only: bool = False


def distill_loss(distill: DistillCfg, pts3d: Tensor, batch, global_step: int, data=None) -> Tensor:
    """Regr3D of the encoder's (b, v, h, w, 3) points against the teacher's
    on the first two context views (model_wrapper_style.py:157-171,
    :234-242). The teacher runs without gradients on its f32 weights. With
    `data` the batch is this rank's rows of the global batch, whose valid
    points the mean is over (regr3d_loss)."""
    from ..losses.regr3d import regr3d_loss
    from ..models.styl3r import normalize_images

    with torch.no_grad(), trace.span("teacher"):
        pseudo = distill.teacher(normalize_images(batch.context_images[:, :2]))
    raw = regr3d_loss(
        pseudo["pts3d_1"], pseudo["pts3d_2"], pts3d[:, 0], pts3d[:, 1],
        conf1=pseudo["conf_1"], conf2=pseudo["conf_2"], conf_threshold=distill.conf_threshold,
        normalize=False, data=data,
    )
    if distill.distill_only:
        # Stage 0 adds the term unweighted and ungated.
        return raw
    gate = float(global_step <= distill.max_steps)
    return distill.weight * gate * raw


@dataclass
class TrainState:
    step: int = 0  # updates taken; the forward's global_step


def make_train_step(
    model: nn.Module,
    optimizer: GroupedAdamW,
    image_shape: Tuple[int, int],
    loss_fn: Optional[Callable] = None,
    stylized: bool = True,
    identity_branch: bool = False,
    distill: Optional[DistillCfg] = None,
    portrait: bool = False,
    data=None,
    **render_kwargs,
):
    """The train step: `step(state, batch, generator) -> metrics`, which
    updates the model in place and advances state.step.

    `loss_fn(output, batch, gaussians, global_step, identity_output)` maps
    the decoder output to (scalar, metrics); plain MSE by default.
    stylized=False (stage-1 NVS pretraining) replaces the style image with
    context view 0; identity_branch adds a second forward with style :=
    context view 0, replaying the generator's state so both forwards draw
    the same dropout masks. The metrics add the loss, the gradient's global
    norm over the trained parameters (before clipping) and the render's
    live_pairs / pair_slots (the pair_cap truncation was lossless iff
    live_pairs <= pair_slots).

    With `distill`, the Regr3D term (distill_loss) is added to the loss and
    logged as `distill`; with `distill.distill_only` the step runs the
    encoder alone, renders nothing, and its metrics are {distill, loss,
    grad_norm}.

    With `data` (a parallel/mesh.py DataGroup) the batch is this rank's rows
    of a global batch (shard_batch) and the step is the global batch's: the
    model's dropout draws the global masks (models/dpt.py::shard_dropout_,
    which the caller applies), Regr3D divides by the global valid count, the
    gradients are averaged over the ranks before the clip (so `grad_norm` is
    the global norm and every rank updates alike), and the metrics are
    reduced over the ranks (reduce_metrics), with `allreduce_bytes` added.

    Spans (utils/trace.py): `forward` from the batch to the scalar loss,
    `loss` around loss_fn, `teacher` around the teacher, `backward`,
    `allreduce`, and the optimizer's `clip` and `adamw`."""
    if loss_fn is None:

        def loss_fn(output, batch, gaussians, global_step=0, identity_output=None):
            mse = ((output.color - batch.target_images) ** 2).mean()
            return mse, {"mse": mse}

    def forward(state: TrainState, batch, generator: torch.Generator) -> Tuple[Tensor, Dict[str, Tensor]]:
        if not stylized:
            batch = batch._replace(style_image=batch.context_images[:, 0])
        model.train()
        if distill is not None and distill.distill_only:
            # The encoder stops at its point maps: the only output the loss
            # reads (the rest get zero gradients, as in JAX).
            pts = model.predict_gaussians(
                batch, state.step, portrait=portrait, generator=generator, distill_only=True
            )["pts3d"]
            loss = distill_loss(distill, pts, batch, state.step, data)
            return loss, {"distill": loss}

        rng_state = generator.get_state()
        kw = dict(global_step=state.step, portrait=portrait, generator=generator, **render_kwargs)
        fwd = model(batch, image_shape, return_aux=distill is not None, **kw)
        gaussians, output = fwd[0], fwd[1]
        identity_output = None
        if identity_branch:
            generator.set_state(rng_state)
            id_batch = batch._replace(style_image=batch.context_images[:, 0])
            _, identity_output = model(id_batch, image_shape, **kw)
        with trace.span("loss"):
            loss, metrics = loss_fn(
                output, batch, gaussians, global_step=state.step, identity_output=identity_output
            )
        if distill is not None:
            term = distill_loss(distill, fwd[2]["pts3d"], batch, state.step, data)
            loss = loss + term
            metrics = dict(metrics, distill=term)
        return loss, dict(metrics, live_pairs=output.live_pairs.max(), pair_slots=output.pair_slots.min())

    def train_step(state: TrainState, batch, generator: torch.Generator) -> Dict[str, Tensor]:
        with trace.span("forward"):
            loss, metrics = forward(state, batch, generator)
        return update(state, loss, metrics)

    def update(state: TrainState, loss: Tensor, metrics: Dict[str, Tensor]) -> Dict[str, Tensor]:
        optimizer.zero_grad()
        with trace.span("backward"):
            loss.backward()
        if data is not None:
            with trace.span("allreduce"):
                reduced = all_reduce_grads_(optimizer.params, data)
        grad_norm = optimizer.step()
        state.step += 1
        metrics = dict({k: v.detach() for k, v in metrics.items()}, loss=loss.detach(), grad_norm=grad_norm)
        if data is None:
            return metrics
        return dict(reduce_metrics(metrics, data), allreduce_bytes=reduced)

    return train_step
