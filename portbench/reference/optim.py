"""A plain clip + AdamW, written out (what styl3r_tpu_torch/train/step.py's
GroupedAdamW computes, which follows optax): one clip of every trained
gradient by the global norm, then per parameter, in float32,

    lr_k  = lr * scale_group * schedule(k)     (k = 0, 1, ...; warmup from 0)
    p    *= 1 - lr_k * weight_decay
    m     = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2
    p    -= lr_k * (m / (1 - b1^(k+1))) / (sqrt(v / (1 - b2^(k+1))) + eps)

with betas (0.9, 0.95) and eps 1e-8. A parameter the loss does not reach
has a zero gradient and still decays."""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch
from torch import Tensor

BETAS = (0.9, 0.95)
EPS = 1e-8


def make_schedule(lr: float, warmup_steps: int, total_steps: int, final_scale: float = 0.1) -> Callable[[int], float]:
    """Linear warmup from 0, then cosine decay to final_scale * lr."""
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / warmup_steps
        count = min(step - warmup_steps, decay_steps)
        return lr * ((1.0 - final_scale) * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps)) + final_scale)

    return schedule


class PlainAdamW:
    def __init__(self, groups: Sequence[Tuple[List[Tensor], float]], lr: float, warmup_steps: int,
                 total_steps: int, weight_decay: float, grad_clip: float):
        self.groups = [(list(ps), scale) for ps, scale in groups if ps]
        self.schedule = make_schedule(lr, warmup_steps, total_steps)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.k = 0
        self.m = {id(p): torch.zeros_like(p) for ps, _ in self.groups for p in ps}
        self.v = {id(p): torch.zeros_like(p) for ps, _ in self.groups for p in ps}
        self.clipped: List[Tensor] = []  # the last step's gradients after the clip, as AdamW got them

    @torch.no_grad()
    def step(self) -> Tensor:
        params = [p for ps, _ in self.groups for p in ps]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        scale = 1.0 if float(norm) < self.grad_clip else self.grad_clip / float(norm)
        grads = [g * scale for g in grads]
        self.clipped = grads
        b1, b2 = BETAS
        t = self.k + 1
        by_id = {id(p): g for p, g in zip(params, grads)}
        for ps, group_scale in self.groups:
            lr = self.schedule(self.k) * group_scale
            for p in ps:
                g = by_id[id(p)]
                m, v = self.m[id(p)], self.v[id(p)]
                p.mul_(1.0 - lr * self.weight_decay)
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v / (1.0 - b2**t)).sqrt_().add_(EPS)
                p.addcdiv_(m, denom, value=-lr / (1.0 - b1**t))
        self.k += 1
        return norm
