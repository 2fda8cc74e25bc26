"""Training steps back to back: the step of styl3r_tpu_torch's
train/step.py::make_train_step, built as train/trainer.py builds it for
the configuration's stage: stage 0 ("distill": make_optimizer, the frozen
teacher of models/distiller.py, Regr3D on the point maps) or stage 2
("style": make_stage2_optimizer, train/losses.py's LossBundle with the
VGG19 style loss and the identity branch, the configuration's renderer
settings). Every step takes a batch of
its own, drawn on the host from the seed and the step's index, and pays
its own copy to the device; the window's steps each end in a synchronise.

Set-up drives the step through its first `first_steps` steps (they are the
warm-up) and keeps what the check compares: each step's loss, each leaf's
first gradient as the optimizer got it (AdamW's first moment after one
step over 1 - beta1), the teacher's outputs of the first step, and each
leaf's change after the first steps. The same step object then runs the
window.

End to end: `train_examples_per_s`, the examples of the window's completed
steps over its seconds. Traced run: spans on the optimizer's step and on
the teacher's forward over the window, the window's peak of allocated
memory, and a profiled slice of `trace_steps` steps.

Check, after the window: the reference (float32, TF32 off) follows the
first steps from the same weights, batches and dropout draws with the plain
clip + AdamW, and the readings are compared. Stage 2's reference takes a
step one scene at a time and sums the scenes' gradients: its losses are
means over the scenes, and each scene's dropout masks are its rows of the
whole batch's draw (the gs towers' `dropout_shard`)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from ..core import (Context, Outcome, Spans, free, limits_checks, profiled, reference_weights, rel_l2, synchronize,
                    widths, worst_leaf_gap)
from ..counts import flops
from ..program import teacher as program_teacher
from ..program import teacher_widths, training_model
from ..reference import lowprec
from ..reference.init import drawn
from ..reference.model import Styl3rRef, batch_on, normalize_images
from ..reference.optim import BETAS, PlainAdamW
from ..reference.regr3d import regr3d_loss
from ..reference.style import identity_loss, style_loss
from ..reference.teacher import Dust3RTeacher as TeacherRef
from ..reference.vgg import VGG19Features as VGGRef
from ..scenes import draw, step_generator

TEACHER_KEYS = ("pts3d_1", "pts3d_2", "conf_1", "conf_2")
STYLE_MODULES = ("encoder.token_stylizer.", "encoder.gaussian_appearance_head.")


def traffic(ctx: Context) -> dict:
    return dict(ctx.workload["traffic_parameters"], batch=ctx.config["batch_size"])


def render_kwargs(wl: dict, device: torch.device) -> dict:
    """render_gaussians' keyword arguments, as trainer.render_settings makes
    them from the configuration's decoder."""
    kw = dict(wl.get("render", {}))
    if "background_color" in kw:
        kw["background_color"] = torch.tensor(kw["background_color"], dtype=torch.float32, device=device)
    return kw


def vgg_weights(cfg: dict, device: torch.device):
    return reference_weights(VGGRef, cfg["losses"]["vgg19_weight_seed"], device)


class Program:
    """The program's model, optimizer and step (and stage 0's teacher,
    stage 2's loss bundle), as the trainer builds them for the stage."""

    def __init__(self, cfg: dict, wl: dict, device: torch.device):
        from styl3r_tpu_torch.train.step import (DistillCfg, TrainState, make_optimizer, make_stage2_optimizer,
                                                 make_train_step)

        tr = wl["traffic_parameters"]
        hw = (tr["size"], tr["size"])
        opt = cfg["optimizer"]
        self.stage = cfg["stage"]
        self.model = training_model(cfg, device)
        self.teacher = self.loss = None
        if self.stage == "distill":
            self.teacher = program_teacher(cfg, device)
            self.optimizer = make_optimizer(
                self.model, lr=opt["lr"], warmup_steps=opt["warm_up_steps"], total_steps=opt["total_steps"],
                weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
                backbone_lr_multiplier=opt["backbone_lr_multiplier"],
            )
            d = cfg["distill"]
            distill = DistillCfg(teacher=self.teacher, weight=d["weight"], max_steps=d["max_steps"],
                                 conf_threshold=d["conf_threshold"], distill_only=d["distill_only"])
            self.step = make_train_step(self.model, self.optimizer, hw, loss_fn=None, stylized=False,
                                        identity_branch=False, distill=distill, **render_kwargs(wl, device))
        else:
            from styl3r_tpu_torch.losses.vgg import VGG19Features
            from styl3r_tpu_torch.train.losses import LossBundle

            with torch.device("meta"):
                vgg = VGG19Features()
            vgg = vgg.to_empty(device=device)
            vgg.load_state_dict(vgg_weights(cfg, device))
            lw = cfg["losses"]
            self.loss = LossBundle(mse_weight=lw["mse"], style_weight=lw["style"], identity=lw["identity"],
                                   vgg19=vgg.requires_grad_(False))
            self.optimizer = make_stage2_optimizer(
                self.model, lr=opt["lr"], warmup_steps=opt["warm_up_steps"], total_steps=opt["total_steps"],
                weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
                pretrained_lr_scale=opt["pretrained_lr_scale"],
            )
            self.loss_call = self.loss
            self.step = make_train_step(self.model, self.optimizer, hw,
                                        loss_fn=lambda *a, **kw: self.loss_call(*a, **kw), stylized=True,
                                        identity_branch=lw["identity"], **render_kwargs(wl, device))
        self.state = TrainState()
        self.device = device
        self.restore = lambda: None  # undoes a planted fault outside the program's objects

    def batch(self, seed: int, k: int, tr: dict):
        from styl3r_tpu_torch.models.styl3r import batch_to

        return batch_to(draw(seed, k, tr), self.device)


def first_steps(prog: Program, seed: int, tr: dict, n: int) -> Dict[str, object]:
    """Drive the step through its first n steps; the readings the check
    compares, of the trained leaves (those the optimizer holds)."""
    model, opt = prog.model, prog.optimizer
    trained = {name: p for name, p in model.named_parameters() if p.requires_grad}
    before = {name: p.detach().clone() for name, p in trained.items()}
    seen = {}

    def keep(_module, _inputs, output):
        if not seen:
            seen.update({k: output[k].detach().float().clone() for k in TEACHER_KEYS})

    hook = prog.teacher.register_forward_hook(keep) if prog.teacher is not None else None
    losses, grads, dropped = [], None, 0
    try:
        for k in range(n):
            metrics = prog.step(prog.state, prog.batch(seed, k, tr), step_generator(seed, k, prog.device))
            losses.append(float(metrics["loss"]))
            dropped += bool("live_pairs" in metrics and metrics["live_pairs"] > metrics["pair_slots"])
            if k == 0:
                state = opt.adamw.state
                grads = {name: float(state[p]["exp_avg"].double().norm()) / (1.0 - BETAS[0]) if p in state else 0.0
                         for name, p in trained.items()}
    finally:
        if hook is not None:
            hook.remove()
    delta = {name: float((p.detach() - before[name]).double().norm()) for name, p in trained.items()}
    del before
    return {"losses": losses, "grads": grads, "delta": delta, "teacher": seen, "dropped": dropped}


def stage2_label(name: str) -> str:
    """The stage-2 freeze (model_wrapper_style.py:843-916): the stylizer's
    decoder side and the appearance head "new", the stylizer's encoder
    (patch_embed, enc_blocks, enc_norm) "pretrained", the rest "frozen"."""
    if name.startswith("encoder.gaussian_appearance_head."):
        return "new"
    if name.startswith("encoder.token_stylizer."):
        part = name.split(".")[2]
        return "pretrained" if part in ("patch_embed", "enc_blocks", "enc_norm") else "new"
    return "frozen"


class Reference:
    """The reference model (and stage 0's teacher, stage 2's VGG19) in
    float32 with TF32 off, and the plain clip + AdamW, on the
    configuration's weights."""

    def __init__(self, cfg: dict, wl: dict, device: torch.device):
        opt = cfg["optimizer"]
        self.stage = cfg["stage"]
        self.cfg, self.device = cfg, device
        self.render = render_kwargs(wl, device)
        self.model = drawn(lambda: Styl3rRef(sh_degree=cfg["sh_degree"], **widths(cfg)), cfg["weight_seed"], device)
        self.model.train()
        named = list(self.model.named_parameters())
        if self.stage == "distill":
            self.teacher = drawn(lambda: TeacherRef(**teacher_widths(cfg)), cfg["teacher"]["weight_seed"], device)
            self.teacher.eval().requires_grad_(False)
            groups = [([p for n, p in named if n.startswith("encoder.backbone.")], opt["backbone_lr_multiplier"]),
                      ([p for n, p in named if not n.startswith("encoder.backbone.")], 1.0)]
        else:
            self.vgg = drawn(VGGRef, cfg["losses"]["vgg19_weight_seed"], device).requires_grad_(False)
            for n, p in named:
                p.requires_grad_(stage2_label(n) != "frozen")
            groups = [([p for n, p in named if stage2_label(n) == "new"], 1.0),
                      ([p for n, p in named if stage2_label(n) == "pretrained"], opt["pretrained_lr_scale"])]
        self.groups = groups
        self.names = {id(p): n for n, p in named}
        self.init = {n: p.detach().clone() for n, p in named if p.requires_grad}
        self.reset()

    def reset(self) -> None:
        """Back to the configuration's weights, with a fresh optimizer."""
        opt = self.cfg["optimizer"]
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                if n in self.init:
                    p.copy_(self.init[n])
        self.optimizer = PlainAdamW(self.groups, opt["lr"], opt["warm_up_steps"], opt["total_steps"],
                                    opt["weight_decay"], opt["grad_clip"])

    def low_precision_parts(self):
        """What the configuration computes in bfloat16: the backbone and the
        stylizer (backbone_dtype)."""
        return [self.model.encoder.backbone, self.model.encoder.token_stylizer]

    def steps(self, seed: int, tr: dict, n: int, control: bool = False) -> Dict[str, object]:
        """The reference's readings of the first n steps; with `control`,
        one precision step below the configuration (fp8 in the bfloat16
        backbone and stylizer, TF32 in every float32 matmul and
        convolution, bfloat16 in the compositor)."""
        model = self.model
        trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
        losses, grads, seen = [], None, {}
        low = (lowprec.fp8_layers(self.low_precision_parts()), lowprec.tf32(), lowprec.bf16_compositor()) \
            if control else ()
        with contextlib.ExitStack() as stack:
            for c in low:
                stack.enter_context(c)
            for k in range(n):
                batch = batch_on(draw(seed, k, tr), self.device)
                for p in model.parameters():
                    p.grad = None
                if self.stage == "distill":
                    loss, pseudo = self._distill_loss(batch, k)
                    loss.backward()
                else:
                    loss = self._style_backward(batch, step_generator(seed, k, self.device))
                    pseudo = None
                self.optimizer.step()
                losses.append(float(loss.detach()))
                if k == 0:
                    if pseudo is not None:
                        seen = {key: pseudo[key].detach().float().clone() for key in TEACHER_KEYS}
                    params = [p for ps, _ in self.optimizer.groups for p in ps]
                    grads = {self.names[id(p)]: float(g.double().norm()) for p, g in zip(params, self.optimizer.clipped)}
        delta = {name: float((p.detach() - self.init[name]).double().norm()) for name, p in trained.items()}
        return {"losses": losses, "grads": grads, "delta": delta, "teacher": seen, "dropped": 0}

    def _distill_loss(self, batch, k: int):
        batch = batch._replace(style_image=batch.context_images[:, 0])
        pts = self.model.predict_gaussians(batch, global_step=k, distill_only=True)["pts3d"]
        with torch.no_grad():
            pseudo = self.teacher(normalize_images(batch.context_images[:, :2]))
        loss = regr3d_loss(pseudo["pts3d_1"], pseudo["pts3d_2"], pts[:, 0], pts[:, 1],
                           conf1=pseudo["conf_1"], conf2=pseudo["conf_2"],
                           conf_threshold=self.cfg["distill"]["conf_threshold"], normalize=False)
        return loss, pseudo

    def _style_backward(self, batch, generator: torch.Generator):
        """Stage 2's loss, one scene at a time: each scene's style loss on
        its renders and identity loss on its identity branch's, over b, with
        the scene's rows of the whole batch's dropout masks. Accumulates the
        gradients; returns the step's loss."""
        lw = self.cfg["losses"]
        b = batch.context_images.shape[0]
        hw = tuple(batch.context_images.shape[2:4])
        start = generator.get_state()
        towers = [self.model.encoder.gaussian_param_head, self.model.encoder.gaussian_param_head2,
                  self.model.encoder.gaussian_appearance_head]
        total = torch.zeros((), device=self.device)
        try:
            for r in range(b):
                for t in towers:
                    t.dropout_shard = (r, b)
                row = type(batch)(*(None if x is None else x[r:r + 1] for x in batch))
                generator.set_state(start)
                _, out = self.model(row, hw, generator=generator, **self.render)
                loss = style_loss(self.vgg, out.color, row.target_images, row.style_image, lw["style"])[0]
                if lw["identity"]:
                    generator.set_state(start)
                    _, ident = self.model(row._replace(style_image=row.context_images[:, 0]), hw,
                                          generator=generator, **self.render)
                    loss = loss + identity_loss(self.vgg, ident.color, row.target_images)
                (loss / b).backward()
                total = total + loss.detach() / b
        finally:
            for t in towers:
                t.dropout_shard = (0, 1)
        return total


def compare(prog: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
    """The compared numbers: each step's loss (the worst relative gap), the
    first gradient's and the change's worst leaf (core.worst_leaf_gap, the
    leaves left out by the reference's first gradient), and stage 0's
    teacher outputs of the first step (the worst relative L2 gap)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    if set(prog["grads"]) != set(ref["grads"]):
        return {k: float("inf") for k in NUMBERS}
    grad, grad_at, n_leaves = worst_leaf_gap(prog["grads"], ref["grads"], ref["grads"])
    delta, delta_at, _ = worst_leaf_gap(prog["delta"], ref["delta"], ref["grads"])
    out = {"loss_rel": loss, "grad_leaf_gap": grad, "delta_leaf_gap": delta,
           "grad_worst_leaf": grad_at, "delta_worst_leaf": delta_at, "leaves_compared": n_leaves,
           "losses": prog["losses"], "ref_losses": ref["losses"]}
    if ref["teacher"]:
        out["teacher_rel_l2"] = max(rel_l2(prog["teacher"].get(k, torch.zeros(0)), ref["teacher"][k])
                                    for k in TEACHER_KEYS)
    return out


NUMBERS = ("loss_rel", "grad_leaf_gap", "delta_leaf_gap", "teacher_rel_l2")


def step_flops(cfg: dict, tr: dict) -> float:
    if cfg["stage"] == "distill":
        return flops.distill_step_flops(tr["batch"], tr["views"], tr["size"], tr["size"], flops.dims(cfg["widths"]),
                                        flops.dims(cfg["teacher"]["widths"]))
    return flops.style_step_flops(tr["batch"], tr["views"], tr["size"], tr["size"], tr["targets"],
                                  flops.dims(cfg["widths"]), identity=cfg["losses"]["identity"],
                                  sh_degree=cfg["sh_degree"])


def run(ctx: Context, fault=None) -> Outcome:
    """`fault`, if given, is called with the built Program before the first
    step and may break it (the tests plant faults with it)."""
    from styl3r_tpu_torch.ops.rasterizer import composite

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr = traffic(ctx)
    lowprec.no_tf32()
    prog = Program(cfg, dict(wl, traffic_parameters=tr), dev)
    if fault is not None:
        fault(prog)
    n_first = wl["first_steps"]
    readings = first_steps(prog, ctx.seed, tr, n_first)

    def one(k):
        metrics = prog.step(prog.state, prog.batch(ctx.seed, k, tr), step_generator(ctx.seed, k, dev))
        return bool("live_pairs" in metrics and metrics["live_pairs"] > metrics["pair_slots"])

    spans = Spans(dev) if ctx.trace else None
    hooks = []
    if spans:
        prog.optimizer.step = spans.wrap("optimizer", prog.optimizer.step)
        if prog.loss is not None:
            prog.loss_call = spans.wrap("loss", prog.loss)
        if prog.teacher is not None:
            hooks = [prog.teacher.register_forward_pre_hook(lambda *_: spans.start("teacher")),
                     prog.teacher.register_forward_hook(lambda *_: spans.stop("teacher"))]
    ctx.setup_done()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k, failed = n_first, 0
    t0 = time.perf_counter()
    while True:
        failed += one(k)
        synchronize(dev)
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = k - n_first
    record = {"calls": steps, "window_s": window_s, "window_peak_bytes": peak, "flops_per_call": step_flops(cfg, tr)}
    if spans:
        del prog.optimizer.step
        prog.loss_call = prog.loss
        for h in hooks:
            h.remove()
        record["spans_ms"] = spans.ms()
        if dev.type == "cuda":
            captured = {"composite_inputs": [], "composite_bwd_inputs": []}
            launch, launch_bwd = composite.composite_tiles, composite.composite_backward

            def capture(*args):
                captured["composite_inputs"].append(args)
                return launch(*args)

            def capture_bwd(*args, max_per_tile):
                captured["composite_bwd_inputs"].append(args + (max_per_tile,))
                return launch_bwd(*args, max_per_tile=max_per_tile)

            composite.composite_tiles, composite.composite_backward = capture, capture_bwd
            ks = iter(range(k, 10**9))
            try:
                record["trace"] = profiled(lambda: one(next(ks)), wl["trace_steps"])
            finally:
                composite.composite_tiles, composite.composite_backward = launch, launch_bwd
            record["trace_calls"] = wl["trace_steps"]
            record.update({key: v for key, v in captured.items() if v})
    prog.restore()
    del prog
    free(dev)
    ref = Reference(cfg, wl, dev)
    values = compare(readings, ref.steps(ctx.seed, tr, n_first))
    ctx.log("check: " + ", ".join(f"{k}={values[k]}" for k in values if k not in NUMBERS))
    del ref
    free(dev)
    return Outcome(attempted=steps, failed=failed,
                   end_to_end={"train_examples_per_s": steps * tr["batch"] / window_s},
                   record=record, memory_peak_bytes=peak, checks=limits_checks(values, wl["check"]["limits"]))


def readings(ctx: Context, seeds, control_seeds, faults=()) -> List[dict]:
    """The compared numbers of sound program runs on `seeds`, of the
    control on `control_seeds`, and of each named fault (FAULTS) on
    `control_seeds`, in one process (portbench/calibrate.py). The program
    and the reference never hold the card at once, as in a run."""
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr = traffic(ctx)
    lowprec.no_tf32()
    out = []
    jobs = [("program", s, None) for s in seeds] + [("control", s, None) for s in control_seeds]
    jobs += [(f, s, FAULTS[f]) for f in faults for s in control_seeds]
    for kind, seed, fault in jobs:
        if kind != "control":
            prog = Program(cfg, dict(wl, traffic_parameters=tr), dev)
            if fault is not None:
                fault(prog)
            got = first_steps(prog, seed, tr, wl["first_steps"])
            prog.restore()
            del prog
            free(dev)
        ref = Reference(cfg, wl, dev)
        truth = ref.steps(seed, tr, wl["first_steps"])
        if kind == "control":
            ref.reset()
            got = ref.steps(seed, tr, wl["first_steps"], control=True)
        del ref
        free(dev)
        row = dict(kind=kind, seed=seed, **compare(got, truth))
        out.append(row)
        ctx.log(str(row))
    return out


def _half_batch(prog: Program) -> None:
    """Half of each batch left out: the step sees its first half only, and
    the mean is taken over it."""
    step = prog.step

    def half(state, batch, generator):
        b = batch.context_images.shape[0]
        return step(state, type(batch)(*(x[: max(b // 2, 1)] if torch.is_tensor(x) and x.dim() > 0 else x
                                         for x in batch)), generator)

    prog.step = half


def _unchanged(prog: Program) -> None:
    """A step that returns its state unchanged: the update is skipped."""
    prog.optimizer.adamw.step = lambda *a, **k: None


def _teacher_altered(prog: Program) -> None:
    """An answer altered where it is produced: the teacher's points moved
    by a thousandth of their scale."""
    def alter(_module, _inputs, output):
        for key in ("pts3d_1", "pts3d_2"):
            output[key] = output[key] * 1.001
        return output

    prog.teacher.register_forward_hook(alter)


def _render_altered(prog: Program) -> None:
    """An answer altered where it is produced: the compositor's colors
    doubled."""
    from styl3r_tpu_torch.ops.rasterizer import composite

    plain = composite.composite_tiles

    def brighter(*args):
        out = plain(*args)
        return out._replace(color=out.color * 2.0)

    composite.composite_tiles = brighter
    prog.restore = lambda: setattr(composite, "composite_tiles", plain)


FAULTS = {"half_batch": _half_batch, "unchanged": _unchanged, "teacher_altered": _teacher_altered,
          "render_altered": _render_altered}
STAGE_FAULTS = {"distill": ("half_batch", "unchanged", "teacher_altered"),
                "style": ("half_batch", "unchanged", "render_altered")}
