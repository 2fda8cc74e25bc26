"""Training driver (counterpart of styl3r_tpu/train/trainer.py; the
reference's Lightning runtime, `src/main_style.py` + `ModelWrapperStyle`).

Builds the model, datasets and losses from a RootCfg, runs the train step
on one device, logs scalar metrics, validates now and then (PSNR/SSIM, the
comparison gallery, a trajectory strip, orthographic projections, camera
plots, a wobble video) and writes torch checkpoints: the model's state
dict, the optimizer's and the step. Several datasets interleave round-robin
(the reference concatenates one batch of each loader a step).

A resumed run continues the uninterrupted one exactly: each step's dropout
generator is derived from (train.seed + 1, step), so the checkpoint holds no
generator state, and the checkpoint holds the data stream's position after
the last trained batch (a few numbers per dataset), from which a fit on the
trainer's own stream continues without decoding what was trained on.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..data import DatasetConfig, RE10kStyleDataset, make_view_sampler
from ..data.dataset import batch_iterator
from ..eval.metrics import compute_psnr, compute_ssim
from ..models.decoder import render_gaussians, render_orthographic
from ..models.styl3r import Batch, Styl3rModel, batch_to
from ..utils.checkpoint import (
    load_checkpoint,
    load_torch_state_dict,
    load_warm_start,
    model_state_dict,
    reject_directory,
)
from ..utils.config import RootCfg
from ..utils.convert import init_like_flax_
from .losses import LossBundle
from .step import TrainState, make_optimizer, make_stage2_optimizer, make_train_step


class LocalLogger:
    """metrics.jsonl of scalars and PNG dumps of images (reference
    misc/LocalLogger.py)."""

    def __init__(self, output_dir: Path):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.scalar_file = (self.dir / "metrics.jsonl").open("a")

    def log_scalars(self, step: int, metrics: Dict[str, float]):
        record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self.scalar_file.write(json.dumps(record) + "\n")
        self.scalar_file.flush()

    def log_image(self, step: int, name: str, image: np.ndarray):
        from PIL import Image

        img_dir = self.dir / name
        img_dir.mkdir(parents=True, exist_ok=True)
        arr = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"{step:0>8}.png")

    def log_video(self, step: int, name: str, frames: np.ndarray, fps: int = 10):
        """(t, h, w, 3) float frames -> a PNG sequence, and an mp4 where
        ffmpeg exists (the reference logs videos to wandb,
        model_wrapper_style.py:544-629)."""
        from ..infer.cli import save_video

        save_video(self.dir / name / f"{step:0>8}", np.asarray(frames), fps=fps)

    def close(self):
        self.scalar_file.close()


class WandbLogger(LocalLogger):
    """Weights & Biases on top of the local logger (reference
    main_style.py:61-77)."""

    def __init__(self, output_dir: Path, project: str = "styl3r_tpu", name: str = ""):
        super().__init__(output_dir)
        import wandb  # raises if not installed; make_logger then logs locally

        self._wandb = wandb
        self._run = wandb.init(project=project, name=name or None, dir=str(output_dir))

    def log_scalars(self, step: int, metrics: Dict[str, float]):
        super().log_scalars(step, metrics)
        self._wandb.log({k: float(v) for k, v in metrics.items()}, step=step)

    def log_image(self, step: int, name: str, image: np.ndarray):
        super().log_image(step, name, image)
        self._wandb.log({name: self._wandb.Image(np.clip(image, 0, 1))}, step=step)

    def log_video(self, step: int, name: str, frames: np.ndarray, fps: int = 10):
        super().log_video(step, name, frames, fps=fps)
        arr = (np.clip(np.asarray(frames), 0, 1) * 255).astype(np.uint8)
        self._wandb.log({name: self._wandb.Video(arr.transpose(0, 3, 1, 2), fps=fps)}, step=step)


def make_logger(output_dir: Path, use_wandb: bool = False, **kwargs) -> LocalLogger:
    """The wandb logger when asked for and it starts, else the local one."""
    if use_wandb:
        try:
            return WandbLogger(output_dir, **kwargs)
        except Exception as exc:  # wandb missing or offline: log locally
            print(f"wandb unavailable ({exc}); falling back to LocalLogger")
    return LocalLogger(output_dir)


def build_datasets(cfg: RootCfg, stage: str, seed: int, step_of=lambda n: 0) -> List[RE10kStyleDataset]:
    """The configured datasets; `step_of` gives each view sampler's
    curriculum step from the examples its dataset yielded
    (RE10kStyleDataset)."""
    datasets = []
    for ds_cfg in cfg.datasets:
        sampler_cfg = ds_cfg.view_sampler
        if sampler_cfg.name == "bounded":
            sampler = make_view_sampler(
                "bounded",
                num_context_views=sampler_cfg.num_context_views,
                num_target_views=sampler_cfg.num_target_views,
                min_gap=sampler_cfg.min_gap,
                max_gap=sampler_cfg.max_gap,
                warm_up_steps=sampler_cfg.warm_up_steps,
                initial_min_gap=sampler_cfg.initial_min_gap,
                initial_max_gap=sampler_cfg.initial_max_gap,
                stage=stage,
            )
        elif sampler_cfg.name == "evaluation":
            sampler = make_view_sampler(
                "evaluation",
                index_path=Path(sampler_cfg.index_path),
                num_context_views=sampler_cfg.num_context_views,
            )
        else:
            sampler = make_view_sampler(
                sampler_cfg.name,
                num_context_views=sampler_cfg.num_context_views,
                num_target_views=sampler_cfg.num_target_views,
            )
        datasets.append(
            RE10kStyleDataset(
                DatasetConfig(
                    roots=[Path(r) for r in ds_cfg.roots],
                    style_root=Path(ds_cfg.style_root) if ds_cfg.style_root else None,
                    input_image_shape=tuple(ds_cfg.input_image_shape),
                    original_image_shape=tuple(ds_cfg.original_image_shape),
                    baseline_min=ds_cfg.baseline_min,
                    baseline_max=ds_cfg.baseline_max,
                    max_fov=ds_cfg.max_fov,
                    make_baseline_1=ds_cfg.make_baseline_1,
                    relative_pose=ds_cfg.relative_pose,
                    augment=ds_cfg.augment and stage == "train",
                    overfit_to_scene=ds_cfg.overfit_to_scene,
                ),
                stage,
                sampler,
                seed=seed,
                step_of=step_of,
            )
        )
    return datasets


def endless_batches(
    datasets: List[RE10kStyleDataset], batch_size: int, position: Optional[Dict[str, Any]] = None
) -> Iterator[Tuple[Batch, Optional[Dict[str, Any]]]]:
    """An endless stream of (batch, position) over all datasets, round-robin,
    each epoch restarted when every dataset is spent. Batches are grouped by
    image shape (aspect buckets). `position` is where the stream stands after
    its batch: whose turn is next, which datasets this epoch has spent, and
    each dataset's state after the last batch taken from it (None where a
    dataset's shape buckets held examples back). endless_batches(datasets,
    batch_size, position) continues from there exactly."""
    n = len(datasets)
    if position is None:
        turn, exhausted, states = 0, [False] * n, [ds.state_dict() for ds in datasets]
    else:
        turn, exhausted, states = position["turn"], list(position["exhausted"]), list(position["datasets"])
        for ds, st in zip(datasets, states):
            ds.load_state_dict(st)
    while True:
        iters = [
            None if done else batch_iterator(ds, batch_size, aspect_buckets=True, with_state=True)
            for ds, done in zip(datasets, exhausted)
        ]
        try:
            while not all(exhausted):
                i, turn = turn, (turn + 1) % n
                if exhausted[i]:
                    continue
                try:
                    batch, states[i] = next(iters[i])
                except StopIteration:
                    # Spent: its generator is at the epoch's end, where the
                    # next epoch starts from.
                    exhausted[i], states[i] = True, datasets[i].state_dict()
                    continue
                resumable = all(st is not None for st in states)
                yield batch, (dict(turn=turn, exhausted=list(exhausted), datasets=list(states)) if resumable else None)
        finally:
            for it in iters:
                if it is not None:
                    it.close()
        turn, exhausted, states = 0, [False] * n, [ds.state_dict() for ds in datasets]


def render_settings(cfg: RootCfg, device: torch.device) -> Dict[str, Any]:
    """render_gaussians' keyword arguments from `model.decoder`. Its `impl`
    is checked against the device: "auto" follows it, "pallas" (the
    compositor kernels) needs CUDA and "jnp" (their plain versions) the CPU,
    since the renderer takes the kernels for CUDA tensors and the plain
    versions for CPU tensors."""
    dec = cfg.model.decoder
    wanted = {"auto": device.type, "pallas": "cuda", "jnp": "cpu"}.get(dec.impl)
    if wanted is None:
        raise ValueError(f"model.decoder.impl={dec.impl!r}: expected auto, jnp or pallas")
    if wanted != device.type:
        raise ValueError(
            f"model.decoder.impl={dec.impl!r} renders on {wanted} tensors, but the model is on "
            f"{device.type}; use impl=auto or run on {wanted}"
        )
    kwargs = dict(
        max_per_tile=dec.max_per_tile,
        max_tiles_per_gaussian=dec.max_tiles_per_gaussian,
        scale_invariant=dec.make_scale_invariant,
        background_color=torch.tensor(dec.background_color, dtype=torch.float32, device=device),
    )
    if dec.pair_cap_per_gaussian:
        kwargs["pair_cap_per_gaussian"] = dec.pair_cap_per_gaussian
    return kwargs


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The dropout generator of training step `step`, a function of the seed
    and the step alone."""
    words = np.random.SeedSequence([seed, step]).generate_state(2)
    return torch.Generator(device).manual_seed(int(words[0]) << 32 | int(words[1]))


class StepClock:
    """Times one span on the device's clock: CUDA events on the card (read
    only when asked, so the span is not synchronized), the host's clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record()
        else:
            self._ms = 1e3 * (time.perf_counter() - self._t0)

    def ms(self) -> float:
        if self.cuda:
            self._end.synchronize()
            return self._start.elapsed_time(self._end)
        return self._ms


def _first(gaussians):
    """The first scene's Gaussians, batch dim kept."""
    return type(gaussians)(*(None if x is None else x[:1] for x in gaussians))


class Trainer:
    """`model` replaces the full-width model the config would build (the
    tests pass a tiny one); `device` places the one it builds."""

    def __init__(self, cfg: RootCfg, model: Optional[Styl3rModel] = None, device=None):
        self.cfg = cfg
        self._check_distiller(cfg)
        self.model = model or Styl3rModel(
            sh_degree=cfg.model.encoder.sh_degree,
            backbone_dtype=torch.bfloat16 if cfg.model.encoder.backbone_dtype == "bfloat16" else torch.float32,
            device=device,
            seed=cfg.seed,
        )
        self.device = self.model.device
        self.loss_bundle = self._build_loss_bundle(cfg)
        self.output_dir = Path(cfg.checkpointing.output_dir)
        wandb_cfg = cfg.wandb
        use_wandb = wandb_cfg.mode != "disabled"
        self.logger = make_logger(
            self.output_dir, use_wandb=use_wandb,
            **(dict(project=wandb_cfg.project, name=wandb_cfg.name) if use_wandb else {}),
        )
        self.optimizer = None
        self._render_kwargs: Optional[Dict[str, Any]] = None
        # The data stream's position after the last trained batch
        # (endless_batches); None for batches handed to fit.
        self._data_position: Optional[Dict[str, Any]] = None
        # validate's 2-D AdaIN baseline, built at its first use.
        self._adain = None

    def _build_loss_bundle(self, cfg: RootCfg) -> LossBundle:
        """The configured losses, with the perceptual nets' weights when
        their paths are given (torchvision / lpips-package state dicts).
        Without them the nets are drawn at random, with a loud warning, so
        that training still starts without downloads; the loss is then not
        the reference's. They are drawn on the CPU, so every device gets the
        same nets."""
        from ..losses.lpips import LPIPSVgg16, convert_lpips_state
        from ..losses.vgg import VGG19Features

        vgg = lpips = None
        if bool(cfg.losses.style) or cfg.losses.identity:
            vgg = VGG19Features()
            if cfg.losses.vgg19_weights:
                missing = vgg.load_state_dict(load_torch_state_dict(cfg.losses.vgg19_weights), strict=False)[0]
                if missing:
                    raise ValueError(f"{cfg.losses.vgg19_weights} lacks VGG19 weights {missing[:3]}")
            else:
                print(
                    "WARNING: style/identity loss configured without losses.vgg19_weights — using a "
                    "RANDOMLY INITIALIZED VGG19 (not the reference loss)."
                )
                init_like_flax_(vgg, torch.Generator().manual_seed(0))
            vgg = vgg.to(self.device).requires_grad_(False)
        if cfg.losses.lpips:
            lpips = LPIPSVgg16()
            if cfg.losses.lpips_weights and cfg.losses.lpips_vgg16_weights:
                lpips.load_state_dict(convert_lpips_state(
                    load_torch_state_dict(cfg.losses.lpips_weights),
                    load_torch_state_dict(cfg.losses.lpips_vgg16_weights),
                ))
            else:
                print(
                    "WARNING: lpips loss configured without losses.lpips_weights + "
                    "losses.lpips_vgg16_weights — using a RANDOMLY INITIALIZED LPIPS net (not the "
                    "reference loss)."
                )
                init_like_flax_(lpips, torch.Generator().manual_seed(1))
            lpips = lpips.to(self.device).requires_grad_(False)
        return LossBundle(
            mse_weight=cfg.losses.mse,
            lpips_weight=cfg.losses.lpips,
            lpips_apply_after_step=cfg.losses.lpips_apply_after_step,
            style_weight=cfg.losses.style,
            identity=cfg.losses.identity,
            vgg19=vgg,
            lpips=lpips,
        )

    def _check_distiller(self, cfg: RootCfg) -> None:
        """Distillation from a frozen DUSt3R/MASt3R teacher
        (main_style.py:122-125) is not ported: configuring it raises."""
        if bool(cfg.train.distiller) or bool(cfg.losses.distill):
            raise NotImplementedError(
                "distillation (train.distiller / losses.distill) needs models/distiller.py and "
                "losses/regr3d.py, which ROADMAP queue 1, item 6 ports"
            )

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, state: TrainState, path: Optional[Path] = None) -> Path:
        """One torch file: the model's state dict, the optimizer's (moments
        of the trained parameters, the schedule's position), the step and the
        data stream's position. Written to a temporary name and renamed, so a
        cut run leaves no torn file; then the periodic checkpoints are
        pruned. Logs the seconds it took and the file's bytes."""
        t0 = time.perf_counter()
        path = Path(path or self.output_dir / "checkpoints" / f"step_{state.step}.pt")
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        torch.save({
            "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": state.step,
            "data": self._data_position,
        }, tmp)
        os.replace(tmp, path)
        self._prune_checkpoints(path.parent)
        self.logger.log_scalars(state.step, {
            "checkpoint_seconds": time.perf_counter() - t0, "checkpoint_bytes": path.stat().st_size,
        })
        return path

    def _prune_checkpoints(self, ckpt_dir: Path):
        """Keep the newest `checkpointing.save_top_k` periodic checkpoints
        (-1 keeps all; the reference's ModelCheckpoint on the step,
        main_style.py:80-90)."""
        k = self.cfg.checkpointing.save_top_k
        if k is None or k < 0:
            return
        steps = sorted(Path(ckpt_dir).glob("step_*.pt"), key=lambda p: int(p.stem.split("_")[1]))
        for stale in steps[:-k] if k else steps:
            stale.unlink()

    def load_params_lazy(self, path: Path) -> Dict[str, torch.Tensor]:
        """The model's state dict from a checkpoint file: a trainer
        checkpoint's weights, or a reference .ckpt/.pth's."""
        return model_state_dict(path)

    def load_params(self, path: Path) -> Styl3rModel:
        """Load a checkpoint's weights into the model, by key and strictly."""
        return load_checkpoint(self.model, path)

    def restore_state(self, path: Path, state: TrainState) -> TrainState:
        """A true resume: the model, the optimizer (which must be built, for
        the same configuration), the step and the data stream's position,
        from a trainer checkpoint. Logs the seconds it took and the file's
        bytes."""
        reject_directory(path)
        t0 = time.perf_counter()
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        if "optimizer" not in ckpt:
            raise ValueError(f"{path} holds no optimizer state to resume from")
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        self._data_position = ckpt.get("data")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.logger.log_scalars(state.step, {
            "restore_seconds": time.perf_counter() - t0, "restore_bytes": Path(path).stat().st_size,
        })
        return state

    # -- training ---------------------------------------------------------

    def fit(
        self,
        max_steps: Optional[int] = None,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        batches: Optional[Iterator] = None,
        warm_start: Optional[Dict[str, torch.Tensor]] = None,
    ) -> TrainState:
        """The training loop: steps, validation every `train.val_every_n_steps`
        (the reference's validation_step cadence,
        model_wrapper_style.py:471-629, on the step's batch) and periodic
        checkpoints.

        `init_params` is a full state dict loaded before training;
        `warm_start` a partial one loaded over it (load_warm_start). Batches
        are Batch-shaped tuples of arrays or tensors; without `batches` the
        trainer streams its configured datasets. With
        `checkpointing.resume`, the state of `checkpointing.load` is
        restored, and the trainer's own stream continues from the position
        the checkpoint holds.

        Logged every `train.log_every_n_steps`: the step's metrics,
        `seconds_per_step` (the host's time between logs), `step_ms` (the
        logged step on the device's clock: CUDA events on the card) and
        `data_seconds` (the host's wait for the step's batch); after each
        validation `validate_seconds`."""
        cfg = self.cfg
        max_steps = max_steps or cfg.optimizer.total_steps
        stylized = bool(cfg.losses.style) or cfg.losses.identity
        own_stream = batches is None
        self._data_position = None

        if init_params is not None:
            self.model.load_state_dict(init_params)
        if warm_start is not None:
            load_warm_start(self.model, warm_start)

        opt = cfg.optimizer
        if opt.train_stylizer_only:
            self.optimizer = make_stage2_optimizer(
                self.model, lr=opt.lr, warmup_steps=opt.warm_up_steps, total_steps=max_steps,
                weight_decay=opt.weight_decay, grad_clip=opt.grad_clip, pretrained_lr_scale=opt.pretrained_lr_scale,
            )
        else:
            self.optimizer = make_optimizer(
                self.model, lr=opt.lr, warmup_steps=opt.warm_up_steps, total_steps=max_steps,
                weight_decay=opt.weight_decay, grad_clip=opt.grad_clip,
                backbone_lr_multiplier=opt.backbone_lr_multiplier,
            )
        state = TrainState()
        if cfg.checkpointing.load and cfg.checkpointing.resume:
            state = self.restore_state(cfg.checkpointing.load, state)
            print(f"resumed full train state at step {state.step}")
            if own_stream and self._data_position is None:
                print(f"{cfg.checkpointing.load} holds no data position: the data stream starts from its beginning")
        if own_stream:
            # The curriculum's step: the datasets take turns, one batch each.
            b, n = cfg.train.batch_size, len(cfg.datasets)
            datasets = build_datasets(cfg, "train", cfg.train.seed, step_of=lambda built: built // b * n)
            positioned = endless_batches(datasets, b, self._data_position)
        else:
            positioned = ((batch, None) for batch in batches)
        self._render_kwargs = render_settings(cfg, self.device)

        # One step function per (h, w) bucket; portrait batches (h > w) run
        # the encoder on their transpose (the ManyAR equivalent).
        step_cache: Dict[Tuple[int, int], Any] = {}
        self._step_cache = step_cache

        def get_step_fn(hh: int, ww: int):
            if (hh, ww) not in step_cache:
                step_cache[(hh, ww)] = make_train_step(
                    self.model, self.optimizer, (hh, ww), loss_fn=self.loss_bundle, stylized=stylized,
                    identity_branch=self.loss_bundle.identity, portrait=hh > ww, **self._render_kwargs,
                )
            return step_cache[(hh, ww)]

        def next_batch() -> Tuple[Batch, Optional[Dict[str, Any]], float]:
            t0 = time.perf_counter()
            batch, position = next(positioned)
            return batch_to(batch, self.device), position, time.perf_counter() - t0

        clock = StepClock(self.device)
        try:
            batch, position, data_s = next_batch()
            t_last = time.time()
            for i in range(state.step, max_steps):
                bh, bw = batch.context_images.shape[2:4]
                clock.start()
                metrics = get_step_fn(bh, bw)(state, batch, step_generator(cfg.train.seed + 1, i, self.device))
                clock.stop()
                self._data_position = position

                if (i + 1) % cfg.train.log_every_n_steps == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t_last) / cfg.train.log_every_n_steps
                    t_last = time.time()
                    self.logger.log_scalars(i + 1, dict(
                        metrics, seconds_per_step=dt, step_ms=clock.ms(), data_seconds=data_s,
                    ))
                    print(f"step {i + 1}: loss={metrics['loss']:.4f} ({dt:.2f}s/step)", flush=True)

                if (i + 1) % cfg.train.val_every_n_steps == 0:
                    t0 = time.perf_counter()
                    self.validate(state, batch, stylized=stylized)
                    self.logger.log_scalars(i + 1, {"validate_seconds": time.perf_counter() - t0})

                if (i + 1) % cfg.checkpointing.every_n_train_steps == 0:
                    self.save_checkpoint(state)

                if i + 1 < max_steps:
                    batch, position, data_s = next_batch()
        finally:
            positioned.close()  # stops the datasets' producer threads
        return state

    # -- validation -------------------------------------------------------

    @torch.no_grad()
    def validate(
        self, state: TrainState, batch: Batch, stylized: bool = False, n_trajectory_frames: int = 4
    ) -> Dict[str, float]:
        """The validation pass (reference validation_step,
        model_wrapper_style.py:471-629): PSNR/SSIM, the comparison gallery,
        a strip along the trajectory between the first two targets, the
        Gaussians' orthographic projections (front/top/side), the cameras
        from above and their frustums in three planes, and a wobble video
        around the first target; and, for a stylized run with
        `train.adain_baseline_weights`, the 2-D AdaIN baseline of context view
        0 in the style (model_wrapper_style.py:260-308)."""
        from ..infer.trajectory import interpolate_extrinsics, interpolate_intrinsics, wobble_extrinsics
        from ..utils.drawing import draw_cameras
        from ..utils.viz import annotate, draw_cameras_topdown, hcat, ortho_projection_cameras, validation_gallery

        h, w = batch.context_images.shape[2:4]
        render_kwargs = self._render_kwargs or render_settings(self.cfg, self.device)
        if not stylized:
            batch = batch._replace(style_image=batch.context_images[:, 0])
        self.model.eval()
        gaussians, output = self.model(batch, (h, w), **render_kwargs)
        b, v = output.color.shape[:2]
        pred = output.color.reshape(b * v, h, w, 3)
        gt = batch.target_images.reshape(b * v, h, w, 3)
        psnr = float(compute_psnr(gt, pred).mean())
        ssim_val = float(compute_ssim(gt, pred).mean())
        step = state.step
        self.logger.log_scalars(step, {"val_psnr": psnr, "val_ssim": ssim_val})

        def host(x):
            return x.float().cpu().numpy()

        gallery = validation_gallery(
            host(batch.context_images[0]), host(batch.target_images[0]), host(output.color[0]),
            depth=host(output.depth[0]), style_image=host(batch.style_image[0]) if stylized else None,
        )
        self.logger.log_image(step, "val_comparison", gallery)
        first = _first(gaussians)

        def render(ext, intr):
            """Render the first scene into the cameras (n, 4, 4), (n, 3, 3)."""
            n = ext.shape[0]
            return render_gaussians(
                first, torch.as_tensor(ext, device=self.device)[None],
                torch.as_tensor(intr, device=self.device)[None],
                batch.target_near[:1, :1].expand(1, n), batch.target_far[:1, :1].expand(1, n), (h, w),
                **render_kwargs,
            )

        target_ext, target_k = host(batch.target_extrinsics[0]), host(batch.target_intrinsics[0])
        if target_ext.shape[0] >= 2 and n_trajectory_frames > 0:
            t = np.linspace(0.0, 1.0, n_trajectory_frames)
            traj = render(
                interpolate_extrinsics(target_ext[0], target_ext[1], t).astype(np.float32),
                interpolate_intrinsics(target_k[0], target_k[1], t).astype(np.float32),
            )
            self.logger.log_image(step, "val_trajectory", np.concatenate(list(host(traj.color[0])), axis=1))

        # The Gaussians' orthographic projections (reference
        # validation_in_3d.py render_projections).
        proj_kwargs = {k: render_kwargs[k] for k in ("max_per_tile", "max_tiles_per_gaussian", "background_color")}
        exts, widths, heights, nears, fars = ortho_projection_cameras(host(gaussians.means[0]))
        proj = render_orthographic(
            first, *(torch.as_tensor(x, device=self.device)[None] for x in (exts, widths, heights, nears, fars)),
            (256, 256), **proj_kwargs,
        )
        proj_imgs = host(proj.color[0])
        self.logger.log_image(step, "val_projections", hcat(
            annotate(proj_imgs[0], "front (xy)"), annotate(proj_imgs[1], "top (xz)"),
            annotate(proj_imgs[2], "side (zy)"),
        ))
        self.logger.log_image(step, "val_cameras", draw_cameras_topdown(target_ext, target_k))
        # Frustum wireframes in three planes (reference drawing/cameras.py).
        n_cams = target_ext.shape[0]
        cam_colors = np.stack([np.linspace(1, 0, n_cams), np.linspace(0, 1, n_cams), np.full(n_cams, 0.3)], axis=-1)
        planes = draw_cameras(
            256, target_ext, target_k, cam_colors,
            near=float(batch.target_near.min()), far=float(batch.target_far.max()) * 0.1,
        )
        self.logger.log_image(step, "val_camera_frustums", hcat(planes[0], planes[1], planes[2]))

        # A wobble around the first target camera
        # (src/visualization/camera_trajectory/wobble.py).
        if n_trajectory_frames > 0:
            n_wob = max(n_trajectory_frames * 2, 8)
            scene_scale = float(np.percentile(np.abs(host(gaussians.means[0])), 90))
            ext_w = wobble_extrinsics(target_ext[0], n=n_wob, radius=0.05 * max(scene_scale, 1e-3))
            wob = render(ext_w.astype(np.float32), np.broadcast_to(target_k[0], (n_wob, 3, 3)).copy())
            self.logger.log_video(step, "val_wobble", host(wob.color[0]))

        if stylized and self.cfg.train.adain_baseline_weights:
            if self._adain is None:
                from ..models.stylizers import AdaIN2D, convert_adain2d_checkpoint

                self._adain = AdaIN2D()
                self._adain.load_state_dict(convert_adain2d_checkpoint(
                    load_torch_state_dict(self.cfg.train.adain_baseline_weights)))
                self._adain.to(self.device).requires_grad_(False)
            baseline = self._adain(batch.context_images[:1, 0], batch.style_image[:1])
            self.logger.log_image(step, "val_adain_baseline", host(baseline[0]))
        return {"psnr": psnr, "ssim": ssim_val}

    def close(self):
        self.logger.close()
