"""Stage-1 overfit of one COLMAP/LLFF scene from scratch init, scored on
held-out frames, then optionally stage 2 (counterpart of
scripts/overfit_colmap.py, whose docstring sets out the protocol):

    python -m styl3r_tpu_torch.train.overfit_colmap --scene-dir SCENE \
        [--size 256] [--model small] [--steps 3000] [--stage2-steps N] \
        [--output outputs/overfit_colmap.json] [--cpu]
    python -m styl3r_tpu_torch.train.overfit_colmap --scene-dir SCENE --cpu \
        --model tiny --size 32 --steps 2 --eval-every 1 --gap-max 4

Every `--holdout-every`-th frame is held out. A training sample is a context
pair (i, i + 2g) of training frames with `--targets` training frames
between, the world rescaled so that the pair's baseline is 1 and posed
relative to context 0. Stage 1 trains with MSE (plus scratch_stabilizer
unless --no-stabilize) under make_optimizer; each evaluation renders every
held-out frame from its nearest training frames on either side and reports
the mean PSNR. Stage 2 (--stage2-steps) trains style 10 + identity + MSE
under make_stage2_optimizer with VGG19 drawn from --vgg-seed.

The record (the JAX script's keys; `card` added on CUDA) is written to
--output after each evaluation (`partial`) and at the end. Runs on CUDA, or
raises without it, unless --cpu is given; the compositor follows the device
(the kernels on CUDA tensors, their plain versions on CPU tensors).
Departures from the JAX script: --scene-dir is required, --output defaults
under outputs/, `backend` is the torch device type, and VGG19 is drawn by
torch. As in JAX, --anchor-weight and --k-points are parsed and unused: no
batch of `main` carries the sparse anchor.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..data.colmap import (
    auto_orient_and_center_poses,
    camera_intrinsics_normalized,
    colmap_poses_c2w,
    llff_intrinsics_normalized,
    load_colmap_model,
    read_llff_poses,
    read_points3d_binary,
)
from ..device import card_line, resolve_device
from ..losses.vgg import VGG19Features
from ..models.styl3r import Batch, Styl3rModel
from ..utils.convert import init_like_flax_
from .losses import LossBundle, scratch_stabilizer
from .scratch_init import scratch_init_heads
from .step import TrainState, make_optimizer, make_stage2_optimizer, make_train_step
from .trainer import step_generator

MODEL_KWARGS = {
    # full = ViT-L reference config (encoder.py defaults)
    "full": {},
    # small: enough capacity to overfit one scene, ~8x cheaper per step
    "small": dict(enc_depth=8, dec_depth=6, enc_dim=512, dec_dim=384, enc_heads=8, dec_heads=6),
    "tiny": dict(
        enc_depth=2, dec_depth=2, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2, head_feature_dim=16,
        head_last_dim=16, head_layer_dims=(8, 8, 16, 16),
    ),
}

Sample = Tuple[int, int, List[int]]  # (context 0, context 1, targets)


def load_scene(scene_dir: Path, size: int, return_points: bool = False):
    """Images (n, size, size, 3) in [0, 1], normalized intrinsics and c2w
    poses of the scene's numbered frames (auto-oriented and centered). With
    return_points, also the COLMAP sparse cloud (m, 3) in the same oriented
    frame (None without points3D.bin)."""
    from PIL import Image

    sparse = scene_dir / "sparse" / "0"
    photo_paths = sorted(
        p for p in (scene_dir / "images").iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg") and p.stem.isdigit()
    )
    if (sparse / "images.bin").exists() or (sparse / "images.txt").exists():
        cameras, col_images = load_colmap_model(sparse)
        poses, names = colmap_poses_c2w(col_images)
        name_to_pose = {n: i for i, n in enumerate(names)}
        photo_paths = [p for p in photo_paths if p.name in name_to_pose]
        poses = poses[[name_to_pose[p.name] for p in photo_paths]]
        cam = cameras[next(iter(cameras))]
        intrinsics = np.tile(camera_intrinsics_normalized(cam), (len(photo_paths), 1, 1))
    else:
        poses_all, hwf, _ = read_llff_poses(scene_dir / "poses_bounds.npy")
        poses = poses_all[: len(photo_paths)]
        intrinsics = llff_intrinsics_normalized(hwf[: len(photo_paths)])
    poses, transform = auto_orient_and_center_poses(poses)

    def load(p):
        im = Image.open(p).convert("RGB")
        if im.size != (size, size):
            im = im.resize((size, size), Image.LANCZOS)
        return np.asarray(im, np.float32) / 255.0

    images = np.stack([load(p) for p in photo_paths])
    out = (images, intrinsics.astype(np.float32), poses.astype(np.float32))
    if not return_points:
        return out
    pts_file = sparse / "points3D.bin"
    points = None
    if pts_file.exists():
        xyz = read_points3d_binary(pts_file)[:, :3]
        points = ((transform[:3, :3] @ xyz.T).T + transform[:3, 3]).astype(np.float32)
    return out + (points,)


def _sparse_anchor(pts_c0, ext, intr, c0, c1, hw, k_points):
    """COLMAP points (rescaled and in the context-0 camera frame, where the
    pts3d heads predict) projected into both context views: flat Gaussian
    indices (2k,), target xyz (2k, 3) and mask (2k,). A view keeps at most
    k_points, a strided subsample."""
    h, w = hw
    idx_out = np.zeros((2 * k_points,), np.int32)
    tgt_out = np.zeros((2 * k_points, 3), np.float32)
    mask_out = np.zeros((2 * k_points,), np.float32)
    for j, c in enumerate((c0, c1)):
        w2c = np.linalg.inv(ext[c])
        pc = (w2c[:3, :3] @ pts_c0.T).T + w2c[:3, 3]
        z = pc[:, 2]
        kmat = intr[c]
        u = kmat[0, 0] * pc[:, 0] / np.clip(z, 1e-6, None) + kmat[0, 2]
        v = kmat[1, 1] * pc[:, 1] / np.clip(z, 1e-6, None) + kmat[1, 2]
        ok = (z > 0.1) & (z < 50.0) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
        sel = np.flatnonzero(ok)
        if len(sel) > k_points:
            sel = sel[:: len(sel) // k_points + 1][:k_points]
        n = len(sel)
        px = np.minimum((u[sel] * w).astype(np.int32), w - 1)
        py = np.minimum((v[sel] * h).astype(np.int32), h - 1)
        sl = slice(j * k_points, j * k_points + n)
        idx_out[sl] = j * h * w + py * w + px
        tgt_out[sl] = pts_c0[sel]
        mask_out[sl] = 1.0
    return idx_out, tgt_out, mask_out


def make_batch(images, intrinsics, poses, samples: Sequence[Sample], n_targets: int, device,
               style_idx=None, points=None, k_points: int = 2048):
    """A Batch of f32 tensors on `device` for (ctx0, ctx1, [targets...])
    samples. style_idx: per-sample style frames (stage 2); by default the
    style is context 0. points: the (m, 3) sparse cloud in the poses' frame,
    which fills `sparse_anchor` ({flat_idx int32, target, mask} tensors)."""
    hw = images.shape[1:3]
    ctx_i, ctx_k, tgt_e, tgt_k, tgt_im, nears, fars = [], [], [], [], [], [], []
    anc_idx, anc_tgt, anc_mask = [], [], []
    for c0, c1, tgts in samples:
        ext = poses.copy()
        scale = max(float(np.linalg.norm(ext[c0, :3, 3] - ext[c1, :3, 3])), 1e-6)
        ext[:, :3, 3] /= scale
        rel = np.linalg.inv(ext[c0])
        ext = rel[None] @ ext
        ctx_i.append(images[[c0, c1]])
        ctx_k.append(intrinsics[[c0, c1]])
        tgt_e.append(ext[tgts])
        tgt_k.append(intrinsics[tgts])
        tgt_im.append(images[tgts])
        nears.append(np.full((n_targets,), 0.1 / scale, np.float32))
        fars.append(np.full((n_targets,), 100.0 / scale, np.float32))
        if points is not None:
            pr = points / scale
            pts_c0 = (rel[:3, :3] @ pr.T).T + rel[:3, 3]
            i, t, m = _sparse_anchor(pts_c0.astype(np.float32), ext, intrinsics, c0, c1, hw, k_points)
            anc_idx.append(i), anc_tgt.append(t), anc_mask.append(m)

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    anchor = None
    if points is not None:
        anchor = {"flat_idx": tensor(np.stack(anc_idx)), "target": tensor(np.stack(anc_tgt)),
                  "mask": tensor(np.stack(anc_mask))}
    style = images[list(style_idx)] if style_idx is not None else np.stack(ctx_i)[:, 0]
    fields = (ctx_i, ctx_k, tgt_e, tgt_k, nears, fars)
    return Batch(*(tensor(np.stack(x).astype(np.float32)) for x in fields), style_image=tensor(style),
                 target_images=tensor(np.stack(tgt_im)), sparse_anchor=anchor)


# --- samplers: the JAX script's numpy calls, in its order ---------------------


def split_frames(n: int, holdout_every: int) -> Tuple[Set[int], List[int], Set[int]]:
    """(held-out frames, training frames, training set): every
    holdout_every-th frame is held out."""
    held = set(range(0, n, holdout_every))
    train_frames = [i for i in range(n) if i not in held]
    return held, train_frames, set(train_frames)


def sample_train(rng: np.random.Generator, n: int, train_set: Set[int], gap_min: int, gap_max: int,
                 targets: int) -> Sample:
    """A context pair (c0, c0 + 2g) of training frames, g in [gap_min,
    gap_max], with `targets` training frames drawn between them (sorted)."""
    while True:
        g = int(rng.integers(gap_min, gap_max + 1))
        c0 = int(rng.integers(0, n - 2 * g))
        c1 = c0 + 2 * g
        if c0 not in train_set or c1 not in train_set:
            continue
        between = [t for t in range(c0 + 1, c1) if t in train_set]
        if len(between) < targets:
            continue
        tgts = sorted(rng.choice(between, size=targets, replace=False).tolist())
        return (c0, c1, tgts)


def eval_samples(held: Set[int], train_set: Set[int], n: int, eval_gap: int, targets: int) -> List[Sample]:
    """For each held-out frame t (ascending), the farthest training frames
    within eval_gap + 3 before it and eval_gap + 3 after it as contexts, t
    as every target; frames with no training frame on a side are skipped."""
    out = []
    for t in sorted(held):
        lo = [i for i in range(max(0, t - eval_gap - 3), t) if i in train_set]
        hi = [i for i in range(t + 1, min(n, t + eval_gap + 4)) if i in train_set]
        if lo and hi:
            out.append((lo[0], hi[-1], [t] * targets))
    return out


def draw_styles(rng: np.random.Generator, train_frames: List[int], samples: Sequence[Sample]) -> List[int]:
    """Stage 2's style frame for each sample: a training frame other than
    its two contexts."""
    return [int(rng.choice([f for f in train_frames if f not in (s[0], s[1])])) for s in samples]


# --- model and losses ---------------------------------------------------------


def build_model(name: str, device, seed: int = 0, pts3d_bound: Optional[float] = 20.0, bf16: bool = False,
                scratch_init: bool = True):
    """The script's model: sh degree 0, MODEL_KWARGS[name], f32 weights
    (bf16 compute in the backbone and the DPT trunks with `bf16`), the
    pts3d heads' radial clamp at pts3d_bound (None: unbounded), random
    weights from `seed`, and scratch_init_heads unless told otherwise."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = Styl3rModel(sh_degree=0, backbone_dtype=dtype, head_trunk_dtype=dtype, pts3d_bound=pts3d_bound,
                        device=device, seed=seed, **MODEL_KWARGS[name])
    return scratch_init_heads(model) if scratch_init else model


def stage1_loss(output, batch, gaussians, global_step=0, identity_output=None):
    """MSE to the targets plus scratch_stabilizer, with its terms as metrics."""
    mse = ((output.color - batch.target_images) ** 2).mean()
    stab, sm = scratch_stabilizer(gaussians)
    return mse + stab, {"mse": mse, **sm}


def render_settings(size: int) -> Dict[str, int]:
    """The script's render caps: 8 tiles a Gaussian, 2048 pairs a tile at
    256^2 and above (512 below), 4 pair slots a Gaussian."""
    return dict(max_tiles_per_gaussian=8, max_per_tile=2048 if size >= 256 else 512, pair_cap_per_gaussian=4)


@torch.no_grad()
def eval_psnr(model, images, intrinsics, poses, samples: Sequence[Sample], n_targets: int, hw, render_kwargs,
              device) -> Tuple[float, float, float]:
    """(mean, min, max) PSNR of each held-out sample's first target, the
    model in eval mode."""
    model.eval()
    psnrs = []
    for s in samples:
        b = make_batch(images, intrinsics, poses, [s], n_targets, device)
        _, out = model(b, hw, **render_kwargs)
        pred = out.color.float().cpu().numpy()
        gt = b.target_images.cpu().numpy()
        mse = float(np.mean((pred[0, 0] - gt[0, 0]) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
    return float(np.mean(psnrs)), float(np.min(psnrs)), float(np.max(psnrs))


# --- the entry point ----------------------------------------------------------


def main(argv=None, model=None) -> Dict[str, object]:
    """Runs the protocol and returns the record it writes. `model`, if
    given, is trained as it is in place of the one the flags build (the
    flags' widths, pts3d bound and init are then the caller's)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene-dir", required=True,
                    help="a scene with images/ (numbered frames) and sparse/0 (COLMAP) or poses_bounds.npy")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--model", choices=list(MODEL_KWARGS), default="small")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--targets", type=int, default=2, help="target views per sample")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--eval-gap", type=int, default=5)
    ap.add_argument("--gap-min", type=int, default=3, help="min context half-gap")
    ap.add_argument("--gap-max", type=int, default=12, help="max context half-gap")
    ap.add_argument("--holdout-every", type=int, default=10)
    ap.add_argument("--stage2-steps", type=int, default=0,
                    help="after stage 1, this many stage-2 (style) steps with a fixed-seed VGG19")
    ap.add_argument("--stage2-lr", type=float, default=2e-4)
    ap.add_argument("--vgg-seed", type=int, default=42)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-scratch-init", action="store_true",
                    help="skip scratch_init_heads (the degenerate all-Gaussians-at-origin init)")
    ap.add_argument("--pts3d-bound", type=float, default=20.0,
                    help="radial clamp on the pts3d heads; 0 disables (unbounded expm1)")
    ap.add_argument("--no-stabilize", action="store_true",
                    help="drop the scratch_stabilizer terms from the stage-1 objective")
    ap.add_argument("--anchor-weight", type=float, default=0.2,
                    help="parsed and unused, as in the JAX script: no batch carries the sparse anchor")
    ap.add_argument("--k-points", type=int, default=2048, help="parsed and unused, as --anchor-weight")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    ap.add_argument("--bf16", action="store_true", help="bf16 compute in the backbone and the DPT trunks")
    ap.add_argument("--output", default="outputs/overfit_colmap.json")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    images, intrinsics, poses = load_scene(Path(args.scene_dir), args.size)
    n = len(images)
    held, train_frames, train_set = split_frames(n, args.holdout_every)
    print(f"scene: {n} frames, {len(held)} held out, size {args.size}")
    rng = np.random.default_rng(args.seed)

    def draw_train():
        return [sample_train(rng, n, train_set, args.gap_min, args.gap_max, args.targets) for _ in range(args.batch)]

    evals_at = eval_samples(held, train_set, n, args.eval_gap, args.targets)
    if model is None:
        model = build_model(args.model, device, args.seed, args.pts3d_bound or None, args.bf16,
                            scratch_init=not args.no_scratch_init)
    hw = (args.size, args.size)
    render_kwargs = render_settings(args.size)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {args.model}: {n_params / 1e6:.1f}M params")
    optimizer = make_optimizer(model, lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
                               backbone_lr_multiplier=1.0)
    step_fn = make_train_step(model, optimizer, hw, stylized=False,
                              loss_fn=None if args.no_stabilize else stage1_loss, **render_kwargs)
    state = TrainState()
    card = card_line() if device.type == "cuda" else None
    series: List[Dict[str, float]] = []
    evals: List[Dict[str, float]] = []

    def write_output(stage2=None, partial=False):
        out = {
            "task": "stage-1 overfit on a COLMAP scene, scratch init",
            "scene": str(args.scene_dir),
            "n_frames": n,
            "held_out": len(evals_at),
            "size": args.size,
            "model": args.model,
            "params_m": round(n_params / 1e6, 2),
            "steps": args.steps,
            "batch": args.batch,
            "targets_per_sample": args.targets,
            "lr": args.lr,
            "pts3d_bound": args.pts3d_bound or None,
            "stabilizer": not args.no_stabilize,
            "backend": device.type,
            "series": series,
            "evals": evals,
            "final_psnr": evals[-1]["psnr"] if evals else None,
            "wall_s": round(time.time() - t_start, 1),
        }
        if card is not None:
            out["card"] = card
        if partial:
            out["partial"] = True
        if stage2 is not None:
            out["stage2"] = stage2
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(out, indent=1))
        return out

    t_start = time.time()
    for i in range(args.steps):
        batch = make_batch(images, intrinsics, poses, draw_train(), args.targets, device)
        metrics = step_fn(state, batch, step_generator(args.seed + 1, i, device))
        if i < 3 or (i + 1) % 25 == 0:
            loss = float(metrics["loss"])
            series.append({"step": i + 1, "loss": loss})
            if not np.isfinite(loss):
                print(f"step {i + 1}: loss NOT FINITE, aborting")
                break
        if (i + 1) % args.eval_every == 0 or i + 1 == args.steps:
            mean_p, min_p, max_p = eval_psnr(model, images, intrinsics, poses, evals_at, args.targets, hw,
                                             render_kwargs, device)
            evals.append({"step": i + 1, "psnr": mean_p, "psnr_min": min_p, "psnr_max": max_p})
            print(f"step {i + 1}: loss {float(metrics['loss']):.5f} held-out PSNR {mean_p:.2f} dB "
                  f"(min {min_p:.2f}, max {max_p:.2f}) [{time.time() - t_start:.0f}s]", flush=True)
            write_output(partial=True)

    stage2 = None
    if args.stage2_steps:
        # VGG19 at random weights, drawn on the CPU as the trainer draws it.
        vgg = VGG19Features()
        init_like_flax_(vgg, torch.Generator().manual_seed(args.vgg_seed))
        bundle = LossBundle(mse_weight=1.0, style_weight=10.0, identity=True,
                            vgg19=vgg.to(device).requires_grad_(False))
        optimizer2 = make_stage2_optimizer(model, lr=args.stage2_lr, warmup_steps=min(25, args.stage2_steps // 4),
                                           total_steps=args.stage2_steps)
        step2_fn = make_train_step(model, optimizer2, hw, loss_fn=bundle, stylized=True, identity_branch=True,
                                   **render_kwargs)
        state2 = TrainState()
        s2_series: List[Dict[str, float]] = []
        t2 = time.time()
        for i in range(args.stage2_steps):
            samples = draw_train()
            styles = draw_styles(rng, train_frames, samples)
            batch = make_batch(images, intrinsics, poses, samples, args.targets, device, style_idx=styles)
            m2 = step2_fn(state2, batch, step_generator(args.seed + 1, args.steps + i, device))
            if i < 3 or (i + 1) % 5 == 0 or i + 1 == args.stage2_steps:
                rec = {"step": i + 1, **{k: float(m2[k]) for k in ("loss", "style", "identity", "mse") if k in m2}}
                s2_series.append(rec)
                if not np.isfinite(rec["loss"]):
                    print(f"stage2 step {i + 1}: loss NOT FINITE, aborting")
                    break
        first_style = next((r["style"] for r in s2_series if "style" in r), None)
        last_style = next((r["style"] for r in reversed(s2_series) if "style" in r), None)
        stage2 = {
            "vgg": f"fixed-seed random init (seed {args.vgg_seed})",
            "steps": args.stage2_steps,
            "lr": args.stage2_lr,
            "series": s2_series,
            "style_first": first_style,
            "style_last": last_style,
            "style_decreased": bool(first_style is not None and last_style is not None and last_style < first_style),
            "wall_s": round(time.time() - t2, 1),
        }
        print(f"stage2: style {first_style:.4f} -> {last_style:.4f} "
              f"({'DECREASED' if stage2['style_decreased'] else 'no decrease'}) [{stage2['wall_s']:.0f}s]")

    out = write_output(stage2=stage2)
    print(f"wrote {args.output}: final held-out PSNR {out['final_psnr'] and round(out['final_psnr'], 2)} dB")
    return out


if __name__ == "__main__":
    main()
