"""Typed config (counterpart of styl3r_tpu/utils/config.py; the reference's
Hydra + dacite stack, `src/config.py`, `config/*.yaml`).

Plain dataclasses loaded from YAML with `defaults:` composition (entries
resolved relative to the configs root, like Hydra groups) and dotted-path
overrides (`key.sub=value`, list items by index: `datasets.0.roots=[...]`).
The port reads the same files into the same values as the JAX package.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import yaml


# ---------------------------------------------------------------------------
# Config schema (mirrors config/main.yaml + experiment groups)
# ---------------------------------------------------------------------------


@dataclass
class ModelEncoderCfg:
    name: str = "noposplat_multi_token_style"
    sh_degree: int = 0
    opacity_initial: float = 0.0
    opacity_final: float = 0.0
    opacity_warm_up: int = 1
    backbone_dtype: str = "bfloat16"
    pretrained_weights: str = ""
    stylizer_pretrained_weights: str = ""


@dataclass
class ModelDecoderCfg:
    name: str = "splatting"
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    make_scale_invariant: bool = False
    max_tiles_per_gaussian: int = 32
    max_per_tile: int = 4096
    # auto | jnp | pallas: auto follows the tensors' device; "pallas" (the
    # kernels) needs CUDA tensors and "jnp" (the plain versions) CPU tensors
    # (train/trainer.py::render_settings checks it).
    impl: str = "auto"
    # Post-sort cap on total pair slots per render, as a multiple of the
    # gaussian count (0 = exact/no cap). Lossless while live pairs fit; the
    # attribute-gather HBM cost scales with slots (see render_many docstring).
    pair_cap_per_gaussian: int = 0


@dataclass
class ModelCfg:
    encoder: ModelEncoderCfg = field(default_factory=ModelEncoderCfg)
    decoder: ModelDecoderCfg = field(default_factory=ModelDecoderCfg)


@dataclass
class LossCfg:
    mse: Optional[float] = 1.0
    lpips: Optional[float] = None
    lpips_apply_after_step: int = 0
    style: Optional[float] = None  # style stats weight (reference: 10.0)
    identity: bool = False
    distill: Optional[float] = None  # Regr3D distillation weight (reference: 0.1)
    # Perceptual-net weight paths (torch state dicts, converted on load).
    # style/identity need vgg19; lpips needs the lpips lin weights + vgg16.
    # Empty paths fall back to random init with a loud warning so training
    # stays launchable in weightless environments.
    vgg19_weights: str = ""
    lpips_weights: str = ""
    lpips_vgg16_weights: str = ""


@dataclass
class ViewSamplerCfg:
    name: str = "bounded"
    num_context_views: int = 2
    num_target_views: int = 4
    min_gap: int = 45
    max_gap: int = 90
    warm_up_steps: int = 0
    initial_min_gap: int = 25
    initial_max_gap: int = 25
    index_path: str = ""  # evaluation sampler


@dataclass
class DatasetCfg:
    name: str = "re10k_style"
    roots: List[str] = field(default_factory=list)
    style_root: str = ""
    input_image_shape: Tuple[int, int] = (256, 256)
    original_image_shape: Tuple[int, int] = (360, 640)
    baseline_min: float = 1e-3
    baseline_max: float = 1e2
    max_fov: float = 100.0
    make_baseline_1: bool = True
    relative_pose: bool = True
    augment: bool = True
    overfit_to_scene: Optional[str] = None
    view_sampler: ViewSamplerCfg = field(default_factory=ViewSamplerCfg)


@dataclass
class OptimizerCfg:
    lr: float = 2e-4
    warm_up_steps: int = 125
    total_steps: int = 15_000
    weight_decay: float = 0.05
    grad_clip: float = 0.5
    # Stage-1: the CroCo backbone trains at a reduced lr
    # (reference re10k_3view_style_8x8.yaml optimizer block: 0.1).
    backbone_lr_multiplier: float = 1.0
    # stage-2 style training: freeze everything except stylizer + appearance
    # head; the stylizer encoder trains at lr * pretrained_scale.
    train_stylizer_only: bool = False
    pretrained_lr_scale: float = 0.1


@dataclass
class TrainCfg:
    batch_size: int = 2
    identity_loss: bool = False
    # Distillation (reference config/main.yaml train block): path to the
    # frozen DUSt3R/MASt3R teacher weights enables it; distill_only skips the
    # render/photometric losses (stage-0 pretraining).
    distiller: str = ""
    distill_max_steps: int = 1_000_000
    distill_only: bool = False
    val_every_n_steps: int = 500
    log_every_n_steps: int = 10
    seed: int = 0
    # Optional pretrained AdaIN ckpt: when set, validation logs the 2-D AdaIN
    # stylization baseline image (model_wrapper_style.py:260-308).
    adain_baseline_weights: str = ""


@dataclass
class CheckpointingCfg:
    every_n_train_steps: int = 3125
    save_top_k: int = -1
    load: Optional[str] = None
    resume: bool = False
    output_dir: str = "outputs"


@dataclass
class TestCfg:
    align_pose: bool = False
    pose_align_steps: int = 100
    rot_opt_lr: float = 3e-3
    trans_opt_lr: float = 1e-3
    compute_scores: bool = True
    save_image: bool = False
    save_video: bool = False
    output_path: str = "outputs/test"


@dataclass
class WandbCfg:
    """Reference config/main.yaml wandb block (main_style.py:61-77): mode
    'disabled' uses the LocalLogger; anything else attempts wandb and falls
    back to local logging if the package/network is unavailable."""

    project: str = "styl3r_tpu"
    entity: str = ""
    name: str = ""
    mode: str = "disabled"  # disabled | online | offline


@dataclass
class RootCfg:
    mode: str = "train"
    wandb: WandbCfg = field(default_factory=WandbCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    losses: LossCfg = field(default_factory=LossCfg)
    datasets: List[DatasetCfg] = field(default_factory=lambda: [DatasetCfg()])
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    train: TrainCfg = field(default_factory=TrainCfg)
    checkpointing: CheckpointingCfg = field(default_factory=CheckpointingCfg)
    test: TestCfg = field(default_factory=TestCfg)
    seed: int = 111123


# ---------------------------------------------------------------------------
# Loading / merging
# ---------------------------------------------------------------------------


def _merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_defaults(cfg: Dict, root_dir: Path) -> Dict:
    """Hydra-like `defaults:` composition: each entry 'group/name' merges
    configs/<group>/<name>.yaml under key <group> (or at top level for
    '_self_'-style plain names)."""
    defaults = cfg.pop("defaults", [])
    merged: Dict = {}
    for entry in defaults:
        if isinstance(entry, dict):
            ((group, name),) = entry.items()
            sub = load_yaml(root_dir / group / f"{name}.yaml", root_dir)
            merged = _merge(merged, {group: sub} if group != "_global_" else sub)
        else:
            sub = load_yaml(root_dir / f"{entry}.yaml", root_dir)
            merged = _merge(merged, sub)
    return _merge(merged, cfg)


def _find_configs_root(path: Path) -> Path:
    """Walk up from the config file to the directory holding main.yaml —
    `defaults:` entries are relative to that configs root."""
    d = Path(path).parent
    for candidate in [d, *d.parents]:
        if (candidate / "main.yaml").exists():
            return candidate
    return d


def load_yaml(path: Path, root_dir: Optional[Path] = None) -> Dict:
    path = Path(path)
    with path.open() as f:
        cfg = yaml.safe_load(f) or {}
    return _resolve_defaults(cfg, root_dir or _find_configs_root(path))


def _coerce(cls, value):
    if dataclasses.is_dataclass(cls) and isinstance(value, dict):
        return from_dict(cls, value)
    origin = getattr(cls, "__origin__", None)
    if origin in (list, List) and isinstance(value, list):
        (item_t,) = cls.__args__
        return [_coerce(item_t, v) for v in value]
    if origin in (tuple, Tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    # Scalar casts: YAML leaves '3e-5' as a string and ints where floats are
    # declared; coerce to the declared field type.
    if cls is float and isinstance(value, (int, str)):
        return float(value)
    if cls is int and isinstance(value, str):
        return int(value)
    if cls is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes")
    return value


def from_dict(cls, data: Dict):
    """dacite-lite: recursively build a dataclass from a dict, ignoring
    unknown keys (so configs can carry reference-only fields)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            continue
        kwargs[k] = _coerce(_field_type(cls, k), v)
    return cls(**kwargs)


def _field_type(cls, name):
    hints = typing.get_type_hints(cls)
    t = hints[name]
    # unwrap Optional
    if getattr(t, "__origin__", None) is typing.Union:
        args = [a for a in t.__args__ if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return t


def apply_overrides(cfg_dict: Dict, overrides: List[str]) -> Dict:
    """CLI overrides 'a.b.c=value' (YAML-parsed values)."""
    out = dict(cfg_dict)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, value = ov.split("=", 1)
        value = yaml.safe_load(value)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[int(p)] if isinstance(node, list) else node.setdefault(p, {})
        if isinstance(node, list):
            node[int(parts[-1])] = value
        else:
            node[parts[-1]] = value
    return out


def load_config(
    path: Optional[Path] = None, overrides: Optional[List[str]] = None
) -> RootCfg:
    cfg_dict: Dict = {}
    if path is not None:
        cfg_dict = load_yaml(path)
    if overrides:
        cfg_dict = apply_overrides(cfg_dict, overrides)
    return from_dict(RootCfg, cfg_dict)
