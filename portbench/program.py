"""The system under test: styl3r_tpu_torch's modules built as a
configuration states, with the weights the benchmark drew (loaded by key
name). Nothing else of the program is used: no FLOP count, no timing, no
plain version of a kernel."""

from __future__ import annotations

import torch

from .core import DTYPES, reference_weights, widths
from .reference.model import Styl3rRef
from .reference.teacher import Dust3RTeacher as TeacherRef


def styl3r_weights(config: dict, device: torch.device):
    return reference_weights(lambda: Styl3rRef(sh_degree=config["sh_degree"], **widths(config)),
                             config["weight_seed"], device)


def serving_model(config: dict, device: torch.device):
    """Styl3rModel with the configuration's serving dtypes: compute in
    `serve.compute_dtype`, trunks stored in it (cast_dtypes)."""
    from styl3r_tpu_torch.models.styl3r import Styl3rModel

    dtype = DTYPES[config["serve"]["compute_dtype"]]
    model = Styl3rModel(sh_degree=config["sh_degree"], backbone_dtype=dtype, head_trunk_dtype=dtype,
                        device=device, seed=config["weight_seed"], **widths(config))
    model.load_state_dict(styl3r_weights(config, device))
    if config["serve"]["storage_dtype"] != "float32":
        model.cast_dtypes()
    return model.eval()


def training_model(config: dict, device: torch.device):
    """Styl3rModel as the trainer builds it: float32 weights, the backbone
    computing in `train.backbone_dtype`, the heads in float32."""
    from styl3r_tpu_torch.models.styl3r import Styl3rModel

    model = Styl3rModel(sh_degree=config["sh_degree"], backbone_dtype=DTYPES[config["train"]["backbone_dtype"]],
                        device=device, seed=config["weight_seed"], **widths(config))
    model.load_state_dict(styl3r_weights(config, device))
    return model


def teacher_widths(config: dict) -> dict:
    w = dict(config["teacher"]["widths"])
    w["head_layer_dims"] = tuple(w["head_layer_dims"])
    return w


def teacher(config: dict, device: torch.device):
    """The frozen float32 distillation teacher (models/distiller.py), built
    without torch's own init and loaded with the benchmark's weights."""
    from styl3r_tpu_torch.models.distiller import Dust3RTeacher

    with torch.device("meta"):
        module = Dust3RTeacher(**teacher_widths(config))
    module = module.to_empty(device=device)
    module.load_state_dict(reference_weights(lambda: TeacherRef(**teacher_widths(config)),
                                             config["teacher"]["weight_seed"], device))
    return module.float().freeze()
