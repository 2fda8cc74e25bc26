"""The training runtime's contract, on the CPU with a tiny injected model:
Trainer.fit's step count and log cadence, validation's outputs, checkpoint
cadence and pruning, a resume equal to the uninterrupted run bit for bit,
the data stream continued from any batch's position without replaying it, a
mixed landscape/portrait stream through two step functions with
sparse_anchor=None, what raises, and the entry point
`python -m styl3r_tpu_torch.train.main`.

Torch only: the step's numeric parity with JAX is held by
tests/test_torch_train_step.py."""

import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from styl3r_tpu_torch.data import DatasetConfig, RE10kStyleDataset
from styl3r_tpu_torch.data.view_samplers import ViewSamplerBounded
from styl3r_tpu_torch.models.distiller import Dust3RTeacher
from styl3r_tpu_torch.models.styl3r import Batch, Styl3rModel
from styl3r_tpu_torch.train import main as train_main
from styl3r_tpu_torch.train.trainer import Trainer, endless_batches
from styl3r_tpu_torch.utils.config import load_config
from tests.test_data import make_scene

TINY = dict(
    enc_depth=1, dec_depth=2, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2,
    head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16),
)
SMALL_RENDER = ["model.decoder.max_per_tile=128", "model.decoder.max_tiles_per_gaussian=4"]


def _tiny(seed=0):
    return Styl3rModel(sh_degree=0, device="cpu", seed=seed, **TINY)


def _batch(rng, hw=(16, 16), b=2, v=2, t=2):
    k = np.asarray([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1.0]], np.float32)
    ext = np.broadcast_to(np.eye(4, dtype=np.float32), (b, t, 4, 4)).copy()
    ext[:, 1:, 0, 3] = 0.1
    return Batch(
        context_images=rng.uniform(0, 1, (b, v, *hw, 3)),
        context_intrinsics=np.broadcast_to(k, (b, v, 3, 3)),
        target_extrinsics=ext,
        target_intrinsics=np.broadcast_to(k, (b, t, 3, 3)),
        target_near=np.full((b, t), 0.5),
        target_far=np.full((b, t), 100.0),
        style_image=rng.uniform(0, 1, (b, 16, 16, 3)),
        target_images=rng.uniform(0.4, 0.6, (b, t, *hw, 3)),
        sparse_anchor=None,
    )


def _records(out_dir):
    return [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def stage2_run(tmp_path_factory):
    """Four steps of the paper's stage 2 (re10k_3view_style.yaml: style 10 +
    identity, stylizer-only) on explicit batches, validating and saving
    every 2 steps and keeping 1 periodic checkpoint."""
    out = tmp_path_factory.mktemp("stage2")
    cfg = load_config("configs/experiment/re10k_3view_style.yaml", [
        f"checkpointing.output_dir={out}", "train.val_every_n_steps=2", "train.log_every_n_steps=1",
        "checkpointing.every_n_train_steps=2", "checkpointing.save_top_k=1", *SMALL_RENDER,
    ])
    trainer = Trainer(cfg, model=_tiny())
    rng = np.random.default_rng(5)
    state = trainer.fit(max_steps=4, batches=iter([_batch(rng) for _ in range(4)]))
    trainer.close()
    return trainer, state, out


def test_fit_takes_the_steps_and_logs_each(stage2_run):
    trainer, state, out = stage2_run
    assert state.step == 4 and trainer.optimizer.schedule.last_epoch == 4
    records = _records(out)
    steps = [r["step"] for r in records if "loss" in r]
    assert steps == [1, 2, 3, 4]
    for r in records:
        if "loss" in r:
            assert {"style", "identity", "grad_norm", "live_pairs", "pair_slots", "seconds_per_step",
                    "step_ms", "data_seconds"} <= r.keys() and np.isfinite(r["loss"])
            # The logged step's spans (utils/trace.py), each inside the step.
            spans = {k for k in r if k.endswith("_ms")}
            assert {"forward_ms", "loss_ms", "backward_ms", "clip_ms", "adamw_ms", "encoder_ms", "render_ms"} <= spans
            assert all(0 <= r[k] <= r["step_ms"] for k in spans)
    assert [r["step"] for r in records if "val_psnr" in r] == [2, 4]
    assert [r["step"] for r in records if "validate_seconds" in r] == [2, 4]
    assert [r["step"] for r in records if "checkpoint_seconds" in r] == [2, 4]
    assert all(r["checkpoint_bytes"] > 0 for r in records if "checkpoint_seconds" in r)


def test_validation_writes_its_outputs(stage2_run):
    _, _, out = stage2_run
    for name in ("val_comparison", "val_trajectory", "val_projections", "val_cameras", "val_camera_frustums"):
        assert sorted(p.name for p in (out / name).glob("*.png")) == ["00000002.png", "00000004.png"], name
    wobble = sorted((out / "val_wobble").iterdir())
    assert [p.name for p in wobble] == ["00000002", "00000004"] and len(list(wobble[0].glob("*.png"))) == 8
    assert Image.open(out / "val_projections" / "00000004.png").size == (3 * 256 + 4, 256 + 16)


def test_checkpoints_follow_the_cadence_and_save_top_k(stage2_run):
    """Saved at steps 2 and 4, step 2 pruned by save_top_k=1; the file holds
    the model, the optimizer (no state for the frozen stage-2 parameters)
    and the step."""
    trainer, _, out = stage2_run
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["step_4.pt"]
    ckpt = torch.load(out / "checkpoints" / "step_4.pt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["model"].keys() == trainer.model.state_dict().keys()
    trained = [p for p in trainer.model.parameters() if p.requires_grad]
    assert 0 < len(trained) < len(list(trainer.model.parameters()))
    assert len(ckpt["optimizer"]["adamw"]["state"]) == len(trained)
    assert ckpt["optimizer"]["schedule"]["last_epoch"] == 4
    # Its weights load back by key (load_params), strictly.
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.zero_()
    trainer.load_params(out / "checkpoints" / "step_4.pt")
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, ckpt["model"][key]), key


def test_mixed_aspect_stream_trains_through_two_step_functions(tmp_path):
    """Landscape and portrait batches, sparse_anchor=None: one step function
    for each shape, the portrait one through the transposed encoder (the
    case the JAX trainer's Batch coercion crashes on)."""
    cfg = load_config(None, [f"checkpointing.output_dir={tmp_path}", "losses.mse=1.0", "train.val_every_n_steps=100",
                             "checkpointing.every_n_train_steps=100", *SMALL_RENDER])
    trainer = Trainer(cfg, model=_tiny())
    rng = np.random.default_rng(9)
    batches = iter([_batch(rng, hw) for hw in ((16, 32), (32, 16), (16, 32), (32, 16))])
    state = trainer.fit(max_steps=4, batches=batches)
    trainer.close()
    assert state.step == 4
    assert set(trainer._step_cache) == {(16, 32), (32, 16)}
    assert all(np.isfinite(r["loss"]) for r in _records(tmp_path) if "loss" in r)


def test_distillation_builds_a_frozen_teacher_and_the_adain_baseline_raises(tmp_path, capsys):
    """losses.distill builds the teacher at random, with a warning, drawn on
    the CPU from a fixed seed; train.distiller loads a MASt3R `model` dict
    into it instead. Either way it is frozen, f32, and no part of the model,
    so it stays out of the optimizer and the checkpoints."""
    teacher_dims = dict(TINY, head_last_dim=8)
    cfg = load_config(None, [f"checkpointing.output_dir={tmp_path}", "losses.distill=0.1"])
    drawn = [Trainer(cfg, model=_tiny(), teacher=Dust3RTeacher(**teacher_dims)) for _ in range(2)]
    assert capsys.readouterr().out.count("teacher will be RANDOMLY INITIALIZED") == 2
    for trainer in drawn:
        distill = trainer.distill
        assert distill.weight == 0.1 and not distill.distill_only and distill.max_steps == 1_000_000
        assert not distill.teacher.training
        assert all(not p.requires_grad and p.dtype == torch.float32 for p in distill.teacher.parameters())
        assert not any(k.startswith(("teacher", "backbone.", "downstream")) for k in trainer.model.state_dict())
        trainer.close()
    for a, b in zip(drawn[0].distill.teacher.parameters(), drawn[1].distill.teacher.parameters()):
        assert torch.equal(a, b)

    weights = {k: torch.full_like(v, 0.5) for k, v in drawn[0].distill.teacher.state_dict().items()}
    torch.save({"model": weights}, tmp_path / "mast3r.pth")
    cfg = load_config(None, [f"checkpointing.output_dir={tmp_path}", f"train.distiller={tmp_path / 'mast3r.pth'}"])
    trainer = Trainer(cfg, model=_tiny(), teacher=Dust3RTeacher(**teacher_dims))
    assert "RANDOMLY" not in capsys.readouterr().out
    for k, v in trainer.distill.teacher.state_dict().items():
        assert torch.equal(v, weights[k]), k
    trainer.close()
    plain = Trainer(load_config(None, [f"checkpointing.output_dir={tmp_path}"]), model=_tiny())
    assert plain.distill is None
    plain.close()

    cfg = load_config("configs/experiment/re10k_3view_style.yaml", [
        f"checkpointing.output_dir={tmp_path}", "train.adain_baseline_weights=/weights/adain.pth",
        "train.val_every_n_steps=1", *SMALL_RENDER])
    trainer = Trainer(cfg, model=_tiny())
    # The baseline is ported (tests/test_torch_stylizers.py); a weights file
    # that is not there raises at the first validation.
    with pytest.raises(FileNotFoundError, match="adain.pth"):
        trainer.fit(max_steps=1, batches=iter([_batch(np.random.default_rng(0))]))
    trainer.close()


@pytest.fixture(scope="module")
def chunk_root(tmp_path_factory):
    """tests/test_data.py's synthetic chunks (30 noise frames of 72x96 a
    scene, cameras sliding along x) and a style root."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("re10k")
    (root / "train").mkdir()
    torch.save([make_scene(rng, f"scene_{i}") for i in range(3)], root / "train" / "000000.torch")
    style = root / "styles" / "train"
    style.mkdir(parents=True)
    Image.fromarray((rng.uniform(0, 1, (40, 60, 3)) * 255).astype(np.uint8)).save(style / "style0.jpg")
    (style / "scene_style_mapping_all.json").write_text(json.dumps({f"scene_{i}": "style0.jpg" for i in range(3)}))
    return root


def _main(chunk_root, out, max_steps, *extra):
    args = [
        "--config", "configs/experiment/re10k_3view_style.yaml", "--cpu", "--max-steps", str(max_steps),
        f"datasets.0.roots=[{chunk_root}]", f"datasets.0.style_root={chunk_root / 'styles'}",
        "datasets.0.original_image_shape=[72,96]", "datasets.0.input_image_shape=[16,16]",
        "datasets.0.view_sampler.num_context_views=2", "datasets.0.view_sampler.num_target_views=2",
        "datasets.0.view_sampler.min_gap=10", "datasets.0.view_sampler.max_gap=20",
        "train.batch_size=2", "train.val_every_n_steps=100", "train.log_every_n_steps=1",
        "checkpointing.every_n_train_steps=2", f"checkpointing.output_dir={out}", *SMALL_RENDER, *extra,
    ]
    return train_main.main(args, model=_tiny())


def test_main_resumes_exactly_where_the_run_stopped(chunk_root, tmp_path):
    """`main` on synthetic chunks, 4 steps at once against 2 steps and a
    resume from their step-2 checkpoint: the resumed steps log the same
    metrics and end at the same weights and optimizer state, bit for bit
    (each step's dropout generator comes from (seed, step); the stream
    continues from the position the checkpoint holds). The view sampler's
    curriculum widens the gap over these steps (from 4-6 frames to 10-20 in
    3 steps), so its draws depend on the step the stream hands it."""
    whole, part = tmp_path / "whole", tmp_path / "part"
    warm_up = ["datasets.0.view_sampler.warm_up_steps=3", "datasets.0.view_sampler.initial_min_gap=4",
               "datasets.0.view_sampler.initial_max_gap=6"]
    assert _main(chunk_root, whole, 4, *warm_up).step == 4
    assert _main(chunk_root, part, 2, *warm_up).step == 2
    resumed = _main(chunk_root, part, 4, *warm_up, f"checkpointing.load={part / 'checkpoints' / 'step_2.pt'}",
                    "checkpointing.resume=true")
    assert resumed.step == 4
    assert not [t for t in threading.enumerate() if t.name == "batch-producer"]

    def logged(out):
        # Host and device times, the step's spans among them, differ run to run.
        return [{k: v for k, v in r.items() if k not in ("seconds_per_step", "data_seconds") and not k.endswith("_ms")}
                for r in _records(out) if "loss" in r]

    assert logged(part) == logged(whole)  # steps 1-2, then the resumed 3-4
    a = torch.load(whole / "checkpoints" / "final.pt", weights_only=True)
    b = torch.load(part / "checkpoints" / "final.pt", weights_only=True)
    assert a["step"] == b["step"] == 4
    for key, value in a["model"].items():
        assert torch.equal(value, b["model"][key]), key
    for key, value in a["optimizer"]["adamw"]["state"].items():
        for name, tensor in value.items():
            assert torch.equal(tensor, b["optimizer"]["adamw"]["state"][key][name]), (key, name)


@pytest.fixture(scope="module")
def three_chunk_root(tmp_path_factory):
    """Three chunks of two scenes each."""
    rng = np.random.default_rng(1)
    root = tmp_path_factory.mktemp("re10k_three")
    (root / "train").mkdir()
    for c in range(3):
        torch.save([make_scene(rng, f"scene_{c}{i}") for i in range(2)], root / "train" / f"00000{c}.torch")
    return root


def _stream_datasets(chunk_root, three_chunk_root, b):
    """Two datasets taking turns: 6 examples an epoch over three chunks, and 3
    in one chunk (one dropped at each epoch's end) with style images, with a
    moving curriculum and flips. An epoch's batches come as A B A A: the
    second is spent while the first goes on."""
    def dataset(root, seed, style_root=None):
        cfg = DatasetConfig(roots=[root], style_root=style_root, input_image_shape=(16, 16),
                            original_image_shape=(72, 96))
        sampler = ViewSamplerBounded(2, 2, min_gap=10, max_gap=20, warm_up_steps=6, initial_min_gap=2,
                                     initial_max_gap=4)
        return RE10kStyleDataset(cfg, "train", sampler, seed=seed, step_of=lambda n: n // b * 2)

    return [dataset(three_chunk_root, 1), dataset(chunk_root, 2, chunk_root / "styles")]


def test_stream_continues_from_any_batch_position(chunk_root, three_chunk_root, tmp_path):
    """The trainer's data stream restarted from the position after batch k
    (through torch.save and a weights-only load, as a checkpoint holds it)
    yields batches k+1... of the uninterrupted stream, across both datasets'
    epoch ends. It builds no more than its prefetch's worth of examples
    before its first batch, however far the position lies (a replay would
    decode every batch before it); closing a stream stops its producers."""
    b, n = 2, 12
    stream = endless_batches(_stream_datasets(chunk_root, three_chunk_root, b), b)
    items = [next(stream) for _ in range(n)]
    stream.close()
    assert not [t for t in threading.enumerate() if t.name == "batch-producer"]
    assert all(position is not None for _, position in items)
    # The curriculum widens the context gap from 2-4 frames at step 0 to
    # 10-20 (near = 0.1 / (0.05 gap) once the baseline is scaled to 1).
    assert np.asarray(items[0][0].target_near).min() >= 0.5 - 1e-6
    assert np.asarray(items[-1][0].target_near).max() <= 0.2 + 1e-6

    for k in range(n - 1):
        torch.save(items[k][1], tmp_path / "position.pt")
        position = torch.load(tmp_path / "position.pt", weights_only=True)
        datasets = _stream_datasets(chunk_root, three_chunk_root, b)
        resumed = endless_batches(datasets, b, position)
        first = next(resumed)
        built = sum(ds.n_built - st["n_built"] for ds, st in zip(datasets, position["datasets"]))
        # Each producer holds at most the queue's 2 batches and one more.
        assert built <= len(datasets) * 4 * b, (k, built)
        for (want, _), (got, _) in zip(items[k + 1:], [first, *(next(resumed) for _ in range(n - k - 2))]):
            for x, y in zip(want, got):
                if x is None:
                    assert y is None
                else:
                    np.testing.assert_array_equal(x, y)
        resumed.close()


def test_main_needs_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: main runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main.main(["--config", "configs/main.yaml", f"checkpointing.output_dir={tmp_path}"])


def test_loading_an_orbax_directory_raises(chunk_root, tmp_path):
    (tmp_path / "orbax_step_100").mkdir()
    with pytest.raises(ValueError, match="orbax_to_torch.py"):
        _main(chunk_root, tmp_path / "out", 1, f"checkpointing.load={tmp_path / 'orbax_step_100'}")
