"""Port parity for the training data path and validation's helpers:
styl3r_tpu_torch's view samplers, shims, RE10kStyleDataset, collation,
orthographic renders, viz, drawing and warm starts against styl3r_tpu's on
the same inputs and seeds.

The data path is host-side numpy and PIL, so indices, flips, style picks
and images must be equal and the cameras agree to 1e-6. Both datasets are
pinned to their PIL decoders here (tests/test_torch_native.py holds their
native decoders, which resize off-size frames that PIL's path skips). Renders: 1e-5, as tests/test_torch_rasterizer.py
holds them. Drawing: 1e-5 (coverage from f32 distances, summed in other
orders). Warm starts: exact, since both only select and rename weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import styl3r_tpu.native
import styl3r_tpu_torch.native
from styl3r_tpu.data import dataset as jdataset
from styl3r_tpu.data import shims as jshims
from styl3r_tpu.data import view_samplers as jsamplers
from styl3r_tpu.geometry.gaussians import Gaussians as JGaussians
from styl3r_tpu.models import decoder as jdecoder
from styl3r_tpu.utils import checkpoint as jckpt
from styl3r_tpu.utils import drawing as jdrawing
from styl3r_tpu.utils import viz as jviz
from styl3r_tpu_torch.data import dataset as tdataset
from styl3r_tpu_torch.data import shims as tshims
from styl3r_tpu_torch.data import view_samplers as tsamplers
from styl3r_tpu_torch.data.types import Example, Views
from styl3r_tpu_torch.geometry.gaussians import Gaussians as TGaussians
from styl3r_tpu_torch.models import decoder as tdecoder
from styl3r_tpu_torch.models.styl3r import Styl3rModel
from styl3r_tpu_torch.utils import checkpoint as tckpt
from styl3r_tpu_torch.utils import drawing as tdrawing
from styl3r_tpu_torch.utils import viz as tviz
from styl3r_tpu_torch.utils.convert import from_jax_params
from tests.test_data import data_root  # noqa: F401  (the synthetic chunks, a fixture)

TINY = dict(
    enc_depth=1, dec_depth=2, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2,
    head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16),
)


# -- view samplers -------------------------------------------------------------


@pytest.mark.parametrize("stage", ["train", "test"])
@pytest.mark.parametrize("n_ctx", [2, 3])
def test_bounded_sampler_matches_jax(stage, n_ctx):
    """The curriculum's steps (warm-up 100: gaps 25 -> 45/90) and both stages,
    on one default_rng stream each; too few frames raises in both."""
    kw = dict(num_context_views=n_ctx, num_target_views=4, min_gap=45, max_gap=90, warm_up_steps=100,
              initial_min_gap=25, initial_max_gap=25, stage=stage)
    ours, ref = tsamplers.ViewSamplerBounded(**kw), jsamplers.ViewSamplerBounded(**kw)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for step in (0, 10, 50, 99, 100, 5000):
        for n_views in (100, 150):
            a = ours.sample("s", n_views, rng_a, step)
            b = ref.sample("s", n_views, rng_b, step)
            np.testing.assert_array_equal(a.context, b.context)
            np.testing.assert_array_equal(a.target, b.target)
            assert a.context.dtype == b.context.dtype and a.overlap == b.overlap
    assert rng_a.random() == rng_b.random()
    for sampler, rng in ((ours, rng_a), (ref, rng_b)):
        with pytest.raises(ValueError):
            sampler.sample("s", 20, rng, 5000)


@pytest.mark.parametrize("n_ctx", [2, 3])
def test_evaluation_sampler_matches_jax_on_the_index(n_ctx):
    """Every scene of assets/evaluation_index_re10k.json, with the 2 -> 3
    context upsample; scenes without an entry raise in both."""
    path = "assets/evaluation_index_re10k.json"
    ours = tsamplers.make_view_sampler("evaluation", index_path=path, num_context_views=n_ctx)
    ref = jsamplers.make_view_sampler("evaluation", index_path=path, num_context_views=n_ctx)
    assert ours.index.keys() == ref.index.keys()
    for scene in ours.index:
        if ours.index[scene] is None:
            for sampler in (ours, ref):
                with pytest.raises(ValueError):
                    sampler.sample(scene, 300)
            continue
        a, b = ours.sample(scene, 300), ref.sample(scene, 300)
        np.testing.assert_array_equal(a.context, b.context)
        np.testing.assert_array_equal(a.target, b.target)
        assert len(a.context) == n_ctx and a.overlap == b.overlap


def test_arbitrary_and_all_samplers_match_jax():
    for name, kw in (("arbitrary", dict(num_context_views=3, num_target_views=5)), ("all", {})):
        ours, ref = tsamplers.make_view_sampler(name, **kw), jsamplers.make_view_sampler(name, **kw)
        rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
        for _ in range(20):
            a, b = ours.sample("s", 40, rng_a), ref.sample("s", 40, rng_b)
            np.testing.assert_array_equal(a.context, b.context)
            np.testing.assert_array_equal(a.target, b.target)


# -- shims ---------------------------------------------------------------------


def _views(rng, v, hw=(8, 12), cls=Views):
    ext = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    ext[:, :3, 3] = rng.normal(size=(v, 3))
    return cls(
        extrinsics=ext, intrinsics=np.tile(np.eye(3, dtype=np.float32), (v, 1, 1)),
        image=rng.uniform(0, 1, (v, *hw, 3)).astype(np.float32), near=np.full(v, 0.1, np.float32),
        far=np.full(v, 100.0, np.float32), index=np.arange(v), overlap=np.asarray([0.5], np.float32),
    )


def test_training_shims_match_jax():
    from styl3r_tpu.data import types as jtypes

    rng = np.random.default_rng(5)
    ext = rng.normal(size=(4, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(tshims.reflect_extrinsics(ext), jshims.reflect_extrinsics(ext))
    images = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tshims.normalize_to_unit(images), jshims.normalize_to_unit(images))
    for n in (1, 3):
        for a, b in zip(tshims.compute_depth_bounds(ext[:n]), jshims.compute_depth_bounds(ext[:n])):
            np.testing.assert_array_equal(a, b)
    k = np.asarray([[0.8, 0, 0.5], [0, 0.9, 0.45], [0, 0, 1]], np.float32)
    rng_a, rng_b = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(5):
        for a, b in zip(tshims.random_patch_crop(images[0], k, 5, rng_a), jshims.random_patch_crop(images[0], k, 5, rng_b)):
            np.testing.assert_array_equal(a, b)
    # The flip: 20 draws from one stream each, about half of them flipped.
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    flips = 0
    for _ in range(20):
        seed = int(rng.integers(1 << 30))
        ex_t = Example(_views(np.random.default_rng(seed), 2), _views(np.random.default_rng(seed + 1), 3), "s",
                       np.zeros((4, 4, 3), np.float32), "x")
        ex_j = jtypes.Example(_views(np.random.default_rng(seed), 2, cls=jtypes.Views),
                              _views(np.random.default_rng(seed + 1), 3, cls=jtypes.Views), "s",
                              np.zeros((4, 4, 3), np.float32), "x")
        a, b = tshims.apply_augmentation(ex_t, rng_a), jshims.apply_augmentation(ex_j, rng_b)
        flips += a is not ex_t
        assert (a is ex_t) == (b is ex_j)
        for va, vb in ((a.context, b.context), (a.target, b.target)):
            for name in ("extrinsics", "intrinsics", "image", "near", "far", "index", "overlap"):
                np.testing.assert_array_equal(getattr(va, name), getattr(vb, name))
    assert 3 <= flips <= 17


# -- dataset and collation -----------------------------------------------------


def _datasets(root, stage, monkeypatch, seed=3):
    monkeypatch.setattr(styl3r_tpu.native, "decode_jpeg_batch", lambda *a, **k: None)
    monkeypatch.setattr(styl3r_tpu_torch.native, "decode_jpeg_batch", lambda *a, **k: None)
    kw = dict(num_context_views=3, num_target_views=4, min_gap=10, max_gap=20, stage=stage)
    cfg = dict(roots=[root], style_root=root / "styles", input_image_shape=(32, 48), original_image_shape=(72, 96))
    ours = tdataset.RE10kStyleDataset(tdataset.DatasetConfig(**cfg), stage, tsamplers.ViewSamplerBounded(**kw),
                                      seed=seed, shard_id=0, num_shards=1)
    ref = jdataset.RE10kStyleDataset(jdataset.DatasetConfig(**cfg), stage, jsamplers.ViewSamplerBounded(**kw),
                                     seed=seed, shard_id=0, num_shards=1)
    return ours, ref


@pytest.mark.parametrize("stage", ["train", "test"])
def test_dataset_yields_the_jax_examples(data_root, stage, monkeypatch):  # noqa: F811
    """Two epochs of each stage's stream (the train stage shuffles and flips):
    scene, view indices, flips, style, intrinsics and extrinsics to 1e-6,
    near/far, and equal images."""
    ours, ref = _datasets(data_root, stage, monkeypatch)
    assert [p.name for p in ours.chunks] == [p.name for p in ref.chunks]
    n = 0
    for _ in range(2):
        pairs = list(zip(ours, ref, strict=True))
        for a, b in pairs:
            assert (a.scene, a.style_name) == (b.scene, b.style_name)
            np.testing.assert_array_equal(a.style_image, b.style_image)
            for va, vb in ((a.context, b.context), (a.target, b.target)):
                np.testing.assert_array_equal(va.index, vb.index)
                np.testing.assert_array_equal(va.image, vb.image)
                for name in ("extrinsics", "intrinsics", "near", "far", "overlap"):
                    np.testing.assert_allclose(getattr(va, name), getattr(vb, name), rtol=1e-6, atol=1e-6)
            assert a.context.image.shape == (3, 32, 48, 3)
        n += len(pairs)
    assert n == 6


def test_collation_and_aspect_buckets(data_root, monkeypatch):  # noqa: F811
    """collate_examples gives JAX's arrays; batch_iterator(aspect_buckets)
    groups a mixed landscape/portrait stream into batches of one shape; an
    error in the producer thread reaches the consumer."""
    ours, ref = _datasets(data_root, "test", monkeypatch)
    a, b = tdataset.collate_examples(list(ours)), jdataset.collate_examples(list(ref))
    assert a._fields == b._fields
    for x, y in zip(a, b):
        if y is None:
            assert x is None
        else:
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6, atol=1e-6)

    examples = list(ours)
    portrait = [Example(*[Views(**{**e.__dict__, "image": e.image.transpose(0, 2, 1, 3)}) for e in (ex.context, ex.target)],
                        ex.scene, ex.style_image) for ex in examples]
    stream = [examples[0], portrait[0], portrait[1], examples[1], examples[2], portrait[2]]
    shapes = [x.context_images.shape[2:4] for x in tdataset.batch_iterator(stream, 2, aspect_buckets=True)]
    assert shapes == [(48, 32), (32, 48)]
    tail = [x.context_images.shape[0] for x in tdataset.batch_iterator(stream, 2, drop_last=False, aspect_buckets=True)]
    assert tail == [2, 2, 1, 1]

    def broken():
        yield examples[0]
        raise KeyError("scene_x not in scene_style_mapping")

    with pytest.raises(KeyError, match="scene_x"):
        list(tdataset.batch_iterator(broken(), 1))


# -- orthographic renders ------------------------------------------------------


def test_orthographic_projection_matches_jax():
    """Validation's front/top/side projections of a Gaussian cloud (cameras
    from viz.ortho_projection_cameras, pulled back ~573x the view's width
    with a 0.1 degree field of view): cameras exact, renders against JAX's
    impl="jnp"."""
    rng = np.random.default_rng(8)
    g = 300
    means = np.stack([rng.uniform(-1, 1, g), rng.uniform(-1, 1, g), rng.uniform(1, 3, g)], -1).astype(np.float32)
    fields = dict(
        means=means, covariances=None,
        harmonics=rng.uniform(-1, 1, (g, 3, 1)).astype(np.float32), opacities=rng.uniform(0.3, 0.9, g).astype(np.float32),
        scales=rng.uniform(0.02, 0.1, (g, 3)).astype(np.float32), rotations=rng.normal(size=(g, 4)).astype(np.float32),
    )
    cams = tviz.ortho_projection_cameras(means)
    for a, b in zip(cams, jviz.ortho_projection_cameras(means)):
        np.testing.assert_array_equal(a, b)
    cams = [c[None] for c in cams]
    for a, b in zip(tdecoder.orthographic_cameras(*map(torch.from_numpy, cams)),
                    jdecoder.orthographic_cameras(*map(jnp.asarray, cams))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    kw = dict(max_per_tile=512, max_tiles_per_gaussian=16)
    ours = tdecoder.render_orthographic(
        TGaussians(**{k: None if v is None else torch.from_numpy(v)[None] for k, v in fields.items()}),
        *map(torch.from_numpy, cams), (32, 32), **kw)
    ref = jax.jit(lambda g, *c: jdecoder.render_orthographic(g, *c, (32, 32), impl="jnp", **kw))(
        JGaussians(**{k: None if v is None else jnp.asarray(v)[None] for k, v in fields.items()}),
        *map(jnp.asarray, cams))
    assert float(ref.alpha.max()) > 0.5
    for name in ("color", "alpha"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-5)
    depth_scale = float(np.abs(np.asarray(ref.depth)).max())
    np.testing.assert_allclose(ours.depth.numpy(), np.asarray(ref.depth), rtol=1e-5, atol=1e-5 * depth_scale)


# -- viz and drawing -----------------------------------------------------------


def test_viz_matches_jax_and_matplotlib():
    import matplotlib

    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    values = rng.uniform(-0.1, 1.1, (64, 64)).astype(np.float32)
    values[0, :2] = (0.0, 1.0)
    np.testing.assert_array_equal(
        tviz.apply_color_map(values), matplotlib.colormaps["turbo"](np.clip(values, 0, 1))[..., :3].astype(np.float32))
    np.testing.assert_array_equal(tviz.color_map_depth(values + 2), jviz.color_map_depth(values + 2))
    pts, ends = rng.uniform(-5, 70, (6, 2)), rng.uniform(-5, 70, (6, 2))
    for a, b in (
        (tviz.add_border(img), jviz.add_border(img)),
        (tviz.hcat(img, img[:32]), jviz.hcat(img, img[:32])),
        (tviz.vcat(img, img[:, :32]), jviz.vcat(img, img[:, :32])),
        (tviz.annotate(img, "front (xy)"), jviz.annotate(img, "front (xy)")),
        (tviz.draw_points(img, pts, radius=2), jviz.draw_points(img, pts, radius=2)),
        (tviz.draw_lines(img, pts, ends), jviz.draw_lines(img, pts, ends)),
    ):
        np.testing.assert_array_equal(a, b)
    ext = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    ext[:, 0, 3] = (0.0, 0.4, 0.8)
    k = np.tile(np.asarray([[0.8, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (3, 1, 1))
    np.testing.assert_array_equal(tviz.draw_cameras_topdown(ext, k, 64), jviz.draw_cameras_topdown(ext, k, 64))
    gallery = (img[None].repeat(2, 0), img[None].repeat(3, 0), img[None].repeat(3, 0))
    np.testing.assert_array_equal(
        tviz.validation_gallery(*gallery, depth=values[None].repeat(3, 0) + 1, style_image=img),
        jviz.validation_gallery(*gallery, depth=values[None].repeat(3, 0) + 1, style_image=img))


@pytest.mark.parametrize("cap", ["round", "butt", "square"])
def test_drawing_matches_jax(cap):
    rng = np.random.default_rng(10)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    start, end, color = rng.uniform(-4, 68, (7, 2)), rng.uniform(-4, 68, (7, 2)), rng.uniform(0, 1, (7, 3))
    ranges = dict(x_range=(-2.0, 70.0), y_range=(5.0, 60.0))
    for kw in ({}, ranges):
        a = tdrawing.draw_lines(torch.from_numpy(img), start, end, color, width=3, cap=cap, **kw).numpy()
        b = np.asarray(jdrawing.draw_lines(jnp.asarray(img), start, end, color, width=3, cap=cap, **kw))
        np.testing.assert_allclose(a, b, atol=1e-5)
    a = tdrawing.draw_points(torch.from_numpy(img), start, color, radius=5, inner_radius=2).numpy()
    b = np.asarray(jdrawing.draw_points(jnp.asarray(img), start, color, radius=5, inner_radius=2))
    np.testing.assert_allclose(a, b, atol=1e-5)
    ext = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    ext[:, :3, 3] = rng.normal(size=(3, 3))
    ext[1, :3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    k = np.tile(np.asarray([[0.8, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (3, 1, 1))
    cols = rng.uniform(0, 1, (3, 3))
    np.testing.assert_allclose(tdrawing.draw_cameras(64, ext, k, cols, near=0.1, far=2.0),
                               jdrawing.draw_cameras(64, ext, k, cols, near=0.1, far=2.0), atol=1e-5)


# -- warm starts ---------------------------------------------------------------

HEADS = ("downstream_head1", "downstream_head2", "gaussian_param_head", "gaussian_param_head2",
         "gaussian_appearance_head")


def _released(sd):
    """A state dict as releases carry it: with each trunk's unused
    refinenet4.resConfUnit1 and an entry no model has."""
    sd = dict(sd)
    for head in HEADS:
        for conv in ("conv1", "conv2"):
            p = f"encoder.{head}.dpt.scratch.refinenet4.resConfUnit1.{conv}"
            sd[f"{p}.weight"], sd[f"{p}.bias"] = torch.zeros(16, 16, 3, 3), torch.zeros(16)
    sd["encoder.backbone.mask_token"] = torch.zeros(1, 1, 32)
    return sd


def _checkpoint(flavor):
    """Checkpoints of each flavor from a tiny port model's weights: a full
    Styl3R one; a NoPoSplat one (no stylizer or appearance head; gs heads
    with structure + SH rows); a raw MASt3R `model` dict (the backbone
    without dec_blocks2, and a head of its own)."""
    sd = _released(Styl3rModel(sh_degree=1, device="cpu", seed=1, **TINY).state_dict())
    if flavor == "styl3r":
        return sd
    if flavor == "noposplat":
        out = {k: v for k, v in sd.items() if not k.startswith(("encoder.token_stylizer.", "encoder.gaussian_appearance"))}
        for head in ("gaussian_param_head", "gaussian_param_head2"):
            for p in ("weight", "bias"):
                key = f"encoder.{head}.dpt.head.4.{p}"
                out[key] = torch.cat([sd[key], sd[f"encoder.gaussian_appearance_head.dpt.head.4.{p}"] + 0.5])
        return out
    prefix = "encoder.backbone."
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix) and ".dec_blocks2." not in k}
    out["downstream_head1.proj.weight"] = torch.ones(3, 3)
    return out


@pytest.mark.parametrize("flavor", ["styl3r", "noposplat", "mast3r", "stylizer_noposplat", "stylizer_mast3r"])
def test_warm_starts_match_jax(flavor):
    """warm_start_encoder_params (three flavors) and convert_stylizer_weights
    (two) loaded over a model's init equal JAX's merge_params of its
    converters over the same init, carried back by the weights bridge."""
    source = _checkpoint(flavor.split("_")[-1])
    if flavor.startswith("stylizer"):
        ours, ref = tckpt.convert_stylizer_weights(source), jckpt.convert_stylizer_weights(source)
    else:
        ours = tckpt.warm_start_encoder_params(source, sh_degree=1)
        ref = jckpt.warm_start_encoder_params(source, sh_degree=1)
    model = Styl3rModel(sh_degree=1, device="cpu", seed=2, **TINY)
    base = jckpt.convert_styl3r_encoder(_released(model.state_dict()))
    expected = {k: v for k, v in from_jax_params(jckpt.merge_params(base, ref)).items() if tckpt.UNUSED_KEY not in k}
    unused = tckpt.load_warm_start(model, ours)
    got = model.state_dict()
    assert got.keys() == expected.keys()
    for key, value in expected.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)
    init = Styl3rModel(sh_degree=1, device="cpu", seed=2, **TINY).state_dict()
    assert any(not torch.equal(v, init[k]) for k, v in got.items())  # the warm start reached the model
    assert ("encoder.backbone.mask_token" in unused) == (flavor in ("styl3r", "noposplat", "mast3r"))


@pytest.mark.parametrize("new_size", [(16, 16), (8, 12)])
def test_resample_patch_embed_kernel_matches_jax(new_size):
    """The torch (out, in, h, w) weight against JAX's (h, w, in, out) kernel;
    the MASt3R converter resamples a checkpoint of another patch size."""
    kernel = np.random.default_rng(11).normal(size=(14, 14, 3, 8)).astype(np.float32)
    ours = tckpt.resample_patch_embed_kernel(torch.from_numpy(kernel).permute(3, 2, 0, 1), new_size)
    np.testing.assert_allclose(ours.permute(2, 3, 1, 0).numpy(), jckpt.resample_patch_embed_kernel(kernel, new_size),
                               rtol=1e-6, atol=1e-6)
    source = _checkpoint("mast3r")
    source["patch_embed.proj.weight"] = torch.from_numpy(kernel).permute(3, 2, 0, 1)
    ours = tckpt.convert_mast3r_backbone(source, patch_size=16)["encoder.backbone.patch_embed.proj.weight"]
    ref = jckpt.convert_mast3r_backbone(source, patch_size=16)["params"]["backbone"]["encoder"]["patch_embed"]["proj"]["kernel"]
    np.testing.assert_allclose(ours.permute(2, 3, 1, 0).numpy(), ref, rtol=1e-6, atol=1e-6)
