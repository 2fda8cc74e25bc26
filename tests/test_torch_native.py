"""Port parity for the native host decoder (styl3r_tpu_torch.native, the
port's copy of styl3r_tpu/native/loader.cpp, built with the JAX Makefile's
flags) against styl3r_tpu.native, and for the datasets that decode through
it.

  * decode_jpeg_batch and resize_lanczos equal the JAX package's bit for
    bit, on frames of the canonical shape and of smaller and larger ones;
    a frame that fails to decode gives None on both sides.
  * On a chunk with off-size frames the port's and the JAX dataset, both
    decoding natively, yield the same batches; the off-size frames are kept
    and resized, where PIL's path skips their examples.

The tests skip, with the reason the build failed, where the library cannot be
built (no g++ or no jpeglib.h).
"""

import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

import styl3r_tpu.native as jnative
import styl3r_tpu_torch.native as tnative
from styl3r_tpu.data import dataset as jdataset
from styl3r_tpu.data import view_samplers as jsamplers
from styl3r_tpu_torch.data import dataset as tdataset
from styl3r_tpu_torch.data import view_samplers as tsamplers
from tests.test_data import make_jpeg_bytes, make_scene

SHAPE = (72, 96)
OFF_SIZE = {3: (60, 80), 11: (90, 120), 17: (72, 100)}  # frame index -> its shape


@pytest.fixture(scope="module")
def libraries():
    if not tnative.native_available():
        pytest.skip(f"the port's native library is unavailable: {tnative.unavailable_reason()}")
    if not jnative.native_available():
        pytest.skip("the JAX package's native library is unavailable")


def _jpegs(rng, shapes):
    return [make_jpeg_bytes(rng, *shape) for shape in shapes]


def test_decode_and_resize_match_jax_bit_for_bit(libraries):
    rng = np.random.default_rng(0)
    jpegs = _jpegs(rng, [SHAPE, (60, 80), SHAPE, (90, 120), (72, 100)])
    ours, ref = tnative.decode_jpeg_batch(jpegs, SHAPE), jnative.decode_jpeg_batch(jpegs, SHAPE)
    assert ours.shape == (5, *SHAPE, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    # Canonical frames are decoded as PIL decodes them; the others resized.
    for i in (0, 2):
        with Image.open(io.BytesIO(jpegs[i])) as img:
            np.testing.assert_array_equal(ours[i], np.asarray(img.convert("RGB"), np.float32) / 255.0)
    assert np.abs(ours[1] - ours[3]).max() > 0.1
    image = rng.uniform(0, 1, (50, 70, 3)).astype(np.float32)
    for shape in ((31, 44), (50, 70), (80, 120)):
        np.testing.assert_array_equal(tnative.resize_lanczos(image, shape), jnative.resize_lanczos(image, shape))
    assert tnative.decode_jpeg_batch([jpegs[0], b"not a jpeg"], SHAPE) is None
    assert jnative.decode_jpeg_batch([jpegs[0], b"not a jpeg"], SHAPE) is None


@pytest.fixture(scope="module")
def off_size_root(tmp_path_factory):
    """One train chunk of two scenes whose frames 3, 11 and 17 are of
    another shape than 72x96, and a style root."""
    rng = np.random.default_rng(1)
    root = tmp_path_factory.mktemp("re10k_off_size")
    (root / "train").mkdir()
    scenes = [make_scene(rng, f"scene_{i}") for i in range(2)]
    for scene in scenes:
        for index, shape in OFF_SIZE.items():
            scene["images"][index] = torch.frombuffer(bytearray(make_jpeg_bytes(rng, *shape)), dtype=torch.uint8)
    torch.save(scenes, root / "train" / "000000.torch")
    style = root / "styles" / "train"
    style.mkdir(parents=True)
    Image.fromarray((rng.uniform(0, 1, (40, 60, 3)) * 255).astype(np.uint8)).save(style / "style0.jpg")
    (style / "scene_style_mapping_all.json").write_text(json.dumps({s["key"]: "style0.jpg" for s in scenes}))
    return root


def _examples(module, samplers, root, epochs=3):
    kw = dict(num_context_views=2, num_target_views=3, min_gap=8, max_gap=14, stage="train")
    cfg = module.DatasetConfig(roots=[root], style_root=root / "styles", input_image_shape=(32, 48),
                               original_image_shape=SHAPE)
    ds = module.RE10kStyleDataset(cfg, "train", samplers.ViewSamplerBounded(**kw), seed=5, shard_id=0,
                                  num_shards=1)
    return ds, [ex for _ in range(epochs) for ex in ds]


def test_datasets_keep_and_resize_off_size_frames_alike(libraries, off_size_root, monkeypatch):
    ours_ds, ours = _examples(tdataset, tsamplers, off_size_root)
    _, ref = _examples(jdataset, jsamplers, off_size_root)
    assert ours_ds.decoded == {"native": len(ours), "pil": 0} and ours_ds.fallback_reason is None
    kept = [ex for ex in ours if set(OFF_SIZE) & {*ex.context.index.tolist(), *ex.target.index.tolist()}]
    assert len(ours) == len(ref) == 6 and kept
    a, b = tdataset.collate_examples(ours), jdataset.collate_examples(ref)
    for name, x, y in zip(a._fields, a, b):
        if y is None:
            assert x is None, name
        elif name.endswith("images") or name == "style_image":
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=name)

    # PIL's path skips the examples that hold an off-size frame, and says why
    # it decodes with PIL.
    monkeypatch.setattr(tnative, "decode_jpeg_batch", lambda *a, **k: None)
    pil_ds, pil = _examples(tdataset, tsamplers, off_size_root)
    assert pil_ds.fallback_reason == "a frame failed to decode natively"
    assert 0 < len(pil) < len(ours)
    assert all(not set(OFF_SIZE) & {*ex.context.index.tolist(), *ex.target.index.tolist()} for ex in pil)


def test_build_failures_name_their_reason(tmp_path, monkeypatch):
    """What a failed build reports, and so what the dataset prints when it
    falls back to PIL: a missing jpeglib.h by name, another compiler error
    by its exit code and last line. Runs without the library."""
    compiler = tmp_path / "cxx"
    compiler.write_text("#!/bin/sh\necho 'loader.cpp:20:10: fatal error: jpeglib.h: No such file' >&2\nexit 1\n")
    compiler.chmod(0o755)
    monkeypatch.setenv("CXX", str(compiler))
    assert tnative._build(tmp_path / "lib.so") == "no jpeglib.h (libjpeg's headers are not installed)"
    compiler.write_text("#!/bin/sh\necho 'ld: cannot find -ljpeg' >&2\nexit 2\n")
    assert tnative._build(tmp_path / "lib.so") == f"{compiler} exited 2: ld: cannot find -ljpeg"
    assert not (tmp_path / "lib.so").exists()
