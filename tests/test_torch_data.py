"""Port parity for the inference path's data readers: styl3r_tpu_torch.data
(shims, chunks, COLMAP and LLFF) against styl3r_tpu.data on the same files
and arrays. All of it is host-side numpy and PIL, so everything is exact.
The COLMAP models are written here with struct, in COLMAP's binary and text
formats."""

import io
import json
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from styl3r_tpu.data import chunks as jchunks
from styl3r_tpu.data import colmap as jcolmap
from styl3r_tpu.data import shims as jshims
from styl3r_tpu_torch.data import chunks as tchunks
from styl3r_tpu_torch.data import colmap as tcolmap
from styl3r_tpu_torch.data import shims as tshims
from tests.test_data import make_scene


def _image(rng, h, w):
    return rng.uniform(0, 1, (h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", [(40, 56), (72, 96), (30, 30)], ids=["down", "same", "square"])
def test_rescale_matches_jax(shape):
    image = _image(np.random.default_rng(0), 72, 96)
    ours = tshims.rescale(image, shape)
    np.testing.assert_array_equal(ours, jshims.rescale(image, shape))
    assert ours.shape == (*shape, 3) and ours is not image


def test_crops_and_style_image_match_jax():
    rng = np.random.default_rng(1)
    images = np.stack([_image(rng, 72, 96) for _ in range(3)])
    k = np.tile(np.asarray([[0.8, 0, 0.5], [0, 0.9, 0.45], [0, 0, 1]], np.float32), (3, 1, 1))
    for ours, ref in (
        (tshims.center_crop(images, k, (64, 64)), jshims.center_crop(images, k, (64, 64))),
        (tshims.rescale_and_crop(images, k, (32, 48)), jshims.rescale_and_crop(images, k, (32, 48))),
        (tshims.rescale_and_crop(images, k, (32, 32)), jshims.rescale_and_crop(images, k, (32, 32))),
    ):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tshims.rescale_and_crop(images, k, (80, 80))
    for hw in ((300, 400), (400, 300), (256, 256)):
        style = _image(rng, *hw)
        np.testing.assert_array_equal(tshims.prepare_style_image(style, 256), jshims.prepare_style_image(style, 256, "test"))


@pytest.fixture(scope="module")
def chunk_root(tmp_path_factory):
    rng = np.random.default_rng(2)
    root = tmp_path_factory.mktemp("chunks")
    (root / "test").mkdir()
    scenes = [make_scene(rng, f"scene_{i}", n_frames=6) for i in range(2)]
    torch.save(scenes, root / "test" / "000000.torch")
    (root / "test" / "index.json").write_text(json.dumps({s["key"]: "000000.torch" for s in scenes}))
    np.savez(root / "test" / "000001.npz", examples=np.asarray(
        [{"key": "npz_scene", "cameras": np.asarray(scenes[0]["cameras"]), "images": []}], dtype=object))
    return root


def test_chunks_match_jax(chunk_root):
    ours, ref = tchunks.load_index(chunk_root, "test"), jchunks.load_index(chunk_root, "test")
    assert ours == ref
    for path in (chunk_root / "test" / "000000.torch", chunk_root / "test" / "000001.npz"):
        a, b = tchunks.load_chunk(path), jchunks.load_chunk(path)
        assert [e["key"] for e in a] == [e["key"] for e in b]
        for ea, eb in zip(a, b):
            np.testing.assert_array_equal(ea["cameras"], eb["cameras"])
            assert ea["images"] == eb["images"]
            for pa, pb in zip(tchunks.convert_poses_re10k(ea["cameras"]), jchunks.convert_poses_re10k(eb["cameras"])):
                np.testing.assert_array_equal(pa, pb)
            for data in ea["images"]:
                np.testing.assert_array_equal(tchunks.decode_jpeg(data), jchunks.decode_jpeg(data))
    with pytest.raises(ValueError):
        tchunks.load_chunk(chunk_root / "test" / "index.json")


def test_decode_jpeg_reads_a_truncated_file():
    buf = io.BytesIO()
    Image.fromarray((np.random.default_rng(3).uniform(0, 1, (32, 48, 3)) * 255).astype(np.uint8)).save(buf, "JPEG")
    data = buf.getvalue()[:-200]
    np.testing.assert_array_equal(tchunks.decode_jpeg(data), jchunks.decode_jpeg(data))


CAMERAS = [(1, 1, 640, 480, (500.0, 510.0, 320.0, 240.0)), (2, 0, 800, 600, (700.0, 400.0, 300.0)),
           (3, 2, 320, 240, (250.0, 160.0, 120.0, 0.01))]
IMAGES = [(7, "0003.png", 1), (2, "0001.png", 2), (5, "0002.jpg", 3)]


def _qvec(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def _write_colmap(directory, rng, binary):
    """cameras, images and points3D in COLMAP's format; returns what was
    written."""
    poses = {img_id: (_qvec(rng), rng.normal(size=3)) for img_id, _, _ in IMAGES}
    points = rng.normal(size=(4, 3))
    colors = rng.integers(0, 256, (4, 3))
    if binary:
        with open(directory / "cameras.bin", "wb") as f:
            f.write(struct.pack("<Q", len(CAMERAS)))
            for cam_id, model, w, h, params in CAMERAS:
                f.write(struct.pack("<iiQQ", cam_id, model, w, h) + struct.pack(f"<{len(params)}d", *params))
        with open(directory / "images.bin", "wb") as f:
            f.write(struct.pack("<Q", len(IMAGES)))
            for img_id, name, cam_id in IMAGES:
                q, t = poses[img_id]
                f.write(struct.pack("<i4d3di", img_id, *q, *t, cam_id) + name.encode() + b"\x00")
                f.write(struct.pack("<Q", 2) + struct.pack("<ddqddq", 1.0, 2.0, -1, 3.0, 4.0, 0))
        with open(directory / "points3D.bin", "wb") as f:
            f.write(struct.pack("<Q", len(points)))
            for i, (p, c) in enumerate(zip(points, colors)):
                f.write(struct.pack("<Q3d3Bd", i, *p, *c, 0.5) + struct.pack("<Q", 1) + struct.pack("<ii", 7, 0))
    else:
        models = {0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL"}
        lines = ["# Camera list", *(f"{c} {models[m]} {w} {h} {' '.join(map(repr, p))}" for c, m, w, h, p in CAMERAS)]
        (directory / "cameras.txt").write_text("\n".join(lines) + "\n")
        lines = ["# Image list"]
        for img_id, name, cam_id in IMAGES:
            q, t = poses[img_id]
            lines += [f"{img_id} {' '.join(map(repr, q.tolist()))} {' '.join(map(repr, t.tolist()))} {cam_id} {name}",
                      "1.0 2.0 -1"]
        (directory / "images.txt").write_text("\n".join(lines) + "\n")
    return poses, points, colors


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
def test_colmap_readers_match_jax(tmp_path, binary):
    poses, points, colors = _write_colmap(tmp_path, np.random.default_rng(4), binary)
    (cams, imgs), (jcams, jimgs) = tcolmap.load_colmap_model(tmp_path), jcolmap.load_colmap_model(tmp_path)
    assert sorted(cams) == sorted(jcams) == [1, 2, 3]
    for cid in cams:
        a, b = cams[cid], jcams[cid]
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(tcolmap.camera_intrinsics_normalized(a), jcolmap.camera_intrinsics_normalized(b))
    assert sorted(imgs) == sorted(poses)
    for iid in imgs:
        a, b = imgs[iid], jimgs[iid]
        assert (a.name, a.camera_id) == (b.name, b.camera_id)
        np.testing.assert_array_equal(a.qvec, poses[iid][0])
        np.testing.assert_array_equal(a.tvec, b.tvec)
    (c2w, names), (jc2w, jnames) = tcolmap.colmap_poses_c2w(imgs), jcolmap.colmap_poses_c2w(jimgs)
    assert names == jnames == ["0001.png", "0002.jpg", "0003.png"]
    np.testing.assert_array_equal(c2w, jc2w)
    for method in ("up", "none"):
        for center in ("poses", "none"):
            for a, b in zip(tcolmap.auto_orient_and_center_poses(c2w, method, center),
                            jcolmap.auto_orient_and_center_poses(jc2w, method, center)):
                np.testing.assert_array_equal(a, b)
    if binary:
        pts = tcolmap.read_points3d_binary(tmp_path / "points3D.bin")
        np.testing.assert_array_equal(pts, jcolmap.read_points3d_binary(tmp_path / "points3D.bin"))
        np.testing.assert_array_equal(pts, np.concatenate([points, colors], 1))
        with open(tmp_path / "images.bin", "rb") as f:
            data = f.read()
        (tmp_path / "images.bin").write_bytes(data[:40])
        with pytest.raises(ValueError):
            tcolmap.read_images_binary(tmp_path / "images.bin")


def test_llff_poses_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    n = 4
    blocks = rng.normal(size=(n, 3, 5))
    blocks[:, :, 4] = [300.0, 400.0, 350.0]
    pb = np.concatenate([blocks.reshape(n, 15), rng.uniform(0.5, 10, (n, 2))], 1)
    np.save(tmp_path / "poses_bounds.npy", pb)
    ours = tcolmap.read_llff_poses(tmp_path / "poses_bounds.npy")
    ref = jcolmap.read_llff_poses(tmp_path / "poses_bounds.npy")
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcolmap.llff_intrinsics_normalized(ours[1]), jcolmap.llff_intrinsics_normalized(ref[1]))


@pytest.mark.parametrize(
    "model, params",
    [("SIMPLE_RADIAL", [30.0, 24.5, 19.0, -0.12]), ("RADIAL", [30.0, 24.5, 19.0, 0.08, -0.03]),
     ("PINHOLE", [30.0, 31.0, 24.5, 19.0])],
    ids=["simple_radial", "radial", "pinhole"],
)
def test_undistort_matches_jax(model, params):
    """The same numpy operations on both sides: equal arrays, float and
    uint8 images alike; pinhole models pass the image through."""
    rng = np.random.default_rng(6)
    for image in (rng.uniform(0, 1, (40, 50, 3)).astype(np.float32), rng.integers(0, 256, (40, 50, 3), np.uint8)):
        ours = tcolmap.undistort_image_simple_radial(image, tcolmap.ColmapCamera(1, model, 50, 40, np.asarray(params)))
        ref = jcolmap.undistort_image_simple_radial(image, jcolmap.ColmapCamera(1, model, 50, 40, np.asarray(params)))
        assert ours.dtype == image.dtype
        np.testing.assert_array_equal(ours, ref)
        if model == "PINHOLE":
            assert ours is image
        else:
            assert not np.array_equal(ours, image)


def test_undistort_refuses_other_models():
    image = np.zeros((8, 8, 3), np.float32)
    params = np.asarray([30.0, 31.0, 4.0, 4.0, 0.1, 0.01, 0.0, 0.0])
    for module in (tcolmap, jcolmap):
        with pytest.raises(ValueError, match="OPENCV"):
            module.undistort_image_simple_radial(image, module.ColmapCamera(1, "OPENCV", 8, 8, params))
