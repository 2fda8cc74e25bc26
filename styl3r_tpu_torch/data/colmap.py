"""COLMAP and LLFF scene poses (counterpart of styl3r_tpu/data/colmap.py;
reference `infer_model_colmap.py:257-460`, `src/dataset/colmap_utils.py`).

Readers for COLMAP's binary and text model formats (cameras, images,
points3D), and the pose conditioning of the reference's in-the-wild
inference: qvec -> R, w2c -> c2w, normalized pinhole intrinsics, and
auto-orient-and-center.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise ValueError(f"{f.name}: file ends inside a record")
    return struct.unpack(fmt, data)


def read_cameras_binary(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.asarray(_read(f, f"<{n_params}d"))
            cameras[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cameras


def read_images_binary(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (img_id,) = _read(f, "<i")
            qvec = np.asarray(_read(f, "<4d"))
            tvec = np.asarray(_read(f, "<3d"))
            (cam_id,) = _read(f, "<i")
            name = b""
            while (c := f.read(1)) != b"\x00":
                if not c:
                    raise ValueError(f"{path}: file ends inside an image name")
                name += c
            (n_pts,) = _read(f, "<Q")
            f.read(24 * n_pts)  # 2D points (x, y, point3D_id), unused
            images[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode())
    return images


def read_points3d_binary(path: Path) -> np.ndarray:
    """(n, 6) xyz + rgb."""
    pts = []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            _read(f, "<Q")  # id
            xyz = _read(f, "<3d")
            rgb = _read(f, "<3B")
            _read(f, "<d")  # error
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
            pts.append([*xyz, *rgb])
    return np.asarray(pts, np.float64)


def read_cameras_text(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        params = np.asarray([float(p) for p in parts[4:]])
        cameras[cam_id] = ColmapCamera(cam_id, model, int(parts[2]), int(parts[3]), params)
    return cameras


def read_images_text(path: Path) -> Dict[int, ColmapImage]:
    """Each image has a metadata line and a line of 2D points (unused)."""
    images = {}
    lines = [l for l in Path(path).read_text().splitlines() if l and not l.startswith("#")]
    for meta in lines[0::2]:
        parts = meta.split()
        img_id = int(parts[0])
        qvec = np.asarray([float(p) for p in parts[1:5]])
        tvec = np.asarray([float(p) for p in parts[5:8]])
        images[img_id] = ColmapImage(img_id, qvec, tvec, int(parts[8]), parts[9])
    return images


def load_colmap_model(sparse_dir: Path):
    """(cameras, images) of a sparse model, binary if present, else text."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        return read_cameras_binary(sparse_dir / "cameras.bin"), read_images_binary(sparse_dir / "images.bin")
    return read_cameras_text(sparse_dir / "cameras.txt"), read_images_text(sparse_dir / "images.txt")


def camera_intrinsics_normalized(cam: ColmapCamera) -> np.ndarray:
    """Pinhole-family params -> normalized 3x3 K (distortion ignored)."""
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        f, cx, cy = cam.params[:3]
        fx = fy = f
    elif cam.model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE"):
        fx, fy, cx, cy = cam.params[:4]
    else:
        raise ValueError(f"unsupported camera model {cam.model}")
    k = np.eye(3, dtype=np.float32)
    k[0, 0] = fx / cam.width
    k[1, 1] = fy / cam.height
    k[0, 2] = cx / cam.width
    k[1, 2] = cy / cam.height
    return k


def colmap_poses_c2w(images: Dict[int, ColmapImage]) -> Tuple[np.ndarray, List[str]]:
    """c2w poses and image names, sorted by name."""
    order = sorted(images.values(), key=lambda im: im.name)
    poses = []
    for im in order:
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        poses.append(np.linalg.inv(w2c))
    return np.asarray(poses, np.float32), [im.name for im in order]


def auto_orient_and_center_poses(
    poses: np.ndarray, method: str = "up", center_method: str = "poses"
) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate the mean up-vector onto +z ('up') and center the scene on the
    mean camera origin ('poses'). Returns (oriented poses, 4x4 transform)."""
    origins = poses[:, :3, 3]
    center = origins.mean(axis=0) if center_method == "poses" else np.zeros(3)
    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        target = np.asarray([0.0, 0.0, 1.0])
        v = np.cross(up, target)
        s = np.linalg.norm(v)
        c = float(np.dot(up, target))
        if s < 1e-8:
            rot = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
        else:
            vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
            rot = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
    else:
        rot = np.eye(3)
    transform = np.eye(4)
    transform[:3, :3] = rot
    transform[:3, 3] = -rot @ center
    oriented = transform[None] @ poses
    return oriented.astype(np.float32), transform.astype(np.float32)


def undistort_image_simple_radial(image: np.ndarray, cam: ColmapCamera) -> np.ndarray:
    """An (h, w, c) image undistorted for the SIMPLE_RADIAL and RADIAL
    models: each output pixel samples the input bilinearly at its
    forward-distorted position, xd = xn (1 + k1 r^2 [+ k2 r^4]). Pinhole
    models pass through; other models raise (the reference uses cv2)."""
    if cam.model in ("SIMPLE_PINHOLE", "PINHOLE"):
        return image
    if cam.model == "SIMPLE_RADIAL":
        f, cx, cy, k1 = cam.params
        ks = [k1]
    elif cam.model == "RADIAL":
        f, cx, cy, k1, k2 = cam.params
        ks = [k1, k2]
    else:
        raise ValueError(f"undistortion for {cam.model} not implemented")
    h, w = image.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = (xs - cx) / f
    yn = (ys - cy) / f
    r2 = xn * xn + yn * yn
    factor = 1.0 + sum(k * r2 ** (i + 1) for i, k in enumerate(ks))
    sample_x = np.clip(xn * factor * f + cx, 0, w - 1)
    sample_y = np.clip(yn * factor * f + cy, 0, h - 1)
    x0 = np.floor(sample_x).astype(int)
    y0 = np.floor(sample_y).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = sample_x - x0
    wy = sample_y - y0
    out = (
        image[y0, x0] * ((1 - wx) * (1 - wy))[..., None]
        + image[y0, x1] * (wx * (1 - wy))[..., None]
        + image[y1, x0] * ((1 - wx) * wy)[..., None]
        + image[y1, x1] * (wx * wy)[..., None]
    )
    return out.astype(image.dtype)


def read_llff_poses(path: Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LLFF poses_bounds.npy -> (c2w OpenCV (n, 4, 4), hwf (n, 3), bounds
    (n, 2)). The stored 3x5 blocks are [down, right, backwards | t | hwf]:
    to OpenGL [right, up, back], then to OpenCV (y down, z forward)."""
    pb = np.load(Path(path))
    blocks = pb[:, :15].reshape(-1, 3, 5)
    bounds = pb[:, 15:17]
    hwf = blocks[:, :, 4]
    rot = np.concatenate([blocks[:, :, 1:2], -blocks[:, :, 0:1], blocks[:, :, 2:3]], axis=-1)
    c2w_gl = np.concatenate([rot, blocks[:, :, 3:4]], axis=-1)  # (n, 3, 4)
    flip = np.diag([1.0, -1.0, -1.0])
    c2w_cv = np.concatenate([c2w_gl[:, :, :3] @ flip, c2w_gl[:, :, 3:4]], axis=-1)
    out = np.tile(np.eye(4, dtype=np.float64), (len(pb), 1, 1))
    out[:, :3, :4] = c2w_cv
    return out.astype(np.float32), hwf.astype(np.float32), bounds.astype(np.float32)


def llff_intrinsics_normalized(hwf: np.ndarray) -> np.ndarray:
    """(n, 3) [h, w, f] -> normalized K with a centered principal point."""
    k = np.tile(np.eye(3, dtype=np.float32), (len(hwf), 1, 1))
    k[:, 0, 0] = hwf[:, 2] / hwf[:, 1]
    k[:, 1, 1] = hwf[:, 2] / hwf[:, 0]
    k[:, 0, 2] = 0.5
    k[:, 1, 2] = 0.5
    return k
