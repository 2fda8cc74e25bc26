"""Chunked RE10K-style scenes (counterpart of styl3r_tpu/data/chunks.py;
reference `src/dataset/dataset_re10k_style.py:107-121,218-236`).

A `.torch` chunk is a torch-saved list of {key, cameras (n, 18) f32,
images: list of JPEG byte tensors, url}; a `.npz` chunk holds the same
examples under "examples". Each camera packs fx, fy, cx, cy (normalized),
two unused floats and the 3x4 w2c matrix row-major.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def convert_poses_re10k(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 18) packed cameras -> (c2w (n, 4, 4), normalized K (n, 3, 3))."""
    n = poses.shape[0]
    intrinsics = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    intrinsics[:, 0, 0] = poses[:, 0]
    intrinsics[:, 1, 1] = poses[:, 1]
    intrinsics[:, 0, 2] = poses[:, 2]
    intrinsics[:, 1, 2] = poses[:, 3]
    w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2c[:, :3] = poses[:, 6:].reshape(n, 3, 4)
    return np.linalg.inv(w2c).astype(np.float32), intrinsics


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (h, w, 3) float32 in [0, 1]. Truncated files are read
    as far as they go, as the reference does for DL3DV."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def load_chunk(path: Path) -> List[Dict]:
    """One chunk -> its examples, with numpy cameras and each frame's JPEG
    bytes."""
    path = Path(path)
    if path.suffix == ".torch":
        import torch

        # A chunk holds only lists, dicts, strings and tensors.
        raw = torch.load(path, map_location="cpu", weights_only=True)
        return [
            {
                "key": ex["key"],
                "cameras": np.asarray(ex["cameras"], dtype=np.float32),
                "images": [
                    bytes(im.numpy().tobytes()) if hasattr(im, "numpy") else bytes(im)
                    for im in ex["images"]
                ],
            }
            for ex in raw
        ]
    if path.suffix == ".npz":
        return list(np.load(path, allow_pickle=True)["examples"])
    raise ValueError(f"unknown chunk format: {path}")


def load_index(root: Path, stage: str) -> Dict[str, Path]:
    """Scene key -> chunk path, from the stage's index.json."""
    root = Path(root)
    with (root / stage / "index.json").open() as f:
        index = json.load(f)
    return {k: root / stage / v for k, v in index.items()}


def list_chunks(roots: Sequence[Path], stage: str) -> List[Path]:
    """The .torch and .npz chunks under each root's `stage` directory, sorted
    by name within a root, roots in order."""
    chunks: List[Path] = []
    for root in roots:
        stage_dir = Path(root) / stage
        chunks.extend(sorted(p for p in stage_dir.iterdir() if p.suffix in (".torch", ".npz")))
    return chunks


def iter_chunk_examples(chunk_path: Path) -> Iterator[Dict]:
    yield from load_chunk(chunk_path)
