"""ScanNet-1500 two-view pose-evaluation dataset (counterpart of
styl3r_tpu/data/scannet_pose.py; reference
`src/dataset/dataset_scannet_pose.py:47-255`): iterate the SuperGlue
test-pair list (`test.npz`: `name` rows = [scene, sub, frame_a, frame_b],
`rel_pose` = 3x4 relative poses), load the two color frames + the shared
`intrinsic_color.txt`, zero-pad so the principal point sits at the image
center (the reference's `center_principal_point`), normalize K, and emit a
2-view Example whose target duplicates the context (pose eval renders view 2
from view 1's gaussians; no photometric GT is needed beyond the frames).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from .shims import rescale_and_crop
from .types import Example, Views


def center_principal_point(
    images: np.ndarray, cx: float, cy: float
) -> Tuple[np.ndarray, float, float]:
    """Zero-pad (v, h, w, 3) images so (cx, cy) lands at the padded center
    (dataset_scannet_pose.py:139-179)."""
    v, h, w, _ = images.shape
    cx, cy = round(cx), round(cy)
    shift_x = w // 2 - cx
    shift_y = h // 2 - cy
    new_w = max(w, w - 2 * shift_x)
    new_h = max(h, h - 2 * shift_y)
    out = np.zeros((v, new_h, new_w, 3), np.float32)
    pad_left = max(0, -shift_x)
    pad_top = max(0, -shift_y)
    src_left = max(0, shift_x)
    src_top = max(0, shift_y)
    # The reference also crops the source at w+shift_x / h+shift_y: when the
    # principal point lies right of / below the image center it zeroes out the
    # far band rather than keeping it (dataset_scannet_pose.py:168-174).
    src_right = min(w, w + shift_x)
    src_bottom = min(h, h + shift_y)
    out[
        :,
        pad_top : pad_top + (src_bottom - src_top),
        pad_left : pad_left + (src_right - src_left),
    ] = images[:, src_top:src_bottom, src_left:src_right]
    return out, new_w // 2, new_h // 2


class ScannetPoseDataset:
    """Iterable over the ScanNet test pairs (reference directory layout:
    <root>/test.npz + <root>/scans_test/<scene>/color/<frame>.jpg +
    <root>/scans_test/<scene>/intrinsic/intrinsic_color.txt)."""

    def __init__(
        self,
        root: Path,
        input_image_shape: Tuple[int, int] = (256, 256),
        near: float = 0.1,
        far: float = 100.0,
    ):
        self.root = Path(root)
        self.input_image_shape = tuple(input_image_shape)
        self.near = near
        self.far = far
        data = np.load(self.root / "test.npz")
        self.pairs = data["name"]
        self.rel_pose = data["rel_pose"]

    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self) -> Iterator[Example]:
        from PIL import Image

        for pair, rel in zip(self.pairs, self.rel_pose):
            scene_name = f"scene0{pair[0]}_00"
            scene_dir = self.root / "scans_test" / scene_name
            frames = []
            try:
                for frame_id in (pair[2], pair[3]):
                    with Image.open(scene_dir / "color" / f"{frame_id}.jpg") as img:
                        frames.append(
                            np.asarray(img.convert("RGB"), np.float32) / 255.0
                        )
                k_rows = [
                    [float(x) for x in row.split()]
                    for row in (scene_dir / "intrinsic" / "intrinsic_color.txt")
                    .read_text()
                    .split("\n")
                    if row
                ]
            except (OSError, ValueError):
                continue  # skip bad/missing data like the reference
            images = np.stack(frames)  # (2, h, w, 3)
            k = np.asarray(k_rows, np.float64)

            images, new_cx, new_cy = center_principal_point(
                images, k[0, 2], k[1, 2]
            )
            h, w = images.shape[1:3]
            k = k[:3, :3].copy()
            k[0, 2] = new_cx
            k[1, 2] = new_cy
            k[0, :] /= w
            k[1, :] /= h
            intrinsics = np.broadcast_to(k.astype(np.float32), (2, 3, 3)).copy()

            pose2 = np.eye(4, dtype=np.float32)
            pose2[:3, :4] = rel.reshape(3, 4)
            extrinsics = np.stack(
                [np.eye(4, dtype=np.float32), np.linalg.inv(pose2)]
            )

            images, intrinsics = rescale_and_crop(
                images, intrinsics, self.input_image_shape
            )
            views = Views(
                extrinsics=extrinsics,
                intrinsics=intrinsics,
                image=images,
                near=np.full((2,), self.near, np.float32),
                far=np.full((2,), self.far, np.float32),
                index=np.asarray([0, 1], np.int64),
                overlap=np.asarray([0.5], np.float32),
            )
            yield Example(
                context=views,
                target=views,
                scene=scene_name,
                style_image=images[0],
            )
