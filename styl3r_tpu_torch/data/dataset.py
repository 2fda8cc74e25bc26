"""RE10K/DL3DV-style streaming dataset and batch collation (counterpart of
styl3r_tpu/data/dataset.py; reference `src/dataset/dataset_re10k_style.py`).

Iterate shuffled chunks, sample context/target views, decode the JPEGs,
filter (FOV <= max_fov, baseline in range, frame shape), scale the world to
baseline 1, express poses relative to context camera 0, attach a style
image, flip-augment, and rescale + center-crop to the input shape.

Host-side numpy: the train step takes collated Batches, which
`models/styl3r.py::batch_to` moves to the device. A producer thread overlaps
decoding with the device's work (the decoders release the GIL).
The stream's position between two examples is a small dict
(`RE10kStyleDataset.state_dict`: the generator's state, the epoch's chunk
order and the place in it), so a resumed run continues where the
interrupted one stopped without decoding what it already trained on.
Frames are decoded as the JAX dataset decodes them: first by the native
library (`styl3r_tpu_torch/native`: threaded libjpeg, and frames of another
shape than `original_image_shape` Lanczos-resized to it), and with PIL only
where that library cannot be built or a frame fails to decode; PIL's frames
of another shape are skipped (`skip_bad_shape`). The first fallback of a
dataset prints its reason to stderr, and `decoded` counts the examples
each decoder decoded.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..geometry.projection import get_fov
from ..models.styl3r import Batch
from .chunks import convert_poses_re10k, decode_jpeg, load_chunk, list_chunks
from .shims import apply_augmentation, prepare_style_image, rescale_and_crop
from .types import Example, Views


@dataclass
class DatasetConfig:
    roots: Sequence[Path]
    style_root: Optional[Path] = None
    input_image_shape: tuple = (256, 256)
    original_image_shape: tuple = (360, 640)
    baseline_min: float = 1e-3
    baseline_max: float = 1e2
    max_fov: float = 100.0
    make_baseline_1: bool = True
    relative_pose: bool = True
    augment: bool = True
    skip_bad_shape: bool = True
    near: float = 0.1
    far: float = 100.0
    overfit_to_scene: Optional[str] = None
    specified_style_image: Optional[Path] = None


def data_shard() -> tuple:
    """(shard id, shard count): the process's rank and the world size when
    torch.distributed is initialized, else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


class RE10kStyleDataset:
    def __init__(
        self,
        cfg: DatasetConfig,
        stage: str,
        view_sampler,
        seed: int = 0,
        step_of: Callable[[int], int] = lambda n: 0,
        shard_id: Optional[int] = None,
        num_shards: Optional[int] = None,
    ):
        """`step_of` maps the number of examples yielded so far to the
        training step the view sampler's curriculum sees. It is a function
        of the stream alone (the JAX dataset reads the trainer's live step
        from the prefetch thread), so the draws do not depend on how far the
        prefetch has run ahead, and a resumed stream draws as the
        uninterrupted one did."""
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.step_of = step_of
        self.n_built = 0  # examples yielded, over all epochs
        # Examples each decoder decoded, and why the first PIL fallback was taken.
        self.decoded = {"native": 0, "pil": 0}
        self.fallback_reason: Optional[str] = None
        self._cursor: Optional[Dict[str, Any]] = None  # the epoch in progress
        self._restored: Optional[Dict[str, Any]] = None  # where the next __iter__ starts

        # Each process reads a disjoint subset of the chunks, with its own
        # generator (the reference seeds each rank's DataLoader).
        if shard_id is None or num_shards is None:
            shard_id, num_shards = data_shard()
        self.shard_id, self.num_shards = shard_id, num_shards
        self.rng = np.random.default_rng(seed + 7919 * shard_id)

        data_stage = "test" if stage in ("val", "test") else "train"
        if cfg.overfit_to_scene is not None:
            data_stage = "test"
        chunks = list_chunks(list(cfg.roots), data_stage)
        if num_shards > 1:
            chunks = chunks[shard_id::num_shards] or chunks
        self.chunks = chunks

        self.scene_style_mapping: Dict[str, str] = {}
        if cfg.style_root is not None and cfg.specified_style_image is None:
            mapping = Path(cfg.style_root) / "train" / "scene_style_mapping_all.json"
            if mapping.exists():
                with mapping.open() as f:
                    self.scene_style_mapping = json.load(f)

    def _read_style_image(self, scene: str) -> tuple:
        from PIL import Image

        if self.cfg.specified_style_image is not None:
            path = Path(self.cfg.specified_style_image)
        else:
            name = self.scene_style_mapping.get(scene)
            if name is None:
                raise KeyError(f"{scene} not in scene_style_mapping")
            path = Path(self.cfg.style_root) / "train" / name
        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
        return prepare_style_image(arr, 256), path.name

    def state_dict(self) -> Dict[str, Any]:
        """Where the stream stands between two examples: the generator's
        state, the examples yielded so far and, inside an epoch, its chunk
        order, the chunk's example order and the place in both."""
        cursor = None if self._cursor is None else dict(self._cursor)
        return {"rng": self.rng.bit_generator.state, "n_built": self.n_built, "cursor": cursor}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Continue from `state_dict()`'s position: the next __iter__ goes on
        with the epoch it names, or starts a new one at an epoch boundary."""
        self.rng.bit_generator.state = state["rng"]
        self.n_built = int(state["n_built"])
        self._restored = None if state["cursor"] is None else dict(state["cursor"])

    def __iter__(self) -> Iterator[Example]:
        """One epoch: the chunks and each chunk's examples in an order
        shuffled by the dataset's generator (train and val stages). Index
        lists are shuffled in place of the chunks and examples themselves:
        the same draws give the same permutation."""
        shuffle = self.stage in ("train", "val")
        cursor, self._restored = self._restored, None
        if cursor is None:
            order = list(range(len(self.chunks)))
            if shuffle:
                self.rng.shuffle(order)
            cursor = {"chunk_order": order, "chunk_pos": 0, "example_order": None, "example_pos": 0}
        self._cursor = cursor
        try:
            while cursor["chunk_pos"] < len(cursor["chunk_order"]):
                chunk = load_chunk(self.chunks[cursor["chunk_order"][cursor["chunk_pos"]]])
                if self.cfg.overfit_to_scene is not None:
                    chunk = [ex for ex in chunk if ex["key"] == self.cfg.overfit_to_scene] * max(len(chunk), 1)
                if cursor["example_order"] is None:
                    order = list(range(len(chunk)))
                    if shuffle:
                        self.rng.shuffle(order)
                    cursor["example_order"], cursor["example_pos"] = order, 0
                while cursor["example_pos"] < len(cursor["example_order"]):
                    example = self._build_example(chunk[cursor["example_order"][cursor["example_pos"]]])
                    cursor["example_pos"] += 1
                    if example is not None:
                        self.n_built += 1
                        yield example
                cursor["chunk_pos"] += 1
                cursor["example_order"] = None
        finally:
            self._cursor = None

    def _decode(self, jpegs: List[bytes], n_context: int, expect: tuple) -> Optional[tuple]:
        """(context, target) frames, each (n, h, w, 3) float32 in [0, 1]:
        natively, resized to `expect` where they differ, else with PIL;
        None where PIL fails or, with skip_bad_shape, a PIL frame has
        another shape."""
        images = native.decode_jpeg_batch(jpegs, expect)
        if images is not None:
            self.decoded["native"] += 1
            return images[:n_context], images[n_context:]
        if self.fallback_reason is None:
            self.fallback_reason = native.unavailable_reason() or "a frame failed to decode natively"
            print(f"RE10kStyleDataset: decoding with PIL: {self.fallback_reason}", file=sys.stderr, flush=True)
        try:
            frames = [decode_jpeg(j) for j in jpegs]
        except OSError:
            return None
        # Each frame is checked before stacking: the JAX dataset's np.stack
        # raises where the frames of one example differ in shape.
        if self.cfg.skip_bad_shape and any(f.shape[:2] != expect for f in frames):
            return None
        self.decoded["pil"] += 1
        return np.stack(frames[:n_context]), np.stack(frames[n_context:])

    def _build_example(self, raw: Dict) -> Optional[Example]:
        extrinsics, intrinsics = convert_poses_re10k(raw["cameras"])
        scene = raw["key"]
        try:
            sampled = self.view_sampler.sample(scene, len(extrinsics), self.rng, self.step_of(self.n_built))
        except ValueError:
            return None

        fov_deg = np.degrees(get_fov(torch.from_numpy(intrinsics)).numpy())
        if (fov_deg > self.cfg.max_fov).any():
            return None

        try:
            jpegs = [raw["images"][i] for i in (*sampled.context, *sampled.target)]
        except IndexError:
            return None
        images = self._decode(jpegs, len(sampled.context), tuple(self.cfg.original_image_shape))
        if images is None:
            return None
        ctx_imgs, tgt_imgs = images

        scale = 1.0
        if self.cfg.make_baseline_1:
            a = extrinsics[sampled.context[0], :3, 3]
            b = extrinsics[sampled.context[-1], :3, 3]
            scale = float(np.linalg.norm(a - b))
            if scale < self.cfg.baseline_min or scale > self.cfg.baseline_max:
                return None
            extrinsics = extrinsics.copy()
            extrinsics[:, :3, 3] /= scale

        if self.cfg.relative_pose:
            pivot = extrinsics[sampled.context[0]]
            extrinsics = np.linalg.inv(pivot)[None] @ extrinsics

        if self.scene_style_mapping or self.cfg.specified_style_image:
            style_image, style_name = self._read_style_image(scene)
        else:
            # Novel-view pretraining: the train step puts context view 0 in
            # the style image's place; this placeholder keeps shapes fixed.
            style_image, style_name = np.zeros((256, 256, 3), np.float32), ""

        def make_views(indices, images):
            n = len(indices)
            return Views(
                extrinsics=extrinsics[indices].astype(np.float32),
                intrinsics=intrinsics[indices].astype(np.float32),
                image=images.astype(np.float32),
                near=np.full((n,), self.cfg.near / scale, np.float32),
                far=np.full((n,), self.cfg.far / scale, np.float32),
                index=np.asarray(indices, np.int64),
                overlap=np.asarray([sampled.overlap], np.float32),
            )

        example = Example(
            context=make_views(sampled.context, ctx_imgs),
            target=make_views(sampled.target, tgt_imgs),
            scene=scene,
            style_image=style_image,
            style_name=style_name,
        )
        if self.stage == "train" and self.cfg.augment:
            example = apply_augmentation(example, self.rng)

        shape = tuple(self.cfg.input_image_shape)
        for views in (example.context, example.target):
            views.image, views.intrinsics = rescale_and_crop(views.image, views.intrinsics, shape)
        return example


def collate_examples(examples: List[Example]) -> Batch:
    """Stack host examples into a Batch of numpy arrays."""
    return Batch(
        context_images=np.stack([e.context.image for e in examples]),
        context_intrinsics=np.stack([e.context.intrinsics for e in examples]),
        target_extrinsics=np.stack([e.target.extrinsics for e in examples]),
        target_intrinsics=np.stack([e.target.intrinsics for e in examples]),
        target_near=np.stack([e.target.near for e in examples]),
        target_far=np.stack([e.target.far for e in examples]),
        style_image=np.stack([e.style_image for e in examples]),
        target_images=np.stack([e.target.image for e in examples]),
    )


def batch_iterator(
    dataset: RE10kStyleDataset,
    batch_size: int,
    prefetch: int = 2,
    drop_last: bool = True,
    aspect_buckets: bool = False,
    with_state: bool = False,
) -> Iterator[Batch]:
    """Batches of `dataset`, built by a producer thread into a queue of
    `prefetch`. With `aspect_buckets`, examples are grouped by image shape
    before collation, so a mixed landscape/portrait stream yields batches of
    one shape each (the trainer keeps one step function a shape). With
    `with_state`, each item is (batch, the dataset's state_dict() just after
    the batch's last example), or (batch, None) while examples of another
    shape wait in their bucket, which no position can name. An error in the
    producer is raised in the consumer; closing the iterator stops the
    producer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    errors: List[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        buckets: dict = {}
        try:
            for ex in dataset:
                key = tuple(ex.context.image.shape[1:3]) if aspect_buckets else None
                buf = buckets.setdefault(key, [])
                buf.append(ex)
                if len(buf) == batch_size:
                    item = collate_examples(buf)
                    buckets[key] = []
                    if with_state:
                        pending = any(buckets.values())
                        item = (item, None if pending else dataset.state_dict())
                    if not put(item):
                        return
            if not drop_last:
                for buf in buckets.values():
                    if buf and not put((collate_examples(buf), None) if with_state else collate_examples(buf)):
                        return
        except BaseException as exc:  # handed to the consumer, which raises it
            errors.append(exc)
        finally:
            put(None)

    thread = threading.Thread(target=producer, name="batch-producer", daemon=True)
    thread.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                if errors:
                    raise errors[0]
                break
            yield batch
    finally:
        stop.set()
        thread.join()
