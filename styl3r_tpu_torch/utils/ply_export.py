"""Gaussians to the standard 3DGS .ply layout (counterpart of
styl3r_tpu/utils/ply_export.py; reference `src/model/ply_export.py:26-75`),
byte for byte the JAX package's files: x/y/z, zero normals, f_dc (the DC SH
band), optional f_rest, raw opacity, log-scales, wxyz rotation, written as
binary little-endian f32 rows.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _ply_header(n: int, num_rest: int) -> bytes:
    props = ["x", "y", "z", "nx", "ny", "nz"]
    props += [f"f_dc_{i}" for i in range(3)]
    props += [f"f_rest_{i}" for i in range(num_rest)]
    props += ["opacity"]
    props += [f"scale_{i}" for i in range(3)]
    props += [f"rot_{i}" for i in range(4)]
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
        *[f"property float {p}" for p in props],
        "end_header",
    ]
    return ("\n".join(lines) + "\n").encode("ascii")


def export_ply(
    means: np.ndarray,
    scales: np.ndarray,
    rotations_xyzw: np.ndarray,
    harmonics: np.ndarray,
    opacities: np.ndarray,
    path: Path,
    shift_and_scale: bool = False,
    save_sh_dc_only: bool = True,
) -> None:
    """means (g, 3), scales (g, 3), rotations (g, 4) xyzw, harmonics
    (g, 3, d_sh), opacities (g,). shift_and_scale centers the means on their
    median and scales them by the largest 95th-percentile |coordinate|."""
    means = np.asarray(means, np.float32)
    scales = np.asarray(scales, np.float32)
    rotations_xyzw = np.asarray(rotations_xyzw, np.float32)
    harmonics = np.asarray(harmonics, np.float32)
    opacities = np.asarray(opacities, np.float32)

    if shift_and_scale:
        means = means - np.median(means, axis=0)
        scale_factor = np.quantile(np.abs(means), 0.95, axis=0).max()
        means = means / scale_factor
        scales = scales / scale_factor

    x, y, z, w = rotations_xyzw.T
    rot_wxyz = np.stack([w, x, y, z], axis=-1)
    f_rest = harmonics[..., 1:].reshape(means.shape[0], -1)
    cols = [means, np.zeros_like(means), harmonics[..., 0]]
    if not save_sh_dc_only:
        cols.append(f_rest)
    cols += [opacities[:, None], np.log(np.clip(scales, 1e-10, None)), rot_wxyz]
    data = np.concatenate(cols, axis=1).astype("<f4")

    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    with path.open("wb") as f:
        f.write(_ply_header(means.shape[0], 0 if save_sh_dc_only else f_rest.shape[1]))
        f.write(data.tobytes())


def load_ply(path: Path) -> dict:
    """Property name -> (n,) f32 array of a file `export_ply` wrote."""
    with Path(path).open("rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4")
    data = data.reshape(n, len(props))
    return {p: data[:, i] for i, p in enumerate(props)}
