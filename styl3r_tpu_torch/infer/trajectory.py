"""Camera trajectories for novel-view videos (counterpart of
styl3r_tpu/infer/trajectory.py; reference
`src/visualization/camera_trajectory/`): rotation slerp + translation lerp
between two cameras, the 'wobble' orbit of validation videos, and the spin
orbit. Host-side numpy."""

from __future__ import annotations

import numpy as np


def _quat_from_matrix(rot: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) wxyz."""
    m = rot
    t = np.trace(m, axis1=-2, axis2=-1)
    w = np.sqrt(np.maximum(1 + t, 1e-12)) / 2
    x = (m[..., 2, 1] - m[..., 1, 2]) / (4 * w)
    y = (m[..., 0, 2] - m[..., 2, 0]) / (4 * w)
    z = (m[..., 1, 0] - m[..., 0, 1]) / (4 * w)
    q = np.stack([w, x, y, z], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _matrix_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def _slerp(q0: np.ndarray, q1: np.ndarray, t: np.ndarray) -> np.ndarray:
    dot = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(dot < 0, -q1, q1)
    dot = np.abs(dot)
    theta = np.arccos(np.clip(dot, -1, 1))
    sin_theta = np.sin(theta)
    small = sin_theta < 1e-6
    w0 = np.where(small, 1 - t, np.sin((1 - t) * theta) / np.where(small, 1, sin_theta))
    w1 = np.where(small, t, np.sin(t * theta) / np.where(small, 1, sin_theta))
    out = w0 * q0 + w1 * q1
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def interpolate_extrinsics(initial: np.ndarray, final: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(4, 4), (4, 4), (n,) -> (n, 4, 4) c2w interpolation."""
    initial = np.asarray(initial, np.float64)
    final = np.asarray(final, np.float64)
    t = np.asarray(t, np.float64)[:, None]
    q0 = _quat_from_matrix(initial[:3, :3])
    q1 = _quat_from_matrix(final[:3, :3])
    q = _slerp(np.broadcast_to(q0, (len(t), 4)), np.broadcast_to(q1, (len(t), 4)), t)
    out = np.tile(np.eye(4), (len(t), 1, 1))
    out[:, :3, :3] = _matrix_from_quat(q)
    out[:, :3, 3] = (1 - t) * initial[:3, 3] + t * final[:3, 3]
    return out.astype(np.float32)


def interpolate_intrinsics(initial: np.ndarray, final: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(3, 3), (3, 3), (n,) -> (n, 3, 3) linear interpolation."""
    t = np.asarray(t, np.float32)[:, None, None]
    return ((1 - t) * initial[None] + t * final[None]).astype(np.float32)


def wobble_extrinsics(base: np.ndarray, n: int = 60, radius: float = 0.1) -> np.ndarray:
    """n cameras on a circle of `radius` in the base camera's x/y plane."""
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    out = np.tile(np.asarray(base, np.float32), (n, 1, 1))
    out[:, 0, 3] += radius * np.cos(t)
    out[:, 1, 3] += radius * np.sin(t)
    return out


def _rotvec_to_matrix(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues for (..., 3) rotation vectors."""
    rotvec = np.asarray(rotvec, np.float64)
    angle = np.linalg.norm(rotvec, axis=-1, keepdims=True)
    axis = rotvec / np.where(angle < 1e-12, 1.0, angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    k = np.stack(
        [
            np.stack([zero, -z, y], -1),
            np.stack([z, zero, -x], -1),
            np.stack([-y, x, zero], -1),
        ],
        axis=-2,
    )
    a = angle[..., None]
    eye = np.broadcast_to(np.eye(3), k.shape)
    return eye + np.sin(a) * k + (1 - np.cos(a)) * (k @ k)


def generate_spin(num_frames: int, elevation: float, radius: float) -> np.ndarray:
    """Orbit around the origin (reference `spin.py:9-37`): back off by
    `radius` along the look vector (with the reference's x/y flip), tilt by
    `elevation` degrees, sweep the azimuth over a full turn. Returns
    (num_frames, 4, 4)."""
    tf_translation = np.eye(4, dtype=np.float32)
    tf_translation[:2] *= -1
    tf_translation[2, 3] = -radius
    phi = 2 * np.pi * (np.arange(num_frames) / num_frames)
    rotvecs = np.stack([np.zeros_like(phi), phi, np.zeros_like(phi)], axis=-1)
    tf_azimuth = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    tf_azimuth[:, :3, :3] = _rotvec_to_matrix(rotvecs)
    tf_elevation = np.eye(4, dtype=np.float32)
    tf_elevation[:3, :3] = _rotvec_to_matrix(np.asarray([np.deg2rad(elevation), 0.0, 0.0]))
    return (tf_azimuth @ tf_elevation @ tf_translation).astype(np.float32)
