"""The benchmark's renderer: one closed orbit loop of a textured cube.

A frozen copy of the port's data/synthetic.py renderer (slab-method ray/box
intersection, exact depth, lattice-hash texture, Lambertian shade), moved
to torch so that it renders all frames of the loop in a few batched calls,
on the card in a run.  Two changes make the loop a loop: the elevation
wobble is elev_amp * sin(angle), periodic over 360 degrees (the port's
renderer uses sin(0.7 * angle)), and a loop is `loop_frames` frames at
360 / loop_frames degrees each, so frame loop_frames is frame 0 again.

Frames come out as a camera delivers them: u8 gray, u16 depth in
millimetres (0 = no return), a bool mask, and the ground-truth
object-in-camera poses [F, 4, 4] f32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Loop(NamedTuple):
    gray: np.ndarray  # [F, H, W] uint8
    depth: np.ndarray  # [F, H, W] uint16 millimetres
    mask: np.ndarray  # [F, H, W] bool
    ob_in_cam: np.ndarray  # [F, 4, 4] float32 ground truth
    K: np.ndarray  # [3, 3] float32


def intrinsics(H: int, W: int) -> np.ndarray:
    fx = 0.9 * W
    return np.array([[fx, 0, W / 2 - 0.5], [0, fx, H / 2 - 0.5], [0, 0, 1]], np.float32)


def _hash01(ix, iy, iz, seed: int):
    """Deterministic integer-lattice hash -> [0, 1) (int64 wrap-around, as numpy's)."""
    h = ix.long() * 374761393 + iy.long() * 668265263 + iz.long() * 2147483647 + seed * 979025471
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) / 65535.0


def _texture(p, seed: int, cell: float = 0.02):
    q = torch.floor(p / cell)
    base = _hash01(q[..., 0], q[..., 1], q[..., 2], seed)
    frac = p / cell - q
    detail = 0.15 * _hash01(q[..., 0] * 3 + 1, q[..., 1] * 3 + 2, q[..., 2] * 3 + 3, seed)
    return torch.clamp(0.15 + 0.7 * base + detail * frac[..., 0].to(torch.float32), 0.0, 1.0)


def camera_to_object(frames: np.ndarray, loop_frames: int, radius: float, elev_amp: float) -> np.ndarray:
    """[F, 4, 4] float64 camera-to-object transforms of the loop's frames
    (the camera looks at the cube's centre, OpenCV axes)."""
    ang = np.deg2rad(360.0 / loop_frames * np.asarray(frames, np.float64))
    eye = np.stack([radius * np.sin(ang), elev_amp * np.sin(ang), -radius * np.cos(ang)], -1)
    z = -eye / np.linalg.norm(eye, axis=-1, keepdims=True)
    x = np.cross(z, np.array([0.0, 1.0, 0.0]))
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    T = np.tile(np.eye(4), (len(ang), 1, 1))
    T[:, :3, :3] = np.stack([x, y, z], axis=-1)
    T[:, :3, 3] = eye
    return T


def render_loop(H: int, W: int, texture_seed: int, loop_frames: int = 120, radius: float = 0.55,
                elev_amp: float = 0.15, box_size: float = 0.2, device="cpu", chunk: int = 12) -> Loop:
    """Render the whole loop, `chunk` frames per batched call on `device`."""
    K = intrinsics(H, W)
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    half = box_size / 2.0
    u, v = torch.meshgrid(torch.arange(W, **f64), torch.arange(H, **f64), indexing="xy")
    dirs = torch.stack([(u - float(K[0, 2])) / float(K[0, 0]), (v - float(K[1, 2])) / float(K[1, 1]),
                        torch.ones_like(u)], -1)  # [H, W, 3], depth = t
    T_co = camera_to_object(np.arange(loop_frames), loop_frames, radius, elev_amp)
    grays, depths, masks = [], [], []
    for lo in range(0, loop_frames, chunk):
        T = torch.as_tensor(T_co[lo:lo + chunk], **f64)
        R, o = T[:, :3, :3], T[:, None, None, :3, 3]  # [B, 3, 3], [B, 1, 1, 3]
        d = torch.einsum("hwk,bjk->bhwj", dirs, R)  # rays in the object frame
        inv_d = 1.0 / d
        t1, t2 = (-half - o) * inv_d, (half - o) * inv_d
        tmin = torch.minimum(t1, t2).amax(-1)
        tmax = torch.maximum(t1, t2).amin(-1)
        hit = (tmax > torch.clamp(tmin, min=0.0)) & torch.isfinite(tmin)
        t_hit = torch.where(hit, tmin, torch.zeros_like(tmin))
        p = o + t_hit[..., None] * d
        face = torch.abs(torch.abs(p) - half).argmin(-1, keepdim=True)
        n = torch.zeros_like(p).scatter_(-1, face, torch.sign(torch.gather(p, -1, face)))
        tex = _texture(p, texture_seed)
        shade = torch.clamp(-torch.sum(n * d, -1) / torch.linalg.norm(d, dim=-1), 0.2, 1.0)
        gray = torch.where(hit, tex * (0.6 + 0.4 * shade.to(torch.float32)), 0.05)
        grays.append(torch.round(gray * 255.0).clamp(0, 255).to(torch.uint8))
        depths.append(torch.where(hit, torch.round(t_hit * 1000.0), 0.0).to(torch.int32))
        masks.append(hit)
    ob_in_cam = np.linalg.inv(T_co).astype(np.float32)
    return Loop(
        gray=torch.cat(grays).cpu().numpy(),
        depth=torch.cat(depths).cpu().numpy().astype(np.uint16),
        mask=torch.cat(masks).cpu().numpy(),
        ob_in_cam=ob_in_cam,
        K=K,
    )


def corner_points(box_size: float = 0.2) -> np.ndarray:
    """The cube's 8 corners [8, 3] in the object frame (metres)."""
    h = box_size / 2.0
    return np.array([[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)], np.float64)


def degrees_per_frame(loop_frames: int) -> float:
    return 360.0 / loop_frames

