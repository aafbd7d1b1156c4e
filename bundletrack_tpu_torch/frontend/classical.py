"""Weight-free classical frontend: Shi-Tomasi corners + normalized patches.

Counterpart of bundletrack_tpu/frontend/classical.py: CELL=4 bucketed top-K
keypoints and depth-scaled 16x16 patch descriptors (256-d, L2-normalized).
Arithmetic follows the JAX package operation for operation, so keypoints
come out identical on the same frame.  Images may carry leading batch axes
(the fleet's streams); each image is detected on its own.
"""

from __future__ import annotations

import torch

from bundletrack_tpu_torch.frontend.interface import FrontendOutput
from bundletrack_tpu_torch.ops.topk import topk_stable


def _gauss_kernel(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _edge_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    H, W = img.shape[-2:]
    rows = torch.clamp(torch.arange(-r, H + r, device=img.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-r, W + r, device=img.device), 0, W - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


def _sep_conv(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 2D convolution of [..., H, W] with 1D kernel k (edge padding)."""
    r = (k.shape[0] - 1) // 2
    H, W = img.shape[-2:]
    pad = _edge_pad(img, r)
    out = torch.zeros_like(img)
    for i in range(k.shape[0]):
        out = out + k[i] * pad[..., i : i + H, r : r + W]
    out2 = torch.zeros_like(img)
    pad = _edge_pad(out, r)
    for i in range(k.shape[0]):
        out2 = out2 + k[i] * pad[..., r : r + H, i : i + W]
    return out2


def _gradients(img: torch.Tensor):
    gx = torch.zeros_like(img)
    gx[..., :, 1:-1] = 0.5 * (img[..., :, 2:] - img[..., :, :-2])
    gy = torch.zeros_like(img)
    gy[..., 1:-1, :] = 0.5 * (img[..., 2:, :] - img[..., :-2, :])
    return gx, gy


def shi_tomasi_response(img: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """Min-eigenvalue corner response of the smoothed structure tensor."""
    gx, gy = _gradients(img)
    k = _gauss_kernel(sigma, max(1, int(2 * sigma)), img.device)
    Ixx = _sep_conv(gx * gx, k)
    Iyy = _sep_conv(gy * gy, k)
    Ixy = _sep_conv(gx * gy, k)
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return tr / 2.0 - disc


def _nms(resp: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Local-maximum mask.  Shifts wrap around the image edge (torch.roll),
    exactly as the JAX package's jnp.roll does; padded max pooling would not."""
    r = ksize // 2
    best = resp
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            best = torch.maximum(best, torch.roll(resp, (dy, dx), dims=(-2, -1)))
    return resp >= best


def _take_pixels(img, lin):
    """img [B, H, W] at linear pixel indices lin [B, ...] -> [B, ...]."""
    B = img.shape[0]
    return torch.gather(img.reshape(B, -1), 1, lin.reshape(B, -1)).reshape(lin.shape)


def _extract_patches_depth_scaled(img, kpts_uv, z, patch: int, z0: float):
    """Bilinear patches [B, N, patch, patch] of images [B, H, W] with
    per-keypoint spacing z0/z, so each patch covers a constant physical
    extent whatever the range."""
    H, W = img.shape[-2:]
    step = torch.where(z > 1e-6, z0 / torch.clamp(z, min=1e-6), torch.ones_like(z))
    step = torch.clamp(step, 0.2, 5.0)
    offs = torch.arange(patch, dtype=torch.float32, device=img.device) - (patch - 1) / 2.0
    gu = kpts_uv[..., :, None, None, 0] + step[..., :, None, None] * offs[None, None, :]
    gv = kpts_uv[..., :, None, None, 1] + step[..., :, None, None] * offs[None, :, None]
    u0 = torch.clamp(torch.floor(gu).to(torch.int32), 0, W - 2)
    v0 = torch.clamp(torch.floor(gv).to(torch.int32), 0, H - 2)
    du = torch.clamp(gu - u0, 0.0, 1.0)
    dv = torch.clamp(gv - v0, 0.0, 1.0)
    l00 = (v0 * W + u0).long()
    p00 = _take_pixels(img, l00)
    p01 = _take_pixels(img, l00 + 1)
    p10 = _take_pixels(img, l00 + W)
    p11 = _take_pixels(img, l00 + W + 1)
    return (
        p00 * (1 - du) * (1 - dv)
        + p01 * du * (1 - dv)
        + p10 * (1 - du) * dv
        + p11 * du * dv
    )


def _extract_patches_int(img, kpts_uv, patch: int):
    """Patches [B, N, patch, patch] of images [B, H, W] at integer keypoint
    centers."""
    H, W = img.shape[-2:]
    offs = torch.arange(patch, dtype=torch.int64, device=img.device) - (patch - 1) // 2
    u0 = torch.round(kpts_uv[..., 0]).long()
    v0 = torch.round(kpts_uv[..., 1]).long()
    gu = torch.clamp(u0[..., None, None] + offs[None, None, :], 0, W - 1)
    gv = torch.clamp(v0[..., None, None] + offs[None, :, None], 0, H - 1)
    return _take_pixels(img, gv * W + gu)


def harris_keypoints_and_descriptors(
    img: torch.Tensor,  # [..., H, W] grayscale in [0, 1]
    mask: torch.Tensor,  # [..., H, W] bool detection region
    top_k: int = 512,
    patch: int = 16,
    border: int = 10,
    sigma: float = 1.5,
    min_response: float = 1e-9,
    z_map: torch.Tensor | None = None,  # [..., H, W] depth for scale normalization
    patch_z0: float = 0.0,  # >0: depth-scaled patches, unit spacing at z0
) -> FrontendOutput:
    """Detect top-K corners and build normalized-patch descriptors.

    Bucketed top-K: each CELL x CELL cell keeps its best NMS peak, then the
    top K cell winners are taken — at most one keypoint per cell.  Ties
    rank the lower index first, as `lax.top_k` does.
    """
    H, W = img.shape[-2:]
    batch = img.shape[:-2]
    img = img.reshape(-1, H, W)
    B = img.shape[0]
    dev = img.device
    resp = shi_tomasi_response(img, sigma)
    peak = _nms(resp)
    u = torch.arange(W, device=dev)[None, :]
    v = torch.arange(H, device=dev)[:, None]
    inb = (u >= border) & (u < W - border) & (v >= border) & (v < H - border)
    neg_inf = torch.full_like(resp, float("-inf"))
    score_map = torch.where(peak & mask.reshape(B, H, W) & inb & (resp > min_response), resp, neg_inf)

    CELL = 4
    while CELL > 1 and ((H + CELL - 1) // CELL) * ((W + CELL - 1) // CELL) < top_k:
        CELL //= 2
    Hp = (H + CELL - 1) // CELL * CELL
    Wp = (W + CELL - 1) // CELL * CELL
    sm = torch.full((B, Hp, Wp), float("-inf"), dtype=score_map.dtype, device=dev)
    sm[:, :H, :W] = score_map
    cells = sm.reshape(B, Hp // CELL, CELL, Wp // CELL, CELL).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(B, (Hp // CELL) * (Wp // CELL), CELL * CELL)
    cell_best = torch.amax(cells, dim=-1)
    cell_arg = torch.argmax(cells, dim=-1)  # first index among equal values
    scores, cidx = topk_stable(cell_best, top_k)
    wc = Wp // CELL
    sub = torch.gather(cell_arg, 1, cidx)
    ku = ((cidx % wc) * CELL + sub % CELL).to(torch.float32)
    kv = ((cidx // wc) * CELL + sub // CELL).to(torch.float32)
    valid = torch.isfinite(scores)
    kpts = torch.stack([ku, kv], dim=-1)

    if patch_z0 > 0.0 and z_map is not None:
        ui = torch.clamp(torch.round(ku).long(), 0, W - 1)
        vi = torch.clamp(torch.round(kv).long(), 0, H - 1)
        z_kp = _take_pixels(z_map.reshape(B, H, W), vi * W + ui)
        patches = _extract_patches_depth_scaled(img, kpts, z_kp, patch, patch_z0)
    else:
        patches = _extract_patches_int(img, kpts, patch)
    flatp = patches.reshape(B, top_k, -1)
    mu = torch.mean(flatp, dim=-1, keepdim=True)
    sd = torch.std(flatp, dim=-1, keepdim=True, correction=0)  # population std, as jnp.std
    desc = (flatp - mu) / torch.clamp(sd, min=1e-6)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6)
    desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    out = FrontendOutput(
        kpts_uv=torch.where(valid[..., None], kpts, torch.zeros_like(kpts)),
        scores=torch.where(valid, scores, torch.full_like(scores, float("-inf"))),
        desc=desc,
        valid=valid,
    )
    return FrontendOutput(*(t.reshape(*batch, *t.shape[1:]) for t in out))
