"""Hard synthetic RGB-D world: multi-shape, image-textured, degraded sensing.

The port's own copy of bundletrack_tpu/data/hard_world.py (numpy only): the
same seed renders the same frames, bit for bit, for both packages.

The easy renderer (data/synthetic.py) is one clean textured cube — it cannot
expose descriptor weakness, mask-fill errors, or drift the way the
reference's real NOCS-REAL275/YCBInEOAT validation data does (reference:
scripts/eval_ycbineoat.py:105-164; no real dataset ships with the
repository).  This module is
the stand-in: an analytically ray-traced world that is deliberately hostile
to every stage of the tracker:

  * three object shapes — cube, capped cylinder, non-convex L-shape
    (union of boxes; self-occluding silhouettes);
  * image-like surface appearance — multi-octave (fBm) value noise with
    per-face albedo variation and view-dependent (headlamp) shading, so
    descriptors see brightness change across viewpoints;
  * a textured background sphere with VALID depth everywhere, so mask
    errors admit real (wrong) geometry instead of conveniently-invalid
    pixels;
  * Kinect-style depth degradation — quadratic-with-range Gaussian noise,
    1 mm quantization, blob-shaped holes, grazing-angle dropout;
  * imperfect masks — per-frame random dilate/erode, boundary jitter,
    occasional "bites" (missing chunks) and background "blobs" (false
    positives), mimicking VOS failure modes;
  * trajectory passes with 2x scale change, fast rotation, and in-plane
    camera roll.

Everything is deterministic in `seed`.  Ground-truth (clean) depth and mask
ride along for diagnostics; the tracker consumes the degraded ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from bundletrack_tpu_torch.data.synthetic import _hash01, _look_at


class HardSequence(NamedTuple):
    gray: np.ndarray  # [F, H, W] float32 in [0, 1]
    depth: np.ndarray  # [F, H, W] float32 meters, degraded (0 = invalid)
    mask: np.ndarray  # [F, H, W] bool, degraded (what the tracker sees)
    ob_in_cam: np.ndarray  # [F, 4, 4] ground-truth object pose in camera
    K: np.ndarray  # [3, 3]
    mask_gt: np.ndarray  # [F, H, W] bool, exact silhouette
    depth_gt: np.ndarray  # [F, H, W] float32, exact


# ---------------------------------------------------------------------------
# texture: multi-octave value noise (image-like appearance)


def _smooth_noise3(p: np.ndarray, cell: float, seed: int) -> np.ndarray:
    """Trilinearly interpolated lattice noise at 3D points p [..., 3]."""
    q = p / cell
    q0 = np.floor(q)
    # f32 lerp internals: the fade/trilerp math never needs f64 (the output
    # is f32 anyway) — halving its memory traffic matters on host; the
    # lattice itself stays f64 so cell assignment is unchanged
    f = (q - q0).astype(np.float32)
    f = f * f * (np.float32(3.0) - np.float32(2.0) * f)  # smoothstep fade
    ix, iy, iz = (q0[..., i].astype(np.int64) for i in range(3))
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    # corner hash = _hash01(ix+dx, iy+dy, iz+dz, seed), with the linear part
    # hoisted: base + (dx, dy, dz)·K is bitwise-identical to recomputing the
    # three int64 multiplies per corner and ~2x faster (host rendering is the
    # long-horizon suite's bottleneck on a machine with few cores)
    base = (
        ix * 374761393 + iy * 668265263 + iz * 2147483647
        + np.int64(seed) * 979025471
    )

    def corner(dx, dy, dz):
        h = base + np.int64(dx * 374761393 + dy * 668265263 + dz * 2147483647)
        h = (h ^ (h >> 13)) * 1274126177
        h = h ^ (h >> 16)
        return (h & 0xFFFF).astype(np.float32) / 65535.0

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    x00 = c000 + (c100 - c000) * fx
    x10 = c010 + (c110 - c010) * fx
    x01 = c001 + (c101 - c001) * fx
    x11 = c011 + (c111 - c011) * fx
    y0 = x00 + (x10 - x00) * fy
    y1 = x01 + (x11 - x01) * fy
    return y0 + (y1 - y0) * fz


def fbm3(p: np.ndarray, seed: int, octaves: int = 4, base_cell: float = 0.08) -> np.ndarray:
    """Fractal (multi-octave) value noise in [0, 1] — image-like texture."""
    out = np.zeros(p.shape[:-1], np.float32)
    amp, norm = 1.0, 0.0
    for o in range(octaves):
        out += amp * _smooth_noise3(p, base_cell / (2.0**o), seed + 101 * o)
        norm += amp
        amp *= 0.55
    return (out / norm).astype(np.float32)


def _masked_fbm(
    p: np.ndarray, where: np.ndarray, seed: int, octaves: int, base_cell: float
) -> np.ndarray:
    """fbm3 evaluated only at `where` pixels (zeros elsewhere).

    Bitwise-identical to full-frame fbm3 at the pixels that are read — the
    renderer only ever consumes each texture inside its own region (object /
    background / occluder), so skipping the rest cuts the dominant render
    cost roughly in half."""
    out = np.zeros(p.shape[:-1], np.float32)
    idx = np.nonzero(where)
    if idx[0].size:
        out[idx] = fbm3(p[idx], seed=seed, octaves=octaves, base_cell=base_cell)
    return out


# ---------------------------------------------------------------------------
# analytic primitives (object frame); each returns (t, normal, hit)


def _intersect_box(o, d, center, half):
    """Slab-method ray/box: o [3], d [..., 3]; returns z-depth t, normal, hit."""
    center = np.asarray(center, np.float64)
    half = np.asarray(half, np.float64)
    oc = o - center
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = 1.0 / d
    t1 = (-half - oc) * inv_d
    t2 = (half - oc) * inv_d
    tn = np.minimum(t1, t2)
    tf = np.maximum(t1, t2)
    tmin = tn.max(axis=-1)
    tmax = tf.min(axis=-1)
    hit = (tmax > np.maximum(tmin, 1e-6)) & np.isfinite(tmin)
    t = np.where(hit, tmin, np.inf)
    # entry face = the axis achieving tmin
    face_axis = tn.argmax(axis=-1)
    n = np.zeros(d.shape, np.float32)
    ii = np.indices(face_axis.shape)
    n[(*ii, face_axis)] = -np.sign(d[(*ii, face_axis)]).astype(np.float32)
    return t, n, hit


def _intersect_cylinder(o, d, radius, half_h):
    """Capped cylinder along the object-frame y axis, centered at origin."""
    ox, oy, oz = o
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dz * dz
    b = ox * dx + oz * dz
    c = ox * ox + oz * oz - radius * radius
    disc = b * b - a * c
    with np.errstate(divide="ignore", invalid="ignore"):
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_side = (-b - sq) / a
    y_side = oy + t_side * dy
    side_ok = (disc > 0) & (t_side > 1e-6) & (np.abs(y_side) <= half_h)
    t_s = np.where(side_ok, t_side, np.inf)

    with np.errstate(divide="ignore", invalid="ignore"):
        t_top = (half_h - oy) / dy
        t_bot = (-half_h - oy) / dy

    def cap_ok(t_c):
        with np.errstate(invalid="ignore"):  # inf*0 on dy==0 rays
            px = ox + np.where(np.isfinite(t_c), t_c, 0.0) * dx
            pz = oz + np.where(np.isfinite(t_c), t_c, 0.0) * dz
        return (
            np.isfinite(t_c) & (t_c > 1e-6)
            & (px * px + pz * pz <= radius * radius)
        )

    t_t = np.where(cap_ok(t_top), t_top, np.inf)
    t_b = np.where(cap_ok(t_bot), t_bot, np.inf)

    t = np.minimum(np.minimum(t_s, t_t), t_b)
    hit = np.isfinite(t)
    n = np.zeros(d.shape, np.float32)
    use_side = hit & (t == t_s)
    use_top = hit & ~use_side & (t == t_t)
    use_bot = hit & ~use_side & ~use_top
    with np.errstate(invalid="ignore"):  # inf*0 on miss rays; masked below
        px = ox + np.where(hit, t, 0.0) * dx
        pz = oz + np.where(hit, t, 0.0) * dz
    inv_r = 1.0 / radius
    n[..., 0] = np.where(use_side, px * inv_r, 0.0)
    n[..., 2] = np.where(use_side, pz * inv_r, 0.0)
    n[..., 1] = np.where(use_top, 1.0, np.where(use_bot, -1.0, n[..., 1]))
    return np.where(hit, t, np.inf), n, hit


def _intersect_union(parts):
    """Union of primitives: nearest hit wins (non-convex shapes)."""
    t = np.full(parts[0][0].shape, np.inf)
    n = np.zeros(parts[0][1].shape, np.float32)
    hit = np.zeros(parts[0][0].shape, bool)
    for tp, np_, hp in parts:
        closer = hp & (tp < t)
        t = np.where(closer, tp, t)
        n = np.where(closer[..., None], np_, n)
        hit |= hp
    return t, n, hit


def _intersect_shape(shape: str, o, d, size: float):
    s = size / 2.0
    if shape == "cube":
        return _intersect_box(o, d, (0, 0, 0), (s, s, s))
    if shape == "cylinder":
        return _intersect_cylinder(o, d, radius=0.7 * s, half_h=s)
    if shape == "lshape":
        # non-convex L: horizontal bar + vertical limb (object frame)
        return _intersect_union([
            _intersect_box(o, d, (0.0, -0.6 * s, 0.0), (s, 0.4 * s, 0.5 * s)),
            _intersect_box(o, d, (-0.6 * s, 0.2 * s, 0.0), (0.4 * s, 0.8 * s, 0.5 * s)),
        ])
    if shape == "tshape":
        return _intersect_union([
            _intersect_box(o, d, (0.0, 0.6 * s, 0.0), (s, 0.4 * s, 0.45 * s)),
            _intersect_box(o, d, (0.0, -0.3 * s, 0.0), (0.35 * s, 0.7 * s, 0.45 * s)),
        ])
    raise ValueError(f"unknown shape {shape!r}")


def model_points(shape: str, size: float = 0.2, n: int = 500, seed: int = 0) -> np.ndarray:
    """Sample surface points of a shape for ADD/ADD-S evaluation (the role of
    the reference's points.xyz model files, scripts/eval_ycbineoat.py:117-130):
    ray-cast from random directions and keep the hit points."""
    rng = np.random.RandomState(seed)
    out = []
    # cast bundles of rays from random viewpoints on a sphere toward the
    # shape; hit points sample the visible surface from all sides
    for _ in range(24):
        view = rng.randn(3)
        view /= np.linalg.norm(view)
        o = view * (2.5 * size)
        targets = (rng.rand(n, 3) - 0.5) * size  # aim inside the bounding box
        d = targets - o
        t, _, hit = _intersect_shape(shape, o, d, size)
        p = o + t[..., None] * d
        out.append(p[hit & np.isfinite(t)])
        if sum(len(p_) for p_ in out) >= 4 * n:
            break
    pts = np.concatenate(out, axis=0)
    rng.shuffle(pts)
    return pts[:n].astype(np.float32)


# ---------------------------------------------------------------------------
# degradation operators


def _binary_shift_or(mask: np.ndarray, r: int) -> np.ndarray:
    """Dilate by a (2r+1) cross via shifted ORs (no scipy dependency)."""
    out = mask.copy()
    for k in range(1, r + 1):
        out[k:, :] |= mask[:-k, :]
        out[:-k, :] |= mask[k:, :]
        out[:, k:] |= mask[:, :-k]
        out[:, :-k] |= mask[:, k:]
    return out


def _morph(mask: np.ndarray, k: int) -> np.ndarray:
    """k > 0: dilate k px; k < 0: erode k px (cross structuring element)."""
    if k > 0:
        return _binary_shift_or(mask, k)
    if k < 0:
        return ~_binary_shift_or(~mask, -k)
    return mask


def _disc(H, W, cy, cx, r):
    yy, xx = np.ogrid[:H, :W]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def degrade_mask(mask: np.ndarray, rng: np.random.RandomState,
                 max_morph_px: int = 3, p_bite: float = 0.35,
                 p_blob: float = 0.25) -> np.ndarray:
    """VOS-failure-mode mask corruption: morph error + bites + false blobs."""
    H, W = mask.shape
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return mask
    out = _morph(mask, int(rng.randint(-max_morph_px, max_morph_px + 1)))
    bbox_diag = float(np.hypot(ys.max() - ys.min() + 1, xs.max() - xs.min() + 1))
    if rng.rand() < p_bite:
        i = rng.randint(len(ys))
        out &= ~_disc(H, W, ys[i], xs[i], max(3, 0.12 * bbox_diag * rng.rand()))
    if rng.rand() < p_blob:
        i = rng.randint(len(ys))
        off = rng.randint(-15, 16, size=2)
        out |= _disc(H, W, ys[i] + off[0], xs[i] + off[1],
                     max(2, 0.06 * bbox_diag * rng.rand()))
    # boundary jitter: flip a sprinkling of edge pixels
    edge = _binary_shift_or(out, 1) & ~_morph(out, -1)
    flip = edge & (rng.rand(H, W) < 0.25)
    return out ^ flip


def degrade_depth(depth: np.ndarray, normal_dot_view: np.ndarray,
                  rng: np.random.RandomState, noise_sigma: float = 0.003,
                  quant: float = 0.001, hole_fraction: float = 0.03,
                  ref_depth: float = 0.55) -> np.ndarray:
    """Kinect-style depth corruption (quadratic noise + quantization + holes)."""
    H, W = depth.shape
    valid = depth > 0
    z = depth
    sigma = noise_sigma * (z / ref_depth) ** 2
    z = z + sigma * rng.randn(H, W).astype(np.float32)
    if quant > 0:
        z = np.round(z / quant) * quant
    # blob holes: threshold smooth 2D noise at the requested fraction
    if hole_fraction > 0:
        u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32))
        p = np.stack([u / 25.0, v / 25.0, np.full_like(u, rng.randint(1000))], -1)
        noise = _smooth_noise3(p, 1.0, seed=7)
        thr = np.quantile(noise, hole_fraction)
        z = np.where(noise < thr, 0.0, z)
    # grazing-angle dropout: surfaces nearly edge-on to the ray often return
    # no depth on real sensors
    grazing = np.abs(normal_dot_view) < 0.25
    drop = grazing & (rng.rand(H, W) < 0.5)
    z = np.where(drop, 0.0, z)
    return np.where(valid, z, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# renderer


def render_hard_sequence(
    shape: str = "lshape",
    num_frames: int = 32,
    H: int = 480,
    W: int = 640,
    size: float = 0.2,
    radius: float = 0.55,
    orbit_deg_per_frame: float = 3.0,
    elev_amp: float = 0.15,
    roll_deg_per_frame: float = 0.0,
    scale_to: float = 1.0,  # radius multiplier reached at the last frame
    seed: int = 0,
    # degradations (set all to 0/False for a clean hard-shape render)
    depth_noise: float = 0.003,
    depth_quant: float = 0.001,
    hole_fraction: float = 0.03,
    mask_errors: bool = True,
    background: bool = True,
    bg_radius: float = 1.2,
    texture_octaves: int = 4,
    # second object: a textured distractor cube sweeping between camera and
    # target — occludes the target (mask/mask_gt exclude hidden pixels) and
    # gives VOS a two-object discrimination problem
    occluder: bool = False,
    occluder_size: float = 0.35,  # relative to `size`
) -> HardSequence:
    fx = fy = 0.9 * W
    K = np.array([[fx, 0, W / 2 - 0.5], [0, fy, H / 2 - 0.5], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(seed + 17)

    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    dirs_cam = np.stack(
        [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)], axis=-1
    )  # z-normalized: z-depth = t

    grays, depths, masks, poses, masks_gt, depths_gt = [], [], [], [], [], []
    for f in range(num_frames):
        ang = np.deg2rad(orbit_deg_per_frame * f)
        frac = f / max(num_frames - 1, 1)
        r_f = radius * (1.0 + (scale_to - 1.0) * frac)
        eye = np.array([
            r_f * np.sin(ang),
            elev_amp * np.sin(0.7 * ang),
            -r_f * np.cos(ang),
        ])
        roll = np.deg2rad(roll_deg_per_frame * f)
        up = np.array([np.sin(roll), np.cos(roll), 0.0])
        T_cw = _look_at(eye, np.zeros(3), up=up)
        R_cw, t_cw = T_cw[:3, :3], T_cw[:3, 3]

        o = t_cw
        d = dirs_cam @ R_cw.T  # [H, W, 3] rays in object frame

        t_obj, n_obj, hit = _intersect_shape(shape, o, d, size)
        t_obj = np.where(hit, t_obj, 0.0)
        p_obj = o + t_obj[..., None] * d

        occ_closer = np.zeros_like(hit)
        t_occ = None
        p_occ = None
        if occluder:
            # distractor sweeps laterally on the camera side of the target
            toward_cam = eye / max(np.linalg.norm(eye), 1e-6)
            occ_c = 0.45 * np.linalg.norm(eye) * toward_cam + np.array([
                1.2 * size * np.sin(0.25 * f),
                0.6 * size * np.cos(0.2 * f),
                0.0,
            ])
            occ_half = np.full(3, 0.5 * occluder_size * size)
            t_o, n_o, hit_o = _intersect_box(o, d, occ_c, occ_half)
            occ_closer = hit_o & (~hit | (t_o < np.where(hit, t_obj, np.inf)))
            t_occ = np.where(occ_closer, t_o, 0.0)
            p_occ = o + t_occ[..., None] * d
            hit = hit & ~occ_closer  # target pixels hidden by the distractor

        # per-face albedo variation: quantize the normal into a face id so
        # different faces have different base brightness (low-contrast areas)
        face_id = (np.round(n_obj) * np.array([1, 3, 9])).sum(-1).astype(np.int64)
        albedo = 0.35 + 0.5 * _hash01(face_id, face_id * 7 + 1, face_id * 13 + 2, seed)
        tex = _masked_fbm(p_obj, hit, seed=seed, octaves=texture_octaves,
                          base_cell=0.45 * size)
        d_norm = d / np.linalg.norm(d, axis=-1, keepdims=True)
        ndotv = -np.sum(n_obj * d_norm, axis=-1)
        shade = np.clip(ndotv, 0.35, 1.0)  # headlamp: view-dependent
        obj_gray = albedo * (0.35 + 0.65 * tex) * shade

        if background:
            # inside-out sphere: every miss ray hits textured background with
            # VALID depth — mask errors admit real wrong geometry
            a = np.sum(d * d, axis=-1)
            b = np.sum(o[None, None, :] * d, axis=-1)
            c = float(o @ o) - bg_radius**2
            t_bg = (-b + np.sqrt(np.maximum(b * b - a * c, 0.0))) / a
            p_bg = o + t_bg[..., None] * d
            bg_tex = _masked_fbm(p_bg, ~hit, seed=seed + 999,
                                 octaves=texture_octaves, base_cell=0.35)
            gray = np.where(hit, obj_gray, 0.25 + 0.55 * bg_tex)
            depth_clean = np.where(hit, t_obj, t_bg).astype(np.float32)
            ndv_full = np.where(hit, ndotv, 1.0)
        else:
            gray = np.where(hit, obj_gray, 0.05)
            depth_clean = np.where(hit, t_obj, 0.0).astype(np.float32)
            ndv_full = np.where(hit, ndotv, 1.0)

        if occluder and occ_closer.any():
            occ_tex = _masked_fbm(p_occ, occ_closer, seed=seed + 555,
                                  octaves=texture_octaves, base_cell=0.3 * size)
            gray = np.where(occ_closer, 0.30 + 0.60 * occ_tex, gray)
            depth_clean = np.where(occ_closer, t_occ, depth_clean).astype(
                np.float32
            )
            ndv_full = np.where(occ_closer, 1.0, ndv_full)

        gray = np.clip(gray, 0.0, 1.0).astype(np.float32)
        depth_deg = degrade_depth(
            depth_clean, ndv_full, rng, noise_sigma=depth_noise,
            quant=depth_quant, hole_fraction=hole_fraction, ref_depth=radius,
        )
        mask_deg = degrade_mask(hit, rng) if mask_errors else hit

        grays.append(gray)
        depths.append(depth_deg)
        masks.append(mask_deg)
        masks_gt.append(hit)
        depths_gt.append(np.where(hit, t_obj, depth_clean).astype(np.float32))
        poses.append(np.linalg.inv(T_cw).astype(np.float32))

    return HardSequence(
        gray=np.stack(grays),
        depth=np.stack(depths),
        mask=np.stack(masks),
        ob_in_cam=np.stack(poses),
        K=K,
        mask_gt=np.stack(masks_gt),
        depth_gt=np.stack(depths_gt),
    )


def hard_passes(H: int = 480, W: int = 640, num_frames: int = 32, seed: int = 0):
    """The hard evaluation suite: dict of named passes.

    Covers all three shapes with full degradations, a 2x scale-change pass,
    and a fast-rotation pass (with in-plane roll, stressing descriptor
    orientation handling).
    """
    return {
        "cube": render_hard_sequence(
            "cube", num_frames, H, W, seed=seed),
        "cylinder": render_hard_sequence(
            "cylinder", num_frames, H, W, seed=seed + 1),
        "lshape": render_hard_sequence(
            "lshape", num_frames, H, W, seed=seed + 2),
        "scale2x": render_hard_sequence(
            "lshape", num_frames, H, W, seed=seed + 3,
            radius=0.45, scale_to=2.0, orbit_deg_per_frame=2.0),
        "fastrot": render_hard_sequence(
            "lshape", num_frames, H, W, seed=seed + 4,
            orbit_deg_per_frame=8.0, roll_deg_per_frame=3.0),
    }


def long_hard_passes(
    H: int = 480, W: int = 640, num_frames: int = 128, seed: int = 0
):
    """Long-horizon hostile passes: >=128-frame runs that
    stress keyframe eviction, drift accumulation, and re-acquisition — the
    regimes 16-frame passes cannot reach.  The reference's validation is
    1,000+-frame real sequences (scripts/eval_ycbineoat.py:105-164); these
    are the synthetic stand-ins at matching horizon character.

    orbit:    full 360+ degree orbit of the non-convex L-shape with all
              degradations — every face enters and leaves view, exercising
              keyframe-pool admission/eviction and map-point lifetime.
    occluder: textured distractor sweeps between camera and target ~5 times
              — repeated partial occlusions force FAIL/recovery cycles.
    scale2x:  camera recedes to 2x range over the full run — the appearance
              scale halves while the pool still holds near-field keyframes.
    """
    return {
        "orbit": render_hard_sequence(
            "lshape", num_frames, H, W, seed=seed + 11,
            orbit_deg_per_frame=3.0),
        "occluder": render_hard_sequence(
            "cube", num_frames, H, W, seed=seed + 12,
            orbit_deg_per_frame=2.0, occluder=True),
        "scale2x": render_hard_sequence(
            "lshape", num_frames, H, W, seed=seed + 13,
            radius=0.45, scale_to=2.0, orbit_deg_per_frame=2.0),
    }
