"""The one traffic generator: S camera streams, each cycling a closed orbit loop.

A traffic file (trackbench/traffic/<name>.json) gives `streams`,
`loop_frames`, the orbit's `radius`, `elev_amp` and `box_size`, the
cube's texture (`texture_seed`, one for every stream, or `texture_seeds`,
the k-th pair's), and S (start phase, orbit direction) pairs: the k-th
starts at loop frame `phase_offset` + k * `phase_spacing` and orbits by
`directions[k]` (+1 or -1).  From `--seed` come the order in which the
streams take the pairs, the tracker's seed (its RANSAC draws) and the
frames the reference checks: every seed gives the same set of inputs in
another order, so the work per frame does not depend on the seed.  Stream
s at fleet frame t shows loop frame (phase[s] + direction[s] * t) mod
loop_frames: one rendered frame per tracked frame, whatever the speed of
the tracker.
"""

from __future__ import annotations

import numpy as np

from trackbench.render import Loop, render_loop


def seed_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(int(seed) % 2**64))


class Schedule:
    """Per-stream start phase and direction, and the seeds derived from `seed`."""

    def __init__(self, traffic: dict, seed: int):
        rng = seed_rng(seed)
        S, F = int(traffic["streams"]), int(traffic["loop_frames"])
        dirs = np.asarray(traffic["directions"], np.int64)
        if len(dirs) != S:
            raise ValueError(f"traffic has {len(dirs)} directions for {S} streams")
        if "texture_seeds" in traffic:
            textures = np.asarray(traffic["texture_seeds"], np.int64)
        else:
            textures = np.full(S, int(traffic["texture_seed"]), np.int64)
        if len(textures) != S:
            raise ValueError(f"traffic has {len(textures)} texture seeds for {S} streams")
        self.tracker_seed = int(rng.integers(0, 2**31 - 1))
        k = rng.permutation(S)  # stream s runs the traffic's k[s]-th (phase, direction) pair
        self.phase = (int(traffic["phase_offset"]) + int(traffic["phase_spacing"]) * k) % F
        self.direction = dirs[k]
        self.texture = textures[k]  # each stream's texture seed
        self.loop_frames = F
        self.streams = S

    def frames(self, t: int) -> np.ndarray:
        """Loop frame of each stream at fleet frame t."""
        return (self.phase + self.direction * int(t)) % self.loop_frames

    def sample(self, seed: int, count: int, below: int) -> list:
        """`count` distinct fleet-frame indices of the window in [0, below),
        drawn from the seed: the frames the reference checks."""
        rng = seed_rng(int(seed) + 1)
        return sorted(int(i) for i in rng.choice(below, size=min(count, below), replace=False))


class Streams:
    """The rendered loops (one per texture) and the schedule: each fleet
    frame's host arrays."""

    def __init__(self, traffic: dict, seed: int, H: int, W: int, device="cpu"):
        self.schedule = Schedule(traffic, seed)
        seeds, self.which = np.unique(self.schedule.texture, return_inverse=True)
        loops = [render_loop(
            H, W, int(s), loop_frames=int(traffic["loop_frames"]),
            radius=float(traffic["radius"]), elev_amp=float(traffic["elev_amp"]),
            box_size=float(traffic["box_size"]), device=device) for s in seeds]
        self.loop: Loop = loops[0]  # the geometry, K and poses every texture shares
        self.gray, self.depth, self.mask = (np.stack([getattr(lp, k) for lp in loops])
                                            for k in ("gray", "depth", "mask"))  # [textures, F, H, W]
        self.K = np.broadcast_to(self.loop.K, (self.schedule.streams, 3, 3)).copy()

    def observation(self, t: int):
        """(gray u8, depth u16 mm, mask bool) [S, H, W] and K [S, 3, 3] of fleet frame t."""
        f = self.schedule.frames(t)
        return self.gray[self.which, f], self.depth[self.which, f], self.mask[self.which, f], self.K

    def truth(self, t: int) -> np.ndarray:
        """Ground-truth object-in-camera poses [S, 4, 4] of fleet frame t."""
        return self.loop.ob_in_cam[self.schedule.frames(t)]
