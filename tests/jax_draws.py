"""The RANSAC phases the JAX tracker draws, for the port's tests to replay.

The JAX step splits its state's key the same way on every frame, whatever
the data, so the draws of a tracker seeded with `seed` depend only on the
seed and on (max_matches, ransac.max_iter, bundle.max_ba_frames).
"""

import jax
import jax.numpy as jnp
import numpy as np


def phases_from_key(rng_key, cfg):
    """The RANSAC phases the JAX step draws from its state's key:
    (neighbour [3, n_rep], BA pairs [P, 3, n_rep])."""
    M = cfg.shapes.max_matches
    n_rep = -(-cfg.ransac.max_iter // M)
    K = cfg.bundle.max_ba_frames
    _, kn, km = jax.random.split(rng_key, 3)
    draw = lambda k: jax.random.randint(k, (3, n_rep), 0, M, dtype=jnp.int32)  # noqa: E731
    return np.asarray(draw(kn)), np.asarray(jax.vmap(draw)(jax.random.split(km, K * (K - 1) // 2)))


def jax_phases(cfg, num_frames: int, seed: int = 0):
    """The RANSAC phases of every frame that the JAX tracker seeded with
    `seed` draws: its key splits the same way on every frame, whatever the
    data, so they need no JAX tracker."""
    key = jax.random.PRNGKey(seed)
    for _ in range(num_frames):
        yield phases_from_key(key, cfg)
        key = jax.random.split(key, 3)[0]


def jax_draws_arrays(cfg, num_frames: int, seed: int = 0):
    """jax_phases stacked over frames: (neighbour [F, 3, n_rep], BA pairs
    [F, P, 3, n_rep]), int32 as JAX draws them."""
    neighbour, pairs = zip(*jax_phases(cfg, num_frames, seed))
    return np.stack(neighbour), np.stack(pairs)
