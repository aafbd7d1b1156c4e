"""Single-file npz parameter files, read and written without flax.

Counterpart of bundletrack_tpu/utils/params_io.py, reading only.  A file
holds one array per parameter under its flat name
(`detector/block_1/conv1/kernel`), floats stored as float16.  Reading
restores floats as float32 and checks every name and shape against what
the model expects.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def load_params_npz(path: str, like: Mapping[str, tuple]) -> dict:
    """{flat name: array} from `path`, floats as float32.

    `like` maps every name the model expects to its shape.  A missing name
    raises KeyError; a wrong shape, or a name the model does not have,
    raises ValueError."""
    flat = {}
    with np.load(path) as data:
        for k, shape in like.items():
            if k not in data:
                raise KeyError(f"checkpoint {path} missing param {k}")
            a = np.asarray(data[k])
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.float32)
            if a.shape != tuple(shape):
                raise ValueError(f"param {k}: checkpoint shape {a.shape} != model {tuple(shape)}")
            flat[k] = a
        extra = set(data.files) - set(like)
    if extra:
        raise ValueError(f"checkpoint {path} has unknown params: {sorted(extra)}")
    return flat

