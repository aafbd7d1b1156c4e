"""Checkpoint and resume of any nest of tensors, in one `.npz` file.

Counterpart of bundletrack_tpu/utils/checkpoint.py, which writes orbax
directories; the port has no orbax, so `save_tracker_state(path, tree)`
writes `path/state.npz` instead.  The tree may be any nest of NamedTuples,
dicts, lists and tuples whose leaves are tensors, numpy arrays, Python
scalars, strings, None or torch.Generators: a TrackerState (one stream or a
fleet), a state dict, an optimiser's state dict.  bf16 tensors are stored
as their int16 bits (numpy has no bf16 without ml_dtypes).  Restoring walks
a template `like` of the same structure and checks every name, shape and
dtype against it; tensors come back on the template's devices.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

STATE_FILE = "state.npz"
_DTYPES = "__dtypes__"  # the name of the entry holding each tensor's torch dtype


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs of a nest node, or None for a leaf."""
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, prefix=""):
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else k)


def _rebuild(like, values, prefix=""):
    kids = _children(like)
    if kids is None:
        return values[prefix]
    built = [_rebuild(v, values, f"{prefix}/{k}" if prefix else k) for k, v in kids]
    if _is_namedtuple(like):
        return type(like)(*built)
    if isinstance(like, dict):
        return dict(zip(like.keys(), built))
    return type(like)(built)


def save_tracker_state(path: str, tree) -> None:
    """Save any nest of tensors to the directory `path` (made if missing;
    an earlier checkpoint there is replaced)."""
    arrays, dtypes = {}, {}
    for name, leaf in _leaves(tree):
        if isinstance(leaf, torch.Generator):
            leaf = leaf.get_state()
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            dtypes[name] = str(t.dtype)
            arrays[name] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        elif leaf is not None:
            arrays[name] = np.asarray(leaf)
    arrays[_DTYPES] = np.asarray(json.dumps(dtypes))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "tmp." + STATE_FILE)
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # a crash mid-write keeps the old file


def restore_tracker_state(path: str, like):
    """The nest saved by save_tracker_state in `path`, with `like`'s
    structure and devices.  A name of `like` missing from the file, or one
    the file has beyond it, raises KeyError; a shape or dtype that differs
    from `like`'s raises ValueError."""
    with np.load(os.path.join(path, STATE_FILE)) as data:
        saved = {k: data[k] for k in data.files}
    dtypes = json.loads(str(saved.pop(_DTYPES)))
    values = {}
    for name, leaf in _leaves(like):
        if leaf is None:
            values[name] = None
            continue
        if name not in saved:
            raise KeyError(f"checkpoint {path} has no entry {name}")
        a = saved.pop(name)
        if isinstance(leaf, torch.Generator):
            g = torch.Generator(device=leaf.device)
            g.set_state(torch.from_numpy(a))
            values[name] = g
        elif isinstance(leaf, torch.Tensor):
            if dtypes.get(name) != str(leaf.dtype) or a.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint {path}: {name} is {dtypes.get(name)} {a.shape}, "
                                 f"expected {leaf.dtype} {tuple(leaf.shape)}")
            t = torch.from_numpy(a)
            values[name] = (t.view(torch.bfloat16) if leaf.dtype == torch.bfloat16 else t).to(leaf.device)
        elif isinstance(leaf, np.ndarray):
            if a.dtype != leaf.dtype or a.shape != leaf.shape:
                raise ValueError(f"checkpoint {path}: {name} is {a.dtype} {a.shape}, "
                                 f"expected {leaf.dtype} {leaf.shape}")
            values[name] = a
        else:  # a Python scalar or string
            if a.shape != () or np.asarray(leaf).dtype.kind != a.dtype.kind:
                raise ValueError(f"checkpoint {path}: {name} is {a.dtype} {a.shape}, expected {type(leaf).__name__}")
            values[name] = type(leaf)(a.item())
    if saved:
        raise KeyError(f"checkpoint {path} has entries the template lacks: {sorted(saved)}")
    return _rebuild(like, values)
