"""Spans and captures around the program's calls, from the benchmark's side.

The program's step calls its stages by module-level names
(`tracker/bundler.py` imports `extract_frame_features`, `ransac_pair`,
`optimize_pose_graph_verified`, ...).  `Hooks.install` replaces those names
with thin wrappers, as profile_step wraps its stages, but with no added
device synchronisation: with `spans` on (the traced stretch only) each call
runs inside a `torch.profiler.record_function` span named after its layer;
with `armed` on (the sampled frames only) the wrapper keeps the call's
inputs and outputs for the reference check, by reference (the step is
functional: it never writes a tensor it was given).  Everything is restored
by `remove`.
"""

from __future__ import annotations

import collections
import importlib

import torch

# (module, name, span, capture key) of each wrapped call; the span names are
# the layers that the per-layer metrics read (trackbench/metrics/)
PORT = "bundletrack_tpu_torch"
WRAPPED = (
    ("tracker.bundler", "extract_frame_features", "frontend", "feats"),
    ("tracker.bundler", "match_pair", "matching", None),
    ("tracker.bundler", "ransac_pair", "matching", None),
    ("tracker.bundler", "refine_pose_on_inliers", "matching", None),
    ("tracker.bundler", "select_ba_subset", "matching", None),
    ("tracker.bundler", "match_pairs_batched", "matching", None),
    ("tracker.bundler", "propagate_matches", "matching", None),
    ("tracker.bundler", "merge_matches", "matching", None),
    ("tracker.bundler", "update_mappoints", "matching", None),
    ("matching.pairwise", "fused_mutual_match_pairs", "matcher", "matcher"),
    ("tracker.bundler", "optimize_pose_graph_verified", "gn", "gn"),
    ("tracker.bundler", "_admit_keyframe", "admission", None),
    ("frontend.lfnet", "xla_order_sums", "sums", None),
    ("frontend.detector_ops", "xla_order_instance_stats", "sums", None),
    ("utils.flax_layers", "xla_order_mean_var", "sums", None),
)
SPAN_PREFIX = "trackbench."


class Hooks:
    def __init__(self, package: str = PORT, wrapped=WRAPPED):
        self.spans = False
        self.armed = False
        self.calls = collections.defaultdict(list)  # capture key -> [(args, kwargs, out)]
        self.shapes = collections.defaultdict(list)  # span -> [each call's argument shapes], while spans
        self.counts = collections.Counter()  # span -> calls
        self._package = package
        self._wrapped = wrapped
        self._saved = []

    def install(self):
        for mod_name, attr, span, key in self._wrapped:
            mod = importlib.import_module(f"{self._package}.{mod_name}")
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, span, key))
        return self

    def remove(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def _wrap(self, fn, span, key):
        def wrapper(*args, **kwargs):
            self.counts[span] += 1
            if self.spans:
                self.shapes[span].append(_shapes(args))
                with torch.profiler.record_function(SPAN_PREFIX + span):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if self.armed and key is not None:
                self.calls[key].append((args, kwargs, out))
            return out

        wrapper.__wrapped__ = fn
        return wrapper


def _shapes(args):
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(tuple(a.shape))
        elif isinstance(a, (list, tuple)) and not hasattr(a, "_fields") and a \
                and all(isinstance(t, torch.Tensor) for t in a):
            out.append([tuple(t.shape) for t in a])
        else:
            out.append(a if isinstance(a, (int, float, bool, str)) else None)
    return out
