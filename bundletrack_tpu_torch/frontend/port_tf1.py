"""TF1 LF-Net checkpoint -> the port's LF-Net state dict.

Counterpart of bundletrack_tpu/frontend/port_tf1.py.  The reference serves
TF1 weights (reference: lf-net-release/run_server.py saver.restore:120-134;
variable scopes from models/mso_resnet_detector.py get_model:64-173 —
'ConvOnlyResNet/{init_conv, block-{i}/{pre-bn, conv1, mid-bn, conv2},
fin-bn, score_conv_{i}, ori_conv}' — and models/simple_desc.py
get_model:10-91 — 'SimpleDesc/{conv{i}, fc1, fc2}'; conv/fc variables are
named weights/biases, common/tf_layer_utils.py:391-392).

No TensorFlow is needed: the porting boundary is a plain
``{tf_variable_name: np.ndarray}`` dict, produced offline in any TF1
environment:

    import tensorflow as tf, numpy as np
    ckpt = tf.train.latest_checkpoint(model_dir)
    reader = tf.train.NewCheckpointReader(ckpt)
    arrs = {n: reader.get_tensor(n) for n in
            reader.get_variable_to_shape_map()}
    np.savez("lfnet_tf1.npz", **arrs)

then ``port_lfnet_params(dict(np.load("lfnet_tf1.npz")), cfg)``.

TF conv kernels are HWIO and dense kernels (in, out), the Flax layout, so
the variables are first named as the JAX package's flat Flax parameters and
then carried over with `lfnet_state_dict_from_flax` (OIHW, [out, in], fc1's
rows reordered).  Batch-norm running statistics port into FrozenBN (use
FrontendConfig(norm="bn")).  Both TF1 BN variable stylings are handled:
tf.layers (gamma/beta/moving_mean/moving_variance) and the custom EMA path
(gamma/beta + moments/Squeeze{,_1}/ExponentialMovingAverage).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


class PortError(ValueError):
    pass


def _clean(name: str) -> str:
    """Strip ':0' suffixes and leading slashes from a TF variable name."""
    name = name.split(":")[0]
    return name.strip("/")


def _bn_tree(prefix: str, vars_: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Collect FrozenBN params {mean, var, scale, bias} under a TF BN scope."""
    out = {}
    styles = {
        "mean": [f"{prefix}/moving_mean", f"{prefix}/moments/Squeeze/ExponentialMovingAverage"],
        "var": [f"{prefix}/moving_variance", f"{prefix}/moments/Squeeze_1/ExponentialMovingAverage"],
        "scale": [f"{prefix}/gamma"],
        "bias": [f"{prefix}/beta"],
    }
    for ours, candidates in styles.items():
        for c in candidates:
            if c in vars_:
                out[ours] = np.asarray(vars_[c], np.float32)
                break
    if set(out) == {"scale", "bias"}:
        # affine-only BN (stats folded elsewhere / not exported): identity stats
        out["mean"] = np.zeros_like(out["bias"])
        out["var"] = np.ones_like(out["scale"])
    if set(out) != {"mean", "var", "scale", "bias"}:
        raise PortError(f"incomplete batch-norm scope '{prefix}': found {sorted(out)}")
    return out


def _conv_tree(prefix: str, vars_: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    w = vars_.get(f"{prefix}/weights")
    if w is None:
        raise PortError(f"missing conv/fc kernel '{prefix}/weights'")
    out = {"kernel": np.asarray(w, np.float32)}
    b = vars_.get(f"{prefix}/biases")
    if b is not None:
        out["bias"] = np.asarray(b, np.float32)
    return out


def port_lfnet_params(
    tf_vars: Mapping[str, np.ndarray],
    cfg,
    detector_scope: str = "ConvOnlyResNet",
    descriptor_scope: str = "SimpleDesc",
) -> dict:
    """The port's LFNet state dict from a TF1 LF-Net variable dict.

    cfg: FrontendConfig with norm="bn" (frozen running statistics).  The
    result loads with ``LFNet(cfg).load_state_dict(sd)``.  Raises PortError
    naming anything missing."""
    from bundletrack_tpu_torch.frontend.lfnet import lfnet_state_dict_from_flax

    if cfg.norm != "bn":
        raise PortError(
            'ported weights need FrontendConfig(norm="bn") — the reference '
            "network uses batch norm; GroupNorm params cannot hold its stats"
        )
    vars_ = {_clean(k): np.asarray(v) for k, v in tf_vars.items()}
    det, desc = detector_scope, descriptor_scope
    scopes: Dict[str, dict] = {"detector/init_conv": _conv_tree(f"{det}/init_conv", vars_)}
    for i in range(1, cfg.net_block + 1):
        blk = f"{det}/block-{i}"
        scopes[f"detector/block_{i}/pre_norm"] = _bn_tree(f"{blk}/pre-bn", vars_)
        scopes[f"detector/block_{i}/conv1"] = _conv_tree(f"{blk}/conv1", vars_)
        scopes[f"detector/block_{i}/mid_norm"] = _bn_tree(f"{blk}/mid-bn", vars_)
        scopes[f"detector/block_{i}/conv2"] = _conv_tree(f"{blk}/conv2", vars_)
    scopes["detector/final_norm"] = _bn_tree(f"{det}/fin-bn", vars_)
    for i in range(cfg.net_num_scales):
        scopes[f"detector/score_conv_{i}"] = _conv_tree(f"{det}/score_conv_{i}", vars_)
    scopes["detector/ori_conv"] = _conv_tree(f"{det}/ori_conv", vars_)
    for i in range(1, cfg.desc_net_depth + 1):
        scopes[f"descriptor/conv{i}"] = _conv_tree(f"{desc}/conv{i}", vars_)
        scopes[f"descriptor/norm{i}"] = _bn_tree(f"{desc}/conv{i}/bn", vars_)
    scopes["descriptor/fc1"] = _conv_tree(f"{desc}/fc1", vars_)
    scopes["descriptor/fc1_norm"] = _bn_tree(f"{desc}/fc1/bn", vars_)
    scopes["descriptor/fc2"] = _conv_tree(f"{desc}/fc2", vars_)
    flat = {f"{scope}/{leaf}": a for scope, leaves in scopes.items() for leaf, a in leaves.items()}
    return lfnet_state_dict_from_flax(flat)


def check_ported_params(sd: Mapping, cfg) -> None:
    """Check a ported state dict's names and shapes against LFNet(cfg).
    Raises PortError listing every missing, unexpected or misshapen entry."""
    from bundletrack_tpu_torch.frontend.lfnet import LFNet

    want = {k: tuple(v.shape) for k, v in LFNet(cfg).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    errors = [f"missing param {k}" for k in want if k not in got]
    errors += [f"shape mismatch {k}: got {got[k]}, want {s}" for k, s in want.items() if k in got and got[k] != s]
    errors += [f"unexpected param {k}" for k in got if k not in want]
    if errors:
        raise PortError("; ".join(errors))
