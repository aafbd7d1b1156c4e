"""Where a VOS frame's time goes, on the card.

    python3 -m bundletrack_tpu_torch.vos_bench

Propagates frame 0's mask through FRAMES rendered 480x640 frames with the
shipped width-96 weights (checkpoints/vos_params.npz) and the default
SegmentationConfig (ref_num 9, history 48, sigma 8/21, T 0.05, a 60x80
feature grid), and reports after warm-up:

- the time of one `propagate` (CUDA events, median), and from
  torch.profiler over three frames: device time and launches per frame,
  the ten largest kernels, and the device's busy share;
- the stage split, each stage timed alone with CUDA events on the same
  inputs: the VOSNet forward, the bf16 similarity, softmax and prior, the
  label product, and the upsample to the image with its argmax;
- the peak device memory of a frame;
- the bound: convolution products counted from the shapes the forward runs
  at (f32: TF32 is off in the port), the similarity's bf16 products, the
  rest's f32 products, and the least bytes (image, weights, the chosen
  references, both priors, the outputs), each over the card's published
  peak; the bound is the largest term.

`chip_smoke.py` runs `vos_report` on its 480x640 frames.  Needs a CUDA device.
"""

from __future__ import annotations

import collections
import json
import time

import numpy as np
import torch

from bundletrack_tpu_torch.apps.run_vos import VOS_CKPT
from bundletrack_tpu_torch.cardrun import TIMED_RUNS, card_line, cuda_median_ms, render_main_sequence
from bundletrack_tpu_torch.config import SegmentationConfig
from bundletrack_tpu_torch.eval.vos_eval import rgb_of
from bundletrack_tpu_torch.models import vos
from bundletrack_tpu_torch.ops.resize import resize_bilinear
from bundletrack_tpu_torch.utils.flax_layers import Conv

# Published peaks of one H100 SXM (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores (TF32 is off in the port)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

FRAMES = 12  # frame 0 seeds; 3 warm-up, 5 timed, 3 profiled


def vos_cost(prop: vos.VOSPropagator, rgb) -> dict:
    """Products and least bytes of one propagated frame, from the shapes it
    runs at (2 FLOP per multiply-add)."""
    conv_flops = 0

    def count(mod, inp, out):
        nonlocal conv_flops
        conv_flops += 2 * out.numel() * mod.weight[0].numel()  # cin * k * k per output

    hooks = [m.register_forward_hook(count) for m in prop.model.modules() if isinstance(m, Conv)]
    try:
        feat = prop.extract_feat(rgb)
    finally:
        for h in hooks:
            h.remove()
    C, h, w = feat.shape
    N, R, L = h * w, prop.cfg.ref_num, prop.num_labels
    sim_flops = 2 * N * R * N * C
    rest_flops = 2 * N * R * N * L + 2 * L * (prop.H * h * w + prop.H * w * prop.W)  # label product, upsample
    f4 = 4
    weights = sum(p.numel() * p.element_size() for p in prop.model.parameters())
    nbytes = (prop.H * prop.W * 3 * f4 + weights  # image, weights
              + R * (C + L) * N * f4 + 2 * N * N * f4  # the references read, both priors
              + prop.H * prop.W + L * N * f4 + C * N * f4)  # mask, soft labels, features written to the ring
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "f32 products": (conv_flops + rest_flops) / F32_FLOP_PER_S * 1e3,
        "bf16 products": sim_flops / BF16_FLOP_PER_S * 1e3,
    }
    by = max(terms, key=terms.get)
    return {"conv_flops": conv_flops, "similarity_flops": sim_flops, "other_flops": rest_flops, "bytes": nbytes,
            "bound_terms_ms": terms, "bound_ms": terms[by], "bound_by": by}


def stage_split(prop: vos.VOSPropagator, rgb) -> dict:
    """Each stage of a frame alone, CUDA events, median of TIMED_RUNS, on the
    inputs the frame gives it (the history is not advanced)."""
    cfg = prop.cfg
    with torch.no_grad():
        feat = prop.extract_feat(rgb)
        slots, valid, is_recent = vos.select_references(prop.state, cfg.ref_num, dense_num=4, range_=cfg.range_)
        refs = prop.state.feats.index_select(0, slots)
        labels = prop.state.labels.index_select(0, slots)
        sim = vos.similarity(refs, feat)
        att = vos.attention(sim.clone(), valid, is_recent, prop.w1, prop.w2, prop.temperature)
        soft = vos.label_product(att, labels)
        return {
            "forward": cuda_median_ms(lambda: prop.extract_feat(rgb)),
            "similarity": cuda_median_ms(lambda: vos.similarity(refs, feat)),
            "softmax_and_prior": cuda_median_ms(
                lambda: vos.attention(sim.clone(), valid, is_recent, prop.w1, prop.w2, prop.temperature)),
            "similarity_copy": cuda_median_ms(lambda: sim.clone()),  # inside softmax_and_prior; subtract it
            "label_product": cuda_median_ms(lambda: vos.label_product(att, labels)),
            "upsample_argmax": cuda_median_ms(
                lambda: torch.argmax(resize_bilinear(soft, (prop.H, prop.W)), dim=0) > 0),
        }


def vos_report(seq, card: str) -> dict:
    """Propagates seq (at least 8 frames) from frame 0 on the card; prints
    and returns the numbers of the module docstring.  The last three frames
    run under the profiler."""
    model, _ = vos.load_vos_npz(VOS_CKPT)
    prop = vos.VOSPropagator(model, SegmentationConfig(), seq.gray.shape[1], seq.gray.shape[2], device="cuda")
    prop.first_frame(rgb_of(seq, 0), seq.mask[0])
    F = len(seq.gray)
    frames = list(range(1, F))
    warm, timed, profiled = frames[:3], frames[3:-3], frames[-3:]
    for f in warm:
        prop.propagate(rgb_of(seq, f))
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for f in timed:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        prop.propagate(rgb_of(seq, f))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in profiled:
            prop.propagate(rgb_of(seq, f))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / len(profiled)
    device_ms = sum(by_name.values())
    stages = stage_split(prop, rgb_of(seq, F - 1))
    cost = vos_cost(prop, rgb_of(seq, F - 1))
    step = float(np.median(step_ms))
    print(f"vos: propagate at {prop.H}x{prop.W} (grid {prop.h}x{prop.w}, ref_num {prop.cfg.ref_num}, history "
          f"{prop.state.feats.shape[0]}): median {step:.3f} ms over {len(step_ms)} frames (CUDA events, "
          f"mask to the host included); profiler {len(kernels) / len(profiled):.0f} launches, "
          f"{device_ms:.3f} ms device time per frame, busy {100 * device_ms * len(profiled) / wall_ms:.1f} %; "
          f"peak memory {peak / 2**20:.1f} MiB [{card}]")
    for name, t in by_name.most_common(10):
        print(f"  {t:9.4f} ms/frame  {name[:100]}")
    print("vos stages alone (CUDA events, median of %d): " % TIMED_RUNS
          + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items()))
    print(f"vos bound: convs {cost['conv_flops'] / 1e9:.2f} GFLOP f32, similarity "
          f"{cost['similarity_flops'] / 1e9:.2f} GFLOP bf16, rest {cost['other_flops'] / 1e9:.3f} GFLOP f32, "
          f"least bytes {cost['bytes'] / 1e6:.1f} MB -> {cost['bound_ms']:.4f} ms ({cost['bound_by']}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in cost["bound_terms_ms"].items())
          + f"); {100 * cost['bound_ms'] / device_ms:.1f} % of device time")
    return {"propagate_ms_median": step, "device_ms_per_frame": device_ms,
            "launches_per_frame": len(kernels) / len(profiled), "busy_share": device_ms * len(profiled) / wall_ms,
            "peak_memory_bytes": peak, "top_kernels_ms_per_frame": dict(by_name.most_common(10)),
            "stages_ms": stages, **cost}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("vos_bench: no CUDA device is available")
    card = card_line()
    print(f"card: {card}")
    report = vos_report(render_main_sequence(FRAMES), card)
    print(json.dumps({"card": card, "vos": report}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
