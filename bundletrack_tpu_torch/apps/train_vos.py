"""CLI app: train the VOS segmentation net (reference main.py).

Counterpart of bundletrack_tpu/apps/train_vos.py (reference:
transductive-vos.pytorch/main.py:57-135).  The same objective
(models/vos_train.py: cross-entropy over transductively propagated labels,
or with --rollout the inference recurrence) on rendered clips with mask
labels, Adam, and `.npz` checkpoints: `params/` (the state dict) and
`meta.json` in --ckpt-dir, which `apps/run_vos --checkpoint <dir>/params`
loads.  Runs on the card unless --device says otherwise.  Under torchrun,
--mesh "auto" (or a dp size equal to the world) trains data-parallel over
the ranks, the reference's DDP: each rank takes its block of every global
batch; rank 0 logs and writes the checkpoint.

Usage:
    python -m bundletrack_tpu_torch.apps.train_vos --steps 200 --size 96 \
        --batch 4 --clip-len 4 --ckpt-dir ckpt/vos [--rollout] \
        [--init-npz checkpoints/vos_params.npz --width 96] [--device cpu]
    torchrun --nproc-per-node 2 -m bundletrack_tpu_torch.apps.train_vos --mesh 2 ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_clips(size: int, batch: int, clip_len: int, num_seqs: int, seed: int, world: str,
                far_stride_max: int):
    """The pool of clip batches (numpy dicts with VOSTrainBatch's fields),
    the JAX trainer's pool draw for draw.

    Curriculum on the hard world: even entries are strided clips; odd
    entries are far pairs, one ground-truth reference 15..far_stride_max
    frames from the target (long-horizon inference keeps a pinned anchor
    ~100+ frames old).  World "mix": every 4th entry is an easy world, so
    hard-world training does not regress the clean regime; a third of the
    hard worlds get a sweeping occluder."""
    import numpy as np

    from bundletrack_tpu_torch.data import render_hard_sequence, render_synthetic_sequence
    from bundletrack_tpu_torch.data.pairs import vos_clip_batch

    pool = []
    rng_w = np.random.RandomState(seed + 7)
    shapes = ["cube", "cylinder", "lshape", "tshape"]
    for s in range(num_seqs):
        is_hard = world == "hard" or (world == "mix" and s % 4 != 3)
        far_pair = is_hard and s % 2 == 1
        if far_pair:
            lo, hi = 15, max(far_stride_max, 16)
            n_lv = 5
            T_s = 2
            stride = lo + ((hi - lo) * ((s // 2) % n_lv)) // (n_lv - 1)
        else:
            T_s, stride = clip_len, (1 + (s % 4) if is_hard else 1)
        if is_hard:
            seq = render_hard_sequence(
                shape=shapes[s % len(shapes)],
                num_frames=T_s * batch * stride, H=size, W=size,
                seed=seed + 31 * s,
                radius=0.45 + 0.15 * rng_w.rand(),
                orbit_deg_per_frame=2.0 + 3.0 * rng_w.rand(),
                roll_deg_per_frame=2.0 * rng_w.rand(),
                scale_to=[1.0, 1.25, 0.8][s % 3],
                depth_noise=0.0, depth_quant=0.0, hole_fraction=0.0,
                mask_errors=False, background=True,
                occluder=(s % 3 == 1),
            )
        else:
            seq = render_synthetic_sequence(
                num_frames=T_s * batch * stride, H=size, W=size,
                seed=seed + s, orbit_deg_per_frame=3.0 + 0.5 * (s % 5),
            )
        starts = [b * T_s * stride for b in range(batch)]
        pool.append(vos_clip_batch(seq, starts, T_s, stride=stride))
    return pool


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--size", type=int, default=96)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--clip-len", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--num-seqs", type=int, default=8)
    parser.add_argument("--width", type=int, default=32, help="VOSNet stem width (backbone capacity)")
    parser.add_argument("--rollout", action="store_true",
                        help="sequential rollout loss: refs carry the model's own predictions (inference-faithful)")
    parser.add_argument("--init-npz", default="", help="warm-start params from an npz checkpoint")
    parser.add_argument("--world", choices=["hard", "easy", "mix"], default="easy",
                        help="hard: multi-shape fBm-textured worlds with backgrounds and occluder clips "
                        "(data/hard_world.py); mix: 3 hard : 1 easy")
    parser.add_argument("--far-stride-max", type=int, default=35,
                        help="largest GT-ref-to-target gap in the far-pair curriculum")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--ckpt-every", type=int, default=100)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--mesh", default="auto",
                        help='over torchrun ranks: "auto", a dp size or "none"; one rank trains on one device')
    parser.add_argument("--device", default=None, help="torch device; the CUDA card when not given")
    args = parser.parse_args(argv)

    import torch

    from bundletrack_tpu_torch.apps.train_lfnet import save_checkpoint, training_mesh
    from bundletrack_tpu_torch.models import VOSTrainBatch, make_adam, make_vos_train_step
    from bundletrack_tpu_torch.models.vos import init_vos, load_vos_npz
    from bundletrack_tpu_torch.parallel.distributed import initialize_multihost, world_rank
    from bundletrack_tpu_torch.parallel.fleet import make_sharded_vos_train_step

    device = initialize_multihost(device=args.device)
    mesh = training_mesh(args.mesh, "train_vos", axes=("data",))
    leader = world_rank() == 0
    H = W = args.size
    model, _ = init_vos(width=args.width, seed=args.seed)
    if args.init_npz:
        model, _ = load_vos_npz(args.init_npz)
        if model.width != args.width:
            raise ValueError(f"--init-npz {args.init_npz} holds width {model.width}, not --width {args.width}")
        print(f"[train_vos] warm start from {args.init_npz}", file=sys.stderr)
    model.to(device)
    optimizer = make_adam(model.parameters(), args.lr)
    if mesh is None:
        step = make_vos_train_step(model, optimizer, (H, W), rollout=args.rollout)
    else:
        step = make_sharded_vos_train_step(model, optimizer, mesh, (H, W), rollout=args.rollout)

    print(f"[train_vos] rendering {args.num_seqs} {args.world} sequences...", file=sys.stderr)
    pool = build_clips(args.size, args.batch, args.clip_len, args.num_seqs, args.seed, args.world,
                       args.far_stride_max)
    pool = [VOSTrainBatch(torch.from_numpy(d["clips"]).to(device), torch.from_numpy(d["labels"]).to(device))
            for d in pool]

    def save(step_idx):
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, step_idx, model, None, {"width": args.width})

    t0 = time.perf_counter()
    metrics = {}
    for i in range(args.steps):
        metrics = step(pool[i % len(pool)])
        if leader and ((i + 1) % args.log_every == 0 or i + 1 == args.steps):
            m = {k: float(v) for k, v in metrics.items()}  # reads the device: at log steps only
            m.update(step=i + 1, sec=round(time.perf_counter() - t0, 2))
            print(json.dumps(m), flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save(i + 1)
    save(args.steps)
    return metrics


if __name__ == "__main__":
    main()
