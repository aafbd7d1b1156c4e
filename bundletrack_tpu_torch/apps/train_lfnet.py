"""CLI app: train the LF-Net keypoint frontend (reference train_lfnet.py).

Counterpart of bundletrack_tpu/apps/train_lfnet.py (reference:
lf-net-release/train_lfnet.py).  The same two objectives
(models/lfnet_train.py) on warp-annotated pairs from the rendered worlds,
with Adam and optax's cosine decay, `.npz` checkpoints and resume
(utils/checkpoint.py), and a JSON metrics line per log interval.  Runs on
the card unless --device says otherwise.

Over several ranks (one process per card, started by torchrun), --mesh
sets data x tensor parallelism as the JAX app reads it from the device
count: "auto" is (n/2, 2) for an even world of n ranks and (n, 1)
otherwise, "dp,tp" is explicit and must multiply to n; a world of one rank
trains on one device whatever --mesh says.  Every rank builds the same
pool of global batches from the seed and trains on its block of each;
rank 0 alone logs and writes checkpoints, which hold whole tensors in the
one-device layout.

Usage:
    python -m bundletrack_tpu_torch.apps.train_lfnet --steps 500 --size 96 \
        --batch 8 --ckpt-dir ckpt/lfnet [--resume] [--device cpu]
    torchrun --nproc-per-node 4 -m bundletrack_tpu_torch.apps.train_lfnet --mesh 2,2 ...

The checkpoint directory holds `params/` (the model's state dict),
`opt_state/` (Adam's state dict) and `meta.json` (the step and the flags);
`frontend/lfnet.save_params_npz` turns the weights into the npz both
packages load.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_batches(size: int, batch: int, num_seqs: int, seed: int, world: str = "hard", num_batches: int = 0):
    """Pre-render a pool of warp-annotated training batches (numpy dicts
    with LFNetTrainBatch's fields), the JAX trainer's pool draw for draw.

    Every row of a batch comes from a distinct world (rows sharing
    landmarks poison the InfoNCE negatives); rows are serving-faithful
    mask-ROI crops (data/pairs.lfnet_roi_pair_batch); "hard" worlds are
    fBm-textured cube / cylinder / L / T shapes with a random orbit, roll,
    scale change and photometric augmentation.  Pairs mix frame gaps 1-4."""
    import numpy as np

    from bundletrack_tpu_torch.data import render_hard_sequence, render_synthetic_sequence
    from bundletrack_tpu_torch.data.pairs import lfnet_roi_pair_batch

    rng = np.random.RandomState(seed)
    num_worlds = max(num_seqs, batch)
    n_frames = 8
    render_hw = int(size * 1.6)
    shapes = ["cube", "cylinder", "lshape", "tshape"]
    worlds = []
    for s in range(num_worlds):
        if world == "easy":
            worlds.append(render_synthetic_sequence(
                num_frames=n_frames, H=render_hw, W=render_hw, seed=seed + s,
                orbit_deg_per_frame=3.0 + 0.5 * (s % 5),
            ))
        else:
            worlds.append(render_hard_sequence(
                shape=shapes[s % len(shapes)], num_frames=n_frames,
                H=render_hw, W=render_hw,
                radius=0.42 + 0.12 * rng.rand(),
                orbit_deg_per_frame=2.0 + 4.0 * rng.rand(),
                roll_deg_per_frame=3.0 * rng.rand(),
                scale_to=[1.0, 1.3, 0.75][s % 3],
                elev_amp=0.25 * rng.rand(),
                seed=seed + 31 * s,
                depth_noise=0.0, depth_quant=0.0, hole_fraction=0.0,
                mask_errors=False, background=True,
            ))

    gaps = [1, 1, 2, 3, 4]
    pool = []
    for _ in range(num_batches or max(24, 2 * num_worlds)):
        row_worlds = rng.permutation(num_worlds)[:batch]  # distinct per batch
        rows = []
        for w in row_worlds:
            gap = gaps[rng.randint(len(gaps))]
            i = rng.randint(n_frames - gap)
            rows.append(lfnet_roi_pair_batch(worlds[w], [(i, i + gap)], size, rng=rng, photometric=True))
        pool.append({k: np.concatenate([r[k] for r in rows], axis=0) for k in rows[0]})
    return pool


def training_mesh(mesh: str, tool: str, axes=("data", "model")):
    """A trainer's mesh over the world's ranks (the process group
    initialize_multihost joined under torchrun), or None for one rank,
    which trains on one device whatever --mesh says.  Over several ranks,
    --mesh "none" raises (each rank would train alone), and a mesh whose
    size is not the world's raises ValueError."""
    from bundletrack_tpu_torch.parallel.distributed import make_mesh, world_size

    n = world_size()
    if n == 1:
        return None
    if mesh == "none":
        raise ValueError(f"{tool} --mesh none trains on one device: run it as one process, not {n} ranks")
    if mesh == "auto" and len(axes) == 1:
        sizes = (n,)
    elif mesh == "auto":  # the JAX app's (dp, tp) for n devices
        sizes = (n // 2, 2) if n % 2 == 0 else (n, 1)
    else:
        sizes = tuple(int(x) for x in mesh.split(","))
    if len(sizes) != len(axes):
        raise ValueError(f"{tool} --mesh {mesh}: expected {len(axes)} size(s) for {axes}")
    print(f"[{tool}] mesh " + " ".join(f"{a}={s}" for a, s in zip(axes, sizes)), file=sys.stderr)
    return make_mesh(dict(zip(axes, sizes)))


def save_checkpoint(ckpt_dir: str, step: int, model, optimizer, meta: dict) -> None:
    """params/, opt_state/ (when `optimizer` is given) and meta.json in
    ckpt_dir, every tensor whole (a tensor-parallel model's shards are
    gathered: every rank calls this, rank 0 writes)."""
    from bundletrack_tpu_torch.parallel.distributed import world_rank
    from bundletrack_tpu_torch.parallel.fleet import unsharded_state_dicts
    from bundletrack_tpu_torch.utils.checkpoint import save_tracker_state

    params, opt_state = unsharded_state_dicts(model, optimizer)
    if world_rank() != 0:
        return
    save_tracker_state(os.path.join(ckpt_dir, "params"), params)
    if optimizer is not None:
        save_tracker_state(os.path.join(ckpt_dir, "opt_state"), opt_state)
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump({"step": step, **meta}, f)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--size", type=int, default=96, help="square image size")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--lr-decay", choices=["none", "cosine"], default="cosine",
                        help="cosine-decay the lr to lr/10 over --steps")
    parser.add_argument("--top-k", type=int, default=128)
    parser.add_argument("--desc-dim", type=int, default=256)
    parser.add_argument("--net-channel", type=int, default=16)
    parser.add_argument("--num-scales", type=int, default=5)
    parser.add_argument("--desc-channel", type=int, default=64)
    parser.add_argument("--sm-ksize", type=int, default=15)
    parser.add_argument("--num-seqs", type=int, default=8, help="worlds in the render pool (min = --batch)")
    parser.add_argument("--world", choices=["hard", "easy"], default="hard")
    parser.add_argument("--num-batches", type=int, default=0, help="pre-built batches to cycle (0 = auto)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--ckpt-every", type=int, default=100)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--mesh", default="auto",
                        help='over torchrun ranks: "auto", "dp,tp" or "none"; one rank trains on one device')
    parser.add_argument("--device", default=None, help="torch device; the CUDA card when not given")
    args = parser.parse_args(argv)

    import torch

    from bundletrack_tpu_torch.config import FrontendConfig
    from bundletrack_tpu_torch.frontend.lfnet import init_lfnet
    from bundletrack_tpu_torch.models import LFNetTrainBatch, cosine_schedule, make_adam, make_lfnet_train_step
    from bundletrack_tpu_torch.parallel.distributed import initialize_multihost, world_rank
    from bundletrack_tpu_torch.parallel.fleet import make_sharded_lfnet_train_step
    from bundletrack_tpu_torch.utils.checkpoint import restore_tracker_state

    device = initialize_multihost(device=args.device)
    mesh = training_mesh(args.mesh, "train_lfnet")
    leader = world_rank() == 0
    cfg = FrontendConfig(
        kind="lfnet", input_size=args.size, top_k=args.top_k,
        desc_dim=args.desc_dim, net_channel=args.net_channel,
        net_num_scales=args.num_scales, desc_net_channel=args.desc_channel,
        sm_ksize=args.sm_ksize,
        bf16=False,  # full-precision gradients for training
    )
    model, _ = init_lfnet(cfg, seed=args.seed)
    model.to(device)

    start_step = 0
    meta_path = os.path.join(args.ckpt_dir, "meta.json")
    if args.ckpt_dir and args.resume and os.path.exists(meta_path):
        with open(meta_path) as f:
            start_step = json.load(f)["step"]
    optimizer = make_adam(model.parameters(), args.lr)
    if start_step:
        model.load_state_dict(restore_tracker_state(os.path.join(args.ckpt_dir, "params"), model.state_dict()))
        optimizer.load_state_dict(
            restore_tracker_state(os.path.join(args.ckpt_dir, "opt_state"), optimizer.state_dict()))
        print(f"[train_lfnet] resumed at step {start_step}", file=sys.stderr)
    # optax's schedule reads the restored count: step i takes the rate at i
    scheduler = cosine_schedule(optimizer, max(args.steps, 1), start_step) if args.lr_decay == "cosine" else None
    if mesh is None:
        step = make_lfnet_train_step(model, optimizer, scheduler)
    else:
        step = make_sharded_lfnet_train_step(model, optimizer, mesh, scheduler=scheduler)

    print(f"[train_lfnet] rendering {max(args.num_seqs, args.batch)} {args.world} worlds...", file=sys.stderr)
    pool = build_batches(args.size, args.batch, args.num_seqs, args.seed,
                         world=args.world, num_batches=args.num_batches)
    # the pool goes to the device once: no upload (and no sync) per step
    pool = [LFNetTrainBatch(*(torch.from_numpy(d[k]).to(device) for k in LFNetTrainBatch._fields)) for d in pool]

    def save(step_idx):
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, step_idx, model, optimizer, {"config": vars(args)})

    t0 = time.perf_counter()
    metrics = {}
    for i in range(start_step, args.steps):
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
