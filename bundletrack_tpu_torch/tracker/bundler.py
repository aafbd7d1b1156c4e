"""The per-frame tracking step, over a leading stream axis.

Counterpart of bundletrack_tpu/tracker/bundler.py::make_track_frame and of
its vmap in parallel/fleet.py (reference: Bundler::processNewFrame and
optimizeGPU, src/Bundler.cpp):

  preprocess depth -> features -> neighbour match + RANSAC -> Procrustes
  pose init -> greedy_rot BA subset -> all-pairs matching (fused CUDA
  kernel) + landmark propagation + RANSAC on every pair -> robust GN
  pose-graph solve -> keyframe admission -> outputs.

One implementation serves one stream and a fleet: `make_batched_track_frame`
steps S streams whose every tensor carries a leading stream axis, and
`make_track_frame` is its S = 1 view.  The JAX step is one traced program
whose branches are lax.cond / jnp.where, and selects under vmap.  Here:

- each stream's first frame is a host `if` on its host frame count, so
  it costs no read.  When some streams start (count 0) while the others
  run, the frame is split: the running streams are tracked as a fleet of
  their own (one matcher launch on their S_run * P pairs, the two reads
  below on their values only), the new streams start as a fleet of their
  own, and both are written back into the whole state in stream order;
- the BA solve runs for all streams when any stream needs it (one read of
  any/all), and each stream keeps its solved poses only if it needed the
  solve, as lax.cond under vmap does;
- keyframe admission builds the admitted state for all streams when any
  stream admits (one read of any/all) and selects it per stream; the
  previous-frame update is a per-stream select.

So a tracked frame makes 2 device-to-host reads whatever S is (plus one per
GN iteration with early stopping), each through utils/profiling.read,
which counts it; the first frame makes none.  The host waits for the card
twice more per tracked frame, inside torch: torch.linalg.svd in the
neighbour refit (geometry/procrustes.kabsch) reads its error flags.  The
BA matcher runs once per frame for all S*P pairs.

With `mesh` and `pair_axis` the BA pair work is sharded over that mesh
axis's process group (the JAX step's shard_map over the pair axis): each
rank matches, propagates, RANSACs and linearizes its contiguous block of
the P pairs (phases drawn for all P first, then cut), the new frame's edge
count is summed over the group, H and g are summed once per GN iteration,
and the matches and verified edges are all-gathered back to [S, P, M] in
pair order for the landmark update.  Every branch the host takes must be
the same on every rank or a collective would wait forever, so each reads a
value that came through a collective: `fail` and `admit` are group rank
0's (broadcast), the solve's run flags read the summed edge count, the
early stop the max of every rank's flag.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from bundletrack_tpu_torch.config import TrackerConfig
from bundletrack_tpu_torch.frontend.pipeline import FrameFeatures, extract_frame_features
from bundletrack_tpu_torch.geometry.camera import scale_intrinsics
from bundletrack_tpu_torch.geometry.se3 import se3_compose, se3_inverse
from bundletrack_tpu_torch.matching.mappoints import (
    MapPointTable,
    forget_frame,
    propagate_matches,
    update_mappoints,
)
from bundletrack_tpu_torch.matching.pairwise import (
    MatchResult,
    match_pair,
    match_pairs_batched,
    merge_matches,
)
from bundletrack_tpu_torch.ops.collectives import all_gather_cat, all_reduce, broadcast_from_first
from bundletrack_tpu_torch.ops.depth import process_depth
from bundletrack_tpu_torch.ops.masks import preprocess_mask
from bundletrack_tpu_torch.ops.pointcloud import depth_to_cloud_and_normals
from bundletrack_tpu_torch.ransac.ransac import (
    draw_phases,
    ransac_pair,
    refine_pose_on_inliers,
)
from bundletrack_tpu_torch.solver.dense_p2p import FrameDense, compact_frame, stack_frame_dense
from bundletrack_tpu_torch.solver.gauss_newton import GraphInputs, optimize_pose_graph_verified
from bundletrack_tpu_torch.solver.residuals import SparseCorres
from bundletrack_tpu_torch.tracker.selection import (
    eviction_slot,
    keyframe_admission,
    select_ba_subset,
)
from bundletrack_tpu_torch.tracker.state import (
    STATUS_FAIL,
    STATUS_NO_BA,
    STATUS_OK,
    FrameObservation,
    TrackerState,
    TrackOutput,
    _put_streams,
    _stream_rows,
    _take_streams,
    add_stream_axis,
    drop_stream_axis,
)
from bundletrack_tpu_torch.utils.profiling import annotate, count, read


def _normalize_obs(obs: FrameObservation) -> FrameObservation:
    """Raw sensor types become floats on the device: uint8 gray / 255, and
    integer millimeter depth * 1e-3.  Torch has few operations on uint16, so
    the driver uploads 16-bit depth widened to int32."""
    gray = obs.gray
    if gray.dtype == torch.uint8:
        gray = gray.to(torch.float32) * (1.0 / 255.0)
    depth = obs.depth
    if not depth.is_floating_point():
        depth = depth.to(torch.float32) * 1e-3
    return obs._replace(
        gray=gray.to(torch.float32),
        depth=depth.to(torch.float32),
        mask=obs.mask.to(torch.bool),
    )


def _preprocess(obs: FrameObservation, cfg: TrackerConfig):
    """Depth chain + cloud/normals + the frame's compacted dense tables
    (images [..., H, W])."""
    depth = process_depth(obs.depth, cfg.depth_processing)
    pts_map, nrm_map, val_map = depth_to_cloud_and_normals(depth, obs.K)
    seg_mask = preprocess_mask(obs.mask, cfg.segmentation)
    mask = seg_mask & (depth > 0.1)
    val_map = val_map & seg_mask
    ds = cfg.bundle.image_downscale
    fd = compact_frame(
        pts_map[..., ::ds, ::ds, :], nrm_map[..., ::ds, ::ds, :], val_map[..., ::ds, ::ds],
        cfg.bundle.dense_src_capacity,
    )
    K_low = scale_intrinsics(obs.K, 1.0 / ds)
    return mask, pts_map, nrm_map, val_map, fd, K_low


def _take_rows(table, idx):
    """table [S, X, ...] at idx [S, ...] (indices into X) -> [S, ..., ...]."""
    S = table.shape[0]
    rows = torch.arange(S, device=idx.device).reshape(S, *([1] * (idx.dim() - 1)))
    return table[rows, idx]


def _gather_match_points(ba_pts, ba_normals, pair_i, pair_j, matches: MatchResult):
    """[S,K,N,3] tables + [S,P,M] match indices -> per-pair matched points
    [S,P,M,3] (pair_i/pair_j [P] shared by the streams)."""
    S, K, N, _ = ba_pts.shape

    def g(table, frame, idx):
        lin = (frame[:, None] * N + idx).reshape(S, -1)
        return _take_rows(table.reshape(S, K * N, 3), lin).reshape(*idx.shape, 3)

    return (
        g(ba_pts, pair_i, matches.idx_a), g(ba_pts, pair_j, matches.idx_b),
        g(ba_normals, pair_i, matches.idx_a), g(ba_normals, pair_j, matches.idx_b),
    )


def _stream_select(flag, a, b):
    """Per-stream select: a where flag[s], else b (flag [S], a/b [S, ...])."""
    return torch.where(flag.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def _select(trees, rows):
    """Streams `rows` of each tensor, or of each NamedTuple of tensors."""
    pick = lambda t: t.index_select(0, rows)  # noqa: E731
    return tuple(pick(t) if isinstance(t, torch.Tensor) else type(t)(*map(pick, t)) for t in trees)


def _counts_on(counts, dev) -> torch.Tensor:
    """The streams' host frame counts as [S] int32 on the device: a fill
    when they are equal, else a copy that the device does not wait for."""
    if len(set(counts)) == 1:
        return torch.full((len(counts),), counts[0], dtype=torch.int32, device=dev)
    return torch.as_tensor(counts, dtype=torch.int32).to(dev, non_blocking=True)


def _admit_keyframe(state: TrackerState, feats: FrameFeatures, pose, fd: FrameDense,
                    frame_id, slot, admit=None) -> TrackerState:
    """Write each stream's frame into its pool slot `slot[s]` (flat index
    s*Kp + slot[s]) and forget the slot's old landmark observations.  With
    `admit` [S], a stream that does not admit writes its slot's old contents
    back; its landmark table is the caller's to select."""
    S, Kp = state.kf_frame_id.shape
    index = torch.arange(S, device=slot.device) * Kp + slot

    def put(pool, value):
        flat = pool.reshape(S * Kp, *pool.shape[2:])
        value = value.to(pool.dtype)
        if admit is not None:
            value = _stream_select(admit, value, flat.index_select(0, index))
        return flat.index_copy(0, index, value).reshape(pool.shape)

    return state._replace(
        kf_desc=put(state.kf_desc, feats.desc),
        kf_pts=put(state.kf_pts, feats.pts),
        kf_normals=put(state.kf_normals, feats.normals),
        kf_kp_valid=put(state.kf_kp_valid, feats.valid),
        kf_pose=put(state.kf_pose, pose),
        kf_dsrc=put(state.kf_dsrc, fd.src),
        kf_dvalid=put(state.kf_dvalid, fd.valid),
        kf_dlin=put(state.kf_dlin, fd.lin),
        kf_tchan=put(state.kf_tchan, fd.tchan),
        kf_frame_id=put(state.kf_frame_id, frame_id),
        mappoints=forget_frame(state.mappoints, slot),
    )


def _set_prev(state: TrackerState, feats: FrameFeatures, pose, keep=None) -> TrackerState:
    """The frame becomes each stream's neighbour-matching target; with
    `keep` [S], only where keep[s]."""
    new = dict(prev_desc=feats.desc, prev_pts=feats.pts, prev_normals=feats.normals,
               prev_kp_valid=feats.valid, prev_pose=pose)
    if keep is None:
        return state._replace(**new, prev_valid=torch.ones_like(state.prev_valid))
    return state._replace(
        **{k: _stream_select(keep, v, getattr(state, k)) for k, v in new.items()},
        prev_valid=state.prev_valid | keep,
    )


def make_track_frame(cfg: TrackerConfig, H: int, W: int, lfnet_apply=None, mesh=None,
                     pair_axis: Optional[str] = None):
    """Build the single-stream step for images of size H x W: the S = 1
    view of `make_batched_track_frame` (`mesh`, `pair_axis` as there).

    step(state, obs, init_pose, phases=None) -> (state, TrackOutput).
    `phases` = (neighbour [3, n_rep], pairs [P, 3, n_rep]) RANSAC phases;
    when None they are drawn from `state.rng`.  `lfnet_apply` is the LF-Net
    frontend (frontend/lfnet.make_lfnet_apply), needed when
    cfg.frontend.kind is "lfnet"; it takes the streams' masked crops as
    one [S, side, side, 1] stack, and its descriptors are
    cfg.frontend.desc_dim wide.
    """
    batched = make_batched_track_frame(cfg, H, W, lfnet_apply, mesh, pair_axis)

    def step(state: TrackerState, obs: FrameObservation, init_pose: torch.Tensor,
             phases: Optional[tuple] = None):
        if phases is not None:
            phases = tuple(p[None] for p in phases)
        st, out = batched(add_stream_axis(state), FrameObservation(*(t[None] for t in obs)),
                          init_pose[None], phases)
        return drop_stream_axis(st), TrackOutput(*(t[0] for t in out))

    return step


def make_batched_track_frame(cfg: TrackerConfig, H: int, W: int, lfnet_apply=None, mesh=None,
                             pair_axis: Optional[str] = None):
    """Build the step over S streams for images of size H x W.

    step(state, obs, init_pose, phases=None) -> (state, TrackOutput), with a
    leading stream axis on every tensor of the state (parallel/fleet.py),
    of obs ([S, H, W] images, [S, 3, 3] intrinsics), of init_pose
    [S, 4, 4] and of the outputs.  `phases` = (neighbour [S, 3, n_rep],
    pairs [S, P, 3, n_rep]); when None, each stream draws its own from its
    generator state.rng[s], in the order one stream draws them.

    `mesh` (a DeviceMesh) with `pair_axis` naming one of its axes shards the
    BA pairs over that axis (module docstring); every rank passes the same
    state, observations and phases, and gets the same results.  P must
    divide by the axis size (ValueError).
    """
    if cfg.frontend.kind == "classical" and cfg.frontend.desc_dim != 256:
        raise ValueError("the classical frontend makes 256-d descriptors (16x16 patches)")
    K_BA = cfg.bundle.max_ba_frames
    n_pool_sel = K_BA - 1
    new_idx = K_BA - 1
    pair_i_np, pair_j_np = np.triu_indices(K_BA, k=1)
    P_PAIRS = len(pair_i_np)
    M = cfg.shapes.max_matches
    fc = cfg.feature_corres
    rc = cfg.ransac
    ransac_kw = dict(
        num_trials=rc.max_iter,
        inlier_dist=rc.inlier_dist,
        inlier_normal_deg=rc.inlier_normal_angle,
        min_matches=rc.min_match_after_ransac,
    )
    # pairs whose later frame is the new one: their verified edges feed the landmarks
    new_pairs = [p for p in range(P_PAIRS) if pair_j_np[p] == K_BA - 1]
    group = None
    lo, hi = 0, P_PAIRS  # this rank's block of the pairs
    if mesh is not None and pair_axis is not None:
        n_shard = mesh.size(mesh.mesh_dim_names.index(pair_axis))
        if P_PAIRS % n_shard:
            raise ValueError(f"P={P_PAIRS} BA pairs (max_ba_frames={K_BA}) must divide "
                             f"mesh axis {pair_axis!r}={n_shard}")
        group = mesh.get_group(pair_axis)
        lo = mesh.get_local_rank(pair_axis) * (P_PAIRS // n_shard)
        hi = lo + P_PAIRS // n_shard
    P_LOCAL = hi - lo

    @functools.lru_cache(maxsize=None)
    def pairs_on(dev, S):
        """(pair_i, pair_j) [P] int64 for torch indexing, and the S*P pairs
        of the fleet's flattened [S*K] table, s*K + i, as int32 for the
        matcher kernel; uploaded once: an int32 index costs torch a cast
        launch at every use, and the kernel takes int32.  Sharded: this
        rank's block of the pairs only."""
        local = (pair_i_np[lo:hi], pair_j_np[lo:hi])
        flat = [(np.arange(S)[:, None] * K_BA + a[None]).reshape(-1) for a in local]
        return (
            *(torch.as_tensor(a.astype(np.int64), device=dev) for a in local),
            *(torch.as_tensor(a.astype(np.int32), device=dev) for a in flat),
        )

    def ba_pair_section(ba_desc, ba_pts, ba_nrm, ba_kpv, ba_pose, ba_valid,
                        mappoints, pool_slot_of, pairs, phases_pairs):
        """Match -> propagate -> RANSAC over the BA pairs of every stream."""
        pair_i, pair_j, flat_i32, flat_j32 = pairs
        S = ba_desc.shape[0]
        pair_valid = ba_valid[:, pair_i] & ba_valid[:, pair_j]  # [S, P]
        bm = match_pairs_batched(
            ba_desc, ba_pts, ba_nrm, ba_kpv, ba_pose, flat_i32, flat_j32, pair_valid.reshape(-1),
            max_dist=fc.max_dist_no_neighbor,
            max_normal_deg=fc.max_normal_no_neighbor,
            max_matches=M,
        )
        bm = MatchResult(*(t.reshape(S, P_LOCAL, M) for t in bm))
        if fc.map_points:
            # seed BA pairs with landmark-propagated matches (reference
            # findCorresByMapPoints); RANSAC filters the union
            si, sj = pool_slot_of[:, pair_i], pool_slot_of[:, pair_j]
            prop_ok = (si >= 0) & (sj >= 0) & pair_valid
            prop = propagate_matches(mappoints, si.clamp(min=0), sj.clamp(min=0), M)
            prop = prop._replace(valid=prop.valid & prop_ok[..., None])
            bm = merge_matches(bm, prop, ba_desc.shape[-2], M)
            bm = bm._replace(valid=bm.valid & pair_valid[..., None])
        mpa, mpb, mna, mnb = _gather_match_points(ba_pts, ba_nrm, pair_i, pair_j, bm)
        prior = se3_compose(se3_inverse(ba_pose[:, pair_j]), ba_pose[:, pair_i])
        mr = ransac_pair(
            mpa, mpb, mna, mnb, bm.valid, prior,
            phases=phases_pairs,
            max_trans=rc.max_trans_no_neighbor,
            max_rot_deg=rc.max_rot_no_neighbor,
            **ransac_kw,
        )
        edge_valid = bm.valid & mr.inliers
        touches_new = (pair_i == new_idx) | (pair_j == new_idx)
        n_edges_new = all_reduce(torch.sum(edge_valid & touches_new[:, None], dim=(-2, -1)), group)
        return bm, mpa, mpb, edge_valid, n_edges_new

    def first_frame(state, feats, fd, init_pose):
        S = init_pose.shape[0]
        dev = init_pose.device
        i32 = dict(dtype=torch.int32, device=dev)
        st = _admit_keyframe(
            state, feats, init_pose, fd,
            frame_id=torch.zeros((S,), **i32),
            slot=eviction_slot(state.kf_frame_id, state.kf_pose),
        )
        st = _set_prev(st, feats, init_pose)
        st = st._replace(
            frame_count=(1,) * S,
            last_status=torch.full((S,), STATUS_OK, **i32),
            prev_delta=torch.eye(4, dtype=init_pose.dtype, device=dev).expand(S, 4, 4).clone(),
            pred_pose=init_pose,
        )
        out = TrackOutput(
            ob_in_cam=se3_inverse(init_pose),
            pose_in_model=init_pose,
            status=torch.full((S,), STATUS_OK, **i32),
            num_matches=torch.zeros((S,), **i32),
            num_ba_edges=torch.zeros((S,), **i32),
        )
        return st, out

    def step(state: TrackerState, obs: FrameObservation, init_pose: torch.Tensor,
             phases: Optional[tuple] = None):
        with annotate("bundletrack.step"):
            count("frames")
            S = state.kf_frame_id.shape[0]
            with annotate("bundletrack.preprocess"):
                obs = _normalize_obs(obs)  # the last reference to the raw upload: freed here
                mask, pts_map, nrm_map, val_map, fd, K_low = _preprocess(obs, cfg)
            with annotate("bundletrack.frontend"):
                feats = extract_frame_features(obs.gray, mask, pts_map, nrm_map, val_map, cfg.frontend,
                                               lfnet_apply)
            n_feat = torch.sum(feats.valid, dim=-1)
            roi_ok = torch.sum(mask, dim=(-2, -1)) > 100  # the reference FAILs on a tiny ROI
            per_stream = (feats, fd, K_low, n_feat, roi_ok)

            new = [s for s, c in enumerate(state.frame_count) if c == 0]  # host ints: no read
            if len(new) == S:
                return first_frame(state, feats, fd, init_pose)
            if not new:
                return track(state, *per_stream, phases)
            # a mixed frame: the running and the new streams each stepped as a
            # fleet of their own, then written back in stream order
            run = [s for s in range(S) if s not in new]
            run_rows, new_rows = _stream_rows(run, init_pose.device), _stream_rows(new, init_pose.device)
            if phases is not None:
                phases = tuple(p.index_select(0, run_rows.to(p.device)) for p in phases)
            st_run, out_run = track(_take_streams(state, run), *_select(per_stream, run_rows), phases)
            st_new, out_new = first_frame(_take_streams(state, new), *_select((feats, fd, init_pose), new_rows))
            st = _put_streams(_put_streams(state, run, st_run), new, st_new)
            out = TrackOutput(*(a.new_empty((S, *a.shape[1:])).index_copy_(0, run_rows, a)
                                .index_copy_(0, new_rows, b) for a, b in zip(out_run, out_new)))
            return st, out

    def track(state, feats, fd, K_low, n_feat, roi_ok, phases):
        """A frame of streams that have all started."""
        dev = state.kf_pose.device
        S, Kp = state.kf_frame_id.shape
        if phases is None:
            drawn = [(draw_phases((), rc.max_iter, M, g), draw_phases((P_PAIRS,), rc.max_iter, M, g))
                     for g in state.rng]
            phases = tuple(torch.stack(p) for p in zip(*drawn))
        phases_nb, phases_pairs = phases[0], phases[1][:, lo:hi]

        # ---- neighbour matching + RANSAC + Procrustes init ----------------
        with annotate("bundletrack.neighbour"):
            # constant-velocity prediction: pred_pose advances by the last
            # inter-frame delta every frame, FAIL frames included
            pose_init = state.pred_pose
            nb = match_pair(
                feats.desc, feats.pts, feats.normals, feats.valid, pose_init,
                state.prev_desc, state.prev_pts, state.prev_normals,
                state.prev_kp_valid, state.prev_pose,
                max_dist=fc.max_dist_neighbor,
                max_normal_deg=fc.max_normal_neighbor,
                max_matches=M,
            )
            pa = _take_rows(feats.pts, nb.idx_a)
            pb = _take_rows(state.prev_pts, nb.idx_b)
            na = _take_rows(feats.normals, nb.idx_a)
            nbn = _take_rows(state.prev_normals, nb.idx_b)
            prior_nb = se3_compose(se3_inverse(state.prev_pose), pose_init)
            rr = ransac_pair(
                pa, pb, na, nbn, nb.valid, prior_nb,
                phases=phases_nb,
                max_trans=rc.max_trans_neighbor,
                max_rot_deg=rc.max_rot_deg_neighbor,
                **ransac_kw,
            )
            T_new_to_prev = refine_pose_on_inliers(pa, pb, rr.inliers)
            pose_new = _stream_select(rr.valid, se3_compose(state.prev_pose, T_new_to_prev), pose_init)
            fail = (~rr.valid) | (~roi_ok) | (n_feat < 5)
            # reinit gate: after a FAIL, demand reinit_min_matches inliers,
            # decaying by one per FAIL frame beyond a patience of 5
            patience = 5
            required = torch.clamp(
                rc.reinit_min_matches - torch.clamp(state.fail_streak - patience, min=0),
                min=rc.min_match_after_ransac,
            )
            fail = fail | (state.need_reinit & (rr.num_inliers < required))
            fail = broadcast_from_first(fail, group)

        # ---- BA subset + edges -------------------------------------------
        with annotate("bundletrack.ba_pairs"):
            slots, sel_valid = select_ba_subset(state.kf_frame_id, state.kf_pose, pose_new, n_pool_sel)

            def app(pool, new):
                return torch.cat([_take_rows(pool, slots), new[:, None]], dim=1)

            sel_col = sel_valid[..., None]
            ba_desc = app(state.kf_desc, feats.desc)
            ba_pts = app(state.kf_pts, feats.pts)
            ba_nrm = app(state.kf_normals, feats.normals)
            ba_kpv = torch.cat([_take_rows(state.kf_kp_valid, slots) & sel_col, feats.valid[:, None]], dim=1)
            ba_pose = app(state.kf_pose, pose_new)
            ba_valid = torch.cat([sel_valid, (~fail)[:, None]], dim=1)
            pool_slot_of = torch.cat([slots, torch.full((S, 1), -1, dtype=slots.dtype, device=dev)], dim=1)
            pairs = pairs_on(dev, S)
            pair_i, pair_j = pairs[:2]
            bm, mpa, mpb, edge_valid, n_edges_new = ba_pair_section(
                ba_desc, ba_pts, ba_nrm, ba_kpv, ba_pose, ba_valid,
                state.mappoints, pool_slot_of, pairs, phases_pairs,
            )
            # the dense stacks (~52 MB at 8 streams) after the BA RANSAC, whose
            # trials set the card's peak memory
            dense_compact = stack_frame_dense(
                app(state.kf_dsrc, fd.src),
                torch.cat([_take_rows(state.kf_dvalid, slots) & sel_col, fd.valid[:, None]], dim=1),
                app(state.kf_dlin, fd.lin),
                app(state.kf_tchan, fd.tchan),
            )
        no_ba = n_edges_new <= cfg.bundle.min_fm_edges_newframe

        # ---- BA solve for the streams that need one (lax.cond under vmap)
        run = ~(fail | no_ba)
        run_flags = read("reads.solve", run)  # device-to-host read 1 of 2
        any_run, all_run = any(run_flags), all(run_flags)
        ba_rejected = torch.zeros_like(run)
        ba_out_poses = ba_pose
        if any_run:
            inputs = GraphInputs(
                poses=ba_pose,
                frame_valid=ba_valid,
                free_mask=torch.arange(K_BA, device=dev) > 0,  # anchor the oldest frame
                corres=SparseCorres(pair_i=pair_i, pair_j=pair_j, pts_i=mpa, pts_j=mpb,
                                    valid=edge_valid),
                dense_compact=dense_compact,
                K_lowres=K_low,
            )
            ba_out_poses, ba_rejected, _ = optimize_pose_graph_verified(inputs, cfg.bundle, p2p=cfg.p2p,
                                                                        group=group)
            count("gn.solves", sum(run_flags))
            if not all_run:
                ba_out_poses = _stream_select(run, ba_out_poses, ba_pose)
                ba_rejected = ba_rejected & run
        no_ba = no_ba | ba_rejected  # a rejected solve keeps the Procrustes pose
        pose_final = _stream_select(fail, state.prev_pose, ba_out_poses[:, new_idx])

        # scatter optimized keyframe poses back into the pool
        pool_index = (torch.arange(S, device=dev)[:, None] * Kp + slots).reshape(-1)
        kf_pose_sel = _take_rows(state.kf_pose, slots)
        kf_pose = state.kf_pose.reshape(S * Kp, 4, 4).index_copy(
            0, pool_index,
            _stream_select(sel_valid.reshape(-1), ba_out_poses[:, :n_pool_sel].reshape(-1, 4, 4),
                           kf_pose_sel.reshape(-1, 4, 4)),
        ).reshape(S, Kp, 4, 4)
        status = torch.where(
            fail, STATUS_FAIL, torch.where(no_ba, STATUS_NO_BA, STATUS_OK)
        ).to(torch.int32)
        st = state._replace(kf_pose=kf_pose)

        # ---- keyframe admission (status OK only) --------------------------
        admit = keyframe_admission(
            st.kf_frame_id, st.kf_pose, pose_final, n_feat, status == STATUS_OK,
            cfg.keyframe.min_feat_num, cfg.keyframe.min_rot,
        )
        admit = broadcast_from_first(admit, group)
        admit_flags = read("reads.admit", admit)  # read 2 of 2
        any_admit, all_admit = any(admit_flags), all(admit_flags)
        count("keyframes.admitted", sum(admit_flags))
        if any_admit:
            sel = None if all_admit else admit
            new_slot = eviction_slot(st.kf_frame_id, st.kf_pose)
            frame_id = _counts_on(state.frame_count, dev)
            st_new = _admit_keyframe(st, feats, pose_final, fd, frame_id, new_slot, admit=sel)
            if fc.map_points:
                # absorb the new keyframe's verified BA edges into the landmark
                # track table (reference updateFramePairMapPoints)
                mp = st_new.mappoints
                if group is not None:  # every pair's matches, in pair order
                    packed = all_gather_cat(torch.stack([bm.idx_a, bm.idx_b, edge_valid.long()]), group, dim=2)
                    bm = MatchResult(packed[0], packed[1], packed[2].bool())
                    edge_valid = bm.valid
                for p in new_pairs:
                    pool_pos = int(pair_i_np[p])
                    m = MatchResult(
                        idx_a=bm.idx_a[:, p], idx_b=bm.idx_b[:, p],
                        valid=edge_valid[:, p] & sel_valid[:, pool_pos, None],
                    )
                    mp = update_mappoints(mp, slots[:, pool_pos], new_slot, m)
                st_new = st_new._replace(mappoints=mp)
            if sel is not None:
                st_new = st_new._replace(mappoints=MapPointTable(
                    *(_stream_select(admit, a, b) for a, b in zip(st_new.mappoints, st.mappoints))
                ))
            st = st_new

        # ---- prev update (skipped on FAIL: the reference forgets the frame)
        st = _set_prev(st, feats, pose_final, keep=~fail)

        # constant-velocity update: delta re-estimated on a normal OK frame,
        # identity on the recovery frame, held during FAIL; the prediction
        # advances by delta every frame
        is_fail = status == STATUS_FAIL
        eye = torch.eye(4, dtype=pose_final.dtype, device=dev)
        delta_ok = _stream_select(
            state.fail_streak == 0, se3_compose(pose_final, se3_inverse(state.prev_pose)),
            eye.expand(S, 4, 4),
        )
        new_delta = _stream_select(is_fail, state.prev_delta, delta_ok)
        new_pred = _stream_select(
            is_fail,
            se3_compose(state.prev_delta, state.pred_pose),
            se3_compose(new_delta, pose_final),
        )
        st = st._replace(
            frame_count=tuple(c + 1 for c in state.frame_count),
            last_status=status,
            need_reinit=is_fail,
            fail_streak=torch.where(is_fail, st.fail_streak + 1, 0).to(torch.int32),
            prev_delta=new_delta,
            pred_pose=new_pred,
        )
        out = TrackOutput(
            ob_in_cam=se3_inverse(pose_final),
            pose_in_model=pose_final,
            status=status,
            num_matches=rr.num_inliers.to(torch.int32),
            num_ba_edges=n_edges_new.to(torch.int32),
        )
        return st, out

    return step


def track_frame(state: TrackerState, obs: FrameObservation, init_pose: torch.Tensor, cfg: TrackerConfig,
                phases: Optional[tuple] = None):
    """One frame of one stream through a step built for the observation's
    H x W (a convenience: the step is built anew on every call; keep the
    one `make_track_frame` returns to track a sequence).  `phases` as the
    step's."""
    H, W = obs.gray.shape
    return make_track_frame(cfg, H, W)(state, obs, init_pose, phases)
