"""The per-frame tracking step.

Counterpart of bundletrack_tpu/tracker/bundler.py::make_track_frame
(reference: Bundler::processNewFrame and optimizeGPU, src/Bundler.cpp):

  preprocess depth -> features -> neighbour match + RANSAC -> Procrustes
  pose init -> greedy_rot BA subset -> all-pairs matching (fused CUDA
  kernel) + landmark propagation + RANSAC on every pair -> robust GN
  pose-graph solve -> keyframe admission -> outputs.

The JAX step is one traced program whose data-dependent branches are
lax.cond / jnp.where.  Here three of them are host `if`s, and each reads
the device once: whether this is the first frame, whether to run the BA
solve (FAIL or too few edges), and whether to admit the frame as a
keyframe.  So a tracked frame makes 3 device-to-host reads, the first frame
1.  Everything else stays on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bundletrack_tpu_torch.config import TrackerConfig
from bundletrack_tpu_torch.frontend.pipeline import FrameFeatures, extract_frame_features
from bundletrack_tpu_torch.geometry.camera import scale_intrinsics
from bundletrack_tpu_torch.geometry.se3 import se3_compose, se3_inverse
from bundletrack_tpu_torch.matching.mappoints import (
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
)


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
    """Depth chain + cloud/normals + the frame's compacted dense tables."""
    depth = process_depth(obs.depth, cfg.depth_processing)
    pts_map, nrm_map, val_map = depth_to_cloud_and_normals(depth, obs.K)
    seg_mask = preprocess_mask(obs.mask, cfg.segmentation)
    mask = seg_mask & (depth > 0.1)
    val_map = val_map & seg_mask
    ds = cfg.bundle.image_downscale
    fd = compact_frame(
        pts_map[::ds, ::ds], nrm_map[::ds, ::ds], val_map[::ds, ::ds],
        cfg.bundle.dense_src_capacity,
    )
    K_low = scale_intrinsics(obs.K, 1.0 / ds)
    return mask, pts_map, nrm_map, val_map, fd, K_low


def _gather_match_points(ba_pts, ba_normals, pair_i, pair_j, matches: MatchResult):
    """[K,N,3] tables + match indices -> per-pair matched point arrays."""
    def g(table, frame, idx):
        return torch.gather(table[frame], 1, idx[..., None].expand(*idx.shape, 3))

    return (
        g(ba_pts, pair_i, matches.idx_a), g(ba_pts, pair_j, matches.idx_b),
        g(ba_normals, pair_i, matches.idx_a), g(ba_normals, pair_j, matches.idx_b),
    )


def _admit_keyframe(state: TrackerState, feats: FrameFeatures, pose, fd: FrameDense,
                    frame_id, slot) -> TrackerState:
    """Write the frame into pool slot `slot` (a 0-dim tensor), forgetting the
    slot's old landmark observations."""
    index = slot.reshape(1)  # a 1-element index keeps the slot on the device

    def put(pool, value):
        return pool.index_copy(0, index, value.to(pool.dtype)[None])

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


def _set_prev(state: TrackerState, feats: FrameFeatures, pose) -> TrackerState:
    return state._replace(
        prev_desc=feats.desc,
        prev_pts=feats.pts,
        prev_normals=feats.normals,
        prev_kp_valid=feats.valid,
        prev_pose=pose,
        prev_valid=torch.ones((), dtype=torch.bool, device=pose.device),
    )


def make_track_frame(cfg: TrackerConfig, H: int, W: int, lfnet_apply=None):
    """Build the per-frame step for images of size H x W.

    step(state, obs, init_pose, phases=None) -> (state, TrackOutput).
    `phases` = (neighbour [3, n_rep], pairs [P, 3, n_rep]) RANSAC phases;
    when None they are drawn from `state.rng`.  `lfnet_apply` is the LF-Net
    frontend (frontend/lfnet.make_lfnet_apply), needed when
    cfg.frontend.kind is "lfnet"; its descriptors are cfg.frontend.desc_dim
    wide.
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
    # device -> (pair_i, pair_j) int64 for torch indexing, then the same as
    # int32 for the matcher kernel, uploaded once: an int32 index costs torch
    # a cast launch at every use, and the kernel takes int32
    pair_index = {}

    def pairs_on(dev):
        if dev not in pair_index:
            pair_index[dev] = tuple(
                torch.as_tensor(a.astype(t), device=dev)
                for t in (np.int64, np.int32) for a in (pair_i_np, pair_j_np)
            )
        return pair_index[dev]

    def ba_pair_section(ba_desc, ba_pts, ba_nrm, ba_kpv, ba_pose, ba_valid,
                        mappoints, pool_slot_of, pairs, phases_pairs):
        """Match -> propagate -> RANSAC over the BA pairs."""
        pair_i, pair_j, pair_i32, pair_j32 = pairs
        pair_valid = ba_valid[pair_i] & ba_valid[pair_j]
        bm = match_pairs_batched(
            ba_desc, ba_pts, ba_nrm, ba_kpv, ba_pose, pair_i32, pair_j32, pair_valid,
            max_dist=fc.max_dist_no_neighbor,
            max_normal_deg=fc.max_normal_no_neighbor,
            max_matches=M,
        )
        if fc.map_points:
            # seed BA pairs with landmark-propagated matches (reference
            # findCorresByMapPoints); RANSAC filters the union
            si, sj = pool_slot_of[pair_i], pool_slot_of[pair_j]
            prop_ok = (si >= 0) & (sj >= 0) & pair_valid
            prop = propagate_matches(mappoints, si.clamp(min=0), sj.clamp(min=0), M)
            prop = prop._replace(valid=prop.valid & prop_ok[:, None])
            bm = merge_matches(bm, prop, ba_desc.shape[1], M)
            bm = bm._replace(valid=bm.valid & pair_valid[:, None])
        mpa, mpb, mna, mnb = _gather_match_points(ba_pts, ba_nrm, pair_i, pair_j, bm)
        prior = se3_compose(se3_inverse(ba_pose[pair_j]), ba_pose[pair_i])
        mr = ransac_pair(
            mpa, mpb, mna, mnb, bm.valid, prior,
            phases=phases_pairs,
            max_trans=rc.max_trans_no_neighbor,
            max_rot_deg=rc.max_rot_no_neighbor,
            **ransac_kw,
        )
        edge_valid = bm.valid & mr.inliers
        touches_new = (pair_i == new_idx) | (pair_j == new_idx)
        n_edges_new = torch.sum(edge_valid & touches_new[:, None])
        return bm, mpa, mpb, edge_valid, n_edges_new

    def step(state: TrackerState, obs: FrameObservation, init_pose: torch.Tensor,
             phases: Optional[tuple] = None):
        dev = state.kf_pose.device
        obs = _normalize_obs(obs)
        mask, pts_map, nrm_map, val_map, fd, K_low = _preprocess(obs, cfg)
        feats = extract_frame_features(obs.gray, mask, pts_map, nrm_map, val_map, cfg.frontend,
                                       lfnet_apply)
        n_feat = torch.sum(feats.valid)
        roi_ok = torch.sum(mask) > 100  # the reference FAILs on a tiny ROI
        i32 = dict(dtype=torch.int32, device=dev)

        if int(state.frame_count) == 0:  # device-to-host read 1 of 1
            st = _admit_keyframe(
                state, feats, init_pose, fd,
                frame_id=torch.zeros((), **i32),
                slot=eviction_slot(state.kf_frame_id, state.kf_pose),
            )
            st = _set_prev(st, feats, init_pose)
            st = st._replace(
                frame_count=torch.ones((), **i32),
                last_status=torch.full((), STATUS_OK, **i32),
                prev_delta=torch.eye(4, dtype=init_pose.dtype, device=dev),
                pred_pose=init_pose,
            )
            out = TrackOutput(
                ob_in_cam=se3_inverse(init_pose),
                pose_in_model=init_pose,
                status=torch.full((), STATUS_OK, **i32),
                num_matches=torch.zeros((), **i32),
                num_ba_edges=torch.zeros((), **i32),
            )
            return st, out

        if phases is None:
            phases = (
                draw_phases((), rc.max_iter, M, state.rng),
                draw_phases((P_PAIRS,), rc.max_iter, M, state.rng),
            )
        phases_nb, phases_pairs = phases

        # ---- neighbour matching + RANSAC + Procrustes init ----------------
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
        pa = feats.pts[nb.idx_a]
        pb = state.prev_pts[nb.idx_b]
        na = feats.normals[nb.idx_a]
        nbn = state.prev_normals[nb.idx_b]
        prior_nb = se3_compose(se3_inverse(state.prev_pose), pose_init)
        rr = ransac_pair(
            pa, pb, na, nbn, nb.valid, prior_nb,
            phases=phases_nb,
            max_trans=rc.max_trans_neighbor,
            max_rot_deg=rc.max_rot_deg_neighbor,
            **ransac_kw,
        )
        T_new_to_prev = refine_pose_on_inliers(pa, pb, rr.inliers)
        pose_new = torch.where(rr.valid, se3_compose(state.prev_pose, T_new_to_prev), pose_init)
        fail = (~rr.valid) | (~roi_ok) | (n_feat < 5)
        # reinit gate: after a FAIL, demand reinit_min_matches inliers,
        # decaying by one per FAIL frame beyond a patience of 5
        patience = 5
        required = torch.clamp(
            rc.reinit_min_matches - torch.clamp(state.fail_streak - patience, min=0),
            min=rc.min_match_after_ransac,
        )
        fail = fail | (state.need_reinit & (rr.num_inliers < required))

        # ---- BA subset + edges -------------------------------------------
        slots, sel_valid = select_ba_subset(state.kf_frame_id, state.kf_pose, pose_new, n_pool_sel)

        def app(pool, new):
            return torch.cat([pool[slots], new[None]], dim=0)

        ba_desc = app(state.kf_desc, feats.desc)
        ba_pts = app(state.kf_pts, feats.pts)
        ba_nrm = app(state.kf_normals, feats.normals)
        ba_kpv = torch.cat([state.kf_kp_valid[slots] & sel_valid[:, None], feats.valid[None]])
        ba_pose = app(state.kf_pose, pose_new)
        ba_valid = torch.cat([sel_valid, (~fail)[None]])
        dense_compact = stack_frame_dense(
            app(state.kf_dsrc, fd.src),
            torch.cat([state.kf_dvalid[slots] & sel_valid[:, None], fd.valid[None]]),
            app(state.kf_dlin, fd.lin),
            app(state.kf_tchan, fd.tchan),
        )
        pool_slot_of = torch.cat([slots, torch.full((1,), -1, dtype=slots.dtype, device=dev)])
        pairs = pairs_on(dev)
        pair_i, pair_j = pairs[:2]
        bm, mpa, mpb, edge_valid, n_edges_new = ba_pair_section(
            ba_desc, ba_pts, ba_nrm, ba_kpv, ba_pose, ba_valid,
            state.mappoints, pool_slot_of, pairs, phases_pairs,
        )
        no_ba = n_edges_new <= cfg.bundle.min_fm_edges_newframe

        fail_h, no_ba_h = torch.stack([fail, no_ba]).tolist()  # device-to-host read 2 of 3
        ba_rejected = torch.zeros((), dtype=torch.bool, device=dev)
        ba_out_poses = ba_pose
        if not (fail_h or no_ba_h):
            inputs = GraphInputs(
                poses=ba_pose,
                frame_valid=ba_valid,
                free_mask=torch.arange(K_BA, device=dev) > 0,  # anchor the oldest frame
                corres=SparseCorres(pair_i=pair_i, pair_j=pair_j, pts_i=mpa, pts_j=mpb,
                                    valid=edge_valid),
                dense_compact=dense_compact,
                K_lowres=K_low,
            )
            ba_out_poses, ba_rejected, _ = optimize_pose_graph_verified(inputs, cfg.bundle, p2p=cfg.p2p)
        no_ba = no_ba | ba_rejected  # a rejected solve keeps the Procrustes pose
        pose_final = state.prev_pose if fail_h else ba_out_poses[new_idx]

        # scatter optimized keyframe poses back into the pool
        kf_pose = state.kf_pose.clone()
        keep = sel_valid[:, None, None]
        kf_pose[slots] = torch.where(keep, ba_out_poses[:n_pool_sel], state.kf_pose[slots])
        status = torch.where(
            fail, STATUS_FAIL, torch.where(no_ba, STATUS_NO_BA, STATUS_OK)
        ).to(torch.int32)
        st = state._replace(kf_pose=kf_pose)

        # ---- keyframe admission (status OK only) --------------------------
        admit = keyframe_admission(
            st.kf_frame_id, st.kf_pose, pose_final, n_feat, status == STATUS_OK,
            cfg.keyframe.min_feat_num, cfg.keyframe.min_rot,
        )
        if bool(admit):  # device-to-host read 3 of 3
            new_slot = eviction_slot(st.kf_frame_id, st.kf_pose)
            st = _admit_keyframe(st, feats, pose_final, fd, frame_id=st.frame_count, slot=new_slot)
            if fc.map_points:
                # absorb the new keyframe's verified BA edges into the landmark
                # track table (reference updateFramePairMapPoints)
                mp = st.mappoints
                for p in new_pairs:
                    pool_pos = int(pair_i_np[p])
                    m = MatchResult(
                        idx_a=bm.idx_a[p], idx_b=bm.idx_b[p],
                        valid=edge_valid[p] & sel_valid[pool_pos],
                    )
                    mp = update_mappoints(mp, slots[pool_pos], new_slot, m)
                st = st._replace(mappoints=mp)

        # ---- prev update (skipped on FAIL: the reference forgets the frame)
        if not fail_h:
            st = _set_prev(st, feats, pose_final)

        # constant-velocity update: delta re-estimated on a normal OK frame,
        # identity on the recovery frame, held during FAIL; the prediction
        # advances by delta every frame
        is_fail = status == STATUS_FAIL
        eye = torch.eye(4, dtype=pose_final.dtype, device=dev)
        delta_ok = torch.where(
            state.fail_streak == 0, se3_compose(pose_final, se3_inverse(state.prev_pose)), eye
        )
        new_delta = torch.where(is_fail, state.prev_delta, delta_ok)
        new_pred = torch.where(
            is_fail,
            se3_compose(state.prev_delta, state.pred_pose),
            se3_compose(new_delta, pose_final),
        )
        st = st._replace(
            frame_count=st.frame_count + 1,
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
