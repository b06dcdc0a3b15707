"""Fused per-frame tracking device programs.

Every synchronous device round trip stalls the host; the unfused tracker
paid ~13 of them per frame (search, widen-retry, pose opt, frustum, local
search, per-array fetches...). These
programs fuse each tracking stage into ONE jitted call whose outputs come
back as ONE packed f32 buffer:

  * motion_step: motion-model projection search (narrow + widened window
    evaluated from the SAME distance matrix, selected in-program — the
    reference's `if(nmatches<20) search again with 2*th`,
    src/Tracking.cc:510-547) + the 4x10 LM pose optimization.
  * localmap_step: frustum check over the local-map block (reference
    SearchLocalPoints / isInFrustum), projection search with the
    view-cos-dependent radius, in-program association scatter, and the
    final pose optimization (reference TrackLocalMap :549-575).

Semantics match the unfused host orchestration (the same matching masks,
thresholds, and pose_optimization); only the host<->device cut changes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam_system_tpu.config import SlamConfig
from orb_slam_system_tpu.ops import frustum as frustum_ops
from orb_slam_system_tpu.ops import matching
from orb_slam_system_tpu.ops.hamming import distance_matrix
from orb_slam_system_tpu.solvers.pose_opt import pose_optimization
from orb_slam_system_tpu.utils import lie


def _scatter_last_wins(n_out, idx, valid, n_src):
    """Deterministic duplicate resolution for scatters: winner[j] = the
    LARGEST source row i with valid[i] and idx[i] == j, else -1 — exactly
    the last-writer-wins of a host loop iterating i in ascending order
    (e.g. `for k in nonzero(idx2>=0): mp_ids[idx2[k]] = ids[k]`).
    jnp's .at[].set with duplicate indices has an UNSPECIFIED winner,
    which made the fused/chain association outputs nondeterministic when
    two points claimed the same feature slot."""
    import jax.numpy as jnp
    w = jnp.where(valid, idx, n_out)
    return jnp.full(n_out, -1, jnp.int32).at[w].max(
        jnp.arange(n_src, dtype=jnp.int32), mode="drop")


class TrackPrograms:
    """Shape-specialized fused tracking programs for one camera config."""

    def __init__(self, cfg: SlamConfig, n_slots: int, local_slots: int,
                 bounds):
        cam = cfg.camera
        scale_factors = jnp.asarray(cfg.orb.level_scales(), jnp.float32)
        inv_sigma2 = 1.0 / scale_factors ** 2
        log_sf = float(np.log(cfg.orb.scale_factor))
        n_levels = cfg.orb.n_levels
        fx, fy, cx, cy, bf = cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        th_depth = float(cfg.th_depth)
        self._th_cache: dict = {}  # float -> device scalar (see chain_step)

        def unpack(packed):
            """Slice a device-resident packed frame buffer (see
            FrameBuilder._extract_packed): columns 2:4 undistorted xy,
            5 angle, 6 octave, 7 valid, 8:16 descriptor bits, 16 u_right
            (stereo/RGB-D only)."""
            xy = packed[:, 2:4]
            ang = packed[:, 5]
            octv = packed[:, 6].astype(jnp.int32)
            valid = packed[:, 7] > 0.5
            desc = jax.lax.bitcast_convert_type(packed[:, 8:16], jnp.uint32)
            if packed.shape[1] > 16:
                ur = packed[:, 16]
            else:
                ur = jnp.full(packed.shape[0], -1.0, jnp.float32)
            return xy, ang, octv, valid, desc, ur

        def motion_core(proj, ok, pos_last, packed_last, packed_cur,
                        Tcw_pred, th):
            _, ang_last, oct_last, _, desc_last, _ = unpack(packed_last)
            cur_xy, cur_ang, cur_oct, cur_valid, cur_desc, cur_ur = \
                unpack(packed_cur)
            # One distance matrix; two window masks (narrow th, wide 2*th).
            D = distance_matrix(desc_last, cur_desc)
            radius = th * scale_factors[oct_last]

            def masked_match(r):
                dx = jnp.abs(cur_xy[None, :, 0] - proj[:, None, 0])
                dy = jnp.abs(cur_xy[None, :, 1] - proj[:, None, 1])
                in_win = (dx <= r[:, None]) & (dy <= r[:, None])
                band = ((cur_oct[None, :] >= oct_last[:, None] - 1)
                        & (cur_oct[None, :] <= oct_last[:, None] + 1))
                mask = ok[:, None] & cur_valid[None, :] & in_win & band
                best_j, best_d, _ = matching._masked_best2(D, mask)
                m = (best_d <= matching.TH_HIGH) & ok
                m = matching._dedupe_keep_best(best_j, best_d, m,
                                               cur_xy.shape[0])
                m = matching.rotation_consistency(ang_last, cur_ang[best_j], m)
                return best_j, m

            j1, m1 = masked_match(radius)
            j2, m2 = masked_match(2.0 * radius)
            use_wide = jnp.sum(m1.astype(jnp.int32)) < 20
            best_j = jnp.where(use_wide, j2, j1)
            matched = jnp.where(use_wide, m2, m1)
            # Pose LM over the matched edges (Xw = last-slot point, obs =
            # matched current keypoint).
            obs = cur_xy[best_j]
            obs_ur = cur_ur[best_j]
            T_opt, inlier, n_in = pose_optimization(
                Tcw_pred, pos_last, obs,
                inv_sigma2[cur_oct[best_j]], matched,
                fx, fy, cx, cy,
                obs_ur=jnp.where(matched, obs_ur, -1.0), bf=bf)
            return T_opt, best_j, matched, inlier, n_in, cur_valid

        def motion_step(proj, ok, pos_last, packed_last, packed_cur,
                        Tcw_pred, th):
            T_opt, best_j, matched, inlier, n_in, cur_valid = motion_core(
                proj, ok, pos_last, packed_last, packed_cur, Tcw_pred, th)
            packed = jnp.concatenate([
                T_opt.ravel(),
                best_j.astype(jnp.float32),
                matched.astype(jnp.float32),
                inlier.astype(jnp.float32),
                jnp.stack([n_in.astype(jnp.float32),
                           jnp.sum(matched.astype(jnp.float32)),
                           jnp.sum(cur_valid.astype(jnp.float32))]),
            ])
            return packed

        self._motion_step = jax.jit(motion_step)
        self._n = n_slots

        def localmap_core(pos, normal, mind, maxd, lm_desc, lm_valid,
                          Xw_pre, ok_pre, packed_cur, already, Tcw):
            cur_xy, cur_ang, cur_oct, cur_valid, cur_desc, cur_ur = \
                unpack(packed_cur)
            fr = frustum_ops.frustum_check(
                pos, normal, mind, maxd, lm_valid, Tcw,
                fx, fy, cx, cy,
                bounds[0], bounds[1], bounds[2], bounds[3],
                log_sf, n_levels)
            visible = fr["visible"]
            proj_xy = fr["proj_xy"]
            pred_level = fr["pred_level"]
            view_cos = fr["view_cos"]
            r = jnp.where(view_cos > 0.998, 2.5, 4.0)
            radius = r * scale_factors[pred_level]
            res = matching.search_by_projection_local_map(
                proj_xy, radius, pred_level, visible, lm_desc,
                cur_xy, cur_desc, cur_valid, cur_oct, already)
            idx2 = res.idx2
            matched = idx2 >= 0
            # Attach: local points onto their claimed current slots, with
            # deterministic host-loop (last-writer-wins) duplicate
            # resolution.
            n_cur = Xw_pre.shape[0]
            winner = _scatter_last_wins(n_cur, idx2, matched, pos.shape[0])
            has = winner >= 0
            wsafe = jnp.maximum(winner, 0)
            Xw = jnp.where(has[:, None], pos[wsafe], Xw_pre)
            ok = ok_pre | has
            T_opt, inlier, n_in = pose_optimization(
                Tcw, Xw, cur_xy, inv_sigma2[cur_oct], ok,
                fx, fy, cx, cy,
                obs_ur=jnp.where(ok, cur_ur, -1.0), bf=bf)
            return T_opt, idx2, visible, inlier, n_in

        def localmap_step(pos, normal, mind, maxd, lm_desc, lm_valid,
                          Xw_pre, ok_pre, packed_cur, already, Tcw):
            T_opt, idx2, visible, inlier, n_in = localmap_core(
                pos, normal, mind, maxd, lm_desc, lm_valid,
                Xw_pre, ok_pre, packed_cur, already, Tcw)
            packed = jnp.concatenate([
                T_opt.ravel(),
                idx2.astype(jnp.float32),
                visible.astype(jnp.float32),
                inlier.astype(jnp.float32),
                jnp.asarray([n_in], jnp.float32).reshape(1),
            ])
            return packed

        self._localmap_step = jax.jit(localmap_step)
        self._p = local_slots

        def fused_step(host_in, packed_last, packed_cur,
                       lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc,
                       lm_valid):
            """host_in packs every per-frame host input into ONE f32[N,8]
            upload (each separate host->device transfer costs enqueue
            latency): columns 0:2 proj, 2 ok, 3:6
            pos_last, 6 last2local, 7 row 0..16 = Tcw_pred.ravel() and
            row 17 = th."""
            proj = host_in[:, 0:2]
            ok = host_in[:, 2] > 0.5
            pos_last = host_in[:, 3:6]
            last2local = host_in[:, 6].astype(jnp.int32)
            Tcw_pred = host_in[:16, 7].reshape(4, 4)
            th = host_in[17, 7]
            """Motion-model stage + local-map stage as ONE device program
            (one host round trip per steady-state frame instead of two).

            The local-map block is chosen by the host from the PREVIOUS
            frame's final associations (the reference recomputes the local
            keyframe set from the current frame's motion matches,
            src/Tracking.cc:719-794; one frame of covisibility staleness —
            the host falls back to the exact two-step path when the fused
            result is weak). `last2local` maps each last-frame slot to its
            point's slot in the local block (-1 if absent) so the
            in-program association scatter can exclude already-matched
            points exactly like SearchLocalPoints (:661-678)."""
            n = pos_last.shape[0]
            P = lm_pos.shape[0]
            T1, best_j, matched, inlier1, n_in1, cur_valid = motion_core(
                proj, ok, pos_last, packed_last, packed_cur, Tcw_pred, th)
            good = matched & inlier1
            # good best_j values are unique (_dedupe_keep_best), so the
            # only duplicate hazard is the not-good rows: route them to an
            # out-of-range index dropped by the scatter. (A shared slot-0
            # write had an UNSPECIFIED winner and could nondeterministically
            # drop a motion match on current slot 0.)
            safe_j = jnp.where(good, best_j, n)
            Xw_pre = jnp.zeros((n, 3), jnp.float32).at[safe_j].set(
                pos_last, mode="drop")
            ok_pre = jnp.zeros(n, bool).at[safe_j].set(True, mode="drop")
            # Local-block points already claimed by the motion stage.
            ll = jnp.where(good & (last2local >= 0), last2local, P)
            already_local = jnp.zeros(P, bool).at[ll].set(True, mode="drop")
            T2, idx2, visible, inlier2, n_in2 = localmap_core(
                lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc,
                lm_valid & ~already_local,
                Xw_pre, ok_pre, packed_cur, ok_pre, T1)
            packed = jnp.concatenate([
                T2.ravel(),
                best_j.astype(jnp.float32),
                matched.astype(jnp.float32),
                inlier1.astype(jnp.float32),
                idx2.astype(jnp.float32),
                visible.astype(jnp.float32),
                already_local.astype(jnp.float32),
                inlier2.astype(jnp.float32),
                jnp.stack([n_in1.astype(jnp.float32),
                           jnp.sum(matched.astype(jnp.float32)),
                           jnp.sum(cur_valid.astype(jnp.float32)),
                           n_in2.astype(jnp.float32)]),
            ])
            return packed

        self._fused_step = jax.jit(fused_step)

        def chain_step(T_prev, T_last, assoc_in, lm_remap,
                       packed_last, packed_cur,
                       lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc,
                       lm_valid, th):
            """Device-state tracking step: the pipelined steady-state mode.

            The fused_step above still needs the PREVIOUS frame's fetched
            results on the host to build its inputs (projection prior,
            point gather), so the host blocks one round trip per
            frame. This variant keeps that state ON DEVICE — poses
            (T_prev, T_last) and the per-slot association into the local
            block (assoc_in i32[N], -1 = none) — and derives everything
            in-program:

              velocity = T_last · T_prev⁻¹  (reference Tracking.cc:216-221)
              Tcw_pred = velocity · T_last
              pos_last = lm_pos[assoc], proj = π(Tcw_pred · pos_last)

            then runs the same motion + local-map cores and PROPAGATES the
            association state to the current frame (motion matches, then
            local-map scatter, then final-inlier pruning — the exact order
            of the host bookkeeping in Tracker.track_fused). The host can
            therefore enqueue frame k+1's step before frame k's results
            arrive, and fetch results asynchronously one frame late: the
            round trip overlaps the next frame's device work.

            lm_remap i32[P] maps the PREVIOUS step's local-block slots to
            the current block (identity when the block is unchanged;
            -1 drops a point that left the block) so the host can rotate
            the block between enqueues without syncing the state.

            One deliberate approximation vs fused_step: last-frame points
            NOT present in the local block cannot seed the motion search
            (the host path gathers them from the full map). The block is
            built from the covisible local map, which contains the tracked
            points by construction; the weak-result gates on the host
            trigger the exact fallback when it matters.

            Returns (T_last_out, T_cur_out, assoc_out, packed_out).
            """
            n = assoc_in.shape[0]
            P = lm_pos.shape[0]
            safe_a = jnp.clip(assoc_in, 0, P - 1)
            assoc = jnp.where(assoc_in >= 0, lm_remap[safe_a], -1)
            # The pose state loops device->device across frames: each
            # step's outputs (pose_optimization retractions applied to
            # these inputs) become the next step's T_prev/T_last. f32
            # rounding makes the rotation blocks slightly
            # non-orthonormal, and the transpose-trick inverse below
            # then AMPLIFIES the defect (det error cubes per step —
            # measured collapse to det 0.59 within ~12 frames, >100 px
            # projection error). Projecting the state back onto SE(3)
            # every step bounds the drift at one step's rounding.
            T_prev = lie.se3_project(T_prev)
            T_last = lie.se3_project(T_last)
            # SE3 inverse (R, t): [R^T, -R^T t].
            Rp, tp = T_prev[:3, :3], T_prev[:3, 3]
            Tp_inv = jnp.eye(4, dtype=jnp.float32)
            Tp_inv = Tp_inv.at[:3, :3].set(Rp.T)
            Tp_inv = Tp_inv.at[:3, 3].set(-Rp.T @ tp)
            velocity = T_last @ Tp_inv
            Tcw_pred = velocity @ T_last
            safe_a2 = jnp.clip(assoc, 0, P - 1)
            pos_last = lm_pos[safe_a2]
            Xc = pos_last @ Tcw_pred[:3, :3].T + Tcw_pred[:3, 3]
            z = Xc[:, 2]
            zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
            proj = jnp.stack([fx * Xc[:, 0] / zs + cx,
                              fy * Xc[:, 1] / zs + cy], axis=1)
            ok = (assoc >= 0) & (z > 0)

            T1, best_j, matched, inlier1, n_in1, cur_valid = motion_core(
                proj, ok, pos_last, packed_last, packed_cur, Tcw_pred, th)
            good = matched & inlier1
            # Same out-of-range-drop pattern as fused_step: not-good rows
            # must not share a written slot (unspecified winner).
            safe_j = jnp.where(good, best_j, n)
            Xw_pre = jnp.zeros((n, 3), jnp.float32).at[safe_j].set(
                pos_last, mode="drop")
            ok_pre = jnp.zeros(n, bool).at[safe_j].set(True, mode="drop")
            ll = jnp.where(good & (assoc >= 0), assoc, P)
            already_local = jnp.zeros(P, bool).at[ll].set(True, mode="drop")
            T2, idx2, visible, inlier2, n_in2 = localmap_core(
                lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc,
                lm_valid & ~already_local,
                Xw_pre, ok_pre, packed_cur, ok_pre, T1)
            # Association propagation (same order AND the same
            # last-writer-wins duplicate resolution as the host
            # bookkeeping): motion matches attach, local-map matches
            # overwrite, final outliers detach.
            win1 = _scatter_last_wins(n, best_j, good, n)
            a1 = jnp.where(win1 >= 0, assoc[jnp.maximum(win1, 0)], -1)
            win2 = _scatter_last_wins(n, idx2, idx2 >= 0, P)
            assoc_out = jnp.where(win2 >= 0, win2, a1).astype(jnp.int32)
            assoc_out = jnp.where(inlier2, assoc_out, -1)
            # Stereo/RGB-D close-point counts for the keyframe decision
            # (reference Tracking.cc:590-600): computed in-program so the
            # host never fetches the packed frame just to read its depth
            # column (one round trip per frame otherwise).
            if packed_cur.shape[1] >= 18:
                depth_col = packed_cur[:, 17]
                close = (cur_valid & (depth_col > 0.0)
                         & (depth_col < th_depth))
                tracked_cur = assoc_out >= 0
                n_tracked_close = jnp.sum(
                    (close & tracked_cur).astype(jnp.float32))
                n_nontracked_close = jnp.sum(
                    (close & ~tracked_cur).astype(jnp.float32))
            else:
                n_tracked_close = jnp.float32(0.0)
                n_nontracked_close = jnp.float32(0.0)
            packed_out = jnp.concatenate([
                T2.ravel(),
                assoc_out.astype(jnp.float32),
                visible.astype(jnp.float32),
                already_local.astype(jnp.float32),
                jnp.stack([n_in1.astype(jnp.float32),
                           jnp.sum(matched.astype(jnp.float32)),
                           jnp.sum(cur_valid.astype(jnp.float32)),
                           n_in2.astype(jnp.float32),
                           n_tracked_close, n_nontracked_close]),
            ])
            return T_last, T2, assoc_out, packed_out

        self._chain_step = jax.jit(chain_step)

    # ---- host wrappers: one call, one fetch, numpy outputs ---------------

    def chain_step(self, T_prev_dev, T_last_dev, assoc_dev, lm_remap,
                   packed_last, packed_cur, lm_block, th=15.0):
        """Enqueue one pipelined step; NO fetch. All array inputs may be
        device-resident outputs of previous calls. lm_block is the
        (pos, normal, mind, maxd, desc, valid) device tuple. Returns
        (T_last_out, T_cur_out, assoc_out, packed_out) device arrays; call
        packed_out.copy_to_host_async() and decode later with
        decode_chain_out."""
        lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc, lm_valid = lm_block
        # Device-cache the search-radius scalar: a fresh jnp.asarray per
        # call is a host->device transfer, a dispatch stall on the
        # pipelined loop's main thread. The caller
        # caches lm_remap the same way (Tracker.chain_enqueue).
        th_dev = self._th_cache.get(th)
        if th_dev is None:
            # Callers pass a small fixed set of radii (the default and the
            # widened-retry value); cap the cache so a hypothetical
            # per-frame-varying radius can't leak one device scalar per
            # distinct value.
            if len(self._th_cache) >= 8:
                self._th_cache.pop(next(iter(self._th_cache)))
            th_dev = self._th_cache[th] = jnp.asarray(th, jnp.float32)
        return self._chain_step(
            T_prev_dev, T_last_dev, assoc_dev, jnp.asarray(lm_remap),
            packed_last, packed_cur,
            lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc, lm_valid,
            th_dev)

    def decode_chain_out(self, packed_out):
        """numpy-decode a chain packed_out (accepts the device array — a
        blocking fetch — or a numpy buffer pre-fetched by the caller's
        background fetcher)."""
        out = np.asarray(packed_out)
        n, p = self._n, self._p
        o = 16
        T2 = out[:16].reshape(4, 4).astype(np.float32)
        assoc = out[o:o + n].astype(np.int64); o += n
        visible = out[o:o + p] > 0.5; o += p
        already = out[o:o + p] > 0.5; o += p
        n_in1 = int(out[o]); n_matched = int(out[o + 1])
        n_valid_cur = int(out[o + 2]); n_in2 = int(out[o + 3])
        close_counts = (int(out[o + 4]), int(out[o + 5]))
        return (T2, assoc, visible, already, n_in1, n_matched, n_valid_cur,
                n_in2, close_counts)

    def motion_step(self, proj, ok, pos_last, packed_last, packed_cur,
                    Tcw_pred, th=15.0):
        out = np.asarray(self._motion_step(
            jnp.asarray(proj.astype(np.float32)), jnp.asarray(ok),
            jnp.asarray(pos_last.astype(np.float32)),
            packed_last, packed_cur,
            jnp.asarray(Tcw_pred.astype(np.float32)),
            jnp.asarray(th, jnp.float32)))
        n = len(ok)
        T = out[:16].reshape(4, 4).astype(np.float32)
        best_j = out[16:16 + n].astype(np.int64)
        matched = out[16 + n:16 + 2 * n] > 0.5
        inlier = out[16 + 2 * n:16 + 3 * n] > 0.5
        n_in = int(out[16 + 3 * n])
        n_matched = int(out[16 + 3 * n + 1])
        n_valid_cur = int(out[16 + 3 * n + 2])
        return T, best_j, matched, inlier, n_in, n_matched, n_valid_cur

    def localmap_step(self, pos, normal, mind, maxd, lm_desc, lm_valid,
                      Xw_pre, ok_pre, packed_cur, already, Tcw):
        out = np.asarray(self._localmap_step(
            jnp.asarray(pos.astype(np.float32)),
            jnp.asarray(normal.astype(np.float32)),
            jnp.asarray(mind.astype(np.float32)),
            jnp.asarray(maxd.astype(np.float32)),
            jnp.asarray(lm_desc), jnp.asarray(lm_valid),
            jnp.asarray(Xw_pre.astype(np.float32)), jnp.asarray(ok_pre),
            packed_cur,
            jnp.asarray(already), jnp.asarray(Tcw.astype(np.float32))))
        p, n = self._p, len(ok_pre)
        T = out[:16].reshape(4, 4).astype(np.float32)
        idx2 = out[16:16 + p].astype(np.int64)
        visible = out[16 + p:16 + 2 * p] > 0.5
        inlier = out[16 + 2 * p:16 + 2 * p + n] > 0.5
        n_in = int(out[16 + 2 * p + n])
        return T, idx2, visible, inlier, n_in

    def fused_step(self, proj, ok, pos_last, packed_last, packed_cur,
                   Tcw_pred, lm_pos, lm_normal, lm_mind, lm_maxd, lm_desc,
                   lm_valid, last2local, th=15.0):
        """One call, ONE upload, ONE fetch: motion + local-map tracking
        stages fused; all per-frame host inputs ride one packed buffer
        (the lm_* block is device-resident, cached by the tracker)."""
        n = len(ok)
        host_in = np.zeros((n, 8), np.float32)
        host_in[:, 0:2] = proj
        host_in[:, 2] = ok
        host_in[:, 3:6] = pos_last
        host_in[:, 6] = last2local
        host_in[:16, 7] = Tcw_pred.astype(np.float32).ravel()
        host_in[17, 7] = th
        out = np.asarray(self._fused_step(
            jnp.asarray(host_in), packed_last, packed_cur,
            jnp.asarray(lm_pos.astype(np.float32)),
            jnp.asarray(lm_normal.astype(np.float32)),
            jnp.asarray(lm_mind.astype(np.float32)),
            jnp.asarray(lm_maxd.astype(np.float32)),
            jnp.asarray(lm_desc), jnp.asarray(lm_valid)))
        n, p = len(ok), self._p
        o = 16
        T2 = out[:16].reshape(4, 4).astype(np.float32)
        best_j = out[o:o + n].astype(np.int64); o += n
        matched = out[o:o + n] > 0.5; o += n
        inlier1 = out[o:o + n] > 0.5; o += n
        idx2 = out[o:o + p].astype(np.int64); o += p
        visible = out[o:o + p] > 0.5; o += p
        already = out[o:o + p] > 0.5; o += p
        inlier2 = out[o:o + n] > 0.5; o += n
        n_in1 = int(out[o]); n_matched = int(out[o + 1])
        n_valid_cur = int(out[o + 2]); n_in2 = int(out[o + 3])
        return (T2, best_j, matched, inlier1, idx2, visible, already,
                inlier2, n_in1, n_matched, n_valid_cur, n_in2)
