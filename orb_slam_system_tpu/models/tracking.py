"""Tracking: the per-frame state machine.

Replaces reference Tracking (src/Tracking.cc): grayscale frames in, camera
poses out, driving initialization, motion-model / reference-KF tracking,
local-map tracking, keyframe decisions, and trajectory bookkeeping.

State machine values match include/Tracking.h:62-68. The fork's broken paths
are implemented with upstream-complete semantics per SURVEY.md §0.1:
  * TrackReferenceKeyFrame uses real descriptor matching (row 1),
  * sensor-specific initialization is dispatched correctly (row 4),
  * NeedNewKeyFrame compares against the reference keyframe's tracked-point
    count (row 5), and outlier pruning cannot null-deref (row 6).

Host/device split (SURVEY.md §3 boundary summary): the arena and all
sequential decisions live on host; every dense step — extraction,
matching, RANSAC init, pose LM — is one jitted device call over padded
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from orb_slam_system_tpu.config import Sensor, SlamConfig, TrackingState
from orb_slam_system_tpu.mapping.arena import FrameFeatures, MapArena
from orb_slam_system_tpu.models.frame import Frame, FrameBuilder
from orb_slam_system_tpu.ops import frustum as frustum_ops
from orb_slam_system_tpu.ops import matching
from orb_slam_system_tpu.solvers.initializer import (
    initialize_two_view,
    make_ransac_sets,
)
from orb_slam_system_tpu.solvers.pose_opt import pose_optimization
from orb_slam_system_tpu.utils import lie

LOCAL_MAP_SLOTS = 4096     # padded local-map point budget for device calls
MAX_LOCAL_KEYFRAMES = 80   # reference src/Tracking.cc:759-761
# Pipelined mode only: accept a chain result outright only above this
# inlier count; thinner-margin frames re-anchor via the classic path
# (the reference's own accept floor stays 30/50 — this is the extra
# safety margin the chain's approximations require).
CHAIN_MIN_FLOOR = 40       # hard inlier floor for accepting a chain frame
CHAIN_MARGIN_RATIO = 0.8   # ...and >= this fraction of the recent classic level
CHAIN_MIN_KEYFRAMES = 3    # map epoch maturity: init pair + >=1 tracked KF
# Classic frames required after every keyframe creation before the chain
# re-engages. Default 0: a measured A/B/C across three scenes (orbit,
# low-texture, low-parallax) showed the settle window contributed nothing
# once the SE(3) state-decay bug was fixed — identical OK counts and ATE
# with settle 0 vs 4. Kept as a knob for conservative deployments.
CHAIN_SETTLE_FRAMES = 0


@dataclasses.dataclass
class TrajectoryEntry:
    """Per-frame relative pose record (reference mlRelativeFramePoses etc.,
    src/Tracking.cc:239)."""

    Tcr: np.ndarray
    ref_kf_id: int
    timestamp: float
    lost: bool


class Tracker:
    def __init__(self, cfg: SlamConfig, arena: MapArena, local_mapper,
                 only_tracking: bool = False, place_rec=None):
        self.cfg = cfg
        self.arena = arena
        self.local_mapper = local_mapper
        self.place_rec = place_rec
        self.state = TrackingState.NO_IMAGES_YET
        self.only_tracking = only_tracking
        self.builder = FrameBuilder(cfg)
        # Mono init uses a 2x-features extractor (reference src/Tracking.cc:76-82).
        self.init_builder = FrameBuilder(
            cfg, n_features=2 * cfg.orb.n_features)
        from orb_slam_system_tpu.models.track_device import TrackPrograms
        self.programs = TrackPrograms(
            cfg, self.builder.extractor.n_slots, LOCAL_MAP_SLOTS,
            self.builder.bounds)
        self.scale_factors = self.builder.scale_factors
        self.inv_sigma2 = self.builder.inv_sigma2
        self.velocity: Optional[np.ndarray] = None
        self.last_frame: Optional[Frame] = None
        self.current: Optional[Frame] = None
        self.init_ref: Optional[Frame] = None
        # (ref_xy, cur_xy) matched pairs of the latest mono-init attempt
        # (FrameDrawer init-line overlay, src/FrameDrawer.cc:27-48).
        self.init_vis = None
        self.prev_matched: Optional[np.ndarray] = None
        self.ref_kf_id = -1
        self.last_kf_frame_id = -1
        self.last_kf_id = -1
        self.trajectory: list[TrajectoryEntry] = []
        self.max_frames = int(cfg.camera.fps)
        self.min_frames = 0
        self._ransac = jnp.asarray(
            make_ransac_sets(self.init_builder.extractor.n_slots, 200, 8, seed=0))
        self.n_inliers = 0
        self.local_kf_ids: list[int] = []
        # ((local_kf_ids tuple, arena.version) -> padded local-map block)
        self._local_block_cache = None
        self.frames_since_reloc = 10 ** 9
        # Valid-keypoint count of the current frame, reported by the fused
        # motion step so telemetry doesn't force a host materialization.
        self.last_n_valid = 0
        # Localization-mode VO flag (upstream mbVO, reference
        # src/Tracking.cc:51,530-571): true when the last frame tracked
        # mostly temporary depth points rather than map points.
        self.mb_vo = False
        # Per-stage timing of the steady-state path (SURVEY.md §5
        # observability): where a tracked frame's wall time goes —
        # host gathers vs the fused device round trip vs bookkeeping.
        from orb_slam_system_tpu.utils.metrics import StageTimer
        self.stage_ms = StageTimer()
        # Recent final-inlier counts of accepted chain frames (the
        # pipelined mode's quality-drop detector).
        self._chain_ninl_hist: list[int] = []
        # EMA of final inlier counts over OK frames (classic and chain):
        # the scene-relative reference level the chain margin gate
        # compares against (an absolute margin disabled the chain
        # entirely on scenes whose classic level sits below it).
        self._inl_ema: float = 0.0
        # Pipelined-mode outcome counters (telemetry + tests): how often
        # the chain accepted / re-anchored classically / deferred to a
        # classic keyframe re-track.
        self.chain_stats = {"accept": 0, "reject": 0, "kf": 0}
        self._remap_identity_dev = None  # cached device arange (chain_enqueue)
        self._chain_valid_cache = None   # (block pos id, device valid)
        # Relocalization funnel (attempts / db hits / viable PnP
        # candidates / accepts) — diagnoses LOST-and-never-recovers runs.
        from collections import Counter
        self.reloc_stats = Counter()
        # Async-mapper bounded-queue keyframe admission: while the worker
        # is busy, demanded keyframes are still enqueued as long as fewer
        # than this many are pending (upstream's stereo/RGB-D busy-path
        # semantics, src/Tracking.cc:609-615, extended to monocular —
        # see need_new_keyframe). 0/None disables (strict upstream
        # monocular behavior: drop the want when busy).
        self.kf_async_queue: Optional[int] = 3
        # Backpressure companion to kf_async_queue: when a keyframe is
        # demanded but the queue is already full, wait up to this many
        # seconds (arena lock RELEASED so the worker can drain) for a
        # slot instead of dropping the demand. On a mapper that keeps
        # pace with demand (~1 KF per 10 frames) the queue never fills
        # and this costs nothing; on a host where mapping cannot overlap
        # tracking it throttles tracking toward the
        # sync rate instead of letting keyframe demand be silently
        # suppressed — preserving map density and with it the loop
        # pipeline, matching the reference's quality-neutral
        # three-thread model (src/System.cc:63-82). 0 disables
        # (round-3 drop-on-full behavior).
        self.kf_async_wait_s: float = 10.0
        # If True, the backpressure drain releases as soon as every
        # queued keyframe's triangulation+fusion has landed (the
        # mapper's _expanding flag) instead of waiting for local BA /
        # culling / loop detection too — local BA then overlaps the next
        # tracking frames like the reference's concurrent LocalMapping
        # thread (src/LocalMapping.cc:28-53 + mbAbortBA). The round-4
        # attempt at this was measured NEGATIVE (1250-frame endurance:
        # 1024/1250 tracked, ATE 2.2 m) because process_pending gated BA
        # and culling on an EMPTY queue: a tracker released at expansion
        # refills the queue immediately under ~1 KF/frame structural
        # demand, so BA and culling STARVED and the map was never
        # polished or pruned. The worker restructure removed that
        # gate — one BA/cull pass per expansion batch is GUARANTEED
        # regardless of queue refill — which fixes the starvation
        # mechanism, so the default is now ON (validated by the
        # 1250-frame pipelined+async endurance gate). The release is
        # HEALTH-ADAPTIVE: frames under kf_drain_full_ratio x the
        # OK-frame inlier EMA wait for the full pipeline (see
        # _wait_for_mapper_space).
        self.kf_drain_release_on_expansion: bool = True
        # Inlier-vs-EMA ratio below which a backpressure drain waits for
        # the worker's FULL pipeline (BA/cull included) instead of
        # releasing at map expansion. 0 disables the adaptive fallback.
        self.kf_drain_full_ratio: float = 0.8
        # Health-aware sync: a keyframe created while n_inliers has
        # dropped below this fraction of the OK-frame inlier EMA drains
        # the async mapper before tracking continues (see
        # create_new_keyframe). 0 disables.
        self.kf_sync_flush_ratio: float = 0.6
        self.kf_wait_stats = {"waits": 0, "wait_s": 0.0, "timeouts": 0}
        # MACHINE-CHECKED correction-exclusion invariant (round 5): a
        # frame that observes arena.pose_epoch advance inside one of its
        # correction_unlocked() wait windows MUST re-anchor its pose
        # before committing — otherwise the Tcr_ref stored at frame end
        # marries a pre-correction pose to a corrected reference
        # keyframe, a silently poisoned relative pose the UpdateLastFrame
        # re-anchor reproduces every later frame (the round-4 "timing
        # lottery" race class). _frame_epoch records the epoch the
        # current frame's pose was last derived/re-anchored under; every
        # wait window refreshes it after handling an epoch move, and
        # _store_trajectory crashes loudly on a mismatch instead of
        # letting the poison propagate. Reference bar: upstream holds
        # Map::mMutexMapUpdate for the whole frame (src/Tracking.cc:179)
        # so this cannot happen there by construction.
        self._frame_epoch = -1
        self.epoch_violations = 0
        import os as _os
        self.epoch_assert = _os.environ.get(
            "ORB_SLAM_EPOCH_ASSERT", "1") != "0"
        # Opt-in conservative mode: frames that will create a keyframe are
        # re-tracked through the exact classic path before insertion.
        # Default off — with the chain state held on SE(3) (lie.se3_project)
        # a three-scene A/B/C showed chain-created keyframes are
        # ATE-equivalent to classic re-tracked ones (the earlier measured
        # degradation was the state-decay bug), and the reroute cost two
        # extra round trips per keyframe decision while its inlier trigger
        # over-fired (the chain's one-frame-stale local block undercounts
        # inliers ~10-15% vs classic, sitting under the 0.9 ratio).
        self.chain_classic_kf = False

    # ------------------------------------------------------------------
    # Entry point
    # ------------------------------------------------------------------

    def grab_monocular(self, img: np.ndarray, timestamp: float):
        """Reference GrabImageMonocular (src/Tracking.cc:152-169) +
        Track (:171-237). Returns Tcw (4x4) or None."""
        self.current = self.build_frame(img, timestamp)
        self.track()
        return None if self.current.Tcw is None else self.current.Tcw.copy()

    def build_frame(self, img: np.ndarray, timestamp: float):
        """Frame construction only (enqueues the extraction program; no
        fetch). Exposed so a streaming caller can pre-build frame i+1
        before frame i's tracking fetch — the extract enqueue then rides
        under the fused-step round trip (System.track_monocular_stream)."""
        builder = (
            self.init_builder
            if self.state in (TrackingState.NO_IMAGES_YET,
                              TrackingState.NOT_INITIALIZED)
            else self.builder
        )
        return builder.build(img, timestamp)

    def grab_prebuilt(self, frame):
        """Track a frame produced by build_frame."""
        self.current = frame
        self.track()
        return None if self.current.Tcw is None else self.current.Tcw.copy()

    def grab_stereo(self, img_left: np.ndarray, img_right: np.ndarray,
                    timestamp: float):
        """Reference GrabImageStereo (src/Tracking.cc:114-136)."""
        self.current = self.builder.build_stereo(img_left, img_right, timestamp)
        self.track()
        return None if self.current.Tcw is None else self.current.Tcw.copy()

    def grab_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float):
        """Reference GrabImageRGBD (src/Tracking.cc:138-150)."""
        self.current = self.builder.build_rgbd(img, depth, timestamp)
        self.track()
        return None if self.current.Tcw is None else self.current.Tcw.copy()

    def track(self):
        # Map mutex (reference Tracking.cc Track() takes mMutexMapUpdate):
        # the whole per-frame arena-touching section is serialized against
        # the async local-mapping worker; track_fused RELEASES it around
        # the fused device fetch so mapping stages overlap the round trip.
        # The OUTER correction_lock stays held across those windows:
        # ordinary mapping stages may interleave a frame, a map-wide pose
        # rewrite (loop correction / GBA apply) may not — upstream's
        # whole-frame mMutexMapUpdate semantics (see arena.correction_lock
        # doc; lock order: correction_lock > arena.lock).
        with self.arena.correction_lock, self.arena.lock:
            # Frame-span epoch anchor: the pose about to be computed
            # derives from map state read under THIS epoch (see the
            # _frame_epoch invariant doc in __init__).
            self._frame_epoch = self.arena.pose_epoch
            self._track_locked()

    def _track_locked(self):
        if self.state == TrackingState.NO_IMAGES_YET:
            self.state = TrackingState.NOT_INITIALIZED

        if self.state == TrackingState.NOT_INITIALIZED:
            # Sensor-correct dispatch (the fork always runs the mono path,
            # SURVEY.md §0.1 row 4 — upstream semantics restored here).
            if self.cfg.sensor == Sensor.MONOCULAR:
                self.monocular_initialization()
            else:
                self.stereo_initialization()
            self._store_trajectory()
            self.last_frame = self.current
            return

        ok = False
        fused_done = False
        if self.state == TrackingState.OK:
            self._reanchor_last_frame()
            with self.stage_ms.stage("replace_updated"):
                self._replace_updated_points(self.last_frame)
            if not self.only_tracking or not self.mb_vo:
                # Normal tracking (localization mode with enough map
                # matches follows the same path, reference :521-529).
                if self.track_fused():
                    ok = True
                    fused_done = True
                else:
                    if self.velocity is not None:
                        ok = self.track_with_motion_model()
                    if not ok:
                        ok = self.track_reference_keyframe()
            else:
                # Localization-mode VO (mbVO, reference :530-571): the last
                # frame tracked mostly temporary depth points — run BOTH
                # visual odometry (motion model over VO points) and
                # relocalization; a successful relocalization wins and
                # clears VO mode, otherwise keep the odometry solution.
                ok_mm = (self.track_with_motion_model()
                         if self.velocity is not None else False)
                saved = None
                if ok_mm:
                    # Save the FULL odometry solution incl. the outlier
                    # mask and inlier count (reference :545-553 keeps
                    # vbOutMM alongside TcwMM/vpMPsMM): a failed
                    # relocalization candidate's pose-opt overwrites
                    # cur.outlier, and restoring associations without
                    # their mask would let _clean_outlier_associations
                    # drop valid odometry matches at unrelated slots.
                    saved = (self.current.Tcw.copy(),
                             self.current.mp_ids.copy(),
                             dict(self.current.vo_points or {}),
                             self.current.outlier.copy(),
                             self.n_inliers)
                ok_reloc = self.relocalization()
                if ok_reloc:
                    self.mb_vo = False
                    self.frames_since_reloc = 0
                elif ok_mm:
                    (self.current.Tcw, mp_ids, vo,
                     outlier, self.n_inliers) = saved
                    self.current.mp_ids[:] = mp_ids
                    self.current.vo_points = vo
                    self.current.outlier[:] = outlier
                ok = ok_mm or ok_reloc
        else:
            ok = self.relocalization()
            if ok:
                self.frames_since_reloc = 0

        if fused_done:
            pass  # local map already tracked inside the fused program
        elif ok and not self.only_tracking:
            ok = self.track_local_map()
        elif ok and self.only_tracking and not self.mb_vo:
            # In localization mode the local map is only searched when the
            # frame has real map matches (reference :205-212).
            ok = self.track_local_map()

        self.state = TrackingState.OK if ok else TrackingState.LOST

        if ok:
            self._note_inliers(self.n_inliers)
            # Update motion model (reference :216-221).
            if self.last_frame is not None and self.last_frame.Tcw is not None:
                self.velocity = self.current.Tcw @ np.linalg.inv(
                    self.last_frame.Tcw)
            else:
                self.velocity = None
            self._clean_outlier_associations()
            with self.stage_ms.stage("kf_decision"):
                need_kf = (not self.only_tracking
                           and self.need_new_keyframe())
            if need_kf:
                with self.stage_ms.stage("kf_create"):
                    self.create_new_keyframe()
            self.frames_since_reloc += 1
        else:
            # Lost soon after initialization -> full reset
            # (reference :229-233, System reset protocol src/System.cc:274-278,
            # Tracking::Reset :887-927).
            if self.arena.n_keyframes() <= 5:
                self.reset()

        self._store_trajectory()
        self.last_frame = self.current

    # ------------------------------------------------------------------
    # Initialization (reference :305-428)
    # ------------------------------------------------------------------

    def monocular_initialization(self):
        cur = self.current
        if self.init_ref is None:
            if cur.n_valid > 100:
                self.init_ref = cur
                self.prev_matched = cur.feats.xy_und.copy()
            return
        if cur.n_valid <= 100:
            self.init_ref = None
            return
        ref = self.init_ref
        res = matching.search_for_initialization(
            jnp.asarray(ref.feats.xy_und), jnp.asarray(ref.feats.desc),
            jnp.asarray(ref.feats.valid), jnp.asarray(ref.feats.octave),
            jnp.asarray(ref.feats.angle),
            jnp.asarray(cur.feats.xy_und), jnp.asarray(cur.feats.desc),
            jnp.asarray(cur.feats.valid), jnp.asarray(cur.feats.octave),
            jnp.asarray(cur.feats.angle),
            prev_matched_xy=jnp.asarray(self.prev_matched),
        )
        idx2 = np.asarray(res.idx2)
        matched = idx2 >= 0
        n_matches = int(matched.sum())
        # FrameDrawer init overlay state (reference FrameDrawer keeps
        # mvIniKeys + mvIniMatches and DrawFrame :27-48 draws the match
        # lines while NOT_INITIALIZED): matched (ref_xy, cur_xy) pairs.
        self.init_vis = (ref.feats.xy_und[matched].copy(),
                         cur.feats.xy_und[idx2[matched]].copy())
        if n_matches < 100:           # reference :316-321
            self.init_ref = None
            self.init_vis = None
            return
        # Update prev_matched for drift tolerance (reference :323).
        self.prev_matched[matched] = cur.feats.xy_und[idx2[matched]]
        # Slot-aligned match arrays for the batched initializer.
        pts1 = ref.feats.xy_und
        pts2 = np.zeros_like(pts1)
        pts2[matched] = cur.feats.xy_und[idx2[matched]]
        init = initialize_two_view(
            jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(matched),
            self._ransac, jnp.asarray(self.cfg.camera.K),
        )
        if not bool(init.success):
            return
        good = np.asarray(init.is_triangulated) & matched
        if good.sum() < 50:
            return
        R21 = np.asarray(init.R21)
        t21 = np.asarray(init.t21)
        X = np.asarray(init.points3d)
        self._create_initial_map(ref, cur, idx2, good, R21, t21, X)

    def _create_initial_map(self, ref: Frame, cur: Frame, idx2, good,
                            R21, t21, X):
        """Reference CreateInitialMapMonocular (:350-428)."""
        from orb_slam_system_tpu.solvers.local_ba import (
            BAProblem, global_bundle_adjustment)

        arena = self.arena
        T1 = np.eye(4, dtype=np.float32)
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = R21
        T2[:3, 3] = t21
        kf1 = arena.new_keyframe(ref.id, ref.timestamp, T1, ref.feats)
        kf2 = arena.new_keyframe(cur.id, cur.timestamp, T2, cur.feats)
        for i in np.nonzero(good)[0]:
            j = idx2[i]
            mp = arena.new_point(X[i], cur.feats.desc[j], kf2.id, kf1.id)
            arena.add_observation(mp, kf1, int(i))
            arena.add_observation(mp, kf2, int(j))
            arena.compute_distinctive_descriptor(mp)
            arena.update_normal_and_depth(mp, self.scale_factors)
        arena.update_connections(kf1)
        arena.update_connections(kf2)
        # Global BA over the 2-view map (reference :386, 20 iterations).
        mp_list = list(arena.mps.values())
        P = len(mp_list)
        e_cam, e_pt, e_uv, e_is2 = [], [], [], []
        for p_i, mp in enumerate(mp_list):
            for kf_id, fidx in mp.obs.items():
                kf = arena.kfs[kf_id]
                e_cam.append(0 if kf_id == kf1.id else 1)
                e_pt.append(p_i)
                e_uv.append(kf.feats.xy_und[fidx])
                e_is2.append(self.inv_sigma2[kf.feats.octave[fidx]])
        prob = BAProblem(
            Tcw=jnp.asarray(np.stack([kf1.Tcw, kf2.Tcw])),
            cam_fixed=jnp.asarray(np.array([True, False])),
            cam_valid=jnp.asarray(np.ones(2, bool)),
            points=jnp.asarray(np.stack([mp.pos for mp in mp_list])),
            pt_valid=jnp.asarray(np.ones(P, bool)),
            e_cam=jnp.asarray(np.asarray(e_cam, np.int32)),
            e_pt=jnp.asarray(np.asarray(e_pt, np.int32)),
            e_uv=jnp.asarray(np.asarray(e_uv, np.float32)),
            e_inv_sigma2=jnp.asarray(np.asarray(e_is2, np.float32)),
            e_valid=jnp.asarray(np.ones(len(e_cam), bool)),
        )
        cam = self.cfg.camera
        Tcw_opt, X_opt, _ = global_bundle_adjustment(
            prob, cam.fx, cam.fy, cam.cx, cam.cy, n_iters=20)
        Tcw_opt = np.asarray(Tcw_opt)
        X_opt = np.asarray(X_opt)
        kf1.Tcw = Tcw_opt[0].copy()
        kf2.Tcw = Tcw_opt[1].copy()
        for p_i, mp in enumerate(mp_list):
            arena.set_point_pos(mp, X_opt[p_i])
        # Median-depth normalization (reference :388-405).
        depths = np.array([
            (kf1.Tcw[:3, :3] @ mp.pos + kf1.Tcw[:3, 3])[2]
            for mp in mp_list])
        median_depth = float(np.median(depths)) if len(depths) else -1.0
        if median_depth < 0 or kf2.n_tracked_points(arena, 1) < 100:
            self._reset_map()
            return
        inv_md = 1.0 / median_depth
        kf2.Tcw[:3, 3] *= inv_md
        for mp in mp_list:
            arena.set_point_pos(mp, mp.pos * inv_md)
            arena.update_normal_and_depth(mp, self.scale_factors)
        # Wire the current frame into the new map.
        cur.Tcw = kf2.Tcw.copy()
        cur.mp_ids = kf2.mp_ids.copy()
        cur.ref_kf_id = kf2.id
        self.ref_kf_id = kf2.id
        self.last_kf_frame_id = cur.id
        self.last_kf_id = kf2.id
        self.local_mapper.insert_keyframe(kf1.id)
        self.local_mapper.insert_keyframe(kf2.id)
        self.init_ref = None
        self.init_vis = None
        self.state = TrackingState.OK

    def stereo_initialization(self):
        """Upstream StereoInitialization semantics (reference
        src/Tracking.cc:275-303, dead code in the fork §0.1 row 4): a single
        frame with enough features seeds the map from depth, metric scale."""
        cur = self.current
        if cur.n_valid <= 500:
            return
        cam = self.cfg.camera
        cur.Tcw = np.eye(4, dtype=np.float32)
        kf = self.arena.new_keyframe(cur.id, cur.timestamp, cur.Tcw, cur.feats)
        created = 0
        for i in np.nonzero(cur.feats.valid)[0]:
            z = float(cur.depth[i]) if cur.depth is not None else -1.0
            if z <= 0:
                continue
            uv = cur.feats.xy_und[i]
            x3d = np.array([
                (uv[0] - cam.cx) / cam.fx * z,
                (uv[1] - cam.cy) / cam.fy * z,
                z], np.float32)
            mp = self.arena.new_point(x3d, cur.feats.desc[i], kf.id, kf.id)
            self.arena.add_observation(mp, kf, int(i))
            self.arena.update_normal_and_depth(mp, self.scale_factors)
            cur.mp_ids[i] = mp.id
            created += 1
        if created < 100:
            self._reset_map()
            return
        self.arena.update_connections(kf)
        cur.ref_kf_id = kf.id
        self.ref_kf_id = kf.id
        self.last_kf_frame_id = cur.id
        self.last_kf_id = kf.id
        self.local_mapper.insert_keyframe(kf.id)
        self.state = TrackingState.OK

    def _reset_map(self):
        self.arena.kfs.clear()
        self.arena.mps.clear()
        self.arena.dead_mps.clear()
        self.arena.dead_kfs.clear()
        self.arena.kf_origin_id = -1
        self.init_ref = None
        self.init_vis = None
        self.state = TrackingState.NOT_INITIALIZED

    # ------------------------------------------------------------------
    # Frame-to-frame tracking
    # ------------------------------------------------------------------

    def _replace_updated_points(self, frame: Optional[Frame]):
        """Reference CheckReplacedInLastFrame (src/Tracking.cc) + MapPoint::
        Replace keeping mpReplaced (src/MapPoint.cc:153-190): rebind each of
        the last frame's associations to the SURVIVING point by following
        the arena's replaced_by chain (multi-hop: a point fused twice still
        resolves), so motion-model tracking stays strong right after
        fusion/loop closure. Only dead ends (culled points) drop to -1."""
        if frame is None or frame.mp_ids is None:
            return
        for k, mid in enumerate(frame.mp_ids):
            mid = int(mid)
            if mid < 0 or mid in self.arena.mps:
                continue
            seen = set()
            cur = mid
            while cur not in self.arena.mps:
                rec = self.arena.dead_mps.get(cur)
                nxt = rec.replaced_by if rec is not None else -1
                if nxt < 0 or nxt in seen:
                    cur = -1
                    break
                seen.add(cur)
                cur = nxt
            frame.mp_ids[k] = cur

    def _gather_frame_points(self, frame: Frame):
        """Padded arrays of the map points attached to a frame's features —
        vectorized gather from the arena's columnar point snapshot (this
        runs every frame; the per-slot dict-lookup loop was a fixed ~1000-
        iteration Python cost per frame)."""
        n = frame.n_slots
        pos = np.zeros((n, 3), np.float32)
        rows, ok = self.arena.lookup_points(frame.mp_ids)
        if ok.any():
            pos[ok] = self.arena.point_columns()[1][rows[ok]]
        return pos, ok

    def _reanchor_last_frame(self):
        """Upstream UpdateLastFrame's pose re-anchor (src/Tracking.cc:
        475-481): mLastFrame.SetPose(Tlr * pRef->GetPose()). Between two
        frames the map can move under the tracker — local BA nudges the
        reference keyframe every insertion, and a loop correction /
        essential graph / global-BA apply rewrites EVERY pose (measured:
        the KITTI-scale drive's async GBA landed ~300 frames after the
        lap-2 closure and the un-re-anchored motion model lost tracking
        for the rest of the run). Recomputing the last frame's pose from
        its stored relative pose keeps the prediction in the map's
        CURRENT frame; when nothing moved this is an exact no-op."""
        last = self.last_frame
        if (last is None or last.Tcw is None or last.Tcr_ref is None
                or last.ref_kf_id < 0):
            return
        ref = self.arena.kfs.get(last.ref_kf_id)
        if ref is None:
            # Culled between frames (classic mode can churn keyframes
            # every few frames): walk the spanning tree past dead
            # keyframes via Tcp, exactly like trajectory export
            # (reference src/System.cc:341-345) — a silent no-op here
            # would leave the motion model in the pre-correction frame
            # after a GBA, the very bug this re-anchor fixes.
            from orb_slam_system_tpu.dataio.trajectory import \
                _resolve_ref_pose
            T_extra, live = _resolve_ref_pose(self.arena, last.ref_kf_id)
            if live is None:
                return
            last.Tcw = (last.Tcr_ref @ T_extra @ live.Tcw).astype(
                np.float32)
            return
        last.Tcw = (last.Tcr_ref @ ref.Tcw).astype(np.float32)

    def _vo_augment_last_frame(self, last, pos, ok):
        """Upstream UpdateLastFrame (src/Tracking.cc:475-508): in
        localization mode with a depth sensor, back-project temporary
        visual-odometry points for last-frame features that lost their map
        point — close points first (depth < ThDepth), at least 100 — so the
        motion model keeps matches through map-sparse stretches. Returns
        vo_mask marking augmented slots."""
        vo_mask = np.zeros(len(ok), bool)
        if (not self.only_tracking or last.depth is None
                or last.Tcw is None):
            return pos, ok, vo_mask
        cam = self.cfg.camera
        cand = np.nonzero(~ok & last.feats.valid & (last.depth > 0))[0]
        if len(cand) == 0:
            return pos, ok, vo_mask
        order = cand[np.argsort(last.depth[cand])]
        close = last.depth[order] < self.cfg.th_depth
        n_take = max(int(close.sum()), min(100, len(order)))
        take = order[:n_take]
        z = last.depth[take]
        xy = last.feats.xy_und[take]
        Twc = np.linalg.inv(last.Tcw)
        Xc = np.stack([(xy[:, 0] - cam.cx) / cam.fx * z,
                       (xy[:, 1] - cam.cy) / cam.fy * z, z], axis=1)
        pos = pos.copy()
        ok = ok.copy()
        pos[take] = Xc @ Twc[:3, :3].T + Twc[:3, 3]
        ok[take] = True
        vo_mask[take] = True
        return pos, ok, vo_mask

    def track_with_motion_model(self) -> bool:
        """Reference TrackWithMotionModel (:510-547), with the outlier
        pruning bug (§0.1 row 6) fixed. In localization mode, temporary
        depth-backprojected VO points stand in for lost map points and the
        mbVO flag records whether the map is effectively out of view."""
        cur = self.current
        last = self.last_frame
        Tcw_pred = (self.velocity @ last.Tcw).astype(np.float32)
        pos, ok = self._gather_frame_points(last)
        pos, ok, vo_mask = self._vo_augment_last_frame(last, pos, ok)
        if ok.sum() < 10:
            return False
        # Project into the predicted frame (host: tiny, data already here).
        cam = self.cfg.camera
        Xc = pos @ Tcw_pred[:3, :3].T + Tcw_pred[:3, 3]
        z = Xc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = (Xc[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9, z[:, None]))
        proj = proj * [cam.fx, cam.fy] + [cam.cx, cam.cy]
        ok = ok & (z > 0)
        # ONE fused device program: projection search (narrow + widened
        # window picked in-program) + 4x10 LM pose optimization, ONE fetch.
        # Both frames' features stay DEVICE-RESIDENT (packed buffers).
        T, best_j, matched, inlier, n_in, n_matched, n_valid = \
            self.programs.motion_step(
                proj, ok, pos, last.packed_dev, cur.packed_dev,
                Tcw_pred, th=15.0)
        self.last_n_valid = n_valid
        if n_matched < 20:
            return False
        # Attach matches to the current frame (VO-temp matches carry the
        # 3D position, not a map-point id); edge r maps last slot r to
        # current slot best_j[r].
        cur.mp_ids[:] = -1
        cur.vo_points = {}
        for r in np.nonzero(matched)[0]:
            slot = int(best_j[r])
            if vo_mask[r]:
                cur.vo_points[slot] = pos[r].copy()
            else:
                cur.mp_ids[slot] = last.mp_ids[r]
        cur.Tcw = T
        # Outlier pruning on current slots (reference :532-540 semantics).
        out = np.zeros(cur.n_slots, bool)
        out[best_j[matched & ~inlier]] = True
        cur.outlier = out
        cur.mp_ids[out] = -1
        for slot in list(cur.vo_points):
            if out[slot]:
                del cur.vo_points[slot]
        self.n_inliers = n_in
        if n_in < 10:
            return False
        if self.only_tracking:
            # mbVO: the frame is tracking the map only if >=10 inlier
            # matches are REAL map points (reference :541-545).
            n_map = int(np.sum((cur.mp_ids >= 0) & ~cur.outlier))
            self.mb_vo = n_map < 10
            return self.n_inliers >= 20 or n_map >= 10
        return True

    def track_reference_keyframe(self) -> bool:
        """Reference TrackReferenceKeyFrame (:442-473) with real matching
        (the fork's SearchByBoW is a stub, §0.1 row 1). Until the BoW direct
        index lands, node ids are uniform — the same masked program with the
        vocabulary constraint degenerating to global ratio-test matching."""
        cur = self.current
        kf = self.arena.kfs.get(self.ref_kf_id)
        if kf is None:
            return False
        has_mp = kf.mp_ids >= 0
        node_kf = np.where(has_mp, 0, -1).astype(np.int32)
        node_cur = np.zeros(cur.feats.n_slots, np.int32)
        if (kf.node_ids is not None and self.place_rec is not None
                and self.place_rec.ready):
            # The node constraint is meaningful only when BOTH sides carry
            # real direct-index nodes (upstream SearchByBoW walks the two
            # FeatureVectors in lock-step, src/ORBmatcher.cc:278-366):
            # compute the frame's nodes as Frame::ComputeBoW does
            # (src/Frame.cc:375-382). Round-5 bug fix: the keyframe's real
            # node ids were paired with all-zero frame nodes, so with a
            # loaded vocabulary this search matched (almost) nothing and
            # the post-init fallback chain collapsed into reset loops.
            _, node_cur_ids = self.place_rec.frame_bow(cur.feats.desc,
                                                       cur.feats.valid)
            if node_cur_ids is not None:
                node_kf = np.where(has_mp, kf.node_ids, -1).astype(np.int32)
                node_cur = np.asarray(node_cur_ids, np.int32)
        res = matching.search_by_node_id(
            jnp.asarray(kf.feats.desc), jnp.asarray(kf.feats.valid & has_mp),
            jnp.asarray(kf.feats.angle), jnp.asarray(node_kf),
            jnp.asarray(cur.feats.desc), jnp.asarray(cur.feats.valid),
            jnp.asarray(cur.feats.angle), jnp.asarray(node_cur))
        idx2 = np.asarray(res.idx2)
        rows = np.nonzero(idx2 >= 0)[0]
        if len(rows) < 15:
            return False
        cur.mp_ids[:] = -1
        cur.mp_ids[idx2[rows]] = kf.mp_ids[rows]
        T0 = (self.last_frame.Tcw if self.last_frame.Tcw is not None
              else kf.Tcw).astype(np.float32)
        return self._optimize_current_pose(T0, min_map_matches=10)

    def _optimize_current_pose(self, T0, min_map_matches=10) -> bool:
        """PoseOptimization + outlier pruning on the current frame.
        Temporary VO points (localization mode) contribute reprojection
        edges exactly like map points."""
        cur = self.current
        cam = self.cfg.camera
        pos, ok = self._gather_frame_points(cur)
        if cur.vo_points:
            for slot, p in cur.vo_points.items():
                if not ok[slot]:
                    pos[slot] = p
                    ok[slot] = True
        obs = cur.feats.xy_und
        is2 = self.inv_sigma2[cur.feats.octave]
        obs_ur = cur.feats.ur_or_neg()
        T_opt, inlier, n_in = pose_optimization(
            jnp.asarray(T0), jnp.asarray(pos), jnp.asarray(obs),
            jnp.asarray(is2.astype(np.float32)), jnp.asarray(ok),
            cam.fx, cam.fy, cam.cx, cam.cy,
            obs_ur=jnp.asarray(obs_ur.astype(np.float32)), bf=cam.bf)
        inlier = np.asarray(inlier)
        cur.Tcw = np.array(T_opt)
        # Prune outlier associations (reference :532-540, fixed semantics).
        out = ok & ~inlier
        cur.outlier = out
        cur.mp_ids[out] = -1
        if cur.vo_points:
            for slot in list(cur.vo_points):
                if out[slot]:
                    del cur.vo_points[slot]
        self.n_inliers = int(inlier.sum())
        return self.n_inliers >= min_map_matches

    # ------------------------------------------------------------------
    # Local map tracking (reference :549-695, :719-794)
    # ------------------------------------------------------------------

    def update_local_keyframes(self):
        """Reference UpdateLocalKeyFrames (:719-794): keyframes observing the
        current frame's points, plus covisibility/tree expansion, cap 80."""
        cur = self.current
        counts: dict[int, int] = {}
        for mid in cur.mp_ids:
            if mid < 0:
                continue
            mp = self.arena.mps.get(int(mid))
            if mp is None or mp.bad:
                continue
            for kf_id in mp.obs:
                counts[kf_id] = counts.get(kf_id, 0) + 1
        if not counts:
            return False
        # Relevance order: observing keyframes first, by shared-point
        # count (the reference's K1 set is NEVER dropped by the cap —
        # src/Tracking.cc:759-761 only breaks the neighbor EXPANSION at
        # 80), then covisibility/tree expansions in discovery order. A
        # plain sorted(set)[:80] kept the LOWEST ids, i.e. the OLDEST
        # keyframes, silently cutting the newest best-covising ones.
        obs_sorted = sorted(counts, key=lambda k: (-counts[k], k))
        local = list(obs_sorted)
        seen = set(local)

        def _add(kf_id):
            if kf_id not in seen:
                seen.add(kf_id)
                local.append(kf_id)

        for kf_id in obs_sorted:
            if len(local) > MAX_LOCAL_KEYFRAMES:
                break
            kf = self.arena.kfs.get(kf_id)
            if kf is None:
                continue
            for nb in self.arena.covisible_ordered(kf, 10):
                _add(nb)
            for c in kf.children:
                _add(c)
            if kf.parent >= 0:
                _add(kf.parent)
        sel = [k for k in local if k in self.arena.kfs][:MAX_LOCAL_KEYFRAMES]
        # Sorted for determinism AND cache stability: the local-block
        # cache keys on the tuple, and the same keyframe SET must produce
        # the same key regardless of discovery order.
        self.local_kf_ids = sorted(sel)
        self.ref_kf_id = max(counts, key=counts.get)
        cur.ref_kf_id = self.ref_kf_id
        return True

    def _gather_local_points(self):
        """Padded device arrays for the local map point set.

        Cached on (local keyframe set, arena.version): between keyframe
        insertions the map is immutable, so the block — previously rebuilt
        with ~|local KFs| x n_slots dict lookups EVERY frame — is reused
        verbatim. Any mutator that can move/retire/re-describe a point
        bumps arena.version (see mapping/arena.py)."""
        key = (tuple(self.local_kf_ids), self.arena.version)
        if self._local_block_cache is not None \
                and self._local_block_cache[0] == key:
            return self._local_block_cache[1]
        id_arrays = [self.arena.kfs[k].mp_ids for k in self.local_kf_ids
                     if k in self.arena.kfs]
        if id_arrays:
            all_ids = np.concatenate(id_arrays)
            uniq = np.unique(all_ids[all_ids >= 0])
        else:
            uniq = np.empty(0, np.int64)
        # Vectorized gather from the arena's columnar snapshot (this
        # rebuilds after every map mutation — in pipelined mode that can
        # be every frame, so the former per-point dict loop mattered).
        # ONE cols snapshot for both the lookup and the gathers: a second
        # point_columns() call could see a rebuilt (smaller) table if the
        # mapper ran in between.
        cols = self.arena.point_columns()
        ids_sorted = cols[0]
        if len(ids_sorted):
            srch = np.clip(np.searchsorted(ids_sorted, uniq), 0,
                           len(ids_sorted) - 1)
            found = ids_sorted[srch] == uniq
        else:
            srch = np.zeros(len(uniq), np.int64)
            found = np.zeros(len(uniq), bool)
        sel_rows = srch[found]
        cand_ids = uniq[found]
        if len(cand_ids) > LOCAL_MAP_SLOTS:
            # The device block is fixed-size where the reference's local
            # map is unbounded; when the cap binds, drop the WEAKEST-
            # observED points (ascending-id truncation dropped the newest
            # triangulations — exactly the points near the tracking
            # front). Selection depends only on (kf set, arena.version),
            # so the block cache key stays valid.
            nobs = cols[5][sel_rows]
            keep = np.lexsort((-cand_ids, -nobs))[:LOCAL_MAP_SLOTS]
            keep.sort()      # ascending-id layout within the block
            sel_rows = sel_rows[keep]
            cand_ids = cand_ids[keep]
        ids = [int(m) for m in cand_ids]
        P = LOCAL_MAP_SLOTS
        pos = np.zeros((P, 3), np.float32)
        normal = np.zeros((P, 3), np.float32)
        mind = np.zeros(P, np.float32)
        maxd = np.zeros(P, np.float32)
        desc = np.zeros((P, 8), np.uint32)
        valid = np.zeros(P, bool)
        if len(ids):
            k = len(ids)
            pos[:k] = cols[1][sel_rows]
            normal[:k] = cols[6][sel_rows]
            mind[:k] = 0.8 * cols[3][sel_rows]   # reference band
            maxd[:k] = 1.2 * cols[4][sel_rows]   # (src/MapPoint.cc:341-351)
            desc[:k] = cols[2][sel_rows]
            valid[:k] = True
        # Device-put ONCE per cache epoch: re-uploading the block's five
        # arrays every frame cost per-transfer latency.
        import jax.numpy as jnp
        out = (ids, jnp.asarray(pos), jnp.asarray(normal), jnp.asarray(mind),
               jnp.asarray(maxd), jnp.asarray(desc), valid)
        self._local_block_cache = (key, out)
        return out

    def track_local_map(self) -> bool:
        if not self.update_local_keyframes():
            return False
        cur = self.current
        cam = self.cfg.camera
        ids, pos, normal, mind, maxd, desc, valid = self._gather_local_points()
        if not ids:
            return False
        # Points already attached to the current frame: count as visible+found
        # and exclude from the search (reference SearchLocalPoints :661-678).
        attached = {int(m) for m in cur.mp_ids if m >= 0}
        in_frame = np.array([mid in attached for mid in ids] +
                            [False] * (LOCAL_MAP_SLOTS - len(ids)))
        # Pre-attached edges (motion-model matches + localization-mode VO
        # points) for the fused pose optimization.
        Xw_pre, ok_pre = self._gather_frame_points(cur)
        if cur.vo_points:
            for slot, p in cur.vo_points.items():
                if not ok_pre[slot]:
                    Xw_pre[slot] = p
                    ok_pre[slot] = True
        # ONE fused device program: frustum check + projection search +
        # association scatter + pose LM, ONE fetch.
        T, idx2, visible, inlier, n_in = self.programs.localmap_step(
            pos, normal, mind, maxd, desc, valid & ~in_frame,
            Xw_pre, ok_pre, cur.packed_dev,
            cur.mp_ids >= 0, cur.Tcw)
        for k, mid in enumerate(ids):
            mp = self.arena.mps.get(mid)
            if mp is not None and (visible[k] or in_frame[k]):
                mp.n_visible += 1
        for k in np.nonzero(idx2 >= 0)[0]:
            cur.mp_ids[idx2[k]] = ids[k]
        cur.Tcw = T
        # Outlier pruning over the optimized edge set.
        edge_ok = (cur.mp_ids >= 0)
        if cur.vo_points:
            edge_ok = edge_ok.copy()
            for slot in cur.vo_points:
                edge_ok[slot] = True
        out = edge_ok & ~inlier
        cur.outlier = out
        cur.mp_ids[out] = -1
        for slot in list(cur.vo_points or ()):
            if out[slot]:
                del cur.vo_points[slot]
        self.n_inliers = n_in
        # IncreaseFound for inlier points (reference :567-571).
        for k, mid in enumerate(cur.mp_ids):
            if mid >= 0 and not cur.outlier[k]:
                mp = self.arena.mps.get(int(mid))
                if mp is not None:
                    mp.n_found += 1
        # Acceptance gates (reference :570-575).
        if self.frames_since_reloc < self.max_frames and self.n_inliers < 50:
            return False
        return self.n_inliers >= 30

    def track_fused(self):
        """One-round-trip steady-state tracking: motion-model + local-map stages in
        ONE device program (track_device.fused_step). The local-map block
        comes from the PREVIOUS frame's final associations — the reference
        rebuilds the local keyframe set from the current frame's motion
        matches (src/Tracking.cc:719-794); here it lags one frame, and
        update_local_keyframes() runs on this frame's FINAL associations to
        prepare the next frame. Returns True/False like the two-step path,
        or None to request the exact two-step fallback (weak result or
        insufficient prior state)."""
        if (self.only_tracking or self.velocity is None
                or not self.local_kf_ids or self.last_frame is None):
            return None
        cur, last = self.current, self.last_frame
        t = self.stage_ms
        with t.stage("gather_local"):
            ids, pos_lm, normal, mind, maxd, desc_lm, valid_lm = \
                self._gather_local_points()
        if not ids:
            return None
        with t.stage("gather_frame"):
            pos, ok = self._gather_frame_points(last)
        if ok.sum() < 10:
            return None
        cam = self.cfg.camera
        with t.stage("prep"):
            Tcw_pred = (self.velocity @ last.Tcw).astype(np.float32)
            Xc = pos @ Tcw_pred[:3, :3].T + Tcw_pred[:3, 3]
            z = Xc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                proj = Xc[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9,
                                            z[:, None])
            proj = proj * [cam.fx, cam.fy] + [cam.cx, cam.cy]
            ok = ok & (z > 0)
            # last slot -> local block slot (identity known pre-call).
            ids_arr = np.asarray(ids, np.int64)
            order = np.argsort(ids_arr)
            sorted_ids = ids_arr[order]
            li = np.clip(np.searchsorted(sorted_ids, last.mp_ids), 0,
                         len(sorted_ids) - 1)
            found = (sorted_ids[li] == last.mp_ids) & (last.mp_ids >= 0)
            last2local = np.where(found, order[li], -1).astype(np.int32)
        # Inputs are gathered; release the map mutex for the device round
        # trip so the async mapping worker's host phases overlap it.
        with t.stage("fused_device"), self.arena.unlocked():
            (T2, best_j, matched, inlier1, idx2, visible, already, inlier2,
             n_in1, n_matched, n_valid, n_in2) = self.programs.fused_step(
                proj, ok, pos, last.packed_dev, cur.packed_dev, Tcw_pred,
                pos_lm, normal, mind, maxd, desc_lm, valid_lm, last2local)
        self.last_n_valid = n_valid
        if n_matched < 20 or n_in1 < 10:
            return None
        # Acceptance gates first (reference :570-575): a weak fused result
        # falls back to the exact two-step path with NO state mutated (the
        # stale local block may be the culprit).
        if n_in2 < 30 or (self.frames_since_reloc < self.max_frames
                          and n_in2 < 50):
            return None
        # Motion-stage bookkeeping: only inlier edges attach (the two-step
        # path attaches then prunes — same end state).
        with t.stage("bookkeeping"):
            cur.mp_ids[:] = -1
            cur.vo_points = {}
            good = matched & inlier1
            cur.mp_ids[best_j[good]] = last.mp_ids[good]
            # Local-map bookkeeping (mirrors track_local_map).
            for k in np.nonzero(visible | already)[0]:
                if k < len(ids):
                    mp = self.arena.mps.get(ids[k])
                    if mp is not None:
                        mp.n_visible += 1
            for k in np.nonzero(idx2 >= 0)[0]:
                cur.mp_ids[idx2[k]] = ids[k]
            cur.Tcw = T2
            edge_ok = cur.mp_ids >= 0
            out = edge_ok & ~inlier2
            cur.outlier = out
            cur.mp_ids[out] = -1
            self.n_inliers = n_in2
            mps = self.arena.mps
            for mid in cur.mp_ids[(cur.mp_ids >= 0) & ~cur.outlier]:
                mp = mps.get(int(mid))
                if mp is not None:
                    mp.n_found += 1
        # Refresh local keyframes + reference KF from the FINAL
        # associations (feeds the next frame's fused block).
        with t.stage("update_local_kfs"):
            self.update_local_keyframes()
        return True

    # ------------------------------------------------------------------
    # Pipelined (device-state) steady-state tracking. The host enqueues
    # frame k+1's chain step before frame k's results arrive (they are
    # fetched asynchronously one frame late), so the round trip overlaps
    # the next frame's device work — the serial fetch dependency that
    # capped the streaming mode at one frame per round trip is gone.
    # Bookkeeping
    # runs one frame late with identical per-frame semantics; weak results
    # trigger the exact classic fallback plus a state resync.
    # ------------------------------------------------------------------

    def chain_ready(self) -> bool:
        # Maturity gates: scale-fragile epochs run the exact classic path.
        # (a) Map epoch maturity — keyframes CREATED since the current map
        # epoch (monotonic next_kf_id - kf_origin_id, NOT the culled live
        # population, which stays small forever on compact scenes):
        # >= 3 means the init pair plus a tracked keyframe exist and local
        # BA has refined the map at least once. (b) Keyframe settling —
        # every keyframe creation triangulates FRESH points whose depths
        # are still fragile (the measured low-parallax failure mode: chain
        # frames slipping in right after a keyframe can swing the
        # reconstruction); require the last keyframe to be at least
        # CHAIN_SETTLE_FRAMES frames old so its points were BA'd/culled.
        a = self.arena
        created = a.next_kf_id - a.kf_origin_id if a.kf_origin_id >= 0 else 0
        settled = (self.last_frame is not None
                   and self.last_frame.id - self.last_kf_frame_id
                   >= CHAIN_SETTLE_FRAMES)
        # The keyframe-count maturity floor guards MONOCULAR scale
        # fragility (triangulated depths settle only after the init pair
        # plus a tracked keyframe were BA'd). Stereo/RGB-D maps are metric
        # from the depth-seeded init keyframe (upstream
        # StereoInitialization), so the init keyframe alone suffices — a
        # gentle stereo sequence can legitimately never need a second
        # keyframe, which must not keep the chain disarmed forever.
        min_created = (CHAIN_MIN_KEYFRAMES
                       if self.cfg.sensor == Sensor.MONOCULAR else 1)
        return (self.state == TrackingState.OK and not self.only_tracking
                and self.velocity is not None and bool(self.local_kf_ids)
                and self.last_frame is not None
                and self.last_frame.Tcw is not None
                and self.last_frame.packed_dev is not None
                and created >= min_created and settled)

    def chain_block(self):
        """(ids, device 6-tuple) local-map block for the chain program."""
        ids, pos, normal, mind, maxd, desc, valid = \
            self._gather_local_points()
        # The block arrays are device-cached per epoch by
        # _gather_local_points, but `valid` is kept numpy there (host
        # consumers); device-cache its upload alongside, keyed by the SAME
        # (local keyframe set, arena.version) key as the block cache —
        # converting it fresh every frame was one of the four per-frame
        # device_puts (~2 ms each) in the pipelined loop, and keying on
        # array identity made correctness depend incidentally on the
        # block cache never mutating its arrays in place.
        key = (tuple(self.local_kf_ids), self.arena.version)
        cache = self._chain_valid_cache
        if cache is None or cache[0] != key:
            cache = self._chain_valid_cache = (key, jnp.asarray(valid))
        return ids, (pos, normal, mind, maxd, desc, cache[1])

    def chain_bootstrap(self):
        """Build the device tracking state from the host state (entry into
        pipelined mode, or resync after a fallback): returns
        (T_prev_dev, T_last_dev, assoc_dev, ids, block)."""
        # Re-anchor first (upstream UpdateLastFrame semantics): a loop
        # correction / GBA apply between frames moved the map, and the
        # device state must start from the CORRECTED last pose or every
        # chained projection misses. The velocity stays valid: it is a
        # camera-relative motion, invariant to a rigid map move.
        self._reanchor_last_frame()
        ids, block = self.chain_block()
        last = self.last_frame
        # Exact (SVD) SE(3) projection: chain-accepted poses stored in the
        # host bookkeeping carry one step of f32 rounding off SO(3); the
        # device state must start clean or the chain's transpose-trick
        # inverse amplifies the defect (see lie.se3_project).
        T_last = lie.se3_project_np(last.Tcw).astype(np.float32)
        # velocity = T_last @ inv(T_prev)  =>  T_prev = inv(velocity) @ T_last
        T_prev = lie.se3_project_np(
            np.linalg.inv(self.velocity) @ T_last).astype(np.float32)
        ids_arr = np.asarray(ids, np.int64)
        li = np.clip(np.searchsorted(ids_arr, last.mp_ids), 0,
                     max(len(ids_arr) - 1, 0))
        found = np.zeros(last.mp_ids.shape, bool)
        if len(ids_arr):
            found = (ids_arr[li] == last.mp_ids) & (last.mp_ids >= 0)
        assoc = np.where(found, li, -1).astype(np.int32)
        return (jnp.asarray(T_prev), jnp.asarray(T_last),
                jnp.asarray(assoc), ids, block)

    def chain_enqueue(self, frame, state, prev_packed, prev_ids):
        """Enqueue one chain step for `frame` (NO fetch) and issue the
        async copies of its outputs. state = (T_prev_dev, T_last_dev,
        assoc_dev). Returns (ids, new_state, packed_out)."""
        ids, block = self.chain_block()
        if prev_ids is ids or prev_ids == ids:
            # Identity remap: reuse ONE device-resident array instead of
            # uploading a fresh arange per frame (the block is unchanged on
            # most steady-state frames).
            remap = self._remap_identity_dev
            if remap is None:
                remap = self._remap_identity_dev = jnp.asarray(
                    np.arange(LOCAL_MAP_SLOTS, dtype=np.int32))
        else:
            # Map the previous block's slots into the current block.
            ids_arr = np.asarray(ids, np.int64)
            prev_arr = np.asarray(prev_ids, np.int64)
            remap = np.full(LOCAL_MAP_SLOTS, -1, np.int32)
            if len(ids_arr) and len(prev_arr):
                pos = np.clip(np.searchsorted(ids_arr, prev_arr), 0,
                              len(ids_arr) - 1)
                hit = ids_arr[pos] == prev_arr
                remap[:len(prev_arr)][hit] = pos[hit].astype(np.int32)
        T_prev, T_last, assoc = state
        T_last_o, T_cur_o, assoc_o, packed_out = self.programs.chain_step(
            T_prev, T_last, assoc, remap, prev_packed, frame.packed_dev,
            block)
        # The caller fetches packed_out on a background thread
        # (System.track_monocular_pipelined), which overlaps the blocking
        # round trip with the main thread's enqueues.
        return ids, (T_last_o, T_cur_o, assoc_o), packed_out

    def chain_process(self, frame, ids, packed_out) -> Optional[bool]:
        """Decode a chain step's (async-fetched) results and run the same
        bookkeeping as track_fused, one frame late. Returns True on
        success or None when the result is weak — the caller then re-runs
        this frame through the exact classic path and resyncs."""
        t = self.stage_ms
        # Frame-span epoch anchor for the chain commit path (the caller
        # holds correction_lock and has already discarded results whose
        # enqueue-time epoch went stale; from here the _frame_epoch
        # invariant takes over — see __init__).
        self._frame_epoch = self.arena.pose_epoch
        # The async copy normally landed a frame ago; if not, the blocking
        # decode releases the map mutex so the mapper keeps working.
        with t.stage("chain_decode"), self.arena.unlocked():
            (T2, assoc, visible, already, n_in1, n_matched, n_valid,
             n_in2, close_counts) = self.programs.decode_chain_out(
                 packed_out)
        self.last_n_valid = n_valid
        if n_matched < 20 or n_in1 < 10:
            self.chain_stats["reject"] += 1
            return None
        if n_in2 < 30 or (self.frames_since_reloc < self.max_frames
                          and n_in2 < 50):
            self.chain_stats["reject"] += 1
            return None
        # Margin gates beyond the reference's accept thresholds: the
        # chain's approximations (motion candidates restricted to the
        # local block, one-frame-stale block and keyframe cadence) cost a
        # little robustness margin per frame, which only matters when the
        # margin is already thin — there, re-anchor through the exact
        # classic path instead of accepting. (a) scene-relative: the chain
        # frame must hold CHAIN_MARGIN_RATIO of the recent OK-frame inlier
        # level (_inl_ema; an earlier ABSOLUTE margin of 90 disabled the
        # chain on any scene whose classic level sits below it), with a
        # CHAIN_MIN_FLOOR hard floor; (b) a sharp drop vs the recent
        # chain-accept mean.
        hist = self._chain_ninl_hist
        margin = max(CHAIN_MIN_FLOOR, CHAIN_MARGIN_RATIO * self._inl_ema)
        if n_in2 < margin:
            hist.clear()
            self.chain_stats["reject"] += 1
            return None
        if len(hist) >= 3 and n_in2 < 0.6 * (sum(hist) / len(hist)):
            hist.clear()
            self.chain_stats["reject"] += 1
            return None
        hist.append(n_in2)
        if len(hist) > 5:
            hist.pop(0)
        cur = frame
        self.current = frame   # update_local_keyframes/need_new_keyframe
        self.n_inliers = n_in2
        # Stereo/RGB-D keyframe decisions read the close-point counts the
        # chain program computed on device (the depth column never comes
        # to the host for non-keyframe frames). Set ONLY once the result
        # passed the accept gates: a rejected chain result's counts come
        # from a collapsed association, and the classic fallback's
        # keyframe decision must recompute from the frame's (then
        # materialized) depth column instead of short-circuiting on them.
        frame.chain_close_counts = close_counts
        # Conservative knob only: re-track keyframe frames through the
        # exact classic path before insertion. By default keyframes are
        # created directly from chain results in chain_finish — measured
        # ATE-equivalent on three scene classes once the chain state is
        # projected onto SE(3) each step (the historical degradation was
        # the state-decay bug), whereas this reroute costs two extra trips
        # per trigger and over-fires (the chain's one-frame-stale block
        # undercounts inliers ~10-15%, so n_in2 < 0.9*n_ref fires almost
        # every frame; keyframe culling absorbs the churn either way,
        # matching the reference's own mapper-throttled behavior).
        if (self.chain_classic_kf and not self.only_tracking
                and self.need_new_keyframe()):
            self._chain_ninl_hist.clear()
            self.chain_stats["kf"] += 1
            # The classic re-track recomputes the association; let its
            # keyframe decision use the fresh depth column, not the
            # chain association's counts.
            frame.chain_close_counts = None
            return "kf"   # classic re-track; pipeline state stays valid
        with t.stage("chain_bookkeeping"):
            ids_pad = np.full(LOCAL_MAP_SLOTS, -1, np.int64)
            ids_pad[:len(ids)] = ids
            cur.mp_ids[:] = -1
            cur.vo_points = {}
            sel = assoc >= 0
            cur.mp_ids[sel] = ids_pad[assoc[sel]]
            cur.Tcw = T2
            cur.outlier = np.zeros(cur.n_slots, bool)  # pruned in-program
            self.n_inliers = n_in2
            mps = self.arena.mps
            for k in np.nonzero(visible | already)[0]:
                if k < len(ids):
                    mp = mps.get(ids[k])
                    if mp is not None:
                        mp.n_visible += 1
            for mid in cur.mp_ids[cur.mp_ids >= 0]:
                mp = mps.get(int(mid))
                if mp is not None:
                    mp.n_found += 1
            # Points replaced/retired by the mapper between enqueue and
            # processing: follow tombstones / detach (classic path does
            # this at the next frame's entry).
            self._replace_updated_points(cur)
        with t.stage("update_local_kfs"):
            self.update_local_keyframes()
        self.chain_stats["accept"] += 1
        return True

    def _note_inliers(self, n: int):
        """Fold an OK frame's final inlier count into the scene-relative
        reference level the chain margin gate uses."""
        self._inl_ema = (float(n) if self._inl_ema == 0.0
                         else 0.7 * self._inl_ema + 0.3 * float(n))

    def chain_finish(self, frame, ok: bool):
        """Postlude identical to _track_locked's OK/LOST handling for a
        chain-processed frame."""
        self.current = frame
        self.state = TrackingState.OK if ok else TrackingState.LOST
        if ok:
            self._note_inliers(self.n_inliers)
            if self.last_frame is not None and self.last_frame.Tcw is not None:
                self.velocity = frame.Tcw @ np.linalg.inv(
                    self.last_frame.Tcw)
            else:
                self.velocity = None
            self._clean_outlier_associations()
            with self.stage_ms.stage("kf_decision"):
                need_kf = (not self.only_tracking
                           and self.need_new_keyframe())
            if need_kf:
                with self.stage_ms.stage("kf_create"):
                    self.create_new_keyframe()
                self.chain_stats["kf_direct"] = (
                    self.chain_stats.get("kf_direct", 0) + 1)
            self.frames_since_reloc += 1
        else:
            if self.arena.n_keyframes() <= 5:
                self.reset()
        self._store_trajectory()
        self.last_frame = frame

    def _clean_outlier_associations(self):
        cur = self.current
        cur.mp_ids[cur.outlier] = -1

    # ------------------------------------------------------------------
    # Keyframe decision / creation (reference :578-659)
    # ------------------------------------------------------------------

    def need_new_keyframe(self) -> bool:
        if self.only_tracking:
            return False
        n_kfs = self.arena.n_keyframes()
        if (self.frames_since_reloc < self.max_frames and n_kfs > self.max_frames):
            return False
        min_obs = 3 if n_kfs > 2 else 2
        ref = self.arena.kfs.get(self.ref_kf_id)
        n_ref_matches = (ref.n_tracked_points(self.arena, min_obs)
                         if ref is not None else 0)
        frames_since_kf = self.current.id - self.last_kf_frame_id
        mapper_idle = self.local_mapper.accepting()
        c1a = frames_since_kf >= self.max_frames
        c1b = frames_since_kf >= self.min_frames and mapper_idle
        # Stereo/RGBD: count tracked vs. trackable close points
        # (reference :590-600).
        c1c = False
        if self.cfg.sensor != Sensor.MONOCULAR:
            n_tracked_close, n_nontracked_close = self._close_point_counts()
            need_close = (n_tracked_close < 100) and (n_nontracked_close > 70)
            c1c = need_close
        # Upstream-complete condition (§0.1 row 5): current inliers vs the
        # reference KF's tracked points; ratio 0.9 mono, 0.75 stereo/RGBD.
        th_ratio = 0.9 if self.cfg.sensor == Sensor.MONOCULAR else 0.75
        c2 = ((self.n_inliers < n_ref_matches * th_ratio) or c1c) \
            and self.n_inliers > 15
        # Bounded-queue keyframe admission (async mode). The reference's
        # c1b gates on mapper idleness BEFORE the demand is even
        # registered (src/Tracking.cc:609-615): with a slow/contended
        # mapper the demand signal itself is suppressed (busy -> no c1b
        # -> no want), insertion starves, keyframes thin out, the
        # reference-KF tracked count drops, and the decision settles
        # into a sparse self-reinforcing equilibrium — the 1250-frame
        # async endurance run degraded from cm-class to meter-class ATE
        # this way. Upstream's own stereo/RGB-D branch already has the
        # answer: when the mapper is busy it still ACCEPTS the keyframe
        # into the queue as long as fewer than 3 are pending
        # (src/Tracking.cc:609-615, interruptBA + queue<3); only the
        # monocular branch refuses outright. With kf_async_queue set,
        # demand is measured without the idleness precondition and the
        # same bounded-queue admission applies to all sensors — the
        # worker catches up, tracking never blocks.
        c1b_demand = (frames_since_kf >= self.min_frames
                      if self.kf_async_queue else c1b)
        if (c1a or c1b_demand or c1c) and c2:
            if mapper_idle:
                return True
            self.local_mapper.interrupt_ba()
            if self.kf_async_queue:
                if len(self.local_mapper.queue) < self.kf_async_queue:
                    return True
                # Queue full: DRAIN the backlog (backpressure), for every
                # demand. Two measured negative results stand behind the
                # unconditional policy (do not re-litigate without new
                # evidence): (a) dropping healthy-frame demands — upstream's
                # own busy-mapper monocular behavior — collapses the
                # 1250-frame endurance at every NEW-TERRITORY transition:
                # the frame still looks healthy (inliers ride the old
                # segment's map) while the demanded keyframes are the
                # ones that must map the territory ahead, and once LOST
                # the post-reloc keyframe block window turns it into a
                # death spiral (keyframes froze at 31/69 of ~300 in two
                # gate runs); (b) a brief GIL yield before the drop does
                # not change (a). c2 fires near-continuously by
                # construction, so this admits keyframes at sync-mapping
                # quality and throttles tracking toward the sync rate
                # exactly when the host cannot overlap mapping — on the
                # deploy target the queue never fills and the policy
                # costs nothing.
                if self.kf_async_wait_s > 0 and self._wait_for_mapper_space():
                    return True
            return False
        return False

    def _wait_for_mapper_space(self) -> bool:
        """Backpressure: the queue is full at a keyframe demand — the
        mapper is NOT keeping pace with tracking. Drain it completely
        (bounded by kf_async_wait_s, arena lock released so the worker
        can run) rather than freeing one slot: a one-slot wait leaves
        mapping perpetually kf_async_queue keyframes stale, which the
        scale-fragile early map and degraded segments cannot tolerate
        (tracking went LOST at map scale this way in the endurance
        runs). Draining converges to synchronous quality exactly when
        resources demand it and costs nothing when the mapper keeps pace
        with demand (~1 KF/10 frames). Returns True when at least one slot is
        free; never raises."""
        import time as _time
        mapper = self.local_mapper
        deadline = _time.monotonic() + self.kf_async_wait_s
        t0 = _time.monotonic()
        self.kf_wait_stats["waits"] += 1
        # The backlog being drained can itself contain a loop closure:
        # release the correction lock (held for this frame's span) along
        # with arena.lock so the worker can run the correction instead of
        # deadlocking against this wait. If one lands, re-anchor the
        # current frame's pose through its pre-wait relative pose to the
        # reference keyframe — otherwise the keyframe about to be created
        # (and the Tcr_ref stored at frame end) would carry a
        # pre-correction pose into the corrected map.
        cur = self.current
        epoch0 = self.arena.pose_epoch
        ref0 = self.arena.kfs.get(self.ref_kf_id)
        Tcr_pre = None
        if (cur is not None and cur.Tcw is not None and ref0 is not None):
            Tcr_pre = cur.Tcw @ np.linalg.inv(ref0.Tcw)
        # Default: release as soon as the backlog's EXPANSIONS land
        # (_expanding) — the worker's refinement phase (local BA /
        # culling / loop detection, guaranteed once per expansion batch
        # by the round-5 worker restructure) then overlaps the next
        # tracking frames, matching upstream's concurrent LocalMapping
        # thread. HEALTH-ADAPTIVE: a frame whose inliers sit below
        # kf_drain_full_ratio x the OK-frame EMA waits for the FULL
        # pipeline instead — in degraded segments the next frames must
        # track a POLISHED map, not one-batch-stale raw triangulations
        # (a round-5 endurance run lost tracking entering a degraded
        # segment with expansion-release unconditional; the chain margin
        # gate already re-routes such frames to classic tracking, so on
        # healthy stretches this almost never fires and the fps win
        # stands). kf_drain_release_on_expansion=False restores the full
        # drain (_busy), the deterministic round-4 behavior.
        fragile = self.n_inliers < self.kf_drain_full_ratio * max(
            self._inl_ema, 1.0)
        release_at_expansion = (self.kf_drain_release_on_expansion
                                and not fragile)
        if fragile:
            self.kf_wait_stats["full_drains"] = (
                self.kf_wait_stats.get("full_drains", 0) + 1)
        with self.arena.unlocked(), self.arena.correction_unlocked():
            while ((mapper.queue
                    or (mapper._expanding if release_at_expansion
                        else mapper._busy))
                   and _time.monotonic() < deadline):
                _time.sleep(0.002)
        if self.arena.pose_epoch != epoch0:
            if Tcr_pre is not None:
                ref = self.arena.kfs.get(self.ref_kf_id)
                if ref is not None:
                    cur.Tcw = (Tcr_pre @ ref.Tcw).astype(np.float32)
                    self._frame_epoch = self.arena.pose_epoch
            elif cur is None or cur.Tcw is None:
                # No pose existed before the wait: nothing to poison.
                self._frame_epoch = self.arena.pose_epoch
            # else: pose exists but could not be re-anchored (no valid
            # reference) — leave _frame_epoch stale so _store_trajectory's
            # invariant check fires rather than committing a poisoned
            # relative pose.
        self.kf_wait_stats["wait_s"] += _time.monotonic() - t0
        ok = len(mapper.queue) < self.kf_async_queue
        if not ok:
            self.kf_wait_stats["timeouts"] += 1
        return ok

    def _close_point_counts(self):
        """Tracked / non-tracked close-depth features (reference :590-600).
        Chain-processed frames carry the counts computed in-program
        (chain_step) — reading cur.depth would force a full packed-frame
        fetch per frame."""
        cur = self.current
        if cur.chain_close_counts is not None:
            return cur.chain_close_counts
        if cur.depth is None:
            return 0, 0
        close = (cur.depth > 0) & (cur.depth < self.cfg.th_depth)
        tracked = (cur.mp_ids >= 0) & ~cur.outlier
        n_tracked_close = int((close & tracked).sum())
        n_nontracked_close = int((close & ~tracked).sum())
        return n_tracked_close, n_nontracked_close

    def create_new_keyframe(self):
        cur = self.current
        kf = self.arena.new_keyframe(
            cur.id, cur.timestamp, cur.Tcw, cur.feats, cur.mp_ids)
        cur.ref_kf_id = kf.id
        self.ref_kf_id = kf.id
        self.last_kf_frame_id = cur.id
        self.last_kf_id = kf.id
        if self.cfg.sensor != Sensor.MONOCULAR:
            self._seed_depth_points(kf)
        self.local_mapper.insert_keyframe(kf.id)
        # Health-aware mapping synchronization: a keyframe created while
        # tracking is FRAGILE (inliers well below the scene-relative EMA
        # — e.g. inside a blurred/degraded segment) exists precisely to
        # replenish the local map, and its triangulations must land
        # before the next frames or tracking starves and goes LOST. An
        # async mapper that lags even a few frames here loses the race
        # (sync mapping survives the same segments). Drain the worker
        # synchronously for THIS keyframe only — healthy-tracking
        # keyframes stay fully asynchronous. arena.lock is released
        # around the drain (the worker's host phases need it); flush
        # itself asserts the level is not held.
        if (self.kf_sync_flush_ratio > 0
                and self.local_mapper.is_async
                and self.n_inliers < self.kf_sync_flush_ratio
                * self._inl_ema):
            self.kf_wait_stats["fragile_flushes"] = (
                self.kf_wait_stats.get("fragile_flushes", 0) + 1)
            epoch0 = self.arena.pose_epoch
            with self.arena.unlocked(), self.arena.correction_unlocked():
                try:
                    self.local_mapper.flush(timeout=60.0)
                except RuntimeError:
                    # A wedged worker must degrade tracking, not kill it
                    # (flush raises loudly for reset's sake; here the
                    # keyframe is already queued and tracking can go on).
                    self.kf_wait_stats["flush_timeouts"] = (
                        self.kf_wait_stats.get("flush_timeouts", 0) + 1)
            if self.arena.pose_epoch != epoch0 and kf.id in self.arena.kfs:
                # A map-wide correction landed during the flush (the
                # correction lock is released above so the worker can
                # run one). The keyframe — already in the map — was
                # corrected with it; the frame is the same camera, so
                # adopting the keyframe's corrected pose keeps cur (and
                # the Tcr_ref stored at frame end) in the map's frame.
                cur.Tcw = self.arena.kfs[kf.id].Tcw.copy()
                self._frame_epoch = self.arena.pose_epoch
            # (kf erased during the flush + epoch moved: _frame_epoch
            # stays stale; _store_trajectory skips the store when the
            # reference keyframe is gone, so no poison can land.)

    def _seed_depth_points(self, kf):
        """Stereo/RGBD keyframes seed map points from depth for unmatched
        close features (reference CreateNewKeyFrame :619-659: sort by depth,
        create all closer than ThDepth, at least the 100 closest)."""
        cur = self.current
        cam = self.cfg.camera
        Twc = np.linalg.inv(cur.Tcw)
        if cur.depth is None:
            return
        # ALL valid depth-bearing features enter the depth-sorted sweep —
        # tracked ones too: the reference counts nPoints for every swept
        # entry (created OR already tracked) and stops at
        # z > ThDepth && nPoints > 100, so a frame whose close features
        # are already well tracked creates few far points. Counting only
        # creations would pad every keyframe with up to 100 far/noisy
        # points upstream would never make.
        cand = [(float(cur.depth[i]), int(i))
                for i in np.nonzero(cur.feats.valid)[0]
                if cur.depth[i] > 0]
        cand.sort()
        n_points = 0
        for z, i in cand:
            if z > self.cfg.th_depth and n_points > 100:
                break
            if cur.mp_ids[i] < 0:
                uv = cur.feats.xy_und[i]
                xc = np.array([(uv[0] - cam.cx) / cam.fx * z,
                               (uv[1] - cam.cy) / cam.fy * z, z, 1.0],
                              np.float32)
                x3d = (Twc @ xc)[:3]
                mp = self.arena.new_point(x3d, cur.feats.desc[i],
                                          kf.id, kf.id)
                self.arena.add_observation(mp, kf, int(i))
                self.arena.update_normal_and_depth(mp, self.scale_factors)
                cur.mp_ids[i] = mp.id
                kf.mp_ids[i] = mp.id
                self.local_mapper.recent_points.append((mp.id, kf.id))
            n_points += 1

    # ------------------------------------------------------------------
    # Relocalization (BoW candidate search + EPnP-RANSAC + top-up)
    # ------------------------------------------------------------------

    def relocalization(self) -> bool:
        """See _relocalization_impl. This wrapper hides any temporary VO
        points from the candidate pose optimizations: they were
        backprojected from the (drifted, pre-lost or odometry) pose, and
        the reference's relocalization scores candidates on candidate-KF
        map points only (src/Tracking.cc:796-884). On success they stay
        dropped (mbVO clears); on failure they are restored for the
        caller's odometry-solution restore path."""
        cur = self.current
        saved_vo = cur.vo_points
        cur.vo_points = {}
        self.reloc_stats["attempts"] += 1
        ok = self._relocalization_impl()
        if not ok:
            cur.vo_points = saved_vo
        else:
            self.reloc_stats["ok"] += 1
        return ok

    def _relocalization_impl(self) -> bool:
        """Reference Relocalization (src/Tracking.cc:796-884): BoW candidate
        keyframes -> per-candidate BoW matching (>=15) -> EPnP-RANSAC ->
        PoseOptimization -> projection top-up -> accept at >=50 inliers.

        Batched shape: the reference loops candidates, each with its own
        SearchByBoW + PnPsolver::iterate; here ALL candidates (no cap) run
        through ONE batched BoW match and ONE batched EPnP-RANSAC device
        call, then a cheap host accept loop — so a correct candidate ranked
        arbitrarily low still relocalizes at constant device cost."""
        if self.place_rec is None or not self.place_rec.ready:
            return False
        from orb_slam_system_tpu.solvers.pnp import (
            epnp_ransac_batch, make_pnp_sample_sets)
        cur = self.current
        bow, node_ids = self.place_rec.frame_bow(cur.feats.desc,
                                                 cur.feats.valid)
        if bow is None:
            return False
        candidates = self.place_rec.db.detect_reloc_candidates(bow, self.arena)
        if not candidates:
            self.reloc_stats["no_candidates"] += 1
            return False
        cam = self.cfg.camera
        cand_kfs = [kf for kf in (self.arena.kfs.get(c) for c in candidates)
                    if kf is not None and not kf.bad]
        if not cand_kfs:
            return False
        # ---- ONE batched node-constrained BoW match over all candidates.
        C = len(cand_kfs)
        C_pad = max(4, 1 << (C - 1).bit_length())
        n1 = max(kf.feats.n_slots for kf in cand_kfs)
        desc1 = np.zeros((C_pad, n1, 8), np.uint32)
        has1 = np.zeros((C_pad, n1), bool)
        ang1 = np.zeros((C_pad, n1), np.float32)
        node1 = np.full((C_pad, n1), -1, np.int32)
        for i, kf in enumerate(cand_kfs):
            m = kf.feats.n_slots
            has = (kf.mp_ids >= 0) & kf.feats.valid
            nk = (kf.node_ids if kf.node_ids is not None
                  else np.zeros(m, np.int32))
            desc1[i, :m] = kf.feats.desc
            has1[i, :m] = has
            ang1[i, :m] = kf.feats.angle
            node1[i, :m] = np.where(has, nk, -1)
        idx2_all = np.asarray(matching.search_by_node_id_batch(
            jnp.asarray(desc1), jnp.asarray(has1), jnp.asarray(ang1),
            jnp.asarray(node1),
            jnp.asarray(cur.feats.desc), jnp.asarray(cur.feats.valid),
            jnp.asarray(cur.feats.angle),
            jnp.asarray(node_ids.astype(np.int32)),
            nn_ratio=0.75))
        # ---- Host: per-candidate 3D-2D correspondences on frame slots.
        n = cur.feats.n_slots
        Xw_all = np.zeros((C_pad, n, 3), np.float32)
        ok_all = np.zeros((C_pad, n), bool)
        mp_of_slot = np.full((C_pad, n), -1, np.int64)
        viable = []
        for i, kf in enumerate(cand_kfs):
            idx2 = idx2_all[i]
            rows = np.nonzero(idx2[:kf.feats.n_slots] >= 0)[0]
            if len(rows) < 15:            # reference >=15 gate (:830)
                continue
            for r in rows:
                mid = int(kf.mp_ids[r])
                mp = self.arena.mps.get(mid)
                if mp is not None and not mp.bad:
                    j = idx2[r]
                    Xw_all[i, j] = mp.pos
                    ok_all[i, j] = True
                    mp_of_slot[i, j] = mid
            if ok_all[i].sum() >= 15:
                viable.append(i)
        if not viable:
            self.reloc_stats["no_viable_pnp"] += 1
            return False
        # ---- ONE batched EPnP-RANSAC over all viable candidates.
        sets = make_pnp_sample_sets(n, 300, 0)
        pnp_ok, T_pnp, pnp_inl, _n_pnp = epnp_ransac_batch(
            jnp.asarray(Xw_all), jnp.asarray(cur.feats.xy_und),
            jnp.asarray(self.inv_sigma2[cur.feats.octave].astype(np.float32)),
            jnp.asarray(ok_all), jnp.asarray(sets),
            cam.fx, cam.fy, cam.cx, cam.cy)
        pnp_ok = np.asarray(pnp_ok)
        T_pnp = np.asarray(T_pnp)
        pnp_inl = np.asarray(pnp_inl)
        # ---- Accept loop in candidate order (reference iterates until
        # bMatch; device work is done, each attempt is 1 pose-opt trip).
        for i in viable:
            if not pnp_ok[i]:
                continue
            kf = cand_kfs[i]
            cur.mp_ids[:] = -1
            inl = pnp_inl[i]
            cur.mp_ids[inl] = mp_of_slot[i][inl]
            if not self._optimize_current_pose(T_pnp[i],
                                               min_map_matches=10):
                continue
            # Projection top-up against the keyframe's full point set
            # (reference :863-880, radius th=10).
            self._reloc_topup(kf, radius_th=10.0)
            if self._optimize_current_pose(cur.Tcw, min_map_matches=50):
                self.ref_kf_id = kf.id
                cur.ref_kf_id = kf.id
                return True
        self.reloc_stats["all_candidates_failed"] += 1
        return False

    def _reloc_topup(self, kf, radius_th=10.0):
        cur = self.current
        cam = self.cfg.camera
        ids, pos, desc, oct_pred, ok = [], [], [], [], []
        n = 0
        attached = {int(m) for m in cur.mp_ids if m >= 0}
        slots = []
        for mid in kf.mp_ids:
            if mid < 0 or int(mid) in attached:
                continue
            mp = self.arena.mps.get(int(mid))
            if mp is None or mp.bad:
                continue
            slots.append((int(mid), mp))
        if not slots:
            return
        P = len(slots)
        pos = np.stack([mp.pos for _, mp in slots])
        desc = np.stack([mp.desc for _, mp in slots])
        Xc = pos @ cur.Tcw[:3, :3].T + cur.Tcw[:3, 3]
        z = Xc[:, 2]
        valid = z > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = Xc[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9, z[:, None])
        proj = proj * [cam.fx, cam.fy] + [cam.cx, cam.cy]
        radius = np.full(P, radius_th, np.float32)
        already = cur.mp_ids >= 0
        # Predicted octave from the scale-invariance band (PredictScale).
        Ow = cur.camera_center()
        dist = np.linalg.norm(pos - Ow[None, :], axis=1)
        maxd = np.asarray([mp.max_dist for _, mp in slots])
        with np.errstate(divide="ignore", invalid="ignore"):
            lvl = np.ceil(np.log(np.maximum(maxd, 1e-9)
                                 / np.maximum(dist, 1e-9))
                          / np.log(self.cfg.orb.scale_factor))
        lvl = np.clip(np.nan_to_num(lvl, nan=0.0), 0,
                      self.cfg.orb.n_levels - 1).astype(np.int32)
        res = matching.search_by_projection_set(
            jnp.asarray(proj.astype(np.float32)), jnp.asarray(radius),
            jnp.asarray(lvl),
            jnp.asarray(valid), jnp.asarray(desc),
            jnp.asarray(cur.feats.xy_und), jnp.asarray(cur.feats.desc),
            jnp.asarray(cur.feats.valid), jnp.asarray(cur.feats.octave),
            jnp.asarray(already))
        idx2 = np.asarray(res.idx2)
        for k in np.nonzero(idx2 >= 0)[0]:
            cur.mp_ids[idx2[k]] = slots[k][0]

    # ------------------------------------------------------------------
    # Reset (reference Tracking::Reset src/Tracking.cc:887-927)
    # ------------------------------------------------------------------

    def reset(self):
        # Drain the async worker WITHOUT holding arena.lock: its stages
        # block on that lock, so flushing from inside the tracker's locked
        # section (track() -> _track_locked -> reset) would stall for the
        # full flush timeout and then race a keyframe mid-stage.
        # arena.unlocked() releases the level held by track() and is a
        # no-op when the caller doesn't hold the lock (external reset).
        # correction_unlocked likewise: a worker mid-drain may need the
        # correction lock (held by this frame's span) to finish a loop
        # correction before the flush can complete.
        with self.arena.unlocked(), self.arena.correction_unlocked():
            self.local_mapper.reset()
        with self.arena.lock:
            self._reset_map()
        self.velocity = None
        self.mb_vo = False
        self.ref_kf_id = -1
        self.last_kf_frame_id = -1
        self.last_kf_id = -1
        self.local_kf_ids = []
        self._chain_ninl_hist.clear()
        self._inl_ema = 0.0
        self._frame_epoch = self.arena.pose_epoch
        self.state = TrackingState.NOT_INITIALIZED

    # ------------------------------------------------------------------
    # Trajectory bookkeeping (reference :239, System.cc:301-359)
    # ------------------------------------------------------------------

    def _store_trajectory(self):
        cur = self.current
        if cur is None or cur.Tcw is None or cur.ref_kf_id < 0:
            # Lost/uninitialized frame: repeat the last entry flagged lost
            # (reference :243-249).
            if self.trajectory:
                e = self.trajectory[-1]
                self.trajectory.append(TrajectoryEntry(
                    e.Tcr.copy(), e.ref_kf_id, cur.timestamp if cur else 0.0,
                    True))
            return
        ref = self.arena.kfs.get(cur.ref_kf_id)
        if ref is None:
            return
        if self._frame_epoch not in (-1, self.arena.pose_epoch):
            # Enforced correction-exclusion invariant (__init__ doc): the
            # map's poses were rewritten inside this frame's span through
            # a wait window whose handler did NOT re-anchor the frame.
            # Storing Tcr_ref now would poison the trajectory and the
            # motion model permanently (round-4 race class).
            self.epoch_violations += 1
            msg = (f"correction-exclusion invariant violated: pose_epoch "
                   f"advanced {self._frame_epoch}->{self.arena.pose_epoch} "
                   f"inside frame {cur.id}'s span without a re-anchor; "
                   f"refusing to store a poisoned Tcr_ref "
                   f"(arena.correction_lock doc)")
            if self.epoch_assert:
                raise RuntimeError(msg)
            import sys as _sys
            print("[tracking] WARNING:", msg, file=_sys.stderr)
        Tcr = (cur.Tcw @ np.linalg.inv(ref.Tcw)).astype(np.float32)
        cur.Tcr_ref = Tcr
        self.trajectory.append(TrajectoryEntry(
            Tcr, cur.ref_kf_id, cur.timestamp, False))
