"""Local mapping: keyframe processing, point culling, triangulation, local BA.

Replaces reference LocalMapping (src/LocalMapping.cc). The reference runs
this on its own thread with a 3 ms poll (:28-53); here it runs as a
synchronous stage invoked between tracked frames (SURVEY.md §7.1: "mapping
budget per frame" replaces thread interleaving — JAX async dispatch pipelines
the device work underneath). Upstream-complete semantics restore the fork's
dead paths: triangulation actually creates points (§0.1 row 2) and
SearchInNeighbors fusion is called (row 3).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import jax.numpy as jnp
import numpy as np

from orb_slam_system_tpu.config import SlamConfig
from orb_slam_system_tpu.mapping.arena import KeyFrameRec, MapArena, hamming_np
from orb_slam_system_tpu.ops import matching
from orb_slam_system_tpu.solvers.local_ba import (
    BAProblem, local_bundle_adjustment_packed, unpack_local_ba)
from orb_slam_system_tpu.solvers.triangulate import triangulate_dlt

import jax


@jax.jit
def _dlt_batch(uv1, uv2, P1, P2):
    """Batched two-view DLT over M neighbor keyframes in one device call:
    uv1/uv2 f32[M,N,2], P1 f32[3,4] (the new keyframe, shared), P2
    f32[M,3,4]. Returns (X f32[M,N,3], ok bool[M,N])."""
    return jax.vmap(triangulate_dlt, in_axes=(None, 0, None, 0))(
        uv1, uv2, P1, P2)


@jax.jit
def _search_and_dlt(xy1, desc1, avail1, oct1, ang1,
                    xy2, desc2, avail2, oct2, ang2,
                    F12, inv_sigma2_levels, epipole_xy, nb_valid,
                    P1, P2):
    """Epipolar triangulation search + two-view DLT fused into ONE device
    program with ONE packed output fetch (search idx2 fed the DLT through
    the host before, costing a second device round trip per keyframe
    insertion). Returns f32[M, N1, 5]: [:, :, 0] idx2, 1:4 X, 4 dlt-ok."""
    idx2 = matching.search_for_triangulation_batch(
        xy1, desc1, avail1, oct1, ang1,
        xy2, desc2, avail2, oct2, ang2,
        F12, inv_sigma2_levels, epipole_xy, nb_valid)
    sel = jnp.where(idx2 >= 0, idx2, 0)
    uv2 = jnp.take_along_axis(xy2, sel[..., None], axis=1)   # [M,N1,2]
    X, okd = jax.vmap(triangulate_dlt, in_axes=(None, 0, None, 0))(
        xy1, uv2, P1, P2)
    return jnp.concatenate([
        idx2[..., None].astype(jnp.float32), X,
        okd[..., None].astype(jnp.float32)], axis=-1)

# Local BA size buckets (static shapes for XLA). Points/edges pick the
# smallest bucket that fits the actual window (each bucket compiles once;
# a small early-map window solving at the maximum padded size paid ~4x
# the FLOPs for nothing).
BA_CAMS = 16
BA_POINTS = 2048
BA_EDGES = 8192
BA_PT_BUCKETS = (512, 1024, 2048)
BA_EDGE_BUCKETS = (2048, 4096, 8192)


def _bucket(n: int, ladder) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


class LocalMapper:
    def __init__(self, cfg: SlamConfig, arena: MapArena, place_rec=None):
        self.cfg = cfg
        self.arena = arena
        self.place_rec = place_rec
        self.loop_closer = None  # wired by System
        self.queue: deque[int] = deque()
        self.recent_points: list[tuple[int, int]] = []  # (mp_id, birth_kf_id)
        self._abort_ba = False
        self._accepting = True
        self.scale_factors = np.asarray(cfg.orb.level_scales(), np.float32)
        self.inv_sigma2 = (1.0 / self.scale_factors ** 2).astype(np.float32)
        self.enable_local_ba = True
        self.enable_kf_culling = True
        # Fused tri+fuse device program (one packed fetch per insertion);
        # False restores the separate create_new_map_points /
        # search_in_neighbors programs (parity testing).
        import os
        self.use_fused_tri = (
            os.environ.get("ORB_SLAM_TPU_NO_FUSED_TRI", "0") != "1")
        # MapPointCulling obs threshold: 2 mono, 3 stereo/RGBD
        # (reference src/LocalMapping.cc:137-151 cnThObs).
        from orb_slam_system_tpu.config import Sensor
        self.cull_obs_th = 2 if cfg.sensor == Sensor.MONOCULAR else 3
        from orb_slam_system_tpu.utils.metrics import StageTimer
        self.stage_ms = StageTimer()
        # Async-worker state (start_async / stop_async).
        self._thread = None
        self._cv = None
        self._stop = False
        self._busy = False
        # True while some admitted keyframe has NOT yet expanded the map
        # (its triangulation+fusion stage hasn't run). The tracker's
        # backpressure drain waits on THIS, not _busy: once every queued
        # keyframe's new points are in the arena, the remaining work
        # (local BA, culling, loop detection) is refinement the reference
        # runs concurrently with tracking anyway (src/LocalMapping.cc
        # Run :43-49 + mbAbortBA), so tracking may resume and overlap it.
        # flush()/accepting() keep full _busy semantics (fragile-segment
        # sync and shutdown still wait for everything).
        self._expanding = False
        self.worker_errors = 0
        self.stats_fuse_truncated = 0

    # ----- thread-protocol surface (reference :305-458) -------------------

    def insert_keyframe(self, kf_id: int):
        self.queue.append(kf_id)
        self._abort_ba = True
        cv = self._cv
        if cv is not None:
            with cv:
                cv.notify()

    def accepting(self) -> bool:
        return self._accepting and len(self.queue) == 0 and not self._busy

    @property
    def is_async(self) -> bool:
        """True while the worker thread is running (async mapping mode)."""
        return self._thread is not None

    def interrupt_ba(self):
        self._abort_ba = True

    def reset(self):
        self.flush()
        self.queue.clear()
        self.recent_points.clear()

    # ----- async worker (reference LocalMapping::Run thread, :28-53) ------

    def start_async(self):
        """Run keyframe processing on a dedicated thread (the reference's
        LocalMapping thread). Tracking and mapping then overlap: both sides
        hold arena.lock for host phases and release it around device
        fetches, so device round trips pipeline instead of serializing."""
        import threading
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = False
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="local_mapping")
        self._thread.start()

    def stop_async(self):
        t = self._thread
        if t is None:
            return
        self._stop = True
        with self._cv:
            self._cv.notify()
        t.join()
        self._thread = None
        self._cv = None

    def flush(self, timeout: float = 60.0):
        """Block until the worker drains the queue (sync mode: no-op).

        Fails loudly on timeout: a silent partial flush would let callers
        (reset) clear the queue while a keyframe is still mid-stage in the
        worker. NOTE: callers must NOT hold arena.lock — the worker's
        stages block on it, so a locked flush can never drain."""
        import time as _time
        if self._thread is None:
            return
        t0 = _time.monotonic()
        while (self.queue or self._busy) and _time.monotonic() - t0 < timeout:
            _time.sleep(0.002)
        if self.queue or self._busy:
            raise RuntimeError(
                "local-mapping flush timed out after %.0fs "
                "(queue=%d busy=%s) — is arena.lock held by the caller?"
                % (timeout, len(self.queue), self._busy))

    def _worker(self):
        while True:
            with self._cv:
                while not self.queue and not self._stop:
                    self._cv.wait(0.05)
            if self._stop and not self.queue:
                return
            try:
                self._busy = True
                self._expanding = True
                self.process_pending()
            except Exception:  # noqa: BLE001
                # A dead worker thread would silently stop draining the
                # queue and deadlock the next reset/flush; log loudly,
                # drop the offending keyframe, keep serving (SURVEY.md §5
                # failure-detection row: the mapping thread must survive
                # a bad keyframe).
                import sys
                import traceback
                self.worker_errors += 1
                print("[local_mapping] worker error (keyframe dropped):",
                      file=sys.stderr)
                traceback.print_exc()
            finally:
                self._busy = False
                self._expanding = False

    # ----- main stage ------------------------------------------------------

    def process_pending(self):
        """Drain the keyframe queue (reference Run/ProcessKeyFrames :28-75).

        Per-stage wall time is recorded in self.stage_ms (SURVEY.md §5
        observability: keyframe insertion is the system-throughput spike,
        so each stage is attributable)."""
        # _expanding must not survive an exception: sync-mode callers
        # (system.py invokes this directly, outside the worker's finally)
        # would otherwise leave it stuck True and every later backpressure
        # drain would wait out the full kf_async_wait_s timeout per frame.
        try:
            self._process_pending_inner()
        finally:
            self._expanding = False

    def _process_pending_inner(self):
        t = self.stage_ms
        lk = self.arena.lock
        while self.queue:
            # Phase 1 — EXPANSION: drain every queued keyframe's
            # triangulation+fusion first. _expanding is raised before the
            # pop (from the pop until the triangulation lands, the queue
            # alone no longer witnesses the unexpanded keyframe; the
            # tracker's backpressure drain waits on queue OR _expanding).
            self._expanding = True
            batch: list[KeyFrameRec] = []
            while self.queue:
                kf_id = self.queue.popleft()
                kf = self.arena.kfs.get(kf_id)
                if kf is None:
                    continue
                # Each stage holds the map mutex; the heavy stages release
                # it internally around their device fetches (arena.unlocked)
                # so the tracker's host phases overlap the device round
                # trips.
                with t.stage("process_new_kf"), lk:
                    self.process_new_keyframe(kf)
                with t.stage("cull_points"), lk:
                    self.cull_map_points(kf)
                # Triangulation + fusion ride ONE fused device program with
                # ONE packed fetch (ops/mapper_fused.py); fusion joins only
                # for the backlog's last keyframe (reference Run :43-49
                # runs SearchInNeighbors iff !CheckNewKeyFrames()).
                if self.use_fused_tri:
                    with t.stage("tri_fuse"), lk:
                        self.tri_and_fuse(kf, do_fuse=not self.queue)
                else:
                    with t.stage("triangulate"), lk:
                        self.create_new_map_points(kf)
                    if not self.queue:
                        with t.stage("fuse_neighbors"), lk:
                            self.search_in_neighbors(kf)
                batch.append(kf)
            # Every admitted keyframe has now grown the map: release the
            # tracker's backpressure drain (with kf_drain_release_on_
            # expansion it waits on _expanding, not _busy) so new frames
            # track against the expanded map while local BA / culling /
            # loop detection run behind them — the reference's
            # concurrent-BA thread model (src/LocalMapping.cc:28-53).
            self._expanding = False
            if not batch:
                continue
            kf = batch[-1]
            # Phase 2 — REFINEMENT: one local-BA + keyframe-culling pass
            # per expansion batch, on the newest keyframe, GUARANTEED to
            # run even if the tracker refilled the queue meanwhile. The
            # round-4 drain-release A/B failed precisely because these
            # were gated on an empty queue: a tracker released at
            # expansion refills the queue before the worker reaches BA
            # under ~1 KF/frame structural demand, so BA and culling
            # starved and the map was never polished or pruned. The
            # queue-empty gate's purpose — ONE device solve per backlog
            # instead of one per queued entry — is preserved by the
            # batch structure itself. (_abort_ba mirrors upstream's
            # mbAbortBA intent; the batched LM solve is a single jitted
            # program and cannot stop mid-flight, so batch-gating does
            # the catching up instead.)
            if (self.arena.n_keyframes() > 2 and self.enable_local_ba
                    and kf.id in self.arena.kfs):
                with t.stage("local_ba"), lk:
                    self.local_ba(kf)
            if self.enable_kf_culling and kf.id in self.arena.kfs:
                with t.stage("cull_kfs"), lk:
                    self.cull_keyframes(kf)
            # Hand off to loop closing (reference :72, the thread
            # boundary) — every batch keyframe still alive is processed
            # (BoW-indexed + loop-detected), in insertion order.
            if self.loop_closer is not None:
                for bkf in batch:
                    if bkf.id in self.arena.kfs:
                        with t.stage("loop_closer"), lk:
                            self.loop_closer.process(bkf.id)

    def process_new_keyframe(self, kf: KeyFrameRec):
        """Reference ProcessNewKeyFrame (:105-132): bind tracked map points,
        refresh their statistics, update the covisibility graph. The
        per-point descriptor/normal refreshes run as ONE batched arena pass
        (a ~450-iteration Python loop of tiny numpy ops was the largest
        keyframe-time host cost)."""
        fresh = []
        for idx, mid in enumerate(kf.mp_ids):
            if mid < 0:
                continue
            mp = self.arena.mps.get(int(mid))
            if mp is None or mp.bad:
                kf.mp_ids[idx] = -1
                continue
            if kf.id not in mp.obs:
                self.arena.add_observation(mp, kf, idx)
                fresh.append(mp)
        if fresh:
            self.arena.compute_distinctive_many(fresh)
            self.arena.update_normals_many(fresh, self.scale_factors)
        self.arena.update_connections(kf)
        # BoW + keyframe-database indexing (reference ProcessNewKeyFrame
        # ComputeBoW :108 + KeyFrameDatabase add in LoopClosing).
        if self.place_rec is not None:
            self.place_rec.on_new_keyframe(kf, self.arena)

    def cull_map_points(self, kf: KeyFrameRec):
        """Reference MapPointCulling (:134-164)."""
        keep = []
        cur_kf_id = kf.id
        for mp_id, birth in self.recent_points:
            mp = self.arena.mps.get(mp_id)
            if mp is None or mp.bad:
                continue
            age = cur_kf_id - birth
            if mp.found_ratio() < 0.25:
                self.arena.set_point_bad(mp)
            elif age >= 2 and len(mp.obs) <= self.cull_obs_th:
                self.arena.set_point_bad(mp)
            elif age >= 3:
                pass  # survives culling; leaves the recent list
            else:
                keep.append((mp_id, birth))
        self.recent_points = keep

    # ----- triangulation ---------------------------------------------------


    @staticmethod
    def _pad_slots(a: np.ndarray, n: int, fill=0) -> np.ndarray:
        """Pad a per-slot feature array to n slots (keyframes from the
        mono-init 2x extractor carry more slots than regular ones)."""
        if a.shape[0] == n:
            return a
        pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, pad], axis=0)

    def _compute_f12(self, kf1: KeyFrameRec, kf2: KeyFrameRec) -> np.ndarray:
        """Fundamental matrix mapping kp1 -> epipolar line in image 2
        (reference ComputeF12 src/LocalMapping.cc:295-303)."""
        K = self.cfg.camera.K
        T1, T2 = kf1.Tcw, kf2.Tcw
        R1, t1 = T1[:3, :3], T1[:3, 3]
        R2, t2 = T2[:3, :3], T2[:3, 3]
        R12 = R1 @ R2.T
        t12 = -R12 @ t2 + t1
        tx = np.array([
            [0, -t12[2], t12[1]],
            [t12[2], 0, -t12[0]],
            [-t12[1], t12[0], 0]], np.float64)
        Kinv = np.linalg.inv(K.astype(np.float64))
        F12 = Kinv.T @ tx @ R12 @ Kinv
        return F12.astype(np.float32)

    def _tri_candidates(self, kf: KeyFrameRec):
        """Triangulation neighbor selection + per-neighbor epipolar
        geometry (reference CreateNewMapPoints :166-183: best covisible
        neighbors passing the baseline/median-depth gate). Returns a list
        of (neighbor_kf, F12, epipole_xy)."""
        cam = self.cfg.camera
        K = cam.K
        n_neighbors = 20  # mono (reference :169)
        neighbors = self.arena.covisible_ordered(kf, n_neighbors)
        O1 = kf.camera_center()
        cand = []
        for nb_id in neighbors:
            kf2 = self.arena.kfs.get(nb_id)
            if kf2 is None or kf2.bad:
                continue
            O2 = kf2.camera_center()
            baseline = float(np.linalg.norm(O2 - O1))
            med_depth = self._median_scene_depth(kf2)
            if med_depth <= 0 or baseline / med_depth < 0.01:
                continue  # reference baseline gate (:176-183)
            F12 = self._compute_f12(kf, kf2)
            # Epipole of camera 1 in image 2.
            Xc = kf2.Tcw[:3, :3] @ O1 + kf2.Tcw[:3, 3]
            if abs(Xc[2]) < 1e-9:
                continue
            epi = np.array([
                K[0, 0] * Xc[0] / Xc[2] + K[0, 2],
                K[1, 1] * Xc[1] / Xc[2] + K[1, 2]], np.float32)
            cand.append((kf2, F12.astype(np.float32), epi))
        return cand

    def create_new_map_points(self, kf: KeyFrameRec):
        """Upstream-complete CreateNewMapPoints (reference :166-233; the
        fork's TriangulateAndAddPoint no-op is NOT reproduced): epipolar
        search against the best covisible neighbors, batched DLT
        triangulation, parallax/depth/reprojection/scale-consistency gates,
        then MapPoint creation with observations in both keyframes."""
        cam = self.cfg.camera
        avail1 = kf.feats.valid & (kf.mp_ids < 0)
        # Gather all passing neighbors, then run ONE batched epipolar search
        # over the whole set (per-neighbor calls each cost a host round trip;
        # a new keyframe has up to 20 neighbors).
        with self.stage_ms.stage("tri_prep"):
            cand = self._tri_candidates(kf)
        if not cand:
            return
        M = len(cand)
        # Pad the neighbor axis to a power of two (min 8) so the batched
        # program compiles for ~3 shapes total instead of one per neighbor
        # count (each fresh shape is a multi-second XLA compile that lands
        # in the frame loop), and pad per-slot arrays to the largest slot
        # count in the batch (mono-init keyframes come from the 2x-features
        # extractor).
        with self.stage_ms.stage("tri_prep"):
            M_pad = max(8, 1 << (M - 1).bit_length())
            nb_valid = np.zeros(M_pad, bool)
            nb_valid[:M] = True
            cand_p = cand + [cand[0]] * (M_pad - M)
            n2 = max(c[0].feats.n_slots for c in cand)

            stack = lambda f, fill=0: np.stack(  # noqa: E731
                [self._pad_slots(np.asarray(f(c)), n2, fill) for c in cand_p])
            Kc = cam.K.astype(np.float32)
            P1 = (Kc @ kf.Tcw[:3, :]).astype(np.float32)
            P2_all = np.stack([(Kc @ c[0].Tcw[:3, :]).astype(np.float32)
                               for c in cand_p])
            # Epipolar search + batched DLT: ONE device program, ONE fetch
            # (the idx2->uv2 gather runs on device); per-neighbor acceptance
            # gates stay vectorized numpy. The map mutex is released for the
            # round trip (inputs are immutable copies by this point).
            args = (
                jnp.asarray(kf.feats.xy_und), jnp.asarray(kf.feats.desc),
                jnp.asarray(avail1), jnp.asarray(kf.feats.octave),
                jnp.asarray(kf.feats.angle),
                jnp.asarray(stack(lambda c: c[0].feats.xy_und)),
                jnp.asarray(stack(lambda c: c[0].feats.desc)),
                jnp.asarray(stack(
                    lambda c: c[0].feats.valid & (c[0].mp_ids < 0))),
                jnp.asarray(stack(lambda c: c[0].feats.octave)),
                jnp.asarray(stack(lambda c: c[0].feats.angle)),
                jnp.asarray(np.stack([c[1] for c in cand_p])),
                jnp.asarray(self.inv_sigma2),
                jnp.asarray(np.stack([c[2] for c in cand_p])),
                jnp.asarray(nb_valid),
                jnp.asarray(P1), jnp.asarray(P2_all))
        with self.arena.unlocked(), self.stage_ms.stage("tri_device"):
            out = np.asarray(_search_and_dlt(*args))
        with self.stage_ms.stage("tri_gates"):
            idx2_all = out[..., 0].astype(np.int64)
            X_all = out[..., 1:4]
            okd_all = out[..., 4] > 0.5
            created: list = []
            for m in range(M):
                kf2 = cand[m][0]
                idx2 = idx2_all[m]
                # Features claimed while processing an earlier neighbor are
                # skipped (the sequential reference re-derives avail1 per
                # neighbor; the batched search used the initial mask).
                rows = np.nonzero((idx2 >= 0) & (kf.mp_ids < 0)
                                  & (kf2.mp_ids[idx2.clip(0)] < 0))[0]
                if len(rows) == 0:
                    continue
                created.extend(self._triangulate_matches(
                    kf, kf2, rows, idx2[rows],
                    X_pre=X_all[m], ok_pre=okd_all[m]))
        if created:
            with self.stage_ms.stage("tri_refresh"):
                self.arena.compute_distinctive_many(created)
                self.arena.update_normals_many(created, self.scale_factors)

    def _median_scene_depth(self, kf: KeyFrameRec) -> float:
        """Reference KeyFrame::ComputeSceneMedianDepth (src/KeyFrame.cc:613-643)."""
        zs = []
        R2 = kf.Tcw[2, :3]
        t2 = kf.Tcw[2, 3]
        for mid in kf.mp_ids:
            if mid >= 0:
                mp = self.arena.mps.get(int(mid))
                if mp is not None and not mp.bad:
                    zs.append(float(R2 @ mp.pos + t2))
        return float(np.median(zs)) if zs else -1.0

    def _triangulate_matches(self, kf1, kf2, rows1, rows2,
                             X_pre=None, ok_pre=None):
        """Batched triangulation + vectorized acceptance gates.

        The DLT runs over the FULL padded slot set (fixed [N] shapes: a
        variable-length call recompiled on every new match count, which
        dominated steady-state mapping time); all gates
        (parallax, cheirality, reprojection chi2, scale consistency —
        reference :219-233) are dense numpy, with a host loop only over the
        accepted survivors for arena bookkeeping."""
        cam = self.cfg.camera
        K = cam.K.astype(np.float32)
        P1 = (K @ kf1.Tcw[:3, :]).astype(np.float32)
        P2 = (K @ kf2.Tcw[:3, :]).astype(np.float32)
        N = kf1.feats.n_slots
        sel2 = np.zeros(N, np.int64)
        active = np.zeros(N, bool)
        sel2[rows1] = rows2
        active[rows1] = True
        uv1 = kf1.feats.xy_und                      # [N,2] fixed shape
        uv2 = kf2.feats.xy_und[sel2]                # [N,2] fixed shape
        if X_pre is None:
            X, ok_dlt = triangulate_dlt(
                jnp.asarray(uv1), jnp.asarray(uv2),
                jnp.asarray(P1), jnp.asarray(P2))
            X = np.asarray(X)
            ok = np.asarray(ok_dlt) & active
        else:
            X = X_pre
            ok = ok_pre & active
        # Ray parallax gate (reference :219-233 upstream semantics).
        Kinv = np.linalg.inv(K)
        ones = np.ones((N, 1), np.float32)
        ray1 = (np.concatenate([uv1, ones], 1) @ Kinv.T) @ kf1.Tcw[:3, :3]
        ray2 = (np.concatenate([uv2, ones], 1) @ Kinv.T) @ kf2.Tcw[:3, :3]
        cosp = np.sum(ray1 * ray2, axis=1) / np.maximum(
            np.linalg.norm(ray1, axis=1) * np.linalg.norm(ray2, axis=1),
            1e-12)
        ok &= (cosp > 0) & (cosp < 0.9998)
        # Cheirality both views.
        z1 = X @ kf1.Tcw[2, :3] + kf1.Tcw[2, 3]
        z2 = X @ kf2.Tcw[2, :3] + kf2.Tcw[2, 3]
        ok &= (z1 > 0) & (z2 > 0)
        # Reprojection chi2 both views (95% gate 5.991).
        for kf_, uv_, rows_sel, z_ in ((kf1, uv1, np.arange(N), z1),
                                       (kf2, uv2, sel2, z2)):
            Xc = X @ kf_.Tcw[:3, :3].T + kf_.Tcw[:3, 3]
            zs = np.where(np.abs(Xc[:, 2]) < 1e-12, 1e-12, Xc[:, 2])
            u = cam.fx * Xc[:, 0] / zs + cam.cx
            v = cam.fy * Xc[:, 1] / zs + cam.cy
            e2 = (uv_[:, 0] - u) ** 2 + (uv_[:, 1] - v) ** 2
            chi2 = e2 * self.inv_sigma2[kf_.feats.octave[rows_sel]]
            ok &= chi2 <= 5.991
        # Scale consistency (reference ratioFactor = 1.5 * scaleFactor).
        O1, O2 = kf1.camera_center(), kf2.camera_center()
        d1 = np.linalg.norm(X - O1, axis=1)
        d2 = np.linalg.norm(X - O2, axis=1)
        ok &= (d1 > 0) & (d2 > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio_dist = d2 / np.maximum(d1, 1e-12)
        ratio_oct = (self.scale_factors[kf1.feats.octave]
                     / self.scale_factors[kf2.feats.octave[sel2]])
        rf = 1.5 * self.cfg.orb.scale_factor
        ok &= ~((ratio_dist * rf < ratio_oct) | (ratio_dist > ratio_oct * rf))
        # Arena bookkeeping only for survivors. The descriptor/normal
        # refresh is batched by the caller across ALL neighbors of the
        # insertion (it runs the [P,M,M] popcount pass; per-neighbor it
        # executed up to 20x per keyframe).
        created = []
        for i1 in np.nonzero(ok)[0]:
            i2 = int(sel2[i1])
            # ref_kf = the CURRENT keyframe kf1 (reference :166-233
            # constructs MapPoint(x3D, mpCurrentKeyFrame, mpMap)); the
            # normal/scale-band anchor must be the creating keyframe's
            # viewpoint, not the neighbor's.
            mp = self.arena.new_point(X[i1], kf1.feats.desc[int(i1)],
                                      kf1.id, kf1.id)
            self.arena.add_observation(mp, kf1, int(i1))
            self.arena.add_observation(mp, kf2, i2)
            self.recent_points.append((mp.id, kf1.id))
            created.append(mp)
        return created

    # ----- fused triangulation + fusion (one device program) ---------------

    def _point_data(self, ids, n_pad: int):
        """Columnar gather of fuse-projection point data for an id list
        (or id array with -1 holes), padded to n_pad: (pos, desc,
        0.8*min_dist, 1.2*max_dist, normal, ok)."""
        pos = np.zeros((n_pad, 3), np.float32)
        desc = np.zeros((n_pad, 8), np.uint32)
        mind = np.zeros(n_pad, np.float32)
        maxd = np.ones(n_pad, np.float32)
        normal = np.zeros((n_pad, 3), np.float32)
        okv = np.zeros(n_pad, bool)
        if len(ids):
            rows, ok = self.arena.lookup_points(np.asarray(ids, np.int64))
            (_, c_pos, c_desc, c_mind, c_maxd, _n,
             c_normal) = self.arena.point_columns()
            r = rows[ok]
            w = np.nonzero(ok)[0]
            pos[w] = c_pos[r]
            desc[w] = c_desc[r]
            mind[w] = 0.8 * c_mind[r]
            maxd[w] = np.maximum(1.2 * c_maxd[r], 1e-6)
            normal[w] = c_normal[r]
            okv[w] = True
        return pos, desc, mind, maxd, normal, okv

    # Fusion-target cap: T_pad buckets {FUSE_T_SMALL, FUSE_T_MAX}; targets
    # beyond the cap (covisibility-ordered, so the weakest) are dropped —
    # the reference's unbounded first+second-order set rarely exceeds it.
    FUSE_T_SMALL = 16
    FUSE_T_MAX = 64
    # Direction-B union cap (padded pow2 buckets up to this).
    FUSE_PB_MAX = 4096

    def tri_and_fuse(self, kf: KeyFrameRec, do_fuse: bool = True):
        """CreateNewMapPoints + SearchInNeighbors as TWO CHAINED device
        programs with ONE packed fetch (ops/mapper_fused.{tri_step,
        fuse_step} — the fuse program consumes the tri program's block
        device-resident): epipolar search, DLT, ALL acceptance gates, and
        both fusion directions — including the just-triangulated points,
        whose positions/normals/scale bands are computed in-flight — run
        on device; the host only applies arena bookkeeping from the
        packed result.

        Replaces the 2-program 2-fetch (plus host-gate) sequence, whose
        host gates competed with tracking for host CPU. Shape-bucket
        discipline matters here: every fresh (neighbors x targets x union) size
        combination is a multi-second XLA compile landing in the frame
        loop, so each program keys on few, coarse buckets."""
        from orb_slam_system_tpu.ops import mapper_fused
        cam = self.cfg.camera
        orb = self.cfg.orb
        st = self.stage_ms
        with st.stage("tri_fuse_prep"):
            cand = self._tri_candidates(kf)
        if not cand:
            # No triangulation geometry this insertion: plain fusion only.
            if do_fuse:
                self.search_in_neighbors(kf)
            return
        with st.stage("tri_fuse_prep"):
            targets: list = []
            union: list = []
            if do_fuse:
                t_ids, _src, union = self._fuse_sets(kf)
                targets = [self.arena.kfs[t] for t in t_ids]
                if len(targets) > self.FUSE_T_MAX:
                    targets = targets[:self.FUSE_T_MAX]
                if not targets:
                    do_fuse = False
            # Direction-A ids: SLOT-ALIGNED snapshot of the current KF's
            # bindings (before point creation mutates kf.mp_ids).
            src_slot_ids = [int(m) for m in kf.mp_ids]
            # Triangulation inputs (padded as in create_new_map_points).
            M = len(cand)
            M_pad = max(8, 1 << (M - 1).bit_length())
            nb_valid = np.zeros(M_pad, bool)
            nb_valid[:M] = True
            cand_p = cand + [cand[0]] * (M_pad - M)
            n2 = max(c[0].feats.n_slots for c in cand)
            stack = lambda f, fill=0: np.stack(  # noqa: E731
                [self._pad_slots(np.asarray(f(c)), n2, fill) for c in cand_p])
            Kc = cam.K.astype(np.float32)
            P1 = (Kc @ kf.Tcw[:3, :]).astype(np.float32)
            P2_all = np.stack([(Kc @ c[0].Tcw[:3, :]).astype(np.float32)
                               for c in cand_p])
            nb_Tcw = np.stack([c[0].Tcw for c in cand_p]).astype(np.float32)
            nb_O = np.stack([c[0].camera_center()
                             for c in cand_p]).astype(np.float32)
            avail1 = kf.feats.valid & (kf.mp_ids < 0)
            N1 = kf.feats.n_slots
            O1_dev = jnp.asarray(kf.camera_center().astype(np.float32))
            nb_O_dev = jnp.asarray(nb_O)
            Tcw1_dev = jnp.asarray(kf.Tcw.astype(np.float32))
            xy1_dev = jnp.asarray(kf.feats.xy_und)
            desc1_dev = jnp.asarray(kf.feats.desc)
            oct1_dev = jnp.asarray(kf.feats.octave)
            tri_args = (
                xy1_dev, desc1_dev,
                jnp.asarray(avail1), oct1_dev, jnp.asarray(kf.feats.angle),
                jnp.asarray(stack(lambda c: c[0].feats.xy_und)),
                jnp.asarray(stack(lambda c: c[0].feats.desc)),
                jnp.asarray(stack(
                    lambda c: c[0].feats.valid & (c[0].mp_ids < 0))),
                jnp.asarray(stack(lambda c: c[0].feats.octave)),
                jnp.asarray(stack(lambda c: c[0].feats.angle)),
                jnp.asarray(np.stack([c[1] for c in cand_p])),
                jnp.asarray(np.stack([c[2] for c in cand_p])),
                jnp.asarray(nb_valid), jnp.asarray(P1), jnp.asarray(P2_all),
                Tcw1_dev, jnp.asarray(nb_Tcw), O1_dev, nb_O_dev,
                jnp.asarray(np.linalg.inv(
                    cam.K.astype(np.float64)).astype(np.float32)),
                cam.fx, cam.fy, cam.cx, cam.cy,
                jnp.asarray(self.inv_sigma2), jnp.asarray(self.scale_factors),
                1.5 * orb.scale_factor,
            )
            fuse_args = None
            T_pad = PB = 0
            if do_fuse:
                T = len(targets)
                T_pad = (self.FUSE_T_SMALL if T <= self.FUSE_T_SMALL
                         else self.FUSE_T_MAX)
                tg_p = targets + [targets[0]] * (T_pad - T)
                tg_mask = np.zeros(T_pad, bool)
                tg_mask[:T] = True
                n2t = max(t.feats.n_slots for t in targets)
                stackt = lambda f, fill=0: np.stack(  # noqa: E731
                    [self._pad_slots(np.asarray(f(t)), n2t, fill)
                     for t in tg_p])
                if len(union) > self.FUSE_PB_MAX:
                    self.stats_fuse_truncated += 1
                    union = union[:self.FUSE_PB_MAX]
                PB = self._pad_pow2(len(union), lo=1024)
                A = self._point_data(src_slot_ids, N1)
                B = self._point_data(union, PB)
                fuse_args = (
                    xy1_dev, desc1_dev, jnp.asarray(kf.feats.valid),
                    oct1_dev, Tcw1_dev, O1_dev, nb_O_dev,
                    cam.fx, cam.fy, cam.cx, cam.cy,
                    float(cam.width), float(cam.height),
                    jnp.asarray(self.scale_factors),
                    float(np.log(orb.scale_factor)),
                    jnp.asarray(stackt(lambda t: t.feats.xy_und)),
                    jnp.asarray(stackt(lambda t: t.feats.desc)),
                    jnp.asarray(stackt(lambda t: t.feats.valid)),
                    jnp.asarray(stackt(lambda t: t.feats.octave)),
                    jnp.asarray(np.stack([t.Tcw[:3, :3] for t in tg_p])
                                .astype(np.float32)),
                    jnp.asarray(np.stack([t.Tcw[:3, 3] for t in tg_p])
                                .astype(np.float32)),
                    jnp.asarray(np.stack([t.camera_center() for t in tg_p])
                                .astype(np.float32)),
                    jnp.asarray(tg_mask),
                    jnp.asarray(A[0]), jnp.asarray(A[1]), jnp.asarray(A[2]),
                    jnp.asarray(A[3]), jnp.asarray(A[4]), jnp.asarray(A[5]),
                    jnp.asarray(B[0]), jnp.asarray(B[1]), jnp.asarray(B[2]),
                    jnp.asarray(B[3]), jnp.asarray(B[4]), jnp.asarray(B[5]),
                )
        with self.arena.unlocked(), st.stage("tri_fuse_device"):
            tri_dev = mapper_fused.tri_step(*tri_args)
            if do_fuse:
                buf = np.asarray(mapper_fused.fuse_step(
                    tri_dev, *fuse_args))
            else:
                buf = np.asarray(tri_dev).reshape(-1)
        with st.stage("tri_fuse_merge"):
            tri, idxA, idxB = mapper_fused.unpack_tri_fuse(
                buf, N1, T_pad, 2 * N1, PB, do_fuse)
            # Create accepted points (device gates are authoritative; the
            # arena-claim re-checks guard only against pads/defensive
            # staleness).
            created = []
            created_ids = [-1] * N1
            acc = tri[:, 0] > 0.5
            for i1 in np.nonzero(acc)[0]:
                m = int(tri[i1, 1])
                j2 = int(tri[i1, 2])
                kf2 = cand[m][0]
                if (j2 < 0 or kf.mp_ids[i1] >= 0
                        or kf2.mp_ids[j2] >= 0):
                    continue
                mp = self.arena.new_point(tri[i1, 3:6],
                                          kf.feats.desc[int(i1)],
                                          kf.id, kf.id)
                self.arena.add_observation(mp, kf, int(i1))
                self.arena.add_observation(mp, kf2, j2)
                self.recent_points.append((mp.id, kf.id))
                created.append(mp)
                created_ids[int(i1)] = mp.id
            if created:
                self.arena.compute_distinctive_many(created)
                self.arena.update_normals_many(created, self.scale_factors)
            if do_fuse:
                idsA = src_slot_ids + created_ids
                idsB = union + [-1] * (PB - len(union))
                touched: dict = {}
                for j, t_kf in enumerate(targets):
                    self._merge_fuse_matches(t_kf, idsA, idxA[j],
                                             False, touched)
                self._merge_fuse_matches(kf, idsB, idxB, False, touched)
                self._refresh_touched(touched)
                self.arena.update_connections(kf)

    # ----- fusion (reference SearchInNeighbors :235-293) -------------------

    def _fuse_sets(self, kf: KeyFrameRec):
        """Fusion target selection (first + second order covisible
        neighbors, reference SearchInNeighbors :240-258) plus the two
        point sets: the current KF's bound points (direction A) and the
        union of the targets' points (direction B)."""
        targets = []
        for nb in self.arena.covisible_ordered(kf, 20):
            targets.append(nb)
            nb_kf = self.arena.kfs.get(nb)
            if nb_kf is None:
                continue
            for nb2 in self.arena.covisible_ordered(nb_kf, 5):
                if nb2 != kf.id and nb2 not in targets:
                    targets.append(nb2)
        targets = [t for t in targets if t in self.arena.kfs]
        src_ids = [int(m) for m in kf.mp_ids
                   if m >= 0 and int(m) in self.arena.mps]
        union: list[int] = []
        seen_u: set[int] = set()
        for t_id in targets:
            t_kf = self.arena.kfs.get(t_id)
            if t_kf is None:
                continue
            for m in t_kf.mp_ids:
                if m >= 0 and int(m) not in seen_u and int(m) in self.arena.mps:
                    seen_u.add(int(m))
                    union.append(int(m))
        return targets, src_ids, union

    def search_in_neighbors(self, kf: KeyFrameRec):
        """Map-point fusion with first+second order covisible neighbors.
        The fork implements but never calls this (§0.1 row 3); upstream runs
        it when the queue is empty. Projects each side's points into the
        other and merges duplicates (ORBmatcher::Fuse semantics: replace the
        less-observed point). Standalone path — keyframe insertion normally
        runs this fused with triangulation (tri_and_fuse)."""
        targets, src_ids, union = self._fuse_sets(kf)
        if not targets:
            return
        # Direction A — current KF's points into ALL targets; direction B —
        # the union of the targets' points into the current KF. BOTH ride
        # ONE batched device program (the B call used to cost a second
        # device round trip per insertion).
        jobs = [(t, src_ids) for t in targets] + [(kf.id, union)]
        self._fuse_jobs(jobs)
        self.arena.update_connections(kf)

    def _project_for_fuse_many(self, dst_kfs, ids, radius_th=3.0):
        """Fuse-projection geometry (reference ORBmatcher::Fuse :504-548):
        in-front, in-image, scale-invariance distance band, viewing angle
        < 60 deg; predicted level + radius th*scale. Vectorized over BOTH
        the point set and the destination keyframes (the per-keyframe
        version re-gathered the point arrays ~15x per insertion).
        Returns (proj f32[M,P,2], radius f32[M,P], lvl i32[M,P],
        good bool[M,P])."""
        cam = self.cfg.camera
        mps = [self.arena.mps[m] for m in ids]
        pos = np.stack([mp.pos for mp in mps])                    # [P,3]
        normal = np.stack([mp.normal for mp in mps])
        maxd = np.asarray([max(1.2 * mp.max_dist, 1e-6) for mp in mps])
        mind = np.asarray([0.8 * mp.min_dist for mp in mps])
        R = np.stack([kf.Tcw[:3, :3] for kf in dst_kfs])          # [M,3,3]
        t = np.stack([kf.Tcw[:3, 3] for kf in dst_kfs])           # [M,3]
        ctr = np.stack([kf.camera_center() for kf in dst_kfs])    # [M,3]
        Xc = np.einsum("mij,pj->mpi", R, pos) + t[:, None, :]     # [M,P,3]
        z = Xc[..., 2]
        good = z > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = Xc[..., :2] / np.where(np.abs(z[..., None]) < 1e-9, 1e-9,
                                          z[..., None])
        proj = (proj * [cam.fx, cam.fy] + [cam.cx, cam.cy]).astype(np.float32)
        good &= ((proj[..., 0] >= 0) & (proj[..., 0] < cam.width)
                 & (proj[..., 1] >= 0) & (proj[..., 1] < cam.height))
        PO = pos[None] - ctr[:, None, :]                          # [M,P,3]
        dist = np.linalg.norm(PO, axis=2)
        good &= (dist >= mind[None]) & (dist <= maxd[None])
        good &= np.sum(PO * normal[None], axis=2) >= 0.5 * dist
        with np.errstate(divide="ignore", invalid="ignore"):
            lvl = np.ceil(np.log(np.maximum(maxd[None] / 1.2, 1e-9)
                                 / np.maximum(dist, 1e-9))
                          / np.log(self.cfg.orb.scale_factor))
        lvl = np.clip(np.nan_to_num(lvl, nan=0.0), 0,
                      self.cfg.orb.n_levels - 1).astype(np.int32)
        radius = (radius_th * self.scale_factors[lvl]).astype(np.float32)
        return proj, radius, lvl, good

    @staticmethod
    def _pad_pow2(n: int, lo: int = 256) -> int:
        return max(lo, 1 << (max(n, 1) - 1).bit_length())

    def _fuse_jobs(self, jobs, radius_th=3.0, replace_existing=False):
        """Fuse many (destination keyframe, point-id set) jobs with ONE
        batched device call (vmapped projection-set search), then
        host-merge per job. Jobs sharing the same id-list OBJECT (e.g. the
        current keyframe's points projected into every neighbor) share one
        vectorized projection pass."""
        # Filter each distinct caller-supplied id list ONCE and reuse the
        # resulting object, so the id(ids) grouping below actually shares
        # the projection pass across jobs that passed the same list (the
        # per-job fresh filtered lists used to defeat the grouping).
        filt: list[tuple[KeyFrameRec, list[int]]] = []
        filtered_by_src: dict[int, list[int]] = {}
        for dst_id, pids in jobs:
            dkf = self.arena.kfs.get(dst_id)
            ids = filtered_by_src.get(id(pids))
            if ids is None:
                ids = [m for m in pids if m in self.arena.mps]
                filtered_by_src[id(pids)] = ids
            if dkf is not None and ids:
                filt.append((dkf, ids))
        if not filt:
            return
        st = self.stage_ms
        M = len(filt)
        M_pad = max(8, 1 << (M - 1).bit_length())
        P_pad = self._pad_pow2(max(len(ids) for _, ids in filt))
        projs = np.zeros((M_pad, P_pad, 2), np.float32)
        radii = np.zeros((M_pad, P_pad), np.float32)
        lvls = np.zeros((M_pad, P_pad), np.int32)
        goods = np.zeros((M_pad, P_pad), bool)
        descs = np.zeros((M_pad, P_pad, 8), np.uint32)
        with st.stage("fuse_prep"):
            groups: dict[int, tuple[list[int], list[int]]] = {}
            for j, (_, ids) in enumerate(filt):
                groups.setdefault(id(ids), ([], ids))[0].append(j)
            for rows, ids in groups.values():
                proj, radius, lvl, good = self._project_for_fuse_many(
                    [filt[j][0] for j in rows], ids, radius_th)
                dgrp = np.stack([self.arena.mps[m].desc for m in ids])
                for k, j in enumerate(rows):
                    projs[j, :len(ids)] = proj[k]
                    radii[j, :len(ids)] = radius[k]
                    lvls[j, :len(ids)] = lvl[k]
                    goods[j, :len(ids)] = good[k]
                    descs[j, :len(ids)] = dgrp
            n2 = max(dkf.feats.n_slots for dkf, _ in filt)
            stackf = lambda f, fill=0: np.stack(  # noqa: E731
                [self._pad_slots(np.asarray(f(filt[min(m, M - 1)][0])), n2,
                                 fill)
                 for m in range(M_pad)])
            args = (
                jnp.asarray(projs), jnp.asarray(radii), jnp.asarray(lvls),
                jnp.asarray(goods), jnp.asarray(descs),
                jnp.asarray(stackf(lambda k: k.feats.xy_und)),
                jnp.asarray(stackf(lambda k: k.feats.desc)),
                jnp.asarray(stackf(lambda k: k.feats.valid)),
                jnp.asarray(stackf(lambda k: k.feats.octave)),
                jnp.asarray(np.zeros((M_pad, n2), bool)))
        with self.arena.unlocked(), st.stage("fuse_device"):
            idx2_all = np.asarray(
                matching.search_by_projection_set_batch(*args))
        # Merge job by job (later jobs see earlier replace chains), but
        # refresh descriptors/normals ONCE over the union of touched
        # points: the per-job refresh ran the [P,M,M] popcount pass up to
        # ~15x per insertion and was the largest host slice of
        # search_in_neighbors (matching decisions are unaffected — every
        # job's device matching used descriptors gathered before any
        # merge, exactly as built above).
        with st.stage("fuse_merge"):
            touched: dict[int, object] = {}
            for j, (dkf, ids) in enumerate(filt):
                self._merge_fuse_matches(dkf, ids, idx2_all[j],
                                         replace_existing, touched)
            self._refresh_touched(touched)

    def _refresh_touched(self, touched):
        """One batched descriptor + normal/depth-band refresh for every
        survivor the fuse merges touched (upstream SearchInNeighbors
        :282-292 runs ComputeDistinctiveDescriptors + UpdateNormalAndDepth
        per fused point; a stale band makes the 0.8/1.2 distance gates
        misjudge the merged point in every later projection search)."""
        if touched:
            survivors = list(touched.values())
            self.arena.compute_distinctive_many(survivors)
            self.arena.update_normals_many(survivors, self.scale_factors)

    def _merge_fuse_matches(self, dst_kf: KeyFrameRec, ids, idx2,
                            replace_existing=False, touched=None):
        """Apply fuse decisions: replace the less-observed duplicate or add
        the missing observation (reference Fuse :549-568). With
        replace_existing=True the incoming point always wins — the
        SearchAndFuse(Scw) loop-closing variant (reference Fuse(KF, Scw,...)
        + LoopClosing::SearchAndFuse :302-317, where corrected loop points
        replace current-map duplicates unconditionally).

        Touched survivors are accumulated into `touched` (or refreshed
        here when called standalone without one)."""
        own_refresh = touched is None
        if touched is None:
            touched = {}
        for k in np.nonzero(idx2[:len(ids)] >= 0)[0]:
            mp = self.arena.mps.get(ids[k])
            if mp is None or mp.bad or dst_kf.id in mp.obs:
                continue
            j = int(idx2[k])
            existing = int(dst_kf.mp_ids[j])
            if existing >= 0:
                other = self.arena.mps.get(existing)
                if other is not None and not other.bad and other.id != mp.id:
                    # Keep the more-observed point (reference Fuse :549-560),
                    # unless the loop variant forces the incoming point.
                    if not replace_existing and len(other.obs) > len(mp.obs):
                        self.arena.replace_point(mp, other,
                                                 refresh_desc=False)
                        touched[other.id] = other
                        touched.pop(mp.id, None)
                    else:
                        self.arena.replace_point(other, mp,
                                                 refresh_desc=False)
                        touched[mp.id] = mp
                        touched.pop(other.id, None)
            else:
                self.arena.add_observation(mp, dst_kf, int(j))
                touched[mp.id] = mp
        if own_refresh:
            self._refresh_touched(touched)

    # ----- local bundle adjustment ----------------------------------------

    def local_ba(self, kf: KeyFrameRec):
        """Reference PerformLocalBundleAdjustment -> Optimizer::
        LocalBundleAdjustment (src/Optimizer.cc:434-759): window = current KF
        + covisible KFs; points they observe; boundary KFs fixed."""
        with self.stage_ms.stage("ba_prep"):
            prob, cam_index, cam_fixed, pt_index, edge_refs = \
                self._local_ba_prep(kf)
        if prob is None:
            return
        cam = self.cfg.camera
        # ONE packed fetch for all three results (each fetched array costs
        # a host round trip); the map mutex is released
        # for the solve + fetch so tracking proceeds during it.
        C = int(prob.Tcw.shape[0])
        P = int(prob.points.shape[0])
        E = int(prob.e_cam.shape[0])
        with self.arena.unlocked(), self.stage_ms.stage("ba_device"):
            buf = np.asarray(local_bundle_adjustment_packed(
                prob, cam.fx, cam.fy, cam.cx, cam.cy))
            Tcw_new, X_new, inlier = unpack_local_ba(buf, C, P, E)
        with self.stage_ms.stage("ba_writeback"):
            self._local_ba_writeback(cam_index, cam_fixed, pt_index,
                                     edge_refs, Tcw_new, X_new, inlier)

    def _local_ba_prep(self, kf: KeyFrameRec):
        """Window/point/edge collection + padded problem assembly."""
        cam = self.cfg.camera
        window = [kf.id] + self.arena.covisible_ordered(kf, BA_CAMS - 2)
        window = window[:BA_CAMS - 1]
        window_set = set(window)
        # Collect points.
        pt_ids: list[int] = []
        seen = set()
        for w_id in window:
            w_kf = self.arena.kfs.get(w_id)
            if w_kf is None:
                continue
            for mid in w_kf.mp_ids:
                if mid >= 0 and int(mid) not in seen:
                    mp = self.arena.mps.get(int(mid))
                    if mp is not None and not mp.bad:
                        seen.add(int(mid))
                        pt_ids.append(int(mid))
        pt_ids = pt_ids[:BA_POINTS]
        pt_index = {m: i for i, m in enumerate(pt_ids)}
        # Fixed boundary cams: observe window points but not in window.
        fixed: list[int] = []
        for m in pt_ids:
            for kf_id in self.arena.mps[m].obs:
                if kf_id not in window_set and kf_id not in fixed:
                    fixed.append(kf_id)
        fixed = fixed[:BA_CAMS - len(window)]
        cams = window + fixed
        cam_index = {c: i for i, c in enumerate(cams)}
        C = BA_CAMS
        Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        cam_fixed = np.ones(C, bool)
        cam_valid = np.zeros(C, bool)
        for c_id, i in cam_index.items():
            Tcw[i] = self.arena.kfs[c_id].Tcw
            cam_valid[i] = True
            cam_fixed[i] = (c_id in fixed) or (c_id == self.arena.kf_origin_id)
        if (~cam_fixed & cam_valid).sum() == 0:
            return None, None, None, None, None
        P_b = _bucket(len(pt_ids), BA_PT_BUCKETS)
        pts = np.zeros((P_b, 3), np.float32)
        pt_valid = np.zeros(P_b, bool)
        for m, i in pt_index.items():
            pts[i] = self.arena.mps[m].pos
            pt_valid[i] = True
        # Edge build: pure-Python triple collection (cheap appends), then
        # vectorized per-camera gathers — the scalar per-edge numpy writes
        # this replaces were a measurable slice of keyframe-time host work.
        tri_pt: list[int] = []          # point slot
        tri_cam: list[int] = []         # camera slot
        tri_fidx: list[int] = []        # feature index in that keyframe
        edge_refs: list[tuple[int, int]] = []  # (mp_id, kf_id)
        for m in pt_ids:
            pi = pt_index[m]
            for kf_id, fidx in self.arena.mps[m].obs.items():
                ci = cam_index.get(kf_id)
                if ci is None or len(tri_pt) >= BA_EDGES:
                    continue
                tri_pt.append(pi)
                tri_cam.append(ci)
                tri_fidx.append(fidx)
                edge_refs.append((m, kf_id))
        n_e = len(tri_pt)
        if n_e < 10:
            return None, None, None, None, None
        E_b = _bucket(n_e, BA_EDGE_BUCKETS)
        e_cam = np.zeros(E_b, np.int32)
        e_pt = np.zeros(E_b, np.int32)
        e_uv = np.zeros((E_b, 2), np.float32)
        e_ur = np.full(E_b, -1.0, np.float32)
        e_is2 = np.ones(E_b, np.float32)
        e_valid = np.zeros(E_b, bool)
        e_cam[:n_e] = tri_cam
        e_pt[:n_e] = tri_pt
        e_valid[:n_e] = True
        fidx_arr = np.asarray(tri_fidx, np.int64)
        cam_arr = e_cam[:n_e]
        for c_id, ci in cam_index.items():
            rows = np.nonzero(cam_arr == ci)[0]
            if rows.size == 0:
                continue
            w_kf = self.arena.kfs[c_id]
            f = fidx_arr[rows]
            e_uv[rows] = w_kf.feats.xy_und[f]
            if w_kf.feats.u_right is not None:
                e_ur[rows] = w_kf.feats.u_right[f]
            e_is2[rows] = self.inv_sigma2[w_kf.feats.octave[f]]
        prob = BAProblem(
            Tcw=jnp.asarray(Tcw), cam_fixed=jnp.asarray(cam_fixed),
            cam_valid=jnp.asarray(cam_valid), points=jnp.asarray(pts),
            pt_valid=jnp.asarray(pt_valid), e_cam=jnp.asarray(e_cam),
            e_pt=jnp.asarray(e_pt), e_uv=jnp.asarray(e_uv),
            e_inv_sigma2=jnp.asarray(e_is2), e_valid=jnp.asarray(e_valid),
            e_ur=jnp.asarray(e_ur), bf=self.cfg.camera.bf)
        return prob, cam_index, cam_fixed, pt_index, edge_refs

    def _local_ba_writeback(self, cam_index, cam_fixed, pt_index, edge_refs,
                            Tcw_new, X_new, inlier):
        """Apply the solved window (reference :692-738, under the
        map-update mutex there)."""
        pt_ids = list(pt_index)
        for c_id, i in cam_index.items():
            if not cam_fixed[i]:
                self.arena.kfs[c_id].Tcw = Tcw_new[i].copy()
        self.arena.version += 1  # point positions move (local-map cache)
        for m, i in pt_index.items():
            mp = self.arena.mps.get(m)
            if mp is not None:
                self.arena.set_point_pos(mp, X_new[i])
        # Erase outlier observations.
        for k, (m, kf_id) in enumerate(edge_refs):
            if not inlier[k]:
                mp = self.arena.mps.get(m)
                if mp is not None:
                    self.arena.erase_observation(mp, kf_id)
        self.arena.update_normals_many(
            [mp for m in pt_ids
             if (mp := self.arena.mps.get(m)) is not None and not mp.bad],
            self.scale_factors)
        self._abort_ba = False

    # ----- keyframe culling (reference :382-410) ---------------------------

    def cull_keyframes(self, kf: KeyFrameRec):
        """Erase local keyframes whose map points are >=90% redundantly
        observed by >=3 other keyframes at the same or finer scale
        (reference KeyFrameCulling src/LocalMapping.cc:382-410).

        Columnar formulation over arena.obs_table(): the reference's (and
        the old implementation's) triple nested loop is
        O(neighbors x points x observations) in Python and dominated
        keyframe time as the map grew; here each neighbor is a handful of
        vectorized gathers and one segment count."""
        obs_sorted = None
        for nb_id in self.arena.covisible_ordered(kf):
            nb = self.arena.kfs.get(nb_id)
            if nb is None or nb.id == self.arena.kf_origin_id:
                continue
            if obs_sorted is None or obs_sorted[0] != self.arena.version:
                kf_r, _, mp_r, oct_r = self.arena.obs_table()
                order = np.argsort(mp_r, kind="stable")
                mp_s, kf_s, oct_s = mp_r[order], kf_r[order], oct_r[order]
                uniq, start = np.unique(mp_s, return_index=True)
                end = np.append(start[1:], len(mp_s))
                obs_sorted = (self.arena.version, mp_s, kf_s, oct_s,
                              uniq, start, end)
            _, mp_s, kf_s, oct_s, uniq, start, end = obs_sorted
            slots = np.nonzero(nb.mp_ids >= 0)[0]
            if not len(slots) or not len(uniq):
                continue
            mids = nb.mp_ids[slots].astype(np.int64)
            pos = np.searchsorted(uniq, mids)
            posc = np.minimum(pos, len(uniq) - 1)
            found = (pos < len(uniq)) & (uniq[posc] == mids)
            slots, posc = slots[found], posc[found]
            n_pts = len(slots)
            if n_pts == 0:
                continue
            levels = nb.feats.octave[slots].astype(np.int64)
            s, e = start[posc], end[posc]
            lens = e - s
            total = int(lens.sum())
            # Flat row indices of every observation of the neighbor's
            # points: repeat each range start and add a within-range ramp.
            ramp = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            flat = np.repeat(s, lens) + ramp
            point_row = np.repeat(np.arange(n_pts), lens)
            fine = ((kf_s[flat] != nb.id)
                    & (oct_s[flat] <= levels[point_row] + 1))
            cnt = np.bincount(point_row[fine], minlength=n_pts)
            n_redundant = int((cnt >= 3).sum())
            if n_redundant > 0.9 * n_pts:
                # erase_keyframe bumps the version; the sorted table
                # rebuilds for the next neighbor so later counts exclude
                # this keyframe's observations (matching the sequential
                # reference semantics).
                self.arena.erase_keyframe(nb)
