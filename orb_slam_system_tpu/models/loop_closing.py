"""Loop closing: detection, Sim3 computation, loop correction.

Replaces reference LoopClosing (src/LoopClosing.cc) with upstream-complete
semantics (the fork's CorrectLoop never adds loop edges or runs GBA,
SURVEY.md §0.1 rows 7-8 — both restored here):
  * DetectLoop (:55-125): BoW candidates gated by the min covisible score,
    3-consecutive covisibility-group consistency (consistency threshold 3,
    :17), candidate list cleared at entry (fixing fork row 8).
  * ComputeSim3 (:127-208): per-candidate BoW matching >= 20, batched Sim3
    RANSAC, projection-guided match top-up, OptimizeSim3 >= 20 inliers.
  * CorrectLoop (:225-300 + upstream RunGlobalBundleAdjustment :340-410):
    corrected-Sim3 propagation over the covisible group, map-point
    correction, loop-point fusion, essential-graph optimization, loop edge
    insertion, and (bounded-size) global BA.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from orb_slam_system_tpu.config import SlamConfig
from orb_slam_system_tpu.mapping.arena import KeyFrameRec, MapArena, hamming_np
from orb_slam_system_tpu.models.place_recognition import PlaceRecognition
from orb_slam_system_tpu.ops import matching
from orb_slam_system_tpu.solvers.pose_graph import (
    optimize_essential_graph,
    optimize_sim3,
)
from orb_slam_system_tpu.solvers.sim3 import (
    make_sim3_sample_sets, sim3_ransac_batch)
from orb_slam_system_tpu.vocab.vocabulary import Vocabulary

CONSISTENCY_TH = 3      # reference src/LoopClosing.cc:17
MIN_KFS_BETWEEN = 10    # reference :61
GBA_DENSE_MAX_CAMS = 48  # dense-Schur GBA bucket; larger maps use the
                         # implicit Schur-CG solver (scales O(E)/iteration)


class LoopCloser:
    def __init__(self, cfg: SlamConfig, arena: MapArena,
                 place_rec: PlaceRecognition, local_mapper):
        self.cfg = cfg
        self.arena = arena
        self.place_rec = place_rec
        self.local_mapper = local_mapper
        self.last_loop_kf_id = -1
        self.consistent_groups: List[tuple[set, int]] = []
        self.scale_factors = np.asarray(cfg.orb.level_scales(), np.float32)
        self.inv_sigma2 = (1.0 / self.scale_factors ** 2).astype(np.float32)
        self.n_loops_closed = 0
        self.debug = False
        # Funnel counters (diagnosing WHERE loop attempts die on long
        # runs): detect calls -> db candidates -> consistency-passing ->
        # sim3 attempts -> each rejection gate -> accepts.
        from collections import Counter
        self.stats = Counter()
        self.gba = GBARunner()
        # Synchronous GBA keeps unit tests deterministic; the upstream
        # behavior (side thread + propagation to keyframes created during
        # the solve) is the default.
        import os
        self.sync_gba = os.environ.get("ORB_SLAM_TPU_SYNC_GBA", "0") == "1"

        from orb_slam_system_tpu.config import Sensor
        self.fix_scale = cfg.sensor != Sensor.MONOCULAR

    # ------------------------------------------------------------------

    def process(self, kf_id: int):
        """One pass of the loop thread body (reference Run :28-41)."""
        kf = self.arena.kfs.get(kf_id)
        if kf is None or not self.place_rec.ready:
            return False
        candidates = self.detect_loop(kf)
        if not candidates:
            return False
        ok, matched_kf, Scw, loop_points, cur_matches = self.compute_sim3(
            kf, candidates)
        if not ok:
            return False
        # Correction-exclusion (arena.correction_lock doc): no tracking
        # frame may interleave a map-wide pose rewrite. Lock ORDER is
        # correction_lock > arena.lock, and the caller (mapping worker
        # stage / sync pump) holds arena.lock — release it while
        # acquiring the outer lock, like upstream's CorrectLoop taking
        # mMutexMapUpdate after stopping local mapping
        # (src/LoopClosing.cc:227-253). Re-entrant when the tracker's
        # own thread runs sync mapping inside its frame span.
        with self.arena.unlocked():
            self.arena.correction_lock.acquire()
        try:
            self.correct_loop(kf, matched_kf, Scw, loop_points,
                              cur_matches)
        finally:
            self.arena.correction_lock.release()
        self.n_loops_closed += 1
        return True

    # ------------------------------------------------------------------

    def detect_loop(self, kf: KeyFrameRec) -> List[int]:
        """Reference DetectLoop (:55-125)."""
        if kf.id < self.last_loop_kf_id + MIN_KFS_BETWEEN or \
                self.arena.n_keyframes() < MIN_KFS_BETWEEN:
            return []
        if kf.bow is None:
            return []
        # Min score against covisible neighbors (:67-74).
        min_score = 1.0
        for nb in kf.covis:
            nb_kf = self.arena.kfs.get(nb)
            if nb_kf is not None and nb_kf.bow is not None:
                s = Vocabulary.score(kf.bow, nb_kf.bow)
                min_score = min(min_score, s)
        candidates = self.place_rec.db.detect_loop_candidates(
            kf.id, kf.bow, min_score, self.arena)
        self.stats["detect_calls"] += 1
        if candidates:
            self.stats["db_candidates"] += 1
        if self.debug:
            print(f"[loop] kf {kf.id}: min_score={min_score:.3f} "
                  f"db_candidates={candidates} "
                  f"groups={[(sorted(g)[:3], c) for g, c in self.consistent_groups]}",
                  flush=True)
        if not candidates:
            self.consistent_groups = []
            return []
        # Covisibility-consistency over consecutive detections (:84-117).
        enough: List[int] = []
        new_groups: List[tuple[set, int]] = []
        for cand in candidates:
            ckf = self.arena.kfs.get(cand)
            if ckf is None:
                continue
            group = set(ckf.covis) | {cand}
            consistent_for = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    consistent_for = max(consistent_for, prev_count + 1)
            new_groups.append((group, consistent_for))
            if consistent_for >= CONSISTENCY_TH:
                enough.append(cand)
        self.consistent_groups = new_groups
        if enough:
            self.stats["consistent"] += 1
        return enough

    # ------------------------------------------------------------------

    def compute_sim3(self, kf: KeyFrameRec, candidates: List[int]):
        """Reference ComputeSim3 (:127-208), candidate-parallel on device:
        stage 1 runs ONE batched KF-KF BoW match (with the unconstrained
        retry in-program) over ALL candidates, stage 2 ONE batched Sim3
        RANSAC over those passing the >=20 gate — the per-candidate
        version paid 2-3 device round trips per candidate, nearly all on
        attempts that die at the BoW gate. The refinement tail
        (SearchBySim3 top-up, OptimizeSim3, projection gate) runs only
        for RANSAC-passing candidates, first winner taken in candidate
        order as upstream."""
        ckfs = [(cid, c) for cid in candidates
                if (c := self.arena.kfs.get(cid)) is not None and not c.bad]
        if not ckfs:
            return False, None, None, None, None
        match_lists = self._match_keyframes_batch(kf, [c for _, c in ckfs])
        eligible = []
        for (cand_id, ckf), m in zip(ckfs, match_lists):
            self.stats["sim3_attempts"] += 1
            if self.debug:
                print(f"[loop] sim3 kf {kf.id} vs cand {cand_id}: "
                      f"bow_matches={len(m)}", flush=True)
            if len(m) < 20:
                self.stats["rej_bow_lt20"] += 1
                continue
            rows1 = np.asarray([a for a, b in m])
            rows2 = np.asarray([b for a, b in m])
            # Camera-frame 3D positions of the matched map points.
            P1, ok1 = self._cam_points(kf, rows1)
            P2, ok2 = self._cam_points(ckf, rows2)
            ok = ok1 & ok2
            if ok.sum() < 20:
                continue
            eligible.append((ckf, rows1, rows2, P1, P2, ok))
        if not eligible:
            return False, None, None, None, None
        cam = self.cfg.camera
        C = len(eligible)
        C_pad = max(2, 1 << (C - 1).bit_length())
        N_pad = max(64, 1 << (max(len(e[1]) for e in eligible) - 1)
                    .bit_length())
        P1b = np.zeros((C_pad, N_pad, 3), np.float32)
        P2b = np.zeros((C_pad, N_pad, 3), np.float32)
        uv1b = np.zeros((C_pad, N_pad, 2), np.float32)
        uv2b = np.zeros((C_pad, N_pad, 2), np.float32)
        m1b = np.ones((C_pad, N_pad), np.float32)
        m2b = np.ones((C_pad, N_pad), np.float32)
        okb = np.zeros((C_pad, N_pad), bool)
        for k, (ckf, rows1, rows2, P1, P2, ok) in enumerate(eligible):
            n = len(rows1)
            P1b[k, :n] = P1
            P2b[k, :n] = P2
            uv1b[k, :n] = kf.feats.xy_und[rows1]
            uv2b[k, :n] = ckf.feats.xy_und[rows2]
            m1b[k, :n] = 9.21 * (1.0 / self.inv_sigma2)[
                kf.feats.octave[rows1]]
            m2b[k, :n] = 9.21 * (1.0 / self.inv_sigma2)[
                ckf.feats.octave[rows2]]
            okb[k, :n] = ok
        sets = make_sim3_sample_sets(N_pad, 300, 0)
        # Inputs are immutable copies: release the map mutex for the
        # RANSAC device round trip so tracking proceeds (loop closure
        # runs on the async mapping worker).
        with self.arena.unlocked():
            out = np.asarray(sim3_ransac_batch(
                jnp.asarray(P1b), jnp.asarray(P2b), jnp.asarray(uv1b),
                jnp.asarray(uv2b), jnp.asarray(m1b), jnp.asarray(m2b),
                jnp.asarray(okb), jnp.asarray(sets),
                cam.fx, cam.fy, cam.cx, cam.cy, fix_scale=self.fix_scale))
        for k, (ckf, rows1, rows2, P1, P2, ok) in enumerate(eligible):
            okr = out[k, 0] > 0.5
            s12 = out[k, 1]
            R12 = out[k, 2:11].reshape(3, 3)
            t12 = out[k, 11:14]
            inl = out[k, 14:14 + len(rows1)] > 0.5
            if self.debug:
                print(f"[loop]   ransac ok={bool(okr)} "
                      f"inl={int(inl.sum())} s={float(s12):.3f}", flush=True)
            if not bool(okr):
                self.stats["rej_ransac"] += 1
                continue
            # Sim3-guided mutual re-search tops up the RANSAC-inlier BoW
            # matches (upstream LoopClosing::ComputeSim3 :184-190 +
            # ORBmatcher::SearchBySim3) — marginal loops whose BoW matches
            # barely clear RANSAC gain the extra correspondences needed to
            # reach the OptimizeSim3 and >=40 gates.
            matches12 = {int(rows1[k]): int(rows2[k])
                         for k in np.nonzero(np.asarray(inl))[0]}
            matches12.update(self._search_by_sim3(
                kf, ckf, float(s12), np.asarray(R12), np.asarray(t12),
                matches12, th=7.5))
            if self.debug:
                print(f"[loop]   after SearchBySim3: {len(matches12)} "
                      f"matches", flush=True)
            if len(matches12) < 20:
                self.stats["rej_sim3_search_lt20"] += 1
                continue
            rows1 = np.asarray(sorted(matches12), np.int64)
            rows2 = np.asarray([matches12[i] for i in rows1], np.int64)
            P1, ok1 = self._cam_points(kf, rows1)
            P2, ok2 = self._cam_points(ckf, rows2)
            ok = ok1 & ok2
            uv1 = kf.feats.xy_und[rows1].astype(np.float32)
            uv2 = ckf.feats.xy_und[rows2].astype(np.float32)
            # Refine with OptimizeSim3 (>=20 inliers, :195-206).
            with self.arena.unlocked():
                n_in, s_f, R_f, t_f, inl_f = optimize_sim3(
                    s12, R12, t12, jnp.asarray(P1), jnp.asarray(P2),
                    jnp.asarray(uv1), jnp.asarray(uv2),
                    jnp.asarray(self.inv_sigma2[kf.feats.octave[rows1]]),
                    jnp.asarray(self.inv_sigma2[ckf.feats.octave[rows2]]),
                    jnp.asarray(ok), cam.fx, cam.fy, cam.cx, cam.cy,
                    fix_scale=self.fix_scale)
            if self.debug:
                print(f"[loop]   optimize_sim3 inliers={int(n_in)}", flush=True)
            if int(n_in) < 20:
                self.stats["rej_opt_lt20"] += 1
                continue
            # Scw = S12 * T2w  (Sim3 world -> current KF camera).
            s_f = float(s_f)
            R_f = np.asarray(R_f)
            t_f = np.asarray(t_f)
            T2w = ckf.Tcw
            R_cw = R_f @ T2w[:3, :3]
            t_cw = s_f * (R_f @ T2w[:3, 3]) + t_f
            Scw = {"s": s_f, "R": R_cw.astype(np.float32),
                   "t": t_cw.astype(np.float32)}
            # Loop map points: candidate KF + its neighbors' points (:210-222).
            loop_points = self._collect_loop_points(ckf)
            cur_matches = {int(rows1[k]): int(ckf.mp_ids[rows2[k]])
                           for k in np.nonzero(np.asarray(inl_f))[0]
                           if ckf.mp_ids[rows2[k]] >= 0}
            # Project ALL loop points into the current KF with Scw and
            # require >=40 total matches to accept the loop (upstream
            # LoopClosing::ComputeSim3 :192-206; failing the gate aborts
            # the whole attempt, not just this candidate).
            n_before = len(cur_matches)
            self._project_loop_points(kf, Scw, loop_points, cur_matches,
                                      th=10.0)
            if self.debug:
                print(f"[loop]   total matches {len(cur_matches)} "
                      f"(+{len(cur_matches) - n_before} projected); "
                      f"gate >= 40", flush=True)
            if len(cur_matches) < 40:
                self.stats["rej_project_lt40"] += 1
                return False, None, None, None, None
            self.stats["accept"] += 1
            return True, ckf, Scw, loop_points, cur_matches
        return False, None, None, None, None

    def _match_keyframes_batch(self, kf1: KeyFrameRec, ckfs):
        """SearchByBoW(KF,KF) (reference src/ORBmatcher.cc:278-366,
        upstream-complete) over ALL loop candidates in ONE device call
        (matching.search_by_node_id_retry_batch): node-constrained
        ratio-test matching restricted to features with map points, with
        the unconstrained fallback IN-PROGRAM (the node constraint exists
        upstream for speed; our matching is one dense matmul either
        way, and a shallow self-trained vocabulary under-populates nodes —
        the Sim3 RANSAC + OptimizeSim3 gates downstream keep precision).

        Returns one [(slot1, slot2), ...] list per candidate."""
        from orb_slam_system_tpu.models.local_mapping import LocalMapper
        has1 = (kf1.mp_ids >= 0) & kf1.feats.valid
        n1 = kf1.node_ids if kf1.node_ids is not None else np.zeros(
            kf1.feats.n_slots, np.int32)
        C = len(ckfs)
        C_pad = max(2, 1 << (C - 1).bit_length())
        ckfs_p = list(ckfs) + [ckfs[0]] * (C_pad - C)
        n2max = max(k.feats.n_slots for k in ckfs)
        pad = LocalMapper._pad_slots

        def stack(f, fill=0):
            return np.stack([pad(np.asarray(f(k)), n2max, fill)
                             for k in ckfs_p])

        has2 = stack(lambda k: (k.mp_ids >= 0) & k.feats.valid)
        node2 = stack(lambda k: (
            k.node_ids if k.node_ids is not None
            else np.zeros(k.feats.n_slots, np.int32)))
        node2 = np.where(has2, node2, -1)
        res = matching.search_by_node_id_retry_batch(
            jnp.asarray(kf1.feats.desc), jnp.asarray(has1),
            jnp.asarray(kf1.feats.angle),
            jnp.asarray(np.where(has1, n1, -1)),
            jnp.asarray(stack(lambda k: k.feats.desc)), jnp.asarray(has2),
            jnp.asarray(stack(lambda k: k.feats.angle)),
            jnp.asarray(node2), nn_ratio=0.75)
        # Inputs are device copies: release the map mutex for the fetch
        # (one device round trip) so tracking's host phases proceed.
        with self.arena.unlocked():
            idx2_all = np.asarray(res)
        return [[(int(i), int(row[i])) for i in np.nonzero(row >= 0)[0]]
                for row in idx2_all[:C]]

    def _slot_points(self, kf: KeyFrameRec, exclude=frozenset()):
        """Per-feature-slot map-point arrays (descriptor, world position,
        scale-invariance band, validity) for Sim3-guided search —
        vectorized gathers from the arena's columnar point snapshot
        (the per-slot dict-lookup loop scaled linearly with slot count in
        Python)."""
        N = kf.feats.n_slots
        desc = np.zeros((N, 8), np.uint32)
        pos = np.zeros((N, 3), np.float32)
        mind = np.zeros(N, np.float32)
        maxd = np.ones(N, np.float32)
        rows, ok = self.arena.lookup_points(kf.mp_ids)
        if exclude:
            ok = ok.copy()
            ok[np.fromiter(exclude, np.int64, len(exclude))] = False
        if ok.any():
            (_, c_pos, c_desc, c_mind, c_maxd,
             _n_obs, _normal) = self.arena.point_columns()
            r = rows[ok]
            desc[ok] = c_desc[r]
            pos[ok] = c_pos[r]
            mind[ok] = 0.8 * c_mind[r]
            maxd[ok] = np.maximum(1.2 * c_maxd[r], 1e-6)
        return desc, pos, mind, maxd, ok

    def _sim3_guided_geometry(self, pos, mind, maxd, ok, sR, t, th):
        """Project world points into a camera via Sim3 (sR, t): returns
        (proj f32[N,2], radius f32[N], pred_level i32[N], ok bool[N])."""
        cam = self.cfg.camera
        Xc = pos @ sR.T + t
        z = Xc[:, 2]
        good = ok & (z > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = Xc[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9,
                                        z[:, None])
        proj = (proj * [cam.fx, cam.fy] + [cam.cx, cam.cy]).astype(np.float32)
        good &= ((proj[:, 0] >= 0) & (proj[:, 0] < cam.width)
                 & (proj[:, 1] >= 0) & (proj[:, 1] < cam.height))
        dist = np.linalg.norm(Xc, axis=1)
        good &= (dist >= mind) & (dist <= maxd)
        with np.errstate(divide="ignore", invalid="ignore"):
            lvl = np.ceil(np.log(np.maximum(maxd / 1.2, 1e-9)
                                 / np.maximum(dist, 1e-9))
                          / np.log(self.cfg.orb.scale_factor))
        lvl = np.clip(np.nan_to_num(lvl, nan=0.0), 0,
                      self.cfg.orb.n_levels - 1).astype(np.int32)
        radius = (th * self.scale_factors[lvl]).astype(np.float32)
        return proj, radius, lvl, good

    def _search_by_sim3(self, kf1: KeyFrameRec, kf2: KeyFrameRec,
                        s12: float, R12, t12, matches12: Dict[int, int],
                        th: float = 7.5) -> Dict[int, int]:
        """Mutual Sim3-guided re-search (upstream ORBmatcher::SearchBySim3;
        reference fork's one-directional copy at src/ORBmatcher.cc:636-730).
        S12 maps cam2 -> cam1 coordinates. Returns NEW {slot1: slot2} pairs
        not in matches12."""
        used2 = set(matches12.values())
        d1, p1w, mind1, maxd1, ok1 = self._slot_points(
            kf1, exclude=set(matches12))
        d2, p2w, mind2, maxd2, ok2 = self._slot_points(kf2, exclude=used2)
        if ok1.sum() == 0 or ok2.sum() == 0:
            return {}
        sR21 = (1.0 / s12) * R12.T
        t21 = -(sR21 @ t12)
        sR12 = s12 * R12
        # World -> cam2 for KF1's points: T2w? No — reference goes world ->
        # cam1 (SE3) -> cam2 (S21); composing gives sR21@R1w, sR21@t1w+t21.
        R1w, t1w = kf1.Tcw[:3, :3], kf1.Tcw[:3, 3]
        R2w, t2w = kf2.Tcw[:3, :3], kf2.Tcw[:3, 3]
        proj1, rad1, lvl1, good1 = self._sim3_guided_geometry(
            p1w, mind1, maxd1, ok1, sR21 @ R1w, sR21 @ t1w + t21, th)
        proj2, rad2, lvl2, good2 = self._sim3_guided_geometry(
            p2w, mind2, maxd2, ok2, sR12 @ R2w, sR12 @ t2w + t12, th)
        res = matching.search_by_sim3(
            jnp.asarray(d1), jnp.asarray(proj1), jnp.asarray(rad1),
            jnp.asarray(lvl1), jnp.asarray(good1),
            jnp.asarray(d2), jnp.asarray(proj2), jnp.asarray(rad2),
            jnp.asarray(lvl2), jnp.asarray(good2),
            jnp.asarray(kf1.feats.desc), jnp.asarray(kf1.feats.xy_und),
            jnp.asarray(kf1.feats.valid), jnp.asarray(kf1.feats.octave),
            jnp.asarray(kf2.feats.desc), jnp.asarray(kf2.feats.xy_und),
            jnp.asarray(kf2.feats.valid), jnp.asarray(kf2.feats.octave))
        with self.arena.unlocked():
            idx2 = np.asarray(res)
        return {int(i): int(j) for i, j in enumerate(idx2) if j >= 0}

    def _project_loop_points(self, kf: KeyFrameRec, Scw: dict,
                             loop_points: List[int],
                             cur_matches: Dict[int, int], th: float = 10.0):
        """Project loop map points into the current KF with Scw and claim
        unmatched feature slots (upstream SearchByProjection(KF, Scw, ...)
        reference src/ORBmatcher.cc:121-195, TH_LOW, radius th*scale;
        feeds the >=40 total-match gate, LoopClosing.cc:184-206)."""
        already_pts = set(cur_matches.values())
        ids = [m for m in loop_points
               if m not in already_pts and m in self.arena.mps
               and not self.arena.mps[m].bad]
        if not ids:
            return
        pos = np.stack([self.arena.mps[m].pos for m in ids])
        desc = np.stack([self.arena.mps[m].desc for m in ids])
        mind = np.asarray([0.8 * self.arena.mps[m].min_dist for m in ids],
                          np.float32)
        maxd = np.asarray(
            [max(1.2 * self.arena.mps[m].max_dist, 1e-6) for m in ids],
            np.float32)
        R_p = Scw["R"]
        t_p = Scw["t"] / Scw["s"]
        proj, radius, lvl, good = self._sim3_guided_geometry(
            pos, mind, maxd, np.ones(len(ids), bool), R_p, t_p, th)
        already = np.zeros(kf.feats.n_slots, bool)
        for fi in cur_matches:
            already[fi] = True
        res = matching.search_by_projection_set(
            jnp.asarray(proj), jnp.asarray(radius), jnp.asarray(lvl),
            jnp.asarray(good), jnp.asarray(desc),
            jnp.asarray(kf.feats.xy_und), jnp.asarray(kf.feats.desc),
            jnp.asarray(kf.feats.valid), jnp.asarray(kf.feats.octave),
            jnp.asarray(already), max_dist=matching.TH_LOW)
        with self.arena.unlocked():
            idx2 = np.asarray(res.idx2)
        for k in np.nonzero(idx2 >= 0)[0]:
            slot = int(idx2[k])
            if slot not in cur_matches:
                cur_matches[slot] = ids[k]

    def _cam_points(self, kf: KeyFrameRec, rows):
        P = np.zeros((len(rows), 3), np.float32)
        ok = np.zeros(len(rows), bool)
        for k, r in enumerate(rows):
            mid = int(kf.mp_ids[r])
            if mid >= 0:
                mp = self.arena.mps.get(mid)
                if mp is not None and not mp.bad:
                    P[k] = kf.Tcw[:3, :3] @ mp.pos + kf.Tcw[:3, 3]
                    ok[k] = True
        return P, ok

    def _collect_loop_points(self, ckf: KeyFrameRec) -> List[int]:
        ids = set()
        for kf_id in [ckf.id] + self.arena.covisible_ordered(ckf):
            kf = self.arena.kfs.get(kf_id)
            if kf is None:
                continue
            for mid in kf.mp_ids:
                if mid >= 0 and int(mid) in self.arena.mps:
                    ids.add(int(mid))
        return list(ids)

    # ------------------------------------------------------------------

    def correct_loop(self, kf: KeyFrameRec, matched_kf: KeyFrameRec,
                     Scw: dict, loop_points: List[int], cur_matches: Dict[int, int]):
        """Reference CorrectLoop (:225-300) + upstream loop-edge insertion
        and global BA (:340-410)."""
        arena = self.arena
        # Bump the pose epoch at START as well as end: the fuse stages
        # below release arena.lock around their device fetches, so a
        # concurrent reader holding only arena.lock (chain bootstrap)
        # can observe a HALF-corrected map — a start bump guarantees any
        # state built across any part of the rewrite is recognizably
        # stale. (Tracking frames themselves are excluded wholesale by
        # correction_lock.)
        arena.pose_epoch += 1
        # 1. Corrected Sim3 for current KF + covisible group (:246-270).
        Twc = np.linalg.inv(kf.Tcw)
        group = [kf.id] + arena.covisible_ordered(kf)
        corrected: Dict[int, dict] = {}
        non_corrected: Dict[int, np.ndarray] = {}
        for g_id in group:
            gkf = arena.kfs.get(g_id)
            if gkf is None:
                continue
            non_corrected[g_id] = gkf.Tcw.copy()
            Tic = gkf.Tcw @ Twc
            Ric, tic = Tic[:3, :3], Tic[:3, 3]
            # S_i_corr = T_ic * Scw. The LEFT factor T_ic is SE3 (scale 1),
            # so per Sim3 composition t = s_left*(R_left*t_right)+t_left
            # the translation is Ric@t_cw + tic with s_left = 1 (g2o
            # sim3.h:266-271); using Scw's scale here biased every
            # corrected pose in the group by s (the current KF itself,
            # where T_ic = I, must map to exactly Scw).
            R_n = Ric @ Scw["R"]
            t_n = Ric @ Scw["t"] + tic
            corrected[g_id] = {"s": Scw["s"], "R": R_n, "t": t_n}
        # 2. Correct the group's map points + update poses (:253-290).
        moved: set[int] = set()
        moved_recs = []
        for g_id, S_n in corrected.items():
            gkf = arena.kfs[g_id]
            T_old = non_corrected[g_id]
            for mid in gkf.mp_ids:
                if mid < 0 or int(mid) in moved:
                    continue
                mp = arena.mps.get(int(mid))
                if mp is None or mp.bad:
                    continue
                # p_corrected = S_corr^-1( S_old(p) ) with S_old = SE3 pose.
                pc = T_old[:3, :3] @ mp.pos + T_old[:3, 3]
                sinv = 1.0 / S_n["s"]
                p_new = sinv * (S_n["R"].T @ (pc - S_n["t"]))
                self.arena.set_point_pos(mp, p_new)
                moved.add(int(mid))
                moved_recs.append(mp)
            # Pose: SE3 from corrected Sim3 with t/s (reference :283-288).
            gkf.Tcw = np.eye(4, dtype=np.float32)
            gkf.Tcw[:3, :3] = S_n["R"]
            gkf.Tcw[:3, 3] = S_n["t"] / S_n["s"]
            arena.update_connections(gkf)
        arena.update_normals_many(moved_recs, self.scale_factors)
        # 3. Fuse matched loop points into the current KF (:273-279).
        for feat_idx, loop_mid in cur_matches.items():
            cur_mid = int(kf.mp_ids[feat_idx])
            lp = arena.mps.get(loop_mid)
            if lp is None or lp.bad:
                continue
            if cur_mid >= 0 and cur_mid != loop_mid:
                cur_mp = arena.mps.get(cur_mid)
                if cur_mp is not None and not cur_mp.bad:
                    arena.replace_point(cur_mp, lp)
            else:
                arena.add_observation(lp, kf, feat_idx)
                arena.compute_distinctive_descriptor(lp)
        # 4. SearchAndFuse: project loop points into the corrected group
        #    (:302-317, ORBmatcher::Fuse with Scw radius 4).
        self._search_and_fuse(corrected, loop_points)
        # 5. New covisibility links created by the fusion -> loop
        #    connections: RECOUNT the group's connections after the fuse
        #    (upstream CorrectLoop :283-296 calls UpdateConnections per
        #    group keyframe after SearchAndFuse) and collect the NEW
        #    cross-loop links (minus prior neighbors and the group
        #    itself) — these enter the essential graph as loop
        #    constraints measured at the corrected poses; without the
        #    recount the single explicit kf<->matched_kf edge was the
        #    only constraint pulling the loop closed.
        prev_covis = {g: set(arena.kfs[g].covis)
                      for g in corrected if g in arena.kfs}
        loop_connections: Dict[int, set] = {}
        for g_id in corrected:
            gkf = arena.kfs.get(g_id)
            if gkf is None:
                continue
            arena.update_connections(gkf)
            new = (set(gkf.covis) - prev_covis.get(g_id, set())
                   - set(corrected))
            if new:
                loop_connections[g_id] = new
        #    Essential-graph optimization (:292-296).
        self._optimize_essential_graph(kf, matched_kf, corrected,
                                       non_corrected, loop_connections)
        # 6. Loop edge (upstream; fork omitted it — §0.1 row 7). Upstream
        # AddLoopEdge also sets mbNotErase PERMANENTLY
        # (src/KeyFrame.cc:398-409) so keyframe culling can never delete a
        # loop-constraint endpoint — a later loop's essential graph would
        # dangle (found by the 1250-frame endurance run).
        kf.loop_edges.add(matched_kf.id)
        matched_kf.loop_edges.add(kf.id)
        kf.not_erase = True
        matched_kf.not_erase = True
        self.last_loop_kf_id = kf.id
        # The correction + essential graph rewrote every keyframe pose:
        # free-running tracker poses (pipelined chain device state,
        # in-flight chain results) are now in a stale frame. The tracker
        # re-anchors via pose_epoch (arena doc) + UpdateLastFrame.
        arena.pose_epoch += 1
        # 7. Global BA (upstream RunGlobalBundleAdjustment :340-410):
        # dense Schur for small maps, implicit Schur-CG for large ones;
        # runs on a side thread in interruptible chunks (a newer loop
        # aborts it) unless sync_gba is set.
        self._start_global_ba()

    def _search_and_fuse(self, corrected: Dict[int, dict], loop_points):
        """SearchAndFuse (reference LoopClosing.cc:302-317): project the
        loop map points into every corrected keyframe and fuse — corrected
        loop points REPLACE current-map duplicates unconditionally (the
        Fuse(KF, Scw, ...) variant). ONE batched device call for the whole
        corrected group (the jobs share the same id-list object, so the
        projection pass is shared too); the per-keyframe variant cost one
        ~27 ms round trip per group member (~20 per loop) under the map
        lock."""
        ids = list(loop_points)
        jobs = [(g_id, ids) for g_id in corrected
                if g_id in self.arena.kfs]
        if jobs:
            self.local_mapper._fuse_jobs(jobs, radius_th=4.0,
                                         replace_existing=True)
    def _optimize_essential_graph(self, kf, matched_kf, corrected,
                                  non_corrected, loop_connections=None):
        """Build + solve the essential graph (reference Optimizer::
        OptimizeEssentialGraph src/Optimizer.cc:762-1025): spanning-tree
        edges, existing loop edges, covisibility edges >= 100, and the new
        loop constraint; fixed = the loop keyframe."""
        arena = self.arena
        kf_ids = sorted(arena.kfs)
        index = {k: i for i, k in enumerate(kf_ids)}
        K = len(kf_ids)
        # Vertex init: corrected group keyframes start at their FULL
        # corrected Sim3 (scale included, reference :820-860); the rest at
        # their SE3 pose with scale 1 — the solver distributes the measured
        # loop drift scale around the graph.
        R0 = np.zeros((K, 3, 3), np.float32)
        t0 = np.zeros((K, 3), np.float32)
        s0 = np.ones(K, np.float32)
        for k_id in kf_ids:
            i = index[k_id]
            if k_id in corrected:
                S = corrected[k_id]
                R0[i], t0[i], s0[i] = S["R"], S["t"], S["s"]
            else:
                T = arena.kfs[k_id].Tcw
                R0[i], t0[i] = T[:3, :3], T[:3, 3]
        init_sim3 = [(float(s0[i]), R0[i].copy(), t0[i].copy())
                     for i in range(K)]
        fixed = np.zeros(K, bool)
        fixed[index[matched_kf.id]] = True
        e_i, e_j, e_R, e_t, e_s = [], [], [], [], []
        added = set()

        def sim3_of(T):
            return 1.0, T[:3, :3], T[:3, 3]

        def add_edge(i_id, j_id, Si, Sj):
            """Measurement Sji = S_j o S_i^-1 in Sim3; Si/Sj are
            (s, R, t) triples (g2o sim3.h composition: the left factor's
            scale multiplies the right factor's translation)."""
            key = (min(i_id, j_id), max(i_id, j_id))
            if key in added or i_id not in index or j_id not in index:
                return
            added.add(key)
            si, Ri, ti = Si
            sj, Rj, tj = Sj
            sji = sj / si
            Rji = Rj @ Ri.T
            tji = tj - sji * (Rji @ ti)
            e_i.append(index[i_id]); e_j.append(index[j_id])
            e_R.append(Rji); e_t.append(tji); e_s.append(sji)

        # Edge insertion ORDER matters (upstream :862-884 inserts the
        # LoopConnections set FIRST, then skips duplicates among
        # tree/covis edges): after the post-fusion covisibility recount,
        # (cur, matched) is typically a >=100 covis pair — if its covis
        # edge (measured from the DRIFTED non-corrected poses) were
        # added first, the dedup would drop the real loop constraint and
        # the solve would revert the correction. Loop-connection
        # measurements use the corrected/current vertex Sim3s (upstream
        # computes Sji from vScw).
        def vertex_pose(x_id):
            S = corrected.get(x_id)
            if S is not None:
                return (S["s"], S["R"], S["t"])
            return sim3_of(arena.kfs[x_id].Tcw)

        # The new loop constraint: current KF at its CORRECTED Sim3 (the
        # measured drift scale 1/s rides this edge) <-> matched KF.
        add_edge(kf.id, matched_kf.id, vertex_pose(kf.id),
                 sim3_of(non_corrected.get(matched_kf.id,
                                           arena.kfs[matched_kf.id].Tcw)))
        for g_id, nbs in (loop_connections or {}).items():
            gkf = arena.kfs.get(g_id)
            if gkf is None:
                continue
            for nb in nbs:
                if nb not in arena.kfs:
                    continue
                # Weight filter as upstream (minFeat=100) except the main
                # loop pair, which always enters.
                if (gkf.covis.get(nb, 0) < 100
                        and not (g_id == kf.id and nb == matched_kf.id)):
                    continue
                add_edge(g_id, nb, vertex_pose(g_id), vertex_pose(nb))
        for k_id in kf_ids:
            k_kf = arena.kfs[k_id]
            # Use pre-correction poses for edges inside the corrected group
            # (reference uses NonCorrectedSim3 for measurement computation).
            def pose_of(x_id):
                return sim3_of(non_corrected.get(x_id, arena.kfs[x_id].Tcw))
            if k_kf.parent >= 0 and k_kf.parent in arena.kfs:
                add_edge(k_id, k_kf.parent, pose_of(k_id), pose_of(k_kf.parent))
            for le in k_kf.loop_edges:
                # Defensive: maps loaded from pre-fix checkpoints may hold
                # loop edges to culled keyframes.
                if le in arena.kfs:
                    add_edge(k_id, le, pose_of(k_id), pose_of(le))
            for nb, w in k_kf.covis.items():
                if w >= 100 and nb < k_id and nb in arena.kfs:
                    add_edge(k_id, nb, pose_of(k_id), pose_of(nb))
        if not e_i:
            return
        E = len(e_i)
        Rn, tn, sn = optimize_essential_graph(
            jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(s0),
            jnp.asarray(fixed), jnp.asarray(np.ones(K, bool)),
            jnp.asarray(np.asarray(e_i, np.int32)),
            jnp.asarray(np.asarray(e_j, np.int32)),
            jnp.asarray(np.stack(e_R).astype(np.float32)),
            jnp.asarray(np.stack(e_t).astype(np.float32)),
            jnp.asarray(np.asarray(e_s, np.float32)),
            jnp.asarray(np.ones(E, bool)),
            n_iters=20, cg_iters=50)
        Rn = np.asarray(Rn)
        tn = np.asarray(tn)
        sn = np.asarray(sn)
        # Apply: poses = [R | t/s]; points corrected via their reference
        # KF's vertex: p_new = S_post^-1( S_init(p) ) where S_init is the
        # vertex's initial Sim3 (the corrected Sim3 for group KFs, since
        # their points were already moved in CorrectLoop step 2; reference
        # :960-1010 uses vSim3[nIDr] the same way).
        for k_id in kf_ids:
            i = index[k_id]
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = Rn[i]
            T[:3, 3] = tn[i] / max(sn[i], 1e-9)
            arena.kfs[k_id].Tcw = T
        eg_moved = []
        for mp in list(arena.mps.values()):
            ref_id = mp.ref_kf if mp.ref_kf in index else next(
                (k for k in mp.obs if k in index), None)
            if ref_id is None:
                continue
            i = index[ref_id]
            s_o, R_o, t_o = init_sim3[i]
            pc = s_o * (R_o @ mp.pos) + t_o
            # p_new = S_new^-1 (pc) with S_new = (sR, t).
            p_new = (Rn[i].T @ (pc - tn[i])) / max(sn[i], 1e-9)
            arena.set_point_pos(mp, p_new)
            eg_moved.append(mp)
        arena.update_normals_many(eg_moved, self.scale_factors)

    def _build_gba_problem(self):
        """Snapshot the whole arena into a BAProblem (upstream
        GlobalBundleAdjustemnt graph, src/Optimizer.cc:22-27). Runs on the
        MAIN thread so the snapshot is consistent with the single-writer
        arena; only the numeric solve leaves this thread."""
        from orb_slam_system_tpu.solvers.local_ba import BAProblem

        arena = self.arena
        kf_ids = sorted(arena.kfs)
        C = len(kf_ids)
        index = {k: i for i, k in enumerate(kf_ids)}
        mp_ids = list(arena.mps)
        P = len(mp_ids)
        if P == 0 or C < 2:
            return None
        p_index = {m: i for i, m in enumerate(mp_ids)}
        e_cam, e_pt, e_uv, e_ur, e_is2 = [], [], [], [], []
        for m in mp_ids:
            mp = arena.mps[m]
            for kf_id, fidx in mp.obs.items():
                if kf_id not in index:
                    continue
                w_kf = arena.kfs[kf_id]
                e_cam.append(index[kf_id])
                e_pt.append(p_index[m])
                e_uv.append(w_kf.feats.xy_und[fidx])
                e_ur.append(w_kf.feats.u_right[fidx]
                            if w_kf.feats.u_right is not None else -1.0)
                e_is2.append(self.inv_sigma2[w_kf.feats.octave[fidx]])
        if len(e_cam) < 20:
            return None
        prob = BAProblem(
            Tcw=jnp.asarray(np.stack([arena.kfs[k].Tcw for k in kf_ids])),
            cam_fixed=jnp.asarray(
                np.asarray([k == arena.kf_origin_id for k in kf_ids])),
            cam_valid=jnp.asarray(np.ones(C, bool)),
            points=jnp.asarray(np.stack([arena.mps[m].pos for m in mp_ids])),
            pt_valid=jnp.asarray(np.ones(P, bool)),
            e_cam=jnp.asarray(np.asarray(e_cam, np.int32)),
            e_pt=jnp.asarray(np.asarray(e_pt, np.int32)),
            e_uv=jnp.asarray(np.asarray(e_uv, np.float32)),
            e_inv_sigma2=jnp.asarray(np.asarray(e_is2, np.float32)),
            e_valid=jnp.asarray(np.ones(len(e_cam), bool)),
            e_ur=jnp.asarray(np.asarray(e_ur, np.float32)),
            bf=self.cfg.camera.bf)
        old_poses = {k: arena.kfs[k].Tcw.copy() for k in kf_ids}
        return prob, kf_ids, mp_ids, old_poses

    def _start_global_ba(self):
        """Launch (or re-launch) global BA. A loop arriving while a GBA is
        in flight aborts it first (upstream mbStopGBA, reference
        LoopClosing.cc:255-263); with sync_gba the solve runs inline —
        deterministic, used by tests."""
        snap = self._build_gba_problem()
        if snap is None:
            return
        if self.gba.running():
            self.gba.abort()
        self.gba.start(snap, self.cfg.camera,
                       dense_max_cams=GBA_DENSE_MAX_CAMS,
                       sync=self.sync_gba)
        if self.sync_gba:
            self.poll_gba()

    def poll_gba(self):
        """Apply a finished global BA on the MAIN thread (single-writer
        arena): keyframes in the snapshot get their optimized pose;
        keyframes created DURING the solve are corrected by propagating
        through the spanning tree (upstream RunGlobalBundleAdjustment
        :370-400: Tcw_child_new = Tcp_old * Tcw_parent_new); points not in
        the snapshot re-anchor via their reference keyframe."""
        result = self.gba.take_result()
        if result is None:
            return False
        # Correction-exclusion, same ordering discipline as correct_loop:
        # outer correction_lock before arena.lock (release arena first if
        # the caller holds it). Re-entrant from a tracker thread that
        # already holds its frame's correction_lock (_pump_mapping).
        with self.arena.unlocked():
            self.arena.correction_lock.acquire()
        try:
            with self.arena.lock:
                return self._apply_gba(result)
        finally:
            self.arena.correction_lock.release()

    def _apply_gba(self, result):
        kf_ids, mp_ids, old_poses, Tcw_n, X_n = result
        arena = self.arena
        index = {k: i for i, k in enumerate(kf_ids)}
        new_pose: Dict[int, np.ndarray] = {}
        for k in kf_ids:
            if k in arena.kfs and k != arena.kf_origin_id:
                new_pose[k] = Tcw_n[index[k]].copy()
        if arena.kf_origin_id in arena.kfs:
            new_pose[arena.kf_origin_id] = \
                arena.kfs[arena.kf_origin_id].Tcw.copy()
        # Spanning-tree propagation to keyframes born during the solve
        # (passes bounded by tree depth; each pass resolves children whose
        # parent already has a corrected pose). The relative pose Tcp is
        # taken against the parent's pose AT APPLY TIME (upstream's
        # mTcwBefGBA, RunGlobalBundleAdjustment :370-400) — NOT its
        # snapshot-era pose: local BA may have moved the parent during
        # the async solve, and the child is consistent with the parent's
        # current pose, so a snapshot base would bake the local-BA delta
        # into the corrected child as error.
        pre_apply = {k: kf.Tcw.copy() for k, kf in arena.kfs.items()}
        changed = True
        while changed:
            changed = False
            for k, kf in arena.kfs.items():
                if k in new_pose or kf.parent < 0:
                    continue
                parent = kf.parent
                if parent in new_pose:
                    base = pre_apply.get(parent)
                    if base is None:
                        continue
                    Tcp = pre_apply[k] @ np.linalg.inv(base)
                    new_pose[k] = (Tcp @ new_pose[parent]).astype(np.float32)
                    changed = True
        for k, T in new_pose.items():
            if k in arena.kfs:
                arena.kfs[k].Tcw = T
        p_index = {m: i for i, m in enumerate(mp_ids)}
        moved = []
        for m, mp in list(arena.mps.items()):
            if m in p_index:
                arena.set_point_pos(mp, X_n[p_index[m]])
            else:
                # Born during GBA: re-anchor via the reference keyframe's
                # apply-time->new pose pair (upstream :402-408 uses
                # mTcwBefGBA — the pose right before the GBA result is
                # written, since the point is consistent with the ref
                # keyframe's CURRENT pose, not its snapshot pose).
                ref = mp.ref_kf
                T_old = pre_apply.get(ref)
                if ref not in new_pose or T_old is None:
                    continue
                pc = T_old[:3, :3] @ mp.pos + T_old[:3, 3]
                T_new = new_pose[ref]
                arena.set_point_pos(
                    mp, T_new[:3, :3].T @ (pc - T_new[:3, 3]))
            moved.append(mp)
        arena.update_normals_many(moved, self.scale_factors)
        # Map-wide pose rewrite: invalidate free-running tracker poses
        # (see correct_loop / arena.pose_epoch).
        arena.pose_epoch += 1
        return True


class GBARunner:
    """Interruptible global-BA worker (upstream GBA thread machinery,
    reference LoopClosing.cc:340-410 + mbStopGBA). The solve runs in
    CHUNKS of a few LM iterations so an abort lands within one chunk; the
    result is handed back to the main thread via take_result()."""

    CHUNK_ITERS = 2
    N_CHUNKS = 5

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self._thread = None
        self._abort = False
        self._result = None
        self.last_shape = None  # (cameras, points, edges) of the last solve

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def abort(self):
        self._abort = True
        t = self._thread
        if t is not None:
            t.join()
        self._thread = None
        # A solve that passed its last abort check before the flag was set
        # has stored its result; it is superseded all the same.
        with self._lock:
            self._result = None

    def join(self):
        t = self._thread
        if t is not None:
            t.join()

    def start(self, snapshot, cam, dense_max_cams=48, sync=False):
        self.join()
        self._abort = False
        with self._lock:
            self._result = None
        if sync:
            self._solve(snapshot, cam, dense_max_cams)
            return
        import threading
        self._thread = threading.Thread(
            target=self._solve, args=(snapshot, cam, dense_max_cams),
            daemon=True, name="gba")
        self._thread.start()

    def take_result(self):
        with self._lock:
            r = self._result
            self._result = None
        return r

    def _solve(self, snapshot, cam, dense_max_cams):
        from orb_slam_system_tpu.solvers.local_ba import (
            bundle_adjust, bundle_adjust_cg)

        prob, kf_ids, mp_ids, old_poses = snapshot
        C = len(kf_ids)
        dense = C <= dense_max_cams
        self.last_shape = (C, prob.points.shape[0], prob.e_cam.shape[0])
        Tcw, X = prob.Tcw, prob.points
        for _ in range(self.N_CHUNKS):
            if self._abort:
                return  # superseded by a newer loop; discard
            p = prob._replace(Tcw=Tcw, points=X)
            if dense:
                Tcw, X = bundle_adjust(
                    p, cam.fx, cam.fy, cam.cx, cam.cy,
                    n_iters=self.CHUNK_ITERS, use_huber=True)
            else:
                Tcw, X = bundle_adjust_cg(
                    p, cam.fx, cam.fy, cam.cx, cam.cy,
                    n_iters=self.CHUNK_ITERS, cg_iters=50)
        Tcw_n = np.asarray(Tcw)
        X_n = np.asarray(X)
        if self._abort:
            return
        with self._lock:
            self._result = (kf_ids, mp_ids, old_poses, Tcw_n, X_n)
