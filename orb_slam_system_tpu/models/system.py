"""System facade.

Replaces reference System (src/System.cc, include/System.h:41-102): the
public API a user constructs and feeds frames to. Signature parity:
System(vocabulary_path, settings_path_or_config, sensor, use_viewer),
TrackMonocular/TrackStereo/TrackRGBD, ActivateLocalizationMode /
DeactivateLocalizationMode, Reset, Shutdown, SaveTrajectoryTUM,
SaveKeyFrameTrajectoryTUM, SaveTrajectoryKITTI, GetTrackingState,
GetTrackedMapPoints, GetTrackedKeyPointsUn.

The reference spawns LocalMapping/LoopClosing/Viewer threads
(src/System.cc:63-82); here mapping runs as a synchronous stage after each
tracked frame (JAX async dispatch pipelines device work), keeping results
deterministic — the reference's queue handoffs become direct stage calls.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np

from orb_slam_system_tpu.config import Sensor, SlamConfig, TrackingState, load_settings
from orb_slam_system_tpu.dataio import trajectory as traj_io
from orb_slam_system_tpu.mapping.arena import MapArena
from orb_slam_system_tpu.models.local_mapping import LocalMapper
from orb_slam_system_tpu.models.tracking import Tracker


class System:
    def __init__(self, vocabulary_path: Optional[str],
                 settings: Union[str, SlamConfig],
                 sensor: Sensor = Sensor.MONOCULAR,
                 use_viewer: bool = False,
                 metrics_jsonl: Optional[str] = None,
                 async_mapping: bool = False,
                 viewer_port: Optional[int] = None,
                 prewarm: bool = False):
        if isinstance(settings, str):
            self.cfg = load_settings(settings, sensor)
        else:
            self.cfg = settings
        # Opt-in compile-cache pre-warm: runs a short synthetic pass
        # through both mapping modes BEFORE this System's first real
        # frame, filling the in-process jit caches and the persistent XLA
        # cache so serving never hits the multi-second per-bucket
        # cold-compile cliff. Re-entrancy guarded inside.
        if prewarm:
            from orb_slam_system_tpu.utils.warmup import warm
            warm(verbose=False, n_features=self.cfg.orb.n_features)
        self.sensor = Sensor(sensor)
        self.vocabulary = None
        if vocabulary_path:
            from orb_slam_system_tpu.vocab.vocabulary import Vocabulary
            self.vocabulary = Vocabulary.load(vocabulary_path)
        self.arena = MapArena()
        from orb_slam_system_tpu.models.loop_closing import LoopCloser
        from orb_slam_system_tpu.models.place_recognition import PlaceRecognition
        self.place_rec = PlaceRecognition(self.vocabulary)
        self.arena.erase_hooks.append(self.place_rec.on_erase_keyframe)
        self.local_mapper = LocalMapper(self.cfg, self.arena,
                                        place_rec=self.place_rec)
        # async_mapping=True runs LocalMapper on its own thread (the
        # reference's LocalMapping thread, src/System.cc:65-70): tracking
        # and mapping overlap their device round trips via arena.lock /
        # arena.unlocked. Default False = synchronous staged pipeline
        # (deterministic; same results every run).
        self.async_mapping = async_mapping
        self.loop_closer = LoopCloser(self.cfg, self.arena, self.place_rec,
                                      self.local_mapper)
        self.local_mapper.loop_closer = self.loop_closer
        self.tracker = Tracker(self.cfg, self.arena, self.local_mapper,
                               place_rec=self.place_rec)
        self.use_viewer = use_viewer
        self.viewer = None
        if use_viewer and viewer_port is not None:
            # Live interactive view (the reference's Viewer window +
            # menu, src/Viewer.cc:34-120) served on localhost HTTP;
            # port 0 picks an ephemeral port (viewer.port has it).
            from orb_slam_system_tpu.models.viewer import LiveViewer
            self.viewer = LiveViewer(self, port=viewer_port)
        elif use_viewer:
            from orb_slam_system_tpu.models.viewer import StatsViewer
            self.viewer = StatsViewer(self)
        self._timings: list[float] = []
        from orb_slam_system_tpu.utils.metrics import Telemetry
        self.telemetry = Telemetry(jsonl_path=metrics_jsonl)
        # State mutex mirroring the reference's mMutexMode/mMutexState
        # (src/System.cc): the Track* entry points and state getters are
        # safe to call from different threads (e.g. a ROS callback thread
        # plus a UI thread).
        import threading
        self._lock = threading.RLock()  # reentrant: viewer reads state
        if self.async_mapping:
            self.local_mapper.start_async()
                                        # from inside the track section

    # ------------------------------------------------------------------

    def _emit_frame_metrics(self, timestamp: float, t_track: float,
                            t_map: float):
        cur = self.tracker.current
        # Avoid forcing a device fetch just for telemetry: use the host
        # copy when it exists, else the count the fused motion step
        # reported (0 before tracking starts).
        if cur is not None and cur.feats_host is not None:
            n_kp = int(cur.feats_host.valid.sum())
        else:
            n_kp = getattr(self.tracker, "last_n_valid", 0)
        self.telemetry.emit(
            t=timestamp,
            state=int(self.tracker.state),
            n_keypoints=n_kp,
            n_inliers=self.tracker.n_inliers,
            n_tracked=len(self.get_tracked_map_points()),
            n_kfs=self.arena.n_keyframes(),
            n_mps=self.arena.n_points(),
            track_ms=t_track * 1000.0,
            mapping_ms=t_map * 1000.0,
        )

    def track_monocular(self, img: np.ndarray, timestamp: float):
        """Reference TrackMonocular (src/System.cc:197-247). img: grayscale
        or RGB (converted); returns Tcw (4x4) or None."""
        if self.sensor != Sensor.MONOCULAR:
            raise RuntimeError("track_monocular called on non-monocular system")
        if img.ndim == 3:
            img = rgb_to_gray(img, self.cfg.camera.rgb)
        with self._lock:
            t0 = time.perf_counter()
            Tcw = self.tracker.grab_monocular(img, timestamp)
            t1 = time.perf_counter()
            self._pump_mapping()
            t2 = time.perf_counter()
            self._timings.append(t2 - t0)
            self._emit_frame_metrics(timestamp, t1 - t0, t2 - t1)
            if self.viewer is not None:
                self.viewer.update(img)
            return Tcw

    def track_stereo(self, img_left: np.ndarray, img_right: np.ndarray,
                     timestamp: float):
        """Reference TrackStereo (src/System.cc:95-144). Rectified pair in,
        Tcw out."""
        if self.sensor != Sensor.STEREO:
            raise RuntimeError("track_stereo called on non-stereo system")
        if img_left.ndim == 3:
            img_left = rgb_to_gray(img_left, self.cfg.camera.rgb)
            img_right = rgb_to_gray(img_right, self.cfg.camera.rgb)
        with self._lock:
            t0 = time.perf_counter()
            Tcw = self.tracker.grab_stereo(img_left, img_right, timestamp)
            t1 = time.perf_counter()
            self._pump_mapping()
            t2 = time.perf_counter()
            self._timings.append(t2 - t0)
            self._emit_frame_metrics(timestamp, t1 - t0, t2 - t1)
            if self.viewer is not None:
                self.viewer.update(img_left)
            return Tcw

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float):
        """Reference TrackRGBD (src/System.cc:146-195)."""
        if self.sensor != Sensor.RGBD:
            raise RuntimeError("track_rgbd called on non-RGBD system")
        if img.ndim == 3:
            img = rgb_to_gray(img, self.cfg.camera.rgb)
        with self._lock:
            t0 = time.perf_counter()
            Tcw = self.tracker.grab_rgbd(img, depth, timestamp)
            t1 = time.perf_counter()
            self._pump_mapping()
            t2 = time.perf_counter()
            self._timings.append(t2 - t0)
            self._emit_frame_metrics(timestamp, t1 - t0, t2 - t1)
            if self.viewer is not None:
                self.viewer.update(img)
            return Tcw

    def track_monocular_prebuilt(self, frame):
        """Track a frame prebuilt by a (possibly shared, batched)
        FrameBuilder — the multi-sequence mode builds S systems' frames
        with ONE batched extraction program and feeds each system its
        slice here."""
        with self._lock:
            t0 = time.perf_counter()
            Tcw = self.tracker.grab_prebuilt(frame)
            t1 = time.perf_counter()
            self._pump_mapping()
            t2 = time.perf_counter()
            self._timings.append(t2 - t0)
            self._emit_frame_metrics(frame.timestamp, t1 - t0, t2 - t1)
            return Tcw

    def track_monocular_stream(self, frames):
        """Pipelined monocular tracking over an iterable of (img, t):
        frame i+1's extraction is ENQUEUED before frame i's tracking fetch,
        so the device round trip and the next frame's extract overlap. Identical per-frame semantics
        to calling track_monocular sequentially (frames are independent
        until the tracking step). Yields Tcw (or None) per frame.

        This is the device-side replacement for the reference's real-time
        pacing loop (Examples/Monocular/mono_tum.cc:97-105): a streaming
        driver that keeps one frame in flight."""
        from orb_slam_system_tpu.config import TrackingState
        it = iter(frames)
        pending = None        # (built_frame, raw_img, timestamp)
        while True:
            if pending is None:
                nxt = next(it, None)
                if nxt is None:
                    return
                img, ts = nxt
                if img.ndim == 3:
                    img = rgb_to_gray(img, self.cfg.camera.rgb)
                with self._lock:
                    frame = self.tracker.build_frame(img, ts)
            else:
                frame, img, ts = pending
                pending = None
                # The pending frame was prebuilt by the steady-state
                # builder; if the previous step's tracking left OK (e.g.
                # the internal ≤5-KF reset), the sequential path would use
                # a different builder (init extracts 2x features) — drop
                # the prebuilt buffer and rebuild to stay bit-identical
                # to sequential semantics.
                if self.tracker.state != TrackingState.OK:
                    with self._lock:
                        frame = self.tracker.build_frame(img, ts)
            with self._lock:
                t0 = time.perf_counter()
                # Pre-enqueue the NEXT frame's extraction before this
                # frame's tracking fetch — only in steady state (the
                # builder choice depends on the tracking state).
                if self.tracker.state == TrackingState.OK:
                    nxt = next(it, None)
                    if nxt is not None:
                        img2, ts2 = nxt
                        if img2.ndim == 3:
                            img2 = rgb_to_gray(img2, self.cfg.camera.rgb)
                        pending = (self.tracker.build_frame(img2, ts2),
                                   img2, ts2)
                Tcw = self.tracker.grab_prebuilt(frame)
                t1 = time.perf_counter()
                self._pump_mapping()
                t2 = time.perf_counter()
                self._timings.append(t2 - t0)
                self._emit_frame_metrics(ts, t1 - t0, t2 - t1)
                if self.viewer is not None:
                    self.viewer.update(img)
                yield Tcw

    def track_monocular_pipelined(self, frames, resync_every: int = 0,
                                  depth: int = 2):
        """Deep-pipelined monocular tracking (the realtime mode): frame
        k+1's extraction AND tracking programs are enqueued before frame
        k's results arrive; results are fetched by a pool of background
        threads and consumed `depth` frames late via the device-state
        chain step (tracking.chain_*). The host-device round trip overlaps
        the next frames' device work, so steady-state throughput is
        bounded by device time + host bookkeeping, not by the round trip.

        depth = frames in flight. Each blocking fetch costs one round
        trip no matter when it is issued, and concurrent fetches
        overlap, so the fetch of frame k is given `depth` frame-times to
        land: depth 1 caps the loop at one frame per round trip, depth 2
        at two, until device time or host bookkeeping binds. Whether the
        chain still beats the classic stream path on the GPU is an open
        measurement. Bookkeeping (keyframe decisions, local-map
        block refresh) lags `depth` frames; the chain margin gates below
        re-anchor classically whenever that staleness costs inliers.

        Semantics and safeguards:
          * Keyframes are created directly from chain results (measured
            ATE-equivalent to classic re-tracking across scene classes
            once the device pose state is projected onto SE(3) each
            step); set tracker.chain_classic_kf = True to re-track
            keyframe frames through the exact classic path instead
            (2 extra round trips per keyframe decision).
          * The chain engages only on a mature map (CHAIN_MIN_KEYFRAMES
            created since the map epoch), outside the post-keyframe
            settling window (CHAIN_SETTLE_FRAMES, default 0 — measured
            no-op since the SE(3) projection fix), and only while the
            inlier margin is healthy relative to the scene's recent
            classic level (CHAIN_MARGIN_RATIO of the OK-frame EMA, floor
            CHAIN_MIN_FLOOR, + a relative-drop detector); anything else
            re-anchors classically, and weak results additionally resync
            the device state.
          * Within those guards, per-frame match selection can still
            differ from the sequential path within matching tolerance
            (device-f32 vs host-f64 projection rounding flips borderline
            window candidates), so trajectories are quality-equivalent,
            not bit-equal; the classic stream mode remains the
            sequential-identical option.

        Yields Tcw (or None) per frame, in order.
        """
        if self.sensor != Sensor.MONOCULAR:
            raise RuntimeError(
                "track_monocular_pipelined called on non-monocular system")

        def build_steady(item):
            img, ts = item
            if img.ndim == 3:
                img = rgb_to_gray(img, self.cfg.camera.rgb)
            return self.tracker.builder.build(img, ts)

        def build_classic(item):
            img, ts = item
            if img.ndim == 3:
                img = rgb_to_gray(img, self.cfg.camera.rgb)
            return self.tracker.build_frame(img, ts)

        return self._track_pipelined(frames, build_steady, build_classic,
                                     resync_every, depth)

    def track_stereo_pipelined(self, frames, resync_every: int = 0,
                               depth: int = 2):
        """Deep-pipelined stereo tracking over an iterable of
        (img_left, img_right, timestamp) — same architecture and
        safeguards as track_monocular_pipelined (the chain step consumes
        the 18-wide stereo packed buffer: stereo observations enter the
        in-program pose LM via u_right, and the stereo keyframe decision's
        close-point counts are computed on device). The reference paces
        stereo KITTI at 10 fps (Examples/Stereo/stereo_kitti.cc)."""
        if self.sensor != Sensor.STEREO:
            raise RuntimeError(
                "track_stereo_pipelined called on non-stereo system")

        def build(item):
            left, right, ts = item
            if left.ndim == 3:
                left = rgb_to_gray(left, self.cfg.camera.rgb)
                right = rgb_to_gray(right, self.cfg.camera.rgb)
            return self.tracker.builder.build_stereo(left, right, ts)

        return self._track_pipelined(frames, build, build,
                                     resync_every, depth)

    def track_rgbd_pipelined(self, frames, resync_every: int = 0,
                             depth: int = 2):
        """Deep-pipelined RGB-D tracking over an iterable of
        (img, depth_map, timestamp); see track_stereo_pipelined."""
        if self.sensor != Sensor.RGBD:
            raise RuntimeError(
                "track_rgbd_pipelined called on non-RGBD system")

        def build(item):
            img, depth_map, ts = item
            if img.ndim == 3:
                img = rgb_to_gray(img, self.cfg.camera.rgb)
            return self.tracker.builder.build_rgbd(img, depth_map, ts)

        return self._track_pipelined(frames, build, build,
                                     resync_every, depth)

    def _track_pipelined(self, items, build_steady, build_classic,
                         resync_every: int, depth: int):
        from collections import deque

        from orb_slam_system_tpu.config import TrackingState
        tr = self.tracker
        depth = max(1, int(depth))
        pendq: deque = deque()   # (frame, ids, item) in flight, oldest first
        state = None     # (T_prev_dev, T_last_dev, assoc_dev)
        state_epoch = -1  # arena.pose_epoch the device state was built in
        prev_ids = None
        prev_packed = None

        # Background fetch pool: each worker blocks on one chain step's
        # packed output (np.asarray = one round trip) and posts the numpy
        # buffer. Concurrent fetches overlap, so `depth` workers keep
        # `depth` round trips in flight.
        import queue as _queue
        import threading as _threading
        fetch_q: "_queue.Queue" = _queue.Queue()
        fetched: dict = {}
        fetched_cv = _threading.Condition()

        def _fetch_loop():
            while True:
                item = fetch_q.get()
                if item is None:
                    return
                tok, arr = item
                try:
                    buf = np.asarray(arr)
                except Exception as e:  # noqa: BLE001 — surfaced at get
                    buf = e
                with fetched_cv:
                    fetched[tok] = buf
                    # Results discarded by the break path can race this
                    # store; at most `depth` tokens are ever legitimately
                    # outstanding, so cap the dict to bound the leak.
                    while len(fetched) > 8 + depth:
                        fetched.pop(min(fetched))
                    fetched_cv.notify_all()

        n_fetchers = max(2, depth)
        fetchers = [_threading.Thread(target=_fetch_loop, daemon=True,
                                      name=f"chain-fetch-{i}")
                    for i in range(n_fetchers)]
        for f in fetchers:
            f.start()

        def _fetch_get(tok, timeout=300.0):
            deadline = time.monotonic() + timeout
            with fetched_cv:
                while tok not in fetched:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise TimeoutError(
                            f"chain fetch {tok} not delivered")
                    fetched_cv.wait(left)
                buf = fetched.pop(tok)
            if isinstance(buf, Exception):
                raise buf
            return buf

        def classic(frame):
            with self._lock:
                t0 = time.perf_counter()
                Tcw = tr.grab_prebuilt(frame)
                t1 = time.perf_counter()
                self._pump_mapping()
                self._timings.append(time.perf_counter() - t0)
                self._emit_frame_metrics(frame.timestamp, t1 - t0,
                                         time.perf_counter() - t1)
            return Tcw

        def vupdate(item):
            # Live-viewer cadence for the realtime modes (Viewer::Run runs
            # once per frame in the reference): cheap unless a browser is
            # actively polling (LiveViewer poll-gates the frame encode).
            if self.viewer is not None:
                try:
                    self.viewer.update(item[0])
                except Exception:  # noqa: BLE001 — viewer never kills SLAM
                    pass

        def process_oldest():
            """Returns (Tcw, broke) for the oldest in-flight frame,
            running the classic fallback when the chain result was weak.
            broke=True means frames already enqueued on the stale state
            must be discarded and re-tracked classically."""
            nonlocal state
            frame, ids, _item = pendq.popleft()
            broke = False
            with tr.stage_ms.stage("chain_fetch_wait"):
                host_buf = _fetch_get(frame.id)
            # correction_lock held for this frame's whole commit span
            # (upstream's whole-frame mMutexMapUpdate semantics): without
            # it, chain_process's unlocked decode window lets a
            # correction land MID-FRAME — the stale pose is committed
            # and the Tcr_ref stored against the corrected reference is
            # poisoned, which the UpdateLastFrame re-anchor then
            # faithfully reproduces. Lock order: self._lock >
            # correction_lock > arena.lock.
            with self._lock, tr.arena.correction_lock:
                t0 = time.perf_counter()
                with tr.arena.lock:
                    # A loop correction / GBA apply rewrote the map's
                    # poses since this step was enqueued: its result is
                    # in the pre-correction frame — discard it and
                    # re-track classically (the classic path re-anchors
                    # via UpdateLastFrame semantics).
                    stale = tr.arena.pose_epoch != state_epoch
                    ok = (None if stale
                          else tr.chain_process(frame, ids, host_buf))
                    # Belt-and-braces: chain_finish's keyframe path can
                    # release the correction lock (backpressure wait /
                    # fragile flush) — re-validate before committing a
                    # chain result if the epoch moved mid-process.
                    if ok is True and tr.arena.pose_epoch != state_epoch:
                        ok = None
                if ok is None or ok == "kf":
                    # Classic re-track of this frame (its packed buffer is
                    # retained). ok is None = weak result: also drop the
                    # device state (resynced at the next enqueue) and
                    # discard the in-flight next frame. ok == "kf" = the
                    # frame will create a keyframe, which must carry
                    # classic-grade (freshest-state) content into the
                    # map; the pipeline itself stays valid.
                    # NOT under arena.lock: the classic path manages the
                    # lock itself (an internal reset must be able to
                    # release it fully around the worker flush).
                    if ok is None:
                        state = None
                        broke = True
                    Tcw = tr.grab_prebuilt(frame)
                else:
                    with tr.arena.lock:
                        tr.chain_finish(frame, True)
                    Tcw = None if frame.Tcw is None else frame.Tcw.copy()
                t1 = time.perf_counter()
                self._pump_mapping()
                self._timings.append(time.perf_counter() - t0)
                self._emit_frame_metrics(frame.timestamp, t1 - t0,
                                         time.perf_counter() - t1)
                if tr.state != TrackingState.OK:
                    state = None
                    broke = True
            vupdate(_item)
            return Tcw, broke

        def drain_classic():
            """Discard every in-flight frame's chain result and re-track
            it classically, in order (their chain steps ran on a state
            that has been invalidated). Returns the list of poses.

            If the tracking state left OK meanwhile (internal reset /
            LOST), the pending frames were built by the steady builder
            but the sequential path would pick a different one (mono
            re-initialization extracts 2x features) — rebuild each from
            its retained source item, exactly like the streaming mode
            does for its prebuilt frame (see track_monocular_stream)."""
            outs = []
            while pendq:
                frame, _ids, item = pendq.popleft()
                with fetched_cv:
                    fetched.pop(frame.id, None)
                with self._lock:
                    if tr.state != TrackingState.OK:
                        frame = build_classic(item)
                outs.append(classic(frame))
                vupdate(item)
            return outs

        def drain_all():
            """Process every in-flight frame in order (chain results are
            valid until one breaks; the rest then re-track classically).
            Returns the list of poses."""
            outs = []
            while pendq:
                Tcw, broke = process_oldest()
                outs.append(Tcw)
                if broke:
                    outs.extend(drain_classic())
            return outs

        try:
            for item in items:
                with self._lock:
                    chain_ok = tr.chain_ready()
                if pendq and (state is None or not chain_ok):
                    # The device state was dropped (resync knob) or a gate
                    # disengaged the chain (e.g. the post-keyframe settling
                    # window) while frames are still in flight: drain them
                    # so the bookkeeping stays ordered and the bootstrap
                    # below refers to the frame whose packed buffer becomes
                    # packed_last. Re-evaluate the gate afterwards —
                    # draining can create a keyframe or change the tracking
                    # state.
                    for Tcw in drain_all():
                        yield Tcw
                    with self._lock:
                        chain_ok = chain_ok and tr.chain_ready()
                with self._lock:
                    frame = (build_steady(item) if chain_ok
                             else build_classic(item))
                if not chain_ok:
                    state = None
                    Tcw = classic(frame)
                    vupdate(item)
                    yield Tcw
                    continue
                # correction_lock: a bootstrap/enqueue must not read a
                # HALF-corrected map (a correction's internal fuse
                # stages release arena.lock around device fetches).
                with self._lock, tr.arena.correction_lock, tr.arena.lock:
                    if state is None:
                        (T_prev, T_last, assoc, prev_ids,
                         _blk) = tr.chain_bootstrap()
                        state = (T_prev, T_last, assoc)
                        state_epoch = tr.arena.pose_epoch
                        prev_packed = tr.last_frame.packed_dev
                    ids, state, packed_out = tr.chain_enqueue(
                        frame, state, prev_packed, prev_ids)
                    if resync_every and (frame.id % resync_every == 0):
                        # Periodic state resync: drop the device state
                        # after this frame; the next iteration drains the
                        # pipeline and re-bootstraps from the host
                        # bookkeeping.
                        state = None
                fetch_q.put((frame.id, packed_out))
                pendq.append((frame, ids, item))
                prev_ids = ids
                prev_packed = frame.packed_dev
                if len(pendq) > depth:
                    Tcw, broke = process_oldest()
                    yield Tcw
                    if broke:
                        # The newer in-flight frames' chain steps ran on
                        # the now-invalid state: discard them and re-enter
                        # through the classic path.
                        for Tcw in drain_classic():
                            yield Tcw
            for Tcw in drain_all():
                yield Tcw
        finally:
            for _ in fetchers:
                fetch_q.put(None)
            for f in fetchers:
                f.join(timeout=10.0)

    def _pump_mapping(self):
        """Synchronous mode: drain the keyframe queue inline. Async mode:
        the worker thread drains it; here we only apply any finished
        global-BA result (cheap)."""
        if not self.async_mapping:
            self.local_mapper.process_pending()
        self.loop_closer.poll_gba()

    # Aliases matching the reference's exact method names.
    TrackMonocular = track_monocular
    TrackStereo = track_stereo
    TrackRGBD = track_rgbd

    # ------------------------------------------------------------------

    def activate_localization_mode(self):
        """Reference ActivateLocalizationMode (src/System.cc:249-259):
        tracking continues, mapping paused."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False
        self.tracker.mb_vo = False

    def reset(self):
        self.tracker.reset()

    def shutdown(self):
        """Reference Shutdown (src/System.cc:280-299): drain mapping and
        wait for an in-flight global BA, applying its result."""
        if self.async_mapping:
            self.local_mapper.flush()
            self.local_mapper.stop_async()
        self.local_mapper.process_pending()
        self.loop_closer.gba.join()
        self.loop_closer.poll_gba()
        if self.viewer is not None and hasattr(self.viewer, "shutdown"):
            self.viewer.shutdown()

    Shutdown = shutdown
    Reset = reset

    # ------------------------------------------------------------------

    def get_tracking_state(self) -> TrackingState:
        with self._lock:
            return self.tracker.state

    def get_tracked_map_points(self):
        cur = self.tracker.current
        if cur is None:
            return []
        return [int(m) for m in cur.mp_ids if m >= 0]

    def get_tracked_keypoints_un(self):
        cur = self.tracker.current
        if cur is None:
            return np.zeros((0, 2), np.float32)
        return cur.feats.xy_und[cur.feats.valid]

    # ------------------------------------------------------------------

    def save_trajectory_tum(self, path: str):
        traj_io.save_trajectory_tum(path, self.arena, self.tracker.trajectory)

    def save_keyframe_trajectory_tum(self, path: str):
        traj_io.save_keyframe_trajectory_tum(path, self.arena)

    def save_trajectory_kitti(self, path: str):
        traj_io.save_trajectory_kitti(path, self.arena, self.tracker.trajectory)

    SaveTrajectoryTUM = save_trajectory_tum
    SaveKeyFrameTrajectoryTUM = save_keyframe_trajectory_tum
    SaveTrajectoryKITTI = save_trajectory_kitti

    # ------------------------------------------------------------------
    # Map persistence (the reference's explicit TODO, include/System.h:94-96)
    # ------------------------------------------------------------------

    def save_map(self, path: str):
        from orb_slam_system_tpu.mapping.serialize import save_map
        save_map(self.arena, path)

    def load_map(self, path: str, localization_only: bool = True):
        """Load a saved map and resume. With localization_only (default) the
        system relocalizes against the loaded map without modifying it."""
        from orb_slam_system_tpu.mapping.serialize import load_map
        arena = load_map(path)
        self.arena.kfs = arena.kfs
        self.arena.mps = arena.mps
        self.arena.next_kf_id = arena.next_kf_id
        self.arena.next_mp_id = arena.next_mp_id
        self.arena.kf_origin_id = arena.kf_origin_id
        # Rebuild the place-recognition index.
        self.place_rec.reset()
        if self.place_rec.ready or self.place_rec.allow_self_train:
            self.place_rec.maybe_self_train(self.arena)
            if self.place_rec.ready:
                for kf in self.arena.kfs.values():
                    self.place_rec._compute_bow(kf)
                    self.place_rec.db.add(kf.id, kf.bow)
        from orb_slam_system_tpu.config import TrackingState
        self.tracker.state = TrackingState.LOST
        self.tracker.velocity = None
        if localization_only:
            self.activate_localization_mode()

    SaveMap = save_map
    LoadMap = load_map

    # ------------------------------------------------------------------

    def timing_report(self):
        """Median/mean per-frame track time, the report every reference
        driver prints at exit (Examples/Monocular/mono_tum.cc:111-120)."""
        if not self._timings:
            return {"median_s": 0.0, "mean_s": 0.0}
        t = np.sort(np.asarray(self._timings))
        return {"median_s": float(t[len(t) // 2]), "mean_s": float(t.mean())}


def rgb_to_gray(img: np.ndarray, rgb_order: bool = True) -> np.ndarray:
    """cvtColor equivalent (reference src/Tracking.cc:155-160)."""
    img = img.astype(np.float32)
    if rgb_order:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
    else:
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b
