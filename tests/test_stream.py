"""Pipelined streaming tracking (System.track_monocular_stream).

The stream keeps one frame in flight (frame i+1's extraction enqueued
before frame i's tracking fetch). Semantics must equal the sequential
track_monocular loop exactly in deterministic (sync-mapping) mode.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orb_slam_system_tpu.config import (  # noqa: E402
    CameraConfig, ORBConfig, Sensor, SlamConfig, TrackingState)
from orb_slam_system_tpu.dataio.synthetic import (  # noqa: E402
    PlanarSceneRenderer, make_texture, orbit_trajectory)
from orb_slam_system_tpu.models.system import System  # noqa: E402


def _setup(n_frames=16):
    W, H = 640, 480
    cam = CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=400),
                     sensor=Sensor.MONOCULAR)
    r = PlanarSceneRenderer(cam.K, W, H, texture=make_texture(2048, 8, 7),
                            tex_scale=220.0)
    poses = orbit_trajectory(n_frames, radius=0.35, depth=-2.0, tilt=0.3)
    frames = [(r.render(T), i / 30.0) for i, T in enumerate(poses)]
    return cfg, frames


def test_stream_with_async_mapping():
    """The bench's exact combination: streaming + the async mapping worker.
    Gates tracking health and clean shutdown (results aren't deterministic
    across interleavings, so only quality is asserted)."""
    cfg, frames = _setup(n_frames=18)
    slam = System(None, cfg, Sensor.MONOCULAR, async_mapping=True)
    out = list(slam.track_monocular_stream(frames))
    slam.shutdown()
    assert len(out) == len(frames)
    assert slam.get_tracking_state() == TrackingState.OK
    assert slam.arena.n_keyframes() >= 2
    assert not slam.local_mapper.queue


def test_reset_mid_stream():
    """System.reset while a stream has a prebuilt frame in flight: the
    stream continues, re-initializes, and ends healthy."""
    cfg, frames = _setup(n_frames=24)
    slam = System(None, cfg, Sensor.MONOCULAR)
    stream = slam.track_monocular_stream(frames)
    for i, _ in enumerate(stream):
        if i == 10:
            slam.reset()
    slam.shutdown()
    # Re-initialized after the reset and tracking again by the end.
    assert slam.get_tracking_state() == TrackingState.OK
    assert slam.arena.n_keyframes() >= 2


def test_save_load_under_async_mapping(tmp_path):
    """save_map takes the map mutex: a consistent snapshot while the async
    worker is live, and the reloaded map localizes."""
    cfg, frames = _setup(n_frames=16)
    slam = System(None, cfg, Sensor.MONOCULAR, async_mapping=True)
    for img, ts in frames[:-2]:
        slam.track_monocular(img, ts)
    path = str(tmp_path / "map.npz")
    slam.save_map(path)          # worker may be mid-drain
    slam.shutdown()
    slam2 = System(None, cfg, Sensor.MONOCULAR)
    slam2.load_map(path, localization_only=True)
    tracked = 0
    for img, ts in frames[-6:]:
        slam2.track_monocular(img, ts)
        if slam2.get_tracking_state() == TrackingState.OK:
            tracked += 1
    slam2.shutdown()
    assert tracked >= 1
    assert slam2.arena.n_points() > 50


def test_stream_matches_sequential():
    cfg, frames = _setup()
    seq = System(None, cfg, Sensor.MONOCULAR)
    seq_out = [seq.track_monocular(img, ts) for img, ts in frames]
    seq.shutdown()

    st = System(None, cfg, Sensor.MONOCULAR)
    st_out = list(st.track_monocular_stream(frames))
    st.shutdown()

    assert len(st_out) == len(seq_out)
    assert st.get_tracking_state() == TrackingState.OK
    for a, b in zip(seq_out, st_out):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-5)
    assert st.arena.n_keyframes() == seq.arena.n_keyframes()
    assert st.arena.n_points() == seq.arena.n_points()


def test_pipelined_mode_quality():
    """Deep-pipelined (device-state) tracking mode: quality-equivalent to
    the sequential path on the synthetic orbit. The safeguards (classic
    keyframes, maturity + margin gates) keep map content classic-grade;
    the per-frame chain only carries pose tracking between keyframes."""
    import numpy as np

    from examples.mono_synthetic import make_config
    from orb_slam_system_tpu.config import Sensor, TrackingState
    from orb_slam_system_tpu.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu.dataio import trajectory as traj_io
    from orb_slam_system_tpu.models.system import System

    cfg = make_config(n_features=400)
    r = PlanarSceneRenderer(cfg.camera.K, cfg.camera.width, cfg.camera.height,
                            texture=make_texture(2048, 8, 7), tex_scale=220.0)
    poses = orbit_trajectory(40, radius=0.35, depth=-2.0, tilt=0.3)
    slam = System(None, cfg, Sensor.MONOCULAR)
    gt = {}

    def gen():
        for i, T in enumerate(poses):
            gt[i / 30.0] = (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
            yield r.render(T), i / 30.0

    n_ok = 0
    n_yield = 0
    for _ in slam.track_monocular_pipelined(gen()):
        n_yield += 1
        if slam.get_tracking_state() == TrackingState.OK:
            n_ok += 1
    slam.shutdown()
    assert n_yield == 40          # one yield per frame, in order
    assert n_ok >= 36
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    rmse = traj_io.ate_rmse(est, gt)
    assert rmse < 0.03, rmse


def test_pipelined_aggressive_motion():
    """Fast-motion stress: the pipelined mode's
    one-frame-stale local block and chain approximations must not cost
    tracking robustness when per-frame motion is ~3x the nominal orbit
    step — either the chain holds quality or the margin gates re-anchor
    classically. Compare against the exact sequential path on the SAME
    fast sequence."""
    import numpy as np

    from examples.mono_synthetic import make_config
    from orb_slam_system_tpu.dataio import trajectory as traj_io

    cfg = make_config(n_features=400)
    r = PlanarSceneRenderer(cfg.camera.K, cfg.camera.width,
                            cfg.camera.height,
                            texture=make_texture(2048, 8, 7),
                            tex_scale=220.0)
    # 24 frames over the same arc the nominal tests cover in 72: ~3x the
    # per-frame baseline and yaw rate.
    poses = orbit_trajectory(24, radius=0.35, depth=-2.0, tilt=0.3,
                             yaw_amp=0.06)
    frames = [(np.clip(r.render(T), 0, 255).astype(np.uint8), i / 30.0)
              for i, T in enumerate(poses)]
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}

    def run(pipelined):
        slam = System(None, cfg, Sensor.MONOCULAR)
        n_ok = 0
        it = (slam.track_monocular_pipelined(iter(frames)) if pipelined
              else (slam.track_monocular(img, ts) for img, ts in frames))
        for _ in it:
            if slam.get_tracking_state() == TrackingState.OK:
                n_ok += 1
        est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
        rmse = traj_io.ate_rmse(est, gt)
        slam.shutdown()
        return n_ok, rmse

    ok_seq, ate_seq = run(False)
    ok_pipe, ate_pipe = run(True)
    assert ok_pipe >= ok_seq - 1, (ok_pipe, ok_seq)
    assert ate_pipe < max(2.0 * ate_seq, 0.02), (ate_pipe, ate_seq)


def test_pipelined_chain_stays_on_manifold():
    """Regression for the chain pose-state SO(3) decay: chained device
    steps feed pose products back through the next step's transpose-trick
    inverse, and without the per-step SE(3) projection the orthogonality
    error compounded geometrically (det(R) reached 0.59 within ~12 chained
    frames, >100 px projection error, match collapse, and degraded poses
    leaking into host bookkeeping — every later re-entry then failed
    immediately).  A long orbit must keep the chain accepting all the way
    to the end, with every stored pose a proper rotation."""
    cfg, _ = _setup()
    r = PlanarSceneRenderer(cfg.camera.K, cfg.camera.width,
                            cfg.camera.height,
                            texture=make_texture(2048, 8, 7),
                            tex_scale=220.0)
    poses = orbit_trajectory(72, radius=0.35, depth=-2.0, tilt=0.3)
    slam = System(None, cfg, Sensor.MONOCULAR)
    tr = slam.tracker
    late_results = []           # chain outcomes over the last third
    orig = tr.chain_process

    def spy(frame, ids, packed_out):
        res = orig(frame, ids, packed_out)
        if frame.id >= 48:
            late_results.append(res)
        return res

    tr.chain_process = spy
    n_ok = 0
    for _ in slam.track_monocular_pipelined(
            (r.render(T), i / 30.0) for i, T in enumerate(poses)):
        if slam.get_tracking_state() == TrackingState.OK:
            n_ok += 1
    slam.shutdown()
    st = tr.chain_stats
    assert st["accept"] >= 10, st
    # The decay bug made every late attempt a reject; with the projection
    # the late window keeps accepting.
    assert late_results and any(x is True for x in late_results), (
        st, late_results)
    assert sum(1 for x in late_results if x is None) <= len(late_results) // 2
    assert n_ok >= 66
    # Every pose the chain wrote into host bookkeeping is a rotation
    # (Tcr = Tcw @ inv(ref Tcw): orthonormal iff the stored Tcw is).
    for e in tr.trajectory:
        R = np.asarray(e.Tcr, np.float64)[:3, :3]
        assert abs(np.linalg.det(R) - 1.0) < 1e-3, (
            e.timestamp, np.linalg.det(R))


def test_pipelined_stereo_quality():
    """Stereo deep-pipelined mode (System.track_stereo_pipelined): same
    chain architecture over the 18-wide stereo packed buffer — stereo
    observations enter the in-program pose LM (u_right), and the stereo
    keyframe decision's close-point counts come from the chain program
    (reference Tracking.cc:590-600) instead of a per-frame depth fetch.
    Quality-equivalent to the sequential stereo path, metric scale held."""
    from examples.stereo_synthetic import BASELINE, make_config
    from orb_slam_system_tpu.dataio import trajectory as traj_io

    cfg = make_config(n_features=400)
    r = PlanarSceneRenderer(cfg.camera.K, cfg.camera.width,
                            cfg.camera.height,
                            texture=make_texture(2048, 8, 7),
                            tex_scale=220.0)
    poses = orbit_trajectory(30, radius=0.35, depth=-2.0, tilt=0.3)
    frames = []
    gt = {}
    for i, T in enumerate(poses):
        left, right = r.render_stereo(T, BASELINE)
        frames.append((left, right, i / 30.0))
        gt[i / 30.0] = (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)

    def run(pipelined):
        slam = System(None, cfg, Sensor.STEREO)
        n_ok = 0
        it = (slam.track_stereo_pipelined(iter(frames)) if pipelined
              else (slam.track_stereo(le, ri, ts) for le, ri, ts in frames))
        chain_accepts = 0
        for _ in it:
            if slam.get_tracking_state() == TrackingState.OK:
                n_ok += 1
        if pipelined:
            chain_accepts = slam.tracker.chain_stats["accept"]
        est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
        # SE3-only alignment: removes the arbitrary world frame (the
        # estimate's origin is the first camera) but NOT scale — a scale
        # drift through the chain would show up here.
        rmse = traj_io.ate_rmse(est, gt, with_scale=False)
        slam.shutdown()
        return n_ok, rmse, chain_accepts

    ok_seq, ate_seq, _ = run(False)
    ok_pipe, ate_pipe, accepts = run(True)
    assert ok_pipe >= ok_seq - 1, (ok_pipe, ok_seq)
    # Metric (unaligned) ATE: scale must hold through the chain.
    assert ate_pipe < max(2.0 * ate_seq, 0.06), (ate_pipe, ate_seq)
    # The chain actually engaged (not everything re-anchored classically).
    assert accepts >= 8, accepts


def test_pipelined_rgbd_quality():
    """RGB-D deep-pipelined mode over synthetic frames with analytic
    depth; chain engages and metric ATE stays bounded."""
    from orb_slam_system_tpu.dataio import trajectory as traj_io

    W, H = 320, 240
    cam = CameraConfig(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H, bf=260.0 * 0.08)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=400),
                     sensor=Sensor.RGBD, th_depth=40.0,
                     depth_map_factor=5000.0)
    r = PlanarSceneRenderer(cam.K, W, H, texture=make_texture(2048, 8, 7),
                            tex_scale=220.0)
    poses = orbit_trajectory(26, radius=0.35, depth=-2.0, tilt=0.3)
    frames = []
    gt = {}
    for i, T in enumerate(poses):
        img = r.render(T)
        depth_raw = r.render_depth(T) * 5000.0
        frames.append((img, depth_raw, i / 30.0))
        gt[i / 30.0] = (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)

    slam = System(None, cfg, Sensor.RGBD)
    n_ok = 0
    for _ in slam.track_rgbd_pipelined(iter(frames)):
        if slam.get_tracking_state() == TrackingState.OK:
            n_ok += 1
    accepts = slam.tracker.chain_stats["accept"]
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    rmse = traj_io.ate_rmse(est, gt, with_scale=False)  # SE3-only: metric
    slam.shutdown()
    assert n_ok >= 23, n_ok
    assert rmse < 0.08, rmse
    assert accepts >= 6, accepts


def test_weak_chain_result_does_not_poison_close_counts():
    """A REJECTED chain result's close-point counts must not stick to
    the frame: they come from a collapsed association, and the classic
    fallback's keyframe decision (need_new_keyframe -> _close_point_counts)
    would short-circuit on them instead of recomputing from the frame's
    depth column (reference Tracking.cc:590-600 computes the counts from
    the CURRENT association)."""
    from orb_slam_system_tpu.models.frame import Frame

    cfg, _ = _setup(n_frames=2)
    slam = System(None, cfg, Sensor.MONOCULAR)
    tr = slam.tracker
    frame = Frame(id=123, timestamp=0.0,
                  packed_dev=np.zeros((8, 16), np.float32))
    n = frame.n_slots
    # Weak decode: 0 matches -> the first reject gate fires.
    tr.programs.decode_chain_out = lambda packed: (
        np.eye(4, dtype=np.float32), np.full(n, -1, np.int64),
        np.zeros(n, bool), np.zeros(n, bool),
        0, 0, 0, 0, (0, 999))
    res = tr.chain_process(frame, [], object())
    slam.shutdown()
    assert res is None
    assert frame.chain_close_counts is None
