"""Async/interruptible global BA + spanning-tree propagation.

Upstream runs GBA on a side thread, abortable via mbStopGBA, and — after
the solve — propagates corrected poses through the spanning tree to
keyframes created DURING the solve, re-anchoring their points via the
reference keyframe (reference src/LoopClosing.cc:340-410). These tests
drive GBARunner + LoopCloser.poll_gba directly on a constructed map.
"""

import numpy as np
import pytest

from orb_slam_system_tpu.config import CameraConfig, ORBConfig, Sensor, SlamConfig
from orb_slam_system_tpu.mapping.arena import FrameFeatures, MapArena
from orb_slam_system_tpu.models.local_mapping import LocalMapper
from orb_slam_system_tpu.models.loop_closing import LoopCloser
from orb_slam_system_tpu.models.place_recognition import PlaceRecognition

FX = FY = 300.0
CX, CY = 160.0, 120.0
N_SLOTS = 128


def make_cfg():
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, width=320, height=240)
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=N_SLOTS),
                      sensor=Sensor.MONOCULAR)


def make_feats(uv, n_slots=N_SLOTS):
    n = len(uv)
    xy = np.zeros((n_slots, 2), np.float32)
    xy[:n] = uv
    valid = np.zeros(n_slots, bool)
    valid[:n] = True
    return FrameFeatures(
        xy=xy, xy_und=xy.copy(), response=np.ones(n_slots, np.float32),
        angle=np.zeros(n_slots, np.float32),
        octave=np.zeros(n_slots, np.int32),
        desc=np.zeros((n_slots, 8), np.uint32), valid=valid)


def build_map(rng, n_kfs=5, noise=0.02):
    """Chain of keyframes along x observing a common cloud, with noisy
    poses/points so GBA has something to correct."""
    arena = MapArena()
    world = rng.uniform(-2, 2, size=(80, 3)).astype(np.float32)
    world[:, 2] = rng.uniform(4, 7, size=80)
    kfs = []
    for i in range(n_kfs):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -0.3 * i
        if i > 0:
            T[:3, 3] += rng.normal(scale=noise, size=3).astype(np.float32)
        Xc = world @ T[:3, :3].T + T[:3, 3]
        uv = Xc[:, :2] / Xc[:, 2:3] * [FX, FY] + [CX, CY]
        kf = arena.new_keyframe(i, float(i), T, make_feats(uv))
        if i > 0:
            kf.parent = kfs[-1].id
            kfs[-1].children.add(kf.id)
        kfs.append(kf)
    arena.kf_origin_id = kfs[0].id
    mps = []
    for p in range(world.shape[0]):
        mp = arena.new_point(
            world[p] + rng.normal(scale=noise, size=3).astype(np.float32),
            np.zeros(8, np.uint32), kfs[0].id, kfs[0].id)
        for kf in kfs:
            arena.add_observation(mp, kf, p)
        mps.append(mp)
    return arena, kfs, world


def make_closer(arena):
    cfg = make_cfg()
    lm = LocalMapper(cfg, arena)
    pr = PlaceRecognition(None)
    return LoopCloser(cfg, arena, pr, lm)


def test_gba_propagates_to_keyframes_created_during_solve(rng):
    arena, kfs, world = build_map(rng)
    closer = make_closer(arena)
    snap = closer._build_gba_problem()
    assert snap is not None
    # Solve synchronously (deterministic), but DELAY the apply: a new
    # keyframe arrives in between — exactly the upstream race.
    closer.gba.start(snap, closer.cfg.camera, sync=True)
    T_new = np.eye(4, dtype=np.float32)
    T_new[0, 3] = -0.3 * len(kfs)
    late = arena.new_keyframe(99, 99.0, T_new, make_feats(np.zeros((1, 2))))
    late.parent = kfs[-1].id
    kfs[-1].children.add(late.id)
    # A point born during the solve, anchored at the late keyframe's parent.
    late_pt = arena.new_point(world[0] + 0.5, np.zeros(8, np.uint32),
                              kfs[-1].id, kfs[-1].id)
    pre_parent = kfs[-1].Tcw.copy()
    pre_child = late.Tcw.copy()
    Tcp_old = pre_child @ np.linalg.inv(pre_parent)
    pc_old = pre_parent[:3, :3] @ late_pt.pos + pre_parent[:3, 3]

    assert closer.poll_gba()
    # Parent was optimized; the late child must follow through the tree:
    # Tcw_child_new = Tcp_old @ Tcw_parent_new.
    expect_child = Tcp_old @ kfs[-1].Tcw
    np.testing.assert_allclose(late.Tcw, expect_child, atol=1e-5)
    # The late point re-anchors via its reference KF (camera-frame coords
    # preserved across the correction).
    T_ref_new = kfs[-1].Tcw
    pc_new = T_ref_new[:3, :3] @ late_pt.pos + T_ref_new[:3, 3]
    np.testing.assert_allclose(pc_new, pc_old, atol=1e-4)
    # And GBA actually improved the noisy chain: optimized poses exist for
    # every snapshot keyframe.
    for kf in kfs[1:]:
        assert not np.allclose(kf.Tcw, np.eye(4))


def test_gba_abort_discards_result(rng):
    arena, kfs, world = build_map(rng)
    closer = make_closer(arena)
    snap = closer._build_gba_problem()
    closer.gba.start(snap, closer.cfg.camera, sync=False)
    closer.gba.abort()
    assert closer.gba.take_result() is None
    assert not closer.poll_gba()


def test_gba_abort_after_finish_discards_result(rng):
    """A solve that finished before abort() (its last abort check already
    passed) is superseded all the same."""
    arena, kfs, world = build_map(rng)
    closer = make_closer(arena)
    snap = closer._build_gba_problem()
    closer.gba.start(snap, closer.cfg.camera, sync=False)
    closer.gba.join()
    closer.gba.abort()
    assert closer.gba.take_result() is None
    assert not closer.poll_gba()


def test_gba_async_roundtrip(rng):
    arena, kfs, world = build_map(rng)
    closer = make_closer(arena)
    poses_before = {k.id: k.Tcw.copy() for k in kfs}
    snap = closer._build_gba_problem()
    closer.gba.start(snap, closer.cfg.camera, sync=False)
    closer.gba.join()
    assert closer.poll_gba()
    moved = sum(
        0 if np.allclose(poses_before[k.id], k.Tcw, atol=1e-7) else 1
        for k in kfs[1:])
    assert moved >= 1
