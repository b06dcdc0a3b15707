"""Full-system batched multi-sequence mode (BASELINE.json config 5).

S complete Systems (tracking + mapping + loop closing)
whose per-frame extraction runs as ONE batched device program; each
produces its own trajectory. parallel/multiseq.py remains the sharded
multi-chip front-end microbenchmark (exercised by dryrun_multichip).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def test_multi_system_full_slam(tmp_path):
    from examples.multiseq_throughput import run_full
    from orb_slam_system_tpu.config import TrackingState

    ms, ates, fps = run_full(n_seq=3, n_frames=22, out_dir=str(tmp_path),
                             n_features=400, verbose=False)
    # Every sequence ran FULL SLAM: initialized, mapped, tracked.
    for s, sy in enumerate(ms.systems):
        assert sy.get_tracking_state() == TrackingState.OK, s
        assert sy.arena.n_keyframes() >= 3, s
        assert sy.arena.n_points() > 100, s
    # Centimeter-class ATE per sequence (independent maps).
    assert all(a < 0.05 for a in ates), ates
    assert fps > 0
    # One trajectory file per sequence.
    for s in range(3):
        p = tmp_path / f"CameraTrajectory_seq{s}.txt"
        assert p.exists() and len(p.read_text().splitlines()) > 10


def test_multi_system_batches_extraction(tmp_path):
    """The steady-state path must use the SHARED batched extractor (one
    [S,H,W] program), not per-system extract calls."""
    from examples.mono_synthetic import make_config
    from orb_slam_system_tpu.config import Sensor
    from orb_slam_system_tpu.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu.parallel.multi_system import MultiSystem

    cfg = make_config(n_features=400)
    S = 2
    renderers = [
        PlanarSceneRenderer(cfg.camera.K, cfg.camera.width,
                            cfg.camera.height,
                            texture=make_texture(2048, 8, seed=7 + s),
                            tex_scale=220.0)
        for s in range(S)
    ]
    trajs = [orbit_trajectory(12, radius=0.3 + 0.02 * s, depth=-2.0,
                              tilt=0.3) for s in range(S)]
    ms = MultiSystem(cfg, S)
    calls = {"batch": 0}
    orig = ms.shared_builder._extract_packed_batch

    def counted(imgs):
        calls["batch"] += 1
        return orig(imgs)

    ms.shared_builder._extract_packed_batch = counted
    for i in range(12):
        imgs = np.stack([renderers[s].render(trajs[s][i]) for s in range(S)])
        ms.track_batch(imgs, i / 30.0)
    ms.shutdown()
    # Batched extraction engaged once per steady frame round.
    assert calls["batch"] >= 6, calls
