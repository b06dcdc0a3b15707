"""KITTI-00-scale stress gate (env-gated: ORB_SLAM_RUN_KITTI_SCALE=1).

A ~4000-frame drive-style synthetic sequence (long
straights + turns + same-direction revisits) through pipelined monocular
tracking — stresses keyframe culling churn, spanning-tree surgery,
trajectory export through culled references, and memory growth at the
scale of the reference's committed artifact
(/root/reference/CameraTrajectory.txt: 4541 KITTI-format rows; export
semantics src/System.cc:398-451).

Run manually:
  ORB_SLAM_RUN_KITTI_SCALE=1 python -m pytest tests/test_kitti_scale.py -s
(~1-2 h on this host's single CPU core.)
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

pytestmark = pytest.mark.skipif(
    os.environ.get("ORB_SLAM_RUN_KITTI_SCALE") != "1",
    reason="multi-hour drive-scale run (set ORB_SLAM_RUN_KITTI_SCALE=1)")


def test_kitti_scale_drive(tmp_path):
    from examples.kitti_synthetic import run

    n = int(os.environ.get("ORB_SLAM_KITTI_FRAMES", "4000"))
    out = str(tmp_path / "kitti")
    slam, s = run(n_frames=n, out_dir=out, verbose=True,
                  async_mapping=os.environ.get(
                      "ORB_SLAM_KITTI_ASYNC", "0") == "1")

    # Tracking held through the drive.
    assert s["n_tracked"] >= 0.9 * n, s
    # Second-lap revisits close loops.
    assert s["loops_closed"] >= 1, s["loop_stats"]
    # Loop-corrected metric accuracy over a ~200 m circuit: cm-to-dm
    # class (scale-free mono, Sim3-aligned ATE).
    assert s["ate_rmse_m"] < 0.30, s
    # Keyframe culling bounded the map: the second lap must mostly REUSE
    # the first lap's keyframes rather than double the map.
    assert s["n_keyframes_final"] < 0.25 * n, s
    # Host time stays bounded as the map grows (last third within 3x the
    # first third's median).
    m1, _, m3 = s["host_ms_median_thirds"]
    assert m3 < 3.0 * max(m1, 1.0), s["host_ms_median_thirds"]

    # --- Export parity vs the reference artifact's format -------------
    rows = [ln.split() for ln in open(
        os.path.join(out, "CameraTrajectory.txt")).read().splitlines()]
    # One row per frame from initialization on, 12 floats each (3x4
    # row-major), like the reference's 4541-row artifact. The artifact is
    # a stereo/RGB-D run (init on frame 0 -> one row per image); upstream
    # MONOCULAR stores no trajectory entry until initialization succeeds
    # (Track() returns before the bookkeeping, src/Tracking.cc:226-249),
    # so a mono drive legitimately emits n-1..n-2 rows.
    assert n - 2 <= len(rows) <= n, len(rows)
    assert all(len(r) == 12 for r in rows)
    M = np.asarray([float(v) for v in rows[len(rows) // 2]]).reshape(3, 4)
    np.testing.assert_allclose(M[:, :3] @ M[:, :3].T, np.eye(3), atol=1e-4)
    ref_art = "/root/reference/CameraTrajectory.txt"
    if os.path.exists(ref_art):
        with open(ref_art) as f:
            ref_row = f.readline().split()
        assert len(ref_row) == len(rows[0]) == 12
