#!/usr/bin/env python
"""One-command real-dataset validation (the runbook glue).

The reference validates by running its dataset drivers and evaluating the
written trajectory against ground truth offline (SURVEY.md §4). This CLI
makes that a single invocation the day real assets (TUM fr1_xyz, KITTI 00,
EuRoC MH01, ORBvoc.txt) land on a machine:

    python tools/run_dataset.py /data/rgbd_dataset_freiburg1_xyz \
        --voc /data/ORBvoc.txt --max-ate 0.05

It auto-detects the dataset layout, picks the matching driver + shipped
settings file, PRE-VALIDATES the vocabulary load (so a bad path fails in
seconds, not after the run), runs the driver, associates the written
trajectory with the dataset's ground truth and prints ATE RMSE via
tools/evaluate_ate.py conventions. See docs/RUNBOOK.md for expected
numbers per sequence.

Layout detection:
  * TUM mono:   <dir>/rgb.txt                     -> examples/mono_tum.py
  * TUM RGB-D:  <dir>/rgb.txt + depth.txt (+ --assoc or
                <dir>/associations.txt)           -> examples/rgbd_tum.py
  * KITTI:      <dir>/image_0 + times.txt         -> examples/mono_kitti.py
                (--sensor stereo + image_1        -> examples/stereo_kitti.py)
  * EuRoC:      <dir>/mav0/cam0/data + --timestamps
                                                  -> examples/mono_euroc.py
Ground truth: TUM <dir>/groundtruth.txt (TUM format) is picked up
automatically; KITTI poses need --gt <poses/00.txt>.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SETTINGS = os.path.join(ROOT, "examples", "settings")
sys.path.insert(0, ROOT)


def detect(seq_dir: str, sensor: str):
    """Returns (kind, driver, default_settings)."""
    if os.path.exists(os.path.join(seq_dir, "rgb.txt")):
        if (sensor == "rgbd"
                or (sensor == "auto"
                    and os.path.exists(os.path.join(seq_dir, "depth.txt"))
                    and os.path.exists(os.path.join(seq_dir,
                                                    "associations.txt")))):
            return ("tum_rgbd", "examples/rgbd_tum.py", "tum1.yaml")
        return ("tum_mono", "examples/mono_tum.py", "tum1.yaml")
    if os.path.isdir(os.path.join(seq_dir, "image_0")):
        if sensor == "stereo" and os.path.isdir(
                os.path.join(seq_dir, "image_1")):
            return ("kitti_stereo", "examples/stereo_kitti.py",
                    "kitti00-02.yaml")
        return ("kitti_mono", "examples/mono_kitti.py", "kitti00-02.yaml")
    if os.path.isdir(os.path.join(seq_dir, "mav0")):
        return ("euroc_mono", "examples/mono_euroc.py", "euroc_mono.yaml")
    raise SystemExit(f"unrecognized dataset layout under {seq_dir} "
                     "(expected rgb.txt, image_0/, or mav0/)")


def prevalidate_vocabulary(voc: str):
    """Load the vocabulary NOW (text parse + npz cache) so a bad path or
    truncated file fails before the hour-long run, and report its shape
    — the reference's ~10 s/140 MB load (src/System.cc:41-51) happens
    once here and is cached for the driver process."""
    from orb_slam_system_tpu.vocab.vocabulary import Vocabulary
    print(f"pre-validating vocabulary: {voc}")
    v = Vocabulary.load(voc)
    print(f"  ok: k={v.k} L={v.L} nodes={len(v.node_desc)} "
          f"words={v.n_words}")


def main():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("seq_dir")
    ap.add_argument("--voc", default="none",
                    help="ORBvoc.txt path ('none' = self-trained fallback)")
    ap.add_argument("--settings", default=None,
                    help="settings yaml (default: auto by dataset kind)")
    ap.add_argument("--sensor", default="auto",
                    choices=["auto", "mono", "stereo", "rgbd"])
    ap.add_argument("--gt", default=None,
                    help="ground-truth file (default: <dir>/groundtruth.txt)")
    ap.add_argument("--timestamps", default=None,
                    help="EuRoC timestamp file")
    ap.add_argument("--max-ate", type=float, default=None,
                    help="fail (exit 1) if ATE RMSE exceeds this [m]")
    ap.add_argument("--out-dir", default=".",
                    help="where the driver writes trajectories")
    ap.add_argument("--realtime", action="store_true",
                    help="pace frames to dataset timestamps (default: "
                         "unpaced — ATE is pacing-independent)")
    args = ap.parse_args()

    kind, driver, default_settings = detect(args.seq_dir, args.sensor)
    settings = args.settings or os.path.join(SETTINGS, default_settings)
    print(f"dataset kind: {kind}\ndriver: {driver}\nsettings: {settings}")

    if args.voc.lower() != "none":
        prevalidate_vocabulary(args.voc)

    cmd = [sys.executable, os.path.join(ROOT, driver), args.voc, settings,
           args.seq_dir]
    if kind == "tum_rgbd":
        assoc = os.path.join(args.seq_dir, "associations.txt")
        cmd.append(assoc)
    if kind == "euroc_mono":
        if not args.timestamps:
            raise SystemExit("EuRoC needs --timestamps")
        cmd.append(args.timestamps)
    if not args.realtime:
        cmd.append("--no-realtime")
    print("running:", " ".join(cmd), flush=True)
    rc = subprocess.run(cmd, cwd=args.out_dir).returncode
    if rc != 0:
        raise SystemExit(rc)

    # Trajectory the driver wrote (reference file names, src/System.cc).
    traj_name = ("CameraTrajectory.txt" if kind == "kitti_stereo"
                 else "KeyFrameTrajectory.txt")
    traj = os.path.join(args.out_dir, traj_name)
    if not os.path.exists(traj):
        raise SystemExit(f"driver wrote no {traj_name}")
    print(f"trajectory: {traj}")

    gt = args.gt or os.path.join(args.seq_dir, "groundtruth.txt")
    if not os.path.exists(gt):
        print(f"no ground truth at {gt} — skipping ATE (run "
              f"tools/evaluate_ate.py manually when it exists)")
        return
    eval_cmd = [sys.executable, os.path.join(HERE, "evaluate_ate.py"),
                gt, traj]
    if kind.startswith(("tum_mono", "kitti_mono", "euroc")):
        eval_cmd.append("--scale")   # monocular: Sim3 alignment
    if args.max_ate is not None:
        eval_cmd += ["--max_ate", str(args.max_ate)]
    print("evaluating:", " ".join(eval_cmd), flush=True)
    raise SystemExit(subprocess.run(eval_cmd).returncode)


if __name__ == "__main__":
    main()
