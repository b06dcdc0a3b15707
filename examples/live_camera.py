"""Live-camera monocular driver (the reference's `myslam`).

Equivalent of Examples/Monocular/laptop_camera.cpp:6-20: open
cv::VideoCapture(index) at 1280x720, timestamp frames with wall-clock
time, and feed System.TrackMonocular until interrupted. Differences are
device-side only: frames go through the pipelined tracking API so the
host-device round trip overlaps the next capture, and a `--max-frames`
bound plus graceful no-device reporting make the driver testable on
machines without a camera.

Usage: python examples/live_camera.py path_to_vocabulary path_to_settings \
       [camera_index] [--max-frames N] [--classic]

The capture backend is cv2 when importable (the reference's own backend);
`open_capture` is injectable for tests (any object with read() ->
(ok, HxW[x3] uint8) and release()).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

CAPTURE_W, CAPTURE_H = 1280, 720   # laptop_camera.cpp:8-10


def open_capture(index: int = 0):
    """cv2.VideoCapture at the reference's 1280x720; None if unavailable
    (no cv2 or no device) — callers report and exit cleanly."""
    try:
        import cv2
    except Exception:  # noqa: BLE001 — cv2 optional at runtime
        return None
    cap = cv2.VideoCapture(index)
    if not cap.isOpened():
        cap.release()
        return None
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, CAPTURE_W)
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, CAPTURE_H)
    return cap


def frame_source(cap, max_frames=None):
    """(gray f32[H,W], wall-clock seconds) frames from a capture object.
    Stops on read failure or after max_frames."""
    t_origin = time.time()
    n = 0
    while max_frames is None or n < max_frames:
        ok, img = cap.read()
        if not ok or img is None:
            break
        img = np.asarray(img)
        if img.ndim == 3:
            # BGR (cv2 convention) -> gray, reference Tracking::
            # GrabImageMonocular (src/Tracking.cc:155-160) with RGB=0.
            img = (0.114 * img[..., 0] + 0.587 * img[..., 1]
                   + 0.299 * img[..., 2])
        yield img.astype(np.float32), time.time() - t_origin
        n += 1


def run(slam, cap, max_frames=None, pipelined=True, report_every=30):
    """Track a live capture until it ends; returns frames processed."""
    src = frame_source(cap, max_frames)
    n = 0
    it = (slam.track_monocular_pipelined(src) if pipelined
          else (slam.track_monocular(im, t) for im, t in src))
    for _ in it:
        n += 1
        if report_every and n % report_every == 0:
            print(f"frame {n}: state={slam.get_tracking_state().name} "
                  f"kfs={slam.arena.n_keyframes()}", flush=True)
    return n


def main():
    if len(sys.argv) < 3:
        print(__doc__)
        sys.exit(1)
    voc_path = None if sys.argv[1].lower() == "none" else sys.argv[1]
    settings = sys.argv[2]
    args = sys.argv[3:]
    index = int(args[0]) if args and not args[0].startswith("--") else 0
    max_frames = None
    if "--max-frames" in args:
        max_frames = int(args[args.index("--max-frames") + 1])
    pipelined = "--classic" not in args

    cap = open_capture(index)
    if cap is None:
        print(f"error: no camera at index {index} (or cv2 unavailable); "
              "use video_slam.py for file/directory sources", file=sys.stderr)
        sys.exit(2)

    from orb_slam_system_tpu.config import Sensor, load_settings
    from orb_slam_system_tpu.models.system import System

    cfg = load_settings(settings, Sensor.MONOCULAR)
    slam = System(voc_path, cfg, Sensor.MONOCULAR, async_mapping=True)
    try:
        n = run(slam, cap, max_frames, pipelined)
    finally:
        cap.release()
        slam.shutdown()
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    print(f"processed {n} frames")


if __name__ == "__main__":
    main()
