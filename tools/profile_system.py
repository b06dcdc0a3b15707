#!/usr/bin/env python
"""Profile the steady-state system-fps workload: where does a tracked
frame's wall time go (host gathers / fused device round trip /
bookkeeping / keyframe work / mapper stages)? Run on the GPU (the default
backend) to see device round-trip costs, or with JAX_PLATFORMS=cpu for
host hotspots.

Usage: python tools/profile_system.py [n_frames] [--stream] [--async]
       [--pipe] [--depth=N] [--cprofile]

--pipe uses the deep-pipelined chain mode (warming the chain program
first so its ~1.5 s jit compile stays out of the timed window, like
bench.py); --depth=N sets frames in flight; --cprofile wraps the timed
loop in cProfile and prints the top cumulative entries (host hotspots;
device waits show up as numpy.asarray).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    n_frames = 72
    use_stream = "--stream" in sys.argv
    use_async = "--async" in sys.argv
    use_pipe = "--pipe" in sys.argv
    use_cprofile = "--cprofile" in sys.argv
    depth = 2
    for a in sys.argv[1:]:
        if a.isdigit():
            n_frames = int(a)
        elif a.startswith("--depth="):
            depth = int(a.split("=", 1)[1])

    from orb_slam_system_tpu.config import (
        CameraConfig, ORBConfig, Sensor, SlamConfig)
    from orb_slam_system_tpu.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu.models.system import System

    W, H = 640, 480
    cam = CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=1000),
                     sensor=Sensor.MONOCULAR)
    r = PlanarSceneRenderer(cam.K, W, H, texture=make_texture(2048, 8, 7),
                            tex_scale=440.0)
    poses = orbit_trajectory(n_frames, radius=0.35, depth=-2.0, tilt=0.3)
    frames = [np.clip(r.render(T), 0, 255).astype(np.uint8) for T in poses]
    slam = System(None, cfg, Sensor.MONOCULAR, async_mapping=use_async)

    warmup = min(24, n_frames // 3)
    n_chain_warm = min(8, warmup) if use_pipe else 0
    for i in range(warmup - n_chain_warm):
        slam.track_monocular(frames[i], i / 30.0)
    if n_chain_warm:
        warm = ((frames[i], i / 30.0)
                for i in range(warmup - n_chain_warm, warmup))
        for _ in slam.track_monocular_pipelined(warm, depth=depth):
            pass
    # Reset counters after warmup.
    slam.tracker.stage_ms.reset()
    slam.local_mapper.stage_ms.reset()
    frame_ms = []
    n_ok = 0
    prof = None
    if use_cprofile:
        import cProfile
        prof = cProfile.Profile()
        prof.enable()
    t_all = time.perf_counter()
    if use_pipe:
        for _ in slam.track_monocular_pipelined(
                ((frames[i], i / 30.0) for i in range(warmup, n_frames)),
                depth=depth):
            if slam.tracker.state.name == "OK":
                n_ok += 1
    elif use_stream:
        for _ in slam.track_monocular_stream(
                (frames[i], i / 30.0) for i in range(warmup, n_frames)):
            if slam.tracker.state.name == "OK":
                n_ok += 1
    else:
        for i in range(warmup, n_frames):
            t0 = time.perf_counter()
            slam.track_monocular(frames[i], i / 30.0)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if slam.tracker.state.name == "OK":
                n_ok += 1
    wall = time.perf_counter() - t_all
    if prof is not None:
        prof.disable()
    n_timed = n_frames - warmup
    slam.shutdown()

    print(f"\n=== {n_timed} frames in {wall:.2f}s -> "
          f"{n_timed / wall:.1f} fps, ok={n_ok}/{n_timed} "
          f"(pipe={use_pipe} depth={depth} stream={use_stream} "
          f"async={use_async}) ===")
    if prof is not None:
        import pstats
        stats = pstats.Stats(prof)
        stats.sort_stats("cumulative")
        stats.print_stats(30)
    if frame_ms and not use_stream:
        print(f"frame ms: median {np.median(frame_ms):.1f} "
              f"p90 {np.percentile(frame_ms, 90):.1f} "
              f"max {max(frame_ms):.1f}")
    print("\n-- tracker stages (total ms over timed frames / calls) --")
    for k, v in sorted(slam.tracker.stage_ms.ms.items(),
                       key=lambda kv: -kv[1]):
        h = slam.tracker.stage_ms.history[k]
        print(f"  {k:20s} {v:8.1f} ms  ({len(h)} calls, "
              f"mean {np.mean(h):6.2f}, p90 {np.percentile(h, 90):6.2f})")
    print("\n-- mapper stages --")
    for k, v in sorted(slam.local_mapper.stage_ms.ms.items(),
                       key=lambda kv: -kv[1]):
        h = slam.local_mapper.stage_ms.history[k]
        print(f"  {k:20s} {v:8.1f} ms  ({len(h)} calls, "
              f"mean {np.mean(h):6.2f})")


if __name__ == "__main__":
    main()
