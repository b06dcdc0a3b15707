"""Compile-cache pre-warm for serving: kill the cold-compile cliff.

Every distinct (size-bucket x variant) combination of the jitted SLAM
programs costs a compile on first encounter, multi-second each, and a cold
keyframe-heavy run spends most of its first frames compiling. The package
enables the persistent compilation cache (`compilation_cache_dir()`) so
compiles persist across processes; this warm pass additionally fills the
IN-PROCESS jit caches (the jitted programs are module-level, so a System
constructed afterwards reuses them directly).

Opt-in at construction: `System(..., prewarm=True)`, or run
`python tools/warm_cache.py` once per deployment target."""

from __future__ import annotations

import os
import time

import numpy as np

_WARMING = False


def warm(n_frames: int = 72, n_features: int = 1000, verbose: bool = True):
    """Drive a short keyframe-heavy synthetic orbit through BOTH mapping
    modes — async surfaces mapper-program variants sync never hits (a
    backlogged queue runs triangulation with do_fuse=False) — and both
    the sequential and deep-pipelined tracking paths."""
    global _WARMING
    if _WARMING:
        return
    _WARMING = True
    try:
        from orb_slam_system_tpu import compilation_cache_dir
        from orb_slam_system_tpu.config import (
            CameraConfig, ORBConfig, Sensor, SlamConfig)
        from orb_slam_system_tpu.dataio.synthetic import (
            PlanarSceneRenderer, make_texture, orbit_trajectory)
        from orb_slam_system_tpu.models.system import System

        W, H = 640, 480
        cam = CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2,
                           fps=30.0, width=W, height=H)
        cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=n_features),
                         sensor=Sensor.MONOCULAR)
        r = PlanarSceneRenderer(cam.K, W, H,
                                texture=make_texture(2048, 8, 7),
                                tex_scale=440.0)
        poses = orbit_trajectory(n_frames, radius=0.35, depth=-2.0,
                                 tilt=0.3)
        frames = [np.clip(r.render(T), 0, 255).astype(np.uint8)
                  for T in poses]

        for mode, use_async, use_pipe in (
                ("sequential+sync", False, False),
                ("pipelined+async", True, True)):
            t0 = time.perf_counter()
            slam = System(None, cfg, Sensor.MONOCULAR,
                          async_mapping=use_async)
            if use_pipe:
                for _ in slam.track_monocular_pipelined(
                        (f, i / 30.0) for i, f in enumerate(frames)):
                    pass
            else:
                for i, f in enumerate(frames):
                    slam.track_monocular(f, i / 30.0)
            slam.shutdown()
            if verbose:
                print(f"# warmed {mode}: {n_frames} frames in "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
        cache_dir = compilation_cache_dir()
        if verbose and os.path.isdir(cache_dir):
            n = sum(len(fs) for _, _, fs in os.walk(cache_dir))
            print(f"# compilation cache: {n} entries in {cache_dir}",
                  flush=True)
    finally:
        _WARMING = False
