"""Benchmark: ORB extraction + matching throughput on the accelerator.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Measures the SLAM front-end hot path (SURVEY.md §3.2: Frame construction is
the dominant per-frame cost in the reference) as a single fused device
program: 8-level pyramid + FAST + orientation + rBRIEF over a batch of
640x480 frames, then the 1024x1024 Hamming matmul match against the previous
frame. Throughput unit is extracted+matched keypoints per second.

Baseline: the reference's ORB front end is OpenCV CPU; at its configured
1000 features/frame it spends ~15 ms/frame on extraction+matching on a
desktop CPU (upstream ORB-SLAM2 reports 25-30 ms for the whole tracking
loop, BASELINE.md) => ~66,700 keypoints/sec. vs_baseline = value / 66700.
BASELINE.json's north star is >=10x this.
"""

import json
import os
import sys
import time

import numpy as np


def bench_system_fps(n_frames: int = 72, warmup: int = 24,
                     mode: str = "pipelined", admission: str = "drain"):
    """End-to-end tracking FPS (BASELINE.md primary metric): a real System
    tracking pre-rendered 640x480 synthetic frames at the reference's 1000
    features/frame. Frames are rendered up front so the loop measures the
    SLAM system, not the renderer. Returns (fps, n_timed) or None on error.

    The reference paces TUM sequences at 30 fps (Examples/Monocular/
    mono_tum.cc:97-105 + Camera.fps) — real-time operation is the bar.

    mode="pipelined" uses the deep-pipelined device-state tracking
    (results fetched asynchronously one frame late; RTT overlaps the next
    frame's device work); "stream" keeps one frame in flight with
    sequential-identical semantics. Both are gated on >=90% frames OK.
    """
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
    # u8 frames, like every real dataset: uploads 4x less than f32 over
    # PCIe (FrameBuilder casts on device).
    frames = [np.clip(r.render(T), 0, 255).astype(np.uint8) for T in poses]
    # async_mapping = the reference's own thread model (tracking + local
    # mapping on separate threads); device round trips overlap.
    slam = System(None, cfg, Sensor.MONOCULAR, async_mapping=True)
    if admission == "drop":
        # Drop-on-full admission: a demanded keyframe is dropped when the
        # mapper queue is full instead of draining the backlog. Faster on
        # a host whose mapper cannot keep pace, but collapses endurance
        # quality at new-territory transitions — reported as a LABELED
        # secondary number.
        slam.tracker.kf_async_wait_s = 0.0
        slam.tracker.kf_sync_flush_ratio = 0.0
    depth = int(os.environ.get("ORB_SLAM_BENCH_DEPTH", "2"))
    n_chain_warm = 8 if mode == "pipelined" else 0
    for i in range(warmup - n_chain_warm):
        slam.track_monocular(frames[i], i / 30.0)
    if n_chain_warm:
        # Warm the chain-step program too (first pipelined frame pays its
        # ~1.5 s jit compile otherwise — measured inside the timed window).
        warm = ((frames[i], i / 30.0)
                for i in range(warmup - n_chain_warm, warmup))
        for _ in slam.track_monocular_pipelined(warm, depth=depth):
            pass
    t0 = time.perf_counter()
    n_ok = 0
    src = ((frames[i], i / 30.0) for i in range(warmup, n_frames))
    it = (slam.track_monocular_pipelined(src, depth=depth)
          if mode == "pipelined" else slam.track_monocular_stream(src))
    for _ in it:
        if slam.tracker.state.name == "OK":
            n_ok += 1
    dt = time.perf_counter() - t0
    n_timed = n_frames - warmup
    # Throughput counts only if tracking held for (almost) every timed
    # frame — a lost tracker "tracks" arbitrarily fast.
    ok = n_ok >= 0.9 * n_timed and slam.tracker.state.name == "OK"
    # Diagnostics: chain outcome mix + slowest tracking stages (stderr
    # only; the JSON line stays single).
    st = dict(slam.tracker.chain_stats)
    hist = slam.tracker.stage_ms.history
    stages = sorted(((k, sum(v) / len(v)) for k, v in hist.items() if v),
                    key=lambda kv: -kv[1])[:5]
    print(f"# chain_stats={st} kfs={slam.arena.n_keyframes()} "
          f"top_stages_ms={[(k, round(v, 1)) for k, v in stages]}",
          file=sys.stderr)
    if not ok:
        print(f"# system bench rejected: ok_frames={n_ok}/{n_timed} "
              f"final={slam.tracker.state.name}", file=sys.stderr)
    slam.shutdown()
    return (n_timed / dt, n_timed) if ok else None


def bench_cv2_baseline(n_frames: int = 8, reps: int = 3):
    """MEASURE the OpenCV-CPU baseline on this machine instead of assuming
    the literature constant: cv2.ORB_create(1000) extraction (the exact
    workload of the reference's front end, src/ORBextractor.cc:442-495,
    which wraps OpenCV FAST/resize/blur) + BFMatcher(HAMMING) against the
    previous frame, over the same textured 640x480 synthetic frames the
    device path benches. Returns measured keypoints/sec or None if cv2 is
    unavailable."""
    try:
        import cv2
    except ImportError:
        return None
    from orb_slam_system_tpu.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)

    W, H = 640, 480
    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1]])
    r = PlanarSceneRenderer(K, W, H, texture=make_texture(2048, 8, 7),
                            tex_scale=440.0)
    poses = orbit_trajectory(n_frames, radius=0.35, depth=-2.0, tilt=0.3)
    frames = [np.clip(r.render(T), 0, 255).astype(np.uint8) for T in poses]
    orb = cv2.ORB_create(nfeatures=1000, scaleFactor=1.2, nlevels=8,
                         fastThreshold=20)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING)
    # Warmup pass (cv2 lazy-allocates pyramids etc.).
    prev = orb.detectAndCompute(frames[0], None)[1]
    best_dt, n_kp = float("inf"), 0
    for _ in range(reps):
        t0 = time.perf_counter()
        n_kp = 0
        pdesc = prev
        for img in frames:
            kp, desc = orb.detectAndCompute(img, None)
            n_kp += len(kp)
            if desc is not None and pdesc is not None:
                bf.match(desc, pdesc)
            pdesc = desc
        best_dt = min(best_dt, time.perf_counter() - t0)
    return n_kp / best_dt


def main():
    # Measure the cv2 baseline FIRST, before any device work: jax's async
    # dispatch threads contend for host cores with it.
    baseline = 66700.0
    measured_baseline = bench_cv2_baseline()
    if measured_baseline and measured_baseline > 0:
        baseline = measured_baseline
        print(f"# measured cv2 baseline: {measured_baseline:.0f} kp/s "
              f"(constant fallback 66700)", file=sys.stderr)

    import jax
    import jax.numpy as jnp

    from orb_slam_system_tpu.config import ORBConfig
    from orb_slam_system_tpu.ops.extractor import ORBExtractor
    from orb_slam_system_tpu.ops.hamming import distance_matrix

    H, W = 480, 640
    B = 8
    cfg = ORBConfig(n_features=1000)
    extractor = ORBExtractor(cfg, H, W)
    N = extractor.n_slots

    def frontend(imgs, prev_desc, prev_valid):
        feats = extractor._extract(imgs)
        def match_one(desc, valid, pdesc, pvalid):
            D = distance_matrix(desc, pdesc)
            D = jnp.where(valid[:, None] & pvalid[None, :], D, 1 << 20)
            best = jnp.min(D, axis=1)
            return jnp.argmin(D, axis=1), best <= 50
        idx, ok = jax.vmap(match_one)(feats.desc, feats.valid,
                                      prev_desc, prev_valid)
        # Keep results device-resident (the multi-sequence mapping pipeline
        # consumes them on device); return a checksum so timing can force
        # completion with a scalar fetch.
        checksum = (jnp.sum(feats.xy) + jnp.sum(idx)
                    + jnp.sum(ok.astype(jnp.int32))
                    + jnp.sum(feats.valid.astype(jnp.int32)))
        n_valid = jnp.sum(feats.valid.astype(jnp.int32))
        return checksum, n_valid

    step = jax.jit(frontend)

    # Textured frames generated on device (no host transfer in the loop).
    key = jax.random.PRNGKey(0)
    base = jax.random.uniform(key, (B, H // 8, W // 8)) * 255.0
    imgs = jnp.repeat(jnp.repeat(base, 8, axis=1), 8, axis=2)
    rng = np.random.default_rng(0)
    prev_desc = jnp.asarray(
        rng.integers(0, 2 ** 32, size=(B, N, 8), dtype=np.uint32))
    prev_valid = jnp.ones((B, N), bool)

    out = step(imgs, prev_desc, prev_valid)
    n_valid = float(np.asarray(out[1])) / B

    # Repeated timing loops with SPREAD reporting: the headline value is
    # the MEDIAN of the per-rep throughputs; min/max ride along in the
    # same JSON line.
    iters = 20
    rep_kps = []
    for _rep in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step(imgs, prev_desc, prev_valid)
        _ = float(np.asarray(out[0]))  # scalar fetch = real synchronization
        dt = time.perf_counter() - t0
        rep_kps.append(B * iters / dt * n_valid)
    # Outlier-rep rejection: reps beyond 2x the scaled MAD from the
    # median are dropped before aggregating, with the rejection counted in
    # the line.
    med = float(np.median(rep_kps))
    mad = 1.4826 * float(np.median(np.abs(np.asarray(rep_kps) - med)))
    tol = max(2.0 * mad, 0.10 * med)
    kept = [x for x in rep_kps if abs(x - med) <= tol]
    n_rejected = len(rep_kps) - len(kept)
    kps_per_sec = float(np.median(kept))
    frames_per_sec = kps_per_sec / max(n_valid, 1.0)
    rep_kps = kept

    # Baseline: MEASURED cv2.ORB+BFMatcher throughput on this host,
    # taken at main() entry (fallback: the ~15 ms/frame literature
    # constant, 66,700 kp/s).
    record = {
        "metric": "orb_extract_match_throughput",
        "value": round(kps_per_sec, 1),
        "unit": "keypoints/sec",
        "vs_baseline": round(kps_per_sec / baseline, 2),
        "baseline_kps": round(baseline, 0),
        # Multiple against the desktop-CPU literature constant too, so the
        # number stays comparable if this host's single core undersells the
        # reference's hardware.
        "vs_baseline_constant_66700": round(kps_per_sec / 66700.0, 2),
        "value_min": round(min(rep_kps), 1),
        "value_max": round(max(rep_kps), 1),
        "n_reps": len(rep_kps),
        "n_reps_rejected": n_rejected,
    }
    # Second metric: end-to-end tracking FPS (system throughput, not a
    # kernel benchmark) vs the 30 fps real-time dataset rate. Up to 4
    # pipelined attempts collect 3 valid reps for a median + min/max
    # spread; a run rejected for lost tracking doesn't count, and no valid
    # rep fails the bench.
    if os.environ.get("ORB_SLAM_BENCH_NO_SYSTEM") != "1":
        reps = []
        for attempt in range(4):
            if len(reps) >= 3:
                break
            sysres = bench_system_fps(mode="pipelined")
            if sysres is None:
                print(f"# pipelined attempt {attempt} rejected",
                      file=sys.stderr)
                continue
            reps.append(sysres)
        if not reps:
            print("# system bench failed: no tracked pipelined run",
                  file=sys.stderr)
            sys.exit(1)
        fps_all = sorted(r[0] for r in reps)
        fps, n_timed = fps_all[len(fps_all) // 2], reps[0][1]
        record["system_fps"] = round(fps, 1)
        record["system_vs_realtime_30fps"] = round(fps / 30.0, 2)
        record["system_mode"] = "pipelined"
        record["system_fps_min"] = round(fps_all[0], 1)
        record["system_fps_max"] = round(fps_all[-1], 1)
        record["system_n_reps"] = len(reps)
        record["system_admission"] = "drain_on_full"
        # Secondary LABELED number: drop-on-full admission (fast on a
        # mapper-bound host, known to collapse endurance quality),
        # reported beside the quality-holding headline so admission-policy
        # changes never masquerade as kernel regressions.
        for attempt in range(2):
            sysres = bench_system_fps(mode="pipelined", admission="drop")
            if sysres is not None:
                record["system_fps_drop_on_full"] = round(sysres[0], 1)
                break
            print(f"# drop-admission attempt {attempt} rejected",
                  file=sys.stderr)
        print(f"# system_fps median={fps:.1f} "
              f"[{fps_all[0]:.1f}, {fps_all[-1]:.1f}] over "
              f"{n_timed} frames x{len(reps)} (pipelined)", file=sys.stderr)
    dev = jax.devices()[0]
    record["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    print(json.dumps(record), flush=True)
    print(f"# frames/sec={frames_per_sec:.1f} avg_kp/frame={n_valid:.0f} "
          f"batch={B}", file=sys.stderr, flush=True)

if __name__ == "__main__":
    main()
