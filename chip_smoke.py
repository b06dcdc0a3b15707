"""Smoke test of the SLAM main path on one GPU.

Drives the system through the entry points a user calls, at the TUM
monocular deployment the repo targets (640x480, 1000 features, 8 levels,
scale 1.2), and checks the results against the CPU backend and the
synthetic ground truth:

  device  the default JAX backend is the GPU (exit 2 otherwise); prints the
          card's name and power limit and the JAX version
  parity  the same jitted functions on the GPU and on the CPU device:
          extraction, Hamming distances, pose optimization, local BA
  mono    72-frame orbit through System(async_mapping=True), once with
          track_monocular and once with track_monocular_pipelined
  loop    examples/loop_synthetic.py's 170-frame loop: closure + ATE
  stereo  examples/stereo_synthetic.py and the RGB-D run: metric scale

One process, one card. Any failed phase makes the script exit 1 without
the ok line. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

With --tf32-control the script runs only the parity phase, twice: at the
package's precision, and with XLA's TF32 default for f32 matmuls in place
of the package's HIGHEST. It is a control that the parity tolerances can
see the precision fault the package guards against: it exits 0 when the
first pass holds and at least one check of the second fails, 1
otherwise, and never prints the ok line.

Usage: python chip_smoke.py [--tf32-control]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the parity phase, each with the precision it assumes. The
# readings quoted are GPU vs CPU on an H100 80GB HBM3 (700 W limit), at the
# package's HIGHEST and, as a control (--tf32-control), at TF32.
# Extraction: f32 pyramid/FAST/blur (HIGHEST matmuls, stated in the ops, so
# TF32 does not reach them) on both backends. Both read 1.0 exactly; a score
# tied within rounding could flip a keypoint, and a patch value on a bf16
# rounding boundary or an angle on a bin boundary could flip descriptor bits.
KP_SET_MIN = 0.995       # share of keypoints (x, y at 0.01 px) in both sets
OCTAVE_EQ_MIN = 0.999    # share of position-matched keypoints, same octave
DESC_BITS_MIN = 0.995    # share of equal descriptor bits over those
# Pose optimization: f32 LM from the same start, deterministic on both
# backends. HIGHEST reads 4.2e-8 rad / 3.7e-7 m, TF32 1.0e-5 rad / 5.6e-4 m:
# this is the check that catches a lost precision setting.
POSE_ROT_MAX = 1e-6      # radians between GPU and CPU rotations
POSE_TRANS_MAX = 1e-5    # metres between GPU and CPU translations
# Local BA: f32 Schur LM; GPU segment sums are atomics (unordered), and that
# order noise (camera difference 1.9e-4 m at HIGHEST, 2.3e-4 m at TF32)
# hides the precision, so these bound the solve, not the precision.
BA_RMS_DIFF_MAX = 1e-4   # pixels between GPU and CPU reprojection RMS
BA_RMS_MAX = 1.0         # pixels (0.5 px observation noise)
BA_CAM_DIFF_MAX = 1e-3   # metres between GPU and CPU camera translations
# System gates (the CPU gates of tests/test_e2e_*.py and the examples).
MONO_TRACKED_MIN = 0.9
MONO_ATE_MAX = 0.03      # metres, Sim3-aligned
LOOP_TRACKED_MIN = 160
# Loop ATE in metres: the CPU reaches 2.35 cm on this scene (deterministic);
# on the GPU atomic segment sums make runs differ (2.07 and 2.52 cm in two
# runs on an H100 80GB HBM3, 700 W limit). Without the closure it is ~22 cm.
LOOP_ATE_MAX = 0.03
STEREO_SCALE_TOL = 0.15
RGBD_SCALE_TOL = 0.10
RGBD_ATE_MAX = 0.05

W, H, N_FEATURES = 640, 480, 1000


def card_info() -> str:
    """`name, power.limit` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _on(dev, fn, *args):
    """Run jitted `fn` with its array inputs committed to `dev`; returns
    the outputs as numpy arrays."""
    import jax
    args = jax.device_put(args, dev)
    return jax.tree.map(np.asarray, fn(*args))


def extraction_parity(extractor, imgs, dev_a, dev_b) -> dict:
    """Run one extraction program on two devices and compare: the share of
    keypoints found by both (position at 0.01 px), the share of those with
    the same octave, and the share of equal descriptor bits over keypoints
    equal in position and octave."""
    import jax
    fn = jax.jit(extractor._extract)
    fa = _on(dev_a, fn, imgs)
    fb = _on(dev_b, fn, imgs)
    n_a = n_b = n_pos = n_oct = 0
    bits_eq = bits_all = 0
    for b in range(imgs.shape[0]):
        def index(f):
            v = np.nonzero(f.valid[b])[0]
            key = np.round(f.xy[b, v] * 100).astype(np.int64)
            return {(int(x), int(y)): i for (x, y), i in zip(key, v)}
        ia, ib = index(fa), index(fb)
        n_a += len(ia)
        n_b += len(ib)
        for k, i in ia.items():
            j = ib.get(k)
            if j is None:
                continue
            n_pos += 1
            if fa.octave[b, i] != fb.octave[b, j]:
                continue
            n_oct += 1
            x = np.bitwise_xor(fa.desc[b, i], fb.desc[b, j])
            bits_eq += 256 - int(np.unpackbits(x.view(np.uint8)).sum())
            bits_all += 256
    return {"kp_set": n_pos / max(n_a, n_b, 1),
            "octave_eq": n_oct / max(n_pos, 1),
            "desc_bits": bits_eq / max(bits_all, 1),
            "n_kp": (n_a, n_b)}


def hamming_parity(desc_a, desc_b, dev_a, dev_b) -> bool:
    """distance_matrix on two devices: exactly equal (int8 x int8 -> i32)."""
    import jax
    from orb_slam_system_tpu.ops.hamming import distance_matrix
    fn = jax.jit(distance_matrix)
    return bool(np.array_equal(_on(dev_a, fn, desc_a, desc_b),
                               _on(dev_b, fn, desc_a, desc_b)))


def make_pose_problem(rng, n=1024, noise_px=0.5):
    """Points in front of a known camera, their noisy projections and a
    perturbed start pose: (Tcw0, X, uv, inv_sigma2, mask, fx, fy, cx, cy)."""
    from orb_slam_system_tpu.utils import lie
    import jax.numpy as jnp
    fx = fy = 520.0
    cx, cy = W / 2.0, H / 2.0
    X = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 8, size=n)
    T = np.asarray(lie.se3_exp(jnp.asarray(
        np.array([0.05, -0.02, 0.1, 0.01, 0.02, -0.01], np.float32))))
    Xc = X @ T[:3, :3].T + T[:3, 3]
    uv = Xc[:, :2] / Xc[:, 2:3] * [fx, fy] + [cx, cy]
    uv = (uv + rng.normal(size=uv.shape) * noise_px).astype(np.float32)
    T0 = np.asarray(lie.se3_exp(jnp.asarray(
        (rng.normal(size=6) * 0.01).astype(np.float32)))) @ T
    return (T0.astype(np.float32), X, uv, np.ones(n, np.float32),
            np.ones(n, bool), fx, fy, cx, cy)


def pose_parity(problem, dev_a, dev_b) -> dict:
    """pose_optimization on two devices: rotation angle (rad; the
    Frobenius distance / sqrt(2), exact to first order and free of
    arccos's loss near 0) and translation (m) between the two results."""
    import jax
    from orb_slam_system_tpu.solvers.pose_opt import pose_optimization
    fn = jax.jit(pose_optimization)
    Ta = _on(dev_a, fn, *problem)[0].astype(np.float64)
    Tb = _on(dev_b, fn, *problem)[0].astype(np.float64)
    ang = float(np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / np.sqrt(2.0))
    return {"rot": ang, "trans": float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]))}


def make_ba_problem(rng, C=16, P=2048, E=8192, noise_px=0.5):
    """A local-BA window at the mapper's largest bucket: C cameras along a
    short baseline (the first two fixed), P points, E observations."""
    import jax.numpy as jnp
    from orb_slam_system_tpu.solvers.local_ba import BAProblem
    from orb_slam_system_tpu.utils import lie
    X = rng.uniform(-3, 3, size=(P, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(4, 9, size=P)
    Tcw = np.stack([np.asarray(lie.se3_exp(jnp.asarray(
        np.array([0.05 * c, 0, 0, 0, 0.005 * c, 0], np.float32))))
        for c in range(C)])
    e_cam = rng.integers(0, C, size=E).astype(np.int32)
    e_pt = (np.arange(E) % P).astype(np.int32)
    Xc = (np.einsum("eij,ej->ei", Tcw[e_cam, :3, :3], X[e_pt])
          + Tcw[e_cam, :3, 3])
    uv = Xc[:, :2] / Xc[:, 2:3] * 520.0 + np.array([W / 2.0, H / 2.0])
    uv += rng.normal(size=uv.shape) * noise_px
    T0 = Tcw.copy()
    for c in range(2, C):
        T0[c] = np.asarray(lie.se3_exp(jnp.asarray(
            (rng.normal(size=6) * 0.01).astype(np.float32)))) @ Tcw[c]
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    return BAProblem(
        Tcw=T0.astype(np.float32), cam_fixed=fixed,
        cam_valid=np.ones(C, bool),
        points=X + rng.normal(size=X.shape).astype(np.float32) * 0.03,
        pt_valid=np.ones(P, bool), e_cam=e_cam, e_pt=e_pt,
        e_uv=uv.astype(np.float32), e_inv_sigma2=np.ones(E, np.float32),
        e_valid=np.ones(E, bool), e_ur=np.full(E, -1.0, np.float32), bf=0.0)


def _reproj_rms(prob, Tcw, X, inlier) -> float:
    R, t = Tcw[prob.e_cam, :3, :3], Tcw[prob.e_cam, :3, 3]
    Xc = np.einsum("eij,ej->ei", R, X[prob.e_pt]) + t
    uv = Xc[:, :2] / Xc[:, 2:3] * 520.0 + np.array([W / 2.0, H / 2.0])
    r = np.sum((uv - prob.e_uv) ** 2, axis=1)[inlier]
    return float(np.sqrt(r.mean())) if r.size else float("inf")


def ba_parity(prob, dev_a, dev_b) -> dict:
    """local_bundle_adjustment on two devices: reprojection RMS (px) of
    each result over its inliers, and the largest difference between the
    two results in a camera translation (m) and a point (m)."""
    import jax
    from orb_slam_system_tpu.solvers.local_ba import local_bundle_adjustment
    fn = jax.jit(lambda p: local_bundle_adjustment(p, 520.0, 520.0,
                                                   W / 2.0, H / 2.0))
    out, res = {}, {}
    for name, dev in (("a", dev_a), ("b", dev_b)):
        Tcw, X, inl = res[name] = _on(dev, fn, prob)
        out[name] = _reproj_rms(prob, Tcw, X, inl)
        out[f"inliers_{name}"] = int(inl.sum())
    (Ta, Xa, _), (Tb, Xb, _) = res["a"], res["b"]
    out["cam_diff"] = float(np.abs(Ta[:, :3, 3] - Tb[:, :3, 3]).max())
    out["pt_diff"] = float(np.abs(Xa - Xb).max())
    return out


def _mono_config():
    from orb_slam_system_tpu.config import (
        CameraConfig, ORBConfig, Sensor, SlamConfig)
    cam = CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H)
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=N_FEATURES),
                      sensor=Sensor.MONOCULAR)


def _orbit_frames(cfg, n_frames):
    from orb_slam_system_tpu.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    r = PlanarSceneRenderer(cfg.camera.K, W, H,
                            texture=make_texture(2048, 8, 7),
                            tex_scale=440.0)
    poses = orbit_trajectory(n_frames, radius=0.35, depth=-2.0, tilt=0.3)
    frames = [np.clip(r.render(T), 0, 255).astype(np.uint8) for T in poses]
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}
    return frames, gt


def run_mono(mode: str, frames, gt) -> dict:
    """One System(async_mapping=True) over the frames; fps counts the
    frames after the first third (compilation lands in the first)."""
    from orb_slam_system_tpu.config import Sensor
    from orb_slam_system_tpu.dataio import trajectory as traj_io
    from orb_slam_system_tpu.models.system import System
    slam = System(None, _mono_config(), Sensor.MONOCULAR, async_mapping=True)
    stamps = []
    src = ((f, i / 30.0) for i, f in enumerate(frames))
    if mode == "track_monocular":
        for f, ts in src:
            slam.track_monocular(f, ts)
            stamps.append(time.perf_counter())
    else:
        for _ in slam.track_monocular_pipelined(src):
            stamps.append(time.perf_counter())
    slam.shutdown()
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    k = len(stamps) // 3
    hist = slam.tracker.stage_ms.history
    stages = sorted(((n, float(np.mean(v))) for n, v in hist.items() if v),
                    key=lambda kv: -kv[1])[:5]
    return {"tracked": sum(1 for _, _, lost in est if not lost),
            "ate": traj_io.ate_rmse(est, gt),
            "fps": (len(stamps) - 1 - k) / (stamps[-1] - stamps[k]),
            "kfs": slam.arena.n_keyframes(), "stages_ms": stages}


def run_rgbd(n_frames=20) -> dict:
    """The RGB-D run of tests/test_e2e_rgbd.py: 320x240, 500 features."""
    from orb_slam_system_tpu.config import (
        CameraConfig, ORBConfig, Sensor, SlamConfig)
    from orb_slam_system_tpu.dataio import trajectory as traj_io
    from orb_slam_system_tpu.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu.models.system import System
    w, h = 320, 240
    cam = CameraConfig(fx=260.0, fy=260.0, cx=w / 2, cy=h / 2, fps=30.0,
                       width=w, height=h, bf=260.0 * 0.08)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=500),
                     sensor=Sensor.RGBD, th_depth=40.0,
                     depth_map_factor=5000.0)
    r = PlanarSceneRenderer(cam.K, w, h, texture=make_texture(2048, 8, 7),
                            tex_scale=220.0)
    poses = orbit_trajectory(n_frames, radius=0.35, depth=-2.0, tilt=0.3)
    slam = System(None, cfg, Sensor.RGBD)
    gt = {}
    for i, T in enumerate(poses):
        slam.track_rgbd(r.render(T), r.render_depth(T) * 5000.0, i / 30.0)
        gt[i / 30.0] = (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
    slam.shutdown()
    est = traj_io.frame_poses(slam.arena, slam.tracker.trajectory)
    pos = [(-T[:3, :3].T @ T[:3, 3]) for _, T, lost in est if not lost]
    ts = sorted(gt)
    span_gt = np.linalg.norm(gt[ts[-1]] - gt[ts[0]])
    return {"tracked": len(pos), "n": n_frames,
            "ate": traj_io.ate_rmse(est, gt),
            "scale_err": abs(np.linalg.norm(pos[-1] - pos[0]) - span_gt)
            / span_gt}


class _Phases:
    """Runs named phases in order; a phase fails by raising or by a false
    check, and the run goes on so one call reports every phase."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(self)
        except Exception as e:  # noqa: BLE001 — reported, fails the run
            import traceback
            traceback.print_exc()
            self.failed.append(f"{name}: {type(e).__name__}: {e}")
        print(f"== phase {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)

    def check(self, what, ok, detail):
        print(f"   [{'pass' if ok else 'FAIL'}] {what}: {detail}", flush=True)
        if not ok:
            self.failed.append(what)


def main(argv) -> int:
    control = "--tf32-control" in argv
    import jax
    print("== phase device", flush=True)
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's default backend is {jax.default_backend()}",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "orb_slam_system_tpu")):
        print("the orb_slam_system_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    card = card_info()
    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    print(f"   card: {card} | jax {jax.__version__} | {dev.device_kind}",
          flush=True)
    ph = _Phases()

    def parity(ph, prec="f32 HIGHEST"):
        from orb_slam_system_tpu.config import ORBConfig
        from orb_slam_system_tpu.ops.extractor import ORBExtractor
        rng = np.random.default_rng(0)
        frames, _ = _orbit_frames(_mono_config(), 4)
        imgs = np.stack(frames[:2]).astype(np.float32)
        ext = ORBExtractor(ORBConfig(n_features=N_FEATURES), H, W)
        ex = extraction_parity(ext, imgs, dev, cpu)
        ph.check("extraction keypoint set (f32 HIGHEST)",
                 ex["kp_set"] >= KP_SET_MIN,
                 f"{ex['kp_set']:.4f} >= {KP_SET_MIN}, n={ex['n_kp']}")
        ph.check("extraction octave equality (f32 HIGHEST)",
                 ex["octave_eq"] >= OCTAVE_EQ_MIN,
                 f"{ex['octave_eq']:.4f} >= {OCTAVE_EQ_MIN}")
        ph.check("descriptor bits (bf16 operands, f32 accumulation)",
                 ex["desc_bits"] >= DESC_BITS_MIN,
                 f"{ex['desc_bits']:.4f} >= {DESC_BITS_MIN}")
        da = rng.integers(0, 2 ** 32, size=(1024, 8), dtype=np.uint32)
        db = rng.integers(0, 2 ** 32, size=(1024, 8), dtype=np.uint32)
        ph.check("hamming distance_matrix (int8, exact)",
                 hamming_parity(da, db, dev, cpu), "equal")
        po = pose_parity(make_pose_problem(rng), dev, cpu)
        ph.check(f"pose_optimization ({prec})",
                 po["rot"] <= POSE_ROT_MAX and po["trans"] <= POSE_TRANS_MAX,
                 f"rot {po['rot']:.2e} <= {POSE_ROT_MAX} rad, "
                 f"trans {po['trans']:.2e} <= {POSE_TRANS_MAX} m")
        ba = ba_parity(make_ba_problem(rng), dev, cpu)
        ph.check(f"local BA window C=16 P=2048 E=8192 ({prec}, atomics)",
                 abs(ba["a"] - ba["b"]) <= BA_RMS_DIFF_MAX
                 and max(ba["a"], ba["b"]) <= BA_RMS_MAX
                 and ba["cam_diff"] <= BA_CAM_DIFF_MAX,
                 f"rms gpu {ba['a']:.6f} px cpu {ba['b']:.6f} px "
                 f"(|diff| <= {BA_RMS_DIFF_MAX}, each <= {BA_RMS_MAX}), "
                 f"camera diff {ba['cam_diff']:.2e} <= {BA_CAM_DIFF_MAX} m, "
                 f"point diff {ba['pt_diff']:.2e} m, "
                 f"inliers {ba['inliers_a']}/{ba['inliers_b']}")

    def mono(ph):
        n = 72
        frames, gt = _orbit_frames(_mono_config(), n)
        for mode in ("track_monocular", "track_monocular_pipelined"):
            t0 = time.perf_counter()
            r = run_mono(mode, frames, gt)
            ph.check(f"mono {mode} tracked", r["tracked"] >= MONO_TRACKED_MIN * n,
                     f"{r['tracked']}/{n}")
            ph.check(f"mono {mode} ATE", r["ate"] < MONO_ATE_MAX,
                     f"{r['ate'] * 100:.2f} cm < {MONO_ATE_MAX * 100:.0f} cm")
            print(f"   {mode}: {r['fps']:.2f} fps after warm-up, "
                  f"{r['kfs']} keyframes, wall {time.perf_counter() - t0:.1f} s"
                  f" | top stage means (ms) "
                  f"{[(k, round(v, 2)) for k, v in r['stages_ms']]} | {card}",
                  flush=True)

    def loop(ph):
        from examples.loop_synthetic import run
        slam, rmse, n_tracked = run(170, verbose=False)
        ph.check("loop closed", slam.loop_closer.n_loops_closed >= 1,
                 f"{slam.loop_closer.n_loops_closed} loop(s)")
        ph.check("loop tracked", n_tracked >= LOOP_TRACKED_MIN,
                 f"{n_tracked}/170 >= {LOOP_TRACKED_MIN}")
        ph.check("loop ATE", rmse < LOOP_ATE_MAX,
                 f"{rmse * 100:.2f} cm < {LOOP_ATE_MAX * 100:.0f} cm")
        print(f"   last GBA (cameras, points, edges): "
              f"{slam.loop_closer.gba.last_shape}", flush=True)

    def stereo_rgbd(ph):
        from examples.stereo_synthetic import run
        with tempfile.TemporaryDirectory() as out:
            _, rmse, s_est, s_gt = run(n_frames=18, out_dir=out,
                                       verbose=False)
        err = abs(s_est - s_gt) / s_gt
        ph.check("stereo metric scale", err < STEREO_SCALE_TOL,
                 f"|est/gt - 1| {err:.3f} < {STEREO_SCALE_TOL}, "
                 f"ATE {rmse * 100:.2f} cm")
        r = run_rgbd()
        ph.check("rgbd tracked", r["tracked"] >= r["n"] - 2,
                 f"{r['tracked']}/{r['n']}")
        ph.check("rgbd metric scale", r["scale_err"] < RGBD_SCALE_TOL,
                 f"{r['scale_err']:.3f} < {RGBD_SCALE_TOL}")
        ph.check("rgbd ATE", r["ate"] < RGBD_ATE_MAX,
                 f"{r['ate'] * 100:.2f} cm < {RGBD_ATE_MAX * 100:.0f} cm")

    if control:
        ph.run("parity", parity)
        sound = not ph.failed
        ph.failed = []
        with jax.default_matmul_precision("tensorfloat32"):
            ph.run("parity at TF32 (control)",
                   lambda ph: parity(ph, "f32 TF32"))
        print(f"control: parity {'passes' if sound else 'FAILS'} at the "
              f"package precision, {len(ph.failed)} check(s) fail at TF32",
              flush=True)
        return 0 if sound and ph.failed else 1
    ph.run("parity", parity)
    ph.run("mono", mono)
    ph.run("loop", loop)
    ph.run("stereo_rgbd", stereo_rgbd)
    if ph.failed:
        print("FAILED: " + "; ".join(ph.failed), file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
