"""Multi-chip batched multi-sequence SLAM front-end.

The reference is a single-process, shared-memory system (SURVEY.md §2.4);
multi-chip scale-out is this framework's extension axis (BASELINE.json
config 5: batched EuRoC MH01-05 mapping). The parallelization:

  * **dp over sequences** ('data' mesh axis): each device tracks a shard of
    independent sequences — extraction, matching, pose LM all batched.
  * **sp over keypoint slots** ('model' mesh axis): the Hamming distance
    matrix of the matching step is sharded over query keypoints, each
    device computing its row block (popcount-as-matmul).
  * XLA collectives: per-step global statistics (inlier counts,
    matched features) are psum'd over the whole mesh; nothing is
    host-gathered mid-step.

`make_multiseq_step` builds the jitted sharded step; `dryrun` runs one step
on tiny shapes — used by __graft_entry__.dryrun_multichip to validate the
sharding on a virtual device mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orb_slam_system_tpu.config import ORBConfig
from orb_slam_system_tpu.ops.extractor import ORBExtractor
from orb_slam_system_tpu.ops.hamming import (
    distance_matrix_from_pm1, to_pm1_int8)
from orb_slam_system_tpu.solvers.pose_opt import pose_optimization


def make_mesh(n_devices: int, model_parallel: int = 2) -> Mesh:
    """2D mesh: ('data', 'model'). data shards sequences, model shards the
    keypoint axis of the matching step."""
    mp = model_parallel if n_devices % model_parallel == 0 else 1
    dp = n_devices // mp
    devices = np.asarray(jax.devices()[:n_devices]).reshape(dp, mp)
    return Mesh(devices, ("data", "model"))


def make_multiseq_step(mesh: Mesh, height: int, width: int,
                       n_features: int = 256, n_levels: int = 4):
    """Returns (step_fn, example_args). step_fn is jitted over the mesh:

    (imgs f32[S,H,W], prev_desc u32[S,N,8],
     prev_valid bool[S,N], pts f32[S,N,3], Tcw0 f32[S,4,4])
      -> (Tcw f32[S,4,4], n_inliers i32, n_matched i32)

    The front half (extract+match) runs under shard_map with dp/sp
    shardings; the pose LM is vmapped per-sequence under dp.
    """
    cfg = ORBConfig(n_features=n_features, n_levels=n_levels)
    extractor = ORBExtractor(cfg, height, width)
    N = extractor.n_slots
    S_model = mesh.shape["model"]
    # The model axis slices query slots with dynamic_slice: a remainder
    # would be covered by NO shard and its matches/edges would vanish
    # silently.
    assert N % S_model == 0, (
        f"n_slots {N} not divisible by model axis {S_model}")
    fx = fy = 0.8 * width
    cx, cy = width / 2.0, height / 2.0

    def local_step(imgs, prev_desc, prev_valid, pts, Tcw0):
        # ---- per-device shard of sequences (dp) --------------------------
        feats = extractor._extract(imgs)              # pure fn, traced here
        # ---- matching, sharded over query keypoint slots (sp) ------------
        # Block-local query rows vs full reference set; model-axis shards
        # each take N / S_model query slots.
        q = to_pm1_int8(feats.desc)                   # [s, Nq_local? no: N]
        r = to_pm1_int8(prev_desc)
        # Shard query rows over 'model' by dynamic slice on axis index.
        m_idx = jax.lax.axis_index("model")
        nq = N // S_model
        q_loc = jax.lax.dynamic_slice_in_dim(q, m_idx * nq, nq, axis=1)
        dist = jax.vmap(distance_matrix_from_pm1)(q_loc, r)  # [s, nq, N]
        v_loc = jax.lax.dynamic_slice_in_dim(feats.valid, m_idx * nq, nq, axis=1)
        mask = v_loc[:, :, None] & prev_valid[:, None, :]
        dist = jnp.where(mask, dist, 1 << 20)
        best = jnp.min(dist, axis=2)
        best_j = jnp.argmin(dist, axis=2)
        matched = best <= 50
        n_matched_loc = jnp.sum(matched.astype(jnp.int32))
        # ---- per-sequence pose refinement (dp over sequences, edges
        # sharded over 'model') -------------------------------------------
        # Each model shard owns nq keypoint rows; the 6x6 normal equations
        # (J^T W J, J^T W e) and LM costs are psum'd over 'model' inside
        # pose_optimization, so every shard performs the IDENTICAL global
        # solve — one pose per sequence, bit-exact across shards (an
        # element-wise mean of SE3 matrices is not a rotation; reducing the
        # normal equations is the sound formulation).
        obs_xy = jax.lax.dynamic_slice_in_dim(feats.xy, m_idx * nq, nq, axis=1)
        pt_loc = jnp.take_along_axis(pts, best_j[..., None], axis=1)
        T_opt, inl, n_in = jax.vmap(
            lambda T0, X, uv, ok: pose_optimization(
                T0, X, uv, jnp.ones(uv.shape[0], jnp.float32), ok,
                fx, fy, cx, cy, axis_name="model")
        )(Tcw0, pt_loc, obs_xy, matched)
        # ---- global statistics over the whole mesh (collectives) ---------
        # n_in is shard-local (each shard's inlier rows); sum over 'model'
        # for the per-sequence total, then over 'data' for the global one.
        n_in_tot = jax.lax.psum(jnp.sum(n_in), axis_name="model")
        n_in_tot = jax.lax.psum(n_in_tot, axis_name="data")
        n_match_tot = jax.lax.psum(n_matched_loc, axis_name="data")
        n_match_tot = jax.lax.psum(n_match_tot, axis_name="model")
        return T_opt, n_in_tot, n_match_tot

    smapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P(), P()),
        check_vma=False,
    )
    step = jax.jit(smapped)

    S = mesh.shape["data"] * 2   # 2 sequences per data shard
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, size=(S, height, width)).astype(np.float32)
    prev_desc = rng.integers(0, 2 ** 32, size=(S, N, 8), dtype=np.uint32)
    prev_valid = np.ones((S, N), bool)
    pts = rng.uniform(-2, 2, size=(S, N, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(3, 8, size=(S, N))
    Tcw0 = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    sharding = NamedSharding(mesh, P("data"))
    args = tuple(
        jax.device_put(a, sharding)
        for a in (imgs, prev_desc, prev_valid, pts, Tcw0))
    return step, args


def dryrun(n_devices: int, height: int = 96, width: int = 128):
    """One multi-chip step on tiny shapes; raises on sharding errors.

    Exercises all three sharded programs: the dp/sp tracking front-end
    step, the edge-sharded Sim3 pose-graph solve, and the edge-sharded
    Schur-CG global bundle adjustment (the framework's scale-out axes)."""
    mesh = make_mesh(n_devices)
    step, args = make_multiseq_step(mesh, height, width,
                                    n_features=128, n_levels=2)
    T, n_in, n_match = step(*args)
    jax.block_until_ready((T, n_in, n_match))
    assert np.isfinite(np.asarray(T)).all()
    # Pose-graph solve sharded over a 1-D 'graph' mesh.
    from orb_slam_system_tpu.parallel.pose_graph_dist import (
        optimize_essential_graph_sharded)
    gmesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("graph",))
    K = 6
    rng = np.random.default_rng(0)
    R0 = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t0 = rng.normal(size=(K, 3)).astype(np.float32) * 0.1
    s0 = np.ones(K, np.float32)
    e_i = np.arange(K - 1, dtype=np.int32)
    e_j = e_i + 1
    e_R = np.tile(np.eye(3, dtype=np.float32), (K - 1, 1, 1))
    e_t = np.zeros((K - 1, 3), np.float32)
    e_s = np.ones(K - 1, np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    Rn, tn, sn = optimize_essential_graph_sharded(
        gmesh, R0, t0, s0, fixed, np.ones(K, bool),
        e_i, e_j, e_R, e_t, e_s, np.ones(K - 1, bool),
        n_iters=3, cg_iters=10)
    assert np.isfinite(np.asarray(tn)).all()
    # Edge-sharded global bundle adjustment (the third scale-out axis).
    from orb_slam_system_tpu.parallel.ba_dist import bundle_adjust_cg_sharded
    from orb_slam_system_tpu.solvers.local_ba import BAProblem

    C, P_pts = 4, 24
    world = rng.uniform(-1, 1, size=(P_pts, 3)).astype(np.float32)
    world[:, 2] += 4.0
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    for c in range(C):
        Tcw[c, 0, 3] = -0.1 * c
    e_cam, e_pt, e_uv = [], [], []
    fx = fy = 100.0
    for c in range(C):
        Xc = world @ Tcw[c, :3, :3].T + Tcw[c, :3, 3]
        uv = Xc[:, :2] / Xc[:, 2:3] * fx + 64.0
        for p in range(P_pts):
            e_cam.append(c); e_pt.append(p); e_uv.append(uv[p])
    prob = BAProblem(
        Tcw=jnp.asarray(Tcw),
        cam_fixed=jnp.asarray(np.arange(C) == 0),
        cam_valid=jnp.asarray(np.ones(C, bool)),
        points=jnp.asarray(world + 0.01),
        pt_valid=jnp.asarray(np.ones(P_pts, bool)),
        e_cam=jnp.asarray(np.asarray(e_cam, np.int32)),
        e_pt=jnp.asarray(np.asarray(e_pt, np.int32)),
        e_uv=jnp.asarray(np.asarray(e_uv, np.float32)),
        e_inv_sigma2=jnp.asarray(np.ones(len(e_cam), np.float32)),
        e_valid=jnp.asarray(np.ones(len(e_cam), bool)))
    Tn, Xn = bundle_adjust_cg_sharded(gmesh, prob, fx, fy, 64.0, 64.0,
                                      n_iters=2, cg_iters=8)
    assert np.isfinite(np.asarray(Xn)).all()
    # Full-system batched multi-sequence mode (BASELINE config 5): two
    # COMPLETE SLAM systems sharing one batched extraction program run a
    # short synthetic sequence each — validates that the batched front end
    # and the full pipeline compose on this device topology.
    from orb_slam_system_tpu.config import (
        CameraConfig, ORBConfig, Sensor, SlamConfig, TrackingState)
    from orb_slam_system_tpu.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu.parallel.multi_system import MultiSystem

    W2, H2 = 320, 240
    cam = CameraConfig(fx=260.0, fy=260.0, cx=W2 / 2, cy=H2 / 2, fps=30.0,
                       width=W2, height=H2)
    cfg2 = SlamConfig(camera=cam, orb=ORBConfig(n_features=400),
                      sensor=Sensor.MONOCULAR)
    rends = [PlanarSceneRenderer(cam.K, W2, H2,
                                 texture=make_texture(1024, 8, seed=7 + s),
                                 tex_scale=220.0) for s in range(2)]
    trajs = [orbit_trajectory(10, radius=0.3 + 0.02 * s, depth=-2.0,
                              tilt=0.3) for s in range(2)]
    msys = MultiSystem(cfg2, 2)
    for i in range(10):
        imgs = np.stack([rends[s].render(trajs[s][i]) for s in range(2)])
        msys.track_batch(imgs, i / 30.0)
    states = [s.get_tracking_state() for s in msys.systems]
    msys.shutdown()
    assert all(st == TrackingState.OK for st in states), states
    return int(n_in), int(n_match)
