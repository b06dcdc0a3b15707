"""Frame: per-image feature container + device-side construction pipeline.

Replaces reference Frame (src/Frame.cc): ORB extraction, keypoint
undistortion (:384-414), image-bound computation, and the per-frame tracking
bookkeeping (map-point ids, outlier flags). The reference's 64x48 feature
grid (include/Frame.h:17-18) has no equivalent here: candidate gating happens
inside the dense masked matchers (ops/matching.py), which replace grid
bucketing.

Construction runs extraction + undistortion as jitted device programs and
then pulls ONE host copy of the padded arrays (a single device->host
transfer per frame).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam_system_tpu.config import SlamConfig
from orb_slam_system_tpu.mapping.arena import FrameFeatures
from orb_slam_system_tpu.ops.extractor import ORBExtractor
from orb_slam_system_tpu.utils import camera as cam_ops


@dataclasses.dataclass
class Frame:
    """One frame's padded feature state.

    `feats` is materialized LAZILY from `packed_dev` (the device-resident
    [N, 16|18] packed output of the fused extract program): fetching a
    buffer from the device costs a host-device round trip, and
    the steady-state tracking path never needs the host copy — the fused
    tracking programs consume `packed_dev` directly, and only keyframe
    creation / initialization materialize."""

    id: int
    timestamp: float
    feats_host: Optional[FrameFeatures] = None
    packed_dev: Optional[object] = None     # jax f32[N, 16|18]
    Tcw: Optional[np.ndarray] = None        # f32[4,4] world->camera
    mp_ids: Optional[np.ndarray] = None     # i64[N] map point per feature
    outlier: Optional[np.ndarray] = None    # bool[N]
    ref_kf_id: int = -1
    # Temporary visual-odometry points (localization mode, upstream
    # UpdateLastFrame: depth-backprojected points NOT in the map):
    # {feature slot -> world position f32[3]}.
    vo_points: Optional[dict] = None
    # (n_tracked_close, n_nontracked_close) computed on device by the
    # pipelined chain step (stereo/RGB-D keyframe decision, reference
    # Tracking.cc:590-600) — lets need_new_keyframe avoid fetching the
    # packed frame just for its depth column.
    chain_close_counts: Optional[tuple] = None
    # Pose relative to ref_kf_id at the time this frame was finalized
    # (upstream Tracking.cc:239 mlRelativeFramePoses entry). Used by
    # UpdateLastFrame's pose re-anchor (src/Tracking.cc:475-481): map
    # mutations between frames (local BA, loop correction, global BA)
    # move the reference keyframe, and the motion model must follow —
    # Tcw_last := Tcr_ref @ Tcw_ref(now).
    Tcr_ref: Optional[np.ndarray] = None

    def __post_init__(self):
        n = self.n_slots
        if self.mp_ids is None:
            self.mp_ids = np.full(n, -1, np.int64)
        if self.outlier is None:
            self.outlier = np.zeros(n, bool)

    @property
    def n_slots(self) -> int:
        if self.feats_host is not None:
            return self.feats_host.n_slots
        return int(self.packed_dev.shape[0])

    @property
    def feats(self) -> FrameFeatures:
        if self.feats_host is None:
            self.feats_host = FrameBuilder._unpack_feats(
                np.asarray(self.packed_dev))
        return self.feats_host

    @property
    def u_right(self):
        return self.feats.u_right

    @property
    def depth(self):
        return self.feats.depth

    @property
    def n_valid(self) -> int:
        return int(self.feats.valid.sum())

    def camera_center(self) -> np.ndarray:
        R = self.Tcw[:3, :3]
        return -R.T @ self.Tcw[:3, 3]


class FrameBuilder:
    """Shape-specialized frame construction: extraction + undistortion."""

    def __init__(self, cfg: SlamConfig, n_features: Optional[int] = None):
        self.cfg = cfg
        cam = cfg.camera
        orb = cfg.orb
        if n_features is not None:
            orb = dataclasses.replace(orb, n_features=n_features)
        self.extractor = ORBExtractor(orb, cam.height, cam.width)
        self.scale_factors = self.extractor.scales
        self.inv_sigma2 = self.extractor.inv_sigma2
        self.sigma2 = self.extractor.sigma2
        self._next_id = 0
        k = cam
        self._undistort = jax.jit(
            lambda uv: cam_ops.undistort_points(
                uv, k.fx, k.fy, k.cx, k.cy, k.k1, k.k2, k.p1, k.p2, k.k3))

        # Fused extract+undistort+pack: ONE device program whose single
        # packed f32 output is fetched in ONE transfer instead of the 7
        # per-array host syncs of the naive build.
        def _extract_packed(img):
            img = img.astype(jnp.float32)   # no-op for f32; on-device for u8
            fs = self.extractor._extract(img[None])
            und = cam_ops.undistort_points(
                fs.xy, k.fx, k.fy, k.cx, k.cy, k.k1, k.k2, k.p1, k.p2, k.k3)
            packed = jnp.concatenate([
                fs.xy[0], und[0],
                fs.response[0][:, None], fs.angle[0][:, None],
                fs.octave[0].astype(jnp.float32)[:, None],
                fs.valid[0].astype(jnp.float32)[:, None],
                jax.lax.bitcast_convert_type(fs.desc[0], jnp.float32),
            ], axis=1)                                     # [N, 16]
            return packed

        self._extract_packed = jax.jit(_extract_packed)

        def _extract_packed_batch(imgs):
            """[S,H,W] -> packed [S,N,16]: ONE device program extracts S
            sequences' frames (the multi-sequence mode's shared front
            end — S per-system extract calls collapse into one batched
            program)."""
            imgs = imgs.astype(jnp.float32)
            fs = self.extractor._extract(imgs)
            und = cam_ops.undistort_points(
                fs.xy, k.fx, k.fy, k.cx, k.cy, k.k1, k.k2, k.p1, k.p2, k.k3)
            return jnp.concatenate([
                fs.xy, und,
                fs.response[..., None], fs.angle[..., None],
                fs.octave.astype(jnp.float32)[..., None],
                fs.valid.astype(jnp.float32)[..., None],
                jax.lax.bitcast_convert_type(fs.desc, jnp.float32),
            ], axis=2)                                     # [S, N, 16]

        self._extract_packed_batch = jax.jit(_extract_packed_batch)

        def _extract_packed_stereo(left, right):
            from orb_slam_system_tpu.ops.stereo import stereo_match

            x = jnp.stack([left, right]).astype(jnp.float32)
            fs = self.extractor._extract(x)
            und = cam_ops.undistort_points(
                fs.xy, k.fx, k.fy, k.cx, k.cy, k.k1, k.k2, k.p1, k.p2, k.k3)
            u_right, depth = stereo_match(
                x[0], x[1],
                fs.xy[0], fs.octave[0], fs.desc[0], fs.valid[0],
                fs.xy[1], fs.octave[1], fs.desc[1], fs.valid[1],
                jnp.asarray(self.scale_factors), k.bf, 0.0, k.fx,
                scale_factor=float(orb.scale_factor))
            return jnp.concatenate([
                fs.xy[0], und[0],
                fs.response[0][:, None], fs.angle[0][:, None],
                fs.octave[0].astype(jnp.float32)[:, None],
                fs.valid[0].astype(jnp.float32)[:, None],
                jax.lax.bitcast_convert_type(fs.desc[0], jnp.float32),
                u_right[:, None], depth[:, None],
            ], axis=1)                                     # [N, 18]

        self._extract_packed_stereo = jax.jit(_extract_packed_stereo)

        def _extract_packed_rgbd(img, depth_map, depth_scale):
            from orb_slam_system_tpu.ops.stereo import rgbd_pseudo_stereo

            fs = self.extractor._extract(img.astype(jnp.float32)[None])
            und = cam_ops.undistort_points(
                fs.xy, k.fx, k.fy, k.cx, k.cy, k.k1, k.k2, k.p1, k.p2, k.k3)
            u_right, depth = rgbd_pseudo_stereo(
                depth_map, fs.xy[0], und[0], fs.valid[0], k.bf, depth_scale)
            return jnp.concatenate([
                fs.xy[0], und[0],
                fs.response[0][:, None], fs.angle[0][:, None],
                fs.octave[0].astype(jnp.float32)[:, None],
                fs.valid[0].astype(jnp.float32)[:, None],
                jax.lax.bitcast_convert_type(fs.desc[0], jnp.float32),
                u_right[:, None], depth[:, None],
            ], axis=1)                                     # [N, 18]

        self._extract_packed_rgbd = jax.jit(_extract_packed_rgbd)

        # Undistorted image bounds (reference ComputeImageBounds).
        b = cam_ops.compute_image_bounds(
            cam.width, cam.height, k.fx, k.fy, k.cx, k.cy,
            k.k1, k.k2, k.p1, k.p2, k.k3)
        self.bounds = tuple(float(x) for x in b)  # (min_x, max_x, min_y, max_y)

    @staticmethod
    def _unpack_feats(packed: np.ndarray) -> FrameFeatures:
        stereo = packed.shape[1] >= 18
        return FrameFeatures(
            xy=packed[:, 0:2].copy(),
            xy_und=packed[:, 2:4].copy(),
            response=packed[:, 4].copy(),
            angle=packed[:, 5].copy(),
            octave=packed[:, 6].astype(np.int32),
            desc=np.ascontiguousarray(packed[:, 8:16]).view(np.uint32),
            valid=packed[:, 7] > 0.5,
            u_right=packed[:, 16].copy() if stereo else None,
            depth=packed[:, 17].copy() if stereo else None,
        )

    def build(self, img: np.ndarray, timestamp: float) -> Frame:
        """img: f32/u8 [H, W] grayscale. One device call, ZERO fetches —
        the packed buffer stays device-resident; the host copy is
        materialized lazily (keyframe creation, initialization). u8 input
        uploads as u8 (4x less PCIe traffic than f32; jit
        specializes per dtype and casts on device)."""
        packed = self._extract_packed(jnp.asarray(img))
        f = Frame(id=self._next_id, timestamp=timestamp, packed_dev=packed)
        self._next_id = self._next_id + 1
        return f

    def build_stereo(self, img_left: np.ndarray, img_right: np.ndarray,
                     timestamp: float) -> Frame:
        """Rectified stereo frame: one batched extraction over both images
        (the batched version of the reference's two extraction threads,
        src/Frame.cc:58-61) + row-banded stereo matching."""
        packed = self._extract_packed_stereo(
            jnp.asarray(img_left), jnp.asarray(img_right))
        f = Frame(id=self._next_id, timestamp=timestamp, packed_dev=packed)
        self._next_id += 1
        return f

    def build_rgbd(self, img: np.ndarray, depth_map: np.ndarray,
                   timestamp: float) -> Frame:
        """RGB-D frame: extraction + pseudo-stereo from the depth map
        (reference src/Frame.cc:99-151, :623-644)."""
        # Reference src/Tracking.cc:90-96: scale raw depth by 1/DepthMapFactor.
        df = self.cfg.depth_map_factor
        depth_scale = 1.0 / df if abs(df) > 1e-5 else 1.0
        packed = self._extract_packed_rgbd(
            jnp.asarray(img),
            jnp.asarray(depth_map, jnp.float32),
            jnp.asarray(depth_scale, jnp.float32))
        f = Frame(id=self._next_id, timestamp=timestamp, packed_dev=packed)
        self._next_id += 1
        return f
