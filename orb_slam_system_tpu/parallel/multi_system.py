"""Full-system batched multi-sequence SLAM (BASELINE.json config 5).

The reference is strictly single-sequence (one System per process); batched
multi-sequence throughput is this framework's extension axis
(SURVEY.md §2.4). `parallel/multiseq.py` shards a simplified front-end
step over a device mesh; THIS module runs S COMPLETE Systems — tracking,
local mapping, loop closing, relocalization, trajectory export each — while
collapsing the dominant per-frame device cost into shared batched
programs:

  * Extraction: one [S,H,W] fused pyramid/FAST/rBRIEF program
    (FrameBuilder._extract_packed_batch) builds every steady sequence's
    frame in a single device call; each System consumes its [N,16] slice
    as a prebuilt device-resident frame (zero fetch).
  * Sequences still initializing run their own classic path (monocular
    initialization needs the 2x-feature extractor).

Per-sequence map state stays fully independent (separate arenas, mappers,
loop closers), so results are identical in kind to running S Systems —
only the device dispatch is batched.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from orb_slam_system_tpu.config import Sensor, SlamConfig, TrackingState
from orb_slam_system_tpu.models.frame import Frame, FrameBuilder
from orb_slam_system_tpu.models.system import System


class MultiSystem:
    """S independent full SLAM systems with a shared batched front end."""

    def __init__(self, cfg: SlamConfig, n_sequences: int,
                 async_mapping: bool = False):
        self.cfg = cfg
        self.systems: List[System] = [
            System(None, cfg, Sensor.MONOCULAR, async_mapping=async_mapping)
            for _ in range(n_sequences)
        ]
        # ONE shared steady-state builder for the batched extraction; the
        # per-system builders keep owning frame-id counters (keyframe
        # cadence decisions are id-based) and the init-phase 2x extractor.
        self.shared_builder = FrameBuilder(cfg)
        self.frame_ms: list[float] = []

    @property
    def n_sequences(self) -> int:
        return len(self.systems)

    def track_batch(self, imgs: np.ndarray, timestamp: float):
        """imgs [S,H,W] (u8/f32 grayscale) -> list of Tcw (or None).

        Steady sequences ride the shared batched extraction; initializing
        or lost-at-start sequences use their own classic entry point."""
        t0 = time.perf_counter()
        S = len(self.systems)
        assert imgs.shape[0] == S
        steady = [s for s in range(S)
                  if self.systems[s].tracker.state
                  not in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED)]
        poses: list[Optional[np.ndarray]] = [None] * S
        if steady:
            import jax.numpy as jnp
            # Always extract the FULL [S,H,W] batch: slicing to the
            # steady subset would jit-compile _extract_packed_batch once
            # per distinct subset size (the heaviest device program,
            # ~seconds per compile, re-triggered whenever any sequence
            # resets to init). The wasted rows for non-steady sequences
            # cost far less than one recompile.
            packed = self.shared_builder._extract_packed_batch(
                jnp.asarray(imgs))

            def _track_one(s):
                tr = self.systems[s].tracker
                f = Frame(id=tr.builder._next_id, timestamp=timestamp,
                          packed_dev=packed[s])
                tr.builder._next_id += 1
                return self.systems[s].track_monocular_prebuilt(f)

            # The S systems are fully independent (separate arenas,
            # mappers, locks), so their tracking steps run CONCURRENTLY
            # on a thread pool: each step's device fetches block its own
            # thread while the others' round trips overlap, and jitted
            # dispatch is thread-safe. Sequentially the S steps paid
            # S x (tracking round trips + per-KF mapping) per frame.
            from concurrent.futures import ThreadPoolExecutor
            if len(steady) > 1:
                if not hasattr(self, "_pool") or self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=min(8, len(self.systems)),
                        thread_name_prefix="multiseq")
                for s, T in zip(steady,
                                self._pool.map(_track_one, steady)):
                    poses[s] = T
            else:
                for s in steady:
                    poses[s] = _track_one(s)
        for s in range(S):
            if s not in steady:
                poses[s] = self.systems[s].track_monocular(
                    imgs[s], timestamp)
        self.frame_ms.append((time.perf_counter() - t0) * 1e3)
        return poses

    def shutdown(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
            self._pool = None
        for s in self.systems:
            s.shutdown()

    def aggregate_fps(self, skip: int = 5) -> float:
        ms = self.frame_ms[skip:]
        if not ms:
            return 0.0
        return len(ms) * self.n_sequences / (sum(ms) / 1e3)
