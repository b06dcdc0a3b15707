"""orb_slam_system_tpu — an ORB-SLAM2-class visual SLAM framework in JAX.

Built from scratch in JAX/XLA against the capability surface of the
reference (WangHewei16/ORB-SLAM-System, an ORB-SLAM2 fork; see SURVEY.md).
The compute path (feature extraction, descriptor matching, RANSAC solvers,
bundle adjustment) runs as batched, statically-shaped device programs; the
sequential SLAM state machine and the map store live on host.

Layering (mirrors SURVEY.md §1):
  utils/     SE3/Sim3 Lie ops, camera models, profiling
  ops/       device kernels: pyramid, FAST, orientation, rBRIEF, Hamming,
             matching, stereo
  solvers/   batched LM engine: pose optimization, two-view init, EPnP,
             Sim3, local/global BA, essential graph
  mapping/   host-side map arena (keyframes, map points, covisibility)
  models/    Frame, Tracking, LocalMapping, LoopClosing, System facade
  vocab/     bag-of-words vocabulary (DBoW2-equivalent)
  dataio/    dataset readers (TUM/KITTI/EuRoC), trajectory writers, synthetic
  parallel/  device-mesh sharding for batched multi-sequence mapping

The program runs on whatever backend JAX picks (the GPU when one is
present); `JAX_PLATFORMS=cpu` forces the CPU.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))

# Every float32 contraction runs at full float32 precision. XLA's GPU
# default runs f32 matmuls as TF32 (10 mantissa bits), which is too coarse
# for the geometry: the pose chain, the solvers' normal equations and the
# projection gates compound the rounding frame over frame. The contractions
# meant to be low precision say so through their operand types (bf16
# descriptor tests in ops/brief.py, int8 Hamming in ops/hamming.py) and an
# explicit `precision` where the default would otherwise apply.
_jax.config.update("jax_default_matmul_precision", "highest")


def compilation_cache_dir() -> str:
    """Where XLA compilations persist across processes:
    `$JAX_COMPILATION_CACHE_DIR` when set, else `.jax_cache` in the
    checkout (a fixed path, so the cache keys stay stable)."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_REPO_ROOT, ".jax_cache"))


def _enable_compilation_cache():
    """Persist XLA compilations across processes (the SLAM pipeline traces
    ~100 programs; cold starts drop from minutes to seconds on reruns).
    Opt out with ORB_SLAM_TPU_NO_COMPILE_CACHE=1."""
    if _os.environ.get("ORB_SLAM_TPU_NO_COMPILE_CACHE"):
        return
    _jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compilation_cache()

from orb_slam_system_tpu.config import SlamConfig, Sensor  # noqa: F401, E402
