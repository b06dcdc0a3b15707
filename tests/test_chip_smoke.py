"""CPU checks of chip_smoke.py (its refusal without a GPU and its parity
helpers at tiny sizes) and of the compile-cache location."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import orb_slam_system_tpu  # noqa: E402


@pytest.mark.parametrize("args", [[], ["--tf32-control"]])
def test_chip_smoke_refuses_cpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                          *args],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def test_extraction_parity_same_device(cpu):
    from orb_slam_system_tpu.config import ORBConfig
    from orb_slam_system_tpu.dataio.synthetic import (
        PlanarSceneRenderer, orbit_trajectory)
    from orb_slam_system_tpu.ops.extractor import ORBExtractor
    K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]], np.float32)
    img = PlanarSceneRenderer(K, 160, 120).render(orbit_trajectory(2)[0])
    ext = ORBExtractor(ORBConfig(n_features=200, n_levels=3), 120, 160)
    ex = chip_smoke.extraction_parity(ext, img[None].astype(np.float32),
                                      cpu, cpu)
    assert ex["n_kp"][0] == ex["n_kp"][1] > 50
    assert ex["kp_set"] == ex["octave_eq"] == ex["desc_bits"] == 1.0


def test_hamming_parity_same_device(cpu, rng):
    d = rng.integers(0, 2 ** 32, size=(2, 64, 8), dtype=np.uint32)
    assert chip_smoke.hamming_parity(d[0], d[1], cpu, cpu)


def test_pose_parity_same_device(cpu, rng):
    po = chip_smoke.pose_parity(chip_smoke.make_pose_problem(rng, n=64),
                                cpu, cpu)
    assert po["rot"] <= chip_smoke.POSE_ROT_MAX
    assert po["trans"] <= chip_smoke.POSE_TRANS_MAX


def test_ba_parity_same_device(cpu, rng):
    prob = chip_smoke.make_ba_problem(rng, C=4, P=64, E=256)
    ba = chip_smoke.ba_parity(prob, cpu, cpu)
    assert abs(ba["a"] - ba["b"]) <= chip_smoke.BA_RMS_DIFF_MAX
    assert ba["a"] <= chip_smoke.BA_RMS_MAX
    assert ba["inliers_a"] == ba["inliers_b"] > 200


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert orb_slam_system_tpu.compilation_cache_dir() == str(tmp_path / "cc")


@pytest.mark.parametrize("cwd", ["repo", "elsewhere"])
def test_compile_cache_dir_fixed_in_checkout(monkeypatch, tmp_path, cwd):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(REPO if cwd == "repo" else tmp_path)
    assert (orb_slam_system_tpu.compilation_cache_dir()
            == os.path.join(REPO, ".jax_cache"))

