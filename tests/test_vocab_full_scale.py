"""Real-scale vocabulary gate (env-gated: ORB_SLAM_RUN_VOCAB_FULL=1).

The shipped ORBvoc.txt is k=10 L=6 (~1.11M nodes, ~140 MB;
reference Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1342-1420); the
loader had only been scale-proven to 111k nodes. This generates a
full-size synthetic file (tools/make_full_vocab.py — structure-identical,
random centroids), loads it through the text parser + npz cache, and
runs host/device transforms and BoW scoring at real size.

Run manually:
  ORB_SLAM_RUN_VOCAB_FULL=1 python -m pytest tests/test_vocab_full_scale.py -s
(~6 min on this host: ~2 min generate, ~2 min parse, the rest bench.)
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

pytestmark = pytest.mark.skipif(
    os.environ.get("ORB_SLAM_RUN_VOCAB_FULL") != "1",
    reason="~140 MB generate + full-scale load (set ORB_SLAM_RUN_VOCAB_FULL=1)")


def test_full_scale_vocab(tmp_path):
    from tools.make_full_vocab import bench, generate

    path = os.environ.get("ORB_SLAM_VOCAB_FULL_PATH",
                          str(tmp_path / "orbvoc_full.txt"))
    if not os.path.exists(path):
        generate(path, k=10, L=6)
    out = bench(path)
    print(out)
    # Real-artifact structure: 10 + 100 + ... + 10^6 nodes (+ root).
    assert out["n_nodes"] == sum(10 ** i for i in range(0, 7))
    assert out["n_words"] == 10 ** 6
    assert out["file_mb"] > 100
    # Host/device descent agree bit-for-bit and complete in bounded time
    # (per 1000 descriptors; generous bounds — this is a does-it-scale
    # gate, not a perf benchmark).
    assert out.get("device_bit_equal", True)
    assert out["transform_host_ms"] < 2000
    # Self-score is exactly 1 under L1 normalization.
    assert abs(out["score_self"] - 1.0) < 1e-3
    # Cached reload is order-of-magnitude faster than the text parse.
    assert out["load_cache_s"] < out["load_text_s"]
