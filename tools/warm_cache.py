#!/usr/bin/env python
"""Pre-populate the persistent XLA compilation cache for serving.

Thin CLI over orb_slam_system_tpu.utils.warmup.warm() (the same pass
System(..., prewarm=True) runs at construction). Run once per deployment
target, or ship the cache directory (`$JAX_COMPILATION_CACHE_DIR`, else
`.jax_cache` in the checkout) with the image, to remove the first-run
compile cliff.

Usage: python tools/warm_cache.py [n_frames_per_pass]
       (warms the cache of the backend JAX picks: the GPU when present)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orb_slam_system_tpu.utils.warmup import warm  # noqa: E402

if __name__ == "__main__":
    warm(int(sys.argv[1]) if len(sys.argv) > 1 else 72)
