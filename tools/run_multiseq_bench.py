#!/usr/bin/env python
"""Record the batched multi-sequence throughput artifact (BASELINE config
5's scale-out showcase — S complete SLAM systems, shared batched
extraction, aggregate fps + per-sequence ATE).

Runs examples/multiseq_throughput.run_full on the current backend and
writes MULTISEQ_r{N}.json at the repo root.

Usage: python tools/run_multiseq_bench.py [round_n] [n_seq] [n_frames]
       (on the GPU: the default backend)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    n_round = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    n_seq = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    n_frames = int(sys.argv[3]) if len(sys.argv) > 3 else 60
    out_dir = "/tmp/multiseq_r%d" % n_round
    os.makedirs(out_dir, exist_ok=True)
    import jax
    from examples.multiseq_throughput import run_full
    t0 = time.time()
    ms, ates, fps = run_full(n_seq=n_seq, n_frames=n_frames,
                             out_dir=out_dir, verbose=True)
    from orb_slam_system_tpu.config import TrackingState
    rec = {
        "metric": "multiseq_aggregate_fps",
        "value": round(fps, 2),
        "unit": "frames/sec (all sequences)",
        "n_sequences": n_seq,
        "n_frames_per_seq": n_frames,
        "per_seq_ate_cm": [round(a * 100, 2) for a in ates],
        "ok_final": sum(1 for s in ms.systems
                        if s.get_tracking_state() == TrackingState.OK),
        "device": jax.devices()[0].platform,
        "wall_s": round(time.time() - t0, 1),
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), f"MULTISEQ_r{n_round:02d}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
