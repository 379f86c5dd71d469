"""Cross-video dispatch batching: measure whether merging many SMALL
videos' scan batches into shared device dispatches would pay.

Batch mode runs one ProcessingPipeline per video (batch/batch.py:280);
each video's frames dispatch separately, and every dispatch pads to
``device_batch`` frames (models/mv_detector.py::_words_dispatch).  For a
directory of tiny clips (e.g. 12 x 200 frames), that is 12 padded
2048-frame dispatches where a cross-video feeder would issue 2 — the
open question from round 3 (VERDICT item 8): does the saved dispatch +
padded-compute overhead matter against the host decode/cut wall that
dominates small-clip batches?

Three strategies over the SAME frames (V videos x F frames, bits
payload, production scan_bits_async path):

* pervideo  — production semantics: each video dispatches and RESOLVES
              before the next starts (per-stream pipelines are
              sequential; the cut decision needs the resolve).
* pipelined — what a shared feeder gets WITHOUT merging batches: all V
              dispatches issued back-to-back, one resolve pass at the
              end (removes V-1 round-trip latencies, keeps V padded
              dispatches).
* merged    — full cross-video batching: one [V*F]-frame scan_bits_async
              call (ceil(V*F / device_batch) padded dispatches).

All three must produce identical motion vectors, diffed against the
oracle (audit).  Prints per-strategy medians and a JSON line.

The decision is read from the ratio structure: dispatch count x
per-dispatch cost vs the end-to-end batch wall (PERFORMANCE.md,
"Cross-video dispatch batching").  Run it on the card; JAX_PLATFORMS=cpu
gives a host-only reference run.

Usage:
    python benchmarks/dispatch_batch_bench.py [--videos 12] [--frames 200]
        [--width 640 --height 480] [--repeats 5] [--density 0.03]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--density", type=float, default=0.03)
    args = ap.parse_args()

    from mvtrim_tpu.core import oracle
    from mvtrim_tpu.core.config import Config
    from mvtrim_tpu.models.mv_detector import MVClusterDetector

    cfg = Config()
    det = MVClusterDetector(args.width, args.height, cfg)
    geom = det.geom
    V, F = args.videos, args.frames

    rng = np.random.default_rng(7)
    active = (rng.random((V, F, geom.gh, geom.gw)) <
              args.density).astype(np.uint8)
    bits = np.packbits(active, axis=3, bitorder="little")  # [V,F,gh,gwb]
    merged_bits = bits.reshape(V * F, geom.gh, -1)

    # oracle truth for the audit
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    truth = np.stack([
        oracle.count_clusters_batch(active[v], vectors_needed=1,
                                    y_min=geom.y_min, y_max=geom.y_max)
        >= need
        for v in range(V)
    ])  # [V, F] bool

    # warmup: compile + one full round-trip outside every timed window
    det.scan_bits(bits[0])

    def run_pervideo():
        out = np.zeros((V, F), bool)
        for v in range(V):
            out[v] = det.scan_bits_async(bits[v])()
        return out

    def run_pipelined():
        rs = [det.scan_bits_async(bits[v]) for v in range(V)]
        return np.stack([r() for r in rs])

    def run_merged():
        return det.scan_bits_async(merged_bits)().reshape(V, F)

    strategies = (("pervideo", run_pervideo, V),
                  ("pipelined", run_pipelined, V),
                  ("merged", run_merged,
                   -(-(V * F) // det.device_batch)))

    results = {}
    for name, fn, n_disp in strategies:
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            motion = fn()
            times.append(time.perf_counter() - t0)
        assert np.array_equal(motion, truth), f"{name} diverges from oracle"
        med = statistics.median(times)
        results[name] = {"median_s": round(med, 4),
                         "dispatches": n_disp,
                         "per_dispatch_ms": round(1e3 * med / n_disp, 1)}
        print(f"{name:<10} {med*1e3:8.1f} ms   {n_disp:3d} dispatches   "
              f"{1e3*med/n_disp:6.1f} ms/dispatch", file=sys.stderr)

    saved = results["pervideo"]["median_s"] - results["merged"]["median_s"]
    rec = {"bench": "dispatch_batch", "videos": V, "frames_per_video": F,
           "width": args.width, "height": args.height,
           "device_batch": det.device_batch,
           "backend": det.backend,
           "platform": __import__("jax").default_backend(),
           "audit": "all strategies bit-equal the oracle motion vector",
           "merged_saves_s_per_batch": round(saved, 4), **results}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
