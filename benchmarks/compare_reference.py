"""Head-to-head benchmark: this framework vs the compiled C++ reference.

Builds the reference (parity/harness.py), synthesizes a 1080p clip, runs
both implementations on it end to end (cuts captured by stand-ins so only
scan+segment work is timed), verifies the concat lists are byte-identical,
and prints a comparison table.

Usage: python benchmarks/compare_reference.py [--duration 120] [--runs 2]

Notes on reading the numbers: the rebuild pays a one-time jit
compilation ("warmup(jit)" phase) that production hosts amortize via the
persistent compilation cache or long-lived batch processes;
marginal_per_video_sec excludes it (what each additional video costs in
batch/daemon operation), wall_sec includes it plus interpreter startup.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from parity import harness  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--duration", type=float, default=120.0)
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    args = parser.parse_args()

    sys.path.insert(0, harness.REPO)
    from mvtrim_tpu.io import native

    clip = (f"/tmp/bench_clip_{args.width}x{args.height}"
            f"_{args.duration:.0f}s.mp4")
    if not os.path.exists(clip):
        print(f"synthesizing {args.duration:.0f}s "
              f"{args.width}x{args.height} clip...", file=sys.stderr)
        native.synthesize(
            clip, width=args.width, height=args.height, fps=25.0,
            duration=args.duration, codec="libx264",
            motion_windows=((args.duration * 0.1, args.duration * 0.2),
                            (args.duration * 0.5, args.duration * 0.65),
                            (args.duration * 0.85, args.duration * 0.9)))

    binary, shim = harness.ensure_reference()

    # Interleave reference/rebuild runs: this host's throughput swings by
    # tens of percent over minutes, so back-to-back pairs are the only
    # fair comparison; medians over the pairs absorb the residual noise.
    ref_walls, ref_concat = [], None
    our_walls, our_marginals, our_concat = [], [], None
    for i in range(args.runs):
        print(f"run {i + 1}/{args.runs}: reference...", file=sys.stderr)
        wall, ref_concat = harness.run_reference(
            binary, shim, clip, "/tmp/bench_ref_out.mp4",
            "/tmp/bench_ref_concat.txt")
        ref_walls.append(wall)

        print(f"run {i + 1}/{args.runs}: rebuild...", file=sys.stderr)
        wall, our_concat, stdout = harness.run_ours(
            clip, "/tmp/bench_our_out.mp4", "/tmp/bench_our_concat.txt",
            {"MVT_LOG": "0"})
        our_walls.append(wall)
        m = re.search(r"warmup\(jit\)\s+([0-9.]+)s", stdout)
        warmup = float(m.group(1)) if m else 0.0
        m = re.search(r"total_run\s+([0-9.]+)s", stdout)
        total_run = float(m.group(1)) if m else wall
        our_marginals.append(total_run - warmup)

    from statistics import median

    frames = args.duration * 25.0
    ref_med, our_med = median(ref_walls), median(our_marginals)
    result = {
        "clip": {"resolution": f"{args.width}x{args.height}",
                 "duration_sec": args.duration, "frames": frames},
        "reference_cpp": {
            "wall_sec": round(ref_med, 2),
            "wall_sec_runs": [round(w, 2) for w in ref_walls],
            "frames_per_sec": round(frames / ref_med),
        },
        "rebuild": {
            "wall_sec": round(median(our_walls), 2),
            "marginal_per_video_sec": round(our_med, 2),
            "marginal_per_video_runs": [round(w, 2) for w in our_marginals],
            "marginal_frames_per_sec": round(frames / our_med),
        },
        "rebuild_vs_reference": round(ref_med / our_med, 3),
        "concat_lists_identical": (our_concat is not None
                                   and our_concat == ref_concat),
    }
    print(json.dumps(result, indent=2))
    return 0 if result["concat_lists_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
