"""Feeder-scaling benchmark: can ONE Python feeder keep up with N decode
cores? ("feeding the beast", SURVEY.md §7)

The reference's scale-out story is fully-independent per-stream workers
(batch_processor.cpp:153-157); the rebuild's is N GIL-releasing native
decode threads feeding ONE Python feeder that assembles device batches
(pipeline/pipeline.py feeder loop).  The feeder must sustain the frame
rate of all decode cores together or it becomes the many-core
bottleneck; compare its rate with the host's measured decode rate.

This harness drives the REAL feeder+detector path with synthetic
pre-decoded chunks from N producer threads (no decode cost — producers
only enqueue, so the measured ceiling is the feeder's own):

* payload ``bits``  — the default H2D path: the feeder re-packs each
  batch to the int32 word layout (ops/cluster.repack_bits_words).
* payload ``words`` — the MVT_SCAN_INPUT=words path: the native scanner
  already emitted the word layout inside the GIL-released decode call;
  the feeder only assembles (pad).

Dispatch modes:
* ``null``   (default) — batch assembly runs in full, the device op is a
  stub: measures the feeder's HOST work in isolation (what competes with
  decode threads for cores).  Runs on the CPU backend.
* ``device`` — real detector dispatch + resolve on the card.

Prints a frames/s table vs producer count and a JSON line per row.

Usage:
    python benchmarks/feeder_bench.py [--payload bits,words]
        [--producers 1,2,4,8,16,32] [--frames 40000] [--chunk 256]
        [--dispatch null|device] [--width 1920 --height 1080]
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_chunks(payload, geom, cfg, chunk_frames, n_distinct=8, seed=0):
    """Pre-decoded chunk payloads with realistic (sparse) activity."""
    from mvtrim_tpu.ops.cluster import repack_bits_words

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_distinct):
        grids = (rng.random((chunk_frames, geom.gh, geom.gw)) <
                 0.03).astype(np.uint8) * cfg.vectors_needed
        bits = np.packbits(grids >= cfg.vectors_needed, axis=2,
                           bitorder="little")
        pts = np.arange(chunk_frames, dtype=np.float64) / 25.0
        if payload == "bits":
            out.append((bits, pts))
        else:
            out.append((np.ascontiguousarray(
                repack_bits_words(bits, geom)), pts))
    return out


def run_case(payload, n_producers, total_frames, chunk_frames, dispatch,
             width, height, device_batch):
    from mvtrim_tpu.core.config import Config
    from mvtrim_tpu.models.mv_detector import MVClusterDetector

    cfg = Config(device_batch=device_batch)
    det = MVClusterDetector(width, height, cfg)
    if dispatch == "null":
        # stub the device op AFTER the real batch assembly: scan_*_async
        # still pads/repacks exactly like production, then the "op"
        # returns immediately
        def null_op(batch):
            return None, np.zeros((batch.shape[0],), bool)

        det._bits_op = null_op
    else:
        # real warmup so compile is outside the timed window
        gwb = (det.geom.gw + 7) // 8
        det.scan_bits(np.zeros((1, det.geom.gh, gwb), np.uint8))

    chunks = make_chunks(payload, det.geom, cfg, chunk_frames)
    n_chunks = (total_frames + chunk_frames - 1) // chunk_frames
    # distribute the remainder instead of truncating it: with 32
    # producers and 157 chunks a silent floor-division would measure an
    # ~18% smaller workload than --frames asked for
    per_producer = [n_chunks // n_producers
                    + (i < n_chunks % n_producers)
                    for i in range(n_producers)]

    results: queue.Queue = queue.Queue(maxsize=max(4, 2 * n_producers))

    def producer(widx):
        for i in range(per_producer[widx]):
            results.put(chunks[(widx + i) % len(chunks)])
        results.put(None)

    threads = [threading.Thread(target=producer, args=(i,))
               for i in range(n_producers)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()

    pending = []
    frames = 0
    done = 0
    while done < n_producers:
        item = results.get()
        if item is None:
            done += 1
            continue
        data, pts = item
        if payload == "bits":
            resolver = det.scan_bits_async(data)
        else:
            resolver = det.scan_words_async(data)
        pending.append((pts, resolver))
        frames += len(pts)
    motion_total = 0
    for pts, resolver in pending:
        motion_total += int(np.asarray(resolver()).sum())
    for th in threads:
        th.join()
    dt = time.perf_counter() - t0
    return frames / dt, frames, motion_total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--payload", default="bits,words")
    ap.add_argument("--producers", default="1,2,4,8,16,32")
    ap.add_argument("--frames", type=int, default=40000)
    ap.add_argument("--chunk", type=int, default=256,
                    help="frames per producer chunk (the pipeline's "
                         "chunk_duration*fps analog)")
    ap.add_argument("--dispatch", default="null",
                    choices=("null", "device"))
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device-batch", type=int, default=2048)
    args = ap.parse_args()

    if args.dispatch == "null":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")

    print(f"{'payload':<8}{'producers':>10}{'frames/s':>14}",
          file=sys.stderr)
    for payload in args.payload.split(","):
        for n in (int(x) for x in args.producers.split(",")):
            fps, frames, motion = run_case(
                payload, n, args.frames, args.chunk, args.dispatch,
                args.width, args.height, args.device_batch)
            print(f"{payload:<8}{n:>10}{fps:>14,.0f}", file=sys.stderr)
            print(json.dumps({
                "bench": "feeder", "payload": payload, "producers": n,
                "dispatch": args.dispatch, "frames_per_sec": round(fps),
                "frames": frames, "motion_frames": motion}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
