"""Sharded streaming scan for very long archives (BASELINE config 5).

One video's timeline is chunk-decoded by host workers (same task-queue
model as the single-card pipeline), but frame batches are assembled into
global device batches sharded over the mesh's 'data' axis: every card
scans 1/N of each batch and the per-frame motion booleans come back
gathered.  Segmentation stays on host in float64 (the bit-parity path);
the device segment op (ops/segmentation.py) serves streaming statistics.

This replaces the reference's only scale-out story — more CPU threads in
one box — with the cards of a mesh: decode scales with host cores, scan
scales with mesh size.
"""

from __future__ import annotations

import math
import os
import queue
import threading

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import oracle
from ..core.config import Config
from ..core.types import GridGeometry, ScanTask
from ..io import native
from ..utils import logging as log
from ..utils import system
from .mesh import (build_mesh, build_process_mesh,
                   sharded_bits_scan_step, sharded_sad_scan_step)


class ScanCheckpoint:
    """Chunk-granular resume state for long archive scans.

    JSON-lines sidecar: one record per completed chunk with its motion
    timestamps.  A re-run skips completed chunks and seeds their
    timestamps — the mid-video resume the reference lacks (its only
    idempotency is the output-exists skip, batch_processor.cpp:66-69).
    """

    def __init__(self, path: str, identity: dict | None = None):
        import json
        import os

        self.path = path
        self._json = json
        self.done: dict[int, list[float]] = {}
        seen_header = False
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        # a kill mid-append leaves one truncated line;
                        # tolerating it costs one chunk re-scan — far
                        # better than refusing the resume the sidecar
                        # exists to provide
                        continue
                    if "header" in rec:
                        seen_header = True
                        if identity is not None and \
                                rec["header"] != identity:
                            raise RuntimeError(
                                f"checkpoint {path} belongs to a "
                                f"different scan: sidecar header "
                                f"{rec['header']!r} != current "
                                f"{identity!r}; delete the file (or "
                                f"point MVT_CHECKPOINT elsewhere) to "
                                f"start fresh")
                        continue
                    self.done[int(rec["chunk"])] = rec["motion_ts"]
            if identity is not None and not seen_header and self.done:
                log.warn(f"checkpoint {path} has no identity header "
                         "(older format): cannot verify it matches this "
                         "video/config — resuming anyway")
        if identity is not None and not seen_header and not self.done:
            # stamp FRESH sidecars so a future resume against a different
            # video or config fails loudly instead of silently merging
            # foreign chunks.  Legacy headerless sidecars that already
            # carry chunk records are deliberately NOT stamped: stamping
            # would convert "cannot verify" into "verified" for records
            # this scan never checked — they keep warning on every resume
            with open(path, "a") as f:
                f.write(json.dumps({"header": identity}) + "\n")

    def record(self, chunk_id: int, motion_ts: list[float]) -> None:
        with open(self.path, "a") as f:
            f.write(self._json.dumps(
                {"chunk": chunk_id, "motion_ts": motion_ts}) + "\n")
        self.done[chunk_id] = motion_ts


def _allgather_f64(x: np.ndarray):
    """process_allgather of a float64 vector WITHOUT precision loss.

    multihost_utils routes through jax arrays, and with jax_enable_x64
    off (the default) a float64 payload is silently downcast to float32 —
    enough to move %.2f-quantized cut boundaries.  Gather the raw bit
    pattern as two int32 halves instead; returns [pc, n] float64.
    """
    from jax.experimental import multihost_utils

    bits = np.ascontiguousarray(x).view(np.uint64)
    hi = (bits >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    ghi = np.asarray(multihost_utils.process_allgather(hi))
    glo = np.asarray(multihost_utils.process_allgather(lo))
    gbits = ((ghi.view(np.uint32).astype(np.uint64) << np.uint64(32))
             | glo.view(np.uint32).astype(np.uint64))
    return gbits.view(np.float64)


def scan_archive_multiprocess(input_path: str, cfg: Config | None = None,
                              *, mesh=None, frames_per_device: int = 256,
                              checkpoint: str | None = None,
                              progress_cb=None):
    """Multi-process archive scan (one process per card or per host).

    Each host process decodes a DISJOINT chunk slice of the timeline
    (chunk_id % process_count == process_index — the cross-host analog of
    the single-process task queue) and contributes its local shard of
    every global device batch via
    ``jax.make_array_from_process_local_data``; the scan step's
    collectives merge decisions across the processes' cards (psum for
    global motion counts, all_gather so every process reads the full
    decision vector).
    A final bit-exact float64 timestamp allgather lets every process run
    the identical host segmentation, so ALL processes return the same
    (segments, duration, stats) — byte-equal to the single-card oracle
    path's (asserted at the process level in tests/test_distributed.py).

    Requires ``parallel.distributed.initialize()`` to have joined >= 2
    processes BEFORE any JAX use.  Processes must own equal device
    counts; processes sharing a host each own one card through their
    own CUDA_VISIBLE_DEVICES (parallel/distributed.py).

    ``checkpoint`` is a sidecar BASE path: each process appends
    chunk-granular records to ``<base>.p<process_index>`` as its chunks
    finish scanning, with an identity header that additionally pins
    (process_count, process_index) — a restart with a different process
    count re-shards the chunk assignment, so the resume REFUSES it
    loudly instead of merging foreign chunk splits (delete the sidecars
    to start fresh).  A killed job restarted with the same topology
    skips every recorded chunk's decode AND scan.  The whole job must
    restart together (a dead process stalls the others' collectives —
    the jax.distributed model); per-process sidecars make that restart
    cheap.  ``progress_cb(i, n_dispatch)`` fires after each lockstep
    dispatch (observability + fault-injection hook).

    Reference contrast: the reference's only scale-out is more threads
    in one box (SURVEY.md §5 — no NCCL/MPI/RPC) and its only
    idempotency the output-exists skip (batch_processor.cpp:261-269);
    this spreads decode over hosts, scan over every card, and resumes at
    chunk granularity.
    """
    import jax
    from jax.experimental import multihost_utils

    from ..ops.cluster import packed_geometry

    cfg = cfg or Config.from_env()
    pc, pi = jax.process_count(), jax.process_index()
    if pc < 2:
        raise RuntimeError(
            "scan_archive_multiprocess needs a multi-process JAX cluster "
            "(parallel.distributed.initialize); use scan_archive for "
            "single-process scans")
    mesh = mesh or build_process_mesh()
    data_size = mesh.shape["data"]
    if mesh.shape["sweep"] != 1 or data_size % pc:
        raise RuntimeError(
            f"scan_archive_multiprocess needs a sweep=1 mesh whose data "
            f"axis divides evenly over processes, got shape "
            f"{dict(mesh.shape)} across {pc} processes")
    n_local = sum(1 for d in mesh.devices.ravel()
                  if d.process_index == pi)
    if n_local * pc != data_size:
        raise RuntimeError(
            f"uneven per-process device counts: {n_local} local x {pc} "
            f"processes != mesh size {mesh.devices.size}")
    local_rows = frames_per_device * n_local
    global_batch = frames_per_device * data_size

    reader = native.VideoReader(input_path)
    duration, fps = reader.duration, reader.fps
    geom = GridGeometry.build(reader.width, reader.height, cfg)
    frame_skip = cfg.frame_skip(fps)
    gwb, used, lanes = packed_geometry(geom)

    # per-process sidecar: chunk assignment is cid % pc == pi, so the
    # identity must pin the topology — a different process count
    # re-shards and the resume refuses (ScanCheckpoint header check)
    ckpt = None
    resumed_ts: list[float] = []
    resumed_chunks = 0
    if checkpoint:
        identity = {
            "input": os.path.abspath(input_path),
            "duration": round(duration, 6),
            "chunk_duration_sec": cfg.chunk_duration_sec,
            "mv_threshold_sq": cfg.mv_threshold_sq,
            "block_shift": cfg.block_shift,
            "vectors_needed": cfg.vectors_needed,
            "clusters_needed": cfg.clusters_needed,
            "vertical_mask": cfg.vertical_mask,
            "frame_skip": frame_skip,
            "process_count": pc,
            "process_index": pi,
        }
        ckpt = ScanCheckpoint(f"{checkpoint}.p{pi}", identity)

    # --- decode this process's disjoint chunk slice (cap-resume like the
    # single-process workers, parallel/archive.py worker loop) ---
    max_frames = int(math.ceil(cfg.chunk_duration_sec
                               * max(fps, 1.0))) + 64
    parts_bits: list[np.ndarray] = []
    parts_pts: list[np.ndarray] = []
    chunk_rows: list[tuple[int, int]] = []   # (cid, frames) in feed order
    timing = native.ScanTiming()
    t, cid = 0.0, 0
    while t < duration:
        end = min(t + cfg.chunk_duration_sec, duration)
        if cid % pc == pi:
            if ckpt is not None and cid in ckpt.done:
                resumed_ts.extend(ckpt.done[cid])
                resumed_chunks += 1
            else:
                n_chunk = 0
                resume = False
                while True:
                    bits, pts = reader.scan_bits(
                        t, end, threshold_sq=cfg.mv_threshold_sq,
                        block_shift=cfg.block_shift, gw=geom.gw,
                        gh=geom.gh, y_min=geom.y_min, y_max=geom.y_max,
                        vectors_needed=cfg.vectors_needed,
                        frame_skip=frame_skip, max_frames=max_frames,
                        timing=timing, resume=resume)
                    if len(pts) == 0:
                        break
                    parts_bits.append(bits)
                    parts_pts.append(pts)
                    n_chunk += len(pts)
                    if len(pts) < max_frames:
                        break
                    resume = True
                if n_chunk == 0 and ckpt is not None:
                    ckpt.record(cid, [])      # empty chunk: done already
                elif n_chunk:
                    chunk_rows.append((cid, n_chunk))
        cid += 1
        t += cfg.chunk_duration_sec
    reader.close()
    local_bits = (np.concatenate(parts_bits) if parts_bits
                  else np.zeros((0, geom.gh, gwb), np.uint8))
    local_pts = (np.concatenate(parts_pts) if parts_pts
                 else np.zeros((0,), np.float64))
    n_frames = len(local_pts)

    # --- lockstep dispatch count agreed across processes: SPMD demands
    # every process execute the same program the same number of times,
    # and per-process frame counts differ (chunk contents are data) ---
    counts = np.asarray(multihost_utils.process_allgather(
        np.asarray([n_frames], np.int32))).ravel()
    n_dispatch = -(-int(counts.max()) // local_rows)

    from jax.sharding import NamedSharding, PartitionSpec
    step = sharded_bits_scan_step(geom, cfg, mesh, gather_motion=True)
    sharding = NamedSharding(mesh, PartitionSpec("data", None))
    motion_ts: list[float] = list(resumed_ts)
    motion_frames_psum = 0
    # chunk attribution for checkpointing: local row extents per chunk
    # (feed order), drained as dispatches cover them — a chunk records
    # the moment its last row has been scanned, so a killed job loses at
    # most the in-flight dispatch's chunks
    chunk_bounds: list[tuple[int, int, int]] = []    # (cid, row_lo, n)
    row = 0
    for cid_, n_ in chunk_rows:
        chunk_bounds.append((cid_, row, n_))
        row += n_
    chunk_left = {cid_: n_ for cid_, n_ in chunk_rows}
    chunk_motion: dict[int, list[float]] = {cid_: [] for cid_, _ in
                                            chunk_rows}
    flat = np.zeros((local_rows, lanes), np.uint8)
    for i in range(n_dispatch):
        lo = i * local_rows
        n_valid = max(0, min(lo + local_rows, n_frames) - lo)
        flat[:] = 0  # safe: np.asarray(motion) below resolves the
        # previous dispatch before this overwrite (CPU zero-copy rule)
        if n_valid:
            flat[:n_valid, :used] = \
                local_bits[lo:lo + n_valid].reshape(n_valid, used)
        arr = jax.make_array_from_process_local_data(sharding, flat)
        motion, gcount = step(arr)
        motion = np.asarray(motion)       # replicated [global_batch]
        motion_frames_psum += int(np.asarray(gcount))
        if n_valid:
            # build_process_mesh orders the data axis by process, so this
            # process's rows are the pi-th contiguous block
            mine = motion[pi * local_rows: pi * local_rows + n_valid]
            motion_ts.extend(local_pts[lo:lo + n_valid][mine].tolist())
            for cid_, clo, n_ in chunk_bounds:
                if clo >= lo + n_valid:
                    break                     # rows not yet dispatched
                if cid_ not in chunk_left:
                    continue                  # completed earlier
                a, b = max(clo, lo), min(clo + n_, lo + n_valid)
                if a >= b:
                    continue
                sel = mine[a - lo:b - lo]
                chunk_motion[cid_].extend(
                    local_pts[a:b][sel].tolist())
                chunk_left[cid_] -= b - a
                if chunk_left[cid_] == 0:
                    del chunk_left[cid_]
                    done_ts = chunk_motion.pop(cid_)
                    if ckpt is not None:
                        ckpt.record(cid_, done_ts)
        if progress_cb is not None:
            progress_cb(i, n_dispatch)

    # --- bit-exact global timestamp merge -> identical host segmentation
    # on every process ---
    nms = np.asarray(multihost_utils.process_allgather(
        np.asarray([len(motion_ts)], np.int32))).ravel()
    buf = np.zeros((max(1, int(nms.max())),), np.float64)
    buf[:len(motion_ts)] = motion_ts
    gathered = _allgather_f64(buf)                      # [pc, maxn]
    all_ts = np.concatenate([gathered[p, :int(nms[p])]
                             for p in range(pc)])
    timestamps = oracle.merge_timestamps(all_ts.tolist())
    segments = oracle.segments_from_timestamps(
        timestamps, max_gap_sec=cfg.max_gap_sec,
        padding_sec=cfg.padding_sec, duration=duration)
    stats = {
        "frames_scanned": int(counts.sum()),
        "frames_with_mvs_local": timing.frames_with_mvs,
        "motion_frames": int(timestamps.size),
        "motion_frames_psum": motion_frames_psum,
        "dispatches": n_dispatch,
        "mesh": dict(mesh.shape),
        "processes": pc,
        "global_batch": global_batch,
        "resumed_chunks_local": resumed_chunks,
    }
    log.info(f"archive scan: {stats['frames_scanned']} frames over "
             f"{pc} processes x mesh {dict(mesh.shape)} in "
             f"{n_dispatch} lockstep dispatches")
    return segments, duration, stats


def _probe_archive_mvs(input_path: str, cfg: Config, geom: GridGeometry,
                       frame_skip: int) -> bool:
    """Cheap MV-capability probe for payload='auto': scan short chunk
    prefixes from the start until at least one frame is analyzed (up to
    3 non-empty chunks) and report whether any carried MV side data.

    MV export is a stream/codec property, not content: intra-only
    streams and HEVC on FFmpeg < 7 export none for ANY frame (the
    reference detects nothing on them, motion_scanner.cpp:219-221; the
    single-file pipeline's auto fallback triggers on the same whole-scan
    condition, pipeline/pipeline.py) — so a short prefix decides it.  A
    wrong 'sad' answer (e.g. a frame-skip phase that only ever lands on
    I-frames) still detects motion correctly, just via the pixel path.
    """
    reader = native.VideoReader(input_path)
    try:
        timing = native.ScanTiming()
        t, probed = 0.0, 0
        while t < reader.duration and probed < 3:
            end = min(t + cfg.chunk_duration_sec, reader.duration)
            _, pts = reader.scan_bits(
                t, end, threshold_sq=cfg.mv_threshold_sq,
                block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
                y_min=geom.y_min, y_max=geom.y_max,
                vectors_needed=cfg.vectors_needed,
                frame_skip=frame_skip, max_frames=64, timing=timing)
            if timing.frames_with_mvs > 0:
                return True
            if len(pts) > 0:
                probed += 1
            t += cfg.chunk_duration_sec
        return timing.frames_with_mvs > 0
    finally:
        reader.close()


def scan_archive(input_path: str, cfg: Config | None = None, *,
                 mesh=None, decode_workers: int = 0,
                 frames_per_device: int = 256,
                 checkpoint: str | None = None,
                 payload: str | None = None):
    """Scan one (long) video over a device mesh.

    Returns (segments, duration, stats dict).  Segments come from the
    host float64 oracle path over the gathered motion timestamps, so they
    are identical to the single-card pipeline's.  With ``checkpoint``, a
    sidecar file records per-chunk results so interrupted scans resume.

    ``payload`` picks the scan domain, defaulting to ``cfg.pipeline_mode``
    (MVT_PIPELINE) mapped onto archive payloads:

    * ``'bits'`` (pipeline_mode 'mv') — packed MV activity masks
      (mvt_scan_bits), the transfer-lean default for streams with codec
      MVs (sharded_bits_scan_step).
    * ``'sad'``  (pipeline_mode 'sad') — decoded luma through the
      sharded pixel-domain SAD step (sharded_sad_scan_step): the path
      for intra-only / MV-less archives, which the reference cannot
      detect motion on at all (motion_scanner.cpp:219-221).  Decisions
      match the single-file SAD pipeline exactly: per-shard predecessor
      carries preserve consecutive diffs across shard/batch boundaries,
      and a chunk's first analyzed frame is never motion
      (models/sad_detector.py contract).
    * ``'auto'`` — probe the stream prefix for MV side data
      (_probe_archive_mvs) and pick bits/sad accordingly, like the
      single-file pipeline's auto fallback but without a wasted full
      scan.

    Checkpoint sidecars are payload-specific (the identity header
    carries the payload and its decision-shaping knobs), so a bits
    sidecar can never silently resume a sad scan or vice versa.
    """
    from ..ops.cluster import packed_geometry

    cfg = cfg or Config.from_env()
    mesh = mesh or build_mesh()
    data_size = mesh.shape["data"]

    reader = native.VideoReader(input_path)
    duration, fps = reader.duration, reader.fps
    width, height = reader.width, reader.height
    reader.close()
    geom = GridGeometry.build(width, height, cfg)
    frame_skip = cfg.frame_skip(fps)
    gwb, used, lanes = packed_geometry(geom)

    if payload is None:
        payload = {"mv": "bits", "sad": "sad"}.get(cfg.pipeline_mode,
                                                   "auto")
    if payload not in ("auto", "bits", "sad"):
        raise ValueError(f"unknown archive payload {payload!r} "
                         "(bits | sad | auto)")
    if payload == "auto":
        payload = ("bits" if _probe_archive_mvs(input_path, cfg, geom,
                                                frame_skip) else "sad")
        log.info(f"archive payload auto-selected: {payload}"
                 + ("" if payload == "bits"
                    else " (no MV side data in the stream prefix)"))

    # everything that shapes per-chunk motion timestamps or chunk ids:
    # a sidecar written under any other value must not be resumed from.
    # The bits identity is EXACTLY the round-4 shape (existing sidecars
    # keep resuming); the sad identity swaps the MV-only knobs for the
    # SAD ones and carries an explicit payload marker.
    if payload == "sad":
        identity = {
            "input": os.path.abspath(input_path),
            "duration": round(duration, 6),
            "chunk_duration_sec": cfg.chunk_duration_sec,
            "payload": "sad",
            "sad_threshold": cfg.sad_threshold,
            "block_size": cfg.block_size,
            "clusters_needed": cfg.clusters_needed,
            "vertical_mask": cfg.vertical_mask,
            "frame_skip": frame_skip,
        }
    else:
        identity = {
            "input": os.path.abspath(input_path),
            "duration": round(duration, 6),
            "chunk_duration_sec": cfg.chunk_duration_sec,
            "mv_threshold_sq": cfg.mv_threshold_sq,
            "block_shift": cfg.block_shift,
            "vectors_needed": cfg.vectors_needed,
            "clusters_needed": cfg.clusters_needed,
            "vertical_mask": cfg.vertical_mask,
            "frame_skip": frame_skip,
        }
    ckpt = ScanCheckpoint(checkpoint, identity) if checkpoint else None

    if payload == "sad":
        from ..ops.sad import pad_luma  # noqa: F401 (used in the feeder)

        hp = geom.padded_gh * cfg.block_size
        wp = geom.padded_gw * cfg.block_size
        # luma is H_p*W_p bytes/frame (~2MB at 1080p): cap the host
        # staging buffer at ~256MB, like the pipeline's SAD branch caps
        # its decode windows
        frames_per_device = max(4, min(
            frames_per_device,
            (256 << 20) // max(1, hp * wp) // max(1, data_size)))
        step = sharded_sad_scan_step(geom, cfg, mesh)
        luma_sharding = NamedSharding(mesh, P("data", None, None))
        valid_sharding = NamedSharding(mesh, P("data"))
    else:
        step = sharded_bits_scan_step(geom, cfg, mesh)
        bits_sharding = NamedSharding(mesh, P("data", None))
    global_batch = frames_per_device * data_size

    # --- host decode workers over the chunked timeline ---
    # decode is host-CPU-bound (ctypes releases the GIL) — size by the
    # cgroup-aware CPU budget like the per-video pipeline does, NOT by
    # accelerator count: one card on a many-core host would otherwise
    # starve the device behind two decode threads
    n_workers = decode_workers or max(2, min(8, system.detect_cpu_limit()))
    num_chunks = max(1, math.ceil(duration / cfg.chunk_duration_sec))
    n_workers = min(n_workers, num_chunks)
    tasks: queue.Queue = queue.Queue()
    resumed_ts: list[float] = []
    resumed_chunks = 0
    t = 0.0
    cid = 0
    while t < duration:
        if ckpt is not None and cid in ckpt.done:
            resumed_ts.extend(ckpt.done[cid])
            resumed_chunks += 1
        else:
            tasks.put(ScanTask(
                t, min(t + cfg.chunk_duration_sec, duration), cid))
        cid += 1
        t += cfg.chunk_duration_sec
    for _ in range(n_workers):
        tasks.put(None)

    results: queue.Queue = queue.Queue(maxsize=2 * n_workers)
    max_frames = int(math.ceil(cfg.chunk_duration_sec * max(fps, 1.0))) + 64
    timings = [native.ScanTiming() for _ in range(n_workers)]
    errors: list[Exception] = []

    if payload == "sad":
        # luma sub-scans are H*W bytes/frame: cap each native call like
        # the pipeline's SAD branch does; the cap-resume loop + per-part
        # feeding keep a 30s 1080p chunk from materializing ~1.5GB at
        # once (parts stream through the feeder as they decode)
        if cfg.chunk_frames_cap > 0:
            part_cap = cfg.chunk_frames_cap
        else:
            part_cap = max(16, (256 << 20) // max(1, width * height)
                           // max(1, n_workers))
        max_frames = min(max_frames, part_cap)

    def scan_chunk(r, widx, start, end, resume):
        if payload == "sad":
            return r.scan_luma(start, end, frame_skip=frame_skip,
                               max_frames=max_frames,
                               timing=timings[widx], resume=resume)
        return r.scan_bits(
            start, end, threshold_sq=cfg.mv_threshold_sq,
            block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
            y_min=geom.y_min, y_max=geom.y_max,
            vectors_needed=cfg.vectors_needed, frame_skip=frame_skip,
            max_frames=max_frames, timing=timings[widx], resume=resume)

    def worker(widx: int):
        try:
            r = native.VideoReader(input_path)
            while True:
                task = tasks.get()
                if task is None:
                    break
                # resume past the frame cap (VFR bursts / the sad
                # payload's memory cap), streaming each sub-scan to the
                # feeder as a PART: (chunk_id, data, pts, first, last,
                # carry).  resume=True continues decode from the exact
                # stream position with the skip counter carried, keeping
                # the analyzed frame set identical to an uncapped chunk
                # scan (the reference's one counter per chunk,
                # motion_scanner.cpp:314,356-357); the chunk stays one
                # checkpoint attribution unit via the feeder's
                # first/last accounting.  A part emits even when empty:
                # an empty first part is an empty chunk, an empty later
                # part closes the chunk's accounting.
                resume = False
                first = True
                carry = None
                while True:
                    data, pts = scan_chunk(r, widx, task.start, task.end,
                                           resume)
                    last = len(pts) < max_frames
                    results.put((task.chunk_id, data, pts, first, last,
                                 carry))
                    if last:
                        break
                    # the part's last analyzed frame is the next part's
                    # predecessor (sad payload); bits parts need no carry
                    carry = (data[-1].copy() if payload == "sad"
                             else None)
                    first = False
                    resume = True
            r.close()
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            results.put(None)

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"archive-{i}")
               for i in range(n_workers)]
    for th in threads:
        th.start()

    # --- feeder: pack frames into sharded global batches ---
    if payload == "sad":
        rows = frames_per_device           # rows per shard
        buf = np.zeros((global_batch, hp, wp), np.uint8)
        # per-frame "has a true predecessor" mask (False at chunk starts,
        # carry placeholders, and batch padding) and per-shard carries
        valid = np.ones((global_batch,), bool)
        carries = np.zeros((data_size, hp, wp), np.uint8)
        prev_tail = np.zeros((hp, wp), np.uint8)  # last fed row overall
    else:
        buf = np.zeros((global_batch, lanes), np.uint8)
    buf_pts = np.zeros((global_batch,), np.float64)
    fill = 0
    motion_ts: list[float] = list(resumed_ts)
    frames_scanned = 0
    dispatches = 0
    # chunk attribution for checkpointing: spans of the current buffer
    # belonging to each chunk, plus per-chunk completion accounting.
    # Parts stream in, so a chunk completes when its last part has been
    # seen (not in chunk_open) AND all its fed frames have flushed
    # (chunk_left == 0).
    spans: list[tuple[int, int, int]] = []        # (chunk_id, buf_lo, n)
    chunk_left: dict[int, int] = {}
    chunk_motion: dict[int, list[float]] = {}
    chunk_open: set[int] = set()
    tail_cid = -1   # chunk id owning the most recently fed buffer row

    def maybe_complete(cid):
        if cid not in chunk_open and chunk_left.get(cid) == 0:
            # pop even without a checkpoint: the dict would otherwise
            # retain a second copy of every motion timestamp for the
            # whole (possibly days-long) scan
            del chunk_left[cid]
            done_ts = chunk_motion.pop(cid)
            if ckpt is not None:
                ckpt.record(cid, done_ts)

    def flush(n_valid: int):
        nonlocal dispatches, prev_tail
        if errors:
            spans.clear()
            return
        if n_valid == 0:
            return
        dispatches += 1
        try:
            if payload == "sad":
                valid[n_valid:] = False
                # shard d's carry = the frame just before its first row
                # in feed order: buf[d*rows - 1] in-batch, the previous
                # batch's last fed row for shard 0 (content is unread
                # wherever valid is False)
                carries[0] = prev_tail
                for d in range(1, data_size):
                    carries[d] = buf[d * rows - 1]
                motion, _ = step(
                    jax.device_put(carries, luma_sharding),
                    jax.device_put(buf, luma_sharding),
                    jax.device_put(valid, valid_sharding))
            else:
                motion, _ = step(jax.device_put(buf, bits_sharding))
            m = np.asarray(motion)[:n_valid]
            motion_ts.extend(buf_pts[:n_valid][m].tolist())
            for cid, lo, n in spans:
                sel = m[lo:lo + n]
                chunk_motion[cid].extend(buf_pts[lo:lo + n][sel].tolist())
                chunk_left[cid] -= n
                maybe_complete(cid)
            if payload == "sad":
                prev_tail = buf[n_valid - 1].copy()
                valid[:] = True
        except Exception as e:  # noqa: BLE001 — drain workers, raise after
            errors.append(e)
        spans.clear()
        buf[:] = 0

    done = 0
    while done < n_workers:
        item = results.get()
        if item is None:
            done += 1
            continue
        if errors:
            continue  # drain only
        cid, data, pts, first_part, last_part, carry = item
        frames_scanned += len(pts)
        if first_part:
            chunk_left[cid] = 0
            chunk_motion[cid] = []
            chunk_open.add(cid)
        if last_part:
            chunk_open.discard(cid)
        if len(pts) == 0:
            # empty chunk, or the empty closing part of a capped chunk
            maybe_complete(cid)
            continue
        chunk_left[cid] += len(pts)
        if payload == "sad":
            data = pad_luma(data, geom, cfg.block_size)
            if carry is not None and tail_cid != cid:
                # continuation part whose predecessor is NOT the row fed
                # just before it (another chunk's part interleaved):
                # inject the shipped carry as a placeholder row — scored
                # never (valid False), attributed to no span — purely so
                # the next row's in-shard predecessor is the right frame
                if fill == global_batch:
                    flush(global_batch)
                    fill = 0
                buf[fill] = pad_luma(carry[None], geom,
                                     cfg.block_size)[0]
                valid[fill] = False
                fill += 1
        off = 0
        while off < len(pts):
            take = min(global_batch - fill, len(pts) - off)
            if payload == "sad":
                buf[fill:fill + take] = data[off:off + take]
                if first_part and off == 0:
                    # the chunk's first analyzed frame has no
                    # predecessor and is never motion (SADDetector
                    # contract, models/sad_detector.py)
                    valid[fill] = False
            else:
                buf[fill:fill + take, :used] = \
                    data[off:off + take].reshape(take, used)
            buf_pts[fill:fill + take] = pts[off:off + take]
            spans.append((cid, fill, take))
            fill += take
            off += take
            tail_cid = cid
            if fill == global_batch:
                flush(global_batch)
                fill = 0
    flush(fill)

    for th in threads:
        th.join()
    if errors:
        raise RuntimeError(errors[0])

    frames_with_mvs = sum(t.frames_with_mvs for t in timings)
    if payload == "bits" and frames_scanned and not frames_with_mvs:
        # payload='auto' (the default) routes such streams to the
        # sharded SAD payload up front; this can only trigger when a
        # caller FORCED bits (MVT_PIPELINE=mv) on an MV-less stream —
        # stay loud rather than silently report a motionless archive
        log.warn(
            f"none of the {frames_scanned} scanned frames carried MV "
            "side data (intra-only stream, or a codec this FFmpeg "
            "cannot export MVs for — HEVC needs FFmpeg >= 7): the "
            "forced bits payload cannot detect motion on this input; "
            "use MVT_PIPELINE=sad (payload='sad') or the auto default")
    timestamps = oracle.merge_timestamps(motion_ts)
    segments = oracle.segments_from_timestamps(
        timestamps, max_gap_sec=cfg.max_gap_sec,
        padding_sec=cfg.padding_sec, duration=duration)
    stats = {
        "frames_scanned": frames_scanned,
        "frames_with_mvs": frames_with_mvs,
        "motion_frames": int(timestamps.size),
        "dispatches": dispatches,
        "payload": payload,
        "mesh": dict(mesh.shape),
        "global_batch": global_batch,
        "resumed_chunks": resumed_chunks,
        # summed across decode workers (wall-clock overlaps) — the same
        # seek/decode/analyze split the pipeline's phase tree reports
        # (reference motion_scanner.cpp:318-380 out-params)
        "worker_us": {
            "seek": sum(t.seek_us for t in timings),
            "decode": sum(t.decode_us for t in timings),
            "analyze": sum(t.analyze_us for t in timings),
        },
    }
    log.info(f"archive scan ({payload}): {frames_scanned} frames over "
             f"mesh {dict(mesh.shape)} in {dispatches} dispatches")
    return segments, duration, stats
