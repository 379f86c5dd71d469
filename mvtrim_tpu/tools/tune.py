"""tune — sweep detector configs over one decode of a video.

Scans the clip once — the native layer scatters one vote grid per
MV_THRESHOLD_SQ candidate during decode (mvt_scan_grids_multi) — then
scores every (threshold, VECTORS_NEEDED, CLUSTERS_NEEDED) combination with
the vote-sweep device op (ops/sweep.py), reporting motion frames, segment
count and savings per config.

The reference needs one full re-run per candidate; here a K-config grid
costs one decode plus K tiny device reductions: H2D is K*gh*gw bytes per
frame instead of the raw-MV export's max_mv*8.

Usage:
  python -m mvtrim_tpu.tools.tune input.mp4 \
      [--thresholds 4,16,64] [--vectors 1,2,4] [--clusters 1,2,4]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from ..core import oracle
from ..core.config import Config
from ..core.types import GridGeometry
from ..io import native
from ..ops.sweep import make_vote_sweep_op


def sweep(input_path: str, thresholds, vectors, clusters, *,
          cfg: Config | None = None, batch_frames: int = 512,
          device_stats: bool = False,
          scan_input: str = "grids", mesh=None) -> list[dict]:
    """Score every config combination over one decode.

    ``device_stats=False`` (default): per-batch motion booleans come back
    to the host and segmentation/savings run through the float64 oracle —
    bit-exact with what a pipeline run at that config would decide.

    ``device_stats=True``: motion stays device-resident for the whole
    scan; at the end ONE vmapped dispatch of the streaming segmentation
    op (ops/segmentation.py lax.scan carry) produces the entire
    (threshold x config) stats table — segment counts, kept seconds,
    savings — with a single host round trip.  Timestamps are f32 on
    device, so savings can differ from the oracle in the last decimals;
    use it for tuning sweeps, not for cut lists.

    ``scan_input`` picks the H2D payload, like the pipeline's
    MVT_SCAN_INPUT: 'grids' scatters one vote grid per threshold during
    decode (mvt_scan_grids_multi — K*gh*gw bytes/frame, near-zero device
    math per config); 'mv_raw' exports raw MV fields once and sweeps the
    magnitude thresholds as device data (ops/sweep.make_mv_sweep_op) —
    for hosts where the scatter CPU is the constraint.  Identical
    decisions either way (the integer bound reproduces the double
    threshold compare exactly — ops/mv_vote.threshold_bound).

    ``mesh`` (a jax.sharding.Mesh with 'data'/'sweep' axes, e.g. from
    parallel.mesh.build_mesh) shards the scoring across cards: frames
    over 'data', (vectors, clusters) pairs over 'sweep', one
    sharded_scan_step dispatch per (batch, threshold) — the multi-card
    sweep the reference would need one box-wide re-run per config for.
    Decisions are identical to the single-device path (asserted in
    tests/test_sweep.py on the 8-device CPU mesh).
    """
    import jax

    cfg = cfg or Config.from_env()
    thresholds = list(thresholds)
    vc_pairs = [(v, c) for v in vectors for c in clusters]
    # the reference stores VECTORS_NEEDED as uint8 (config.hpp:74) and
    # Config.__post_init__ wraps to match; sweeping the raw value would
    # score configs the reference cannot express (256 vs 0, -1 vs 255)
    vec_needs = np.asarray([v & 0xFF for v, _ in vc_pairs], np.int32)
    clust_needs = np.asarray([c for _, c in vc_pairs], np.int32)
    # effective vec == 0: zero votes satisfy >= 0, but the reference
    # still decides MV-less frames False before phase 2 runs
    # (motion_scanner.cpp:219-221) — those frames need masking because
    # a zero vote grid cannot carry the distinction
    vec0 = vec_needs == 0

    reader = native.VideoReader(input_path)
    duration, fps = reader.duration, reader.fps
    geom = GridGeometry.build(reader.width, reader.height, cfg)
    frame_skip = cfg.frame_skip(fps)
    gh_p, gw_p = geom.padded_gh, geom.padded_gw

    # motion_ts[(threshold index, vc index)] -> timestamps (host path)
    motion_ts: dict[tuple[int, int], list[float]] = {
        (ti, vi): [] for ti in range(len(thresholds))
        for vi in range(len(vc_pairs))
    }
    # device path: per-threshold lists of (motion device array, n_valid)
    dev_motion: list[list] = [[] for _ in thresholds]
    all_pts: list[np.ndarray] = []

    if scan_input == "mv_raw":
        if mesh is not None:
            raise ValueError("--mesh supports the grids scan input only")
        _sweep_mv_raw(reader, cfg, geom, thresholds, vc_pairs,
                      frame_skip, batch_frames, device_stats,
                      motion_ts, dev_motion, all_pts)
    else:
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..parallel.mesh import sharded_scan_step

            data_size = mesh.shape["data"]
            sweep_size = mesh.shape["sweep"]
            # frames pad to the data axis, configs to the sweep axis;
            # pad configs score with clusters_needed = INT32_MAX so they
            # decide False and slice off
            batch_frames = ((batch_frames + data_size - 1)
                            // data_size) * data_size
            kp = ((len(vc_pairs) + sweep_size - 1)
                  // sweep_size) * sweep_size
            vec_p = np.ones((kp,), np.int32)
            clu_p = np.full((kp,), np.iinfo(np.int32).max, np.int32)
            vec_p[:len(vc_pairs)] = vec_needs
            clu_p[:len(vc_pairs)] = np.maximum(1, clust_needs)
            step = sharded_scan_step(geom, cfg, mesh, sweep_clusters=True)
            votes_sh = NamedSharding(mesh, P("data", None, None))
            cfg_sh = NamedSharding(mesh, P("sweep"))
            vec_dev = jax.device_put(vec_p, cfg_sh)
            clu_dev = jax.device_put(clu_p, cfg_sh)

            def score(batch):
                m, _ = step(jax.device_put(batch, votes_sh),
                            vec_dev, clu_dev)
                return m[:, :len(vc_pairs)]
        else:
            op = make_vote_sweep_op(geom)

            def score(batch):
                return op(batch, vec_needs, clust_needs)
        import jax.numpy as jnp

        cap = int(math.ceil(cfg.chunk_duration_sec * max(fps, 1.0))) + 64
        cur = native.ChunkScanCursor(duration, cfg.chunk_duration_sec, cap)
        # Host path: one staging buffer for the whole sweep — each
        # dispatch is resolved (np.asarray) before the next overwrite.
        # device_stats path: dispatches stay LAZY until the end and the
        # CPU backend may alias numpy buffers zero-copy, so reuse would
        # feed later batches' data to earlier dispatches (caught by
        # test_device_stats_matches_host_path) — allocate per dispatch.
        batch = (None if device_stats
                 else np.zeros((batch_frames, gh_p, gw_p), np.uint8))
        while cur.more():
            start, end = cur.window()
            grids, pts, has_mv = reader.scan_grids_multi(
                start, end, thresholds_sq=thresholds,
                block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
                y_min=geom.y_min, y_max=geom.y_max,
                frame_skip=frame_skip, max_frames=cap, resume=cur.resume)
            cur.advance(len(pts))
            if len(pts) == 0:
                continue
            if device_stats:
                all_pts.append(pts)
            for lo in range(0, len(pts), batch_frames):
                hi = min(lo + batch_frames, len(pts))
                if vec0.any():
                    # reference `!sd -> false` for the vec==0 columns
                    # (zero grids cannot represent "no side data")
                    allow = np.ones((batch_frames, len(vc_pairs)), bool)
                    allow[:hi - lo] = has_mv[lo:hi, None] | ~vec0[None, :]
                for ti in range(len(thresholds)):
                    if device_stats:
                        batch = np.zeros((batch_frames, gh_p, gw_p),
                                         np.uint8)
                    else:
                        batch[hi - lo:, :geom.gh, :geom.gw] = 0
                    batch[:hi - lo, :geom.gh, :geom.gw] = grids[lo:hi, ti]
                    motion = score(batch)
                    if vec0.any():
                        motion = motion & jnp.asarray(allow)
                    if device_stats:
                        # async dispatch; resolution happens on-device at
                        # the end via the segmentation op — no host round
                        # trip
                        dev_motion[ti].append((motion, hi - lo))
                    else:
                        motion = np.asarray(motion)
                        for vi in range(len(vc_pairs)):
                            sel = motion[:hi - lo, vi]
                            motion_ts[(ti, vi)].extend(
                                pts[lo:hi][sel].tolist())
    reader.close()

    def make_row(ti, vi):
        vec, clu = vc_pairs[vi]
        return {"mv_threshold_sq": thresholds[ti],
                "vectors_needed": vec, "clusters_needed": clu}

    if device_stats:
        return _device_stats_rows(thresholds, len(vc_pairs), dev_motion,
                                  all_pts, duration, cfg, make_row)
    return _host_rows(thresholds, len(vc_pairs), motion_ts, duration,
                      cfg, make_row)


def _host_rows(thresholds, nvc, motion_ts, duration, cfg, make_row):
    """Exact (float64 oracle) stats table — shared by the MV routes and
    the SAD route; one definition so the routes cannot drift."""
    rows = []
    for ti in range(len(thresholds)):
        for vi in range(nvc):
            merged = oracle.merge_timestamps(motion_ts[(ti, vi)])
            segments = oracle.segments_from_timestamps(
                merged, max_gap_sec=cfg.max_gap_sec,
                padding_sec=cfg.padding_sec, duration=duration)
            _, saved_pct = oracle.savings(segments, duration)
            row = make_row(ti, vi)
            row.update(motion_frames=int(merged.size),
                       segments=len(segments),
                       saved_pct=round(saved_pct, 2))
            rows.append(row)
    return rows


def _device_stats_rows(thresholds, nvc, dev_motion, all_pts, duration,
                       cfg, make_row):
    """Device-resident stats tail (--device-stats): ONE vmapped dispatch
    of the streaming segmentation op (ops/segmentation.py) per threshold
    over the still-lazy motion columns.  Shared by the MV and SAD routes."""
    import jax
    import jax.numpy as jnp

    from ..ops.segmentation import make_segment_op

    # segment capacity: the gap rule bounds how many segments can fit
    max_segments = min(4096, int(duration /
                                 max(1e-6, cfg.max_gap_sec)) + 2)
    seg_op = make_segment_op(max_segments,
                             max_gap_sec=cfg.max_gap_sec,
                             padding_sec=cfg.padding_sec)
    ts = jnp.asarray(np.concatenate(all_pts) if all_pts
                     else np.zeros((1,)), jnp.float32)
    dur = jnp.float32(duration)

    def per_threshold(parts):
        motion = jnp.concatenate(
            [m[:n] for m, n in parts], axis=0)          # [N, K]
        starts, ends, count, kept = jax.vmap(
            lambda col: seg_op(ts, col, dur), in_axes=1)(motion)
        return count, kept, motion.sum(axis=0)

    rows = []
    for ti in range(len(thresholds)):
        if not dev_motion[ti]:
            count = kept = frames = np.zeros((nvc,))
        else:
            count, kept, frames = (np.asarray(x)
                                   for x in per_threshold(dev_motion[ti]))
        for vi in range(nvc):
            kept_s = float(kept[vi])
            saved = 100.0 * max(0.0, duration - kept_s) / duration \
                if duration > 0 else 0.0
            row = make_row(ti, vi)
            row.update(motion_frames=int(frames[vi]),
                       segments=int(count[vi]),
                       saved_pct=round(saved, 2), stats="device_f32")
            if int(count[vi]) >= max_segments:
                # capacity saturated: later segments were dropped, so
                # segments/saved_pct understate reality — mark the
                # row and tell the operator (host path has no cap)
                row["segments_saturated"] = True
                cfg_desc = " ".join(
                    f"{k}={v}" for k, v in make_row(ti, vi).items())
                print(f"tune: segment capacity {max_segments} "
                      f"saturated for {cfg_desc}; re-run without "
                      "--device-stats for exact stats", file=sys.stderr)
            rows.append(row)
    return rows


def sweep_sad(input_path: str, thresholds, clusters, *,
              cfg: Config | None = None, batch_frames: int = 512,
              device_stats: bool = False, mesh=None) -> list[dict]:
    """Score K (sad_threshold, clusters_needed) configs over ONE luma
    decode — the pixel-domain analog of sweep().

    The reference can only evaluate one config per full run
    (config.hpp single-triple-per-process) and has no pixel path at
    all; before this route the SAD fallback's ``sad_threshold`` could
    only be tuned by K full re-decodes.  Decisions are bit-identical
    to K independent SADDetector pipeline runs at each config
    (tests/test_sweep.py::TestSADSweep): same chunk independence (a
    chunk's first analyzed frame is never motion —
    models/sad_detector.py docstring), same carry threading across
    cap-resumed sub-scans, same integer SAD bound.  ``thresholds``
    are ``sad_threshold`` values (mean abs diff per pixel);
    ``vectors_needed`` does not exist on this path — a block is
    active iff its SAD sum clears the bound.

    ``mesh`` (a jax.sharding.Mesh with 'data'/'sweep' axes) shards the
    scoring like sweep()'s grids path: frames over 'data' with
    per-shard predecessor carries, (threshold, clusters) configs over
    'sweep' (parallel.mesh.sharded_sad_sweep_step).  Decisions are
    identical to the single-device path (tests/test_sweep.py on the
    8-device CPU mesh).
    """
    import jax
    import jax.numpy as jnp

    from ..ops.sad import pad_luma, sad_threshold_sum
    from ..ops.sweep import make_sad_sweep_op

    cfg = cfg or Config.from_env()
    thresholds = list(thresholds)
    clusters = list(clusters)
    nvc = len(clusters)
    # flattened config axis k = ti * nvc + vi (same layout as _sweep_mv_raw)
    bounds_k = np.asarray([sad_threshold_sum(t, cfg.block_size)
                           for t in thresholds for _ in clusters], np.int32)
    clus_k = np.asarray([c for _ in thresholds for c in clusters], np.int32)

    reader = native.VideoReader(input_path)
    duration, fps = reader.duration, reader.fps
    geom = GridGeometry.build(reader.width, reader.height, cfg)
    frame_skip = cfg.frame_skip(fps)
    hp = geom.padded_gh * cfg.block_size
    wp = geom.padded_gw * cfg.block_size
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import sharded_sad_sweep_step

        data_size = mesh.shape["data"]
        sweep_size = mesh.shape["sweep"]
        # frames pad to the data axis, configs to the sweep axis; pad
        # configs score with clusters_needed = INT32_MAX so they decide
        # False and slice off (same recipe as sweep()'s mesh path)
        batch_frames = ((batch_frames + data_size - 1)
                        // data_size) * data_size
        rows = batch_frames // data_size
        kk = len(bounds_k)
        kp = ((kk + sweep_size - 1) // sweep_size) * sweep_size
        bounds_p = np.zeros((kp,), np.int32)
        clus_p = np.full((kp,), np.iinfo(np.int32).max, np.int32)
        bounds_p[:kk] = bounds_k
        clus_p[:kk] = clus_k
        step = sharded_sad_sweep_step(geom, cfg, mesh)
        luma_sh = NamedSharding(mesh, P("data", None, None))
        cfg_sh = NamedSharding(mesh, P("sweep"))
        bounds_dev = jax.device_put(bounds_p, cfg_sh)
        clus_dev = jax.device_put(clus_p, cfg_sh)

        def score(batch):
            # batch rows: [predecessor] + batch_frames frames — shard
            # d's carry is the frame just before its first row, i.e.
            # combined row d*rows (a strided host view; ascontiguousarray
            # materializes the copy so the lazy dispatch never aliases
            # the reused staging buffer)
            carries = np.ascontiguousarray(batch[0:batch_frames:rows])
            m = step(jax.device_put(carries, luma_sh),
                     jax.device_put(batch[1:], luma_sh),
                     bounds_dev, clus_dev)
            return m[:, :kk]
    else:
        op = make_sad_sweep_op(geom, cfg.block_size)

        def score(batch):
            return op(batch, bounds_k, clus_k)

    motion_ts: dict[tuple[int, int], list[float]] = {
        (ti, vi): [] for ti in range(len(thresholds))
        for vi in range(nvc)}
    dev_motion: list[list] = [[] for _ in thresholds]
    all_pts: list[np.ndarray] = []

    # luma frames are H*W bytes: cap the per-call decode like the
    # pipeline's SAD branch (pipeline/pipeline.py "luma chunks are large")
    if cfg.chunk_frames_cap > 0:
        mem_cap = cfg.chunk_frames_cap
    else:
        mem_cap = max(16, (512 << 20) // max(1, reader.width *
                                             reader.height))
    cap = min(mem_cap,
              int(math.ceil(cfg.chunk_duration_sec * max(fps, 1.0))) + 64)
    cur = native.ChunkScanCursor(duration, cfg.chunk_duration_sec, cap)
    # Host path: one staging buffer, each dispatch resolved before the
    # next overwrite; device_stats dispatches stay LAZY so allocate per
    # dispatch (the CPU backend may alias numpy buffers zero-copy —
    # CLAUDE.md / test_device_stats_matches_host_path)
    batch = (None if device_stats
             else np.zeros((batch_frames + 1, hp, wp), np.uint8))
    luma_carry = None  # last analyzed frame of the prior sub-scan
    while cur.more():
        start, end = cur.window()
        if not cur.resume:
            # chunks are independent by design (SADDetector contract):
            # a chunk's first analyzed frame has no predecessor
            luma_carry = None
        data, pts = reader.scan_luma(start, end, frame_skip=frame_skip,
                                     max_frames=cap, resume=cur.resume)
        cur.advance(len(pts))
        if len(pts) == 0:
            continue
        if device_stats:
            all_pts.append(pts)
        padded = pad_luma(data, geom, cfg.block_size)
        carry_p = (None if luma_carry is None
                   else pad_luma(luma_carry[None], geom,
                                 cfg.block_size)[0])
        for lo in range(0, len(pts), batch_frames):
            hi = min(lo + batch_frames, len(pts))
            n = hi - lo
            if device_stats:
                batch = np.zeros((batch_frames + 1, hp, wp), np.uint8)
            else:
                batch[n + 1:] = 0
            # row 0 = predecessor.  At chunk start there is none: feed
            # the frame itself (diff 0) and force its row False below —
            # SADDetector's no-predecessor rule.  Cap-resumed sub-scans
            # and intra-scan batches diff against their real predecessor.
            if lo == 0:
                mask_first = carry_p is None
                batch[0] = padded[0] if mask_first else carry_p
            else:
                mask_first = False
                batch[0] = padded[lo - 1]
            batch[1:n + 1] = padded[lo:hi]
            motion = score(batch)[:n]
            if mask_first:
                allow = np.ones((n, len(clus_k)), bool)
                allow[0] = False
                motion = motion & jnp.asarray(allow)
            if device_stats:
                for ti in range(len(thresholds)):
                    dev_motion[ti].append(
                        (motion[:, ti * nvc:(ti + 1) * nvc], n))
            else:
                mnp = np.asarray(motion)
                for ti in range(len(thresholds)):
                    for vi in range(nvc):
                        sel = mnp[:, ti * nvc + vi]
                        motion_ts[(ti, vi)].extend(
                            pts[lo:hi][sel].tolist())
        luma_carry = data[-1].copy()
    reader.close()

    def make_row(ti, vi):
        return {"sad_threshold": thresholds[ti],
                "clusters_needed": clusters[vi]}

    if device_stats:
        return _device_stats_rows(thresholds, nvc, dev_motion, all_pts,
                                  duration, cfg, make_row)
    return _host_rows(thresholds, nvc, motion_ts, duration, cfg, make_row)


def _sweep_mv_raw(reader, cfg, geom, thresholds, vc_pairs, frame_skip,
                  batch_frames, device_stats, motion_ts, dev_motion,
                  all_pts) -> None:
    """One raw-MV decode, all (threshold, vec, clu) combos on device.

    Flattened config axis k = ti * len(vc_pairs) + vi; chunks whose MV
    count overflows MVT_MV_CAPACITY are re-decoded at a fitting capacity
    (exactness over speed — a truncated list is never scored).
    """
    import math as _math

    import numpy as np

    from ..ops.mv_vote import threshold_bound
    from ..ops.sweep import make_mv_sweep_op

    nvc = len(vc_pairs)
    bounds = np.asarray([threshold_bound(t) for t in thresholds
                         for _ in vc_pairs], np.int32)
    # uint8 wrap: same rationale as sweep()'s vec_needs
    vecs = np.asarray([v & 0xFF for _ in thresholds for v, _ in vc_pairs],
                      np.int32)
    clus = np.asarray([c for _ in thresholds for _, c in vc_pairs],
                      np.int32)
    op = make_mv_sweep_op(geom, cfg.block_shift)

    cap = int(_math.ceil(cfg.chunk_duration_sec
                         * max(reader.fps, 1.0))) + 64
    cur = native.ChunkScanCursor(reader.duration, cfg.chunk_duration_sec,
                                 cap)
    capm = cfg.mv_capacity
    fields = cnts = None
    marks = None  # rollback point: the current chunk's list lengths
    while cur.more():
        start, end = cur.window()
        if not cur.resume:
            marks = (len(all_pts), [len(x) for x in dev_motion],
                     {k: len(v) for k, v in motion_ts.items()})
        mvs, counts, pts = reader.scan_mvs(
            start, end, frame_skip=frame_skip, max_frames=cap,
            max_mv=capm, resume=cur.resume)
        if len(pts) and (counts < 0).any():
            # MV-capacity overflow: roll back any partial contributions
            # this chunk already scored, then restart the whole chunk
            # from a fresh seek at a fitting capacity
            del all_pts[marks[0]:]
            for lst, n in zip(dev_motion, marks[1]):
                del lst[n:]
            for k, n in marks[2].items():
                del motion_ts[k][n:]
            capm = 1 << int(np.ceil(np.log2(-counts.min())))
            cur.restart_chunk()
            continue
        cur.advance(len(pts))
        if len(pts) == 0:
            continue
        if device_stats:
            all_pts.append(pts)
        m = mvs.shape[1]
        if fields is None or fields.shape[1] != m:
            # host-path staging buffers live for the whole sweep
            # (reallocated only when an overflow restart raises the MV
            # capacity); each dispatch is resolved before the next
            # overwrite, so reuse is safe — unlike device_stats, whose
            # LAZY dispatches may alias numpy buffers on the CPU backend
            fields = np.zeros((batch_frames, m, 4), np.int32)
            cnts = np.zeros((batch_frames,), np.int32)
        for lo in range(0, len(pts), batch_frames):
            hi = min(lo + batch_frames, len(pts))
            if device_stats:
                fields = np.zeros((batch_frames, m, 4), np.int32)
                cnts = np.zeros((batch_frames,), np.int32)
            else:
                fields[hi - lo:] = 0
                cnts[hi - lo:] = 0
            fields[:hi - lo] = mvs[lo:hi]
            cnts[:hi - lo] = counts[lo:hi]
            motion = op(fields[..., 0], fields[..., 1], fields[..., 2],
                        fields[..., 3], cnts, bounds, vecs, clus)
            if device_stats:
                for ti in range(len(thresholds)):
                    dev_motion[ti].append(
                        (motion[:, ti * nvc:(ti + 1) * nvc], hi - lo))
            else:
                mnp = np.asarray(motion)
                for ti in range(len(thresholds)):
                    for vi in range(nvc):
                        sel = mnp[:hi - lo, ti * nvc + vi]
                        motion_ts[(ti, vi)].extend(
                            pts[lo:hi][sel].tolist())


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tune")
    parser.add_argument("input")
    parser.add_argument("--thresholds", default=None,
                        help="comma list of MV_THRESHOLD_SQ values "
                             "(default 4,16,64), or SAD_THRESHOLD values "
                             "with --scan-input sad (default 4,12,30)")
    parser.add_argument("--vectors", default=None,
                        help="comma list of VECTORS_NEEDED values "
                             "(default 1,2,4; MV routes only — the SAD "
                             "path has no vote counts)")
    parser.add_argument("--clusters", default="1,2,4")
    parser.add_argument("--device-stats", action="store_true",
                        help="compute the stats table with the device "
                             "segmentation op (one host round trip; f32)")
    parser.add_argument("--scan-input", default="grids",
                        choices=("grids", "mv_raw", "sad"),
                        help="scan payload: per-threshold vote grids "
                             "(default), raw MV fields with on-device "
                             "threshold sweeping, or decoded luma through "
                             "the pixel-domain SAD path (sweeps "
                             "sad_threshold x clusters_needed)")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="shard the sweep over an N-device mesh: "
                             "frames over 'data', configs over 'sweep' "
                             "(grids and sad inputs; mv_raw is "
                             "single-device)")
    parser.add_argument("--mesh-sweep", type=int, default=0, metavar="S",
                        help="sweep-axis size of the mesh (default: the "
                             "largest divisor of N not exceeding the "
                             "config-pair count)")
    args = parser.parse_args(argv)

    clusters = [int(x) for x in args.clusters.split(",")]

    def make_mesh(n_configs):
        if not args.mesh:
            return None
        from ..parallel.mesh import build_mesh
        s = args.mesh_sweep or max(
            d for d in range(1, args.mesh + 1)
            if args.mesh % d == 0 and d <= max(1, n_configs))
        return build_mesh(args.mesh, sweep=s)

    if args.scan_input == "sad":
        if args.vectors is not None:
            parser.error("--vectors does not apply to --scan-input sad "
                         "(the SAD path has no per-block vote counts)")
        thresholds = [float(x) for x in
                      (args.thresholds or "4,12,30").split(",")]
        # the SAD route flattens (threshold x clusters) onto one config
        # axis, so the whole grid shards over 'sweep'
        results = sweep_sad(args.input, thresholds, clusters,
                            device_stats=args.device_stats,
                            mesh=make_mesh(len(thresholds) * len(clusters)))
        print(json.dumps(results, indent=2))
        return 0

    thresholds = [float(x) for x in
                  (args.thresholds or "4,16,64").split(",")]
    vectors = [int(x) for x in (args.vectors or "1,2,4").split(",")]
    results = sweep(args.input, thresholds, vectors, clusters,
                    device_stats=args.device_stats,
                    scan_input=args.scan_input,
                    mesh=make_mesh(len(vectors) * len(clusters)))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
