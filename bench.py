"""Benchmark: 1080p motion-scan throughput per device, roofline-audited.

Measures the device scan stage — the replacement for the reference's
check_frame hot loop (motion_scanner.cpp:217-295) — over device-resident
1080p activity masks in the word layout (the default ``bits`` path) with
the default detector config.  Prints ONE JSON line on stdout:
{"metric", "value", "unit", "impl", "device", ...audit fields}.

Methodology (designed so the number CANNOT exceed physics):
  * the timed region is ONE dispatch of a fori_loop chain in which every
    iteration's motion decisions feed an int32 accumulator, and the
    accumulator is fetched to the host inside the window — a data
    dependency on every byte of every iteration's input;
  * iterations rotate over 8 distinct device buffers, so device memory
    is re-read every iteration;
  * the accumulator is checked against the NumPy oracle's motion count
    (compute proof), and on an accelerator the implied bandwidth is
    checked against the device's HBM roofline (physics proof).  A number
    failing either check is re-measured once with 4x iterations and
    flagged if still invalid.

The roofline table is keyed by ``device_kind``; an accelerator missing
from it is an error, and a CPU run reports no roofline share.  The
redesign into end-to-end cells is separate work (ROADMAP.md).
"""

import json
import os
import sys
import time

import numpy as np

# HBM bandwidth per device kind, GB/s (NVIDIA H100 SXM data sheet:
# 3.35 TB/s).  Unknown accelerators are an error, not a default.
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def _roofline_gbps(dev) -> float | None:
    """HBM roofline of ``dev``; None on the CPU (no device metric)."""
    if dev.platform == "cpu":
        return None
    try:
        return HBM_GBPS[dev.device_kind]
    except KeyError:
        raise SystemExit(
            f"no HBM roofline for device kind {dev.device_kind!r}; add it "
            f"to bench.HBM_GBPS with its data-sheet source") from None


def _chained_bench(op, stacked, iters):
    """Time `iters` chained invocations of op over rotating buffers.

    Returns (seconds_per_iter, device_motion_total).  The returned total
    is the host-fetched accumulator — fetching it synchronizes on every
    iteration in the chain.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    k = stacked.shape[0]

    @jax.jit
    def chain(stacked, acc, n):
        def body(i, acc):
            _, motion = op(stacked[i % k])
            return acc + jnp.sum(motion.astype(jnp.int32))
        return lax.fori_loop(0, n, body, acc)

    # warmup: compile + one full run
    int(chain(stacked, jnp.int32(0), iters))
    t0 = time.perf_counter()
    total = int(chain(stacked, jnp.int32(0), iters))
    dt = time.perf_counter() - t0
    return dt / iters, total


def _expected_total(motion_per_buf, k, iters):
    full, rem = divmod(iters, k)
    return int(sum(int(m) * (full + (1 if i < rem else 0))
                   for i, m in enumerate(motion_per_buf)))


def _audit(name, fps, bytes_per_frame, roofline_gbps, checksum_ok):
    implied = fps * bytes_per_frame / 1e9
    if roofline_gbps is None:
        print(f"{name}: {fps:,.0f} frames/s (CPU run: no roofline) | "
              f"checksum {'ok' if checksum_ok else 'MISMATCH'}",
              file=sys.stderr)
        return checksum_ok, implied, None
    pct = 100.0 * implied / roofline_gbps
    ok = checksum_ok and implied <= roofline_gbps * 1.05
    print(f"{name}: {fps:,.0f} frames/s | implied {implied:,.1f} GB/s "
          f"({pct:.0f}% of {roofline_gbps:.0f} GB/s roofline) | "
          f"checksum {'ok' if checksum_ok else 'MISMATCH'}"
          f"{'' if ok else ' | INVALID'}", file=sys.stderr)
    return ok, implied, pct


def _words_stack(rng, geom, cfg, k, b):
    """k device buffers of b random frames in the word layout, and the
    oracle's motion count for each buffer."""
    from mvtrim_tpu.core import oracle
    from mvtrim_tpu.ops import cluster as cluster_ops

    grids = rng.integers(0, 6, size=(k, b, geom.gh, geom.gw),
                         dtype=np.uint8)
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    motion = [int((oracle.count_clusters_batch(
        g, vectors_needed=cfg.vectors_needed,
        y_min=geom.y_min, y_max=geom.y_max) >= need).sum()) for g in grids]
    packed = np.packbits(grids >= cfg.vectors_needed, axis=3,
                         bitorder="little")
    _, used, lanes = cluster_ops.word_geometry(geom)
    flat = np.zeros((k, b, lanes), np.int32)
    flat[:, :, :used] = cluster_ops.repack_bits_words(
        packed.reshape(k * b, geom.gh, -1), geom).reshape(k, b, used)
    return grids, motion, flat


def main() -> int:
    import jax

    from mvtrim_tpu.core.config import Config
    from mvtrim_tpu.core.types import GridGeometry
    from mvtrim_tpu.ops import cluster as cluster_ops

    dev = jax.devices()[0]
    roofline = _roofline_gbps(dev)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device} (HBM roofline {roofline} GB/s)",
          file=sys.stderr)

    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    rng = np.random.default_rng(0)
    K = 8
    B = int(os.environ.get("MVT_BENCH_B", 8192))
    ITERS = int(os.environ.get("MVT_BENCH_ITERS", 4096))

    def run(name, op, buf, motion_per_buf, bytes_per_frame, b, iters):
        dt, total = _chained_bench(op, buf, iters)
        ok = total == _expected_total(motion_per_buf, K, iters)
        valid, implied, pct = _audit(name, b / dt, bytes_per_frame,
                                     roofline, ok)
        if not valid:  # re-measure once with a longer window
            dt, total = _chained_bench(op, buf, iters * 4)
            ok = total == _expected_total(motion_per_buf, K, iters * 4)
            valid, implied, pct = _audit(f"{name}(re)", b / dt,
                                         bytes_per_frame, roofline, ok)
        return b / dt, implied, pct, valid, ok

    # --- headline: the word-domain product path (MVT_SCAN_INPUT=bits) ---
    grids, motion_per_buf, flatw = _words_stack(rng, geom, cfg, K, B)
    word_bytes = flatw.shape[-1] * 4
    op = cluster_ops.make_cluster_words_op_xla(geom, cfg.clusters_needed)
    fps, gbps, pct, valid, ok = run("words xla", op,
                                    jax.device_put(flatw), motion_per_buf,
                                    word_bytes, B, ITERS)
    rec = {
        "metric": "1080p_scan_frames_per_sec_per_device",
        "unit": "frames/s",
        "impl": "xla-words",
        "device": device,
        "roofline_gbps": roofline,
        "bytes_per_frame": word_bytes,
        "audit": "single-launch resident accumulator, oracle checksum"
                 + (", roofline gate" if roofline else ""),
    }
    if valid:
        rec.update(value=round(fps), implied_gbps=round(gbps, 1))
        if pct is not None:
            rec["pct_of_roofline"] = round(pct, 1)
    else:
        # never pass off an unaudited number as the metric of record
        rec.update(value=0, audit_failed=True, unaudited_fps=round(fps),
                   checksum_ok=bool(ok))

    # --- secondaries (stderr): uint8 vote grids, and 4K words ---
    try:
        padded = np.zeros((K, B, geom.padded_gh, geom.padded_gw), np.uint8)
        padded[:, :, :geom.gh, :geom.gw] = grids
        op_grids = cluster_ops.make_cluster_op_xla(
            geom, cfg.vectors_needed, cfg.clusters_needed)
        run("grids xla", op_grids, jax.device_put(padded), motion_per_buf,
            geom.padded_gh * geom.padded_gw, B, ITERS // 4)
    except Exception as e:  # noqa: BLE001 — secondary is best-effort
        print(f"grids xla bench skipped: {e}", file=sys.stderr)
    try:
        geom4k = GridGeometry.build(3840, 2160, cfg)
        B4 = B // 4
        _, motion4k, flat4k = _words_stack(rng, geom4k, cfg, K, B4)
        op4k = cluster_ops.make_cluster_words_op_xla(geom4k,
                                                     cfg.clusters_needed)
        run("words xla 4K", op4k, jax.device_put(flat4k), motion4k,
            flat4k.shape[-1] * 4, B4, ITERS)
    except Exception as e:  # noqa: BLE001 — secondary is best-effort
        print(f"4K words bench skipped: {e}", file=sys.stderr)

    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
