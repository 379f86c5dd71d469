"""doctor — one-command environment & capability report.

The reference makes its environment demands implicitly: the Dockerfile
builds FFmpeg 8 from source because stock distros cannot export HEVC
motion vectors (reference Dockerfile:46-65), and a silently degraded
install just produces wrong/empty results.  ``motion_doctor`` makes every
capability explicit BEFORE a production run:

* native media library loads, ABI matches, linked libav* versions;
* H.264 motion-vector export (the core scan input) actually works;
* HEVC motion-vector export (FFmpeg >= 7) — WARN, not FAIL, when absent
  because the single-file pipeline auto-falls back to the pixel-domain
  SAD detector (archive mode cannot);
* stream-copy remux cut produces a decodable output;
* JAX device inventory, default backend, mesh construction;
* a full end-to-end trim on a synthesized clip (oracle backend — no
  device compile needed; ``--device`` additionally runs one real device
  scan, which pays the jit compile).

Exit code = number of FAILed checks (0 when everything required works).
``--json`` prints machine-readable records instead of the table.

Usage: python -m mvtrim_tpu.tools.doctor [--json] [--device]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile


def _check_native() -> dict:
    import ctypes

    from ..io import native
    lib = native._load_library()
    lib.mvt_version.restype = ctypes.c_char_p
    ver = lib.mvt_version().decode()
    return {"name": "native-library", "status": "ok",
            "detail": f"{ver}, ABI {native._ABI_VERSION}"}


def _check_libav() -> dict:
    from ..io import native
    vers = native.libav_versions()
    avcodec_major = int(vers["avcodec"].split(".")[0])
    detail = ", ".join(f"{k} {v}" for k, v in vers.items())
    if avcodec_major >= 61:  # FFmpeg >= 7
        return {"name": "libav", "status": "ok",
                "detail": detail + " (HEVC MV export supported)"}
    return {"name": "libav", "status": "warn",
            "detail": detail + " — FFmpeg < 7: no HEVC MV export; HEVC "
            "inputs use the SAD fallback (single-file mode only)"}


def _check_h264_mv() -> dict:
    from ..io import native
    codec = native.synth_codec()
    with tempfile.TemporaryDirectory() as td:
        clip = os.path.join(td, "probe.mp4")
        native.synthesize(clip, width=160, height=128, fps=25.0,
                          duration=1.0, codec=codec,
                          motion_windows=((0.0, 1.0),))
        with native.VideoReader(clip) as r:
            tm = native.ScanTiming()
            r.scan_grids(0.0, 2.0, threshold_sq=0.0, block_shift=4,
                         gw=10, gh=8, y_min=0, y_max=8, max_frames=30,
                         timing=tm)
    if tm.frames_with_mvs > 0 and codec == "libx264":
        return {"name": "h264-mv-export", "status": "ok",
                "detail": f"{tm.frames_with_mvs} MV frames from a 1s probe"}
    if tm.frames_with_mvs > 0:
        return {"name": "h264-mv-export", "status": "warn",
                "detail": f"no libx264 encoder to make an H.264 probe; "
                f"{tm.frames_with_mvs} MV frames from a 1s {codec} probe"}
    return {"name": "h264-mv-export", "status": "fail",
            "detail": f"decoded {codec} frames carry no MV side data — the "
            "MV scan path is broken on this libavcodec"}


def _check_hevc_mv() -> dict:
    from ..io import native
    if native.hevc_mv_export_capable():
        return {"name": "hevc-mv-export", "status": "ok",
                "detail": "HEVC frames carry MV side data"}
    if int(native.libav_versions()["avcodec"].split(".")[0]) >= 61:
        return {"name": "hevc-mv-export", "status": "warn",
                "detail": "FFmpeg >= 7 is linked, but without an HEVC "
                "encoder (libx265) no probe clip can be made: HEVC MV "
                "export is not verified"}
    return {"name": "hevc-mv-export", "status": "warn",
            "detail": "no HEVC MV side data (needs FFmpeg >= 7; see the "
            "Dockerfile) — HEVC inputs fall back to the SAD detector"}


def _check_cut() -> dict:
    from ..io import native
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "src.mp4")
        dst = os.path.join(td, "dst.mp4")
        native.synthesize(src, width=160, height=128, fps=25.0,
                          duration=4.0, codec=native.synth_codec(),
                          motion_windows=((0.0, 4.0),))
        native.cut(src, dst, [(0.5, 2.5)])
        with native.VideoReader(dst) as r:
            dur = r.duration
    # a 2s segment may stretch to ~3s from keyframe anchoring, but a cut
    # that ignored the segment list and copied the whole 4s stream (the
    # most plausible cut regression) must FAIL, so the bound sits below 4
    if 0.5 <= dur <= 3.5:
        return {"name": "remux-cut", "status": "ok",
                "detail": f"2s segment remuxed, output decodes ({dur:.2f}s)"}
    return {"name": "remux-cut", "status": "fail",
            "detail": f"cut output duration {dur:.2f}s outside [0.5, 3.5] "
                      f"(expected ~2s for a 2s segment of a 4s source)"}


def _check_jax() -> dict:
    import jax
    devs = jax.devices()
    dev = devs[0]
    detail = (f"jax {jax.__version__}, {len(devs)} x {dev.platform} "
              f"({dev.device_kind})")
    if dev.platform == "cpu":
        return {"name": "jax-devices", "status": "warn",
                "detail": detail + " — CPU only: scans are correct, but "
                "no time from this host is a device measurement"}
    return {"name": "jax-devices", "status": "ok", "detail": detail}


def _check_mesh() -> dict:
    from ..parallel.mesh import build_mesh
    mesh = build_mesh()
    return {"name": "device-mesh", "status": "ok",
            "detail": f"mesh {dict(mesh.shape)} over "
                      f"{mesh.devices.size} device(s)"}


def _check_e2e(device: bool) -> dict:
    import contextlib
    import io

    from ..core.config import Config
    from ..pipeline.pipeline import ProcessingPipeline
    backend = "auto" if device else "oracle"
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "e2e.mp4")
        dst = os.path.join(td, "out.mp4")
        from ..io import native
        codec = native.synth_codec()
        native.synthesize(src, width=320, height=240, fps=25.0,
                          duration=8.0, codec=codec,
                          motion_windows=((1.0, 3.0),))
        # mpeg4 has one MV per 16x16 macroblock: one vote per grid cell
        cfg = Config(scan_backend=backend, min_savings_pct=5.0,
                     vectors_needed=2 if codec == "libx264" else 1)
        # the doctor's report is the output; swallow the run's own logs
        with contextlib.redirect_stdout(io.StringIO()):
            rc = ProcessingPipeline(src, dst, stream_id=-1, num_threads=2,
                                    cfg=cfg).run()
        if rc != 0:
            return {"name": f"end-to-end ({backend})", "status": "fail",
                    "detail": f"pipeline exit code {rc}"}
        if not os.path.exists(dst):
            return {"name": f"end-to-end ({backend})", "status": "fail",
                    "detail": "no output produced for a clip with motion"}
        with native.VideoReader(dst) as r:
            dur = r.duration
    return {"name": f"end-to-end ({backend})", "status": "ok",
            "detail": f"8s clip with a 2s motion window trimmed to "
                      f"{dur:.1f}s"}


def _check_compile_cache() -> dict:
    from .. import COMPILE_CACHE_DIR
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    origin = ("in the checkout" if d == COMPILE_CACHE_DIR
              else "from JAX_COMPILATION_CACHE_DIR")
    return {"name": "compile-cache", "status": "ok",
            "detail": f"{d} ({origin})"}


def run_checks(device: bool = False) -> list[dict]:
    e2e_name = f"end-to-end ({'auto' if device else 'oracle'})"
    # explicit names so a CRASHED probe reports under the same key its
    # success path would (--json consumers key checks by name)
    checks = [
        ("native-library", _check_native),
        ("libav", _check_libav),
        ("h264-mv-export", _check_h264_mv),
        ("hevc-mv-export", _check_hevc_mv),
        ("remux-cut", _check_cut),
        ("jax-devices", _check_jax),
        ("device-mesh", _check_mesh),
        ("compile-cache", _check_compile_cache),
        (e2e_name, lambda: _check_e2e(device)),
    ]
    out = []
    for name, fn in checks:
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 — a probe crash IS the finding
            out.append({"name": name, "status": "fail",
                        "detail": f"{type(e).__name__}: {e}"})
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    as_json = "--json" in argv
    device = "--device" in argv
    results = run_checks(device=device)
    fails = sum(r["status"] == "fail" for r in results)
    if as_json:
        print(json.dumps({"checks": results, "failures": fails}, indent=2))
    else:
        tag = {"ok": "[ OK ]", "warn": "[WARN]", "fail": "[FAIL]"}
        for r in results:
            print(f"{tag[r['status']]} {r['name']:<22} {r['detail']}")
        warns = sum(r["status"] == "warn" for r in results)
        print(f"\n{len(results)} checks: {len(results) - fails - warns} ok, "
              f"{warns} warnings, {fails} failures")
    return fails


if __name__ == "__main__":
    sys.exit(main())
