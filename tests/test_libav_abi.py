"""The native library built against native/libav_abi.h.

Hosts without FFmpeg's development files but with an FFmpeg 8 runtime
(libavformat 62, libavcodec 62, libavutil 60; the opencv-python wheels
carry one) build the host library from the declarations in libav_abi.h.
These tests build that variant next to the one compiled against FFmpeg's
own headers and require the two to decode, cut and synthesize alike on
the same clips.  They skip where no FFmpeg 8 runtime is installed.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from mvtrim_tpu.io import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")

# One process per build: each loads its own libav.  Writes an .npz of
# everything the library reports about each clip.
DIGEST = r"""
import os, sys
import numpy as np
from mvtrim_tpu.io import native

out, work, clips = sys.argv[1], sys.argv[2], sys.argv[3:]
res = {}
for name, path in (c.split("=", 1) for c in clips):
    with native.VideoReader(path) as r:
        res[f"{name}/probe"] = np.array([r.duration, r.fps, r.width,
                                         r.height])
        res[f"{name}/time_base"] = np.array(r.time_base())
        res[f"{name}/stream_types"] = np.array(r.stream_types())
        for k, v in zip(("mvs", "counts", "pts"),
                        r.scan_mvs(0.0, r.duration + 1, max_frames=4096)):
            res[f"{name}/{k}"] = v
    with native.VideoReader(path, native.MVT_MODE_LUMA) as r:
        luma, pts = r.scan_luma(0.0, 2.0, max_frames=64)
        res[f"{name}/luma"], res[f"{name}/luma_pts"] = luma, pts
    with native.VideoReader(path, native.MVT_MODE_MV_FULL) as r:
        for k, v in enumerate(r.scan_mvs_full(0.0, r.duration + 1,
                                              max_frames=4096)):
            res[f"{name}/full{k}"] = np.asarray(v)
    for k, v in enumerate(native.inspect_packets(path)):
        res[f"{name}/packets{k}"] = np.asarray(v)
    cut = os.path.join(work, name + "_cut.mp4")
    native.cut(path, cut, [(1.0, 2.5), (4.0, 5.0)])
    for k, v in enumerate(native.inspect_packets(cut)):
        res[f"{name}/cut_packets{k}"] = np.asarray(v)
syn = os.path.join(work, "synth.mp4")
native.synthesize(syn, width=320, height=240, duration=3.0, codec="mpeg4",
                  motion_windows=((1.0, 2.0),), with_audio=True)
with native.VideoReader(syn) as r:
    res["synth/stream_counts"] = np.array(r.stream_counts())
vers = native.libav_versions()
res["majors"] = np.array([int(vers[k].split(".")[0])
                          for k in ("avformat", "avcodec", "avutil")])
np.savez(out, **res)
"""

CLIPS = {
    "h264_audio": dict(width=640, height=480, codec="libx264", noise=2,
                       with_audio=True),
    "mpeg4": dict(width=640, height=480, codec="mpeg4"),
    "h264_bframes": dict(width=320, height=240, codec="libx264",
                         b_frames=2),
}


def _runtime() -> list[str]:
    r = subprocess.run([sys.executable, os.path.join(NATIVE, "find_libav.py")],
                       capture_output=True, text=True)
    return r.stdout.split()


@pytest.fixture(scope="module")
def abi_lib(tmp_path_factory):
    if not _runtime():
        pytest.skip("no FFmpeg 8 runtime on this host")
    build = tmp_path_factory.mktemp("abi_build")
    for f in ("Makefile", "mvtrim_host.cpp", "libav_abi.h", "find_libav.py"):
        shutil.copy(os.path.join(NATIVE, f), build / f)
    subprocess.run(["make", "-C", str(build), "LIBAV=abi",
                    f"PYTHON={sys.executable}"], check=True,
                   capture_output=True)
    return str(build / "libmvtrim_host.so")


@pytest.fixture(scope="module")
def digests(abi_lib, tmp_path_factory):
    clips = tmp_path_factory.mktemp("abi_clips")
    args = []
    for name, kw in CLIPS.items():
        path = str(clips / f"{name}.mp4")
        native.synthesize(path, fps=25.0, duration=6.0,
                          motion_windows=((1.0, 3.0),), **kw)
        args.append(f"{name}={path}")
    out = {}
    for build, lib in (("headers", native._load_library()._name),
                       ("abi", abi_lib)):
        work = tmp_path_factory.mktemp(build)
        env = dict(os.environ, MVT_NATIVE_LIB=lib, PYTHONPATH=REPO)
        subprocess.run([sys.executable, "-c", DIGEST, str(work / "d.npz"),
                        str(work)] + args, check=True, env=env, cwd=REPO,
                       capture_output=True, timeout=600)
        out[build] = dict(np.load(work / "d.npz"))
    return out


def test_find_libav_reports_ffmpeg8():
    libs = _runtime()
    if not libs:
        pytest.skip("no FFmpeg 8 runtime on this host")
    names = [os.path.basename(p) for p in libs]
    for name, (lib, major) in zip(names, (("avformat", 62), ("avcodec", 62),
                                          ("avutil", 60))):
        assert name.startswith(f"lib{lib}") and f".so.{major}" in name


def test_abi_build_loads_ffmpeg8(digests):
    assert digests["abi"]["majors"].tolist() == [62, 62, 60]


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_abi_build_decodes_like_header_build(digests, clip):
    """MVs, luma, timestamps, picture types, packets and cut output of
    the same file are identical between the two builds."""
    want, got = digests["headers"], digests["abi"]
    keys = sorted(k for k in want if k.startswith(clip + "/"))
    assert keys == sorted(k for k in got if k.startswith(clip + "/"))
    for k in keys:
        if k.endswith("/probe"):
            # The container duration is FFmpeg's own estimate, which
            # differs by microseconds between releases when audio is muxed.
            np.testing.assert_allclose(got[k], want[k], atol=1e-3)
            np.testing.assert_array_equal(got[k][1:], want[k][1:])
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_abi_build_synthesizes_audio(digests):
    """AVFrame.ch_layout and AVCodecContext.sample_fmt as declared: the
    AAC track of a synthesized clip is muxed."""
    assert digests["abi"]["synth/stream_counts"].tolist() == [2, 1]


def test_synth_codec_prefers_libx264():
    assert native.synth_codec() == "libx264"


def test_mpeg4_clip_moves_at_one_vector(tmp_path):
    """mpeg4 codes one MV per 16x16 macroblock, one vote per grid cell:
    with VECTORS_NEEDED=1, the setting for such streams, the moving box
    of a synthesized mpeg4 clip is found and cut."""
    import contextlib
    import io

    from mvtrim_tpu.core.config import Config
    from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline

    src, dst = str(tmp_path / "m4.mp4"), str(tmp_path / "out.mp4")
    native.synthesize(src, width=320, height=240, fps=25.0, duration=10.0,
                      codec="mpeg4", motion_windows=((3.0, 5.0),))
    with contextlib.redirect_stdout(io.StringIO()):
        rc = ProcessingPipeline(src, dst, stream_id=-1, num_threads=2,
                                cfg=Config(scan_backend="oracle",
                                           vectors_needed=1)).run()
    assert rc == 0 and os.path.exists(dst)
    with native.VideoReader(dst) as r:
        assert 1.5 < r.duration < 6.0


def test_doctor_mv_check_without_libx264(monkeypatch):
    """Without libx264 the H.264 probe clip cannot be made: the doctor
    probes with mpeg4 and warns instead of failing."""
    from mvtrim_tpu.tools import doctor

    monkeypatch.setattr(native, "_synth_codec", "mpeg4")
    r = doctor._check_h264_mv()
    assert r["status"] == "warn" and "mpeg4" in r["detail"], r
    assert doctor._check_e2e(device=False)["status"] == "ok"


def test_doctor_hevc_check_without_hevc_encoder(monkeypatch):
    """FFmpeg >= 7 exports HEVC MVs; without libx265 the doctor says the
    export is unverified rather than that FFmpeg is too old."""
    from mvtrim_tpu.tools import doctor

    monkeypatch.setattr(native, "hevc_mv_export_capable", lambda: False)
    monkeypatch.setattr(native, "libav_versions",
                        lambda: {"avformat": "62.3.100",
                                 "avcodec": "62.11.100",
                                 "avutil": "60.8.100"})
    r = doctor._check_hevc_mv()
    assert r["status"] == "warn" and "not verified" in r["detail"], r
    monkeypatch.setattr(native, "libav_versions",
                        lambda: {"avformat": "59.27.100",
                                 "avcodec": "59.37.100",
                                 "avutil": "57.28.100"})
    assert "FFmpeg >= 7" in doctor._check_hevc_mv()["detail"]
