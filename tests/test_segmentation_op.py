"""Device segmentation op + sharded archive scan tests."""

import numpy as np
import pytest

from mvtrim_tpu.core import oracle
from mvtrim_tpu.core.config import Config
from mvtrim_tpu.core.types import TimeSegment
from mvtrim_tpu.io import native
from mvtrim_tpu.ops.segmentation import make_segment_op
from mvtrim_tpu.parallel.archive import scan_archive
from mvtrim_tpu.parallel.mesh import build_mesh


def run_op(ts_motion, duration, max_gap=5.0, pad=0.5, cap=16):
    ts = np.asarray([t for t, _ in ts_motion], np.float32)
    motion = np.asarray([m for _, m in ts_motion], bool)
    op = make_segment_op(cap, max_gap_sec=max_gap, padding_sec=pad)
    starts, ends, count, kept = op(ts, motion, np.float32(duration))
    n = int(count)
    return ([TimeSegment(round(float(s), 4), round(float(e), 4))
             for s, e in zip(np.asarray(starts)[:n], np.asarray(ends)[:n])],
            float(kept))


class TestSegmentOp:
    def test_matches_oracle_basic(self):
        pts = [10.0, 11.0, 12.0, 20.0, 21.0]
        segs, kept = run_op([(t, True) for t in pts], 100.0)
        expect = oracle.segments_from_timestamps(
            pts, max_gap_sec=5.0, padding_sec=0.5, duration=100.0)
        assert segs == expect
        assert kept == pytest.approx(sum(s.end - s.start for s in expect))

    def test_non_motion_frames_ignored(self):
        stream = [(9.0, False), (10.0, True), (10.5, False), (11.0, True),
                  (30.0, False), (40.0, True)]
        segs, _ = run_op(stream, 100.0)
        expect = oracle.segments_from_timestamps(
            [10.0, 11.0, 40.0], max_gap_sec=5.0, padding_sec=0.5,
            duration=100.0)
        assert segs == expect

    def test_no_motion(self):
        segs, kept = run_op([(1.0, False), (2.0, False)], 10.0)
        assert segs == [] and kept == 0.0

    def test_clamping(self):
        segs, _ = run_op([(0.2, True), (9.9, True)], 10.0, max_gap=2.0)
        expect = oracle.segments_from_timestamps(
            [0.2, 9.9], max_gap_sec=2.0, padding_sec=0.5, duration=10.0)
        assert segs == expect

    def test_random_streams_match_oracle(self, rng):
        for _ in range(10):
            n = 64
            ts = np.sort(rng.uniform(0, 300, n)).astype(np.float32)
            ts = np.unique(ts)
            motion = rng.random(len(ts)) < 0.3
            segs, _ = run_op(list(zip(ts.tolist(), motion.tolist())), 300.0,
                             max_gap=7.0, pad=1.0, cap=64)
            expect = oracle.segments_from_timestamps(
                ts[motion].astype(np.float64), max_gap_sec=7.0,
                padding_sec=1.0, duration=300.0)
            assert len(segs) == len(expect)
            for got, want in zip(segs, expect):
                assert got.start == pytest.approx(want.start, abs=1e-3)
                assert got.end == pytest.approx(want.end, abs=1e-3)

    def test_capacity_saturation_keeps_first(self):
        # 20 isolated motion frames, cap 4: the FIRST 4 segments are kept
        stream = [(float(10 * i), True) for i in range(20)]
        segs, _ = run_op(stream, 1000.0, max_gap=2.0, cap=4)
        assert len(segs) == 4
        expect = oracle.segments_from_timestamps(
            [10.0 * i for i in range(20)], max_gap_sec=2.0,
            padding_sec=0.5, duration=1000.0)[:4]
        assert segs == expect


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("arch") / "long.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0,
                      duration=30.0, codec="libx264",
                      motion_windows=((3.0, 6.0), (20.0, 22.0)))
    return path


class TestArchiveScan:
    def test_sharded_scan_matches_single_device(self, clip):
        cfg = Config(chunk_duration_sec=5.0)
        mesh8 = build_mesh(8, sweep=1)
        segs8, dur, stats = scan_archive(clip, cfg, mesh=mesh8,
                                         frames_per_device=32)
        assert stats["mesh"]["data"] == 8
        assert stats["dispatches"] >= 2
        # observability parity with the pipeline phase tree: the decode
        # dominates on any real clip, and every frame decoded carries time
        assert stats["worker_us"]["decode"] > 0
        assert stats["worker_us"]["analyze"] >= 0
        mesh1 = build_mesh(1, sweep=1)
        segs1, _, _ = scan_archive(clip, cfg, mesh=mesh1,
                                   frames_per_device=64)
        assert segs8 == segs1
        # both motion windows are represented (detection onset depends on
        # encoder GOP/partition dynamics; require overlap, not exact edges)
        assert len(segs8) == 2
        assert segs8[0].start < 6.0 and segs8[0].end > 3.0
        assert segs8[1].start < 22.0 and segs8[1].end > 20.0


class TestArchiveCheckpoint:
    def test_resume_skips_chunks_and_matches(self, clip, tmp_path):
        cfg = Config(chunk_duration_sec=5.0)
        mesh = build_mesh(2, sweep=1)
        ck = str(tmp_path / "scan.ckpt")
        # full scan writing the checkpoint
        segs_a, dur, stats_a = scan_archive(clip, cfg, mesh=mesh,
                                            frames_per_device=64,
                                            checkpoint=ck)
        assert stats_a["resumed_chunks"] == 0
        import os
        assert os.path.exists(ck)
        # resume: everything is checkpointed, nothing rescanned
        segs_b, _, stats_b = scan_archive(clip, cfg, mesh=mesh,
                                          frames_per_device=64,
                                          checkpoint=ck)
        assert stats_b["resumed_chunks"] == 6  # 30s / 5s chunks
        assert stats_b["frames_scanned"] == 0
        assert segs_b == segs_a

    def test_partial_checkpoint_resumes(self, clip, tmp_path):
        import json
        cfg = Config(chunk_duration_sec=5.0)
        mesh = build_mesh(1, sweep=1)
        ck_full = str(tmp_path / "full.ckpt")
        segs_full, _, _ = scan_archive(clip, cfg, mesh=mesh,
                                       frames_per_device=64,
                                       checkpoint=ck_full)
        # simulate an interrupted scan: keep only the first 3 chunk records
        # (plus the identity header the sidecar leads with)
        lines = open(ck_full).read().strip().split("\n")
        all_recs = [json.loads(x) for x in lines]
        header = [r for r in all_recs if "header" in r]
        assert len(header) == 1
        recs = sorted((r for r in all_recs if "chunk" in r),
                      key=lambda r: r["chunk"])
        ck_part = str(tmp_path / "part.ckpt")
        with open(ck_part, "w") as f:
            for r in header + recs[:3]:
                f.write(json.dumps(r) + "\n")
        segs_res, _, stats = scan_archive(clip, cfg, mesh=mesh,
                                          frames_per_device=64,
                                          checkpoint=ck_part)
        assert stats["resumed_chunks"] == 3
        assert segs_res == segs_full

    def test_legacy_headerless_sidecar_resumes_but_is_never_stamped(
            self, clip, tmp_path):
        """Pre-identity-header sidecars (chunk records only) must still
        resume — with a warning, not a refusal — and must NOT be stamped
        with the current identity: stamping would convert 'cannot verify'
        into 'verified' for chunk records this scan never checked."""
        import json
        cfg = Config(chunk_duration_sec=5.0)
        mesh = build_mesh(1, sweep=1)
        ck_full = str(tmp_path / "full.ckpt")
        segs_full, _, _ = scan_archive(clip, cfg, mesh=mesh,
                                       frames_per_device=64,
                                       checkpoint=ck_full)
        legacy = str(tmp_path / "legacy.ckpt")
        with open(legacy, "w") as f:
            for line in open(ck_full):
                if "header" not in json.loads(line):
                    f.write(line)
        for _ in range(2):  # every resume stays unverified (and warns)
            segs_res, _, stats = scan_archive(clip, cfg, mesh=mesh,
                                              frames_per_device=64,
                                              checkpoint=legacy)
            assert stats["resumed_chunks"] == 6
            assert segs_res == segs_full
            headers = [json.loads(x) for x in open(legacy)
                       if "header" in json.loads(x)]
            assert headers == []

    def test_foreign_checkpoint_rejected(self, clip, tmp_path):
        """A sidecar written under a different config must fail loudly
        instead of silently merging foreign chunk results."""
        import pytest
        cfg = Config(chunk_duration_sec=5.0)
        mesh = build_mesh(1, sweep=1)
        ck = str(tmp_path / "scan.ckpt")
        scan_archive(clip, cfg, mesh=mesh, frames_per_device=64,
                     checkpoint=ck)
        other = Config(chunk_duration_sec=5.0, mv_threshold_sq=999)
        with pytest.raises(RuntimeError, match="different scan"):
            scan_archive(clip, other, mesh=mesh, frames_per_device=64,
                         checkpoint=ck)

    def test_sigkill_mid_scan_resumes(self, clip, tmp_path):
        """Crash consistency at the process level: a scan SIGKILLed
        mid-run (right after its 3rd chunk record hits the sidecar)
        must leave a sidecar a fresh process resumes from, producing
        segments identical to an uninterrupted scan.  (The reference's
        only resume granularity is the whole-file output-exists skip,
        batch_processor.cpp:66-69.)"""
        import os
        import signal
        import subprocess
        import sys

        ck = str(tmp_path / "scan.ckpt")
        child = (
            "import os, signal\n"
            # pin the CPU platform like conftest does
            "import jax\n"
            "if jax.config.jax_platforms != 'cpu':\n"
            "    jax.config.update('jax_platforms', 'cpu')\n"
            "import mvtrim_tpu.parallel.archive as A\n"
            "orig = A.ScanCheckpoint.record\n"
            "n = [0]\n"
            "def rec(self, cid, ts):\n"
            "    orig(self, cid, ts)\n"
            "    n[0] += 1\n"
            "    if n[0] == 3:\n"
            "        os.kill(os.getpid(), signal.SIGKILL)\n"
            "A.ScanCheckpoint.record = rec\n"
            "from mvtrim_tpu.core.config import Config\n"
            "from mvtrim_tpu.parallel.mesh import build_mesh\n"
            f"A.scan_archive({clip!r}, Config(chunk_duration_sec=5.0),\n"
            "               mesh=build_mesh(1, sweep=1),\n"
            f"               frames_per_device=64, checkpoint={ck!r})\n"
        )
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd() + os.pathsep + \
            env.get("PYTHONPATH", "")
        p = subprocess.run([sys.executable, "-c", child], env=env,
                           capture_output=True, timeout=300)
        assert p.returncode == -signal.SIGKILL, p.stderr.decode()[-2000:]

        cfg = Config(chunk_duration_sec=5.0)
        mesh = build_mesh(1, sweep=1)
        segs_full, _, _ = scan_archive(clip, cfg, mesh=mesh,
                                       frames_per_device=64)
        segs_res, _, stats = scan_archive(clip, cfg, mesh=mesh,
                                          frames_per_device=64,
                                          checkpoint=ck)
        assert stats["resumed_chunks"] == 3
        assert segs_res == segs_full

    def test_truncated_tail_line_tolerated(self, clip, tmp_path):
        """A kill mid-append leaves a truncated final line; resume must
        tolerate it (costing one chunk re-scan), not crash."""
        cfg = Config(chunk_duration_sec=5.0)
        mesh = build_mesh(1, sweep=1)
        ck = str(tmp_path / "scan.ckpt")
        segs_full, _, _ = scan_archive(clip, cfg, mesh=mesh,
                                       frames_per_device=64,
                                       checkpoint=ck)
        with open(ck, "a") as f:
            f.write('{"chunk": 99, "motion_')  # torn write
        segs_res, _, stats = scan_archive(clip, cfg, mesh=mesh,
                                          frames_per_device=64,
                                          checkpoint=ck)
        assert stats["resumed_chunks"] == 6
        assert segs_res == segs_full


class TestArchivePipelineEquivalence:
    def test_archive_mode_matches_standard_pipeline(self, clip, tmp_path):
        """MVT_ARCHIVE=1 and the standard pipeline must produce identical
        quantized cut segments for the same clip/config."""
        from mvtrim_tpu.cut.executor import quantized_segments
        from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline
        from mvtrim_tpu.core import oracle as orc

        cfg = Config(scan_backend="oracle", chunk_duration_sec=5.0)
        segs_arch, dur, _ = scan_archive(clip, cfg, mesh=build_mesh(4, sweep=1),
                                         frames_per_device=64)
        # run the standard pipeline capturing its emitted segments via the
        # fake-ffmpeg concat dump
        import os
        import subprocess
        import sys
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dump = str(tmp_path / "std.txt")
        env = dict(os.environ,
                   MVT_FFMPEG_BIN=os.path.join(repo, "parity",
                                               "fake_ffmpeg.sh"),
                   MVT_CONCAT_DUMP=dump, MVT_SCAN_BACKEND="oracle",
                   CHUNK_DURATION_SEC="5.0", MVT_LOG="0")
        subprocess.run([sys.executable, "-m", "mvtrim_tpu", clip,
                        str(tmp_path / "std.mp4")], env=env, cwd=repo,
                       check=True, capture_output=True, timeout=300)
        std_concat = open(dump).read()
        _, out_segments = orc.decide_cut(segs_arch, dur,
                                         cfg.min_savings_pct)
        arch_concat = orc.concat_list(os.path.abspath(clip), out_segments)
        assert arch_concat == std_concat


def _sad_archive_truth(clip: str, cfg: Config):
    """Single-device ground truth for the SAD archive payload: the
    pipeline-style chunked SAD scan (chunk-independent, cap-resume carry
    threading — the same helper shape as tests/test_sweep.py's
    _sad_detector_run) -> (segments, duration)."""
    import math

    from mvtrim_tpu.models.sad_detector import SADDetector

    reader = native.VideoReader(clip)
    duration, fps = reader.duration, reader.fps
    det = SADDetector(reader.width, reader.height, cfg)
    frame_skip = cfg.frame_skip(fps)
    cap = int(math.ceil(cfg.chunk_duration_sec * max(fps, 1.0))) + 64
    if cfg.chunk_frames_cap > 0:
        cap = min(cap, cfg.chunk_frames_cap)
    cur = native.ChunkScanCursor(duration, cfg.chunk_duration_sec, cap)
    carry = None
    ts: list[float] = []
    while cur.more():
        start, end = cur.window()
        if not cur.resume:
            carry = None
        data, pts = reader.scan_luma(start, end, frame_skip=frame_skip,
                                     max_frames=cap, resume=cur.resume)
        cur.advance(len(pts))
        if len(pts) == 0:
            continue
        motion = det.scan_luma(data, carry=carry)
        ts.extend(pts[motion].tolist())
        carry = data[-1].copy()
    reader.close()
    merged = oracle.merge_timestamps(ts)
    segments = oracle.segments_from_timestamps(
        merged, max_gap_sec=cfg.max_gap_sec, padding_sec=cfg.padding_sec,
        duration=duration)
    return segments, duration


@pytest.fixture(scope="module")
def intra_clip(tmp_path_factory):
    """All-I-frame stream (gop=1): exports ZERO codec MVs — the class of
    input the reference cannot detect motion on (motion_scanner.cpp:
    219-221) and the round-4 archive path warned-and-gave-up on."""
    path = str(tmp_path_factory.mktemp("sadarch") / "intra.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0,
                      duration=20.0, codec="libx264", gop=1, noise=2,
                      motion_windows=((3.0, 6.0), (14.0, 16.0)))
    return path


class TestArchiveSADPayload:
    def test_auto_selects_sad_and_matches_single_device_truth(
            self, intra_clip):
        cfg = Config(chunk_duration_sec=5.0)
        segs, dur, stats = scan_archive(intra_clip, cfg,
                                        mesh=build_mesh(8, sweep=1),
                                        frames_per_device=8)
        assert stats["payload"] == "sad"
        assert stats["dispatches"] >= 2
        expect, dur_t = _sad_archive_truth(intra_clip, cfg)
        assert dur == dur_t
        assert segs == expect
        # both motion windows detected (the reference finds nothing here)
        assert len(segs) == 2
        assert segs[0].start < 6.0 and segs[0].end > 3.0
        assert segs[1].start < 16.0 and segs[1].end > 14.0

    def test_auto_keeps_bits_on_mv_stream(self, clip):
        cfg = Config(chunk_duration_sec=5.0)
        _, _, stats = scan_archive(clip, cfg, mesh=build_mesh(2, sweep=1),
                                   frames_per_device=32)
        assert stats["payload"] == "bits"

    @pytest.mark.parametrize("n", [1, 4])
    def test_mesh_sizes_agree(self, intra_clip, n):
        """The per-shard carry construction must be layout-invariant:
        any mesh size produces the 8-device segments."""
        cfg = Config(chunk_duration_sec=5.0)
        segs_n, _, stats = scan_archive(intra_clip, cfg,
                                        mesh=build_mesh(n, sweep=1),
                                        frames_per_device=16,
                                        payload="sad")
        assert stats["payload"] == "sad"
        expect, _ = _sad_archive_truth(intra_clip, cfg)
        assert segs_n == expect

    def test_part_streaming_is_decision_invariant(self, intra_clip):
        """A tiny chunk-frames cap forces many sub-scan parts per chunk
        (incl. the interleaved-chunk placeholder-row path); decisions
        must not move."""
        cfg = Config(chunk_duration_sec=5.0, chunk_frames_cap=16)
        segs, _, _ = scan_archive(intra_clip, cfg,
                                  mesh=build_mesh(4, sweep=1),
                                  frames_per_device=8, payload="sad")
        expect, _ = _sad_archive_truth(intra_clip,
                                       Config(chunk_duration_sec=5.0))
        assert segs == expect

    def test_sad_checkpoint_resume(self, intra_clip, tmp_path):
        cfg = Config(chunk_duration_sec=5.0)
        ck = str(tmp_path / "sad.ckpt")
        segs_a, _, stats_a = scan_archive(intra_clip, cfg,
                                          mesh=build_mesh(2, sweep=1),
                                          frames_per_device=16,
                                          checkpoint=ck, payload="sad")
        assert stats_a["resumed_chunks"] == 0
        segs_b, _, stats_b = scan_archive(intra_clip, cfg,
                                          mesh=build_mesh(2, sweep=1),
                                          frames_per_device=16,
                                          checkpoint=ck, payload="sad")
        assert stats_b["resumed_chunks"] == 4   # 20s / 5s chunks
        assert stats_b["frames_scanned"] == 0
        assert segs_b == segs_a

    def test_payload_mismatched_sidecar_refuses(self, intra_clip,
                                                tmp_path):
        """A bits sidecar must never resume a sad scan (and vice
        versa): the identity header carries the payload."""
        cfg = Config(chunk_duration_sec=5.0)
        ck = str(tmp_path / "x.ckpt")
        scan_archive(intra_clip, cfg, mesh=build_mesh(1, sweep=1),
                     frames_per_device=16, checkpoint=ck, payload="sad")
        with pytest.raises(RuntimeError, match="different scan"):
            scan_archive(intra_clip, cfg, mesh=build_mesh(1, sweep=1),
                         frames_per_device=16, checkpoint=ck,
                         payload="bits")

    def test_forced_bits_on_intra_warns_and_finds_nothing(
            self, intra_clip, capsys):
        cfg = Config(chunk_duration_sec=5.0)
        segs, _, stats = scan_archive(intra_clip, cfg,
                                      mesh=build_mesh(1, sweep=1),
                                      frames_per_device=32,
                                      payload="bits")
        assert stats["payload"] == "bits"
        assert segs == []   # the reference-equivalent (blind) outcome
        captured = capsys.readouterr()
        assert "MV side data" in captured.out + captured.err
