"""End-to-end pipeline/batch/CLI tests on synthetic clips (SURVEY.md §4
item 3).  Runs on the CPU backend (conftest forces JAX_PLATFORMS=cpu)."""

import os

import numpy as np
import pytest

from mvtrim_tpu.cli import main as cli_main
from mvtrim_tpu.core.config import Config
from mvtrim_tpu.io import native
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu.batch.batch import BatchProcessor, list_videos
from mvtrim_tpu.utils.timing import TimingCollector


@pytest.fixture(scope="session")
def motion_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pipe") / "motion.mp4")
    native.synthesize(path, width=640, height=480, fps=25.0, duration=20.0,
                      codec="libx264",
                      motion_windows=((2.0, 5.0), (12.0, 14.0)))
    return path


@pytest.fixture(scope="session")
def static_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pipe") / "static.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=6.0,
                      codec="libx264", motion_windows=())
    return path




@pytest.fixture(autouse=True)
def clear_timing():
    TimingCollector.clear()
    yield
    TimingCollector.clear()


class TestSingleFile:
    def test_motion_clip_is_trimmed(self, motion_clip, tmp_path):
        out = str(tmp_path / "out.mp4")
        p = ProcessingPipeline(motion_clip, out, cfg=Config())
        assert p.run() == 0
        assert os.path.exists(out)
        # ~7s of motion+padding kept from 20s
        assert 50.0 < p.saved_pct < 80.0
        with native.VideoReader(out) as r:
            assert 5.0 < r.duration < 10.0

    def test_backend_parity(self, motion_clip, tmp_path):
        """The device (auto) and oracle backends produce identical
        savings."""
        res = {}
        for backend in ("auto", "oracle"):
            out = str(tmp_path / f"out_{backend}.mp4")
            p = ProcessingPipeline(motion_clip, out,
                                   cfg=Config(scan_backend=backend))
            assert p.run() == 0
            res[backend] = (p.time_removed, p.saved_pct)
        assert res["auto"] == res["oracle"]

    def test_static_clip_no_output(self, static_clip, tmp_path):
        out = str(tmp_path / "none.mp4")
        p = ProcessingPipeline(static_clip, out, cfg=Config())
        assert p.run() == 0  # "No motion found." is a success, no output
        assert not os.path.exists(out)

    def test_low_savings_full_copy(self, motion_clip, tmp_path):
        # strict > on MIN_SAVINGS_PCT (pipeline.cpp:358): raise the bar so
        # the decision flips to a single full-duration copy segment
        out = str(tmp_path / "copy.mp4")
        p = ProcessingPipeline(motion_clip, out,
                               cfg=Config(min_savings_pct=99.0))
        assert p.run() == 0
        assert os.path.exists(out)
        with native.VideoReader(motion_clip) as orig, \
                native.VideoReader(out) as copy:
            assert abs(orig.duration - copy.duration) < 0.6

    def test_missing_input_fails(self, tmp_path):
        p = ProcessingPipeline("/nonexistent.mp4", str(tmp_path / "x.mp4"),
                               cfg=Config())
        assert p.run() == 1

    def test_target_fps_still_finds_motion(self, motion_clip, tmp_path):
        out = str(tmp_path / "skip.mp4")
        p = ProcessingPipeline(motion_clip, out,
                               cfg=Config(target_fps=10.0))
        assert p.run() == 0
        assert os.path.exists(out)
        assert p.saved_pct > 40.0


class TestBatch:
    def test_batch_two_files(self, motion_clip, static_clip, tmp_path):
        in_dir = tmp_path / "in"
        out_dir = tmp_path / "out"
        in_dir.mkdir()
        os.symlink(motion_clip, in_dir / "a_motion.mp4")
        os.symlink(static_clip, in_dir / "b_static.mp4")
        files = list_videos(str(in_dir))
        assert [os.path.basename(f) for f in files] == \
            ["a_motion.mp4", "b_static.mp4"]
        bp = BatchProcessor(2, Config())
        assert bp.process(files, str(out_dir), str(in_dir)) == 0
        assert os.path.exists(out_dir / "a_motion.mp4")
        assert not os.path.exists(out_dir / "b_static.mp4")  # no motion

    def test_skip_existing_output(self, motion_clip, tmp_path):
        in_dir = tmp_path / "in"
        out_dir = tmp_path / "out"
        in_dir.mkdir()
        out_dir.mkdir()
        os.symlink(motion_clip, in_dir / "v.mp4")
        (out_dir / "v.mp4").write_bytes(b"sentinel")
        bp = BatchProcessor(1, Config())
        assert bp.process(list_videos(str(in_dir)), str(out_dir)) == 0
        assert (out_dir / "v.mp4").read_bytes() == b"sentinel"

    def test_extension_filter(self, tmp_path):
        d = tmp_path / "mixed"
        d.mkdir()
        for name in ["a.mp4", "b.MKV", "c.txt", "d.ts", "e.mov", "f.avi",
                     "g.wav"]:
            (d / name).write_bytes(b"x")
        names = [os.path.basename(f) for f in list_videos(str(d))]
        assert names == ["a.mp4", "b.MKV", "d.ts", "e.mov", "f.avi"]


class TestCLI:
    def test_usage_error(self):
        assert cli_main([]) == 1
        assert cli_main(["only_one"]) == 1

    def test_single_file(self, motion_clip, tmp_path):
        out = str(tmp_path / "cli.mp4")
        assert cli_main([motion_clip, out]) == 0
        assert os.path.exists(out)

    def test_empty_dir(self, tmp_path):
        d = tmp_path / "empty"
        d.mkdir()
        assert cli_main([str(d), str(tmp_path / "o")]) == 0


class TestHeatmapIntegration:
    def test_pipeline_writes_heatmap(self, motion_clip, tmp_path):
        """MVT_HEATMAP rides the scan's own grids — no extra decode."""
        import json
        hdir = tmp_path / "heat"
        hdir.mkdir()
        cfg = Config(scan_backend="oracle", heatmap_path=str(hdir))
        p = ProcessingPipeline(motion_clip, str(tmp_path / "o.mp4"), cfg=cfg)
        assert p.run() == 0
        out = hdir / (os.path.basename(motion_clip) + ".heatmap.json")
        assert out.exists()
        doc = json.loads(out.read_text())
        assert doc["grid"] == [30, 40]
        assert doc["frames_analyzed"] > 400
        assert doc["max_activity"] > 0

    def test_file_target_gets_per_input_suffix_in_batch(
            self, motion_clip, tmp_path):
        """MVT_HEATMAP naming a FILE in batch mode (stream_id >= 0) must
        not let N parallel streams race open(path, 'w') on the same path
        — each input gets its own suffixed file."""
        import json
        hp = tmp_path / "heat.json"
        cfg = Config(scan_backend="oracle", heatmap_path=str(hp))
        p = ProcessingPipeline(motion_clip, str(tmp_path / "ob.mp4"),
                               stream_id=0, cfg=cfg)
        assert p.run() == 0
        suffixed = tmp_path / (
            "heat.json." + os.path.basename(motion_clip) + ".json")
        assert suffixed.exists(), "batch stream must write per-input file"
        assert not hp.exists(), "shared path must not be written in batch"
        assert json.loads(suffixed.read_text())["max_activity"] > 0
        # single-file mode (stream_id < 0) keeps the literal file target
        hp2 = tmp_path / "heat1.json"
        cfg2 = Config(scan_backend="oracle", heatmap_path=str(hp2))
        p2 = ProcessingPipeline(motion_clip, str(tmp_path / "os.mp4"),
                                cfg=cfg2)
        assert p2.run() == 0
        assert hp2.exists()


class TestPipelineModeValidation:
    def test_unknown_mvt_pipeline_falls_back_to_auto(
            self, static_clip, tmp_path, capsys):
        """A typo'd MVT_PIPELINE (e.g. 'SAD') must not silently select
        the MV scan with the auto-SAD fallback disabled — it warns and
        behaves as 'auto' (same guard MVT_SCAN_INPUT already has)."""
        cfg = Config(scan_backend="oracle", pipeline_mode="SAD")
        p = ProcessingPipeline(static_clip, str(tmp_path / "om.mp4"),
                               cfg=cfg)
        rc = p.run()
        captured = capsys.readouterr()
        assert "Unknown MVT_PIPELINE" in captured.out + captured.err
        assert rc == 0
