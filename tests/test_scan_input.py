"""MVT_SCAN_INPUT path parity: bits (default), words, grids, mv_raw.

The three H2D payloads must produce identical motion decisions — the
packed-bits path because the cluster rule reads votes only through
``>= VECTORS_NEEDED`` (reference motion_scanner.cpp:277-293), the raw-MV
path because on-device thresholding reproduces the phase-1 vote loop
(motion_scanner.cpp:242-268).  Also covers the MV-capacity overflow
contract: truncated lists are never decided; the pipeline re-decodes at a
fitting capacity and decides on the complete list.
"""

import json
import os

import numpy as np
import pytest

from mvtrim_tpu.core.config import Config
from mvtrim_tpu.io import native
from mvtrim_tpu.models.mv_detector import MVClusterDetector
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu.utils.timing import TimingCollector


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    # 360px width -> gw=23 (not byte-aligned: exercises packed tail bits)
    path = str(tmp_path_factory.mktemp("scaninput") / "motion.mp4")
    native.synthesize(path, width=360, height=240, fps=25.0, duration=16.0,
                      codec="libx264",
                      motion_windows=((2.0, 4.0), (10.0, 12.0)))
    return path


@pytest.fixture(autouse=True)
def clear_timing():
    TimingCollector.clear()
    yield
    TimingCollector.clear()


def _scan_both(clip, cfg, geom):
    with native.VideoReader(clip) as r:
        grids, pts_g = r.scan_grids(
            0.0, r.duration + 1, threshold_sq=cfg.mv_threshold_sq,
            block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
            y_min=geom.y_min, y_max=geom.y_max, max_frames=600)
    with native.VideoReader(clip) as r:
        bits, pts_b = r.scan_bits(
            0.0, r.duration + 1, threshold_sq=cfg.mv_threshold_sq,
            block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
            y_min=geom.y_min, y_max=geom.y_max,
            vectors_needed=cfg.vectors_needed, max_frames=600)
    return grids, pts_g, bits, pts_b


class TestNativeScanBits:
    def test_bits_match_thresholded_grids(self, clip):
        cfg = Config()
        with native.VideoReader(clip) as r:
            geom = MVClusterDetector(r.width, r.height, cfg).geom
        grids, pts_g, bits, pts_b = _scan_both(clip, cfg, geom)
        assert len(pts_g) == len(pts_b)
        np.testing.assert_array_equal(pts_g, pts_b)
        expected = np.packbits(grids >= cfg.vectors_needed, axis=2,
                               bitorder="little")
        np.testing.assert_array_equal(bits, expected)

    def test_bits_zero_threshold_sd_frames_only(self, clip):
        """vectors_needed=0: on frames WITH MV side data every cell
        (incl. zero-vote) satisfies >= 0 -> all gw bits set; frames
        WITHOUT side data stay all-zero — the reference's check_frame
        returns false before the threshold is ever consulted
        (motion_scanner.cpp:219-221)."""
        cfg = Config(vectors_needed=0)
        timing = native.ScanTiming()
        with native.VideoReader(clip) as r:
            geom = MVClusterDetector(r.width, r.height, cfg).geom
            bits, pts = r.scan_bits(
                0.0, 1.0, threshold_sq=cfg.mv_threshold_sq,
                block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
                y_min=geom.y_min, y_max=geom.y_max,
                vectors_needed=0, max_frames=30, timing=timing)
        active = np.unpackbits(bits, axis=2,
                               bitorder="little")[:, :, :geom.gw]
        per_frame = active.reshape(len(pts), -1)
        full = per_frame.all(axis=1)
        empty = ~per_frame.any(axis=1)
        # strict dichotomy: all-ones (side data) or all-zero (none)
        assert (full | empty).all()
        assert int(full.sum()) == timing.frames_with_mvs
        assert full.any() and empty.any()  # clip has both I and inter
        # padding bits past gw stay zero
        tail = np.unpackbits(bits, axis=2, bitorder="little")[:, :, geom.gw:]
        assert not tail.any()


class TestNativeScanWords:
    def test_words_match_host_repack(self, clip):
        """mvt_scan_words emits exactly repack_bits_words(mvt_scan_bits):
        the word layout the device kernel consumes, natively."""
        from mvtrim_tpu.ops.cluster import repack_bits_words

        cfg = Config()
        with native.VideoReader(clip) as r:
            geom = MVClusterDetector(r.width, r.height, cfg).geom
        _, _, bits, pts_b = _scan_both(clip, cfg, geom)
        with native.VideoReader(clip) as r:
            words, pts_w = r.scan_words(
                0.0, r.duration + 1, threshold_sq=cfg.mv_threshold_sq,
                block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
                y_min=geom.y_min, y_max=geom.y_max,
                vectors_needed=cfg.vectors_needed, max_frames=600)
        np.testing.assert_array_equal(pts_w, pts_b)
        np.testing.assert_array_equal(words, repack_bits_words(bits, geom))


class TestDetectorBits:
    # ids name the path taken: "auto" resolves to the XLA build
    @pytest.mark.parametrize("backend", ["auto", "oracle"],
                             ids=["xla", "oracle"])
    def test_bits_decision_equals_grids(self, backend):
        rng = np.random.default_rng(7)
        cfg = Config(scan_backend=backend, device_batch=32)
        det = MVClusterDetector(360, 240, cfg)
        grids = rng.integers(0, 5, size=(70, det.geom.gh, det.geom.gw),
                             dtype=np.uint8)
        packed = np.packbits(grids >= cfg.vectors_needed, axis=2,
                             bitorder="little")
        np.testing.assert_array_equal(det.scan_bits(packed),
                                      det.scan_votes(grids))

    @pytest.mark.parametrize("db", [32, 1048, 1152])
    def test_bits_across_device_batches(self, db):
        """The word-layout dispatch pads, splits and resolves batches of
        any size identically: 70 frames land in one partial batch or
        three, never rounded to a tile multiple."""
        rng = np.random.default_rng(11)
        det = MVClusterDetector(360, 240, Config(device_batch=db))
        assert det.device_batch == db
        grids = rng.integers(0, 5, size=(70, det.geom.gh, det.geom.gw),
                             dtype=np.uint8)
        packed = np.packbits(grids >= det.cfg.vectors_needed, axis=2,
                             bitorder="little")
        ref = MVClusterDetector(360, 240, Config(scan_backend="oracle"))
        np.testing.assert_array_equal(det.scan_bits(packed),
                                      ref.scan_bits(packed))

    @pytest.mark.parametrize("m", [256, 8192])
    def test_raw_mvs_device_equals_oracle(self, m):
        """scan_raw_mvs decides like the oracle backend, which runs the
        NumPy restatement with no device, across a partial and a full
        dispatch bucket."""
        rng = np.random.default_rng(5)
        n = 300
        counts = rng.integers(0, m + 1, n).astype(np.int32)
        counts[::7] = 0
        mvs = np.zeros((n, m, 4), np.int16)
        dst = rng.integers(-16, 376, (n, m, 2))
        mvs[..., :2] = dst
        mvs[..., 2:] = dst - rng.integers(-9, 10, (n, m, 2))
        got = {b: MVClusterDetector(360, 240, Config(
            scan_backend=b, vectors_needed=1)).scan_raw_mvs(mvs, counts)
               for b in ("auto", "oracle")}
        assert got["oracle"].any() and not got["oracle"][::7].any()
        np.testing.assert_array_equal(got["auto"], got["oracle"])

    def test_raw_mvs_overflow_raises(self):
        cfg = Config()
        det = MVClusterDetector(360, 240, cfg)
        mvs = np.zeros((3, 16, 4), np.int16)
        counts = np.array([4, -40, 2], np.int32)
        with pytest.raises(ValueError, match="overflow"):
            det.scan_raw_mvs(mvs, counts)


class TestPipelineParity:
    def _run(self, clip, out, **cfg_kw):
        cfg = Config(device_batch=64, **cfg_kw)
        p = ProcessingPipeline(clip, out, cfg=cfg)
        assert p.run() == 0
        return p.time_removed, p.saved_pct, os.path.getsize(out)

    def test_all_inputs_identical_cuts(self, clip, tmp_path):
        results = {}
        for inp in ("bits", "words", "grids", "mv_raw"):
            out = str(tmp_path / f"out_{inp}.mp4")
            results[inp] = self._run(clip, out, scan_input=inp)
        assert (results["bits"] == results["words"] == results["grids"]
                == results["mv_raw"])

    def test_mv_raw_overflow_rescan_exact(self, clip, tmp_path):
        """A capacity far below real MV counts forces the overflow
        re-decode + host-oracle path; the cut must be unchanged, and the
        restart must not double-count the re-decoded frames in the
        frames_scanned / frames_with_mvs stats (the replayed duplicates
        are dropped before emission)."""
        ref = self._run(clip, str(tmp_path / "ref.mp4"),
                        scan_input="grids",
                        metrics_json=str(tmp_path / "ref.jsonl"))
        ovf = self._run(clip, str(tmp_path / "ovf.mp4"),
                        scan_input="mv_raw", mv_capacity=8,
                        metrics_json=str(tmp_path / "ovf.jsonl"))
        assert ovf == ref
        ref_rec = json.loads(
            open(tmp_path / "ref.jsonl").read().splitlines()[-1])
        ovf_rec = json.loads(
            open(tmp_path / "ovf.jsonl").read().splitlines()[-1])
        for key in ("frames_scanned", "frames_with_mvs", "motion_frames"):
            assert ovf_rec[key] == ref_rec[key], (key, ovf_rec, ref_rec)

    def test_mv_raw_overflow_after_cap_resume_exact(self, clip, tmp_path,
                                                    monkeypatch):
        """Tiny frame cap + a capacity only the peak-MV frame exceeds:
        chunk parts are queued BEFORE a later part overflows, so the
        capacity restart replays frames that were already emitted.  The
        replayed duplicates must be dropped — identical cut AND exact
        (not inflated) frame stats.  scan_mvs is instrumented to prove
        the mid-chunk restart actually fired (a first-part overflow
        would make this test a duplicate of the one above)."""
        with native.VideoReader(clip, native.MVT_MODE_MV) as r:
            _, counts, _ = r.scan_mvs(0.0, 1e9, max_mv=1 << 16,
                                      max_frames=4096)
        cap = int(counts.max()) - 1
        # the first two 16-frame parts (static lead-in) must fit, or the
        # overflow hits part 0 and the scenario degenerates
        assert counts[:32].max() <= cap, (counts[:32].max(), cap)

        events = []
        orig = native.VideoReader.scan_mvs

        def traced(self, *a, **kw):
            mvs, cnt, pts = orig(self, *a, **kw)
            events.append((bool(kw.get("resume")),
                           len(pts) > 0 and bool((cnt < 0).any())))
            return mvs, cnt, pts

        monkeypatch.setattr(native.VideoReader, "scan_mvs", traced)
        ref = self._run(clip, str(tmp_path / "ref.mp4"),
                        scan_input="grids",
                        metrics_json=str(tmp_path / "ref.jsonl"))
        ovf = self._run(clip, str(tmp_path / "ovf.mp4"),
                        scan_input="mv_raw", mv_capacity=cap,
                        chunk_frames_cap=16,
                        metrics_json=str(tmp_path / "ovf.jsonl"))
        assert any(resume and overflowed for resume, overflowed in events)
        assert ovf == ref
        ref_rec = json.loads(
            open(tmp_path / "ref.jsonl").read().splitlines()[-1])
        ovf_rec = json.loads(
            open(tmp_path / "ovf.jsonl").read().splitlines()[-1])
        for key in ("frames_scanned", "frames_with_mvs", "motion_frames"):
            assert ovf_rec[key] == ref_rec[key], (key, ovf_rec, ref_rec)

    @pytest.mark.parametrize("knobs", [
        dict(width=328, height=200, vectors_needed=1, vertical_mask=0.0),
        dict(width=304, height=176, vectors_needed=4, clusters_needed=1),
        dict(width=640, height=352, mv_threshold_sq=4.0,
             vertical_mask=0.2, clusters_needed=3),
        dict(width=200, height=144, vectors_needed=0),
    ])
    def test_cross_input_parity_fuzz(self, tmp_path, knobs):
        """Randomized-ish geometries and knob corners (odd widths -> tail
        bits, margin 0, vec_need 0/4, clusters 1/3): all three scan
        inputs must produce the identical cut."""
        width = knobs.pop("width")
        height = knobs.pop("height")
        clip = str(tmp_path / f"f{width}x{height}.mp4")
        native.synthesize(clip, width=width, height=height, fps=25.0,
                          duration=10.0, codec="libx264",
                          motion_windows=((1.0, 3.0), (6.0, 7.0)),
                          noise=2)
        results = {}
        for inp in ("bits", "words", "grids", "mv_raw"):
            out = str(tmp_path / f"f_{inp}.mp4")
            cfg = Config(device_batch=64, scan_input=inp, **knobs)
            p = ProcessingPipeline(clip, out, cfg=cfg)
            assert p.run() == 0
            TimingCollector.clear()
            results[inp] = (p.time_removed, p.saved_pct)
        assert (results["bits"] == results["words"] == results["grids"]
                == results["mv_raw"])

    def test_heatmap_identical_bits_vs_grids(self, clip, tmp_path):
        heats = {}
        for inp in ("bits", "words", "grids"):
            hp = str(tmp_path / f"heat_{inp}.json")
            out = str(tmp_path / f"hout_{inp}.mp4")
            cfg = Config(device_batch=64, scan_input=inp, heatmap_path=hp)
            assert ProcessingPipeline(clip, out, cfg=cfg).run() == 0
            TimingCollector.clear()
            with open(hp) as f:
                heats[inp] = json.load(f)
            heats[inp].pop("input")
        assert heats["bits"] == heats["words"] == heats["grids"]
