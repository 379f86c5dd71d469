"""SAD fallback path: kernel parity, detector behavior, pipeline
auto-fallback on intra-only (MV-less) streams — BASELINE config 2."""

import os

import numpy as np
import pytest

from mvtrim_tpu.core.config import Config
from mvtrim_tpu.core.types import GridGeometry
from mvtrim_tpu.io import native
from mvtrim_tpu.models.sad_detector import SADDetector, sad_oracle_counts
from mvtrim_tpu.ops import sad as sad_ops
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline

CFG = Config()
GEOM = GridGeometry.build(320, 240, CFG)  # gw=20, gh=15


@pytest.fixture(scope="session")
def intra_clip(tmp_path_factory):
    """All-I-frame clip (gop=1): decodes fine, exports zero MVs."""
    path = str(tmp_path_factory.mktemp("sad") / "intra.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=10.0,
                      codec="libx264", motion_windows=((2.0, 4.0),), gop=1)
    return path


class TestSADKernels:
    def random_luma(self, rng, n=6):
        h = GEOM.padded_gh * CFG.block_size
        w = GEOM.padded_gw * CFG.block_size
        luma = np.zeros((n, h, w), np.uint8)
        base = rng.integers(0, 200, size=(h, w), dtype=np.uint8)
        luma[:] = base
        # add moving square on some frames
        for i in range(1, n, 2):
            luma[i, 50:100, 30 + i * 10:80 + i * 10] = 255
        return luma

    def test_xla_matches_oracle(self, rng):
        luma = self.random_luma(rng)
        op = sad_ops.make_sad_op_xla(
            GEOM, sad_threshold=CFG.sad_threshold,
            block_size=CFG.block_size, clusters_needed=CFG.clusters_needed)
        counts, motion = op(luma)
        # oracle computes over the unpadded region; our luma is padded and
        # oracle's geom-based loop only reads geom.gh/gw blocks
        expect = sad_oracle_counts(
            luma, GEOM, sad_threshold=CFG.sad_threshold,
            block_size=CFG.block_size)
        np.testing.assert_array_equal(np.asarray(counts), expect)
        np.testing.assert_array_equal(
            np.asarray(motion), expect >= max(1, CFG.clusters_needed))

    @pytest.mark.parametrize("dims", [(1920, 1080), (3840, 2160),
                                      (330, 250)])
    def test_xla_matches_oracle_at_widths(self, rng, dims):
        """1080p- and 4K-shaped small batches, and a size whose edge
        blocks are cut by the frame border."""
        w, h = dims
        geom = GridGeometry.build(w, h, CFG)
        luma = np.zeros((4, h, w), np.uint8)
        luma[:] = rng.integers(0, 200, size=(h, w), dtype=np.uint8)
        for i in (1, 3):
            luma[i, h // 4:h // 2, (w // 8) * i:(w // 8) * i + w // 4] = 255
        padded = sad_ops.pad_luma(luma, geom, CFG.block_size)
        op = sad_ops.make_sad_op_xla(
            geom, sad_threshold=CFG.sad_threshold,
            block_size=CFG.block_size, clusters_needed=CFG.clusters_needed)
        counts, motion = op(padded)
        expect = sad_oracle_counts(luma, geom,
                                   sad_threshold=CFG.sad_threshold,
                                   block_size=CFG.block_size)
        assert expect[0] > 0 and expect[1] > 0
        np.testing.assert_array_equal(np.asarray(counts), expect)
        np.testing.assert_array_equal(
            np.asarray(motion), expect >= max(1, CFG.clusters_needed))

    @pytest.mark.parametrize("delta,active", [(0, True), (-1, False)])
    def test_near_threshold_sums_exact(self, delta, active):
        """Every 16x16 block's SAD sits exactly at the activation bound
        (delta 0: active) or one below it (delta -1: inactive), built
        from per-column sums of 257 — the op's integer sums must not
        round."""
        cfg = Config(sad_threshold=16.0625)   # bound = 4112 = 16 * 257
        bound = sad_ops.sad_threshold_sum(cfg.sad_threshold, cfg.block_size)
        assert bound == 4112
        geom = GridGeometry.build(640, 480, cfg)
        luma = np.zeros((3, 480, 640), np.uint8)
        luma[1, 0::16, :] = 255
        luma[1, 1::16, :] = 2
        if delta:
            luma[1, 1::16, 0::16] = 2 + delta   # one pixel per block
        luma[2] = luma[1]                   # no change: never motion
        expect = sad_oracle_counts(luma, geom,
                                   sad_threshold=cfg.sad_threshold,
                                   block_size=cfg.block_size)
        assert (expect[0] > 0) == active and expect[1] == 0
        op = sad_ops.make_sad_op_xla(
            geom, sad_threshold=cfg.sad_threshold,
            block_size=cfg.block_size, clusters_needed=cfg.clusters_needed)
        counts, _ = op(sad_ops.pad_luma(luma, geom, cfg.block_size))
        np.testing.assert_array_equal(np.asarray(counts), expect)

    def test_oracle_matches_blockwise_loop(self, rng):
        """The vectorised SAD oracle equals a block-by-block loop over the
        unpadded frame, including blocks cut by the right/bottom edge."""
        w, h = 330, 250
        geom = GridGeometry.build(w, h, CFG)
        luma = rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)
        bs = CFG.block_size
        bound = sad_ops.sad_threshold_sum(CFG.sad_threshold, bs)
        x = luma.astype(np.int64)
        diff = np.abs(x[1:] - x[:-1])
        active = np.zeros((2, geom.gh, geom.gw), np.uint8)
        for by in range(geom.gh):
            for bx in range(geom.gw):
                blk = diff[:, by * bs:(by + 1) * bs, bx * bs:(bx + 1) * bs]
                active[:, by, bx] = blk.sum(axis=(1, 2)) >= bound
        from mvtrim_tpu.core.oracle import count_clusters_batch
        expect = count_clusters_batch(active, vectors_needed=1,
                                      y_min=geom.y_min, y_max=geom.y_max)
        np.testing.assert_array_equal(
            sad_oracle_counts(luma, geom, sad_threshold=CFG.sad_threshold,
                              block_size=bs), expect)

    def test_static_frames_inactive(self):
        h = GEOM.padded_gh * CFG.block_size
        w = GEOM.padded_gw * CFG.block_size
        luma = np.full((4, h, w), 77, np.uint8)
        op = sad_ops.make_sad_op_xla(
            GEOM, sad_threshold=CFG.sad_threshold,
            block_size=CFG.block_size, clusters_needed=CFG.clusters_needed)
        counts, motion = op(luma)
        assert not np.asarray(motion).any()


class TestSADDetector:
    def _luma_seq(self, rng, n=12):
        """320x240 sequence: moving bright square on odd frames < 8
        (every consecutive pair differs -> motion), static tail (no
        motion)."""
        luma = np.zeros((n, 240, 320), np.uint8)
        base = rng.integers(0, 200, size=(240, 320), dtype=np.uint8)
        luma[:] = base
        for i in range(1, min(n, 8), 2):
            luma[i, 40:120, 20 + i * 12:120 + i * 12] = 255
        return luma

    def test_carry_matches_single_scan(self, rng):
        """Splitting a chunk anywhere and threading the boundary frame as
        ``carry`` reproduces single-scan decisions exactly — the frame
        cap must never change decisions (the pipeline cap-resume
        contract).  Without carry the first frame of the resumed part
        would be forced False."""
        luma = self._luma_seq(rng)
        n = len(luma)
        # device_batch=64 -> window of 8: resumed parts also re-window
        det = SADDetector(320, 240, Config(device_batch=64))
        full = det.scan_luma(luma)
        assert full[1:8].all() and not full[9:].any()  # both regimes
        for k in (1, 2, 5, 9, n - 1):
            head = det.scan_luma(luma[:k])
            tail = det.scan_luma(luma[k:], carry=luma[k - 1])
            got = np.concatenate([head, tail])
            np.testing.assert_array_equal(got, full,
                                          err_msg=f"split at {k}")

    @pytest.mark.parametrize("device_batch", [64, 512])
    def test_device_and_oracle_backends_agree(self, rng, device_batch):
        """The device op and the NumPy oracle path decide identically,
        across dispatch windows of 8 and 64 frames (a 20-frame chunk
        fills one, two or three windows)."""
        luma = self._luma_seq(rng, n=20)
        got = {}
        for backend in ("auto", "oracle"):
            det = SADDetector(320, 240, Config(scan_backend=backend,
                                               device_batch=device_batch))
            got[backend] = det.scan_luma(luma)
        assert got["auto"][1:8].all()
        np.testing.assert_array_equal(got["auto"], got["oracle"])

    def test_device_pin_same_decisions(self, rng):
        """Pinning the detector to an explicit device (multi-card batch
        round-robin) changes placement only, never decisions."""
        import jax

        luma = self._luma_seq(rng, n=6)
        base = SADDetector(320, 240, CFG).scan_luma(luma)
        pinned = SADDetector(320, 240, CFG,
                             device=jax.devices()[-1]).scan_luma(luma)
        np.testing.assert_array_equal(pinned, base)

    def test_detects_moving_box(self, intra_clip):
        with native.VideoReader(intra_clip, native.MVT_MODE_LUMA) as r:
            luma, pts = r.scan_luma(0.0, r.duration, max_frames=300)
        det = SADDetector(320, 240, CFG)
        motion = det.scan_luma(luma)
        assert not motion[0]  # no predecessor
        hits = pts[motion]
        assert len(hits) > 10
        assert all(1.9 <= p <= 4.1 for p in hits), hits


class TestPipelineFallback:
    def test_intra_clip_has_no_mvs(self, intra_clip):
        with native.VideoReader(intra_clip) as r:
            timing = native.ScanTiming()
            r.scan_grids(0.0, r.duration, threshold_sq=16.0, block_shift=4,
                         gw=GEOM.gw, gh=GEOM.gh, y_min=GEOM.y_min,
                         y_max=GEOM.y_max, max_frames=300, timing=timing)
            assert timing.frames_with_mvs == 0

    def test_auto_fallback_trims(self, intra_clip, tmp_path):
        out = str(tmp_path / "sad_out.mp4")
        p = ProcessingPipeline(intra_clip, out, cfg=Config())
        assert p.run() == 0
        assert os.path.exists(out)
        # motion 2-4s of 10s -> ~3s kept with padding
        assert 50.0 < p.saved_pct < 80.0

    def test_forced_sad_mode(self, intra_clip, tmp_path):
        out = str(tmp_path / "sad_forced.mp4")
        p = ProcessingPipeline(intra_clip, out,
                               cfg=Config(pipeline_mode="sad"))
        assert p.run() == 0
        assert os.path.exists(out)

    def test_tiny_frame_cap_identical_cut(self, intra_clip, tmp_path):
        """MVT_CHUNK_FRAMES_CAP=8 forces ~30 cap-resumes through the
        SAD path, several inside the motion window.  The luma carry
        threading must keep the cut AND the per-frame motion count
        identical to the uncapped run (without it, each resumed
        sub-scan's first frame was silently decided False)."""
        import json

        def run(tag, **kw):
            out = str(tmp_path / f"{tag}.mp4")
            mj = str(tmp_path / f"{tag}.jsonl")
            p = ProcessingPipeline(intra_clip, out, cfg=Config(
                pipeline_mode="sad", metrics_json=mj, **kw))
            assert p.run() == 0
            rec = json.loads(open(mj).read().splitlines()[-1])
            return (p.time_removed, p.saved_pct,
                    rec["motion_frames"], rec["frames_scanned"])

        ref = run("uncapped")
        assert ref[2] > 0
        capped = run("capped", chunk_frames_cap=8)
        assert capped == ref

    def test_mv_mode_finds_nothing_on_intra(self, intra_clip, tmp_path):
        out = str(tmp_path / "mv_none.mp4")
        p = ProcessingPipeline(intra_clip, out,
                               cfg=Config(pipeline_mode="mv"))
        assert p.run() == 0  # "No motion found." — reference behavior
        assert not os.path.exists(out)
