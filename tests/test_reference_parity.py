"""Bit-exact parity against the compiled C++ reference.

Builds the read-only reference (parity/build_reference.sh: vendored
header-only fmt 11 + a system() interposer that captures the concat list
from the memfd), runs both implementations on the same synthetic clips
under the same env knobs, and asserts the final concat lists — the
inpoint/outpoint cut boundaries formatted to %.2f — are byte-identical.

This is the north-star contract from BASELINE.json ("segment boundaries
identical to the C++ reference").  Skips (not fails) if the reference
toolchain can't build here.
"""

import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from parity import harness  # noqa: E402

REPO = harness.REPO


@pytest.fixture(scope="session")
def reference_bin():
    try:
        return harness.ensure_reference()
    except (subprocess.SubprocessError, OSError) as e:
        pytest.skip(f"reference build unavailable: {e}")


@pytest.fixture(scope="session")
def clips(tmp_path_factory):
    from mvtrim_tpu.io import native

    d = tmp_path_factory.mktemp("parity")
    paths = {}
    p = str(d / "two_windows.mp4")
    native.synthesize(p, width=640, height=480, fps=25.0, duration=20.0,
                      codec="libx264",
                      motion_windows=((2.0, 5.0), (12.0, 14.0)))
    paths["two_windows"] = p
    p = str(d / "busy.mp4")
    native.synthesize(p, width=320, height=240, fps=25.0, duration=12.0,
                      codec="libx264", motion_windows=((0.5, 11.5),))
    paths["busy"] = p
    p = str(d / "bframes.mp4")
    native.synthesize(p, width=320, height=240, fps=25.0, duration=12.0,
                      codec="libx264", motion_windows=((2.0, 5.0),),
                      b_frames=2)
    paths["bframes"] = p
    p = str(d / "legacy.avi")
    native.synthesize(p, width=320, height=240, fps=25.0, duration=12.0,
                      codec="mpeg4", motion_windows=((3.0, 6.0),))
    paths["mpeg4_avi"] = p
    return paths


def both_concats(reference_bin, clip, knobs, tmp_path):
    binary, shim = reference_bin
    _, ref = harness.run_reference(
        binary, shim, clip, str(tmp_path / "ref_out.mp4"),
        str(tmp_path / "ref_concat.txt"), knobs)
    our_knobs = dict(knobs)
    our_knobs["MVT_SCAN_BACKEND"] = "oracle"  # device-free; same decisions
    our_knobs["MVT_LOG"] = "0"
    _, ours, _ = harness.run_ours(
        clip, str(tmp_path / "our_out.mp4"),
        str(tmp_path / "our_concat.txt"), our_knobs)
    return ref, ours


CONFIGS = [
    pytest.param({}, id="defaults"),
    pytest.param({"TARGET_FPS": "10"}, id="frame-skip"),
    pytest.param({"MV_THRESHOLD_SQ": "4.0", "VECTORS_NEEDED": "4"},
                 id="env-file-tuning"),
    pytest.param({"CHUNK_DURATION_SEC": "5.0", "THREADS_PER_STREAM": "3"},
                 id="multi-chunk-parallel"),
    pytest.param({"MAX_GAP_SEC": "2.0", "PADDING_SEC": "1.25"},
                 id="segmentation-knobs"),
    pytest.param({"MIN_SAVINGS_PCT": "95"}, id="full-copy-path"),
    pytest.param({"VERTICAL_MASK": "0.2"}, id="wide-vertical-mask"),
    pytest.param({"PADDING_SEC": "0", "MAX_GAP_SEC": "0.5"},
                 id="zero-padding-tight-gap"),
    pytest.param({"TARGET_FPS": "7", "CHUNK_DURATION_SEC": "4.0"},
                 id="skip-phase-across-chunks"),
    # frame cap forced tiny: every chunk saturates repeatedly and the
    # skip phase must survive each cap-resume (the reference has no cap
    # at all — motion_scanner.cpp:314,356-357 — so any phase restart
    # diverges the analyzed-frame set)
    pytest.param({"TARGET_FPS": "7", "CHUNK_DURATION_SEC": "4.0",
                  "MVT_CHUNK_FRAMES_CAP": "5"},
                 id="skip-phase-across-cap-resume"),
    pytest.param({"TARGET_FPS": "10", "MVT_CHUNK_FRAMES_CAP": "3"},
                 id="skip-phase-tiny-cap-long-chunk"),
    pytest.param({"BLOCK_SIZE": "8", "BLOCK_SHIFT": "3",
                  "VECTORS_NEEDED": "1"}, id="8px-grid-cells"),
    # vec_need 0: zero-vote cells satisfy >= 0, so every side-data frame
    # is motion — but the reference still decides MV-LESS frames False
    # (`if (!sd) return false`, motion_scanner.cpp:219-221) before the
    # threshold is consulted; masks must carry that distinction
    pytest.param({"VECTORS_NEEDED": "0"}, id="zero-vec-need"),
    # 256 wraps to 0 through the reference's uint8 config storage
    pytest.param({"VECTORS_NEEDED": "256"}, id="vec-need-uint8-wrap"),
]


class TestConcatListParity:
    @pytest.mark.parametrize("knobs", CONFIGS)
    def test_two_windows(self, reference_bin, clips, tmp_path, knobs):
        ref, ours = both_concats(reference_bin, clips["two_windows"],
                                 knobs, tmp_path)
        assert ref is not None and ours is not None
        assert ours == ref

    def test_busy_clip_defaults(self, reference_bin, clips, tmp_path):
        ref, ours = both_concats(reference_bin, clips["busy"], {}, tmp_path)
        assert ours == ref

    def test_b_frame_clip(self, reference_bin, clips, tmp_path):
        """B-frame stream: the skip_frame=BIDIR analyzed-frame set and the
        resulting segments must match the reference exactly."""
        ref, ours = both_concats(reference_bin, clips["bframes"],
                                 {"VECTORS_NEEDED": "1"}, tmp_path)
        assert ref is not None and ours == ref

    def test_mpeg4_avi_clip(self, reference_bin, clips, tmp_path):
        """Second codec family (mpeg4/AVI) through both implementations."""
        ref, ours = both_concats(reference_bin, clips["mpeg4_avi"],
                                 {"VECTORS_NEEDED": "1"}, tmp_path)
        assert ref is not None and ours == ref

    def test_hevc_clip(self, reference_bin, tmp_path):
        """HEVC MV side-data path (BASELINE config 3).

        The reference deploys FFmpeg 8, whose hevc decoder exports MV
        side data; FFmpeg < 7 runtimes (this dev box) export none, so the
        scenario is capability-gated: it SKIPS (never silently passes)
        where the linked libavcodec cannot export HEVC MVs.  Both
        implementations link the same libav here, so when the capability
        is present this asserts byte-identical HEVC concat lists.
        """
        from mvtrim_tpu.io import native

        if not native.hevc_mv_export_capable():
            pytest.skip("linked libavcodec exports no HEVC MV side data "
                        "(FFmpeg < 7); deployment image builds FFmpeg 8 "
                        "— see Dockerfile")
        clip = str(tmp_path / "hevc.mp4")
        native.synthesize(clip, width=640, height=480, fps=25.0,
                          duration=12.0, codec="libx265",
                          motion_windows=((2.0, 5.0),))
        ref, ours = both_concats(reference_bin, clip,
                                 {"VECTORS_NEEDED": "1"}, tmp_path)
        assert ref is not None and ours == ref

    def test_intra_only_zero_vec_need(self, reference_bin, tmp_path):
        """The sharpest MV-less divergence: an all-I-frame clip at
        VECTORS_NEEDED=0.  No frame carries side data, so the reference
        finds NO motion at all — while a naive 'zero votes satisfy >= 0'
        reading marks EVERY frame motion.  MVT_PIPELINE=mv pins our MV
        path (the reference has no SAD fallback to compare against)."""
        from mvtrim_tpu.io import native

        clip = str(tmp_path / "intra.mp4")
        native.synthesize(clip, width=320, height=240, fps=25.0,
                          duration=10.0, codec="libx264",
                          motion_windows=((2.0, 4.0),), gop=1)
        binary, shim = reference_bin
        _, ref = harness.run_reference(
            binary, shim, clip, str(tmp_path / "ref_out.mp4"),
            str(tmp_path / "ref_concat.txt"), {"VECTORS_NEEDED": "0"})
        _, ours, _ = harness.run_ours(
            clip, str(tmp_path / "our_out.mp4"),
            str(tmp_path / "our_concat.txt"),
            {"VECTORS_NEEDED": "0", "MVT_PIPELINE": "mv",
             "MVT_SCAN_BACKEND": "oracle", "MVT_LOG": "0"})
        assert ref is None  # no side data anywhere -> no motion
        assert ours == ref

    def test_batch_mode(self, reference_bin, clips, tmp_path):
        """Directory batch (BASELINE config 4): per-file concat lists from
        the reference's parallel streams + cut queue match ours."""
        binary, shim = reference_bin
        in_dir = tmp_path / "in"
        in_dir.mkdir()
        os.symlink(clips["two_windows"], in_dir / "a.mp4")
        os.symlink(clips["busy"], in_dir / "b.mp4")

        ref_dump = tmp_path / "ref_dump"
        our_dump = tmp_path / "our_dump"
        ref_dump.mkdir()
        our_dump.mkdir()
        harness.run_reference(
            binary, shim, str(in_dir), str(tmp_path / "ref_out"),
            str(tmp_path / "r.txt"), {"PARALLEL_STREAMS": "2"},
            dump_dir=str(ref_dump))
        harness.run_ours(
            str(in_dir), str(tmp_path / "our_out"), str(tmp_path / "o.txt"),
            {"PARALLEL_STREAMS": "2", "MVT_SCAN_BACKEND": "oracle",
             "MVT_LOG": "0"},
            dump_dir=str(our_dump))

        def load(d):
            return {f: open(os.path.join(d, f)).read()
                    for f in sorted(os.listdir(d))}

        ref = load(str(ref_dump))
        ours = load(str(our_dump))
        assert set(ref) == {"a.mp4.concat", "b.mp4.concat"}
        assert ours == ref


# Differential-fuzz breadth knob: MVT_FUZZ_N scales the randomized seed
# count (default 6 keeps CI fast; MVT_FUZZ_N=50 runs the wide sweep —
# see CLAUDE.md "Fuzzing").
FUZZ_N = int(os.environ.get("MVT_FUZZ_N", "6"))


def _random_knobs(seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(1000 + seed)
    return {
        "MV_THRESHOLD_SQ": str(float(rng.choice(
            [1.0, 4.0, 9.0, 16.0, 25.0, 64.0]))),
        "VECTORS_NEEDED": str(int(rng.integers(0, 6))),
        "CLUSTERS_NEEDED": str(int(rng.integers(1, 5))),
        "MAX_GAP_SEC": str(round(float(rng.uniform(0.5, 6.0)), 2)),
        "PADDING_SEC": str(round(float(rng.uniform(0.0, 2.0)), 2)),
        "TARGET_FPS": str(int(rng.choice([0, 5, 7, 10]))),
        "CHUNK_DURATION_SEC": str(int(rng.choice([4, 7, 30]))),
        "MIN_SAVINGS_PCT": str(int(rng.choice([0, 5, 50]))),
        # >= 0.07 keeps margin >= 1 on the smallest grid here: the
        # margin-0 neighbor read is UB in the reference
        "VERTICAL_MASK": str(round(float(rng.uniform(0.07, 0.25)), 3)),
    }


def _fuzz_one(reference_bin, clips, tmp_path, knobs, our_extra):
    binary, shim = reference_bin
    _, ref = harness.run_reference(
        binary, shim, clips["two_windows"],
        str(tmp_path / "ref_out.mp4"),
        str(tmp_path / "ref_concat.txt"), knobs)
    our_knobs = dict(knobs)
    our_knobs["JAX_PLATFORMS"] = "cpu"  # device path, CPU-backed
    our_knobs["MVT_LOG"] = "0"
    our_knobs.update(our_extra)
    _, ours, _ = harness.run_ours(
        clips["two_windows"], str(tmp_path / "our_out.mp4"),
        str(tmp_path / "our_concat.txt"), our_knobs)
    # ref None = the reference found no motion and never invoked a
    # cut; ours must agree exactly (None == None), and when both cut
    # the concat lists must be byte-identical
    assert ours == ref, (knobs, our_extra)


class TestRandomizedParity:
    """Differential fuzz: random knob combinations through the compiled
    reference and OUR DEVICE PATH (default bits scan -> word-domain
    cluster op on the CPU backend via JAX_PLATFORMS — the same jit
    program the card runs), asserting byte-identical concat lists.  The fixed
    CONFIGS above use the oracle backend; this class pins the device
    kernels themselves to the reference across the knob space.
    MVT_FUZZ_N widens the sweep (see CLAUDE.md)."""

    @pytest.mark.parametrize("seed", range(FUZZ_N))
    def test_random_knobs_device_path(self, reference_bin, clips,
                                      tmp_path, seed):
        _fuzz_one(reference_bin, clips, tmp_path, _random_knobs(seed), {})


class TestRandomizedParityMvRaw:
    """The same differential fuzz routed through MVT_SCAN_INPUT=mv_raw:
    on-device thresholding + scatter (ops/mv_vote) must match the
    reference across the knob space too — including seeds that force the
    MV-capacity overflow full-chunk restart (tiny MVT_MV_CAPACITY)."""

    @pytest.mark.parametrize("seed", range(max(2, FUZZ_N // 2)))
    def test_random_knobs_mv_raw(self, reference_bin, clips, tmp_path,
                                 seed):
        extra = {"MVT_SCAN_INPUT": "mv_raw"}
        if seed % 2 == 1:
            extra["MVT_MV_CAPACITY"] = "64"  # force overflow restarts
        _fuzz_one(reference_bin, clips, tmp_path,
                  _random_knobs(7000 + seed), extra)


class TestRandomizedParityWords:
    """The same differential fuzz routed through MVT_SCAN_INPUT=words:
    the native mvt_scan_words repack (GIL-released int32 word-layout
    emit — the 32+-core feeder path) must produce byte-identical concat
    lists across the knob space, pinning the native word packing the
    way the bits fuzz pins the byte packing."""

    @pytest.mark.parametrize("seed", range(max(2, FUZZ_N // 2)))
    def test_random_knobs_words(self, reference_bin, clips, tmp_path,
                                seed):
        _fuzz_one(reference_bin, clips, tmp_path,
                  _random_knobs(11000 + seed),
                  {"MVT_SCAN_INPUT": "words"})


class TestRandomizedParityCapResume:
    """Fuzz with the frame cap forced tiny: every chunk cap-resumes many
    times and the carried skip phase must stay reference-exact across
    the knob space (incl. TARGET_FPS draws)."""

    @pytest.mark.parametrize("seed", range(max(2, FUZZ_N // 2)))
    def test_random_knobs_tiny_cap(self, reference_bin, clips, tmp_path,
                                   seed):
        _fuzz_one(reference_bin, clips, tmp_path,
                  _random_knobs(9000 + seed),
                  {"MVT_CHUNK_FRAMES_CAP": "4"})
