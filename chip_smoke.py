#!/usr/bin/env python3
"""Smoke run of the trimmer on NVIDIA GPUs: the quickest proof that the
system starts on the card and decides exactly like its NumPy reference.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: phase 5 only

Phases, all in this one process (a JAX process reserves most of a card's
memory, so no second process may touch the card):

1. Card and host: the card line from nvidia-smi, JAX and its devices (a
   platform other than ``gpu`` fails), a clean build of
   native/libmvtrim_host.so from the tracked sources, and the doctor's
   checks.  The native library links FFmpeg's development files where
   pkg-config finds them, else an FFmpeg 8 runtime such as the one inside
   the opencv-python wheels (native/find_libav.py, native/libav_abi.h).
2. Every device program, compiled at 1080p and 4K at the shapes the
   pipeline dispatches: its ``memory_analysis()`` and a bit-equal
   comparison of its decisions with the NumPy reference (core/oracle.py).
3. The main path: synthetic clips from a fixed seed through the CLI
   (``mvtrim_tpu.cli.main``) under every scan payload, a 3-stream
   directory batch, the SAD fallback and 4K, each cut list equal to the
   oracle backend's and each output decodable.  Clips are encoded with
   libx264 where the linked FFmpeg has it, else with mpeg4, whose one MV
   per 16x16 macroblock leaves one vote per grid cell: those runs use
   VECTORS_NEEDED=1, the setting for such streams.
4. The bodies of the GPU-marked tests (tests/test_gpu.py).
5. ``--four-cards`` only: the archive's mesh-sharded ``bits`` and SAD
   steps, and batch mode's one-stream-per-card placement
   (``parallel.mesh.stream_device``, the rule batch.py's stream workers
   use) on detectors fed seeded masks, on four cards, compared with one
   card in this process, with the collectives' share of the step from a
   profiler trace.  Decode is not part of this phase.

Every line that carries a time also carries the card's name and power
limit.  Logs longer than a line go to chiprun_out/chip_smoke/.  The last
line of stdout is one JSON object, printed only when every phase passed:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import importlib.util
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import mvtrim_tpu  # noqa: E402,F401 — before jax: places the compile cache

OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
FPS = 25.0
MAIN_WINDOWS = ((20.0, 26.0), (95.0, 99.0), (170.0, 184.0), (260.0, 263.0))


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


class Ctx:
    """What phase 1 learned (the card line, the devices, the codec) and
    what later phases record: phase 2's program measurements, and the
    compiles that asked the persistent cache and those it answered."""

    def __init__(self, card, devices, codec):
        self.card = card
        self.devices = devices
        self.codec = codec
        self.programs = []
        self.cache = {"/jax/compilation_cache/compile_requests_use_cache": 0,
                      "/jax/compilation_cache/cache_hits": 0}

    def timed(self, what: str, seconds: float, extra: str = "") -> None:
        say(f"{what}: {seconds:.6f} s{extra} | card {self.card}")

    def count_cache_event(self, event: str, **_) -> None:
        """jax.monitoring listener."""
        if event in self.cache:
            self.cache[event] += 1

    def cache_line(self) -> str:
        import jax

        hits, asked = (self.cache["/jax/compilation_cache/cache_hits"],
                       self.cache["/jax/compilation_cache/"
                                  "compile_requests_use_cache"])
        return (f"compile cache {jax.config.jax_compilation_cache_dir}: "
                f"{hits} of {asked} compiles read from it")


# --- phase 1 -------------------------------------------------------------

def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return "; ".join(ln.strip() for ln in r.stdout.splitlines()
                     if ln.strip())


def build_native() -> None:
    """Clean build from the tracked sources, so that a library copied in
    with the checkout is never loaded."""
    native_dir = os.path.join(REPO, "native")
    subprocess.run(["make", "-C", native_dir, "clean"], check=True,
                   capture_output=True)
    r = subprocess.run(["make", "-C", native_dir,
                        f"PYTHON={sys.executable}"],
                       capture_output=True, text=True)
    check(r.returncode == 0, "make -C native failed:\n" + r.stdout[-2000:]
          + r.stderr[-2000:])
    say("native: built from the tracked sources: "
        + next(ln for ln in r.stdout.splitlines() if " -shared " in ln))


def pick_codec(work: str) -> str:
    from mvtrim_tpu.io import native

    say(f"libav versions: {native.libav_versions()}")
    found = []
    for codec in ("libx264", "mpeg4"):
        path = os.path.join(work, f"probe_{codec}.mp4")
        try:
            native.synthesize(path, width=320, height=240, fps=FPS,
                              duration=1.0, codec=codec)
        except RuntimeError as e:
            say(f"encoder {codec}: missing ({e})")
            continue
        found.append(codec)
        say(f"encoder {codec}: present")
    check(found, "no encoder for synthetic clips (libx264 or mpeg4)")
    say(f"synthetic clips use {found[0]}")
    return found[0]


def phase_card_and_host(n_cards: int, work: str) -> Ctx:
    import jax

    devices = jax.devices()
    check(devices[0].platform == "gpu",
          f"JAX found no GPU: {[str(d) for d in devices]}")
    check(len(devices) >= n_cards,
          f"{n_cards} cards needed, JAX has {len(devices)}")
    card = card_line()
    say(f"card: {card}")
    say(f"jax {jax.__version__}: {len(devices)} x {devices[0].platform} "
        f"({devices[0].device_kind})")
    build_native()

    from mvtrim_tpu.tools.doctor import run_checks

    for r in run_checks():
        say(f"doctor [{r['status']}] {r['name']}: {r['detail']}")
        check(r["status"] != "fail",
              f"doctor check {r['name']} failed: {r['detail']}")
    return Ctx(card, devices, pick_codec(work))


# --- phase 2 -------------------------------------------------------------

def _memory(compiled) -> str:
    ma = compiled.memory_analysis()
    return (f"args {ma.argument_size_in_bytes} B, out "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B")


def busy_seconds(trace_dir: str, keep=None) -> float:
    """Device busy time in a profiler trace: the union of the intervals
    of the events on the GPU planes (one piece of work shows on several
    lines of a plane: its module, its ops, its stream), counting only the
    events whose lower-cased name ``keep`` accepts, if given."""
    from jax.profiler import ProfileData

    spans = []
    for path in glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                       "*", "*.xplane.pb")):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                spans += [(ev.start_ns, ev.end_ns) for ev in line.events
                          if keep is None or keep(ev.name.lower())]
    busy, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy, end = busy + hi - lo, hi
        elif hi > end:
            busy, end = busy + hi - end, hi
    return busy / 1e9


def trace_lines(trace_dir: str) -> list[str]:
    """Per line of each GPU plane: its name, event count and summed
    duration — what a reader checks before trusting busy_seconds."""
    from jax.profiler import ProfileData

    out = []
    for path in glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                       "*", "*.xplane.pb")):
        for plane in ProfileData.from_file(path).planes:
            if plane.name.startswith("/device:GPU"):
                out += [f"{plane.name} | {line.name}: "
                        f"{sum(1 for _ in line.events)} events, "
                        f"{sum(e.duration_ns for e in line.events)} ns"
                        for line in plane.lines]
    return out


def _measure(ctx: Ctx, name: str, op, *args, reps: int = 20):
    """Compile ``op`` at the shapes of ``args`` and print its
    memory_analysis; run it once for the caller to check; then trace
    ``reps`` calls and print the device time of one call, the bytes it
    must move (its arguments and results) and its share of the card's
    HBM roofline."""
    import jax

    import bench

    t0 = time.perf_counter()
    compiled = op.lower(*args).compile()
    ctx.timed(f"compile {name}", time.perf_counter() - t0,
              f" | {_memory(compiled)}")
    out = jax.block_until_ready(compiled(*args))
    trace = os.path.join(OUT_DIR, "trace_programs",
                         name.replace(" ", "_").replace("=", ""))
    shutil.rmtree(trace, ignore_errors=True)
    with jax.profiler.trace(trace):
        for _ in range(reps):
            jax.block_until_ready(compiled(*args))
    if not ctx.programs:
        for ln in trace_lines(trace):
            say(f"  trace line {ln}")
    per_call = busy_seconds(trace) / reps
    ma = compiled.memory_analysis()
    moved = ma.argument_size_in_bytes + ma.output_size_in_bytes
    floor = moved / (bench.HBM_GBPS[ctx.devices[0].device_kind] * 1e9)
    ctx.programs.append({"program": name, "device_s": per_call,
                     "bytes": moved, "hbm_floor_s": floor,
                     "roofline_share": floor / per_call,
                     "temp_bytes": ma.temp_size_in_bytes,
                     "card": ctx.card})
    say(f"device time {name}: {per_call * 1e6:.2f} us per call (trace, "
        f"{reps} calls) | {moved} B moved, HBM floor {floor * 1e6:.2f} us, "
        f"{100 * floor / per_call:.2f}% of the HBM roofline | card {ctx.card}")
    return out


def random_masks(rng, n, gh, gw, moving):
    """Activity masks: sparse noise (a cluster by chance on a few per cent
    of frames) plus a moving 4x4 block of active cells on the frames
    flagged in ``moving``."""
    active = rng.random((n, gh, gw)) < 0.001
    for i in np.nonzero(moving)[0]:
        y = 4 + (i * 3) % max(1, gh - 12)
        x = 4 + (i * 5) % max(1, gw - 12)
        active[i, y:y + 4, x:x + 4] = True
    return active


def random_mv_fields(rng, n, m, width, height, moving):
    """Raw MV fields int16 [n, m, 4] + counts: small sub-threshold
    jitter everywhere, and a 4x4-cell block of large vectors on the
    frames flagged in ``moving``."""
    counts = np.minimum(np.exp(rng.uniform(np.log(64), np.log(2049), n)),
                        m).astype(np.int32)
    mvs = np.zeros((n, m, 4), np.int16)
    dst = np.stack([rng.integers(0, width, (n, m)),
                    rng.integers(0, height, (n, m))], -1)
    mvs[..., :2] = dst
    mvs[..., 2:] = dst - rng.integers(-2, 3, (n, m, 2))
    cells = np.array([(16 * cx + 8, 16 * cy + 8) for cx in range(4)
                      for cy in range(4)])
    for i in np.nonzero(moving)[0]:
        c = min(int(counts[i]), m - 32)
        origin = np.array([(i * 80) % (width - 96), 64 + (i * 48) %
                           max(1, height - 192)])
        block = np.concatenate([cells, cells], 0) + origin
        mvs[i, c:c + 32, :2] = block
        mvs[i, c:c + 32, 2:] = block - 9
        counts[i] = c + 32
    return mvs, counts


def phase_programs(ctx: Ctx, batch: int = 2048, m: int = 8192,
                   sad_window: int = 64,
                   sizes=((1920, 1080), (3840, 2160))) -> None:
    import jax

    from mvtrim_tpu.core import oracle
    from mvtrim_tpu.core.config import Config
    from mvtrim_tpu.core.types import GridGeometry
    from mvtrim_tpu.models.sad_detector import sad_oracle_counts
    from mvtrim_tpu.ops import cluster as cluster_ops
    from mvtrim_tpu.ops import mv_vote
    from mvtrim_tpu.ops import sad as sad_ops

    cfg = Config()
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    rng = np.random.default_rng(2)
    dev = ctx.devices[0]
    for w, h in sizes:
        geom = GridGeometry.build(w, h, cfg)
        tag = f"{w}x{h}"
        moving = rng.random(batch) < 0.3
        active = random_masks(rng, batch, geom.gh, geom.gw, moving)
        want = oracle.count_clusters_batch(
            active.astype(np.uint8), vectors_needed=1, y_min=geom.y_min,
            y_max=geom.y_max)

        bits = np.packbits(active, axis=2, bitorder="little")
        _, used, lanes = cluster_ops.word_geometry(geom)
        words = np.zeros((batch, lanes), np.int32)
        words[:, :used] = cluster_ops.repack_bits_words(bits, geom)
        words = jax.device_put(words, dev)
        op = cluster_ops.make_cluster_words_op_xla(geom, cfg.clusters_needed)
        counts, motion = _measure(ctx, f"words {tag} B={batch}", op,
                                  words)
        check(np.array_equal(np.asarray(counts), want),
              f"words {tag}: counts differ from the oracle")
        check(np.array_equal(np.asarray(motion), want >= need),
              f"words {tag}: decisions differ from the oracle")

        votes = np.zeros((batch, geom.padded_gh, geom.padded_gw), np.uint8)
        votes[:, :geom.gh, :geom.gw] = active * cfg.vectors_needed
        votes = jax.device_put(votes, dev)
        op = cluster_ops.make_cluster_op_xla(geom, cfg.vectors_needed,
                                             cfg.clusters_needed)
        counts, _ = _measure(ctx, f"grids {tag} B={batch}", op, votes)
        check(np.array_equal(np.asarray(counts), want),
              f"grids {tag}: counts differ from the oracle")

        mvs, mv_counts = random_mv_fields(rng, batch, m, w, h, moving)
        fields = [jax.device_put(mvs[..., i].astype(np.int32), dev)
                  for i in range(4)]
        cnt = jax.device_put(mv_counts, dev)
        op = mv_vote.make_mv_cluster_op_xla(
            geom, threshold_sq=cfg.mv_threshold_sq,
            block_shift=cfg.block_shift, vectors_needed=cfg.vectors_needed,
            clusters_needed=cfg.clusters_needed)
        n, motion = _measure(ctx, f"mv_raw {tag} B={batch} M={m}", op,
                             *fields, cnt)
        grids = np.stack([oracle.vote_grid(
            mvs[i, :mv_counts[i]], geom.gw, geom.gh,
            threshold_sq=cfg.mv_threshold_sq, block_shift=cfg.block_shift,
            y_min=geom.y_min, y_max=geom.y_max) for i in range(batch)])
        want_mv = oracle.count_clusters_batch(
            grids, vectors_needed=cfg.vectors_needed, y_min=geom.y_min,
            y_max=geom.y_max)
        check(np.array_equal(np.asarray(n), want_mv),
              f"mv_raw {tag}: counts differ from the oracle")
        check(np.array_equal(np.asarray(motion),
                             (want_mv >= need) & (mv_counts > 0)),
              f"mv_raw {tag}: decisions differ from the oracle")

        luma = np.empty((sad_window + 1, h, w), np.uint8)
        luma[:] = rng.integers(0, 200, (h, w), dtype=np.uint8)
        for i in range(1, sad_window + 1, 3):
            y, x = (i * 37) % (h - 200), (i * 53) % (w - 200)
            luma[i, y:y + 150, x:x + 150] = 255
        padded = jax.device_put(sad_ops.pad_luma(luma, geom,
                                                 cfg.block_size), dev)
        op = sad_ops.make_sad_op_xla(
            geom, sad_threshold=cfg.sad_threshold,
            block_size=cfg.block_size, clusters_needed=cfg.clusters_needed)
        counts, _ = _measure(ctx, f"sad {tag} window={sad_window}+1",
                             op, padded)
        want_sad = sad_oracle_counts(luma, geom,
                                     sad_threshold=cfg.sad_threshold,
                                     block_size=cfg.block_size)
        check(np.array_equal(np.asarray(counts), want_sad),
              f"sad {tag}: counts differ from the oracle")
        say(f"phase 2 {tag}: words, grids, mv_raw and sad equal the oracle")
    with open(os.path.join(OUT_DIR, "programs.json"), "w") as f:
        json.dump(ctx.programs, f, indent=1)
    say(f"phase 2: {ctx.cache_line()}")


# --- phase 3 -------------------------------------------------------------

@contextlib.contextmanager
def environ(**knobs):
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update({k: str(v) for k, v in knobs.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(ctx: Ctx, name: str, args, **knobs) -> list[dict]:
    """One CLI invocation in this process, its log under OUT_DIR; returns
    the per-video metrics records (cut list, frames, phase tree)."""
    from mvtrim_tpu.cli import main as cli_main
    from mvtrim_tpu.utils.timing import TimingCollector

    TimingCollector.clear()          # single-file runs do not clear it
    metrics = os.path.join(OUT_DIR, f"{name}.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    with environ(MVT_METRICS_JSON=metrics, **knobs), \
            open(os.path.join(OUT_DIR, f"{name}.log"), "w") as logf, \
            contextlib.redirect_stdout(logf):
        t0 = time.perf_counter()
        rc = cli_main(list(args))
        wall = time.perf_counter() - t0
    check(rc == 0, f"{name}: CLI exit code {rc}")
    with open(metrics) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    frames = sum(r["frames_scanned"] for r in recs)
    for r in recs:
        phases = ", ".join(f"{k.strip(' ├└│─')} {v / 1e6:.6f}"
                           for k, v in r["phases_us"].items())
        say(f"  {name} {os.path.basename(r['input'])}: "
            f"{r['frames_scanned']} frames, {r['decision']}, "
            f"{len(r['cut_segments'])} segments | phases (s): {phases} "
            f"| card {ctx.card}")
    ctx.timed(f"run {name}", wall, f", {frames} frames scanned")
    return recs


def _by_input(recs):
    return {os.path.basename(r["input"]): r for r in recs}


def same_cuts(name, recs, ref_recs) -> None:
    got, want = _by_input(recs), _by_input(ref_recs)
    check(got.keys() == want.keys(), f"{name}: inputs differ")
    for k in want:
        check(got[k]["cut_segments"] == want[k]["cut_segments"],
              f"{name} {k}: cut list differs from the oracle backend's: "
              f"{got[k]['cut_segments']} vs {want[k]['cut_segments']}")
        check(want[k]["decision"] != "no_motion",
              f"{name} {k}: no motion found in a clip with motion")
        out = want[k]["output"]
        for path in {got[k]["output"], out}:
            from mvtrim_tpu.io import native

            with native.VideoReader(path) as r:
                check(r.duration > 0, f"{name}: {path} does not decode")


def phase_end_to_end(ctx: Ctx, work: str, main_sec: float = 300.0,
                     intra_sec: float = 60.0, uhd_sec: float = 20.0,
                     batch_sec: float = 60.0,
                     hd=(1920, 1080), uhd=(3840, 2160)) -> None:
    from mvtrim_tpu.io import native

    scale = main_sec / 300.0
    clips = os.path.join(work, "clips")
    outs = os.path.join(work, "out")
    batch_in = os.path.join(work, "batch_in")
    for d in (clips, outs, batch_in):
        os.makedirs(d, exist_ok=True)

    def synth(path, size, sec, windows, **kw):
        t0 = time.perf_counter()
        native.synthesize(path, width=size[0], height=size[1], fps=FPS,
                          duration=sec, codec=ctx.codec,
                          motion_windows=windows, **kw)
        ctx.timed(f"synthesize {os.path.basename(path)} "
                  f"({size[0]}x{size[1]}, {sec:g} s)",
                  time.perf_counter() - t0)
        return path

    # Sensor noise only under libx264: mpeg4 codes noisy P-frames as intra
    # frames, which carry no motion vectors at all.
    tuning = {} if ctx.codec == "libx264" else {"VECTORS_NEEDED": 1}
    say(f"phase 3: clips in {ctx.codec}, knobs {tuning or 'defaults'}")
    main = synth(os.path.join(clips, "main.mp4"), hd, main_sec,
                 tuple((a * scale, b * scale) for a, b in MAIN_WINDOWS),
                 noise=2 if ctx.codec == "libx264" else 0)
    intra = synth(os.path.join(clips, "intra.mp4"), hd, intra_sec,
                  ((intra_sec * 0.2, intra_sec * 0.3),), gop=1)
    big = synth(os.path.join(clips, "uhd.mp4"), uhd, uhd_sec,
                ((uhd_sec * 0.25, uhd_sec * 0.45),))
    for i in range(3):
        a = batch_sec * (0.1 + 0.25 * i)
        synth(os.path.join(batch_in, f"cam{i}.mp4"), hd, batch_sec,
              ((a, a + batch_sec * 0.1),))

    def out(name):
        return os.path.join(outs, f"{name}.mp4")

    ref = run_cli(ctx, "main_oracle", [main, out("main_oracle")],
                  MVT_SCAN_BACKEND="oracle", MVT_SCAN_INPUT="bits", **tuning)
    for payload in ("bits", "words", "grids", "mv_raw"):
        recs = run_cli(ctx, f"main_{payload}", [main, out(payload)],
                       MVT_SCAN_BACKEND="auto", MVT_SCAN_INPUT=payload,
                       **tuning)
        same_cuts(f"main {payload}", recs, ref)

    ref = run_cli(ctx, "batch_oracle",
                  [batch_in, os.path.join(outs, "batch_oracle")],
                  MVT_SCAN_BACKEND="oracle", PARALLEL_STREAMS=3,
                  MVT_SCAN_INPUT="bits", **tuning)
    recs = run_cli(ctx, "batch_auto",
                   [batch_in, os.path.join(outs, "batch_auto")],
                   MVT_SCAN_BACKEND="auto", PARALLEL_STREAMS=3,
                   MVT_SCAN_INPUT="bits", **tuning)
    check(len(recs) == 3, f"batch: {len(recs)} of 3 files processed")
    same_cuts("batch", recs, ref)

    ref = run_cli(ctx, "intra_oracle", [intra, out("intra_oracle")],
                  MVT_SCAN_BACKEND="oracle", MVT_SCAN_INPUT="bits", **tuning)
    recs = run_cli(ctx, "intra_auto", [intra, out("intra_auto")],
                   MVT_SCAN_BACKEND="auto", MVT_SCAN_INPUT="bits", **tuning)
    check(recs[0]["frames_with_mvs"] == 0, "intra clip carried MVs")
    same_cuts("intra (SAD fallback)", recs, ref)

    for mode in ("mv", "sad"):
        ref = run_cli(ctx, f"uhd_{mode}_oracle", [big, out(f"uhd_o{mode}")],
                      MVT_SCAN_BACKEND="oracle", MVT_PIPELINE=mode,
                      MVT_SCAN_INPUT="bits", **tuning)
        recs = run_cli(ctx, f"uhd_{mode}", [big, out(f"uhd_{mode}")],
                       MVT_SCAN_BACKEND="auto", MVT_PIPELINE=mode,
                       MVT_SCAN_INPUT="bits", **tuning)
        same_cuts(f"4K {mode}", recs, ref)
    say("phase 3: every cut list equals the oracle backend's; every "
        "output decodes")


# --- phase 4 -------------------------------------------------------------

def phase_gpu_tests(ctx: Ctx) -> None:
    path = os.path.join(REPO, "tests", "test_gpu.py")
    spec = importlib.util.spec_from_file_location("gpu_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = sorted(n for n in vars(mod) if n.startswith("test_"))
    check(names, "tests/test_gpu.py holds no tests")
    for name in names:
        fn = getattr(mod, name)
        check(list(inspect.signature(fn).parameters) == ["gpu"],
              f"{name}: GPU test bodies take exactly the `gpu` fixture")
        t0 = time.perf_counter()
        fn(ctx.devices[0])
        ctx.timed(f"gpu test {name} passed", time.perf_counter() - t0)


# --- phase 5 -------------------------------------------------------------

def median_wall(fn, reps: int = 20) -> float:
    """Median host wall time of ``fn()`` over ``reps`` calls, after one
    call that compiles."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


COLLECTIVES = ("all-reduce", "allreduce", "all-gather", "allgather", "nccl")


def collective_share(trace_dir: str) -> tuple[float, float]:
    """(collective device seconds, all device seconds) from a profiler
    trace, collectives recognised by their op or kernel name."""
    return (busy_seconds(trace_dir,
                         lambda name: any(k in name for k in COLLECTIVES)),
            busy_seconds(trace_dir))


def phase_four_cards(ctx: Ctx, frames: int = 8192) -> None:
    import threading

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mvtrim_tpu.core import oracle
    from mvtrim_tpu.core.config import Config
    from mvtrim_tpu.core.types import GridGeometry
    from mvtrim_tpu.models import MVClusterDetector
    from mvtrim_tpu.ops.cluster import packed_geometry
    from mvtrim_tpu.ops.sad import pad_luma
    from mvtrim_tpu.parallel.mesh import (build_mesh, sharded_bits_scan_step,
                                          sharded_sad_scan_step,
                                          stream_device)

    cfg = Config()
    devices = ctx.devices[:4]
    mesh4 = build_mesh(4)
    check(all(d.platform == "gpu" for d in mesh4.devices.ravel()),
          "the four-card mesh holds a non-GPU device")
    mesh1 = build_mesh(1)
    rng = np.random.default_rng(5)

    # archive bits payload: global batches sharded over 'data'
    geom = GridGeometry.build(1920, 1080, cfg)
    moving = rng.random(frames) < 0.2
    active = random_masks(rng, frames, geom.gh, geom.gw, moving)
    packed = np.packbits(active, axis=2, bitorder="little")
    _, used, lanes = packed_geometry(geom)
    flat = np.zeros((frames, lanes), np.uint8)
    flat[:, :used] = packed.reshape(frames, used)
    want = oracle.count_clusters_batch(
        active.astype(np.uint8), vectors_needed=1, y_min=geom.y_min,
        y_max=geom.y_max) >= oracle.effective_clusters_needed(
            cfg.clusters_needed)
    for name, mesh in (("1 card", mesh1), ("4 cards", mesh4)):
        step = sharded_bits_scan_step(geom, cfg, mesh)
        x = jax.device_put(flat, NamedSharding(mesh, P("data", None)))
        motion, total = jax.block_until_ready(step(x))
        check(np.array_equal(np.asarray(motion), want),
              f"archive bits step on {name}: decisions differ")
        check(int(total) == int(want.sum()), f"{name}: psum differs")
        ctx.timed(f"archive bits step, {name}, {frames} frames",
                  median_wall(lambda: jax.block_until_ready(step(x))),
                  " (median of 20)")
    trace = os.path.join(OUT_DIR, "trace_four_cards")
    shutil.rmtree(trace, ignore_errors=True)
    step = sharded_bits_scan_step(geom, cfg, mesh4)
    x = jax.device_put(flat, NamedSharding(mesh4, P("data", None)))
    with jax.profiler.trace(trace):
        for _ in range(5):
            jax.block_until_ready(step(x))
    coll, busy = collective_share(trace)
    say(f"archive bits step, 4 cards, traced x5: collectives {coll:.6f} s "
        f"of {busy:.6f} s device time "
        f"({100 * coll / max(busy, 1e-12):.1f}%) | card {ctx.card}")

    # archive SAD payload
    geom = GridGeometry.build(1920, 1080, cfg)
    n = 64
    luma = rng.integers(0, 256, (n + 1, 1080, 1920), dtype=np.uint8)
    luma[10:30] = luma[9]
    padded = pad_luma(luma, geom, cfg.block_size)
    rows = n // 4
    carries = padded[[0, rows, 2 * rows, 3 * rows]]
    frames_sad = padded[1:]
    valid = np.ones(n, bool)
    for name, mesh, car in (("1 card", mesh1, padded[:1]),
                            ("4 cards", mesh4, carries)):
        step = sharded_sad_scan_step(geom, cfg, mesh)
        args = (jax.device_put(car, NamedSharding(mesh, P("data", None,
                                                          None))),
                jax.device_put(frames_sad, NamedSharding(
                    mesh, P("data", None, None))),
                jax.device_put(valid, NamedSharding(mesh, P("data"))))
        motion, _ = jax.block_until_ready(step(*args))
        if name == "1 card":
            want_sad = np.asarray(motion)
        else:
            check(np.array_equal(np.asarray(motion), want_sad),
                  "archive SAD step: 4 cards differ from 1 card")
        ctx.timed(f"archive sad step, {name}, {n} frames",
                  median_wall(lambda: jax.block_until_ready(step(*args))),
                  " (median of 20)")

    # batch mode: one stream per card, by batch.py's placement rule
    streams = []
    for i in range(4):
        r = np.random.default_rng(100 + i)
        a = random_masks(r, 4096, 68, 120, r.random(4096) < 0.2)
        streams.append(np.packbits(a, axis=2, bitorder="little"))
    one = MVClusterDetector(1920, 1080, cfg, device=devices[0])
    want_streams = [one.scan_bits(s) for s in streams]
    wall_one = median_wall(lambda: [one.scan_bits(s) for s in streams], 5)
    placed = [stream_device(i, devices) for i in range(4)]
    check(len(set(placed)) == 4, f"streams share a card: {placed}")
    dets = [MVClusterDetector(1920, 1080, cfg, device=d) for d in placed]
    got, errors = [None] * 4, []

    def worker(i):
        try:
            got[i] = dets[i].scan_bits(streams[i])
        except BaseException as e:  # re-raised in the main thread
            errors.append(e)

    def four_streams():
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "a stream hung")
        if errors:
            raise errors[0]

    wall_four = median_wall(four_streams, 5)
    for i in range(4):
        check(np.array_equal(got[i], want_streams[i]),
              f"batch stream {i} on card {i} differs from card 0")
    ctx.timed("batch placement, 4 streams on 1 card", wall_one,
              " (median of 5)")
    ctx.timed("batch placement, 4 streams on 4 cards", wall_four,
              " (median of 5)")
    say("phase 5: archive and batch results on four cards equal one card")


# --- driver --------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    os.makedirs(OUT_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        import jax

        ctx = phase_card_and_host(n_cards, work)
        jax.monitoring.register_event_listener(ctx.count_cache_event)
        if args.four_cards:
            phase_four_cards(ctx)
        else:
            phase_programs(ctx)
            phase_end_to_end(ctx, work)
            phase_gpu_tests(ctx)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(ctx.cache_line())
    dev = ctx.devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(ctx.devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
