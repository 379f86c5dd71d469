"""Shared helpers for running the compiled C++ reference side by side with
this framework.  Used by tests/test_reference_parity.py and
benchmarks/compare_reference.py — one place owns the build dir, the build
invocation, and the concat-capture protocol.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = "/tmp/mvt_ref_build"
FAKE_FFMPEG = os.path.join(REPO, "parity", "fake_ffmpeg.sh")


def ensure_reference(build_dir: str = BUILD_DIR) -> tuple[str, str]:
    """Build the reference if needed; returns (binary, interposer_so)."""
    binary = os.path.join(build_dir, "motion_trim")
    shim = os.path.join(build_dir, "libinterpose_system.so")
    if not (os.path.exists(binary) and os.path.exists(shim)):
        subprocess.run(
            [os.path.join(REPO, "parity", "build_reference.sh"), build_dir],
            check=True, capture_output=True, timeout=600)
    return binary, shim


def run_reference(binary: str, shim: str, input_arg: str, output_arg: str,
                  dump: str, env_knobs: dict | None = None,
                  dump_dir: str | None = None, timeout: int = 600):
    """Run the reference with the system() interposer capturing concat
    lists.  Returns (wall_seconds, concat_text_or_None)."""
    if os.path.exists(dump):
        os.unlink(dump)
    env = dict(os.environ)
    env.update(env_knobs or {})
    env["LD_PRELOAD"] = shim
    env["MVT_CONCAT_DUMP"] = dump
    if dump_dir:
        env["MVT_CONCAT_DUMP_DIR"] = dump_dir
    t0 = time.perf_counter()
    res = subprocess.run([binary, input_arg, output_arg], env=env,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"reference failed: {res.stdout}{res.stderr}")
    concat = open(dump).read() if os.path.exists(dump) else None
    return wall, concat


def run_ours(input_arg: str, output_arg: str, dump: str,
             env_knobs: dict | None = None, dump_dir: str | None = None,
             timeout: int = 3600):
    # default covers cold compiles plus the 1-CPU decode of a long clip
    """Run our CLI with the list-capturing ffmpeg stand-in.

    Returns (wall_seconds, concat_text_or_None, stdout_text).
    """
    if os.path.exists(dump):
        os.unlink(dump)
    env = dict(os.environ)
    env.update(env_knobs or {})
    env["MVT_FFMPEG_BIN"] = FAKE_FFMPEG
    env["MVT_CONCAT_DUMP"] = dump
    if dump_dir:
        env["MVT_CONCAT_DUMP_DIR"] = dump_dir
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mvtrim_tpu", input_arg, output_arg],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"rebuild failed: {res.stdout}{res.stderr}")
    concat = open(dump).read() if os.path.exists(dump) else None
    return wall, concat, res.stdout
