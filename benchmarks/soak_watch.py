"""Watch-daemon soak: feed files continuously, assert RSS stays flat.

Long-lived daemons are the reference's primary deployment mode
(WATCH_MODE=1 under docker-compose); the costliest failure class there is
a slow leak.  This harness drops N clips into a watched directory one by
one, waits for each output, samples the daemon's RSS, and reports the
trend (a healthy daemon plateaus after JIT warmup).  Comparing a run with
MVT_SCAN_BACKEND=oracle (no device) against the default tells framework
growth apart from growth in the device client.  MVT_RSS_LIMIT_MB bounds
the damage of a leak (drain + exit for a supervisor restart).

The daemon this script spawns owns the card.  This parent process must
stay off JAX: it imports only the native media bridge, because a second
JAX process on the card would reserve its memory and starve the daemon.

Usage: python benchmarks/soak_watch.py [--files 10]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rss_mb(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def wait_for(path: str, timeout: float, proc=None) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            return True
        if proc is not None and proc.poll() is not None:
            # daemon died (import error, missing native lib): fail fast
            # instead of spinning out the whole timeout
            return False
        time.sleep(0.25)
    return False


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--files", type=int, default=10)
    parser.add_argument("--timeout-per-file", type=float, default=120.0)
    args = parser.parse_args()

    sys.path.insert(0, REPO)
    from mvtrim_tpu.io import native

    base = tempfile.mkdtemp(prefix="soak_")
    in_dir = os.path.join(base, "in")
    out_dir = os.path.join(base, "out")
    os.makedirs(in_dir)
    os.makedirs(out_dir)
    seed = os.path.join(base, "seed.mp4")
    native.synthesize(seed, width=640, height=480, fps=25.0, duration=10.0,
                      codec="libx264", motion_windows=((2.0, 5.0),))

    env = dict(os.environ, WATCH_MODE="1", MVT_LOG="0",
               PARALLEL_STREAMS="1")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "mvtrim_tpu", in_dir, out_dir],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    samples = []
    try:
        for i in range(args.files):
            staging = os.path.join(base, f"f{i}.mp4")
            shutil.copy(seed, staging)
            os.rename(staging, os.path.join(in_dir, f"f{i}.mp4"))
            # the first file absorbs jit compilation
            timeout = args.timeout_per_file * (4 if i == 0 else 1)
            ok = wait_for(os.path.join(out_dir, f"f{i}.mp4"), timeout,
                          proc=daemon)
            samples.append({"file": i, "processed": ok,
                            "rss_mb": round(rss_mb(daemon.pid), 1)})
            print(f"file {i}: processed={ok} rss={samples[-1]['rss_mb']}MB",
                  file=sys.stderr)
            if not ok:
                break
    finally:
        daemon.terminate()
        try:
            daemon.wait(timeout=30)
        except subprocess.TimeoutExpired:
            # stuck in a long native call: escalate, or the result JSON
            # is lost AND the orphan keeps holding the card
            daemon.kill()
            daemon.wait()
        shutil.rmtree(base, ignore_errors=True)

    processed = sum(1 for s in samples if s["processed"])
    steady = [s["rss_mb"] for s in samples[2:]]  # skip warmup samples
    growth = (steady[-1] - steady[0]) if len(steady) >= 2 else 0.0
    result = {
        "files_processed": processed,
        "rss_samples_mb": [s["rss_mb"] for s in samples],
        "steady_state_growth_mb": round(growth, 1),
        "healthy": processed == args.files and growth < 50.0,
    }
    print(json.dumps(result))
    return 0 if result["healthy"] else 1


if __name__ == "__main__":
    sys.exit(main())
