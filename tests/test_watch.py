"""Watch-mode daemon behavior (reference batch_processor.cpp:237-305).

Runs BatchProcessor in watch mode on a directory, drops a new file in
while it's running, and checks it gets picked up and processed; then
terminates via stop() (which the reference cannot do — its stop_watch_
is never set, SURVEY.md §3.3).
"""

import os
import shutil
import threading
import time

import pytest

from mvtrim_tpu.batch.batch import BatchProcessor
from mvtrim_tpu.core.config import Config
from mvtrim_tpu.io import native


def wait_for(predicate, timeout=90.0, interval=0.25):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(scope="module")
def small_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("watch") / "seed.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=6.0,
                      codec="libx264", motion_windows=((1.0, 3.0),))
    return path


class TestWatchMode:
    def test_watch_keeps_full_concurrency(self):
        """The initial file count says nothing about a daemon's future
        load: watch mode keeps every stream worker alive (the reference
        caps by CPUs only, batch_processor.cpp:81-83); one-shot batches
        still never spawn workers that cannot receive a file."""
        bp = BatchProcessor(num_streams=4)
        want = bp.num_streams  # may be CPU-clamped below 4
        assert bp._plan_streams(0, watch=True) == want
        assert bp._plan_streams(1, watch=True) == want
        assert bp._plan_streams(1, watch=False) == 1
        assert bp._plan_streams(0, watch=False) == want

    def test_new_file_detected_and_processed(self, small_clip, tmp_path):
        in_dir = tmp_path / "in"
        out_dir = tmp_path / "out"
        in_dir.mkdir()
        out_dir.mkdir()
        shutil.copy(small_clip, in_dir / "first.mp4")

        cfg = Config(watch_mode=True, scan_backend="oracle",
                     parallel_streams=1)
        bp = BatchProcessor(1, cfg)
        result = {}

        def run():
            result["failures"] = bp.process(
                [str(in_dir / "first.mp4")], str(out_dir), str(in_dir))

        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            assert wait_for(lambda: (out_dir / "first.mp4").exists()), \
                "initial file not processed"
            # drop a new file in atomically (write elsewhere, rename):
            # the watcher's 500ms size-stability check must accept it
            staging = tmp_path / "second.mp4"
            shutil.copy(small_clip, staging)
            os.rename(staging, in_dir / "second.mp4")
            assert wait_for(lambda: (out_dir / "second.mp4").exists()), \
                "watched file not processed"
        finally:
            bp.stop()
        t.join(timeout=60)
        assert not t.is_alive(), "watch mode did not terminate after stop()"
        assert result.get("failures") == 0

    def test_existing_output_not_reprocessed(self, small_clip, tmp_path):
        in_dir = tmp_path / "in2"
        out_dir = tmp_path / "out2"
        in_dir.mkdir()
        out_dir.mkdir()
        shutil.copy(small_clip, in_dir / "v.mp4")
        sentinel = out_dir / "v.mp4"
        sentinel.write_bytes(b"sentinel")

        cfg = Config(watch_mode=True, scan_backend="oracle")
        bp = BatchProcessor(1, cfg)
        t = threading.Thread(
            target=lambda: bp.process([], str(out_dir), str(in_dir)),
            daemon=True)
        t.start()
        try:
            time.sleep(4.0)  # a couple of poll cycles
            assert sentinel.read_bytes() == b"sentinel"
        finally:
            bp.stop()
        t.join(timeout=30)
        assert not t.is_alive()

    def test_rss_watchdog_stops_daemon(self, tmp_path):
        """MVT_RSS_LIMIT_MB: a bound below the process's RSS makes the
        watch monitor stop on its own (supervisor-restart mitigation for
        leaky transports; see benchmarks/soak_watch.py)."""
        in_dir = tmp_path / "in3"
        out_dir = tmp_path / "out3"
        in_dir.mkdir()
        out_dir.mkdir()

        cfg = Config(watch_mode=True, scan_backend="oracle",
                     rss_limit_mb=1.0)  # any real process exceeds 1MB
        bp = BatchProcessor(1, cfg)
        result = {}
        t = threading.Thread(
            target=lambda: result.update(
                rc=bp.process([], str(out_dir), str(in_dir))),
            daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "watchdog did not stop the daemon"
        assert result["rc"] == 0

    def test_abort_drops_backlog_stop_drains_it(self):
        """Ctrl+C (abort) drops queued work so workers exit right after
        the file in flight; stop() alone keeps draining the backlog —
        the RSS watchdog's drain-and-exit relies on that."""
        cfg = Config(watch_mode=False, scan_backend="oracle")
        bp = BatchProcessor(1, cfg)
        bp._work.put("a.mp4")
        bp._work.put("b.mp4")
        assert bp._get_next_file() == "a.mp4"
        bp.abort()
        assert bp._get_next_file() is None, "abort must drop the backlog"

        bp2 = BatchProcessor(1, cfg)
        bp2._work.put("a.mp4")
        bp2.stop()
        assert bp2._get_next_file() == "a.mp4", \
            "stop() must still drain queued work"

        wcfg = Config(watch_mode=True, scan_backend="oracle")
        bp3 = BatchProcessor(1, wcfg)
        bp3._work.put("a.mp4")
        bp3.abort()
        assert bp3._get_next_file() is None, \
            "watch-mode branch must honor abort too"

    def test_sigint_terminates_watch_daemon(self, small_clip, tmp_path):
        """Process-level Ctrl+C: SIGINT to a running watch daemon must
        terminate the process cleanly — the non-daemon monitor and stream
        workers would otherwise keep polling and hang interpreter
        shutdown forever (the C++ reference never has this failure mode:
        SIGINT default-kills the whole process)."""
        import signal
        import subprocess
        import sys

        in_dir = tmp_path / "sig_in"
        out_dir = tmp_path / "sig_out"
        in_dir.mkdir()
        out_dir.mkdir()
        shutil.copy(small_clip, in_dir / "v.mp4")
        child = (
            # pin the CPU platform like conftest does — the oracle
            # backend shouldn't dispatch, but a stray jit must stay here
            "import jax\n"
            "if jax.config.jax_platforms != 'cpu':\n"
            "    jax.config.update('jax_platforms', 'cpu')\n"
            "from mvtrim_tpu.batch.batch import BatchProcessor\n"
            "from mvtrim_tpu.core.config import Config\n"
            "cfg = Config(watch_mode=True, scan_backend='oracle',\n"
            "             parallel_streams=1)\n"
            "bp = BatchProcessor(1, cfg)\n"
            f"rc = bp.process([{str(in_dir / 'v.mp4')!r}],\n"
            f"                {str(out_dir)!r}, {str(in_dir)!r})\n"
            "print('EXITED', rc, flush=True)\n"
        )
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd() + os.pathsep + \
            env.get("PYTHONPATH", "")
        p = subprocess.Popen([sys.executable, "-c", child], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        try:
            assert wait_for(
                lambda: (out_dir / "v.mp4").exists(), timeout=120), \
                "initial file never processed"
            p.send_signal(signal.SIGINT)
            out, _ = p.communicate(timeout=90)
        except Exception:
            p.kill()
            p.wait()
            raise
        tail = out.decode(errors="replace")[-2000:]
        assert "EXITED 0" in tail, tail
        assert p.returncode == 0, tail
