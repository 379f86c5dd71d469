"""bench.py smoke: the metric surface must emit one valid headline JSON
line on the CPU backend, where no roofline share may be reported.

Runs the real bench.py in a subprocess with tiny MVT_BENCH_B/ITERS: the
XLA words path audits against the oracle, and exactly one JSON object
with the contract keys must appear on stdout.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_emits_headline_json():
    env = dict(os.environ)
    env.update(MVT_BENCH_B="256", MVT_BENCH_ITERS="8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # pin the CPU platform in code as well, like conftest does
    prog = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import runpy\n"
        "runpy.run_path('bench.py', run_name='__main__')\n"
    )
    r = subprocess.run([sys.executable, "-c", prog], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    json_lines = [ln for ln in r.stdout.splitlines()
                  if ln.startswith("{")]
    assert len(json_lines) == 1, (r.stdout, r.stderr[-2000:])
    rec = json.loads(json_lines[0])
    assert rec["metric"] == "1080p_scan_frames_per_sec_per_device"
    for key in ("value", "unit", "impl", "device", "roofline_gbps",
                "bytes_per_frame", "audit"):
        assert key in rec, (key, rec)
    # on CPU the XLA words path must audit (checksum ok) and report no
    # device metric: no roofline, no share of one
    assert rec.get("audit_failed") is None, rec
    assert rec["value"] > 0
    assert rec["impl"] == "xla-words"
    assert rec["device"]["platform"] == "cpu"
    assert rec["roofline_gbps"] is None
    assert "pct_of_roofline" not in rec


def test_bench_roofline_table():
    """The roofline is looked up by device kind: the H100 has its
    data-sheet figure, an unknown accelerator is an error, and the CPU
    has none."""
    import importlib.util
    from types import SimpleNamespace

    import pytest

    spec = importlib.util.spec_from_file_location(
        "bench_mod", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    h100 = SimpleNamespace(platform="gpu",
                           device_kind="NVIDIA H100 80GB HBM3")
    assert bench._roofline_gbps(h100) == 3350.0
    assert bench._roofline_gbps(
        SimpleNamespace(platform="cpu", device_kind="cpu")) is None
    with pytest.raises(SystemExit, match="no HBM roofline"):
        bench._roofline_gbps(SimpleNamespace(platform="gpu",
                                             device_kind="Unknown GPU"))


def test_dispatch_batch_bench_smoke():
    """The cross-video dispatch-batching decision tool (PERFORMANCE.md
    "Cross-video dispatch batching") must keep running and keep its
    oracle audit: all three strategies bit-equal the oracle motion
    vector, JSON contract keys present."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "benchmarks/dispatch_batch_bench.py",
         "--videos", "3", "--frames", "16", "--width", "320",
         "--height", "240", "--repeats", "2"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    json_lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(json_lines) == 1, (r.stdout, r.stderr[-2000:])
    rec = json.loads(json_lines[0])
    assert rec["bench"] == "dispatch_batch"
    assert rec["platform"] == "cpu"
    assert "bit-equal the oracle" in rec["audit"]
    for strat in ("pervideo", "pipelined", "merged"):
        assert rec[strat]["median_s"] > 0, rec
    assert rec["pervideo"]["dispatches"] == 3
    assert rec["merged"]["dispatches"] == 1
