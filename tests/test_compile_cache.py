"""Where the persistent compilation cache lands.

A JAX_COMPILATION_CACHE_DIR set by the deployment is used as it is and no
other directory is written; with it unset, the cache goes to the one
fixed path inside the checkout (mvtrim_tpu.COMPILE_CACHE_DIR); a second
process hits what the first wrote.  Runs on the CPU backend in
subprocesses with a clean cache configuration.
"""

import os
import subprocess
import sys

import pytest

import mvtrim_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Imports the package BEFORE jax, like the CLI; ``SALT`` makes the
# compiled program's cache key unique to one test run.
_PROG = """
import sys
import mvtrim_tpu
import jax
import jax.numpy as jnp
import numpy as np
from mvtrim_tpu.core.config import Config
from mvtrim_tpu.core.types import GridGeometry
from mvtrim_tpu.ops import cluster as cluster_ops
print("cache_dir", jax.config.jax_compilation_cache_dir)
geom = GridGeometry.build(320, 240, Config())
op = cluster_ops.make_cluster_words_op_xla(geom, 2)
lanes = cluster_ops.word_geometry(geom)[2]
counts, _ = op(jnp.asarray(np.zeros((8, lanes), np.int32)))
salted = jax.jit(lambda x: x * SALT)(jnp.int32(1))
print("counts_sum", int(np.asarray(counts).sum()), int(salted))
"""


def _run(salt, cache_dir=None):
    env = dict(os.environ)
    env.pop("JAX_ENABLE_COMPILATION_CACHE", None)   # conftest's opt-out
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if cache_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    env.update(JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c",
                        _PROG.replace("SALT", str(salt))],
                       env=env, capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"counts_sum 0 {salt}" in r.stdout, r.stdout
    return r.stdout


def _entries(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_compile_cache_round_trip(tmp_path):
    """A second process hits what the first wrote to an explicit
    directory: a hit writes NO new entry; a key-instability miss would
    write a second entry for the same program."""
    salt = int.from_bytes(os.urandom(3), "little") + 2
    cache = str(tmp_path / "jitcache")
    _run(salt, cache)
    entries = _entries(cache)
    assert any(e.endswith("-cache") for e in entries), entries
    _run(salt, cache)
    assert _entries(cache) == entries


@pytest.mark.parametrize("case", ["env_dir", "checkout_default"])
def test_compile_cache_location(tmp_path, case):
    salt = int.from_bytes(os.urandom(3), "little") + 2
    in_checkout = mvtrim_tpu.COMPILE_CACHE_DIR
    before = set(_entries(in_checkout))
    if case == "checkout_default":
        out = _run(salt)
        assert f"cache_dir {in_checkout}" in out, out
        new = set(_entries(in_checkout)) - before
        assert any(e.endswith("-cache") for e in new), new
        return
    cache = str(tmp_path / "jitcache")
    out = _run(salt, cache)
    assert f"cache_dir {cache}" in out, out
    assert any(e.endswith("-cache") for e in _entries(cache))
    # an explicit directory is the only one written
    assert set(_entries(in_checkout)) == before
