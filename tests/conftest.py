"""Test harness: force an 8-device virtual CPU mesh before JAX backends init.

The suite runs on the CPU backend, where multi-card sharding is validated
on virtual devices exactly like __graft_entry__.dryrun_multichip.  The
platform is pinned in code as well as by JAX_PLATFORMS, so the suite
stays on the CPU on a machine with a card.  Tests that need the card are
marked ``gpu`` (tests/test_gpu.py) and skip here.  The persistent
compilation cache is off, in this process and in the children tests
spawn: concurrent workers must not write one directory at once.
"""

import os

os.environ.setdefault("JAX_NUM_CPU_DEVICES", "8")
# read by this process's jax and inherited by every child a test spawns
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if jax.config.jax_platforms != "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
