"""motion-estimated-video-trimmer on JAX.

A ground-up JAX/XLA rebuild of the capabilities of
Vaibhav-20022002/Motion-Estimated-Video-Trimmer (pure C++/FFmpeg reference):
codec motion-vector scanning of surveillance video, cluster-based motion
detection, temporal segmentation, and lossless FFmpeg-level cutting —
with the per-frame analysis running as batched device programs instead of
per-thread scalar loops.

Layout:
  core/      config knobs (identical env names), value types, NumPy oracle
  ops/       XLA device ops (vote/cluster, fused MV, SAD, segmentation)
  models/    detector "model" families wrapping the ops (MV, SAD)
  io/        host media layer: ctypes bridge to the native C++ decode library
  cut/       lossless cut executors (native remux / external ffmpeg) + job queue
  pipeline/  single-video driver (probe -> scan -> segment -> cut)
  batch/     multi-video scheduler, watch mode, mesh sharding of streams
  parallel/  device mesh discovery and sharded scan steps
  utils/     logging, phase timing
  tools/     extract_mvs / motion_scalar equivalents
"""

__version__ = "0.1.0"

import os as _os
import sys as _sys

# Persistent jit cache.  CLI invocations are short-lived processes whose
# scan programs repeat across runs for a given (geometry, config).  A
# JAX_COMPILATION_CACHE_DIR set by the deployment is used as it is;
# otherwise the cache lives at one fixed path inside the checkout (the
# path is part of JAX's cache key, so it must not move between runs).
# Every program is cached: the scan programs compile in under a second
# on the GPU, below JAX's default floor for caching.
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _os.environ["JAX_COMPILATION_CACHE_DIR"] = COMPILE_CACHE_DIR
_os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
if "jax" in _sys.modules:  # imported first: its config has read env
    _sys.modules["jax"].config.update(
        "jax_compilation_cache_dir", _os.environ["JAX_COMPILATION_CACHE_DIR"])
    _sys.modules["jax"].config.update(
        "jax_persistent_cache_min_compile_time_secs",
        float(_os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]))

from .core.config import Config
from .core.types import TimeSegment, ScanTask, GridGeometry

__all__ = ["Config", "TimeSegment", "ScanTask", "GridGeometry",
           "COMPILE_CACHE_DIR", "__version__"]
