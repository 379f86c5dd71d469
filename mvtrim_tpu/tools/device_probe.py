"""device_probe — accelerator/host capability report.

This rebuild's analog of the reference's cacheLineSize build probe
(tools/cacheLineSize.cpp, baked into the build via CMake try_run): instead
of cache-line geometry for padded atomics, what matters here is the device
inventory, the padded grid geometry of the scan ops, and the host CPU
budget for decode workers.  Prints JSON.

Usage: python -m mvtrim_tpu.tools.device_probe
"""

from __future__ import annotations

import json
import sys


def probe() -> dict:
    import jax

    from ..core.config import Config
    from ..core.types import GridGeometry
    from ..utils import system

    cfg = Config.from_env()
    geom_1080 = GridGeometry.build(1920, 1080, cfg)
    devices = system.device_info()
    return {
        "devices": devices,
        "default_backend": jax.default_backend(),
        "host": {
            "cpu_limit": system.detect_cpu_limit(),
            "available_cpus": system.available_cpus(),
            "auto_parallel_streams": system.calculate_parallel_streams(
                cfg.threads_per_stream),
        },
        "scan_geometry_1080p": {
            "grid": [geom_1080.gh, geom_1080.gw],
            "padded": [geom_1080.padded_gh, geom_1080.padded_gw],
            "vertical_margin": geom_1080.y_min,
            "bytes_per_frame": geom_1080.padded_gh * geom_1080.padded_gw,
        },
        "config": {
            "device_batch": cfg.device_batch,
            "scan_backend": cfg.scan_backend,
            "pipeline_mode": cfg.pipeline_mode,
        },
    }


def main(argv: list[str] | None = None) -> int:
    print(json.dumps(probe(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
