#!/usr/bin/env python3
"""Print the paths of an FFmpeg 8 runtime (libavformat 62, libavcodec 62,
libavutil 60) on this host, space-separated, or nothing if there is none.

The Makefile uses it where pkg-config finds no FFmpeg development files:
the library then builds against native/libav_abi.h and links these files.
Searched, in order: the ``*.libs`` directories that Python wheels such as
opencv-python bundle their shared libraries in, then the usual system
library directories.
"""

from __future__ import annotations

import glob
import os
import site
import sys

WANT = (("avformat", 62), ("avcodec", 62), ("avutil", 60))


def candidate_dirs() -> list[str]:
    sites = [p for p in site.getsitepackages() + [site.getusersitepackages()]
             + sys.path if p and os.path.isdir(p)]
    dirs = [d for s in dict.fromkeys(sites)
            for d in sorted(glob.glob(os.path.join(s, "*.libs")))]
    return dirs + ["/usr/local/lib", "/usr/lib/x86_64-linux-gnu",
                   "/usr/lib64", "/usr/lib"]


def find_in(d: str) -> list[str] | None:
    found = []
    for name, major in WANT:
        hits = sorted(
            glob.glob(os.path.join(d, f"lib{name}.so.{major}"))
            + glob.glob(os.path.join(d, f"lib{name}-*.so.{major}.*")))
        if not hits:
            return None
        found.append(hits[0])
    return found


def main() -> int:
    for d in candidate_dirs():
        libs = find_in(d)
        if libs:
            print(" ".join(libs))
            return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
