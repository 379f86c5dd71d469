"""The one choice of scan backend, shared by every detector."""

from __future__ import annotations

BACKENDS = ("auto", "oracle")


def resolve_backend(requested: str) -> str:
    """MVT_SCAN_BACKEND -> "xla" (the device programs in ops/, compiled
    by XLA for whatever platform JAX runs on) or "oracle" (the NumPy
    reference in core/oracle.py; no device).

    Anything else is refused with the accepted values: a mistyped or
    retired value must not silently pick a path.
    """
    if requested == "auto":
        return "xla"
    if requested == "oracle":
        return "oracle"
    raise ValueError(
        f"MVT_SCAN_BACKEND={requested!r} is not supported; accepted "
        f"values: {', '.join(BACKENDS)}")
