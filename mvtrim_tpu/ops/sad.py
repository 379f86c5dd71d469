"""Pixel-domain block SAD op — the MV-less fallback path.

For intra-only / MV-less streams (BASELINE.json config 2) the codec offers
no motion vectors, so motion is measured from decoded luma directly: per
16x16 block, the sum of absolute differences against the previous analyzed
frame.  A block is "active" when its mean absolute difference clears
``sad_threshold``; active blocks then run through the same 4-neighbor
cluster rule as the MV path (ops/cluster.py), so segmentation semantics
are shared.

The reference has no such path (it simply detects nothing on MV-less
input — check_frame returns false without side data,
motion_scanner.cpp:219-221); this is a capability extension the north
star requires.

One XLA build: the uint8 -> int32 cast, the absolute difference and the
``reduce_window`` block sums fuse into one pass over the luma.  Integer
sums are exact, so no matmul precision is involved.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import GridGeometry
from .cluster import cluster_counts_traced


def sad_threshold_sum(sad_threshold: float, block_size: int) -> int:
    """Active iff block SAD sum >= ceil(threshold * block_area).

    ``sad_threshold`` is a mean-absolute-difference per pixel; comparing
    against the integer SAD sum keeps the op in int32.
    """
    return int(math.ceil(sad_threshold * block_size * block_size))


def make_sad_op_xla(geom: GridGeometry, *, sad_threshold: float,
                    block_size: int, clusters_needed: int, device=None):
    """luma uint8 [B+1, H_p, W_p] (frame 0 = previous carry) ->
    (cluster counts int32 [B], motion bool [B]).

    H_p/W_p must be multiples of block_size (zero-pad; pad pixels diff to
    zero and cannot activate a block).  ``device`` pins the dispatch to
    one card (multi-card batch mode assigns each stream its own).
    """
    bound = sad_threshold_sum(sad_threshold, block_size)
    eff = max(1, clusters_needed)

    @jax.jit
    def op_jit(luma):
        x = luma.astype(jnp.int32)
        diff = jnp.abs(x[1:] - x[:-1])                     # [B, H, W]
        sad = jax.lax.reduce_window(
            diff, 0, jax.lax.add,
            window_dimensions=(1, block_size, block_size),
            window_strides=(1, block_size, block_size),
            padding="VALID")                               # [B, gh_p, gw_p]
        counts = cluster_counts_traced(sad, geom, bound)
        return counts, counts >= jnp.int32(eff)

    if device is None:
        return op_jit

    def op(luma):
        return op_jit(jax.device_put(luma, device))

    return op


def pad_luma(luma: np.ndarray, geom: GridGeometry,
             block_size: int) -> np.ndarray:
    """Zero-pad [N, H, W] luma to block-aligned padded grid extents."""
    n, h, w = luma.shape
    h_p = geom.padded_gh * block_size
    w_p = geom.padded_gw * block_size
    out = np.zeros((n, h_p, w_p), np.uint8)
    out[:, :h, :w] = luma
    return out
