"""Fused motion-vector -> vote-grid -> cluster op (the ``mv_raw`` path).

Replaces the reference's per-MV scalar vote loop (motion_scanner.cpp:242-268)
with one device program per batch: each MV is thresholded and mapped to a
grid cell, kept MVs are scatter-added into an int32 ``[GH_p, GW_p]`` vote
grid per frame, and the shared cluster rule (ops/cluster.py) decides.

    votes[b, y, x] = sum_k keep[b, k] * 1(gy[b, k] == y) * 1(gx[b, k] == x)

The scatter does O(M) integer work per frame.  It replaced a formulation
that built the sum as a product of two one-hot matrices, which needs
``(GH_p + GW_p) * M`` floats of temporaries per frame and ran slower than
the scatter on the GPU at every measured shape (PERF.md, Findings).

Exactness notes:

* magnitude test: the reference compares integer (dst-src)^2 against a
  *double* threshold (motion_scanner.cpp:246-251).  ``mag_sq < T`` over
  integers is equivalent to ``mag_sq < ceil(T)``, so we bake a static
  integer bound and keep the compare in int32.
* grid mapping: arithmetic right shift of dst (floor for negatives),
  bounds 0 <= gx < gw, y_min <= gy < y_max — folded into the keep mask;
  dropped MVs are sent to an out-of-range cell that the scatter drops.
* vote saturation at 255 (motion_scanner.cpp:265-266) is skipped: counts
  only feed ``>= vectors_needed`` with vectors_needed <= 255, and
  count > 255 implies both saturated and unsaturated values pass — the
  motion decision is identical.
* integer adds are exact and order-independent, so the scatter's
  nondeterministic update order cannot change a count.
* the motion compare uses max(1, clusters_needed): the reference's early
  exit (motion_scanner.cpp:288-289) requires at least one cluster even for
  CLUSTERS_NEEDED <= 0, and MV-less frames always return false (:219-221).

This path exists for hosts where the MV scatter CPU is the constraint and
for on-device threshold sweeps (ops/sweep.py); the default pipeline
thresholds and packs votes host-side during decode (cheaper H2D) and runs
only the cluster op on device.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import GridGeometry
from .cluster import cluster_counts_traced


def threshold_bound(threshold_sq: float) -> int:
    """Static integer bound b with (mag < threshold_sq) == (mag < b)
    for integer mag (b = ceil of the double threshold)."""
    return int(math.ceil(threshold_sq))


def mv_votes(dst_x, dst_y, src_x, src_y, counts, geom: GridGeometry,
             bound, block_shift: int):
    """Vote grids from raw MV fields.

    dst_x/dst_y/src_x/src_y are int32 [B, M], counts int32 [B] (entries
    at index >= count are padding); ``bound`` is the integer magnitude
    bound (threshold_bound), static or traced.  Returns int32 votes
    [B, GH_p, GW_p].
    """
    b, m = dst_x.shape
    gh_p, gw_p = geom.padded_gh, geom.padded_gw
    dx = dst_x - src_x
    dy = dst_y - src_y
    mag = dx * dx + dy * dy
    gx = jax.lax.shift_right_arithmetic(dst_x, block_shift)
    gy = jax.lax.shift_right_arithmetic(dst_y, block_shift)
    idx = jax.lax.broadcasted_iota(jnp.int32, (b, m), 1)
    keep = ((idx < counts[:, None])
            & (mag >= bound)
            & (gx >= 0) & (gx < geom.gw)
            & (gy >= geom.y_min) & (gy < geom.y_max))
    cell = jnp.where(keep, gy * gw_p + gx, gh_p * gw_p)   # OOB: dropped
    rows = jax.lax.broadcasted_iota(jnp.int32, (b, m), 0)
    votes = jnp.zeros((b, gh_p * gw_p), jnp.int32).at[rows, cell].add(
        1, mode="drop")
    return votes.reshape(b, gh_p, gw_p)


def make_mv_cluster_op_xla(geom: GridGeometry, *, threshold_sq: float,
                           block_shift: int, vectors_needed: int,
                           clusters_needed: int):
    """MV fields [B, M] i32 x4 + counts [B] i32 -> (cluster counts i32
    [B], motion bool [B]).  M is not baked in: the jitted program
    retraces per input shape."""
    bound = threshold_bound(threshold_sq)

    @jax.jit
    def op(dst_x, dst_y, src_x, src_y, counts):
        votes = mv_votes(dst_x, dst_y, src_x, src_y, counts, geom, bound,
                         block_shift)
        n = cluster_counts_traced(votes, geom, vectors_needed)
        # count == 0 <=> the frame carried no MV side data (FFmpeg never
        # attaches an empty list): the reference decides such frames
        # False before phase 2 runs (motion_scanner.cpp:219-221), which
        # the cluster math alone cannot reproduce at vectors_needed == 0
        # (zero votes satisfy >= 0)
        return n, ((n >= jnp.int32(max(1, clusters_needed)))
                   & (counts > 0))

    return op


def pad_mvs(mv_list, m: int):
    """Host helper: list of [n_i, 4] int arrays -> ([B, M] x4 int32, counts).

    Rows are (dst_x, dst_y, src_x, src_y).  Frames with more than M MVs are
    truncated with a flag so callers can re-run them through the oracle.
    """

    b = len(mv_list)
    dst_x = np.zeros((b, m), np.int32)
    dst_y = np.zeros((b, m), np.int32)
    src_x = np.zeros((b, m), np.int32)
    src_y = np.zeros((b, m), np.int32)
    counts = np.zeros((b,), np.int32)
    overflow = np.zeros((b,), bool)
    for i, mvs in enumerate(mv_list):
        mvs = np.asarray(mvs, np.int32).reshape(-1, 4)
        n = mvs.shape[0]
        if n > m:
            overflow[i] = True
            n = m
        counts[i] = n
        dst_x[i, :n] = mvs[:n, 0]
        dst_y[i, :n] = mvs[:n, 1]
        src_x[i, :n] = mvs[:n, 2]
        src_y[i, :n] = mvs[:n, 3]
    return dst_x, dst_y, src_x, src_y, counts, overflow
