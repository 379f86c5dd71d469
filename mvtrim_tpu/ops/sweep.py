"""Multi-config sweep kernels: score K detector configs in one pass.

The reference evaluates exactly one (MV_THRESHOLD_SQ, VECTORS_NEEDED,
CLUSTERS_NEEDED) triple per process run; tuning means re-decoding the
video once per candidate.  On the device the marginal cost of extra
configs is a few elementwise ops per frame, so a whole tuning grid rides
one decode:

* ``make_vote_sweep_op``  — vote grids were scattered host-side with a
  fixed MV threshold, so the sweep covers (vectors_needed,
  clusters_needed) pairs: [B, GH, GW] votes x [K] configs -> bool [B, K].
* ``make_mv_sweep_op``    — raw MV fields; the magnitude threshold is
  traced too, so the sweep covers (threshold_bound, vectors_needed,
  clusters_needed) triples.

Configs are *data* (traced arrays), not compile-time constants: one
compiled program serves any K of the same static shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import GridGeometry
from .cluster import cluster_counts_traced as _cluster_counts_traced
from .mv_vote import mv_votes


def make_vote_sweep_op(geom: GridGeometry):
    """(votes u8 [B, GH, GW], vec_needs i32 [K], clusters_needs i32 [K])
    -> motion bool [B, K].

    Caveat for vec_need <= 0 columns: a zero vote grid cannot represent
    "no MV side data", so this op alone cannot reproduce the reference's
    unconditional ``!sd -> false`` (motion_scanner.cpp:219-221) — zero
    votes satisfy ``>= 0`` and MV-less frames would decide True.  Callers
    sweeping vec <= 0 must mask MV-less frames themselves (tools/tune.py
    does, from scan_grids_multi's per-frame has_mv flags)."""

    @jax.jit
    def op(votes, vec_needs, clusters_needs):
        v = votes.astype(jnp.int32)

        def per_config(vec_need, clust_need):
            counts = _cluster_counts_traced(v, geom, vec_need)
            return counts >= jnp.maximum(1, clust_need)

        return jax.vmap(per_config, out_axes=1)(vec_needs, clusters_needs)

    return op


def make_sad_sweep_op(geom: GridGeometry, block_size: int):
    """Pixel-domain sweep: K (sad_threshold, clusters_needed) configs
    from one luma decode.

    (luma u8 [N, H_p, W_p], bounds i32 [K], clusters_needs i32 [K])
    -> motion bool [N-1, K]: row i is the decision for luma[i+1]
    compared against luma[i] (row 0 is the predecessor/carry, exactly
    the SADDetector windowing — models/sad_detector.py).

    ``bounds`` are integer SAD-sum bounds (ops/sad.sad_threshold_sum,
    ceil(threshold * block_area)) so the compare stays int32-exact.
    The |diff| + block reduction runs ONCE and is shared by every
    config; each sweep point costs one traced cluster pass
    (cluster_counts_traced with the SAD bound as the activity
    threshold) — the same math the single-config SAD ops dispatch
    (ops/sad.make_sad_op_xla).  The reference needs one full re-run
    per config triple (config.hpp single-triple-per-process); it has
    no pixel-domain path at all (motion_scanner.cpp:219-221 decides
    MV-less frames False), so this sweeps a capability extension.

    Same reduce_window formulation as the single-config SAD op
    (ops/sad.make_sad_op_xla).
    """

    @jax.jit
    def op(luma, bounds, clusters_needs):
        x = luma.astype(jnp.int32)
        diff = jnp.abs(x[1:] - x[:-1])                     # [N-1, H, W]
        sad = jax.lax.reduce_window(
            diff, 0, jax.lax.add,
            window_dimensions=(1, block_size, block_size),
            window_strides=(1, block_size, block_size),
            padding="VALID")                               # [N-1, gh, gw]

        def per_config(bound, clust_need):
            counts = _cluster_counts_traced(sad, geom, bound)
            return counts >= jnp.maximum(1, clust_need)

        return jax.vmap(per_config, out_axes=1)(bounds, clusters_needs)

    return op


def make_mv_sweep_op(geom: GridGeometry, block_shift: int):
    """Raw-MV sweep: thresholds are traced data.

    (dst_x/dst_y/src_x/src_y i32 [B, M], counts i32 [B],
     bounds i32 [K], vec_needs i32 [K], clusters_needs i32 [K])
    -> motion bool [B, K].

    ``bounds`` are integer magnitude bounds (ceil of the double threshold,
    ops/mv_vote.threshold_bound) so the compare is exact.  The vote
    scatter is the single-config op's (ops/mv_vote.mv_votes), run once
    per sweep point.
    """

    @jax.jit
    def op(dst_x, dst_y, src_x, src_y, counts, bounds, vec_needs,
           clusters_needs):
        def per_config(bound, vec_need, clust_need):
            votes = mv_votes(dst_x, dst_y, src_x, src_y, counts, geom,
                             bound, block_shift)
            n = _cluster_counts_traced(votes, geom, vec_need)
            # count == 0 <=> no MV side data (FFmpeg never attaches an
            # empty list): the reference decides such frames False before
            # phase 2 runs (motion_scanner.cpp:219-221) — unreachable from
            # the votes alone at vec_need == 0, where zero votes satisfy
            # >= 0
            return (n >= jnp.maximum(1, clust_need)) & (counts > 0)

        return jax.vmap(per_config, out_axes=1)(bounds, vec_needs,
                                                clusters_needs)

    return op
