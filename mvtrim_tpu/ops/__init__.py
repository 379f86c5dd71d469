"""Device ops: cluster detection, fused MV scatter, block SAD,
segmentation, multi-config sweeps."""

from .cluster import (cluster_counts, cluster_counts_traced,
                      make_cluster_op_xla, pad_votes)
from .mv_vote import make_mv_cluster_op_xla, pad_mvs, threshold_bound
from .sad import make_sad_op_xla, pad_luma
from .segmentation import make_segment_op
from .sweep import make_mv_sweep_op, make_vote_sweep_op

__all__ = [
    "cluster_counts", "cluster_counts_traced", "make_cluster_op_xla",
    "pad_votes", "make_mv_cluster_op_xla", "pad_mvs", "threshold_bound",
    "make_sad_op_xla", "pad_luma", "make_segment_op",
    "make_mv_sweep_op", "make_vote_sweep_op",
]
