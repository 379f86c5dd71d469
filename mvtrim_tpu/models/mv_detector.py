"""MVClusterDetector — the flagship detector model.

Wraps the device kernels into a per-video "model": static (geometry, config)
are baked into jit'd programs; the forward pass maps a batch of per-frame
vote grids (or raw MV fields) to per-frame motion booleans.  This replaces
the reference's MotionScanner::check_frame (motion_scanner.cpp:217-295) with
one device dispatch per DEVICE_BATCH frames instead of one scalar loop per
frame per thread.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import oracle
from ..core.config import Config
from ..core.types import GridGeometry
from ..ops import cluster as cluster_ops
from ..ops import mv_vote
from .backend import resolve_backend


def _resolver(futures, n: int):
    """Zero-arg callable that blocks on each dispatched batch's motion
    and gathers motion bool [n]; ``futures`` holds (lo, hi, motion) per
    batch, whose rows past hi - lo are padding."""
    def resolve():
        out = np.zeros((n,), bool)
        for lo, hi, motion in futures:
            out[lo:hi] = np.asarray(motion)[:hi - lo]
        return out

    return resolve


class MVClusterDetector:
    """Per-video detector: vote grids -> motion decisions.

    The forward program is shape-static: grids are padded to
    (device_batch, padded_gh, padded_gw) and invalid tail frames are masked
    out by the caller via the returned counts (padding grids are all-zero,
    so their motion decision is False and merging is unaffected — MV-less
    frames behave identically in the reference, motion_scanner.cpp:219-221).
    """

    def __init__(self, width: int, height: int, cfg: Config | None = None,
                 device=None):
        self.cfg = cfg or Config.from_env()
        self.geom = GridGeometry.build(width, height, self.cfg)
        self.backend = resolve_backend(self.cfg.scan_backend)
        # pad frames are zero grids = no motion, sliced off in resolve
        self.device_batch = max(1, self.cfg.device_batch)
        # optional pinned device: multi-card batch mode places each video
        # stream's analysis on its own card (parallel/mesh.py assignment)
        self.device = device
        self._bits_op = None  # word-domain op (see scan_bits_async)
        self._mv_op = None

    # --- forward over host-scattered vote grids ---

    def forward_padded(self, votes_padded):
        """jittable forward: votes uint8 [device_batch, GH_p, GW_p] ->
        (cluster counts int32 [B], motion bool [B]).  The op is cached
        process-wide per (geometry, config)."""
        return cluster_ops.make_cluster_op_xla(
            self.geom, self.cfg.vectors_needed,
            self.cfg.clusters_needed)(votes_padded)

    def scan_votes_async(self, grids: np.ndarray):
        """Dispatch vote grids uint8 [N, gh, gw]; return a resolver.

        JAX dispatch is asynchronous: the returned zero-arg callable blocks
        on and returns the motion bool [N].  Callers overlap device work
        with host decode by resolving late (pipeline feeder does).
        """
        n = grids.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        if self.backend == "oracle":
            counts = oracle.count_clusters_batch(
                grids, vectors_needed=self.cfg.vectors_needed,
                y_min=self.geom.y_min, y_max=self.geom.y_max)
            motion = counts >= oracle.effective_clusters_needed(
                self.cfg.clusters_needed)
            return lambda: motion

        db = self.device_batch
        gh_p, gw_p = self.geom.padded_gh, self.geom.padded_gw
        futures = []
        for lo in range(0, n, db):
            hi = min(lo + db, n)
            batch = np.zeros((db, gh_p, gw_p), np.uint8)
            batch[:hi - lo, :grids.shape[1], :grids.shape[2]] = grids[lo:hi]
            _, motion = self.forward_padded(
                jax.device_put(batch, self.device))
            futures.append((lo, hi, motion))

        return _resolver(futures, n)

    def scan_votes(self, grids: np.ndarray) -> np.ndarray:
        """Host entry: vote grids uint8 [N, gh, gw] -> motion bool [N]."""
        return self.scan_votes_async(grids)()

    # --- forward over bit-packed activity masks (default product path) ---

    def scan_bits_async(self, bits: np.ndarray):
        """Dispatch bit-packed activity masks uint8 [N, gh, ceil(gw/8)]
        (native mvt_scan_bits layout); return a resolver for motion [N].

        Same decision as scan_votes_async — the mask is the host-side
        ``votes >= vectors_needed`` threshold, and the cluster rule only
        reads votes through that comparison (motion_scanner.cpp:277-293).
        Device ops run in the WORD domain: frames are re-packed to
        32-cell int32 lanes (ops/cluster.repack_bits_words) and computed
        by word_cluster_counts — see ops/cluster for the byte-domain
        variant the transfer-bound archive path uses instead.
        """
        n = bits.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        if self.backend == "oracle":
            active = np.unpackbits(
                bits, axis=2, bitorder="little")[:, :, :self.geom.gw]
            counts = oracle.count_clusters_batch(
                active, vectors_needed=1,
                y_min=self.geom.y_min, y_max=self.geom.y_max)
            motion = counts >= oracle.effective_clusters_needed(
                self.cfg.clusters_needed)
            return lambda: motion

        return self._words_dispatch(
            lambda lo, hi: cluster_ops.repack_bits_words(
                bits[lo:hi], self.geom), n)

    def scan_bits(self, bits: np.ndarray) -> np.ndarray:
        """Host entry: packed masks uint8 [N, gh, gwb] -> motion bool [N]."""
        return self.scan_bits_async(bits)()

    def _words_dispatch(self, get_rows, n: int):
        """Shared batch/dispatch/resolve loop over word-layout rows —
        the single place the bits and words scan inputs pad, place, and
        dispatch batches.

        ``get_rows(lo, hi) -> int32 [hi-lo, used]`` supplies each
        batch's word rows (scan_bits_async repacks per batch so the
        repack overlaps device work; scan_words_async slices the
        native-emitted layout).  Zero-pad rows/columns decide False and
        are sliced off in resolve.
        """
        db = self.device_batch
        _, used, lanes = cluster_ops.word_geometry(self.geom)
        if self._bits_op is None:
            self._bits_op = cluster_ops.make_cluster_words_op_xla(
                self.geom, self.cfg.clusters_needed)
        op = self._bits_op
        futures = []
        for lo in range(0, n, db):
            hi = min(lo + db, n)
            batch = np.zeros((db, lanes), np.int32)
            batch[:hi - lo, :used] = get_rows(lo, hi)
            _, motion = op(jax.device_put(batch, self.device))
            futures.append((lo, hi, motion))

        return _resolver(futures, n)

    def scan_words_async(self, words: np.ndarray):
        """Dispatch word-layout activity masks int32 [N, gh*gww] (the
        native mvt_scan_words output — already the device kernel's word
        layout); return a resolver for motion [N].

        Identical decisions to scan_bits_async; the per-frame repack
        (repack_bits_words) happened inside the GIL-released native scan,
        so the feeder's per-batch work here is pure batch assembly — the
        many-core scaling path (see benchmarks/feeder_bench.py).
        """
        n = words.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        used = cluster_ops.word_geometry(self.geom)[1]
        assert words.shape[1] == used, (words.shape, used)
        if self.backend == "oracle":
            gwb = (self.geom.gw + 7) // 8
            bits = words.view(np.uint8).reshape(n, self.geom.gh, -1)[
                :, :, :gwb]
            return self.scan_bits_async(np.ascontiguousarray(bits))
        return self._words_dispatch(lambda lo, hi: words[lo:hi], n)

    def scan_words(self, words: np.ndarray) -> np.ndarray:
        """Host entry: word-layout masks int32 [N, gh*gww] -> motion [N]."""
        return self.scan_words_async(words)()

    # --- forward over raw MV fields (on-device thresholding path) ---

    def _build_mv_op(self):
        # one op regardless of MV capacity M: the jitted program retraces
        # per input shape, nothing here bakes M
        if self._mv_op is None:
            self._mv_op = mv_vote.make_mv_cluster_op_xla(
                self.geom, threshold_sq=self.cfg.mv_threshold_sq,
                block_shift=self.cfg.block_shift,
                vectors_needed=self.cfg.vectors_needed,
                clusters_needed=self.cfg.clusters_needed)
        return self._mv_op

    def scan_raw_mvs_async(self, mvs: np.ndarray, counts: np.ndarray):
        """Raw MV path: mvs int16 [N, M, 4] + counts int32 [N] -> resolver
        for motion bool [N].

        Exactness contract: a negative count means the native scanner
        truncated that frame's MV list to the M capacity, so a decision
        over it could differ from the reference — callers MUST re-scan the
        range with a larger capacity first (the pipeline's mv_raw worker
        does, doubling until clean).  We refuse to guess.
        """
        n = mvs.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        overflow = np.nonzero(counts < 0)[0]
        if overflow.size:
            need = int(-counts[overflow].min())
            raise ValueError(
                f"{overflow.size} frame(s) overflowed the MV capacity "
                f"M={mvs.shape[1]} (max real count {need}); re-scan with "
                f"a larger max_mv — a truncated list cannot be decided "
                f"exactly")
        if self.backend == "oracle":
            g = self.geom
            votes = oracle.vote_grids_batch(
                mvs, counts, g.gw, g.gh, threshold_sq=self.cfg.mv_threshold_sq,
                block_shift=self.cfg.block_shift, y_min=g.y_min,
                y_max=g.y_max)
            clusters = oracle.count_clusters_batch(
                votes, vectors_needed=self.cfg.vectors_needed,
                y_min=g.y_min, y_max=g.y_max)
            motion = ((clusters >= oracle.effective_clusters_needed(
                self.cfg.clusters_needed)) & (counts > 0))
            return lambda: motion
        op = self._build_mv_op()
        # pad each dispatch to a power-of-two bucket in [256, device_batch]
        # (zero-count pad frames decide False and are sliced off in
        # resolve): a handful of compiled shapes instead of one, but raw
        # MV fields are heavy (M*8 bytes/frame) and always padding to
        # device_batch would ship mostly zeros for typical chunk sizes
        db = self.device_batch
        m = mvs.shape[1]
        futures = []
        for lo in range(0, n, db):
            hi = min(lo + db, n)
            bucket = min(db, max(256, 1 << (hi - lo - 1).bit_length()))
            batch = np.zeros((bucket, m, 4), mvs.dtype)
            batch[:hi - lo] = mvs[lo:hi]
            cnts = np.zeros((bucket,), np.int32)
            cnts[:hi - lo] = counts[lo:hi]
            batch = jax.device_put(batch, self.device)
            cnts = jax.device_put(cnts, self.device)
            fields = batch.astype(jnp.int32)
            _, motion = op(fields[..., 0], fields[..., 1],
                           fields[..., 2], fields[..., 3], cnts)
            futures.append((lo, hi, motion))

        return _resolver(futures, n)

    def scan_raw_mvs(self, mvs: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Host entry for the raw-MV path (see scan_raw_mvs_async)."""
        return self.scan_raw_mvs_async(mvs, counts)()
