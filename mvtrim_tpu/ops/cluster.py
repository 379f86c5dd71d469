"""Cluster-detection device ops.

Replaces the per-frame scalar phase-2 loop (reference
motion_scanner.cpp:277-293) with a batched, branch-free program over
``[B, GH, GW]`` vote grids:

  active(c)   = votes(c) >= vectors_needed
  cluster(c)  = active(c) AND any 4-neighbor active, for centers with
                y in [y_min, y_max), x in [1, gw-2]
  motion      = count(cluster) >= clusters_needed

Neighbor reads use zero-vote fill, matching the reference's vote-free
in-allocation rows (and *defining* the margin==0 case the reference leaves
as UB — motion_scanner.cpp:285-286).  The reference's early exit at the
Nth cluster is replaced by a full count + compare: identical decision.

Three payload layouts share that rule: uint8 vote grids (``grids``),
bit-packed activity bytes (the mesh archive step) and int32 words of 32
cells (the detector's ``bits``/``words`` inputs).  Every op here is plain
``jax.numpy``: XLA fuses the shifts, masks and reduction into one pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import GridGeometry


def _shift2d(v, dy: int, dx: int):
    """Shift a [..., H, W] array by (dy, dx), filling with zeros.

    Value at (y, x) of the result is v[y - dy, x - dx] (or 0 off-edge), so
    _shift2d(v, 0, 1) holds each cell's *left* neighbor.
    """
    pads = [(0, 0)] * (v.ndim - 2) + [
        (max(dy, 0), max(-dy, 0)),
        (max(dx, 0), max(-dx, 0)),
    ]
    padded = jnp.pad(v, pads)
    h, w = v.shape[-2], v.shape[-1]
    start_y = max(-dy, 0)
    start_x = max(-dx, 0)
    return padded[..., start_y:start_y + h, start_x:start_x + w]


def _center_mask(geom: GridGeometry, padded_gh: int, padded_gw: int):
    """Static mask of valid cluster centers (motion_scanner.cpp:277-280)."""
    ys = jax.lax.broadcasted_iota(jnp.int32, (padded_gh, padded_gw), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (padded_gh, padded_gw), 1)
    return ((ys >= geom.y_min) & (ys < geom.y_max)
            & (xs >= 1) & (xs <= geom.gw - 2))


def cluster_counts_traced(votes_i32, geom: GridGeometry, vec_need):
    """int32 votes [..., GH, GW] -> int32 cluster counts [...].

    ``vec_need`` may be a Python int or a traced int32 scalar — the single
    source of the cluster rule for the detector ops, the sweep ops, the
    SAD path and the mesh-sharded scan steps (which vary the threshold as
    data).
    """
    vec_need = jnp.asarray(vec_need, jnp.int32)
    active = votes_i32 >= vec_need
    # any 4-neighbor >= vec_need  <=>  max of 4-neighbors >= vec_need
    neighbor_max = jnp.maximum(
        jnp.maximum(_shift2d(votes_i32, 0, 1), _shift2d(votes_i32, 0, -1)),
        jnp.maximum(_shift2d(votes_i32, 1, 0), _shift2d(votes_i32, -1, 0)),
    )
    mask = _center_mask(geom, votes_i32.shape[-2], votes_i32.shape[-1])
    cluster = active & (neighbor_max >= vec_need) & mask
    return jnp.sum(cluster.astype(jnp.int32), axis=(-2, -1))


def pad_votes(votes, geom: GridGeometry):
    """Pad host vote grids [B, gh, gw] -> [B, GH, GW] (zero votes)."""
    b, gh, gw = votes.shape
    return jnp.pad(votes, ((0, 0), (0, geom.padded_gh - gh),
                           (0, geom.padded_gw - gw)))


@functools.lru_cache(maxsize=64)
def make_cluster_op_xla(geom: GridGeometry, vectors_needed: int,
                        clusters_needed: int):
    """votes_u8 [B, GH, GW] -> (counts i32, motion bool).

    Cached per (geometry, config): detectors for videos sharing a
    geometry reuse one compiled program."""

    @jax.jit
    def op(votes):
        counts = cluster_counts_traced(votes.astype(jnp.int32), geom,
                                       vectors_needed)
        return counts, counts >= jnp.int32(max(1, clusters_needed))

    return op


def packed_geometry(geom: GridGeometry) -> tuple[int, int, int]:
    """(gwb, used, L): bytes per row, used bytes per frame, and the flat
    length (used rounded up to 128) of the packed-domain layout."""
    gwb = (geom.gw + 7) // 8
    used = geom.gh * gwb
    lanes = ((used + 127) // 128) * 128
    return gwb, used, lanes


def _packed_masks(geom: GridGeometry):
    """Per-byte constants for the packed-domain cluster math.

    center[j]: bit k set iff cell (y=j//gwb, x=8*(j%gwb)+k) is a valid
    cluster center (x in [1, gw-2], y in [y_min, y_max)) — the same mask
    _center_mask applies in the unpacked domain.
    not_first_row / not_last_row: zero the row-neighbor bytes that a
    cyclic lane roll would wrap across frame/row boundaries, reproducing
    the zero-fill shift semantics exactly.
    """
    gwb, used, lanes = packed_geometry(geom)
    center = np.zeros((lanes,), np.int32)
    not_first = np.zeros((lanes,), np.int32)
    not_last = np.zeros((lanes,), np.int32)
    for j in range(used):
        y, c = divmod(j, gwb)
        if y >= 1:
            not_first[j] = 0xFF
        if y < geom.gh - 1:
            not_last[j] = 0xFF
        if not (geom.y_min <= y < geom.y_max):
            continue
        bits = 0
        for k in range(8):
            x = 8 * c + k
            if 1 <= x <= geom.gw - 2:
                bits |= 1 << k
        center[j] = bits
    return center, not_first, not_last


def _roll(v, shift: int):
    """Cyclic shift of the lanes (axis -1) by a non-negative amount."""
    return jnp.roll(v, shift, axis=-1)


def packed_cluster_counts(a_i32, geom: GridGeometry, masks):
    """Packed-domain cluster counts: int32 byte values [B, L] -> [B].

    Each lane holds one packed byte (8 cells along x, little bit order —
    the native mvt_scan_bits layout flattened row-major).  The
    active/4-neighbor/mask rule runs entirely in the packed domain:
    x-neighbors are in-byte shifts with cross-byte carries via lane
    rolls, y-neighbors are lane rolls by the row stride, and the cluster
    count is a popcount.  ~9x fewer elements than the unpacked op
    touching the same cells.  The rolls are cyclic; wrapped-in garbage
    is annihilated by the row masks / center mask (see _packed_masks).
    """
    center, not_first, not_last = masks
    lanes = a_i32.shape[-1]
    gwb = packed_geometry(geom)[0]

    left = ((a_i32 << 1) & 0xFF) | (_roll(a_i32, 1) >> 7)
    right = (a_i32 >> 1) | ((_roll(a_i32, lanes - 1) & 1) << 7)
    up = _roll(a_i32, gwb) & not_first
    down = _roll(a_i32, lanes - gwb) & not_last
    cl = a_i32 & (left | right | up | down) & center

    return jnp.sum(jax.lax.population_count(cl), axis=-1)


def word_geometry(geom: GridGeometry) -> tuple[int, int, int]:
    """(gww, used, L): int32 words per row, used words per frame, and
    flat length (used rounded up to 128) of the word-domain layout (rows
    re-packed to 4-byte multiples so every word covers 32 consecutive x
    cells)."""
    gww = (geom.gw + 31) // 32
    used = geom.gh * gww
    lanes = ((used + 127) // 128) * 128
    return gww, used, lanes


def repack_bits_words(bits: "np.ndarray", geom: GridGeometry):
    """Host repack: mvt_scan_bits [N, gh, gwb] -> int32 words [N, used].

    Rows are padded to 4-byte multiples and viewed little-endian, so word
    w of a row holds cells x = 32w..32w+31 in bit order — the byte layout
    generalized to 32-cell lanes.
    """
    n, gh, gwb = bits.shape
    gww, used, _ = word_geometry(geom)
    rows = np.zeros((n, gh, gww * 4), np.uint8)
    rows[:, :, :gwb] = bits
    return rows.reshape(n, gh * gww * 4).view("<i4")


def _word_masks(geom: GridGeometry):
    """Per-word constants for the word-domain cluster math (the 32-cell
    generalization of _packed_masks)."""

    gww, used, lanes = word_geometry(geom)
    center = np.zeros((lanes,), np.int32)
    not_first = np.zeros((lanes,), np.int32)
    not_last = np.zeros((lanes,), np.int32)
    for j in range(used):
        y, c = divmod(j, gww)
        if y >= 1:
            not_first[j] = -1
        if y < geom.gh - 1:
            not_last[j] = -1
        if not (geom.y_min <= y < geom.y_max):
            continue
        bits = 0
        for k in range(32):
            x = 32 * c + k
            if 1 <= x <= geom.gw - 2:
                bits |= 1 << k
        center[j] = np.int32(np.uint32(bits))
    return center, not_first, not_last


def word_cluster_counts(w, geom: GridGeometry, masks):
    """Word-domain cluster counts: int32 packed words [B, L] -> [B].

    Same rule as packed_cluster_counts at 32 cells per lane.  int32
    right shifts are arithmetic, so every >> is masked to its logical
    value before use.
    """
    center, not_first, not_last = masks
    lanes = w.shape[-1]
    gww = word_geometry(geom)[0]

    left = (w << 1) | ((_roll(w, 1) >> 31) & 1)
    right = ((w >> 1) & 0x7FFFFFFF) | ((_roll(w, lanes - 1) & 1) << 31)
    up = _roll(w, gww) & not_first
    down = _roll(w, lanes - gww) & not_last
    cl = w & (left | right | up | down) & center

    return jnp.sum(jax.lax.population_count(cl), axis=-1)


@functools.lru_cache(maxsize=64)
def make_cluster_words_op_xla(geom: GridGeometry, clusters_needed: int):
    """Word-domain op: words int32 [B, L] -> (counts i32 [B], motion bool
    [B]).  Cached per (geometry, config) like make_cluster_op_xla."""
    masks_np = tuple(m[None, :] for m in _word_masks(geom))

    @jax.jit
    def op(words):
        masks = tuple(jnp.asarray(m) for m in masks_np)
        counts = word_cluster_counts(words, geom, masks)
        return counts, counts >= jnp.int32(max(1, clusters_needed))

    return op


def cluster_counts(votes, geom: GridGeometry, *, vectors_needed: int,
                   clusters_needed: int):
    """Convenience entry: pad host vote grids [B, gh, gw] and run the
    grid op -> (counts i32 [B], motion bool [B])."""
    votes = pad_votes(jnp.asarray(votes, dtype=jnp.uint8), geom)
    return make_cluster_op_xla(geom, vectors_needed, clusters_needed)(votes)
