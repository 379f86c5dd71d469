"""Device-kernel vs oracle parity (SURVEY.md §4 item 2).

Random vote grids and random MV sets are pushed through the device ops
(on the CPU backend here) and must reproduce the NumPy oracle's cluster
counts and motion decisions exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mvtrim_tpu.core import oracle
from mvtrim_tpu.core.config import Config
from mvtrim_tpu.core.types import GridGeometry
from mvtrim_tpu.ops import cluster as cluster_ops
from mvtrim_tpu.ops import mv_vote

CFG = Config()
GEOM = GridGeometry.build(640, 480, CFG)  # gw=40, gh=30, margin=1


def oracle_counts(grids, geom, vectors_needed):
    return np.array([
        oracle.count_clusters(g, vectors_needed=vectors_needed,
                              y_min=geom.y_min, y_max=geom.y_max)
        for g in grids
    ], dtype=np.int32)


def random_grids(rng, b, geom, density=0.1, max_votes=6):
    grids = np.zeros((b, geom.gh, geom.gw), np.uint8)
    mask = rng.random((b, geom.gh, geom.gw)) < density
    votes = rng.integers(0, max_votes, size=(b, geom.gh, geom.gw))
    # votes may land anywhere in the allocated grid rows inside the mask
    # window only (vote_grid can't produce them elsewhere), but the cluster
    # phase must tolerate arbitrary grid contents — test with full-range.
    grids[mask] = votes[mask]
    return grids


class TestClusterKernels:
    # ``backend`` names the build under test in the ids: XLA is the one
    @pytest.mark.parametrize("backend", ["xla"])
    def test_random_parity(self, rng, backend):
        grids = random_grids(rng, 64, GEOM)
        counts, motion = cluster_ops.cluster_counts(
            grids, GEOM, vectors_needed=2, clusters_needed=2)
        expect = oracle_counts(grids, GEOM, 2)
        np.testing.assert_array_equal(np.asarray(counts), expect)
        np.testing.assert_array_equal(np.asarray(motion), expect >= 2)

    @pytest.mark.parametrize("backend", ["xla"])
    def test_dense_grids(self, rng, backend):
        grids = random_grids(rng, 16, GEOM, density=0.9, max_votes=255)
        counts, _ = cluster_ops.cluster_counts(
            grids, GEOM, vectors_needed=3, clusters_needed=2)
        np.testing.assert_array_equal(np.asarray(counts),
                                      oracle_counts(grids, GEOM, 3))

    @pytest.mark.parametrize("dims", [(640, 480), (1920, 1080),
                                      (3840, 2160), (200, 144)])
    def test_random_parity_at_widths(self, rng, dims):
        geom = GridGeometry.build(dims[0], dims[1], CFG)
        grids = random_grids(rng, 24, geom)
        counts, motion = cluster_ops.cluster_counts(
            grids, geom, vectors_needed=2, clusters_needed=2)
        expect = oracle_counts(grids, geom, 2)
        np.testing.assert_array_equal(np.asarray(counts), expect)
        np.testing.assert_array_equal(np.asarray(motion), expect >= 2)

    @pytest.mark.parametrize("vm", [0.05, 0.0])
    def test_dense_grids_vertical_mask(self, rng, vm):
        geom = GridGeometry.build(640, 480, Config(vertical_mask=vm))
        grids = random_grids(rng, 16, geom, density=0.9, max_votes=255)
        counts, _ = cluster_ops.cluster_counts(
            grids, geom, vectors_needed=3, clusters_needed=2)
        np.testing.assert_array_equal(np.asarray(counts),
                                      oracle_counts(grids, geom, 3))

    def test_1080p_geometry(self, rng):
        geom = GridGeometry.build(1920, 1080, CFG)
        assert (geom.gw, geom.gh, geom.y_min, geom.y_max) == (120, 68, 3, 65)
        grids = random_grids(rng, 8, geom, density=0.05)
        counts, _ = cluster_ops.cluster_counts(
            grids, geom, vectors_needed=2, clusters_needed=2)
        np.testing.assert_array_equal(np.asarray(counts),
                                      oracle_counts(grids, geom, 2))

    def test_empty_and_full(self):
        grids = np.zeros((4, GEOM.gh, GEOM.gw), np.uint8)
        grids[1] = 255
        counts, motion = cluster_ops.cluster_counts(
            grids, GEOM, vectors_needed=2, clusters_needed=2)
        assert counts[0] == 0 and not motion[0]
        assert counts[1] == oracle_counts(grids[1:2], GEOM, 2)[0]

    def test_ops_cached_per_config(self):
        """Detectors for videos sharing a geometry and config reuse one
        compiled program: the builders are cached on their arguments."""
        a = cluster_ops.make_cluster_op_xla(GEOM, 2, 2)
        assert cluster_ops.make_cluster_op_xla(GEOM, 2, 2) is a
        assert cluster_ops.make_cluster_op_xla(GEOM, 3, 2) is not a
        w = cluster_ops.make_cluster_words_op_xla(GEOM, 2)
        assert cluster_ops.make_cluster_words_op_xla(GEOM, 2) is w


def random_mvs(rng, n, spread=640):
    """Random MV rows (dst_x, dst_y, src_x, src_y) incl. negatives/OOB."""
    dst = rng.integers(-32, spread + 32, size=(n, 2))
    disp = rng.integers(-8, 9, size=(n, 2))
    src = dst - disp
    return np.concatenate([dst, src], axis=1).astype(np.int32)


class TestMVFusedKernels:
    @pytest.mark.parametrize("threshold_sq", [16.0, 16.5, 0.0, 4.0])
    def test_xla_parity(self, rng, threshold_sq):
        b, m = 12, 256
        mv_list = [random_mvs(rng, int(rng.integers(0, m))) for _ in range(b)]
        dx_, dy_, sx_, sy_, counts, overflow = mv_vote.pad_mvs(mv_list, m)
        assert not overflow.any()
        op = mv_vote.make_mv_cluster_op_xla(
            GEOM, threshold_sq=threshold_sq, block_shift=4,
            vectors_needed=2, clusters_needed=2)
        n, motion = op(dx_, dy_, sx_, sy_, counts)
        for i, mvs in enumerate(mv_list):
            grid = oracle.vote_grid(
                mvs, GEOM.gw, GEOM.gh, threshold_sq=threshold_sq,
                block_shift=4, y_min=GEOM.y_min, y_max=GEOM.y_max)
            expect = oracle.count_clusters(grid, vectors_needed=2,
                                           y_min=GEOM.y_min, y_max=GEOM.y_max)
            assert int(n[i]) == expect, f"frame {i}"
            assert bool(motion[i]) == (expect >= 2)

    def test_padding_ignored(self, rng):
        # padded zero MVs have mag 0: dropped when threshold > 0, and when
        # threshold == 0 they must still be masked by the count
        mvs = random_mvs(rng, 100)
        dx_, dy_, sx_, sy_, counts, _ = mv_vote.pad_mvs([mvs], 256)
        op = mv_vote.make_mv_cluster_op_xla(
            GEOM, threshold_sq=0.0, block_shift=4,
            vectors_needed=1, clusters_needed=1)
        n, _ = op(dx_, dy_, sx_, sy_, counts)
        grid = oracle.vote_grid(mvs, GEOM.gw, GEOM.gh, threshold_sq=0.0,
                                block_shift=4, y_min=GEOM.y_min,
                                y_max=GEOM.y_max)
        assert int(n[0]) == oracle.count_clusters(
            grid, vectors_needed=1, y_min=GEOM.y_min, y_max=GEOM.y_max)

    def test_threshold_bound(self):
        assert mv_vote.threshold_bound(16.0) == 16
        assert mv_vote.threshold_bound(16.5) == 17
        assert mv_vote.threshold_bound(0.0) == 0
        assert mv_vote.threshold_bound(-3.0) == -3


def _mv_case(rng, geom, m, counts_wanted):
    """Random MV rows at the given per-frame counts, padded to m."""
    mv_list = [random_mvs(rng, c, spread=geom.width) for c in counts_wanted]
    return mv_vote.pad_mvs(mv_list, m)


def _expected_mv_clusters(fields, counts, geom, cfg):
    votes = oracle.vote_grids_batch(
        np.stack(fields, -1), counts, geom.gw, geom.gh,
        threshold_sq=cfg.mv_threshold_sq, block_shift=cfg.block_shift,
        y_min=geom.y_min, y_max=geom.y_max)
    return oracle.count_clusters_batch(
        votes, vectors_needed=cfg.vectors_needed, y_min=geom.y_min,
        y_max=geom.y_max)


@pytest.mark.parametrize("threshold_sq", [0.0, 16.0, 16.5])
@pytest.mark.parametrize("spread", [640, 1 << 15])
def test_vote_grids_batch_matches_vote_grid(rng, threshold_sq, spread):
    """The batched oracle equals the per-row reference loop: padding past
    each count, negative and out-of-grid cells, int16-extreme fields whose
    squared magnitude wraps int32, and saturation at 255."""
    b, m = 5, 700
    counts = np.array([0, 1, 350, 699, 700])
    mvs = rng.integers(-spread, spread, (b, m, 4))
    mvs[4, :300] = (200, 200, 190, 190)      # one cell, 300 votes
    want = np.stack([oracle.vote_grid(
        mvs[i, :counts[i]], GEOM.gw, GEOM.gh, threshold_sq=threshold_sq,
        block_shift=4, y_min=GEOM.y_min, y_max=GEOM.y_max)
        for i in range(b)])
    got = oracle.vote_grids_batch(
        mvs, counts, GEOM.gw, GEOM.gh, threshold_sq=threshold_sq,
        block_shift=4, y_min=GEOM.y_min, y_max=GEOM.y_max)
    assert want[4, 200 >> 4, 200 >> 4] == 255
    np.testing.assert_array_equal(got, want)


class TestMVScatterOp:
    """The scatter-add mv_raw op vs the NumPy restatement and the
    per-frame oracle, at the capacities and counts the pipeline ships:
    M = 2048, an M that is not a power of two, and the default 8192;
    sparse (real 1080p densities) and full-capacity counts; frame counts
    that are not multiples of any step size."""

    @pytest.mark.parametrize("m", [2048, 3000, 8192])
    @pytest.mark.parametrize("regime", ["sparse", "full"])
    def test_capacity_and_density(self, rng, m, regime):
        b = 13
        if regime == "sparse":
            counts_wanted = np.minimum(np.exp(rng.uniform(
                np.log(1), np.log(2049), b)).astype(int), m)
        else:
            counts_wanted = np.full(b, m)
        counts_wanted[0] = 0            # no MV side data: never motion
        geom = GridGeometry.build(640, 480, CFG)
        dx, dy, sx, sy, counts, overflow = _mv_case(rng, geom, m,
                                                    counts_wanted)
        assert not overflow.any()
        op = mv_vote.make_mv_cluster_op_xla(
            geom, threshold_sq=CFG.mv_threshold_sq,
            block_shift=CFG.block_shift, vectors_needed=2,
            clusters_needed=2)
        n, motion = op(dx, dy, sx, sy, counts)
        cfg = Config(vectors_needed=2, clusters_needed=2)
        expect = _expected_mv_clusters((dx, dy, sx, sy), counts, geom, cfg)
        np.testing.assert_array_equal(np.asarray(n), expect)
        np.testing.assert_array_equal(
            np.asarray(motion), (expect >= 2) & (counts > 0))
        assert not bool(motion[0])

    @pytest.mark.parametrize("dims", [(1920, 1080), (3840, 2160)])
    def test_counts_at_old_chunk_boundaries(self, rng, dims):
        """Counts at zero, one, and either side of every power-of-two
        boundary up to capacity decide exactly like the per-frame
        oracle."""
        geom = GridGeometry.build(dims[0], dims[1], CFG)
        m = 4096
        counts_wanted = [0, 1, 255, 256, 257, 2047, 2048, 2049, 4095, 4096]
        dx, dy, sx, sy, counts, _ = _mv_case(rng, geom, m, counts_wanted)
        np.testing.assert_array_equal(counts, counts_wanted)
        op = mv_vote.make_mv_cluster_op_xla(
            geom, threshold_sq=16.0, block_shift=4, vectors_needed=1,
            clusters_needed=1)
        n, _ = op(dx, dy, sx, sy, counts)
        for i, c in enumerate(counts_wanted):
            mvs = np.stack([dx[i, :c], dy[i, :c], sx[i, :c], sy[i, :c]], 1)
            grid = oracle.vote_grid(
                mvs, geom.gw, geom.gh, threshold_sq=16.0, block_shift=4,
                y_min=geom.y_min, y_max=geom.y_max)
            assert int(n[i]) == oracle.count_clusters(
                grid, vectors_needed=1, y_min=geom.y_min,
                y_max=geom.y_max), f"frame {i} (count {c})"

    @pytest.mark.parametrize("threshold_sq", [0.0, 16.0, 16.5])
    def test_votes_match_oracle_grid(self, rng, threshold_sq):
        """mv_votes is the reference's phase-1 vote grid before the 255
        saturation, on the padded extents (OOB and masked rows vote
        nowhere)."""
        b, m = 6, 512
        dx, dy, sx, sy, counts, _ = _mv_case(
            rng, GEOM, m, rng.integers(0, m + 1, b))
        votes = np.asarray(mv_vote.mv_votes(
            *(jnp.asarray(a) for a in (dx, dy, sx, sy, counts)), GEOM,
            mv_vote.threshold_bound(threshold_sq), 4))
        assert votes.shape == (b, GEOM.padded_gh, GEOM.padded_gw)
        assert not votes[:, GEOM.gh:].any() and not votes[:, :, GEOM.gw:].any()
        for i in range(b):
            c = counts[i]
            mvs = np.stack([dx[i, :c], dy[i, :c], sx[i, :c], sy[i, :c]], 1)
            grid = oracle.vote_grid(
                mvs, GEOM.gw, GEOM.gh, threshold_sq=threshold_sq,
                block_shift=4, y_min=GEOM.y_min, y_max=GEOM.y_max)
            np.testing.assert_array_equal(
                np.minimum(votes[i, :GEOM.gh, :GEOM.gw], 255), grid)

    def test_tail_mvs_count(self, rng):
        """Motion carried only by the last MVs of a long list counts."""
        m = 3000
        dst = np.array([(16 * cx + 8, 16 * cy + 8)
                        for cx in range(10, 13) for cy in range(10, 13)])
        tail = np.concatenate([dst, dst - 8], axis=1).astype(np.int32)
        mvs = np.concatenate([np.zeros((2900, 4), np.int32), tail])
        dx, dy, sx, sy, c, _ = mv_vote.pad_mvs([mvs], m)
        op = mv_vote.make_mv_cluster_op_xla(
            GEOM, threshold_sq=16.0, block_shift=4, vectors_needed=1,
            clusters_needed=1)
        n, _ = op(dx, dy, sx, sy, c)
        grid = oracle.vote_grid(mvs, GEOM.gw, GEOM.gh, threshold_sq=16.0,
                                block_shift=4, y_min=GEOM.y_min,
                                y_max=GEOM.y_max)
        expect = oracle.count_clusters(grid, vectors_needed=1,
                                       y_min=GEOM.y_min, y_max=GEOM.y_max)
        assert expect > 0 and int(n[0]) == expect


def _packed_flat(active, geom):
    """Activity masks [B, gh, gw] -> the archive's flat byte layout."""
    packed = np.packbits(active, axis=2, bitorder="little")
    _, used, lanes = cluster_ops.packed_geometry(geom)
    flat = np.zeros((len(active), lanes), np.uint8)
    flat[:, :used] = packed.reshape(len(active), used)
    return flat


def _archive_bits_step(geom, cfg, flat):
    """The archive's packed-domain scan on a one-device mesh: (cluster
    counts from packed_cluster_counts, the step's motion, its psum)."""
    import jax

    from mvtrim_tpu.parallel.mesh import build_mesh, sharded_bits_scan_step

    masks = tuple(jnp.asarray(m)[None, :]
                  for m in cluster_ops._packed_masks(geom))
    counts = jax.jit(lambda b: cluster_ops.packed_cluster_counts(
        b.astype(jnp.int32), geom, masks))(flat)
    motion, total = sharded_bits_scan_step(geom, cfg, build_mesh(1))(
        jnp.asarray(flat))
    return np.asarray(counts), np.asarray(motion), int(total)


class TestPackedClusterOps:
    """Packed-domain cluster math (bitwise neighbors + popcount on the
    mvt_scan_bits layout), as the archive's mesh step runs it, vs the
    oracle."""

    @pytest.mark.parametrize("dims", [(1920, 1080), (360, 240), (256, 192)])
    def test_packed_xla_matches_oracle(self, rng, dims):
        cfg = Config()
        geom = GridGeometry.build(dims[0], dims[1], cfg)
        grids = rng.integers(0, 5, size=(48, geom.gh, geom.gw),
                             dtype=np.uint8)
        active = (grids >= cfg.vectors_needed)
        counts, motion, total = _archive_bits_step(
            geom, cfg, _packed_flat(active, geom))
        expect = oracle.count_clusters_batch(
            active.astype(np.uint8), vectors_needed=1,
            y_min=geom.y_min, y_max=geom.y_max)
        np.testing.assert_array_equal(counts, expect)
        need = oracle.effective_clusters_needed(cfg.clusters_needed)
        np.testing.assert_array_equal(motion, expect >= need)
        assert total == int((expect >= need).sum())

    def test_packed_matches_unpack_op_margin0(self, rng):
        """vertical_mask=0 (margin-0): the zero-fill row-neighbor
        semantics must match the unpacked rule's definition exactly."""
        cfg = Config(vertical_mask=0.0)
        geom = GridGeometry.build(360, 240, cfg)
        grids = rng.integers(0, 4, size=(32, geom.gh, geom.gw),
                             dtype=np.uint8)
        active = grids >= cfg.vectors_needed
        counts, motion, _ = _archive_bits_step(
            geom, cfg, _packed_flat(active, geom))
        c_grid, m_grid = cluster_ops.cluster_counts(
            active.astype(np.uint8), geom, vectors_needed=1,
            clusters_needed=cfg.clusters_needed)
        np.testing.assert_array_equal(counts, np.asarray(c_grid))
        np.testing.assert_array_equal(motion, np.asarray(m_grid))


class TestWordClusterOps:
    """Word-domain cluster math (32 cells per int32 lane; the default
    bits/words path) vs the oracle, incl. margin-0 and non-32-aligned
    widths."""

    @pytest.mark.parametrize("dims,vm", [
        ((1920, 1080), 0.05),   # gw=120: not a multiple of 32
        ((3840, 2160), 0.05),   # 4K
        ((360, 240), 0.0),      # margin-0 zero-fill rows
        ((200, 144), 0.05),     # tiny, gw=13 < one word
        ((1920, 1080), 0.0),
        ((3840, 2160), 0.0),
    ])
    def test_words_xla_matches_oracle(self, rng, dims, vm):
        from mvtrim_tpu.core import oracle as orc

        cfg = Config(vertical_mask=vm)
        geom = GridGeometry.build(dims[0], dims[1], cfg)
        grids = rng.integers(0, 5, size=(40, geom.gh, geom.gw),
                             dtype=np.uint8)
        active = grids >= cfg.vectors_needed
        bits = np.packbits(active, axis=2, bitorder="little")
        gww, used, lanes = cluster_ops.word_geometry(geom)
        words = np.zeros((40, lanes), np.int32)
        words[:, :used] = cluster_ops.repack_bits_words(bits, geom)

        op = cluster_ops.make_cluster_words_op_xla(
            geom, cfg.clusters_needed)
        counts, motion = op(jnp.asarray(words))
        expect = orc.count_clusters_batch(
            active.astype(np.uint8), vectors_needed=1,
            y_min=geom.y_min, y_max=geom.y_max)
        np.testing.assert_array_equal(np.asarray(counts), expect)
        need = orc.effective_clusters_needed(cfg.clusters_needed)
        np.testing.assert_array_equal(np.asarray(motion), expect >= need)

    @pytest.mark.parametrize("dims,vm", [
        ((1920, 1080), 0.05),
        ((1920, 1080), 0.0),
        ((3840, 2160), 0.05),
        ((3840, 2160), 0.0),
    ])
    def test_grid_op_matches_oracle(self, rng, dims, vm):
        """The uint8 vote-grid op (MVT_SCAN_INPUT=grids) at 1080p and 4K,
        with and without a vertical mask."""
        cfg = Config(vertical_mask=vm)
        geom = GridGeometry.build(dims[0], dims[1], cfg)
        grids = random_grids(rng, 12, geom, density=0.3)
        counts, motion = cluster_ops.cluster_counts(
            grids, geom, vectors_needed=cfg.vectors_needed,
            clusters_needed=cfg.clusters_needed)
        expect = oracle_counts(grids, geom, cfg.vectors_needed)
        np.testing.assert_array_equal(np.asarray(counts), expect)
        np.testing.assert_array_equal(
            np.asarray(motion),
            expect >= oracle.effective_clusters_needed(cfg.clusters_needed))

    def test_words_no_padding_headroom(self, rng):
        """A geometry where used == lanes (no zero-padding words): the up
        and down neighbours wrap through real words and the edge masks
        must cancel them."""
        cfg = Config(vertical_mask=0.0)
        geom = GridGeometry.build(512, 2048, cfg)  # gww=1, gh=128
        gww, used, lanes = cluster_ops.word_geometry(geom)
        assert lanes - used < gww  # the case under test
        grids = rng.integers(0, 5, size=(16, geom.gh, geom.gw),
                             dtype=np.uint8)
        active = grids >= cfg.vectors_needed
        bits = np.packbits(active, axis=2, bitorder="little")
        words = np.zeros((16, lanes), np.int32)
        words[:, :used] = cluster_ops.repack_bits_words(bits, geom)
        counts, _ = cluster_ops.make_cluster_words_op_xla(
            geom, cfg.clusters_needed)(jnp.asarray(words))
        expect = oracle.count_clusters_batch(
            active.astype(np.uint8), vectors_needed=1,
            y_min=geom.y_min, y_max=geom.y_max)
        np.testing.assert_array_equal(np.asarray(counts), expect)

    def test_words_match_byte_domain(self, rng):
        """Word and byte packed domains agree bit-for-bit (same frames,
        both layouts)."""
        cfg = Config()
        geom = GridGeometry.build(360, 240, cfg)
        grids = rng.integers(0, 4, size=(24, geom.gh, geom.gw),
                             dtype=np.uint8)
        active = grids >= cfg.vectors_needed
        bits = np.packbits(active, axis=2, bitorder="little")
        _, usedw, lanesw = cluster_ops.word_geometry(geom)
        flatw = np.zeros((24, lanesw), np.int32)
        flatw[:, :usedw] = cluster_ops.repack_bits_words(bits, geom)

        cb, mb, _ = _archive_bits_step(geom, cfg, _packed_flat(active, geom))
        cw, mw = cluster_ops.make_cluster_words_op_xla(
            geom, cfg.clusters_needed)(jnp.asarray(flatw))
        np.testing.assert_array_equal(cb, np.asarray(cw))
        np.testing.assert_array_equal(mb, np.asarray(mw))
