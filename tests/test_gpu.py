"""Tests that need an NVIDIA GPU.

They skip on every other platform, and the regular suite pins the CPU
(conftest.py), so under pytest they skip here.  Their bodies run on the
card as phase 4 of ``python chip_smoke.py``, in the smoke run's own
process, with ``gpu`` set to ``jax.devices()[0]``.  The fixture decides,
never the module at import: every pytest worker must collect the same
tests.

Each body compares device decisions with the NumPy reference, bit for
bit, at the widths the pipeline dispatches.
"""

import numpy as np
import pytest

from mvtrim_tpu.core import oracle
from mvtrim_tpu.core.config import Config
from mvtrim_tpu.models import MVClusterDetector, SADDetector

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX has {dev.platform}); run "
                    "`python chip_smoke.py` on the card")
    return dev


def _masks(rng, n, gh, gw, moving):
    """Activity masks: sparse noise, plus a moving 4x4 blob of active
    cells on the frames flagged in ``moving``."""
    active = rng.random((n, gh, gw)) < 0.004
    for i in np.nonzero(moving)[0]:
        y = 4 + (i * 3) % (gh - 12)
        x = 4 + (i * 5) % (gw - 12)
        active[i, y:y + 4, x:x + 4] = True
    return active


def _pinned_pair(cfg_kw, gpu, width, height, cls=MVClusterDetector):
    dev = cls(width, height, Config(**cfg_kw), device=gpu)
    ref = cls(width, height, Config(scan_backend="oracle", **cfg_kw))
    return dev, ref


def test_mv_payloads_on_card(gpu):
    """bits, words and grids over several 1080p device batches decide
    like the oracle backend, on the card the detector is pinned to."""
    rng = np.random.default_rng(21)
    n = 5000
    dev, ref = _pinned_pair({}, gpu, 1920, 1080)
    gh, gw = dev.geom.gh, dev.geom.gw
    moving = rng.random(n) < 0.2
    active = _masks(rng, n, gh, gw, moving)
    bits = np.packbits(active, axis=2, bitorder="little")
    want = ref.scan_bits(bits)
    assert want[moving].mean() > 0.9 and not want.all()
    np.testing.assert_array_equal(dev.scan_bits(bits), want)
    from mvtrim_tpu.ops.cluster import repack_bits_words

    np.testing.assert_array_equal(
        dev.scan_words(repack_bits_words(bits, dev.geom)), want)
    votes = active.astype(np.uint8) * 3
    np.testing.assert_array_equal(dev.scan_votes(votes),
                                  ref.scan_votes(votes))


def test_mv_raw_on_card_4k(gpu):
    """The scatter-add mv_raw op at 4K, M = 8192, in full 2048-frame
    dispatches: counts from empty to full capacity."""
    rng = np.random.default_rng(22)
    n, m = 4096, 8192
    dev, ref = _pinned_pair({}, gpu, 3840, 2160)
    counts = np.minimum(np.exp(rng.uniform(0, np.log(m + 1), n)),
                        m).astype(np.int32)
    counts[:3] = (0, m, 1)
    mvs = np.zeros((n, m, 4), np.int16)
    dst = np.stack([rng.integers(-32, 3872, (n, m)),
                    rng.integers(-32, 2192, (n, m))], -1)
    mvs[..., :2] = dst
    mvs[..., 2:] = dst - rng.integers(-9, 10, (n, m, 2))
    want = ref.scan_raw_mvs(mvs, counts)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(dev.scan_raw_mvs(mvs, counts), want)


def test_sad_on_card(gpu):
    """SAD decisions over a 1080p chunk (several 64-frame windows, a
    carried boundary frame) and a sum exactly at the activation bound."""
    rng = np.random.default_rng(23)
    n, h, w = 150, 1080, 1920
    dev, ref = _pinned_pair({}, gpu, w, h, SADDetector)
    luma = np.empty((n, h, w), np.uint8)
    luma[:] = rng.integers(0, 200, (h, w), dtype=np.uint8)
    for i in range(0, n, 3):
        y, x = (i * 7) % (h - 200), (i * 11) % (w - 200)
        luma[i, y:y + 160, x:x + 160] = 255
    carry = luma[0].copy()
    want = ref.scan_luma(luma[1:], carry=carry)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(dev.scan_luma(luma[1:], carry=carry),
                                  want)

    cfg = {"sad_threshold": 16.0625}          # bound 4112 = 16 * 257
    dev, ref = _pinned_pair(cfg, gpu, 640, 480, SADDetector)
    edge = np.zeros((3, 480, 640), np.uint8)
    edge[1, 0::16, :] = 255
    edge[1, 1::16, :] = 2
    edge[2] = edge[1]
    want = ref.scan_luma(edge)
    assert want.tolist() == [False, True, False]
    np.testing.assert_array_equal(dev.scan_luma(edge), want)


def test_mesh_steps_on_one_card(gpu):
    """The archive's sharded bits and SAD steps on a one-card mesh decide
    like the single-stream oracle."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mvtrim_tpu.core.types import GridGeometry
    from mvtrim_tpu.models.sad_detector import sad_oracle_counts
    from mvtrim_tpu.ops.cluster import packed_geometry
    from mvtrim_tpu.parallel.mesh import (sharded_bits_scan_step,
                                          sharded_sad_scan_step)
    from mvtrim_tpu.ops.sad import pad_luma

    cfg = Config()
    mesh = jax.sharding.Mesh(np.asarray([gpu]).reshape(1, 1),
                             ("data", "sweep"))
    rng = np.random.default_rng(24)
    geom = GridGeometry.build(1920, 1080, cfg)
    n = 512
    active = _masks(rng, n, geom.gh, geom.gw, rng.random(n) < 0.3)
    packed = np.packbits(active, axis=2, bitorder="little")
    _, used, lanes = packed_geometry(geom)
    flat = np.zeros((n, lanes), np.uint8)
    flat[:, :used] = packed.reshape(n, used)
    motion, total = sharded_bits_scan_step(geom, cfg, mesh)(
        jax.device_put(flat, NamedSharding(mesh, P("data", None))))
    want = oracle.count_clusters_batch(
        active.astype(np.uint8), vectors_needed=1, y_min=geom.y_min,
        y_max=geom.y_max) >= oracle.effective_clusters_needed(
            cfg.clusters_needed)
    np.testing.assert_array_equal(np.asarray(motion), want)
    assert int(total) == int(want.sum())

    geom = GridGeometry.build(640, 480, cfg)
    luma = rng.integers(0, 256, (17, 480, 640), dtype=np.uint8)
    luma[5:9] = luma[4]
    padded = pad_luma(luma, geom, cfg.block_size)
    valid = np.ones(16, bool)
    motion, _ = sharded_sad_scan_step(geom, cfg, mesh)(
        padded[:1], padded[1:], valid)
    counts = sad_oracle_counts(luma, geom, sad_threshold=cfg.sad_threshold,
                               block_size=cfg.block_size)
    np.testing.assert_array_equal(
        np.asarray(motion),
        counts >= oracle.effective_clusters_needed(cfg.clusters_needed))
