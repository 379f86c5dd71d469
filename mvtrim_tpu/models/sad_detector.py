"""SADDetector — pixel-domain fallback detector (no codec MVs needed).

Feeds decoded luma planes through the block-SAD op (ops/sad.py).
Within a chunk, each analyzed frame is compared to the previous analyzed
frame; a chunk's first frame has no predecessor and is never motion (the
MV path behaves the same way: the first decodable frame after a seek is an
I-frame without MV side data).  This keeps chunks independent, so the
host decode stays embarrassingly parallel.
"""

from __future__ import annotations

import numpy as np

from ..core import oracle
from ..core.config import Config
from ..core.types import GridGeometry
from ..ops import sad as sad_ops
from .backend import resolve_backend


def sad_oracle_counts(luma: np.ndarray, geom: GridGeometry, *,
                      sad_threshold: float, block_size: int) -> np.ndarray:
    """NumPy contract for the SAD path: counts[i] for frame i vs i-1.

    Blocks cut by the frame edge sum only their in-frame pixels.  Frames
    are differenced one at a time in int16, so a long 1080p chunk costs
    a few frames of temporaries, not a widened copy of the whole chunk.
    """
    n = luma.shape[0] - 1
    h, w = luma.shape[1:]
    gh, gw = geom.gh, geom.gw
    sad = np.zeros((max(n, 0), gh, gw), np.int64)
    for i in range(n):
        diff = np.abs(luma[i + 1].astype(np.int16)
                      - luma[i].astype(np.int16))
        blocks = np.zeros((gh * block_size, gw * block_size), np.int32)
        hh, ww = min(h, gh * block_size), min(w, gw * block_size)
        blocks[:hh, :ww] = diff[:hh, :ww]
        sad[i] = blocks.reshape(gh, block_size, gw, block_size).sum(
            axis=(1, 3))
    bound = sad_ops.sad_threshold_sum(sad_threshold, block_size)
    active = (sad >= bound).astype(np.uint8)
    # reuse the cluster rule with votes=1, threshold=1
    return oracle.count_clusters_batch(active, vectors_needed=1,
                                       y_min=geom.y_min, y_max=geom.y_max)


class SADDetector:
    """Per-video pixel-domain detector: luma frames -> motion decisions."""

    def __init__(self, width: int, height: int, cfg: Config | None = None,
                 device=None):
        self.cfg = cfg or Config.from_env()
        # pin dispatches to one card (multi-card batch mode round-robin)
        self.device = device
        self.geom = GridGeometry.build(width, height, self.cfg)
        self.backend = resolve_backend(self.cfg.scan_backend)
        self._op = None
        # device batch for luma is small: 1080p luma is ~2MB/frame
        self.device_batch = min(64, max(8, self.cfg.device_batch // 8))

    def _build_op(self):
        if self._op is None:
            if self.backend == "oracle":
                geom, cfg = self.geom, self.cfg
                need = oracle.effective_clusters_needed(cfg.clusters_needed)

                def host_op(luma):
                    counts = sad_oracle_counts(
                        luma, geom, sad_threshold=cfg.sad_threshold,
                        block_size=cfg.block_size)
                    return counts, counts >= need

                self._op = host_op
            else:
                self._op = sad_ops.make_sad_op_xla(
                    self.geom, sad_threshold=self.cfg.sad_threshold,
                    block_size=self.cfg.block_size,
                    clusters_needed=self.cfg.clusters_needed,
                    device=self.device)
        return self._op

    def scan_luma(self, luma: np.ndarray,
                  carry: np.ndarray | None = None) -> np.ndarray:
        """luma uint8 [N, H, W] (one chunk, decode order) -> motion [N].

        Without ``carry``, motion[0] is always False (no predecessor
        inside the chunk).  ``carry`` is the last ANALYZED frame of the
        chunk's previous cap-resumed sub-scan ([H, W]): motion[0] is then
        the real comparison against it, so splitting a chunk at the
        frame cap never changes decisions (the MVT_CHUNK_FRAMES_CAP
        contract in core/config.py).  Chunk boundaries themselves stay
        independent by design — see the module docstring.
        """
        n = luma.shape[0]
        out = np.zeros((n,), bool)
        off = 0 if carry is None else 1
        nt = n + off  # virtual sequence: [carry?] + luma
        if nt < 2:
            return out
        op = self._build_op()
        padded = sad_ops.pad_luma(luma, self.geom, self.cfg.block_size)
        db = self.device_batch
        # window batches of db+1 frames overlapping by one (the carry);
        # one reused buffer (a fresh np.zeros per window costs a full
        # clear + page faults on the host decode core).  Virtual frame v
        # is carry at v==0 (when given) else padded[v - off]; decisions
        # for v land at out[v - off].
        batch = np.zeros((db + 1,) + padded.shape[1:], np.uint8)
        for lo in range(0, nt - 1, db):
            hi = min(lo + db, nt - 1)
            if off and lo == 0:
                batch[0] = sad_ops.pad_luma(
                    carry[None], self.geom, self.cfg.block_size)[0]
                batch[1:hi + 1] = padded[:hi]
            else:
                batch[:hi - lo + 1] = padded[lo - off:hi + 1 - off]
            if hi - lo < db:
                batch[hi - lo + 1:] = 0
            _, motion = op(batch)
            out[lo + 1 - off:hi + 1 - off] = np.asarray(motion)[:hi - lo]
        return out
