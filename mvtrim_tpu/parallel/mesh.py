"""Device mesh discovery and sharded scan steps.

The reference's parallel substrate is cgroup-aware CPU enumeration +
thread pinning (system.cpp:107-225); here the substrate is a
``jax.sharding.Mesh``.  Two mesh axes are meaningful for this workload:

* ``data``  — frames (from one long archive or many videos) shard across
  cards; each card scans its shard and a ``psum`` merges global motion
  statistics across the cards.
* ``sweep`` — detector configurations (vote thresholds) shard across
  cards; the same frames are scored under per-card thresholds in one
  step.  The reference can only re-run the whole binary per config.

``sharded_scan_step`` builds the full jit'd multi-card scan step that
__graft_entry__.dryrun_multichip runs on a virtual CPU mesh.

The mesh follows the algorithm alone: the cards of one host are joined
all to all (NVLink), so no axis order is tied to a physical topology.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import Config
from ..core.types import GridGeometry


def build_mesh(n_devices: int | None = None,
               sweep: int = 1,
               allow_cpu_fallback: bool = False) -> Mesh:
    """Mesh over available devices: ('data', 'sweep').

    ``sweep`` cards hold distinct detector configs; the rest of the
    devices spread the frame batch.  If the default platform has fewer
    devices than requested, the call FAILS loudly with the device
    inventory — a mis-sized production run must not silently "scan" on
    host CPUs.  Dryruns/tests that intend virtual CPU meshes opt in with
    ``allow_cpu_fallback=True``.
    """
    devices = jax.devices()
    if n_devices is not None and len(devices) < n_devices:
        if not allow_cpu_fallback:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but the default "
                f"platform has only {len(devices)}: "
                f"{[str(d) for d in devices]}. Pass allow_cpu_fallback="
                f"True only for virtual-mesh dryruns/tests.")
        devices = jax.devices("cpu")
        if len(devices) < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but the CPU "
                f"fallback platform also has only {len(devices)} "
                f"devices: {[str(d) for d in devices]}. Set XLA_FLAGS="
                f"--xla_force_host_platform_device_count={n_devices} "
                f"for a virtual mesh.")
    n = n_devices or len(devices)
    if n % sweep != 0:
        raise ValueError(
            f"mesh size {n} is not divisible by sweep={sweep}")
    dev_grid = np.asarray(devices[:n]).reshape(n // sweep, sweep)
    return Mesh(dev_grid, ("data", "sweep"))


def sharded_scan_step(geom: GridGeometry, cfg: Config, mesh: Mesh,
                      sweep_clusters: bool = False):
    """Build the jit'd multi-card scan step.

    Returns ``step(votes, vec_needs) -> (motion, global_motion_frames)``:

      votes     uint8 [B, GH_p, GW_p], sharded over 'data'
      vec_needs int32 [K], sharded over 'sweep' (per-config thresholds)
      motion    bool  [B, K] — frame x config decisions, sharded (data, sweep)
      global_motion_frames int32 [K] — psum over 'data' (a collective),
                replicated over 'data', sharded over 'sweep'

    With ``sweep_clusters=True`` the step takes a third input
    ``clu_needs`` int32 [K] (also sharded over 'sweep'): each sweep point
    is a full (vectors_needed, clusters_needed) pair — the tune --mesh
    product path.  Callers pass EFFECTIVE cluster thresholds
    (max(1, clusters_needed), oracle.effective_clusters_needed).

    The per-frame math is the cluster kernel (ops/cluster.py); thresholds
    arrive as *data* so one compiled program serves every sweep point.
    """
    from ..ops.cluster import cluster_counts_traced

    clusters_eff = max(1, cfg.clusters_needed)

    def local_step(votes, vec_needs, clu_needs=None):
        # votes: [B_local, GH, GW] uint8; vec/clu_needs: [K_local] int32
        v = votes.astype(jnp.int32)

        def per_config(vec_need, clu_need):
            counts = cluster_counts_traced(v, geom, vec_need)
            return counts >= clu_need                     # [B_local]

        if clu_needs is None:
            motion = jax.vmap(
                lambda vn: per_config(vn, jnp.int32(clusters_eff)),
                out_axes=1)(vec_needs)                    # [B_l, K_l]
        else:
            motion = jax.vmap(per_config, out_axes=1)(vec_needs, clu_needs)
        # Global motion-frame count per config: collective over 'data'.
        global_count = jax.lax.psum(
            jnp.sum(motion.astype(jnp.int32), axis=0), axis_name="data")
        return motion, global_count

    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:  # older jax
        from jax.experimental.shard_map import shard_map

    in_specs = (P("data", None, None), P("sweep"))
    if sweep_clusters:
        in_specs = in_specs + (P("sweep"),)
    step = shard_map(
        local_step, mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("data", "sweep"), P("sweep")),
    )
    return jax.jit(step)


def build_process_mesh() -> Mesh:
    """Multi-process mesh with the 'data' axis ordered by OWNING PROCESS
    (then device id): process p's addressable devices form one contiguous
    block of the axis, so the row blocks of a data-sharded global batch
    map to processes contiguously — the layout
    parallel.archive.scan_archive_multiprocess relies on to slice its own
    rows out of the gathered motion vector.  Requires
    parallel.distributed.initialize() to have joined the processes first
    (jax.devices() then spans the cluster)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs).reshape(len(devs), 1), ("data", "sweep"))


def sharded_bits_scan_step(geom: GridGeometry, cfg: Config, mesh: Mesh,
                           gather_motion: bool = False):
    """Packed-payload multi-card scan step (the archive product path).

    Returns ``step(bits) -> (motion, global_motion_frames)``:

      bits   uint8 [B, lanes] — mvt_scan_bits frames flattened/zero-padded
             (ops.cluster.packed_geometry), sharded over 'data'.  The
             activity threshold is baked in host-side, so there is no
             'sweep' dimension; any sweep axis in the mesh carries
             replicated work.
      motion bool [B], sharded over 'data' — or, with
             ``gather_motion=True``, all-gathered over 'data' and
             returned fully replicated so every *process* of a
             multi-process mesh can read the whole decision vector
             (per-process host code cannot address other processes'
             shards; the collective is the bridge)
      global_motion_frames int32 — psum over 'data', replicated

    9x less H2D and collective traffic than the uint8-grid step for the same
    decisions (packed_cluster_counts does the math in the packed domain).
    The archive path deliberately keeps the byte layout rather than the
    detector's int32 word layout: sharded scans are transfer-bound
    (H2D + collectives), and bytes are 1.5x smaller on the wire; the word
    kernel's compute edge only matters when the device is the
    bottleneck (single-host pipeline).
    """
    from ..ops.cluster import (_packed_masks, packed_cluster_counts,
                               packed_geometry)

    masks_np = tuple(m[None, :] for m in _packed_masks(geom))
    lanes = packed_geometry(geom)[2]
    clusters_eff = max(1, cfg.clusters_needed)

    def local_step(bits):
        assert bits.shape[-1] == lanes, (bits.shape, lanes)
        masks = tuple(jnp.asarray(m) for m in masks_np)
        counts = packed_cluster_counts(bits.astype(jnp.int32), geom, masks)
        motion = counts >= jnp.int32(clusters_eff)
        global_count = jax.lax.psum(
            jnp.sum(motion.astype(jnp.int32)), axis_name="data")
        return motion, global_count

    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:  # older jax
        from jax.experimental.shard_map import shard_map

    inner = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("data", None),),
        out_specs=(P("data"), P()),
    )
    if not gather_motion:
        return jax.jit(inner)

    def step(bits):
        motion, global_count = inner(bits)
        # replicate the decision vector: XLA inserts the all-gather over
        # 'data' (an in-shard_map lax.all_gather would trip the VMA
        # replication check — its output is still device-varying)
        motion = jax.lax.with_sharding_constraint(
            motion, NamedSharding(mesh, P()))
        return motion, global_count

    return jax.jit(step)


def _local_sad_grids(carry, frames, geom: GridGeometry, block_size: int):
    """SAD grids for one shard: carry u8 [1, H_p, W_p] + frames u8
    [rows, H_p, W_p] -> int32 [rows, gh_p, gw_p].  Row i is the block
    SAD of frames[i] against its predecessor (frames[i-1], or the carry
    for i == 0) — the same diff + reduce_window math as
    ops/sweep.make_sad_sweep_op, so decisions are bit-identical to the
    single-device SAD path.  The in-jit concat costs one extra HBM pass
    over the shard; archive/tune SAD scans are host-decode-bound
    (~hundreds of frames/s/core vs >10^5 frames/s device SAD), so the
    simple formulation wins over threading a carry through shard_map."""
    x = jnp.concatenate([carry, frames], axis=0).astype(jnp.int32)
    diff = jnp.abs(x[1:] - x[:-1])
    return jax.lax.reduce_window(
        diff, 0, jax.lax.add,
        window_dimensions=(1, block_size, block_size),
        window_strides=(1, block_size, block_size),
        padding="VALID")


def sharded_sad_sweep_step(geom: GridGeometry, cfg: Config, mesh: Mesh):
    """Multi-card pixel-domain sweep step (tune --mesh --scan-input sad).

    Returns ``step(carries, frames, bounds, clus) -> motion bool [B, K]``:

      carries u8 [data_size, H_p, W_p] sharded over 'data' — each
              shard's predecessor frame (the frame just before the
              shard's first row in decode order; content is irrelevant
              for rows the caller masks/slices off)
      frames  u8 [B, H_p, W_p] sharded over 'data' (B = data_size*rows)
      bounds  i32 [K] sharded over 'sweep' — integer SAD-sum bounds
              (ops/sad.sad_threshold_sum)
      clus    i32 [K] sharded over 'sweep' — raw clusters_needed (the
              effective max(1, .) is applied here, mirroring
              ops/sweep.make_sad_sweep_op)

    The SAD block reduction runs once per shard and is shared by every
    sweep point; thresholds arrive as data (cluster_counts_traced), so
    one compiled program serves any config set of the same shape —
    the pattern sharded_scan_step established for the vote sweeps.
    """
    from ..ops.cluster import cluster_counts_traced

    bs = cfg.block_size

    def local_step(carry, frames, bounds, clus):
        sad = _local_sad_grids(carry, frames, geom, bs)

        def per_config(bound, clust_need):
            counts = cluster_counts_traced(sad, geom, bound)
            return counts >= jnp.maximum(1, clust_need)

        return jax.vmap(per_config, out_axes=1)(bounds, clus)

    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:  # older jax
        from jax.experimental.shard_map import shard_map

    step = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("data", None, None), P("data", None, None),
                  P("sweep"), P("sweep")),
        out_specs=P("data", "sweep"),
    )
    return jax.jit(step)


def sharded_sad_scan_step(geom: GridGeometry, cfg: Config, mesh: Mesh,
                          gather_motion: bool = False):
    """Pixel-domain multi-card scan step — the MV-less archive path.

    Returns ``step(carries, frames, valid) -> (motion, global_count)``:

      carries u8 [data_size, H_p, W_p] sharded over 'data' (per-shard
              predecessor frames, as in sharded_sad_sweep_step)
      frames  u8 [B, H_p, W_p] sharded over 'data'
      valid   bool [B] sharded over 'data' — False where a frame has no
              true predecessor (a chunk's first analyzed frame — the
              SADDetector no-predecessor rule, models/sad_detector.py)
              or where the row is batch padding
      motion  bool [B] sharded over 'data'; with ``gather_motion=True``
              replicated via an all-gather so every process of a
              multi-process mesh reads the full decision vector
      global_count int32 — psum over 'data', replicated

    The SAD bound and cluster threshold are baked from ``cfg`` exactly
    like the single-file SAD pipeline (models/sad_detector.py), so an
    archive scanned here and the same stream run chunk-by-chunk through
    SADDetector decide identically.  This closes the round-4 gap where
    intra-only / MV-less archives (which the reference cannot detect on
    at all — motion_scanner.cpp:219-221) got neither sharding nor
    checkpointing (parallel/archive.py warn-and-give-up).
    """
    from ..ops.cluster import cluster_counts_traced
    from ..ops.sad import sad_threshold_sum

    bs = cfg.block_size
    bound = sad_threshold_sum(cfg.sad_threshold, bs)
    clusters_eff = max(1, cfg.clusters_needed)

    def local_step(carry, frames, valid):
        sad = _local_sad_grids(carry, frames, geom, bs)
        counts = cluster_counts_traced(sad, geom, jnp.int32(bound))
        motion = (counts >= jnp.int32(clusters_eff)) & valid
        global_count = jax.lax.psum(
            jnp.sum(motion.astype(jnp.int32)), axis_name="data")
        return motion, global_count

    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:  # older jax
        from jax.experimental.shard_map import shard_map

    inner = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("data", None, None), P("data", None, None),
                  P("data")),
        out_specs=(P("data"), P()),
    )
    if not gather_motion:
        return jax.jit(inner)

    def step(carries, frames, valid):
        motion, global_count = inner(carries, frames, valid)
        # replicate the decision vector for multi-process hosts (same
        # rationale as sharded_bits_scan_step's gather_motion)
        motion = jax.lax.with_sharding_constraint(
            motion, NamedSharding(mesh, P()))
        return motion, global_count

    return jax.jit(step)


def shard_votes(votes: np.ndarray, mesh: Mesh):
    """Place a [B, GH, GW] batch sharded over the 'data' axis."""
    return jax.device_put(
        votes, NamedSharding(mesh, P("data", None, None)))


def stream_device(stream_id: int, devices=None):
    """The card batch stream ``stream_id`` analyses on: streams go
    round-robin over ``devices`` (default ``jax.devices()``), replacing
    the reference's disjoint per-stream cpusets
    (batch_processor.cpp:101-110).  None on a one-device host, where
    JAX's default placement applies."""
    devices = jax.devices() if devices is None else devices
    return devices[stream_id % len(devices)] if len(devices) > 1 else None
