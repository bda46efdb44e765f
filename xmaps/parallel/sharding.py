"""Sharded multi-device depth pipeline: data-parallel frames x
event-parallel events, composed with shard_map and XLA collectives.

Design notes:

- Frames are independent; the ``data`` mesh axis shards a leading batch
  axis of stacked EventBatches.  No collectives cross this axis.
- Within a frame, the ``event`` axis shards the padded event dimension.
  Two collectives are needed per frame: pmin/pmax of the frame time window
  (two scalars) and a pmax all-reduce of the index-packed disparity map
  (u32 image, the tail's crop window for the projector view).  Packing
  global event indices keeps NumPy's last-write-wins scatter semantics
  bit-exact regardless of sharding (see ops.scatter).
- The dense image tail runs replicated on the event axis; spatially
  sharding dilate+remap would need halo exchanges.

When does the event axis pay?  (cost model, symbolic and unmeasured on
NVLink)

  saved   = (1 - 1/E) * N_events * (t_event + t_scatter)
  added   = ring all-reduce of the packed map
          = 2 * (E-1)/E * 4 * H_map * W_map / BW_link

  -> event sharding pays iff
     N_events * (t_event + t_scatter) > 8 * H_map * W_map / (E * BW_link)

with t_event and t_scatter the per-event device costs of the event stage
and the scatter, and BW_link the per-direction link bandwidth.  The
all-reduce grows with the map while the saving grows with the event
count, so the axis can pay only for high event rates into small maps
(the camera view's 0.3 Mpx map, or a small crop window).  None of these
terms has been measured on an NVLink host yet, so the default mesh is
data-only (``make_mesh(event=1)``); pass ``event > 1`` deliberately.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from xmaps.config import PipelineConfig
from xmaps.ops.disparity import compute_event_disparity, time_bounds
from xmaps.ops.event_batch import EventBatch
from xmaps.ops.frame_pipeline import DeviceTables, FrameResult
from xmaps.ops.image_tail import (
    depth_and_frame,
    dilate_max,
    disparity_luts,
    remap_nearest_i16,
)
from xmaps.ops.scatter import scatter_disp_packed, unpack_disp

__all__ = [
    "make_mesh",
    "make_sharded_pipeline",
    "make_group_sharded_pipeline",
    "shard_batches",
    "shard_staged_group",
]


def make_mesh(
    devices: Sequence[jax.Device] | None = None,
    data: int | None = None,
    event: int = 1,
) -> Mesh:
    """Create a ('data', 'event') mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        data = n // event
    assert data * event == n, f"{data}x{event} != {n} devices"
    dev_array = np.array(devices).reshape(data, event)
    return Mesh(dev_array, axis_names=("data", "event"))


def _frame_event_sharded(
    batch: EventBatch,
    tables: DeviceTables,
    cfg: PipelineConfig,
    *,
    axis_name: str = "event",
    local_capacity: int,
) -> FrameResult:
    """Per-frame pipeline over a local event shard (inside shard_map)."""
    shard = jax.lax.axis_index(axis_name)

    priority = None
    if cfg.frame_filter != "none":
        # Dedup filters need global per-key winners and globally consistent
        # scatter ranks, so gather the whole frame over the event axis
        # (one all_gather per field), filter it replicated, and slice this
        # shard's lanes back out.  Filters are off the hot path; the
        # all_gather cost is accepted for bit-identity with single-chip.
        from xmaps.ops.disparity import rectify_events_packed
        from xmaps.ops.filters import apply_frame_filter

        gather = functools.partial(
            jax.lax.all_gather, axis_name=axis_name, tiled=True
        )
        full = EventBatch(
            x=gather(batch.x),
            y=gather(batch.y),
            t=gather(batch.t),
            p=gather(batch.p),
            valid=gather(batch.valid),
            count=batch.count,
        )
        xr_full, _ = rectify_events_packed(
            full.x, full.y, tables.cam_map_packed
        )
        fb = apply_frame_filter(
            full,
            xr_full,
            name=cfg.frame_filter,
            camera_width=cfg.camera_width,
            camera_height=cfg.camera_height,
            rect_width=cfg.rect_width,
        )
        start = shard * local_capacity
        slc = lambda a: jax.lax.dynamic_slice_in_dim(a, start, local_capacity)
        batch = EventBatch(
            x=slc(fb.batch.x),
            y=slc(fb.batch.y),
            t=slc(fb.batch.t),
            p=slc(fb.batch.p),
            valid=slc(fb.batch.valid),
            count=batch.count,
        )
        priority = slc(fb.scatter_priority)

    # Global frame time window over the (possibly filtered) events
    # (2-scalar collectives).
    t_min, t_max = time_bounds(batch.t, batch.valid)
    t_min = jax.lax.pmin(t_min, axis_name)
    t_max = jax.lax.pmax(t_max, axis_name)

    res = compute_event_disparity(
        batch,
        tables.cam_mapx_i16,
        tables.cam_mapy_i16,
        tables.x_map,
        t_px_scale=cfg.t_px_scale,
        t_bounds=(t_min, t_max),
    )

    # Without a filter, the global event index (shard offset + lane) is the
    # last-write-wins priority; dedup filters supply a global dense rank.
    index_offset = shard * local_capacity
    if cfg.camera_perspective:
        packed = scatter_disp_packed(
            batch.y,
            batch.x,
            res.disp,
            res.inlier,
            height=cfg.camera_height,
            width=cfg.camera_width,
            index_offset=index_offset,
            priority=priority,
        )
        packed = jax.lax.pmax(packed, axis_name)
        disp_map = unpack_disp(packed)
        disp_for_depth = disp_map
    else:
        crop = cfg.tail_crop or (0, 0, cfg.rect_height, cfg.rect_width)
        packed = scatter_disp_packed(
            res.y_rect,
            res.x_rect + res.disp.astype(jnp.int32),
            res.disp,
            res.inlier,
            height=cfg.rect_height,
            width=cfg.rect_width,
            index_offset=index_offset,
            priority=priority,
            window=crop,
        )
        # Combine partial scatters: max of packed values == global
        # last-write-wins (all-reduce over the event axis).
        packed = jax.lax.pmax(packed, axis_name)
        dilated = dilate_max(unpack_disp(packed), 7)
        disp_for_depth = remap_nearest_i16(
            dilated, tables.proj_mapx_i16, tables.proj_mapy_i16,
            origin=crop[:2],
        )
        disp_map = disp_for_depth

    depth, frame = depth_and_frame(
        disp_for_depth, disparity_luts(cfg.p03, cfg.z_near, cfg.z_far)
    )
    num_inliers = jax.lax.psum(jnp.sum(res.inlier).astype(jnp.int32), axis_name)
    return FrameResult(
        frame_bgr=frame, depth=depth, disp_map=disp_map, num_inliers=num_inliers
    )


def make_sharded_pipeline(
    cfg: PipelineConfig,
    tables: DeviceTables,
    mesh: Mesh,
):
    """Build the jitted multi-device pipeline over stacked frame batches.

    Input: an EventBatch whose leaves carry a leading frame axis B
    (B % mesh['data'] == 0) and event capacity N (N % mesh['event'] == 0).
    Output: FrameResult with leading axis B, sharded over 'data' and
    replicated over 'event'.  Every stage is the plain XLA chain (the
    event-axis collectives cut through the frame program); the engine's
    own per-frame program over a data-only mesh is
    :func:`make_group_sharded_pipeline`.
    """
    ev_shards = mesh.shape["event"]
    local_capacity = cfg.event_capacity // ev_shards
    from xmaps.ops.scatter import PACK

    assert (cfg.event_capacity + 1) * PACK < 2**32, (
        f"event capacity {cfg.event_capacity} overflows the uint32 packing"
    )

    batch_specs = EventBatch(
        x=P("data", "event"),
        y=P("data", "event"),
        t=P("data", "event"),
        p=P("data", "event"),
        valid=P("data", "event"),
        count=P("data"),
    )
    out_specs = FrameResult(
        frame_bgr=P("data"),
        depth=P("data"),
        disp_map=P("data"),
        num_inliers=P("data"),
    )
    frame_fn = functools.partial(
        _frame_event_sharded,
        cfg=cfg,
        axis_name="event",
        local_capacity=local_capacity,
    )

    def local_fn(batch: EventBatch, tables: DeviceTables) -> FrameResult:
        return jax.vmap(frame_fn, in_axes=(0, None))(batch, tables)

    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(batch_specs, P()),
        out_specs=out_specs,
        check_vma=False,
    )

    @jax.jit
    def pipeline(batch: EventBatch) -> FrameResult:
        return sharded(batch, tables)

    return pipeline


def make_group_sharded_pipeline(
    cfg: PipelineConfig,
    tables: DeviceTables,
    mesh: Mesh,
    *,
    presort: bool = False,
):
    """Data-parallel LIVE group pipeline: the engine's host-staged frame
    programs (host target-sort + runs scatter + crop-window tail -- the
    exact per-frame program ``process_frames`` dispatches) sharded over
    the mesh's ``data`` axis as ONE jitted shard_map program.

    This is the multi-camera / multi-sequence streaming regime scaled
    across devices (the moral equivalent of the reference's GNU-parallel
    fan-out, eval/x-map-eval.sh:49, but as a single device program):
    frames are independent, no collectives cross 'data', and each device
    runs the full single-device pipeline on its shard -- so results match
    the single-device engine exactly (tests/test_sharding.py pins
    bit-equality).

    Input: (batch, prio) with a leading frame axis B
    (B % mesh['data'] == 0), as produced by :func:`shard_staged_group`.
    ``presort``: the batches are host target-sorted (prio carries the
    arrival indices; the sort-free runs scatter), else unsorted (prio is
    ignored).  Event-sharded meshes are not supported here -- use
    :func:`make_sharded_pipeline` for within-frame event parallelism.
    """
    assert mesh.shape["event"] == 1, (
        "group pipeline is data-parallel only; use make_sharded_pipeline "
        "for event-sharded meshes"
    )
    from xmaps.ops.frame_pipeline import depth_frame

    def local_fn(batch, prio, tables):
        b_local = batch.x.shape[0]
        outs = []
        for i in range(b_local):
            kw = {}
            if presort:
                kw = dict(presort_priority=prio[i], presort_runs=True)
            outs.append(
                depth_frame(
                    jax.tree.map(lambda a: a[i], batch),
                    tables,
                    cfg,
                    **kw,
                )
            )
        return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *outs)

    batch_specs = EventBatch(
        x=P("data"), y=P("data"), t=P("data"), p=P("data"),
        valid=P("data"), count=P("data"),
    )
    out_specs = FrameResult(
        frame_bgr=P("data"),
        depth=P("data"),
        disp_map=P("data"),
        num_inliers=P("data"),
    )
    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(batch_specs, P("data"), P()),
        out_specs=out_specs,
        check_vma=False,
    )

    @jax.jit
    def pipeline(batch, prio):
        return sharded(batch, prio, tables)

    return pipeline


def shard_staged_group(staged: Sequence, mesh: Mesh) -> tuple:
    """Stack host-staged (batch, priority) pairs (from
    XMapsDepthEngine.make_sorted_batch, or (batch, None)) along a leading
    frame axis and place the shards on the mesh's 'data' axis.

    Returns (batch, prio) ready for :func:`make_group_sharded_pipeline`;
    prio is a zero-width placeholder when the staging carried none
    (uniform pytree structure keeps one compiled program per (B, presort)
    shape).
    """
    data_sharding = NamedSharding(mesh, P("data"))
    batches = [s[0] for s in staged]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *batches)
    batch = jax.tree.map(
        lambda a: jax.device_put(a, data_sharding), stacked
    )
    if staged[0][1] is None:
        prio = jnp.zeros((len(staged), 0), jnp.int32)
    else:
        prio = jnp.stack([jnp.asarray(s[1]) for s in staged], axis=0)
    return batch, jax.device_put(prio, data_sharding)


def shard_batches(
    batches: Sequence[EventBatch], mesh: Mesh, cfg: PipelineConfig
) -> EventBatch:
    """Stack per-frame EventBatches along a leading axis and place them
    according to the mesh sharding (host -> device)."""
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *batches)
    sharding = NamedSharding(mesh, P("data", "event"))
    scalar_sharding = NamedSharding(mesh, P("data"))
    return EventBatch(
        x=jax.device_put(stacked.x, sharding),
        y=jax.device_put(stacked.y, sharding),
        t=jax.device_put(stacked.t, sharding),
        p=jax.device_put(stacked.p, sharding),
        valid=jax.device_put(stacked.valid, sharding),
        count=jax.device_put(stacked.count, scalar_sharding),
    )
