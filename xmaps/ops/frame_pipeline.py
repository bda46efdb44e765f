"""The fused per-frame depth program (device).

Composes the per-event stage (rectify -> X-map lookup -> disparity), the
deterministic scatter, and the dense image tail into ONE jitted XLA
program, mirroring the reference's per-frame path process_ev_frame
(depth_reprojection_pipe.py:121-167) minus display.  Both render
perspectives are supported:

- projector view (default): scatter into the rectified frame, dilate,
  remap to projector resolution (depth_reprojection_pipe.py:153-162);
- camera view: scatter at raw event coordinates
  (cam_proj_calibration.py:312-317).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from xmaps.config import PipelineConfig
from xmaps.ops.disparity import compute_event_disparity
from xmaps.ops.event_batch import EventBatch
from xmaps.ops.image_tail import (
    depth_and_frame,
    dilate_max,
    disparity_luts,
    remap_nearest_i16,
)
__all__ = ["DeviceTables", "FrameResult", "depth_frame", "make_depth_frame_fn"]


class DeviceTables(NamedTuple):
    """Precomputed LUTs resident in device memory (built once per session from
    calib.CamProjMaps; see models/depth_pipeline.py)."""

    cam_mapx_i16: jax.Array  # (H_cam, W_cam) int16: cam px -> rect x
    cam_mapy_i16: jax.Array  # (H_cam, W_cam) int16: cam px -> rect y
    cam_map_packed: jax.Array  # (H_cam, W_cam) int32: mapy<<16 | mapx
    x_map: jax.Array  # (H_rect, W_time) int16
    proj_mapx_i16: jax.Array  # (H_proj, W_proj) int16: proj px -> rect x
    proj_mapy_i16: jax.Array  # (H_proj, W_proj) int16: proj px -> rect y

    @staticmethod
    def from_maps(cam_proj_maps, x_map: np.ndarray) -> "DeviceTables":
        from xmaps.ops.disparity import pack_rect_maps

        m = cam_proj_maps
        return DeviceTables(
            cam_mapx_i16=jnp.asarray(m.disp_cam_mapx_i16),
            cam_mapy_i16=jnp.asarray(m.disp_cam_mapy_i16),
            cam_map_packed=pack_rect_maps(
                m.disp_cam_mapx_i16, m.disp_cam_mapy_i16
            ),
            x_map=jnp.asarray(x_map),
            proj_mapx_i16=jnp.asarray(m.disp_proj_mapx_i16),
            proj_mapy_i16=jnp.asarray(m.disp_proj_mapy_i16),
        )


class FrameResult(NamedTuple):
    frame_bgr: jax.Array  # (H_out, W_out, 3) uint8 colorized depth
    depth: jax.Array  # (H_out, W_out) float32 metric depth (0 = undefined)
    disp_map: jax.Array  # view-dependent disparity map, float32
    num_inliers: jax.Array  # int32


def depth_frame(
    batch: EventBatch,
    tables: DeviceTables,
    cfg: PipelineConfig,
    t_scaled=None,
    presort_priority=None,
    presort_runs: bool = False,
    presort_unique: bool = False,
    host_num_inliers=None,
    display_only: bool = False,
    display_packed: bool = False,
) -> FrameResult:
    """One projector frame of events -> colorized depth map.

    Trace-time static: cfg (shapes/sizes), dynamic: batch + tables.
    The projector view scatters into ``cfg.tail_crop`` (the window of the
    rect frame the tail can see, ops.image_tail.tail_crop_window; the full
    frame when None) and runs the dense tail (dilate, remap, per-disparity
    depth and colour tables) there.
    ``t_scaled`` (int32 X-map time bins, precomputed exactly on the host
    by io.prefetch compact staging) skips the on-device time
    normalization; only valid with ``frame_filter == "none"`` (filters
    change the frame's time bounds, so bins must be computed after
    filtering).
    ``presort_priority`` (int32 original-arrival indices from
    XMapsDepthEngine.make_sorted_batch) marks the batch as staged in host
    order; the scatter resolves last-write-wins through the priority, so
    results are bit-identical to arrival-order staging.  Requires integer
    timestamps and no frame filter.
    ``presort_runs`` additionally marks the host sort key as the SCATTER
    TARGET (rectified row + raw X-map value for the projector view, raw
    coordinates for the camera view -- make_sorted_batch computes both
    exactly), so same-pixel lanes are contiguous and the scatter finds
    each pixel's winner with a neighbour compare (ops.scatter
    method="runs") instead of a scatter-max.
    ``presort_unique`` marks the batch as a host-COMPACTED winner batch
    (models.depth_pipeline.make_winner_batch): every valid lane targets a
    distinct pixel and is that pixel's winner, so the scatter is a bare
    unique-indices set (ops.scatter method="set").  Requires
    ``host_num_inliers`` (the host-mirrored inlier count -- the compacted
    batch no longer carries the losing inlier lanes) plus ``t_scaled``
    (time bins must come from the FULL frame's bounds, which the
    compacted batch cannot recover).
    ``display_only`` returns FrameResult with depth and disp_map as None
    -- the reference's per-frame output surface (disp_to_depth.py emits
    only the colorized frame; depth/disparity are intermediates).
    ``display_packed`` (requires display_only) emits frame_bgr as ONE
    (H, W) uint32 packed-BGR plane (B | G<<8 | R<<16) instead of
    (H, W, 3) u8; unpack on the host with
    ``arr.view(np.uint8).reshape(H, W, 4)[..., :3]`` at display rate.
    """
    from xmaps.ops.disparity import rectify_events_packed
    from xmaps.ops.filters import apply_frame_filter
    from xmaps.ops.scatter import scatter_disp_packed, unpack_disp

    if t_scaled is not None and cfg.frame_filter != "none":
        raise ValueError(
            "precomputed t_scaled requires frame_filter == 'none' "
            "(filters change the frame's time bounds)"
        )
    if presort_priority is not None and (
        cfg.frame_filter != "none"
        or not jnp.issubdtype(batch.t.dtype, jnp.integer)
    ):
        raise ValueError(
            "presort_priority requires a host-sorted batch: integer "
            "timestamps and frame_filter == 'none'"
        )
    if presort_runs and presort_priority is None:
        raise ValueError(
            "presort_runs requires a host-sorted batch (presort_priority): "
            "run contiguity is a property of the host sort key"
        )
    if presort_unique:
        if presort_priority is None or host_num_inliers is None or t_scaled is None:
            raise ValueError(
                "presort_unique requires a host-compacted winner batch: "
                "presort_priority (original arrival indices), "
                "host_num_inliers (the compacted batch lost the losing "
                "inlier lanes), and t_scaled (full-frame time bounds)"
            )
        if presort_runs:
            raise ValueError("presort_unique and presort_runs are exclusive")
    if display_packed and not display_only:
        raise ValueError(
            "display_packed emits only the packed colorized plane; it "
            "requires display_only"
        )

    luts = disparity_luts(cfg.p03, cfg.z_near, cfg.z_far)
    ev_x, ev_y = batch.x, batch.y
    xr, yr = rectify_events_packed(batch.x, batch.y, tables.cam_map_packed)
    priority = presort_priority
    if cfg.frame_filter != "none":
        fb = apply_frame_filter(
            batch,
            xr,
            name=cfg.frame_filter,
            camera_width=cfg.camera_width,
            camera_height=cfg.camera_height,
            rect_width=cfg.rect_width,
        )
        batch = fb.batch
        priority = fb.scatter_priority
        ev_x, ev_y = batch.x, batch.y

    res = compute_event_disparity(
        batch,
        tables.cam_mapx_i16,
        tables.cam_mapy_i16,
        tables.x_map,
        t_px_scale=cfg.t_px_scale,
        rect_coords=(xr, yr),
        t_scaled=t_scaled,
    )

    if host_num_inliers is not None:
        num_inliers = jnp.asarray(host_num_inliers, jnp.int32)
    else:
        num_inliers = jnp.sum(res.inlier).astype(jnp.int32)

    # Unsorted batches take the duplicate-capable scatter-max (packed
    # priority keys make it order-independent); host target-sorted
    # batches upgrade to "runs", compacted winner batches to "set".
    scatter_method = "max"
    run_keys = None
    if presort_unique:
        scatter_method = "set"
    elif presort_runs:
        scatter_method = "runs"
        if cfg.camera_perspective:
            run_keys = (ev_y, ev_x)
        else:
            # clipped row + raw X-map value: the exact key the host
            # sorted by, defined for every lane (rejects included)
            h_xmap = tables.x_map.shape[0]
            run_keys = (
                jnp.clip(res.y_rect, 0, h_xmap - 1),
                res.x_proj,
            )

    if cfg.camera_perspective:
        disp_map = unpack_disp(
            scatter_disp_packed(
                ev_y,
                ev_x,
                res.disp,
                res.inlier,
                height=cfg.camera_height,
                width=cfg.camera_width,
                priority=priority,
                method=scatter_method,
                run_keys=run_keys,
            )
        )
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
            priority=priority,
            method=scatter_method,
            run_keys=run_keys,
            window=crop,
        )
        dilated = dilate_max(unpack_disp(packed), 7)
        disp_for_depth = remap_nearest_i16(
            dilated, tables.proj_mapx_i16, tables.proj_mapy_i16,
            origin=crop[:2],
        )
        disp_map = disp_for_depth

    depth, frame = depth_and_frame(disp_for_depth, luts, packed=display_packed)
    return FrameResult(
        frame_bgr=frame,
        depth=None if display_only else depth,
        disp_map=None if display_only else disp_map,
        num_inliers=num_inliers,
    )


def make_depth_frame_fn(cfg: PipelineConfig):
    """Build the jitted frame function with cfg baked in.

    Batch-buffer donation was evaluated and intentionally not used: the
    program's outputs (projector-resolution images + a scalar) share no
    shape/dtype with the event arrays, so XLA cannot alias donated
    buffers into outputs (it warns "donated buffers were not usable").
    Host-side buffer reuse lives in io.prefetch.HostStagingPool instead.
    """
    fn = functools.partial(
        depth_frame,
        cfg=cfg,
    )
    return jax.jit(fn)
