"""Per-event rectification gathers + X-map disparity lookup (device).

The per-event hot path of the reference
(cam_proj_calibration.py:277-281 + x_maps_disparity.py:9-32), rebuilt as a
masked, fixed-shape XLA program:

1. rectify: two 2D gathers through the inverse camera LUTs;
2. normalize event time to [0, 1] within the frame (masked min/max);
3. scale to an X-map time bin with round-half-to-even;
4. gather the projector column from the X-map;
5. disparity = x_proj - x_rect - X_OFFSET with inlier masking.

For integer microsecond timestamps the time-bin computation is done in
exact integer arithmetic (round-half-to-even of dt*scale/range), which is
deterministic and matches the reference's float64 np.rint bit-for-bit in
practice; float32 timestamps (the offline ESL eval path) use float math.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from xmaps.config import X_OFFSET
from xmaps.ops.event_batch import EventBatch

__all__ = [
    "rectify_events",
    "rectify_events_packed",
    "pack_rect_maps",
    "compute_event_disparity",
    "time_bounds",
    "DisparityResult",
]


class DisparityResult(NamedTuple):
    disp: jax.Array  # (N,) float32, 0 where not inlier
    x_rect: jax.Array  # (N,) int32 rectified x (i16 semantics)
    y_rect: jax.Array  # (N,) int32 rectified y (i16 semantics)
    inlier: jax.Array  # (N,) bool
    t_scaled: jax.Array  # (N,) int32 X-map time bin
    #: (N,) int32 raw clipped X-map value x_map[clip(yr), clip(t)], defined
    #: for EVERY lane (not zeroed by the inlier mask) -- the host can
    #: mirror it exactly, which makes it usable as a scatter run key
    #: (ops.scatter method="runs")
    x_proj: jax.Array | None = None


def rectify_events(
    x: jax.Array, y: jax.Array, mapx_i16: jax.Array, mapy_i16: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Per-event rectification: 2 gathers through the inverse camera LUT.

    Mirrors rectify_cam_coords_i16 (reference: cam_proj_calibration.py:277-281).
    Event coordinates come from the decoder and are in-range by construction;
    indices are clamped anyway so padded lanes stay in-bounds.
    """
    H, W = mapx_i16.shape
    yc = jnp.clip(y, 0, H - 1)
    xc = jnp.clip(x, 0, W - 1)
    xr = mapx_i16[yc, xc].astype(jnp.int32)
    yr = mapy_i16[yc, xc].astype(jnp.int32)
    return xr, yr


def pack_rect_maps(mapx_i16, mapy_i16) -> jax.Array:
    """Pack the two i16 inverse-rectification LUTs into one int32 table.

    One gather then fetches both rectified coordinates of an event.
    Layout: low 16 bits = mapx, high 16 bits = mapy (both sign-preserved).
    """
    lo = jnp.asarray(mapx_i16).astype(jnp.int32) & 0xFFFF
    hi = jnp.asarray(mapy_i16).astype(jnp.int32) << 16
    return hi | lo


def rectify_events_packed(
    x: jax.Array, y: jax.Array, map_packed: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Per-event rectification via ONE gather through the packed LUT.

    Bit-identical to :func:`rectify_events` (arithmetic shifts sign-extend
    the two i16 halves exactly).
    """
    H, W = map_packed.shape
    yc = jnp.clip(y, 0, H - 1)
    xc = jnp.clip(x, 0, W - 1)
    packed = map_packed[yc, xc]
    xr = (packed << 16) >> 16
    yr = packed >> 16
    return xr, yr


def time_bounds(t: jax.Array, valid: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Masked (min, max) of event times; identity elements for invalid
    lanes, so shard-local bounds combine with min/max collectives."""
    if jnp.issubdtype(t.dtype, jnp.integer):
        big = jnp.iinfo(t.dtype).max
        t_min = jnp.min(jnp.where(valid, t, big))
        t_max = jnp.max(jnp.where(valid, t, -big))
    else:
        inf = jnp.asarray(jnp.inf, t.dtype)
        t_min = jnp.min(jnp.where(valid, t, inf))
        t_max = jnp.max(jnp.where(valid, t, -inf))
    return t_min, t_max


def _scale_time_int(
    t: jax.Array, t_min: jax.Array, t_max: jax.Array, t_px_scale: int
) -> jax.Array:
    """Exact integer round-half-to-even of (t - min) * scale / (max - min).

    Equivalent to np.rint(event_norm_t * T_PX_SCALE)
    (reference: x_maps_disparity.py:12-19) computed without floating point.
    Assumes (max-min) * scale * 2 < 2^31 (frame spans are ~16.7 ms in us
    units; scale is ~1000, so the product is ~3.6e7).
    """
    rng = jnp.maximum(t_max - t_min, 1)
    num = (t - t_min) * jnp.int32(t_px_scale)
    q = num // rng
    r = num - q * rng
    twice = 2 * r
    round_up = (twice > rng) | ((twice == rng) & (q % 2 == 1))
    return q + round_up.astype(jnp.int32)


def _scale_time_float(
    t: jax.Array, t_min: jax.Array, t_max: jax.Array, t_px_scale: int
) -> jax.Array:
    """Float path for normalized [0,1] timestamps (offline eval)."""
    rng = jnp.maximum(t_max - t_min, jnp.float32(1e-30))
    norm = (t - t_min) / rng
    return jnp.round(norm * jnp.float32(t_px_scale)).astype(jnp.int32)


def compute_event_disparity(
    batch: EventBatch,
    mapx_i16: jax.Array,
    mapy_i16: jax.Array,
    x_map: jax.Array,
    *,
    t_px_scale: int,
    t_bounds: tuple[jax.Array, jax.Array] | None = None,
    rect_coords: tuple[jax.Array, jax.Array] | None = None,
    t_scaled: jax.Array | None = None,
) -> DisparityResult:
    """Full per-event disparity stage (reference: x_maps_disparity.py:9-32).

    Returns per-event disparity (float32, integer-valued) and the inlier
    mask combining:
    - batch validity (padding lanes);
    - rectified-y in [0, H_xmap - 2] (reference :23);
    - disparity >= 0 (reference :29), which also rejects undefined X-map
      entries (x_proj == 0 gives disp = -x_rect - X_OFFSET < 0).
    """
    if rect_coords is not None:
        xr, yr = rect_coords
    else:
        xr, yr = rectify_events(batch.x, batch.y, mapx_i16, mapy_i16)

    if t_scaled is None:
        if t_bounds is None:
            t_bounds = time_bounds(batch.t, batch.valid)
        t_min, t_max = t_bounds
        if jnp.issubdtype(batch.t.dtype, jnp.integer):
            t_scaled = _scale_time_int(batch.t, t_min, t_max, t_px_scale)
        else:
            t_scaled = _scale_time_float(batch.t, t_min, t_max, t_px_scale)

    H_xmap, W_time = x_map.shape
    y_in = (yr >= 0) & (yr < H_xmap - 1) & batch.valid

    yg = jnp.clip(yr, 0, H_xmap - 1)
    tg = jnp.clip(t_scaled, 0, W_time - 1)
    x_proj = x_map[yg, tg].astype(jnp.int32)

    disp = x_proj - xr - X_OFFSET
    inlier = y_in & (disp >= 0) & (t_scaled >= 0) & (t_scaled < W_time)

    disp_f32 = jnp.where(inlier, disp, 0).astype(jnp.float32)
    return DisparityResult(
        disp=disp_f32, x_rect=xr, y_rect=yr, inlier=inlier, t_scaled=t_scaled,
        x_proj=x_proj,
    )
