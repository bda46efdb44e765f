"""Frame event dedup filters (device, fixed-shape).

The reference offers 5 per-frame dedup strategies selectable at runtime
with the E key (frame_event_filter.py:131-151).  They rebuild a smaller
event list by scattering into dense pixel maps and re-extracting in raster
order.  On the device, variable-length compaction breaks static shapes, so each
filter is expressed as a transformation of the padded batch:

- a validity mask update (drop filtered-out lanes), and
- optionally a rewritten timestamp (MeanFirstLastEventPerXY), and
- a scatter priority (events re-emerge in raster order in the reference, so
  the disparity-map scatter must use the pixel raster index as last-write
  priority to stay bit-exact; see ``scatter_priority``).

All filters first drop negative-polarity events
(frame_event_filter.py:21,47,72,104).  NoFilter is the default.

Deviation note: the reference implements "first event wins" via a
reversed-array fancy-index scatter (frame_event_filter.py:52-53), whose
duplicate-index winner is undefined behavior in NumPy and flips between
NumPy versions.  These filters implement the documented intent (true first
event by stream order) deterministically.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from xmaps.ops.event_batch import EventBatch

__all__ = ["FilteredBatch", "apply_frame_filter", "FILTER_NAMES"]

FILTER_NAMES = (
    "none",
    "first_per_yt",
    "first_per_xy",
    "last_per_xy",
    "mean_first_last_per_xy",
)


class FilteredBatch(NamedTuple):
    batch: EventBatch
    #: per-lane scatter priority; dense raster RANK for dedup filters,
    #: event order for NoFilter (matches reference output ordering
    #: semantics -- see _dense_rank)
    scatter_priority: jax.Array


def _dense_rank(key: jax.Array) -> jax.Array:
    """Rank of each lane under (key, lane) lexicographic order.

    The dedup filters' scatter priority is the reference's raster
    position (frame_event_filter.py re-emits one event per key in raster
    order).  Raw raster keys overflow the uint32 packing at ESL scale
    (camera_height * rect_width ~ 2.8M), but only their ORDER matters and
    every filter keeps at most one survivor per key, so the dense rank
    (< capacity) is an equivalent priority.  One free lax.sort."""
    n = key.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(n)
    _, order = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
    return jnp.zeros((n,), jnp.int32).at[order].set(idx)


def _winner_mask(key: jax.Array, valid: jax.Array, n_keys: int, *, first: bool):
    """Per-lane mask: is this lane the first/last valid event of its key?

    Scatter-max of packed (event index + 1) per key, then compare with a
    gather.  For ``first``, indices are flipped so min wins.
    """
    n = key.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    prio = (n - idx) if first else (idx + 1)
    prio = jnp.where(valid, prio, 0)
    k = jnp.where(valid, key, n_keys)
    winners = jnp.zeros((n_keys + 1,), jnp.int32).at[k].max(prio, mode="drop")
    return valid & (winners[k] == prio)


def apply_frame_filter(
    batch: EventBatch,
    x_rect_i16: jax.Array,
    *,
    name: str,
    camera_width: int,
    camera_height: int,
    rect_width: int,
) -> FilteredBatch:
    """Apply one of the 5 reference dedup strategies to a padded batch.

    Args:
        batch: the frame's padded events.
        x_rect_i16: per-lane rectified x (int32), the ``xp_i16`` the
            reference passes to filters (depth_reprojection_pipe.py:131).
        name: one of FILTER_NAMES.
    """
    n = batch.x.shape[0]
    idx_order = jnp.arange(n, dtype=jnp.int32)

    if name == "none":
        return FilteredBatch(batch=batch, scatter_priority=idx_order)

    pos = batch.valid & (batch.p == 1)
    key_xy = batch.y * camera_width + batch.x
    n_xy = camera_width * camera_height

    if name == "first_per_xy":
        # reference frame_event_filter.py:45-64 (reversed scatter)
        keep = _winner_mask(key_xy, pos, n_xy, first=True)
        out = batch._replace(valid=keep)
        return FilteredBatch(out, _dense_rank(key_xy))

    if name == "last_per_xy":
        # reference frame_event_filter.py:19-39
        keep = _winner_mask(key_xy, pos, n_xy, first=False)
        out = batch._replace(valid=keep)
        return FilteredBatch(out, _dense_rank(key_xy))

    if name == "first_per_yt":
        # reference frame_event_filter.py:70-99: key = (raw y, rectified x)
        xr = jnp.clip(x_rect_i16.astype(jnp.int32), 0, rect_width - 1)
        key_yt = batch.y * rect_width + xr
        keep = _winner_mask(key_yt, pos, camera_height * rect_width, first=True)
        out = batch._replace(valid=keep)
        return FilteredBatch(out, _dense_rank(key_yt))

    if name == "mean_first_last_per_xy":
        # reference frame_event_filter.py:102-128: one event per (x, y)
        # with t = (t_first + t_last) // 2
        keep_first = _winner_mask(key_xy, pos, n_xy, first=True)
        # per-key last t: scatter-max of packed (idx, none needed -- t of the
        # max-idx event). pack (idx+1) * T + t would overflow for long
        # frames; gather t via the winning index instead.
        idx1 = jnp.where(pos, idx_order + 1, 0)
        k = jnp.where(pos, key_xy, n_xy)
        last_idx = (
            jnp.zeros((n_xy + 1,), jnp.int32).at[k].max(idx1, mode="drop")
        )
        t_i32 = batch.t.astype(jnp.int32)
        # t of the last event at this lane's pixel (gather via winning index)
        li = last_idx[k]
        t_last = jnp.where(li > 0, t_i32[jnp.maximum(li - 1, 0)], 0)
        t_mean = (t_i32 + t_last) // 2
        out = batch._replace(
            valid=keep_first,
            t=jnp.where(keep_first, t_mean, batch.t).astype(batch.t.dtype),
        )
        return FilteredBatch(out, _dense_rank(key_xy))

    raise ValueError(f"unknown frame filter {name!r}")
